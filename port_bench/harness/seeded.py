"""Everything a run makes from ``--seed``: weights on the device in a few
large draws, images, arrival schedules and request sizes. The same seed
gives the same inputs; every seed gives the same set of sizes and the same
number of arrivals, in another order, so seeds change no amount of work."""

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of a run, from ``--seed`` and keys."""
    entropy = [int(seed) & (2 ** 64 - 1)] + [int(k) for k in keys]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(spec, seed: int, device) -> dict:
    """Parameters from a reference's ``param_spec``: one uniform and one
    normal draw on ``device`` for all of them, sliced and scaled per leaf.
    "uniform": U(-1/sqrt(fan_in), 1/sqrt(fan_in)); "he_normal":
    N(0, 2/fan_in); "gamma": U(0.5, 1.5); "beta": U(-0.5, 0.5); "zero"."""
    gen = device_generator(seed, device)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    uni = torch.rand(sum(s for s, (_, _, init, _) in zip(sizes, spec) if init != "he_normal"),
                     generator=gen, device=device)
    nor = torch.randn(sum(s for s, (_, _, init, _) in zip(sizes, spec) if init == "he_normal"),
                      generator=gen, device=device)
    out, at_u, at_n = {}, 0, 0
    for size, (name, shape, init, fan_in) in zip(sizes, spec):
        if init == "he_normal":
            t = nor[at_n:at_n + size] * float(np.sqrt(2.0 / fan_in))
            at_n += size
        else:
            u = uni[at_u:at_u + size]
            at_u += size
            if init == "uniform":
                t = (2.0 * u - 1.0) / float(np.sqrt(fan_in))
            elif init == "gamma":
                t = 0.5 + u
            elif init == "beta":
                t = u - 0.5
            elif init == "zero":
                t = torch.zeros_like(u)
            else:
                raise ValueError(f"unknown init {init!r}")
        out[name] = t.reshape(shape).contiguous()
    return out


def images(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """n natural-looking uint8 HWC images: a coarse random colour field,
    bicubic-upsampled, plus mild noise; made on ``device``, returned on the
    host."""
    gen = device_generator(seed, device)
    coarse = torch.rand((n, 3, max(h // 16, 2), max(w // 16, 2)), generator=gen,
                        device=device) * 255.0
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    img = img + 6.0 * torch.randn(img.shape, generator=gen, device=device)
    img = torch.clamp(img, 0, 255).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def spread_sizes(n: int, lo: int, hi: int, rng: np.random.Generator) -> np.ndarray:
    """n integer sizes in [lo, hi], spread evenly over the range (the same
    set for every seed), in an order drawn from ``rng``."""
    sizes = lo + np.floor((np.arange(n) + 0.5) / n * (hi - lo + 1)).astype(np.int64)
    return rng.permutation(np.minimum(sizes, hi))


def poisson_dues(n: int, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """n arrival times of a Poisson process given its count over
    [0, seconds): sorted uniforms."""
    return np.sort(rng.uniform(0.0, seconds, n))
