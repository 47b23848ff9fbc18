"""AdaAttN in the port (``models/adaattn.py``, ``infer/adaattn.py``,
``ops/cuda_moment_attention.py``, ``fnst-serve --adaattn``) against the
benchmark's plain float32 reference ``port_bench/reference/adaattn.py`` on
seeded random weights at small sizes on the CPU, its planted faults, the
strict checkpoint loader on synthetic state dicts, and, on a card, the
moment-attention kernel against its float32 composition.

The CPU tests shrink relu3_1's ``max_sample`` so that a small style is
sampled there as a 512² one is; the widths are the published ones."""

import argparse
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_neural_style_transfer_tpu_torch.infer.adaattn import AttentionalStylizer
from fast_neural_style_transfer_tpu_torch.models import adaattn as model
from fast_neural_style_transfer_tpu_torch.ops import _build
from fast_neural_style_transfer_tpu_torch.ops import cuda_moment_attention as cma
from fast_neural_style_transfer_tpu_torch.serve import http as serve_http

BENCH_DIR = Path(__file__).resolve().parents[1] / "port_bench"
SAMPLE = 60  # relu3_1's max_sample here: a 48 x 32 style has 96 positions there


def _bench(name: str):
    sys.path.insert(0, str(BENCH_DIR))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(BENCH_DIR))


ref = _bench("reference.adaattn")
ref_vgg = _bench("reference.vgg")
common = _bench("reference.common")
for _name in [m for m in sys.modules if m == "reference" or m.startswith("reference.")]:
    del sys.modules[_name]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _small_sample(monkeypatch):
    """relu3_1 keeps SAMPLE positions of the style, in the port and in the
    reference alike."""
    monkeypatch.setitem(model.MAX_SAMPLE, 2, SAMPLE)
    monkeypatch.setattr(ref, "SITES", ((ref.SITES[0][0], 2, SAMPLE),) + ref.SITES[1:])


def seeded_weights(seed: int) -> tuple:
    """(AdaAttN's state_dict, VGG19's): He-normal convs with small random
    biases (so that the loader and each bias take part), f and g scaled as
    the benchmark's (logits of std 3-6), the decoder's last conv scaled and
    centred so the [0, 1] output spans the u8 range; VGG19 He-normal."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.AdaAttN().state_dict().items():
        if v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        else:
            sd[k] = 0.02 * torch.randn(v.shape, generator=g)
    for pre, scale in (("adaattn_3.", 0.14), ("transformer.attn_adain_4_1.", 0.09),
                       ("transformer.attn_adain_5_1.", 0.065)):
        for conv in "fg":
            sd[f"{pre}{conv}.weight"] *= scale
    sd["decoder.decoder_layer_2.24.weight"] *= 0.1
    sd["decoder.decoder_layer_2.24.bias"] += 0.5
    vgg = {name: (torch.randn(shape, generator=g) * (2.0 / fan) ** 0.5 if init == "he_normal"
                  else torch.zeros(shape))
           for name, shape, init, fan in ref_vgg.param_spec()}
    return sd, vgg


def _images(n, h, w, seed):
    """Smooth colour fields plus noise: VGG features with spatial structure."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((n, 3, max(h // 8, 2), max(w // 8, 2)), np.float32))
    img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                          align_corners=False) * 255
    img = img + torch.from_numpy(rng.normal(0, 8, (n, 3, h, w)).astype(np.float32))
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()


def _network(u8: np.ndarray) -> torch.Tensor:
    return common.to_network(torch.from_numpy(np.ascontiguousarray(u8)))


def _ref_u8(sd, vgg, content_u8, style_u8, fault=None) -> np.ndarray:
    with torch.no_grad():
        cache = ref.style_cache(sd, vgg, _network(style_u8), fault)
        y = ref.forward(sd, vgg, _network(content_u8), cache, fault)
    return (torch.clamp(y, 0, 1) * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def _assert_u8_close(got, want):
    """u8 outputs of float32 computations that sum in other orders (the
    attention's products by blocks, cuDNN-free CPU convs, instance norm's
    two passes): a value may land one level off where it sits on a
    rounding boundary, rarely."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def weights():
    return seeded_weights(1)


@pytest.mark.parametrize("side,style_hw", [(64, (48, 32)), (128, (64, 80))])
def test_stylize_u8_matches_the_reference(weights, side, style_hw):
    """f32 on the CPU, content and style of other sizes, relu3_1 sampled."""
    sd, vgg = weights
    style = _images(1, *style_hw, seed=side)
    sty = AttentionalStylizer(sd, vgg, device="cpu").set_style_u8(style[0])
    assert sty._style[2].keys.shape[0] == SAMPLE  # sampling engaged
    content = _images(2, side, side, seed=side + 1)
    want = _ref_u8(sd, vgg, content, style)
    _assert_u8_close(sty.stylize_u8(content), want)
    # the check compares something: the output spans the range, few clamp
    assert want.std() > 20 and np.isin(want, (0, 255)).mean() < 0.2


def test_bucketed_padding_matches_the_reference_on_the_padded_input(weights):
    """A 50 x 61 request reflect-padded to the 64 bucket: padded pixels enter
    the keys' norms and the attention, so the crop equals the reference's
    output on the padded image, cropped."""
    from fast_neural_style_transfer_tpu_torch.core.shapes import pad_to_multiple_reflect

    sd, vgg = weights
    style = _images(1, 48, 64, seed=8)
    sty = AttentionalStylizer(sd, vgg, device="cpu", bucket_multiple=64).set_style_u8(style[0])
    img = _images(1, 50, 61, seed=9)
    padded, _ = pad_to_multiple_reflect(torch.from_numpy(img), 64)
    want = _ref_u8(sd, vgg, padded.numpy(), style)[:, :50, :61]
    got = sty.stylize_u8(img[0])
    assert got.shape == (50, 61, 3)
    _assert_u8_close(got[None], want)


@pytest.mark.parametrize("site", model.SITES)
def test_key_builder_matches_get_key(weights, site):
    """Nearest downsampling, biased instance norm and the concatenation, in
    the published channel order: float32 roundoff of the two-pass norm."""
    _, vgg = weights
    x = _network(_images(2, 64, 48, seed=site))
    with torch.no_grad():
        feats = ref.encode(vgg, x)
        want = ref.get_key(feats, site)
        got = model.build_keys([f.permute(0, 2, 3, 1) for f in feats], site)
    assert got.shape[-1] == model.key_width(site) == (448, 960, 1472)[site - 2]
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_each_planted_fault_moves_the_output(weights, fault):
    """Each fault the benchmark's limit must catch moves the u8 output far
    beyond the one level the port may differ by."""
    sd, vgg = weights
    style, content = _images(1, 48, 32, seed=3), _images(2, 64, 64, seed=4)
    good, bad = _ref_u8(sd, vgg, content, style), _ref_u8(sd, vgg, content, style, fault)
    d = np.abs(good.astype(np.int16) - bad.astype(np.int16))
    assert np.percentile(d, 99.9) > 10, (fault, np.percentile(d, 99.9))


def test_a_cached_style_gives_what_re_encoding_it_gives(weights):
    sd, vgg = weights
    style, content = _images(1, 48, 48, seed=10)[0], _images(2, 64, 64, seed=11)
    sty = AttentionalStylizer(sd, vgg, device="cpu").set_style_u8(style)
    cached = [sty.stylize_u8(content) for _ in range(2)]
    assert sty.style_encodes == 1
    sty.set_style_u8(style)
    assert sty.style_encodes == 2
    for a in cached:
        np.testing.assert_array_equal(a, sty.stylize_u8(content))


def test_bf16_near_f32(weights):
    """bf16 on the CPU: the convs and projections in bf16, the attention's
    plain version in float32 from bf16 operands. A mean gap under 3 u8
    levels is bf16's 8-bit mantissa through VGG19 and the decoder; a
    dropped term reads tens (the faults above)."""
    sd, vgg = weights
    style, content = _images(1, 48, 48, seed=12)[0], _images(2, 64, 64, seed=13)
    f32 = AttentionalStylizer(sd, vgg, device="cpu").set_style_u8(style)
    bf16 = AttentionalStylizer(sd, vgg, device="cpu", precision="bf16").set_style_u8(style)
    assert bf16._style[3].keys.dtype == bf16._style[3].values.values.dtype == torch.bfloat16
    d = np.abs(bf16.stylize_u8(content).astype(int) - f32.stylize_u8(content).astype(int))
    assert d.mean() < 3.0, d.mean()


def test_counters_count_attention_calls_and_style_encodes(weights):
    sd, vgg = weights
    sty = AttentionalStylizer(sd, vgg, device="cpu")
    assert sty.attention_launches == 0 and sty.style_encodes == 0
    sty.set_style_u8(_images(1, 32, 32, seed=14)[0])
    assert sty.attention_launches == 0 and sty.style_encodes == 1
    before = cma.moment_attention.launches
    sty.stylize_u8(_images(2, 32, 32, seed=15))
    assert sty.attention_launches == 3  # one a site for the batch
    assert cma.moment_attention.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("kwargs,match", [({"precision": "int8"}, "int8"),
                                          ({"bucket_multiple": 40}, "multiple of relu5_1")])
def test_stylizer_refuses_int8_and_buckets_off_the_grid(weights, kwargs, match):
    with pytest.raises(ValueError, match=match):
        AttentionalStylizer(*weights, device="cpu", **kwargs)


def test_moment_attention_plain_version_is_the_definition():
    """The shifted moments give the unshifted formula's output (float64) to
    float32's roundoff of the values (logits of std ~0.6, so that no
    variance is near 0, where the square root would magnify it), and the
    square is of the rounded first power."""
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 37, 128, generator=g), torch.randn(53, 128, generator=g) * 0.05
    v, c = torch.randn(53, 64, generator=g) + 5.0, torch.randn(2, 37, 64, generator=g)
    mv = cma.prepare_values(v, torch.float32)
    got = cma.moment_attention_reference(q, k, mv, c, block_q=16).double()
    a = torch.softmax(q.double() @ k.double().t(), -1)
    m = a @ v.double()
    want = torch.sqrt(torch.relu(a @ v.double() ** 2 - m ** 2)) * c.double() + m
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    bf = cma.prepare_values(v, torch.bfloat16)
    assert torch.equal(bf.values[1], bf.values[0].float().square().bfloat16())
    torch.testing.assert_close(bf.shift, v.mean(0))


@pytest.mark.parametrize("edit,match", [
    ("dtype", "bfloat16 q"), ("shape", "do not match"), ("dqk", "multiple of 64"),
    ("stride", "rows of a"), ("contiguous", "contiguous")])
def test_kernel_wrapper_refuses_what_the_kernel_cannot_take(edit, match):
    bf = torch.bfloat16
    key = torch.zeros(2, 10, 448, dtype=bf)
    q, k = torch.zeros(2, 10, 448, dtype=bf), torch.zeros(30, 448, dtype=bf)
    mv = cma.prepare_values(torch.zeros(30, 256), bf)
    c = key[..., 192:]
    assert cma._check(q, k, mv, c) == 448
    if edit == "dtype":
        q = q.float()
    elif edit == "shape":
        k = k[:, :384]
    elif edit == "dqk":
        q, k, c = q[..., :96], k[:, :96].contiguous(), torch.zeros(2, 10, 256, dtype=bf)
        q = q.contiguous()
    elif edit == "stride":
        c = key.transpose(0, 1).contiguous().transpose(0, 1)[..., 192:]
    else:
        q = torch.zeros(2, 448, 10, dtype=bf).transpose(1, 2)
    with pytest.raises((TypeError, ValueError), match=match):
        cma._check(q, k, mv, c)


def test_the_kernel_builds_alone_and_not_with_the_others():
    """Every other path loads the three sources of ``TOGETHER`` at once;
    the moment attention is none of them, so no other cell builds it."""
    assert "moment_attention" in _build.SOURCES
    assert "moment_attention" not in _build.TOGETHER
    assert set(_build.SOURCES) - set(_build.TOGETHER) == {"moment_attention"}
    assert cma.moment_attention in _build.COUNTED


# -- checkpoints ---------------------------------------------------------------


def _official_parts(sd: dict) -> dict:
    parts = {p: {} for p in model.PARTS}
    for k, v in sd.items():
        part, rest = k.split(".", 1)
        parts[part][rest] = v
    return parts


def test_published_widths_and_parameter_counts(weights):
    sd, vgg = weights
    n = lambda prefix: sum(v.numel() for k, v in sd.items() if k.startswith(prefix))  # noqa: E731
    assert (n("adaattn_3."), n("transformer."), n("decoder.")) == (468_096, 9_066_752, 4_095_043)
    assert sum(v.numel() for v in sd.values()) == 13_629_891
    convs = [name for name, cin, _ in ref_vgg.CFG if cin]
    encoder = convs[:convs.index("conv5_1") + 1]
    assert sum(vgg[f"{c}.weight"].numel() + vgg[f"{c}.bias"].numel()
               for c in encoder) == 12_944_960
    assert sd["transformer.attn_adain_5_1.f.weight"].shape == (1472, 1472, 1, 1)
    assert sd["adaattn_3.g.weight"].shape == (448, 448, 1, 1)


def test_loader_round_trips_the_official_layout(weights, tmp_path):
    sd, _ = weights
    parts = _official_parts(sd)
    assert {"f.weight", "g.bias", "h.weight"} <= set(parts["adaattn_3"])
    assert {"attn_adain_4_1.f.weight", "attn_adain_5_1.h.bias",
            "merge_conv.weight"} <= set(parts["transformer"])
    assert {"decoder_layer_1.1.weight", "decoder_layer_2.1.weight",
            "decoder_layer_2.24.bias"} <= set(parts["decoder"])
    # the release's files, one saved from a DataParallel (module. prefix)
    torch.save(parts["adaattn_3"], tmp_path / "latest_net_adaattn_3.pth")
    torch.save({f"module.{k}": v for k, v in parts["transformer"].items()},
               tmp_path / "latest_net_transformer.pth")
    torch.save(parts["decoder"], tmp_path / "latest_net_decoder.pth")
    got = model.load_adaattn_checkpoint(tmp_path)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    model.make_adaattn(got, "cpu")  # loads strictly
    torch.save(parts["decoder"], tmp_path / "5_net_decoder.pth")
    with pytest.raises(FileNotFoundError, match="want one"):
        model.load_adaattn_checkpoint(tmp_path)


@pytest.mark.parametrize("edit", ["missing", "unexpected", "misnamed"])
def test_loader_refuses_missing_or_unexpected_keys(weights, edit):
    parts = _official_parts(weights[0])
    t = dict(parts["transformer"])
    if edit == "missing":
        del t["merge_conv.bias"]
    elif edit == "unexpected":
        t["attn_adain_3_1.f.weight"] = torch.ones(1)
    else:  # the non-shallow model's name for the relu4_1 attention's key conv
        t["attn_adain_4_1.k.weight"] = t.pop("attn_adain_4_1.f.weight")
    with pytest.raises(ValueError, match="transformer state_dict"):
        model.load_adaattn(parts["adaattn_3"], t, parts["decoder"])


def _serve_args(ckpt, style, **kw):
    base = dict(adaattn=str(ckpt), style=str(style), precision="f32", vgg_weights=None,
                stytr2=None, adain_decoder=None, model=None, data_parallel=False, max_batch=8)
    return argparse.Namespace(**{**base, **kw})


def test_serve_adaattn_flag_serves_through_the_batcher(weights, tmp_path, monkeypatch):
    """fnst-serve --adaattn <checkpoint> --style builds the "adaattn" family
    on ``AttentionalStylizer``; u8 requests through the server's batcher
    come back as the stylizer's output."""
    from PIL import Image

    from fast_neural_style_transfer_tpu_torch.models import vgg_weights

    sd, vgg = weights
    monkeypatch.setattr(vgg_weights, "resolve_params", lambda path: vgg)
    ckpt, style = tmp_path / "ckpt", tmp_path / "style.png"
    ckpt.mkdir()
    for part, psd in _official_parts(sd).items():
        torch.save(psd, ckpt / f"latest_net_{part}.pth")
    style_u8 = _images(1, 40, 48, seed=23)[0]
    Image.fromarray(style_u8).save(style)
    fwd, family, device = serve_http._build_forward(_serve_args(ckpt, style), "cpu")
    assert family == "adaattn" and str(device) == "cpu"
    assert isinstance(fwd.__self__, AttentionalStylizer)
    srv = serve_http.make_server(fwd, family=family, device=device, port=0, max_batch=2,
                                 max_wait_ms=50.0)
    try:
        imgs = _images(2, 30, 27, seed=24)
        futs = [srv.batcher.submit(im) for im in imgs]
        outs = [f.result(timeout=120) for f in futs]
    finally:  # never served: close the batcher and the socket
        srv.batcher.close()
        srv.server_close()
    want = AttentionalStylizer(sd, vgg, device="cpu").set_style_u8(style_u8).stylize_u8(imgs)
    for out, w in zip(outs, want):
        assert out.shape == (30, 27, 3)
        np.testing.assert_array_equal(out, w)


@pytest.mark.parametrize("bad,match", [({"style": None}, "--style"),
                                       ({"precision": "int8"}, "flagship"),
                                       ({"data_parallel": True}, "--data_parallel")])
def test_serve_adaattn_refuses_data_parallel_int8_and_no_style(tmp_path, bad, match):
    with pytest.raises(SystemExit, match=match):
        args = vars(_serve_args(tmp_path, tmp_path / "s.png"))
        serve_http._build_forward(argparse.Namespace(**{**args, **bad}), "cpu")


def test_serve_adaattn_refuses_f32_on_a_card(tmp_path):
    """The kernel has no float32 variant, and the plain version serves the
    CPU only: ``--precision f32`` on a card is refused before it is touched."""
    args = vars(_serve_args(tmp_path, tmp_path / "s.png"))
    with pytest.raises(SystemExit, match="bf16 on a card"):
        serve_http._build_forward(argparse.Namespace(**{**args, "precision": "f32"}), "cuda")


def test_stylizer_refuses_f32_on_a_card(weights, monkeypatch):
    from fast_neural_style_transfer_tpu_torch.infer import adaattn as infer

    monkeypatch.setattr(infer, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(infer, "indexed_device", lambda d: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="bf16' on a card"):
        AttentionalStylizer(*weights, precision="f32", device="cuda")


# -- on a card -------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _operands(b, nq, nk, dqk, dv, mu=0.0, seed=0):
    """bf16 operands on the card: logits of std ~4, values N(mu + a channel
    offset, 1), c the last dv channels of a key buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = (4.0 / dqk ** 0.5) ** 0.5
    q = (torch.randn(b, nq, dqk, generator=g, device="cuda") * a).bfloat16()
    key = torch.randn(b, nq, dqk, generator=g, device="cuda").bfloat16()
    k = (torch.randn(nk, dqk, generator=g, device="cuda") * a).bfloat16()
    v = (torch.randn(nk, dv, generator=g, device="cuda") + mu
         + torch.randn(1, dv, generator=g, device="cuda")).bfloat16()
    return q, k, v, key[..., dqk - dv:]


def _composition(q, k, v, c):
    """The float32 composition from the same bf16 operands, unshifted, in
    blocks of queries."""
    out = []
    for i in range(0, q.shape[1], 4096):
        a = torch.softmax(q[:, i:i + 4096].float() @ k.float().t(), -1)
        m = a @ v.float()
        s = torch.sqrt(torch.relu(a @ v.float().square() - m.square()))
        out.append(s * c[:, i:i + 4096].float() + m)
    return torch.cat(out, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mu", [
    ((8, 16384, 4096, 448, 256), 0.0),  # relu3_1 at 512², the style sampled
    ((8, 4096, 4096, 960, 512), 0.0),  # relu4_1
    ((8, 1024, 1024, 1472, 512), 0.0),  # relu5_1
    ((2, 1000, 1000, 448, 256), 0.0),  # no multiple of the 64-row tiles
    ((3, 200, 70, 192, 128), 0.0),  # one ragged key tile, the narrowest widths
    ((2, 1024, 1024, 960, 512), 100.0),  # |M| >> S: the cancellation case
], ids=["relu3_1", "relu4_1", "relu5_1", "ragged", "small", "cancellation"])
def test_kernel_matches_the_float32_composition_on_card(shape, mu):
    """One launch against the float32 composition of the same bf16 operands.
    The output is rounded to bf16 (a relative error up to 2^-9, ~2^-10 on
    average), and so are the weights and the shifted values the kernel
    multiplies; where the variance is near 0 the square root magnifies an
    error e in it to sqrt(e), which bounds the worst element, not the mean.
    So: the mean error within 0.4 % of the mean |output| (measured 0.17 %,
    and 0.12 % at |M| ~ 100, where the output's own rounding is 0.1 %), its
    99.9th percentile within 5 % (measured 1.4-2.6 %), the worst within 60 %
    (measured 35 %). Without the shift the cancellation case's variance is
    lost to bf16's squares of ~10^4."""
    _card()
    q, k, v, c = _operands(*shape, mu=mu)
    mv = cma.prepare_values(v.float(), torch.bfloat16)
    before = cma.moment_attention.launches
    with torch.inference_mode():
        got = cma.moment_attention(q, k, mv, c)
    torch.cuda.synchronize()
    assert cma.moment_attention.launches == before + 1
    assert got.shape == c.shape and got.dtype == torch.bfloat16
    want = _composition(q, k, v, c)
    d = (got.float() - want).abs()
    scale = want.abs().mean().item()
    assert d.mean().item() < 0.004 * scale, (d.mean().item(), scale)
    assert torch.quantile(d.flatten()[:1 << 24], 0.999).item() < 0.05 * max(scale, 1.0)
    assert d.max().item() < 0.6 * max(scale, 1.0)


@pytest.mark.gpu
def test_stylizer_runs_the_kernel_once_a_site_on_card(weights):
    """bf16 on the card: three launches a batch, counted by the stylizer and
    the kernel alike; the output within bf16's reach of the CPU's f32."""
    _card()
    sd, vgg = weights
    style, content = _images(1, 64, 64, seed=30)[0], _images(4, 128, 128, seed=31)
    card = AttentionalStylizer(sd, vgg, precision="bf16", device="cuda").set_style_u8(style)
    before = cma.moment_attention.launches
    got = card.stylize_u8(content)
    assert cma.moment_attention.launches - before == card.attention_launches == 3
    f32 = AttentionalStylizer(sd, vgg, device="cpu").set_style_u8(style).stylize_u8(content)
    assert np.abs(got.astype(int) - f32.astype(int)).mean() < 3.0
