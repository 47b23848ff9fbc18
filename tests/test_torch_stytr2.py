"""StyTr² in the port (``models/stytr2.py``, ``infer/stytr2.py``, ``fnst-serve
--stytr2``) against the plain float32 reference ``tests/plain_stytr2.py`` on
seeded random weights at small sizes on the CPU, the benchmark's copy of
the reference against the same, and the strict checkpoint loader on
synthetic state dicts.

The AdaIN decoder takes 512 channels, so the whole forward runs at d = 512
(8 heads of 64, FFN 128, one layer of each stack); the transformer alone
also at d = 64 (one head)."""

import argparse
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_stytr2 as plain
from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.core.shapes import pad_to_multiple_reflect
from fast_neural_style_transfer_tpu_torch.infer.stytr2 import TransformerStylizer
from fast_neural_style_transfer_tpu_torch.models.stytr2 import (
    PARTS,
    StyTr2,
    load_stytr2,
    load_stytr2_checkpoint,
    make_stytr2,
)
from fast_neural_style_transfer_tpu_torch.serve import http as serve_http

SMALL = dict(dim_feedforward=128, num_encoder_layers=1, num_decoder_layers=1)
BENCH_DIR = Path(__file__).resolve().parents[1] / "port_bench"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


def seeded_weights(seed: int, d_model: int = 512, **widths) -> dict:
    """The official initialization, then every bias and LayerNorm drawn off
    its constant (so each takes part), the CNN decoder He-normal with its
    last conv scaled and centred so the [0, 1] output spans the u8 range."""
    torch.manual_seed(seed)
    sd = {k: v.clone() for k, v in StyTr2(d_model=d_model, **widths).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    last = max((k for k in sd if k.startswith("decoder.") and k.endswith(".weight")),
               key=lambda k: int(k.split(".")[1]))
    for k, v in sd.items():
        if k.startswith("decoder.") and v.dim() == 4:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
            if k == last:
                sd[k] *= 0.2
        elif k.startswith("decoder."):
            sd[k] = 0.5 if k == last[:-len("weight")] + "bias" else 0.05
            sd[k] = torch.full_like(v, sd[k]) + 0.01 * torch.randn(v.shape, generator=g)
        elif ".norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.2 * torch.randn(v.shape, generator=g)
        elif v.dim() == 1:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    return sd


def _images(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _nchw(u8: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u8).permute(0, 3, 1, 2).float() / 255.0


def _plain_u8(sd, content_u8, style_u8, nhead) -> np.ndarray:
    y = plain.forward(sd, _nchw(content_u8), _nchw(style_u8), nhead)
    return (torch.clamp(y, 0, 1) * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def _assert_u8_close(got, want):
    """u8 outputs of f32 computations that sum in other orders (fused
    attention, F.layer_norm, cuDNN-free CPU convs): a value may land one
    level off where it sits on a rounding boundary, rarely."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_transformer_tokens_match_the_plain_reference_at_d64():
    """Embedding, CAPE, both encoders and the decoder (the tokens before the
    CNN decoder), d = 64, one head: 1e-4 absolute on LayerNorm'd O(1)
    tokens is f32 roundoff of differently ordered sums through three
    post-norm stacks."""
    sd = seeded_weights(1, d_model=64, **SMALL)
    model = make_stytr2(sd, "cpu")
    content, style = _nchw(_images(2, 64, 48, 2)), _nchw(_images(1, 40, 56, 3))
    with torch.no_grad():
        mem = model.encode_style(style.permute(0, 2, 3, 1), Precision.f32())
        tokens, pos, _ = model.embed(content.permute(0, 2, 3, 1), Precision.f32())
        got = model.decode(model.encode(tokens, pos), pos, mem)
        want = plain.transform(sd, content, style, nhead=1)
    assert got.shape == want.shape == (2, 8 * 6, 64)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_stylize_u8_matches_the_plain_reference():
    sd = seeded_weights(4, **SMALL)
    style = _images(1, 64, 64, 5)[0]
    sty = TransformerStylizer(sd, device="cpu").set_style_u8(style)
    content = _images(3, 64, 64, 6)
    got = sty.stylize_u8(content)
    want = _plain_u8(sd, content, style[None], nhead=8)
    _assert_u8_close(got, want)
    # the check compares something: the output spans the range, few clamp
    assert want.std() > 20 and np.isin(want, (0, 255)).mean() < 0.2


def test_bucketed_padding_matches_the_reference_on_the_padded_input():
    """A 50 x 61 request reflect-padded to the 64 bucket: padded tokens take
    part in attention and CAPE, so the crop equals the reference's output
    on the padded image, cropped, and not its output on the bare one."""
    sd = seeded_weights(7, **SMALL)
    style = _images(1, 48, 64, 8)[0]
    sty = TransformerStylizer(sd, device="cpu", bucket_multiple=64).set_style_u8(style)
    img = _images(1, 50, 61, 9)
    padded, _ = pad_to_multiple_reflect(torch.from_numpy(img), 64)
    want = _plain_u8(sd, padded.numpy(), style[None], nhead=8)[:, :50, :61]
    got = sty.stylize_u8(img[0])
    assert got.shape == (50, 61, 3)
    _assert_u8_close(got[None], want)


def test_a_cached_style_gives_what_re_encoding_it_per_call_gives():
    sd = seeded_weights(10, **SMALL)
    style = _images(1, 64, 64, 11)[0]
    sty = TransformerStylizer(sd, device="cpu").set_style_u8(style)
    content = _images(2, 64, 64, 12)
    cached = [sty.stylize_u8(content) for _ in range(2)]
    assert sty.style_encodes == 1
    fresh = []
    for _ in range(2):
        sty.set_style_u8(style)
        fresh.append(sty.stylize_u8(content))
    assert sty.style_encodes == 3
    for a in cached + fresh[1:]:
        np.testing.assert_array_equal(a, fresh[0])
    # the cache is the style's whole contribution: the model's own forward
    # with the memory encoded afresh gives the same pixels
    with torch.no_grad():
        s = torch.from_numpy(style[None]).float() / 255.0
        y = sty.model(torch.from_numpy(content).float() / 255.0,
                      sty.model.encode_style(s, Precision.f32()))
    np.testing.assert_array_equal(
        (torch.clamp(y, 0, 1) * 255.0 + 0.5).to(torch.uint8).numpy(), fresh[0])


def test_bf16_runs_on_the_flash_backend_near_f32():
    """bf16 holds the transformer's weights in bf16 and runs attention on the
    flash backend only (the CPU's flash kernel here). A mean gap to f32
    under 4 u8 levels is bf16's 8-bit mantissa through the stacks; a wrong
    path or a dropped term reads tens."""
    sd = seeded_weights(13, **SMALL)
    style, content = _images(1, 64, 64, 14)[0], _images(2, 64, 64, 15)
    f32 = TransformerStylizer(sd, device="cpu").set_style_u8(style)
    bf16 = TransformerStylizer(sd, device="cpu", precision="bf16").set_style_u8(style)
    assert next(bf16.model.transformer.parameters()).dtype == torch.bfloat16
    d = np.abs(bf16.stylize_u8(content).astype(int) - f32.stylize_u8(content).astype(int))
    assert d.mean() < 4.0, d.mean()


def test_counters_count_attention_launches_and_style_encodes():
    sd = seeded_weights(16, **SMALL)
    sty = TransformerStylizer(sd, device="cpu")
    assert sty.attention_launches == 0 and sty.style_encodes == 0
    sty.set_style_u8(_images(1, 32, 32, 17)[0])
    assert sty.attention_launches == 1 and sty.style_encodes == 1  # encoder_s
    sty.stylize_u8(_images(2, 32, 32, 18))
    assert sty.attention_launches == 1 + 3  # encoder_c, the decoder's two


@pytest.mark.parametrize("kwargs,match", [({"precision": "int8"}, "int8"),
                                          ({"bucket_multiple": 60}, "multiple of the 8")])
def test_stylizer_refuses_int8_and_buckets_off_the_patch_grid(kwargs, match):
    with pytest.raises(ValueError, match=match):
        TransformerStylizer(seeded_weights(0, **SMALL), device="cpu", **kwargs)


def test_the_benchmark_reference_matches_the_plain_reference():
    """``port_bench/reference/stytr2.py`` against this file's, so the two
    copies cannot drift."""
    sys.path.insert(0, str(BENCH_DIR))
    try:
        ref = importlib.import_module("reference.stytr2")
    finally:
        sys.path.remove(str(BENCH_DIR))
        for name in [m for m in sys.modules if m == "reference" or m.startswith("reference.")]:
            del sys.modules[name]
    sd = seeded_weights(19, **SMALL)
    content, style = _nchw(_images(2, 48, 64, 20)), _nchw(_images(1, 64, 40, 21))
    with torch.no_grad():
        got = ref.forward(sd, content, ref.style_memory(sd, style, layers=1), layers=1)
        want = plain.forward(sd, content, style, nhead=8)
    # the same operations in nearly the same order: float32 roundoff only
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # a planted fault moves the output
        bad = ref.forward(sd, content, ref.style_memory(sd, style, layers=1), layers=1,
                          fault="no_final_norm")
    assert (bad - want).abs().mean() > 1e-2


def _official_parts(sd: dict) -> dict:
    parts = {p: {} for p in PARTS}
    for k, v in sd.items():
        part, rest = k.split(".", 1)
        parts[part][rest] = v
    return parts


@pytest.fixture(scope="module")
def full_width():
    """A published-width state_dict (35.4 M parameters), made once."""
    torch.manual_seed(22)
    return StyTr2().state_dict()


def test_full_width_has_the_published_parameter_counts(full_width):
    n = lambda prefix: sum(v.numel() for k, v in full_width.items()  # noqa: E731
                           if k.startswith(prefix))
    assert n("transformer.encoder_c.layers.0.") == 3_152_384
    assert n("transformer.decoder.layers.0.") == 4_204_032
    assert n("decoder.") == 3_505_219
    assert n("embedding.") + n("transformer.new_ps.") == 361_472
    assert abs(sum(v.numel() for v in full_width.values()) - 35.4e6) < 0.05e6


def test_loader_reads_the_three_official_state_dicts_strictly(full_width, tmp_path):
    parts = _official_parts(full_width)
    assert set(parts["transformer"]) >= {
        "encoder_c.layers.2.self_attn.in_proj_weight", "encoder_s.layers.0.linear1.bias",
        "decoder.layers.1.multihead_attn.out_proj.weight", "decoder.layers.2.norm3.weight",
        "decoder.norm.bias", "new_ps.weight"}
    assert {"proj.weight", "proj.bias"} == set(parts["embedding"])
    assert "1.weight" in parts["decoder"] and "28.bias" in parts["decoder"]
    got = load_stytr2(*(parts[p] for p in PARTS))
    assert set(got) == set(full_width)
    # the official release's three files, in a directory
    for p in PARTS:
        torch.save(parts[p], tmp_path / f"{p}_iter_160000.pth")
    got = load_stytr2_checkpoint(tmp_path)
    assert all(torch.equal(got[k], full_width[k]) for k in full_width)
    torch.save(parts["decoder"], tmp_path / "decoder_iter_1.pth")
    with pytest.raises(FileNotFoundError, match="want one decoder"):
        load_stytr2_checkpoint(tmp_path)


@pytest.mark.parametrize("edit", ["missing", "unexpected", "misnamed"])
def test_loader_refuses_missing_or_unexpected_keys(full_width, edit):
    parts = _official_parts(full_width)
    t = dict(parts["transformer"])
    if edit == "missing":
        del t["decoder.norm.weight"]
    elif edit == "unexpected":
        t["decoder.layers.3.norm1.weight"] = torch.ones(512)
    else:  # nn.Transformer's own name for the cross-attention
        t["decoder.layers.0.cross_attn.in_proj_weight"] = t.pop(
            "decoder.layers.0.multihead_attn.in_proj_weight")
    with pytest.raises(ValueError, match="transformer state_dict"):
        load_stytr2(parts["embedding"], t, parts["decoder"])


def test_serve_stytr2_flag_builds_a_server_that_round_trips(full_width, tmp_path):
    """fnst-serve --stytr2 <checkpoint> --style builds the "stytr2" family on
    ``TransformerStylizer``; a u8 batch through the server's batcher comes
    back as the stylizer's output. --stytr2 without --style, or at int8,
    is refused."""
    from PIL import Image

    ckpt, style = tmp_path / "ckpt", tmp_path / "style.png"
    ckpt.mkdir()
    for part, sd in _official_parts(full_width).items():
        torch.save(sd, ckpt / f"{part}_iter_160000.pth")
    style_u8 = _images(1, 40, 48, 23)[0]
    Image.fromarray(style_u8).save(style)
    args = argparse.Namespace(stytr2=str(ckpt), style=str(style), precision="f32",
                              adain_decoder=None, model=None, data_parallel=False)
    fwd, family, device = serve_http._build_forward(args, "cpu")
    assert family == "stytr2" and str(device) == "cpu"
    assert isinstance(fwd.__self__, TransformerStylizer)
    srv = serve_http.make_server(fwd, family=family, device=device, port=0, max_batch=2,
                                 max_wait_ms=50.0)
    try:
        imgs = _images(2, 30, 27, 24)
        futs = [srv.batcher.submit(im) for im in imgs]
        outs = [f.result(timeout=120) for f in futs]
    finally:  # never served: close the batcher and the socket
        srv.batcher.close()
        srv.server_close()
    want = TransformerStylizer(full_width, device="cpu").set_style_u8(
        style_u8).stylize_u8(imgs)
    for out, w in zip(outs, want):
        assert out.shape == (30, 27, 3)
        np.testing.assert_array_equal(out, w)
    for bad, match in (({"style": None}, "--style"), ({"precision": "int8"}, "flagship")):
        with pytest.raises(SystemExit, match=match):
            serve_http._build_forward(argparse.Namespace(**{**vars(args), **bad}), "cpu")


def test_attention_is_the_scaled_dot_product_of_nn_multihead_attention():
    """The port's attention on ``nn.MultiheadAttention``'s own parameters
    gives its output (batch_first, no dropout): the key names and the
    1/sqrt(64) scaling are the official module's."""
    from fast_neural_style_transfer_tpu_torch.models.stytr2 import LaunchCounter, MultiheadAttention

    torch.manual_seed(25)
    mha = torch.nn.MultiheadAttention(512, 8, batch_first=True).eval()
    ours = MultiheadAttention(512, 8)
    with torch.no_grad():
        mha.in_proj_bias.normal_()
        ours.load_state_dict(mha.state_dict(), strict=True)
        q, m = torch.randn(2, 20, 512), torch.randn(1, 30, 512)
        want = mha(q, m.expand(2, -1, -1), m.expand(2, -1, -1), need_weights=False)[0]
        got = ours.attend(q, *ours.project_kv(m), LaunchCounter())
        x = torch.randn(2, 24, 512)
        want_self = mha(x, x, x, need_weights=False)[0]
        got_self = ours.self_attend(x, None, LaunchCounter())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_self, want_self, atol=1e-5, rtol=1e-5)
