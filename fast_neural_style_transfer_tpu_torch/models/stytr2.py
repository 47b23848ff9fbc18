"""StyTr² (Deng et al., "StyTr²: Image Style Transfer with Transformers",
CVPR 2022, arXiv:2105.14576): arbitrary style through two transformer
encoders and a cross-attention decoder, decoded to pixels by the AdaIN
decoder.

At the published widths (d = 512, 8 heads of 64, FFN 2048, ReLU):

- patch embedding: ``Conv2d(3, d, k=8, s=8)`` on the [0, 1] image (no
  ImageNet normalization); one module embeds content and style;
- CAPE, the content-aware positional encoding: ``P = bilinear(Conv1x1(
  AdaptiveAvgPool2d(18)(E_c)))`` back to the content's token grid, added to
  the content's queries and keys only (the style has none);
- ``encoder_c`` and ``encoder_s``, 3 post-norm layers each (DETR's layout):
  ``x = LN1(x + MHA(q = k = x + pos, v = x)); x = LN2(x + FFN(x))``;
- the decoder, 3 post-norm layers whose two attentions both take queries
  from the content stream and keys and values from the encoded style m:
  ``t = LN1(t + MHA(t + P, m, m)); t = LN2(t + MHA(t + P, m, m));
  t = LN3(t + FFN(t))``, then a final LayerNorm;
- the tokens, reshaped to (B, H/8, W/8, d), through ``models.adain.
  AdaINDecoder`` unchanged; the output is [0, 1] pixels (callers clamp).

The modules carry the official code's names (``models/StyTR.py``,
``models/transformer.py``), so ``load_stytr2`` takes its three state dicts
(``embedding``, ``transformer``, ``decoder``) strictly. Everything that
depends on the style alone (its embedding, ``encoder_s`` and each decoder
attention's keys and values of its output) is ``encode_style``'s, computed
once per style: ``StyleMemory``. Heads are 64 wide, so d fixes their number.

Attention is ``F.scaled_dot_product_attention`` under a named backend, so
an unsupported shape raises instead of falling back: bf16 runs only the
flash backend; float32 the memory-efficient one on the card, the math one
on the CPU. ``attention_launches`` counts its calls.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.models.adain import AdaINDecoder

PATCH = 8
CAPE_POOL = 18
HEAD_DIM = 64  # the published head width: d / 64 heads
LN_EPS = 1e-5

StateDict = Dict[str, torch.Tensor]


def attention_backend(dtype: torch.dtype, device: torch.device) -> SDPBackend:
    """The one backend attention may take: flash in bf16, the
    memory-efficient kernel in float32 on the card, math on the CPU."""
    if dtype == torch.bfloat16:
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.EFFICIENT_ATTENTION if device.type == "cuda" else SDPBackend.MATH


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype), ln.bias.to(x.dtype),
                        ln.eps)


def _heads(t: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, N, d) -> (B, heads, N, d / heads), a view."""
    b, n, d = t.shape
    return t.view(b, n, nhead, d // nhead).transpose(1, 2)


class MultiheadAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (``in_proj_weight``
    (3d, d) as [W_q; W_k; W_v], ``in_proj_bias``, ``out_proj``), computed
    with a named SDPA backend, 1 / sqrt(d / heads) scaling, no dropout."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def _part(self, i: int, j: int = 1):
        d = self.in_proj_weight.shape[1]
        return self.in_proj_weight[i * d:(i + j) * d], self.in_proj_bias[i * d:(i + j) * d]

    def project_kv(self, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keys and values of ``memory`` (B, N, d), each (B, heads, N, dh)."""
        kv = _linear(memory, *self._part(1, 2))
        k, v = kv.chunk(2, dim=-1)
        return _heads(k, self.nhead), _heads(v, self.nhead)

    def _attend(self, q, k, v, counter: "LaunchCounter") -> torch.Tensor:
        """Heads (B, heads, N, dh) -> the output projection, (B, N, d)."""
        with sdpa_kernel(attention_backend(q.dtype, q.device)):
            o = F.scaled_dot_product_attention(q, k, v)
        counter.attention_launches += 1
        b, _, n, _ = o.shape
        return _linear(o.transpose(1, 2).reshape(b, n, -1), self.out_proj.weight,
                       self.out_proj.bias)

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               counter: "LaunchCounter") -> torch.Tensor:
        """Queries projected from ``q_in`` (B, N, d) against projected keys
        and values (B or 1, heads, M, dh)."""
        q = _heads(_linear(q_in, *self._part(0)), self.nhead)
        b = q.shape[0]
        if k.shape[0] != b:  # one style serves the batch: broadcast, no copy
            k, v = k.expand(b, *k.shape[1:]), v.expand(b, *v.shape[1:])
        return self._attend(q, k, v, counter)

    def self_attend(self, x: torch.Tensor, pos: Optional[torch.Tensor],
                    counter: "LaunchCounter") -> torch.Tensor:
        """``MHA(q = k = x + pos, v = x)``."""
        qk = _linear(x if pos is None else x + pos, *self._part(0, 2))
        q, k = qk.chunk(2, dim=-1)
        v = _linear(x, *self._part(2))
        return self._attend(_heads(q, self.nhead), _heads(k, self.nhead),
                            _heads(v, self.nhead), counter)


class LaunchCounter:
    """The model's always-on count of attention launches."""

    def __init__(self):
        self.attention_launches = 0


class _FFN(nn.Module):
    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(torch.relu(_linear(x, self.linear1.weight, self.linear1.bias)),
                       self.linear2.weight, self.linear2.bias)


class TransformerEncoderLayer(_FFN):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, pos, counter):
        x = _layer_norm(x + self.self_attn.self_attend(x, pos, counter), self.norm1)
        return _layer_norm(x + self.ffn(x), self.norm2)


class TransformerDecoderLayer(_FFN):
    """Both attentions read the encoded style: queries ``t + P``, keys and
    values the style memory's (paper §3.3; the official ``forward_post``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def attentions(self):
        return self.self_attn, self.multihead_attn

    def forward(self, t, pos, kv, counter):
        (k1, v1), (k2, v2) = kv
        t = _layer_norm(t + self.self_attn.attend(t + pos, k1, v1, counter), self.norm1)
        t = _layer_norm(t + self.multihead_attn.attend(t + pos, k2, v2, counter), self.norm2)
        return _layer_norm(t + self.ffn(t), self.norm3)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(*layer_args)
                                    for _ in range(num_layers))

    def forward(self, x, pos, counter):
        for layer in self.layers:
            x = layer(x, pos, counter)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList(TransformerDecoderLayer(d_model, *layer_args)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)


class PatchEmbed(nn.Module):
    """``proj``: Conv2d(3, d, k=8, s=8) on the [0, 1] image."""

    def __init__(self, d_model: int):
        super().__init__()
        self.proj = nn.Conv2d(3, d_model, PATCH, PATCH)

    def forward(self, x_unit_nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, 3) -> tokens (B, H/8, W/8, d) in ``dtype``."""
        x = x_unit_nhwc.permute(0, 3, 1, 2).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x, self.proj.weight.to(dtype), self.proj.bias.to(dtype), stride=PATCH)
        return y.permute(0, 2, 3, 1)


class Transformer(nn.Module):
    """The official ``Transformer``: ``encoder_c``, ``encoder_s``,
    ``decoder`` and CAPE's ``new_ps``. Matrices Xavier-uniform as its
    ``_reset_parameters``; ``new_ps`` PyTorch's default (it is made after)."""

    def __init__(self, d_model: int = 512, num_encoder_layers: int = 3,
                 num_decoder_layers: int = 3, dim_feedforward: int = 2048):
        super().__init__()
        layer = (d_model, d_model // HEAD_DIM, dim_feedforward)
        self.encoder_c = TransformerEncoder(num_encoder_layers, *layer)
        self.encoder_s = TransformerEncoder(num_encoder_layers, *layer)
        self.decoder = TransformerDecoder(num_decoder_layers, *layer)
        for p in self.parameters():
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)
        self.new_ps = nn.Conv2d(d_model, d_model, 1)

    def cape(self, e: torch.Tensor) -> torch.Tensor:
        """Content tokens (B, h, w, d) -> P, (B, h * w, d): pooled to 18 x 18,
        a 1x1 conv, bilinear back to (h, w)."""
        b, h, w, d = e.shape
        x = e.permute(0, 3, 1, 2)
        p = F.adaptive_avg_pool2d(x, CAPE_POOL)
        p = F.conv2d(p, self.new_ps.weight.to(x.dtype), self.new_ps.bias.to(x.dtype))
        p = F.interpolate(p, size=(h, w), mode="bilinear", align_corners=False)
        return p.permute(0, 2, 3, 1).reshape(b, h * w, d)

    def decoder_kv(self, memory: torch.Tensor) -> List[tuple]:
        """Each decoder layer's ((k, v) of self_attn, (k, v) of
        multihead_attn), projected from the style memory (B, N, d)."""
        return [tuple(a.project_kv(memory) for a in layer.attentions())
                for layer in self.decoder.layers]

    def decode(self, t, pos, kv, counter) -> torch.Tensor:
        for layer, layer_kv in zip(self.decoder.layers, kv):
            t = layer(t, pos, layer_kv, counter)
        return _layer_norm(t, self.decoder.norm)


# What depends on the style alone: each decoder layer's ((k, v) of
# self_attn, (k, v) of multihead_attn), projected from encoder_s's output.
StyleMemory = List[tuple]


class StyTr2(nn.Module):
    """``embedding`` (``PatchEmbed``), ``transformer`` (``Transformer``) and
    ``decoder`` (``AdaINDecoder``, whose input fixes d = 512 for ``cnn``). The stages
    (``embed``, ``encode``, ``decode``, ``cnn``) are separate calls so that
    a caller can time each; ``counter`` counts attention launches."""

    def __init__(self, d_model: int = 512, num_encoder_layers: int = 3,
                 num_decoder_layers: int = 3, dim_feedforward: int = 2048):
        super().__init__()
        self.embedding = PatchEmbed(d_model)
        self.transformer = Transformer(d_model, num_encoder_layers, num_decoder_layers,
                                       dim_feedforward)
        self.decoder = AdaINDecoder()
        self.counter = LaunchCounter()

    def encode_style(self, style_unit: torch.Tensor, precision: Precision) -> StyleMemory:
        """[0, 1] NHWC style image(s), sides multiples of 8 -> its memory."""
        s = self.embedding(style_unit, precision.compute_dtype)
        b, h, w, d = s.shape
        m = self.transformer.encoder_s(s.reshape(b, h * w, d), None, self.counter)
        return self.transformer.decoder_kv(m)

    def embed(self, content_unit: torch.Tensor, precision: Precision):
        """-> (content tokens (B, N, d), P (B, N, d), the token grid (h, w))."""
        e = self.embedding(content_unit, precision.compute_dtype)
        b, h, w, d = e.shape
        return e.reshape(b, h * w, d), self.transformer.cape(e), (h, w)

    def encode(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return self.transformer.encoder_c(tokens, pos, self.counter)

    def decode(self, tokens: torch.Tensor, pos: torch.Tensor, style: StyleMemory) -> torch.Tensor:
        return self.transformer.decode(tokens, pos, style, self.counter)

    def cnn(self, tokens: torch.Tensor, grid: Tuple[int, int], precision: Precision):
        """Tokens (B, N, d) -> [0, 1]-space pixels (B, 8h, 8w, 3), unclamped."""
        b, _, d = tokens.shape
        return self.decoder(tokens.reshape(b, grid[0], grid[1], d), precision)

    def forward(self, content_unit: torch.Tensor, style: StyleMemory,
                precision: Precision = Precision.f32()) -> torch.Tensor:
        tokens, pos, grid = self.embed(content_unit, precision)
        t = self.decode(self.encode(tokens, pos), pos, style)
        return self.cnn(t, grid, precision)


# -- weights ------------------------------------------------------------------

PARTS = ("embedding", "transformer", "decoder")


def _expected_keys() -> Dict[str, set]:
    with torch.device("meta"):
        model = StyTr2()
    return {part: set(getattr(model, part).state_dict()) for part in PARTS}


def _read(obj: Union[str, os.PathLike, Mapping]) -> Mapping:
    if isinstance(obj, Mapping):
        return obj
    return torch.load(obj, map_location="cpu", weights_only=True)


def load_stytr2(embedding, transformer, decoder) -> StateDict:
    """The official checkpoints' three state dicts (mappings or ``.pth``
    paths: ``embedding_iter_*.pth``, ``transformer_iter_*.pth``,
    ``decoder_iter_*.pth``) -> ``StyTr2``'s state_dict. Each must hold
    exactly its part's keys: ``proj.*``; ``encoder_c|encoder_s|decoder.
    layers.N.{self_attn,multihead_attn}.{in_proj_weight,in_proj_bias,
    out_proj.*}``, ``linear1/2``, ``norm1-3``, ``decoder.norm``, ``new_ps``;
    the AdaIN decoder's ``nn.Sequential`` indices. Shapes are checked when
    the state_dict is loaded."""
    expected = _expected_keys()
    out: StateDict = {}
    for part, obj in zip(PARTS, (embedding, transformer, decoder)):
        sd = _read(obj)
        got = set(sd)
        missing, unexpected = expected[part] - got, got - expected[part]
        if missing or unexpected:
            raise ValueError(f"StyTr² {part} state_dict: missing {sorted(missing)[:6]}, "
                             f"unexpected {sorted(unexpected)[:6]}")
        out.update({f"{part}.{k}": torch.as_tensor(v).float() for k, v in sd.items()})
    return out


def load_stytr2_checkpoint(path: Union[str, os.PathLike]) -> StateDict:
    """A directory holding the official ``embedding*.pth``,
    ``transformer*.pth`` and ``decoder*.pth``, one each."""
    files = []
    for part in PARTS:
        found = sorted(Path(path).glob(f"{part}*.pth"))
        if len(found) != 1:
            raise FileNotFoundError(f"{path}: want one {part}*.pth, found {len(found)}")
        files.append(found[0])
    return load_stytr2(*files)


def widths_of(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """``StyTr2``'s sizes read from a state_dict's shapes and keys."""
    def layers(prefix):
        return len({k[len(prefix):].split(".")[0] for k in state_dict if k.startswith(prefix)})

    return {"d_model": state_dict["embedding.proj.weight"].shape[0],
            "dim_feedforward": state_dict["transformer.encoder_c.layers.0.linear1.weight"].shape[0],
            "num_encoder_layers": layers("transformer.encoder_c.layers."),
            "num_decoder_layers": layers("transformer.decoder.layers.")}


def make_stytr2(state_dict: Optional[Mapping[str, torch.Tensor]], device) -> StyTr2:
    """A ``StyTr2`` of ``state_dict``'s sizes on ``device`` with it loaded
    (None: the published sizes, the official initialization from the global
    generator), in eval mode."""
    if state_dict is None:
        model = StyTr2()
    else:
        model = StyTr2(**widths_of(state_dict))
        model.load_state_dict(state_dict, strict=True)
    return model.to(device, memory_format=torch.channels_last).eval()
