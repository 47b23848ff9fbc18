#!/usr/bin/env python3
"""The AdaAttN cell's comparison with the moment attention on another route.

    python3 tools/adaattn_composition_limits.py --route composition --seeds 8 \
        --seed-base 3000000000
    python3 tools/adaattn_composition_limits.py --route kernel --seeds 8 \
        --seed-base 3000000000

Runs ``port_bench/calibrate.py limits`` on ``adaattn.serve.512-closed``
(the program served at the cell's load over ``--seeds`` seeds, no control)
with the stylizer's moment attention on ``--route``:

- ``kernel``: the program as it is (``csrc/moment_attention.cu``);
- ``composition``: the library's alternative, the official code's bmm /
  softmax / bmm in bf16 (bf16 scores, weights and both moments, summed in
  fp32 by cuBLAS) on the same shifted values the kernel reads
  (``prepare_values``), the epilogue in fp32.

The same ``--seed-base`` gives both routes the same seeds, so their
``du8_mean`` and ``du8_p999`` can be set side by side against the cell's
limits. Needs the card; JSON lines on standard output, as calibrate.py's.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "adaattn.serve.512-closed"


def composition(q, k, mv, c, block: int = 4096):
    """``S * c + M`` from the library's bf16 products on the shifted values."""
    import torch

    v1, v2 = mv.values[:, :, :k.shape[0]].transpose(1, 2)
    kt = k.t()
    out = torch.empty(c.shape, dtype=q.dtype, device=q.device)
    for i in range(0, q.shape[1], block):
        a = torch.softmax(q[:, i:i + block] @ kt, dim=-1)
        m, e2 = (a @ v1).float(), (a @ v2).float()
        s = torch.sqrt(torch.relu(e2 - m.square()))
        out[:, i:i + block] = (s * c[:, i:i + block].float() + m + mv.shift).to(q.dtype)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--route", choices=("kernel", "composition"), required=True)
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--seed-base", type=int, default=2 ** 31)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "port_bench"), str(ROOT)]
    import calibrate

    from fast_neural_style_transfer_tpu_torch.models import adaattn as model

    if args.route == "composition":
        model.moment_attention = composition
    print(f'{{"route": "{args.route}"}}', flush=True)
    return calibrate.main(["limits", "--workload", CELL, "--seeds", str(args.seeds),
                           "--control-seeds", "0", "--seed-base", str(args.seed_base),
                           "--seconds", str(args.seconds)])


if __name__ == "__main__":
    sys.exit(main())
