"""The port's benchmark: one cell, one run, one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files by name (``BENCHMARK.json`` at the checkout's root,
``port_bench/configs``, ``traffic``, ``workloads``, ``metrics``), makes the
weights and the traffic from the seed on the card, warms the cell's own
shapes, measures for ``--seconds``, judges what the timed path produced
against the plain reference, and prints the result as the last line of
standard output. ``--trace 1`` runs the same window under
``torch.profiler`` and reports the cell's per-layer metrics instead of its
end-to-end ones. Without a card, or with JAX or the JAX package loaded, it
exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]
# every kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: torch's CPU thread pool spinning beside the
# server's threads made latencies wander from run to run
os.environ.setdefault("OMP_NUM_THREADS", "1")

from harness import guard, spec  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def measure(cell, seed: int, seconds: float, trace: bool, device):
    """One run of the cell's runner -> its record, with the counts and peaks
    the metric readers need."""
    import torch

    from counts import for_arch
    from counts.peaks import peaks_for

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec = spec.runner(cell.traffic["kind"]).run(cell, seed, seconds, device, trace, T_START)
    rec.counts = for_arch(cell.config["arch"])
    rec.peaks = peaks_for(device_name(device))
    return rec


def judge(cell, rec) -> tuple:
    """(correct, checks): every number compared, beside its limit."""
    checks = {}
    for name, limit in cell.params["limits"].items():
        value = rec.checks.get(name)
        checks[name] = {"value": value, "limit": limit}
    # a request the batcher refused under backpressure is counted in
    # "failed" but is no wrong answer; a lost one, or an error, is
    correct = (getattr(rec, "lost", rec.failed) == 0 and
               all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks


def main(argv=None, device=None, cell=None) -> int:
    """``device`` and ``cell`` are for tests, which drive a run on the CPU
    past the look for a card; the benchmark passes neither."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cell or spec.load_cell(args.workload)
    if device is None:
        guard.require_cards(cell.chips)
    import torch

    if device is None:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    rec = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.read(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    correct, checks = judge(cell, rec)
    from fast_neural_style_transfer_tpu_torch.ops import _build

    lat = getattr(rec, "lateness_ms", None)
    if lat is not None:
        import numpy as np
        ok = np.isfinite(lat)
        print("lateness ms (sent - due): p50 %.4f p99 %.4f max %.4f over %d"
              % (np.percentile(lat[ok], 50), np.percentile(lat[ok], 99), lat[ok].max(),
                 int(ok.sum())), file=sys.stderr)
    print("kernel builds this run (s): " + json.dumps(
        {k: v["seconds"] for k, v in _build.build_info.items()}), file=sys.stderr)
    bad = guard.forbidden_modules()
    if bad:
        print("port_bench: refused: loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": device_name(device), "count": 1,
                   "memory_peak_bytes": int(rec.memory_peak_bytes),
                   "power_limit": power_limit()}
    result = {"correct": correct, "attempted": int(rec.attempted), "failed": int(rec.failed),
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown(rec.host_spans, rec.idle_label)
    result["build_s"] = {k: v["seconds"] for k, v in _build.build_info.items()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
