"""A whole run driven on the CPU at a tiny size, past the look for a card:
the last line's schema, and ``correct`` coming out false with the timed
path broken underneath (an answer altered where it is produced; a step that
leaves its state unchanged; half of each batch left out, the rest counted
twice)."""

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import pytest  # noqa: E402
import torch  # noqa: E402

import run  # noqa: E402
from harness import spec  # noqa: E402

CPU = torch.device("cpu")
SERVE = {"kind": "serving", "side_min": 33, "side_max": 64, "bucket_multiple": 64,
         "max_batch": 4, "max_wait_ms": 5.0, "max_pending": 256}
TRAIN = {"kind": "training", "batch_size": 4, "image_size": 32, "images": 12, "side_min": 40,
         "side_max": 64, "jpeg_quality": 90, "workers": 2, "prefetch": 2, "transport": "u8",
         "lr": 1e-3, "total_steps": 80000}


def tiny(name: str):
    """The named cell at a size the CPU holds: its metrics, configuration
    and limits, with small images, batches, rate and clients."""
    cell = spec.load_cell(name)
    if cell.traffic["kind"] == "serving":
        arrivals = {k: cell.traffic[k] for k in ("arrivals", "clients", "ceiling_per_s")
                    if k in cell.traffic}
        cell.traffic = dict(SERVE, **arrivals)
        if "clients" in arrivals:
            cell.traffic["clients"] = 3 * SERVE["max_batch"]
        cell.params = dict(cell.params, rate_per_s=16)
    else:
        cell.traffic = dict(TRAIN)
    return cell


def last_line(capsys, name: str, trace: int = 0, seed: int = 2 ** 31 + 77) -> dict:
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.7",
                   "--trace", str(trace)], device=CPU, cell=tiny(name))
    assert rc == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)
    return result


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["stylenet-ref.serve.512-closed", "stylenet-ref.serve.256-low",
                                  "stylenet-ref.train.256"])
def test_last_line_schema(capsys, name, trace):
    r = last_line(capsys, name, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    cell = spec.load_cell(name)
    want = {m.name for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][key]) <= 10
    assert set(r["checks"]) == set(cell.params["limits"])
    if cell.traffic["kind"] == "serving":
        assert r["correct"] is True and r["failed"] == 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(capsys, monkeypatch):
    from fast_neural_style_transfer_tpu_torch.infer import stylize

    good = stylize.network_to_u8

    def altered(y):
        out = good(y).clone()
        out[:, :8, :8] = 255 - out[:, :8, :8]
        return out

    monkeypatch.setattr(stylize, "network_to_u8", altered)
    assert last_line(capsys, "stylenet-ref.serve.512-closed")["correct"] is False


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(capsys, monkeypatch):
    from fast_neural_style_transfer_tpu_torch.train import state

    monkeypatch.setattr(state.StyleOptimizer, "update", lambda self, grads: False)
    r = last_line(capsys, "stylenet-ref.train.256")
    assert r["correct"] is False and r["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_each_batch_left_out_is_not_correct(capsys, monkeypatch):
    from fast_neural_style_transfer_tpu_torch.train import step

    good = step.normalize_u8_batch

    def half(batch):
        h = batch.shape[0] // 2
        return good(torch.cat([batch[:h], batch[:h]]))

    monkeypatch.setattr(step, "normalize_u8_batch", half)
    r = last_line(capsys, "stylenet-ref.train.256")
    gap = r["checks"]["loss1_gap"]
    assert r["correct"] is False and gap["value"] > gap["limit"]
