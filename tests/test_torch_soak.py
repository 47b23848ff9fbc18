"""The port's preemption drill (``tools/soak.py``): JAX's six watchdog
tests (``tests/test_soak_watchdog.py``) on the port's module, with a fake
trainer put in for ``_trainer_argv`` (launch and relaunch counting, stall
detection by the metrics' staleness, the start-up grace while a child has
no row, the SIGTERM sent exactly once), then one real drill of the port's
trainer on the CPU: 64x64, batch 2, 6 steps, SIGTERM at step 3, under a
120 s deadline. It must end at step 6 with no step logged twice, every
loss finite, and the resumed child's first logged step one past the
checkpoint the SIGTERM left.
"""

import json
import os
import sys
import time

from fast_neural_style_transfer_tpu_torch.tools import adain_soak, soak
from fast_neural_style_transfer_tpu_torch.train.checkpoint import CheckpointManager


def _fake_trainer(tmp_path, body: str):
    """argv factory for a fake trainer; ``body`` runs with OUT (outdir),
    METRICS (metrics path) and LAUNCHES (a per-test launch-count file)
    defined, and appends one line to LAUNCHES at startup."""

    def argv(outdir):
        code = (
            "import json, os, signal, sys, time\n"
            f"OUT = {str(tmp_path)!r}\n"
            "METRICS = os.path.join(OUT, 'metrics.jsonl')\n"
            "LAUNCHES = os.path.join(OUT, 'launches.txt')\n"
            "open(LAUNCHES, 'a').write('x\\n')\n"
            "open(METRICS, 'a').close()\n"  # like the real loop: file first
            + body
        )
        return [sys.executable, "-c", code]

    return argv


def _launches(tmp_path) -> int:
    try:
        with open(tmp_path / "launches.txt") as f:
            return len(f.readlines())
    except OSError:
        return 0


def _write_rows(upto: int):
    return (
        f"for s in range(50, {upto} + 1, 50):\n"
        "    open(METRICS, 'a').write(json.dumps({'step': s}) + '\\n')\n"
        "    time.sleep(0.05)\n"
    )


def test_healthy_child_runs_once(tmp_path, monkeypatch):
    monkeypatch.setattr(soak, "_trainer_argv",
                        _fake_trainer(tmp_path, _write_rows(200)))
    soak.run_phase(str(tmp_path), stall_s=5.0, poll_s=0.1, backoff_s=0.0)
    assert _launches(tmp_path) == 1


def test_stalled_child_is_killed_and_relaunched(tmp_path, monkeypatch):
    # 1st launch: one row then hang forever; later launches: finish cleanly.
    body = (
        "if len(open(LAUNCHES).readlines()) == 1:\n"
        "    open(METRICS, 'a').write(json.dumps({'step': 50}) + '\\n')\n"
        "    time.sleep(600)\n"
        + _write_rows(200)
    )
    monkeypatch.setattr(soak, "_trainer_argv", _fake_trainer(tmp_path, body))
    t0 = time.time()
    soak.run_phase(str(tmp_path), stall_s=5.0, poll_s=0.1, backoff_s=0.0)
    assert _launches(tmp_path) == 2
    assert time.time() - t0 < 120  # killed the hang, didn't sit out 600 s


def test_compile_grace_covers_rowless_startup(tmp_path, monkeypatch):
    # Empty metrics file + no rows for longer than stall_s must NOT trip the
    # watchdog while within the compile grace (the round-5 false positive).
    monkeypatch.setattr(soak, "_COMPILE_GRACE_S", 30.0)
    body = "time.sleep(4.0)\n" + _write_rows(100)
    monkeypatch.setattr(soak, "_trainer_argv", _fake_trainer(tmp_path, body))
    # stall_s comfortably above child interpreter-exit lag (a child that
    # has written its last row but not yet exited must not read as stalled)
    soak.run_phase(str(tmp_path), stall_s=8.0, poll_s=0.1, backoff_s=0.0)
    assert _launches(tmp_path) == 1  # 4 s rowless < 8 + 30 s grace


def test_stale_rows_from_previous_child_do_not_retrip(tmp_path, monkeypatch):
    # Rows mtimed BEFORE this launch must count as "no row from this child"
    # (grace), not as instant staleness.
    monkeypatch.setattr(soak, "_COMPILE_GRACE_S", 30.0)
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"step": 50}) + "\n")
    old = time.time() - 1000
    os.utime(tmp_path / "metrics.jsonl", (old, old))
    body = "time.sleep(1.0)\n" + _write_rows(100)
    monkeypatch.setattr(soak, "_trainer_argv", _fake_trainer(tmp_path, body))
    soak.run_phase(str(tmp_path), stall_s=8.0, poll_s=0.1, backoff_s=0.0)
    assert _launches(tmp_path) == 1


def test_drill_sigterm_sent_exactly_once(tmp_path, monkeypatch):
    # Child writes rows past kill_at_step and records any SIGTERM received;
    # a graceful exit after SIGTERM ends the phase with one launch.
    body = (
        "hits = os.path.join(OUT, 'sigterms.txt')\n"
        "def h(sig, frm):\n"
        "    open(hits, 'a').write('t\\n')\n"
        "    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, h)\n"
        "for s in range(50, 801, 50):\n"
        "    open(METRICS, 'a').write(json.dumps({'step': s}) + '\\n')\n"
        "    time.sleep(0.05)\n"
    )
    monkeypatch.setattr(soak, "_trainer_argv", _fake_trainer(tmp_path, body))
    soak.run_phase(str(tmp_path), kill_at_step=500, stall_s=10.0,
                   poll_s=0.1, backoff_s=0.0)
    assert _launches(tmp_path) == 1
    with open(tmp_path / "sigterms.txt") as f:
        assert len(f.readlines()) == 1


def test_child_exiting_before_drill_is_relaunched(tmp_path, monkeypatch):
    # A crash before the drill step must relaunch until the drill happens.
    body = (
        "n = len(open(LAUNCHES).readlines())\n"
        "if n == 1:\n"
        "    open(METRICS, 'a').write(json.dumps({'step': 100}) + '\\n')\n"
        "    sys.exit(1)\n"  # dies before kill_at_step
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
        "for s in range(150, 801, 50):\n"
        "    open(METRICS, 'a').write(json.dumps({'step': s}) + '\\n')\n"
        "    time.sleep(0.05)\n"
    )
    monkeypatch.setattr(soak, "_trainer_argv", _fake_trainer(tmp_path, body))
    soak.run_phase(str(tmp_path), kill_at_step=500, stall_s=10.0,
                   poll_s=0.1, backoff_s=0.0)
    assert _launches(tmp_path) == 2


def test_deadline_kills_the_child(tmp_path, monkeypatch):
    monkeypatch.setattr(soak, "_trainer_argv",
                        _fake_trainer(tmp_path, "time.sleep(600)\n"))
    t0 = time.time()
    try:
        soak.run_phase(str(tmp_path), stall_s=600.0, poll_s=0.1, backoff_s=0.0,
                       deadline_s=3.0)
    except TimeoutError:
        pass
    else:
        raise AssertionError("no TimeoutError past the deadline")
    assert time.time() - t0 < 60 and _launches(tmp_path) == 1


def test_real_drill_on_the_cpu(tmp_path, monkeypatch):
    # one intra-op thread a child: the suite runs with several xdist workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = str(tmp_path / "data")
    soak.make_dataset(data, 6)
    out = str(tmp_path / "out")
    rc = soak.run_config(out, create=True, total_steps=6, batch=2, ckpt_every=100,
                         image_size=64, log_every=1, dataset_dir=data, device="cpu")
    assert soak.run_config(out) == rc  # pinned for phase_b
    t0 = time.time()
    assert soak.run_phase(out, kill_at_step=rc["total_steps"] // 2, poll_s=0.05,
                          deadline_s=120.0) == 0
    sigterm_ckpt = CheckpointManager(os.path.join(out, "checkpoints")).latest_step()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows_a = len(f.readlines())
    assert 3 <= sigterm_ckpt < 6  # the SIGTERM landed mid-run
    assert soak.run_phase(out, poll_s=0.05, deadline_s=120.0 - (time.time() - t0)) == 0
    rep = soak.report(out)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rep["max_step"] == 6 and rep["duplicate_steps_after_resume"] == 0
    assert rows[rows_a]["step"] == sigterm_ckpt + 1
    assert all(isinstance(r["loss"], float) and abs(r["loss"]) < float("inf")
               and r["loss"] == r["loss"] for r in rows)
    assert rep["nonfinite_skips"] == 0 and rep["checkpoints"][-1] == 6
    assert os.path.exists(os.path.join(out, "style_transfer_final.npz"))


def test_adain_drill_runs_its_own_trainer(tmp_path, monkeypatch):
    """The AdaIN drill is ``soak.run_phase`` with the AdaIN trainer's
    argv, and its config pins its own parameters."""
    calls = []
    monkeypatch.setattr(soak, "run_phase",
                        lambda outdir, kill, **kw: calls.append((outdir, kill, kw)) or 0)
    rc = adain_soak.run_config(str(tmp_path), create=True, total_steps=8)
    assert rc["batch"] == 8 and rc["total_steps"] == 8
    adain_soak.main(["phase_a", str(tmp_path)])
    ((outdir, kill, kw),) = calls
    assert outdir == str(tmp_path) and kill == 4
    argv = kw["trainer_argv"](outdir)
    assert argv[0] == sys.executable and "train_adain(_cfg(" in argv[-1]
    cfg = adain_soak._cfg(str(tmp_path))
    assert cfg.total_steps == 8 and cfg.precision == "bf16" and cfg.device is None


def test_sigterm_reaches_the_spawned_ranks(tmp_path, monkeypatch):
    """A drill child whose trainer spawned its ranks (``parallel.mesh.
    launch``: 2 height ranks on the CPU, 32x32, batch 2) gets the SIGTERM
    as the launcher: it passes it on, every rank stops at one step, rank 0
    checkpoints that step once, and the child exits 0, all within a 120 s
    deadline."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = str(tmp_path / "data")
    soak.make_dataset(data, 4)
    out = str(tmp_path / "out")

    def argv(outdir):
        code = (
            f"import sys; sys.path.insert(0, {str(soak.REPO)!r});"
            "from fast_neural_style_transfer_tpu_torch.train.loop import "
            "TrainConfig, train_style_transfer;"
            "train_style_transfer(TrainConfig("
            f"style_image={os.path.join(outdir, 'style.jpg')!r}, dataset_dir={data!r}, "
            f"output_dir={outdir!r}, total_steps=40, batch_size=2, image_size=(32, 32), "
            "spatial=2, checkpoint_every=1000, log_every=1, num_workers=1, device='cpu'))"
        )
        return [sys.executable, "-c", code]

    assert soak.run_phase(out, kill_at_step=2, trainer_argv=argv, poll_s=0.05,
                          deadline_s=120.0) == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert CheckpointManager(os.path.join(out, "checkpoints")).labels() == [steps[-1]]
    assert 2 <= steps[-1] < 40 and steps == list(range(1, steps[-1] + 1))
