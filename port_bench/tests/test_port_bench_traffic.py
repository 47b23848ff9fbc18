"""The seeded generators: repeatable by seed, and true to each cell's
parameters (rate, size range, one bucket, the training folder)."""

import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from harness import seeded, serving, training  # noqa: E402

BIG = 2 ** 31 + 12345


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _params(cell):
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())


def _one_bucket(traffic, sched):
    lo, hi, m = traffic["side_min"], traffic["side_max"], traffic["bucket_multiple"]
    for sides in (sched.h, sched.w):
        assert sides.min() >= lo and sides.max() <= hi
    assert {-(-s // m) * m for s in np.concatenate([sched.h, sched.w])} == {hi}


def _sample_is_drawn_from_the_seed(sched, answered):
    sample = sched.sample(answered)
    assert len(sample) == serving.SAMPLE
    assert sample[0] == max(answered, key=lambda i: (int(sched.h[i]) * int(sched.w[i]), -i))
    assert sched.sample(set(answered) - {sample[0]})[0] != sample[0]
    # the answers kept while they come are those judged, whatever their order
    for order in (answered, answered[::-1], np.random.default_rng(0).permutation(answered)):
        keeper = serving.Keeper(sched)
        for i in order:
            keeper.offer(int(i), i)
        assert [i for i, _ in keeper.sample()] == sample
        assert len(keeper.outs) <= serving.SAMPLE + 1


@pytest.mark.parametrize("cell,mix", [("stylenet-ref.serve.256-low", "photo256")])
def test_open_loop_schedule_is_repeatable_and_true_to_the_cell(cell, mix):
    traffic, params = _traffic(mix), _params(cell)
    rate = params["rate_per_s"]
    a = serving.Schedule(traffic, params, 10.0, BIG)
    b = serving.Schedule(traffic, params, 10.0, BIG)
    c = serving.Schedule(traffic, params, 10.0, BIG + 1)
    assert np.array_equal(a.due, b.due) and np.array_equal(a.h, b.h)
    assert not np.array_equal(a.due, c.due)
    assert a.n == round(rate * 10.0)
    assert np.all(np.diff(a.due) >= 0) and a.due[0] >= 0 and a.due[-1] < 10.0
    # every seed the same sizes, in another order
    assert np.array_equal(np.sort(a.h), np.sort(c.h))
    _one_bucket(traffic, a)
    _sample_is_drawn_from_the_seed(a, list(range(a.n)))


@pytest.mark.parametrize("cell,mix", [("stylenet-ref.serve.512-closed", "photo512-closed"),
                                      ("adain-vgg19.serve.512-closed", "photo512-closed")])
def test_closed_loop_schedule_is_repeatable_and_true_to_the_cell(cell, mix):
    traffic, params = _traffic(mix), _params(cell)
    a = serving.Schedule(traffic, params, 10.0, BIG)
    b = serving.Schedule(traffic, params, 10.0, BIG)
    c = serving.Schedule(traffic, params, 10.0, BIG + 1)
    assert a.due is None and a.n == traffic["clients"] + 10 * traffic["ceiling_per_s"]
    assert np.array_equal(a.h, b.h) and np.array_equal(a.key, b.key)
    assert not np.array_equal(a.h, c.h)
    assert np.array_equal(np.sort(a.h), np.sort(c.h))
    _one_bucket(traffic, a)
    # a closed loop answers a prefix of the schedule
    _sample_is_drawn_from_the_seed(a, list(range(3000)))


def test_closed_loop_keeps_its_clients_busy_and_stops_at_the_close():
    import queue
    import threading
    import time

    from harness.arrivals import closed

    traffic = {"clients": 3, "ceiling_per_s": 1000}
    freed, sent, lock = queue.Queue(), [], threading.Lock()
    outstanding = [0]

    def submit(i):
        with lock:
            sent.append(i)
            outstanding[0] += 1
            assert outstanding[0] <= traffic["clients"]
        threading.Timer(0.01, answer, (i,)).start()

    def answer(i):
        with lock:
            outstanding[0] -= 1
        freed.put(i)

    t0 = time.perf_counter()
    closed.drive(traffic, 3 + 300, None, submit, freed, t0, 0.3)
    assert time.perf_counter() - t0 < 0.5
    assert sent == list(range(len(sent))) and 30 < len(sent) < 3 + 300
    short = queue.Queue()
    with pytest.raises(RuntimeError, match="ceiling_per_s"):
        closed.drive(traffic, 5, None, short.put, short, time.perf_counter(), 0.3)


def test_an_unknown_arrivals_or_kind_is_refused():
    from harness import arrivals, spec

    with pytest.raises(SystemExit, match="bursts"):
        arrivals.load("bursts")
    with pytest.raises(SystemExit, match="bulk"):
        spec.runner("bulk")


def test_images_and_weights_are_repeatable_by_seed():
    from reference import stylenet

    assert np.array_equal(seeded.images(2, 32, 48, BIG, "cpu"), seeded.images(2, 32, 48, BIG, "cpu"))
    w1 = seeded.weights(stylenet.param_spec(), BIG, "cpu")
    w2 = seeded.weights(stylenet.param_spec(), BIG, "cpu")
    assert all(np.array_equal(w1[k].numpy(), w2[k].numpy()) for k in w1)
    assert seeded.sub_seed(BIG, 1) != seeded.sub_seed(BIG, 2)


def test_training_folder_is_repeatable_and_true_to_the_mix(tmp_path):
    from PIL import Image

    traffic = dict(_traffic("cli-train256"), images=12, side_min=40, side_max=72, workers=2)
    dirs = []
    for name in ("a", "b"):
        os.makedirs(tmp_path / name)
        dirs.append(training.write_folder(str(tmp_path / name), traffic, BIG, "cpu"))
    files = sorted(os.listdir(dirs[0]))
    assert len(files) == 12 and files == sorted(os.listdir(dirs[1]))
    for f in files:
        with Image.open(os.path.join(dirs[0], f)) as im:
            w, h = im.size
        assert 40 <= w <= 72 and 40 <= h <= 72
        assert (Path(dirs[0]) / f).read_bytes() == (Path(dirs[1]) / f).read_bytes()
