"""CUDA graphs of the serving forward (``infer/graphs.py``, through
``infer/stylize.py::serve_u8``).

- On the CPU: the rule that decides whether a stylizer serves through
  graphs; the cache's key, capture on a key's second call, eviction of a
  stale graph only, its counters, and the kernels' launch counters (listed
  by ``ops/_build.py::counted``) across a capture and a replay, driven
  through a stand-in for the capture; ``stylize.replay`` inside
  ``stylize.launch``; the per-device constants a capture needs; the CPU
  stylizers keep the eager path.
- The ``gpu``-marked tests hold every replay to the eager output bit for
  bit (the luma transfer too), keys replayed in another order than
  captured, count the launches a forward on each path and the kernels in a
  device trace of a replay, and check that the paths that stay eager
  capture nothing. They decide inside the test whether a card exists. This
  file imports no JAX.
"""

import re

import numpy as np
import pytest
import torch
from test_torch_pad import _composed, _he_decoder
from torch.profiler import ProfilerActivity, profile

from fast_neural_style_transfer_tpu_torch.infer import graphs as graphs_module
from fast_neural_style_transfer_tpu_torch.infer.graphs import (
    MAX_GRAPHS,
    ForwardGraphs,
    add_launch_counts,
    engages,
    launch_counts,
)
from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer, serve_u8
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.ops import conv, cuda_norm
from fast_neural_style_transfer_tpu_torch.parallel.mesh import ReplicaPlan
from fast_neural_style_transfer_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(prev)


def _u8(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


class StandIn:
    """A capture that needs no card: the program runs once at capture (as a
    capture records its launches), and each replay runs it again into the
    static outputs, its counts taken back (a replay calls no wrapper)."""

    def __init__(self, x, program):
        self.x, self.program = x, program
        self.outs = [o.clone() for o in program(x)]

    def replay(self):
        before = launch_counts()
        for static, o in zip(self.outs, self.program(self.x)):
            static.copy_(o)
        add_launch_counts({k: n - before[k] for k, n in launch_counts().items()}, -1)

    @classmethod
    def capture(cls, x, program):
        g = cls(x, program)
        return g, g.outs


def _launch(calls):
    """A stand-in forward on the CPU: each call bumps the kernels' counters
    as a stylizer forward on the card does (13 pads, 14 IN launches) and
    inverts the u8 input."""

    def launch(x):
        calls.append(tuple(x.shape))
        conv.reflect_pad_hw.launches += 13
        cuda_norm.instance_norm_fwd.launches += 14
        cuda_norm.instance_norm_fwd.launches_by_mode["plain"] += 14
        return [255 - x]

    return launch


# -- when graphs engage ------------------------------------------------------

@pytest.mark.parametrize("device, kw, on", [
    ("cuda", {}, True),
    ("cuda:1", {}, True),
    ("cpu", {}, False),
    ("cuda", {"int8": True}, False),
    ("cuda", {"sharding": ReplicaPlan((torch.device("cuda", 0), torch.device("cuda", 0)))},
     False),
    ("cuda", {"sharding": ReplicaPlan((torch.device("cuda", 0), torch.device("cuda", 1)))},
     False),
    ("cuda", {"sharding": ReplicaPlan((torch.device("cuda", 0),))}, True),
    ("cpu", {"sharding": ReplicaPlan((torch.device("cpu"),))}, False),
], ids=["card", "second-card", "cpu", "int8", "two-replicas-one-card", "two-cards",
        "one-device-plan", "cpu-plan"])
def test_graphs_engage_only_on_an_unsharded_card_without_int8(device, kw, on):
    assert engages(torch.device(device), **kw) is on


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_cpu_stylizer_keeps_the_eager_path(precision):
    """No cache on the CPU, every count 0, and the output that of the u8
    round trip composed by hand: pad up to the bucket, the network, crop."""
    torch.manual_seed(0)
    sty = Stylizer(TransformerNet().state_dict(), precision=precision, bucket_multiple=16,
                   device="cpu")
    assert sty._graphs is None
    batch = _u8(2, 12, 20, seed=1)
    got = sty.stylize_u8(batch)
    again = sty.stylize_u8(batch)
    assert (sty.graph_captures, sty.graph_replays, sty.graph_evictions) == (0, 0, 0)
    with torch.inference_mode():
        from fast_neural_style_transfer_tpu_torch.core.shapes import pad_to_multiple_reflect
        padded, _ = pad_to_multiple_reflect(torch.from_numpy(batch), 16)
        (want,) = sty._u8_roundtrip([padded])
    np.testing.assert_array_equal(got, want[:, :12, :20].numpy())
    np.testing.assert_array_equal(again, got)


def test_cpu_arbitrary_stylizer_has_no_graphs():
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models.adain import AdaINDecoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params

    ada = ArbitraryStylizer(AdaINDecoder().state_dict(), random_params(0), device="cpu")
    assert ada._graphs is None and ada.graph_captures == 0


def test_device_constants_are_made_once_per_device():
    """The ImageNet mean/std and the YIQ matrices a forward reads are made
    once per device (a capture refuses the copies that make them), outside
    inference mode, so autograd may use them too."""
    from fast_neural_style_transfer_tpu_torch.utils import color
    from fast_neural_style_transfer_tpu_torch.utils.image_io import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        mean_std,
    )

    cpu = torch.device("cpu")
    with torch.inference_mode():
        mean, std = mean_std(cpu)
        rgb2yiq, yiq2rgb = color._yiq(cpu)
    assert mean_std(cpu)[0] is mean and mean_std(cpu)[1] is std
    assert color._yiq(cpu)[0] is rgb2yiq and color._yiq(cpu)[1] is yiq2rgb
    assert not mean.is_inference() and not rgb2yiq.is_inference()
    np.testing.assert_array_equal(mean.numpy(), IMAGENET_MEAN)
    np.testing.assert_array_equal(std.numpy(), IMAGENET_STD)
    assert rgb2yiq.tolist() == torch.tensor(color._RGB2YIQ).tolist()
    assert yiq2rgb.tolist() == torch.tensor(color._YIQ2RGB).tolist()


def test_every_counted_kernel_wrapper_is_listed():
    """``ops/_build.py::counted`` lists each wrapper whose launches a
    replay has to count again; ``parallel.mesh.kernel_counts`` reads the
    same list. AdaAttN's kernel lists itself when its module is imported,
    which nothing else on the other paths does."""
    from fast_neural_style_transfer_tpu_torch.ops import (  # noqa: F401 (lists the kernel)
        _build,
        cuda_conv,
        cuda_moment_attention,
    )
    from fast_neural_style_transfer_tpu_torch.parallel.mesh import kernel_counts

    names = [fn.__name__ for fn in _build.COUNTED]
    assert sorted(names) == ["conv2d_same_bwd", "conv2d_same_dx", "conv_to_rgb",
                             "instance_norm_bwd", "instance_norm_fwd", "moment_attention",
                             "reflect_pad_hw"]
    counts = kernel_counts()
    assert set(counts) == set(names)
    assert set(counts["instance_norm_fwd"]) == {
        "launches", "launches_by_route", "launches_by_affine", "launches_by_mode"}
    assert counts["conv2d_same_dx"]["launches_by_route"] == dict(
        cuda_conv.conv2d_same_dx.launches_by_route)
    assert set(counts["reflect_pad_hw"]) == set(counts["conv_to_rgb"]) == {"launches"}


def test_counted_gives_a_wrapper_zeroed_counters(monkeypatch):
    from fast_neural_style_transfer_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "COUNTED", [])

    def wrapper():
        pass

    _build.counted(wrapper, route=("a", "b"))
    assert wrapper.launches == 0 and wrapper.launches_by_route == {"a": 0, "b": 0}
    assert _build.COUNTED == [wrapper]


# -- the cache, through a stand-in capture ------------------------------------

def test_a_key_is_captured_on_its_second_call_and_replayed_after():
    calls = []
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch(calls)
    a, b, c = (_u8(2, 10, 12, seed=s) for s in (1, 2, 3))
    got_a = serve_u8(a, torch.device("cpu"), 8, launch, graphs)
    # the first call ran eagerly and was only noted
    assert len(calls) == 1 and (graphs.captures, graphs.replays) == (0, 0)
    assert graphs.keys() == []
    got_b = serve_u8(b, torch.device("cpu"), 8, launch, graphs)
    # the second: eagerly, then captured (the stand-in runs the program)
    assert len(calls) == 3 and (graphs.captures, graphs.replays) == (1, 0)
    assert graphs.keys() == [(2, 10, 12)]
    got_c = serve_u8(c, torch.device("cpu"), 8, launch, graphs)
    assert (graphs.captures, graphs.replays) == (1, 1)
    # the bucket pad is part of the program: (10, 12) -> (16, 16)
    assert set(calls) == {(2, 16, 16, 3)}
    np.testing.assert_array_equal(got_a, 255 - a)
    np.testing.assert_array_equal(got_b, 255 - b)
    np.testing.assert_array_equal(got_c, 255 - c)  # the new input, copied in
    got_a1 = serve_u8(a[0], torch.device("cpu"), 8, launch, graphs)  # HWC: rows 1
    np.testing.assert_array_equal(got_a1, 255 - a[0])
    assert graphs.keys() == [(2, 10, 12)] and graphs.captures == 1


def test_keys_met_once_run_eagerly_and_capture_nothing():
    """A bulk job of one-off photo sizes: each runs its eager forward once
    and nothing else."""
    calls = []
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch(calls)
    sizes = [(8 + i, 8 + 2 * i) for i in range(40)]
    for h, w in sizes:
        x = _u8(1, h, w, seed=h)
        np.testing.assert_array_equal(serve_u8(x, torch.device("cpu"), 8, launch, graphs),
                                      255 - x)
    assert len(calls) == len(sizes)
    assert (graphs.captures, graphs.replays, graphs.evictions) == (0, 0, 0)


def test_launch_counters_count_one_forward_per_call_on_every_path():
    """The capture's own increments are taken back; a replay adds the
    forward's again: 13 pads and 14 IN launches a call, whichever path."""
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch([])
    x = _u8(1, 16, 16, seed=3)
    for _ in range(4):  # eager, eager + capture, then two replays
        pads = conv.reflect_pad_hw.launches
        ins = dict(cuda_norm.instance_norm_fwd.launches_by_mode)
        total = cuda_norm.instance_norm_fwd.launches
        serve_u8(x, torch.device("cpu"), 8, launch, graphs)
        assert conv.reflect_pad_hw.launches - pads == 13
        assert cuda_norm.instance_norm_fwd.launches - total == 14
        assert cuda_norm.instance_norm_fwd.launches_by_mode["plain"] - ins["plain"] == 14
        assert cuda_norm.instance_norm_fwd.launches_by_mode["capture"] == ins["capture"]
    assert (graphs.captures, graphs.replays) == (1, 2)
    (entry,) = graphs._entries.values()
    assert entry.counts == {(conv.reflect_pad_hw, "launches", None): 13,
                            (cuda_norm.instance_norm_fwd, "launches", None): 14,
                            (cuda_norm.instance_norm_fwd, "launches_by_mode", "plain"): 14}


def test_a_failed_capture_takes_its_counts_back_and_keeps_nothing():
    def broken(x, program):
        program(x)
        raise RuntimeError("capture refused")

    graphs = ForwardGraphs(capture=broken)
    x = _u8(1, 8, 8, seed=4)
    serve_u8(x, torch.device("cpu"), 8, _launch([]), graphs)  # noted
    before = launch_counts()
    with pytest.raises(RuntimeError, match="capture refused"):
        serve_u8(x, torch.device("cpu"), 8, _launch([]), graphs)
    after = launch_counts()
    # only the eager call's forward was counted
    assert after[(conv.reflect_pad_hw, "launches", None)] - \
        before[(conv.reflect_pad_hw, "launches", None)] == 13
    assert graphs.keys() == [] and graphs.captures == 0


def test_key_takes_the_callers_extra_entries():
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch([])
    x = _u8(1, 8, 8, seed=5)
    for alpha in (1.0, 0.5, 1.0, 0.5, 1.0):
        serve_u8(x, torch.device("cpu"), 8, launch, graphs, (alpha,))
    assert graphs.keys() == [(1, 8, 8, 0.5), (1, 8, 8, 1.0)]
    assert (graphs.captures, graphs.replays) == (2, 1)


def test_each_algorithm_setting_keeps_graphs_of_its_own(monkeypatch):
    """A graph replays the convolution kernels chosen at its capture, so a
    change of cuDNN's settings captures anew."""
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch([])
    x = _u8(1, 8, 8, seed=5)
    for _ in range(2):
        serve_u8(x, torch.device("cpu"), 8, launch, graphs)
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "deterministic", not torch.backends.cudnn.deterministic)
        for _ in range(3):
            serve_u8(x, torch.device("cpu"), 8, launch, graphs)
    serve_u8(x, torch.device("cpu"), 8, launch, graphs)
    assert (graphs.captures, graphs.replays) == (2, 2)
    assert graphs.keys() == [(1, 8, 8), (1, 8, 8)]


def _fill(graphs, launch):
    """MAX_GRAPHS keys, each called twice (so captured): the warm-up's 8
    rows at two buckets."""
    keys = [(n, 8, 8 * s) for s in (1, 2) for n in range(1, 9)]
    assert len(keys) == MAX_GRAPHS
    for n, h, w in keys:
        for _ in range(2):
            serve_u8(_u8(n, h, w, seed=n), torch.device("cpu"), 8, launch, graphs)
    assert graphs.keys() == keys and graphs.captures == MAX_GRAPHS
    return keys


def test_cycling_through_more_keys_than_are_kept_captures_no_more():
    """Past the limit, while every graph is in use, a new key stays eager:
    the kept graphs replay and nothing is captured or evicted again."""
    calls = []
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch(calls)
    keys = _fill(graphs, launch) + [(1, 8, 8 * s) for s in (3, 4, 5, 6)]
    calls.clear()
    for _ in range(4):
        for n, h, w in keys:
            x = _u8(n, h, w, seed=h + w)
            np.testing.assert_array_equal(serve_u8(x, torch.device("cpu"), 8, launch, graphs),
                                          255 - x)
    assert (graphs.captures, graphs.evictions) == (MAX_GRAPHS, 0)
    assert graphs.replays == 4 * MAX_GRAPHS
    # each call ran one forward: eagerly for the new keys, replayed for the kept
    assert len(calls) == 4 * len(keys)
    assert set(graphs.keys()) == set(keys[:MAX_GRAPHS])


def test_least_recently_used_graph_gives_way_only_once_stale(monkeypatch):
    monkeypatch.setattr(graphs_module, "STALE_CALLS", 40)
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch([])
    keys = _fill(graphs, launch)  # 32 calls
    for _ in range(40):  # (1, 8, 8) replayed; the others go stale
        serve_u8(_u8(1, 8, 8, seed=1), torch.device("cpu"), 8, launch, graphs)
    for _ in range(2):  # a new key, noted, then captured in the stale one's place
        serve_u8(_u8(1, 8, 24, seed=1), torch.device("cpu"), 8, launch, graphs)
    assert (graphs.captures, graphs.replays, graphs.evictions) == (MAX_GRAPHS + 1, 40, 1)
    assert len(graphs.keys()) == MAX_GRAPHS
    # (2, 8, 8) was the least recently used; (1, 8, 8), replayed, stays
    assert keys[1] == (2, 8, 8) and (2, 8, 8) not in graphs.keys()
    assert graphs.keys()[-2:] == [(1, 8, 8), (1, 8, 24)]
    # (2, 8, 8) again, seen before: captured at once, (3, 8, 8) giving way
    serve_u8(_u8(2, 8, 8, seed=1), torch.device("cpu"), 8, launch, graphs)
    assert (graphs.captures, graphs.evictions) == (MAX_GRAPHS + 2, 2)
    assert (3, 8, 8) not in graphs.keys() and graphs.keys()[-1] == (2, 8, 8)
    graphs.clear()
    assert graphs.keys() == []


def test_replay_span_lies_inside_the_launch_span_under_a_profiler():
    graphs = ForwardGraphs(capture=StandIn.capture)
    launch = _launch([])
    x = _u8(2, 8, 8, seed=6)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            serve_u8(x, torch.device("cpu"), 8, launch, graphs)
    spans = tracing.spans()
    launches = [s for s in spans if s.name == "stylize.launch"]
    (replay,) = [s for s in spans if s.name == "stylize.replay"]
    assert len(launches) == 3
    assert replay.parent == launches[2].id
    assert launches[2].start_ns <= replay.start_ns <= replay.end_ns <= launches[2].end_ns
    assert replay.attrs == {"n": 2, "h": 8, "w": 8}


@pytest.mark.parametrize("preserve_color", ["off", "luma"])
def test_stylizer_serves_through_its_graphs_with_the_eager_bits(preserve_color):
    """A CPU Stylizer given a stand-in cache: its program (pad, u8 in, the
    network, u8 out; the luma transfer too) replayed gives an eager
    Stylizer's output."""
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    eager, graphed = (Stylizer(params, precision="f32", bucket_multiple=16, device="cpu",
                               preserve_color=preserve_color) for _ in range(2))
    graphed._graphs = ForwardGraphs(capture=StandIn.capture)
    for seed in (7, 8, 7, 9):
        x = _u8(2, 12, 16, seed=seed)
        np.testing.assert_array_equal(graphed.stylize_u8(x), eager.stylize_u8(x))
    assert (graphed.graph_captures, graphed.graph_replays) == (1, 2)


def test_set_style_drops_the_arbitrary_stylizers_graphs():
    """A new style drops the graphs; a key called before is captured again
    on its next call."""
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models.adain import AdaINDecoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params

    torch.manual_seed(0)
    decoder, vgg = AdaINDecoder().state_dict(), random_params(0)
    eager = ArbitraryStylizer(decoder, vgg, bucket_multiple=8, device="cpu")
    graphed = ArbitraryStylizer(decoder, vgg, bucket_multiple=8, device="cpu")
    graphed._graphs = ForwardGraphs(capture=StandIn.capture)
    x = _u8(1, 16, 16, seed=9)
    for style_seed, counts in ((10, (2, 1)), (11, (4, 4))):
        style = _u8(1, 16, 16, seed=style_seed)[0]
        eager.set_style_u8(style)
        graphed.set_style_u8(style)
        assert graphed._graphs.keys() == []
        for alpha in (1.0, 0.5, 1.0, 0.5, 1.0):
            np.testing.assert_array_equal(graphed.stylize_u8(x, alpha=alpha),
                                          eager.stylize_u8(x, alpha=alpha))
        assert graphed._graphs.keys() == [(1, 16, 16, 0.5), (1, 16, 16, 1.0)]
        assert (graphed.graph_captures, graphed.graph_replays) == counts


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _adain_pair(**kw):
    """A graphed and an eager ArbitraryStylizer of the same seeded weights,
    bf16, each with the same style set."""
    from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
    from fast_neural_style_transfer_tpu_torch.models.adain import AdaINDecoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import random_params

    torch.manual_seed(0)
    decoder, vgg = _he_decoder(AdaINDecoder().state_dict()), random_params(0)
    pair = [ArbitraryStylizer(decoder, vgg, precision="bf16", device="cuda", **kw)
            for _ in range(2)]
    pair[1]._graphs = None
    for a in pair:
        a.set_style_u8(_u8(1, 256, 256, seed=1)[0])
    return pair


@pytest.mark.gpu
@pytest.mark.parametrize("precision, preserve_color", [
    ("bf16", "off"), ("f32", "off"), ("bf16", "luma")], ids=["bf16", "f32", "bf16-luma"])
def test_stylizer_replay_equals_eager_at_every_key_on_card(precision, preserve_color,
                                                            monkeypatch):
    """B=1, 3 and 8 at 256^2 and 512^2, and a batch that the graph pads up
    to its bucket: each key's first two calls (eager; eager, then
    captured), then replays in another order than captured, each of a new
    input, equal bit for bit to an eager Stylizer's output of that input;
    the luma transfer too. f32 under cuDNN's deterministic convolutions, on
    both sides: under its default ones two eager f32 forwards differ in a
    few u8 values by one."""
    _card()
    if precision == "f32":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    graphed, eager = (Stylizer(params, precision=precision, preserve_color=preserve_color,
                               device="cuda") for _ in range(2))
    eager._graphs = None
    keys = [(n, s, s) for s in (256, 512) for n in (1, 3, 8)] + [(2, 449, 500)]
    for i, (n, h, w) in enumerate(keys):
        for j in range(2):
            x = _u8(n, h, w, seed=10 * i + j)
            np.testing.assert_array_equal(graphed.stylize_u8(x), eager.stylize_u8(x),
                                          err_msg=f"call {j + 1} {n, h, w}")
    assert (graphed.graph_captures, graphed.graph_replays) == (len(keys), 0)
    order = [keys[j] for j in (6, 4, 0, 5, 2, 1, 3, 0, 5, 6)]
    for i, (n, h, w) in enumerate(order):
        x = _u8(n, h, w, seed=100 + i)
        got = graphed.stylize_u8(x)
        assert got.shape == x.shape and got.std() > 0
        np.testing.assert_array_equal(got, eager.stylize_u8(x), err_msg=f"replay {n, h, w}")
    assert (graphed.graph_captures, graphed.graph_replays) == (len(keys), len(order))
    assert graphed.graph_evictions == 0 and eager.graph_captures == 0


@pytest.mark.gpu
@pytest.mark.parametrize("preserve_color", ["off", "luma"])
def test_arbitrary_stylizer_replays_each_alpha_and_a_new_style_on_card(preserve_color):
    """alpha 1.0 and 0.5 each a key of its own, replayed equal to the eager
    stylizer's output; after ``set_style`` with a new style the graphs are
    gone, and the output (the key, seen before, recaptured on its next
    call, then replayed) is the eager one of the new style; the luma
    transfer too."""
    _card()
    graphed, eager = _adain_pair(preserve_color=preserve_color)
    x = _u8(2, 256, 256, seed=2)
    before = {}
    for alpha in (1.0, 0.5, 1.0, 0.5, 1.0, 0.5):
        got = graphed.stylize_u8(x, alpha=alpha)
        np.testing.assert_array_equal(got, eager.stylize_u8(x, alpha=alpha), err_msg=str(alpha))
        before[alpha] = got
    assert (graphed.graph_captures, graphed.graph_replays) == (2, 2)
    assert not np.array_equal(before[1.0], before[0.5])
    for a in (graphed, eager):
        a.set_style_u8(_u8(1, 256, 256, seed=3)[0])
    assert graphed._graphs.keys() == []
    for _ in range(2):
        got = graphed.stylize_u8(x)
        np.testing.assert_array_equal(got, eager.stylize_u8(x))
        assert not np.array_equal(got, before[1.0])
    assert (graphed.graph_captures, graphed.graph_replays) == (3, 3)


def _counted(fn, *args, **kw):
    """fn's output and the launch counters it moved (no zero entries)."""
    before = launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, {k: n - before.get(k, 0) for k, n in launch_counts().items()
                 if n != before.get(k, 0)}


@pytest.mark.gpu
def test_launch_counters_per_forward_are_the_same_eager_captured_and_replayed_on_card():
    """14 IN and 13 pad launches a Stylizer forward, 1 IN and 9 pads an
    ArbitraryStylizer forward, on the call that captures (a key's second),
    on a replay and eagerly, every counter by route, affine and mode
    alike."""
    _card()
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    graphed = Stylizer(params, precision="bf16", device="cuda")
    eager = Stylizer(params, precision="bf16", device="cuda")
    eager._graphs = None
    ada, ada_eager = _adain_pair()
    x = _u8(8, 512, 512, seed=4)
    for name, (g, e), (ins, pads) in (("stylenet", (graphed, eager), (14, 13)),
                                     ("adain", (ada, ada_eager), (1, 9))):
        g.stylize_u8(x)  # noted
        _, captured = _counted(g.stylize_u8, x)
        _, replayed = _counted(g.stylize_u8, x)
        _, plain = _counted(e.stylize_u8, x)
        assert (g.graph_captures, g.graph_replays) == (1, 1), name
        assert captured == replayed == plain, name
        assert plain[(cuda_norm.instance_norm_fwd, "launches", None)] == ins, name
        assert plain[(conv.reflect_pad_hw, "launches", None)] == pads, name


@pytest.mark.gpu
def test_replayed_forwards_match_the_fpad_route_on_card(monkeypatch):
    """The reflect-pad kernel's check of the serving stylizers, for a
    replay: the B=8 512^2 u8 outputs replayed equal those of an eager
    stylizer whose pads take F.pad's composition."""
    _card()
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    net, net_eager = (Stylizer(params, precision="bf16", device="cuda") for _ in range(2))
    net_eager._graphs = None
    ada, ada_eager = _adain_pair()
    x = _u8(8, 512, 512, seed=5)
    for name, g, e in (("stylenet", net, net_eager), ("adain", ada, ada_eager)):
        for seed in (6, 7):  # eager; eager, then captured
            g.stylize_u8(_u8(8, 512, 512, seed=seed))
        got = g.stylize_u8(x)
        assert g.graph_replays == 1, name
        with monkeypatch.context() as m:
            m.setattr(conv, "reflect_pad", _composed)
            want = e.stylize_u8(x)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.gpu
def test_a_replays_kernels_in_a_device_trace_are_those_its_counters_add_on_card():
    """A replay's counters are its capture's, added again: a device trace
    of one replay holds as many ``in_fwd_*`` and ``pad_*`` kernels as one of
    an eager forward of the key, and as many as the counters it moved
    say (an IN launch is one kernel on the one-launch and inject routes,
    two on the two-launch route)."""
    _card()
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    graphed, eager = (Stylizer(params, precision="bf16", device="cuda") for _ in range(2))
    eager._graphs = None
    x = _u8(8, 512, 512, seed=9)
    for _ in range(2):  # noted; captured
        graphed.stylize_u8(x)

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, moved = _counted(fn, x)
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA], moved

    replayed, moved = traced(graphed.stylize_u8)
    plain, _ = traced(eager.stylize_u8)
    assert graphed.graph_replays == 1

    def kernels(names, rx):
        return sum(bool(re.search(rx, n)) for n in names)

    ins, pads = r"\bin_fwd_", r"\bpad_(pixels|gather)\b"
    assert kernels(replayed, ins) == kernels(plain, ins) > 0
    assert kernels(replayed, pads) == kernels(plain, pads) > 0
    fwd = cuda_norm.instance_norm_fwd
    route = {r: moved.get((fwd, "launches_by_route", r), 0) for r in fwd.launches_by_route}
    assert kernels(replayed, ins) == route["one_launch"] + 2 * route["two_launch"] + route["inject"]
    assert kernels(replayed, pads) == moved[(conv.reflect_pad_hw, "launches", None)] == 13


@pytest.mark.gpu
def test_int8_replicas_and_stytr2_capture_nothing_on_card(monkeypatch):
    """The paths that stay eager: no graph is captured, called three times
    at one key."""
    _card()
    from fast_neural_style_transfer_tpu_torch.infer.stytr2 import TransformerStylizer
    from fast_neural_style_transfer_tpu_torch.models.stytr2 import StyTr2

    entered = []
    real_begin = torch.cuda.CUDAGraph.capture_begin
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        lambda *a, **k: entered.append(1) or real_begin(*a, **k))
    torch.manual_seed(0)
    params = TransformerNet().state_dict()
    card = torch.device("cuda", torch.cuda.current_device())
    stylizers = {
        "int8": Stylizer(params, precision="int8", device="cuda"),
        "replicas": Stylizer(params, precision="bf16", sharding=ReplicaPlan((card, card))),
    }
    sty = TransformerStylizer(_he_decoder(StyTr2().state_dict(), "decoder."),
                              precision="bf16", device="cuda")
    sty.set_style_u8(_u8(1, 256, 256, seed=7)[0])
    x = _u8(2, 256, 256, seed=8)
    for name, s in stylizers.items():
        assert s._graphs is None, name
        for _ in range(3):
            s.stylize_u8(x)
        assert s.graph_captures == 0, name
    for _ in range(3):
        sty.stylize_u8(x)
    assert entered == []
