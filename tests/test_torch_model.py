"""The port's full-width TransformerNet against the JAX package's on the CPU.

Weights come from ``TransformerNet.init`` on the JAX side and cross over as
numpy arrays through ``params_from_jax``. The forward compares at f32 with
an absolute tolerance of 2e-4 on outputs of order 1: 16 layers of convs
whose k*k*C_in products (up to 2304 terms) XLA and PyTorch sum in other
orders, each normalized by an IN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_neural_style_transfer_tpu.core.dtypes import Precision as JaxPrecision
from fast_neural_style_transfer_tpu.export.torch_convert import (
    _TORCH_PREFIX_ORDER,
    to_torch_state_dict,
)
from fast_neural_style_transfer_tpu.models.transformer import (
    TransformerNet as JaxNet,
)
from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
from fast_neural_style_transfer_tpu_torch.models import (
    NUM_IN_SITES,
    TransformerNet,
    params_from_jax,
)
from fast_neural_style_transfer_tpu_torch.models.transformer import layer_walk


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs with several xdist workers
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    params = JaxNet.init(jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, params)


def _net(jax_params) -> TransformerNet:
    net = TransformerNet()
    net.load_state_dict(params_from_jax(jax_params), strict=True)
    return net.eval().to(memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", [(32, 32), (36, 52)])
def test_forward_matches_jax(jax_params, hw):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = JaxNet.apply(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(x),
                        train=False)
    with torch.inference_mode():
        got = _net(jax_params)(torch.from_numpy(x))
    assert got.shape == (2, *hw, 3) and got.dtype == torch.float32
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


def test_bf16_forward_close_to_jax_bf16(jax_params):
    # bf16 activations round at different places in XLA and PyTorch; the
    # 16-layer forward drifts by a few bf16 ulps of its order-1 output
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    want = JaxNet.apply(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(x),
                        train=False, precision=JaxPrecision.bf16())
    with torch.inference_mode():
        got = _net(jax_params)(torch.from_numpy(x), Precision.bf16())
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.mean() < 0.02 and err.max() < 0.25


def test_state_dict_matches_jax_exporter(jax_params):
    """load_state_dict(strict=True) of the JAX package's own exporter gives
    the same tensors as params_from_jax, in the reference key order."""
    sd_jax = to_torch_state_dict(jax_params)
    net = TransformerNet()
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd_jax.items()},
                        strict=True)
    ours = params_from_jax(jax_params)
    assert list(net.state_dict()) == list(sd_jax)
    assert list(sd_jax) == [p + s for p in _TORCH_PREFIX_ORDER
                            for s in (".weight", ".bias")]
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, ours[k], rtol=0, atol=0)


def test_default_init_shapes_and_sites():
    net = TransformerNet()
    n_params = sum(p.numel() for p in net.parameters())
    jax_count = JaxNet.param_count(JaxNet.init(jax.random.PRNGKey(0)))
    assert n_params == jax_count
    assert NUM_IN_SITES == 14
    assert sum(type(m).__name__ == "InstanceNorm" for m in net.modules()) == 14


def test_multi_style_params_load(jax_params):
    """A JAX multi-style tree loads into TransformerNet(num_styles=2) with
    its (S, C) banks, and the forward with per-example style rows matches
    JAX's (the same 2e-4 as above; the banks' rows differ)."""
    multi = jax.tree.map(np.asarray, JaxNet.init(jax.random.PRNGKey(0), num_styles=2))
    rng = np.random.default_rng(4)
    multi["norm3"]["gamma"] = rng.standard_normal((2, 64)).astype(np.float32)
    multi["res_blocks"][1]["in1"]["beta"] = rng.standard_normal((2, 256)).astype(np.float32)
    net = TransformerNet(num_styles=2)
    net.load_state_dict(params_from_jax(multi), strict=True)
    net = net.eval().to(memory_format=torch.channels_last)
    assert net.norm3.weight.shape == (2, 64) and net.num_styles == 2
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = np.eye(2, dtype=np.float32)[[1, 0]]
    want = JaxNet.apply(jax.tree.map(jnp.asarray, multi), jnp.asarray(x),
                        style_weights=jnp.asarray(w))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), style_weights=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


@pytest.mark.parametrize("styles", [1, 2])
def test_layer_walk_visits_the_reference_layers(styles):
    """``layer_walk`` over a TransformerNet's ``layers``: every parameter
    prefix of its state_dict once, in the reference's registration order;
    the reflect convs' strides 2, 2, then 1; a ReLU after every IN site
    but each residual block's in2; dropout after each in1, the residual
    add after each in2."""
    net = TransformerNet(num_styles=styles)
    keys = list(net.state_dict())
    events = []

    def visit(kind, name, arg=None):
        events.append((kind, name, arg))
        return name

    out = layer_walk(
        "x",
        conv=lambda name, h, stride: visit("conv", name, stride),
        up=lambda name, h: visit("up", name),
        inorm=lambda name, h, relu: visit("inorm", name, relu),
        add=lambda a, b: visit("add", b),
        drop=lambda h: visit("drop", h))
    assert out == "final_conv"
    names = [name for kind, name, _ in events if kind in ("conv", "up", "inorm")]
    assert [k for n in names for k in keys if k.startswith(n + ".")] == keys
    for n in names:
        assert net.layers[n].weight is net.get_parameter(
            next(k for k in keys if k.startswith(n + ".")))
    strides = [s for kind, _, s in events if kind == "conv"]
    assert strides == [2, 2] + [1] * 11  # conv1, conv2, 10 in the blocks, final_conv
    relu_off = [n for kind, n, relu in events if kind == "inorm" and not relu]
    assert relu_off == [f"res_blocks.{i}.in2" for i in range(5)]
    assert sum(kind == "inorm" for kind, _, _ in events) == NUM_IN_SITES
    after = {a[:2]: b[:2] for a, b in zip(events, events[1:])}
    for i in range(5):
        in1, in2 = f"res_blocks.{i}.in1", f"res_blocks.{i}.in2"
        assert after[("inorm", in1)] == ("drop", in1)
        assert after[("inorm", in2)] == ("add", in2)
