"""The port's side of the height-sharded and data-parallel tests:
functions that each rank of ``parallel.launch`` runs
(``tests/test_torch_spatial*.py`` and ``tests/test_torch_data_parallel.py``
compare what they return with the JAX package). This module imports torch
and the port only, never JAX, so the spawned ranks do not load it."""

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.ops import sharded as sh


def slab(a: np.ndarray, axis) -> torch.Tensor:
    """This rank's rows of an NHWC numpy batch, as NCHW channels_last."""
    h = a.shape[1] // axis.size
    t = torch.from_numpy(np.ascontiguousarray(a[:, axis.index * h:(axis.index + 1) * h]))
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def full(t: torch.Tensor, axis, nchw: bool = True) -> np.ndarray:
    """Every rank's slab of t (NCHW, or NHWC with ``nchw=False``) stacked
    along H, NHWC numpy."""
    t = t.detach()
    if nchw:
        t = t.permute(0, 2, 3, 1)
    return torch.cat(list(axis.gather(t.contiguous().float())), dim=1).numpy()


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def iohw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(2, 3, 0, 1)))


def ops(plan, a: dict) -> dict:
    """Every ``ops/sharded.py`` function on the seeded inputs ``a`` (NHWC,
    HWIO weights), -> {name: the whole result as NHWC numpy, or the
    replicated value}."""
    axis = plan.space
    x = slab(a["x"], axis)
    e = int(a["extent"])
    t = lambda v: torch.from_numpy(np.asarray(v))  # noqa: E731
    out = {
        "from_prev": full(sh.from_prev(x[:, :, -2:], axis), axis),
        "from_next": full(sh.from_next(x[:, :, :2], axis), axis),
        "halo_reflect": full(sh.halo_extend(x, 4, mode="reflect", axis=axis), axis),
        "halo_zero": full(sh.halo_extend(x, 1, mode="zero", axis=axis), axis),
        "global_row_index": torch.cat(list(axis.gather(
            sh.global_row_index(x.shape[2], axis)))).numpy(),
        "mask_rows_from": full(sh.mask_rows_from(x, e, axis), axis),
        "fetch_global_row": sh.fetch_global_row(x, e - 2, axis).permute(0, 2, 3, 1).numpy(),
        "set_global_row": full(sh.set_global_row(
            x, e, torch.ones_like(x[:, :, :1]) * 7.0, axis), axis),
        "pin_reflect_rows": full(sh.pin_reflect_rows(x, e, 4, axis), axis),
        "reflect_conv_k9": full(sh.reflect_conv2d_sharded(
            x, oihw(a["w9"]), t(a["b9"]), axis=axis), axis),
        "reflect_conv_k3s2": full(sh.reflect_conv2d_sharded(
            x, oihw(a["w3"]), t(a["b3"]), stride=2, axis=axis), axis),
        "conv_same": full(sh.conv2d_same_sharded(x, oihw(a["w3"]), t(a["b3"]), axis=axis),
                          axis),
        "max_pool": full(sh.max_pool2d_sharded(x), axis),
        "conv_transpose": full(sh.conv_transpose2d_sharded(
            x, iohw(a["wt"]), t(a["bt"]), axis=axis), axis),
        "in_relu": full(sh.instance_norm_sharded(
            x, t(a["gamma"]), t(a["beta"]), relu=True, axis=axis), axis),
        "in_sample_affine": full(sh.instance_norm_sharded(
            x, t(a["gamma_n"]), t(a["beta_n"]), axis=axis), axis),
        "in_masked": full(sh.instance_norm_sharded(
            x, t(a["gamma"]), t(a["beta"]), relu=True, axis=axis, extent=e), axis),
    }
    feat = x.permute(0, 2, 3, 1)
    tgt = slab(a["y"], axis).permute(0, 2, 3, 1)
    out["gram"] = sh.gram_matrix_sharded(feat, axis).numpy()
    out["content_loss"] = float(sh.content_loss_sharded(feat, tgt, axis))
    out["tv_loss"] = float(sh.total_variation_loss_sharded(feat, axis))
    return out


def ops_grads(plan, a: dict) -> dict:
    """Gradients through the sharded ops against the port's unsharded ops
    on the whole image: a scalar built from each, backpropagated on every
    rank; input gradients gathered, parameter gradients summed over the
    ranks. -> {name: max abs error}."""
    import torch.nn.functional as F

    from fast_neural_style_transfer_tpu_torch.ops.conv import reflect_conv2d
    from fast_neural_style_transfer_tpu_torch.ops.norm import instance_norm

    axis = plan.space
    t = lambda v: torch.from_numpy(np.asarray(v)).clone()  # noqa: E731
    xf = t(a["x"]).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    errs = {}

    def check(name, sharded, unsharded, params):
        xu = xf.clone().requires_grad_(True)
        pu = [p.clone().requires_grad_(True) for p in params]
        yu = unsharded(xu, *pu)
        probe = torch.from_numpy(np.random.default_rng(5).normal(
            size=tuple(yu.shape)).astype(np.float32))
        ux, *up = torch.autograd.grad((yu.float() * probe).sum(), [xu, *pu])
        xs = slab(a["x"], axis).requires_grad_(True)
        ps = [p.clone().requires_grad_(True) for p in params]
        ys = sharded(xs, *ps)
        hs = ys.shape[2]
        loss = axis.psum((ys.float() * probe[:, :, axis.index * hs:(axis.index + 1) * hs])
                         .sum())
        gx, *gp = torch.autograd.grad(loss, [xs, *ps])
        err = float(np.abs(full(gx, axis) - ux.permute(0, 2, 3, 1).numpy()).max())
        for g, u in zip(gp, up):
            err = max(err, float((axis.all_reduce_(g.clone()) - u).abs().max()))
        scale = max(float(ux.abs().max()), *(float(u.abs().max()) for u in up))
        errs[name] = err / max(scale, 1e-12)

    w9, b9 = oihw(a["w9"]), t(a["b9"])
    check("reflect_conv_k9",
          lambda x, w, b: sh.reflect_conv2d_sharded(x, w, b, axis=axis),
          lambda x, w, b: reflect_conv2d(x, w, b), [w9, b9])
    wt, bt = iohw(a["wt"]), t(a["bt"])
    check("conv_transpose",
          lambda x, w, b: sh.conv_transpose2d_sharded(x, w, b, axis=axis),
          lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2, padding=1,
                                             output_padding=1), [wt, bt])
    w3, b3 = oihw(a["w3"]), t(a["b3"])
    check("conv_same",
          lambda x, w, b: sh.conv2d_same_sharded(x, w, b, axis=axis),
          lambda x, w, b: F.conv2d(x, w, b, padding=1), [w3, b3])
    g, b = t(a["gamma"]), t(a["beta"])
    check("instance_norm",
          lambda x, g, b: sh.instance_norm_sharded(x, g, b, relu=True, axis=axis),
          lambda x, g, b: instance_norm(x, g, b, relu=True), [g, b])
    gn, bn = t(a["gamma_n"]), t(a["beta_n"])
    check("instance_norm_sample_affine",
          lambda x, g, b: sh.instance_norm_sharded(x, g, b, axis=axis),
          lambda x, g, b: instance_norm(x, g, b), [gn, bn])
    return errs


def state_dict(d: dict) -> dict:
    """numpy arrays -> tensors."""
    return {k: torch.as_tensor(v) for k, v in d.items()}


def load_net(params: dict, device, num_styles: int = 1):
    from fast_neural_style_transfer_tpu_torch.models import TransformerNet

    net = TransformerNet(num_styles=num_styles)
    net.load_state_dict(state_dict(params), strict=True)
    return net.to(device, memory_format=torch.channels_last)


def stylize(plan, params: dict, x: np.ndarray, precision: str = "f32") -> np.ndarray:
    """``infer/spatial.py::stylize_spatial`` of the network-space batch x."""
    from fast_neural_style_transfer_tpu_torch.core.dtypes import canonical_compute_dtype
    from fast_neural_style_transfer_tpu_torch.infer.spatial import stylize_spatial

    net = load_net(params, plan.device).eval()
    out = stylize_spatial(net, torch.from_numpy(x).to(plan.device), plan,
                          precision=canonical_compute_dtype(precision))
    return out.float().cpu().numpy()


def adain(plan, decoder: dict, vgg: dict, content, styles, alpha, style_weights=None,
          masks=None) -> np.ndarray:
    """``infer/spatial_adain.py::stylize_arbitrary_spatial``."""
    from fast_neural_style_transfer_tpu_torch.infer.spatial_adain import (
        stylize_arbitrary_spatial,
    )
    from fast_neural_style_transfer_tpu_torch.models.adain import make_decoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg

    dec = make_decoder(state_dict(decoder), plan.device).eval()
    v = make_vgg(state_dict(vgg), plan.device)
    out = stylize_arbitrary_spatial(
        dec, v, torch.from_numpy(content), [torch.from_numpy(s) for s in styles], plan,
        alpha=alpha, style_weights=style_weights, style_masks=masks)
    return out.float().cpu().numpy()


def train(plan, params: dict, vgg: dict, batches, grams, lr: float, total: int,
          remat: bool = False) -> dict:
    """The spatial step's loss, this rank's and the summed gradients of
    the first batch, then one step per batch: metrics and params after
    each."""
    from fast_neural_style_transfer_tpu_torch.core.dtypes import Precision
    from fast_neural_style_transfer_tpu_torch.losses import LossTaps
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg
    from fast_neural_style_transfer_tpu_torch.train.schedule import LossWeightSchedule
    from fast_neural_style_transfer_tpu_torch.train.spatial_step import (
        all_reduce_grads,
        make_spatial_train_step,
        shard_rows,
        spatial_loss_fn,
    )
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state

    axis = plan.space
    net = load_net(params, plan.device)
    v = make_vgg(state_dict(vgg), plan.device)
    grams = [torch.from_numpy(np.asarray(g)) for g in grams]
    batch0 = torch.from_numpy(batches[0])
    net.train()
    total_loss, metrics = spatial_loss_fn(
        net, v, shard_rows(batch0, axis), grams, LossWeightSchedule()(0), axis=axis,
        taps=LossTaps(), precision=Precision.f32(), dropout=False, remat=remat)
    names = [n for n, _ in net.named_parameters()]
    local = torch.autograd.grad(total_loss, list(net.parameters()))
    summed = all_reduce_grads([g.clone() for g in local], axis)
    out = {"loss": {k: float(m) for k, m in metrics.items()},
           "grads_local": dict(zip(names, [g.numpy() for g in local])),
           "grads": dict(zip(names, [g.numpy() for g in summed])), "steps": []}
    state = create_train_state(net, lr, total)
    step = make_spatial_train_step(plan, lr=lr, total_steps=total, dropout=False,
                                   remat=remat)
    for b in batches:
        m = step(state, v, torch.from_numpy(b), grams)
        out["steps"].append(({k: float(x) for k, x in m.items()}, state.step,
                             {k: p.detach().clone().numpy()
                              for k, p in state.net.state_dict().items()}))
    return out


def _numpy(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _run_steps(plan, make_step, state, batches, vgg, grams, **per_step) -> dict:
    """``make_step()``'s step on this rank's slice of each global batch ->
    its metrics, the step count, the gradients the first update applied
    (summed over the ranks) and the params after."""
    d = plan.data
    applied = []
    update = state.optimizer.update

    def spy(grads):
        applied.append([g.detach().clone().numpy() for g in grads])
        return update(grads)

    state.optimizer.update = spy
    step = make_step()
    names = [n for n, _ in state.net.named_parameters()]
    metrics = []
    for i, b in enumerate(batches):
        kw = {k: torch.from_numpy(part(v[i], d)) for k, v in per_step.items()}
        metrics.append(_numpy(step(state, vgg, torch.from_numpy(part(b, d)), grams, **kw)))
    return {"metrics": metrics, "step": state.step,
            "grads": dict(zip(names, applied[0])) if applied else None,
            "params": {k: v.detach().clone().numpy()
                       for k, v in state.net.state_dict().items()}}


def part(x: np.ndarray, data) -> np.ndarray:
    """This rank's contiguous slice of a global batch on the data axis."""
    k = x.shape[0] // data.size
    return np.ascontiguousarray(x[data.index * k:(data.index + 1) * k])


def data_parallel(plan, a: dict) -> dict:
    """Everything ``tests/test_torch_data_parallel.py`` holds against the
    JAX package from one launch of (data 2 x space 1) ranks: this rank's
    mesh indices; the stylizer step plain, with ``grad_accum=2``, on a
    padded batch, with two styles, and with a non-finite input on rank 1
    alone; the AdaIN step; the training loop (``a["loop"]``). Every step
    takes this rank's slice of the global batches."""
    from fast_neural_style_transfer_tpu_torch.models.adain import make_decoder
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg
    from fast_neural_style_transfer_tpu_torch.train import adain as tadain
    from fast_neural_style_transfer_tpu_torch.train.loop import train_style_transfer
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state
    from fast_neural_style_transfer_tpu_torch.train.step import make_train_step

    lr, total, d = a["lr"], a["total"], plan.data
    vgg = make_vgg(state_dict(a["vgg"]), plan.device)
    grams = [torch.from_numpy(g) for g in a["grams"]]
    out = {"layout": (plan.world.index, d.index, plan.space.index, d.size, plan.spatial)}

    def stylizer(params, batches, *, grad_accum=1, num_styles=1, grams=grams, **per_step):
        state = create_train_state(load_net(params, plan.device, num_styles), lr, total,
                                   grad_accum=grad_accum)
        return _run_steps(
            plan, lambda: make_train_step(lr=lr, total_steps=total, grad_accum=grad_accum,
                                          dropout=False, num_styles=num_styles, data=d),
            state, batches, vgg, grams, **per_step)

    out["plain"] = stylizer(a["params"], a["batches"][:1])
    out["accum"] = stylizer(a["params"], a["batches"][:2], grad_accum=2)
    out["pad"] = stylizer(a["params"], [a["padded"]], batch_mask=[a["mask"]])
    out["styles"] = stylizer(a["params_multi"], a["batches"][:1], num_styles=2,
                             grams=[torch.from_numpy(g) for g in a["grams_multi"]],
                             style_select=[a["select"]])
    bad = a["batches"][0].astype(np.float32)
    bad[-1, 0, 0, 0] = np.nan  # in rank 1's slice only
    out["nonfinite"] = stylizer(a["params"], [bad])
    state = tadain.create_adain_train_state(
        make_decoder(state_dict(a["decoder"]), plan.device), lr)
    m = tadain.make_adain_train_step(lr=lr, data=d)(
        state, vgg, torch.from_numpy(part(a["content"], d)),
        torch.from_numpy(part(a["style"], d)))
    out["adain"] = {"metrics": _numpy(m), "step": state.step, "params": {
        k: v.detach().numpy() for k, v in state.decoder.state_dict().items()}}
    out["loop"] = train_style_transfer(a["loop"], plan)
    out["adain_loop"] = tadain.train_adain(a["adain_loop"], plan)
    return out


def data_space_step(plan, params: dict, vgg: dict, batch, grams, lr: float,
                    total: int) -> dict:
    """One 2-D (data x space) step: this rank's samples (its data index's
    slice) and rows -> this rank's mesh indices, the metrics, the step
    count and the params after."""
    from fast_neural_style_transfer_tpu_torch.models.vgg_weights import make_vgg
    from fast_neural_style_transfer_tpu_torch.train.spatial_step import (
        make_spatial_train_step,
    )
    from fast_neural_style_transfer_tpu_torch.train.state import create_train_state

    state = create_train_state(load_net(params, plan.device), lr, total)
    out = _run_steps(plan, lambda: make_spatial_train_step(
        plan, lr=lr, total_steps=total, dropout=False), state, [batch],
        make_vgg(state_dict(vgg), plan.device), [torch.from_numpy(g) for g in grams])
    out["layout"] = (plan.world.index, plan.data.index, plan.space.index)
    return out
