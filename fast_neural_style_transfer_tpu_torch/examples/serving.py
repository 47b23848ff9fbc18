"""Serving patterns: the inference paths on one host, in order:

1. the uint8 round trip for one image (what the inference CLI uses: both
   transfer directions carry a quarter of float32's bytes);
2. a batch of equal-shape frames in one call;
3. data parallelism: replicas of the params, the batch split over them
   (two replicas on one device here; ``make_mesh_plan()`` takes every card);
4. height-sharded inference of a large image over two ranks (halo
   exchange, exact: not overlap tiling);
5. arbitrary-style serving (the AdaIN family) with a cached style;
6. online HTTP serving: concurrent requests micro-batched into one device
   batch per shape bucket (in production: ``python -m
   fast_neural_style_transfer_tpu_torch.serve --model final.npz``).

Runs on the card unless ``--device cpu``.

    python -m fast_neural_style_transfer_tpu_torch.examples.serving [output_dir] [--device cpu]
"""

import io
import os
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.core import resolve_device
from fast_neural_style_transfer_tpu_torch.examples import parse_args
from fast_neural_style_transfer_tpu_torch.infer import Stylizer, stylize_spatial
from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
from fast_neural_style_transfer_tpu_torch.models import TransformerNet
from fast_neural_style_transfer_tpu_torch.models.adain import AdaINDecoder
from fast_neural_style_transfer_tpu_torch.models.vgg_weights import resolve_params
from fast_neural_style_transfer_tpu_torch.parallel import launch, make_mesh_plan
from fast_neural_style_transfer_tpu_torch.serve import make_server
from fast_neural_style_transfer_tpu_torch.utils import save_image

SPATIAL_RANKS = 2


def _spatial_rank(plan, params, image):
    """One rank of section 4: the net on the rank's device, its rows of the
    image, the whole output back."""
    net = TransformerNet()
    net.load_state_dict(params, strict=True)
    net = net.eval().to(plan.device, memory_format=torch.channels_last)
    return stylize_spatial(net, torch.from_numpy(image).to(plan.device), plan).cpu()


def main(out_dir: str = "serving_out", device=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    # in production: Stylizer.from_checkpoint("run/style_transfer_final.npz")
    torch.manual_seed(0)
    params = TransformerNet().state_dict()

    # 1. one image, uint8 in -> uint8 out, normalize/denormalize on the device
    sty = Stylizer(params, device=dev)
    frame = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    out = sty.stylize_u8(frame)
    save_image(out.astype(np.float32) / 255.0, os.path.join(out_dir, "single.jpg"),
               denormalize=False)
    print(f"1. single u8 roundtrip: {frame.shape} -> {out.shape} {out.dtype}")

    # 2. batched: equal-shape frames in one call
    batch = rng.integers(0, 256, (4, 200, 300, 3), dtype=np.uint8)
    outs = sty.stylize_u8(batch)
    print(f"2. batched: {batch.shape} -> {outs.shape}")

    # 3. data parallel: params replicated, the batch split over the replicas
    plan = make_mesh_plan(devices=[dev, dev])
    outs_dp = Stylizer(params, sharding=plan.batch_sharding).stylize_u8(batch)
    du8 = int(np.abs(outs_dp.astype(int) - outs.astype(int)).max())
    print(f"3. data-parallel over {len(plan.devices)} replicas: max |du8| {du8} "
          "against one call")

    # 4. a large image: rows split over ranks (halo exchange)
    big = rng.standard_normal((1, 384, 256, 3)).astype(np.float32)
    out_sp = launch(_spatial_rank, SPATIAL_RANKS, (params, big), device=dev.type,
                    quiet=True)[0]
    print(f"4. spatial (H over {SPATIAL_RANKS} shards): {big.shape} -> "
          f"{tuple(out_sp.shape)}")

    # 5. arbitrary-style serving (AdaIN family): encode the style ONCE, then
    #    stream u8 batches over the same replicas; alpha per call
    torch.manual_seed(1)
    styler = ArbitraryStylizer(AdaINDecoder().state_dict(), resolve_params(None),
                               sharding=plan.batch_sharding).set_style_u8(
        rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    ad_out = styler.stylize_u8(batch[:, :64, :64], alpha=0.8)
    print(f"5. arbitrary-style DP serving: {batch[:, :64, :64].shape} -> "
          f"{ad_out.shape} (style cached, one VGG encode per frame)")

    # 6. online HTTP serving: concurrent requests micro-batched
    from PIL import Image

    srv = make_server(sty.stylize_u8, family="flagship", device=sty.device, port=0,
                      max_wait_ms=200.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG")

    def post(_):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/stylize",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        with ThreadPoolExecutor(max_workers=4) as ex:
            replies = list(ex.map(post, range(4)))
        occ = srv.batcher.stats.snapshot()["mean_batch_occupancy"]
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    print(f"6. HTTP micro-batching: 4 concurrent POSTs -> "
          f"{len(replies)} JPEGs, mean batch occupancy {occ:.1f}")
    print(f"outputs under {out_dir}")


if __name__ == "__main__":
    main(*parse_args(sys.argv[1:], "serving_out", __doc__))
