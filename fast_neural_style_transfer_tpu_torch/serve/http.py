"""HTTP stylization service on the card.

A stdlib ``ThreadingHTTPServer`` front end feeding the :class:`MicroBatcher`,
so concurrent clients share device batches instead of queueing whole
forwards behind each other.

Endpoints:
  POST /stylize[?format=jpeg|png]  image bytes in -> stylized image out
  GET  /healthz                    liveness + device + model family
  GET  /stats                      batching occupancy + latency quantiles, and
                                   where the batcher's time goes:
                                   mean_linger_ms, mean_pad_stack_ms,
                                   mean_forward_ms, mean_deliver_ms (per
                                   batch), mean_queue_wait_ms (per request,
                                   submit to being taken into a batch),
                                   mean_slot_ms (per batch, stacked to its
                                   forward's start), prepared_ahead_share
                                   (batches padded and stacked while the
                                   forward before them ran)

Run:  python -m fast_neural_style_transfer_tpu_torch.serve \\
          --model evidence/soak40k_r5/style_transfer_final.pth --port 8765
      python -m fast_neural_style_transfer_tpu_torch.serve \\
          --adain-decoder adain_decoder_final.npz --style painting.jpg --alpha 0.8
      python -m fast_neural_style_transfer_tpu_torch.serve \\
          --stytr2 stytr2_checkpoint/ --style painting.jpg
      python -m fast_neural_style_transfer_tpu_torch.serve \\
          --adaattn adaattn_checkpoint/ --style painting.jpg
"""

from __future__ import annotations

import argparse
import io
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Union

import numpy as np
import torch

from fast_neural_style_transfer_tpu_torch.serve.batcher import MicroBatcher, QueueFull

__all__ = ["StylizeServer", "make_server", "main"]

_MAX_BODY = 32 * 1024 * 1024  # JPEG/PNG request cap; a 4K png is ~24 MB


def _device_name(device: Union[str, torch.device]) -> str:
    """The card's name for a CUDA device, else the device type."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class StylizeServer(ThreadingHTTPServer):
    """ThreadingHTTPServer owning the batcher + serving config."""

    daemon_threads = True
    # listen backlog: socketserver's default of 5 drops the SYNs of a burst
    # of concurrent clients, which then retry only after a ~1 s timeout
    request_queue_size = 128

    def __init__(self, addr, batcher: MicroBatcher, *, family: str,
                 device: str, size: int = 0,
                 request_timeout_s: float = 60.0):
        self.batcher = batcher
        self.family = family
        self.device = device
        self.size = size  # >0: resize every request to size x size
        self.request_timeout_s = request_timeout_s
        super().__init__(addr, _Handler)

    def shutdown(self) -> None:  # also stop the dispatcher thread
        super().shutdown()
        self.batcher.close()


class _Handler(BaseHTTPRequestHandler):
    server: StylizeServer
    server_version = "fnst-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default (tests/daemons)
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply_json(200, {
                "status": "ok",
                "family": self.server.family,
                "device": self.server.device,
                "size": self.server.size or "native",
            })
        elif self.path == "/stats":
            self._reply_json(200, self.server.batcher.stats.snapshot())
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        from PIL import Image

        if not self.path.startswith("/stylize"):
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        t0 = time.monotonic()
        ok = False
        try:
            n = int(self.headers.get("Content-Length", 0))
            if not 0 < n <= _MAX_BODY:
                self._reply_json(413 if n > _MAX_BODY else 400,
                                 {"error": f"bad Content-Length {n}"})
                return
            body = self.rfile.read(n)
            try:
                img = Image.open(io.BytesIO(body)).convert("RGB")
            except Exception:
                self._reply_json(400, {"error": "undecodable image"})
                return
            if self.server.size > 0:
                img = img.resize((self.server.size, self.server.size),
                                 Image.BILINEAR)
            arr = np.asarray(img, dtype=np.uint8)
            try:
                fut = self.server.batcher.submit(arr)
            except QueueFull as e:
                self.send_response(503)
                self.send_header("Retry-After", "1")
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            out = fut.result(timeout=self.server.request_timeout_s)
            fmt = "png" if self.path.endswith("format=png") else "jpeg"
            buf = io.BytesIO()
            Image.fromarray(out).save(
                buf, format=fmt.upper(),
                **({"quality": 95} if fmt == "jpeg" else {}))
            self._reply(200, buf.getvalue(), f"image/{fmt}")
            ok = True
        except Exception as e:  # noqa: BLE001 — 500 to the client, keep serving
            try:
                self._reply_json(500, {"error": repr(e)})
            except Exception:
                pass
        finally:
            self.server.batcher.stats.record_request(
                time.monotonic() - t0, ok)


def make_server(
    forward: Callable[[np.ndarray], np.ndarray],
    *,
    family: str,
    device: Union[str, torch.device],
    host: str = "127.0.0.1",
    port: int = 0,
    size: int = 0,
    max_batch: int = 8,
    max_wait_ms: float = 5.0,
    max_pending: int = 256,
    bucket_multiple: int = 64,
    warm_size: int = 0,
) -> StylizeServer:
    """Wire a stylize_u8-style callable behind the HTTP front end.

    ``device`` is what ``forward`` runs on; ``/healthz`` reports its name.
    ``port=0`` binds an ephemeral port (read it back from
    ``server.server_address[1]``). ``warm_size`` > 0 warms a square bucket
    at every batch size on the batcher's thread before returning.
    """
    batcher = MicroBatcher(
        forward, max_batch=max_batch, max_wait_ms=max_wait_ms,
        max_pending=max_pending, bucket_multiple=bucket_multiple,
        warm_size=warm_size)
    batcher.ready.wait()
    if batcher.warm_error is not None:
        batcher.close()
        raise batcher.warm_error
    return StylizeServer((host, port), batcher, family=family,
                         device=_device_name(device), size=size)


def _build_forward(args, device: str) -> tuple:
    """Resolve the flags to (stylize_u8 callable, family label, device).
    ``--data_parallel``: a replica on every visible card (``device`` "cuda";
    an explicit card or the CPU is that one device), a batch split over
    them when it divides (the JAX package's ``make_mesh_plan()
    .batch_sharding``)."""
    sharding = None
    if args.data_parallel:
        from fast_neural_style_transfer_tpu_torch.parallel import make_mesh_plan

        sharding = make_mesh_plan(device=device).batch_sharding
        print(sharding.describe(args.max_batch), flush=True)
        device = None
    if getattr(args, "stytr2", None):
        if not args.style:
            raise SystemExit("--stytr2 needs --style <image>")
        if args.precision == "int8":
            raise SystemExit("--precision int8 serves the flagship family only")
        if sharding is not None:
            raise SystemExit("--data_parallel serves the flagship and adain families only")
        from fast_neural_style_transfer_tpu_torch.infer.stytr2 import TransformerStylizer
        from fast_neural_style_transfer_tpu_torch.models.stytr2 import load_stytr2_checkpoint
        from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image

        sty = TransformerStylizer(load_stytr2_checkpoint(args.stytr2),
                                  precision=args.precision, device=device)
        sty.set_style_u8(decode_image(args.style))
        return sty.stylize_u8, "stytr2", sty.device
    if getattr(args, "adaattn", None):
        if not args.style:
            raise SystemExit("--adaattn needs --style <image>")
        if args.precision == "int8":
            raise SystemExit("--precision int8 serves the flagship family only")
        if sharding is not None:
            raise SystemExit("--data_parallel serves the flagship and adain families only")
        if args.precision == "f32" and torch.device(device or "cuda").type != "cpu":
            raise SystemExit("--adaattn serves bf16 on a card (the moment-attention kernel "
                             "has no float32 variant); f32 runs on the CPU")
        from fast_neural_style_transfer_tpu_torch.infer.adaattn import AttentionalStylizer
        from fast_neural_style_transfer_tpu_torch.models.adaattn import load_adaattn_checkpoint
        from fast_neural_style_transfer_tpu_torch.models.vgg_weights import resolve_params
        from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image

        sty = AttentionalStylizer(load_adaattn_checkpoint(args.adaattn),
                                  resolve_params(args.vgg_weights),
                                  precision=args.precision, device=device)
        sty.set_style_u8(decode_image(args.style))
        return sty.stylize_u8, "adaattn", sty.device
    if args.adain_decoder:
        if not args.style:
            raise SystemExit("--adain-decoder needs --style <image>")
        if args.precision == "int8":
            raise SystemExit("--precision int8 serves the flagship family only")
        from fast_neural_style_transfer_tpu_torch.infer.adain import ArbitraryStylizer
        from fast_neural_style_transfer_tpu_torch.models.adain import load_decoder
        from fast_neural_style_transfer_tpu_torch.models.vgg_weights import resolve_params
        from fast_neural_style_transfer_tpu_torch.utils.image_io import decode_image

        sty = ArbitraryStylizer(
            load_decoder(args.adain_decoder), resolve_params(args.vgg_weights),
            precision=args.precision, preserve_color=args.preserve_color,
            device=device, sharding=sharding)
        sty.set_style_u8(decode_image(args.style))
        alpha = args.alpha
        return (lambda b: sty.stylize_u8(b, alpha=alpha)), "adain", sty.device
    if not args.model:
        raise SystemExit("pass --model <checkpoint>, or --adain-decoder, --stytr2 or "
                         "--adaattn + --style")
    from fast_neural_style_transfer_tpu_torch.infer.stylize import Stylizer

    sty = Stylizer.from_checkpoint(
        args.model, style=args.style_index, precision=args.precision,
        preserve_color=args.preserve_color, device=device, sharding=sharding)
    return sty.stylize_u8, "flagship", sty.device


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(
        prog="fnst-serve",
        description="Online stylization HTTP service with micro-batching")
    p.add_argument("--model", help="stylizer checkpoint (.pth/.npz)")
    p.add_argument("--style_index", type=int, default=None,
                   help="which trained style of a multi-style checkpoint "
                        "to serve")
    p.add_argument("--adain-decoder", help="AdaIN decoder checkpoint (.npz/.pth)")
    p.add_argument("--stytr2", help="StyTr² checkpoint: a directory of the official "
                                    "embedding*.pth, transformer*.pth and decoder*.pth")
    p.add_argument("--adaattn", help="AdaAttN checkpoint: a directory of the official "
                                     "*net_adaattn_3.pth, *net_transformer.pth and "
                                     "*net_decoder.pth")
    p.add_argument("--style", help="style image for --adain-decoder, --stytr2 or --adaattn")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="AdaIN stylization strength")
    p.add_argument("--vgg_weights", default=None,
                   help="VGG19 weights (.npz/.pth) for the AdaIN and AdaAttN encoders")
    p.add_argument("--precision", default="bf16", choices=["f32", "bf16", "int8"],
                   help="serving compute dtype (int8: flagship only)")
    p.add_argument("--preserve_color", default="off", choices=["off", "luma"])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--size", type=int, default=0,
                   help=">0: resize every request to SIZE x SIZE; 0: native "
                        "sizes, bucketed")
    p.add_argument("--data_parallel", action="store_true",
                   help="a replica on every visible card; a batch whose size "
                        "divides their number is split over them")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--max_pending", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the card)")
    p.add_argument("--cpu", action="store_true",
                   help="serve on the CPU (same as --device cpu)")
    args = p.parse_args(argv)

    forward, family, device = _build_forward(args, "cpu" if args.cpu else args.device)
    # warm the canonical bucket at every batch size the batcher can form
    # (kernel build, cuDNN handles and plans) before traffic
    srv = make_server(
        forward, family=family, device=device,
        host=args.host, port=args.port, size=args.size,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_pending=args.max_pending,
        warm_size=args.size if args.size > 0 else 256)
    host, port = srv.server_address[:2]

    # SIGTERM drains like Ctrl-C: stop accepting, finish in-flight batches,
    # fail what is still queued. Installed BEFORE the ready banner: the
    # banner is the documented "safe to preempt" point, so the handler must
    # already be live when a supervisor reacts to it.
    def _term(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)

    print(f"fnst-serve: {family} model on http://{host}:{port} "
          f"({srv.device}, max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms} ms)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        threading.Thread(target=srv.shutdown, daemon=True).start()


if __name__ == "__main__":
    main()
