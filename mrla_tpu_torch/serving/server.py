"""Batching inference daemon: the port's counterpart of the JAX package's
``serving/server.py``.  Stdlib HTTP (``ThreadingHTTPServer``) around the
engines the eval CLI uses (``cli.make_engine_forward``):

  * one fixed batch shape: requests are queued and flushed as a padded
    [batch_size, H, W, 3] batch, when full or ``max_wait_ms`` after the
    oldest request arrived; padding rows repeat row 0 (every engine is
    per-sample math, so padding cannot move a real row);
  * two threads: the flusher casts a batch's real rows on the host (numpy
    has no bf16: ``torch.from_numpy(x)`` copied into a pinned bf16 buffer),
    copies them to the card without blocking, fills the padding rows with
    row 0 there, and dispatches the forward, which queues its kernels and
    returns; the completer copies the result to the host, which
    waits for the batch (the synchronisation point), and wakes the waiting
    requests, so batch N + 1 runs on the card while batch N streams back.
    A ring of three pinned buffers, each with an event recorded after its
    copy, lets a buffer be refilled only once its copy has ended.  Grad
    mode is thread-local: both threads run under ``torch.inference_mode``.

Endpoints (routes, bodies and status codes as the JAX daemon's):
  GET  /healthz           -> {"status": "ok", ...model info}
  GET  /stats             -> request / batch counters and padded rows
  POST /predict           -> logits (+ optional top-k)
      body: .npy bytes (Content-Type: application/x-npy) of one [H, W, 3]
      image or an [N, H, W, 3] batch, float; or JSON {"instances": [...]}.
      Values are expected normalised.  Response: {"predictions": [[...]]},
      or {"topk": [{"classes": [...], "scores": [...]}, ...]} with ?topk=K;
      a detection pyramid daemon answers application/x-npz (one
      ``level{i}`` array per level, fp32), a detections daemon JSON
      {"detections": [{"boxes", "scores", "labels"[, "masks"]}, ...]}
      (masks on ?masks=1).  400 on a bad body or shape, 404 on another
      route, 500 on an engine error, 504 on a timeout.

Usage:
    python -m mrla_tpu_torch.serving.server -a resnet50_mrlal \\
        [--torch ckpt.pth.tar | --resume runs/x] [-b 128] [--port 8000]
    python -m mrla_tpu_torch.serving.server \\
        --detect-preset faster_rcnn_r50mrlal_fpn_1x_coco \\
        --detect-output detections [-b 8] [--torch detector.pth]

The JAX daemon's ``--roi-backend`` has no counterpart: the port always
runs its RoIAlign kernel on the presets' exact grid.  Nor has
``--no-compile-cache`` (an XLA cache).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mrla_tpu_torch._device import resolve_device

RING = 3  # pinned host buffers: more than the two batches in flight


class _Pending:
    """One queued image; ``event`` signals that its result is available."""

    __slots__ = ("image", "event", "logits", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.logits = None
        self.error: Optional[Exception] = None


def _to_host(out):
    """An engine's output on the host: a tensor as a numpy array (fp32
    where numpy has no such dtype), a tuple of them likewise."""
    if isinstance(out, (tuple, list)):
        return tuple(_to_host(o) for o in out)
    out = out.detach().cpu()
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.numpy()


class BatchingEngine:
    """Collects single-image requests into fixed-size padded batches.

    fwd: [batch_size, H, W, 3] tensor on ``device`` -> [batch_size, ...]
    tensor (or a tuple of them).  Flush policy: when ``batch_size``
    requests are waiting, at once; otherwise ``max_wait_ms`` after the
    oldest request arrived.  Batches reach ``fwd`` in ``input_dtype``
    (cast on the host; bf16 halves the bytes copied to the card)."""

    def __init__(self, fwd: Callable, batch_size: int, image_shape,
                 max_wait_ms: float = 5.0, input_dtype=torch.float32,
                 device="cuda"):
        self.fwd = fwd
        self.batch_size = int(batch_size)
        self.image_shape = tuple(image_shape)  # (H, W, 3)
        self.max_wait_s = max_wait_ms / 1e3
        self.input_dtype = input_dtype
        self.device = resolve_device(device)
        self.queue: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0}
        self._stats_lock = threading.Lock()
        pinned = self.device.type == "cuda"
        self._ring = [
            torch.empty((self.batch_size,) + self.image_shape,
                        dtype=input_dtype, pin_memory=pinned)
            for _ in range(RING)]
        self._copied = [None] * RING  # the event after each buffer's copy
        self._slot = 0
        self._stop = threading.Event()
        # the flusher dispatches batches and the completer fetches them
        self._done: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._thread.start()
        self._completer.start()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._completer.join(timeout=5)

    def _count(self, **add) -> None:
        with self._stats_lock:
            for k, v in add.items():
                self.stats[k] += v

    def submit(self, image: np.ndarray) -> _Pending:
        if image.shape != self.image_shape:
            raise ValueError(
                f"image shape {image.shape} != server shape {self.image_shape}"
            )
        p = _Pending(np.asarray(image, np.float32))
        self._count(requests=1)
        self.queue.put(p)
        return p

    def _collect(self):
        """Block for the first request, then gather until full or timeout."""
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _upload(self, batch) -> torch.Tensor:
        """The padded batch in ``input_dtype`` on the device: the real
        rows cast on the host into the next pinned buffer of the ring and
        copied, the padding rows filled with row 0 on the device."""
        n = len(batch)
        slot = self._slot
        self._slot = (slot + 1) % RING
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy has ended
        buf = self._ring[slot]
        buf[:n].copy_(torch.from_numpy(np.stack([p.image for p in batch])))
        x = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
        x[:n].copy_(buf[:n], non_blocking=True)
        if self.device.type == "cuda":
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()
        x[n:] = x[:1]
        return x

    def _loop(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                batch = self._collect()
                if not batch:
                    continue
                self._count(batches=1,
                            padded_rows=self.batch_size - len(batch))
                try:
                    out = self.fwd(self._upload(batch))  # queues, returns
                except Exception as e:  # shape / engine errors surface here
                    for p in batch:
                        p.error = e
                        p.event.set()
                    continue
                self._done.put((batch, out))  # bounded: 2 deep

    def _complete_loop(self):
        with torch.inference_mode():
            while not (self._stop.is_set() and self._done.empty()):
                try:
                    batch, out = self._done.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    host = _to_host(out)  # waits for the batch
                    for i, p in enumerate(batch):
                        p.logits = (tuple(lv[i] for lv in host)
                                    if isinstance(host, tuple) else host[i])
                except Exception as e:  # device errors reach the callers
                    for p in batch:
                        p.error = e
                for p in batch:
                    p.event.set()


def detections_json(result, want_masks: bool = False) -> dict:
    """One image's (boxes [M, 4], scores [M], labels [M], valid [M][,
    masks [M, 28, 28]]) on the host -> its JSON detections, the invalid
    rows dropped; the soft masks (rounded to 4 places) only on request."""
    boxes, scores, labels, valid = result[:4]
    m = np.asarray(valid, bool)
    det = {
        "boxes": np.asarray(boxes)[m].astype(float).tolist(),
        "scores": np.asarray(scores)[m].astype(float).tolist(),
        "labels": np.asarray(labels)[m].astype(int).tolist(),
    }
    if want_masks and len(result) > 4:
        det["masks"] = (np.asarray(result[4])[m].astype(float).round(4)
                        .tolist())
    return det


def _make_handler(engine: BatchingEngine, info: dict, timeout_s: float = 120.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                return self._json(200, {"status": "ok", **info})
            if self.path.startswith("/stats"):
                with engine._stats_lock:
                    return self._json(200, dict(engine.stats))
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if "npy" in ctype or body[:6] == b"\x93NUMPY":
                    arr = np.load(io.BytesIO(body), allow_pickle=False)
                else:
                    arr = np.asarray(
                        json.loads(body)["instances"], np.float32
                    )
                if arr.ndim == 3:
                    arr = arr[None]
                if arr.ndim != 4:
                    raise ValueError(f"expected [N,H,W,3], got {arr.shape}")
            except Exception as e:
                return self._json(400, {"error": str(e)})

            try:
                pendings = [engine.submit(im) for im in arr]
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            for p in pendings:
                if not p.event.wait(timeout=timeout_s):
                    return self._json(504, {"error": "inference timeout"})
                if p.error is not None:
                    return self._json(500, {"error": str(p.error)})

            if info.get("output") == "detections":
                want_masks = "masks=1" in self.path
                return self._json(200, {"detections": [
                    detections_json(p_.logits, want_masks)
                    for p_ in pendings]})

            if isinstance(pendings[0].logits, tuple):
                # detection export -> npz: one array per pyramid level
                n_levels = len(pendings[0].logits)
                buf = io.BytesIO()
                np.savez(
                    buf,
                    **{
                        f"level{lv}": np.stack(
                            [p.logits[lv] for p in pendings]
                        )
                        for lv in range(n_levels)
                    },
                )
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None

            logits = np.stack([p.logits for p in pendings])
            topk = 0
            if "topk=" in self.path:
                try:
                    topk = int(self.path.split("topk=")[1].split("&")[0])
                except ValueError:
                    pass
            if topk:
                order = np.argsort(-logits, axis=-1)[:, :topk]
                return self._json(200, {
                    "topk": [
                        {
                            "classes": order[i].tolist(),
                            "scores": logits[i, order[i]].astype(float).tolist(),
                        }
                        for i in range(len(order))
                    ]
                })
            return self._json(
                200, {"predictions": logits.astype(float).tolist()}
            )

    return Handler


def build_server(
    arch: str,
    weights,
    batch_size: int = 128,
    image_size: int = 224,
    num_classes: int = 1000,
    engine: str = "auto",
    microbatch: Optional[int] = None,
    max_wait_ms: float = 5.0,
    host: str = "127.0.0.1",
    port: int = 8000,
    timeout_s: float = 120.0,
    input_dtype=None,
    quant: str = "none",
    calib_x=None,
    device="cuda",
    model=None,
):
    """Returns (ThreadingHTTPServer, BatchingEngine) ready for
    ``serve_forever()``.  ``weights`` is a state_dict of ``arch`` (None
    serves the model's own); ``model`` a built model of the arch (default:
    ``create_model(arch, num_classes=...)``, which gives the engine its
    structure).  The first request builds the kernels unless the caller
    warms the engine first (``main()`` does)."""
    from mrla_tpu_torch.models import create_model
    from mrla_tpu_torch.serving.cli import make_engine_forward

    dev = resolve_device(device)
    if model is None:
        model = create_model(arch, device="cpu", num_classes=num_classes)
    fwd = make_engine_forward(
        arch, model, weights, engine=engine, microbatch=microbatch,
        num_classes=num_classes, quant=quant, calib_x=calib_x, device=dev,
    )
    beng = BatchingEngine(
        fwd, batch_size, (image_size, image_size, 3), max_wait_ms,
        input_dtype=input_dtype or torch.bfloat16, device=dev,
    )
    info = {
        "arch": arch,
        "batch_size": batch_size,
        "image_size": image_size,
        "num_classes": num_classes,
    }
    httpd = ThreadingHTTPServer(
        (host, port), _make_handler(beng, info, timeout_s=timeout_s)
    )
    return httpd, beng


def build_detect_server(
    preset: str,
    det_weights,
    batch_size: int = 8,
    image_hw=(800, 1344),
    microbatch: int = 0,
    max_wait_ms: float = 5.0,
    host: str = "127.0.0.1",
    port: int = 8000,
    timeout_s: float = 120.0,
    input_dtype=None,
    device="cuda",
    backbone_layers=None,
):
    """Detection-export daemon: POST /predict (npy [N, H, W, 3]) ->
    application/x-npz with one ``level{i}`` array per pyramid level.
    ``preset`` is a ``detect.configs.PRESETS`` key; ``det_weights`` an
    mmdet-keyed detector or backbone + FPN (a module or its state_dict)."""
    from mrla_tpu_torch.detect.configs import PRESETS
    from mrla_tpu_torch.serving import detect_forward, prepare_detect_params

    dev = resolve_device(device)
    p = PRESETS[preset]
    layers = tuple(backbone_layers or p.backbone_layers)
    sp = prepare_detect_params(det_weights, layers=layers, device=dev)

    def fwd(x):
        levels = detect_forward(sp, x, layers=layers, microbatch=microbatch,
                                start_level=p.start_level,
                                add_extra_convs=p.add_extra_convs)
        if len(levels) != p.num_outs:
            raise ValueError(f"{preset}: the pyramid has {len(levels)} "
                             f"levels, the preset {p.num_outs}")
        return levels

    h, w = image_hw
    beng = BatchingEngine(fwd, batch_size, (h, w, 3), max_wait_ms,
                          input_dtype=input_dtype or torch.bfloat16,
                          device=dev)
    info = {"preset": preset, "batch_size": batch_size,
            "image_hw": [h, w], "num_outs": p.num_outs}
    httpd = ThreadingHTTPServer(
        (host, port), _make_handler(beng, info, timeout_s=timeout_s)
    )
    return httpd, beng


def build_detections_server(
    preset: str,
    det_weights,
    num_classes: int = 80,
    batch_size: int = 8,
    image_hw=(800, 1344),
    score_thr: float = 0.05,
    max_per_img: int = 100,
    max_wait_ms: float = 5.0,
    host: str = "127.0.0.1",
    port: int = 8000,
    timeout_s: float = 120.0,
    num_proposals: int = 1000,
    backbone_layers=None,
    rpn_nms_pre: int = 1000,
    device="cuda",
):
    """Full-detector daemon: POST /predict (npy [N, H, W, 3]) -> JSON
    detections (boxes / scores / labels per image, mmdet's test decode).

    A ``retinanet`` preset serves the ``RetinaNet`` module (``det_weights``
    its module or state_dict) under bf16 autocast, then ``get_bboxes``, as
    the JAX daemon serves the Flax module.  The two-stage presets go
    through ``prepare_detect_params`` / ``two_stage_detections``, whose
    RoIAlign kernel samples the presets' exact grid
    (``sampling_ratio=0``)."""
    from mrla_tpu_torch.detect.configs import PRESETS

    dev = resolve_device(device)
    p = PRESETS[preset]
    layers = tuple(backbone_layers or p.backbone_layers)
    h, w = image_hw
    if "retinanet" in preset:
        from mrla_tpu_torch.detect.retinanet import RetinaNet, get_bboxes

        if isinstance(det_weights, torch.nn.Module):
            model = det_weights
        else:
            model = RetinaNet(layers=layers, num_classes=num_classes)
            model.load_state_dict({k.removeprefix("module."): v
                                   for k, v in det_weights.items()})
        model = model.to(dev).eval()

        def fwd(x):
            with torch.autocast(dev.type, torch.bfloat16):
                outs = model(x)
                return get_bboxes(outs, (h, w), score_thr=score_thr,
                                  max_per_img=max_per_img)

    else:
        from mrla_tpu_torch.serving import (
            prepare_detect_params,
            two_stage_detections,
        )

        sp = prepare_detect_params(det_weights, layers=layers, device=dev)

        def fwd(x):
            return two_stage_detections(
                sp, x, preset=preset, score_thr=score_thr,
                max_per_img=max_per_img, num_proposals=num_proposals,
                rpn_nms_pre=rpn_nms_pre, layers=layers)

    beng = BatchingEngine(fwd, batch_size, (h, w, 3), max_wait_ms,
                          input_dtype=torch.bfloat16, device=dev)
    info = {"preset": preset, "batch_size": batch_size,
            "image_hw": [h, w], "num_classes": num_classes,
            "output": "detections"}
    httpd = ThreadingHTTPServer(
        (host, port), _make_handler(beng, info, timeout_s=timeout_s)
    )
    return httpd, beng


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mrla_tpu_torch serving daemon")
    p.add_argument("-a", "--arch", default="resnet50_mrlal")
    p.add_argument("--torch", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=None,
                   help="default: 1000 (classification), 80 (COCO "
                        "detection presets)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "mrlal", "mrlab", "precast"])
    p.add_argument("--microbatch", type=int, default=None)
    p.add_argument("--quant", default="none",
                   choices=("none", "int8", "int8-fast"),
                   help="int8 PTQ engine (mrlal only); requires "
                        "--calib-npy")
    p.add_argument("--calib-npy", default=None,
                   help="calibration batch for --quant: .npy [B,H,W,3] "
                        "float (normalized) images")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="per-request inference wait before 504")
    p.add_argument("--detect-preset", default=None,
                   help="serve detection feature export instead of "
                        "classification (a detect.configs.PRESETS key; "
                        "responses are npz pyramids)")
    p.add_argument("--detect-output", default="pyramid",
                   choices=["pyramid", "detections"],
                   help="'detections' runs the FULL detector (head + "
                        "decode + NMS) and answers JSON "
                        "boxes/scores/labels")
    p.add_argument("--score-thr", type=float, default=0.05)
    p.add_argument("--image-hw", type=int, nargs=2, default=(800, 1344),
                   metavar=("H", "W"),
                   help="detection input size (COCO eval contract)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="the card by default; 'cpu' runs the kernels' "
                        "plain versions")
    return p


def _random_detector(preset: str, num_classes: int, full: bool):
    """A detector of ``preset`` with its constructor's random weights: the
    whole detector with ``full``, else the backbone + FPN of its pyramid."""
    from mrla_tpu_torch.detect import PRESETS, MRLABackboneFPN
    from mrla_tpu_torch.detect.retinanet import RetinaNet
    from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN

    p = PRESETS[preset]
    layers = tuple(p.backbone_layers)
    if not full:
        return MRLABackboneFPN(layers=layers, start_level=p.start_level,
                               add_extra_convs=p.add_extra_convs)
    if "retinanet" in preset:
        return RetinaNet(layers=layers, num_classes=num_classes)
    cls = MaskRCNN if p.with_mask else FasterRCNN
    return cls(layers=layers, num_classes=num_classes)


def _serve(httpd, beng, warm_shape, banner: str) -> None:
    """Warm the engine at the serving shape, then serve until interrupted."""
    with torch.inference_mode():
        _to_host(beng.fwd(torch.zeros(warm_shape, dtype=beng.input_dtype,
                                      device=beng.device)))
    print(banner, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        beng.close()
        httpd.server_close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_argparser().parse_args(argv)
    if args.num_classes is None:
        # the classification default (ImageNet-1K) must not leak into the
        # detection presets (COCO: 80 classes)
        args.num_classes = 80 if args.detect_preset else 1000
    dev = resolve_device(args.device)

    if args.detect_preset:
        detections = args.detect_output == "detections"
        h, w = args.image_hw
        if args.torch:
            sd = torch.load(args.torch, map_location="cpu",
                            weights_only=True)
            det = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        else:
            print("warning: no --torch given, serving RANDOM weights",
                  flush=True)
            det = _random_detector(args.detect_preset, args.num_classes,
                                   full=detections)
        if detections:
            httpd, beng = build_detections_server(
                args.detect_preset, det, num_classes=args.num_classes,
                batch_size=args.batch_size, image_hw=(h, w),
                score_thr=args.score_thr, max_wait_ms=args.max_wait_ms,
                host=args.host, port=args.port, timeout_s=args.timeout_s,
                device=dev,
            )
        else:
            httpd, beng = build_detect_server(
                args.detect_preset, det, batch_size=args.batch_size,
                image_hw=(h, w), microbatch=args.microbatch or 0,
                max_wait_ms=args.max_wait_ms, host=args.host,
                port=args.port, timeout_s=args.timeout_s, device=dev,
            )
        _serve(httpd, beng, (args.batch_size, h, w, 3),
               f"serving {args.detect_preset} {args.detect_output} on "
               f"{args.host}:{args.port} (batch {args.batch_size}, "
               f"{h}x{w})")
        return

    from mrla_tpu_torch.models import create_model
    from mrla_tpu_torch.serving.cli import _load_variables

    model = create_model(args.arch, device="cpu",
                         num_classes=args.num_classes)
    weights = _load_variables(args, model)
    calib_x = None
    if args.quant != "none":
        if not args.calib_npy:
            raise SystemExit("--quant needs --calib-npy (a [B,H,W,3] "
                             "float .npy of normalized images)")
        calib_x = np.load(args.calib_npy)
    httpd, beng = build_server(
        args.arch, weights, batch_size=args.batch_size,
        image_size=args.image_size, num_classes=args.num_classes,
        engine=args.engine, microbatch=args.microbatch,
        max_wait_ms=args.max_wait_ms, host=args.host, port=args.port,
        timeout_s=args.timeout_s, quant=args.quant, calib_x=calib_x,
        device=dev, model=model,
    )
    _serve(httpd, beng,
           (args.batch_size, args.image_size, args.image_size, 3),
           f"serving {args.arch} on {args.host}:{args.port} "
           f"(batch {args.batch_size}, {args.image_size}px)")


if __name__ == "__main__":
    main()
