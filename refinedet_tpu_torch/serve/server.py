"""Micro-batching serving host for the port's serving function.

The port's own copy of ``refinedet_tpu/serve/server.py``. A GPU, like the
TPU, earns its keep at large batches, so the serving host's job is to
turn many concurrent single-image requests into few large device batches:

* ``BatchingEngine`` — a queue + one dispatcher thread. Requests
  accumulate until ``max_batch`` are waiting or the oldest has waited
  ``max_delay_ms``; the batch is zero-padded up to the next size in
  ``buckets`` (powers of two by default) so the device sees a fixed set
  of shapes (cuDNN picks its algorithms once per shape). Pad rows are
  sliced off before results are returned.
* ``ServingHandler``/``serve_forever`` — a stdlib ThreadingHTTPServer
  front-end: ``POST /detect`` with one raw float32 NHWC image (or an
  ``.npy``), response is an ``.npz`` of the model outputs; ``GET
  /healthz`` liveness; ``GET /stats`` JSON latency percentiles and the
  realized batch-size histogram (the observability the reference's FPS
  print can't give a running service).

The engine is deliberately independent of HTTP — ``submit()`` returns a
``concurrent.futures.Future``, so an embedding application (or a future
gRPC front) reuses the same batching core.

``main`` serves a serving artifact (``--artifact``, as the JAX server
does; on the card each bucket replays its own CUDA graph, captured at
startup), or a model built from ``--checkpoint``/``--seed``.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

_SHUTDOWN = object()


class EngineOverloadedError(RuntimeError):
    """Raised by submit() when the bounded request queue is full — the
    backpressure signal (HTTP front-end maps it to 503)."""


def _default_buckets(max_batch: int) -> Tuple[int, ...]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return tuple(out)


class BatchingEngine:
    """Gather concurrent requests into padded, bucket-sized device batches.

    ``infer_fn(images[B,H,W,C] f32) -> tuple of arrays with leading dim
    B`` — typically ``serve.make_serving_fn(model, ...)``. One dispatcher
    thread owns the device; callers block on the returned Future. An
    ``infer_fn`` exception is delivered to that batch's futures and
    counted in ``stats()["errors"]``.
    """

    def __init__(self, infer_fn: Callable, input_shape: Tuple[int, int, int],
                 max_batch: int = 8, max_delay_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 256, input_dtype="float32"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.infer_fn = infer_fn
        self.input_shape = tuple(input_shape)
        # uint8 for uint8-wire artifacts (in-artifact mean-subtract): the
        # request path, the pad buffer, and the device upload all stay
        # integer — 4x less host->device traffic than the f32 default.
        self.input_dtype = np.dtype(input_dtype)
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.buckets = tuple(sorted(buckets)) if buckets else \
            _default_buckets(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")
        # Bounded: a device that falls behind sheds load at submit()
        # (EngineOverloadedError -> 503) instead of growing an unbounded
        # backlog of requests whose latency deadline is already blown.
        self.max_queue = int(max_queue)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._lock = threading.Lock()
        # Serializes submit()'s liveness-check+put against stop()'s
        # flag-set+shutdown-put: every accepted request is queued AHEAD
        # of the shutdown sentinel, so no Future can be left unresolved
        # by a request racing the drain.
        self._submit_lock = threading.Lock()
        self._latencies: deque = deque(maxlen=4096)
        self._batch_hist: Counter = Counter()
        self._errors = 0
        self._rejected = 0
        self._started = False
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="refinedet-serve-dispatch")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingEngine":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._started and not self._stopping:
            # Flip _stopping under the lock (submit() checks it there), but
            # put the sentinel OUTSIDE it: on a full queue the put blocks
            # for up to one inference, and holding the lock through that
            # would stall every concurrent submit() on lock acquisition
            # instead of letting them hit the fast "not running" path.
            with self._submit_lock:
                self._stopping = True
            self._queue.put(_SHUTDOWN)
            self._thread.join(timeout=30)
            self._started = False
            # Belt-and-braces: fail any stragglers rather than leaving
            # their Futures unresolved forever.
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not _SHUTDOWN:
                    item[1].set_exception(
                        RuntimeError("engine stopped before dispatch"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request path ------------------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue ONE image [H,W,C] of the engine's input_dtype (f32
        mean-subtracted, or raw uint8 pixels for a uint8-wire artifact);
        resolves to a tuple of per-request output arrays (leading batch
        dim stripped)."""
        image = np.asarray(image, self.input_dtype)
        if image.shape != self.input_shape:
            raise ValueError(f"expected image shape {self.input_shape}, "
                             f"got {image.shape}")
        fut: Future = Future()
        with self._submit_lock:
            if not self._started or self._stopping:
                raise RuntimeError("engine is not running (start() it, or "
                                   "it has been stopped)")
            try:
                self._queue.put_nowait((image, fut, time.monotonic()))
            except queue.Full:
                with self._lock:
                    self._rejected += 1
                raise EngineOverloadedError(
                    f"request queue full ({self.max_queue} pending); "
                    "retry later") from None
        return fut

    def __call__(self, image: np.ndarray):
        return self.submit(image).result()

    # -- dispatcher --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SHUTDOWN:
                return
            batch = [item]
            deadline = item[2] + self.max_delay
            while len(batch) < self.max_batch:
                wait = deadline - time.monotonic()
                try:
                    # Past the deadline, still DRAIN without blocking:
                    # requests that queued up behind a long inference
                    # must coalesce, not dribble out one per batch.
                    nxt = (self._queue.get(timeout=wait) if wait > 0
                           else self._queue.get_nowait())
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    self._run(batch)
                    return
                batch.append(nxt)
            self._run(batch)

    def _run(self, batch) -> None:
        n = len(batch)
        padded = self._bucket(n)
        images = np.zeros((padded,) + self.input_shape, self.input_dtype)
        for i, (img, _, _) in enumerate(batch):
            images[i] = img
        try:
            outs = self.infer_fn(images)
        except Exception as e:  # deliver, don't kill the dispatcher
            with self._lock:
                self._errors += 1
            for _, fut, _ in batch:
                fut.set_exception(e)
            return
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        outs = [np.asarray(o) for o in outs]
        now = time.monotonic()
        with self._lock:
            self._batch_hist[n] += 1
            for _, _, t0 in batch:
                self._latencies.append(now - t0)
        for i, (_, fut, _) in enumerate(batch):
            fut.set_result(tuple(o[i] for o in outs))

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            hist = dict(sorted(self._batch_hist.items()))
            errors = self._errors
            rejected = self._rejected
        n = len(lat)

        def pct(p):
            return round(lat[min(n - 1, int(p * n))] * 1e3, 3) if n else None

        return {
            "requests": int(sum(k * v for k, v in hist.items())),
            "batches": int(sum(hist.values())),
            "batch_size_hist": {str(k): v for k, v in hist.items()},
            "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                           "p99": pct(0.99)},
            "errors": errors,
            "rejected": rejected,
            "buckets": list(self.buckets),
            "max_batch": self.max_batch,
            "max_queue": self.max_queue,
            "max_delay_ms": self.max_delay * 1e3,
        }


# -- HTTP front-end ---------------------------------------------------------


def _make_handler(engine: BatchingEngine, meta: dict):
    h, w, c = engine.input_shape
    dtype = engine.input_dtype  # little-endian f32, or uint8 (raw-pixel wire)
    raw_len = h * w * c * dtype.itemsize

    class ServingHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet; /stats is the observability
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/stats":
                self._send_json(200, engine.stats())
            elif self.path == "/meta":
                self._send_json(200, meta)
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/detect":
                return self._send_json(404, {"error": f"no route "
                                                      f"{self.path}"})
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    return self._send_json(
                        400, {"error": "bad Content-Length"})
                # Validate BEFORE allocating: an oversized claim must not
                # buffer gigabytes (413, connection closed — the body is
                # unread). Slack covers the .npy header.
                if length > raw_len + 16384:
                    self.close_connection = True
                    return self._send_json(
                        413, {"error": f"body {length} bytes exceeds "
                                       f"limit {raw_len + 16384} "
                                       f"(one {dtype.name} {h}x{w}x{c} "
                                       f"image)"})
                body = self.rfile.read(length)
                if self.headers.get("Content-Type") == \
                        "application/x-npy":
                    img = np.load(io.BytesIO(body), allow_pickle=False)
                else:  # raw little-endian NHWC bytes of the wire dtype
                    if len(body) != raw_len:
                        return self._send_json(
                            400, {"error": f"expected {raw_len} bytes "
                                           f"({dtype.name} {h}x{w}x{c}), "
                                           f"got {len(body)}"})
                    img = np.frombuffer(
                        body, dtype.newbyteorder("<")).reshape(h, w, c)
                outs = engine.submit(np.ascontiguousarray(img)).result()
            except EngineOverloadedError as e:
                return self._send_json(503, {"error": str(e)})
            except ValueError as e:
                return self._send_json(400, {"error": str(e)})
            except Exception as e:  # inference failure
                return self._send_json(500, {"error": str(e)})
            buf = io.BytesIO()
            np.savez(buf, **{f"out{i}": o for i, o in enumerate(outs)})
            self._send(200, buf.getvalue(), "application/x-npz")

    return ServingHandler


class _ServingHTTPServer(ThreadingHTTPServer):
    # The stdlib default listen backlog of 5 RSTs bursts of concurrent
    # connects on loopback long before the engine queue is the limit
    # (measured: 64 simultaneous clients lose ~11% of requests to
    # ECONNRESET at backlog 5, zero at 128). Size it to the engine's
    # admission bound — the queue's 503 path is the intended shedding
    # mechanism, not the kernel's accept queue.
    request_queue_size = 128


class Server:
    """HTTP serving host: ``Server(engine, meta, port).start()``."""

    def __init__(self, engine: BatchingEngine, meta: dict, port: int = 0,
                 host: str = "127.0.0.1"):
        self.engine = engine
        self.httpd = _ServingHTTPServer(
            (host, port), _make_handler(engine, meta))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="refinedet-serve-http")

    def start(self) -> "Server":
        self.engine.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=30)
        self.engine.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def client_detect(host: str, port: int, image: np.ndarray,
                  timeout: float = 60.0, dtype="<f4"):
    """Minimal stdlib client: send one [H,W,C] image (f32 wire by
    default; pass dtype="u1" for a uint8-wire artifact), return the
    tuple of output arrays."""
    from urllib.request import Request, urlopen

    body = np.ascontiguousarray(np.asarray(image, dtype)).tobytes()
    req = Request(f"http://{host}:{port}/detect", data=body,
                  headers={"Content-Type": "application/octet-stream"})
    with urlopen(req, timeout=timeout) as resp:
        data = resp.read()
    npz = np.load(io.BytesIO(data), allow_pickle=False)
    return tuple(npz[k] for k in sorted(npz.files))


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="micro-batching HTTP serving host")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact",
                     help="a serving artifact from python -m "
                          "refinedet_tpu_torch.tools.export_serving; its "
                          "metadata gives the input size, dtype, wire and "
                          "device")
    src.add_argument("--checkpoint",
                     help="a training checkpoint of the port, or a "
                          "reference-named .pth state_dict ('module.' "
                          "prefixes stripped); strict load")
    src.add_argument("--seed", type=int,
                     help="serve random weights drawn from this seed")
    # Model flags of --checkpoint/--seed; an artifact carries its own.
    model_flags = {"size": 320, "num_classes": 21, "device": "cuda",
                   "dtype": "float32"}
    p.add_argument("--size", type=int, choices=(320, 512),
                   help="default 320")
    p.add_argument("--num_classes", type=int, help="default 21")
    p.add_argument("--device", help="default cuda")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   help="default float32")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--max_queue", type=int, default=256,
                   help="pending-request bound; overload returns 503")
    args = p.parse_args(argv)
    for name, default in model_flags.items():
        if args.artifact is None:
            if getattr(args, name) is None:
                setattr(args, name, default)
        elif getattr(args, name) is not None:
            p.error(f"--{name} comes from the artifact's metadata; it "
                    "does not go with --artifact")
    return args


def load_model(args):
    """The test-phase model the flags ask for, with the weights of
    ``--checkpoint`` (read as the eval CLIs read theirs) or of
    ``--seed``."""
    import torch

    from refinedet_tpu_torch.eval.cli_coco import make_loader
    from refinedet_tpu_torch.models.builder import build_refinedet

    model = build_refinedet("test", args.size, args.num_classes,
                            dtype=getattr(torch, args.dtype),
                            device=args.device, seed=args.seed or 0)
    if args.checkpoint:
        model.net.load_state_dict(make_loader()(args.checkpoint),
                                  strict=True)
    return model


def make_server(args) -> Server:
    """The server ``args`` ask for, its engine warm and not yet started.

    With ``--artifact``, the loaded ``ServingModel`` answers, and on the
    card each of the engine's buckets replays its own CUDA graph, captured
    here; the artifact's metadata is the server's ``/meta``. Otherwise a
    fused-NMS serving function over the model of ``load_model``, each
    bucket run once here (the kernel build and cuDNN's plans belong at
    startup, not on the first unlucky requests).
    """
    from refinedet_tpu_torch.serve.export import (FUSED_OUTPUT, FORMAT,
                                                  load_serving,
                                                  make_serving_fn)

    if args.artifact:
        serving = load_serving(args.artifact)
        meta, dtype = serving.meta, serving.input_dtype
    else:
        model = load_model(args)
        serving = make_serving_fn(model, None, fused_nms={})
        meta = {"format": FORMAT, "input_size": args.size,
                "num_classes": args.num_classes, "dtype": args.dtype,
                "device": str(model.device), "fused_nms": {},
                "input": "NHWC float32, mean-subtracted RGB",
                "output": FUSED_OUTPUT}
        dtype = np.dtype(np.float32)
    size = meta["input_size"]
    engine = BatchingEngine(serving, (size, size, 3),
                            max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            max_queue=args.max_queue, input_dtype=dtype)
    if args.artifact:
        serving.warm_up(engine.buckets)
    else:
        for b in engine.buckets:
            serving(np.zeros((b, size, size, 3), dtype))
    return Server(engine, meta, args.port, args.host)


def main(argv=None):
    """``python -m refinedet_tpu_torch.serve.server --artifact m.rdtpu``

    Serves an artifact of ``tools/export_serving.py`` (on the device it
    was exported on, one CUDA graph per bucket on the card), or
    fused-NMS detections (``dets [C-1, 200, 5]`` per image) of a
    test-phase RefineDet built on ``--device`` (the card by default),
    with the weights of ``--checkpoint`` (a port training checkpoint or
    a reference-named ``.pth``) or drawn from ``--seed``.
    """
    args = parse_args(argv)
    with make_server(args) as srv:
        name = args.artifact or f"RefineDet{srv.engine.input_shape[0]}"
        print(f"serving {name} on http://{args.host}:{srv.port} "
              f"(buckets {list(srv.engine.buckets)}, "
              f"max_delay {args.max_delay_ms} ms)", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
