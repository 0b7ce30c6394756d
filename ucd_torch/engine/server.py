"""HTTP inference server with dynamic micro-batching.

Counterpart of ucd_tpu/engine/server.py, over the same inference npz:

  * concurrent requests are COALESCED into batched device calls — a
    request waits at most `max_wait_ms` for peers before its batch is
    dispatched;
  * images group by spatial bucket (pad-to-multiple, as `predict_paths`),
    and a bucket's partial batch pads back up to the full batch size once
    a full batch has run for that bucket;
  * the HTTP layer is stdlib-only (`http.server`), one handler thread per
    connection, all device work serialized through the single batcher
    thread.

Formats: `ids` (PNG, mode L, pixel = class id), `color` (PNG, dataset
palette) and `json` (class-id lists + per-class pixel histogram).
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .export import _bucket_hw, complete_padded_chunk, dispatch_padded_chunk

# Largest request body do_POST will read into memory (64 MB covers any
# realistic PNG/JPEG; a 4096x4096 RGB PNG is ~<50 MB uncompressed).
MAX_BODY_BYTES = 64 * 1024 * 1024


class _Item:
    __slots__ = ("img", "h", "w", "key", "event", "result", "error")

    def __init__(self, img: np.ndarray, bucket: int):
        self.img = img
        self.h, self.w = img.shape[:2]
        self.key = _bucket_hw(self.h, self.w, bucket)
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class MicroBatcher:
    """Coalesce concurrent `submit` calls into batched Predictor calls.

    One daemon thread owns the device: it pops the first waiting request,
    gives peers `max_wait_ms` to pile on (returning early the moment any
    bucket fills a whole batch), then dispatches one device call per
    spatial-bucket group (chunked at `batch_size`). `stats()` exposes the
    coalescing behavior (batches, images, padded rows), counted at
    dispatch.

    Dispatch is PIPELINED: a chunk's kernels and its device->host copy are
    enqueued on the CUDA stream (export.dispatch_padded_chunk) and its
    result is waited for later (complete_padded_chunk), so while chunk N
    runs on the device the batcher thread is already collecting and
    enqueueing chunk N+1. Up to `pipeline_depth` chunks stay in flight
    while more traffic is queued; the moment the queue is empty every
    pending chunk completes, so an idle server adds no latency.
    `pipeline_depth=0` makes dispatch synchronous."""

    def __init__(self, predictor, bucket: int = 128, batch_size: int = 8,
                 max_wait_ms: float = 5.0, pipeline_depth: int = 2):
        self.predictor = predictor
        self.bucket = int(bucket)
        self.batch_size = max(int(batch_size), 1)
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self._pending: collections.deque = collections.deque()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._stats = {"batches": 0, "images": 0, "padded_rows": 0}
        self._full_seen: set = set()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ucd-microbatcher")
        self._thread.start()

    def submit(self, img_u8: np.ndarray) -> np.ndarray:
        """uint8 HWC image -> (h, w) uint8 class-id map. Thread-safe;
        blocks until this request's batch has run."""
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected HWC RGB image, got {img_u8.shape}")
        it = _Item(np.ascontiguousarray(img_u8, np.uint8), self.bucket)
        # the closed-check and the enqueue are atomic vs close()'s flag-set
        # (same lock): once close() holds the lock and sets _closed, no new
        # item can slip into the queue after _fail_queued() drained it, so
        # no waiter can block forever on an event nobody will set.
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(it)
        it.event.wait()
        if it.error is not None:
            raise it.error
        return it.result

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def close(self):
        # flag first under the lock (submit's check+put holds the same
        # lock, so after this no new item can enter the queue), then the
        # sentinel, then drain anything already queued — every queued
        # waiter gets either a result or an error
        with self._lock:
            self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5.0)
        self._fail_queued(RuntimeError("MicroBatcher is closed"))

    def _fail_queued(self, err: Exception):
        # if the batcher thread outlived close()'s join, this drain could
        # eat the None sentinel and leave _loop running forever — so the
        # sentinel is re-enqueued after the drain if we consumed one
        sentinel_eaten = False
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is None:
                sentinel_eaten = True
            elif not it.event.is_set():
                it.error = err
                it.event.set()
        if sentinel_eaten and self._thread.is_alive():
            self._q.put(None)

    # -- batcher thread --

    def _loop(self):
        while True:
            try:
                # with chunks in flight, poll instead of blocking: an empty
                # queue means traffic paused, so drain one pending chunk
                # (its waiters are blocked on it) and re-check
                it = self._q.get(block=not self._pending)
            except queue.Empty:
                self._complete_chunk(self._pending.popleft())
                continue
            if it is None:
                self._drain_pending()
                return
            batch = [it]
            counts = {it.key: 1}
            deadline = time.monotonic() + self.max_wait
            while max(counts.values()) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    self._drain_pending()
                    return
                batch.append(nxt)
                counts[nxt.key] = counts.get(nxt.key, 0) + 1
            self._dispatch(batch)
            while len(self._pending) > self.pipeline_depth:
                self._complete_chunk(self._pending.popleft())

    def _dispatch(self, batch):
        groups: dict = {}
        for it in batch:
            groups.setdefault(it.key, []).append(it)
        for key, items in groups.items():
            for i in range(0, len(items), self.batch_size):
                self._dispatch_chunk(key, items[i:i + self.batch_size])

    def _dispatch_chunk(self, key, items):
        # the pad-back-to-full-batch rule lives in
        # export.dispatch_padded_chunk (one copy, shared with
        # predict_paths). The device call is enqueued here; the result is
        # waited for in _complete_chunk.
        try:
            dev_preds, padded = dispatch_padded_chunk(
                self.predictor, key, [(it.img, it.h, it.w) for it in items],
                self.batch_size, self._full_seen)
            with self._lock:
                self._stats["batches"] += 1
                self._stats["images"] += len(items)
                self._stats["padded_rows"] += padded
            self._pending.append((dev_preds, items))
        except Exception as e:  # shape/launch errors surface at dispatch
            for it in items:
                if not it.event.is_set():
                    it.error = e
                    it.event.set()

    def _complete_chunk(self, pending):
        dev_preds, items = pending
        try:
            preds = complete_padded_chunk(dev_preds,
                                          [(it.img, it.h, it.w)
                                           for it in items])
            for p, it in zip(preds, items):
                it.result = p
                it.event.set()
        except Exception as e:  # asynchronous device errors surface here
            for it in items:
                if not it.event.is_set():
                    it.error = e
                    it.event.set()

    def _drain_pending(self):
        while self._pending:
            self._complete_chunk(self._pending.popleft())


class _Handler(BaseHTTPRequestHandler):
    server_version = "ucd-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        path = urlparse(self.path).path
        if path in ("/healthz", "/health"):
            self._send_json(200, {
                "status": "ok",
                "model": self.server.meta,            # type: ignore
                "stats": self.server.batcher.stats(),  # type: ignore
            })
        else:
            self._send_json(404, {"error": f"no route {path!r}; "
                                           "POST /predict or GET /healthz"})

    def do_POST(self):
        from PIL import Image

        url = urlparse(self.path)
        # drain the body BEFORE any (error) response: this is an HTTP/1.1
        # keep-alive handler, so an unread image body would be parsed as
        # the connection's next request line. Without a usable
        # Content-Length the body can't be drained — close instead.
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._send_json(413, {"error": f"body {length} bytes exceeds "
                                           f"limit {MAX_BODY_BYTES}"})
            return
        if length > 0:
            body = self.rfile.read(length)
        else:
            body = b""
            self.close_connection = True
        if url.path != "/predict":
            self._send_json(404, {"error": f"no route {url.path!r}"})
            return
        fmt = parse_qs(url.query).get("format", ["ids"])[0]
        if fmt not in ("ids", "color", "json"):
            self._send_json(400, {"error": f"format {fmt!r} not in "
                                           "('ids', 'color', 'json')"})
            return
        try:
            if not body:
                raise ValueError("empty body")
            img = np.asarray(
                Image.open(io.BytesIO(body)).convert("RGB"), np.uint8)
        except Exception as e:
            self._send_json(400, {"error": f"bad image body: {e}"})
            return
        try:
            preds = self.server.batcher.submit(img)  # type: ignore
        except Exception as e:
            self._send_json(500, {"error": f"prediction failed: {e}"})
            return
        if fmt == "json":
            hist = np.bincount(preds.ravel(),
                               minlength=self.server.n_classes)  # type: ignore
            self._send_json(200, {
                "shape": list(preds.shape),
                "ids": preds.tolist(),
                "class_pixels": {str(c): int(v) for c, v in enumerate(hist)
                                 if v},
            })
            return
        if fmt == "color":
            # palettized PNG: same decoded RGB as the full palette lookup,
            # 1/3 the bytes to compress (host PNG encode is the hot op)
            im = self.server.to_palette_png(preds)  # type: ignore
        else:
            im = Image.fromarray(preds)
        buf = io.BytesIO()
        im.save(buf, format="PNG", compress_level=1)
        self._send(200, buf.getvalue(), "image/png")


def make_server(npz_path: str, host: str = "127.0.0.1", port: int = 8433,
                *, batch_size: int = 8, bucket: int = 128,
                max_wait_ms: float = 5.0, fusion_mode: str = "mean",
                scales=(1.0,), flip: bool = False, fused: bool = True,
                pipeline_depth: int = 2, verbose: bool = False,
                device=None) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server over an inference npz.
    `server.serve_forever()` runs it; `shutdown_server(server)` stops it
    and the batcher thread. Separated from `serve` so tests can bind
    port 0 and drive it in-process."""
    import functools

    from ..utils.viz import color_map, palette_png
    from .export import load_inference
    from .predictor import Predictor

    model, meta = load_inference(npz_path, device=device)
    predictor = Predictor(model, fusion_mode=fusion_mode, flip=flip,
                          scales=scales, fused=fused, device=device)
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    srv.batcher = MicroBatcher(predictor, bucket=bucket,  # type: ignore
                               batch_size=batch_size, max_wait_ms=max_wait_ms,
                               pipeline_depth=pipeline_depth)
    srv.meta = {k: v for k, v in meta.items() if k != "bf16_keys"}  # type: ignore
    srv.n_classes = sum(meta["classes"])  # type: ignore
    srv.to_palette_png = functools.partial(  # type: ignore
        palette_png, cmap=color_map(meta["dataset"]))
    srv.verbose = verbose  # type: ignore
    return srv


def shutdown_server(srv: ThreadingHTTPServer):
    srv.shutdown()
    srv.server_close()
    srv.batcher.close()  # type: ignore[attr-defined]


def serve(npz_path: str, host: str = "127.0.0.1", port: int = 8433,
          warmup_size: int = 0, **kw):
    """CLI entry: build, optionally warm up the common bucket, serve."""
    srv = make_server(npz_path, host, port, **kw)
    if warmup_size > 0:
        # run one full batch of the warmup bucket BEFORE accepting traffic:
        # the kernel build, cuDNN's algorithm choice and the allocator's
        # pools are paid here, not by the first request. The serving
        # max_wait is widened meanwhile so a slow thread start cannot split
        # the warmup into partial batches.
        batcher: MicroBatcher = srv.batcher  # type: ignore[attr-defined]
        img = np.zeros((warmup_size, warmup_size, 3), np.uint8)
        serving_wait = batcher.max_wait
        batcher.max_wait = max(serving_wait, 5.0)  # widen only, never narrow
        try:
            threads = [threading.Thread(target=batcher.submit, args=(img,))
                       for _ in range(batcher.batch_size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            batcher.max_wait = serving_wait
        full = batcher.stats()["batches"] == 1
        print(f"[serve] warmed up {warmup_size}x{warmup_size} "
              f"batch-{batcher.batch_size}"
              + ("" if full else " (split into partial batches)"))
    print(f"[serve] listening on http://{host}:{srv.server_address[1]} "
          f"(POST /predict?format=ids|color|json, GET /healthz)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_server(srv)
