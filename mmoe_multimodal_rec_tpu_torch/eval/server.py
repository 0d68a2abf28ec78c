"""Online serving front-end over the Predictor (stdlib HTTP, no new deps).

The PyTorch port's copy of mmoe_multimodal_rec_tpu/eval/server.py; it is
framework-free apart from the predictor it wraps.  One static batch shape
per bucket, padding + valid masking, and cross-request micro-batching so
concurrent low-latency traffic still rides the device at full batch.

  POST /v1/predict   {"instances": [{"user_text": str, "item_text": str,
                                     "patch_b64": base64(uint8[196*768])?}]}
                  -> {"predictions": [{"prob_good": f, "prob_best": f}]}
  GET  /healthz      liveness + model/step info
  GET  /varz         request/instance/batch counters, latency quantiles

`MicroBatcher` gathers instances from concurrent requests into one device
batch: the dispatcher blocks on the first instance, then drains the queue
for up to `max_wait_ms` (or until `batch_size` instances), runs the
forward, and fans results back out.  A request carrying more than
`batch_size` instances is simply chunked across consecutive device batches.
"""
from __future__ import annotations

import base64
import binascii
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.decode import PATCH_SHAPE

_PATCH_BYTES = int(np.prod(PATCH_SHAPE))


class BadInstance(ValueError):
    """Client-side error in a request instance (-> HTTP 400)."""


def _parse_instance(inst: Any) -> Dict[str, Any]:
    if not isinstance(inst, dict):
        raise BadInstance(f"instance must be an object, got {type(inst).__name__}")
    user = inst.get("user_text")
    item = inst.get("item_text")
    if not isinstance(user, str) or not isinstance(item, str):
        raise BadInstance("instance needs string 'user_text' and 'item_text'")
    patch = None
    if inst.get("patch_b64") is not None:
        try:
            raw = base64.b64decode(inst["patch_b64"], validate=True)
        except (binascii.Error, TypeError) as e:
            raise BadInstance(f"patch_b64 is not valid base64: {e}")
        if len(raw) != _PATCH_BYTES:
            raise BadInstance(
                f"patch_b64 must decode to {_PATCH_BYTES} bytes "
                f"(uint8{list(PATCH_SHAPE)}), got {len(raw)}")
        patch = np.frombuffer(raw, np.uint8).reshape(PATCH_SHAPE)
    return {"user_text": user, "item_text": item, "patch": patch}


class _Pending:
    __slots__ = ("instance", "event", "result", "error")

    def __init__(self, instance: Dict[str, Any]):
        self.instance = instance
        self.event = threading.Event()
        self.result: Optional[Dict[str, float]] = None
        self.error: Optional[str] = None


class MicroBatcher:
    """Coalesces concurrently-submitted instances into fixed-shape device
    batches.  One dispatcher thread; the forward never runs concurrently
    with itself, so there is exactly one in-flight device batch (queueing a
    second buys nothing and doubles peak memory)."""

    def __init__(self, predictor, max_wait_ms: float = 5.0):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stopped = False
        # serializes submit vs close: without it a submit could pass the
        # stopped check, get descheduled across close()'s whole drain, and
        # enqueue into a dead queue — waiting out the full request timeout
        self._submit_lock = threading.Lock()
        self.batches_run = 0
        self.instances_run = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def submit(self, instance: Dict[str, Any]) -> _Pending:
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("MicroBatcher is closed")
            p = _Pending(instance)
            self._q.put(p)
            return p

    def close(self) -> None:
        with self._submit_lock:
            self._stopped = True
            self._q.put(None)
        self._thread.join(timeout=10)
        # items enqueued before the sentinel that the dispatcher did not
        # reach would otherwise wait out the full request timeout
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.error = "server shutting down"
                p.event.set()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        cap = self.predictor.batch_size
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            deadline = time.monotonic() + self.max_wait
            while len(group) < cap:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                else:
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                if nxt is None:
                    self._score(group)
                    return
                group.append(nxt)
            self._score(group)

    def _score(self, group: List[_Pending]) -> None:
        try:
            users = [g.instance["user_text"] for g in group]
            items = [g.instance["item_text"] for g in group]
            patches = np.stack([
                g.instance["patch"] if g.instance["patch"] is not None
                else np.zeros(PATCH_SHAPE, np.uint8) for g in group])
            has_image = np.asarray(
                [int(g.instance["patch"] is not None) for g in group],
                np.int32)
            out = self.predictor.predict(users, items, patches, has_image)
            for i, g in enumerate(group):
                g.result = {"prob_good": float(out["prob_good"][i]),
                            "prob_best": float(out["prob_best"][i])}
            self.batches_run += 1
            self.instances_run += len(group)
        except Exception as e:  # pragma: no cover - surfaced as HTTP 500
            for g in group:
                g.error = f"{type(e).__name__}: {e}"
        finally:
            for g in group:
                g.event.set()


class _Handler(BaseHTTPRequestHandler):
    server_version = "mmoe-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    # silence the default per-request stderr lines
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def app(self) -> "PredictionServer":
        return self.server.app  # type: ignore[attr-defined]

    def _json(self, code: int, payload: Dict) -> None:
        if code >= 400:
            # error paths may leave request-body bytes unread (e.g. the
            # 413 reject), which would desync HTTP/1.1 keep-alive — drop
            # the connection instead
            self.close_connection = True
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        if self.path == "/healthz":
            self._json(200, self.app.health())
        elif self.path == "/varz":
            self._json(200, self.app.stats())
        else:
            self._json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self) -> None:
        if self.path != "/v1/predict":
            self._json(404, {"error": f"no route {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length > self.app.max_body_bytes:
                self._json(413, {"error": f"body too large ({length} > "
                                          f"{self.app.max_body_bytes})"})
                return
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"invalid JSON body: {e}"})
            return
        instances = body.get("instances")
        if not isinstance(instances, list) or not instances:
            self._json(400, {"error": "body needs a non-empty 'instances' list"})
            return
        t0 = time.monotonic()
        try:
            parsed = [_parse_instance(i) for i in instances]
        except BadInstance as e:
            self._json(400, {"error": str(e)})
            return
        try:
            pendings = [self.app.batcher.submit(p) for p in parsed]
        except RuntimeError:
            self._json(503, {"error": "server shutting down"})
            return
        # ONE deadline for the whole request, not per-instance (k
        # sequential waits would multiply the worst-case latency by k)
        deadline = time.monotonic() + self.app.request_timeout_s
        for p in pendings:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not p.event.wait(timeout=remaining):
                self._json(504, {"error": "prediction timed out"})
                return
        errors = [p.error for p in pendings if p.error]
        if errors:
            self._json(500, {"error": errors[0]})
            return
        self.app.record_latency(time.monotonic() - t0)
        self._json(200, {"predictions": [p.result for p in pendings]})


class PredictionServer:
    def __init__(self, predictor, host: str = "0.0.0.0", port: int = 8000,
                 max_wait_ms: float = 5.0, request_timeout_s: float = 60.0,
                 model_info: Optional[Dict] = None,
                 max_body_bytes: int = 64 << 20):
        self.predictor = predictor
        self.max_body_bytes = max_body_bytes
        self.batcher = MicroBatcher(predictor, max_wait_ms)
        self.request_timeout_s = request_timeout_s
        self.model_info = model_info or {}
        self._lat_lock = threading.Lock()
        self._latencies: List[float] = []   # ring, last 1024
        self.requests = 0
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.app = self  # type: ignore[attr-defined]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self.requests += 1
            self._latencies.append(seconds)
            if len(self._latencies) > 1024:
                del self._latencies[:512]

    def health(self) -> Dict:
        return {"status": "ok", "batch_size": self.predictor.batch_size,
                **self.model_info}

    def stats(self) -> Dict:
        with self._lat_lock:
            lats = sorted(self._latencies)
        q = (lambda f: lats[min(len(lats) - 1, int(f * len(lats)))]
             if lats else None)
        return {"requests": self.requests,
                "instances": self.batcher.instances_run,
                "device_batches": self.batcher.batches_run,
                "mean_batch_fill": (self.batcher.instances_run
                                    / max(1, self.batcher.batches_run)),
                "latency_s": {"p50": q(0.50), "p90": q(0.90),
                              "p99": q(0.99)}}

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
