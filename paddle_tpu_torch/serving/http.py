"""Thin stdlib HTTP front end over the ServingEngine.

Counterpart of ``paddle_tpu/serving/http.py``: the same routes, bodies
and typed-error statuses.

Deliberately ThreadingHTTPServer, not a framework: the container ships
no web dependencies, and the engine already does the hard part — each
handler thread blocks on its request's Future while the dispatcher
coalesces across ALL handler threads, so concurrency here is free
batching there. One handler thread per in-flight request is exactly the
concurrency model the micro-batcher wants.

Routes (JSON in/out):

    POST /v1/models/<name>:predict   {"feeds": {name: nested-list},
                                      "deadline_ms": optional}
         -> {"fetches": {name: {"data","shape","dtype"}}, "model_version"}
    POST /v1/models/<name>:generate  {"prompt_ids": [ints],
                                      "max_new_tokens", "deadline_ms",
                                      "priority", "eos_id",
                                      "stream": bool (default true)}
         stream=true  -> chunked application/x-ndjson: one
                         {"token": t, "index": i} line per generated
                         token, then {"done": true, "tokens": [...],
                         "finish_reason": ...}
         stream=false -> one JSON body with the final result
    POST /v1/models/<name>:reload    {"model_dir": path} -> {"version": N}
    GET  /v1/models                  registry description
    GET  /v1/fleet                   fleet-tier status (replica health,
                                     queue depths per class, autoscaler
                                     state) — 404 on a single engine
    GET  /v1/metrics                 metrics snapshot (JSON)
    GET  /v1/metrics?format=prometheus
         (also /metrics)             Prometheus text exposition of the
                                     same snapshot — both serving planes
                                     (one-shot + decode) in one scrape

The same server fronts a fleet router (serving/fleet/FleetRouter) —
anything with the engine surface plus `is_fleet` serves the extra
tier: requests may carry a `priority` field (body) and an
`X-PT-Session` affinity header, so a session keeps hitting the replica
that holds its paged KV blocks, and paid-tier traffic classes ahead of
free-tier in the fleet queue.

Typed serving errors map to their http_status (429 Overloaded, 504
DeadlineExceeded, 404 ModelUnavailable, 400 InvalidRequest, 500
RequestFailed) with a JSON body naming the error type, so clients can
key retry policy off the type exactly like in-process callers do
(admission.retryable). A fleet Overloaded response body additionally
carries `shed_class` — which priority class was shed. A typed error
that fires MID-STREAM (a sequence shed after its first tokens went out)
arrives as a terminal {"error": type, "message": ...} NDJSON line — the
status line already shipped, so the error type rides in-band.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..obs import trace as obs_trace
from .admission import InvalidRequest, ServingError
from .metrics import render_prometheus

__all__ = ["make_server", "start_http_server"]


class _Handler(BaseHTTPRequestHandler):
    # the engine rides on the server object (make_server sets it)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # tests must stay quiet
        pass

    # -- helpers -------------------------------------------------------------
    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_typed(self, exc: BaseException) -> None:
        status = getattr(exc, "http_status", 500)
        body = {"error": type(exc).__name__, "message": str(exc)}
        if getattr(exc, "shed_class", None) is not None:
            body["shed_class"] = exc.shed_class
        self._send(status, body)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(n) if n else b""
        if not raw:
            return {}
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise InvalidRequest(f"request body is not JSON: {e}") from e
        if not isinstance(body, dict):
            raise InvalidRequest("request body must be a JSON object")
        return body

    def _model_route(self, suffix: str) -> Optional[Tuple[str, str]]:
        prefix = "/v1/models/"
        if not self.path.startswith(prefix) or \
                not self.path.endswith(suffix):
            return None
        name = self.path[len(prefix):-len(suffix)]
        return (name, suffix) if name else None

    # -- routes --------------------------------------------------------------
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        engine = self.server.engine
        split = urllib.parse.urlsplit(self.path)
        query = urllib.parse.parse_qs(split.query)
        try:
            if split.path == "/v1/models":
                self._send(200, {"models": engine.models()})
            elif split.path == "/v1/fleet":
                if getattr(engine, "is_fleet", False):
                    self._send(200, engine.status())
                else:
                    self._send(404, {"error": "NotFound",
                                     "message": "no fleet tier — this "
                                     "is a single serving engine"})
            elif split.path in ("/v1/metrics", "/metrics"):
                if query.get("format", [""])[0] == "prometheus":
                    body = render_prometheus(
                        engine.metrics_snapshot()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(200, engine.metrics_snapshot())
            else:
                self._send(404, {"error": "NotFound",
                                 "message": self.path})
        except Exception as e:  # noqa: BLE001 — typed error boundary
            self._send_error_typed(e)

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        engine = self.server.engine
        try:
            route = self._model_route(":predict")
            if route is not None:
                return self._predict(engine, route[0])
            route = self._model_route(":generate")
            if route is not None:
                return self._generate(engine, route[0])
            route = self._model_route(":reload")
            if route is not None:
                body = self._read_json()
                model_dir = body.get("model_dir")
                if not model_dir:
                    raise InvalidRequest("reload needs {'model_dir': …}")
                ver = engine.load_model(route[0], model_dir,
                                        version=body.get("version"))
                return self._send(200, {"model": route[0],
                                        "version": ver})
            self._send(404, {"error": "NotFound", "message": self.path})
        except ServingError as e:
            self._send_error_typed(e)
        except Exception as e:  # noqa: BLE001 — boundary: never a 200
            self._send_error_typed(e)

    def _predict(self, engine, name: str) -> None:
        # the ingress span is the request's trace ROOT: engine.submit
        # runs on this handler thread, so the batcher's Request captures
        # this context and the dispatcher parents the queue/batch spans
        # under it — "why was this request slow" reads as one trace
        with obs_trace.span("http_request", cat="serve",
                            route="predict", model=name):
            body = self._read_json()
            feeds_in = body.get("feeds")
            if not isinstance(feeds_in, dict) or not feeds_in:
                raise InvalidRequest(
                    "predict needs {'feeds': {name: value}}")
            fleet = getattr(engine, "is_fleet", False)
            if fleet:
                # one catalog walk for both (ModelUnavailable -> 404,
                # reject-fast — parity with the single-engine branch)
                dtypes, version = engine.model_info(name)
            else:
                # one routing read, public surface only
                # (ModelUnavailable -> 404)
                model = engine.registry.get(name).model
                # dtype-faithful conversion: the model's feed dtypes
                # win over whatever JSON number type the client sent
                dtypes = model.feed_dtypes()
                version = model.version
            feeds = {}
            for k, v in feeds_in.items():
                try:
                    feeds[k] = (np.asarray(v, dtype=dtypes[k])
                                if k in dtypes else np.asarray(v))
                except (TypeError, ValueError) as e:
                    raise InvalidRequest(
                        f"feed {k!r} is not coercible: {e}") from e
            if fleet:
                # the router-level surface: priority classes the fleet
                # queue serves weighted-fair, and a session key that
                # pins this client to its affine replica
                try:
                    priority = int(body.get("priority") or 0)
                except (TypeError, ValueError) as e:
                    raise InvalidRequest(
                        f"priority {body.get('priority')!r} is not an "
                        "integer class") from e
                fut = engine.submit(
                    name, feeds, priority=priority,
                    session=self.headers.get("X-PT-Session"),
                    deadline_ms=body.get("deadline_ms"))
            else:
                fut = engine.submit(name, feeds,
                                    deadline_ms=body.get("deadline_ms"))
            result = fut.result()   # engine deadline machinery bounds this
            fetches = {
                k: {"data": v.tolist(), "shape": list(v.shape),
                    "dtype": v.dtype.name}
                for k, v in result.items()}
            self._send(200, {"fetches": fetches,
                             "model_version": version})

    def _generate(self, engine, name: str) -> None:
        body = self._read_json()
        prompt = body.get("prompt_ids")
        if not isinstance(prompt, list) or not prompt:
            raise InvalidRequest(
                "generate needs {'prompt_ids': [int, ...]}")
        kw = {}
        for key in ("max_new_tokens", "deadline_ms", "priority",
                    "eos_id"):
            if body.get(key) is not None:
                kw[key] = body[key]
        # typed admission errors raise BEFORE any response bytes -> they
        # map to their status like every other route. The ingress span
        # roots the request's trace: the decode scheduler parents its
        # prefill/decode/evict/resume events under this context. For
        # non-streaming requests it also covers the result() wait (the
        # full wall time, like _predict); a streaming response's span
        # necessarily closes at submit — its duration lives in the
        # scheduler's per-sequence events instead.
        if getattr(engine, "is_fleet", False):
            # decode sessions are stateful (paged KV blocks live on ONE
            # replica): the affinity header keeps a session's turns on
            # the replica that holds them
            session = self.headers.get("X-PT-Session")
            if session is not None:
                kw["session"] = session
        with obs_trace.span("http_request", cat="serve",
                            route="generate", model=name):
            handle = engine.generate(name, prompt, **kw)
            if not body.get("stream", True):
                result = handle.result()
                return self._send(200, result)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(payload: dict) -> None:
            data = (json.dumps(payload) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data
                             + b"\r\n")
            self.wfile.flush()

        try:
            i = 0
            for tok in handle.stream():
                chunk({"token": int(tok), "index": i})
                i += 1
            result = handle.result()
            result["done"] = True
            chunk(result)
        except OSError:
            # client hung up mid-stream: the status line already went
            # out, so nothing more may be written to this socket (a
            # second status line would be protocol garbage) — close
            self.close_connection = True
            return
        except Exception as e:  # noqa: BLE001 — in-band terminal error
            try:
                chunk({"error": type(e).__name__, "message": str(e)})
            except OSError:
                self.close_connection = True
                return
        try:
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            self.close_connection = True


def make_server(engine, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server; `server.engine` is set.
    port=0 binds an ephemeral port (tests)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.engine = engine
    return server


def start_http_server(engine, host: str = "127.0.0.1", port: int = 0):
    """Start serving on a daemon thread. Returns (server, thread); stop
    with server.shutdown()."""
    server = make_server(engine, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="pt-serve-http")
    thread.start()
    return server, thread
