"""The serving front door: an HTTP transport over the fleet (the port of
deep_vision_tpu/serve/transport.py).

Everything below this module speaks Futures; everything above it speaks
HTTP. One `Transport` binds a stdlib `ThreadingHTTPServer` (daemon
handler threads, port 0 picks a free port) in front of any backend
exposing `submit(model, image, deadline_ms=) -> Future` — a
`serve.Server`, a `ReplicaPool`, or a `ProcReplicaPool` — and turns
in-process verdicts into status codes a client can act on:

    POST /v1/<model>      body {"image": [...]}  ->  200 + outputs
    POST /control/<verb>  a fleet parent's verb on a replica (promote)
    GET  /healthz         readiness (503 while draining)
    GET  /ledgerz         the transport request ledger (JSON)
    GET  /statusz         the ledger and the backend's counts and status

The status-code contract:

    429  ShedError(rate_limited)          + Retry-After
    503  ShedError(queue_full|draining),  + Retry-After
         ServerClosed, ReplicaLost, no serving replicas
    504  deadline shed — at ADMISSION (the X-DVT-Deadline-Ms budget is
         already spent on arrival) or at DISPATCH (it expired while the
         request sat queued; serve/router.py refuses to execute it)
    400  undecodable body / wrong shape   404  unknown model/route

Deadlines are enforced twice: the front door sheds a request whose
budget is spent before admission sees it, and the remaining budget
rides into `submit(deadline_ms=...)` so the dispatcher sheds it again
at batch pickup if queueing ate the rest.

The W3C `traceparent` rides the wire: an inbound header becomes the
parent of this hop's context (obs/propagate.py), the backend's submit
runs under it, the journal row carries its ids, and the response
echoes this hop's context.

The wire format is the reference's: JSON with the image as nested
lists, and outputs as nested lists (`_jsonable_outputs`: a dict, a
tuple or list, or one array, the forms the Server answers).

Fault point `serve.transport` (resilience/faults.py): `io_error` tears
the connection mid-frame (no response bytes; exactly one request
fails and the acceptor thread lives), `corrupt` mangles the request
body (a 400), `crash` SIGKILLs the serving process (the procpool
respawn path). Journal events: `transport_server{host,port,outcome}` on
start/stop/fail, `transport_request{status,deadline_ms,outcome}` per
request (the reference's schemas, tools/check_journal.py --strict).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from deep_vision_tpu_torch.core import knobs
from deep_vision_tpu_torch.obs import locksmith, propagate
from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.serve.admission import ShedError
from deep_vision_tpu_torch.serve.engine import ServeError
from deep_vision_tpu_torch.serve.queue import DeadlineExceeded, QueueClosed

__all__ = ["Transport", "TransportError", "DEADLINE_HEADER",
           "STATUS_BY_REASON", "TRANSPORT_OUTCOMES",
           "TRANSPORT_SERVER_OUTCOMES"]

#: the client's remaining budget in milliseconds, measured at SEND time
DEADLINE_HEADER = "X-DVT-Deadline-Ms"

#: ShedError reason -> status. 429 is "you, specifically, are over
#: budget" (token bucket); 503 is "the service, as a whole, cannot take
#: this right now" (bounded queue, drain) — both carry Retry-After.
STATUS_BY_REASON = {"rate_limited": 429, "queue_full": 503,
                    "draining": 503}

#: `transport_request` outcome enum (check_journal --strict pins it)
TRANSPORT_OUTCOMES = ("ok", "error", "shed", "deadline", "bad_request",
                      "torn")

#: `transport_server` outcome enum (the reference's lifecycle verdicts)
TRANSPORT_SERVER_OUTCOMES = ("started", "stopped", "failed")


class TransportError(RuntimeError):
    """Transport lifecycle misuse (start twice, bind failure wrapper)."""


class Transport:
    """HTTP edge over one serving backend.

    Wire-up::

        tp = Transport(pool, journal=journal, registry=registry)
        tp.start()                       # binds 127.0.0.1:0, journals port
        ... clients POST /v1/<model> ...
        tp.close()

    The backend contract is three callables, all optional but the
    first: `submit(model, image, deadline_ms=) -> Future`,
    `healthz() -> (ok, detail)`, and — only when `admission` is given —
    `queue_depth(model) -> int` feeds the admission verdict. Backends
    that run their own admission (`ReplicaPool`) just raise `ShedError`
    from submit; the mapping below is the same either way.
    """

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 journal=None, registry=None, admission=None,
                 models: Optional[Sequence[str]] = None,
                 queue_depth: Optional[Callable[[str], int]] = None,
                 default_deadline_ms: Optional[float] = None,
                 retry_after_ms: Optional[float] = None,
                 result_timeout_s: float = 60.0,
                 controls: Optional[Dict[str, Callable[[dict],
                                                       dict]]] = None):
        self.backend = backend
        self.journal = journal
        self.admission = admission
        # the control plane (POST /control/<name>): named host-side
        # verbs a fleet parent drives on its replica processes (weight
        # promote, drain) — separate from the request ledger, which
        # counts user traffic only
        self.controls: Dict[str, Callable[[dict], dict]] = \
            dict(controls or {})
        self._models = tuple(models) if models is not None else None
        if queue_depth is None and hasattr(backend, "queue_depth"):
            queue_depth = backend.queue_depth  # the admission input most
            # backends already expose (Server, ProcReplicaPool)
        self._queue_depth = queue_depth
        self._want_host = host
        self._want_port = int(port)
        self.default_deadline_ms = float(
            knobs.get_float("DVT_TRANSPORT_DEADLINE_MS")
            if default_deadline_ms is None else default_deadline_ms)
        self.retry_after_ms = float(
            knobs.get_float("DVT_TRANSPORT_RETRY_AFTER_MS")
            if retry_after_ms is None else retry_after_ms)
        self.result_timeout_s = float(result_timeout_s)
        if registry is None:
            from deep_vision_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self.registry = registry
        # the edge ledger: every offered request lands in exactly one
        # bucket, so offered == ok + error + shed + deadline + bad +
        # torn holds at any instant the lock is not held mid-increment
        self._lock = locksmith.lock("serve.transport")
        self.counts: Dict[str, int] = {
            "offered": 0, "ok": 0, "error": 0, "shed": 0, "deadline": 0,
            "bad_request": 0, "torn": 0}
        self.by_status: Dict[int, int] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def add_control(self, name: str, fn: Callable[[dict], dict]) -> None:
        """Register/replace a control verb (idempotent by name)."""
        self.controls[str(name)] = fn

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def address(self) -> Optional[str]:
        return f"{self._want_host}:{self.port}" if self._httpd else None

    def start(self) -> "Transport":
        if self._httpd is not None:
            return self
        try:
            httpd = ThreadingHTTPServer(
                (self._want_host, self._want_port), _Handler)
        except OSError as e:
            self._journal_server("failed", port=self._want_port,
                                 error=f"{type(e).__name__}: {e}")
            raise
        httpd.daemon_threads = True
        httpd.transport = self  # the handlers' way back to this object
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="serve-transport",
            daemon=True)
        self._thread.start()
        self._journal_server("started", port=self.port)
        return self

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        port = httpd.server_address[1]
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._journal_server("stopped", port=port)

    def _journal_server(self, outcome: str, port: int, **extra) -> None:
        assert outcome in TRANSPORT_SERVER_OUTCOMES
        if self.journal is not None:
            self.journal.write("transport_server", host=self._want_host,
                               port=int(port), outcome=outcome, **extra)

    # -- ledger ------------------------------------------------------------

    def ledger(self) -> dict:
        """One consistent snapshot; `balanced` is the fleet-edge
        invariant offered == ok + error + shed + deadline + bad + torn
        the smoke asserts across client, server, and journal."""
        with self._lock:
            counts = dict(self.counts)
            by_status = dict(self.by_status)
        counts["by_status"] = {str(k): v
                               for k, v in sorted(by_status.items())}
        counts["balanced"] = counts["offered"] == sum(
            counts[k] for k in ("ok", "error", "shed", "deadline",
                                "bad_request", "torn"))
        return counts

    def _account(self, outcome: str, status: int) -> None:
        with self._lock:
            self.counts[outcome] += 1
            self.by_status[status] = self.by_status.get(status, 0) + 1
        self.registry.counter(
            "transport_requests_total", "front-door requests by status",
            labels={"status": str(status)}).inc()

    # -- request handling (called from handler threads) --------------------

    def healthz(self):
        if self._closed or self._httpd is None:
            return False, {"draining": True}
        fn = getattr(self.backend, "healthz", None)
        if callable(fn):
            return fn()
        return True, {}

    def known_models(self) -> Optional[Sequence[str]]:
        if self._models is not None:
            return self._models
        eng = getattr(self.backend, "engine", None)
        if eng is None:
            fn = getattr(self.backend, "primary_engine", None)
            if callable(fn):
                try:
                    eng = fn()
                except Exception:
                    return None
        return getattr(eng, "models", None)

    def handle_request(self, model: str, body: bytes,
                       deadline_hdr: Optional[str],
                       traceparent: Optional[str]) -> "_Reply":
        """The whole front-door verdict for one POST, transport-neutral
        (the HTTP handler frames it; tests call it directly). Returns a
        `_Reply`; `outcome == "torn"` means write NOTHING and drop the
        connection."""
        t0 = time.perf_counter()
        with self._lock:
            self.counts["offered"] += 1
        # the frame boundary: io_error = the connection resets mid-frame
        # (one torn request, no response bytes, the acceptor thread
        # lives), crash = the serving process dies here, corrupt =
        # the body arrives mangled and must fail THIS request as a 400
        try:
            faults.fire("serve.transport")
        except faults.FaultInjected:
            return self._reply(None, 0, "torn", t0, 0.0,
                               error="injected connection reset")
        body = faults.transform("serve.transport", body)
        # inbound context: the wire's traceparent parents this hop
        parent = propagate.from_traceparent(traceparent) \
            if traceparent else None
        ctx = parent.child() if parent is not None else \
            propagate.new_trace()
        deadline_ms: Optional[float] = None
        if deadline_hdr is not None and str(deadline_hdr).strip():
            try:
                deadline_ms = float(deadline_hdr)
            except ValueError:
                return self._reply(
                    ctx, 400, "bad_request", t0, 0.0,
                    error=f"unparseable {DEADLINE_HEADER}: "
                          f"{deadline_hdr!r}")
        elif self.default_deadline_ms > 0:
            deadline_ms = self.default_deadline_ms
        known = self.known_models()
        if known is not None and model not in known:
            return self._reply(ctx, 404, "bad_request", t0, deadline_ms,
                               error=f"unknown model {model!r}")
        try:
            image = self._decode(body)
        except (ValueError, TypeError) as e:
            return self._reply(ctx, 400, "bad_request", t0, deadline_ms,
                               error=f"{type(e).__name__}: {e}")
        # deadline check ONE, at admission: a budget spent in flight
        # (or by the corrupt-frame read above) sheds before any queue
        # or token bucket is consulted — never execute, never admit
        remaining_ms = None
        if deadline_ms is not None:
            remaining_ms = deadline_ms - (time.perf_counter() - t0) * 1e3
            if remaining_ms <= 0:
                return self._reply(ctx, 504, "deadline", t0, deadline_ms,
                                   stage="admission")
        if self.admission is not None:
            depth = self._queue_depth(model) if self._queue_depth else 0
            reason = self.admission.admit(model, depth)
            if reason is not None:
                return self._shed_reply(ctx, reason, t0, deadline_ms)
        try:
            with propagate.use(ctx):
                fut = self.backend.submit(model, image,
                                          deadline_ms=remaining_ms)
        except ShedError as e:
            return self._shed_reply(ctx, e.reason, t0, deadline_ms)
        except QueueClosed:
            return self._shed_reply(ctx, "draining", t0, deadline_ms)
        except ServeError as e:
            # "no serving replicas" — a fleet failure, not a policy
            # verdict: 503 + Retry-After, the respawn will land shortly
            return self._reply(ctx, 503, "error", t0, deadline_ms,
                               error=f"{type(e).__name__}: {e}",
                               retry_after=True)
        timeout_s = self.result_timeout_s if remaining_ms is None \
            else remaining_ms / 1e3 + 10.0
        try:
            row = fut.result(timeout=timeout_s)
        except DeadlineExceeded:
            # deadline check TWO fired, at dispatch (serve/router.py):
            # the budget died in the queue, the request never executed
            return self._reply(ctx, 504, "deadline", t0, deadline_ms,
                               stage="dispatch")
        except ShedError as e:
            return self._shed_reply(ctx, e.reason, t0, deadline_ms)
        except TimeoutError:
            fut.cancel()
            return self._reply(ctx, 500, "error", t0, deadline_ms,
                               error="result timeout")
        except Exception as e:
            # typed, retryable process death (ReplicaLost) and drain
            # races answer 503 + Retry-After; everything else is a 500
            name = type(e).__name__
            retryable = name in ("ReplicaLost", "ServerClosed",
                                 "QueueClosed")
            return self._reply(ctx, 503 if retryable else 500, "error",
                               t0, deadline_ms, error=f"{name}: {e}",
                               retry_after=retryable)
        latency_ms = (time.perf_counter() - t0) * 1e3
        body_out = {"model": model,
                    "latency_ms": round(latency_ms, 3),
                    "outputs": _jsonable_outputs(row)}
        return self._finish(ctx, 200, "ok", t0, deadline_ms,
                            body=body_out)

    @staticmethod
    def _decode(body: bytes):
        obj = json.loads(body.decode("utf-8"))
        if not isinstance(obj, dict) or "image" not in obj:
            raise ValueError("request body must be a JSON object with "
                             "an 'image' field")
        return np.asarray(obj["image"], dtype=np.float32)

    def _shed_reply(self, ctx, reason: str, t0: float,
                    deadline_ms: Optional[float]) -> "_Reply":
        status = STATUS_BY_REASON.get(reason, 503)
        return self._reply(ctx, status, "shed", t0, deadline_ms,
                           reason=reason, retry_after=True)

    def _reply(self, ctx, status: int, outcome: str, t0: float,
               deadline_ms: Optional[float], reason: Optional[str] = None,
               stage: Optional[str] = None, error: Optional[str] = None,
               retry_after: bool = False) -> "_Reply":
        body = {"error": outcome, "status": status,
                "retryable": bool(retry_after)}
        if reason:
            body["reason"] = reason
        if stage:
            body["stage"] = stage
        if error:
            body["detail"] = error[:200]
        extra = {}
        if reason:
            extra["reason"] = reason
        if stage:
            extra["stage"] = stage
        if error:
            extra["error"] = error[:200]
        return self._finish(ctx, status, outcome, t0, deadline_ms,
                            body=body, retry_after=retry_after, **extra)

    def _finish(self, ctx, status: int, outcome: str, t0: float,
                deadline_ms: Optional[float], body: dict,
                retry_after: bool = False, **extra) -> "_Reply":
        assert outcome in TRANSPORT_OUTCOMES
        latency_ms = (time.perf_counter() - t0) * 1e3
        self._account(outcome, status)
        if self.journal is not None:
            if ctx is not None:
                extra.update(ctx.fields())
            self.journal.write(
                "transport_request", status=int(status),
                deadline_ms=round(float(deadline_ms or 0.0), 3),
                outcome=outcome, latency_ms=round(latency_ms, 3), **extra)
        headers = {}
        if ctx is not None:
            headers["traceparent"] = ctx.to_traceparent()
        if retry_after:
            headers["Retry-After"] = f"{self.retry_after_ms / 1e3:.3f}"
        return _Reply(status, outcome, body, headers)


class _Reply:
    """One framed verdict: status + JSON body + extra headers.
    `outcome == "torn"` instructs the handler to write nothing."""

    __slots__ = ("status", "outcome", "body", "headers")

    def __init__(self, status: int, outcome: str, body: dict,
                 headers: Dict[str, str]):
        self.status = status
        self.outcome = outcome
        self.body = body
        self.headers = headers


def _jsonable_outputs(row):
    """One output row (a dict, a tuple or list, or one array or
    tensor) -> JSON-shippable nested lists."""
    if isinstance(row, dict):
        return {str(k): _jsonable_outputs(v) for k, v in row.items()}
    if isinstance(row, (list, tuple)):
        return [_jsonable_outputs(v) for v in row]
    tolist = getattr(row, "tolist", None)
    if callable(tolist):
        return tolist()
    if isinstance(row, (int, float, str, bool)) or row is None:
        return row
    return repr(row)


class _Handler(BaseHTTPRequestHandler):
    """Route table. POST bodies are length-framed (Content-Length);
    handler threads are daemons (ThreadingHTTPServer), so one slow or
    torn request never blocks accept()."""

    server_version = "dvt-transport/1"
    protocol_version = "HTTP/1.1"

    def do_POST(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        tp: Transport = self.server.transport
        route = self.path.rstrip("/")
        if route.startswith("/control/"):
            self._do_control(tp, route[len("/control/"):])
            return
        if not route.startswith("/v1/"):
            with tp._lock:
                tp.counts["offered"] += 1
            tp._account("bad_request", 404)
            self._send_json(404, {"error": "bad_request",
                                  "detail": f"no such route: {route}"})
            return
        model = route[len("/v1/"):]
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
        except (OSError, ValueError):
            with tp._lock:
                tp.counts["offered"] += 1
            tp._account("torn", 0)
            self.close_connection = True
            return
        try:
            reply = tp.handle_request(
                model, body, self.headers.get(DEADLINE_HEADER),
                self.headers.get("traceparent"))
        except Exception as e:
            # last-resort guard: a transport bug answers 500 for THIS
            # request; it must never wedge or kill the acceptor
            tp._account("error", 500)
            try:
                self._send_json(500, {"error": "error",
                                      "detail": f"{type(e).__name__}: {e}"})
            except Exception:
                pass
            return
        if reply.outcome == "torn":
            # mid-frame reset: no status line, no body — the client
            # sees the connection die exactly as a real reset looks
            self.close_connection = True
            try:
                self.wfile.flush()
            except Exception:
                pass
            return
        try:
            self._send_json(reply.status, reply.body,
                            extra=reply.headers)
        except Exception:
            pass  # client went away mid-response: its request, its loss

    def _do_control(self, tp: Transport, name: str) -> None:
        """Control-plane verbs: off the request ledger (they are fleet
        operations, not user traffic), 404 on unknown names so a typo'd
        parent fails loudly."""
        fn = tp.controls.get(name)
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length).decode("utf-8")) \
                if length else {}
        except (OSError, ValueError):
            self._send_json(400, {"error": "bad_request",
                                  "detail": "undecodable control payload"})
            return
        if fn is None:
            self._send_json(404, {"error": "bad_request",
                                  "detail": f"no such control: {name}"})
            return
        try:
            self._send_json(200, {"ok": True, **(fn(payload) or {})})
        except Exception as e:
            try:
                self._send_json(500, {"ok": False, "error":
                                      f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    def do_GET(self):  # noqa: N802
        tp: Transport = self.server.transport
        route = self.path.rstrip("/") or "/"
        try:
            if route == "/healthz":
                ok, detail = tp.healthz()
                self._send_json(200 if ok else 503,
                                {"ok": bool(ok), **dict(detail or {})})
            elif route == "/ledgerz":
                self._send_json(200, tp.ledger())
            elif route == "/statusz":
                body = {"ledger": tp.ledger()}
                for attr in ("counts", "telemetry_status"):
                    fn = getattr(tp.backend, attr, None)
                    if callable(fn):
                        try:
                            body[attr] = fn()
                        except Exception as e:
                            body[attr] = {"error":
                                          f"{type(e).__name__}: {e}"}
                self._send_json(200, body)
            elif route == "/":
                self._send_json(200, {"endpoints":
                                      ["/v1/<model> (POST)", "/healthz",
                                       "/ledgerz", "/statusz"]})
            else:
                self._send_json(404, {"error": "bad_request",
                                      "detail": f"no such page: {route}"})
        except Exception as e:
            try:
                self._send_json(500, {"error": "error",
                                      "detail": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    def _send_json(self, code: int, obj,
                   extra: Optional[Dict[str, str]] = None) -> None:
        data = (json.dumps(obj, default=repr) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass
