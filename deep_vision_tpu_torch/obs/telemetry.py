"""Live telemetry plane: per-process HTTP /metrics, /varz, /healthz,
/statusz and /alertz (the port of deep_vision_tpu/obs/telemetry.py).

The `TelemetryServer` is a stdlib `http.server` on a daemon thread
inside a process that wants to be watched (the Trainer and train_cli,
a serving Server or ReplicaPool), serving:

    GET /metrics   Prometheus text exposition (Registry.to_prometheus)
    GET /varz      JSON metrics snapshot (Registry.snapshot)
    GET /healthz   200/503 readiness verdict over pluggable health
                   sources (a HealthMonitor's latch, a Server's drain
                   state, the fleet's serving replicas, ...)
    GET /statusz   JSON (or ?format=html) status page: the run's
                   manifest, each status source's section (step and
                   epoch, step-time quantiles, replica states), the
                   executable cache's excache_* ledger from the
                   registry, and the last journal rows of the flight
                   recorder's ring
    GET /alertz    JSON state of an attached alert engine (set_alerts):
                   active alerts, history, rule inventory; empty lists
                   with no engine, which is every process until the
                   alert plane is ported

Discovery: the server binds port 0 by default, journals the bound port
as a typed `telemetry_server` event (`started`, `stopped`, `failed`),
and writes a discovery file `telemetry-<role>-<pid>.json` under the run
dir, which `read_discovery` and tools/obs_poll.py read.

Contracts:
- nothing here touches a device: every handler reads host-side state
  (registry objects, copies of the journal ring, plain callables), so a
  scrape never holds a lock across a device fence or forces a sync;
- telemetry degrades, never kills the run it observes: a raising
  status or health source renders as an error entry (and turns /healthz
  to 503: a probe that cannot be evaluated is not a passing one), never
  a 500 of the whole page;
- registration is idempotent by name, so a respawned serving replica
  takes over its dead predecessor's slot and the endpoint survives.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from deep_vision_tpu_torch.obs import locksmith

__all__ = ["TelemetryServer", "TELEMETRY_OUTCOMES", "validate_prometheus",
           "read_discovery"]

# outcomes of the typed `telemetry_server` journal event, the ones
# tools/check_journal.py accepts (tests/test_torch_telemetry.py holds the
# three lists equal)
TELEMETRY_OUTCOMES = ("started", "stopped", "failed")

DISCOVERY_PREFIX = "telemetry-"

# a health source: () -> (ok, detail-dict); a status source: () -> dict
HealthSource = Callable[[], Tuple[bool, dict]]
StatusSource = Callable[[], dict]


class TelemetryServer:
    """One process's live observability endpoint.

    Construction wires what exists; anything absent just leaves its
    section empty (a data worker has no flight recorder, a bare test
    has no journal). `start()` binds and journals; `close()` is
    idempotent and removes the discovery file.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 role: str = "process", registry=None, journal=None,
                 flight=None, discovery_dir: Optional[str] = None,
                 tail_n: int = 32):
        self.role = str(role)
        self.registry = registry
        self.journal = journal
        self.flight = flight
        self.discovery_dir = discovery_dir
        self.tail_n = int(tail_n)
        self._want_host = host
        self._want_port = int(port)
        # sources are registered from trainer/pool/service threads and
        # read from handler threads — locksmith-named like every other
        # cross-thread obs structure
        self._lock = locksmith.lock("obs.telemetry")
        self._health: Dict[str, HealthSource] = {}
        self._status: Dict[str, StatusSource] = {}
        self._alerts = None  # AlertEngine (obs/alerts.py) via set_alerts
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._discovery_path: Optional[str] = None
        self._t_start: Optional[float] = None
        self._closed = False

    # -- registration (idempotent by name) --------------------------------

    def add_health(self, name: str, fn: HealthSource) -> None:
        """Register/replace a readiness probe. Replacing is the respawn
        story: a fresh replica (or a fresh HealthMonitor after an
        aborted run) takes over its predecessor's slot by name."""
        with self._lock:
            self._health[str(name)] = fn

    def add_status(self, name: str, fn: StatusSource) -> None:
        with self._lock:
            self._status[str(name)] = fn

    def remove(self, name: str) -> None:
        with self._lock:
            self._health.pop(str(name), None)
            self._status.pop(str(name), None)

    def set_alerts(self, engine) -> None:
        """Attach an obs/alerts.py AlertEngine: `/alertz` serves its
        state, and the "alerts" health source fails while any
        page-severity alert is firing — a burning error budget flips
        /healthz exactly like a failing readiness probe. Idempotent by
        the same replace-on-respawn story as add_health."""
        with self._lock:
            self._alerts = engine
        self.add_health("alerts", self._alerts_health)

    def _alerts_health(self) -> Tuple[bool, dict]:
        with self._lock:
            engine = self._alerts
        if engine is None:
            return True, {"active": 0}
        active = engine.active()
        paging = [a["rule"] for a in active
                  if a.get("severity") == "page"]
        return (not paging,
                {"active": len(active), "paging": paging})

    def alertz(self) -> dict:
        """The /alertz body: the engine's event-time state (active
        alerts, fired->resolved history, rule inventory). An endpoint
        with no engine answers with empty lists — pollable either way."""
        with self._lock:
            engine = self._alerts
        if engine is None:
            return {"now": None, "active": [], "history": [], "rules": []}
        return _jsonable(engine.alertz())

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def host(self) -> str:
        return self._want_host

    @property
    def address(self) -> Optional[str]:
        return f"{self.host}:{self.port}" if self._httpd else None

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        try:
            httpd = ThreadingHTTPServer(
                (self._want_host, self._want_port), _Handler)
        except OSError as e:
            self._journal_event("failed", port=self._want_port,
                               error=f"{type(e).__name__}: {e}")
            raise
        httpd.daemon_threads = True
        httpd.telemetry = self  # handler backref
        self._httpd = httpd
        self._t_start = time.time()
        self._thread = threading.Thread(
            target=httpd.serve_forever, name=f"telemetry-{self.role}",
            daemon=True)
        self._thread.start()
        self._journal_event("started", port=self.port)
        self._write_discovery()
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
        if self._discovery_path:
            try:
                os.remove(self._discovery_path)
            except OSError:
                pass
        self._journal_event("stopped", port=port)

    def _journal_event(self, outcome: str, port: int, **extra) -> None:
        assert outcome in TELEMETRY_OUTCOMES
        if self.journal is not None:
            self.journal.write("telemetry_server", host=self._want_host,
                               port=int(port), outcome=outcome,
                               role=self.role, pid=os.getpid(), **extra)

    def _write_discovery(self) -> None:
        if not self.discovery_dir:
            return
        try:
            os.makedirs(self.discovery_dir, exist_ok=True)
            path = os.path.join(
                self.discovery_dir,
                f"{DISCOVERY_PREFIX}{self.role}-{os.getpid()}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"host": self.host, "port": self.port,
                           "pid": os.getpid(), "role": self.role,
                           "run_id": getattr(self.journal, "run_id", None),
                           "ts": time.time()}, f)
            os.replace(tmp, path)
            self._discovery_path = path
        except OSError:
            # telemetry degrades: the endpoint still answers, it is
            # just not discoverable from the run dir
            self._discovery_path = None

    # -- endpoint bodies (called from handler threads) ---------------------

    def metrics_text(self) -> str:
        if self.registry is None:
            return ""
        return self.registry.to_prometheus()

    def varz(self) -> dict:
        return self.registry.snapshot() if self.registry is not None else {}

    def healthz(self) -> Tuple[bool, dict]:
        """Aggregate verdict: every registered source must pass. A
        source that raises counts as failing — an unevaluable probe is
        not a passing probe."""
        with self._lock:
            sources = list(self._health.items())
        checks: Dict[str, dict] = {}
        ok_all = True
        for name, fn in sources:
            try:
                ok, detail = fn()
                entry = dict(detail or {})
                entry["ok"] = bool(ok)
            except Exception as e:
                entry = {"ok": False,
                         "error": f"{type(e).__name__}: {e}"}
            checks[name] = entry
            ok_all = ok_all and entry["ok"]
        return ok_all, {"ok": ok_all, "role": self.role, "checks": checks}

    def statusz(self) -> dict:
        with self._lock:
            sources = list(self._status.items())
        status: Dict[str, dict] = {}
        for name, fn in sources:
            try:
                status[name] = _jsonable(fn())
            except Exception as e:
                status[name] = {"error": f"{type(e).__name__}: {e}"}
        ok, health = self.healthz()
        out = {
            "role": self.role,
            "pid": os.getpid(),
            "address": self.address,
            "run_id": getattr(self.journal, "run_id", None),
            "uptime_s": (round(time.time() - self._t_start, 3)
                         if self._t_start else None),
            "healthy": ok,
            "health": health,
            "status": status,
            "excache": self._excache_ledger(),
            "manifest": self._manifest(),
            "recent_events": self._recent_events(),
        }
        return out

    def _manifest(self) -> Optional[dict]:
        fn = getattr(self.journal, "manifest_row", None)
        return fn() if callable(fn) else None

    def _excache_ledger(self) -> dict:
        """The executable-cache hit ledger, pulled from the registry by
        name — the cache reports there already, so statusz needs no
        direct handle on the cache object."""
        if self.registry is None:
            return {}
        snap = self.registry.snapshot()
        return {k: v for k, v in snap.items() if k.startswith("excache_")}

    def _recent_events(self) -> List[dict]:
        if self.flight is None:
            return []
        tail = getattr(self.flight, "tail", None)
        if not callable(tail):
            return []
        try:
            return [_jsonable(r) for r in tail(self.tail_n)]
        except Exception:
            return []


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        if isinstance(v, dict):
            return {str(k): _jsonable(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_jsonable(x) for x in v]
        return repr(v)


class _Handler(BaseHTTPRequestHandler):
    """Route table for the endpoints. Every handler body reads host-side
    state only: no tensor read, no device sync, no blocking on the
    training loop."""

    server_version = "dvt-telemetry/1"
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        tele: TelemetryServer = self.server.telemetry
        parsed = urlparse(self.path)
        route = parsed.path.rstrip("/") or "/"
        try:
            if route == "/metrics":
                self._send(200, "text/plain; version=0.0.4",
                           tele.metrics_text())
            elif route == "/varz":
                self._send_json(200, tele.varz())
            elif route == "/healthz":
                ok, body = tele.healthz()
                self._send_json(200 if ok else 503, body)
            elif route == "/alertz":
                self._send_json(200, tele.alertz())
            elif route == "/statusz":
                body = tele.statusz()
                fmt = parse_qs(parsed.query).get("format", ["json"])[0]
                if fmt == "html":
                    self._send(200, "text/html; charset=utf-8",
                               _statusz_html(body))
                else:
                    self._send_json(200, body)
            elif route == "/":
                self._send(200, "text/plain",
                           "endpoints: /metrics /varz /healthz /statusz "
                           "/alertz\n")
            else:
                self._send(404, "text/plain", f"no such page: {route}\n")
        except Exception as e:
            # last-resort guard: a handler bug must answer 500, not
            # wedge the client or kill the serving thread
            try:
                self._send(500, "text/plain",
                           f"telemetry error: {type(e).__name__}: {e}\n")
            except Exception:
                pass

    def _send(self, code: int, ctype: str, body: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, "application/json",
                   json.dumps(obj, indent=1, default=repr) + "\n")

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


def _statusz_html(body: dict) -> str:
    """Minimal human view: headings + pre-formatted JSON per section.
    Operators curl the JSON; the HTML exists for a browser glance."""
    verdict = "HEALTHY" if body.get("healthy") else "UNHEALTHY"
    color = "#2a7" if body.get("healthy") else "#c33"
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>statusz — {body.get('role')}</title></head>",
        "<body style='font-family:monospace'>",
        f"<h1>{body.get('role')} @ {body.get('address')} "
        f"<span style='color:{color}'>[{verdict}]</span></h1>",
        f"<p>pid {body.get('pid')} · run {body.get('run_id')} · "
        f"up {body.get('uptime_s')}s</p>",
    ]
    for section in ("status", "health", "excache", "manifest",
                    "recent_events"):
        parts.append(f"<h2>{section}</h2><pre>"
                     + _escape(json.dumps(body.get(section), indent=1,
                                          default=repr))
                     + "</pre>")
    parts.append("</body></html>")
    return "".join(parts)


def _escape(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


# -- Prometheus text validation (shared by the tests and chip_smoke.py) ------

_PROM_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")
_PROM_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}


def validate_prometheus(text: str) -> List[str]:
    """Sanity-check Prometheus text exposition format. Returns a list
    of problems (empty = parses). Not a full spec parser — it enforces
    what our exporter promises: well-formed sample lines with numeric
    values, known TYPE tokens, and family lines contiguous under one
    TYPE block (the spec forbids interleaving)."""
    problems: List[str] = []
    typed: Dict[str, str] = {}
    seen_families: List[str] = []
    current_family: Optional[str] = None
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            bits = line.split(None, 3)
            if len(bits) < 4 or bits[3] not in _PROM_TYPES:
                problems.append(f"line {i}: bad TYPE line: {line!r}")
                continue
            family = bits[2]
            if family in typed:
                problems.append(
                    f"line {i}: duplicate TYPE for family {family!r} "
                    "(families must be contiguous)")
            typed[family] = bits[3]
            seen_families.append(family)
            current_family = family
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        value = line.rsplit(" ", 1)[1]
        if value not in ("NaN", "+Inf", "-Inf"):
            try:
                float(value)
            except ValueError:
                problems.append(f"line {i}: non-numeric value {value!r}")
        base = current_family
        if base is None or not name.startswith(base):
            problems.append(
                f"line {i}: sample {name!r} outside its family's TYPE "
                f"block (current family: {base!r})")
    return problems


def read_discovery(run_dir: str) -> List[dict]:
    """Parse every discovery file under `run_dir` (non-recursive).
    Unreadable/garbled files are skipped — a process that died mid-write
    must not break discovery of its siblings."""
    out: List[dict] = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(DISCOVERY_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(run_dir, name)) as f:
                row = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(row, dict) and row.get("port"):
            row["discovery_file"] = name
            out.append(row)
    return out
