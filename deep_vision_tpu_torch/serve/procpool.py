"""ProcReplicaPool: the serving fleet as processes, not threads (the port
of deep_vision_tpu/serve/procpool.py).

serve/pool.py's replicas share one interpreter. This module runs each
replica as a spawned PROCESS with its own warmed Engine, so a death is a
real SIGKILL, a weight swap crosses a process boundary and a shed is a
real 429:

- each replica child runs `_replica_main`: join the serving generation
  through `resilience/rendezvous.py` first (a member lease and its
  heartbeat; the first cohort forms the generation with `join`, a
  respawn re-enters it with `attach`), then build the engine from a
  picklable builder, warm it, start a `serve.Server` and its own
  `serve/transport.py` endpoint on 127.0.0.1:0, and write a ready file;
  on SIGTERM it drains and leaves the generation;
- the parent routes requests to the replicas over their sockets
  (`submit(model, image, deadline_ms=) -> Future`, the ReplicaPool
  contract, so one Transport fronts either), with admission at the
  parent edge and the W3C traceparent on every proxied hop;
- death is seen twice: connection loss at request time (the dead
  process's in-flight requests, and only those, fail with a typed,
  retryable `ReplicaLost`) and, in the monitor thread, waitpid or an
  expired lease (a hung process stops heartbeating before it stops
  holding its socket). Either way the pool journals `replica_lost`,
  spawns a fresh process under the same rid (attempt + 1) and journals
  `replica_recovered` with the child's warm-up report;
- `SwapController` drives a canary across processes unchanged: the
  parent holds a warmed template engine (`primary_engine()`), the
  shadow's weights go to a spawned canary process as CPU tensors in a
  `torch.save` file under the run dir, `promote_variables` POSTs
  `/control/promote` to every base replica (each applies them with
  `Engine.set_variables`: no warm-up, no kernel build), and
  `remove_canary` drains the canary process.

The parent's ledger holds `accepted == completed + errors + cancelled`
with sheds and refusals beside it (`ledger()`); each child holds the
same at its own edge.

Where the port differs from the reference:

- the builder is `builder(journal=, registry=, **builder_kwargs) ->
  Engine`; the device is one of `builder_kwargs` (the builders default
  to the card and raise without one);
- `excache_dir=` is the port's executable cache (core/excache.py) over
  its compiled libraries, not over executables: the parent and every
  child attach an ExecutableCache there (core/build.py `attach_cache`)
  before their builder runs, so whatever library a process loads comes
  from the cache or is compiled into it. A child's warm-up report gives
  the compiler runs (`backend_compiles`) and cache loads
  (`cache_hits`) of its whole process up to ready: over a warm cache,
  0 and one a library it loaded. The parent's template warms first, so
  over an empty cache it pays the compiler and the children load;
  without a cache a child compiles nothing either when the libraries are
  built already in build/ (its `cache_hits` is then 0);
- a canary process runs `health_policy="abort"`, as the in-process
  pool's canary does, so weights that give non-finite outputs become
  request errors the swap's verdict counts (the reference's process
  canary keeps the "warn" default and ships them as answers);
- a connection loss marks a replica dead only if the request was
  routed to the incarnation that is still current (attempt-scoped), so
  a late failure of the old process cannot kill its respawn; and a
  replica declared dead by its lease while its process lives is killed
  before the respawn, so no rid ever has two processes;
- canaries get rids of their own (`canary1`, `canary2`, ...), so each
  writes a journal of its own;
- a child points its standard output at its standard error: its
  prints never land among the parent's lines;
- a started pool not drained by its owner is drained at interpreter
  exit: otherwise its monitor would respawn the children that
  multiprocessing terminates at exit, and the exit would wait on them.
"""
from __future__ import annotations

import atexit
import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from deep_vision_tpu_torch.obs import locksmith, propagate
from deep_vision_tpu_torch.serve.admission import ShedError
from deep_vision_tpu_torch.serve.engine import Engine, ServeError
from deep_vision_tpu_torch.serve.pool import ReplicaLost
from deep_vision_tpu_torch.serve.queue import DeadlineExceeded
from deep_vision_tpu_torch.serve.slo import SLOTracker

READY_SUFFIX = ".ready.json"

#: a replica process's lifecycle states (warming is seen only as the
#: ready-file wait)
PROC_STATES = ("spawning", "serving", "draining", "dead")


def _atomic_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _save_variables(variables_by_model: dict, path: str) -> None:
    """{model: {name: tensor}} -> a torch.save file of CPU tensors (what
    a child loads whatever its device)."""
    import torch

    torch.save({m: {k: v.detach().cpu() for k, v in sd.items()}
                for m, sd in variables_by_model.items()}, path)


def _apply_variables(engine: Engine, path: str) -> List[str]:
    """Load a `_save_variables` file into `engine`'s registered models
    (Engine.set_variables moves them to its device). -> models set."""
    import torch

    variables_by_model = torch.load(path, map_location="cpu",
                                    weights_only=True)
    swapped = []
    for name, variables in variables_by_model.items():
        if name in engine.models:
            engine.set_variables(name, variables)
            swapped.append(name)
    return sorted(swapped)


def _warmup_report(stats: dict, builds: int, loads: int) -> dict:
    return {"models": stats["models"], "pairs": stats["pairs"],
            "backend_compiles": int(builds), "cache_hits": int(loads)}


def _attach_cache(excache_dir: Optional[str], journal, registry) -> None:
    """Attach an ExecutableCache over `excache_dir` to this process."""
    if excache_dir:
        from deep_vision_tpu_torch.core import build
        from deep_vision_tpu_torch.core.excache import ExecutableCache

        build.attach_cache(ExecutableCache(excache_dir, journal=journal,
                                           registry=registry))


# -- the child process ---------------------------------------------------------

def _replica_main(spec: dict) -> None:
    """Entry point of one replica process (the spawn target; all it needs
    rides the picklable `spec`): an engine, a Server, a Transport and a
    membership lease, drained on SIGTERM."""
    # the parent owns standard output; a child's prints go to stderr
    sys.stdout.flush()
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    rid = spec["rid"]
    run_dir = spec["run_dir"]
    # membership first (stdlib only): the lease must exist while the
    # child pays its torch import and warm-up, or the parent would read
    # a slow warm-up as a corpse
    from deep_vision_tpu_torch.resilience.rendezvous import Rendezvous

    rdzv = Rendezvous(spec["rdzv_root"], host=rid,
                      heartbeat_s=spec["heartbeat_s"])
    try:
        if spec["generation"] is None:
            view = rdzv.join(expect_hosts=spec["expect_hosts"],
                             timeout_s=60.0)
        else:
            view = rdzv.attach(generation=spec["generation"],
                               timeout_s=60.0)
    except Exception:
        rdzv.leave()
        raise
    from deep_vision_tpu_torch.core import build
    from deep_vision_tpu_torch.obs.journal import RunJournal
    from deep_vision_tpu_torch.obs.registry import Registry
    from deep_vision_tpu_torch.serve.router import Server
    from deep_vision_tpu_torch.serve.transport import Transport

    registry = Registry()
    journal = RunJournal(os.path.join(
        run_dir, f"replica-{rid}-a{spec['attempt']}.jsonl"), kind="serve")
    journal.manifest(config={"replica": rid, "attempt": spec["attempt"]})
    _attach_cache(spec["excache_dir"], journal, registry)
    engine = spec["builder"](journal=journal, registry=registry,
                             **spec["builder_kwargs"])
    stats = engine.warmup()
    if spec["variables_path"]:
        # a canary (or a respawn after a promote) serves the shipped
        # weights, through the same set_variables a live promote uses
        _apply_variables(engine, spec["variables_path"])
    server = Server(engine, journal=journal, registry=registry,
                    max_wait_ms=spec["max_wait_ms"], slo_ms=spec["slo_ms"],
                    health_policy=spec["health_policy"],
                    tags={"replica": rid}).start()
    backend = _ChildBackend(server)
    transport = Transport(backend, port=0, journal=journal,
                          registry=registry,
                          controls={"promote": backend.promote}).start()
    _atomic_json(os.path.join(run_dir, f"replica-{rid}{READY_SUFFIX}"), {
        "rid": rid, "attempt": spec["attempt"], "pid": os.getpid(),
        "port": transport.port, "generation": view.generation,
        "warmup": _warmup_report(stats, build.build_count(),
                                 build.cache_load_count()),
        "ts": time.time(),
    })
    server.install_sigterm()
    server.wait_for_stop()
    # SIGTERM: flush in-flight, then drop the lease cleanly so the
    # monitor sees a departure, not a corpse
    transport.close()
    server.drain("sigterm")
    rdzv.leave()
    journal.close()


class _ChildBackend:
    """The replica child's view of its own Server: fires the
    `serve.replica` fault at the request boundary (the `crash` kind kills
    this process) and hosts the promote control verb."""

    def __init__(self, server):
        self.server = server
        self.engine = server.engine

    def submit(self, model, image, deadline_ms=None):
        from deep_vision_tpu_torch.resilience import faults

        faults.fire("serve.replica")
        return self.server.submit(model, image, deadline_ms=deadline_ms)

    def healthz(self):
        return self.server.healthz()

    def queue_depth(self, model):
        return self.server.queue_depth(model)

    def counts(self):
        return self.server.counts()

    def telemetry_status(self):
        return self.server.telemetry_status()

    def promote(self, payload: dict) -> dict:
        """POST /control/promote {"path": <torch.save file>}: set the
        shipped weights into this process's engine (no warm-up, no
        kernel build: Engine.set_variables)."""
        return {"models": _apply_variables(self.engine, payload["path"])}


# -- the parent-side pool ------------------------------------------------------

class _ProcSlot:
    """Parent-side record of one replica process."""

    __slots__ = ("rid", "proc", "port", "attempt", "state", "warmup",
                 "canary", "completed", "errors", "latencies_by_model",
                 "generation")

    def __init__(self, rid: str, canary: bool = False):
        self.rid = rid
        self.proc = None
        self.port: Optional[int] = None
        self.attempt = 0
        self.state = "spawning"
        self.warmup: Optional[dict] = None
        self.canary = canary
        self.completed = 0
        self.errors = 0
        self.latencies_by_model: Dict[str, List[float]] = {}
        self.generation: Optional[int] = None


class ProcReplicaPool:
    """N replica PROCESSES behind one submit() — the ReplicaPool contract
    over sockets.

        pool = ProcReplicaPool(builder, replicas=2, run_dir=run_dir,
                               journal=journal,
                               admission=AdmissionController(...))
        pool.start()                      # template, spawn, wait ready
        fut = pool.submit("toy", image)   # proxied over HTTP
        ...
        pool.drain("close")               # SIGTERM children, fold ledgers

    `builder(journal=, registry=, **builder_kwargs) -> Engine` (unwarmed)
    must be a MODULE-LEVEL callable (spawn pickles it by reference). The
    parent calls it too, for the warmed template engine: it builds the
    CUDA kernels before any child starts (a child then builds none) and
    gives SwapController its `primary_engine()`. With `excache_dir`, the
    parent and every child load their libraries through an executable
    cache there (one cache a process: a parent with another attached
    raises).
    """

    def __init__(self, builder: Callable, replicas: int = 2,
                 run_dir: str = ".", excache_dir: Optional[str] = None,
                 journal=None, registry=None, admission=None,
                 builder_kwargs: Optional[dict] = None,
                 slo_ms: Optional[float] = None,
                 max_wait_ms: float = 2.0,
                 heartbeat_s: float = 0.5,
                 ready_timeout_s: float = 90.0,
                 max_respawns: int = 2,
                 monitor_poll_s: float = 0.25,
                 request_timeout_s: float = 30.0,
                 max_inflight: int = 64):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.builder = builder
        self.excache_dir = excache_dir
        self.builder_kwargs = dict(builder_kwargs or {})
        self.n_replicas = int(replicas)
        self.run_dir = run_dir
        self.rdzv_root = os.path.join(run_dir, "rdzv")
        self.journal = journal
        self.admission = admission
        self.slo_ms = slo_ms
        self.max_wait_ms = float(max_wait_ms)
        self.heartbeat_s = float(heartbeat_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.max_respawns = int(max_respawns)
        self.monitor_poll_s = float(monitor_poll_s)
        self.request_timeout_s = float(request_timeout_s)
        if registry is None:
            from deep_vision_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self.registry = registry
        self.slo = SLOTracker(registry=registry, slo_ms=slo_ms)
        self._lock = locksmith.lock("serve.procpool")
        self._slots: Dict[str, _ProcSlot] = {}
        self._canary: Optional[_ProcSlot] = None
        self._canary_pct = 0
        self._canary_gen = 0
        self._rr = 0
        self._seq = 0
        self.accepted = 0
        self.completed = 0
        self.errors = 0
        self.cancelled = 0
        self.sheds = 0
        self.refused = 0
        self._started = False
        self._draining = False
        self._drain_summary: Optional[dict] = None
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=int(max_inflight), thread_name_prefix="procpool")
        self._template: Optional[Engine] = None
        self.template_warmup: Optional[dict] = None
        self._promoted_path: Optional[str] = None
        # a read-only rendezvous handle: the parent never writes a member
        # lease, it reads the children's
        from deep_vision_tpu_torch.resilience.rendezvous import Rendezvous

        self._rdzv = Rendezvous(self.rdzv_root, host="fleet-parent",
                                heartbeat_s=self.heartbeat_s)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ProcReplicaPool":
        if self._started:
            return self
        from deep_vision_tpu_torch.core import build

        os.makedirs(self.rdzv_root, exist_ok=True)
        # the template warms FIRST: its warm-up builds (or loads from the
        # cache) every library the model runs, so no child races the
        # compiler
        _attach_cache(self.excache_dir, self.journal, self.registry)
        builds, loads = build.build_count(), build.cache_load_count()
        self._template = self.builder(journal=self.journal,
                                      registry=self.registry,
                                      **self.builder_kwargs)
        stats = self._template.warmup()
        self.template_warmup = _warmup_report(
            stats, build.build_count() - builds,
            build.cache_load_count() - loads)
        for i in range(self.n_replicas):
            slot = _ProcSlot(f"p{i}")
            self._slots[slot.rid] = slot
            self._spawn(slot, generation=None)
        deadline = time.monotonic() + self.ready_timeout_s
        for slot in self._slots.values():
            self._wait_ready(slot, deadline)
        self._started = True
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="procpool-monitor",
                                         daemon=True)
        self._monitor.start()
        atexit.register(self.drain, "close")
        return self

    def _spawn(self, slot: _ProcSlot, generation: Optional[int],
               variables_path: Optional[str] = None) -> None:
        import multiprocessing as mp

        slot.attempt += 1
        slot.state = "spawning"
        slot.port = None
        # a stale ready file of the previous incarnation must never be
        # taken for the new one's
        try:
            os.remove(self._ready_path(slot.rid))
        except OSError:
            pass
        spec = {
            "rid": slot.rid, "attempt": slot.attempt,
            "run_dir": self.run_dir, "rdzv_root": self.rdzv_root,
            "excache_dir": self.excache_dir,
            "builder": self.builder, "builder_kwargs": self.builder_kwargs,
            "heartbeat_s": self.heartbeat_s,
            "expect_hosts": self.n_replicas, "generation": generation,
            "slo_ms": self.slo_ms, "max_wait_ms": self.max_wait_ms,
            "health_policy": "warn",
            "variables_path": variables_path or self._promoted_path,
        }
        if slot.canary:
            # a canary never joins the base generation: it forms a
            # one-member world under a root of its own (in the shared
            # root it would wait for a resize the base fleet never runs)
            spec.update(generation=None, expect_hosts=1,
                        health_policy="abort",
                        rdzv_root=f"{self.rdzv_root}-{slot.rid}")
            os.makedirs(spec["rdzv_root"], exist_ok=True)
        ctx = mp.get_context("spawn")
        slot.proc = ctx.Process(target=_replica_main, args=(spec,),
                                name=f"replica-{slot.rid}", daemon=True)
        slot.proc.start()

    def _ready_path(self, rid: str) -> str:
        return os.path.join(self.run_dir, f"replica-{rid}{READY_SUFFIX}")

    def _wait_ready(self, slot: _ProcSlot, deadline: float) -> None:
        path = self._ready_path(slot.rid)
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                rec = None
            if rec and rec.get("attempt") == slot.attempt:
                slot.port = int(rec["port"])
                slot.warmup = rec.get("warmup")
                slot.generation = rec.get("generation")
                slot.state = "serving"
                return
            if slot.proc is not None and not slot.proc.is_alive():
                raise ServeError(
                    f"replica {slot.rid} died during warmup "
                    f"(exitcode={slot.proc.exitcode})")
            time.sleep(0.05)
        raise ServeError(
            f"replica {slot.rid} not ready within "
            f"{self.ready_timeout_s:.0f}s")

    # -- request path ------------------------------------------------------

    def submit(self, model: str, image,
               deadline_ms: Optional[float] = None) -> Future:
        """Admit at the parent edge, pick a replica, proxy over its
        socket. ShedError is synchronous (no Future on a shed, the
        ReplicaPool contract); everything request-scoped, a SIGKILLed
        replica mid-request included, comes back on the Future."""
        if not self._started:
            raise ServeError("submit() before start(): no replicas are up")
        self.slo.offered(model)
        with self._lock:
            if self._draining:
                reason: Optional[str] = "draining"
            elif self.admission is not None:
                reason = self.admission.admit(
                    model, self._pool._work_queue.qsize())
            else:
                reason = None
            slot = None if reason is not None else self._route()
            if reason is None and slot is None:
                self.refused += 1
            if slot is not None:
                self.accepted += 1
                attempt = slot.attempt
        if reason is not None:
            self.sheds += 1
            self.slo.shed(model, reason)
            if self.journal is not None:
                self.journal.write("serve_shed", model=model, reason=reason)
            raise ShedError(model, reason)
        if slot is None:
            self.slo.refused(model)
            raise ServeError(
                f"no serving replicas for {model!r} "
                f"({self.replica_states()})")
        fut: Future = Future()
        self._pool.submit(self._proxy_call, slot, attempt, model, image,
                          deadline_ms, propagate.current(), fut,
                          time.perf_counter())
        return fut

    def _route(self) -> Optional[_ProcSlot]:
        """Round-robin over serving base replicas; the canary takes its
        diverted percentage first ((seq * pct) % 100 < pct spreads the
        diverted requests evenly through the stream). The caller holds
        the lock."""
        self._seq += 1
        if (self._canary is not None and self._canary.state == "serving"
                and self._canary_pct > 0
                and (self._seq * self._canary_pct) % 100 < self._canary_pct):
            return self._canary
        serving = [s for s in self._slots.values()
                   if s.state == "serving" and not s.canary]
        if not serving:
            return None
        self._rr = (self._rr + 1) % len(serving)
        return serving[self._rr]

    def _proxy_call(self, slot: _ProcSlot, attempt: int, model: str, image,
                    deadline_ms: Optional[float], ctx, fut: Future,
                    t0: float) -> None:
        """One proxied request on a worker thread; resolves `fut` with the
        child's answer or the typed failure: the child's HTTP verdict
        maps back onto the exceptions in-process callers handle."""
        if not fut.set_running_or_notify_cancel():
            self._account(slot, model, "cancelled", t0)
            return
        try:
            row = self._http_infer(slot, model, image, deadline_ms, ctx)
        except Exception as e:
            self._account(slot, model, "error", t0)
            fut.set_exception(e)
            if isinstance(e, ReplicaLost):
                self._suspect(slot, attempt)
            return
        self._account(slot, model, "ok", t0)
        fut.set_result(row)

    def _account(self, slot: _ProcSlot, model: str, outcome: str,
                 t0: float) -> None:
        latency_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            if outcome == "ok":
                self.completed += 1
                slot.completed += 1
                slot.latencies_by_model.setdefault(model, []).append(
                    latency_ms)
            elif outcome == "cancelled":
                self.cancelled += 1
            else:
                self.errors += 1
                slot.errors += 1
        self.slo.request_done(model, latency_ms, outcome)

    def _http_infer(self, slot: _ProcSlot, model: str, image,
                    deadline_ms: Optional[float], ctx):
        body = json.dumps(
            {"image": image.tolist() if hasattr(image, "tolist")
             else image}).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if deadline_ms is not None:
            headers["X-DVT-Deadline-Ms"] = f"{deadline_ms:.3f}"
        if ctx is not None:
            headers["traceparent"] = ctx.to_traceparent()
        conn = http.client.HTTPConnection(
            "127.0.0.1", slot.port, timeout=self.request_timeout_s)
        try:
            try:
                conn.request("POST", f"/v1/{model}", body=body,
                             headers=headers)
                resp = conn.getresponse()
                payload = json.loads(resp.read().decode("utf-8"))
            except (OSError, http.client.HTTPException, ValueError) as e:
                # connection loss IS the death signal for in-flight
                # requests: typed, retryable, scoped to this request
                raise ReplicaLost(
                    f"replica {slot.rid} connection lost mid-request "
                    f"({type(e).__name__}: {e})")
            if resp.status == 200:
                return payload.get("outputs", payload)
            reason = payload.get("reason")
            if resp.status in (429, 503) and reason:
                raise ShedError(model, reason)
            if resp.status == 504:
                raise DeadlineExceeded(
                    f"deadline shed at {payload.get('stage', '?')} on "
                    f"replica {slot.rid}")
            raise ServeError(
                f"replica {slot.rid} answered {resp.status}: "
                f"{payload.get('detail', payload)}")
        finally:
            conn.close()

    # -- death detection + respawn ----------------------------------------

    def _suspect(self, slot: _ProcSlot, attempt: int) -> None:
        """Request-path death report (connection loss): take the slot out
        of the routing set now, if the request went to the incarnation
        still serving; the monitor confirms and respawns."""
        with self._lock:
            if slot.state == "serving" and slot.attempt == attempt:
                slot.state = "dead"

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitor_poll_s):
            for slot in list(self._slots.values()):
                if slot.state not in ("serving", "dead"):
                    continue
                dead = slot.state == "dead"
                if not dead and slot.proc is not None \
                        and not slot.proc.is_alive():
                    dead = True  # waitpid: connection loss's parent-side
                    # twin
                if not dead:
                    gap = self._rdzv.lease_gap(slot.rid)
                    if gap is not None and gap > self._rdzv.lease_s:
                        dead = True  # lease expiry: a HUNG process stops
                        # heartbeating long before it stops holding its
                        # socket open
                if not dead:
                    continue
                with self._lock:
                    slot.state = "dead"
                self._handle_lost(slot)
            if self._draining:
                return

    def _handle_lost(self, slot: _ProcSlot) -> None:
        if self.journal is not None:
            self.journal.write("replica_lost", replica=slot.rid,
                               attempt=slot.attempt)
        self.registry.counter("serve_replica_lost_total",
                              "replica processes lost",
                              labels={"replica": slot.rid}).inc()
        proc = slot.proc
        if proc is not None and proc.is_alive():
            proc.kill()  # a hung process: its lease expired
            proc.join(timeout=5.0)
        if slot.canary or self._draining \
                or slot.attempt > self.max_respawns:
            return
        try:
            self._spawn(slot, generation=slot.generation)
            self._wait_ready(slot,
                             time.monotonic() + self.ready_timeout_s)
        except Exception as e:
            with self._lock:
                slot.state = "dead"
            if self.journal is not None:
                self.journal.write("note", note="respawn_failed",
                                   replica=slot.rid,
                                   error=f"{type(e).__name__}: {e}"[:200])
            return
        if self.journal is not None:
            self.journal.write("replica_recovered", replica=slot.rid,
                               attempt=slot.attempt, **(slot.warmup or {}))

    # -- fleet introspection ----------------------------------------------

    def primary_engine(self) -> Engine:
        """The parent's warmed template engine: SwapController's
        reference for variable checks, shadow cloning and probes."""
        if self._template is None:
            raise ServeError("primary_engine() before start()")
        return self._template

    def replica_states(self) -> Dict[str, str]:
        with self._lock:
            out = {rid: s.state for rid, s in self._slots.items()}
            if self._canary is not None:
                out[self._canary.rid] = self._canary.state
            return out

    def warmup_stats(self) -> Dict[str, dict]:
        """Each replica's warm-up report from its ready file."""
        with self._lock:
            return {rid: dict(s.warmup or {})
                    for rid, s in self._slots.items()}

    def healthz(self):
        states = self.replica_states()
        serving = sum(1 for s in states.values() if s == "serving")
        ok = self._started and not self._draining and serving > 0
        return ok, {"replicas": states, "serving": serving,
                    "draining": self._draining}

    def telemetry_status(self) -> dict:
        out = dict(self.counts())
        out["sheds"] = self.sheds
        out["refused"] = self.refused
        out["replicas"] = self.replica_states()
        out["slo"] = self.slo.report()
        return out

    def counts(self) -> dict:
        with self._lock:
            return {"accepted": self.accepted, "completed": self.completed,
                    "errors": self.errors, "cancelled": self.cancelled}

    def ledger(self) -> dict:
        """The fleet ledger and its invariant: every offered request is
        accepted, shed or refused, and every accepted one lands in
        exactly one of completed/errors/cancelled."""
        with self._lock:
            counts = {"accepted": self.accepted,
                      "completed": self.completed, "errors": self.errors,
                      "cancelled": self.cancelled, "shed": self.sheds,
                      "refused": self.refused}
        counts["pending"] = (counts["accepted"] - counts["completed"]
                             - counts["errors"] - counts["cancelled"])
        counts["balanced"] = counts["pending"] >= 0
        return counts

    def queue_depth(self, model: str) -> int:
        """Admission input when a Transport fronts this pool directly:
        the parent's backlog of proxied requests not yet sent."""
        return self._pool._work_queue.qsize()

    # -- canary swap across processes (SwapController's surface) -----------

    def add_canary(self, engine: Engine, pct: int) -> str:
        """Mount a canary PROCESS serving `engine`'s weights for `pct`% of
        traffic. The engine is the SwapController's shadow (parent-side);
        its variables go to the spawned child in a torch.save file under
        the run dir."""
        if not 0 < pct <= 100:
            raise ValueError(f"canary pct must be in (0, 100], got {pct}")
        with self._lock:
            if self._canary is not None:
                raise ServeError("a canary is already mounted")
            self._canary_gen += 1
            slot = _ProcSlot(f"canary{self._canary_gen}", canary=True)
        path = os.path.join(self.run_dir, f"{slot.rid}-variables.pt")
        _save_variables({name: engine.entry(name).variables
                         for name in engine.models}, path)
        self._spawn(slot, generation=None, variables_path=path)
        self._wait_ready(slot, time.monotonic() + self.ready_timeout_s)
        with self._lock:
            self._canary = slot
            self._canary_pct = int(pct)
        return slot.rid

    def canary_status(self) -> Optional[dict]:
        with self._lock:
            slot = self._canary
        if slot is None:
            return None
        state = slot.state
        if slot.proc is not None and not slot.proc.is_alive():
            state = "dead"
        with self._lock:
            lat = {m: sorted(v)
                   for m, v in slot.latencies_by_model.items()}
            out = {"replica": slot.rid, "state": state,
                   "accepted": slot.completed + slot.errors,
                   "completed": slot.completed, "errors": slot.errors,
                   "cancelled": 0}
        out["slo"] = {
            m: {"p99_ms": v[min(len(v) - 1, int(0.99 * len(v)))]}
            for m, v in lat.items() if v}
        return out

    def remove_canary(self) -> Optional[dict]:
        with self._lock:
            slot, self._canary = self._canary, None
            self._canary_pct = 0
        if slot is None:
            return None
        slot.state = "draining"
        summary = self._terminate(slot)
        slot.state = "dead"
        return summary

    def promote_variables(self, variables_by_model: dict) -> None:
        """Ship the new weights to every base replica process (POST
        /control/promote -> Engine.set_variables) and to the parent's
        template; a replica respawned later loads the same file, so the
        promoted weights survive process death."""
        path = os.path.join(self.run_dir, "promoted-variables.pt")
        _save_variables(variables_by_model, path)
        self._promoted_path = path
        for name, variables in variables_by_model.items():
            self._template.set_variables(name, variables)
        failures = []
        with self._lock:
            slots = [s for s in self._slots.values()
                     if s.state == "serving"]
        for slot in slots:
            try:
                self._control(slot, "promote", {"path": path})
            except Exception as e:
                failures.append(f"{slot.rid}: {type(e).__name__}: {e}")
        if failures:
            raise ServeError(
                f"promote failed on {len(failures)} replica(s): "
                + "; ".join(failures))

    def _control(self, slot: _ProcSlot, verb: str, payload: dict) -> dict:
        conn = http.client.HTTPConnection(
            "127.0.0.1", slot.port, timeout=self.request_timeout_s)
        try:
            conn.request("POST", f"/control/{verb}",
                         body=json.dumps(payload).encode("utf-8"),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read().decode("utf-8"))
            if resp.status != 200 or not out.get("ok"):
                raise ServeError(
                    f"control {verb} on {slot.rid} answered "
                    f"{resp.status}: {out}")
            return out
        finally:
            conn.close()

    # -- drain / shutdown --------------------------------------------------

    def _terminate(self, slot: _ProcSlot,
                   timeout_s: float = 15.0) -> Optional[dict]:
        """SIGTERM one child (its Server drains in-process), reap it, and
        return its final edge ledger when reachable."""
        summary = None
        try:
            summary = self._ledgerz(slot)
        except Exception:
            pass
        proc = slot.proc
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=timeout_s)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        return summary

    def _ledgerz(self, slot: _ProcSlot) -> dict:
        conn = http.client.HTTPConnection("127.0.0.1", slot.port,
                                          timeout=5.0)
        try:
            conn.request("GET", "/ledgerz")
            return json.loads(conn.getresponse().read().decode("utf-8"))
        finally:
            conn.close()

    def child_ledgers(self) -> Dict[str, dict]:
        """Each live child's transport ledger."""
        out = {}
        with self._lock:
            slots = [s for s in self._slots.values()
                     if s.state == "serving"]
        for slot in slots:
            try:
                out[slot.rid] = self._ledgerz(slot)
            except Exception:
                pass
        return out

    def drain(self, reason: str = "close") -> dict:
        """Stop admitting, drain every child (SIGTERM -> in-process
        flush), and fold the fleet ledger into one journaled summary."""
        with self._lock:
            if self._draining:
                return dict(self._drain_summary or {})
            self._draining = True
        atexit.unregister(self.drain)
        t0 = time.monotonic()
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        if self._canary is not None:
            self.remove_canary()
        for slot in self._slots.values():
            if slot.state == "serving":
                slot.state = "draining"
            self._terminate(slot)
            slot.state = "dead"
        self._pool.shutdown(wait=True)
        counts = self.counts()
        pending = (counts["accepted"] - counts["completed"]
                   - counts["errors"] - counts["cancelled"])
        summary = {"reason": reason,
                   "outcome": "flushed" if pending == 0 else "timeout",
                   **counts, "pending": max(0, pending),
                   "shed": self.sheds, "refused": self.refused,
                   "replicas": len(self._slots),
                   "drain_s": round(time.monotonic() - t0, 3)}
        if self.journal is not None:
            self.journal.write("serve_drain", scope="pool", **summary)
        self._drain_summary = summary
        return summary

    def close(self) -> dict:
        return self.drain("close")
