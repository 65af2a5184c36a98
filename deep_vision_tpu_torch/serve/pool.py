"""ReplicaPool: N engine replicas behind one front door (the port of
deep_vision_tpu/serve/pool.py).

The fleet layer above serve/router.py's single Server: replica death,
overload and weight updates under live traffic. A pool owns N replicas,
each an in-process set of dispatcher threads over its own warmed Engine
and Server; on one card the replicas share the device, and the
`serve.replica` fault kind `crash` SIGKILLs the process, as a real
process death would.

The request path::

    pool.submit(model, image)
      -> SLOTracker.offered           # every request the front door saw
      -> AdmissionController.admit    # bounded queues + token budget:
                                      #   shed -> typed `serve_shed` +
                                      #   ShedError, no Future made
      -> route: canary x% (swap.py), else the least-in-flight serving
         replica
      -> the replica's Server.submit

Replica lifecycle: `warming -> serving -> draining|dead`. Death is seen
two ways: at once, when a batch hits the `serve.replica` fault boundary
or an error below the request layer (the dispatcher reports it before it
fails its in-flight requests, so a death costs the requests on the dead
replica and no others); and by the supervisor, when a serving replica's
dispatcher threads are gone. Either way the pool journals a typed
`replica_lost`, fails that replica's requests with `ReplicaLost`, and
respawns the serving layer over the surviving warmed engine under a
`resilience.RetryPolicy` (typed `retry` events; `replica_recovered` on
success). The engine outlives its frontend, so a respawn runs no
warm-up; with `respawn_fresh=True` it rebuilds and re-warms the engine
through `build_engine`, the fresh-device model: when the factory's
Engine attaches an executable cache (core/excache.py) the libraries it
needs come from the cache, and the `replica_respawn_fresh` note carries
the warm-up's `backend_compiles` and `cache_hits` (in one process the
libraries are loaded already, so both are 0 there: the cache pays off in
a fresh process).

With `telemetry=` (an obs/telemetry.py TelemetryServer) the pool
registers the fleet view as `fleet` (`healthz`, `telemetry_status`), and
each replica's Server, built with the same server, registers its own
`serve:<rid>`: a respawned replica's Server takes over its dead
predecessor's slot by name. A canary's Server registers
`serve:canary<N>`, and `remove_canary` takes that entry out again. (The
reference leaves it, so after its first canary its /healthz answers 503
for good, from the drained canary's Server.)
"""
from __future__ import annotations

import queue as _queue
import threading
from concurrent.futures import Future
from typing import Callable, Dict, Optional

from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.resilience.retry import RetryPolicy
from deep_vision_tpu_torch.serve.admission import AdmissionController, ShedError
from deep_vision_tpu_torch.serve.engine import Engine, ServeError
from deep_vision_tpu_torch.serve.queue import QueueClosed
from deep_vision_tpu_torch.serve.router import DRAIN_REASONS, Server
from deep_vision_tpu_torch.serve.slo import SLOTracker

REPLICA_STATES = ("warming", "serving", "draining", "dead")


class ReplicaLost(ServeError):
    """The replica serving this request died; the failure is scoped to
    the requests in flight on it, and a resubmit lands on a survivor."""


class _ReplicaServer(Server):
    """A Server owned by one pool slot.

    It adds the `serve.replica` fault boundary at batch execution, and
    sorts errors: a malformed request stays request-scoped as in the
    base class, while an error below the request layer (or the injected
    replica fault) latches this replica dead and reports to the pool
    BEFORE the base dispatcher fails the in-flight batch.
    """

    #: exception types that are the request's fault, never the replica's
    _REQUEST_SCOPED = (ServeError, ValueError, TypeError)

    def __init__(self, *args, on_fatal: Optional[Callable] = None, **kw):
        super().__init__(*args, **kw)
        self._on_fatal = on_fatal
        self._dead = threading.Event()
        # one on_fatal report per replica life, even when several model
        # dispatchers hit the boundary at once
        self._fatal_lock = locksmith.lock("serve.replica.fatal")
        self._fatal_reported = False

    @property
    def dead(self) -> bool:
        return self._dead.is_set()

    @property
    def threads_alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def die(self) -> None:
        """Latch dead and close the queues: what is still queued fails
        with ReplicaLost at once, and the dispatchers exit."""
        self._dead.set()
        for q in self._queues.values():
            q.close()

    def _fatal(self, exc: Exception) -> None:
        with self._fatal_lock:
            if self._fatal_reported:
                return
            self._fatal_reported = True
        # report before closing the queues: the pool marks the slot dead
        # first, so no route picks a closed replica that looks serving
        if self._on_fatal is not None:
            self._on_fatal(exc)
        self.die()

    def _run_batch(self, model: str, batch) -> None:
        if self._dead.is_set():
            raise ReplicaLost(
                f"replica {self.tags.get('replica', '?')} is dead; "
                "resubmit to the pool")
        try:
            # the replica's execution boundary: an injected serve.replica
            # io_error here is a replica death
            faults.fire("serve.replica")
            super()._run_batch(model, batch)
        except self._REQUEST_SCOPED:
            raise
        except Exception as e:
            self._fatal(e)
            raise ReplicaLost(
                f"replica {self.tags.get('replica', '?')} died mid-batch: "
                f"{type(e).__name__}: {e}") from e


class _Slot:
    """One replica slot: identity, state, and its routing load."""

    __slots__ = ("rid", "engine", "server", "state", "inflight", "losses",
                 "canary", "retired")

    def __init__(self, rid: str, engine: Engine, canary: bool = False):
        self.rid = rid
        self.engine = engine
        self.server: Optional[_ReplicaServer] = None
        self.state = "warming"
        self.inflight = 0
        self.losses = 0
        self.canary = canary
        # has this slot's current server been folded into _retired? (a
        # dead server whose respawn gave up must not be folded again at
        # drain: its ledger would count twice)
        self.retired = False


class ReplicaPool:
    """N replicas, one front door: least-in-flight routing, admission
    control, supervised respawn, and a canary slot for serve/swap.py.

        pool = ReplicaPool(build_engine, replicas=2, journal=journal,
                           admission=AdmissionController(
                               max_queue_depth=16, rate_per_s=200))
        pool.start()                      # warms every replica's engine
        fut = pool.submit("yolov3", image)  # may raise ShedError
        pool.drain("close")               # flush, aggregate the ledger

    `build_engine(replica_id)` returns an UNWARMED Engine with the models
    registered, on the device the replica runs on; the pool warms each
    one and journals a `pool_warmup` note with the (model, bucket) pairs
    and their milliseconds. A replica needs modules of its own: a
    predictor built on `functional_call` swaps its module's parameters
    for the call, so the Engine serialises the calls of one predictor.
    """

    def __init__(self, build_engine: Callable[[str], Engine],
                 replicas: int = 2, journal=None, registry=None,
                 admission: Optional[AdmissionController] = None,
                 max_wait_ms: float = 5.0, slo_ms: Optional[float] = None,
                 health_policy: str = "warn", drain_timeout_s: float = 30.0,
                 respawn_policy: Optional[RetryPolicy] = None,
                 monitor_interval_s: float = 0.25,
                 respawn_fresh: bool = False, telemetry=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.build_engine = build_engine
        self.n_replicas = int(replicas)
        self.journal = journal
        self.registry = registry
        self.admission = admission
        self.max_wait_ms = float(max_wait_ms)
        self.slo_ms = slo_ms
        self.health_policy = health_policy
        self.drain_timeout_s = float(drain_timeout_s)
        self.monitor_interval_s = float(monitor_interval_s)
        self.respawn_fresh = bool(respawn_fresh)
        self.respawn_policy = respawn_policy or RetryPolicy(
            name="serve.replica", max_attempts=4, base_delay_s=0.05,
            max_delay_s=1.0, journal=journal,
            retry_on=(OSError, TimeoutError, ServeError))
        self.slo = SLOTracker(registry=registry, slo_ms=slo_ms)
        self._slots: Dict[str, _Slot] = {}
        self._inflight_model: Dict[str, int] = {}
        # the ledger of replaced and removed servers, so drain's
        # accepted == completed + errors + cancelled survives respawns
        self._retired = {"accepted": 0, "completed": 0, "errors": 0,
                         "cancelled": 0}
        self._lock = locksmith.lock("serve.pool")
        self._canary: Optional[_Slot] = None
        self._canary_pct = 0
        self._canary_counter = 0
        self._canary_gen = 0
        self._rr = 0
        self._started = False
        self._draining = False
        self._drained: Optional[dict] = None
        self._drain_done = threading.Event()
        self._respawn_q: _queue.Queue = _queue.Queue()
        self._supervisor: Optional[threading.Thread] = None
        self.warmup_stats: Optional[dict] = None
        # the live plane: the pool's fleet view; each replica's Server
        # registers its own serve:<rid> sources (Server.__init__)
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.add_health("fleet", self.healthz)
            telemetry.add_status("fleet", self.telemetry_status)

    # -- lifecycle -----------------------------------------------------------

    def _make_server(self, rid: str, engine: Engine, registry=None,
                     health_policy: Optional[str] = None) -> _ReplicaServer:
        return _ReplicaServer(
            engine, journal=self.journal,
            registry=registry if registry is not None else self.registry,
            max_wait_ms=self.max_wait_ms, slo_ms=self.slo_ms,
            drain_timeout_s=self.drain_timeout_s,
            health_policy=health_policy or self.health_policy,
            tags={"replica": rid}, telemetry=self.telemetry,
            on_fatal=lambda exc, _rid=rid: self._on_replica_fatal(_rid, exc))

    def start(self) -> "ReplicaPool":
        if self._started:
            return self
        per_replica = []
        for i in range(self.n_replicas):
            rid = f"r{i}"
            slot = _Slot(rid, self.build_engine(rid))
            self._slots[rid] = slot
            stats = slot.engine.warmup()
            slot.server = self._make_server(rid, slot.engine)
            slot.server.start()
            slot.state = "serving"
            per_replica.append({
                "replica": rid, **{k: stats[k] for k in (
                    "pairs", "warmup_ms_total", "backend_compiles",
                    "cache_hits")}})
        self.warmup_stats = {
            "replicas": self.n_replicas,
            **{k: sum(r[k] for r in per_replica) for k in (
                "pairs", "warmup_ms_total", "backend_compiles",
                "cache_hits")},
            "detail": per_replica,
        }
        if self.journal is not None:
            self.journal.write("note", note="pool_warmup", **{
                k: v for k, v in self.warmup_stats.items() if k != "detail"})
        self._supervisor = threading.Thread(
            target=self._supervise, name="pool-supervisor", daemon=True)
        self._supervisor.start()
        self._started = True
        return self

    # -- the front door ------------------------------------------------------

    def submit(self, model: str, image,
               deadline_ms: Optional[float] = None) -> Future:
        """Admit, route, enqueue. Raises ShedError at once when policy
        rejects (the admission budgets, or the pool draining), with no
        Future made, and ServeError when no serving replica remains
        (counted `refused`: a fleet failure, not a policy verdict)."""
        if not self._started:
            raise ServeError("submit() before start(): no replicas are up")
        self.slo.offered(model)
        # the admission verdict, the depth it judged and the in-flight
        # increment commit under ONE pool-lock hold: N racing clients at
        # depth max-1 admit exactly one (the admission lock nests inside
        # as a leaf)
        with self._lock:
            if self._draining:
                reason: Optional[str] = "draining"
            elif self.admission is not None:
                reason = self.admission.admit(
                    model, self._inflight_model.get(model, 0))
            else:
                reason = None
            slot = None if reason is not None else self._route(model)
        if reason is not None:
            self._shed(model, reason)
        # one reroute, excluding the replica that refused: it can die
        # between route and submit, which is the pool's race to absorb
        for attempt in range(2):
            if slot is None:
                self.slo.refused(model)
                raise ServeError(
                    f"no serving replicas for {model!r} "
                    f"({self.replica_states()})")
            try:
                fut = slot.server.submit(model, image,
                                         deadline_ms=deadline_ms)
            except QueueClosed:
                self._dec_inflight(slot, model)
                if attempt == 0:
                    with self._lock:
                        slot = self._route(model, exclude=slot)
                    continue
                break
            except Exception:
                self._dec_inflight(slot, model)
                raise
            fut.add_done_callback(
                lambda _f, _s=slot, _m=model: self._dec_inflight(_s, _m))
            return fut
        self.slo.refused(model)
        raise ServeError(f"no serving replica accepted {model!r}")

    def _shed(self, model: str, reason: str) -> None:
        self.slo.shed(model, reason)
        if self.journal is not None:
            self.journal.write("serve_shed", model=model, reason=reason)
        raise ShedError(model, reason)

    def _route(self, model: str,
               exclude: Optional[_Slot] = None) -> Optional[_Slot]:
        """Pick a replica and commit its in-flight increment. The caller
        holds the pool lock."""
        # canary diversion first (serve/swap.py): pct% of the stream,
        # evenly spread, so a seeded arrival pattern gives the same sample
        canary = self._canary
        if (canary is not None and canary.state == "serving"
                and canary is not exclude and self._canary_pct > 0):
            self._canary_counter += 1
            i, pct = self._canary_counter, self._canary_pct
            if (i * pct) // 100 > ((i - 1) * pct) // 100:
                return self._take(canary, model)
        serving = [s for s in self._slots.values()
                   if s.state == "serving" and not s.canary
                   and s is not exclude]
        if not serving:
            return None
        self._rr += 1
        slot = min(serving,
                   key=lambda s: (s.inflight,
                                  (hash(s.rid) + self._rr)
                                  % max(1, len(serving))))
        return self._take(slot, model)

    def _take(self, slot: _Slot, model: str) -> _Slot:
        slot.inflight += 1
        self._inflight_model[model] = self._inflight_model.get(model, 0) + 1
        self.slo.replica_queue_depth(slot.rid, slot.inflight)
        return slot

    def _dec_inflight(self, slot: _Slot, model: str) -> None:
        with self._lock:
            slot.inflight = max(0, slot.inflight - 1)
            self._inflight_model[model] = max(
                0, self._inflight_model.get(model, 0) - 1)
            self.slo.replica_queue_depth(slot.rid, slot.inflight)

    # -- replica death + respawn ---------------------------------------------

    def _on_replica_fatal(self, rid: str, exc: Exception) -> None:
        """Called once per replica life from the dying replica's
        dispatcher, before its queues close and its batch fails: routing
        stops here first."""
        with self._lock:
            slot = self._slots.get(rid)
            if slot is None or slot.state == "dead":
                return
            slot.state = "dead"
            slot.losses += 1
            losses = slot.losses
            is_canary = slot.canary
        self.slo.registry.counter(
            "serve_replica_lost_total", "replica deaths",
            labels={"replica": rid}).inc()
        if self.journal is not None:
            self.journal.write(
                "replica_lost", replica=rid, attempt=int(losses),
                error=f"{type(exc).__name__}: {exc}"[:200])
        if not is_canary:
            # a canary's death is the swap's verdict, not a slot to respawn
            self._respawn_q.put(rid)

    def _supervise(self) -> None:
        """Respawn worker and liveness monitor: a dead replica arrives on
        the queue; the timeout doubles as the poll for replicas whose
        dispatchers died without reporting."""
        while True:
            try:
                rid = self._respawn_q.get(timeout=self.monitor_interval_s)
            except _queue.Empty:
                self._check_liveness()
                continue
            if rid is None:
                return
            self._respawn(rid)

    def _check_liveness(self) -> None:
        with self._lock:
            suspects = [s for s in self._slots.values()
                        if s.state == "serving" and s.server is not None
                        and not s.server.threads_alive]
        for slot in suspects:
            # the same fatal path, so the journal and respawn story do not
            # depend on how the death was seen
            slot.server._fatal(ReplicaLost(
                f"replica {slot.rid} dispatcher threads died silently"))

    def _retire(self, slot: _Slot) -> None:
        """Fold a replaced or removed server's ledger into the pool totals,
        once (after its threads end, when its counts are final)."""
        with self._lock:
            if slot.retired or slot.server is None:
                return
            slot.retired = True
            server = slot.server
        for t in server._threads:
            t.join(timeout=self.drain_timeout_s)
        counts = server.counts()
        with self._lock:
            for k in self._retired:
                self._retired[k] += counts[k]

    def _respawn(self, rid: str) -> None:
        with self._lock:
            slot = self._slots.get(rid)
            if slot is None or slot.state != "dead":
                return
            engine = slot.engine
        self._retire(slot)
        attempts = {"n": 0}
        fresh = {"engine": None}

        def build() -> _ReplicaServer:
            attempts["n"] += 1
            # the respawn rides death's injection point: a serve.replica
            # io_error here is a failed attempt the RetryPolicy retries
            faults.fire("serve.replica")
            server_engine = engine
            if self.respawn_fresh:
                server_engine = self.build_engine(rid)
                stats = server_engine.warmup()
                fresh["engine"] = server_engine
                if self.journal is not None:
                    self.journal.write(
                        "note", note="replica_respawn_fresh", replica=rid,
                        pairs=stats["pairs"],
                        warmup_ms_total=stats["warmup_ms_total"],
                        backend_compiles=stats["backend_compiles"],
                        cache_hits=stats["cache_hits"])
            server = self._make_server(rid, server_engine)
            server.start()
            return server

        try:
            server = self.respawn_policy.call(build)
        except Exception as e:  # budget spent: the slot stays dead
            if self.journal is not None:
                self.journal.write(
                    "note", note="replica_respawn_gave_up", replica=rid,
                    error=f"{type(e).__name__}: {e}"[:200])
            return
        with self._lock:
            if fresh["engine"] is not None:
                slot.engine = fresh["engine"]
            slot.server = server
            slot.inflight = 0
            slot.retired = False  # a fresh ledger to fold in later
            slot.state = "serving"
        self.slo.registry.counter(
            "serve_replica_recovered_total", "replica respawns",
            labels={"replica": rid}).inc()
        if self.journal is not None:
            self.journal.write("replica_recovered", replica=rid,
                               attempt=int(attempts["n"]))

    # -- canary hosting (serve/swap.py) --------------------------------------

    def primary_engine(self) -> Engine:
        """The engine whose warmed menu a swap's shadow shares."""
        with self._lock:
            for slot in self._slots.values():
                if slot.state == "serving" and not slot.canary:
                    return slot.engine
        raise ServeError("no serving replica to anchor a swap on")

    def add_canary(self, engine: Engine, pct: int) -> str:
        """Mount a canary replica over `engine` taking `pct`% of traffic.
        It always runs health_policy=abort, so bad weights turn into
        request errors the verdict counts, and has a registry of its own,
        so its latency tail judges canary traffic only."""
        if not 0 < pct <= 100:
            raise ValueError(f"canary pct must be in (0, 100], got {pct}")
        with self._lock:
            if self._canary is not None:
                raise ServeError("a canary replica is already mounted")
            self._canary_gen += 1
            rid = f"canary{self._canary_gen}"
        server = self._make_server(rid, engine, registry=Registry(),
                                   health_policy="abort")
        server.start()
        with self._lock:
            slot = _Slot(rid, engine, canary=True)
            slot.server = server
            slot.state = "serving"
            self._slots[rid] = slot
            self._canary = slot
            self._canary_pct = int(pct)
            self._canary_counter = 0
        return rid

    def canary_status(self) -> Optional[dict]:
        with self._lock:
            slot = self._canary
        if slot is None:
            return None
        counts = slot.server.counts()
        return {"replica": slot.rid, "state": slot.state, **counts,
                "slo": slot.server.slo.report()}

    def remove_canary(self) -> Optional[dict]:
        """Unmount the canary (promote or rollback: the diverted traffic
        returns to the base replicas) and retire its ledger. Returns its
        drain summary, or None without a canary."""
        with self._lock:
            slot = self._canary
            self._canary = None
            self._canary_pct = 0
        if slot is None:
            return None
        with self._lock:
            slot.state = "draining"
        summary = slot.server.drain("close")
        self._retire(slot)
        with self._lock:
            self._slots.pop(slot.rid, None)
        if self.telemetry is not None:
            # the drained canary's sources leave with it
            self.telemetry.remove(f"serve:{slot.rid}")
        return summary

    def promote_variables(self, variables_by_model: dict) -> None:
        """Swap the new weights into every base replica's engine (dead
        slots included: a respawn must come back with the promoted
        weights). Each engine's swap takes effect at its next batch."""
        with self._lock:
            engines = [s.engine for s in self._slots.values()
                       if not s.canary]
        for engine in engines:
            for name, variables in variables_by_model.items():
                engine.set_variables(name, variables)

    # -- drain / report ------------------------------------------------------

    def replica_states(self) -> Dict[str, str]:
        with self._lock:
            return {rid: s.state for rid, s in self._slots.items()}

    def healthz(self):
        """Health source: ready while at least one replica serves and the
        pool is not draining; a dead replica mid-respawn costs capacity,
        not readiness."""
        states = self.replica_states()
        with self._lock:
            draining = self._draining or self._drained is not None
        serving = sum(1 for s in states.values() if s == "serving")
        ok = self._started and not draining and serving > 0
        return ok, {"started": self._started, "draining": draining,
                    "serving": serving, "replicas": len(states),
                    "states": states}

    def telemetry_status(self) -> dict:
        """Status source: replica states, the fleet ledger, the canary's
        generation and the warm-up."""
        with self._lock:
            replicas = self._replicas()
            retired = dict(self._retired)
            generation = self._canary_gen
            canary_pct = self._canary_pct
        return {"replicas": replicas, "retired": retired,
                "generation": generation, "canary_pct": canary_pct,
                "warmup": self.warmup_stats}

    def drain(self, reason: str = "close") -> dict:
        """Flush every admitted request, stop every replica, and journal
        the fleet ledger as one `serve_drain` with scope "pool", after the
        replicas' own. Idempotent."""
        if reason not in DRAIN_REASONS:
            raise ValueError(f"drain reason {reason!r} not in {DRAIN_REASONS}")
        with self._lock:
            already = self._drained is not None
            if not already:
                # a full-keyed placeholder: a concurrent caller that times
                # out below still sees a well-formed summary, and only one
                # caller runs the body
                self._drained = {
                    "reason": reason, "outcome": "timeout", "accepted": 0,
                    "completed": 0, "errors": 0, "cancelled": 0,
                    "pending": 0, "shed": 0, "offered": 0, "refused": 0,
                    "replicas": 0,
                }
                self._draining = True
            slots = list(self._slots.values())
        if already:
            self._drain_done.wait(timeout=self.drain_timeout_s)
            with self._lock:
                return self._drained
        try:
            if self.admission is not None:
                self.admission.start_draining()
            self._respawn_q.put(None)
            if self._supervisor is not None:
                self._supervisor.join(timeout=self.drain_timeout_s)
            summaries = {}
            for slot in slots:
                if slot.state == "dead":
                    self._retire(slot)  # a no-op if its give-up did it
                    continue
                with self._lock:
                    slot.state = "draining"
                # replicas drain with reason `close`: the pool owns the
                # preemption (one preempt bundle below, not N)
                summaries[slot.rid] = slot.server.drain("close")
            with self._lock:
                totals = dict(self._retired)
            for s in summaries.values():
                for k in totals:
                    totals[k] += s.get(k, 0)
            pending = (totals["accepted"] - totals["completed"]
                       - totals["errors"] - totals["cancelled"])
            outcome = ("flushed"
                       if pending == 0 and all(s["outcome"] == "flushed"
                                               for s in summaries.values())
                       else "timeout")
            slo_report = self.slo.report().values()
            summary = {"reason": reason, "outcome": outcome, **totals,
                       "pending": max(0, pending),
                       "shed": sum(r.get("shed", 0) for r in slo_report),
                       "offered": sum(r.get("offered", 0)
                                      for r in slo_report),
                       "refused": sum(r.get("refused", 0)
                                      for r in slo_report),
                       "replicas": len(summaries)}
            if self.journal is not None:
                self.journal.write("serve_drain", scope="pool", **summary)
            if reason == "sigterm":
                from deep_vision_tpu_torch.obs import flight

                summary["flight_bundle"] = flight.emergency_dump("preempt")
            with self._lock:
                self._drained = summary
            return summary
        finally:
            self._drain_done.set()

    def close(self) -> dict:
        return self.drain("close")

    def report(self) -> dict:
        with self._lock:
            replicas = self._replicas()
        return {"replicas": replicas, "slo": self.slo.report(),
                "drained": self._drained}

    def _replicas(self) -> Dict[str, dict]:
        """Each slot's state, load and losses; the caller holds the lock."""
        return {rid: {"state": s.state, "inflight": s.inflight,
                      "losses": s.losses, "canary": s.canary}
                for rid, s in self._slots.items()}
