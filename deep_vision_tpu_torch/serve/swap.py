"""Canary weight swap: new weights under live traffic, with no downtime
(the port of deep_vision_tpu/serve/swap.py).

Every registered predictor takes its variables (a state_dict) as a
runtime argument, so new weights of the same shapes and dtypes run on
the (model, bucket) shapes warmed at start-up. A swap therefore runs no
warm-up and builds no kernel; the controller proves it with
`compile_count()`, the warm-ups of any Engine plus the kernel builds of
ops/cuda/build.py, the port's counterpart of the JAX compile counter.

The state machine, each transition a typed `serve_swap` journal event
(`phase` in warm/canary/promote/rollback, `outcome` in
started/ok/failed)::

    warm      load the checkpoint (CheckpointManager.restore_tree onto the
              serving variables' keys, shapes, dtypes and device),
              bind a SHADOW engine over the primary's warmed menu
              (Engine.clone_with_variables), and probe every swapped
              model once; the count must not move. Any failure here
              rolls back before a user request touches the new weights.
              The `serve.replica` fault point fires at the load, so a
              failed restore is injectable.
    canary    mount the shadow as a canary replica taking x% of live
              traffic (add_canary: a replica of a ReplicaPool, or a
              process of a ProcReplicaPool, whose weights go there in a
              file; health_policy=abort either way, so non-finite
              outputs become request errors), and wait for
              `min_canary_requests` verdict samples.
    promote   canary healthy (error rate within budget, p99 within the
              SLO target, replica alive): set the new variables on every
              base replica's engine (a process replica's through its
              /control/promote), then unmount the canary.
    rollback  canary unhealthy (errors, SLO, death) or warm failed:
              unmount; the old weights never stopped serving.

The warm probes run on zeros: they prove plumbing, shapes and the
no-warm-up contract, not health; weights finite on zeros can blow up on
real traffic, which is what the canary judges.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.ops.cuda import build
from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.serve.engine import Engine, ServeError, warmup_count

SWAP_PHASES = ("warm", "canary", "promote", "rollback")
SWAP_OUTCOMES = ("started", "ok", "failed")


def compile_count() -> int:
    """(model, bucket) warm-ups of any Engine plus CUDA sources built, in
    this process: what a hot swap must leave unchanged."""
    return warmup_count() + build.build_count()


class SwapController:
    """Drives one canary weight swap at a time over a ReplicaPool or a
    ProcReplicaPool, through their shared surface: primary_engine,
    add_canary, canary_status, promote_variables and remove_canary.

        ckpt.save_tree(1200, swap_tree({"yolov3": new_state_dict}))
        swapper = SwapController(pool, journal=journal, canary_pct=25,
                                 min_canary_requests=8)
        verdict = swapper.swap("checkpoints/yolov3", step=1200)
        # {'outcome': 'promoted' | 'rolled_back', 'timeline': [...]}

    `swap()` blocks through the state machine; live traffic must keep
    flowing from client threads meanwhile, since the canary's verdict is
    sampled from real requests the pool diverts.
    """

    def __init__(self, pool, journal=None,
                 canary_pct: int = 25, min_canary_requests: int = 8,
                 max_canary_error_rate: float = 0.0,
                 slo_ms: Optional[float] = None,
                 canary_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.02,
                 clock=time.monotonic, sleep=time.sleep):
        self.pool = pool
        self.journal = journal
        self.canary_pct = int(canary_pct)
        self.min_canary_requests = int(min_canary_requests)
        self.max_canary_error_rate = float(max_canary_error_rate)
        self.slo_ms = slo_ms
        self.canary_timeout_s = float(canary_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self._clock = clock
        self._sleep = sleep
        self._swap_lock = locksmith.lock("serve.swap")
        self._swap_seq = 0

    def _emit(self, timeline: list, swap_id: int, phase: str, outcome: str,
              **fields) -> None:
        row = {"swap": swap_id, "phase": phase, "outcome": outcome, **fields}
        timeline.append(row)
        if self.journal is not None:
            self.journal.write("serve_swap", **row)

    # -- the load + shadow-bind step -----------------------------------------

    def _load(self, source, step, models, mesh) -> Dict[str, object]:
        """Checkpoint -> {model: variables} on the serving device.

        `source` is a core/checkpoint.CheckpointManager (or anything with
        its restore_tree contract) or a checkpoint directory path; the
        tree was saved by `save_tree(step, swap_tree({model:
        state_dict}))`. A mesh raises in restore_tree: cross-mesh restore
        is not ported."""
        faults.fire("serve.replica")  # the injectable swap-restore boundary
        engine = self.pool.primary_engine()
        models = tuple(models or engine.models)
        template = {name: engine.entry(name).variables for name in models}
        owned = None
        try:
            if isinstance(source, str):
                from deep_vision_tpu_torch.core.checkpoint import (
                    CheckpointManager,
                )

                owned = CheckpointManager(source, journal=self.journal)
                mgr = owned
            else:
                mgr = source
            tree, _host = mgr.restore_tree(swap_tree(template), step=step,
                                           mesh=mesh)
        finally:
            if owned is not None:
                owned.close()
        if tree is None:
            raise ServeError(
                f"no valid checkpoint to swap in from {source!r} "
                f"(step={step})")
        return {name: _nested(tree, name) for name in models}

    def _probe(self, shadow: Engine, models) -> int:
        """One zeros batch per swapped model through the shared menu;
        returns the compile-count delta (must be 0)."""
        c0 = compile_count()
        for name in models:
            entry = shadow.entry(name)
            bucket = min(entry.buckets)
            shadow.run(name, np.zeros((bucket,) + entry.input_shape,
                                      entry.dtype))
        return compile_count() - c0

    # -- the state machine ---------------------------------------------------

    def swap(self, source, step: Optional[int] = None, models=None,
             mesh=None) -> dict:
        """Run warm -> canary -> promote|rollback; returns the verdict
        {outcome, swap, timeline} (and reason on a rollback). One swap
        at a time: a second concurrent call raises."""
        if not self._swap_lock.acquire(blocking=False):
            raise ServeError("a swap is already in flight")
        try:
            self._swap_seq += 1
            swap_id = self._swap_seq
            timeline: list = []

            def emit(phase, outcome, **fields):
                self._emit(timeline, swap_id, phase, outcome, **fields)

            # -- warm ------------------------------------------------------
            emit("warm", "started", step=step)
            try:
                new_vars = self._load(source, step, models, mesh)
                shadow = self.pool.primary_engine().clone_with_variables(
                    new_vars)
                delta = self._probe(shadow, new_vars)
                if delta:
                    raise ServeError(
                        f"shadow warm compiled {delta} executable(s); a "
                        "hot swap must reuse the warmed menu — re-warm a "
                        "new pool for shape/structure changes")
            except Exception as e:
                emit("warm", "failed",
                     error=f"{type(e).__name__}: {e}"[:200])
                emit("rollback", "ok", reason="warm_failed")
                return {"outcome": "rolled_back", "swap": swap_id,
                        "reason": "warm_failed", "timeline": timeline}
            emit("warm", "ok", compile_delta=0, models=sorted(new_vars))

            # -- canary ----------------------------------------------------
            rid = self.pool.add_canary(shadow, self.canary_pct)
            emit("canary", "started", replica=rid, pct=self.canary_pct)
            verdict = self._watch_canary()
            if not verdict.pop("healthy"):
                emit("canary", "failed", replica=rid, **verdict)
                self.pool.remove_canary()
                emit("rollback", "ok", reason=verdict.get("reason", "?"))
                return {"outcome": "rolled_back", "swap": swap_id,
                        "reason": verdict.get("reason"),
                        "timeline": timeline}
            emit("canary", "ok", replica=rid, **verdict)

            # -- promote ---------------------------------------------------
            # base replicas first, the canary unmounted after: at every
            # instant the whole request stream has a serving target
            self.pool.promote_variables(new_vars)
            self.pool.remove_canary()
            emit("promote", "ok", models=sorted(new_vars))
            return {"outcome": "promoted", "swap": swap_id,
                    "timeline": timeline}
        finally:
            self._swap_lock.release()

    def _watch_canary(self) -> dict:
        """Sample the canary until enough verdict traffic (or timeout, or
        its death). Healthy = alive, error rate within budget, p99 within
        the SLO target."""
        deadline = self._clock() + self.canary_timeout_s
        status = self.pool.canary_status()
        while self._clock() < deadline:
            status = self.pool.canary_status()
            if status is None:
                return {"healthy": False, "reason": "canary_missing"}
            if status["state"] == "dead":
                return {"healthy": False, "reason": "replica_lost",
                        "canary_ok": status["completed"],
                        "canary_err": status["errors"]}
            done = (status["completed"] + status["errors"]
                    + status["cancelled"])
            if done >= self.min_canary_requests:
                break
            self._sleep(self.poll_interval_s)
        else:
            return {"healthy": False, "reason": "canary_timeout",
                    "canary_ok": status["completed"] if status else 0,
                    "canary_err": status["errors"] if status else 0}
        judged = status["completed"] + status["errors"]
        rate = status["errors"] / max(1, judged)
        out = {"canary_ok": status["completed"],
               "canary_err": status["errors"],
               "error_rate": round(rate, 4)}
        slo = status.get("slo") or {}
        p99 = max((r.get("p99_ms", 0.0) for r in slo.values()), default=0.0)
        if p99:
            out["p99_ms"] = round(p99, 3)
        if rate > self.max_canary_error_rate:
            return {"healthy": False, "reason": "errors", **out}
        if self.slo_ms is not None and p99 > self.slo_ms:
            return {"healthy": False, "reason": "slo", **out}
        return {"healthy": True, **out}


def swap_tree(tree: Dict[str, Dict[str, object]]) -> Dict[str, object]:
    """{model: state_dict} -> one flat dict keyed "model/param", which
    `CheckpointManager.save_tree` writes and a swap restores."""
    return {f"{name}/{k}": v for name, sd in tree.items()
            for k, v in sd.items()}


def _nested(flat: Dict[str, object], name: str) -> Dict[str, object]:
    prefix = f"{name}/"
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}
