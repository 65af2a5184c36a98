"""Training health monitor: NaN guard, divergence detector, hang watchdog.

The port of deep_vision_tpu/obs/health.py:47-370, host-side code:

- **Non-finite guard**: each checked step's loss and grad norm, read on
  the host, are tested for NaN/Inf. Policies: `warn` writes a typed
  `health` event and goes on; `skip_step` has the Trainer discard the
  poisoned update (Trainer.train_step keeps the whole pre-step state)
  and counts the skip; `abort` writes the event, then raises
  TrainingHealthError.
- **Divergence detector**: a rolling-window z-score over recent losses
  flags spikes (`loss_spike`); `patience` spikes in a row escalate to
  `divergence` and apply the policy.
- **Hang watchdog**: a daemon thread with a deadline; when no step (or
  eval batch) completes within it, every Python thread's stack goes
  into a `health` event (`kind=hang`) and to stderr.

`healthz()` is the telemetry server's health source (obs/telemetry.py):
unhealthy once the run has aborted (a latch set before each abort raise
unwinds, and never cleared) and while the watchdog's latch is up (the
next heartbeat clears it).

Findings reach the flight recorder (obs/flight.py) through the
journal's tap; with no journal they go to the installed recorder
directly, so a hang or an abort still leaves its bundle.
"""
from __future__ import annotations

import math
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.registry import Registry, get_registry

POLICIES = ("warn", "skip_step", "abort")


class TrainingHealthError(FloatingPointError):
    """Raised by the `abort` policy (and by divergence escalation under
    it); a FloatingPointError, as the epoch-level divergence check's."""


def dump_all_stacks() -> dict:
    """Every live Python thread's stack, keyed by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for tid, frame in sys._current_frames().items():
        name = names.get(tid, f"tid-{tid}")
        stacks[f"{name} ({tid})"] = [
            line.rstrip() for line in traceback.format_stack(frame)]
    return stacks


class HealthMonitor:
    """Per-run health guard between the host loop and the journal.

    `check_step` doubles as the watchdog heartbeat; eval loops call
    `beat()` per batch."""

    def __init__(self, policy: str = "warn", journal=None,
                 registry: Optional[Registry] = None, window: int = 50,
                 z_threshold: float = 6.0, min_history: int = 20,
                 patience: int = 3,
                 watchdog_timeout: Optional[float] = None,
                 check_every: int = 1, name: str = "train",
                 policy_explicit: bool = True):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        # False when the policy is a default nobody chose (a watchdog
        # alone): the trainer's fatal non-finite epoch check then stays
        self.policy_explicit = bool(policy_explicit)
        self.journal = journal
        self.registry = registry or get_registry()
        self.window = int(window)
        self.z_threshold = float(z_threshold)
        self.min_history = int(min_history)
        self.patience = int(patience)
        self.watchdog_timeout = watchdog_timeout
        self.check_every = max(1, int(check_every))
        self.name = name

        r = self.registry
        self._c_nonfinite = r.counter(
            "health_nonfinite_steps_total",
            "steps whose loss or grad norm was NaN/Inf")
        self._c_skipped = r.counter(
            "health_skipped_steps_total",
            "poisoned updates discarded by the skip_step policy")
        self._c_spikes = r.counter(
            "health_loss_spikes_total", "rolling-window z-score loss spikes")
        self._c_hangs = r.counter(
            "health_watchdog_fires_total",
            "watchdog deadline expiries (stack dumps written)")

        # the readiness latch /healthz reads: set before every abort raise
        # and never cleared (a fresh monitor is a fresh run)
        self.aborted = False
        self.abort_reason: Optional[str] = None

        self._losses: deque = deque(maxlen=self.window)
        self._spike_streak = 0
        self._checks = 0

        # watchdog: a monotonic heartbeat and a fire latch (one stall, one
        # dump), both under one lock: the train thread beats, the
        # watchdog thread fires
        self._wd_lock = locksmith.lock("obs.health.watchdog")
        self._last_beat = time.monotonic()
        self._wd_fired = False
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()

    def _emit(self, kind: str, **fields) -> None:
        if self.journal is not None:
            # the flight recorder rides the journal's tap
            self.journal.write("health", kind=kind, policy=self.policy,
                               monitor=self.name, **fields)
            return
        # journal-less runs still feed the recorder: a hang or an abort
        # must leave its bundle when nobody asked for a journal
        try:
            from deep_vision_tpu_torch.obs import flight

            fr = flight.get_flight()
            if fr is not None:
                fr.observe({"event": "health", "ts": round(time.time(), 3),
                            "kind": kind, "policy": self.policy,
                            "monitor": self.name, **fields})
        except Exception:
            pass

    # -- non-finite + divergence checks ------------------------------------

    def check_step(self, step: int, loss: Optional[float] = None,
                   grad_norm: Optional[float] = None,
                   skipped: bool = False) -> str:
        """Check one step's host scalars; returns the action taken
        ('ok' | 'warn' | 'skip' | 'spike'). Raises TrainingHealthError
        under the abort policy. `skipped`: the step already discarded
        this update (skip_step)."""
        self.beat()
        self._checks += 1
        if self._checks % self.check_every != 0 and not skipped:
            return "ok"

        bad = [k for k, v in (("loss", loss), ("grad_norm", grad_norm))
               if v is not None and not math.isfinite(v)]
        if bad or skipped:
            self._c_nonfinite.inc()
            action = {"warn": "warn", "skip_step": "skip",
                      "abort": "abort"}[self.policy]
            detail = {k: repr(v) for k, v in
                      (("loss", loss), ("grad_norm", grad_norm))
                      if v is not None}
            self._emit("non_finite", step=int(step), fields=bad or ["loss"],
                       action=action, **detail)
            if self.policy == "skip_step":
                self._c_skipped.inc()
                print(f"health: non-finite {'/'.join(bad) or 'loss'} at step "
                      f"{step} — update skipped", file=sys.stderr, flush=True)
                return "skip"
            if self.policy == "abort":
                raise self._abort(TrainingHealthError(
                    f"non-finite {'/'.join(bad) or 'loss'} at step {step} "
                    f"(loss={loss!r}, grad_norm={grad_norm!r}); aborting per "
                    "--health-policy abort"))
            print(f"health: non-finite {'/'.join(bad)} at step {step} "
                  f"(loss={loss!r}, grad_norm={grad_norm!r})",
                  file=sys.stderr, flush=True)
            return "warn"

        if loss is None:
            return "ok"
        if len(self._losses) >= self.min_history:
            mean = sum(self._losses) / len(self._losses)
            var = sum((x - mean) ** 2 for x in self._losses) / len(
                self._losses)
            std = math.sqrt(var)
            z = (loss - mean) / max(std, 1e-9)
            if z > self.z_threshold:
                self._c_spikes.inc()
                self._spike_streak += 1
                escalate = self._spike_streak >= self.patience
                extra = ({"action": "abort"}
                         if escalate and self.policy == "abort" else {})
                self._emit("divergence" if escalate else "loss_spike",
                           step=int(step), loss=loss, window_mean=mean,
                           window_std=std, z=z, streak=self._spike_streak,
                           **extra)
                if escalate:
                    msg = (f"divergence: {self._spike_streak} consecutive "
                           f"loss spikes (z={z:.1f}, loss={loss:.4g} vs "
                           f"window mean {mean:.4g})")
                    if self.policy == "abort":
                        raise self._abort(TrainingHealthError(msg))
                    print("health: " + msg, file=sys.stderr, flush=True)
                # a spiking loss stays out of the window, which models the
                # healthy recent past
                return "spike"
            self._spike_streak = 0
        self._losses.append(loss)
        return "ok"

    def check_summary(self, epoch: int, summary: dict) -> None:
        """Epoch-granularity guard: any non-finite summary value triggers
        the policy."""
        self.beat()
        bad = {k: v for k, v in summary.items()
               if isinstance(v, float) and not math.isfinite(v)}
        if not bad:
            return
        self._c_nonfinite.inc()
        self._emit("non_finite", epoch=int(epoch), fields=sorted(bad),
                   action=self.policy)
        if self.policy == "abort":
            raise self._abort(TrainingHealthError(
                f"non-finite epoch {epoch} summary: {bad}; aborting per "
                "--health-policy abort"))
        print(f"health: non-finite epoch {epoch} summary {bad}",
              file=sys.stderr, flush=True)

    def _abort(self, err: TrainingHealthError) -> TrainingHealthError:
        """Latch the abort for /healthz and hand the error back to its
        raise site: the latch is up before the raise unwinds, so a probe
        racing the abort never reads healthy-but-dying."""
        self.aborted = True
        self.abort_reason = str(err)
        return err

    def healthz(self):
        """Telemetry health source: (ok, detail). Unhealthy once aborted,
        or while the watchdog's latch is up."""
        with self._wd_lock:
            fired = self._wd_fired
            beat_age = time.monotonic() - self._last_beat
        ok = not self.aborted and not fired
        detail = {
            "policy": self.policy,
            "monitor": self.name,
            "aborted": self.aborted,
            "watchdog_fired": fired,
            "last_beat_age_s": round(beat_age, 3),
        }
        if self.abort_reason:
            detail["abort_reason"] = self.abort_reason
        return ok, detail

    @property
    def skip_nonfinite(self) -> bool:
        """True when the train step must discard non-finite updates."""
        return self.policy == "skip_step"

    # -- watchdog ----------------------------------------------------------

    def beat(self) -> None:
        """Heartbeat: any sign of progress re-arms the watchdog."""
        with self._wd_lock:
            self._last_beat = time.monotonic()
            self._wd_fired = False

    def start_watchdog(self) -> None:
        """Arm the hang detector (no-op without a timeout); a daemon
        thread, which never keeps a dying process alive."""
        if not self.watchdog_timeout or self._wd_thread is not None:
            return
        self.beat()
        self._wd_stop.clear()
        self._wd_thread = threading.Thread(
            target=self._watchdog_loop, name=f"health-watchdog-{self.name}",
            daemon=True)
        self._wd_thread.start()
        self._emit("watchdog_started", timeout_s=float(self.watchdog_timeout))

    def _watchdog_loop(self) -> None:
        poll = min(max(self.watchdog_timeout / 4.0, 0.05), 10.0)
        while not self._wd_stop.wait(poll):
            with self._wd_lock:
                stalled = time.monotonic() - self._last_beat
                if stalled < self.watchdog_timeout or self._wd_fired:
                    continue
                self._wd_fired = True
            # the dump and the write run outside the lock: beat() is on
            # the per-step path
            self._c_hangs.inc()
            stacks = dump_all_stacks()
            self._emit("hang", stalled_s=round(stalled, 3),
                       timeout_s=float(self.watchdog_timeout), stacks=stacks)
            print(f"health: WATCHDOG — no step completed in {stalled:.1f}s "
                  f"(deadline {self.watchdog_timeout}s); thread stacks:",
                  file=sys.stderr, flush=True)
            for name, frames in stacks.items():
                print(f"--- {name} ---", file=sys.stderr)
                print("".join(f"{ln}\n" for ln in frames), file=sys.stderr,
                      flush=True)

    def stop(self) -> None:
        """Disarm the watchdog; idempotent."""
        self._wd_stop.set()
        t, self._wd_thread = self._wd_thread, None
        if t is not None:
            t.join(timeout=5)
