"""The preemption guard, the single-process part of
deep_vision_tpu/parallel/multihost.py (`PreemptionGuard`, :269-).

SIGTERM (what a preemptible VM gets ~30 s before it is reclaimed) sets
a latch; the training loop polls `agreed()` at step boundaries,
finishes the step in flight, checkpoints and returns. The context
manager installs the handler on the main thread only (the signal
module's rule) and restores the previous handler on exit.

The signal also dumps the flight recorder's `preempt` bundle
(obs/flight.py) at once, from a thread: SIGTERM gives ~30 s of grace,
and the bundle must exist even if the graceful path never completes.
The dump never runs in signal context, where the handler may have
interrupted the main thread inside the journal's or the recorder's
locks. On exit the guard waits for that thread (up to
DUMP_JOIN_TIMEOUT_S), so a run that returns right after its preempt
save still leaves the bundle. A failed dump is swallowed: it must not
break the preemption protocol.

This is the single-process case: `agreed(step=, force=)` returns the
local flag. Agreement across processes (the reference's cross-host OR
every `poll_every` optimizer steps, so that no host enters a checkpoint
while another enters the next step's all-reduce) waits for the
`torch.distributed` slice; `poll_every` is kept for its signature.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional

#: seconds the guard's exit waits for the preempt dump's thread
DUMP_JOIN_TIMEOUT_S = 30.0


class PreemptionGuard:
    """SIGTERM -> a "stop at the next step boundary" latch."""

    def __init__(self, poll_every: int = 10):
        self.poll_every = max(1, int(poll_every))
        self.requested = False
        self._prev_handler = None
        self._dump_thread: Optional[threading.Thread] = None

    def _on_sigterm(self, signum, frame):
        self.requested = True
        try:
            t = threading.Thread(target=self._preempt_dump,
                                 name="flight-preempt-dump", daemon=True)
            t.start()
            self._dump_thread = t
        except Exception:
            pass  # a failed dump must not break the preemption protocol

    @staticmethod
    def _preempt_dump() -> None:
        try:
            from deep_vision_tpu_torch.obs import flight

            flight.emergency_dump("preempt")
        except Exception:
            pass

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._prev_handler = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        return self

    def __exit__(self, *exc):
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None
        if self._dump_thread is not None:
            self._dump_thread.join(timeout=DUMP_JOIN_TIMEOUT_S)
            self._dump_thread = None
        return False

    def agreed(self, *, step: Optional[int] = None,
               force: bool = False) -> bool:
        """Whether to stop now: one process, so the local flag."""
        return self.requested
