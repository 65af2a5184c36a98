"""The preemption guard, the single-process part of
deep_vision_tpu/parallel/multihost.py (`PreemptionGuard`, :269-).

SIGTERM (what a preemptible VM gets ~30 s before it is reclaimed) sets
a latch; the training loop polls `agreed()` at step boundaries,
finishes the step in flight, checkpoints and returns. The context
manager installs the handler on the main thread only (the signal
module's rule) and restores the previous handler on exit.

This is the single-process case: `agreed(step=, force=)` returns the
local flag. Agreement across processes (the reference's cross-host OR
every `poll_every` optimizer steps, so that no host enters a checkpoint
while another enters the next step's all-reduce) waits for the
`torch.distributed` slice; `poll_every` is kept for its signature. The
reference's flight-recorder dump on SIGTERM waits for obs/flight.py.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    """SIGTERM -> a "stop at the next step boundary" latch."""

    def __init__(self, poll_every: int = 10):
        self.poll_every = max(1, int(poll_every))
        self.requested = False
        self._prev_handler = None

    def _on_sigterm(self, signum, frame):
        self.requested = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._prev_handler = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        return self

    def __exit__(self, *exc):
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None
        return False

    def agreed(self, *, step: Optional[int] = None,
               force: bool = False) -> bool:
        """Whether to stop now: one process, so the local flag."""
        return self.requested
