"""Multi-device and multi-process pieces of the port: only the
single-process PreemptionGuard so far (parallel/multihost.py)."""
from deep_vision_tpu_torch.parallel.multihost import PreemptionGuard

__all__ = ["PreemptionGuard"]
