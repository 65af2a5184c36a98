"""Multi-device and multi-process pieces of the port: only the
single-process PreemptionGuard (parallel/multihost.py) and the Switch
load-balancing loss (parallel/moe.py) so far."""
from deep_vision_tpu_torch.parallel.multihost import PreemptionGuard

__all__ = ["PreemptionGuard"]
