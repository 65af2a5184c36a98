from deep_vision_tpu_torch.resilience import faults
from deep_vision_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultInjector,
    FaultSpecError,
    install_spec,
    installed,
)
from deep_vision_tpu_torch.resilience.retry import RetryPolicy

__all__ = ["FaultInjected", "FaultInjector", "FaultSpecError", "RetryPolicy",
           "faults", "install_spec", "installed"]
