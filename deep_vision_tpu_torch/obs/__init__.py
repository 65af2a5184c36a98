from deep_vision_tpu_torch.obs.registry import Registry, get_registry
from deep_vision_tpu_torch.obs.telemetry import TelemetryServer

__all__ = ["Registry", "TelemetryServer", "get_registry"]
