from deep_vision_tpu_torch.core.backend import resolve_device

__all__ = ["resolve_device"]
