from deep_vision_tpu_torch.obs.registry import Registry, get_registry

__all__ = ["Registry", "get_registry"]
