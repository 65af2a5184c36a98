from deep_vision_tpu_torch.resilience.retry import RetryPolicy

__all__ = ["RetryPolicy"]
