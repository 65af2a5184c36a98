from deep_vision_tpu_torch.losses.classification import (
    classification_loss_fn,
    cross_entropy_loss,
)

__all__ = ["classification_loss_fn", "cross_entropy_loss"]
