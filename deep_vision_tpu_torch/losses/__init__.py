from deep_vision_tpu_torch.losses.classification import (
    classification_loss_fn,
    cross_entropy_loss,
)
from deep_vision_tpu_torch.losses.heatmap import (
    centernet_loss_fn,
    hourglass_loss_fn,
)
from deep_vision_tpu_torch.losses.yolo import (
    yolo_loss_fn,
    yolo_loss_per_scale,
    yolo_train_loss_fn,
)

__all__ = ["centernet_loss_fn", "classification_loss_fn",
           "cross_entropy_loss", "hourglass_loss_fn", "yolo_loss_fn",
           "yolo_loss_per_scale", "yolo_train_loss_fn"]
