from deep_vision_tpu_torch.train.optimizers import build_optimizer, set_lr
from deep_vision_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer", "build_optimizer", "set_lr"]
