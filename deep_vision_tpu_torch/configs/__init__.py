"""Experiment config registry, the port of deep_vision_tpu/configs/__init__.py.

Configs are data, selected by name: the reference's `ExperimentConfig`
fields, its one-LR-policy check, and every registered config with every
value, copied. `get_config` returns a copy. A config whose model the
port does not have yet stays registered; building it raises
`models.get_model`'s "unknown model", which names the model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    name: str
    task: str  # classification | detection | pose | centernet | dcgan | cyclegan
    model: str
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    input_shape: Tuple[int, ...] = (224, 224, 3)
    num_classes: int = 1000
    batch_size: int = 128  # global batch (reference: per-replica x replicas)
    epochs: int = 90
    optimizer: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"name": "sgd", "learning_rate": 0.01}
    )
    schedule: Optional[Dict[str, Any]] = None  # make_schedule kwargs
    plateau: Optional[Dict[str, Any]] = None  # ReduceLROnPlateau kwargs
    plateau_metric: str = "top1"
    dataset: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"kind": "fake"}
    )
    loss_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    eval_crop: int = 224
    train_resize: int = 256

    def __post_init__(self):
        # One LR policy per recipe: the Trainer sets a scheduled LR before
        # every update, which would overwrite whatever absolute value the
        # plateau wrote between epochs.
        if self.schedule is not None and self.plateau is not None:
            raise ValueError(
                f"config '{self.name}' sets both 'schedule' and 'plateau': "
                "a scheduled learning rate is re-evaluated before every "
                "step and would silently override plateau scaling — pick "
                "one LR policy"
            )


CONFIG_REGISTRY: Dict[str, ExperimentConfig] = {}


def register_config(cfg: ExperimentConfig) -> ExperimentConfig:
    CONFIG_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ExperimentConfig:
    if name not in CONFIG_REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(CONFIG_REGISTRY)}")
    return dataclasses.replace(CONFIG_REGISTRY[name])  # copy: callers mutate


# -- classifiers (ImageNet unless noted) ------------------------------------

register_config(ExperimentConfig(
    # LeNet/pytorch/train.py:15-32: Adam 1e-3, plateau(max, 0.1), batch 64
    name="lenet5", task="classification", model="lenet5",
    input_shape=(32, 32, 1), num_classes=10, batch_size=64, epochs=50,
    optimizer={"name": "adam", "learning_rate": 1e-3},
    plateau={"factor": 0.1, "mode": "max"},
    dataset={"kind": "mnist"},
))

for _name, _model, _bs, _wd in (
    # ResNet/pytorch/train.py:26-48 (alexnet1/2): SGD .01/.9/5e-4, plateau
    ("alexnet1", "alexnet1", 128, 5e-4),
    ("alexnet2", "alexnet2", 128, 5e-4),
):
    register_config(ExperimentConfig(
        name=_name, task="classification", model=_model,
        batch_size=_bs, epochs=90,
        optimizer={"name": "sgd", "learning_rate": 0.01, "momentum": 0.9,
                   "weight_decay": _wd},
        plateau={"factor": 0.1, "mode": "max"},
        dataset={"kind": "imagenet"},
    ))

for _name, _model, _bs in (("vgg16", "vgg16", 128), ("vgg19", "vgg19", 64)):
    # ResNet/pytorch/train.py:50-92: SGD .01/.9/5e-4, StepLR(10, 0.5)
    register_config(ExperimentConfig(
        name=_name, task="classification", model=_model,
        batch_size=_bs, epochs=90,
        optimizer={"name": "sgd", "learning_rate": 0.01, "momentum": 0.9,
                   "weight_decay": 5e-4},
        schedule={"kind": "step", "step_size_epochs": 10, "gamma": 0.5},
        dataset={"kind": "imagenet"},
    ))

register_config(ExperimentConfig(
    # ResNet/pytorch/train.py:94-140: SGD .01/.9/2e-4, poly decay sqrt
    name="inception1", task="classification", model="inception1",
    batch_size=128, epochs=90,
    optimizer={"name": "sgd", "learning_rate": 0.01, "momentum": 0.9,
               "weight_decay": 2e-4},
    schedule={"kind": "poly", "power": 0.5, "total_epochs": 60},
    dataset={"kind": "imagenet"},
    loss_kwargs={"aux_weight": 0.3},
))

register_config(ExperimentConfig(
    # finished properly here; reference stub is 6 lines (inception_v3.py)
    name="inception3", task="classification", model="inception3",
    input_shape=(299, 299, 3), batch_size=128, epochs=100,
    optimizer={"name": "rmsprop", "learning_rate": 0.045, "alpha": 0.9,
               "eps": 1.0},
    schedule={"kind": "step", "step_size_epochs": 2, "gamma": 0.94},
    dataset={"kind": "imagenet"}, train_resize=320, eval_crop=299,
))

for _name, _model, _mkw in (
    ("resnet34", "resnet34", {}),
    # flagship: space-to-depth stem (math-equal to conv7;
    # models/resnet.py SpaceToDepthStem) — the config bench.py reproduces
    ("resnet50", "resnet50", {"stem": "s2d"}),
    ("resnet152", "resnet152", {}), ("resnet50v2", "resnet50v2", {}),
):
    # ResNet/pytorch/train.py:142-215: SGD .1/.9/1e-4, batch 256, plateau(max)
    register_config(ExperimentConfig(
        name=_name, task="classification", model=_model,
        model_kwargs=_mkw, batch_size=256, epochs=90,
        optimizer={"name": "sgd", "learning_rate": 0.1, "momentum": 0.9,
                   "weight_decay": 1e-4},
        plateau={"factor": 0.1, "mode": "max"},
        dataset={"kind": "imagenet"},
    ))

register_config(ExperimentConfig(
    # ResNet/pytorch/train.py:185-214: RMSprop .045/alpha .9/eps 1, StepLR(2,.94)
    name="mobilenet1", task="classification", model="mobilenet1",
    model_kwargs={"alpha": 1.0}, batch_size=128, epochs=90,
    optimizer={"name": "rmsprop", "learning_rate": 0.045, "alpha": 0.9,
               "eps": 1.0},
    schedule={"kind": "step", "step_size_epochs": 2, "gamma": 0.94},
    dataset={"kind": "imagenet"},
))

register_config(ExperimentConfig(
    # implemented for real here (reference ships a 0-byte file, SURVEY.md §2.9);
    # recipe from the ShuffleNet paper: SGD, linear decay
    name="shufflenet1", task="classification", model="shufflenet1",
    model_kwargs={"groups": 3}, batch_size=256, epochs=90,
    optimizer={"name": "sgd", "learning_rate": 0.1, "momentum": 0.9,
               "weight_decay": 4e-5},
    schedule={"kind": "poly", "power": 1.0, "total_epochs": 90},
    dataset={"kind": "imagenet"},
))

# -- detection / pose / generative ------------------------------------------

register_config(ExperimentConfig(
    # YOLO/tensorflow/train.py:13-17,46-47: Adam 1e-3, batch 16/replica,
    # 416 input, 80 classes (COCO), manual plateau on val loss :56-68
    name="yolov3_coco", task="detection", model="yolov3",
    input_shape=(416, 416, 3), num_classes=80, batch_size=16, epochs=300,
    optimizer={"name": "adam", "learning_rate": 1e-3},
    plateau={"factor": 0.3, "patience": 5, "mode": "min"},
    plateau_metric="loss",
    dataset={"kind": "records", "schema": "coco"},
))

register_config(ExperimentConfig(
    name="yolov3_voc", task="detection", model="yolov3",
    input_shape=(416, 416, 3), num_classes=20, batch_size=16, epochs=300,
    optimizer={"name": "adam", "learning_rate": 1e-3},
    plateau={"factor": 0.3, "patience": 5, "mode": "min"},
    plateau_metric="loss",
    dataset={"kind": "records", "schema": "voc"},
))

register_config(ExperimentConfig(
    # Hourglass/tensorflow/main.py:21-43 defaults: Adam, 64x64x16 heatmaps
    name="hourglass_mpii", task="pose", model="hourglass",
    model_kwargs={"num_stack": 4, "num_heatmap": 16},
    input_shape=(256, 256, 3), num_classes=16, batch_size=16, epochs=100,
    optimizer={"name": "adam", "learning_rate": 2.5e-4},
    plateau={"factor": 0.5, "patience": 5, "mode": "min"},
    plateau_metric="loss",
    dataset={"kind": "records", "schema": "mpii"},
))

register_config(ExperimentConfig(
    # ObjectsAsPoints completed (reference never finished the losses,
    # train.py:35): paper recipe Adam 1.25e-4
    name="centernet_coco", task="centernet", model="objects_as_points",
    model_kwargs={"num_stack": 2},
    input_shape=(512, 512, 3), num_classes=80, batch_size=32, epochs=140,
    optimizer={"name": "adam", "learning_rate": 1.25e-4},
    schedule={"kind": "step", "step_size_epochs": 90, "gamma": 0.1},
    dataset={"kind": "records", "schema": "coco"},
))

register_config(ExperimentConfig(
    # DCGAN/tensorflow/main.py:13-17,42-53: Adam 1e-4, batch 256, MNIST
    name="dcgan_mnist", task="dcgan", model="dcgan",
    input_shape=(28, 28, 1), batch_size=256, epochs=50,
    optimizer={"name": "adam", "learning_rate": 1e-4},
    dataset={"kind": "mnist"},
))

register_config(ExperimentConfig(
    # CycleGAN/tensorflow/train.py:14-21,126-131: Adam 2e-4 beta1 .5,
    # batch 1, 200 epochs, linear decay after 100
    name="cyclegan", task="cyclegan", model="cyclegan",
    input_shape=(256, 256, 3), batch_size=1, epochs=200,
    optimizer={"name": "adam", "learning_rate": 2e-4, "b1": 0.5},
    schedule={"kind": "linear_decay", "hold_epochs": 100, "total_epochs": 200},
    dataset={"kind": "records", "schema": "image_only"},
))

# -- attention family (net-new; no reference counterpart) -------------------

for _name, _model, _mkw in (
    ("vit_s16", "vit_s16", {}),
    ("vmoe_s16", "vmoe_s16", {}),
):
    # AdamW recipe (ViT paper, app. B.1 scaled to single-host): decoupled
    # weight decay, linear warmup + cosine decay via the schedule registry
    register_config(ExperimentConfig(
        name=_name, task="classification", model=_model,
        model_kwargs=_mkw, batch_size=256, epochs=90,
        optimizer={"name": "adamw", "learning_rate": 1e-3,
                   "weight_decay": 1e-4},
        schedule={"kind": "cosine", "warmup_epochs": 5,
                  "total_epochs": 90},
        dataset={"kind": "imagenet"},
    ))
