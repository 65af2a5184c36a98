"""deep_vision_tpu_torch: the PyTorch/CUDA port of deep_vision_tpu.

The JAX package `deep_vision_tpu` is the reference; this package mirrors
its module names (core/, nn/, models/, ops/, serve/, obs/, inference.py)
so each counterpart is easy to find, and imports nothing from it. Plain
tensor code is PyTorch; every Pallas TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper under `csrc/`, built at first use
by `ops/cuda/build.py`.

Entry points (`models.get_model`, `serve.Engine`,
`inference.make_yolo_detector`, `train.Trainer`, and the training CLI
`python -m deep_vision_tpu_torch.train_cli`) run on `cuda` unless the
caller passes `device="cpu"` (`--device cpu`); asking for `cuda` on a
machine without a card raises.
"""
