"""Model accounting: the port of deep_vision_tpu/core/summary.py.

`count_params` is what the training CLI prints for every run;
`model_summary` is its `--summary` table (the analog of torchsummary's
`summary(net, (3, 224, 224))`): one row per parameter, under the port's
own names and shapes (OIHW convolution kernels, not flax's HWIO), then
the reference's totals, which count the same numbers.
"""
from __future__ import annotations

import torch
from torch import nn


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm running statistics are buffers,
    not counted, as the reference counts `params` only)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def param_bytes(model: nn.Module) -> int:
    """Bytes of the trainable parameters, at their storage dtype."""
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if p.requires_grad)


def _stat_count(model: nn.Module) -> int:
    """Elements of the BatchNorms' running means and variances: every
    buffer but torch's `num_batches_tracked` (the port's BatchNorm,
    nn/layers.py, registers only `mean` and `var`)."""
    return sum(b.numel() for name, b in model.named_buffers()
               if not name.endswith("num_batches_tracked"))


def model_summary(model: nn.Module, sample_input) -> str:
    """The table string: parameter, shape and count a row, then
    `trainable params: N (X MB)`, `batch-norm stats: M` and `total:`.
    `sample_input` runs through the model once in eval mode without
    gradients (as the reference's abstract init does): a model that
    does not take it fails here. The model's mode is restored."""
    was_training = model.training
    try:
        device = next(model.parameters()).device
    except StopIteration:
        device = torch.device("cpu")
    with torch.no_grad():
        model.eval()(torch.as_tensor(sample_input).to(device))
    model.train(was_training)
    rows = [(name, tuple(p.shape), p.numel())
            for name, p in model.named_parameters() if p.requires_grad]
    name_w = max([len(r[0]) for r in rows] + [len("parameter")])
    shape_w = max([len(str(r[1])) for r in rows] + [len("shape")])
    lines = [f"{'parameter':<{name_w}}  {'shape':<{shape_w}}  count",
             "-" * (name_w + shape_w + 12)]
    for path, shape, count in rows:
        lines.append(f"{path:<{name_w}}  {str(shape):<{shape_w}}  {count:,}")
    n_params = count_params(model)
    n_stats = _stat_count(model)
    lines += ["-" * (name_w + shape_w + 12),
              f"trainable params: {n_params:,} "
              f"({param_bytes(model) / 1e6:.1f} MB)",
              f"batch-norm stats: {n_stats:,}",
              f"total: {n_params + n_stats:,}"]
    return "\n".join(lines)
