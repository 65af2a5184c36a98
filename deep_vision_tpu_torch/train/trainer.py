"""The Trainer, a first subset of deep_vision_tpu/train/trainer.py.

One model, one optimizer and one loss on one device: `train_step`
follows `_train_step_impl` (trainer.py:589-627): the model runs in
training mode on `batch[input_key]` (BatchNorm normalises with batch
statistics and updates its running ones), `loss_fn(outputs, batch)`
gives `(loss, metrics)`, the gradients of the loss update the
parameters, and the metrics gain `grad_norm`, the global L2 norm of the
gradients. As on one device in the reference (`_pad_and_mask`), every
batch gets a `_mask` of ones unless it has one, so the loss takes its
weighted path. `eval_step`, `evaluate` and `fit` loop over steps.

A learning-rate schedule (`lr_schedule`, by default the optimizer
spec's own when `build_optimizer` was given one) sets every parameter
group's lr to `lr_schedule(step)` before each update, where `step`
counts the updates taken so far: the count optax's `inject_hyperparams`
evaluates the reference's schedule at.

Not ported yet: checkpoints, the run journal and telemetry, EMA weights,
multistep supersteps, device prefetch, profiler windows, plateau LR,
the non-finite skip policy, meshes and sharding.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.core.train_state import create_train_state
from deep_vision_tpu_torch.train.optimizers import set_lr


class Trainer:
    """loss_fn(outputs, batch) -> (loss, metrics dict). `tx` builds the
    optimizer from the model (`train.optimizers.build_optimizer`);
    `lr_schedule` (step -> lr) defaults to its `schedule`, if any."""

    def __init__(self, model: nn.Module,
                 tx: Callable[[nn.Module], torch.optim.Optimizer],
                 loss_fn: Callable, sample_input,
                 eval_loss_fn: Optional[Callable] = None,
                 input_key: str = "image", device: DeviceLike = None,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        self.device = resolve_device(device)
        self.lr_schedule = lr_schedule or getattr(tx, "schedule", None)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn or loss_fn
        self.input_key = input_key
        self.state = create_train_state(model, tx, sample_input,
                                        device=self.device)

    @property
    def model(self) -> nn.Module:
        return self.state.model

    def _pad_and_mask(self, batch: dict) -> dict:
        """The batch on the device, with a `_mask` of ones if it has none
        (one device: nothing to pad)."""
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        if "_mask" not in out:
            n = out[self.input_key].shape[0]
            out["_mask"] = torch.ones(n, dtype=torch.float32,
                                      device=self.device)
        return out

    def train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the metrics as device scalars."""
        batch = self._pad_and_mask(batch)
        model, opt = self.state.model, self.state.optimizer
        model.train()
        loss, metrics = self.loss_fn(model(batch[self.input_key]), batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        if self.lr_schedule is not None:
            set_lr(opt, self.lr_schedule(self.state.step))
        opt.step()
        self.state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        batch = self._pad_and_mask(batch)
        model = self.state.model
        model.eval()
        with torch.no_grad():
            _, metrics = self.eval_loss_fn(model(batch[self.input_key]),
                                           batch)
        return metrics

    def _rows(self, batch: dict) -> int:
        """Valid rows of a host batch: the mask's sum, else its length."""
        if "_mask" in batch:
            return int(torch.as_tensor(batch["_mask"]).sum())
        return len(batch[self.input_key])

    def evaluate(self, eval_data: Iterable[dict]) -> Dict[str, float]:
        """Metrics over `eval_data`, each batch weighted by its valid
        rows."""
        return self._run(eval_data, self.eval_step)

    def _run(self, data: Iterable[dict], step: Callable) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        rows = 0
        for batch in data:
            n = self._rows(batch)
            for k, v in step(batch).items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            rows += n
        return {k: v / max(rows, 1) for k, v in totals.items()}

    def fit(self, train_data_fn: Callable[[], Iterable[dict]],
            eval_data_fn: Optional[Callable[[], Iterable[dict]]] = None,
            epochs: int = 1) -> List[dict]:
        """`epochs` passes over `train_data_fn()`, each followed by
        `evaluate(eval_data_fn())` when given. Returns one record per
        epoch: {"epoch", "train": row-weighted step metrics, "val"}."""
        history = []
        for epoch in range(epochs):
            record = {"epoch": epoch,
                      "train": self._run(train_data_fn(), self.train_step)}
            if eval_data_fn is not None:
                record["val"] = self.evaluate(eval_data_fn())
            history.append(record)
        return history
