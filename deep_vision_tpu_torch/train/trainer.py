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

Device prefetch (`device_prefetch=N`, the reference's
`_run_epoch` and `_place_one`): `fit` runs each epoch's host batches
through a `data.DevicePrefetcher`, whose producer thread places up to N
batches ahead of the step. On the card `_place_one` pins each array
(PyTorch's caching host allocator reuses the pinned blocks), copies it
on the Trainer's one copy stream and records an event there (one stream
for every epoch's producer thread, so the caching allocator hands each
epoch the device blocks the last one freed);
`train_step` makes its own stream wait on that event before the step
and marks every placed tensor as used by that stream (`record_stream`),
so the caching allocator does not hand the memory back to the copy
stream while the step still reads it. A missed wait would read a batch
that is still being copied, silently.

Not ported yet: checkpoints, the run journal and telemetry, EMA weights,
multistep supersteps, profiler windows, plateau LR, the non-finite skip
policy, meshes and sharding.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
from torch import nn

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.core.train_state import create_train_state
from deep_vision_tpu_torch.data.device_prefetch import (
    DevicePrefetcher,
    PlacedBatch,
)
from deep_vision_tpu_torch.train.optimizers import set_lr


class Trainer:
    """loss_fn(outputs, batch) -> (loss, metrics dict). `tx` builds the
    optimizer from the model (`train.optimizers.build_optimizer`);
    `lr_schedule` (step -> lr) defaults to its `schedule`, if any;
    `device_prefetch` > 0 places that many batches ahead in `fit`."""

    def __init__(self, model: nn.Module,
                 tx: Callable[[nn.Module], torch.optim.Optimizer],
                 loss_fn: Callable, sample_input,
                 eval_loss_fn: Optional[Callable] = None,
                 input_key: str = "image", device: DeviceLike = None,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 device_prefetch: int = 0):
        self.device = resolve_device(device)
        self.lr_schedule = lr_schedule or getattr(tx, "schedule", None)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn or loss_fn
        self.input_key = input_key
        self.state = create_train_state(model, tx, sample_input,
                                        device=self.device)
        self.prefetcher = (DevicePrefetcher(self._place_one,
                                            depth=device_prefetch)
                           if device_prefetch > 0 else None)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

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

    def _place_one(self, batch: dict) -> PlacedBatch:
        """Host batch -> on the device with its `_mask`, off the step's
        stream: on the card, pinned and copied on `copy_stream`, with the
        event `ready` recorded after the copies."""
        n = self._rows(batch)
        if self.device.type != "cuda":
            return PlacedBatch(self._pad_and_mask(batch), n)
        stream = self.copy_stream
        with torch.cuda.stream(stream):
            data = {k: torch.as_tensor(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            if "_mask" not in data:
                data["_mask"] = torch.ones(len(data[self.input_key]),
                                           dtype=torch.float32,
                                           device=self.device)
            ready = torch.cuda.Event()
            ready.record(stream)
        return PlacedBatch(data, n, ready=ready)

    def _on_device(self, batch: Union[dict, PlacedBatch]) -> dict:
        """The batch as the step reads it: a host batch placed on the
        step's stream (`_pad_and_mask`), or a placed one made safe to
        read there: the stream waits for its copies, and its tensors are
        marked as used by the stream."""
        if not isinstance(batch, PlacedBatch):
            return self._pad_and_mask(batch)
        if batch.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.ready)
            for t in batch.data.values():
                t.record_stream(stream)
        return batch.data

    def train_step(self, batch: Union[dict, PlacedBatch]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a host batch or a `PlacedBatch`; returns
        the metrics as device scalars."""
        batch = self._on_device(batch)
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

    def eval_step(self, batch: Union[dict, PlacedBatch]
                  ) -> Dict[str, torch.Tensor]:
        batch = self._on_device(batch)
        model = self.state.model
        model.eval()
        with torch.no_grad():
            _, metrics = self.eval_loss_fn(model(batch[self.input_key]),
                                           batch)
        return metrics

    def _rows(self, batch: Union[dict, PlacedBatch]) -> int:
        """Valid rows of a batch: a placed batch's `n`; a host batch's
        mask's sum, else its length."""
        if isinstance(batch, PlacedBatch):
            return batch.n
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
        `evaluate(eval_data_fn())` when given; with `device_prefetch`,
        each epoch's batches come through the prefetcher. Returns one
        record per epoch: {"epoch", "train": row-weighted step metrics,
        "val"}."""
        history = []
        for epoch in range(epochs):
            data = train_data_fn()
            if self.prefetcher is not None:
                data = self.prefetcher(data)
            record = {"epoch": epoch,
                      "train": self._run(data, self.train_step)}
            if eval_data_fn is not None:
                record["val"] = self.evaluate(eval_data_fn())
            history.append(record)
        return history
