"""GAN trainers, the port of deep_vision_tpu/train/gan.py (:37-392):
DCGAN's simultaneous G/D update and CycleGAN's two generators, two
discriminators and two image pools.

Each sub-network is its own TrainState (model, optimizer, step,
generator) with its own optimizer, as in the reference.

`DcganTrainer.train_step(real)` follows `_step_impl` (:128-159): one
noise batch drives G's adversarial loss (D applied to G's output, the
gradient taken for G only) and D's loss on the real batch and on G's
output detached; both updates are taken from the same pre-step
parameters. The noise and D's three dropout masks (one a D application,
drawn in call order) come from a device generator seeded a step with
`dropout_step_seed(g_state.generator.initial_seed(), g_state.step)`, as
the reference splits `fold_in(g_state.rng, g_state.step)`: a resumed run
draws what a straight one draws. A caller may pass the noise and the
masks (`dropout_masks`: per D application, one mask per Dropout in module
order) to replay a step on another device.

`CycleGanTrainer.train_step(real_a, real_b)` follows :279-392: a G step
over both generators (adversarial LSGAN + cycle + identity losses), then
the host-side `ImagePool` query of both fakes (numpy, `RandomState`
seeds 1 and 2, so its decisions are the reference's bit for bit; the
copy to the host is the step's one sync), then a D step over both
discriminators. The reference keeps the batch statistics of only the
first application of each network in a step (G: on the real input; D:
on the real images) and drops the others'; the port's BatchNorms update
their running statistics in place, so the other applications run between
a snapshot of the buffers and its restore (a no-op with the default
instance norm, which has none).

`save`/`restore` write and read all sub-networks as one step through
`CheckpointManager.save_states` / `restore_states`, under the global
optimizer step, with `{"epoch": ...}` as the host state; `restore`
returns the next epoch to run. `load_variables` loads one JAX variable
tree per sub-network (convert.py), strictly.

The profiler ranges `GAN_STEP_RANGE`, `GAN_POOL_RANGE` and the G and D
step ranges mark the work for tools/profile_train.py, and the trace
spans `gan/step` (both trainers), `gan/g_step`, `gan/pool`, `gan/d_step`
(CycleGAN), `checkpoint/save` and `checkpoint/restore` for obs/trace.py,
as the reference's. Not ported: the
reference's meshes, StepClock telemetry and autoprof; the per-step
journal events are the CLI loop's (train_cli.gan_main).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.core.train_state import (
    TrainState,
    create_train_state,
)
from deep_vision_tpu_torch.losses.gan import (
    bce_discriminator_loss,
    bce_generator_loss,
    cycle_consistency_loss,
    identity_loss,
    lsgan_discriminator_loss,
    lsgan_generator_loss,
)
from deep_vision_tpu_torch.nn.layers import Dropout
from deep_vision_tpu_torch.obs.trace import span
from deep_vision_tpu_torch.train.trainer import dropout_step_seed

GAN_STEP_RANGE = "dvt::gan_step"
GAN_G_STEP_RANGE = "dvt::gan_g_step"
GAN_POOL_RANGE = "dvt::gan_pool"
GAN_D_STEP_RANGE = "dvt::gan_d_step"


class ImagePool:
    """Replay buffer of generated images (CycleGAN/tensorflow/utils.py:
    32-61), host-side numpy, decisions from `RandomState(seed)`."""

    def __init__(self, size: int = 50, seed: int = 0):
        self.size = size
        self.images: List[np.ndarray] = []
        self.rng = np.random.RandomState(seed)

    def query(self, batch: np.ndarray) -> np.ndarray:
        if self.size == 0:
            return batch
        out = []
        for img in np.asarray(batch):
            # copy: a row view would pin the whole batch array in the pool
            if len(self.images) < self.size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.rand() < 0.5:
                idx = self.rng.randint(self.size)
                out.append(self.images[idx])
                self.images[idx] = img.copy()
            else:
                out.append(img)
        return np.stack(out)


@contextlib.contextmanager
def _stats_kept(models: Sequence[nn.Module]):
    """Run the block and put every buffer of `models` back as it was:
    applications whose batch statistics the reference drops."""
    buffers = [b for m in models for b in m.buffers()]
    saved = [b.clone() for b in buffers]
    try:
        yield
    finally:
        if buffers:
            torch._foreach_copy_(buffers, saved)


def _grads(states: Sequence[TrainState], loss: torch.Tensor
           ) -> List[List[torch.Tensor]]:
    """The gradients of `loss` for the states' parameters only, one list
    a state."""
    params = [list(s.model.parameters()) for s in states]
    flat = torch.autograd.grad(loss, [p for ps in params for p in ps])
    out, i = [], 0
    for ps in params:
        out.append(list(flat[i:i + len(ps)]))
        i += len(ps)
    return out


def _apply(state: TrainState, grads: List[torch.Tensor]) -> None:
    """One optimizer step of `state` on `grads`."""
    for p, g in zip(state.model.parameters(), grads):
        p.grad = g
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


class _GanBase:
    """The save/restore/load plumbing shared by both trainers; `states`
    names the sub-networks' TrainStates as the checkpoint keys them."""

    health = None

    def states(self) -> Dict[str, TrainState]:
        raise NotImplementedError

    def _beat(self) -> None:
        if self.health is not None:
            self.health.beat()

    def save(self, ckpt, epoch: int,
             completed_epoch: Optional[int] = None) -> bool:
        """Checkpoint every sub-network under the first one's (global)
        optimizer step; `completed_epoch` (default: epoch) is what
        `restore` resumes after. Returns whether a save started."""
        states = self.states()
        step = next(iter(states.values())).step
        with span("checkpoint/save", epoch=epoch, step=int(step)):
            return bool(ckpt.save_states(step, states, host_state={
                "epoch": (epoch if completed_epoch is None
                          else completed_epoch)}))

    def restore(self, ckpt) -> int:
        """Restore-or-initialize; returns the next epoch to run (0 if
        nothing is saved, or the sidecar has no epoch)."""
        with span("checkpoint/restore"):
            restored, host = ckpt.restore_states(self.states())
        if restored is None:
            return 0
        if not host or "epoch" not in host:
            print("GAN restore: no epoch sidecar; weights restored, "
                  "restarting epoch count at 0")
            return 0
        return int(host["epoch"]) + 1

    def load_variables(self, trees: Mapping[str, Mapping]) -> None:
        """Load the reference's flax variables, one tree per sub-network
        (`{name: {"params": ..., "batch_stats": ...}}`, numpy leaves),
        through convert.variables_from_jax, strictly."""
        from deep_vision_tpu_torch.convert import variables_from_jax

        states = self.states()
        if set(trees) != set(states):
            raise KeyError(f"trees for {sorted(trees)}, sub-networks "
                           f"{sorted(states)}")
        for name, tree in trees.items():
            states[name].model.load_state_dict(variables_from_jax(tree))


class DcganTrainer(_GanBase):
    """G and D updated together from one noise batch a step."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 g_tx: Callable[[nn.Module], torch.optim.Optimizer],
                 d_tx: Callable[[nn.Module], torch.optim.Optimizer],
                 latent_dim: int = 100, image_shape=(28, 28, 1),
                 device: DeviceLike = None, health=None):
        self.device = resolve_device(device)
        self.latent_dim = latent_dim
        self.health = health
        self.g_state = create_train_state(
            generator, g_tx, torch.zeros((2, latent_dim)),
            device=self.device)
        self.d_state = create_train_state(
            discriminator, d_tx, torch.zeros((2, *image_shape)),
            device=self.device)
        self._dropouts = [m for m in discriminator.modules()
                          if isinstance(m, Dropout)]
        self._gen = torch.Generator(device=self.device)

    def states(self) -> Dict[str, TrainState]:
        return {"g": self.g_state, "d": self.d_state}

    def train_step(self, real_images, noise=None,
                   dropout_masks: Optional[Sequence[Sequence]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One G and one D update on `real_images` (B, H, W, C); returns
        {"g_loss", "d_loss"} as device scalars. `noise` (B, latent) and
        `dropout_masks` (three D applications x D's Dropouts) replace
        the draws."""
        g, d = self.g_state.model, self.d_state.model
        g.train()
        d.train()
        with span("gan/step"), torch.profiler.record_function(
                GAN_STEP_RANGE):
            real = torch.as_tensor(real_images).to(self.device,
                                                   non_blocking=True)
            self._gen.manual_seed(dropout_step_seed(
                self.g_state.generator.initial_seed(), self.g_state.step))
            if noise is None:
                noise = torch.randn((real.shape[0], self.latent_dim),
                                    generator=self._gen, device=self.device)
            else:
                noise = torch.as_tensor(noise).to(self.device)
            for i, m in enumerate(self._dropouts):
                m.generator = self._gen
                m.replay = ([list(app)[i] for app in dropout_masks]
                            if dropout_masks is not None else [])
            fake = g(noise)
            g_loss = bce_generator_loss(d(fake))
            (g_grads,) = _grads([self.g_state], g_loss)
            fake = fake.detach()
            d_loss = bce_discriminator_loss(d(real), d(fake))
            (d_grads,) = _grads([self.d_state], d_loss)
            _apply(self.g_state, g_grads)
            _apply(self.d_state, d_grads)
        self._beat()
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach()}


class CycleGanTrainer(_GanBase):
    """A <-> B translation: G_ab, G_ba, D_a, D_b and two image pools."""

    def __init__(self, gen_ab: nn.Module, gen_ba: nn.Module,
                 disc_a: nn.Module, disc_b: nn.Module, g_tx_fn: Callable,
                 d_tx_fn: Callable, image_shape=(256, 256, 3),
                 pool_size: int = 50, device: DeviceLike = None,
                 health=None):
        self.device = resolve_device(device)
        self.health = health
        sample = torch.zeros((2, *image_shape))

        def state(model, tx):
            return create_train_state(model, tx, sample, device=self.device)

        self.gab = state(gen_ab, g_tx_fn())
        self.gba = state(gen_ba, g_tx_fn())
        self.da = state(disc_a, d_tx_fn())
        self.db = state(disc_b, d_tx_fn())
        self.pool_a = ImagePool(pool_size, seed=1)
        self.pool_b = ImagePool(pool_size, seed=2)

    def states(self) -> Dict[str, TrainState]:
        return {"gab": self.gab, "gba": self.gba, "da": self.da,
                "db": self.db}

    def _g_step(self, real_a, real_b):
        gab, gba = self.gab.model, self.gba.model
        da, db = self.da.model, self.db.model
        fake_b = gab(real_a)
        fake_a = gba(real_b)
        with _stats_kept((gab, gba, da, db)):
            cycled_a, cycled_b = gba(fake_b), gab(fake_a)
            same_a, same_b = gba(real_a), gab(real_b)
            adv = (lsgan_generator_loss(db(fake_b))
                   + lsgan_generator_loss(da(fake_a)))
        cyc = (cycle_consistency_loss(real_a, cycled_a)
               + cycle_consistency_loss(real_b, cycled_b))
        ident = identity_loss(real_a, same_a) + identity_loss(real_b, same_b)
        total = adv + cyc + ident
        for state, grads in zip((self.gab, self.gba),
                                _grads((self.gab, self.gba), total)):
            _apply(state, grads)
        metrics = {"g_loss": total, "g_adv": adv, "g_cycle": cyc,
                   "g_identity": ident}
        return ({k: v.detach() for k, v in metrics.items()},
                fake_a.detach(), fake_b.detach())

    def _d_step(self, real_a, real_b, fake_a, fake_b):
        da, db = self.da.model, self.db.model
        ra = da(real_a)
        with _stats_kept((da,)):
            fa = da(fake_a)
        rb = db(real_b)
        with _stats_kept((db,)):
            fb = db(fake_b)
        loss = (lsgan_discriminator_loss(ra, fa)
                + lsgan_discriminator_loss(rb, fb))
        for state, grads in zip((self.da, self.db),
                                _grads((self.da, self.db), loss)):
            _apply(state, grads)
        return {"d_loss": loss.detach()}

    def train_step(self, real_a, real_b) -> Dict[str, torch.Tensor]:
        """G step, pool query, D step; returns the G and D metrics as
        device scalars."""
        for s in self.states().values():
            s.model.train()
        with span("gan/step"), torch.profiler.record_function(
                GAN_STEP_RANGE):
            real_a = torch.as_tensor(real_a).to(self.device,
                                                non_blocking=True)
            real_b = torch.as_tensor(real_b).to(self.device,
                                                non_blocking=True)
            with span("gan/g_step"), torch.profiler.record_function(
                    GAN_G_STEP_RANGE):
                g_metrics, fake_a, fake_b = self._g_step(real_a, real_b)
            # the pool's host copy is the step's sync point
            with span("gan/pool"), torch.profiler.record_function(
                    GAN_POOL_RANGE):
                fake_a = torch.from_numpy(self.pool_a.query(
                    fake_a.cpu().numpy())).to(self.device)
                fake_b = torch.from_numpy(self.pool_b.query(
                    fake_b.cpu().numpy())).to(self.device)
            with span("gan/d_step"), torch.profiler.record_function(
                    GAN_D_STEP_RANGE):
                d_metrics = self._d_step(real_a, real_b, fake_a, fake_b)
        self._beat()
        return {**g_metrics, **d_metrics}
