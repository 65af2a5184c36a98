"""Optimizers and schedules, the port of deep_vision_tpu/train/optimizers.py:
every optimizer of its `build_optimizer` (sgd, adam, adamw, rmsprop,
lamb) with masked weight decay, `grad_clip_norm` and `state_dtype`,
every named schedule (constant, step, poly, linear_decay, cosine) and
the host-side `ReduceLROnPlateau`. Each reproduces optax's arithmetic,
which is not always PyTorch's default.

SGD: the reference chains `optax.add_decayed_weights(wd, mask)` and
`optax.sgd(lr, momentum, nesterov)`: u = g + wd * p where the mask
allows it, then the trace t = u + m * t from zeros, then
p -= lr * t (nesterov: p -= lr * (u + m * t)). `torch.optim.SGD` with
two parameter groups (weight decay wd and 0) computes the same
arithmetic.

AdamW: the reference calls `optax.adamw(lr, b1, b2, weight_decay=wd,
mask)` and passes no eps, so optax's default 1e-8 always holds:
p -= lr * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p). `torch.optim.AdamW`
decays first (p *= 1 - lr * wd), then takes the same Adam step: the
same arithmetic up to rounding. eps (1e-8) and weight_decay are passed
explicitly (torch's AdamW defaults to weight_decay 1e-2); any other eps
for "adamw" raises, since the reference would ignore it. "sgd" ignores
eps.

The mask is by flax name (`_decay_mask`, optimizers.py:29-40): a
parameter is exempt when its name ends in `bias` or `scale` or contains
`BatchNorm`; `decay_bn_bias=True` decays everything.

Adam: `optax.adam(lr, b1, b2, eps)` after `add_decayed_weights`:
u = g + wd * p, m = b1 m + (1 - b1) u, v = b2 v + (1 - b2) u^2,
p -= lr * m_hat / (sqrt(v_hat) + eps) with m_hat = m / (1 - b1^t) and
v_hat = v / (1 - b2^t): `torch.optim.Adam` (its weight_decay adds wd * p
to the gradient) computes the same arithmetic up to rounding, eps outside
the square root as in optax.

RMSprop (`RMSprop` below): optax puts eps inside the square root and
starts the second moment at 0, and applies the learning rate before the
momentum trace: nu = a nu + (1 - a) u^2, t = m t - lr u / sqrt(nu + eps),
p += t. `torch.optim.RMSprop` puts eps outside the square root, which at
the configs' eps = 1.0 is a different optimizer.

LAMB (`Lamb` below): `optax.lamb(lr, weight_decay, mask)` with optax's
b1 0.9, b2 0.999 and eps 1e-6: the Adam direction r = m_hat /
(sqrt(v_hat) + eps), plus wd * p where the mask allows, scaled per
tensor by the trust ratio ||p|| / ||r|| (1 where either norm is 0),
then p -= lr * r. PyTorch has no LAMB.

`grad_clip_norm`: `optax.clip_by_global_norm`, first in the reference's
chain: with n the global L2 norm of the gradients, each gradient g
becomes g / n * max_norm unless n < max_norm, before the update (a step
pre-hook on the optimizer, with no host sync).

`state_dtype` ("bfloat16"): `cast_optimizer_state` stores the optimizer's
float state (momentum, moments) in that dtype and computes each update
in float32: a step pre-hook widens the state to float32 and a post-hook
rounds it back once, after the update, as optax does. Step counters stay
as they are.

The learning rate is a float or a schedule, step -> lr. With a schedule
the optimizer starts at schedule(0), and the Trainer sets every group to
schedule(step) before each update, where step counts the updates taken,
as optax's `inject_hyperparams` counts them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
from torch import nn

from deep_vision_tpu_torch.convert import flax_path

Schedule = Union[float, Callable[[int], float]]
#: optax.adamw's default eps, the only one the reference's adamw uses
ADAMW_EPS = 1e-8


def decay_mask(names: Iterable[str], decay_bn_bias: bool) -> Dict[str, bool]:
    """state_dict parameter names -> True where weight decay applies."""
    mask = {}
    for name in names:
        path = flax_path(name)
        exempt = (path.endswith("bias") or "BatchNorm" in path
                  or path.endswith("scale"))
        mask[name] = decay_bn_bias or not exempt
    return mask


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule(0, base_lr, warmup_steps,
    total_steps, end_lr)`: linear from 0 to base_lr over warmup_steps,
    then a cosine from base_lr to end_lr over total_steps - warmup_steps,
    end_lr after."""
    if total_steps - warmup_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr
    decay = total_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * max(step, 0) / warmup_steps
        count = min(step - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def step_decay(base_lr: float, step_size: int,
               gamma: float = 0.1) -> Callable[[int], float]:
    """`optax.exponential_decay(base_lr, step_size, gamma,
    staircase=True)`, torch's StepLR: base_lr * gamma**floor(step /
    step_size); a constant when step_size <= 0 or gamma == 0."""
    if step_size <= 0 or gamma == 0:
        return lambda step: base_lr

    def schedule(step: int) -> float:
        if step <= 0:
            return base_lr
        return base_lr * gamma ** math.floor(step / step_size)

    return schedule


def polynomial(base_lr: float, end_lr: float, power: float,
               total_steps: int) -> Callable[[int], float]:
    """`optax.polynomial_schedule(base_lr, end_lr, power, total_steps)`:
    (base_lr - end_lr) * (1 - t / total)**power + end_lr, t clipped to
    [0, total]; a constant when total_steps <= 0."""
    if total_steps <= 0:
        return lambda step: base_lr

    def schedule(step: int) -> float:
        t = min(max(step, 0), total_steps)
        return (base_lr - end_lr) * (1 - t / total_steps) ** power + end_lr

    return schedule


def linear_decay(base_lr: float, hold_steps: int,
                 total_steps: int) -> Callable[[int], float]:
    """The CycleGAN decay: base_lr for `hold_steps`, then linear to 0
    over `total_steps - hold_steps` (optax.join_schedules of a constant
    and a linear schedule, the second counted from the boundary)."""
    decay = polynomial(base_lr, 0.0, 1.0, total_steps - hold_steps)

    def schedule(step: int) -> float:
        return base_lr if step < hold_steps else decay(step - hold_steps)

    return schedule


def make_schedule(kind: str = "constant", base_lr: float = 0.1,
                  **kw) -> Schedule:
    """The reference's named schedules: "constant" (base_lr), "step"
    (step_size, gamma 0.1), "poly" (total_steps, end_lr 0, power 1),
    "linear_decay" (hold_steps 0, total_steps) and "cosine"
    (warmup_steps, total_steps, end_lr; warmup at least 1 step, as the
    reference clamps it)."""
    if kind == "constant":
        return base_lr
    if kind == "step":
        return step_decay(base_lr, kw["step_size"], kw.get("gamma", 0.1))
    if kind == "poly":
        return polynomial(base_lr, kw.get("end_lr", 0.0),
                          kw.get("power", 1.0), kw["total_steps"])
    if kind == "linear_decay":
        return linear_decay(base_lr, kw.get("hold_steps", 0),
                            kw["total_steps"])
    if kind == "cosine":
        return warmup_cosine(base_lr, max(kw.get("warmup_steps", 0), 1),
                             kw["total_steps"], kw.get("end_lr", 0.0))
    raise ValueError(f"unknown schedule '{kind}'")


class RMSprop(torch.optim.Optimizer):
    """`optax.rmsprop(lr, decay=alpha, eps, momentum)` after masked
    weight decay: eps inside the square root, the second moment from 0,
    the learning rate applied before the momentum trace."""

    def __init__(self, params, lr: float, alpha: float = 0.9,
                 eps: float = 1e-8, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            for p in params:
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        st["trace"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            a = group["alpha"]
            # nu = (1 - a) * u**2 + a * nu, in optax's order
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - a)
            torch._foreach_mul_(nus, a)
            torch._foreach_add_(nus, sq)
            upd = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(upd)
            torch._foreach_mul_(upd, grads)
            torch._foreach_mul_(upd, -group["lr"])
            if group["momentum"]:
                traces = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(traces, group["momentum"])
                torch._foreach_add_(traces, upd)
                upd = traces
            torch._foreach_add_(params, upd)


class Lamb(torch.optim.Optimizer):
    """`optax.lamb(lr, b1, b2, eps, weight_decay)`: the Adam direction
    plus masked weight decay, scaled per tensor by ||p|| / ||r||."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
            count = self.state[params[0]]["step"]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g**2 + b2 nu
            g1 = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, g1)
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            mu_hat = torch._foreach_div(mus, 1 - b1 ** count)
            nu_hat = torch._foreach_div(nus, 1 - b2 ** count)
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, group["eps"])
            r = torch._foreach_div(mu_hat, nu_hat)
            if group["weight_decay"]:
                torch._foreach_add_(r, params, alpha=group["weight_decay"])
            p_norm = torch._foreach_norm(params)
            r_norm = torch._foreach_norm(r)
            for u, pn, rn in zip(r, p_norm, r_norm):
                ratio = torch.where((pn == 0) | (rn == 0),
                                    torch.ones_like(pn), pn / rn)
                u.mul_(ratio)
            torch._foreach_mul_(r, -group["lr"])
            torch._foreach_add_(params, r)


def _float_state(optimizer: torch.optim.Optimizer, dtype) -> None:
    """Cast every float state tensor but step counters to `dtype`."""
    for st in optimizer.state.values():
        for k, v in st.items():
            if (k != "step" and torch.is_tensor(v) and v.is_floating_point()
                    and v.dtype != dtype):
                st[k] = v.to(dtype)


def _clip_by_global_norm(optimizer: torch.optim.Optimizer,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients, on the device."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    for g, c in zip(grads, clipped):
        g.copy_(torch.where(keep, g, c))


@dataclass(frozen=True)
class OptimizerSpec:
    """What `build_optimizer` returns: call it on a model to get the
    torch optimizer over that model's parameters, in two groups (weight
    decay `weight_decay` where the mask allows it, 0 elsewhere), with
    the gradient clip and the state dtype as step hooks."""

    name: str
    learning_rate: Schedule
    weight_decay: float = 0.0
    decay_bn_bias: bool = False
    momentum: float = 0.0
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    alpha: float = 0.9
    grad_clip_norm: Optional[float] = None
    state_dtype: Optional[torch.dtype] = None

    @property
    def schedule(self) -> Optional[Callable[[int], float]]:
        return self.learning_rate if callable(self.learning_rate) else None

    def groups(self, model: nn.Module) -> List[dict]:
        named = list(model.named_parameters())
        mask = decay_mask((n for n, _ in named), self.decay_bn_bias)
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": self.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0},
        ]
        return [g for g in groups if g["params"]]

    def _make(self, model: nn.Module, lr: float) -> torch.optim.Optimizer:
        groups = self.groups(model)
        if self.name == "sgd":
            return torch.optim.SGD(
                groups, lr=lr, momentum=self.momentum,
                nesterov=self.nesterov and self.momentum > 0)
        if self.name == "adamw":
            return torch.optim.AdamW(groups, lr=lr, betas=(self.b1, self.b2),
                                     eps=ADAMW_EPS)
        if self.name == "adam":
            return torch.optim.Adam(groups, lr=lr, betas=(self.b1, self.b2),
                                    eps=self.eps)
        if self.name == "rmsprop":
            return RMSprop(groups, lr=lr, alpha=self.alpha, eps=self.eps,
                           momentum=self.momentum)
        return Lamb(groups, lr=lr, eps=LAMB_EPS)

    def __call__(self, model: nn.Module) -> torch.optim.Optimizer:
        lr = self.schedule(0) if self.schedule else self.learning_rate
        opt = self._make(model, lr)
        if self.grad_clip_norm:
            max_norm = float(self.grad_clip_norm)
            opt.register_step_pre_hook(
                lambda o, args, kwargs: _clip_by_global_norm(o, max_norm))
        if self.state_dtype is not None and \
                self.state_dtype != torch.float32:
            dtype = self.state_dtype
            opt.register_step_pre_hook(
                lambda o, args, kwargs: _float_state(o, torch.float32))
            opt.register_step_post_hook(
                lambda o, args, kwargs: _float_state(o, dtype))
        return opt


#: optax.lamb's eps, the one the reference's lamb uses
LAMB_EPS = 1e-6
OPTIMIZERS = ("sgd", "adam", "adamw", "rmsprop", "lamb")


def build_optimizer(name: str, learning_rate: Schedule, *,
                    weight_decay: float = 0.0, decay_bn_bias: bool = False,
                    grad_clip_norm: Optional[float] = None,
                    state_dtype=None, momentum: float = 0.0,
                    nesterov: bool = False, b1: float = 0.9,
                    b2: float = 0.999, eps: Optional[float] = None,
                    alpha: float = 0.9) -> OptimizerSpec:
    """The reference's `build_optimizer`: "sgd" (momentum, nesterov),
    "adam" (b1, b2, eps 1e-8), "adamw" (b1, b2), "rmsprop" (alpha,
    eps 1e-8, momentum) and "lamb"; `learning_rate` a float or a
    schedule; `state_dtype` a torch dtype or its name. "adamw" and
    "lamb" take only optax's eps (1e-8, 1e-6), the ones the reference
    uses whatever it is given; "sgd" ignores eps."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}'")
    fixed = {"adamw": ADAMW_EPS, "lamb": LAMB_EPS}.get(name)
    if fixed is not None and eps not in (None, fixed):
        raise ValueError(
            f"{name} eps={eps!r}: the reference's {name} ignores eps and "
            f"always uses optax's {fixed}; pass no eps")
    if isinstance(state_dtype, str):
        state_dtype = getattr(torch, state_dtype)
    if not callable(learning_rate):
        learning_rate = float(learning_rate)
    return OptimizerSpec(name, learning_rate, float(weight_decay),
                         bool(decay_bn_bias), float(momentum), bool(nesterov),
                         float(b1), float(b2),
                         float(1e-8 if eps is None else eps), float(alpha),
                         grad_clip_norm, state_dtype)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate to an absolute value (`_set_lr`,
    trainer.py:53)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class ReduceLROnPlateau:
    """Host-side plateau schedule (optimizers.py:221-272): `step(metric)`
    once an epoch returns the LR multiplier, which the Trainer applies
    to the base learning rate. Its state_dict is the reference's."""

    def __init__(self, factor=0.1, patience=10, mode="max", threshold=1e-4,
                 min_scale=0.0):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.threshold = threshold
        # LR floor as a fraction of the base LR (torch's min_lr / base_lr)
        self.min_scale = min_scale
        self.best = None
        self.num_bad = 0
        self.scale = 1.0

    def _is_better(self, v):
        if self.best is None:
            return True
        if self.mode == "max":
            return v > self.best + self.threshold
        return v < self.best - self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad = 0
        return self.scale

    def state_dict(self):
        return {"best": self.best, "num_bad": self.num_bad,
                "scale": self.scale}

    def load_state_dict(self, d):
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.scale = d["scale"]
