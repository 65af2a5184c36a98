"""Port parity: train/optimizers.py's schedules, optimizers, gradient clip,
low-precision state and ReduceLROnPlateau against the JAX package's
optax chains, on the CPU.

The same random parameters (a convolution kernel, a BatchNorm's scale
and bias, a dense kernel and bias, under their flax names so the weight
decay mask exempts what the reference's exempts; drawn with numpy) and
the same random gradients go through the reference's `build_optimizer`
and the port's for five steps.

Tolerances, each with its reason:
- schedules: rtol 1e-6, atol 1e-8 over steps 0-500. optax evaluates in
  float32, the port in float64: intermediates of the size of the base lr
  (0.045) round to ~4e-9, which dominates near the end of a decay.
- optimizers: rtol = atol = 1e-6 on the parameters after five steps
  (tests/test_torch_train.py's optimizer tolerance): the same float32
  arithmetic, but PyTorch may fuse a multiply-add that optax rounds twice
  and its Adam divides by the bias corrections in another order, an ulp
  or two a step. bfloat16 optimizer state: XLA may fuse the state
  update's multiply-add that PyTorch rounds twice, and a state element
  whose two float32 values differ by that ulp can round to neighbouring
  bf16 values, 2**-8 of its magnitude apart; each later update then moves
  the parameter by up to lr x that much. So the parameters within atol
  STEPS x lr x 2**-8 x the largest stored state, and the stored momentum
  within one bf16 ulp (2**-8 relative).
- ReduceLROnPlateau: exact (the same host arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_vision_tpu.train.optimizers import ReduceLROnPlateau as RefPlateau
from deep_vision_tpu.train.optimizers import build_optimizer as jax_build
from deep_vision_tpu.train.optimizers import make_schedule as jax_schedule
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.train.optimizers import (
    ReduceLROnPlateau,
    RMSprop,
    build_optimizer,
    make_schedule,
)

TIGHT = dict(rtol=1e-6, atol=1e-6)
STEPS = 5
BF16_LR = 1e-2
BF16_ATOL_PER_STATE = STEPS * BF16_LR * 2 ** -8


#: flax name -> shape of the parameters
SHAPES = {"Conv_0": {"kernel": (3, 3, 4, 8)},
          "BatchNorm_0": {"scale": (8,), "bias": (8,)},
          "Dense_0": {"kernel": (8, 10), "bias": (10,)}}


class _Params(torch.nn.Module):
    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.zeros(shape)))


class Tiny(torch.nn.Module):
    """The port's names for SHAPES (OIHW conv and (out, in) dense)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = _Params(weight=(8, 4, 3, 3))
        self.BatchNorm_0 = _Params(scale=(8,), bias=(8,))
        self.Dense_0 = _Params(weight=(10, 8), bias=(10,))


def pair(seed):
    """The port's module and the reference's params tree, equal, drawn
    from numpy."""
    rng = np.random.RandomState(seed)
    params = {m: {k: (rng.randn(*shape) * 0.1).astype(np.float32)
                  for k, shape in leaves.items()}
              for m, leaves in SHAPES.items()}
    tm = Tiny()
    tm.load_state_dict(variables_from_jax({"params": params}))
    return tm, params


def run_both(name, lr, seed=0, grad_scale=1.0, **kw):
    """(port parameters, reference parameters, port optimizer, reference
    state) after STEPS updates from the same gradients."""
    tm, params = pair(seed)
    jtx = jax_build(name, lr, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtx.init(jparams)
    update = jax.jit(jtx.update)
    opt = build_optimizer(name, lr, **kw)(tm)
    named = dict(tm.named_parameters())
    rng = np.random.RandomState(seed + 100)
    for _ in range(STEPS):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * grad_scale).astype(np.float32),
            params)
        updates, state = update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in variables_from_jax({"params": grads}).items():
            named[k].grad = g.clone()
        opt.step()
    want = variables_from_jax({"params": jax.device_get(jparams)})
    return named, want, opt, state


def find_trace(state):
    """optax's TraceState.trace inside a (nested) chain state."""
    if hasattr(state, "trace"):
        return state.trace
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = find_trace(sub)
            if found is not None:
                return found
    return None


def assert_params_close(named, want, atol=TIGHT["atol"]):
    for k, w in want.items():
        np.testing.assert_allclose(named[k].detach().numpy(), w.numpy(),
                                   err_msg=k, rtol=TIGHT["rtol"], atol=atol)


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("step", {"step_size": 30, "gamma": 0.5}),
    ("step", {"step_size": 2, "gamma": 0.94}),
    ("step", {"step_size": 0}),
    ("poly", {"total_steps": 400, "power": 0.5}),
    ("poly", {"total_steps": 450, "power": 1.0, "end_lr": 0.001}),
    ("linear_decay", {"hold_steps": 100, "total_steps": 300}),
    ("cosine", {"warmup_steps": 25, "total_steps": 450}),
])
def test_schedule_matches_optax_over_500_steps(kind, kw):
    want = jax_schedule(kind, 0.045, **kw)
    got = make_schedule(kind, 0.045, **kw)
    for step in range(501):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-8, err_msg=f"{kind} {kw} @{step}")


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule("exponential", 0.1)


# -- optimizers -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"weight_decay": 1e-2},
    {"weight_decay": 1e-2, "decay_bn_bias": True, "b1": 0.5},
    {"eps": 1e-3, "b2": 0.99},
])
def test_adam_matches_optax(kw):
    named, want, opt, _ = run_both("adam", 1e-2, **kw)
    assert_params_close(named, want)


@pytest.mark.parametrize("kw", [
    {"eps": 1.0, "alpha": 0.9},
    {"eps": 1.0, "alpha": 0.9, "weight_decay": 4e-5},
    {"eps": 1e-8, "alpha": 0.95, "momentum": 0.9},
])
def test_rmsprop_matches_optax_eps_inside_the_sqrt(kw):
    named, want, _, _ = run_both("rmsprop", 0.045, **kw)
    assert_params_close(named, want)


def test_rmsprop_at_eps_one_is_not_torchs():
    tm, _ = pair(0)
    p = next(tm.parameters())
    before = p.detach().clone()
    g = torch.randn(before.shape, generator=torch.Generator().manual_seed(0))
    outs = []
    for cls in (RMSprop, torch.optim.RMSprop):
        q = torch.nn.Parameter(before.clone())
        opt = cls([q], lr=0.045, alpha=0.9, eps=1.0)
        q.grad = g.clone()
        opt.step()
        outs.append(q.detach() - before)
    # sqrt(nu + 1) against sqrt(nu) + 1: the steps differ by far more
    # than rounding
    assert not torch.allclose(outs[0], outs[1], rtol=1e-2)


@pytest.mark.parametrize("kw", [
    {},
    {"weight_decay": 1e-2},
    {"weight_decay": 1e-2, "decay_bn_bias": True},
])
def test_lamb_matches_optax(kw):
    named, want, _, _ = run_both("lamb", 1e-2, **kw)
    assert_params_close(named, want)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.9, "weight_decay": 1e-4}),
    ("adam", {}),
    ("rmsprop", {"eps": 1.0}),
])
def test_grad_clip_norm_matches_optax(name, kw):
    # the five gradients' global norms lie between 19.7 and 20.9 (394
    # unit normals): a max norm of 20.5 clips some steps and not others
    named, want, _, _ = run_both(name, 0.01, grad_clip_norm=20.5, **kw)
    assert_params_close(named, want)


@pytest.mark.parametrize("name,kw,keys", [
    ("sgd", {"momentum": 0.9}, ("momentum_buffer",)),
    ("adam", {"weight_decay": 1e-2}, ("exp_avg", "exp_avg_sq")),
])
def test_bfloat16_state_matches_cast_optimizer_state(name, kw, keys):
    named, want, opt, state = run_both(name, BF16_LR,
                                       state_dtype="bfloat16", **kw)
    bound = max(float(v.float().abs().max()) for st in opt.state.values()
                for k, v in st.items() if k in keys)
    assert_params_close(named, want, atol=BF16_ATOL_PER_STATE * bound)
    # the stored state is bf16 between steps, as the reference's
    inner = state.inner_state
    leaves = [x for x in jax.tree_util.tree_leaves(inner)
              if getattr(x, "dtype", None) == jnp.bfloat16]
    assert leaves
    for st in opt.state.values():
        for key in keys:
            assert st[key].dtype == torch.bfloat16, key
    if name == "sgd":  # the trace, leaf for leaf
        ref = variables_from_jax({"params": jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), find_trace(inner))})
        for k, p in named.items():
            got = opt.state[p]["momentum_buffer"].float()
            np.testing.assert_allclose(got.numpy(), ref[k].numpy(),
                                       rtol=2 ** -8, atol=1e-30, err_msg=k)


def test_adamw_and_lamb_refuse_an_eps_the_reference_ignores():
    for name, fixed in (("adamw", 1e-8), ("lamb", 1e-6)):
        with pytest.raises(ValueError, match="ignores eps"):
            build_optimizer(name, 1e-2, eps=1.0)
        build_optimizer(name, 1e-2, eps=fixed)
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("adagrad", 1e-2)


# -- ReduceLROnPlateau ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"factor": 0.1, "mode": "max"},
    {"factor": 0.3, "patience": 2, "mode": "min"},
    {"factor": 0.5, "patience": 0, "mode": "max", "threshold": 0.05,
     "min_scale": 0.2},
])
def test_plateau_matches_the_reference(kw):
    metrics = np.random.RandomState(3).rand(40).round(2).tolist()
    ref, port = RefPlateau(**kw), ReduceLROnPlateau(**kw)
    assert [port.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    assert port.state_dict() == ref.state_dict()
    again = ReduceLROnPlateau(**kw)
    again.load_state_dict(port.state_dict())
    assert again.state_dict() == port.state_dict()
    assert again.step(0.5) == ref.step(0.5)
