"""Shared helpers of the zoo's parity tests (tests/test_torch_zoo_*.py,
and the GAN, Hourglass and CenterNet ones): the JAX package's variables
drawn with numpy and bridged into the port, one training step's
outputs, batch statistics and gradients on both sides, and the
comparison; the JAX run's ReLU and leaky-ReLU decisions recorded and
replayed on the port (ActivationReplay).

JAX variables come from `jax.eval_shape` of the module's init (no
forward, no compile) and are filled from a numpy seed: kernels at
1/sqrt(fan_in), BatchNorm scale and var in [0.5, 1.5), biases and means
~ 0.1 N(0, 1). The port's module goes to channels_last memory first, as
its initialiser leaves it, so the parity runs the layout the card runs.

Importing this module gives torch one intra-op thread in a pytest-xdist
worker (PYTEST_XDIST_WORKER set; every worker imports every test module
while it collects, so the whole worker runs so): six workers each
running torch at a thread a core oversubscribe the host's cores, and
the heaviest six port test files took 492 s under `-n 6 --dist
loadfile` at torch's default against 263 s at one thread. A run
without xdist keeps the default.
"""
import contextlib
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.nn.layers import Dropout

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def randomize(tree, rng):
    """Same structure, numpy leaves from `rng`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def close(got, want, rtol, name=""):
    """|got - want| <= rtol |want| + rtol max|want|."""
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=name)


def bridge(jm, tm, x, seed, train=True):
    """Numpy-seeded variables of the JAX module `jm` on input x (NHWC),
    loaded into the port module `tm` (strict). -> the variables."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.asarray(x), train=train))
    v = randomize(shapes, np.random.RandomState(seed))
    tm.to(memory_format=torch.channels_last)
    tm.load_state_dict(variables_from_jax(v))
    return v


def _outputs(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _captured(tree, path=()):
    """{module path: its first output} from flax's intermediates."""
    out = {}
    for k, sub in tree.items():
        if k == "__call__":
            out[".".join(path)] = np.asarray(sub[0])
        else:
            out.update(_captured(sub, path + (k,)))
    return out


def jax_train(jm, v, x, cots, dropout_seed=0, relu_module=None,
              grads=True):
    """One training forward of `jm` and the gradients of sum(out * cot)
    over its outputs, jitted (one XLA compile costs a fraction of op-by-op
    dispatch's compiles of every op). -> (outputs, batch_stats, param
    grads (None without `grads`: a forward only), {module path: output}
    of its Dropouts and of its `relu_module` instances)."""
    def capture(m, _):
        return isinstance(m, fnn.Dropout) or (
            relu_module is not None and isinstance(m, relu_module))

    def f(params, v, x, cots):
        variables = dict(v, params=params)
        out, upd = jm.apply(
            variables, x, train=True,
            rngs={"dropout": jax.random.PRNGKey(dropout_seed)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=capture)
        loss = sum(jnp.sum(o * c) for o, c in zip(_outputs(out), cots))
        return loss, (out, upd)

    if grads:
        step = jax.jit(jax.value_and_grad(f, has_aux=True))
        (_, (out, upd)), grads = step(v["params"], v, x, list(cots))
    else:
        _, (out, upd) = jax.jit(f)(v["params"], v, x, list(cots))
        grads = None
    return (tuple(np.asarray(o) for o in _outputs(out)),
            jax.device_get(upd.get("batch_stats", {})),
            jax.device_get(grads),
            _captured(jax.device_get(upd.get("intermediates", {}))))


def apply_masks(tm, captured, relu_module=None):
    """Forward hooks that make the port take the JAX run's random and
    branch decisions. Dropout: kept where the JAX output is nonzero.
    `relu_module` (a port module ending in a ReLU of its `BatchNorm_0`'s
    output): positive where the JAX output is, so a ReLU input that lies
    within rounding of zero cannot fall the other way on one side alone.
    -> handles."""
    handles = []
    for name, m in tm.named_modules():
        if name not in captured:
            continue
        mask = torch.from_numpy(captured[name] != 0)
        if isinstance(m, Dropout):
            if mask.dim() == 4:  # the port's NCHW indexing of an NHWC map
                mask = mask.permute(0, 3, 1, 2)
            keep = 1.0 - m.rate

            def hook(mod, args, out, mask=mask, keep=keep):
                return torch.where(mask, args[0] / keep, 0.0)

            handles.append(m.register_forward_hook(hook))
        elif relu_module is not None and isinstance(m, relu_module):
            pre = {}
            handles.append(m.BatchNorm_0.register_forward_hook(
                lambda mod, args, out, pre=pre: pre.__setitem__("z", out)))

            def relu_hook(mod, args, out, mask=mask, pre=pre):
                return torch.where(mask.permute(0, 3, 1, 2), pre["z"], 0.0)

            handles.append(m.register_forward_hook(relu_hook))
    return handles


def check_train(jm, tm, v, x, cots, rtol, dropout_seed=0, grads=True,
                cancelled=None, relu_modules=(None, None), grad_rtol=None):
    """Outputs, updated batch statistics and (with `grads`) every
    parameter's gradient of one training step, port against JAX, within
    `rtol`. `cancelled` maps a parameter-name suffix whose gradient is
    zero in exact arithmetic (a shift that the next training BatchNorm
    removes) to the suffix of a parameter of the same layer: such a
    gradient is rounding noise on both sides, held at rtol x that
    parameter's largest gradient. `relu_modules`: a (JAX, port) pair of
    module classes whose ReLU decisions the port takes from the JAX run
    (apply_masks). `grad_rtol` (default: rtol) holds the gradients."""
    want_out, want_stats, want_grads, captured = jax_train(
        jm, v, x, cots, dropout_seed, relu_modules[0], grads)
    handles = apply_masks(tm, captured, relu_modules[1])
    try:
        tm.train()
        out = _outputs(tm(torch.from_numpy(x)))
        if grads:
            sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)
                ).backward()
    finally:
        for h in handles:
            h.remove()
    assert len(out) == len(want_out)
    for i, (g, w) in enumerate(zip(out, want_out)):
        close(g.detach().numpy(), w, rtol, f"output {i}")
    if grads:
        compare_grads(tm, want_grads, grad_rtol or rtol, cancelled or {})
    buffers = dict(tm.named_buffers())
    stats = variables_from_jax({"batch_stats": want_stats})
    assert sorted(stats) == sorted(buffers)
    for k, w in stats.items():
        close(buffers[k].numpy(), w.numpy(), rtol, k)


def compare_grads(tm, want_grads, rtol, cancelled):
    params = dict(tm.named_parameters())
    want = variables_from_jax({"params": want_grads})
    assert sorted(want) == sorted(params)
    for k, w in want.items():
        grad = params[k].grad  # None: unused (eval mode's aux heads)
        got = np.zeros(w.shape, np.float32) if grad is None else grad.numpy()
        ref = next((k[:-len(a)] + b for a, b in cancelled.items()
                    if k.endswith(a)), None)
        if ref is None:
            close(got, w.numpy(), rtol, k)
        else:
            atol = rtol * float(want[ref].abs().max())
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=atol,
                                       err_msg=k)


def check_eval(jm, tm, v, x, cot, rtol, relu_modules=(None, None)):
    """Eval-mode outputs and every parameter's gradient of sum(out * cot),
    port against JAX, within `rtol`; `relu_modules` as check_train's."""
    def f(params, v, x):
        out, upd = jm.apply(
            dict(v, params=params), x, train=False, mutable=["intermediates"],
            capture_intermediates=lambda m, _: relu_modules[0] is not None
            and isinstance(m, relu_modules[0]))
        return jnp.sum(out * cot), (out, upd)

    (_, (want, upd)), want_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(v["params"], v, x)
    handles = apply_masks(tm, _captured(jax.device_get(
        upd.get("intermediates", {}))), relu_modules[1])
    try:
        tm.eval()
        got = tm(torch.from_numpy(x))
        (got * torch.from_numpy(cot)).sum().backward()
    finally:
        for h in handles:
            h.remove()
    close(got.detach().numpy(), np.asarray(want), rtol, "eval output")
    compare_grads(tm, jax.device_get(want_grads), rtol, {})


@contextlib.contextmanager
def recording_activations():
    """Record the input of every `nn.relu` and `nn.leaky_relu` call made
    inside the block, in call order, into the yielded list. The
    reference's modules look these functions up on flax.linen at call
    time, so wrapping them there sees every call; under a trace the
    entries are tracers, for the traced function to return (as an
    output, or as aux of a gradient)."""
    seen = []
    saved = {name: getattr(fnn, name) for name in ("relu", "leaky_relu")}

    def recorder(fn):
        def wrapped(y, *args, **kwargs):
            seen.append(y)
            return fn(y, *args, **kwargs)
        return wrapped

    try:
        for name, fn in saved.items():
            setattr(fnn, name, recorder(fn))
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(fnn, name, fn)


def activation_inputs(jm, v, x, dropout_seed=0):
    """The inputs of every relu and leaky relu of one jitted training
    forward of `jm`, in call order, as numpy (NHWC, or (B, F) after a
    Dense)."""
    def f(v, x):
        with recording_activations() as seen:
            jm.apply(v, x, train=True,
                     rngs={"dropout": jax.random.PRNGKey(dropout_seed)},
                     mutable=["batch_stats"])
        return list(seen)

    return [np.asarray(a) for a in jax.jit(f)(v, x)]


class ActivationReplay:
    """Makes the port's `F.relu` and `F.leaky_relu` take the JAX run's
    decisions (activation_inputs), in call order: kept where the JAX
    input was > 0 (relu) or >= 0 (leaky, jnp.where(x >= 0, ...)), so an
    input within rounding of zero cannot fall the other way on one side
    alone. `flips` counts the decisions the port's own input would have
    taken otherwise; `left` what was not consumed."""

    def __init__(self, inputs):
        self.inputs = list(inputs)
        self.flips = 0
        self.calls = 0

    @property
    def left(self):
        return len(self.inputs)

    def _mask(self, x, leaky):
        a = self.inputs.pop(0)
        mask = torch.from_numpy(a >= 0 if leaky else a > 0)
        if mask.dim() == 4:
            mask = mask.permute(0, 3, 1, 2)
        assert tuple(mask.shape) == tuple(x.shape), (mask.shape, x.shape)
        own = (x >= 0) if leaky else (x > 0)
        self.flips += int((own != mask).sum())
        self.calls += 1
        return mask

    def __enter__(self):
        import torch.nn.functional as F

        self._saved = (F.relu, F.leaky_relu)

        def relu(x, inplace=False):
            return torch.where(self._mask(x, False), x, 0.0)

        def leaky_relu(x, negative_slope=0.01, inplace=False):
            return torch.where(self._mask(x, True), x, negative_slope * x)

        F.relu, F.leaky_relu = relu, leaky_relu
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.relu, F.leaky_relu = self._saved
        return False


def check_train_replayed(jm, tm, v, x, cots, rtol, dropout_seed=0,
                         cancelled=None, grad_rtol=None):
    """check_train with the port taking the JAX run's ReLU and leaky-ReLU
    decisions (ActivationReplay); every recorded decision is used.
    -> the replay (its `flips` and `calls`)."""
    replay = ActivationReplay(activation_inputs(jm, v, x, dropout_seed))
    with replay:
        check_train(jm, tm, v, x, cots, rtol, dropout_seed=dropout_seed,
                    cancelled=cancelled, grad_rtol=grad_rtol)
    assert replay.left == 0 and replay.calls > 0
    return replay


def damp_residual_branches(v, block="HgBottleneck", conv="Conv_2",
                           factor=0.1):
    """Scale the last kernel of every residual branch (`conv` inside a
    `block`) by `factor`, in place: the residual sums then keep
    activations of order 1 down a deep hourglass, as a trained one's
    are, instead of growing until the few-row normalisations of its
    deepest levels amplify float32 rounding (JAX's own float32 outputs
    then stray from float64 by percents). -> v."""
    def walk(t, path):
        for k, a in t.items():
            if isinstance(a, dict):
                walk(a, path + (k,))
            elif (k == "kernel" and len(path) >= 2 and path[-1] == conv
                  and path[-2].startswith(block)):
                t[k] = (a * factor).astype(a.dtype)

    walk(v["params"], ())
    return v
