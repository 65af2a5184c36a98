"""Port parity: V-MoE in deep_vision_tpu_torch/models/vit.py (`MoeMlp`,
the ViT's `num_experts` / `moe_every`, its training aux outputs), the
Switch loss in parallel/moe.py, ViT dropout, and `vmoe_s16`'s
registration and variables, against the JAX package on the CPU.

Variables and inputs are drawn with numpy from a seed and bridged into
the port (`variables_from_jax`, strict). Expert choices: the port must
choose each token's expert as the reference does; where the reference's
top two gates lie within GATE_MARGIN of each other the two sides may
round to different arg-maxes, and there (only) the port takes the
reference's choice (`MoeMlp.choose`). Tolerances, with their reasons:
- float32 outputs, gates, losses and gradients: rtol 1e-4, atol 1e-4 x
  the compared array's largest magnitude. The same float32 formulas, but
  XLA's dense one-hot einsums against the port's grouped matmuls sum in
  other orders (the one-hot products add exact zeros).
- bf16 MoeMlp output: 3e-2 x its largest magnitude (every product and
  GELU rounded to bf16 on both sides, in other orders).
- the dropout keep rate: within 5 standard deviations of 1 - rate over
  the mask's elements.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.losses.classification import (
    classification_loss_fn as jax_loss_fn,
)
from deep_vision_tpu.models import vit as jax_vit
from deep_vision_tpu.parallel.moe import (
    load_balancing_loss as jax_balancing_loss,
)
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.models.vit import MoeMlp, ViT
from deep_vision_tpu_torch.nn.layers import Dropout
from deep_vision_tpu_torch.parallel.moe import load_balancing_loss

TINY = dict(depth=2, dim=32, num_heads=2, patch=8, num_classes=10,
            num_experts=4)
GATE_MARGIN = 1e-5
RTOL = 1e-4


def close(got, want, name="", rtol=RTOL):
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=name)


def randomize(tree, rng):
    """Same structure, numpy leaves: kernels and expert weights at
    1/sqrt(fan_in), the router at 2/sqrt(dim) (gates away from uniform),
    LayerNorm scales in [0.5, 1.5), biases ~ 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = tuple(np.shape(v))
        if k in ("kernel", "w1", "w2"):
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]) / (
                shape[0] if k != "kernel" else 1))
        elif k == "router":
            a = rng.randn(*shape) * 2.0 / np.sqrt(shape[0])
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def replay(jax_gates):
    """A `MoeMlp.choose` that keeps the port's own arg-max except where
    it differs from the reference's, which it asserts happens only
    within GATE_MARGIN, and counts the replays."""
    want = torch.from_numpy(np.asarray(jax_gates).argmax(-1))
    top2 = np.sort(np.asarray(jax_gates), -1)[:, -2:]
    near = torch.from_numpy(top2[:, 1] - top2[:, 0] < GATE_MARGIN)

    def choose(gates):
        own = gates.argmax(dim=-1)
        differ = own != want
        assert not bool((differ & ~near).any()), "expert choice differs"
        choose.replayed += int(differ.sum())
        return torch.where(differ, want, own)

    choose.replayed = 0
    return choose


# -- MoeMlp ------------------------------------------------------------------

def moe_pair(seed, dtype=None, tokens=24, dim=16, experts=4, hidden=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, tokens, dim).astype(np.float32)
    jm = jax_vit.MoeMlp(experts, hidden,
                        dtype=jnp.bfloat16 if dtype else None)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    v = randomize(shapes, rng)
    tm = MoeMlp(dim, experts, hidden, dtype=dtype)
    tm.load_state_dict(variables_from_jax(v))
    return jm, tm, v, x, rng


def test_moe_mlp_outputs_gates_and_every_gradient():
    jm, tm, v, x, rng = moe_pair(0)
    cot = rng.randn(*x.shape).astype(np.float32)

    def f(params, xx):
        out, gates = jm.apply({"params": params}, xx)
        return jnp.sum(out * cot), (out, gates)

    (_, (want, want_gates)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm.choose = replay(want_gates)
    xt = torch.from_numpy(x).requires_grad_()
    out, gates = tm(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    assert gates.dtype == torch.float32 and gates.shape == (48, 4)
    close(gates.detach(), want_gates, "gates")
    close(out.detach(), want, "output")
    close(xt.grad, gx, "input grad")
    params = dict(tm.named_parameters())
    for k, w in variables_from_jax({"params": jax.device_get(gp)}).items():
        close(params[k].grad, w, k)
    # every expert got tokens: each group's matmul is exercised
    assert len(set(np.asarray(want_gates).argmax(-1).tolist())) == 4


def test_moe_mlp_bf16_output():
    jm, tm, v, x, _ = moe_pair(1, dtype=torch.bfloat16)
    want, want_gates = jm.apply(v, jnp.asarray(x).astype(jnp.bfloat16))
    tm.choose = replay(want_gates)
    with torch.no_grad():
        out, gates = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and gates.dtype == torch.float32
    close(out.float(), np.asarray(want, np.float32), "bf16 output",
          rtol=3e-2)


def test_moe_mlp_handles_an_expert_without_tokens():
    _, tm, _, x, _ = moe_pair(2)
    tm.choose = lambda gates: torch.zeros(gates.shape[0], dtype=torch.long)
    out, gates = tm(torch.from_numpy(x))
    tok = torch.from_numpy(x).reshape(-1, 16)
    h = torch.nn.functional.gelu(tok @ tm.w1[0] + tm.b1[0],
                                 approximate="tanh")
    want = (h @ tm.w2[0] + tm.b2[0]) * gates[:, :1]
    torch.testing.assert_close(out.reshape(-1, 16), want)


def test_load_balancing_loss_matches_the_reference():
    rng = np.random.RandomState(3)
    for gates in (np.full((12, 4), 0.25, np.float32),
                  np.eye(4, dtype=np.float32)[rng.randint(0, 4, 50)],
                  jax.nn.softmax(rng.randn(64, 8).astype(np.float32) * 3)):
        gates = np.array(gates, np.float32)
        want = float(jax_balancing_loss(jnp.asarray(gates)))
        got = float(load_balancing_loss(torch.from_numpy(gates)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(load_balancing_loss(torch.full((12, 4), 0.25))) == 1.0


# -- the V-MoE ViT ------------------------------------------------------------

def vmoe_pair(seed, **kw):
    cfg = dict(TINY, **kw)
    rng = np.random.RandomState(seed)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    jm = jax_vit.ViT(**cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False))
    v = randomize(shapes, rng)
    tm = ViT(**cfg, image_size=32)
    tm.load_state_dict(variables_from_jax(v))
    labels = rng.randint(0, 10, 4).astype(np.int32)
    return jm, tm, v, x, labels


def jax_train(jm, v, x, labels):
    """Loss, metrics, gradients and each MoE block's gates of the
    reference's training forward."""
    def f(params):
        (out, upd) = jm.apply(
            {"params": params}, jnp.asarray(x), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["intermediates"],
            capture_intermediates=lambda m, _: isinstance(
                m, (jax_vit.MoeMlp, fnn.Dropout)))
        loss, metrics = jax_loss_fn(out, {"label": jnp.asarray(labels)})
        return loss, (metrics, upd["intermediates"])

    (loss, (metrics, inter)), grads = jax.value_and_grad(
        f, has_aux=True)(v["params"])
    gates = {k: np.asarray(sub["MoeMlp_0"]["__call__"][0][1])
             for k, sub in inter.items() if k.startswith("ViTBlock")}
    dropped = {k: np.asarray(sub["__call__"][0]) for k, sub in inter.items()
               if k.startswith("Dropout")}
    return (float(loss), jax.device_get(metrics), variables_from_jax(
        {"params": jax.device_get(grads)}), gates, dropped)


def port_train(tm, x, labels, gates):
    for name, g in gates.items():
        getattr(tm, name).MoeMlp_0.choose = replay(g)
    tm.train().zero_grad()
    out = tm(torch.from_numpy(x))
    loss, metrics = classification_loss_fn(
        out, {"label": torch.from_numpy(labels)})
    loss.backward()
    return out, loss, metrics


def test_vmoe_training_loss_telemetry_and_every_gradient():
    jm, tm, v, x, labels = vmoe_pair(4)
    want_loss, want_m, want_g, gates, _ = jax_train(jm, v, x, labels)
    assert sorted(gates) == ["ViTBlock_1"]  # moe_every 2: the odd blocks
    out, loss, metrics = port_train(tm, x, labels, gates)
    logits, aux = out
    assert sorted(aux) == ["_expert_load_max", "_router_entropy", "moe_aux"]
    assert sorted(metrics) == sorted(want_m)
    close(loss.detach(), want_loss, "loss")
    for k in ("moe_aux", "router_entropy", "expert_load_max", "top1"):
        close(metrics[k].detach(), want_m[k], k)
    # the penalty enters the loss at penalty_weight 0.01
    ce, _ = classification_loss_fn(logits, {"label":
                                            torch.from_numpy(labels)})
    close(loss.detach() - ce.detach(), 0.01 * float(want_m["moe_aux"]),
          "0.01 x moe_aux", rtol=1e-3)
    params = dict(tm.named_parameters())
    assert sorted(want_g) == sorted(params)
    for k, w in want_g.items():
        close(params[k].grad, w, k)


def test_vmoe_eval_returns_the_references_logits():
    jm, tm, v, x, _ = vmoe_pair(5)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    close(got, want, "eval logits")


@pytest.mark.parametrize("depth,every,moe_blocks", [
    (4, 2, (1, 3)), (4, 3, (2,)), (3, 1, (0, 1, 2))])
def test_moe_every_places_the_experts_as_the_reference(depth, every,
                                                       moe_blocks):
    cfg = dict(TINY, depth=depth, moe_every=every)
    shapes = jax.eval_shape(lambda: jax_vit.ViT(**cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    tm = ViT(**cfg, image_size=32)
    want = variables_from_jax(randomize(shapes, np.random.RandomState(0)))
    assert sorted(want) == sorted(tm.state_dict())
    assert tuple(i for i in range(depth) if hasattr(
        getattr(tm, f"ViTBlock_{i}"), "MoeMlp_0")) == moe_blocks


def test_vmoe_s16_is_registered_as_the_reference():
    model = get_model("vmoe_s16", device="cpu")
    blocks = [getattr(model, f"ViTBlock_{i}") for i in range(12)]
    moe = [b.MoeMlp_0 for b in blocks if hasattr(b, "MoeMlp_0")]
    assert (model.depth, model.dim, len(moe)) == (12, 384, 6)
    assert tuple(moe[0].w1.shape) == (8, 384, 1536)
    assert tuple(moe[0].router.shape) == (384, 8)
    assert blocks[0].Attention_0.num_heads == 6
    # flax's lecun_normal over (E, d, h) counts E into the fan
    std = float(moe[0].w1.detach().std())
    np.testing.assert_allclose(std, (1.0 / (8 * 384)) ** 0.5, rtol=0.02)


# -- ViT dropout ----------------------------------------------------------------

def test_dropout_off_in_eval_and_replayed_in_training_gives_parity():
    jm, tm, v, x, labels = vmoe_pair(6, dropout=0.3)
    assert isinstance(tm.Dropout_0, Dropout)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close(got, jm.apply(v, jnp.asarray(x), train=False), "eval logits")
    want_loss, _, want_g, gates, dropped = jax_train(jm, v, x, labels)
    mask = torch.from_numpy(dropped["Dropout_0"] != 0)
    handle = tm.Dropout_0.register_forward_hook(
        lambda mod, args, out: torch.where(mask, args[0] / 0.7, 0.0))
    try:
        _, loss, _ = port_train(tm, x, labels, gates)
    finally:
        handle.remove()
    close(loss.detach(), want_loss, "loss with the reference's mask")
    params = dict(tm.named_parameters())
    for k, w in want_g.items():
        close(params[k].grad, w, k)


def test_dropout_keeps_its_rate_and_scales_the_kept():
    tm = ViT(**dict(TINY, num_experts=0), dropout=0.25, image_size=32)
    tm.Dropout_0.generator = torch.Generator().manual_seed(0)
    seen = {}
    tm.Dropout_0.register_forward_hook(
        lambda mod, args, out: seen.update(x=args[0], y=out))
    tm.train()
    with torch.no_grad():
        tm(torch.rand(64, 32, 32, 3, generator=torch.Generator()
                      .manual_seed(1)))
    kept = seen["y"] != 0
    n = kept.numel()
    rate = float(kept.float().mean())
    assert abs(rate - 0.75) < 5 * (0.75 * 0.25 / n) ** 0.5
    torch.testing.assert_close(seen["y"][kept], seen["x"][kept] / 0.75)
