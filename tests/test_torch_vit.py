"""Port parity: deep_vision_tpu_torch/models/vit.py, the flax layers in
nn/layers.py (LayerNorm, Dense, DenseGeneral), convert.py's ViT bridge,
AdamW and the warmup-cosine schedule in train/optimizers.py, and the
Trainer's schedule, against the JAX package on the CPU, on small shapes.

Variables are drawn with numpy from a seed and bridged into the port
through `variables_from_jax`; a strict `load_state_dict` proves the
mapping complete. Gradients are taken of the reference's classification
loss on a seeded batch.

Tolerances, each with its reason:
- f32 logits and gradients: rtol 1e-4, atol 1e-4 x the largest magnitude
  of the compared array. The same f32 formulas, but XLA's and PyTorch's
  CPU matmuls, convolutions and reductions sum in different orders.
- the T = 1024 ViT (the port's plain flash path against the reference's
  dense einsum): the same, with rtol 2e-4: a blockwise-exact softmax
  against a dense one over 1024 keys.
- bf16 logits: 3e-2 x the largest magnitude. Both sides round every
  bf16 matmul, GELU and residual add, and a one-ulp bf16 difference
  (2^-8) early on propagates through two blocks.
- AdamW: rtol 1e-6, atol 1e-6 on the parameters after three steps: the
  same f32 arithmetic with the decay applied before the Adam step (torch)
  instead of beside it (optax), an ulp or two apart.
- the schedule: rtol 1e-6, atol 1e-6 x the peak (optax evaluates it in
  f32, the port in f64; near the end of the cosine f32's cos is off by
  ~3e-6 of the small value).
- Trainer steps: loss and grad norm at rtol 1e-4; each parameter's total
  update over the steps within 1e-3 of the largest update of its tensor
  (AdamW's first steps move every parameter by ~lr whatever its gradient's
  size, so the update, not the parameter, is what can be wrong). The key
  third of each qkv bias is left out: adding a constant to every key of a
  row leaves its softmax unchanged, so that gradient is 0 up to rounding
  (~1e-10 here), and Adam normalises the rounding noise to +-lr on each
  side independently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_vision_tpu.losses.classification import (
    classification_loss_fn as jax_loss_fn,
)
from deep_vision_tpu.models.vit import ViT as JaxViT
from deep_vision_tpu.parallel.mesh import create_mesh
from deep_vision_tpu.train.optimizers import build_optimizer as jax_build
from deep_vision_tpu.train.optimizers import make_schedule as jax_schedule
from deep_vision_tpu.train.trainer import Trainer as JaxTrainer
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.models import vit as vit_mod
from deep_vision_tpu_torch.models.vit import ViT
from deep_vision_tpu_torch.nn.layers import DenseGeneral, LayerNorm
from deep_vision_tpu_torch.train import Trainer, build_optimizer
from deep_vision_tpu_torch.train.optimizers import make_schedule

TINY = dict(depth=2, dim=32, num_heads=2, patch=8, num_classes=10)


def close(got, want, name="", rtol=1e-4):
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=name)


def randomize(tree, rng):
    """Same structure, numpy leaves from `rng`: kernels at 1/sqrt(fan_in),
    LayerNorm scales in [0.5, 1.5), everything else ~ 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def pair(seed, image=32, batch=2, jax_dtype=None, torch_dtype=None, **kw):
    """JAX and port ViTs holding the same random variables, and one
    seeded batch {image, label}."""
    cfg = dict(TINY, **kw)
    jm = JaxViT(**cfg, dtype=jax_dtype)
    tm = ViT(**cfg, image_size=image, dtype=torch_dtype)
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, image, image, 3).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                               train=False))
    v = randomize(v, rng)
    tm.load_state_dict(variables_from_jax(v))
    labels = rng.randint(0, cfg["num_classes"], size=(batch,)).astype(
        np.int32)
    return jm, tm, v, {"image": x, "label": labels}


def jax_grads(jm, v, batch):
    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(batch["image"]),
                       train=True)
        return jax_loss_fn(out, {"label": jnp.asarray(batch["label"])})[0]

    value, grads = jax.value_and_grad(loss)(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))
    return float(value), variables_from_jax(
        {"params": jax.device_get(grads)})


def port_grads(tm, batch):
    tm.train().zero_grad()
    out = tm(torch.from_numpy(batch["image"]))
    loss, _ = classification_loss_fn(out, {
        "label": torch.from_numpy(batch["label"])})
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  tm.named_parameters()}


# -- layers ------------------------------------------------------------------

def test_layernorm_matches_flax_including_bf16_input():
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 24) * 4 + 2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    ln = LayerNorm(24, dtype=torch.float32)
    ln.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = fnn.LayerNorm(dtype=jnp.float32).apply(
            {"params": {"scale": scale, "bias": bias}},
            jnp.asarray(x, jdt))
        got = ln(torch.from_numpy(x).to(tdt))
        assert got.dtype == torch.float32
        close(got.detach().numpy(), want, f"{jdt}", rtol=1e-5)


def test_dense_general_bridges_both_kernel_layouts():
    import flax.linen as fnn

    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 12).astype(np.float32)
    qkv = fnn.DenseGeneral((3, 2, 4))
    vq = randomize(jax.device_get(qkv.init(jax.random.PRNGKey(0), x)), rng)
    out = fnn.DenseGeneral(5, axis=(-2, -1))
    y = rng.randn(2, 7, 2, 4).astype(np.float32)
    vo = randomize(jax.device_get(out.init(jax.random.PRNGKey(0), y)), rng)
    sd = variables_from_jax({"params": {"Attention_0": {
        "qkv": vq["params"], "out": vo["params"]}}})
    tq, to = DenseGeneral(12, (3, 2, 4)), DenseGeneral((2, 4), 5)
    tq.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()
                        if ".qkv." in k})
    to.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()
                        if ".out." in k})
    assert tq.weight.shape == (24, 12) and to.weight.shape == (5, 8)
    close(tq(torch.from_numpy(x)).detach().numpy(), qkv.apply(vq, x), "qkv")
    close(to(torch.from_numpy(y)).detach().numpy(), out.apply(vo, y), "out")


# -- the model ---------------------------------------------------------------

def test_tiny_vit_f32_logits_and_every_gradient():
    jm, tm, v, batch = pair(0)
    want = jm.apply({"params": v["params"]}, jnp.asarray(batch["image"]),
                    train=False)
    got = tm.eval()(torch.from_numpy(batch["image"]))
    close(got.detach().numpy(), want, "logits")
    want_loss, want_g = jax_grads(jm, v, batch)
    got_loss, got_g = port_grads(tm, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        close(got_g[k].numpy(), w.numpy(), k)


def test_tiny_vit_bf16_logits():
    jm, tm, v, batch = pair(1, jax_dtype=jnp.bfloat16,
                            torch_dtype=torch.bfloat16)
    want = jm.apply({"params": v["params"]}, jnp.asarray(batch["image"]),
                    train=False)
    got = tm.eval()(torch.from_numpy(batch["image"]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got.detach().numpy(), want, "bf16 logits", rtol=3e-2)


def test_vit_at_1024_tokens_routes_through_flash(monkeypatch):
    """32x32 at patch 1 is T = 1024: the port takes the flash path (its
    plain version on the CPU), the reference the dense einsum (its flash
    kernel needs a compiled Pallas backend), and both agree."""
    calls = []
    flash = vit_mod.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return flash(*args, **kw)

    monkeypatch.setattr(vit_mod, "flash_attention", spy)
    jm, tm, v, batch = pair(2, depth=1, dim=16, patch=1)
    want = jm.apply({"params": v["params"]}, jnp.asarray(batch["image"]),
                    train=False)
    got = tm.eval()(torch.from_numpy(batch["image"]))
    assert calls == [(2, 1024, 2, 8)]
    close(got.detach().numpy(), want, "logits", rtol=2e-4)
    want_loss, want_g = jax_grads(jm, v, batch)
    got_loss, got_g = port_grads(tm, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for k, w in want_g.items():
        close(got_g[k].numpy(), w.numpy(), k, rtol=2e-4)


def test_routing_rule_and_knob(monkeypatch):
    monkeypatch.delenv("DVT_FLASH_MIN_TOKENS", raising=False)
    assert [vit_mod.use_flash(t) for t in (196, 1000, 1024, 1536, 2048)] \
        == [False, False, True, False, True]
    monkeypatch.setenv("DVT_FLASH_MIN_TOKENS", "4096")
    assert not vit_mod.use_flash(2048)


def test_vit_s16_shape_and_routes_dense_at_224(monkeypatch):
    calls = []
    monkeypatch.setattr(vit_mod, "flash_attention",
                        lambda *a, **k: calls.append(1))
    model = get_model("vit_s16", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 22_049_896
    assert model.pos_embed.shape == (1, 196, 384)
    with torch.no_grad():
        logits = model(torch.zeros(1, 224, 224, 3))
    assert logits.shape == (1, 1000) and calls == []
    big = get_model("vit_s16", image_size=512, device="cpu")
    assert big.pos_embed.shape == (1, 1024, 384)
    assert sum(p.numel() for p in big.parameters()) == 22_367_848
    with pytest.raises(ValueError, match="built for 512x512"):
        big(torch.zeros(1, 224, 224, 3))


def test_remat_gives_the_same_gradients():
    _, tm, v, batch = pair(3)
    _, want = port_grads(tm, batch)
    rm = ViT(**TINY, image_size=32, remat=True)
    rm.load_state_dict(variables_from_jax(v))
    _, got = port_grads(rm, batch)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kw", [{"num_experts": 4}, {"dropout": 0.1}])
def test_unported_options_raise(kw):
    """V-MoE and dropout, refused until they were ported, now build:
    MoE blocks at the odd indices, a Dropout after the position
    embedding (tests/test_torch_vmoe.py holds them against the JAX
    package)."""
    model = ViT(**TINY, image_size=32, **kw)
    if "num_experts" in kw:
        assert not hasattr(model.ViTBlock_0, "MoeMlp_0")
        assert model.ViTBlock_1.MoeMlp_0.w1.shape[0] == 4
    else:
        assert model.Dropout_0.rate == 0.1
    model.eval()
    with torch.no_grad():
        assert model(torch.rand(1, 32, 32, 3)).shape == (1, 10)


# -- optimizer, schedule, Trainer --------------------------------------------

def test_cosine_schedule_matches_optax():
    for warmup, total in ((3, 13), (0, 10), (5, 90)):
        want = jax_schedule("cosine", 1e-3, warmup_steps=warmup,
                            total_steps=total)
        got = make_schedule("cosine", 1e-3, warmup_steps=warmup,
                            total_steps=total)
        for step in range(total + 3):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{warmup}/{total}@{step}")
    assert make_schedule("constant", 0.5) == 0.5


@pytest.mark.parametrize("decay_bn_bias", [False, True])
def test_adamw_matches_optax_with_identical_gradients(decay_bn_bias):
    _, tm, v, _ = pair(4)
    sched = make_schedule("cosine", 1e-2, warmup_steps=1, total_steps=5)
    jtx = jax_build("adamw", jax_schedule("cosine", 1e-2, warmup_steps=1,
                                          total_steps=5),
                    weight_decay=1e-2, decay_bn_bias=decay_bn_bias)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = jtx.init(params)
    spec = build_optimizer("adamw", sched, weight_decay=1e-2,
                           decay_bn_bias=decay_bn_bias)
    opt = spec(tm)
    assert spec.schedule is sched and opt.defaults["eps"] == 1e-8
    named = dict(tm.named_parameters())
    rng = np.random.RandomState(5)
    for step in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), v["params"])
        updates, state = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for k, g in variables_from_jax({"params": grads}).items():
            named[k].grad = g
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
    want = variables_from_jax({"params": jax.device_get(params)})
    for k, w in want.items():
        np.testing.assert_allclose(named[k].detach().numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_adamw_eps_is_the_references_fixed_one():
    # the reference's adamw passes no eps to optax.adamw: its eps=1.0 is
    # the default 1e-8, so the port refuses any other eps for adamw
    for eps in (1.0, 1e-6):
        with pytest.raises(ValueError, match="ignores eps"):
            build_optimizer("adamw", 1e-2, eps=eps)
    build_optimizer("sgd", 0.1, eps=1.0)  # sgd has no eps to ignore
    p0 = np.array([1.0, -2.0, 0.5], np.float32)
    g = np.array([0.1, 0.2, -0.3], np.float32)
    jtx = jax_build("adamw", 1e-2, eps=1.0)
    updates, _ = jtx.update(jnp.asarray(g), jtx.init(jnp.asarray(p0)),
                            jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), updates))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer("adamw", 1e-2)(torch.nn.ParameterList([p]))
    assert opt.defaults["eps"] == 1e-8
    p.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    # eps=1.0 would have moved it far less: the check can tell them apart
    assert np.abs(want - p0).min() > 9e-3


def test_trainer_steps_match_jax_trainer_with_schedule():
    jm, tm, v, batch = pair(6, batch=4)
    kw = dict(weight_decay=1e-4, decay_bn_bias=True)
    jt = JaxTrainer(jm, jax_build("adamw", jax_schedule(
        "cosine", 1e-3, warmup_steps=2, total_steps=8), **kw), jax_loss_fn,
        jnp.zeros((4, 32, 32, 3)),
        mesh=create_mesh(devices=jax.devices()[:1]))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(params=params,
                                opt_state=jt.state.tx.init(params))
    tt = Trainer(tm, build_optimizer("adamw", make_schedule(
        "cosine", 1e-3, warmup_steps=2, total_steps=8), **kw),
        classification_loss_fn, torch.zeros(4, 32, 32, 3), device="cpu")
    lrs = []
    for step in range(4):
        want = jax.device_get(jt.train_step(batch))
        got = tt.train_step(batch)
        lrs.append(tt.state.optimizer.param_groups[0]["lr"])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=f"{step} {k}")
    assert lrs == [0.0, 5e-4, 1e-3, tt.lr_schedule(3)]
    start = variables_from_jax(v)
    want = variables_from_jax({"params": jax.device_get(jt.state.params)})
    for k, w in tm.state_dict().items():
        du_got, du_want = (x.numpy() - start[k].numpy() for x in (w, want[k]))
        if k.endswith("qkv.bias"):  # the key third: see the module doc
            keep = np.arange(du_got.size) // (du_got.size // 3) != 1
            du_got, du_want = du_got[keep], du_want[keep]
        close(du_got, du_want, k, rtol=1e-3)


def test_make_vit_train_parts_builds_the_configuration():
    from deep_vision_tpu_torch.tools.profile_train import make_vit_train_parts

    trainer, batch = make_vit_train_parts(1, device="cpu")
    rng = np.random.RandomState(0)
    images = rng.rand(1, 512, 512, 3).astype(np.float32)
    assert torch.equal(batch["image"],
                       torch.from_numpy(images).to(torch.bfloat16))
    assert batch["label"].tolist() == rng.randint(0, 1000, size=(1,)).tolist()
    model = trainer.model
    assert model.dtype == torch.bfloat16 and model.image_size == 512
    assert sum(p.numel() for p in model.parameters()) == 22_367_848
    opt = trainer.state.optimizer
    assert isinstance(opt, torch.optim.AdamW)
    assert [(g["weight_decay"], g["lr"], g["eps"], g["betas"])
            for g in opt.param_groups] == [(1e-4, 0.0, 1e-8, (0.9, 0.999))]
    assert [trainer.lr_schedule(s) for s in (0, 3, 13)] == [0.0, 1e-3, 0.0]


def test_profile_groups_for_the_vit_step():
    from types import SimpleNamespace as Ns

    from deep_vision_tpu_torch.nn.layers import LAYERNORM_RANGE
    from deep_vision_tpu_torch.tools.profile_train import (
        VIT_GROUPING,
        kernel_groups,
    )

    def op(name, kernels=(), parent=None, seq=-1):
        return Ns(name=name, cpu_parent=parent, sequence_nr=seq,
                  kernels=[Ns(name=k, duration=d) for k, d in kernels])

    ln = op(LAYERNORM_RANGE)
    step = op("Optimizer.step#AdamW.step")
    backward = op("autograd::engine::evaluate_function: MulBackward0",
                  seq=3)
    events = [
        ln, step, backward,
        op("aten::mul", [("elementwise_kernel", 3.0)], ln, seq=3),
        op("aten::mul", [("elementwise_kernel", 5.0)], backward),
        op("_Flash", [("void flash_fwd<__nv_bfloat16, 64>", 2.0)]),
        op("_FlashBackward", [("void flash_dq<64>", 4.0),
                              ("void flash_dkv<64>", 6.0)]),
        op("_FlashBackward", [
            ("void (anonymous namespace)::flash_dq_sm90<64>(CUtensorMap)",
             2.0),
            ("void (anonymous namespace)::flash_dkv_sm90<64>(CUtensorMap)",
             3.0)]),
        op("aten::_foreach_mul_", [("multi_tensor_apply_kernel", 1.0)],
           step),
        op("aten::mm", [("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", 9.0)]),
        op("aten::gelu", [("gelu_kernel", 7.0)]),
    ]
    assert kernel_groups(events, VIT_GROUPING) == {
        "flash_fwd": 2.0, "flash_dq": 6.0, "flash_dkv": 9.0, "matmul": 9.0,
        "layernorm": 8.0, "optimizer": 1.0, "other": 7.0}
