"""Port parity: the GAN slice (deep_vision_tpu_torch/nn/layers.py's
ConvTranspose, reflect padding and instance norm; models/dcgan.py,
models/cyclegan.py, losses/gan.py, train/gan.py) against the JAX
package on the CPU.

Every variable and input is drawn with numpy from a seed and handed to
both packages (JAX variables from `jax.eval_shape`, filled by
torch_parity.randomize, bridged by convert.variables_from_jax).

- ConvTranspose at every (kernel, stride) the models use and an even
  kernel, SAME, against `flax.linen.ConvTranspose`: output, input and
  kernel gradients, rtol 1e-5 (a few float32 products summed in other
  orders).
- Reflect padding: bit for bit `jnp.pad(mode="reflect")`. CycleGAN's
  `_Norm`, both branches: outputs, gradients and batch statistics, rtol
  1e-5.
- The models, training mode, outputs, every parameter's gradient and
  the batch statistics (torch_parity.check_train, the port taking the
  JAX run's dropout masks): DCGAN as registered at batch 4, rtol 1e-4
  (three float32 layers and a Dense of 12544 outputs normalised over 4
  rows); CycleGAN with n_blocks=1, base=8 at 32x32, rtol 1e-4 (nine
  normalisations over 4 to 1024 pixels).
- The losses: rtol 1e-6 (one float32 reduction each).
- One DCGAN step (the noise drawn in numpy, dropout off) and one
  CycleGAN G + pool + D step, the JAX side composed from the models'
  `apply`, the reference's losses and its `build_optimizer` as
  `_step_impl` / `_g_step_impl` / `_d_step_impl` compose them: the
  losses within rtol 1e-5 and every updated parameter within 1e-2 x
  the learning rate plus rtol 1e-5 (Adam's first step moves a parameter
  by lr x g / (|g| + eps)), or within 2 lr where the reference's
  gradient is rounding noise (at most 1e-4 of its tensor's largest: the
  step is then lr times the noise's sign). The port takes the JAX run's
  ReLU and leaky-ReLU decisions (torch_parity.ActivationReplay) in the
  model and step tests, as the zoo's tests do for ReLUs: an input within
  rounding of zero falls either way, and one flip moves the gradients
  upstream of it by percents.
- ImagePool: its returned batches and its buffer bit for bit the
  reference's over a stream of queries that fills and replaces.
"""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_vision_tpu.losses import gan as ref_losses
from deep_vision_tpu.models import cyclegan as jax_cyc
from deep_vision_tpu.models import dcgan as jax_dcgan
from deep_vision_tpu.train import build_optimizer as ref_build_optimizer
from deep_vision_tpu.train.gan import ImagePool as RefImagePool
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.losses import gan as losses
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.models import cyclegan as port_cyc
from deep_vision_tpu_torch.models import dcgan as port_dcgan
from deep_vision_tpu_torch.nn import layers
from deep_vision_tpu_torch.train import build_optimizer
from deep_vision_tpu_torch.train.gan import (
    CycleGanTrainer,
    DcganTrainer,
    ImagePool,
)
from torch_parity import (
    ActivationReplay,
    bridge,
    check_train,
    check_train_replayed,
    close,
    randomize,
    recording_activations,
)

TOL = 1e-5
MODEL_TOL = 1e-4
#: a gradient element at most this share of its tensor's largest is
#: rounding noise of a sum that cancels (see close_updated)
GRAD_NOISE = 1e-4


@pytest.fixture(autouse=True)
def two_torch_threads():
    """torch on two threads for each test: with several test processes
    on one host, torch's default of a thread a core oversubscribes the
    cores (a CycleGAN run took 100x its serial time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride", [(5, 2), (3, 2), (5, 1), (4, 2)])
def test_conv_transpose_matches_flax(kernel, stride):
    """SAME at the models' (kernel, stride) pairs, and an even kernel."""
    rng = np.random.RandomState(kernel * 10 + stride)
    x = rng.randn(2, 7, 6, 5).astype(np.float32)
    jm = fnn.ConvTranspose(3, (kernel, kernel), strides=(stride, stride),
                           padding="SAME")
    tm = layers.ConvTranspose(5, 3, kernel, stride)
    v = randomize(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x))), rng)
    tm.load_state_dict(variables_from_jax(v))

    def f(params, x):
        return jm.apply({"params": params}, x)

    want = np.asarray(f(v["params"], x))
    assert want.shape == (2, 7 * stride, 6 * stride, 3)
    cot = rng.randn(*want.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, x: jnp.sum(f(p, x) * cot), (0, 1))(
        v["params"], x)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    out = tm(xt)
    assert out.is_contiguous(memory_format=torch.channels_last)
    close(nhwc(out), want, TOL, "output")
    (out * nchw(cot)).sum().backward()
    close(nhwc(xt.grad), np.asarray(gx), TOL, "input grad")
    grads = variables_from_jax({"params": jax.device_get(gp)})
    close(tm.weight.grad.numpy(), grads["weight"].numpy(), TOL, "kernel")
    close(tm.bias.grad.numpy(), grads["bias"].numpy(), TOL, "bias")


def test_reflect_pad_is_jnps_bit_for_bit():
    x = np.random.RandomState(0).randn(2, 9, 7, 3).astype(np.float32)
    for pad in (1, 3):
        want = np.asarray(jax_cyc.reflect_pad(jnp.asarray(x), pad))
        got = layers.reflect_pad(nchw(x), pad)
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(nhwc(got), want)


class NormNHWC(port_cyc._Norm):
    """The port's `_Norm` with the reference module's NHWC edge."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("use_in", [True, False])
def test_norm_matches_the_references(use_in):
    rng = np.random.RandomState(int(use_in))
    x = (rng.randn(3, 6, 5, 4) * 2 + 0.5).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    jm, tm = jax_cyc._Norm(use_in), NormNHWC(4, use_in)
    v = bridge(jm, tm, x, seed=2)
    check_train(jm, tm, v, x, (cot,), TOL)
    if use_in:
        assert not list(tm.buffers())  # no batch statistics: no kernel


# -- models -------------------------------------------------------------------

def test_dcgan_generator_as_registered():
    rng = np.random.RandomState(3)
    z = rng.randn(4, 100).astype(np.float32)
    jm, tm = jax_dcgan.Generator(), port_dcgan.Generator()
    v = bridge(jm, tm, z, seed=4)
    cot = rng.randn(4, 28, 28, 1).astype(np.float32)
    check_train_replayed(jm, tm, v, z, (cot,), MODEL_TOL)


def test_dcgan_discriminator_as_registered_with_jaxs_dropout_masks():
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    jm, tm = jax_dcgan.Discriminator(), port_dcgan.Discriminator()
    v = bridge(jm, tm, x, seed=6)
    cot = rng.randn(4, 1).astype(np.float32)
    check_train_replayed(jm, tm, v, x, (cot,), MODEL_TOL, dropout_seed=7)


#: the biases of convolutions whose output a `_Norm` normalises: zero
#: gradients in exact arithmetic (the normalisation removes a constant
#: shift), rounding noise on both sides, held at the tolerance x the
#: layer's kernel gradient (torch_parity.check_train's `cancelled`)
NORMED_BIASES = {"generator": {"Conv_0.bias": "Conv_0.weight",
                               "Conv_1.bias": "Conv_1.weight",
                               "Conv_2.bias": "Conv_2.weight",
                               "ConvTranspose_0.bias":
                                   "ConvTranspose_0.weight",
                               "ConvTranspose_1.bias":
                                   "ConvTranspose_1.weight"},
                 "discriminator": {"Conv_1.bias": "Conv_1.weight",
                                   "Conv_2.bias": "Conv_2.weight",
                                   "Conv_3.bias": "Conv_3.weight"}}


@pytest.mark.parametrize("kind", ["generator", "discriminator"])
def test_cyclegan_models_at_a_small_width(kind):
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    if kind == "generator":
        jm = jax_cyc.CycleGanGenerator(n_blocks=1, base=8)
        tm = port_cyc.CycleGanGenerator(n_blocks=1, base=8)
        out_shape = (2, 32, 32, 3)
    else:
        jm = jax_cyc.PatchGanDiscriminator(base=8)
        tm = port_cyc.PatchGanDiscriminator(base=8)
        out_shape = (2, 4, 4, 1)
    v = bridge(jm, tm, x, seed=9)
    cot = rng.randn(*out_shape).astype(np.float32)
    check_train_replayed(jm, tm, v, x, (cot,), MODEL_TOL,
                         cancelled=NORMED_BIASES[kind])


def test_registered_gan_models_load_the_references_trees():
    for name, jm, x in (
            ("dcgan_generator", jax_dcgan.Generator(), np.zeros((2, 100))),
            ("dcgan_discriminator", jax_dcgan.Discriminator(),
             np.zeros((2, 28, 28, 1))),
            ("cyclegan_generator", jax_cyc.CycleGanGenerator(),
             np.zeros((1, 32, 32, 3))),
            ("cyclegan_discriminator", jax_cyc.PatchGanDiscriminator(),
             np.zeros((1, 32, 32, 3)))):
        tm = get_model(name, device="cpu")
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.asarray(x, jnp.float32)))
        tm.load_state_dict(variables_from_jax(
            randomize(shapes, np.random.RandomState(0))))  # strict
    counts = {n: sum(p.numel() for p in get_model(n, device="cpu")
                     .parameters())
              for n in ("dcgan_generator", "dcgan_discriminator",
                        "cyclegan_generator", "cyclegan_discriminator")}
    assert counts == {"dcgan_generator": 2_305_472,
                      "dcgan_discriminator": 212_865,
                      "cyclegan_generator": 11_388_675,
                      "cyclegan_discriminator": 2_766_529}


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "bce_generator_loss", "bce_discriminator_loss", "lsgan_generator_loss",
    "lsgan_discriminator_loss", "cycle_consistency_loss", "identity_loss"])
def test_gan_losses_match_the_references(name):
    rng = np.random.RandomState(len(name))
    a = (rng.randn(3, 5, 5, 2) * 4).astype(np.float32)
    b = (rng.randn(3, 5, 5, 2) * 4).astype(np.float32)
    args = (a,) if name.endswith("generator_loss") else (a, b)
    want = float(getattr(ref_losses, name)(*map(jnp.asarray, args)))
    got = float(getattr(losses, name)(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- the image pool -----------------------------------------------------------

def test_image_pool_decisions_are_the_references_bit_for_bit():
    rng = np.random.RandomState(11)
    for size, seed in ((3, 1), (0, 2), (50, 2)):
        got, want = ImagePool(size, seed), RefImagePool(size, seed)
        for _ in range(8):
            batch = rng.randn(2, 4, 4, 3).astype(np.float32)
            np.testing.assert_array_equal(got.query(batch),
                                          want.query(batch))
        assert len(got.images) == len(want.images)
        for g, w in zip(got.images, want.images):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="at least one array"):
        ImagePool(3, 1).query(np.zeros((0, 4, 4, 3), np.float32))


# -- steps --------------------------------------------------------------------

def close_updated(state_model, new_params, grads, lr, name,
                  cancelled=None):
    """Every parameter after the step within 1e-2 lr + rtol 1e-5 of the
    reference's. Adam's first step moves a parameter by lr g / (|g| +
    eps): where the reference's gradient is rounding noise (|g| <=
    GRAD_NOISE x its tensor's largest or, for a `cancelled` bias that a
    normalisation removes (suffix -> its layer's kernel suffix), of its
    kernel's largest), by lr times the sign of that noise, so there
    within 2 lr."""
    want = variables_from_jax({"params": jax.device_get(new_params)})
    grad = variables_from_jax({"params": jax.device_get(grads)})
    got = dict(state_model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = grad[k].abs()
        scale = g.max()
        for suffix, ref in (cancelled or {}).items():
            if k.endswith(suffix):
                scale = grad[k[:-len(suffix)] + ref].abs().max()
        noise = (g <= GRAD_NOISE * scale).numpy()
        err = np.abs(got[k].detach().numpy() - w.numpy())
        allowed = np.where(noise, 2.0 * lr * (1 + 1e-3), 1e-2 * lr) \
            + 1e-5 * np.abs(w.numpy())
        assert (err <= allowed).all(), (
            f"{name}.{k}: {int((err > allowed).sum())} of {err.size} beyond "
            f"tolerance, worst {err.max()}")


def test_one_dcgan_step_matches_the_references_composition():
    """_step_impl's G and D updates from one numpy noise batch, dropout
    off (D's dropout layers at rate 0; the JAX D in eval mode, which
    only turns dropout off: it has no BatchNorm)."""
    rng = np.random.RandomState(12)
    real = rng.uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    noise = rng.randn(4, 100).astype(np.float32)
    jg, jd = jax_dcgan.Generator(), jax_dcgan.Discriminator()
    key = jax.random.PRNGKey(0)
    vg = randomize(jax.eval_shape(lambda: jg.init(key, jnp.asarray(noise))),
                   rng)
    vd = randomize(jax.eval_shape(lambda: jd.init(key, jnp.asarray(real))),
                   rng)
    vd["params"] = jax.tree_util.tree_map(lambda a: a * 0.1, vd["params"])
    lr = 1e-4
    g_tx, d_tx = (ref_build_optimizer("adam", lr) for _ in range(2))

    def g_loss_fn(g_params):
        with recording_activations() as seen:
            fake, upd = jg.apply({"params": g_params,
                                  "batch_stats": vg["batch_stats"]}, noise,
                                 train=True, mutable=["batch_stats"])
            logits = jd.apply(vd, fake, train=False)
        return ref_losses.bce_generator_loss(logits), (upd, fake, seen)

    def d_loss_fn(d_params, fake):
        d = {"params": d_params}
        with recording_activations() as seen:
            loss = ref_losses.bce_discriminator_loss(
                jd.apply(d, real, train=False),
                jd.apply(d, fake, train=False))
        return loss, seen

    @jax.jit
    def step():
        (gl, (upd, fake, g_acts)), gg = jax.value_and_grad(
            g_loss_fn, has_aux=True)(vg["params"])
        (dl, d_acts), dg = jax.value_and_grad(d_loss_fn, has_aux=True)(
            vd["params"], jax.lax.stop_gradient(fake))
        gu, _ = g_tx.update(gg, g_tx.init(vg["params"]), vg["params"])
        du, _ = d_tx.update(dg, d_tx.init(vd["params"]), vd["params"])
        return (gl, dl, optax.apply_updates(vg["params"], gu),
                optax.apply_updates(vd["params"], du), upd["batch_stats"],
                g_acts + d_acts, gg, dg)

    gl, dl, new_g, new_d, stats, acts, gg, dg = step()
    trainer = DcganTrainer(port_dcgan.Generator(), port_dcgan.Discriminator(),
                           build_optimizer("adam", lr),
                           build_optimizer("adam", lr), device="cpu")
    trainer.load_variables({"g": vg, "d": vd})
    for m in trainer.d_state.model.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    with ActivationReplay([np.asarray(a) for a in acts]) as replay:
        metrics = trainer.train_step(real, noise=noise)
    assert replay.left == 0 and replay.calls == 9
    np.testing.assert_allclose(float(metrics["g_loss"]), float(gl), rtol=TOL)
    np.testing.assert_allclose(float(metrics["d_loss"]), float(dl), rtol=TOL)
    close_updated(trainer.g_state.model, new_g, gg, lr, "G")
    close_updated(trainer.d_state.model, new_d, dg, lr, "D")
    buffers = dict(trainer.g_state.model.named_buffers())
    for k, w in variables_from_jax({"batch_stats": jax.device_get(
            stats)}).items():
        close(buffers[k].numpy(), w.numpy(), MODEL_TOL, k)
    assert trainer.g_state.step == trainer.d_state.step == 1


def test_dcgan_step_replays_noise_and_dropout_masks():
    """The same noise and masks on a second trainer give the same step;
    masks in call order, one a D application."""
    rng = np.random.RandomState(13)
    real = rng.uniform(-1, 1, (2, 28, 28, 1)).astype(np.float32)

    def make():
        g = port_dcgan.dcgan_generator()
        d = port_dcgan.dcgan_discriminator()
        layers.reset_flax_parameters(g, torch.Generator().manual_seed(0))
        layers.reset_flax_parameters(d, torch.Generator().manual_seed(1))
        return DcganTrainer(g, d, build_optimizer("adam", 1e-4),
                            build_optimizer("adam", 1e-4), device="cpu")

    a, b = make(), make()
    noise = rng.randn(2, 100).astype(np.float32)
    masks = [[torch.from_numpy(rng.rand(2, c, s, s) < 0.7)
              for c, s in ((64, 14), (128, 7))] for _ in range(3)]
    ma = a.train_step(real, noise=noise, dropout_masks=masks)
    mb = b.train_step(real, noise=noise, dropout_masks=masks)
    assert ma["g_loss"] == mb["g_loss"] and ma["d_loss"] == mb["d_loss"]
    for p, q in zip(a.d_state.model.parameters(),
                    b.d_state.model.parameters()):
        assert torch.equal(p, q)
    # drawn: a seeded stream a step, the same for the same step
    c, d = make(), make()
    assert c.train_step(real)["d_loss"] == d.train_step(real)["d_loss"]


def test_one_cyclegan_step_matches_the_references_composition():
    """_g_step_impl, the two pools, _d_step_impl: n_blocks=1, base=8,
    32x32, Adam b1 0.5."""
    rng = np.random.RandomState(14)
    real_a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    real_b = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jgen = jax_cyc.CycleGanGenerator(n_blocks=1, base=8)
    jdis = jax_cyc.PatchGanDiscriminator(base=8)
    key = jax.random.PRNGKey(0)
    trees = {}
    for name, jm in (("gab", jgen), ("gba", jgen), ("da", jdis),
                     ("db", jdis)):
        trees[name] = randomize(jax.eval_shape(
            lambda jm=jm: jm.init(key, jnp.asarray(real_a))), rng)
        trees[name]["params"] = jax.tree_util.tree_map(
            lambda a: a * 0.3, trees[name]["params"])
    lr = 2e-4
    txs = {k: ref_build_optimizer("adam", lr, b1=0.5) for k in trees}
    p = {k: v["params"] for k, v in trees.items()}

    def g_loss_fn(params):
        gab_p, gba_p = params

        def gab(x):
            return jgen.apply({"params": gab_p}, x, train=True)

        def gba(x):
            return jgen.apply({"params": gba_p}, x, train=True)

        def d(q, x):
            return jdis.apply({"params": q}, x, train=True)

        with recording_activations() as seen:  # _g_step_impl's order
            fake_b, fake_a = gab(real_a), gba(real_b)
            cycled_a, cycled_b = gba(fake_b), gab(fake_a)
            same_a, same_b = gba(real_a), gab(real_b)
            logits_fake_b, logits_fake_a = d(p["db"], fake_b), d(p["da"],
                                                                 fake_a)
        adv = (ref_losses.lsgan_generator_loss(logits_fake_b)
               + ref_losses.lsgan_generator_loss(logits_fake_a))
        cyc = (ref_losses.cycle_consistency_loss(real_a, cycled_a)
               + ref_losses.cycle_consistency_loss(real_b, cycled_b))
        ident = (ref_losses.identity_loss(real_a, same_a)
                 + ref_losses.identity_loss(real_b, same_b))
        return adv + cyc + ident, (fake_a, fake_b, seen)

    def d_loss_fn(params, fake_a, fake_b):
        da_p, db_p = params

        def d(q, x):
            return jdis.apply({"params": q}, x, train=True)

        with recording_activations() as seen:  # _d_step_impl's order
            ra, fa = d(da_p, real_a), d(da_p, fake_a)
            rb, fb = d(db_p, real_b), d(db_p, fake_b)
        return (ref_losses.lsgan_discriminator_loss(ra, fa)
                + ref_losses.lsgan_discriminator_loss(rb, fb)), seen

    def update(name, grads):
        u, _ = txs[name].update(grads, txs[name].init(p[name]), p[name])
        return optax.apply_updates(p[name], u)

    (gl, (fake_a, fake_b, g_acts)), (g_ab, g_ba) = jax.jit(
        jax.value_and_grad(g_loss_fn, has_aux=True))((p["gab"], p["gba"]))
    pool_a, pool_b = RefImagePool(50, seed=1), RefImagePool(50, seed=2)
    fake_a = pool_a.query(np.asarray(fake_a))
    fake_b = pool_b.query(np.asarray(fake_b))
    (dl, d_acts), (d_a, d_b) = jax.jit(jax.value_and_grad(
        d_loss_fn, has_aux=True))((p["da"], p["db"]), fake_a, fake_b)
    grads = {"gab": g_ab, "gba": g_ba, "da": d_a, "db": d_b}
    want = {k: update(k, g) for k, g in grads.items()}

    def tx_fn():
        return build_optimizer("adam", lr, b1=0.5)

    trainer = CycleGanTrainer(
        port_cyc.CycleGanGenerator(n_blocks=1, base=8),
        port_cyc.CycleGanGenerator(n_blocks=1, base=8),
        port_cyc.PatchGanDiscriminator(base=8),
        port_cyc.PatchGanDiscriminator(base=8), tx_fn, tx_fn,
        image_shape=(32, 32, 3), device="cpu")
    trainer.load_variables(trees)
    with ActivationReplay([np.asarray(a) for a in g_acts + d_acts]) as rep:
        metrics = trainer.train_step(real_a, real_b)
    assert rep.left == 0 and rep.calls == 6 * 6 + 6 * 4
    np.testing.assert_allclose(float(metrics["g_loss"]), float(gl), rtol=TOL)
    np.testing.assert_allclose(float(metrics["d_loss"]), float(dl), rtol=TOL)
    assert sorted(metrics) == ["d_loss", "g_adv", "g_cycle", "g_identity",
                               "g_loss"]
    states = trainer.states()
    for name, new in want.items():
        kind = "generator" if name.startswith("g") else "discriminator"
        close_updated(states[name].model, new, grads[name], lr, name,
                      NORMED_BIASES[kind])
        assert states[name].step == 1
    for got, ref in ((trainer.pool_a, pool_a), (trainer.pool_b, pool_b)):
        assert len(got.images) == len(ref.images) == 2
        for g, w in zip(got.images, ref.images):
            close(g, w, MODEL_TOL, "pooled image")


def test_cyclegan_keeps_only_the_first_applications_batch_statistics():
    """With use_in=False (BatchNorm) the G step keeps each generator's
    statistics of its real input only, and the D step each
    discriminator's of the real images, as the reference does."""
    torch.manual_seed(0)
    tx = lambda: build_optimizer("adam", 2e-4, b1=0.5)  # noqa: E731
    models = [port_cyc.CycleGanGenerator(n_blocks=1, base=8, use_in=False),
              port_cyc.CycleGanGenerator(n_blocks=1, base=8, use_in=False),
              port_cyc.PatchGanDiscriminator(base=8, use_in=False),
              port_cyc.PatchGanDiscriminator(base=8, use_in=False)]
    for m in models:
        layers.reset_flax_parameters(m, torch.Generator().manual_seed(0))
    trainer = CycleGanTrainer(*models, tx, tx, image_shape=(32, 32, 3),
                              device="cpu")
    real_a = torch.rand(2, 32, 32, 3) * 2 - 1
    real_b = torch.rand(2, 32, 32, 3) * 2 - 1
    expect = {}
    for name, model, x in (("gab", models[0], real_a),
                           ("gba", models[1], real_b),
                           ("da", models[2], real_a),
                           ("db", models[3], real_b)):
        probe = copy.deepcopy(model).train()
        with torch.no_grad():
            probe(x)
        expect[name] = dict(probe.named_buffers())
    trainer.train_step(real_a, real_b)
    for name, state in trainer.states().items():
        for k, b in state.model.named_buffers():
            torch.testing.assert_close(b, expect[name][k], rtol=0, atol=0)
