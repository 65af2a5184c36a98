"""Port parity: the training slice (train/optimizers.py, losses/,
core/metrics.py, core/train_state.py, train/trainer.py,
tools/profile_train.py) against the JAX package, on small shapes, in
f32.

Variables, gradients and batches are drawn with numpy from a seed and
handed to both sides. The JAX Trainer runs on a one-device mesh (as the
port does) with DVT_PALLAS_FUSED=1, so its BatchNorms take the folded
bn_act arithmetic (interpret mode), as on a TPU.

Tolerances, each with its reason:
- optimizer: rtol = atol = 1e-6. The same f32 arithmetic, but PyTorch's
  CPU `add_(alpha=-lr)` may fuse the multiply-add that optax rounds
  twice: an ulp or two per step.
- loss and metrics: rtol = atol = 1e-6; the same f32 formula, reduced in
  another order.
- three Trainer steps: the step metrics at rtol = 1e-4, atol = 1e-4 x
  the largest magnitude, as in tests/test_torch_resnet.py (convolutions
  and BatchNorm statistics summed in another order, magnified by the
  batch standard deviations). Each parameter's update over the three
  steps (after minus before, on each side) within UPDATE_RTOL of the
  largest update of its tensor: a step at lr 0.1 moves a parameter by a
  few percent, so the parameters themselves would hide an update wrong
  by as much. The forwards agree to ~1e-5 of each tensor's largest
  value, and the errors compound over the steps: 1.1e-3 observed here.
  The running statistics at rtol = 1e-3. The seed matters: at a seed
  where a ReLU input lies within that ~1e-5 of zero, it falls to
  opposite sides, and the one element's gradient moves a bias update by
  up to ~20% (seed 13: 8.4e-6 in the reference, 0 here, in the last
  block of the second stage), though each side alone moves its updates
  by ~2e-5 when its input moves by one ulp. Seed 7 has no such element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.losses.classification import (
    classification_loss_fn as jax_loss_fn,
)
from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu.parallel.mesh import create_mesh
from deep_vision_tpu.train.optimizers import _decay_mask
from deep_vision_tpu.train.optimizers import build_optimizer as jax_build
from deep_vision_tpu.train.trainer import Trainer as JaxTrainer
from deep_vision_tpu_torch.tools.profile_train import (
    input_shape,
    make_train_parts,
)
from deep_vision_tpu_torch.convert import flax_path, variables_from_jax
from deep_vision_tpu_torch.core.metrics import topk_accuracy
from deep_vision_tpu_torch.core.train_state import create_train_state
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import resnet
from deep_vision_tpu_torch.train import Trainer, build_optimizer, set_lr
from deep_vision_tpu_torch.train.optimizers import decay_mask

TIGHT = dict(rtol=1e-6, atol=1e-6)
UPDATE_RTOL = 5e-3


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setenv("DVT_PALLAS_FUSED", "1")


def close(got, want, name="", rtol=1e-4):
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=name)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def tiny(seed, hw=16, batch=8):
    """JAX and port tiny ResNets (s2d, widths 8..64, 10 classes) holding
    the same random variables, and one seeded batch."""
    jm = jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                           stem="s2d")
    tm = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                       stem="s2d")
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, hw, hw, 12).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = randomize(v, rng)
    tm.load_state_dict(variables_from_jax(v))
    labels = rng.randint(0, 10, size=(batch,)).astype(np.int32)
    return jm, tm, v, {"image": x, "label": labels}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = v
    return out


# -- optimizer ---------------------------------------------------------------

@pytest.mark.parametrize("decay_bn_bias", [False, True])
def test_decay_mask_matches_reference_name_for_name(decay_bn_bias):
    _, tm, v, _ = tiny(1)
    want = flat(jax.device_get(_decay_mask(v["params"], decay_bn_bias)))
    got = decay_mask((n for n, _ in tm.named_parameters()), decay_bn_bias)
    assert {flax_path(n): m for n, m in got.items()} == want
    if not decay_bn_bias:
        assert got["SpaceToDepthStem_0.weight"] and got["Dense_0.weight"]
        assert not got["Dense_0.bias"] and not got["BatchNorm_0.scale"]


@pytest.mark.parametrize("nesterov,decay_bn_bias,momentum",
                         [(False, False, 0.9), (True, False, 0.9),
                          (False, True, 0.9), (True, True, 0.5),
                          (False, False, 0.0)])
def test_sgd_matches_optax_chain(nesterov, decay_bn_bias, momentum):
    _, tm, v, _ = tiny(2)
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=1e-2,
              decay_bn_bias=decay_bn_bias)
    jtx = jax_build("sgd", 0.1, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = jtx.init(params)
    opt = build_optimizer("sgd", 0.1, **kw)(tm)
    named = dict(tm.named_parameters())
    rng = np.random.RandomState(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), v["params"])
        updates, state = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for k, g in variables_from_jax({"params": grads}).items():
            named[k].grad = g
        opt.step()
    want = variables_from_jax({"params": jax.device_get(params)})
    for k, w in want.items():
        np.testing.assert_allclose(named[k].detach().numpy(), w.numpy(),
                                   err_msg=k, **TIGHT)


def test_set_lr_and_unported_options():
    _, tm, _, _ = tiny(3)
    opt = build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=1e-4)(tm)
    assert [g["weight_decay"] for g in opt.param_groups] == [1e-4, 0.0]
    set_lr(opt, 0.025)
    assert [g["lr"] for g in opt.param_groups] == [0.025, 0.025]
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("adafactor", 1e-3)
    spec = build_optimizer("sgd", lambda step: 0.1 * step, momentum=0.9)
    assert spec(tm).param_groups[0]["lr"] == 0.0  # schedule(0)
    assert spec.schedule(3) == pytest.approx(0.3)


# -- loss and metrics --------------------------------------------------------

def loss_inputs(seed, b=6, c=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, c).astype(np.float32) * 3
    labels = rng.randint(0, c, size=(b,)).astype(np.int32)
    mask = (rng.rand(b) > 0.3).astype(np.float32)
    aux = rng.randn(b, c).astype(np.float32)
    return logits, labels, mask, aux


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_aux", [False, True])
def test_classification_loss_matches_reference(smoothing, masked, with_aux):
    logits, labels, mask, aux = loss_inputs(int(smoothing * 10) + masked)
    penalties = {"moe_aux": np.float32(0.5), "_entropy": np.float32(1.25)}
    j_out = ((jnp.asarray(logits), jnp.asarray(aux), penalties)
             if with_aux else jnp.asarray(logits))
    t_out = ((torch.from_numpy(logits), torch.from_numpy(aux),
              {k: torch.tensor(v) for k, v in penalties.items()})
             if with_aux else torch.from_numpy(logits))
    j_batch = {"label": jnp.asarray(labels)}
    t_batch = {"label": torch.from_numpy(labels)}
    if masked:
        j_batch["_mask"] = jnp.asarray(mask)
        t_batch["_mask"] = torch.from_numpy(mask)
    want_loss, want = jax_loss_fn(j_out, j_batch, label_smoothing=smoothing)
    got_loss, got = classification_loss_fn(t_out, t_batch,
                                           label_smoothing=smoothing)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TIGHT)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **TIGHT)


@pytest.mark.parametrize("aux", [{"loss": 1.0}, {"_top1": 1.0},
                                 {"x": 1.0, "_x": 2.0}])
def test_reserved_and_duplicate_aux_names_raise_as_in_reference(aux):
    logits, labels, _, _ = loss_inputs(4)
    with pytest.raises(ValueError):
        jax_loss_fn((jnp.asarray(logits), aux), {"label": labels})
    with pytest.raises(ValueError):
        classification_loss_fn(
            (torch.from_numpy(logits),
             {k: torch.tensor(v) for k, v in aux.items()}),
            {"label": torch.from_numpy(labels)})


def test_topk_ties_order_by_class_index_as_jnp_argsort():
    from deep_vision_tpu.core.metrics import topk_accuracy as jax_topk

    logits = np.zeros((4, 8), np.float32)
    logits[:, 5] = 1.0  # class 5 first, then 0, 1, 2, 3 tied at 0
    labels = np.array([5, 0, 3, 4], np.int32)
    want = jax_topk(jnp.asarray(logits), jnp.asarray(labels))
    got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in want.items()} == {"top1": 0.25, "top5": 0.75}


# -- train state and Trainer -------------------------------------------------

def test_three_trainer_steps_match_jax_trainer():
    jm, tm, v, batch = tiny(7)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    jt = JaxTrainer(jm, jax_build("sgd", 0.1, **kw), jax_loss_fn,
                    jnp.zeros((8, 16, 16, 12)),
                    mesh=create_mesh(devices=jax.devices()[:1]))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.state = jt.state.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        opt_state=jt.state.tx.init(params))
    tt = Trainer(tm, build_optimizer("sgd", 0.1, **kw), classification_loss_fn,
                 torch.zeros(8, 16, 16, 12), device="cpu")
    rng = np.random.RandomState(8)
    for step in range(3):
        b = dict(batch, image=batch["image"] + rng.rand(
            *batch["image"].shape).astype(np.float32) * 0.1)
        want = jax.device_get(jt.train_step(b))
        got = tt.train_step(b)
        for k in ("loss", "top1", "top5", "grad_norm"):
            close(float(got[k]), float(want[k]), f"step {step} {k}")
    assert tt.state.step == 3 and int(jt.state.step) == 3
    start = variables_from_jax(v)
    want = variables_from_jax(jax.device_get(jt.state.variables))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    params = {n for n, _ in tm.named_parameters()}
    for k, w in want.items():
        if k in params:  # the update, against the largest of its tensor
            close(got[k].numpy() - start[k].numpy(),
                  w.numpy() - start[k].numpy(), k, rtol=UPDATE_RTOL)
        else:
            close(got[k].numpy(), w.numpy(), k, rtol=1e-3)


def test_trainer_eval_evaluate_and_fit():
    _, tm, _, batch = tiny(9, batch=4)
    tt = Trainer(tm, build_optimizer("sgd", 0.05, momentum=0.9),
                 classification_loss_fn, torch.zeros(1, 16, 16, 12),
                 device="cpu")
    assert tm.training  # create_train_state keeps the caller's mode
    stats = {k: v.clone() for k, v in tm.named_buffers()}
    masked = dict(batch, _mask=np.array([1, 1, 0, 0], np.float32))
    m_full = tt.eval_step(batch)
    summary = tt.evaluate([batch, masked])
    # eval leaves the running statistics alone; rows weight the mean
    for k, v in tm.named_buffers():
        assert torch.equal(v, stats[k]), k
    m_half = tt.eval_step(masked)
    for k in ("loss", "top1", "top5"):
        want = (float(m_full[k]) * 4 + float(m_half[k]) * 2) / 6
        assert summary[k] == pytest.approx(want, rel=1e-6)
    history = tt.fit(lambda: [batch] * 3, lambda: [batch], epochs=2)
    assert [h["epoch"] for h in history] == [0, 1] and tt.state.step == 6
    assert history[1]["train"]["loss"] < history[0]["train"]["loss"]
    assert set(history[1]["val"]) == {"loss", "top1", "top5"}


def test_create_train_state_checks_the_sample_input():
    _, tm, _, _ = tiny(10)
    tx = build_optimizer("sgd", 0.1)
    state = create_train_state(tm.train(), tx, torch.zeros(2, 16, 16, 12),
                               device="cpu")
    assert state.step == 0 and tm.training
    assert state.generator.device.type == "cpu"
    with pytest.raises(RuntimeError):
        create_train_state(tm, tx, torch.zeros(2, 16, 16, 3), device="cpu")


def test_make_train_parts_builds_the_reference_batch():
    trainer, batch = make_train_parts(2, "s2d", device="cpu",
                                      dtype=torch.float32)
    rng = np.random.RandomState(0)
    images = rng.rand(2, *input_shape("s2d")).astype(np.float32)
    assert torch.equal(batch["image"], torch.from_numpy(images))
    assert batch["label"].tolist() == rng.randint(0, 1000, size=(2,)).tolist()
    model = trainer.model
    assert model.BottleneckBlock_15.BatchNorm_0.scale.shape == (2048,)
    assert [g["weight_decay"] for g in trainer.state.optimizer.param_groups] \
        == [1e-4, 0.0]
    assert input_shape("conv7") == (224, 224, 3)
    assert input_shape("s2d") == (112, 112, 12)


def test_profile_groups_attribute_kernels_by_name_range_and_sequence():
    from types import SimpleNamespace as Ns

    from deep_vision_tpu_torch.nn.layers import BN_STATS_RANGE
    from deep_vision_tpu_torch.tools.profile_train import kernel_groups

    def op(name, kernels=(), parent=None, seq=-1):
        return Ns(name=name, cpu_parent=parent, sequence_nr=seq,
                  kernels=[Ns(name=k, duration=d) for k, d in kernels])

    stats = op(BN_STATS_RANGE)
    step = op("Optimizer.step#SGD.step")
    backward = op("autograd::engine::evaluate_function: MeanBackward1",
                  seq=7)
    events = [
        stats, step, backward,
        op("aten::mean", [("reduce_kernel", 3.0)], stats, seq=7),
        op("aten::mul", [("elementwise_kernel", 5.0)], backward),
        op("_BnAct", [("void fwd_rows<bf16>", 2.0)]),
        op("_BnActBackward", [("void bwd_rows<bf16>", 4.0),
                              ("reduce_partials", 1.0)]),
        op("aten::_foreach_add_", [("multi_tensor_apply_kernel", 6.0)],
           step),
        op("aten::cudnn_convolution", [("sm90_xmma_fprop_bf16", 9.0)]),
        op("aten::max_pool2d", [("max_pool_forward_nhwc", 8.0)]),
    ]
    assert kernel_groups(events) == {
        "conv": 9.0, "bn_act_fwd": 2.0, "bn_act_bwd": 5.0, "bn_stats": 8.0,
        "optimizer": 6.0, "other": 8.0}
