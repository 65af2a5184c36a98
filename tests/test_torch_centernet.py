"""Port parity: the CenterNet slice (deep_vision_tpu_torch/models/
centernet.py, losses/heatmap.py's CenterNet losses and inference.py's
peak decode) against the JAX package on the CPU.

Every variable and input is drawn with numpy from a seed and handed to
both packages; the port takes the JAX run's ReLU decisions
(torch_parity.ActivationReplay).

- The innermost CenterHourglassModule (order 1, 384 -> 512): outputs,
  batch statistics and every gradient at rtol 1e-4.
- ObjectsAsPoints(num_stack=1), 6 classes, at the registered 512x512
  input, batch 1, training mode, each residual branch's last kernel
  scaled by 0.1 (torch_parity.damp_residual_branches): every head's
  output and the batch statistics at rtol 1e-4, every gradient within
  2e-2 of its tensor's largest (GRAD_TOL); float32 convolutions summed
  in other orders through 34 bottlenecks at the fixed `_CURR_DIMS`
  widths, 256 to 512 (the JAX variables drawn from `jax.eval_shape`, as
  torch_parity.bridge does). At 128x128 the deepest normalisations see
  1 and 4 rows a channel, and the gradients through them are
  ill-conditioned: JAX's own float32 run strays from its float64 one by
  percents there.
- The losses (focal, masked L1, centernet_loss_fn and its metrics):
  rtol 1e-6.
- centernet_decode with many tied scores (quantised logits): classes,
  num and the order of the picks equal (lax.top_k's lowest index first),
  boxes and scores within 1e-6.
- The registered objects_as_points: its 199 BatchNorms, every input
  channels_last.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu import inference as ref_inference
from deep_vision_tpu.losses import heatmap as ref_heatmap
from deep_vision_tpu.models import centernet as jax_cn
from deep_vision_tpu_torch import inference
from deep_vision_tpu_torch.losses import heatmap
from deep_vision_tpu_torch.models import centernet as port_cn
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.nn.layers import BatchNorm, reset_flax_parameters
from deep_vision_tpu_torch.convert import variables_from_jax
from torch_parity import (
    bridge,
    check_train_replayed,
    damp_residual_branches,
)

MODEL_TOL = 1e-4
#: the whole model's gradients: relative to each tensor's largest (as
#: chip_smoke's ZOO_CHECK_TOL holds deep nets); the worst measured is
#: 0.24% (a projection kernel's gradient, a sum over 256x256 pixels)
GRAD_TOL = 2e-2
#: the registered model's training BatchNorms
CENTERNET_BN = 199
HEADS = ("heatmap", "wh", "offset")


@pytest.fixture(autouse=True)
def two_torch_threads():
    """torch on two threads for each test: with several test processes
    on one host, torch's default of a thread a core oversubscribes the
    cores (a CycleGAN run took 100x its serial time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class JaxFlat(jax_cn.ObjectsAsPoints):
    """The reference model with its per-stack head dicts flattened into a
    tuple, for torch_parity's output comparison; the variable tree is
    the reference's."""

    def __call__(self, x, train: bool = True):
        return tuple(head[k] for head in super().__call__(x, train)
                     for k in HEADS)


class PortFlat(port_cn.ObjectsAsPoints):
    def forward(self, images):
        return tuple(head[k] for head in super().forward(images)
                     for k in HEADS)


class ModuleNHWC(port_cn.CenterHourglassModule):
    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_center_hourglass_module_matches_the_reference():
    """The innermost module (order 1: 384 -> 512 wide) at 8x8, batch 2:
    outputs, statistics and every gradient at rtol 1e-4."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 384).astype(np.float32)
    jm, tm = jax_cn.CenterHourglassModule(1), ModuleNHWC(1)
    v = bridge(jm, tm, x, seed=5)
    cot = rng.randn(2, 8, 8, 384).astype(np.float32)
    check_train_replayed(jm, tm, v, x, (cot,), MODEL_TOL)


def test_objects_as_points_one_stack():
    """num_stack=1, 6 classes, at the registered 512x512 input, batch 1
    (the deepest normalisations see 16 rows), each residual branch's
    last kernel scaled by 0.1."""
    rng = np.random.RandomState(0)
    x = rng.rand(1, 512, 512, 3).astype(np.float32)
    jm = JaxFlat(num_classes=6, num_stack=1)
    tm = PortFlat(num_classes=6, num_stack=1)
    v = bridge(jm, tm, x, seed=1)
    tm.load_state_dict(variables_from_jax(damp_residual_branches(v)))
    cots = tuple(rng.randn(1, 128, 128, c).astype(np.float32)
                 for c in (6, 2, 2))
    replay = check_train_replayed(jm, tm, v, x, cots, MODEL_TOL,
                                  grad_rtol=GRAD_TOL)
    assert replay.calls == 1 + 3 * 34 + 3  # stem, 34 bottlenecks, heads


def test_registered_objects_as_points_batchnorms_read_channels_last():
    model = get_model("objects_as_points", num_classes=80, device="cpu",
                      train=True)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].is_contiguous(
            memory_format=torch.channels_last)))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        out = model(torch.rand(1, 128, 128, 3))
    for h in hooks:
        h.remove()
    assert len(hooks) == len(seen) == CENTERNET_BN and all(seen)
    assert len(out) == 2 and out[-1]["heatmap"].shape == (1, 32, 32, 80)
    assert sum(p.numel() for p in model.parameters()) == 32_399_400
    bias = model.stacks[0][2].branches[0][1].bias
    assert torch.all(bias == port_cn.HEATMAP_BIAS)


def batch(rng, b=2, h=16, w=16, c=3):
    hm = np.where(rng.rand(b, h, w, c) > 0.8, rng.rand(b, h, w, c), 0.0)
    mask = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(3):
            y, x = rng.randint(h), rng.randint(w)
            hm[i, y, x, rng.randint(c)] = 1.0
            mask[i, y, x] = 1.0
    return {"heatmap": hm.astype(np.float32),
            "wh": (rng.rand(b, h, w, 2) * 5).astype(np.float32),
            "offset": rng.rand(b, h, w, 2).astype(np.float32),
            "mask": mask}


def heads(rng, n=2, b=2, h=16, w=16, c=3):
    return [{"heatmap": (rng.randn(b, h, w, c) * 3).astype(np.float32),
             "wh": (rng.rand(b, h, w, 2) * 5).astype(np.float32),
             "offset": rng.rand(b, h, w, 2).astype(np.float32)}
            for _ in range(n)]


def to(tree, fn):
    if isinstance(tree, dict):
        return {k: to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, fn) for v in tree]
    return fn(tree)


def test_centernet_losses_match_the_references():
    rng = np.random.RandomState(2)
    b, outs = batch(rng), heads(rng)
    np.testing.assert_allclose(
        float(heatmap.centernet_focal_loss(torch.from_numpy(
            outs[0]["heatmap"]), torch.from_numpy(b["heatmap"]))),
        float(ref_heatmap.centernet_focal_loss(
            jnp.asarray(outs[0]["heatmap"]), jnp.asarray(b["heatmap"]))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(heatmap._masked_l1(*(torch.from_numpy(a) for a in (
            outs[0]["wh"], b["wh"], b["mask"])))),
        float(ref_heatmap._masked_l1(*(jnp.asarray(a) for a in (
            outs[0]["wh"], b["wh"], b["mask"])))), rtol=1e-6)
    got_loss, got = heatmap.centernet_loss_fn(to(outs, torch.from_numpy),
                                              to(b, torch.from_numpy))
    want_loss, want = ref_heatmap.centernet_loss_fn(to(outs, jnp.asarray),
                                                    to(b, jnp.asarray))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("max_detections,threshold", [(100, 0.1),
                                                      (2000, 0.0)])
def test_centernet_decode_breaks_ties_as_lax_top_k(max_detections,
                                                   threshold):
    rng = np.random.RandomState(3)
    head = heads(rng, n=1, h=8, w=12, c=5)[0]
    # quantised logits: many exactly equal scores and plateaus of peaks
    head["heatmap"] = (rng.randint(-3, 3, head["heatmap"].shape)
                       .astype(np.float32))
    want = ref_inference.centernet_decode(
        to(head, jnp.asarray), max_detections=max_detections,
        score_threshold=threshold)
    got = inference.centernet_decode(
        to(head, torch.from_numpy), max_detections=max_detections,
        score_threshold=threshold)
    for k in ("classes", "num"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert got["boxes"].shape == (2, max_detections, 4)


def test_centernet_detector_decodes_the_last_stack():
    model = port_cn.ObjectsAsPoints(num_classes=3, num_stack=2)
    reset_flax_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.rand(1, 128, 128, 3)
    detect = inference.make_centernet_detector(model, device="cpu")
    got = detect(dict(model.state_dict()), x)
    with torch.no_grad():
        want = inference.centernet_decode(model(x)[-1])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
