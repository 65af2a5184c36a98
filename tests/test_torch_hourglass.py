"""Port parity: the pose slice (deep_vision_tpu_torch/models/hourglass.py,
losses/heatmap.py's hourglass_loss_fn, inference.py's pose decode and
core/detection_metrics.py's pck / pckh) against the JAX package on the
CPU.

Every variable and input is drawn with numpy from a seed and handed to
both packages (JAX variables from `jax.eval_shape`, bridged by
convert.variables_from_jax); the port takes the JAX run's ReLU decisions
(torch_parity.ActivationReplay: an input within rounding of zero falls
either way, and a flip moves the gradients upstream of it by percents).

- Nearest 2x upsampling: bit for bit `jnp.repeat` on H and W.
- HgBottleneck (with and without its projection) and an order-2
  HourglassModule, training mode: outputs, batch statistics and every
  parameter's gradient, rtol 1e-4 (float32 convolutions summed in other
  orders). StackedHourglass(num_stack=2, num_heatmap=4, features=16) at
  the registered 256x256 input, batch 1, each residual branch's last
  kernel scaled by 0.1 (torch_parity.damp_residual_branches): outputs
  and batch statistics at rtol 1e-4, every gradient within 2e-2 of its
  tensor's largest (GRAD_TOL). At 64x64 the deepest normalisations see
  one pixel a sample and the gradients through them are ill-conditioned:
  JAX's own float32 run strays from its float64 one there.
- hourglass_loss_fn: rtol 1e-6. heatmaps_to_keypoints: equal, ties
  included (the first maximum). pck and pckh: equal.
- The registered hourglass: its 182 BatchNorms, every input
  channels_last (the layout the moments kernels read on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu import inference as ref_inference
from deep_vision_tpu.core import detection_metrics as ref_metrics
from deep_vision_tpu.losses import heatmap as ref_heatmap
from deep_vision_tpu.models import hourglass as jax_hg
from deep_vision_tpu_torch import inference
from deep_vision_tpu_torch.core import detection_metrics
from deep_vision_tpu_torch.losses import heatmap
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.models import hourglass as port_hg
from deep_vision_tpu_torch.nn.layers import (
    BatchNorm,
    reset_flax_parameters,
    upsample_nearest2x,
)
from deep_vision_tpu_torch.convert import variables_from_jax
from torch_parity import (
    bridge,
    check_train_replayed,
    damp_residual_branches,
)

MODEL_TOL = 1e-4
#: the whole model's gradients: relative to each tensor's largest (as
#: chip_smoke's ZOO_CHECK_TOL holds deep nets); the worst measured is
#: 0.64% (a projection kernel's gradient, a sum over 128x128 pixels
#: whose terms cancel)
GRAD_TOL = 2e-2

#: the registered model's training BatchNorms (the reference's variable
#: tree has as many)
HOURGLASS_BN = 182


@pytest.fixture(autouse=True)
def two_torch_threads():
    """torch on two threads for each test: with several test processes
    on one host, torch's default of a thread a core oversubscribes the
    cores (a CycleGAN run took 100x its serial time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class BottleneckNHWC(port_hg.HgBottleneck):
    """The port's HgBottleneck with the reference module's NHWC edge."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_upsampling_is_jnp_repeat_bit_for_bit():
    x = np.random.RandomState(0).randn(2, 5, 3, 4).astype(np.float32)
    want = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)
    got = upsample_nearest2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.repeat(jnp.repeat(
        jnp.asarray(x), 2, axis=1), 2, axis=2)), want)


@pytest.mark.parametrize("in_features,features", [(8, 16), (16, 16)])
def test_bottleneck_matches_the_reference(in_features, features):
    rng = np.random.RandomState(in_features)
    x = rng.randn(2, 6, 6, in_features).astype(np.float32)
    jm = jax_hg.HgBottleneck(features)
    tm = BottleneckNHWC(in_features, features)
    v = bridge(jm, tm, x, seed=1)
    cot = rng.randn(2, 6, 6, features).astype(np.float32)
    replay = check_train_replayed(jm, tm, v, x, (cot,), MODEL_TOL)
    assert replay.calls == 3
    assert bool(tm.project) == (in_features != features)


class ModuleNHWC(port_hg.HourglassModule):
    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def test_hourglass_module_matches_the_reference():
    """An order-2 module at 16x16, batch 4: its deepest normalisations
    see 64 rows; outputs, statistics and every gradient at rtol 1e-4."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 16, 16, 16).astype(np.float32)
    jm = jax_hg.HourglassModule(2, features=16)
    tm = ModuleNHWC(2, features=16)
    v = bridge(jm, tm, x, seed=8)
    cot = rng.randn(4, 16, 16, 16).astype(np.float32)
    check_train_replayed(jm, tm, v, x, (cot,), MODEL_TOL)


def test_stacked_hourglass_at_a_small_width():
    """num_stack=2, num_heatmap=4, features=16 at the registered 256x256
    input, batch 1 (the deepest normalisations see 16 rows)."""
    rng = np.random.RandomState(2)
    x = rng.rand(1, 256, 256, 3).astype(np.float32)
    jm = jax_hg.StackedHourglass(num_stack=2, num_heatmap=4, features=16)
    tm = port_hg.StackedHourglass(num_stack=2, num_heatmap=4, features=16)
    v = bridge(jm, tm, x, seed=3)
    tm.load_state_dict(variables_from_jax(damp_residual_branches(v)))
    cots = tuple(rng.randn(1, 64, 64, 4).astype(np.float32)
                 for _ in range(2))
    check_train_replayed(jm, tm, v, x, cots, MODEL_TOL, grad_rtol=GRAD_TOL)


def test_registered_hourglass_batchnorms_read_channels_last():
    model = get_model("hourglass", device="cpu", train=True)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].is_contiguous(
            memory_format=torch.channels_last)))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        out = model(torch.rand(1, 64, 64, 3))
    for h in hooks:
        h.remove()
    assert len(hooks) == len(seen) == HOURGLASS_BN and all(seen)
    assert len(out) == 4 and out[-1].shape == (1, 16, 16, 16)
    assert sum(p.numel() for p in model.parameters()) == 12_825_600


def test_hourglass_loss_matches_the_reference():
    rng = np.random.RandomState(4)
    outs = [rng.randn(2, 8, 8, 3).astype(np.float32) for _ in range(3)]
    gt = np.where(rng.rand(2, 8, 8, 3) > 0.7, rng.rand(2, 8, 8, 3),
                  0.0).astype(np.float32)
    want_loss, want = ref_heatmap.hourglass_loss_fn(
        [jnp.asarray(o) for o in outs], {"heatmap": jnp.asarray(gt)})
    got_loss, got = heatmap.hourglass_loss_fn(
        [torch.from_numpy(o) for o in outs], {"heatmap": torch.from_numpy(gt)})
    assert sorted(got) == sorted(want) == ["last_stack_mse", "loss"]
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_heatmaps_to_keypoints_take_the_first_maximum():
    rng = np.random.RandomState(5)
    hm = rng.randint(0, 4, (3, 6, 5, 4)).astype(np.float32)  # many ties
    hm[0, :, :, 0] = 0.0  # all tied
    want = np.asarray(ref_inference.heatmaps_to_keypoints(jnp.asarray(hm)))
    got = inference.heatmaps_to_keypoints(torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pose_estimator_decodes_the_last_stack():
    model = port_hg.StackedHourglass(num_stack=2, num_heatmap=4, features=16)
    reset_flax_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.rand(2, 64, 64, 3)
    estimate = inference.make_pose_estimator(model, device="cpu")
    got = estimate(dict(model.state_dict()), x)
    with torch.no_grad():
        want = inference.heatmaps_to_keypoints(model(x)[-1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.shape == (2, 4, 3)


@pytest.mark.parametrize("alpha", [0.5, 0.05])
def test_pck_and_pckh_match_the_references(alpha):
    rng = np.random.RandomState(6)
    gt = rng.rand(7, 16, 2).astype(np.float32)
    pred = (gt + rng.randn(7, 16, 2) * 0.05).astype(np.float32)
    vis = rng.rand(7, 16) > 0.2
    vis[:, 3] = False  # a joint never visible: nan per joint
    norms = rng.uniform(0.05, 0.3, 7).astype(np.float32)
    for name in ("pck", "pckh"):
        got = getattr(detection_metrics, name)(pred, gt, vis, norms, alpha)
        want = getattr(ref_metrics, name)(pred, gt, vis, norms, alpha)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
