"""Port parity: deep_vision_tpu_torch/models/yolov3.py against the JAX
YOLOv3 and its blocks, through `variables_from_jax`.

Every variable and input is drawn with numpy from a seed and handed to
both packages. Blocks run at narrow widths; the whole YoloV3 runs at
64x64 with num_classes=4 (full depth: 75 ConvBN layers).

Tolerances: blocks rtol = atol = 1e-5 (one to five float32 convolutions;
XLA and PyTorch sum the window products in different orders, a few ulps
per layer). The whole model atol = rtol = 1e-4: the same reordering,
compounded through 75 layers and 23 residual adds, on outputs of
magnitude ~1 (measured max error ~4e-6, so the bound has 25x headroom).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.models import yolov3 as jax_yolo
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.models import yolov3 as port_yolo

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(tree, rng, damp_residuals=False):
    """Same structure, numpy leaves from `rng` (kernels at 1/sqrt(fan_in),
    BN statistics and affine terms away from init). With
    `damp_residuals`, each residual branch's last kernel is scaled by 0.1
    so 23 residual adds keep activations of order 1 instead of growing
    into saturated sigmoids."""
    def walk(t, path):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            shape = np.shape(v)
            if k == "kernel":
                a = rng.randn(*shape) / np.sqrt(int(np.prod(shape[:-1])))
                if (damp_residuals and len(path) >= 4
                        and path[-4].startswith("DarknetResidual")
                        and path[-3] == "DarknetConv_1"):
                    a = a * 0.1
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = rng.randn(*shape) * 0.1
            out[k] = a.astype(np.float32)
        return out

    return walk(tree, ())


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def bridge(jax_module, port_module, x, seed):
    v = jax.device_get(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                       train=False))
    v = randomize(v, np.random.RandomState(seed))
    port_module.load_state_dict(variables_from_jax(v))
    return v, port_module.eval()


@pytest.mark.parametrize("strides", [1, 2])
def test_darknet_conv(strides):
    rng = np.random.RandomState(strides)
    x = rng.rand(2, 8, 8, 6).astype(np.float32)
    jm = jax_yolo.DarknetConv(12, 3, strides=strides)
    v, tm = bridge(jm, port_yolo.DarknetConv(6, 12, 3, strides), x, 10)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


def test_darknet_residual():
    x = np.random.RandomState(2).randn(2, 6, 6, 8).astype(np.float32)
    jm = jax_yolo.DarknetResidual(8)
    v, tm = bridge(jm, port_yolo.DarknetResidual(8), x, 11)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


def test_yolo_neck():
    x = np.random.RandomState(3).randn(1, 5, 5, 12).astype(np.float32)
    jm = jax_yolo.YoloNeck(8)
    v, tm = bridge(jm, port_yolo.YoloNeck(12, 8), x, 12)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


def test_yolo_head_layout():
    x = np.random.RandomState(4).randn(2, 4, 4, 8).astype(np.float32)
    jm = jax_yolo.YoloHead(4, 3, 2)
    v, tm = bridge(jm, port_yolo.YoloHead(8, 4, 3, 2), x, 13)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 3, 7)
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


@pytest.fixture(scope="module")
def yolo_pair():
    jm = jax_yolo.YoloV3(num_classes=4)
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               train=False))
    v = randomize(v, np.random.RandomState(14), damp_residuals=True)
    tm = get_model("yolov3", num_classes=4, device="cpu")
    tm.load_state_dict(variables_from_jax(v))
    return jm, v, tm, x


def test_whole_yolov3_raw_outputs(yolo_pair):
    jm, v, tm, x = yolo_pair
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    shapes = [(2, 2, 2, 3, 9), (2, 4, 4, 3, 9), (2, 8, 8, 3, 9)]
    for w, g, shape in zip(want, got, shapes):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape) == shape
        # not saturated: the comparison is about numbers, not about 0/1
        assert 0.05 < np.abs(w).max() < 50.0
        np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL)


def test_darknet53_features_match(yolo_pair):
    jm, v, tm, x = yolo_pair
    sub = {c: v[c]["Darknet53_0"] for c in v}
    want = jax_yolo.Darknet53().apply(sub, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.Darknet53_0(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_bridge_covers_every_variable(yolo_pair):
    _, v, tm, _ = yolo_pair
    sd = variables_from_jax(v)
    assert set(sd) == set(tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(
            v["params"]))
    key = "Darknet53_0.DarknetConv_0.ConvBN_0.Conv_0.weight"
    np.testing.assert_array_equal(
        sd[key].numpy(),
        v["params"]["Darknet53_0"]["DarknetConv_0"]["ConvBN_0"]["Conv_0"]
        ["kernel"].transpose(3, 2, 0, 1))


def test_full_width_parameter_count():
    # 80 COCO classes: the published YOLOv3 size, without running it
    with torch.device("meta"):
        m = port_yolo.YoloV3(num_classes=80)
    assert sum(p.numel() for p in m.parameters()) == 61_949_149


def test_bridge_rejects_unknown_collections_and_kernels():
    with pytest.raises(ValueError, match="collections"):
        variables_from_jax({"params": {}, "cache": {}})
    with pytest.raises(ValueError, match="HWIO"):
        variables_from_jax({"params": {"Dense_0": {
            "kernel": np.zeros((3, 4, 5), np.float32)}}})
