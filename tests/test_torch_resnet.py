"""Port parity: deep_vision_tpu_torch/models/resnet.py and the training
path of nn/layers.py against the JAX ResNet, on small shapes, in f32.

The JAX side runs with DVT_PALLAS_FUSED=1, so every BatchNorm with a
ReLU or a residual takes the folded bn_act arithmetic through the Pallas
kernel in interpret mode, as on a TPU (its CPU default is the unfused
form). Variables are drawn with numpy from a seed and bridged into the
port through `variables_from_jax`; a strict `load_state_dict` proves the
mapping complete. Gradients are taken against a fixed random cotangent
of the output.

Tolerance: rtol = 1e-4, atol = 1e-4 x the largest magnitude of the
compared array. Both sides compute in f32, but XLA's and PyTorch's CPU
convolutions and reductions sum in different orders, and each training
BatchNorm divides by a batch standard deviation computed from
E[x^2] - E[x]^2 over a handful of elements, which magnifies those
few-ulp differences layer by layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.models import get_model, resnet
from deep_vision_tpu_torch.nn.layers import BatchNorm, global_avg_pool

RTOL = 1e-4


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setenv("DVT_PALLAS_FUSED", "1")


def randomize(tree, rng):
    """Same structure, numpy leaves from `rng`: kernels at 1/sqrt(fan_in),
    BN scale and var in [0.5, 1.5), biases and means ~ 0.1 N(0, 1)."""
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


def close(got, want, name=""):
    want = np.asarray(want, np.float32)
    atol = RTOL * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=atol, err_msg=name)


def bridge(jax_module, port_module, x, seed, train=True):
    """Init the JAX module on x, randomize its variables, load them into
    the port module (strict). -> variables."""
    v = jax.device_get(jax_module.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x), train=train))
    v = randomize(v, np.random.RandomState(seed))
    port_module.load_state_dict(variables_from_jax(v))
    return v


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def jax_train(jm, v, x, cot, **kw):
    """Output, batch_stats after the step, and grads of <out, cot> wrt
    params and x."""
    def f(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"], **kw)
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    return out, stats, gp, gx


def port_train(tm, x, cot, to_port):
    """The same for the port: x and cot in the reference's layout;
    `to_port` maps an NHWC array to the module's input."""
    tm.train()
    xt = to_port(x).clone().requires_grad_()
    out = tm(xt)
    (out * to_port(cot)).sum().backward()
    return out, xt.grad


def check_train(jm, tm, v, x, cot, to_port, from_port):
    want_out, want_stats, want_gp, want_gx = jax_train(jm, v, x, cot)
    got_out, got_gx = port_train(tm, x, cot, to_port)
    close(from_port(got_out.detach()), want_out, "output")
    close(from_port(got_gx), want_gx, "input grad")
    sd = dict(tm.named_parameters())
    want = variables_from_jax({"params": jax.device_get(want_gp)})
    assert sorted(want) == sorted(sd)
    for k, w in want.items():
        close(sd[k].grad.numpy(), w.numpy(), k)
    buffers = dict(tm.named_buffers())
    stats = variables_from_jax({"batch_stats": jax.device_get(want_stats)})
    assert sorted(stats) == sorted(buffers)
    for k, w in stats.items():
        close(buffers[k].numpy(), w.numpy(), k)


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cin,features,strides", [(16, 4, 1), (8, 4, 2),
                                                  (16, 4, 2)])
def test_bottleneck_block_train_parity(cin, features, strides):
    rng = np.random.RandomState(cin + strides)
    x = rng.randn(2, 6, 6, cin).astype(np.float32)
    jm = jax_resnet.BottleneckBlock(features, strides=(strides, strides))
    tm = resnet.BottleneckBlock(cin, features, strides)
    v = bridge(jm, tm, x, seed=strides)
    assert hasattr(tm, "ConvBN_2") == (cin != 4 * features or strides != 1)
    out_hw = -(-6 // strides)
    cot = rng.randn(2, out_hw, out_hw, 4 * features).astype(np.float32)
    check_train(jm, tm, v, x, cot, nchw, to_nhwc)


@pytest.mark.parametrize("cin,features,strides", [(8, 8, 1), (4, 8, 2)])
def test_basic_block_train_parity(cin, features, strides):
    rng = np.random.RandomState(cin * 10 + strides)
    x = rng.randn(2, 6, 6, cin).astype(np.float32)
    jm = jax_resnet.BasicBlock(features, strides=(strides, strides))
    tm = resnet.BasicBlock(cin, features, strides)
    v = bridge(jm, tm, x, seed=strides + 3)
    out_hw = -(-6 // strides)
    cot = rng.randn(2, out_hw, out_hw, features).astype(np.float32)
    check_train(jm, tm, v, x, cot, nchw, to_nhwc)


def test_space_to_depth_stem_parity():
    rng = np.random.RandomState(21)
    x = rng.randn(2, 8, 8, 12).astype(np.float32)
    jm = jax_resnet.SpaceToDepthStem(16)
    w = (rng.randn(7, 7, 3, 16) / np.sqrt(147)).astype(np.float32)
    want = jm.apply({"params": {"kernel": w}}, jnp.asarray(x))
    tm = resnet.SpaceToDepthStem(16)
    tm.load_state_dict(variables_from_jax({"params": {"kernel": w}}))
    got = tm(nchw(x))
    close(to_nhwc(got.detach()), want)
    # the (7, 7, 3) kernel reshuffled to (4, 4, 12): tap (i, j) of input
    # channel (dy * 2 + dx) * 3 + c is original tap (2i + dy - 1, 2j + dx - 1)
    k = tm.kernel().detach().numpy()
    assert k.shape == (16, 12, 4, 4)
    assert k[:, 0, 0, 0].tolist() == [0.0] * 16  # the zero row/column
    np.testing.assert_array_equal(k[:, (1 * 2 + 0) * 3 + 2, 2, 1],
                                  w[2 * 2 + 1 - 1, 2 * 1 + 0 - 1, 2])


def tiny_models():
    jm = jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                           stem="s2d")
    tm = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                       stem="s2d")
    return jm, tm


def nhwc_in(x):
    return torch.from_numpy(x)


def test_tiny_resnet_train_parity():
    rng = np.random.RandomState(5)
    x = rng.rand(8, 16, 16, 12).astype(np.float32)  # stage 4: 8 values/BN
    jm, tm = tiny_models()
    v = bridge(jm, tm, x, seed=5)
    cot = rng.randn(8, 10).astype(np.float32)
    check_train(jm, tm, v, x, cot, nhwc_in, lambda t: t.numpy())


def test_tiny_resnet_eval_parity():
    rng = np.random.RandomState(6)
    x = rng.rand(3, 16, 16, 12).astype(np.float32)
    jm, tm = tiny_models()
    v = bridge(jm, tm, x, seed=6, train=False)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close(got.numpy(), want)


def test_tiny_resnet_conv7_stem_names_and_eval_parity():
    rng = np.random.RandomState(7)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jm = jax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
    tm = resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
    v = bridge(jm, tm, x, seed=7, train=False)
    assert "ConvBN_0.Conv_0.weight" in tm.state_dict()
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    close(got.numpy(), want)


def test_resnet50_state_dict_is_the_reference_tree():
    """Every variable of the JAX ResNet-50 (s2d) has a port counterpart of
    the same shape, and nothing else exists: the full-width bridge."""
    x = jnp.zeros((1, 32, 32, 12))
    shapes = jax.eval_shape(lambda: jax_resnet.ResNet(
        stage_sizes=(3, 4, 6, 3), stem="s2d").init(
            jax.random.PRNGKey(0), x, train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = get_model("resnet50", device="cpu", stem="s2d")
    tm.load_state_dict(variables_from_jax(zeros))
    names = sorted(k for k in tm.state_dict() if "BottleneckBlock" not in k)
    assert names[:4] == ["BatchNorm_0.bias", "BatchNorm_0.mean",
                         "BatchNorm_0.scale", "BatchNorm_0.var"]
    assert {"Dense_0.weight", "Dense_0.bias",
            "SpaceToDepthStem_0.weight"} <= set(names)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in
        jax.tree_util.tree_leaves(shapes["params"]))


def test_get_model_draws_resnet_weights_as_flax_does():
    m = get_model("resnet50", device="cpu", seed=3, num_classes=10)
    assert not m.training and get_model("resnet50", device="cpu",
                                        train=True).training
    b0 = m.BottleneckBlock_0
    assert torch.all(b0.BatchNorm_0.scale == 0)  # tail starts as identity
    assert torch.all(b0.ConvBN_0.BatchNorm_0.scale == 1)
    assert torch.all(m.Dense_0.bias == 0)
    w = b0.ConvBN_1.Conv_0.weight  # he_normal: std sqrt(2 / fan_in)
    assert abs(float(w.detach().std()) - (2 / (64 * 9)) ** 0.5) < 0.01
    assert w.is_contiguous(memory_format=torch.channels_last)
    again = get_model("resnet50", device="cpu", seed=3, num_classes=10)
    for (k, u), v in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(u, v), k


def test_batchnorm_training_statistics_and_running_update():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(4, 3, 5, 5).astype(np.float32) * 2 + 1)
    bn = BatchNorm(3).train()
    y = bn(x)
    xf = x.double()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf * xf).mean(dim=(0, 2, 3)) - mean ** 2  # biased, E[x^2]-E[x]^2
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * mean.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * var.numpy(),
                               rtol=1e-5)
    want = (xf - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_global_avg_pool_sums_bf16_in_f32():
    x = torch.full((1, 2, 16, 16), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    x[0, :, 0, 0] = 3.0
    got = global_avg_pool(x)
    assert got.dtype == torch.bfloat16
    want = jnp.mean(jnp.asarray(x.float().permute(0, 2, 3, 1).numpy())
                    .astype(jnp.bfloat16), axis=(1, 2))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
