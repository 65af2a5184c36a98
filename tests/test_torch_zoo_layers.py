"""Port parity: the zoo's layers in deep_vision_tpu_torch/nn/layers.py
(channel_shuffle, LocalResponseNorm, max_pool / avg_pool with flax's
padding, Conv and ConvBN with groups, rectangular kernels, with and
without BatchNorm and bias, DepthwiseSeparableConv, Dropout and the
initialisers) against the JAX package's and flax's, on the CPU.

Inputs are drawn with numpy from a seed; variables are bridged through
`variables_from_jax` (tests/torch_parity.py). Tolerances, each with its
reason:
- channel_shuffle and max_pool: exact (they move values);
- avg_pool: exact gradients, outputs within 2e-7 relative (XLA's
  reduce_window and PyTorch's pool sum the window in other orders);
- LRN: rtol 1e-6 (the same window sum and power, one ulp apart);
- ConvBN and DepthwiseSeparableConv in eval and training mode (outputs,
  batch statistics, every gradient): rtol 1e-4, atol 1e-4 x the largest
  magnitude, as tests/test_torch_resnet.py holds its blocks (the
  convolutions sum in other orders, and a training BatchNorm's batch
  deviation magnifies it);
- Dropout: the keep rate within 4 standard deviations of its binomial
  count, the kept values exactly x / keep;
- initialisers: the standard deviation within 3% of flax's on 60,000
  draws (each side's sampling error is under 1%).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_vision_tpu.nn import layers as jax_layers
from deep_vision_tpu_torch.nn.layers import (
    INITIALIZERS,
    ConvBN,
    DepthwiseSeparableConv,
    Dropout,
    LocalResponseNorm,
    avg_pool,
    channel_shuffle,
    max_pool,
    variance_scaling_,
    window_pads,
)
from torch_parity import bridge, check_eval, check_train


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setenv("DVT_PALLAS_FUSED", "1")


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("channels,groups", [(12, 3), (60, 3), (16, 2),
                                             (9, 9)])
def test_channel_shuffle_is_the_references(channels, groups):
    x = np.random.RandomState(channels).randn(2, 3, 5, channels).astype(
        np.float32)
    want = np.asarray(jax_layers.channel_shuffle(jnp.asarray(x), groups))
    got = channel_shuffle(
        nchw(x).contiguous(memory_format=torch.channels_last), groups)
    np.testing.assert_array_equal(nhwc(got), want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="divisible"):
        channel_shuffle(nchw(x), 5 if channels % 5 else 7)


@pytest.mark.parametrize("channels", [3, 96, 256])
def test_local_response_norm_is_the_references_formula(channels):
    rng = np.random.RandomState(channels)
    x = (rng.randn(2, 5, 4, channels) * 20).astype(np.float32)
    want = jax_layers.LocalResponseNorm().apply({}, jnp.asarray(x))
    got = LocalResponseNorm()(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # not torch's: there alpha is divided by the window size
    torch_lrn = torch.nn.LocalResponseNorm(5, 1e-4, 0.75, 2.0)(nchw(x))
    assert not np.allclose(nhwc(torch_lrn), np.asarray(want), rtol=1e-4)


POOLS = [
    # (window, strides, padding, size): the zoo's pools at odd and even
    # sizes, SAME with an odd total (high side padded more)
    (3, 2, "SAME", 8), (3, 2, "SAME", 7), (3, 2, "SAME", 112),
    (3, 1, "SAME", 7), (3, 1, "SAME", 8), (3, 2, "VALID", 9),
    (3, 2, "VALID", 8), (2, 2, "VALID", 8), (5, 3, "VALID", 14),
    (3, 2, [(1, 1), (1, 1)], 8), (3, 2, [(0, 2), (1, 0)], 7),
]


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("window,strides,padding,size", POOLS)
def test_pools_follow_flax_padding(kind, window, strides, padding, size):
    rng = np.random.RandomState(size * 10 + window)
    x = rng.randn(2, size, size + 1, 4).astype(np.float32)
    x[0, :3] = np.maximum(x[0, :3], 0)  # ties of zeros, as after a ReLU
    ref, port = {"max": (fnn.max_pool, max_pool),
                 "avg": (fnn.avg_pool, avg_pool)}[kind]

    def f(xx):
        return ref(xx, (window, window), strides=(strides, strides),
                   padding=padding)

    want, vjp = jax.vjp(f, jnp.asarray(x))
    cot = rng.randn(*want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    got = port(xt, window, strides, padding)
    (got * nchw(cot)).sum().backward()
    assert got.is_contiguous(memory_format=torch.channels_last)
    if kind == "max":
        np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    else:
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=2e-7,
                                   atol=2e-7 * float(np.abs(want).max()))
    np.testing.assert_array_equal(nhwc(xt.grad), np.asarray(want_dx))


def test_window_pads_take_each_axis_kernel():
    x = torch.zeros(1, 1, 17, 17)
    assert window_pads(x, (1, 7), (1, 1), "SAME") == ((0, 0), (3, 3))
    assert window_pads(x, (3, 3), (2, 2), "VALID") == ((0, 0), (0, 0))
    assert window_pads(x, (3, 3), (2, 2), [(1, 0), (0, 1)]) == ((1, 0),
                                                                (0, 1))


CONVBN = [
    # (cin, features, kernel, strides, groups, use_bn, use_bias, act)
    (12, 24, (1, 1), 1, 3, True, False, "relu"),     # ShuffleNet 1x1 group
    (16, 16, (3, 3), 2, 16, True, False, None),      # depthwise, no act
    (16, 16, (3, 3), 1, 16, True, False, "relu"),    # MobileNet depthwise
    (8, 12, (1, 7), 1, 1, True, False, "relu"),      # Inception V3
    (8, 12, (7, 1), 1, 1, True, False, "relu"),
    (8, 12, (3, 1), 2, 1, True, True, "relu"),       # BN and a bias
    (6, 12, (3, 3), 1, 3, False, False, "relu"),     # no BN: a bias
    (6, 12, (3, 3), 1, 1, False, True, None),
]


def _convbn(cin, features, kernel, strides, groups, use_bn, use_bias, act):
    jact = {"relu": fnn.relu, None: None}[act]
    tact = {"relu": F.relu, None: None}[act]
    jm = jax_layers.ConvBN(features, kernel, strides=(strides, strides),
                           groups=groups, use_bn=use_bn, use_bias=use_bias,
                           act=jact)

    class Port(ConvBN):  # NHWC in and out, as its JAX twin
        def forward(self, x):
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    tm = Port(cin, features, kernel, strides, groups=groups, use_bn=use_bn,
              use_bias=use_bias, act=tact)
    return jm, tm


@pytest.mark.parametrize("case", CONVBN, ids=str)
@pytest.mark.parametrize("train", [True, False])
def test_convbn_matches_the_reference(case, train):
    cin, features, kernel, strides = case[:4]
    rng = np.random.RandomState(sum(kernel) + cin + train)
    x = rng.randn(4, 9, 8, cin).astype(np.float32)
    jm, tm = _convbn(*case)
    v = bridge(jm, tm, x, seed=cin)
    assert ("bias" in v["params"]["Conv_0"]) == (case[6] or not case[5])
    assert tm.Conv_0.weight.shape == (features, cin // case[4], *kernel)
    out = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), train=False))
    cot = rng.randn(*out.shape).astype(np.float32)
    if train:
        # a conv bias before a training BatchNorm: zero gradient
        check_train(jm, tm, v, x, [cot], 1e-4,
                    cancelled={"Conv_0.bias": "Conv_0.weight"})
    else:
        check_eval(jm, tm, v, x, cot, 1e-4)


@pytest.mark.parametrize("strides", [1, 2])
def test_convbn_residual_without_bn_adds_before_the_act(strides):
    rng = np.random.RandomState(strides)
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    jm, tm = _convbn(4, 8, (3, 3), strides, 1, False, True, "relu")
    v = bridge(jm, tm, x, seed=2)
    r = rng.randn(2, 6 // strides, 6 // strides, 8).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=True, residual=jnp.asarray(r))
    got = ConvBN.forward(tm, nchw(x), residual=nchw(r))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("strides", [1, 2])
@pytest.mark.parametrize("train", [True, False])
def test_depthwise_separable_conv_matches_the_reference(strides, train):
    rng = np.random.RandomState(strides * 2 + train)
    x = rng.randn(4, 9, 9, 8).astype(np.float32)
    jm = jax_layers.DepthwiseSeparableConv(12, strides=(strides, strides))

    class Port(DepthwiseSeparableConv):
        def forward(self, x):
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    tm = Port(8, 12, strides)
    v = bridge(jm, tm, x, seed=strides)
    assert tm.ConvBN_0.Conv_0.weight.shape == (8, 1, 3, 3)
    out = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), train=False))
    cot = rng.randn(*out.shape).astype(np.float32)
    if train:
        check_train(jm, tm, v, x, [cot], 1e-4)
    else:
        check_eval(jm, tm, v, x, cot, 1e-4)


@pytest.mark.parametrize("rate", [0.001, 0.4, 0.7])
def test_dropout_keep_rate_scaling_and_repeatability(rate):
    x = torch.full((400, 500), 3.0)
    m = Dropout(rate).train()
    m.generator = torch.Generator().manual_seed(7)
    y = m(x)
    keep = 1.0 - rate
    kept = y != 0
    n, k = x.numel(), int(kept.sum())
    assert abs(k - n * keep) <= 4 * (n * keep * rate) ** 0.5
    assert torch.equal(y[kept], (x / keep)[kept])  # flax's x / keep
    m.generator = torch.Generator().manual_seed(7)
    assert torch.equal(m(x), y)  # one generator state, one mask
    assert not torch.equal(m(x), y)  # the generator moved on
    assert torch.equal(m.eval()(x), x)


def test_dropout_edges_and_gradient():
    x = torch.randn(64, 64, requires_grad=True)
    assert Dropout(0.0).train()(x) is x
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros(64, 64))
    m = Dropout(0.5).train()
    m.generator = torch.Generator().manual_seed(1)
    y = m(x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.where(y != 0, 2.0, 0.0))


@pytest.mark.parametrize("name,shape", [
    ("he_normal", (3, 3, 8, 32)), ("he_normal", (3, 3, 1, 240)),
    ("lecun_normal", (5, 5, 6, 16)), ("lecun_normal", (1, 1, 20, 60)),
    ("xavier_normal", (1, 7, 16, 24)), ("xavier_normal", (6400, 40)),
])
def test_initialisers_draw_flaxs_distribution(name, shape):
    """flax's draw of an HWIO (or (in, out)) kernel against the port's of
    the same layer (OIHW, (out, in)); a grouped kernel (a depthwise one's
    (3, 3, 1, 240), ShuffleNet's (1, 1, 20, 60) of 3 groups) has
    C_in / groups inputs in both. Many draws: the std within 3%, the cut at two of the
    untruncated deviations."""
    init = jax_layers.INITIALIZERS[name]
    reps = max(1, 60000 // int(np.prod(shape)))
    want = np.concatenate([np.asarray(init(jax.random.PRNGKey(i), shape))
                           .ravel() for i in range(reps)])
    torch_shape = ((shape[-1], shape[-2], *shape[:2]) if len(shape) == 4
                   else (shape[1], shape[0]))
    gen = torch.Generator().manual_seed(0)
    got = torch.cat([variance_scaling_(torch.empty(torch_shape),
                                       *INITIALIZERS[name], gen).ravel()
                     for _ in range(reps)]).numpy()
    assert abs(got.std() / want.std() - 1) < 0.03
    cut = 2 * want.std() / 0.87962566
    assert np.abs(got).max() <= cut * 1.03
    assert np.abs(want).max() <= cut * 1.03
