"""Port parity: deep_vision_tpu_torch/nn/layers.py against the JAX
ConvBN/BatchNorm on the eval path (the training path is held against
the reference in tests/test_torch_resnet.py).

Inputs and every variable are drawn with numpy from a seed and handed to
both packages (the variables through `variables_from_jax`).

Tolerance: rtol = atol = 1e-5. Both sides compute in float32, but XLA's
and PyTorch's CPU convolutions sum the kernel-window products in
different orders; at these sizes (<= 9 * 16 terms of magnitude ~1) the
reordering moves results by a few ulps, far inside 1e-5.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_vision_tpu.nn.layers import ConvBN as JaxConvBN
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.nn.layers import BatchNorm, ConvBN, same_padding

TOL = dict(rtol=1e-5, atol=1e-5)


def randomize(tree, rng):
    """Same structure, numpy leaves drawn from `rng`: BN statistics and
    affine terms away from their init values, conv kernels at
    1/sqrt(fan_in) scale."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.randn(*shape) / np.sqrt(fan_in)
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


CASES = [
    # (kernel, strides, padding, spatial size)
    (1, 1, "SAME", 7),
    (3, 1, "SAME", 7),
    (3, 1, "SAME", 8),
    (3, 2, [(1, 0), (1, 0)], 8),
    (3, 2, [(1, 0), (1, 0)], 7),
    (3, 2, "SAME", 8),
    (3, 2, "SAME", 7),
]


@pytest.mark.parametrize("kernel,strides,padding,size", CASES)
def test_convbn_eval_parity(kernel, strides, padding, size):
    rng = np.random.RandomState(kernel * 100 + strides * 10 + size)
    cin, cout = 5, 16
    x = rng.rand(2, size, size, cin).astype(np.float32)
    leaky = lambda t: fnn.leaky_relu(t, 0.1)  # noqa: E731
    jm = JaxConvBN(cout, (kernel, kernel), strides=(strides, strides),
                   padding=padding, act=leaky)
    v = randomize(jax.device_get(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))

    tm = ConvBN(cin, cout, kernel, strides, padding=padding,
                act=lambda t: F.leaky_relu(t, 0.1)).eval()
    tm.load_state_dict(variables_from_jax(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_convbn_relu_default_matches_reference():
    rng = np.random.RandomState(7)
    x = rng.randn(1, 6, 6, 3).astype(np.float32)
    jm = JaxConvBN(8, (3, 3))
    v = randomize(jax.device_get(
        jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)), rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = ConvBN(3, 8, 3).eval()
    tm.load_state_dict(variables_from_jax(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (7, 3, 1, (1, 1)), (8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)),
    (8, 1, 1, (0, 0)), (5, 4, 1, (1, 2)), (416, 3, 2, (0, 1)),
])
def test_same_padding_follows_xla(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want


def test_batchnorm_keeps_reference_arithmetic_and_layout():
    bn = BatchNorm(4).eval()
    assert sorted(n for n, _ in bn.named_parameters()) == ["bias", "scale"]
    assert sorted(n for n, _ in bn.named_buffers()) == ["mean", "var"]
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for t in (bn.scale, bn.bias, bn.mean):
            t.copy_(torch.from_numpy(rng.randn(4).astype(np.float32)))
        bn.var.copy_(torch.from_numpy(rng.uniform(0.1, 2, 4)
                                      .astype(np.float32)))
        x = torch.from_numpy(rng.randn(2, 4, 3, 3).astype(np.float32))
        got = bn(x)
    s, b, m, var = (t.detach().numpy()[:, None, None] for t in
                    (bn.scale, bn.bias, bn.mean, bn.var))
    inv = s * (1.0 / np.sqrt(var + np.float32(1e-5)))
    want = (x.numpy() - m) * inv + b
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_batchnorm_training_mode_raises():
    # training mode normalises with batch statistics (held against the
    # reference in tests/test_torch_resnet.py); what it cannot take raises
    bn = BatchNorm(2).train()
    x = torch.arange(36.0).view(2, 2, 3, 3)
    assert torch.allclose(bn(x).mean(dim=(0, 2, 3)), torch.zeros(2),
                          atol=1e-6)
    with pytest.raises(ValueError, match="does not match"):
        bn(x, residual=torch.zeros(2, 2, 3, 1))
