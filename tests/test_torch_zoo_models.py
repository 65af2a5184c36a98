"""Port parity: the classifier zoo (deep_vision_tpu_torch/models/lenet.py,
alexnet.py, vgg.py, mobilenet.py, shufflenet.py, inception.py and
resnet.py's pre-activation ResNet) against the JAX package, on the CPU.

Sizes: LeNet-5 as registered; AlexNet V1 and V2 at the smallest input
whose classifier still flattens a 2x2 grid (99 and 95), so the NHWC
flatten order shows; VGG with one conv a stage (8-32 channels) at 64x64,
with and without BatchNorm; MobileNet alpha 0.25 and ShuffleNet (g = 3)
s 0.25 at 64x64; Inception V1 at 113 (its aux heads flatten a 2x2 grid)
and V3 at 139 (the smallest input its VALID convs and aux pool allow is
107, where the last BatchNorms see 16 values); a one-block-a-stage,
width-8 pre-activation ResNet with either stem. Variables are drawn with
numpy from a seed and bridged through `variables_from_jax`
(tests/torch_parity.py); the JAX side runs with DVT_PALLAS_FUSED=1, so
its fused BatchNorms take the bn_act kernel in interpret mode, as on a
TPU. Dropout: AlexNet, VGG and MobileNet run at rate 0 on both sides;
Inception's fixed rates drop on the port what the JAX run dropped (its
masks, read from `capture_intermediates`, are applied by forward hooks).

What is compared, and why:
- eval mode, every model at full depth: the output and every
  parameter's gradient of sum(out * cot);
- training mode, every model at full depth: the outputs (aux heads
  included) and the updated batch statistics;
- training mode, every parameter's gradient: LeNet, AlexNet and VGG
  whole, and every block type of the others (MobileNet's depthwise-
  separable block, ShuffleNet's units, the pre-activation bottleneck
  with and without its projection, each Inception module and aux head).
  A whole deep network's training gradients on a CPU-sized batch are
  not a stable comparison: each training BatchNorm normalises by the
  deviation of a few dozen values, so the two sides' few-ulp summation
  differences grow about 1.3x a layer (to ~1e-4 after MobileNet's 27),
  and a ReLU input within that distance of zero then falls the other
  way on one side and moves a whole upstream gradient by 10-50%
  (measured: one flipped element in MobileNet's 21st BatchNorm at batch
  4, with the loss's finite difference between the two sides). The
  eval-mode gradients hold the composition of the blocks at full depth.
  The port's CPU convolutions run on one thread, so every comparison
  repeats in any test worker.

Tolerance: rtol = 1e-4, atol = 1e-4 x the largest magnitude of the
compared array (tests/test_torch_resnet.py's): both sides compute in
float32, but XLA's and PyTorch's CPU convolutions sum in other orders.
The full-depth training forwards of MobileNet, ShuffleNet and the
Inceptions hold 1e-3 (the growth above), and so do the Inceptions'
eval-mode gradients: a stem BatchNorm's shift sums ~1e5 terms of both
signs, which cancel to a hundredth of their magnitude. In Inception's
BasicConvs the port takes the JAX run's ReLU decisions
(torch_parity.apply_masks), in eval mode too: V3 at 139 has ~4e6 ReLU
inputs, and one within rounding of zero fell the other way. A gradient that is zero in
exact arithmetic (a conv bias before a training BatchNorm; ShuffleNet's
depthwise BatchNorm shift, which a 1x1 conv carries into the next
training BatchNorm) is rounding noise on both sides and is held at
1e-4 x its layer's largest other gradient.

Beside the parity: every registered classification config's full-width
variable tree loads strictly into the port (from `jax.eval_shape`, no
forward); the initialisers draw each layer at flax's standard
deviation; every BatchNorm input stays channels_last (the moments
kernels refuse anything else); and the counts of fused and training
BatchNorms that chip_smoke.py expects of each model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.configs import CONFIG_REGISTRY as REF_CONFIGS
from deep_vision_tpu.models import alexnet as jax_alexnet
from deep_vision_tpu.models import get_model as jax_get_model
from deep_vision_tpu.models import inception as jax_inception
from deep_vision_tpu.models import lenet as jax_lenet
from deep_vision_tpu.models import mobilenet as jax_mobilenet
from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu.models import shufflenet as jax_shufflenet
from deep_vision_tpu.models import vgg as jax_vgg
from deep_vision_tpu.nn import layers as jax_layers
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.models import (
    MODEL_REGISTRY,
    alexnet,
    get_model,
    inception,
    lenet,
    mobilenet,
    resnet,
    shufflenet,
    vgg,
)
from deep_vision_tpu_torch.nn.layers import BatchNorm, DepthwiseSeparableConv
from deep_vision_tpu_torch.ops.cuda.norm import moments_rows
from deep_vision_tpu_torch.tools.profile_train import ZOO_MODELS
from torch_parity import bridge, check_eval, check_train

RTOL = 1e-4
TINY_VGG = ((1, 8), (1, 16), (1, 32), (1, 32), (1, 32))


def tiny_preact(stem):
    kw = dict(stage_sizes=(1, 1, 1, 1), num_classes=10, width=8, stem=stem)
    return (jax_resnet.ResNet(block=jax_resnet.PreActBottleneckBlock,
                              preact=True, **kw),
            resnet.ResNet(block=resnet.PreActBottleneckBlock, preact=True,
                          **kw))


#: name -> (JAX module, port module, input NHWC, training-forward rtol)
CASES = {
    "lenet5": lambda: (jax_lenet.LeNet5(10), lenet.LeNet5(10),
                       (4, 32, 32, 1), RTOL),
    "alexnet1": lambda: (jax_alexnet.AlexNetV1(10, dropout=0.0),
                         alexnet.AlexNet(True, 10, 0.0, image_size=99),
                         (2, 99, 99, 3), RTOL),
    "alexnet2": lambda: (jax_alexnet.AlexNetV2(10, dropout=0.0),
                         alexnet.AlexNet(False, 10, 0.0, image_size=95),
                         (2, 95, 95, 3), RTOL),
    "vgg": lambda: (jax_vgg.VGG(TINY_VGG, 10, dropout=0.0),
                    vgg.VGG(TINY_VGG, 10, 0.0, image_size=64),
                    (2, 64, 64, 3), RTOL),
    "vgg_bn": lambda: (jax_vgg.VGG(TINY_VGG, 10, dropout=0.0, use_bn=True),
                       vgg.VGG(TINY_VGG, 10, 0.0, use_bn=True,
                               image_size=64), (4, 64, 64, 3), RTOL),
    "mobilenet1": lambda: (jax_mobilenet.MobileNetV1(10, alpha=0.25,
                                                     dropout=0.0),
                           mobilenet.MobileNetV1(10, 0.25, 0.0),
                           (4, 64, 64, 3), 1e-3),
    "shufflenet1": lambda: (jax_shufflenet.ShuffleNetV1(10, 3, 0.25),
                            shufflenet.ShuffleNetV1(10, 3, 0.25),
                            (4, 64, 64, 3), 1e-3),
    "inception1": lambda: (jax_inception.InceptionV1(10),
                           inception.InceptionV1(10, image_size=113),
                           (4, 113, 113, 3), 1e-3),
    "inception3": lambda: (jax_inception.InceptionV3(10),
                           inception.InceptionV3(10, image_size=139),
                           (4, 139, 139, 3), 1e-3),
    "resnet_v2": lambda: (*tiny_preact("conv7"), (8, 64, 64, 3), RTOL),
    "resnet_v2_s2d": lambda: (*tiny_preact("s2d"), (8, 32, 32, 12), RTOL),
}
#: training outputs: logits and the aux heads'
N_OUT = {"inception1": 3, "inception3": 2}
#: the models whose whole training step's gradients are compared: no
#: chain of training BatchNorms, or a short one (VGG's five)
WHOLE_GRADS = ("lenet5", "alexnet1", "alexnet2", "vgg", "vgg_bn")
#: gradient suffix -> its layer's reference suffix (torch_parity.py)
CANCELLED = {"vgg_bn": {"Conv_0.bias": "Conv_0.weight"},
             "shufflenet1": {"ConvBN_1.BatchNorm_0.bias":
                             "ConvBN_1.BatchNorm_0.scale"}}


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setenv("DVT_PALLAS_FUSED", "1")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's CPU convolutions then sum in one
    order however many test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, shape, salt=0):
    rng = np.random.RandomState(len(name) + salt)
    x = rng.rand(*shape).astype(np.float32)
    cots = [rng.randn(shape[0], 10).astype(np.float32)
            for _ in range(N_OUT.get(name, 1))]
    return x, cots


@pytest.mark.parametrize("name", sorted(CASES))
def test_training_forward_matches_the_reference(name):
    """Full depth: outputs and updated batch statistics (every gradient
    too for the models whose depth keeps the comparison stable)."""
    jm, tm, shape, rtol = CASES[name]()
    x, cots = _inputs(name, shape)
    v = bridge(jm, tm, x, seed=len(name))
    check_train(jm, tm, v, x, cots, rtol, grads=name in WHOLE_GRADS,
                cancelled=CANCELLED.get(name))


class NHWC:
    """Mixin: a block that takes and returns NHWC, as its JAX twin does."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _nhwc(cls):
    return type(cls.__name__, (NHWC, cls), {})


class Logits(torch.nn.Module):
    """An aux head, NHWC in, as its JAX twin."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2))


def _unit(*args, **kw):
    return (jax_shufflenet.ShuffleUnit(*args[1:], **kw),
            _nhwc(shufflenet.ShuffleUnit)(*args, **kw))


#: block -> (JAX block, port block, input NHWC, training output is NHWC)
BLOCKS = {
    "depthwise_separable": lambda: (
        jax_layers.DepthwiseSeparableConv(24),
        _nhwc(DepthwiseSeparableConv)(16, 24), (4, 8, 8, 16), True),
    "depthwise_separable_s2": lambda: (
        jax_layers.DepthwiseSeparableConv(24, strides=(2, 2)),
        _nhwc(DepthwiseSeparableConv)(16, 24, 2), (4, 9, 9, 16), True),
    "shuffle_unit": lambda: (*_unit(24, 24, 3), (4, 8, 8, 24), True),
    "shuffle_unit_s2": lambda: (*_unit(24, 48, 3, stride=2), (4, 9, 9, 24),
                                True),
    "shuffle_unit_first": lambda: (*_unit(12, 48, 3, stride=2,
                                          first_stage=True),
                                   (4, 8, 8, 12), True),
    "preact_block": lambda: (
        jax_resnet.PreActBottleneckBlock(8),
        _nhwc(resnet.PreActBottleneckBlock)(32, 8), (4, 8, 8, 32), True),
    "preact_block_projection": lambda: (
        jax_resnet.PreActBottleneckBlock(8, strides=(2, 2)),
        _nhwc(resnet.PreActBottleneckBlock)(16, 8, 2), (4, 8, 8, 16), True),
    "inception_module": lambda: (
        jax_inception.InceptionModule(8, 6, 8, 4, 8, 8),
        _nhwc(inception.InceptionModule)(16, 8, 6, 8, 4, 8, 8),
        (4, 7, 7, 16), True),
    "aux_classifier": lambda: (
        jax_inception.AuxClassifier(10),
        type("Aux", (Logits, inception.AuxClassifier), {})(16, 10, 8),
        (8, 8, 8, 16), False),
    "inception_a": lambda: (jax_inception.InceptionA(8),
                            _nhwc(inception.InceptionA)(16, 8),
                            (4, 7, 7, 16), True),
    "reduction_a": lambda: (jax_inception.ReductionA(),
                            _nhwc(inception.ReductionA)(16),
                            (4, 9, 9, 16), True),
    "inception_b": lambda: (jax_inception.InceptionB(8),
                            _nhwc(inception.InceptionB)(16, 8),
                            (4, 9, 9, 16), True),
    "reduction_b": lambda: (jax_inception.ReductionB(),
                            _nhwc(inception.ReductionB)(16),
                            (4, 9, 9, 16), True),
    "inception_c": lambda: (jax_inception.InceptionC(),
                            _nhwc(inception.InceptionC)(16),
                            (4, 5, 5, 16), True),
    "inception_v3_aux": lambda: (
        jax_inception.InceptionV3Aux(10),
        type("Aux3", (Logits, inception.InceptionV3Aux), {})(16, 10, 11),
        (32, 11, 11, 16), False),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_training_gradients(name):
    """Outputs, batch statistics and every gradient of each block type in
    training mode (the aux heads' dropout included); in Inception's
    BasicConvs the port takes the JAX run's ReLU decisions
    (torch_parity.apply_masks). The aux heads' last conv sees one value
    an image, so they run on batches of 8 and 32."""
    jm, tm, shape, spatial = BLOCKS[name]()
    rng = np.random.RandomState(len(name))
    x = rng.randn(*shape).astype(np.float32)
    v = bridge(jm, tm, x, seed=len(name))
    out = jax.eval_shape(lambda: jm.apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)})[0])
    assert len(out.shape) == (4 if spatial else 2)
    cot = rng.randn(*out.shape).astype(np.float32)
    check_train(jm, tm, v, x, [cot], RTOL,
                cancelled=CANCELLED["shufflenet1"],
                relu_modules=(jax_inception.BasicConv, inception.BasicConv))


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_matches_the_reference(name):
    jm, tm, shape, _ = CASES[name]()
    x, cots = _inputs(name, shape, salt=50)
    v = bridge(jm, tm, x, seed=len(name) + 50)
    check_eval(jm, tm, v, x, cots[0],
               1e-3 if name.startswith("inception") else RTOL,
               relu_modules=(jax_inception.BasicConv, inception.BasicConv))


def _reference_tree(cfg):
    key = jax.random.PRNGKey(0)
    model = jax_get_model(cfg.model, num_classes=cfg.num_classes,
                          **cfg.model_kwargs)
    x = jnp.zeros((1, *cfg.input_shape))
    return jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, x, train=True))


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_full_width_variables_load_strictly(name):
    """The registered config's whole variable tree (training mode, so the
    aux heads are in it) has a port counterpart of each shape, and the
    port has nothing else: a strict load of zeros."""
    cfg = REF_CONFIGS[name]
    tree = _reference_tree(cfg)
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)
    build, _ = MODEL_REGISTRY[cfg.model]
    tm = build(num_classes=cfg.num_classes, **cfg.model_kwargs)
    tm.load_state_dict(variables_from_jax(zeros))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in
        jax.tree_util.tree_leaves(tree["params"]))


#: (JAX module, port module, input): flax's initialisers against the
#: port's registered ones, at small sizes
INIT_CASES = {
    "lenet5": (lambda: jax_lenet.LeNet5(10), lambda: lenet.LeNet5(10),
               (1, 32, 32, 1)),
    "alexnet2": (lambda: jax_alexnet.AlexNetV2(10),
                 lambda: alexnet.AlexNet(False, 10, image_size=95),
                 (1, 95, 95, 3)),
    "vgg_bn": (lambda: jax_vgg.VGG(TINY_VGG, 10, use_bn=True),
               lambda: vgg.VGG(TINY_VGG, 10, use_bn=True, image_size=64),
               (1, 64, 64, 3)),
    "mobilenet1": (lambda: jax_mobilenet.MobileNetV1(10, alpha=0.5),
                   lambda: mobilenet.MobileNetV1(10, 0.5), (1, 32, 32, 3)),
    "shufflenet1": (lambda: jax_shufflenet.ShuffleNetV1(10, 3, 0.5),
                    lambda: shufflenet.ShuffleNetV1(10, 3, 0.5),
                    (1, 32, 32, 3)),
    "inception1": (lambda: jax_inception.InceptionV1(10),
                   lambda: inception.InceptionV1(10, image_size=65),
                   (1, 65, 65, 3)),
    "resnet_v2": (lambda: tiny_preact("conv7")[0],
                  lambda: tiny_preact("conv7")[1], (1, 32, 32, 3)),
}


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_initialisers_draw_at_flaxs_scale(name):
    """Every kernel of >= 2048 values: the port's draw has the standard
    deviation of flax's draw of the same layer within 8% (the sampling
    error of either is under 3% at that size), and its |values| stay
    within flax's truncation at two of its standard deviations; biases
    and BatchNorm shifts zero, scales one."""
    jm_fn, tm_fn, shape = INIT_CASES[name]
    _, init_fn = MODEL_REGISTRY[name.replace("resnet_v2", "resnet50v2")
                                .replace("vgg_bn", "vgg16")]
    key = jax.random.PRNGKey(3)
    init = jax.jit(lambda: jm_fn().init({"params": key, "dropout": key},
                                        jnp.zeros(shape), train=True))
    want = variables_from_jax({"params": jax.device_get(init()["params"])})
    tm = tm_fn()
    init_fn(tm, torch.Generator().manual_seed(3))
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    checked = 0
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("weight") and w.numel() >= 2048:
            ws, gs = float(w.std()), float(g.std())
            assert abs(gs / ws - 1) < 0.08, (k, gs, ws)
            # the cut: two standard deviations of the untruncated normal
            assert float(g.abs().max()) <= 1.08 * 2 * ws / 0.87962566, k
            checked += 1
        elif not k.endswith("weight"):
            assert torch.equal(g, w), k
    assert checked > 0


#: fused (bn_act) and training (moments) BatchNorms of one step
BN_COUNTS = {"lenet5": (0, 0), "alexnet1": (0, 0), "alexnet2": (0, 0),
             "vgg16": (0, 0), "vgg19": (0, 0), "mobilenet1": (27, 27),
             "shufflenet1": (17, 49), "resnet50v2": (16, 49),
             "inception1": (0, 59), "inception3": (0, 96)}
SMALL = {"lenet5": {}, "alexnet1": {"image_size": 99},
         "alexnet2": {"image_size": 95}, "vgg16": {"image_size": 32},
         "vgg19": {"image_size": 32}, "mobilenet1": {}, "shufflenet1": {},
         "resnet50v2": {}, "inception1": {"image_size": 113},
         "inception3": {"image_size": 107}}


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_every_batchnorm_input_is_channels_last(name):
    """One training forward at a small input: each BatchNorm's input is
    channels_last (`moments_rows`, the moments kernels' layout check,
    accepts it), the fused ones' counts are chip_smoke.py's, and the
    output is finite."""
    cfg = REF_CONFIGS[name]
    size = SMALL[name].get("image_size", 64)
    if name == "lenet5":
        size = 32
    tm = get_model(cfg.model, device="cpu", train=True, num_classes=10,
                   **SMALL[name])
    seen = {"fused": 0, "moments": 0}

    def hook(mod, args, kwargs):
        moments_rows(args[0])  # raises for another layout
        seen["moments"] += 1
        seen["fused"] += (mod.act is not None
                          or kwargs.get("residual") is not None)

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in tm.modules() if isinstance(m, BatchNorm)]
    x = torch.rand(2, size, size, cfg.input_shape[-1],
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tm(x)
    for h in handles:
        h.remove()
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    assert (seen["fused"], seen["moments"]) == BN_COUNTS[name]
