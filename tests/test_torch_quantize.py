"""The port's int8 serving (serve/quantize.py) against the JAX package's
on the CPU.

Models, each the reference's init tree (`jax.eval_shape` of `init`, no
compile) with seeded numpy leaves bridged by convert.py: a yolov3 (4
classes, 64x64), a hourglass (one stack, 4 heatmaps, 64x64, residual
branches damped and running statistics calibrated as
tests/torch_serve_parity.py does), a tiny ViT and a tiny V-MoE. Held bit
for bit: the quantized leaves (one port key a reference leaf), each q8
through convert.py's layout map and each scale as it is (conv and dense
along the output channel, V-MoE's w1/w2 along their last axis, the
attention qkv along the head dimension: hd scales), the dequantized
state_dict, and the report. The calibration gate gives the same verdict
and metric in both on the same batches (a logits toy, `top1`, the delta
equal; the hourglass's keypoints, `output_mse`, the delta within
DELTA_RTOL), and both refuse the poisoned case: a cancelling-outlier
channel calibrated on constant images (tests/test_excache.py:413-435).
Port only: a re-quantized tree swaps through an Engine with no warm-up,
an int8 -> float32 swap is refused, the scales round-trip through the
checkpoint sidecar bit for bit, apply_scales raises the reference's
three errors, and tools/check_journal.py --strict accepts the port's
`quant_calibrated` rows.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_vision_tpu.inference as ref_inference
import deep_vision_tpu.models as ref_models
import deep_vision_tpu.serve.quantize as ref_q
import deep_vision_tpu_torch.inference as port_inference
import deep_vision_tpu_torch.models as port_models
import deep_vision_tpu_torch.serve.quantize as port_q
from deep_vision_tpu.models.vit import ViT as JaxViT
from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs import read_journal as ref_read_journal
from deep_vision_tpu.serve import ServeError as RefServeError
from deep_vision_tpu_torch.convert import torch_key, variables_from_jax
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.models.vit import ViT
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.serve import Engine, ServeError
from deep_vision_tpu_torch.serve.engine import warmup_count
from torch_infer_parity import calibrated
from torch_parity import damp_residual_branches, randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import check_journal  # noqa: E402

#: the hourglass's output_mse delta: the same keypoints, scores within
#: float32 rounding of the two packages' convolutions
DELTA_RTOL = 1e-3
VIT = dict(depth=2, dim=32, num_heads=2, patch=8, num_classes=10)
IMG = (4, 4, 1)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and not ref_q._is_quantized_leaf(v):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(path, leaf):
    out = leaf
    for k in reversed(path):
        out = {k: out}
    return out


class Case:
    """One model: the reference's numpy variables, the port module
    holding them, and its state_dict."""

    def __init__(self, name, jm, tm, v):
        self.name, self.jm, self.tm, self.v = name, jm, tm, v
        tm.load_state_dict(variables_from_jax(v))
        self.sd = tm.state_dict()


def _shapes(jm, x, rngs=None):
    return jax.eval_shape(lambda: jm.init(
        rngs or jax.random.PRNGKey(0), x, train=False))


@pytest.fixture(scope="module")
def cases():
    out = {}
    x64 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jm = ref_models.get_model("yolov3", num_classes=4)
    v = randomize(_shapes(jm, x64), np.random.RandomState(1))
    build, _ = port_models.MODEL_REGISTRY["yolov3"]
    out["yolov3"] = Case("yolov3", jm, build(num_classes=4).eval(), v)

    kw = dict(num_stack=1, num_heatmap=4)
    jm = ref_models.get_model("hourglass", **kw)
    v = damp_residual_branches(randomize(_shapes(jm, x64),
                                         np.random.RandomState(2)))
    images = np.random.RandomState(3).rand(4, 64, 64, 3).astype(np.float32)
    v = calibrated("hourglass", images, **kw)(v)
    build, _ = port_models.MODEL_REGISTRY["hourglass"]
    out["hourglass"] = Case("hourglass", jm, build(**kw).eval(), v)

    x32 = jnp.zeros((1, 32, 32, 3), jnp.float32)
    jm = JaxViT(**VIT)
    v = randomize(_shapes(jm, x32), np.random.RandomState(4))
    out["vit"] = Case("vit", jm, ViT(**VIT, image_size=32).eval(), v)

    moe = dict(VIT, num_experts=4)
    jm = JaxViT(**moe)
    v = randomize(_shapes(jm, x32, {"params": jax.random.PRNGKey(0),
                                    "dropout": jax.random.PRNGKey(1)}),
                  np.random.RandomState(5))
    out["vmoe"] = Case("vmoe", jm, ViT(**moe, image_size=32).eval(), v)
    return out


def both(case):
    """(reference qvars, report), (port qvars, report)."""
    ref = ref_q.quantize_variables(case.v)
    port = port_q.quantize_variables(
        case.sd, features=port_q.dense_features(case.tm))
    return ref, port


@pytest.mark.parametrize("name", ["yolov3", "hourglass", "vit", "vmoe"])
def test_quantized_leaves_bit_equal_through_the_layout_map(cases, name):
    case = cases[name]
    (ref, ref_report), (port, port_report) = both(case)
    ref_leaves = {path: leaf for path, leaf in _flat(ref)
                  if ref_q._is_quantized_leaf(leaf)}
    port_keys = {k for k, v in port.items() if port_q._is_quantized_leaf(v)}
    assert {torch_key(p[1:]) for p in ref_leaves} == port_keys
    assert len(port_keys) == ref_report["quantized_leaves"] > 0
    for path, leaf in ref_leaves.items():
        key = torch_key(path[1:])
        want_q8 = variables_from_jax(_nest(path, leaf["q8"]))[key]
        got = port[key]
        assert got["q8"].dtype == torch.int8
        assert torch.equal(got["q8"], want_q8), key
        assert torch.equal(got["scale"], torch.from_numpy(
            np.asarray(leaf["scale"]))), key
    for k in ("quantized_leaves", "skipped_leaves", "bytes_f32",
              "bytes_int8", "compression"):
        assert port_report[k] == ref_report[k], k
    if name == "vit":
        qkv = port["ViTBlock_0.Attention_0.qkv.weight"]
        assert qkv["scale"].shape == (VIT["dim"] // VIT["num_heads"],)
        assert qkv["q8"].shape == (3 * VIT["dim"], VIT["dim"])
    if name == "vmoe":
        w1 = [k for k in port_keys if k.endswith(".w1")]
        assert w1 and all(port[k]["scale"].shape == (port[k]["q8"].shape[-1],)
                          for k in w1)


@pytest.mark.parametrize("name", ["yolov3", "hourglass", "vit", "vmoe"])
def test_dequantized_state_dict_bit_equal(cases, name):
    case = cases[name]
    (ref, _), (port, _) = both(case)
    want = variables_from_jax(jax.device_get(ref_q.dequantize_variables(ref)))
    got = port_q.dequantize_variables(port)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_qkv_without_its_features_raises(cases):
    with pytest.raises(ServeError, match="dense_features"):
        port_q.quantize_variables(cases["vit"].sd)


def test_kernel_free_tree_refused_in_both():
    with pytest.raises(RefServeError, match="no kernel leaves"):
        ref_q.quantize_variables({"bias": np.zeros((4,), np.float32)})
    with pytest.raises(ServeError, match="no kernel leaves"):
        port_q.quantize_variables({"bias": torch.zeros(4)})


# -- the calibration gate -------------------------------------------------------

def ref_toy(variables, images):
    return images.reshape((images.shape[0], -1)) @ variables["w"]


def port_toy(variables, images):
    return images.reshape(images.shape[0], -1) @ variables["w"]


def ref_scores(variables, images):
    return {"scores": ref_toy(variables, images)}


def port_scores(variables, images):
    return {"scores": port_toy(variables, images)}


def toy_w(seed=0, scale=0.1):
    return (np.random.RandomState(seed).randn(16, 6) * scale).astype(
        np.float32)


def gate_both(tmp_path, w, batches, tolerance, tag, fns=(ref_toy, port_toy)):
    """calibrate_and_quantize of a toy, fns (reference's, port's), in
    both packages -> ((reference model or exception, rows), (port's,
    rows))."""
    out = []
    for port in (False, True):
        path = str(tmp_path / f"{tag}_{'port' if port else 'ref'}.jsonl")
        journal = (RunJournal if port else RefJournal)(path, kind="serve")
        mod = port_q if port else ref_q
        fn = fns[port]
        var = {"w": torch.from_numpy(w.copy()) if port else w.copy()}
        try:
            got = mod.calibrate_and_quantize(
                "toy", fn, var, [b.copy() for b in batches],
                tolerance=tolerance, journal=journal)
        except Exception as e:
            got = e
        journal.close()
        read = read_journal if port else ref_read_journal
        rows = [r for r in read(path) if r["event"] == "quant_calibrated"]
        if port:
            assert check_journal(path, strict=True) == []
        out.append((got, rows))
    return out


def test_gate_on_logits_agrees(tmp_path):
    rng = np.random.RandomState(0)
    batches = [rng.rand(8, *IMG).astype(np.float32) for _ in range(3)]
    (ref, ref_rows), (port, port_rows) = gate_both(
        tmp_path, toy_w(scale=0.3), batches, 0.02, "logits")
    assert port.metric == ref.metric == "top1"
    assert port.delta == ref.delta
    assert port.report == ref.report
    strip = [{k: v for k, v in r.items() if k not in ("ts", "run_id")}
             for r in port_rows]
    assert strip == [{k: v for k, v in r.items()
                      if k not in ("ts", "run_id")} for r in ref_rows]
    assert port_rows[0]["accepted"] is True


def test_poisoned_case_refused_in_both(tmp_path):
    """Same weights, same tolerance, a dict output (output_mse): a random
    stream passes, the constant-image stream that exposes the
    cancelling-outlier channel is refused, in both packages, with the
    same typed rows."""
    w = toy_w(scale=0.02)
    w[0, :], w[1, :] = 500.0, -500.0
    rng = np.random.RandomState(0)
    random_calib = [rng.rand(4, *IMG).astype(np.float32) for _ in range(3)]
    fns = (ref_scores, port_scores)
    (ref, _), (port, _) = gate_both(tmp_path, w, random_calib, 0.005, "ok",
                                    fns)
    assert port.metric == ref.metric == "output_mse"
    np.testing.assert_allclose(port.delta, ref.delta, rtol=DELTA_RTOL)
    assert ref.delta <= 0.005
    poison = [np.full((4, *IMG), v, np.float32) for v in (0.2, 0.6, 0.9)]
    (ref, ref_rows), (port, port_rows) = gate_both(tmp_path, w, poison,
                                                   0.005, "poison", fns)
    assert isinstance(ref, ref_q.QuantizationRejected)
    assert isinstance(port, port_q.QuantizationRejected)
    assert isinstance(port, ServeError)
    assert str(port) == str(ref)
    assert [r["accepted"] for r in port_rows] == \
        [r["accepted"] for r in ref_rows] == [False]
    np.testing.assert_allclose(port_rows[0]["delta"], ref_rows[0]["delta"],
                               rtol=DELTA_RTOL)


def test_gate_on_pose_agrees(cases):
    """The hourglass's keypoints (B, J, 3): output_mse in both, the same
    verdict at the serve smoke's tolerance and at one below the delta."""
    case = cases["hourglass"]
    rng = np.random.RandomState(7)
    batches = [rng.rand(2, 64, 64, 3).astype(np.float32) for _ in range(2)]
    ref_fn = jax.jit(ref_inference.pose_predict_fn(case.jm))
    ref = ref_q.calibrate_and_quantize(
        "pose", ref_fn, jax.tree_util.tree_map(jnp.asarray, case.v),
        batches, tolerance=0.02)
    port = port_q.calibrate_and_quantize(
        "pose", port_inference.pose_predict_fn(case.tm), case.sd, batches,
        tolerance=0.02)
    assert port.metric == ref.metric == "output_mse"
    assert 0 < ref.delta <= 0.02
    np.testing.assert_allclose(port.delta, ref.delta, rtol=DELTA_RTOL)
    below = ref.delta / 2
    with pytest.raises(ref_q.QuantizationRejected):
        ref_q.calibrate_and_quantize(
            "pose", ref_fn, jax.tree_util.tree_map(jnp.asarray, case.v),
            batches, tolerance=below)
    with pytest.raises(port_q.QuantizationRejected):
        port_q.calibrate_and_quantize(
            "pose", port_inference.pose_predict_fn(case.tm), case.sd,
            batches, tolerance=below)


def test_gate_refuses_empty_calibration():
    with pytest.raises(ServeError, match="at least one"):
        port_q.calibrate_and_quantize(
            "toy", port_toy, {"w": torch.from_numpy(toy_w())}, [])


# -- the Engine ---------------------------------------------------------------

def test_requantized_tree_swaps_with_no_warmup():
    q1, _ = port_q.quantize_variables({"w": torch.from_numpy(toy_w(0))})
    q2, _ = port_q.quantize_variables({"w": torch.from_numpy(toy_w(9))})
    eng = Engine(device="cpu", registry=Registry())
    eng.register("toy", port_q.quantized_fn(port_toy), q1, input_shape=IMG,
                 buckets=(2,))
    stats = eng.warmup()
    assert stats["backend_compiles"] == stats["cache_hits"] == 0
    img = np.random.RandomState(1).rand(2, *IMG).astype(np.float32)
    out1 = eng.run("toy", img)
    w0 = warmup_count()
    eng.set_variables("toy", q2)
    clone = eng.clone_with_variables({"toy": q1})
    out2 = eng.run("toy", img)
    assert warmup_count() == w0
    assert not torch.allclose(out1, out2)
    assert torch.equal(clone.run("toy", img), out1)
    with pytest.raises(ServeError, match="precision"):
        eng.set_variables("toy", {"w": torch.from_numpy(toy_w(0))})
    bad = {"w": {"q8": q1["w"]["q8"][:8], "scale": q1["w"]["scale"]}}
    with pytest.raises(ServeError, match="w/q8"):
        eng.set_variables("toy", bad)


# -- the checkpoint sidecar -----------------------------------------------------

def test_scales_round_trip_checkpoint_sidecar(tmp_path):
    qvars, _ = port_q.quantize_variables(
        {"layer.weight": torch.from_numpy(
            np.random.RandomState(0).randn(5, 8).astype(np.float32))})
    ref_qvars, _ = ref_q.quantize_variables({"layer": {"kernel": np.random
                                             .RandomState(0).randn(5, 8)
                                             .astype(np.float32).T}})
    host = port_q.scales_host_state(qvars)
    assert host == {"layer.weight": ref_q.scales_host_state(ref_qvars)[
        "layer/kernel"]}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_tree(1, qvars, host_state={"quant_scales": host})
    mgr.wait()
    template = {k: {q: torch.zeros_like(t) for q, t in v.items()}
                for k, v in qvars.items()}
    restored, state = mgr.restore_tree(template, step=1)
    rejoined = port_q.apply_scales(restored, state["quant_scales"])
    for part in ("q8", "scale"):
        assert torch.equal(rejoined["layer.weight"][part],
                           qvars["layer.weight"][part])
    mgr.close()


def test_apply_scales_errors_match_the_reference():
    w = toy_w()
    ref, _ = ref_q.quantize_variables({"w": w})
    port, _ = port_q.quantize_variables({"w": torch.from_numpy(w)})
    ref_host, port_host = (ref_q.scales_host_state(ref),
                           port_q.scales_host_state(port))
    assert port_host == ref_host
    bad = dict(ref_host, w=ref_host["w"][:-1])
    extra = dict(ref_host, ghost=[1.0])
    for host in ({}, bad, extra):
        with pytest.raises(RefServeError) as want:
            ref_q.apply_scales(ref, host)
        with pytest.raises(ServeError) as got:
            port_q.apply_scales(port, host)
        assert str(got.value) == str(want.value)
