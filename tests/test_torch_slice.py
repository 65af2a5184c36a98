"""The whole slice on the CPU: JAX `jit(yolo_predict_fn(...))` against the
port's Engine + Server end to end, on the same numpy images and bridged
weights (YOLOv3 at 64x64, num_classes=4, full depth).

Tolerances: `boxes` and `scores` atol = 1e-5. The raw head outputs
agree to ~1e-5 (tests/test_torch_yolov3.py), and decode passes them
through sigmoid/exp, whose derivatives here are <= 1 and ~box size, so
the detections move by no more than that. `classes` and `num` must be
equal: they are discrete, and a flipped pick would show as a class or
count mismatch. If one appears, the failure message reports how close
the two runs' picked scores were, so a genuine near-tie (a score gap
inside the tolerance) can be told from a real fault; the seed is not to
be changed to hide it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.inference import yolo_predict_fn as jax_predict_fn
from deep_vision_tpu.models import yolov3 as jax_yolo
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.inference import yolo_predict_fn
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.serve import Engine, Server

ATOL = 1e-5
DET = dict(max_detections=8, score_threshold=0.3)


def randomize(tree, rng, path=()):
    """numpy leaves from `rng`: kernels at 1/sqrt(fan_in), each residual
    branch's last kernel damped by 0.1 (so activations stay of order 1
    through 23 residual adds), BN terms away from init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng, path + (k,))
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(int(np.prod(shape[:-1])))
            if len(path) >= 4 and path[-4].startswith("DarknetResidual") \
                    and path[-3] == "DarknetConv_1":
                a = a * 0.1
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def both():
    jm = jax_yolo.YoloV3(num_classes=4)
    imgs = np.random.RandomState(21).rand(5, 64, 64, 3).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs[:1]),
                               train=False))
    v = randomize(v, np.random.RandomState(22))
    want = jax.device_get(
        jax.jit(jax_predict_fn(jm, **DET))(v, jnp.asarray(imgs)))
    model = get_model("yolov3", num_classes=4, device="cpu")
    return model, variables_from_jax(v), imgs, want


def test_server_matches_jax_end_to_end(both):
    model, variables, imgs, want = both
    eng = Engine(device="cpu", registry=Registry())
    eng.register("yolov3", yolo_predict_fn(model, **DET), variables,
                 input_shape=(64, 64, 3), buckets=(1, 2, 4))
    eng.warmup()
    srv = Server(eng, registry=Registry(), max_wait_ms=20.0).start()
    try:
        rows = [f.result(timeout=120)
                for f in [srv.submit("yolov3", im) for im in imgs]]
    finally:
        summary = srv.close()
    assert summary["outcome"] == "flushed" and summary["completed"] == 5
    assert sum(int(r["num"]) for r in rows) > 0, "the model kept nothing"
    for i, row in enumerate(rows):
        assert row["boxes"].shape == (8, 4) and row["classes"].shape == (8,)
        gap = np.abs(row["scores"] - want["scores"][i]).max()
        assert int(row["num"]) == int(want["num"][i]), \
            f"image {i}: count differs (max picked-score gap {gap:.3g})"
        np.testing.assert_array_equal(
            row["classes"], want["classes"][i],
            err_msg=f"image {i}: a pick flipped (max score gap {gap:.3g})")
        np.testing.assert_allclose(row["scores"], want["scores"][i],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(row["boxes"], want["boxes"][i],
                                   rtol=0, atol=ATOL)


def test_predict_fn_takes_variables_at_call_time(both):
    """Hot-swap relies on it: the same fn with other variables gives the
    other model's answer, and the bridged variables give JAX's."""
    model, variables, imgs, want = both
    fn = yolo_predict_fn(model, **DET)
    x = torch.from_numpy(imgs[:2])
    out = fn(variables, x)
    np.testing.assert_allclose(out["scores"].numpy(), want["scores"][:2],
                               rtol=0, atol=ATOL)
    zeroed = {k: torch.zeros_like(t) if k.endswith("Conv_0.bias") else t
              for k, t in variables.items()}
    assert any(k.endswith("Conv_0.bias") for k in variables)
    other = fn(zeroed, x)
    assert not torch.equal(other["scores"], out["scores"])


def test_make_yolo_detector_on_cpu(both):
    from deep_vision_tpu_torch.inference import make_yolo_detector

    model, variables, imgs, want = both
    reg = Registry()
    detect = make_yolo_detector(model, device="cpu", registry=reg, **DET)
    out = detect(variables, imgs[:2])
    np.testing.assert_array_equal(out["classes"].numpy(), want["classes"][:2])
    np.testing.assert_allclose(out["boxes"].numpy(), want["boxes"][:2],
                               rtol=0, atol=ATOL)
    assert reg.counter("inference_requests_total",
                       labels={"task": "yolo"}).value == 1
    assert reg.histogram("inference_latency_ms",
                         labels={"task": "yolo"}).mean > 0
