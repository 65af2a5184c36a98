"""Shared parts of the port's Server parity on the serve smoke's task
families (tests/test_torch_serve_tasks.py: pose and CenterNet;
tests/test_torch_serve_tasks_yolo.py: YOLOv3): one model's reference
and port Engines on the same weights (`Pair`), the seeded requests, the
bursts through both Servers, and the two comparisons.

Models: hourglass (num_stack=1, num_heatmap=4) and yolov3
(num_classes=4) at 64x64, as tools/serve_smoke.py builds them;
CenterNet's objects_as_points (num_stack=1) at 128x128, the smallest
input its order-5 hourglass takes (at 64x64 its innermost map has no
pixel). The variables follow the reference's init tree (`jax.eval_shape`
of `init`) with seeded numpy leaves (tests/torch_parity.randomize),
bridged by convert.py; the hourglasses' residual branches end in kernels
scaled by 0.1 (torch_parity.damp_residual_branches), as their model
tests hold them; and every BatchNorm's running statistics are set to its
input's batch statistics on the requests (torch_infer_parity.calibrated),
as the inference CLI's parity tests do: at init statistics the residual
stacks grow their outputs until the scores saturate at 1 and tie. Each
reference Engine warms one bucket, (4,): one jit a model.

Held: keypoints (x, y) equal, except at a joint whose heatmap has a
second value within MODEL_TOL of its maximum (a tie either side may
break its own way); keypoint scores, boxes and scores within MODEL_TOL
(1e-4) of the largest |value|, as tests/test_torch_hourglass.py and
tests/test_torch_centernet.py hold these models; detection counts and
classes equal. A NaN image under health_policy="abort" fails the same
requests in both, and both journals name the same non-finite fields.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deep_vision_tpu.inference as ref_inference
import deep_vision_tpu.models as ref_models
import deep_vision_tpu_torch.inference as port_inference
import deep_vision_tpu_torch.models as port_models
from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs import read_journal as ref_read_journal
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.serve import Engine as RefEngine
from deep_vision_tpu.serve import Server as RefServer
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.serve import Engine, Server
from torch_infer_parity import calibrated
from torch_parity import damp_residual_branches, randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import check_journal  # noqa: E402

MODEL_TOL = 1e-4
BUCKETS = (4,)
#: requests a burst; the last burst's lone request pads to bucket 4
BURSTS = (4, 3, 1)

#: task -> (model name, its kwargs, input side, predictor, its kwargs)
MODELS = {
    "pose": ("hourglass", dict(num_stack=1, num_heatmap=4), 64,
             "pose_predict_fn", {}),
    "centernet": ("objects_as_points", dict(num_stack=1), 128,
                  "centernet_predict_fn",
                  dict(max_detections=16, score_threshold=0.1)),
    "yolo": ("yolov3", dict(num_classes=4), 64, "yolo_predict_fn",
             dict(max_detections=8, score_threshold=0.3)),
}


def requests(side, seed=0, nan_at=None):
    rng = np.random.RandomState(seed)
    out = [rng.rand(side, side, 3).astype(np.float32)
           for _ in range(sum(BURSTS))]
    if nan_at is not None:
        out[nan_at][0, 0, 0] = np.nan
    return out


class Pair:
    """One model's warmed reference and port Engines on the same
    weights, and its port module (for the heatmaps' ties)."""

    def __init__(self, task):
        name, kw, side, fn, fn_kw = MODELS[task]
        self.task, self.side = task, side
        x = jnp.zeros((1, side, side, 3), jnp.float32)
        jm = ref_models.get_model(name, **kw)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), x, train=False))
        v = randomize(shapes, np.random.RandomState(1))
        if name != "yolov3":
            damp_residual_branches(v)
        v = calibrated(name, np.stack(requests(side)), **kw)(v)
        self.ref = RefEngine(registry=RefRegistry())
        self.ref.register(task, getattr(ref_inference, fn)(jm, **fn_kw),
                          jax.tree_util.tree_map(jnp.asarray, v),
                          input_shape=(side, side, 3), buckets=BUCKETS)
        self.ref.warmup()
        build, _ = port_models.MODEL_REGISTRY[name]
        self.model = build(**kw).eval()
        self.model.load_state_dict(variables_from_jax(v))
        self.port = Engine(device="cpu", registry=Registry())
        self.port.register(task,
                           getattr(port_inference, fn)(self.model, **fn_kw),
                           self.model.state_dict(),
                           input_shape=(side, side, 3), buckets=BUCKETS)
        self.port.warmup()

    def serve(self, tmp_path, policy="warn", nan_at=None,
              max_wait_ms=300.0):
        """The bursts through both Servers -> ((port rows, port journal
        rows), (reference rows, reference journal rows)); a failed request
        is its exception's type name. A burst shares one batch when
        `max_wait_ms` outlasts its submits."""
        out = []
        for port in (True, False):
            tag = "port" if port else "ref"
            path = str(tmp_path / f"{self.task}_{tag}.jsonl")
            journal = (RunJournal if port else RefJournal)(path,
                                                           kind="serve")
            srv = (Server if port else RefServer)(
                self.port if port else self.ref, journal=journal,
                registry=Registry() if port else RefRegistry(),
                max_wait_ms=max_wait_ms, health_policy=policy).start()
            ims = requests(self.side, seed=5, nan_at=nan_at)
            rows, i = [], 0
            for n in BURSTS:
                futs = [srv.submit(self.task, im) for im in ims[i:i + n]]
                i += n
                for f in futs:
                    try:
                        rows.append(f.result(timeout=120))
                    except Exception as e:  # either package's ServeError
                        rows.append(type(e).__name__)
            srv.close()
            journal.close()
            if port:
                assert check_journal(path, strict=True) == []
            read = read_journal if port else ref_read_journal
            out.append((rows, [r for r in read(path) if r["event"] in (
                "serve_request", "serve_batch", "health")]))
        return out


def near(got, want, name):
    want = np.asarray(want, np.float32)
    atol = MODEL_TOL * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=atol, err_msg=name)


def heatmap_ties(pair, ims):
    """(image, joint) pairs whose last-stack heatmap has a second value
    within MODEL_TOL of its maximum."""
    with torch.inference_mode():
        out = pair.model(torch.from_numpy(np.stack(ims)))
    hm = (out[-1] if isinstance(out, (list, tuple)) else out).numpy()
    flat = np.sort(hm.reshape(hm.shape[0], -1, hm.shape[-1]), axis=1)
    top, second = flat[:, -1], flat[:, -2]
    return {tuple(ij) for ij in np.argwhere(
        top - second <= MODEL_TOL * np.abs(hm).max())}


def check_rows(pair, tmp_path):
    """Each request's row from the port's Server against the
    reference's (a row does not depend on its batch: eval-mode
    BatchNorms, per-image decodes)."""
    (got, _), (want, _) = pair.serve(tmp_path, max_wait_ms=20.0)
    assert len(got) == len(want) == sum(BURSTS)
    if pair.task == "pose":
        ties = heatmap_ties(pair, requests(pair.side, seed=5))
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert isinstance(g, np.ndarray) and g.shape == w.shape == (4, 3)
            for j in range(g.shape[0]):
                if (i, j) not in ties:
                    np.testing.assert_array_equal(g[j, :2], w[j, :2])
            near(g[:, 2], w[:, 2], "keypoint scores")
        return
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        n = int(g["num"])
        assert n == int(w["num"]) and n > 0
        np.testing.assert_array_equal(g["classes"], np.asarray(w["classes"]))
        for k in ("boxes", "scores"):
            near(g[k], w[k], k)


def check_nan_under_abort(pair, tmp_path):
    """A NaN image under health_policy=\"abort\": the same requests
    fail, and the same health rows name the same fields."""
    (got, port_rows), (want, ref_rows) = pair.serve(
        tmp_path, policy="abort", nan_at=BURSTS[0])
    assert [isinstance(r, str) for r in got] == \
        [isinstance(r, str) for r in want]

    def health(rows):
        return [(r["fields"], r["batch_size"]) for r in rows
                if r["event"] == "health"]

    def outcomes(rows):
        return [r["outcome"] for r in rows if r["event"] == "serve_request"]

    assert health(port_rows) == health(ref_rows)
    assert outcomes(port_rows) == outcomes(ref_rows)
    if pair.task == "pose":  # a bare output's leaf is named by its index
        assert health(port_rows) == [(["0"], 3)]
        assert got[4:7] == ["ServeError"] * 3
