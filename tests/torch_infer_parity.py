"""Shared helpers of the inference CLI's parity tests
(tests/test_torch_infer_*.py): seeded JPEGs, narrowed configs registered
in both packages, the models' and predictors' outputs caught on both
sides, and one run of each CLI on the same weights.
"""
import dataclasses
import re

import jax
import numpy as np
import torch

import deep_vision_tpu.models as ref_models
import deep_vision_tpu.tools.infer as ref_infer
from deep_vision_tpu.configs import CONFIG_REGISTRY as REF_REGISTRY
from deep_vision_tpu.configs import get_config as ref_get_config
import deep_vision_tpu_torch.models as port_models
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.tools import infer
from deep_vision_tpu_torch.tools.synth_records import encode_jpeg

WARNING = "warning: no -c checkpoint; running with fresh-init weights"


def write_jpegs(directory):
    """Two seeded 300x400 noise JPEGs (the reference test's image and a
    second draw), written with encode_jpeg. -> their paths."""
    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        image = (rng.rand(300, 400, 3) * 255).astype(np.uint8)
        paths.append(str(directory / f"img{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(encode_jpeg(image))
    return paths


def register(monkeypatch, name, base, **changes):
    """A copy of `base` registered as `name` in both registries."""
    cfg = dataclasses.replace(get_config(base), name=name, **changes)
    ref = dataclasses.replace(ref_get_config(base), name=name, **changes)
    monkeypatch.setitem(CONFIG_REGISTRY, name, cfg)
    monkeypatch.setitem(REF_REGISTRY, name, ref)


def record_forward(monkeypatch, log):
    """The port's get_model, with a hook that logs each forward's input
    and output."""
    get_model = port_models.get_model

    def wrapped(*args, **kwargs):
        model = get_model(*args, **kwargs)
        model.register_forward_hook(lambda m, i, o: log.append(
            (i[0].detach().cpu().numpy(), o)))
        return model

    monkeypatch.setattr(port_models, "get_model", wrapped)


class RecordingModel:
    """A flax module whose `apply` logs its input and output."""

    def __init__(self, model, log):
        self.model, self.log = model, log

    def init(self, *args, **kwargs):
        return self.model.init(*args, **kwargs)

    def apply(self, variables, x, **kwargs):
        out = self.model.apply(variables, x, **kwargs)
        self.log.append((np.asarray(x), np.asarray(out, np.float32)))
        return out


def record_ref_model(monkeypatch, log):
    get_model = ref_models.get_model
    monkeypatch.setattr(ref_models, "get_model", lambda *a, **k:
                        RecordingModel(get_model(*a, **k), log))


def as_numpy(out):
    if isinstance(out, dict):
        return {k: as_numpy(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def record_factory(monkeypatch, module, name, log):
    """module.name(...) returns a callable whose outputs are logged."""
    make = getattr(module, name)

    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)

        def call(variables, images):
            out = fn(variables, images)
            log.append(as_numpy(out))
            return out

        return call

    monkeypatch.setattr(module, name, wrapped)


NUMBER = re.compile(r"(-?\d+\.\d+)")


def assert_printed_alike(got, want, digits=3):
    """Lines equal in their text; each printed number within the last
    printed digit (both sides round their own float32 values)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gs, ws = NUMBER.split(g), NUMBER.split(w)
        assert gs[0::2] == ws[0::2], (g, w)
        np.testing.assert_allclose([float(x) for x in gs[1::2]],
                                   [float(x) for x in ws[1::2]], rtol=0,
                                   atol=1.01 * 10 ** -digits,
                                   err_msg=f"{g} | {w}")


def plain(tree):
    """A nested dict of numpy arrays (from FrozenDicts of jax arrays)."""
    if hasattr(tree, "items"):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def calibrated(model_name, images, **kwargs):
    """variables -> the same parameters with every BatchNorm's running
    statistics set to its input's batch statistics on `images` (NHWC
    numpy), computed by the port's calibrate_batch_stats and written
    back into the flax tree."""
    from deep_vision_tpu_torch.nn.layers import calibrate_batch_stats

    def calibrate(variables):
        v = plain(variables)
        # built without get_model's seeded draw: every weight is loaded
        build, _ = port_models.MODEL_REGISTRY[model_name]
        model = build(**kwargs).eval()
        model.load_state_dict(variables_from_jax(v))
        calibrate_batch_stats(model, torch.from_numpy(images))
        for key, t in model.state_dict().items():
            *path, leaf = key.split(".")
            if leaf in ("mean", "var"):
                node = v["batch_stats"]
                for p in path:
                    node = node[p]
                node[leaf] = t.numpy().copy()
        return v

    return calibrate


def run_both(monkeypatch, tmp_path, capsys, name, images, extra=(),
             adjust=None):
    """The reference's main without -c, then the port's main on the
    reference's variables (first passed through `adjust`, where given,
    which the reference's run then uses too). -> (port stdout lines,
    reference stdout lines), the out dirs' prefixes replaced by OUT and
    the warning dropped."""
    caught = []
    restore = ref_infer._restore_variables
    adjust = adjust or (lambda v: v)
    monkeypatch.setattr(ref_infer, "_restore_variables", lambda *a: (
        caught.append(adjust(restore(*a))) or caught[-1]))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_infer.main(["-m", name, "-o", ref_dir, *extra,
                           *images]) == 0
    want = capsys.readouterr().out
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck)
    mgr.save_tree(1, {"model": variables_from_jax(plain(caught[0]))})
    mgr.close()
    assert infer.main(["-m", name, "--device", "cpu", "-c", ck, "-o",
                       port_dir, *extra, *images]) == 0
    got = capsys.readouterr().out
    assert "warning: no -c checkpoint" not in got
    want = want.replace(ref_dir, "OUT").splitlines()
    assert want[0] == WARNING
    return got.replace(port_dir, "OUT").splitlines(), want[1:]
