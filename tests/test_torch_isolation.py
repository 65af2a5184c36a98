"""The port stands alone: importing any of its modules (the training
slice's included) loads neither JAX, flax, optax nor the JAX package;
its entry points (serving and training) default to the card and raise
without one; and the kernel builder names what is missing when there is
no `nvcc`.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deep_vision_tpu_torch

PKG = Path(deep_vision_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deep_vision_tpu")


def port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_source_imports_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from deep_vision_tpu_torch.core.train_state import create_train_state
    from deep_vision_tpu_torch.inference import make_yolo_detector
    from deep_vision_tpu_torch.losses import classification_loss_fn
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.serve import Engine
    from deep_vision_tpu_torch.tools.profile_train import (
        make_train_parts,
        make_vit_train_parts,
    )
    from deep_vision_tpu_torch.train import Trainer, build_optimizer

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        get_model("darknet53")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Engine()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_yolo_detector(torch.nn.Identity())
    tiny = torch.nn.Linear(2, 2)
    tx = build_optimizer("sgd", 0.1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        create_train_state(tiny, tx, torch.zeros(1, 2))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Trainer(tiny, tx, classification_loss_fn, torch.zeros(1, 2))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_train_parts(1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        get_model("vit_s16")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_vit_train_parts(1, 32)
    assert get_model("darknet53", device="cpu") is not None
    assert get_model("resnet50", device="cpu") is not None
    assert get_model("vit_s16", device="cpu") is not None
    trainer, batch = make_vit_train_parts(1, 32, device="cpu")
    assert trainer.device.type == "cpu" and batch["image"].shape == (
        1, 32, 32, 3)


def test_builder_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    from deep_vision_tpu_torch.ops.cuda import build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["nms"])
    assert not (tmp_path / "build").exists()


def test_every_kernel_source_is_known_to_the_builder():
    from deep_vision_tpu_torch.ops.cuda import build

    assert sorted(build.sources()) == ["bn_act", "flash_attention", "nms",
                                       "norm"]
    with pytest.raises(KeyError):
        build.build(["no_such_kernel"])
