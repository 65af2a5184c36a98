"""Port parity: a GAN run's checkpoint under deep_vision_tpu_torch/tools/
infer.py's -c, a fault of the JAX package's tools/infer.py that the port
keeps, on the CPU.

The GAN trainers save their sub-networks by name ({"g": ..., "d": ...}
for dcgan_mnist; cyclegan's {"gab": ...} the same way), and
restore_variables reads the classifier trainers' key ("params" in the
reference, "model" in the port), so `infer -m dcgan_mnist -c <a
train_cli dcgan run>` raises KeyError in both packages.
"""
import os

import pytest
import torch

import deep_vision_tpu.tools.infer as ref_infer
import deep_vision_tpu.train_cli as ref_cli
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.tools import infer
from torch_infer_parity import write_jpegs


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    return write_jpegs(tmp_path_factory.mktemp("jpegs"))


def test_gan_checkpoints_raise_in_both_packages(tmp_path, jpegs):
    """-c with a dcgan_mnist run that each package's train_cli wrote."""
    args = ["-m", "dcgan_mnist", "--fake-data", "--fake-batches", "1",
            "--batch-size", "8", "--epochs", "1"]
    ref_ck, port_ck = str(tmp_path / "ref_ck"), str(tmp_path / "port_ck")
    assert ref_cli.main(args + ["--ckpt-dir", ref_ck]) == 0
    assert train_cli.main(args + ["--ckpt-dir", port_ck, "--device",
                                  "cpu"]) == 0
    saved = torch.load(os.path.join(port_ck, "1", "state.pt"),
                       weights_only=True)
    assert sorted(saved) == ["d", "g"]
    out = ["-o", str(tmp_path / "out"), jpegs[0]]
    with pytest.raises(KeyError, match="'params'"):
        ref_infer.main(["-m", "dcgan_mnist", "-c", ref_ck] + out)
    with pytest.raises(KeyError, match="'model'"):
        infer.main(["-m", "dcgan_mnist", "--device", "cpu", "-c",
                    port_ck] + out)
    assert not (tmp_path / "out").exists()
