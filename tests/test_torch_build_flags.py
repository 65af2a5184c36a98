"""The CUDA build's per-source flags, on the CPU (no nvcc needed).

NMS and bn_act must round like their plain versions bit for bit, so
their sources are compiled with `--fmad=false`; flash attention is held
to tolerances and lets nvcc contract multiply-adds into FMAs. A
library's name carries a hash of its source and of its own flags, so a
change of either builds anew.
"""
import subprocess
from pathlib import Path

import pytest

from deep_vision_tpu_torch.ops.cuda import build

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9flash_fwd' for 'sm_90a'
ptxas info    : Function properties for _Z9flash_fwd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 158 registers, used 1 barriers, 1080 bytes smem
ptxas info    : Compiling entry function '_Z9flash_dkv' for 'sm_90a'
ptxas info    : Function properties for _Z9flash_dkv
    96 bytes stack frame, 96 bytes spill stores, 100 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1080 bytes smem
"""


@pytest.mark.parametrize("name,fmad", [("nms", False), ("bn_act", False),
                                       ("flash_attention", True)])
def test_each_source_has_its_own_flags(name, fmad):
    flags = build.flags(name)
    assert flags[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert ("--fmad=false" not in flags) == fmad
    assert "arch=compute_90a,code=sm_90a" in flags and "-v" in flags
    assert not any("fast" in f for f in flags)


def test_every_source_has_an_entry_and_no_other():
    assert set(build.sources()) == set(build.SOURCE_FLAGS)
    with pytest.raises(KeyError, match="SOURCE_FLAGS"):
        build.flags("no_such_source")


def test_the_library_hash_covers_each_sources_flags(monkeypatch):
    before = {n: build.library_path(n) for n in build.sources()}
    assert len(set(before.values())) == len(before)
    monkeypatch.setitem(build.SOURCE_FLAGS, "flash_attention",
                        ("--fmad=false",))
    after = {n: build.library_path(n) for n in build.sources()}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["nms"] == before["nms"]
    assert after["bn_act"] == before["bn_act"]
    assert after["flash_attention"].name.startswith("flash_attention-")


def test_build_passes_each_source_its_flags(monkeypatch, tmp_path):
    commands = {}

    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            out = Path(cmd[cmd.index("-o") + 1])
            commands[Path(cmd[-1]).stem] = cmd
            out.write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return REPORT, None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    seconds = build.build()
    assert set(seconds) == set(commands) == set(build.sources())
    for name, cmd in commands.items():
        assert cmd[1:cmd.index("-o")] == list(build.flags(name))
        assert build.library_path(name).exists()
        assert build.ptxas_report(name) == REPORT
    assert build.build() == {n: 0.0 for n in build.sources()}  # cached


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    usage = build.ptxas_usage(REPORT)
    assert usage == {
        "_Z9flash_fwd": {"registers": 158, "spill_stores": 0,
                         "spill_loads": 0},
        "_Z9flash_dkv": {"registers": 168, "spill_stores": 96,
                         "spill_loads": 100},
    }
    assert build.ptxas_usage("") == {}
