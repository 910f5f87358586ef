"""The port's kernel build (``tf_operator_tpu_torch/ops/_build.py``) on
the CPU, with no ``nvcc``: a library is named by its source and by every
header in ``csrc/``, so an edited header builds anew; ``build`` runs one
compiler per stale source and reuses a built one. A stand-in
compiler (a Python script that writes its ``-o`` file and records its
arguments) takes nvcc's place."""

import os
import stat
import sys

import pytest
import torch

from tf_operator_tpu_torch.ops import _build

torch.set_num_threads(1)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ with k.cu including a.cuh, which includes b.cuh, and a
    second source; the build directory beside it."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n'
                              'extern "C" int k() { return A; }\n')
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                               '#define A B\n')
    (src / "b.cuh").write_text("#define B 1\n")
    (src / "other.cu").write_text('extern "C" int other() { return 2; }\n')
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return src


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc; returns the file its calls' arguments go to, one
    line per call."""
    calls = tmp_path / "calls.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('library')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    return calls


def test_sources_are_the_source_and_every_header(csrc):
    assert _build.sources("k") == [str(csrc / f) for f in
                                   ("k.cu", "a.cuh", "b.cuh")]


@pytest.mark.parametrize("edited, rebuilds", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("other.cu", False)])
def test_library_path_follows_the_source_and_the_headers(csrc, edited,
                                                         rebuilds):
    before = _build.library_path("k")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (_build.library_path("k") != before) == rebuilds


def test_build_reuses_a_built_library_and_rebuilds_after_a_header_edit(
        csrc, fake_nvcc):
    first = _build.build("k")["k"]
    assert os.path.exists(first)
    assert _build.build("k")["k"] == first  # built: no second compile
    assert len(fake_nvcc.read_text().splitlines()) == 1
    with open(csrc / "b.cuh", "a") as f:
        f.write("#define B2 2\n")
    second = _build.build("k")["k"]
    assert second != first and os.path.exists(second)
    calls = fake_nvcc.read_text().splitlines()
    assert len(calls) == 2
    # The compiler is pointed at csrc/ for the headers, with the flags.
    assert f"-I {csrc}" in calls[1]
    assert " ".join(_build.NVCC_FLAGS) in calls[1]


def test_the_flash_source_is_hashed_with_its_hopper_header():
    names = [os.path.basename(p) for p in _build.sources("flash_attention")]
    assert names == ["flash_attention.cu", "sm90.cuh"]


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_5326155212flash_dkv_wsILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_5326155212flash_dkv_wsILi128EEEv14CUtensorMap_st
    32 bytes stack frame, 96 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 165 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_532615528flash_dqI13__nv_bfloat16Li64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_532615528flash_dqI13__nv_bfloat16Li64EEEvPKT_
    32 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_5326155212flash_fwd_wsILi64EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_5326155212flash_fwd_wsILi64EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
"""


def test_chip_smoke_reads_the_wgmma_instances_spills_from_ptxas():
    """chip_smoke fails a build whose TMA + wgmma instances spill: it
    reads each one's spill stores from the ptxas log, by name, and leaves
    the mma.sync instances (B2's spill here) out."""
    import chip_smoke

    assert chip_smoke.ws_spills(PTXAS_LOG) == {"flash_dkv_ws<128>": 96,
                                               "flash_fwd_ws<64>": 0}
