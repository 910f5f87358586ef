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


@pytest.mark.parametrize("source", ["flash_attention", "int8_dense"])
def test_the_tma_sources_are_hashed_with_their_hopper_header(source):
    """Both sources include sm90.cuh, so an edit there rebuilds them."""
    names = [os.path.basename(p) for p in _build.sources(source)]
    assert names == [f"{source}.cu", "sm90.cuh"]
    with open(_build.source_path(source)) as f:
        assert '#include "sm90.cuh"' in f.read()


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
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_5326155211flash_dq_wsILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__fdabf354_18_flash_attention_cu_5326155211flash_dq_wsILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0b2a7c31_13_int8_dense_cu_a1b2c3d411int8_streamI13__nv_bfloat16S1_Li4EEEvPKT_PKaPKfS7_PT0_iiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0b2a7c31_13_int8_dense_cu_a1b2c3d411int8_streamI13__nv_bfloat16S1_Li4EEEvPKT_PKaPKfS7_PT0_iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0b2a7c31_13_int8_dense_cu_a1b2c3d410int8_tiledIffEEvPKT_PKaPKfS7_PT0_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0b2a7c31_13_int8_dense_cu_a1b2c3d410int8_tiledIffEEvPKT_PKaPKfS7_PT0_iii
    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0b2a7c31_13_int8_dense_cu_a1b2c3d410int8_wgmmaIfEEv14CUtensorMap_stS1_PKfS3_PT_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0b2a7c31_13_int8_dense_cu_a1b2c3d410int8_wgmmaIfEEv14CUtensorMap_stS1_PKfS3_PT_iii
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
"""


def test_chip_smoke_reads_the_tma_instances_spills_from_ptxas():
    """chip_smoke fails a build whose TMA instances spill: it reads each
    one's spill stores from the ptxas log, by name (the flash _ws kernels,
    B2's among them, and B5's wgmma tile), and leaves the others (B2's old
    mma.sync instance, B5's weight stream and f32 tile here) out."""
    import chip_smoke

    assert chip_smoke.ws_spills(PTXAS_LOG) == {
        "flash_dkv_ws<128>": 96, "flash_fwd_ws<64>": 0, "flash_dq_ws<64>": 0,
        "int8_wgmma<f>": 8}


def test_each_planted_fault_names_text_that_occurs_once():
    """tools/plant_fault.py changes one piece of text in a kernel source;
    each fault's text must still occur exactly once there."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "plant_fault", os.path.join(root, "tools", "plant_fault.py"))
    plant_fault = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plant_fault)
    for fault, (source, text, faulty) in plant_fault.FAULTS.items():
        with open(os.path.join(root, source)) as f:
            code = f.read()
        assert code.count(text) == 1, fault
        assert faulty != text, fault


def test_each_probe_variant_names_text_that_occurs_once():
    """tools/torch_int8_probe.py times copies of the int8 kernel source
    with one piece of text changed; each variant's text must still occur
    exactly once there, and no variant may leave the source as it is."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_int8_probe", os.path.join(root, "tools", "torch_int8_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    with open(_build.source_path("int8_dense")) as f:
        code = f.read()
    assert set(probe.DECODE_VARIANTS + probe.PREFILL_VARIANTS) == set(
        probe.VARIANTS)
    for name in probe.VARIANTS:
        assert probe.variant_source(name) != code, name


def test_each_kernel_ab_variant_names_text_that_occurs_once():
    """tools/torch_kernel_ab.py --variant times a copy of a kernel source
    with one piece of text changed; each variant's text must still occur
    exactly once there, and no variant may leave the source as it is."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ab", os.path.join(root, "tools", "torch_kernel_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    for name, (kernel, _, _) in ab.VARIANTS.items():
        with open(_build.source_path(ab.SOURCES[kernel])) as f:
            assert ab.variant_source(name) != f.read(), name
