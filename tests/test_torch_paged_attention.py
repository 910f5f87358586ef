"""The port's paged attention (tf_operator_tpu_torch/ops/paged_attention.py)
held against the JAX package's on the CPU in f32: the plain PyTorch
version against JAX ``paged_attend`` (Pallas interpret mode, as
tests/test_paged_attention.py runs it) and against that file's gather
oracle, on the same seeded inputs. Tolerance atol=1e-5: the same f32
math summed in another order. The CUDA kernel itself is compared with
the plain version on the card, in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from test_paged_attention import gather_oracle, make_case
from tf_operator_tpu.ops.paged_attention import (
    paged_attend as jax_paged_attend,
)
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

ATOL = 1e-5


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# t in {1, 3} x g in {1, 4} x blk in {8, 16}; S = 64, and every spread
# holds an inactive lane at index 0 (all-zero table past block 0).
CASES = [
    dict(b=3, t=t, kv=2, g=g, dh=16, blk=blk, table_len=64 // blk,
         kv8=False, seed=10 * t + g + blk, spread=[5, 40, 0])
    for t in (1, 3) for g in (1, 4) for blk in (8, 16)
]


@pytest.mark.parametrize(
    "case", CASES,
    ids=lambda c: f"t{c['t']}g{c['g']}blk{c['blk']}",
)
def test_reference_matches_jax_paged_attend(case):
    q, pk, pv, table, idx, _, _ = make_case(**case)
    want_kernel = np.asarray(jax_paged_attend(q, pk, pv, table, idx))
    want_oracle = np.asarray(gather_oracle(q, pk, pv, table, idx))
    got = pa.paged_attend_reference(*_torch(q, pk, pv, table, idx))
    assert got.dtype == torch.float32
    assert got.shape == (case["b"], case["t"], case["kv"] * case["g"], 16)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_oracle, atol=ATOL, rtol=0)


def test_cpu_dispatch_runs_the_plain_version_and_counts_nothing():
    q, pk, pv, table, idx, _, _ = make_case(**CASES[-1])
    args = _torch(q, pk, pv, table, idx)
    before = pa.launches
    got = pa.paged_attend(*args)
    assert pa.launches == before
    torch.testing.assert_close(got, pa.paged_attend_reference(*args),
                               rtol=0, atol=0)


def test_stale_table_tail_is_invisible():
    """Entries past a lane's owned blocks must not change the output."""
    q, pk, pv, table, idx, _, _ = make_case(**CASES[0])
    q, pk, pv, table, idx = _torch(q, pk, pv, table, idx)
    base = pa.paged_attend_reference(q, pk, pv, table, idx)
    dirty = table.clone()
    dirty[0, 1:] = 3  # lane 0 owns one block; its tail points at data
    got = pa.paged_attend_reference(q, pk, pv, dirty, idx)
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def test_rejects_bad_shapes_and_unknown_devices():
    q, pk, pv, table, idx, _, _ = make_case(**CASES[-1])  # 8 heads
    q, pk, pv, table, idx = _torch(q, pk, pv, table, idx)
    with pytest.raises(ValueError, match="at least one query row"):
        pa.paged_attend(q[:, :0], pk, pv, table, idx)
    with pytest.raises(ValueError, match="multiple of KV"):
        pa.paged_attend(q[:, :, :3], pk, pv, table, idx)
    # No quiet fallback: a tensor neither on the CPU nor on the card
    # raises instead of running the plain version.
    meta = [x.to("meta") for x in (q, pk, pv, table, idx)]
    with pytest.raises(ValueError, match="no kernel for device"):
        pa.paged_attend(*meta)


@pytest.mark.parametrize("t,h,kv,dh,dtype,ok", [
    (1, 16, 4, 64, torch.bfloat16, True),
    (3, 16, 4, 64, torch.float32, True),
    (8, 16, 4, 64, torch.bfloat16, True),    # 32 rows: the limit
    (9, 16, 4, 64, torch.bfloat16, False),   # 36 rows per KV head
    (1, 16, 4, 48, torch.bfloat16, False),   # no instance for Dh=48
    (1, 16, 4, 64, torch.float16, False),
    (1, 6, 4, 64, torch.float32, False),     # heads do not tile KV
])
def test_supported_geometry(t, h, kv, dh, dtype, ok):
    assert pa.paged_attend_supported(t, h, kv, dh, dtype) is ok


# (nblk, S): the slice's lanes at blk 128 (28, 14, 7 and 4 blocks), a lane
# at index 0 (1 block), fewer blocks than splits, a count that is not a
# multiple of S, and the 512-entry table, at S = 8 and at 16.
SPLIT_CASES = [(28, 8), (14, 8), (7, 8), (4, 8), (1, 8), (29, 8), (512, 8),
               (3, 16), (28, 16), (512, 16)]


@pytest.mark.parametrize("nblk,splits", SPLIT_CASES,
                         ids=lambda v: str(v))
def test_split_walk_walks_each_owned_block_once(nblk, splits):
    walk = pa.split_walk(nblk, splits)
    assert len(walk) == splits
    walked = sorted(j for blocks in walk for j in blocks)
    assert walked == list(range(nblk))  # each owned block exactly once
    assert walk[0][:1] == [0]           # block 0 falls to split 0
    assert all(j < nblk for blocks in walk for j in blocks)
    assert all(blocks == sorted(blocks) for blocks in walk)


def test_split_walk_keeps_every_split_busy_on_the_longest_lane():
    """The strided rule: the 3500-token lane's 28 blocks give every split
    work at S = 8 and at the wrapper's S = 16 (so a merge that drops the
    last split shows), and a 437-token lane's 4 blocks leave the other
    CTAs with none."""
    assert [len(w) for w in pa.split_walk(28, 8)] == [4] * 4 + [3] * 4
    assert pa.split_walk(28, 8)[7] == [7, 15, 23]
    assert [len(w) for w in pa.split_walk(4, 8)] == [1] * 4 + [0] * 4
    assert pa.SPLITS == 16
    assert [len(w) for w in pa.split_walk(28)] == [2] * 12 + [1] * 4
    assert pa.split_walk(28)[15] == [15]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_name_follows_the_source():
    path = _build.library_path("paged_attention")
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path("paged_attention")
