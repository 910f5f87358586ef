"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA
device; the file imports no JAX, so it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU mesh.)
Tolerance atol=1e-4: kernel and plain version both sum in f32, in
different orders, over up to 4096 keys."""

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.ops import paged_attention as pa

ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, *, t, kv, g, dh, blk, table_len, spread, seed):
    """Seeded inputs; each live lane owns distinct blocks for its rows,
    a lane at index 0 keeps an all-zero table."""
    rng = np.random.default_rng(seed)
    b, nb = len(spread), len(spread) * table_len + 1
    q = rng.standard_normal((b, t, kv * g, dh), dtype=np.float32)
    pk = rng.standard_normal((nb, blk, kv, dh), dtype=np.float32)
    pv = rng.standard_normal((nb, blk, kv, dh), dtype=np.float32)
    table = np.zeros((b, table_len), np.int32)
    nxt = 1
    for lane, pos in enumerate(spread):
        for e in range(-(-(pos + t) // blk) if pos else 0):
            table[lane, e] = nxt
            nxt += 1
    idx = np.asarray(spread, np.int32)
    return ([torch.from_numpy(x).to(dev, dtype) for x in (q, pk, pv)]
            + [torch.from_numpy(x).to(dev) for x in (table, idx)])


CASES = [
    dict(t=t, kv=2, g=g, dh=16, blk=blk, table_len=64 // blk,
         spread=[5, 40, 0], seed=t + g + blk)
    for t in (1, 3) for g in (1, 4) for blk in (8, 16)
] + [
    # The slice's shapes, with a t=3 chunk and an inactive lane.
    dict(t=1, kv=4, g=4, dh=64, blk=128, table_len=32,
         spread=[3500, 1750, 875, 437], seed=1),
    dict(t=3, kv=4, g=4, dh=64, blk=128, table_len=32,
         spread=[3500, 0, 875, 437], seed=2),
    # Dh=128 at the row limit (t*g = 32), blocks smaller than a tile.
    dict(t=4, kv=2, g=8, dh=128, blk=32, table_len=16,
         spread=[100, 511 - 4, 0], seed=3),
    # A 65536-token table: 512 entries, two per split (MAX_SPLITS).
    dict(t=2, kv=1, g=4, dh=64, blk=128, table_len=512,
         spread=[40000, 3], seed=4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"t{c['t']}g{c['g']}dh{c['dh']}blk{c['blk']}"))
def test_paged_kernel_matches_plain_version(cuda, dtype, case):
    args = _case(cuda, dtype, **case)
    before = pa.launches
    got = pa.paged_attend(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_attend_reference(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_paged_kernel_raises_outside_its_geometry(cuda):
    args = _case(cuda, torch.float32, t=1, kv=2, g=1, dh=48, blk=8,
                 table_len=4, spread=[3], seed=0)
    before = pa.launches
    with pytest.raises(ValueError, match="outside its geometry"):
        pa.paged_attend(*args)
    assert pa.launches == before
