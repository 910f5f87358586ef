"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA
device; the file imports no JAX, so it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU mesh.)
Paged attention, its kv8 variant included, atol=1e-4: kernel and plain
version both sum in f32, in different orders, over up to 4096 keys. Int8
matmul: each element within the rule and ``INT8_TOL`` of
``tf_operator_tpu_torch.testing``. Flash attention: each element
within ``rtol |plain| + atol rms(its row of plain)`` and lse within 1e-4,
the rule and tolerances of ``tf_operator_tpu_torch.testing`` (which says
why);
the one test here that runs on the CPU shows that the rule fails an
output whose last key tile went missing."""

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch import ops
from tf_operator_tpu_torch.models.transformer import _kv8_quant
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import int8_dense as i8
from tf_operator_tpu_torch.ops import paged_attention as pa
from tf_operator_tpu_torch.testing import INT8_TOL, excess, flash_excess

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
    # A 65536-token table: 512 entries, 32 blocks a CTA at S = 16.
    dict(t=2, kv=1, g=4, dh=64, blk=128, table_len=512,
         spread=[40000, 3], seed=4),
    # Lanes with fewer blocks than the cluster has CTAs (3 and 1 of 16),
    # so some CTAs own nothing and still take part in the merge.
    dict(t=1, kv=2, g=4, dh=64, blk=128, table_len=8,
         spread=[300, 0, 900], seed=5),
    # Block counts that are not multiples of S (14 and 21 blocks of 16).
    dict(t=1, kv=2, g=2, dh=32, blk=16, table_len=32,
         spread=[213, 335], seed=6),
    # The shared-memory edge: t*g = 32 at Dh 128 (f32: 64-column tiles, two
    # a 128-row block).
    dict(t=8, kv=1, g=4, dh=128, blk=128, table_len=24,
         spread=[2900, 130, 0], seed=7),
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
@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "kv8"])
def test_paged_kernel_gives_the_same_bits_twice(cuda, kv8):
    """No atomics: the cluster merge sums the splits in a fixed order, so
    two runs at the slice's shapes give the same bits."""
    args = _case(cuda, torch.bfloat16, t=1, kv=4, g=4, dh=64, blk=128,
                 table_len=32, spread=[3500, 1750, 875, 437], seed=8)
    scales = {}
    if kv8:
        args, scales = _kv8(args)
    runs = [pa.paged_attend(*args, **scales) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", CASES[-3:], ids=lambda c: (
    f"t{c['t']}g{c['g']}dh{c['dh']}blk{c['blk']}"))
def test_paged_kernel_matches_plain_version_at_other_cluster_sizes(
        cuda, monkeypatch, splits, case):
    """The split rule at other cluster sizes S than the wrapper's 16: the
    kernel reads S from the launch, so any S from 1 to 16 agrees."""
    monkeypatch.setattr(pa, "SPLITS", splits)
    for kv8 in (False, True):
        args, scales = _case(cuda, torch.float32, **case), {}
        if kv8:
            args, scales = _kv8(args)
        got = pa.paged_attend(*args, **scales)
        torch.cuda.synchronize()
        want = pa.paged_attend_reference(*args, **scales)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_paged_kernel_raises_outside_its_geometry(cuda):
    args = _case(cuda, torch.float32, t=1, kv=2, g=1, dh=48, blk=8,
                 table_len=4, spread=[3], seed=0)
    before = pa.launches
    with pytest.raises(ValueError, match="outside its geometry"):
        pa.paged_attend(*args)
    assert pa.launches == before


def _kv8(args):
    """A case's pools quantized as the kv_int8 cache stores them: int8
    pools and their f32 [nb, blk, KV] scale pools."""
    q, pk, pv, table, idx = args
    (k8, ks), (v8, vs) = _kv8_quant(pk), _kv8_quant(pv)
    return (q, k8, v8, table, idx), dict(k_scale_pool=ks, v_scale_pool=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"t{c['t']}g{c['g']}dh{c['dh']}blk{c['blk']}"))
def test_paged_kv8_kernel_matches_plain_version(cuda, dtype, case):
    args, scales = _kv8(_case(cuda, dtype, **case))
    before = pa.kv8_launches, pa.launches
    got = pa.paged_attend(*args, **scales)
    torch.cuda.synchronize()
    assert (pa.kv8_launches, pa.launches) == (before[0] + 1, before[1])
    want = pa.paged_attend_reference(*args, **scales)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_paged_kv8_kernel_raises_outside_its_geometry(cuda):
    args, scales = _kv8(_case(cuda, torch.float32, t=1, kv=2, g=1, dh=48,
                              blk=8, table_len=4, spread=[3], seed=0))
    before = pa.kv8_launches
    with pytest.raises(ValueError, match="outside its geometry"):
        pa.paged_attend(*args, **scales)
    args, scales = _kv8(_case(cuda, torch.float32, t=1, kv=2, g=1, dh=64,
                              blk=8, table_len=4, spread=[3], seed=0))
    with pytest.raises(ValueError, match="int8 with scale pools"):
        pa.paged_attend(args[0], *(x.float() for x in args[1:3]), *args[3:],
                        **scales)
    assert pa.kv8_launches == before


# The decode path's (k, n) (chip_smoke's INT8_CALLS) and the narrowest n.
INT8_SHAPES = [(1024, 1024), (1024, 512), (1024, 4096), (4096, 1024),
               (1024, 32768), (1024, 128)]
# (m, k, n): decode (m <= 8, the weight stream: k split over a cluster of
# up to 8 CTAs or not, a chunk of 132 rows at k = 1056, k = 96 in one
# chunk) and prefill (m > 8, or k beyond 8 chunks of 1024: the TMA +
# wgmma tile for bf16 x, the mma.sync tile for f32 x; ragged m tiles, n of
# 128 and 384, k not a multiple of the 64-row k step).
INT8_CASES = [(m, k, n) for k, n in INT8_SHAPES for m in (1, 4, 8)] + [
    (3, 64, 128), (2, 1024, 4096), (5, 1056, 128), (4, 8224, 256),
    (6, 96, 384), (4, 16416, 256),
    (9, 96, 256), (33, 64, 128), (16, 1024, 1024), (17, 1056, 384),
    (130, 1024, 4096),
    (437, 4096, 1024), (3500, 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", INT8_CASES,
                         ids=lambda c: "m{}k{}n{}".format(*c))
def test_int8_kernel_matches_plain_version(cuda, x_dtype, out_dtype, case):
    m, k, n = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(x_dtype)
    w = torch.randn((k, n), generator=gen, device=cuda) / k ** 0.5
    w[:, 5] = 0  # an all-zero column
    w_q, scale = i8.quantize_int8(w)
    bias = torch.randn((n,), generator=gen, device=cuda)
    wgmma = i8._library().int8_design(
        m, k, n, int(x_dtype == torch.bfloat16)) == i8.WGMMA
    for b in (None, bias):
        before = (i8.launches, i8.wgmma_launches)
        got = i8.int8_matmul(x, w_q, scale, out_dtype, b)
        torch.cuda.synchronize()
        assert (i8.launches, i8.wgmma_launches) == (
            before[0] + 1, before[1] + wgmma)
        want = i8.int8_matmul_reference(x, w_q, scale, out_dtype, b)
        assert excess(got, want, *INT8_TOL[out_dtype]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 1024, 512), (1, 1024, 32768),
                                  (437, 4096, 1024), (3500, 1024, 4096)],
                         ids=lambda c: "m{}k{}n{}".format(*c))
def test_int8_kernel_gives_the_same_bits_twice(cuda, case):
    """No atomics: the weight stream's cluster sum and the wgmma tile give
    the same bits on two runs."""
    m, k, n = case
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    w_q, scale = i8.quantize_int8(
        torch.randn((k, n), generator=gen, device=cuda))
    bias = torch.randn((n,), generator=gen, device=cuda)
    runs = [i8.int8_matmul(x, w_q, scale, torch.float32, bias)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


@pytest.mark.cuda
def test_int8_design_rule(cuda):
    """int8_design: up to 8 rows of x and k up to 8192 take the weight
    stream (1), bf16 x beyond that the TMA + wgmma tile (2), f32 x the
    mma.sync tile (0); -1 outside the geometry."""
    lib = i8._library()
    for x_bf16 in (0, 1):
        assert lib.int8_design(1, 1024, 32768, x_bf16) == 1
        assert lib.int8_design(8, 8192, 128, x_bf16) == 1
        assert lib.int8_design(9, 1024, 4096, x_bf16) == (2 if x_bf16 else 0)
        assert lib.int8_design(4, 16416, 256, x_bf16) == (2 if x_bf16 else 0)
        assert lib.int8_design(3500, 1024, 4096, x_bf16) == (
            2 if x_bf16 else 0)
    assert lib.int8_design(4, 1024, 72, 1) == -1
    assert lib.int8_design(4, 48, 128, 1) == -1
    assert lib.int8_design(1, 8224, 256, 1) == 2


@pytest.mark.cuda
def test_int8_apply_on_the_card_takes_leading_dims(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 1, 256), generator=gen, device=cuda)
    w_q, scale = i8.quantize_int8(
        torch.randn((256, 384), generator=gen, device=cuda))
    got = i8.int8_apply(x, w_q, scale)
    want = i8.int8_matmul_reference(x.reshape(4, 256), w_q, scale)
    assert got.shape == (4, 1, 384)
    assert excess(got.reshape(4, 384), want, *INT8_TOL[torch.float32]) <= 1


@pytest.mark.cuda
def test_int8_kernel_raises_outside_its_geometry(cuda):
    x = torch.zeros((4, 64), device=cuda)
    w_q, scale = i8.quantize_int8(torch.ones((64, 72), device=cuda))
    before = i8.launches
    with pytest.raises(ValueError, match="outside its geometry"):
        i8.int8_matmul(x, w_q, scale)  # n = 72
    w_q, scale = i8.quantize_int8(torch.ones((48, 128), device=cuda))
    with pytest.raises(ValueError, match="outside its geometry"):
        i8.int8_matmul(x[:, :48], w_q, scale)  # k = 48
    with pytest.raises(ValueError, match="outside its geometry"):
        i8.int8_matmul(x[:, :48].half(), w_q, scale)
    assert i8.launches == before


FLASH_CASES = [
    # (tq, tk, causal, heads, head_dim)
    (64, 64, True, 2, 64),
    (1000, 1000, True, 2, 64),
    (100, 100, True, 1, 32),
    (130, 130, True, 1, 128),
    (512, 1024, False, 2, 64),
    (1024, 512, False, 1, 128),
    (33, 77, False, 1, 32),
    # The edges of the tiles of the bf16 TMA + wgmma design (B1: 128 query
    # rows, 128-key tiles; B3: 128 keys and 64-row query tiles at Dh 64,
    # 64 keys and 32-row query tiles at Dh 128): a partial tile, one tile,
    # a partial diagonal tile, a long walk.
    (63, 63, True, 2, 64),
    (127, 127, True, 2, 64),
    (128, 128, True, 2, 64),
    (129, 129, True, 2, 64),
    (255, 255, True, 2, 64),
    (2048, 2048, True, 2, 64),
    (200, 200, True, 1, 128),
    (130, 300, False, 1, 128),
    # B2's tiles (128 query rows at Dh 64 and 64 at Dh 128, 64-key tiles):
    # a partial key tile past tk, one query tile, a straddled diagonal, a
    # long walk.
    (200, 70, False, 2, 64),
    (70, 200, False, 1, 128),
    (64, 64, True, 1, 128),
    (65, 65, True, 1, 128),
    (191, 191, True, 2, 128),
    (2048, 2048, True, 1, 128),
]


def _check_flash(q, k, v, do, causal):
    """One launch of each kernel, every output within the shared rule of
    its plain version; the backward kernels get the plain forward's lse
    and delta."""
    scale = q.shape[-1] ** -0.5
    counts = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    stats = (q, k, v, do, lse_ref, delta, causal, scale)
    dq, dk, dv = fa.flash_bwd_from_stats(*stats)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + 1 for c in counts)
    want_dk, want_dv = fa.flash_dkv_reference(*stats)
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref),
                            ("dq", dq, fa.flash_dq_reference(*stats)),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert flash_excess(name, got, want) <= 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: (
    f"{'causal' if c[2] else 'full'}{c[0]}x{c[1]}h{c[3]}d{c[4]}"))
def test_flash_kernels_match_plain_versions(cuda, dtype, case):
    tq, tk, causal, h, d = case
    gen = torch.Generator(device=cuda).manual_seed(tq + tk + d)

    def randn(t):
        return torch.randn((2, t, h, d), generator=gen, device=cuda).to(dtype)

    _check_flash(randn(tq), randn(tk), randn(tk), randn(tq), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_read_the_fused_projections_slices(cuda, dtype):
    """q, k and v as the training forward hands them over: strided slices
    of one [B, T, 3, H, Dh] projection."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((2, 1000, 3, 4, 64), generator=gen,
                      device=cuda).to(dtype)
    do = torch.randn((2, 1000, 4, 64), generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _check_flash(q, k, v, do, True)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
def test_bf16_flash_kernels_give_the_same_bits_twice(cuda, head_dim):
    """No atomics: two runs of each bf16 kernel on the same inputs agree
    bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(head_dim)
    q, k, v, do = (torch.randn((2, 2048, 4, head_dim), generator=gen,
                               device=cuda).bfloat16() for _ in range(4))
    scale = head_dim ** -0.5
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        runs.append((o, lse, *fa.flash_bwd_from_stats(q, k, v, do, lse,
                                                      delta, True, scale)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_design_rule(cuda):
    """flash_design (kernel 0 forward, 1 dQ, 2 dK/dV): every bf16 kernel
    at Dh 64 and 128 runs the TMA + wgmma design (1), f32 and bf16 Dh 32
    the mma.sync one (0); no instance answers -1."""
    lib = fa._library()
    for dh in fa.HEAD_DIMS:
        for kernel in range(3):
            want = int(dh >= 64)
            assert lib.flash_design(1, dh, kernel) == want, (dh, kernel)
            assert lib.flash_design(0, dh, kernel) == 0, (dh, kernel)
    assert lib.flash_design(1, 48, 0) == -1
    assert lib.flash_design(1, 64, 3) == -1


def test_flash_rule_fails_a_missing_last_tile():
    """On the CPU: the rule rejects an O whose last 64 keys went missing
    (causal and full) and a dK/dV that lost the last 64 queries, in both
    dtypes."""
    rng = np.random.default_rng(11)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (1, t, 2, 64), dtype=np.float32)).to(dtype)
            for t in (1024, 1024, 1024, 1024))
        scale = 64 ** -0.5
        o, lse = fa.flash_fwd_reference(q, k, v, True, scale)
        cut = o.clone()  # rows 960.. over keys 0..959 only
        cut[:, 960:] = fa.flash_fwd_reference(
            q[:, 960:], k[:, :960], v[:, :960], False, scale)[0]
        assert flash_excess("o", cut, o) > 1, dtype
        qf = q[:, :512]
        o, lse = fa.flash_fwd_reference(qf, k, v, False, scale)
        cut = fa.flash_fwd_reference(qf, k[:, :960], v[:, :960], False,
                                     scale)[0]
        assert flash_excess("o", cut, o) > 1, dtype
        dof = do[:, :512]
        delta = (dof.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        want = fa.flash_dkv_reference(qf, k, v, dof, lse, delta, False, scale)
        got = fa.flash_dkv_reference(qf[:, :448], k, v, dof[:, :448],
                                     lse[..., :448].contiguous(),
                                     delta[..., :448].contiguous(), False,
                                     scale)
        for name, g, w in zip(("dk", "dv"), got, want):
            assert flash_excess(name, g, w) > 1, (dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_on_the_card_matches_the_oracle(cuda, causal):
    """Gradients through the kernels' autograd.Function against autograd
    through reference_attention, in f32."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    leaves = [torch.randn((2, 200, 4, 64), generator=gen, device=cuda)
              for _ in range(3)]
    do = torch.randn((2, 200, 4, 64), generator=gen, device=cuda)
    grads = []
    for fn in (fa.flash_attention, fa.reference_attention):
        xs = [x.clone().requires_grad_() for x in leaves]
        fn(*xs, causal=causal).backward(do)
        grads.append([x.grad for x in xs])
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        assert flash_excess(name, got, want) <= 1, name


@pytest.mark.cuda
def test_attention_on_the_card_raises_outside_the_kernels_geometry(cuda):
    """ops.attention has no plain branch on the card: the dispatch answers
    the kernels for every geometry, and they raise outside theirs."""
    before = fa.fwd_launches
    for dh in (48, 16):
        q = torch.zeros((1, 64, 2, dh), device=cuda)
        assert ops.attention_kernel(64, 64, dh, q.dtype,
                                    device=cuda) == "cuda-flash"
        with pytest.raises(ValueError, match="outside their geometry"):
            ops.attention(q, q, q)
    assert ops.attention_kernel(32, 64, 64, torch.float32,
                                device=cuda) == "cuda-flash"
    with pytest.raises(ValueError, match="tq == tk"):
        ops.attention(torch.zeros((1, 32, 2, 64), device=cuda),
                      *(torch.zeros((1, 64, 2, 64), device=cuda),) * 2)
    assert fa.fwd_launches == before


@pytest.mark.cuda
def test_flash_kernels_raise_outside_their_geometry(cuda):
    q = torch.zeros((1, 64, 2, 48), device=cuda)
    before = fa.fwd_launches
    with pytest.raises(ValueError, match="outside their geometry"):
        fa.flash_fwd(q, q, q, True, 48 ** -0.5)
    assert fa.fwd_launches == before


@pytest.mark.cuda
def test_rounded_head_dot_on_the_card_matches_the_upcast_product(cuda):
    """The loss head's bf16 product with f32 output (torch.mm's out_dtype
    on the card) against the same product of the upcast operands, value
    and gradients: f32 sums of exact products in another order."""
    from tf_operator_tpu_torch.train.steps import _head_logits

    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn((2, 64, 256), generator=gen, device=cuda)
    kernel = torch.randn((256, 1000), generator=gen, device=cuda) * 0.1
    g = torch.randn((2, 64, 1000), generator=gen, device=cuda)
    outs = []
    for run in (lambda a, b: _head_logits(a, b, None, torch.bfloat16),
                lambda a, b: (a.bfloat16().float() @ b.bfloat16().float())):
        a, b = h.clone().requires_grad_(), kernel.clone().requires_grad_()
        out = run(a, b)
        out.backward(g)
        outs.append((out, a.grad, b.grad))
    assert outs[0][0].dtype == torch.float32
    for got, want in zip(*outs):
        assert excess(got, want, 1e-5, 1e-5) <= 1
