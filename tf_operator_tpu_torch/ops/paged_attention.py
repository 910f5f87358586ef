"""Paged decode attention straight off the block table (PyTorch/CUDA).

Counterpart of ``tf_operator_tpu/ops/paged_attention.py``, with its
signature and layout: q ``[b, t, H, Dh]``, pools ``[nb, blk, KV, Dh]``,
block table ``[b, table_len]`` int32 and ``index`` ``[b]`` int32
pre-update counters (query row i of lane b sits at absolute position
``index[b] + i``). The result is f32 ``[b, t, H, Dh]``; the caller
applies the storage-dtype cast, as the gather path does. Under kv_int8
the pools are int8 and ``k_scale_pool``/``v_scale_pool`` (both or
neither) hold their f32 ``[nb, blk, KV]`` per-(token, head) scales: the
scores are the raw int8 keys' times the key scale, then times Dh^-1/2,
and the value scale multiplies the probabilities before P.V.

- ``paged_attend_reference`` is the plain PyTorch version: the gather
  oracle of ``_decode_attend_paged`` (gather the pool back to the dense
  ``[b, S, KV, Dh]`` layout, f32 scores, ``-1e30`` mask, softmax, P.V).
  The model's ``kv_attend="gather"`` mode runs it.
- ``paged_attend`` runs the plain version for a tensor on the CPU. For a
  CUDA tensor it launches the hand-written kernel
  (``csrc/paged_attention.cu``, which says what bounds it and how it is
  built) or raises: there is no quiet fallback.
- ``paged_attend_supported`` is the kernel's own geometry rule. The JAX
  module's 12 MiB VMEM gate is a TPU fact and does not carry over.
- ``launches`` counts launches of the bf16/f32 kernel and
  ``kv8_launches`` those of its kv8 variant, and nothing else. A call is
  one kernel launch: a thread-block cluster of ``SPLITS`` CTAs per lane
  and KV head walks the lane's blocks and merges in the same launch.
- ``split_walk`` mirrors the kernel's split rule: which blocks each CTA
  of a cluster walks.
"""

from __future__ import annotations

import ctypes

import torch

from tf_operator_tpu_torch.ops import _build

_NEG_INF = -1e30

# The kernel's geometry: one template instance per head dim, and the
# t * g query rows of one KV head held in one CTA.
HEAD_DIMS = (16, 32, 64, 128)
MAX_ROWS = 32
DTYPES = (torch.float32, torch.bfloat16)
# The cluster size S: the CTAs that split one lane's block walk for one KV
# head and merge their partials through distributed shared memory. The
# kernel takes 1 to 16 (above 8 a non-portable cluster size); 16 measured
# faster than 8 at the slice's shapes (PERF.md).
SPLITS = 16

# Kernel launches since the last reset (set them to 0 to reset): the
# bf16/f32 pools' kernel, and its kv8 variant.
launches = 0
kv8_launches = 0

_lib: ctypes.CDLL | None = None


def paged_attend_supported(t: int, n_heads: int, kv_heads: int,
                           head_dim: int, dtype: torch.dtype) -> bool:
    """True when the CUDA kernel takes this geometry: q in f32 or bf16
    (``dtype``), a head dim it is built for, and at most ``MAX_ROWS`` query
    rows (t times the group size) per KV head. The kv8 variant takes the
    same geometry, with q's dtype as ``dtype``; the pools' dtype (q's, or
    int8 beside the scale pools) is checked at launch."""
    if t < 1 or kv_heads < 1 or n_heads % kv_heads:
        return False
    return (dtype in DTYPES and head_dim in HEAD_DIMS
            and t * (n_heads // kv_heads) <= MAX_ROWS)


def split_walk(nblk: int, splits: int = SPLITS) -> list[list[int]]:
    """The blocks each CTA of a lane's cluster walks, in its order, for a
    lane that owns ``nblk`` blocks (``ceil((index + t) / blk)``, at most
    the table's length): split ``s`` takes ``s, s + splits, ...`` below
    ``nblk``, so block 0 falls to split 0 and the longest lane keeps every
    split busy. The kernel computes the same on the card from the lane's
    counter."""
    return [list(range(s, nblk, splits)) for s in range(splits)]


def paged_attend_reference(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           index: torch.Tensor, *,
                           k_scale_pool: torch.Tensor | None = None,
                           v_scale_pool: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The gather oracle: ``pool[table]`` back to ``[b, S, KV, Dh]``, the
    grouped einsums in f32 (an upcast of bf16 or int8 operands is exact,
    so this is JAX's bf16 dot with f32 accumulation), scale before the
    mask, masked columns at -1e30, softmax over the full S; under kv8 the
    key scale on the scores before Dh^-1/2 and the value scale on the
    probabilities."""
    kv8 = _kv8(k_scale_pool, v_scale_pool)
    b, t, h, dh = q.shape
    _, blk, kv, _ = pool_k.shape
    g = h // kv
    s_len = block_table.shape[1] * blk
    table = block_table.long()

    def rows(pool):
        return pool[table].reshape(b, s_len, *pool.shape[2:]).float()

    def cols(scale_pool):  # [b, S, KV] -> the scores' [b, KV, 1, 1, S]
        return rows(scale_pool).transpose(1, 2)[:, :, None, None, :]

    keys, vals = rows(pool_k), rows(pool_v)
    qg = q.reshape(b, t, kv, g, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, keys)
    if kv8:
        s = s * cols(k_scale_pool)
    s = s * dh ** -0.5
    pos = (index.long()[:, None]
           + torch.arange(t, device=q.device)[None, :])  # [b, t]
    valid = (torch.arange(s_len, device=q.device)[None, None, :]
             <= pos[:, :, None])  # [b, t, S]
    s = torch.where(valid[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if kv8:
        p = p * cols(v_scale_pool)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vals)
    return out.reshape(b, t, h, dh)


def paged_attend(q: torch.Tensor, pool_k: torch.Tensor,
                 pool_v: torch.Tensor, block_table: torch.Tensor,
                 index: torch.Tensor, *,
                 k_scale_pool: torch.Tensor | None = None,
                 v_scale_pool: torch.Tensor | None = None) -> torch.Tensor:
    """Paged decode attention: the plain version on the CPU, the CUDA
    kernel on the card (its kv8 variant when the scale pools are given).
    Raises ``ValueError`` on shapes the attention does not define and,
    on the card, on a geometry the kernel does not take
    (``paged_attend_supported``)."""
    t, h = q.shape[1], q.shape[2]
    kv = pool_k.shape[2]
    _kv8(k_scale_pool, v_scale_pool)
    if t < 1:
        raise ValueError(f"t={t}: need at least one query row per lane")
    if h % kv:
        raise ValueError(f"n_heads={h} must be a multiple of KV={kv}")
    if q.device.type == "cpu":
        return paged_attend_reference(q, pool_k, pool_v, block_table, index,
                                      k_scale_pool=k_scale_pool,
                                      v_scale_pool=v_scale_pool)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attend: no kernel for device {q.device}")
    return _launch(q, pool_k, pool_v, block_table, index, k_scale_pool,
                   v_scale_pool)


def _kv8(k_scale_pool, v_scale_pool) -> bool:
    """Whether the call is kv8; raises when only one scale pool is given."""
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("kv8 needs both scale pools (or neither)")
    return k_scale_pool is not None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.paged_attend_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.paged_attend_kv8_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q, pool_k, pool_v, table, index, k_scale_pool=None,
            v_scale_pool=None) -> torch.Tensor:
    global launches, kv8_launches
    b, t, h, dh = q.shape
    nb, blk, kv, _ = pool_k.shape
    kv8 = k_scale_pool is not None
    if not paged_attend_supported(t, h, kv, dh, q.dtype):
        raise ValueError(
            f"paged_attend kernel: t={t} H={h} KV={kv} Dh={dh} "
            f"{q.dtype} is outside its geometry (dtype in {DTYPES}, Dh in "
            f"{HEAD_DIMS}, t*H/KV <= {MAX_ROWS})"
        )
    pool_dtype = torch.int8 if kv8 else q.dtype
    if pool_k.dtype != pool_dtype or pool_v.dtype != pool_dtype:
        raise ValueError(
            "paged_attend kernel: the pools must be int8 with scale pools "
            "(kv8), else in q's dtype")
    if pool_v.shape != pool_k.shape:
        raise ValueError("paged_attend kernel: key and value pools differ")
    scales = (k_scale_pool, v_scale_pool) if kv8 else ()
    for sp in scales:
        if sp.dtype != torch.float32 or sp.shape != (nb, blk, kv):
            raise ValueError("paged_attend kernel: scale pools are f32 "
                             "[nb, blk, KV]")
    if table.dtype != torch.int32 or index.dtype != torch.int32:
        raise ValueError("paged_attend kernel: table and index are int32")
    if table.shape[0] != b or index.shape != (b,):
        raise ValueError("paged_attend kernel: table/index lanes != q lanes")
    args = (q, pool_k, pool_v, *scales, table, index)
    for x in args:
        if x.device != q.device:
            raise ValueError("paged_attend kernel: inputs on two devices")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                "paged_attend kernel: inputs must be contiguous and "
                "16-byte aligned"
            )
    out = torch.empty((b, t, h, dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _library()
        entry = lib.paged_attend_kv8_launch if kv8 else lib.paged_attend_launch
        err = entry(
            *(x.data_ptr() for x in args), out.data_ptr(),
            b, t, h // kv, kv, dh, blk, table.shape[1], SPLITS,
            int(q.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(
            f"paged_attend kernel launch failed: CUDA error {err}"
        )
    if kv8:
        kv8_launches += 1
    else:
        launches += 1
    return out
