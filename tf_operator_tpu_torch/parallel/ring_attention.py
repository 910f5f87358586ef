"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of ``tf_operator_tpu/parallel/ring_attention.py``, in the
``[B, T, H, Dh]`` layout, one process a device. The sequence is split over
a mesh's ``sp`` axis: each rank holds one block of Q, K and V (its own
``T / sp`` positions, ``sp_index * T / sp`` onwards), and the K/V blocks
rotate around the ring of the ``sp`` group while a streaming softmax
folds them in. Where JAX wraps a per-device body in ``shard_map``, the
port's functions take this rank's blocks and the ``sp`` axis as the rank
sees it (``axis``: a ``parallel/sharding.py`` ``TensorParallel`` over
``"sp"``, whose members are the ranks that share this rank's ``dp`` and
``tp`` coordinates). Two implementations share the contract:

- ``ring_attention`` (JAX's ``stream``): the streaming softmax over the
  rotating blocks, with global-position causal masking and ``kv_chunk``
  to bound the score tile; its gradient comes from autograd through the
  ring (``_RingShift``, whose backward sends the gradient the other way).
- ``ring_flash_attention``: a ``torch.autograd.Function``. The forward
  runs each block pair through ``ops/flash_attention.py``'s ``flash_fwd``
  and merges the results by ``logaddexp`` (JAX's ``_merge_block``); under
  causal masking a ring step is the diagonal block (causal), a past block
  (full) or a future block (skipped: nothing is launched). The backward
  is a second ring: delta = rowsum(dO * O) of the merged output, each
  block's dQ, dK and dV from ``flash_bwd_from_stats`` on the GLOBAL lse
  and delta, and f32 dK/dV accumulators that travel with their blocks and
  arrive home after a full rotation. On a CPU tensor the block functions
  run their plain versions; on a CUDA tensor the kernels B1-B3. A block's
  results are cast to f32 before they are merged, as in JAX.

The transport (``ring_shift``): each rank sends to the next member of the
ring, ``(i + 1) % sp``, and receives from the one before, posting the
receive first, so no rank waits on a peer that waits on it. Under gloo a
tensor on the card travels through a host copy, in the open: it is
counted in ``parallel.sharding.staged_bytes``. The point-to-point
transport is the axis' ``exchange`` (``parallel/sharding.py``), which
``parallel/ulysses.py``'s all-to-all uses too.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # a finite "masked" score: keeps the streaming max finite


def ring_shift(axis, x: torch.Tensor, step: int = 1) -> torch.Tensor:
    """``x`` sent ``step`` places along the ring (+1: to the next member)
    and what the member ``step`` places before sent in its place."""
    n, i = axis.size, axis.index
    return axis.exchange({(i + step) % n: x}, {(i - step) % n: x.shape}
                         )[(i - step) % n]


class _RingShift(torch.autograd.Function):
    """``ring_shift`` by +1 forward; the gradient shifted by -1 back."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return ring_shift(axis, x, 1)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(ctx.axis, g, -1), None


def _kv_shift(axis, k, v):
    """The next K/V block of the ring, K and V in one message."""
    kv = _RingShift.apply(torch.stack((k, v)), axis)
    return kv[0], kv[1]


def _fold(q, k, v, q_pos, k_pos, o, m, l, scale, causal):
    """Fold one K/V block into the streaming-softmax accumulators (JAX's
    ``_accumulate_block``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o * alpha.transpose(1, 2)[..., None] + pv, m_new, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                   *, causal: bool = True, scale: float | None = None,
                   kv_chunk: int | None = None) -> torch.Tensor:
    """Exact attention of this rank's Q block ``[B, tq, H, Dh]`` over every
    rank's K/V block ``[B, tk, H, Dh]`` of the ``axis`` ring (JAX's
    ``ring_attention``, the ``stream`` implementation); differentiable.
    ``kv_chunk`` (must divide the K/V block) folds each held block in
    chunks of that many keys, bounding the score tile to ``tq * kv_chunk``.
    Under ``causal`` a query at global position ``i * tq + r`` sees keys at
    global positions up to it. Every block is folded, a future one wholly
    masked, as JAX folds it: each rank's autograd graph then holds every
    shift, so every rank takes part in each backward exchange."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if kv_chunk is not None and (kv_chunk <= 0 or tk % kv_chunk):
        raise ValueError(f"kv_chunk {kv_chunk} must divide the kv block {tk}")
    if scale is None:
        scale = d ** -0.5
    n, me = axis.size, axis.index
    chunk = kv_chunk or tk
    o = q.new_zeros((b, tq, h, d), dtype=torch.float32)
    m = q.new_full((b, h, tq), _NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, tq), dtype=torch.float32)
    q_pos = me * tq + torch.arange(tq, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        # Blocks rotate forward: at step i this rank holds block me - i.
        kv_idx = (me - i) % n
        for c0 in range(0, tk, chunk):
            k_pos = kv_idx * tk + c0 + torch.arange(chunk, device=q.device)
            o, m, l = _fold(q, k_cur[:, c0:c0 + chunk],
                            v_cur[:, c0:c0 + chunk], q_pos, k_pos, o, m, l,
                            scale, causal)
        if i < n - 1:
            k_cur, v_cur = _kv_shift(axis, k_cur, v_cur)
    l = l.clamp_min(1e-30)  # a row with every key masked
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _merge(o, lse, o_blk, lse_blk):
    """Fold one block's (o, lse) into the global accumulators (JAX's
    ``_merge_block``)."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None]
    return o * w_old + o_blk * w_blk, lse_new


def _mode(causal: bool, kv_idx: int, me: int) -> str | None:
    """The block pair's mode: "diag" (causal), "past" or "full" (no
    mask), or None for a future block (skipped)."""
    if not causal:
        return "full"
    if kv_idx == me:
        return "diag"
    return "past" if kv_idx < me else None


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        from tf_operator_tpu_torch.ops.flash_attention import flash_fwd

        n, me = axis.size, axis.index
        b, tq, h, d = q.shape
        o = q.new_zeros((b, tq, h, d), dtype=torch.float32)
        lse = q.new_full((b, h, tq), _NEG_INF, dtype=torch.float32)
        k_cur, v_cur = k, v
        for i in range(n):
            mode = _mode(causal, (me - i) % n, me)
            if mode is not None:
                o_blk, lse_blk = flash_fwd(q, k_cur, v_cur, mode == "diag",
                                           scale)
                o, lse = _merge(o, lse, o_blk.float(), lse_blk)
            if i < n - 1:
                kv = ring_shift(axis, torch.stack((k_cur, v_cur)))
                k_cur, v_cur = kv[0], kv[1]
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        from tf_operator_tpu_torch.ops.flash_attention import (
            flash_bwd_from_stats,
        )

        q, k, v, out, lse = ctx.saved_tensors
        axis, causal, scale = ctx.axis, ctx.causal, ctx.scale
        n, me = axis.size, axis.index
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2
                                                              ).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # dK/dV of the block held, travelling with it: after a full
        # rotation each block's accumulators are back on its home rank.
        dkv = torch.zeros((2, *k.shape), dtype=torch.float32,
                          device=k.device)
        kv = torch.stack((k, v))
        for i in range(n):
            mode = _mode(causal, (me - i) % n, me)
            if mode is not None:
                dq_b, dk_b, dv_b = flash_bwd_from_stats(
                    q, kv[0], kv[1], do, lse, delta, mode == "diag", scale)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            if i < n - 1:
                kv = ring_shift(axis, kv)
            dkv = ring_shift(axis, dkv)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis, *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Ring attention with a second-ring backward and flash blocks (JAX's
    ``ring_flash_attention``); the same contract as ``ring_attention``
    without ``kv_chunk``. Causal blocks must be equal: a causal call with
    ``tq != tk`` raises (``ring_attention`` masks by global position)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal ring_flash_attention requires equal q/kv seq lengths "
            f"(got {q.shape[1]}, {k.shape[1]}); use ring_attention")
    return _RingFlash.apply(q, k, v, axis, bool(causal), float(scale))
