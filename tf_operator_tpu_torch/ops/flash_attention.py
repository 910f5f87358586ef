"""Flash attention, forward and backward, for the training path
(PyTorch/CUDA).

Counterpart of ``tf_operator_tpu/ops/flash_attention.py``, with its public
layout: q ``[B, tq, H, Dh]``, k and v ``[B, tk, H, Dh]``, O in q's dtype.
The softmax statistics are f32 ``[B, H, T]`` (lse, and delta =
rowsum(dO * O)).

- ``flash_attention`` is a ``torch.autograd.Function``: its forward saves
  (q, k, v, o, lse) as the JAX ``_flash_vjp_fwd`` does, its backward
  computes delta with a torch op and hands the statistics to
  ``flash_bwd_from_stats``, which a ring backward can call with global
  statistics.
- ``flash_fwd``, ``flash_dq``, ``flash_dkv`` (and
  ``flash_bwd_from_stats``, which runs the last two): on a CPU tensor
  they run the plain versions (``flash_fwd_reference``,
  ``flash_dq_reference``, ``flash_dkv_reference``), so the CPU tests go
  through the same forward and backward structure as the card. On a CUDA tensor they launch the
  hand-written kernels (``csrc/flash_attention.cu``, which says what
  bounds them and how they are built) or raise: there is no quiet
  fallback. The library's ``flash_design(is_bf16, dh, kernel)`` says which
  of the file's two designs an instance runs (bf16 B1, B2 and B3 at Dh 64
  and 128: TMA + wgmma; f32 and bf16 Dh 32: mma.sync).
- ``reference_attention`` is the plain, autograd-differentiable oracle
  (the JAX package's ``parallel/ring_attention.py::reference_attention``).
- ``flash_supported`` is the kernels' own geometry rule. The JAX module's
  block pickers and Mosaic's multiple-of-128 rule are TPU facts and do not
  carry over: the kernels mask a ragged tail themselves.
- ``fwd_launches``, ``dq_launches`` and ``dkv_launches`` count kernel
  launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from tf_operator_tpu_torch.ops import _build

_NEG_INF = -1e30

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the last reset (set them to 0 to reset).
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_lib: ctypes.CDLL | None = None


def flash_supported(tq: int, tk: int, head_dim: int, dtype: torch.dtype, *,
                    causal: bool) -> bool:
    """True when the kernels take this geometry: f32 or bf16, a head dim
    they are built for, and under ``causal`` equal query and key lengths
    (the mask aligns row 0 with column 0). Any length is tiled."""
    if tq < 1 or tk < 1 or (causal and tq != tk):
        return False
    return dtype in DTYPES and head_dim in HEAD_DIMS


def reference_attention(q, k, v, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Single-device exact attention, the correctness oracle: f32 scores,
    masked columns at -1e30, softmax, P.V on an f32 V, cast to q's
    dtype. Differentiable by autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    """[tq, tk] bool: query row i sees key columns j <= i."""
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])


def _probs(q, k, lse, causal, scale):
    """P = exp(S - lse) in f32 [B, H, tq, tk], masked entries exactly 0:
    the kernels' recomputation from the saved statistics."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device), 0.)
    return p


def _dscores(q, k, v, do, lse, delta, causal, scale):
    """(P, dS) in f32: dS = P * (dO.V^T - delta) * scale."""
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_fwd_reference(q, k, v, causal: bool, scale: float):
    """Plain version of the forward kernel -> (o, lse): f32 scores, the
    row max m, P = exp(S - m) cast to v's dtype for P.V, the f32 row sum
    l, o = P.V / l in q's dtype and lse = m + log(max(l, 1e-30))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # [B, H, tq, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of the dQ kernel: dQ = dS.K with dS cast to k's
    dtype, f32 sums, in q's dtype."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                        scale: float):
    """Plain version of the dK/dV kernel -> (dk, dv): dV = P^T.dO with P
    cast to dO's dtype, dK = dS^T.Q with dS cast to q's dtype, f32 sums."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd(q, k, v, causal: bool, scale: float):
    """(o, lse): the plain version for a CPU tensor, the forward kernel
    for a CUDA tensor."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale)
    _require_cuda(q)
    return _launch_fwd(q, k, v, causal, scale)


def _check_bwd(q, k, v, do, lse, delta, causal):
    _check_shapes(q, k, v, causal)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    stats = (q.shape[0], q.shape[2], q.shape[1])
    if tuple(lse.shape) != stats or tuple(delta.shape) != stats:
        raise ValueError(f"lse/delta must be [B, H, tq] = {stats}")


def flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ from the statistics: the plain version for a CPU tensor, the dQ
    kernel for a CUDA tensor."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    _require_cuda(q)
    return _launch_dq(q, k, v, do, lse, delta, causal, scale)


def flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dK, dV) from the statistics: the plain version for a CPU tensor,
    the dK/dV kernel for a CUDA tensor."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    _require_cuda(q)
    return _launch_dkv(q, k, v, do, lse, delta, causal, scale)


def flash_bwd_from_stats(q, k, v, do, lse, delta, causal: bool,
                         scale: float):
    """(dq, dk, dv) from the softmax statistics lse and delta, f32
    ``[B, H, tq]``. They may be global (a ring backward's merged lse and
    delta): P = exp(S - lse) is then each block's share of the global
    softmax. ``flash_dq`` and ``flash_dkv``: the plain versions for a CPU
    tensor, the kernels for a CUDA tensor."""
    return (flash_dq(q, k, v, do, lse, delta, causal, scale),) + flash_dkv(
        q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O) in f32, outside the kernels as in JAX.
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_bwd_from_stats(q, k, v, do, lse, delta,
                                          ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention over ``[B, T, H, Dh]``; differentiable. Raises
    ``ValueError`` on shapes attention does not define and, on the card,
    on a geometry the kernels do not take (``flash_supported``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [B, T, H, Dh]")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                k.shape[3]):
        raise ValueError("q and k/v differ in batch, heads or head dim")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash attention requires tq == tk")


def _require_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        tail = [i32] * 5 + [strides, ctypes.c_float, i32, i32, ptr]
        lib.flash_fwd_launch.argtypes = [ptr] * 5 + tail
        lib.flash_dq_launch.argtypes = [ptr] * 7 + tail
        lib.flash_dkv_launch.argtypes = [ptr] * 8 + tail
        for fn in (lib.flash_fwd_launch, lib.flash_dq_launch,
                   lib.flash_dkv_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kernel_args(causal, *inputs):
    """Validate the inputs of a launch and return the (batch, time, head)
    strides of each, in elements, as a C array."""
    q = inputs[0]
    b, tq, h, dh = q.shape
    tk = inputs[1].shape[1]
    if not flash_supported(tq, tk, dh, q.dtype, causal=causal):
        raise ValueError(
            f"flash kernels: tq={tq} tk={tk} Dh={dh} {q.dtype} causal="
            f"{causal} is outside their geometry (dtype in {DTYPES}, Dh in "
            f"{HEAD_DIMS}, causal needs tq == tk)"
        )
    per = 16 // q.element_size()  # elements in 16 bytes
    strides = []
    for x in inputs:
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash kernels: inputs need one dtype and device")
        if (x.stride(3) != 1 or x.data_ptr() % 16
                or any(s % per for s in x.stride()[:3])):
            raise ValueError(
                "flash kernels: Dh must be contiguous and every pointer and "
                "stride 16-byte aligned"
            )
        strides += x.stride()[:3]
    return (ctypes.c_longlong * len(strides))(*strides)


def _check_stats(q, *stats):
    for x in stats:
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError("flash kernels: lse/delta are contiguous f32 "
                             "on q's device")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(q, k, v, causal, scale):
    global fwd_launches
    strides = _kernel_args(causal, q, k, v)
    b, tq, h, dh = q.shape
    o = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, tq, k.shape[1], dh, strides, scale,
            int(causal), int(q.dtype == torch.bfloat16), _stream(q))
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    fwd_launches += 1
    return o, lse


def _launch_dq(q, k, v, do, lse, delta, causal, scale):
    global dq_launches
    strides = _kernel_args(causal, q, k, v, do)
    _check_stats(q, lse, delta)
    b, tq, h, dh = q.shape
    dq = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, tq,
            k.shape[1], dh, strides, scale, int(causal),
            int(q.dtype == torch.bfloat16), _stream(q))
    if err:
        raise RuntimeError(f"flash_dq kernel launch failed: CUDA error {err}")
    dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, scale):
    global dkv_launches
    strides = _kernel_args(causal, q, k, v, do)
    _check_stats(q, lse, delta)
    b, tq, h, dh = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        err = _library().flash_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, tq, k.shape[1], dh, strides, scale, int(causal),
            int(q.dtype == torch.bfloat16), _stream(q))
    if err:
        raise RuntimeError(
            f"flash_dkv kernel launch failed: CUDA error {err}")
    dkv_launches += 1
    return dk, dv
