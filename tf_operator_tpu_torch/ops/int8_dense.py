"""Int8 weight-only matmul (W8A16) for int8 decode (PyTorch/CUDA).

Counterpart of ``tf_operator_tpu/ops/int8_dense.py``. A projection's
weight ``[k, n]`` is stored as int8 ``w_q`` with one f32 scale per output
channel; the product is

    out[i, j] = (sum_k bf16(x[i, k]) * bf16(w_q[k, j])) * scale[j]

with f32 sums, cast to ``out_dtype``. x is rounded to bf16 whatever its
dtype, as JAX's ``x.astype(bf16)`` does, so an f32 model's int8
projections see bf16 activations too. An optional f32 ``bias`` is added
to that f32 product before the cast: JAX's ``Int8Dense`` computes
``int8_apply(x, w_q, scale, out_dtype=f32) + bias`` and then casts, and
the kernel does the same in its epilogue, one rounding for each.

- ``quantize_int8`` is the symmetric per-output-channel quantizer
  (absmax / 127, 1.0 where a column is all zero, round half to even,
  clip to +-127), bitwise JAX's.
- ``int8_matmul_reference`` is the plain PyTorch version, the formula of
  JAX's ``int8_matmul_xla``.
- ``int8_matmul`` runs the plain version for a tensor on the CPU. For a
  CUDA tensor it launches the hand-written kernel (``csrc/int8_dense.cu``,
  which says what bounds it and how it is built) or raises: there is no
  quiet fallback. The library's ``int8_design(m, k, n, x_bf16)`` says
  which of its kernels a call runs (the weight stream for m <= 8, the
  TMA + wgmma tile for bf16 x prefill, the mma.sync tile for f32 x
  prefill). ``int8_matmul_supported`` is the kernel's geometry
  rule; JAX's padding of m to 16 and its XLA branch for n or k off the
  128-lane tiling are TPU facts and do not carry over.
- ``int8_apply`` takes leading dimensions: x ``[..., k]`` -> ``[..., n]``.
- ``launches`` counts kernel launches, and nothing else;
  ``wgmma_launches`` counts those of them that ran the TMA + wgmma tile.
"""

from __future__ import annotations

import ctypes

import torch

from tf_operator_tpu_torch.ops import _build

# The kernel's geometry: whole 128-column tiles (one 16-byte int8 vector
# a thread along n) and whole 32-row k steps of the tiled product.
N_ALIGN = 128
K_ALIGN = 32
X_DTYPES = (torch.float32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the last reset (set them to 0 to reset): all of
# them, and those that ran the TMA + wgmma tile (bf16 x prefill).
launches = 0
wgmma_launches = 0
# int8_design's answer for the TMA + wgmma tile.
WGMMA = 2

_lib: ctypes.CDLL | None = None


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a 2-D ``[k, n]``
    weight: ``(w_q int8 [k, n], scale f32 [n])`` with ``w_q * scale ~= w``."""
    if w.dim() != 2:
        raise ValueError(f"quantize_int8 takes [k, n], got {tuple(w.shape)}")
    wf = w.float()
    absmax = wf.abs().amax(0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: x rounded to bf16, both operands upcast to f32
    (exact: a bf16 times an int8 fits f32's 24 bits), f32 product, times
    the per-channel scale, plus the bias, cast to ``out_dtype``."""
    acc = (x.to(torch.bfloat16).float() @ w_q.float()) * scale[None, :]
    if bias is not None:
        acc = acc + bias
    return acc.to(out_dtype)


def int8_matmul_supported(m: int, k: int, n: int, x_dtype: torch.dtype,
                          out_dtype: torch.dtype) -> bool:
    """True when the CUDA kernel takes this product: n a multiple of
    ``N_ALIGN``, k of ``K_ALIGN``, x in f32 or bf16, out f32 or bf16."""
    return (m >= 1 and k >= K_ALIGN and n >= N_ALIGN and k % K_ALIGN == 0
            and n % N_ALIGN == 0 and x_dtype in X_DTYPES
            and out_dtype in OUT_DTYPES)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x [m, k] @ dequant(w_q [k, n], scale [n]) (+ bias [n]) -> [m,
    n]``: the plain version on the CPU, the CUDA kernel on the card. Raises
    ``ValueError`` on mismatched shapes and, on the card, on a geometry
    the kernel does not take (``int8_matmul_supported``)."""
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"int8_matmul takes x [m, k] and w_q [k, n], got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    k2, n = w_q.shape
    if (k != k2 or tuple(scale.shape) != (n,)
            or bias is not None and tuple(bias.shape) != (n,)):
        raise ValueError(
            f"shape mismatch: {tuple(x.shape)} @ {tuple(w_q.shape)}, scale "
            f"{tuple(scale.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale, out_dtype, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    return _launch(x, w_q, scale, out_dtype, bias)


def int8_apply(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype = torch.float32,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """``int8_matmul`` over leading dimensions: x ``[..., k]`` ->
    ``[..., n]``."""
    lead = x.shape[:-1]
    out = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w_q, scale,
                      out_dtype, bias)
    return out.reshape(*lead, w_q.shape[1])


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("int8_dense")
        fn = lib.int8_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.int8_design.argtypes = [ctypes.c_int] * 4
        lib.int8_design.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(x, w_q, scale, out_dtype, bias) -> torch.Tensor:
    global launches, wgmma_launches
    m, k = x.shape
    n = w_q.shape[1]
    if not int8_matmul_supported(m, k, n, x.dtype, out_dtype):
        raise ValueError(
            f"int8_matmul kernel: m={m} k={k} n={n} x {x.dtype} out "
            f"{out_dtype} is outside its geometry (n % {N_ALIGN} == 0, "
            f"k % {K_ALIGN} == 0, x in {X_DTYPES}, out in {OUT_DTYPES})"
        )
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise ValueError("int8_matmul kernel: w_q is int8, scale and bias "
                         "f32")
    for t in (x, w_q, scale) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError("int8_matmul kernel: inputs on two devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8_matmul kernel: inputs must be contiguous "
                             "and 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _library()
    x_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_matmul_launch(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, k,
            n, x_bf16, int(out_dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    if lib.int8_design(m, k, n, x_bf16) == WGMMA:
        wgmma_launches += 1
    return out
