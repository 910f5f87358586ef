"""How a kernel's output is held against its plain version: the rule
``chip_smoke.py`` and ``tests/test_torch_kernels.py`` share.

Each element is compared: ``|got - want| <= rtol |want| + atol s``,
where ``s`` is the rms of the element's row of ``want`` (its last axis),
but no less than a tenth of the whole tensor's rms. The ``rtol`` term
holds an element to its own size; the ``atol`` term holds it to its
row's scale, which is the scale of the rounding in sums that cancel.
Rows differ in scale by far: under the causal mask row i averages i
keys, so |O| ~ 1/sqrt(i), and a scale taken over the whole tensor would
be loose for the late rows and tight for the early ones. The floor
covers rows whose exact value is 0 (dQ of query 0 under the causal mask)
and so hold only rounding noise. ``excess`` returns the largest ratio of
an element's error to its bound: the check passes at <= 1.

Flash attention (``FLASH_TOL``): f32 sums the same products in another
order (relative error ~1e-6), but dQ of query 0 under the causal mask is
0 in exact arithmetic, the difference of two f32 sums of size ~8 (dO.V
and delta): ~1e-6 of noise against the floor of its row's scale, atol
1e-3. bf16 rounds P and dS to bf16 before their products, and the
kernels scale P by a running max where the plain versions use the final
one, so the two round different values: against the plain versions run
in f32 on the same inputs, each side errs by up to ~2.3e-2 of the row's
rms (rms ~2.4e-3) at B=2, H=16, T=8192, as chip_smoke.py prints, in
opposite directions as often as not: atol 3e-2. Each output then rounds
to bf16 once more, so the two may land two bf16 steps apart, at most 2 x
2^-7 = 1.6e-2 of an element's size: rtol 2e-2. lse is f32 in both dtypes
and held to ``LSE_ATOL`` absolute.

Int8 matmul (``INT8_TOL``, by the output's dtype): kernel and plain
version multiply the same bf16 activations by the same int8 weights,
products exact in f32, and differ only in the order of the f32 sums over
k (up to 4096 terms): ~1e-6 of the row's scale, atol 1e-4, rtol 1e-5. A
bf16 output rounds those sums once on each side, so two sums that
straddle a rounding boundary land one bf16 step apart, at most 2^-7 of
the element: rtol 2^-7.
"""

from __future__ import annotations

import torch

# (rtol, atol as a share of the row's rms) by dtype.
FLASH_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 3e-2)}
LSE_ATOL = 1e-4
INT8_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}


def _errors(got: torch.Tensor, want: torch.Tensor):
    """(|got - want|, want) in f32, after the shape, dtype and finiteness
    checks that raise ``AssertionError``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"got {got.dtype} {tuple(got.shape)}, want "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite output")
    want = want.float()
    return (got.float() - want).abs(), want


def row_scale(want: torch.Tensor) -> torch.Tensor:
    """The rms of each row (last axis) of ``want`` in f32, floored at a
    tenth of the tensor's rms; shape ``[..., 1]``."""
    sq = want.float().square()
    floor = 0.1 * sq.mean().sqrt()
    return sq.mean(-1, keepdim=True).sqrt().clamp_min(floor)


def excess(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> float:
    """max over elements of ``|got - want| / (rtol |want| + atol s)``,
    ``s`` the ``row_scale`` of ``want``."""
    err, want = _errors(got, want)
    bound = rtol * want.abs() + atol * row_scale(want)
    if not (bound > 0).all():  # want is all zeros: only zeros pass
        return float("inf") if err.any() else 0.0
    return (err / bound).max().item()


def flash_excess(out: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``excess`` of one flash output (``o``, ``lse``, ``dq``, ``dk`` or
    ``dv``) at its dtype's tolerance; lse's largest error over
    ``LSE_ATOL``."""
    if out == "lse":
        return (_errors(got, want)[0].max() / LSE_ATOL).item()
    return excess(got, want, *FLASH_TOL[want.dtype])
