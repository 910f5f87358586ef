"""The port's kernels and the attention dispatch.

Counterpart of ``tf_operator_tpu/ops/__init__.py``. ``attention_kernel``
is the single source of truth for which attention runs, and
``attention()`` consults it:

- on a CUDA device, the flash kernels B1-B3 (``"cuda-flash"``) for every
  geometry: the kernels take the shapes or the call raises (a head dim
  other than 32, 64 or 128, a dtype other than f32 or bf16, causal
  attention over unequal lengths), with no quiet move to the plain path.
  JAX's compiled block rule (Mosaic's multiple-of-128 tiling) is a TPU
  fact and does not carry over: the kernels mask a ragged tail
  themselves, so they take any length;
- on the CPU, the kernels' plain versions (``"flash-plain"``: the same
  autograd structure) where ``flash_supported`` says the kernels take the
  shapes, ``reference_attention`` (``"reference"``, the counterpart of
  JAX's ``"xla"``) elsewhere.

``TPU_OPERATOR_ATTN`` is JAX's A/B switch, read the same way (stripped,
lowercased): ``xla`` forces ``reference_attention`` on every device,
``flash`` (or unset) keeps the rule above, and any other value raises
JAX's ``ValueError``, so that a typo never measures the path an A/B run
meant to exclude. The switch at ``xla`` and ``attention(use_flash=False)``
are the only ways to the plain path on the card.
"""

from __future__ import annotations

import os

import torch

# The module, not its function of the same name, so that
# ``tf_operator_tpu_torch.ops.flash_attention`` stays the module.
from tf_operator_tpu_torch.ops import flash_attention as _flash
from tf_operator_tpu_torch.ops.flash_attention import flash_supported
from tf_operator_tpu_torch.ops.paged_attention import (
    paged_attend,
    paged_attend_supported,
)

# attention_kernel's answers.
KERNEL, PLAIN, REFERENCE = "cuda-flash", "flash-plain", "reference"


def attention_kernel(tq: int, tk: int, head_dim: int, dtype: torch.dtype,
                     *, causal: bool = True, device) -> str:
    """Which attention ``attention()`` runs for these shapes on
    ``device``: ``"cuda-flash"`` (the kernels), ``"flash-plain"`` (their
    plain versions, on the CPU) or ``"reference"``
    (``reference_attention``). ``TPU_OPERATOR_ATTN`` overrides: ``xla``
    always answers ``"reference"``; ``flash`` keeps the rule, which on the
    card answers the kernels for every geometry (``attention()`` then
    raises where they do not take it)."""
    forced = os.environ.get("TPU_OPERATOR_ATTN", "").strip().lower()
    if forced and forced not in ("xla", "flash"):
        # A typo must not silently measure the kernel an A/B run meant to
        # exclude.
        raise ValueError(
            f"TPU_OPERATOR_ATTN={forced!r}: expected 'xla' or 'flash'")
    if forced == "xla":
        return REFERENCE
    return _legal(tq, tk, head_dim, dtype, causal, device)


def _legal(tq, tk, head_dim, dtype, causal, device) -> str:
    """The kernels on the card (which raise outside their geometry); on
    the CPU their plain versions where the kernels would take the shapes,
    else ``"reference"``."""
    if torch.device(device).type == "cuda":
        return KERNEL
    if flash_supported(tq, tk, head_dim, dtype, causal=causal):
        return PLAIN
    return REFERENCE


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: float | None = None,
              use_flash: bool | None = None) -> torch.Tensor:
    """Single-device attention over ``[B, T, H, Dh]``: ``use_flash`` None
    dispatches by ``attention_kernel`` (and so by the switch); True runs
    the kernels (on the CPU their plain versions where the kernels would
    take the shapes, ``reference_attention`` elsewhere) whatever the
    switch; False runs ``reference_attention``."""
    shape = (q.shape[1], k.shape[1], q.shape[-1], q.dtype)
    if use_flash is None:
        choice = attention_kernel(*shape, causal=causal, device=q.device)
    elif use_flash:
        choice = _legal(*shape, causal, q.device)
    else:
        choice = REFERENCE
    if choice == REFERENCE:
        return _flash.reference_attention(q, k, v, causal=causal,
                                          scale=scale)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


# JAX's __all__ names that the port has. Its ``flash_attention`` is the
# function of the module of that name, here ``_flash.flash_attention``;
# ``on_tpu_backend``, ``paged_attend_vmem_bytes``, ``pick_block`` and
# ``select_block`` are TPU facts.
__all__ = [
    "attention",
    "attention_kernel",
    "flash_supported",
    "paged_attend",
    "paged_attend_supported",
]
