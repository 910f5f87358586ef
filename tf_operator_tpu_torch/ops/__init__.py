"""The port's kernels and the attention dispatch.

Counterpart of ``tf_operator_tpu/ops/__init__.py``. ``attention()`` runs
``flash_attention`` on every CUDA tensor: the kernels take the geometry
or the call raises, with no plain version on the card. On a CPU tensor it
runs ``flash_attention`` (the kernels' plain versions, through the same
autograd structure) where ``flash_supported`` says the kernels take the
shapes, and ``reference_attention`` elsewhere, as the JAX dispatch does.
The JAX package's ``TPU_OPERATOR_ATTN`` switch is not ported.
"""

from __future__ import annotations

import torch

# The module, not its function of the same name, so that
# ``tf_operator_tpu_torch.ops.flash_attention`` stays the module.
from tf_operator_tpu_torch.ops import flash_attention as _flash


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Single-device attention over ``[B, T, H, Dh]``: the flash kernels on
    the card (raising outside their geometry); on the CPU their plain
    versions where the kernels would take the shapes,
    ``reference_attention`` elsewhere."""
    if q.device.type == "cuda" or _flash.flash_supported(
            q.shape[1], k.shape[1], q.shape[-1], q.dtype, causal=causal):
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
    return _flash.reference_attention(q, k, v, causal=causal, scale=scale)


__all__ = ["attention"]
