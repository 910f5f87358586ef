"""Ulysses sequence parallelism: an all-to-all head/sequence exchange.

Counterpart of ``tf_operator_tpu/parallel/ulysses.py``, in the ``[B, T,
H, Dh]`` layout, one process a device. The second long-context strategy
beside ring attention (``TransformerConfig.ring_impl="ulysses"``):

- this rank's blocks arrive sequence-split, ``[B, T/sp, H, Dh]``, as ring
  attention takes them;
- an all-to-all over the ``sp`` group splits the heads instead: ``[B, T,
  H/sp, Dh]``, every rank holding the whole sequence of its head group
  (member j's heads ``j * H/sp`` onwards);
- ``ops.attention`` runs causally over the whole sequence, through the
  dispatch (``attention_kernel``, and so ``TPU_OPERATOR_ATTN``) as JAX's
  does, or by ``use_flash``: the kernels B1-B3 on the card, their plain
  versions on the CPU, ``reference_attention`` where the rule or the
  switch says;
- the inverse all-to-all restores the sequence split.

Both exchanges are ``torch.autograd.Function``s whose backward is the
other exchange, built from the point-to-point pairs of the axis'
``exchange`` (``parallel/sharding.py``; every rank receives from
and sends to every other member; no rank gathers more than its part).

Requires that this rank's heads (``H / tp`` under a tensor split) divide
by ``sp``; a sequence that ``sp`` does not divide is refused where the
batch is cut into blocks (``parallel/sharding.py`` ``token_block``).
"""

from __future__ import annotations

import torch


def _all_to_all(axis, x: torch.Tensor, split: int, concat: int
                ) -> torch.Tensor:
    """``x`` cut into ``sp`` parts on ``split``, part j to member j, and
    the parts received concatenated on ``concat`` in member order."""
    n, me = axis.size, axis.index
    parts = x.chunk(n, dim=split)
    got = axis.exchange({j: parts[j] for j in range(n) if j != me},
                        {j: parts[me].shape for j in range(n) if j != me})
    got[me] = parts[me]
    return torch.cat([got[j] for j in range(n)], dim=concat)


class _Exchange(torch.autograd.Function):
    """The all-to-all forward; the inverse one (split and concat swapped)
    backward."""

    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _all_to_all(axis, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(ctx.axis, g.contiguous(), ctx.concat, ctx.split),
                None, None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis, *, causal: bool = True,
                      scale: float | None = None,
                      use_flash: bool | None = None) -> torch.Tensor:
    """Exact attention of this rank's sequence block ``[B, T/sp, H, Dh]``
    (every rank's, over the ``axis`` group) by the head/sequence
    all-to-all; differentiable. ``H`` is this rank's heads. ``use_flash``
    is ``ops.attention``'s (None: the dispatch)."""
    from tf_operator_tpu_torch.ops import attention

    sp, h = axis.size, q.shape[2]
    if h % sp:
        raise ValueError(
            f"local heads {h} not divisible by {axis.axis}={sp} "
            "— use ring attention for sp beyond the head count")
    # [B, T/sp, H, Dh] -> [B, T, H/sp, Dh]: split heads, concat sequence.
    qf, kf, vf = (_Exchange.apply(x, axis, 2, 1) for x in (q, k, v))
    out = attention(qf, kf, vf, causal=causal, scale=scale,
                    use_flash=use_flash)
    # [B, T, H/sp, Dh] -> [B, T/sp, H, Dh]: the inverse exchange.
    return _Exchange.apply(out, axis, 1, 2)
