"""Speculative decoding in PyTorch: a draft model proposes, the target
verifies k + 1 positions in one forward.

Counterpart of ``tf_operator_tpu/models/spec_decode.py``. A small DRAFT
model proposes k tokens autoregressively; the TARGET scores them in ONE
chunked forward over its KV cache (the block-causal multi-token path
prefill uses), accepts a prefix, and adds one token of its own. Both
modes keep the target's output:

- greedy (temperature 0): accept while a proposal equals the target's
  argmax; the tokens equal ``generate``'s on the target;
- sampled: accept d ~ q with probability min(1, p(d)/q(d)), resample a
  rejection from the residual max(p - q, 0)/Z
  (``residual_distribution``), so every emitted token follows the
  target's tempered (and nucleus-filtered) softmax, for any draft.

Rejected positions are undone by rewriting the cache counter
(``set_cache_index``): attention masks every row at or past it, so stale
K/V rows are invisible until a later write overwrites them. A batch
advances by the batch-minimum accepted count; each row still emits its
own outcome at the cut, so every row is exact.

The draws follow JAX's: ``speculative_generate`` splits its key per round
as ``rng, k_draft, k_acc, k_res, k_bonus = split(rng, 5)`` and draws at
JAX's shapes, so a sampled run gives JAX's tokens for the same key.
``lane_accept_emit`` is the continuous engine's accept/emit over all its
lanes at once (``serve/engine.py``): each lane's draws reproduce the b = 1
solo shapes, so a lane's stream is the solo stream of its seed.

Where JAX compiles a ``while_loop``, the port runs an eager loop: one
host read a round (the accepted count), nothing to compile.
"""

from __future__ import annotations

from typing import Any

import torch

from tf_operator_tpu_torch.models.transformer import (
    TransformerConfig,
    _decode_model,
    _nucleus_filter,
    _prefill,
    set_cache_index,
)
from tf_operator_tpu_torch.random import categorical, gumbel, split, uniform

__all__ = [
    "lane_accept_emit",
    "residual_distribution",
    "set_cache_index",
    "spec_margin",
    "speculative_generate",
]

_NEG_MASK = -1e30
# The accept uniforms' floor and the residual's offset, as JAX has them.
_TINY = 1e-38


def spec_margin(k: int) -> int:
    """Cache rows one speculative lane may touch beyond prompt + steps: up
    to k rejected draft tokens plus the in-flight pend write. The one
    budget formula: ``speculative_generate``'s check, the engine's
    ``validate_request`` and ``_block_cap`` read it from here."""
    return k + 1


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis, by its formula: the
    shifted logits minus the log of the sum of their exponentials."""
    shifted = x - x.amax(-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


def residual_distribution(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The rejection-resample distribution r = max(p - q, 0)/Z over the
    last axis, with ``p`` where Z == 0 (only when the accept probability
    was exactly 1, so it never fires; it keeps the categorical defined)."""
    r = (p - q).clamp_min(0.0)
    z = r.sum(-1, keepdim=True)
    return torch.where(z > 0, r / torch.where(z > 0, z, 1.0), p)


def speculative_generate(target_cfg: TransformerConfig, target_params: Any,
                         draft_cfg: TransformerConfig, draft_params: Any,
                         prompt: Any, num_steps: int, *, k: int = 4,
                         temperature: float = 0.0,
                         top_p: float | None = None, rng: Any = None,
                         program: Any = None,
                         device=None) -> tuple[torch.Tensor, int]:
    """Speculative decode: ``([B, num_steps]`` int32 tokens on ``device``
    (default the card), rounds used).

    ``temperature=0`` (default) is greedy: the tokens of
    ``generate(target_cfg, target_params, prompt, num_steps)`` for any
    draft (a bad draft costs speed, never tokens). ``temperature > 0``
    samples with the accept/residual scheme from ``rng`` (a key from
    ``tf_operator_tpu_torch.random``); ``top_p`` filters both models'
    distributions to their nucleus. ``k`` proposals a round; each round
    emits 1 to k + 1 tokens, and ``rounds`` counts the verify forwards.

    ``program`` (a ``serve/constrain.py`` ``CompiledProgram``) composes a
    grammar constraint: the draft walks the FSM and proposes from masked
    logits, the verify masks each chunk row with the same state chain, and
    a disallowed transition (after the grammar completes) lands on an
    always-allow free state, as the engine's pool row 0 does.

    The params are flax-layout trees or loaded decode-mode models
    (``models/transformer.py`` ``_decode_model``)."""
    plen = prompt.shape[1]
    if plen + num_steps + spec_margin(k) > target_cfg.max_seq_len:
        raise ValueError(
            f"prompt {plen} + steps {num_steps} + speculation "
            f"margin {spec_margin(k)} exceeds target max_seq_len "
            f"{target_cfg.max_seq_len} (the cache must hold up to k "
            "rejected tokens beyond the emitted sequence)"
        )
    if plen + num_steps + spec_margin(k) > draft_cfg.max_seq_len:
        raise ValueError("draft max_seq_len too small for prompt + steps + k")
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if cfg.int8_decode:
            raise ValueError(
                f"{name}_cfg.int8_decode is not supported by speculative "
                "decoding (the int8 head tree has no shared greedy-head "
                "path here); quantize after choosing a decode strategy"
            )
    if temperature < 0:
        raise ValueError(f"temperature={temperature} must be >= 0")
    if temperature > 0 and rng is None:
        raise ValueError("temperature > 0 needs an rng key")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if top_p is not None and temperature <= 0:
        raise ValueError("top_p requires temperature > 0 (greedy ignores it)")
    tmodel = _decode_model(target_cfg, target_params, device)
    dmodel = _decode_model(draft_cfg, draft_params, tmodel.device)
    with torch.no_grad():
        return _spec_run(tmodel, dmodel, prompt, num_steps, int(k),
                         float(temperature),
                         None if top_p is None else float(top_p), rng,
                         program)


def _spec_run(tmodel, dmodel, prompt, num_steps: int, k: int,
              temperature: float, top_p: float | None, rng, program):
    """The round loop of JAX's ``_spec_fn``, eager."""
    dev = tmodel.device
    prompt = torch.as_tensor(prompt, device=dev)
    b = prompt.shape[0]
    sampled = temperature > 0
    if sampled:
        rng = torch.as_tensor(rng, dtype=torch.int64, device=dev)
        temp = torch.tensor(temperature, dtype=torch.float32, device=dev)
    if program is not None:
        from tf_operator_tpu_torch.serve.constrain import oracle_tables

        allow_x, next_x = oracle_tables(program, dev)

    def cmask(logits, st):
        """The additive grammar mask of [B, V] logits at FSM states [B]."""
        if program is None:
            return logits
        return logits + torch.where(allow_x[st], 0.0, _NEG_MASK)

    def advance(st, tok):
        if program is None:
            return st
        return next_x[st, tok.long()].long()

    def scale(logits):
        """Tempered, optionally nucleus-filtered logits: the one
        transformation both models' distributions pass through."""
        s = logits / temp
        return s if top_p is None else _nucleus_filter(s, top_p)

    tcache, tlogits = _prefill(tmodel, prompt)
    dcache, _ = _prefill(dmodel, prompt)
    # pend is the first generated token; the carried state is always the
    # state AFTER pend.
    st = torch.zeros(b, dtype=torch.int64, device=dev)
    tlogits = cmask(tlogits, st)
    if sampled:
        rng, k0 = split(rng)
        pend = categorical(k0, scale(tlogits))
    else:
        pend = tlogits.argmax(-1)
    st = advance(st, pend)
    # k + 1 slack: each round writes a k + 1 window at n < num_steps.
    out = torch.zeros((b, num_steps + k + 1), dtype=torch.int64,
                      device=dev)
    out[:, 0] = pend
    n, rounds = 1, 0
    cols = torch.arange(k + 1, device=dev)[None, :]
    while n < num_steps:
        t_idx, d_idx = tcache["cache_index"], dcache["cache_index"]
        if sampled:
            rng, k_draft, k_acc, k_res, k_bonus = split(rng, 5)
            step_keys = split(k_draft, k + 1)
        # Draft k + 1 steps from pend: the proposals are the first k; the
        # last is drafted so the draft cache holds d_k if all are accepted.
        tok, s = pend, st
        drafted, qlogits = [], []
        for j in range(k + 1):
            logits = cmask(dmodel(tok[:, None], dcache)[:, 0], s)
            if sampled:
                tok = categorical(step_keys[j], scale(logits))
                qlogits.append(logits)
            else:
                tok = logits.argmax(-1)
            s = advance(s, tok)
            drafted.append(tok)
        drafted = torch.stack(drafted, 1)  # [B, k + 1]
        proposals = drafted[:, :k]
        # One target forward over [pend, d_1..d_k]: row i predicts the
        # token after chunk[i].
        tlogits = tmodel(torch.cat([pend[:, None], proposals], 1), tcache)
        if program is not None:
            # The draft's state chain, re-derived: s_seq[:, j] masks chunk
            # row j (s_0 = the state after pend).
            seq = [st]
            for j in range(k):
                seq.append(advance(seq[-1], proposals[:, j]))
            s_seq = torch.stack(seq, 1)  # [B, k + 1]
            tlogits = tlogits + torch.where(allow_x[s_seq], 0.0, _NEG_MASK)
        if sampled:
            qlogits = torch.stack(qlogits, 1)  # [B, k + 1, V]
            logp = _log_softmax(scale(tlogits[:, :k]))
            logq = _log_softmax(scale(qlogits[:, :k]))
            sel = proposals[..., None]
            lp = logp.gather(-1, sel)[..., 0]
            lq = logq.gather(-1, sel)[..., 0]
            log_u = torch.log(uniform(k_acc, (b, k), _TINY, 1.0))
            accept = log_u < torch.minimum(lp - lq, torch.zeros_like(lp))
        else:
            targmax = tlogits.argmax(-1)  # [B, k + 1]
            accept = proposals == targmax[:, :k]
        # The batch-minimum accepted prefix: one host read a round.
        m = int(torch.cumprod(accept.long(), 1).sum(1).min())
        if sampled:
            resample = categorical(k_res, torch.log(residual_distribution(
                torch.exp(logp), torch.exp(logq)) + _TINY))  # [B, k]
            if m == k:
                nxt = categorical(k_bonus, scale(tlogits[:, k]))
            else:
                nxt = torch.where(accept, proposals, resample)[:, m]
        else:
            # The row's argmax at m: the correction at a mismatch, the
            # row's own d_{m+1} where it accepted further.
            nxt = targmax[:, m]
        out[:, n:n + k + 1] = torch.where(cols < m, drafted, nxt[:, None])
        if program is not None:
            st = advance(s_seq[:, m], nxt)
        # Rollback: the fed prefix grew by pend + the accepted proposals.
        set_cache_index(tcache, t_idx + 1 + m)
        set_cache_index(dcache, d_idx + 1 + m)
        n, pend, rounds = n + 1 + m, nxt, rounds + 1
    return out[:, :num_steps].to(torch.int32), rounds


def lane_accept_emit(k: int, tlogits: torch.Tensor, qlogits: torch.Tensor,
                     drafted: torch.Tensor, pend: torch.Tensor,
                     k_acc: torch.Tensor, k_res: torch.Tensor,
                     k_bonus: torch.Tensor, temperature: torch.Tensor,
                     top_p: torch.Tensor, has_top_p: torch.Tensor):
    """Every lane's accept/emit round at once: JAX's ``lane_accept_emit``
    (one lane, vmapped over the engine's slots there) over ``[n, ...]``
    tensors. Each lane's draws have the solo b = 1 shapes: the accept
    uniforms ``(1, k)`` from 1e-38, the residual categorical over ``[1,
    k, V]``, the bonus over ``[1, V]``; so a lane's stream is the solo
    stream of its seed. Greedy lanes (temperature <= 0) draw too and
    discard the draws, as JAX's selects do.

    Inputs: the verify logits ``tlogits`` and the draft's ``qlogits``
    ``[n, k + 1, V]`` (both masked), the drafted tokens ``[n, k + 1]``,
    the incoming ``pend`` ``[n]``, the round keys ``[n, 2]`` and the
    sampling parameters ``[n]``. Returns ``(toks [n, k + 1], counts [n],
    nxt_pend [n])``, int32: the window ``[pend, d_1..d_k]`` whose first
    ``counts = 1 + m`` tokens are emitted, and the next round's pend
    (the correction, residual or bonus token)."""
    sampled = temperature > 0

    def scale(logits):
        """Solo's scale() with the greedy guard (a greedy lane divides by
        1); ``logits`` has the lane axis first."""
        view = (-1,) + (1,) * (logits.dim() - 1)
        s = logits / torch.where(sampled, temperature, 1.0).view(view)
        return torch.where(has_top_p.view(view),
                           _nucleus_filter(s, top_p.view(view)), s)

    proposals = drafted[:, :k].long()
    targmax = tlogits.argmax(-1)  # [n, k + 1]
    tl, ql = tlogits[:, None], qlogits[:, None]  # solo's b = 1 shapes
    logp = _log_softmax(scale(tl[:, :, :k]))  # [n, 1, k, V]
    logq = _log_softmax(scale(ql[:, :, :k]))
    sel = proposals[:, None, :, None]
    lp = logp.gather(-1, sel)[..., 0]  # [n, 1, k]
    lq = logq.gather(-1, sel)[..., 0]
    log_u = torch.log(uniform(k_acc, (1, k), _TINY, 1.0))
    acc_s = log_u < torch.minimum(lp - lq, torch.zeros_like(lp))
    accept = torch.where(sampled[:, None], acc_s[:, 0],
                         proposals == targmax[:, :k])
    m = torch.cumprod(accept.long(), 1).sum(1)  # [n]
    resample = _lane_categorical(k_res, torch.log(residual_distribution(
        torch.exp(logp), torch.exp(logq)) + _TINY))  # [n, 1, k]
    bonus = _lane_categorical(k_bonus, scale(tl[:, :, k]))[:, 0]  # [n]
    col = m.clamp(max=k - 1)[:, None, None]
    at_m = torch.where(acc_s, proposals[:, None], resample).gather(
        2, col)[:, 0, 0]
    nxt_pend = torch.where(
        sampled, torch.where(m == k, bonus, at_m),
        targmax.gather(1, m[:, None])[:, 0])
    toks = torch.cat([pend[:, None].long(), proposals], 1)
    return (toks.to(torch.int32), (1 + m).to(torch.int32),
            nxt_pend.to(torch.int32))


def _lane_categorical(keys: torch.Tensor, logits: torch.Tensor
                      ) -> torch.Tensor:
    """``categorical`` with a key a lane: ``keys [n, 2]`` against
    ``logits [n, ...]``, each lane's noise drawn over ``logits.shape[1:]``
    from its own key, as JAX's vmapped draw is."""
    return (gumbel(keys, logits.shape[1:]) + logits).argmax(-1)
