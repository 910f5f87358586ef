"""Mixture-of-Experts: the top-k routed expert MLP, in PyTorch.

Counterpart of ``tf_operator_tpu/models/moe.py``. Routing is top-k
(``router_top_k``): k = 1 is Switch (the gate is the raw top
probability), k >= 2 is GShard (gates renormalised over the chosen
experts) with choice-priority capacity: every token's first choice
queues before any token's second choice, so second choices drop first.
A dropped choice contributes nothing; the token keeps its residual.
The load-balancing loss is the Switch form over first choices,
``n_experts * sum(fraction_tokens * fraction_probs)``, taken before any
drop; ``MoeMlp`` returns it beside its output (JAX sows it into the
``losses`` collection). Under data parallelism (``data_parallel``, which
the train step attaches) both fractions are means over the GLOBAL batch,
as JAX's are over its sharded one: each rank's means are summed over the
data group (``frac_probs`` through an all-reduce that autograd sees) and
divided by its size before the product. Capacity and dispatch stay per
routing group, and a group never straddles two examples, so they stay on
the rank. In a sequence-parallel model (``seq_parallel``: the ``sp``
ranks each hold a block of every sequence) the group is JAX's for the
whole sequence, the largest divisor <= 512 of it. A group that lies
inside one rank's block routes there; when a group would straddle two
ranks' blocks, every rank of the ``sp`` group gathers the whole sequence
(its gradient summed over ``sp`` and cut back to the rank's block),
routes and computes it as JAX does, and keeps its block of the output. The data group the train step attaches then spans the
sequence axis too, so the fractions are means over every token.

JAX routes with one-hot ``dispatch``/``combine`` tensors ``[G, S, E,
C]`` and einsums. ``top_k_dispatch`` builds those tensors, bitwise
JAX's; ``MoeMlp`` computes the same function with a scatter and a
gather instead (``_positions``): each kept choice's token is copied into its
expert's slot, and each token sums its kept choices' expert outputs
times their gates. It rounds where JAX does in a narrow ``dtype``: the
dispatch is an exact copy; the expert products sum in f32 and ``gelu``
runs on the f32 ``h`` before its cast; the second product sums in f32
and is cast; the combine multiplies the ``dtype`` gates by the ``dtype``
outputs and sums the kept choices in f32, in ascending expert order
(the einsum's contraction order over experts), rounding once.

Expert parallelism (``MoeConfig.mesh`` with its ``ep_axis`` above 1, in
training): each rank holds ``n_experts / ep`` experts of ``w_in`` and
``w_out`` (``moe_param_sharding_rules``: the experts' dim over ``ep``),
the ranks of one ``data_axis`` index take the same rows (JAX's batch is
sharded over the data axis alone), and each routes them exactly as the
plain layer does, dispatches the kept choices of its own experts,
computes them and combines their terms in f32 in ascending expert order;
the f32 partial sums are summed over ``ep`` and cast once, so a token's
kept choices still round once (two nonzero terms add in either order to
the same f32). The gradients keep ``TpPlan``'s rules over ``ep``: the
experts' are the rank's own (averaged over the data axes only); the
gates and the dispatched tokens, which each rank uses in part, enter
through ``ep.copy`` (their partial gradients summed over ``ep``); the
load-balancing loss, whole on every rank, reaches the router once.

Beside tensor parallelism (a mesh with ``tp`` and ``ep``) the layer is
JAX's placement: the router and the experts are whole over ``tp``
(``param_sharding_rules`` cut no MoE leaf) and the experts split over
``ep``. Its input is the residual stream after the row-parallel
all-reduce, the same on every tp rank, so the ``ep`` group is the ranks
of one tp index (``Mesh.group``: those sharing every other coordinate),
the tp ranks of one ep index compute the same experts, and the experts'
and the router's gradients follow ``TpPlan``'s rule 2 over tp (the same
on every tp rank, never summed over it). Beside sequence parallelism the
``ep`` ranks of one sp index hold the same block, so a group that
straddles two blocks is gathered over ``sp`` as above and then routed
over the experts split on ``ep``; the data group the train step attaches
spans ``sp`` and not ``ep``, so the fractions stay means over every
token once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.models.transformer import RMSNorm, _Store, gelu


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 8
    d_model: int = 256
    d_ff: int = 512
    capacity_factor: float = 1.25
    # Experts per token: 1 = Switch, 2 = GShard top-2 (see module doc).
    router_top_k: int = 1
    # Tokens route within groups of this many consecutive tokens of one
    # sequence; None = the largest divisor of the sequence length <= 512.
    group_size: int | None = None
    dtype: torch.dtype = torch.bfloat16
    # Expert parallelism: the experts split over the mesh's ep_axis, the
    # rows over its data_axis (a mesh of parallel/mesh.py; None: whole).
    ep_axis: str = "ep"
    data_axis: str = "dp"
    mesh: Any = None

    def __post_init__(self) -> None:
        if not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]"
            )


def _positions(top_idx: torch.Tensor, n_experts: int, capacity: int):
    """Choice-priority queue positions: for ``top_idx [G, S, k]`` ->
    (slot ``[G, S, k]`` int64, kept ``[G, S, k]`` bool, first-choice
    one-hot ``[G, S, E]`` f32). Choice j of token s queues at expert e
    after every token's kept earlier choices for e and the tokens before
    s choosing e at j; it is kept when its position is below
    ``capacity``, so an expert takes exactly min(assignments, capacity)
    tokens and a dropped choice reserves no slot."""
    idx = top_idx.long()
    prior = torch.zeros(idx.shape[0], 1, n_experts, dtype=torch.long,
                        device=idx.device)
    slots, kept = [], []
    for j in range(idx.shape[-1]):
        oh = F.one_hot(idx[..., j], n_experts)  # [G, S, E]
        pos = (oh.cumsum(1) - 1 + prior).gather(-1, idx[..., j:j + 1])
        keep = pos[..., 0] < capacity
        slots.append(pos[..., 0])
        kept.append(keep)
        prior = prior + (oh * keep[..., None]).sum(1, keepdim=True)
        if j == 0:
            first = oh.float()
    return torch.stack(slots, -1), torch.stack(kept, -1), first


def top_k_dispatch(top_idx: torch.Tensor, gates: torch.Tensor,
                   n_experts: int, capacity: int):
    """JAX's choice-priority dispatch as dense tensors: ``top_idx`` and
    ``gates`` ``[G, S, k]`` -> (dispatch ``[G, S, E, C]``, combine ``[G,
    S, E, C]``, first-choice one-hot ``[G, S, E]``), f32. A dropped
    choice's position is >= C and its row is all zeros (``jax.nn.one_hot``
    of an index past its size), never slot C-1."""
    slot, keep, first = _positions(top_idx, n_experts, capacity)
    ohe = F.one_hot(top_idx.long(), n_experts).float()  # [G, S, k, E]
    ohc = (slot[..., None] == torch.arange(capacity, device=slot.device)
           ).float()  # [G, S, k, C]
    d = keep.float()[..., None, None] * ohe[..., None] * ohc[..., None, :]
    # Each (expert, slot) holds one token: the sums over k are exact.
    return d.sum(2), (d * gates[..., None, None].float()).sum(2), first


class _ExpertDot(torch.autograd.Function):
    """``a @ b`` batched over experts, operands in a narrow dtype, f32
    sums and output: JAX's ``einsum(..., preferred_element_type=f32)``.
    On the card one tensor-core product (``torch.bmm``'s ``out_dtype``);
    elsewhere the upcast operands' f32 product. The backward rounds the
    f32 gradient to the operands' dtype and runs the same products, each
    gradient cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _f32_bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (_f32_bmm(g, b.transpose(1, 2)).to(a.dtype),
                _f32_bmm(a.transpose(1, 2), g).to(b.dtype))


def _f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _expert_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``[E, N, K] @ [E, K, M]``: plain in f32, ``_ExpertDot``
    otherwise."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _ExpertDot.apply(a, b)


def _group_size(cfg: MoeConfig, seq_len: int) -> int:
    """Routing group size: explicit, or the largest divisor of the
    sequence length <= 512 (groups never straddle sequences)."""
    if cfg.group_size is not None:
        if seq_len % cfg.group_size and cfg.group_size % seq_len:
            raise ValueError(
                f"group_size {cfg.group_size} incompatible with seq {seq_len}"
            )
        return min(cfg.group_size, seq_len)
    for g in range(min(512, seq_len), 0, -1):
        if seq_len % g == 0:
            return g
    return seq_len


def expert_parallel(cfg: MoeConfig):
    """The ``TensorParallel`` of the config's ``ep_axis`` when its mesh
    splits the experts (above 1), else None."""
    if cfg.mesh is None or cfg.mesh.shape.get(cfg.ep_axis, 1) == 1:
        return None
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    return TensorParallel(cfg.mesh, cfg.ep_axis)


def moe_param_sharding_rules(ep_axis: str = "ep") -> dict[str, tuple]:
    """JAX's rules for expert-parallel placement (path substring -> spec):
    the stacked expert weights split on the expert dim; the router
    whole."""
    return {
        "w_in": (ep_axis, None, None),
        "w_out": (ep_axis, None, None),
    }


def _train_store(cfg: MoeConfig, device) -> _Store:
    """f32 trainable weights on ``device`` (default the card)."""
    return _Store(cfg.dtype, False, resolve_device(device))


class MoeMlp(nn.Module):
    """Top-k routed expert MLP: ``forward(x [b, t, d]) -> (y [b, t, d] in
    ``cfg.dtype``, aux f32 scalar)``. Weights by flax's names: ``router``
    ``[d, E]`` (f32 always), ``w_in`` ``[E, d, f]``, ``w_out`` ``[E, f,
    d]`` (f32 and trainable in training, ``cfg.dtype`` in a decode
    model's ``store``). Without a ``store``, trainable on ``device``."""

    # Set by parallel/sharding.py::attach; None: the local batch.
    data_parallel = None
    # A sequence-parallel model's sp axis (a TensorParallel of "sp"), set
    # by the Block; None: the sequence is whole on the rank.
    seq_parallel = None

    def __init__(self, cfg: MoeConfig, store: _Store | None = None, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        store = store or _train_store(cfg, device)
        d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
        # Expert parallel: this rank's experts [lo, lo + e_local).
        self.ep = expert_parallel(cfg) if store.trainable else None
        if self.ep is not None:
            if e % self.ep.size:
                raise ValueError(f"n_experts={e} is not a multiple of "
                                 f"{cfg.ep_axis}={self.ep.size}")
            e //= self.ep.size
        self.router = store.param((d, cfg.n_experts), torch.float32)
        self.w_in = store.param((e, d, f))
        self.w_out = store.param((e, f, d))

    def capacity(self, group: int) -> int:
        """Slots an expert has in a group; they scale with k."""
        cfg = self.cfg
        return max(1, int(math.ceil(
            cfg.capacity_factor * cfg.router_top_k * group / cfg.n_experts)))

    def route(self, x: torch.Tensor, group: int | None = None):
        """The router's decisions for ``x [b, t, d]`` in groups of
        ``group`` tokens (default ``_group_size``'s) -> (top_idx, gates,
        probs, capacity), ``[G, S, k]``, ``[G, S, k]`` f32, ``[G, S, E]``
        f32, int. The router's product and softmax run in f32 (on the card
        TF32 must be off for it: a TF32 product flips routes); ties break
        toward the lower expert, as ``lax.top_k``'s do, by a stable
        descending sort."""
        cfg = self.cfg
        b, t, d = x.shape
        group = group or _group_size(cfg, t)
        tokens = x.reshape(b * t // group, group, d)
        probs = torch.softmax(tokens.float() @ self.router.float(), dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        top_idx = order[..., :cfg.router_top_k]
        top_vals = probs.gather(-1, top_idx)
        if cfg.router_top_k == 1:
            gates = top_vals
        else:
            gates = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        return top_idx, gates, probs, self.capacity(group)

    def forward(self, x: torch.Tensor):
        sp = self.seq_parallel
        if sp is None:
            return self._forward(x, None)
        t = x.shape[1]
        group = _group_size(self.cfg, t * sp.size)
        if t % group == 0:
            return self._forward(x, group)
        # The whole sequence on every rank; its gradient, which each
        # rank holds for every position, summed over sp (copy) and cut to
        # this rank's block (gather).
        y, aux = self._forward(sp.copy(sp.gather(x, 1)), group)
        return y.narrow(1, sp.index * t, t), aux

    def _forward(self, x: torch.Tensor, group: int | None):
        cfg = self.cfg
        b, t, d = x.shape
        dt = cfg.dtype
        top_idx, gates, probs, cap = self.route(x, group)
        n_groups, group, k = top_idx.shape
        slot, keep, first = _positions(top_idx, cfg.n_experts, cap)
        frac_tokens, frac_probs = first.mean((0, 1)), probs.mean((0, 1))
        ep = self.ep
        n_local = self.w_in.shape[0]
        lo = 0 if ep is None else ep.index * n_local
        if ep is not None:
            # Each rank combines its experts' gates and dispatches their
            # tokens: both are used in part, so their gradients are summed
            # over ep (TpPlan rule 3); the aux reads the router whole.
            gates, x = ep.copy(gates), ep.copy(x)
        dp = self.data_parallel
        if dp is not None:
            frac_tokens = dp.mean(frac_tokens)
            frac_probs = dp.sum(frac_probs) / dp.size
        aux = cfg.n_experts * (frac_tokens * frac_probs).sum()

        # Dispatch: each kept choice of this rank's experts, its token into
        # [E_local, G, C + 1, D]; dropped choices and other ranks' all land
        # in a spare slot C, which is cut off.
        e_idx = top_idx.long()
        mine = (e_idx >= lo) & (e_idx < lo + n_local)
        keep = keep & mine
        g_idx = torch.arange(n_groups, device=x.device)[:, None, None].expand(
            n_groups, group, k)
        c_idx = torch.where(keep, slot, cap)
        l_idx = torch.where(mine, e_idx - lo, 0)
        tokens = x.reshape(n_groups, group, 1, d).to(dt).expand(
            n_groups, group, k, d)
        expert_in = x.new_zeros((n_local, n_groups, cap + 1, d),
                                dtype=dt).index_put(
            (l_idx, g_idx, c_idx), tokens)[:, :, :cap]
        flat_in = expert_in.reshape(n_local, n_groups * cap, d)
        h = gelu(_expert_dot(flat_in, self.w_in.to(dt))).to(dt)
        expert_out = _expert_dot(h, self.w_out.to(dt)).to(dt).reshape(
            n_local, n_groups, cap, d)

        # Combine: each token's kept choices in ascending expert order,
        # gate (rounded to dt) times output, summed in f32, rounded once
        # (under ep the ranks' f32 partial sums are summed first).
        order = e_idx.argsort(-1)
        e_s, c_s = l_idx.gather(-1, order), c_idx.gather(-1, order)
        w = (gates.gather(-1, order) * keep.gather(-1, order)).to(dt)
        padded = F.pad(expert_out, (0, 0, 0, 1))  # slot C reads zeros
        y = None
        for j in range(k):
            term = w[..., j, None].float() * padded[
                e_s[..., j], g_idx[..., j], c_s[..., j]].float()
            y = term if y is None else y + term
        if ep is not None:
            y = ep.reduce(y)
        return y.reshape(b, t, d).to(dt), aux


class MoeBlock(nn.Module):
    """Pre-norm residual MoE feed-forward block: ``x + MoeMlp(RMSNorm(x))``
    -> (that, aux). Attention-free; for tests and composition. Trainable
    f32 weights; ``norm``/``moe`` are flax's ``RMSNorm_0``/``moe``."""

    def __init__(self, cfg: MoeConfig, device=None):
        super().__init__()
        store = _train_store(cfg, device)
        self.norm = RMSNorm(cfg.d_model, cfg.dtype, store)
        self.moe = MoeMlp(cfg, store)

    def forward(self, x: torch.Tensor):
        y, aux = self.moe(self.norm(x))
        return x + y, aux


def aux_loss_from(auxes, device=None) -> torch.Tensor:
    """The sum of the aux losses the MoE layers returned (``None`` for a
    dense layer); an f32 0 on ``device`` when there is none."""
    auxes = [a for a in auxes if a is not None]
    if not auxes:
        return torch.zeros((), dtype=torch.float32, device=device)
    return sum(auxes[1:], auxes[0])
