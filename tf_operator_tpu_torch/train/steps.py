"""The training and eval steps, the losses and the optimisers, in PyTorch.

Counterpart of ``tf_operator_tpu/train/steps.py`` for one device:
``make_lm_train_step`` builds ``step(state, batch) -> (state, metrics)``
over a training-mode ``Transformer`` (f32 weights, ``cfg.dtype`` compute)
and an ``adamw``, ``lamb`` or ``adafactor`` optimiser, whose learning
rate may be ``warmup_cosine``.
``make_classifier_train_step`` does the same for the image classifiers
(``models/resnet.py``, ``models/mnist.py``) with ``sgd_momentum`` or
``lars``; a ResNet's BatchNorm running statistics (the ``TrainState``'s
``batch_stats``) update in its forward. Where JAX returns a new state,
the port updates the model's weights, statistics and the optimiser's
buffers in place and returns the same ``TrainState``.
``make_lm_eval_step`` and ``evaluate_lm`` are the Evaluator's perplexity
over host batches of any row counts (``chunked_lm_xent_sums``, padding
through ``_iter_padded``), under ``torch.no_grad()``: on the card the
forward runs the flash forward kernel and no backward kernel.
``make_classifier_eval_step`` and ``evaluate`` are the classifier's
accuracy and loss the same way, BatchNorm on its running statistics.

An MoE model's load-balancing loss enters the LM step through
``aux_loss_weight``. ``lamb`` and ``adafactor`` are optax's chains written
as torch optimisers, as ``lars`` is.

Each step takes a data-parallel ``mesh`` (``parallel/mesh.py``) and
its ``data_axis`` (a name or a tuple such as ``("dcn", "dp")``): the
process runs one rank of it. A train step's batch is then this rank's
rows of the global batch (``shard_batch``); it averages the gradients
over the data axes with one all-reduce (``DataParallel.mean_grads``) and
reports the global mean loss (and accuracy), JAX's numbers for the same
global batch. BatchNorm's statistics and the MoE load-balancing loss are
taken over the global batch (``attach``). Under ``grad_accum`` > 1 the
step gathers the batch's rows and deals each rank JAX's microbatch
shards (``_deal_microbatches``). An eval step takes the GLOBAL padded
batch, as JAX's ``evaluate`` places the same host batch on every
process; each rank evaluates its shard and the sums are all-reduced, so
every rank returns the same numbers. A mesh whose ``pp`` axis is above 1
raises, naming ``train/pp_lm.py``'s ``make_pp_lm_train_step``.

FSDP and ZeRO-1 (JAX's ``param_shardings`` and ``opt_shardings``) cut
leaves by JAX's fsdp rule over one of the data axes. Under FSDP
(``param_shardings``, a model cut by ``shard_params_fsdp``) the model
holds its shards; each step gathers every cut leaf for the forward and
its backward (``FullyShardedParallel.gathered``), whose gradient lands
reduce-scattered on the shard, summed over the other data axes and
divided by the data size; the optimiser updates the shards. Under ZeRO-1
(``opt_shardings``) the weights stay whole and ``ZeroOneOptimizer``
updates this rank's part of each cut leaf: its gradient
reduce-scattered, the parts all-gathered after the update. AdamW is
elementwise; LAMB's (and LARS's) norms and Adafactor's factored
statistics and block rms are the whole leaf's, taken over the cut's axes
(``param_cuts``, ``moment_cut``), as for tp and ep. An ``ep`` axis trains
the MoE layers' experts split over it (``models/moe.py``): the rows
stay over the data axes, and every gradient is averaged over them alone
(and ``sp``). Expert parallelism composes with ``tp`` and ``sp``, and
FSDP and ZeRO-1 with ``tp`` and ``sp``: the spec trees are JAX's, of the
whole leaves (``fsdp_sharding_tree``'s rule over the flax tree whole), and
a leaf the tp layout splits is cut again on the dim its spec names, so a
rank holds 1/(tp fsdp) of it (``Cut.within``); its gradient is
reduce-scattered over the data axis and summed over the other data axes
and ``sp``. FSDP or ZeRO-1 beside ``ep`` raises, naming ROADMAP A8l.

A ``tp`` axis beside the data axes trains the Megatron layout of
``models/transformer.py`` (the model's ``mesh`` must be the step's):
each rank holds its slices of the weights (``shard_params_by_rules``),
the ranks of one data index take the same rows, and the gradients are
averaged over the data axes alone (the tensor-parallel ranks hold other
shards; the model's own collectives already summed what rule 3 of
``TpPlan`` sums). With ``xent_chunk`` the loss is ``sharded_lm_xent``,
vocabulary-parallel over the head's split, as JAX's step switches to it;
without, the head's logits are gathered. The eval sums are
vocabulary-parallel too (``chunked_lm_xent_sums(tp=)``). ``lamb`` takes
the norms of a split leaf over tp; ``adafactor`` factors a split leaf on
its whole shape and takes its means and block rms over tp.

An ``sp`` axis above 1 trains the sequence-parallel model (the model's
``mesh`` must be the step's): each rank's batch is its block of the
global batch, ``[B / dp, T / sp]`` (``parallel/sharding.py``
``token_block``, JAX's ``P(dp, sp)``); rows (``grad_accum``'s microbatch
dealing, eval's padded rows) stay over the data axes, while the
gradients, the reported loss and the MoE load-balancing fractions are
averaged over the data axes and ``sp`` (each rank's loss is the mean over
its block; the ring's backward already carried every rank's share of the
other blocks' gradients home). ``xent_chunk`` must divide the per-rank
sequence. The eval step cuts each rank's columns of its rows and sums
over the data axes and ``sp``.

Not ported yet: ``fuse_steps`` (a CUDA graph of the step is its
counterpart, A5's graph).
"""

from __future__ import annotations

import contextlib
import logging
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch.models.transformer import Transformer
from tf_operator_tpu_torch.parallel.mesh import check_data_parallel
from tf_operator_tpu_torch.parallel.sharding import (
    DataParallel,
    attach,
    data_parallel,
)

Schedule = Callable[[int], float]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every position, in f32."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


class _RoundedDot(torch.autograd.Function):
    """``h @ kernel`` in f32 with both operands rounded to ``dtype``: the
    numerics of JAX's ``dot(h.astype(dtype), kernel.astype(dtype),
    preferred_element_type=f32)``. On the card the forward is one
    tensor-core product with f32 sums and output (torch.mm's
    ``out_dtype``); elsewhere it multiplies the upcast operands. The
    backward multiplies in f32 and rounds each gradient to ``dtype``
    before casting it to its input's dtype, as JAX's transpose does."""

    @staticmethod
    def forward(ctx, h, kernel, dtype):
        a, b = h.to(dtype), kernel.to(dtype)
        ctx.save_for_backward(a, b)
        ctx.in_dtypes = (h.dtype, kernel.dtype)
        if a.is_cuda:
            flat = torch.mm(a.reshape(-1, a.shape[-1]), b,
                            out_dtype=torch.float32)
            return flat.reshape(*a.shape[:-1], b.shape[-1])
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        h_dtype, k_dtype = ctx.in_dtypes
        gh = (g @ b.float().T).to(a.dtype).to(h_dtype)
        gk = (a.reshape(-1, a.shape[-1]).float().T
              @ g.reshape(-1, g.shape[-1])).to(b.dtype).to(k_dtype)
        return gh, gk, None


def _head_logits(h: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor | None, dot_dtype) -> torch.Tensor:
    """One chunk's f32 logits: an f32 product, or with ``dot_dtype``
    (bf16) a product of operands rounded to it with f32 sums and output."""
    if dot_dtype is not None:
        logits = _RoundedDot.apply(h, kernel, dot_dtype)
    else:
        logits = h.float() @ kernel.float()
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _token_losses(logits: torch.Tensor, labels: torch.Tensor, tp=None,
                  v_start: int = 0) -> torch.Tensor:
    """Each position's ``logsumexp(logits) - logits[label]``. With ``tp``
    (a ``TensorParallel``) the logits are this rank's columns from
    ``v_start`` and the sums are vocabulary-parallel, JAX's
    ``sharded_lm_xent``: the global max (no gradient: the value does not
    depend on the shift) all-reduced by MAX, the sum of exponentials and
    the label's logit (masked to the rank that holds it) summed over tp,
    forward only (``tp.reduce``): every rank holds the same value, and
    its gradient is the rank's softmax columns minus its one-hot part."""
    if tp is None:
        picked = logits.gather(-1, labels[..., None].long())[..., 0]
        return torch.logsumexp(logits, dim=-1) - picked
    import torch.distributed as dist

    v_local = logits.shape[-1]
    gmax = tp.all_reduce_(logits.detach().amax(-1), op=dist.ReduceOp.MAX)
    sumexp = tp.reduce(torch.exp(logits - gmax[..., None]).sum(-1))
    lse = torch.log(sumexp) + gmax
    idx = labels.long() - v_start
    held = (idx >= 0) & (idx < v_local)
    val = logits.gather(-1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = tp.reduce(torch.where(held, val, 0.0))
    return lse - picked


def _chunk_loss(h, kernel, bias, labels, dot_dtype, tp=None,
                v_start: int = 0) -> torch.Tensor:
    logits = _head_logits(h, kernel, bias, dot_dtype)
    return _token_losses(logits, labels, tp, v_start).sum()


def chunked_lm_xent(hidden: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor | None, labels: torch.Tensor, *,
                    chunk: int = 512, dot_dtype=None) -> torch.Tensor:
    """Exact mean softmax cross-entropy without the ``[B, S, V]`` logits:
    the head runs over ``chunk`` positions at a time, and each chunk is
    checkpointed so the backward recomputes its logits instead of keeping
    them. Peak logits memory is ``B * chunk * V`` f32. Raises
    ``ValueError`` when ``chunk`` does not divide the sequence."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by xent chunk {chunk}")
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_loss, hidden[:, c0:c0 + chunk], kernel, bias,
            labels[:, c0:c0 + chunk], dot_dtype, use_reentrant=False)
    return total / (b * s)


def _vocab_part(tp, hidden, kernel, bias):
    """``(hidden, kernel, bias, v_start)`` for this rank's columns of a
    vocabulary-split head: the replicated ``hidden`` and the whole
    ``bias`` enter through ``tp.copy`` (each rank's gradient of them is a
    part: ``TpPlan`` rule 3), the bias is cut to the rank's columns."""
    v_local = kernel.shape[-1]
    v_start = tp.index * v_local
    hidden = tp.copy(hidden)
    if bias is not None:
        bias = tp.copy(bias).narrow(0, v_start, v_local)
    return hidden, kernel, bias, v_start


def sharded_lm_xent(mesh, hidden: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor | None, labels: torch.Tensor, *,
                    chunk: int = 512, tp_axis: str = "tp",
                    dot_dtype=None) -> torch.Tensor:
    """``chunked_lm_xent`` with the head split on the vocabulary over the
    mesh's ``tp_axis``: JAX's ``sharded_lm_xent``, one process a device.
    ``hidden`` ``[B, S, d]`` is this rank's rows (replicated over tp),
    ``kernel`` ``[d, V / tp]`` its columns of the head, ``bias`` the
    whole ``[V]`` (None without one), ``labels`` ``[B, S]`` its rows'
    global ids. Each chunk is checkpointed; its loss is the
    vocabulary-parallel ``_token_losses``. Returns the mean over this
    rank's tokens, the same on every rank of its tp group; the data axes'
    mean is the step's (its gradients averaged over dp), as for
    ``chunked_lm_xent``. The gradients of ``hidden`` and ``bias`` are
    whole on every rank, the kernel's its columns'. Raises ``ValueError``
    when ``chunk`` does not divide the sequence."""
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    tp = TensorParallel(mesh, tp_axis)
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"per-device seq {s} not divisible by xent chunk "
                         f"{chunk}")
    hidden, kernel, bias, v_start = _vocab_part(tp, hidden, kernel, bias)
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_loss, hidden[:, c0:c0 + chunk], kernel, bias,
            labels[:, c0:c0 + chunk], dot_dtype, tp, v_start,
            use_reentrant=False)
    return total / (b * s)


def chunked_lm_xent_sums(hidden: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor | None, labels: torch.Tensor,
                         mask: torch.Tensor, *, chunk: int = 512,
                         dot_dtype=None, tp=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked ``(loss_sum f32, token_count int32)`` over ``chunk``
    positions at a time: the eval-side form of ``chunked_lm_xent``.
    Padding rows carry mask 0, each token's loss is weighted by its mask
    value, the count is of nonzero mask entries, and the ``[B, S, V]``
    logits never materialize. With ``tp`` (a ``TensorParallel``)
    ``kernel`` is this rank's columns of a vocabulary-split head and
    ``bias`` the whole one: the sums are vocabulary-parallel, the same on
    every rank of the tp group. Raises ``ValueError`` when ``chunk`` does
    not divide the sequence."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by xent chunk {chunk}")
    v_start = 0
    if tp is not None:
        hidden, kernel, bias, v_start = _vocab_part(tp, hidden, kernel,
                                                    bias)
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        cols = slice(c0, c0 + chunk)
        logits = _head_logits(hidden[:, cols], kernel, bias, dot_dtype)
        mc = mask[:, cols]
        loss_sum = loss_sum + (_token_losses(logits, labels[:, cols], tp,
                                             v_start) * mc.float()).sum()
        count = count + (mc > 0).sum(dtype=torch.int32)
    return loss_sum, count


class _Optimiser:
    """What the steps ask of an optimiser: ``init(model)``, a torch
    optimiser over the model's parameters (``build`` over them and their
    ``param_cuts``), ``build(tensors, cuts)``, one over any tensors, of
    which those in ``cuts`` (``{id: Cut}``) are this rank's parts of whole
    leaves, and ``learning_rate(step)``, which the step sets before each
    update. ``lr`` is a number or a schedule of the step count, which
    optax evaluates at the count before the update (step 0 runs at
    ``lr(0)``)."""

    lr: float | Schedule

    def learning_rate(self, step: int) -> float:
        return float(self.lr(step) if callable(self.lr) else self.lr)

    def init(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        return self.build(list(model.parameters()), param_cuts(model))


@dataclass(frozen=True)
class AdamW(_Optimiser):
    """optax ``adamw``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, and
    decoupled weight decay (scaled by the learning rate) on every leaf."""

    lr: float | Schedule
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def build(self, params, cuts) -> torch.optim.AdamW:
        """torch's AdamW follows optax's formula at these settings:
        ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``; it is
        elementwise, so a part of a leaf updates as the whole would."""
        return torch.optim.AdamW(
            params, lr=self.learning_rate(0),
            betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay)


def adamw(lr: float | Schedule = 3e-4, weight_decay: float = 0.01) -> AdamW:
    """AdamW; ``lr`` may be a number or a schedule (``warmup_cosine``)."""
    return AdamW(lr, weight_decay)


@dataclass(frozen=True)
class SGDMomentum(_Optimiser):
    """optax ``sgd(lr, momentum, nesterov)``: the trace ``t = g + m t``
    (``g`` at the first step), the update ``g + m t`` with Nesterov or
    ``t`` without, times ``-lr``. torch's SGD (no dampening, no weight
    decay) computes the same recursion."""

    lr: float | Schedule
    momentum: float = 0.9
    nesterov: bool = True

    def build(self, params, cuts) -> torch.optim.SGD:
        return torch.optim.SGD(params, lr=self.learning_rate(0),
                               momentum=self.momentum,
                               nesterov=self.nesterov)


def sgd_momentum(lr: float | Schedule = 0.1, momentum: float = 0.9,
                 nesterov: bool = True) -> SGDMomentum:
    return SGDMomentum(lr, momentum, nesterov)


class LarsSGD(torch.optim.Optimizer):
    """optax ``lars``'s chain as a torch optimiser, leaf by leaf:

    1. ``u = g + weight_decay * p`` (``add_decayed_weights``);
    2. ``u *= trust_coefficient * |p| / (|u| + eps)``, or 1 where either
       norm is 0 (``scale_by_trust_ratio``; the norms are Frobenius);
    3. ``u *= -lr`` (``scale_by_learning_rate``);
    4. ``t = u + momentum * t`` (``trace``, no Nesterov; ``t`` starts at
       0) and ``p += t``.

    Steps 1 and 2 apply only to leaves of two or more dims (conv and
    dense kernels), JAX's ``_no_norm_or_bias`` mask; biases and BN scales
    skip both. The trace is the state's ``momentum_buffer``. The trust
    coefficient (1e-3) and eps (0) are optax's defaults, which JAX's
    ``lars`` keeps. A parameter in ``cuts`` is this rank's part of a whole
    leaf (``Cut``), whose norms are the leaf's: the squared sums summed
    over its axis."""

    TRUST_COEFFICIENT, EPS = 1e-3, 0.0

    def __init__(self, params, lr: float, weight_decay: float,
                 momentum: float, cuts=None) -> None:
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay, momentum=momentum))
        self.cuts = dict(cuts or {})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if p.dim() >= 2:
                    u = u + group["weight_decay"] * p
                    p_norm, u_norm = _norms(p, u, _axis_of(self.cuts, p))
                    ratio = (self.TRUST_COEFFICIENT * p_norm
                             / (u_norm + self.EPS))
                    ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                        torch.ones_like(ratio), ratio)
                    u = u * ratio
                u = u * -group["lr"]
                state = self.state[p]
                trace = state.get("momentum_buffer")
                if trace is None:
                    trace = state["momentum_buffer"] = u.clone()
                else:
                    trace.mul_(group["momentum"]).add_(u)
                p.add_(trace)


@dataclass(frozen=True)
class Lars(_Optimiser):
    """optax ``lars`` as JAX's ``steps.lars`` builds it by default: no
    Nesterov, weight decay and trust ratio masked by ``_no_norm_or_bias``
    (``LarsSGD``)."""

    lr: float | Schedule
    weight_decay: float = 1e-4
    momentum: float = 0.9

    def build(self, params, cuts) -> LarsSGD:
        return LarsSGD(params, self.learning_rate(0), self.weight_decay,
                       self.momentum, cuts)


def lars(lr: float | Schedule = 1.0, weight_decay: float = 1e-4,
         momentum: float = 0.9) -> Lars:
    """LARS, layerwise-adaptive SGD for large-batch vision training; the
    canonical recipe excludes BN scales and biases from the decay and the
    trust ratio. Use with ``warmup_cosine``."""
    return Lars(lr, weight_decay, momentum)


def _axis_of(cuts: dict, p: torch.Tensor):
    """The axes over which ``p`` is a part of its leaf (a
    ``TensorParallel``; None: whole)."""
    cut = cuts.get(id(p))
    return None if cut is None else cut.axes()


def _norms(p: torch.Tensor, u: torch.Tensor, axis=None):
    """``(|p|, |u|)`` (Frobenius). With ``axis`` (a ``TensorParallel``)
    ``p`` and ``u`` are this rank's parts of a leaf, and the norms are the
    whole leaf's: the squared sums all-reduced over the axis."""
    if axis is None:
        return torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    sq = axis.all_reduce_(torch.stack([p.square().sum(), u.square().sum()]))
    return sq.sqrt().unbind()


def _trust_ratio(p: torch.Tensor, u: torch.Tensor, axis=None
                 ) -> torch.Tensor:
    """optax ``scale_by_trust_ratio``'s factor at its defaults (trust
    coefficient 1, min_norm 0, eps 0): ``|p| / |u|`` (``_norms``), or 1
    where either norm is 0."""
    p_norm, u_norm = _norms(p, u, axis)
    return torch.where((p_norm == 0) | (u_norm == 0),
                       torch.ones_like(p_norm), p_norm / u_norm)


class LambOptimizer(torch.optim.Optimizer):
    """optax ``lamb``'s chain as a torch optimiser, leaf by leaf, at the
    step count ``n`` (from 1):

    1. ``scale_by_adam(b1, b2, eps, eps_root=0)``: ``m = (1 - b1) g + b1
       m``, ``v = (1 - b2) g^2 + b2 v``, ``u = m / (1 - b1^n) /
       (sqrt(v / (1 - b2^n)) + eps)``;
    2. ``add_decayed_weights(weight_decay, mask=_no_norm_or_bias)``: ``u
       += weight_decay * p`` on leaves of two or more dims;
    3. ``scale_by_trust_ratio()`` on every leaf (``_trust_ratio``);
    4. ``p -= lr * u``.

    The state is ``exp_avg`` (m), ``exp_avg_sq`` (v) and ``step`` (n, a
    CPU tensor, as AdamW keeps it). b1, b2 and eps are optax's defaults,
    which JAX's ``lamb`` keeps. ``cuts`` holds the parameters that are
    this rank's parts of a leaf (``Cut``: tp, ep, FSDP or ZeRO-1): their
    trust ratio takes the whole leaf's norms."""

    B1, B2, EPS = 0.9, 0.999, 1e-6

    def __init__(self, params, lr: float, weight_decay: float, *,
                 cuts=None) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.cuts = dict(cuts or {})

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.B1, self.B2
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                n = int(state["step"])
                m = state["exp_avg"].mul_(b1).add_((1 - b1) * g)
                v = state["exp_avg_sq"].mul_(b2).add_((1 - b2) * (g * g))
                u = (m / (1 - b1 ** n)) / (
                    torch.sqrt(v / (1 - b2 ** n)) + self.EPS)
                if p.dim() >= 2:
                    u = u + group["weight_decay"] * p
                p.add_(u * _trust_ratio(p, u, _axis_of(self.cuts, p))
                       * -group["lr"])


@dataclass(frozen=True)
class Lamb(_Optimiser):
    """optax ``lamb`` as JAX's ``steps.lamb`` builds it: b1 0.9, b2 0.999,
    eps 1e-6, weight decay masked by ``_no_norm_or_bias``
    (``LambOptimizer``)."""

    lr: float | Schedule
    weight_decay: float = 0.01

    def build(self, params, cuts) -> LambOptimizer:
        return LambOptimizer(params, self.learning_rate(0),
                             self.weight_decay, cuts=cuts)


def lamb(lr: float | Schedule = 1e-3, weight_decay: float = 0.01) -> Lamb:
    """LAMB, the Adam-based layerwise-adaptive optimiser for large-batch
    transformer training; norm scales and biases skip the decay."""
    return Lamb(lr, weight_decay)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: the (second largest, largest) axes of
    ``shape`` by ``np.argsort``, or None below two dims or when the second
    largest is shorter than ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class AdafactorOptimizer(torch.optim.Optimizer):
    """``optax.adafactor``'s chain at its defaults as a torch optimiser,
    leaf by leaf, at the step count ``n`` (from 0 before the update):

    1. ``scale_by_factored_rms``: ``beta = 1 - (n + 1)^-decay_rate``,
       ``g2 = g^2 + eps``. A leaf with two axes >= ``min_dim_size_to_factor``
       (``_factored_dims``: ``d1`` the second largest, ``d0`` the largest)
       keeps ``v_row = beta v_row + (1 - beta) mean(g2, d0)`` and ``v_col =
       beta v_col + (1 - beta) mean(g2, d1)`` and scales ``g`` by ``(v_row
       / mean(v_row over d1))^-1/2`` and ``v_col^-1/2``; any other leaf
       keeps the full ``v = beta v + (1 - beta) g2`` and scales by
       ``v^-1/2``;
    2. ``clip_by_block_rms(clipping_threshold)``: ``u /= max(1, rms(u) /
       threshold)``;
    3. ``u *= lr``;
    4. ``scale_by_param_block_rms``: ``u *= max(rms(p), 1e-3)``;
    5. ``p -= u``.

    The state is ``v_row`` and ``v_col`` (not shaped like the parameter)
    or ``v``, and ``step`` (n, a CPU tensor). The factored axes are those
    of the parameter's own layout (the Transformer's is flax's). The
    constants are ``optax.adafactor``'s defaults, which JAX's
    ``adafactor`` keeps: factored on axes >= 128, decay rate 0.8, offset
    0, clipping at 1.0, eps 1e-30, parameter scale floored at 1e-3; no
    momentum and no weight decay.

    ``cuts`` maps the parameters that are this rank's parts of a leaf
    (tp, ep, FSDP or ZeRO-1) to their ``Cut``: such a leaf is factored on
    the axes of its WHOLE shape (a part may not be: a ``[128, 192]``
    kernel split to ``[128, 96]``), a mean over the split dim is the sum
    over the cut's axis of the local sums over the whole length, and the
    clip's ``rms(u)`` and the scale's ``rms(p)`` are the whole leaf's. Its
    ``v_row``/``v_col`` are the rank's part (split where the leaf is,
    ``moment_cut``)."""

    MIN_DIM_SIZE_TO_FACTOR, DECAY_RATE, CLIPPING_THRESHOLD = 128, 0.8, 1.0
    EPS, MIN_SCALE = 1e-30, 1e-3

    def __init__(self, params, lr: float, *, cuts=None) -> None:
        super().__init__(params, dict(lr=lr))
        self.cuts = dict(cuts or {})

    @property
    def split(self) -> dict:
        """``{id(parameter): (whole shape, split dim)}`` of the cut
        parameters (the outermost cut's dim)."""
        return {k: (c.whole, c.dim) for k, c in self.cuts.items()}

    @staticmethod
    def _mean(x: torch.Tensor, dim: int, whole: int, axis,
              keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of length ``whole``: the local sum
        all-reduced over ``axis``, the axes that split ``dim`` (None:
        none)."""
        if axis is None:
            return x.mean(dim, keepdim=keepdim)
        return axis.all_reduce_(x.sum(dim, keepdim=keepdim)) / whole

    @staticmethod
    def _rms(x: torch.Tensor, size: int, axis) -> torch.Tensor:
        if axis is None:
            return torch.sqrt(torch.mean(x * x))
        return torch.sqrt(axis.all_reduce_((x * x).sum()) / size)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                cut = self.cuts.get(id(p))
                shape = tuple(p.shape) if cut is None else cut.whole

                def on(d):  # the axes that split dim d of the leaf
                    return None if cut is None else cut.axes(d)

                axis = None if cut is None else cut.axes()
                dims = _factored_dims(shape, self.MIN_DIM_SIZE_TO_FACTOR)
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros(p.select(d0, 0).shape)
                        state["v_col"] = p.new_zeros(p.select(d1, 0).shape)
                n = int(state["step"])
                beta = 1.0 - float(np.float32(n + 1) ** np.float32(
                    -self.DECAY_RATE))
                g2 = g * g + self.EPS
                if dims is None:
                    v = state["v"].mul_(beta).add_((1.0 - beta) * g2)
                    u = g * v ** -0.5
                else:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(beta).add_(
                        (1.0 - beta) * self._mean(g2, d0, shape[d0], on(d0)))
                    v_col = state["v_col"].mul_(beta).add_(
                        (1.0 - beta) * self._mean(g2, d1, shape[d1], on(d1)))
                    rd1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / self._mean(
                        v_row, rd1, shape[d1], on(d1), keepdim=True)) ** -0.5
                    u = (g * row_factor.unsqueeze(d0)
                         * (v_col ** -0.5).unsqueeze(d1))
                state["step"] += 1
                size = math.prod(shape)
                u = u / torch.clamp_min(
                    self._rms(u, size, axis) / self.CLIPPING_THRESHOLD, 1.0)
                u = u * group["lr"]
                rms = self._rms(p, size, axis)
                u = u * torch.where(rms <= self.MIN_SCALE,
                                    torch.full_like(rms, self.MIN_SCALE), rms)
                p.sub_(u)


def moment_cut(key: str, cut):
    """The ``Cut`` of an Adafactor moment ``key`` of a leaf cut by ``cut``:
    the leaf's cuts without the dim the moment averages away (``v_row``:
    the largest, ``v_col``: the second largest), None when only that dim
    is split (the moment is then whole on every rank) or for a moment of
    no such kind."""
    dims = _factored_dims(cut.whole,
                          AdafactorOptimizer.MIN_DIM_SIZE_TO_FACTOR)
    if dims is None or key not in ("v_row", "v_col"):
        return None
    return cut.without(dims[1] if key == "v_row" else dims[0])


@dataclass(frozen=True)
class Adafactor(_Optimiser):
    """``optax.adafactor(lr)`` as JAX's ``steps.adafactor`` builds it
    (``AdafactorOptimizer``). Not torch's ``Adafactor``, whose relative
    step, beta2 schedule and factored axes differ."""

    lr: float | Schedule

    def build(self, params, cuts) -> AdafactorOptimizer:
        return AdafactorOptimizer(params, self.learning_rate(0), cuts=cuts)


def adafactor(lr: float | Schedule = 1e-3) -> Adafactor:
    """Adafactor: the second-moment state of a ``[d_in, d_out]`` kernel is
    O(d_in + d_out), not AdamW's 2 x O(d_in * d_out)."""
    return Adafactor(lr)


def warmup_cosine(peak_lr: float, total_steps: int, *,
                  warmup_steps: int | None = None,
                  end_lr_fraction: float = 0.1) -> Schedule:
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine decay to ``peak_lr * end_lr_fraction`` at ``total_steps``:
    the same function of the step as
    ``optax.warmup_cosine_decay_schedule`` with these arguments."""
    if warmup_steps is None:
        warmup_steps = max(1, total_steps // 20)
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps={total_steps} must exceed "
                         f"warmup_steps={warmup_steps}")
    end = peak_lr * end_lr_fraction
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * max(step, 0) / warmup_steps
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def param_cuts(model: torch.nn.Module) -> dict:
    """``{id(parameter): Cut}`` of every parameter that is this rank's
    part of a leaf cut over an axis above 1: an expert-parallel MoE
    layer's ``w_in``/``w_out`` (its experts), a tensor-parallel model's
    other split leaves (whose part is shaped unlike ``models/convert.py``'s
    ``param_shapes``), and the leaves ``shard_params_fsdp`` cut, beside
    tp a further cut of the rank's tp part (``Cut.within``)."""
    from tf_operator_tpu_torch.models.convert import flax_path, param_shapes
    from tf_operator_tpu_torch.parallel.sharding import Cut

    experts = {}
    for m in model.modules():
        ep = getattr(m, "ep", None)
        if ep is not None and ep.size > 1:
            for p in (m.w_in, m.w_out):
                experts[id(p)] = Cut(
                    (m.cfg.n_experts,) + tuple(p.shape[1:]), 0, ep)
    fsdp = getattr(model, "fsdp", None)
    shards = fsdp.cuts if fsdp is not None else {}
    plan = getattr(model, "tp_plan", None)
    split = plan is not None and plan.tp.size > 1 and plan.train
    whole = param_shapes(model.cfg) if split else {}
    out = {}
    for name, p in model.named_parameters():
        shard = shards.get(name)
        cut = experts.get(id(p))
        if cut is None and split:
            # The tp part: the parameter's shape before FSDP cut it.
            part = shard.whole if shard is not None else tuple(p.shape)
            shape = tuple(whole[flax_path(name)])
            if shape != part:
                at = next(d for d, (a, b) in enumerate(zip(shape, part))
                          if a != b)
                cut = Cut(shape, at, plan.tp)
        if shard is not None and shard.axis.size > 1:
            cut = shard if cut is None else cut.within(shard)
        if cut is not None:
            out[id(p)] = cut
    return out


@dataclass
class TrainState:
    """The step count, the model (which holds the weights and, for a
    BatchNorm model, the running statistics) and the optimiser (which
    holds the moments or the momentum buffers)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, model: torch.nn.Module, tx: _Optimiser) -> TrainState:
        return cls(step=0, model=model, optimizer=tx.init(model))

    @property
    def batch_stats(self) -> dict | None:
        """The BatchNorm running statistics, ``{dotted name: buffer}``
        (the live tensors; the names are flax paths joined by dots), or
        None for a model without BatchNorm."""
        return dict(self.model.named_buffers()) or None


def _on(device, x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


class ZeroOneOptimizer:
    """ZeRO-1 over a torch optimiser (``weight_update_shardings``): the
    model keeps its weights whole over the data axis (beside tp, its tp
    parts), and the optimiser updates only this rank's part of each cut
    leaf (a view into the weight, so its moments are the part's):
    ``grads`` reduce-scatters each cut leaf's gradient into its part,
    ``step`` updates the parts and the uncut leaves, then all-gathers
    every cut leaf from its parts. ``views`` maps a cut parameter's id to
    ``(parameter, part, its ZeRO-1 Cut, the part's Cut in the whole leaf)``
    (the last the model's cut, ``param_cuts``, then the ZeRO-1 one);
    ``param_groups``, ``state`` and the state dict are the inner
    optimiser's."""

    def __init__(self, model: torch.nn.Module, tx: "_Optimiser",
                 cuts: dict) -> None:
        self.views = {}
        model_cuts = param_cuts(model)
        tensors, inner_cuts = [], {}
        for name, p in model.named_parameters():
            cut = cuts.get(name)
            if cut is None:
                tensors.append(p)
                if id(p) in model_cuts:
                    inner_cuts[id(p)] = model_cuts[id(p)]
                continue
            part = cut.part(p.detach())
            outer = model_cuts.get(id(p))
            whole = cut if outer is None else outer.within(cut)
            self.views[id(p)] = (p, part, cut, whole)
            tensors.append(part)
            if any(ax.size > 1 for _, ax in whole.levels()):
                inner_cuts[id(part)] = whole
        self.model, self.model_cuts = model, model_cuts
        self.inner = tx.build(tensors, inner_cuts)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.inner.load_state_dict(state_dict)

    def held(self, p: torch.Tensor):
        """``(the tensor the optimiser keeps p's state by, its Cut in the
        whole leaf or None)``."""
        view = self.views.get(id(p))
        if view is None:
            return p, self.model_cuts.get(id(p))
        return view[1], view[3]

    def adopt(self, old: torch.optim.Optimizer) -> None:
        """Take ``old``'s state (an optimiser over the model's
        parameters), each tensor cut to this rank's ZeRO-1 part as it is
        kept here."""
        for p in self.model.parameters():
            got = old.state.get(p)
            if not got:
                continue
            view = self.views.get(id(p))
            key, cut = (p, None) if view is None else (view[1], view[2])
            self.inner.state[key] = {
                k: _cut_state(k, v, cut).clone() if isinstance(
                    v, torch.Tensor) else v for k, v in got.items()}

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.model.zero_grad(set_to_none=set_to_none)
        self.inner.zero_grad(set_to_none=set_to_none)

    def grads(self, dp: DataParallel | None, rest: DataParallel | None
              ) -> None:
        """The mean gradients: each cut leaf's reduce-scattered over its
        axis into its part and summed over the other data axes
        (``rest``), every whole leaf's averaged over the data axes."""
        whole = []
        for p in self.model.parameters():
            view = self.views.get(id(p))
            if view is None:
                whole.append(p)
            elif p.grad is not None:
                view[1].grad = view[2].axis.reduce_scatter(p.grad,
                                                           view[2].dim)
                p.grad = None
        parts = [v[1] for v in self.views.values()]
        if dp is not None:
            dp.mean_grads(whole)
            rest.mean_grads(parts, size=dp.size)

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        for p, part, cut, _ in self.views.values():
            p.copy_(cut.gather(part.contiguous()))


def state_cut(key: str, t: torch.Tensor, cut):
    """The ``Cut`` of optimiser tensor ``key`` (whole or a part) of a leaf
    cut by ``cut``: the leaf's for a tensor of its rank, an Adafactor
    factored moment's (``moment_cut``), None for any other (a step count)
    or an uncut leaf."""
    if cut is None or not t.dim():
        return None
    if t.dim() == len(cut.whole):
        return cut
    return moment_cut(key, cut)


def _cut_state(key: str, t: torch.Tensor, cut) -> torch.Tensor:
    """This rank's part of a whole optimiser tensor (``state_cut``)."""
    part = state_cut(key, t, cut)
    return t if part is None else part.part(t)


def _flax_specs(model: torch.nn.Module, specs: Any, what: str) -> dict:
    """``{parameter name: (spec, the port dim of each flax dim)}`` of a
    spec tree by flax path (``fsdp_sharding_tree``'s, in the params
    tree's layout)."""
    from tf_operator_tpu_torch.models.convert import _leaves, variable_layout
    from tf_operator_tpu_torch.parallel.sharding import flax_dims

    leaves, to_flax, _ = variable_layout(model)
    given = dict(_leaves(specs)) if isinstance(specs, dict) else {}
    names = {id(p): n for n, p in model.named_parameters()}
    if given.keys() != leaves["params"].keys():
        raise ValueError(f"{what}: the spec tree does not match the "
                         "model's params tree")
    return {names[id(p)]: (tuple(given[path]), flax_dims(to_flax, p.dim()))
            for path, p in leaves["params"].items()}


def _placement(model: torch.nn.Module, mesh: Any, dp, param_shardings,
               opt_shardings, what: str, grads=None):
    """``(fsdp, zero, rest)``: the model's ``FullyShardedParallel`` under
    ``param_shardings``, the ZeRO-1 cuts ``{name: Cut}`` under
    ``opt_shardings``, and the ``DataParallel`` of the axes the gradients
    are averaged over (``grads``, default the data axes ``dp``; the data
    axes and sp in a sequence-parallel step) other than the one they cut
    over; Nones without either. Beside tp the cuts are of the rank's
    tensor-parallel parts (the specs are JAX's, of the whole leaves).
    Refuses what JAX's contract does not hold (a spec tree that is not
    the model's cut, an axis that is not a data axis) and either beside
    ep, naming ROADMAP A8l."""
    from tf_operator_tpu_torch.parallel.sharding import Cut, TensorParallel

    if param_shardings is None and opt_shardings is None:
        return None, None, None
    if mesh is None:
        raise ValueError(f"{what}: param_shardings and opt_shardings need "
                         "the mesh they name")
    if param_shardings is not None and opt_shardings is not None:
        raise ValueError(f"{what}: under param_shardings the moments are "
                         "cut as the weights are; pass one of the two")
    if mesh.shape.get("ep", 1) > 1:
        raise NotImplementedError(
            f"{what}: FSDP or ZeRO-1 beside ep={mesh.shape['ep']} is not "
            "ported yet: see ROADMAP.md A8l (FSDP or ZeRO-1 beside expert "
            "parallelism)")
    fsdp = zero = None
    if param_shardings is not None:
        fsdp = getattr(model, "fsdp", None)
        if fsdp is None:
            raise ValueError(f"{what}: cut the model with "
                             "shard_params_fsdp before TrainState.create")
        fsdp.check(param_shardings, what)
        axis = fsdp.axis.axis
    else:
        specs = _flax_specs(model, opt_shardings, what)
        axes = {a for spec, _ in specs.values() for a in spec if a}
        if len(axes) > 1:
            raise ValueError(f"{what}: opt_shardings name {sorted(axes)}; "
                             "ZeRO-1 cuts over one data axis")
        axis = next(iter(axes), None)
        params = dict(model.named_parameters())
        zero = {}
        if axis is not None:
            over = TensorParallel(mesh, axis)
            for name, (spec, dims) in specs.items():
                if axis not in spec:
                    continue
                shape, dim = tuple(params[name].shape), dims[spec.index(
                    axis)]
                if shape[dim] % over.size:
                    raise ValueError(
                        f"{what}: {name}'s part {shape} does not divide on "
                        f"dim {dim} by {axis}={over.size}")
                zero[name] = Cut(shape, dim, over)
    if axis is not None and axis not in dp.axes:
        raise ValueError(f"{what}: {axis!r} is not one of the data axes "
                         f"{dp.axes}")
    grads = grads or dp
    rest = DataParallel(mesh, tuple(a for a in grads.axes if a != axis))
    return fsdp, zero, rest


def _zero_optimizer(state: "TrainState", tx: "_Optimiser", zero: dict
                    ) -> ZeroOneOptimizer:
    """The state's ZeRO-1 optimiser: on the step's first call the whole
    one ``TrainState.create`` built is replaced, its state (a restored
    one, say) cut to this rank's parts, as JAX's step constrains the
    updated moments to ``opt_shardings``."""
    opt = state.optimizer
    if not isinstance(opt, ZeroOneOptimizer):
        new = ZeroOneOptimizer(state.model, tx, zero)
        new.adopt(opt)
        state.optimizer = opt = new
    return opt


def _mean_grads(model, grads, fsdp, rest) -> None:
    """Average the gradients over the data axes (``grads``); under FSDP a
    cut leaf's gradient is already summed over its axis (the gather's
    reduce-scatter) and is summed over the other data axes (``rest``)."""
    if grads is None:
        return
    if fsdp is None:
        grads.mean_grads(list(model.parameters()))
        return
    cut = {id(p) for n, p in model.named_parameters() if n in fsdp.cuts}
    grads.mean_grads([p for p in model.parameters() if id(p) not in cut])
    rest.mean_grads([p for p in model.parameters() if id(p) in cut],
                    size=grads.size)


def _step_data_parallel(model: torch.nn.Module, mesh: Any, data_axis: Any,
                        what: str) -> DataParallel | None:
    """The step's ``DataParallel`` (None without a mesh), after refusing
    a mesh that is not data-parallel; hands it to the model's global-batch
    statistics."""
    if mesh is None:
        return None
    check_data_parallel(mesh, what)
    dp = data_parallel(mesh, data_axis)
    attach(model, dp)
    return dp


def _seq_data_parallel(model: torch.nn.Module, mesh: Any, data_axis: Any,
                       what: str) -> DataParallel | None:
    """Under a mesh whose model trains sequence-parallel: the
    ``DataParallel`` over the data axes and the sequence axis, handed to
    the model's global-batch statistics (the MoE fractions: a mean over
    every token). None for any other step."""
    if mesh is None or mesh.shape.get(model.cfg.seq_axis, 1) == 1:
        return None
    if model.cfg.mesh is not mesh:
        raise ValueError(f"a sequence-parallel model {what} over its own "
                         "mesh: pass the model's cfg.mesh as mesh=")
    axes = (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)
    out = DataParallel(mesh, axes + (model.cfg.seq_axis,))
    attach(model, out)
    return out


def _deal_microbatches(dp: DataParallel, x, grad_accum: int
                       ) -> torch.Tensor:
    """This rank's rows for ``grad_accum`` microbatches, in order: JAX
    splits the GLOBAL batch into contiguous microbatches and shards each
    over the data axes, so rank index r's microbatch i is global rows
    ``i * mb + r * m`` to ``i * mb + (r + 1) * m`` (mb = B / grad_accum,
    m = mb / size), gathered from the ranks' rows."""
    rows = dp.gather_rows(torch.as_tensor(x))
    mb = rows.shape[0] // grad_accum
    m = mb // dp.size
    return torch.cat([rows[i * mb + dp.index * m:i * mb + (dp.index + 1) * m]
                      for i in range(grad_accum)])


def make_lm_train_step(model: Transformer, tx: _Optimiser, *,
                       xent_chunk: int | None = None, xent_dot_dtype=None,
                       grad_accum: int = 1, aux_loss_weight: float = 0.0,
                       mesh: Any = None, data_axis: Any = "dp",
                       param_shardings: Any = None,
                       opt_shardings: Any = None):
    """The train step for the LM, on one device: the loss (mean token
    cross-entropy; ``chunked_lm_xent`` when ``xent_chunk`` is set, with
    the head product in ``xent_dot_dtype``), its gradients and one
    optimiser update at ``tx``'s learning rate for the state's step.

    ``grad_accum`` > 1 splits the batch into that many equal microbatches
    (leading rows first) and averages their gradients into one update;
    the reported loss is the mean over microbatches.

    ``aux_loss_weight`` adds that multiple of the MoE layers' summed
    load-balancing loss to the loss (``xent + w * aux``, the reported
    ``loss``) and reports the aux as ``aux_loss``, its mean over
    microbatches under ``grad_accum``.

    ``batch`` is ``{"tokens", "targets"}``, ``[B, S]`` integer tensors or
    numpy arrays; they are moved to the model's device. Under a ``mesh``
    they are this rank's rows of the global batch, the rows of its data
    index (the module docstring).

    ``param_shardings`` (``fsdp_sharding_tree``'s specs of a model cut by
    ``shard_params_fsdp``) trains FSDP: each leaf gathered for the
    forward, its gradient reduce-scattered. ``opt_shardings``
    (``weight_update_shardings``, in the params tree's layout) trains
    ZeRO-1: the weights stay whole and the optimiser updates this rank's
    part of each cut leaf (``ZeroOneOptimizer``, which replaces the
    state's optimiser on the first call); as in JAX's step, the weights
    are then whole on every rank after each update."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    if model.cfg.decode:
        raise ValueError("train a model built with decode=False")
    dp = _step_data_parallel(model, mesh, data_axis, "make_lm_train_step")
    data_size = dp.size if dp is not None else 1
    plan = model.tp_plan
    if (plan is not None or mesh is not None and mesh.shape.get("tp", 1) > 1
            ) and model.cfg.mesh is not mesh:
        raise ValueError("a tensor-parallel model trains over its own "
                         "mesh: pass the model's cfg.mesh as mesh=")
    tp_size = plan.tp.size if plan is not None else 1
    # Sequence-parallel: rows over the data axes (dp), gradients, the loss
    # and the MoE fractions over the data axes and sp.
    grads = _seq_data_parallel(model, mesh, data_axis, "trains") or dp
    fsdp, zero, rest = _placement(model, mesh, dp, param_shardings,
                                  opt_shardings, "make_lm_train_step", grads)
    gathered = fsdp.gathered if fsdp is not None else contextlib.nullcontext
    # JAX's sharded_loss: the vocabulary-parallel loss when tp > 1 and the
    # loss is chunked (a head whose vocabulary does not tile is whole).
    sharded = (xent_chunk is not None and tp_size > 1
               and plan.vocab is not None)

    def loss_fn(tokens, targets):
        """-> (loss, aux or None)."""
        if grads is not dp and xent_chunk and tokens.shape[1] % xent_chunk:
            raise ValueError(f"per-device seq {tokens.shape[1]} not "
                             f"divisible by xent chunk {xent_chunk}")
        out, aux = model(tokens, return_hidden=xent_chunk is not None,
                         return_aux=True)
        head = model.lm_head
        if xent_chunk is None:
            xent = cross_entropy(out, targets)
        elif sharded:
            xent = sharded_lm_xent(mesh, out, head.kernel, head.bias,
                                   targets, chunk=xent_chunk,
                                   dot_dtype=xent_dot_dtype)
        else:
            xent = chunked_lm_xent(out, head.kernel, head.bias, targets,
                                   chunk=xent_chunk,
                                   dot_dtype=xent_dot_dtype)
        if not aux_loss_weight:
            return xent, None
        return xent + aux_loss_weight * aux, aux

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step's")
        tokens, targets = batch["tokens"], batch["targets"]
        b = tokens.shape[0] * data_size
        if b % grad_accum or (b // grad_accum) % data_size:
            raise ValueError(
                f"batch dim {b} not divisible into grad_accum="
                f"{grad_accum} microbatches that tile the data axis "
                f"(size {data_size})")
        if grad_accum > 1 and data_size > 1:
            tokens = _deal_microbatches(dp, tokens, grad_accum)
            targets = _deal_microbatches(dp, targets, grad_accum)
        tokens = _on(model.device, tokens)
        targets = _on(model.device, targets)
        b = tokens.shape[0]
        opt = state.optimizer
        if zero is not None:
            opt = _zero_optimizer(state, tx, zero)
        opt.zero_grad(set_to_none=True)
        mb = b // grad_accum
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        aux_sum = torch.zeros_like(loss)
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            with gathered():
                micro, aux = loss_fn(tokens[rows], targets[rows])
                (micro / grad_accum).backward()
            loss += micro.detach()
            if aux is not None:
                aux_sum += aux.detach()
        if grad_accum > 1:  # JAX's scan: the sums times 1 / grad_accum
            loss *= 1.0 / grad_accum
            aux_sum *= 1.0 / grad_accum
        if zero is not None:
            opt.grads(grads, rest)
        else:
            _mean_grads(model, grads, fsdp, rest)
        if grads is not None:
            loss, aux_sum = grads.mean(torch.stack([loss, aux_sum])).unbind()
        lr = tx.learning_rate(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        metrics = {"loss": loss}
        if aux_loss_weight:
            metrics["aux_loss"] = aux_sum
        return state, metrics

    return step


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The share of rows whose argmax is the label, f32."""
    return (logits.argmax(-1) == labels).float().mean()


def _gathered(model: torch.nn.Module):
    """A model cut by ``shard_params_fsdp`` with its leaves whole, for an
    eval's forward; any other model as it is."""
    fsdp = getattr(model, "fsdp", None)
    return fsdp.gathered() if fsdp is not None else contextlib.nullcontext()


def _check_batch_stats(model: torch.nn.Module, has_batch_stats: bool) -> None:
    """JAX's ``has_batch_stats`` names whether the model carries a
    ``batch_stats`` collection; in the port the BatchNorm buffers are it,
    so the flag must agree with the model (JAX fails at ``apply``)."""
    has = any(True for _ in model.buffers())
    if has != has_batch_stats:
        raise ValueError(
            f"has_batch_stats={has_batch_stats}, but the model "
            f"{'has' if has else 'has no'} BatchNorm statistics")


def make_classifier_train_step(model: torch.nn.Module, tx: _Optimiser, *,
                               has_batch_stats: bool = True,
                               mesh: Any = None, data_axis: Any = "dp",
                               param_shardings: Any = None):
    """The train step for the image classifiers, on one device: the
    forward in training mode (BatchNorm on the batch's statistics, its
    running statistics updated), the mean cross-entropy of the f32
    logits, its gradients and one optimiser update at ``tx``'s learning
    rate for the state's step. Returns ``{"loss", "accuracy"}`` as
    device scalars.

    ``batch`` is ``{"image": [B, H, W, C], "label": [B]}``, numpy arrays
    or tensors; they are moved to the model's device. Under a ``mesh``
    they are this rank's rows of the global batch, and BatchNorm takes
    the global batch's statistics. ``param_shardings`` trains FSDP, as
    ``make_lm_train_step``'s does."""
    _check_batch_stats(model, has_batch_stats)
    dp = _step_data_parallel(model, mesh, data_axis,
                             "make_classifier_train_step")
    fsdp, _, rest = _placement(model, mesh, dp, param_shardings, None,
                               "make_classifier_train_step")
    gathered = fsdp.gathered if fsdp is not None else contextlib.nullcontext

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step's")
        images = _on(model.device, batch["image"])
        labels = _on(model.device, batch["label"])
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        with gathered():
            logits = model(images, train=True)
            loss = cross_entropy(logits, labels)
            loss.backward()
        acc = accuracy(logits.detach(), labels)
        loss = loss.detach()
        _mean_grads(model, dp, fsdp, rest)
        if dp is not None:
            loss, acc = dp.mean(torch.stack([loss, acc])).unbind()
        lr = tx.learning_rate(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    return step


def _iter_padded(batches, shard_count: int, pad_to: int | None,
                 fields: tuple[str, ...], mask_ndim: int):
    """Yield ``(arrays with "mask", pad_to)`` for each non-empty host
    batch, every batch zero-padded to ONE row count (``pad_to``; default:
    the first non-empty batch's rows rounded up to ``shard_count``). The
    mask is ones over real rows and zeros over padding, of the leading
    ``mask_ndim`` dims, or the batch's own per-element "mask" field, so
    padded rows contribute nothing. JAX's ``_iter_padded``, whose fixed
    shape served one compiled executable; here it keeps the eval's
    shapes (and its kernels' launches) the same for every batch."""
    for batch in batches:
        arrs = {f: np.asarray(batch[f]) for f in fields}
        n = arrs[fields[0]].shape[0]
        if n == 0:
            continue  # an empty shard must not define (or fail) the shape
        if pad_to is None:
            pad_to = -(-n // shard_count) * shard_count
        if n > pad_to:
            raise ValueError(
                f"batch of {n} exceeds pad_to={pad_to}; the first batch "
                "sets the compiled shape — pass pad_to= explicitly when "
                "later batches can be larger"
            )
        mshape = arrs[fields[0]].shape[:mask_ndim]
        arrs["mask"] = (
            np.asarray(batch["mask"], np.float32)
            if "mask" in batch
            else np.ones(mshape, np.float32)
        )
        pad = pad_to - n
        if pad:
            arrs = {
                k: np.concatenate(
                    [v, np.zeros((pad, *v.shape[1:]), v.dtype)]
                )
                for k, v in arrs.items()
            }
        yield arrs, pad_to


def eval_chunk(seq: int, xent_chunk: int) -> int:
    """The largest divisor of ``seq`` that is <= ``xent_chunk``: JAX's
    eval chunk. ``xent_chunk`` is a memory bound and is never exceeded."""
    return next(c for c in range(min(xent_chunk, seq), 0, -1)
                if seq % c == 0)


def _eval_shard(dp: DataParallel | None, batch, fields) -> dict:
    """This rank's share of a global eval batch: its ``1 / size`` of the
    rows, at its shard index (all of them without a mesh)."""
    if dp is None:
        return {f: batch[f] for f in fields}
    n = batch[fields[0]].shape[0]
    if n % dp.size:
        raise ValueError(f"eval batch of {n} rows does not tile the data "
                         f"axis (size {dp.size})")
    per = n // dp.size
    rows = slice(dp.index * per, (dp.index + 1) * per)
    return {f: batch[f][rows] for f in fields}


class LMEvalStep:
    """``step(state, batch) -> {"loss_sum"}``: the model's forward under
    ``torch.no_grad()`` and the masked chunked loss sums of a batch
    ``{"tokens", "targets", "mask"}`` (numpy arrays or tensors, moved to
    the model's device). ``shard_count`` is 1 on one device, the data
    axes' size under a mesh: the batch is then the global one, and the
    sums every rank returns are the global ones."""

    def __init__(self, model: Transformer, xent_chunk: int,
                 dp: DataParallel | None = None,
                 sums: DataParallel | None = None) -> None:
        self.model = model
        self.xent_chunk = xent_chunk
        self.dp = dp
        # Sequence-parallel: each rank takes its columns of its rows, and
        # the sums are taken over the data axes and sp.
        self.sums = sums or dp
        self.sp = model.seq_parallel
        # A vocabulary-split head's sums are taken over tp.
        plan = model.tp_plan
        self.tp = (plan.tp if plan is not None and plan.tp.size > 1
                   and plan.vocab is not None else None)
        self.shard_count = dp.size if dp is not None else 1
        self._warned: set[int] = set()

    def chunk_for(self, seq: int) -> int:
        """The eval chunk at ``seq``; warns once a length, as JAX warns at
        trace time, when its best divisor is tiny."""
        chunk = eval_chunk(seq, self.xent_chunk)
        if chunk < min(8, self.xent_chunk, seq) and seq not in self._warned:
            self._warned.add(seq)
            logging.getLogger(__name__).warning(
                "seq %d has no divisor <= xent_chunk %d above %d; eval "
                "will scan %d tiny chunks — consider a seq length with a "
                "divisor near the chunk size",
                seq, self.xent_chunk, chunk, seq // chunk,
            )
        return chunk

    def __call__(self, state: TrainState, batch) -> dict:
        model = self.model
        if state.model is not model:
            raise ValueError("the state holds another model than the step's")
        batch = _eval_shard(self.dp, batch, ("tokens", "targets", "mask"))
        if self.sp is not None:
            n = batch["tokens"].shape[1] // self.sp.size
            cols = slice(self.sp.index * n, (self.sp.index + 1) * n)
            batch = {k: v[:, cols] for k, v in batch.items()}
        tokens = _on(model.device, batch["tokens"])
        targets = _on(model.device, batch["targets"])
        mask = _on(model.device, batch["mask"])
        chunk = self.chunk_for(tokens.shape[1])
        with torch.no_grad(), _gathered(model):
            hidden = model(tokens, return_hidden=True)
            head = model.lm_head
            # The token count is not kept: evaluate_lm counts on the host
            # (a device int32 would wrap past 2^31 tokens).
            loss_sum, _ = chunked_lm_xent_sums(
                hidden, head.kernel, head.bias, targets, mask, chunk=chunk,
                tp=self.tp)
        if self.sums is not None:
            self.sums.all_reduce_(loss_sum)
        return {"loss_sum": loss_sum}


def make_lm_eval_step(model: Transformer, *, xent_chunk: int = 512,
                      mesh: Any = None, data_axis: Any = "dp"
                      ) -> LMEvalStep:
    """The LM eval step (the Evaluator-role flow for the transformer):
    MASKED sums (``loss_sum`` f32) so ``evaluate_lm`` can pad every batch
    to one shape, with the ``[B, S, V]`` logits never materialized. The
    chunk is the largest divisor of the sequence <= ``xent_chunk``
    (``eval_chunk``)."""
    if model.cfg.decode:
        raise ValueError("evaluate a model built with decode=False")
    if mesh is not None:
        check_data_parallel(mesh, "make_lm_eval_step")
    if (model.tp_plan is not None or mesh is not None
            and mesh.shape.get("tp", 1) > 1) and model.cfg.mesh is not mesh:
        raise ValueError("a tensor-parallel model evaluates over its own "
                         "mesh: pass the model's cfg.mesh as mesh=")
    return LMEvalStep(model, xent_chunk, data_parallel(mesh, data_axis),
                      _seq_data_parallel(model, mesh, data_axis,
                                         "evaluates"))


def evaluate_lm(eval_step: LMEvalStep, state: TrainState, batches, *,
                pad_to: int | None = None) -> dict[str, float]:
    """Drive an LM eval step over host batches of any row counts (padding
    via ``_iter_padded``); returns the mean token loss, the perplexity and
    the total token weight (a float: the sum of mask values, exactly the
    token count for 0/1 masks). The f32 loss accumulates on the device,
    read once at the end; the token weight accumulates on the host in
    float64, the sum of mask VALUES, so a fractional mask weights the
    denominator as the device loss weights the numerator."""
    loss_sum = None
    tokens = 0.0
    for arrs, pad_to in _iter_padded(
        batches, eval_step.shard_count, pad_to, ("tokens", "targets"),
        mask_ndim=2,
    ):
        tokens += float(arrs["mask"].sum(dtype=np.float64))
        m = eval_step(state, arrs)
        loss_sum = (m["loss_sum"] if loss_sum is None
                    else loss_sum + m["loss_sum"])
    if loss_sum is None or tokens == 0:
        raise ValueError("evaluate_lm() got no non-empty batches")
    mean = float(loss_sum) / tokens
    return {"loss": mean, "perplexity": math.exp(mean), "tokens": tokens}


class ClassifierEvalStep:
    """``step(state, batch) -> {"correct", "loss_sum", "count"}``: the
    forward in inference mode (BatchNorm on its running statistics) under
    ``torch.no_grad()``, and MASKED sums over a batch ``{"image",
    "label", "mask"}`` (numpy arrays or tensors, moved to the model's
    device): int32 counts of correct and of real rows (mask > 0), and the
    f32 loss weighted by the mask. ``shard_count`` is 1 on one device, the
    data axes' size under a mesh: the batch is then the global one, and
    the sums every rank returns are the global ones."""

    def __init__(self, model: torch.nn.Module,
                 dp: DataParallel | None = None) -> None:
        self.model = model
        self.dp = dp
        self.shard_count = dp.size if dp is not None else 1

    def __call__(self, state: TrainState, batch) -> dict:
        model = self.model
        if state.model is not model:
            raise ValueError("the state holds another model than the step's")
        batch = _eval_shard(self.dp, batch, ("image", "label", "mask"))
        labels = _on(model.device, batch["label"]).long()
        mask = _on(model.device, batch["mask"])
        with torch.no_grad(), _gathered(model):
            logits = model(_on(model.device, batch["image"]), train=False)
            per_example = F.cross_entropy(logits.float(), labels,
                                          reduction="none")
            real = mask > 0
            # Integer counts: an f32 sum would lose exactness past 2^24.
            counts = torch.stack([
                ((logits.argmax(-1) == labels) & real).sum(dtype=torch.int32),
                real.sum(dtype=torch.int32)])
            loss_sum = (per_example * mask.float()).sum()
            if self.dp is not None:
                self.dp.all_reduce_(counts)
                self.dp.all_reduce_(loss_sum)
        return {"correct": counts[0], "loss_sum": loss_sum,
                "count": counts[1]}


def make_classifier_eval_step(model: torch.nn.Module, *,
                              has_batch_stats: bool = True,
                              mesh: Any = None, data_axis: Any = "dp"
                              ) -> ClassifierEvalStep:
    """The classifier's eval step (what an Evaluator replica runs against
    the trainer's checkpoints): masked sums, so ``evaluate`` can pad
    every batch to one shape."""
    _check_batch_stats(model, has_batch_stats)
    if mesh is not None:
        check_data_parallel(mesh, "make_classifier_eval_step")
    return ClassifierEvalStep(model, data_parallel(mesh, data_axis))


def evaluate(eval_step: ClassifierEvalStep, state: TrainState, batches, *,
             pad_to: int | None = None) -> dict[str, float]:
    """Drive a classifier eval step over host batches of ANY sizes, tail
    batches included (padding via ``_iter_padded``, so every call sees
    one shape): ``{"accuracy", "loss", "count"}``, exact counts and the
    loss accumulated in f32 on the device, read once at the end."""
    correct = loss_sum = count = None
    for arrs, pad_to in _iter_padded(
        batches, eval_step.shard_count, pad_to, ("image", "label"),
        mask_ndim=1,
    ):
        m = eval_step(state, arrs)
        if correct is None:
            correct, loss_sum, count = m["correct"], m["loss_sum"], m["count"]
        else:
            correct = correct + m["correct"]
            loss_sum = loss_sum + m["loss_sum"]
            count = count + m["count"]
    if correct is None or int(count) == 0:
        raise ValueError("evaluate() got no non-empty batches")
    total = int(count)
    return {"accuracy": int(correct) / total,
            "loss": float(loss_sum) / total, "count": total}
