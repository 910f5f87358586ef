"""Decoder-only transformer in PyTorch: the training forward and the
decode forward.

Counterpart of ``tf_operator_tpu/models/transformer.py``. Weights keep
flax's layouts (``qkv`` kernel ``[d, 3, H, Dh]``, ``out`` kernel ``[H, Dh,
d]``, ...) so ``models/convert.py`` copies a flax ``params`` tree in
without reshaping. ``TransformerConfig.decode`` picks the mode, as in JAX:

- training (``decode=False``): ``forward(tokens)`` over positions
  ``0..T-1``, causal attention through ``ops.attention`` (the flash
  kernels), optional per-block activation checkpointing (``remat``).
  Parameters are f32 and trainable; each module casts its weights and
  input to ``cfg.dtype`` at use, as flax does with ``param_dtype=f32``.
- decode (``decode=True``): the KV-cache forward over a dense per-request
  cache (what prefill fills) and over the block-paged pool (what the
  continuous engine steps). Parameters are stored in ``cfg.dtype`` and
  need no gradient, so a decode step runs no weight casts.

Decode mode takes JAX's two int8 options: ``int8_decode`` (every
projection and the head as ``Int8Dense``, int8 weights with per-channel
scales, from ``models/convert.py::quantize_decode_params``) and
``kv_int8`` (K/V stored as int8 with one f32 scale per token and head,
``_kv8_quant``). Every ``moe_every_n``-th block routes its MLP through
``models/moe.py``'s experts, in both modes; its weights stay unquantized
under ``int8_decode``. ``mesh`` takes a data-parallel mesh
(``parallel/mesh.py``), which changes nothing in the model: the train
step averages over it. A training mesh whose ``ep_axis`` is above 1
splits each MoE block's experts over it (``models/moe.py``; the rows
over ``batch_axis``), as JAX's ``Block`` hands its mesh to ``MoeMlp``,
beside ``tp`` and ``sp`` too: the MoE input is the residual stream that
every tp rank holds whole (after the row-parallel all-reduce), so the ep
exchange runs among the ranks of one tp index and the tp ranks of an ep
index compute the same experts; under sp a routing group that straddles
two blocks is gathered over sp first. A mesh that shards the layers
raises, naming ``train/pp_lm.py``'s ``make_pp_lm_train_step``, whose
stage models take no mesh.

A training model over a mesh whose ``sp`` axis is above 1 is this rank's
part of a sequence-parallel model (``seq_parallel``): ``forward`` takes
this rank's block of each sequence, ``[b, T / sp]`` tokens at global
positions ``sp_index * T / sp`` onwards, and attention runs over the
``sp`` ring by ``ring_impl`` (``parallel/ring_attention.py``,
``parallel/ulysses.py``), on this rank's heads under tp. An MoE block
routes in JAX's groups of the whole sequence (``models/moe.py``). A
decode mesh over ``sp`` raises (ROADMAP.md A8h: JAX's server builds
none).

A model over a mesh with a ``tp`` axis, in either mode, is this rank's
part of a tensor-parallel model (``param_sharding_rules``, JAX's
Megatron pairs):
the qkv (or q and kv) projections split on heads and ``mlp/in_proj`` on
``d_ff``; ``attn/out`` and ``mlp/out_proj`` split on their input and sum
their partial products with one all-reduce, then add their bias; the
embedding splits on the vocabulary (a masked lookup, whose rows from
other ranks are exact zeros, then an all-reduce) and so does the head,
whose logits are all-gathered in rank order. A leaf that does not tile
stays whole, as the rules leave it: KV heads fewer than tp (every rank
keeps every KV head and reads the ones its query heads group to), an odd
vocabulary or ``d_ff``. An ``int8_decode`` tree stays whole on every
rank, as JAX replicates it: each rank runs the full projections and keeps
its heads' share of the K/V, and the heads' attention outputs are
all-gathered before the whole out-projection. The KV storage holds this
rank's ``KV/tp`` heads either way.

In training the same layout runs under autograd (``TpPlan``'s docstring
has the rule each leaf's gradient follows): the flash kernels run on
each rank over its ``H/tp`` heads, ``n_heads`` that does not tile tp
leaves the attention whole on every rank (JAX's unsharded fallback), and
an MoE block keeps its router and experts whole over tp (JAX's rules match
no MoE leaf), its experts split over ``ep`` where the mesh has one.
``remat`` recomputes a block with its collectives inside the backward,
in the same order on every rank.

The cache is an explicit dict of tensors, updated IN PLACE where the
JAX model rebuilt its ``cache`` collection:

- dense (prefill): ``{"layers": [{"cached_key", "cached_value"}],
  "cache_index": int}`` with ``[b, max_seq_len, KV, Dh]`` rows, every
  lane at one position;
- dense stacked (a speculative engine's draft, ``serve/kvcache.py``
  ``stack_slots``): the same rows with ``"cache_index": [b] int32``, one
  counter a lane, as JAX's vmapped solo caches keep them;
- paged (decode): ``{"layers": [{"pool_key", "pool_value"}],
  "block_table": [b, table_len] int32, "cache_index": [b] int32}`` with
  ``[kv_num_blocks, kv_block, KV, Dh]`` pools.

Under ``kv_int8`` the K/V leaves are int8 and each layer also holds f32
scales: ``key_scale``/``value_scale`` ``[b, max_seq_len, KV]`` (dense) or
``pool_key_scale``/``pool_value_scale`` ``[kv_num_blocks, kv_block, KV]``
(paged), addressed by the same rows as the K/V they scale.

JAX keeps one ``cache_index`` per layer plus a top-level ``pos_index``;
every call moves them in lockstep, so the port keeps one counter (a
tensor of one a lane in the paged and dense stacked layouts).

The solo decode entry points follow JAX's: ``generate`` (greedy, or
sampled through ``tf_operator_tpu_torch/random.py`` with an optional
nucleus ``top_p``), ``generate_segments``/``generate_segmented`` (greedy,
in fixed segments) and ``ChunkedPrefill``/``prefill_chunked`` (the prompt
in fixed chunks). They run eagerly over the dense cache: where JAX
compiles a loop, the port has nothing to compile.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.ops import attention
from tf_operator_tpu_torch.ops.int8_dense import int8_apply
from tf_operator_tpu_torch.ops.paged_attention import (
    paged_attend,
    paged_attend_reference,
)
from tf_operator_tpu_torch.random import categorical, split

_NEG_INF = -1e30

# A layer's cache leaves, K/V then (kv_int8 only) their scales: the paged
# pool's and, in the same order, the dense rows holding the same data.
POOL_NAMES = ("pool_key", "pool_value", "pool_key_scale", "pool_value_scale")
DENSE_NAMES = ("cached_key", "cached_value", "key_scale", "value_scale")


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # Grouped-query attention: K/V carry this many heads (None = MHA and
    # the fused qkv projection).
    n_kv_heads: int | None = None
    # Block-paged decode KV (serving): one pool of kv_num_blocks blocks of
    # kv_block tokens per layer, addressed through per-lane block tables.
    kv_paged: bool = False
    kv_block: int = 64
    kv_num_blocks: int = 0
    # Paged read: "gather" (the reference oracle: the pool gathered back
    # to the dense layout) or "kernel" (the hand-written CUDA kernel,
    # ops/paged_attention.py, that reads only the blocks a lane owns).
    kv_attend: str = "gather"
    # Decode mode: the KV-cache forward (prefill and paged steps) with
    # weights stored in ``dtype``; otherwise the training forward over f32
    # weights.
    decode: bool = False
    # Training: recompute each block's activations in the backward
    # (torch.utils.checkpoint) instead of storing them.
    remat: bool = False
    # Decode mode: int8 K/V with per-(token, head) f32 scales, and int8
    # weight-only projections and head (a quantize_decode_params tree).
    kv_int8: bool = False
    int8_decode: bool = False
    # Mixture-of-Experts: block i (from 0) swaps its dense MLP for a
    # routed expert MLP (models/moe.py) when (i + 1) % moe_every_n == 0.
    # Train with make_lm_train_step(aux_loss_weight=...) so the
    # load-balancing loss counts.
    moe_every_n: int | None = None
    moe_experts: int = 8
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1  # 1 = Switch, 2 = GShard top-2
    # A mesh (parallel/mesh.py) of data axes, ep, sp and tp in training, of
    # tp and dp in decode mode; pp trains through train/pp_lm.py, whose
    # stages take none. The MoE experts split over ep_axis, their rows
    # over batch_axis.
    mesh: Any = None
    ep_axis: str = "ep"
    batch_axis: str = "dp"
    # Sequence parallelism (training over a mesh whose seq_axis is above
    # 1): each rank runs its block of T / sp positions and attention is
    # "stream" (parallel/ring_attention.py's ring_attention, which takes
    # ring_kv_chunk), "flash" (ring_flash_attention, the kernels B1-B3 on
    # the card), "ulysses" (parallel/ulysses.py) or "auto": on the card
    # flash unless ring_kv_chunk is set (a block the kernels do not take
    # then raises, as ops.attention does; there is no quiet fallback to
    # the plain stream ring), stream on the CPU and with ring_kv_chunk.
    seq_axis: str = "sp"
    ring_kv_chunk: int | None = None
    ring_impl: str = "auto"

    # The fields that fix the params tree's shapes; the MoE ones only when
    # MoE is on.
    SHAPE_FIELDS = ("vocab_size", "d_model", "n_heads", "n_kv_heads",
                    "n_layers", "d_ff", "max_seq_len")
    MOE_SHAPE_FIELDS = ("moe_every_n", "moe_experts")

    def shape_fields(self) -> dict:
        """What fixes the params tree's shapes: a checkpoint manifest's
        record of the model. A dense model's record has no MoE field, so
        it reads as it did before MoE was ported."""
        fields = self.SHAPE_FIELDS + (self.MOE_SHAPE_FIELDS
                                      if self.moe_every_n else ())
        return {f: getattr(self, f) for f in fields}

    def __post_init__(self):
        if self.mesh is not None:
            from tf_operator_tpu_torch.parallel.mesh import (
                check_data_parallel,
                check_decode_mesh,
            )

            if self.decode and ("tp" in self.mesh.axis_names
                                or self.use_ring):
                tp, _ = check_decode_mesh(self.mesh,
                                          "TransformerConfig.mesh")
                if self.n_heads % tp:
                    raise ValueError(
                        f"tp={tp} must divide n_heads={self.n_heads} (each "
                        "rank holds n_heads / tp query heads)")
                if (self.kv_attend == "kernel" and tp > 1
                        and self.kv_heads % tp):
                    raise ValueError(
                        f"paged_attend: KV={self.kv_heads} does not tile "
                        f"tp={tp} — use kv_attend='gather' for this mesh")
            else:
                check_data_parallel(self.mesh, "TransformerConfig.mesh")
        if self.use_ring:
            if self.ring_impl not in ("auto", "stream", "flash", "ulysses"):
                raise ValueError(
                    f"ring_impl={self.ring_impl!r}: expected 'auto', "
                    f"'stream', 'flash', or 'ulysses'")
            if (self.ring_impl in ("flash", "ulysses")
                    and self.ring_kv_chunk is not None):
                raise ValueError(
                    f"ring_impl={self.ring_impl!r} ignores ring_kv_chunk; "
                    "use ring_impl='stream' (or 'auto') with ring_kv_chunk")
        if self.n_kv_heads is not None and (
            self.n_kv_heads <= 0 or self.n_heads % self.n_kv_heads
        ):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be a positive "
                f"divisor of n_heads={self.n_heads}"
            )
        if self.kv_paged:
            if self.kv_block < 1:
                raise ValueError(f"kv_block={self.kv_block} must be >= 1")
            if self.max_seq_len % self.kv_block:
                raise ValueError(
                    f"max_seq_len={self.max_seq_len} must be a multiple "
                    f"of kv_block={self.kv_block} (block tables address "
                    "whole blocks)"
                )
            if self.kv_num_blocks < 2:
                raise ValueError(
                    f"kv_num_blocks={self.kv_num_blocks} must be >= 2 "
                    "(block 0 is the pinned garbage block)"
                )
        if self.kv_attend not in ("gather", "kernel"):
            raise ValueError(
                f"kv_attend={self.kv_attend!r}: expected 'gather' or "
                "'kernel'"
            )
        if self.kv_attend == "kernel" and not self.kv_paged:
            raise ValueError(
                "kv_attend='kernel' requires kv_paged=True (the kernel "
                "consumes the block table)"
            )

    def uses_moe(self, layer: int) -> bool:
        """Whether block ``layer`` (from 0) takes the MoE MLP."""
        return bool(self.moe_every_n) and (layer + 1) % self.moe_every_n == 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def use_ring(self) -> bool:
        return (self.mesh is not None
                and self.mesh.shape.get(self.seq_axis, 1) > 1)


def seq_parallel(cfg: TransformerConfig):
    """The ``TensorParallel`` of the config's sequence axis (this rank's
    index on it, its size and its group) when the model trains
    sequence-parallel, else None."""
    if not cfg.use_ring or cfg.decode:
        return None
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    return TensorParallel(cfg.mesh, cfg.seq_axis)


@dataclass(frozen=True)
class TpPlan:
    """This rank's part of a tensor-parallel model: ``tp`` (the
    ``TensorParallel``), whether the weights are split (``split``; an
    int8 decode tree is whole on every rank), whether it trains
    (``train``), and the ``(start, length)`` it holds of the query heads,
    the KV heads, ``d_ff`` and the vocabulary, None where the dimension
    does not tile tp (whole on every rank).

    In training each leaf's gradient follows one of three rules, which
    the modules below keep:

    1. A split leaf (``param_sharding_rules`` cut it) has a gradient of
       its own on each rank, never summed over tp.
    2. A whole leaf that every rank uses alike on the replicated residual
       stream (the norms' scales, the position table, the row-split
       projections' biases added after their all-reduce, the MoE experts,
       the whole attention when ``n_heads`` does not tile, a whole MLP,
       embedding or head) has the same gradient on every rank: summing it
       would count it tp times.
    3. A whole leaf that each rank uses in part (a column split's bias
       sliced at use, the head's bias under a vocabulary split, a GQA
       ``attn/kv`` that is whole because KV < tp and of which each rank
       reads the heads its queries group to) enters through
       ``tp.copy``, so that its partial gradients are summed over tp.

    The activations follow Megatron's pairs: the replicated input of a
    split product enters through ``tp.copy`` (its gradient summed), the
    partial products leave through ``tp.reduce`` (summed forward, the
    identity backward), the split head's logits through ``tp.gather``."""

    tp: Any
    split: bool
    train: bool
    heads: tuple | None
    kv: tuple | None
    ff: tuple | None
    vocab: tuple | None

    @property
    def share(self):
        """The ``TensorParallel`` whose ``copy`` sums a rule-3 leaf's
        gradient: ``tp`` in training, None in decode (no gradient)."""
        return self.tp if self.train else None


def tp_plan(cfg: TransformerConfig) -> TpPlan | None:
    """The ``TpPlan`` of a config over a mesh with a ``tp`` axis (None
    otherwise), from ``parallel/sharding.py``'s ``TensorParallel`` of the
    mesh: what ``param_sharding_rules`` gives this rank."""
    if cfg.mesh is None or "tp" not in cfg.mesh.axis_names:
        return None
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    tp = TensorParallel(cfg.mesh, "tp")
    n, r = tp.size, tp.index

    def part(total: int):
        return None if total % n else (r * (total // n), total // n)

    return TpPlan(tp=tp, split=not (cfg.decode and cfg.int8_decode),
                  train=not cfg.decode, heads=part(cfg.n_heads),
                  kv=part(cfg.kv_heads), ff=part(cfg.d_ff),
                  vocab=part(cfg.vocab_size))


def param_sharding_rules(tp_axis: str = "tp") -> dict[str, tuple]:
    """JAX's tensor-parallel rules (path substring -> spec): QKV and the
    MLP's in-projection split their output, the out-projections their
    input, the embedding and the head the vocabulary (the Megatron
    pairing: one all-reduce a block a direction)."""
    return {
        "qkv/kernel": (None, None, tp_axis, None),  # [d_model,3,heads,head_dim]
        # GQA split projections: q shards its head dim like qkv; kv shards
        # the KV-head dim (kept whole when n_kv_heads % tp != 0).
        "attn/q/kernel": (None, tp_axis, None),  # [d_model,heads,head_dim]
        "attn/kv/kernel": (None, None, tp_axis, None),  # [d,2,kv,head_dim]
        "attn/out/kernel": (tp_axis, None, None),  # [heads,head_dim,d_model]
        "mlp/in_proj/kernel": (None, tp_axis),  # [d_model,d_ff]
        "mlp/out_proj/kernel": (tp_axis, None),  # [d_ff,d_model]
        "embed/embedding": (tp_axis, None),  # vocab split
        "lm_head/kernel": (None, tp_axis),  # vocab split
    }


class _Store:
    """Where a module keeps its weights: f32 and trainable (training), or
    in the compute ``dtype`` with no gradient (``decode``)."""

    def __init__(self, dtype: torch.dtype, decode: bool, device,
                 plan: "TpPlan | None" = None, sp=None):
        self.dtype = dtype if decode else torch.float32
        self.trainable = not decode
        self.device = device
        self.plan = plan
        self.sp = sp

    def param(self, shape, dtype=None) -> nn.Parameter:
        dtype = dtype or self.dtype
        return nn.Parameter(
            torch.zeros(shape, dtype=dtype, device=self.device),
            requires_grad=self.trainable and dtype.is_floating_point)


def _kv8_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """kv_int8's symmetric per-(token, head) quantizer, bitwise JAX's:
    ``[..., Dh]`` -> (int8 values, f32 absmax/127 scales over Dh, the
    absmax floored at 1e-8). One copy for the dense rows and the paged
    pool, so a prefill scattered into the pool lands the same bits. Its
    callers quantize K and V stacked, in one pass: each row is its own."""
    xf = x.float()
    s = xf.abs().amax(-1).clamp_min(1e-8) / 127.0
    return torch.round(xf / s[..., None]).to(torch.int8), s


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` over the trailing ``in_shape`` axes: kernel
    ``[*in_shape, *out_shape]``, bias ``[*out_shape]``, computed in
    ``dtype`` (flax promotes inputs and params to ``dtype``; a weight
    already stored in it is not copied).

    A rank's part of a tensor-parallel projection keeps the whole bias, as
    the rules leave it: ``bias_slice`` ``(dim, start, length)`` is its
    columns of it (a projection split on its output), and ``reduce`` (a
    ``TensorParallel``) sums the partial products over the ranks before
    the bias is added (a projection split on its input). In training,
    ``share`` is the ``TensorParallel`` whose ``copy`` takes the leaves
    this rank uses in part (``TpPlan`` rule 3): the sliced bias, and with
    ``share_kernel`` the kernel too."""

    def __init__(self, in_shape, out_shape, dtype, store: _Store,
                 param_dtype=None, *, bias_shape=None, bias_slice=None,
                 reduce=None, share=None, share_kernel=False):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = store.param(self.in_shape + self.out_shape, param_dtype)
        self.bias = store.param(tuple(bias_shape or self.out_shape),
                                param_dtype)
        self.bias_slice = bias_slice
        self.reduce = reduce
        self.share, self.share_kernel = share, share_kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.dim() - len(self.in_shape)]
        k, n = math.prod(self.in_shape), math.prod(self.out_shape)
        dt = self.dtype
        kernel, bias = self.kernel, self.bias
        if self.share is not None and self.share_kernel:
            kernel, bias = self.share.copy(kernel), self.share.copy(bias)
        y = x.reshape(*lead, k).to(dt) @ kernel.reshape(k, n).to(dt)
        if self.reduce is not None:
            y = self.reduce.reduce(y)
        if self.bias_slice is not None:
            if self.share is not None:
                bias = self.share.copy(bias)
            bias = bias.narrow(*self.bias_slice)
        y = y + bias.reshape(n).to(dt)
        return y.reshape(*lead, *self.out_shape)


class Int8Dense(nn.Module):
    """JAX's ``Int8Dense`` over the trailing ``in_shape`` axes: int8
    ``kernel_q [prod(in_shape), prod(out_shape)]``, f32 ``scale`` and
    ``bias`` ``[prod(out_shape)]``; ``int8_apply`` in f32 plus the bias,
    cast to ``out_dtype`` (in one launch of the kernel, which adds the
    bias and casts in its epilogue), reshaped to ``out_shape``."""

    def __init__(self, in_shape, out_shape, out_dtype, store: _Store):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.out_dtype = out_dtype
        k, n = math.prod(self.in_shape), math.prod(self.out_shape)
        self.kernel_q = store.param((k, n), torch.int8)
        self.scale = store.param((n,), torch.float32)
        self.bias = store.param((n,), torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.dim() - len(self.in_shape)]
        x = x.reshape(*lead, self.kernel_q.shape[0])
        y = int8_apply(x, self.kernel_q, self.scale, self.out_dtype,
                       self.bias)
        return y.reshape(*lead, *self.out_shape)


def _dense(cfg: TransformerConfig, store: _Store, in_shape,
           out_shape) -> nn.Module:
    """A projection in ``cfg.dtype``: ``Int8Dense`` in an ``int8_decode``
    decode model, else ``DenseGeneral``."""
    if cfg.decode and cfg.int8_decode:
        return Int8Dense(in_shape, out_shape, cfg.dtype, store)
    return DenseGeneral(in_shape, out_shape, cfg.dtype, store)


class Embed(nn.Module):
    """flax ``nn.Embed``: the looked-up rows in ``dtype``.

    Each device reads the rows through the op whose backward sums a row's
    gradients in one order, so that a resumed run ends bitwise on an
    uninterrupted one (ROADMAP C2). On the card that is indexing
    (``index_put_`` with accumulate sorts the ids first): ``F.embedding``'s
    CUDA backward over more than 3072 ids sums in an order that changes
    from call to call. On the CPU it is ``F.embedding``: indexing's CPU
    backward adds rows with atomics across threads. Both read the same
    rows."""

    def __init__(self, num, features, dtype, store: _Store):
        super().__init__()
        self.dtype = dtype
        self.weight = store.param((num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.is_cuda:
            return self.weight[ids.long()].to(self.dtype)
        return F.embedding(ids, self.weight).to(self.dtype)


class VocabEmbed(Embed):
    """A rank's rows ``[start, start + num)`` of a vocabulary-split
    embedding: a gather of the ids it holds (through ``Embed``'s op, so
    that the backward keeps its one order), exact zeros for the others,
    then the sum over ``tp`` that adds the one rank's row to the other
    ranks' zeros (``tp.reduce``: in training its backward hands every
    rank the whole gradient, and the ids a rank does not hold add exact
    zeros to its rows)."""

    def __init__(self, num, features, dtype, store: _Store, *, start: int,
                 tp):
        super().__init__(num, features, dtype, store)
        self.start, self.tp = int(start), tp

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids.long() - self.start
        held = (local >= 0) & (local < self.weight.shape[0])
        local = local.clamp(0, self.weight.shape[0] - 1)
        rows = (self.weight[local] if ids.is_cuda
                else F.embedding(local, self.weight))
        out = torch.where(held[..., None], rows, 0).to(self.dtype)
        return self.tp.reduce(out)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: f32 statistics, eps 1e-6, ``x * (rsqrt(var +
    eps) * scale)`` in f32, cast to ``dtype``."""

    eps = 1e-6

    def __init__(self, features, dtype, store: _Store):
        super().__init__()
        self.dtype = dtype
        self.scale = store.param((features,), torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps) * self.scale)).to(
            self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, store: _Store):
        super().__init__()
        self.cfg = cfg
        d, h, dh, kv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads
        plan = self.plan = store.plan
        self.sp = store.sp
        # Under tp: which query and K/V heads this rank attends over (the
        # slices taken after whole int8 projections), and, when KV does
        # not tile, the KV head each of its query heads reads. Query
        # heads that do not tile tp (training only) leave the attention
        # whole on every rank.
        self.head_cut = self.kv_cut = self.kv_map = self.tp_in = None
        if plan is not None and plan.heads is None:
            plan = None
        if plan is not None:
            (hlo, hn), kvc = plan.heads, plan.kv
            self.kv_map = (None if kvc is not None else torch.arange(
                hlo, hlo + hn, device=store.device) // (h // kv))
            if not plan.split:
                self.head_cut, self.kv_cut = (hlo, hn), kvc
        if plan is not None and plan.split:
            # Megatron pairs: q/kv (or qkv) split on heads, the whole bias
            # sliced; out split on its input and all-reduced. A whole kv
            # (KV < tp) is read in part on each rank (TpPlan rule 3).
            (hlo, hn), kvc = plan.heads, plan.kv
            share = plan.share
            self.tp_in = share
            if cfg.n_kv_heads is not None:
                self.q = DenseGeneral((d,), (hn, dh), cfg.dtype, store,
                                      bias_shape=(h, dh),
                                      bias_slice=(0, hlo, hn), share=share)
                if kvc is None:
                    self.kv = DenseGeneral((d,), (2, kv, dh), cfg.dtype,
                                           store, share=share,
                                           share_kernel=True)
                else:
                    self.kv = DenseGeneral((d,), (2, kvc[1], dh), cfg.dtype,
                                           store, bias_shape=(2, kv, dh),
                                           bias_slice=(1, *kvc), share=share)
            else:
                self.qkv = DenseGeneral((d,), (3, hn, dh), cfg.dtype, store,
                                        bias_shape=(3, h, dh),
                                        bias_slice=(1, hlo, hn), share=share)
            self.out = DenseGeneral((hn, dh), (d,), cfg.dtype, store,
                                    reduce=plan.tp)
            return
        if cfg.n_kv_heads is not None:
            # GQA: separate projections, K/V carry only kv_heads.
            self.q = _dense(cfg, store, (d,), (h, dh))
            self.kv = _dense(cfg, store, (d,), (2, kv, dh))
        else:
            self.qkv = _dense(cfg, store, (d,), (3, h, dh))
        self.out = _dense(cfg, store, (h, dh), (d,))

    def _heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The K/V heads (on ``dim``) each of this rank's query heads
        reads, one a query head, when KV does not tile tp; else ``x``."""
        return x if self.kv_map is None else x.index_select(dim, self.kv_map)

    def forward(self, x, layer: dict | None = None, cache: dict | None = None,
                live=None) -> torch.Tensor:
        if self.tp_in is not None:
            x = self.tp_in.copy(x)
        if self.cfg.n_kv_heads is not None:
            q = self.q(x)
            kv = self.kv(x)
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            qkv = self.qkv(x)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.head_cut is not None:
            # Whole int8 projections: this rank's heads of their outputs.
            q = q.narrow(2, *self.head_cut).contiguous()
            if self.kv_cut is not None:
                k, v = k.narrow(2, *self.kv_cut), v.narrow(2, *self.kv_cut)
        if not self.cfg.decode:
            out = self._attend(q, k, v)
        elif "pool_key" in layer:
            out = self._decode_attend_paged(
                q, k, v, layer, cache["block_table"], cache["cache_index"],
                live,
            )
        else:
            out = self._decode_attend(q, k, v, layer, cache["cache_index"])
        if self.head_cut is not None:
            # The heads' outputs meet the whole int8 out-projection.
            out = self.plan.tp.all_gather(out, 2)
        return self.out(out)

    def _attend(self, q, k, v):
        """Training attention, causal over the whole sequence. Under GQA
        K/V are repeated to full heads first (``jnp.repeat`` on the head
        axis: each KV head serves its g query heads in a row), so the
        kernels see the MHA layout; the saving is the smaller projection.
        A tensor-parallel rank whose KV heads are whole reads the one each
        of its query heads groups to. Sequence-parallel, ``q``, ``k`` and
        ``v`` are this rank's block of the sequence and its heads, and
        ``ring_impl`` picks the strategy (JAX's dispatch)."""
        if self.kv_map is not None:
            k, v = self._heads(k, 2), self._heads(v, 2)
        else:
            g = q.shape[2] // k.shape[2]
            if g > 1:
                k = k.repeat_interleave(g, dim=2)
                v = v.repeat_interleave(g, dim=2)
        if self.sp is None:
            return attention(q, k, v, causal=True)
        from tf_operator_tpu_torch.parallel.ring_attention import (
            ring_attention,
            ring_flash_attention,
        )

        cfg = self.cfg
        if cfg.ring_impl == "ulysses":
            from tf_operator_tpu_torch.parallel.ulysses import (
                ulysses_attention,
            )

            return ulysses_attention(q, k, v, self.sp, causal=True)
        # "auto" is flash on the card, as JAX's is on the TPU; a block the
        # kernels do not take raises there (flash_fwd) rather than running
        # the plain stream ring.
        if cfg.ring_impl == "flash" or (
                cfg.ring_impl == "auto" and cfg.ring_kv_chunk is None
                and q.is_cuda):
            return ring_flash_attention(q, k, v, self.sp, causal=True)
        return ring_attention(q, k, v, self.sp, causal=True,
                              kv_chunk=cfg.ring_kv_chunk)

    def _decode_attend(self, q, k, v, layer: dict, idx):
        """Block attention against the dense cache (t >= 1 tokens; a
        multi-token call is prompt prefill, block-causal). The t new rows
        are written at ``idx`` in place; query row i sees keys at
        positions <= idx + i. Columns past idx + t are masked to exactly 0
        by the softmax, so they are left out of the products. A ``[b]``
        tensor ``idx`` puts each lane at its own counter
        (``_decode_attend_lanes``)."""
        if isinstance(idx, torch.Tensor):
            return self._decode_attend_lanes(q, k, v, layer, idx)
        b, t, h, dh = q.shape
        ck, cv = layer["cached_key"], layer["cached_value"]
        if idx + t > ck.shape[1]:
            raise ValueError(
                f"cache index {idx} + {t} tokens exceeds max_seq_len "
                f"{ck.shape[1]}"
            )
        kv8 = self.cfg.kv_int8
        if kv8:
            (k, v), (ks, vs) = _kv8_quant(torch.stack((k, v)))
            layer["key_scale"][:, idx:idx + t] = ks
            layer["value_scale"][:, idx:idx + t] = vs
        ck[:, idx:idx + t] = k
        cv[:, idx:idx + t] = v
        n = idx + t
        keys = self._heads(ck[:, :n], 2).float()
        vals = self._heads(cv[:, :n], 2).float()
        kv = keys.shape[2]
        g = h // kv
        qg = q.reshape(b, t, kv, g, dh).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, keys)
        if kv8:
            # The kv8 factoring: the raw int8 keys' scores times the key
            # scale, then Dh^-1/2; the value scale on the probabilities.
            s = s * _scale_cols(self._heads(layer["key_scale"][:, :n], 2))
        s = s * dh ** -0.5
        rows = torch.arange(t, device=q.device)
        valid = (torch.arange(n, device=q.device)[None, :]
                 <= (idx + rows)[:, None])  # [t, n]
        s = torch.where(valid, s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        if kv8:
            p = p * _scale_cols(self._heads(layer["value_scale"][:, :n], 2))
        out = torch.einsum("bkgqs,bskd->bqkgd", p, vals)
        return out.reshape(b, t, h, dh).to(self.cfg.dtype)

    def _decode_attend_lanes(self, q, k, v, layer: dict, idx: torch.Tensor):
        """``_decode_attend`` with a counter a lane (``idx`` ``[b]``), as
        JAX's vmapped solo forward runs it: lane b writes its t rows at
        rows ``idx[b]..idx[b] + t - 1`` (the start clamped to
        ``max_seq_len - t``, as ``dynamic_update_slice`` clamps it), and
        its query row i reads the whole cache with keys past ``idx[b] + i``
        masked. No host sync: the engine's budget keeps every live lane's
        rows inside the cache."""
        b, t, h, dh = q.shape
        ck, cv = layer["cached_key"], layer["cached_value"]
        n = ck.shape[1]
        steps = torch.arange(t, device=q.device)
        rows = idx.long().clamp(max=n - t)[:, None] + steps[None, :]
        lanes = torch.arange(b, device=q.device)[:, None]
        kv8 = self.cfg.kv_int8
        if kv8:
            (k, v), (ks, vs) = _kv8_quant(torch.stack((k, v)))
            layer["key_scale"][lanes, rows] = ks
            layer["value_scale"][lanes, rows] = vs
        ck[lanes, rows] = k.to(ck.dtype)
        cv[lanes, rows] = v.to(cv.dtype)
        keys = self._heads(ck, 2).float()
        kv = keys.shape[2]
        g = h // kv
        qg = q.reshape(b, t, kv, g, dh).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, keys)
        if kv8:
            s = s * _scale_cols(self._heads(layer["key_scale"], 2))
        s = s * dh ** -0.5
        valid = (torch.arange(n, device=q.device)[None, None, :]
                 <= (idx.long()[:, None] + steps[None, :])[:, :, None])
        s = torch.where(valid[:, None, None], s, _NEG_INF)  # [b, t, n]
        p = torch.softmax(s, dim=-1)
        if kv8:
            p = p * _scale_cols(self._heads(layer["value_scale"], 2))
        out = torch.einsum("bkgqs,bskd->bqkgd", p,
                           self._heads(cv, 2).float())
        return out.reshape(b, t, h, dh).to(self.cfg.dtype)

    def _decode_attend_paged(self, q, k, v, layer: dict, table, idx, live):
        """Block-paged decode attention. Each lane's t new K/V rows go to
        flat pool row ``table[pos // blk] * blk + pos % blk``, in place;
        then the read dispatches on ``kv_attend``. Lanes at index 0 are
        inactive and their writes are dropped: JAX routes them out of
        range with ``mode="drop"``, which ``index_put_`` has no twin of,
        so only the rows of ``live`` lanes are written."""
        b, t, h, dh = q.shape
        pool_k = layer["pool_key"]
        nb, blk = pool_k.shape[:2]
        pos = idx.long()[:, None] + torch.arange(t, device=q.device)[None, :]
        entry = (pos // blk).clamp(0, table.shape[1] - 1)
        flat = table.long().gather(1, entry) * blk + pos % blk  # [b, t]
        rows = flat[live].reshape(-1)
        new = {"pool_key": k, "pool_value": v}
        scales = {}
        if self.cfg.kv_int8:
            # The shared quantizer: the pool gets the bits the dense rows
            # get. The scale pools ride the same flat rows.
            (k8, v8), (ks, vs) = _kv8_quant(torch.stack((k, v)))
            new = {"pool_key": k8, "pool_value": v8, "pool_key_scale": ks,
                   "pool_value_scale": vs}
            scales = {"k_scale_pool": layer["pool_key_scale"],
                      "v_scale_pool": layer["pool_value_scale"]}
        for name, x in new.items():
            pool = layer[name]
            pool.view(nb * blk, *pool.shape[2:])[rows] = x[live].reshape(
                -1, *pool.shape[2:])
        if self.kv_map is not None:
            # KV does not tile tp (the kernel read refuses it): the gather
            # reads each query head's KV head.
            return paged_attend_reference(
                q, pool_k, layer["pool_value"], table, idx,
                kv_heads=self.kv_map, **scales).to(self.cfg.dtype)
        attend = (paged_attend if self.cfg.kv_attend == "kernel"
                  else paged_attend_reference)
        return attend(q, pool_k, layer["pool_value"], table, idx,
                      **scales).to(self.cfg.dtype)


def _scale_cols(scale: torch.Tensor) -> torch.Tensor:
    """Per-(token, head) scales ``[b, S, KV]`` broadcast over the grouped
    score layout ``[b, KV, g, t, S]``."""
    return scale.transpose(1, 2)[:, :, None, None, :]


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)
_GELU_A = 0.044715


class _RoundedGelu(torch.autograd.Function):
    """The tanh gelu with a rounding after every operation, in the input's
    dtype (``gelu``). The forward keeps only ``x``; the backward is
    ``F.gelu``'s own (one pass: the derivative times the incoming gradient
    in f32, rounded to ``x``'s dtype once)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        # The constants rounded to x's dtype, as Python numbers: a product
        # with one is computed in f32 and rounded, as JAX's with the
        # rounded constant, and no tensor goes to the device.
        c, a = (torch.tensor(v, dtype=x.dtype).item()
                for v in (_SQRT_2_OVER_PI, _GELU_A))
        inner = c * (x + a * (x * (x * x)))
        return x * (0.5 * (1.0 + torch.tanh(inner)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x, approximate="tanh")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``, the tanh form ``x * 0.5 * (1 + tanh(sqrt(2/pi) *
    (x + 0.044715 x^3)))``, rounded where JAX rounds it. In f32 one
    ``F.gelu``. In a narrower dtype JAX rounds after every operation of
    the formula, its constants rounded to that dtype and ``x^3`` as ``x *
    (x * x)`` (``integer_pow``'s square-and-multiply); so does this, where
    ``F.gelu`` would compute in f32 and round once."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    return _RoundedGelu.apply(x)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, store: _Store):
        super().__init__()
        plan = store.plan
        self.tp_in = None
        if plan is not None and plan.split and plan.ff is not None:
            # in_proj split on d_ff (its bias sliced), out_proj on its
            # input, all-reduced.
            lo, n = plan.ff
            self.tp_in = plan.share
            self.in_proj = DenseGeneral((cfg.d_model,), (n,), cfg.dtype,
                                        store, bias_shape=(cfg.d_ff,),
                                        bias_slice=(0, lo, n),
                                        share=plan.share)
            self.out_proj = DenseGeneral((n,), (cfg.d_model,), cfg.dtype,
                                         store, reduce=plan.tp)
            return
        self.in_proj = _dense(cfg, store, (cfg.d_model,), (cfg.d_ff,))
        self.out_proj = _dense(cfg, store, (cfg.d_ff,), (cfg.d_model,))

    def forward(self, x):
        if self.tp_in is not None:
            x = self.tp_in.copy(x)
        return self.out_proj(gelu(self.in_proj(x)))


class Block(nn.Module):
    """Pre-norm attention, then the dense MLP or (``use_moe``) the routed
    expert MLP, each with its residual. The MoE MLP is ``moe`` (flax's
    ``block_i/moe``) and keeps its weights unquantized in an
    ``int8_decode`` model, as JAX's does."""

    def __init__(self, cfg: TransformerConfig, store: _Store,
                 use_moe: bool = False):
        super().__init__()
        self.norm_attn = RMSNorm(cfg.d_model, cfg.dtype, store)
        self.attn = Attention(cfg, store)
        self.norm_mlp = RMSNorm(cfg.d_model, cfg.dtype, store)
        self.mlp = self.moe = None
        if use_moe:
            from tf_operator_tpu_torch.models.moe import MoeConfig, MoeMlp

            self.moe = MoeMlp(MoeConfig(
                n_experts=cfg.moe_experts, d_model=cfg.d_model,
                d_ff=cfg.d_ff, capacity_factor=cfg.moe_capacity_factor,
                router_top_k=cfg.moe_top_k, dtype=cfg.dtype,
                ep_axis=cfg.ep_axis, data_axis=cfg.batch_axis,
                mesh=cfg.mesh), store)
            self.moe.seq_parallel = store.sp
        else:
            self.mlp = MLP(cfg, store)

    def forward(self, x, layer: dict | None = None, cache: dict | None = None,
                live=None):
        """-> (x, the MoE aux loss, or None for a dense block)."""
        x = x + self.attn(self.norm_attn(x), layer, cache, live)
        if self.moe is None:
            return x + self.mlp(self.norm_mlp(x)), None
        y, aux = self.moe(self.norm_mlp(x))
        return x + y, aux


class Transformer(nn.Module):
    """The LM. Training mode (``cfg.decode`` False): ``forward(tokens)``
    runs ``[b, T]`` tokens at positions ``0..T-1`` and returns f32 logits
    ``[b, T, vocab]`` (or the normed hidden state). Decode mode:
    ``forward(tokens, cache)`` runs t >= 1 tokens per lane against
    ``cache`` (dense or paged, see the module docstring) and advances its
    counter in place."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        plan = self.tp_plan = tp_plan(cfg)
        self.seq_parallel = seq_parallel(cfg)
        store = _Store(cfg.dtype, cfg.decode, self.device, plan,
                       self.seq_parallel)
        dt = cfg.dtype
        if plan is not None and plan.split and plan.vocab is not None:
            self.embed = VocabEmbed(plan.vocab[1], cfg.d_model, dt, store,
                                    start=plan.vocab[0], tp=plan.tp)
        else:
            self.embed = Embed(cfg.vocab_size, cfg.d_model, dt, store)
        self.pos = Embed(cfg.max_seq_len, cfg.d_model, dt, store)
        self.blocks = nn.ModuleList(
            Block(cfg, store, use_moe=cfg.uses_moe(i))
            for i in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.d_model, dt, store)
        # The head runs in f32 on an f32 cast of the hidden state; the
        # int8 head rounds it to bf16, as every Int8Dense does.
        if cfg.decode and cfg.int8_decode:
            self.lm_head = Int8Dense((cfg.d_model,), (cfg.vocab_size,),
                                     torch.float32, store)
        elif plan is not None and plan.split and plan.vocab is not None:
            # The vocabulary split: this rank's columns, the whole bias
            # sliced; _head_logits gathers the ranks' logits.
            lo, n = plan.vocab
            self.lm_head = DenseGeneral(
                (cfg.d_model,), (n,), torch.float32, store,
                param_dtype=torch.float32, bias_shape=(cfg.vocab_size,),
                bias_slice=(0, lo, n), share=plan.share)
        else:
            self.lm_head = DenseGeneral((cfg.d_model,), (cfg.vocab_size,),
                                        torch.float32, store,
                                        param_dtype=torch.float32)

    def shape_fields(self) -> dict:
        """What fixes the params tree's shapes (the config's)."""
        return self.cfg.shape_fields()

    @property
    def kv_heads(self) -> int:
        """The K/V heads this model's caches hold: the config's, or under
        tp this rank's ``KV/tp`` (every KV head when KV does not tile)."""
        plan = self.tp_plan
        if plan is not None and plan.kv is not None:
            return plan.kv[1]
        return self.cfg.kv_heads

    def init_cache(self, batch: int, paged: bool | None = None) -> dict:
        """An empty cache for ``batch`` lanes: paged (pools, tables on the
        pinned block 0, counters 0) when ``paged`` (default
        ``cfg.kv_paged``), else dense rows."""
        cfg = self.cfg
        paged = cfg.kv_paged if paged is None else paged
        kv, dh, dev = self.kv_heads, cfg.head_dim, self.device

        def zeros(*shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        kv_dtype = torch.int8 if cfg.kv_int8 else cfg.dtype

        def layer(rows, names):
            key, value, key_scale, value_scale = names
            out = {key: zeros(*rows, kv, dh, dtype=kv_dtype),
                   value: zeros(*rows, kv, dh, dtype=kv_dtype)}
            if cfg.kv_int8:
                out[key_scale] = zeros(*rows, kv, dtype=torch.float32)
                out[value_scale] = zeros(*rows, kv, dtype=torch.float32)
            return out

        if paged:
            nb, blk = cfg.kv_num_blocks, cfg.kv_block
            return {
                "layers": [layer((nb, blk), POOL_NAMES)
                           for _ in range(cfg.n_layers)],
                "block_table": zeros(batch, cfg.max_seq_len // blk,
                                     dtype=torch.int32),
                "cache_index": zeros(batch, dtype=torch.int32),
            }
        return {
            "layers": [layer((batch, cfg.max_seq_len), DENSE_NAMES)
                       for _ in range(cfg.n_layers)],
            "cache_index": 0,
        }

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                return_hidden: bool = False, return_aux: bool = False):
        """The logits (or with ``return_hidden`` the normed hidden state);
        with ``return_aux`` (training mode) also the sum of the MoE
        layers' aux losses, an f32 scalar (0 for a dense model), as JAX's
        ``apply(..., mutable=["losses"])`` with ``aux_loss_from``."""
        if not self.cfg.decode:
            if cache is not None:
                raise ValueError("a training-mode model takes no cache: "
                                 "build it with decode=True")
            out, aux = self._train_forward(tokens, return_hidden)
            return (out, aux) if return_aux else out
        if return_aux:
            raise ValueError("return_aux is for a training-mode model: "
                             "decode throws the aux loss away")
        if cache is None:
            raise ValueError("a decode-mode model needs a cache "
                             "(init_cache)")
        b, t = tokens.shape
        steps = torch.arange(t, device=tokens.device)
        idx = cache["cache_index"]
        live = None
        if "block_table" in cache:
            # Per-lane counters; lanes at 0 are inactive. One host sync per
            # call finds the live lanes for every layer's write.
            positions = idx.long()[:, None] + steps[None, :]
            live = torch.nonzero(idx > 0).squeeze(1)
        elif isinstance(idx, torch.Tensor):
            # The dense stacked layout: a counter a lane. Positions clamp
            # to the table, as JAX's gather clamps them.
            positions = (idx.long()[:, None] + steps[None, :]).clamp(
                max=self.cfg.max_seq_len - 1)
        else:
            positions = (idx + steps)[None, :].expand(b, t)
        x = self.embed(tokens) + self.pos(positions)
        for block, layer in zip(self.blocks, cache["layers"]):
            # An MoE block's aux loss is thrown away, as flax's sow is
            # without mutable=["losses"].
            x, _ = block(x, layer, cache, live)
        if isinstance(idx, torch.Tensor):
            idx.add_(t)
        else:
            cache["cache_index"] = idx + t
        x = self.norm(x)
        return x if return_hidden else _head_logits(self, x)

    def _train_forward(self, tokens: torch.Tensor, return_hidden: bool):
        """-> (logits or hidden, aux). Under ``remat`` each block is
        checkpointed and returns its aux as an output, so the backward's
        recomputation does not count it again."""
        from tf_operator_tpu_torch.models.moe import aux_loss_from

        t = tokens.shape[1]
        # Sequence-parallel, ``tokens`` is this rank's block of a sequence
        # of t * sp positions, from position sp_index * t.
        sp = self.seq_parallel
        start, total = (0, t) if sp is None else (sp.index * t, sp.size * t)
        if total > self.cfg.max_seq_len:
            raise ValueError(f"{total} tokens exceed max_seq_len "
                             f"{self.cfg.max_seq_len}")
        positions = start + torch.arange(t, device=tokens.device)[None, :]
        x = self.embed(tokens) + self.pos(positions)
        auxes = []
        for block in self.blocks:
            if self.cfg.remat:
                x, aux = checkpoint(block, x, use_reentrant=False)
            else:
                x, aux = block(x)
            auxes.append(aux)
        x = self.norm(x)
        aux = aux_loss_from(auxes, x.device)
        return (x if return_hidden else _head_logits(self, x)), aux


def set_cache_index(cache: dict, value) -> dict:
    """Set the cache's position counter to ``value`` (in place; returns
    the cache). K/V rows are untouched: attention masks positions past
    the counter, so rewriting it is the rollback. ``value`` is a number,
    or a tensor that broadcasts against the ``[b]`` counters of the paged
    and dense stacked layouts (a speculative engine's per-lane rewind)."""
    idx = cache["cache_index"]
    if not isinstance(idx, torch.Tensor):
        cache["cache_index"] = int(value)
    elif isinstance(value, torch.Tensor):
        idx.copy_(value.to(device=idx.device, dtype=idx.dtype))
    else:
        idx.fill_(int(value))
    return cache


def _head_logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """lm_head projection of normed hidden rows ``[..., d]`` -> f32
    ``[..., vocab]``, dispatching on the head's layout as JAX's does: the
    int8 head on the hidden rows as they are (``int8_apply`` rounds them
    to bf16), the dense head in f32 on an f32 cast. A vocabulary-split
    head's logits are all-gathered, in rank order, to full rows (in
    training its replicated input enters through ``tp.copy``)."""
    if isinstance(model.lm_head, Int8Dense):
        return model.lm_head(h)
    plan = model.tp_plan
    split = plan is not None and plan.split and plan.vocab is not None
    if split and plan.train:
        h = plan.tp.copy(h)
    logits = model.lm_head(h.float())
    if split:
        logits = plan.tp.gather(logits, -1)
    return logits


def _prefill(model: Transformer, prompt: torch.Tensor):
    """Prompt prefill in one block-causal forward over a fresh dense cache
    -> (cache, logits of the last position)."""
    cache = model.init_cache(prompt.shape[0], paged=False)
    hidden = model(prompt, cache, return_hidden=True)
    return cache, _head_logits(model, hidden[:, -1])


def _prefill_extend(model: Transformer, cache: dict, suffix: torch.Tensor):
    """Suffix prefill on a seeded dense cache (rows [0:base) hold a shared
    prefix, the counter sits at base) -> (cache, last-position logits)."""
    hidden = model(suffix, cache, return_hidden=True)
    return cache, _head_logits(model, hidden[:, -1])


def _nucleus_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """JAX's ``_nucleus_filter``: keep the smallest set of tokens whose
    probability mass reaches ``top_p`` (the top token always), the rest
    set to -1e30. The mask is by sorted RANK: the order is a stable
    ascending argsort flipped, as ``jnp.flip(jnp.argsort(...))`` (a
    ``descending=True`` sort would order ties the other way), so exact
    ties at the cutoff keep the later indices first. The softmax is
    ``jax.nn.softmax``'s ``exp(x - max) / sum`` and it and the cumsum run
    in f32. ``top_p`` is a number or a tensor that broadcasts against
    ``logits[..., :1]`` (one value a row)."""
    sort_idx = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    ranked = logits.gather(-1, sort_idx)
    e = torch.exp(ranked - ranked.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    # Keep a token iff the mass BEFORE it is still short of top_p: the
    # crossing token stays, everything after drops.
    keep_sorted = (torch.cumsum(probs, -1) - probs) < top_p
    keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, _NEG_INF)


def _decode_model(cfg: TransformerConfig, params, device) -> Transformer:
    """The decode-mode model of ``cfg`` holding ``params`` on ``device``:
    what every solo decode entry point runs (JAX's ``replace(cfg,
    decode=True, mesh=None, remat=False)``). ``params`` is a flax-layout
    tree (``models/convert.py``), or a decode-mode ``Transformer`` that
    already holds its weights, used as it is (``device`` is then its
    own)."""
    from tf_operator_tpu_torch.models.convert import load_params

    if isinstance(params, Transformer):
        if not params.cfg.decode:
            raise ValueError("a training-mode model cannot decode: build "
                             "it with decode=True")
        return params
    return load_params(
        Transformer(replace(cfg, decode=True, remat=False, mesh=None),
                    device), params)


def generate(cfg: TransformerConfig, params, prompt, num_steps: int, *,
             temperature: float = 0.0, top_p: float | None = None,
             rng=None, device=None) -> torch.Tensor:
    """Autoregressive generation with a KV cache: one batched prompt
    prefill, then ``num_steps`` of sample-and-feed. ``temperature=0`` is
    greedy (argmax, the first maximum); otherwise categorical sampling
    with ``rng`` (a key from ``tf_operator_tpu_torch.random``), optionally
    nucleus-filtered to mass ``top_p``. Step i samples with key i of
    ``split(rng, num_steps)``, so the tokens follow JAX's ``generate`` for
    the same key. Returns ``[B, num_steps]`` int32 tokens on ``device``
    (default the card). ``params`` is a flax-layout tree (a
    ``quantize_decode_params`` tree for ``int8_decode``) or a loaded
    decode-mode model (``_decode_model``)."""
    if prompt.shape[1] + num_steps > cfg.max_seq_len:
        raise ValueError(
            f"prompt {prompt.shape[1]} + steps {num_steps} exceeds "
            f"max_seq_len {cfg.max_seq_len}"
        )
    if temperature > 0 and rng is None:
        raise ValueError("temperature > 0 needs an rng key")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if top_p is not None and temperature <= 0:
        raise ValueError("top_p requires temperature > 0 (greedy ignores it)")
    model = _decode_model(cfg, params, device)
    if rng is not None:
        rng = torch.as_tensor(rng, dtype=torch.int64, device=model.device)
    with torch.no_grad():
        return _generate_fn(model, torch.as_tensor(prompt,
                                                   device=model.device),
                            rng, num_steps, float(temperature),
                            None if top_p is None else float(top_p))


def _generate_fn(model: Transformer, prompt: torch.Tensor, rng, num_steps,
                 temperature: float, top_p: float | None) -> torch.Tensor:
    """The decode loop of JAX's ``_generate_fn`` (a jitted ``lax.scan``
    there; an eager loop here, with nothing to compile): prefill, then per
    step divide by the temperature (a tensor on the model's device, so
    CUDA divides rather than multiplying by a reciprocal), apply the
    nucleus filter, sample with the step's key and feed the token. The
    last token's forward is left out: its logits would go unused."""
    cache, logits = _prefill(model, prompt)
    if temperature > 0:
        keys = split(rng, num_steps)
        temp = torch.tensor(temperature, dtype=torch.float32,
                            device=prompt.device)
    toks = []
    for i in range(num_steps):
        if temperature > 0:
            scaled = logits / temp
            if top_p is not None:
                scaled = _nucleus_filter(scaled, top_p)
            tok = categorical(keys[i], scaled)
        else:
            tok = logits.argmax(-1)
        toks.append(tok.to(torch.int32))
        if i + 1 < num_steps:
            logits = model(toks[-1][:, None], cache)[:, 0]
    return torch.stack(toks, dim=1)


def _decode_segment(model: Transformer, cache: dict, logits: torch.Tensor,
                    segment: int):
    """One greedy segment (JAX's ``_segment_fns`` decode segment): feed
    ``segment`` argmax tokens -> (cache, next logits, ``[B, segment]``
    int32 tokens). Nothing in it waits on the card."""
    toks = []
    for _ in range(segment):
        tok = logits.argmax(-1).to(torch.int32)
        logits = model(tok[:, None], cache)[:, 0]
        toks.append(tok)
    return cache, logits, torch.stack(toks, dim=1)


def _to_host(toks: torch.Tensor):
    """Start copying ``toks`` to the host -> (host tensor, event to wait
    on before reading it; None on the CPU). The copy is queued now, so
    work queued after it does not delay it."""
    if toks.device.type != "cuda":
        return toks, None
    host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
    host.copy_(toks, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def generate_segments(cfg: TransformerConfig, params, prompt,
                      num_steps: int, *, segment: int = 16,
                      prefill_chunk: int | None = None, device=None):
    """Greedy generation in fixed-size segments, as a generator yielding
    each segment's ``[B, <=segment]`` int32 tokens as a host (numpy)
    array. ``prefill_chunk`` runs the prefill through ``prefill_chunked``.

    Overlap: segment i+1 is queued on the card before segment i is
    yielded, and segment i's copy to the host is queued ahead of it, so
    the consumer reads segment i while the card decodes segment i+1.
    That is all the overlap there is: each ``next()`` queues one segment
    and waits for the previous one's tokens.

    Tokens equal ``generate(..., temperature=0)``'s: the same argmax-feed
    recurrence; segmentation only moves the boundaries. The last partial
    segment still decodes ``segment`` tokens and is trimmed on the host,
    so the cache must budget the overshoot: prompt +
    ceil(num_steps/segment)*segment <= cfg.max_seq_len. Every check
    raises here, before the generator runs."""
    if segment < 1:
        raise ValueError(f"segment={segment} must be >= 1")
    if num_steps < 1:
        raise ValueError(f"num_steps={num_steps} must be >= 1")
    n_segments = -(-num_steps // segment)
    if prompt.shape[1] + n_segments * segment > cfg.max_seq_len:
        raise ValueError(
            f"prompt {prompt.shape[1]} + {n_segments} segments of "
            f"{segment} exceeds max_seq_len {cfg.max_seq_len} (the last "
            "partial segment decodes a full segment on device)"
        )
    if prefill_chunk is not None:
        _validate_prefill_chunk(cfg, prompt.shape[1], prefill_chunk)

    def trim(host, done, i):
        if done is not None:
            done.synchronize()
        toks = host.numpy()
        if (i + 1) * segment > num_steps:  # the last segment's overshoot
            return toks[:, : num_steps - i * segment]
        return toks

    def gen():
        model = _decode_model(cfg, params, device)
        tokens = torch.as_tensor(prompt, device=model.device)
        with torch.no_grad():
            if prefill_chunk is not None:
                pf = ChunkedPrefill(model, tokens, prefill_chunk)
                pf.feed(pf.n_chunks)
                cache, logits = pf.result()
            else:
                cache, logits = _prefill(model, tokens)
            cache, logits, toks = _decode_segment(model, cache, logits,
                                                  segment)
            pending = _to_host(toks)
            for i in range(1, n_segments):
                cache, logits, toks = _decode_segment(model, cache, logits,
                                                      segment)
                nxt = _to_host(toks)
                yield trim(*pending, i - 1)
                pending = nxt
        yield trim(*pending, n_segments - 1)

    return gen()


def generate_segmented(cfg: TransformerConfig, params, prompt,
                       num_steps: int, *, segment: int = 16,
                       prefill_chunk: int | None = None, on_segment=None,
                       device=None) -> np.ndarray:
    """Collected form of ``generate_segments``: the full ``[B,
    num_steps]`` int32 tokens as a numpy array, calling
    ``on_segment(tokens)`` for each segment as it lands."""
    chunks = []
    for toks in generate_segments(cfg, params, prompt, num_steps,
                                  segment=segment,
                                  prefill_chunk=prefill_chunk,
                                  device=device):
        chunks.append(toks)
        if on_segment is not None:
            on_segment(toks)
    return np.concatenate(chunks, axis=1)


class ChunkedPrefill:
    """Resumable chunked prefill of one prompt on a decode-mode ``model``
    (JAX's ``ChunkedPrefill``): a serving loop feeds a budgeted number of
    chunks between decode steps; ``prefill_chunked`` runs it to the end.

    The last partial chunk is RIGHT-PADDED to the chunk: pad positions
    sit after every true position, so no true position attends one
    (causal), and their rows lie past the true length, where
    ``set_cache_index`` rolls the counter back (decode overwrites them).
    The cache must budget the padding: ceil(P/chunk)*chunk <=
    max_seq_len. The logits come from the true last position's row of
    the final chunk.

    ``initial_cache``/``base_index`` seed a SUFFIX prefill: the dense
    cache already holds rows [0:base_index) (a shared prefix gathered out
    of the paged pool, counter at base_index) and ``prompt`` is only the
    rest; the padding budget and the rollback shift by base_index."""

    def __init__(self, model: Transformer, prompt, chunk: int, *,
                 initial_cache: dict | None = None,
                 base_index: int = 0) -> None:
        self.prompt_len = int(prompt.shape[1])
        self.base_index = int(base_index)
        _validate_prefill_chunk(model.cfg, self.prompt_len, chunk,
                                base=self.base_index)
        self.chunk = int(chunk)
        self.n_chunks = -(-self.prompt_len // self.chunk)
        self._padded = self.n_chunks * self.chunk
        prompt = torch.as_tensor(prompt, device=model.device)
        self._prompt = F.pad(prompt, (0, self._padded - self.prompt_len))
        self._model = model
        self._cache = (model.init_cache(prompt.shape[0], paged=False)
                       if initial_cache is None else initial_cache)
        self._hidden = None
        self._at = 0

    @property
    def done(self) -> bool:
        return self._at >= self.n_chunks

    def feed(self, max_chunks: int = 1) -> int:
        """Run up to ``max_chunks`` chunk forwards; returns the prompt
        tokens processed (the unit a serving loop budgets)."""
        n = min(max_chunks, self.n_chunks - self._at)
        with torch.no_grad():
            for _ in range(n):
                at = self._at * self.chunk
                self._hidden = self._model(
                    self._prompt[:, at:at + self.chunk], self._cache,
                    return_hidden=True)
                self._at += 1
        return n * self.chunk

    def result(self) -> tuple[dict, torch.Tensor]:
        """(cache, last-true-position logits): call once, after done."""
        if not self.done:
            raise RuntimeError("prefill not finished")
        row = self.prompt_len - 1 - (self._padded - self.chunk)
        with torch.no_grad():
            logits = _head_logits(self._model, self._hidden[:, row])
        if self._padded > self.prompt_len:
            set_cache_index(self._cache, self.base_index + self.prompt_len)
        return self._cache, logits


def prefill_chunked(cfg: TransformerConfig, params, prompt,
                    chunk: int = 64, *, device=None):
    """Prompt prefill through fixed ``[B, chunk]`` forwards -> (dense
    cache, last-position logits) for any prompt length: a
    ``ChunkedPrefill`` run to the end."""
    _validate_prefill_chunk(cfg, prompt.shape[1], chunk)
    pf = ChunkedPrefill(_decode_model(cfg, params, device), prompt, chunk)
    pf.feed(pf.n_chunks)
    return pf.result()


def _validate_prefill_chunk(cfg: TransformerConfig, p: int, chunk: int,
                            base: int = 0) -> None:
    """Chunked prefill's checks, run before any device work
    (``generate_segments`` runs them before returning its generator).
    ``base`` is a seeded suffix prefill's starting row: the padding
    budget shifts by it."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    if p < 1:
        raise ValueError("prompt must have at least one token")
    padded = -(-p // chunk) * chunk
    if base + padded > cfg.max_seq_len:
        at_base = f" at base {base}" if base else ""
        raise ValueError(
            f"prompt {p} right-padded to {padded}{at_base} exceeds "
            f"max_seq_len {cfg.max_seq_len} (the last partial chunk "
            "feeds a full chunk of cache rows before rollback)"
        )
