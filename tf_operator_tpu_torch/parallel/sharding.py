"""Data-parallel placement over a mesh of processes.

Counterpart of ``tf_operator_tpu/parallel/sharding.py``'s data-parallel
half. JAX places one global array over the mesh's devices; the port runs
one process a device, so a batch sharded over the data axes is each
rank's own rows, and a replicated tree is one copy a rank:

- ``shard_batch(mesh, batch)`` puts this rank's rows on its device. The
  global batch is the ranks' rows concatenated in the data axes' order
  (``Mesh.members``), JAX's ``make_array_from_process_local_data``
  contract of one host batch a process.
- ``token_block(mesh, batch)`` cuts this rank's block of a GLOBAL token
  batch, rows by the data axes and columns by ``sp``, and places it: what
  JAX's ``P(dp, sp)`` gives each device of a sequence-parallel step.
- ``replicate(mesh, tree)`` broadcasts every tensor of a tree, a module
  or a ``TrainState`` over the mesh's axes but ``tp``, ``ep`` and ``pp``
  from the first rank of this rank's group, so that every rank starts
  from the same state (the same shards or stage, on a dp x tp, dp x ep or
  dp x pp mesh).
- ``DataParallel`` is a mesh's data axes as this rank sees them: its
  group, its size, this rank's shard index, the gradient mean, an
  all-reduce that autograd sees (``sum``), and the gather of a batch's
  rows that a step deals into JAX's microbatches.

The rule-driven placement shards parameters over a tensor axis, as
slicing: JAX puts one global array over the mesh and each device holds
its shard; here rank r keeps its slice of each leaf.

- ``sharding_tree_by_rules(mesh, params, rules)`` is JAX's spec tree, as
  data: each leaf's spec (a tuple of axis names or None) from the first
  rule whose path substring matches, and JAX's fallback: a leaf whose
  named dimension does not tile (GQA K/V heads fewer than tp, an odd
  vocabulary) stays whole.
- ``shard_params_by_rules(mesh, params, rules, rank=)`` is rank's slice of
  every leaf under that tree: the addressable shard JAX gives the device
  at the rank's place in the mesh.
- ``gather_params_by_rules(mesh, params, rules, shapes)`` is the inverse:
  every split leaf all-gathered on its rule's dimension back to the whole
  leaf (``shapes`` names the whole shapes, which decide the specs).
- ``TensorParallel`` is a mesh's tensor axis as this rank sees it: its
  index, its size, its group (the world's for a decode mesh, the ranks
  of one data index on a dp x tp mesh), and the collectives the Megatron
  layout of ``models/transformer.py`` issues: in place for decode (the
  row-split projections' all-reduce, the vocab-split head's all-gather,
  the engine's command broadcast), and for training three that autograd
  sees (``copy``: the identity forward and an all-reduce backward;
  ``reduce``: an all-reduce forward and the identity backward;
  ``gather``: an all-gather forward and the rank's slice backward).
  Under gloo a tensor on the card is staged through the host, in the
  open: the module's ``staged_bytes`` counts what went that way in this
  process, the tensor axis' collectives and the ``sp`` axis' ring and
  all-to-all transport (``TensorParallel.exchange``, over a
  ``TensorParallel`` of ``"sp"``) and the pipeline's hops (over one of
  ``"pp"``, ``parallel/pipeline.py``) alike.

FSDP and ZeRO-1 cut leaves by JAX's rule (``fsdp_spec``: the largest
dimension the axis divides, leaves under ``min_size`` whole):

- ``fsdp_sharding_tree`` and ``weight_update_shardings`` are JAX's spec
  trees as data (a model reads as its flax-layout params tree);
- ``shard_params_fsdp`` is a tree's slices for a rank, or a model cut in
  place, which then holds its shards and a ``FullyShardedParallel``
  (``model.fsdp``) whose ``gathered()`` all-gathers each leaf for a
  forward and reduce-scatters its gradient (``_GatherShards``,
  ``TensorParallel.reduce_scatter``);
- ``Cut`` is one tensor's place in its whole leaf (shape, dimension,
  axis, and a further cut of that part: a tp-split leaf cut again over
  fsdp, each rank holding 1/(tp fsdp) of it): what the optimisers
  (whole-leaf norms and factored statistics), the ZeRO-1 update and the
  checkpoints read.

Beside ``tp`` the fsdp rule reads the WHOLE leaf's shape (the spec tree is
JAX's, of the whole params tree), and cuts the dim it names of the rank's
tensor-parallel part: a leaf split over tp on that dim is cut again on it
(its tp part of ``n / tp`` rows into ``n / (tp fsdp)``), a leaf split on
another dim is cut on two dims, and a whole leaf is cut as it is without
tp. Beside ``ep`` the same holds for an MoE layer's experts: the spec is of
the whole ``[n_experts, ...]`` leaf, and the rank's ``n_experts / ep``
experts are cut again on the dim it names, so a rank holds 1/(ep fsdp) of
``w_in`` and ``w_out``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tf_operator_tpu_torch.parallel.mesh import Mesh
from tf_operator_tpu_torch.train.distributed import collective_device


def _axes(data_axis: Any) -> tuple[str, ...]:
    return (data_axis,) if isinstance(data_axis, str) else tuple(data_axis)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a data group, whose gradient is the sum of the ranks'
    gradients: with every rank's loss a share of one global loss, the
    backward carries each rank's share of the other ranks' terms."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        y = x.clone()
        dp.all_reduce_(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.dp.all_reduce_(g)
        return g, None


class DataParallel:
    """The data axes ``data_axis`` (a name or a tuple of names; axes the
    mesh lacks count as size 1) of ``mesh`` as this rank sees them."""

    def __init__(self, mesh: Mesh, data_axis: Any = "dp") -> None:
        axes = tuple(a for a in _axes(data_axis) if a in mesh.axis_names)
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.mesh, self.axes = mesh, axes
        self.members = mesh.members(axes, rank)
        self.size = len(self.members)
        self.index = self.members.index(rank)
        self.group = mesh.group(axes)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place (nothing without one)."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, differentiable."""
        if self.group is None:
            return t
        return _AllReduceSum.apply(t, self)

    def mean_grads(self, params: Sequence[torch.Tensor],
                   size: int | None = None) -> None:
        """Average the parameters' gradients over the group with one
        all-reduce of their concatenation (divided by ``size``, default
        the group's: a gradient already summed over another axis is
        divided by both)."""
        grads = [p.grad for p in params if p.grad is not None]
        size = size or self.size
        if not grads or (self.group is None and size == 1):
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat)
        flat /= size
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a metric over the group (not differentiable)."""
        if self.group is None:
            return t
        t = t.detach().clone()
        self.all_reduce_(t)
        return t / self.size

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in shard order: the
        global rows, on ``x``'s device. Gloo gathers on the host."""
        if self.group is None:
            return x
        local = x.to(collective_device(self.group)).contiguous()
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local, group=self.group)
        # all_gather fills the group's ranks in ascending order.
        by_rank = dict(zip(sorted(self.members), parts))
        return torch.cat([by_rank[r] for r in self.members]).to(x.device)


def data_parallel(mesh: Mesh | None, data_axis: Any = "dp"
                  ) -> DataParallel | None:
    """``DataParallel`` of ``mesh``'s data axes (None without a mesh)."""
    return None if mesh is None else DataParallel(mesh, data_axis)


def attach(model: torch.nn.Module, dp: DataParallel | None) -> None:
    """Hand ``dp`` to every module of ``model`` that takes its statistics
    over the global batch (a ``data_parallel`` attribute: BatchNorm, the
    MoE router's load-balancing loss), or None to make them local again.
    Over one rank the local statistics are the global ones, so a group
    of size 1 attaches None."""
    dp = dp if dp is not None and dp.size > 1 else None
    for m in model.modules():
        if hasattr(m, "data_parallel"):
            m.data_parallel = dp


def shard_batch(mesh: Mesh, batch: Any, axis: Any = "dp") -> Any:
    """This rank's rows of the global batch (a dict, list or tuple of
    numpy arrays or tensors), on the mesh's device."""
    from tf_operator_tpu_torch import resolve_device

    device = resolve_device(mesh.device)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return torch.as_tensor(x).to(device)

    return place(batch)


def token_block(mesh: Mesh, batch: dict, data_axis: Any = "dp",
                seq_axis: str = "sp") -> dict:
    """This rank's block of a GLOBAL batch of ``[B, T]`` arrays (tokens,
    targets, a mask): rows ``B / dp`` at its index on the data axes,
    columns ``T / sp`` at its index on ``seq_axis``, placed on the mesh's
    device. Raises ``ValueError`` when the axes do not divide the
    batch."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    rows = mesh.members(_axes(data_axis), rank)
    cols = mesh.members((seq_axis,), rank)
    b, t = np.shape(next(iter(batch.values())))[:2]
    if b % len(rows):
        raise ValueError(f"batch {b} not divisible by {data_axis}="
                         f"{len(rows)}")
    if t % len(cols):
        raise ValueError(f"seq {t} not divisible by {seq_axis}={len(cols)}")
    r, c = b // len(rows), t // len(cols)
    i, j = rows.index(rank), cols.index(rank)
    return shard_batch(mesh, {k: v[i * r:(i + 1) * r, j * c:(j + 1) * c]
                              for k, v in batch.items()})


def _tensors(tree: Any) -> list[torch.Tensor]:
    from tf_operator_tpu_torch.train.steps import TrainState

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, TrainState):
        out = _tensors(tree.model)
        for state in tree.optimizer.state.values():
            out += [v for v in state.values() if isinstance(v, torch.Tensor)]
        return out
    if isinstance(tree, torch.nn.Module):
        return [t.data for t in tree.parameters()] + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every tensor of ``tree`` (tensors in dicts, lists and
    tuples, a module's parameters and buffers, a ``TrainState``'s model
    and optimiser state) in place over every axis of the mesh but ``tp``,
    ``ep`` and ``pp`` (and the axis a model cut by ``shard_params_fsdp``
    is cut over), from the first rank of this rank's group; returns
    ``tree``. A copy of the same state on every rank, as JAX's replicated
    placement is; on a dp x tp (or dp x ep, dp x pp) mesh each rank keeps
    its own shards (its stage), and the ranks that share its ``tp``
    (``ep``, ``pp``) index get them."""
    held = {"tp", "ep", "pp"}
    model = getattr(tree, "model", tree)
    if getattr(model, "fsdp", None) is not None:
        held.add(model.fsdp.axis.axis)
    axes = [a for a in mesh.axis_names if a not in held]
    group = mesh.group(axes)
    if group is None:
        return tree
    rank = dist.get_rank()
    src = mesh.members(axes, rank)[0]
    nccl = dist.get_backend(group) == "nccl"
    for t in _tensors(tree):
        if t.is_cuda or not nccl:
            dist.broadcast(t, src, group=group)
        else:
            on = t.cuda()
            dist.broadcast(on, src, group=group)
            t.copy_(on)
    return tree


# -- rule-driven placement (tensor parallelism) ------------------------------


def _path_str(path: Sequence[str]) -> str:
    return "/".join(str(k) for k in path)


def _map_tree(tree: Any, fn, prefix=()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def spec_by_rules(mesh: Mesh, path: str, shape: Sequence[int],
                  rules: dict[str, tuple], default: tuple = ()) -> tuple:
    """One leaf's spec: the first rule whose key is a substring of
    ``path``, unless one of its named axes cannot tile the leaf (then
    ``default``, replicated by default), as JAX's ``spec_for``."""
    shape = tuple(shape)
    for sub, spec in rules.items():
        if sub not in path:
            continue
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            size = mesh.shape.get(axis, 1)
            if d >= len(shape) or (size > 1 and shape[d] % size):
                return tuple(default)
        return tuple(spec)
    return tuple(default)


def sharding_tree_by_rules(mesh: Mesh, params: Any, rules: dict[str, tuple],
                           default: tuple = ()) -> Any:
    """The spec of every leaf of ``params`` (nested dicts of arrays) under
    the path-substring ``rules``: JAX's ``sharding_tree_by_rules`` with a
    tuple where JAX has a ``NamedSharding``."""
    return _map_tree(params, lambda path, leaf: spec_by_rules(
        mesh, _path_str(path), tuple(leaf.shape), rules, default))


def shard_slices(mesh: Mesh, spec: tuple, shape: Sequence[int],
                 rank: int) -> tuple[slice, ...]:
    """The index of ``rank``'s shard of a leaf of ``shape`` under
    ``spec``: dimension d split into ``mesh.shape[spec[d]]`` equal parts,
    the rank's coordinate on that axis picking its part."""
    at = mesh.coords(rank)
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        parts = mesh.shape.get(axis, 1) if axis is not None else 1
        if parts == 1:
            out.append(slice(None))
        else:
            size = n // parts
            out.append(slice(at[axis] * size, (at[axis] + 1) * size))
    return tuple(out)


def shard_params_by_rules(mesh: Mesh, params: Any, rules: dict[str, tuple],
                          default: tuple = (), rank: int | None = None
                          ) -> Any:
    """``rank``'s slice (default this process's rank) of every leaf of
    ``params`` under the rules: numpy leaves come back as contiguous numpy
    arrays, tensors as contiguous tensors."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0

    def cut(path, leaf):
        spec = spec_by_rules(mesh, _path_str(path), tuple(leaf.shape),
                             rules, default)
        part = leaf[shard_slices(mesh, spec, tuple(leaf.shape), rank)]
        if isinstance(part, torch.Tensor):
            return part.contiguous()
        return np.ascontiguousarray(part)

    return _map_tree(params, cut)


def gather_leaf(mesh: Mesh, spec: tuple, leaf: torch.Tensor
                ) -> torch.Tensor:
    """The whole leaf of which ``leaf`` is this rank's shard under
    ``spec``: all-gathered over each named axis above size 1 on its
    dimension, the shards in the axis' order, on ``leaf``'s device."""
    for d, axis in enumerate(spec):
        if axis is not None and mesh.shape.get(axis, 1) > 1:
            leaf = TensorParallel(mesh, axis).all_gather(leaf, d)
    return leaf


def gather_params_by_rules(mesh: Mesh, params: Any, rules: dict[str, tuple],
                           shapes: dict, default: tuple = ()) -> Any:
    """The inverse of ``shard_params_by_rules``: every leaf of ``params``
    (nested dicts of this rank's tensor shards) all-gathered back to the
    whole leaf. ``shapes`` is ``{path tuple: whole shape}``
    (``models/convert.py::param_shapes``): the whole shape decides a
    leaf's spec, as it does when the leaf is cut. Collective over the
    axes the rules name: every rank calls it with the same tree."""

    def whole(path, leaf):
        spec = spec_by_rules(mesh, _path_str(path), tuple(shapes[path]),
                             rules, default)
        return gather_leaf(mesh, spec, leaf)

    return _map_tree(params, whole)


# -- the tensor axis ------------------------------------------------------------

# Bytes this process's tensor- and sequence-parallel collectives staged
# through the host (gloo over tensors on the card); set it to 0 to reset.
staged_bytes = 0



class _Copy(torch.autograd.Function):
    """The identity forward and the sum over the tensor axis backward: a
    replicated activation (or a whole leaf) that each rank feeds to its
    part of a split product, whose gradient each rank holds in part."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.clone()), None


class _Reduce(torch.autograd.Function):
    """The sum over the tensor axis forward (out of place) and the identity
    backward: the ranks' partial products (or partial sums) of one value
    that every rank then uses alike, whose gradient every rank holds
    whole."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' parts concatenated on ``dim`` forward and this rank's
    part of the whole gradient backward (every rank holds it whole)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return g.narrow(ctx.dim, tp.index * ctx.n, ctx.n), None, None


class TensorParallel:
    """The ``axis`` (default ``"tp"``; a tuple of axes is their product,
    the first the most significant) of ``mesh`` as this rank sees it:
    ``index`` (its place on the axis), ``size``, and the collectives over
    the axis. The group is ``Mesh.group``'s: the default group when the
    axis spans the world (at one rank too, so that a world of one runs
    the same NCCL calls as a wider one), the ranks of this rank's data
    index on a dp x tp mesh, none without a process group or at size 1
    inside a wider world (every collective a no-op). Collectives go in
    the order the callers issue them, the same on every rank of the
    group: the model's forward is one order, its backward another, the
    engine's command stream a third, and they never interleave."""

    def __init__(self, mesh: Mesh, axis: str | tuple = "tp") -> None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        self.mesh, self.axis = mesh, axis
        self.size = math.prod(int(mesh.shape.get(a, 1)) for a in axes)
        self.members = mesh.members(axes, rank)
        self.index = self.members.index(rank)
        self.group = mesh.group(axes)
        self.backend = (dist.get_backend(self.group)
                        if self.group is not None else None)

    @property
    def rank(self) -> int:
        return self.members[self.index]

    def _on_wire(self, t: torch.Tensor) -> torch.Tensor:
        """Where ``t`` travels: itself, or a host copy under gloo for a
        tensor on the card (counted in the module's ``staged_bytes``)."""
        global staged_bytes
        if self.backend == "gloo" and t.is_cuda:
            staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def exchange(self, sends: dict[int, torch.Tensor],
                 shapes: dict[int, tuple], like: torch.Tensor | None = None
                 ) -> dict[int, torch.Tensor]:
        """Point-to-point over the axis: ``sends[j]`` goes to the member at
        index j and a tensor of ``shapes[j]`` (``sends``' dtype) arrives
        from the member at index j; every receive is posted before any
        send, and all are waited on. Returns ``{j: received}`` on each
        tensor's device: ``like``'s dtype and device when given (a rank
        that only receives), else the sends'. The transport of the ``sp``
        ring and all-to-all (``parallel/ring_attention.py``,
        ``parallel/ulysses.py``) and of the pipeline's hops
        (``parallel/pipeline.py``)."""
        some = like if like is not None else next(iter(sends.values()))
        wire = {j: self._on_wire(t.contiguous()) for j, t in sends.items()}
        on = (torch.device("cpu") if self.backend == "gloo" and some.is_cuda
              else some.device)
        got = {j: torch.empty(s, dtype=some.dtype, device=on)
               for j, s in shapes.items()}
        ops = [dist.P2POp(dist.irecv, got[j], self.members[j], self.group)
               for j in got]
        ops += [dist.P2POp(dist.isend, wire[j], self.members[j], self.group)
                for j in wire]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {j: t.to(some.device) for j, t in got.items()}

    def all_reduce_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """Sum ``t`` over the axis (or reduce it by ``op``), in place."""
        if self.group is None:
            return t
        wire = self._on_wire(t.contiguous())
        dist.all_reduce(wire, op=op or dist.ReduceOp.SUM, group=self.group)
        if wire.data_ptr() != t.data_ptr():
            t.copy_(wire)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in axis order."""
        if self.group is None:
            return t
        wire = self._on_wire(t.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        # all_gather fills the group's ranks in ascending order.
        by_rank = dict(zip(sorted(self.members), parts))
        out = torch.cat([by_rank[r] for r in self.members], dim=dim)
        return out.to(t.device)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``t`` over the axis, this rank's part of it on
        ``dim`` (the parts in axis order): the inverse collective of
        ``all_gather``."""
        if self.group is None:
            return t
        n = t.shape[dim] // self.size
        parts = dict(zip(self.members, t.split(n, dim)))
        # reduce_scatter hands the group's ranks their parts in ascending
        # rank order.
        wire = self._on_wire(torch.cat(
            [parts[r].movedim(dim, 0) for r in sorted(self.members)]
        ).contiguous())
        out = torch.empty((n,) + wire.shape[1:], dtype=wire.dtype,
                          device=wire.device)
        dist.reduce_scatter_tensor(out, wire, group=self.group)
        return out.movedim(0, dim).to(t.device)

    def broadcast_(self, t: torch.Tensor, src_index: int = 0
                   ) -> torch.Tensor:
        """``t`` from the rank at ``src_index`` on the axis, in place."""
        if self.group is None:
            return t
        wire = self._on_wire(t)
        dist.broadcast(wire, self.members[src_index], group=self.group)
        if wire.data_ptr() != t.data_ptr():
            t.copy_(wire)
        return t

    # -- the training collectives (autograd sees them) ---------------------

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is; its gradient summed over the axis."""
        if self.group is None:
            return x
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the axis; its gradient passed as it is. In
        place where autograd does not follow ``x`` (decode, eval)."""
        if self.group is None:
            return x
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_reduce_(x)
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated on ``dim`` in axis order; the
        gradient's slice of this rank passed back."""
        if self.group is None:
            return x
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self.all_gather(x, dim)
        return _Gather.apply(x, self, dim % x.dim())


# -- FSDP and ZeRO-1: leaves cut by JAX's fsdp rule ---------------------------


def fsdp_spec(shape: Sequence[int], axis: str, size: int,
              min_size: int = 2**11) -> tuple:
    """One leaf's spec under JAX's ``fsdp_sharding_tree`` rule: the
    largest dimension that ``size`` divides (ties to the earlier one) split
    over ``axis``; ``()`` (whole) for a scalar, a leaf of fewer than
    ``min_size`` elements or one with no such dimension."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return ()
    for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[d] % size == 0:
            return tuple(axis if i == d else None for i in range(len(shape)))
    return ()


def whole_shapes(model: torch.nn.Module) -> dict:
    """``{flax path: the whole leaf's flax shape}`` of a model's params:
    a tensor-parallel model's (whose ``TpPlan`` splits leaves) from its
    config (``models/convert.py::param_shapes``), any other's its own but
    an expert-parallel MoE layer's ``w_in``/``w_out``, whose rank holds
    ``n_experts / ep`` experts of the whole ``n_experts`` on dim 0."""
    from tf_operator_tpu_torch.models.convert import (
        param_shapes,
        variable_layout,
    )
    from tf_operator_tpu_torch.models.moe import expert_parts

    leaves, to_flax, _ = variable_layout(model)
    plan = getattr(model, "tp_plan", None)
    if plan is not None and plan.split and plan.tp.size > 1:
        shapes = param_shapes(model.cfg)
        return {path: tuple(shapes[path]) for path in leaves["params"]}
    experts = expert_parts(model)
    out = {}
    for path, p in leaves["params"].items():
        shape = tuple(to_flax(p).shape)
        if id(p) in experts:
            shape = (experts[id(p)][0],) + shape[1:]
        out[path] = shape
    return out


def _map_leaves(tree: Any, fn) -> Any:
    """``fn(leaf)`` over a tree of dicts, lists and tuples; None stays
    None (JAX's empty subtree)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def fsdp_sharding_tree(mesh: Mesh, params: Any, axis: str = "fsdp",
                       min_size: int = 2**11) -> Any:
    """JAX's ``fsdp_sharding_tree`` as data: every leaf's spec (a tuple,
    ``()`` for whole) by ``fsdp_spec`` at the size of ``axis``. ``params``
    is a tree of arrays or tensors (dicts, lists, tuples; a leaf without a
    shape, such as a step count, is whole), or a port model, read as its
    WHOLE flax-layout params tree (a tensor-parallel model's leaves at
    their whole shapes, ``whole_shapes``)."""
    size = mesh.shape[axis]
    if isinstance(params, torch.nn.Module):
        from tf_operator_tpu_torch.models.convert import _nest

        params = _nest({path: torch.empty(shape, device="meta")
                        for path, shape in whole_shapes(params).items()})
    return _map_leaves(params, lambda leaf: fsdp_spec(
        getattr(leaf, "shape", ()), axis, size, min_size))


def weight_update_shardings(mesh: Mesh, opt_state: Any, axis: str = "dp",
                            min_size: int = 2**11) -> Any:
    """ZeRO-1 (the weight-update sharding of arXiv:2004.13336) for plain
    data parallelism: ``fsdp_sharding_tree``'s rule over the data axis
    ``axis``. JAX applies it to optax's state; the port's optimisers keep
    their state by parameter, so the train steps read it in the params
    tree's layout (``weight_update_shardings(mesh, params)`` or of the
    model): a leaf's spec is how its update and the moments shaped like it
    are cut (``make_lm_train_step(opt_shardings=)``)."""
    return fsdp_sharding_tree(mesh, opt_state, axis=axis, min_size=min_size)


def shard_params_fsdp(mesh: Mesh, params: Any, axis: str = "fsdp",
                      min_size: int = 2**11, rank: int | None = None
                      ) -> Any:
    """FSDP placement. For a tree: ``rank``'s slice (default this
    process's rank) of every leaf under ``fsdp_sharding_tree``, the
    addressable shard JAX gives that device (numpy leaves as contiguous
    numpy arrays, tensors as contiguous tensors). For a port model: its
    parameters cut IN PLACE to this rank's slices (cut in flax's layout,
    so a classifier's conv kernel is cut where JAX cuts its HWIO kernel),
    the model's ``fsdp`` set to their ``FullyShardedParallel``; returns the
    model. Cut a model before ``TrainState.create``, so that its optimiser
    holds the shards, as JAX shards params before ``tx.init``."""
    if isinstance(params, torch.nn.Module):
        FullyShardedParallel.shard(mesh, params, axis, min_size)
        return params
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    size = mesh.shape[axis]

    def cut(leaf):
        spec = fsdp_spec(getattr(leaf, "shape", ()), axis, size, min_size)
        if not spec:
            return leaf
        part = leaf[shard_slices(mesh, spec, tuple(leaf.shape), rank)]
        if isinstance(part, torch.Tensor):
            return part.contiguous()
        return np.ascontiguousarray(part)

    return _map_leaves(params, cut)


@dataclass(frozen=True)
class Cut:
    """Where a tensor lies in its whole leaf: the leaf's ``whole`` shape (in
    the tensor's own layout) split on ``dim`` over ``axis`` (a
    ``TensorParallel``), this rank's part the one at ``axis.index``; and,
    when ``then`` is set, that part cut again (a tp-split leaf cut over
    fsdp, or its ZeRO-1 part over dp: ``then.whole`` is this cut's part's
    shape). A chain of cuts names distinct axes."""

    whole: tuple
    dim: int
    axis: TensorParallel
    then: "Cut | None" = None

    @property
    def length(self) -> int:
        return self.whole[self.dim] // self.axis.size

    def levels(self) -> list:
        """``(dim, axis)`` of each cut of the chain, outermost first."""
        out = [(self.dim, self.axis)]
        return out if self.then is None else out + self.then.levels()

    def within(self, inner: "Cut | None") -> "Cut":
        """This cut followed by ``inner`` (a cut of this chain's part)."""
        if inner is None:
            return self
        return Cut(self.whole, self.dim, self.axis,
                   inner if self.then is None else self.then.within(inner))

    def part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole ``t`` (a view)."""
        t = t.narrow(self.dim, self.axis.index * self.length, self.length)
        return t if self.then is None else self.then.part(t)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole of which ``t`` is this rank's part (collective)."""
        if self.then is not None:
            t = self.then.gather(t)
        return self.axis.all_gather(t, self.dim)

    def axes(self, dim: int | None = None):
        """The ``TensorParallel`` over the axes of the chain's cuts (those
        on ``dim`` only, when given), or None when there is none: the
        group over which a sum of this rank's part is the whole leaf's (a
        norm, or a mean over ``dim``)."""
        axes = [ax for d, ax in self.levels() if dim is None or d == dim]
        if len(axes) < 2:
            return axes[0] if axes else None
        return TensorParallel(self.axis.mesh, tuple(ax.axis for ax in axes))

    def without(self, dim: int) -> "Cut | None":
        """The cut of a tensor made by averaging ``dim`` away (an Adafactor
        factored moment): the chain's cuts of the other dims, shifted
        down past ``dim``; None when no cut is left."""
        inner = None if self.then is None else self.then.without(dim)
        if self.dim == dim:
            return inner
        whole = self.whole[:dim] + self.whole[dim + 1:]
        return Cut(whole, self.dim - (self.dim > dim), self.axis, inner)


def flax_dims(to_flax, ndim: int) -> tuple:
    """The port dimension of each flax dimension of an ``ndim`` leaf under
    a layout's ``to_flax`` (a permutation view)."""
    probe = torch.empty((2,) * ndim, device="meta")
    strides = probe.stride()
    return tuple(strides.index(s) for s in to_flax(probe).stride())


class _GatherShards(torch.autograd.Function):
    """FSDP's collective pair: the whole leaf all-gathered from the ranks'
    shards forward, the gradient reduce-scattered back to this rank's
    shard (summed over the axis) backward."""

    @staticmethod
    def forward(ctx, shard, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g, ctx.dim), None, None


class FullyShardedParallel:
    """A model whose parameters are cut over a data axis (JAX's FSDP, one
    process a device): ``cuts`` maps each cut parameter's name to its
    ``Cut`` (the port layout's whole shape and dimension), ``specs`` its
    flax path to JAX's spec. Between steps the model holds only its
    shards (``model.parameters()`` are the shards, so the optimiser's
    state is too); ``gathered()`` puts each leaf's whole, gathered over
    the axis through ``_GatherShards``, in its module's place for a
    forward and its backward, whose gradients then land reduce-scattered
    on the shards."""

    def __init__(self, mesh: Mesh, model: torch.nn.Module, axis: str,
                 specs: dict, cuts: dict) -> None:
        self.mesh, self.axis = mesh, TensorParallel(mesh, axis)
        self.specs, self.cuts = specs, cuts
        self._places = [(model.get_submodule(name.rpartition(".")[0]),
                         name.rpartition(".")[2], name)
                        for name in cuts]

    @classmethod
    def shard(cls, mesh: Mesh, model: torch.nn.Module, axis: str,
              min_size: int) -> "FullyShardedParallel":
        """Cut ``model``'s parameters in place by ``fsdp_spec`` of their
        whole flax shapes (``whole_shapes``; a tensor-parallel part, or an
        expert-parallel layer's ``E / ep`` experts, is cut on the dim the
        whole leaf's spec names, which must then divide the part, else a
        ``ValueError`` names the leaf); set and return its ``fsdp``."""
        from tf_operator_tpu_torch.models.convert import variable_layout

        if getattr(model, "fsdp", None) is not None:
            raise ValueError("the model is cut already")
        leaves, to_flax, _ = variable_layout(model)
        whole = whole_shapes(model)
        names = {id(p): n for n, p in model.named_parameters()}
        tp = TensorParallel(mesh, axis)
        specs, cuts = {}, {}
        for path, p in leaves["params"].items():
            spec = fsdp_spec(whole[path], axis, tp.size, min_size)
            specs[path] = spec
            if not spec:
                continue
            dim = flax_dims(to_flax, p.dim())[spec.index(axis)]
            if p.shape[dim] % tp.size:
                raise ValueError(
                    f"{'/'.join(path)}: this rank's part {tuple(p.shape)} "
                    f"does not divide on dim {dim} by {axis}={tp.size}")
            cuts[names[id(p)]] = Cut(tuple(p.shape), dim, tp)
        for name, cut in cuts.items():
            module, _, attr = name.rpartition(".")
            owner = model.get_submodule(module)
            p = owner._parameters[attr]
            owner._parameters[attr] = torch.nn.Parameter(
                cut.part(p.detach()).clone(
                    memory_format=torch.contiguous_format),
                requires_grad=p.requires_grad)
        model.fsdp = cls(mesh, model, axis, specs, cuts)
        return model.fsdp

    def check(self, specs: Any, what: str) -> None:
        """Raise unless ``specs`` (a spec tree by flax path) is the cut's."""
        from tf_operator_tpu_torch.models.convert import _leaves

        given = dict(_leaves(specs)) if isinstance(specs, dict) else None
        if given != self.specs:
            raise ValueError(f"{what}: param_shardings differ from the "
                             "model's cut (shard_params_fsdp)")

    @contextmanager
    def gathered(self):
        """Every cut leaf whole in its module for the block's forward and
        backward, in one order on every rank; the shards after."""
        held = []
        try:
            for module, attr, name in self._places:
                shard = module._parameters[attr]
                held.append((module, attr, shard))
                cut = self.cuts[name]
                module._parameters[attr] = _GatherShards.apply(
                    shard, cut.axis, cut.dim)
            yield
        finally:
            for module, attr, shard in held:
                module._parameters[attr] = shard
