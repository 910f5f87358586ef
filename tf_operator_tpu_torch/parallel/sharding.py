"""Data-parallel placement over a mesh of processes.

Counterpart of ``tf_operator_tpu/parallel/sharding.py``'s data-parallel
half. JAX places one global array over the mesh's devices; the port runs
one process a device, so a batch sharded over the data axes is each
rank's own rows, and a replicated tree is one copy a rank:

- ``shard_batch(mesh, batch)`` puts this rank's rows on its device. The
  global batch is the ranks' rows concatenated in the data axes' order
  (``Mesh.members``), JAX's ``make_array_from_process_local_data``
  contract of one host batch a process.
- ``replicate(mesh, tree)`` broadcasts every tensor of a tree, a module
  or a ``TrainState`` from the mesh's first rank, so that every rank
  starts from the same state.
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
- ``TensorParallel`` is a decode mesh's tensor axis as this rank sees
  it: its index, its size, and the collectives the Megatron layout of
  ``models/transformer.py`` issues (the row-split projections'
  all-reduce, the vocab-split head's all-gather, the engine's command
  broadcast). Under gloo a tensor on the card is staged through the
  host, in the open: the module's ``staged_bytes`` counts what went that
  way in this process.

The FSDP and ZeRO placements (``fsdp_sharding_tree``,
``shard_params_fsdp``, ``weight_update_shardings``) wait for ROADMAP
A8e and raise, naming it.
"""

from __future__ import annotations

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

    def mean_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Average the parameters' gradients over the group with one
        all-reduce of their concatenation."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.group is None or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat)
        flat /= self.size
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
    and optimiser state) in place from the mesh's first rank; returns
    ``tree``. A copy of the same state on every rank, as JAX's
    replicated placement is."""
    group = mesh.group(mesh.axis_names)
    if group is None:
        return tree
    src = int(mesh.devices.reshape(-1)[0])
    nccl = dist.get_backend(group) == "nccl"
    for t in _tensors(tree):
        if t.is_cuda or not nccl:
            dist.broadcast(t, src, group=group)
        else:
            on = t.cuda()
            dist.broadcast(on, src, group=group)
            t.copy_(on)
    return tree


def _waits(name: str, item: str):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: see ROADMAP.md {item}")

    refused.__name__ = name
    refused.__doc__ = f"Waits for ROADMAP {item}; raises."
    return refused


fsdp_sharding_tree = _waits("fsdp_sharding_tree", "A8e (FSDP)")
shard_params_fsdp = _waits("shard_params_fsdp", "A8e (FSDP)")
weight_update_shardings = _waits("weight_update_shardings",
                                 "A8e (ZeRO-1)")


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


# -- the tensor axis of a decode mesh ----------------------------------------

# Bytes this process's tensor-parallel collectives staged through the host
# (gloo over tensors on the card); set it to 0 to reset.
staged_bytes = 0



class TensorParallel:
    """The ``axis`` (default ``"tp"``) of a decode ``mesh`` as this rank
    sees it: ``index`` (its place on the axis), ``size``, and the
    collectives over the axis. The group is the default group when the
    mesh spans the world (at one rank too, so that a world of one runs
    the same NCCL calls as a wider one), none without a process group
    (every collective a no-op). Collectives go in the order the callers
    issue them, the same on every rank: the model's forward is one order,
    the engine's command stream another, and they never interleave."""

    def __init__(self, mesh: Mesh, axis: str = "tp") -> None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.mesh, self.axis = mesh, axis
        self.size = int(mesh.shape.get(axis, 1))
        self.members = mesh.members((axis,), rank)
        self.index = self.members.index(rank)
        self.group = None
        if dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != mesh.size:
                raise ValueError(f"{mesh} spans {mesh.size} ranks, the "
                                 f"world {dist.get_world_size()}")
            self.group = dist.group.WORLD
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

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place."""
        if self.group is None:
            return t
        wire = self._on_wire(t.contiguous())
        dist.all_reduce(wire, group=self.group)
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
