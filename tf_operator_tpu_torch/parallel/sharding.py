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

The rule-driven and FSDP placements (``sharding_tree_by_rules``,
``shard_params_by_rules``, ``fsdp_sharding_tree``, ``shard_params_fsdp``,
``weight_update_shardings``) shard parameters over tensor, expert or
fully-sharded data axes: ROADMAP A8b and A8e. Each raises, naming its
item.
"""

from __future__ import annotations

from typing import Any, Sequence

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


sharding_tree_by_rules = _waits("sharding_tree_by_rules",
                                "A8b (tensor parallel)")
shard_params_by_rules = _waits("shard_params_by_rules",
                               "A8b (tensor parallel)")
fsdp_sharding_tree = _waits("fsdp_sharding_tree", "A8e (FSDP)")
shard_params_fsdp = _waits("shard_params_fsdp", "A8e (FSDP)")
weight_update_shardings = _waits("weight_update_shardings",
                                 "A8e (ZeRO-1)")
