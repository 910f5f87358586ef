"""Meshes over the processes of a ``torch.distributed`` world.

Counterpart of ``tf_operator_tpu/parallel/mesh.py``. JAX runs one
process a host and lays its mesh over ``jax.devices()``; the port runs
one process a device, so a ``Mesh`` here is a named, ordered set of axis
sizes over the world's RANKS, in rank order where JAX has devices in
device order. The axis names and their canonical order are JAX's:

- ``dcn``  cross-slice data parallelism (outermost);
- ``pp``   pipeline stages;
- ``dp``   data parallelism;
- ``fsdp`` data parallelism with sharded parameters;
- ``ep``   expert parallelism;
- ``sp``   sequence parallelism;
- ``tp``   tensor parallelism.

``Mesh.group`` is the process group over a set of axes: the world's own
group when the axes span the mesh, none when they have size 1, and over
a part of the mesh (the tensor axis beside a data axis) the group of the
ranks that share this rank's coordinates on every other axis. The first
such request builds every group over every part of the mesh, on every
rank in one fixed order (``dist.new_group`` is collective over the
world), and caches them on the mesh. A multislice job needs none: each
slice is a world of its own (``train/dist_multislice.py``).

Training takes a mesh of data axes (``fsdp`` among them: FSDP and
ZeRO-1, ``parallel/sharding.py``), ``ep`` (the experts,
``models/moe.py``), ``sp`` (the sequence split of
``parallel/ring_attention.py`` and ``parallel/ulysses.py``) and ``tp``
(``check_data_parallel``), in any mix but FSDP or ZeRO-1 beside ``ep``
and ``tp`` or ``sp`` at once (``train/steps.py`` refuses it, naming
ROADMAP.md A8m), and a mesh of
``pp`` and the data axes through
the pipelined LM (``train/pp_lm.py``, over ``parallel/pipeline.py``);
decode takes ``tp`` and ``dp`` (``check_decode_mesh``).

``slice_mesh`` checks the world against a TPU slice's device count, from
this module's copy of ``tf_operator_tpu/topology/slices.py``'s
generations (their chips per host, devices per chip and largest slice).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")


class Mesh:
    """Ranks laid out on named axes: ``devices`` is the array of ranks
    shaped by the axis sizes, ``device`` this process's torch device
    (None: the card, resolved where a tensor is placed)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...],
                 device=None) -> None:
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.device = device
        # {axes above size 1: this rank's group over them}, built once.
        self._groups: dict | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> dict[str, int]:
        """``rank``'s coordinate on each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def members(self, axes: Sequence[str], rank: int) -> list[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in
        the order of their coordinates on ``axes`` taken as a mixed-radix
        number (the first axis the most significant): the order of the
        shards of a dimension JAX shards over ``axes``. Axes the mesh
        lacks are ignored."""
        axes = [a for a in axes if a in self.axis_names]
        at = self.coords(rank)
        index = [slice(None) if a in axes else at[a] for a in self.axis_names]
        sub = self.devices[tuple(index)]
        kept = [a for a in self.axis_names if a in axes]
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return [int(r) for r in sub.reshape(-1)]

    def group(self, axes: Sequence[str]):
        """The process group over ``axes``: the world's default group when
        they span the mesh, None when they have size 1 or no process group
        is initialised, else this rank's group over that part of the mesh
        (``_part_groups``)."""
        import torch.distributed as dist

        axes = [a for a in axes if a in self.axis_names]
        n = math.prod(self.shape[a] for a in axes)
        if not (dist.is_available() and dist.is_initialized()):
            return None
        if dist.get_world_size() != self.size:
            raise ValueError(f"{self} spans {self.size} ranks, the world "
                             f"{dist.get_world_size()}")
        if n == self.size:
            return dist.group.WORLD
        if n == 1:
            return None
        key = tuple(sorted((a for a in axes if self.shape[a] > 1),
                           key=self.axis_names.index))
        return self._part_groups()[key]

    def _part_groups(self) -> dict:
        """This rank's group over every set of axes above size 1 that is
        not the whole mesh, built on the first call: for each set in a
        fixed order (fewest axes first, then the mesh's axis order), one
        ``dist.new_group`` for each coordinate of the other axes, in
        row-major order, on every rank (gloo and NCCL want every rank to
        create every group, in one order, or they hang)."""
        import itertools

        import torch.distributed as dist

        if self._groups is not None:
            return self._groups
        big = [a for a in self.axis_names if self.shape[a] > 1]
        rank = dist.get_rank()
        groups = {}
        for k in range(1, len(big)):
            for axes in itertools.combinations(big, k):
                dims = [self.axis_names.index(a) for a in axes]
                rest = [d for d in range(self.devices.ndim)
                        if d not in dims]
                arr = np.transpose(self.devices, rest + dims).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                for ranks in arr:
                    ranks = sorted(int(r) for r in ranks)
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axes] = g
        self._groups = groups
        return groups


def _world_ranks() -> list[int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def create_mesh(axes: dict[str, int] | None = None,
                devices: Sequence[int] | None = None, *,
                device=None) -> Mesh:
    """A Mesh with the given axis sizes over ``devices`` (ranks; default
    every rank of the world, or rank 0 alone without a process group).

    Axis sizes of 1 are kept; a single ``-1`` axis absorbs the remaining
    ranks; the axes are laid out in ``AXIS_ORDER`` (unknown names last).

    >>> create_mesh({"dp": -1}, range(4)).shape
    {'dp': 4}
    """
    devices = list(devices if devices is not None else _world_ranks())
    n = len(devices)
    axes = dict(axes or {"dp": n})

    wildcard = [k for k, v in axes.items() if v == -1]
    if len(wildcard) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(v for v in axes.values() if v != -1)
    if wildcard:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
        axes[wildcard[0]] = n // fixed
    elif fixed != n:
        raise ValueError(f"mesh axes {axes} need {fixed} devices, have {n}")

    names = tuple(sorted(axes, key=lambda a: AXIS_ORDER.index(a)
                         if a in AXIS_ORDER else 99))
    shape = tuple(axes[a] for a in names)
    return Mesh(np.asarray(devices).reshape(shape), names, device)


@dataclass(frozen=True)
class _Generation:
    chips_per_host: int
    devices_per_chip: int
    max_chips: int


# tf_operator_tpu/topology/slices.py's GENERATIONS and
# _SINGLE_HOST_MAX_CHIPS, the fields a mesh reads.
GENERATIONS = {
    "v4": _Generation(4, 1, 4096),
    "v5e": _Generation(4, 1, 256),
    "v5p": _Generation(4, 1, 8960),
    "v6e": _Generation(4, 1, 256),
}
_SINGLE_HOST_MAX_CHIPS = {"v4": 4, "v5e": 8, "v5p": 4, "v6e": 8}


class TopologyError(ValueError):
    """An accelerator type or topology the fleet does not offer."""


def slice_devices(accelerator_type: str, topology: str | None = None
                  ) -> tuple[str, int]:
    """``(canonical accelerator type, device count)`` of a TPU slice, with
    ``slices.resolve``'s checks and messages."""
    parts = accelerator_type.strip().lower().split("-")
    if len(parts) != 2 or parts[0] not in GENERATIONS:
        raise TopologyError(
            f"unknown accelerator type {accelerator_type!r}; expected "
            f"<generation>-<chips> with generation in {sorted(GENERATIONS)}"
        )
    try:
        chips = int(parts[1])
    except ValueError as e:
        raise TopologyError(f"bad chip count in {accelerator_type!r}") from e
    if chips <= 0:
        raise TopologyError(
            f"chip count must be positive in {accelerator_type!r}")
    name, gen = parts[0], GENERATIONS[parts[0]]
    if chips > gen.max_chips:
        raise TopologyError(
            f"{accelerator_type!r}: {chips} chips exceeds the {name} "
            f"maximum of {gen.max_chips}"
        )
    if topology:
        try:
            dims = tuple(int(d) for d in topology.lower().split("x"))
        except ValueError as e:
            raise TopologyError(f"bad topology string {topology!r}") from e
        if not dims or any(d <= 0 for d in dims):
            raise TopologyError(f"bad topology string {topology!r}")
        if math.prod(dims) != chips:
            raise TopologyError(
                f"topology {topology!r} has {math.prod(dims)} chips but "
                f"accelerator {accelerator_type!r} declares {chips}"
            )
    if chips > _SINGLE_HOST_MAX_CHIPS[name] and chips % gen.chips_per_host:
        raise TopologyError(
            f"{accelerator_type!r}: multi-host slices must be a multiple "
            f"of {gen.chips_per_host} chips/host"
        )
    return f"{name}-{chips}", chips * gen.devices_per_chip


def slice_mesh(accelerator_type: str, topology: str | None = None,
               devices: Sequence[int] | None = None,
               data_axis: str = "dp", *, device=None) -> Mesh:
    """Data-parallel mesh over exactly one TPU slice's worth of ranks:
    fails when the ranks do not number the slice's devices."""
    canonical, num_devices = slice_devices(accelerator_type, topology)
    devices = list(devices if devices is not None else _world_ranks())
    if len(devices) != num_devices:
        raise ValueError(
            f"slice {canonical} has {num_devices} devices "
            f"but {len(devices)} are visible"
        )
    return create_mesh({data_axis: len(devices)}, devices, device=device)


def multislice_mesh(num_slices: int, axes: dict[str, int] | None = None,
                    devices: Sequence[int] | None = None, *,
                    device=None) -> Mesh:
    """Mesh for a multislice job: ``dcn`` (cross-slice, outermost) x the
    per-slice ``axes`` (default all-dp), which describe ONE slice; the
    rank count must be ``num_slices`` x their product, slice-major."""
    devices = list(devices if devices is not None else _world_ranks())
    if len(devices) % num_slices:
        raise ValueError(
            f"{len(devices)} devices not divisible into {num_slices} slices")
    per_slice = len(devices) // num_slices
    axes = dict(axes or {"dp": per_slice})
    if math.prod(axes.values()) != per_slice:
        raise ValueError(
            f"per-slice axes {axes} need {per_slice} devices/slice")
    return create_mesh({"dcn": num_slices, **axes}, devices, device=device)


def host_local_batch_size(global_batch: int, mesh: Mesh,
                          axis: str = "dp") -> int:
    size = mesh.shape.get(axis, 1)
    if global_batch % size:
        raise ValueError(
            f"global batch {global_batch} not divisible by {axis}={size}")
    return global_batch // size


def check_data_parallel(mesh: Mesh, what: str) -> None:
    """Raise unless ``mesh`` is a port ``Mesh`` whose pipeline axis is 1:
    a mesh with ``pp`` above 1 trains the block stack as pipeline stages,
    through ``train/pp_lm.py``'s ``make_pp_lm_train_step`` (``ValueError``
    naming it). The data axes, ``ep``, ``sp`` and ``tp`` may take any
    size."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: expected a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    size = mesh.shape.get("pp", 1)
    if size > 1:
        raise ValueError(
            f"{what}: a mesh with pp={size} trains the pipelined LM: use "
            "train/pp_lm.py's make_pp_lm_train_step (--pp composes with dp "
            "only)")


# The axes a decode mesh keeps at 1, and the ROADMAP items that name them.
# A decode mesh takes ``tp`` (heads) and ``dp`` (slot slices and pool
# tiles, serve/sharding.py); JAX's server builds no mesh over ``sp``, its
# engine shards nothing over ``pp`` (``serve_lm --from-pp`` merges a
# pipelined tree instead), ``fsdp`` or ``ep``.
UNPORTED_DECODE_AXES = dict(sp="A8h (a decode mesh over sp)",
                            pp="A8k (a decode mesh over pp)",
                            fsdp="A8j (a decode mesh over fsdp or ep)",
                            ep="A8j (a decode mesh over fsdp or ep)",
                            dcn="A8g (serving across slices)")


def check_decode_mesh(mesh: Mesh, what: str) -> tuple[int, int]:
    """The ``(tp, dp)`` sizes of a decode mesh, after refusing (with
    ``NotImplementedError`` naming the ROADMAP item) a mesh whose
    sequence, expert, pipeline, fsdp or cross-slice axes are above 1."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: expected a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    for axis, item in UNPORTED_DECODE_AXES.items():
        size = mesh.shape.get(axis, 1)
        if size > 1:
            raise NotImplementedError(
                f"{what}: a decode mesh with {axis}={size} is not ported "
                f"yet: see ROADMAP.md {item}")
    return int(mesh.shape.get("tp", 1)), int(mesh.shape.get("dp", 1))
