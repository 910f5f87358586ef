"""Engine-state layout for tensor- and data-parallel decode, as data.

Counterpart of ``tf_operator_tpu/serve/sharding.py``. JAX lays one cache
pytree over a ``tp`` x ``dp`` mesh; the port runs one process a device,
so a spec here says which slice of each leaf a rank holds:

| engine state | spec | a rank holds |
| --- | --- | --- |
| paged pool ``pool_key``/``pool_value`` ``[nb, blk, KV, Dh]`` | ``("dp", None, "tp", None)`` | ``KV/tp`` heads of its dp shard's ``nb/dp`` blocks (``dp_pool``) |
| dense rows ``cached_key``/``cached_value`` ``[slots, b, S, KV, Dh]`` | ``("dp", None, None, "tp", None)`` | its shard's ``slots/dp`` rows, ``KV/tp`` heads |
| kv8 scales ``key_scale``/``value_scale`` ``[slots, b, S, KV]`` and ``pool_key_scale``/``pool_value_scale`` ``[nb, blk, KV]`` | as the rows they scale | the scales of its rows and heads |
| block tables, counters ``[slots, ...]`` | ``("dp", ...)`` | its shard's slots (``slot_spec``) |
| logits ``[slots, vocab]`` | ``("dp", "tp")`` | its shard's rows, its vocabulary slice; the tp group gathers the slice and rank 0 gathers the rows for its sampler |
| shipped rows ``[R, KV, Dh]``, kv8 scale rows ``[R, KV]`` (``ship_specs``) | ``(None, "tp", None)``, ``(None, "tp")`` | its ``KV/tp`` heads (``ship_heads``); no dp part: the owning shard's extent places them |

A leaf whose named dimension cannot tile (``KV % tp``, an odd vocab, a
slot count dp does not divide) stays whole on that dimension, the
convention of ``parallel/sharding.py``'s rules. Without ``dp_size`` (or
at 1) every spec is the tensor-parallel one.

The dp arithmetic (``shard_of_slot``, ``shard_block_extent``) is JAX's:
dp shard i owns the slots ``[i*per, (i+1)*per)`` and allocates blocks
only from its extent of the GLOBAL block indices, ``[i*nb/dp,
(i+1)*nb/dp)`` less the garbage block 0 in shard 0's. Host state (the
allocators, the prefix cache, a plan's tables, ``kv_debug``) keeps global
indices, so it compares with JAX's entry by entry. A rank of shard i
holds only its tile and turns a global entry ``g`` into a local index
(``local_block``): ``g - i*nb/dp`` on shard 0, where global block 0 is
local block 0, and ``g - i*nb/dp + 1`` on shard i >= 1, whose local
block 0 is a garbage block of its own. A table entry 0 (a shared or
unused write, the pad of a read) lands there on every shard, and never
in a block the shard owns. So each rank's pool is its tile, plus one
block on every shard but 0 (``local_pool_blocks``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np

# Leaf name -> index of the KV-head dimension counted FROM THE END, so the
# solo dense rows [b, S, KV, Dh] and the slot-stacked ones [slots, b, S,
# KV, Dh] both find KV at -2.
_HEAD_AXIS_FROM_END = {
    "pool_key": 2,      # [nb, blk, KV, Dh]
    "pool_value": 2,
    "cached_key": 2,    # [(slots,) b, S, KV, Dh]
    "cached_value": 2,
    "key_scale": 1,     # [(slots,) b, S, KV]
    "value_scale": 1,
    "pool_key_scale": 1,    # [nb, blk, KV]
    "pool_value_scale": 1,
}


# Leaf name -> the least rank at which dimension 0 is the SLOT axis (the
# dp split of the per-slot leaves): the slot-stacked dense leaves have one
# more dimension than their solo shapes. The pool is absent: it splits
# over dp only under ``dp_pool``.
_SLOT_LEADING_MIN_RANK = {
    "cached_key": 5,    # [slots, b, S, KV, Dh] (solo 4)
    "cached_value": 5,
    "key_scale": 4,     # [slots, b, S, KV]     (solo 3)
    "value_scale": 4,
    "block_table": 2,   # [slots, table_len]
    "cache_index": 1,   # [slots]               (solo: a scalar)
    "pos_index": 1,
}

# Leaf name -> the least rank at which dimension 0 is the BLOCK axis (the
# dp split of the pool under ``dp_pool``, with the allocators' extents).
_POOL_LEADING_MIN_RANK = {
    "pool_key": 4,        # [nb, blk, KV, Dh]
    "pool_value": 4,
    "pool_key_scale": 3,  # [nb, blk, KV]
    "pool_value_scale": 3,
}


def _tiles(shape: tuple, dim: int, size: int) -> bool:
    """Can an axis of ``size`` tile dimension ``dim`` of ``shape``?"""
    return 0 <= dim < len(shape) and size > 0 and shape[dim] % size == 0


def leaf_spec(name: str, shape: tuple, tp_size: int,
              tp_axis: str = "tp", dp_size: int = 1, dp_axis: str = "dp",
              dp_pool: bool = False) -> tuple:
    """The spec of one cache leaf by name and shape: the KV storage leaves
    split over tp on their head dimension when it tiles; the per-slot
    leaves over dp on their slot dimension when it tiles; the pool's block
    dimension over dp too under ``dp_pool`` (legal only with the
    allocators' extents, ``shard_block_extent``). A leaf that splits on
    nothing is whole, ``()``."""
    shape = tuple(shape)
    spec = [None] * len(shape)
    from_end = _HEAD_AXIS_FROM_END.get(name)
    if from_end is not None and tp_size > 1:
        dim = len(shape) - from_end
        if _tiles(shape, dim, tp_size):
            spec[dim] = tp_axis
    if dp_size > 1:
        rank = _SLOT_LEADING_MIN_RANK.get(name)
        if dp_pool and rank is None:
            rank = _POOL_LEADING_MIN_RANK.get(name)
        if rank is not None and len(shape) >= rank and _tiles(shape, 0,
                                                              dp_size):
            spec[0] = dp_axis
    return tuple(spec) if any(spec) else ()


def cache_specs(tree: Any, tp_size: int, tp_axis: str = "tp",
                dp_size: int = 1, dp_axis: str = "dp",
                dp_pool: bool = False) -> Any:
    """The spec tree of a cache (nested dicts and lists of tensors), each
    leaf by ``leaf_spec``. Non-tensor leaves (a solo cache's int counter)
    map to ``()``."""
    def walk(name, node):
        if isinstance(node, Mapping):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(name, v) for v in node]
        shape = tuple(getattr(node, "shape", ()))
        return leaf_spec(name, shape, tp_size, tp_axis, dp_size, dp_axis,
                         dp_pool)

    return walk("", tree)


def logits_spec(shape: tuple, tp_size: int, tp_axis: str = "tp",
                dp_size: int = 1, dp_axis: str = "dp") -> tuple:
    """The ``[slots, vocab]`` logits' spec: vocabulary-split as the
    lm_head is, slot-split over dp; each part only where it tiles."""
    shape = tuple(shape)
    spec = [None] * len(shape)
    if tp_size > 1 and _tiles(shape, len(shape) - 1, tp_size):
        spec[-1] = tp_axis
    if dp_size > 1 and len(shape) >= 2 and _tiles(shape, 0, dp_size):
        spec[0] = dp_axis
    return tuple(spec) if any(spec) else ()


def slot_spec(shape: tuple, dp_size: int, dp_axis: str = "dp") -> tuple:
    """The spec of a slot-leading engine vector (counters, sampling keys,
    FSM rows): dimension 0 over dp when it tiles, else whole."""
    shape = tuple(shape)
    if dp_size > 1 and _tiles(shape, 0, dp_size):
        return (dp_axis,) + (None,) * (len(shape) - 1)
    return ()


def shard_of_slot(slot: int, max_slots: int, dp_size: int) -> int:
    """The dp shard that owns ``slot``: shard i holds the contiguous slots
    ``[i*per, (i+1)*per)``, ``per = max_slots // dp``. The allocators, the
    admission planner and every rank's engine use this function."""
    if dp_size <= 1:
        return 0
    per = max_slots // dp_size
    return min(int(slot) // per, dp_size - 1)


def shard_block_extent(shard: int, num_blocks: int, dp_size: int,
                       reserved: int = 1) -> tuple[int, int]:
    """``[lo, hi)`` of the global block indices dp shard ``shard`` may
    allocate: its contiguous tile of the block axis, the ``reserved``
    garbage blocks excluded from shard 0's (the last shard takes any
    remainder)."""
    if dp_size <= 1:
        return reserved, num_blocks
    per = num_blocks // dp_size
    lo, hi = shard * per, (shard + 1) * per
    if shard == dp_size - 1:
        hi = num_blocks
    return max(lo, reserved), hi


def local_pool_blocks(shard: int, num_blocks: int, dp_size: int) -> int:
    """The blocks of dp shard ``shard``'s pool on its ranks: its tile, plus
    a garbage block of its own on every shard but 0 (whose tile holds
    global block 0). ``num_blocks`` at dp 1."""
    if dp_size <= 1:
        return num_blocks
    per = num_blocks // dp_size
    hi = num_blocks if shard == dp_size - 1 else (shard + 1) * per
    return hi - shard * per + (1 if shard else 0)


def local_block(table, shard: int, num_blocks: int, dp_size: int):
    """Global block indices (an int or an array of them) as indices of
    dp shard ``shard``'s own pool: entry 0 to its garbage block (local 0),
    every other entry, which must lie in the shard's tile, shifted by the
    tile's start (and by the garbage block on shard >= 1). The identity at
    dp 1."""
    if dp_size <= 1:
        return table
    per = num_blocks // dp_size
    g = np.asarray(table, np.int64)
    out = np.where(g == 0, 0, g - shard * per + (1 if shard else 0))
    return out.astype(np.int32) if out.ndim else int(out)


# Wire part -> the pool leaf its rows land in (serve/kvcache.py's
# POOL_WIRE_PARTS, inverted).
_WIRE_POOL_LEAF = {
    "key": "pool_key",
    "value": "pool_value",
    "key_scale": "pool_key_scale",
    "value_scale": "pool_value_scale",
}


def ship_specs(rows: Any, tp_size: int, tp_axis: str = "tp") -> dict:
    """The spec of each part of a shipment's wire rows (``serve/disagg.py``
    ``Shipment.rows``: path -> part -> ``[R, KV, Dh]`` K/V or ``[R, KV]``
    kv8 scales; tensors, arrays or bare shapes), as JAX's: each part split
    over tp on its head dimension exactly as the pool leaf it lands in
    (the from-the-end addressing finds KV in the rows as in the pool), so
    each tp rank takes its own heads (``ship_heads``). No dp part: wire
    rows sit below the pool's block-axis rank, so they reach every dp
    shard whole and the extent-bounded allocation places them on the
    owning shard's tile. Pure data.

    JAX names every part but ``key`` after ``pool_value``, which on a
    scale row ``[R, KV]`` finds its row dimension; here each part takes
    its own pool leaf's entry, so a scale row splits on its heads, as the
    scale pool does. K/V parts are JAX's spec exactly."""
    out: dict = {}
    for path, parts in rows.items():
        out[path] = {}
        for part, leaf in parts.items():
            shape = tuple(getattr(leaf, "shape", leaf))
            out[path][part] = leaf_spec(
                _WIRE_POOL_LEAF.get(part, "pool_value"), shape, tp_size,
                tp_axis)
    return out


def ship_heads(rows: dict, tp_size: int, tp_index: int,
               tp_axis: str = "tp") -> dict:
    """Tensor-parallel rank ``tp_index``'s part of a shipment's rows (path
    -> part -> tensor): each part that ``ship_specs`` splits over tp cut
    to the rank's contiguous ``1/tp`` of it, the heads its pool holds;
    a part that does not tile stays whole, as the pool's heads do."""
    specs = ship_specs(rows, tp_size, tp_axis)
    out: dict = {}
    for path, parts in rows.items():
        out[path] = {}
        for part, leaf in parts.items():
            spec = specs[path][part]
            if tp_axis in spec:
                dim = spec.index(tp_axis)
                n = leaf.shape[dim] // tp_size
                leaf = leaf.narrow(dim, tp_index * n, n)
            out[path][part] = leaf
    return out


def tp_size_of(mesh: Any, tp_axis: str = "tp") -> int:
    """The size of ``mesh``'s tensor axis (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(tp_axis, 1))


def dp_size_of(mesh: Any, dp_axis: str = "dp") -> int:
    """The size of ``mesh``'s data axis (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(dp_axis, 1))


def mesh_debug(mesh: Any) -> dict:
    """The /debug/serve and /healthz mesh shape: the device count and the
    named axis sizes, ``{"devices": 1}`` on one device."""
    if mesh is None:
        return {"devices": 1}
    return {
        "devices": int(mesh.devices.size),
        "axes": {name: int(size) for name, size in mesh.shape.items()},
    }
