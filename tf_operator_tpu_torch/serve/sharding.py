"""Engine-state layout for tensor-parallel decode, as data.

Counterpart of ``tf_operator_tpu/serve/sharding.py``'s tensor-parallel
half. JAX lays one cache pytree over a ``tp`` mesh; the port runs one
process a device, so a spec here says which slice of each leaf a rank
holds:

| engine state | spec | a rank holds |
| --- | --- | --- |
| paged pool ``pool_key``/``pool_value`` ``[nb, blk, KV, Dh]`` | ``(None, None, "tp", None)`` | ``KV/tp`` heads of every block |
| dense rows ``cached_key``/``cached_value`` ``[(slots,) b, S, KV, Dh]`` | tp on KV | the same head split |
| kv8 scales ``key_scale``/``value_scale`` ``[(slots,) b, S, KV]`` and ``pool_key_scale``/``pool_value_scale`` ``[nb, blk, KV]`` | tp on KV (the last axis) | the scales of its heads |
| block tables, counters, sampling state | ``()`` | all of it (rank 0's engine keeps the host state) |
| logits ``[slots, vocab]`` | ``(None, "tp")`` | its vocabulary slice, gathered for rank 0's sampler |

A leaf whose named dimension cannot tile (``KV % tp``, an odd vocab)
stays whole, the convention of ``parallel/sharding.py``'s rules. The
data-parallel half (``slot_spec``, ``shard_of_slot``,
``shard_block_extent``, ``dp_pool``, ``ship_specs``) comes with its first
caller, ROADMAP A8b's second half.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

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


def _tiles(shape: tuple, dim: int, size: int) -> bool:
    """Can an axis of ``size`` tile dimension ``dim`` of ``shape``?"""
    return 0 <= dim < len(shape) and size > 0 and shape[dim] % size == 0


def leaf_spec(name: str, shape: tuple, tp_size: int,
              tp_axis: str = "tp") -> tuple:
    """The spec of one cache leaf by name and shape: the KV storage leaves
    split on their head dimension when it tiles, every other leaf (or a
    non-tiling one) whole, ``()``."""
    shape = tuple(shape)
    from_end = _HEAD_AXIS_FROM_END.get(name)
    if from_end is None or tp_size <= 1:
        return ()
    dim = len(shape) - from_end
    if not _tiles(shape, dim, tp_size):
        return ()
    spec = [None] * len(shape)
    spec[dim] = tp_axis
    return tuple(spec)


def cache_specs(tree: Any, tp_size: int, tp_axis: str = "tp") -> Any:
    """The spec tree of a cache (nested dicts and lists of tensors): K/V
    storage split over tp on its heads, the rest whole. Non-tensor leaves
    (a dense cache's int counter) map to ``()``."""
    def walk(name, node):
        if isinstance(node, Mapping):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(name, v) for v in node]
        shape = tuple(getattr(node, "shape", ()))
        return leaf_spec(name, shape, tp_size, tp_axis)

    return walk("", tree)


def logits_spec(shape: tuple, tp_size: int, tp_axis: str = "tp") -> tuple:
    """The ``[slots, vocab]`` logits' spec: vocabulary-split as the
    lm_head is, or whole when the vocabulary does not tile."""
    shape = tuple(shape)
    if tp_size > 1 and _tiles(shape, len(shape) - 1, tp_size):
        return (None,) * (len(shape) - 1) + (tp_axis,)
    return ()


def tp_size_of(mesh: Any, tp_axis: str = "tp") -> int:
    """The size of ``mesh``'s tensor axis (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(tp_axis, 1))


def mesh_debug(mesh: Any) -> dict:
    """The /debug/serve and /healthz mesh shape: the device count and the
    named axis sizes, ``{"devices": 1}`` on one device."""
    if mesh is None:
        return {"devices": 1}
    return {
        "devices": int(mesh.devices.size),
        "axes": {name: int(size) for name, size in mesh.shape.items()},
    }
