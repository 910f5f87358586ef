"""Paged KV-cache storage for continuous batching, in PyTorch.

Counterpart of ``tf_operator_tpu/serve/kvcache.py`` for the block-paged
pool, the dense slot tensor and the shipped-KV pool write (the layout
over a mesh is ``serve/sharding.py``'s). Per layer, one pool of
``[kv_num_blocks, kv_block, KV, Dh]`` token blocks; each slot carries a
``[max_seq_len // kv_block]`` int32 block table and a position counter
(``models/transformer.py`` describes the cache dict). Block 0 is the pinned garbage block that
unused table entries point at: never allocated, always masked.

The dense slot tensor (``stack_slots``, ``dense_insert``) is the solo
dense cache with one row of ``max_seq_len`` positions a slot and a
counter a slot: the draft cache of a speculative engine. JAX stacks the
solo ``[1, S, KV, Dh]`` leaves over a new slot axis and vmaps the solo
forward over it; the port folds the solo batch of one into the slot
axis, so the stacked cache is a dense cache of ``max_slots`` lanes that
one batched forward of the model reads with a counter a lane.

The device functions below update the cache IN PLACE. The JAX module
builds each as a jitted, donated executable that returns a new tree, so
one executable serves every join; eager PyTorch needs neither.

``SlotAllocator``, ``BlockAllocator`` and ``PrefixCache`` are this
package's own copies of the JAX module's host classes (that module
imports JAX), with their dp shards (slot slices, block extents, prefix
probes within an extent); ``POOL_KEYS`` and
``POOL_WIRE_PARTS`` are its own copies of that module's tables of pool
leaves.
"""

from __future__ import annotations

import hashlib
import heapq
import threading
from dataclasses import dataclass

import numpy as np
import torch

from tf_operator_tpu_torch.models.transformer import DENSE_NAMES, POOL_NAMES

# Paged pool leaf -> the dense (solo) leaf holding the same rows:
# pool_key/pool_value -> cached_key/cached_value and, under kv_int8, the
# f32 [nb, blk, KV] scale pools pool_key_scale/pool_value_scale ->
# key_scale/value_scale. The scales address their rows by the same
# table[pos // blk] * blk + pos % blk math as the K/V blocks, so one walk
# over the leaves a layer holds serves the scatter, the gather and the
# copy-on-write.
POOL_KEYS = dict(zip(POOL_NAMES, DENSE_NAMES))

# Paged pool leaf -> the part name its rows travel under in the shipped-KV
# wire format (serve/disagg.py): K/V rows as "key"/"value", the kv_int8
# per-(token, head) f32 scales as "key_scale"/"value_scale" ([R, KV] rows,
# no Dh axis). One table for the ingest write (``pool_write``) and the
# engine's coverage check, so a new pool leaf cannot miss the wire.
POOL_WIRE_PARTS = {
    "pool_key": "key",
    "pool_value": "value",
    "pool_key_scale": "key_scale",
    "pool_value_scale": "value_scale",
}


def paged_cache_template(model, max_slots: int) -> dict:
    """The paged engine's whole cache: per-layer pools, per-lane block
    tables (all entries on block 0) and per-lane counters."""
    return model.init_cache(max_slots, paged=True)


def solo_cache_template(model) -> dict:
    """The empty solo dense cache of one request: ``[1, max_seq_len, KV,
    Dh]`` rows per layer (and the kv_int8 scales), counter 0."""
    return model.init_cache(1, paged=False)


def stack_slots(template: dict, max_slots: int) -> dict:
    """The dense slot tensor: each of ``template``'s leaves (a solo dense
    cache) as zeros with ``max_slots`` rows in place of its one, and a
    ``[max_slots]`` int32 counter, one a slot. One allocation up front;
    occupancy changes never allocate again."""
    layers = [{name: torch.zeros((max_slots, *leaf.shape[1:]),
                                 dtype=leaf.dtype, device=leaf.device)
               for name, leaf in layer.items()}
              for layer in template["layers"]]
    dev = layers[0]["cached_key"].device
    return {"layers": layers,
            "cache_index": torch.zeros(max_slots, dtype=torch.int32,
                                       device=dev)}


def dense_insert(stacked: dict, slot: int, solo: dict) -> dict:
    """Land a finished solo dense prefill in slot ``slot`` of the dense
    slot tensor, in place: every leaf's row (all ``max_seq_len``
    positions, so nothing of the slot's last occupant stays below the
    counter) and the counter. The JAX module's ``make_insert_fn``."""
    for ls, lo in zip(stacked["layers"], solo["layers"]):
        for name, leaf in ls.items():
            leaf[slot] = lo[name][0]
    stacked["cache_index"][slot] = int(solo["cache_index"])
    return stacked


def mask_inactive_indices(cache: dict, active: torch.Tensor) -> dict:
    """Zero the counters of inactive slots (``active`` is ``[N]`` bool),
    in place, in the paged and the dense stacked layouts alike. Inactive
    slots still run the fixed-shape step. Paged: at index 0 their K/V
    writes are dropped, so a retired lane's stale table can never write
    into a block that went to another lane. Dense: they write into their
    own rows, which the next join's ``dense_insert`` overwrites."""
    cache["cache_index"].mul_(active.to(cache["cache_index"].dtype))
    return cache


def paged_insert(cache: dict, slot: int, write_table: np.ndarray,
                 read_table: np.ndarray, solo: dict, block: int) -> dict:
    """Land a finished solo prefill in the pool: the prompt rows of the
    dense ``solo`` cache whose ``write_table`` entry is a real block go to
    that block (entries 0 mark shared-prefix rows, already resident in
    the donor's blocks), every pool leaf present (K/V and, under
    kv_int8, their scales); the slot's table row becomes ``read_table``
    and its counter the solo counter. The JAX insert scatters all
    max_seq_len rows and dumps the unwanted ones into block 0 so that one
    executable serves every join; here only the rows that matter move."""
    n = int(solo["cache_index"])
    pos = np.arange(n)
    blocks = np.asarray(write_table)[pos // block]
    keep = blocks != 0
    dev = cache["block_table"].device
    flat = torch.as_tensor(blocks[keep] * block + pos[keep] % block,
                           device=dev)
    src = torch.as_tensor(pos[keep], device=dev)
    for lp, ls in zip(cache["layers"], solo["layers"]):
        for pname, dname in _leaves(lp):
            pool = lp[pname]
            nb, blk = pool.shape[:2]
            pool.view(nb * blk, *pool.shape[2:])[flat] = ls[dname][0, src]
    return table_insert(cache, slot, read_table, n)


def _leaves(layer: dict):
    """(pool leaf, dense leaf) of each ``POOL_KEYS`` entry the layer
    holds."""
    return [(p, d) for p, d in POOL_KEYS.items() if p in layer]


def table_insert(cache: dict, slot: int, read_table: np.ndarray,
                 index: int) -> dict:
    """Set only the slot's table row and counter: the exact-prefix join,
    where every prompt row already lives in shared blocks."""
    cache["block_table"][slot] = torch.as_tensor(
        np.asarray(read_table, np.int32), device=cache["block_table"].device)
    cache["cache_index"][slot] = int(index)
    return cache


def pool_write(cache: dict, write_table: np.ndarray, rows: list,
               block: int) -> dict:
    """Write SHIPPED rows into the pool through ``write_table``, in place:
    the disaggregated-prefill ingest (serve/disagg.py). ``rows`` holds,
    per layer, ``{pool leaf: [R, ...] tensor}`` (K/V ``[R, KV, Dh]``, the
    kv_int8 scales ``[R, KV]``); row ``r`` goes to flat pool row
    ``write_table[r // block] * block + r % block``, cast to the leaf's
    dtype. No slot's table or counter changes: the request that owns the
    rows joins later through the exact-prefix ``table_insert``, which is
    what makes shipped decode bit-identical to local. The JAX module's
    ``make_pool_write_fn`` pads every shipment to max_seq_len rows so that
    one executable serves all, its pad rows landing in the pinned garbage
    block 0 through the 0 entries of the table; here only the shipment's
    rows move, and a 0 entry still sends its rows to block 0."""
    dev = cache["block_table"].device
    n_rows = max((int(r.shape[0]) for layer in rows for r in layer.values()),
                 default=0)
    pos = np.arange(n_rows)
    flat = torch.as_tensor(
        np.asarray(write_table, np.int64)[pos // block] * block + pos % block,
        device=dev)
    for lp, lr in zip(cache["layers"], rows):
        for pname, r in lr.items():
            pool = lp[pname]
            nb, blk = pool.shape[:2]
            pool.view(nb * blk, *pool.shape[2:])[flat[:r.shape[0]]] = r.to(
                device=dev, dtype=pool.dtype)
    return cache


def gather_solo(cache: dict, table: np.ndarray) -> dict:
    """A solo dense cache whose K/V rows (and scales) are ``table``'s
    blocks in order, counter 0: the seed of a shared-prefix suffix
    prefill. Rows past the
    shared prefix are whatever those blocks hold; the suffix prefill
    overwrites them before it reads them."""
    idx = torch.as_tensor(np.asarray(table, np.int64),
                          device=cache["block_table"].device)
    layers = []
    for lp in cache["layers"]:
        row = {}
        for pname, dname in _leaves(lp):
            pool = lp[pname]
            row[dname] = pool[idx].reshape(1, -1, *pool.shape[2:])
        layers.append(row)
    return {"layers": layers, "cache_index": 0}


def cow_copy(cache: dict, slot: int, entry: int, src: int, dst: int) -> dict:
    """Copy-on-write: every layer's pool block ``src`` copied into
    ``dst``, in every pool leaf (a copy that left the kv_int8 scales
    behind would decode with zeroed scales), and the slot's table entry
    switched to ``dst``."""
    for lp in cache["layers"]:
        for pname, _ in _leaves(lp):
            lp[pname][dst] = lp[pname][src]
    cache["block_table"][slot, entry] = int(dst)
    return cache


class SlotAllocator:
    """Free-slot bookkeeping (host-side, thread-safe): lowest free index
    first, from a heap, with a high-water mark and an acquire count.

    ``dp`` > 1 splits the slots into ``dp`` contiguous slices
    (``sharding.shard_of_slot``), one heap each: ``acquire(shard=i)`` is
    the lowest free slot of dp shard i, ``acquire()`` the lowest free slot
    of all, which at dp 1 is the single heap's."""

    def __init__(self, max_slots: int, dp: int = 1) -> None:
        if max_slots < 1:
            raise ValueError(f"max_slots={max_slots} must be >= 1")
        if dp < 1 or max_slots % dp:
            raise ValueError(
                f"dp={dp} must be >= 1 and divide max_slots={max_slots}")
        self.max_slots = max_slots
        self.dp = dp
        self._per = max_slots // dp
        # Ascending ranges are heaps already.
        self._heaps = [list(range(i * self._per, (i + 1) * self._per))
                       for i in range(dp)]
        self._free_set = set(range(max_slots))
        self._lock = threading.Lock()
        self.acquired_total = 0
        self.high_water = 0

    def acquire(self, shard: int | None = None) -> int | None:
        """The lowest free slot index, of all (``shard`` None) or of dp
        shard ``shard``'s slice; None when that scope is full."""
        with self._lock:
            if shard is None:
                heap = next((h for h in self._heaps if h), None)
            else:
                heap = self._heaps[shard]
            if not heap:
                return None
            slot = heapq.heappop(heap)
            self._free_set.discard(slot)
            self.acquired_total += 1
            self.high_water = max(self.high_water, self.in_use)
            return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if not 0 <= slot < self.max_slots:
                raise ValueError(f"slot {slot} out of range")
            if slot in self._free_set:
                raise ValueError(f"slot {slot} double-released")
            heapq.heappush(self._heaps[slot // self._per], slot)
            self._free_set.add(slot)

    def free_in(self, shard: int) -> int:
        """Free slots in dp shard ``shard``'s slice."""
        with self._lock:
            return len(self._heaps[shard])

    @property
    def in_use(self) -> int:
        return self.max_slots - len(self._free_set)

    @property
    def free(self) -> int:
        return len(self._free_set)


class BlockAllocator:
    """Refcounted allocator for the block pool (host-side, thread-safe).
    Blocks below ``reserved`` (the garbage block 0) are never handed
    out; lowest free index first. A shared block carries one reference
    per holder; ``free`` returns the blocks whose last holder left.

    ``dp`` > 1 splits the block indices into the dp shards' extents
    (``sharding.shard_block_extent``), one heap each: ``alloc(k,
    shard=i)`` grants blocks of dp shard i's extent only, ``alloc(k)``
    the lowest free of all, which at dp 1 is the single heap's."""

    def __init__(self, num_blocks: int, reserved: int = 1,
                 dp: int = 1) -> None:
        from tf_operator_tpu_torch.serve.sharding import shard_block_extent

        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks={num_blocks} must exceed the {reserved} "
                "reserved block(s)"
            )
        if dp < 1:
            raise ValueError(f"dp={dp} must be >= 1")
        if dp > 1 and num_blocks // dp <= reserved:
            raise ValueError(
                f"num_blocks={num_blocks} leaves dp shard 0 no "
                f"allocatable blocks past the {reserved} reserved "
                f"(need num_blocks // dp > reserved at dp={dp})")
        self.num_blocks = num_blocks
        self.reserved = reserved
        self.dp = dp
        self._per = num_blocks // dp
        self._extents = [shard_block_extent(i, num_blocks, dp, reserved)
                         for i in range(dp)]
        self._heaps = [list(range(lo, hi)) for lo, hi in self._extents]
        self._free_set = set().union(*map(set, self._heaps))
        self._refs: dict[int, int] = {}
        self._lock = threading.Lock()
        self.high_water = 0

    def alloc(self, k: int, shard: int | None = None) -> list[int] | None:
        """The k lowest free blocks at refcount 1, of all (``shard`` None)
        or of dp shard ``shard``'s extent; None when fewer than k are free
        there (all or nothing)."""
        with self._lock:
            heaps = self._heaps if shard is None else [self._heaps[shard]]
            if k > sum(len(h) for h in heaps):
                return None
            out: list[int] = []
            for _ in range(k):
                heap = min((h for h in heaps if h), key=lambda h: h[0])
                out.append(heapq.heappop(heap))
            for blk in out:
                self._free_set.discard(blk)
                self._refs[blk] = 1
            self.high_water = max(self.high_water, self.used)
            return out

    def ref(self, blocks) -> None:
        """Bump the refcounts of live blocks (prefix sharing)."""
        with self._lock:
            for blk in blocks:
                if blk not in self._refs:
                    raise ValueError(f"block {blk} is not live")
                self._refs[blk] += 1

    def free(self, blocks) -> list[int]:
        """Drop one reference each; returns the blocks that hit zero."""
        freed: list[int] = []
        with self._lock:
            for blk in blocks:
                rc = self._refs.get(blk)
                if rc is None:
                    raise ValueError(f"block {blk} double-freed")
                if rc > 1:
                    self._refs[blk] = rc - 1
                    continue
                del self._refs[blk]
                shard = min(blk // self._per, self.dp - 1)
                heapq.heappush(self._heaps[shard], blk)
                self._free_set.add(blk)
                freed.append(blk)
        return freed

    def free_in(self, shard: int) -> int:
        """Free blocks in dp shard ``shard``'s extent."""
        with self._lock:
            return len(self._heaps[shard])

    def shard_extent(self, shard: int) -> tuple[int, int]:
        """``[lo, hi)`` of the global blocks dp shard ``shard`` allocates:
        the ``within`` bound of its prefix probes."""
        return self._extents[shard]

    @property
    def free_blocks(self) -> int:
        return len(self._free_set)

    @property
    def used(self) -> int:
        return self.num_blocks - self.reserved - len(self._free_set)

    @property
    def shared(self) -> int:
        """Blocks currently referenced by more than one holder."""
        with self._lock:
            return sum(1 for rc in self._refs.values() if rc >= 2)


@dataclass
class _PrefixEntry:
    tokens: np.ndarray         # the prefix itself (collision guard)
    n: int                     # prefix length in tokens
    blocks: tuple[int, ...]    # physical blocks holding rows [0:n)
    logits: np.ndarray | None  # last-position logits (exact entries)


class PrefixCache:
    """Block-aligned prefix registry for copy-on-write prefix sharing.

    Keys are chained per-block SHA-1 digests (``D_k = sha1(D_{k-1} +
    block_k)``, the exact partial tail chained once more), so registering
    or probing every aligned prefix of a prompt hashes each token once. A
    digest hit compares the stored tokens, so a collision is a miss. An
    admitted prompt registers every full-block prefix plus the exact
    prompt with its last-position logits, so an identical prompt skips
    prefill. Entries reference live blocks only: ``invalidate_blocks``
    drops every entry touching a block whose last holder released it.
    Persistence past a request's own slot is the engine's job: with
    retention on (``ContinuousEngine.prefix_retain_max`` > 0) it takes
    one extra pool reference per exact-entry block at registration
    (``exact_hold`` is its read), so the entry outlives its slot until
    the bounded retained set evicts it."""

    _SEED = hashlib.sha1(b"tpu-kv-prefix").digest()

    def __init__(self, block: int) -> None:
        self.block = block
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._by_block: dict[int, set[bytes]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _chain_keys(self, tokens: np.ndarray) -> list[tuple[int, bytes]]:
        """[(n_tokens, digest)] for every full-block prefix plus the exact
        length, longest first."""
        n_tok, blk = len(tokens), self.block
        digest = self._SEED
        keys: list[tuple[int, bytes]] = []
        for k in range(n_tok // blk):
            digest = hashlib.sha1(
                digest + tokens[k * blk:(k + 1) * blk].tobytes()
            ).digest()
            keys.append(((k + 1) * blk, digest))
        if n_tok % blk:
            keys.append((n_tok, hashlib.sha1(
                digest + tokens[(n_tok // blk) * blk:].tobytes()
            ).digest()))
        keys.reverse()
        return keys

    def _match(self, tokens: np.ndarray,
               within: tuple[int, int] | None = None):
        """The longest usable entry for ``tokens`` (the lock held):
        ``(n, key, entry)`` or None. A full-length match without logits
        (registered as a longer prompt's prefix) is skipped: it would leave
        nothing to prefill and nothing to sample from. ``within=(lo, hi)``
        (a dp shard's block extent) skips an entry holding a block outside
        it: that shard's tables cannot reach a donor on another shard."""
        n_tok = len(tokens)
        for n, key in self._chain_keys(tokens):
            e = self._entries.get(key)
            if (e is None or e.n != n
                    or not np.array_equal(e.tokens, tokens[:n])):
                continue
            if n == n_tok and e.logits is None:
                continue
            if within is not None and any(
                    not within[0] <= b < within[1] for b in e.blocks):
                continue
            return n, key, e
        return None

    def lookup(self, tokens: np.ndarray,
               within: tuple[int, int] | None = None):
        """Longest usable prefix of ``tokens``: the exact prompt first
        (it may end mid-block, which is what makes copy-on-write
        reachable), else the longest registered full-block prefix, within
        a dp shard's extent when ``within`` is given (``_match``).
        Returns (n_tokens, blocks, logits | None); logits only on an
        exact whole-prompt match. Counts a hit or a miss and moves a hit
        to the hot end of the LRU order."""
        tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        with self._lock:
            m = self._match(tokens, within)
            if m is not None:
                n, key, e = m
                self.hits += 1
                self._entries[key] = self._entries.pop(key)  # LRU refresh
                return n, tuple(e.blocks), (
                    e.logits if n == len(tokens) else None)
            self.misses += 1
        return 0, (), None

    def peek(self, tokens: np.ndarray,
             within: tuple[int, int] | None = None):
        """``lookup`` without its side effects (no counter, no LRU move):
        the probe of every dp shard by which admission picks one, so that
        only the chosen shard's ``lookup`` counts."""
        tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        with self._lock:
            m = self._match(tokens, within)
        if m is None:
            return 0, (), None
        n, _, e = m
        return n, tuple(e.blocks), (e.logits if n == len(tokens) else None)

    def register(self, tokens: np.ndarray, blocks,
                 logits: np.ndarray | None = None) -> None:
        """Register an admitted prompt: ``blocks`` are its table entries
        (shared ones included; an existing digest is kept, first writer
        wins), ``logits`` its last position's row."""
        tokens = np.ascontiguousarray(
            np.array(tokens, np.int32, copy=True).reshape(-1))
        blocks = [int(b) for b in blocks]
        n_tok, blk = len(tokens), self.block
        with self._lock:
            for n, key in self._chain_keys(tokens):
                self._add(key, tokens[:n], n, blocks[: -(-n // blk)],
                          logits if n == n_tok else None)

    def _add(self, key, toks, n, blks, logits):
        e = self._entries.get(key)
        if e is not None:
            if (logits is not None and e.logits is None and e.n == n
                    and np.array_equal(e.tokens, toks)):
                # First registered as a longer prompt's aligned prefix;
                # this exact admission supplies its sampling row.
                e.logits = np.array(logits, copy=True)
            return
        self._entries[key] = _PrefixEntry(
            toks, n, tuple(blks),
            None if logits is None else np.array(logits, copy=True),
        )
        for b in blks:
            self._by_block.setdefault(b, set()).add(key)

    def invalidate_blocks(self, freed) -> list[_PrefixEntry]:
        """Drop every entry referencing a block whose last holder just
        released it; returns the dropped entries: the engine's host-tier
        spill hook (serve/tier.py). The pool rows they reference stay
        intact until the freed blocks are reallocated, so a caller that
        serializes them before its next allocation reads valid K/V."""
        dropped: list[_PrefixEntry] = []
        with self._lock:
            for blk in freed:
                for key in self._by_block.pop(blk, ()):
                    e = self._entries.pop(key, None)
                    if e is None:
                        continue
                    dropped.append(e)
                    for other in e.blocks:
                        if other != blk:
                            peers = self._by_block.get(other)
                            if peers is not None:
                                peers.discard(key)
        return dropped

    @property
    def entries(self) -> int:
        return len(self._entries)

    # -- fleet-global prefix reuse ------------------------------------------

    def advertise(self, cap: int = 32) -> list[str]:
        """The replica's hot-prefix advertisement: hex digests of up to
        ``cap`` entries, most recently used first (dict order is the LRU
        order: ``lookup`` hits refresh it, registrations append at the hot
        end). It rides /healthz so a fleet router can score prefix hits;
        entries reference LIVE blocks only, so a digest can go stale
        between the advertisement and a pull, which is why
        ``/prefix/<digest>`` answers the typed ``prefix_not_found``
        instead of trusting this list."""
        if cap <= 0:
            return []  # NOT [-0:], which would be the whole table
        with self._lock:
            keys = list(self._entries)[-int(cap):]
        keys.reverse()
        return [k.hex() for k in keys]

    def entry_for_hex(self, digest_hex: str):
        """The live EXACT entry (stored sampling logits) under a hex
        digest, as ``(tokens, n, blocks, logits)`` copies: the ``GET
        /prefix/<digest>`` export's read. None when the digest names
        nothing live, or only a longer prompt's aligned prefix (no logits:
        the wire format cannot ship it, and a puller could not exact-join
        it)."""
        try:
            key = bytes.fromhex(digest_hex)
        except ValueError:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.logits is None:
                return None
            return (np.array(e.tokens, np.int32, copy=True), e.n,
                    tuple(e.blocks), np.array(e.logits, copy=True))

    def exact_hold(self, tokens) -> tuple[bytes, tuple[int, ...]] | None:
        """``(digest, blocks)`` of the live exact-length entry for
        ``tokens`` (sampling row present): the engine's retention hook,
        the blocks it must extra-reference to keep this entry alive past
        its last slot. None when the exact digest is unregistered,
        collided, or only a longer prompt's aligned prefix (nothing worth
        pinning: it could never exact-join or export)."""
        tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        with self._lock:
            n, key = self._chain_keys(tokens)[0]
            e = self._entries.get(key)
            if (e is None or e.logits is None or e.n != n
                    or not np.array_equal(e.tokens, tokens)):
                return None
            return key, tuple(e.blocks)
