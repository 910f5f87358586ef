"""Host-RAM KV block tier: the second level of the serving memory
hierarchy.

Counterpart of ``tf_operator_tpu/serve/tier.py``, this package's own copy
(that module imports the JAX package's metrics): the same byte budget,
LRU order and lock, over the port's metrics registry.

The block pool (serve/kvcache.py) bounds LIVE sessions; most sessions
are idle at any instant, and without a tier their prefixes vanish when
the pool reclaims their blocks. ``HostTier`` is where they go instead: a
byte-bounded LRU of **shipped-KV wire payloads** (serve/disagg.py
``export_shipment``; dense and kv8-with-sidecars both round-trip
losslessly), keyed by the same chained per-block SHA-1 digest namespace
the PrefixCache and the fleet's prefix advertisement use. One namespace,
three levels:

    device PrefixCache entry  (hot: table-insert join, zero upload)
      <-> spill / restore
    HostTier payload          (warm: upload + table-insert join)
      <-> GET /prefix/<digest>
    peer replica              (fleet: same wire format, one more hop)

The tier stores exactly what the wire ships, so a restore IS an
``ingest_shipment`` and a fleet pull can answer straight from the tier
with no re-encoding. Entries are host-side dicts of base64 strings: no
device memory.

Thread safety: the engine loop spills and restores, the /healthz probe
thread reads ``advertise``, and /debug reads ``snapshot``; every public
method takes the lock. LRU order is dict order, the PrefixCache's
contract (``get`` refreshes recency; eviction pops the cold end)."""

from __future__ import annotations

import threading

from tf_operator_tpu_torch.runtime.metrics import (
    SERVE_KV_TIER_BYTES,
    SERVE_KV_TIER_SPILLS,
)

__all__ = ["HostTier", "payload_nbytes"]


def payload_nbytes(payload: dict) -> int:
    """Host bytes a shipped-KV wire payload occupies: the decoded size of
    every encoded tensor part (KV rows, scale sidecars, logits) plus the
    int32 prompt tokens. The byte budget charges the DECODED size (what a
    restore materializes and what capacity planning cares about), not the
    transient base64 strings."""
    total = 4 * len(payload.get("tokens", ()))
    enc = [payload["logits"]] if payload.get("logits") else []
    for parts in payload.get("rows", {}).values():
        enc.extend(parts.values())
    for e in enc:
        data = e.get("b64", "")
        # Decoded b64 length without decoding: 3 bytes per 4 chars, minus
        # padding.
        total += (len(data) * 3) // 4 - data.count("=", -2)
    return total


class HostTier:
    """Byte-bounded host-RAM LRU of spilled KV prefixes.

    ``put`` keys a payload under its EXACT (deepest) chain digest and
    charges its decoded byte size against ``capacity_bytes``, evicting
    oldest-first to fit; a payload larger than the whole budget is refused
    (counted, not raised: spill is best-effort, the blocks were dying
    anyway). ``get`` is the restore/pull read and refreshes recency.
    ``deepest`` resolves a prompt's chain digests (hex, shortest-first,
    ``disagg.chain_digests`` order) to the longest stored prefix, which is
    how tier-aware admission finds the most KV it can restore for a
    partially-matching prompt."""

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self._entries: dict[str, tuple[dict, int]] = {}
        self._lock = threading.Lock()
        self.bytes_used = 0
        self.spills = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.refused = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _set_gauges_locked(self) -> None:
        SERVE_KV_TIER_BYTES.set(self.bytes_used, tier="host")
        SERVE_KV_TIER_BYTES.set(
            max(0, self.capacity_bytes - self.bytes_used),
            tier="host_free",
        )

    def put(self, payload: dict) -> bool:
        """Store one wire payload under its exact digest. Returns False
        (and counts ``refused``) when the payload alone exceeds the byte
        budget; True otherwise. A duplicate digest refreshes recency and
        keeps the newer payload (same digest means the same tokens: the
        sha1 chain runs over the token bytes)."""
        digests = payload.get("digests") or ()
        if not digests:
            return False
        key = digests[-1]
        size = payload_nbytes(payload)
        with self._lock:
            if size > self.capacity_bytes:
                self.refused += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_used -= old[1]
            while (self.bytes_used + size > self.capacity_bytes
                   and self._entries):
                cold_key = next(iter(self._entries))
                _, cold_size = self._entries.pop(cold_key)
                self.bytes_used -= cold_size
                self.evictions += 1
            self._entries[key] = (payload, size)
            self.bytes_used += size
            self.spills += 1
            self._set_gauges_locked()
            SERVE_KV_TIER_SPILLS.inc()
        return True

    def get(self, digest_hex: str) -> dict | None:
        """The restore / fleet-pull read: the stored payload (recency
        refreshed) or None. Counts hits and misses."""
        with self._lock:
            ent = self._entries.get(digest_hex)
            if ent is None:
                self.misses += 1
                return None
            self.hits += 1
            self._entries[digest_hex] = self._entries.pop(digest_hex)
            return ent[0]

    def __contains__(self, digest_hex: str) -> bool:
        with self._lock:
            return digest_hex in self._entries

    def deepest(self, chain_hex) -> str | None:
        """Longest stored prefix of a prompt: ``chain_hex`` is the prompt's
        chain digests hex SHORTEST-first (``disagg.chain_digests`` order);
        the deepest present digest wins. A pure membership probe (no
        recency refresh, no hit/miss accounting; the restore's ``get``
        does that), so admission can ask "could I restore?" without
        perturbing the LRU."""
        with self._lock:
            for hx in reversed(list(chain_hex)):
                if hx in self._entries:
                    return hx
        return None

    def discard(self, digest_hex: str) -> None:
        """Drop one entry (idempotent): the mid-restore corruption path,
        where a payload that fails ``decode_shipment`` is poison, not
        cold."""
        with self._lock:
            ent = self._entries.pop(digest_hex, None)
            if ent is not None:
                self.bytes_used -= ent[1]
                self._set_gauges_locked()

    def advertise(self, cap: int = 32) -> list[str]:
        """Warm-tier digest advertisement for /healthz, most recently used
        first: the fleet router scores these as DISCOUNTED hits
        (restorable, not hot). ``PrefixCache.advertise``'s cap: cap <= 0
        advertises nothing."""
        if cap <= 0:
            return []
        with self._lock:
            keys = list(self._entries)[-int(cap):]
        keys.reverse()
        return keys

    def snapshot(self) -> dict:
        """The /debug/serve ``kv_cache.tier`` section."""
        with self._lock:
            return {
                "capacity_bytes": self.capacity_bytes,
                "bytes_used": self.bytes_used,
                "entries": len(self._entries),
                "spills": self.spills,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "refused": self.refused,
            }
