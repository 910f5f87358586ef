"""Disaggregated prefill/decode serving: dedicated prefill replicas and
the shipped-KV wire format, in PyTorch.

Counterpart of ``tf_operator_tpu/serve/disagg.py``: the codec
(``chain_digests``, ``export_shipment``, ``decode_shipment``,
``Shipment``), the prefill replica's worker and its HTTP server, under the
same names. The wire payloads are the JAX module's byte for byte, so a JAX
replica and a port replica exchange shipments in either direction:

- A prefill replica runs ONLY prompt prefill (``_prefill`` or
  ``ChunkedPrefill`` on a dense ``decode=True, kv_paged=False`` model of
  the decode pool's weights) and exports, per attention layer, the dense
  cache rows ``[0 : ceil(L/B)*B)`` (the pad rows past the prompt included,
  so a copy-on-write of the partial last block is bitwise the local
  copy), the last-position logits row, and the chained per-block SHA-1
  token digests (the PrefixCache key chain, recomputed and verified on the
  decode side).
- A decode replica ingests a shipment through
  ``ContinuousEngine.ingest_shipment``: blocks allocated, rows written
  into the pool, the prompt registered in the PrefixCache with the shipped
  logits, after which the request's own admission finds an EXACT prefix
  match and joins through the table insert, skipping prefill. A shipped
  prefix lands exactly as a local exact-prefix hit, so the decode is
  bit-identical whether the KV was computed locally or shipped.

Wire format: a JSON-safe dict, arrays as base64 raw bytes + shape +
dtype. Rows travel under the JAX cache's module paths: layer ``i`` of the
port's ``{"layers": [...]}`` cache is ``"block_{i}/attn"``, and its leaves
``cached_key``/``cached_value`` (and the kv_int8 scales
``key_scale``/``value_scale``) are the parts ``key``/``value``
(``key_scale``/``value_scale``). bf16 rows travel as their raw 2-byte
words under the dtype name ``"bfloat16"`` (the name ml_dtypes gives the
JAX side's arrays; numpy has no bf16, so the port reads the words as
uint16 and views them as ``torch.bfloat16``); float32 and int8 keep
numpy's names. The row checksum hashes those raw bytes, as JAX hashes its
arrays'.

Decoded rows are CPU tensors; the logits a float32 numpy row.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import threading
import time
from dataclasses import dataclass, replace
from http.server import ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER, mint_request_id
from tf_operator_tpu_torch.serve.httpapi import QuietHandler
from tf_operator_tpu_torch.serve.resilience import (
    Draining,
    ShipFailed,
    error_payload,
    http_status_of,
)

LOG = logging.getLogger("serve-disagg")

WIRE_VERSION = 1

# Seed of the chained per-block digest: PrefixCache._SEED (kvcache.py).
# The shipment's digests are the prefix-cache key chain.
_SEED = hashlib.sha1(b"tpu-kv-prefix").digest()

# Dense (solo) cache leaf -> its wire part name. The kv_int8 scale
# sidecars ride as two more parts with [R, KV] rows, present only when the
# prefill side ran a kv_int8 cache (kvcache.POOL_WIRE_PARTS names the pool
# twins on the ingest side).
_DENSE_WIRE_PARTS = {
    "cached_key": "key",
    "cached_value": "value",
    "key_scale": "key_scale",
    "value_scale": "value_scale",
}


def layer_path(i: int) -> str:
    """The wire path of layer ``i``: the JAX cache's module path."""
    return f"block_{i}/attn"


# ---------------------------------------------------------------------------
# digests + array codec
# ---------------------------------------------------------------------------


def chain_digests(tokens, block: int) -> list[str]:
    """Chained per-block SHA-1 digests of a prompt, hex, shortest first:
    ``D_k = sha1(D_{k-1} + block_k_bytes)`` per full block, chained once
    more over the partial tail: the PrefixCache key chain, O(L) total."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    n_tok = len(tokens)
    digest = _SEED
    out: list[str] = []
    for k in range(n_tok // block):
        digest = hashlib.sha1(
            digest + tokens[k * block:(k + 1) * block].tobytes()
        ).digest()
        out.append(digest.hex())
    if n_tok % block:
        out.append(hashlib.sha1(
            digest + tokens[(n_tok // block) * block:].tobytes()
        ).digest().hex())
    return out


def _raw(arr) -> tuple[bytes, str]:
    """(the raw bytes, the wire dtype name) of a tensor or numpy array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr.tobytes(), str(arr.dtype)


def _enc(arr) -> dict:
    raw, dtype = _raw(arr)
    return {
        "shape": list(arr.shape),
        "dtype": dtype,
        "b64": base64.b64encode(raw).decode("ascii"),
    }


def _dec(d: dict) -> torch.Tensor:
    try:
        raw = bytearray(base64.b64decode(d["b64"]))
        shape = [int(n) for n in d["shape"]]
        if d["dtype"] == "bfloat16":
            words = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
            return torch.from_numpy(words).view(torch.bfloat16)
        arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(shape)
        return torch.from_numpy(arr)
    except (KeyError, TypeError, ValueError) as exc:
        raise ShipFailed(f"malformed wire array: {exc}") from exc


def _rows_sha1(rows: dict) -> str:
    """One SHA-1 over every row leaf in (path, part) order: the payload
    integrity check (the token digests prove WHICH prompt, this proves the
    K/V bytes survived the hop). The parts present, in sorted order: a
    key/value payload hashes as wire v1 always did, a kv_int8 one folds
    its scale sidecars in."""
    h = hashlib.sha1()
    for path in sorted(rows):
        for part in sorted(rows[path]):
            h.update(path.encode())
            h.update(_raw(rows[path][part])[0])
    return h.hexdigest()


# ---------------------------------------------------------------------------
# shipment: export / decode / verify
# ---------------------------------------------------------------------------


@dataclass
class Shipment:
    """One decoded, VERIFIED shipped-KV payload, engine-ready."""

    tokens: np.ndarray                 # [L] int32 prompt
    kv_block: int
    # path -> key/value [R, KV, Dh] (+ key_scale/value_scale [R, KV] f32
    # sidecars when the prefill side ran a kv_int8 cache), CPU tensors
    rows: dict[str, dict[str, torch.Tensor]]
    logits: np.ndarray                 # [vocab] last-position sampling row
    digests: tuple[str, ...] = ()

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


def export_shipment(cache: dict, tokens, logits, kv_block: int) -> dict:
    """Render a finished SOLO prefill (a dense cache and the
    last-position logits) as the JSON-safe wire payload. Ships rows
    ``[0 : ceil(L/B)*B)`` of every layer: block-aligned, the pad rows past
    the prompt included, so the decode side's blocks are bitwise what a
    local prefill would have produced (the CoW copy of a partial last
    block reads them)."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    cap_rows = -(-int(tokens.shape[0]) // kv_block) * kv_block
    rows: dict[str, dict[str, torch.Tensor]] = {}
    for i, layer in enumerate(cache["layers"]):
        for name, part in _DENSE_WIRE_PARTS.items():
            if name in layer:
                # [1, S, KV, Dh] -> [cap, KV, Dh] (scales: [1, S, KV] ->
                # [cap, KV]), on the host
                rows.setdefault(layer_path(i), {})[part] = (
                    layer[name][0, :cap_rows].cpu())
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    return {
        "version": WIRE_VERSION,
        "tokens": tokens.tolist(),
        "kv_block": int(kv_block),
        "rows": {
            path: {part: _enc(arr) for part, arr in kv.items()}
            for path, kv in rows.items()
        },
        "logits": _enc(np.asarray(logits, np.float32).reshape(-1)),
        "digests": chain_digests(tokens, kv_block),
        "rows_sha1": _rows_sha1(rows),
    }


def decode_shipment(payload: dict, expect_tokens=None) -> Shipment:
    """Decode and VERIFY one wire payload; raises the typed ``ShipFailed``
    on any mismatch (version, token digests, row checksum, or, when
    ``expect_tokens`` is given, a payload that prefilled a different
    prompt than the request carries). A router treats ``ship_failed`` as
    re-prefill, never as retry-the-same-bytes-elsewhere."""
    if not isinstance(payload, dict):
        raise ShipFailed("shipment payload must be an object")
    if payload.get("version") != WIRE_VERSION:
        raise ShipFailed(
            f"unknown shipment version {payload.get('version')!r}"
        )
    try:
        tokens = np.asarray(payload["tokens"], np.int32).reshape(-1)
        kv_block = int(payload["kv_block"])
        digests = tuple(payload.get("digests") or ())
    except (KeyError, TypeError, ValueError) as exc:
        raise ShipFailed(f"malformed shipment: {exc}") from exc
    if kv_block < 1 or tokens.size < 1:
        raise ShipFailed("shipment needs kv_block >= 1 and >= 1 token")
    if expect_tokens is not None:
        expect = np.asarray(expect_tokens, np.int32).reshape(-1)
        if not np.array_equal(tokens, expect):
            raise ShipFailed(
                "shipment prefilled a different prompt than the request"
            )
    if tuple(chain_digests(tokens, kv_block)) != digests:
        raise ShipFailed("chained per-block token digests do not match")
    rows = {
        path: {part: _dec(d) for part, d in kv.items()}
        for path, kv in (payload.get("rows") or {}).items()
    }
    cap_rows = -(-int(tokens.size) // kv_block) * kv_block
    for path, kv in rows.items():
        for part in ("key", "value"):
            arr = kv.get(part)
            if arr is None or arr.ndim != 3 or arr.shape[0] != cap_rows:
                raise ShipFailed(
                    f"row leaf {path}:{part} has wrong geometry "
                    f"(want [{cap_rows}, KV, Dh])"
                )
        # kv_int8 scale sidecars are optional per payload (present only
        # when the prefill side quantized); the INGESTING engine's
        # coverage check is what enforces match-the-pool.
        for part in ("key_scale", "value_scale"):
            arr = kv.get(part)
            if arr is not None and (arr.ndim != 2
                                    or arr.shape[0] != cap_rows):
                raise ShipFailed(
                    f"row leaf {path}:{part} has wrong geometry "
                    f"(want [{cap_rows}, KV])"
                )
        unknown = set(kv) - set(_DENSE_WIRE_PARTS.values())
        if unknown:
            raise ShipFailed(
                f"row leaf {path} carries unknown parts {sorted(unknown)}"
            )
    if payload.get("rows_sha1") != _rows_sha1(rows):
        raise ShipFailed("shipped K/V row checksum mismatch")
    logits = _dec(payload["logits"]) if payload.get("logits") else None
    if logits is None:
        raise ShipFailed("shipment is missing the last-position logits")
    return Shipment(tokens=tokens, kv_block=kv_block, rows=rows,
                    logits=logits.float().numpy().reshape(-1),
                    digests=digests)


# ---------------------------------------------------------------------------
# the prefill worker (engine-side prefill, exported as shipments)
# ---------------------------------------------------------------------------


class PrefillWorker:
    """The prefill replica's brain: the decode pool's cfg and weights, but
    the ONLY device work is prompt prefill (one-shot ``_prefill`` or
    ``ChunkedPrefill`` under ``prefill_chunk``), exported as wire
    shipments. One device, one worker: requests serialize on an internal
    lock and ``queue_depth`` counts the waiters (the prefill pool's
    autoscale signal, as decode occupancy is the decode pool's).

    The prefill is THE engine's: a ``decode=True, kv_paged=False`` model
    of the same weights runs the dense prefill the engine's local joins
    run, so the shipped rows are bitwise what the decode replica's local
    prefill writes. ``params`` is a flax-layout tree; ``device`` defaults
    to the CUDA card."""

    role = "prefill"

    def __init__(self, cfg, params, *, prefill_chunk: int | None = None,
                 kv_block: int = 64, device=None) -> None:
        from tf_operator_tpu_torch.models.convert import load_params
        from tf_operator_tpu_torch.models.transformer import (
            Transformer,
            _validate_prefill_chunk,
        )

        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        self.cfg = cfg
        self.kv_block = int(kv_block)
        if cfg.max_seq_len % self.kv_block:
            raise ValueError(
                f"max_seq_len={cfg.max_seq_len} must be a multiple of "
                f"kv_block={self.kv_block}"
            )
        self.prefill_chunk = prefill_chunk
        self._validate_chunk = _validate_prefill_chunk
        dcfg = replace(cfg, decode=True, remat=False, kv_paged=False,
                       kv_attend="gather")
        self._model = load_params(Transformer(dcfg, device), params)
        self.device = self._model.device
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._waiting = 0
        self._running = 0
        self.requests_done = 0
        self.tokens_prefilled = 0
        self.restarts = 0
        self.dead = False
        # Capacity for the membership load score: one prefill at a time.
        self.max_slots = 1

    @property
    def queue_depth(self) -> int:
        with self._stats_lock:
            return self._waiting

    @property
    def active_slots(self) -> int:
        with self._stats_lock:
            return self._running

    @property
    def tokens_generated(self) -> int:
        # readiness_payload's duck type: a prefill replica generates no
        # decode tokens; it prefills prompt tokens.
        with self._stats_lock:
            return self.tokens_prefilled

    def prefill(self, tokens, request_id: str = "") -> dict:
        """Run one prompt's prefill and return the wire payload, serialized
        on the worker's device lock; waiters count into ``queue_depth``."""
        from tf_operator_tpu_torch.models.transformer import (
            ChunkedPrefill,
            _prefill,
        )

        tokens = np.asarray(tokens, np.int32).reshape(1, -1)
        n_tok = int(tokens.shape[1])
        if n_tok < 1:
            raise ValueError("prompt must have at least one token")
        if n_tok > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt {n_tok} exceeds max_seq_len {self.cfg.max_seq_len}"
            )
        if self.prefill_chunk is not None:
            self._validate_chunk(self.cfg, n_tok, self.prefill_chunk)
        with self._stats_lock:
            self._waiting += 1
        t0 = time.monotonic()
        with self._device_lock:
            with self._stats_lock:
                self._waiting -= 1
                self._running += 1
            try:
                prompt = torch.as_tensor(tokens, device=self.device)
                with torch.no_grad():
                    if self.prefill_chunk is not None:
                        pf = ChunkedPrefill(self._model, prompt,
                                            self.prefill_chunk)
                        pf.feed(pf.n_chunks)
                        cache, logits = pf.result()
                    else:
                        cache, logits = _prefill(self._model, prompt)
                payload = export_shipment(cache, tokens[0], logits,
                                          self.kv_block)
            finally:
                with self._stats_lock:
                    self._running -= 1
        with self._stats_lock:
            self.requests_done += 1
            self.tokens_prefilled += n_tok
        SERVE_TRACER.record(
            "prefill.ship", t0, time.monotonic(),
            request_id=request_id, prompt_tokens=n_tok,
            blocks=len(payload["digests"]),
        )
        return payload


class PrefillServer:
    """One prefill replica endpoint: POST /prefill -> the wire shipment,
    plus /healthz (``role: "prefill"``; queue_depth is the pool's
    autoscale signal), /metrics and /debug/traces, with the fleet
    lifecycle hooks (``begin_drain``, ``kill``): the prefill-pool twin of
    the decode replica's server."""

    def __init__(self, backend: Any, *, replica_id: str,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.backend = backend
        self.replica_id = replica_id
        self._draining = False
        outer = self

        class Handler(QuietHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self.send_json(200, outer.health_payload())
                elif path == "/debug/traces":
                    self.send_serve_traces()
                elif path == "/metrics":
                    self.send_metrics()
                else:
                    self.send_json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path.split("?", 1)[0] != "/prefill":
                    self.send_json(404, {"error": "unknown path"})
                    return
                try:
                    body = self.read_json_body()
                    tokens = np.asarray(body["tokens"], np.int32)
                    if tokens.ndim != 2 or tokens.shape[0] != 1:
                        raise ValueError("tokens must be [1, len]")
                except (ValueError, KeyError, TypeError) as exc:
                    self.send_json(400, {
                        "error": str(exc), "code": "bad_request",
                        "retryable": False, "replica": outer.replica_id,
                    })
                    return
                rid = (body.get("request_id")
                       or self.headers.get("X-Request-Id")
                       or mint_request_id())
                if outer._draining:
                    exc = Draining("prefill replica draining")
                    payload = error_payload(exc)
                    payload["replica"] = outer.replica_id
                    payload["request_id"] = rid
                    self.send_json(exc.http_status, payload)
                    return
                try:
                    shipped = outer.backend.prefill(tokens[0],
                                                    request_id=rid)
                except Exception as exc:  # noqa: BLE001 — typed out, like
                    # every serving failure (a ServeError renders itself;
                    # the rest become internal 500s).
                    payload = error_payload(exc)
                    payload["replica"] = outer.replica_id
                    payload["request_id"] = rid
                    self.send_json(http_status_of(exc), payload)
                    return
                self.send_json(200, {
                    "shipped_kv": shipped,
                    "replica": outer.replica_id,
                    "request_id": rid,
                })

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining

    def health_payload(self) -> dict:
        b = self.backend
        payload: dict[str, Any] = {
            "ok": not getattr(b, "dead", False),
            "role": "prefill",
            "replica": self.replica_id,
            "active_slots": getattr(b, "active_slots", 0),
            "queue_depth": getattr(b, "queue_depth", 0),
            "max_slots": getattr(b, "max_slots", 1),
            "requests_done": getattr(b, "requests_done", 0),
            "tokens_generated": getattr(b, "tokens_generated", 0),
            "watchdog_restarts": getattr(b, "restarts", 0),
        }
        if self._draining:
            payload["draining"] = True
        if getattr(b, "dead", False):
            payload["dead"] = True
        return payload

    def start(self) -> "PrefillServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"prefill-{self.replica_id}",
        )
        self._thread.start()
        LOG.info("prefill replica %s listening on %s", self.replica_id,
                 self.endpoint)
        return self

    def begin_drain(self) -> None:
        self._draining = True

    def kill(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def stop(self) -> None:
        self.kill()
