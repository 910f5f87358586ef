"""The legacy batch-window coalescer (serve_lm ``--engine coalesce``).

Counterpart of ``tf_operator_tpu/serve/coalesce.py``: this package's own
copy (that module imports JAX). It batches concurrent same-shape greedy
requests into one lock-step decode: rows sharing ``(prompt_len,
num_steps)`` that arrive within the window run as ONE decode call, padded
with zero rows up to the next power-of-two row count so the set of batch
shapes stays small. Greedy only (batching is output-invariant for argmax
decoding up to the reduction order of another batch shape; sampled
requests carry their own keys and run solo), lock-step (every row rides
to the shared horizon) and same-shape only: the three restrictions the
continuous engine (``serve/engine.py``) removes.

Rows are a ``[rows, prompt_len]`` torch tensor, or a numpy array on the
host; a batch is concatenated in the rows' own kind (``torch.cat`` where
JAX's ``jnp.concatenate`` stood).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch


def _cat(parts) -> torch.Tensor | np.ndarray:
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


def _zeros_like_rows(rows, n: int):
    if isinstance(rows, torch.Tensor):
        return torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                           device=rows.device)
    return np.zeros((n, rows.shape[1]), rows.dtype)


class Coalescer:
    """Batch concurrent same-shape greedy requests into one decode.

    ``decode_fn(rows, num_steps) -> tokens`` runs the batched greedy
    decode (callers bake their own device locking into it); ``stop`` ends
    the loop, which still drains everything already queued and answers
    whatever remains with an error, never abandoning a waiter.
    """

    def __init__(self, window_s: float, max_rows: int,
                 decode_fn: Callable, stop: threading.Event) -> None:
        self.window_s = window_s
        self.max_rows = max_rows
        self.decode_fn = decode_fn
        self.stop = stop
        self.cond = threading.Condition()
        self.pending: list[dict] = []
        self.closed = False   # loop exited: no consumer remains
        self.batches = 0      # stats for /healthz (and tests)
        self.max_rows_seen = 0

    def submit(self, prompt, num_steps: int):
        item = {
            "key": (prompt.shape[1], num_steps),
            "rows": prompt,
            "event": threading.Event(),
            "out": None,
            "err": None,
        }
        with self.cond:
            if self.closed:
                # The batcher has exited (shutdown): failing fast beats
                # queueing where no consumer will ever look.
                raise RuntimeError("server shutting down")
            self.pending.append(item)
            self.cond.notify()
        if not item["event"].wait(timeout=300.0):
            raise TimeoutError("coalesced decode timed out")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _key_rows(self, key) -> int:
        return sum(p["rows"].shape[0] for p in self.pending
                   if p["key"] == key)

    def _take_batch(self) -> list[dict]:
        with self.cond:
            # Wake exactly on submit()'s notify (or shutdown).
            self.cond.wait_for(
                lambda: self.pending or self.stop.is_set(), timeout=1.0
            )
            if not self.pending:
                return []
            key = self.pending[0]["key"]
            # Hold the window open until the batch fills (or closes).
            self.cond.wait_for(
                lambda: self._key_rows(key) >= self.max_rows
                or self.stop.is_set(),
                timeout=self.window_s,
            )
            take: list[dict] = []
            total = 0
            for p in [p for p in self.pending if p["key"] == key]:
                n = p["rows"].shape[0]
                if take and total + n > self.max_rows:
                    break
                take.append(p)
                total += n
            for p in take:
                self.pending.remove(p)
        return take

    def loop(self):
        # Keep draining after shutdown begins: requests already queued
        # must be answered (the direct path serves its in-flight requests
        # too), never left to hang in submit().
        try:
            self._loop()
        finally:
            # Whatever is left when the consumer stops (a crash included)
            # is answered with an error, never abandoned.
            with self.cond:
                self.closed = True
                leftovers, self.pending = self.pending, []
            for p in leftovers:
                p["err"] = RuntimeError("server shutting down")
                p["event"].set()

    def _loop(self):
        # lint: ok guarded-attr — racy liveness peek; _take_batch re-reads pending under cond
        while not self.stop.is_set() or self.pending:
            batch = self._take_batch()
            if not batch:
                continue
            try:
                num_steps = batch[0]["key"][1]
                rows = _cat([p["rows"] for p in batch])
                k = rows.shape[0]
                bucket = 1
                while bucket < k:
                    bucket *= 2
                if bucket > k:  # pad: bounded set of batch shapes
                    rows = _cat([rows, _zeros_like_rows(rows, bucket - k)])
                out = self.decode_fn(rows, num_steps)
                self.batches += 1
                self.max_rows_seen = max(self.max_rows_seen, k)
                at = 0
                for p in batch:
                    n = p["rows"].shape[0]
                    p["out"] = out[at:at + n]
                    at += n
            except Exception as exc:  # noqa: BLE001 — a failed batch
                # must answer its clients AND leave the loop alive.
                for p in batch:
                    p["err"] = exc
            for p in batch:
                p["event"].set()
