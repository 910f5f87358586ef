"""The port's ``Coalescer`` (tf_operator_tpu_torch/serve/coalesce.py) held
against the JAX package's (tf_operator_tpu/serve/coalesce.py) on the same
numpy ``decode_fn`` and the same arrivals: every request is queued, one
at a time in a fixed order, before the loop starts, so the batches depend
on the queue alone.

- The batches: the same rows, in the same order, padded with the same
  zero rows to the same power of two, split back into the same answers;
  the same ``batches`` and ``max_rows_seen``. Rows may be numpy or torch
  (``torch.cat``) in the port.
- A failing decode answers its batch's clients with the error and the
  loop serves the next batch.
- Stop: what is queued is still served; a loop that dies answers its
  leftovers with ``RuntimeError("server shutting down")``; after close a
  submit raises it at once."""

import threading
import time

import numpy as np
import pytest
import torch

from tf_operator_tpu.serve.coalesce import Coalescer as JaxCoalescer
from tf_operator_tpu_torch.serve.coalesce import Coalescer

torch.set_num_threads(1)

# (prompt_len, rows, num_steps) in arrival order: three keys (two lengths,
# two horizons), requests that a full batch leaves for the next, and
# batches of 3 rows that pad to 4.
ARRIVALS = [(4, 1, 3), (4, 2, 3), (5, 1, 3), (4, 1, 3), (4, 3, 3),
            (4, 1, 2), (5, 2, 3), (4, 2, 3), (5, 4, 3), (5, 1, 3)]
MAX_ROWS = 4


def prompts(kind=np.asarray):
    rng = np.random.default_rng(0)
    return [kind(rng.integers(1, 100, (rows, n)).astype(np.int32))
            for n, rows, _ in ARRIVALS]


def recording_decode(calls, fail_on=None):
    """A greedy stand-in: row r's tokens are its first token + 1..steps.
    Records each call's rows and steps; raises on the call ``fail_on``."""
    def decode(rows, num_steps):
        rows = np.asarray(rows)
        calls.append((rows.tolist(), num_steps))
        if fail_on is not None and len(calls) == fail_on:
            raise ValueError("decode failed")
        return rows[:, :1] + np.arange(1, num_steps + 1)[None, :]
    return decode


def queue_all(co, items):
    """Submit each item on its own thread, in order, each queued before
    the next starts; returns the threads and their results by index."""
    results, threads = {}, []

    def client(i, rows, steps):
        try:
            results[i] = ("ok", np.asarray(co.submit(rows, steps)).tolist())
        except Exception as exc:  # noqa: BLE001 — the answer under test
            results[i] = ("err", repr(exc))

    for i, (rows, steps) in enumerate(items):
        t = threading.Thread(target=client, args=(i, rows, steps),
                             daemon=True)
        t.start()
        threads.append(t)
        limit = time.monotonic() + 30
        while len(co.pending) + len(results) < i + 1:
            assert time.monotonic() < limit
            time.sleep(0.001)
    return threads, results


def run(cls, rows, *, fail_on=None, stop_first=False, die_after=None):
    """Queue every arrival on a ``cls`` coalescer, then run its loop to
    the end: (decode calls, results, counters)."""
    calls = []
    stop = threading.Event()
    co = cls(0.05, MAX_ROWS, recording_decode(calls, fail_on), stop)
    if die_after is not None:
        take, taken = co._take_batch, []

        def dying_take():
            if len(taken) == die_after:
                raise KeyboardInterrupt("batcher died")
            taken.append(1)
            return take()

        co._take_batch = dying_take
    threads, results = queue_all(
        co, [(r, steps) for r, (_, _, steps) in zip(rows, ARRIVALS)])
    if stop_first:
        stop.set()

    def loop():
        try:
            co.loop()
        except KeyboardInterrupt:
            pass

    batcher = threading.Thread(target=loop, daemon=True)
    batcher.start()
    if not stop_first:
        limit = time.monotonic() + 30
        while len(results) < len(rows):
            assert time.monotonic() < limit, results
            time.sleep(0.005)
        stop.set()
    batcher.join(timeout=30)
    for t in threads:
        t.join(timeout=30)
    return calls, results, (co.batches, co.max_rows_seen, co.closed)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_batches_padding_and_splits_match_jax(kind):
    want = run(JaxCoalescer, prompts())
    got = run(Coalescer, prompts(np.asarray if kind == "numpy"
                                 else torch.from_numpy))
    assert got == want
    calls, results, (batches, seen, closed) = got
    # Keys stay apart, full batches split a request off, and every batch
    # pads with zero rows to a power of two.
    assert [len(rows) for rows, _ in calls] == [4, 4, 4, 1, 2, 4, 1]
    assert calls[1][0][3] == [0] * 5  # 3 rows of key (5, 3), padded
    assert [steps for _, steps in calls] == [3, 3, 3, 2, 3, 3, 3]
    assert batches == len(calls) and seen == MAX_ROWS and closed
    assert all(status == "ok" for status, _ in results.values())
    for i, r in enumerate(prompts()):
        assert results[i][1] == (r[:, :1] + np.arange(
            1, ARRIVALS[i][2] + 1)).tolist()


def test_failed_decode_answers_its_batch_and_the_loop_goes_on():
    want = run(JaxCoalescer, prompts(), fail_on=2)
    got = run(Coalescer, prompts(), fail_on=2)
    assert got == want
    _, results, (batches, _, _) = got
    failed = sorted(i for i, (status, _) in results.items()
                    if status == "err")
    assert failed == [2, 6] and "decode failed" in results[2][1]
    assert batches == 6  # the failed call is not counted


def test_stop_drains_the_queue_and_close_refuses():
    want = run(JaxCoalescer, prompts(), stop_first=True)
    got = run(Coalescer, prompts(), stop_first=True)
    assert got == want
    assert all(status == "ok" for status, _ in got[1].values())
    stop = threading.Event()
    for cls in (Coalescer, JaxCoalescer):
        co = cls(0.01, MAX_ROWS, recording_decode([]), stop)
        stop.set()
        co.loop()
        with pytest.raises(RuntimeError, match="server shutting down"):
            co.submit(prompts()[0], 3)


def test_a_dead_loop_answers_its_leftovers():
    """The batcher dies after two batches: the requests still queued are
    answered with the shutdown error, never abandoned."""
    want = run(JaxCoalescer, prompts(), die_after=2)
    got = run(Coalescer, prompts(), die_after=2)
    assert got == want
    calls, results, (batches, _, closed) = got
    assert batches == len(calls) == 2 and closed
    left = sorted(i for i, (status, _) in results.items() if status == "err")
    assert left == [4, 5, 7, 8, 9]
    assert all("server shutting down" in results[i][1] for i in left)
