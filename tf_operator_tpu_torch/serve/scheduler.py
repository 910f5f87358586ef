"""The continuous-batching serving loop: admission, prefill/decode
interleaving, retirement, drain — the policy layer over the engine.

Counterpart of ``tf_operator_tpu/serve/scheduler.py``'s
``ContinuousScheduler`` on the continuous, single-device path, over the
port's ``serve/engine.py::ContinuousEngine``, constrained decoding
included: a request's ``json_schema``/``regex``/``choices`` spec compiles
at ``enqueue`` (on the caller's thread, off the device lock) through the
``constrainer`` (``serve/constrain.py::ConstraintCompiler``), ``stop``
sequences encode there too, and delivery walks each constrained lane's
FSM on the host (retiring it at ``grammar_complete``), trims matched stop
sequences and appends ``logprobs`` rows. Disaggregated prefill and the
host KV tier as the JAX scheduler has them: a request's verified
``shipment`` is ingested right before its admission plan
(``_ingest_shipment``), so the plan exact-hits the shipped prefix and
joins without a local prefill; with a host tier the deepest restorable
prefix of the prompt is restored there too (``_restore_tier``); a
``session`` key posts a restore at enqueue (``_maybe_prefetch``, under
``tier_prefetch``), so the upload overlaps the queue wait; and
``export_prefix`` answers ``GET /prefix/<digest>`` on the loop's thread.

One thread owns the device (the engine is lock-free by design); HTTP
handler threads talk to it only through ``submit``'s queue + event
handshake. Each loop iteration:

1. ADMIT + PREFILL (token-budgeted): queued requests move into free
   slots through the engine's PLANNED admission — a plan reserves a free
   slot and the KV blocks for prompt + max_tokens, after shared-prefix
   credit, so admission is "free slot AND enough free blocks": when
   either is exhausted the request stays queued until a retire frees
   capacity (block-exhaustion queueing). Under chunked prefill the
   iteration feeds at most ``prefill_tokens_per_step`` prompt tokens
   before decoding again, so a long prompt streams in across iterations
   instead of stalling every active slot for its whole prefill (when
   nothing is decoding the budget is waived: there is no one to
   protect). One-shot prefill (prefill_chunk=None) admits whole prompts,
   still at most one batch of budget per iteration. A shipment or a tier
   hit is landed before the plan; a pool too full for it requeues the
   request as a plan miss does, and a shipment that fails to ingest is
   dropped for a local prefill (counted ``failed``).
2. DECODE: one engine step advances every active slot one token; new
   tokens are appended per request, TTFT is observed on each request's
   first, and slots retire on num_steps or the request's eos_id. The
   engine samples a slot's first token at the step after its join, from
   the logits its prefill carried, so the token a step returns for a slot
   is the next token of that slot's request, in order. On a speculative
   engine (``spec_k``) the step is a ROUND (``spec_step``) that emits 1
   to k + 1 tokens a slot; each slot's window is delivered token by token
   through the same rules, and a budget, eos, stop sequence or completed
   grammar cuts it mid-window (the rest of the window is dead), as solo
   ``speculative_generate``'s trim does.
3. IDLE: with nothing queued and nothing active the loop parks on a
   condition variable — zero device work, zero spin.

RESILIENCE (serve/resilience.py — every knob defaults off, preserving
the bare-scheduler semantics above exactly):

- The loop HEARTBEATS every iteration; a supervisor's watchdog reads the
  stamp. An ``ack_loss`` fault drops the write (the false-positive
  drill).
- Queued requests expire after ``queue_ttl_s`` with a typed 408; decode
  slots whose absolute deadline passes retire with the PARTIAL
  generation and a ``deadline_exceeded`` flag.
- The queue is bounded: at ``queue_limit`` new submits shed with a typed
  503 + Retry-After (reject-newest). When the engine's free-block
  fraction drops under ``degraded_free_block_frac``, admissions cap
  ``num_steps`` at ``degraded_max_tokens`` (flagged).
- ``fence_and_harvest`` is the supervisor's takeover: it marks the
  scheduler FENCED under the condvar and strips every live request out.
  All request/slot bookkeeping in the loop re-checks the fence under the
  same condvar before touching anything, so a loop thread that was stuck
  inside a wedged device call when the watchdog fired can wake up later
  and die quietly without double-finishing a replayed request. The
  fenced engine is never called again by anyone but that thread, and
  nothing of it is shared with the next generation's engine.
- The drain (``stop``) is bounded by ``drain_timeout_s``: on expiry the
  remaining slots resolve through the SAME partial-output path as the
  decode deadline (cause ``drain_timeout``).

Shutdown (``stop``) is the serve_lm SIGTERM drain: queued requests that
never reached a slot fail FAST with ``ShuttingDown`` (the server's 503),
while admitted requests — slots and the in-flight prefill — finish
normally. A loop crash answers every parked waiter with a typed error —
unless a supervisor claims the crash, in which case the waiters ride
through the restart and are replayed.

All counters/histograms land in the process-global registry
(runtime/metrics.py ``tpu_serve_*``); long-lived tests must window reads
via snapshot()/deltas.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:  # annotation-only
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

from tf_operator_tpu_torch.runtime.metrics import (
    SERVE_CONSTRAINED_REQUESTS,
    SERVE_CONSTRAINED_STOPS,
    SERVE_DEADLINE_TOTAL,
    SERVE_DEGRADED,
    SERVE_ITL_SECONDS,
    SERVE_OCCUPANCY,
    SERVE_PHASE_SECONDS,
    SERVE_PREFILL_TOKENS_TOTAL,
    SERVE_QUEUE_DEPTH,
    SERVE_REQUESTS_TOTAL,
    SERVE_SHED_TOTAL,
    SERVE_SHIP_INGEST_TOTAL,
    SERVE_SLOTS_ACTIVE,
    SERVE_SLOT_CAPACITY,
    SERVE_STEP_SECONDS,
    SERVE_TOKENS_TOTAL,
    SERVE_TTFT_SECONDS,
)
from tf_operator_tpu_torch.runtime.tracing import (
    SERVE_TRACER,
    mint_request_id,
)
from tf_operator_tpu_torch.serve.constrain import match_stop
from tf_operator_tpu_torch.serve.faultinject import NULL_INJECTOR
from tf_operator_tpu_torch.serve.resilience import (
    EngineCrashed,
    EngineSupervisor,
    InvalidGrammar,
    PrefixNotFound,
    QueueFull,
    QueueTTLExpired,
    ResilienceConfig,
    ServeError,
    ShuttingDown,
    await_request,
)

__all__ = [
    "ContinuousScheduler",
    "SchedulerFenced",
    "ServeRequest",
    "ShuttingDown",
]

# Decode steps per ``decode.interval`` span before it is flushed and a
# new one opened. Spans wrap host-side intervals, never single tokens.
DECODE_INTERVAL_STEPS = 256


class SchedulerFenced(RuntimeError):
    """Internal: an enqueue hit a scheduler the supervisor has already
    fenced for teardown. The supervisor retries on the next generation;
    this never reaches a client."""


class ServeRequest:
    """One /generate row in flight through the continuous engine, with the
    JAX ``ServeRequest``'s arguments. ``shipment`` is a verified
    ``serve/disagg.py`` ``Shipment`` of this row's prompt, ingested before
    its admission plan (None: the local prefill). ``session`` marks a
    resumable conversation: enqueue posts a host-tier restore of its
    prompt."""

    def __init__(self, tokens: np.ndarray, num_steps: int, *,
                 temperature: float = 0.0, top_p: float | None = None,
                 seed: int = 0, eos_id: int | None = None,
                 deadline_s: float | None = None,
                 request_id: str | None = None,
                 shipment: Any = None,
                 session: str | None = None,
                 constrain: Any = None,
                 stop: Any = None,
                 logprobs: bool = False) -> None:
        self.tokens = np.asarray(tokens, np.int32)
        if self.tokens.ndim != 2 or self.tokens.shape[0] != 1:
            raise ValueError("tokens must be [1, len] (one request row)")
        self.num_steps = int(num_steps)
        self.temperature = float(temperature)
        self.top_p = top_p
        self.seed = int(seed)
        self.eos_id = eos_id
        self.out: list[int] = []
        self.error: Exception | None = None
        self.event = threading.Event()
        self.submitted_at = time.perf_counter()
        self.first_token_at: float | None = None
        self.slot: int | None = None
        # ``deadline`` is ABSOLUTE (monotonic): it keeps ticking through
        # watchdog restarts, so a replayed request still resolves inside
        # its original budget. The scheduler stamps the config default at
        # enqueue when the per-request ``deadline_s`` is None.
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s} must be > 0")
        self.deadline_s = deadline_s
        self.deadline: float | None = (
            time.monotonic() + deadline_s if deadline_s else None
        )
        self.enqueued_at: float | None = None
        self.ttl_deadline: float | None = None
        self.deadline_exceeded = False
        self.timeout_cause: str | None = None
        self.requested_steps = self.num_steps
        self.degraded = False
        self.replays = 0
        # One histogram observation per request: a replay resets
        # first_token_at but must not observe twice.
        self.ttft_observed = False
        self.request_id = (str(request_id) if request_id
                           else mint_request_id())
        # Decode-step monotonic stamps ITL is computed from at retirement
        # (cleared on replay).
        self.token_times: list[float] = []
        self.queue_wait_s = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        # Disaggregated prefill: kept through watchdog replays, so a
        # rebuilt engine ingests the same bytes again; ``shipped_join``
        # records that the prompt's K/V arrived shipped.
        self.shipment = shipment
        self.shipped_join = False
        # The host KV tier: ``tier_join`` records that admission restored
        # this prompt's K/V from the tier instead of prefilling it.
        self.session = None if session is None else str(session)
        self.tier_join = False
        # Constrained decoding (serve/constrain.py). ``constrain`` is the
        # raw client spec ({"json_schema"|"regex"|"choices": ...}); enqueue
        # compiles it off the device lock and stamps ``program`` (a
        # CompiledProgram), which a replay reuses. ``_walk_state`` is the
        # host FSM position over DELIVERED tokens (program-local states),
        # re-derived from ``out``, so a replay rebuilds it for free.
        # ``stop_ids`` are the encoded stop sequences, matched on the host
        # against the tail of ``out``.
        self.constrain = constrain
        self.stop = stop
        self.logprobs = bool(logprobs)
        self.program: Any = None
        self.stop_ids: tuple = ()
        # "length" | "eos" | "grammar_complete" | "stop_sequence"; None for
        # a deadline-cut partial.
        self.finish_reason: str | None = None
        self.logprob_rows: list[dict] = []
        self._walk_state = 0

    @property
    def ttft(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    def itl_values(self) -> list[float]:
        """Inter-token gaps (seconds) from the decode-step stamps."""
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]

    def timing(self) -> dict:
        """Compact per-request latency breakdown for response JSON
        (opt-in via ``"timing": true``). Phase accumulators span replays
        — a watchdog restart's re-prefill is real time the client
        waited."""
        out = {
            "request_id": self.request_id,
            "queue_ms": round(self.queue_wait_s * 1e3, 3),
            "prefill_ms": round(self.prefill_s * 1e3, 3),
            "decode_ms": round(self.decode_s * 1e3, 3),
        }
        if self.ttft is not None:
            out["ttft_ms"] = round(self.ttft * 1e3, 3)
        gaps = self.itl_values()
        if gaps:
            out["itl_mean_ms"] = round(sum(gaps) / len(gaps) * 1e3, 3)
            out["itl_max_ms"] = round(max(gaps) * 1e3, 3)
            out["itl_ms"] = [round(g * 1e3, 2) for g in gaps]
        if self.replays:
            out["replays"] = self.replays
        if self.shipped_join:
            # The prompt's K/V arrived as shipped rows: no local prefill.
            out["shipped_kv"] = True
        if self.tier_join:
            # The prompt's K/V was restored from the host tier.
            out["tier_kv"] = True
        return out

    def _finish(self, outcome: str, error: Exception | None = None) -> None:
        self.error = error
        SERVE_REQUESTS_TOTAL.inc(outcome=outcome)
        self.event.set()


class ContinuousScheduler:
    def __init__(self, engine: ContinuousEngine, *,
                 prefill_tokens_per_step: int = 256,
                 device_lock: threading.Lock | None = None,
                 resilience: ResilienceConfig | None = None,
                 supervisor: EngineSupervisor | None = None,
                 faults: Any = None, tier_prefetch: bool = True,
                 constrainer: Any = None) -> None:
        if prefill_tokens_per_step < 1:
            raise ValueError("prefill_tokens_per_step must be >= 1")
        self.engine = engine
        self.prefill_tokens_per_step = prefill_tokens_per_step
        # Session prefetch: an enqueue-time host-tier restore for requests
        # with a ``session`` key. Inert without a tier; the flag isolates
        # the prefetch from the tiering itself (serve_lm --tier-prefetch).
        self.tier_prefetch = bool(tier_prefetch)
        # The shared ConstraintCompiler requests' grammar specs compile
        # through at ENQUEUE time, on the client's thread, off the device
        # lock, LRU-cached by spec digest. None = constrained requests and
        # stop sequences are a typed 400.
        self.constrainer = constrainer
        # Serializes device access with a server's OTHER decode paths
        # (serve_lm's streaming requests bypass the engine); a dedicated
        # server may pass None and let the loop own the card outright.
        self._device_lock = device_lock or threading.Lock()
        self.res = resilience or ResilienceConfig()
        self.supervisor = supervisor
        self.faults = faults or NULL_INJECTOR
        self._cond = threading.Condition()
        self._queue: deque[ServeRequest] = deque()
        self._slots: dict[int, ServeRequest] = {}
        # (request, ChunkedPrefill | None, AdmissionPlan): planned
        # admission with its prefill mid-flight.
        self._prefilling: tuple[ServeRequest, Any, Any] | None = None
        # The request popped from the queue but not yet recorded in
        # _prefilling/_slots — set/cleared under the condvar so a
        # harvest can never miss it.
        self._admitting: ServeRequest | None = None
        self._stopping = False
        self._fenced = False
        self._drain_deadline: float | None = None
        self._thread: threading.Thread | None = None
        self.heartbeat = time.monotonic()
        self.decode_steps = 0
        self.occupancy_sum = 0
        self.tokens_generated = 0
        self.requests_done = 0
        self.queue_high_water = 0
        self.shed_total = 0
        self.deadline_total = 0
        self.degraded = False
        if self.res.degraded_free_block_frac:
            # The gauge is process-global but degraded state is
            # per-generation: a fresh engine (full pool) must not inherit
            # a dead generation's 1.
            SERVE_DEGRADED.set(0)
        # Open decode-interval spans: slot -> [start_mono, last_mono,
        # steps]. Mutated only under the condvar.
        self._intervals: dict[int, list] = {}
        # Loop-serialized engine calls (``call_engine``): (fn, box)
        # pairs appended under the condvar from other threads, drained by
        # the loop between steps.
        self._engine_calls: deque = deque()
        SERVE_SLOT_CAPACITY.set(engine.max_slots)

    # -- client side ------------------------------------------------------

    def submit(self, tokens, num_steps: int, *, temperature: float = 0.0,
               top_p: float | None = None, seed: int = 0,
               eos_id: int | None = None,
               deadline_s: float | None = None,
               timeout: float = 600.0) -> np.ndarray:
        """Enqueue one request and block for its tokens ([1, n] int32;
        n < num_steps when eos_id fired or a decode deadline cut it
        short). Validation errors raise HERE, eagerly;
        ``ShuttingDown``/``QueueFull``/``QueueTTLExpired`` are the typed
        503/408s."""
        req = ServeRequest(tokens, num_steps, temperature=temperature,
                           top_p=top_p, seed=seed, eos_id=eos_id,
                           deadline_s=deadline_s)
        return np.asarray(
            self.submit_request(req, timeout=timeout).out, np.int32
        ).reshape(1, -1)

    def submit_request(self, req: ServeRequest,
                       timeout: float = 600.0) -> ServeRequest:
        """``submit`` with the request object exposed (TTFT, the
        ``deadline_exceeded``/``degraded`` flags)."""
        self.enqueue(req)
        return await_request(req, timeout=timeout)

    def enqueue(self, req: ServeRequest) -> ServeRequest:
        """Validate and queue one request WITHOUT waiting. Raises
        eagerly: validation (400s), ``QueueFull`` (shedding),
        ``ShuttingDown`` (drain), ``SchedulerFenced`` (supervisor-internal
        retry)."""
        self.engine.validate_request(req.tokens.shape[1], req.num_steps)
        if req.top_p is not None and not 0.0 < float(req.top_p) <= 1.0:
            raise ValueError(f"top_p={req.top_p} must be in (0, 1]")
        if req.top_p is not None and req.temperature <= 0:
            raise ValueError(
                "top_p requires temperature > 0 (greedy ignores it)"
            )
        if req.logprobs and not getattr(self.engine, "logprobs_k", 0):
            raise ValueError(
                "logprobs requires an engine built with logprobs_k > 0"
            )
        self._compile_constraint(req)
        with self._cond:
            if self._fenced:
                raise SchedulerFenced("scheduler fenced for restart")
            if self._stopping:
                raise ShuttingDown("server shutting down")
            if (self.res.queue_limit is not None
                    and len(self._queue) >= self.res.queue_limit):
                # Reject-NEWEST: the queued requests are older and
                # closer to their TTLs.
                self.shed_total += 1
                SERVE_SHED_TOTAL.inc()
                SERVE_REQUESTS_TOTAL.inc(outcome="shed")
                raise QueueFull(
                    f"queue at limit ({self.res.queue_limit})",
                    retry_after_s=self.res.queue_ttl_s or 1.0,
                )
            now = time.monotonic()
            req.enqueued_at = now
            if self.res.queue_ttl_s:
                req.ttl_deadline = now + self.res.queue_ttl_s
            if req.deadline is None and self.res.decode_deadline_s:
                req.deadline = now + self.res.decode_deadline_s
            self._queue.append(req)
            self.queue_high_water = max(self.queue_high_water,
                                        len(self._queue))
            SERVE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
        self._maybe_prefetch(req)
        return req

    def _maybe_prefetch(self, req: ServeRequest) -> None:
        """Session prefetch: post a fire-and-forget host-tier restore for
        a just-enqueued ``session`` request, so the upload runs between
        decode steps WHILE the request queues and its admission exact-hits
        the restored (retained) prefix. Needs retention
        (``prefix_retain_max`` > 0): the prefetch releases its ingest hold
        at once, and only a retained reference keeps the entry until the
        admission. A no-op without a tier, a session key, the knob, or a
        running loop (the admission-time restore covers those)."""
        if req.session is None or not self.tier_prefetch:
            return
        eng = self.engine
        if (getattr(eng, "host_tier", None) is None
                or getattr(eng, "prefix_retain_max", 0) <= 0
                or not self.running):
            return
        tokens = np.asarray(req.tokens)

        def job(engine):
            hold, outcome = engine.restore_from_tier(tokens)
            if hold is not None:
                engine.release_shipment(hold)
            return outcome

        # The call_engine queue, but nobody waits on the box: a prefetch
        # that loses its loop is a restore at admission instead.
        box: dict = {"done": threading.Event()}
        with self._cond:
            self._engine_calls.append((job, box))
            self._cond.notify_all()

    def _compile_constraint(self, req: ServeRequest) -> None:
        """Enqueue-time constraint compile and stop-sequence encoding, on
        the CLIENT's thread, off the device lock: the decode loop only
        ever sees a finished CompiledProgram. Grammar failures raise
        :class:`InvalidGrammar` here (the server's typed 400). Idempotent:
        a supervisor replay re-enqueues with ``program``/``stop_ids``
        already stamped and recompiles nothing."""
        if req.constrain is not None and req.program is None:
            if self.constrainer is None:
                raise InvalidGrammar(
                    "this server has no constraint compiler "
                    "(constrained decoding is not enabled)"
                )
            t0 = time.monotonic()
            req.program = self.constrainer.compile(
                req.constrain, eos_id=req.eos_id
            )
            SERVE_TRACER.record(
                "constrain.compile", t0, time.monotonic(),
                request_id=req.request_id, **req.program.describe(),
            )
            SERVE_CONSTRAINED_REQUESTS.inc(kind=req.program.kind)
        if req.stop is not None and not req.stop_ids:
            if self.constrainer is None:
                raise InvalidGrammar(
                    "this server has no constraint compiler "
                    "(stop sequences are not enabled)"
                )
            req.stop_ids = self.constrainer.encode_stop(req.stop)

    def requeue(self, reqs) -> None:
        """Supervisor replay: previously-live requests re-enter the queue
        of a FRESH generation, reset to their pre-admission state. Greedy
        replays are bit-identical to an uninterrupted run (same prompt,
        same engine math); sampled ones reproduce their seeded key
        ladder. Queue TTLs restart; the absolute decode deadline does
        NOT."""
        now = time.monotonic()
        with self._cond:
            for req in reqs:
                req.out.clear()
                req.slot = None
                req.first_token_at = None
                req.token_times.clear()
                req.num_steps = req.requested_steps
                req.degraded = False
                # A kept shipment is ingested again by the rebuilt engine
                # (same bytes, fresh pool), and a tier restore is earned
                # again there (the HostTier outlives the engine): both
                # flags re-earn themselves.
                req.shipped_join = False
                req.tier_join = False
                # The compiled program survives (the rebuilt engine's pool
                # re-binds the same tables); the host FSM walk and the
                # delivered logprob rows restart with the cleared output.
                req._walk_state = 0
                req.finish_reason = None
                req.logprob_rows.clear()
                req.replays += 1
                req.enqueued_at = now
                req.ttl_deadline = (
                    now + self.res.queue_ttl_s
                    if self.res.queue_ttl_s else None
                )
                self._queue.append(req)
            self.queue_high_water = max(self.queue_high_water,
                                        len(self._queue))
            SERVE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ContinuousScheduler":
        self._thread = threading.Thread(target=self.loop, daemon=True,
                                        name="serve-loop")
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 60.0) -> None:
        """Begin the drain and wait for the loop to finish it: queued
        requests fail fast with ShuttingDown, admitted ones complete —
        within ``drain_timeout_s`` when configured."""
        t0 = time.monotonic()
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            SERVE_TRACER.record(
                "drain", t0, time.monotonic(),
                requests_done=self.requests_done,
                bounded=bool(self.res.drain_timeout_s),
            )

    def fence_and_harvest(self) -> list[ServeRequest]:
        """Supervisor takeover: mark this scheduler fenced and strip out
        every live request (admitted slots in join order, then the
        in-flight prefill, then the queue) under the condvar. The engine
        is NOT touched: it is generation garbage the moment its scheduler
        is fenced."""
        self._flush_intervals(reason="harvest")
        with self._cond:
            self._fenced = True
            harvested = list(self._slots.values())
            self._slots.clear()
            if self._prefilling is not None:
                harvested.append(self._prefilling[0])
                self._prefilling = None
            if self._admitting is not None:
                harvested.append(self._admitting)
                self._admitting = None
            harvested.extend(self._queue)
            self._queue.clear()
            SERVE_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        return harvested

    # -- the loop ---------------------------------------------------------

    def loop(self) -> None:
        try:
            self._loop()
        except Exception as exc:  # noqa: BLE001 — a crashed loop must
            # answer every waiter — unless a supervisor claims the crash
            # and replays them instead.
            if (self.supervisor is not None
                    and self.supervisor.on_loop_crash(self, exc)):
                return
            self._fail_all(exc)
            raise
        finally:
            if not self._fenced:
                self._fail_all(ShuttingDown("server shutting down"))
                SERVE_SLOTS_ACTIVE.set(0)

    def _beat(self) -> None:
        """Stamp the watchdog heartbeat — unless the ack_loss fault
        swallows the write (the false-positive restart drill)."""
        if self.faults.fire("ack_loss") is None:
            self.heartbeat = time.monotonic()

    @contextlib.contextmanager
    def _device(self):
        """The device lock, heartbeating WHILE WAITING: time spent queued
        behind a server's other decode paths is contention, not a wedged
        engine — only silence INSIDE a device call may trip the
        watchdog."""
        while not self._device_lock.acquire(timeout=0.2):
            self._beat()
        try:
            yield
        finally:
            self._device_lock.release()

    def _run_engine_calls(self) -> None:
        """Drain the loop-serialized engine-call queue: pop under the
        condvar, execute under the device lock OUTSIDE it, answer the
        waiter through its box."""
        while True:
            with self._cond:
                if not self._engine_calls:
                    return
                fn, box = self._engine_calls.popleft()
            try:
                with self._device():
                    box["result"] = fn(self.engine)
            except Exception as exc:  # noqa: BLE001 — delivered, not lost
                box["exc"] = exc
            box["done"].set()

    def call_engine(self, fn, timeout: float = 30.0):
        """Run ``fn(engine)`` serialized with the serving loop's device
        work and return its result: posted and executed between steps on
        a live loop, directly under the device lock otherwise. Raises
        TimeoutError when the loop does not take the call in ``timeout``
        seconds, and re-raises whatever ``fn`` raised."""
        if not self.running:
            with self._device():
                return fn(self.engine)
        box: dict = {"done": threading.Event()}
        with self._cond:
            self._engine_calls.append((fn, box))
            self._cond.notify_all()
        if not box["done"].wait(timeout):
            raise TimeoutError("engine call timed out behind the loop")
        if "exc" in box:
            raise box["exc"]
        return box["result"]

    # -- fleet-global prefix reuse ------------------------------------------

    def advertised_prefixes(self) -> list[str]:
        """The engine's hot-prefix advertisement for /healthz: a host-side
        PrefixCache read, safe from the probe thread; empty for engine
        fakes."""
        fn = getattr(self.engine, "advertised_prefixes", None)
        return fn() if fn is not None else []

    def advertised_tier_prefixes(self) -> list[str]:
        """The warm host-tier advertisement for /healthz: a host-side
        HostTier read; empty without a tier (and for engine fakes)."""
        fn = getattr(self.engine, "advertised_tier_prefixes", None)
        return fn() if fn is not None else []

    def export_prefix(self, digest: str, timeout: float = 30.0) -> dict:
        """``GET /prefix/<digest>``: a live PrefixCache entry as the
        shipped-KV wire payload, on the loop's thread (``call_engine``). A
        loop too busy to take the export inside ``timeout`` answers the
        typed ``prefix_not_found``: the puller degrades to a local
        prefill, which beats stalling its request behind this decode."""
        try:
            return self.call_engine(lambda eng: eng.export_prefix(digest),
                                    timeout=timeout)
        except TimeoutError as exc:
            raise PrefixNotFound(
                "prefix export timed out behind the serving loop"
            ) from exc

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._queue or self._slots or self._prefilling
                    or self._engine_calls or self._stopping or self._fenced,
                    timeout=1.0,
                )
                if self._fenced:
                    return
                if self._stopping:
                    # Queued-but-unadmitted work will never run: answer
                    # those sockets NOW (503), keep draining the rest.
                    while self._queue:
                        self._queue.popleft()._finish(
                            "rejected", ShuttingDown("server shutting down")
                        )
                    SERVE_QUEUE_DEPTH.set(0)
                    if not (self._slots or self._prefilling):
                        return
                    if (self._drain_deadline is None
                            and self.res.drain_timeout_s):
                        self._drain_deadline = (
                            time.monotonic() + self.res.drain_timeout_s
                        )
            self._beat()
            dd = self._drain_deadline
            if dd is not None and time.monotonic() > dd:
                self._expire_drain()
                return
            self._run_engine_calls()
            self._expire_queue_ttls()
            self._admit_and_prefill()
            self._decode()
            with self._cond:
                if self._fenced:
                    return
                SERVE_QUEUE_DEPTH.set(len(self._queue))
            SERVE_SLOTS_ACTIVE.set(self.engine.active_slots)

    def _pop_next(self) -> ServeRequest | None:
        with self._cond:
            if self._queue:
                self._admitting = self._queue.popleft()
                return self._admitting
        return None

    def _note_dequeued(self, req: ServeRequest, now: float) -> None:
        """Close the request's queue residence: ONE ``queue.wait`` span
        per stay, recorded when the request leaves the queue for good."""
        if req.enqueued_at is None:
            return
        req.queue_wait_s += max(0.0, now - req.enqueued_at)
        SERVE_TRACER.record(
            "queue.wait", req.enqueued_at, now,
            request_id=req.request_id, depth=self.queue_depth,
            replays=req.replays,
        )
        req.enqueued_at = None

    def _settle_admitting(self, requeue_front: bool = False) -> bool:
        """Clear the mid-admission marker under the condvar. Returns
        False when a fence already harvested the request — the caller
        must then drop it untouched (the supervisor owns it)."""
        with self._cond:
            if self._fenced:
                return False
            if requeue_front and self._admitting is not None:
                self._queue.appendleft(self._admitting)
            self._admitting = None
            return True

    def _expire_queue_ttls(self) -> None:
        """Resolve queued requests whose TTL passed (typed 408 — no
        device work was ever spent on them) or whose ABSOLUTE decode
        deadline passed while still queued (empty partial + flag)."""
        now = time.monotonic()
        ttl_expired, dl_expired = [], []
        with self._cond:
            if self._fenced or not self._queue:
                return
            keep = deque()
            for req in self._queue:
                if req.ttl_deadline is not None and now > req.ttl_deadline:
                    ttl_expired.append(req)
                elif req.deadline is not None and now > req.deadline:
                    dl_expired.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        for req in ttl_expired:
            self.deadline_total += 1
            SERVE_DEADLINE_TOTAL.inc(kind="queue")
            waited = now - (req.enqueued_at or now)
            req.queue_wait_s += waited
            SERVE_TRACER.record(
                "queue.wait", req.enqueued_at or now, now,
                request_id=req.request_id, outcome="ttl_expired",
            )
            req._finish("deadline", QueueTTLExpired(
                f"queued {waited:.2f}s > ttl "
                f"{self.res.queue_ttl_s}s without reaching a slot",
                retry_after_s=self.res.queue_ttl_s,
            ))
        for req in dl_expired:
            req.queue_wait_s += now - (req.enqueued_at or now)
            SERVE_TRACER.record(
                "queue.wait", req.enqueued_at or now, now,
                request_id=req.request_id, outcome="decode_deadline",
            )
            self._expire_decode_deadline(None, req, "decode_deadline",
                                         "decode")

    def _expire_decode_deadline(self, slot: int | None, req: ServeRequest,
                                cause: str, kind: str) -> None:
        """THE partial-resolution retire path: deliver whatever the
        request generated, flagged — shared by the decode deadline and
        the bounded drain."""
        if slot is not None:
            self.engine.retire(slot)
            self._retire_telemetry(slot, req, reason=cause)
        req.deadline_exceeded = True
        req.timeout_cause = cause
        self.deadline_total += 1
        SERVE_DEADLINE_TOTAL.inc(kind=kind)
        req._finish("deadline")

    def _expire_drain(self) -> None:
        """The bounded drain's expiry: every remaining admitted request
        resolves NOW with partial output + the drain flag, the in-flight
        prefill resolves empty, and the loop exits."""
        with self._cond:
            if self._fenced:
                return
            slots = dict(self._slots)
            self._slots.clear()
            prefilling = self._prefilling
            self._prefilling = None
        for slot, req in slots.items():
            self._expire_decode_deadline(slot, req, "drain_timeout",
                                         "drain")
        if prefilling is not None:
            req, _, plan = prefilling
            self.engine.release_plan(plan)
            self._expire_decode_deadline(None, req, "drain_timeout",
                                         "drain")
        SERVE_SLOTS_ACTIVE.set(self.engine.active_slots)

    def _degrade_check(self, req: ServeRequest) -> None:
        """Degraded admission: when free KV blocks fall under the
        watermark, cap this request's max_tokens (flagged)."""
        frac = self.res.degraded_free_block_frac
        if not frac:
            return
        free = getattr(self.engine, "free_block_fraction", 1.0)
        entering = free < frac
        if entering != self.degraded:
            self.degraded = entering
            SERVE_DEGRADED.set(1 if entering else 0)
        if entering and req.num_steps > self.res.degraded_max_tokens:
            req.num_steps = self.res.degraded_max_tokens
            req.degraded = True

    def _admit_and_prefill(self) -> None:
        # Budget waived while nothing decodes (an int sentinel: the chunk
        # division below needs integers).
        budget = (self.prefill_tokens_per_step if self._slots
                  else 1 << 30)
        while budget > 0:
            if self._prefilling is None:
                req = self._pop_next()
                if req is None:
                    return
                self._degrade_check(req)
                # Land the request's shipped rows, else the deepest
                # restorable host-tier prefix, BEFORE the plan, so the plan
                # exact-hits (or shares) it instead of prefilling. A pool
                # that cannot hold it requeues as a plan miss does; a bad
                # shipment falls back to the local prefill.
                verdict, ship_hold, tier_hold = "none", None, None
                if req.shipment is not None:
                    verdict, ship_hold = self._ingest_shipment(req)
                if verdict == "none":
                    verdict, tier_hold = self._restore_tier(req)
                if verdict == "requeue":
                    if not self._settle_admitting(requeue_front=True):
                        return
                    if not (self._slots or self._prefilling):
                        time.sleep(0.001)
                    return
                t_plan = time.monotonic()
                try:
                    plan = self.engine.plan_admission(
                        np.asarray(req.tokens), req.num_steps
                    )
                except Exception as exc:  # noqa: BLE001 — one bad
                    # request answers its own client, never the loop.
                    self._release_holds(ship_hold, tier_hold)
                    if self._settle_admitting():
                        self._note_dequeued(req, t_plan)
                        req._finish("error", exc)
                    else:
                        return
                    continue
                # The plan (if any) now references the landed blocks; the
                # ingest hold goes either way. On a plan miss the entry
                # dies with the hold (a restored one spills back to the
                # tier) and the requeued request lands it again next time.
                self._release_holds(ship_hold, tier_hold)
                if plan is None:
                    # No free slot or not enough free KV blocks: queue
                    # until a retire frees capacity. Undo any degraded
                    # cap first: the next admission re-evaluates.
                    req.num_steps = req.requested_steps
                    req.degraded = False
                    if not self._settle_admitting(requeue_front=True):
                        return
                    if not (self._slots or self._prefilling):
                        # Nothing decoding either: yield instead of
                        # spinning hot on an unadmittable head-of-line.
                        time.sleep(0.001)
                    return
                self._note_dequeued(req, t_plan)
                SERVE_TRACER.record(
                    "admit.plan", t_plan, time.monotonic(),
                    request_id=req.request_id,
                    prompt_tokens=req.tokens.shape[1],
                    prefill_tokens=plan.prefill_tokens,
                    shared_tokens=getattr(plan, "shared_tokens", 0),
                )
                try:
                    pf = self.engine.prefill_planned(plan)
                except Exception as exc:  # noqa: BLE001
                    self.engine.release_plan(plan)
                    if self._settle_admitting():
                        req._finish("error", exc)
                    else:
                        return
                    continue
                with self._cond:
                    if self._fenced:
                        return
                    self._admitting = None
                    self._prefilling = (req, pf, plan)
            with self._cond:
                # Re-read under the condvar: a concurrent harvest may
                # have fenced us and taken the request since the write.
                if self._fenced or self._prefilling is None:
                    return
                req, pf, plan = self._prefilling
            if req.deadline is not None and time.monotonic() > req.deadline:
                # The decode deadline caught the request still in
                # prefill: resolve it now, empty partial.
                with self._cond:
                    if self._fenced:
                        return
                    self._prefilling = None
                self.engine.release_plan(plan)
                self._expire_decode_deadline(None, req, "decode_deadline",
                                             "decode")
                continue
            # Prefill is about to time-share the device with live
            # decodes: close the open decode-interval spans so the
            # interference shows as a GAP in each request's timeline.
            self._flush_intervals(reason="prefill")
            t0 = time.perf_counter()
            mono0 = time.monotonic()
            try:
                with self._device():
                    self.faults.maybe_sleep("slow_prefill")
                    if pf is not None:
                        chunks = max(1, int(budget // pf.chunk))
                        budget -= pf.feed(chunks)
                        if not pf.done:
                            self._beat()
                            SERVE_STEP_SECONDS.observe(
                                time.perf_counter() - t0, phase="prefill"
                            )
                            self._note_prefill(req, mono0, joined=False,
                                               plan=plan)
                            return  # resume next iteration
                    else:
                        # One-shot (or prefill-free exact match) inside
                        # join_planned; charge what actually runs.
                        budget -= plan.prefill_tokens
                    # ``program`` is passed only when set, so the tests'
                    # fake engines keep their join_planned signatures.
                    join_kw = ({"program": req.program}
                               if req.program is not None else {})
                    slot = self.engine.join_planned(
                        plan, pf, temperature=req.temperature,
                        top_p=req.top_p, seed=req.seed, **join_kw,
                    )
            except Exception as exc:  # noqa: BLE001 — one bad request
                # answers its own client and never kills the loop. The
                # release is idempotent: a pf.feed() failure never
                # reaches join_planned's own release.
                self.engine.release_plan(plan)
                with self._cond:
                    if self._fenced:
                        return
                    self._prefilling = None
                req._finish("error", exc)
                continue
            self._beat()  # a long prefill is progress, not a stall
            SERVE_STEP_SECONDS.observe(
                time.perf_counter() - t0, phase="prefill"
            )
            self._note_prefill(req, mono0, joined=True, plan=plan)
            SERVE_PREFILL_TOKENS_TOTAL.inc(plan.prefill_tokens)
            with self._cond:
                if self._fenced:
                    # Harvested mid-join: the slot belongs to a fenced
                    # generation's engine. Do NOT record anything.
                    return
                self._prefilling = None
                if slot is None:  # raced capacity — put it back, front.
                    req.enqueued_at = time.monotonic()
                    self._queue.appendleft(req)
                    return
                req.slot = slot
                self._slots[slot] = req
                if hasattr(self.engine, "tag_slot"):
                    # hasattr-guarded for the tests' fake engines.
                    self.engine.tag_slot(slot, req.request_id)

    def _release_holds(self, *holds) -> None:
        for hold in holds:
            if hold is not None:
                self.engine.release_shipment(hold)

    def _ingest_shipment(self, req: ServeRequest):
        """Land one request's shipped KV ahead of its admission plan.
        Returns (verdict, hold): ``("ok", hold)``, rows written and the
        prefix registered (the caller releases the hold once the plan has
        its references); ``("requeue", None)``, block exhaustion, treated
        as a plan miss; ``("none", None)``, no ingest happened (an engine
        without one, or a payload it refused: ``req.shipment`` is cleared
        and the local prefill takes over, counted ``failed``)."""
        if not hasattr(self.engine, "ingest_shipment"):
            req.shipment = None
            return "none", None
        alloc = getattr(self.engine, "alloc", None)
        if alloc is not None and alloc.free == 0:
            # No free slot: the plan would requeue anyway. Requeue WITHOUT
            # the device write, which would otherwise repeat (ingest, plan
            # miss, release) once a loop iteration until a slot frees.
            return "requeue", None
        t0 = time.monotonic()
        try:
            with self._device():
                hold = self.engine.ingest_shipment(
                    req.shipment, reserve_steps=req.num_steps)
        except Exception:  # noqa: BLE001 — a bad shipment must not fail
            # the request (its prompt is right here): the local prefill.
            req.shipment = None
            SERVE_SHIP_INGEST_TOTAL.inc(outcome="failed")
            return "none", None
        if hold is None:
            if getattr(self.engine, "kv_paged", False):
                # Not enough free blocks: queue until a retire frees
                # capacity, keeping the payload for the next attempt.
                SERVE_SHIP_INGEST_TOTAL.inc(outcome="exhausted")
                return "requeue", None
            req.shipment = None  # a dense engine: shipping is a no-op
            SERVE_SHIP_INGEST_TOTAL.inc(outcome="unsupported")
            return "none", None
        self._beat()  # the ingest returned: progress, not a stall
        now = time.monotonic()
        SERVE_TRACER.record(
            "kv.ship", t0, now, request_id=req.request_id,
            prompt_tokens=hold.tokens, blocks=len(hold.blocks),
        )
        SERVE_PHASE_SECONDS.inc(now - t0, phase="ship")
        SERVE_SHIP_INGEST_TOTAL.inc(outcome="ok")
        req.shipped_join = True
        return "ok", hold

    def _restore_tier(self, req: ServeRequest):
        """Land one request's deepest host-tier prefix ahead of its
        admission plan (the tier twin of ``_ingest_shipment``). Returns
        (verdict, hold): ``("ok", hold)``, restored and registered;
        ``("requeue", None)``, a restorable entry exists but the pool
        cannot hold it yet (the can-restore wait); ``("none", None)``, no
        tier, no deep-enough entry, or a poison payload (the local prefill
        serves the request either way)."""
        eng = self.engine
        if (getattr(eng, "host_tier", None) is None
                or not hasattr(eng, "restore_from_tier")):
            return "none", None
        alloc = getattr(eng, "alloc", None)
        if alloc is not None and alloc.free == 0:
            # No free slot: skip the upload the plan would throw away.
            return "none", None
        try:
            with self._device():
                hold, outcome = eng.restore_from_tier(
                    np.asarray(req.tokens), reserve_steps=req.num_steps)
        except Exception:  # noqa: BLE001 — a restore is an optimization;
            # the local prefill serves the prompt.
            return "none", None
        if outcome == "ok":
            self._beat()  # the upload returned: progress, not a stall
            req.tier_join = True
            return "ok", hold
        if outcome == "exhausted":
            return "requeue", None
        return "none", None

    def _note_prefill(self, req: ServeRequest, mono0: float, *,
                      joined: bool, plan: Any = None) -> None:
        """Close one prefill device interval: span + per-phase seconds
        (including the ``prefill_interference`` share charged whenever
        live decode slots were waiting behind this prefill)."""
        now = time.monotonic()
        dt = now - mono0
        req.prefill_s += dt
        SERVE_PHASE_SECONDS.inc(dt, phase="prefill")
        if self._slots:
            SERVE_PHASE_SECONDS.inc(dt, phase="prefill_interference")
        attrs: dict[str, Any] = {"request_id": req.request_id}
        if plan is not None:
            attrs["prefill_tokens"] = plan.prefill_tokens
            if getattr(plan, "shared_tokens", 0):
                attrs["shared_tokens"] = plan.shared_tokens
            if joined and plan.prefill_tokens == 0:
                attrs["exact_prefix_join"] = True
        SERVE_TRACER.record(
            "prefill.join" if joined else "prefill.chunk",
            mono0, now, **attrs,
        )

    def _flush_intervals(self, slot: int | None = None,
                         reason: str | None = None,
                         rid: str | None = None) -> None:
        """Emit the open ``decode.interval`` span(s): one slot (its
        retire — ``rid`` names the owner, already gone from _slots) or
        all of them (a prefill about to interleave, the drain, a crash).
        Bounded aggregation — never one span per token."""
        with self._cond:
            slots = ([slot] if slot is not None
                     else list(self._intervals))
            flushed = [(s, self._intervals.pop(s))
                       for s in slots if s in self._intervals]
            owners = {
                s: (rid if rid is not None and s == slot
                    else self._slots[s].request_id if s in self._slots
                    else "")
                for s, _ in flushed
            }
        spec = getattr(self.engine, "spec_k", 0)
        for s, (start, last, steps, rounds) in flushed:
            attrs: dict[str, Any] = {
                "request_id": owners.get(s, ""), "slot": s,
                "tokens": steps,
            }
            if spec and rounds:
                # Speculative rounds: tokens > rounds while the draft
                # rides; the interval's accept rate is where a spec
                # regression shows first.
                attrs["rounds"] = rounds
                attrs["spec_accept_rate"] = round(
                    max(0.0, steps / rounds - 1.0) / spec, 4)
            if reason:
                attrs["closed_by"] = reason
            SERVE_TRACER.record("decode.interval", start, last, **attrs)

    def _retire_telemetry(self, slot: int, req: ServeRequest,
                          reason: str | None = None) -> None:
        """Retirement-side tracing/ITL: flush the slot's open decode
        interval and observe the request's inter-token gaps (exactly
        once, at retirement)."""
        self._flush_intervals(slot, reason=reason, rid=req.request_id)
        for gap in req.itl_values():
            SERVE_ITL_SECONDS.observe(gap)

    def _decode(self) -> None:
        if not self._slots:
            return
        spec = getattr(self.engine, "spec_k", 0)
        t0 = time.perf_counter()
        mono0 = time.monotonic()
        with self._device():
            if spec:
                toks, counts = self.engine.spec_step()
            else:
                toks = self.engine.step()
        # Per-step top-k logprobs (plain engines only: the engine refuses
        # logprobs_k with spec_k): numpy rows already on the host after
        # step(); slots read theirs below.
        lp = (self.engine.last_logprobs()
              if not spec and getattr(self.engine, "logprobs_k", 0)
              else None)
        self._beat()  # the step returned — wedged steps never get here
        now = time.perf_counter()
        mono = time.monotonic()
        with self._cond:
            if self._fenced:
                return
            slots_now = list(self._slots.items())
            SERVE_STEP_SECONDS.observe(now - t0, phase="decode")
            SERVE_PHASE_SECONDS.inc(mono - mono0, phase="decode")
            SERVE_OCCUPANCY.observe(self.engine.occupancy)
            self.decode_steps += 1
            self.occupancy_sum += len(self._slots)
            retired: list[tuple[int, ServeRequest]] = []
            delivered_total = 0
            for slot, req in slots_now:
                window = (toks[slot, :int(counts[slot])] if spec
                          else toks[slot:slot + 1])
                finished, delivered = False, 0
                for tok in window.tolist():
                    req.out.append(tok)
                    req.token_times.append(mono)
                    delivered += 1
                    if self._deliver(req, slot, tok, lp):
                        finished = True
                        break  # the window past the cut is dead
                delivered_total += delivered
                req.decode_s += mono - mono0
                # Aggregate this step into the slot's open interval span:
                # (start, last, tokens, rounds).
                ent = self._intervals.get(slot)
                if ent is None:
                    self._intervals[slot] = [mono0, mono, delivered, 1]
                else:
                    ent[1] = mono
                    ent[2] += delivered
                    ent[3] += 1
                if req.first_token_at is None:
                    req.first_token_at = now
                    if not req.ttft_observed:
                        req.ttft_observed = True
                        SERVE_TTFT_SECONDS.observe(req.ttft)
                if finished:
                    del self._slots[slot]
                    self.engine.retire(slot)
                    self.requests_done += 1
                    retired.append((slot, req))
                    req._finish("ok")
                    if self.supervisor is not None:
                        # A completed request proves this engine serves:
                        # the consecutive-restart budget resets.
                        self.supervisor.note_served()
                elif req.deadline is not None and mono > req.deadline:
                    # Decode deadline: retire the slot, deliver the
                    # PARTIAL generation with the flag.
                    del self._slots[slot]
                    self._expire_decode_deadline(
                        slot, req, "decode_deadline", "decode"
                    )
                elif (ent := self._intervals.get(slot)) is not None \
                        and ent[2] >= DECODE_INTERVAL_STEPS:
                    self._flush_intervals(slot, reason="cap")
            self.tokens_generated += delivered_total
            SERVE_TOKENS_TOTAL.inc(delivered_total)
        for slot, req in retired:
            self._retire_telemetry(slot, req)

    @staticmethod
    def _deliver(req: ServeRequest, slot: int, tok: int, lp) -> bool:
        """The delivery rules of one appended token, in JAX's order: its
        logprob row; the host FSM walk (a completed grammar retires the
        lane, ``grammar_complete``); a stop sequence ending here (trimmed
        with its times and logprob rows, ``stop_sequence``); then the
        budget and eos. Returns whether the request finished."""
        if req.logprobs and lp is not None:
            req.logprob_rows.append({
                "token": tok,
                "logprob": float(lp[0][slot]),
                "top_ids": [int(x) for x in lp[2][slot]],
                "top_logprobs": [float(x) for x in lp[1][slot]],
            })
        if req.program is not None:
            # The device fsm row advanced in the same step; this mirror
            # reads the COMPLETE flag.
            req._walk_state = req.program.walk(req._walk_state, tok)
            if bool(req.program.complete[req._walk_state]):
                req.finish_reason = "grammar_complete"
                SERVE_CONSTRAINED_STOPS.inc(reason="grammar_complete")
                return True
        if req.stop_ids:
            k = match_stop(req.out, req.stop_ids)
            if k:
                # The stop tokens are excluded from the response
                # (apply_stop's post-hoc law); their times and logprob
                # rows go with them.
                del req.out[-k:]
                del req.token_times[-k:]
                if req.logprob_rows:
                    del req.logprob_rows[-k:]
                req.finish_reason = "stop_sequence"
                SERVE_CONSTRAINED_STOPS.inc(reason="stop_sequence")
                return True
        is_eos = req.eos_id is not None and tok == req.eos_id
        if len(req.out) >= req.num_steps or is_eos:
            req.finish_reason = "eos" if is_eos else "length"
            return True
        return False

    def _fail_all(self, exc: Exception) -> None:
        # Typed teardown: waiters see {code, retryable, detail}, never a
        # bare 500 repr.
        self._flush_intervals(reason="crash")
        if not isinstance(exc, ServeError):
            exc = EngineCrashed(f"serving loop crashed: {exc!r}")
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            if self._admitting is not None:
                leftovers.append(self._admitting)
                self._admitting = None
            if self._prefilling is not None:
                req, _, plan = self._prefilling
                leftovers.append(req)
                # Host-side undo of the plan's block reservations.
                self.engine.release_plan(plan)
                self._prefilling = None
            admitted = dict(self._slots)
            leftovers.extend(admitted.values())
            self._slots.clear()
        for slot in admitted:
            # A crashed loop hands the engine back whole.
            try:
                self.engine.retire(slot)
            except Exception:  # noqa: BLE001 — failing-all must finish
                pass
        for req in leftovers:
            if not req.event.is_set():
                req._finish(
                    "rejected" if isinstance(exc, ShuttingDown) else "error",
                    exc,
                )

    # -- observability ----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def mean_occupancy(self) -> float:
        with self._cond:
            if not self.decode_steps:
                return 0.0
            return (self.occupancy_sum / self.decode_steps
                    / self.engine.max_slots)

    def debug_snapshot(self) -> dict:
        """The /debug/serve payload, the JAX scheduler's keys. Supervised
        serving wraps this with a ``resilience`` section
        (EngineSupervisor.debug_snapshot). One consistent view under the
        condvar, which the loop never holds across device work."""
        with self._cond:
            snap = {
                "engine": "continuous",
                "max_slots": self.engine.max_slots,
                "active_slots": self.engine.active_slots,
                "queue_depth": self.queue_depth,
                "queue_limit": self.res.queue_limit,
                "queue_high_water": self.queue_high_water,
                "prefill_chunk": self.engine.prefill_chunk,
                "prefill_tokens_per_step": self.prefill_tokens_per_step,
                "decode_steps": self.decode_steps,
                # Eager engines compile nothing: both read 0 (see the
                # engine's ``decode_step_compiles``).
                "decode_step_compiles": self.engine.decode_step_compiles,
                "warmup_compiles": self.engine.warmup_compiles,
                "tokens_generated": self.tokens_generated,
                "requests_done": self.requests_done,
                "mean_occupancy": round(self.mean_occupancy, 4),
                "ttft_p50_s": SERVE_TTFT_SECONDS.quantile(0.5),
                "ttft_p99_s": SERVE_TTFT_SECONDS.quantile(0.99),
                "itl_p50_s": SERVE_ITL_SECONDS.quantile(0.5),
                "itl_p99_s": SERVE_ITL_SECONDS.quantile(0.99),
                "tracing": {
                    "enabled": SERVE_TRACER.enabled,
                    "capacity": SERVE_TRACER.capacity,
                    "spans": SERVE_TRACER.size(),
                    "dropped": SERVE_TRACER.dropped,
                },
                "draining": self._stopping,
                "degraded": self.degraded,
                "shed_total": self.shed_total,
                "deadline_exceeded_total": self.deadline_total,
                "kv_cache": self.engine.kv_debug(),
                "mesh": (
                    self.engine.mesh_info()
                    if hasattr(self.engine, "mesh_info")
                    else {"devices": 1}
                ),
            }
            if hasattr(self.engine, "constrain_debug"):
                # Pool rows/residency, bind and eviction counters, slots
                # under a program, plus the shared compiler's cache stats
                # when this scheduler has one.
                snap["constrain"] = self.engine.constrain_debug()
                if self.constrainer is not None:
                    snap["constrain"]["compiler"] = self.constrainer.debug()
            if getattr(self.engine, "spec_k", 0):
                # k, rounds, emitted tokens and the accept rate.
                snap["spec"] = self.engine.spec_debug()
            return snap
