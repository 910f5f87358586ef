"""Serving resilience: typed failures, request deadlines, the engine
watchdog, and bounded degradation — the layer that turns "a wedged step
hangs every socket" into "every request resolves, typed, within its
deadline".

A whole copy of ``tf_operator_tpu/serve/resilience.py`` for the port's
serving front: the same error taxonomy, wire payloads and HTTP statuses,
the same config, waiter and supervisor, plus one code-``bad_request``
error of its own (:class:`NotPorted`, below) for request fields and
flags whose ROADMAP item is not ported yet. Four pillars:

1. **Typed errors.** Every failure a client can see carries ``code``,
   ``retryable``, ``detail`` (and optionally ``retry_after_s``) — the
   :class:`ServeError` taxonomy below. A future router reads ``code``
   to distinguish "retry here later" (``queue_full``), "retry elsewhere
   now" (``draining``, ``engine_crashed``), and "eject this replica"
   (``replica_dead``). ``error_payload`` renders any exception into the
   wire shape; untyped exceptions map to a non-retryable ``internal``.

2. **Deadlines.** A request expires in QUEUE (typed 408, it never cost
   device work) after ``queue_ttl_s``, and in DECODE (200 + the partial
   generation + a ``deadline_exceeded`` flag — tokens already paid for
   are delivered, the slot retires) after ``decode_deadline_s`` or a
   per-request override. The decode deadline is absolute from submit,
   so it also bounds time lost to watchdog restarts; the queue TTL is
   per queue residence (a replayed request gets a fresh one).

3. **Watchdog + crash recovery** (:class:`EngineSupervisor`). The
   serving loop heartbeats; on silence past ``watchdog_stall_s`` or an
   uncaught loop exception the supervisor FENCES the old scheduler
   (its thread — possibly still stuck inside a wedged device call — can
   never again touch a request), harvests every live request, rebuilds
   the engine via the factory (fresh KV pool, warmed step), and replays
   the harvested requests from scratch. Greedy replays are bit-identical
   to an uninterrupted run (same prompt, same engine math, fresh state)
   and sampled replays reproduce their seeded key ladder exactly;
   replayed prompts re-register in the new prefix cache, so a replayed
   cohort sharing prefixes re-prefills once (prefix-cache-assisted).
   Restarts are bounded: ``max_restarts`` consecutive failures (the
   budget resets once a rebuilt engine completes a request) with
   exponential backoff, then the replica is DEAD — everything drains
   with ``replica_dead`` 503s and the router routes around it.

4. **Load shedding + degraded mode.** The queue is bounded
   (``queue_limit``): above the watermark new submits shed with a typed
   503 + Retry-After (reject-newest — the queued requests are older and
   closer to their TTLs; shedding the newcomer preserves more deadlines).
   When free KV blocks drop under ``degraded_free_block_frac`` the
   scheduler caps admitted ``max_tokens`` at ``degraded_max_tokens``
   (response carries a ``degraded`` flag), so pool exhaustion shrinks
   answers instead of deadlocking admission.

The supervisor exposes the scheduler surface (``submit``/
``submit_request``/``debug_snapshot``/``stop``) so serve_lm and the
/debug/serve handler talk to ONE object whose engine may be torn down
and rebuilt underneath at any time.

Fault points (serve/faultinject.py) are threaded through the engine and
scheduler so tests/serve_bench can inject each failure mode
deterministically; see docs/resilience.md for the failure model and the
watchdog state machine.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable

from tf_operator_tpu_torch.runtime.metrics import SERVE_WATCHDOG_RESTARTS
from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER
from tf_operator_tpu_torch.serve.faultinject import NULL_INJECTOR

if TYPE_CHECKING:  # annotation-only: the runtime import stays lazy
    from tf_operator_tpu_torch.serve.scheduler import ContinuousScheduler

LOG = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------

# Replica identity for error attribution (fleet routing): serve_lm
# threads --replica-id / $TPU_SERVE_REPLICA_ID here once at startup, and
# every typed payload then self-reports which replica produced it — the
# router's retry logs and tpu_fleet_* metrics attribute failures without
# reverse-mapping ports. Process-wide on purpose: one serve process IS
# one replica.
_REPLICA_ID = ""


def set_replica_id(rid: str) -> None:
    global _REPLICA_ID
    _REPLICA_ID = rid or ""


def replica_id() -> str:
    return _REPLICA_ID


class ServeError(RuntimeError):
    """Base of every typed serving failure: ``code`` names the failure
    mode, ``http_status`` the transport mapping, ``retryable`` whether
    the REQUEST could succeed if retried (here after Retry-After, or on
    another replica — ``code`` tells a router which)."""

    code = "internal"
    http_status = 500
    retryable = False

    def __init__(self, detail: str = "", *,
                 retry_after_s: float | None = None) -> None:
        super().__init__(detail or self.code)
        self.detail = detail or self.code
        self.retry_after_s = retry_after_s

    def payload(self) -> dict:
        out = {
            "error": self.detail,
            "code": self.code,
            "retryable": self.retryable,
            "detail": self.detail,
        }
        if self.retry_after_s is not None:
            out["retry_after_s"] = round(float(self.retry_after_s), 3)
        if _REPLICA_ID:
            out["replica"] = _REPLICA_ID
        return out


class Draining(ServeError):
    """The server is shutting down; the request was fine. Retry on
    another replica."""

    code = "draining"
    http_status = 503
    retryable = True


class ShuttingDown(Draining):
    """The drain-time refusal under the name serve.scheduler exports
    (isinstance checks against Draining keep working)."""


class QueueFull(ServeError):
    """Reject-newest load shedding: the bounded queue is at its
    watermark. Retry after backoff (``retry_after_s``) or elsewhere."""

    code = "queue_full"
    http_status = 503
    retryable = True


class QueueTTLExpired(ServeError):
    """The request aged out waiting for a slot — it never cost any
    device work. 408: the server timed the request out."""

    code = "queue_ttl_expired"
    http_status = 408
    retryable = True


class EngineCrashed(ServeError):
    """The serving loop died (or is restarting) and this request could
    not be carried across. Retryable — a rebuilt engine (or another
    replica) can serve it."""

    code = "engine_crashed"
    http_status = 503
    retryable = True


class ReplicaDead(ServeError):
    """The watchdog exhausted its restart budget: this replica will not
    recover. The request is retryable ON ANOTHER REPLICA — a router
    seeing this code should eject the backend, not just retry."""

    code = "replica_dead"
    http_status = 503
    retryable = True


class ShipFailed(ServeError):
    """A decode replica rejected a shipped-KV payload (chained per-block
    digest mismatch, token mismatch, wrong geometry). Retryable — but
    NOT on another decode replica with the same payload: the
    disaggregation router re-runs the PREFILL stage (or strips the
    shipment and lets the decode pool prefill locally), which is why
    this code is deliberately absent from the router's RETRY_ELSEWHERE
    set."""

    code = "ship_failed"
    http_status = 503
    retryable = True


class PrefixNotFound(ServeError):
    """A ``GET /prefix/<digest>`` export found no live PrefixCache entry
    with stored sampling logits for that digest — the advertisement the
    router acted on went stale (the holder freed the blocks, or the
    digest was only ever a longer prompt's aligned prefix). NOT
    retryable and deliberately absent from RETRY_ELSEWHERE: the
    prefix-aware router treats this as degrade-to-local-prefill — the
    request itself has not failed, only the optimization."""

    code = "prefix_not_found"
    http_status = 404
    retryable = False


class TierMiss(ServeError):
    """A host-tier KV lookup (serve/tier.py) found nothing under a
    digest the caller expected stored — a tier advertisement went stale
    (byte-budget eviction, poison-payload discard, or an engine rebuild
    emptied the tier's owner). Same degrade-don't-fail contract as
    ``prefix_not_found``: NOT retryable, absent from RETRY_ELSEWHERE —
    the request recomputes locally and only the optimization is lost."""

    code = "tier_miss"
    http_status = 404
    retryable = False


class InvalidGrammar(ServeError):
    """A constrained-decoding spec (``json_schema``/``regex``/
    ``choices``/``stop``, serve/constrain.py) failed to compile into a
    token-level DFA: malformed regex, unsupported schema construct, a
    grammar unsatisfiable with this vocabulary, or a program too large
    for the state budget. A 400, NOT retryable — the request itself is
    wrong, so the router must hand the code back to the client rather
    than burn retries on other replicas (compile is deterministic:
    every replica would reject it identically)."""

    code = "invalid_grammar"
    http_status = 400
    retryable = False


class NotPorted(ServeError):
    """A request field or server flag whose ROADMAP item the port has not
    ported yet (the detail names the item): tp x dp serving and spec,
    shipping and the tier under tp (A8b's second half) and pipelined
    checkpoints (A8d). A 400 under the front door's
    ``bad_request`` code, NOT retryable — every port replica would refuse
    it alike; the request never reaches the device."""

    code = "bad_request"
    http_status = 400
    retryable = False


# The COMPLETE wire-code vocabulary: every ``code`` a client or the
# fleet router can see. ServeError subclasses above carry the
# engine-side codes; these are the transport/front-door codes minted as
# plain payloads (fleet/router.py, fleet/replica.py, serve_lm) where no
# exception object exists. tpulint's ``typed-error`` pass enforces that
# every code literal in the tree comes from this vocabulary — a typo'd
# code silently downgrades to "not retryable" at the router, so new
# codes MUST be declared here.
WIRE_CODES = frozenset((
    "internal",            # untyped exception rendered by error_payload
    "bad_request",         # malformed /generate body (400, not retryable)
    "timeout",             # replica-side transport timeout (router retries)
    "replica_unreachable",  # router could not reach the replica at all
    "no_replica",          # router found nothing routable (503 + backoff)
    # Disaggregated prefill/decode (serve/disagg.py, fleet/router.py):
    "prefill_pool_empty",  # two-stage dispatch found no routable prefill
                           # replica; the decode pool prefills locally
                           # (informational on the response, not a
                           # failure — the request still serves)
    # Fleet-global prefix reuse (fleet/prefixes.py, fleet/router.py):
    "prefix_not_found",    # /prefix/<digest> export found no live entry
                           # (stale advertisement) — the router degrades
                           # to local prefill, the request still serves
    # KV memory hierarchy (serve/tier.py, docs/kv-tiering.md):
    "tier_miss",           # host-tier lookup under an advertised digest
                           # found nothing (evicted / discarded /
                           # rebuilt) — recompute locally, request
                           # still serves
    # Structured & constrained decoding (serve/constrain.py):
    "invalid_grammar",     # constraint spec failed to compile (400 at
                           # enqueue, deterministic — never retried on
                           # another replica)
    "stop_sequence",       # finish_reason wire value: a multi-token
                           # stop sequence matched and the output was
                           # trimmed at the match (a finish reason, not
                           # a failure — carried in the same vocabulary
                           # so a typo'd literal trips tpulint)
))


def error_payload(exc: Exception) -> dict:
    """The wire shape for ANY exception: typed errors render themselves;
    anything else becomes a non-retryable ``internal`` (500) whose
    detail still carries the repr — no failure leaves as a bare
    unstructured 500."""
    if isinstance(exc, ServeError):
        return exc.payload()
    out = {"error": repr(exc), "code": "internal", "retryable": False,
           "detail": repr(exc)}
    if _REPLICA_ID:
        out["replica"] = _REPLICA_ID
    return out


def http_status_of(exc: Exception) -> int:
    if isinstance(exc, ServeError):
        return exc.http_status
    return 500


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass
class ResilienceConfig:
    """Every knob defaults OFF (None/0) so a bare ContinuousScheduler
    keeps its bare semantics exactly; serve_lm turns the layer on with
    production defaults via its flags."""

    queue_ttl_s: float | None = None        # expire queued requests (408)
    decode_deadline_s: float | None = None  # absolute submit->done bound
    watchdog_stall_s: float | None = None   # heartbeat silence -> restart
    max_restarts: int = 3                   # consecutive, before dead
    restart_backoff_s: float = 0.25         # base of the exponential
    queue_limit: int | None = None          # bounded queue watermark
    degraded_free_block_frac: float = 0.0   # 0 disables degraded mode
    degraded_max_tokens: int = 32           # the degraded-mode cap
    drain_timeout_s: float | None = None    # bound the SIGTERM drain

    @property
    def enabled(self) -> bool:
        return any((
            self.queue_ttl_s, self.decode_deadline_s,
            self.watchdog_stall_s, self.queue_limit,
            self.degraded_free_block_frac, self.drain_timeout_s,
        ))


def await_request(req: Any, timeout: float = 600.0) -> Any:
    """Block for a submitted request's terminal state: returns the
    request (carrying ``out`` and flags) or raises its typed error.
    Lives here so the supervisor and the scheduler share one waiter."""
    if not req.event.wait(timeout=timeout):
        raise TimeoutError("continuous decode timed out")
    if req.error is not None:
        raise req.error
    return req


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------


class EngineSupervisor:
    """Owns the engine + scheduler lifecycle. ``engine_factory`` must
    build a fresh, warmed engine (same cfg/params every time — replay
    bit-identity depends on it). The supervisor is the long-lived object
    servers hold; the scheduler/engine pair underneath is generation-
    scoped and may be replaced by the watchdog at any time."""

    def __init__(self, engine_factory: Callable[[], Any], *,
                 resilience: ResilienceConfig | None = None,
                 faults: Any = None,
                 prefill_tokens_per_step: int = 256,
                 device_lock: threading.Lock | None = None,
                 tier_prefetch: bool = True,
                 constrainer: Any = None) -> None:
        # Local import: scheduler imports this module for the error
        # taxonomy, so the supervisor resolves it lazily.
        from tf_operator_tpu_torch.serve.scheduler import ContinuousScheduler

        self._sched_cls = ContinuousScheduler
        self._factory = engine_factory
        self.res = resilience or ResilienceConfig()
        self.faults = faults or NULL_INJECTOR
        self._prefill_budget = prefill_tokens_per_step
        self._device_lock = device_lock
        # Session prefetch knob (serve/tier.py), generation-invariant:
        # every rebuilt scheduler inherits it.
        self._tier_prefetch = bool(tier_prefetch)
        # Constraint compiler (serve/constrain.py), process-lifetime: a
        # watchdog rebuild keeps the compiled-program LRU, and replayed
        # constrained requests re-bind their (already stamped) programs
        # into the fresh engine's pool.
        self._constrainer = constrainer
        self._lock = threading.RLock()     # guards the generation swap
        self._restart_lock = threading.Lock()
        self._closed = False
        self.dead = False
        self.restarts = 0                  # lifetime restarts
        self._attempts = 0                 # consecutive, resets on health
        self.last_fault: str | None = None
        self.last_restart_at: float | None = None
        # Aggregates carried across generations (each scheduler's own
        # counters start at zero).
        self._done_prev = 0
        self._tokens_prev = 0
        self._shed_prev = 0
        self._deadline_prev = 0
        self._qhw_max = 0
        self._max_slots = 0                # last live engine's capacity
        self._sched: ContinuousScheduler | None = None
        self._build(replay=())
        self._watchdog: threading.Thread | None = None
        if self.res.watchdog_stall_s:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True,
                name="serve-watchdog",
            )
            self._watchdog.start()

    # -- generation management -------------------------------------------

    def _build(self, replay) -> None:
        engine = self._factory()
        sched = self._sched_cls(
            engine,
            prefill_tokens_per_step=self._prefill_budget,
            device_lock=self._device_lock,
            resilience=self.res,
            supervisor=self,
            faults=self.faults,
            tier_prefetch=self._tier_prefetch,
            constrainer=self._constrainer,
        )
        if replay:
            sched.requeue(replay)
        with self._lock:
            self._sched = sched
        sched.start()

    @property
    def scheduler(self) -> Any:
        with self._lock:
            return self._sched

    @property
    def engine(self) -> Any:
        return self.scheduler.engine

    # -- client surface ----------------------------------------------------

    def submit(self, tokens, num_steps: int, **kw):
        """Scheduler-shaped convenience: returns the [1, n] token array
        (partial when a deadline fired — check ``submit_request`` for
        the flags)."""
        import numpy as np

        from tf_operator_tpu_torch.serve.scheduler import ServeRequest

        timeout = kw.pop("timeout", 600.0)
        req = ServeRequest(tokens, num_steps, **kw)
        return np.asarray(
            self.submit_request(req, timeout=timeout).out, np.int32
        ).reshape(1, -1)

    def submit_request(self, req: Any, timeout: float = 600.0) -> Any:
        """Enqueue on the CURRENT generation and wait. A restart between
        enqueue and completion is invisible here: the harvested request
        keeps its event, the new generation finishes it. An enqueue that
        races the fence retries on the next generation."""
        from tf_operator_tpu_torch.serve.scheduler import SchedulerFenced

        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self.dead:
                    raise ReplicaDead("serving replica marked dead "
                                      "(restart budget exhausted)")
                sched = self._sched
            try:
                sched.enqueue(req)
                break
            except SchedulerFenced:
                if time.monotonic() > deadline:
                    # Typed: this is a replica-side condition (the
                    # rebuild outlasted the caller's budget), not a bad
                    # request — a router should retry elsewhere.
                    raise EngineCrashed(
                        "engine restarting; enqueue timed out"
                    )
                time.sleep(0.01)  # a rebuild is in flight
        return await_request(
            req, timeout=max(0.0, deadline - time.monotonic())
        )

    def stop(self, timeout: float = 60.0) -> None:
        """Drain the current generation (bounded by the config's
        ``drain_timeout_s`` inside the loop) and stop the watchdog.
        Holding the restart lock first lets any in-flight restart finish
        (its backoff is bounded) and guarantees no NEW generation can be
        built afterwards — every restart re-checks ``_closed`` under
        that lock — so the generation we drain is the last one ever."""
        self._closed = True
        with self._restart_lock:
            sched = self.scheduler
        if sched is not None:
            sched.stop(timeout=timeout)

    # -- failure handling --------------------------------------------------

    def on_loop_crash(self, sched: ContinuousScheduler,
                      exc: Exception) -> bool:
        """Called by a dying serving loop. Returns True when the
        supervisor takes ownership (the loop must NOT fail its waiters —
        they will be replayed, or a concurrent restart already harvested
        them); False hands back the legacy fail-all path (stale-but-
        unharvested generation, or supervisor shut down)."""
        with self._lock:
            if self._closed or self.dead or sched is not self._sched:
                # A superseded generation was fenced+harvested — its
                # requests belong to the supervisor already.
                return sched._fenced
        LOG.warning(f"serving loop crashed; restarting engine: {exc!r}")
        # The dying thread itself performs the restart (it has nothing
        # else to do, and the backoff sleep belongs to the failure).
        return self._restart("crash", exc, sched)

    def note_served(self) -> None:
        """A request completed on the current generation: the
        consecutive-restart budget resets. Called by the scheduler on
        every ok-retire (a fenced generation can never finish a request,
        so no staleness check is needed) — the watchdog thread also
        resets, but crash-only supervision (watchdog_stall_s unset) has
        no watchdog thread to do it."""
        # Under the generation RLock (NOT the restart lock, which is
        # held across backoff sleeps): the scheduler calls this from its
        # condvar body, and _lock is never held while acquiring _cond,
        # so _cond -> _lock stays acyclic in the lock-order graph.
        with self._lock:
            self._attempts = 0

    def _watch(self) -> None:
        stall = float(self.res.watchdog_stall_s)
        period = max(0.01, min(stall / 4.0, 0.5))
        while True:
            time.sleep(period)
            with self._lock:
                if self._closed or self.dead:
                    return
                sched = self._sched
            if sched is None or not sched.running:
                continue
            # A completed request on this generation proves the rebuilt
            # engine serves; the consecutive-failure budget resets.
            with self._lock:
                if self._attempts and sched.requests_done > 0:
                    self._attempts = 0
            age = time.monotonic() - sched.heartbeat
            if age > stall:
                self._restart(
                    "stall", None, sched,
                    detail=f"heartbeat silent {age:.2f}s > {stall}s",
                )

    def _restart(self, reason: str, exc: Exception | None,
                 sched: ContinuousScheduler,
                 detail: str = "") -> bool:
        """Fence, harvest, rebuild, replay. Returns True when this (or a
        concurrent) restart took ownership of ``sched``'s requests —
        the crash path uses it to decide whether the dying loop may
        still fail-all. Acquires the restart lock with a timeout loop:
        ``stop()`` holds that lock while draining, and a crash-path
        caller blocking on it uninterruptibly would deadlock the very
        thread stop() is joining."""
        from tf_operator_tpu_torch.runtime.metrics import SERVE_DEADLINE_TOTAL

        while not self._restart_lock.acquire(timeout=0.05):
            if self._closed:
                return False  # stop() owns shutdown; loop fail-alls
        try:
            with self._lock:
                if self._closed:
                    return False
                if self.dead or sched is not self._sched:
                    # Superseded: whoever fenced it owns its requests.
                    return sched._fenced
            t_restart = time.monotonic()
            harvested = sched.fence_and_harvest()
            # Aggregate roll-over + budget bump under the generation
            # RLock: debug()/requests_done/note_served read these from
            # other threads, and _restart_lock is the wrong guard for
            # them (it is held across the backoff sleep below — readers
            # must never block on it).
            with self._lock:
                self._done_prev += sched.requests_done
                self._tokens_prev += sched.tokens_generated
                self._shed_prev += sched.shed_total
                self._deadline_prev += sched.deadline_total
                self._qhw_max = max(self._qhw_max, sched.queue_high_water)
                self.restarts += 1
                self._attempts += 1
                self.last_fault = (detail or repr(exc)) + f" [{reason}]"
                self.last_restart_at = time.time()
            SERVE_WATCHDOG_RESTARTS.inc(reason=reason)
            LOG.warning(
                f"engine restart ({reason}) attempt {self._attempts}: "
                f"{len(harvested)} in-flight to replay; {self.last_fault}"
            )
            if self._attempts > self.res.max_restarts:
                self._declare_dead(harvested)
                # The terminal fence still gets its bridging span — the
                # one incident an operator most needs the trace to
                # explain is "every request just stopped here".
                SERVE_TRACER.record(
                    "watchdog.restart", t_restart, time.monotonic(),
                    reason=reason, attempt=self._attempts,
                    harvested=len(harvested), replayed=0,
                    outcome="replica_dead",
                    detail=self.last_fault or "",
                )
                return True
            # A harvested request whose absolute deadline already passed
            # resolves NOW with whatever it had (the deadline contract
            # does not pause for restarts); the rest replay.
            now = time.monotonic()
            replay = []
            for req in harvested:
                if req.deadline is not None and now > req.deadline:
                    req.deadline_exceeded = True
                    req.timeout_cause = "decode_deadline"
                    SERVE_DEADLINE_TOTAL.inc(kind="decode")
                    req._finish("deadline")
                else:
                    replay.append(req)
            # lint: ok blocking-under-lock — the backoff sleep belongs to the failure; stop()/crash callers acquire this lock with timeout loops for exactly this reason
            time.sleep(
                self.res.restart_backoff_s * (2 ** (self._attempts - 1))
            )
            try:
                self._build(replay=replay)
            except Exception as build_exc:  # noqa: BLE001 — a factory
                # that cannot build an engine is a dead replica.
                LOG.error(
                    f"engine rebuild failed; replica dead: {build_exc!r}"
                )
                self._declare_dead(replay)
            # The fence→rebuild window on the fleet timeline: every
            # harvested request's spans stop at the fence and resume
            # (same request_id, replays+1) after this span — the trace
            # answers "why did this request's ITL spike" with "the
            # watchdog restarted the engine here".
            SERVE_TRACER.record(
                "watchdog.restart", t_restart, time.monotonic(),
                reason=reason, attempt=self._attempts,
                harvested=len(harvested), replayed=len(replay),
                detail=self.last_fault or "",
            )
            return True
        finally:
            self._restart_lock.release()

    def _declare_dead(self, leftovers) -> None:
        with self._lock:
            self.dead = True
            self._sched = None
        exc = ReplicaDead("serving replica dead after "
                          f"{self.restarts} restart(s): {self.last_fault}")
        for req in leftovers:
            if not req.event.is_set():
                req._finish("error", exc)
        LOG.error(
            f"serving replica declared dead after {self.restarts} "
            f"restart(s); last fault: {self.last_fault}"
        )

    # -- proxied observability --------------------------------------------

    @property
    def active_slots(self) -> int:
        sched = self.scheduler
        return sched.engine.active_slots if sched is not None else 0

    @property
    def queue_depth(self) -> int:
        sched = self.scheduler
        return sched.queue_depth if sched is not None else 0

    @property
    def max_slots(self) -> int:
        """Slot capacity, held steady through rebuild windows (capacity
        is a config fact, not a generation fact) — the fleet readiness
        payload normalizes load by it."""
        sched = self.scheduler
        if sched is not None:
            self._max_slots = sched.engine.max_slots
        return self._max_slots

    @property
    def mesh_devices(self) -> int:
        """SPMD decode-mesh width, held steady through rebuild windows
        like ``max_slots`` (the factory reconstructs the same mesh every
        generation) — /healthz reports it so the fleet router can see
        replica width."""
        sched = self.scheduler
        if sched is not None:
            info = (
                sched.engine.mesh_info()
                if hasattr(sched.engine, "mesh_info")
                else {"devices": 1}
            )
            self._mesh_devices = int(info.get("devices", 1))
        return getattr(self, "_mesh_devices", 1)

    @property
    def mesh_axes(self) -> dict:
        """Both SPMD decode-mesh axes ({"tp": N, "dp": M}), held steady
        through rebuild windows like ``mesh_devices`` — /healthz and
        /debug/serve report the pod SHAPE, not just its width (a
        tp=2,dp=2 replica and a tp=4 replica are both 4 chips but serve
        very different slot capacity)."""
        sched = self.scheduler
        if sched is not None:
            info = (
                sched.engine.mesh_info()
                if hasattr(sched.engine, "mesh_info")
                else {}
            )
            self._mesh_axes = {"tp": int(info.get("tp", 1)),
                               "dp": int(info.get("dp", 1))}
        return getattr(self, "_mesh_axes", {"tp": 1, "dp": 1})

    @property
    def requests_done(self) -> int:
        with self._lock:   # pair with _restart's aggregate roll-over
            sched = self._sched
            return self._done_prev + (sched.requests_done if sched else 0)

    @property
    def tokens_generated(self) -> int:
        with self._lock:
            sched = self._sched
            return self._tokens_prev + (
                sched.tokens_generated if sched else 0)

    def debug(self) -> dict:
        """The /debug/serve ``resilience`` section. One consistent view
        under the generation RLock — never the restart lock, which is
        held across backoff sleeps (debug must stay responsive DURING a
        restart storm; the aggregates it reads are rolled over under
        _lock in _restart for exactly this reason)."""
        with self._lock:
            sched = self._sched
            return {
            "watchdog_stall_s": self.res.watchdog_stall_s,
            "restarts": self.restarts,
            "restart_attempts": self._attempts,
            "max_restarts": self.res.max_restarts,
            "dead": self.dead,
            "last_fault": self.last_fault,
            "last_restart_at": self.last_restart_at,
            "queue_ttl_s": self.res.queue_ttl_s,
            "decode_deadline_s": self.res.decode_deadline_s,
            "queue_limit": self.res.queue_limit,
            # Lifetime aggregates: restarts must not make dashboard
            # counters go backwards (requests_done/tokens carry the same
            # way via their properties).
            "queue_high_water": max(
                self._qhw_max, sched.queue_high_water if sched else 0
            ),
            "shed_total": self._shed_prev + (
                sched.shed_total if sched else 0
            ),
            "deadline_exceeded_total": self._deadline_prev + (
                sched.deadline_total if sched else 0
            ),
            "degraded": bool(sched.degraded) if sched else False,
            "degraded_free_block_frac": self.res.degraded_free_block_frac,
            "drain_timeout_s": self.res.drain_timeout_s,
            "faults": self.faults.snapshot(),
        }

    def debug_snapshot(self) -> dict:
        """Scheduler snapshot + the resilience section — the /debug/serve
        payload when serving runs supervised (httpapi mounts the
        SUPERVISOR so the handler survives engine rebuilds)."""
        sched = self.scheduler
        if sched is None:
            snap = {"engine": "continuous", "dead": True}
        else:
            snap = sched.debug_snapshot()
        snap["resilience"] = self.debug()
        return snap

    # -- fleet-global prefix reuse (fleet/prefixes.py) --------------------

    def advertised_prefixes(self) -> list[str]:
        """The live generation's hot-prefix advertisement (empty across
        a rebuild window — a restarting engine holds no blocks, and a
        stale advertisement would just degrade to a typed pull miss)."""
        sched = self.scheduler
        return sched.advertised_prefixes() if sched is not None else []

    def advertised_tier_prefixes(self) -> list[str]:
        """The live generation's warm host-tier advertisement. Empty
        across a rebuild window like the hot list — though serve_lm
        attaches ONE process-lifetime HostTier to every rebuilt engine,
        so the tier's contents (unlike HBM blocks) survive the restart
        and re-advertise as soon as the new generation serves."""
        sched = self.scheduler
        if sched is None:
            return []
        fn = getattr(sched, "advertised_tier_prefixes", None)
        return fn() if fn is not None else []

    def export_prefix(self, digest: str, timeout: float = 30.0) -> dict:
        """``GET /prefix/<digest>`` through the supervisor: delegates to
        the live generation; a rebuild window answers the typed
        ``prefix_not_found`` (the entry died with the old engine)."""
        sched = self.scheduler
        if sched is None:
            raise PrefixNotFound("engine rebuilding; no live prefixes")
        return sched.export_prefix(digest, timeout=timeout)
