"""Prometheus-style metrics registry (text exposition format) for the
port's serving front.

Counterpart of ``tf_operator_tpu/runtime/metrics.py``, kept to what the
port's serving path touches: the registry primitives (counters, gauges,
histograms with labels, rendered in the Prometheus text format at
/metrics) and the ``tpu_serve_*`` families of the continuous-batching
front, under the JAX package's names, labels and buckets, so a scrape of
either server parses the same way: constrained decoding's four families,
speculative decoding's two, and the five of KV shipments and the host KV
tier (shipment ingests and shipped tokens; the tier's bytes, restores and
spills) included.

Thread-safe; all mutation is under one lock per metric family.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0,
)


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...],
                extra: str = "") -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(float(v)) if not float(v).is_integer() else str(int(v))


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Iterable[str] = ()) -> None:
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def render(self) -> list[str]:
        with self._lock:
            snap = sorted(self._series.items())
        return [
            f"{self.name}{_fmt_labels(self.labelnames, key)} {_fmt_value(v)}"
            for key, v in snap
        ]


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    render = Counter.render


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"counts": [0] * (len(self.buckets) + 1),
                          "sum": 0.0, "n": 0}
                self._series[key] = series
            # First bucket whose upper bound (le) admits the value; values
            # beyond the last bound land in the +Inf overflow slot.
            series["counts"][bisect_left(self.buckets, value)] += 1
            series["sum"] += value
            series["n"] += 1

    def snapshot(self, **labels: str) -> list[int]:
        """Merged per-bucket counts now — pass to quantile(since=...) to
        measure only observations made after this point (the registry is
        process-global, so long-lived tests must window their reads)."""
        with self._lock:
            if labels:
                series = [self._series.get(self._key(labels))]
                series = [s for s in series if s]
            else:
                series = list(self._series.values())
            counts = [0] * (len(self.buckets) + 1)
            for s in series:
                for i, c in enumerate(s["counts"]):
                    counts[i] += c
        return counts

    def quantile(self, q: float, since: list[int] | None = None,
                 **labels: str) -> float:
        """Upper bucket bound holding the q-th observation (conservative).

        With labels: that series only; without: all series merged. ``since``
        (a snapshot() result) subtracts earlier observations. Returns 0.0
        with no observations, +inf when the quantile lands in the overflow
        bucket.
        """
        counts = self.snapshot(**labels)
        if since is not None:
            counts = [max(0, c - s) for c, s in zip(counts, since)]
        total = sum(counts)
        if not total:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")

    def render(self) -> list[str]:
        out = []
        with self._lock:
            snap = sorted(
                (k, {"counts": list(s["counts"]), "sum": s["sum"], "n": s["n"]})
                for k, s in self._series.items()
            )
        for key, s in snap:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += s["counts"][i]
                # The le label is built outside the f-string: a backslash in
                # an f-string expression part is a SyntaxError before 3.12.
                le = 'le="%s"' % _fmt_value(b)
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.labelnames, key, le)}"
                    f" {cum}"
                )
            cum += s["counts"][-1]
            inf = 'le="+Inf"'
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.labelnames, key, inf)} {cum}"
            )
            out.append(
                f"{self.name}_sum{_fmt_labels(self.labelnames, key)} "
                f"{repr(float(s['sum']))}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(self.labelnames, key)} {s['n']}"
            )
        return out


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, fam: _Family) -> _Family:
        with self._lock:
            existing = self._families.get(fam.name)
            if existing is not None:
                # Re-registration must be an exact match — a silent return
                # of a differently-shaped family would defer the error to
                # emission time, far from the offending registration.
                if type(existing) is not type(fam):
                    raise ValueError(f"{fam.name} already registered as "
                                     f"{existing.kind}")
                if existing.labelnames != fam.labelnames:
                    raise ValueError(
                        f"{fam.name} already registered with labels "
                        f"{existing.labelnames}, got {fam.labelnames}"
                    )
                if (
                    isinstance(existing, Histogram)
                    and existing.buckets != fam.buckets  # type: ignore[attr-defined]
                ):
                    raise ValueError(
                        f"{fam.name} already registered with buckets "
                        f"{existing.buckets}"
                    )
                return existing
            self._families[fam.name] = fam
            return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help_text, labelnames))  # type: ignore[return-value]

    def gauge(self, name: str, help_text: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_text, labelnames))  # type: ignore[return-value]

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_text, labelnames, buckets))  # type: ignore[return-value]

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


# ---------------------------------------------------------------------------
# Continuous-batching serving metric families (consumed by
# serve/scheduler.py and rendered by serve/serve_lm.py's /metrics).
# Declared at import so every process exposes the full schema from the
# first scrape: a dashboard pointed at a just-started, still-idle server
# sees the queue/occupancy series at 0 instead of absent.
# ---------------------------------------------------------------------------

SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "tpu_serve_queue_depth",
    "Requests waiting for a free decode slot",
)
SERVE_SLOTS_ACTIVE = REGISTRY.gauge(
    "tpu_serve_active_slots",
    "Decode slots currently occupied by in-flight requests",
)
SERVE_SLOT_CAPACITY = REGISTRY.gauge(
    "tpu_serve_slot_capacity",
    "Preallocated decode slots (the engine's max batch)",
)
SERVE_REQUESTS_TOTAL = REGISTRY.counter(
    "tpu_serve_requests_total",
    "Requests finished by the continuous engine, by outcome "
    "(ok | error | rejected — rejected is the drain-time 503)",
    ("outcome",),
)
SERVE_TOKENS_TOTAL = REGISTRY.counter(
    "tpu_serve_generated_tokens_total",
    "Tokens generated across all slots (the tokens/sec numerator)",
)
SERVE_PREFILL_TOKENS_TOTAL = REGISTRY.counter(
    "tpu_serve_prefill_tokens_total",
    "Prompt tokens prefilled into slots",
)
SERVE_TTFT_SECONDS = REGISTRY.histogram(
    "tpu_serve_ttft_seconds",
    "Submit-to-first-generated-token wall time per request",
)
SERVE_ITL_SECONDS = REGISTRY.histogram(
    "tpu_serve_itl_seconds",
    "Inter-token latency: gap between consecutive generated tokens of "
    "one request, observed per retired request from its decode-step "
    "timestamps (the tail a streaming client actually feels; prefill "
    "interference on decode slots shows up HERE first)",
)
SERVE_PHASE_SECONDS = REGISTRY.counter(
    "tpu_serve_phase_seconds_total",
    "Cumulative host-observed device time by serving phase: prefill = "
    "prompt prefill slices, decode = batched decode steps, cow = "
    "copy-on-write block copies, prefill_interference = the subset of "
    "prefill time that ran WHILE decode slots were active (every such "
    "second is a second stolen from live decodes — the ROADMAP item-2 "
    "disaggregation pin reads this)",
    ("phase",),
)
SERVE_STEP_SECONDS = REGISTRY.histogram(
    "tpu_serve_step_seconds",
    "Serving-loop device iterations by phase: one decode step over the "
    "slot tensor, or one token-budgeted prefill slice",
    ("phase",),  # prefill | decode
)
SERVE_KV_BLOCKS = REGISTRY.gauge(
    "tpu_serve_kv_blocks",
    "Paged KV-cache pool blocks by state: free = allocatable now, "
    "used = held by live slots (the pinned garbage block 0 is excluded), "
    "shared = refcount >= 2 via prefix sharing",
    ("state",),
)
SERVE_KV_COW_TOTAL = REGISTRY.counter(
    "tpu_serve_kv_cow_copies_total",
    "Copy-on-write block copies: a slot's first decode write into a "
    "shared partial block copied it to a privately-owned block first",
)
SERVE_PREFILL_SAVED_TOTAL = REGISTRY.counter(
    "tpu_serve_prefill_tokens_saved_total",
    "Prompt tokens whose prefill was skipped because a shared prefix "
    "already held their K/V blocks",
)
SERVE_WATCHDOG_RESTARTS = REGISTRY.counter(
    "tpu_serve_watchdog_restarts_total",
    "Engine teardown + rebuild cycles performed by the serving watchdog, "
    "by trigger (stall = heartbeat silence past --watchdog-stall, "
    "crash = uncaught decode-loop exception)",
    ("reason",),
)
SERVE_DEADLINE_TOTAL = REGISTRY.counter(
    "tpu_serve_deadline_exceeded_total",
    "Requests resolved by a deadline instead of completion, by kind: "
    "queue = expired waiting for a slot (typed 408), decode = decode "
    "deadline hit mid-generation (200 + partial tokens + flag), drain = "
    "cut by the bounded SIGTERM drain (--drain-timeout, same partial "
    "path)",
    ("kind",),
)
SERVE_SHED_TOTAL = REGISTRY.counter(
    "tpu_serve_shed_total",
    "Requests rejected at submit because the bounded queue was at its "
    "watermark (reject-newest load shedding; typed 503 + Retry-After)",
)
SERVE_DEGRADED = REGISTRY.gauge(
    "tpu_serve_degraded",
    "1 while the engine admits in degraded mode (free KV blocks below "
    "the --degraded-blocks watermark caps admitted max_tokens), else 0",
)
SERVE_MESH_DEVICES = REGISTRY.gauge(
    "tpu_serve_mesh_devices",
    "Devices in the continuous engine's SPMD decode mesh (1 = "
    "single-chip; >1 = one compiled step drives the whole slice, KV "
    "storage head-sharded over the tp axis)",
)
SERVE_OCCUPANCY = REGISTRY.histogram(
    "tpu_serve_batch_occupancy",
    "Fraction of decode slots active, observed at every decode step — "
    "the quantity decode throughput is proportional to",
    buckets=(0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)
SERVE_SHIP_INGEST_TOTAL = REGISTRY.counter(
    "tpu_serve_kv_ship_ingest_total",
    "Shipped-KV ingest attempts on a decode replica, by outcome (ok: "
    "blocks written + prefix registered; exhausted: no free blocks — "
    "the request requeued; unsupported: dense engine, shipment dropped "
    "and prefill ran locally; failed: malformed/mismatched payload, "
    "local-prefill fallback)",
    ("outcome",),
)
SERVE_SHIP_TOKENS_TOTAL = REGISTRY.counter(
    "tpu_serve_ship_tokens_total",
    "Prompt tokens whose K/V arrived as shipped block-pool rows from a "
    "dedicated prefill replica instead of local prefill (the "
    "disaggregation win: these tokens never time-shared the decode "
    "device)",
)
SERVE_KV_TIER_BYTES = REGISTRY.gauge(
    "tpu_serve_kv_tier_bytes",
    "Host-RAM KV tier occupancy by tier label (host = decoded bytes of "
    "spilled prefix payloads currently stored, host_free = remaining "
    "byte budget) — the second level of the KV memory hierarchy "
    "(docs/kv-tiering.md)",
    ("tier",),
)
SERVE_KV_TIER_RESTORES = REGISTRY.counter(
    "tpu_serve_kv_tier_restores_total",
    "Host-tier KV restore attempts on admission/prefetch, by outcome "
    "(ok: payload uploaded into pool blocks + prefix registered; "
    "exhausted: tier hit but no free HBM blocks — the request waits; "
    "miss: no stored prefix deeper than the hot HBM hit; failed: "
    "stored payload no longer decodes — dropped, local prefill runs)",
    ("outcome",),
)
SERVE_KV_TIER_SPILLS = REGISTRY.counter(
    "tpu_serve_kv_tier_spills_total",
    "Prefix entries spilled from the HBM block pool into the host-RAM "
    "KV tier when their last pool holder freed (retention reclaim, "
    "retire, CoW source release) instead of vanishing",
)

SERVE_SPEC_ACCEPT_TOKENS = REGISTRY.histogram(
    "tpu_serve_spec_accept_tokens",
    "Tokens emitted per slot per speculative round (the incoming pend "
    "token plus the accepted draft prefix, 1..k+1) — the distribution "
    "behind the engine's accept rate: mean/(k+1) near 1 means the draft "
    "is riding, near 1/(k+1) means every round falls back to one token",
    buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0),
)
SERVE_SPEC_ROUNDS_TOTAL = REGISTRY.counter(
    "tpu_serve_spec_rounds_total",
    "Speculative decode rounds executed (one per-slot draft of k tokens "
    "+ one batched k+1-position verify forward each) — tokens/round = "
    "tpu_serve_generated_tokens_total over this counter while the spec "
    "engine serves",
)

SERVE_CONSTRAINED_REQUESTS = REGISTRY.counter(
    "tpu_serve_constrained_requests_total",
    "Requests admitted with a compiled constraint program, by spec kind "
    "(json_schema/regex/choices) — unconstrained traffic never touches "
    "this counter (docs/constrained-decoding.md)",
    ("kind",),
)
SERVE_CONSTRAINED_STOPS = REGISTRY.counter(
    "tpu_serve_constrained_stops_total",
    "Completions finished by the host-side stop machinery, by reason "
    "(stop_sequence: a multi-token stop matched and the tail was "
    "trimmed; grammar_complete: the constraint DFA reached a state "
    "with nothing left to emit and the slot retired)",
    ("reason",),
)
SERVE_CONSTRAIN_PROGRAMS = REGISTRY.gauge(
    "tpu_serve_constrain_programs",
    "Compiled constraint programs resident in the device-side paged "
    "constraint pool (row ranges of the batch-wide allow/next tables); "
    "refcount-0 residents are reuse candidates, not leaks",
)
SERVE_CONSTRAIN_EVICTIONS = REGISTRY.counter(
    "tpu_serve_constrain_evictions_total",
    "Constraint-program evictions by tier (cache: host LRU of compiled "
    "DFAs outgrew its bound; pool: a refcount-0 resident gave up its "
    "device rows to an incoming bind) — steady growth under a stable "
    "program set means the cache/pool knobs are undersized",
    ("tier",),
)

# -- tracing (runtime/tracing.py): declared here, not there, so the
# registry module stays import-leaf and the tracer can import it --------------

TRACE_SPANS_DROPPED = REGISTRY.counter(
    "tpu_trace_spans_dropped_total",
    "Spans evicted from a tracer's bounded ring before export, by "
    "tracer process name — a non-zero rate means /debug/traces starts "
    "mid-story and --trace-capacity should grow",
    ("tracer",),
)
