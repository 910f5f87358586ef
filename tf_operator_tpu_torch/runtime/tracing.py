"""Tracing for the port's serving front: timed spans with Chrome-trace
(catapult) export.

Counterpart of ``tf_operator_tpu/runtime/tracing.py``'s ``Tracer``,
``SERVE_TRACER`` and ``mint_request_id``. Spans are cheap (one monotonic
clock pair + a deque append), keep a bounded in-memory ring, and export
in the ``chrome://tracing`` / ui.perfetto.dev JSON format at
``/debug/traces`` on the port's server (``serve/serve_lm.py``).

Spans record wall-clock microseconds (Chrome's "ts") from the tracer's
epoch, thread id as "tid", and keyword attributes as "args". Each tracer
pairs its monotonic epoch with a wall-clock stamp taken at the same
instant and exports it as ``epochUnixUs``, so the JAX package's fleet
router can merge a port replica's traces with its other replicas'.

``SERVE_TRACER`` is process-global on purpose: a supervisor engine
rebuild swaps the scheduler/engine generation underneath, but the ring
(and every span the dead generation recorded) survives.

The ring is bounded and evictions are COUNTED (``dropped`` +
``tpu_trace_spans_dropped_total``) so "the trace ends here because the
ring wrapped" is observable, never silent; attribute values are
sanitized at export (printable, length-capped). ``set_capacity`` is the
runtime knob (serve_lm ``--trace-capacity``; 0 disables tracing
entirely — the ``span``/``record`` fast path is then one attribute
read).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

from tf_operator_tpu_torch.runtime.metrics import TRACE_SPANS_DROPPED

# Attr-value cap: long enough for ids/prompts-prefixes, short enough
# that a pathological attr cannot bloat the export.
_MAX_ATTR_CHARS = 256


def _sanitize_attr(value: Any) -> str:
    """Render one span attribute export-safe: stringified, control and
    other non-printable characters (incl. lone surrogates, which break
    strict JSON consumers) replaced, length-capped."""
    s = str(value)
    if not s.isprintable():
        s = "".join(
            ch if (ch.isprintable() or ch == " ") else "\\u%04x" % ord(ch)
            for ch in s
        )
    if len(s) > _MAX_ATTR_CHARS:
        s = s[:_MAX_ATTR_CHARS] + "..."
    return s


@dataclass
class Span:
    name: str
    start_us: float
    duration_us: float
    thread: int
    attrs: dict[str, Any] = field(default_factory=dict)


class Tracer:
    def __init__(self, capacity: int = 8192, process_name: str = "tpu-operator"):
        self._spans: deque[Span] = deque(maxlen=max(0, capacity))
        self._lock = threading.Lock()
        # The monotonic epoch and its wall-clock twin are captured
        # back-to-back: ts values are monotonic-relative (immune to
        # clock steps), epochUnixUs lets a merger rebase rings from
        # different processes onto one timeline.
        self._epoch = time.monotonic()
        self._epoch_unix = time.time()
        self.process_name = process_name
        self.enabled = capacity > 0
        self.dropped = 0

    @property
    def capacity(self) -> int:
        # lint: ok guarded-attr — atomic deque-reference read; maxlen is immutable per deque
        return self._spans.maxlen or 0

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring (newest spans kept). 0 disables tracing —
        the span/record fast path becomes one attribute read."""
        with self._lock:
            if capacity <= 0:
                self.enabled = False
                self._spans = deque(maxlen=0)
            else:
                self.enabled = True
                self._spans = deque(self._spans, maxlen=capacity)

    def _append(self, s: Span) -> None:
        with self._lock:
            if (self._spans.maxlen is not None
                    and len(self._spans) == self._spans.maxlen):
                # deque(maxlen) evicts silently; the counter makes the
                # wrap observable ("the trace starts mid-story HERE").
                self.dropped += 1
                TRACE_SPANS_DROPPED.inc(tracer=self.process_name)
            self._spans.append(s)

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        # lint: ok guarded-attr — hot-path volatile flag; set_capacity flips it under the GIL, a stale read mistraces one span
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            self._append(Span(
                name=name,
                start_us=(t0 - self._epoch) * 1e6,
                duration_us=(t1 - t0) * 1e6,
                thread=threading.get_ident() % 2**31,
                attrs=attrs,
            ))

    def record(self, name: str, start_mono: float, end_mono: float,
               **attrs: Any) -> None:
        """Record a span from explicit ``time.monotonic()`` stamps — for
        phases measured across threads or assembled after the fact
        (queue wait from the enqueue stamp, decode intervals aggregated
        over many steps)."""
        # lint: ok guarded-attr — hot-path volatile flag, same contract as span() above
        if not self.enabled:
            return
        self._append(Span(
            name=name,
            start_us=(start_mono - self._epoch) * 1e6,
            duration_us=max(0.0, (end_mono - start_mono)) * 1e6,
            thread=threading.get_ident() % 2**31,
            attrs=attrs,
        ))

    def size(self) -> int:
        """Current ring depth — O(1), unlike ``len(spans())`` which
        copies the whole ring (debug snapshots poll this)."""
        with self._lock:
            return len(self._spans)

    def spans(self, name: str | None = None) -> list[Span]:
        with self._lock:
            snap = list(self._spans)
        return [s for s in snap if name is None or s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def export_doc(self) -> dict[str, Any]:
        """The catapult document as a dict: ``traceEvents`` plus the
        merge metadata (``epochUnixUs``, ``droppedSpans``, ``process``).
        Extra top-level keys are legal in the Chrome trace JSON object
        format and ignored by viewers."""
        events: list[dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "args": {"name": self.process_name},
            }
        ]
        # one locked read: the span snapshot and the dropped counter
        # describe the same instant (a racy ``dropped`` read could claim
        # a wrap the exported events don't show)
        with self._lock:
            snap = list(self._spans)
            dropped = self.dropped
        for s in snap:
            events.append(
                {
                    "name": s.name,
                    "ph": "X",  # complete event
                    "pid": 1,
                    "tid": s.thread,
                    "ts": round(s.start_us, 3),
                    "dur": round(s.duration_us, 3),
                    "args": {
                        k: _sanitize_attr(v) for k, v in s.attrs.items()
                    },
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "epochUnixUs": round(self._epoch_unix * 1e6, 1),
            "droppedSpans": dropped,
            "process": self.process_name,
        }

    def export_chrome_trace(self) -> str:
        """Catapult JSON: load at chrome://tracing or ui.perfetto.dev."""
        return json.dumps(self.export_doc())


def mint_request_id() -> str:
    """A fleet-unique request id (16 hex chars) — minted at the FIRST
    hop that sees a request (fleet router, replica server, serve_lm
    handler, or the scheduler itself) unless the client supplied one
    (``X-Request-Id`` header / ``request_id`` body field). Every span a
    request generates anywhere in the fleet carries it as the
    ``request_id`` arg; a fleet trace merge keys on it."""
    return uuid.uuid4().hex[:16]


# The serving data plane's ring: request-scoped spans (queue wait,
# admission, prefill chunks, CoW copies, decode intervals, watchdog
# restarts, drain) recorded by serve/scheduler.py + serve/engine.py and
# exported at /debug/traces. Process-global so supervisor engine rebuilds
# carry the ring across generations.
SERVE_TRACER = Tracer(process_name="tpu-serve")
