"""The serving front's HTTP helpers: the handler base, the /healthz
latency windows and the readiness payload.

Counterpart of ``tf_operator_tpu/serve/httpapi.py``'s ``QuietHandler``,
``_QuantileWindow`` and ``readiness_payload``, over the port's metrics
registry and trace ring. The JAX module's ``mount_serve`` (the
/debug/serve handler mounted on the operator's ApiServer) is
control-plane glue the port does not carry: the port's server
(``serve/serve_lm.py``) serves /debug/serve itself, in the same shape,
from either engine layout.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any


class QuietHandler(BaseHTTPRequestHandler):
    """Shared stdlib-handler base for the serving HTTP fronts (replica
    server, fleet router): suppressed request logging plus the one JSON /
    metrics response shape — the Retry-After rule and the Prometheus
    content type must not drift between surfaces."""

    def log_message(self, *args: Any) -> None:  # quiet
        pass

    def send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if payload.get("retry_after_s") is not None:
            self.send_header("Retry-After", str(
                max(1, int(round(payload["retry_after_s"])))
            ))
        self.end_headers()
        self.wfile.write(body)

    def send_metrics(self) -> None:
        from tf_operator_tpu_torch.runtime.metrics import REGISTRY

        body = REGISTRY.render().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def send_serve_traces(self) -> None:
        """The serving data plane's /debug/traces: the SERVE_TRACER ring
        as one catapult document (load at ui.perfetto.dev; the fleet
        router and ``tpuctl trace`` merge several of these by
        ``epochUnixUs`` + the request_id span attribute)."""
        from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER

        self.send_json(200, SERVE_TRACER.export_doc())

    def read_json_body(self) -> dict:
        """Parse the POST body; raises ValueError on bad JSON."""
        raw = self.rfile.read(
            int(self.headers["Content-Length"] or 0)
        ) or b"{}"
        return json.loads(raw)

# /healthz latency windows: the metrics registry is process-global, so a
# lifetime quantile would latch a cold-start compile burst into the
# reported p99 ~forever — and the fleet autoscaler's latency triggers
# (which require the trigger quiet before scaling down) would pin the
# fleet at max. Rotating two snapshots bounds the read to roughly the
# last 1-2 windows. One instance per histogram the probe payload
# reports: TTFT and ITL (the decode pool's disaggregation-era
# scale signal).
_TTFT_WINDOW_S = 120.0


class _QuantileWindow:
    """p99 of a registry histogram over the trailing 1-2 windows, not
    process lifetime. Clamped to the histogram's top bucket bound: when
    the p99 lands in the +Inf overflow bucket the true value is unknown
    but AT LEAST the top bound — reporting that keeps the autoscaler's
    latency trigger live during the worst episodes instead of going
    silent (a dropped reading leaves membership holding a stale
    pre-overload p99, which can even permit scale-down mid-incident)."""

    def __init__(self, hist_name: str,
                 window_s: float = _TTFT_WINDOW_S) -> None:
        self._hist_name = hist_name
        self.window_s = window_s
        self._lock = threading.Lock()
        self._prev: list[int] | None = None
        self._cur: tuple[list[int], float] | None = None

    def _hist(self):
        from tf_operator_tpu_torch.runtime import metrics

        return getattr(metrics, self._hist_name)

    def p99(self) -> float:
        hist = self._hist()
        now = time.monotonic()
        with self._lock:
            if self._cur is None or now - self._cur[1] >= self.window_s:
                self._prev = self._cur[0] if self._cur else None
                self._cur = (hist.snapshot(), now)
            since = self._prev
        return min(hist.quantile(0.99, since=since), hist.buckets[-1])


_TTFT_WINDOW = _QuantileWindow("SERVE_TTFT_SECONDS")
_ITL_WINDOW = _QuantileWindow("SERVE_ITL_SECONDS")


def windowed_ttft_p99() -> float:
    """p99 TTFT over the trailing 1-2 windows (see _QuantileWindow)."""
    return _TTFT_WINDOW.p99()


def windowed_itl_p99() -> float:
    """p99 inter-token latency over the trailing 1-2 windows — the
    decode pool's autoscale latency signal (prefill interference and
    overload both show up here first for streaming clients)."""
    return _ITL_WINDOW.p99()


def readiness_payload(sched: Any, *, draining: bool = False,
                      replica: str = "", max_slots: int | None = None,
                      role: str = "") -> dict[str, Any]:
    """The /healthz shape fleet/membership.py routes from — liveness and
    readiness split explicitly:

    - ``ok`` is LIVENESS: the process answers and its engine is not
      declared dead. It stays true through a drain.
    - ``draining: true`` is the readiness withdrawal: the SIGTERM
      bounded drain is in flight — admitted requests are finishing, new
      ones must go elsewhere. A router deregisters on this flag BEFORE
      the drain completes instead of eating drain-window 503s.
    - ``dead: true`` (ok false): the restart budget is spent; the
      replica wants replacing, not retrying.

    ``sched`` is an EngineSupervisor / ContinuousScheduler-shaped object
    (duck-typed: active_slots, queue_depth, requests_done,
    tokens_generated, restarts, dead) or None; occupancy/queue numbers
    plus TTFT p99 ride along for the router's least-loaded pick and the
    autoscaler's triggers. serve_lm and fleet/replica.py both emit this
    one shape.
    """
    payload: dict[str, Any] = {"ok": True}
    if replica:
        payload["replica"] = replica
    if role:
        # Disaggregated fleets route by pool: "prefill" replicas take
        # only /prefill work, "decode" (or unset) the /generate path.
        payload["role"] = role
    if draining:
        payload["draining"] = True
    if sched is None:
        return payload
    payload["active_slots"] = sched.active_slots
    payload["queue_depth"] = sched.queue_depth
    if max_slots is not None:
        payload["max_slots"] = max_slots
    mesh_devices = getattr(sched, "mesh_devices", None)
    if mesh_devices is not None:
        # SPMD decode width: a tp-wide replica is one probe target but
        # many chips — the router's least-loaded pick and the
        # autoscaler's capacity math can see it.
        payload["mesh_devices"] = int(mesh_devices)
    mesh_axes = getattr(sched, "mesh_axes", None)
    if mesh_axes is not None:
        # Pod SHAPE, not just width: tp=2,dp=2 and tp=4 are both 4
        # chips but a dp shard multiplies slot capacity, not per-slot
        # speed — capacity math needs the split.
        payload["mesh_axes"] = dict(mesh_axes)
    payload["requests_done"] = sched.requests_done
    payload["tokens_generated"] = sched.tokens_generated
    payload["watchdog_restarts"] = getattr(sched, "restarts", 0)
    adv = getattr(sched, "advertised_prefixes", None)
    if adv is not None:
        # Fleet-global prefix reuse: the replica's hot prefix digest
        # chain (hex, MRU first, capped engine-side). Omitted when
        # empty — membership's clear-on-absent keeps a replica that
        # freed everything from advertising ghosts.
        prefixes = adv()
        if prefixes:
            payload["prefixes"] = list(prefixes)
    tadv = getattr(sched, "advertised_tier_prefixes", None)
    if tadv is not None:
        # KV memory hierarchy (serve/tier.py): the warm host-tier
        # digests alongside the hot HBM ones — the router scores these
        # as DISCOUNTED hits (restorable, not live) and peers can pull
        # them through the same /prefix/<digest> endpoint. Same
        # omit-when-empty / clear-on-absent contract.
        tier_prefixes = tadv()
        if tier_prefixes:
            payload["tier_prefixes"] = list(tier_prefixes)
    ttft_p99 = windowed_ttft_p99()
    if ttft_p99:
        payload["ttft_p99_s"] = round(ttft_p99, 4)
    itl_p99 = windowed_itl_p99()
    if itl_p99:
        # The decode pool's autoscale latency signal (absent while the
        # window is idle, same clear-on-idle contract as TTFT).
        payload["itl_p99_s"] = round(itl_p99, 4)
    if getattr(sched, "dead", False):
        payload["ok"] = False
        payload["dead"] = True
    return payload
