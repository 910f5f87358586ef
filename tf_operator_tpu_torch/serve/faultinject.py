"""Deterministic, seeded fault injection for the serving stack.

A whole copy of ``tf_operator_tpu/serve/faultinject.py`` (numpy only), so
the same spec string and seed fire at the same call counts in the port as
in the JAX package.

Chaos testing a serving engine is only useful when the faults are
REPRODUCIBLE: a flaky failure that cannot be replayed teaches nothing.
Every fault here is therefore either positional (fire at the N-th
invocation of a named fault point — the same schedule every run) or
probabilistic under a seeded per-point rng (the same coin flips every
run for a given seed). The injector is passive: production code calls
``fire(point)`` at each fault point and the injector decides; with no
spec armed every call is a counter bump on an always-``None`` path, so
the hooks cost nothing in real serving.

Fault points (the names are the public contract — specs, tests,
serve_bench's chaos mix, and /debug/serve all use them):

- ``step_raise``   — the decode step raises ``InjectedFault`` (the
  engine-crash path: the serving loop dies mid-decode).
- ``step_stall``   — the decode step blocks for ``arg`` seconds before
  running (the wedged-step path the watchdog must catch).
- ``alloc_exhaust`` — ``plan_admission`` reports no capacity (block/
  slot-pool exhaustion without having to actually fill the pool).
- ``slow_prefill`` — each prefill slice sleeps ``arg`` seconds first
  (TTFT/queue pressure; exercises queue TTLs under load).
- ``ack_loss``     — the serving loop's heartbeat write is dropped (the
  false-positive stall: the watchdog fires on a HEALTHY engine, so
  restart + replay must be loss-free even when nothing was wrong).

Spec grammar (``TPU_SERVE_FAULTS`` env var or serve_lm ``--faults``)::

    spec  := entry ("," entry)*
    entry := point "@" HIT ["x" COUNT] [":" ARG]   # positional
           | point "%" PROB [":" ARG]              # probabilistic

``point@12`` fires at the 12th invocation of that point (1-based), once;
``x3`` extends to the 12th..14th; ``:0.5`` attaches a float argument
(stall/sleep seconds). ``point%0.05:0.01`` fires each invocation with
seeded probability 5%. Multiple entries for one point all apply.

One injector instance is shared by the engine, the scheduler, and the
supervisor — invocation counters persist across watchdog engine
rebuilds, so ``step_raise@40x999`` keeps crashing every rebuilt engine
(the bounded-restart / replica-dead path) while ``step_raise@40`` crashes
exactly one.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass

import numpy as np

FAULT_POINTS = frozenset({
    "step_raise", "step_stall", "alloc_exhaust", "slow_prefill", "ack_loss",
})

ENV_SPEC = "TPU_SERVE_FAULTS"
ENV_SEED = "TPU_SERVE_FAULT_SEED"


class InjectedFault(RuntimeError):
    """Raised by a triggered ``step_raise`` (and available to tests as
    the marker type proving a failure came from the injector, not a real
    bug)."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault: {point}")
        self.point = point


@dataclass
class _Arm:
    """One armed spec entry. Positional: fire while ``hit <= invocation
    < hit + count``. Probabilistic: fire on each invocation whose seeded
    draw lands under ``prob``."""

    point: str
    hit: int | None = None
    count: int = 1
    prob: float | None = None
    arg: float | None = None
    fired: int = 0

    def wants(self, invocation: int, rng: np.random.Generator) -> bool:
        if self.hit is not None:
            return self.hit <= invocation < self.hit + self.count
        return float(rng.random()) < float(self.prob or 0.0)


def _parse_entry(raw: str) -> _Arm:
    entry = raw.strip()
    arg = None
    if ":" in entry:
        entry, argtxt = entry.split(":", 1)
        arg = float(argtxt)
    if "@" in entry:
        point, postxt = entry.split("@", 1)
        count = 1
        if "x" in postxt:
            postxt, counttxt = postxt.split("x", 1)
            count = int(counttxt)
        hit = int(postxt)
        if hit < 1 or count < 1:
            raise ValueError(f"fault entry {raw!r}: hit/count must be >= 1")
        armed = _Arm(point.strip(), hit=hit, count=count, arg=arg)
    elif "%" in entry:
        point, probtxt = entry.split("%", 1)
        prob = float(probtxt)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault entry {raw!r}: prob must be in [0, 1]")
        armed = _Arm(point.strip(), prob=prob, arg=arg)
    else:
        raise ValueError(
            f"fault entry {raw!r}: expected point@hit[xN][:arg] or "
            f"point%prob[:arg]"
        )
    if armed.point not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {armed.point!r} (have "
            f"{sorted(FAULT_POINTS)})"
        )
    return armed


class FaultInjector:
    """Seeded fault-point registry. Thread-safe (the serving loop, HTTP
    handler threads, and the watchdog all pass through it); ``arm`` may
    be called on a live injector (tests re-arm between chaos phases)."""

    def __init__(self, spec: str = "", seed: int = 0) -> None:
        self._lock = threading.Lock()
        self.seed = int(seed)
        self._arms: list[_Arm] = []
        self.invocations: dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self.fired: dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self.last_fired: tuple[str, int] | None = None
        # Per-point rng streams: probabilistic determinism must not
        # depend on how OTHER points' invocations interleave.
        self._rngs = {
            p: np.random.default_rng([self.seed, zlib.crc32(p.encode())])
            for p in FAULT_POINTS
        }
        if spec:
            self.arm(spec)

    @classmethod
    def from_env(cls, env=None) -> "FaultInjector":
        env = os.environ if env is None else env
        return cls(env.get(ENV_SPEC, ""), seed=int(env.get(ENV_SEED, "0")))

    @property
    def enabled(self) -> bool:
        with self._lock:
            return bool(self._arms)

    def arm(self, spec: str) -> "FaultInjector":
        """Parse and ADD entries (existing arms and counters persist)."""
        arms = [_parse_entry(e) for e in spec.split(",") if e.strip()]
        with self._lock:
            self._arms.extend(arms)
        return self

    def disarm(self, point: str | None = None) -> None:
        """Drop armed entries (all, or one point's). Invocation counters
        keep counting — they are history, not configuration."""
        with self._lock:
            self._arms = [
                a for a in self._arms
                if point is not None and a.point != point
            ]

    # -- the hook -----------------------------------------------------------

    def fire(self, point: str) -> float | None:
        """Count one invocation of ``point``; return the triggering
        entry's arg (0.0 if it carried none) when a fault fires, else
        None. THE single decision function — every fault-point hook is
        a ``fire`` call plus the point-specific behavior."""
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        with self._lock:
            self.invocations[point] += 1
            n = self.invocations[point]
            for a in self._arms:
                if a.point == point and a.wants(n, self._rngs[point]):
                    a.fired += 1
                    self.fired[point] += 1
                    self.last_fired = (point, n)
                    return a.arg if a.arg is not None else 0.0
        return None

    def maybe_raise(self, point: str) -> None:
        if self.fire(point) is not None:
            raise InjectedFault(point)

    def maybe_sleep(self, point: str, default: float = 0.05) -> bool:
        arg = self.fire(point)
        if arg is None:
            return False
        time.sleep(arg or default)
        return True

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/serve ``faults`` payload."""
        with self._lock:
            return {
                "armed": [
                    {"point": a.point, "hit": a.hit, "count": a.count,
                     "prob": a.prob, "arg": a.arg, "fired": a.fired}
                    for a in self._arms
                ],
                "seed": self.seed,
                "invocations": {k: v for k, v in self.invocations.items()
                                if v},
                "fired": {k: v for k, v in self.fired.items() if v},
                "last_fired": list(self.last_fired)
                if self.last_fired else None,
            }


#: Shared disabled instance: the default ``faults`` everywhere, so the
#: hooks in the hot path are one attribute read + a short locked counter
#: bump and never allocate.
NULL_INJECTOR = FaultInjector()
