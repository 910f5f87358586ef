"""The port's serving resilience (tf_operator_tpu_torch/serve/
resilience.py and scheduler.py) under tests/test_serve_chaos.py's faults,
held against the JAX package's.

- Stub tier: tests/test_serve_chaos.py's FakeEngine (numpy only) under
  each package's supervisor. Queue TTL -> 408, shedding -> 503 with
  Retry-After, a spent restart budget -> replica_dead and an unsupervised
  crash -> engine_crashed give the same typed payload and status in both
  packages; a decode deadline resolves with the partial output and the
  flag, degraded mode caps the admitted steps, the drain timeout bounds
  shutdown with partials.
- Real tier: the port's ContinuousEngine (f32, CPU, the JAX init weights)
  under the port's supervisor: a greedy and a sampled request cross an
  injected step crash, and a greedy one an injected stall the watchdog
  fences; the replays give JAX's solo generate tokens bit for bit.

Limits sit far above what the path takes on the CPU (queue TTL and
deadlines 0.5 s against ~10 ms stub steps, the watchdog 2.5 s against
~5 ms engine steps), and no assertion reads the wall clock."""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    generate,
)
from tf_operator_tpu.serve import faultinject as jax_faults
from tf_operator_tpu.serve import resilience as jax_res
from tf_operator_tpu.serve import scheduler as jax_sched
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.serve import faultinject, resilience, scheduler
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from test_serve_chaos import FakeEngine, fake_want

torch.set_num_threads(1)

JAX = types.SimpleNamespace(res=jax_res, faults=jax_faults,
                            sched=jax_sched)
PORT = types.SimpleNamespace(res=resilience, faults=faultinject,
                             sched=scheduler)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (1, n)).astype(
        np.int32)


def make_supervisor(pkg, res_kw, *, faults="", step_sleep=0.0,
                    max_slots=2, engines=None):
    inj = pkg.faults.FaultInjector(faults)

    def factory():
        eng = FakeEngine(max_slots=max_slots, step_sleep=step_sleep,
                         faults=inj)
        if engines is not None:
            engines.append(eng)
        return eng

    return pkg.res.EngineSupervisor(
        factory, resilience=pkg.res.ResilienceConfig(**res_kw), faults=inj)


def wait_for(cond, what: str, timeout: float = 60.0) -> None:
    """Poll ``cond`` until it holds; the limit only bounds a hang."""
    limit = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < limit, what
        time.sleep(0.005)


def typed(exc, pkg) -> tuple:
    pl = pkg.res.error_payload(exc)
    return (type(exc).__name__, pl["code"], pl["retryable"],
            pl.get("retry_after_s"), pkg.res.http_status_of(exc))


def hog(sup, steps):
    t = threading.Thread(target=lambda: sup.submit(_prompt(4), steps,
                                                   timeout=120),
                         daemon=True)
    t.start()
    wait_for(lambda: sup.engine.active_slots >= 1, "hog never admitted")
    return t


def queue_ttl_case(pkg):
    # The drain timeout only ends the hog quickly at stop().
    sup = make_supervisor(pkg, dict(queue_ttl_s=0.5, drain_timeout_s=0.05),
                          step_sleep=0.01, max_slots=1)
    try:
        hog(sup, 5000)
        with pytest.raises(pkg.res.QueueTTLExpired) as ei:
            sup.submit(_prompt(3), 4, timeout=120)
        return typed(ei.value, pkg)
    finally:
        sup.stop(timeout=60)


def shed_case(pkg):
    sup = make_supervisor(pkg, dict(queue_limit=1, drain_timeout_s=0.05),
                          step_sleep=0.01, max_slots=1)
    try:
        hog(sup, 5000)
        queued = pkg.sched.ServeRequest(_prompt(4), 4)
        sup.scheduler.enqueue(queued)  # fills the 1-deep queue
        with pytest.raises(pkg.res.QueueFull) as ei:
            sup.submit(_prompt(3), 4, timeout=120)  # reject-NEWEST
        assert sup.scheduler.queue_high_water >= 1
        return typed(ei.value, pkg)
    finally:
        sup.stop(timeout=60)


def dead_case(pkg):
    sup = make_supervisor(pkg, dict(restart_backoff_s=0.01, max_restarts=2),
                          faults="step_raise%1.0")
    try:
        with pytest.raises(pkg.res.ReplicaDead) as ei:
            sup.submit(_prompt(4), 4, timeout=120)
        assert sup.dead and sup.restarts == 3
        with pytest.raises(pkg.res.ReplicaDead):
            sup.submit(_prompt(4), 4, timeout=30)
        assert sup.debug_snapshot()["resilience"]["dead"] is True
        return typed(ei.value, pkg)
    finally:
        sup.stop(timeout=30)


def crash_case(pkg):
    sched = pkg.sched.ContinuousScheduler(FakeEngine(
        faults=pkg.faults.FaultInjector("step_raise@2"))).start()
    try:
        with pytest.raises(pkg.res.EngineCrashed) as ei:
            sched.submit(_prompt(4), 8, timeout=120)
        return typed(ei.value, pkg)
    finally:
        sched.stop(timeout=30)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("case,want", [
    (queue_ttl_case, ("QueueTTLExpired", "queue_ttl_expired", True, 0.5,
                      408)),
    (shed_case, ("QueueFull", "queue_full", True, 1.0, 503)),
    (dead_case, ("ReplicaDead", "replica_dead", True, None, 503)),
    (crash_case, ("EngineCrashed", "engine_crashed", True, None, 503)),
], ids=["queue_ttl", "shed", "replica_dead", "unsupervised_crash"])
def test_fault_paths_typed_as_jax(case, want):
    """Each fault path ends in the same typed error, payload and status
    in the port as in the JAX package."""
    assert case(PORT) == case(JAX) == want


def test_decode_deadline_returns_partial_with_flag():
    before = metrics.SERVE_DEADLINE_TOTAL.value(kind="decode")
    sup = make_supervisor(PORT, dict(decode_deadline_s=60.0),
                          step_sleep=0.01)
    try:
        req = sup.submit_request(
            scheduler.ServeRequest(_prompt(5), 5000, deadline_s=0.5),
            timeout=120)
        assert req.deadline_exceeded
        assert req.timeout_cause == "decode_deadline"
        assert 0 < len(req.out) < 5000 and req.finish_reason is None
        assert req.out == fake_want(_prompt(5), len(req.out))
        assert metrics.SERVE_DEADLINE_TOTAL.value(
            kind="decode") >= before + 1
    finally:
        sup.stop(timeout=30)


def test_degraded_mode_caps_admitted_tokens():
    sup = make_supervisor(PORT, dict(degraded_free_block_frac=0.2,
                                     degraded_max_tokens=4))
    try:
        sup.engine.free_block_fraction = 0.05
        req = sup.submit_request(scheduler.ServeRequest(_prompt(4), 20),
                                 timeout=60)
        assert req.degraded and req.requested_steps == 20
        assert len(req.out) == 4
        assert metrics.SERVE_DEGRADED.value() == 1
        sup.engine.free_block_fraction = 1.0
        req2 = sup.submit_request(scheduler.ServeRequest(_prompt(4), 20),
                                  timeout=60)
        assert not req2.degraded and len(req2.out) == 20
        assert metrics.SERVE_DEGRADED.value() == 0
    finally:
        sup.stop(timeout=30)


def test_drain_timeout_bounds_shutdown_with_partials():
    before = metrics.SERVE_DEADLINE_TOTAL.value(kind="drain")
    sup = make_supervisor(PORT, dict(drain_timeout_s=0.5), step_sleep=0.01)
    holder = {}

    def client():
        holder["req"] = sup.submit_request(
            scheduler.ServeRequest(_prompt(4), 50000), timeout=120)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    wait_for(lambda: sup.engine.active_slots >= 1, "never admitted")
    sup.stop(timeout=120)
    t.join(timeout=60)
    req = holder["req"]
    assert req.deadline_exceeded and req.timeout_cause == "drain_timeout"
    assert 0 < len(req.out) < 50000
    assert req.out == fake_want(_prompt(4), len(req.out))
    assert metrics.SERVE_DEADLINE_TOTAL.value(kind="drain") >= before + 1


def test_restart_attempts_reset_after_served_request():
    sup = make_supervisor(PORT, dict(watchdog_stall_s=2.5,
                                     restart_backoff_s=0.01,
                                     max_restarts=2),
                          faults="step_raise@2")
    try:
        out = sup.submit(_prompt(4), 6, timeout=120)
        assert out.tolist() == [fake_want(_prompt(4), 6)]
        assert sup.restarts == 1
        wait_for(lambda: not sup._attempts, "budget never reset")
        assert not sup.dead
    finally:
        sup.stop(timeout=30)


# -- real tier ---------------------------------------------------------------

STEPS = 10
JCFG = JaxConfig(vocab_size=32, d_model=16, n_layers=1, n_heads=2, d_ff=32,
                 max_seq_len=64, dtype=jnp.float32)
TCFG = TransformerConfig(vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                         d_ff=32, max_seq_len=64, dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    params = JaxTransformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    prompt = np.random.default_rng(2).integers(0, 32, (1, 9)).astype(
        np.int32)
    greedy = np.asarray(generate(JCFG, params, jnp.asarray(prompt), STEPS))
    sampled = np.asarray(generate(
        JCFG, params, jnp.asarray(prompt), STEPS, temperature=0.8,
        top_p=0.9, rng=jax.random.PRNGKey(11)))
    return jax.tree.map(np.asarray, params), prompt, greedy, sampled


def real_supervisor(params, spec):
    inj = faultinject.FaultInjector(spec, seed=3)
    engines = []

    def factory():
        eng = ContinuousEngine(TCFG, params, 2, kv_block=8, prefill_chunk=4,
                               faults=inj, device="cpu")
        eng.warmup()
        engines.append(eng)
        return eng

    sup = resilience.EngineSupervisor(
        factory, resilience=resilience.ResilienceConfig(
            watchdog_stall_s=2.5, restart_backoff_s=0.05, max_restarts=3),
        faults=inj, prefill_tokens_per_step=8)
    return sup, engines


def test_crash_replay_bit_identical_to_jax_generate(model):
    """A greedy and a sampled request cross an injected step crash; the
    rebuilt engine replays both to JAX's solo generate tokens."""
    params, prompt, greedy, sampled = model
    restarts0 = metrics.SERVE_WATCHDOG_RESTARTS.value(reason="crash")
    sup, engines = real_supervisor(params, "step_raise@5")
    try:
        outs = {}

        def client(key, **kw):
            outs[key] = sup.submit(prompt, STEPS, timeout=120, **kw)

        ths = [threading.Thread(target=client, args=("greedy",),
                                daemon=True),
               threading.Thread(target=client, args=("sampled",),
                                kwargs=dict(temperature=0.8, top_p=0.9,
                                            seed=11), daemon=True)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert sup.restarts == 1 and len(engines) == 2
        np.testing.assert_array_equal(outs["greedy"], greedy)
        np.testing.assert_array_equal(outs["sampled"], sampled)
        assert metrics.SERVE_WATCHDOG_RESTARTS.value(
            reason="crash") == restarts0 + 1
        assert sup.debug_snapshot()["resilience"]["last_fault"]
    finally:
        sup.stop(timeout=60)


def test_stall_replay_bit_identical_to_jax_generate(model):
    """An injected 8 s stall of the third step outlasts the 2.5 s
    watchdog: the stalled generation is fenced (its thread wakes later
    and dies without touching the request) and the replay on a fresh
    engine gives JAX's solo generate tokens."""
    params, prompt, greedy, _ = model
    restarts0 = metrics.SERVE_WATCHDOG_RESTARTS.value(reason="stall")
    sup, engines = real_supervisor(params, "step_stall@3:8.0")
    try:
        out = sup.submit(prompt, STEPS, timeout=120)
        np.testing.assert_array_equal(out, greedy)
        assert sup.restarts == 1 and len(engines) == 2
        assert metrics.SERVE_WATCHDOG_RESTARTS.value(
            reason="stall") == restarts0 + 1
    finally:
        sup.stop(timeout=60)
