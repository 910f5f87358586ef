"""The port's serving front (tf_operator_tpu_torch/serve/: scheduler,
resilience, faultinject, httpapi, runtime/metrics and runtime/tracing)
held against the JAX front on the CPU in f32, with the JAX init weights
in both packages (passed through numpy).

- tests/test_serve_sched.py's threaded mixed traffic (greedy and sampled,
  chunked prefill) through JAX's ContinuousScheduler and the port's: the
  same tokens request by request; its eos, drain and eager-validation
  tests as twins over the port.
- The shapes: debug_snapshot(), readiness_payload() and the /metrics
  families have the JAX front's keys, less those of the items the port
  has not ported (listed here); each ServeError renders the same payload
  and status; a FaultInjector spec and seed fire at the same calls.
- The engine's serving hooks: faults placed as in the JAX engine, the
  slot tag on the CoW span, mesh_info, the compile counters, warmup.

No assertion reads the wall clock: threads meet on events and on
await_request with generous timeouts."""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import Transformer as JaxTransformer
from tf_operator_tpu.runtime import metrics as jax_metrics
from tf_operator_tpu.serve import faultinject as jax_faults
from tf_operator_tpu.serve import httpapi as jax_httpapi
from tf_operator_tpu.serve import resilience as jax_res
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu.serve.scheduler import (
    ContinuousScheduler as JaxScheduler,
)
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER
from tf_operator_tpu_torch.serve import faultinject, httpapi, resilience
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
    ShuttingDown,
)
from test_serve_sched import CFG, prompt_of, solo

torch.set_num_threads(1)

TCFG = TransformerConfig(
    dtype=torch.float32, **{k: getattr(CFG, k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
        "max_seq_len")})
# test_serve_sched.py::test_threaded_mixed_traffic_bit_exact's requests:
# (prompt, steps, temperature, top_p, seed).
MIXED = [
    (prompt_of(4, 1), 8, 0.0, None, 0),
    (prompt_of(7, 2), 6, 0.0, None, 0),
    (prompt_of(3, 3), 10, 0.9, None, 11),
    (prompt_of(5, 4), 5, 0.7, 0.8, 7),
    (prompt_of(9, 5), 4, 0.0, None, 0),
    (prompt_of(6, 6), 12, 0.0, None, 0),
]
# What the JAX front shows and the port leaves out with the items that
# bring it: nothing since KV shipments, prefix export, retention and the
# host tier were ported.
UNPORTED_KV_KEYS: set = set()
UNPORTED_FAMILIES: set = set()


@pytest.fixture(scope="module")
def params():
    return JaxTransformer(CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def port_engine(params, slots, **kw) -> ContinuousEngine:
    return ContinuousEngine(TCFG, jax.tree.map(np.asarray, params), slots,
                            kv_block=8, device="cpu", **kw)


def run_threaded(sched, reqs) -> dict:
    out: dict = {}

    def client(i):
        prompt, steps, t, tp, seed = reqs[i]
        out[i] = sched.submit(prompt, steps, temperature=t, top_p=tp,
                              seed=seed, timeout=300)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def test_threaded_mixed_traffic_matches_jax_scheduler(params):
    """The six concurrent requests (chunked prefill interleaved with
    decode) through both schedulers give the same tokens request by
    request, which are solo generate's; the port's counters advance by
    the served amounts."""
    ok0 = metrics.SERVE_REQUESTS_TOTAL.value(outcome="ok")
    tok0 = metrics.SERVE_TOKENS_TOTAL.value()
    ttft0 = metrics.SERVE_TTFT_SECONDS.snapshot()
    jsched = JaxScheduler(JaxEngine(CFG, params, max_slots=4,
                                    prefill_chunk=4),
                          prefill_tokens_per_step=8).start()
    try:
        want = run_threaded(jsched, MIXED)
    finally:
        jsched.stop(timeout=60)
    sched = ContinuousScheduler(port_engine(params, 4, prefill_chunk=4),
                                prefill_tokens_per_step=8).start()
    try:
        got = run_threaded(sched, MIXED)
        assert 0.0 < sched.mean_occupancy <= 1.0
    finally:
        sched.stop(timeout=60)
    for i, (prompt, steps, t, tp, seed) in enumerate(MIXED):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_array_equal(
            got[i], solo(params, prompt, steps, temperature=t, top_p=tp,
                         seed=seed), err_msg=f"req {i} vs solo")
    assert metrics.SERVE_REQUESTS_TOTAL.value(outcome="ok") == ok0 + 6
    assert metrics.SERVE_TOKENS_TOTAL.value() == tok0 + sum(
        r[1] for r in MIXED)
    ttft = metrics.SERVE_TTFT_SECONDS.snapshot()
    assert sum(c - b for c, b in zip(ttft, ttft0)) == len(MIXED)


def test_eos_retires_slot_early(params):
    """Twin of test_serve_sched.py's: the request stops at its eos token
    (inclusive) and frees the single slot for the next one."""
    sched = ContinuousScheduler(port_engine(params, 1)).start()
    try:
        prompt = prompt_of(5, 42)
        want = solo(params, prompt, 10)[0]
        eos = int(want[3])
        req = sched.submit_request(ServeRequest(prompt, 10, eos_id=eos),
                                   timeout=120)
        k = list(want).index(eos)
        np.testing.assert_array_equal(req.out, want[:k + 1])
        assert req.finish_reason == "eos"
        np.testing.assert_array_equal(sched.submit(prompt, 4)[0],
                                      want[:4])
    finally:
        sched.stop(timeout=30)


def test_drain_finishes_inflight_rejects_queued(params):
    """Twin of test_serve_sched.py's drain: the admitted request finishes
    its full decode, the queued one fails with ShuttingDown, later
    submits are refused. The first decode step waits until the second
    request is queued and the drain has begun, so the order is fixed."""
    rejected0 = metrics.SERVE_REQUESTS_TOTAL.value(outcome="rejected")
    engine = port_engine(params, 1)
    sched = ContinuousScheduler(engine).start()
    stepping, proceed = threading.Event(), threading.Event()
    real_step = engine.step

    def step():
        stepping.set()
        assert proceed.wait(timeout=120)
        return real_step()

    engine.step = step
    first = ServeRequest(prompt_of(4, 1), 40)
    sched.enqueue(first)
    assert stepping.wait(timeout=120)
    queued = ServeRequest(prompt_of(4, 2), 4)
    sched.enqueue(queued)
    stopper = threading.Thread(target=sched.stop, kwargs={"timeout": 120})
    stopper.start()
    while not sched.debug_snapshot()["draining"]:
        stopper.join(timeout=0.01)
    proceed.set()
    stopper.join(timeout=120)
    assert queued.event.wait(timeout=60) and first.event.wait(timeout=60)
    assert isinstance(queued.error, ShuttingDown)
    with pytest.raises(ShuttingDown):
        sched.submit(prompt_of(4, 3), 2)
    np.testing.assert_array_equal([first.out],
                                  solo(params, prompt_of(4, 1), 40))
    assert metrics.SERVE_REQUESTS_TOTAL.value(
        outcome="rejected") >= rejected0 + 1


def fake_engine(**kw):
    """The engine surface the schedulers' enqueue reads (no device)."""
    return types.SimpleNamespace(max_slots=1, logprobs_k=0,
                                 validate_request=lambda p, n: None, **kw)


@pytest.mark.parametrize("field,value,jax_type", [
    ("stop", [[1, 2]], jax_res.InvalidGrammar),
    ("constrain", {"regex": "a+"}, jax_res.InvalidGrammar),
    ("logprobs", True, ValueError),
])
def test_unported_fields_refused_typed_before_device_work(params, field,
                                                          value, jax_type):
    """Structured fields on a scheduler without the machinery they need:
    the port refuses them at enqueue as the JAX scheduler does, with the
    same error and message, without a constraint compiler (``stop``,
    grammars: the typed invalid_grammar 400) or without ``logprobs_k``
    (a ValueError, the server's bad_request 400); nothing is queued."""
    jax_sched = JaxScheduler(fake_engine())
    from tf_operator_tpu.serve.scheduler import ServeRequest as JaxRequest
    with pytest.raises(jax_type) as want:
        jax_sched.enqueue(JaxRequest(prompt_of(4, 1), 2, **{field: value}))
    sched = ContinuousScheduler(fake_engine())
    port_type = getattr(resilience, jax_type.__name__, jax_type)
    with pytest.raises(port_type) as ei:
        sched.enqueue(ServeRequest(prompt_of(4, 1), 2, **{field: value}))
    assert str(ei.value) == str(want.value)
    if port_type is resilience.InvalidGrammar:
        assert resilience.http_status_of(ei.value) == 400
        assert ei.value.code == jax_type.code
    assert sched.queue_depth == 0


def test_submit_validates_eagerly(params):
    """Twin of test_serve_sched.py's eager validation, plus the shipment
    and session fields, which the port now serves: a shipment the engine
    cannot ingest falls back to the local prefill (counted
    ``tpu_serve_kv_ship_ingest_total{outcome="failed"}``, as in JAX), and
    a session key on an engine without a host tier is an ordinary
    request; both give solo generate's tokens."""
    sched = ContinuousScheduler(port_engine(params, 1))
    with pytest.raises(ValueError, match="max_seq_len"):
        sched.submit(prompt_of(60, 1), 10)
    with pytest.raises(ValueError, match="top_p"):
        sched.submit(prompt_of(4, 1), 2, top_p=0.9)
    with pytest.raises(ValueError, match="one request row"):
        ServeRequest(np.zeros((2, 4), np.int32), 2)
    sched.start()
    try:
        failed0 = metrics.SERVE_SHIP_INGEST_TOTAL.value(outcome="failed")
        for kw in ({"shipment": object()}, {"session": "s"}):
            req = sched.submit_request(
                ServeRequest(prompt_of(4, 1), 2, **kw), timeout=300)
            assert not req.shipped_join and not req.tier_join
            assert [req.out] == solo(params, prompt_of(4, 1), 2).tolist()
        assert metrics.SERVE_SHIP_INGEST_TOTAL.value(
            outcome="failed") == failed0 + 1
    finally:
        sched.stop(timeout=30)


def test_debug_snapshot_and_readiness_keys_match_jax(params):
    """After one request each, the port scheduler's debug_snapshot has
    the JAX scheduler's keys and kv_cache keys (less the unported ones);
    readiness_payload renders the same payload for the same supervisor
    state in both packages."""
    jsched = JaxScheduler(JaxEngine(CFG, params, max_slots=2)).start()
    sched = ContinuousScheduler(port_engine(params, 2)).start()
    try:
        jsched.submit(prompt_of(4, 1), 3)
        sched.submit(prompt_of(4, 1), 3)
        want, got = jsched.debug_snapshot(), sched.debug_snapshot()
    finally:
        jsched.stop(timeout=30)
        sched.stop(timeout=30)
    assert set(got) == set(want)
    assert got["constrain"] == want["constrain"]
    assert set(got["kv_cache"]) == set(want["kv_cache"]) - UNPORTED_KV_KEYS
    assert got["mesh"] == want["mesh"] == {"devices": 1}
    assert got["decode_step_compiles"] == got["warmup_compiles"] == 0
    assert got["requests_done"] == want["requests_done"] == 1
    state = types.SimpleNamespace(
        active_slots=1, queue_depth=2, requests_done=3,
        tokens_generated=40, restarts=1, dead=False, mesh_devices=1,
        mesh_axes={"tp": 1, "dp": 1}, advertised_prefixes=lambda: [],
        advertised_tier_prefixes=lambda: [])
    windowed = ("ttft_p99_s", "itl_p99_s")  # each package's own registry
    kw = dict(draining=True, replica="r0", max_slots=4)
    a = jax_httpapi.readiness_payload(state, **kw)
    b = httpapi.readiness_payload(state, **kw)
    assert ({k: v for k, v in a.items() if k not in windowed}
            == {k: v for k, v in b.items() if k not in windowed})
    state.dead = True
    assert (httpapi.readiness_payload(state)["dead"]
            == jax_httpapi.readiness_payload(state)["dead"] is True)


def _family_lines(registry, name) -> list[str]:
    return [line for line in registry.render().splitlines()
            if line.startswith(("# HELP " + name + " ",
                                "# TYPE " + name + " "))]


def test_metric_families_match_jax():
    """Every family of the port's registry is the JAX registry's family
    of that name (kind, labels, buckets, and the same HELP/TYPE lines in
    a scrape); its tpu_serve_* families are JAX's less the unported
    items' ones."""
    mine = metrics.REGISTRY._families
    theirs = jax_metrics.REGISTRY._families
    serve = {n for n in theirs if n.startswith("tpu_serve_")}
    assert {n for n in mine if n.startswith("tpu_serve_")} == (
        serve - UNPORTED_FAMILIES)
    assert {"tpu_serve_spec_accept_tokens",
            "tpu_serve_spec_rounds_total"} <= set(mine)
    for name, fam in mine.items():
        ref = theirs[name]
        assert (fam.kind, fam.labelnames, getattr(fam, "buckets", None)) \
            == (ref.kind, ref.labelnames, getattr(ref, "buckets", None))
        assert _family_lines(metrics.REGISTRY, name) == _family_lines(
            jax_metrics.REGISTRY, name)


def test_serve_error_payloads_and_status_match_jax():
    """Each typed error renders the same wire payload and HTTP status in
    both packages, with and without a replica id; untyped errors leave
    as the same ``internal`` 500; the port's NotPorted code is in the
    JAX wire vocabulary."""
    names = ["Draining", "ShuttingDown", "QueueFull", "QueueTTLExpired",
             "EngineCrashed", "ReplicaDead", "ShipFailed", "PrefixNotFound",
             "TierMiss", "InvalidGrammar"]
    try:
        for replica in ("", "gpu-0"):
            jax_res.set_replica_id(replica)
            resilience.set_replica_id(replica)
            for name in names:
                for kw in ({}, {"retry_after_s": 2.5}):
                    a = getattr(jax_res, name)("detail text", **kw)
                    b = getattr(resilience, name)("detail text", **kw)
                    assert (resilience.error_payload(b)
                            == jax_res.error_payload(a)), name
                    assert (resilience.http_status_of(b)
                            == jax_res.http_status_of(a)), name
            exc = ValueError("bad tokens")
            assert (resilience.error_payload(exc)
                    == jax_res.error_payload(exc))
            assert resilience.http_status_of(exc) == 500
    finally:
        jax_res.set_replica_id("")
        resilience.set_replica_id("")
    assert resilience.WIRE_CODES == jax_res.WIRE_CODES
    assert resilience.NotPorted.code in jax_res.WIRE_CODES
    assert resilience.http_status_of(resilience.NotPorted("x")) == 400


@pytest.mark.parametrize("spec,seed", [
    ("step_raise@3x2:1.5,ack_loss@2", 0),
    ("slow_prefill%0.3:0.01,step_stall%0.1", 5),
    ("alloc_exhaust@4,alloc_exhaust%0.5", 9),
])
def test_fault_injector_fires_at_jax_calls(spec, seed):
    """The same spec and seed fire at the same invocations of every point,
    interleaved, and snapshot alike; the env spelling is read alike."""
    a = jax_faults.FaultInjector(spec, seed=seed)
    b = faultinject.FaultInjector(spec, seed=seed)
    points = sorted(faultinject.FAULT_POINTS)
    assert points == sorted(jax_faults.FAULT_POINTS)
    order = np.random.default_rng(seed).choice(len(points), 300)
    assert ([b.fire(points[i]) for i in order]
            == [a.fire(points[i]) for i in order])
    assert b.snapshot() == a.snapshot()
    env = {"TPU_SERVE_FAULTS": spec, "TPU_SERVE_FAULT_SEED": str(seed)}
    assert (faultinject.FaultInjector.from_env(env).snapshot()
            == jax_faults.FaultInjector.from_env(env).snapshot())


def test_engine_fault_points_and_hooks(params):
    """The engine's serving hooks: alloc_exhaust empties a plan before
    any reservation, step_raise raises before the step runs, the slot
    tag names the request on the CoW span, warmup and the compile
    counters; the tokens stay solo generate's."""
    inj = faultinject.FaultInjector("alloc_exhaust@1,step_raise@1")
    engine = port_engine(params, 2, faults=inj)
    engine.warmup()
    assert engine.steps_total == 0 and not inj.invocations["step_raise"]
    prompt = prompt_of(12, 7)  # a partial last block: an exact re-join CoWs
    free = engine.kv_debug()["blocks_free"]
    assert engine.plan_admission(prompt, 6) is None
    assert engine.kv_debug()["blocks_free"] == free
    a = engine.join(prompt, num_steps=6)
    with pytest.raises(faultinject.InjectedFault):
        engine.step()
    b = engine.join(prompt, num_steps=6)
    engine.tag_slot(b, "req-b")
    SERVE_TRACER.clear()
    toks = np.stack([engine.step() for _ in range(6)])
    cow = SERVE_TRACER.spans("kv.cow")
    assert [s.attrs["request_id"] for s in cow] == ["req-b"]
    want = solo(params, prompt, 6)[0]
    np.testing.assert_array_equal(toks[:, a], want)
    np.testing.assert_array_equal(toks[:, b], want)
    assert engine.mesh_info() == {"devices": 1}
    assert engine.decode_step_compiles == engine.warmup_compiles == 0
    engine.retire(a)
    engine.retire(b)
    assert engine.free_block_fraction == 1.0
