"""The host KV tier in the port (tf_operator_tpu_torch/serve/tier.py, the
engine's spill and restore, the scheduler's tier-aware admission), on the
CPU in f32 (and kv8) with the JAX init's weights, held to
tests/test_serve_tier.py's pins: every restored decode equals JAX's solo
``generate`` (greedy and sampled) with the decode step's compile count
unmoved, and

- spill: a reclaimed retained prefix lands in the tier as a wire payload
  (blocks back in the pool, the digest advertised warm, not hot); restore:
  the identical prompt exact-joins the restored blocks, its whole prefill
  skipped; a longer turn restores its aligned prefix and prefills the
  rest; a ``session`` key prefetches the restore at enqueue;
- tier off: no ``tier`` section, nothing advertised warm, evictions free,
  a restore is a ``miss``, an export the typed ``prefix_not_found``;
- a tier hit the pool cannot hold is ``exhausted`` (the can-restore wait)
  and lands once capacity frees; an export answers from the tier;
  /healthz carries ``tier_prefixes`` and omits it when empty;
- a poison entry is dropped, the restore counted ``failed``, and the
  request prefills locally; a spill the tier refuses or whose export
  raises leaves the release whole;
- across a watchdog rebuild (one process-lifetime tier), a shipped
  request ingests its shipment again and a tier-restored one restores
  again, both replays giving the solo tokens;
- ``HostTier`` and ``payload_nbytes`` step for step JAX's.

No assertion reads the wall clock."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    generate as jax_generate,
)
from tf_operator_tpu.serve import tier as jax_tier
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.serve import disagg, faultinject, resilience
from tf_operator_tpu_torch.serve import serve_lm
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.httpapi import readiness_payload
from tf_operator_tpu_torch.serve.resilience import PrefixNotFound
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
)
from tf_operator_tpu_torch.serve.tier import HostTier, payload_nbytes

torch.set_num_threads(1)

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
          max_seq_len=64)
BLOCK = 8
JCFG = JaxConfig(dtype=jnp.float32, **KW)
TCFG = TransformerConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def params():
    return JaxTransformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def prompt_of(p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, p)).astype(np.int32)


def solo(params, prompt, steps, *, cfg=JCFG, temperature=0.0, seed=0):
    kw = {}
    if temperature > 0:
        kw = dict(temperature=temperature, rng=jax.random.PRNGKey(seed))
    return np.asarray(jax_generate(cfg, params, jnp.asarray(prompt), steps,
                                   **kw))[0].tolist()


def tiered_engine(params, *, cfg=TCFG, retain=32, max_slots=2,
                  tier=None, **kw) -> ContinuousEngine:
    """A port engine with retention on and ``tier`` attached: serve_lm's
    --host-tier-bytes wiring."""
    eng = ContinuousEngine(cfg, jax.tree.map(np.asarray, params), max_slots,
                           kv_block=BLOCK, device="cpu", **kw)
    eng.prefix_retain_max = retain
    eng.prefix_advertise_max = 32
    eng.host_tier = tier
    return eng


def mk_sched(params, *, tier_bytes=64 << 20, **kw) -> ContinuousScheduler:
    tier = HostTier(tier_bytes) if tier_bytes else None
    return ContinuousScheduler(tiered_engine(params, tier=tier, **kw)).start()


def exact_digest(prompt) -> str:
    return disagg.chain_digests(np.asarray(prompt[0], np.int32), BLOCK)[-1]


def force_spill(sched):
    """Reclaim every retained hold as pool pressure would: with a tier the
    dying exact entries spill, without one they just free."""
    sched.call_engine(lambda e: e._evict_retained(until_free=10 ** 9))


# ---------------------------------------------------------------------------
# spill -> restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 11)],
                         ids=["greedy", "sampled"])
def test_spill_restore_bit_identical(params, temperature, seed):
    prompt = prompt_of(13, 70 if temperature == 0 else 71)
    steps = 8
    oracle = solo(params, prompt, steps, temperature=temperature, seed=seed)
    sched = mk_sched(params)
    eng = sched.engine
    try:
        r1 = sched.submit_request(ServeRequest(
            prompt, steps, temperature=temperature, seed=seed), timeout=300)
        assert r1.out == oracle
        force_spill(sched)
        assert eng.blocks.used == 0
        assert exact_digest(prompt) not in sched.advertised_prefixes()
        assert exact_digest(prompt) in sched.advertised_tier_prefixes()
        saved0 = sched.debug_snapshot()["kv_cache"]["prefill_tokens_saved"]
        r2 = sched.submit_request(ServeRequest(
            prompt, steps, temperature=temperature, seed=seed), timeout=300)
        snap = sched.debug_snapshot()
        assert r2.out == oracle and r2.tier_join
        assert r2.timing()["tier_kv"] is True
        assert eng.tier_restores >= 1 and eng.tier_spills >= 1
        assert (snap["kv_cache"]["prefill_tokens_saved"] - saved0
                == prompt.shape[1]), "the restore did not skip prefill"
        assert snap["decode_step_compiles"] == snap["warmup_compiles"]
        tier = snap["kv_cache"]["tier"]
        assert tier["spills"] >= 1 and tier["hits"] >= 1
        assert tier["restore_tokens"] >= prompt.shape[1]
    finally:
        sched.stop(timeout=60)


def test_session_resume_restores_turn_prefix(params):
    """Turn 2 extends turn 1 (block-aligned): the tier restores turn 1's
    spilled prefix and only the extension prefills."""
    turn1 = prompt_of(16, 72)
    steps = 6
    ext = np.concatenate(
        [turn1, np.asarray(solo(params, turn1, steps), np.int32)[None, :8],
         prompt_of(8, 73)], axis=1)
    sched = mk_sched(params)
    eng = sched.engine
    try:
        sched.submit_request(ServeRequest(turn1, steps, session="s0"),
                             timeout=300)
        force_spill(sched)
        assert eng.blocks.used == 0
        r2 = sched.submit_request(ServeRequest(ext, steps, session="s0"),
                                  timeout=300)
        assert r2.out == solo(params, ext, steps)
        assert eng.tier_restores >= 1 and eng.tier_restore_tokens >= 16
    finally:
        sched.stop(timeout=60)


def test_session_prefetch_prewarms(params):
    """A ``session`` enqueue posts a restore that runs on the loop before
    the admission; either way the prompt exact-joins."""
    prompt = prompt_of(13, 74)
    steps = 6
    sched = mk_sched(params)
    eng = sched.engine
    try:
        sched.submit_request(ServeRequest(prompt, steps, session="s1"),
                             timeout=300)
        force_spill(sched)
        saved0 = sched.debug_snapshot()["kv_cache"]["prefill_tokens_saved"]
        r2 = sched.submit_request(ServeRequest(prompt, steps, session="s1"),
                                  timeout=300)
        snap = sched.debug_snapshot()
        assert r2.out == solo(params, prompt, steps)
        assert eng.tier_restores >= 1
        assert (snap["kv_cache"]["prefill_tokens_saved"] - saved0
                == prompt.shape[1])
        assert snap["decode_step_compiles"] == snap["warmup_compiles"]
    finally:
        sched.stop(timeout=60)


class TestKv8Tier:
    @pytest.fixture(scope="class")
    def cfgs(self):
        from dataclasses import replace
        return replace(JCFG, kv_int8=True), replace(TCFG, kv_int8=True)

    @pytest.fixture(scope="class")
    def p8(self, cfgs):
        return JaxTransformer(cfgs[0]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]

    @pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 5)],
                             ids=["greedy", "sampled"])
    def test_kv8_spill_restore_bit_identical(self, cfgs, p8, temperature,
                                             seed):
        prompt = prompt_of(13, 75 if temperature == 0 else 76)
        oracle = solo(p8, prompt, 8, cfg=cfgs[0], temperature=temperature,
                      seed=seed)
        sched = mk_sched(p8, cfg=cfgs[1])
        try:
            r1 = sched.submit_request(ServeRequest(
                prompt, 8, temperature=temperature, seed=seed), timeout=300)
            assert r1.out == oracle
            force_spill(sched)
            payload = json.loads(json.dumps(
                sched.export_prefix(exact_digest(prompt))))
            parts = set().union(*(set(kv)
                                  for kv in payload["rows"].values()))
            assert {"key_scale", "value_scale"} <= parts
            r2 = sched.submit_request(ServeRequest(
                prompt, 8, temperature=temperature, seed=seed), timeout=300)
            snap = sched.debug_snapshot()
            assert r2.out == oracle and r2.tier_join
            assert snap["decode_step_compiles"] == snap["warmup_compiles"]
        finally:
            sched.stop(timeout=60)


# ---------------------------------------------------------------------------
# tier off; the can-restore wait; poison
# ---------------------------------------------------------------------------


def test_tier_off_accounting_unchanged(params):
    prompt = prompt_of(13, 77)
    sched = mk_sched(params, tier_bytes=0)
    eng = sched.engine
    try:
        sched.submit_request(ServeRequest(prompt, 6), timeout=300)
        force_spill(sched)
        assert eng.blocks.used == 0
        assert "tier" not in sched.debug_snapshot()["kv_cache"]
        assert sched.advertised_tier_prefixes() == []
        assert eng.tier_probe(prompt) is False
        assert sched.call_engine(
            lambda e: e.restore_from_tier(prompt)) == (None, "miss")
        with pytest.raises(PrefixNotFound):
            sched.export_prefix(exact_digest(prompt))
    finally:
        sched.stop(timeout=60)


def test_exhausted_pool_is_can_restore_not_recompute(params):
    prompt = prompt_of(13, 78)
    steps = 6
    oracle = solo(params, prompt, steps)
    sched = mk_sched(params, kv_blocks=8, max_slots=1)
    eng = sched.engine
    try:
        assert sched.submit_request(ServeRequest(prompt, steps),
                                    timeout=300).out == oracle
        force_spill(sched)
        grabbed = sched.call_engine(
            lambda e: e.blocks.alloc(e.blocks.free_blocks))
        assert grabbed
        assert eng.tier_probe(prompt) is True
        assert sched.call_engine(lambda e: e.restore_from_tier(
            prompt, reserve_steps=steps)) == (None, "exhausted")
        sched.call_engine(lambda e: e._free_blocks(grabbed))
        r2 = sched.submit_request(ServeRequest(prompt, steps), timeout=300)
        assert r2.out == oracle and r2.tier_join
    finally:
        sched.stop(timeout=60)


def test_poison_entry_dropped_and_counted_failed(params):
    """A stored payload that no longer verifies is dropped from the tier,
    the restore is counted ``failed``, and the request prefills locally
    to the solo tokens."""
    prompt = prompt_of(13, 81)
    sched = mk_sched(params)
    eng = sched.engine
    try:
        sched.submit_request(ServeRequest(prompt, 6), timeout=300)
        force_spill(sched)
        digest = exact_digest(prompt)
        poison = dict(eng.host_tier.get(digest), rows_sha1="0" * 40)
        assert eng.host_tier.put(poison)
        failed0 = metrics.SERVE_KV_TIER_RESTORES.value(outcome="failed")
        r2 = sched.submit_request(ServeRequest(prompt, 6), timeout=300)
        assert r2.out == solo(params, prompt, 6) and not r2.tier_join
        assert digest not in eng.host_tier
        assert metrics.SERVE_KV_TIER_RESTORES.value(
            outcome="failed") == failed0 + 1
    finally:
        sched.stop(timeout=60)


@pytest.mark.parametrize("fault", ["refused", "export_raises"])
def test_spill_is_best_effort(params, monkeypatch, fault):
    """A spill the tier refuses (a payload over its whole budget, counted
    ``refused``) or whose export raises leaves the entry unspilled and the
    release whole: every block back in the pool, nothing raised."""
    prompt = prompt_of(13, 86)
    sched = mk_sched(params, tier_bytes=64 if fault == "refused" else 64 << 20)
    eng = sched.engine
    try:
        sched.submit_request(ServeRequest(prompt, 4), timeout=300)
        if fault == "export_raises":
            def broken(*args, **kw):
                raise RuntimeError("export failed")

            monkeypatch.setattr(disagg, "export_shipment", broken)
        force_spill(sched)
        assert eng.blocks.used == 0 and len(eng.host_tier) == 0
        assert eng.tier_spills == 0
        assert eng.host_tier.refused == (1 if fault == "refused" else 0)
        assert sched.submit_request(ServeRequest(prompt, 4),
                                    timeout=300).out == solo(params, prompt, 4)
    finally:
        sched.stop(timeout=60)


def test_export_answers_from_tier(params):
    prompt = prompt_of(13, 79)
    sched = mk_sched(params)
    try:
        sched.submit_request(ServeRequest(prompt, 6), timeout=300)
        force_spill(sched)
        exports0 = sched.debug_snapshot()["kv_cache"]["prefix_exports"]
        payload = json.loads(json.dumps(
            sched.export_prefix(exact_digest(prompt))))
        assert sched.debug_snapshot()["kv_cache"]["prefix_exports"] == (
            exports0 + 1)
        shp = disagg.decode_shipment(payload, expect_tokens=prompt[0])
        assert shp.tokens.tolist() == prompt[0].tolist()
        with pytest.raises(PrefixNotFound):
            sched.export_prefix("ab" * 20)
    finally:
        sched.stop(timeout=60)


class _ProbeShape:
    active_slots = 0
    queue_depth = 0
    requests_done = 0
    tokens_generated = 0

    def __init__(self, sched):
        self._sched = sched

    def advertised_prefixes(self):
        return self._sched.advertised_prefixes()

    def advertised_tier_prefixes(self):
        return self._sched.advertised_tier_prefixes()


def test_readiness_advertises_tier_and_omits_when_empty(params):
    prompt = prompt_of(11, 80)
    sched = mk_sched(params)
    duck = _ProbeShape(sched)
    try:
        sched.submit_request(ServeRequest(prompt, 4), timeout=300)
        assert "tier_prefixes" not in readiness_payload(duck)
        force_spill(sched)
        payload = readiness_payload(duck)
        assert exact_digest(prompt) in payload["tier_prefixes"]
        assert exact_digest(prompt) not in payload.get("prefixes", [])
        sched.engine.prefix_advertise_max = 0
        assert "tier_prefixes" not in readiness_payload(duck)
    finally:
        sched.engine.prefix_advertise_max = 32
        sched.stop(timeout=60)


# ---------------------------------------------------------------------------
# replay across a watchdog rebuild
# ---------------------------------------------------------------------------


def test_replay_ingests_again_and_restores_again(params):
    """One tier for the process: a shipped request and a request whose
    prompt sits in the tier cross an injected step crash; the rebuilt
    engine ingests the shipment again and restores the prefix again, and
    both replays give the solo tokens."""
    tier = HostTier(64 << 20)
    inj = faultinject.FaultInjector("step_raise@9", seed=3)
    engines = []

    def factory():
        eng = tiered_engine(params, tier=tier, faults=inj)
        eng.warmup()
        engines.append(eng)
        return eng

    sup = resilience.EngineSupervisor(
        factory, resilience=resilience.ResilienceConfig(
            watchdog_stall_s=30.0, restart_backoff_s=0.05, max_restarts=3),
        faults=inj)
    try:
        warm, shipped = prompt_of(13, 82), prompt_of(12, 83)
        sup.submit(warm, 6, timeout=300)  # steps 1-6
        sup.scheduler.call_engine(
            lambda e: e._evict_retained(until_free=10 ** 9))
        assert exact_digest(warm) in tier
        pw = disagg.PrefillWorker(TCFG, jax.tree.map(np.asarray, params),
                                  kv_block=BLOCK, device="cpu")
        shp = disagg.decode_shipment(pw.prefill(shipped))
        reqs = [ServeRequest(shipped, 8, shipment=shp),
                ServeRequest(warm, 8)]
        for req in reqs:
            sup.scheduler.enqueue(req)
        for req in reqs:
            resilience.await_request(req, timeout=300)
        assert sup.restarts == 1 and len(engines) == 2
        a, b = reqs
        assert a.replays == b.replays == 1
        assert a.shipped_join and a.out == solo(params, shipped, 8)
        assert b.tier_join and b.out == solo(params, warm, 8)
        assert engines[1].shipments_ingested == 1
        assert engines[1].tier_restores == 1
    finally:
        sup.stop(timeout=60)


# ---------------------------------------------------------------------------
# the front: --host-tier-bytes
# ---------------------------------------------------------------------------


def test_front_host_tier(params):
    """``build_front`` under --host-tier-bytes attaches one tier to the
    engine; a spilled prompt's digest shows on /healthz as a tier prefix
    and its second request restores; the five ship and tier families are
    in /metrics."""
    args = serve_lm.front_args(device="cpu", max_batch=2, kv_block=BLOCK,
                               max_seq_len=KW["max_seq_len"],
                               host_tier_bytes=64 << 20, tier_prefetch=0)
    sup, server = serve_lm.build_front(TCFG, jax.tree.map(np.asarray, params),
                                       args)
    server.start()
    try:
        prompt = prompt_of(13, 84)
        sup.submit(prompt, 6, timeout=300)
        sup.scheduler.call_engine(
            lambda e: e._evict_retained(until_free=10 ** 9))
        payload = readiness_payload(sup)
        assert exact_digest(prompt) in payload["tier_prefixes"]
        req = sup.submit_request(ServeRequest(prompt, 6), timeout=300)
        assert req.tier_join and req.out == solo(params, prompt, 6)
        assert sup.scheduler.tier_prefetch is False
        text = metrics.REGISTRY.render()
        for family in ("tpu_serve_kv_ship_ingest_total",
                       "tpu_serve_ship_tokens_total",
                       "tpu_serve_kv_tier_bytes",
                       "tpu_serve_kv_tier_restores_total",
                       "tpu_serve_kv_tier_spills_total"):
            assert f"# TYPE {family} " in text
    finally:
        server.drain()


# ---------------------------------------------------------------------------
# HostTier against JAX's
# ---------------------------------------------------------------------------


def _payload(tag: str, nbytes: int = 96) -> dict:
    import base64
    data = base64.b64encode(b"\x00" * nbytes).decode()
    return {"version": 1, "tokens": [1, 2, 3], "kv_block": 2,
            "digests": [f"{tag}-d0", f"{tag}-d1"],
            "rows": {"layer0": {"key": {"b64": data}}}}


def test_host_tier_matches_jax_step_for_step():
    """The same calls on the port's HostTier and JAX's give the same
    answers and snapshots: the LRU byte budget, refusal, ``deepest``,
    ``advertise`` and ``discard``."""
    one = payload_nbytes(_payload("a"))
    assert one == jax_tier.payload_nbytes(_payload("a"))
    tiers = (HostTier(2 * one), jax_tier.HostTier(2 * one))
    script = [("put", "a"), ("put", "b"), ("get", "a-d1"), ("put", "c"),
              ("contains", "b-d1"), ("contains", "a-d1"), ("get", "zz"),
              ("deepest", ["a-d0", "a-d1"]), ("deepest", ["zz"]),
              ("advertise", 1), ("advertise", 0), ("discard", "c-d1"),
              ("discard", "c-d1"), ("put", "d"), ("len", None)]
    for op, arg in script:
        got = []
        for t in tiers:
            if op == "put":
                got.append(t.put(_payload(arg)))
            elif op == "get":
                got.append(t.get(arg) is not None)
            elif op == "contains":
                got.append(arg in t)
            elif op == "len":
                got.append(len(t))
            else:
                got.append(getattr(t, op)(arg))
        assert got[0] == got[1], (op, arg, got)
        assert tiers[0].snapshot() == tiers[1].snapshot(), (op, arg)
    assert not HostTier(8).put(_payload("x"))
    # Payloads of a real spill: the budget charges their decoded bytes.
    assert tiers[0].bytes_used <= tiers[0].capacity_bytes


def test_spill_payload_bytes(params):
    """A spilled entry is charged its decoded size: 2 layers x K and V of
    16 rows x 2 heads x 16 f32, the logits and the tokens."""
    prompt = prompt_of(13, 85)
    sched = mk_sched(params)
    try:
        sched.submit_request(ServeRequest(prompt, 4), timeout=300)
        force_spill(sched)
        snap = sched.engine.host_tier.snapshot()
        assert snap["entries"] == 1
        assert snap["bytes_used"] == (2 * 2 * 16 * 2 * 16 * 4
                                      + KW["vocab_size"] * 4 + 13 * 4)
    finally:
        sched.stop(timeout=60)


def test_tier_is_thread_safe_under_concurrent_puts():
    tier = HostTier(10 * payload_nbytes(_payload("a")))
    threads = [threading.Thread(target=lambda i=i: [
        tier.put(_payload(f"t{i}-{j}")) for j in range(20)])
        for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a put never returned"
    snap = tier.snapshot()
    assert snap["entries"] == 10 and snap["spills"] == 80
    assert snap["evictions"] == 70
    assert snap["bytes_used"] == 10 * payload_nbytes(_payload("a"))
