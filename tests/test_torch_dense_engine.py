"""The port's dense slot engine (``ContinuousEngine(kv_paged=False)`` in
tf_operator_tpu_torch/serve/engine.py, on the CPU in f32) held against the
JAX package's ``ContinuousEngine(kv_paged=False)``, with the JAX init
weights in both (models/convert.py's layout).

- JAX's exactness matrix (tests/test_serve_engine.py: greedy, sampled and
  nucleus requests over an occupancy walk with joins, retires and slot
  reuse), one-shot and chunked prefill, MHA and GQA: each request's
  tokens equal JAX's dense engine's, JAX's solo ``generate`` for its seed
  and the port's paged engine's, bit for bit; the last step's logits
  within ``LOGIT_TOL`` (testing.py's rule) of JAX's.
- The dense speculative engine on JAX's spec script, f32 and kv8: tokens,
  rounds and accept counts (``spec_debug``) equal JAX's dense spec engine,
  each lane equal to the port's solo ``speculative_generate``.
- Constrained lanes and logprob rows (tests/test_torch_constrain.py's
  script), f32 and int8 + kv8: JAX's dense engine's tokens and rows.
- The dense engine's answers as JAX gives them: an ingest None (the
  scheduler prefills locally and counts ``unsupported``), an export the
  typed ``PrefixNotFound``, inert advertisements and tier, ``kv_debug``
  ``mode: "dense"``, ``free_block_fraction`` 1.0, compiles equal to
  warmup's, the kernel read refused.
- A ``step_raise`` replay across a supervisor rebuild serves every
  request as the unfaulted dense scheduler did, bit for bit."""

import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from tf_operator_tpu.serve import constrain as jc
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.runtime.metrics import SERVE_SHIP_INGEST_TOTAL
from tf_operator_tpu_torch.serve import constrain as tc
from tf_operator_tpu_torch.serve import faultinject, resilience
from tf_operator_tpu_torch.serve.disagg import PrefillWorker, decode_shipment
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
)
from tf_operator_tpu_torch.testing import excess
from test_serve_engine import (
    CFG as MATRIX_CFG,
    MATRIX_REQS,
    MATRIX_SCRIPT,
    drive,
    solo,
)
from test_torch_constrain import (
    assert_rows_equal,
    configs,
    engine_requests,
    port_oracle,
    trees,
)
from test_torch_constrain import KW as CKW
from test_torch_constrain import drive as constrained_drive
from test_torch_spec_decode import (
    CFG as SPEC_CFG,
    DRAFT_CFG,
    SPEC_K,
    SPEC_REQS,
    SPEC_SCRIPT,
    jax_init,
    port_cfg,
    solo_port,
    spec_drive,
    tree,
)

torch.set_num_threads(1)

# The final logits: f32 sums over the same products in another order.
LOGIT_TOL = (1e-5, 1e-4)
MATRIX_KEYS = ("vocab_size", "d_model", "n_layers", "d_ff", "max_seq_len")


def matrix_cfgs(n_kv_heads):
    """(JAX config, port config) of the matrix: JAX's (2 heads, MHA) or
    4 heads over ``n_kv_heads``."""
    heads = dict(n_heads=2) if n_kv_heads is None else dict(
        n_heads=4, n_kv_heads=n_kv_heads)
    jcfg = replace(MATRIX_CFG, **heads)
    tcfg = TransformerConfig(
        dtype=torch.float32, **heads,
        **{k: getattr(MATRIX_CFG, k) for k in MATRIX_KEYS})
    return jcfg, tcfg


def jax_params(jcfg):
    return JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.mark.parametrize("n_kv_heads,prefill_chunk", [
    (None, None), (None, 4), (2, None)])
def test_dense_matrix_matches_jax_dense_engine_and_solo(n_kv_heads,
                                                        prefill_chunk):
    """JAX's tentpole pin on the dense layout: every request of the
    occupancy walk, greedy, sampled and nucleus, gives JAX's dense
    engine's tokens, JAX's solo generate's for its seed and the port's
    paged engine's, bit for bit; the last step's logits agree."""
    jcfg, tcfg = matrix_cfgs(n_kv_heads)
    params = jax_params(jcfg)
    jax_engine = JaxEngine(jcfg, params, max_slots=4, kv_paged=False,
                           prefill_chunk=prefill_chunk)
    want = drive(jax_engine, MATRIX_REQS, MATRIX_SCRIPT)
    engine = ContinuousEngine(tcfg, jax.tree.map(np.asarray, params), 4,
                              kv_paged=False, prefill_chunk=prefill_chunk,
                              device="cpu")
    engine.warmup()
    got = drive(engine, MATRIX_REQS, MATRIX_SCRIPT)
    paged = drive(ContinuousEngine(
        tcfg, jax.tree.map(np.asarray, params), 4, kv_block=8,
        prefill_chunk=prefill_chunk, device="cpu"),
        MATRIX_REQS, MATRIX_SCRIPT)
    for name, (prompt, steps, t, tp, seed) in MATRIX_REQS.items():
        assert got[name] == want[name] == paged[name], name
        if n_kv_heads is None:
            np.testing.assert_array_equal(
                np.asarray(got[name]),
                solo(params, prompt, steps, temperature=t, top_p=tp,
                     seed=seed), err_msg=name)
    # Every slot ran the same steps in both engines (the script retires
    # each request the step it completes): the logits rows agree.
    assert excess(engine._logits, torch.from_numpy(
        np.array(jax_engine._logits)), *LOGIT_TOL) <= 1
    assert engine.kv_debug() == jax_engine.kv_debug() == {
        "mode": "dense", "cache_rows": 4,
        "max_seq_len": MATRIX_CFG.max_seq_len}
    assert engine.decode_step_compiles == engine.warmup_compiles


@pytest.mark.parametrize("mode", ["f32", "kv8"])
def test_dense_spec_engine_matches_jax_dense_spec(mode):
    """JAX's spec script on the dense layout: the port's tokens, rounds
    and accept counts equal JAX's dense spec engine's; each lane equals
    the port's solo speculative_generate (greedy lanes the plain tokens
    too, through it)."""
    flags = {"kv8": dict(kv_int8=True)}.get(mode, {})
    cfg, dcfg = replace(SPEC_CFG, **flags), replace(DRAFT_CFG, **flags)
    params = jax_init(SPEC_CFG, 0), jax_init(DRAFT_CFG, 7)
    jax_engine = JaxEngine(cfg, params[0], max_slots=4, kv_paged=False,
                           spec_k=SPEC_K, draft_cfg=dcfg,
                           draft_params=params[1])
    want = spec_drive(jax_engine, SPEC_REQS, SPEC_SCRIPT)
    engine = ContinuousEngine(
        port_cfg(cfg), tree(params[0]), 4, kv_paged=False, spec_k=SPEC_K,
        draft_cfg=port_cfg(dcfg), draft_params=tree(params[1]),
        device="cpu")
    engine.warmup()
    got = spec_drive(engine, SPEC_REQS, SPEC_SCRIPT)
    assert got == want
    assert engine.spec_debug() == jax_engine.spec_debug()
    assert engine.spec_debug()["rounds"] > 0
    for name, (prompt, steps, t, tp, seed) in SPEC_REQS.items():
        assert got[name] == solo_port(cfg, dcfg, params, prompt, steps, t,
                                      tp, seed), name


@pytest.fixture(scope="module")
def con_params():
    return JaxTransformer(JaxConfig(dtype=jnp.float32, **CKW)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.mark.parametrize("mode,chunk", [("f32", 4), ("int8kv8", None)])
def test_dense_constrained_lanes_and_logprobs_match_jax(con_params, mode,
                                                        chunk):
    """Constrained and free lanes, greedy and sampled, with logprob rows,
    on the dense layout: JAX's dense engine's tokens and rows (values
    within 1e-5), each lane its solo oracle's."""
    vocab = jc.default_vocab(CKW["vocab_size"])
    jcfg, tcfg = configs(mode)
    jtree, ttree = trees(mode, con_params)
    want, want_rows = constrained_drive(JaxEngine(
        jcfg, jtree, max_slots=4, prefill_chunk=chunk, kv_paged=False,
        logprobs_k=3), engine_requests(jc.ConstraintCompiler(vocab)))
    reqs = engine_requests(tc.ConstraintCompiler(vocab))
    got, rows = constrained_drive(ContinuousEngine(
        tcfg, ttree, 4, kv_paged=False, prefill_chunk=chunk, logprobs_k=3,
        device="cpu"), reqs)
    assert got == want
    assert_rows_equal(rows, want_rows)
    for name, (prompt, steps, t, tp, seed, prog) in reqs.items():
        np.testing.assert_array_equal(
            got[name], port_oracle(tcfg, ttree, prompt, steps, prog, t, tp,
                                   seed), err_msg=name)


def small():
    jcfg, tcfg = matrix_cfgs(None)
    return jcfg, tcfg, jax_params(jcfg)


def test_dense_engine_answers_as_jax():
    """What a dense engine answers where the paged one holds blocks, each
    as JAX's dense engine answers it; the kernel read is refused."""
    jcfg, tcfg, params = small()
    tparams = jax.tree.map(np.asarray, params)
    jax_engine = JaxEngine(jcfg, params, max_slots=2, kv_paged=False)
    engine = ContinuousEngine(tcfg, tparams, 2, kv_paged=False,
                              device="cpu")
    engine.warmup()
    prompt = MATRIX_REQS["solo_a"][0]
    shp = decode_shipment(PrefillWorker(tcfg, tparams, kv_block=8,
                                        device="cpu").prefill(prompt))
    assert engine.ingest_shipment(shp, reserve_steps=4) is None
    assert jax_engine.ingest_shipment(shp) is None
    for eng in (engine, jax_engine):
        with pytest.raises(Exception, match="dense engine holds no prefix"):
            eng.export_prefix("00" * 20)
        assert eng.advertised_prefixes() == []
        assert eng.advertised_tier_prefixes() == []
        assert eng.free_block_fraction == 1.0
        assert eng.kv_paged is False and eng.blocks is eng.prefix is None
        assert eng.table_len is eng.kv_blocks is None
    with pytest.raises(resilience.PrefixNotFound):
        engine.export_prefix("00" * 20)
    # The tier is inert (JAX's dense engine has no tier attribute at all).
    assert not engine.tier_probe(prompt)
    assert engine.restore_from_tier(prompt) == (None, "miss")
    plan = engine.plan_admission(prompt, 4)
    assert plan.shared_tokens == 0 and plan.read_table is None
    engine.release_plan(plan)  # reserves nothing: a no-op
    assert engine.join_planned(plan) == 0
    assert engine.kv_debug() == jax_engine.kv_debug()
    assert engine.decode_step_compiles == engine.warmup_compiles == 0
    with pytest.raises(ValueError, match="kv_paged"):
        ContinuousEngine(tcfg, tparams, 2, kv_paged=False,
                         kv_attend="kernel", device="cpu")


def run_all(submit, reqs):
    done = [None] * len(reqs)

    def client(i):
        done[i] = submit(reqs[i])

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None for r in done)
    return [(list(r.out), r.finish_reason) for r in done]


def sched_requests(shipment=None):
    reqs = [ServeRequest(MATRIX_REQS["solo_a"][0], 10),
            ServeRequest(MATRIX_REQS["join_b"][0], 8, temperature=0.9,
                         seed=5),
            ServeRequest(MATRIX_REQS["nucl_d"][0], 12, temperature=0.7,
                         top_p=0.8, seed=6)]
    if shipment is not None:
        reqs.append(ServeRequest(MATRIX_REQS["solo_a"][0], 10,
                                 shipment=shipment))
    return reqs


def test_scheduler_prefills_a_shipment_locally_and_replays_bitwise():
    """The scheduler over a dense engine: a request carrying a shipment is
    prefilled locally (counted ``unsupported``) and answers as the same
    request without one; the degraded watermark never trips (a dense
    engine reads every block free); each request equals JAX's solo
    generate over its whole budget. Then
    ``step_raise`` once under the supervisor: every request replays on a
    rebuilt dense engine and answers bit for bit as the unfaulted run."""
    jcfg, tcfg, params = small()
    tparams = jax.tree.map(np.asarray, params)
    shp = decode_shipment(PrefillWorker(tcfg, tparams, kv_block=8,
                                        device="cpu").prefill(
        MATRIX_REQS["solo_a"][0]))

    def engine(**kw):
        eng = ContinuousEngine(tcfg, tparams, 3, kv_paged=False,
                               device="cpu", **kw)
        eng.warmup()
        return eng

    before = SERVE_SHIP_INGEST_TOTAL.value(outcome="unsupported")
    res = resilience.ResilienceConfig(degraded_free_block_frac=0.99,
                                      degraded_max_tokens=2)
    sched = ContinuousScheduler(engine(), resilience=res).start()
    try:
        want = run_all(lambda r: sched.submit_request(r, timeout=120),
                       sched_requests(shp))
        snap = sched.debug_snapshot()
    finally:
        sched.stop(timeout=60)
    assert SERVE_SHIP_INGEST_TOTAL.value(outcome="unsupported") == before + 1
    assert want[3] == want[0]
    assert snap["kv_cache"]["mode"] == "dense" and not sched.degraded
    for (out, _), req in zip(want, sched_requests()):
        kw = dict(temperature=req.temperature, top_p=req.top_p,
                  seed=req.seed) if req.temperature > 0 else {}
        assert out == solo(params, req.tokens, req.num_steps,
                           **kw).tolist()

    inj = faultinject.FaultInjector("step_raise@3", seed=3)
    engines = []

    def factory():
        engines.append(engine(faults=inj))
        return engines[-1]

    sup = resilience.EngineSupervisor(
        factory, resilience=resilience.ResilienceConfig(
            watchdog_stall_s=30.0, restart_backoff_s=0.05, max_restarts=3),
        faults=inj)
    try:
        got = run_all(lambda r: sup.submit_request(r, timeout=120),
                      sched_requests())
    finally:
        sup.stop(timeout=60)
    assert sup.restarts == 1 and len(engines) == 2
    assert got == want[:3]
