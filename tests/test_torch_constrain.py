"""Constrained and structured decoding in the port
(tf_operator_tpu_torch/serve/constrain.py, the engine's constraint pool and
logprobs, the scheduler's delivery rules) held against the JAX package on
the CPU in f32, with the JAX init weights in both.

- The compiler: for regex, choices and json_schema specs (nested object,
  array, enum, const, pattern), with and without ``eos_id``, the
  ``allow``/``next``/``accept``/``complete`` tables are bitwise JAX's; the
  invalid specs raise the same message; ``encode_stop``, ``match_stop``
  and ``apply_stop`` give JAX's answers; the LRU keeps JAX's counts.
- The pool: a bind/release/evict sequence gives JAX's base rows, tables
  and ``debug()``.
- The oracle: ``constrained_generate`` gives JAX's tokens, greedy and
  sampled (temperature, top_p).
- The engine: constrained and free lanes, greedy and sampled, through the
  gather and the kernel's plain read, f32, kv8 and int8 + kv8, with
  chunked prefill: each lane equals JAX's engine and the port's oracle,
  and each step's logprob rows equal JAX's ``last_logprobs`` (values within
  1e-5, ids equal) where a choices lane allows fewer tokens than K (the
  tail of the top-K is a tie); program churn through a small pool evicts
  as JAX's does.
- The scheduler: constrained, stop, logprobs and eos requests give JAX's
  scheduler's tokens, ``finish_reason`` and logprob rows, also across a
  ``step_raise`` crash replay under the supervisor.

The vocabulary is the identity charset at V=128 (token id i = chr(i)), so
ASCII grammars close over it."""

import json
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    quantize_decode_params as jax_quantize_decode_params,
)
from tf_operator_tpu.serve import constrain as jc
from tf_operator_tpu.serve import resilience as jax_res
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu.serve.scheduler import (
    ContinuousScheduler as JaxScheduler,
    ServeRequest as JaxRequest,
)
from tf_operator_tpu_torch.models.convert import quantize_decode_params
from tf_operator_tpu_torch.models.transformer import (
    TransformerConfig,
    generate,
)
from tf_operator_tpu_torch.random import PRNGKey
from tf_operator_tpu_torch.serve import constrain as tc
from tf_operator_tpu_torch.serve import faultinject, resilience
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
)

torch.set_num_threads(1)

V = 128
KW = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=2, d_ff=64,
          max_seq_len=64)
MODES = {"f32": {}, "kv8": dict(kv_int8=True),
         "int8kv8": dict(int8_decode=True, kv_int8=True)}
BLK, K = 8, 3
VOCAB = tc.default_vocab(V)
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 4}, "ok": {"type": "boolean"}}}
SPECS = [
    {"regex": "[0-9]{2,6}"},
    {"regex": "(ab|cd)+x?"},
    {"regex": "[^a-z\\n]{1,3}\\.?"},
    {"regex": "\\d+(\\.\\d{1,2})?"},
    {"choices": ["cat", "car", "dog"]},
    {"json_schema": SCHEMA},
    {"json_schema": {"type": "object", "properties": {
        "id": {"type": "integer"},
        "tag": {"type": "object", "properties": {
            "k": {"type": "string", "minLength": 1, "maxLength": 2},
            "on": {"type": "boolean"}}}}}},
    {"json_schema": {"type": "array", "items": {"enum": ["a", 1, None]},
                     "minItems": 1, "maxItems": 3}},
    {"json_schema": {"type": "object", "required": ["v", "n"],
                     "properties": {"v": {"const": {"k": [1, 2]}},
                                    "n": {"type": "number"},
                                    "z": {"type": "null"}}}},
    {"json_schema": {"type": "string", "pattern": "[A-Z]{2}"}},
]
INVALID = [
    (V, {"regex": "[unclosed"}),
    (V, {"regex": "a{5,2}"}),
    (V, {"regex": "a{65}"}),
    (V, {"regex": ""}),
    (V, {"regex": "*a"}),
    (V, {"choices": []}),
    (V, {"choices": ["ok", ""]}),
    (V, {"json_schema": {"type": "object"}}),
    (V, {"json_schema": {"type": "tuple"}}),
    (V, {"regex": "a", "choices": ["a"]}),
    (V, {"unknown": 1}),
    (V, "a+"),
    (64, {"choices": ["cat"]}),  # no lowercase tokens at V=64
]


@pytest.fixture(scope="module")
def comps():
    """(JAX compiler, port compiler) over the same vocabulary."""
    return jc.ConstraintCompiler(VOCAB), tc.ConstraintCompiler(VOCAB)


@pytest.fixture(scope="module")
def params():
    return JaxTransformer(JaxConfig(dtype=jnp.float32, **KW)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def prompt_of(p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, V, (1, p)).astype(
        np.int32)


def configs(mode: str):
    return (JaxConfig(dtype=jnp.float32, **MODES[mode], **KW),
            TransformerConfig(dtype=torch.float32, **MODES[mode], **KW))


def trees(mode: str, params):
    """(JAX tree, port tree): quantized when the mode has int8 weights."""
    if MODES[mode].get("int8_decode"):
        return (jax_quantize_decode_params(params),
                quantize_decode_params(jax.tree.map(np.asarray, params)))
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# the compiler, the stop helpers and the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eos_id", [None, 10])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: json.dumps(s)[:40])
def test_compiler_tables_are_bitwise_jax(comps, spec, eos_id):
    want = comps[0].compile(spec, eos_id=eos_id)
    got = comps[1].compile(spec, eos_id=eos_id)
    for name in ("allow", "next", "accept", "complete"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.digest, got.kind, got.spec, got.describe()) == (
        want.digest, want.kind, want.spec, want.describe())
    if "json_schema" in spec:
        assert tc.schema_to_regex(spec["json_schema"]) == jc.schema_to_regex(
            spec["json_schema"])


@pytest.mark.parametrize("vocab,spec", INVALID,
                         ids=lambda x: json.dumps(x)[:30])
def test_invalid_grammars_raise_jax_message(vocab, spec):
    with pytest.raises(jax_res.InvalidGrammar) as want:
        jc.ConstraintCompiler(jc.default_vocab(vocab)).compile(spec)
    with pytest.raises(resilience.InvalidGrammar) as got:
        tc.ConstraintCompiler(tc.default_vocab(vocab)).compile(spec)
    assert str(got.value) == str(want.value)
    assert got.value.http_status == 400 and not got.value.retryable


def test_compiler_cache_counts_match_jax():
    seq = [{"regex": "[0-9]+"}, {"regex": "[0-9]+"}, {"regex": "[a-z]+"},
           {"regex": "[A-Z]+"}, {"regex": "[0-9]+"}, {"choices": ["a"]}]
    jaxc = jc.ConstraintCompiler(VOCAB, cache_programs=2)
    port = tc.ConstraintCompiler(VOCAB, cache_programs=2)
    for spec in seq:
        assert jaxc.compile(spec).digest == port.compile(spec).digest
        assert port.debug() == jaxc.debug()
    assert port.debug()["cache_hits"] == 1


def test_stop_helpers_match_jax(comps):
    stop = ["ab", [7, 8, 9], "z"]
    stops = comps[1].encode_stop(stop)
    assert stops == comps[0].encode_stop(stop) == ((97, 98), (7, 8, 9),
                                                   (122,))
    for bad in ([""], [3.5], [], "ab", [[]], ["一"]):
        with pytest.raises(jax_res.InvalidGrammar) as want:
            comps[0].encode_stop(bad)
        with pytest.raises(resilience.InvalidGrammar) as got:
            comps[1].encode_stop(bad)
        assert str(got.value) == str(want.value)
    assert comps[1].encode_stop(None) == ()
    rng = np.random.default_rng(0)
    for _ in range(100):
        stream = [int(t) for t in rng.integers(95, 100, 30)]
        stream[int(rng.integers(0, 28))] = 7
        assert tc.apply_stop(stream, stops) == jc.apply_stop(stream, stops)
        for j in range(len(stream)):
            assert tc.match_stop(stream[:j], stops) == jc.match_stop(
                stream[:j], stops)
    assert tc.max_stop_len(stops) == jc.max_stop_len(stops) == 3


def test_program_pool_matches_jax(comps):
    """Bind, rebind, a full pool (None), release, an LRU eviction, a
    program larger than the pool: the same answers, tables and debug()
    as JAX's pool."""
    progs = [(comps[0].compile(s), comps[1].compile(s)) for s in (
        {"regex": "[0-9]{2,4}"}, {"choices": ["cat", "car", "dog"]},
        {"regex": "[A-Z]{2,4}"}, {"regex": "[a-c]{1,3}"})]
    rows = progs[0][0].n_states + progs[1][0].n_states + 1
    jpool, tpool = jc.ProgramPool(rows, V), tc.ProgramPool(rows, V,
                                                           device="cpu")
    script = [("bind", 0), ("bind", 0), ("bind", 1), ("bind", 2),
              ("release", 0), ("release", 0), ("bind", 2), ("bind", 3),
              ("release", 1), ("bind", 3), ("release", 2), ("bind", 0)]
    for op, i in script:
        if op == "bind":
            assert tpool.bind(progs[i][1]) == jpool.bind(progs[i][0]), (op, i)
        else:
            tpool.release(progs[i][1].digest)
            jpool.release(progs[i][0].digest)
        assert tpool.debug() == jpool.debug()
        assert np.array_equal(tpool.allow_pool.numpy(),
                              np.asarray(jpool.allow_pool))
        assert np.array_equal(tpool.next_pool.numpy(),
                              np.asarray(jpool.next_pool))
    assert tpool.debug()["evictions"] >= 1
    assert tpool.next_pool.dtype == torch.int32
    big = comps[1].compile({"json_schema": SCHEMA})
    with pytest.raises(resilience.InvalidGrammar, match="constrain_rows"):
        tpool.bind(big)
    with pytest.raises(ValueError, match="must be >= 2"):
        tc.ProgramPool(1, V)


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def jax_oracle(cfg, tree, prompt, steps, prog, t=0.0, tp=None, seed=0):
    kw = {}
    if t > 0:
        kw = dict(temperature=t, rng=jax.random.PRNGKey(seed), top_p=tp)
    return np.asarray(jc.constrained_generate(
        cfg, tree, jnp.asarray(prompt), steps, program=prog, **kw))[0]


def port_oracle(cfg, tree, prompt, steps, prog, t=0.0, tp=None, seed=0):
    kw = dict(temperature=t, rng=PRNGKey(seed, "cpu"), top_p=tp) \
        if t > 0 else {}
    if prog is None:
        return generate(cfg, tree, prompt, steps, device="cpu", **kw)[
            0].numpy()
    return tc.constrained_generate(cfg, tree, prompt, steps, program=prog,
                                   device="cpu", **kw)[0].numpy()


@pytest.mark.parametrize("spec,t,tp,seed", [
    ({"regex": "[0-9]{2,6}"}, 0.0, None, 0),
    ({"choices": ["cat", "car", "dog"]}, 0.8, 0.9, 11),
    ({"json_schema": SCHEMA}, 0.9, None, 3),
    ({"regex": "(ab|cd)+x?"}, 1.0, 0.95, 5),
])
def test_constrained_generate_matches_jax(params, comps, spec, t, tp, seed):
    jcfg, tcfg = configs("f32")
    prompt = prompt_of(5, seed)
    want = jax_oracle(jcfg, params, prompt, 30, comps[0].compile(spec), t,
                      tp, seed)
    prog = comps[1].compile(spec)
    got = port_oracle(tcfg, jax.tree.map(np.asarray, params), prompt, 30,
                      prog, t, tp, seed)
    np.testing.assert_array_equal(got, want)
    _, done = tc.walk_tokens(prog, got)
    assert done is not None  # every one of these completes in 30 steps
    text = tc.detokenize(VOCAB, got[:done + 1])
    if "json_schema" in spec:
        assert isinstance(json.loads(text)["ok"], bool)
    elif "choices" in spec:
        assert text in spec["choices"]
    else:
        assert re.fullmatch(spec["regex"], text)
    with pytest.raises(ValueError, match="top_p requires"):
        tc.constrained_generate(tcfg, jax.tree.map(np.asarray, params),
                                prompt, 4, program=prog, top_p=0.9,
                                device="cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def engine_requests(comp):
    """(prompt, steps, temperature, top_p, seed, program) by name."""
    return {
        "free_a": (prompt_of(5, 1), 10, 0.0, None, 0, None),
        "con_b": (prompt_of(6, 2), 10, 0.0, None, 0,
                  comp.compile({"regex": "[0-9]{2,6}"})),
        "con_c": (prompt_of(4, 3), 8, 0.8, 0.9, 11,
                  comp.compile({"choices": ["cat", "car", "dog"]})),
        "free_d": (prompt_of(7, 4), 6, 0.9, None, 5, None),
        "con_e": (prompt_of(5, 5), 12, 0.0, None, 0,
                  comp.compile({"json_schema": SCHEMA})),
        "reuse_f": (prompt_of(5, 6), 5, 0.7, None, 2,
                    comp.compile({"regex": "[0-9]{2,6}"})),
    }


SCRIPT = [("join", "free_a"), ("steps", 2), ("join", "con_b"),
          ("join", "con_c"), ("steps", 3), ("join", "free_d"),
          ("steps", 6), ("join", "con_e"), ("join", "reuse_f"),
          ("steps", 20)]


def drive(engine, reqs):
    """SCRIPT over ``engine``: each request's tokens, and each step's
    logprob rows of the live slots ((name, chosen, values, ids))."""
    owner, left, out, rows = {}, {}, {n: [] for n in reqs}, []
    for op, arg in SCRIPT:
        if op == "join":
            prompt, steps, t, tp, seed, prog = reqs[arg]
            slot = engine.join(np.asarray(prompt), num_steps=steps,
                               temperature=t, top_p=tp, seed=seed,
                               program=prog)
            assert slot is not None, arg
            owner[slot], left[slot] = arg, steps
            continue
        for _ in range(arg):
            if not owner:
                break
            toks = engine.step()
            chosen, vals, ids = engine.last_logprobs()
            rows.append([(owner[s], float(chosen[s]), vals[s].tolist(),
                          ids[s].tolist()) for s in sorted(owner)])
            for slot in list(owner):
                out[owner[slot]].append(int(toks[slot]))
                left[slot] -= 1
                if left[slot] == 0:
                    engine.retire(slot)
                    del owner[slot], left[slot]
    assert not owner, owner
    return out, rows


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g_step, w_step in zip(got, want):
        assert [r[0] for r in g_step] == [r[0] for r in w_step]
        for (name, gc, gv, gi), (_, wc, wv, wi) in zip(g_step, w_step):
            assert gi == wi, name
            np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-5)
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode,jax_attend,attend,chunk", [
    ("f32", "gather", "gather", None),
    ("f32", "pallas", "kernel", 4),
    ("kv8", "gather", "kernel", 4),
    ("int8kv8", "gather", "gather", None),
])
def test_engine_lanes_match_jax_engine_and_oracle(params, comps, mode,
                                                  jax_attend, attend, chunk):
    jcfg, tcfg = configs(mode)
    jtree, ttree = trees(mode, params)
    want, want_rows = drive(JaxEngine(
        jcfg, jtree, max_slots=4, prefill_chunk=chunk, kv_paged=True,
        kv_block=BLK, kv_attend=jax_attend, logprobs_k=K),
        engine_requests(comps[0]))
    engine = ContinuousEngine(tcfg, ttree, 4, kv_block=BLK, kv_attend=attend,
                              prefill_chunk=chunk, logprobs_k=K,
                              device="cpu")
    reqs = engine_requests(comps[1])
    got, rows = drive(engine, reqs)
    assert got == want
    assert_rows_equal(rows, want_rows)
    for name, (prompt, steps, t, tp, seed, prog) in reqs.items():
        solo = port_oracle(tcfg, ttree, prompt, steps, prog, t, tp, seed)
        np.testing.assert_array_equal(got[name], solo, err_msg=name)
        if prog is not None:
            # Every token up to the grammar's completion is legal.
            state, done = 0, None
            for i, tok in enumerate(got[name]):
                assert prog.allow[state, tok], (name, i)
                state = prog.walk(state, tok)
                if prog.complete[state]:
                    break
    # A choices lane allows 2 tokens at its start, fewer than K: the rows
    # hold a tie at -1e30 and the ids of the tie follow JAX's order.
    assert any(name == "con_c" and vals[-1] < -1e29
               for step in rows for name, _, vals, _ in step)
    dbg = engine.constrain_debug()
    assert dbg["slots_constrained"] == 0 and dbg["logprobs_k"] == K
    assert engine._fsm.dtype == torch.int32 and not engine._fsm.any()


def test_program_churn_evicts_as_jax(params, comps):
    """A different program joins and retires each round through a pool of
    12 rows (evictions), beside a long free lane: tokens and
    constrain_debug() as JAX's engine, and each lane its oracle's."""
    jcfg, tcfg = configs("f32")
    ttree = jax.tree.map(np.asarray, params)
    specs = [{"regex": "[0-9]{2,4}"}, {"choices": ["cat", "car", "dog"]},
             {"regex": "[A-Z]{1,3}"}, {"regex": "[0-9]{2,4}"},
             {"regex": "(ab|cd)+x?"}]
    results = []
    for comp, make in ((comps[0], lambda: JaxEngine(
            jcfg, params, max_slots=2, kv_paged=True, kv_block=BLK,
            constrain_rows=12)), (comps[1], lambda: ContinuousEngine(
                tcfg, ttree, 2, kv_block=BLK, constrain_rows=12,
                device="cpu"))):
        engine = make()
        anchor = engine.join(np.asarray(prompt_of(4, 9)), num_steps=40)
        toks, debug = [], []
        for i, spec in enumerate(specs):
            slot = engine.join(np.asarray(prompt_of(3 + i, 20 + i)),
                               num_steps=3, program=comp.compile(spec))
            toks.append([int(engine.step()[slot]) for _ in range(3)])
            engine.retire(slot)
            debug.append(engine.constrain_debug())
        engine.retire(anchor)
        results.append((toks, debug))
    assert results[1] == results[0]
    assert results[1][1][-1]["evictions"] >= 2
    for i, spec in enumerate(specs):
        want = port_oracle(tcfg, ttree, prompt_of(3 + i, 20 + i), 3,
                           comps[1].compile(spec))
        assert results[1][0][i] == want.tolist(), spec


def test_engine_refuses_bad_logprobs_k_and_full_pool(params, comps):
    _, tcfg = configs("f32")
    ttree = jax.tree.map(np.asarray, params)
    for k in (-1, V + 1):
        with pytest.raises(ValueError, match="logprobs_k"):
            ContinuousEngine(tcfg, ttree, 2, kv_block=BLK, logprobs_k=k,
                             device="cpu")
    engine = ContinuousEngine(tcfg, ttree, 2, kv_block=BLK,
                              constrain_rows=8, device="cpu")
    a = comps[1].compile({"regex": "[0-9]{2,6}"})  # 7 states: the pool
    slot = engine.join(prompt_of(4, 1), num_steps=4, program=a)
    free0 = engine.kv_debug()["blocks_free"]
    b = comps[1].compile({"regex": "[A-Z]{1,2}"})
    # Every row live: the join requeues (None) and releases its plan.
    assert engine.join(prompt_of(4, 2), num_steps=4, program=b) is None
    assert engine.kv_debug()["blocks_free"] == free0
    assert engine.active_slots == 1 and engine.last_logprobs() is None
    engine.retire(slot)
    assert engine.join(prompt_of(4, 2), num_steps=4, program=b) is not None
    assert engine.constrain_debug()["evictions"] == 1


# ---------------------------------------------------------------------------
# the scheduler, and its replay under the supervisor
# ---------------------------------------------------------------------------

def sched_requests(cls):
    """The mixed structured traffic: constrained greedy and sampled,
    logprobs, a stop sequence, eos at an accepting state."""
    return [
        cls(prompt_of(6, 11), 20, constrain={"regex": "[0-9]{2,4}"}),
        cls(prompt_of(5, 12), 40, temperature=0.9, seed=3,
            constrain={"json_schema": SCHEMA}, logprobs=True),
        cls(prompt_of(4, 13), 12, temperature=0.8, top_p=0.9, seed=11,
            constrain={"choices": ["cat", "car", "dog"]}),
        cls(prompt_of(6, 11), 8, logprobs=True),
        cls(prompt_of(6, 14), 10, stop=["a", [5, 6]], logprobs=True),
        cls(prompt_of(3, 15), 12, eos_id=10,
            constrain={"regex": "[0-9]+"}),
    ]


def run_all(submit, reqs):
    """Submit every request from its own thread; the finished requests."""
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
    return done


def outcome(reqs):
    return [(list(r.out), r.finish_reason) for r in reqs]


@pytest.fixture(scope="module")
def jax_served(params, comps):
    sched = JaxScheduler(JaxEngine(
        configs("f32")[0], params, max_slots=4, kv_paged=True, kv_block=BLK,
        logprobs_k=K), constrainer=comps[0]).start()
    try:
        return run_all(lambda r: sched.submit_request(r, timeout=120),
                       sched_requests(JaxRequest))
    finally:
        sched.stop(timeout=60)


def assert_served_as_jax(got, want):
    assert outcome(got) == outcome(want)
    for g, w in zip(got, want):
        assert len(g.logprob_rows) == len(w.logprob_rows)
        for gr, wr in zip(g.logprob_rows, w.logprob_rows):
            assert (gr["token"], gr["top_ids"]) == (wr["token"],
                                                    wr["top_ids"])
            np.testing.assert_allclose(
                [gr["logprob"], *gr["top_logprobs"]],
                [wr["logprob"], *wr["top_logprobs"]], rtol=0, atol=1e-5)


def test_scheduler_serves_structured_traffic_as_jax(params, comps,
                                                    jax_served):
    engine = ContinuousEngine(configs("f32")[1],
                              jax.tree.map(np.asarray, params), 4,
                              kv_block=BLK, logprobs_k=K, device="cpu")
    sched = ContinuousScheduler(engine, constrainer=comps[1]).start()
    try:
        got = run_all(lambda r: sched.submit_request(r, timeout=120),
                      sched_requests(ServeRequest))
        snap = sched.debug_snapshot()
    finally:
        sched.stop(timeout=60)
    assert_served_as_jax(got, jax_served)
    assert [r.finish_reason for r in got[:4]] == ["grammar_complete"] * 3 \
        + ["length"]
    assert tc.detokenize(VOCAB, got[0].out).isdigit()
    assert isinstance(json.loads(tc.detokenize(VOCAB, got[1].out))["ok"],
                      bool)
    assert tc.detokenize(VOCAB, got[2].out) in ("cat", "car", "dog")
    # Greedy: each row's top id is the delivered token, its logprob the
    # top value.
    assert len(got[3].logprob_rows) == 8
    for row in got[3].logprob_rows:
        assert row["top_ids"][0] == row["token"]
        assert row["logprob"] == row["top_logprobs"][0]
    assert snap["constrain"]["slots_constrained"] == 0
    assert snap["constrain"]["compiler"] == comps[1].debug()


def test_stop_sequence_trims_as_jax(params, comps, jax_served):
    """A stop taken from a free greedy stream's own tokens: the response
    is apply_stop's cut, the rows trimmed with it, in both schedulers."""
    free = [int(t) for t in jax_served[3].out]
    stop = [free[2:4]]
    results = []
    for sched in (
            JaxScheduler(JaxEngine(configs("f32")[0], params, max_slots=2,
                                   kv_paged=True, kv_block=BLK,
                                   logprobs_k=K), constrainer=comps[0]),
            ContinuousScheduler(ContinuousEngine(
                configs("f32")[1], jax.tree.map(np.asarray, params), 2,
                kv_block=BLK, logprobs_k=K, device="cpu"),
                constrainer=comps[1])):
        cls = JaxRequest if isinstance(sched, JaxScheduler) else ServeRequest
        sched.start()
        try:
            results.append(sched.submit_request(
                cls(prompt_of(6, 11), 8, stop=stop, logprobs=True),
                timeout=120))
        finally:
            sched.stop(timeout=60)
    assert_served_as_jax([results[1]], [results[0]])
    assert results[1].out == tc.apply_stop(free, [tuple(free[2:4])])
    assert results[1].finish_reason == "stop_sequence"
    assert len(results[1].logprob_rows) == len(results[1].out) == 2


def test_crash_replay_serves_structured_traffic_as_jax(params, comps,
                                                       jax_served):
    """``step_raise`` once under the supervisor: every request is replayed
    on a rebuilt engine (its stamped program re-bound, rows and walk
    restarted) and answers as the unfaulted JAX scheduler did."""
    inj = faultinject.FaultInjector("step_raise@4", seed=3)
    engines = []

    def factory():
        eng = ContinuousEngine(configs("f32")[1],
                               jax.tree.map(np.asarray, params), 4,
                               kv_block=BLK, logprobs_k=K, faults=inj,
                               device="cpu")
        eng.warmup()
        engines.append(eng)
        return eng

    comp = tc.ConstraintCompiler(VOCAB)
    sup = resilience.EngineSupervisor(
        factory, resilience=resilience.ResilienceConfig(
            watchdog_stall_s=30.0, restart_backoff_s=0.05, max_restarts=3),
        faults=inj, constrainer=comp)
    try:
        got = run_all(lambda r: sup.submit_request(r, timeout=120),
                      sched_requests(ServeRequest))
    finally:
        sup.stop(timeout=60)
    assert sup.restarts == 1 and len(engines) == 2
    assert any(r.replays for r in got)
    assert comp.compiles == 4  # one a spec: replays recompile nothing
    assert_served_as_jax(got, jax_served)
