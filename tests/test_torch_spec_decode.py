"""Speculative decoding in the PyTorch port (models/spec_decode.py, the
engine's spec mode, the scheduler's windows) on the CPU in f32, held
against the JAX package on the same weights (the JAX init's, converted by
models/convert.py) and the same seeds.

- ``residual_distribution`` and the batched ``lane_accept_emit`` against
  JAX's vmapped ``lane_accept_emit`` on seeded logits and keys: accept
  decisions, tokens, counts and the next pend identical, for greedy,
  sampled, nucleus and mixed lanes.
- Solo ``speculative_generate`` against JAX's (tests/test_spec_decode.py's
  cases): a random draft, a self-draft, k = 1, batch 2 and 4, the GQA,
  kv8 and GQA + kv8 caches; greedy tokens and rounds identical and equal
  to the port's ``generate``; sampled and nucleus tokens identical for
  each seed; constrained (``program=``) equal to JAX's and, greedy, to
  ``constrained_generate``; JAX's validation messages.
- The engine on JAX's SPEC_SCRIPT/SPEC_REQS (tests/test_serve_engine.py,
  copied here): each request equal to the JAX spec engine's stream and to
  the port's solo spec stream, under both reads and both prefill modes,
  with an exact-prefix join and its copy-on-write ahead of the first
  speculative write; the kv8 pool; constrained lanes; the scheduler's
  windows (eos mid-round) and snapshot against JAX's scheduler; a
  ``step_raise`` replay equal to the unfaulted run; the admission margin;
  the kernel's row cap.
- The helpers: the dense stacked cache with a counter a lane and
  ``set_cache_index`` with a vector, against JAX's vmapped solo forward.
"""

import functools
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import spec_decode as jsd
from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    _prefill as jax_prefill,
    set_cache_index as jax_set_cache_index,
)
from tf_operator_tpu.serve import constrain as jc
from tf_operator_tpu.serve import kvcache as jkv
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu.serve.scheduler import (
    ContinuousScheduler as JaxScheduler,
    ServeRequest as JaxRequest,
)
from tf_operator_tpu_torch.models import spec_decode as tsd
from tf_operator_tpu_torch.models.convert import load_params
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _prefill,
    generate,
    set_cache_index,
)
from tf_operator_tpu_torch.ops.paged_attention import MAX_ROWS
from tf_operator_tpu_torch.random import PRNGKey
from tf_operator_tpu_torch.serve import constrain as tc
from tf_operator_tpu_torch.serve import faultinject, resilience
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.kvcache import (
    dense_insert,
    solo_cache_template,
    stack_slots,
)
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
)

torch.set_num_threads(1)

SHAPE = ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
         "max_seq_len", "n_kv_heads", "kv_int8", "int8_decode")


def port_cfg(jcfg: JaxConfig, **kw) -> TransformerConfig:
    """The port's config of a JAX one (f32)."""
    return TransformerConfig(dtype=torch.float32, **{
        k: getattr(jcfg, k) for k in SHAPE}, **kw)


def jax_init(cfg: JaxConfig, seed: int):
    return JaxTransformer(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]


def tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# solo speculative_generate (tests/test_spec_decode.py's configurations)
# ---------------------------------------------------------------------------

def small_cfg(**kw) -> JaxConfig:
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                max_seq_len=128, dtype=jnp.float32)
    base.update(kw)
    return JaxConfig(**base)


TARGET = small_cfg()
DRAFT = small_cfg(n_layers=1, d_model=16, n_heads=1, d_ff=32)


@pytest.fixture(scope="module")
def solo_params():
    return {"target": jax_init(TARGET, 0), "draft": jax_init(DRAFT, 7)}


def prompt_batch(b: int, p: int = 6) -> np.ndarray:
    return np.random.default_rng(3).integers(0, 64, (b, p)).astype(np.int32)


def both_spec(tcfg, tparams, dcfg, dparams, prompt, steps, k,
              temperature=0.0, top_p=None, seed=0, program=None):
    """(JAX's tokens and rounds, the port's) of one speculative run."""
    jkw, tkw = {}, {}
    if temperature > 0:
        jkw = dict(temperature=temperature, top_p=top_p,
                   rng=jax.random.PRNGKey(seed))
        tkw = dict(temperature=temperature, top_p=top_p,
                   rng=PRNGKey(seed, "cpu"))
    want, wr = jsd.speculative_generate(
        tcfg, tparams, dcfg, dparams, jnp.asarray(prompt), steps, k=k,
        program=program[0] if program else None, **jkw)
    got, gr = tsd.speculative_generate(
        port_cfg(tcfg), tree(tparams), port_cfg(dcfg), tree(dparams),
        prompt, steps, k=k, program=program[1] if program else None,
        device="cpu", **tkw)
    return (np.asarray(want), int(wr)), (got.numpy(), gr)


@pytest.mark.parametrize("case,b,steps,k", [
    ("random draft", 1, 24, 3),
    ("batch", 4, 17, 4),
    ("self draft", 2, 19, 3),
    ("k=1", 2, 9, 1),
])
def test_greedy_speculative_generate_matches_jax(solo_params, case, b,
                                                 steps, k):
    draft = "target" if case == "self draft" else "draft"
    dcfg = TARGET if case == "self draft" else DRAFT
    prompt = prompt_batch(b)
    (want, wr), (got, gr) = both_spec(
        TARGET, solo_params["target"], dcfg, solo_params[draft], prompt,
        steps, k)
    np.testing.assert_array_equal(got, want)
    assert gr == wr
    plain = generate(port_cfg(TARGET), tree(solo_params["target"]),
                     torch.as_tensor(prompt), steps, device="cpu")
    np.testing.assert_array_equal(got, plain.numpy())
    if case == "self draft":
        assert gr == -(-(steps - 1) // (k + 1))


@pytest.mark.parametrize("t,tp,seed,b,k", [
    (0.8, None, 3, 2, 2),
    (0.8, None, 4, 1, 3),
    (0.7, 0.8, 5, 2, 3),
    (1.0, 0.95, 9, 4, 4),
])
def test_sampled_speculative_generate_matches_jax(solo_params, t, tp, seed,
                                                  b, k):
    """Sampled and nucleus runs draw JAX's bits at JAX's shapes: the same
    tokens and rounds for the same key."""
    (want, wr), (got, gr) = both_spec(
        TARGET, solo_params["target"], DRAFT, solo_params["draft"],
        prompt_batch(b), 12, k, temperature=t, top_p=tp, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert gr == wr


@pytest.mark.parametrize("variant", ["gqa", "kv8", "gqa_kv8"])
def test_cache_variants_match_jax(variant):
    kw = {}
    if "gqa" in variant:
        kw.update(n_heads=4, n_kv_heads=2)
    if "kv8" in variant:
        kw.update(kv_int8=True)
    tcfg = small_cfg(**kw)
    tparams = jax_init(small_cfg(**{k: v for k, v in kw.items()
                                    if k != "kv_int8"}), 3)
    dparams = jax_init(DRAFT, 7)
    prompt = prompt_batch(2)
    (want, wr), (got, gr) = both_spec(tcfg, tparams, DRAFT, dparams, prompt,
                                      12, 3)
    np.testing.assert_array_equal(got, want)
    assert gr == wr
    plain = generate(port_cfg(tcfg), tree(tparams), torch.as_tensor(prompt),
                     12, device="cpu")
    np.testing.assert_array_equal(got, plain.numpy())


def test_validation_messages_match_jax(solo_params):
    tp, dp = solo_params["target"], solo_params["draft"]
    cases = [
        (dict(prompt=prompt_batch(1, 100), steps=30, k=4), "speculation"),
        (dict(tcfg=replace(TARGET, int8_decode=True)), "int8_decode"),
        (dict(k=0), "k=0"),
        (dict(temperature=0.5), "rng"),
        (dict(temperature=-1.0, seed=0), "temperature"),
        (dict(temperature=0.5, top_p=1.5, seed=0), "top_p"),
        (dict(top_p=0.9), "top_p requires"),
    ]
    for kw, match in cases:
        tcfg = kw.get("tcfg", TARGET)
        prompt = kw.get("prompt", prompt_batch(1))
        steps, k = kw.get("steps", 8), kw.get("k", 2)
        t, top_p = kw.get("temperature", 0.0), kw.get("top_p")
        jrng = (jax.random.PRNGKey(0) if "seed" in kw else None)
        trng = (PRNGKey(0, "cpu") if "seed" in kw else None)
        with pytest.raises(ValueError, match=match) as want:
            jsd.speculative_generate(tcfg, tp, DRAFT, dp,
                                     jnp.asarray(prompt), steps, k=k,
                                     temperature=t, top_p=top_p, rng=jrng)
        with pytest.raises(ValueError) as got:
            tsd.speculative_generate(port_cfg(tcfg), tree(tp),
                                     port_cfg(DRAFT), tree(dp), prompt,
                                     steps, k=k, temperature=t,
                                     top_p=top_p, rng=trng, device="cpu")
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# residual_distribution and lane_accept_emit
# ---------------------------------------------------------------------------

def test_residual_distribution_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        p = rng.dirichlet(np.full(16, 0.4)).astype(np.float32)
        q = rng.dirichlet(np.full(16, 0.4)).astype(np.float32)
        got = tsd.residual_distribution(torch.as_tensor(p),
                                        torch.as_tensor(q)).numpy()
        want = np.asarray(jsd.residual_distribution(jnp.asarray(p),
                                                    jnp.asarray(q)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        accept = q * np.minimum(1.0, p / q)
        np.testing.assert_allclose(accept + (1.0 - accept.sum()) * got, p,
                                   atol=2e-6)
    got = tsd.residual_distribution(torch.as_tensor(p), torch.as_tensor(p))
    np.testing.assert_allclose(got.numpy(), p, atol=1e-6)


LANES, K, V = 8, 4, 32


def accept_inputs(seed: int):
    """Seeded verify and draft logits with the draft near the target (so
    some proposals pass and some fail), drafted tokens that follow the
    target's argmax for a random number of positions, and each lane's
    round keys."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(LANES, K + 1, V)).astype(np.float32) * 2.0
    q = (t + rng.normal(size=t.shape) * 0.7).astype(np.float32)
    drafted = rng.integers(0, V, (LANES, K + 1)).astype(np.int32)
    cut = rng.integers(0, K + 1, LANES)
    for lane in range(LANES):
        drafted[lane, :cut[lane]] = t[lane, :cut[lane]].argmax(-1)
    pend = rng.integers(0, V, LANES).astype(np.int32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 3 * LANES)
                      ).reshape(3, LANES, 2)
    return t, q, drafted, pend, keys


@pytest.mark.parametrize("mix", ["greedy", "sampled", "nucleus", "mixed"])
def test_lane_accept_emit_matches_jax(mix):
    t, q, drafted, pend, keys = accept_inputs(
        {"greedy": 1, "sampled": 2, "nucleus": 3, "mixed": 4}[mix])
    temp = np.full(LANES, {"greedy": 0.0}.get(mix, 0.9), np.float32)
    top_p = np.full(LANES, 0.8 if mix == "nucleus" else 1.0, np.float32)
    has_tp = np.full(LANES, mix == "nucleus")
    if mix == "mixed":
        temp[::2] = 0.0
        top_p[1::4], has_tp[1::4] = 0.7, True
    want = jax.vmap(functools.partial(jsd.lane_accept_emit, K))(
        jnp.asarray(t), jnp.asarray(q), jnp.asarray(drafted),
        jnp.asarray(pend), *(jnp.asarray(k) for k in keys),
        jnp.asarray(temp), jnp.asarray(top_p), jnp.asarray(has_tp))
    got = tsd.lane_accept_emit(
        K, torch.as_tensor(t), torch.as_tensor(q), torch.as_tensor(drafted),
        torch.as_tensor(pend), *(torch.as_tensor(k.astype(np.int64))
                                 for k in keys),
        torch.as_tensor(temp), torch.as_tensor(top_p),
        torch.as_tensor(has_tp))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The lanes part at different accepted counts.
    assert len(set(got[1].tolist())) > 1


# ---------------------------------------------------------------------------
# the dense stacked cache and set_cache_index with a vector
# ---------------------------------------------------------------------------

def test_lane_counters_match_jax_vmapped_forward():
    """The dense stacked cache forward with a counter a lane, a vector
    rewind and a second forward, against JAX's vmapped solo forward over
    its stacked cache: the logits within f32 rounding, the counters
    equal."""
    jcfg = small_cfg(n_heads=4, n_kv_heads=2, kv_int8=True, max_seq_len=32)
    params = jax_init(small_cfg(n_heads=4, n_kv_heads=2, max_seq_len=32), 5)
    prompts = [np.random.default_rng(i).integers(0, 64, (1, n)).astype(
        np.int32) for i, n in enumerate((5, 9, 3))]
    chunk = np.random.default_rng(9).integers(0, 64, (3, 4)).astype(np.int32)
    rewind = np.array([6, 10, 4], np.int32)

    jmodel = JaxTransformer(replace(jcfg, decode=True))
    stacked = jkv.stack_slots(jkv.solo_cache_template(jmodel), 3)
    insert = jkv.make_insert_fn()
    for i, p in enumerate(prompts):
        cache, _ = jax_prefill(jmodel, params, jnp.asarray(p))
        stacked = insert(stacked, jnp.int32(i), jkv.plain_tree(cache))

    def one(c1, x1):
        lg, upd = jmodel.apply({"params": params, "cache": c1}, x1[None],
                               mutable=["cache"])
        return jkv.plain_tree(upd["cache"]), lg[0]

    fwd = jax.jit(jax.vmap(one))
    stacked, want1 = fwd(stacked, jnp.asarray(chunk))
    stacked = jax_set_cache_index(stacked, jnp.asarray(rewind))
    stacked, want2 = fwd(stacked, jnp.asarray(chunk[:, :2]))

    model = load_params(Transformer(replace(port_cfg(jcfg), decode=True),
                                    "cpu"), tree(params))
    cache = stack_slots(solo_cache_template(model), 3)
    with torch.no_grad():
        for i, p in enumerate(prompts):
            dense_insert(cache, i, _prefill(model, torch.as_tensor(p))[0])
        got1 = model(torch.as_tensor(chunk), cache)
        assert cache["cache_index"].tolist() == [9, 13, 7]
        set_cache_index(cache, torch.as_tensor(rewind))
        got2 = model(torch.as_tensor(chunk[:, :2]), cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=2e-5)
    assert cache["cache_index"].tolist() == (rewind + 2).tolist()


def test_set_cache_index_takes_a_vector_or_a_number():
    cfg = port_cfg(small_cfg(max_seq_len=32), kv_paged=True, kv_block=8,
                   kv_num_blocks=5)
    model = Transformer(replace(cfg, decode=True), "cpu")
    for cache in (model.init_cache(3, paged=True),
                  stack_slots(solo_cache_template(model), 3)):
        set_cache_index(cache, torch.tensor([4, 0, 7]))
        assert cache["cache_index"].dtype == torch.int32
        assert cache["cache_index"].tolist() == [4, 0, 7]
        set_cache_index(cache, 2)
        assert cache["cache_index"].tolist() == [2, 2, 2]
    solo = model.init_cache(1, paged=False)
    assert set_cache_index(solo, torch.tensor(6))["cache_index"] == 6


# ---------------------------------------------------------------------------
# the engine on JAX's spec script (tests/test_serve_engine.py)
# ---------------------------------------------------------------------------

CFG = JaxConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                max_seq_len=64, dtype=jnp.float32)
DRAFT_CFG = JaxConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                      d_ff=64, max_seq_len=64, dtype=jnp.float32)
SPEC_K, BLK = 2, 8


def prompt_of(p: int, seed: int, vocab: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (1, p)).astype(np.int32)


SPEC_REQS = {
    "a": (prompt_of(6, 11), 24, 0.0, None, 0),
    "b": (prompt_of(9, 12), 6, 0.0, None, 0),
    "c": (prompt_of(4, 13), 8, 0.9, None, 11),
    "d": (prompt_of(5, 14), 5, 0.7, 0.8, 3),
    "e": (prompt_of(6, 11), 7, 0.0, None, 0),
}
SPEC_SCRIPT = [
    ("join", "a"), ("rounds", 1),
    ("join", "b"), ("join", "c"), ("rounds", 2),
    ("join", "d"), ("rounds", 12),
    ("join", "e"), ("rounds", 40),
]


def spec_drive(engine, reqs: dict, script: list) -> dict:
    """tests/test_serve_engine.py's ``spec_drive``: each ``("rounds", n)``
    runs up to n rounds, delivering each slot's window trimmed to its
    budget; a request retires the round it completes. A request may carry
    a sixth entry, its constraint program."""
    owner: dict[int, str] = {}
    out = {name: [] for name in reqs}
    for op, arg in script:
        if op == "join":
            prompt, steps, t, tp, seed, *prog = reqs[arg]
            slot = engine.join(
                prompt if isinstance(engine, ContinuousEngine)
                else jnp.asarray(prompt), num_steps=steps, temperature=t,
                top_p=tp, seed=seed, program=prog[0] if prog else None)
            assert slot is not None, f"no free slot for {arg}"
            owner[slot] = arg
        else:
            for _ in range(arg):
                if not owner:
                    break
                toks, counts = engine.spec_step()
                for slot in list(owner):
                    name = owner[slot]
                    steps = reqs[name][1]
                    for j in range(int(counts[slot])):
                        if len(out[name]) < steps:
                            out[name].append(int(toks[slot, j]))
                    if len(out[name]) >= steps:
                        engine.retire(slot)
                        del owner[slot]
    assert not owner, f"script left requests unfinished: {owner}"
    return out


@pytest.fixture(scope="module")
def engine_params():
    return jax_init(CFG, 0), jax_init(DRAFT_CFG, 7)


@pytest.fixture(scope="module")
def jax_streams(engine_params):
    """The JAX spec engine's streams on SPEC_SCRIPT (paged, gather), and
    its spec_debug."""
    engine = JaxEngine(CFG, engine_params[0], max_slots=4, kv_paged=True,
                       kv_block=BLK, spec_k=SPEC_K, draft_cfg=DRAFT_CFG,
                       draft_params=engine_params[1])
    return spec_drive(engine, SPEC_REQS, SPEC_SCRIPT), engine.spec_debug()


def port_engine(jcfg, djcfg, params, **kw) -> ContinuousEngine:
    return ContinuousEngine(
        port_cfg(jcfg), tree(params[0]), 4, kv_block=BLK, spec_k=SPEC_K,
        draft_cfg=port_cfg(djcfg), draft_params=tree(params[1]),
        device="cpu", **kw)


def solo_port(jcfg, djcfg, params, prompt, steps, t, tp, seed, prog=None):
    kw = dict(temperature=t, top_p=tp, rng=PRNGKey(seed, "cpu")) if t else {}
    toks, _ = tsd.speculative_generate(
        port_cfg(jcfg), tree(params[0]), port_cfg(djcfg), tree(params[1]),
        prompt, steps, k=SPEC_K, program=prog, device="cpu", **kw)
    return toks[0].tolist()


@pytest.mark.parametrize("prefill_chunk", [None, 4])
@pytest.mark.parametrize("attend", ["gather", "kernel"])
def test_spec_engine_matches_jax_engine_and_solo(engine_params, jax_streams,
                                                 attend, prefill_chunk):
    engine = port_engine(CFG, DRAFT_CFG, engine_params, kv_attend=attend,
                         prefill_chunk=prefill_chunk)
    got = spec_drive(engine, SPEC_REQS, SPEC_SCRIPT)
    want, want_debug = jax_streams
    assert got == want
    for name, (prompt, steps, t, tp, seed) in SPEC_REQS.items():
        assert got[name] == solo_port(CFG, DRAFT_CFG, engine_params,
                                      prompt, steps, t, tp, seed), name
        if t == 0.0:
            plain = generate(port_cfg(CFG), tree(engine_params[0]),
                             torch.as_tensor(prompt), steps, device="cpu")
            assert got[name] == plain[0].tolist(), name
    # e joined on a's registered prompt: no target prefill, and its
    # shared partial block copied before the first speculative write.
    assert engine.prefill_tokens_saved >= SPEC_REQS["a"][0].shape[1]
    assert engine.cow_copies >= 1
    assert engine.spec_debug() == want_debug


@pytest.mark.parametrize("attend", ["gather", "kernel"])
def test_spec_engine_kv8_chunked_matches_jax(engine_params, attend):
    cfg8, dcfg8 = replace(CFG, kv_int8=True), replace(DRAFT_CFG,
                                                      kv_int8=True)
    jax_engine = JaxEngine(cfg8, engine_params[0], max_slots=4,
                           kv_paged=True, kv_block=BLK, prefill_chunk=4,
                           spec_k=SPEC_K, draft_cfg=dcfg8,
                           draft_params=engine_params[1])
    want = spec_drive(jax_engine, SPEC_REQS, SPEC_SCRIPT)
    engine = port_engine(cfg8, dcfg8, engine_params, kv_attend=attend,
                         prefill_chunk=4)
    got = spec_drive(engine, SPEC_REQS, SPEC_SCRIPT)
    assert got == want
    for name, (prompt, steps, t, tp, seed) in SPEC_REQS.items():
        assert got[name] == solo_port(cfg8, dcfg8, engine_params, prompt,
                                      steps, t, tp, seed), name
    assert engine.cow_copies >= 1  # the scale pools rode the block copy


# Constrained lanes (tests/test_serve_constrain.py), identity vocabulary.
CV = 128
CCFG = replace(CFG, vocab_size=CV)
CDRAFT = replace(DRAFT_CFG, vocab_size=CV)


@pytest.fixture(scope="module")
def con_params():
    return jax_init(CCFG, 0), jax_init(CDRAFT, 7)


@pytest.fixture(scope="module")
def programs():
    """Each spec compiled by the JAX compiler and the port's: (jax, port)
    program pairs, keyed by name."""
    specs = {"digits": {"regex": "[0-9]{2,6}"},
             "animals": {"choices": ["cat", "car", "dog"]}}
    jcomp = jc.ConstraintCompiler(jc.default_vocab(CV))
    tcomp = tc.ConstraintCompiler(tc.default_vocab(CV))
    return {n: (jcomp.compile(s), tcomp.compile(s)) for n, s in specs.items()}


def test_solo_constrained_speculative_matches_jax(con_params, programs):
    """``program=``: greedy equal to JAX's and to ``constrained_generate``,
    sampled equal to JAX's."""
    prog = programs["digits"]
    pa = prompt_of(6, 11, CV)
    (want, wr), (got, gr) = both_spec(CCFG, con_params[0], CDRAFT,
                                      con_params[1], pa, 12, SPEC_K,
                                      program=prog)
    np.testing.assert_array_equal(got, want)
    assert gr == wr
    plain = tc.constrained_generate(port_cfg(CCFG), tree(con_params[0]),
                                    torch.as_tensor(pa), 12,
                                    program=prog[1], device="cpu")
    np.testing.assert_array_equal(got, plain.numpy())
    (want, _), (got, _) = both_spec(CCFG, con_params[0], CDRAFT,
                                    con_params[1], pa, 12, SPEC_K, 0.8, 0.9,
                                    5, program=prog)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attend", ["gather", "kernel"])
def test_spec_engine_constrained_lanes_match_jax(con_params, programs,
                                                 attend):
    def reqs(i):
        return {
            "free_a": (prompt_of(6, 11, CV), 12, 0.0, None, 0, None),
            "con_b": (prompt_of(6, 11, CV), 12, 0.0, None, 0,
                      programs["digits"][i]),
            "con_c": (prompt_of(4, 13, CV), 8, 0.8, 0.9, 5,
                      programs["digits"][i]),
            "con_d": (prompt_of(5, 14, CV), 6, 0.0, None, 0,
                      programs["animals"][i]),
        }

    script = [("join", "free_a"), ("rounds", 1), ("join", "con_b"),
              ("join", "con_c"), ("rounds", 2), ("join", "con_d"),
              ("rounds", 40)]
    want = spec_drive(JaxEngine(
        CCFG, con_params[0], max_slots=4, kv_paged=True, kv_block=BLK,
        spec_k=SPEC_K, draft_cfg=CDRAFT, draft_params=con_params[1]),
        reqs(0), script)
    engine = port_engine(CCFG, CDRAFT, con_params, kv_attend=attend)
    got = spec_drive(engine, reqs(1), script)
    assert got == want
    for name, (prompt, steps, t, tp, seed, prog) in reqs(1).items():
        assert got[name] == solo_port(CCFG, CDRAFT, con_params, prompt,
                                      steps, t, tp, seed, prog), name
    assert engine.constrain_debug()["slots_constrained"] == 0


def test_spec_engine_refuses_as_jax(engine_params):
    """JAX's constructor checks, with its messages."""
    tparams, dparams = engine_params
    cases = [
        (dict(spec_k=2, logprobs_k=3), "logprobs_k"),
        (dict(spec_k=-1), "spec_k=-1"),
        (dict(spec_k=2, draft_params=None), "draft_cfg and draft_params"),
        (dict(spec_k=2, draft_cfg=replace(DRAFT_CFG, int8_decode=True)),
         "int8_decode"),
        (dict(spec_k=2, draft_cfg=replace(DRAFT_CFG, max_seq_len=32)),
         "draft max_seq_len"),
    ]
    for kw, match in cases:
        dcfg = kw.pop("draft_cfg", DRAFT_CFG)
        dp = kw.pop("draft_params", dparams)
        with pytest.raises(ValueError, match=match) as want:
            JaxEngine(CFG, tparams, max_slots=2, kv_paged=True,
                      kv_block=BLK, draft_cfg=dcfg, draft_params=dp, **kw)
        with pytest.raises(ValueError) as got:
            ContinuousEngine(port_cfg(CFG), tree(tparams), 2, kv_block=BLK,
                             draft_cfg=port_cfg(dcfg),
                             draft_params=None if dp is None else tree(dp),
                             device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_spec_engine_budget_reserves_the_margin(engine_params):
    """validate_request and _block_cap add spec_margin(k) = k + 1 rows,
    with JAX's message: a rejected speculative write stays in the slot's
    own blocks."""
    engine = port_engine(CFG, DRAFT_CFG, engine_params)
    jax_engine = JaxEngine(CFG, engine_params[0], max_slots=4,
                           kv_paged=True, kv_block=BLK, spec_k=SPEC_K,
                           draft_cfg=DRAFT_CFG,
                           draft_params=engine_params[1])
    assert tsd.spec_margin(SPEC_K) == jsd.spec_margin(SPEC_K) == SPEC_K + 1
    for plen, steps in ((6, 10), (5, 3), (8, 8), (20, 36)):
        assert engine._block_cap(plen, steps) == jax_engine._block_cap(
            plen, steps) == -(-(plen + steps + SPEC_K + 1) // BLK)
    with pytest.raises(ValueError, match="speculation margin") as want:
        jax_engine.validate_request(30, 32)
    with pytest.raises(ValueError) as got:
        engine.validate_request(30, 32)
    assert str(got.value) == str(want.value)
    engine.validate_request(30, 31)
    plan = engine.plan_admission(prompt_of(7, 3), 8)
    assert len(plan.private_blocks) == -(-(7 + 8 + SPEC_K + 1) // BLK)
    engine.release_plan(plan)


def test_kernel_row_cap_raises_at_construction():
    """Under kv_attend="kernel" the verify is B4 at t = k + 1 rows a lane:
    at 16 heads over 4 KV heads k = 7 fits MAX_ROWS = 32 and k = 8 raises
    naming the cap, before any weight is loaded; the gather read takes
    any k."""
    jcfg = JaxConfig(vocab_size=64, d_model=64, n_layers=1, n_heads=16,
                     n_kv_heads=4, d_ff=64, max_seq_len=64,
                     dtype=jnp.float32)
    cfg = port_cfg(jcfg)
    with pytest.raises(ValueError, match="MAX_ROWS = 32"):
        ContinuousEngine(cfg, {}, 2, kv_block=BLK, kv_attend="kernel",
                         spec_k=8, draft_cfg=cfg, draft_params={},
                         device="cpu")
    assert MAX_ROWS == 32
    params = tree(jax_init(jcfg, 0))
    for k, attend in ((7, "kernel"), (8, "gather")):
        engine = ContinuousEngine(cfg, params, 2, kv_block=BLK,
                                  kv_attend=attend, spec_k=k, draft_cfg=cfg,
                                  draft_params=params, device="cpu")
        engine.warmup()
        slot = engine.join(prompt_of(5, 1), num_steps=4)
        toks, counts = engine.spec_step()
        assert counts[slot] == k + 1  # a self-draft accepts every proposal
        assert toks.shape == (2, k + 1)


def test_spec_engine_step_and_warmup(engine_params):
    engine = port_engine(CFG, DRAFT_CFG, engine_params)
    engine.warmup()
    assert engine.steps_total == 0 and engine.spec_debug()["rounds"] == 0
    with pytest.raises(RuntimeError, match="spec_step"):
        engine.step()
    plain = ContinuousEngine(port_cfg(CFG), tree(engine_params[0]), 2,
                             kv_block=BLK, device="cpu")
    with pytest.raises(RuntimeError, match="spec_k"):
        plain.spec_step()


# ---------------------------------------------------------------------------
# the scheduler's windows, and a replay under the supervisor
# ---------------------------------------------------------------------------

def sched_requests(cls, eos=None):
    pa, pb = prompt_of(6, 40), prompt_of(9, 41)
    reqs = [cls(pa, 10), cls(pb, 8, temperature=0.9, seed=5),
            cls(prompt_of(5, 42), 12, temperature=0.7, top_p=0.8, seed=6)]
    if eos is not None:
        reqs.append(cls(pa, 10, eos_id=eos))
    return reqs


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


@pytest.fixture(scope="module")
def jax_served(engine_params):
    sched = JaxScheduler(JaxEngine(
        CFG, engine_params[0], max_slots=3, kv_paged=True, kv_block=BLK,
        spec_k=SPEC_K, draft_cfg=DRAFT_CFG,
        draft_params=engine_params[1])).start()
    try:
        served = run_all(lambda r: sched.submit_request(r, timeout=120),
                         sched_requests(JaxRequest))
        # eos mid-stream: the fifth greedy token, delivered as the last.
        eos = served[0][0][4]
        eos_run = run_all(lambda r: sched.submit_request(r, timeout=120),
                          sched_requests(JaxRequest, eos)[3:])
        return served + eos_run, eos, sched.debug_snapshot()["spec"]
    finally:
        sched.stop(timeout=60)


def test_scheduler_serves_spec_windows_as_jax(engine_params, jax_served):
    want, eos, want_spec = jax_served
    engine = port_engine(CFG, DRAFT_CFG, engine_params)
    sched = ContinuousScheduler(engine).start()
    try:
        got = run_all(lambda r: sched.submit_request(r, timeout=120),
                      sched_requests(ServeRequest))
        got += run_all(lambda r: sched.submit_request(r, timeout=120),
                       sched_requests(ServeRequest, eos)[3:])
        snap = sched.debug_snapshot()
    finally:
        sched.stop(timeout=60)
    assert got == want
    assert got[3][0] == want[0][0][:want[0][0].index(eos) + 1]
    assert got[3][1] == "eos"
    assert snap["spec"]["k"] == SPEC_K and snap["spec"]["rounds"] > 0
    assert snap["tokens_generated"] == sum(len(o) for o, _ in got)
    # Rounds depend on which requests shared them (thread timing), so
    # only the section's keys compare.
    assert set(snap["spec"]) == set(want_spec)


def test_decode_intervals_carry_rounds(engine_params):
    from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER

    engine = port_engine(CFG, DRAFT_CFG, engine_params)
    sched = ContinuousScheduler(engine).start()
    try:
        req = sched.submit_request(ServeRequest(prompt_of(6, 40), 10),
                                   timeout=120)
    finally:
        sched.stop(timeout=60)
    spans = [s.attrs for s in SERVE_TRACER.spans("decode.interval")
             if s.attrs.get("request_id") == req.request_id]
    assert spans and sum(a["tokens"] for a in spans) == 10
    rounds = sum(a["rounds"] for a in spans)
    assert 1 <= rounds <= 10
    assert all(0.0 <= a["spec_accept_rate"] <= 1.0 for a in spans)


def test_step_raise_replay_serves_as_unfaulted(engine_params, jax_served):
    """``step_raise`` once under the supervisor: every request replays on
    a rebuilt spec engine and answers as the unfaulted JAX scheduler
    did (each lane's stream depends only on its own seed)."""
    inj = faultinject.FaultInjector("step_raise@3", seed=3)
    engines = []

    def factory():
        eng = port_engine(CFG, DRAFT_CFG, engine_params, faults=inj)
        eng.warmup()
        engines.append(eng)
        return eng

    sup = resilience.EngineSupervisor(
        factory, resilience=resilience.ResilienceConfig(
            watchdog_stall_s=30.0, restart_backoff_s=0.05, max_restarts=3),
        faults=inj)
    try:
        got = run_all(lambda r: sup.submit_request(r, timeout=120),
                      sched_requests(ServeRequest))
    finally:
        sup.stop(timeout=60)
    assert sup.restarts == 1 and len(engines) == 2
    assert got == jax_served[0][:3]
