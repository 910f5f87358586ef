"""The port's ContinuousEngine (tf_operator_tpu_torch/serve/engine.py, on
the CPU in f32) held against the JAX ContinuousEngine on one schedule:
join, step, retire, slot reuse, a shared-prefix suffix join and an
exact-prefix re-join that triggers copy-on-write, with one-shot and
chunked prefill. The JAX engine reads the pool in ``gather`` mode and in
Pallas interpret mode; the port in ``gather`` and ``kernel`` mode (its
plain version on the CPU). Greedy tokens must be identical at every
step, and the block accounting (``kv_debug``) must match after every
phase. Then JAX's own exactness matrix (tests/test_serve_engine.py:
greedy, sampled and nucleus requests over an occupancy walk): each
request's tokens equal JAX's solo ``generate`` for its seed, bit for bit,
under both reads and both prefill modes. Weights are the JAX init's,
converted by models/convert.py."""

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
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu_torch.models.convert import init_params
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.parallel import mesh as port_mesh
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from test_serve_engine import (
    CFG as MATRIX_CFG,
    MATRIX_REQS,
    MATRIX_SCRIPT,
    drive,
    solo,
)

torch.set_num_threads(1)

BLK, SLOTS = 8, 3
KV_KEYS = ("blocks_used", "blocks_shared", "blocks_free", "prefix_hits",
           "prefix_entries", "cow_copies", "prefill_tokens_saved")
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=64)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


def _schedule(engine):
    """Drive ``engine`` and return (slots joined, tokens of the active
    slots at every step, kv_debug after every phase)."""
    a, b = _prompt(20, 1), _prompt(13, 2)
    d = np.concatenate([b[:, :BLK], _prompt(5, 3)], axis=1)
    slots, toks, debug = [], [], []
    active = set()

    def steps(n):
        for _ in range(n):
            out = engine.step()
            toks.append({s: int(out[s]) for s in sorted(active)})
        debug.append({k: engine.kv_debug()[k] for k in KV_KEYS})

    def join(p, n):
        slot = engine.join(p, num_steps=n)
        slots.append(slot)
        active.add(slot)

    def retire(slot):
        engine.retire(slot)
        active.discard(slot)

    join(a, 10)
    join(b, 30)
    steps(3)
    retire(slots[0])
    join(b, 12)   # exact prompt, partial last block: CoW; reuses slot 0
    join(d, 12)   # shares b's first block: suffix prefill
    steps(5)
    retire(slots[1])
    join(_prompt(9, 4), 6)  # slot 1 again, after its blocks were freed
    steps(4)
    return slots, toks, debug


@pytest.mark.parametrize("n_kv_heads,jax_attend,torch_attend", [
    (2, "gather", "gather"),
    (2, "pallas", "kernel"),
    (None, "gather", "kernel"),
])
def test_engine_matches_jax_engine(n_kv_heads, jax_attend, torch_attend):
    jcfg = JaxConfig(dtype=jnp.float32, n_kv_heads=n_kv_heads, **KW)
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    want = _schedule(JaxEngine(jcfg, params, max_slots=SLOTS,
                               kv_paged=True, kv_block=BLK,
                               kv_attend=jax_attend))
    tcfg = TransformerConfig(dtype=torch.float32, n_kv_heads=n_kv_heads,
                             **KW)
    got = _schedule(ContinuousEngine(
        tcfg, jax.tree.map(np.asarray, params), SLOTS, kv_block=BLK,
        kv_attend=torch_attend, device="cpu"))
    assert got[0] == want[0] == [0, 1, 0, 2, 1]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[2][-2]["cow_copies"] == 1 and got[2][-2]["prefix_hits"] == 2


def _engine(**kw):
    cfg = TransformerConfig(dtype=torch.float32, n_kv_heads=2, **KW)
    return ContinuousEngine(cfg, init_params(cfg, 0), SLOTS,
                            **{"kv_block": BLK, "device": "cpu", **kw})


@pytest.mark.parametrize("prefill_chunk", [None, 4])
@pytest.mark.parametrize("attend", ["gather", "kernel"])
def test_engine_matrix_equals_jax_solo_generate(attend, prefill_chunk):
    """JAX's tentpole pin, ported: every request of the occupancy walk,
    greedy, sampled and nucleus, gives JAX's solo generate tokens for its
    seed, bit for bit."""
    params = JaxTransformer(MATRIX_CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig(
        dtype=torch.float32, **{k: getattr(MATRIX_CFG, k) for k in (
            "vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
            "max_seq_len")})
    engine = ContinuousEngine(cfg, jax.tree.map(np.asarray, params), 4,
                              kv_block=8, kv_attend=attend,
                              prefill_chunk=prefill_chunk, device="cpu")
    got = drive(engine, MATRIX_REQS, MATRIX_SCRIPT)
    for name, (prompt, steps, t, tp, seed) in MATRIX_REQS.items():
        want = solo(params, prompt, steps, temperature=t, top_p=tp,
                    seed=seed)
        np.testing.assert_array_equal(np.asarray(got[name]), want,
                                      err_msg=name)


def test_chunked_prefill_engine_matches_jax_engine():
    """The schedule with prefill_chunk=4 on both sides: chunked prompt
    prefills and the chunked suffix prefill on a seeded cache."""
    jcfg = JaxConfig(dtype=jnp.float32, n_kv_heads=2, **KW)
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    want = _schedule(JaxEngine(jcfg, params, max_slots=SLOTS,
                               kv_paged=True, kv_block=BLK,
                               prefill_chunk=4))
    tcfg = TransformerConfig(dtype=torch.float32, n_kv_heads=2, **KW)
    got = _schedule(ContinuousEngine(
        tcfg, jax.tree.map(np.asarray, params), SLOTS, kv_block=BLK,
        kv_attend="kernel", prefill_chunk=4, device="cpu"))
    assert got == want
    assert got[2][-2]["prefix_hits"] == 2


@pytest.mark.parametrize("kw,msg", [
    (dict(temperature=0.7, top_p=0.0), r"must be in \(0, 1\]"),
    (dict(temperature=0.7, top_p=1.5), r"must be in \(0, 1\]"),
    (dict(top_p=0.9), "requires temperature > 0"),
])
def test_join_rejects_bad_sampling_before_any_state(kw, msg):
    engine = _engine()
    with pytest.raises(ValueError, match=msg):
        engine.join(_prompt(5, 0), num_steps=4, **kw)
    plan = engine.plan_admission(_prompt(5, 0), 4)
    with pytest.raises(ValueError, match=msg):
        engine.join_planned(plan, **kw)
    assert plan.settled
    assert engine.kv_debug()["blocks_used"] == 0
    assert engine.active_slots == 0 and not engine._active.any()
    # A sampled join is taken.
    assert engine.join(_prompt(5, 0), num_steps=4, temperature=0.7,
                       top_p=0.9, seed=3) == 0


def test_greedy_steps_skip_the_sampler():
    """The sampler runs only while a live lane samples: a greedy lane
    alone leaves the step indices where they are."""
    engine = _engine()
    engine.join(_prompt(5, 0), num_steps=6)
    engine.step()
    assert engine._stepidx.tolist() == [0] * SLOTS
    slot = engine.join(_prompt(6, 1), num_steps=6, temperature=0.8, seed=2)
    engine.step()
    engine.step()
    assert engine._stepidx[slot].item() == 2
    engine.retire(slot)
    engine.step()
    assert engine._stepidx[slot].item() == 2


def test_block_exhaustion_queues_and_release_plan_returns_blocks():
    engine = _engine(kv_blocks=5)  # 4 allocatable blocks of 8 rows
    plan = engine.plan_admission(_prompt(20, 0), 10)  # needs 4
    assert plan is not None and engine.kv_debug()["blocks_free"] == 0
    assert engine.plan_admission(_prompt(3, 1), 2) is None
    engine.release_plan(plan)
    engine.release_plan(plan)  # idempotent
    assert engine.kv_debug()["blocks_free"] == 4
    with pytest.raises(ValueError, match="KV blocks"):
        engine.validate_request(40, 10)  # 7 blocks > 4 allocatable
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        engine.validate_request(60, 10)


def test_slots_run_out_before_blocks():
    engine = _engine()
    slots = [engine.join(_prompt(4, i), num_steps=4) for i in range(SLOTS)]
    assert slots == [0, 1, 2] and engine.occupancy == 1.0
    assert engine.join(_prompt(4, 9), num_steps=4) is None
    engine.retire(1)
    assert engine.active_slots == 2
    assert engine.join(_prompt(4, 9), num_steps=4) == 1


def test_config_rejects_unported_options():
    # int8 decode (A2) is ported: both flags construct, alone and together.
    for flags in ({"kv_int8": True}, {"int8_decode": True},
                  {"kv_int8": True, "int8_decode": True}):
        assert TransformerConfig(**flags)
    # MoE (A9b) is ported, and so are data-parallel meshes (A8a); a
    # tensor-parallel mesh serves decode (A8b's first half,
    # tests/test_torch_tp.py) and training over one waits for A8b's
    # second half.
    assert TransformerConfig(moe_every_n=2).uses_moe(1)
    dp = port_mesh.create_mesh({"dp": 1}, range(1))
    assert TransformerConfig(mesh=dp).mesh is dp
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8b"):
        TransformerConfig(mesh=port_mesh.create_mesh({"tp": 2}, range(2)))
    with pytest.raises(ValueError, match="kv_paged"):
        TransformerConfig(kv_attend="kernel")
    with pytest.raises(ValueError, match="kv_attend"):
        replace(TransformerConfig(), kv_attend="pallas")
    # The engine's options reach the same checks.
    with pytest.raises(ValueError, match="kv_attend"):
        _engine(kv_attend="pallas")
    with pytest.raises(ValueError, match="multiple of kv_block"):
        _engine(kv_block=24)
