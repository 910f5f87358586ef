"""Speculative decoding, shipped KV, prefix pulls and the host tier under a
tp / dp mesh (tf_operator_tpu_torch/serve/engine.py's ``spec``, ``ship``
and ``export`` commands, ``serve/sharding.py``'s ``ship_specs``, and
``serve_lm`` over a mesh) held against JAX on the CPU. The port's worlds
are gloo processes; JAX's engines run in this process over meshes of the
conftest's virtual CPU devices.

- ``ship_specs`` equals JAX's on every K/V part over the leaf table of
  ``tests/test_torch_tpdp.py``; a kv8 scale part splits on its heads, as
  its pool does; ``ship_heads`` hands each tp rank its own heads.
- One spawn of 2 gloo ranks (``{"tp": 2}``) runs JAX's ``run_spec``
  cells (``tools/serve_tp_check.py``: the same config, k = 2, a draft of
  1 layer): spec/dense, spec/paged and spec/paged-kv8 through a join and
  retire walk with a greedy and a sampled lane. Every token, the slots
  and ``spec_rounds_total``, ``spec_lane_rounds_total`` and
  ``spec_tokens_total`` equal JAX's engine's on ``create_mesh({"tp":
  2})``; each round's verify logits of every accepted row within
  ``LOGIT_TOL`` (1e-4, f32) of JAX's decode-mode forward of the prompt
  and the emitted stream; each rank's draft rows hold its one KV head.
- One spawn of 4 gloo ranks (``{"tp": 2, "dp": 2}``) runs JAX's
  ``run_tpdp`` ship and tier legs: the slots fill until one dp shard
  alone has free seats, then a ``PrefillWorker`` shipment is ingested
  (and, in a second cell, a prompt restored from a ``HostTier`` after
  its spill). The hold's blocks lie in that shard's extent, the plan
  exact-hits them there with no prefill, four decoded tokens,
  ``kv_debug``, the tier counters and the prefix counters equal JAX's.
  The same world runs a spec/paged cell on this mesh (held as above:
  JAX's engine takes spec on any mesh; only its server refuses ``--dp``
  with ``--spec-k``), exports a retained prompt from each dp shard
  (verified by ``decode_shipment``, rows within ``ROW_TOL`` of JAX's
  export on the same mesh, and ingested by a meshless port engine, which
  exact-hits and decodes JAX's tokens), and JAX's refusals: an ingest
  with no free seat returns None, a shipment whose kv8 parts do not match
  the pool raises ValueError on rank 0 before any command goes out.
- ``serve_lm --tp 2 --spec-k 2 --host-tier-bytes N --device cpu
  --dist-backend gloo`` over HTTP: greedy /generate equals the port's
  solo ``speculative_generate``; a retained prompt evicted by a small
  ``--kv-pool-blocks`` spills and then restores (``tier_restores``
  moves) with its first run's tokens; ``GET /prefix/<digest>`` answers a
  payload ``decode_shipment`` verifies; a ``shipped_kv`` request whose
  round raises (``step_raise``) replays through a rebuild that ingests
  the kept shipment again, and joins shipped with no ``failed`` ingest;
  no process is left after the drain.
"""

import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
ROW_TOL = 1e-5
K, BLK, TP, DP = 2, 8, 2, 2
# tools/serve_tp_check.py's run_spec and run_tpdp config; the draft has 1
# layer.
KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_seq_len=64)
# name -> (engine keywords, kv_int8)
SPEC_CELLS = {
    "dense": (dict(kv_paged=False), False),
    "paged": (dict(kv_paged=True), False),
    "paged-kv8": (dict(kv_paged=True), True),
}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


# Joins by the number of rounds run before them: (name, prompt, steps,
# temperature, seed). JAX's run_spec walk: a greedy lane, one round, a
# sampled lane; on the dp mesh a third, greedy lane seats on the other
# shard.
SPEC_WALK = {0: [("a", _prompt(9, 1), 10, 0.0, 0)],
             1: [("b", _prompt(5, 2), 6, 0.9, 11)]}
SPEC_WALK_DP = {0: [("a", _prompt(9, 1), 10, 0.0, 0)],
                1: [("b", _prompt(5, 2), 6, 0.9, 11),
                    ("c", _prompt(12, 3), 8, 0.0, 0)]}


def spec_walk(engine, walk):
    """Drive ``engine`` (the port's or JAX's) through ``walk``: each
    request's tokens (trimmed to its budget), its whole emitted stream,
    its slot, each round's lanes (name -> (tokens emitted before the
    round, count)) and the spec counters."""
    live, streams, slots, log = {}, {}, {}, []
    budget = {}
    last = max(walk)
    for rnd in range(60):
        for name, prompt, n, temp, seed in walk.get(rnd, []):
            kw = dict(temperature=temp, seed=seed) if temp else {}
            slot = engine.join(prompt, num_steps=n, **kw)
            assert slot is not None, name
            live[slot], slots[name], budget[name] = name, slot, n
            streams[name] = []
        if not live and rnd > last:
            break
        toks, counts = engine.spec_step()
        log.append({name: (len(streams[name]), int(counts[slot]))
                    for slot, name in live.items()})
        for slot, name in list(live.items()):
            streams[name] += [int(t) for t in toks[slot, :int(counts[slot])]]
            if len(streams[name]) >= budget[name]:
                engine.retire(slot)
                del live[slot]
    tokens = {name: s[:budget[name]] for name, s in streams.items()}
    counters = (engine.spec_rounds_total, engine.spec_lane_rounds_total,
                engine.spec_tokens_total)
    return tokens, streams, slots, log, counters


def ship_walk(engine, shipment_of, source, tier=None):
    """JAX's run_tpdp ship or tier leg on ``engine``: (for the tier, the
    prompt decoded once and retired, so its entry spills), the slots
    filled until one dp shard alone has free seats, then the prompt
    landed by an ingest or a restore; the hold's blocks, whether they lie
    in the seating shard's extent, the plan's shard and prefill tokens,
    four decoded tokens, kv_debug and the tier and prefix counters."""
    prompt = _prompt(9, 21)
    if tier is not None:
        engine.host_tier = tier
        slot = engine.join(prompt, num_steps=3)
        for _ in range(3):
            engine.step()
        engine.retire(slot)
    seed = 30
    while sum(1 for i in range(DP) if engine.alloc.free_in(i)) > 1:
        seed += 1
        assert engine.join(_prompt(5, seed), num_steps=20) is not None
    target = next(i for i in range(DP) if engine.alloc.free_in(i))
    lo, hi = engine.blocks.shard_extent(target)
    if source == "ship":
        hold = engine.ingest_shipment(shipment_of(prompt), reserve_steps=4)
    else:
        hold, outcome = engine.restore_from_tier(prompt, reserve_steps=4)
        assert outcome == "ok"
    plan = engine.plan_admission(prompt, 4)
    slot = engine.join_planned(plan)
    engine.release_shipment(hold)
    out = [int(engine.step()[slot]) for _ in range(4)]
    debug = {k: v for k, v in engine.kv_debug().items()
             if not isinstance(v, dict)}
    return dict(
        blocks=list(hold.blocks), target=target,
        in_extent=all(lo <= b < hi for b in hold.blocks),
        plan=(plan.dp_shard, plan.prefill_tokens), tokens=out, debug=debug,
        tier=(engine.tier_spills, engine.tier_restores,
              engine.tier_restore_tokens),
        prefix=(engine.prefix.hits, engine.prefix.misses))


EXPORT_PROMPTS = ((_prompt(11, 41), 3), (_prompt(6, 42), 3))


def export_walk(engine):
    """Two prompts seated on the two dp shards, decoded and retired with
    retention on: each retained entry's shard, digest and first tokens."""
    from tf_operator_tpu_torch.serve.disagg import chain_digests

    engine.prefix_retain_max = 4
    out = []
    for prompt, n in EXPORT_PROMPTS:
        slot = engine.join(prompt, num_steps=n)
        toks = [int(engine.step()[slot]) for _ in range(n)]
        engine.retire(slot)
        out.append((slot // (engine.max_slots // DP),
                    chain_digests(prompt[0], BLK)[-1], toks))
    return out


# -- the ranks' side (torch and the port only) ------------------------------


def port_cfgs(kv8=False):
    from dataclasses import replace

    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(dtype=torch.float32, kv_int8=kv8, **KW)
    return cfg, replace(cfg, n_layers=1)


def _spy_verify(engine):
    """Record rank 0's verify logits (``[max_slots, k + 1, vocab]``) of
    each round, before the constraint mask (+0.0 for these lanes)."""
    seen = []
    inner = engine._lanes_forward

    def spy(model, cache, x):
        out = inner(model, cache, x)
        if model is engine._model and x.shape[1] > 1:
            seen.append(out.cpu().numpy())
        return out

    engine._lanes_forward = spy
    return seen


def _draft_shapes(engine):
    return [tuple(layer["cached_key"].shape)
            for layer in engine._draft_cache["layers"]]


def spec_rank(rank, world, payload):
    """The ``{"tp": 2}`` cells: rank 0 drives each spec engine through
    ``SPEC_WALK``, the other rank serves its commands."""
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.tp import (
        TpWorker,
        report,
        stop_workers,
        world_comm,
        world_mesh,
    )

    mesh = world_mesh(world, 1, "cpu")
    comm = world_comm(mesh)
    out = {}
    for name, (kw, kv8) in SPEC_CELLS.items():
        cfg, dcfg = port_cfgs(kv8)

        def make():
            return ContinuousEngine(
                cfg, payload["target"], 3, kv_block=BLK, device="cpu",
                mesh=mesh, spec_k=K, draft_cfg=dcfg,
                draft_params=payload["draft"], **kw)

        if rank:
            worker = TpWorker(comm, make)
            worker.run()
            out[name] = {"draft": _draft_shapes(worker.engine)}
            continue
        engine = make()
        seen = _spy_verify(engine)
        walk = spec_walk(engine, SPEC_WALK)
        out[name] = {"walk": walk, "verify": seen, "report": report(engine),
                     "draft": _draft_shapes(engine)}
        stop_workers(comm)
    return out


def tpdp_rank(rank, world, payload):
    """The ``{"tp": 2, "dp": 2}`` cells on one world: spec/paged, the ship
    and tier legs, the exports and the refusals."""
    from tf_operator_tpu_torch.serve.disagg import (
        PrefillWorker,
        decode_shipment,
    )
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.tier import HostTier
    from tf_operator_tpu_torch.serve.tp import (
        TpWorker,
        report,
        stop_workers,
        world_comm,
        world_mesh,
    )

    mesh = world_mesh(world, DP, "cpu")
    comm = world_comm(mesh)
    cfg, dcfg = port_cfgs()
    tree = payload["target"]
    cells = {
        "spec": lambda: ContinuousEngine(
            cfg, tree, 4, kv_block=BLK, device="cpu", mesh=mesh, spec_k=K,
            draft_cfg=dcfg, draft_params=payload["draft"]),
    }
    for name in ("ship", "tier", "export", "refuse"):
        cells[name] = lambda: ContinuousEngine(cfg, tree, 4, kv_block=BLK,
                                               device="cpu", mesh=mesh)
    out = {}
    if rank:
        for name, make in cells.items():
            worker = TpWorker(comm, make)
            worker.run()
            out[name] = {"draft": (_draft_shapes(worker.engine)
                                   if name == "spec" else None)}
        return out
    pw = PrefillWorker(cfg, tree, kv_block=BLK, device="cpu")

    def shipment_of(prompt):
        return decode_shipment(pw.prefill(prompt))

    engine = cells["spec"]()
    seen = _spy_verify(engine)
    walk = spec_walk(engine, SPEC_WALK_DP)
    out["spec"] = {"walk": walk, "verify": seen, "report": report(engine),
                   "draft": _draft_shapes(engine)}
    stop_workers(comm)
    for source in ("ship", "tier"):
        engine = cells[source]()
        tier = HostTier(1 << 22) if source == "tier" else None
        out[source] = ship_walk(engine, shipment_of, source, tier)
        out[source]["report"] = report(engine)
        if tier is not None:
            # Releases inside another command's section queue their
            # spills until the section closes.
            before = engine.tier_spills
            with engine._device_op("drop", (0,)):
                for slot in range(engine.max_slots):
                    engine.retire(slot)
                inside = engine.tier_spills
            out[source]["deferred"] = (before, inside, engine.tier_spills)
        stop_workers(comm)
    engine = cells["export"]()
    seated = export_walk(engine)
    exports = []
    for shard, digest, toks in seated:
        payload_ = engine.export_prefix(digest)
        shp = decode_shipment(payload_)
        # A meshless engine lands the pulled rows and decodes them.
        plain = ContinuousEngine(cfg, tree, 2, kv_block=BLK, device="cpu")
        hold = plain.ingest_shipment(shp, reserve_steps=len(toks))
        plan = plain.plan_admission(shp.tokens[None], len(toks))
        slot = plain.join_planned(plan)
        plain.release_shipment(hold)
        got = [int(plain.step()[slot]) for _ in toks]
        exports.append(dict(
            shard=shard, rows={p: {k: v.numpy() for k, v in parts.items()}
                               for p, parts in shp.rows.items()},
            logits=shp.logits, exact=plan.prefill_tokens == 0, tokens=got))
    out["export"] = {"seated": seated, "exports": exports,
                     "count": engine.prefix_exports,
                     "report": report(engine)}
    stop_workers(comm)
    engine = cells["refuse"]()
    seed = 50
    while engine.alloc.free:
        seed += 1
        assert engine.join(_prompt(5, seed), num_steps=4) is not None
    full = engine.ingest_shipment(shipment_of(_prompt(9, 61)))
    for slot in range(engine.max_slots):
        engine.retire(slot)
    pw8 = PrefillWorker(port_cfgs(kv8=True)[0], tree, kv_block=BLK,
                        device="cpu")
    seq = engine._chan.seq
    try:
        engine.ingest_shipment(decode_shipment(pw8.prefill(_prompt(9, 62))))
        error = None
    except ValueError as exc:
        error = str(exc)
    out["refuse"] = dict(full=full, error=error,
                         commands=engine._chan.seq - seq,
                         free=engine.blocks.free_blocks)
    stop_workers(comm)
    return out


# -- the test process ---------------------------------------------------------

_RESULTS = {}


def jax_trees():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )

    if "trees" not in _RESULTS:
        cfg = JaxConfig(dtype=jnp.float32, **KW)
        dcfg = JaxConfig(dtype=jnp.float32, **{**KW, "n_layers": 1})
        x = jnp.zeros((1, 8), jnp.int32)
        _RESULTS["trees"] = {
            "target": jax.tree.map(np.asarray, JaxTransformer(cfg).init(
                jax.random.PRNGKey(0), x)["params"]),
            "draft": jax.tree.map(np.asarray, JaxTransformer(dcfg).init(
                jax.random.PRNGKey(7), x)["params"])}
    return _RESULTS["trees"]


def port_results(name):
    """The spawn ``name`` (``"tp"``: 2 ranks, ``"tpdp"``: 4), run once and
    one at a time, so no more than 4 ranks run at once."""
    from test_torch_dp import free_port, rank_env, run_processes

    if name not in _RESULTS:
        fn, world = {"tp": ("spec_rank", TP),
                     "tpdp": ("tpdp_rank", TP * DP)}[name]
        port = free_port()
        _RESULTS[name] = run_processes(
            "test_torch_mesh_spec_ship", fn,
            [rank_env(r, world, port) for r in range(world)], jax_trees())
    return _RESULTS[name]


def jax_cfgs(kv8=False):
    from dataclasses import replace

    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import TransformerConfig

    cfg = TransformerConfig(dtype=jnp.float32, kv_int8=kv8, **KW)
    return cfg, replace(cfg, n_layers=1)


def jax_mesh(axes):
    import jax

    from tf_operator_tpu.parallel.mesh import create_mesh

    n = int(np.prod(list(axes.values())))
    return create_mesh(axes, jax.devices()[:n])


def jax_spec_engine(kv8, kw, mesh, slots):
    from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine

    cfg, dcfg = jax_cfgs(kv8)
    trees = jax_trees()
    return JaxEngine(cfg, trees["target"], max_slots=slots, kv_block=BLK,
                     mesh=mesh, spec_k=K, draft_cfg=dcfg,
                     draft_params=trees["draft"], **kw)


def jax_stream_logits(kv8, prompt, stream):
    """JAX's decode-mode logits of ``stream`` after ``prompt``: the prompt
    prefilled into a dense cache, then the stream as one chunk (row i
    reads every row up to ``stream[i]``'s, quantized under kv8 as the
    engine's pools hold them)."""
    from dataclasses import replace

    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        _prefill,
    )

    cfg, _ = jax_cfgs(kv8)
    model = JaxTransformer(replace(cfg, decode=True))
    params = jax_trees()["target"]
    cache, _ = _prefill(model, params, jnp.asarray(prompt))
    logits, _ = model.apply({"params": params, "cache": cache},
                            jnp.asarray([stream], jnp.int32),
                            mutable=["cache"])
    return np.asarray(logits)[0]


def check_spec(got, want, kv8, walk):
    """The port's spec walk against JAX's: tokens, slots and counters
    equal; every accepted verify row within LOGIT_TOL of JAX's."""
    tokens, streams, slots, log, counters = got["walk"]
    w_tokens, w_streams, w_slots, w_log, w_counters = want
    assert tokens == w_tokens
    assert slots == w_slots
    assert counters == w_counters
    assert log == w_log
    prompts = {name: p for joins in walk.values()
               for name, p, *_ in joins}
    refs = {name: jax_stream_logits(kv8, prompts[name], streams[name])
            for name in streams}
    assert len(got["verify"]) == len(log)
    rows = 0
    for rnd, (verify, lanes) in enumerate(zip(got["verify"], log)):
        for name, (before, count) in lanes.items():
            for j in range(count):
                np.testing.assert_allclose(
                    verify[slots[name], j], refs[name][before + j], rtol=0,
                    atol=LOGIT_TOL, err_msg=f"round {rnd} {name} row {j}")
                rows += 1
    assert rows == sum(c for lanes in log for _, c in lanes.values())


@pytest.mark.parametrize("cell", list(SPEC_CELLS))
def test_spec_tp2_matches_jax_engine(cell):
    ranks = port_results("tp")
    kw, kv8 = SPEC_CELLS[cell]
    want = spec_walk(jax_spec_engine(kv8, kw, jax_mesh({"tp": TP}), 3),
                     SPEC_WALK)
    got = ranks[0][cell]
    check_spec(got, want, kv8, SPEC_WALK)
    # Both lanes ran, one sampled; some draft token was accepted.
    assert set(got["walk"][0]) == {"a", "b"}
    assert got["walk"][4][2] > got["walk"][4][1]
    # The draft's rows: 3 slots, one of the two KV heads a rank.
    for r in range(TP):
        assert {s[0] for s in ranks[r][cell]["draft"]} == {3}
        assert {s[-2] for s in ranks[r][cell]["draft"]} == {1}
    rows = got["report"]
    assert rows[0]["spec_bytes"] > 0 and rows[1]["spec_bytes"] > 0
    assert rows[0]["paged_launches"] == rows[1]["paged_launches"]


def test_spec_tp2_dp2_matches_jax_engine():
    ranks = port_results("tpdp")
    want = spec_walk(jax_spec_engine(False, {}, jax_mesh(
        {"tp": TP, "dp": DP}), 4), SPEC_WALK_DP)
    got = ranks[0]["spec"]
    check_spec(got, want, False, SPEC_WALK_DP)
    # The lanes seat on both dp shards; each rank's draft rows are its
    # shard's 2 slots and its one KV head.
    assert {s // 2 for s in got["walk"][2].values()} == {0, 1}
    for r in range(TP * DP):
        assert {(s[0], s[-2]) for s in ranks[r]["spec"]["draft"]} == {(2, 1)}


def jax_shipment_of(prompt):
    from tf_operator_tpu.serve.disagg import PrefillWorker, decode_shipment

    cfg, _ = jax_cfgs()
    pw = PrefillWorker(cfg, jax_trees()["target"], kv_block=BLK)
    return decode_shipment(pw.prefill(prompt))


def jax_plain_engine(mesh, slots=4):
    from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine

    return JaxEngine(jax_cfgs()[0], jax_trees()["target"], max_slots=slots,
                     kv_block=BLK, mesh=mesh)


@pytest.mark.parametrize("source", ["ship", "tier"])
def test_ingest_lands_on_the_seating_shard_as_jax(source):
    from tf_operator_tpu.serve.tier import HostTier

    got = port_results("tpdp")[0][source]
    tier = HostTier(1 << 22) if source == "tier" else None
    want = ship_walk(jax_plain_engine(jax_mesh({"tp": TP, "dp": DP})),
                     jax_shipment_of, source, tier)
    report = got.pop("report")
    if source == "tier":
        before, inside, after = got.pop("deferred")
        assert inside == before and after > before
    assert got["in_extent"] and got["plan"] == (got["target"], 0)
    assert got == want
    if source == "tier":
        assert got["tier"][0] >= 1 and got["tier"][1] == 1
    # Only the seating shard's ranks took the rows: every rank counted
    # the command's payload.
    assert all(r["ship_bytes"] > 0 for r in report)


def test_export_from_each_shard_as_jax():
    from tf_operator_tpu.serve.disagg import decode_shipment as jdecode

    got = port_results("tpdp")[0]["export"]
    engine = jax_plain_engine(jax_mesh({"tp": TP, "dp": DP}))
    seated = export_walk(engine)
    assert got["seated"] == seated
    assert sorted(s for s, _, _ in seated) == [0, 1]
    assert got["count"] == len(seated)
    for (shard, digest, toks), mine in zip(seated, got["exports"]):
        want = jdecode(engine.export_prefix(digest))
        assert mine["shard"] == shard and mine["exact"]
        assert mine["tokens"] == toks
        assert set(mine["rows"]) == set(want.rows)
        for path, parts in want.rows.items():
            assert set(mine["rows"][path]) == set(parts)
            for part, arr in parts.items():
                np.testing.assert_allclose(
                    mine["rows"][path][part], np.asarray(arr), rtol=0,
                    atol=ROW_TOL, err_msg=f"shard {shard} {path}:{part}")
        np.testing.assert_allclose(mine["logits"], want.logits, rtol=0,
                                   atol=LOGIT_TOL)
    # Shard 1's rows reached rank 0 over the dp leaders; shard 0's ranks
    # gathered their heads over tp.
    assert all(r["export_bytes"] > 0 for r in got["report"])


def test_ingest_refusals_as_jax():
    got = port_results("tpdp")[0]["refuse"]
    engine = jax_plain_engine(jax_mesh({"tp": TP, "dp": DP}))
    seed = 50
    while engine.alloc.free:
        seed += 1
        assert engine.join(_prompt(5, seed), num_steps=4) is not None
    assert engine.ingest_shipment(jax_shipment_of(_prompt(9, 61))) is None
    assert got["full"] is None
    for slot in range(engine.max_slots):
        engine.retire(slot)
    from tf_operator_tpu.serve.disagg import PrefillWorker, decode_shipment

    pw8 = PrefillWorker(jax_cfgs(kv8=True)[0], jax_trees()["target"],
                        kv_block=BLK)
    with pytest.raises(ValueError, match="kv-int8 pools require") as exc:
        engine.ingest_shipment(decode_shipment(pw8.prefill(_prompt(9, 62))))
    assert got["error"] is not None and "kv-int8 pools require" in got[
        "error"]
    assert str(exc.value).split(" but ")[1] == got["error"].split(" but ")[1]
    # No command reached a worker, and the blocks went back.
    assert got["commands"] == 0
    assert got["free"] == engine.blocks.free_blocks


def _wire_rows():
    """tests/test_torch_tpdp.py's leaf table as wire rows: each K/V leaf's
    rows ``[R, KV, Dh]``, each scale leaf's ``[R, KV]`` (R its leading
    dimensions' product)."""
    from test_torch_tpdp import LEAF_TABLE

    kv, scales = {}, {}
    for i, (name, shape) in enumerate(LEAF_TABLE):
        if name.endswith(("key", "value")):
            kv[f"l{i}"] = {"key" if "key" in name else "value": (
                int(np.prod(shape[:-2])),) + shape[-2:]}
        elif name.endswith("scale"):
            scales[f"l{i}"] = {"key_scale" if "key" in name
                               else "value_scale": (
                int(np.prod(shape[:-1])), shape[-1])}
    return kv, scales


def test_ship_specs_match_jax_and_cut_heads():
    from tf_operator_tpu.serve import sharding as js
    from tf_operator_tpu_torch.serve import sharding as ts

    kv, scales = _wire_rows()
    assert len(kv) == 5 and len(scales) == 4
    for tp in (1, 2, 3, 4):
        want = js.ship_specs(kv, tp)
        assert ts.ship_specs(kv, tp) == {
            p: {k: tuple(v) for k, v in parts.items()}
            for p, parts in want.items()}, tp
        # A scale row splits on its heads, as its pool leaf does.
        for path, parts in ts.ship_specs(scales, tp).items():
            for part, spec in parts.items():
                heads = scales[path][part][1]
                assert spec == ((None, "tp") if tp > 1 and heads % tp == 0
                                else ()), (path, tp)
    k = torch.arange(8 * 4 * 2).reshape(8, 4, 2)
    ks = torch.arange(8 * 4).reshape(8, 4).float()
    kv1 = torch.zeros(8, 1, 2)
    for r in range(2):
        cut = ts.ship_heads({"p": {"key": k, "key_scale": ks,
                                   "value": kv1}}, 2, r)["p"]
        assert torch.equal(cut["key"], k[:, 2 * r:2 * r + 2])
        assert torch.equal(cut["key_scale"], ks[:, 2 * r:2 * r + 2])
        assert cut["value"] is kv1  # one KV head does not tile: whole


# -- serve_lm --tp 2 --spec-k 2 --host-tier-bytes over HTTP -------------------

SERVE_FLAGS = ["--device", "cpu", "--dist-backend", "gloo", "--train-steps",
               "20", "--max-seq-len", "64", "--kv-block", "16", "--d-model",
               "64", "--vocab", "128", "--max-batch", "4",
               "--kv-pool-blocks", "6", "--host-tier-bytes",
               str(64 << 20)]


def _metric(text, family, outcome):
    for line in text.splitlines():
        if line.startswith(f'{family}{{outcome="{outcome}"}}'):
            return float(line.split()[-1])
    return 0.0


def test_serve_lm_tp2_spec_tier_ship_over_http(tmp_path):
    from dataclasses import replace

    from test_torch_dp import free_port
    from test_torch_tp import _call, _children

    from tf_operator_tpu_torch.models.spec_decode import speculative_generate
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.serve.disagg import (
        PrefillWorker,
        chain_digests,
        decode_shipment,
    )
    from tf_operator_tpu_torch.serve.serve_lm import quick_train

    port = free_port()
    log = open(tmp_path / "serve.log", "w")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve.serve_lm",
         "--tp", "2", "--spec-k", "2", "--port", str(port), "--faults",
         "step_raise@3", *SERVE_FLAGS], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    cfg = TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                            n_layers=2, d_ff=128, max_seq_len=64,
                            dtype=torch.float32)
    dcfg = replace(cfg, n_layers=1)
    params = quick_train(cfg, 20, 5e-3, "cpu")
    dparams = quick_train(dcfg, 20, 5e-3, "cpu")

    def solo(prompt):
        out, _ = speculative_generate(cfg, params, dcfg, dparams,
                                      np.array([prompt], np.int32), 8, k=2,
                                      device="cpu")
        return np.asarray(out)[0].tolist()

    def gen(prompt, **extra):
        body = {"tokens": [prompt], "num_steps": 8, "timing": True, **extra}
        return _call(url, "/generate", body)

    try:
        deadline = time.monotonic() + 180
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()
            try:
                _call(url, "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        workers = _children(proc.pid)
        assert len(workers) == 1
        # A shipped request first: its third round raises, the supervisor
        # rebuilds the engine (the worker's too) and the replay ingests the
        # kept shipment again on the new engine.
        pw = PrefillWorker(cfg, params, kv_block=16, device="cpu")
        ship_prompt = [40, 41, 42, 43, 44]
        shipped = gen(ship_prompt, shipped_kv=pw.prefill(
            np.array([ship_prompt])))
        assert shipped["timing"][0]["shipped_kv"] is True
        assert shipped["tokens"][0] == solo(ship_prompt)
        assert _call(url, "/healthz")["watchdog_restarts"] == 1
        text = urllib.request.urlopen(url + "/metrics", timeout=60).read(
        ).decode()
        family = "tpu_serve_kv_ship_ingest_total"
        assert _metric(text, family, "ok") == 2
        assert _metric(text, family, "failed") == 0
        first = gen([5, 6, 7, 8])
        assert first["tokens"][0] == solo([5, 6, 7, 8])
        # Six more prompts: each completed prompt keeps one of the 5
        # allocatable blocks, so the oldest retained give way and spill,
        # [5, 6, 7, 8] among them.
        prompts = [[9 + i, 10 + i, 11 + i, 12 + i] for i in range(6)]
        for p in prompts:
            assert gen(p)["tokens"][0] == solo(p)
        health = _call(url, "/healthz")
        digest = chain_digests(np.array([5, 6, 7, 8], np.int32), 16)[-1]
        assert digest in health.get("tier_prefixes", [])
        debug = _call(url, "/debug/serve")
        restores = debug["kv_cache"]["tier"]["restores"]
        again = gen([5, 6, 7, 8])
        assert again["tokens"] == first["tokens"]
        debug = _call(url, "/debug/serve")
        assert debug["kv_cache"]["tier"]["restores"] == restores + 1
        assert debug["spec"]["k"] == 2 and debug["spec"]["rounds"] > 0
        # A pull of a retained prompt: a payload decode_shipment verifies.
        last = prompts[-1]
        pulled = _call(url, "/prefix/" + chain_digests(
            np.array(last, np.int32), 16)[-1])
        shp = decode_shipment(pulled["shipment"], expect_tokens=last)
        assert shp.prompt_len == 4
        health = _call(url, "/healthz")
        assert health["mesh_axes"] == {"tp": 2, "dp": 1}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "serve.log").read_text()
    assert "serve_lm: params tp-sharded over 2 devices" in text
    assert "tp 2 (kv head-sharded)" in text and "spec k=2" in text
    assert "engine drained" in text
    for pid in workers:
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().split()[2] == "Z", pid
