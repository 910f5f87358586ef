"""Tensor x data parallel serving (the dp half of
tf_operator_tpu_torch/serve/sharding.py, the dp allocators and prefix
probes of serve/kvcache.py, the engine's global dp admission, serve/tp.py
over a ``{"tp": 2, "dp": 2}`` world, ``serve_lm --dp``) held against JAX
on the CPU. The port's world is gloo processes; JAX's is one process
over a mesh of the conftest's virtual CPU devices.

- Data rules: ``leaf_spec``, ``cache_specs``, ``logits_spec``,
  ``slot_spec``, ``shard_of_slot``, ``shard_block_extent`` and
  ``dp_size_of`` equal JAX's over a table of leaves, shapes and sizes
  (the cases where nothing tiles included); ``local_block`` sends entry 0
  to each shard's garbage block and every owned block inside its pool.
- Host side: JAX's and the port's ``SlotAllocator(dp=2)``,
  ``BlockAllocator(34, dp=2)``, ``PrefixCache`` (``peek``/``lookup``
  with ``within=``) and ``choose_dp_shard`` walked in lockstep through a
  seeded join and retire script: every choice, slot, block list and
  counter equal.
- The decode mesh: ``dp`` beside ``tp`` is taken; ``dcn``, ``fsdp``,
  ``sp``, ``ep`` and ``pp`` above 1 are refused naming their items.
- Engines: one spawn of 4 gloo ranks runs every cell of ``CELLS``
  (paged, paged-chunked, dense, kv8, int8 + kv8, and KV 1 on the gather
  read) through ``script``, which crosses both shards: greedy, sampled
  and constrained lanes, retire and slot reuse on each shard, an exact
  re-join (copy-on-write) and a shared-prefix suffix join within a
  shard, and a prompt whose donor sits on a full shard, which must miss
  on the shard it is seated on. Each cell is held against JAX's engine
  on ``create_mesh({"tp": 2, "dp": 2})``: every token, the slots,
  ``kv_debug`` (``dp_shards`` included) and the prefix counters equal;
  the live slots' next-step logits within ``LOGIT_TOL`` (1e-4, f32);
  every live table inside its shard's extent; each rank's cache leaves
  the shapes of JAX device r's addressable shards, but for the garbage
  block of shard 1's pool (the port folds the dense rows' batch of one
  into the slot axis).
- ``serve_lm --tp 1 --dp 2 --device cpu`` over HTTP: greedy /generate
  equal to the port's solo ``generate``, the mesh and ``dp_shards`` on
  /healthz and /debug/serve, one ``step_raise`` replayed through a
  rebuild that reaches the worker, and no process left after the drain.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-4
SLOTS, BLK, TP, DP = 4, 8, 2, 2
KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_seq_len=64)
REGEX = {"regex": "[0-9]{2,6}"}
# name -> (n_kv_heads, engine keywords, int8_decode, kv_int8)
CELLS = {
    "paged": (2, dict(kv_paged=True), False, False),
    "paged-chunked": (2, dict(kv_paged=True, prefill_chunk=4), False,
                      False),
    "dense": (2, dict(kv_paged=False), False, False),
    "kv8": (2, dict(kv_paged=True), False, True),
    "int8kv8": (2, dict(kv_paged=True, prefill_chunk=4), True, True),
    "kv1-gather": (1, dict(kv_paged=True), False, False),
}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


def _extents_hold(engine, shard_of_slot):
    """Whether every live slot's blocks lie in its dp shard's extent."""
    for slot, st in engine._slot_state.items():
        lo, hi = engine.blocks.shard_extent(shard_of_slot(slot, SLOTS, DP))
        if any(b and not lo <= b < hi for b in st["private"] + st["shared"]):
            return False
    return True


def script(engine, program, shard_of_slot):
    """The cells' schedule on ``engine`` (the port's or JAX's), over both
    dp shards: (tokens of the live slots at each step, their next-step
    logits, the slots joined, kv_debug, the prefix counters, whether every
    live table stayed in its shard's extent)."""
    a, b = _prompt(20, 1), _prompt(13, 2)
    d = np.concatenate([b[:, :BLK], _prompt(5, 3)], axis=1)
    e = np.concatenate([b[:, :BLK], _prompt(4, 5)], axis=1)
    live, toks, logits, slots, extents = set(), [], [], [], []

    def join(p, n, **kw):
        slot = engine.join(p, num_steps=n, **kw)
        assert slot is not None
        slots.append(slot)
        live.add(slot)
        if engine.kv_paged:
            extents.append(_extents_hold(engine, shard_of_slot))
        return slot

    def steps(n):
        for _ in range(n):
            out = engine.step()
            toks.append({s: int(out[s]) for s in sorted(live)})
            rows = np.asarray(engine._logits)
            logits.append(np.stack([rows[s] for s in sorted(live)]))

    def retire(slot):
        engine.retire(slot)
        live.discard(slot)

    sa = join(a, 10)
    sb = join(b, 30, temperature=0.8, top_p=0.9, seed=3)
    steps(3)
    retire(sa)
    join(b, 12)   # the exact prompt on b's shard: copy-on-write, paged
    join(d, 12)   # b's shard is full: seated on the other, a miss there
    steps(5)
    retire(sb)
    join(e, 6, program=program)  # shares b's first block on its shard
    steps(4)
    join(_prompt(9, 4), 6)
    steps(3)
    debug = {k: v for k, v in engine.kv_debug().items()
             if not isinstance(v, dict)}
    counters = ((engine.prefix.hits, engine.prefix.misses)
                if engine.kv_paged else None)
    return toks, logits, slots, debug, counters, extents


# -- the ranks' side (torch and the port only) ------------------------------


def port_cfg(kv, int8, kv8):
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(dtype=torch.float32, n_kv_heads=kv,
                             int8_decode=int8, kv_int8=kv8, **KW)


def _leaf_shapes(cache) -> dict:
    return {(i, name): tuple(leaf.shape)
            for i, layer in enumerate(cache["layers"])
            for name, leaf in layer.items()}


def cells_rank(rank, world, payload):
    """Every cell on a tp 2 x dp 2 world of gloo ranks: rank 0 drives its
    engine through ``script`` (then the per-rank report), the others run
    the worker loop until rank 0 stops it; every rank returns its cache
    leaves' shapes."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params
    from tf_operator_tpu_torch.serve import constrain
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.sharding import shard_of_slot
    from tf_operator_tpu_torch.serve.tp import (
        TpWorker,
        report,
        stop_workers,
        world_comm,
        world_mesh,
    )

    mesh = world_mesh(world, DP, "cpu")
    comm = world_comm(mesh)
    comp = constrain.ConstraintCompiler(
        constrain.default_vocab(KW["vocab_size"]))
    out = {}
    for name, (kv, kw, int8, kv8) in CELLS.items():
        cfg = port_cfg(kv, int8, kv8)
        tree = (quantize_decode_params(payload[kv]) if int8
                else payload[kv])

        def make(mesh=mesh):
            return ContinuousEngine(cfg, tree, SLOTS, kv_block=BLK,
                                    device="cpu", mesh=mesh, **kw)

        if rank:
            worker = TpWorker(comm, make)
            worker.run()
            out[name] = {"shapes": _leaf_shapes(worker.engine._cache)}
            continue
        engine = make()
        got = script(engine, comp.compile(REGEX), shard_of_slot)
        out[name] = {"script": got, "report": report(engine),
                     "mesh": engine.mesh_info(),
                     "shapes": _leaf_shapes(engine._cache)}
        stop_workers(comm)
    return out


# -- the test process ---------------------------------------------------------

_RESULTS = {}


def jax_params(kv):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )

    cfg = JaxConfig(dtype=jnp.float32, n_kv_heads=kv, **KW)
    params = JaxTransformer(cfg).init(
        jax.random.PRNGKey(kv), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def port_results():
    from test_torch_dp import free_port, rank_env, run_processes

    if "port" not in _RESULTS:
        payload = {kv: jax_params(kv) for kv in (1, 2)}
        port = free_port()
        _RESULTS["port"] = run_processes(
            "test_torch_tpdp", "cells_rank",
            [rank_env(r, TP * DP, port) for r in range(TP * DP)], payload)
    return _RESULTS["port"]


def jax_cell(name):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        quantize_decode_params,
    )
    from tf_operator_tpu.parallel.mesh import create_mesh
    from tf_operator_tpu.serve import constrain as jc
    from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
    from tf_operator_tpu.serve.sharding import shard_of_slot

    kv, kw, int8, kv8 = CELLS[name]
    cfg = JaxConfig(dtype=jnp.float32, n_kv_heads=kv, int8_decode=int8,
                    kv_int8=kv8, **KW)
    params = jax_params(kv)
    if int8:
        params = quantize_decode_params(params)
    mesh = create_mesh({"tp": TP, "dp": DP}, jax.devices()[:TP * DP])
    engine = JaxEngine(cfg, params, max_slots=SLOTS, kv_block=BLK,
                       mesh=mesh, **kw)
    comp = jc.ConstraintCompiler(jc.default_vocab(KW["vocab_size"]))
    got = script(engine, comp.compile(REGEX), shard_of_slot)
    # Device r's shard of each cache leaf, by (layer, leaf name).
    shapes = [{} for _ in range(TP * DP)]
    for path, leaf in jax.tree_util.tree_leaves_with_path(engine._cache):
        keys = [p.key for p in path]
        if not keys[0].startswith("block_") or leaf.ndim < 3:
            continue
        for r in range(TP * DP):
            shard = next(s for s in leaf.addressable_shards
                         if s.device == jax.devices()[r])
            shapes[r][(int(keys[0][6:]), keys[-1])] = tuple(
                shard.data.shape)
    return got, shapes


@pytest.mark.parametrize("cell", list(CELLS))
def test_tpdp_engine_matches_jax_tpdp_engine(cell):
    ranks = port_results()
    got = ranks[0][cell]
    toks, logits, slots, debug, counters, extents = got["script"]
    (w_toks, w_logits, w_slots, w_debug, w_counters, w_extents), \
        w_shapes = jax_cell(cell)
    assert slots == w_slots
    assert {s // (SLOTS // DP) for s in slots} == set(range(DP))
    assert toks == w_toks
    for i, (a, b) in enumerate(zip(logits, w_logits)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"{cell} step {i}")
    assert debug == w_debug
    assert counters == w_counters
    assert extents == w_extents and all(extents)
    if CELLS[cell][1]["kv_paged"]:
        assert [s["slots_free"] for s in debug["dp_shards"]] == [0, 0]
    for r in range(TP * DP):
        for key, want in w_shapes[r].items():
            have = ranks[r][cell]["shapes"][key]
            if key[1].startswith("pool"):
                # Shard 1's ranks hold a garbage block past their tile.
                want = (want[0] + (r >= TP),) + want[1:]
            else:
                # The dense rows [slots, 1, S, ...] fold the batch of one.
                want = (want[0],) + want[2:]
            assert have == want, (cell, r, key)
    assert got["mesh"]["devices"] == TP * DP
    assert got["mesh"]["axes"] == {"tp": TP, "dp": DP}
    assert (got["mesh"]["tp"], got["mesh"]["dp"]) == (TP, DP)
    rows = got["report"]
    assert len({r["pool_bytes"] for r in rows[:TP]}) == 1
    assert rows[0]["logits_bytes"] > 0


# Cache leaves and shapes the data rules are held against JAX's over
# (tests/test_torch_mesh_spec_ship.py holds ship_specs over them too).
LEAF_TABLE = [
    ("pool_key", (34, 8, 4, 16)), ("pool_value", (33, 8, 2, 16)),
    ("pool_key_scale", (34, 8, 4)), ("pool_value_scale", (34, 8, 1)),
    ("cached_key", (1, 64, 4, 16)), ("cached_value", (4, 1, 64, 4, 16)),
    ("cached_key", (3, 1, 64, 4, 16)), ("key_scale", (4, 1, 64, 4)),
    ("value_scale", (1, 64, 3)), ("block_table", (4, 8)),
    ("block_table", (3, 8)), ("cache_index", (4,)), ("pos_index", (4,)),
    ("other", (4, 4))]


def test_dp_data_rules_match_jax():
    from tf_operator_tpu.serve import sharding as js
    from tf_operator_tpu_torch.serve import sharding as ts

    table = LEAF_TABLE
    for tp in (1, 2, 4):
        for dp in (1, 2, 4):
            for pool in (False, True):
                for name, shape in table:
                    assert ts.leaf_spec(name, shape, tp, dp_size=dp,
                                        dp_pool=pool) == tuple(
                        js.leaf_spec(name, shape, tp, dp_size=dp,
                                     dp_pool=pool)), (name, shape, tp, dp)
                tree = {"a": {n: np.zeros(s) for n, s in table[:6]},
                        "block_table": np.zeros((4, 8))}
                want = js.cache_specs(tree, tp, dp_size=dp, dp_pool=pool)
                got = ts.cache_specs(tree, tp, dp_size=dp, dp_pool=pool)
                assert got == {"a": {k: tuple(v) for k, v in
                                     want["a"].items()},
                               "block_table": tuple(want["block_table"])}
            for shape in ((4, 64), (4, 66), (3, 64), (4, 1, 64), (8,)):
                assert ts.logits_spec(shape, tp, dp_size=dp) == tuple(
                    js.logits_spec(shape, tp, dp_size=dp)), (shape, tp, dp)
    for dp in (1, 2, 3, 4):
        for shape in ((4, 64), (4,), (3, 64), (12, 2, 2)):
            assert ts.slot_spec(shape, dp) == tuple(js.slot_spec(shape, dp))
        for slot in range(12):
            assert ts.shard_of_slot(slot, 12, dp) == js.shard_of_slot(
                slot, 12, dp)
        for nb in (34, 12 * dp, 12 * dp + 1):
            for i in range(dp):
                assert ts.shard_block_extent(i, nb, dp) == \
                    js.shard_block_extent(i, nb, dp)

    class FakeMesh:
        shape = {"tp": 2, "dp": 2}
        devices = np.zeros((2, 2))

    assert ts.dp_size_of(FakeMesh()) == js.dp_size_of(FakeMesh()) == 2
    assert ts.dp_size_of(None) == js.dp_size_of(None) == 1
    assert ts.mesh_debug(FakeMesh()) == js.mesh_debug(FakeMesh())


def test_local_block_lands_in_each_shards_pool():
    from tf_operator_tpu_torch.serve import sharding as ts

    nb, dp = 34, 2
    for shard in range(dp):
        lo, hi = ts.shard_block_extent(shard, nb, dp)
        size = ts.local_pool_blocks(shard, nb, dp)
        owned = ts.local_block(np.arange(lo, hi), shard, nb, dp)
        # Entry 0 -> the garbage block; owned blocks fill the rest of the
        # pool once each, never local 0.
        assert ts.local_block(0, shard, nb, dp) == 0
        assert sorted(owned.tolist()) == list(range(1, size))
        assert size == nb // dp + (1 if shard else 0)
    assert ts.local_block(np.array([0, 5, 33]), 0, nb, 1).tolist() == [0, 5,
                                                                       33]
    assert ts.local_pool_blocks(0, nb, 1) == nb


def _walk(mods, choose):
    """JAX's test_dp_occupancy_walk with prefixes: a seeded join and
    retire script over ``mods``' host classes; every decision recorded."""
    blk, dp, slots = 4, 2, 4
    salloc = mods.SlotAllocator(slots, dp=dp)
    balloc = mods.BlockAllocator(34, dp=dp)
    prefix = mods.PrefixCache(blk)
    rng = np.random.default_rng(5)
    stems = [rng.integers(0, 64, 8).astype(np.int32) for _ in range(3)]
    live, log = {}, []
    for step in range(160):
        if live and (step % 3 == 2 or salloc.free == 0):
            slot = sorted(live)[int(rng.integers(len(live)))]
            held = live.pop(slot)
            freed = balloc.free(held)
            prefix.invalidate_blocks(freed)
            salloc.release(slot)
            log.append(("retire", slot, sorted(freed)))
            continue
        stem = stems[int(rng.integers(3))]
        tokens = np.concatenate([stem[:int(rng.integers(4, 9))],
                                 rng.integers(0, 64, int(rng.integers(0, 6)))
                                 ]).astype(np.int32)
        depths = [prefix.peek(tokens, within=balloc.shard_extent(i))[0]
                  for i in range(dp)]
        shard = choose([salloc.free_in(i) for i in range(dp)],
                       [balloc.free_in(i) for i in range(dp)], depths)
        log.append(("choose", depths, shard))
        if shard is None:
            continue
        n, shared, _ = prefix.lookup(tokens,
                                     within=balloc.shard_extent(shard))
        need = -(-len(tokens) // blk) - -(-n // blk) + 1
        priv = balloc.alloc(need, shard=shard)
        log.append(("alloc", n, list(shared), priv))
        if priv is None:
            continue
        balloc.ref(shared)
        slot = salloc.acquire(shard=shard)
        table = list(shared) + priv
        prefix.register(tokens, table[:-(-len(tokens) // blk)],
                        np.zeros(3, np.float32))
        live[slot] = table
        log.append(("seat", slot, balloc.free_in(0), balloc.free_in(1),
                    balloc.used, balloc.shared, salloc.free))
    log.append(("end", prefix.hits, prefix.misses, prefix.entries,
                balloc.high_water, salloc.high_water))
    return log


def test_host_walk_matches_jax():
    from tf_operator_tpu.serve import kvcache as jk
    from tf_operator_tpu.serve.engine import choose_dp_shard as jchoose
    from tf_operator_tpu_torch.serve import kvcache as tk
    from tf_operator_tpu_torch.serve.engine import choose_dp_shard

    want = _walk(jk, jchoose)
    got = _walk(tk, choose_dp_shard)
    assert got == want
    assert sum(1 for e in got if e[0] == "seat") > 40
    assert any(e[0] == "alloc" and e[1] for e in got)  # prefix hits
    # JAX's own pins of the pieces, on the port's.
    alloc = tk.SlotAllocator(4, dp=2)
    assert alloc.acquire(shard=1) == 2 and alloc.acquire(shard=0) == 0
    assert alloc.acquire(shard=1) == 3 and alloc.acquire(shard=1) is None
    with pytest.raises(ValueError, match="dp"):
        tk.SlotAllocator(3, dp=2)
    blocks = tk.BlockAllocator(34, dp=2)
    assert [blocks.shard_extent(i) for i in range(2)] == [(1, 17), (17, 34)]
    assert blocks.alloc(17, shard=0) is None
    assert choose_dp_shard([1, 1], [16, 2], [0, 8]) == 1
    assert choose_dp_shard([1, 1], [3, 9], [4, 4]) == 1
    assert choose_dp_shard([2, 2], [8, 8], [0, 0]) == 0
    assert choose_dp_shard([0, 1], [16, 2], [99, 0]) == 1
    assert choose_dp_shard([0, 0], [16, 16], [0, 0]) is None


def test_peek_moves_no_counter_or_lru():
    from tf_operator_tpu_torch.serve.kvcache import PrefixCache

    cache = PrefixCache(4)
    a = np.arange(10, dtype=np.int32)
    b = np.arange(20, 30, dtype=np.int32)
    cache.register(a, [1, 2, 3], np.ones(3, np.float32))
    cache.register(b, [20, 21, 22], np.ones(3, np.float32))
    order = cache.advertise()
    assert cache.peek(a)[0] == 10 and cache.peek(a, within=(17, 34))[0] == 0
    assert cache.peek(b, within=(17, 34))[0] == 10
    assert (cache.hits, cache.misses, cache.advertise()) == (0, 0, order)
    assert cache.lookup(a, within=(17, 34))[0] == 0
    assert cache.lookup(a, within=(1, 17))[0] == 10
    assert (cache.hits, cache.misses) == (1, 1)
    assert cache.advertise()[0] != order[0]


@pytest.mark.parametrize("axis,item", [
    # Sequence parallelism is ported for training (A8c); a decode mesh
    # over sp keeps its refusal under its own item, A8h. FSDP and expert
    # parallelism are ported for training (A8e); JAX's engine shards
    # nothing over them, and a decode mesh over either names A8j.
    # Pipelines are ported for training (A8d); a decode mesh over pp
    # names A8k (serve_lm --from-pp merges the tree instead).
    ("dcn", "A8g"), pytest.param("fsdp", "A8j", id="fsdp-A8e"),
    pytest.param("sp", "A8h", id="sp-A8c"),
    pytest.param("ep", "A8j", id="ep-A8e"),
    pytest.param("pp", "A8k", id="pp-A8d")])
def test_decode_mesh_takes_dp_and_refuses_the_rest(axis, item):
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel import mesh as port_mesh

    m = port_mesh.create_mesh({"tp": 2, "dp": 2}, range(4))
    assert port_mesh.check_decode_mesh(m, "x") == (2, 2)
    assert TransformerConfig(decode=True, mesh=m, **KW).mesh is m
    bad = port_mesh.create_mesh({"tp": 2, axis: 2}, range(4))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        port_mesh.check_decode_mesh(bad, "x")
    with pytest.raises(NotImplementedError, match=f"{axis}=2"):
        TransformerConfig(decode=True, mesh=bad, **KW)


def test_engine_refuses_slots_dp_does_not_divide():
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    cfg = port_cfg(2, False, False)
    with pytest.raises(ValueError, match="multiple of the dp mesh axis"):
        ContinuousEngine(cfg, jax_params(2), 3, kv_block=BLK, device="cpu",
                         mesh=create_mesh({"tp": 1, "dp": 2}, range(2)))


# -- serve_lm --tp 1 --dp 2 over HTTP -------------------------------------------

SERVE_FLAGS = ["--device", "cpu", "--train-steps", "20", "--max-seq-len",
               "64", "--kv-block", "16", "--d-model", "64", "--vocab",
               "128", "--max-batch", "4"]


def test_serve_lm_dp2_answers_replays_and_drains(tmp_path):
    from test_torch_dp import free_port
    from test_torch_tp import _call, _children

    from tf_operator_tpu_torch.models.transformer import (
        TransformerConfig,
        generate,
    )
    from tf_operator_tpu_torch.serve.serve_lm import quick_train

    port = free_port()
    log = open(tmp_path / "serve.log", "w")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve.serve_lm",
         "--tp", "1", "--dp", "2", "--port", str(port), "--faults",
         "step_raise@4", *SERVE_FLAGS], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()
            try:
                health = _call(url, "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        workers = _children(proc.pid)
        assert len(workers) == 1
        assert health["mesh_devices"] == 2
        assert health["mesh_axes"] == {"tp": 1, "dp": 2}
        body = {"tokens": [[5, 6, 7, 8]], "num_steps": 8}
        first = _call(url, "/generate", body)  # the 4th step raises
        again = _call(url, "/generate", body)
        two = _call(url, "/generate", {"tokens": [[9, 10, 11, 12],
                                                  [5, 6, 7, 8]],
                                       "num_steps": 8})
        assert first["tokens"] == again["tokens"]
        assert two["tokens"][1] == first["tokens"][0]
        debug = _call(url, "/debug/serve")
        assert debug["mesh"]["devices"] == 2
        assert debug["mesh"]["axes"] == {"tp": 1, "dp": 2}
        shards = debug["kv_cache"]["dp_shards"]
        assert [s["shard"] for s in shards] == [0, 1]
        assert shards[0]["extent"][1] == shards[1]["extent"][0]
        assert _call(url, "/healthz")["watchdog_restarts"] == 1
        cfg = TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq_len=64,
                                dtype=torch.float32)
        params = quick_train(cfg, 20, 5e-3, "cpu")
        for prompt, got in (([5, 6, 7, 8], first["tokens"][0]),
                            ([9, 10, 11, 12], two["tokens"][0])):
            want = generate(cfg, params, np.array([prompt]), 8,
                            device="cpu")
            assert got == np.asarray(want)[0].tolist()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "serve.log").read_text()
    assert "serve_lm: params tp-sharded over 2 devices (tp 1 x dp 2)" in text
    assert "serve_lm: tp rank 1 pool bytes" in text
    assert "engine drained" in text
    for pid in workers:
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().split()[2] == "Z", pid
