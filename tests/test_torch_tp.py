"""Tensor-parallel serving (tf_operator_tpu_torch/serve/tp.py, the
engine's ``mesh=``, the model's Megatron layout) held against JAX on the
CPU. The port's tp world is N gloo processes; JAX's is one process over
a ``{"tp": N}`` mesh of the conftest's virtual CPU devices.

- Placement: at tp 2 and 4, rank r's slice of every leaf
  (``parallel/sharding.py`` ``shard_params_by_rules``) equals the shard
  JAX's ``shard_params_by_rules(mesh, params, param_sharding_rules())``
  puts on device r, a non-tiling leaf (GQA K/V heads fewer than tp)
  whole, as in JAX.
- The data rules of ``serve/sharding.py`` equal JAX's over a table of
  cache leaves and shapes.
- Engines: one spawn of 2 gloo ranks runs every cell of ``CELLS``
  ({paged, dense} x {one-shot, chunked}, kv8, the int8 + kv8 tree, and a
  model whose KV heads do not tile tp on the gather read) through one
  script: greedy and sampled lanes, a constrained lane, retire, slot
  reuse, and on the paged engine an exact re-join (copy-on-write) and a
  shared-prefix suffix join. Each cell is held against JAX's engine on a
  ``{"tp": 2}`` mesh: every token equal, the next-step logits of the live
  slots within ``LOGIT_TOL`` (1e-4 absolute, f32: the row-split
  projections add their partial products in another order than one
  device does), ``kv_debug`` equal. Each rank's pool holds half the KV
  bytes of a tp 1 engine when the heads tile.
- The kernel read refuses a KV head count that does not tile tp, with
  JAX's message.
- ``serve_lm --tp 2 --device cpu`` over HTTP: /generate (greedy equal to
  the port's solo ``generate`` of the same weights at tp 1), the mesh on
  /healthz and /debug/serve, one ``step_raise`` replayed by the
  supervisor through a rebuild that reaches the worker, and no process
  left after the drain.
- ``prestart``: a worker started ahead of its world is the one
  ``start_world(spawned=)`` takes (it waits at rank 0's store), builds its
  engine and reports its pool; a world of other arguments refuses it, and
  ``discard`` stops one no world took.
"""

import json
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
SLOTS, BLK = 3, 8
KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_seq_len=64)
REGEX = {"regex": "[0-9]{2,6}"}
# name -> (n_kv_heads, engine keywords, int8_decode, kv_int8)
CELLS = {
    "paged": (2, dict(kv_paged=True), False, False),
    "paged-chunked": (2, dict(kv_paged=True, prefill_chunk=4), False,
                      False),
    "dense": (2, dict(kv_paged=False), False, False),
    "dense-chunked": (2, dict(kv_paged=False, prefill_chunk=4), False,
                      False),
    "kv8": (2, dict(kv_paged=True), False, True),
    "int8kv8": (2, dict(kv_paged=True, prefill_chunk=4), True, True),
    "kv1-gather": (1, dict(kv_paged=True), False, False),
}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


def script(engine, program):
    """The cells' schedule on ``engine`` (the port's or JAX's):
    (tokens of the live slots at each step, their next-step logits, the
    slots joined, kv_debug at the end)."""
    a, b = _prompt(20, 1), _prompt(13, 2)
    d = np.concatenate([b[:, :BLK], _prompt(5, 3)], axis=1)
    live, toks, logits, slots = set(), [], [], []

    def join(p, n, **kw):
        slot = engine.join(p, num_steps=n, **kw)
        assert slot is not None
        slots.append(slot)
        live.add(slot)
        return slot

    def steps(n):
        for _ in range(n):
            out = engine.step()
            toks.append({s: int(out[s]) for s in sorted(live)})
            rows = np.asarray(engine._logits)
            logits.append(np.stack([rows[s] for s in sorted(live)]))

    sa = join(a, 10)
    sb = join(b, 30, temperature=0.8, top_p=0.9, seed=3)
    steps(3)
    engine.retire(sa)
    live.discard(sa)
    join(b, 12)   # the exact prompt again: copy-on-write, paged
    join(d, 12)   # shares b's first block: a suffix prefill, paged
    steps(5)
    engine.retire(sb)
    live.discard(sb)
    join(_prompt(9, 4), 6, program=program)
    steps(4)
    debug = engine.kv_debug()
    return toks, logits, slots, {k: v for k, v in debug.items()
                                 if not isinstance(v, dict)}


# -- the ranks' side (torch and the port only) ------------------------------


def port_cfg(kv, int8, kv8):
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(dtype=torch.float32, n_kv_heads=kv,
                             int8_decode=int8, kv_int8=kv8, **KW)


def port_tree(params, int8):
    from tf_operator_tpu_torch.models.convert import quantize_decode_params

    return quantize_decode_params(params) if int8 else params


def cells_rank(rank, world, payload):
    """Every cell on a tp world of ``world`` gloo ranks: rank 0 drives its
    engine through ``script`` (then the per-rank report), the others run
    the worker loop until rank 0 stops it; then the tp 1 engine's pool
    bytes."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel
    from tf_operator_tpu_torch.serve import constrain
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.tp import TpWorker, report, stop_workers

    mesh = create_mesh({"tp": world}, device="cpu")
    tp = TensorParallel(mesh)
    comp = constrain.ConstraintCompiler(
        constrain.default_vocab(KW["vocab_size"]))
    out = {}
    for name, (kv, kw, int8, kv8) in CELLS.items():
        cfg = port_cfg(kv, int8, kv8)
        tree = port_tree(payload[kv], int8)

        def make(mesh=mesh):
            return ContinuousEngine(cfg, tree, SLOTS, kv_block=BLK,
                                    device="cpu", mesh=mesh, **kw)

        if rank:
            TpWorker(tp, make).run()
            continue
        engine = make()
        got = script(engine, comp.compile(REGEX))
        solo = make(None)
        out[name] = {"script": got, "report": report(engine),
                     "mesh": engine.mesh_info(),
                     "solo_pool": solo.pool_bytes(),
                     "layout": layout_holds(solo._cache, engine._cache,
                                            world)}
        stop_workers(tp)
    return out


def layout_holds(full, mine, world):
    """Whether each leaf of a rank's cache ``mine`` is the tp 1 cache
    ``full``'s leaf cut as ``serve/sharding.py``'s ``cache_specs`` says:
    the model's split and the data rules are one decision."""
    from tf_operator_tpu_torch.serve.sharding import cache_specs

    specs = cache_specs(full, world)
    for lf, lm, ls in zip(full["layers"], mine["layers"], specs["layers"]):
        for name, leaf in lf.items():
            spec = ls[name] or (None,) * leaf.dim()
            want = tuple(n // world if axis == "tp" else n
                         for n, axis in zip(leaf.shape, spec))
            if tuple(lm[name].shape) != want:
                return False
    return (specs["cache_index"] == ()
            and mine["cache_index"].shape == full["cache_index"].shape)


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
            "test_torch_tp", "cells_rank",
            [rank_env(r, 2, port) for r in range(2)], payload)[0]
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

    kv, kw, int8, kv8 = CELLS[name]
    cfg = JaxConfig(dtype=jnp.float32, n_kv_heads=kv, int8_decode=int8,
                    kv_int8=kv8, **KW)
    params = jax_params(kv)
    if int8:
        params = quantize_decode_params(params)
    mesh = create_mesh({"tp": 2}, jax.devices()[:2])
    engine = JaxEngine(cfg, params, max_slots=SLOTS, kv_block=BLK,
                       mesh=mesh, **kw)
    comp = jc.ConstraintCompiler(jc.default_vocab(KW["vocab_size"]))
    return script(engine, comp.compile(REGEX))


@pytest.mark.parametrize("cell", list(CELLS))
def test_tp_engine_matches_jax_tp_engine(cell):
    got = port_results()[cell]
    toks, logits, slots, debug = got["script"]
    w_toks, w_logits, w_slots, w_debug = jax_cell(cell)
    assert slots == w_slots
    assert toks == w_toks
    for i, (a, b) in enumerate(zip(logits, w_logits)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"{cell} step {i}")
    assert debug == w_debug
    if CELLS[cell][0] == 2:  # the KV heads tile tp: half the bytes a rank
        rows = got["report"]
        assert [r["pool_bytes"] for r in rows] == [got["solo_pool"] // 2] * 2
    assert got["layout"]
    assert got["mesh"]["devices"] == 2
    assert got["mesh"]["axes"] == {"tp": 2}
    assert got["mesh"]["kv_heads_sharded"] == (CELLS[cell][0] == 2)


@pytest.mark.parametrize("tp,kv", [(2, 2), (4, 2), (4, None)])
def test_rank_slices_are_jax_device_shards(tp, kv):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules as jax_rules,
    )
    from tf_operator_tpu.parallel.mesh import create_mesh as jax_mesh
    from tf_operator_tpu.parallel.sharding import (
        shard_params_by_rules as jax_shard,
    )
    from tf_operator_tpu_torch.models.transformer import (
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        shard_params_by_rules,
        sharding_tree_by_rules,
    )

    # vocab 66 tiles tp 2 but not 4: the embedding and head stay whole.
    cfg = JaxConfig(dtype=jnp.float32, n_kv_heads=kv,
                    **dict(KW, vocab_size=66))
    params = JaxTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    placed = jax_shard(jax_mesh({"tp": tp}, jax.devices()[:tp]), params,
                       jax_rules())
    host = jax.tree.map(np.asarray, params)
    mesh = create_mesh({"tp": tp}, range(tp))
    specs = sharding_tree_by_rules(mesh, host, param_sharding_rules())
    flat_want = jax.tree_util.tree_flatten_with_path(placed)[0]
    for r in range(tp):
        mine = shard_params_by_rules(mesh, host, param_sharding_rules(),
                                     rank=r)
        for path, arr in flat_want:
            keys = [p.key for p in path]
            got, spec = mine, specs
            for k in keys:
                got, spec = got[k], spec[k]
            shard = next(s for s in arr.addressable_shards
                         if s.device == jax.devices()[r])
            np.testing.assert_array_equal(got, np.asarray(shard.data),
                                          err_msg="/".join(keys))
            assert spec == tuple(arr.sharding.spec), "/".join(keys)
    whole = specs["block_0"]["attn"]["kv" if kv else "qkv"]["kernel"]
    assert (whole == ()) == (kv is not None and kv % tp != 0)


def test_cache_data_rules_match_jax():
    from tf_operator_tpu.serve import sharding as js
    from tf_operator_tpu_torch.serve import sharding as ts

    table = [("pool_key", (9, 8, 4, 16)), ("pool_value", (9, 8, 2, 16)),
             ("cached_key", (1, 64, 4, 16)), ("cached_value", (3, 1, 64, 6,
                                                              16)),
             ("key_scale", (1, 64, 4)), ("value_scale", (3, 1, 64, 3)),
             ("pool_key_scale", (9, 8, 4)), ("pool_value_scale", (9, 8, 1)),
             ("block_table", (3, 8)), ("cache_index", (3,)),
             ("pos_index", (3,))]
    for tp in (1, 2, 4):
        for name, shape in table:
            assert ts.leaf_spec(name, shape, tp) == tuple(
                js.leaf_spec(name, shape, tp)), (name, shape, tp)
        for shape in ((4, 64), (4, 66), (4, 1, 64)):
            assert ts.logits_spec(shape, tp) == tuple(
                js.logits_spec(shape, tp)), (shape, tp)
        tree = {"layers": {"0": {n: np.zeros(s) for n, s in table[:4]}},
                "block_table": np.zeros((3, 8))}
        want = js.cache_specs(tree, tp)
        got = ts.cache_specs(tree, tp)
        assert {k: tuple(v) for k, v in want["layers"]["0"].items()} == \
            got["layers"]["0"]
        assert got["block_table"] == tuple(want["block_table"])

    class FakeMesh:
        shape = {"tp": 2}
        devices = np.zeros(2)

    assert ts.mesh_debug(FakeMesh()) == js.mesh_debug(FakeMesh())
    assert ts.mesh_debug(None) == js.mesh_debug(None) == {"devices": 1}
    assert ts.tp_size_of(FakeMesh()) == js.tp_size_of(FakeMesh()) == 2
    assert ts.tp_size_of(None) == 1


def test_kernel_read_refuses_kv_that_does_not_tile_tp():
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"tp": 2}, range(2))
    with pytest.raises(ValueError) as exc:
        TransformerConfig(n_kv_heads=1, decode=True, kv_paged=True,
                          kv_block=8, kv_num_blocks=4, kv_attend="kernel",
                          mesh=mesh, **KW)
    # JAX's message (tf_operator_tpu/ops/paged_attention.py).
    assert str(exc.value) == ("paged_attend: KV=1 does not tile tp=2 — use "
                              "kv_attend='gather' for this mesh")
    # The gather read takes it (CELLS["kv1-gather"]), and so does training
    # over a tp mesh (tests/test_torch_tp_train.py's gqa1 cell).
    assert TransformerConfig(n_kv_heads=1, decode=True, kv_paged=True,
                             kv_block=8, kv_num_blocks=4, mesh=mesh, **KW)
    assert TransformerConfig(n_kv_heads=1, mesh=mesh, **KW).mesh is mesh
    with pytest.raises(ValueError, match="must divide n_heads"):
        TransformerConfig(decode=True, mesh=create_mesh({"tp": 3},
                                                        range(3)), **KW)


# -- serve_lm --tp 2 over HTTP --------------------------------------------------

SERVE_FLAGS = ["--device", "cpu", "--train-steps", "20", "--max-seq-len",
               "64", "--kv-block", "16", "--d-model", "64", "--vocab",
               "128"]


def _call(url, path, body=None):
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _children(pid):
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def test_serve_lm_tp2_answers_replays_and_drains(tmp_path):
    from test_torch_dp import free_port

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
         "--tp", "2", "--port", str(port), "--faults", "step_raise@4",
         *SERVE_FLAGS], cwd=REPO, env=env, stdout=log,
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
        assert health["mesh_axes"] == {"tp": 2, "dp": 1}
        body = {"tokens": [[5, 6, 7, 8]], "num_steps": 8}
        first = _call(url, "/generate", body)  # the 4th step raises
        again = _call(url, "/generate", body)
        sampled = _call(url, "/generate", dict(body, temperature=0.8,
                                               seed=3))
        assert first["tokens"] == again["tokens"]
        assert len(sampled["tokens"][0]) == 8
        debug = _call(url, "/debug/serve")
        assert debug["mesh"]["devices"] == 2
        assert debug["mesh"]["axes"] == {"tp": 2}
        assert _call(url, "/healthz")["watchdog_restarts"] == 1
        # Greedy equals the port's solo generate of the same weights at
        # tp 1 (quick_train is seeded).
        cfg = TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq_len=64,
                                dtype=torch.float32)
        params = quick_train(cfg, 20, 5e-3, "cpu")
        want = generate(cfg, params, np.array([[5, 6, 7, 8]]), 8,
                        device="cpu")
        assert first["tokens"][0] == np.asarray(want)[0].tolist()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "serve.log").read_text()
    assert "serve_lm: params tp-sharded over 2 devices" in text
    assert "serve_lm: tp rank 1 pool bytes" in text
    assert "engine drained" in text
    for pid in workers:
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().split()[2] == "Z", pid


# A rank 0 that prestarts its world's worker, waits, then starts the world:
# prints the worker's pid, the world's, the pools of both ranks, the
# workers' exit codes, then whether a discarded worker was stopped and
# whether a world of other arguments refuses spawned workers.
PRESTART = """
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from tf_operator_tpu_torch.models.convert import init_params
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.serve import tp
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
cfg = TransformerConfig(dtype=torch.float32, decode=True, **eval(sys.argv[2]))
params = init_params(TransformerConfig(**eval(sys.argv[2])), 0)
kw = dict(cfg=cfg, max_slots=2, kv_block=8)
spawned = tp.prestart(2, "cpu", "gloo", timeout_s=120)
print("prestarted", [p.pid for p in spawned.procs])
time.sleep(2)
world = tp.start_world(2, "cpu", "gloo", kw, params, timeout_s=120,
                       spawned=spawned)
print("world", [p.pid for p in world.procs], spawned.taken)
spawned.discard()
engine = ContinuousEngine(params=params, device="cpu", mesh=world.mesh, **kw)
print("pools", [r["pool_bytes"] for r in tp.report(engine)])
print("codes", world.close())
other = tp.prestart(2, "cpu", "gloo", timeout_s=120)
try:
    tp.start_world(4, "cpu", "gloo", kw, params, timeout_s=120,
                   spawned=other)
except ValueError:
    print("refused", True)
other.discard()
print("discarded", [p.poll() is not None for p in other.procs])
"""


def test_prestarted_worker_joins_the_world_it_was_started_for():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", PRESTART, REPO, repr(KW)],
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("prestarted", "world",
                                              "pools", "codes", "refused",
                                              "discarded"))
    assert lines["world"] == f"{lines['prestarted']} True"
    pools = eval(lines["pools"])
    assert len(pools) == 2 and pools[0] == pools[1] > 0
    assert lines["codes"] == "[0]"
    assert lines["refused"] == "True"
    assert lines["discarded"] == "[True]"
