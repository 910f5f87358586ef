"""bf16 under tensor parallelism held against JAX, stage by stage (ROADMAP
C3).

At tp 2 the row-split projections (attention ``out``, the MLP's
``out_proj``) each give a bf16 partial product on each rank, which the
port's ``DenseGeneral.forward`` sums over tp with ``TensorParallel.
reduce`` (an all-reduce of the bf16 partials, rounded to bf16) before the
bias. JAX's SPMD partitioner places its own all-reduce in the same
program. The JAX side runs in a subprocess with
``--xla_allow_excess_precision=false`` (the rounding rule of
tests/test_torch_bf16_rounding.py) over 2 virtual CPU devices on a
``{"tp": 2}`` mesh; the port's as 2 gloo ranks. Both start from JAX's
tree:

- serving: the bf16 paged engine joins ``LENGTHS`` prompts: each prompt's
  K/V rows in the pool after its prefill (the ranks' heads joined) and its
  last-position logits, then ``STEPS`` decode steps' logits of every lane
  and the greedy tokens;
- training: one bf16 step (``make_lm_train_step`` against JAX's
  ``jax.value_and_grad`` of the same loss): the loss and every leaf of the
  first step's gradient, gathered; and the same at tp 1 on both sides (the
  port's in this process).

The serving stages and the loss are held to ``test_prefill_stages``'s
limits: each stage parts on at most ``PART_SHARE`` of its elements beyond
one bf16 step of its row's rms (the K/V rows on at most ``KV_SHARE`` of
their elements at all), by at most ``MAX_STEPS`` bf16 steps of the
element, or of its row's rms where a sum cancelled. Measured: 1 of 9,344
K/V elements parts (2.5e-4 steps), the prefill logits by at most 5.3e-5
steps (their f32 sums' order), the decode logits and tokens not at all.

A bf16 gradient parts from JAX's already at tp 1 (the backward's bf16
products and sums in another order: up to ~7 bf16 steps of an element,
~1 % of a leaf's norm), and JAX's own tp 2 gradient parts from its tp 1
gradient by as much. So each leaf is held to ``GRAD_RATIO``: the port's
tp 2 gradient is within ``GRAD_RATIO`` times the larger of those two
relative L2 gaps of JAX's tp 2 gradient. Measured: at most 1.13 times
(``block_1/attn/qkv/bias``, whose gradient is rounding noise). The test
prints the stage table (``-s``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_seq_len=64)
LENGTHS = (13, 9, 21, 30)
STEPS, BLK, TRAIN_B, TRAIN_T = 3, 8, 4, 16
BF16_STEP = 2.0 ** -7
PART_SHARE, KV_SHARE, MAX_STEPS = 2e-2, 1e-3, 2.0
GRAD_RATIO = 1.5

JAX_SCRIPT = r'''
import sys

import jax
import jax.numpy as jnp
import numpy as np

from tf_operator_tpu.models.transformer import (
    Transformer, TransformerConfig, param_sharding_rules)
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.parallel.sharding import shard_params_by_rules
from tf_operator_tpu.serve.engine import ContinuousEngine
from tf_operator_tpu.train import steps as jsteps

KW, LENGTHS, STEPS, BLK, B, T = (
    {kw!r}, {lengths!r}, {steps!r}, {blk!r}, {b!r}, {t!r})
out = {{}}
mesh = create_mesh({{"tp": 2}}, jax.devices()[:2])
cfg = TransformerConfig(dtype=jnp.bfloat16, **KW)
params = Transformer(cfg).init(
    jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["param|" + "/".join(k.key for k in path)] = np.asarray(leaf)
eng = ContinuousEngine(cfg, params, max_slots=len(LENGTHS), kv_block=BLK,
                       mesh=mesh)
slots = []
for j, n in enumerate(LENGTHS):
    prompt = np.random.default_rng(40 + j).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)
    s = eng.join(prompt, num_steps=STEPS + 1)
    slots.append(s)
    out[f"prefill{{j}}"] = np.asarray(eng._logits[s].astype(jnp.float32))
    for i in range(KW["n_layers"]):
        attn = eng._cache[f"block_{{i}}"]["attn"]
        table = np.asarray(attn["block_table"][s])
        pos = np.arange(n)
        for part in ("pool_key", "pool_value"):
            pool = np.asarray(attn[part].astype(jnp.float32))
            out[f"kv{{j}}|{{i}}|{{part}}"] = pool[table[pos // BLK],
                                                 pos % BLK]
out["slots"] = np.asarray(slots)
for t in range(STEPS):
    toks = eng.step()
    out[f"tok{{t}}"] = np.asarray(toks)[slots]
    out[f"step{{t}}"] = np.asarray(eng._logits.astype(jnp.float32))[slots]

model = Transformer(TransformerConfig(dtype=jnp.bfloat16, mesh=mesh, **KW))
placed = shard_params_by_rules(mesh, params, param_sharding_rules())
chain = (np.random.default_rng(7).integers(0, KW["vocab_size"], (B, 1))
         + np.arange(T + 1)) % KW["vocab_size"]
tokens, targets = chain[:, :-1].astype(np.int32), chain[:, 1:].astype(
    np.int32)


def loss(p):
    return jsteps.cross_entropy(model.apply({{"params": p}}, tokens),
                                targets)


val, grads = jax.jit(jax.value_and_grad(loss))(placed)
model1 = Transformer(TransformerConfig(dtype=jnp.bfloat16, **KW))
val1, grads1 = jax.jit(jax.value_and_grad(
    lambda p: jsteps.cross_entropy(model1.apply({{"params": p}}, tokens),
                                   targets)))(params)
out["loss1"] = np.asarray(val1)
for path, leaf in jax.tree_util.tree_leaves_with_path(grads1):
    out["grad1|" + "/".join(k.key for k in path)] = np.asarray(leaf)
out["loss"] = np.asarray(val)
out["tokens"], out["targets"] = tokens, targets
for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
    out["grad|" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
'''


def _tree(ref, kind) -> dict:
    tree: dict = {}
    for key, val in ref.items():
        if key.startswith(kind + "|"):
            node = tree
            parts = key.split("|", 1)[1].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return tree


# -- the ranks' side (torch and the port only) ------------------------------


def c3_rank(rank, world, p):
    """The bf16 engine at tp 2 (rank 0 drives, rank 1 works), then one
    bf16 train step at tp 2: rank 0's logits and tokens, every rank's
    pool rows of each prompt, the loss and the gathered gradient."""
    from test_torch_tp_train import _whole

    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.tp import (
        TpWorker,
        stop_workers,
        world_comm,
        world_mesh,
    )
    from tf_operator_tpu_torch.train import steps

    mesh = world_mesh(world, 1, "cpu")
    comm = world_comm(mesh)
    cfg = TransformerConfig(dtype=torch.bfloat16, **KW)

    def make():
        return ContinuousEngine(cfg, p["params"], len(LENGTHS),
                                kv_block=BLK, device="cpu", mesh=mesh)

    out = {}
    if rank:
        worker = TpWorker(comm, make)
        worker.run()
        engine = worker.engine
    else:
        engine = make()
        slots, prefill, toks, logits = [], [], [], []
        for j, n in enumerate(LENGTHS):
            slot = engine.join(p["prompts"][j], num_steps=STEPS + 1)
            slots.append(slot)
            prefill.append(engine._logits[slot].float().numpy())
        for _ in range(STEPS):
            toks.append(engine.step()[slots])
            logits.append(engine._logits[slots].float().numpy())
        stop_workers(comm)
        out.update(slots=slots, prefill=prefill, toks=toks, logits=logits)
    rows = {}
    cache = engine._cache
    for j, n in enumerate(LENGTHS):
        table = cache["block_table"][j].numpy()
        pos = np.arange(n)
        for i, layer in enumerate(cache["layers"]):
            for part in ("pool_key", "pool_value"):
                rows[j, i, part] = layer[part][table[pos // BLK],
                                               pos % BLK].float().numpy()
    out["rows"] = rows

    tcfg = TransformerConfig(dtype=torch.bfloat16, mesh=mesh, **KW)
    model = load_params(Transformer(tcfg, device="cpu"), shard_params_by_rules(
        mesh, p["params"], param_sharding_rules()))
    tx = steps.adamw(1e-3)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx, mesh=mesh)
    _, m = step(state, {"tokens": p["tokens"], "targets": p["targets"]})
    out["loss"] = float(m["loss"])
    out["grads"] = _whole(model, mesh, lambda q: q.grad)
    return out


# -- the test process ---------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's arrays (a subprocess without excess precision, 2 devices) and
    the port's 2 ranks, from JAX's tree."""
    from test_torch_dp import free_port, rank_env, run_processes

    path = str(tmp_path_factory.mktemp("c3") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false "
                         "--xla_force_host_platform_device_count=2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    script = JAX_SCRIPT.format(kw=KW, lengths=LENGTHS, steps=STEPS, blk=BLK,
                               b=TRAIN_B, t=TRAIN_T)
    done = subprocess.run([sys.executable, "-c", script, path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    ref = dict(np.load(path))
    payload = {
        "params": _tree(ref, "param"),
        "prompts": [np.random.default_rng(40 + j).integers(
            0, KW["vocab_size"], (1, n)).astype(np.int32)
            for j, n in enumerate(LENGTHS)],
        "tokens": ref["tokens"], "targets": ref["targets"]}
    port = free_port()
    ranks = run_processes("test_torch_tp_bf16", "c3_rank",
                          [rank_env(r, 2, port) for r in range(2)], payload)
    return ref, ranks


def _parting(have, want):
    """(elements that differ, elements, largest difference in bf16 steps of
    the element or of its row's rms, elements beyond one step of their
    row's rms)."""
    have = np.asarray(have, np.float64).reshape(want.shape)
    want = np.asarray(want, np.float64)
    err = np.abs(have - want)
    row = np.sqrt(np.mean(want ** 2, -1, keepdims=True)) if want.ndim else \
        np.abs(want)
    steps = err / np.maximum(BF16_STEP * np.maximum(np.abs(want), row),
                             1e-30)
    beyond = err > BF16_STEP * np.maximum(row, 1e-30)
    return int((err > 0).sum()), err.size, float(steps.max()), int(
        beyond.sum())


def _rel(have, want) -> float:
    """The relative L2 gap of ``have`` from ``want``."""
    want = np.asarray(want, np.float64)
    have = np.asarray(have, np.float64).reshape(want.shape)
    return float(np.linalg.norm(have - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _port_tp1_grads(ref) -> tuple[float, dict]:
    """The port's bf16 loss and gradient at tp 1, in this process."""
    from tf_operator_tpu_torch.models.convert import flax_path, load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import steps

    model = load_params(Transformer(TransformerConfig(
        dtype=torch.bfloat16, **KW), device="cpu"), _tree(ref, "param"))
    tx = steps.adamw(1e-3)
    _, m = steps.make_lm_train_step(model, tx)(
        steps.TrainState.create(model, tx),
        {"tokens": ref["tokens"], "targets": ref["targets"]})
    return float(m["loss"]), {tuple(flax_path(n)): p.grad.float().numpy()
                              for n, p in model.named_parameters()}


def test_bf16_tp2_serving_against_jax_stage_by_stage(runs):
    ref, ranks = runs
    mine = ranks[0]
    assert mine["slots"] == ref["slots"].tolist()
    table = {}

    def add(stage, have, want):
        got = table.setdefault(stage, [0, 0, 0.0, 0])
        d, n, m, b = _parting(have, want)
        got[0] += d
        got[1] += n
        got[2] = max(got[2], m)
        got[3] += b

    for j in range(len(LENGTHS)):
        for i in range(KW["n_layers"]):
            for part in ("pool_key", "pool_value"):
                have = np.concatenate([r["rows"][j, i, part] for r in ranks],
                                      axis=1)
                add(f"prefill K/V rows ({part})", have,
                    ref[f"kv{j}|{i}|{part}"])
        add("prefill last logits", mine["prefill"][j], ref[f"prefill{j}"])
    for t in range(STEPS):
        assert mine["toks"][t].tolist() == ref[f"tok{t}"].tolist(), t
        add(f"decode step {t} logits", mine["logits"][t], ref[f"step{t}"])
    add("train loss", np.array([mine["loss"]]), ref["loss"].reshape(1))
    lines = [f"{s:30s} {d:6d} / {n:6d} differ, at most {m:.3g} bf16 steps, "
             f"{b} beyond one step of the row rms"
             for s, (d, n, m, b) in table.items()]
    for stage, (differ, count, steps, beyond) in table.items():
        if stage.startswith("prefill K/V"):
            assert differ <= KV_SHARE * count, "\n".join(lines)
        assert beyond <= PART_SHARE * count, "\n".join(lines)
        assert steps <= MAX_STEPS, "\n".join(lines)
    print("\n".join(lines))


def test_bf16_tp2_gradients_against_jax(runs):
    ref, ranks = runs
    mine = ranks[0]
    loss1, port1 = _port_tp1_grads(ref)
    assert abs(loss1 - float(ref["loss1"])) <= BF16_STEP * float(
        ref["loss1"])
    jax2, jax1 = _tree(ref, "grad"), _tree(ref, "grad1")
    worst = []
    for path, want in _leaves(jax2):
        have, base = mine["grads"], jax1
        for k in path:
            have, base = have[k], base[k]
        gap = _rel(have, want)
        spread = max(_rel(port1[path], base), _rel(want, base))
        worst.append((gap / spread, "/".join(path), gap, spread))
    for r in ranks[1:]:  # every rank reports the gathered gradient
        np.testing.assert_array_equal(
            r["grads"]["lm_head"]["kernel"], mine["grads"]["lm_head"][
                "kernel"])
    worst.sort(reverse=True)
    lines = [f"gradient {name:26s} port tp 2 vs JAX tp 2 {gap:.3e}, spread "
              f"{spread:.3e} ({ratio:.2f}x)"
              for ratio, name, gap, spread in worst[:5]]
    print("\n".join(lines))
    assert worst[0][0] <= GRAD_RATIO, "\n".join(lines)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val
