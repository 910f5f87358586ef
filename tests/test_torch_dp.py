"""Data parallelism over processes (tf_operator_tpu_torch/parallel/ and the
steps' ``mesh``) held against JAX on the CPU: N gloo processes stand for
JAX's N devices (the conftest's virtual CPU devices), from one seeded
tree and one seeded global batch. Each process runs ``distributed.
initialize`` from the operator's env names, builds the mesh ``{"dp": N}``,
replicates its state from process 0 (every other process starts from
other weights, so ``replicate`` is held too), feeds its rows of each
global batch (``shard_batch``) and sends its results back. One world of
each size runs every case of that size (``world_results``), since a
process spends seconds importing torch.

- The LM step (2 layers, d 64, f32, chunked loss) at 2 and 4 processes
  with ``grad_accum`` 1 and 2, against JAX's ``make_lm_train_step`` on a
  ``{"dp": N}`` mesh: the loss at each of 3 AdamW steps within
  ``LOSS_TOL`` 1e-5 (relative), every leaf after them within
  ``LEAF_RTOL`` 1e-4 of its largest magnitude plus Adam's noise bound
  (tests/test_torch_moe.py's rule: ``ADAM_NOISE`` x the summed lr, the
  key bias 4 x the summed lr). Every process reports the same loss and
  ends with the same bits.
- The same with MoE (every block, 4 experts, top-2, aux weight 0.01) at
  ``grad_accum`` 2: the aux loss at each step is JAX's GLOBAL one, within
  ``LOSS_TOL``.
- The small ResNet's classifier step with BatchNorm over 2 processes:
  loss, params and the running ``mean``/``var`` after 3 SGD steps within
  tests/test_torch_classifier.py's ``LEAF_RTOL`` 1e-4 and ``LOSS_TOL``
  1e-5 (BatchNorm takes the global batch's statistics).
- ``evaluate`` and ``evaluate_lm`` over 2 processes with a ragged tail
  against JAX's on a 2-device mesh: counts exact, losses within 1e-5
  relative, the same dict on both processes.
- ``Mesh.group`` over 4 processes: the world's group over axes that span
  the mesh, and a refusal over part of it.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LOSS_TOL, LEAF_RTOL, ADAM_NOISE = 1e-5, 1e-4, 0.05
LR = 5e-3
SEQ, VOCAB, BATCH = 16, 64, 8
LM_KW = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=SEQ)
MOE_KW = dict(moe_every_n=1, moe_experts=4, moe_top_k=2)
STAGES, WIDTH, CLASSES, HW = (1, 1), 8, 10, 16
RANK_TIMEOUT = 240

# A process of a world: initialise from the operator's env, run the named
# function of the named test module, pickle its result as out{argv[6]}.
BOOT = """
import importlib, os, pickle, sys
import torch
torch.set_num_threads(1)
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from tf_operator_tpu_torch.train import distributed
topo = distributed.initialize(device="cpu", timeout_s=120)
mod = importlib.import_module(sys.argv[3])
with open(os.path.join(sys.argv[5], "in.pkl"), "rb") as f:
    payload = pickle.load(f)
out = getattr(mod, sys.argv[4])(topo.process_id, topo.num_processes,
                                payload)
with open(os.path.join(sys.argv[5], f"out{sys.argv[6]}.pkl"), "wb") as f:
    pickle.dump(out, f)
distributed.shutdown()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("TF_CONFIG", "MEGASCALE_NUM_SLICES")}
    env.update(OMP_NUM_THREADS="1", TPU_NUM_PROCESSES=str(world),
               TPU_WORKER_ID=str(rank),
               TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    return env


def run_processes(module: str, fn: str, envs: list[dict], payload) -> list:
    """``fn(process id, processes, payload)`` of test module ``module`` in
    one process for each env (the operator's names in it say which world
    it joins); returns their results in the envs' order."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.pkl"), "wb") as f:
            pickle.dump(payload, f)
        procs = [subprocess.Popen(
            [sys.executable, "-c", BOOT, REPO, TESTS, module, fn, tmp,
             str(i)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for i, env in enumerate(envs)]
        deadline = time.monotonic() + RANK_TIMEOUT
        logs = []
        try:
            for proc in procs:
                out, _ = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                logs.append(out)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        codes = [p.returncode for p in procs]
        assert codes == [0] * len(envs), "\n".join(logs)
        results = []
        for i in range(len(envs)):
            with open(os.path.join(tmp, f"out{i}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def run_ranks(fn: str, world: int, payload) -> list:
    """``fn(rank, world, payload)`` of this module in ``world`` processes
    joined by gloo; returns their results in rank order."""
    port = free_port()
    return run_processes("test_torch_dp", fn,
                         [rank_env(r, world, port) for r in range(world)],
                         payload)


# -- the processes' side (torch and the port only) --------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _rows(batch: dict, rank: int, world: int) -> dict:
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def lm_rank(rank, world, p):
    from tf_operator_tpu_torch.models.convert import (
        export_params,
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        replicate,
        shard_batch,
    )
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh({"dp": world}, device="cpu")
    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh, **p["cfg"])
    # Only process 0 holds the tree; replicate gives it to the others.
    tree = p["params"] if rank == 0 else init_params(cfg, 100 + rank)
    model = load_params(Transformer(cfg, device="cpu"), tree)
    tx = steps.adamw(LR)
    state = replicate(mesh, steps.TrainState.create(model, tx))
    step = steps.make_lm_train_step(
        model, tx, xent_chunk=SEQ // 2, grad_accum=p["grad_accum"],
        aux_loss_weight=p["aux"], mesh=mesh)
    losses, auxes = [], []
    for batch in p["batches"]:
        state, m = step(state, shard_batch(mesh, _rows(batch, rank, world)))
        losses.append(float(m["loss"]))
        auxes.append(float(m.get("aux_loss", 0.0)))
    return {"losses": losses, "auxes": auxes,
            "params": export_params(model)}


def groups_rank(rank, world, p):
    """``Mesh.group`` on a dcn 2 x dp 2 mesh: the world's group over both
    axes, none over an axis the mesh lacks, and the refusal (its message)
    over dp alone, a group over part of the mesh."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"dcn": 2, "dp": 2}, device="cpu")
    try:
        mesh.group(("dp",))
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return {"both": mesh.group(("dp", "dcn")) is dist.group.WORLD,
            "none": mesh.group(("tp",)) is None, "dp": refused}


def classifier_rank(rank, world, p):
    from tf_operator_tpu_torch.models import convert, resnet
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        replicate,
        shard_batch,
    )
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh({"dp": world}, device="cpu")
    model = resnet.ResNet(STAGES, CLASSES, WIDTH, torch.float32, "conv7",
                          device="cpu")
    if rank == 0:
        convert.load_variables(model, p["variables"])
    tx = steps.sgd_momentum(0.1)
    state = replicate(mesh, steps.TrainState.create(model, tx))
    step = steps.make_classifier_train_step(model, tx, mesh=mesh)
    losses, accs = [], []
    for batch in p["batches"]:
        state, m = step(state, shard_batch(mesh, _rows(batch, rank, world)))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return {"losses": losses, "accs": accs,
            "variables": convert.export_variables(model)}


def eval_rank(rank, world, p):
    from tf_operator_tpu_torch.models import convert, resnet
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh({"dp": world}, device="cpu")
    cls = convert.load_variables(resnet.ResNet(
        STAGES, CLASSES, WIDTH, torch.float32, "conv7", device="cpu"),
        p["variables"])
    cls_state = steps.TrainState.create(cls, steps.sgd_momentum(0.1))
    cls_eval = steps.make_classifier_eval_step(cls, mesh=mesh)
    lm = load_params(Transformer(TransformerConfig(
        dtype=torch.float32, **LM_KW), device="cpu"), p["params"])
    lm_state = steps.TrainState.create(lm, steps.adamw(LR))
    lm_eval = steps.make_lm_eval_step(lm, xent_chunk=8, mesh=mesh)
    seen = []

    class Spy:
        shard_count = lm_eval.shard_count

        def __call__(self, st, batch):
            seen.append(batch["tokens"].shape[0])
            return lm_eval(st, batch)

    return {"cls": steps.evaluate(cls_eval, cls_state,
                                  iter(p["images"])),
            "lm": steps.evaluate_lm(Spy(), lm_state, iter(p["tokens"])),
            "seen": seen, "shard_count": cls_eval.shard_count}


# -- the JAX side ------------------------------------------------------------


def _flat(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _assert_leaves_close(got, want, rtol, lr_sum=0.0):
    """Every leaf within ``rtol`` of its largest magnitude plus
    ``ADAM_NOISE * lr_sum``; the key bias, rounding noise that Adam scales
    to about lr a step, within 4 * ``lr_sum``."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path].copy()
        if lr_sum and path[-3:] == ("attn", "qkv", "bias"):
            assert np.abs(g[1] - w[1]).max() <= 4 * lr_sum, path
            g[1] = w[1]
        err = float(np.abs(g - w).max())
        bound = rtol * float(np.abs(w).max()) + ADAM_NOISE * lr_sum
        assert err <= bound, (path, err, bound)


def _lm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        chain = (rng.integers(0, VOCAB, (BATCH, 1))
                 + np.arange(SEQ + 1)) % VOCAB
        out.append({"tokens": chain[:, :-1].astype(np.int32),
                    "targets": chain[:, 1:].astype(np.int32)})
    return out


def _jax_mesh(n):
    import jax

    from tf_operator_tpu.parallel.mesh import create_mesh

    return create_mesh({"dp": n}, jax.devices()[:n])


def _jax_lm(cfg_kw, world, batches, grad_accum, aux):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )
    from tf_operator_tpu.train import steps as jax_steps

    jcfg = JaxConfig(dtype=jnp.float32, **cfg_kw)
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    mesh = _jax_mesh(world)
    tx = jax_steps.adamw(LR)
    state = jax_steps.TrainState.create(params, tx)
    step = jax_steps.make_lm_train_step(
        JaxTransformer(jcfg), tx, mesh, seq_axis=None, donate=False,
        xent_chunk=SEQ // 2, grad_accum=grad_accum, aux_loss_weight=aux)
    losses, auxes = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        auxes.append(float(m.get("aux_loss", 0.0)))
    return params, losses, auxes, jax.tree.map(np.asarray, state.params)


LM_CASES = {"lm1": (1, False), "lm2": (2, False), "moe2": (2, True)}
_RESULTS: dict = {}


def world_results(world: int) -> tuple[dict, list]:
    """(JAX's references, the processes' results) of every case at
    ``world`` processes, computed once."""
    if world in _RESULTS:
        return _RESULTS[world]
    want, cases = {}, []
    for name, (grad_accum, moe) in LM_CASES.items():
        cfg_kw = dict(LM_KW, **(MOE_KW if moe else {}))
        aux = 0.01 if moe else 0.0
        batches = _lm_batches(3, seed=world + grad_accum + moe)
        params, *want[name] = _jax_lm(cfg_kw, world, batches, grad_accum,
                                      aux)
        cases.append((name, "lm_rank", {
            "cfg": cfg_kw, "params": params, "batches": batches,
            "grad_accum": grad_accum, "aux": aux}))
    if world == 4:
        cases.append(("groups", "groups_rank", None))
    if world == 2:
        payload, want["classifier"] = _jax_classifier()
        cases.append(("classifier", "classifier_rank", payload))
        payload, want["eval"] = _jax_eval()
        cases.append(("eval", "eval_rank", payload))
    _RESULTS[world] = want, run_ranks("cases_rank", world, cases)
    return _RESULTS[world]


def _check_lm(world, name):
    want, results = world_results(world)
    losses, auxes, final = want[name]
    got = [r[name] for r in results]
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_TOL)
        if LM_CASES[name][1]:
            np.testing.assert_allclose(r["auxes"], auxes, rtol=LOSS_TOL)
        assert r["losses"] == got[0]["losses"]
        for path, leaf in _flat(r["params"]).items():
            assert np.array_equal(leaf, _flat(got[0]["params"])[path]), path
    _assert_leaves_close(got[0]["params"], final, LEAF_RTOL,
                         lr_sum=3 * LR)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("world", [2, 4])
def test_lm_step_over_processes_matches_jax_dp_mesh(world, grad_accum):
    _check_lm(world, f"lm{grad_accum}")


@pytest.mark.parametrize("world", [2, 4])
def test_moe_step_over_processes_takes_jax_global_aux_loss(world):
    _check_lm(world, "moe2")


def test_mesh_groups_span_the_world_or_refuse_part_of_it():
    _, results = world_results(4)
    for r in results:
        got = r["groups"]
        assert got["both"] and got["none"]
        assert "A8b's second half" in got["dp"]


def _randomized(tree, rng):
    import jax

    return jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim == 1
                   else rng.normal(size=a.shape) * 0.3).astype(np.float32),
        tree)


def _jax_resnet_variables(rng, x):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.resnet import ResNet as JaxResNet

    jm = JaxResNet(stage_sizes=STAGES, width=WIDTH, num_classes=CLASSES,
                   dtype=jnp.float32, stem="conv7")
    v = _randomized(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), x)), rng)
    return jm, v


def _images(rng, n):
    return {"image": rng.normal(size=(n, HW, HW, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, (n,)).astype(np.int32)}


def _jax_classifier():
    import jax

    from tf_operator_tpu.train import steps as jax_steps

    rng = np.random.default_rng(11)
    batches = [_images(rng, 8) for _ in range(3)]
    jm, v = _jax_resnet_variables(rng, batches[0]["image"])
    jtx = jax_steps.sgd_momentum(0.1)
    jstate = jax_steps.TrainState.create(v["params"], jtx,
                                         batch_stats=v["batch_stats"])
    jstep = jax_steps.make_classifier_train_step(jm, jtx, _jax_mesh(2),
                                                 donate=False)
    losses, accs = [], []
    for batch in batches:
        jstate, m = jstep(jstate, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    want = jax.tree.map(np.asarray, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    return {"variables": v, "batches": batches}, (losses, accs, want)


def test_classifier_batchnorm_step_over_processes_matches_jax():
    want_all, results = world_results(2)
    losses, accs, want = want_all["classifier"]
    got = [r["classifier"] for r in results]
    for r in got:
        for a, b in zip(r["losses"], losses):
            assert abs(a - b) <= LOSS_TOL * max(1.0, abs(b))
        assert r["accs"] == accs
    for key in ("params", "batch_stats"):
        _assert_leaves_close(got[0]["variables"][key], want[key], LEAF_RTOL)
        _assert_leaves_close(got[1]["variables"][key],
                             got[0]["variables"][key], 0.0)


def _jax_eval():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )
    from tf_operator_tpu.train import steps as jax_steps

    rng = np.random.default_rng(6)
    images = [_images(rng, n) for n in (8, 8, 3)]
    jm, v = _jax_resnet_variables(rng, images[0]["image"])
    mesh = _jax_mesh(2)
    jstate = jax_steps.TrainState.create(
        v["params"], jax_steps.sgd_momentum(0.1),
        batch_stats=v["batch_stats"])
    want_cls = jax_steps.evaluate(
        jax_steps.make_classifier_eval_step(jm, mesh), jstate, iter(images))
    jcfg = JaxConfig(dtype=jnp.float32, **LM_KW)
    params = jax.tree.map(np.asarray, JaxTransformer(jcfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, SEQ), jnp.int32))["params"])
    tokens = []
    for n in (5, 5, 3):
        t = rng.integers(0, VOCAB, (n, SEQ + 1)).astype(np.int32)
        tokens.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    want_lm = jax_steps.evaluate_lm(
        jax_steps.make_lm_eval_step(JaxTransformer(jcfg), mesh,
                                    xent_chunk=8),
        jax_steps.TrainState.create(params, jax_steps.adamw(LR)),
        iter(tokens))
    return ({"variables": v, "images": images, "params": params,
             "tokens": tokens}, (want_cls, want_lm))


def test_evaluate_over_processes_with_a_ragged_tail_matches_jax():
    want, results = world_results(2)
    want_cls, want_lm = want["eval"]
    got = [r["eval"] for r in results]
    assert got[0] == got[1]
    r = got[0]
    assert r["shard_count"] == 2
    assert r["seen"] == [6, 6, 6]  # 5 rows padded to the data axis
    assert r["cls"]["count"] == want_cls["count"] == 19
    assert r["cls"]["accuracy"] == want_cls["accuracy"]
    assert abs(r["cls"]["loss"] - want_cls["loss"]) <= LOSS_TOL * max(
        1.0, abs(want_cls["loss"]))
    assert r["lm"]["tokens"] == want_lm["tokens"] == 13 * SEQ
    assert abs(r["lm"]["loss"] - want_lm["loss"]) <= LOSS_TOL * max(
        1.0, abs(want_lm["loss"]))
