"""Tensor-parallel training (the Megatron layout of
tf_operator_tpu_torch/models/transformer.py with its backward,
``sharded_lm_xent``, dp x tp meshes, eval and checkpoints under tp, and
``dist_lm --tp``) held against JAX on the CPU. The port's tp world is N
gloo processes; JAX's is one process over a ``{"tp": 2}`` or ``{"dp": 2,
"tp": 2}`` mesh of the conftest's virtual CPU devices. One spawn of 2
ranks and one of 4 run every cell (``world_results``).

- Groups: on ``{"dp": 2, "tp": 2}`` each rank's tp group and dp group are
  the ranks JAX's ``create_mesh`` puts on its row and its column, and
  rank r's slice of every leaf is JAX device r's addressable shard.
- ``sharded_lm_xent`` at tp 2, with and without a head bias: the value
  and the gradients of ``hidden``, the kernel and the bias against JAX's
  ``sharded_lm_xent`` on a ``{"tp": 2}`` mesh and against the port's
  ``chunked_lm_xent`` on one process, within ``XENT_RTOL`` (JAX's own
  tests/test_training.py::test_sharded_xent_matches_naive: 1e-6 on the
  value, 1e-4 relative and 1e-6 absolute on the gradients).
- The step, 3 steps in f32 at 2 layers, d 64, 4 heads, against JAX's
  ``make_lm_train_step`` on the same mesh, from one seeded tree whose
  biases are random (every projection and the head carry one): the loss
  at each step within ``LOSS_TOL`` (1e-5 relative), every gathered leaf
  after each step by tests/test_torch_dp.py's rule (``LEAF_RTOL`` 1e-4 of
  its largest magnitude plus Adam's noise bound), and every leaf of the
  first step's gradient, gathered, within ``GRAD_RTOL`` (1e-4) of its
  largest magnitude plus ``GRAD_ATOL`` (1e-7: the key bias's gradient is
  rounding noise) — Adam is blind to a gradient scaled by tp, so this is
  what holds each leaf's rule (``TpPlan``). The cells (``CELLS``): tp 2
  with and without ``xent_chunk``; dp 2 x tp 2; GQA KV 1 (``attn/kv``
  whole and partly used); 3 heads (the attention whole); ``grad_accum``
  2; one MoE block with the aux loss; ``remat``; LAMB against optax's.
  Every rank reports the same losses and gathered tree.
- Adafactor over tp (``ADAFACTOR_CELLS``): 3 steps at tp 2 and at dp 2 x
  tp 2 against optax's through JAX's ``steps.adafactor`` on the same
  mesh, by the step cells' rules, on a model whose leaves factor (d 128,
  d_ff 192, vocab 256): ``mlp/in_proj`` ``[128, 192]`` is factored whole
  while its ``[128, 96]`` shard would not be, and the head, embedding and
  MLP leaves split on their largest axis. A checkpoint of it saved at
  tp 2 restores bitwise at tp 2 and at tp 1, factored moments included.
- Eval under dp 2 x tp 2 with a ragged tail against JAX's
  ``evaluate_lm`` on the same mesh: tokens exact, the loss within
  ``LOSS_TOL``.
- Checkpoints: saved at tp 2 (rank 0 writes the gathered tree), restored
  at tp 2 by fresh models and at tp 1 in this process, each bitwise the
  gathered state (weights and AdamW moments).
- ``dist_lm --tp 2 --device cpu``: killed with ``--fail-at-step``, its
  resume ends bitwise on an uninterrupted twin's final checkpoint; as 4
  processes (dp 2 x tp 2) it prints JAX's mesh line and its printed
  losses follow JAX's example's step (``examples/dist_lm.py``'s mesh,
  batches, chunk and AdamW on 4 virtual devices, from the port's seeded
  tree, since the port cannot make flax's) within ``ENTRY_TOL`` (3e-4:
  four printed decimals and f32 sums in another order).
"""

import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from test_torch_dp import (
    LEAF_RTOL,
    LOSS_TOL,
    _assert_leaves_close,
    _flat,
    free_port,
    rank_env,
    run_processes,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 5e-3
SEQ, VOCAB, BATCH = 16, 64, 8
LM_KW = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=SEQ)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
XENT_RTOL = dict(value=1e-6, grad_rtol=1e-4, grad_atol=1e-6)
ENTRY_TOL = 3e-4
TP2, DP2TP2 = {"tp": 2}, {"dp": 2, "tp": 2}
# name -> (mesh axes, config keywords, xent_chunk, grad_accum, aux weight,
# optimiser)
CELLS = {
    "chunk": (TP2, {}, SEQ // 2, 1, 0.0, "adamw"),
    "full": (TP2, {}, None, 1, 0.0, "adamw"),
    "gqa1": (TP2, {"n_kv_heads": 1}, SEQ // 2, 1, 0.0, "adamw"),
    "heads3": (TP2, {"n_heads": 3, "d_model": 48}, SEQ // 2, 1, 0.0,
               "adamw"),
    "accum2": (TP2, {}, SEQ // 2, 2, 0.0, "adamw"),
    "moe": (TP2, {"moe_every_n": 2, "moe_experts": 4, "moe_top_k": 2},
            SEQ // 2, 1, 0.01, "adamw"),
    "remat": (TP2, {"remat": True}, SEQ // 2, 1, 0.0, "adamw"),
    "lamb": (TP2, {}, SEQ // 2, 1, 0.0, "lamb"),
    "dp2tp2": (DP2TP2, {}, SEQ // 2, 1, 0.0, "adamw"),
}
# Adafactor's cells: leaves that factor on their whole shape.
FACTOR_KW = {"d_model": 128, "d_ff": 192, "vocab_size": 256}
ADAFACTOR_CELLS = {
    "adafactor": (TP2, FACTOR_KW, SEQ // 2, 1, 0.0, "adafactor"),
    "adafactor_dp2tp2": (DP2TP2, FACTOR_KW, SEQ // 2, 1, 0.0, "adafactor"),
}
CELLS.update(ADAFACTOR_CELLS)


def _tree(params) -> dict:
    out: dict = {}
    for path, leaf in params.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def seeded_tree(cfg_kw: dict, seed: int) -> dict:
    """The port's seeded tree with random biases, numpy f32."""
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    tree = init_params(TransformerConfig(**cfg_kw), seed)
    rng = np.random.default_rng(seed + 1)
    flat = {path: (rng.normal(size=leaf.shape).astype(np.float32) * 0.1
                   if path[-1] == "bias" else leaf)
            for path, leaf in _flat(tree).items()}
    return _tree(flat)


def lm_batches(n, seed, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        chain = (rng.integers(0, vocab, (BATCH, 1))
                 + np.arange(SEQ + 1)) % vocab
        out.append({"tokens": chain[:, :-1].astype(np.int32),
                    "targets": chain[:, 1:].astype(np.int32)})
    return out


# -- the ranks' side (torch and the port only) ------------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _whole(model, mesh, pick=lambda p: p) -> dict:
    """``pick(parameter)`` of every parameter (default the weight; its
    gradient, its moment), gathered whole over tp, as a flax-layout tree
    of numpy arrays."""
    from tf_operator_tpu_torch.models.convert import flax_path, param_shapes
    from tf_operator_tpu_torch.models.transformer import param_sharding_rules
    from tf_operator_tpu_torch.parallel.sharding import (
        gather_params_by_rules,
    )

    tree = _tree({flax_path(n): pick(p).detach().clone()
                  for n, p in model.named_parameters()})
    whole = gather_params_by_rules(mesh, tree, param_sharding_rules(),
                                   param_shapes(model.cfg))
    return _tree({path: t.numpy() for path, t in _flat_t(whole)})


def _flat_t(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_t(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _build(mesh, cfg_kw, params, tx_name):
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu_torch.train import steps

    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh, **cfg_kw)
    model = load_params(Transformer(cfg, device="cpu"), shard_params_by_rules(
        mesh, params, param_sharding_rules()))
    tx = getattr(steps, tx_name)(LR)
    return model, tx, steps.TrainState.create(model, tx)


def _dp_rows(mesh, rank, batch):
    """The rows of ``rank``'s data index."""
    dp = mesh.shape.get("dp", 1)
    i = mesh.coords(rank).get("dp", 0)
    n = BATCH // dp
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}


def step_rank(rank, world, p):
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(p["axes"], device="cpu")
    model, tx, state = _build(mesh, p["cfg"], p["params"], p["tx"])
    step = steps.make_lm_train_step(
        model, tx, xent_chunk=p["xent_chunk"], grad_accum=p["grad_accum"],
        aux_loss_weight=p["aux"], mesh=mesh)
    losses, trees, grads = [], [], None
    for batch in p["batches"]:
        state, m = step(state, _dp_rows(mesh, rank, batch))
        losses.append(float(m["loss"]))
        if grads is None:
            grads = _whole(model, mesh, lambda p: p.grad)
        trees.append(_whole(model, mesh))
    return {"losses": losses, "params": trees, "grads": grads}


def xent_rank(rank, world, p):
    """``sharded_lm_xent`` over tp 2 with and without a bias: the value and
    the gradients (the kernel's this rank's columns)."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(TP2, device="cpu")
    v_local = p["kernel"].shape[1] // world
    out = {}
    for with_bias in (True, False):
        hidden = torch.tensor(p["hidden"], requires_grad=True)
        kernel = torch.tensor(p["kernel"][:, rank * v_local:
                                          (rank + 1) * v_local],
                              requires_grad=True)
        bias = (torch.tensor(p["bias"], requires_grad=True) if with_bias
                else None)
        loss = steps.sharded_lm_xent(mesh, hidden, kernel, bias,
                                     torch.tensor(p["labels"]), chunk=8)
        loss.backward()
        out[with_bias] = {
            "value": loss.item(), "hidden": hidden.grad.numpy(),
            "kernel": kernel.grad.numpy(),
            "bias": bias.grad.numpy() if with_bias else None}
    return out


def groups_rank(rank, world, p):
    """This rank's tp and dp groups on a dp 2 x tp 2 mesh, as rank lists."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        DataParallel,
        TensorParallel,
    )

    mesh = create_mesh(DP2TP2, device="cpu")
    tp, dp = TensorParallel(mesh), DataParallel(mesh, "dp")
    # A collective over each group: the sum of its ranks.
    sums = []
    for group in (tp.group, dp.group):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=group)
        sums.append(float(t))
    return {"tp": dist.get_process_group_ranks(tp.group),
            "dp": dist.get_process_group_ranks(dp.group),
            "tp_members": tp.members, "dp_members": dp.members,
            "sums": sums}


def eval_rank(rank, world, p):
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(DP2TP2, device="cpu")
    model, _, state = _build(mesh, LM_KW, p["params"], "adamw")
    ev = steps.make_lm_eval_step(model, xent_chunk=8, mesh=mesh)
    return {"lm": steps.evaluate_lm(ev, state, iter(p["tokens"])),
            "shard_count": ev.shard_count}


def ckpt_rank(rank, world, p):
    """3 AdamW steps at tp 2, a save (rank 0 writes the whole tree), then
    fresh tp 2 models restored from it: the gathered weights and moments
    of the trained state and of the restored one."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    mesh = create_mesh(TP2, device="cpu")
    model, tx, state = _build(mesh, LM_KW, p["params"], "adamw")
    step = steps.make_lm_train_step(model, tx, xent_chunk=SEQ // 2,
                                    mesh=mesh)
    for batch in p["batches"]:
        state, _ = step(state, batch)
    with CheckpointManager(p["dir"]) as ck:
        saved = ck.save(state.step - 1, state)
        ck.wait()
    dist.barrier()  # rank 0's write is on disk before any rank reads
    fresh, _, fresh_state = _build(mesh, LM_KW, p["other"], "adamw")
    with CheckpointManager(p["dir"]) as ck:
        ck.restore(None, fresh_state)
    return {"saved": saved, "state": _state_whole(state, mesh),
            "restored": _state_whole(fresh_state, mesh),
            "step": fresh_state.step}


def adafactor_ckpt_rank(rank, world, p):
    """``ckpt_rank`` for Adafactor at tp 2: the whole state (weights,
    factored and full moments, steps) as a checkpoint snapshot gathers it,
    of the trained state and of fresh tp 2 models restored from its
    save."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps
    from tf_operator_tpu_torch.train.checkpoint import (
        CheckpointManager,
        _snapshot,
    )

    kw = dict(LM_KW, **FACTOR_KW)
    mesh = create_mesh(TP2, device="cpu")
    model, tx, state = _build(mesh, kw, p["params"], "adafactor")
    step = steps.make_lm_train_step(model, tx, xent_chunk=SEQ // 2,
                                    mesh=mesh)
    for batch in p["batches"]:
        state, _ = step(state, batch)
    with CheckpointManager(p["dir"]) as ck:
        saved = ck.save(state.step - 1, state)
        ck.wait()
    dist.barrier()
    _, _, fresh_state = _build(mesh, kw, p["other"], "adafactor")
    with CheckpointManager(p["dir"]) as ck:
        ck.restore(None, fresh_state)
    return {"saved": saved, "state": _snapshot_flat(_snapshot(state)),
            "restored": _snapshot_flat(_snapshot(fresh_state))}


def _snapshot_flat(snap: dict) -> dict:
    """A checkpoint snapshot as {(kind, key...): numpy array}."""
    out = {("params",) + k: v.numpy() for k, v in _flat_t(snap["params"])}
    for key, tree in snap["opt"].items():
        out.update({(key,) + k: v.numpy() for k, v in _flat_t(tree)})
    out[("step",)] = snap["step"].numpy()
    return out


def _restore_adafactor_tp1(directory: str) -> dict:
    """The Adafactor tp 2 checkpoint restored at tp 1 on one process."""
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import steps
    from tf_operator_tpu_torch.train.checkpoint import (
        CheckpointManager,
        _snapshot,
    )

    kw = dict(LM_KW, **FACTOR_KW)
    model = load_params(Transformer(TransformerConfig(
        dtype=torch.float32, **kw), device="cpu"), seeded_tree(kw, 25))
    state = steps.TrainState.create(model, steps.adafactor(LR))
    with CheckpointManager(directory) as ck:
        ck.restore(None, state)
    return _snapshot_flat(_snapshot(state))


def _state_whole(state, mesh) -> dict:
    """Weights and AdamW moments by (kind,) + flax path, gathered whole."""
    model, opt = state.model, state.optimizer
    out = {("params",) + k: v for k, v in _flat(_whole(model, mesh)).items()}
    for key in ("exp_avg", "exp_avg_sq"):
        moments = _whole(model, mesh, lambda p: opt.state[p][key])
        out.update({(key,) + k: v for k, v in _flat(moments).items()})
    return out


# -- the JAX side ------------------------------------------------------------


def _jax_mesh(axes):
    import jax

    from tf_operator_tpu.parallel.mesh import create_mesh

    n = int(np.prod(list(axes.values())))
    return create_mesh(dict(axes), jax.devices()[:n])


def _jax_cell(name, params, batches):
    """JAX's losses, gathered trees after each step and first-step
    gradients for cell ``name``."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.moe import aux_loss_from
    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps

    axes, cfg_kw, xc, accum, aux_w, tx_name = CELLS[name]
    mesh = _jax_mesh(axes)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh,
                                     **dict(LM_KW, **cfg_kw)))
    placed = shard_params_by_rules(mesh, params, param_sharding_rules())
    tx = getattr(jax_steps, tx_name)(LR)

    def loss(p, tokens, targets):
        kw = dict(return_hidden=xc is not None)
        if aux_w:
            out, col = model.apply({"params": p}, tokens,
                                   mutable=["losses"], **kw)
            aux = aux_loss_from(col)
        else:
            out, aux = model.apply({"params": p}, tokens, **kw), 0.0
        if xc is None:
            xent = jax_steps.cross_entropy(out, targets)
        else:
            head = p["lm_head"]
            xent = jax_steps.sharded_lm_xent(
                mesh, out, head["kernel"], head["bias"], targets, chunk=xc,
                seq_axis=None)
        return xent + aux_w * aux

    grad = jax.jit(jax.grad(loss))
    first = batches[0]
    mb = BATCH // accum
    micro = [grad(placed, first["tokens"][i * mb:(i + 1) * mb],
                  first["targets"][i * mb:(i + 1) * mb])
             for i in range(accum)]
    grads = jax.tree.map(lambda *g: np.asarray(sum(g) / accum), *micro)
    state = jax_steps.TrainState.create(placed, tx)
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, seq_axis=None, donate=False, xent_chunk=xc,
        grad_accum=accum, aux_loss_weight=aux_w)
    losses, trees = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "params": trees, "grads": grads}


def _jax_xent(p):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.train import steps as jax_steps

    mesh = _jax_mesh(TP2)
    labels = jnp.asarray(p["labels"])
    out = {}
    for with_bias in (True, False):
        def fn(h, k, b):
            return jax_steps.sharded_lm_xent(
                mesh, h, k, b if with_bias else None, labels, chunk=8)

        val, grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2)))(
            jnp.asarray(p["hidden"]), jnp.asarray(p["kernel"]),
            jnp.asarray(p["bias"]))
        out[with_bias] = {"value": float(val), "hidden": np.asarray(
            grads[0]), "kernel": np.asarray(grads[1]),
            "bias": np.asarray(grads[2]) if with_bias else None}
    return out


def _jax_eval(params, tokens):
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps

    mesh = _jax_mesh(DP2TP2)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **LM_KW))
    placed = shard_params_by_rules(mesh, params, param_sharding_rules())
    return jax_steps.evaluate_lm(
        jax_steps.make_lm_eval_step(model, mesh, xent_chunk=8),
        jax_steps.TrainState.create(placed, jax_steps.adamw(LR)),
        iter(tokens))


_RESULTS: dict = {}


def world_results(world: int) -> tuple[dict, list]:
    """(JAX's references, the ranks' results) of every case at ``world``
    ranks, computed once. The ranks start first and JAX's references are
    computed while they run."""
    if world in _RESULTS:
        return _RESULTS[world]
    from concurrent.futures import ThreadPoolExecutor

    want, cases, refs = {}, [], {}
    for name, (axes, cfg_kw, xc, accum, aux, tx) in CELLS.items():
        if int(np.prod(list(axes.values()))) != world:
            continue
        kw = dict(LM_KW, **cfg_kw)
        params = seeded_tree(kw, len(cases))
        batches = lm_batches(3, seed=len(cases), vocab=kw["vocab_size"])
        cases.append((name, "step_rank", {
            "axes": axes, "cfg": kw, "params": params, "batches": batches,
            "xent_chunk": xc, "grad_accum": accum, "aux": aux, "tx": tx}))
        refs[name] = (_jax_cell, name, params, batches)
    tmp = tempfile.mkdtemp()
    if world == 2:
        xent = xent_payload()
        cases.append(("xent", "xent_rank", xent))
        refs["xent"] = (_jax_xent, xent)
        cases.append(("ckpt", "ckpt_rank", {
            "params": seeded_tree(LM_KW, 20), "other": seeded_tree(LM_KW,
                                                                    21),
            "batches": lm_batches(3, seed=20), "dir": tmp}))
        kw = dict(LM_KW, **FACTOR_KW)
        cases.append(("ckpt_adafactor", "adafactor_ckpt_rank", {
            "params": seeded_tree(kw, 23), "other": seeded_tree(kw, 24),
            "batches": lm_batches(3, seed=23, vocab=kw["vocab_size"]),
            "dir": os.path.join(tmp, "adafactor")}))
    if world == 4:
        cases.append(("groups", "groups_rank", None))
        rng = np.random.default_rng(6)
        params = seeded_tree(LM_KW, 30)
        tokens = []
        for n in (5, 5, 3):
            t = rng.integers(0, VOCAB, (n, SEQ + 1)).astype(np.int32)
            tokens.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
        cases.append(("eval", "eval_rank", {"params": params,
                                            "tokens": tokens}))
        refs["eval"] = (_jax_eval, params, tokens)
    port = free_port()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_processes, "test_torch_tp_train",
                            "cases_rank",
                            [rank_env(r, world, port) for r in range(world)],
                            cases)
        for name, (fn, *args) in refs.items():
            want[name] = fn(*args)
        results = ranks.result()
    if world == 2:
        want["ckpt_tp1"] = _restore_tp1(tmp)
        want["ckpt_adafactor_tp1"] = _restore_adafactor_tp1(
            os.path.join(tmp, "adafactor"))
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    _RESULTS[world] = want, results
    return _RESULTS[world]


def _restore_tp1(directory: str) -> dict:
    """The tp 2 checkpoint restored into a tp 1 model on one process."""
    from tf_operator_tpu_torch.models.convert import export_params, load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.models.convert import flax_path
    from tf_operator_tpu_torch.train import steps
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    cfg = TransformerConfig(dtype=torch.float32, **LM_KW)
    model = load_params(Transformer(cfg, device="cpu"),
                        seeded_tree(LM_KW, 22))
    state = steps.TrainState.create(model, steps.adamw(LR))
    with CheckpointManager(directory) as ck:
        ck.restore(None, state)
    out = {("params",) + k: v for k, v in
           _flat(export_params(model)).items()}
    for n, p in model.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            out[(key,) + flax_path(n)] = (
                state.optimizer.state[p][key].numpy())
    return {"state": out, "step": state.step}


def _check_step(world, name):
    want_all, results = world_results(world)
    want = want_all[name]
    got = [r[name] for r in results]
    for r in got:
        assert r["losses"] == got[0]["losses"], name
        for a, b in zip(r["params"], got[0]["params"]):
            for path, leaf in _flat(a).items():
                assert np.array_equal(leaf, _flat(b)[path]), (name, path)
    np.testing.assert_allclose(got[0]["losses"], want["losses"],
                               rtol=LOSS_TOL)
    for path, w in _flat(want["grads"]).items():
        g = _flat(got[0]["grads"])[path]
        err = float(np.abs(g - w).max())
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert err <= bound, (name, "grad", path, err, bound)
    for i, (g, w) in enumerate(zip(got[0]["params"], want["params"])):
        _assert_leaves_close(_gqa_key_bias(g, w, (i + 1) * LR), w,
                             LEAF_RTOL, lr_sum=(i + 1) * LR)


def _gqa_key_bias(got, want, lr_sum):
    """tests/test_torch_dp.py's rule for the key bias (rounding noise that
    Adam scales to about lr a step: within 4 x ``lr_sum``), applied to
    GQA's, row 0 of ``attn/kv/bias``, which that rule does not name;
    returns ``got`` with those rows set to ``want``'s."""
    flat = _flat(got)
    for path, w in _flat(want).items():
        if path[-3:] == ("attn", "kv", "bias"):
            assert np.abs(flat[path][0] - w[0]).max() <= 4 * lr_sum, path
            flat[path] = flat[path].copy()
            flat[path][0] = w[0]
    return _tree(flat)


@pytest.mark.parametrize("name", [n for n, c in CELLS.items()
                                  if c[0] == TP2])
def test_tp2_step_matches_jax_tp_mesh(name):
    _check_step(2, name)


def test_dp2_tp2_step_matches_jax_mesh():
    _check_step(4, "dp2tp2")


def test_sharded_lm_xent_matches_jax_and_chunked():
    from tf_operator_tpu_torch.train import steps

    want_all, results = world_results(2)
    want = want_all["xent"]
    p = xent_payload()
    for with_bias in (True, False):
        w = want[with_bias]
        got = [r["xent"][with_bias] for r in results]
        assert got[0]["value"] == got[1]["value"]
        np.testing.assert_allclose(got[0]["value"], w["value"],
                                   rtol=XENT_RTOL["value"])
        hidden = torch.tensor(p["hidden"], requires_grad=True)
        kernel = torch.tensor(p["kernel"], requires_grad=True)
        bias = (torch.tensor(p["bias"], requires_grad=True) if with_bias
                else None)
        plain = steps.chunked_lm_xent(hidden, kernel, bias,
                                      torch.tensor(p["labels"]), chunk=8)
        plain.backward()
        np.testing.assert_allclose(got[0]["value"], plain.item(),
                                   rtol=XENT_RTOL["value"])
        grads = {"hidden": got[0]["hidden"],
                 "kernel": np.concatenate([r["kernel"] for r in got], 1),
                 "bias": got[0]["bias"]}
        refs = [w, {"hidden": hidden.grad.numpy(),
                    "kernel": kernel.grad.numpy(),
                    "bias": bias.grad.numpy() if with_bias else None}]
        for key in ("hidden", "kernel", "bias"):
            if grads[key] is None:
                continue
            for r in got:  # whole on every rank
                if key != "kernel":
                    assert np.array_equal(r[key], grads[key]), key
            for ref in refs:
                np.testing.assert_allclose(
                    grads[key], ref[key], rtol=XENT_RTOL["grad_rtol"],
                    atol=XENT_RTOL["grad_atol"], err_msg=key)


def xent_payload() -> dict:
    """``sharded_lm_xent``'s seeded inputs (JAX's test's shapes)."""
    rng = np.random.default_rng(9)
    b, s, d, v = 2, 16, 16, 64
    return {"hidden": rng.normal(size=(b, s, d)).astype(np.float32),
           "kernel": (rng.normal(size=(d, v)) * 0.3).astype(np.float32),
           "bias": (rng.normal(size=(v,)) * 0.1).astype(np.float32),
           "labels": rng.integers(0, v, (b, s)).astype(np.int64)}


def test_groups_are_jax_mesh_rows_and_columns():
    _, results = world_results(4)
    jm = _jax_mesh(DP2TP2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)  # [dp, tp]
    for rank, r in enumerate(results):
        g = r["groups"]
        i, j = map(int, np.argwhere(ids == rank)[0])
        assert g["tp"] == sorted(ids[i, :].tolist())
        assert g["dp"] == sorted(ids[:, j].tolist())
        assert g["tp_members"] == ids[i, :].tolist()
        assert g["dp_members"] == ids[:, j].tolist()
        assert g["sums"] == [float(ids[i, :].sum()), float(ids[:, j].sum())]
    assert results[0]["groups"]["tp"] == [0, 1]  # ranks 0, 1: tp group 0


def test_rank_slices_are_jax_device_shards():
    import jax

    from tf_operator_tpu.models.transformer import (
        param_sharding_rules as jax_rules,
    )
    from tf_operator_tpu.parallel.sharding import (
        shard_params_by_rules as jax_shard,
    )
    from tf_operator_tpu_torch.models.transformer import param_sharding_rules
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import shard_params_by_rules

    for kw in (LM_KW, dict(LM_KW, n_kv_heads=1)):
        params = seeded_tree(kw, 3)
        placed = dict(_flat_t(jax_shard(_jax_mesh(DP2TP2), params,
                                        jax_rules())))
        pm = create_mesh(DP2TP2, range(4))
        for rank in range(4):
            mine = _flat(shard_params_by_rules(pm, params,
                                               param_sharding_rules(),
                                               rank=rank))
            for path, arr in placed.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device.id == rank)
                assert np.array_equal(mine[path], np.asarray(shard.data)), (
                    rank, path)


def test_eval_under_dp2_tp2_with_a_ragged_tail_matches_jax():
    want, results = world_results(4)
    got = [r["eval"] for r in results]
    assert all(r == got[0] for r in got)
    assert got[0]["shard_count"] == 2
    w = want["eval"]
    assert got[0]["lm"]["tokens"] == w["tokens"] == 13 * SEQ
    assert abs(got[0]["lm"]["loss"] - w["loss"]) <= LOSS_TOL * abs(w["loss"])


def test_checkpoint_saved_at_tp2_restores_bitwise_at_tp2_and_tp1():
    want, results = world_results(2)
    got = [r["ckpt"] for r in results]
    assert [r["saved"] for r in got] == [True, False]  # rank 0 writes
    state = got[0]["state"]
    for r in got:
        assert r["step"] == 3
        assert r["state"].keys() == state.keys()
        for key, leaf in state.items():
            assert np.array_equal(r["state"][key], leaf), key
            assert np.array_equal(r["restored"][key], leaf), key
    tp1 = want["ckpt_tp1"]
    assert tp1["step"] == 3
    assert tp1["state"].keys() == state.keys()
    for key, leaf in state.items():
        assert np.array_equal(tp1["state"][key], leaf), key


def test_adafactor_over_tp_names_its_item():
    """Adafactor over tp is ported (A8f): a tp 2 step is built, and its
    optimiser factors each split leaf on its whole shape (the cells below
    hold its numbers)."""
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(TP2, range(2), device="cpu")
    model = Transformer(TransformerConfig(
        dtype=torch.float32, mesh=mesh, **dict(LM_KW, **FACTOR_KW)),
        device="cpu")
    tx = steps.adafactor(1e-3)
    assert callable(steps.make_lm_train_step(model, tx, mesh=mesh))
    opt = steps.TrainState.create(model, tx).optimizer
    assert isinstance(opt, steps.AdafactorOptimizer)
    mlp_in = model.blocks[0].mlp.in_proj.kernel
    assert tuple(mlp_in.shape) == (128, 96)  # the shard would not factor
    assert opt.split[id(mlp_in)] == ((128, 192), 1)
    with pytest.raises(ValueError, match="its own mesh"):
        steps.make_lm_train_step(model, steps.adamw(LR))


def test_dp2_tp2_adafactor_matches_optax():
    _check_step(4, "adafactor_dp2tp2")


def test_adafactor_checkpoint_at_tp2_restores_bitwise_at_tp2_and_tp1():
    want, results = world_results(2)
    got = [r["ckpt_adafactor"] for r in results]
    assert [r["saved"] for r in got] == [True, False]  # rank 0 writes
    state = got[0]["state"]
    assert any(k[0] == "v_row" for k in state)  # factored moments
    assert state[("v_row", "block_0", "mlp", "in_proj", "kernel")].shape \
        == (128,)
    assert state[("v_col", "block_0", "mlp", "in_proj", "kernel")].shape \
        == (192,)
    tp1 = want["ckpt_adafactor_tp1"]
    for r in got:
        assert r["state"].keys() == state.keys() == tp1.keys()
        for key, leaf in state.items():
            assert np.array_equal(r["state"][key], leaf), key
            assert np.array_equal(r["restored"][key], leaf), key
            assert np.array_equal(tp1[key], leaf), key


# -- dist_lm --tp ------------------------------------------------------------

LM = "tf_operator_tpu_torch.train.dist_lm"
ENTRY = ["--device", "cpu", "--tp", "2", "--steps", "12", "--target-loss",
         "10"]


def _start(args, world, tmp, tag):
    port = free_port()
    procs = []
    for r in range(world):
        env = rank_env(r, world, port)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        with open(os.path.join(tmp, f"{tag}{r}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", LM, *args], cwd=REPO, env=env,
                stdout=out, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, timeout=240):
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def _log(tmp, tag, r=0):
    with open(os.path.join(tmp, f"{tag}{r}.log")) as f:
        return f.read()


def _jax_entry_losses(world):
    """examples/dist_lm.py's step at ENTRY's flags on ``world`` virtual
    devices (its mesh, batches, chunk and AdamW), from the port's seeded
    tree: the losses at the steps dist_lm prints."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    steps, batch, seq, vocab, d = 12, 8, 128, 256, 128
    kw = dict(vocab_size=vocab, d_model=d, n_heads=4, n_layers=2,
              d_ff=2 * d, max_seq_len=seq)
    mesh = _jax_mesh({"dp": world // 2, "sp": 1, "tp": 2})
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **kw))
    params = shard_params_by_rules(mesh, init_params(TransformerConfig(
        **kw), 0), param_sharding_rules())
    tx = jax_steps.adamw(3e-3)
    state = jax_steps.TrainState.create(params, tx)
    step = jax_steps.make_lm_train_step(model, tx, mesh, donate=False,
                                        xent_chunk=seq // 2)
    out = {}
    for i in range(steps):
        rng = np.random.default_rng((7, i))
        start = rng.integers(0, vocab, (batch, 1))
        chain = ((start + np.arange(seq + 1)) % vocab).astype(np.int32)
        state, m = step(state, {"tokens": chain[:, :-1],
                                "targets": chain[:, 1:]})
        if i == 0 or (i + 1) % 20 == 0 or i == steps - 1:
            out[i + 1] = float(m["loss"])
    return out


def _printed(log):
    got = {int(s): float(v) for s, v in
           re.findall(r"step (\d+) loss=(\S+)", log)}
    final = re.search(r"final loss (\S+)", log)
    return got, float(final.group(1)) if final else None


def test_dist_lm_tp2_resumes_bitwise_and_dp2_tp2_follows_jax(tmp_path):
    from tf_operator_tpu_torch.models.convert import _leaves
    from tf_operator_tpu_torch.train import checkpoint

    tmp = str(tmp_path)
    ck, twin = str(tmp_path / "ck"), str(tmp_path / "twin")
    first = _start(ENTRY + ["--checkpoint-dir", ck, "--fail-at-step", "5"],
                   2, tmp, "first")
    other = _start(ENTRY + ["--checkpoint-dir", twin], 2, tmp, "twin")
    codes = _wait(first + other)
    assert codes == [138, 138, 0, 0], _log(tmp, "first") + _log(tmp, "twin")
    # At most four ranks at once: the suite's other workers share the cores.
    four = _start(ENTRY, 4, tmp, "four")
    want = _jax_entry_losses(4)  # while the ranks run
    codes = _wait(four)
    second = _start(ENTRY + ["--checkpoint-dir", ck, "--fail-at-step", "5"],
                    2, tmp, "second")
    codes += _wait(second)
    assert codes == [0] * 6, "".join(_log(tmp, "four", r) for r in range(4))
    for r in range(2):
        out = _log(tmp, "second", r)
        assert "dist_lm: resumed from step 6" in out and "dist_lm: OK" in out
        assert "mesh {'dp': 1, 'sp': 1, 'tp': 2}" in out
    last = checkpoint.latest_step(ck)
    assert last == checkpoint.latest_step(twin) == 11
    a = dict(_leaves(checkpoint.read(ck, last)[0]))
    b = dict(_leaves(checkpoint.read(twin, last)[0]))
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert _printed(_log(tmp, "second"))[1] == _printed(
        _log(tmp, "twin"))[1]
    logs = [_log(tmp, "four", r) for r in range(4)]
    for r, out in enumerate(logs):
        assert (f"dist_lm: process {r}/4, mesh {{'dp': 2, 'sp': 1, "
                f"'tp': 2}}") in out
        assert _printed(out) == _printed(logs[0])
    printed, final = _printed(logs[0])
    assert printed.keys() == {1} and final is not None
    for s, v in {**printed, 12: final}.items():
        assert abs(v - want[s]) <= ENTRY_TOL, (s, v, want[s])
