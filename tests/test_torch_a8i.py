"""Expert parallelism, FSDP and ZeRO-1 beside tensor or sequence
parallelism (tf_operator_tpu_torch's ``models/moe.py``, ``Cut.within``
in ``parallel/sharding.py``, the train step's ``param_shardings`` and
``opt_shardings``, the checkpoints and ``dist_lm --ep`` with ``--tp``),
and ``dist_lm --data`` beside ``--ep``, held against JAX on the CPU. The
port's world is 4 gloo processes; JAX's is one process over a mesh of the
conftest's virtual CPU devices. One spawn runs every step cell
(``world_results``); each rank runs one thread, and at most 4 ranks run
at once.

- The steps (``CELLS``), 3 steps each from one seeded tree against JAX's
  step on the same mesh and placement: losses (and the MoE aux) within
  tests/test_torch_dp.py's ``LOSS_TOL`` (1e-5 relative), every leaf
  within its ``LEAF_RTOL`` (1e-4 of the leaf's largest magnitude) plus
  Adam's noise bound (LAMB's and Adafactor's updates are at most about lr
  an element a step too). The MoE LM at dp 1 x ep 2 x tp 2 and at dp 1 x
  sp 2 x ep 2 (its routing groups straddle the two sequence blocks); the
  LM under FSDP at dp 1 x fsdp 2 x tp 2 (AdamW, and Adafactor at a width
  whose leaves factor) and at fsdp 2 x sp 2; ZeRO-1 at dp 2 x tp 2
  (AdamW and LAMB). Every rank reports the same losses and whole trees;
  a tp-split leaf under FSDP holds 1/(tp fsdp) of the whole leaf, and so
  does its moment.
- ``sharded_lm_xent`` at dp 1 x fsdp 2 x tp 2 with the data axes
  ("dp", "fsdp") against tests/test_training.py's JAX case (its shapes
  and seed; value within 1e-6, gradients within 1e-4 + 1e-6).
- Checkpoints: each cell's state is saved at its layout (rank 0 writes
  the gathered tree), restored at the same layout into a fresh state
  (weights and moments bitwise), and restored at one process (ep 1 x tp
  1, fsdp 1 x tp 1, no ZeRO-1) bitwise the saved tree, which is the
  ranks' gathered state.
- FSDP and ZeRO-1 beside ep: tests/test_torch_a8l.py.
- ``dist_lm --moe-every-n 2 --ep 2 --tp 2`` (and ``--sp 2``) as 4
  processes: JAX's mesh line and its losses within
  tests/test_torch_tp_train.py's ``ENTRY_TOL`` (3e-4: four printed
  decimals) of JAX's example at the same flags (its mesh, rules,
  batches, chunk and AdamW on virtual devices, from the port's seeded
  tree); the tp run's checkpoint restored at ep 1 x tp 1 bitwise.
- C6, ``dist_lm --data`` beside ``--ep``: at dp 1 x ep 2 each rank trains
  on JAX's single process's rows (shard 0 of 1) and follows its losses;
  at dp 2 x ep 2 the ep ranks of a dp index train on that index's rows of
  the pure-dp ``--data`` run, whose losses the run follows.
"""

import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_torch_dp import (
    LEAF_RTOL,
    LOSS_TOL,
    TESTS,
    _assert_leaves_close,
    _flat,
    free_port,
    rank_env,
    run_processes,
)
from test_torch_ep import _restore_ep1
from test_torch_tp_train import (
    ENTRY_TOL,
    REPO,
    _jax_mesh,
    _log,
    _printed,
    _start,
    _tree,
    _wait,
    seeded_tree,
)

torch.set_num_threads(1)

STEPS, LR, SEQ, BATCH, MIN_SIZE = 3, 5e-3, 16, 8, 64
LM_KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=SEQ)
MOE_KW = dict(LM_KW, moe_every_n=2, moe_experts=4, moe_top_k=2)
# Adafactor's cell: leaves whose dims reach optax's factoring size.
FACTOR_KW = dict(LM_KW, d_model=128, d_ff=192, vocab_size=256)
EP2TP2 = {"dp": 1, "sp": 1, "ep": 2, "tp": 2}
SP2EP2 = {"dp": 1, "sp": 2, "ep": 2, "tp": 1}
FSDP2TP2 = {"dp": 1, "fsdp": 2, "sp": 1, "tp": 2}
FSDP2SP2 = {"dp": 1, "fsdp": 2, "sp": 2, "tp": 1}
DP2TP2 = {"dp": 2, "sp": 1, "tp": 2}
DATA = ("dp", "fsdp")


def _data(axes):
    """The cell's data axes: dp, and fsdp where the mesh has it."""
    return DATA if "fsdp" in axes else "dp"


# name -> (mesh axes, config keywords, placement, optimiser, xent chunk)
CELLS = {
    "moe_ep2tp2": (EP2TP2, MOE_KW, None, "adamw", SEQ // 2),
    "moe_sp2ep2": (SP2EP2, MOE_KW, None, "adamw", SEQ // 4),
    "fsdp2tp2": (FSDP2TP2, LM_KW, "fsdp", "adamw", SEQ // 2),
    "fsdp2tp2_adafactor": (FSDP2TP2, FACTOR_KW, "fsdp", "adafactor",
                           SEQ // 2),
    "fsdp2sp2": (FSDP2SP2, LM_KW, "fsdp", "adamw", SEQ // 4),
    "zero_dp2tp2": (DP2TP2, LM_KW, "zero", "adamw", SEQ // 2),
    "zero_dp2tp2_lamb": (DP2TP2, LM_KW, "zero", "lamb", SEQ // 2),
}
XENT_AXES = {"dp": 1, "fsdp": 2, "tp": 2}


def lm_tokens(cfg_kw, seed):
    """Seeded +1 chains: ``{"tokens", "targets"}`` int32 [BATCH, SEQ]."""
    rng = np.random.default_rng(seed)
    vocab = cfg_kw["vocab_size"]
    chain = (rng.integers(0, vocab, (BATCH, 1)) + np.arange(SEQ + 1)) % vocab
    return {"tokens": chain[:, :-1].astype(np.int32),
            "targets": chain[:, 1:].astype(np.int32)}


def _rules(axes):
    """The rules that place a tree on ``axes``: JAX's Megatron pairs over
    tp, the experts over ep (``examples/dist_lm.py``'s)."""
    from tf_operator_tpu_torch.models.moe import moe_param_sharding_rules
    from tf_operator_tpu_torch.models.transformer import param_sharding_rules

    rules = dict(param_sharding_rules()) if axes.get("tp", 1) > 1 else {}
    if axes.get("ep", 1) > 1:
        rules.update(moe_param_sharding_rules())
    return rules


# -- the ranks' side (torch and the port only) ------------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _whole(model, pick=lambda p: p) -> dict:
    """``pick(parameter)`` of every parameter, gathered whole over every
    cut (``param_cuts``), as a flax-layout tree of numpy arrays."""
    from tf_operator_tpu_torch.models.convert import flax_path
    from tf_operator_tpu_torch.train.steps import param_cuts

    cuts = param_cuts(model)
    out = {}
    for name, p in model.named_parameters():
        t = pick(p).detach()
        if id(p) in cuts:
            t = cuts[id(p)].gather(t.contiguous())
        out[flax_path(name)] = t.numpy().copy()
    return _tree(out)


def _moments(state, key="exp_avg") -> dict:
    """Every parameter's optimiser tensor ``key`` (AdamW's and LAMB's
    moments, Adafactor's ``v``/``v_row``/``v_col``), gathered whole."""
    from tf_operator_tpu_torch.models.convert import flax_path
    from tf_operator_tpu_torch.train.steps import param_cuts, state_cut

    model, opt = state.model, state.optimizer
    cuts = param_cuts(model)
    held = getattr(opt, "held", lambda p: (p, cuts.get(id(p))))
    out = {}
    for name, p in model.named_parameters():
        t, cut = held(p)
        for k, m in opt.state[t].items():
            if not isinstance(m, torch.Tensor) or not m.dim():
                continue
            if key not in (k, "all"):
                continue
            part = state_cut(k, m, cut)
            if part is not None:
                m = part.gather(m.contiguous())
            out[flax_path(name) + ((k,) if key == "all" else ())] = (
                m.numpy().copy())
    return out


def _build(p):
    """The cell's model (its part of the seeded tree), optimiser, state
    and step; and the FSDP spec tree the model reads as, or None."""
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    axes, cfg_kw, placement, tx_name, chunk = CELLS[p["name"]]
    mesh = create_mesh(axes, device="cpu")
    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh, **cfg_kw)
    rules = _rules(axes)
    tree = (sharding.shard_params_by_rules(mesh, p["params"], rules)
            if rules else p["params"])
    model = load_params(Transformer(cfg, device="cpu"), tree)
    kw, read_as = {}, None
    if placement == "fsdp":
        kw["param_shardings"] = sharding.fsdp_sharding_tree(
            mesh, p["params"], min_size=MIN_SIZE)
        read_as = sharding.fsdp_sharding_tree(mesh, model,
                                              min_size=MIN_SIZE)
        sharding.shard_params_fsdp(mesh, model, min_size=MIN_SIZE)
    elif placement == "zero":
        kw["opt_shardings"] = sharding.weight_update_shardings(
            mesh, p["params"], min_size=MIN_SIZE)
    tx = getattr(steps, tx_name)(LR)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(
        model, tx, mesh=mesh, data_axis=_data(axes), xent_chunk=chunk,
        aux_loss_weight=0.01 if "moe_every_n" in cfg_kw else 0.0, **kw)
    same = read_as is None or read_as == kw["param_shardings"]
    return mesh, model, state, step, same


def cell_rank(rank, world, p):
    """A cell's 3 steps: losses, aux, the whole trees after each step, the
    shapes a rank holds; then its checkpoint saved (``p["dir"]``) and
    restored at the same layout into a fresh state (the names of what
    parts from the trained state's whole weights and moments)."""
    from tf_operator_tpu_torch.parallel.sharding import token_block
    from tf_operator_tpu_torch.train import checkpoint, distributed

    mesh, model, state, step, same = _build(p)
    data = _data(CELLS[p["name"]][0])
    losses, aux, trees = [], [], []
    for batch in p["batches"]:
        state, m = step(state, token_block(mesh, batch, data_axis=data))
        losses.append(float(m["loss"]))
        aux.append(float(m.get("aux_loss", 0.0)))
        trees.append(_whole(model))
    held = {}
    for name, q in model.named_parameters():
        key, _ = getattr(state.optimizer, "held", lambda t: (t, None))(q)
        mom = state.optimizer.state[key]
        held[name] = (tuple(q.shape), {k: tuple(v.shape) for k, v in
                                       mom.items() if v.dim()})
    moments = _moments(state, "all")
    with checkpoint.CheckpointManager(p["dir"]) as mgr:
        mgr.save(STEPS, state, force=True)
    distributed.barrier()  # the primary's write is durable
    _, fresh_model, fresh, _, _ = _build(p)
    with checkpoint.CheckpointManager(p["dir"]) as mgr:
        mgr.restore(STEPS, fresh)
    kept = [] if fresh.step == STEPS else [f"step {fresh.step}"]
    for path, w in _flat(_whole(fresh_model)).items():
        if not np.array_equal(w, _flat(trees[-1])[path]):
            kept.append("/".join(path))
    again = _moments(fresh, "all")
    kept += [f"moment {'/'.join(k)}" for k in moments.keys() | again.keys()
             if k not in moments or k not in again
             or not np.array_equal(moments[k], again[k])]
    return {"losses": losses, "aux": aux, "params": trees, "held": held,
            "same_specs": same, "kept": kept, "moments": moments}


def xent_rank(rank, world, p):
    """``sharded_lm_xent`` at ``XENT_AXES``: this rank's rows of the
    hidden state and labels, its columns of the head; the global loss (the
    data ranks' mean) and gradients (the hidden rows' scaled by 1 / data
    size and gathered, the kernel's and the bias' averaged over the data
    axes, the kernel's columns gathered over tp)."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        DataParallel,
        TensorParallel,
    )
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(XENT_AXES, device="cpu")
    dp, tp = DataParallel(mesh, DATA), TensorParallel(mesh, "tp")
    b = p["hidden"].shape[0] // dp.size
    v = p["kernel"].shape[1] // tp.size
    rows = slice(dp.index * b, (dp.index + 1) * b)
    hidden = torch.tensor(p["hidden"][rows], requires_grad=True)
    kernel = torch.tensor(p["kernel"][:, tp.index * v:(tp.index + 1) * v],
                          requires_grad=True)
    bias = torch.tensor(p["bias"], requires_grad=True)
    loss = steps.sharded_lm_xent(mesh, hidden, kernel, bias,
                                 torch.tensor(p["labels"][rows]), chunk=8)
    loss.backward()
    dp.mean_grads([kernel, bias])
    return {"value": float(dp.mean(loss.detach())),
            "hidden": dp.gather_rows(hidden.grad / dp.size).numpy(),
            "kernel": tp.all_gather(kernel.grad, 1).numpy(),
            "bias": bias.grad.numpy()}


# -- the JAX side ------------------------------------------------------------


def _jax_cell(name, params, batches):
    """JAX's losses, aux and whole trees after each step for cell
    ``name``: its model over the cell's mesh, the tree placed as the cell
    names (Megatron and expert rules, ``shard_params_fsdp`` with
    ``param_shardings``, or replicated with ``opt_shardings``)."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.moe import moe_param_sharding_rules
    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel import sharding as jax_sharding
    from tf_operator_tpu.train import steps as jax_steps

    axes, cfg_kw, placement, tx_name, chunk = CELLS[name]
    mesh = _jax_mesh(axes)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **cfg_kw))
    tx = getattr(jax_steps, tx_name)(LR)
    kw = {}
    if placement == "fsdp":
        kw["param_shardings"] = jax_sharding.fsdp_sharding_tree(
            mesh, params, min_size=MIN_SIZE)
        state = jax_steps.TrainState.create(jax_sharding.shard_params_fsdp(
            mesh, params, min_size=MIN_SIZE), tx)
    elif placement == "zero":
        state = jax_steps.TrainState.create(
            jax_sharding.replicate(mesh, params), tx)
        kw["opt_shardings"] = jax_sharding.weight_update_shardings(
            mesh, state.opt_state, min_size=MIN_SIZE)
        state = state.replace(opt_state=jax.tree.map(
            jax.device_put, state.opt_state, kw["opt_shardings"]))
    else:
        rules = dict(param_sharding_rules())
        rules.update(moe_param_sharding_rules())
        state = jax_steps.TrainState.create(
            jax_sharding.shard_params_by_rules(mesh, params, rules), tx)
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, data_axis=_data(axes), donate=False,
        xent_chunk=chunk,
        aux_loss_weight=0.01 if "moe_every_n" in cfg_kw else 0.0, **kw)
    losses, aux, trees = [], [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        aux.append(float(m.get("aux_loss", 0.0)))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "aux": aux, "params": trees}


def xent_payload() -> dict:
    """tests/test_training.py's sharded-xent inputs (its shapes, seed 0)."""
    rng = np.random.default_rng(0)
    b, s, d, v = 4, 32, 16, 64
    return {"hidden": rng.normal(size=(b, s, d)).astype(np.float32),
            "kernel": (rng.normal(size=(d, v)) * 0.3).astype(np.float32),
            "bias": (rng.normal(size=(v,)) * 0.1).astype(np.float32),
            "labels": rng.integers(0, v, (b, s)).astype(np.int32)}


def _jax_xent(p):
    """JAX's ``sharded_lm_xent`` over ``{"dp": 1, "fsdp": 2, "tp": 2}``
    with ``data_axis=("dp", "fsdp")``: value and gradients."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.train.steps import sharded_lm_xent

    mesh = _jax_mesh(XENT_AXES)
    labels = jnp.asarray(p["labels"])

    def fn(h, k, b):
        return sharded_lm_xent(mesh, h, k, b, labels, chunk=8,
                               data_axis=DATA)

    val, grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2)))(
        jnp.asarray(p["hidden"]), jnp.asarray(p["kernel"]),
        jnp.asarray(p["bias"]))
    return {"value": float(val), "hidden": np.asarray(grads[0]),
            "kernel": np.asarray(grads[1]), "bias": np.asarray(grads[2])}


_RESULTS: dict = {}


def world_results() -> tuple[dict, list]:
    """(JAX's references, the 4 ranks' results) of every case, computed
    once; the ranks start first and JAX's references are computed while
    they run."""
    if _RESULTS:
        return _RESULTS["all"]
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="a8i_ckpt")
    cases, refs = [], {}
    for i, (name, (_, cfg_kw, _, _, _)) in enumerate(CELLS.items()):
        params = seeded_tree(cfg_kw, 30 + i)
        batches = [lm_tokens(cfg_kw, 40 + 10 * i + s) for s in range(STEPS)]
        cases.append((name, "cell_rank", {
            "name": name, "params": params, "batches": batches,
            "dir": os.path.join(tmp, name)}))
        refs[name] = (_jax_cell, name, params, batches)
    xent = xent_payload()
    cases.append(("xent", "xent_rank", xent))
    refs["xent"] = (_jax_xent, xent)
    port = free_port()
    want = {}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_processes, "test_torch_a8i", "cases_rank",
                            [rank_env(r, 4, port) for r in range(4)], cases)
        for name, (fn, *args) in refs.items():
            want[name] = fn(*args)
        results = ranks.result()
    want["tmp"] = tmp
    _RESULTS["all"] = want, results
    return want, results


@pytest.fixture(scope="module", autouse=True)
def _cleanup():
    yield
    if _RESULTS:
        shutil.rmtree(_RESULTS["all"][0]["tmp"], ignore_errors=True)


@pytest.mark.parametrize("name", list(CELLS))
def test_step_matches_jax(name):
    want, results = world_results()
    w = want[name]
    got = [r[name] for r in results]
    for r in got:
        assert r["same_specs"], "the model does not read as its whole tree"
        assert r["losses"] == got[0]["losses"]
        assert r["aux"] == got[0]["aux"]
        for a, b in zip(r["params"], got[0]["params"]):
            for path, leaf in _flat(a).items():
                assert np.array_equal(leaf, _flat(b)[path]), path
    np.testing.assert_allclose(got[0]["losses"], w["losses"], rtol=LOSS_TOL)
    np.testing.assert_allclose(got[0]["aux"], w["aux"], rtol=LOSS_TOL)
    for i, (g, t) in enumerate(zip(got[0]["params"], w["params"])):
        _assert_leaves_close(g, t, LEAF_RTOL, lr_sum=(i + 1) * LR)


def _held(results, name):
    return [r[name]["held"] for r in results]


def test_fsdp_beside_tp_holds_a_quarter_of_a_split_leaf():
    _, results = world_results()
    for held in _held(results, "fsdp2tp2"):
        # mlp/in_proj [64, 128]: tp splits d_ff and fsdp cuts the tp part
        # on the same dim; qkv [64, 3, 4, 16]: tp splits the heads, fsdp
        # (its largest dim) d_model; the moments likewise.
        for name, shape in (("blocks.0.mlp.in_proj.kernel", (64, 32)),
                            ("blocks.0.attn.qkv.kernel", (32, 3, 2, 16)),
                            ("lm_head.kernel", (32, 32)),
                            ("embed.weight", (16, 64))):
            assert held[name][0] == shape, (name, held[name])
            assert held[name][1]["exp_avg"] == shape
        # A whole leaf (a norm's scale) is cut over fsdp alone.
        assert held["norm.scale"][0] == (32,)


def test_zero1_beside_tp_cuts_the_tp_part_of_each_moment():
    _, results = world_results()
    for name in ("zero_dp2tp2", "zero_dp2tp2_lamb"):
        for held in _held(results, name):
            # The weight is the tp part; its moments half of that over dp.
            w, moments = held["blocks.0.mlp.in_proj.kernel"]
            assert w == (64, 64)
            assert moments["exp_avg"] == (64, 32)


def test_expert_parallel_beside_tp_holds_half_the_experts():
    _, results = world_results()
    for held in _held(results, "moe_ep2tp2"):
        assert held["blocks.1.moe.w_in"][0] == (2, 64, 128)
        assert held["blocks.0.mlp.in_proj.kernel"][0] == (64, 64)
        assert held["blocks.1.moe.router"][0] == (64, 4)


def test_sharded_lm_xent_over_fsdp_and_tp_matches_jax():
    want, results = world_results()
    w = want["xent"]
    for r in results:
        np.testing.assert_allclose(r["xent"]["value"], w["value"],
                                   rtol=1e-6)
        for key in ("hidden", "kernel", "bias"):
            np.testing.assert_allclose(r["xent"][key], w[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(CELLS))
def test_checkpoint_restores_bitwise_at_its_layout(name):
    _, results = world_results()
    for r in results:
        assert r[name]["kept"] == []


@pytest.mark.parametrize("name", list(CELLS))
def test_checkpoint_restores_bitwise_at_one_process(name):
    from tf_operator_tpu_torch.models.convert import (
        _leaves,
        flax_path,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import checkpoint, steps

    want, results = world_results()
    _, cfg_kw, _, tx_name, _ = CELLS[name]
    directory = os.path.join(want["tmp"], name)
    saved, _ = checkpoint.read(directory, STEPS)
    # The saved tree is the ranks' gathered state.
    final = _flat(results[0][name]["params"][-1])
    for path, t in _leaves(saved["params"]):
        assert np.array_equal(t.numpy(), final[path]), path
    moments = results[0][name]["moments"]
    for key, tree in saved["opt"].items():
        for path, t in _leaves(tree):
            if t.dim():
                assert np.array_equal(t.numpy(), moments[path + (key,)]), (
                    key, path)
    cfg = TransformerConfig(dtype=torch.float32, **cfg_kw)
    model = load_params(Transformer(cfg, device="cpu"), seeded_tree(cfg_kw,
                                                                    1))
    state = steps.TrainState.create(model, getattr(steps, tx_name)(LR))
    with checkpoint.CheckpointManager(directory) as mgr:
        mgr.restore(STEPS, state)
    assert state.step == STEPS
    for n, q in model.named_parameters():
        path = flax_path(n)
        assert torch.equal(q.detach(), checkpoint._tree_get(
            saved["params"], path)), n
        for key, val in state.optimizer.state[q].items():
            if val.dim():
                assert torch.equal(val, checkpoint._tree_get(
                    saved["opt"][key], path)), (key, n)


# -- dist_lm: --ep beside --tp or --sp, and --data beside --ep ----------------

ENTRY = ["--device", "cpu", "--moe-every-n", "2", "--moe-experts", "4",
         "--ep", "2", "--steps", "12", "--target-loss", "10"]
ENTRY_MESHES = {"tp": {"dp": 1, "sp": 1, "tp": 2, "ep": 2},
                "sp": {"dp": 1, "sp": 2, "tp": 1, "ep": 2}}
# C6's runs: a small MoE model over a token-record corpus.
DATA_KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_seq_len=32, moe_every_n=2, moe_experts=4, moe_top_k=2)
DATA_FLAGS = ["--device", "cpu", "--moe-every-n", "2", "--moe-experts", "4",
              "--d-model", "64", "--seq", "32", "--vocab", "64", "--batch",
              "8", "--steps", "6", "--target-loss", "10"]
DATA_STEPS = 6

# A rank of a recorded dist_lm run: the rows of every step's batch and the
# exit code, pickled to argv[3].
RECORDER = """
import pickle, sys
import torch
torch.set_num_threads(1)
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import test_torch_a8i
out = test_torch_a8i.recorded_dist_lm(sys.argv[4:])
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""


def recorded_dist_lm(flags):
    """``dist_lm.main(flags)`` in this process with every step's batch
    recorded: ``(exit code, [the step's tokens as numpy])``."""
    from tf_operator_tpu_torch.train import dist_lm, steps

    seen = []
    real = steps.make_lm_train_step

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, batch):
            seen.append(np.array(batch["tokens"]))
            return step(state, batch)

        return wrapped

    steps.make_lm_train_step = recording
    return dist_lm.main(flags), seen


def _start_recorded(flags, world, tmp, tag):
    port = free_port()
    procs = []
    for r in range(world):
        env = rank_env(r, world, port)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        with open(os.path.join(tmp, f"{tag}{r}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RECORDER, REPO, TESTS,
                 os.path.join(tmp, f"{tag}{r}.pkl"), *flags], cwd=REPO,
                env=env, stdout=out, stderr=subprocess.STDOUT))
    return procs


def _recorded(tmp, tag, world):
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{tag}{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_entry_losses(axes, steps, batches, kw, chunk):
    """examples/dist_lm.py's step over ``axes`` (its mesh, the Megatron
    and expert rules, AdamW at 3e-3 and the aux weight 0.01) from the
    port's seeded tree over ``batches(i)``: the losses at the steps
    dist_lm prints."""
    import jax.numpy as jnp

    from tf_operator_tpu.models.moe import moe_param_sharding_rules
    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    mesh = _jax_mesh(axes)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **kw))
    rules = dict(param_sharding_rules())
    rules.update(moe_param_sharding_rules())
    params = shard_params_by_rules(mesh, init_params(TransformerConfig(
        **kw), 0), rules)
    tx = jax_steps.adamw(3e-3)
    state = jax_steps.TrainState.create(params, tx)
    step = jax_steps.make_lm_train_step(model, tx, mesh, donate=False,
                                        xent_chunk=chunk,
                                        aux_loss_weight=0.01)
    out = {}
    for i in range(steps):
        state, m = step(state, batches(i))
        if i == 0 or (i + 1) % 20 == 0 or i == steps - 1:
            out[i + 1] = float(m["loss"])
    return out


def _chain_batch(i, batch=8, seq=128, vocab=256):
    """dist_lm's synthetic batch of step ``i``."""
    rng = np.random.default_rng((7, i))
    start = rng.integers(0, vocab, (batch, 1))
    chain = ((start + np.arange(seq + 1)) % vocab).astype(np.int32)
    return {"tokens": chain[:, :-1], "targets": chain[:, 1:]}


def _assert_follows(logs, want, steps):
    for out in logs:
        assert _printed(out) == _printed(logs[0])
    printed, final = _printed(logs[0])
    assert final is not None
    for s, v in {**printed, steps: final}.items():
        assert abs(v - want[s]) <= ENTRY_TOL, (s, v, want[s])


@pytest.mark.parametrize("beside", list(ENTRY_MESHES))
def test_dist_lm_ep2_beside_tp_or_sp_follows_jax(beside, tmp_path):
    """``dist_lm --moe-every-n 2 --ep 2 --tp 2`` (and ``--sp 2``) as 4
    processes: JAX's mesh line, its losses within ENTRY_TOL of JAX's
    example at the same flags; the ``--tp`` run's final checkpoint
    (written whole) restores into a plain model at one process
    bitwise."""
    from tf_operator_tpu_torch.train import checkpoint

    tmp = str(tmp_path)
    ck = str(tmp_path / "ck")
    flags = ENTRY + [f"--{beside}", "2"]
    if beside == "tp":
        flags += ["--checkpoint-dir", ck]
    procs = _start(flags, 4, tmp, "ep")
    kw = dict(vocab_size=256, d_model=128, n_heads=4, n_layers=2,
              d_ff=256, max_seq_len=128, moe_every_n=2, moe_experts=4,
              moe_top_k=2)
    want = _jax_entry_losses(ENTRY_MESHES[beside], 12, _chain_batch, kw,
                             128 // ENTRY_MESHES[beside]["sp"] // 2)
    codes = _wait(procs)
    logs = [_log(tmp, "ep", r) for r in range(4)]
    assert codes == [0] * 4, "".join(logs)
    mesh = ENTRY_MESHES[beside]
    for r, out in enumerate(logs):
        assert (f"dist_lm: process {r}/4, mesh {{'dp': 1, 'sp': "
                f"{mesh['sp']}, 'tp': {mesh['tp']}, 'ep': 2}}" in out)
    _assert_follows(logs, want, 12)
    if beside == "tp":
        assert _restore_ep1(ck, checkpoint.latest_step(ck)) == []


def _corpus(tmp):
    from test_torch_dist_lm import chain_corpus

    return chain_corpus(os.path.join(tmp, "corpus.bin"), 24, 32, 64)


def test_data_beside_ep_at_dp1_reads_jax_s_rows_and_losses(tmp_path):
    """C6: ``--data --ep 2 --moe-every-n 2`` as 2 processes (dp 1 x ep
    2): each rank trains on JAX's single process's rows, step by step
    (examples/dist_lm.py's row stream over JAX's token_dataset, shard 0 of
    1), and its printed losses follow JAX's example's step on those rows
    within ENTRY_TOL."""
    from test_torch_dist_lm import _jax_rows

    tmp = str(tmp_path)
    path = _corpus(tmp)
    procs = _start_recorded(DATA_FLAGS + ["--ep", "2", "--data", path], 2,
                            tmp, "c6")
    rows = _jax_rows(path, 32, 8, 0, DATA_STEPS, 64)
    want = _jax_entry_losses(
        {"dp": 1, "sp": 1, "tp": 1, "ep": 2}, DATA_STEPS,
        lambda i: rows[i], DATA_KW, 16)
    codes = _wait(procs)
    logs = [_log(tmp, "c6", r) for r in range(2)]
    assert codes == [0, 0], "".join(logs)
    for rc, seen in _recorded(tmp, "c6", 2):
        assert rc == 0 and len(seen) == DATA_STEPS
        for got, w in zip(seen, rows):
            np.testing.assert_array_equal(got, w["tokens"])
    _assert_follows(logs, want, DATA_STEPS)


def test_data_beside_ep_at_dp2_gives_each_index_its_dp_shard(tmp_path):
    """C6: ``--data --ep 2`` as 4 processes (dp 2 x ep 2): the two ep
    ranks of each dp index train on the same rows, which are the rows the
    pure-dp ``--data`` run (2 processes, ``--ep 1``) gives that index, and
    the two runs' printed losses agree within ENTRY_TOL."""
    tmp = str(tmp_path)
    path = _corpus(tmp)
    four = _start_recorded(DATA_FLAGS + ["--ep", "2", "--data", path], 4,
                           tmp, "ep")
    assert _wait(four) == [0] * 4, "".join(_log(tmp, "ep", r)
                                           for r in range(4))
    two = _start_recorded(DATA_FLAGS + ["--data", path], 2, tmp, "dp")
    assert _wait(two) == [0, 0], "".join(_log(tmp, "dp", r)
                                         for r in range(2))
    ep, dp = _recorded(tmp, "ep", 4), _recorded(tmp, "dp", 2)
    for r, (rc, seen) in enumerate(ep):
        # The mesh is {"dp": 2, "ep": 2}: rank r is dp index r // 2.
        assert rc == 0 and len(seen) == DATA_STEPS
        for got, want in zip(seen, dp[r // 2][1]):
            np.testing.assert_array_equal(got, want)
    assert not np.array_equal(dp[0][1][0], dp[1][1][0])
    got, final = _printed(_log(tmp, "ep"))
    want, want_final = _printed(_log(tmp, "dp"))
    assert got.keys() == want.keys()
    for s in got:
        assert abs(got[s] - want[s]) <= ENTRY_TOL, s
    assert abs(final - want_final) <= ENTRY_TOL
