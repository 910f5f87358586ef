"""FSDP and ZeRO-1 beside expert parallelism (tf_operator_tpu_torch's
``whole_shapes`` and ``FullyShardedParallel`` in ``parallel/sharding.py``,
``param_cuts``, ``ZeroOneOptimizer`` and ``_placement`` in
``train/steps.py``, and the checkpoints' ``_Layout``), held against JAX
on the CPU. The port's world is 4 gloo processes; JAX's is one process
over a mesh of the conftest's virtual CPU devices. One spawn runs every
cell (``world_results``); each rank runs one thread.

- The steps (``CELLS``), 3 steps each from one seeded tree against JAX's
  step on the same mesh and placement (``fsdp_sharding_tree`` or
  ``weight_update_shardings`` of the whole tree): the MoE LM at dp 1 x
  fsdp 2 x ep 2 with AdamW, and with Adafactor at a width whose expert
  leaves factor; at dp 2 x ep 2 under ZeRO-1 with AdamW and LAMB. Losses
  and the MoE aux within tests/test_torch_dp.py's ``LOSS_TOL`` (1e-5
  relative), every leaf within its ``LEAF_RTOL`` (1e-4 of the leaf's
  largest magnitude) plus Adam's noise bound, as tests/test_torch_a8i.py
  states them. Every rank reports the same losses and whole trees. A
  rank holds 1/(ep fsdp) of each expert leaf and of its moments (1/(ep
  dp) of the moments under ZeRO-1).
- Checkpoints: each cell's state saved at its layout (rank 0 writes the
  gathered tree), restored at the same layout (weights and moments
  bitwise) and at one process (ep 1, no FSDP or ZeRO-1) bitwise the
  saved tree, which is the ranks' gathered state.
- An expert leaf whose spec names dim 0 where ``n_experts / ep`` does not
  divide by the fsdp (or dp) size raises ``ValueError`` naming the leaf;
  FSDP or ZeRO-1 beside ep and tp or sp raises, naming ROADMAP.md A8m.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from test_torch_a8i import (
    LR,
    MIN_SIZE,
    MOE_KW,
    SEQ,
    STEPS,
    _moments,
    _rules,
    _whole,
    lm_tokens,
)
from test_torch_dp import (
    LEAF_RTOL,
    LOSS_TOL,
    _assert_leaves_close,
    _flat,
    free_port,
    rank_env,
    run_processes,
)
from test_torch_tp_train import _jax_mesh, seeded_tree

torch.set_num_threads(1)

# Adafactor's cell: expert leaves [4, 128, 192] factor (dims >= 128).
MOE_FACTOR_KW = dict(MOE_KW, d_model=128, d_ff=192, vocab_size=256)
FSDP2EP2 = {"dp": 1, "fsdp": 2, "ep": 2}
DP2EP2 = {"dp": 2, "ep": 2}
DATA = ("dp", "fsdp")
AUX_WEIGHT = 0.01

# name -> (mesh axes, config keywords, placement, optimiser, xent chunk)
CELLS = {
    "fsdp2ep2": (FSDP2EP2, MOE_KW, "fsdp", "adamw", SEQ // 2),
    "fsdp2ep2_adafactor": (FSDP2EP2, MOE_FACTOR_KW, "fsdp", "adafactor",
                           SEQ // 2),
    "zero_dp2ep2": (DP2EP2, MOE_KW, "zero", "adamw", SEQ // 2),
    "zero_dp2ep2_lamb": (DP2EP2, MOE_KW, "zero", "lamb", SEQ // 2),
}


def _data(axes):
    """The cell's data axes: dp, and fsdp where the mesh has it."""
    return DATA if "fsdp" in axes else "dp"


# -- the ranks' side (torch and the port only) ------------------------------


def cases_rank(rank, world, cases):
    """Every cell in turn, one world."""
    return {name: cell_rank(rank, world, p) for name, p in cases}


def _build(p):
    """The cell's model (its experts of the seeded tree), optimiser,
    state (replicated over the mesh) and step; and whether the model reads
    as the whole tree's FSDP specs."""
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
    tree = sharding.shard_params_by_rules(mesh, p["params"], _rules(axes))
    model = load_params(Transformer(cfg, device="cpu"), tree)
    kw, same = {}, True
    if placement == "fsdp":
        kw["param_shardings"] = sharding.fsdp_sharding_tree(
            mesh, p["params"], min_size=MIN_SIZE)
        same = sharding.fsdp_sharding_tree(
            mesh, model, min_size=MIN_SIZE) == kw["param_shardings"]
        sharding.shard_params_fsdp(mesh, model, min_size=MIN_SIZE)
    else:
        kw["opt_shardings"] = sharding.weight_update_shardings(
            mesh, p["params"], min_size=MIN_SIZE)
    tx = getattr(steps, tx_name)(LR)
    state = sharding.replicate(mesh, steps.TrainState.create(model, tx))
    step = steps.make_lm_train_step(
        model, tx, mesh=mesh, data_axis=_data(axes), xent_chunk=chunk,
        aux_loss_weight=AUX_WEIGHT, **kw)
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
        aux.append(float(m["aux_loss"]))
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


# -- the JAX side ------------------------------------------------------------


def _jax_cell(name, params, batches):
    """JAX's losses, aux and whole trees after each step for cell
    ``name``: its MoE model over the cell's mesh, the tree placed by
    ``shard_params_fsdp`` with ``param_shardings``, or replicated with
    ``opt_shardings``."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
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
    else:
        state = jax_steps.TrainState.create(
            jax_sharding.replicate(mesh, params), tx)
        kw["opt_shardings"] = jax_sharding.weight_update_shardings(
            mesh, state.opt_state, min_size=MIN_SIZE)
        state = state.replace(opt_state=jax.tree.map(
            jax.device_put, state.opt_state, kw["opt_shardings"]))
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, data_axis=_data(axes), donate=False,
        xent_chunk=chunk, aux_loss_weight=AUX_WEIGHT, **kw)
    losses, aux, trees = [], [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "aux": aux, "params": trees}


_RESULTS: dict = {}


def world_results() -> tuple[dict, list]:
    """(JAX's references, the 4 ranks' results) of every cell, computed
    once; the ranks start first and JAX's references are computed while
    they run."""
    if _RESULTS:
        return _RESULTS["all"]
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="a8l_ckpt")
    cases, want = [], {}
    for i, (name, (_, cfg_kw, _, _, _)) in enumerate(CELLS.items()):
        params = seeded_tree(cfg_kw, 60 + i)
        batches = [lm_tokens(cfg_kw, 70 + 10 * i + s) for s in range(STEPS)]
        cases.append((name, {"name": name, "params": params,
                             "batches": batches,
                             "dir": os.path.join(tmp, name)}))
    port = free_port()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_processes, "test_torch_a8l", "cases_rank",
                            [rank_env(r, 4, port) for r in range(4)], cases)
        for name, p in cases:
            want[name] = _jax_cell(name, p["params"], p["batches"])
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


# A rank's part of each expert leaf (whole [4, 64, 128] and [4, 128, 64];
# Adafactor's [4, 128, 192] and [4, 192, 128]) and of its moments: ep
# takes 2 of the 4 experts, then fsdp (or ZeRO-1's dp) halves the dim the
# whole leaf's spec names, its largest.
HELD = {
    "fsdp2ep2": {"w_in": ((2, 64, 64), {"exp_avg": (2, 64, 64)}),
                 "w_out": ((2, 64, 64), {"exp_avg": (2, 64, 64)})},
    "fsdp2ep2_adafactor": {
        "w_in": ((2, 128, 96), {"v_row": (2, 128), "v_col": (2, 96)}),
        "w_out": ((2, 96, 128), {"v_row": (2, 128), "v_col": (2, 96)})},
    "zero_dp2ep2": {"w_in": ((2, 64, 128), {"exp_avg": (2, 64, 64)}),
                    "w_out": ((2, 128, 64), {"exp_avg": (2, 64, 64)})},
    "zero_dp2ep2_lamb": {"w_in": ((2, 64, 128), {"exp_avg": (2, 64, 64)}),
                         "w_out": ((2, 128, 64), {"exp_avg": (2, 64, 64)})},
}


@pytest.mark.parametrize("name", list(CELLS))
def test_a_rank_holds_its_share_of_each_expert_leaf(name):
    _, results = world_results()
    for r in results:
        held = r[name]["held"]
        for leaf, (shape, moments) in HELD[name].items():
            got = held[f"blocks.1.moe.{leaf}"]
            assert got[0] == shape, (leaf, got)
            for key, want in moments.items():
                assert got[1][key] == want, (leaf, key, got)
        # A dense leaf beside them ([64, 128], Adafactor's [128, 192]):
        # FSDP cuts it, ZeRO-1 its moments, on its largest dim.
        dense = held["blocks.0.mlp.in_proj.kernel"]
        if name.startswith("fsdp"):
            assert dense[0] == ((128, 96) if "adafactor" in name
                                else (64, 64))
        else:
            assert dense == ((64, 128), {"exp_avg": (64, 64),
                                         "exp_avg_sq": (64, 64)})


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
    assert saved["params"]["block_1"]["moe"]["w_in"].shape[0] == 4
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


def _moe_model(axes, **kw):
    """Rank 0's MoE LM over ``axes`` (no process group: a placement
    check raises before any collective)."""
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(axes, range(int(np.prod(list(axes.values())))))
    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh,
                            **dict(MOE_KW, **kw))
    return mesh, Transformer(cfg, device="cpu")


@pytest.mark.parametrize("kind", ["fsdp", "zero"])
def test_experts_that_do_not_divide_name_the_leaf(kind):
    """130 experts [130, 64, 128]: the spec names dim 0 (the largest the
    axis divides), and ep 2 leaves 65 a rank, which 2 does not divide."""
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.train import steps

    axes = FSDP2EP2 if kind == "fsdp" else DP2EP2
    mesh, model = _moe_model(axes, moe_experts=130)
    spec = sharding.fsdp_spec((130, 64, 128), "fsdp", 2, MIN_SIZE)
    assert spec == ("fsdp", None, None)
    with pytest.raises(ValueError, match=r"w_in.*\(65, 64, 128\)"):
        if kind == "fsdp":
            sharding.shard_params_fsdp(mesh, model, min_size=MIN_SIZE)
        else:
            steps.make_lm_train_step(
                model, steps.adamw(LR), mesh=mesh,
                opt_shardings=sharding.weight_update_shardings(
                    mesh, model, min_size=MIN_SIZE))


@pytest.mark.parametrize("kind", ["fsdp", "zero"])
@pytest.mark.parametrize("beside", ["tp", "sp"])
def test_fsdp_or_zero1_beside_ep_and_tp_or_sp_names_a8m(kind, beside):
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.train import steps

    data = {"fsdp": {"dp": 1, "fsdp": 2}, "zero": {"dp": 2}}[kind]
    mesh, model = _moe_model(dict(data, ep=2, **{beside: 2}))
    kw = ({"param_shardings": sharding.fsdp_sharding_tree(mesh, model)}
          if kind == "fsdp" else
          {"opt_shardings": sharding.weight_update_shardings(mesh, model)})
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8m"):
        steps.make_lm_train_step(model, steps.adamw(LR), mesh=mesh,
                                 data_axis=_data(data), **kw)
