"""Expert parallelism (tf_operator_tpu_torch/models/moe.py over a mesh's
``ep`` axis, ``moe_param_sharding_rules``, the model, the step, the
checkpoints and ``dist_lm --ep``) held against JAX on the CPU. The
port's world is 4 gloo processes; JAX's is one process over a mesh of the
conftest's virtual CPU devices. One spawn runs every cell
(``world_results``); each rank runs one thread, and at most 4 ranks run
at once.

- ``MoeMlp`` at ``{"dp": 2, "ep": 2}`` and ``{"ep": 4}``, Switch and
  top-2 (tests/test_moe_pipeline.py's ``test_moe_sharded_matches_unsharded``
  and ``test_top2_sharded_matches_unsharded``: 4 experts, d 16, f 32,
  ``[4, 8, 16]`` rows): each rank's rows of the output within JAX's
  1e-5 of JAX's sharded layer, the aux within ``LOSS_TOL``. Each rank
  holds 4 / ep experts.
- ``MoeBlock`` over the same meshes: the gradients of JAX's
  ``test_moe_block_trains`` loss (``(out ** 2).mean() + 0.01 aux``),
  averaged over dp as the step averages them and the experts gathered
  over ep, within tests/test_torch_dp.py's ``LEAF_RTOL`` of the largest
  magnitude of each leaf.
- The MoE LM step at ``{"dp": 2, "ep": 2}`` (every 2nd block 4 experts,
  top-2, aux weight 0.01, chunked loss): 3 AdamW steps against JAX's step
  on the same mesh from the same tree, placed by
  ``moe_param_sharding_rules``: losses and aux within ``LOSS_TOL``, every
  leaf within ``LEAF_RTOL`` plus Adam's noise bound; each rank's expert
  leaves and their moments hold half the experts.
- ``dist_lm --moe-every-n 2 --moe-experts 4 --ep 2 --device cpu`` as 4
  processes (dp 2 x ep 2): JAX's mesh line, its losses within
  tests/test_torch_tp_train.py's ``ENTRY_TOL`` of JAX's example at the
  same flags; its final checkpoint (written whole) restores into a plain
  model at one process bitwise; JAX's two usage errors of ``--ep``, and
  ``--ep`` beside ``--tp`` past them.
"""

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
from test_torch_tp_train import (
    ENTRY_TOL,
    _jax_mesh,
    _log,
    _printed,
    _start,
    _tree,
    _wait,
    seeded_tree,
)

torch.set_num_threads(1)

FUNC_TOL = 1e-5
E, D, F_ = 4, 16, 32
MESHES = {"dp2ep2": {"dp": 2, "ep": 2}, "ep4": {"ep": 4}}
LAYER_CELLS = {f"{m}-k{k}": (m, k) for m in MESHES for k in (1, 2)}
LR, SEQ = 5e-3, 16
LM_KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=SEQ, moe_every_n=2, moe_experts=4, moe_top_k=2)
STEP_AXES = {"dp": 2, "ep": 2}


def _moe_input(seed):
    return np.random.default_rng(seed).normal(size=(4, 8, D)).astype(
        np.float32)


def _lm_batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        chain = (rng.integers(0, 64, (8, 1)) + np.arange(SEQ + 1)) % 64
        out.append({"tokens": chain[:, :-1].astype(np.int32),
                    "targets": chain[:, 1:].astype(np.int32)})
    return out


# -- the ranks' side (torch and the port only) ------------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _rows(mesh, x):
    """This rank's rows of a global batch (by its dp index)."""
    from tf_operator_tpu_torch.parallel.sharding import DataParallel

    dp = DataParallel(mesh, "dp")
    n = x.shape[0] // dp.size
    return x[dp.index * n:(dp.index + 1) * n], dp


def layer_rank(rank, world, p):
    """``MoeMlp`` and ``MoeBlock`` over the cell's mesh: the output rows,
    the aux, the block's gradients (averaged over dp, experts gathered
    over ep) and the experts a rank holds."""
    from tf_operator_tpu_torch.models import moe
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import attach

    mesh = create_mesh(MESHES[p["mesh"]], device="cpu")
    cfg = moe.MoeConfig(n_experts=E, d_model=D, d_ff=F_, router_top_k=p["k"],
                        dtype=torch.float32, mesh=mesh)
    x, dp = _rows(mesh, torch.from_numpy(p["x"]))

    def load(m, tree):
        ep = m.ep
        n = E // ep.size
        with torch.no_grad():
            m.router.copy_(torch.tensor(tree["router"]))
            for name in ("w_in", "w_out"):
                getattr(m, name).copy_(torch.tensor(
                    tree[name][ep.index * n:(ep.index + 1) * n]))

    mlp = moe.MoeMlp(cfg, device="cpu")
    load(mlp, p["mlp"])
    attach(mlp, dp)
    with torch.no_grad():
        y, aux = mlp(x)
    blk = moe.MoeBlock(cfg, device="cpu")
    load(blk.moe, p["block"]["moe"])
    with torch.no_grad():
        blk.norm.scale.copy_(torch.tensor(p["block"]["RMSNorm_0"]["scale"]))
    attach(blk, dp)
    out, baux = blk(x)
    ((out ** 2).mean() + 0.01 * baux).backward()
    dp.mean_grads(list(blk.parameters()))
    grads = {"RMSNorm_0": {"scale": blk.norm.scale.grad.numpy()},
             "moe": {"router": blk.moe.router.grad.numpy()}}
    for name in ("w_in", "w_out"):
        g = getattr(blk.moe, name).grad
        grads["moe"][name] = blk.moe.ep.all_gather(g, 0).numpy()
    return {"y": y.numpy(), "aux": float(aux), "grads": grads,
            "experts": mlp.w_in.shape[0]}


def step_rank(rank, world, p):
    """The MoE LM step at ``{"dp": 2, "ep": 2}``: losses, aux, the whole
    trees after each step, and the expert leaves' and their moments'
    leading dims."""
    from tf_operator_tpu_torch.models.convert import (
        flax_path,
        load_params,
        param_shapes,
    )
    from tf_operator_tpu_torch.models.moe import moe_param_sharding_rules
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        gather_params_by_rules,
        shard_params_by_rules,
    )
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(STEP_AXES, device="cpu")
    rules = moe_param_sharding_rules()
    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh, **LM_KW)
    model = load_params(Transformer(cfg, device="cpu"),
                        shard_params_by_rules(mesh, p["params"], rules))
    tx = steps.adamw(LR)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx, mesh=mesh, xent_chunk=SEQ // 2,
                                    aux_loss_weight=0.01)
    losses, aux, trees = [], [], []
    for batch in p["batches"]:
        rows = {k: _rows(mesh, v)[0] for k, v in batch.items()}
        state, m = step(state, rows)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
        tree = _tree({flax_path(n): q.detach().clone()
                      for n, q in model.named_parameters()})
        whole = gather_params_by_rules(mesh, tree, rules, param_shapes(cfg))
        trees.append(_tree(_flat(whole)))
    w_in = model.blocks[1].moe.w_in
    return {"losses": losses, "aux": aux, "params": trees,
            "experts": (w_in.shape[0],
                        state.optimizer.state[w_in]["exp_avg"].shape[0])}


# -- the JAX side ------------------------------------------------------------


def _jax_moe_cfg(mesh, k):
    import jax.numpy as jnp

    from tf_operator_tpu.models.moe import MoeConfig

    return MoeConfig(n_experts=E, d_model=D, d_ff=F_, router_top_k=k,
                     dtype=jnp.float32, mesh=mesh)


def _jax_layer(mesh_name, k, mlp, block, x):
    """JAX's sharded MoeMlp output and aux, and its MoeBlock's gradients
    of ``(out ** 2).mean() + 0.01 aux``."""
    import jax

    from tf_operator_tpu.models.moe import MoeBlock, MoeMlp, aux_loss_from
    from tf_operator_tpu.models.moe import moe_param_sharding_rules
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules

    mesh = _jax_mesh(MESHES[mesh_name])
    cfg = _jax_moe_cfg(mesh, k)
    rules = moe_param_sharding_rules()
    sharded = MoeMlp(cfg)
    y, col = jax.jit(lambda p, x: sharded.apply(
        {"params": p}, x, mutable=["losses"]))(
        shard_params_by_rules(mesh, mlp, rules), x)
    model = MoeBlock(cfg)

    def loss(p):
        out, c = model.apply({"params": p}, x, mutable=["losses"])
        return (out ** 2).mean() + 0.01 * aux_loss_from(c)

    g = jax.jit(jax.grad(loss))(shard_params_by_rules(mesh, block, rules))
    return {"y": np.asarray(y), "aux": float(aux_loss_from(col)),
            "grads": jax.tree.map(np.asarray, g)}


def _jax_step(params, batches):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.moe import moe_param_sharding_rules
    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps

    mesh = _jax_mesh(STEP_AXES)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **LM_KW))
    placed = shard_params_by_rules(mesh, params, moe_param_sharding_rules())
    tx = jax_steps.adamw(LR)
    state = jax_steps.TrainState.create(placed, tx)
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, seq_axis=None, donate=False, xent_chunk=SEQ // 2,
        aux_loss_weight=0.01)
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
    import jax

    from tf_operator_tpu.models.moe import MoeBlock, MoeMlp
    from concurrent.futures import ThreadPoolExecutor

    cases, refs = [], {}
    for name, (mesh_name, k) in LAYER_CELLS.items():
        x = _moe_input(3 + k)
        cfg = _jax_moe_cfg(None, k)
        mlp = jax.tree.map(np.asarray, MoeMlp(cfg).init(
            jax.random.PRNGKey(k), x)["params"])
        block = jax.tree.map(np.asarray, MoeBlock(cfg).init(
            jax.random.PRNGKey(10 + k), x)["params"])
        cases.append((name, "layer_rank", {"mesh": mesh_name, "k": k,
                                           "x": x, "mlp": mlp,
                                           "block": block}))
        refs[name] = (_jax_layer, mesh_name, k, mlp, block, x)
    params = seeded_tree(LM_KW, 20)
    batches = _lm_batches(3, 21)
    cases.append(("step", "step_rank", {"params": params,
                                        "batches": batches}))
    refs["step"] = (_jax_step, params, batches)
    port = free_port()
    want = {}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_processes, "test_torch_ep", "cases_rank",
                            [rank_env(r, 4, port) for r in range(4)], cases)
        for name, (fn, *args) in refs.items():
            want[name] = fn(*args)
        results = ranks.result()
    _RESULTS["all"] = want, results
    return want, results


@pytest.mark.parametrize("name", list(LAYER_CELLS))
def test_moe_mlp_over_ep_matches_jax_sharded_layer(name):
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    want, results = world_results()
    mesh_name, _ = LAYER_CELLS[name]
    mesh = create_mesh(MESHES[mesh_name], range(4))
    w = want[name]
    for rank, r in enumerate(results):
        got = r[name]
        i = mesh.coords(rank).get("dp", 0)
        n = w["y"].shape[0] // mesh.shape.get("dp", 1)
        err = float(np.abs(got["y"] - w["y"][i * n:(i + 1) * n]).max())
        assert err <= FUNC_TOL, (rank, err)
        assert abs(got["aux"] - w["aux"]) <= LOSS_TOL * abs(w["aux"])
        assert got["experts"] == E // mesh.shape["ep"]


@pytest.mark.parametrize("name", list(LAYER_CELLS))
def test_moe_block_gradients_over_ep_match_jax(name):
    want, results = world_results()
    for r in results:
        _assert_leaves_close(r[name]["grads"], want[name]["grads"],
                             LEAF_RTOL)


def test_moe_lm_step_at_dp2_ep2_matches_jax():
    want, results = world_results()
    w = want["step"]
    got = [r["step"] for r in results]
    for r in got:
        assert r["losses"] == got[0]["losses"]
        for a, b in zip(r["params"], got[0]["params"]):
            for path, leaf in _flat(a).items():
                assert np.array_equal(leaf, _flat(b)[path]), path
        # Half of the 4 experts a rank, and their moments likewise.
        assert r["experts"] == (2, 2)
    np.testing.assert_allclose(got[0]["losses"], w["losses"], rtol=LOSS_TOL)
    np.testing.assert_allclose(got[0]["aux"], w["aux"], rtol=LOSS_TOL)
    for i, (g, t) in enumerate(zip(got[0]["params"], w["params"])):
        _assert_leaves_close(g, t, LEAF_RTOL, lr_sum=(i + 1) * LR)


# -- dist_lm --ep --------------------------------------------------------------

ENTRY = ["--device", "cpu", "--moe-every-n", "2", "--moe-experts", "4",
         "--ep", "2", "--steps", "12", "--target-loss", "10"]


def _jax_entry_losses():
    """examples/dist_lm.py's step at ENTRY's flags on 4 virtual devices
    (its mesh, rules, batches, chunk, aux weight and AdamW), from the
    port's seeded tree: the losses at the steps dist_lm prints."""
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

    steps, batch, seq, vocab, d = 12, 8, 128, 256, 128
    kw = dict(vocab_size=vocab, d_model=d, n_heads=4, n_layers=2,
              d_ff=2 * d, max_seq_len=seq, moe_every_n=2, moe_experts=4,
              moe_top_k=2)
    mesh = _jax_mesh({"dp": 2, "sp": 1, "tp": 1, "ep": 2})
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **kw))
    rules = dict(param_sharding_rules())
    rules.update(moe_param_sharding_rules())
    params = shard_params_by_rules(mesh, init_params(TransformerConfig(
        **kw), 0), rules)
    tx = jax_steps.adamw(3e-3)
    state = jax_steps.TrainState.create(params, tx)
    step = jax_steps.make_lm_train_step(model, tx, mesh, donate=False,
                                        xent_chunk=seq // 2,
                                        aux_loss_weight=0.01)
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


def _restore_ep1(directory: str, step: int) -> list:
    """The ep 2 checkpoint of ``step`` restored into a plain model as
    dist_lm builds it: the names of the weights and moments that differ
    from the saved tree."""
    from tf_operator_tpu_torch.models.convert import (
        flax_path,
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import checkpoint
    from tf_operator_tpu_torch.train.steps import TrainState, adamw

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_layers=2, d_ff=256, max_seq_len=128,
                            dtype=torch.float32, moe_every_n=2,
                            moe_experts=4, moe_top_k=2)
    model = load_params(Transformer(cfg, device="cpu"), init_params(cfg, 1))
    state = TrainState.create(model, adamw(3e-3))
    with checkpoint.CheckpointManager(directory) as mgr:
        mgr.restore(step, state)
    saved, _ = checkpoint.read(directory, step)
    differ = []
    for name, p in model.named_parameters():
        path = flax_path(name)
        if not torch.equal(p.detach(), checkpoint._tree_get(
                saved["params"], path)):
            differ.append(name)
        for key in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(state.optimizer.state[p][key],
                               checkpoint._tree_get(saved["opt"][key],
                                                    path)):
                differ.append(f"{key} {name}")
    assert state.step == step + 1
    assert saved["params"]["block_1"]["moe"]["w_in"].shape[0] == 4
    return differ


def test_dist_lm_ep2_follows_jax_and_restores_at_ep1(tmp_path):
    tmp = str(tmp_path)
    ck = str(tmp_path / "ck")
    procs = _start(ENTRY + ["--checkpoint-dir", ck], 4, tmp, "ep")
    want = _jax_entry_losses()
    codes = _wait(procs)
    logs = [_log(tmp, "ep", r) for r in range(4)]
    assert codes == [0] * 4, "".join(logs)
    for r, out in enumerate(logs):
        assert (f"dist_lm: process {r}/4, mesh {{'dp': 2, 'sp': 1, "
                "'tp': 1, 'ep': 2}" in out)
        assert _printed(out) == _printed(logs[0])
    printed, final = _printed(logs[0])
    assert printed.keys() == {1} and final is not None
    for s, v in {**printed, 12: final}.items():
        assert abs(v - want[s]) <= ENTRY_TOL, (s, v, want[s])
    from tf_operator_tpu_torch.train import checkpoint

    assert _restore_ep1(ck, checkpoint.latest_step(ck)) == []


def test_dist_lm_ep_usage_errors_are_jax_s():
    from tf_operator_tpu_torch.train import dist_lm

    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu", "--ep", "2"])
    assert exc.value.args == ("--ep requires --moe-every-n",)
    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu", "--moe-every-n", "2",
                      "--moe-experts", "6", "--ep", "4"])
    assert exc.value.args == ("--moe-experts must be a multiple of --ep",)
    # --ep beside --tp passes the usage checks (A8i): a single process
    # reaches the mesh's count of processes, JAX's next error.
    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu", "--moe-every-n", "2", "--ep", "2",
                      "--tp", "2"])
    assert exc.value.args == ("1 devices not divisible by sp*tp*ep*pp=4",)
