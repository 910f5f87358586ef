"""FSDP and ZeRO-1 (tf_operator_tpu_torch/parallel/sharding.py, the train
steps' ``param_shardings`` and ``opt_shardings``, the optimisers on a
part of a leaf and the checkpoints) held against JAX on the CPU. The
port's world is N gloo processes; JAX's is one process over a mesh of the
conftest's virtual CPU devices. One spawn a world size (1, 2 and 4 ranks)
runs every cell of that size (``world_results``); each rank runs one
thread, and at most 4 ranks run at once.

- The rule: ``fsdp_sharding_tree`` equals JAX's specs on JAX's own tree
  (tests/test_parallel.py's ``test_sharding_tree_rules``) and on the
  Transformer's and MnistCNN's trees at fsdp 2, 4 and 8 (a model reads as
  its flax tree); ``shard_params_fsdp``'s slice for each rank is JAX's
  addressable shard of that device, and ``weight_update_shardings`` of
  the params is JAX's spec of AdamW's ``mu`` under
  ``weight_update_shardings(mesh, opt_state)``.
- FSDP: the LM step at ``{"dp": 2, "fsdp": 2}`` with ``data_axis=("dp",
  "fsdp")`` and ``xent_chunk`` 16 (tests/test_training.py's
  ``test_lm_step_fsdp_sharded_state``), and MnistCNN's classifier step at
  ``{"fsdp": 2}`` and ``{"fsdp": 4}`` (tests/test_parallel.py's
  ``TestFsdp``), 3 AdamW steps each against JAX's ``param_shardings``
  step: losses within tests/test_torch_dp.py's ``LOSS_TOL`` (1e-5
  relative), every leaf within its ``LEAF_RTOL`` (1e-4 of the leaf's
  largest magnitude) plus Adam's noise bound, the key bias by its rule.
  Each rank's embedding and its AdamW moments hold 1/n of the rows, and
  the model's cut is the tree's slice for the rank.
- ZeRO-1: the LM step at ``{"dp": 2}`` and ``{"dp": 4}`` with AdamW,
  LAMB and Adafactor (tests/test_parallel.py's
  ``TestWeightUpdateSharding``, tests/test_training.py's
  ``test_lamb_trains_lm_and_shards_moments``; Adafactor at a width whose
  leaves factor) against JAX's ``opt_shardings`` step, by the same
  bounds; the weights stay whole and each rank's big moment holds 1/n of
  the rows.
- Worlds of one: FSDP at ``{"fsdp": 1}``, ZeRO-1 at ``{"dp": 1}`` and the
  MoE LM at ``{"ep": 1}``, each with every collective of a world of one,
  bitwise the plain step's losses and weights.
- Checkpoints: written at dp 4 and restored into an FSDP state at dp 2 x
  fsdp 2, each rank's shards of the weights and moments bitwise the saved
  tree's; an FSDP state's shards bitwise through a round trip; a ZeRO-1
  state written at dp 2 restored at one process, bitwise the saved tree,
  whose moments are the ranks' parts gathered.
"""

import os
import shutil
import tempfile

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
from test_torch_tp_train import _jax_mesh, _tree, seeded_tree

torch.set_num_threads(1)

STEPS, MIN_SIZE = 3, 64
# tests/test_training.py's and tests/test_parallel.py's LM.
LM_KW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=32)
# Adafactor's cell: leaves whose dims reach optax's factoring size.
FACTOR_KW = dict(LM_KW, d_model=128, d_ff=192, vocab_size=256)
FSDP_LR, ZERO_LR = 3e-3, 5e-3
DP2FSDP2 = {"dp": 2, "fsdp": 2}
# name -> (mesh axes, config keywords, optimiser)
ZERO_CELLS = {f"dp{n}_{tx}": ({"dp": n}, FACTOR_KW if tx == "adafactor"
                              else LM_KW, tx)
              for n in (2, 4) for tx in ("adamw", "lamb", "adafactor")}
MNIST_CELLS = {"fsdp2": {"fsdp": 2}, "fsdp4": {"fsdp": 4}}
WORLD1 = ("fsdp1", "zero1", "ep1")


def _size(axes) -> int:
    return int(np.prod(list(axes.values())))


def lm_tokens(cfg_kw, rows, seq, seed):
    """Seeded +1 chains: ``{"tokens", "targets"}`` int32 [rows, seq]."""
    rng = np.random.default_rng(seed)
    chain = (rng.integers(0, cfg_kw["vocab_size"], (rows, 1))
             + np.arange(seq + 1)) % cfg_kw["vocab_size"]
    return {"tokens": chain[:, :-1].astype(np.int32),
            "targets": chain[:, 1:].astype(np.int32)}


def mnist_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(16, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, (16,)).astype(np.int32)}


# -- the ranks' side (torch and the port only) ------------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _whole(model, pick=lambda p: p) -> dict:
    """``pick(parameter)`` of every parameter (its weight, its gradient),
    gathered whole where it is cut, as a flax-layout tree of numpy
    arrays."""
    from tf_operator_tpu_torch.models.convert import variable_layout
    from tf_operator_tpu_torch.train.steps import param_cuts

    leaves, to_flax, _ = variable_layout(model)
    cuts = param_cuts(model)
    out = {}
    for path, p in leaves["params"].items():
        t = pick(p).detach()
        if id(p) in cuts:
            t = cuts[id(p)].gather(t)
        out[path] = to_flax(t).contiguous().numpy().copy()
    return _tree(out)


def _moments(state, key="exp_avg") -> dict:
    """Every parameter's AdamW moment ``key``, gathered whole."""
    from tf_operator_tpu_torch.models.convert import variable_layout
    from tf_operator_tpu_torch.train.steps import param_cuts

    model, opt = state.model, state.optimizer
    leaves, to_flax, _ = variable_layout(model)
    cuts = param_cuts(model)
    held = getattr(opt, "held", lambda p: (p, cuts.get(id(p))))
    out = {}
    for path, p in leaves["params"].items():
        t, cut = held(p)
        m = opt.state[t][key]
        if cut is not None:
            m = cut.gather(m.contiguous())
        out[path] = to_flax(m).contiguous().numpy().copy()
    return _tree(out)


def _rows(dp, batch):
    """The rows of this rank's index on the data axes."""
    n = len(next(iter(batch.values()))) // dp.size
    return {k: v[dp.index * n:(dp.index + 1) * n] for k, v in batch.items()}


def _lm(cfg_kw, params, mesh=None):
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )

    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh, **cfg_kw)
    return load_params(Transformer(cfg, device="cpu"), params)


def _run(step, state, batches, dp):
    losses, trees = [], []
    for batch in batches:
        state, m = step(state, batch if dp is None else _rows(dp, batch))
        losses.append(float(m["loss"]))
        trees.append(_whole(state.model))
    return losses, trees


def fsdp_lm_rank(rank, world, p):
    """The LM step under FSDP at ``{"dp": 2, "fsdp": 2}``; the embedding's
    and a moment's rows a rank, and the model's cut against the tree's
    slice for the rank."""
    from tf_operator_tpu_torch.models.convert import flax_path
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(DP2FSDP2, device="cpu")
    model = _lm(LM_KW, p["params"])
    specs = sharding.fsdp_sharding_tree(mesh, p["params"], min_size=MIN_SIZE)
    assert sharding.fsdp_sharding_tree(mesh, model, min_size=MIN_SIZE) == specs
    sharding.shard_params_fsdp(mesh, model, min_size=MIN_SIZE)
    cut = _flat(sharding.shard_params_fsdp(mesh, p["params"],
                                           min_size=MIN_SIZE))
    same = all(np.array_equal(q.detach().numpy(), cut[flax_path(n)])
               for n, q in model.named_parameters())
    tx = steps.adamw(FSDP_LR)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(
        model, tx, mesh=mesh, data_axis=("dp", "fsdp"),
        param_shardings=specs, xent_chunk=16)
    dp = sharding.DataParallel(mesh, ("dp", "fsdp"))
    losses, trees = _run(step, state, p["batches"], dp)
    emb = model.embed.weight
    return {"losses": losses, "params": trees, "slices_same": same,
            "embed_rows": (emb.shape[0], state.optimizer.state[emb][
                "exp_avg"].shape[0])}


def fsdp_mnist_rank(rank, world, p):
    """MnistCNN's classifier step under FSDP over ``p["axes"]``."""
    from tf_operator_tpu_torch.models.convert import load_variables
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(p["axes"], device="cpu")
    model = load_variables(MnistCNN(dtype=torch.float32, device="cpu"),
                           p["variables"])
    specs = sharding.fsdp_sharding_tree(mesh, p["variables"]["params"],
                                        min_size=MIN_SIZE)
    sharding.shard_params_fsdp(mesh, model, min_size=MIN_SIZE)
    tx = steps.adamw(1e-3)
    state = steps.TrainState.create(model, tx)
    step = steps.make_classifier_train_step(
        model, tx, has_batch_stats=False, mesh=mesh, data_axis="fsdp",
        param_shardings=specs)
    dp = sharding.DataParallel(mesh, "fsdp")
    losses, trees = _run(step, state, [p["batch"]] * STEPS, dp)
    kernel = model.Dense_0.kernel
    return {"losses": losses, "params": trees,
            "kernel_rows": tuple(kernel.shape)}


def zero_rank(rank, world, p):
    """The LM step under ZeRO-1 over ``p["axes"]`` with ``p["tx"]``; the
    weights' shapes and each cut moment's part a rank."""
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(p["axes"], device="cpu")
    model = _lm(p["cfg"], p["params"])
    tx = getattr(steps, p["tx"])(ZERO_LR)
    state = steps.TrainState.create(model, tx)
    opt_sh = sharding.weight_update_shardings(mesh, p["params"],
                                              min_size=MIN_SIZE)
    step = steps.make_lm_train_step(model, tx, mesh=mesh,
                                    opt_shardings=opt_sh)
    dp = sharding.DataParallel(mesh, "dp")
    losses, trees = _run(step, state, p["batches"], dp)
    opt = state.optimizer
    parts = {}
    for name, q in model.named_parameters():
        held, cut = opt.held(q)
        if cut is not None:
            parts[name] = (tuple(q.shape), {
                k: tuple(t.shape) for k, t in opt.state[held].items()},
                cut.dim)
    out = {"losses": losses, "params": trees, "parts": parts,
           "zero": isinstance(opt, steps.ZeroOneOptimizer)}
    if p.get("ckpt"):
        from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

        with CheckpointManager(p["ckpt"]) as mgr:
            mgr.save(STEPS, state, force=True)
        out["moments"] = _moments(state)
    return out


def world1_rank(rank, world, p):
    """FSDP at fsdp 1, ZeRO-1 at dp 1 and the MoE LM at ep 1, each in
    turn with the plain step of the same model: the names of what parts
    from the plain run (empty: bitwise)."""
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps

    differ = {}
    for name in WORLD1:
        cfg_kw = p["moe_cfg"] if name == "ep1" else LM_KW
        params = p["moe_params"] if name == "ep1" else p["params"]
        runs = []
        for side in ("plain", name):
            mesh, kw = None, {}
            if side == "fsdp1":
                mesh = create_mesh({"fsdp": 1}, device="cpu")
            elif side == "zero1":
                mesh = create_mesh({"dp": 1}, device="cpu")
            elif side == "ep1":
                mesh = create_mesh({"dp": 1, "ep": 1}, device="cpu")
            model = _lm(cfg_kw, params, mesh if side == "ep1" else None)
            if side == "fsdp1":
                kw = dict(data_axis="fsdp",
                          param_shardings=sharding.fsdp_sharding_tree(
                              mesh, params, min_size=MIN_SIZE))
                sharding.shard_params_fsdp(mesh, model, min_size=MIN_SIZE)
            elif side == "zero1":
                kw = dict(opt_shardings=sharding.weight_update_shardings(
                    mesh, params, min_size=MIN_SIZE))
            tx = steps.adamw(FSDP_LR)
            step = steps.make_lm_train_step(
                model, tx, mesh=mesh, xent_chunk=16,
                aux_loss_weight=0.01 if name == "ep1" else 0.0, **kw)
            runs.append(_run(step, steps.TrainState.create(model, tx),
                             p["batches"], None))
        (l0, t0), (l1, t1) = runs
        differ[name] = ([] if l0 == l1 else ["losses"]) + [
            "/".join(k) for k, v in _flat(t1[-1]).items()
            if not np.array_equal(v, _flat(t0[-1])[k])]
    return differ


def ckpt_rank(rank, world, p):
    """Written at dp 4, restored into an FSDP state at dp 2 x fsdp 2 (the
    names of the shards that part from the saved tree's slices); then
    that state one FSDP step on, saved and restored into a fresh FSDP
    state (the names of the shards that part from the saved state's)."""
    from tf_operator_tpu_torch.models.convert import _leaves
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import checkpoint, distributed, steps

    dp4 = create_mesh({"dp": 4}, device="cpu")
    model = _lm(LM_KW, p["params"])
    tx = steps.adamw(FSDP_LR)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx, mesh=dp4, xent_chunk=16)
    _run(step, state, p["batches"][:2], sharding.DataParallel(dp4, "dp"))
    with checkpoint.CheckpointManager(p["dir"]) as mgr:
        mgr.save(1, state, force=True)
    distributed.barrier()  # the primary's write is durable
    saved, _ = checkpoint.read(p["dir"], 1)

    mesh = create_mesh(DP2FSDP2, device="cpu")

    def fsdp_state():
        m = _lm(LM_KW, p["params"])
        sharding.shard_params_fsdp(mesh, m, min_size=MIN_SIZE)
        return m, steps.TrainState.create(m, tx)

    model, state = fsdp_state()
    with checkpoint.CheckpointManager(p["dir"]) as mgr:
        mgr.restore(1, state)
    want = {"params": sharding.shard_params_fsdp(
        mesh, {k: v.numpy() for k, v in _leaves(saved["params"])},
        min_size=MIN_SIZE)}
    for key in ("exp_avg", "exp_avg_sq"):
        want[key] = sharding.shard_params_fsdp(
            mesh, {k: v.numpy() for k, v in _leaves(saved["opt"][key])},
            min_size=MIN_SIZE)
    from tf_operator_tpu_torch.models.convert import flax_path

    restored = []
    for name, q in model.named_parameters():
        path = flax_path(name)
        if not np.array_equal(q.detach().numpy(), want["params"][path]):
            restored.append(name)
        for key in ("exp_avg", "exp_avg_sq"):
            if not np.array_equal(state.optimizer.state[q][key].numpy(),
                                  want[key][path]):
                restored.append(f"{key} {name}")
    restored += [] if state.step == 2 else [f"step {state.step}"]

    fstep = steps.make_lm_train_step(
        model, tx, mesh=mesh, data_axis=("dp", "fsdp"), xent_chunk=16,
        param_shardings=sharding.fsdp_sharding_tree(
            mesh, p["params"], min_size=MIN_SIZE))
    _run(fstep, state, p["batches"][2:], sharding.DataParallel(
        mesh, ("dp", "fsdp")))
    with checkpoint.CheckpointManager(p["dir2"]) as mgr:
        mgr.save(2, state, force=True)
    distributed.barrier()
    again_model, again = fsdp_state()
    with checkpoint.CheckpointManager(p["dir2"]) as mgr:
        mgr.restore(2, again)
    kept = [] if again.step == state.step else ["step"]
    for (name, a), b in zip(model.named_parameters(),
                            again_model.parameters()):
        if not torch.equal(a, b):
            kept.append(name)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(state.optimizer.state[a][key],
                               again.optimizer.state[b][key]):
                kept.append(f"{key} {name}")
    return {"restored": restored, "kept": kept,
            "shard_shapes": {n: tuple(q.shape)
                             for n, q in model.named_parameters()}}


# -- the JAX side ------------------------------------------------------------


def _jax_lm_model(cfg_kw, mesh=None):
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )

    return JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **cfg_kw))


def _jax_fsdp_lm(params, batches):
    import jax

    from tf_operator_tpu.parallel.sharding import (
        fsdp_sharding_tree,
        shard_params_fsdp,
    )
    from tf_operator_tpu.train import steps as jax_steps

    mesh = _jax_mesh(DP2FSDP2)
    model = _jax_lm_model(LM_KW)
    tree = fsdp_sharding_tree(mesh, params, min_size=MIN_SIZE)
    tx = jax_steps.adamw(FSDP_LR)
    state = jax_steps.TrainState.create(
        shard_params_fsdp(mesh, params, min_size=MIN_SIZE), tx)
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, data_axis=("dp", "fsdp"), seq_axis=None,
        donate=False, param_shardings=tree, xent_chunk=16)
    losses, trees = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "params": trees}


def _jax_fsdp_mnist(axes, variables, batch):
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.mnist import MnistCNN as JaxMnist
    from tf_operator_tpu.parallel.sharding import (
        fsdp_sharding_tree,
        shard_batch,
        shard_params_fsdp,
    )
    from tf_operator_tpu.train import steps as jax_steps

    mesh = _jax_mesh(axes)
    model = JaxMnist(dtype=jnp.float32)
    params = variables["params"]
    tree = fsdp_sharding_tree(mesh, params, min_size=MIN_SIZE)
    tx = jax_steps.adamw(1e-3)
    state = jax_steps.TrainState.create(
        shard_params_fsdp(mesh, params, min_size=MIN_SIZE), tx)
    step = jax_steps.make_classifier_train_step(
        model, tx, mesh, has_batch_stats=False, data_axis="fsdp",
        param_shardings=tree, donate=False)
    placed = shard_batch(mesh, batch, axis="fsdp")
    losses, trees = [], []
    for _ in range(STEPS):
        state, m = step(state, placed)
        losses.append(float(m["loss"]))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "params": trees}


def _jax_zero(name, params, batches):
    import jax

    from tf_operator_tpu.parallel.sharding import (
        replicate,
        weight_update_shardings,
    )
    from tf_operator_tpu.train import steps as jax_steps

    axes, cfg_kw, tx_name = ZERO_CELLS[name]
    mesh = _jax_mesh(axes)
    model = _jax_lm_model(cfg_kw)
    tx = getattr(jax_steps, tx_name)(ZERO_LR)
    state = jax_steps.TrainState.create(replicate(mesh, params), tx)
    opt_sh = weight_update_shardings(mesh, state.opt_state,
                                     min_size=MIN_SIZE)
    state = state.replace(opt_state=jax.tree.map(
        jax.device_put, state.opt_state, opt_sh))
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, seq_axis=None, donate=False, opt_shardings=opt_sh)
    losses, trees = [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "params": trees}


_RESULTS: dict = {}


def world_results(world: int) -> tuple[dict, list]:
    """(JAX's references, the ranks' results) of every case at ``world``
    ranks, computed once; the ranks start first and JAX's references are
    computed while they run."""
    if world in _RESULTS:
        return _RESULTS[world]
    from concurrent.futures import ThreadPoolExecutor

    cases, refs = [], {}
    tmp = tempfile.mkdtemp(prefix="fsdp_ckpt")
    if world == 1:
        moe_cfg = dict(LM_KW, moe_every_n=2, moe_experts=4, moe_top_k=2)
        cases.append(("world1", "world1_rank", {
            "params": seeded_tree(LM_KW, 60),
            "moe_cfg": moe_cfg, "moe_params": seeded_tree(moe_cfg, 61),
            "batches": [lm_tokens(LM_KW, 8, 32, 62 + i)
                        for i in range(STEPS)]}))
    for name, axes in MNIST_CELLS.items():
        if _size(axes) != world:
            continue
        from tf_operator_tpu_torch.models.convert import init_variables
        from tf_operator_tpu_torch.models.mnist import MnistCNN

        variables = init_variables(MnistCNN(device="cpu"), 70 + world)
        batch = mnist_batch(71 + world)
        cases.append((name, "fsdp_mnist_rank", {
            "axes": axes, "variables": variables, "batch": batch}))
        refs[name] = (_jax_fsdp_mnist, axes, variables, batch)
    for name, (axes, cfg_kw, _) in ZERO_CELLS.items():
        if _size(axes) != world:
            continue
        params = seeded_tree(cfg_kw, 80 + len(cases))
        batches = [lm_tokens(cfg_kw, 16, 16, 81 + len(cases) + i)
                   for i in range(STEPS)]
        payload = {"axes": axes, "cfg": cfg_kw, "tx": ZERO_CELLS[name][2],
                   "params": params, "batches": batches}
        if name == "dp2_adamw":
            payload["ckpt"] = os.path.join(tmp, "zero")
        cases.append((name, "zero_rank", payload))
        refs[name] = (_jax_zero, name, params, batches)
    if world == 4:
        params = seeded_tree(LM_KW, 90)
        batches = [lm_tokens(LM_KW, 8, 32, 91 + i) for i in range(STEPS)]
        cases.append(("lm", "fsdp_lm_rank", {"params": params,
                                              "batches": batches}))
        refs["lm"] = (_jax_fsdp_lm, params, batches)
        cases.append(("ckpt", "ckpt_rank", {
            "params": seeded_tree(LM_KW, 95), "dir": os.path.join(
                tmp, "dp4"), "dir2": os.path.join(tmp, "fsdp"),
            "batches": [lm_tokens(LM_KW, 8, 32, 96 + i)
                        for i in range(STEPS)]}))
    port = free_port()
    want = {}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_processes, "test_torch_fsdp", "cases_rank",
                            [rank_env(r, world, port) for r in range(world)],
                            cases)
        for name, (fn, *args) in refs.items():
            want[name] = fn(*args)
        results = ranks.result()
    want["tmp"] = tmp
    _RESULTS[world] = want, results
    return _RESULTS[world]


@pytest.fixture(scope="module", autouse=True)
def _cleanup():
    yield
    for want, _ in _RESULTS.values():
        shutil.rmtree(want["tmp"], ignore_errors=True)


def _check_run(got_all, want, name, lr_sum_step):
    got = [r[name] for r in got_all]
    for r in got:
        assert r["losses"] == got[0]["losses"], name
        for a, b in zip(r["params"], got[0]["params"]):
            for path, leaf in _flat(a).items():
                assert np.array_equal(leaf, _flat(b)[path]), (name, path)
    np.testing.assert_allclose(got[0]["losses"], want["losses"],
                               rtol=LOSS_TOL)
    for i, (g, w) in enumerate(zip(got[0]["params"], want["params"])):
        _assert_leaves_close(g, w, LEAF_RTOL, lr_sum=(i + 1) * lr_sum_step)
    return got


# -- the rule -----------------------------------------------------------------


def _jax_fsdp_specs(tree, n):
    import jax

    from tf_operator_tpu.parallel.sharding import fsdp_sharding_tree

    mesh = _jax_mesh({"fsdp": n})
    return jax.tree.map(lambda s: tuple(s.spec),
                        fsdp_sharding_tree(mesh, tree, min_size=MIN_SIZE))


def _flax_trees():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.mnist import MnistCNN as JaxMnist

    lm = seeded_tree(dict(LM_KW, moe_every_n=2, moe_experts=8), 3)
    mnist = JaxMnist(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), train=True)
    return {"lm": lm, "mnist": jax.tree.map(np.asarray, mnist["params"])}


def test_fsdp_sharding_tree_is_jax_s_on_its_own_tree():
    import jax.numpy as jnp

    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    params = {"dense": {"kernel": jnp.ones((16, 256)),
                        "bias": jnp.ones((256,))},
              "odd": jnp.ones((129, 3)), "tiny": jnp.ones((8, 8))}
    import jax

    from tf_operator_tpu.parallel.sharding import fsdp_sharding_tree

    want = jax.tree.map(lambda s: tuple(s.spec), fsdp_sharding_tree(
        _jax_mesh({"fsdp": 8}), params, min_size=128))
    got = sharding.fsdp_sharding_tree(create_mesh({"fsdp": 8}, range(8)),
                                      params, min_size=128)
    assert got == want
    assert got["dense"] == {"kernel": (None, "fsdp"), "bias": ("fsdp",)}
    assert got["odd"] == got["tiny"] == ()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("tree", ["lm", "mnist"])
def test_fsdp_specs_and_slices_are_jax_s(tree, n):
    import jax

    from tf_operator_tpu.parallel.sharding import shard_params_fsdp
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.models.convert import load_variables
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    params = _flax_trees()[tree]
    mesh = create_mesh({"fsdp": n}, range(n))
    want = _jax_fsdp_specs(params, n)
    got = sharding.fsdp_sharding_tree(mesh, params, min_size=MIN_SIZE)
    assert got == want
    if tree == "mnist":
        model = load_variables(MnistCNN(dtype=torch.float32, device="cpu"),
                               {"params": params})
        assert sharding.fsdp_sharding_tree(mesh, model,
                                           min_size=MIN_SIZE) == want
    placed = shard_params_fsdp(_jax_mesh({"fsdp": n}), params,
                               min_size=MIN_SIZE)
    flat_placed = dict(jax.tree_util.tree_leaves_with_path(placed))
    for key, leaf in flat_placed.items():
        path = tuple(k.key for k in key)
        for shard in leaf.addressable_shards:
            mine = _flat(sharding.shard_params_fsdp(
                mesh, params, min_size=MIN_SIZE, rank=shard.device.id))
            np.testing.assert_array_equal(mine[path], np.asarray(shard.data))


def test_weight_update_shardings_are_jax_s_on_adamw_s_moments():
    import jax

    from tf_operator_tpu.parallel.sharding import weight_update_shardings
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    params = seeded_tree(LM_KW, 4)
    opt_state = jax_steps.adamw(1e-3).init(params)
    want = weight_update_shardings(_jax_mesh({"dp": 4}), opt_state,
                                   min_size=MIN_SIZE)
    got = sharding.weight_update_shardings(
        create_mesh({"dp": 4}, range(4)), params, min_size=MIN_SIZE)
    assert got == jax.tree.map(lambda s: tuple(s.spec), want[0].mu)
    assert any("dp" in spec for spec in _flat_specs(got))


def _flat_specs(tree):
    out = []
    for v in tree.values():
        out += _flat_specs(v) if isinstance(v, dict) else [v]
    return out


# -- FSDP --------------------------------------------------------------------


def test_fsdp_lm_step_at_dp2_fsdp2_matches_jax():
    want, results = world_results(4)
    got = _check_run(results, want["lm"], "lm", FSDP_LR)
    for r in got:
        assert r["slices_same"]
        # The embedding [64, 64] is cut on its rows over fsdp 2, and so
        # is its AdamW moment.
        assert r["embed_rows"] == (32, 32)


@pytest.mark.parametrize("name", list(MNIST_CELLS))
def test_fsdp_mnist_step_matches_jax(name):
    axes = MNIST_CELLS[name]
    want, results = world_results(_size(axes))
    got = _check_run(results, want[name], name, 1e-3)
    n = axes["fsdp"]
    for r in got:
        # Dense_0's kernel [3136, 256]: its rows cut n ways.
        assert r["kernel_rows"] == (3136 // n, 256)


# -- ZeRO-1 ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ZERO_CELLS))
def test_zero1_step_matches_jax(name):
    axes, cfg_kw, _ = ZERO_CELLS[name]
    want, results = world_results(_size(axes))
    got = _check_run(results, want[name], name, ZERO_LR)
    n = axes["dp"]
    for r in got:
        assert r["zero"] and r["parts"]
        held = 0
        for whole, moments, dim in r["parts"].values():
            # The weights stay whole; a moment shaped like its leaf holds
            # 1/n of the cut dim (Adafactor's factored ones drop a dim).
            for key in ("exp_avg", "exp_avg_sq", "v"):
                if key in moments:
                    assert moments[key][dim] * n == whole[dim], (key, whole)
                    held += 1
        assert held


# -- worlds of one and checkpoints -------------------------------------------


@pytest.mark.parametrize("name", WORLD1)
def test_world_of_one_is_bitwise_the_plain_step(name):
    _, results = world_results(1)
    assert results[0]["world1"][name] == []


def test_checkpoint_at_dp4_restores_bitwise_at_dp2_fsdp2():
    _, results = world_results(4)
    for r in results:
        assert r["ckpt"]["restored"] == []
        assert r["ckpt"]["shard_shapes"]["embed.weight"] == (32, 64)


def test_fsdp_checkpoint_keeps_its_shards_through_a_round_trip():
    _, results = world_results(4)
    for r in results:
        assert r["ckpt"]["kept"] == []


def test_zero1_checkpoint_restores_bitwise_at_one_process():
    from tf_operator_tpu_torch.models.convert import _leaves, flax_path
    from tf_operator_tpu_torch.train import checkpoint, steps

    want, results = world_results(2)
    directory = os.path.join(want["tmp"], "zero")
    saved, _ = checkpoint.read(directory, STEPS)
    # The saved moments are the ranks' parts gathered whole.
    moments = _flat(results[0]["dp2_adamw"]["moments"])
    for path, t in _leaves(saved["opt"]["exp_avg"]):
        np.testing.assert_array_equal(t.numpy(), moments[path])
    model = _lm(LM_KW, seeded_tree(LM_KW, 1))
    state = steps.TrainState.create(model, steps.adamw(ZERO_LR))
    with checkpoint.CheckpointManager(directory) as mgr:
        mgr.restore(STEPS, state)
    assert state.step == STEPS
    for name, p in model.named_parameters():
        path = flax_path(name)
        assert torch.equal(p.detach(), checkpoint._tree_get(
            saved["params"], path)), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][key],
                               checkpoint._tree_get(saved["opt"][key],
                                                    path)), (key, name)
