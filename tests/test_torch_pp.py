"""Pipeline parallelism (tf_operator_tpu_torch/parallel/pipeline.py and
tf_operator_tpu_torch/train/pp_lm.py) held against JAX on the CPU: gloo
processes stand for JAX's devices (the conftest's virtual CPU devices),
from the same numpy-seeded inputs and JAX's own init. Each process runs
its stage; a world runs every case of its size once (``worlds``), at most
four processes at a time.

- ``split_pp_params``/``merge_pp_params``: bitwise JAX's, with JAX's
  errors; so are ``microbatch``'s and ``pipeline_apply``'s stage-count
  check.
- ``pipeline_apply`` over tests/test_moe_pipeline.py's MLP stage at pp 2
  (M 4), pp 4 (M 8) and pp 2 x dp 2 (M 2): each rank's outputs and the
  gradient of its stage's row (its shard of JAX's) within ``RTOL`` 1e-5
  of the largest magnitude of JAX's; the other rows get none.
- ``pipeline_value_and_grad`` on the same meshes and with a checkpointed
  stage: loss, stage and last gradients and ``d_microbatches`` within
  ``RTOL``; the stash's high-water mark is ``min(M, 2S - 1 - 2s)`` on
  stage s (at most ``2S - 1``) at M = 2, 4 and 8.
- ``make_pp_lm_forward`` at ``{"pp": 2, "dp": 2}`` (JAX's
  ``TestPipelineTransformer._setup``), with and without remat: the mean
  of the data ranks' losses within ``RTOL`` of JAX's.
- ``make_pp_lm_train_step``, GPipe and 1F1B at num_micro 2 and 4, 3 AdamW
  steps against JAX's on the same mesh: losses within ``LOSS_TOL``, the
  merged weights within ``LEAF_RTOL`` plus Adam's noise bound
  (tests/test_torch_dp.py's rule), the data replicas and every rank's
  outer params bitwise alike; a ``{"pp": 1}`` world of one against the
  plain step by the same bounds.
- The checkpoint written at pp 2 x dp 2 holds JAX's tree layout (and
  AdamW's moments in it), restores bitwise on every rank, and refuses
  another pp (or a plain state) naming ``pp``; ``restore_params`` merges
  it back given ``from_pp``.
- ``dist_lm --pp 2 --device cpu`` killed at step 60 and resumed (beside a
  1F1B twin), then ``serve_lm --from-pp 2`` answers ``[5, 6, 7, 8]`` with
  ``[9, 10, 11, 12]``: tests/test_examples.py's check over the port.
- Every ``--pp`` refusal of ``dist_lm`` is JAX's example's, word for
  word; a decode mesh over pp is refused naming ROADMAP A8k.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_dp import (
    BOOT,
    LEAF_RTOL,
    LOSS_TOL,
    RANK_TIMEOUT,
    REPO,
    TESTS,
    _assert_leaves_close,
    _flat,
    free_port,
    rank_env,
)

torch.set_num_threads(1)

RTOL = 1e-5
LR = 1e-3
STEPS = 3
XENT_CHUNK = 16
# JAX's TestPipelineTransformer._setup.
LM_KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq_len=32)
# The MLP stage's cases: (stages, microbatches, dp).
PIPE_CASES = {"pp2": (2, 4, 1), "pp4": (4, 8, 1), "pp2dp2": (2, 2, 2)}
D, H, MB = 8, 16, 4
MARK_MS = (2, 4, 8)
TRAIN_CASES = [(sched, m) for sched in ("gpipe", "1f1b") for m in (2, 4)]


# -- the processes' side (torch and the port only) --------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    torch.set_num_threads(1)
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _mlp_stage(p, x):
    return x + torch.relu(x @ p["w1"]) @ p["w2"]


def _remat_stage(p, x):
    from torch.utils.checkpoint import checkpoint

    return checkpoint(_mlp_stage, p, x, use_reentrant=False)


def _last(lp, y, tgt):
    return ((y @ lp["wo"] - tgt) ** 2).mean()


def _mesh(axes):
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(axes, device="cpu")


def _place(mesh):
    """(stage index, data index, data size) of this rank."""
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    n_dp = mesh.shape.get("dp", 1)
    d = TensorParallel(mesh, "dp").index if n_dp > 1 else 0
    return TensorParallel(mesh, "pp").index, d, n_dp


def pipe_rank(rank, world, p):
    """``pipeline_apply`` and ``pipeline_value_and_grad`` over the MLP
    stage on ``p["axes"]``: this rank's outputs and stage rows."""
    from tf_operator_tpu_torch.parallel import pipeline as pl

    mesh = _mesh(p["axes"])
    s, d, n_dp = _place(mesh)
    batch_axis = "dp" if n_dp > 1 else None
    S, M = mesh.shape["pp"], p["m"]
    stacked = {k: torch.from_numpy(v) for k, v in p["stacked"].items()}

    def mine(a):
        mb = pl.microbatch(torch.from_numpy(a), M)
        r = mb.shape[1] // n_dp
        return mb[:, d * r:(d + 1) * r]

    out = {}
    with torch.no_grad():
        out["out"] = pl.pipeline_apply(_mlp_stage, stacked, mine(p["x"]),
                                       mesh, batch_axis=batch_axis).numpy()
    grad_p = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    y = pl.pipeline_apply(_mlp_stage, grad_p, mine(p["x"]), mesh,
                          batch_axis=batch_axis)
    # Every stage computes the loss from its copy: 1 / S of it a rank.
    (y.square().sum() / S).backward()
    out["grad"] = {k: v.grad[s].numpy() for k, v in grad_p.items()}
    out["other_rows"] = max(float(v.grad[i].abs().max())
                            for v in grad_p.values() for i in range(S)
                            if i != s)
    lp = {"wo": torch.from_numpy(p["wo"])}
    for name, fn in (("vg", _mlp_stage), ("vg_remat", _remat_stage)):
        if name == "vg_remat" and not p["remat"]:
            continue
        run = pl.pipeline_value_and_grad(fn, _last, mesh,
                                         batch_axis=batch_axis)
        loss, gs, gl, dx = run(stacked, lp, mine(p["x"]), mine(p["tgt"]))
        out[name] = {"loss": float(loss),
                     "stage": {k: v.numpy() for k, v in gs.items()},
                     "last": {k: v.numpy() for k, v in gl.items()},
                     "dx": dx.numpy(), "mark": run.stash_mark}
    marks = {}
    for m in p["marks"]:
        run = pl.pipeline_value_and_grad(_mlp_stage, _last, mesh,
                                         batch_axis=batch_axis)
        run(stacked, lp, torch.zeros((m, MB, D)), torch.zeros((m, MB, 4)))
        marks[m] = run.stash_mark
    out["marks"] = marks
    return out


def _pp_tree(params, pp):
    from tf_operator_tpu_torch.train.pp_lm import split_pp_params

    outer, stages = split_pp_params(params, LM_KW["n_layers"], pp)
    return {"outer": outer, "stages": stages}


def _cfg(**kw):
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(dtype=torch.float32, **LM_KW, **kw)


def _merged_export(model):
    """A stage rank's weights as {global flax path: array}: its blocks
    renamed to their place in the whole stack."""
    from tf_operator_tpu_torch.models.convert import export_params

    pipe = model.pipeline
    k = pipe.cfg.n_layers // pipe.stage.size
    out = {}
    for key, val in export_params(model).items():
        if key.startswith("block_"):
            key = f"block_{pipe.stage.index * k + int(key[6:])}"
        out[key] = val
    return out


def lm_rank(rank, world, p):
    """make_pp_lm_forward (with and without remat) and the train steps on
    ``p["axes"]``; the checkpoint of the first train run."""
    from tf_operator_tpu_torch.train import pp_lm, steps

    mesh = _mesh(p["axes"])
    tree = _pp_tree(p["params"], mesh.shape["pp"])
    out = {"fwd": {}, "train": {}}
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        model = pp_lm.pp_model(cfg, mesh, tree, device="cpu")
        rows = pp_lm.pp_rows(mesh, p["batch"], 2)
        fwd = pp_lm.make_pp_lm_forward(cfg, mesh, num_micro=2,
                                       xent_chunk=XENT_CHUNK)
        with torch.no_grad():
            out["fwd"][remat] = float(fwd(model, rows["tokens"],
                                          rows["targets"]))
    cfg = _cfg()
    for sched, m in p["train"]:
        model = pp_lm.pp_model(cfg, mesh, tree, device="cpu")
        tx = steps.adamw(LR)
        state = steps.TrainState.create(model, tx)
        step = pp_lm.make_pp_lm_train_step(cfg, mesh, tx, num_micro=m,
                                           xent_chunk=XENT_CHUNK,
                                           schedule=sched)
        rows = pp_lm.pp_rows(mesh, p["batch"], m)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, rows)
            losses.append(float(metrics["loss"]))
        out["train"][(sched, m)] = {"losses": losses,
                                    "params": _merged_export(model),
                                    "mark": step.stash_mark}
        if p.get("ck") and "ckpt" not in out:
            out["ckpt"] = _ckpt_leg(mesh, cfg, tree, state, p["ck"])
    return out


def _ckpt_leg(mesh, cfg, tree, state, ck):
    """Save ``state`` under ``ck``, restore it into a fresh stage model:
    the paths that differ (weights and AdamW's state), none expected."""
    from tf_operator_tpu_torch.train import (
        checkpoint,
        distributed,
        pp_lm,
        steps,
    )

    with checkpoint.CheckpointManager(ck) as mgr:
        mgr.save(STEPS, state, force=True)
    distributed.barrier()  # rank 0's write is durable
    fresh = steps.TrainState.create(
        pp_lm.pp_model(cfg, mesh, tree, device="cpu"), steps.adamw(LR))
    with checkpoint.CheckpointManager(ck) as mgr:
        mgr.restore(None, fresh)
    differ = [n for (n, a), b in zip(state.model.named_parameters(),
                                     fresh.model.parameters())
              if not torch.equal(a, b)]
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(state.optimizer.state[a][key],
                               fresh.optimizer.state[b][key]):
                differ.append(key)
    return {"differ": differ, "step": fresh.step}


def world1_rank(rank, world, p):
    """A ``{"pp": 1}`` world of one (gloo): the pp steps at num_micro 2
    beside the plain step from the same tree and batch."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import (
        export_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import Transformer
    from tf_operator_tpu_torch.train import pp_lm, steps

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = _mesh({"pp": 1})
        cfg = _cfg()
        batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
        model = load_params(Transformer(cfg, device="cpu"), p["params"])
        tx = steps.adamw(LR)
        state = steps.TrainState.create(model, tx)
        step = steps.make_lm_train_step(model, tx, xent_chunk=XENT_CHUNK)
        plain = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            plain.append(float(m["loss"]))
        out = {"plain": {"losses": plain, "params": export_params(model)}}
        for sched in ("gpipe", "1f1b"):
            model = pp_lm.pp_model(cfg, mesh, _pp_tree(p["params"], 1),
                                   device="cpu")
            state = steps.TrainState.create(model, tx)
            step = pp_lm.make_pp_lm_train_step(
                cfg, mesh, tx, num_micro=2, xent_chunk=XENT_CHUNK,
                schedule=sched)
            losses = []
            for _ in range(STEPS):
                state, m = step(state, pp_lm.pp_rows(mesh, p["batch"], 2))
                losses.append(float(m["loss"]))
            out[sched] = {"losses": losses, "params": _merged_export(model)}
        return out
    finally:
        dist.destroy_process_group()


# -- the worlds ---------------------------------------------------------------


def _start(world, cases, tmp):
    """``cases_rank`` over ``cases`` in ``world`` processes joined by gloo
    (a world of one: a process of its own); returns the processes."""
    port = free_port()
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(cases, f)
    procs = []
    for r in range(world):
        env = rank_env(r, world, port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", BOOT, REPO, TESTS, "test_torch_pp",
             "cases_rank", tmp, str(r)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(procs, tmp) -> list:
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
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(logs)
    results = []
    for i in range(len(procs)):
        with open(os.path.join(tmp, f"out{i}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# -- the JAX side ------------------------------------------------------------


def _jax_mesh(axes):
    import jax

    from tf_operator_tpu.parallel.mesh import create_mesh

    n = int(np.prod(list(axes.values())))
    return create_mesh(axes, jax.devices()[:n])


def _pipe_inputs(name):
    S, M, dp = PIPE_CASES[name]
    rng = np.random.default_rng(11 + S + dp)
    mb = MB * dp
    stacked = {"w1": (rng.normal(size=(S, D, H)) * 0.1).astype(np.float32),
               "w2": (rng.normal(size=(S, H, D)) * 0.1).astype(np.float32)}
    return {"axes": {"pp": S, "dp": dp} if dp > 1 else {"pp": S}, "m": M,
            "stacked": stacked,
            "wo": (rng.normal(size=(D, 4)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(M * mb, D)).astype(np.float32),
            "tgt": rng.normal(size=(M * mb, 4)).astype(np.float32),
            "remat": name == "pp2", "marks": MARK_MS if dp == 1 else ()}


def _jax_pipe(p):
    import jax

    from tf_operator_tpu.parallel.pipeline import (
        microbatch,
        pipeline_apply,
        pipeline_value_and_grad,
    )

    def stage(q, x):
        return x + jax.nn.relu(x @ q["w1"]) @ q["w2"]

    def last(lq, y, tgt):
        return ((y @ lq["wo"] - tgt) ** 2).mean()

    mesh = _jax_mesh(p["axes"])
    batch_axis = "dp" if "dp" in p["axes"] else None
    mbs = microbatch(p["x"], p["m"])
    tgts = microbatch(p["tgt"], p["m"])

    def apply(q):
        return pipeline_apply(stage, q, mbs, mesh, batch_axis=batch_axis)

    want = {"out": np.asarray(jax.jit(apply)(p["stacked"])),
            "grad": jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda q: (apply(q) ** 2).sum()))(p["stacked"]))}
    for name, fn in (("vg", stage), ("vg_remat", jax.checkpoint(stage))):
        if name == "vg_remat" and not p["remat"]:
            continue
        engine = pipeline_value_and_grad(fn, last, mesh,
                                         batch_axis=batch_axis)
        loss, gs, gl, dx = jax.jit(engine)(p["stacked"], {"wo": p["wo"]},
                                          mbs, tgts)
        want[name] = {"loss": float(loss),
                      "stage": jax.tree.map(np.asarray, gs),
                      "last": jax.tree.map(np.asarray, gl),
                      "dx": np.asarray(dx)}
    return want


def _jax_setup():
    """JAX's _setup: its config, seeded tokens and targets, and its own
    init as numpy."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )

    cfg = JaxConfig(dtype=jnp.float32, **LM_KW)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (8, 32)).astype(np.int32)
    targets = rng.integers(0, 64, (8, 32)).astype(np.int32)
    params = JaxTransformer(cfg).init(jax.random.PRNGKey(0),
                                      jnp.asarray(tokens))["params"]
    return cfg, jax.tree.map(np.asarray, params), {"tokens": tokens,
                                                   "targets": targets}


def _jax_pp(cfg, params, batch):
    """JAX's pipelined forward (with and without remat) and train steps
    on {"pp": 2, "dp": 2}."""
    from dataclasses import replace

    import jax

    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu.train.pp_lm import (
        make_pp_lm_forward,
        make_pp_lm_train_step,
        merge_pp_params,
        pp_param_shardings,
        split_pp_params,
    )

    mesh = _jax_mesh({"pp": 2, "dp": 2})
    outer, stages = split_pp_params(params, cfg.n_layers, 2)
    tree = {"outer": outer, "stages": stages}
    tree = jax.device_put(tree, pp_param_shardings(mesh, tree))
    want = {"fwd": {}, "train": {}}
    for remat in (False, True):
        fwd = make_pp_lm_forward(replace(cfg, remat=remat), mesh,
                                 num_micro=2, xent_chunk=XENT_CHUNK)
        want["fwd"][remat] = float(fwd(tree, batch["tokens"],
                                       batch["targets"]))
    for sched, m in TRAIN_CASES:
        tx = jax_steps.adamw(LR)
        state = jax_steps.TrainState.create(tree, tx)
        step = make_pp_lm_train_step(cfg, mesh, tx, num_micro=m,
                                     xent_chunk=XENT_CHUNK, schedule=sched)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        final = jax.tree.map(np.asarray, state.params)
        want["train"][(sched, m)] = {
            "losses": losses, "params": merge_pp_params(
                final["outer"], final["stages"], cfg.n_layers)}
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """JAX's references and the worlds' results, computed once: the world
    of four (pp 4, pp 2 x dp 2) while JAX runs, then the worlds of two and
    one together."""
    cfg, params, batch = _jax_setup()
    ck = str(tmp_path_factory.mktemp("ppck") / "ck")
    pipe = {name: _pipe_inputs(name) for name in PIPE_CASES}
    lm = {"axes": {"pp": 2, "dp": 2}, "params": params, "batch": batch,
          "train": TRAIN_CASES, "ck": ck}
    with tempfile.TemporaryDirectory() as four, \
            tempfile.TemporaryDirectory() as two, \
            tempfile.TemporaryDirectory() as one:
        procs = _start(4, [("pp4", "pipe_rank", pipe["pp4"]),
                           ("pp2dp2", "pipe_rank", pipe["pp2dp2"]),
                           ("lm", "lm_rank", lm)], four)
        want = {name: _jax_pipe(p) for name, p in pipe.items()}
        want["lm"] = _jax_pp(cfg, params, batch)
        got = {"four": _collect(procs, four)}
        procs = (_start(2, [("pp2", "pipe_rank", pipe["pp2"])], two),
                 _start(1, [("world1", "world1_rank", {
                     "params": params, "batch": batch})], one))
        got["two"] = _collect(procs[0], two)
        got["one"] = _collect(procs[1], one)[0]["world1"]
    return dict(want=want, got=got, pipe=pipe, ck=ck, params=params)


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rtol * float(np.abs(want).max())
    assert err <= bound, (what, err, bound)


def _ranks_of(worlds, name):
    """(the ranks' results of pipe case ``name``, its inputs)."""
    ranks = worlds["got"]["two" if name == "pp2" else "four"]
    return [r[name] for r in ranks], worlds["pipe"][name]


def _place_of(rank, p):
    """(stage, data index, data size) of ``rank`` on the case's mesh: the
    stage outer, JAX's device order."""
    n_dp = p["axes"].get("dp", 1)
    return rank // n_dp, rank % n_dp, n_dp


def _mine(a, d, n_dp):
    r = a.shape[1] // n_dp
    return a[:, d * r:(d + 1) * r]


# -- the tests ---------------------------------------------------------------


def test_split_merge_are_jax_bitwise_with_its_errors():
    import jax

    from tf_operator_tpu.train import pp_lm as jax_pp
    from tf_operator_tpu_torch.parallel import pipeline as pl
    from tf_operator_tpu_torch.train import pp_lm

    _, params, _ = _jax_setup()
    for pp in (1, 2, 4):
        got = pp_lm.split_pp_params(params, LM_KW["n_layers"], pp)
        want = jax_pp.split_pp_params(params, LM_KW["n_layers"], pp)
        want = jax.tree.map(np.asarray, want)
        assert _flat({"o": got[0], "s": got[1]}).keys() == _flat(
            {"o": want[0], "s": want[1]}).keys()
        for path, leaf in _flat({"o": want[0], "s": want[1]}).items():
            g = _flat({"o": got[0], "s": got[1]})[path]
            assert g.dtype == leaf.dtype and np.array_equal(g, leaf), path
        merged = pp_lm.merge_pp_params(*got, LM_KW["n_layers"])
        for path, leaf in _flat(params).items():
            assert np.array_equal(_flat(merged)[path], leaf), path
    for fn in (pp_lm.split_pp_params, jax_pp.split_pp_params):
        with pytest.raises(ValueError, match="n_layers=4 not divisible by "
                                             "pp=3"):
            fn(params, LM_KW["n_layers"], 3)
        partial = {k: v for k, v in params.items() if k != "block_1"}
        with pytest.raises(ValueError, match=r"params missing \['block_1'\]"):
            fn(partial, LM_KW["n_layers"], 2)
    with pytest.raises(ValueError, match="batch 10 not divisible by 3 "
                                         "microbatches"):
        pl.microbatch(torch.zeros((10, 4)), 3)
    x = torch.arange(24.0).reshape(6, 4)
    assert torch.equal(pl.unmicrobatch(pl.microbatch(x, 3)), x)
    # JAX's stage-count check, word for word.
    stacked = pl.stack_stage_params([{"w1": torch.zeros(2, 2)}] * 4)
    mesh = pl.Mesh(np.arange(2), ("pp",))
    with pytest.raises(ValueError, match=r"stage_params leading dim 4 != pp "
                       r"axis size 2; to run multiple layers per stage, "
                       r"fold them into stage_fn"):
        pl.pipeline_apply(_mlp_stage, stacked, torch.zeros(2, 1, 2), mesh)


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_pipeline_apply_matches_jax(worlds, name):
    ranks, p = _ranks_of(worlds, name)
    want = worlds["want"][name]
    for rank, got in enumerate(ranks):
        s, d, n_dp = _place_of(rank, p)
        _close(got["out"], _mine(want["out"], d, n_dp), what=(rank, "out"))
        for k, g in got["grad"].items():
            _close(g, want["grad"][k][s], what=(rank, k))
        assert got["other_rows"] == 0.0


@pytest.mark.parametrize("name,leg", [(n, "vg") for n in PIPE_CASES]
                         + [("pp2", "vg_remat")])
def test_1f1b_engine_matches_jax(worlds, name, leg):
    ranks, p = _ranks_of(worlds, name)
    want = worlds["want"][name][leg]
    for rank, got in enumerate(ranks):
        s, d, n_dp = _place_of(rank, p)
        got = got[leg]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        for k, g in got["stage"].items():
            assert g.shape[0] == 1
            _close(g[0], want["stage"][k][s], what=(rank, k))
        for k, g in got["last"].items():
            _close(g, want["last"][k], what=(rank, k))
        _close(got["dx"], _mine(want["dx"], d, n_dp), what=(rank, "dx"))


@pytest.mark.parametrize("name", ["pp2", "pp4"])
def test_1f1b_stash_stays_within_2s_minus_1(worlds, name):
    ranks, p = _ranks_of(worlds, name)
    S = p["axes"]["pp"]
    for s, got in enumerate(ranks):
        assert got["vg"]["mark"] == min(p["m"], 2 * S - 1 - 2 * s)
        for m, mark in got["marks"].items():
            assert mark == min(m, 2 * S - 1 - 2 * s) <= 2 * S - 1


@pytest.mark.parametrize("remat", [False, True])
def test_pp_lm_forward_matches_jax(worlds, remat):
    ranks = [r["lm"]["fwd"][remat] for r in worlds["got"]["four"]]
    # pp outer: ranks (0, 1) hold data indices 0 and 1 of stage 0.
    assert ranks[:2] == ranks[2:]
    np.testing.assert_allclose(np.mean(ranks[:2]),
                               worlds["want"]["lm"]["fwd"][remat],
                               rtol=RTOL)


def _merged(ranks: list) -> dict:
    """The whole tree from the ranks of data index 0 (one a stage)."""
    out = {}
    for r in ranks:
        out.update(r["params"])
    return out


@pytest.mark.parametrize("sched,m", TRAIN_CASES)
def test_pp_lm_train_step_matches_jax(worlds, sched, m):
    got = [r["lm"]["train"][(sched, m)] for r in worlds["got"]["four"]]
    want = worlds["want"]["lm"]["train"][(sched, m)]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_TOL)
        assert r["losses"] == got[0]["losses"]
    # Data replicas of a stage (ranks 2s, 2s + 1) end bitwise alike, and
    # every rank's outer params too.
    for a, b in ((0, 1), (2, 3)):
        for path, leaf in _flat(got[a]["params"]).items():
            assert np.array_equal(leaf, _flat(got[b]["params"])[path]), path
    for key in ("embed", "pos", "RMSNorm_0", "lm_head"):
        for path, leaf in _flat(got[0]["params"][key]).items():
            assert np.array_equal(leaf, _flat(got[2]["params"][key])[path])
    _assert_leaves_close(_merged([got[0], got[2]]), want["params"],
                         LEAF_RTOL, lr_sum=STEPS * LR)
    if sched == "1f1b":
        assert [r["mark"] for r in got] == [min(m, 3)] * 2 + [1] * 2


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_world_of_one_pp1_matches_the_plain_step(worlds, sched):
    got = worlds["got"]["one"]
    np.testing.assert_allclose(got[sched]["losses"],
                               got["plain"]["losses"], rtol=LOSS_TOL)
    _assert_leaves_close(got[sched]["params"], got["plain"]["params"],
                         LEAF_RTOL, lr_sum=STEPS * LR)


def test_checkpoint_holds_jax_layout_restores_bitwise_and_names_pp(
        worlds):
    import jax

    from tf_operator_tpu.train.pp_lm import split_pp_params as jax_split
    from tf_operator_tpu_torch.models.convert import _leaves, load_params
    from tf_operator_tpu_torch.models.transformer import Transformer
    from tf_operator_tpu_torch.train import checkpoint, pp_lm, steps

    ck = worlds["ck"]
    for r in worlds["got"]["four"]:
        assert r["lm"]["ckpt"] == {"differ": [], "step": STEPS}
    payload, manifest = checkpoint.read(ck)
    assert manifest["config"]["pp"] == 2
    want = jax.tree.map(np.asarray, jax_split(worlds["params"],
                                              LM_KW["n_layers"], 2))
    layout = {"outer": want[0], "stages": want[1]}
    shapes = {k: v.shape for k, v in _flat(layout).items()}
    assert {k: tuple(v.shape) for k, v in _leaves(payload["params"])
            } == shapes
    for key in ("exp_avg", "exp_avg_sq"):
        assert {k: tuple(v.shape) for k, v in
                _leaves(payload["opt"][key])} == shapes
    # The saved weights are the trained ranks' (the first train case).
    trained = _merged([r["lm"]["train"][TRAIN_CASES[0]] for r in
                       (worlds["got"]["four"][0], worlds["got"]["four"][2])])
    merged = pp_lm.merge_pp_params(
        {k: _np(v) for k, v in payload["params"]["outer"].items()},
        _np(payload["params"]["stages"]), LM_KW["n_layers"])
    for path, leaf in _flat(trained).items():
        assert np.array_equal(_flat(merged)[path], leaf), path
    # served as a standard tree, given its pp
    served = checkpoint.restore_params(ck, _cfg(), from_pp=2)
    for path, leaf in _flat(trained).items():
        assert np.array_equal(_flat(served)[path], leaf), path
    with pytest.raises(ValueError, match=r"pp 2 \(checkpoint\) vs None"):
        checkpoint.restore_params(ck, _cfg())
    # another pp, and a plain state, are refused naming the field
    mesh = _mesh({"pp": 1})
    one = pp_lm.pp_model(_cfg(), mesh, _pp_tree(worlds["params"], 1),
                         device="cpu")
    plain = load_params(Transformer(_cfg(), device="cpu"), worlds["params"])
    for model, seen in ((one, "1"), (plain, "None")):
        state = steps.TrainState.create(model, steps.adamw(LR))
        with checkpoint.CheckpointManager(ck) as mgr:
            with pytest.raises(ValueError,
                               match=rf"pp 2 \(checkpoint\) vs {seen} "
                                     r"\(model\)"):
                mgr.restore(None, state)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def test_train_step_refuses_another_schedule():
    from tf_operator_tpu_torch.train import pp_lm, steps

    with pytest.raises(ValueError, match="schedule 'interleaved-2f2b': want "
                                         "'gpipe' or '1f1b'"):
        pp_lm.make_pp_lm_train_step(_cfg(), _mesh({"pp": 1}),
                                    steps.adamw(LR), num_micro=4,
                                    schedule="interleaved-2f2b")


def test_decode_mesh_over_pp_names_a8k():
    from tf_operator_tpu_torch.parallel import mesh as port_mesh

    bad = port_mesh.create_mesh({"tp": 2, "pp": 2}, range(4))
    with pytest.raises(NotImplementedError, match="pp=2 is not ported yet: "
                                                  "see ROADMAP.md A8k"):
        port_mesh.check_decode_mesh(bad, "x")
    with pytest.raises(ValueError, match="make_pp_lm_train_step"):
        port_mesh.check_data_parallel(bad, "x")


# -- the entry points ----------------------------------------------------------


PP_REFUSALS = [
    ["--pp", "2", "--sp", "2"], ["--pp", "2", "--tp", "2"],
    ["--pp", "2", "--moe-every-n", "2"],
    ["--pp", "2", "--ep", "2", "--moe-every-n", "2"], ["--pp", "3"],
    ["--pp", "2", "--grad-accum", "2"], ["--pp", "2", "--data", "x.bin"],
    ["--pp", "2", "--pp-microbatches", "3"],
    ["--pp", "2", "--pp-microbatches", "4"],
    ["--pp", "3", "--layers", "3"],
]


@pytest.mark.parametrize("argv", PP_REFUSALS)
def test_dist_lm_pp_refusals_are_jax_words(argv, monkeypatch):
    """Each refusal as examples/dist_lm.py's on the conftest's 8 devices,
    the port's world read as 8 processes."""
    import importlib.util
    from dataclasses import replace

    from tf_operator_tpu_torch.train import distributed, dist_lm

    for name in ("TPU_WORKER_ID", "TPU_NUM_PROCESSES",
                 "TPU_COORDINATOR_ADDRESS", "TF_CONFIG"):
        monkeypatch.delenv(name, raising=False)
    spec = importlib.util.spec_from_file_location(
        "jax_dist_lm", os.path.join(REPO, "examples", "dist_lm.py"))
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    with pytest.raises(SystemExit) as want:
        jax_example.main(argv)
    monkeypatch.setattr(distributed, "initialize",
                        lambda topo, **kw: replace(topo, num_processes=8))
    with pytest.raises(SystemExit) as got:
        dist_lm.main(["--device", "cpu", *argv])
    assert isinstance(want.value.code, str)
    assert got.value.code == want.value.code


LM = "tf_operator_tpu_torch.train.dist_lm"
ENTRY = ["--device", "cpu", "--steps", "120", "--batch", "8", "--seq", "64",
         "--vocab", "256", "--d-model", "128", "--layers", "2", "--pp", "2",
         "--lr", "5e-3", "--target-loss", "1.0"]


def _launch(args, world, tmp, tag, module=LM):
    port = free_port()
    procs = []
    for r in range(world):
        env = rank_env(r, world, port)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        with open(os.path.join(tmp, f"{tag}{r}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args], cwd=REPO, env=env,
                stdout=out, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, timeout=RANK_TIMEOUT):
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


def test_dist_lm_pp_resumes_and_serve_lm_from_pp_answers(tmp_path):
    tmp = str(tmp_path)
    ck = str(tmp_path / "ck")
    first = _launch(ENTRY + ["--checkpoint-dir", ck, "--fail-at-step", "60"],
                    2, tmp, "first")
    twin = _launch(ENTRY + ["--pp-schedule", "1f1b", "--pp-microbatches",
                            "4"], 2, tmp, "twin")
    codes = _wait(first + twin)
    assert codes == [138, 138, 0, 0], _log(tmp, "first") + _log(tmp, "twin")
    second = _launch(ENTRY + ["--checkpoint-dir", ck], 2, tmp, "second")
    assert _wait(second) == [0, 0], _log(tmp, "second")
    for tag in ("first", "second", "twin"):
        for r in range(2):
            out = _log(tmp, tag, r)
            assert (f"dist_lm: process {r}/2, mesh {{'dp': 1, 'sp': 1, "
                    f"'tp': 1, 'pp': 2}}") in out, out
    for r in range(2):
        out = _log(tmp, "second", r)
        assert "dist_lm: resumed from step 61" in out and (
            "dist_lm: OK" in out), out
        assert "dist_lm: OK" in _log(tmp, "twin", r)
    assert "dist_lm: simulating preemption at step 60" in _log(tmp, "first")

    port = free_port()
    log = tmp_path / "serve.log"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.serve.serve_lm",
             "--device", "cpu", "--port", str(port), "--checkpoint-dir", ck,
             "--from-pp", "2", "--max-seq-len", "64", "--requests", "1"],
            env=env, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        limit = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(url + "/healthz", timeout=5).read()
                break
            except OSError:
                assert proc.poll() is None, log.read_text()
                assert time.monotonic() < limit, log.read_text()
                time.sleep(0.2)
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"tokens": [[5, 6, 7, 8]], "num_steps": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["tokens"][0] == [9, 10, 11, 12], body
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert re.search(r"serve_lm: restored target checkpoint step 119 "
                     r"\(merged from pp=2\)", text), text
