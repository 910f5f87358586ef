"""The port's checkpoint layer (tf_operator_tpu_torch/train/checkpoint.py
and ckpt/protocol.py) on the CPU, held against the JAX package where it
has a counterpart: save/restore bitwise (weights, AdamW moments, step),
restore_or_init's fresh start, resume and min_step rule, the steps kept
for a sequence of saves equal to orbax's under JAX's CheckpointManager,
a forced save of a saved step refused as JAX refuses it, ack files that
JAX's read_ack parses, the JAX operator's sweeper pruning a port
directory, the async-copy trap, and the params of a checkpoint after
three f32 steps equal to JAX's restored params after the same steps.

Tolerance: the last test's params within 1e-5 absolute, the bound
tests/test_torch_train.py holds the train step to (its docstring says
why, and why the key bias is held to 4 x the summed learning rate)."""

import json
import os
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.api import constants
from tf_operator_tpu.ckpt import protocol as jax_protocol
from tf_operator_tpu.ckpt.gc import CheckpointSweeper, SweepConfig
from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.runtime import objects
from tf_operator_tpu.runtime.memcluster import InMemoryCluster
from tf_operator_tpu.train import checkpoint as jax_checkpoint
from tf_operator_tpu.train import steps as jax_steps
from tf_operator_tpu_torch.ckpt import protocol
from tf_operator_tpu_torch.models.convert import (
    export_params,
    init_params,
    load_params,
)
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from tf_operator_tpu_torch.train import checkpoint, steps
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

SEQ = 16
KW = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=2, d_ff=32,
          max_seq_len=SEQ)
CFG = TransformerConfig(dtype=torch.float32, **KW)
PARAM_TOL = 1e-5


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 32, (b, SEQ)).astype(np.int32),
            "targets": rng.integers(0, 32, (b, SEQ)).astype(np.int32)}


def _trainer(cfg=CFG, seed=0, lr=1e-2):
    model = load_params(Transformer(cfg, device="cpu"), init_params(cfg, seed))
    tx = steps.adamw(lr)
    return steps.TrainState.create(model, tx), steps.make_lm_train_step(
        model, tx)


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _state_tensors(state) -> dict:
    """Every weight, moment and step count of a state, by name."""
    out = {("step",): torch.tensor(state.step)}
    for name, p in state.model.named_parameters():
        out[("param", name)] = p.detach()
        for key, val in state.optimizer.state.get(p, {}).items():
            out[(key, name)] = val
    return out


def _assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for key, val in ta.items():
        assert val.dtype == tb[key].dtype, key
        assert torch.equal(val, tb[key]), key


def test_save_restore_is_bitwise_with_the_optimizer(tmp_path):
    state, step = _trainer()
    for i in range(3):
        state, _ = step(state, _batch(i))
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        assert mgr.save(2, state)
        mgr.wait()
        assert mgr.latest_step() == 2
        fresh, fresh_step = _trainer(seed=9)
        assert mgr.restore(None, fresh) is fresh
    _assert_states_equal(fresh, state)
    assert fresh.step == 3
    # Both carry on alike: the restored moments are AdamW's own.
    state, m1 = step(state, _batch(7))
    fresh, m2 = fresh_step(fresh, _batch(7))
    assert m1["loss"].item() == m2["loss"].item()
    _assert_states_equal(fresh, state)
    # The file is tensors only: torch's safe loader reads it.
    payload = torch.load(str(tmp_path / "ck" / "2" / checkpoint.STATE_FILE),
                         weights_only=True)
    assert set(payload) == {"params", "opt", "step"}
    assert set(payload["opt"]) == set(checkpoint.MOMENT_KEYS)
    manifest = json.loads(
        (tmp_path / "ck" / "2" / checkpoint.MANIFEST_FILE).read_text())
    assert manifest["config"] == checkpoint.config_fields(CFG)


def test_restore_into_another_shape_names_the_fields(tmp_path):
    state, step = _trainer()
    state, _ = step(state, _batch(0))
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(0, state)
        mgr.wait()
        other, _ = _trainer(replace(CFG, d_ff=64))
        with pytest.raises(ValueError, match=r"d_ff 32 \(checkpoint\) vs 64"):
            mgr.restore(0, other)
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path / "empty")).restore(None, other)


def test_restore_or_init_fresh_resume_and_min_step(tmp_path):
    path = str(tmp_path / "ck")
    # The follower opens the (empty) directory FIRST, as
    # tests/test_ckpt.py's follower does.
    follower = CheckpointManager(path)
    state, step = _trainer()
    got, start = follower.restore_or_init(state, min_step=None)
    assert (got, start) == (state, 0)
    with CheckpointManager(path, max_to_keep=None) as writer:
        for i in range(3):
            state, _ = step(state, _batch(i))
            writer.save(i, state)
        writer.wait()
    # min_step: the operator's acked step; the directory is re-read and
    # the replacement resumes from what is on disk, never below it.
    fresh, _ = _trainer(seed=4)
    got, start = follower.restore_or_init(fresh, min_step=2)
    assert start == 3 and got is fresh
    _assert_states_equal(fresh, state)
    again, _ = _trainer(seed=5)
    assert follower.restore_or_init(again, min_step=None)[1] == 3
    follower.close()


def test_resume_env_contract(monkeypatch):
    monkeypatch.delenv(protocol.ENV_RESUME_STEP, raising=False)
    monkeypatch.delenv(protocol.ENV_CKPT_DIR, raising=False)
    assert checkpoint.resume_min_step() is None
    assert checkpoint.injected_dir() is None
    for raw, want in (("7", 7), ("x", None), ("", None)):
        monkeypatch.setenv(protocol.ENV_RESUME_STEP, raw)
        assert checkpoint.resume_min_step() == want
        assert jax_checkpoint.resume_min_step() == want
    monkeypatch.setenv(protocol.ENV_CKPT_DIR, "/ckpt/x")
    assert checkpoint.injected_dir() == jax_checkpoint.injected_dir()
    assert (protocol.ENV_ACK_FILE, protocol.ENV_RESUME_STEP,
            protocol.ENV_CKPT_DIR) == (jax_protocol.ENV_ACK_FILE,
                                       jax_protocol.ENV_RESUME_STEP,
                                       jax_protocol.ENV_CKPT_DIR)


# (step, force) calls; steps kept and each call's answer must equal
# orbax's under JAX's CheckpointManager (interval 3, max_to_keep 2).
SAVE_CALLS = {
    "interval": [(i, False) for i in range(10)],
    "forced": [(0, False), (1, False), (2, True), (3, False), (3, True),
               (4, False), (5, True), (6, False), (6, True), (7, False),
               (8, True), (9, False)],
    "first-off-interval": [(1, False), (2, False), (4, True), (5, False),
                           (6, False), (7, False), (9, False)],
}


def _jax_kept(path, calls):
    mgr = jax_checkpoint.CheckpointManager(path, max_to_keep=2,
                                           save_interval_steps=3)
    tree = {"w": jnp.zeros((3,), jnp.float32)}
    answers = []
    for step_no, force in calls:
        answers.append(bool(mgr.save(step_no, tree, force=force)))
        mgr.wait()
    mgr.close()
    return answers, sorted(int(e) for e in os.listdir(path) if e.isdigit())


@pytest.mark.parametrize("case", sorted(SAVE_CALLS))
def test_kept_steps_equal_orbax(case, tmp_path):
    calls = SAVE_CALLS[case]
    want_answers, want_kept = _jax_kept(str(tmp_path / "jax"), calls)
    state, _ = _trainer()
    answers = []
    with CheckpointManager(str(tmp_path / "port"), max_to_keep=2,
                           save_interval_steps=3) as mgr:
        for step_no, force in calls:
            answers.append(mgr.save(step_no, state, force=force))
        mgr.wait()
        assert mgr.all_steps() == want_kept
    assert answers == want_answers
    assert sorted(os.listdir(tmp_path / "port")) == [str(s)
                                                     for s in want_kept]


def test_forced_save_of_a_saved_step_returns_false(tmp_path):
    state, _ = _trainer()
    with CheckpointManager(str(tmp_path / "port")) as mgr:
        assert mgr.save(4, state)
        # Still being written, then committed: refused either way.
        assert mgr.save(4, state, force=True) is False
        mgr.wait()
        assert mgr.save(4, state, force=True) is False
        assert mgr.save(3, state) is False  # behind the newest step
        assert mgr.save(3, state, force=True) is True
    jmgr = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"))
    tree = {"w": jnp.zeros((3,), jnp.float32)}
    assert jmgr.save(4, tree)
    assert jmgr.save(4, tree, force=True) is False
    jmgr.close()


def test_ack_files_parse_with_the_jax_protocol(tmp_path):
    ack_path = str(tmp_path / "ack.json")
    state, step = _trainer()
    mgr = CheckpointManager(str(tmp_path / "ck"), ack_path=ack_path)
    assert mgr.maybe_ack() is None  # nothing committed yet
    assert mgr.ack() is None
    state, _ = step(state, _batch(0))
    mgr.save(0, state)
    mgr.wait()
    assert mgr.maybe_ack() == 0
    ack = jax_protocol.read_ack(ack_path)
    assert (ack.step, ack.directory) == (0, mgr.directory)
    assert ack.saved_at.endswith("Z")
    assert protocol.read_ack(ack_path).to_dict() == {
        "step": 0, "dir": mgr.directory, "savedAt": ack.saved_at}
    assert mgr.maybe_ack() is None  # once per step
    before = os.stat(ack_path).st_mtime_ns
    os.utime(ack_path, ns=(before - 10**9, before - 10**9))
    # ack() always rewrites: the executor reads the change as the ack.
    assert mgr.ack() == 0
    assert os.stat(ack_path).st_mtime_ns > before - 10**9
    state, _ = step(state, _batch(1))
    mgr.save(1, state)
    assert mgr.ack() == 1  # drains the write first
    assert jax_protocol.read_ack(ack_path).step == 1
    assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []
    mgr.close()
    # An unwritable ack path never fails a save.
    bad = CheckpointManager(str(tmp_path / "ck2"),
                            ack_path=str(tmp_path / "no" / "ack.json"))
    assert bad.save(0, state)
    assert bad.ack() is None and bad.maybe_ack() is None
    assert bad.latest_step() == 0
    bad.close()


def test_port_ack_file_round_trip_matches_jax(tmp_path):
    path = str(tmp_path / "ack.json")
    assert protocol.read_ack(path) is None
    protocol.write_ack(path, 42, "/ckpt/demo")
    ours, theirs = protocol.read_ack(path), jax_protocol.read_ack(path)
    assert (ours.step, ours.directory, ours.saved_at) == (
        theirs.step, theirs.directory, theirs.saved_at)
    jax_protocol.write_ack(path, 43)
    assert protocol.read_ack(path).step == 43
    with open(path, "w") as f:
        f.write("{not json")
    assert protocol.read_ack(path) is None
    assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []


def test_sweeper_prunes_a_port_checkpoint_dir(tmp_path):
    """ckpt/gc.py's CheckpointSweeper keeps the newest step of a
    Succeeded job's port directory, which still restores; a live
    writer's temporary step is not a step and stays."""
    path = tmp_path / "ck"
    state, step = _trainer()
    with CheckpointManager(str(path), max_to_keep=None) as mgr:
        for i in range(4):
            state, _ = step(state, _batch(i))
            mgr.save(i, state)
    (path / f"9.tmp-{os.getpid()}").mkdir()
    client = InMemoryCluster()
    job = {"apiVersion": constants.API_VERSION, "kind": constants.KIND,
           "metadata": {"name": "train", "namespace": "default",
                        "annotations": {jax_protocol.JOB_DIR: str(path)}},
           "spec": {"replicaSpecs": {}}}
    client.create(objects.TPUJOBS, job)
    sweeper = CheckpointSweeper(client, SweepConfig(keep=1))
    assert sweeper.sweep() == 0  # not Succeeded yet
    job = client.get(objects.TPUJOBS, "default", "train")
    job.setdefault("status", {})["conditions"] = [
        {"type": "Succeeded", "status": "True"}]
    client.update_status(objects.TPUJOBS, job)
    assert sweeper.sweep() == 3
    assert sorted(os.listdir(path)) == ["3", f"9.tmp-{os.getpid()}"]
    fresh, _ = _trainer(seed=3)
    with CheckpointManager(str(path)) as mgr:
        assert mgr.restore_or_init(fresh)[1] == 4
    _assert_states_equal(fresh, state)


def test_readers_leave_the_directory_as_they_find_it(tmp_path):
    """The module's readers (a server's or an evaluator's path) create
    nothing, and neither they nor another manager on the directory touch
    a writer's temporary step, whoever wrote it."""
    missing = tmp_path / "missing"
    assert checkpoint.all_steps(str(missing)) == []
    assert checkpoint.latest_step(str(missing)) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.read(str(missing))
    assert not missing.exists()
    state, step = _trainer()
    state, _ = step(state, _batch(0))
    path = tmp_path / "ck"
    with CheckpointManager(str(path)) as mgr:
        mgr.save(0, state)
    others = [path / "5.tmp-999999999", path / f"6.tmp-{os.getpid()}"]
    for tmp in others:
        tmp.mkdir()
    with CheckpointManager(str(path)) as mgr:
        assert mgr.latest_step() == 0
    got = dict(_flat(checkpoint.restore_params(str(path), CFG)))
    want = dict(_flat(export_params(state.model)))
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(val)), key
    with pytest.raises(ValueError, match=r"d_ff 32 \(checkpoint\) vs 64"):
        checkpoint.restore_params(str(path), replace(CFG, d_ff=64))
    assert sorted(os.listdir(path)) == ["0", *(t.name for t in others)]


def test_save_copies_before_the_in_place_step(tmp_path, monkeypatch):
    """The async-copy trap: the write is held back until after the next
    in-place train step; the checkpoint still holds the saved step's
    weights and moments, not the later ones."""
    state, step = _trainer()
    state, _ = step(state, _batch(0))
    want = {k: v.clone() for k, v in _state_tensors(state).items()}
    release = threading.Event()
    original = CheckpointManager._write

    def held(self, *args):
        assert release.wait(30)
        original(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.save(0, state)
        state, _ = step(state, _batch(1))
        release.set()
        mgr.wait()
        fresh, _ = _trainer(seed=8)
        mgr.restore(0, fresh)
    got = _state_tensors(fresh)
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert torch.equal(got[key], val), key
    moved = _state_tensors(state)[("param", "lm_head.kernel")]
    assert not torch.equal(got[("param", "lm_head.kernel")], moved)


def _jax_assert_tree_close(got, want, atol, lr_sum):
    """tests/test_torch_train.py's rule: every leaf within ``atol``, the
    key-bias slice within 4 * ``lr_sum``."""
    flat_got = dict(_flat(got))
    flat_want = {tuple(k.key for k in path): np.asarray(leaf) for path, leaf
                 in jax.tree_util.tree_leaves_with_path(want)}
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        g = np.array(flat_got[path])
        key_bias = {"qkv": 1, "kv": 0}.get(path[-2]) if (
            path[-1] == "bias" and path[-3:-2] == ("attn",)) else None
        if key_bias is not None:
            np.testing.assert_allclose(g[key_bias], leaf[key_bias],
                                       atol=4 * lr_sum, rtol=0)
            g[key_bias] = leaf[key_bias]
        np.testing.assert_allclose(g, leaf, atol=atol, rtol=0,
                                   err_msg="/".join(path))


def test_checkpoint_params_after_three_steps_match_jax(tmp_path):
    jcfg = JaxConfig(dtype=jnp.float32, **KW)
    params = jax.tree.map(np.asarray, JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, SEQ), jnp.int32))["params"])
    batches = [_batch(20 + i) for i in range(3)]
    lr = 3e-3

    mesh = create_mesh({"dp": 1}, jax.devices("cpu")[:1])
    jtx = jax_steps.adamw(lr)
    jstep = jax_steps.make_lm_train_step(
        JaxTransformer(replace(jcfg, mesh=mesh)), jtx, mesh, seq_axis=None,
        donate=False)
    jstate = jax_steps.TrainState.create(params, jtx)
    jmgr = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"))
    for i, batch in enumerate(batches):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        jmgr.save(i, jstate)
    jmgr.wait()
    template = jax_steps.TrainState.create(params, jtx)
    want = jmgr.restore(None, template).params
    jmgr.close()

    model = load_params(Transformer(CFG, device="cpu"), params)
    tx = steps.adamw(lr)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx)
    with CheckpointManager(str(tmp_path / "port")) as mgr:
        for i, batch in enumerate(batches):
            state, _ = step(state, batch)
            mgr.save(i, state)
        mgr.wait()
        assert mgr.latest_step() == 2
        got = checkpoint.restore_params(mgr.directory, CFG)
    _jax_assert_tree_close(got, want, PARAM_TOL, lr_sum=3 * lr)
    _jax_assert_tree_close(export_params(model), want, PARAM_TOL,
                           lr_sum=3 * lr)
