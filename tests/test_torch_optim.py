"""The port's LAMB and Adafactor (tf_operator_tpu_torch/train/steps.py) on
the CPU in f32, held against optax through the JAX package's
``steps.lamb``/``steps.adafactor``, and their state through the
checkpoint layer (tf_operator_tpu_torch/train/checkpoint.py):

- 3 steps of each on a small LM with dims >= 128 (tests/test_training.py
  sizes its Adafactor test so, as optax factors only axes >= 128), the
  JAX init's weights: losses within 1e-5 at every step; every leaf and
  every leaf of the optimiser's state (LAMB's moments; Adafactor's
  ``v_row``/``v_col`` of the factored leaves, ``v`` of the others, among
  them leaves under 128 that stay unfactored) within 1e-4 of its largest
  magnitude (``LEAF_RTOL``). The key bias, whose gradient is rounding
  noise (a softmax ignores it) that both optimisers normalise into steps
  of about lr, is held to 4 x the steps' summed lr, as
  tests/test_torch_train.py holds it; its second moments are noise
  squared and are not compared. Adafactor clips and scales each leaf by
  its block's rms, which mixes that noise into the whole ``qkv`` bias
  leaf, so under Adafactor the whole leaf is held so.
- The state saves and restores bitwise, and a restored run's next step
  equals the unbroken run's; Adafactor's factored rows keep their own
  shapes on disk.
- A dense model's manifest records no MoE field, so a dense checkpoint
  written before MoE was ported restores as it did; an MoE model refuses
  it, naming the fields."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.train import steps as jsteps
from tf_operator_tpu_torch.models.convert import (
    export_params,
    flax_path,
    init_params,
    load_params,
)
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from tf_operator_tpu_torch.train import checkpoint, steps

torch.set_num_threads(1)

LEAF_RTOL, LOSS_TOL = 1e-4, 1e-5
KW = dict(vocab_size=256, d_model=128, n_heads=4, n_layers=2, d_ff=256,
          max_seq_len=32)
OPTS = {"lamb": (5e-3, jsteps.lamb, steps.lamb),
        "adafactor": (2e-2, jsteps.adafactor, steps.adafactor)}
KEY_BIAS = ("attn", "qkv", "bias")


def _batch():
    rng = np.random.default_rng(11)
    chain = (rng.integers(0, 256, (4, 1)) + np.arange(17)) % 256
    return {"tokens": chain[:, :-1].astype(np.int32),
            "targets": chain[:, 1:].astype(np.int32)}


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close(path, got, want, lr_sum, whole_leaf=False):
    got, want = np.array(got), np.array(want)
    if path[-3:] == KEY_BIAS:
        # The key bias's slice (index 1), or with ``whole_leaf`` the leaf.
        rows = slice(None) if whole_leaf else 1
        if lr_sum is not None:
            assert np.abs(got[rows] - want[rows]).max() <= 4 * lr_sum, path
        got[rows] = want[rows]  # moments of noise are not compared
    err = np.abs(got - want).max()
    assert err <= LEAF_RTOL * np.abs(want).max(), (path, err)


def _port(params, name):
    lr, _, make = OPTS[name]
    model = load_params(Transformer(TransformerConfig(
        dtype=torch.float32, **KW), "cpu"), jax.tree.map(np.asarray, params))
    tx = make(lr)
    return model, tx, steps.TrainState.create(model, tx), \
        steps.make_lm_train_step(model, tx)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_three_steps_match_optax(name):
    lr, jmake, _ = OPTS[name]
    jcfg = JaxConfig(dtype=jnp.float32, **KW)
    batch = _batch()
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["tokens"]))["params"]
    mesh = create_mesh({"dp": 1}, jax.devices()[:1])
    jtx = jmake(lr)
    jstate = jsteps.TrainState.create(params, jtx)
    jstep = jsteps.make_lm_train_step(JaxTransformer(jcfg), jtx, mesh,
                                      seq_axis=None, donate=False)
    model, _, state, step = _port(params, name)
    for _ in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * float(
            jm["loss"])
    got = {flax_path(n): p for n, p in model.named_parameters()}
    # Adafactor clips and scales a leaf by its whole block's rms, so the
    # key bias's noise reaches the query and value biases of its leaf.
    whole = name == "adafactor"
    for path, want in _flat(jstate.params).items():
        _close(path, got[path].detach().numpy(), want, 3 * lr, whole)

    opt = state.optimizer
    inner = jstate.opt_state[0]  # scale_by_adam / scale_by_factored_rms
    if name == "lamb":
        pairs = {"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
    else:
        pairs = {"v_row": inner.v_row, "v_col": inner.v_col, "v": inner.v}
    factored = unfactored = 0
    for key, tree in pairs.items():
        for path, want in _flat(tree).items():
            st = opt.state[got[path]]
            assert int(st["step"]) == 3
            if key not in st:
                # optax keeps a (1,) placeholder where the port keeps none.
                assert want.shape == (1,), (key, path)
                continue
            factored += key == "v_row"
            unfactored += key == "v"
            _close(path, st[key].numpy(), want, None, whole)
    if name == "adafactor":
        # The MLP kernels, the embedding and the head have two axes >= 128
        # and factor; the rest (norms, biases, the attention kernels whose
        # second longest axis is 32, the [32, 128] position table) keep a
        # full second moment.
        assert (factored, unfactored) == (6, 19)
        pos = opt.state[got[("pos", "embedding")]]
        assert "v" in pos and "v_row" not in pos


def _opt_tensors(state):
    return {(n, k): v.clone() for n, p in state.model.named_parameters()
            for k, v in state.optimizer.state[p].items()}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_round_trips_through_a_checkpoint(name, tmp_path):
    cfg = TransformerConfig(dtype=torch.float32, **KW)
    params = init_params(cfg, 0)
    batch = _batch()
    _, _, state, step = _port(params, name)
    for _ in range(2):
        state, _ = step(state, batch)
    with checkpoint.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(2, state, force=True)
        mgr.wait()
        _, _, fresh, fresh_step = _port(params, name)
        mgr.restore(None, fresh)
    assert fresh.step == 2
    want = _opt_tensors(state)
    assert _opt_tensors(fresh).keys() == want.keys()
    for key, val in _opt_tensors(fresh).items():
        assert val.shape == want[key].shape and torch.equal(val,
                                                             want[key]), key
    if name == "adafactor":
        payload, _ = checkpoint.read(str(tmp_path))
        rows = payload["opt"]["v_row"]["block_0"]["mlp"]["in_proj"]["kernel"]
        assert tuple(rows.shape) == (KW["d_model"],)  # [d, f] -> [d]
    state, _ = step(state, batch)
    fresh, _ = fresh_step(fresh, batch)
    for (path, a), b in zip(_flat(export_params(state.model)).items(),
                            _flat(export_params(fresh.model)).values()):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_dense_checkpoint_restores_and_moe_refuses_it(tmp_path):
    cfg = TransformerConfig(dtype=torch.float32, **KW)
    model = load_params(Transformer(cfg, "cpu"), init_params(cfg, 0))
    tx = steps.adamw(1e-3)
    with checkpoint.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(0, steps.TrainState.create(model, tx), force=True)
    with open(tmp_path / "0" / checkpoint.MANIFEST_FILE) as f:
        saved = json.load(f)["config"]
    # The record a dense checkpoint had before MoE was ported.
    assert sorted(saved) == sorted(
        ("vocab_size", "d_model", "n_heads", "n_kv_heads", "n_layers",
         "d_ff", "max_seq_len"))
    twin = Transformer(cfg, "cpu")
    with checkpoint.CheckpointManager(str(tmp_path)) as mgr:
        mgr.restore(None, steps.TrainState.create(twin, tx))
    assert torch.equal(twin.blocks[0].mlp.in_proj.kernel,
                       model.blocks[0].mlp.in_proj.kernel)
    moe_cfg = TransformerConfig(dtype=torch.float32, moe_every_n=2,
                                moe_experts=4, **KW)
    with pytest.raises(ValueError, match="moe_every_n None .checkpoint. vs "
                                         "2 .model."):
        checkpoint.restore_params(str(tmp_path), moe_cfg)
    assert os.path.isdir(tmp_path / "0")
