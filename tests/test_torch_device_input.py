"""The port's device-resident input (tf_operator_tpu_torch/train/
device_input.py) and the draws under it (random.py's ``randint``,
``bernoulli`` and ``permutation``) held bitwise against the JAX package
on the CPU: the draws over several keys, shapes and bounds (two shuffle
rounds past n = 1625); both samplers' batches for the same keys, bf16
pixels and labels; each record once an epoch; the record reader; and the
fused train loop across an epoch boundary, against JAX's scan over the
same classifier step (params and batch_stats within 1e-4 of each leaf's
largest magnitude, the f32 rule of tests/test_torch_classifier.py; the
carried key and sampler state bitwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.resnet import ResNet as JaxResNet
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.train import device_input as jax_input
from tf_operator_tpu.train import steps as jax_steps
from tf_operator_tpu_torch import random
from tf_operator_tpu_torch.models import convert, resnet
from tf_operator_tpu_torch.train import device_input, steps

torch.set_num_threads(1)

SEEDS = (0, 1, 42, 2**31 + 5)
LEAF_RTOL = 1e-4


def _keys(seed):
    return jax.random.PRNGKey(seed), random.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("shape,lo,hi", [
    ((256,), 0, 33), ((17,), 0, 1024), ((5, 3), -7, 100_000),
    ((8,), 3, 3), ((8,), 5, 2), ((64,), 0, 2**31 - 1), ((1,), -2**31, 7),
])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_is_jax_bitwise(seed, shape, lo, hi):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = random.randint(tk, shape, lo, hi)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_is_jax_bitwise(seed, p):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.bernoulli(jk, p, (300,)))
    got = random.bernoulli(tk, p, (300,))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 10, 1024, 1700, 5000])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_is_jax_bitwise(seed, n):
    jk, tk = _keys(seed)
    got = random.permutation(tk, n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.permutation(jk,
                                                                         n)))
    assert sorted(got.tolist()) == list(range(n))


def _records(n=16, r=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, r, r, 3), dtype=np.uint8),
            rng.integers(0, 256, (n,), dtype=np.int32))


def _assert_batch_equal(want, got):
    np.testing.assert_array_equal(
        np.asarray(want["image"].astype(jnp.float32)),
        got["image"].float().numpy())
    np.testing.assert_array_equal(np.asarray(want["label"]),
                                  got["label"].numpy())
    assert got["image"].dtype == torch.bfloat16


@pytest.mark.parametrize("crop", [8, 12])
def test_sampler_batches_are_jax_bitwise(crop):
    """crop 8 of 12: random offsets; crop 12: flips only."""
    images, labels = _records()
    want_fn = jax_input.make_resident_sampler(
        jnp.asarray(images), jnp.asarray(labels), 4, crop, 10)
    got_fn = device_input.make_resident_sampler(
        torch.from_numpy(images), torch.from_numpy(labels), 4, crop, 10)
    for seed in SEEDS:
        jk, tk = _keys(seed)
        _assert_batch_equal(want_fn(jk), got_fn(tk))


def test_epoch_sampler_batches_are_jax_bitwise_across_epochs():
    images, labels = _records()
    want_fn, jstate = jax_input.make_resident_epoch_sampler(
        jnp.asarray(images), jnp.asarray(labels), 4, 8, 10)
    got_fn, tstate = device_input.make_resident_epoch_sampler(
        torch.from_numpy(images), torch.from_numpy(labels), 4, 8, 10)
    jk, tk = _keys(3)
    for _ in range(10):  # 2.5 epochs of 4 batches
        jk, jsub = jax.random.split(jk)
        tk, tsub = random.split(tk)
        want, jstate = want_fn(jsub, jstate)
        got, tstate = got_fn(tsub, tstate)
        _assert_batch_equal(want, got)
        np.testing.assert_array_equal(np.asarray(jstate[0]),
                                      tstate[0].numpy())
        assert int(jstate[1]) == tstate[1]


def test_each_record_once_an_epoch():
    images, _ = _records(n=24)
    labels = np.arange(24, dtype=np.int32)  # a label names its record
    sample, state = device_input.make_resident_epoch_sampler(
        torch.from_numpy(images), torch.from_numpy(labels), 6, 8, 1000)
    key = random.PRNGKey(7, device="cpu")
    epochs = []
    for _ in range(3):
        seen = []
        for _ in range(4):
            key, sub = random.split(key)
            batch, state = sample(sub, state)
            seen += batch["label"].tolist()
        assert sorted(seen) == list(range(24))
        epochs.append(seen)
    assert epochs[0] != epochs[1] != epochs[2]


def test_sampler_refusals():
    images, labels = _records(n=10)
    with pytest.raises(ValueError, match="divisible by batch"):
        device_input.make_resident_epoch_sampler(
            torch.from_numpy(images), torch.from_numpy(labels), 4, 8)
    with pytest.raises(ValueError, match="smaller than crop"):
        device_input.make_resident_sampler(
            torch.from_numpy(images), torch.from_numpy(labels), 4, 16)


def test_load_records_numpy_matches_jax(tmp_path):
    r = 6
    rec_bytes = r * r * 3 + 1
    raw = np.random.default_rng(0).integers(0, 256, (5, rec_bytes),
                                            dtype=np.uint8)
    path = str(tmp_path / "recs.bin")
    raw.tofile(path)
    want = jax_input.load_records_numpy(path, rec_bytes, r)
    got = device_input.load_records_numpy(path, rec_bytes, r)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a multiple"):
        device_input.load_records_numpy(path, rec_bytes + 1, r)
    with pytest.raises(ValueError, match="label byte"):
        device_input.load_records_numpy(path, rec_bytes, r + 1)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_leaves_close(got, want):
    flat_got, flat_want = _flat(got), _flat(want)
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        err = np.abs(flat_got[path] - w).max()
        assert err <= LEAF_RTOL * max(np.abs(w).max(), 1e-12), (path, err)


@pytest.mark.parametrize("stateful", [True, False])
def test_train_loop_matches_jax_across_an_epoch_boundary(stateful):
    """8 records, batch 4, 3 steps a call, two calls: the epoch sampler
    reshuffles inside each call; the stateless form draws i.i.d. Images
    go in as bf16 to an f32 model (leaves randomized, as
    tests/test_torch_classifier.py does and says why).

    The carried key and sampler state are held bitwise against JAX's
    fused loop. The training is held against JAX's sampler and step
    driven eagerly in the same split order: XLA's CPU compiler keeps the
    fused loop's normalised pixels in f32 (its excess-precision default
    drops the bf16 rounding between the sampler and the model), so JAX's
    fused loop parts from its own step on the same batch by ~3e-4 in the
    loss (measured), while the eager step and the port agree to ~1e-7."""
    images, labels = _records(n=8)
    jm = JaxResNet(stage_sizes=(1,), width=8, num_classes=10,
                   dtype=jnp.float32)
    rng = np.random.default_rng(1)
    v = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim == 1
                   else rng.normal(size=a.shape) * 0.3).astype(np.float32),
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         np.zeros((1, 8, 8, 3)))))
    jtx = jax_steps.sgd_momentum(0.05)

    def jax_state():
        return jax_steps.TrainState.create(v["params"], jtx,
                                           batch_stats=v["batch_stats"])

    jstep = jax_steps.make_classifier_train_step(
        jm, jtx, create_mesh({"dp": 1}, jax.devices("cpu")[:1]),
        donate=False)
    model = convert.load_variables(
        resnet.ResNet((1,), 10, 8, torch.float32, device="cpu"), v)
    tx = steps.sgd_momentum(0.05)
    state = steps.TrainState.create(model, tx)
    step = steps.make_classifier_train_step(model, tx)
    ji, jl = jnp.asarray(images), jnp.asarray(labels)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    if stateful:
        jsample, jss = jax_input.make_resident_epoch_sampler(ji, jl, 4, 8, 10)
        tsample, tss = device_input.make_resident_epoch_sampler(ti, tl, 4, 8,
                                                                10)
        fused = jax_input.make_resident_epoch_train_loop(jstep, jsample, 3)
        tloop = device_input.make_resident_epoch_train_loop(step, tsample, 3)
    else:
        jsample = jax_input.make_resident_sampler(ji, jl, 4, 8, 10)
        fused = jax_input.make_resident_train_loop(jstep, jsample, 3)
        tloop = device_input.make_resident_train_loop(
            step, device_input.make_resident_sampler(ti, tl, 4, 8, 10), 3)
        jss = tss = ()
    fused_state, eager_state = jax_state(), jax_state()
    jk, tk = _keys(5)
    eager_key, eager_ss = jk, jss
    for _ in range(2):
        if stateful:
            fused_state, _, jk, jss = fused(fused_state, jk, jss)
            state, tm_, tk, tss = tloop(state, tk, tss)
            np.testing.assert_array_equal(np.asarray(jss[0]),
                                          tss[0].numpy())
            assert int(jss[1]) == tss[1]
        else:
            fused_state, _, jk = fused(fused_state, jk)
            state, tm_, tk = tloop(state, tk)
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        for _ in range(3):
            eager_key, sub = jax.random.split(eager_key)
            if stateful:
                batch, eager_ss = jsample(sub, eager_ss)
            else:
                batch = jsample(sub)
            eager_state, jm_ = jstep(eager_state, batch)
        np.testing.assert_array_equal(np.asarray(eager_key), tk.numpy())
        assert abs(float(jm_["loss"]) - float(tm_["loss"])) <= 1e-5 * max(
            1.0, abs(float(jm_["loss"])))
        assert float(jm_["accuracy"]) == float(tm_["accuracy"])
    assert state.step == int(eager_state.step) == int(fused_state.step) == 6
    got = convert.export_variables(model)
    _assert_leaves_close(got["params"], eager_state.params)
    _assert_leaves_close(got["batch_stats"], eager_state.batch_stats)
