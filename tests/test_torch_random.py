"""The port's threefry sampler (tf_operator_tpu_torch/random.py) held
against the installed JAX on the CPU: the Threefry-2x32 hash, ``PRNGKey``,
``split``, ``fold_in``, ``random_bits`` and ``uniform`` bitwise; ``gumbel``
within 4 ulp of max(|g|, 1) (XLA's CPU ``log`` is accurate to a few ulp
of 1 near 1, not of its result, so the -log(-log(u)) chain differs there
by an absolute few 1e-7); ``categorical`` equal but at Gumbel near-ties.
Bits are compared as uint32 words widened to int64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax._src import prng

from tf_operator_tpu_torch import random as tr

torch.set_num_threads(1)

WORD = 0xFFFFFFFF
# Random123's known answers for Threefry-2x32 at 20 rounds: (key, counter,
# output); JAX's own test holds the same three.
RANDOM123 = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((WORD, WORD), (WORD, WORD), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]
SEEDS = [0, 7, 2**31, -1, 2**40 + 3]
SHAPES = [(1, 64), (3, 37), (4, 32768)]
NEAR_TIE = 1e-4


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def _key(seed):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("key,ctr,out", RANDOM123)
def test_threefry_known_answers(key, ctr, out):
    want = _words(prng.threefry_2x32(np.uint32(key), np.uint32(ctr)))
    got = tr.threefry2x32(*(torch.tensor(w) for w in (*key, *ctr)))
    assert [int(w) for w in got] == list(out) == want.tolist()


@settings(max_examples=60, deadline=None)
@given(key=st.tuples(st.integers(0, WORD), st.integers(0, WORD)),
       ctr=st.lists(st.tuples(st.integers(0, WORD), st.integers(0, WORD)),
                    min_size=1, max_size=9))
def test_threefry_matches_jax(key, ctr):
    x0, x1 = (np.array(c, np.int64) for c in zip(*ctr))
    # threefry_2x32 hashes the first half of its counts against the second.
    want = _words(prng.threefry_2x32(
        np.uint32(key), np.concatenate([x0, x1]).astype(np.uint32)))
    y0, y1 = tr.threefry2x32(torch.tensor(key[0]), torch.tensor(key[1]),
                             torch.from_numpy(x0), torch.from_numpy(x1))
    np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS + [2**63 - 1, -(2**40)])
def test_prng_key_is_bitwise_jax(seed):
    jk, tk = _key(seed)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), _words(jk))


@pytest.mark.parametrize("num", [1, 2, 3, 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_is_bitwise_jax(seed, num):
    jk, tk = _key(seed)
    got = tr.split(tk, num)
    assert got.shape == (num, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  _words(jax.random.split(jk, num)))


def test_split_of_a_split_is_bitwise_jax():
    jk, tk = _key(3)
    want = jax.random.split(jax.random.split(jk, 4)[2], 5)
    np.testing.assert_array_equal(tr.split(tr.split(tk, 4)[2], 5).numpy(),
                                  _words(want))


@pytest.mark.parametrize("data", [0, 7, 2**31 + 5, WORD])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_bitwise_jax(seed, data):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(tr.fold_in(tk, data).numpy(),
                                  _words(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_is_bitwise_jax(seed, shape):
    jk, tk = _key(seed)
    got = tr.random_bits(tk, shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(),
                                  _words(jax.random.bits(jk, shape)))


def test_random_bits_over_keys_is_jax_vmap():
    """Leading key dimensions draw one block each, as vmap over keys."""
    jkeys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = jax.vmap(lambda k: jax.random.bits(k, (1, 37)))(jkeys)
    got = tr.random_bits(torch.from_numpy(_words(jkeys)), (1, 37))
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (tr.TINY, 1.0), (-1.0, 1.0)])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, -1])
def test_uniform_is_bitwise_jax(seed, shape, lo, hi):
    jk, tk = _key(seed)
    got = tr.uniform(tk, shape, lo, hi)
    want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_4_ulp(seed, shape):
    jk, tk = _key(seed)
    got = tr.gumbel(tk, shape).numpy()
    want = np.asarray(jax.random.gumbel(jk, shape))
    assert np.isfinite(got).all()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) <= 4 * ulp).all()


def top_two_gap(values: np.ndarray) -> np.ndarray:
    """Each row's largest value minus its second largest."""
    top = np.sort(values, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("shape", [(1, 64), (4, 1000), (8, 32768)])
def test_categorical_matches_jax_but_at_near_ties(shape):
    """Same draws as jax.random.categorical: a row may pick otherwise only
    where JAX's top two noisy logits lie within NEAR_TIE."""
    logits = np.random.default_rng(shape[1]).standard_normal(
        shape, dtype=np.float32)
    jk, tk = _key(shape[0])
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = tr.categorical(tk, torch.from_numpy(logits)).numpy()
    parted = got != want
    values = np.asarray(jax.random.gumbel(jk, shape)) + logits
    assert (top_two_gap(values)[parted] <= NEAR_TIE).all()
    assert parted.sum() <= 1
