"""The port's solo decode entry points (tf_operator_tpu_torch/models/
transformer.py: ``_nucleus_filter``, ``generate``, ``generate_segments``
/ ``generate_segmented``, ``ChunkedPrefill`` / ``prefill_chunked``) held
against the JAX package on the CPU in f32, on the JAX init's weights and
seeded numpy prompts:

- the nucleus masks equal JAX's, exact ties at the cutoff included;
- ``generate`` greedy, sampled and sampled with a nucleus, in MHA, GQA and
  int8_decode + kv_int8: tokens equal JAX's ``generate`` for the same
  seed. A row may part from JAX only at a near-tie: at the first step
  where it parts, JAX's top two values of gumbel + scaled logits (the
  logits, greedy) lie within NEAR_TIE, and at most one row parts;
- ``generate_segmented`` equal to greedy ``generate``, with and without
  ``prefill_chunk``;
- ``prefill_chunked``'s logits within 1e-4 of the largest |logit| of
  JAX's and its counter at the true length, for prompt lengths that
  divide the chunk and that do not; a seeded suffix prefill
  (``initial_cache``/``base_index``) against the one-shot prefill;
- JAX's eager checks and messages."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    _nucleus_filter as jax_nucleus_filter,
    _prefill as jax_prefill,
    generate as jax_generate,
    prefill_chunked as jax_prefill_chunked,
    quantize_decode_params as jax_quantize_decode_params,
)
from tf_operator_tpu_torch import random as tr
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.convert import quantize_decode_params

torch.set_num_threads(1)

KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=64)
ARCHS = {"mha": {}, "gqa": dict(n_kv_heads=2),
         "int8kv8": dict(n_kv_heads=2, int8_decode=True, kv_int8=True)}
# (temperature, top_p, seed) of the three sampling modes.
MODES = {"greedy": (0.0, None, 0), "sampled": (0.9, None, 11),
         "nucleus": (0.7, 0.8, 7)}
NEAR_TIE = 1e-4
STEPS = 20


def _setup(arch):
    """(JAX config, JAX tree, port config, port tree) of one arch."""
    flags = ARCHS[arch]
    jcfg = JaxConfig(dtype=jnp.float32, **flags, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **flags, **KW)
    params = JaxTransformer(replace(jcfg, int8_decode=False)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, params)
    if flags.get("int8_decode"):
        return (jcfg, jax_quantize_decode_params(params), tcfg,
                quantize_decode_params(tree))
    return jcfg, params, tcfg, tree


def _prompt(b, p, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, p)).astype(np.int32)


@pytest.mark.parametrize("top_p", [0.3, 0.5, 0.75, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nucleus_filter_masks_equal_jax(seed, top_p):
    """Logits on a coarse grid, so many tokens tie exactly and the cutoff
    falls inside runs of ties: the rank order must break them as JAX's
    flipped stable argsort does (later indices first)."""
    logits = np.random.default_rng(seed).integers(
        -3, 3, (4, 64)).astype(np.float32) / 2
    want = np.asarray(jax_nucleus_filter(jnp.asarray(logits), top_p))
    got = tt._nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got == -1e30, want == -1e30)
    np.testing.assert_array_equal(got, want)


def test_nucleus_filter_breaks_ties_by_rank():
    """Four equal logits at top_p 0.5 keep the two with the highest
    indices (JAX's rank order), a per-row top_p tensor included."""
    logits = torch.zeros(2, 4)
    got = tt._nucleus_filter(logits, torch.tensor([[0.5], [1.0]]))
    assert (got[0] == -1e30).tolist() == [True, True, False, False]
    assert not (got[1] == -1e30).any()


def _jax_values(jcfg, params, prompt, toks, step, temperature, top_p,
                seed, steps):
    """JAX's values at ``step`` of a run that fed ``toks``: the logits
    (greedy), else gumbel(key_step) + the scaled, filtered logits."""
    model = JaxTransformer(replace(jcfg, decode=True))
    cache, logits = jax_prefill(model, params, jnp.asarray(prompt))
    for j in range(step):
        out, upd = model.apply({"params": params, "cache": cache},
                               jnp.asarray(toks[:, j:j + 1]),
                               mutable=["cache"])
        cache, logits = upd["cache"], out[:, 0]
    if temperature <= 0:
        return np.asarray(logits)
    scaled = logits / temperature
    if top_p is not None:
        scaled = jax_nucleus_filter(scaled, top_p)
    key = jax.random.split(jax.random.PRNGKey(seed), steps)[step]
    return np.asarray(jax.random.gumbel(key, scaled.shape) + scaled)


def assert_same_or_near_tie(got, want, values_at) -> None:
    """Tokens equal, or each row that parts does so where JAX's top two
    values (``values_at(step)[row]``) lie within NEAR_TIE; at most one
    row parts."""
    parted = [r for r in range(want.shape[0])
              if not np.array_equal(got[r], want[r])]
    assert len(parted) <= 1, parted
    for r in parted:
        step = int(np.flatnonzero(got[r] != want[r])[0])
        top = np.sort(values_at(step)[r])[-2:]
        assert top[1] - top[0] <= NEAR_TIE, (r, step, top)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_generate_matches_jax(arch, mode):
    jcfg, jtree, tcfg, ttree = _setup(arch)
    temperature, top_p, seed = MODES[mode]
    prompt = _prompt(2, 7, 1)
    kw = dict(temperature=temperature, top_p=top_p) if temperature else {}
    want = np.asarray(jax_generate(
        jcfg, jtree, jnp.asarray(prompt), STEPS,
        rng=jax.random.PRNGKey(seed) if temperature else None, **kw))
    got = tt.generate(tcfg, ttree, prompt, STEPS,
                      rng=tr.PRNGKey(seed, "cpu") if temperature else None,
                      device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (2, STEPS)
    assert_same_or_near_tie(
        got.numpy(), want,
        lambda step: _jax_values(jcfg, jtree, prompt, want, step,
                                 temperature, top_p, seed, STEPS))


def test_generate_takes_a_loaded_model():
    """A decode-mode model that holds the weights serves as ``params``
    and gives the tree's tokens; a training-mode model is refused."""
    _, _, tcfg, ttree = _setup("gqa")
    prompt = _prompt(2, 6, 4)
    kw = dict(temperature=0.8, top_p=0.9, rng=tr.PRNGKey(5, "cpu"))
    model = tt._decode_model(tcfg, ttree, "cpu")
    assert tt._decode_model(tcfg, model, None) is model
    np.testing.assert_array_equal(
        tt.generate(tcfg, model, prompt, 8, **kw).numpy(),
        tt.generate(tcfg, ttree, prompt, 8, device="cpu", **kw).numpy())
    with pytest.raises(ValueError, match="training-mode"):
        tt.generate(tcfg, tt.Transformer(tcfg, device="cpu"), prompt, 2)


def test_near_tie_rule_rejects_a_real_parting():
    """The rule's own check: a parting where JAX's margin is wide
    fails."""
    want = np.zeros((2, 3), np.int32)
    got = want.copy()
    got[1, 1] = 5
    with pytest.raises(AssertionError):
        assert_same_or_near_tie(got, want,
                                lambda step: np.array([[0.0, 1.0]] * 2))
    assert_same_or_near_tie(got, want,
                            lambda step: np.array([[1.0, 1.0]] * 2))


@pytest.mark.parametrize("prefill_chunk", [None, 3])
@pytest.mark.parametrize("steps,segment", [(12, 4), (10, 4), (3, 8), (7, 7)])
def test_generate_segmented_equals_greedy_generate(steps, segment,
                                                   prefill_chunk):
    jcfg, jtree, tcfg, ttree = _setup("gqa")
    prompt = _prompt(2, 5, 1)
    seen = []
    got = tt.generate_segmented(tcfg, ttree, prompt, steps, segment=segment,
                                prefill_chunk=prefill_chunk,
                                on_segment=seen.append, device="cpu")
    want = tt.generate(tcfg, ttree, prompt, steps, device="cpu").numpy()
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, np.asarray(jax_generate(jcfg, jtree, jnp.asarray(prompt),
                                      steps)))
    assert [s.shape[1] for s in seen] == [
        min(segment, steps - i) for i in range(0, steps, segment)]


def test_generate_segments_yields_host_arrays_lazily():
    _, _, tcfg, ttree = _setup("mha")
    gen = tt.generate_segments(tcfg, ttree, _prompt(1, 4, 2), 5, segment=2,
                               device="cpu")
    parts = list(gen)
    assert [p.shape for p in parts] == [(1, 2), (1, 2), (1, 1)]
    assert all(isinstance(p, np.ndarray) for p in parts)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("p,chunk", [(8, 4), (11, 4), (1, 4), (5, 8)])
def test_prefill_chunked_matches_jax(arch, p, chunk):
    jcfg, jtree, tcfg, ttree = _setup(arch)
    prompt = _prompt(2, p, p)
    _, jlogits = jax_prefill_chunked(jcfg, jtree, jnp.asarray(prompt),
                                     chunk=chunk)
    cache, logits = tt.prefill_chunked(tcfg, ttree, prompt, chunk=chunk,
                                       device="cpu")
    want = np.asarray(jlogits)
    assert cache["cache_index"] == p
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_seeded_suffix_prefill_equals_one_shot():
    """A suffix fed in chunks onto a cache that holds the prefix's rows
    (counter at base) lands the one-shot prefill's logits and counter."""
    _, _, tcfg, ttree = _setup("gqa")
    model = tt._decode_model(tcfg, ttree, "cpu")
    prompt = torch.from_numpy(_prompt(1, 13, 3))
    _, want = tt._prefill(model, prompt)
    seed, _ = tt._prefill(model, prompt[:, :8])
    pf = tt.ChunkedPrefill(model, prompt[:, 8:], 3, initial_cache=seed,
                           base_index=8)
    assert pf.n_chunks == 2 and not pf.done
    with pytest.raises(RuntimeError, match="not finished"):
        pf.result()
    assert pf.feed() == 3 and pf.feed(5) == 3 and pf.done
    cache, logits = pf.result()
    assert cache["cache_index"] == 13
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_checks_match_jax():
    _, _, tcfg, ttree = _setup("mha")
    prompt = _prompt(1, 60, 0)
    key = tr.PRNGKey(0, "cpu")
    cases = [
        (dict(num_steps=5), "exceeds max_seq_len"),
        (dict(num_steps=2, temperature=0.5), "needs an rng key"),
        (dict(num_steps=2, temperature=0.5, rng=key, top_p=0.0),
         r"must be in \(0, 1\]"),
        (dict(num_steps=2, top_p=0.5), "requires temperature > 0"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tt.generate(tcfg, ttree, prompt, device="cpu", **kw)
    # generate_segments checks before it returns its generator.
    with pytest.raises(ValueError, match="segment=0"):
        tt.generate_segments(tcfg, ttree, prompt, 2, segment=0)
    with pytest.raises(ValueError, match="segments of"):
        tt.generate_segments(tcfg, ttree, prompt, 5, segment=4)
    with pytest.raises(ValueError, match="right-padded"):
        tt.generate_segments(tcfg, ttree, _prompt(1, 62, 0), 1, segment=1,
                             prefill_chunk=5)
    with pytest.raises(ValueError, match="chunk=0"):
        tt.prefill_chunked(tcfg, ttree, prompt, chunk=0)
