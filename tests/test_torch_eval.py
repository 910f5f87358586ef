"""The port's LM eval (tf_operator_tpu_torch/train/steps.py:
chunked_lm_xent_sums, make_lm_eval_step, evaluate_lm, _iter_padded) held
against the JAX package's on the CPU in f32, from the JAX init's params:
the masked sums of the chunked loss, the mean loss and perplexity over
uneven batches (tests/test_training.py's lm-eval case: 4 + 4 + 0 + 3
rows, the tail padded) and with a fractional per-token mask, the errors
of an empty stream and of a batch past ``pad_to``, and the chunk a prime
sequence length gets.

Tolerances: loss sums 1e-4 relative (f32 sums over up to 1000 tokens in
two orders), mean losses 1e-5 absolute (the train tests' LOSS_TOL), the
perplexity 1e-5 relative; token counts and weights exact."""

import logging
import math
from dataclasses import replace

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
from tf_operator_tpu.train import steps as jax_steps
from tf_operator_tpu_torch.models.convert import load_params
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.parallel import mesh as port_mesh
from tf_operator_tpu_torch.train import steps

torch.set_num_threads(1)

LOSS_TOL, SUM_RTOL, PPL_RTOL = 1e-5, 1e-4, 1e-5
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=32)


def _setup(**over):
    kw = dict(KW, **over)
    jcfg = JaxConfig(dtype=jnp.float32, **kw)
    params = jax.tree.map(np.asarray, JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, **kw),
                    device="cpu"), params)
    state = steps.TrainState.create(model, steps.adamw(1e-3))
    jstate = jax_steps.TrainState.create(params, jax_steps.adamw(1e-3))
    return jcfg, model, state, jstate


def _jax_eval(jcfg, jstate, batches, **kw):
    mesh = create_mesh({"dp": 1}, jax.devices("cpu")[:1])
    step = jax_steps.make_lm_eval_step(JaxTransformer(jcfg), mesh, **kw)
    return jax_steps.evaluate_lm(step, jstate, batches)


@pytest.mark.parametrize("dot_dtype", [None, "bf16"])
def test_chunked_xent_sums_match_jax(dot_dtype):
    rng = np.random.default_rng(3)
    b, s, d, v = 3, 24, 16, 97
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    kernel = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.choice([0.0, 0.25, 1.0], size=(b, s)).astype(np.float32)
    mask[2] = 0.0  # a padded row
    jdt = None if dot_dtype is None else jnp.bfloat16
    tdt = None if dot_dtype is None else torch.bfloat16
    for b_np in (bias, None):
        want_sum, want_count = jax_steps.chunked_lm_xent_sums(
            jnp.asarray(hidden), jnp.asarray(kernel),
            None if b_np is None else jnp.asarray(b_np), jnp.asarray(labels),
            jnp.asarray(mask), chunk=8, dot_dtype=jdt)
        got_sum, got_count = steps.chunked_lm_xent_sums(
            torch.from_numpy(hidden), torch.from_numpy(kernel),
            None if b_np is None else torch.from_numpy(b_np),
            torch.from_numpy(labels), torch.from_numpy(mask), chunk=8,
            dot_dtype=tdt)
        assert got_sum.dtype == torch.float32
        assert got_count.dtype == torch.int32
        assert got_count.item() == int(want_count) == int((mask > 0).sum())
        np.testing.assert_allclose(got_sum.item(), float(want_sum),
                                   rtol=SUM_RTOL)
    with pytest.raises(ValueError, match="not divisible"):
        steps.chunked_lm_xent_sums(
            torch.from_numpy(hidden), torch.from_numpy(kernel), None,
            torch.from_numpy(labels), torch.from_numpy(mask), chunk=7)


def _uneven(seed=0, seq=24, fractional=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 64, (11, seq)).astype(np.int32)
    targs = rng.integers(0, 64, (11, seq)).astype(np.int32)
    cuts = [(0, 4), (4, 8), (8, 8), (8, 11)]
    batches = [{"tokens": toks[a:b], "targets": targs[a:b]} for a, b in cuts]
    if fractional:
        for batch in batches:
            batch["mask"] = rng.choice(
                [0.0, 0.5, 1.0], size=batch["tokens"].shape
            ).astype(np.float32)
    return batches


@pytest.mark.parametrize("fractional", [False, True])
def test_evaluate_lm_matches_jax_over_uneven_batches(fractional):
    jcfg, model, state, jstate = _setup()
    batches = _uneven(fractional=fractional)
    want = _jax_eval(jcfg, jstate, batches, xent_chunk=8)
    step = steps.make_lm_eval_step(model, xent_chunk=8)
    got = steps.evaluate_lm(step, state, batches)
    assert got["tokens"] == want["tokens"]
    if not fractional:
        assert got["tokens"] == 11 * 24
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=PPL_RTOL)
    assert got["perplexity"] == pytest.approx(math.exp(got["loss"]))
    assert all(p.grad is None for p in model.parameters())


def test_evaluate_lm_equals_the_naive_full_logits_mean():
    jcfg, model, state, _ = _setup()
    batches = _uneven(seed=1)
    toks = np.concatenate([b["tokens"] for b in batches])
    targs = np.concatenate([b["targets"] for b in batches])
    with torch.no_grad():
        want = steps.cross_entropy(model(torch.from_numpy(toks)),
                                   torch.from_numpy(targs)).item()
    got = steps.evaluate_lm(steps.make_lm_eval_step(model, xent_chunk=6),
                            state, batches)
    np.testing.assert_allclose(got["loss"], want, atol=LOSS_TOL, rtol=0)


def test_empty_stream_and_pad_to_errors_match_jax():
    jcfg, model, state, jstate = _setup()
    step = steps.make_lm_eval_step(model, xent_chunk=8)
    empty = [{"tokens": np.zeros((0, 8), np.int32),
              "targets": np.zeros((0, 8), np.int32)}]
    for run in (lambda b, **kw: steps.evaluate_lm(step, state, b, **kw),
                lambda b, **kw: _jax_eval(jcfg, jstate, b, xent_chunk=8,
                                          **kw)):
        with pytest.raises(ValueError, match="got no non-empty batches"):
            run(empty)
        with pytest.raises(ValueError, match="got no non-empty batches"):
            run([])
    grow = _uneven()[:1] + [{"tokens": np.zeros((5, 24), np.int32),
                             "targets": np.zeros((5, 24), np.int32)}]
    with pytest.raises(ValueError, match="exceeds pad_to=4"):
        steps.evaluate_lm(step, state, grow)
    mesh = create_mesh({"dp": 1}, jax.devices("cpu")[:1])
    jstep = jax_steps.make_lm_eval_step(JaxTransformer(jcfg), mesh,
                                        xent_chunk=8)
    with pytest.raises(ValueError, match="exceeds pad_to=4"):
        jax_steps.evaluate_lm(jstep, jstate, grow)
    # An explicit pad_to takes the larger batch.
    out = steps.evaluate_lm(step, state, grow, pad_to=5)
    assert out["tokens"] == 9 * 24


def _jax_chunk(seq, xent_chunk):
    """JAX's make_lm_eval_step chunk (tf_operator_tpu/train/steps.py)."""
    return next(c for c in range(min(xent_chunk, seq), 0, -1)
                if seq % c == 0)


@pytest.mark.parametrize("seq,xent_chunk", [(13, 8), (13, 512), (24, 8),
                                            (30, 7), (31, 512)])
def test_eval_chunk_is_jaxs(seq, xent_chunk):
    assert steps.eval_chunk(seq, xent_chunk) == _jax_chunk(seq, xent_chunk)


def test_prime_sequence_evaluates_and_warns_once(caplog):
    jcfg, model, state, jstate = _setup()
    batches = _uneven(seed=2, seq=13)
    step = steps.make_lm_eval_step(model, xent_chunk=8)
    with caplog.at_level(logging.WARNING):
        got = steps.evaluate_lm(step, state, batches)
    warned = [r for r in caplog.records if "no divisor" in r.getMessage()]
    assert len(warned) == 1  # once for the length, as JAX traces once
    assert "seq 13" in warned[0].getMessage()
    want = _jax_eval(jcfg, jstate, batches, xent_chunk=8)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_TOL,
                               rtol=0)


def test_eval_runs_the_flash_forward_only(monkeypatch):
    """At a head dim the kernels take (32) the eval goes through the flash
    path: one forward a layer and batch, never dQ or dK/dV (on the card:
    B1 launches and no B2/B3)."""
    jcfg, model, state, jstate = _setup(d_model=128, d_ff=256)
    calls = {"fwd": 0}
    fwd = fa.flash_fwd

    def counted(*args):
        calls["fwd"] += 1
        return fwd(*args)

    def never(*args):
        raise AssertionError("the eval ran a backward kernel")

    monkeypatch.setattr(fa, "flash_fwd", counted)
    monkeypatch.setattr(fa, "flash_dq", never)
    monkeypatch.setattr(fa, "flash_dkv", never)
    batches = _uneven(seed=3)
    got = steps.evaluate_lm(steps.make_lm_eval_step(model, xent_chunk=8),
                            state, batches)
    assert calls["fwd"] == KW["n_layers"] * 3  # 3 non-empty batches
    want = _jax_eval(jcfg, jstate, batches, xent_chunk=8)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_TOL,
                               rtol=0)


def test_unported_options_raise():
    _, model, state, _ = _setup()
    # A data-parallel mesh is ported (A8a) and so is sequence parallelism
    # (A8c); a pipeline mesh trains through train/pp_lm.py (A8d), which
    # the eval step names.
    with pytest.raises(ValueError, match="make_pp_lm_train_step"):
        steps.make_lm_eval_step(model, mesh=port_mesh.create_mesh(
            {"dp": 1, "pp": 2}, range(2)))
    assert steps.make_lm_eval_step(model, mesh=port_mesh.create_mesh(
        {"dp": 1}, range(1))).shard_count == 1
    decode = Transformer(replace(model.cfg, decode=True), device="cpu")
    with pytest.raises(ValueError, match="decode=False"):
        steps.make_lm_eval_step(decode)
    other = _setup()[1]
    step = steps.make_lm_eval_step(other)
    with pytest.raises(ValueError, match="another model"):
        steps.evaluate_lm(step, state, _uneven())
