"""The port's Mixture-of-Experts (tf_operator_tpu_torch/models/moe.py and
the MoE blocks of models/transformer.py) on the CPU in f32, held against
the JAX package on the same numpy-seeded inputs and the JAX init's
weights:

- ``top_k_dispatch`` for k = 1, 2, 3 at a capacity that drops choices and
  one that does not: dispatch, combine and first-choice tensors bitwise
  JAX's, on router probabilities with exact ties.
- The router breaks exact ties toward the lower expert, as ``lax.top_k``.
- ``MoeMlp``, Switch and top-2, at capacity factors 0.01, 1.25 and 2.0,
  with an explicit and an automatic group size: output and aux by
  tf_operator_tpu_torch/testing.py's rule (rtol 1e-5, atol 1e-4 of the
  row's rms: the same products summed in another order), the gradients
  of ``out.sum() + 0.01 aux`` leaf by leaf within 1e-4 of each leaf's
  largest magnitude (``LEAF_RTOL``, tests/test_torch_classifier.py's
  rule). The ``MoeBlock`` likewise.
- The MoE Transformer (``moe_every_n=2``, 4 experts, top-2, 4 layers):
  logits and aux; 3 AdamW steps with ``aux_loss_weight=0.01`` (plain,
  ``grad_accum=2``, ``remat``): loss and ``aux_loss`` within 1e-5 at
  every step, every leaf within ``LEAF_RTOL`` after the third (the key
  bias by tests/test_torch_train.py's noise bound); the remat losses and
  aux equal to the plain ones.
- Decode over an MoE tree: the paged engine's greedy tokens and
  ``kv_debug`` equal JAX's engine; an ``int8_decode + kv_int8`` model's
  logits within ``INT8_LOGIT_RTOL`` of the largest of JAX's,
  teacher-forced over a prefill and 6 steps; the MoE leaves pass
  ``quantize_decode_params`` unquantized, equal to JAX's.
- ``param_shapes``/``init_params`` cover the MoE leaves with flax's
  fan-in."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import moe as jmoe
from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    quantize_decode_params as jax_quantize_decode_params,
)
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu.train import steps as jsteps
from tf_operator_tpu_torch.models import moe
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.convert import (
    export_params,
    init_params,
    load_params,
    param_shapes,
    quantize_decode_params,
)
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.testing import excess
from tf_operator_tpu_torch.train import steps
from test_torch_engine import BLK, SLOTS, _schedule

torch.set_num_threads(1)

OUT_TOL = (1e-5, 1e-4)
LEAF_RTOL = 1e-4
LOSS_TOL = 1e-5
LR = 5e-3
# Adam moves an element whose gradient g is near its eps (1e-8) by about
# lr * g / (|g| + eps), so a rounding difference dg of the gradient moves
# it by up to lr * dg / (4 eps). The expert kernels hold such elements
# (an expert's few token rows cancel): a gradient rounding ~1e-6 of the
# leaf's largest (~1e-10 there) moved one w_in element by 0.016 lr after
# the first step. Leaves after steps get this much of the steps' summed
# lr on top of LEAF_RTOL.
ADAM_NOISE = 0.05
# An Int8Dense rounds its input to bf16; the MoE layer's f32 output,
# summed in another order than JAX's einsum, can land one bf16 step away
# there, which moves a logit by up to 2^-7 of the logits' scale
# (testing.py's INT8_TOL for bf16).
INT8_LOGIT_RTOL = 2.0 ** -7
D, F_, E = 16, 32, 4
MOE = dict(moe_every_n=2, moe_experts=4, moe_top_k=2)
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
          max_seq_len=64)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _tied_probs(g, s, seed):
    """Router probabilities with many exact ties: each row a few integer
    counts normalised (k-th and (k+1)-th values often equal)."""
    raw = np.random.default_rng(seed).integers(1, 4, (g, s, E))
    return (raw / raw.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("capacity", ["drops", "fits"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_dispatch_is_bitwise_jax(k, capacity):
    probs = jnp.asarray(_tied_probs(3, 16, seed=k))
    top_vals, top_idx = jax.lax.top_k(probs, k)
    gates = top_vals if k == 1 else top_vals / jnp.maximum(
        top_vals.sum(-1, keepdims=True), 1e-9)
    cap = 2 if capacity == "drops" else 16 * k
    want = jmoe.top_k_dispatch(top_idx, gates, E, cap)
    got = moe.top_k_dispatch(torch.tensor(np.asarray(top_idx)),
                             torch.tensor(np.asarray(gates)), E, cap)
    for name, g, w in zip(("dispatch", "combine", "first"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=name)
    # Every expert of a group takes exactly min(assignments, capacity).
    counts = np.stack([(np.asarray(top_idx) == e).sum((1, 2))
                       for e in range(E)])
    kept = float(np.asarray(want[0]).sum())
    assert kept == np.minimum(counts, cap).sum()
    assert (kept < 3 * 16 * k) == (capacity == "drops")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_ties_break_toward_the_lower_expert(k):
    """Exact ties in the router's probabilities (a zero router: every
    probability 1/E; then two equal columns) order as ``lax.top_k``
    orders them."""
    cfg = moe.MoeConfig(n_experts=E, d_model=D, d_ff=F_, router_top_k=k,
                        dtype=torch.float32)
    m = moe.MoeMlp(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, D)).astype(np.float32))
    with torch.no_grad():
        m.router.zero_()
        top_idx, _, probs, _ = m.route(x)
        assert (top_idx == torch.arange(k)).all()
        col = torch.from_numpy(np.random.default_rng(1).standard_normal(
            D).astype(np.float32))
        m.router[:, 1] = col
        m.router[:, 3] = col
        top_idx, _, probs, _ = m.route(x)
    assert (probs[..., 1] == probs[..., 3]).all()
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), k)[1])
    np.testing.assert_array_equal(top_idx.numpy(), want)


def _assert_leaves_close(got: dict, want: dict, rtol=LEAF_RTOL,
                         lr_sum=0.0):
    """Every leaf within ``rtol`` of its largest magnitude, plus after
    optimiser steps ``ADAM_NOISE * lr_sum``; the key bias is held to 4 *
    ``lr_sum`` (tests/test_torch_train.py's rule): its gradient is 0 in
    exact arithmetic (a softmax ignores a shift of a row's scores), so it
    is rounding noise that Adam scales up to about lr a step."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        w, g = np.array(w), np.array(got[path])
        if lr_sum and path[-3:] == ("attn", "qkv", "bias"):
            assert np.abs(g[1] - w[1]).max() <= 4 * lr_sum, path
            g[1] = w[1]
        err = np.abs(g - w).max()
        bound = rtol * np.abs(w).max() + ADAM_NOISE * lr_sum
        assert err <= bound, (path, err, bound)


def _flat(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def _jax_moe_grads(jcfg, params, x, block=False):
    """(out, aux, grads of out.sum() + 0.01 aux over params and x)."""
    mod = jmoe.MoeBlock(jcfg) if block else jmoe.MoeMlp(jcfg)

    def f(p, xx):
        y, col = mod.apply({"params": p}, xx, mutable=["losses"])
        return y.sum() + 0.01 * jmoe.aux_loss_from(col), (
            y, jmoe.aux_loss_from(col))

    (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(params, x)
    return np.asarray(y), float(aux), grads


@pytest.mark.parametrize("group", [None, 4], ids=["auto", "group4"])
@pytest.mark.parametrize("cf", [0.01, 1.25, 2.0])
@pytest.mark.parametrize("k", [1, 2], ids=["switch", "top2"])
def test_moe_mlp_matches_jax(k, cf, group):
    jcfg = jmoe.MoeConfig(n_experts=E, d_model=D, d_ff=F_,
                          capacity_factor=cf, router_top_k=k,
                          group_size=group, dtype=jnp.float32)
    x = np.random.default_rng(k).standard_normal((2, 16, D)).astype(
        np.float32)
    params = jmoe.MoeMlp(jcfg).init(jax.random.PRNGKey(k), x)["params"]
    y, aux, (gp, gx) = _jax_moe_grads(jcfg, params, jnp.asarray(x))

    m = moe.MoeMlp(moe.MoeConfig(
        n_experts=E, d_model=D, d_ff=F_, capacity_factor=cf,
        router_top_k=k, group_size=group, dtype=torch.float32),
        device="cpu")
    with torch.no_grad():
        for name in ("router", "w_in", "w_out"):
            getattr(m, name).copy_(torch.tensor(np.asarray(params[name])))
    xt = torch.from_numpy(x).requires_grad_()
    out, got_aux = m(xt)
    (out.sum() + 0.01 * got_aux).backward()
    assert excess(out.detach(), torch.tensor(y), *OUT_TOL) <= 1
    assert abs(got_aux.item() - aux) <= LOSS_TOL * abs(aux)
    _assert_leaves_close(
        {n: getattr(m, n).grad.numpy() for n in ("router", "w_in", "w_out")}
        | {"x": xt.grad.numpy()},
        {n: gp[n] for n in ("router", "w_in", "w_out")} | {"x": gx})
    top_idx, _, _, cap = m.route(xt.detach())
    _, keep, _ = moe._positions(top_idx, E, cap)
    if cf == 0.01:
        assert cap == 1 and not keep.all()  # choices were dropped


def test_moe_block_and_aux_loss_from_match_jax():
    jcfg = jmoe.MoeConfig(n_experts=E, d_model=D, d_ff=F_, router_top_k=2,
                          dtype=jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 8, D)).astype(
        np.float32)
    params = jmoe.MoeBlock(jcfg).init(jax.random.PRNGKey(5), x)["params"]
    y, aux, (gp, _) = _jax_moe_grads(jcfg, params, jnp.asarray(x),
                                     block=True)
    blk = moe.MoeBlock(moe.MoeConfig(n_experts=E, d_model=D, d_ff=F_,
                                     router_top_k=2, dtype=torch.float32),
                       device="cpu")
    with torch.no_grad():
        blk.norm.scale.copy_(torch.tensor(
            np.asarray(params["RMSNorm_0"]["scale"])))
        for name in ("router", "w_in", "w_out"):
            getattr(blk.moe, name).copy_(torch.tensor(
                np.asarray(params["moe"][name])))
    out, got_aux = blk(torch.from_numpy(x))
    (out.sum() + 0.01 * got_aux).backward()
    assert excess(out.detach(), torch.tensor(y), *OUT_TOL) <= 1
    assert abs(got_aux.item() - aux) <= LOSS_TOL * abs(aux)
    _assert_leaves_close(
        {n: getattr(blk.moe, n).grad.numpy()
         for n in ("router", "w_in", "w_out")},
        {n: gp["moe"][n] for n in ("router", "w_in", "w_out")})
    assert float(moe.aux_loss_from([None, None])) == 0.0
    assert float(moe.aux_loss_from([torch.tensor(1.5), None,
                                    torch.tensor(2.0)])) == 3.5
    with pytest.raises(ValueError, match="router_top_k"):
        moe.MoeConfig(n_experts=4, router_top_k=5)


def _jax_tree(cfg_kw, seed=0, **extra):
    jcfg = JaxConfig(dtype=jnp.float32, **cfg_kw, **extra)
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params


def test_param_shapes_and_init_cover_the_moe_leaves():
    jcfg, params = _jax_tree(KW, **MOE)
    cfg = tt.TransformerConfig(dtype=torch.float32, **KW, **MOE)
    want = {p: tuple(v.shape) for p, v in _flat(
        jax.tree.map(np.asarray, params)).items()}
    assert param_shapes(cfg) == want
    assert ("block_1", "moe", "w_in") in want
    assert ("block_1", "mlp", "in_proj", "kernel") not in want
    big = replace(cfg, d_model=256, d_ff=512, moe_experts=8, n_layers=2,
                  moe_every_n=1, vocab_size=8, max_seq_len=8)
    tree = init_params(big, 0)["block_0"]["moe"]
    # flax's lecun_normal on a 3-D kernel counts every axis but the last.
    for name, fan_in in (("router", 256), ("w_in", 256 * 8),
                         ("w_out", 512 * 8)):
        std = float(tree[name].std())
        assert abs(std * np.sqrt(fan_in) - 1) < 0.02, (name, std)


def test_moe_transformer_logits_and_aux_match_jax():
    jcfg, params = _jax_tree(KW, seed=2, **MOE)
    toks = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(
        np.int32)
    logits, col = JaxTransformer(jcfg).apply({"params": params}, toks,
                                             mutable=["losses"])
    model = load_params(tt.Transformer(tt.TransformerConfig(
        dtype=torch.float32, **KW, **MOE), "cpu"),
        jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks), return_aux=True)
        dense = model(torch.from_numpy(toks))
    assert excess(got, torch.tensor(np.asarray(logits)), *OUT_TOL) <= 1
    want = float(jmoe.aux_loss_from(col))
    assert abs(float(aux) - want) <= LOSS_TOL * want
    assert torch.equal(dense, got)


def _batch(seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    chain = (rng.integers(0, 64, (b, 1)) + np.arange(s + 1)) % 64
    return {"tokens": chain[:, :-1].astype(np.int32),
            "targets": chain[:, 1:].astype(np.int32)}


def _port_steps(params, n, **kw):
    """The port's MoE model after ``n`` AdamW steps with aux 0.01 ->
    (tree, losses, auxes)."""
    remat = kw.pop("remat", False)
    model = load_params(tt.Transformer(tt.TransformerConfig(
        dtype=torch.float32, remat=remat, **KW, **MOE), "cpu"),
        jax.tree.map(np.asarray, params))
    tx = steps.adamw(LR)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx, aux_loss_weight=0.01, **kw)
    losses, auxes = [], []
    for i in range(n):
        state, m = step(state, _batch(i))
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux_loss"]))
    return export_params(model), losses, auxes


@pytest.mark.parametrize("mode", ["plain", "grad_accum2", "remat"])
def test_moe_train_steps_match_jax(mode):
    kw = {"grad_accum": 2} if mode == "grad_accum2" else {}
    remat = mode == "remat"
    jcfg, params = _jax_tree(KW, seed=3, remat=remat, **MOE)
    mesh = create_mesh({"dp": 1}, jax.devices()[:1])
    tx = jsteps.adamw(LR)
    state = jsteps.TrainState.create(params, tx)
    step = jsteps.make_lm_train_step(
        JaxTransformer(jcfg), tx, mesh, seq_axis=None, donate=False,
        aux_loss_weight=0.01, **kw)
    want_loss, want_aux = [], []
    for i in range(3):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in _batch(i).items()})
        want_loss.append(float(m["loss"]))
        want_aux.append(float(m["aux_loss"]))
    tree, losses, auxes = _port_steps(params, 3, remat=remat, **kw)
    np.testing.assert_allclose(losses, want_loss, rtol=LOSS_TOL)
    np.testing.assert_allclose(auxes, want_aux, rtol=LOSS_TOL)
    _assert_leaves_close(_flat(tree), _flat(jax.tree.map(np.asarray,
                                                         state.params)),
                         lr_sum=3 * LR)
    if remat:
        # Counted once: the checkpointed blocks return their aux.
        _, plain_losses, plain_auxes = _port_steps(params, 3)
        assert auxes == plain_auxes and losses == plain_losses


def test_dense_model_reports_a_zero_aux_loss():
    cfg = tt.TransformerConfig(dtype=torch.float32, **KW)
    model = load_params(tt.Transformer(cfg, "cpu"), init_params(cfg, 0))
    tx = steps.adamw(1e-3)
    step = steps.make_lm_train_step(model, tx, aux_loss_weight=0.01)
    _, m = step(steps.TrainState.create(model, tx), _batch(0))
    assert float(m["aux_loss"]) == 0.0


def test_moe_engine_matches_jax_engine():
    """JAX's engine serves an MoE tree; the port's gives its tokens and
    block accounting (each decode token routes alone, capacity 1)."""
    kw = dict(KW, n_heads=4, n_kv_heads=2)
    jcfg, params = _jax_tree(kw, **MOE)
    want = _schedule(JaxEngine(jcfg, params, max_slots=SLOTS,
                               kv_paged=True, kv_block=BLK))
    for attend in ("gather", "kernel"):
        got = _schedule(ContinuousEngine(
            tt.TransformerConfig(dtype=torch.float32, **kw, **MOE),
            jax.tree.map(np.asarray, params), SLOTS, kv_block=BLK,
            kv_attend=attend, device="cpu"))
        assert got == want, attend


def test_int8_kv8_moe_logits_teacher_forced_match_jax():
    mode = dict(int8_decode=True, kv_int8=True, decode=True)
    jcfg, params = _jax_tree(KW, seed=4, **MOE)
    jcfg = replace(jcfg, **mode)
    jtree = jax_quantize_decode_params(params)
    ttree = quantize_decode_params(jax.tree.map(np.asarray, params))
    for path, leaf in _flat(ttree).items():
        if "moe" in path:  # passed through, unquantized
            np.testing.assert_array_equal(
                leaf, np.asarray(_flat(jax.tree.map(np.asarray, jtree))[path]))
    model = load_params(tt.Transformer(tt.TransformerConfig(
        dtype=torch.float32, **KW, **MOE, **mode), "cpu"), ttree)
    assert model.blocks[1].moe.w_in.dtype == torch.float32
    assert model.blocks[1].moe.router.dtype == torch.float32
    jmodel = JaxTransformer(jcfg)
    prompt = np.random.default_rng(4).integers(0, 64, (2, 11)).astype(
        np.int32)
    jcache = jmodel.init(jax.random.PRNGKey(0), prompt[:, :1])["cache"]
    cache = model.init_cache(2, paged=False)
    feed = prompt
    with torch.no_grad():
        for _ in range(7):
            want, upd = jmodel.apply({"params": jtree, "cache": jcache},
                                     jnp.asarray(feed), mutable=["cache"])
            jcache = upd["cache"]
            got = model(torch.from_numpy(feed), cache)
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=INT8_LOGIT_RTOL * np.abs(want).max())
            feed = want[:, -1].argmax(-1)[:, None].astype(np.int32)
    with pytest.raises(ValueError, match="return_aux"):
        model(torch.from_numpy(feed), cache, return_aux=True)
