"""The port's training path (tf_operator_tpu_torch/train/steps.py and the
training forward of models/transformer.py) held against the JAX package
on the CPU in f32, from the JAX init's params converted by
models/convert.py: the forward's logits, the chunked loss and its
gradients, one train step with and without the chunked loss, gradient
accumulation, and three AdamW steps on the warmup-cosine schedule, whose
updated params are read back with ``export_params``.

Tolerances: logits 1e-4 (f32 end to end, two frameworks' reduction
orders through two layers); losses 1e-5; params after AdamW 1e-5
absolute. Adam divides by sqrt(v): a gradient g moves its param by about
lr * g / (|g| + eps), so a difference dg between the frameworks moves it
by lr * dg * eps / (|g| + eps)^2, at most lr * dg / (4 eps) where |g| =
eps. With lr <= 5e-3 and dg of f32 rounding on gradients of order 1e-2
(~1e-9), that is ~1e-4 * lr at the worst |g|, and far less elsewhere;
gradients that are exactly 0 in both (unused embedding rows) move
nothing in either. One slice is the exception: the key bias, whose
gradient is 0 in exact arithmetic (it adds q.b to every score of a row,
which the softmax ignores) and so is rounding noise in both frameworks,
which Adam scales up to about lr a step in either direction. That slice
is held only to the bound 4 * (sum of the steps' lr)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
)
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.train import steps as jax_steps
from tf_operator_tpu_torch.models.convert import export_params, load_params
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from tf_operator_tpu_torch.parallel import mesh as port_mesh
from tf_operator_tpu_torch.train import steps

torch.set_num_threads(1)

LOGIT_TOL, LOSS_TOL, PARAM_TOL = 1e-4, 1e-5, 1e-5
ARCHS = {"mha": None, "gqa": 1}  # n_kv_heads (GQA: g = 4)
SEQ = 32


def _configs(arch, **extra):
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq_len=SEQ, n_kv_heads=ARCHS[arch])
    return (JaxConfig(dtype=jnp.float32, **kw),
            TransformerConfig(dtype=torch.float32, **kw, **extra))


def _init(jcfg, seed=0):
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((2, SEQ), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _batch(seed, vocab=64, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_tree_close(got, want, atol, lr_sum=0.0):
    """Every leaf within ``atol``, except the key-bias slice (see the
    module docstring), held within 4 * ``lr_sum``."""
    flat_got, flat_want = _flat(got), _flat(want)
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        g = flat_got[path].copy()
        key_bias = {"qkv": 1, "kv": 0}.get(path[-2]) if (
            path[-1] == "bias" and path[-3:-2] == ("attn",)) else None
        if key_bias is not None:
            np.testing.assert_allclose(g[key_bias], leaf[key_bias],
                                       atol=4 * lr_sum, rtol=0)
            g[key_bias] = leaf[key_bias]
        np.testing.assert_allclose(g, leaf, atol=atol, rtol=0,
                                   err_msg="/".join(path))


def _jax_step(jcfg, tx, **kw):
    mesh = create_mesh({"dp": 1}, jax.devices("cpu")[:1])
    return jax_steps.make_lm_train_step(
        JaxTransformer(replace(jcfg, mesh=mesh)), tx, mesh, seq_axis=None,
        donate=False, **kw)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_training_forward_logits_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    params = _init(jcfg)
    tokens = _batch(1)["tokens"][:, :27]  # no multiple of the kernel tile
    want = JaxTransformer(jcfg).apply({"params": params},
                                      jnp.asarray(tokens))
    model = load_params(Transformer(tcfg, device="cpu"), params)
    got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    hidden = model(torch.from_numpy(tokens), return_hidden=True)
    assert hidden.shape == (2, 27, tcfg.d_model)


def test_training_model_stores_f32_trainable_weights():
    _, tcfg = _configs("mha")
    model = Transformer(replace(tcfg, dtype=torch.bfloat16), device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    decode = Transformer(replace(tcfg, dtype=torch.bfloat16, decode=True),
                         device="cpu")
    assert all(not p.requires_grad for p in decode.parameters())
    assert decode.blocks[0].attn.qkv.kernel.dtype == torch.bfloat16
    out = model(torch.zeros((1, 8), dtype=torch.int64))
    assert out.dtype == torch.float32  # the head runs in f32
    with pytest.raises(ValueError, match="takes no cache"):
        model(torch.zeros((1, 8), dtype=torch.int64), {})
    with pytest.raises(ValueError, match="exceed max_seq_len"):
        model(torch.zeros((1, SEQ + 1), dtype=torch.int64))


@pytest.mark.parametrize("dot_dtype", [None, "bf16"])
def test_chunked_xent_matches_naive_and_jax(dot_dtype):
    """Loss and gradients of the chunked loss against the full-logits
    loss (f32 head) and against JAX's chunked_lm_xent (both heads)."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 64, 16, 97
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    kernel = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    tdot = torch.bfloat16 if dot_dtype else None
    jdot = jnp.bfloat16 if dot_dtype else None

    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (hidden, kernel, bias)]
    loss = steps.chunked_lm_xent(*leaves, torch.from_numpy(labels), chunk=16,
                                 dot_dtype=tdot)
    loss.backward()

    def jax_loss(h, k, bb):
        return jax_steps.chunked_lm_xent(h, k, bb, jnp.asarray(labels),
                                         chunk=16, dot_dtype=jdot)

    jl, jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(bias))
    np.testing.assert_allclose(loss.item(), float(jl), atol=LOSS_TOL, rtol=0)
    for leaf, want in zip(leaves, jg):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-4)

    if dot_dtype is None:
        naive = [torch.from_numpy(x).requires_grad_()
                 for x in (hidden, kernel, bias)]
        ln = steps.cross_entropy(naive[0] @ naive[1] + naive[2],
                                 torch.from_numpy(labels))
        ln.backward()
        np.testing.assert_allclose(loss.item(), ln.item(), rtol=1e-6)
        for a, c in zip(naive, leaves):
            np.testing.assert_allclose(c.grad.numpy(), a.grad.numpy(),
                                       rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        steps.chunked_lm_xent(*leaves, torch.from_numpy(labels), chunk=48)


@pytest.mark.parametrize("chunk", [None, 8])
def test_train_step_matches_jax(chunk):
    jcfg, tcfg = _configs("mha")
    params = _init(jcfg)
    batch = _batch(1)
    jtx = jax_steps.adamw(1e-3)
    jstate = jax_steps.TrainState.create(params, jtx)
    jstate, jm = _jax_step(jcfg, jtx, xent_chunk=chunk)(
        jstate, jax.tree.map(jnp.asarray, batch))

    model = load_params(Transformer(tcfg, device="cpu"), params)
    tx = steps.adamw(1e-3)
    state = steps.TrainState.create(model, tx)
    state, metrics = steps.make_lm_train_step(model, tx, xent_chunk=chunk)(
        state, batch)
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=0)
    _assert_tree_close(export_params(model), jstate.params, PARAM_TOL,
                       lr_sum=1e-3)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_three_adamw_warmup_cosine_steps_match_optax(arch):
    """Step 0 runs at lr 0 and leaves every param unchanged (optax reads
    the schedule at the count before the update); steps 1 and 2 move
    them as optax does. Loss per step and the params after three steps
    agree with the JAX step."""
    jcfg, tcfg = _configs(arch)
    params = _init(jcfg, seed=2)
    batches = [_batch(10 + i) for i in range(3)]
    jtx = jax_steps.adamw(jax_steps.warmup_cosine(5e-3, 20, warmup_steps=2))
    jstate = jax_steps.TrainState.create(params, jtx)
    jstep = _jax_step(jcfg, jtx)
    jlosses = []
    for batch in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        jlosses.append(float(jm["loss"]))

    model = load_params(Transformer(tcfg, device="cpu"), params)
    tx = steps.adamw(steps.warmup_cosine(5e-3, 20, warmup_steps=2))
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx)
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        if i == 0:
            _assert_tree_close(export_params(model), params, 0)
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    _assert_tree_close(export_params(model), jstate.params, PARAM_TOL,
                       lr_sum=sum(tx.learning_rate(i) for i in range(3)))


def test_warmup_cosine_matches_optax():
    ours = steps.warmup_cosine(1e-2, total_steps=100, warmup_steps=10)
    theirs = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-2, warmup_steps=10, decay_steps=100,
        end_value=1e-3)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6,
                                           abs=1e-12)
    default = steps.warmup_cosine(1e-2, total_steps=100)
    assert default(5) == pytest.approx(1e-2)  # warmup = 100 // 20


def test_grad_accum_matches_jax():
    jcfg, tcfg = _configs("mha")
    params = _init(jcfg, seed=3)
    batch = _batch(4, b=4)
    jtx = jax_steps.adamw(1e-3)
    jstate = jax_steps.TrainState.create(params, jtx)
    jstate, jm = _jax_step(jcfg, jtx, grad_accum=2)(
        jstate, jax.tree.map(jnp.asarray, batch))
    model = load_params(Transformer(tcfg, device="cpu"), params)
    tx = steps.adamw(1e-3)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(model, tx, grad_accum=2)
    state, metrics = step(state, batch)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=0)
    _assert_tree_close(export_params(model), jstate.params, PARAM_TOL,
                       lr_sum=1e-3)
    with pytest.raises(ValueError, match="grad_accum"):
        step(state, _batch(5, b=3))


def test_remat_gives_the_same_loss_and_grads():
    jcfg, tcfg = _configs("gqa")
    params = _init(jcfg, seed=4)
    tokens = torch.from_numpy(_batch(6)["tokens"])
    targets = torch.from_numpy(_batch(6)["targets"])
    out = []
    for remat in (False, True):
        model = load_params(
            Transformer(replace(tcfg, remat=remat), device="cpu"), params)
        loss = steps.cross_entropy(model(tokens), targets)
        loss.backward()
        out.append((loss.item(),
                    {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-7)
    for name, grad in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], grad, atol=1e-7, rtol=0,
                                   msg=name)


def test_export_params_round_trips_through_load_params():
    jcfg, tcfg = _configs("gqa")
    params = _init(jcfg, seed=5)
    model = load_params(Transformer(tcfg, device="cpu"), params)
    _assert_tree_close(export_params(model), params, 0)


def test_unported_options_raise():
    _, tcfg = _configs("mha")
    model = Transformer(tcfg, device="cpu")
    tx = steps.adamw(1e-3)
    # A data-parallel mesh is ported (A8a), and so is a tensor-parallel
    # one (A8b), over which the model itself must be built: a model of its
    # own mesh {"dp": 1, "tp": 1} trains as the plain one does.
    with pytest.raises(ValueError, match="its own mesh"):
        steps.make_lm_train_step(model, tx, mesh=port_mesh.create_mesh(
            {"dp": 1, "tp": 2}, range(2)))
    tp1 = port_mesh.create_mesh({"dp": 1, "tp": 1}, range(1))
    tp_model = load_params(Transformer(replace(tcfg, mesh=tp1),
                                       device="cpu"), export_params(model))
    _, m_tp = steps.make_lm_train_step(tp_model, tx, mesh=tp1)(
        steps.TrainState.create(tp_model, tx), _batch(0))
    _, m_plain = steps.make_lm_train_step(model, tx)(
        steps.TrainState.create(model, tx), _batch(0))
    assert float(m_tp["loss"]) == float(m_plain["loss"])
    one = steps.make_lm_train_step(model, tx, mesh=port_mesh.create_mesh(
        {"dp": 1}, range(1)))
    _, m = one(steps.TrainState.create(model, tx), _batch(0))
    assert np.isfinite(float(m["loss"]))
    # The MoE aux loss is ported: a dense model's step reports it as 0.
    _, metrics = steps.make_lm_train_step(model, tx, aux_loss_weight=0.01)(
        steps.TrainState.create(model, tx), _batch(0))
    assert float(metrics["aux_loss"]) == 0.0
    with pytest.raises(ValueError, match="decode=False"):
        steps.make_lm_train_step(
            Transformer(replace(tcfg, decode=True), device="cpu"), tx)
