"""Sequence-parallel training (tf_operator_tpu_torch/parallel/ring_attention.py,
parallel/ulysses.py, the model, the steps and ``dist_lm --sp``) held
against JAX on the CPU. The port's sp world is N gloo processes; JAX's is
one process over a mesh of the conftest's virtual CPU devices. One spawn
of 2 ranks and one of 4 run every cell (``world_results``); each rank runs
one thread, and at most 4 ranks run at once.

- The functions, at JAX's own test shapes (tests/test_parallel.py:
  ``[2, 32, 4, 16]`` forward, ``[2, 16, 2, 8]`` gradients, ``[2, 16, 4,
  8]`` for Ulysses, whose heads must tile sp): ``ring_attention`` causal,
  full and with ``kv_chunk`` 4, ``ring_flash_attention`` causal and full,
  ``ulysses_attention`` causal, each rank on its block (rows by dp,
  sequence by sp, heads by tp) against JAX's function on the same mesh,
  ``{"sp": 2}``, ``{"sp": 4}`` (a ring of three hops, future blocks
  skipped), ``{"dp": 2, "sp": 2}`` and ``{"sp": 2, "tp": 2}``: the
  forward and the gradients of q, k and v (of the output weighted by a
  seeded cotangent) within ``FUNC_TOL`` 1e-5 max-abs, JAX's own bound. The
  flash ring is held against JAX's XLA blocks (``use_kernel=False``) and,
  where the per-device blocks tile (sp 2), its interpret-mode kernel
  blocks (``use_kernel=True``). The refusals in
  JAX's words: ``kv_chunk`` not dividing, causal ``tq != tk``, heads not
  dividing sp.
- The step: 3 AdamW steps in f32 at tests/test_torch_tp_train.py's model
  (2 layers, d 64, 4 heads, random biases) against JAX's
  ``make_lm_train_step`` on the same mesh from the same tree, with that
  file's ``LOSS_TOL`` (1e-5 relative), ``LEAF_RTOL`` and ``GRAD_RTOL``/
  ``GRAD_ATOL``; an element whose first-step gradient that check cannot
  tell from 0 is held by the key bias's rule (4 x the summed lr: Adam
  scales a noise-level gradient to about lr a step, so the two sides'
  rounding noise moves it by up to that). Cells (``STEP_CELLS``): sp 2
  with ``ring_impl`` auto,
  flash and ulysses; sp 2 without ``xent_chunk``; GQA KV 1; ``remat``;
  ``grad_accum`` 2; one MoE block (its routing group of 16 tokens spans
  both ranks' blocks: the ranks gather it); dp 2 x sp 2; sp 2 x tp 2 with
  flash and with ulysses. Every rank reports the same losses and the same
  gathered tree.
- Eval under dp 2 x sp 2 with a ragged tail against JAX's ``evaluate_lm``
  on the same mesh: tokens exact, the loss within ``LOSS_TOL``.
- ``dist_lm --sp 2 --device cpu``: killed with ``--fail-at-step``, its
  resume ends bitwise on an uninterrupted twin's final checkpoint, which
  restores at sp 1 (a plain model, bitwise); ``--sp 2 --tp 2`` (4
  processes) and ``--sp 2 --ring-impl ulysses`` print JAX's mesh line and
  their printed losses follow JAX's example within ``ENTRY_TOL`` (3e-4);
  JAX's usage errors for ``--ring-impl`` without ``--sp``, a seq that sp
  does not divide and ``--data`` beside ``--sp``.
"""

import types

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
from test_torch_tp_train import (
    BATCH,
    ENTRY_TOL,
    GRAD_ATOL,
    GRAD_RTOL,
    LM_KW,
    LR,
    SEQ,
    VOCAB,
    _gqa_key_bias,
    _jax_mesh,
    _log,
    _printed,
    _start,
    _tree,
    _wait,
    _whole,
    lm_batches,
    seeded_tree,
)

torch.set_num_threads(1)

FUNC_TOL = 1e-5
SP2, SP4 = {"sp": 2}, {"sp": 4}
DP2SP2, SP2TP2 = {"dp": 2, "sp": 2}, {"sp": 2, "tp": 2}
FUNC_MESHES = {"sp2": SP2, "sp4": SP4, "dp2sp2": DP2SP2, "sp2tp2": SP2TP2}
# impl -> (function, causal, kv_chunk)
IMPLS = {
    "stream-causal": ("ring", True, None),
    "stream-full": ("ring", False, None),
    "stream-chunk": ("ring", True, 4),
    "flash-causal": ("flash", True, None),
    "flash-full": ("flash", False, None),
    "ulysses-causal": ("ulysses", True, None),
}
FWD_SHAPE, GRAD_SHAPE, ULYSSES_GRAD_SHAPE = (2, 32, 4, 16), (2, 16, 2, 8), (
    2, 16, 4, 8)
CHUNK = SEQ // 4  # the per-device seq / 2 at sp 2, dist_lm's default
# name -> (mesh axes, config keywords, xent_chunk, grad_accum, aux weight)
STEP_CELLS = {
    "auto": (SP2, {}, CHUNK, 1, 0.0),
    "flash": (SP2, {"ring_impl": "flash"}, CHUNK, 1, 0.0),
    "ulysses": (SP2, {"ring_impl": "ulysses"}, CHUNK, 1, 0.0),
    "full": (SP2, {}, None, 1, 0.0),
    "gqa1": (SP2, {"n_kv_heads": 1}, CHUNK, 1, 0.0),
    "remat": (SP2, {"remat": True}, CHUNK, 1, 0.0),
    "accum2": (SP2, {}, CHUNK, 2, 0.0),
    "moe": (SP2, {"moe_every_n": 2, "moe_experts": 4, "moe_top_k": 2},
            CHUNK, 1, 0.01),
    "dp2sp2": (DP2SP2, {}, CHUNK, 1, 0.0),
    "sp2tp2_flash": (SP2TP2, {"ring_impl": "flash"}, CHUNK, 1, 0.0),
    "sp2tp2_ulysses": (SP2TP2, {"ring_impl": "ulysses"}, CHUNK, 1, 0.0),
}


def _size(axes) -> int:
    return int(np.prod(list(axes.values())))


def _jax_full_mesh(axes):
    """JAX's mesh of ``axes`` with dp, sp and tp all named (its rules name
    tp), the axes not given at size 1."""
    return _jax_mesh({"dp": 1, "sp": 1, "tp": 1, **axes})


def func_inputs(impl: str) -> dict:
    """Seeded q, k, v and a cotangent for the forward and the gradients."""
    rng = np.random.default_rng(sorted(IMPLS).index(impl))
    grad = ULYSSES_GRAD_SHAPE if impl.startswith("ulysses") else GRAD_SHAPE
    return {kind: [rng.normal(size=shape).astype(np.float32)
                   for _ in range(4)]
            for kind, shape in (("fwd", FWD_SHAPE), ("grad", grad))}


def _block_index(axes, rank, shape):
    """The index of ``rank``'s block of a ``[B, T, H, D]`` array: rows by
    dp, sequence by sp, heads by tp."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    at = create_mesh(axes, range(_size(axes))).coords(rank)
    out = []
    for dim, axis in ((0, "dp"), (1, "sp"), (2, "tp")):
        n = axes.get(axis, 1)
        size = shape[dim] // n
        i = at.get(axis, 0)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


# -- the ranks' side (torch and the port only) ------------------------------


def cases_rank(rank, world, cases):
    """Every case ``(name, function name, payload)`` in turn, one world."""
    return {name: globals()[fn](rank, world, p) for name, fn, p in cases}


def _port_fn(impl, axis):
    from tf_operator_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
    )
    from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention

    fn, causal, chunk = IMPLS[impl]
    if fn == "ring":
        return lambda q, k, v: ring_attention(q, k, v, axis, causal=causal,
                                              kv_chunk=chunk)
    if fn == "flash":
        return lambda q, k, v: ring_flash_attention(q, k, v, axis,
                                                    causal=causal)
    return lambda q, k, v: ulysses_attention(q, k, v, axis, causal=causal)


def func_rank(rank, world, p):
    """One function cell on this rank's blocks: its output block and the
    gradients of its q, k and v blocks."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    axes = p["axes"]
    mesh = create_mesh(axes, device="cpu")
    fn = _port_fn(p["impl"], TensorParallel(mesh, "sp"))
    out = {}
    for kind, arrays in p["inputs"].items():
        at = _block_index(axes, rank, arrays[0].shape)
        q, k, v, w = (torch.tensor(a[at]) for a in arrays)
        for x in (q, k, v):
            x.requires_grad_(True)
        o = fn(q, k, v)
        if kind == "fwd":
            out["out"] = o.detach().numpy()
        else:
            (o * w).sum().backward()
            out["grads"] = [x.grad.numpy() for x in (q, k, v)]
    return out


def step_rank(rank, world, p):
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        shard_params_by_rules,
        token_block,
    )
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.train import steps

    mesh = create_mesh(p["axes"], device="cpu")
    cfg = TransformerConfig(dtype=torch.float32, mesh=mesh, **p["cfg"])
    model = load_params(Transformer(cfg, device="cpu"), shard_params_by_rules(
        mesh, p["params"], param_sharding_rules()))
    tx = steps.adamw(LR)
    state = steps.TrainState.create(model, tx)
    step = steps.make_lm_train_step(
        model, tx, xent_chunk=p["xent_chunk"], grad_accum=p["grad_accum"],
        aux_loss_weight=p["aux"], mesh=mesh)
    losses, trees, grads, aux = [], [], None, []
    for batch in p["batches"]:
        state, m = step(state, token_block(mesh, batch))
        losses.append(float(m["loss"]))
        aux.append(float(m.get("aux_loss", 0.0)))
        if grads is None:
            grads = _whole(model, mesh, lambda p: p.grad)
        trees.append(_whole(model, mesh))
    return {"losses": losses, "params": trees, "grads": grads, "aux": aux}


def eval_rank(rank, world, p):
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import steps
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )

    mesh = create_mesh(DP2SP2, device="cpu")
    model = load_params(Transformer(TransformerConfig(
        dtype=torch.float32, mesh=mesh, **LM_KW), device="cpu"), p["params"])
    state = steps.TrainState.create(model, steps.adamw(LR))
    ev = steps.make_lm_eval_step(model, xent_chunk=8, mesh=mesh)
    return {"lm": steps.evaluate_lm(ev, state, iter(p["tokens"])),
            "shard_count": ev.shard_count}


# -- the JAX side ------------------------------------------------------------


def _jax_fn(impl, mesh, axes, use_kernel=False):
    from tf_operator_tpu.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
    )
    from tf_operator_tpu.parallel.ulysses import ulysses_attention

    fn, causal, chunk = IMPLS[impl]
    kw = dict(batch_spec=("dp",) if axes.get("dp", 1) > 1 else (None,),
              head_spec=("tp",) if axes.get("tp", 1) > 1 else (None,),
              causal=causal)
    if fn == "ring":
        return lambda q, k, v: ring_attention(q, k, v, mesh, kv_chunk=chunk,
                                              **kw)
    if fn == "flash":
        return lambda q, k, v: ring_flash_attention(
            q, k, v, mesh, use_kernel=use_kernel, **kw)
    return lambda q, k, v: ulysses_attention(q, k, v, mesh, **kw)


def _jax_func(mesh_name, impl, inputs):
    """JAX's output and gradients for one function cell; the flash ring's
    by its XLA blocks and by its interpret-mode kernel blocks."""
    import jax
    import jax.numpy as jnp

    axes = FUNC_MESHES[mesh_name]
    mesh = _jax_full_mesh(axes)
    out = {}
    # The kernel blocks tile per-device blocks of 8 and more (sp 2).
    kernels = ((False, True) if impl.startswith("flash")
               and axes["sp"] == 2 else (False,))
    for use_kernel in kernels:
        fn = _jax_fn(impl, mesh, axes, use_kernel)
        q, k, v, _ = (jnp.asarray(a) for a in inputs["fwd"])
        res = {"out": np.asarray(jax.jit(fn)(q, k, v))}
        q, k, v, w = (jnp.asarray(a) for a in inputs["grad"])
        grads = jax.jit(jax.grad(
            lambda q, k, v: (fn(q, k, v).astype(jnp.float32) * w).sum(),
            argnums=(0, 1, 2)))(q, k, v)
        res["grads"] = [np.asarray(g) for g in grads]
        out["kernel" if use_kernel else "xla"] = res
    return out


def _jax_step(name, params, batches):
    """JAX's losses, trees after each step and first-step gradients."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.moe import aux_loss_from
    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps

    axes, cfg_kw, xc, accum, aux_w = STEP_CELLS[name]
    mesh = _jax_full_mesh(axes)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh,
                                     **dict(LM_KW, **cfg_kw)))
    placed = shard_params_by_rules(mesh, params, param_sharding_rules())
    tx = jax_steps.adamw(LR)

    def loss(p, tokens, targets):
        kw = dict(return_hidden=xc is not None)
        if aux_w:
            out, col = model.apply({"params": p}, tokens,
                                   mutable=["losses"], **kw)
            aux = aux_loss_from(col)
        else:
            out, aux = model.apply({"params": p}, tokens, **kw), 0.0
        if xc is None:
            xent = jax_steps.cross_entropy(out, targets)
        else:
            head = p["lm_head"]
            xent = jax_steps.sharded_lm_xent(
                mesh, out, head["kernel"], head["bias"], targets, chunk=xc)
        return xent + aux_w * aux

    grad = jax.jit(jax.grad(loss))
    first = batches[0]
    mb = BATCH // accum
    micro = [grad(placed, first["tokens"][i * mb:(i + 1) * mb],
                  first["targets"][i * mb:(i + 1) * mb])
             for i in range(accum)]
    grads = jax.tree.map(lambda *g: np.asarray(sum(g) / accum), *micro)
    state = jax_steps.TrainState.create(placed, tx)
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, donate=False, xent_chunk=xc, grad_accum=accum,
        aux_loss_weight=aux_w)
    losses, trees, aux = [], [], []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        aux.append(float(m.get("aux_loss", 0.0)))
        trees.append(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "params": trees, "grads": grads, "aux": aux}


def _jax_eval(params, tokens):
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )
    from tf_operator_tpu.train import steps as jax_steps

    mesh = _jax_full_mesh(DP2SP2)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh, **LM_KW))
    return jax_steps.evaluate_lm(
        jax_steps.make_lm_eval_step(model, mesh, xent_chunk=8),
        jax_steps.TrainState.create(params, jax_steps.adamw(LR)),
        iter(tokens))


_RESULTS: dict = {}


def world_results(world: int) -> tuple[dict, list]:
    """(JAX's references, the ranks' results) of every case at ``world``
    ranks, computed once. The ranks start first and JAX's references are
    computed while they run."""
    if world in _RESULTS:
        return _RESULTS[world]
    from concurrent.futures import ThreadPoolExecutor

    cases, refs = [], {}
    for mesh_name, axes in FUNC_MESHES.items():
        if _size(axes) != world:
            continue
        for impl in IMPLS:
            inputs = func_inputs(impl)
            key = f"{mesh_name}-{impl}"
            cases.append((key, "func_rank", {"axes": axes, "impl": impl,
                                             "inputs": inputs}))
            refs[key] = (_jax_func, mesh_name, impl, inputs)
    for name, (axes, cfg_kw, xc, accum, aux) in STEP_CELLS.items():
        if _size(axes) != world:
            continue
        kw = dict(LM_KW, **cfg_kw)
        params = seeded_tree(kw, 40 + len(cases))
        batches = lm_batches(3, seed=40 + len(cases))
        cases.append((name, "step_rank", {
            "axes": axes, "cfg": kw, "params": params, "batches": batches,
            "xent_chunk": xc, "grad_accum": accum, "aux": aux}))
        refs[name] = (_jax_step, name, params, batches)
    if world == 4:
        rng = np.random.default_rng(16)
        params = seeded_tree(LM_KW, 31)
        tokens = []
        for n in (5, 5, 3):
            t = rng.integers(0, VOCAB, (n, SEQ + 1)).astype(np.int32)
            tokens.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
        cases.append(("eval", "eval_rank", {"params": params,
                                            "tokens": tokens}))
        refs["eval"] = (_jax_eval, params, tokens)
    port = free_port()
    want = {}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_processes, "test_torch_sp", "cases_rank",
                            [rank_env(r, world, port) for r in range(world)],
                            cases)
        for name, (fn, *args) in refs.items():
            want[name] = fn(*args)
        results = ranks.result()
    _RESULTS[world] = want, results
    return _RESULTS[world]


# -- the functions -----------------------------------------------------------


def _assemble(axes, results, key, part):
    """The global array of every rank's block of ``part`` (``"out"`` or
    ``("grads", i)``)."""
    blocks = []
    for rank, r in enumerate(results):
        got = r[key]
        blocks.append(got["out"] if part == "out" else got["grads"][part])
    shape = list(blocks[0].shape)
    for dim, axis in ((0, "dp"), (1, "sp"), (2, "tp")):
        shape[dim] *= axes.get(axis, 1)
    whole = np.zeros(shape, np.float32)
    for rank, block in enumerate(blocks):
        whole[_block_index(axes, rank, shape)] = block
    return whole


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("mesh_name", list(FUNC_MESHES))
def test_function_matches_jax(mesh_name, impl):
    axes = FUNC_MESHES[mesh_name]
    want, results = world_results(_size(axes))
    key = f"{mesh_name}-{impl}"
    for side, ref in want[key].items():
        err = np.abs(_assemble(axes, results, key, "out")
                     - ref["out"]).max()
        assert err <= FUNC_TOL, (side, "out", err)
        for i, name in enumerate("qkv"):
            err = np.abs(_assemble(axes, results, key, i)
                         - ref["grads"][i]).max()
            assert err <= FUNC_TOL, (side, "d" + name, err)


def test_refusals_in_jax_words():
    from tf_operator_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
    )
    from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention

    axis = types.SimpleNamespace(size=2, index=0, axis="sp", members=[0, 1])
    q = torch.zeros(2, 8, 3, 8)
    with pytest.raises(ValueError, match="kv_chunk 3 must divide the kv "
                                         "block 8"):
        ring_attention(q, q, q, axis, kv_chunk=3)
    with pytest.raises(ValueError, match="causal ring_flash_attention "
                                         "requires equal q/kv seq lengths"):
        ring_flash_attention(q, q[:, :4], q[:, :4], axis)
    with pytest.raises(ValueError, match="local heads 3 not divisible by "
                                         "sp=2"):
        ulysses_attention(q, q, q, axis)


def test_config_refuses_as_jax_and_keeps_decode_meshes_off_sp():
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(SP2, range(2), device="cpu")
    with pytest.raises(ValueError, match="ring_impl='ring': expected"):
        TransformerConfig(mesh=mesh, ring_impl="ring")
    with pytest.raises(ValueError, match="ignores ring_kv_chunk"):
        TransformerConfig(mesh=mesh, ring_impl="flash", ring_kv_chunk=4)
    assert TransformerConfig(mesh=mesh, ring_kv_chunk=4).use_ring
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8h"):
        TransformerConfig(mesh=mesh, decode=True)


# -- the step ----------------------------------------------------------------


def _check_step(name):
    axes = STEP_CELLS[name][0]
    want_all, results = world_results(_size(axes))
    want = want_all[name]
    got = [r[name] for r in results]
    for r in got:
        assert r["losses"] == got[0]["losses"], name
        for a, b in zip(r["params"], got[0]["params"]):
            for path, leaf in _flat(a).items():
                assert np.array_equal(leaf, _flat(b)[path]), (name, path)
    np.testing.assert_allclose(got[0]["losses"], want["losses"],
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(got[0]["aux"], want["aux"], rtol=LOSS_TOL)
    for path, w in _flat(want["grads"]).items():
        g = _flat(got[0]["grads"])[path]
        err = float(np.abs(g - w).max())
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert err <= bound, (name, "grad", path, err, bound)
    for i, (g, w) in enumerate(zip(got[0]["params"], want["params"])):
        g = _noise_elements(g, w, want["grads"], (i + 1) * LR)
        _assert_leaves_close(_gqa_key_bias(g, w, (i + 1) * LR), w,
                             LEAF_RTOL, lr_sum=(i + 1) * LR)


def _noise_elements(got, want, grads, lr_sum):
    """The key bias's rule (within 4 x ``lr_sum``: Adam scales rounding
    noise to about lr a step) for every element whose first-step gradient
    the gradient check cannot tell from 0 (``|g| <= GRAD_RTOL * max +
    GRAD_ATOL`` of its leaf); returns ``got`` with those elements set to
    ``want``'s."""
    flat, grads = _flat(got), _flat(grads)
    for path, w in _flat(want).items():
        g = np.abs(grads[path])
        noise = g <= GRAD_RTOL * float(g.max()) + GRAD_ATOL
        err = np.abs(flat[path] - w)[noise]
        assert not err.size or err.max() <= 4 * lr_sum, path
        flat[path] = np.where(noise, w, flat[path])
    return _tree(flat)


@pytest.mark.parametrize("name", list(STEP_CELLS))
def test_step_matches_jax_mesh(name):
    _check_step(name)


def test_eval_under_dp2_sp2_with_a_ragged_tail_matches_jax():
    want, results = world_results(4)
    got = [r["eval"] for r in results]
    assert all(r == got[0] for r in got)
    assert got[0]["shard_count"] == 2
    w = want["eval"]
    assert got[0]["lm"]["tokens"] == w["tokens"] == 13 * SEQ
    assert abs(got[0]["lm"]["loss"] - w["loss"]) <= LOSS_TOL * abs(w["loss"])


# -- dist_lm --sp ------------------------------------------------------------

ENTRY = ["--device", "cpu", "--sp", "2", "--steps", "12", "--target-loss",
         "10"]


def _jax_entry_losses(axes, ring_impl):
    """examples/dist_lm.py's step at ENTRY's flags on a mesh of ``axes``
    (its mesh, batches, per-device chunk, ring_impl and AdamW) on virtual
    devices, from the port's seeded tree: the losses at the steps dist_lm
    prints."""
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu.parallel.sharding import shard_params_by_rules
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    steps, batch, seq, vocab, d = 12, 8, 128, 256, 128
    kw = dict(vocab_size=vocab, d_model=d, n_heads=4, n_layers=2,
              d_ff=2 * d, max_seq_len=seq)
    mesh = _jax_full_mesh(axes)
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, mesh=mesh,
                                     ring_impl=ring_impl, **kw))
    params = shard_params_by_rules(mesh, init_params(TransformerConfig(
        **kw), 0), param_sharding_rules())
    tx = jax_steps.adamw(3e-3)
    state = jax_steps.TrainState.create(params, tx)
    step = jax_steps.make_lm_train_step(
        model, tx, mesh, donate=False, xent_chunk=seq // axes["sp"] // 2)
    out = {}
    for i in range(steps):
        rng = np.random.default_rng((7, i))
        start = rng.integers(0, vocab, (batch, 1))
        chain = ((start + np.arange(seq + 1)) % vocab).astype(np.int32)
        state, m = step(state, {"tokens": chain[:, :-1],
                                "targets": chain[:, 1:]})
        if i == 0 or (i + 1) % 20 == 0 or i == steps - 1:
            out[i + 1] = float(m["loss"])
    return out


def _restore_sp1(directory: str, step: int) -> list:
    """The sp 2 checkpoint of ``step`` restored into a plain model as
    dist_lm builds it: the names of the weights and moments that differ
    from the saved tree."""
    from tf_operator_tpu_torch.models.convert import (
        flax_path,
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import checkpoint
    from tf_operator_tpu_torch.train.steps import TrainState, adamw

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            n_layers=2, d_ff=256, max_seq_len=128,
                            dtype=torch.float32)
    model = load_params(Transformer(cfg, device="cpu"), init_params(cfg, 1))
    state = TrainState.create(model, adamw(3e-3))
    with checkpoint.CheckpointManager(directory) as mgr:
        mgr.restore(step, state)
    saved, _ = checkpoint.read(directory, step)
    differ = []
    for name, p in model.named_parameters():
        path = flax_path(name)
        if not torch.equal(p.detach(), checkpoint._tree_get(
                saved["params"], path)):
            differ.append(name)
        for key in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(state.optimizer.state[p][key],
                               checkpoint._tree_get(saved["opt"][key],
                                                    path)):
                differ.append(f"{key} {name}")
    assert state.step == step + 1
    return differ


def test_dist_lm_sp2_resumes_bitwise_and_follows_jax(tmp_path):
    from tf_operator_tpu_torch.models.convert import _leaves
    from tf_operator_tpu_torch.train import checkpoint

    tmp = str(tmp_path)
    ck, twin = str(tmp_path / "ck"), str(tmp_path / "twin")
    first = _start(ENTRY + ["--checkpoint-dir", ck, "--fail-at-step", "5"],
                   2, tmp, "first")
    other = _start(ENTRY + ["--checkpoint-dir", twin], 2, tmp, "twin")
    codes = _wait(first + other)
    assert codes == [138, 138, 0, 0], _log(tmp, "first") + _log(tmp, "twin")
    # At most four ranks at once: the suite's other workers share the cores.
    four = _start(ENTRY + ["--tp", "2"], 4, tmp, "four")
    want_four = _jax_entry_losses({"dp": 1, "sp": 2, "tp": 2}, "auto")
    codes = _wait(four)
    second = _start(ENTRY + ["--checkpoint-dir", ck, "--fail-at-step", "5"],
                    2, tmp, "second")
    uly = _start(ENTRY + ["--ring-impl", "ulysses"], 2, tmp, "uly")
    want_uly = _jax_entry_losses({"dp": 1, "sp": 2, "tp": 1}, "ulysses")
    codes += _wait(second + uly)
    assert codes == [0] * 8, "".join(
        _log(tmp, tag, r) for tag, n in (("four", 4), ("second", 2),
                                         ("uly", 2)) for r in range(n))
    for r in range(2):
        out = _log(tmp, "second", r)
        assert "dist_lm: resumed from step 6" in out and "dist_lm: OK" in out
        assert f"process {r}/2, mesh {{'dp': 1, 'sp': 2, 'tp': 1}}" in out
    last = checkpoint.latest_step(ck)
    assert last == checkpoint.latest_step(twin) == 11
    a = dict(_leaves(checkpoint.read(ck, last)[0]))
    b = dict(_leaves(checkpoint.read(twin, last)[0]))
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert _printed(_log(tmp, "second"))[1] == _printed(
        _log(tmp, "twin"))[1]
    assert _restore_sp1(ck, last) == []
    for tag, n, want, mesh in (
            ("four", 4, want_four, "{'dp': 1, 'sp': 2, 'tp': 2}"),
            ("uly", 2, want_uly, "{'dp': 1, 'sp': 2, 'tp': 1}")):
        logs = [_log(tmp, tag, r) for r in range(n)]
        for r, out in enumerate(logs):
            assert f"dist_lm: process {r}/{n}, mesh {mesh}" in out
            assert _printed(out) == _printed(logs[0])
        printed, final = _printed(logs[0])
        assert printed.keys() == {1} and final is not None
        for s, v in {**printed, 12: final}.items():
            assert abs(v - want[s]) <= ENTRY_TOL, (tag, s, v, want[s])


def test_dist_lm_sp_usage_errors_are_jax_s(tmp_path, capsys):
    from tf_operator_tpu_torch.train import dist_lm

    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu", "--ring-impl", "stream"])
    assert exc.value.code == 2
    assert "--ring-impl requires --sp > 1" in capsys.readouterr().err
    tmp = str(tmp_path)
    data = str(tmp_path / "tokens.bin")
    with open(data, "wb"):
        pass
    seq = _start(ENTRY + ["--seq", "15"], 2, tmp, "seq")
    dat = _start(ENTRY + ["--data", data], 2, tmp, "data")
    assert _wait(seq + dat) == [1] * 4
    for r in range(2):
        assert ("batch must be a multiple of dp and seq a multiple of sp"
                in _log(tmp, "seq", r))
        assert "--data requires sp=1 and tp=1" in _log(tmp, "data", r)
