"""The port's int8 decode held against the JAX package on the CPU, on the
same seeded numpy inputs and the JAX init's weights:

- ``quantize_int8``, ``_kv8_quant`` and ``quantize_decode_params``
  bitwise (the quantizers carry the int8 weights and cache across);
- ``int8_matmul_reference`` (the plain version of kernel B5) against JAX
  ``int8_matmul`` in Pallas interpret mode and ``int8_matmul_xla``: f32
  within rtol = atol = 1e-5 (the same exact products summed in another
  order), bf16 within one bf16 step (each side rounds that sum once);
- ``paged_attend_reference`` with scale pools (the plain version of the
  kv8 variant of B4) against JAX ``paged_attend`` in interpret mode,
  within 1e-5;
- prefill logits of the int8, kv8 and int8 + kv8 decode models within
  1e-4 of the largest |logit|;
- the ContinuousEngine with int8 + kv8 against the JAX engine (gather and
  Pallas-interpret reads) and against JAX ``generate`` per prompt, over
  join, retire, a shared-prefix join and an exact re-join whose
  copy-on-write must carry the scale pools: greedy tokens identical and
  ``kv_debug`` equal.

The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_paged_attention import make_case
from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    _kv8_quant as jax_kv8_quant,
    _prefill as jax_prefill,
    generate as jax_generate,
    quantize_decode_params as jax_quantize_decode_params,
)
from tf_operator_tpu.ops.int8_dense import (
    int8_apply as jax_int8_apply,
    int8_matmul as jax_int8_matmul,
    int8_matmul_xla,
    quantize_int8 as jax_quantize_int8,
)
from tf_operator_tpu.ops.paged_attention import (
    paged_attend as jax_paged_attend,
)
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.convert import (
    load_params,
    quantize_decode_params,
)
from tf_operator_tpu_torch.ops import int8_dense as i8
from tf_operator_tpu_torch.ops import paged_attention as pa
from tf_operator_tpu_torch.serve.engine import ContinuousEngine

torch.set_num_threads(1)

BLK, SLOTS = 8, 3
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=64)
KV_KEYS = ("blocks_used", "blocks_shared", "blocks_free", "prefix_hits",
           "prefix_entries", "cow_copies", "prefill_tokens_saved")
MODES = {"int8": dict(int8_decode=True), "kv8": dict(kv_int8=True),
         "int8kv8": dict(int8_decode=True, kv_int8=True)}


def _bits(x) -> np.ndarray:
    """An array's raw bits, so equality is bitwise (and -0.0 != 0.0)."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.dtype(f"u{x.dtype.itemsize}")) if x.dtype.kind == "f" \
        else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (64, 72)])
def test_quantize_int8_is_bitwise_jax(shape, dtype):
    rng = np.random.default_rng(shape[1])
    w = (rng.standard_normal(shape, dtype=np.float32)
         * rng.uniform(0.01, 3.0, shape[1]).astype(np.float32))
    w[:, 3] = 0.0  # an all-zero column: scale 1.0, codes 0
    jq, js = jax_quantize_int8(jnp.asarray(w, dtype))
    tq, ts = i8.quantize_int8(
        torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    assert ts[3] == 1.0 and not tq[:, 3].any()


def test_kv8_quant_is_bitwise_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32) * 3
    x[0, 2, 1] = 0.0  # an all-zero head row: the 1e-8 floor
    jq, js = jax_kv8_quant(jnp.asarray(x))
    tq, ts = tt._kv8_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def _jax_params(n_kv_heads, seed=0):
    cfg = JaxConfig(dtype=jnp.float32, n_kv_heads=n_kv_heads, **KW)
    params = JaxTransformer(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, params


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_quantize_decode_params_is_bitwise_jax(n_kv_heads):
    _, params = _jax_params(n_kv_heads)
    want = _flat(jax_quantize_decode_params(params))
    got = _flat(quantize_decode_params(jax.tree.map(np.asarray, params)))
    assert got.keys() == want.keys()
    assert ("lm_head", "kernel_q") in got
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(_bits(got[path]), _bits(leaf),
                                      err_msg=str(path))


def test_quantize_decode_params_refuses_moe():
    """Now the pass-through pin (JAX's tests/test_training.py::
    test_moe_params_pass_through_unquantized): an MoE block's leaves leave
    ``quantize_decode_params`` as they came, as JAX's leave it, while the
    dense projections around them quantize."""
    _, params = _jax_params(None)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(7)
    moe = {"router": rng.standard_normal((32, 4)).astype(np.float32),
           "w_in": rng.standard_normal((4, 32, 64)).astype(np.float32),
           "w_out": rng.standard_normal((4, 64, 32)).astype(np.float32)}
    tree["block_1"]["moe"] = moe
    got = quantize_decode_params(tree)
    want = jax_quantize_decode_params(
        jax.tree.map(jnp.asarray, tree))["block_1"]["moe"]
    for name, leaf in moe.items():
        np.testing.assert_array_equal(got["block_1"]["moe"][name], leaf)
        np.testing.assert_array_equal(np.asarray(want[name]), leaf)
    assert "kernel_q" in got["block_1"]["attn"]["qkv"]


def _matmul_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    wq, scale = (np.array(a) for a in jax_quantize_int8(jnp.asarray(w)))
    return x, wq, scale


def _assert_one_bf16_step(got: torch.Tensor, want) -> None:
    """Each element equal or one bf16 step apart (2^-7 of its size)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    step = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= step).all()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 19])
def test_int8_matmul_reference_matches_jax(m, x_dtype, out_dtype):
    x, wq, scale = _matmul_case(m, 64, 256, seed=m)
    jx = jnp.asarray(x, x_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jout = getattr(jnp, out_dtype)
    tout = getattr(torch, out_dtype)
    wants = (
        jax_int8_matmul(jx, jnp.asarray(wq), jnp.asarray(scale), block_n=128,
                        interpret=True, out_dtype=jout),
        int8_matmul_xla(jx, jnp.asarray(wq), jnp.asarray(scale),
                        out_dtype=jout),
    )
    got = i8.int8_matmul_reference(tx, torch.from_numpy(wq),
                                   torch.from_numpy(scale), tout)
    assert got.dtype == tout and got.shape == (m, 256)
    for want in wants:
        if out_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        else:
            _assert_one_bf16_step(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_apply_takes_leading_dims_and_any_n(out_dtype):
    """n = 72 is off every tiling (JAX takes its XLA branch); the CPU
    dispatch runs the plain version and counts no launch."""
    x, wq, scale = _matmul_case(6, 64, 72, seed=3)
    x = x.reshape(2, 3, 64)
    want = jax_int8_apply(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                          out_dtype=getattr(jnp, out_dtype))
    before = (i8.launches, i8.wgmma_launches)
    got = i8.int8_apply(torch.from_numpy(x), torch.from_numpy(wq),
                        torch.from_numpy(scale), getattr(torch, out_dtype))
    assert (i8.launches, i8.wgmma_launches) == before
    assert got.shape == (2, 3, 72)
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        _assert_one_bf16_step(got, want)
    with pytest.raises(ValueError, match="shape mismatch"):
        i8.int8_matmul(torch.zeros(2, 63), torch.from_numpy(wq),
                       torch.from_numpy(scale))


def test_int8_geometry_rule():
    f32, bf16 = torch.float32, torch.bfloat16
    assert i8.int8_matmul_supported(4, 1024, 512, bf16, f32)
    assert i8.int8_matmul_supported(3500, 4096, 1024, f32, bf16)
    assert not i8.int8_matmul_supported(4, 64, 72, f32, f32)   # n % 128
    assert not i8.int8_matmul_supported(4, 48, 128, f32, f32)  # k % 32
    assert not i8.int8_matmul_supported(4, 64, 128, torch.float16, f32)
    assert not i8.int8_matmul_supported(0, 64, 128, f32, f32)
    assert not i8.int8_matmul_supported(4, 64, 128, f32, torch.int8)


KV8_CASES = [
    dict(b=3, t=t, kv=2, g=g, dh=16, blk=8, table_len=8, kv8=True,
         seed=20 + 10 * t + g, spread=[5, 40, 0])
    for t in (1, 3) for g in (1, 4)
]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", KV8_CASES,
                         ids=lambda c: f"t{c['t']}g{c['g']}")
def test_kv8_paged_reference_matches_jax_paged_attend(case):
    q, pk, pv, table, idx, ks, vs = make_case(**case)
    want = np.asarray(jax_paged_attend(q, pk, pv, table, idx,
                                       k_scale_pool=ks, v_scale_pool=vs,
                                       interpret=True))
    tq, tpk, tpv, ttable, tidx, tks, tvs = _torch(q, pk, pv, table, idx, ks,
                                                   vs)
    assert tpk.dtype == torch.int8
    scales = dict(k_scale_pool=tks, v_scale_pool=tvs)
    got = pa.paged_attend_reference(tq, tpk, tpv, ttable, tidx, **scales)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    before = pa.kv8_launches, pa.launches
    dispatched = pa.paged_attend(tq, tpk, tpv, ttable, tidx, **scales)
    assert (pa.kv8_launches, pa.launches) == before
    torch.testing.assert_close(dispatched, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="both scale pools"):
        pa.paged_attend(tq, tpk, tpv, ttable, tidx, k_scale_pool=tks)


def test_kv8_geometry_rule():
    """The kv8 variant takes the bf16/f32 kernel's geometry, q's dtype
    deciding: int8 names the pools, never q."""
    assert pa.paged_attend_supported(1, 16, 4, 64, torch.bfloat16)
    assert pa.paged_attend_supported(3, 16, 4, 64, torch.float32)
    assert not pa.paged_attend_supported(1, 16, 4, 64, torch.int8)
    assert not pa.paged_attend_supported(9, 16, 4, 64, torch.bfloat16)


def _configs(mode, n_kv_heads):
    jcfg = JaxConfig(dtype=jnp.float32, n_kv_heads=n_kv_heads,
                     **MODES[mode], **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, n_kv_heads=n_kv_heads,
                                **MODES[mode], **KW)
    return jcfg, tcfg


def _trees(mode, params):
    """(JAX tree, port tree): quantized when the mode has int8 weights."""
    if MODES[mode].get("int8_decode"):
        return (jax_quantize_decode_params(params),
                quantize_decode_params(jax.tree.map(np.asarray, params)))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_logits_match_jax(mode, n_kv_heads):
    jcfg, tcfg = _configs(mode, n_kv_heads)
    _, params = _jax_params(n_kv_heads, seed=3)
    jtree, ttree = _trees(mode, params)
    prompt = np.random.default_rng(4).integers(
        0, KW["vocab_size"], (1, 11)).astype(np.int32)
    jcache, jlogits = jax_prefill(JaxTransformer(replace(jcfg, decode=True)),
                                  jtree, jnp.asarray(prompt))
    model = load_params(
        tt.Transformer(replace(tcfg, decode=True), device="cpu"), ttree)
    cache, logits = tt._prefill(model, torch.from_numpy(prompt))
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    layer = cache["layers"][0]
    if tcfg.kv_int8:
        assert layer["cached_key"].dtype == torch.int8
        assert layer["key_scale"].shape == (1, KW["max_seq_len"],
                                            tcfg.kv_heads)
        np.testing.assert_allclose(
            layer["value_scale"][0, :11].numpy(),
            np.asarray(jcache["block_0"]["attn"]["value_scale"])[0, :11],
            rtol=1e-5)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


# (name, prompt, steps): a joins and retires; b's exact re-join ends
# mid-block (copy-on-write of a shared block: int8 rows and scale pools);
# d shares b's first block (suffix prefill); e reuses a freed slot.
A, B = _prompt(20, 1), _prompt(13, 2)
D = np.concatenate([B[:, :BLK], _prompt(5, 3)], axis=1)
E = _prompt(9, 4)
REQUESTS = {"a": (A, 10), "b": (B, 30), "b2": (B, 12), "d": (D, 12),
            "e": (E, 6)}


def _schedule(engine):
    """Drive ``engine``; return each request's greedy tokens, the slots
    joined and ``kv_debug`` after every phase."""
    streams, slots, debug = {}, [], []
    live: dict[str, int] = {}

    def steps(n):
        for _ in range(n):
            out = engine.step()
            for name, slot in live.items():
                if len(streams[name]) < REQUESTS[name][1]:
                    streams[name].append(int(out[slot]))
        debug.append({k: engine.kv_debug()[k] for k in KV_KEYS})

    def join(name):
        prompt, n = REQUESTS[name]
        live[name] = engine.join(prompt, num_steps=n)
        slots.append(live[name])
        streams[name] = []

    join("a")
    join("b")
    steps(3)
    engine.retire(live.pop("a"))
    join("b2")
    join("d")
    steps(5)
    engine.retire(live.pop("b"))
    join("e")
    steps(4)
    return streams, slots, debug


@pytest.mark.parametrize("n_kv_heads,jax_attend,torch_attend", [
    (2, "gather", "gather"),
    (2, "pallas", "kernel"),
    (None, "gather", "kernel"),
])
def test_int8_kv8_engine_matches_jax_engine(n_kv_heads, jax_attend,
                                            torch_attend):
    jcfg, tcfg = _configs("int8kv8", n_kv_heads)
    _, params = _jax_params(n_kv_heads)
    jtree, ttree = _trees("int8kv8", params)
    want = _schedule(JaxEngine(jcfg, jtree, max_slots=SLOTS, kv_paged=True,
                               kv_block=BLK, kv_attend=jax_attend))
    engine = ContinuousEngine(tcfg, ttree, SLOTS, kv_block=BLK,
                              kv_attend=torch_attend, device="cpu")
    assert engine._cache["layers"][0]["pool_key_scale"].dtype == torch.float32
    got = _schedule(engine)
    assert got[1] == want[1] == [0, 1, 0, 2, 1]
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[2][1]["cow_copies"] == 1 and got[2][1]["prefix_hits"] == 2


def test_int8_kv8_engine_matches_jax_generate_per_prompt():
    """Each request's tokens, the copy-on-write re-join's included, equal
    JAX ``generate`` of its prompt alone on the int8 + kv8 config; a
    copy-on-write that left the scale pools behind would not."""
    jcfg, tcfg = _configs("int8kv8", 2)
    _, params = _jax_params(2)
    jtree, ttree = _trees("int8kv8", params)
    streams, _, debug = _schedule(ContinuousEngine(
        tcfg, ttree, SLOTS, kv_block=BLK, kv_attend="kernel", device="cpu"))
    assert debug[1]["cow_copies"] == 1
    for name, toks in streams.items():
        prompt = REQUESTS[name][0]
        want = np.asarray(jax_generate(jcfg, jtree, jnp.asarray(prompt),
                                       len(toks)))[0]
        np.testing.assert_array_equal(toks, want, err_msg=name)


def test_cow_copies_every_pool_leaf():
    """cow_copy moves the scale pools with the int8 rows."""
    from tf_operator_tpu_torch.serve.kvcache import POOL_KEYS, cow_copy

    _, tcfg = _configs("kv8", 2)
    model = tt.Transformer(replace(tcfg, decode=True, kv_paged=True,
                                   kv_block=BLK, kv_num_blocks=4),
                           device="cpu")
    cache = model.init_cache(1)
    layer = cache["layers"][0]
    assert set(layer) == set(POOL_KEYS)
    for i, name in enumerate(POOL_KEYS):
        layer[name][1] = i + 1
    cow_copy(cache, 0, 0, 1, 3)
    for i, name in enumerate(POOL_KEYS):
        assert (layer[name][3] == i + 1).all(), name
    assert cache["block_table"][0, 0] == 3
