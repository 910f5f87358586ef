"""The port's decode-mode transformer (tf_operator_tpu_torch/models/) held
against the JAX model on the CPU in f32, with the JAX init's params
converted by models/convert.py: prompt prefill logits against JAX
``_prefill``, and three paged decode steps' logits against the JAX
``kv_paged`` model's apply from one seeded pool state, with the JAX
read in ``gather`` mode and in Pallas interpret mode. MHA and GQA.
Tolerance atol=1e-4: f32 end to end, two frameworks' reduction orders
through two layers."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    _prefill as jax_prefill,
)
from tf_operator_tpu_torch.models.convert import (
    init_params,
    load_params,
    param_shapes,
)
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _prefill,
)

torch.set_num_threads(1)

ATOL = 1e-4
BLK, LANES, SPREAD = 8, 3, [5, 17, 0]  # lane 2 inactive at index 0
ARCHS = {"mha": None, "gqa": 1}  # n_kv_heads (GQA: g = 4)


def _configs(arch):
    kw = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq_len=64, n_kv_heads=ARCHS[arch])
    return JaxConfig(dtype=jnp.float32, **kw), \
        TransformerConfig(dtype=torch.float32, decode=True, **kw)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    jcfg, tcfg = _configs(request.param)
    params = JaxTransformer(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


def test_convert_layout_matches_the_flax_tree(arch):
    jcfg, tcfg, params = arch
    leaves = {
        tuple(k.key for k in path): leaf.shape
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    assert leaves == param_shapes(tcfg)
    seeded = init_params(tcfg, 0)
    assert {
        tuple(k.key for k in path): leaf.shape
        for path, leaf in jax.tree_util.tree_leaves_with_path(seeded)
    } == leaves


def test_load_params_rejects_a_foreign_tree(arch):
    _, tcfg, params = arch
    other = replace(tcfg, n_kv_heads=None if tcfg.n_kv_heads else 2)
    with pytest.raises(ValueError, match="param tree does not match"):
        load_params(Transformer(other, device="cpu"), params)


def test_prefill_matches_jax(arch):
    jcfg, tcfg, params = arch
    prompt = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 11)).astype(np.int32)
    jcache, jlogits = jax_prefill(
        JaxTransformer(replace(jcfg, decode=True)), params,
        jnp.asarray(prompt))
    model = load_params(Transformer(tcfg, device="cpu"), params)
    cache, logits = _prefill(model, torch.from_numpy(prompt))
    assert cache["cache_index"] == 11
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    for i, layer in enumerate(cache["layers"]):
        jattn = jcache[f"block_{i}"]["attn"]
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(
                layer[name][0, :11].numpy(),
                np.asarray(jattn[name])[0, :11], atol=ATOL, rtol=0)


def _pool_state(tcfg, nb, seed):
    """Seeded pools for every layer plus tables giving each lane distinct
    blocks for its history and the three decode steps."""
    rng = np.random.default_rng(seed)
    shape = (nb, BLK, tcfg.kv_heads, tcfg.head_dim)
    pools = [(rng.standard_normal(shape, dtype=np.float32),
              rng.standard_normal(shape, dtype=np.float32))
             for _ in range(tcfg.n_layers)]
    table = np.zeros((LANES, tcfg.max_seq_len // BLK), np.int32)
    nxt = 1
    for lane, pos in enumerate(SPREAD):
        for e in range(-(-(pos + 3) // BLK)):
            table[lane, e] = nxt
            nxt += 1
    return pools, table, np.asarray(SPREAD, np.int32)


@pytest.mark.parametrize("jax_attend,torch_attend",
                         [("gather", "gather"), ("pallas", "kernel")])
def test_paged_decode_steps_match_jax(arch, jax_attend, torch_attend):
    jcfg, tcfg, params = arch
    nb = 12
    paged = dict(kv_paged=True, kv_block=BLK, kv_num_blocks=nb)
    jmodel = JaxTransformer(replace(jcfg, decode=True, kv_attend=jax_attend,
                                    **paged))
    tmodel = load_params(
        Transformer(replace(tcfg, kv_attend=torch_attend, **paged),
                    device="cpu"), params)
    pools, table, idx = _pool_state(tcfg, nb, seed=5)

    jcache = {"pos_index": jnp.asarray(idx)}
    tcache = tmodel.init_cache(LANES)
    tcache["block_table"].copy_(torch.from_numpy(table))
    tcache["cache_index"].copy_(torch.from_numpy(idx))
    for i, (pk, pv) in enumerate(pools):
        jcache[f"block_{i}"] = {"attn": {
            "pool_key": jnp.asarray(pk), "pool_value": jnp.asarray(pv),
            "block_table": jnp.asarray(table),
            "cache_index": jnp.asarray(idx),
        }}
        tcache["layers"][i]["pool_key"].copy_(torch.from_numpy(pk))
        tcache["layers"][i]["pool_value"].copy_(torch.from_numpy(pv))

    rng = np.random.default_rng(6)
    for _ in range(3):
        toks = rng.integers(0, tcfg.vocab_size, (LANES, 1)).astype(np.int32)
        jlogits, upd = jmodel.apply(
            {"params": params, "cache": jcache}, jnp.asarray(toks),
            mutable=["cache"])
        jcache = upd["cache"]
        tlogits = tmodel(torch.from_numpy(toks), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tcache["cache_index"].numpy(),
                                  np.asarray(jcache["pos_index"]))
    for i, layer in enumerate(tcache["layers"]):
        np.testing.assert_allclose(
            layer["pool_key"].numpy(),
            np.asarray(jcache[f"block_{i}"]["attn"]["pool_key"]),
            atol=ATOL, rtol=0)


def test_embed_backward_on_the_cpu_is_one_sum_across_threads():
    """``Embed``'s CPU gradient is the same on every call with four
    threads (ROADMAP C2): 8,192 ids into 256 rows, five backwards from one
    gradient. Indexing's CPU backward adds rows with atomics across
    threads and gave five different gradients in five calls here."""
    from tf_operator_tpu_torch.models.transformer import Embed, _Store

    torch.manual_seed(0)
    embed = Embed(256, 512, torch.float32,
                  _Store(torch.float32, False, torch.device("cpu")))
    with torch.no_grad():
        embed.weight.normal_()
    ids = torch.randint(0, 256, (8, 1024))
    grad = torch.randn(8, 1024, 512)
    grads = set()
    torch.set_num_threads(4)
    try:
        for _ in range(5):
            embed.weight.grad = None
            embed(ids).backward(grad)
            grads.add(embed.weight.grad.numpy().tobytes())
    finally:
        torch.set_num_threads(1)
    assert len(grads) == 1
