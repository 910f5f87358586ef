"""Where the port's bf16 forward rounds, held against JAX's (ROADMAP C1).

XLA's CPU backend drops bf16 roundings inside a fusion unless
``--xla_allow_excess_precision=false``; with it, every JAX operation
rounds its result to its dtype, as the port's eager operations do. The
JAX side runs in a subprocess with that flag (the conftest's JAX and
the other tests keep theirs) and writes its arrays to an ``.npz``:

- the bf16 model and prompts of tests/test_torch_disagg.py's bf16 rows
  (its tree, 16 prompts of 3-47 tokens), prefilled in decode mode:
  each module's input and output in layers 0 and 1 (``nn.
  intercept_methods``: the norms, qkv, the attention core before and
  after ``out``, ``in_proj``, gelu as ``out_proj``'s input,
  ``out_proj``, each block's residual sum), the attention's f32 scores
  and their softmax from layer 0's q/k, the cache's K/V rows and the
  last position's logits;
- ``nn.gelu`` on 4096 x 512 bf16 draws of N(0, 4);
- the bf16 ``MoeMlp`` (Switch and top-2, capacity 1.25) on seeded
  inputs: its output and aux.

The port's activations are taken by forward hooks. ``test_prefill_
stages`` prints the stage table and the first stage where the packages
part. The one stated difference is the order of the f32 sums inside a
bf16 product (XLA's CPU dot against torch's CPU GEMM; cuBLAS on the card
orders them otherwise again): the product's f32 result may differ in its
last bits and so, rounded to bf16, land one bf16 step away. It held:

- the first parting is at a product (``PRODUCTS``; on these prompts one
  of layer 0's 33,216 qkv elements, near 0);
- gelu parts nowhere its input agrees;
- each bf16 stage parts on at most ``PART_SHARE`` of its elements and
  the K/V rows on at most ``KV_SHARE``, by at most ``MAX_STEPS`` bf16
  steps (of the element, or of its row's rms where a sum cancelled);
- the logits within their f32 head product's own order bound, ``2
  gamma_d sum |h w| + 2^-23 |logit|`` (``head_bound``, ``gamma_d = d u /
  (1 - d u)``, u = 2^-24), plus what the final hidden rows' difference
  carries through the head (``|dh| @ |W|``).

The bf16 gelu is bitwise JAX's. The bf16 ``MoeMlp`` (its dispatch an
exact copy, its combine two exact products summed once) is held to the
same stated difference plus one more: gelu on the f32 ``h`` uses torch's
f32 tanh where XLA's CPU uses a rational approximation of it; the two
differ in the last f32 bit of ~30 % of elements, ~1 % after the bf16
cast of ``h``. Measured: top-2 bitwise, Switch 0.0122 % of outputs one
bf16 step away; held to ``MOE_STEPS`` steps on ``MOE_PART_SHARE``."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models import moe
from tf_operator_tpu_torch.models import transformer as tt
from tf_operator_tpu_torch.models.convert import flax_path, load_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_disagg.py's model, and 16 prompts.
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
          max_seq_len=64)
LENGTHS = (13, 9, 21, 30, 5, 17, 41, 8, 25, 33, 12, 19, 27, 3, 36, 47)
# One bf16 step of an element: 2^-7 of it at most (an 8-bit significand).
BF16_STEP = 2.0 ** -7
# Measured on these 16 prompts (the stage table the test prints): at most
# 1.0 % of a stage's elements and 0.04 % of the K/V rows part, by at most
# 1.78 bf16 steps.
PART_SHARE, KV_SHARE, MAX_STEPS = 2e-2, 1e-3, 2.0
MOE_STEPS = 2
MOE_PART_SHARE = 1e-3
MOE_CASES = ((1, 0), (2, 1))  # (router_top_k, seed)
MOE_DIMS = dict(n_experts=4, d_model=64, d_ff=128, capacity_factor=1.25)

# The JAX side: argv[1] is the .npz to write.
JAX_SCRIPT = r'''
import sys
from dataclasses import replace

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from tf_operator_tpu.models import moe
from tf_operator_tpu.models.transformer import (
    Transformer, TransformerConfig, _prefill)

KW, LENGTHS, MOE_CASES, MOE_DIMS = (
    {kw!r}, {lengths!r}, {cases!r}, {dims!r})
out = {{}}
cfg = TransformerConfig(dtype=jnp.bfloat16, **KW)
params = Transformer(cfg).init(
    jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["param|" + "/".join(k.key for k in path)] = np.asarray(leaf)
model = Transformer(replace(cfg, decode=True))


def stages(p, prompt):
    got = {{}}

    def grab(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and args:
            name = "/".join(context.module.path)
            got[name + ":in"], got[name + ":out"] = args[0], y
        return y

    with nn.intercept_methods(grab):
        cache, logits = _prefill(model, p, prompt)
    got["logits"] = logits
    for i in range(KW["n_layers"]):
        for part in ("cached_key", "cached_value"):
            got[f"block_{{i}}/{{part}}"] = cache[f"block_{{i}}"]["attn"][part]
    # Layer 0's scores and softmax, by the decode attention's formula.
    qkv = got["block_0/attn/qkv:out"]
    q, k = qkv[:, :, 0], qkv[:, :, 1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                   preferred_element_type=jnp.float32)
    s = s * (q.shape[-1] ** -0.5)
    t = q.shape[1]
    s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -1e30)
    got["block_0/attn/scores"] = s
    got["block_0/attn/probs"] = jax.nn.softmax(s, axis=-1)
    return {{k: v for k, v in got.items() if hasattr(v, "dtype")}}


run = jax.jit(stages)
for j, n in enumerate(LENGTHS):
    prompt = np.random.default_rng(40 + j).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)
    for name, val in run(params, jnp.asarray(prompt)).items():
        out[f"{{j}}|{{name}}"] = np.asarray(val.astype(jnp.float32))

x = np.random.default_rng(0).standard_normal((4096, 512)) * 2
out["gelu_x"] = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
out["gelu"] = np.asarray(jax.jit(nn.gelu)(
    jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))

for k, seed in MOE_CASES:
    mcfg = moe.MoeConfig(router_top_k=k, dtype=jnp.bfloat16, **MOE_DIMS)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (2, 64, MOE_DIMS["d_model"])), jnp.bfloat16)
    mlp = moe.MoeMlp(mcfg)
    p = mlp.init(jax.random.PRNGKey(seed), x)["params"]

    def fwd(p, x):
        y, col = mlp.apply({{"params": p}}, x, mutable=["losses"])
        return y, moe.aux_loss_from(col)

    y, aux = jax.jit(fwd)(p, x)
    for name in ("router", "w_in", "w_out"):
        out[f"moe{{k}}|{{name}}"] = np.asarray(p[name])
    out[f"moe{{k}}|x"] = np.asarray(x.astype(jnp.float32))
    out[f"moe{{k}}|y"] = np.asarray(y.astype(jnp.float32))
    out[f"moe{{k}}|aux"] = np.asarray(aux)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's arrays, from a subprocess without excess precision."""
    path = str(tmp_path_factory.mktemp("c1") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    script = JAX_SCRIPT.format(kw=KW, lengths=LENGTHS, cases=MOE_CASES,
                               dims=MOE_DIMS)
    done = subprocess.run([sys.executable, "-c", script, path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(np.load(path))


def _params(ref) -> dict:
    tree: dict = {}
    for key, val in ref.items():
        if key.startswith("param|"):
            node = tree
            parts = key.split("|", 1)[1].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
    return tree


def _port_stages(model, prompt) -> dict:
    """The port's activations under the names of the JAX side's."""
    got = {}

    def hook(name):
        def grab(mod, args, out):
            got[name + ":in"] = args[0]
            got[name + ":out"] = out[0] if isinstance(out, tuple) else out
        return grab

    handles = [mod.register_forward_hook(hook(
        "/".join(flax_path(name + ".x")[:-1])))
        for name, mod in model.named_modules() if name]
    try:
        with torch.no_grad():
            cache, logits = tt._prefill(model, torch.from_numpy(prompt))
    finally:
        for h in handles:
            h.remove()
    got["logits"] = logits
    for i, layer in enumerate(cache["layers"]):
        got[f"block_{i}/cached_key"] = layer["cached_key"]
        got[f"block_{i}/cached_value"] = layer["cached_value"]
    qkv = got["block_0/attn/qkv:out"]
    q, k = qkv[:, :, 0].float(), qkv[:, :, 1].float()
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = torch.where(torch.ones(t, t, dtype=torch.bool).tril(), s, -1e30)
    got["block_0/attn/scores"] = s
    got["block_0/attn/probs"] = torch.softmax(s, dim=-1)
    return {k: v.float().numpy() for k, v in got.items()}


# The stages in the order the forward reaches them.
STAGES = [f"block_{i}/{s}" for i in range(2) for s in (
    "RMSNorm_0:out", "attn/qkv:out", "cached_key", "cached_value",
    "attn/scores", "attn/probs", "attn/out:in", "attn/out:out",
    "RMSNorm_1:in", "RMSNorm_1:out", "mlp/in_proj:out", "mlp/out_proj:in",
    "mlp/out_proj:out", ":out")] + ["RMSNorm_0:out", "logits"]
STAGES = [s.replace("/:", ":") for s in STAGES
          if not (s.startswith("block_1/attn/") and ("scores" in s
                                                     or "probs" in s))]
BF16_STAGES = [s for s in STAGES if s != "logits"
               and not s.endswith(("scores", "probs"))]
# Where a parting may begin: a product whose f32 sums torch orders
# otherwise than XLA's dot (the one stated difference).
PRODUCTS = [s for s in STAGES if s.endswith((
    "qkv:out", "attn/out:in", "attn/out:out", "in_proj:out",
    "out_proj:out", "scores", "probs"))] + ["logits"]


def head_bound(hidden: np.ndarray, kernel: np.ndarray,
               logits: np.ndarray) -> np.ndarray:
    """Two f32 sums of the same d products in any orders differ by at
    most 2 gamma_d sum |h w|; the bias add after them by one rounding."""
    d = hidden.shape[-1]
    u = 2.0 ** -24
    gamma = d * u / (1 - d * u)
    mag = np.abs(hidden.astype(np.float64)) @ np.abs(kernel.astype(
        np.float64))
    return 2 * gamma * mag + 2 * u * np.abs(logits)


def test_prefill_stages(ref):
    params = _params(ref)
    kernel = params["lm_head"]["kernel"]
    model = load_params(tt.Transformer(tt.TransformerConfig(
        dtype=torch.bfloat16, decode=True, **KW), "cpu"), params)
    # stage -> [elements that differ, elements, largest difference in bf16
    # steps of the element (or of its row's rms where a sum cancelled)]
    table = {s: [0, 0, 0.0] for s in STAGES}
    for j, n in enumerate(LENGTHS):
        prompt = np.random.default_rng(40 + j).integers(
            0, KW["vocab_size"], (1, n)).astype(np.int32)
        got = _port_stages(model, prompt)
        parts = {}
        for stage in STAGES:
            want = ref[f"{j}|{stage}"]
            have = got[stage].reshape(want.shape)
            err = np.abs(have - want)
            parts[stage] = err > 0
            row = np.sqrt(np.mean(want.astype(np.float64) ** 2, -1,
                                  keepdims=True))
            steps = err / np.maximum(
                BF16_STEP * np.maximum(np.abs(want), row), 1e-30)
            table[stage][0] += int(parts[stage].sum())
            table[stage][1] += err.size
            table[stage][2] = max(table[stage][2], float(steps.max()))
        # gelu parts nowhere its input agrees.
        for i in range(KW["n_layers"]):
            gelu_in = parts[f"block_{i}/mlp/in_proj:out"]
            assert not (parts[f"block_{i}/mlp/out_proj:in"] & ~gelu_in).any()
        # The head adds no parting beyond its sums' order: the logits
        # within head_bound plus what the hidden rows' difference carries.
        hidden = got["RMSNorm_0:out"].reshape(1, n, -1)[:, -1]
        dh = np.abs(hidden - ref[f"{j}|RMSNorm_0:out"][:, -1])
        want = ref[f"{j}|logits"]
        assert (np.abs(got["logits"].reshape(want.shape) - want) <= head_bound(
            hidden, kernel, want) + dh @ np.abs(kernel)).all(), j
    lines = [f"{s:28s} {d:6d} / {n:6d} differ, at most {m:.3g} bf16 steps"
             for s, (d, n, m) in table.items()]
    parted = [s for s in STAGES if table[s][0]]
    report = "\n".join(lines + ["first stage where the packages part: "
                                + (parted[0] if parted else "none")])
    print(report)
    assert not parted or parted[0] in PRODUCTS, report
    for stage in BF16_STAGES:
        differ, count, steps = table[stage]
        share = KV_SHARE if stage.endswith(("_key", "_value")) else PART_SHARE
        assert differ <= share * count, f"{stage}\n{report}"
        assert steps <= MAX_STEPS, f"{stage}\n{report}"


def test_bf16_gelu_is_bitwise_jax(ref):
    x = torch.from_numpy(ref["gelu_x"]).bfloat16()
    got = tt.gelu(x).float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  ref["gelu"].view(np.uint32))


def test_rounded_gelu_gradient_is_the_derivative():
    """The bf16 gelu's backward: the tanh form's derivative in f32,
    rounded once; against float64 autograd of the formula. Past |x| ~ 5
    f32's tanh rounds to -1 and the derivative (under 4e-6 there) reads
    0: the absolute term."""
    x = torch.linspace(-6, 6, 4097, dtype=torch.float64)
    xb = x.bfloat16().requires_grad_()
    tt.gelu(xb).sum().backward()
    xd = xb.detach().double().requires_grad_()
    c = math.sqrt(2 / math.pi)
    (xd * 0.5 * (1 + torch.tanh(c * (xd + 0.044715 * xd ** 3)))).sum(
    ).backward()
    err = (xb.grad.double() - xd.grad).abs()
    assert xb.grad.dtype == torch.bfloat16
    assert (err <= BF16_STEP * xd.grad.abs() + 4e-6).all()


@pytest.mark.parametrize("k,seed", MOE_CASES, ids=["switch", "top2"])
def test_bf16_moe_mlp_against_jax(ref, k, seed):
    cfg = moe.MoeConfig(router_top_k=k, dtype=torch.bfloat16, **MOE_DIMS)
    m = moe.MoeMlp(cfg, device="cpu")
    with torch.no_grad():
        for name in ("router", "w_in", "w_out"):
            getattr(m, name).copy_(torch.from_numpy(ref[f"moe{k}|{name}"]))
        x = torch.from_numpy(ref[f"moe{k}|x"]).bfloat16()
        y, aux = m(x)
    want = ref[f"moe{k}|y"]
    got = y.float().numpy()
    assert y.dtype == torch.bfloat16
    err = np.abs(got - want)
    scale = np.abs(want).max()
    parted = err > 0
    assert (err <= MOE_STEPS * BF16_STEP * np.maximum(
        np.abs(want), BF16_STEP * scale)).all(), err.max()
    assert parted.mean() <= MOE_PART_SHARE, parted.mean()
    assert abs(float(aux) - float(ref[f"moe{k}|aux"])) <= 1e-5 * float(
        ref[f"moe{k}|aux"])
    print(f"bf16 MoeMlp k={k}: {parted.mean():.4%} of outputs part from "
          f"JAX's, max {err.max():.3g}")

