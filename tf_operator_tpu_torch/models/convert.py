"""flax ``params`` tree <-> the port's ``Transformer`` state.

The JAX model's parameters are a nested dict (``model.init(...)
["params"]``); as numpy arrays it needs no JAX to read. Its layout:

- top level: ``embed/embedding [V, d]``, ``pos/embedding [S, d]``,
  ``RMSNorm_0/scale [d]`` (the final norm), ``lm_head/{kernel [d, V],
  bias [V]}``;
- ``block_i``: ``RMSNorm_0/scale`` (before attention), ``RMSNorm_1/scale``
  (before the MLP), ``attn/qkv/{kernel [d, 3, H, Dh], bias}`` (MHA) or
  ``attn/q/{kernel [d, H, Dh], bias}`` and ``attn/kv/{kernel
  [d, 2, KV, Dh], bias}`` (GQA), ``attn/out/{kernel [H, Dh, d], bias}``,
  ``mlp/in_proj`` and ``mlp/out_proj`` ``{kernel, bias}``.

The port keeps these layouts, so loading is a copy per leaf after a
check of names and shapes, into a decode-mode model (weights in its
dtype) or a training-mode one (f32 trainable weights) alike;
``export_params`` reads a model back out as such a tree. ``init_params``
builds one from a seed with numpy alone, so a machine without JAX can
run the model. ``quantize_decode_params`` turns a tree into the int8
tree an ``int8_decode`` model loads: every projection and the head as
``{kernel_q int8 [k, n], scale f32 [n], bias f32 [n]}``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from tf_operator_tpu_torch.ops.int8_dense import quantize_int8

_RENAME = {"norm": "RMSNorm_0", "norm_attn": "RMSNorm_0",
           "norm_mlp": "RMSNorm_1", "weight": "embedding"}


def flax_path(name: str) -> tuple[str, ...]:
    """The flax tree path of a port parameter name, e.g.
    ``blocks.0.norm_mlp.scale`` -> ``("block_0", "RMSNorm_1", "scale")``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"block_{parts[1]}"] + parts[2:]
    return tuple(_RENAME.get(p, p) for p in parts)


def param_shapes(cfg: TransformerConfig) -> dict[tuple[str, ...], tuple]:
    """``{flax path: shape}`` of every leaf of the config's tree."""
    d, h, dh, kv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads
    v, f = cfg.vocab_size, cfg.d_ff
    shapes = {
        ("embed", "embedding"): (v, d),
        ("pos", "embedding"): (cfg.max_seq_len, d),
        ("RMSNorm_0", "scale"): (d,),
        ("lm_head", "kernel"): (d, v),
        ("lm_head", "bias"): (v,),
    }
    for i in range(cfg.n_layers):
        blk = f"block_{i}"
        attn = {"out": ((h, dh, d), (d,))}
        if cfg.n_kv_heads is None:
            attn["qkv"] = ((d, 3, h, dh), (3, h, dh))
        else:
            attn["q"] = ((d, h, dh), (h, dh))
            attn["kv"] = ((d, 2, kv, dh), (2, kv, dh))
        mlp = {"in_proj": ((d, f), (f,)), "out_proj": ((f, d), (d,))}
        shapes[(blk, "RMSNorm_0", "scale")] = (d,)
        shapes[(blk, "RMSNorm_1", "scale")] = (d,)
        for group, dense in (("attn", attn), ("mlp", mlp)):
            for name, (kshape, bshape) in dense.items():
                shapes[(blk, group, name, "kernel")] = kshape
                shapes[(blk, group, name, "bias")] = bshape
    return shapes


def init_params(cfg: TransformerConfig, seed: int) -> dict:
    """A seeded random tree in the flax layout, made with numpy: kernels
    normal with variance 1/fan_in (fan_in = the product of the input
    axes), embeddings normal with variance 1/d_model (flax's embed
    init), biases 0, norm scales 1. f32 arrays."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in param_shapes(cfg).items():
        leaf = path[-1]
        if leaf == "bias":
            arr = np.zeros(shape, np.float32)
        elif leaf == "scale":
            arr = np.ones(shape, np.float32)
        else:
            if leaf == "embedding":
                fan_in = shape[1]
            elif path[-2] == "out":
                fan_in = shape[0] * shape[1]  # [H, Dh, d]
            else:
                fan_in = shape[0]
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= np.float32(1.0 / math.sqrt(fan_in))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


# The projections quantize_decode_params turns into int8 (the flax module
# names; qkv/q/kv/out are the attention's).
_INT8_TARGETS = ("qkv", "q", "kv", "out", "in_proj", "out_proj", "lm_head")


def quantize_decode_params(params: Mapping) -> dict:
    """A flax-layout tree -> the tree ``int8_decode=True`` loads, leaf for
    leaf JAX's ``quantize_decode_params``: each projection kernel reshaped
    to 2-D ``[k, n]`` (``qkv``/``q``/``kv`` ``[d, ...]`` to ``[d, prod]``,
    ``out`` ``[H, Dh, d]`` to ``[H*Dh, d]``) and quantized per output
    channel (``quantize_int8``), its bias flattened to f32; embeddings,
    the position table and norms pass through. numpy arrays out. An MoE
    tree raises: MoE is not ported (ROADMAP.md A9)."""

    def quant(name: str, sub: Mapping) -> dict:
        kern = _as_tensor(sub["kernel"]).detach().float().cpu()
        if name in ("qkv", "q", "kv"):
            kern = kern.reshape(kern.shape[0], -1)
        elif name == "out":
            kern = kern.reshape(-1, kern.shape[-1])
        w_q, scale = quantize_int8(kern)
        bias = _as_tensor(sub["bias"]).detach().float().cpu().reshape(-1)
        return {"kernel_q": w_q.numpy(), "scale": scale.numpy(),
                "bias": bias.numpy()}

    def walk(tree: Mapping) -> dict:
        out = {}
        for name, sub in tree.items():
            if name == "moe":
                raise NotImplementedError(
                    "quantize_decode_params: MoE is not ported yet: see "
                    "ROADMAP.md A9 (ResNet, MNIST and MoE)")
            if (name in _INT8_TARGETS and isinstance(sub, Mapping)
                    and "kernel" in sub):
                out[name] = quant(name, sub)
            elif isinstance(sub, Mapping):
                out[name] = walk(sub)
            else:
                out[name] = sub
        return out

    return walk(params)


def _leaves(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _as_tensor(arr: Any) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    # f32 is exact for bf16 and int8 leaves (numpy has no bf16 of its own).
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def load_params(model: Transformer, params: Mapping) -> Transformer:
    """Copy a flax-layout tree (numpy arrays or tensors) into ``model``,
    cast to each parameter's dtype. Raises ``ValueError`` on a missing,
    unexpected or misshapen leaf."""
    leaves = dict(_leaves(params))
    want = {flax_path(n): p for n, p in model.named_parameters()}
    missing = sorted("/".join(p) for p in want.keys() - leaves.keys())
    extra = sorted("/".join(p) for p in leaves.keys() - want.keys())
    if missing or extra:
        raise ValueError(
            f"param tree does not match the model: missing {missing}, "
            f"unexpected {extra}"
        )
    for path, p in want.items():
        src = _as_tensor(leaves[path])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"{'/'.join(path)}: shape {tuple(src.shape)}, the model "
                f"wants {tuple(p.shape)}"
            )
        p.data.copy_(src.to(device=p.device, dtype=p.dtype))
    return model


def export_params(model: Transformer) -> dict:
    """The model's weights as a flax-layout tree of f32 numpy arrays: the
    inverse of ``load_params``."""
    tree: dict = {}
    for name, p in model.named_parameters():
        path = flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().float().cpu().numpy()
    return tree
