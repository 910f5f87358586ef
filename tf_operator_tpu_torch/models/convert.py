"""flax variable trees <-> the port's models: the ``Transformer`` and the
image classifiers (``ResNet``, ``MnistCNN``).

The JAX model's parameters are a nested dict (``model.init(...)
["params"]``); as numpy arrays it needs no JAX to read. Its layout:

- top level: ``embed/embedding [V, d]``, ``pos/embedding [S, d]``,
  ``RMSNorm_0/scale [d]`` (the final norm), ``lm_head/{kernel [d, V],
  bias [V]}``;
- ``block_i``: ``RMSNorm_0/scale`` (before attention), ``RMSNorm_1/scale``
  (before the MLP), ``attn/qkv/{kernel [d, 3, H, Dh], bias}`` (MHA) or
  ``attn/q/{kernel [d, H, Dh], bias}`` and ``attn/kv/{kernel
  [d, 2, KV, Dh], bias}`` (GQA), ``attn/out/{kernel [H, Dh, d], bias}``,
  ``mlp/in_proj`` and ``mlp/out_proj`` ``{kernel, bias}``, or in an MoE
  block (``moe_every_n``) ``moe/{router [d, E], w_in [E, d, f], w_out
  [E, f, d]}`` in place of ``mlp``.

The port keeps these layouts, so loading is a copy per leaf after a
check of names and shapes, into a decode-mode model (weights in its
dtype) or a training-mode one (f32 trainable weights) alike;
``export_params`` reads a model back out as such a tree. ``init_params``
builds one from a seed with numpy alone, so a machine without JAX can
run the model. ``quantize_decode_params`` turns a tree into the int8
tree an ``int8_decode`` model loads: every projection and the head as
``{kernel_q int8 [k, n], scale f32 [n], bias f32 [n]}``.

The classifiers' trees are flax's ``{"params", "batch_stats"}``
variables, with the flax names as the models' attribute names, so a
parameter's dotted name is its path. Conv kernels are HWIO in flax and
OIHW in the port (``channels_last`` memory): ``load_variables`` and
``export_variables`` transpose them, once, and every other leaf (BN
``scale``/``bias`` and ``mean``/``var``, ``[in, out]`` Dense kernels,
biases) keeps its layout. ``init_variables`` makes a seeded numpy tree
with flax's inits.

``variable_layout`` is the one place that knows each model family's
tree: any port model's leaves by flax path, with the per-leaf maps to
and from flax's layout. ``load_variables``, ``export_variables``,
``variable_shapes`` and the checkpoint layer read every model through
it; each model's ``shape_fields()`` is what fixes its shapes.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping
from typing import Any, NamedTuple

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
        shapes[(blk, "RMSNorm_0", "scale")] = (d,)
        shapes[(blk, "RMSNorm_1", "scale")] = (d,)
        groups = [("attn", attn)]
        if cfg.uses_moe(i):
            e = cfg.moe_experts
            shapes[(blk, "moe", "router")] = (d, e)
            shapes[(blk, "moe", "w_in")] = (e, d, f)
            shapes[(blk, "moe", "w_out")] = (e, f, d)
        else:
            groups.append(("mlp", {"in_proj": ((d, f), (f,)),
                                   "out_proj": ((f, d), (d,))}))
        for group, dense in groups:
            for name, (kshape, bshape) in dense.items():
                shapes[(blk, group, name, "kernel")] = kshape
                shapes[(blk, group, name, "bias")] = bshape
    return shapes


def init_params(cfg: TransformerConfig, seed: int) -> dict:
    """A seeded random tree in the flax layout, made with numpy: kernels
    normal with variance 1/fan_in (fan_in = the product of the input
    axes; for the MoE leaves every axis but the last, as flax's
    ``lecun_normal`` counts a 3-D kernel: ``d`` for the router, ``E * d``
    for ``w_in``, ``E * f`` for ``w_out``), embeddings normal with
    variance 1/d_model (flax's embed init), biases 0, norm scales 1. f32
    arrays."""
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
            elif path[-2] == "out" or path[-2] == "moe":
                fan_in = math.prod(shape[:-1])  # [H, Dh, d], [E, d, f]
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
    the position table and norms pass through, and so do the MoE leaves
    (``moe/{router, w_in, w_out}``: an ``int8_decode`` model runs its
    expert MLPs in its dtype, as JAX's does). numpy arrays out."""

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
                out[name] = dict(sub)
            elif (name in _INT8_TARGETS and isinstance(sub, Mapping)
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


# flax's variance_scaling "truncated_normal": a normal cut at two standard
# deviations, rescaled by this factor so its variance is scale / fan_in.
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.Generator, shape, scale: float,
                      fan_in: int) -> np.ndarray:
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    he-normal at scale 2, lecun-normal at scale 1. Draws outside [-2, 2]
    are drawn again."""
    z = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(z) > 2
    return z * np.float32(math.sqrt(scale / fan_in) / _TRUNC_STD)


def _nest(flat: Mapping) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def init_variables(model, seed: int) -> dict:
    """A seeded random classifier tree in flax's layout, made with numpy,
    with flax's inits: ResNet convs he-normal, its BN scales 1 but each
    block's last (``BatchNorm_2``) 0, BN biases 0, running means 0 and
    variances 1, the head's kernel and bias 0; MnistCNN's convs and
    denses lecun-normal with zero biases. f32 arrays, as
    ``{"params", "batch_stats"}`` (the latter empty for MnistCNN)."""
    shapes = variable_shapes(model)
    resnet = model.shape_fields()["model"] == "ResNet"
    rng = np.random.default_rng(seed)
    params = {}
    for path, shape in shapes["params"].items():
        leaf = path[-1]
        if leaf == "bias" or (resnet and path[0] == "Dense_0"):
            arr = np.zeros(shape, np.float32)
        elif leaf == "scale":
            fill = 0.0 if path[-2] == "BatchNorm_2" else 1.0
            arr = np.full(shape, fill, np.float32)
        else:
            fan_in = math.prod(shape[:-1])
            arr = _truncated_normal(rng, shape, 2.0 if resnet else 1.0,
                                    fan_in)
        params[path] = arr
    stats = {path: (np.zeros if path[-1] == "mean" else np.ones)(
        shape, np.float32) for path, shape in shapes["batch_stats"].items()}
    return {"params": _nest(params), "batch_stats": _nest(stats)}


def to_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """A classifier leaf in flax's layout: a conv kernel OIHW -> HWIO (a
    view), any other leaf as it is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def from_flax_layout(t: torch.Tensor) -> torch.Tensor:
    """A flax classifier leaf in the port's layout: a conv kernel HWIO ->
    OIHW (a view), any other leaf as it is."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class Layout(NamedTuple):
    """A port model's variables by flax path: ``leaves`` is
    ``{"params": {path: parameter}, "batch_stats": {path: buffer}}`` in
    the port's layout, and ``to_flax``/``from_flax`` map one leaf (or a
    per-parameter optimiser tensor) between that layout and flax's."""

    leaves: dict
    to_flax: Callable[[torch.Tensor], torch.Tensor]
    from_flax: Callable[[torch.Tensor], torch.Tensor]


def variable_layout(model: torch.nn.Module) -> Layout:
    """The ``Layout`` of any port model: the ``Transformer``'s flax paths
    (``flax_path``; its layouts are flax's and it has no BatchNorm), or a
    classifier's, whose dotted names are its flax paths and whose conv
    kernels are OIHW."""
    if isinstance(model, Transformer):
        return Layout({"params": {flax_path(n): p
                                  for n, p in model.named_parameters()},
                       "batch_stats": {}}, _same, _same)
    return Layout({"params": {tuple(n.split(".")): p
                              for n, p in model.named_parameters()},
                   "batch_stats": {tuple(n.split(".")): b
                                   for n, b in model.named_buffers()}},
                  to_flax_layout, from_flax_layout)


def variable_shapes(model: torch.nn.Module) -> dict:
    """``{"params": {path: shape}, "batch_stats": {path: shape}}`` of a
    model in flax's layout and names: what ``model.init`` gives in JAX."""
    leaves, to_flax, _ = variable_layout(model)
    return {coll: {path: tuple(to_flax(t).shape) for path, t in flat.items()}
            for coll, flat in leaves.items()}


def load_variables(model: torch.nn.Module, variables: Mapping
                   ) -> torch.nn.Module:
    """Copy a flax tree ``{"params", "batch_stats"}`` (numpy arrays or
    tensors; ``batch_stats`` may be absent for a model without BatchNorm)
    into ``model``, each leaf cast to its tensor's dtype and, for a
    classifier, conv kernels transposed HWIO -> OIHW. Raises
    ``ValueError`` on a missing, unexpected or misshapen leaf."""
    leaves, to_flax, from_flax = variable_layout(model)
    for coll, want in leaves.items():
        given = dict(_leaves(variables.get(coll, {})))
        missing = sorted("/".join(p) for p in want.keys() - given.keys())
        extra = sorted("/".join(p) for p in given.keys() - want.keys())
        if missing or extra:
            raise ValueError(
                f"{coll} tree does not match the model: missing {missing}, "
                f"unexpected {extra}")
        for path, dst in want.items():
            src = from_flax(_as_tensor(given[path]))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{coll}/{'/'.join(path)}: shape "
                    f"{tuple(to_flax(src).shape)}, the model wants "
                    f"{tuple(to_flax(dst).shape)}")
            dst.data.copy_(src.to(device=dst.device, dtype=dst.dtype))
    return model


def export_variables(model: torch.nn.Module) -> dict:
    """The model's ``{"params", "batch_stats"}`` as flax-layout trees of
    f32 numpy arrays: the inverse of ``load_variables``."""
    leaves, to_flax, _ = variable_layout(model)
    return {coll: _nest({
        path: to_flax(t.detach()).float().cpu().contiguous().numpy()
        for path, t in flat.items()})
        for coll, flat in leaves.items()}
