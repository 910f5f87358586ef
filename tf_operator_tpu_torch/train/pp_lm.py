"""Pipeline-parallel transformer LM training over the block stack
(GPipe and 1F1B schedules).

Counterpart of ``tf_operator_tpu/train/pp_lm.py``. The transformer's own
block stack becomes the pipeline (``parallel/pipeline.py``):

- embed + positions run OUTSIDE the pipeline, as does the final norm +
  chunked-xent head, so the stages are homogeneous: ``pp`` stages of ``k =
  n_layers / pp`` blocks each.
- JAX holds the tree ``{"outer": ..., "stages": ...}`` (``split_pp_params``:
  block leaves stacked ``[pp, k, ...]``) with the stages sharded over
  ``pp`` and the outer params replicated (``pp_param_shardings``). The
  port runs one process a device: a rank holds its part (``pp_model``), a
  ``Transformer`` of ``k`` blocks, its stage's, beside a copy of the outer
  params, built from ``_stage_cfg`` (no mesh, no remat, dense blocks: JAX's
  stage ``Block``); ``cfg.remat`` checkpoints each block in the stage
  function, as JAX wraps each block apply.
- the rows follow JAX's layout, ``[M, mb, ...]`` with the ``mb`` dim over
  the data axis: data rank ``d`` takes its slice of EVERY microbatch
  (``pp_rows``), and the ranks are laid out in JAX's mesh order (``pp``
  before ``dp``).
- schedule ``"gpipe"``: autograd through ``pipeline.gpipe``; every rank
  computes the norm and the loss over the whole unmicrobatched batch from
  its copy of the outputs, and its backward counts ``1 / (pp * dp)`` of
  it (the pipeline sums the stages' cotangents and the data ranks' stage
  gradients). ``"1f1b"``: ``pipeline.one_f_one_b`` with the norm, head and
  loss as ``last_fn`` inside the schedule, the embedding's backward
  outside it from the broadcast ``d_microbatches``.

The outer params' gradients are summed from the ranks that produced them
(GPipe: over ``pp`` and the data axis; 1F1B: the engine sums the head's,
the embedding's over the data axis), so every rank's AdamW moves its copy
alike. ``make_pp_lm_train_step``'s step takes this rank's rows
(``pp_rows``) and updates the state in place, as the port's other steps
do; its ``stash_mark`` is the last 1F1B step's stash high-water mark.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch.models.convert import load_params
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from tf_operator_tpu_torch.parallel.mesh import Mesh
from tf_operator_tpu_torch.parallel.pipeline import (
    Stage,
    gpipe,
    microbatch,
    one_f_one_b,
    sum_over,
    unmicrobatch,
)
from tf_operator_tpu_torch.train.steps import TrainState, chunked_lm_xent

OUTER_KEYS = ("embed", "pos", "RMSNorm_0", "lm_head")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(xs: list) -> Any:
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _stack_trees(trees: list) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return _stack(trees)


def split_pp_params(params: Any, n_layers: int, pp: int) -> tuple[Any, Any]:
    """Standard Transformer param tree -> (outer, stages).

    outer: embed/pos/final-norm/head subtrees, unchanged.
    stages: block params stacked to leaves [pp, k, ...] (stage-major,
    layer order preserved: stage s holds blocks s*k .. s*k+k-1).
    """
    if n_layers % pp:
        raise ValueError(f"n_layers={n_layers} not divisible by pp={pp}")
    k = n_layers // pp
    missing = [f"block_{i}" for i in range(n_layers)
               if f"block_{i}" not in params]
    if missing:
        raise ValueError(f"params missing {missing}")
    outer = {key: params[key] for key in OUTER_KEYS}
    stage_trees = [_stack_trees([params[f"block_{s * k + j}"]
                                 for j in range(k)]) for s in range(pp)]
    return outer, _stack_trees(stage_trees)


def _leading(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def merge_pp_params(outer: Any, stages: Any, n_layers: int) -> Any:
    """(outer, stages) -> the standard Transformer tree (for checkpoints
    / serving / decode interop)."""
    pp = _leading(stages) if stages else 1
    k = n_layers // pp
    params = dict(outer)
    for s in range(pp):
        stage = _map(lambda a, s=s: a[s], stages)
        for j in range(k):
            params[f"block_{s * k + j}"] = _map(lambda a, j=j: a[j], stage)
    return params


def _stage_cfg(cfg: TransformerConfig, pp: int) -> TransformerConfig:
    """A stage rank's model: its k blocks beside the outer params. Each
    stage is single-device code (no mesh); remat is applied by the stage
    function around each block; the blocks are dense, as JAX's stage
    ``Block`` is."""
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    return replace(cfg, mesh=None, remat=False, n_layers=cfg.n_layers // pp,
                   moe_every_n=None)


@dataclass
class Pipeline:
    """What a stage rank's model knows of the pipelined LM: the whole
    model's config and this rank's ``Stage``."""

    cfg: TransformerConfig
    stage: Stage


def pp_model(cfg: TransformerConfig, mesh: Mesh, pp_params: Any, *,
             pp_axis: str = "pp", batch_axis: str | None = "dp",
             device=None) -> Transformer:
    """This rank's part of the pipelined LM from JAX's tree ``{"outer":
    ..., "stages": ...}`` (``split_pp_params``; numpy arrays or tensors): a
    training ``Transformer`` of its stage's ``k`` blocks (``block_j`` is
    block ``stage * k + j`` of the whole) and the outer params, with
    ``model.pipeline`` (``Pipeline``) set."""
    stage = Stage.of(mesh, pp_axis, _data_axis(mesh, batch_axis))
    scfg = _stage_cfg(cfg, stage.size)
    if _leading(pp_params["stages"]) != stage.size:
        raise ValueError(
            f"stage_params leading dim {_leading(pp_params['stages'])} != "
            f"{pp_axis} axis size {stage.size}")
    tree = dict(pp_params["outer"])
    mine = _map(lambda a: a[stage.index], pp_params["stages"])
    for j in range(scfg.n_layers):
        tree[f"block_{j}"] = _map(lambda a, j=j: a[j], mine)
    model = load_params(Transformer(scfg, device), tree)
    model.pipeline = Pipeline(cfg, stage)
    return model


def _data_axis(mesh: Mesh, batch_axis: str | None) -> str | None:
    return (batch_axis if batch_axis and mesh.shape.get(batch_axis, 1) > 1
            else None)


def pp_rows(mesh: Mesh, batch: dict, num_micro: int,
            batch_axis: str | None = "dp") -> dict:
    """This rank's rows of a GLOBAL batch of ``[B, ...]`` arrays in JAX's
    layout: the batch cut into ``num_micro`` microbatches, of each this
    rank's slice over ``batch_axis`` (``P(None, batch_axis)``), the slices
    in microbatch order, placed on the mesh's device."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.sharding import shard_batch

    axis = _data_axis(mesh, batch_axis)
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = mesh.members((axis,), rank) if axis else [rank]
    n, d = len(ranks), ranks.index(rank)

    def cut(x):
        mb = microbatch(torch.as_tensor(np.asarray(x)), num_micro)
        if mb.shape[1] % n:
            raise ValueError(f"microbatch {mb.shape[1]} not divisible by "
                             f"{axis}={n}")
        r = mb.shape[1] // n
        return unmicrobatch(mb[:, d * r:(d + 1) * r])

    return shard_batch(mesh, {k: cut(v) for k, v in batch.items()})


def _make_stage_fn(cfg: TransformerConfig):
    """One pipeline stage: the stage model's k blocks applied in order;
    remat per block when the model asks for it."""

    def stage_fn(model: Transformer, x: torch.Tensor) -> torch.Tensor:
        for block in model.blocks:
            if cfg.remat:
                x, _ = checkpoint(block, x, use_reentrant=False)
            else:
                x, _ = block(x)
        return x

    return stage_fn


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return model.embed(tokens) + model.pos(positions[None, :])


def _stage_leaves(model: Transformer) -> list:
    return list(model.blocks.parameters())


def _outer(model: Transformer) -> list:
    return [model.embed.weight, model.pos.weight, model.norm.scale,
            model.lm_head.kernel, model.lm_head.bias]


def _check(model: Transformer, what: str) -> Pipeline:
    pipe = getattr(model, "pipeline", None)
    if pipe is None:
        raise ValueError(f"{what}: build the model with pp_model")
    return pipe


def make_pp_lm_forward(
    cfg: TransformerConfig,
    mesh: Mesh,
    *,
    num_micro: int,
    pp_axis: str = "pp",
    batch_axis: str | None = "dp",
    xent_chunk: int | None = None,
):
    """Returns loss_fn(model, tokens, targets) -> scalar loss.

    The full pipelined forward + chunked-xent loss of this rank's rows
    (``pp_rows``) over its stage model (``pp_model``), the same on every
    stage; differentiable through the GPipe schedule (a loss every stage
    computes counts ``1 / pp`` on each: ``parallel/pipeline.py``). The
    global loss is its mean over the data axis.
    """
    stage_fn = _make_stage_fn(cfg)

    def loss_fn(model, tokens, targets):
        pipe = _check(model, "make_pp_lm_forward")
        tokens = torch.as_tensor(tokens).to(model.device)
        targets = torch.as_tensor(targets).to(model.device)
        T = tokens.shape[1]
        x = _embed(model, tokens)
        out = gpipe(pipe.stage, stage_fn, model, _stage_leaves(model),
                    microbatch(x, num_micro))
        y = model.norm(unmicrobatch(out))
        head = model.lm_head
        return chunked_lm_xent(y, head.kernel, head.bias, targets,
                               chunk=xent_chunk or min(512, T))

    return loss_fn


def make_pp_lm_train_step(
    cfg: TransformerConfig,
    mesh: Mesh,
    tx,
    *,
    num_micro: int,
    pp_axis: str = "pp",
    batch_axis: str | None = "dp",
    xent_chunk: int | None = None,
    schedule: str = "gpipe",
):
    """(state, batch) -> (state, metrics) for the pipelined LM.

    ``state.model`` is this rank's ``pp_model``; ``batch`` is
    ``{"tokens", "targets"}``, this rank's rows (``pp_rows``).

    schedule:
      "gpipe" — autograd through the pipeline: all forwards, then all
        backwards; each stage keeps num_micro microbatches' graphs.
      "1f1b"  — ``pipeline.one_f_one_b``: interleaved schedule with an
        O(pp) stash of inputs, so num_micro can grow (shrinking the
        (pp-1)/num_micro bubble) without growing memory.
    """
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule {schedule!r}: want 'gpipe' or '1f1b'")
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    data_axis = _data_axis(mesh, batch_axis)
    n_pp, n_dp = mesh.shape[pp_axis], mesh.shape.get(data_axis, 1)
    # The outer gradients' sum: over pp and dp (GPipe), over dp (1F1B).
    over = TensorParallel(mesh, (pp_axis, data_axis) if data_axis
                          else pp_axis)
    over_dp = TensorParallel(mesh, data_axis) if data_axis else None
    stage_fn = _make_stage_fn(cfg)
    loss_fn = make_pp_lm_forward(cfg, mesh, num_micro=num_micro,
                                 pp_axis=pp_axis, batch_axis=batch_axis,
                                 xent_chunk=xent_chunk)

    def last_fn(model, y, tgt):
        y = model.norm(y)
        head = model.lm_head
        return chunked_lm_xent(y, head.kernel, head.bias, tgt,
                               chunk=xent_chunk or min(512, y.shape[-2]))

    def sum_grads(axis, params) -> None:
        for p in params:
            if p.grad is None:  # a rank that did not produce it adds 0
                p.grad = torch.zeros_like(p)
        sum_over(axis, [p.grad for p in params])

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        pipe = _check(model, "make_pp_lm_train_step")
        tokens = torch.as_tensor(batch["tokens"]).to(model.device)
        targets = torch.as_tensor(batch["targets"]).to(model.device)
        opt.zero_grad(set_to_none=True)
        if schedule == "gpipe":
            loss = loss_fn(model, tokens, targets)
            (loss * (1.0 / (n_pp * n_dp))).backward()
            sum_grads(over, _outer(model))
            loss = loss.detach()
            if over_dp is not None:
                loss = over_dp.all_reduce_(loss.clone()) / n_dp
        else:
            x_mb = microbatch(_embed(model, tokens), num_micro)
            last = [model.norm.scale, model.lm_head.kernel,
                    model.lm_head.bias]
            stage_leaves = _stage_leaves(model)
            loss, gp, gl, dx, step.stash_mark = one_f_one_b(
                pipe.stage, stage_fn, model, stage_leaves, last_fn, model,
                last, x_mb.detach(), microbatch(targets, num_micro))
            x_mb.backward(dx.to(x_mb.dtype))
            for p, g in zip(stage_leaves + last, gp + gl):
                p.grad = g
            sum_grads(over_dp, [model.embed.weight, model.pos.weight])
        lr = tx.learning_rate(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {"loss": loss}

    step.stash_mark = 0
    return step
