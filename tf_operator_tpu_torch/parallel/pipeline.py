"""Pipeline parallelism over a mesh axis: GPipe and 1F1B schedules.

Counterpart of ``tf_operator_tpu/parallel/pipeline.py``. JAX holds the
stage parameters as leaves ``[S, ...]`` sharded over the ``pp`` axis and
drives every stage in lockstep inside one ``shard_map``; the port runs one
process a device, so each rank runs ITS stage, the index ``stage`` of the
mesh's ``pp`` axis, and an activation hops to the next stage (its
cotangent to the previous one) point to point over
``TensorParallel(mesh, "pp").exchange``. Under gloo a tensor on the card
is staged through the host and counted in ``sharding.staged_bytes``.

- ``pipeline_apply`` is the GPipe forward, differentiable: stage 0
  ingests microbatch ``t`` at tick ``t`` and stage ``s`` works on
  microbatch ``t - s``, JAX's ``lax.scan`` schedule, with no tick spent on
  a masked microbatch. Every rank keeps each microbatch's graph until the
  backward, which runs the microbatches in reverse order on every stage
  (so the cotangent hops up the pipe in one fixed order). The last
  stage's outputs reach every stage (JAX's masked ``psum``), and the
  backward of that broadcast is a reduce: the cotangents of the ranks'
  copies are summed onto the last stage. A replicated output's cotangent
  counts once in JAX (``shard_map`` divides it by the axis size before
  the ``psum``), so a loss that every stage computes from its copy counts
  ``1 / S`` on each rank.
- ``pipeline_value_and_grad`` is the 1F1B engine, JAX's tick arithmetic:
  microbatch ``i`` enters stage ``s`` at tick ``s + i`` and leaves it (its
  cotangent) at tick ``2S - 1 - s + i``, ``M + 2S - 1`` ticks in all. A
  stage keeps the INPUTS of the microbatches in flight (at most ``2S -
  1``; ``run.stash_mark`` is the last call's high-water mark), never their
  graphs: each backward tick recomputes the stage forward from the stashed
  input and pulls the cotangent back through it. The loss head
  (``last_fn``) runs in the schedule on the last stage, its vjp seeded by
  ``1 / (M * dp)``. In a tick where a rank both sends an activation down
  and a cotangent up, both go in one exchange, receives posted first; a
  rank sends only what a neighbour reads (JAX's ring wraps round, but the
  wrapped values are never used).

With ``batch_axis`` each data-parallel group runs a pipeline of its own on
its slice of every microbatch (``[M, mb / dp, ...]``, JAX's ``P(None,
batch_axis)``), and the stage parameters' gradients are summed over it.

``stage_params`` is JAX's stage-stacked tree (dicts, lists and tuples of
tensors with a leading stage dim ``S``), of which each rank runs its row;
``microbatch``/``unmicrobatch`` reshape ``[batch, ...]`` to ``[M, mb,
...]`` and back. The pipelined LM (``train/pp_lm.py``) runs the same two
schedules over its own stage's module (``gpipe`` and ``one_f_one_b``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from tf_operator_tpu_torch.parallel.mesh import Mesh


def stack_stage_params(param_list: list[Any]) -> Any:
    """Stack per-stage param trees into one tree with a leading stage
    dim."""
    flat = [pytree.tree_flatten(p) for p in param_list]
    spec = flat[0][1]
    leaves = [torch.stack([torch.as_tensor(f[0][i]) for f in flat])
              for i in range(len(flat[0][0]))]
    return pytree.tree_unflatten(leaves, spec)


def microbatch(x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """[batch, ...] -> [num_micro, batch/num_micro, ...]."""
    if x.shape[0] % num_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {num_micro} microbatches"
        )
    return x.reshape(num_micro, x.shape[0] // num_micro, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """[num_micro, mb, ...] -> [num_micro*mb, ...]."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


@dataclass
class Stage:
    """This rank's place in a pipeline: ``pp`` the ``TensorParallel`` of
    the pipeline axis (``index`` the stage, ``size`` the stage count) and
    ``dp`` that of the data axis beside it (None without one)."""

    pp: Any
    dp: Any = None

    @classmethod
    def of(cls, mesh: Mesh, axis: str = "pp",
           batch_axis: str | None = None) -> "Stage":
        from tf_operator_tpu_torch.parallel.sharding import TensorParallel

        dp = (TensorParallel(mesh, batch_axis)
              if batch_axis and mesh.shape.get(batch_axis, 1) > 1 else None)
        return cls(TensorParallel(mesh, axis), dp)

    @property
    def index(self) -> int:
        return self.pp.index

    @property
    def size(self) -> int:
        return self.pp.size

    @property
    def first(self) -> bool:
        return self.pp.index == 0

    @property
    def last(self) -> bool:
        return self.pp.index == self.pp.size - 1

    def hop(self, down: torch.Tensor | None, up: torch.Tensor | None,
            recv_down: bool, recv_up: bool, like: torch.Tensor
            ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """One tick's transfers: ``down`` to the next stage, ``up`` to the
        previous one, and ``like``-shaped tensors received from the
        previous stage (``recv_down``: the activation coming down) and
        from the next (``recv_up``: the cotangent coming up), in one
        exchange with the receives posted first. Returns (from the
        previous stage, from the next), None where nothing came."""
        s = self.pp.index
        sends = {}
        if down is not None:
            sends[s + 1] = down
        if up is not None:
            sends[s - 1] = up
        shapes = {}
        if recv_down:
            shapes[s - 1] = tuple(like.shape)
        if recv_up:
            shapes[s + 1] = tuple(like.shape)
        if not sends and not shapes:
            return None, None
        got = self.pp.exchange(sends, shapes, like=like)
        return got.get(s - 1), got.get(s + 1)


def sum_over(axis, tensors: list[torch.Tensor]) -> None:
    """Sum ``tensors`` over ``axis`` (a ``TensorParallel``; None: nothing)
    in place, with one all-reduce of their concatenation."""
    if axis is None or not tensors:
        return
    flat = axis.all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def _grads(outputs, inputs, grad_outputs) -> list:
    """``torch.autograd.grad`` with zeros for an input the outputs do not
    reach."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


class _GPipe(torch.autograd.Function):
    """The GPipe schedule over this rank's stage. Forward: the
    microbatches in order, each received from the previous stage (stage 0:
    taken from ``microbatches``), run through ``stage_fn`` with its graph
    kept, and sent to the next; the last stage's outputs broadcast over
    ``pp``. Backward: the ranks' cotangents summed onto the last stage,
    then the microbatches in reverse order on every stage, each
    cotangent received from the next stage (the last: its own), pulled
    back through the kept graph and sent to the previous stage; the
    leaves' gradients summed over the data axis."""

    @staticmethod
    def forward(ctx, stage: Stage, stage_fn, p, keep: bool, microbatches,
                *leaves):
        ctx.stage = stage
        ctx.leaves = leaves
        ctx.graphs = []
        ctx.like = like = microbatches[0]
        with torch.set_grad_enabled(keep):
            for i in range(microbatches.shape[0]):
                if stage.first:
                    inp = microbatches[i]
                else:
                    inp, _ = stage.hop(None, None, True, False, like)
                inp = inp.detach().requires_grad_(keep)
                out = stage_fn(p, inp)
                ctx.graphs.append((inp, out))
                if not stage.last:
                    stage.hop(out.detach(), None, False, False, like)
        outs = (torch.stack([o.detach() for _, o in ctx.graphs])
                if stage.last else torch.empty_like(microbatches))
        if not keep:
            ctx.graphs = []
        return stage.pp.broadcast_(outs, stage.size - 1)

    @staticmethod
    def backward(ctx, g):
        stage = ctx.stage
        g = stage.pp.all_reduce_(g.contiguous().clone())
        sums = [torch.zeros_like(x) for x in ctx.leaves]
        d_mb = torch.zeros_like(g) if stage.first else None
        for i in reversed(range(len(ctx.graphs))):
            inp, out = ctx.graphs[i]
            ctx.graphs[i] = None
            if stage.last:
                ct = g[i]
            else:
                _, ct = stage.hop(None, None, False, True, ctx.like)
            got = _grads(out, [inp, *ctx.leaves], ct.to(out.dtype))
            for acc, d in zip(sums, got[1:]):
                acc += d
            if stage.first:
                d_mb[i] = got[0]
            else:
                stage.hop(None, got[0].to(ctx.like.dtype), False, False,
                          ctx.like)
        sum_over(stage.dp, sums)
        return (None, None, None, None, d_mb, *sums)


def gpipe(stage: Stage, stage_fn: Callable, p: Any, leaves: list,
          microbatches: torch.Tensor) -> torch.Tensor:
    """The GPipe forward of this rank's stage (``_GPipe``): ``stage_fn(p,
    x)`` runs the stage, ``leaves`` are the tensors of ``p`` whose
    gradients the backward returns. The last stage's outputs ``[M, mb,
    ...]`` on every rank. Under ``torch.no_grad()`` no graph is kept."""
    return _GPipe.apply(stage, stage_fn, p, torch.is_grad_enabled(),
                        microbatches, *leaves)


def _stage_row(stage_params: Any, n_stages: int, axis: str, index: int,
               detach: bool) -> tuple[Any, list]:
    """This rank's row of a stage-stacked tree, after JAX's check of the
    leading dim: ``(its tree, its leaves)``; ``detach`` makes the row's
    leaves leaves of autograd's graph of their own."""
    leaves, spec = pytree.tree_flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != {axis} axis "
                f"size {n_stages}; to run multiple layers per stage, fold "
                "them into stage_fn (a silent mismatch would drop stages)"
            )
    rows = [leaf[index] for leaf in leaves]
    if detach:
        rows = [r.detach().requires_grad_(r.is_floating_point())
                for r in rows]
    return pytree.tree_unflatten(rows, spec), rows


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "pp",
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Run microbatches through S pipelined stages over ``axis``.

    stage_fn: (one stage's params, activation) -> activation (same shape
      and dtype).
    stage_params: tree whose leaves have leading dim S (stage); this rank
      runs row ``stage``, its place on ``axis`` (its gradient lands in that
      row alone: this rank's shard of JAX's).
    microbatches: [M, microbatch, ...] input activations, the same on
      every stage (stage 0 reads them); with ``batch_axis`` this rank's
      slice of each microbatch.
    batch_axis: each group of that data axis runs a pipeline of its own,
      and the stage params' gradients are summed over it.
    Returns [M, microbatch, ...] outputs of the final stage on every
    stage; their backward sums the stages' cotangents (module docstring).
    """
    stage = Stage.of(mesh, axis, batch_axis)
    p, rows = _stage_row(stage_params, stage.size, axis, stage.index,
                         detach=False)
    return gpipe(stage, stage_fn, p, rows, microbatches)


def one_f_one_b(stage: Stage, stage_fn: Callable, p: Any, leaves: list,
                last_fn: Callable, lp: Any, last_leaves: list,
                microbatches: torch.Tensor, targets: torch.Tensor
                ) -> tuple:
    """The 1F1B schedule of this rank's stage (module docstring):
    ``stage_fn(p, x)`` runs the stage and ``last_fn(lp, y, tgt)`` the loss
    head (the microbatch's mean loss), ``leaves`` and ``last_leaves`` the
    tensors of ``p`` and ``lp`` to differentiate. Returns ``(loss, stage
    grads, last grads, d_microbatches, stash high-water mark)``: the loss
    and the last grads summed over dp and broadcast over ``pp``, the stage
    grads summed over dp, d_microbatches (stage 0's) broadcast over
    ``pp``."""
    S, s, M = stage.size, stage.index, microbatches.shape[0]
    n_dp = stage.dp.size if stage.dp is not None else 1
    seed = 1.0 / (M * n_dp)
    like = microbatches[0]
    gp = [torch.zeros_like(x) for x in leaves]
    gl = [torch.zeros_like(x) for x in last_leaves]
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    dx_out = torch.zeros_like(microbatches)
    x_stash: dict[int, torch.Tensor] = {}
    dy_stash: dict[int, torch.Tensor] = {}
    mark = 0
    down = up = None  # what this rank sends at the next tick
    for t in range(M + 2 * S - 1):
        i_f = t - s
        i_b = t - (2 * S - 1 - s)
        f_valid = 0 <= i_f < M
        b_valid = 0 <= i_b < M
        fwd_in, bwd_in = stage.hop(down, up, f_valid and not stage.first,
                                   b_valid and not stage.last, like)
        down = up = None
        # Backward branch first: its stash slot is free before the forward
        # branch stashes this tick's input.
        if b_valid:
            xb = x_stash.pop(i_b)
            cot = dy_stash.pop(i_b) if stage.last else bwd_in
            with torch.enable_grad():
                xb = xb.detach().requires_grad_(True)
                y = stage_fn(p, xb)
            got = _grads(y, [xb, *leaves], cot.to(y.dtype))
            for acc, d in zip(gp, got[1:]):
                acc += d
            if stage.first:
                dx_out[i_b] = got[0]
            else:
                up = got[0].to(like.dtype)
        if f_valid:
            xf = microbatches[i_f] if stage.first else fwd_in
            with torch.no_grad():
                y = stage_fn(p, xf)
            x_stash[i_f] = xf
            mark = max(mark, len(x_stash))
            if not stage.last:
                down = y
            else:
                # The head, its loss and its vjp in the same tick, so the
                # microbatch's backward starts at the next one.
                with torch.enable_grad():
                    yd = y.detach().requires_grad_(True)
                    loss_i = last_fn(lp, yd, targets[i_f])
                got = _grads(loss_i, [*last_leaves, yd],
                             torch.full_like(loss_i, seed))
                loss += loss_i.detach().float()
                for acc, d in zip(gl, got[:-1]):
                    acc += d
                dy_stash[i_f] = got[-1].to(like.dtype)
    sum_over(stage.dp, gp)
    sum_over(stage.dp, gl + [loss])
    # Only the last stage summed the loss and the head's gradients, only
    # stage 0 the input cotangents: broadcast them over pp.
    for t in gl + [loss]:
        stage.pp.broadcast_(t, S - 1)
    stage.pp.broadcast_(dx_out, 0)
    return loss * seed, gp, gl, dx_out, mark


def pipeline_value_and_grad(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    last_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    *,
    axis: str = "pp",
    batch_axis: str | None = None,
) -> Callable[[Any, Any, torch.Tensor, torch.Tensor], tuple]:
    """1F1B pipelined training step: loss AND grads in one schedule.

    stage_fn: (stage params, activation [mb, ...]) -> activation.
    last_fn: (last params, activation, targets [mb, ...]) -> scalar mean
      loss for that microbatch (e.g. final norm + vocab head + xent).
    Returns run(stage_params, last_params, microbatches, targets) ->
      (loss, stage_grads, last_grads, d_microbatches): loss is the global
      mean; stage_grads this rank's shard of JAX's (leaves ``[1, ...]``,
      its stage's row of the stage-stacked ``stage_params``, summed over
      ``batch_axis``); last_grads (a tree like ``last_params``) and
      d_microbatches (which feed the caller's embedding vjp; this rank's
      slice under ``batch_axis``) on every stage. ``run.stash_mark`` is
      the last call's stash high-water mark (at most ``2S - 1``).
    """
    stage = Stage.of(mesh, axis, batch_axis)

    def run(stage_params, last_params, microbatches, targets):
        p, rows = _stage_row(stage_params, stage.size, axis, stage.index,
                             detach=True)
        flat, spec = pytree.tree_flatten(last_params)
        flat = [x.detach().requires_grad_(x.is_floating_point())
                for x in flat]
        lp = pytree.tree_unflatten(flat, spec)
        loss, gp, gl, dx, run.stash_mark = one_f_one_b(
            stage, stage_fn, p, rows, last_fn, lp, flat, microbatches,
            targets)
        stage_grads = pytree.tree_unflatten([g[None] for g in gp],
                                            pytree.tree_flatten(p)[1])
        return loss, stage_grads, pytree.tree_unflatten(gl, spec), dx

    run.stash_mark = 0
    return run
