"""Checkpoint / resume of the port's train state, under the operator's
checkpoint protocol.

Counterpart of ``tf_operator_tpu/train/checkpoint.py``, with its public
API, written for torch instead of orbax (which imports JAX). The
operator's restart policies (ExitCode/OnFailure) compose with
``restore_or_init`` to give kill-and-resume training, and ``ack()`` /
``maybe_ack()`` write the durable-save report (``ckpt/protocol.py``) that
the local executor lifts into pod annotations for the operator's
checkpoint registry and eviction barrier.

Layout: ``{dir}/{step}/``, all-digit step names as orbax writes them, so
``ckpt/gc.py``'s sweeper prunes the port's steps as it prunes orbax's.
Each step holds

- ``state.pt``: ``{"params": <flax-layout tree>, "opt": {<state key>:
  <tree of the same paths>}, "step": <int64>}``, plus ``"batch_stats"``
  for a model with BatchNorm, tensors only, so ``torch.load(...,
  weights_only=True)`` reads it. The params are the tree
  ``models/convert.py::export_variables`` gives, in each parameter's
  dtype (the classifiers' conv kernels HWIO), the ``batch_stats`` the
  BatchNorm running statistics,
  the optimiser's trees its per-parameter state in the same layout
  (AdamW's and LAMB's ``exp_avg``, ``exp_avg_sq`` and ``step``; SGD's and
  LARS's ``momentum_buffer``; Adafactor's ``v`` or factored ``v_row`` and
  ``v_col``, which keep their own shapes, and ``step``), each under the
  paths of the parameters that have it, and ``step`` the ``TrainState``'s
  step;
- ``manifest.json``: the format version, the step, and the fields that
  fix the tree's shapes (the model's ``shape_fields()``), so a restore
  into another model fails with a message that names them.

``models/convert.py::variable_layout`` is the one place that knows each
model family's tree; this module reads every model through it.

A step is written into a temporary sibling (``{step}.tmp-{pid}``, which
neither ``latest_step`` nor the sweeper reads), fsynced and renamed into
place: ``latest_step`` never names a half-written step, which is what
``maybe_ack`` relies on.

``save`` is asynchronous, and the port's train step updates weights and
moments IN PLACE: so ``save`` copies every tensor to the host before it
returns, and only the file writes run on the background thread. One
write is in flight at a time (``save`` waits for the previous one, as
orbax does).

Under several processes (a ``torch.distributed`` world) the state is
replicated, so the primary process (rank 0) alone writes: two ranks
renaming the same step into place would race. A leaf cut over a mesh
axis is saved whole: a tensor-parallel model's split leaves
(``models/transformer.py``'s ``TpPlan``), an expert-parallel MoE layer's
experts, the leaves of a model cut by ``shard_params_fsdp`` and the
moments of a ZeRO-1 optimiser (``steps.ZeroOneOptimizer``). The ranks of
rank 0's group over the cut axes learn from it whether the step is due
(a broadcast over the group), then all-gather every cut tensor over its
axis (``_Layout``, from ``steps.param_cuts``: AdamW's and LAMB's moments
as their leaf, Adafactor's factored ``v_row``/``v_col`` on the dims they
keep, ``steps.moment_cut``), and rank 0 writes the whole tree. A leaf cut
twice (a tp part cut again over fsdp, or its ZeRO-1 part over dp) is
gathered over the inner axis first, then over tp; beside ep the expert
leaves are cut over ep and the others over tp, and rank 0's group spans
both. A restore reads the whole tree and cuts each rank's parts from it,
so a checkpoint written on one layout restores on any other (another tp
or ep, FSDP or none, ZeRO-1 or none, any of them beside tp), as orbax
places a restore into the target's shardings. Every rank reads and
restores from the shared directory, and every rank's ``maybe_ack`` names
only a step that ``latest_step`` lists; ``ack`` first drains the
primary's write and meets the other ranks at a barrier, so every rank's
durable ack names the step just written.

A pipelined state (a stage rank's ``train/pp_lm.py`` ``pp_model``) is
saved in JAX's tree, ``{"outer": ..., "stages": ...}`` with each block
leaf ``[pp, k, ...]`` (``split_pp_params``' layout), AdamW's state in
the same layout: the ranks of rank 0's ``pp`` group stack their stage's
blocks and all-gather them over it (once: the data ranks' replicas are
equal), and rank 0 writes. The manifest's record of the model adds
``pp``, so restoring at another ``pp``, or restoring a pipelined
checkpoint as a plain tree (or the other way round), fails naming the
field. A restore gives each rank its stage's rows. ``restore_params``
reads a pipelined checkpoint given its ``pp`` (``from_pp``) and merges it
back into the standard tree (``merge_pp_params``), as ``serve_lm
--from-pp`` does.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

from tf_operator_tpu_torch.ckpt import protocol as ckpt_protocol
from tf_operator_tpu_torch.models.convert import (
    _leaves,
    load_variables,
    variable_layout,
)
from tf_operator_tpu_torch.train.pp_lm import OUTER_KEYS, merge_pp_params
from tf_operator_tpu_torch.train.steps import state_cut

FORMAT_VERSION = 1
STATE_FILE = "state.pt"
MANIFEST_FILE = "manifest.json"
# AdamW's per-parameter state, as torch names it.
MOMENT_KEYS = ("exp_avg", "exp_avg_sq", "step")


def resume_min_step() -> int | None:
    """The operator-injected resume contract (TPU_RESUME_STEP): the last
    checkpoint step the operator saw acked before this pod was (re)placed.
    Pass it to restore_or_init(min_step=...)."""
    raw = os.environ.get(ckpt_protocol.ENV_RESUME_STEP)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def injected_dir() -> str | None:
    """The operator-injected checkpoint directory (TPU_CKPT_DIR), if any."""
    return os.environ.get(ckpt_protocol.ENV_CKPT_DIR) or None


def _tree_set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tree_get(tree: dict, path: tuple):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that no later in-place update reaches. From the card
    the copy goes to pinned memory without blocking; the caller
    synchronises once."""
    return t.detach().to("cpu", copy=True, non_blocking=t.is_cuda)


class _Layout:
    """Where a state's leaves lie across the ranks: for each parameter
    (by flax path) its ``Cut`` (this rank's part of a tensor-parallel,
    expert-parallel or FSDP leaf; None: whole on every rank), the tensor
    the optimiser keeps its state by (itself, or under ZeRO-1 its part,
    ``ZeroOneOptimizer.held``) and that tensor's ``Cut``. ``group`` is the
    ``TensorParallel`` over every axis something is cut over (None when
    nothing is): the ranks of rank 0's group hold the parts rank 0
    writes."""

    def __init__(self, state) -> None:
        from tf_operator_tpu_torch.parallel.sharding import TensorParallel
        from tf_operator_tpu_torch.train.steps import param_cuts

        model, opt = state.model, state.optimizer
        cuts = param_cuts(model)
        held = getattr(opt, "held", lambda p: (p, cuts.get(id(p))))
        self.leaves, self.to_flax, self.from_flax = variable_layout(model)
        # A stage rank of the pipelined LM: gathered over its pp group.
        self.pipe = getattr(model, "pipeline", None)
        self.rows = {}
        axes, mesh = set(), None
        for path, p in self.leaves["params"].items():
            key, key_cut = held(p)
            self.rows[path] = (p, cuts.get(id(p)), key, key_cut)
            for c in (cuts.get(id(p)), key_cut):
                for _, ax in (c.levels() if c is not None else ()):
                    if ax.size > 1:
                        axes.add(ax.axis)
                        mesh = ax.mesh
        self.group = (TensorParallel(mesh, tuple(
            a for a in mesh.axis_names if a in axes)) if axes else None)
        if self.pipe is not None:
            self.group = self.pipe.stage.pp


def _pp_tree(tree: dict, pipe, device) -> dict:
    """A stage rank's tree (the outer keys and its ``block_0`` ..
    ``block_{k-1}``) in JAX's pipelined layout: ``{"outer": ..., "stages":
    ...}``, each block leaf stacked over the rank's k blocks on ``device``
    and all-gathered over the pp group into ``[pp, k, ...]``. Collective
    over the group, every leaf in the tree's order."""
    k = pipe.cfg.n_layers // pipe.stage.size
    outer = {key: tree[key] for key in OUTER_KEYS}
    flat = [dict(_leaves(tree[f"block_{j}"])) for j in range(k)]
    stages: dict = {}
    for path in flat[0]:
        mine = torch.stack([f[path].to(device) for f in flat])
        _tree_set(stages, path, pipe.stage.pp.all_gather(mine[None], 0))
    return {"outer": outer, "stages": stages}


def _stage_tree(tree: dict, pipe) -> dict:
    """This stage rank's tree (the outer keys and ``block_j``) of a tree in
    JAX's pipelined layout."""
    k = pipe.cfg.n_layers // pipe.stage.size
    out = dict(tree["outer"])
    for j in range(k):
        out[f"block_{j}"] = {}
        for path, leaf in _leaves(tree["stages"]):
            _tree_set(out[f"block_{j}"], path, leaf[pipe.stage.index][j])
    return out


def _snapshot(state) -> dict:
    """The state's weights, BatchNorm statistics, optimiser state and step
    as host tensors, in the ``state.pt`` layout; returns once every copy
    has landed. A leaf cut over an axis (tp, ep, FSDP; ZeRO-1's moments)
    is gathered whole first: collective over the axis' group."""
    model, opt = state.model, state.optimizer
    layout = _Layout(state)
    if layout.pipe is not None:
        return _pp_snapshot(state, layout)
    to_flax = layout.to_flax

    def host(t, cut=None):
        if cut is not None:
            t = cut.gather(t.detach())
        # Into flax's layout on the device (a copy only for conv kernels),
        # so the host copy is contiguous.
        return _host(to_flax(t).contiguous() if t.dim() == 4 else t)

    out: dict = {"params": {}, "opt": {}}
    cuda = False
    for path, (p, cut, key, key_cut) in layout.rows.items():
        cuda |= p.is_cuda
        _tree_set(out["params"], path, host(p, cut))
        for k, val in (opt.state.get(key) or {}).items():
            if isinstance(val, torch.Tensor):
                _tree_set(out["opt"].setdefault(k, {}), path,
                          host(val, state_cut(k, val, key_cut)))
    stats = layout.leaves["batch_stats"]
    if stats:
        out["batch_stats"] = {}
        for path, b in stats.items():
            _tree_set(out["batch_stats"], path, host(b))
    if cuda:
        torch.cuda.synchronize(model.device)
    out["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    return out


def _pp_snapshot(state, layout: _Layout) -> dict:
    """``_snapshot`` of a stage rank's state in JAX's pipelined layout
    (``_pp_tree``: collective over the pp group)."""
    model, opt = state.model, state.optimizer
    params: dict = {}
    moments: dict = {}
    for path, (p, _, key, _) in layout.rows.items():
        _tree_set(params, path, p.detach())
        for k, val in (opt.state.get(key) or {}).items():
            if isinstance(val, torch.Tensor):
                _tree_set(moments.setdefault(k, {}), path, val.detach())

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else _host(v)
                for k, v in tree.items()}

    out = {"params": host(_pp_tree(params, layout.pipe, model.device)),
           "opt": {k: host(_pp_tree(v, layout.pipe, model.device))
                   for k, v in moments.items()}}
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    out["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    return out


def _port_layout(p: torch.Tensor, saved: torch.Tensor, from_flax
                 ) -> torch.Tensor:
    """A saved per-parameter tensor shaped like ``p`` in ``p``'s layout and
    strides (a classifier's conv kernel moment HWIO -> OIHW,
    ``channels_last``). The caller passes a tensor of another rank, such
    as Adafactor's factored ``v_row``/``v_col``, through unchanged."""
    return torch.empty_like(p, dtype=saved.dtype, device="cpu").copy_(
        from_flax(saved))


def config_fields(cfg) -> dict:
    """The manifest's record of a model or a ``TransformerConfig``: its
    ``shape_fields()`` (JSON types); a stage rank of the pipelined LM
    records the whole model's and its ``pp``."""
    pipe = getattr(cfg, "pipeline", None)
    if pipe is not None:
        return dict(pipe.cfg.shape_fields(), pp=pipe.stage.size)
    return cfg.shape_fields()


def _write_file(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def all_steps(directory: str) -> list[int]:
    """The committed steps under ``directory``, ascending (a temporary
    ``{step}.tmp-{pid}`` is not a step)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(e) for e in entries if e.isdigit()
                  and os.path.isdir(os.path.join(directory, e)))


def latest_step(directory: str) -> int | None:
    """The newest committed step under ``directory`` (never one still
    being written)."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def read(directory: str, step: int | None = None) -> tuple[dict, dict]:
    """``(state.pt's payload on the host, manifest)`` of ``step`` (or the
    newest) under ``directory``. Raises FileNotFoundError when there is
    none."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(step))
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format "
                         f"{manifest.get('format')}, this reader takes "
                         f"{FORMAT_VERSION}")
    payload = torch.load(os.path.join(path, STATE_FILE),
                         map_location="cpu", weights_only=True)
    return payload, manifest


def check_config(directory: str, manifest: dict, cfg) -> None:
    """Raise ValueError, naming each field, when the checkpoint was saved
    for a model of other shapes than ``cfg`` (a model or a
    ``TransformerConfig``)."""
    _check_fields(directory, manifest, config_fields(cfg))


def _check_fields(directory: str, manifest: dict, want: dict) -> None:
    saved = manifest["config"]
    diff = [f"{f} {saved.get(f)} (checkpoint) vs {want.get(f)} (model)"
            for f in sorted(saved.keys() | want.keys(), key=str)
            if saved.get(f) != want.get(f)]
    if diff:
        raise ValueError(
            f"checkpoint step {manifest['step']} under "
            f"{os.path.abspath(directory)} was saved for another model: "
            f"{', '.join(diff)}")


def restore_params(directory: str, cfg, step: int | None = None,
                   from_pp: int | None = None) -> dict:
    """The params of ``step`` (or the newest) under ``directory`` as a
    flax-layout tree of f32 numpy arrays, after checking them against
    ``cfg``'s shapes: what a server or an evaluator reads, with no
    manager. ``from_pp``: the checkpoint of a pipelined run at that
    ``pp``, merged back into the standard tree."""
    payload, manifest = read(directory, step)
    want = config_fields(cfg)
    if from_pp:
        want = dict(want, pp=from_pp)
    _check_fields(directory, manifest, want)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}

    params = walk(payload["params"])
    if from_pp:
        params = merge_pp_params(params["outer"], params["stages"],
                                 cfg.n_layers)
    return params


class CheckpointManager:
    """Step directories of one trainer's state under ``directory``.

    ``save()`` is asynchronous (host copy, then a background write);
    ``wait()`` drains it, ``close()`` drains and stops the writer. At most
    ``max_to_keep`` committed steps are kept (None keeps all), and a save
    that is not forced lands only on a multiple of
    ``save_interval_steps``, past the newest step, or as the first: the
    steps orbax keeps for the same calls.

    Checkpoint coordination: when ``ack_path`` is set (defaulting to the
    operator-injected $TPU_CKPT_ACK_FILE), ``ack()``/``maybe_ack()`` write
    the durable-save report (ckpt/protocol.py).

    ``primary`` is whether this process writes: rank 0 of the default
    process group, or the one process without one. On another rank
    ``save`` writes nothing and returns False (under tp the ranks of rank
    0's tensor-parallel group take part in the gather first).
    """

    def __init__(self, directory: str, *, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1,
                 ack_path: str | None = None) -> None:
        if save_interval_steps < 1:
            raise ValueError(
                f"save_interval_steps={save_interval_steps} must be >= 1")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.ack_path = (ack_path if ack_path is not None
                         else os.environ.get(ckpt_protocol.ENV_ACK_FILE))
        self._last_acked: int | None = None
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ckpt-write")
        self._pending: Future | None = None
        self._pending_step: int | None = None
        from tf_operator_tpu_torch.train.distributed import world

        self.primary = world()[0] == 0

    @property
    def directory(self) -> str:
        return self._dir

    def all_steps(self) -> list[int]:
        """The committed steps on disk, ascending."""
        return all_steps(self._dir)

    def latest_step(self) -> int | None:
        """The newest committed step (never one still being written)."""
        return latest_step(self._dir)

    def reload(self) -> None:
        """A no-op kept for the API: this manager lists the directory on
        every call, so steps another process wrote are always seen."""

    def _should_save(self, step: int) -> bool:
        known = self.all_steps()
        if self._pending_step is not None:
            known.append(self._pending_step)
        if known and max(known) >= step:
            return False
        return step % self.save_interval_steps == 0 or not known

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save ``state`` (a ``TrainState``) as ``step``: copy it to the
        host, then write it on the background thread. Returns False when
        the step is not due (see the class docstring) or, under
        ``force``, already saved or being saved: the checkpoint the
        caller wants is there, as orbax's refusal to overwrite means."""
        step = int(step)
        group = _Layout(state).group
        if not self.primary and (group is None or 0 not in group.members):
            return False
        due = False
        if self.primary:
            due = force or self._should_save(step)
            if due:
                self.wait()
                due = step not in self.all_steps()
        if group is not None:
            # Rank 0's group gathers together, or none of it does.
            flag = torch.tensor([int(due)], device=state.model.device)
            due = bool(group.broadcast_(flag, group.members.index(0))
                       .item())
        if not due:
            return False
        payload = _snapshot(state)
        if not self.primary:
            return False
        manifest = {"format": FORMAT_VERSION, "step": step,
                    "config": config_fields(state.model)}
        self._pending_step = step
        self._pending = self._writer.submit(self._write, step, payload,
                                            manifest)
        return True

    def _write(self, step: int, payload: dict, manifest: dict) -> None:
        tmp = os.path.join(self._dir, f"{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_file(os.path.join(tmp, STATE_FILE),
                    lambda f: torch.save(payload, f))
        _write_file(os.path.join(tmp, MANIFEST_FILE),
                    lambda f: f.write(json.dumps(manifest).encode()))
        _fsync_dir(tmp)
        os.rename(tmp, os.path.join(self._dir, str(step)))
        _fsync_dir(self._dir)
        if self.max_to_keep is not None:
            steps = self.all_steps()
            for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                shutil.rmtree(os.path.join(self._dir, str(old)))

    def restore(self, step: int | None, state: Any) -> Any:
        """Restore ``step`` (or the newest) IN PLACE into ``state``'s model
        (weights and BatchNorm statistics) and optimiser (its state on the
        model's device, in each parameter's dtype and layout) and set its
        step; returns ``state``."""
        payload, manifest = read(self._dir, step)
        model, opt = state.model, state.optimizer
        check_config(self._dir, manifest, model)
        layout = _Layout(state)
        flax, from_flax = layout.to_flax, layout.from_flax
        if layout.pipe is not None:
            payload = dict(
                payload, params=_stage_tree(payload["params"], layout.pipe),
                opt={k: _stage_tree(v, layout.pipe)
                     for k, v in payload["opt"].items()})

        def part(t, cut):
            # This rank's part of a saved whole tensor (in the port's
            # layout, where the cut is).
            if cut is None:
                return t
            return flax(cut.part(from_flax(t)).contiguous())

        params = {path: part(t, layout.rows[path][1])
                  for path, t in _leaves(payload["params"])
                  if path in layout.rows}
        payload = dict(payload, params={})
        for path, t in params.items():
            _tree_set(payload["params"], path, t)
        load_variables(model, payload)
        by_key = {id(key): (path, key_cut) for path, (_, _, key, key_cut)
                  in layout.rows.items()}
        saved_opt = payload["opt"]
        moments, index = {}, 0
        for group in opt.param_groups:
            for key in group["params"]:
                path, key_cut = by_key[id(key)]
                vals = {k: _tree_get(saved_opt[k], path) for k in saved_opt}
                vals = {k: part(v, state_cut(k, v, key_cut))
                        for k, v in vals.items() if v is not None}
                if vals:
                    moments[index] = {
                        k: _port_layout(key, v, from_flax)
                        if v.dim() == key.dim() else v
                        for k, v in vals.items()}
                index += 1
        # load_state_dict casts each tensor to its param's dtype and
        # device, and places AdamW's step counts where AdamW keeps them.
        opt.load_state_dict({"state": moments,
                             "param_groups": opt.state_dict()["param_groups"]})
        state.step = int(payload["step"])
        return state

    def restore_or_init(self, state: Any, min_step: int | None = None
                        ) -> tuple[Any, int]:
        """Resume from the newest checkpoint if one exists: returns
        ``(state, next_step)``, the restored state and newest + 1, or
        ``(state, 0)`` untouched when there is none.

        ``min_step`` is the operator's resume contract (TPU_RESUME_STEP):
        when the newest step seen is below it, the directory is re-read
        before giving up (orbax's follower rule; this manager lists the
        directory on every call, so the re-read sees what the first
        did)."""
        step = self.latest_step()
        if min_step is not None and (step is None or step < min_step):
            self.reload()
            step = self.latest_step()
        if step is None:
            return state, 0
        return self.restore(step, state), int(step) + 1

    def wait(self) -> None:
        """Block until the queued save is durable; raises its error."""
        pending, self._pending = self._pending, None
        self._pending_step = None
        if pending is not None:
            pending.result()

    def ack(self) -> int | None:
        """Durably ack the newest checkpoint: drain the pending save, then
        write the ack file (no-op without one configured). Returns the
        acked step. What an eviction-signal handler calls after its forced
        save.

        Always REWRITES the file, even when the step is unchanged: the
        executor's relay treats "the ack file changed after the signal was
        delivered" as the ack.

        Under several processes every rank must call it at the same step:
        it meets the others at a barrier after the primary's write."""
        from tf_operator_tpu_torch.train.distributed import barrier

        self.wait()
        barrier()
        return self._write_ack(self.latest_step(), again=True)

    def maybe_ack(self) -> int | None:
        """Ack the newest COMMITTED step once, without draining the write
        in flight (a step is renamed into place whole, so latest_step never
        names a half-written one). Call after periodic save()s."""
        return self._write_ack(self.latest_step(), again=False)

    def _write_ack(self, step: int | None, again: bool) -> int | None:
        if step is None or not self.ack_path or (
                step == self._last_acked and not again):
            return None
        try:
            ckpt_protocol.write_ack(self.ack_path, step, self._dir)
        except OSError:
            return None  # ack is observability; never fail the save path
        self._last_acked = step
        return step

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)

    def __enter__(self) -> CheckpointManager:
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
