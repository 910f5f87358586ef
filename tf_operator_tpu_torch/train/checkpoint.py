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
renaming the same step into place would race. Every rank reads and
restores from the shared directory, and every rank's ``maybe_ack`` names
only a step that ``latest_step`` lists; ``ack`` first drains the
primary's write and meets the other ranks at a barrier, so every rank's
durable ack names the step just written.
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
    load_variables,
    variable_layout,
)

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


def _snapshot(state) -> dict:
    """The state's weights, BatchNorm statistics, optimiser state and step
    as host tensors, in the ``state.pt`` layout; returns once every copy
    has landed."""
    model, opt = state.model, state.optimizer
    leaves, to_flax, _ = variable_layout(model)
    params, stats = leaves["params"], leaves["batch_stats"]

    def host(t):
        # Into flax's layout on the device (a copy only for conv kernels),
        # so the host copy is contiguous.
        return _host(to_flax(t).contiguous() if t.dim() == 4 else t)

    out: dict = {"params": {}, "opt": {}}
    cuda = False
    for path, p in params.items():
        cuda |= p.is_cuda
        _tree_set(out["params"], path, host(p))
        for key, val in (opt.state.get(p) or {}).items():
            if isinstance(val, torch.Tensor):
                _tree_set(out["opt"].setdefault(key, {}), path, host(val))
    if stats:
        out["batch_stats"] = {}
        for path, b in stats.items():
            _tree_set(out["batch_stats"], path, host(b))
    if cuda:
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
    ``shape_fields()`` (JSON types)."""
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
    saved, want = manifest["config"], config_fields(cfg)
    diff = [f"{f} {saved.get(f)} (checkpoint) vs {want.get(f)} (model)"
            for f in sorted(saved.keys() | want.keys(), key=str)
            if saved.get(f) != want.get(f)]
    if diff:
        raise ValueError(
            f"checkpoint step {manifest['step']} under "
            f"{os.path.abspath(directory)} was saved for another model: "
            f"{', '.join(diff)}")


def restore_params(directory: str, cfg, step: int | None = None) -> dict:
    """The params of ``step`` (or the newest) under ``directory`` as a
    flax-layout tree of f32 numpy arrays, after checking them against
    ``cfg``'s shapes: what a server or an evaluator reads, with no
    manager."""
    payload, manifest = read(directory, step)
    check_config(directory, manifest, cfg)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}

    return walk(payload["params"])


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
    ``save`` writes nothing and returns False.
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
        if not self.primary:
            return False
        if not force and not self._should_save(step):
            return False
        self.wait()
        if step in self.all_steps():
            return False
        payload = _snapshot(state)
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
        leaves, _, from_flax = variable_layout(model)
        load_variables(model, payload)
        path_of = {p: path for path, p in leaves["params"].items()}
        saved_opt = payload["opt"]
        moments, index = {}, 0
        for group in opt.param_groups:
            for p in group["params"]:
                vals = {k: _tree_get(saved_opt[k], path_of[p])
                        for k in saved_opt}
                vals = {k: v for k, v in vals.items() if v is not None}
                if vals:
                    moments[index] = {
                        k: _port_layout(p, v, from_flax)
                        if v.dim() == p.dim() else v
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
