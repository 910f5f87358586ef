"""Tensor-parallel serving over processes: the command stream from rank 0
to the workers, the worker loop, and the weights' way across.

JAX drives every chip of a tp mesh from one process (one compiled step,
GSPMD). The port runs one process a device, so:

- Rank 0 alone holds the engine's host state: the front, the scheduler,
  the allocators, the prefix cache, the sampler and the constraints.
- Ranks 1..N-1 are workers (``TpWorker``). Each holds its slice of the
  params and its ``KV/tp`` heads of the KV storage, in an engine of its
  own that never plans, samples or answers.
- Each device operation of rank 0's engine is first broadcast as a
  command (``CommandChannel``): a fixed header (sequence number, op,
  arguments, payload length) and one int64 payload (tokens, tables, the
  live mask). Then every rank runs its shard of the same operation, so
  the model's collectives (``parallel/sharding.py`` ``TensorParallel``)
  go in the same order on every rank.

The ops (``OPS``): ``build`` (a fresh engine: the first one and each
supervisor rebuild), ``open`` (a prompt's prefill: one-shot, run at
once, or chunked, fed later), ``feed`` (chunks of an open prefill),
``finish`` (a chunked prefill's last logits), ``insert`` (a prefilled or
exact-prefix admission into its slot), ``drop`` (an open prefill whose
plan was released), ``step`` (the pending copy-on-write copies, the live
mask and one decode forward of the sampled tokens), ``report`` (every
rank's launch counts and pool bytes, gathered to rank 0) and ``stop``.

A worker checks every header's sequence number (a gap raises: a lost
command would leave the ranks out of step), and exits non-zero when rank
0 dies (``watch_parent``) rather than wait in a collective. A superseded
engine (a rebuild took over the channel) cannot issue a command: its
next one raises, so an old serving loop can never interleave its
collectives with the new engine's.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

import numpy as np
import torch

OPS = ("build", "open", "feed", "finish", "insert", "drop", "step",
       "report", "stop")
OP = {name: i for i, name in enumerate(OPS)}
_ARGS = 5  # argument slots of a header
_HEADER = 3 + _ARGS  # seq, op, the arguments, the payload length


class CommandChannel:
    """The command broadcast of one tensor-parallel world, over its
    ``TensorParallel`` (``tp``). Rank 0 sends (``section``), the workers
    receive (``recv``); ``commands`` and ``payload_bytes`` count what went
    out. One channel a process (``channel_for``)."""

    def __init__(self, tp) -> None:
        from tf_operator_tpu_torch.train.distributed import collective_device

        self.tp = tp
        self.device = (collective_device(tp.group) if tp.group is not None
                       else torch.device("cpu"))
        self.seq = 0
        self.commands = 0
        self.payload_bytes = 0
        self._lock = threading.RLock()
        self._owner: Any = None

    @property
    def leader(self) -> bool:
        return self.tp.index == 0

    def claim(self, engine: Any) -> None:
        """Make ``engine`` the one rank-0 engine that may issue commands,
        and have every worker build its own (the ``build`` command)."""
        with self._lock:
            self._owner = engine
            self._send(OP["build"], (), None)

    def stop(self, code: int = 0) -> None:
        """End every worker's loop (the ``stop`` command), whichever engine
        holds the channel."""
        with self._lock:
            self._send(OP["stop"], (code,), None)

    @contextmanager
    def section(self, engine: Any, op: str, args=(), payload=None):
        """Rank 0: issue ``op`` and hold the channel while the caller runs
        its own share of it, so no other thread's command interleaves with
        its collectives. Raises for an engine a rebuild superseded."""
        with self._lock:
            if engine is not self._owner:
                raise RuntimeError(
                    "a superseded tensor-parallel engine cannot issue "
                    f"{op!r}: a rebuild took over the workers")
            self._send(OP[op], args, payload)
            yield

    def _send(self, op: int, args, payload) -> None:
        if not self.leader:
            raise RuntimeError("only rank 0 of a tp world sends commands")
        args = [int(a) for a in args]
        if len(args) > _ARGS:
            raise ValueError(f"{len(args)} arguments > {_ARGS}")
        if payload is not None:
            payload = torch.as_tensor(payload).reshape(-1).to(
                device=self.device, dtype=torch.int64)
        n = 0 if payload is None else int(payload.numel())
        header = torch.tensor(
            [self.seq, op, *args, *[0] * (_ARGS - len(args)), n],
            dtype=torch.int64, device=self.device)
        self.tp.broadcast_(header)
        if n:
            self.tp.broadcast_(payload)
            self.payload_bytes += 8 * n
        self.seq += 1
        self.commands += 1

    def recv(self) -> tuple[str, list[int], np.ndarray]:
        """A worker: the next command, ``(op name, arguments, payload)``.
        Raises on a sequence gap."""
        header = torch.empty(_HEADER, dtype=torch.int64, device=self.device)
        self.tp.broadcast_(header)
        seq, op, *rest = header.tolist()
        args, n = rest[:_ARGS], rest[_ARGS]
        if seq != self.seq:
            raise RuntimeError(f"tp command stream out of step: got seq "
                               f"{seq}, expected {self.seq}")
        self.seq += 1
        payload = np.zeros(0, np.int64)
        if n:
            buf = torch.empty(n, dtype=torch.int64, device=self.device)
            self.tp.broadcast_(buf)
            payload = buf.cpu().numpy()
        return OPS[op], args, payload


_CHANNELS: dict[int, CommandChannel] = {}


def channel_for(tp) -> CommandChannel:
    """This process's channel over ``tp``'s group (one a group)."""
    key = id(tp.group)
    chan = _CHANNELS.get(key)
    if chan is None or chan.tp.group is not tp.group:
        chan = _CHANNELS[key] = CommandChannel(tp)
    return chan


def rank_report() -> list[int]:
    """This process's kernel launches (B4, kv8 B4, B5 and B5's wgmma
    tile), in the order ``report`` gathers them."""
    from tf_operator_tpu_torch.ops import int8_dense, paged_attention

    return [paged_attention.launches, paged_attention.kv8_launches,
            int8_dense.launches, int8_dense.wgmma_launches]


REPORT_KEYS = ("paged_launches", "kv8_launches", "int8_launches",
               "int8_wgmma_launches", "pool_bytes", "staged_bytes")


def gather_report(tp, pool_bytes: int) -> list[dict]:
    """Every rank's ``REPORT_KEYS`` (this rank's from ``rank_report``,
    ``pool_bytes`` and the bytes its collectives staged through the
    host), gathered in rank order: a collective of the whole world."""
    from tf_operator_tpu_torch.parallel import sharding

    mine = torch.tensor(rank_report() + [int(pool_bytes),
                                         int(sharding.staged_bytes)],
                        dtype=torch.int64)
    dev = channel_for(tp).device
    rows = tp.all_gather(mine.to(dev)[None, :], 0).cpu().tolist()
    return [dict(zip(REPORT_KEYS, row)) for row in rows]


class TpWorker:
    """A worker rank's loop: ``make_engine()`` builds its engine (on each
    ``build``), then each command runs on it (``ContinuousEngine.
    serve_command``) until ``stop``. ``run`` returns the stop's argument
    (0)."""

    def __init__(self, tp, make_engine: Callable[[], Any]) -> None:
        self.tp = tp
        self.chan = channel_for(tp)
        self.make_engine = make_engine
        self.engine = None
        self.pending: dict[int, Any] = {}

    def run(self) -> int:
        while True:
            op, args, payload = self.chan.recv()
            if op == "stop":
                return int(args[0])
            if op == "build":
                self.engine = None
                self.pending = {}
                self.engine = self.make_engine()
            elif op == "report":
                gather_report(self.tp, self.engine.pool_bytes()
                              if self.engine is not None else 0)
            else:
                self.engine.serve_command(op, args, payload, self.pending)


def stop_workers(tp, code: int = 0) -> None:
    """Rank 0: end every worker's loop (the ``stop`` command)."""
    channel_for(tp).stop(code)


def report(engine: Any) -> list[dict]:
    """Rank 0: every rank's ``REPORT_KEYS`` for the current engine."""
    tp = engine._tp
    chan = channel_for(tp)
    with chan.section(engine, "report"):
        return gather_report(tp, engine.pool_bytes())


# -- the weights across ranks -------------------------------------------------


def broadcast_tree(tp, tree: dict | None) -> dict:
    """Rank 0's flax-layout tree (nested dicts of arrays) on every rank:
    the paths, shapes and dtypes first, then one broadcast a leaf. Rank 0
    passes its tree; the others pass None and get numpy arrays (f32 for
    floating leaves, which holds a bf16 leaf exactly; int8 stays int8)."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import _leaves

    chan = channel_for(tp)
    leaves = []
    if tp.index == 0:
        for path, leaf in _leaves(tree):
            t = torch.as_tensor(leaf) if not isinstance(
                leaf, torch.Tensor) else leaf
            t = t.to(torch.int8 if t.dtype == torch.int8
                     else torch.float32)
            leaves.append((path, t))
        meta = [[(p, tuple(t.shape), str(t.dtype)) for p, t in leaves]]
    else:
        meta = [None]
    if tp.group is not None:
        dist.broadcast_object_list(meta, tp.members[0], group=tp.group)
    out: dict = {}
    for i, (path, shape, dtype) in enumerate(meta[0]):
        if tp.index == 0:
            t = leaves[i][1]
        else:
            t = torch.empty(shape, dtype=getattr(torch, dtype.split(".")[-1]))
        wire = t.to(chan.device).contiguous()
        tp.broadcast_(wire)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (leaves[i][1] if tp.index == 0
                          else wire.cpu().numpy())
    return out


def watch_parent(interval_s: float = 0.5, code: int = 3) -> threading.Thread:
    """Exit this process with ``code`` once its parent (rank 0, which
    started it) is gone: a worker never waits on a dead rank in a
    collective."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(interval_s)
            if os.getppid() != parent:
                os._exit(code)

    thread = threading.Thread(target=watch, daemon=True, name="tp-parent")
    thread.start()
    return thread


# -- a serving world of local processes ---------------------------------------


class TpWorld:
    """Rank 0's handle on the tensor-parallel world ``start_world`` made:
    ``mesh`` (``{"tp": N}`` over the ranks), ``tp`` (its
    ``TensorParallel``) and the worker processes. ``close`` stops the
    workers, waits for them and ends the process group. A worker that
    exits before ``close`` ends this process too (exit 1): rank 0 cannot
    serve without it, and its next collective would wait on it."""

    def __init__(self, mesh, tp, procs: list) -> None:
        self.mesh, self.tp, self.procs = mesh, tp, procs
        self.closed = False
        threading.Thread(target=self._watch, daemon=True,
                         name="tp-workers").start()

    def _watch(self, interval_s: float = 0.5) -> None:
        while not self.closed:
            for r, proc in enumerate(self.procs, start=1):
                if proc.poll() is not None and not self.closed:
                    print(f"tp world: worker rank {r} exited "
                          f"{proc.returncode}; rank 0 exits",
                          file=sys.stderr, flush=True)
                    os._exit(1)
            time.sleep(interval_s)

    def close(self, timeout: float = 60.0) -> list[int]:
        """Stop and reap every worker; their exit codes."""
        import subprocess

        import torch.distributed as dist

        if self.closed:
            return [p.returncode for p in self.procs]
        self.closed = True
        try:
            stop_workers(self.tp)
        finally:
            codes = []
            for proc in self.procs:
                try:
                    codes.append(proc.wait(timeout=timeout))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    codes.append(proc.wait())
            if dist.is_initialized():
                dist.destroy_process_group()
            _CHANNELS.clear()
        return codes


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(world: int, device, backend: str | None,
                engine_kwargs: dict, params: dict,
                timeout_s: float = 86400.0) -> TpWorld:
    """Rank 0 of a serving replica's tp world: start ``world - 1`` worker
    processes on this host (``python -m tf_operator_tpu_torch.serve.tp``;
    worker r on card ``r % device_count``), meet them at a TCP store of
    their own on a free local port, and send them the engine's arguments
    (``engine_kwargs``: the ``ContinuousEngine`` keywords, ``cfg``
    included) and the whole ``params`` tree. Each worker then waits for
    its first ``build``. ``backend`` defaults to nccl on the card, gloo
    on the CPU (two ranks on one card need gloo). The collectives' timeout
    is a day: a worker waits for rank 0's next command as long as the
    replica is idle, and ``watch_parent`` ends it if rank 0 dies."""
    import subprocess
    from datetime import timedelta

    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend runs on the card, not on {device}")
    port = _free_port()
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve.tp",
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--device", device.type, "--backend", backend,
         "--timeout", str(timeout_s)], env=env)
        for r in range(1, world)]
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=0, timeout=timedelta(seconds=timeout_s))
        mesh = create_mesh({"tp": world}, device=device)
        tp = TensorParallel(mesh, "tp")
        dist.broadcast_object_list([engine_kwargs], 0)
        broadcast_tree(tp, params)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    return TpWorld(mesh, tp, procs)


def worker_main(argv: list[str] | None = None) -> int:
    """A worker rank of a serving replica (``start_world`` runs it): join
    the world, take the engine's arguments and the params, then run
    rank 0's commands until ``stop``. A failed join, build or command
    ends the process non-zero."""
    import argparse
    from datetime import timedelta

    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel
    from tf_operator_tpu_torch.serve.serve_lm import _to_device

    p = argparse.ArgumentParser(description="a tp serving worker rank")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="nccl")
    p.add_argument("--timeout", type=float, default=86400.0)
    args = p.parse_args(argv)
    # A worker ends with rank 0 (its stop command, or its death), not on a
    # signal sent to the replica's process group.
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    watch_parent()
    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(args.device)
    dist.init_process_group(
        args.backend, init_method=f"tcp://127.0.0.1:{args.port}",
        world_size=args.world, rank=args.rank,
        timeout=timedelta(seconds=args.timeout))
    mesh = create_mesh({"tp": args.world}, device=device)
    tp = TensorParallel(mesh, "tp")
    box = [None]
    dist.broadcast_object_list(box, 0)
    kwargs = dict(box[0])
    cfg = kwargs.pop("cfg")
    tree = _to_device(broadcast_tree(tp, None), device)

    def make_engine():
        from tf_operator_tpu_torch.serve.engine import ContinuousEngine

        return ContinuousEngine(cfg, tree, device=device, mesh=mesh,
                                **kwargs)

    code = TpWorker(tp, make_engine).run()
    dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(worker_main())
