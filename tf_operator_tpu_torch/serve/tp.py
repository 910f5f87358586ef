"""Parallel serving over processes (tp, and tp x dp): the command stream
from rank 0 to the workers, the worker loop, and the weights' way across.

JAX drives every chip of a tp x dp mesh from one process (one compiled
step, GSPMD). The port runs one process a device, over a mesh of ``tp``
and ``dp`` (``dp`` outer, so ranks ``[i*tp, (i+1)*tp)`` are dp shard i's
tp group and rank 0 is shard 0's tp index 0), so:

- Rank 0 alone holds the engine's host state: the front, the scheduler,
  the allocators, the prefix cache, the sampler and the constraints.
- Ranks 1..N-1 are workers (``TpWorker``). Each holds its tp slice of the
  params and its ``KV/tp`` heads of its dp shard's KV storage, in an
  engine of its own that never plans, samples or answers.
- Each device operation of rank 0's engine is first broadcast to the
  whole world as a command (``CommandChannel``): a fixed header (sequence
  number, op, arguments, payload length) and one int64 payload (tokens,
  tables, the live mask). A command that touches a slot, a plan or a
  block names its dp shard (an argument, or the slot's shard), and only
  that shard's ranks run it, their collectives over their tp group alone;
  the others skip it. A step runs on every rank. So each group's
  collectives go in one order on all its ranks, and no rank waits in a
  collective of a group it is not in.

The ops (``OPS``): ``build`` (a fresh engine: the first one and each
supervisor rebuild), ``open`` (a prompt's prefill: one-shot, run at
once, or chunked, fed later), ``feed`` (chunks of an open prefill),
``finish`` (a chunked prefill's last logits), ``insert`` (a prefilled or
exact-prefix admission into its slot, and on a speculative engine the
draft's prefill of its prompt), ``drop`` (an open prefill whose plan was
released), ``step`` (the pending copy-on-write copies, the live mask and
one decode forward of the sampled tokens), ``spec`` (a speculative round:
the copies, each lane's pending token and the live mask, then the
draft's k + 1 steps and the verify, rank 0 broadcasting each drafted
token and the accept counts), ``ship`` (a shipment's or a restore's
block list and rows into the owning shard's pool), ``export`` (an
entry's rows from the owning shard back to rank 0: a pull or a tier
spill), ``report`` (every rank's launch counts, pool bytes, staged bytes,
logits bytes and the bytes ``ship``, ``export`` and ``spec`` moved,
gathered to rank 0) and ``stop``.

A worker checks every header's sequence number, those of the commands it
skips too (a gap raises: a lost command would leave the ranks out of
step), and exits non-zero when rank 0 dies (``watch_parent``) rather than
wait in a collective. A superseded engine (a rebuild took over the
channel) cannot issue a command: its next one raises, so an old serving
loop can never interleave its collectives with the new engine's.
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

from tf_operator_tpu_torch.train import distributed

OPS = ("build", "open", "feed", "finish", "insert", "drop", "step",
       "report", "stop", "spec", "ship", "export")
OP = {name: i for i, name in enumerate(OPS)}
_ARGS = 5  # argument slots of a header
_HEADER = 3 + _ARGS  # seq, op, the arguments, the payload length


class CommandChannel:
    """The command broadcast of one serving world, over a
    ``TensorParallel`` that spans it (``tp``, from ``world_comm``). Rank 0
    sends (``section``), the workers receive (``recv``); ``commands`` and
    ``payload_bytes`` count what went out. One channel a process
    (``channel_for``)."""

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
            raise RuntimeError("only rank 0 of a serving world sends "
                               "commands")
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
distributed.on_shutdown(_CHANNELS.clear)


def world_comm(mesh):
    """The ``TensorParallel`` over all of ``mesh`` (its commands, reports
    and weights), after this rank has built the mesh's part groups: the tp
    groups and the dp groups, every rank in one order (``Mesh.group``), so
    no engine built later makes a group while its peers wait for a
    command. Every rank of the world calls it, at once."""
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel

    mesh.group(("tp",))
    mesh.group(("dp",))
    return TensorParallel(mesh, tuple(mesh.axis_names))


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
               "int8_wgmma_launches", "pool_bytes", "staged_bytes",
               "logits_bytes", "ship_bytes", "export_bytes", "spec_bytes")
# The engine's ``op_bytes`` keys, in REPORT_KEYS's order.
OP_BYTES = ("ship", "export", "spec")


def gather_report(tp, pool_bytes: int, logits_bytes: int = 0,
                  op_bytes: dict | None = None) -> list[dict]:
    """Every rank's ``REPORT_KEYS`` (this rank's from ``rank_report``,
    ``pool_bytes``, the bytes its collectives staged through the host, the
    logits bytes it took from other dp shards, and the bytes each of the
    ``ship``, ``export`` and ``spec`` commands moved on it: their payloads
    and what their collectives staged, the engine's ``op_bytes``),
    gathered in rank order: a collective of the whole world."""
    from tf_operator_tpu_torch.parallel import sharding

    op_bytes = op_bytes or {}
    mine = torch.tensor(rank_report() + [int(pool_bytes),
                                         int(sharding.staged_bytes),
                                         int(logits_bytes)]
                        + [int(op_bytes.get(op, 0)) for op in OP_BYTES],
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
                eng = self.engine
                gather_report(self.tp, eng.pool_bytes() if eng else 0,
                              eng.logits_bytes if eng else 0,
                              eng.op_bytes if eng else None)
            else:
                self.engine.serve_command(op, args, payload, self.pending)


def stop_workers(tp, code: int = 0) -> None:
    """Rank 0: end every worker's loop (the ``stop`` command)."""
    channel_for(tp).stop(code)


def report(engine: Any) -> list[dict]:
    """Rank 0: every rank's ``REPORT_KEYS`` for the current engine."""
    chan = engine._chan
    with chan.section(engine, "report"):
        return gather_report(chan.tp, engine.pool_bytes(),
                             engine.logits_bytes, engine.op_bytes)


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
    """Rank 0's handle on the serving world ``start_world`` made: ``mesh``
    (``{"tp": N}``, or ``{"tp": N/dp, "dp": dp}``, over the ranks), ``tp``
    (the ``TensorParallel`` over all of it, ``world_comm``'s) and the
    worker processes. ``close`` stops the
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
            distributed.shutdown()
        return codes


def world_mesh(world: int, dp: int, device=None):
    """The serving mesh of ``world`` ranks: ``{"tp": world}``, or with
    ``dp`` > 1 ``{"tp": world // dp, "dp": dp}``, as JAX's serve_lm lays
    it out (``dp`` outer)."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    axes = {"tp": world // dp}
    if dp > 1:
        axes["dp"] = dp
    return create_mesh(axes, device=device)


def _world_key(world: int, device, backend: str | None, timeout_s: float,
               dp: int) -> tuple:
    """``(world, device, backend, timeout, dp)`` with the backend's default
    filled in and the device's index (0 when none is named): a world's
    arguments as ``prestart`` and ``start_world`` match them."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend runs on the card, not on {device}")
    if world % dp:
        raise ValueError(f"dp={dp} must divide the world of {world} ranks")
    return (world, (device.type, device.index or 0), backend,
            float(timeout_s), dp)


class Spawned:
    """A serving world's workers started ahead of it: rank 0's TCP store
    (made first, it holds the port the workers join), the ``world - 1``
    worker processes waiting there for rank 0, and the arguments of the
    world they belong to (``key``). ``start_world(..., spawned=)`` takes
    them; ``discard`` stops them unless a world took them."""

    def __init__(self, key: tuple) -> None:
        import subprocess
        from datetime import timedelta

        import torch.distributed as dist

        world, (kind, _), backend, timeout_s, dp = key
        self.key, self.taken = key, False
        self.store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                                   timeout=timedelta(seconds=timeout_s),
                                   wait_for_workers=False)
        env = dict(os.environ)
        env.setdefault("OMP_NUM_THREADS", "1")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.serve.tp",
             "--rank", str(r), "--world", str(world), "--port",
             str(self.store.port), "--device", kind, "--backend", backend,
             "--timeout", str(timeout_s), "--dp", str(dp)], env=env)
            for r in range(1, world)]

    def discard(self) -> None:
        """Stop the workers, unless a world took them."""
        if self.taken:
            return
        for proc in self.procs:
            proc.kill()
            proc.wait()


def prestart(world: int, device, backend: str | None = None,
             timeout_s: float = 86400.0, dp: int = 1) -> Spawned:
    """The workers of a ``start_world`` call with these arguments, started
    now so that their start-up (the interpreter, torch, the card) overlaps
    the caller's other work: pass the result to that call as ``spawned``,
    and ``discard`` it if the world is never started."""
    return Spawned(_world_key(world, device, backend, timeout_s, dp))


def start_world(world: int, device, backend: str | None,
                engine_kwargs: dict, params: dict,
                timeout_s: float = 86400.0, dp: int = 1,
                draft_params: dict | None = None,
                spawned: Spawned | None = None) -> TpWorld:
    """Rank 0 of a serving replica's world of ``world`` ranks, ``dp`` dp
    shards of ``world // dp`` tp ranks (``world_mesh``): start ``world -
    1`` worker processes on this host (``python -m
    tf_operator_tpu_torch.serve.tp``; worker r on card ``r %
    device_count``), or take ``spawned`` (``prestart``'s, for the same
    arguments), meet them at rank 0's TCP store on a free local port, and
    send them the engine's arguments
    (``engine_kwargs``: the ``ContinuousEngine`` keywords, ``cfg``
    included) and the whole ``params`` tree, then, for a speculative
    engine (``spec_k`` in ``engine_kwargs``), the draft's whole
    ``draft_params`` tree. Each worker then waits for
    its first ``build``. ``backend`` defaults to nccl on the card, gloo
    on the CPU (two ranks on one card need gloo). The collectives' timeout
    is a day: a worker waits for rank 0's next command as long as the
    replica is idle, and ``watch_parent`` ends it if rank 0 dies."""
    from datetime import timedelta

    import torch.distributed as dist

    key = _world_key(world, device, backend, timeout_s, dp)
    device, backend = torch.device(device), key[2]
    if spawned is None:
        spawned = Spawned(key)
    elif spawned.key != key or spawned.taken:
        raise ValueError(f"spawned workers of {spawned.key} (taken "
                         f"{spawned.taken}) for a world of {key}")
    spawned.taken = True
    store, procs = spawned.store, spawned.procs
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        # The workers' tcp:// rendezvous keeps its keys under this prefix.
        dist.init_process_group(
            backend, store=dist.PrefixStore("default_pg", store),
            world_size=world, rank=0, timeout=timedelta(seconds=timeout_s))
        mesh = world_mesh(world, dp, device)
        tp = world_comm(mesh)
        dist.broadcast_object_list([engine_kwargs], 0)
        broadcast_tree(tp, params)
        if engine_kwargs.get("spec_k"):
            broadcast_tree(tp, draft_params)
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

    from tf_operator_tpu_torch.serve.serve_lm import _to_device

    p = argparse.ArgumentParser(description="a tp serving worker rank")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="nccl")
    p.add_argument("--timeout", type=float, default=86400.0)
    p.add_argument("--dp", type=int, default=1)
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
    mesh = world_mesh(args.world, args.dp, device)
    tp = world_comm(mesh)
    box = [None]
    dist.broadcast_object_list(box, 0)
    kwargs = dict(box[0])
    cfg = kwargs.pop("cfg")
    tree = _to_device(broadcast_tree(tp, None), device)
    if kwargs.get("spec_k"):
        kwargs["draft_params"] = _to_device(broadcast_tree(tp, None), device)

    def make_engine():
        from tf_operator_tpu_torch.serve.engine import ContinuousEngine

        return ContinuousEngine(cfg, tree, device=device, mesh=mesh,
                                **kwargs)

    code = TpWorker(tp, make_engine).run()
    distributed.shutdown()
    return code


if __name__ == "__main__":
    sys.exit(worker_main())
