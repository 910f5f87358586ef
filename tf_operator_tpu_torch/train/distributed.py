"""The operator-injected topology contract, read inside a training
process, and the process group it starts: the port's counterpart of
``tf_operator_tpu/train/distributed.py``.

The operator injects ``TPU_COORDINATOR_ADDRESS`` / ``TPU_WORKER_ID`` /
``TPU_NUM_PROCESSES`` (and a TPU slice's hostnames, accelerator type and
topology) and, for TF-style pods, ``TF_CONFIG``, whose ``task.type`` is
the replica's role and whose first worker is the coordinator when no
address is injected. An evaluator never joins the training rendezvous
(the operator leaves it out of the cluster map), so its TF_CONFIG-derived
identity is neutralised to one standalone process; slice env still wins.

``initialize`` turns a distributed topology into
``torch.distributed.init_process_group`` over TCP at the coordinator's
address: one process a device, as torch runs, where JAX runs one process
a host over all of its devices. The backend is ``nccl`` on the card and
``gloo`` on the CPU unless the caller names one (two ranks sharing one
card need ``gloo``: NCCL puts one rank on a device); a failed init
raises, and nothing falls back to another backend.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from datetime import timedelta

ENV_TF_CONFIG = "TF_CONFIG"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_NUM_PROCESSES = "TPU_NUM_PROCESSES"
ENV_COORDINATOR_ADDRESS = "TPU_COORDINATOR_ADDRESS"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_NUM_SLICES = "MEGASCALE_NUM_SLICES"


@dataclass(frozen=True)
class ProcessTopology:
    process_id: int
    num_processes: int
    # The replica role from TF_CONFIG task.type ("worker", "chief",
    # "evaluator", ...).
    role: str = "worker"
    coordinator_address: str | None = None
    accelerator_type: str | None = None
    topology: str | None = None
    worker_hostnames: list[str] = field(default_factory=list)
    # The slices of a multislice job (MEGASCALE_NUM_SLICES); each slice is
    # a world of its own.
    num_slices: int = 1

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1 and self.coordinator_address is not None


def from_env(env: dict[str, str] | None = None) -> ProcessTopology:
    """Parse the injected contract, falling back to TF_CONFIG's task for
    plain TF-style pods; an evaluator's TF_CONFIG identity is one
    standalone process with no coordinator."""
    env = dict(os.environ if env is None else env)
    coord = env.get(ENV_COORDINATOR_ADDRESS)
    worker_id = env.get(ENV_TPU_WORKER_ID)
    num = env.get(ENV_NUM_PROCESSES)
    role = "worker"
    if ENV_TF_CONFIG in env:
        try:
            tf_config = json.loads(env[ENV_TF_CONFIG])
            task = tf_config.get("task", {})
            role = str(task.get("type", role)) or role
            if worker_id is None:
                if role == "evaluator":
                    coord, worker_id, num = None, "0", "1"
                else:
                    worker_id = str(task.get("index", 0))
                    workers = tf_config.get("cluster", {}).get("worker", [])
                    num = num or str(len(workers) or 1)
                    if coord is None and workers:
                        coord = workers[0]
        except (ValueError, KeyError):
            pass
    hostnames = [h for h in env.get(ENV_TPU_WORKER_HOSTNAMES, "").split(",")
                 if h]
    return ProcessTopology(
        process_id=int(worker_id or 0), num_processes=int(num or 1),
        role=role, coordinator_address=coord,
        accelerator_type=env.get(ENV_TPU_ACCELERATOR_TYPE),
        topology=env.get(ENV_TPU_TOPOLOGY), worker_hostnames=hostnames,
        num_slices=int(env.get(ENV_NUM_SLICES) or 1))


def check_topology(p, topo: ProcessTopology) -> None:
    """The usage error (``p.error``) for a topology the port cannot join:
    several processes with no coordinator address. A multislice job is
    not one: as JAX's entry points do, each slice's processes form their
    own world from the in-slice env (``train/dist_multislice.py`` bridges
    the slices)."""
    if topo.num_processes > 1 and not topo.is_distributed:
        p.error(f"{topo.num_processes} training processes need "
                f"{ENV_COORDINATOR_ADDRESS} (or a TF_CONFIG worker list) to "
                "meet at")


def add_dist_backend(p) -> None:
    """The ``--dist-backend`` flag of a training entry point's parser."""
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend of a multi-process run "
                        "(default nccl on cuda, gloo on cpu; two processes "
                        "on one card need gloo)")


def initialize(topology: ProcessTopology | None = None, *, device,
               backend: str | None = None,
               timeout_s: float = 600.0) -> ProcessTopology:
    """``init_process_group`` from the injected env (nothing for one
    process): ``backend`` (default ``nccl`` on the card, ``gloo`` on the
    CPU) over ``tcp://{coordinator_address}``, rank ``process_id`` of
    ``num_processes``. On the card each rank first takes card
    ``process_id % device_count`` as its current device. ``timeout_s``
    bounds the rendezvous and every collective after it."""
    import torch
    import torch.distributed as dist

    topo = topology or from_env()
    if not topo.is_distributed:
        return topo
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on the card, not on {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(topo.process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{topo.coordinator_address}",
        world_size=topo.num_processes, rank=topo.process_id,
        timeout=timedelta(seconds=timeout_s))
    return topo


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    when none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collective_device(group=None):
    """Where a tensor must lie for a collective of ``group``: the current
    card under NCCL, the CPU under gloo."""
    import torch
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (an all-reduce MAX
    over the default group); ``flag`` itself for one process. What makes
    a signal that reaches each process at its own moment a decision
    every rank takes at the same step."""
    import torch
    import torch.distributed as dist

    if world()[1] == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank of the default group (nothing for one
    process)."""
    import torch.distributed as dist

    if world()[1] > 1:
        if dist.get_backend() == "nccl":
            import torch

            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# What this process keeps of its process groups past their use, each
# dropped by a callable registered here (``on_shutdown``).
_RELEASES: list = []


def on_shutdown(release) -> None:
    """Have ``shutdown`` call ``release()`` once the groups are destroyed:
    it drops a cache that holds a group (``serve/tp.py``'s channels)."""
    if release not in _RELEASES:
        _RELEASES.append(release)


def shutdown() -> None:
    """Destroy every process group, if one was initialised, then drop what
    held them. ``destroy_process_group`` leaves a gloo group's threads
    running until the group's last reference goes; one that a cache still
    holds at exit is torn down with the interpreter, in no fixed order,
    and that teardown can abort the process after its work is done."""
    import gc

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    for release in _RELEASES:
        release()
    gc.collect()
