"""The operator-injected topology contract, read inside a training
process: the port's own copy of the role and process fields of
``tf_operator_tpu/train/distributed.py::from_env``.

The operator injects ``TPU_WORKER_ID`` / ``TPU_NUM_PROCESSES`` and, for
TF-style pods, ``TF_CONFIG``, whose ``task.type`` is the replica's role.
An evaluator never joins the training rendezvous (the operator leaves it
out of the cluster map), so its TF_CONFIG-derived identity is
neutralised to one standalone process; slice env still wins. Joining a
rendezvous (the coordinator's address, ``init_process_group``) is
multi-device work, ROADMAP A8: the port's entry points refuse more than
one process.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

ENV_TF_CONFIG = "TF_CONFIG"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_NUM_PROCESSES = "TPU_NUM_PROCESSES"


@dataclass(frozen=True)
class ProcessTopology:
    process_id: int
    num_processes: int
    # The replica role from TF_CONFIG task.type ("worker", "chief",
    # "evaluator", ...).
    role: str = "worker"


def from_env(env: dict[str, str] | None = None) -> ProcessTopology:
    """Parse the injected contract, falling back to TF_CONFIG's task for
    plain TF-style pods; an evaluator's TF_CONFIG identity is one
    standalone process."""
    env = dict(os.environ if env is None else env)
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
                    worker_id, num = "0", "1"
                else:
                    worker_id = str(task.get("index", 0))
                    workers = tf_config.get("cluster", {}).get("worker", [])
                    num = num or str(len(workers) or 1)
        except (ValueError, KeyError):
            pass
    return ProcessTopology(process_id=int(worker_id or 0),
                           num_processes=int(num or 1), role=role)
