"""The workload half of the operator's checkpoint protocol: the env vars
a pod is given and the ack file it writes.

The port's own copy of what a workload needs from
``tf_operator_tpu/ckpt/protocol.py``. A workload saves checkpoints and
*acks* them: under the local executor the ack is a small JSON file
(``$TPU_CKPT_ACK_FILE``, written by ``train/checkpoint.py`` after a
durable save) that the executor lifts into the pod's annotations, which
the operator's registry and eviction barrier read. A replacement pod is
given ``TPU_RESUME_STEP`` (the last step the operator saw acked) and
``TPU_CKPT_DIR``. The JSON keys (``step``, ``dir``, ``savedAt``) are the
executor's: they must not change.

The annotations, signal generations and pod helpers belong to the
control plane and are not copied.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any

# Where the workload writes its ack file (local executor contract).
ENV_ACK_FILE = "TPU_CKPT_ACK_FILE"
# Resume contract injected into replacement pods from the job record.
ENV_RESUME_STEP = "TPU_RESUME_STEP"
ENV_CKPT_DIR = "TPU_CKPT_DIR"


@dataclass
class Ack:
    """One durable-save report, as written to the ack file."""

    step: int
    directory: str = ""
    saved_at: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {"step": self.step, "dir": self.directory,
                "savedAt": self.saved_at}


def write_ack(path: str, step: int, directory: str = "") -> None:
    """Atomically write the ack file: the executor may read it mid-write,
    so the JSON lands via rename, never a partial file."""
    ack = Ack(step=int(step), directory=directory,
              saved_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(ack.to_dict(), f)
    os.replace(tmp, path)


def read_ack(path: str) -> Ack | None:
    """Parse an ack file; None when absent or (transiently) malformed."""
    try:
        with open(path) as f:
            d = json.load(f)
        return Ack(step=int(d["step"]), directory=str(d.get("dir", "")),
                   saved_at=str(d.get("savedAt", "")))
    except (OSError, ValueError, KeyError, TypeError):
        return None
