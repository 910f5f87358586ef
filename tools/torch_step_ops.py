"""Count the PyTorch operations of one ContinuousEngine decode step, greedy
against sampled, on the CPU at a toy width.

    python tools/torch_step_ops.py

Four lanes join a toy engine (vocab 64, d_model 32, 2 layers), once all
greedy and once with chip_smoke.py's sampled mix (a greedy lane, one at
a temperature, two with a nucleus ``top_p``); one step warms up, the next
runs under a ``TorchDispatchMode`` that counts every aten operation by
name. Prints each step's count, the sampled step's extra operations by
name, and those of them that only make a view or read a scalar (no
device work). The count is of operations, not time: a device's time
comes from chip_smoke's profiled steps.
"""

from __future__ import annotations

import collections
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tf_operator_tpu_torch.models.convert import init_params  # noqa: E402
from tf_operator_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
)
from tf_operator_tpu_torch.serve.engine import ContinuousEngine  # noqa: E402

CFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                        n_layers=2, d_ff=64, max_seq_len=64,
                        dtype=torch.float32)
GREEDY = [(0.0, None, 0)] * 4
SAMPLED = [(0.0, None, 0), (0.9, None, 101), (0.7, 0.8, 102),
           (1.0, 0.95, 103)]
# Operations that make a view, an allocation or a host scalar: no kernel.
NO_KERNEL = {"aten.view", "aten.unsqueeze", "aten.select", "aten.detach",
             "aten.scalar_tensor", "aten.lift_fresh", "aten.empty_like",
             "aten.slice", "aten.expand", "aten.reshape", "aten._unsafe_view",
             "aten.t", "aten.transpose", "aten.squeeze"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def step_ops(mix) -> collections.Counter:
    """The aten operations of the second step of a 4-lane engine whose
    lanes join with ``mix``'s (temperature, top_p, seed)."""
    engine = ContinuousEngine(CFG, init_params(CFG, 0), len(mix), kv_block=8,
                              device="cpu")
    for i, (t, tp, seed) in enumerate(mix):
        prompt = (np.arange(5 + i, dtype=np.int32) % CFG.vocab_size)[None]
        engine.join(prompt, num_steps=8, temperature=t, top_p=tp, seed=seed)
    engine.step()
    with _Count() as count:
        engine.step()
    return count.ops


def main() -> int:
    torch.set_num_threads(1)
    greedy, sampled = step_ops(GREEDY), step_ops(SAMPLED)
    extra = sampled - greedy
    views = {k: v for k, v in extra.items() if k in NO_KERNEL}
    print(f"greedy step: {sum(greedy.values())} aten operations; sampled "
          f"step: {sum(sampled.values())}; extra {sum(extra.values())}, of "
          f"them {sum(extra.values()) - sum(views.values())} with device "
          f"work")
    print("extra by name:", dict(extra.most_common()))
    print("extra without device work:", views)
    return 0


if __name__ == "__main__":
    sys.exit(main())
