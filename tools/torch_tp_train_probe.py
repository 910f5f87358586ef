"""Run chip_smoke.py's phase 26 (tensor-, sequence-, fully sharded,
expert- and pipeline-parallel training) alone on the card.

    python tools/torch_tp_train_probe.py

Phase 1's settings first (TF32 off for cuDNN and matmuls), then the
build of the flash kernels (B1-B3; the rank processes load the library
this process built), then phase 26 (a) to (k) exactly as chip_smoke.py
runs them after phase 25, and the launches each path counted. Exits
non-zero without a card.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tp_train_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build("flash_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    paths = chip_smoke.tp_train_phase(card)
    print(json.dumps(paths), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
