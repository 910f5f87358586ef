"""Run chip_smoke.py's phase 24 (data parallelism) alone on the card.

    python tools/torch_dp_probe.py

Phase 1's settings first (TF32 off for cuDNN and matmuls), then the
flash kernels' build (every rank of phase 24 runs B1-B3, and the
subprocesses find the library built), then phase 24 (a) to (c) exactly
as chip_smoke.py runs them after phase 23, and the launches each path
counted. Exits non-zero without a card.
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
        print("torch_dp_probe: torch sees no CUDA device", file=sys.stderr)
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
    print(json.dumps(chip_smoke.dp_phase(card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
