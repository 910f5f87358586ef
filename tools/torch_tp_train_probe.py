"""Run chip_smoke.py's phase 26 (tensor-, sequence-, fully sharded,
expert- and pipeline-parallel training) alone on the card.

    python tools/torch_tp_train_probe.py [--phase-9b]

Phase 1's settings first (TF32 off for cuDNN and matmuls), then the
build of the flash kernels (B1-B3; the rank processes load the library
this process built), with ``--phase-9b`` chip_smoke's phase 9 (b)
(``fuse_steps`` and ``TPU_OPERATOR_ATTN`` on phase 9's cell), then phase
26 (a) to (o) exactly as chip_smoke.py runs them after phase 25, and the
launches each path counted. Exits non-zero without a card.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--phase-9b", action="store_true",
                   help="run phase 9 (b) first")
    args = p.parse_args()
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
    paths = {}
    if args.phase_9b:
        from tf_operator_tpu_torch.models.convert import init_params
        from tf_operator_tpu_torch.models.transformer import (
            TransformerConfig,
        )

        t0 = time.perf_counter()
        paths.update(chip_smoke.dispatch_fuse_phase(
            init_params(TransformerConfig(**chip_smoke.LM), seed=0), card))
        print(f"phase 9 (b): {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    ahead: dict = {}
    try:
        paths.update(chip_smoke.tp_train_phase(card, ahead))
    finally:
        # Phase 27's workers, started as phase 26 ends: no world here.
        for spawned in ahead.values():
            spawned.discard()
    print(json.dumps(paths), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
