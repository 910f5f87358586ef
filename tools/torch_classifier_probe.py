"""Run chip_smoke.py's phase 21 (the image classifiers) alone on the card.

    python tools/torch_classifier_probe.py

Phase 1's settings first (TF32 off for cuDNN and matmuls), then (a) to
(c) as chip_smoke.py runs them after phase 20, then (d), which
chip_smoke.py runs beside phase 22 (c) and (d), alone. Builds no kernel:
no hand kernel lies on this path. Exits non-zero without a card.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_classifier_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.classifier_phase(card)
    chip_smoke.mnist_entry_phase(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
