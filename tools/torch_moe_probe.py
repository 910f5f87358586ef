"""Run chip_smoke.py's phase 22 (Mixture-of-Experts) alone on the card, then
time phase 9's bf16 trainer with the two gelus in turns.

    python tools/torch_moe_probe.py [--skip-moe] [--skip-gelu]

Phase 1's settings first (TF32 off), the kernels built from this
checkout, then (a) to (d) exactly as chip_smoke.py runs them after phase
21. Then the gelu A/B: phase 9 (``train_bf16_phase``: bench.py's LM
shape, B=2 x T=8192, 7 steps, one profiled) four times in turns, with
``F.gelu`` in one rounding (the MLP before the op-by-op bf16 gelu) and
with ``models/transformer.py``'s ``gelu``: plain, rounded, rounded,
plain. Exits non-zero without a card.
"""

import argparse
import os
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--skip-moe", action="store_true")
    p.add_argument("--skip-gelu", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_moe_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import paged_attention as pa

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build("flash_attention", "int8_dense", "paged_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    if not args.skip_moe:
        base = transformer.TransformerConfig(
            vocab_size=32768, d_model=1024, n_heads=chip_smoke.H,
            n_kv_heads=chip_smoke.KV, n_layers=chip_smoke.LAYERS, d_ff=4096,
            max_seq_len=chip_smoke.S, dtype=torch.float32)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, base.vocab_size, (1, n)).astype(np.int32)
                   for n in chip_smoke.LANES]
        print(chip_smoke.moe_phase(pa, base, prompts, card), flush=True)
        torch.cuda.empty_cache()
    if not args.skip_gelu:
        params = init_params(transformer.TransformerConfig(**chip_smoke.LM),
                             seed=0)
        rounded = transformer.gelu

        def one_rounding(x):
            return F.gelu(x, approximate="tanh")

        for label, fn in (("F.gelu", one_rounding), ("rounded", rounded),
                          ("rounded", rounded), ("F.gelu", one_rounding)):
            print(f"gelu A/B: phase 9 with the {label} gelu", flush=True)
            with mock.patch.object(transformer, "gelu", fn):
                chip_smoke.train_bf16_phase(params, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
