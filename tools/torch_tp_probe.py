"""Run chip_smoke.py's phase 25 (tensor-parallel serving) alone on the card.

    python tools/torch_tp_probe.py

Phase 1's settings first (TF32 off for cuDNN and matmuls), then the
build of the kernels phase 25 runs (B4 and its kv8 variant, B5; the
worker rank loads the library this process built), phase 6's model,
weights and prompts, then phase 25 (a) to (c) exactly as chip_smoke.py
runs them after phase 24, and the launches each path counted. Exits
non-zero without a card.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tp_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import int8_dense as i8
    from tf_operator_tpu_torch.ops import paged_attention as pa

    card = chip_smoke.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build("paged_attention", "int8_dense")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    base = TransformerConfig(
        vocab_size=32768, d_model=1024, n_heads=chip_smoke.H,
        n_kv_heads=chip_smoke.KV, n_layers=chip_smoke.LAYERS, d_ff=4096,
        max_seq_len=chip_smoke.S, dtype=torch.float32)
    params = init_params(base, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab_size, (1, n)).astype(np.int32)
               for n in chip_smoke.LANES]
    ahead: dict = {}
    try:
        paths = chip_smoke.tp_phase(pa, i8, base, params, prompts, card, {},
                                    ahead)
    finally:
        for spawned in ahead.values():
            spawned.discard()
    print(json.dumps(paths), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
