"""Run chip_smoke.py's phase 22 (Mixture-of-Experts) alone on the card, then
time phase 9's bf16 trainer with the two gelus in turns.

    python tools/torch_moe_probe.py [--skip-moe] [--skip-gelu] [--route-repeats N]

Phase 1's settings first (TF32 off), the kernels built from this
checkout, then (a) to (d) exactly as chip_smoke.py runs them after phase
21. Then the gelu A/B: phase 9 (``train_bf16_phase``: bench.py's LM
shape, B=2 x T=8192, 7 steps, one profiled) four times in turns, with
``F.gelu`` in one rounding (the MLP before the op-by-op bf16 gelu) and
with ``models/transformer.py``'s ``gelu``: plain, rounded, rounded,
plain. With ``--route-repeats N``, first phase 22 (a)'s router
probabilities (the reduced f32 MoE LM's no-grad forward, TF32 off) N
times on the CPU and N times on the card: the distinct results on each
side and each repeat's card-vs-CPU distance against ``MOE_PROB_TOL``.
Exits non-zero without a card.
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


def route_repeats(n: int) -> None:
    """Phase 22 (a)'s routes ``n`` times on each device."""
    from tf_operator_tpu_torch.models.convert import init_params, load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )

    cfg = TransformerConfig(dtype=torch.float32, **chip_smoke.MOE_F32)
    params = init_params(cfg, seed=3)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size,
        (chip_smoke.MOE_F32_B, chip_smoke.MOE_F32_T)).astype(np.int64))
    models = {"cpu": load_params(Transformer(cfg, "cpu"), params),
              "cuda": load_params(Transformer(cfg), params)}
    runs = {dev: [chip_smoke.moe_routes(model, tokens.to(model.device))
                  for _ in range(n)] for dev, model in models.items()}

    def key(routes):
        return b"".join(p.numpy().tobytes() for _, p in routes)

    dists = [max((g[1] - w[1]).abs().max().item() for g, w in zip(c, h))
             for c, h in zip(runs["cuda"], runs["cpu"])]
    print(f"moe f32 (22a) routes, {n} repeats a device ({torch.get_num_threads()}"
          f" CPU threads): distinct router probabilities CPU "
          f"{len({key(r) for r in runs['cpu']})}, card "
          f"{len({key(r) for r in runs['cuda']})}; card vs CPU at most "
          f"{[f'{d:.3e}' for d in dists]} (tolerance "
          f"{chip_smoke.MOE_PROB_TOL})", flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--skip-moe", action="store_true")
    p.add_argument("--skip-gelu", action="store_true")
    p.add_argument("--route-repeats", type=int, default=0)
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
    if args.route_repeats:
        route_repeats(args.route_repeats)
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
