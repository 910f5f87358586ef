"""Run chip_smoke.py's phases 27 (tensor x data parallel serving, with
27 (c)'s shipment and pull) and 28 (spec and the host tier under tp) alone
on the card.

    python tools/torch_tpdp_probe.py

Phase 1's settings first (TF32 off for cuDNN and matmuls), then the
build of the paged kernel (the worker ranks load the library this process
built), phase 6's model, weights and prompts, then phase 25 (b) (the tp 1
front phase 27 holds its tokens, pool bytes and latency against, and the
tp 2 front beside it), then phases 27 and 28 exactly as chip_smoke.py
runs them after phase 26, and the launches each path counted. After each
phase it prints where rank 0's world start-ups spent their seconds: the
process group's start (the workers' imports and card start-up), the
weights' broadcast, the engine builds and the warm-ups. Exits non-zero
without a card.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def time_world_starts() -> list:
    """Wrap rank 0's world start-up steps with timers; returns the list
    they append (step, seconds) to."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.serve import engine, serve_lm, tp

    log: list = []

    def timed(owner, name, label):
        inner = getattr(owner, name)

        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                log.append((label, round(time.perf_counter() - t, 3)))

        setattr(owner, name, run)

    timed(serve_lm, "start_world", "start_world")
    timed(dist, "init_process_group", "  init_process_group")
    timed(tp, "broadcast_tree", "  broadcast_tree")
    timed(engine.ContinuousEngine, "__init__", "engine build")
    timed(engine.ContinuousEngine, "warmup", "warmup (with the workers' "
          "builds)")
    return log


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tpdp_probe: torch sees no CUDA device", file=sys.stderr)
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
    _build.build("paged_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    base = TransformerConfig(
        vocab_size=32768, d_model=1024, n_heads=chip_smoke.H,
        n_kv_heads=chip_smoke.KV, n_layers=chip_smoke.LAYERS, d_ff=4096,
        max_seq_len=chip_smoke.S, dtype=torch.float32)
    params = init_params(base, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab_size, (1, n)).astype(np.int32)
               for n in chip_smoke.LANES]
    ref: dict = {}
    starts = time_world_starts()
    t0 = time.perf_counter()
    front = chip_smoke.tp_front_phase(pa, i8, base, params, prompts, card,
                                      ref)
    print(f"phase 25 (b): {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"start-up steps (25 b): {starts}", flush=True)
    starts.clear()
    torch.cuda.empty_cache()
    paths = chip_smoke.tpdp_phase(pa, i8, base, params, prompts, card, ref)
    print(f"start-up steps (27): {starts}", flush=True)
    starts.clear()
    torch.cuda.empty_cache()
    spec = chip_smoke.tp_spec_phase(pa, i8, base, params, prompts, card,
                                    ref)
    print(f"start-up steps (28): {starts}", flush=True)
    paths["paged_attend"].update(spec["paged_attend"])
    paths["paged_attend"]["serve_lm tp 2 (25b)"] = front
    print(json.dumps(paths), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
