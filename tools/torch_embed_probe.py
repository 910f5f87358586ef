"""Time the two embedding backwards on the card: the model's ``Embed``
(indexing, whose backward is ``index_put_`` with accumulate) against
``F.embedding``'s, alone and inside chip_smoke.py's trainers.

    python tools/torch_embed_probe.py

Phase 1's settings first (TF32 off), the kernels built from this
checkout. Then (1) the embedding's forward and backward alone at phase
9's shape (B=2 x T=8192 ids over a 32768 x 1024 f32 table, bf16 rows),
each way by CUDA events, in turns; (2) phase 9 (``train_bf16_phase``:
bench.py's LM shape, 7 steps, one profiled) and phase 22 (b)
(``moe_bench_phase``: the MoE trainer at the same width) four times in
turns, with ``F.embedding`` (the embedding before ROADMAP C2's repair)
and with indexing: F.embedding, indexing, indexing, F.embedding. Each
trainer prints its tokens/s. Exits non-zero without a card.
"""

import os
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TURNS = ("F.embedding", "indexing", "indexing", "F.embedding")
ALONE_ITERS = 50


def functional_forward(self, ids):
    return F.embedding(ids, self.weight).to(self.dtype)


def embed_alone(transformer, card: str) -> None:
    """(1): forward + backward of one Embed at phase 9's shape."""
    cfg = chip_smoke.LM
    store = transformer._Store(torch.float32, False, torch.device("cuda"))
    embed = transformer.Embed(cfg["vocab_size"], cfg["d_model"],
                              torch.bfloat16, store)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, cfg["vocab_size"], (chip_smoke.TRAIN_B, chip_smoke.TRAIN_T)
    ).astype(np.int64)).cuda()
    grad = torch.randn(*ids.shape, cfg["d_model"], device="cuda",
                       dtype=torch.bfloat16)
    indexing = transformer.Embed.forward
    for label in TURNS:
        forward = indexing if label == "indexing" else functional_forward

        def step(_i):
            embed.weight.grad = None
            forward(embed, ids).backward(grad)

        ms = chip_smoke.cuda_ms(step, ALONE_ITERS)
        print(f"embed alone ({label}): {ids.numel()} ids over "
              f"{tuple(embed.weight.shape)} f32, bf16 rows: forward + "
              f"backward {ms:.6f} ms a call ({ALONE_ITERS} calls) on {card}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_embed_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build("flash_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    embed_alone(transformer, card)
    params = init_params(transformer.TransformerConfig(**chip_smoke.LM),
                         seed=0)
    for phase, run in (("phase 9", lambda: chip_smoke.train_bf16_phase(
                            params, card)),
                       ("phase 22 (b)", lambda: chip_smoke.moe_bench_phase(
                           card))):
        for label in TURNS:
            print(f"embedding A/B: {phase} with {label}", flush=True)
            if label == "indexing":
                run()
            else:
                with mock.patch.object(transformer.Embed, "forward",
                                       functional_forward):
                    run()
            torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
