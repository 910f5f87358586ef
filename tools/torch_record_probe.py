"""Run chip_smoke.py's phase 23 (the record input) alone on the card.

    python tools/torch_record_probe.py

Phase 1's settings first (TF32 off for cuDNN and matmuls), then the
flash kernels' build (phase 23 (c)'s entry point runs B1-B3, and its
subprocesses find the library built), phase 21 (b)'s resident ResNet-50
cell (the reading 23 (b) stands beside), and phase 23 (a) to (c) exactly
as chip_smoke.py runs them after phase 22. Exits non-zero without a
card.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_record_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.train.device_input import load_records_numpy

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build("flash_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    with chip_smoke.tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "records.bin")
        record, rec_bytes = chip_smoke.write_bench_records(path)
        images, labels = load_records_numpy(path, rec_bytes, record)
    bench = chip_smoke.resnet_bench_phase(
        card, torch.from_numpy(images).cuda(),
        torch.from_numpy(labels).cuda())
    resident = bench["conv7"]["images_s"]
    del bench
    torch.cuda.empty_cache()
    chip_smoke.record_input_phase(card, resident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
