"""Time two builds of the port's paged-attention kernel on one card.

    python tools/torch_paged_ab.py --baseline OLD.cu

Builds ``OLD.cu`` (an earlier ``paged_attention.cu`` with the same C entry
point, e.g. from ``git show REV:tf_operator_tpu_torch/ops/csrc/
paged_attention.cu``) beside the checkout's own source, holds each
against the plain version at chip_smoke.py's shapes, and times both by
CUDA-graph replay in turns (baseline, current, current, baseline) on the
same inputs: bf16, t=1, 4 lanes at 3500/1750/875/437 tokens, H=16, KV=4,
Dh=64, blk=128, one pool pair per layer for 8 layers. Prints the card
line and one JSON line per turn. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tf_operator_tpu_torch.ops import _build  # noqa: E402
from tf_operator_tpu_torch.ops import paged_attention as pa  # noqa: E402


def _load(source: str, out_dir: str) -> ctypes.CDLL:
    lib = os.path.join(out_dir, "paged_attention_baseline.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                    source], check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier paged_attention.cu to time against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = {"current": pa._library(),
            "baseline": _load(os.path.abspath(args.baseline),
                              _build.BUILD_DIR)}
    fn = libs["baseline"].paged_attend_launch
    fn.argtypes = libs["current"].paged_attend_launch.argtypes
    fn.restype = ctypes.c_int

    q, pools, table, index = cs.paged_case(cs.LANES, 1, torch.bfloat16,
                                           seed=9, layers=cs.LAYERS)
    want = pa.paged_attend_reference(q, *pools[0], table, index)
    bms, bound_by = cs.bound_ms(cs.LANES, 1, torch.bfloat16)
    for name in ("baseline", "current", "current", "baseline"):
        pa._lib = libs[name]  # the wrapper launches through this library
        err = (pa.paged_attend(q, *pools[0], table, index) - want).abs().max()
        ms = cs.device_ms(lambda i: pa.paged_attend(
            q, *pools[i % cs.LAYERS], table, index), 400)
        print(json.dumps(dict(build=name, ms=ms, max_abs_err=err.item(),
                              bound_ms=bms, bound_by=bound_by)), flush=True)
    pa._lib = libs["current"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
