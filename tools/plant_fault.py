"""Plant a fault in a copy of a kernel source and read chip_smoke's
engine check on it.

    python tools/plant_fault.py --into DIR [--fault NAME ...]

For each fault, copies the checkout into ``DIR/<fault>`` (the checkout
itself is never edited), makes one textual change to a kernel source
there, and runs chip_smoke.py's phase 12 in that copy: the f32
int8_decode + kv_int8 engine through the kernels against its plain twin,
in lockstep (``chip_smoke.lockstep_phase``). Phase 12 prints the largest
logit gap it saw beside ``LOGIT_TOL`` and fails when the gap exceeds it;
this tool prints each copy's output and one JSON line per fault, and exits
0 only when phase 12 failed on every fault. The sound tree's reading is
phase 12's own line in chip_smoke's output. Faults:

- ``vs_in_l``: the kv8 paged kernel adds the value-scaled probabilities
  into the softmax's normaliser ``l`` (out = sum p vs v8 / sum p vs);
- ``drop_split``: the int8 matmul kernel's weight stream (``int8_stream``,
  every decode call with k split) leaves the last k-split's partial sums
  out of its cluster reduction through distributed shared memory;
- ``drop_paged_split``: the paged kernel's cluster merge (both variants)
  leaves the last split's P.V partial out of every output, while its
  (max, sum) still weighs the others. The strided split keeps the last
  split live on the 3500-token lane, so the fault shows.

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "tf_operator_tpu_torch/ops/csrc/"

# name -> (source, text, faulty text): the text occurs once in the source.
FAULTS = {
    "vs_in_l": (
        CSRC + "paged_attention.cu",
        "          sum += p;\n",
        "          sum += KV8 ? p * vsc[c] : p;\n",
    ),
    "drop_split": (
        CSRC + "int8_dense.cu",
        "for (int sp = 0; sp < splits; ++sp)",
        "for (int sp = 0; sp < splits - 1; ++sp)",
    ),
    "drop_paged_split": (
        CSRC + "paged_attention.cu",
        "for (int sp = 0; sp < splits; ++sp)\n      o = fmaf(",
        "for (int sp = 0; sp < splits - 1; ++sp)\n      o = fmaf(",
    ),
}

# Phase 12 as chip_smoke's main() sets it up: the serving width, weights
# from seed 0 quantized, the four prompts from seed 1.
PHASE_12 = """
from dataclasses import replace
import numpy as np, torch
import chip_smoke as cs
from tf_operator_tpu_torch.models.convert import (
    init_params, quantize_decode_params)
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.ops import paged_attention as pa
torch.backends.cuda.matmul.allow_tf32 = False
print(cs.card_line(), flush=True)
base = TransformerConfig(vocab_size=32768, d_model=1024, n_heads=cs.H,
                         n_kv_heads=cs.KV, n_layers=cs.LAYERS, d_ff=4096,
                         max_seq_len=cs.S, dtype=torch.float32)
params = init_params(base, seed=0)
rng = np.random.default_rng(1)
prompts = [rng.integers(0, base.vocab_size, (1, n)).astype(np.int32)
           for n in cs.LANES]
cs.lockstep_phase(pa, replace(base, int8_decode=True, kv_int8=True),
                  quantize_decode_params(params), prompts)
"""


def plant(into: str, fault: str) -> str:
    """A copy of the checkout under ``into`` with ``fault`` planted."""
    source, text, faulty = FAULTS[fault]
    copy = os.path.join(into, fault)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(REPO_ROOT, copy, ignore=shutil.ignore_patterns(
        ".git", "_build", "chiprun_out", "artifacts", "__pycache__"))
    path = os.path.join(copy, source)
    with open(path) as f:
        code = f.read()
    if code.count(text) != 1:
        raise RuntimeError(f"{fault}: {text!r} occurs {code.count(text)} "
                           f"times in {source}, want once")
    with open(path, "w") as f:
        f.write(code.replace(text, faulty))
    return copy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--into", required=True,
                    help="a directory outside the checkout for the copies")
    ap.add_argument("--fault", action="append", choices=sorted(FAULTS),
                    help="the faults to plant (default: all)")
    args = ap.parse_args()
    into = os.path.abspath(args.into)
    if (into + os.sep).startswith(REPO_ROOT + os.sep):
        ap.error("--into must lie outside the checkout")
    caught = True
    for fault in args.fault or sorted(FAULTS):
        copy = plant(into, fault)
        run = subprocess.run([sys.executable, "-c", PHASE_12], cwd=copy,
                             capture_output=True, text=True, timeout=1200)
        print(run.stdout + run.stderr[-4000:], flush=True)
        failed = run.returncode != 0 and "disagree" in run.stderr
        caught = caught and failed
        print(json.dumps(dict(fault=fault, source=FAULTS[fault][0],
                              returncode=run.returncode,
                              phase_12_failed=failed)), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
