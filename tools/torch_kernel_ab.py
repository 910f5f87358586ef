"""Time two builds of one of the port's CUDA kernel sources on one card.

    python tools/torch_kernel_ab.py --kernel paged --baseline OLD.cu
    python tools/torch_kernel_ab.py --kernel flash --baseline OLD.cu
    python tools/torch_kernel_ab.py --kernel int8 --baseline OLD.cu

Builds ``OLD.cu`` (an earlier ``paged_attention.cu``,
``flash_attention.cu`` or ``int8_dense.cu`` with the same C entry points,
e.g. from ``git show REV:tf_operator_tpu_torch/ops/csrc/int8_dense.cu``)
beside the
checkout's own source, holds each build against the plain versions, and
times both by CUDA-graph replay in turns (baseline, current, current,
baseline) on the same inputs at chip_smoke.py's shapes:

- paged: bf16, t=1, 4 lanes at 3500/1750/875/437 tokens, H=16, KV=4,
  Dh=64, blk=128, one pool pair per layer for 8 layers; the error is the
  max-abs error against the plain version;
- flash: the forward, dQ and dK/dV kernels at B=2, H=16, T=8192, Dh=64,
  bf16, causal; the errors are each output's largest share of its bound
  (tf_operator_tpu_torch.testing) at T=1000;
- int8: one decode forward's 41 int8 matmuls at m=4 as the bf16 model
  makes them (bf16 x, a bias, bf16 out, the head's f32; distinct
  weights), each (k, n) alone at m=4 (no bias, f32 out), and m=3500
  against 1024x4096; the error is the largest share of the bound of the
  rule in
  tf_operator_tpu_torch.testing over the first and last calls of the
  forward and the m=3500 call.

Prints the card line and one JSON line per turn. Needs a CUDA card and
nvcc.
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
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402
from tf_operator_tpu_torch.ops import int8_dense as i8  # noqa: E402
from tf_operator_tpu_torch.ops import paged_attention as pa  # noqa: E402
from tf_operator_tpu_torch.testing import (  # noqa: E402
    INT8_TOL,
    excess,
    flash_excess,
)


def _load(module, source: str, entries, borrowed=()) -> ctypes.CDLL:
    """Build ``source`` into the build directory and give its entry points
    the argument types of the checkout's build of ``module``. An entry of
    ``borrowed`` that an older source lacks is the checkout's own."""
    name = module.__name__.rsplit(".", 1)[-1]
    lib_path = os.path.join(_build.BUILD_DIR, f"{name}_baseline.so")
    # -I: a baseline kept outside csrc/ still finds the checkout's headers.
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", lib_path, source], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    current = module._library()
    for entry in entries:
        getattr(lib, entry).argtypes = getattr(current, entry).argtypes
        getattr(lib, entry).restype = ctypes.c_int
    for entry in borrowed:
        if not hasattr(lib, entry):
            setattr(lib, entry, getattr(current, entry))
    return lib


def paged():
    """(module, entry points, one turn's measurement) of the paged kernel."""
    q, pools, table, index = cs.paged_case(cs.LANES, 1, torch.bfloat16,
                                           seed=9, layers=cs.LAYERS)
    want = pa.paged_attend_reference(q, *pools[0], table, index)
    bms, bound_by = cs.bound_ms(cs.LANES, 1, torch.bfloat16)

    def turn() -> dict:
        err = (pa.paged_attend(q, *pools[0], table, index) - want).abs().max()
        ms = cs.device_ms(lambda i: pa.paged_attend(
            q, *pools[i % cs.LAYERS], table, index), 400)
        return dict(ms=ms, max_abs_err=err.item(), bound_ms=bms,
                    bound_by=bound_by)

    return pa, ("paged_attend_launch",), turn


def flash():
    """(module, entry points, one turn's measurement) of the flash
    kernels."""
    scale = cs.DH ** -0.5
    small = cs.flash_inputs(2, 1000, 1000, torch.bfloat16, seed=1)
    o_ref, lse_ref = fa.flash_fwd_reference(*small[:3], True, scale)
    delta = (small[3].float() * o_ref.float()).sum(-1).transpose(
        1, 2).contiguous()
    small_stats = (*small, lse_ref, delta, True, scale)
    want = dict(o=o_ref, dq=fa.flash_dq_reference(*small_stats))
    want["dk"], want["dv"] = fa.flash_dkv_reference(*small_stats)

    q, k, v, do = cs.flash_inputs(cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN_T,
                                  torch.bfloat16, seed=11, fused=True)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    stats = (q, k, v, do, lse, delta, True, scale)
    bounds = cs.flash_bounds(cs.TRAIN_B, cs.TRAIN_T)

    def turn() -> dict:
        got = dict(o=fa.flash_fwd(*small[:3], True, scale)[0],
                   dq=fa.flash_dq(*small_stats))
        got["dk"], got["dv"] = fa.flash_dkv(*small_stats)
        ms = {"flash_fwd": cs.device_ms(
                  lambda i: fa.flash_fwd(q, k, v, True, scale), 10),
              "flash_dq": cs.device_ms(lambda i: fa.flash_dq(*stats), 10),
              "flash_dkv": cs.device_ms(lambda i: fa.flash_dkv(*stats), 10)}
        return dict(ms=ms, share_of_bound={
            name: flash_excess(name, got[name], want[name]) for name in got},
            bound_ms={name: b[0] for name, b in bounds.items()})

    return fa, ("flash_fwd_launch", "flash_dq_launch", "flash_dkv_launch"), \
        turn


def int8():
    """(module, entry points, one turn's measurement) of the int8 matmul
    kernel."""
    weights, xs, forward = cs.int8_forward_case()
    gen = torch.Generator(device="cuda").manual_seed(13)
    x_pre = torch.randn((cs.PREFILL_M, 1024), generator=gen,
                        device="cuda").bfloat16()
    pre = [(w_q, scale, torch.bfloat16, bias)
           for w_q, scale, bias in weights[(1024, 4096)]]
    checks = [(call, i8.int8_matmul_reference(*call))
              for call in (forward[0], forward[-1], (x_pre, *pre[0]))]
    bound = sum(cs.int8_bounds_ms(call[0].shape[0], *call[1].shape)[0]
                for call in forward)

    def turn() -> dict:
        share = max(excess(i8.int8_matmul(*call), want, *INT8_TOL[want.dtype])
                    for call, want in checks)
        shape_ms = {f"{k}x{n}": cs.device_ms(
            lambda i: i8.int8_matmul(xs[k], *ws[i % len(ws)][:2]), 64)
            for (k, n), ws in weights.items()}
        return dict(
            forward_ms=cs.device_ms(
                lambda i: [i8.int8_matmul(*call) for call in forward], 10),
            forward_bound_ms=bound, shape_ms=shape_ms,
            prefill_ms=cs.device_ms(
                lambda i: i8.int8_matmul(x_pre, *pre[i % len(pre)]), 16),
            share_of_bound=share)

    return i8, ("int8_matmul_launch",), turn


KERNELS = {"paged": paged, "flash": flash, "int8": int8}
# Entries the wrapper reads beside the launch, which an earlier source may
# lack: int8_design only sorts the wrapper's launch counts.
BORROWED = {"int8": ("int8_design",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--baseline", required=True,
                    help="an earlier source of that kernel to time against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    module, entries, turn = KERNELS[args.kernel]()
    libs = {"current": module._library(),
            "baseline": _load(module, os.path.abspath(args.baseline),
                              entries, BORROWED.get(args.kernel, ()))}
    for name in ("baseline", "current", "current", "baseline"):
        module._lib = libs[name]  # the wrappers launch through this library
        print(json.dumps(dict(build=name, **turn())), flush=True)
    module._lib = libs["current"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
