"""Time two builds of one of the port's CUDA kernel sources on one card.

    python tools/torch_kernel_ab.py --kernel paged --baseline OLD.cu
    python tools/torch_kernel_ab.py --kernel flash --baseline OLD.cu
    python tools/torch_kernel_ab.py --kernel int8 --baseline OLD.cu
    python tools/torch_kernel_ab.py --checkout DIR
    python tools/torch_kernel_ab.py --kernel paged --splits 8,16
    python tools/torch_kernel_ab.py --kernel paged --variant tile64

Builds ``OLD.cu`` (an earlier ``paged_attention.cu``,
``flash_attention.cu`` or ``int8_dense.cu`` with the same C entry points,
e.g. from ``git show REV:tf_operator_tpu_torch/ops/csrc/int8_dense.cu``)
beside the
checkout's own source, holds each build against the plain versions, and
times both by CUDA-graph replay in turns (baseline, current, current,
baseline) on the same inputs at chip_smoke.py's shapes:

- paged: bf16 q, t=1, 4 lanes at 3500/1750/875/437 tokens, H=16, KV=4,
  Dh=64, blk=128, one pool pair per layer for 8 layers, bf16 pools and
  (kv8) int8 pools with their scales; the error is the max-abs error
  against the plain version;
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
nvcc. ``--kernel paged`` needs a baseline with the one-launch cluster
kernel's C entries (no scratch pointers, the cluster size in place of
``bps``/``nsplit``): a source from before that design has other
signatures; time it with ``--checkout`` instead.

``--splits A,B`` times the checkout's paged kernel at two cluster sizes
(``paged_attention.SPLITS``) in turns (A, B, B, A). ``--variant NAME``
times a copy of the checkout's kernel source with one textual change
(``VARIANTS``) against the source as it is, in turns (variant, current,
current, variant).

``--checkout DIR`` compares whole checkouts, each with its own wrapper and
source: DIR (e.g. ``git archive`` of an earlier commit unpacked into a
git-ignored directory) and this one run chip_smoke.py's paged phases, 3
(``kernel_phase``) and 11 (its kv8 variant), each in a process of its own
in its own directory, in turns (baseline, current, current, baseline);
one JSON line per turn gives both variants' device ms, error against the
plain version, bound and SDPA's ms.
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
    """(module, entry points, one turn's measurement) of the paged kernel,
    both variants."""
    cases = {}
    for kv8 in (False, True):
        q, pools, table, index = cs.attend_case(
            cs.LANES, 1, torch.bfloat16, 9, kv8, layers=cs.LAYERS)
        pk, pv, scales = pools[0]
        want = pa.paged_attend_reference(q, pk, pv, table, index, **scales)
        cases["kv8" if kv8 else "bf16"] = (
            q, pools, table, index, want,
            cs.bound_ms(cs.LANES, 1, torch.bfloat16, kv8)[0])

    def turn() -> dict:
        out = dict(splits=pa.SPLITS)
        for name, (q, pools, table, index, want, bms) in cases.items():
            pk, pv, scales = pools[0]
            err = (pa.paged_attend(q, pk, pv, table, index, **scales)
                   - want).abs().max()

            def call(i, q=q, pools=pools, table=table, index=index):
                pk, pv, scales = pools[i % cs.LAYERS]
                return pa.paged_attend(q, pk, pv, table, index, **scales)

            out[name] = dict(ms=cs.device_ms(call, 400),
                             max_abs_err=err.item(), bound_ms=bms)
        return out

    return pa, ("paged_attend_launch", "paged_attend_kv8_launch"), turn


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
# Textual variants of a kernel source: name -> (kernel, text, changed
# text); the text occurs once in the source.
VARIANTS = {
    # 64-column K/V tiles for bf16 pools at Dh 64 (128 as it is).
    "tile64": ("paged", "  return sizeof(TKV) * DH >= 512 ? 64 : 128;",
               "  return sizeof(TKV) * DH >= 512 || "
               "(sizeof(TKV) == 2 && DH == 64) ? 64 : 128;"),
}
SOURCES = {"paged": "paged_attention", "flash": "flash_attention",
           "int8": "int8_dense"}


def variant_source(name: str) -> str:
    """The checkout's kernel source with variant ``name``'s change."""
    kernel, text, changed = VARIANTS[name]
    with open(_build.source_path(SOURCES[kernel])) as f:
        code = f.read()
    if code.count(text) != 1:
        raise RuntimeError(f"{name}: {text!r} occurs {code.count(text)} "
                           "times, want once")
    return code.replace(text, changed)


# chip_smoke's phases 3 and 11 in a checkout's own directory.
PAGED_PHASES = """
import json, torch
import chip_smoke as cs
from tf_operator_tpu_torch.ops import _build, paged_attention as pa
torch.backends.cuda.matmul.allow_tf32 = False
_build.build("paged_attention")
print(json.dumps(dict(paged=cs.kernel_phase(pa),
                      kv8=cs.kernel_phase(pa, kv8=True))))
"""


def checkout_turns(baseline: str) -> int:
    """Phases 3 and 11 of ``baseline`` and of this checkout, in turns."""
    dirs = {"baseline": os.path.abspath(baseline), "current": REPO_ROOT}
    for name in ("baseline", "current", "current", "baseline"):
        run = subprocess.run([sys.executable, "-c", PAGED_PHASES],
                             cwd=dirs[name], capture_output=True, text=True,
                             timeout=900)
        if run.returncode:
            print(run.stdout + run.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps(dict(build=name, checkout=dirs[name],
                              **json.loads(run.stdout.splitlines()[-1]))),
              flush=True)
    return 0


# Entries the wrapper reads beside the launch, which an earlier source may
# lack: int8_design only sorts the wrapper's launch counts.
BORROWED = {"int8": ("int8_design",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS))
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--baseline",
                       help="an earlier source of that kernel to time against")
    which.add_argument("--checkout",
                       help="an earlier checkout whose paged phases to time "
                            "against")
    which.add_argument("--variant", choices=sorted(VARIANTS),
                       help="a textual variant of the checkout's source")
    which.add_argument("--splits",
                       help="two paged cluster sizes to time, e.g. 8,16")
    args = ap.parse_args()
    if (args.baseline or args.splits) and not args.kernel:
        ap.error("--baseline and --splits need --kernel")
    if args.splits and args.kernel != "paged":
        ap.error("--splits is for --kernel paged")
    if args.variant:
        args.kernel = VARIANTS[args.variant][0]
    if not torch.cuda.is_available():
        print("torch_kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    if args.checkout:
        return checkout_turns(args.checkout)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    module, entries, turn = KERNELS[args.kernel]()
    if args.splits:
        a, b = (int(s) for s in args.splits.split(","))
        for splits in (a, b, b, a):
            pa.SPLITS = splits
            print(json.dumps(dict(build="current", **turn())), flush=True)
        return 0
    baseline = args.baseline
    if args.variant:
        baseline = os.path.join(_build.BUILD_DIR,
                                f"{SOURCES[args.kernel]}_{args.variant}.cu")
        with open(baseline, "w") as f:
            f.write(variant_source(args.variant))
    libs = {"current": module._library(),
            "baseline": _load(module, os.path.abspath(baseline),
                              entries, BORROWED.get(args.kernel, ()))}
    label = args.variant or "baseline"
    for name in ("baseline", "current", "current", "baseline"):
        module._lib = libs[name]  # the wrappers launch through this library
        print(json.dumps(dict(build=label if name == "baseline" else name,
                              **turn())), flush=True)
    module._lib = libs["current"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
