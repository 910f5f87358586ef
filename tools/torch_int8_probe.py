"""Time variants of the int8 matmul kernel (B5) on one card, to find what
sets its pace.

    python tools/torch_int8_probe.py [--shapes all|decode|prefill]

Each variant is a copy of ``csrc/int8_dense.cu`` with one textual change
(``VARIANTS``: the text occurs once in the source, which is never edited),
built beside the checkout's own library, all with one nvcc each started
together, and launched through the same wrapper
(``tf_operator_tpu_torch.ops.int8_dense``), at chip_smoke.py's shapes and
weights (bf16 x, a bias, bf16 out, the head's f32; distinct weights a
call, CUDA-graph replay):

- decode (m=4), for each (k, n) of ``chip_smoke.INT8_CALLS``: the weight
  stream as it is, and ``loads_only``, its FMAs left out (if it runs no
  faster, the ALUs do not set the pace); one decode forward's 41 calls;
  then the launch floor (m=4, k=64, n=128: one CTA, 8 KB);
- prefill (m=3500, 1024x4096): the TMA + wgmma tile as it is,
  ``widen_once``, the weights widened at its first k step only and reused,
  and ``no_products``, no wgmma issued.

A variant's output is wrong by design; only the sources as they are are
held to the plain version. Prints the card line and one JSON line per
measurement. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
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
from tf_operator_tpu_torch.ops import int8_dense as i8  # noqa: E402
from tf_operator_tpu_torch.testing import INT8_TOL, excess  # noqa: E402

# name -> (text of csrc/int8_dense.cu, its replacement).
VARIANTS = {
    "loads_only": (
        "fma_row<M>(acc, u[i], xs, chunk, r0 + i * kRowLanes);",
        "acc[0][0] += __uint_as_float(u[i].x);",
    ),
    "widen_once": (
        "widen_a(a, smem + kPW + s * kPWBytes, n_base, g, t);",
        "if (i == 0) widen_a(a, smem + kPW + s * kPWBytes, n_base, g, t);",
    ),
    "no_products": (
        "sm90::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[0][0]),\n"
        "                          a[kk], sm90::desc_sw128(xs + kk * 32));",
        ";",
    ),
}
DECODE_VARIANTS = ("loads_only",)
PREFILL_VARIANTS = ("widen_once", "no_products")


def variant_source(name: str) -> str:
    """The kernel source with variant ``name``'s change made."""
    text, new = VARIANTS[name]
    with open(_build.source_path("int8_dense")) as f:
        code = f.read()
    if code.count(text) != 1:
        raise RuntimeError(f"{name}: {text!r} occurs {code.count(text)} times "
                           "in int8_dense.cu, want once")
    return code.replace(text, new)


def build(names) -> dict:
    """{name: library} of each variant, built with one nvcc each."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(_build.BUILD_DIR, f"int8_dense_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        lib = src[:-3] + ".so"
        # -I: the copy still finds the checkout's headers.
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    current = i8._library()  # the checkout's own, built meanwhile
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log.decode()[-4000:]}")
        lib = ctypes.CDLL(path)
        for entry in ("int8_matmul_launch", "int8_design"):
            getattr(lib, entry).argtypes = getattr(current, entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(lib):
    """The wrapper launches through ``lib`` (None: the checkout's own)."""
    current = i8._library()
    i8._lib = lib or current
    try:
        yield
    finally:
        i8._lib = current


def decode(libs):
    weights, xs, forward = cs.int8_forward_case()
    for (k, n), ws in weights.items():
        dt = cs.head_dtype(n)
        by_bytes, _ = cs.int8_bounds_ms(cs.DECODE_M, k, n,
                                        4 if dt == torch.float32 else 2)
        want = i8.int8_matmul_reference(xs[k], *ws[0][:2], dt, ws[0][2])
        lines = {}
        for name in (None, *DECODE_VARIANTS):
            with using(libs.get(name)):
                got = i8.int8_matmul(xs[k], *ws[0][:2], dt, ws[0][2])
                lines[name or "as_is"] = dict(
                    ms=cs.device_ms(lambda i: i8.int8_matmul(
                        xs[k], *ws[i % len(ws)][:2], dt, ws[i % len(ws)][2]),
                        64),
                    share_of_bound=(None if name else
                                    excess(got, want, *INT8_TOL[dt])))
        print(json.dumps(dict(m=cs.DECODE_M, k=k, n=n, bound_ms=by_bytes,
                              variants=lines)), flush=True)
    fwd = cs.device_ms(lambda i: [i8.int8_matmul(*c) for c in forward], 10)
    print(json.dumps(dict(forward_calls=len(forward), forward_ms=fwd)),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tiny = [(torch.randn((4, 64), generator=gen, device="cuda").bfloat16(),
             *w) for w in cs.int8_weights(64, 128, 8, seed=5)]
    floor = cs.device_ms(lambda i: i8.int8_matmul(
        tiny[i % 8][0], *tiny[i % 8][1:3], torch.bfloat16, tiny[i % 8][3]),
        64)
    print(json.dumps(dict(launch_floor_ms=floor, m=4, k=64, n=128)),
          flush=True)


def prefill(libs):
    k, n = 1024, 4096
    weights = cs.int8_weights(k, n, 8, seed=k + n)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((cs.PREFILL_M, k), generator=gen,
                    device="cuda").bfloat16()
    _, by_ops = cs.int8_bounds_ms(cs.PREFILL_M, k, n, 2)
    out = {}
    for name in (None, *PREFILL_VARIANTS):
        with using(libs.get(name)):
            out[name or "as_is"] = cs.device_ms(lambda i: i8.int8_matmul(
                x, *weights[i % 8][:2], torch.bfloat16, weights[i % 8][2]),
                16)
    print(json.dumps(dict(m=cs.PREFILL_M, k=k, n=n, bound_ms=by_ops,
                          variants_ms=out)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="all",
                    choices=("all", "decode", "prefill"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    names = ((DECODE_VARIANTS if args.shapes != "prefill" else ())
             + (PREFILL_VARIANTS if args.shapes != "decode" else ()))
    libs = build(names)
    if args.shapes in ("all", "decode"):
        decode(libs)
    if args.shapes in ("all", "prefill"):
        prefill(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
