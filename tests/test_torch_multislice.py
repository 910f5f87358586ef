"""Multislice training (tf_operator_tpu_torch/train/dist_multislice.py)
held against JAX's example (examples/dist_multislice.py) on the CPU.

The port runs 2 slices x 2 gloo processes, each slice a world of its own
from the in-slice env, the slices meeting over the DCN channel; JAX's
example runs 2 slices x 1 process. With and without ``--fsdp``, every
process prints the example's lines and ``dist_multislice: OK``, and the
final ``w`` (what the closing agreement check sends over DCN, recorded by
a wrapper around ``cross_slice_mean``) is within ``W_TOL`` 1e-5 of JAX's:
the port takes each slice's mean gradient as the mean of its processes'
halves, which equals JAX's mean over the slice's rows up to the order of
the sums. ``--fsdp`` with a ``--dim`` its processes do not divide exits 1
with JAX's message.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_TOL = 1e-5
TIMEOUT = 180

# Run the port's entry point (argv[2] "port") or JAX's example ("jax") with
# its DCN mean wrapped: each numpy tree it sends (the closing agreement
# check's final w) is saved to argv[1].
WRAPPER = """
import os, runpy, sys
import numpy as np
out, kind = sys.argv[1], sys.argv[2]
if kind == "jax":
    from tf_operator_tpu.train import dcn
else:
    from tf_operator_tpu_torch.train import dcn
orig = dcn.cross_slice_mean
def record(channel, tree):
    if isinstance(tree, np.ndarray):
        np.save(out, tree)
    return orig(channel, tree)
dcn.cross_slice_mean = record
sys.argv = ["dist_multislice", *sys.argv[3:]]
if kind == "jax":
    runpy.run_path(os.path.join(os.environ["REPO"], "examples",
                                "dist_multislice.py"), run_name="__main__")
else:
    runpy.run_module("tf_operator_tpu_torch.train.dist_multislice",
                     run_name="__main__")
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_slices(kind, procs, args, tmp, slices=2):
    """``slices`` slices of ``procs`` processes each: (exit codes,
    outputs, saved final w) in slice-major order."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "MEGASCALE_", "TF_CONFIG"))
            and k != "XLA_FLAGS"}
    base.update(OMP_NUM_THREADS="1", REPO=REPO, JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""))
    if slices > 1:
        base.update(MEGASCALE_NUM_SLICES=str(slices),
                    MEGASCALE_COORDINATOR_ADDRESS=f"127.0.0.1:{_port()}")
    runs = []
    for sl in range(slices):
        coord = f"127.0.0.1:{_port()}"
        for r in range(procs):
            env = dict(base, TPU_NUM_PROCESSES=str(procs),
                       TPU_WORKER_ID=str(r))
            if slices > 1:
                env["MEGASCALE_SLICE_ID"] = str(sl)
            if procs > 1:
                env["TPU_COORDINATOR_ADDRESS"] = coord
            out = os.path.join(tmp, f"{kind}{sl}_{r}.npy")
            extra = ["--device", "cpu"] if kind == "port" else []
            runs.append((out, subprocess.Popen(
                [sys.executable, "-c", WRAPPER, out, kind, *args, *extra],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    codes, outs, ws = [], [], []
    try:
        for out, proc in runs:
            text, _ = proc.communicate(timeout=TIMEOUT)
            codes.append(proc.returncode)
            outs.append(text)
            ws.append(np.load(out) if os.path.exists(out) else None)
    finally:
        for _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return codes, outs, ws


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("dist_multislice:")]


@pytest.mark.parametrize("args", [[], ["--fsdp"]], ids=["replicated",
                                                        "fsdp"])
def test_two_slices_of_two_processes_match_jax(args, tmp_path):
    codes, outs, ws = run_slices("port", 2, args, str(tmp_path))
    j_codes, j_outs, j_ws = run_slices("jax", 1, args, str(tmp_path))
    assert codes == [0] * 4, "\n".join(outs)
    assert j_codes == [0] * 2, "\n".join(j_outs)
    for i, text in enumerate(outs):
        sl, proc = divmod(i, 2)
        lines = _lines(text)
        assert lines[-1] == "dist_multislice: OK"
        want = _lines(j_outs[sl])
        # The same line as JAX's slice, but for the in-slice processes.
        mine = next(ln for ln in lines if " proc " in ln)
        theirs = next(ln for ln in want if " proc " in ln)
        assert mine == theirs.replace("proc 0/1", f"proc {proc}/2")
        if args:
            assert ("dist_multislice: fsdp state sharded over 2 in-slice "
                    "devices") in lines
    for w in ws:
        np.testing.assert_allclose(w, j_ws[0], rtol=0, atol=W_TOL)
    np.testing.assert_array_equal(j_ws[0], j_ws[1])


def test_fsdp_dim_that_does_not_divide_is_jax_error(tmp_path):
    codes, outs, _ = run_slices("port", 2, ["--fsdp", "--dim", "7"],
                                str(tmp_path), slices=1)
    assert codes == [1, 1]
    for text in outs:
        # examples/dist_multislice.py's message.
        assert "--fsdp: --dim 7 must divide by 2 in-slice devices" in text
