"""Multislice training: one ``torch.distributed`` world a slice, the
slices bridged over the DCN channel.

    python -m tf_operator_tpu_torch.train.dist_multislice [--device cpu]
        [--fsdp] [flags]

The port's entry point for ``examples/dist_multislice.py``, with its
flags, defaults, printed lines and exit codes, plus ``--device`` (default
``cuda``: without a card it raises) and ``--dist-backend`` (``nccl`` on
the card, ``gloo`` on the CPU; processes sharing a card need ``gloo``).

Run as a TPUJob with ``numSlices: N``: each slice starts its OWN world
from the in-slice env the operator injects (``TPU_COORDINATOR_ADDRESS`` /
``TPU_WORKER_ID`` / ``TPU_NUM_PROCESSES``, one coordinator a slice;
``train/distributed.py``), trains data parallel inside the slice (each
process takes its rows of the slice's ``--batch``, in process order, as
JAX's ``P("dp")`` deals them, and the gradient is the slice's mean), and
averages its parameters across slices every step through the MEGASCALE
channel (``train/dcn.py``: ``channel_from_env``, ``cross_slice_mean``).

The model is the example's linear regression whose optimum differs per
slice (``w_base + slice_id``, ``w_base`` from seed 42, each slice's data
from seed ``1000 + slice_id``): only the cross-slice average converges to
the global optimum, so convergence proves the DCN leg carries data.

``--fsdp`` shards ``w`` and its momentum ``v`` (momentum 0.5) over the
slice's processes on dim 0 (``--dim`` must divide by them, JAX's error
otherwise): the forward all-gathers ``w``, the gradient is
reduce-scattered to the shards, and the cross-slice sync gathers
``{w, v}`` for one DCN exchange and re-shards them, as the example does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    from tf_operator_tpu_torch.train.distributed import add_dist_backend

    p = argparse.ArgumentParser(
        description="multislice training over the DCN channel")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--batch", type=int, default=64, help="per-slice batch")
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.3)
    # The per-step average's fixed point sits NEAR the global optimum with
    # a sampled-covariance offset (finite batches); the slice-local optima
    # sit ~1.4 away, so 0.5 still tells "DCN moved data" from "slices
    # trained alone".
    p.add_argument("--tol", type=float, default=0.5)
    p.add_argument("--fsdp", action="store_true",
                   help="shard params + momentum over the IN-SLICE "
                        "processes (ZeRO within each slice, dp across DCN) "
                        "instead of replicating")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' for the plain "
                        "path)")
    add_dist_backend(p)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from tf_operator_tpu_torch import resolve_device
    from tf_operator_tpu_torch.train import dcn, distributed

    device = resolve_device(args.device)
    topo = distributed.initialize(device=device, backend=args.dist_backend)
    slice_id = int(os.environ.get("MEGASCALE_SLICE_ID", "0"))
    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    channel = dcn.channel_from_env(in_slice_process_id=topo.process_id)
    rank, n = distributed.world()
    on = (distributed.collective_device() if n > 1 else device)
    if args.fsdp and args.dim % n:
        raise SystemExit(f"--fsdp: --dim {args.dim} must divide by "
                         f"{n} in-slice devices")
    if args.batch % n:
        raise SystemExit(f"--batch {args.batch} must divide by {n} "
                         "in-slice devices")

    def all_reduce(t):
        if n > 1:
            t = t.to(on)
            dist.all_reduce(t)
            t = t.to(device)
        return t

    def gather(shard):
        """The whole vector from the ranks' shards (dim 0, rank order)."""
        if not args.fsdp or n == 1:
            return shard
        parts = [torch.empty_like(shard, device=on) for _ in range(n)]
        dist.all_gather(parts, shard.to(on))
        return torch.cat(parts).to(device)

    def own(full):
        """This rank's shard of a whole vector (itself when replicated)."""
        if not args.fsdp:
            return full
        k = args.dim // n
        return full[rank * k:(rank + 1) * k].clone()

    rng = np.random.default_rng(42)
    w_base = rng.normal(size=(args.dim,)).astype(np.float32)
    w_true_local = w_base + np.float32(slice_id)
    w_true_global = w_base + np.float32((num_slices - 1) / 2)
    mu = 0.5 if args.fsdp else 0.0  # momentum: --fsdp's moment to shard

    w = own(torch.zeros(args.dim, dtype=torch.float32, device=device))
    v = own(torch.zeros(args.dim, dtype=torch.float32, device=device))
    rows = args.batch // n
    data_rng = np.random.default_rng(1000 + slice_id)
    loss0 = None
    for _ in range(args.steps):
        x = data_rng.normal(size=(args.batch, args.dim)).astype(np.float32)
        y = x @ w_true_local
        xl = torch.from_numpy(x[rank * rows:(rank + 1) * rows]).to(device)
        yl = torch.from_numpy(y[rank * rows:(rank + 1) * rows]).to(device)
        full = gather(w).requires_grad_(True)
        loss = torch.mean((xl @ full - yl) ** 2)
        (g,) = torch.autograd.grad(loss, full)
        # The slice's mean gradient (its rows are the ranks' equal shares),
        # reduce-scattered to the shards under --fsdp.
        g = own(all_reduce(g.detach()) / n)
        loss = all_reduce(loss.detach()) / n
        if loss0 is None:
            loss0 = float(loss)
        v = mu * v + g
        w = w - args.lr * v
        # The cross-slice sync each step: one exchange of the gathered
        # state (momentum too, so every slice runs the same optimizer).
        if args.fsdp:
            synced = dcn.cross_slice_mean(
                channel, {"w": gather(w), "v": gather(v)})
            w, v = own(synced["w"]), own(synced["v"])
        else:
            w = dcn.cross_slice_mean(channel, w)

    if args.fsdp:
        print(f"dist_multislice: fsdp state sharded over {n} in-slice "
              "devices", flush=True)

    w_full = gather(w).cpu().numpy()
    err = float(np.linalg.norm(w_full - w_true_global))
    local_err = float(np.linalg.norm(w_full - w_true_local))
    print(f"dist_multislice: slice {slice_id}/{num_slices} proc "
          f"{topo.process_id}/{topo.num_processes} loss0={loss0:.3f} "
          f"global_err={err:.4f} local_err={local_err:.4f}", flush=True)

    code = 0
    # Cross-slice agreement: every slice must hold the same params.
    if channel is not None:
        mean_w = dcn.cross_slice_mean(channel, w_full)
        agreement = float(np.linalg.norm(mean_w - w_full))
        channel.close()
        if agreement > 1e-5:
            print(f"dist_multislice: DIVERGED across slices ({agreement})")
            code = 1
    if code == 0 and num_slices > 1:
        # Converged to the GLOBAL optimum, not the slice-local one.
        if err > args.tol:
            print(f"dist_multislice: global err {err} > {args.tol}")
            code = 1
        elif local_err < err:
            print("dist_multislice: converged to LOCAL optimum (no DCN?)")
            code = 1
    elif code == 0 and err > args.tol and local_err > args.tol:
        code = 1
    distributed.shutdown()
    if code == 0:
        print("dist_multislice: OK", flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
