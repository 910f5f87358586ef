"""LM training as an operator-launched job: one process a device, data
parallel over the processes.

    python -m tf_operator_tpu_torch.train.dist_lm [--device cpu] [flags]

The port's entry point for ``examples/dist_lm.py``'s data-parallel path,
over ``make_lm_train_step``, with the same flags, names and defaults,
plus ``--device`` (default ``cuda``: without a card it raises rather
than training on the CPU, which it does only under ``--device cpu``) and
``--dist-backend`` (``nccl`` on the card, ``gloo`` on the CPU by
default; two processes sharing one card need ``gloo``).

The operator's topology (``train/distributed.py``: ``TPU_WORKER_ID`` /
``TPU_NUM_PROCESSES`` / ``TPU_COORDINATOR_ADDRESS``, or a TF_CONFIG of
several workers) starts one ``torch.distributed`` world, and the step
runs over the mesh ``{"dp": processes}``: each process trains on its
rows of the ``--batch`` global rows, and the gradients are averaged.
The state starts replicated from process 0; process 0 alone writes
checkpoints, every process restores them.
The model is the example's: 4 heads, ``d_ff = 2 d_model``, f32, from
``init_params(cfg, 0)``. On the card the flash kernels take head dims
32, 64 and 128, so at 4 heads ``--d-model`` 128, 256 or 512; any other
width raises there, by design.

Data is the synthetic next-token task (tokens advance by +1 mod vocab),
seeded by step (``np.random.default_rng((7, step))``), so a resumed run
sees the batches an uninterrupted one would; every process builds the
same global batch and keeps its rows. With ``--data``, a
token-record file (``train/data.py::write_token_records``: rows of
``--seq`` + 1 int32 ids) is streamed through ``token_dataset`` (the
native record pipeline, seed 11, looping) as the example streams it:
process ``i`` of ``n`` reads shard ``i`` of ``n`` of every epoch,
re-batched to exactly ``--batch / n`` rows a step with an epoch's
leftover rows carried into the next step; the first
batch's largest id must be below ``--vocab``, and a resumed run skips
the rows of the steps it restored. The run fails (exit 1) when the final
loss misses ``--target-loss``.

Checkpoint coordination (``train/checkpoint.py``, ``ckpt/protocol.py``):
with ``--checkpoint-dir`` (or the operator-injected ``TPU_CKPT_DIR``)
every step is saved (``--checkpoint-interval``) and the newest committed
step acked; the operator's eviction signal, which the local executor
delivers as a graceful SIGTERM, becomes a forced save and a durable ack,
and training goes on; resume honours ``TPU_RESUME_STEP``. The signal
reaches each process at its own moment, so the processes agree on it
each step (an all-reduce MAX of the flag) and take the forced save at
one step. ``--fail-at-step`` simulates a preemption: drain the writes,
meet at a barrier, every process exits 138, once (a resumed run does not
fire it again). Before it exits the run prints the flash kernels'
launches (``launches_line``).

``--moe-every-n`` swaps every Nth block's MLP for a routed expert MLP
(``--moe-experts``, ``--moe-top-k``: Switch at 1, GShard top-2 at 2), and
the step adds the load-balancing loss at weight 0.01, as the example's.

Flags of unported items exit with a usage error naming the ROADMAP
item: ``--sp`` and ``--ring-impl`` (A8c), ``--tp`` (A8b's second half),
``--pp*`` (A8d), ``--ep`` (A8e); so do several processes with no
coordinator to meet at. A multislice job trains each slice as a world of
its own, as JAX's entry point does (``MEGASCALE_*`` is read by
``train/dist_multislice.py`` alone). The example's checks of ``--ep`` against
the MoE flags keep their meaning, and so does its refusal of ``--data``
beside ``--sp``/``--tp``: those flags are refused as above.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

from tf_operator_tpu_torch.train.distributed import (
    add_dist_backend,
    check_topology,
)

# Flags of ROADMAP items the port has not ported: (flag, set?, item).
UNPORTED_FLAGS = (
    ("--sp", lambda a: a.sp > 1, "A8c (sequence parallel)"),
    ("--tp", lambda a: a.tp > 1,
     "A8b's second half (tensor-parallel training)"),
    ("--pp", lambda a: a.pp > 1, "A8d (pipelines)"),
    ("--pp-microbatches", lambda a: a.pp_microbatches != 2,
     "A8d (pipelines)"),
    ("--pp-schedule", lambda a: a.pp_schedule != "gpipe",
     "A8d (pipelines)"),
    ("--ep", lambda a: a.ep > 1, "A8e (expert parallel)"),
    ("--ring-impl", lambda a: a.ring_impl != "auto",
     "A8c (sequence parallel)"),
)


def launches_line() -> str:
    """The flash kernels' launches in this process (0 on the CPU, which
    runs their plain versions): what a caller on the card reads to see
    that training went through B1-B3."""
    from tf_operator_tpu_torch.ops import flash_attention as fa

    return (f"dist_lm: flash launches fwd={fa.fwd_launches} "
            f"dq={fa.dq_launches} dkv={fa.dkv_launches}")


def build_parser() -> argparse.ArgumentParser:
    """``examples/dist_lm.py``'s flags, names and defaults, plus
    ``--device``."""
    p = argparse.ArgumentParser(
        description="LM training on one device of the PyTorch port, with "
                    "the operator's checkpoint protocol")
    p.add_argument("--device", default="cuda",
                   help="torch device; raises when it is CUDA and torch "
                        "sees no card (pass 'cpu' for the plain PyTorch "
                        "path)")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8, help="GLOBAL batch size")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query attention: K/V heads (must divide "
                        "the 4 query heads)")
    p.add_argument("--layers", type=int, default=2)
    add_dist_backend(p)
    p.add_argument("--sp", type=int, default=1, help="waits for A8c")
    p.add_argument("--tp", type=int, default=1,
                   help="waits for A8b's second half")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--target-loss", type=float, default=1.0)
    p.add_argument("--xent-chunk", type=int, default=None,
                   help="chunked cross-entropy chunk (default: seq / 2)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize blocks (long-context memory)")
    p.add_argument("--ring-impl", default="auto",
                   choices=("auto", "stream", "flash", "ulysses"),
                   help="waits for A8c")
    p.add_argument("--moe-every-n", type=int, default=None,
                   help="swap every Nth block's MLP for a routed expert "
                        "MLP (models/moe.py); enables the MoE path")
    p.add_argument("--moe-experts", type=int, default=8)
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="1 = Switch, 2 = GShard top-2")
    p.add_argument("--ep", type=int, default=1, help="waits for A8e")
    p.add_argument("--pp", type=int, default=1, help="waits for A8d")
    p.add_argument("--pp-microbatches", type=int, default=2,
                   help="waits for A8d")
    p.add_argument("--pp-schedule", choices=("gpipe", "1f1b"),
                   default="gpipe", help="waits for A8d")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer step (gradients "
                        "averaged into one update)")
    p.add_argument("--data", default=None,
                   help="token-record file (write_token_records): this "
                        "process streams its shard of every epoch "
                        "through the native record pipeline instead of "
                        "the synthetic task")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-interval", type=int, default=1)
    p.add_argument("--fail-at-step", type=int, default=None,
                   help="simulate preemption: exit 138 once at this step")
    return p


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    # The example's MoE checks keep their meaning beside --ep's refusal.
    refused = []
    if args.ep > 1 and not args.moe_every_n:
        refused.append("--ep requires --moe-every-n")
    if args.moe_every_n and args.moe_experts % args.ep:
        refused.append("--moe-experts must be a multiple of --ep")
    refused += [f"{flag} waits for ROADMAP {item}"
                for flag, is_set, item in UNPORTED_FLAGS if is_set(args)]
    if refused:
        p.error("; ".join(refused))
    if args.fail_at_step is not None and not args.checkpoint_dir:
        p.error("--fail-at-step requires --checkpoint-dir")

    from tf_operator_tpu_torch.train import distributed

    topo = distributed.from_env()
    check_topology(p, topo)

    # Operator-injected checkpoint contract (ckpt/protocol.py): a
    # replacement pod of a checkpointing job learns its directory even
    # when the manifest never spelled one out.
    from tf_operator_tpu_torch.ckpt import protocol

    ckpt_dir = args.checkpoint_dir or os.environ.get(protocol.ENV_CKPT_DIR)
    stop_event = None
    if ckpt_dir:
        # Install BEFORE any heavy initialization (torch is not loaded
        # yet): the eviction signal can arrive at any point, and an
        # uninstalled handler would kill the process instead of requesting
        # a checkpoint. Only checkpointing runs trap SIGTERM: a
        # non-checkpointing run keeps the default die-on-TERM so plain
        # deletions stay prompt.
        from tf_operator_tpu_torch.utils import signals

        stop_event = signals.setup_signal_handler()

    import numpy as np
    import torch

    from tf_operator_tpu_torch import resolve_device
    from tf_operator_tpu_torch.models.convert import init_params, load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import replicate, shard_batch
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_train_step,
    )

    device = resolve_device(args.device)
    topo = distributed.initialize(topo, device=device,
                                  backend=args.dist_backend)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = topo.num_processes
    axes = {"dp": n, "sp": 1, "tp": 1}
    print(f"dist_lm: process {topo.process_id}/{n}, mesh {axes}, "
          f"device {device}", flush=True)
    mesh = create_mesh(axes, device=device)
    if args.batch % n:
        raise SystemExit(
            "batch must be a multiple of dp and seq a multiple of sp")
    if args.grad_accum < 1 or args.batch % args.grad_accum or (
            (args.batch // args.grad_accum) % n):
        raise SystemExit(
            "--grad-accum must divide the batch, with each microbatch "
            "still a multiple of dp")
    if args.xent_chunk is not None:
        if args.xent_chunk <= 0 or args.seq % args.xent_chunk:
            raise SystemExit(
                f"--xent-chunk must divide the per-device seq {args.seq}")
        chunk = args.xent_chunk
    else:
        chunk = args.seq // 2 if args.seq % 2 == 0 else args.seq

    moe_kw = {}
    if args.moe_every_n:
        moe_kw = dict(moe_every_n=args.moe_every_n,
                      moe_experts=args.moe_experts, moe_top_k=args.moe_top_k)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=4,
        n_kv_heads=args.kv_heads, n_layers=args.layers,
        d_ff=args.d_model * 2, max_seq_len=args.seq, dtype=torch.float32,
        remat=args.remat, **moe_kw,
    )
    model = load_params(Transformer(cfg, device), init_params(cfg, 0))
    tx = adamw(args.lr)
    state = replicate(mesh, TrainState.create(model, tx))
    # The load-balancing loss counts only on the MoE path.
    step = make_lm_train_step(model, tx, xent_chunk=chunk,
                              grad_accum=args.grad_accum,
                              aux_loss_weight=0.01 if args.moe_every_n
                              else 0.0, mesh=mesh)

    ckpt = None
    start_step = 0
    resumed = False
    if ckpt_dir:
        from tf_operator_tpu_torch.train.checkpoint import (
            CheckpointManager,
            resume_min_step,
        )

        ckpt = CheckpointManager(
            ckpt_dir, max_to_keep=2,
            save_interval_steps=args.checkpoint_interval,
        )
        # min_step: the operator's acked-step contract.
        state, start_step = ckpt.restore_or_init(
            state, min_step=resume_min_step())
        # resumed (not the clamped start_step) gates the preemption sim:
        # with --steps 1 the clamp forces start_step back to 0, and a
        # start_step == 0 guard would re-fire exit 138 forever.
        resumed = start_step > 0
        start_step = max(0, min(start_step, args.steps - 1))
        if resumed:
            print(f"dist_lm: resumed from step {start_step}", flush=True)

    local_rows = args.batch // n

    def batch_at(step_idx: int) -> dict:
        # Seeded by step, so resume continues the stream; every process
        # builds the same global batch and keeps its rows.
        rng = np.random.default_rng((7, step_idx))
        start = rng.integers(0, args.vocab, (args.batch, 1))
        chain = (start + np.arange(args.seq + 1)) % args.vocab  # +1 chain
        chain = chain.astype(np.int32)
        rows = slice(topo.process_id * local_rows,
                     (topo.process_id + 1) * local_rows)
        return shard_batch(mesh, {"tokens": chain[rows, :-1],
                                  "targets": chain[rows, 1:]})

    data_iter = None
    if args.data:
        # The record input, examples/dist_lm.py's lines: this process
        # streams ITS shard of every epoch, and shard_batch places its
        # rows of the global batch.
        from tf_operator_tpu_torch.native import NativeBuildError, load_library
        from tf_operator_tpu_torch.train.data import token_dataset

        # token_dataset's "auto" engine, resolved here so that the run says
        # which reader feeds it: both give the same rows, not the same rate.
        try:
            load_library("record_pipeline.cc")
            engine = "native"
        except NativeBuildError as e:
            print(f"dist_lm: native record pipeline unavailable ({e})",
                  flush=True)
            engine = "python"
        print(f"dist_lm: --data {args.data} through the {engine} record "
              f"engine", flush=True)
        if args.batch % max(1, n):
            raise SystemExit(
                "global batch must be a multiple of num_processes"
            )
        data_iter = token_dataset(
            args.data, args.seq, local_rows, seed=11, loop=True,
            engine=engine, shard_id=topo.process_id, num_shards=n,
        )

        def row_stream():
            # Re-batch to EXACTLY local_rows per step, carrying epoch-tail
            # leftovers into the next step (truncating them would skip
            # records for a whole epoch) — and giving resume a stream
            # where one next() == one training step, so fast-forwarding
            # start_step steps lands precisely where training stopped.
            buf = None
            for b in data_iter:
                buf = b if buf is None else {
                    k: np.concatenate([buf[k], b[k]]) for k in b
                }
                while buf["tokens"].shape[0] >= local_rows:
                    yield {k: v[:local_rows] for k, v in buf.items()}
                    buf = {k: v[local_rows:] for k, v in buf.items()}

        rows = row_stream()
        first = next(rows)
        # Fail loudly on a corpus/vocab mismatch, before any step: an id
        # past the embedding table fails inside the step (on the card, as
        # a device-side assert that ends the process).
        hi = int(first["tokens"].max())
        # Every process stops when any reads a bad id: one that ran on
        # would wait at the step's all-reduce for a peer that left.
        if distributed.agree(hi >= args.vocab):
            raise SystemExit(
                f"--data token id {hi} >= --vocab {args.vocab}"
                if hi >= args.vocab else
                "--data: another process read a token id >= --vocab")
        rows = itertools.chain([first], rows)
        for _ in range(start_step):  # resume continues, never replays
            next(rows)

        def next_data(_step_idx):
            return shard_batch(mesh, next(rows))
    else:
        next_data = batch_at

    t0 = time.perf_counter()
    metrics = None
    evict_acked = False
    for i in range(start_step, args.steps):
        state, metrics = step(state, next_data(i))
        if ckpt is not None:
            ckpt.save(i, state)
            # Progress report: the newest COMMITTED step, at no sync cost.
            ckpt.maybe_ack()
            # Every process takes the forced save at one step.
            if (stop_event is not None and not evict_acked
                    and distributed.agree(stop_event.is_set())):
                # The eviction checkpoint signal: force-save this step,
                # drain the writer, ack durably (the operator's barrier
                # releases on it), then KEEP training: exiting here would
                # read as success, and the barrier evicts the pod.
                ckpt.save(i, state, force=True)
                acked = ckpt.ack()
                evict_acked = True
                print(f"dist_lm: eviction signal — checkpoint durable at "
                      f"step {acked}", flush=True)
        if (args.fail_at_step is not None and i == args.fail_at_step
                and not resumed):
            if ckpt is not None:
                ckpt.wait()
            distributed.barrier()
            print(launches_line(), flush=True)
            print(f"dist_lm: simulating preemption at step {i}", flush=True)
            os._exit(138)
        if (i + 1) % 20 == 0 or i == start_step:
            print(f"dist_lm: step {i+1} loss={float(metrics['loss']):.4f}",
                  flush=True)
    if ckpt is not None:
        ckpt.close()
    if data_iter is not None:
        data_iter.close()
    distributed.shutdown()
    print(launches_line(), flush=True)
    if metrics is None:
        print("dist_lm: no steps to run", flush=True)
        return 0
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    steps_run = args.steps - start_step
    tps = steps_run * args.batch * args.seq / dt
    print(f"dist_lm: {steps_run} steps in {dt:.1f}s ({tps:.0f} tokens/s, "
          f"device {device}, xent_chunk={chunk}), final loss {loss:.4f}",
          flush=True)
    if loss > args.target_loss:
        print(f"dist_lm: FAILED (loss {loss:.4f} > {args.target_loss})",
              flush=True)
        return 1
    print("dist_lm: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
