"""LM training as an operator-launched job: one process a device, data
parallel over the processes, sequence parallel with ``--sp``, tensor
parallel with ``--tp``, expert parallel with ``--ep`` and pipeline
parallel with ``--pp``.

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
runs over JAX's mesh ``{"dp": processes / (sp tp ep), "sp": --sp, "tp":
--tp}`` (and ``"ep": --ep`` when above 1): every process builds the same
global batch and keeps its block,
its data index's rows of the ``--batch`` global rows and its sequence
index's ``--seq / sp`` columns of them (every tensor-parallel rank of one
block on the same tokens), and the gradients are averaged over dp and sp.
Under ``--sp`` the model attends over the ``sp`` ring by ``--ring-impl``
(``auto``: the flash ring on the card, the stream ring on the CPU;
``stream``, ``flash`` or ``ulysses``; ``models/transformer.py``), each
rank at its block's global positions. Under ``--tp`` every process builds the
seeded whole tree and keeps its slices (``param_sharding_rules``,
``shard_params_by_rules``), the model runs the Megatron layout and the
chunked loss is vocabulary-parallel (``sharded_lm_xent``). The state
starts replicated over dp from the first rank of each tensor-parallel
index; process 0 alone writes checkpoints, whole (gathered over tp), and
every process restores its slices of them, at any tp and sp.
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
every process of dp index ``i`` reads shard ``i`` of ``dp`` of every
epoch (beside ``--ep`` the ep ranks of one index read the same rows,
which JAX places over dp and replicates over ep; at ``ep`` 1 process
``i`` of ``n`` reads shard ``i`` of ``n``), re-batched to exactly
``--batch / dp`` rows a step with an epoch's leftover rows carried into
the next step; the first
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
``--ep`` splits each MoE block's experts over the mesh's ``ep`` axis
(``moe_param_sharding_rules``, beside ``param_sharding_rules`` under
``--tp``): every process cuts its experts (and its tp slices) from the
seeded whole tree, the ranks of one data index take the same rows, and
checkpoints are written whole and restore at any ``--ep`` and ``--tp``.
``--ep`` composes with ``--tp`` (the attention and dense MLPs cut over
tp, the experts over ep and whole over tp) and with ``--sp`` (a routing
group that straddles two sequence blocks is gathered over sp, then
routed over the experts split on ep), on JAX's mesh ``{"dp": n / (sp tp
ep), "sp", "tp", "ep"}``.

``--pp`` trains the block stack as pipeline stages (``train/pp_lm.py``:
``--pp-microbatches`` microbatches a step, ``--pp-schedule`` ``gpipe`` or
``1f1b``) over JAX's mesh ``{"dp": processes / pp, "sp": 1, "tp": 1,
"pp": --pp}``, ``pp`` outer: each process builds the seeded whole tree
and keeps its stage's blocks beside the outer params (``pp_model``), and
takes its data index's slice of every microbatch of the global batch
(``pp_rows``); process 0 writes checkpoints in JAX's pipelined tree
(``{"outer", "stages"}``, gathered over ``pp``), which restore at the
same ``--pp`` (``serve_lm --from-pp`` serves them). JAX's refusals stand:
``--pp composes with dp only (sp/tp/ep/moe must be off)``, ``--layers
must be divisible by --pp``, ``--pp path: no --data, --grad-accum must be
1``, ``--batch must divide by --pp-microbatches`` and a microbatch the dp
axis does not divide.

Several processes with no coordinator to meet at exit with a usage
error. JAX's errors stand for ``--sp``, ``--tp``, ``--ep`` and
``--ring-impl``: ``--ring-impl requires --sp > 1``, ``--ep requires
--moe-every-n``, ``--moe-experts must be a multiple of --ep``, a process
count ``sp * tp * ep * pp`` does not divide, a batch or seq the mesh does not
divide, an ``--xent-chunk`` that does not divide the per-device seq, and
``--data`` beside ``--sp`` or ``--tp`` (``--data requires sp=1 and
tp=1``). The ``--xent-chunk`` default is the per-device seq / 2. A
multislice
job trains each slice as a world of its own, as JAX's entry point does
(``MEGASCALE_*`` is read by ``train/dist_multislice.py`` alone).
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
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis size (ring attention)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (the Megatron layout); "
                        "must divide the process count")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--target-loss", type=float, default=1.0)
    p.add_argument("--xent-chunk", type=int, default=None,
                   help="chunked cross-entropy chunk (default: per-device "
                        "seq / 2)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize blocks (long-context memory)")
    p.add_argument("--ring-impl", default="auto",
                   choices=("auto", "stream", "flash", "ulysses"),
                   help="sequence-parallel attention: stream (autodiff "
                        "ring, supports kv chunking), flash (custom-VJP "
                        "second-ring backward, the flash kernels on the "
                        "card), or ulysses (all-to-all head/sequence "
                        "exchange — needs heads/tp divisible by sp)")
    p.add_argument("--moe-every-n", type=int, default=None,
                   help="swap every Nth block's MLP for a routed expert "
                        "MLP (models/moe.py); enables the MoE path")
    p.add_argument("--moe-experts", type=int, default=8)
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="1 = Switch, 2 = GShard top-2")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel mesh axis (experts sharded over "
                        "it; requires --moe-every-n)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (train/pp_lm.py: the "
                        "block stack as GPipe stages; requires sp=tp=ep=1 "
                        "and layers divisible by pp)")
    p.add_argument("--pp-microbatches", type=int, default=2,
                   help="microbatches per step on the --pp path")
    p.add_argument("--pp-schedule", choices=("gpipe", "1f1b"),
                   default="gpipe",
                   help="gpipe: autograd through the pipeline (stash "
                        "grows with microbatches); 1f1b: interleaved "
                        "fwd/bwd with an O(pp) stash — raise "
                        "--pp-microbatches to shrink the bubble without "
                        "raising memory")
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
    if args.ep > 1 and not args.moe_every_n:
        raise SystemExit("--ep requires --moe-every-n")
    if args.moe_every_n and args.moe_experts % args.ep:
        raise SystemExit("--moe-experts must be a multiple of --ep")
    if args.pp > 1:
        if args.sp > 1 or args.tp > 1 or args.ep > 1 or args.moe_every_n:
            raise SystemExit("--pp composes with dp only (sp/tp/ep/moe "
                             "must be off)")
        if args.layers % args.pp:
            raise SystemExit("--layers must be divisible by --pp")
        if args.data or args.grad_accum != 1:
            raise SystemExit("--pp path: no --data, --grad-accum must be 1")
        if args.batch % args.pp_microbatches:
            raise SystemExit("--batch must divide by --pp-microbatches")
    if args.fail_at_step is not None and not args.checkpoint_dir:
        p.error("--fail-at-step requires --checkpoint-dir")
    if args.ring_impl != "auto" and args.sp <= 1:
        # Ring attention only engages when the sequence is split; a forced
        # impl with sp=1 would silently train on plain attention.
        p.error("--ring-impl requires --sp > 1 (ring attention is off)")

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
    from tf_operator_tpu_torch.models.moe import moe_param_sharding_rules
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        replicate,
        shard_batch,
        shard_params_by_rules,
        token_block,
    )
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
    split = args.sp * args.tp * args.ep * args.pp
    if n % split:
        raise SystemExit(f"{n} devices not divisible by sp*tp*ep*pp="
                         f"{split}")
    if args.pp > 1:
        micro = args.batch // args.pp_microbatches
        pp_dp = n // args.pp
        if micro % pp_dp:
            raise SystemExit(
                f"microbatch size {micro} (batch/pp-microbatches) must "
                f"divide by the dp axis ({pp_dp}) — raise --batch or "
                "lower --pp-microbatches"
            )
    axes = {"dp": n // split, "sp": args.sp, "tp": args.tp}
    if args.ep > 1:  # JAX's mesh line names ep and pp only when used
        axes["ep"] = args.ep
    if args.pp > 1:
        axes["pp"] = args.pp
    dp = axes["dp"]
    print(f"dist_lm: process {topo.process_id}/{n}, mesh {axes}, "
          f"device {device}", flush=True)
    mesh = create_mesh(axes, device=device)
    if args.batch % dp or args.seq % args.sp:
        raise SystemExit(
            "batch must be a multiple of dp and seq a multiple of sp")
    if args.grad_accum < 1 or args.batch % args.grad_accum or (
            (args.batch // args.grad_accum) % dp):
        raise SystemExit(
            "--grad-accum must divide the batch, with each microbatch "
            "still a multiple of dp")
    local_seq = args.seq // args.sp
    if args.xent_chunk is not None:
        if args.xent_chunk <= 0 or local_seq % args.xent_chunk:
            raise SystemExit(
                f"--xent-chunk must divide the per-device seq {local_seq}")
        chunk = args.xent_chunk
    else:
        chunk = local_seq // 2 if local_seq % 2 == 0 else local_seq

    moe_kw = {}
    if args.moe_every_n:
        moe_kw = dict(moe_every_n=args.moe_every_n,
                      moe_experts=args.moe_experts, moe_top_k=args.moe_top_k)
    # A tensor- or sequence-parallel model is its rank's part of the
    # mesh's model; the pp path's stages take no mesh of their own.
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=4,
        n_kv_heads=args.kv_heads, n_layers=args.layers,
        d_ff=args.d_model * 2, max_seq_len=args.seq, dtype=torch.float32,
        remat=args.remat, ring_impl=args.ring_impl,
        mesh=mesh if max(args.tp, args.sp, args.ep) > 1 else None,
        **moe_kw,
    )
    tree = init_params(cfg, 0)
    tx = adamw(args.lr)
    if args.pp > 1:
        from tf_operator_tpu_torch.train.pp_lm import (
            make_pp_lm_train_step,
            pp_model,
            pp_rows,
            split_pp_params,
        )

        outer, stages = split_pp_params(tree, args.layers, args.pp)
        model = pp_model(cfg, mesh, {"outer": outer, "stages": stages},
                         device=device)
        del outer, stages
        step = make_pp_lm_train_step(
            cfg, mesh, tx, num_micro=args.pp_microbatches, xent_chunk=chunk,
            schedule=args.pp_schedule)
    else:
        rules = dict(param_sharding_rules()) if args.tp > 1 else {}
        if args.ep > 1:  # expert weights split on the expert dim over "ep"
            rules.update(moe_param_sharding_rules())
        if rules:
            tree = shard_params_by_rules(mesh, tree, rules)
        model = load_params(Transformer(cfg, device), tree)
        # The load-balancing loss counts only on the MoE path.
        step = make_lm_train_step(model, tx, xent_chunk=chunk,
                                  grad_accum=args.grad_accum,
                                  aux_loss_weight=0.01 if args.moe_every_n
                                  else 0.0, mesh=mesh)
    del tree
    state = replicate(mesh, TrainState.create(model, tx))

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

    local_rows = args.batch // dp

    def batch_at(step_idx: int) -> dict:
        # Seeded by step, so resume continues the stream; every process
        # builds the same global batch and keeps its (dp, sp) block: the
        # tensor-parallel ranks of one block take the same tokens.
        rng = np.random.default_rng((7, step_idx))
        start = rng.integers(0, args.vocab, (args.batch, 1))
        chain = (start + np.arange(args.seq + 1)) % args.vocab  # +1 chain
        chain = chain.astype(np.int32)
        batch = {"tokens": chain[:, :-1], "targets": chain[:, 1:]}
        if args.pp > 1:
            return pp_rows(mesh, batch, args.pp_microbatches)
        return token_block(mesh, batch)

    data_iter = None
    if args.data and (args.sp > 1 or args.tp > 1):
        raise SystemExit("--data requires sp=1 and tp=1")
    if args.data:
        # The record input, examples/dist_lm.py's lines: this process
        # streams the shard of its data index of every epoch (the ep
        # ranks of one index read the same rows, as JAX replicates the
        # batch over ep), and shard_batch places its rows of the global
        # batch.
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
        from tf_operator_tpu_torch.parallel.sharding import DataParallel

        data_iter = token_dataset(
            args.data, args.seq, local_rows, seed=11, loop=True,
            engine=engine, shard_id=DataParallel(mesh, "dp").index,
            num_shards=dp,
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
