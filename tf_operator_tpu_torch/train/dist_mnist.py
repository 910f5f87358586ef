"""MNIST training and evaluation as an operator-launched job: one
process a device, data parallel over the processes.

    python -m tf_operator_tpu_torch.train.dist_mnist [--device cpu] [flags]

The port's entry point for ``examples/dist_mnist.py``, over
``make_classifier_train_step`` with ``MnistCNN`` (bf16 compute, f32
weights from ``models/convert.py``'s seeded initialiser, seed 0) and
``sgd_momentum``, with the example's flags, defaults and printed lines,
plus ``--device`` (default ``cuda``: without a card it raises rather
than training on the CPU, which it does only under ``--device cpu``) and
``--dist-backend`` (as ``train/dist_lm.py``'s).

The operator's topology (``train/distributed.py``) starts one
``torch.distributed`` world, and the step runs over the mesh ``{"dp":
processes}`` from state replicated from process 0: ``--batch`` is each
process's batch, the global batch ``--batch`` x processes.

Data is ``synthetic_mnist`` seeded by the process index; a resumed run
skips the batches the steps before it consumed, so it continues the
stream instead of replaying it. The run fails (exit 1) when the final
loss is above ``--target-loss``.

Checkpoint coordination, as ``train/dist_lm.py``: with
``--checkpoint-dir`` (or the operator-injected ``TPU_CKPT_DIR``) every
``--checkpoint-interval`` steps are saved (the last step always) and the
newest committed step acked; the eviction signal becomes a forced save
and a durable ack, and training goes on; resume honours
``TPU_RESUME_STEP``. Process 0 alone writes; the processes agree on the
eviction signal each step. ``--fail-at-step`` simulates a preemption:
drain the writes, meet at a barrier, every process exits 138, once.

The replica's role comes from ``TF_CONFIG``'s ``task.type``
(``train/distributed.py``): an ``evaluator`` follows the trainer's
checkpoints and evaluates each new step on 4 held-out batches
(``synthetic_mnist`` seed 10,000), printing ``accuracy=``/``loss=``, and
exits 0 after ``DONE`` at the final step, or 1 after ``--eval-timeout``
seconds without a new checkpoint. Several processes with no coordinator
to meet at exit with a usage error (``distributed.check_topology``); a
multislice job trains each slice as a world of its own, as JAX's does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from tf_operator_tpu_torch.train.distributed import (
    add_dist_backend,
    check_topology,
)

HELDOUT_SEED, HELDOUT_BATCHES = 10_000, 4


def build_parser() -> argparse.ArgumentParser:
    """``examples/dist_mnist.py``'s flags, names and defaults, plus
    ``--device``."""
    p = argparse.ArgumentParser(
        description="MNIST training (or, as an evaluator replica, eval of "
                    "its checkpoints) on one device of the PyTorch port")
    p.add_argument("--device", default="cuda",
                   help="torch device; raises when it is CUDA and torch "
                        "sees no card (pass 'cpu' for the plain PyTorch "
                        "path)")
    add_dist_backend(p)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=256,
                   help="per-process batch size (global = this x processes)")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--target-loss", type=float, default=0.25,
                   help="exit non-zero unless final loss is below this")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save/resume train state here")
    p.add_argument("--checkpoint-interval", type=int, default=1,
                   help="save every N steps")
    p.add_argument("--fail-at-step", type=int, default=None,
                   help="simulate preemption: first incarnation exits 138 "
                        "(user-retryable) at this step after checkpointing")
    p.add_argument("--eval-timeout", type=float, default=120.0,
                   help="evaluator role: exit 1 after this long without a "
                        "new checkpoint")
    return p


def _model_and_state(args, device):
    from tf_operator_tpu_torch.models.convert import (
        init_variables,
        load_variables,
    )
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.train.steps import TrainState, sgd_momentum

    model = MnistCNN(device=device)
    load_variables(model, init_variables(model, 0))
    tx = sgd_momentum(args.lr)
    return model, tx, TrainState.create(model, tx)


def run_evaluator(args, device) -> int:
    """Follow the trainer's checkpoints: evaluate every new step on
    held-out data, exit 0 once the final step is evaluated."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.data import synthetic_mnist
    from tf_operator_tpu_torch.train.steps import (
        evaluate,
        make_classifier_eval_step,
    )

    if not args.checkpoint_dir:
        print("dist_mnist eval: --checkpoint-dir is required", flush=True)
        return 2
    model, _, template = _model_and_state(args, device)
    eval_step = make_classifier_eval_step(model, has_batch_stats=False)
    heldout_stream = synthetic_mnist(args.batch, seed=HELDOUT_SEED)
    heldout = [next(heldout_stream) for _ in range(HELDOUT_BATCHES)]

    ckpt = CheckpointManager(args.checkpoint_dir, max_to_keep=2)
    last = -1
    deadline = time.monotonic() + args.eval_timeout
    try:
        while True:
            latest = ckpt.latest_step()
            step_done = -1 if latest is None else int(latest)
            restored = None
            if step_done > last:
                try:
                    # Restore only when a new step exists.
                    restored = ckpt.restore(step_done, template)
                except (OSError, RuntimeError, ValueError, EOFError):
                    # Racing the trainer's save and pruning: retry, but
                    # fall through to the deadline check, so a checkpoint
                    # that stays unreadable ends in exit 1.
                    restored = None
            if restored is not None:
                m = evaluate(eval_step, restored, iter(heldout))
                print(f"dist_mnist eval: step {step_done} "
                      f"accuracy={m['accuracy']:.3f} loss={m['loss']:.4f}",
                      flush=True)
                last = step_done
                deadline = time.monotonic() + args.eval_timeout
                if step_done >= args.steps - 1:
                    print("dist_mnist eval: DONE", flush=True)
                    return 0
            if time.monotonic() > deadline:
                print(f"dist_mnist eval: no new checkpoint in "
                      f"{args.eval_timeout}s", flush=True)
                return 1
            time.sleep(0.3)
    finally:
        ckpt.close()


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.fail_at_step is not None and not args.checkpoint_dir:
        # Without a checkpoint every incarnation restarts at step 0, hits
        # the failure step again, and the retryable exit crash-loops.
        p.error("--fail-at-step requires --checkpoint-dir")

    from tf_operator_tpu_torch.train import distributed

    topo = distributed.from_env()
    if topo.role != "evaluator":
        check_topology(p, topo)

    from tf_operator_tpu_torch.ckpt import protocol

    ckpt_dir = args.checkpoint_dir or os.environ.get(protocol.ENV_CKPT_DIR)
    stop_event = None
    if ckpt_dir and topo.role != "evaluator":
        # Installed before torch loads: the eviction signal may come at
        # any point. Only checkpointing trainers trap SIGTERM.
        from tf_operator_tpu_torch.utils import signals

        stop_event = signals.setup_signal_handler()

    from tf_operator_tpu_torch import resolve_device

    device = resolve_device(args.device)
    if topo.role == "evaluator":
        # Evaluator replica: outside the training rendezvous, it follows
        # the trainer's checkpoints on held-out data.
        return run_evaluator(args, device)

    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import replicate, shard_batch
    from tf_operator_tpu_torch.train.data import synthetic_mnist
    from tf_operator_tpu_torch.train.steps import make_classifier_train_step

    topo = distributed.initialize(topo, device=device,
                                  backend=args.dist_backend)
    n = topo.num_processes
    print(f"dist_mnist: process {topo.process_id}/{n}, {n} global devices, "
          f"device {device}", flush=True)
    mesh = create_mesh({"dp": n}, device=device)
    model, tx, state = _model_and_state(args, device)
    state = replicate(mesh, state)
    step = make_classifier_train_step(model, tx, has_batch_stats=False,
                                      mesh=mesh)

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
        # min_step: never resume below the operator's acked step.
        state, start_step = ckpt.restore_or_init(
            state, min_step=resume_min_step())
        # resumed (not the clamped start_step) gates the preemption sim:
        # with --steps 1 the clamp forces start_step back to 0, and a
        # start_step == 0 guard would re-fire exit 138 forever.
        resumed = start_step > 0
        # Re-run at least the final step, so the loss check below always
        # runs.
        start_step = max(0, min(start_step, args.steps - 1))
        if resumed:
            print(f"dist_mnist: resumed from step {start_step}", flush=True)

    data = synthetic_mnist(args.batch, seed=topo.process_id)
    # Resume continues the batch stream at the step offset.
    for _ in range(start_step):
        next(data)
    t0 = time.perf_counter()
    metrics = None
    evict_acked = False
    for i in range(start_step, args.steps):
        state, metrics = step(state, shard_batch(mesh, next(data)))
        if ckpt is not None:
            # The final step is saved whatever the interval: a follower
            # evaluator finishes on a checkpoint at steps - 1.
            ckpt.save(i, state, force=(i == args.steps - 1))
            ckpt.maybe_ack()
            # Every process takes the forced save at one step.
            if (stop_event is not None and not evict_acked
                    and distributed.agree(stop_event.is_set())):
                # The eviction checkpoint signal: force-save this step,
                # ack durably, then keep training.
                ckpt.save(i, state, force=True)
                acked = ckpt.ack()
                evict_acked = True
                print(f"dist_mnist: eviction signal — checkpoint durable "
                      f"at step {acked}", flush=True)
        if (args.fail_at_step is not None and i == args.fail_at_step
                and not resumed):
            # Simulated preemption: the checkpoint is durable, then exit
            # with the user-retryable code (138) the ExitCode policy
            # restarts.
            if ckpt is not None:
                ckpt.wait()
            distributed.barrier()
            print(f"dist_mnist: simulating preemption at step {i}",
                  flush=True)
            os._exit(138)
        if (i + 1) % 20 == 0 or i == start_step:
            print(f"dist_mnist: step {i+1} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)
    if ckpt is not None:
        ckpt.close()
    distributed.shutdown()
    if metrics is None:  # steps <= start_step: no step ran this incarnation
        print("dist_mnist: no steps to run", flush=True)
        return 0
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    steps_run = args.steps - start_step
    global_batch = args.batch * topo.num_processes
    print(f"dist_mnist: {steps_run} steps in {dt:.1f}s "
          f"({steps_run * global_batch / dt:.0f} img/s global batch "
          f"{global_batch}), final loss {loss:.4f}", flush=True)
    if loss > args.target_loss:
        print(f"dist_mnist: FAILED (loss {loss:.4f} > {args.target_loss})",
              flush=True)
        return 1
    print("dist_mnist: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
