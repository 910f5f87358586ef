"""The port's MNIST entry point (tf_operator_tpu_torch/train/dist_mnist.py)
on the CPU, as the operator runs it, in subprocesses with ``--device
cpu`` and a few steps: the trainer reaches OK (and FAILED, exit 1, above
its target loss); a run killed at ``--fail-at-step`` exits 138 and the
resumed run continues the batch stream, ending on a final checkpoint
bitwise equal to an uninterrupted run's (one thread); an evaluator
replica (TF_CONFIG task.type ``evaluator``) follows the checkpoints to
``DONE``, and times out without one; the refusals (more than one
process, ``--fail-at-step`` without a directory, an evaluator without
one). The port's topology reader agrees with the JAX package's
``from_env`` on the role and process fields."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tf_operator_tpu.train import distributed as jax_distributed
from tf_operator_tpu_torch.ckpt import protocol
from tf_operator_tpu_torch.train import checkpoint, distributed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "tf_operator_tpu_torch.train.dist_mnist"
EVALUATOR = json.dumps({"task": {"type": "evaluator", "index": 0}})


def small(steps=8, *extra):
    return ["--device", "cpu", "--steps", str(steps), "--batch", "32",
            "--target-loss", "5", *extra]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for key in (protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
                protocol.ENV_RESUME_STEP, "TF_CONFIG", "TPU_WORKER_ID",
                "TPU_NUM_PROCESSES", "TPU_COORDINATOR_ADDRESS",
                "MEGASCALE_NUM_SLICES"):
        env.pop(key, None)
    env.update(extra)
    return env


def _run(args, **env):
    return subprocess.run([sys.executable, "-m", MODULE, *args], cwd=REPO,
                          env=_env(**env), capture_output=True, text=True,
                          timeout=300)


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _payload(path):
    return dict(_flat(torch.load(os.path.join(path, checkpoint.STATE_FILE),
                                 weights_only=True)))


def test_trainer_reaches_ok_and_fails_above_its_target():
    ok = _run(small(8))
    assert ok.returncode == 0, ok.stderr
    lines = ok.stdout.splitlines()
    assert lines[0] == ("dist_mnist: process 0/1, 1 global devices, "
                        "device cpu")
    assert lines[1].startswith("dist_mnist: step 1 loss=")
    assert "8 steps in" in ok.stdout and "global batch 32" in ok.stdout
    assert lines[-1] == "dist_mnist: OK"
    failed = _run(small(2, "--target-loss", "0.0001"))
    assert failed.returncode == 1
    assert "dist_mnist: FAILED (loss" in failed.stdout


def test_kill_and_resume_continues_the_batch_stream(tmp_path):
    ck, twin = str(tmp_path / "ck"), str(tmp_path / "twin")
    first = _run(small(10, "--checkpoint-dir", ck, "--fail-at-step", "4"))
    assert first.returncode == 138, first.stderr
    assert "simulating preemption at step 4" in first.stdout
    assert checkpoint.latest_step(ck) == 4
    second = _run(small(10, "--checkpoint-dir", ck, "--fail-at-step", "4"))
    assert second.returncode == 0, second.stderr
    assert "dist_mnist: resumed from step 5" in second.stdout
    assert "simulating preemption" not in second.stdout
    third = _run(small(10, "--checkpoint-dir", twin))
    assert third.returncode == 0, third.stderr
    assert sorted(os.listdir(ck)) == sorted(os.listdir(twin)) == ["8", "9"]
    # Bitwise the uninterrupted run: the resumed run skipped the five
    # batches the first run consumed (a replayed stream would differ).
    a, b = _payload(os.path.join(ck, "9")), _payload(os.path.join(twin, "9"))
    assert a.keys() == b.keys()
    assert ("opt", "momentum_buffer", "Dense_0", "kernel") in a
    for key, val in a.items():
        assert torch.equal(val, b[key]), key
    loss = [ln for ln in second.stdout.splitlines() if "final loss" in ln]
    twin_loss = [ln for ln in third.stdout.splitlines() if "final loss" in ln]
    assert loss[0].rsplit(" ", 1)[1] == twin_loss[0].rsplit(" ", 1)[1]
    manifest = checkpoint.read(ck, 9)[1]
    assert manifest["config"] == {"model": "MnistCNN", "num_classes": 10}


def test_evaluator_follows_the_checkpoints_to_done(tmp_path):
    ck = str(tmp_path / "ck")
    trainer = _run(small(6, "--checkpoint-dir", ck))
    assert trainer.returncode == 0, trainer.stderr
    ev = _run(small(6, "--checkpoint-dir", ck, "--eval-timeout", "30"),
              TF_CONFIG=EVALUATOR)
    assert ev.returncode == 0, ev.stderr
    lines = ev.stdout.splitlines()
    assert lines[0].startswith("dist_mnist eval: step 5 accuracy=")
    assert " loss=" in lines[0]
    assert lines[-1] == "dist_mnist eval: DONE"
    # Nothing to follow: the evaluator gives up after its timeout.
    empty = _run(small(6, "--checkpoint-dir", str(tmp_path / "none"),
                       "--eval-timeout", "0.5"), TF_CONFIG=EVALUATOR)
    assert empty.returncode == 1
    assert "no new checkpoint in 0.5s" in empty.stdout


@pytest.mark.parametrize("argv,env,code,message", [
    (["--fail-at-step", "3"], {}, 2,
     "--fail-at-step requires --checkpoint-dir"),
    # Several processes train since A8a (tests/test_torch_dist_multi.py);
    # the two cases that refused them now hold the topology the port still
    # refuses, before it meets any peer: processes with no coordinator. A
    # multislice job is no longer refused (each slice is a world of its
    # own, as in JAX), so its case pins that the refusal holds inside one.
    pytest.param(
        [], {"TPU_NUM_PROCESSES": "2", "TPU_WORKER_ID": "0",
             "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
        2, "2 training processes need TPU_COORDINATOR_ADDRESS",
        id="argv1-env1-2-2 training processes wait for ROADMAP A8 "
           "(multi-device)"),
    pytest.param(
        [], {"TPU_NUM_PROCESSES": "4", "TPU_WORKER_ID": "1"}, 2,
        "4 training processes need TPU_COORDINATOR_ADDRESS",
        id="argv2-env2-2-4 training processes wait for ROADMAP A8"),
    ([], {"TF_CONFIG": EVALUATOR}, 2,
     "dist_mnist eval: --checkpoint-dir is required"),
])
def test_refusals(argv, env, code, message):
    out = _run(small(2, *argv), **env)
    assert out.returncode == code
    assert message in out.stdout + out.stderr


@pytest.mark.parametrize("env", [
    {},
    {"TF_CONFIG": EVALUATOR},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["w0:2222", "w1:2222"],
                                          "evaluator": ["e:2222"]},
                              "task": {"type": "evaluator", "index": 0}})},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["w0:2222", "w1:2222"]},
                              "task": {"type": "worker", "index": 1}})},
    {"TF_CONFIG": json.dumps({"cluster": {"chief": ["c:1"]},
                              "task": {"type": "chief"}})},
    {"TF_CONFIG": "not json"},
    {"TPU_COORDINATOR_ADDRESS": "h:8476", "TPU_WORKER_ID": "2",
     "TPU_NUM_PROCESSES": "4",
     "TF_CONFIG": json.dumps({"task": {"type": "evaluator"}})},
])
def test_from_env_matches_jax(env):
    want = jax_distributed.from_env(env)
    got = distributed.from_env(env)
    assert (got.process_id, got.num_processes, got.role) == (
        want.process_id, want.num_processes, want.role)
