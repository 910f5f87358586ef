"""The port's training entry points as several processes on the CPU
(``--device cpu``, gloo), joined as the operator joins them: from
``TPU_NUM_PROCESSES`` / ``TPU_WORKER_ID`` / ``TPU_COORDINATOR_ADDRESS``,
or from a TF_CONFIG of two workers through the operator itself.

- ``dist_mnist`` at tests/test_examples.py's flags (``--steps 30 --batch
  64 --target-loss 0.8``) and ``dist_lm`` (synthetic and ``--data``) as
  2 processes reach their targets and print ``process 1/2``; both
  processes print the same losses.
- Two ``dist_lm`` processes over the global batch of one process: the
  printed losses (the first step's and the final) within ``LOSS_TOL``
  (3e-4: the printed 4 decimals, and the same f32 sums in another
  order).
- A two-process ``--fail-at-step`` run exits 138 on both processes, and
  its resume ends on a final checkpoint bitwise equal to the
  uninterrupted two-process twin's, with the same final loss; process 0
  alone writes (``CheckpointManager.primary``), and both processes' ack
  files name a step the directory listed.
- The eviction signal sent to process 1 alone: both processes take the
  forced save at one step and ack it, and training goes on.
- The port's ``dist_mnist`` as a 2-worker TPUJob under the ``operator``
  fixture: TF_CONFIG -> ``init_process_group`` -> dp, ``dist_mnist:
  OK`` in both pods' logs.
"""

import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from tf_operator_tpu.ckpt import protocol as jax_protocol
from tf_operator_tpu_torch.ckpt import protocol
from tf_operator_tpu_torch.models.convert import _leaves
from tf_operator_tpu_torch.train import checkpoint
from tf_operator_tpu_torch.train.data import write_token_records
from test_torch_dp import free_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM, MNIST = ("tf_operator_tpu_torch.train.dist_lm",
             "tf_operator_tpu_torch.train.dist_mnist")
LOSS_TOL = 3e-4
LM_ARGS = ["--device", "cpu", "--batch", "8", "--seq", "16", "--vocab",
           "32", "--d-model", "32"]


def _env(rank=None, world=None, port=None, **extra):
    env = {k: v for k, v in os.environ.items() if k not in (
        protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
        protocol.ENV_RESUME_STEP, "TF_CONFIG", "TPU_WORKER_ID",
        "TPU_NUM_PROCESSES", "TPU_COORDINATOR_ADDRESS",
        "MEGASCALE_NUM_SLICES")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if world is not None:
        env.update(TPU_NUM_PROCESSES=str(world), TPU_WORKER_ID=str(rank),
                   TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    env.update(extra)
    return env


def _start(module, args, world, tmp, tag, rank_env=None):
    """``world`` processes of ``python -m module args`` (one plain
    process for ``world`` None), stdout to files; -> (procs, logs)."""
    port = free_port()
    procs, logs = [], []
    for r in range(world or 1):
        log = os.path.join(tmp, f"{tag}{r}.log")
        extra = (rank_env or (lambda _: {}))(r)
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args], cwd=REPO,
                env=_env(r if world else None, world, port, **extra),
                stdout=out, stderr=subprocess.STDOUT))
        logs.append(log)
    return procs, logs


def _finish(procs, logs, timeout=240):
    """Wait for every process; -> [(rc, output)]."""
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for proc, log in zip(procs, logs):
        with open(log) as f:
            out.append((proc.returncode, f.read()))
    return out


def _run(module, args, world, tmp, tag, **kw):
    return _finish(*_start(module, args, world, tmp, tag, **kw))


def _final_loss(text):
    return float(re.search(r"final loss (\S+)", text).group(1))


def test_dist_mnist_two_processes_reach_the_target(tmp_path):
    runs = _run(MNIST, ["--device", "cpu", "--steps", "30", "--batch", "64",
                        "--target-loss", "0.8"], 2, str(tmp_path), "mnist")
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, out
        assert f"dist_mnist: process {rank}/2, 2 global devices" in out
        assert "global batch 128" in out
        assert out.rstrip().endswith("dist_mnist: OK")
    assert _final_loss(runs[0][1]) == _final_loss(runs[1][1])


def test_dist_lm_two_processes_match_one_over_the_global_batch(tmp_path):
    args = LM_ARGS + ["--steps", "12", "--target-loss", "3"]
    two = _run(LM, args, 2, str(tmp_path), "two")
    one = _run(LM, args, None, str(tmp_path), "one")
    for rank, (rc, out) in enumerate(two):
        assert rc == 0, out
        assert (f"dist_lm: process {rank}/2, mesh {{'dp': 2, 'sp': 1, "
                f"'tp': 1}}, device cpu") in out
        assert "dist_lm: OK" in out
    assert one[0][0] == 0, one[0][1]
    assert "process 0/1, mesh {'dp': 1" in one[0][1]
    steps = [re.findall(r"step (\d+) loss=(\S+)", o) for _, o in
             two + one]
    assert steps[0] == steps[1]  # every process reports the global loss
    for (s2, l2), (s1, l1) in zip(steps[0], steps[2]):
        assert s2 == s1 and abs(float(l2) - float(l1)) <= LOSS_TOL
    assert abs(_final_loss(two[0][1]) - _final_loss(one[0][1])) <= LOSS_TOL


def test_dist_lm_data_two_processes_stream_their_shards(tmp_path):
    start = np.random.default_rng(0).integers(0, 32, (64, 1))
    path = str(tmp_path / "corpus.bin")
    write_token_records(path, ((start + np.arange(17)) % 32).astype(
        np.int32))
    runs = _run(LM, LM_ARGS + ["--steps", "30", "--target-loss", "2.5",
                               "--data", path, "--grad-accum", "2"], 2,
                str(tmp_path), "data")
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, out
        assert f"dist_lm: process {rank}/2" in out
        assert "record engine" in out and "dist_lm: OK" in out
    assert _final_loss(runs[0][1]) == _final_loss(runs[1][1])


# A process of a --data world that records its rows: each step's batch
# (this process's rows) and each microbatch its model runs, pickled as
# (exit code, {"batches": [...], "micro": [...]}) to argv[1].
RECORD_ROWS = """
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tf_operator_tpu_torch.train import dist_lm, steps
seen = {"batches": [], "micro": []}
real = steps.make_lm_train_step

def recording(model, *args, **kwargs):
    model.register_forward_pre_hook(
        lambda m, a: seen["micro"].append(np.array(a[0])))
    step = real(model, *args, **kwargs)

    def wrapped(state, batch):
        seen["batches"].append(np.array(batch["tokens"]))
        return step(state, batch)

    return wrapped

steps.make_lm_train_step = recording
rc = dist_lm.main(sys.argv[2:])
with open(sys.argv[1], "wb") as f:
    pickle.dump((rc, seen), f)
"""


def test_dist_lm_data_rows_are_jax_s_shard_of_each_process(tmp_path):
    """Two --data processes at --grad-accum 2 over 10 records (5 a shard,
    4 rows a process a step, so each epoch's leftover carries): process
    r's rows at every step are JAX examples/dist_lm.py's row_stream over
    shard r of 2, and its microbatch i is rows i * 4 + 2r to i * 4 + 2r + 2
    of the global batch, the two shards' rows in process order: JAX's
    microbatch i's dp shard r."""
    from test_torch_dist_lm import _jax_rows, chain_corpus

    n_steps, seq, vocab, world, accum = 4, 16, 32, 2, 2
    path = chain_corpus(str(tmp_path / "corpus.bin"), 10, seq, vocab)
    args = ["--device", "cpu", "--batch", "8", "--seq", str(seq), "--vocab",
            str(vocab), "--d-model", "32", "--steps", str(n_steps),
            "--target-loss", "10", "--data", path, "--grad-accum",
            str(accum)]
    port = free_port()
    outs = [str(tmp_path / f"rows{r}.pkl") for r in range(world)]
    logs = [str(tmp_path / f"rows{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RECORD_ROWS, outs[r], *args],
                cwd=REPO, env=_env(r, world, port), stdout=log,
                stderr=subprocess.STDOUT))
    for rc, out in _finish(procs, logs):
        assert rc == 0, out
    seen = []
    for r in range(world):
        with open(outs[r], "rb") as f:
            rc, rows = pickle.load(f)
        assert rc == 0
        seen.append(rows)
    local = 8 // world
    want = [_jax_rows(path, seq, local, 0, n_steps, vocab, shard_id=r,
                      num_shards=world) for r in range(world)]
    m = 8 // accum // world
    for r in range(world):
        assert len(seen[r]["batches"]) == n_steps
        assert len(seen[r]["micro"]) == n_steps * accum
        for s in range(n_steps):
            np.testing.assert_array_equal(seen[r]["batches"][s],
                                          want[r][s]["tokens"], f"{r} {s}")
            glob = np.concatenate([want[q][s]["tokens"]
                                   for q in range(world)])
            for i in range(accum):
                at = i * (8 // accum) + r * m
                np.testing.assert_array_equal(
                    seen[r]["micro"][s * accum + i], glob[at:at + m],
                    f"rank {r} step {s} microbatch {i}")


def test_two_process_kill_and_resume_is_bitwise_its_twin(tmp_path):
    tmp = str(tmp_path)
    ck, twin = os.path.join(tmp, "ck"), os.path.join(tmp, "twin")
    acks = [os.path.join(tmp, f"ack{r}.json") for r in range(2)]

    def ack_env(r):
        return {protocol.ENV_ACK_FILE: acks[r]}

    args = LM_ARGS + ["--steps", "10", "--target-loss", "4"]
    first_procs, first_logs = _start(
        LM, args + ["--checkpoint-dir", ck, "--fail-at-step", "4"], 2, tmp,
        "first", ack_env)
    third = _run(LM, args + ["--checkpoint-dir", twin], 2, tmp, "twin")
    first = _finish(first_procs, first_logs)
    for rc, out in first:
        assert rc == 138, out
        assert "simulating preemption at step 4" in out
    assert checkpoint.latest_step(ck) == 4
    for r in range(2):
        ack = jax_protocol.read_ack(acks[r])
        assert ack is not None and ack.directory == os.path.abspath(ck)
        assert 0 <= ack.step <= 4
    second = _run(LM, args + ["--checkpoint-dir", ck, "--fail-at-step",
                              "4"], 2, tmp, "second")
    for rc, out in second + third:
        assert rc == 0, out
        assert "dist_lm: OK" in out
    assert all("dist_lm: resumed from step 5" in o for _, o in second)
    assert sorted(os.listdir(ck)) == sorted(os.listdir(twin)) == ["8", "9"]
    a = dict(_leaves(checkpoint.read(ck, 9)[0]))
    b = dict(_leaves(checkpoint.read(twin, 9)[0]))
    assert a.keys() == b.keys()
    for key, val in a.items():
        assert torch.equal(val, b[key]), key
    assert _final_loss(second[0][1]) == _final_loss(third[0][1])


def test_only_the_primary_process_writes(tmp_path, monkeypatch):
    """Two managers over one directory, as ranks 0 and 1 of two processes
    hold them: the secondary's saves write nothing, and its acks name
    listed steps."""
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.train import distributed, steps

    model = MnistCNN(device="cpu")
    state = steps.TrainState.create(model, steps.sgd_momentum(0.1))
    ck = str(tmp_path / "ck")
    acks = [str(tmp_path / f"ack{r}.json") for r in range(2)]
    primary = checkpoint.CheckpointManager(ck, ack_path=acks[0])
    with monkeypatch.context() as m:  # built as rank 1 of 2
        m.setattr(distributed, "world", lambda: (1, 2))
        secondary = checkpoint.CheckpointManager(ck, ack_path=acks[1])
    assert primary.primary and not secondary.primary
    assert secondary.save(0, state) is False
    assert secondary.all_steps() == [] and secondary.maybe_ack() is None
    assert primary.save(0, state) is True
    primary.wait()
    assert secondary.save(1, state, force=True) is False
    assert secondary.all_steps() == [0]
    assert secondary.ack() == 0 == jax_protocol.read_ack(acks[1]).step
    primary.close()
    secondary.close()


def test_eviction_signal_to_one_process_saves_on_both(tmp_path):
    tmp = str(tmp_path)
    ck = os.path.join(tmp, "ck")
    acks = [os.path.join(tmp, f"ack{r}.json") for r in range(2)]
    procs, logs = _start(
        LM, LM_ARGS + ["--steps", "1000000", "--target-loss", "4",
                       "--checkpoint-dir", ck], 2, tmp, "evict",
        lambda r: {protocol.ENV_ACK_FILE: acks[r]})

    def text(r):
        with open(logs[r]) as f:
            return f.read()

    try:
        limit = time.monotonic() + 120
        while jax_protocol.read_ack(acks[1]) is None:
            assert all(p.poll() is None for p in procs), text(0) + text(1)
            assert time.monotonic() < limit, text(1)
            time.sleep(0.02)
        procs[1].send_signal(signal.SIGTERM)
        limit = time.monotonic() + 60
        while not all("eviction signal" in text(r) for r in range(2)):
            assert all(p.poll() is None for p in procs), text(0) + text(1)
            assert time.monotonic() < limit, text(0) + text(1)
            time.sleep(0.02)
        acked = [int(re.search(r"checkpoint durable at step (\d+)",
                               text(r)).group(1)) for r in range(2)]
        assert acked[0] == acked[1] >= 0
        assert acked[0] in checkpoint.all_steps(ck) or (
            checkpoint.latest_step(ck) > acked[0])
        limit = time.monotonic() + 60
        while checkpoint.latest_step(ck) <= acked[0]:
            assert all(p.poll() is None for p in procs)  # still training
            assert time.monotonic() < limit
            time.sleep(0.02)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_dist_mnist_as_a_two_worker_tpujob(operator):
    """The operator injects TF_CONFIG into two worker pods; the port's
    entry point turns it into one gloo world and trains data parallel."""
    from tf_operator_tpu.api import constants
    from tf_operator_tpu.client import TPUJobClient
    from tf_operator_tpu.runtime import podlogs
    from tf_operator_tpu.runtime.restclient import RestClusterClient

    cli = TPUJobClient(RestClusterClient(operator))
    job = {
        "apiVersion": constants.API_VERSION, "kind": constants.KIND,
        "metadata": {"name": "portmnist2", "namespace": "default"},
        "spec": {"replicaSpecs": {"Worker": {"replicas": 2, "template": {
            "spec": {"containers": [{
                "name": constants.DEFAULT_CONTAINER_NAME,
                "image": "tpu-operator/examples",
                "command": [sys.executable, "-m", MNIST, "--device", "cpu",
                            "--steps", "30", "--batch", "64",
                            "--target-loss", "0.8"],
                "env": [{"name": "OMP_NUM_THREADS", "value": "1"},
                        {"name": "PYTHONPATH", "value": REPO}],
            }]}}}}},
    }
    cli.create(job)
    try:
        got = cli.wait_for_job("default", "portmnist2", timeout=240)
        conds = {c["type"] for c in got["status"]["conditions"]
                 if c["status"] == "True"}
        logs = "\n".join(
            podlogs.read_log("default", pod["metadata"]["name"]) or ""
            for pod in cli.get_pods("default", "portmnist2"))
        assert "Succeeded" in conds, f"conds={conds}\nlogs:\n{logs}"
        assert "process 1/2, 2 global devices" in logs, logs
        assert logs.count("dist_mnist: OK") == 2, logs
    finally:
        try:
            cli.delete("default", "portmnist2")
        except Exception:  # noqa: BLE001 — the job may be gone already
            pass


def test_tf_config_of_two_workers_names_the_first_as_coordinator():
    from tf_operator_tpu_torch.train import distributed

    topo = distributed.from_env({"TF_CONFIG": json.dumps({
        "cluster": {"worker": ["127.0.0.1:7001", "127.0.0.1:7002"]},
        "task": {"type": "worker", "index": 1}})})
    assert topo.is_distributed
    assert (topo.coordinator_address, topo.process_id,
            topo.num_processes) == ("127.0.0.1:7001", 1, 2)
