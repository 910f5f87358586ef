"""The port's training entry point (tf_operator_tpu_torch/train/dist_lm.py)
on the CPU, as the operator runs it: a run killed at ``--fail-at-step``
exits 138 and the resumed run (``resumed from step k+1``) ends on a final
checkpoint bitwise equal to an uninterrupted run's (f32, one thread); the
injected TPU_CKPT_DIR and TPU_RESUME_STEP are honoured; the eviction
signal becomes a forced save and an ack and training goes on; the MoE
flags run (the model of JAX's tests/test_examples.py MoE test learns
the chain task, top-2 and Switch; an MoE run resumes bitwise too);
``--data`` streams a token-record file as examples/dist_lm.py does (its
rows are JAX's ``row_stream``'s over the same file, an epoch's leftover
rows carried and a resume fast-forwarded; an id past ``--vocab`` exits
with JAX's message; a killed ``--data`` run resumes bitwise; the model
learns tests/test_examples.py's token corpus); each unported flag's
usage error names its ROADMAP item; without ``--device``
and without a card the entry point exits non-zero naming CUDA. Then the
entry point under the JAX operator's LocalProcessExecutor, as
tests/test_ckpt.py::test_executor_relays_acks_and_delivers_signal drives
its workload: periodic acks surface as pod annotations, the signal
annotation becomes an ack of that generation, and the pod keeps
running."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tf_operator_tpu.api import constants
from tf_operator_tpu.ckpt import protocol as jax_protocol
from tf_operator_tpu.runtime import objects
from tf_operator_tpu.runtime.executor import LocalProcessExecutor
from tf_operator_tpu.runtime.memcluster import InMemoryCluster
from tf_operator_tpu.train.data import token_dataset as jax_token_dataset
from tf_operator_tpu_torch.ckpt import protocol
from tf_operator_tpu_torch.train import checkpoint, dist_lm, steps
from tf_operator_tpu_torch.train.data import write_token_records
from tf_operator_tpu_torch.utils import signals

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "tf_operator_tpu_torch.train.dist_lm"


def small(steps=12, *extra):
    """A small model that still learns the +1 chain a little in 12
    steps."""
    return ["--device", "cpu", "--steps", str(steps), "--batch", "4",
            "--seq", "16", "--vocab", "32", "--d-model", "32",
            "--target-loss", "4", *extra]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for key in (protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
                protocol.ENV_RESUME_STEP):
        env.pop(key, None)
    env.update(extra)
    return env


def chain_corpus(path, n, seq, vocab, seed=0):
    """n rows of the +1 chain mod vocab, seq + 1 ids each, from seeded
    starts (tests/test_examples.py's corpus at n=256, seq 64, vocab
    64)."""
    start = np.random.default_rng(seed).integers(0, vocab, (n, 1))
    write_token_records(path, ((start + np.arange(seq + 1))
                               % vocab).astype(np.int32))
    return path


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


def _assert_same_checkpoint(a, b):
    """Two step directories hold the same bits and manifest."""
    pa = dict(_flat(torch.load(os.path.join(a, checkpoint.STATE_FILE),
                               weights_only=True)))
    pb = dict(_flat(torch.load(os.path.join(b, checkpoint.STATE_FILE),
                               weights_only=True)))
    assert pa.keys() == pb.keys()
    for key, val in pa.items():
        assert torch.equal(val, pb[key]), key
    with open(os.path.join(a, checkpoint.MANIFEST_FILE)) as fa, open(
            os.path.join(b, checkpoint.MANIFEST_FILE)) as fb:
        assert json.load(fa) == json.load(fb)


def test_kill_and_resume_ends_bitwise_on_the_uninterrupted_run(tmp_path):
    _kill_and_resume(tmp_path)


def test_moe_kill_and_resume_ends_bitwise_on_the_uninterrupted_run(
        tmp_path):
    """The same with the MoE model (GShard top-2 every 2nd block, the aux
    loss in the step): router, experts and their moments resume bitwise."""
    _kill_and_resume(tmp_path, "--layers", "2", "--moe-every-n", "2",
                     "--moe-experts", "4")
    payload, manifest = checkpoint.read(str(tmp_path / "ck"))
    assert manifest["config"]["moe_every_n"] == 2
    assert "w_in" in payload["opt"]["exp_avg"]["block_1"]["moe"]


def _kill_and_resume(tmp_path, *extra):
    ck, twin = str(tmp_path / "ck"), str(tmp_path / "twin")
    first = _run(small(12, "--checkpoint-dir", ck, "--fail-at-step", "5",
                       *extra))
    assert first.returncode == 138, first.stderr
    assert "simulating preemption at step 5" in first.stdout
    assert checkpoint.latest_step(ck) == 5
    second = _run(small(12, "--checkpoint-dir", ck, "--fail-at-step", "5",
                        *extra))
    assert second.returncode == 0, second.stderr
    assert "dist_lm: resumed from step 6" in second.stdout
    assert "simulating preemption" not in second.stdout
    assert "dist_lm: OK" in second.stdout
    third = _run(small(12, "--checkpoint-dir", twin, *extra))
    assert third.returncode == 0, third.stderr
    assert "resumed" not in third.stdout
    # max_to_keep=2, as the JAX example keeps.
    assert sorted(os.listdir(ck)) == sorted(os.listdir(twin)) == ["10", "11"]
    _assert_same_checkpoint(os.path.join(ck, "11"), os.path.join(twin, "11"))
    # The last reported loss is the same too.
    loss = [ln for ln in second.stdout.splitlines() if "final loss" in ln]
    twin_loss = [ln for ln in third.stdout.splitlines() if "final loss" in ln]
    assert loss[0].rsplit(" ", 1)[1] == twin_loss[0].rsplit(" ", 1)[1]


def test_injected_dir_and_resume_step_are_honoured(tmp_path, monkeypatch):
    """TPU_CKPT_DIR stands in for --checkpoint-dir, and TPU_RESUME_STEP
    reaches restore_or_init as min_step."""
    ck = str(tmp_path / "ck")
    monkeypatch.setenv(protocol.ENV_CKPT_DIR, ck)
    monkeypatch.setenv(protocol.ENV_RESUME_STEP, "3")
    monkeypatch.delenv(protocol.ENV_ACK_FILE, raising=False)
    # In process: a fresh stop event, not the test process's handlers.
    monkeypatch.setattr(signals, "setup_signal_handler", threading.Event)
    seen = []
    real = checkpoint.CheckpointManager.restore_or_init

    def spy(self, state, min_step=None):
        seen.append((self.directory, min_step))
        return real(self, state, min_step)

    monkeypatch.setattr(checkpoint.CheckpointManager, "restore_or_init", spy)
    assert dist_lm.main(small(4)) == 0
    assert seen == [(ck, 3)]
    assert checkpoint.all_steps(ck) == [2, 3]
    assert dist_lm.main(small(6)) == 0
    assert seen[-1] == (ck, 3)
    assert checkpoint.all_steps(ck) == [4, 5]


def test_eviction_signal_saves_acks_and_keeps_training(tmp_path):
    """One SIGTERM after the first ack: a forced save and an ack of it
    (read with JAX's read_ack), training goes on; a second SIGTERM exits
    hard (utils/signals.py)."""
    ck, ack_path = str(tmp_path / "ck"), str(tmp_path / "ack.json")
    argv = small(1000000, "--checkpoint-dir", ck)
    log = tmp_path / "out.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", MODULE, *argv], cwd=REPO,
            env=_env(**{protocol.ENV_ACK_FILE: ack_path}), stdout=out,
            stderr=subprocess.STDOUT)
    try:
        limit = time.monotonic() + 120
        while jax_protocol.read_ack(ack_path) is None:
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < limit, log.read_text()
            time.sleep(0.02)
        first = os.stat(ack_path).st_mtime_ns
        proc.send_signal(signal.SIGTERM)
        limit = time.monotonic() + 60
        while "eviction signal" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < limit, log.read_text()
            time.sleep(0.02)
        line = next(ln for ln in log.read_text().splitlines()
                    if "eviction signal" in ln)
        acked = int(line.rsplit(" ", 1)[1])
        ack = jax_protocol.read_ack(ack_path)
        assert os.stat(ack_path).st_mtime_ns > first
        assert ack.step >= acked and ack.directory == os.path.abspath(ck)
        limit = time.monotonic() + 60
        while checkpoint.latest_step(ck) <= acked:
            assert proc.poll() is None, log.read_text()  # still training
            assert time.monotonic() < limit, log.read_text()
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("argv,item", [
    (["--sp", "2"], "ROADMAP A8"),
    (["--tp", "2"], "ROADMAP A8"),
    (["--pp", "2"], "ROADMAP A8"),
    (["--pp-microbatches", "4"], "ROADMAP A8"),
    (["--pp-schedule", "1f1b"], "ROADMAP A8"),
    (["--ep", "2"], "ROADMAP A8"),
    (["--ring-impl", "flash"], "ROADMAP A8"),
    # The MoE flags are ported (A9b): these three cases now pin that
    # each runs (item None); JAX's --ep checks keep their usage errors.
    pytest.param(["--moe-every-n", "2"], None, id="argv7-ROADMAP A9"),
    pytest.param(["--moe-experts", "4", "--moe-every-n", "2"], None,
                 id="argv8-ROADMAP A9"),
    pytest.param(["--moe-top-k", "1", "--moe-every-n", "2"], None,
                 id="argv9-ROADMAP A9"),
    # --data is ported (A12): the case now pins that it runs over a small
    # corpus the test writes.
    pytest.param(["--data", "tokens.bin"], None, id="argv12-ROADMAP A12"),
    (["--fail-at-step", "3"], "--fail-at-step requires --checkpoint-dir"),
    (["--ep", "4"], "--ep requires --moe-every-n"),
    (["--moe-experts", "6", "--moe-every-n", "2", "--ep", "4"],
     "--moe-experts must be a multiple of --ep"),
    (["--ep", "2", "--moe-every-n", "2"], "ROADMAP A8"),
])
def test_unported_flags_are_usage_errors(argv, item, capsys, tmp_path):
    if "--data" in argv:
        argv = ["--data", chain_corpus(str(tmp_path / "tokens.bin"), 16,
                                       16, 32)]
    if item is None:
        assert dist_lm.main(small(2)[:-2] + ["--target-loss", "10",
                                             *argv]) == 0
        assert "dist_lm: OK" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert item in err and argv[0] in err


@pytest.mark.parametrize("top_k", ["2", "1"])
def test_moe_learns_the_chain_task(top_k, capsys):
    """JAX's tests/test_examples.py MoE flags without --ep: the MoE model
    (every 2nd block, 4 experts, GShard top-2 or Switch) reaches loss
    1.2 in 80 steps."""
    assert dist_lm.main([
        "--device", "cpu", "--steps", "80", "--batch", "8", "--seq", "64",
        "--vocab", "64", "--moe-every-n", "2", "--moe-experts", "4",
        "--moe-top-k", top_k, "--target-loss", "1.2"]) == 0
    assert "dist_lm: OK" in capsys.readouterr().out


def test_default_device_is_the_card(monkeypatch):
    """In process with torch seeing no card, and, where there is none, as
    a subprocess without --device: both fail naming CUDA."""
    has_card = torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_lm.main(["--steps", "1"])
    if has_card:
        return
    out = _run(["--steps", "1"])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "dist_lm: OK" not in out.stdout


def test_the_entry_point_under_the_local_executor(tmp_path, monkeypatch):
    """tests/test_ckpt.py's executor relay test with the port's trainer as
    the workload: periodic acks become ckpt.tpuflow.org/step and /dir, the
    signal annotation is delivered as SIGTERM and answered by an ack of
    its generation, and the pod is still running."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ck = str(tmp_path / "ck")
    argv = small(1000000, "--checkpoint-dir", ck)
    client = InMemoryCluster()
    executor = LocalProcessExecutor(client, "default")
    stop = threading.Event()
    executor.start(stop)
    name = "port-train-0"
    try:
        client.create(objects.PODS, objects.new_pod(name, containers=[{
            "name": constants.DEFAULT_CONTAINER_NAME,
            "command": [sys.executable, "-m", MODULE, *argv]}]))

        def ann_of():
            return client.get(objects.PODS, "default", name)[
                "metadata"].get("annotations", {})

        limit = time.monotonic() + 120
        while jax_protocol.POD_STEP not in ann_of():
            assert time.monotonic() < limit, "ack relay never reported"
            time.sleep(0.05)
        ann = ann_of()
        assert ann[jax_protocol.POD_DIR] == os.path.abspath(ck)
        assert int(ann[jax_protocol.POD_STEP]) >= 0
        assert jax_protocol.POD_ACK not in ann  # no signal yet

        gen = jax_protocol.new_signal_gen()
        client.patch_merge(objects.PODS, "default", name, {
            "metadata": {"annotations": {jax_protocol.POD_SIGNAL: str(gen)}}})
        limit = time.monotonic() + 60
        while ann_of().get(jax_protocol.POD_ACK) != str(gen):
            assert time.monotonic() < limit, ann_of()
            time.sleep(0.05)
        assert objects.pod_phase(
            client.get(objects.PODS, "default", name)) == objects.RUNNING
    finally:
        procs = [r.process for r in list(executor._procs.values())]
        try:
            client.delete(objects.PODS, "default", name)
        except Exception:  # noqa: BLE001 — the pod may never have started
            pass
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        stop.set()
        time.sleep(0.3)


def _jax_rows(path, seq, rows, start_step, count, vocab, shard_id=0,
              num_shards=1):
    """examples/dist_lm.py's --data stream over JAX's token_dataset, line
    for line, as process ``shard_id`` of ``num_shards`` reads it (``rows``
    its local rows): row_stream, the first batch's vocab check, the
    fast-forward of start_step steps; then ``count`` steps' rows."""
    import itertools

    data_iter = jax_token_dataset(path, seq, rows, seed=11, loop=True,
                                  shard_id=shard_id, num_shards=num_shards)

    def row_stream():
        buf = None
        for b in data_iter:
            buf = b if buf is None else {
                k: np.concatenate([buf[k], b[k]]) for k in b
            }
            while buf["tokens"].shape[0] >= rows:
                yield {k: v[:rows] for k, v in buf.items()}
                buf = {k: v[rows:] for k, v in buf.items()}

    stream = row_stream()
    first = next(stream)
    assert int(first["tokens"].max()) < vocab
    stream = itertools.chain([first], stream)
    for _ in range(start_step):
        next(stream)
    out = [next(stream) for _ in range(count)]
    data_iter.close()
    return out


def test_data_rows_are_jax_row_stream(tmp_path, monkeypatch, capsys):
    """Every step's rows against JAX's row_stream over the same file: 10
    records at 4 rows a step, so each epoch's 2 leftover rows carry into
    the next step; a second run restored at step 5 fast-forwards 5 steps
    and goes on where the first stopped."""
    path = chain_corpus(str(tmp_path / "corpus.bin"), 10, 16, 32)
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(signals, "setup_signal_handler", threading.Event)
    for key in (protocol.ENV_CKPT_DIR, protocol.ENV_RESUME_STEP,
                protocol.ENV_ACK_FILE):
        monkeypatch.delenv(key, raising=False)
    seen = []
    real = steps.make_lm_train_step

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, batch):
            seen.append({k: np.array(v) for k, v in batch.items()})
            return step(state, batch)

        return wrapped

    monkeypatch.setattr(steps, "make_lm_train_step", recording)
    flags = small(5)[:-2] + ["--target-loss", "10", "--data", path,
                             "--checkpoint-dir", ck]
    assert dist_lm.main(flags) == 0
    first = list(seen)
    flags[flags.index("--steps") + 1] = "9"
    assert dist_lm.main(flags) == 0
    assert "dist_lm: resumed from step 5" in capsys.readouterr().out
    want = _jax_rows(path, 16, 4, 0, 9, 32)
    got = first + seen[len(first):]
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() == {"tokens", "targets"}
        for key in g:
            assert g[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], w[key], f"{i} {key}")
    # The stream itself, from step 3 on, as a resume at step 3 reads it.
    for g, w in zip(got[3:], _jax_rows(path, 16, 4, 3, 6, 32)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_data_id_past_the_vocab_exits_with_jax_s_message(tmp_path,
                                                         capsys):
    path = chain_corpus(str(tmp_path / "corpus.bin"), 8, 16, 32)
    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                      "--seq", "16", "--vocab", "16", "--data", path])
    assert str(exc.value.code) == "--data token id 31 >= --vocab 16"


def test_data_kill_and_resume_ends_bitwise_on_the_uninterrupted_run(
        tmp_path):
    _kill_and_resume(tmp_path, "--data", chain_corpus(
        str(tmp_path / "corpus.bin"), 20, 16, 32))


def test_data_learns_the_token_corpus(tmp_path, capsys):
    """tests/test_examples.py::test_dist_lm_trains_from_sharded_token_file's
    corpus and flags (256 chains of 65 ids mod 64, 80 steps of 8 x 64, the
    example's d_model 128) reach its loss 1.0 on the CPU."""
    path = chain_corpus(str(tmp_path / "corpus.bin"), 256, 64, 64)
    assert dist_lm.main([
        "--device", "cpu", "--steps", "80", "--batch", "8", "--seq", "64",
        "--vocab", "64", "--data", path, "--target-loss", "1.0"]) == 0
    out = capsys.readouterr().out
    assert "through the native record engine" in out
    assert "dist_lm: OK" in out


def test_data_names_the_python_engine_it_falls_back_to(tmp_path,
                                                        monkeypatch, capsys):
    """Without g++ the run says so and reads the Python engine's rows,
    which are the native engine's: the same final loss."""
    from tf_operator_tpu_torch import native

    path = chain_corpus(str(tmp_path / "corpus.bin"), 20, 16, 32)
    flags = small(3)[:-2] + ["--target-loss", "10", "--data", path]
    assert dist_lm.main(flags) == 0
    native_out = capsys.readouterr().out

    def no_compiler(source):
        raise native.NativeBuildError("g++ unavailable: test")

    monkeypatch.setattr(native, "load_library", no_compiler)
    assert dist_lm.main(flags) == 0
    python_out = capsys.readouterr().out
    assert "through the native record engine" in native_out
    assert ("native record pipeline unavailable (g++ unavailable: test)"
            in python_out)
    assert "through the python record engine" in python_out
    loss = re.compile(r"final loss (\S+)")
    assert loss.search(python_out).group(1) == loss.search(
        native_out).group(1)


def test_more_than_one_process_waits_for_a8(monkeypatch, capsys):
    """Several processes train since A8a (tests/test_torch_dist_multi.py);
    what stays refused, before any peer is met, is a topology the port
    cannot join: processes with no coordinator. A multislice job is not
    one since A8a's remainder: as JAX's entry point, each slice trains as
    a world of its own from the in-slice env (a slice of one process
    here), whatever MEGASCALE_* says."""
    monkeypatch.delenv("TPU_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("TF_CONFIG", raising=False)
    monkeypatch.setenv("TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    with pytest.raises(SystemExit) as exc:
        dist_lm.main(["--device", "cpu"])
    assert exc.value.code == 2
    assert ("2 training processes need TPU_COORDINATOR_ADDRESS"
            in capsys.readouterr().err)
    monkeypatch.setenv("TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("TPU_WORKER_ID", "0")
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    monkeypatch.setenv("MEGASCALE_SLICE_ID", "1")
    assert dist_lm.main(small(2)) == 0
    out = capsys.readouterr().out
    assert "process 0/1, mesh {'dp': 1, 'sp': 1, 'tp': 1}" in out
