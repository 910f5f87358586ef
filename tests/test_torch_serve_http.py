"""The port's HTTP server (tf_operator_tpu_torch/serve/serve_lm.py) on
the CPU (``--device cpu``), in f32 with the JAX init weights, held
against JAX's solo ``generate`` and driven by the JAX package's own fleet
router.

- In process (``build_front``): greedy, sampled, multi-row (row i seeded
  seed + i), eos and ``stream`` requests give JAX's tokens; the fields of
  unported items and ``top_p`` without ``temperature`` answer typed 400s;
  /healthz, /debug/serve, /debug/traces and /metrics answer.
- A port replica registered in the JAX package's FleetMembership turns
  ready, and its RouterServer serves /generate from it with the tokens of
  a direct request.
- As a process (``python -m tf_operator_tpu_torch.serve.serve_lm``), the
  SIGTERM drain of tests/test_examples.py's
  test_serve_lm_continuous_drains_on_sigterm: the admitted request
  finishes whole, the queued one gets a 503, the process exits 0.

The clients wait on /healthz readings and on their own responses with
generous timeouts; no assertion reads the wall clock."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import free_port
from tf_operator_tpu.fleet.membership import FleetMembership
from tf_operator_tpu.fleet.router import RouterConfig, RouterServer
from tf_operator_tpu.models.transformer import Transformer as JaxTransformer
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.serve import resilience, serve_lm
from test_serve_sched import CFG, prompt_of, solo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = TransformerConfig(
    dtype=torch.float32, **{k: getattr(CFG, k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
        "max_seq_len")})


@pytest.fixture(scope="module")
def front():
    params = JaxTransformer(CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    args = serve_lm.front_args(device="cpu", max_batch=4, kv_block=8,
                               max_seq_len=CFG.max_seq_len, prefill_chunk=4,
                               stream_segment=4, replica_id="gpu-0")
    supervisor, server = serve_lm.build_front(
        TCFG, jax.tree.map(np.asarray, params), args)
    server.start()
    yield params, supervisor, "http://" + server.endpoint
    server.drain(timeout=60)
    resilience.set_replica_id("")


def call(url, path, body=None, timeout=120.0):
    """(status, payload): JSON, NDJSON lines, or text."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read().decode()
            kind = resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read().decode()
        kind = exc.headers.get("Content-Type", "")
    if "ndjson" in kind:
        return status, [json.loads(line) for line in raw.splitlines()]
    return status, json.loads(raw) if "json" in kind else raw


def test_generate_greedy_sampled_multirow_eos_and_stream(front):
    params, _, url = front
    a, b = prompt_of(6, 1), prompt_of(6, 2)
    status, out = call(url, "/generate", {"tokens": a.tolist(),
                                          "num_steps": 8})
    assert status == 200 and out["finish_reason"] == ["length"]
    want = solo(params, a, 8)
    assert out["tokens"] == want.tolist()
    status, out = call(url, "/generate", {
        "tokens": [a[0].tolist(), b[0].tolist()], "num_steps": 7,
        "temperature": 0.8, "top_p": 0.9, "seed": 5, "timing": True})
    assert status == 200 and len(out["timing"]) == 2
    for i, p in enumerate((a, b)):  # row i samples with seed + i
        assert out["tokens"][i] == solo(params, p, 7, temperature=0.8,
                                        top_p=0.9, seed=5 + i)[0].tolist()
    eos = int(want[0, 2])
    status, out = call(url, "/generate", {"tokens": a.tolist(),
                                          "num_steps": 8, "eos_id": eos})
    k = want[0].tolist().index(eos)
    assert out["tokens"] == [want[0, :k + 1].tolist()]
    assert out["finish_reason"] == ["eos"]
    status, lines = call(url, "/generate", {"tokens": a.tolist(),
                                            "num_steps": 8, "stream": True})
    assert status == 200 and len(lines) == 2
    assert [t for line in lines for t in line["tokens"][0]] == \
        want[0].tolist()


@pytest.mark.parametrize("body,code,item", [
    ({"regex": "a+"}, "invalid_grammar", "A6"),
    ({"json_schema": {"type": "string"}}, "invalid_grammar", "A6"),
    ({"choices": ["a", "b"]}, "invalid_grammar", "A6"),
    ({"stop": [[1, 2]]}, "invalid_grammar", "A6"),
    ({"logprobs": True}, "bad_request", "A6"),
    ({"n": 2, "temperature": 0.5}, "bad_request", "A6"),
    ({"shipped_kv": {"blocks": []}}, "bad_request", "A7"),
    ({"session": "s1"}, "bad_request", "A7"),
    ({"top_p": 0.9}, "bad_request", None),
    ({"stream": True, "temperature": 0.5}, "bad_request", None),
])
def test_typed_400s(front, body, code, item):
    """The fields of items the port has not ported, and top_p without a
    temperature, answer a typed, non-retryable 400 naming the item."""
    _, supervisor, url = front
    done0 = supervisor.requests_done
    status, out = call(url, "/generate", {
        "tokens": prompt_of(4, 3).tolist(), "num_steps": 4, **body})
    assert status == 400 and out["code"] == code
    assert out["retryable"] is False and out["replica"] == "gpu-0"
    if item:
        assert f"ROADMAP {item}" in out["detail"]
    assert supervisor.requests_done == done0


def test_gets(front):
    _, supervisor, url = front
    call(url, "/generate", {"tokens": prompt_of(4, 4).tolist(),
                            "num_steps": 3})
    status, health = call(url, "/healthz")
    assert status == 200 and health["ok"] and health["replica"] == "gpu-0"
    assert health["max_slots"] == 4 and health["engine"] == "continuous"
    assert health["watchdog_restarts"] == 0
    status, debug = call(url, "/debug/serve")
    assert status == 200 and debug["engine"] == "continuous"
    assert set(debug) == set(supervisor.debug_snapshot())
    assert debug["resilience"]["max_restarts"] == 3
    status, traces = call(url, "/debug/traces")
    assert status == 200 and traces["process"] == "tpu-serve"
    assert {"queue.wait", "admit.plan", "decode.interval"} <= {
        e["name"] for e in traces["traceEvents"]}
    status, text = call(url, "/metrics")
    assert status == 200 and "# TYPE tpu_serve_requests_total counter" \
        in text
    status, out = call(url, "/prefix/abc")
    assert status == 400 and "ROADMAP A7" in out["detail"]
    assert call(url, "/nope")[0] == 404


def test_fleet_router_serves_a_port_replica(front):
    """The JAX package's membership and router drive the port replica
    unchanged: it turns ready from its /healthz, and /generate through
    the router gives the direct request's tokens."""
    _, _, url = front
    membership = FleetMembership()
    membership.register("gpu-0", url[len("http://"):])
    router = RouterServer(membership, config=RouterConfig(
        probe_interval_s=0.1, probe_timeout_s=30.0)).start()
    try:
        limit = time.monotonic() + 60
        while membership.counts()["ready"] != 1:
            assert time.monotonic() < limit, membership.counts()
            time.sleep(0.05)
        body = {"tokens": prompt_of(5, 9).tolist(), "num_steps": 6,
                "temperature": 0.7, "seed": 3}
        status, via = call(f"http://{router.endpoint}", "/generate", body)
        assert status == 200
        assert via["tokens"] == call(url, "/generate", body)[1]["tokens"]
    finally:
        router.stop()


@pytest.mark.parametrize("argv,reason", [
    (["--tp", "2"], "ROADMAP A8"),
    (["--dp", "2"], "ROADMAP A8"),
    (["--spec-k", "2"], "ROADMAP A6"),
    (["--logprobs-k", "3"], "ROADMAP A6"),
    (["--kv-dense"], "ROADMAP A5"),
    (["--engine", "coalesce"], "ROADMAP A10"),
    (["--batch-window", "0.01"], "ROADMAP A10"),
    (["--checkpoint-dir", "ckpt"], "ROADMAP A10"),
    (["--role", "prefill"], "ROADMAP A7"),
    (["--host-tier-bytes", "1024"], "ROADMAP A7"),
    (["--prefill-budget", "0"], "--prefill-budget must be >= 1"),
    (["--max-seq-len", "100", "--kv-block", "16"], "multiple of"),
])
def test_flags_refused_before_device_work(argv, reason, capsys):
    """A flag of an unported item, or one the engine cannot take, is
    refused by build_front (NotPorted or ValueError) and by the entry
    point (usage error, exit 2) before any weights are trained."""
    args = serve_lm.build_parser().parse_args(["--device", "cpu", *argv])
    with pytest.raises((resilience.NotPorted, ValueError), match=reason):
        serve_lm.build_front(TCFG, {}, args)
    with pytest.raises(SystemExit) as exc:
        serve_lm.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr()
    assert reason in err.err and "quick-trained" not in err.out


def test_serve_lm_drains_on_sigterm(tmp_path):
    """test_serve_lm_continuous_drains_on_sigterm over the port: one slot;
    the admitted long request finishes whole, the queued one gets a 503,
    and the process exits 0 after the drain."""
    port = free_port()
    log = tmp_path / "serve.log"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.serve.serve_lm",
             "--device", "cpu", "--port", str(port), "--train-steps", "2",
             "--max-seq-len", "512", "--max-batch", "1"],
            env=env, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        limit = time.monotonic() + 180
        while True:
            try:
                call(url, "/healthz", timeout=5)
                break
            except OSError:
                assert proc.poll() is None, log.read_text()
                assert time.monotonic() < limit, log.read_text()
                time.sleep(0.2)
        results: dict = {}

        def ask(key, tokens, steps):
            results[key] = call(url, "/generate", {"tokens": [tokens],
                                                   "num_steps": steps})

        first = threading.Thread(target=ask,
                                 args=("first", [5, 6, 7, 8], 480))
        first.start()

        def until(key):
            limit = time.monotonic() + 60
            while call(url, "/healthz")[1].get(key, 0) < 1:
                assert time.monotonic() < limit, key
                time.sleep(0.02)

        until("active_slots")
        second = threading.Thread(target=ask,
                                  args=("second", [9, 10, 11, 12], 4))
        second.start()
        until("queue_depth")
        proc.send_signal(signal.SIGTERM)
        first.join(timeout=120)
        second.join(timeout=120)
        status, body = results["first"]
        assert status == 200 and len(body["tokens"][0]) == 480
        status, body = results["second"]
        assert status == 503 and body["code"] == "draining"
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
    assert "engine drained" in log.read_text()
