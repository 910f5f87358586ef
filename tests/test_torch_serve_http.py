"""The port's HTTP server (tf_operator_tpu_torch/serve/serve_lm.py) on
the CPU (``--device cpu``), in f32 with the JAX init weights, held
against JAX's solo ``generate`` and driven by the JAX package's own fleet
router.

- In process (``build_front``): greedy, sampled, multi-row (row i seeded
  seed + i), eos and ``stream`` requests give JAX's tokens; the structured
  fields (``regex``, ``json_schema``, ``choices``, ``stop``, ``logprobs``,
  ``n`` > 1) give the JAX scheduler's tokens, ``finish_reason``, logprob
  rows and ``choices`` under examples/serve_lm.py's payload keys; the
  fields of unported items, bad structured requests and ``top_p`` without
  ``temperature`` answer typed 400s; /healthz, /debug/serve,
  /debug/traces and /metrics answer.
- Checkpoints of the port's trainer (``train/dist_lm.py``), a target and
  a draft, restored by ``restore_params`` and served under ``--spec-k``:
  greedy tokens equal ``generate`` (the port's and JAX's) on the restored
  tree; an empty directory ends ``main`` with JAX's message.
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
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import free_port
from tf_operator_tpu.fleet.membership import FleetMembership
from tf_operator_tpu.fleet.router import RouterConfig, RouterServer
from tf_operator_tpu.models.transformer import Transformer as JaxTransformer
from tf_operator_tpu.serve import constrain as jc
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu.serve.scheduler import (
    ContinuousScheduler as JaxScheduler,
    ServeRequest as JaxRequest,
)
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
                               stream_segment=4, replica_id="gpu-0",
                               logprobs_k=3)
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


@pytest.fixture(scope="module")
def jax_front(front):
    """The JAX scheduler over the JAX engine (logprobs_k 3, the same
    constraint pool) and compiler, on the same weights: what the JAX
    server's /generate hands each row to."""
    sched = JaxScheduler(
        JaxEngine(CFG, front[0], max_slots=4, kv_paged=True, kv_block=8,
                  prefill_chunk=4, logprobs_k=3),
        constrainer=jc.ConstraintCompiler(jc.default_vocab(CFG.vocab_size)),
    ).start()
    yield sched
    sched.stop(timeout=60)


def jax_payload(sched, body) -> dict:
    """examples/serve_lm.py's /generate payload for ``body`` (less the
    request id), each row through the JAX scheduler."""
    prompt = np.asarray(body["tokens"], np.int32)
    n_best = int(body.get("n", 1))
    constrain = {k: body[k] for k in ("json_schema", "regex", "choices")
                 if body.get(k) is not None} or None
    rows = []
    for i in range(n_best if n_best > 1 else prompt.shape[0]):
        rows.append(sched.submit_request(JaxRequest(
            prompt[0:1] if n_best > 1 else prompt[i:i + 1],
            body["num_steps"], temperature=body.get("temperature", 0.0),
            top_p=body.get("top_p"), seed=body.get("seed", 0) + i,
            constrain=constrain, stop=body.get("stop"),
            logprobs=bool(body.get("logprobs"))), timeout=120))
    out = {"tokens": [list(r.out) for r in rows],
           "finish_reason": [r.finish_reason for r in rows]}
    if body.get("logprobs"):
        out["logprobs"] = [r.logprob_rows for r in rows]
    if n_best > 1:
        out["choices"] = [{"tokens": list(r.out),
                           "seed": body.get("seed", 0) + j,
                           "finish_reason": r.finish_reason}
                          for j, r in enumerate(rows)]
    return out


def test_spec_front_serves_as_jax():
    """``--spec-k 2`` on the CPU: /generate rows (greedy multi-row,
    sampled with top_p, an eos, a regex) equal the JAX spec scheduler's
    on the same weights and draft (the draft at serve_lm's default depth,
    max(1, layers // 2)); /healthz and /debug/serve carry the ``spec``
    section, /metrics both spec families with samples."""
    params = JaxTransformer(CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    dcfg = replace(CFG, n_layers=1)
    dparams = JaxTransformer(dcfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"]
    args = serve_lm.front_args(device="cpu", max_batch=4, kv_block=8,
                               max_seq_len=CFG.max_seq_len, prefill_chunk=4,
                               spec_k=2)
    assert serve_lm.draft_config(TCFG, args).n_layers == dcfg.n_layers
    supervisor, server = serve_lm.build_front(
        TCFG, jax.tree.map(np.asarray, params), args,
        jax.tree.map(np.asarray, dparams))
    server.start()
    url = "http://" + server.endpoint
    sched = JaxScheduler(
        JaxEngine(CFG, params, max_slots=4, kv_paged=True, kv_block=8,
                  prefill_chunk=4, spec_k=2, draft_cfg=dcfg,
                  draft_params=dparams),
        constrainer=jc.ConstraintCompiler(jc.default_vocab(CFG.vocab_size)),
    ).start()
    a, b = prompt_of(6, 1), prompt_of(6, 2)
    bodies = [
        {"tokens": [a[0].tolist(), b[0].tolist()], "num_steps": 9},
        {"tokens": [a[0].tolist(), b[0].tolist()], "num_steps": 7,
         "temperature": 0.8, "top_p": 0.9, "seed": 5},
        {"tokens": a.tolist(), "num_steps": 8, "regex": "[0-9]{2,5}"},
    ]
    try:
        for body in bodies:
            status, out = call(url, "/generate", body)
            want = jax_payload(sched, body)
            assert status == 200
            assert out["tokens"] == want["tokens"]
            assert out["finish_reason"] == want["finish_reason"]
        greedy = call(url, "/generate", bodies[0])[1]["tokens"][0]
        eos = greedy[3]
        status, out = call(url, "/generate", {
            "tokens": a.tolist(), "num_steps": 9, "eos_id": eos})
        assert out["tokens"] == [greedy[:greedy.index(eos) + 1]]
        assert out["finish_reason"] == ["eos"]
        _, health = call(url, "/healthz")
        _, debug = call(url, "/debug/serve")
        _, metrics = call(url, "/metrics")
    finally:
        sched.stop(timeout=60)
        server.drain(timeout=60)
    assert health["spec"]["k"] == 2 and health["spec"]["rounds"] > 0
    assert debug["spec"]["k"] == 2 and debug["spec"]["tokens"] > 0
    assert 0.0 <= debug["spec"]["accept_rate"] <= 1.0
    for family in ("tpu_serve_spec_rounds_total",
                   "tpu_serve_spec_accept_tokens_count"):
        assert float(re.search(rf"^{family} (\S+)$", metrics,
                               re.M).group(1)) > 0


@pytest.mark.parametrize("fields,reason", [
    ({"regex": "[0-9]{2,5}"}, "grammar_complete"),
    ({"json_schema": {"type": "string", "maxLength": 3},
      "temperature": 0.8, "seed": 2}, "grammar_complete"),
    ({"choices": ["12", "3=", "<>"], "temperature": 0.9, "top_p": 0.9,
      "seed": 7}, "grammar_complete"),
    ({"stop": None}, "stop_sequence"),
    ({"logprobs": True}, "length"),
    ({"n": 2, "temperature": 0.7, "seed": 4}, None),
])
def test_structured_fields_served_as_jax(front, jax_front, fields, reason):
    """Each structured field gives the JAX scheduler's rows under the JAX
    server's payload keys: tokens, finish_reason, logprob rows (ids equal,
    values within 1e-5) and the n-best ``choices``. ``stop`` takes two
    tokens of the greedy stream, so it trims there."""
    _, supervisor, url = front
    body = {"tokens": prompt_of(6, 3).tolist(), "num_steps": 10, **fields}
    if "stop" in fields:
        free = jax_payload(jax_front, {**body, "stop": None})["tokens"][0]
        body["stop"] = [free[3:5]]
    want = jax_payload(jax_front, body)
    status, got = call(url, "/generate", body)
    assert status == 200, got
    assert set(got) - {"request_id"} == set(want)
    for key in ("tokens", "finish_reason", "choices"):
        assert got.get(key) == want.get(key), key
    if reason:
        assert got["finish_reason"] == [reason]
    for grow, wrow in zip(got.get("logprobs", [[]])[0],
                          want.get("logprobs", [[]])[0]):
        assert (grow["token"], grow["top_ids"]) == (wrow["token"],
                                                    wrow["top_ids"])
        np.testing.assert_allclose(
            [grow["logprob"], *grow["top_logprobs"]],
            [wrow["logprob"], *wrow["top_logprobs"]], rtol=0, atol=1e-5)
    if "logprobs" in fields:
        assert len(got["logprobs"][0]) == 10
    snap = supervisor.debug_snapshot()["constrain"]
    assert snap["slots_constrained"] == 0 and snap["logprobs_k"] == 3


@pytest.mark.parametrize("body,status,code", [
    ({"shipped_kv": {"blocks": []}}, 503, "ship_failed"),
    ({"session": "s1"}, 200, None),
])
def test_shipment_and_session_fields(front, body, status, code):
    """The fields of disaggregated serving and the host tier: a shipment
    that fails verification answers the typed ``ship_failed`` (retryable:
    the router prefills again) before anything is queued; a session key on
    a replica without a host tier serves the prompt as a request without
    one does."""
    _, supervisor, url = front
    plain = {"tokens": prompt_of(4, 3).tolist(), "num_steps": 4}
    done0 = supervisor.requests_done
    got_status, out = call(url, "/generate", {**plain, **body})
    assert got_status == status
    if code:
        assert out["code"] == code and out["retryable"] is True
        assert out["replica"] == "gpu-0"
        assert supervisor.requests_done == done0
    else:
        assert out["tokens"] == call(url, "/generate", plain)[1]["tokens"]


@pytest.mark.parametrize("body,code,item", [
    ({"top_p": 0.9}, "bad_request", None),
    ({"stream": True, "temperature": 0.5}, "bad_request", None),
    ({"stream": True, "regex": "[0-9]+"}, "bad_request", None),
    ({"regex": "[unclosed"}, "invalid_grammar", None),
    ({"choices": ["cat"]}, "invalid_grammar", None),  # no lowercase at V=64
    ({"stop": [3.5]}, "invalid_grammar", None),
    ({"n": 2}, "bad_request", None),
    ({"n": 5, "temperature": 0.5}, "bad_request", None),
])
def test_typed_400s(front, body, code, item):
    """Structured requests that cannot be served (a bad grammar or stop,
    ``stream`` with a grammar, greedy ``n`` > 1 or more candidates than
    slots) and top_p without a temperature answer a typed, non-retryable
    400, naming the item where there is one."""
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
    assert status == 404 and out["code"] == "prefix_not_found"
    assert out["retryable"] is False and out["replica"] == "gpu-0"
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
    # --tp serves since A8b's first half (tests/test_torch_tp.py): the
    # case pins a combination that still waits for A8b's second half.
    pytest.param(["--tp", "2", "--spec-k", "2"], "ROADMAP A8",
                 id="argv0-ROADMAP A8"),
    (["--dp", "2"], "ROADMAP A8"),
    (["--tp", "2", "--host-tier-bytes", "1000"], "A8b's second half"),
    (["--tp", "2", "--role", "prefill"], "A8b's second half"),
    (["--tp", "3"], "tp=3 must divide n_heads"),
    (["--spec-k", "2", "--int8"], "does not compose with --int8"),
    (["--logprobs-k", "-1"], "--logprobs-k must be >= 0"),
    (["--constrain-rows", "0"], "--constrain-rows must be >= 1"),
    (["--engine", "continuous", "--batch-window", "250"],
     "--engine continuous does not compose with --batch-window"),
    (["--role", "prefill", "--batch-window", "250"],
     "--role prefill does not compose with --batch-window"),
    (["--kv-block", "16", "--max-seq-len", "100"],
     "(or use --kv-dense)"),
    (["--from-pp", "2"], "ROADMAP A8"),
    (["--role", "prefill", "--int8"],
     "--role prefill does not compose with --int8"),
    (["--role", "prefill", "--spec-k", "2", "--kv-int8"],
     "--role prefill does not compose with --spec-k/--kv-int8"),
    (["--prefill-budget", "0"], "--prefill-budget must be >= 1"),
    (["--max-seq-len", "100", "--kv-block", "16"], "multiple of"),
    (["--spec-k", "2", "--logprobs-k", "3"],
     "--logprobs-k does not compose with --spec-k"),
    (["--draft-checkpoint-dir", "ckpt"], "requires --spec-k"),
    (["--spec-k", "2", "--checkpoint-dir", "ckpt"],
     "--spec-k with --checkpoint-dir also needs --draft-checkpoint-dir"),
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


def test_dense_flag_takes_any_sequence_length():
    """``--kv-dense`` has no block grid: a length off it is accepted, and
    the server builds (``main`` goes on to train its weights)."""
    argv = ["--device", "cpu", "--kv-dense", "--max-seq-len", "100",
            "--kv-block", "16"]
    args = serve_lm.build_parser().parse_args(argv)
    serve_lm.check_args(args)
    assert args.engine == "continuous" and not args.kv_paged
    cfg = replace(TCFG, max_seq_len=100)
    supervisor, server = serve_lm.build_front(
        cfg, serve_lm.quick_train(cfg, 0, 0.0), args)
    try:
        assert supervisor.engine.kv_debug() == {
            "mode": "dense", "cache_rows": 8, "max_seq_len": 100}
    finally:
        server.start().drain(timeout=60)


def test_serves_a_port_checkpoint_target_and_draft(tmp_path, monkeypatch,
                                                  capsys):
    """The port's trainer writes a target (2 layers) and a draft (1, the
    --spec-k default depth) checkpoint; serve_lm restores both
    (``restore_params``, the entry point's path) into ``build_front`` under
    --spec-k 2, and its greedy tokens equal the port's and JAX's
    ``generate`` on the restored target tree. An empty directory makes
    ``main`` print JAX's message and return 1."""
    from tf_operator_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        generate as jax_generate,
    )
    from tf_operator_tpu_torch.models.transformer import generate
    from tf_operator_tpu_torch.train import dist_lm
    from tf_operator_tpu_torch.utils import signals

    monkeypatch.setattr(signals, "setup_signal_handler", threading.Event)
    monkeypatch.delenv("TPU_CKPT_ACK_FILE", raising=False)
    shape = ["--vocab", "64", "--d-model", "32", "--seq", "64"]
    dirs = {}
    for label, layers in (("target", 2), ("draft", 1)):
        dirs[label] = str(tmp_path / label)
        assert dist_lm.main([
            "--device", "cpu", "--steps", "6", "--batch", "4", *shape,
            "--layers", str(layers), "--target-loss", "10",
            "--checkpoint-dir", dirs[label]]) == 0
    argv = ["--device", "cpu", "--vocab", "64", "--d-model", "32",
            "--max-seq-len", "64", "--kv-block", "8", "--max-batch", "2",
            "--spec-k", "2", "--checkpoint-dir", dirs["target"],
            "--draft-checkpoint-dir", dirs["draft"]]
    args = serve_lm.build_parser().parse_args(argv)
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq_len=64,
                            dtype=torch.float32)
    params = serve_lm.restore_params(args.checkpoint_dir, cfg, "target")
    draft = serve_lm.restore_params(args.draft_checkpoint_dir,
                                    serve_lm.draft_config(cfg, args), "draft")
    out = capsys.readouterr().out
    assert "serve_lm: restored target checkpoint step 5" in out
    assert "serve_lm: restored draft checkpoint step 5" in out
    supervisor, server = serve_lm.build_front(cfg, params, args, draft)
    server.start()
    url = "http://" + server.endpoint
    prompts = [prompt_of(6, 1), prompt_of(5, 2)]
    try:
        status, got = call(url, "/generate", {
            "tokens": [p[0].tolist() for p in prompts[:1]], "num_steps": 9})
        status2, got2 = call(url, "/generate", {
            "tokens": prompts[1].tolist(), "num_steps": 9})
        _, health = call(url, "/healthz")
    finally:
        server.drain(timeout=60)
        resilience.set_replica_id("")
    assert status == status2 == 200
    assert health["spec"]["rounds"] > 0
    jcfg = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                     d_ff=64, max_seq_len=64, dtype=jnp.float32)
    for prompt, tokens in zip(prompts, (got, got2)):
        want = generate(cfg, params, torch.from_numpy(prompt), 9,
                        device="cpu")
        assert tokens["tokens"] == want.tolist()
        jwant = jax_generate(jcfg, jax.tree.map(jnp.asarray, params),
                             jnp.asarray(prompt), 9)
        assert tokens["tokens"] == np.asarray(jwant).tolist()
    empty = str(tmp_path / "empty")
    assert serve_lm.main(["--device", "cpu", "--checkpoint-dir", empty]) == 1
    err = capsys.readouterr()
    assert f"serve_lm: no checkpoint in {empty}" in err.err
    assert "quick-trained" not in err.out


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


def _jax_params(cfg=CFG, seed=0):
    return JaxTransformer(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]


def _concurrent(url, bodies):
    out = [None] * len(bodies)

    def client(i):
        out[i] = call(url, "/generate", bodies[i])

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert all(o is not None for o in out)
    return out


def test_dense_front_serves_as_jax():
    """``--kv-dense``: concurrent greedy and sampled requests give the JAX
    dense engine's tokens; /debug/serve reads ``mode: "dense"``; a
    ``shipped_kv`` request is prefilled locally (counted ``unsupported``)
    and answers as the same request without one; ``GET /prefix/<digest>``
    answers 404 ``prefix_not_found``."""
    from tf_operator_tpu_torch.runtime.metrics import SERVE_SHIP_INGEST_TOTAL
    from tf_operator_tpu_torch.serve.disagg import PrefillWorker

    params = _jax_params()
    tparams = jax.tree.map(np.asarray, params)
    args = serve_lm.front_args(device="cpu", max_batch=4, kv_paged=False,
                               max_seq_len=CFG.max_seq_len, prefill_chunk=4,
                               kv_attend="pallas", host_tier_bytes=1 << 20)
    supervisor, server = serve_lm.build_front(TCFG, tparams, args)
    server.start()
    url = "http://" + server.endpoint
    sched = JaxScheduler(JaxEngine(CFG, params, max_slots=4, kv_paged=False,
                                   prefill_chunk=4)).start()
    bodies = [{"tokens": prompt_of(5 + i, 20 + i).tolist(), "num_steps": 9}
              for i in range(3)]
    bodies.append({"tokens": prompt_of(6, 30).tolist(), "num_steps": 7,
                   "temperature": 0.8, "top_p": 0.9, "seed": 4})
    shipped = {**bodies[0], "shipped_kv": PrefillWorker(
        TCFG, tparams, kv_block=8, device="cpu").prefill(
        np.asarray(bodies[0]["tokens"]))}
    unsupported = SERVE_SHIP_INGEST_TOTAL.value(outcome="unsupported")
    try:
        got = _concurrent(url, bodies)
        status, ship = call(url, "/generate", shipped)
        _, debug = call(url, "/debug/serve")
        pstatus, miss = call(url, "/prefix/" + "ab" * 20)
        _, health = call(url, "/healthz")
        want = [jax_payload(sched, body) for body in bodies]
    finally:
        sched.stop(timeout=60)
        server.drain(timeout=60)
    for (code, out), w in zip(got, want):
        assert code == 200 and out["tokens"] == w["tokens"]
        assert out["finish_reason"] == w["finish_reason"]
    assert status == 200 and ship["tokens"] == got[0][1]["tokens"]
    assert SERVE_SHIP_INGEST_TOTAL.value(
        outcome="unsupported") == unsupported + 1
    assert debug["kv_cache"] == {"mode": "dense", "cache_rows": 4,
                                 "max_seq_len": CFG.max_seq_len}
    assert supervisor.engine.kv_attend == "gather"
    assert supervisor.engine.host_tier is None
    assert pstatus == 404 and miss["code"] == "prefix_not_found"
    assert "prefixes" not in health and "tier_prefixes" not in health


@pytest.fixture(scope="module")
def legacy():
    """A ``--engine coalesce`` front with no window: (JAX params, URL)."""
    params = _jax_params()
    args = serve_lm.front_args(device="cpu", engine="coalesce",
                               max_seq_len=CFG.max_seq_len,
                               stream_segment=4)
    supervisor, server = serve_lm.build_front(
        TCFG, jax.tree.map(np.asarray, params), args)
    assert supervisor is None and server.coalescer is None
    server.start()
    yield params, "http://" + server.endpoint
    server.drain(timeout=60)


def test_coalesce_front_answers_as_jax_generate(legacy):
    """The legacy path: a direct greedy request gives JAX's ``generate``,
    a multi-row one its rows, a seeded sampled one JAX's ``generate`` with
    that seed, a stream the greedy tokens; the answer is ``{"tokens"}``;
    /healthz names the engine; /debug/serve and /prefix are not served."""
    params, url = legacy
    a, b = prompt_of(6, 1), prompt_of(6, 2)
    status, out = call(url, "/generate", {"tokens": a.tolist(),
                                          "num_steps": 8})
    assert status == 200 and out == {"tokens": solo(params, a, 8).tolist()}
    status, out = call(url, "/generate", {
        "tokens": [a[0].tolist(), b[0].tolist()], "num_steps": 5})
    assert out["tokens"] == solo(params, np.concatenate([a, b]),
                                 5).tolist()
    status, out = call(url, "/generate", {
        "tokens": a.tolist(), "num_steps": 7, "temperature": 0.8,
        "top_p": 0.9, "seed": 5})
    assert out["tokens"] == solo(params, a, 7, temperature=0.8, top_p=0.9,
                                 seed=5).tolist()
    status, lines = call(url, "/generate", {"tokens": a.tolist(),
                                            "num_steps": 8, "stream": True})
    assert [t for line in lines for t in line["tokens"][0]] == \
        solo(params, a, 8)[0].tolist()
    status, health = call(url, "/healthz")
    assert health["engine"] == "coalesce" and health["served"] >= 3
    assert "coalesced_batches" not in health and "spec_decodes" not in health
    assert call(url, "/debug/serve")[0] == 404
    assert call(url, "/prefix/" + "ab" * 20)[0] == 404


@pytest.mark.parametrize("fields,detail", [
    ({"regex": "[0-9]+"}, "require --engine continuous"),
    ({"logprobs": True}, "require --engine continuous"),
    ({"n": 2, "temperature": 0.5}, "require --engine continuous"),
    ({"stream": True, "stop": [[1]]}, "stream does not compose"),
    ({"top_p": 0.9}, "requires temperature > 0"),
])
def test_coalesce_front_refuses_structured_fields(legacy, fields, detail):
    """The structured fields need the continuous engine: JAX's 400, typed
    as the continuous front types its errors."""
    _, url = legacy
    status, out = call(url, "/generate", {
        "tokens": prompt_of(4, 3).tolist(), "num_steps": 4, **fields})
    assert status == 400 and out["code"] == "bad_request"
    assert out["retryable"] is False and detail in out["detail"]


def test_batch_window_bursts_coalesce():
    """``--batch-window 250 --max-batch 8``: four same-shape greedy
    requests at once run as fewer decodes than requests (a batch of at
    least two rows), each answer its solo answer, and a second identical
    burst answers bit for bit as the first."""
    params = _jax_params()
    args = serve_lm.front_args(device="cpu", batch_window=250.0,
                               max_batch=8, max_seq_len=CFG.max_seq_len)
    supervisor, server = serve_lm.build_front(
        TCFG, jax.tree.map(np.asarray, params), args)
    assert supervisor is None and args.engine == "coalesce"
    server.start()
    url = "http://" + server.endpoint
    bodies = [{"tokens": prompt_of(6, 40 + i).tolist(), "num_steps": 6}
              for i in range(4)]
    try:
        alone = [call(url, "/generate", body)[1]["tokens"]
                 for body in bodies]
        _, before = call(url, "/healthz")
        first = [out for _, out in _concurrent(url, bodies)]
        second = [out for _, out in _concurrent(url, bodies)]
        _, health = call(url, "/healthz")
    finally:
        server.drain(timeout=60)
    for body, tokens in zip(bodies, alone):
        assert tokens == solo(params, np.asarray(body["tokens"]),
                              6).tolist()
    assert [out["tokens"] for out in first] == alone
    assert second == first
    burst_batches = health["coalesced_batches"] - before["coalesced_batches"]
    assert 2 <= burst_batches < 2 * len(bodies)
    assert health["max_batch_rows"] >= 2 and health["pending"] == 0


def test_coalesce_front_counts_spec_decodes():
    """``--spec-k 2`` on the legacy path: greedy (direct and coalesced)
    and sampled requests decode speculatively, each equal to JAX's
    ``generate`` greedy; /healthz counts ``spec_decodes``/``spec_rounds``;
    a request whose margin does not fit the cache runs plain ``generate``
    and is not counted."""
    params = _jax_params()
    dcfg = replace(CFG, n_layers=1)
    dparams = _jax_params(dcfg, 7)
    args = serve_lm.front_args(device="cpu", batch_window=50.0,
                               max_seq_len=CFG.max_seq_len, spec_k=2)
    _, server = serve_lm.build_front(
        TCFG, jax.tree.map(np.asarray, params), args,
        jax.tree.map(np.asarray, dparams))
    server.start()
    url = "http://" + server.endpoint
    a = prompt_of(6, 1)
    try:
        _, greedy = call(url, "/generate", {"tokens": a.tolist(),
                                            "num_steps": 9})
        status, sampled = call(url, "/generate", {
            "tokens": a.tolist(), "num_steps": 6, "temperature": 0.8,
            "seed": 2})
        _, health = call(url, "/healthz")
        # 6 + 56 + 2 + 1 > 64: plain generate.
        _, long = call(url, "/generate", {"tokens": a.tolist(),
                                          "num_steps": 56})
        _, after = call(url, "/healthz")
    finally:
        server.drain(timeout=60)
    assert greedy["tokens"] == solo(params, a, 9).tolist()
    assert status == 200 and len(sampled["tokens"][0]) == 6
    assert health["spec_decodes"] == 2 and health["spec_rounds"] >= 2
    assert health["spec_tokens"] == 15
    assert long["tokens"] == solo(params, a, 56).tolist()
    assert after["spec_decodes"] == 2


def test_coalesce_drains_a_parked_request_on_sigterm(tmp_path):
    """tests/test_examples.py's test_serve_lm_drains_queued_requests_on_
    shutdown over the port: SIGTERM while a request is parked in the batch
    window; the request is answered and the process exits 0."""
    port = free_port()
    log = tmp_path / "serve.log"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.serve.serve_lm",
             "--device", "cpu", "--port", str(port), "--train-steps", "2",
             "--batch-window", "1500", "--max-batch", "8"],
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
        body = {"tokens": [[5, 6, 7, 8]], "num_steps": 3}
        assert call(url, "/generate", body)[0] == 200
        result: dict = {}
        client = threading.Thread(
            target=lambda: result.update(out=call(url, "/generate", body)))
        client.start()
        limit = time.monotonic() + 20
        while call(url, "/healthz")[1].get("pending", 0) < 1:
            assert time.monotonic() < limit
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        client.join(timeout=60)
        status, out = result["out"]
        assert status == 200 and len(out["tokens"][0]) == 3
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
    text = log.read_text()
    assert "coalescing greedy requests (window 1500 ms" in text
    assert "done (2 request(s) served)" in text
