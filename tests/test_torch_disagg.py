"""Disaggregated prefill in the port (tf_operator_tpu_torch/serve/
disagg.py, the engine's ingest and the scheduler's), on the CPU, held
against tests/test_serve_disagg.py's pins and against the JAX package:

- The wire codec: a JSON round trip; tampered tokens, rows, prompt or
  version raise ``ShipFailed``; ``chain_digests`` is the PrefixCache
  chain (the port's and JAX's).
- Across frameworks, on the same prompt and the JAX init's weights (f32,
  bf16 and kv8): the port's payload has JAX's tokens and digests, and
  each side's ``_rows_sha1`` and ``decode_shipment`` accept the other's
  payload; re-encoding a decoded JAX payload through the port's export
  gives JAX's payload byte for byte (the bf16 rows travel as raw 2-byte
  words under ``"bfloat16"``). The rows agree by the rule of
  tf_operator_tpu_torch/testing.py in f32 and kv8; bf16 rows, which
  JAX's excess precision rounds at fewer points, are held to being about
  as near to the f32 rows as JAX's (``BF16_RMS_RATIO``).
- A JAX PrefillWorker's payload ingested by the port's engine decodes the
  port's local greedy tokens, and a port payload ingested by JAX's engine
  JAX's local tokens, in bf16 and kv8 (and f32).
- Within the port: shipped decode is bitwise the local decode, greedy and
  sampled, one-shot and chunked; ``decode_step_compiles`` does not move.
- The ingest bookkeeping as JAX's: a duplicate shares, release frees and
  invalidates, exhaustion requeues and then serves, a kv_block mismatch
  raises, a dense engine (no block pool) makes the shipment a no-op, and a
  shipment the engine refuses falls back to the local prefill, counted
  ``failed``.
- The prefill replica over HTTP (``PrefillServer``, serve_lm's
  ``build_prefill``): /prefill, /healthz, /metrics, the drain, and the
  ``prefill.ship`` span.

No assertion reads the wall clock."""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.transformer import (
    Transformer as JaxTransformer,
    TransformerConfig as JaxConfig,
    generate as jax_generate,
)
from tf_operator_tpu.serve import disagg as jd
from tf_operator_tpu.serve.engine import ContinuousEngine as JaxEngine
from tf_operator_tpu.serve.kvcache import PrefixCache as JaxPrefixCache
from tf_operator_tpu.serve.scheduler import (
    ContinuousScheduler as JaxScheduler,
    ServeRequest as JaxRequest,
)
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.runtime import metrics
from tf_operator_tpu_torch.serve import disagg, serve_lm
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.kvcache import PrefixCache
from tf_operator_tpu_torch.serve.resilience import ShipFailed
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
)
from tf_operator_tpu_torch.testing import excess

torch.set_num_threads(1)

# tests/test_serve_disagg.py's model and block.
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
          max_seq_len=64)
BLOCK = 8
MODES = {"f32": dict(), "bf16": dict(dtype="bfloat16"),
         "kv8": dict(kv_int8=True)}
# f32 and kv8 rows (and the kv8 scales): the same products summed in
# another order, ~1e-6 of the row's rms; atol 1e-5 of it, rtol 1e-5. The
# kv8 int8 values must be equal.
ROW_TOL = (1e-5, 1e-5)
# bf16: this process's JAX runs with XLA's excess precision, which keeps
# some bf16 intermediates in f32, so the rows are held to the f32 rows
# instead: the port's rms error over them within this factor of JAX's,
# per layer and part. The port rounds where JAX rounds without excess
# precision (tests/test_torch_bf16_rounding.py); on this test's prompt
# the ratio reads 1.212 at most (the logits 1.145), so 1.3.
BF16_RMS_RATIO = 1.3


def configs(mode: str):
    """(JAX config, port config) of a mode."""
    kw = dict(MODES[mode])
    dtype = kw.pop("dtype", "float32")
    return (JaxConfig(dtype=getattr(jnp, dtype), **kw, **KW),
            TransformerConfig(dtype=getattr(torch, dtype), **kw, **KW))


@pytest.fixture(scope="module")
def trees():
    """mode -> (JAX params, the same as a numpy tree)."""
    out = {}
    for mode in MODES:
        jcfg, _ = configs(mode)
        p = JaxTransformer(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        out[mode] = (p, jax.tree.map(np.asarray, p))
    return out


def prompt_of(p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, p)).astype(np.int32)


def solo(jcfg, params, prompt, steps, *, temperature=0.0, seed=0):
    kw = {}
    if temperature > 0:
        kw = dict(temperature=temperature, rng=jax.random.PRNGKey(seed))
    return np.asarray(jax_generate(jcfg, params, jnp.asarray(prompt), steps,
                                   **kw))[0].tolist()


def port_worker(trees, mode="f32", **kw) -> disagg.PrefillWorker:
    return disagg.PrefillWorker(configs(mode)[1], trees[mode][1],
                                kv_block=BLOCK, device="cpu", **kw)


def port_engine(trees, mode="f32", slots=2, **kw) -> ContinuousEngine:
    return ContinuousEngine(configs(mode)[1], trees[mode][1], slots,
                            kv_block=BLOCK, device="cpu", **kw)


def serve(engine, prompt, steps, **kw):
    """One request through a fresh scheduler: (request, snapshot)."""
    sched = ContinuousScheduler(engine).start()
    try:
        req = sched.submit_request(ServeRequest(prompt, steps, **kw),
                                   timeout=300)
        return req, sched.debug_snapshot()
    finally:
        sched.stop(timeout=60)


def wire(payload: dict) -> dict:
    return json.loads(json.dumps(payload))


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------


def test_chain_digests_match_both_prefix_cache_chains():
    toks = np.arange(19, dtype=np.int32)
    ours = disagg.chain_digests(toks, BLOCK)
    assert ours == [d.hex() for _, d in
                    reversed(PrefixCache(BLOCK)._chain_keys(toks))]
    assert ours == [d.hex() for _, d in
                    reversed(JaxPrefixCache(BLOCK)._chain_keys(toks))]
    assert ours == jd.chain_digests(toks, BLOCK)
    assert len(ours) == 3  # 2 full blocks + the partial tail


def test_round_trip_survives_json(trees):
    prompt = prompt_of(11, 1)
    shp = disagg.decode_shipment(wire(port_worker(trees).prefill(prompt)),
                                 expect_tokens=prompt[0])
    assert shp.prompt_len == 11 and shp.kv_block == BLOCK
    assert set(shp.rows) == {"block_0/attn", "block_1/attn"}
    for kv in shp.rows.values():
        # block-aligned: ceil(11/8)*8 = 16 rows a layer
        assert set(kv) == {"key", "value"}
        assert kv["key"].shape == kv["value"].shape == (16, 2, 16)
    assert shp.logits.shape == (KW["vocab_size"],)


def _tamper(payload: dict, how: str) -> tuple[dict, np.ndarray | None]:
    bad = wire(payload)
    if how == "tokens":
        bad["tokens"][0] = (bad["tokens"][0] + 1) % KW["vocab_size"]
    elif how == "rows":
        enc = bad["rows"]["block_0/attn"]["key"]
        raw = bytearray(base64.b64decode(enc["b64"]))
        raw[0] ^= 0xFF
        enc["b64"] = base64.b64encode(bytes(raw)).decode()
    elif how == "version":
        bad["version"] = 99
    expect = prompt_of(9, 5)[0] if how == "prompt" else None
    return bad, expect


@pytest.mark.parametrize("how", ["tokens", "rows", "prompt", "version"])
def test_tampered_payload_raises_ship_failed(trees, how):
    """Both packages refuse the same tampered payload with ShipFailed."""
    bad, expect = _tamper(port_worker(trees).prefill(prompt_of(9, 4)), how)
    with pytest.raises(ShipFailed):
        disagg.decode_shipment(bad, expect_tokens=expect)
    with pytest.raises(jd.ShipFailed):
        jd.decode_shipment(bad, expect_tokens=expect)


# ---------------------------------------------------------------------------
# across frameworks: the payloads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_payloads_match_jax(trees, mode):
    jcfg, _ = configs(mode)
    prompt = prompt_of(13, 40)
    jpay = wire(jd.PrefillWorker(jcfg, trees[mode][0],
                                 kv_block=BLOCK).prefill(prompt))
    ppay = wire(port_worker(trees, mode).prefill(prompt))
    for key in ("version", "tokens", "kv_block", "digests"):
        assert ppay[key] == jpay[key], key
    assert {p: {k: (v["shape"], v["dtype"]) for k, v in kv.items()}
            for p, kv in ppay["rows"].items()} == {
        p: {k: (v["shape"], v["dtype"]) for k, v in kv.items()}
        for p, kv in jpay["rows"].items()}
    # Each side verifies the other's payload, rows_sha1 included.
    mine, theirs = (disagg.decode_shipment(jpay, expect_tokens=prompt[0]),
                    disagg.decode_shipment(ppay, expect_tokens=prompt[0]))
    jd.decode_shipment(ppay, expect_tokens=prompt[0])
    assert disagg._rows_sha1(mine.rows) == jpay["rows_sha1"]
    assert jd._rows_sha1(jd.decode_shipment(ppay).rows) == ppay["rows_sha1"]
    # The port's export of JAX's rows IS JAX's payload.
    dense = {"layers": [
        {name: mine.rows[disagg.layer_path(i)][part][None]
         for name, part in disagg._DENSE_WIRE_PARTS.items()
         if part in mine.rows[disagg.layer_path(i)]}
        for i in range(KW["n_layers"])]}
    assert wire(disagg.export_shipment(dense, prompt[0], mine.logits,
                                       BLOCK)) == jpay
    # The rows and logits themselves.
    if mode == "bf16":
        _bf16_rows_as_exact_as_jax(trees, prompt, mine, theirs)
        return
    np.testing.assert_allclose(theirs.logits, mine.logits, rtol=0,
                               atol=1e-5)
    for path, kv in theirs.rows.items():
        for part, got in kv.items():
            want = mine.rows[path][part]
            if got.dtype == torch.int8:
                assert torch.equal(got, want), (path, part)
            else:
                assert excess(got, want, *ROW_TOL) <= 1, (path, part)


def _bf16_rows_as_exact_as_jax(trees, prompt, jax_shp, port_shp):
    """The port's bf16 prompt rows and logits no further (rms) from the
    port's f32 ones than JAX's bf16 ones, within ``BF16_RMS_RATIO``."""
    f32 = disagg.decode_shipment(port_worker(trees, "f32").prefill(prompt))
    n = prompt.shape[1]

    def rms(x, ref):
        return (x.float() - ref).pow(2).mean().sqrt().item()

    for path, kv in f32.rows.items():
        for part, ref in kv.items():
            err = [rms(s.rows[path][part][:n], ref[:n])
                   for s in (port_shp, jax_shp)]
            assert err[0] <= BF16_RMS_RATIO * err[1], (path, part, err)
    err = [rms(torch.from_numpy(s.logits), torch.from_numpy(f32.logits))
           for s in (port_shp, jax_shp)]
    assert err[0] <= BF16_RMS_RATIO * err[1], ("logits", err)


# ---------------------------------------------------------------------------
# across frameworks: ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_framework_ingest_decodes_the_local_tokens(trees, mode,
                                                         direction):
    """A payload prefilled by one package and ingested by the other's
    engine (through its scheduler) decodes the receiving package's local
    greedy tokens."""
    jcfg, _ = configs(mode)
    jparams, nparams = trees[mode]
    prompt = prompt_of(13, 41)
    steps = 8
    if direction == "jax_to_port":
        payload = wire(jd.PrefillWorker(jcfg, jparams,
                                        kv_block=BLOCK).prefill(prompt))
        shp = disagg.decode_shipment(payload, expect_tokens=prompt[0])
        local, _ = serve(port_engine(trees, mode), prompt, steps)
        got, snap = serve(port_engine(trees, mode), prompt, steps,
                          shipment=shp)
        assert snap["decode_step_compiles"] == snap["warmup_compiles"]
    else:
        payload = wire(port_worker(trees, mode).prefill(prompt))
        shp = jd.decode_shipment(payload, expect_tokens=prompt[0])
        outs = []
        for kw in ({}, {"shipment": shp}):
            sched = JaxScheduler(JaxEngine(jcfg, jparams, max_slots=2,
                                           kv_block=BLOCK)).start()
            try:
                outs.append(sched.submit_request(
                    JaxRequest(prompt, steps, **kw), timeout=300))
            finally:
                sched.stop(timeout=60)
        local, got = outs
    assert got.shipped_join, "the shipped request prefilled locally"
    assert got.out == local.out and len(got.out) == steps


# ---------------------------------------------------------------------------
# within the port: shipped == local, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefill_chunk", [None, 4],
                         ids=["oneshot", "chunked"])
@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 11)],
                         ids=["greedy", "sampled"])
def test_shipped_decode_bit_identical_to_local(trees, prefill_chunk,
                                               temperature, seed):
    """Decode is the same token for token whether the paged KV came from
    the local prefill or from shipped rows, through the whole scheduler
    path (ingest, exact-prefix plan, table-insert join), and equals JAX's
    solo generate; the decode step's compile count does not move."""
    prompt = prompt_of(13, 40 + (prefill_chunk or 0))
    steps = 8
    local, _ = serve(port_engine(trees, prefill_chunk=prefill_chunk),
                     prompt, steps, temperature=temperature, seed=seed)
    payload = wire(port_worker(trees, prefill_chunk=prefill_chunk)
                   .prefill(prompt))
    shp = disagg.decode_shipment(payload, expect_tokens=prompt[0])
    engine = port_engine(trees, prefill_chunk=prefill_chunk)
    compiles0 = engine.decode_step_compiles
    got, snap = serve(engine, prompt, steps, temperature=temperature,
                      seed=seed, shipment=shp)
    assert got.shipped_join and got.timing()["shipped_kv"] is True
    assert got.out == local.out == solo(configs("f32")[0], trees["f32"][0],
                                        prompt, steps,
                                        temperature=temperature, seed=seed)
    assert engine.decode_step_compiles == compiles0
    assert snap["decode_step_compiles"] == snap["warmup_compiles"]
    assert snap["kv_cache"]["shipments_ingested"] == 1
    assert snap["kv_cache"]["ship_tokens_ingested"] == 13


def test_shipped_and_local_interleave_on_one_engine(trees):
    """One engine serves shipped and locally prefilled requests side by
    side; each equals JAX's solo generate, and slots and blocks all come
    back."""
    pw = port_worker(trees)
    engine = port_engine(trees, slots=4)
    sched = ContinuousScheduler(engine).start()
    reqs = []
    for i in range(6):
        prompt = prompt_of(5 + 3 * i, 60 + i)
        shp = None
        if i % 2 == 0:
            shp = disagg.decode_shipment(pw.prefill(prompt),
                                         expect_tokens=prompt[0])
        reqs.append((prompt, ServeRequest(prompt, 6, shipment=shp)))
    out: dict = {}

    def client(i):
        out[i] = sched.submit_request(reqs[i][1], timeout=300)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    sched.stop(timeout=60)
    for i, (prompt, _) in enumerate(reqs):
        assert out[i].out == solo(configs("f32")[0], trees["f32"][0],
                                  prompt, 6)
        assert out[i].shipped_join == (i % 2 == 0)
    assert engine.active_slots == 0
    assert engine.blocks.used == 0, "blocks leaked through the ship path"


# ---------------------------------------------------------------------------
# the ingest bookkeeping
# ---------------------------------------------------------------------------


def test_duplicate_prompt_shares_instead_of_rewriting(trees):
    shp = disagg.decode_shipment(port_worker(trees).prefill(prompt_of(10, 70)))
    eng = port_engine(trees)
    h1 = eng.ingest_shipment(shp)
    assert h1 is not None and len(h1.blocks) == 2
    used = eng.blocks.used
    h2 = eng.ingest_shipment(shp)
    assert h2 is not None and h2.blocks == ()
    assert eng.blocks.used == used
    eng.release_shipment(h1)
    eng.release_shipment(h2)
    assert eng.blocks.used == 0


def test_release_unblocks_pool_and_invalidates_prefix(trees):
    prompt = prompt_of(10, 71)
    shp = disagg.decode_shipment(port_worker(trees).prefill(prompt))
    eng = port_engine(trees)
    hold = eng.ingest_shipment(shp)
    assert eng.prefix.lookup(prompt[0])[0] == 10
    eng.release_shipment(hold)
    eng.release_shipment(hold)  # idempotent
    assert eng.prefix.lookup(prompt[0])[0] == 0 and eng.blocks.used == 0


def test_kv_block_mismatch_raises(trees):
    pw = disagg.PrefillWorker(configs("f32")[1], trees["f32"][1],
                              kv_block=16, device="cpu")
    shp = disagg.decode_shipment(pw.prefill(prompt_of(10, 73)))
    with pytest.raises(ValueError, match="kv_block"):
        port_engine(trees).ingest_shipment(shp)


@pytest.mark.parametrize("sender,receiver", [("f32", "kv8"),
                                             ("kv8", "f32")])
def test_quantization_mismatch_falls_back_to_local_prefill(trees, sender,
                                                           receiver):
    """A kv8 pool refuses a shipment without scales, an f32 pool one with
    them (ValueError, nothing written); through the scheduler the request
    prefills locally, counted ``failed``, as JAX counts it."""
    prompt = prompt_of(12, 72)
    shp = disagg.decode_shipment(
        port_worker(trees, sender).prefill(prompt))
    eng = port_engine(trees, receiver)
    with pytest.raises(ValueError, match="parts"):
        eng.ingest_shipment(shp)
    assert eng.blocks.used == 0
    failed0 = metrics.SERVE_SHIP_INGEST_TOTAL.value(outcome="failed")
    local, _ = serve(port_engine(trees, receiver), prompt, 6)
    got, _ = serve(eng, prompt, 6, shipment=shp)
    assert not got.shipped_join and got.out == local.out
    assert metrics.SERVE_SHIP_INGEST_TOTAL.value(
        outcome="failed") == failed0 + 1


def test_dense_engine_makes_the_shipment_a_no_op(trees):
    """The dense slot engine (``kv_paged=False``, whose ingest returns
    None, as JAX's does) serves a shipped request by its local prefill,
    counted ``unsupported``, in the port's scheduler as in JAX's."""
    prompt = prompt_of(10, 72)
    shp = disagg.decode_shipment(port_worker(trees).prefill(prompt))
    jshp = jd.decode_shipment(port_worker(trees).prefill(prompt))
    dense = port_engine(trees, kv_paged=False)
    assert dense.ingest_shipment(shp) is None
    before = metrics.SERVE_SHIP_INGEST_TOTAL.value(outcome="unsupported")
    got, _ = serve(dense, prompt, 6, shipment=shp)
    jeng = JaxEngine(configs("f32")[0], trees["f32"][0], max_slots=2,
                     kv_paged=False)
    assert jeng.ingest_shipment(jshp) is None
    jsched = JaxScheduler(jeng).start()
    try:
        want = jsched.submit_request(JaxRequest(prompt, 6, shipment=jshp),
                                     timeout=300)
    finally:
        jsched.stop(timeout=60)
    assert not got.shipped_join and not want.shipped_join
    assert got.out == want.out
    assert metrics.SERVE_SHIP_INGEST_TOTAL.value(
        outcome="unsupported") == before + 1


def test_exhausted_pool_requeues_then_serves(trees):
    """Block exhaustion at ingest requeues (counted ``exhausted``); the
    capacity a retire frees lets the shipped request land, and both match
    JAX's solo generate."""
    eng = port_engine(trees, kv_blocks=9)  # 8 allocatable blocks
    a, b = prompt_of(24, 74), prompt_of(24, 75)
    shp_b = disagg.decode_shipment(port_worker(trees).prefill(b))
    sched = ContinuousScheduler(eng).start()
    ra = ServeRequest(a, 24)  # holds 6 blocks while live
    rb = ServeRequest(b, 8, shipment=shp_b)
    exhausted0 = metrics.SERVE_SHIP_INGEST_TOTAL.value(outcome="exhausted")
    sched.enqueue(ra)
    sched.enqueue(rb)
    for r in (ra, rb):
        assert r.event.wait(300)
    sched.stop(timeout=60)
    jcfg, jparams = configs("f32")[0], trees["f32"][0]
    assert ra.out == solo(jcfg, jparams, a, 24)
    assert rb.out == solo(jcfg, jparams, b, 8) and rb.shipped_join
    assert metrics.SERVE_SHIP_INGEST_TOTAL.value(
        outcome="exhausted") > exhausted0
    assert eng.blocks.used == 0


# ---------------------------------------------------------------------------
# the prefill replica over HTTP
# ---------------------------------------------------------------------------


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=120) as resp:
        raw = resp.read().decode()
        return (json.loads(raw) if "json" in resp.headers["Content-Type"]
                else raw)


def test_prefill_replica_over_http(trees):
    """serve_lm's ``build_prefill`` (``--role prefill``): POST /prefill
    answers the worker's payload, which decodes against the prompt; a bad
    body is a typed 400; /healthz carries ``role: "prefill"`` and the
    served counts; /metrics and /debug/traces answer, the latter with the
    ``prefill.ship`` span; a draining replica answers the typed 503."""
    args = serve_lm.front_args(device="cpu", role="prefill",
                               kv_block=BLOCK, max_seq_len=KW["max_seq_len"],
                               replica_id="p0")
    server = serve_lm.build_prefill(configs("f32")[1], trees["f32"][1],
                                    args).start()
    url = "http://" + server.endpoint
    try:
        prompt = prompt_of(13, 76)
        status, out = _post(url, "/prefill", {"tokens": prompt.tolist(),
                                              "request_id": "rq-1"})
        assert status == 200 and out["replica"] == "p0"
        assert out["request_id"] == "rq-1"
        shp = disagg.decode_shipment(out["shipped_kv"],
                                     expect_tokens=prompt[0])
        assert out["shipped_kv"] == wire(
            port_worker(trees).prefill(prompt))
        assert shp.prompt_len == 13
        status, bad = _post(url, "/prefill", {"tokens": [1, 2]})
        assert status == 400 and bad["code"] == "bad_request"
        health = _get(url, "/healthz")
        assert health["role"] == "prefill" and health["ok"]
        assert health["requests_done"] == 1
        assert health["tokens_generated"] == 13
        assert "tpu_serve_requests_total" in _get(url, "/metrics")
        spans = [e for e in _get(url, "/debug/traces")["traceEvents"]
                 if e["name"] == "prefill.ship"]
        assert any(e["args"].get("request_id") == "rq-1" for e in spans)
        server.begin_drain()
        status, out = _post(url, "/prefill", {"tokens": prompt.tolist()})
        assert status == 503 and out["code"] == "draining"
        assert _get(url, "/healthz")["draining"] is True
    finally:
        server.stop()


def test_prefill_worker_counts_and_validates(trees):
    pw = port_worker(trees, prefill_chunk=4)
    with pytest.raises(ValueError, match="max_seq_len"):
        pw.prefill(prompt_of(65, 1))
    with pytest.raises(ValueError):
        disagg.PrefillWorker(configs("f32")[1], trees["f32"][1],
                             kv_block=24, device="cpu")
    pw.prefill(prompt_of(9, 2))
    assert (pw.requests_done, pw.tokens_prefilled, pw.queue_depth,
            pw.active_slots) == (1, 9, 0, 0)
