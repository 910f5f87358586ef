"""Fleet-global prefix reuse in the port, engine and server side:
retention past a slot's retirement, the ``GET /prefix/<digest>`` export,
the cross-replica pull's ingest, and kv8 pools. On the CPU, in f32 with
the JAX init's weights; tests/test_serve_prefix_pull.py's pins, each leg
equal to JAX's solo ``generate`` (greedy and sampled) with the decode
step's compile count unmoved:

- retention: a completed request's exact entry survives its slot
  (advertised, exportable, exact-joinable); with retention off every
  block returns at retire;
- an exact re-join skips the whole prompt's prefill;
- export, a JSON round trip, ``decode_shipment``, and the ingest of a
  replica that never saw the prompt; the port's export ingested by JAX's
  engine and JAX's export by the port's, each giving the solo tokens;
- an unknown digest is the typed ``prefix_not_found``; /healthz carries
  the digests MRU first under the cap; retained holds give way to an
  admission under pool pressure;
- kv8 pools ship and export their scales;
- over HTTP: one front's ``GET /prefix/<digest>`` payload passed to
  another front as ``shipped_kv`` gives the first front's response.

No assertion reads the wall clock."""

import json
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
from tf_operator_tpu.serve.scheduler import (
    ContinuousScheduler as JaxScheduler,
    ServeRequest as JaxRequest,
)
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.serve import disagg, serve_lm
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.httpapi import readiness_payload
from tf_operator_tpu_torch.serve.resilience import PrefixNotFound
from tf_operator_tpu_torch.serve.scheduler import (
    ContinuousScheduler,
    ServeRequest,
)

torch.set_num_threads(1)

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
          max_seq_len=64)
BLOCK = 8
JCFG = JaxConfig(dtype=jnp.float32, **KW)
TCFG = TransformerConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def params():
    return JaxTransformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def prompt_of(p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, p)).astype(np.int32)


def solo(params, prompt, steps, *, cfg=JCFG, temperature=0.0, seed=0):
    kw = {}
    if temperature > 0:
        kw = dict(temperature=temperature, rng=jax.random.PRNGKey(seed))
    return np.asarray(jax_generate(cfg, params, jnp.asarray(prompt), steps,
                                   **kw))[0].tolist()


def mk_sched(params, *, cfg=TCFG, retain=32, max_slots=2, **kw):
    """A port engine with retention on (serve_lm's fleet wiring) under a
    started scheduler."""
    eng = ContinuousEngine(cfg, jax.tree.map(np.asarray, params), max_slots,
                           kv_block=BLOCK, device="cpu", **kw)
    eng.prefix_retain_max = retain
    eng.prefix_advertise_max = 32
    return ContinuousScheduler(eng).start()


def exact_digest(prompt) -> str:
    return disagg.chain_digests(np.asarray(prompt[0], np.int32), BLOCK)[-1]


def wire(payload: dict) -> dict:
    return json.loads(json.dumps(payload))


@pytest.fixture(scope="module")
def home(params):
    """The retaining holder: serves first turns, advertises and exports."""
    sched = mk_sched(params)
    yield sched
    sched.stop(timeout=60)


@pytest.fixture(scope="module")
def target(params):
    """The pulling replica: ingests exports of prompts it never saw."""
    sched = mk_sched(params)
    yield sched
    sched.stop(timeout=60)


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------


def test_retained_entry_survives_completion(params, home):
    prompt = prompt_of(11, 50)
    req = home.submit_request(ServeRequest(prompt, 6), timeout=300)
    assert req.out == solo(params, prompt, 6)
    assert exact_digest(prompt) in home.advertised_prefixes()
    kv = home.debug_snapshot()["kv_cache"]
    assert kv["prefix_retained"] >= 1 and kv["prefix_entries"] >= 1


def test_retention_off_frees_everything_on_retire(params):
    """prefix_retain_max 0 (the engine's default): every block back in
    the pool, and the digest neither advertised nor exportable."""
    prompt = prompt_of(11, 51)
    sched = mk_sched(params, retain=0)
    try:
        sched.submit_request(ServeRequest(prompt, 6), timeout=300)
        assert sched.engine.blocks.used == 0
        assert sched.advertised_prefixes() == []
        with pytest.raises(PrefixNotFound):
            sched.export_prefix(exact_digest(prompt))
    finally:
        sched.stop(timeout=60)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 11)],
                         ids=["greedy", "sampled"])
def test_exact_rejoin_bit_identical(params, home, temperature, seed):
    """The second identical prompt joins by the exact prefix: the whole
    prompt's prefill skipped, the tokens unchanged."""
    prompt = prompt_of(13, 52 if temperature == 0 else 58)
    steps = 8
    oracle = solo(params, prompt, steps, temperature=temperature, seed=seed)
    r1 = home.submit_request(ServeRequest(
        prompt, steps, temperature=temperature, seed=seed), timeout=300)
    saved0 = home.debug_snapshot()["kv_cache"]["prefill_tokens_saved"]
    r2 = home.submit_request(ServeRequest(
        prompt, steps, temperature=temperature, seed=seed), timeout=300)
    snap = home.debug_snapshot()
    assert r1.out == r2.out == oracle
    assert (snap["kv_cache"]["prefill_tokens_saved"] - saved0
            == prompt.shape[1]), "the re-join did not skip prefill"
    assert snap["decode_step_compiles"] == snap["warmup_compiles"]


# ---------------------------------------------------------------------------
# export -> pull -> ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 7)],
                         ids=["greedy", "sampled"])
def test_export_pull_ingest_bit_identical(params, home, target,
                                          temperature, seed):
    prompt = prompt_of(13, 53 if temperature == 0 else 59)
    steps = 8
    oracle = solo(params, prompt, steps, temperature=temperature, seed=seed)
    exports0 = home.debug_snapshot()["kv_cache"]["prefix_exports"]
    r1 = home.submit_request(ServeRequest(
        prompt, steps, temperature=temperature, seed=seed), timeout=300)
    assert r1.out == oracle
    payload = wire(home.export_prefix(exact_digest(prompt)))
    assert home.debug_snapshot()["kv_cache"]["prefix_exports"] == (
        exports0 + 1)
    shp = disagg.decode_shipment(payload, expect_tokens=prompt[0])
    ingested0 = target.debug_snapshot()["kv_cache"]["shipments_ingested"]
    r2 = target.submit_request(ServeRequest(
        prompt, steps, temperature=temperature, seed=seed, shipment=shp),
        timeout=300)
    snap = target.debug_snapshot()
    assert r2.shipped_join, "the pulled request prefilled locally"
    assert r2.out == oracle
    assert snap["decode_step_compiles"] == snap["warmup_compiles"]
    assert snap["kv_cache"]["shipments_ingested"] == ingested0 + 1


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pulls_cross_frameworks(params, direction):
    """A prefix exported by one package's engine, ingested by the other's,
    decodes JAX's solo tokens."""
    prompt = prompt_of(13, 60 if direction == "port_to_jax" else 61)
    steps = 8
    oracle = solo(params, prompt, steps)
    port = mk_sched(params)
    jeng = JaxEngine(JCFG, params, max_slots=2, kv_block=BLOCK)
    jeng.prefix_retain_max = 32
    jax_sched = JaxScheduler(jeng).start()
    try:
        holder, puller = ((port, jax_sched) if direction == "port_to_jax"
                          else (jax_sched, port))
        request = ServeRequest if holder is port else JaxRequest
        holder.submit_request(request(prompt, steps), timeout=300)
        payload = wire(holder.export_prefix(exact_digest(prompt)))
        if puller is port:
            shp, request = disagg.decode_shipment(payload), ServeRequest
        else:
            shp, request = jd.decode_shipment(payload), JaxRequest
        got = puller.submit_request(request(prompt, steps, shipment=shp),
                                    timeout=300)
        assert got.shipped_join and got.out == oracle
    finally:
        port.stop(timeout=60)
        jax_sched.stop(timeout=60)


def test_export_unknown_digest_is_typed(home):
    with pytest.raises(PrefixNotFound) as exc:
        home.export_prefix("ab" * 20)
    assert exc.value.code == "prefix_not_found"
    with pytest.raises(PrefixNotFound):
        home.export_prefix("not-hex")


class _ProbeShape:
    """The supervisor-shaped object readiness_payload reads."""

    active_slots = 0
    queue_depth = 0
    requests_done = 0
    tokens_generated = 0

    def __init__(self, sched):
        self._sched = sched

    def advertised_prefixes(self):
        return self._sched.advertised_prefixes()


def test_readiness_payload_advertises_and_caps(params, home):
    """/healthz carries the hot digests, MRU first, capped by
    prefix_advertise_max; cap 0 omits the field."""
    duck = _ProbeShape(home)
    a, b = prompt_of(11, 54), prompt_of(13, 55)
    home.submit_request(ServeRequest(a, 4), timeout=300)
    home.submit_request(ServeRequest(b, 4), timeout=300)
    try:
        prefixes = readiness_payload(duck)["prefixes"]
        assert prefixes.index(exact_digest(b)) < prefixes.index(
            exact_digest(a))
        home.engine.prefix_advertise_max = 1
        assert len(home.advertised_prefixes()) == 1
        home.engine.prefix_advertise_max = 0
        assert home.advertised_prefixes() == []
        assert "prefixes" not in readiness_payload(duck)
    finally:
        home.engine.prefix_advertise_max = 32


def test_retained_holds_reclaim_under_pool_pressure(params):
    """A pool full of retained holds gives them back to the next admission
    instead of queueing it."""
    # 7 allocatable blocks: an 11-token / 4-step request wants 2 live and
    # retains 2.
    sched = mk_sched(params, kv_blocks=8, max_slots=1)
    try:
        for seed in (60, 61, 62, 63):
            prompt = prompt_of(11, seed)
            req = sched.submit_request(ServeRequest(prompt, 4), timeout=300)
            assert req.out == solo(params, prompt, 4)
        kv = sched.debug_snapshot()["kv_cache"]
        assert 1 <= kv["prefix_retained"] <= 3
    finally:
        sched.stop(timeout=60)


# ---------------------------------------------------------------------------
# kv8 pools
# ---------------------------------------------------------------------------


class TestKv8Shipping:
    """kv8 pools ship their f32 scales, from a PrefillWorker and from a
    retained entry's export, and the shipped decode equals the same
    config's solo decode."""

    @pytest.fixture(scope="class")
    def cfgs(self):
        from dataclasses import replace
        return replace(JCFG, kv_int8=True), replace(TCFG, kv_int8=True)

    @pytest.fixture(scope="class")
    def p8(self, cfgs):
        return JaxTransformer(cfgs[0]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]

    @pytest.fixture(scope="class")
    def target8(self, cfgs, p8):
        sched = mk_sched(p8, cfg=cfgs[1])
        yield sched
        sched.stop(timeout=60)

    @pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 5)],
                             ids=["greedy", "sampled"])
    def test_prefill_worker_ship_bit_identical(self, cfgs, p8, target8,
                                               temperature, seed):
        prompt = prompt_of(13, 56 if temperature == 0 else 66)
        oracle = solo(p8, prompt, 8, cfg=cfgs[0], temperature=temperature,
                      seed=seed)
        pw = disagg.PrefillWorker(cfgs[1], jax.tree.map(np.asarray, p8),
                                  kv_block=BLOCK, device="cpu")
        payload = wire(pw.prefill(prompt))
        parts = set().union(*(set(kv) for kv in payload["rows"].values()))
        assert {"key_scale", "value_scale"} <= parts
        req = target8.submit_request(ServeRequest(
            prompt, 8, temperature=temperature, seed=seed,
            shipment=disagg.decode_shipment(payload,
                                            expect_tokens=prompt[0])),
            timeout=300)
        snap = target8.debug_snapshot()
        assert req.shipped_join and req.out == oracle
        assert snap["decode_step_compiles"] == snap["warmup_compiles"]

    def test_export_carries_scales_and_round_trips(self, cfgs, p8, target8):
        prompt = prompt_of(11, 57)
        oracle = solo(p8, prompt, 6, cfg=cfgs[0])
        assert target8.submit_request(ServeRequest(prompt, 6),
                                      timeout=300).out == oracle
        payload = wire(target8.export_prefix(exact_digest(prompt)))
        parts = set().union(*(set(kv) for kv in payload["rows"].values()))
        assert {"key_scale", "value_scale"} <= parts
        cold = mk_sched(p8, cfg=cfgs[1])
        try:
            r2 = cold.submit_request(ServeRequest(
                prompt, 6, shipment=disagg.decode_shipment(
                    payload, expect_tokens=prompt[0])), timeout=300)
            assert r2.shipped_join and r2.out == oracle
        finally:
            cold.stop(timeout=60)


# ---------------------------------------------------------------------------
# over HTTP: a pull between two fronts
# ---------------------------------------------------------------------------


def _call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_pull_between_two_fronts(params):
    """Front 1 serves a prompt and advertises its digest on /healthz; its
    ``GET /prefix/<digest>`` payload, passed to front 2 as ``shipped_kv``,
    gives front 1's tokens without a prefill on front 2; a tampered
    payload is the typed ``ship_failed``, an unknown digest the typed
    ``prefix_not_found``."""
    fronts = []
    try:
        for rid in ("d1", "d2"):
            args = serve_lm.front_args(
                device="cpu", max_batch=2, kv_block=BLOCK,
                max_seq_len=KW["max_seq_len"], replica_id=rid)
            sup, server = serve_lm.build_front(
                TCFG, jax.tree.map(np.asarray, params), args)
            server.start()
            fronts.append((sup, "http://" + server.endpoint, server))
        (_, url1, _), (sup2, url2, _) = fronts
        prompt = prompt_of(13, 62)
        body = {"tokens": prompt.tolist(), "num_steps": 8, "timing": True}
        status, first = _call(url1, "/generate", body)
        assert status == 200 and first["tokens"][0] == solo(params, prompt, 8)
        status, health = _call(url1, "/healthz")
        digest = exact_digest(prompt)
        assert digest in health["prefixes"]
        status, pulled = _call(url1, f"/prefix/{digest}")
        assert status == 200 and pulled["replica"] == "d1"
        status, second = _call(url2, "/generate",
                               {**body, "shipped_kv": pulled["shipment"]})
        assert status == 200 and second["tokens"] == first["tokens"]
        assert second["timing"][0]["shipped_kv"] is True
        assert sup2.debug_snapshot()["kv_cache"]["shipments_ingested"] == 1
        bad = dict(pulled["shipment"], rows_sha1="0" * 40)
        status, out = _call(url2, "/generate", {**body, "shipped_kv": bad})
        assert status == 503 and out["code"] == "ship_failed"
        status, out = _call(url2, "/generate", {
            "tokens": [prompt[0].tolist()] * 2, "num_steps": 4,
            "shipped_kv": pulled["shipment"]})
        assert status == 503 and "single-row" in out["detail"]
        status, out = _call(url1, "/prefix/" + "cd" * 20)
        assert status == 404 and out["code"] == "prefix_not_found"
        assert out["replica"] == "d1"
    finally:
        for sup, _, server in fronts:
            server.drain()
