"""LM serving over HTTP on the port's continuous-batching engine.

    python -m tf_operator_tpu_torch.serve.serve_lm [--device cpu] [flags]

The continuous path of ``examples/serve_lm.py``, under the same flag
names and defaults where a flag applies: one process quick-trains the
+1-chain task (``--train-steps``, 0 serves the seeded init) or takes the
weights it is given (``build_front``), and serves them through
``ContinuousEngine`` (paged KV, prefix sharing, chunked prefill, greedy
and sampled lanes), the scheduler and the supervisor of this package:

    GET  /healthz        liveness + readiness (``readiness_payload``):
                         ``draining: true`` during the SIGTERM drain,
                         ``dead: true`` once the restart budget is spent,
                         slot occupancy, queue depth, TTFT/ITL p99, the
                         replica id — what the fleet router routes from
    POST /generate       {"tokens": [[...]], "num_steps": N,
                          "temperature": T?, "top_p": P?, "seed": S?,
                          "eos_id": E?, "deadline_s": D?, "stream": B?,
                          "timing": B?, "request_id": R?}
                         -> {"tokens": [[...]], "request_id": R,
                             "finish_reason": [...]} (generated tokens
                         only; multi-row prompts fan out into one slot
                         request a row, row i seeded seed + i)
    GET  /debug/serve    the supervisor's snapshot (scheduler snapshot +
                         its ``resilience`` section)
    GET  /debug/traces   the data-plane trace ring as Chrome-trace JSON
    GET  /metrics        the ``tpu_serve_*`` families

``temperature`` 0 or absent is greedy; ``top_p`` without a temperature is
a 400. ``"stream": true`` runs a greedy request solo through
``generate_segments`` and answers NDJSON, one line a segment, sharing the
device with the serving loop through one lock. Every error leaves typed
(``code``, ``retryable``, ``detail``, Retry-After where it applies). On
SIGTERM the server drains: admitted requests finish (within
``--drain-timeout``), queued ones get a typed 503, the process exits 0.

The engine is built and warmed (``ContinuousEngine.warmup``: on the card
the kernels are built or loaded and run once) in the supervisor's engine
factory, before /healthz answers; a watchdog rebuild reuses the loaded
kernels and the same weights, so a replayed greedy request gives the
tokens of an uninterrupted run.

Flags and fields of ROADMAP items the port has not ported exit (flags)
or answer a typed 400 (fields) naming the item, and never run another
path instead: ``--tp``/``--dp`` (A8), ``--spec-k`` and ``--logprobs-k``
(A6), ``--kv-dense`` (the dense slot engine, A5), ``--engine coalesce``
and ``--batch-window`` (A10), ``--checkpoint-dir`` (A10), ``--role
prefill`` and ``--host-tier-bytes`` (A7); the fields ``json_schema``,
``regex``, ``choices``, ``stop``, ``logprobs`` and ``n`` > 1 (A6),
``shipped_kv``, ``session`` and ``GET /prefix/<digest>`` (A7).

``--device`` defaults to ``cuda``: without a card the server raises
rather than serving on the CPU, which it does only under ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.models.convert import (
    export_params,
    init_params,
    load_params,
    quantize_decode_params,
)
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _decode_model,
    generate_segments,
)
from tf_operator_tpu_torch.runtime.tracing import (
    SERVE_TRACER,
    mint_request_id,
)
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.faultinject import FaultInjector
from tf_operator_tpu_torch.serve.httpapi import (
    QuietHandler,
    readiness_payload,
)
from tf_operator_tpu_torch.serve.resilience import (
    EngineSupervisor,
    NotPorted,
    ResilienceConfig,
    ServeError,
    error_payload,
    http_status_of,
    set_replica_id,
)
from tf_operator_tpu_torch.serve.scheduler import ServeRequest

# Flags of ROADMAP items the port has not ported: (flag, set?, item).
UNPORTED_FLAGS = (
    ("--tp", lambda a: a.tp > 1, "A8 (multi-device)"),
    ("--dp", lambda a: a.dp > 1, "A8 (multi-device)"),
    ("--spec-k", lambda a: a.spec_k > 0, "A6 (speculative decoding)"),
    ("--logprobs-k", lambda a: a.logprobs_k > 0, "A6 (logprobs)"),
    ("--kv-dense", lambda a: not a.kv_paged,
     "A5 (the dense slot engine)"),
    ("--engine coalesce", lambda a: a.engine == "coalesce",
     "A10 (serve/coalesce.py)"),
    ("--batch-window", lambda a: a.batch_window > 0,
     "A10 (serve/coalesce.py)"),
    ("--checkpoint-dir", lambda a: a.checkpoint_dir is not None,
     "A10 (checkpoints)"),
    ("--role prefill", lambda a: a.role == "prefill",
     "A7 (disaggregated prefill)"),
    ("--host-tier-bytes", lambda a: a.host_tier_bytes > 0,
     "A7 (the host KV tier)"),
)
# /generate fields of ROADMAP item A6 (constrained and structured
# decoding). The scheduler refuses json_schema/regex/choices/stop/
# logprobs with a typed 400; ``n`` fans out here, so it is refused here.
STRUCTURED_FIELDS = ("json_schema", "regex", "choices", "stop")


def build_parser() -> argparse.ArgumentParser:
    """``examples/serve_lm.py``'s flags that the continuous path reads,
    under the same names and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(
        description="LM serving over HTTP on the PyTorch port's "
                    "continuous-batching engine")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("TPU_SERVE_PORT") or 0),
                   help="listen port (default $TPU_SERVE_PORT, else an "
                        "ephemeral port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--replica-id",
                   default=os.environ.get("TPU_SERVE_REPLICA_ID", ""),
                   help="fleet replica identity, stamped on /healthz and "
                        "every typed error payload")
    p.add_argument("--role", choices=("decode", "prefill"),
                   default=os.environ.get("TPU_SERVE_ROLE") or "decode",
                   help="'prefill' waits for ROADMAP A7")
    p.add_argument("--device", default="cuda",
                   help="torch device; the server raises when it is CUDA "
                        "and torch sees no card (pass 'cpu' for the plain "
                        "PyTorch path)")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query attention: K/V heads (must divide "
                        "the 4 query heads)")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--max-seq-len", type=int, default=128)
    p.add_argument("--checkpoint-dir", default=None,
                   help="waits for ROADMAP A10")
    p.add_argument("--train-steps", type=int, default=150,
                   help="quick-train steps of the +1-chain task from the "
                        "seeded init (0 serves the init)")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--tp", type=int, default=1, help="waits for A8")
    p.add_argument("--dp", type=int, default=1, help="waits for A8")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decode (kernel B5)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV pools with f32 scale pools (kv8 B4)")
    p.add_argument("--requests", type=int, default=None,
                   help="exit 0 after serving this many /generate calls")
    p.add_argument("--spec-k", type=int, default=0, help="waits for A6")
    p.add_argument("--logprobs-k", type=int, default=0,
                   help="waits for A6")
    p.add_argument("--stream-segment", type=int, default=16, metavar="N",
                   help='segment size of "stream": true responses')
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                   help="prefill in fixed N-token chunks (0: one-shot)")
    p.add_argument("--batch-window", type=float, default=0.0,
                   metavar="MS", help="waits for A10")
    p.add_argument("--max-batch", type=int, default=8,
                   help="decode slots of the continuous engine")
    p.add_argument("--engine", choices=("continuous", "coalesce"),
                   default="continuous",
                   help="'coalesce' waits for A10")
    p.add_argument("--prefill-budget", type=int, default=256,
                   metavar="TOKENS",
                   help="max prompt tokens prefilled per serving-loop "
                        "iteration while slots are decoding")
    p.add_argument("--kv-paged", dest="kv_paged", action="store_true",
                   default=True, help="block-paged KV cache (the default)")
    p.add_argument("--kv-dense", dest="kv_paged", action="store_false",
                   help="waits for A5")
    p.add_argument("--kv-block", type=int, default=64, metavar="TOKENS",
                   help="paged KV block size (--max-seq-len must divide "
                        "evenly)")
    p.add_argument("--kv-attend", choices=("gather", "pallas", "kernel"),
                   default="gather",
                   help="paged decode read: 'gather' (plain PyTorch) or "
                        "'kernel' (the CUDA kernel B4 on the card, its "
                        "plain version on the CPU); 'pallas' is the JAX "
                        "server's name for the kernel")
    p.add_argument("--kv-pool-blocks", type=int, default=None, metavar="N",
                   help="paged KV pool size in blocks, incl. the pinned "
                        "garbage block (default: max-batch x "
                        "max-seq-len/kv-block + 1)")
    p.add_argument("--host-tier-bytes", type=int, default=0,
                   help="waits for A7")
    res = p.add_argument_group("resilience (0 disables a knob)")
    res.add_argument("--queue-ttl", type=float, default=30.0, metavar="S")
    res.add_argument("--decode-deadline", type=float, default=120.0,
                     metavar="S")
    res.add_argument("--watchdog-stall", type=float, default=10.0,
                     metavar="S")
    res.add_argument("--max-restarts", type=int, default=3)
    res.add_argument("--restart-backoff", type=float, default=0.25,
                     metavar="S")
    res.add_argument("--queue-limit", type=int, default=None, metavar="N",
                     help="default 8x --max-batch")
    res.add_argument("--degraded-blocks", type=float, default=0.1,
                     metavar="FRAC")
    res.add_argument("--degraded-max-tokens", type=int, default=32,
                     metavar="N")
    res.add_argument("--drain-timeout", type=float, default=30.0,
                     metavar="S")
    res.add_argument("--faults", default=None, metavar="SPEC",
                     help="arm seeded fault-injection points, e.g. "
                          "'step_raise@40' (serve/faultinject.py); "
                          "default: the TPU_SERVE_FAULTS env var")
    res.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--trace-capacity", type=int, default=8192,
                   metavar="SPANS",
                   help="span ring behind /debug/traces (0 disables "
                        "tracing)")
    return p


def front_args(**overrides) -> argparse.Namespace:
    """The parser's defaults with ``overrides`` (underscored names): the
    ``args`` that ``build_front`` takes from an in-process caller."""
    args = build_parser().parse_args([])
    for key, value in overrides.items():
        if not hasattr(args, key):
            raise TypeError(f"serve_lm has no flag for {key!r}")
        setattr(args, key, value)
    return args


def unported_flags(args) -> list[str]:
    """The set flags whose ROADMAP item is not ported, each with it."""
    return [f"{flag} waits for ROADMAP {item}"
            for flag, is_set, item in UNPORTED_FLAGS if is_set(args)]


def quick_train(cfg: TransformerConfig, steps: int, lr: float,
                device=None) -> dict:
    """Train the +1-mod-vocab chain task just enough to serve verifiable
    completions, as the JAX server does, with the port's
    ``make_lm_train_step`` and ``adamw`` from ``init_params(cfg, 0)``.
    Returns the flax-layout tree (numpy)."""
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_train_step,
    )

    tcfg = replace(cfg, decode=False, int8_decode=False, kv_int8=False)
    params = init_params(tcfg, 0)
    if steps <= 0:
        return params
    model = load_params(Transformer(tcfg, device), params)
    rng = np.random.default_rng(0)
    start = rng.integers(0, cfg.vocab_size, (8, 1))
    # Chain of seq+1 then slice: rolling the tokens would mislabel the
    # last position whenever seq % vocab != 0.
    seq = min(32, cfg.max_seq_len)
    chain = (start + np.arange(seq + 1)) % cfg.vocab_size
    batch = {"tokens": chain[:, :-1].astype(np.int64),
             "targets": chain[:, 1:].astype(np.int64)}
    tx = adamw(lr)
    state = TrainState.create(model, tx)
    step = make_lm_train_step(model, tx)
    loss = float("nan")
    for _ in range(steps):
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
    print(f"serve_lm: quick-trained {steps} steps, loss {loss:.3f}",
          flush=True)
    return export_params(model)


def _to_device(tree, device) -> dict:
    """The tree's leaves as tensors on ``device`` in their own dtypes, so
    every engine generation copies its weights device to device."""
    return {k: _to_device(v, device) if isinstance(v, dict)
            else (v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.array(v))).to(device)
            for k, v in tree.items()}


class FrontServer(ThreadingHTTPServer):
    """The HTTP server with the front's state: the supervisor, the device
    lock the serving loop and the streaming path share, the drain event
    (set on SIGTERM or after ``--requests``), and the served count."""

    daemon_threads = True

    def __init__(self, address, supervisor: EngineSupervisor, *, cfg,
                 params, args, device, lock: threading.Lock) -> None:
        super().__init__(address, _Handler)
        self.supervisor = supervisor
        self.cfg = cfg
        self.params = params
        self.args = args
        self.device = device
        self.lock = lock
        self.done = threading.Event()
        self.served = 0
        self._served_lock = threading.Lock()
        self._stream_model = None

    @property
    def endpoint(self) -> str:
        host, port = self.server_address[:2]
        return f"{host}:{port}"

    def note_served(self) -> None:
        with self._served_lock:
            self.served += 1
            if (self.args.requests is not None
                    and self.served >= self.args.requests):
                self.done.set()

    def stream_model(self) -> Transformer:
        """The decode-mode model the streaming path runs, loaded once;
        call under ``lock``."""
        if self._stream_model is None:
            self._stream_model = _decode_model(self.cfg, self.params,
                                               self.device)
        return self._stream_model

    def start(self) -> "FrontServer":
        threading.Thread(target=self.serve_forever, daemon=True,
                         name="serve-http").start()
        return self

    def drain(self, timeout: float | None = None) -> None:
        """The SIGTERM drain: readiness withdrawn (/healthz keeps
        answering with ``draining: true``), admitted requests finish,
        queued ones get the typed 503; then the listener stops."""
        self.done.set()
        drain = self.args.drain_timeout or 0
        self.supervisor.stop(timeout=timeout or max(60.0, drain + 30.0))
        time.sleep(0.2)  # let unblocked handlers write their responses
        self.shutdown()
        self.server_close()


class _Handler(QuietHandler):
    server: FrontServer

    def do_GET(self) -> None:
        srv = self.server
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            payload = readiness_payload(
                srv.supervisor, draining=srv.done.is_set(),
                replica=srv.args.replica_id, max_slots=srv.args.max_batch,
            )
            payload["served"] = srv.served
            payload["engine"] = "continuous"
            self.send_json(200, payload)
        elif path == "/debug/serve":
            self.send_json(200, srv.supervisor.debug_snapshot())
        elif path == "/debug/traces":
            self.send_serve_traces()
        elif path == "/metrics":
            self.send_metrics()
        elif path.startswith("/prefix/"):
            exc = NotPorted("prefix export (GET /prefix/<digest>) waits "
                            "for ROADMAP A7 in the PyTorch port")
            self.send_json(http_status_of(exc), error_payload(exc))
        else:
            self.send_json(404, {"error": "unknown path"})

    def do_POST(self) -> None:
        if self.path.split("?", 1)[0] != "/generate":
            self.send_json(404, {"error": "unknown path"})
            return
        try:
            body = self.read_json_body()
            if self._generate(body):
                self.server.note_served()
        except Exception as exc:  # noqa: BLE001 — client-visible error
            if isinstance(exc, ServeError):
                self.send_json(exc.http_status, error_payload(exc))
            elif isinstance(exc, TimeoutError):
                # The server ran out of time, not the request out of
                # validity: retryable 503, never a bad_request.
                self.send_json(503, {
                    "error": repr(exc), "code": "timeout",
                    "retryable": True, "detail": repr(exc),
                })
            else:
                self.send_json(400, error_payload(exc) | {
                    "code": "bad_request", "error": repr(exc),
                })

    def _generate(self, body: dict) -> bool:
        """Answer one /generate body; True once a response went out."""
        srv = self.server
        prompt = np.asarray(body["tokens"], np.int32)
        if prompt.ndim != 2:
            raise ValueError("tokens must be [batch, len]")
        num_steps = int(body.get("num_steps", 8))
        temperature = float(body.get("temperature", 0.0))
        top_p = body.get("top_p")
        if int(body.get("n", 1)) != 1:
            raise NotPorted("n-best candidates (n > 1) wait for ROADMAP A6 "
                            "in the PyTorch port")
        if body.get("shipped_kv") is not None:
            raise NotPorted("shipped KV (disaggregated prefill) waits for "
                            "ROADMAP A7 in the PyTorch port")
        if body.get("stream"):
            self._stream(body, prompt, num_steps, temperature, top_p)
            return True
        constrain = {k: body[k] for k in ("json_schema", "regex", "choices")
                     if body.get(k) is not None} or None
        eos_id = body.get("eos_id")
        deadline_s = body.get("deadline_s")
        rid = (body.get("request_id") or self.headers.get("X-Request-Id")
               or mint_request_id())

        def row(i):
            return srv.supervisor.submit_request(ServeRequest(
                prompt[i:i + 1], num_steps, temperature=temperature,
                top_p=None if top_p is None else float(top_p),
                seed=int(body.get("seed", 0)) + i,
                eos_id=None if eos_id is None else int(eos_id),
                deadline_s=None if deadline_s is None else float(deadline_s),
                request_id=rid if i == 0 else f"{rid}.{i}",
                session=body.get("session"), constrain=constrain,
                stop=body.get("stop"), logprobs=bool(body.get("logprobs")),
            ))

        if prompt.shape[0] == 1:
            rows = [row(0)]
        else:
            # Rows decode concurrently, at most one thread a slot.
            with ThreadPoolExecutor(
                    min(prompt.shape[0], srv.args.max_batch)) as ex:
                rows = list(ex.map(row, range(prompt.shape[0])))
        payload = {"tokens": [list(r.out) for r in rows], "request_id": rid}
        if any(r.finish_reason for r in rows):
            payload["finish_reason"] = [r.finish_reason for r in rows]
        if body.get("timing"):
            payload["timing"] = [r.timing() for r in rows]
        if any(r.deadline_exceeded for r in rows):
            payload["deadline_exceeded"] = [r.deadline_exceeded
                                            for r in rows]
            payload["timeout_cause"] = [r.timeout_cause for r in rows]
        if any(r.degraded for r in rows):
            payload["degraded"] = [r.degraded for r in rows]
        self.send_json(200, payload)
        return True

    def _stream(self, body, prompt, num_steps, temperature, top_p) -> None:
        """Streamed greedy decode: NDJSON, one line a segment, solo
        through ``generate_segments``; the device lock covers only the
        device work of each segment."""
        srv = self.server
        if (any(body.get(k) is not None for k in STRUCTURED_FIELDS)
                or body.get("logprobs")):
            raise ValueError("stream does not compose with json_schema/"
                             "regex/choices/stop/logprobs/n")
        if temperature > 0 or top_p is not None:
            raise ValueError("stream supports greedy only (no "
                             "temperature/top_p)")
        with srv.lock:
            model = srv.stream_model()
        # generate_segments validates eagerly, before any device work, so
        # every budget error is still a 400 here.
        gen = generate_segments(
            srv.cfg, model, prompt, num_steps,
            segment=max(1, srv.args.stream_segment),
            prefill_chunk=srv.args.prefill_chunk or None,
        )
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            while True:
                with srv.lock:
                    try:
                        toks = next(gen)
                    except StopIteration:
                        break
                line = json.dumps({"tokens": toks.tolist()}) + "\n"
                self.wfile.write(line.encode())
                self.wfile.flush()
        except Exception as exc:  # noqa: BLE001 — headers are out
            print(f"serve_lm: stream aborted: {exc!r}", file=sys.stderr,
                  flush=True)


def check_args(args) -> None:
    """Refuse what the front cannot serve, before any device work: a flag
    whose ROADMAP item is not ported (NotPorted), a prefill budget below
    one token or a sequence length off the block grid (ValueError)."""
    refused = unported_flags(args)
    if refused:
        raise NotPorted("; ".join(refused))
    if args.prefill_budget < 1:
        raise ValueError("--prefill-budget must be >= 1")
    if args.max_seq_len % args.kv_block:
        raise ValueError(f"--max-seq-len {args.max_seq_len} must be a "
                         f"multiple of --kv-block {args.kv_block}")


def build_front(cfg: TransformerConfig, params, args
                ) -> tuple[EngineSupervisor, FrontServer]:
    """The serving front over ``params`` (a flax-layout tree; an
    ``int8_decode`` config takes a ``quantize_decode_params`` tree): the
    supervisor, with its first engine built and warmed, and the HTTP
    server bound to ``args.host``:``args.port``, not yet serving (call
    ``start()``). ``args`` is ``front_args(...)`` or the parsed flags.
    Raises on a CUDA device when torch sees no card, and where
    ``check_args`` refuses ``args``."""
    device = resolve_device(args.device)
    check_args(args)
    if cfg.max_seq_len % args.kv_block:
        raise ValueError(f"max_seq_len {cfg.max_seq_len} must be a "
                         f"multiple of --kv-block {args.kv_block}")
    faults = (FaultInjector(args.faults, seed=args.fault_seed)
              if args.faults is not None else FaultInjector.from_env())
    if args.replica_id:
        set_replica_id(args.replica_id)
    if args.trace_capacity != SERVE_TRACER.capacity:
        SERVE_TRACER.set_capacity(args.trace_capacity)
    res_cfg = ResilienceConfig(
        queue_ttl_s=args.queue_ttl or None,
        decode_deadline_s=args.decode_deadline or None,
        watchdog_stall_s=args.watchdog_stall or None,
        max_restarts=args.max_restarts,
        restart_backoff_s=args.restart_backoff,
        queue_limit=(args.queue_limit if args.queue_limit is not None
                     else 8 * args.max_batch) or None,
        degraded_free_block_frac=args.degraded_blocks or 0.0,
        degraded_max_tokens=args.degraded_max_tokens,
        drain_timeout_s=args.drain_timeout or None,
    )
    params = _to_device(params, device)
    attend = "kernel" if args.kv_attend == "pallas" else args.kv_attend

    def engine_factory() -> ContinuousEngine:
        # The watchdog rebuilds through here: the SAME cfg and weights
        # every time (replay bit-identity depends on it), a fresh pool,
        # and a warm step before the engine takes a request.
        eng = ContinuousEngine(
            cfg, params, args.max_batch, kv_block=args.kv_block,
            kv_blocks=args.kv_pool_blocks, kv_attend=attend,
            prefill_chunk=args.prefill_chunk or None, faults=faults,
            device=device,
        )
        eng.warmup()
        return eng

    lock = threading.Lock()
    supervisor = EngineSupervisor(
        engine_factory, resilience=res_cfg, faults=faults,
        prefill_tokens_per_step=args.prefill_budget,
        # Streaming requests bypass the engine and share the device: one
        # lock serializes both decode paths.
        device_lock=lock,
    )
    server = FrontServer((args.host, args.port), supervisor, cfg=cfg,
                         params=params, args=args, device=device, lock=lock)
    return supervisor, server


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.requests is not None and args.requests < 1:
        p.error("--requests must be >= 1 (omit it to serve until SIGTERM)")
    try:
        check_args(args)
    except (NotPorted, ValueError) as exc:
        p.error(str(exc))
    device = resolve_device(args.device)
    # The JAX server's model: 4 heads, d_ff = 2 d, f32.
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=4,
        n_kv_heads=args.kv_heads, n_layers=args.layers,
        d_ff=args.d_model * 2, max_seq_len=args.max_seq_len,
        dtype=torch.float32, int8_decode=args.int8, kv_int8=args.kv_int8,
    )
    params = quick_train(cfg, args.train_steps, args.lr, device)
    if args.int8:
        params = quantize_decode_params(params)
        print("serve_lm: projections quantized to int8", flush=True)
    supervisor, server = build_front(cfg, params, args)
    print(f"serve_lm: continuous batching on {device} (slots "
          f"{args.max_batch}, paged kv ({args.kv_block}-token blocks, "
          f"{supervisor.engine.kv_blocks} block pool), kv_attend "
          f"{supervisor.engine.kv_attend}, prefill chunk "
          f"{args.prefill_chunk or 'one-shot'}, prefill budget "
          f"{args.prefill_budget} tok/iter)", flush=True)
    server.start()
    print(f"serve_lm: listening on {server.endpoint}", flush=True)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: server.done.set())
    server.done.wait()
    server.drain()
    print(f"serve_lm: engine drained ({supervisor.requests_done} "
          f"request(s), {supervisor.tokens_generated} token(s))",
          flush=True)
    print(f"serve_lm: done ({server.served} request(s) served)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
