"""LM serving over HTTP on the port's engines.

    python -m tf_operator_tpu_torch.serve.serve_lm [--device cpu] [flags]

``examples/serve_lm.py`` over this package, under the same flag names and
defaults where a flag applies: one process restores a checkpoint of the
port's trainer (``--checkpoint-dir``, written by ``python -m
tf_operator_tpu_torch.train.dist_lm``; the shape flags must mirror the
trainer's), quick-trains the +1-chain task (``--train-steps``, 0 serves
the seeded init), or takes the weights it is given (``build_front``), and
serves them through ``ContinuousEngine`` (paged KV, or the dense slot
tensor under ``--kv-dense``; prefix sharing, chunked prefill, greedy and
sampled lanes), the scheduler and the supervisor of this package:

    GET  /healthz        liveness + readiness (``readiness_payload``):
                         ``draining: true`` during the SIGTERM drain,
                         ``dead: true`` once the restart budget is spent,
                         slot occupancy, queue depth, TTFT/ITL p99, the
                         replica id — what the fleet router routes from
    POST /generate       {"tokens": [[...]], "num_steps": N,
                          "temperature": T?, "top_p": P?, "seed": S?,
                          "eos_id": E?, "deadline_s": D?, "stream": B?,
                          "timing": B?, "request_id": R?,
                          "json_schema"|"regex"|"choices": ...?,
                          "stop": [...]?, "logprobs": B?, "n": K?,
                          "shipped_kv": {...}?, "session": S?}
                         -> {"tokens": [[...]], "request_id": R,
                             "finish_reason": [...], "logprobs": [...]?,
                             "choices": [...]?} (generated tokens only;
                         multi-row prompts fan out into one slot request
                         a row, row i seeded seed + i; ``n`` > 1 fans one
                         sampled prompt out into candidates at seed + j)
    GET  /prefix/<digest> a live prefix (or a host-tier entry) as the
                         shipped-KV wire payload: {"shipment": {...},
                         "replica": R}; a digest held nowhere answers the
                         typed 404 ``prefix_not_found``
    GET  /debug/serve    the supervisor's snapshot (scheduler snapshot +
                         its ``resilience`` section)
    GET  /debug/traces   the data-plane trace ring as Chrome-trace JSON
    GET  /metrics        the ``tpu_serve_*`` families

``temperature`` 0 or absent is greedy; ``top_p`` without a temperature is
a 400. Constrained and structured decoding as the JAX server has it: at
most one of ``json_schema``/``regex``/``choices`` (compiled at enqueue by
one process-lifetime ``ConstraintCompiler`` over the identity vocabulary,
token i = ``chr(i)``; a bad spec is a typed ``invalid_grammar`` 400),
multi-token ``stop`` sequences (trimmed, ``finish_reason``
``stop_sequence``), per-token ``logprobs`` (needs ``--logprobs-k``) and
``n`` best-of candidates (``temperature`` > 0, a single-row prompt, at
most ``--max-batch``). ``"stream": true`` runs a greedy request solo
through ``generate_segments`` and answers NDJSON, one line a segment,
sharing the device with the serving loop through one lock; it composes
with none of the structured fields. Every error leaves typed
(``code``, ``retryable``, ``detail``, Retry-After where it applies). On
SIGTERM the server drains: admitted requests finish (within
``--drain-timeout``), queued ones get a typed 503, the process exits 0.

The engine is built and warmed (``ContinuousEngine.warmup``: on the card
the kernels are built or loaded and run once) in the supervisor's engine
factory, before /healthz answers; a watchdog rebuild reuses the loaded
kernels and the same weights, so a replayed greedy request gives the
tokens of an uninterrupted run.

Disaggregated prefill, prefix pulls and the host KV tier, as the JAX
server has them (wire format: ``serve/disagg.py``):

- ``--role prefill`` (default ``$TPU_SERVE_ROLE``) serves ONLY ``POST
  /prefill`` {"tokens": [[...]]} -> {"shipped_kv": payload, ...} through
  ``PrefillWorker``/``PrefillServer`` (``build_prefill``), plus /healthz
  (``role: "prefill"``), /metrics and /debug/traces; it drains on SIGTERM
  and does not compose with ``--spec-k``, ``--int8``, ``--kv-int8``,
  ``--batch-window``, ``--tp`` or ``--dp``. ``--kv-block`` must match the
  decode pool's.
- ``shipped_kv`` on /generate (a single-row request) is decoded and
  verified against the row's prompt before it is queued (a mismatch is
  the typed ``ship_failed``); the engine ingests it before the request's
  admission, and the request joins without a local prefill.
- Retention: the engine keeps the exact prefix of up to
  ``--prefix-advertise`` completed prompts past their slots, advertises
  them on /healthz (``prefixes``) and exports them on ``GET
  /prefix/<digest>``.
- ``--host-tier-bytes`` attaches ONE process-lifetime ``HostTier`` to
  every engine the supervisor builds: dying prefixes spill to host RAM
  and admission restores them (/healthz ``tier_prefixes``); a ``session``
  key posts the restore at enqueue (``--tier-prefetch``).

``--kv-dense`` serves from the dense slot tensor (``kv_attend`` forced to
the gather's read, no host tier, no prefix retention): a ``shipped_kv``
request is prefilled locally (counted ``unsupported``), ``GET
/prefix/<digest>`` answers ``prefix_not_found``, and /debug/serve's
``kv_cache`` reads ``mode: "dense"``.

``--engine coalesce`` (selected by ``--batch-window`` alone; ``--engine
continuous --batch-window`` is refused) is the legacy path, ``LegacyServer``:
no scheduler and no supervisor, one device lock, each request decoded by
the solo ``generate`` (``speculative_generate`` under ``--spec-k`` when the
speculation margin fits), greedy requests of one shape batched within
``--batch-window`` ms by ``serve/coalesce.py``'s ``Coalescer`` (at most
``--max-batch`` rows, padded to a power of two), sampled ones solo at
their seed. It answers ``{"tokens": [...]}``; the structured fields are a
400 (they need the continuous engine), and /healthz carries
``coalesced_batches``, ``max_batch_rows``, ``pending`` and, under
``--spec-k``, ``spec_decodes``/``spec_rounds``/``spec_tokens``. On SIGTERM
the requests in the window and in flight are answered before it exits.

Tensor parallelism (``--tp N``): the replica stays one process to the
operator, rank 0 of a world of N it starts itself (``serve/tp.py``
``start_world``: N - 1 worker processes on this host, worker r on card
``r % device_count``, over ``--dist-backend``, nccl on the card and gloo
on the CPU by default; two ranks sharing one card need gloo). Rank 0
sends every worker the whole tree; each rank keeps its slices
(``param_sharding_rules``; an ``--int8`` tree stays whole on every rank,
as in JAX), runs its heads of the attention and holds its ``KV/tp`` heads
of the pool, and rank 0's engine drives the workers' with commands. N
must divide the 4 query heads; a KV head count that does not tile N is
served by the gather read (``--kv-attend kernel`` refuses it with JAX's
error). The workers exit with rank 0: at the drain, and on their own
when rank 0 dies.

Data parallelism over slots (``--dp D``, JAX's pod-scale decode): the
world is ``--tp`` x D ranks, D dp shards of ``--tp`` ranks each (the
mesh ``{"tp": T, "dp": D}``, ``dp`` outer); each shard holds the
params' same tp slices, ``--max-batch``/D slots and its tile of the block
pool, and admission picks a request's shard (``serve/engine.py``
``choose_dp_shard``). JAX's errors: ``--dp`` with ``--engine coalesce``,
a ``--max-batch`` it does not divide, ``--spec-k``, ``--role prefill``.

Under ``--tp`` and ``--dp`` the replica serves what it serves on one
device: ``--spec-k`` (at ``--tp`` only: ``--dp`` with ``--spec-k`` is
JAX's usage error), ``--host-tier-bytes``, ``shipped_kv`` requests (each
ingested on the dp shard that will seat it) and ``GET /prefix/<digest>``
(exported from the shard that holds the entry). The draft is sliced by
the target's rules and sent to every worker with the target's tree.

A pipelined checkpoint (``dist_lm --pp PP``) is served with ``--from-pp
PP``: ``restore_params`` reads JAX's ``{"outer", "stages"}`` tree and
merges it back into the standard one (``train/pp_lm.py``
``merge_pp_params``), and says so, as the JAX server does; restored
without it (or at another PP) it fails naming ``pp``.

Speculative decoding (``--spec-k K``): the engine decodes in rounds, a
draft of ``--spec-draft-layers`` layers (default max(1, layers // 2), the
target's width, restored from ``--draft-checkpoint-dir`` or quick-trained
on the same task, so it accepts) proposing
K tokens a lane that one target forward verifies; greedy tokens equal the
plain engine's, sampled ones follow the same law, and /healthz and
/debug/serve carry a ``spec`` section. It does not compose with
``--int8`` or ``--logprobs-k`` (refused with the JAX server's messages),
and under ``--kv-attend kernel`` K + 1 query rows times the heads a KV
head must fit the kernel's row cap (the engine refuses K past it).
With ``--checkpoint-dir`` it also needs ``--draft-checkpoint-dir``.

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
from tf_operator_tpu_torch.models.spec_decode import speculative_generate
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _decode_model,
    generate,
    generate_segments,
)
from tf_operator_tpu_torch.random import PRNGKey
from tf_operator_tpu_torch.runtime.tracing import (
    SERVE_TRACER,
    mint_request_id,
)
from tf_operator_tpu_torch.serve.coalesce import Coalescer
from tf_operator_tpu_torch.serve.constrain import (
    ConstraintCompiler,
    default_vocab,
)
from tf_operator_tpu_torch.serve.disagg import (
    PrefillServer,
    PrefillWorker,
    decode_shipment,
)
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.serve.faultinject import FaultInjector
from tf_operator_tpu_torch.serve.httpapi import (
    QuietHandler,
    readiness_payload,
)
from tf_operator_tpu_torch.serve.resilience import (
    EngineSupervisor,
    ResilienceConfig,
    ServeError,
    ShipFailed,
    error_payload,
    http_status_of,
    set_replica_id,
)
from tf_operator_tpu_torch.serve.scheduler import ServeRequest
from tf_operator_tpu_torch.serve.tp import report as tp_report
from tf_operator_tpu_torch.serve.tp import start_world
from tf_operator_tpu_torch.serve.tier import HostTier

def build_parser() -> argparse.ArgumentParser:
    """``examples/serve_lm.py``'s flags, under the same names and
    defaults, plus ``--device``."""
    p = argparse.ArgumentParser(
        description="LM serving over HTTP on the PyTorch port's "
                    "engines")
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
                   help="replica role (default $TPU_SERVE_ROLE): "
                        "'prefill' serves ONLY POST /prefill, prompt "
                        "prefill exported as shipped-KV block-pool rows "
                        "for a disaggregated fleet's decode pool "
                        "(--kv-block must match the decode pool's); "
                        "'decode' (or unset) is the ordinary server")
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
                   help="a checkpoint of the port's trainer "
                        "(tf_operator_tpu_torch.train.dist_lm): shape flags "
                        "must mirror the trainer's (default: quick-train "
                        "the +1-chain task at startup)")
    p.add_argument("--from-pp", type=int, default=None, metavar="PP",
                   help="the checkpoint came from dist_lm --pp PP: restore "
                        "the pipelined param tree and merge it back to the "
                        "standard layout (train/pp_lm.py merge_pp_params)")
    p.add_argument("--train-steps", type=int, default=150,
                   help="quick-train steps of the +1-chain task from the "
                        "seeded init (0 serves the init)")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism over N ranks this process "
                        "starts on this host (N must divide the heads)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend of --tp's world (default "
                        "nccl on cuda, gloo on cpu; two ranks on one card "
                        "need gloo)")
    p.add_argument("--dp", type=int, default=1,
                   help="data parallelism over slots: dp shards of --tp "
                        "ranks each (tp x dp ranks this process starts), "
                        "each with max-batch/dp slots and its tile of the "
                        "block pool; admission picks the shard")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decode (kernel B5)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV pools with f32 scale pools (kv8 B4)")
    p.add_argument("--requests", type=int, default=None,
                   help="exit 0 after serving this many /generate calls")
    p.add_argument("--spec-k", type=int, default=0, metavar="K",
                   help="speculative decoding: a draft model proposes K "
                        "tokens a lane each round, verified in one "
                        "(K+1)-row target forward; prompt + num_steps + "
                        "K + 1 must fit --max-seq-len. 0 = off")
    p.add_argument("--spec-draft-layers", type=int, default=None,
                   help="draft depth (default max(1, --layers // 2)); the "
                        "draft trains on the same task (quick_train)")
    p.add_argument("--draft-checkpoint-dir", default=None,
                   help="the draft's checkpoint (a trainer run at "
                        "--spec-draft-layers depth); default: quick-train "
                        "the draft")
    p.add_argument("--logprobs-k", type=int, default=0, metavar="K",
                   help="per-token top-K logprobs in /generate responses "
                        '(opt-in per request via "logprobs": true); 0 = '
                        "off")
    p.add_argument("--constrain-rows", type=int, default=128, metavar="N",
                   help="constraint-pool rows the compiled grammar programs "
                        "(json_schema/regex/choices) bind into; row 0 is "
                        "the always-allow row. Device cost: rows x vocab "
                        "bool + rows x vocab int32 (5 bytes a cell)")
    p.add_argument("--stream-segment", type=int, default=16, metavar="N",
                   help='segment size of "stream": true responses')
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                   help="prefill in fixed N-token chunks (0: one-shot)")
    p.add_argument("--batch-window", type=float, default=0.0,
                   metavar="MS",
                   help="legacy engine: coalesce concurrent greedy "
                        "/generate requests of the same shape for this "
                        "many ms and run them as ONE batched decode. "
                        "Implies --engine coalesce. 0 = off")
    p.add_argument("--max-batch", type=int, default=8,
                   help="decode slots of the continuous engine / row cap "
                        "per coalesced batch (--batch-window)")
    p.add_argument("--engine", choices=("continuous", "coalesce"),
                   default=None,
                   help="'continuous' = slot-based continuous batching; "
                        "'coalesce' = the legacy direct/batch-window path. "
                        "Default: continuous unless --batch-window (the "
                        "window IS the coalesce policy)")
    p.add_argument("--prefill-budget", type=int, default=256,
                   metavar="TOKENS",
                   help="max prompt tokens prefilled per serving-loop "
                        "iteration while slots are decoding")
    p.add_argument("--kv-paged", dest="kv_paged", action="store_true",
                   default=True, help="block-paged KV cache (the default)")
    p.add_argument("--kv-dense", dest="kv_paged", action="store_false",
                   help="continuous engine: the dense slot tensor (every "
                        "slot pre-pays max-seq-len rows; no prefix "
                        "sharing, shipping or host tier)")
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
    p.add_argument("--prefix-advertise", type=int, default=32,
                   metavar="N",
                   help="hot prefix-cache entries advertised on /healthz "
                        "and retained past their requests for "
                        "fleet-global prefix routing (MRU first; 0 "
                        "advertises none: the replica still answers "
                        "/prefix/<digest> pulls)")
    p.add_argument("--host-tier-bytes", type=int, default=0,
                   metavar="BYTES",
                   help="host-RAM KV tier byte budget: evicted prefix "
                        "entries spill here as wire payloads and admission "
                        "restores them; it also answers /prefix/<digest> "
                        "pulls and advertises tier_prefixes on /healthz, "
                        "and outlives watchdog rebuilds. 0 (default) "
                        "disables the tier")
    p.add_argument("--tier-prefetch", type=int, default=1, metavar="0|1",
                   help="async host-tier prefetch at enqueue for requests "
                        "carrying a session key (the prefix upload "
                        "overlaps the queue wait); 0 restores only at "
                        "admission")
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


def restore_params(ckpt_dir: str, cfg: TransformerConfig, label: str,
                   from_pp: int | None = None) -> dict | None:
    """The params of the newest step of a port checkpoint under
    ``ckpt_dir`` as the flax-layout tree ``build_front`` takes, checked
    against ``cfg``'s shapes (and, ``from_pp``, written by a pipelined run
    at that ``pp`` and merged back into the standard tree): THE restore
    path of the target and the draft. Returns None (after the JAX server's
    error line) when the directory holds no step."""
    from tf_operator_tpu_torch.train import checkpoint

    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        print(f"serve_lm: no checkpoint in {ckpt_dir}", file=sys.stderr,
              flush=True)
        return None
    params = checkpoint.restore_params(ckpt_dir, cfg, step, from_pp=from_pp)
    print(f"serve_lm: restored {label} checkpoint step {step}"
          + (f" (merged from pp={from_pp})" if from_pp else ""), flush=True)
    return params


def _to_device(tree, device) -> dict:
    """The tree's leaves as tensors on ``device`` in their own dtypes, so
    every engine generation copies its weights device to device."""
    return {k: _to_device(v, device) if isinstance(v, dict)
            else (v if isinstance(v, torch.Tensor)
                  else torch.from_numpy(np.array(v))).to(device)
            for k, v in tree.items()}


class _Front(ThreadingHTTPServer):
    """What both fronts hold: the weights the streaming path decodes, the
    device lock every decode path shares, the drain event (set on SIGTERM
    or after ``--requests``) and the served count."""

    daemon_threads = True

    def __init__(self, address, handler, *, cfg, params, args, device,
                 lock: threading.Lock) -> None:
        super().__init__(address, handler)
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

    def start(self) -> "_Front":
        threading.Thread(target=self.serve_forever, daemon=True,
                         name="serve-http").start()
        return self


class FrontServer(_Front):
    """The continuous front: the HTTP server over the supervisor."""

    def __init__(self, address, supervisor: EngineSupervisor, *, cfg,
                 params, args, device, lock: threading.Lock) -> None:
        super().__init__(address, _Handler, cfg=cfg, params=params,
                         args=args, device=device, lock=lock)
        self.supervisor = supervisor
        self.tp_world = None  # serve/tp.py TpWorld under --tp

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
        if self.tp_world is not None:
            # The workers exit with rank 0's engine.
            self.tp_world.close()


class LegacyServer(_Front):
    """The legacy front of ``--engine coalesce`` (the JAX server's handler
    branch without ``engine_sched``): no scheduler and no supervisor; one
    device lock; each request decoded solo by ``generate`` over the model
    loaded once (``speculative_generate`` under ``--spec-k`` when the
    margin fits: ``decode_spec``), greedy requests of one shape batched by
    a ``Coalescer`` when ``--batch-window`` > 0."""

    def __init__(self, address, *, cfg, params, args, device,
                 lock: threading.Lock, draft_cfg=None,
                 draft_params=None) -> None:
        super().__init__(address, _LegacyHandler, cfg=cfg, params=params,
                         args=args, device=device, lock=lock)
        # The solo decode model, loaded here once (the streaming path
        # shares it): the legacy path's warm-up.
        self._stream_model = self.model = _decode_model(cfg, params, device)
        self.draft_cfg = draft_cfg
        self.draft_model = (None if draft_params is None
                            else _decode_model(draft_cfg, draft_params,
                                               device))
        # /healthz telemetry proving the speculative path ran.
        self.spec_stats = {"decodes": 0, "rounds": 0, "tokens": 0}
        self.coalescer = None
        self._batcher = None
        if args.batch_window > 0:
            self.coalescer = Coalescer(args.batch_window / 1e3,
                                       args.max_batch,
                                       self._coalesced_decode, self.done)
        # /generate handlers inside their decode: the drain waits for them.
        self.inflight = 0
        self._inflight_lock = threading.Lock()

    def _coalesced_decode(self, rows, num_steps: int):
        with self.lock:
            return self.decode_greedy(rows, num_steps)

    def decode_spec(self, rows, num_steps: int, temperature: float = 0.0,
                    top_p: float | None = None, rng=None):
        """THE speculative decode of greedy (direct and coalesced) and
        sampled requests: ``speculative_generate`` when ``--spec-k`` is set
        and prompt + steps + k + 1 fits the cache, else None (the caller
        runs ``generate``: the same tokens greedy, the same law sampled).
        The caller holds ``lock``, which also covers the counters."""
        k = self.args.spec_k
        if not (k and rows.shape[1] + num_steps + k + 1
                <= self.cfg.max_seq_len):
            return None
        out, rounds = speculative_generate(
            self.cfg, self.model, self.draft_cfg, self.draft_model,
            torch.as_tensor(rows, device=self.device), num_steps, k=k,
            temperature=temperature, top_p=top_p, rng=rng)
        self.spec_stats["decodes"] += 1
        self.spec_stats["rounds"] += int(rounds)
        self.spec_stats["tokens"] += num_steps
        return out

    def decode_greedy(self, rows, num_steps: int):
        """A greedy ``[rows, num_steps]`` decode; call under ``lock``."""
        out = self.decode_spec(rows, num_steps)
        if out is None:
            out = generate(self.cfg, self.model,
                           torch.as_tensor(rows, device=self.device),
                           num_steps)
        return out

    def start(self) -> "LegacyServer":
        if self.coalescer is not None:
            self._batcher = threading.Thread(target=self.coalescer.loop,
                                             daemon=True, name="coalesce")
            self._batcher.start()
        return super().start()

    def drain(self, timeout: float | None = None) -> None:
        """The SIGTERM drain: the batcher answers every request in its
        window before it exits (a request submitted after that gets
        "server shutting down"), the direct requests in flight finish
        (within ``--drain-timeout``), then the listener stops."""
        self.done.set()
        if self._batcher is not None:
            self._batcher.join(timeout=timeout or 30.0)
        limit = time.monotonic() + (self.args.drain_timeout or 30.0)
        while self.inflight and time.monotonic() < limit:
            time.sleep(0.02)
        time.sleep(0.2)  # let unblocked handlers write their responses
        self.shutdown()
        self.server_close()


class _FrontHandler(QuietHandler):
    """What both fronts' handlers share: the one error mapping of
    /generate (typed ``ServeError``s with their status, a timeout as a
    retryable 503, anything else a 400 ``bad_request``) and the streamed
    greedy decode."""

    server: _Front

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
        raise NotImplementedError

    def _check_stream(self, body: dict) -> None:
        """The structured fields live in the continuous engine's
        scheduler: a stream (solo ``generate_segments``) would silently
        drop them."""
        if structured_fields(body):
            raise ValueError(
                "stream does not compose with json_schema/regex/"
                "choices/stop/logprobs/n (use the continuous engine's "
                "buffered path)"
            )

    def _stream(self, prompt, num_steps, temperature, top_p) -> None:
        """Streamed greedy decode: NDJSON, one line a segment, solo
        through ``generate_segments``; the device lock covers only the
        device work of each segment."""
        srv = self.server
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


def structured_fields(body: dict) -> bool:
    """Does a /generate body carry a field only the continuous engine's
    scheduler serves (json_schema/regex/choices/stop/logprobs/n)?"""
    return (any(body.get(k) is not None
                for k in ("json_schema", "regex", "choices", "stop"))
            or bool(body.get("logprobs")) or int(body.get("n", 1)) != 1)


class _Handler(_FrontHandler):
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
            if srv.args.spec_k:
                payload["spec"] = srv.supervisor.engine.spec_debug()
            self.send_json(200, payload)
        elif path == "/debug/serve":
            self.send_json(200, srv.supervisor.debug_snapshot())
        elif path == "/debug/traces":
            self.send_serve_traces()
        elif path == "/metrics":
            self.send_metrics()
        elif path.startswith("/prefix/"):
            # Fleet-global prefix reuse: one prefix entry, named by its
            # chained per-block digest (the chain /healthz advertises), in
            # the shipped-KV wire format; a stale digest answers the typed
            # prefix_not_found and the puller prefills locally.
            try:
                shipment = srv.supervisor.export_prefix(
                    path[len("/prefix/"):])
            except Exception as exc:  # noqa: BLE001 — typed out
                payload = error_payload(exc)
                payload["replica"] = srv.args.replica_id
                self.send_json(http_status_of(exc), payload)
                return
            self.send_json(200, {"shipment": shipment,
                                 "replica": srv.args.replica_id})
        else:
            self.send_json(404, {"error": "unknown path"})

    def _generate(self, body: dict) -> bool:
        """Answer one /generate body; True once a response went out."""
        srv = self.server
        prompt = np.asarray(body["tokens"], np.int32)
        if prompt.ndim != 2:
            raise ValueError("tokens must be [batch, len]")
        num_steps = int(body.get("num_steps", 8))
        temperature = float(body.get("temperature", 0.0))
        top_p = body.get("top_p")
        shipment = None
        if body.get("shipped_kv") is not None:
            # Disaggregated prefill: verify the payload (chained digests,
            # row checksum, the request's own prompt) BEFORE it reaches the
            # scheduler; a mismatch raises the typed ship_failed. A
            # shipment prefilled ONE prompt: single-row requests only.
            if prompt.shape[0] != 1:
                raise ShipFailed("shipped_kv serves single-row requests "
                                 "only")
            shipment = decode_shipment(body["shipped_kv"],
                                       expect_tokens=prompt[0])
        if body.get("stream"):
            self._check_stream(body)
            self._stream(prompt, num_steps, temperature, top_p)
            return True
        # At most one of json_schema/regex/choices (the compiler's typed
        # 400 owns the message for conflicts and bad grammars).
        constrain = {k: body[k] for k in ("json_schema", "regex", "choices")
                     if body.get(k) is not None} or None
        want_logprobs = bool(body.get("logprobs"))
        n_best = int(body.get("n", 1))
        if n_best < 1:
            raise ValueError(f"n={n_best} must be >= 1")
        if n_best > 1:
            if prompt.shape[0] != 1:
                raise ValueError("n > 1 requires a single-row prompt "
                                 "(candidates fan out over slots)")
            if temperature <= 0:
                raise ValueError("n > 1 requires temperature > 0 (greedy "
                                 "candidates would be identical)")
            if n_best > srv.args.max_batch:
                raise ValueError(f"n={n_best} exceeds slot capacity "
                                 f"{srv.args.max_batch}")
        eos_id = body.get("eos_id")
        deadline_s = body.get("deadline_s")
        seed = int(body.get("seed", 0))
        rid = (body.get("request_id") or self.headers.get("X-Request-Id")
               or mint_request_id())

        def row(i):
            # Candidate j of n is row 0's request at seed + j; identical
            # prompts join by exact prefix match, so n candidates pay one
            # prefill.
            return srv.supervisor.submit_request(ServeRequest(
                prompt[0:1] if n_best > 1 else prompt[i:i + 1], num_steps,
                temperature=temperature,
                top_p=None if top_p is None else float(top_p),
                seed=seed + i,
                eos_id=None if eos_id is None else int(eos_id),
                deadline_s=None if deadline_s is None else float(deadline_s),
                request_id=rid if i == 0 else f"{rid}.{i}",
                # A session key pre-warms the host KV tier at enqueue; the
                # single-row rule above gives the shipment to row 0 alone
                # (and to every n-best candidate of that row).
                session=body.get("session"), shipment=shipment,
                constrain=constrain, stop=body.get("stop"),
                logprobs=want_logprobs,
            ))

        fanout = n_best if n_best > 1 else prompt.shape[0]
        if fanout == 1:
            rows = [row(0)]
        else:
            # Rows decode concurrently, at most one thread a slot.
            with ThreadPoolExecutor(min(fanout, srv.args.max_batch)) as ex:
                rows = list(ex.map(row, range(fanout)))
        payload = {"tokens": [list(r.out) for r in rows], "request_id": rid}
        if any(r.finish_reason for r in rows):
            # "length" | "eos" | "grammar_complete" | "stop_sequence"
            # (None for a deadline-cut partial).
            payload["finish_reason"] = [r.finish_reason for r in rows]
        if want_logprobs:
            payload["logprobs"] = [r.logprob_rows for r in rows]
        if n_best > 1:
            # The candidate view of the same rows, one entry a seed.
            payload["choices"] = [
                {"tokens": list(r.out), "seed": seed + j,
                 "finish_reason": r.finish_reason}
                for j, r in enumerate(rows)
            ]
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


class _LegacyHandler(_FrontHandler):
    server: LegacyServer

    def do_GET(self) -> None:
        srv = self.server
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            payload = readiness_payload(None, draining=srv.done.is_set(),
                                        replica=srv.args.replica_id)
            payload["served"] = srv.served
            payload["engine"] = "coalesce"
            if srv.coalescer is not None:
                payload["coalesced_batches"] = srv.coalescer.batches
                payload["max_batch_rows"] = srv.coalescer.max_rows_seen
                payload["pending"] = len(srv.coalescer.pending)
            if srv.args.spec_k:
                payload["spec_decodes"] = srv.spec_stats["decodes"]
                payload["spec_rounds"] = srv.spec_stats["rounds"]
                payload["spec_tokens"] = srv.spec_stats["tokens"]
            self.send_json(200, payload)
        elif path == "/debug/traces":
            self.send_serve_traces()
        elif path == "/metrics":
            self.send_metrics()
        else:
            # /debug/serve and /prefix/<digest> are the engine's: the JAX
            # server's legacy path has neither.
            self.send_json(404, {"error": "unknown path"})

    def do_POST(self) -> None:
        srv = self.server
        with srv._inflight_lock:
            srv.inflight += 1
        try:
            super().do_POST()
        finally:
            with srv._inflight_lock:
                srv.inflight -= 1

    def _generate(self, body: dict) -> bool:
        """Answer one /generate body by the JAX server's legacy branch:
        a stream solo; the structured fields a 400; greedy through the
        coalescer when there is one, else ``decode_greedy``; sampled solo
        at ``PRNGKey(seed)``, speculative when it fits. The answer is
        ``{"tokens": [...]}``, one row a prompt row."""
        srv = self.server
        prompt = np.asarray(body["tokens"], np.int32)
        if prompt.ndim != 2:
            raise ValueError("tokens must be [batch, len]")
        num_steps = int(body.get("num_steps", 8))
        temperature = float(body.get("temperature", 0.0))
        top_p = body.get("top_p")
        top_p = None if top_p is None else float(top_p)
        if body.get("stream"):
            self._check_stream(body)
            self._stream(prompt, num_steps, temperature, top_p)
            return True
        if structured_fields(body):
            raise ValueError("json_schema/regex/choices/stop/logprobs/n "
                             "require --engine continuous")
        # top_p without a temperature is sampled here, as JAX forwards it:
        # generate refuses it, a client-visible 400.
        sampled = temperature > 0 or top_p is not None
        if srv.coalescer is not None and not sampled:
            out = srv.coalescer.submit(prompt, num_steps)
        elif not sampled:
            with srv.lock:
                out = srv.decode_greedy(prompt, num_steps)
        else:
            rng = (PRNGKey(int(body.get("seed", 0)), srv.device)
                   if temperature > 0 else None)
            with srv.lock:
                out = None
                if temperature > 0:
                    out = srv.decode_spec(prompt, num_steps, temperature,
                                          top_p, rng)
                if out is None:
                    out = generate(srv.cfg, srv.model,
                                   torch.as_tensor(prompt,
                                                   device=srv.device),
                                   num_steps, temperature=temperature,
                                   top_p=top_p, rng=rng)
        self.send_json(200, {"tokens": out.tolist()})
        return True


def check_args(args) -> None:
    """Refuse what the front cannot serve, before any device work: the
    combinations the JAX server refuses, with its messages (``--engine
    continuous`` with ``--batch-window``; ``--role prefill`` with a flag of
    the decode path; ``--spec-k`` with ``--int8`` or ``--logprobs-k``, or
    with ``--checkpoint-dir`` but no ``--draft-checkpoint-dir``;
    ``--draft-checkpoint-dir`` without ``--spec-k``: ValueError), a
    prefill budget below one token, a negative ``--logprobs-k``, no
    constraint row or, where
    blocks are used (the paged continuous engine, a prefill replica), a
    sequence length off the block grid (ValueError). Resolves
    ``args.engine`` as JAX does: ``--batch-window`` alone selects
    ``coalesce``, nothing selects ``continuous``."""
    if args.batch_window > 0 and args.engine == "continuous":
        raise ValueError(
            "--engine continuous does not compose with --batch-window (the "
            "window IS the coalesce policy — use --engine coalesce)")
    if args.engine is None:
        args.engine = "coalesce" if args.batch_window > 0 else "continuous"
    if args.dp > 1:
        if args.engine != "continuous":
            raise ValueError(
                "--dp > 1 needs --engine continuous (the dp slot slices "
                "exist only in the continuous engine)")
        if args.max_batch % args.dp:
            raise ValueError("--dp must divide --max-batch (each dp shard "
                             "owns an equal slot slice)")
        if args.spec_k:
            raise ValueError(
                "--dp does not compose with --spec-k yet (the pod-scale "
                "bit-identity pins cover the plain engine; the spec "
                "engine's dp placement is unvalidated)")
    if args.role == "prefill":
        bad = [flag for flag, on in (
            ("--spec-k", bool(args.spec_k)),
            ("--int8", args.int8),
            ("--kv-int8", args.kv_int8),
            ("--batch-window", args.batch_window > 0),
            ("--tp", args.tp > 1),
            ("--dp", args.dp > 1),
        ) if on]
        if bad:
            raise ValueError(
                f"--role prefill does not compose with {'/'.join(bad)} (a "
                "prefill replica runs only the solo dense prefill and "
                "ships its rows)")
    if args.spec_k:
        if args.spec_k < 1:
            raise ValueError("--spec-k must be >= 1 (0 disables)")
        if (args.spec_draft_layers is not None
                and args.spec_draft_layers < 1):
            raise ValueError("--spec-draft-layers must be >= 1")
        if args.int8:
            raise ValueError(
                "--spec-k does not compose with --int8 (speculative "
                "decoding rejects int8_decode param trees; quantize after "
                "choosing a decode strategy)")
        if args.checkpoint_dir and not args.draft_checkpoint_dir:
            raise ValueError(
                "--spec-k with --checkpoint-dir also needs "
                "--draft-checkpoint-dir (a draft trained at "
                "--spec-draft-layers depth)")
    elif args.draft_checkpoint_dir:
        raise ValueError("--draft-checkpoint-dir requires --spec-k")
    if args.logprobs_k and args.spec_k:
        raise ValueError(
            "--logprobs-k does not compose with --spec-k (verify rounds "
            "emit accept-dependent windows, not per-step logit rows)")
    if args.tp < 1 or args.dp < 1:
        raise ValueError("--tp and --dp must be >= 1")
    if args.tp > 1 and args.engine == "coalesce":
        raise ValueError("--tp runs the continuous engine (drop "
                         "--batch-window / --engine coalesce)")
    if args.prefill_budget < 1:
        raise ValueError("--prefill-budget must be >= 1")
    if args.logprobs_k < 0:
        raise ValueError("--logprobs-k must be >= 0")
    if args.constrain_rows < 1:
        raise ValueError("--constrain-rows must be >= 1")
    if args.max_seq_len % args.kv_block:
        if args.role == "prefill":
            raise ValueError(
                "--role prefill needs --kv-block to divide --max-seq-len "
                "(the shipped rows are block-aligned pool rows for the "
                "decode pool)")
        if args.engine == "continuous" and args.kv_paged:
            raise ValueError(f"--max-seq-len {args.max_seq_len} must be a "
                             f"multiple of --kv-block {args.kv_block} (or "
                             "use --kv-dense)")


def check_tp(cfg: TransformerConfig, args) -> None:
    """``--tp``'s checks against the model, before any process starts:
    the config's own (tp divides the heads; a KV head count that does not
    tile tp refuses the kernel read with JAX's error). ValueError."""
    if args.tp * args.dp <= 1:
        return
    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    paged = args.kv_paged
    attend = ("gather" if not paged
              else "kernel" if args.kv_attend == "pallas" else args.kv_attend)
    axes = {"tp": args.tp, **({"dp": args.dp} if args.dp > 1 else {})}
    replace(cfg, decode=True, kv_paged=paged, kv_attend=attend,
            kv_block=args.kv_block, kv_num_blocks=max(2, cfg.kv_num_blocks),
            mesh=create_mesh(axes, range(args.tp * args.dp)))


def draft_config(cfg: TransformerConfig, args) -> TransformerConfig:
    """The speculative draft's config: the target's width at
    ``--spec-draft-layers`` layers (default max(1, layers // 2)), as the
    JAX server builds it."""
    layers = (args.spec_draft_layers if args.spec_draft_layers is not None
              else max(1, cfg.n_layers // 2))
    return replace(cfg, n_layers=layers)


def build_front(cfg: TransformerConfig, params, args, draft_params=None
                ) -> tuple[EngineSupervisor | None, _Front]:
    """The serving front over ``params`` (a flax-layout tree; an
    ``int8_decode`` config takes a ``quantize_decode_params`` tree): the
    supervisor, with its first engine built and warmed, and the HTTP
    server bound to ``args.host``:``args.port``, not yet serving (call
    ``start()``); under ``--engine coalesce`` no supervisor (None) and a
    ``LegacyServer``. ``args`` is ``front_args(...)`` or the parsed flags.
    Under ``--spec-k`` ``draft_params`` is the draft's tree, at
    ``draft_config(cfg, args)``. Raises on a CUDA device when torch sees
    no card, and where ``check_args`` refuses ``args``."""
    device = resolve_device(args.device)
    check_args(args)
    check_tp(cfg, args)
    if args.spec_k and draft_params is None:
        raise ValueError("--spec-k needs the draft's weights "
                         "(draft_params)")
    if args.replica_id:
        set_replica_id(args.replica_id)
    if args.trace_capacity != SERVE_TRACER.capacity:
        SERVE_TRACER.set_capacity(args.trace_capacity)
    params = _to_device(params, device)
    if args.engine == "coalesce":
        return None, LegacyServer(
            (args.host, args.port), cfg=cfg, params=params, args=args,
            device=device, lock=threading.Lock(),
            draft_cfg=draft_config(cfg, args) if args.spec_k else None,
            draft_params=(_to_device(draft_params, device)
                          if args.spec_k else None))
    kv_paged = args.kv_paged
    if kv_paged and cfg.max_seq_len % args.kv_block:
        raise ValueError(f"max_seq_len {cfg.max_seq_len} must be a "
                         f"multiple of --kv-block {args.kv_block} (or use "
                         "--kv-dense)")
    faults = (FaultInjector(args.faults, seed=args.fault_seed)
              if args.faults is not None else FaultInjector.from_env())
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
    # The dense slot tensor has no block table for the kernel to read:
    # the gather's math, as JAX forces it.
    attend = ("gather" if not kv_paged
              else "kernel" if args.kv_attend == "pallas" else args.kv_attend)
    # ONE process-lifetime host tier, attached to every engine the factory
    # builds: a watchdog rebuild loses the pool but not the spilled
    # sessions, which the new generation restores on demand. Paged only.
    host_tier = (HostTier(args.host_tier_bytes)
                 if kv_paged and args.host_tier_bytes > 0 else None)
    # What every rank's engine is built from (the workers' too; the
    # draft's tree travels after the target's).
    engine_kwargs = dict(
        cfg=cfg, max_slots=args.max_batch, kv_paged=kv_paged,
        kv_block=args.kv_block, kv_blocks=args.kv_pool_blocks,
        kv_attend=attend, prefill_chunk=args.prefill_chunk or None,
        constrain_rows=args.constrain_rows, logprobs_k=args.logprobs_k)
    draft = None
    if args.spec_k:
        engine_kwargs.update(spec_k=args.spec_k,
                             draft_cfg=draft_config(cfg, args))
        draft = _to_device(draft_params, device)
    world = None
    need = args.tp * args.dp
    if need > 1:
        world = start_world(need, device, args.dist_backend,
                            engine_kwargs, params, dp=args.dp,
                            draft_params=draft)
        print(f"serve_lm: params "
              f"{'replicated (int8)' if cfg.int8_decode else 'tp-sharded'}"
              f" over {need} devices"
              + (f" (tp {args.tp} x dp {args.dp})" if args.dp > 1 else ""),
              flush=True)

    def engine_factory() -> ContinuousEngine:
        # The watchdog rebuilds through here: the SAME cfg and weights
        # every time (replay bit-identity depends on it), a fresh pool
        # (on every rank of a tp world: the build command), and a warm
        # step before the engine takes a request.
        eng = ContinuousEngine(
            params=params, faults=faults, device=device,
            mesh=world.mesh if world is not None else None,
            draft_params=draft, **engine_kwargs,
        )
        if kv_paged:
            # Retention matches the advertisement's width: every digest
            # the replica advertises stays exportable and exact-joinable
            # after its request completes.
            eng.prefix_advertise_max = args.prefix_advertise
            eng.prefix_retain_max = args.prefix_advertise
            eng.host_tier = host_tier
        eng.warmup()
        return eng

    # ONE process-lifetime constraint compiler: its program LRU survives
    # watchdog rebuilds. The vocabulary is the identity charset (token i =
    # chr(i)); a deployment passes its tokenizer's decoded token strings.
    constrainer = ConstraintCompiler(default_vocab(cfg.vocab_size))

    lock = threading.Lock()
    try:
        supervisor = EngineSupervisor(
            engine_factory, resilience=res_cfg, faults=faults,
            prefill_tokens_per_step=args.prefill_budget,
            # Streaming requests bypass the engine and share the device:
            # one lock serializes both decode paths.
            device_lock=lock,
            tier_prefetch=bool(args.tier_prefetch),
            constrainer=constrainer,
        )
        server = FrontServer((args.host, args.port), supervisor, cfg=cfg,
                             params=params, args=args, device=device,
                             lock=lock)
    except BaseException:
        if world is not None:
            world.close()
        raise
    server.tp_world = world
    return supervisor, server


def build_prefill(cfg: TransformerConfig, params, args) -> PrefillServer:
    """A dedicated prefill replica over ``params`` (a flax-layout tree):
    the ``PrefillWorker`` on ``args.device`` behind a ``PrefillServer``
    bound to ``args.host``:``args.port``, not yet serving (call
    ``start()``; the worker is ``server.backend``). Raises where
    ``check_args`` refuses ``args`` and on a CUDA device without a card."""
    device = resolve_device(args.device)
    check_args(args)
    if args.replica_id:
        set_replica_id(args.replica_id)
    if args.trace_capacity != SERVE_TRACER.capacity:
        SERVE_TRACER.set_capacity(args.trace_capacity)
    worker = PrefillWorker(cfg, _to_device(params, device),
                           prefill_chunk=args.prefill_chunk or None,
                           kv_block=args.kv_block, device=device)
    return PrefillServer(worker, replica_id=args.replica_id or "prefill",
                         host=args.host, port=args.port)


def serve_prefill(cfg: TransformerConfig, params, args) -> int:
    """``main``'s prefill role: serve until SIGTERM, then drain (readiness
    withdrawn first, in-flight prefills finish within
    ``--drain-timeout``)."""
    server = build_prefill(cfg, params, args).start()
    worker = server.backend
    print(f"serve_lm: PREFILL replica {args.replica_id or '(anonymous)'} "
          f"on {server.endpoint} (kv_block={args.kv_block}, chunk="
          f"{args.prefill_chunk or 'one-shot'})", flush=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    server.begin_drain()
    deadline = time.monotonic() + args.drain_timeout
    while ((worker.queue_depth or worker.active_slots)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    server.stop()
    print(f"serve_lm: prefill replica drained ({worker.requests_done} "
          f"prompts, {worker.tokens_prefilled} tokens shipped)", flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.requests is not None and args.requests < 1:
        p.error("--requests must be >= 1 (omit it to serve until SIGTERM)")
    try:
        check_args(args)
    except ValueError as exc:
        p.error(str(exc))
    device = resolve_device(args.device)
    # The JAX server's model: 4 heads, d_ff = 2 d, f32.
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=4,
        n_kv_heads=args.kv_heads, n_layers=args.layers,
        d_ff=args.d_model * 2, max_seq_len=args.max_seq_len,
        dtype=torch.float32, int8_decode=args.int8, kv_int8=args.kv_int8,
    )
    try:
        check_tp(cfg, args)
    except ValueError as exc:
        p.error(str(exc))
    if args.checkpoint_dir:
        params = restore_params(args.checkpoint_dir, cfg, "target",
                                from_pp=args.from_pp)
        if params is None:
            return 1
    else:
        params = quick_train(cfg, args.train_steps, args.lr, device)
    if args.role == "prefill":
        return serve_prefill(cfg, params, args)
    if args.int8:
        params = quantize_decode_params(params)
        print("serve_lm: projections quantized to int8", flush=True)
    draft_params = None
    if args.spec_k:
        dcfg = draft_config(cfg, args)
        if args.draft_checkpoint_dir:
            draft_params = restore_params(args.draft_checkpoint_dir, dcfg,
                                          "draft")
            if draft_params is None:
                return 1
        else:
            # The same task as the target's: the draft agrees with it
            # often enough to accept.
            draft_params = quick_train(dcfg, args.train_steps, args.lr,
                                       device)
        print(f"serve_lm: speculative decoding on (k={args.spec_k}, draft "
              f"layers={dcfg.n_layers})", flush=True)
    supervisor, server = build_front(cfg, params, args, draft_params)
    if supervisor is None:
        print(f"serve_lm: legacy engine on {device}"
              + (f", coalescing greedy requests (window "
                 f"{args.batch_window:.0f} ms, max batch {args.max_batch})"
                 if server.coalescer is not None else
                 ", one decode a request"), flush=True)
    else:
        eng = supervisor.engine
        kv_desc = (f"paged kv ({args.kv_block}-token blocks, "
                   f"{eng.kv_blocks} block pool), kv_attend "
                   f"{eng.kv_attend}" if eng.kv_paged else "dense kv")
        # JAX's parts of the line: the tier, the mesh, spec, constraints.
        if eng.host_tier is not None:
            kv_desc += (f", host tier {args.host_tier_bytes >> 20 or 1} MiB"
                        f"{' +prefetch' if args.tier_prefetch else ''}")
        if server.tp_world is not None:
            kv_desc += f", tp {args.tp} (kv head-sharded)"
            if args.dp > 1:
                kv_desc += (f" x dp {args.dp} (slots + pool blocks "
                            f"dp-sharded)")
            for r, row in enumerate(tp_report(eng)):
                print(f"serve_lm: tp rank {r} pool bytes "
                      f"{row['pool_bytes']}", flush=True)
        if args.spec_k:
            kv_desc += (f", spec k={args.spec_k} (draft "
                        f"{eng.draft_cfg.n_layers} layer(s))")
        kv_desc += f", constrain pool {args.constrain_rows} rows"
        if args.logprobs_k:
            kv_desc += f", logprobs top-{args.logprobs_k}"
        print(f"serve_lm: continuous batching on {device} (slots "
              f"{args.max_batch}, {kv_desc}, prefill chunk "
              f"{args.prefill_chunk or 'one-shot'}, prefill budget "
              f"{args.prefill_budget} tok/iter, host tier "
              f"{(args.host_tier_bytes if eng.kv_paged else 0) or 'off'})",
              flush=True)
    server.start()
    print(f"serve_lm: listening on {server.endpoint}", flush=True)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: server.done.set())
    server.done.wait()
    server.drain()
    if supervisor is not None:
        print(f"serve_lm: engine drained ({supervisor.requests_done} "
              f"request(s), {supervisor.tokens_generated} token(s))",
              flush=True)
    print(f"serve_lm: done ({server.served} request(s) served)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
