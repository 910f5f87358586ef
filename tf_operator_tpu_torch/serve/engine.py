"""Continuous-batching decode engine, in PyTorch.

Counterpart of ``tf_operator_tpu/serve/engine.py::ContinuousEngine`` on
one device. Requests join whenever a slot (and, paged, enough blocks) is
free, every step advances all active slots by one token in ONE batched
forward, and slots retire one by one. Two KV layouts, as in JAX:

- ``kv_paged=True`` (default): KV lives in per-layer pools of
  ``kv_block``-token blocks; each slot owns a block table sized to its
  actual length (prompt + decode horizon). Everything below about blocks,
  prefixes, shipments and the tier is this layout's.
- ``kv_paged=False``: the dense slot tensor (``serve/kvcache.py``
  ``stack_slots``), every slot a row of ``max_seq_len`` positions and a
  counter of its own; a join lands its prefill with ``dense_insert`` and
  the step reads each lane's row at its counter
  (``models/transformer.py`` ``_decode_attend_lanes``). Admission needs
  only a free slot; nothing is shared, shipped or spilled: an ingest
  answers None (the caller prefills locally), an export raises
  ``PrefixNotFound``, the tier and the advertisements are inert, and
  ``free_block_fraction`` reads 1.0. The read is the gather's math, so
  ``kv_attend="kernel"`` is refused here as in JAX.

- Prefill is a solo dense concern: each joining request prefills alone
  over a dense cache and its prompt rows are scattered into its blocks.
- Prefix sharing: a prompt that extends a registered block-aligned
  prefix maps those entries to the donor's blocks (refcounts bumped)
  and prefills only its suffix; an exact whole-prompt match reuses the
  donor's last-position logits and skips prefill. An exact match that
  ends mid-block shares a block the sharer will write: the engine
  copies it to a private block (copy-on-write) before that step.
- Admission is planned: ``plan_admission`` reserves the slot's blocks,
  so the prefill and join that follow cannot fail on capacity;
  ``release_plan`` undoes it.
- Prefill may run in fixed chunks (``prefill_chunk``):
  ``prefill_planned`` hands out the resumable ``ChunkedPrefill`` a
  planned admission still needs.
- Token order follows the JAX engine: the first generated token is
  sampled at the next ``step`` from the logits the prefill carried, and
  each step samples from the previous forward's logits, then runs the
  forward.
- Sampling per lane: greedy (argmax, the first maximum), or temperature
  with an optional nucleus ``top_p`` through the threefry sampler
  (``tf_operator_tpu_torch/random.py``). Each lane's key ladder is solo
  ``generate``'s ``split(PRNGKey(seed), num_steps)``, so a request's
  tokens follow its solo run for the same seed. Keys, step indices and
  sampling parameters live on the device; a step whose active lanes are
  all greedy skips the sampler.
- Constrained decoding (``serve/constrain.py``): a join may carry a
  compiled ``program``, bound into the engine's ``ProgramPool`` (row 0
  the always-allow program). Each slot's FSM row lives on the device;
  every step adds ``where(allow_pool[fsm], 0.0, -1e30)`` to every lane's
  logits before sampling (+0.0 for an unconstrained lane) and advances
  ``fsm = next_pool[fsm, token]``, with no extra host sync. A bind that
  cannot fit (every resident program still referenced) returns None, the
  requeue contract of block exhaustion.
- Logprobs (``logprobs_k`` > 0): each step also keeps the chosen token's
  logprob and the top-K values and ids of ``log_softmax`` of the masked
  logits (``last_logprobs``).
- Batch-wide speculative decoding (``spec_k`` >= 1, with ``draft_cfg``
  and ``draft_params``): each decode iteration is a ROUND
  (``spec_step``). A draft model over a dense slot tensor of its own
  (``serve/kvcache.py`` ``stack_slots``, a counter a lane) drafts k + 1
  tokens for every lane from its pending token; ONE target forward of
  the k + 1 chunk ``[pend, d_1..d_k]`` over the paged pool verifies them
  (B4 at t = k + 1 under ``kv_attend="kernel"``); the accept/emit of
  ``models/spec_decode.py`` ``lane_accept_emit`` runs over all lanes at
  once; each lane's counters in both caches are rewound to its own
  accepted count. Lanes advance 1 to k + 1 tokens a round. Admission
  reserves the k + 1 rows of ``spec_margin`` beyond prompt + steps, so a
  rejected write lands in a block the slot owns. Each lane carries solo
  ``speculative_generate``'s key chain (``split(rng, 5)`` a round), so a
  lane's tokens are the b = 1 solo stream of its seed.

Serving hooks, as the JAX engine has them: ``faults`` (``alloc_exhaust``
in ``plan_admission``, ``step_raise`` and ``step_stall`` in ``step``),
``tag_slot`` (the request id the engine's own ``kv.cow`` spans carry),
``mesh_info``, ``free_block_fraction``, the ``tpu_serve_kv_*`` and
``tpu_serve_spec_*`` gauges and counters, and ``warmup`` (a step or
round over no live lane, run by a server's engine factory so the kernels
are built and loaded before it reports ready).

Disaggregation, prefix pulls and the host KV tier, as the JAX engine has
them (the wire format is ``serve/disagg.py``'s):

- ``ingest_shipment`` lands a verified shipment: blocks allocated, the
  shipped rows written into the pool (``kvcache.pool_write``), the prompt
  registered in the PrefixCache with the shipped logits; a ``ShipHold``
  keeps the blocks until the request's own plan has referenced them
  (``release_shipment``). The plan then exact-hits the prefix and joins
  through the table insert, so shipped decode is bit-identical to local.
- Retention (``prefix_retain_max`` > 0): a completed prompt's exact entry
  keeps one extra reference per block, in a bounded LRU that gives way to
  any admission or ingest short of blocks. ``advertised_prefixes`` and
  ``export_prefix`` (``GET /prefix/<digest>``) serve from it.
- The host tier (``host_tier``, a ``serve/tier.py`` ``HostTier``; None is
  off): every block release goes through ``_free_blocks``, which spills
  the dying exact entries to the tier as wire payloads before anything can
  reallocate their blocks; ``restore_from_tier`` lands the deepest stored
  prefix of a prompt through ``ingest_shipment``.

Every device read or write of these mutates or reads the cache in place,
so a server runs them on its serving loop's thread (the scheduler's
``call_engine``), as it runs the steps.

Tensor and data parallelism (``mesh=``, a ``parallel/mesh.py`` mesh of
``tp`` and ``dp`` over the world's ranks, ``dp`` outer): every rank
builds its tp part of the model (``models/transformer.py``: params sliced
by ``param_sharding_rules`` through ``parallel/sharding.py``'s
``shard_params_by_rules``; an ``int8_decode`` tree stays whole, as in
JAX), the same on every dp shard, and holds its ``KV/tp`` heads of its dp
shard's part of the KV storage (``serve/sharding.py``): the slots
``[i*per, (i+1)*per)`` of shard i, and on the paged engine its tile of the
block pool, which the allocators keep each shard's tables inside. Rank
0's engine is the one a server drives: it alone plans, samples and
answers, and each of its device operations is first sent to the workers
as a command (``serve/tp.py``): a prefill opened, fed or finished, an
admission inserted, a step (its copy-on-write copies, the live mask and
the sampled tokens). Workers run their engines from the commands
(``serve_command``) and never plan. A command that touches a slot, a plan
or a block runs on the owning dp shard's ranks only, its collectives over
their tp group; a step runs on every rank, each dp group's forward over
its own ``per`` lanes. The vocabulary-split head's logits are gathered
over tp, and rank 0 gathers the dp groups' rows from their tp-index-0
ranks (the "dp leaders"): each step's rows by an all-gather, a prefill's
last row by a broadcast from the owning shard's leader. Admission is
global, as JAX's: ``choose_dp_shard`` picks the owning shard before its
prefix lookup and its blocks.

Rows move between rank 0 and a dp shard's pool in one way for every use:

- In (``ship``): an ingest, a host-tier restore and the landing of a
  pull allocate on rank 0 in the extent of the shard that will seat the
  request (``_pick_dp_shard``, as JAX's ingest), check the rows against
  the pool there, and send the block list and the whole rows; each rank
  of that shard writes its own heads (``serve/sharding.py``
  ``ship_heads``) into its tile.
- Out (``export``): an export and a tier spill name the shard whose
  extent holds the entry's blocks; its ranks gather their heads, the tp
  group all-gathers them, and the shard's leader sends the rows to rank
  0, which renders the wire payload.
- A speculative round (``spec``): every rank runs the draft's k + 1
  steps and the k + 1-row verify (B4 under the kernel read) over its
  shard's lanes; rank 0 alone samples, and the drafted tokens and the
  accept counts reach the workers by a broadcast, never drawn there. A
  lane's rewind runs on every rank of its shard. The draft is sliced by
  the target's rules and holds its ``KV/tp`` heads of its shard's slots.

A release inside a device operation queues its dying prefix entries; they
spill when the outermost operation's section closes, before any
allocation (rank 0 allocates only outside a section) can reuse their
blocks.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.models.convert import load_params
from tf_operator_tpu_torch.models.spec_decode import (
    lane_accept_emit,
    spec_margin,
)
from tf_operator_tpu_torch.models.transformer import (
    ChunkedPrefill,
    Transformer,
    TransformerConfig,
    _nucleus_filter,
    _prefill,
    _prefill_extend,
    _validate_prefill_chunk,
    set_cache_index,
)
from tf_operator_tpu_torch.ops.paged_attention import (
    HEAD_DIMS,
    MAX_ROWS,
    paged_attend_supported,
)
from tf_operator_tpu_torch.random import PRNGKey, categorical, gumbel, split
from tf_operator_tpu_torch.runtime.metrics import (
    SERVE_KV_BLOCKS,
    SERVE_KV_COW_TOTAL,
    SERVE_KV_TIER_RESTORES,
    SERVE_MESH_DEVICES,
    SERVE_PHASE_SECONDS,
    SERVE_PREFILL_SAVED_TOTAL,
    SERVE_SHIP_TOKENS_TOTAL,
    SERVE_SPEC_ACCEPT_TOKENS,
    SERVE_SPEC_ROUNDS_TOTAL,
)
from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER
from tf_operator_tpu_torch.serve.constrain import NEG_MASK, ProgramPool
from tf_operator_tpu_torch.serve.faultinject import (
    NULL_INJECTOR,
    InjectedFault,
)
from tf_operator_tpu_torch.serve.kvcache import (
    POOL_KEYS,
    POOL_WIRE_PARTS,
    BlockAllocator,
    PrefixCache,
    SlotAllocator,
    cow_copy,
    dense_insert,
    gather_solo,
    mask_inactive_indices,
    paged_cache_template,
    paged_insert,
    pool_write,
    solo_cache_template,
    stack_slots,
    table_insert,
)
from tf_operator_tpu_torch.serve.sharding import (
    dp_size_of,
    local_block,
    local_pool_blocks,
    shard_of_slot,
    ship_heads,
)


def choose_dp_shard(free_slots, free_blocks, prefix_depths) -> int | None:
    """JAX's dp shard of one paged admission, from per-shard lists: among
    the shards with a free slot, the deepest shard-local prefix, then the
    most free blocks, then the lowest index; None when no shard has a
    free slot (the caller queues)."""
    best = None
    for i, slots in enumerate(free_slots):
        if slots <= 0:
            continue
        key = (prefix_depths[i], free_blocks[i], -i)
        if best is None or key > best[0]:
            best = (key, i)
    return None if best is None else best[1]


def _sample_token(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_p: torch.Tensor,
                  has_top_p: torch.Tensor) -> torch.Tensor:
    """JAX's ``_sample_token`` over all lanes at once: ``logits [N, V]``,
    each lane's key ``[N, 2]`` and sampling parameters ``[N]`` -> ``[N]``
    int32 tokens. A lane at temperature <= 0 takes the argmax; the others
    divide by their temperature (``where(greedy, 1, temp)`` guards the
    division), take the nucleus filter where ``has_top_p`` holds, and
    sample the Gumbel-max over noise of shape ``[1, V]`` from their own
    key, as JAX's vmapped ``categorical(key1, filt[None, :])`` draws it.
    ``logits`` are the MASKED logits: the step adds each slot's constraint
    row (``where(allow_pool[fsm], 0.0, -1e30)``, row 0 the always-allow
    program) before this construction, the op position of the solo
    ``constrained_generate``; +0.0 changes no token of an unconstrained
    lane."""
    greedy = temperature <= 0
    scaled = logits / torch.where(greedy, 1.0, temperature)[:, None]
    scaled = torch.where(has_top_p[:, None],
                         _nucleus_filter(scaled, top_p[:, None]), scaled)
    samp = (gumbel(keys, (1, logits.shape[-1]))[:, 0] + scaled).argmax(-1)
    return torch.where(greedy, logits.argmax(-1), samp).to(torch.int32)


@dataclass
class AdmissionPlan:
    """One reserved admission: shared prefix refcounts bumped and private
    blocks allocated at plan time, so the join cannot fail on capacity."""

    tokens: np.ndarray            # [1, L] int32 prompt
    prompt_len: int
    num_steps: int
    shared_tokens: int = 0        # prefix tokens reused from the cache
    shared_blocks: tuple = ()     # donor blocks we hold a ref on
    private_blocks: tuple = ()    # freshly-allocated blocks (CoW dst incl.)
    read_table: np.ndarray | None = None   # [table_len] int32
    write_table: np.ndarray | None = None  # shared/unused entries -> 0
    cow: tuple | None = None      # (table_entry, dst_block)
    logits: np.ndarray | None = None  # exact-match stored sampling row
    dp_shard: int = 0             # the owning dp shard: its slot slice and
    # (paged) the extent every reserved block lies in
    settled: bool = False         # consumed by a join OR released
    tp_pid: int | None = None     # the workers' open prefill (mesh only)

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens this admission still has to prefill."""
        return self.prompt_len - self.shared_tokens


@dataclass
class ShipHold:
    """The ingest-time hold on a shipment's freshly written blocks: the
    ingest allocates them at refcount 1 and registers the prompt in the
    PrefixCache, and THIS object keeps them (and with them the
    registration) alive until the shipped request's own admission plan has
    referenced them; then ``release_shipment`` drops the hold and the
    blocks live exactly as long as the request, as any local prefix
    donor's do. Empty ``blocks``: the prompt was already registered live
    (a duplicate in flight) and the ingest wrote nothing."""

    blocks: tuple = ()
    tokens: int = 0
    settled: bool = False


class ContinuousEngine:
    """The continuous-batching engine (see the module docstring). Public
    surface: ``plan_admission``/``prefill_planned``/``join_planned`` (and
    ``join``), ``step``, ``retire``, ``release_plan``, ``kv_debug``,
    ``constrain_debug``, ``last_logprobs``.

    ``params`` is a flax-layout tree (``models/convert.py``), cast to
    ``cfg.dtype``. ``kv_attend`` picks the paged read: ``"gather"`` (the
    plain oracle) or ``"kernel"`` (the CUDA kernel on the card, the plain
    version on the CPU). ``prefill_chunk`` runs prefills in chunks of
    that many tokens. ``faults`` is a ``serve/faultinject.py`` injector
    (default: none armed). ``constrain_rows`` sizes the constraint pool
    (row 0 included); ``logprobs_k`` > 0 keeps each step's top-K logprobs.
    ``spec_k`` >= 1 with ``draft_cfg``/``draft_params`` (a flax-layout
    tree) makes it a speculative engine that decodes by ``spec_step``.
    ``kv_paged=False`` picks the dense slot tensor (``kv_block`` and
    ``kv_blocks`` unused). ``device`` defaults to the CUDA card. ``mesh``
    (a mesh of ``tp`` and ``dp`` over the world) makes it rank 0's engine
    of a parallel world, or a worker's on the other ranks (see the module
    docstring); ``params`` is then the whole tree on every rank. At dp > 1
    ``max_slots`` must be a multiple of dp and ``kv_blocks`` is rounded up
    to one, as in JAX."""

    def __init__(self, cfg: TransformerConfig, params, max_slots: int, *,
                 kv_paged: bool = True,
                 kv_block: int = 64, kv_blocks: int | None = None,
                 kv_attend: str = "gather",
                 prefill_chunk: int | None = None, faults: Any = None,
                 constrain_rows: int = 128, logprobs_k: int = 0,
                 spec_k: int = 0, draft_cfg: TransformerConfig | None = None,
                 draft_params=None, device=None, mesh=None) -> None:
        self.mesh = mesh
        self._tp = self._chan = self._dpc = None
        # dp shards (1 without a mesh) and this rank's (rank 0's is 0).
        self._dp, self._dp_index = dp_size_of(mesh), 0
        if mesh is not None:
            from tf_operator_tpu_torch.models.transformer import (
                param_sharding_rules,
            )
            from tf_operator_tpu_torch.parallel.mesh import check_decode_mesh
            from tf_operator_tpu_torch.parallel.sharding import (
                TensorParallel,
                shard_params_by_rules,
            )
            from tf_operator_tpu_torch.serve.tp import channel_for, world_comm

            check_decode_mesh(mesh, "ContinuousEngine(mesh=)")
            if max_slots % self._dp:
                raise ValueError(
                    f"max_slots={max_slots} must be a multiple of the dp "
                    f"mesh axis ({self._dp}): each dp shard owns an equal "
                    "contiguous slot slice")
            self._tp = TensorParallel(mesh, "tp")
            world = world_comm(mesh)
            self._chan = channel_for(world)
            if self._dp > 1:
                # This rank's dp group: the dp leaders' for tp index 0.
                self._dpc = TensorParallel(mesh, "dp")
                self._dp_index = self._dpc.index
            cfg = replace(cfg, decode=True, mesh=mesh)
            # This rank's slices (an int8 tree stays whole, as JAX's).
            params = shard_params_by_rules(
                mesh, params,
                {} if cfg.int8_decode else param_sharding_rules(),
                rank=self._tp.rank)
            if spec_k and draft_params is not None:
                # The draft rides the target's rules, as JAX's (spec
                # refuses an int8 tree, so the draft always splits).
                draft_params = shard_params_by_rules(
                    mesh, draft_params, param_sharding_rules(),
                    rank=self._tp.rank)
        self._next_pid = 0
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        # Per-token logprobs: static at construction, as in JAX (K shapes
        # the step's extra outputs); a request opts in at the scheduler.
        self.logprobs_k = int(logprobs_k or 0)
        if self.logprobs_k < 0 or self.logprobs_k > cfg.vocab_size:
            raise ValueError(
                f"logprobs_k={logprobs_k} must be in [0, vocab_size]"
            )
        if self.logprobs_k and spec_k:
            # A round's accepted tokens reuse draft positions whose target
            # logits the rewind discards: no per-token row to report.
            raise ValueError(
                "logprobs_k is not supported with speculative decoding "
                "(serve it from a plain engine)"
            )
        self.spec_k = int(spec_k or 0)
        self._spec_margin = 0
        self.draft_cfg = draft_cfg
        if self.spec_k:
            _check_spec(cfg, self.spec_k, draft_cfg, draft_params, kv_attend,
                        resolve_device(device))
            self._spec_margin = spec_margin(self.spec_k)
        self.prefill_chunk = prefill_chunk
        self.max_slots = int(max_slots)
        self._per = self.max_slots // self._dp  # slots a dp shard
        self.kv_paged = bool(kv_paged)
        self.kv_block = int(kv_block)
        self.kv_attend = kv_attend
        # Bytes of logits rows rank 0 took from other dp shards' leaders.
        self.logits_bytes = 0
        if self.kv_paged:
            self.table_len = cfg.max_seq_len // self.kv_block
            if kv_blocks is None:
                # Every slot at max length, plus the pinned garbage block.
                kv_blocks = self.max_slots * self.table_len + 1
            if self._dp > 1 and int(kv_blocks) % self._dp:
                # Up to a dp multiple, as JAX: the extents tile the blocks.
                kv_blocks = (int(kv_blocks) + self._dp
                             - int(kv_blocks) % self._dp)
            self.kv_blocks = int(kv_blocks)
            # The config validates kv_attend and the block geometry.
            self.cfg = replace(cfg, decode=True, kv_paged=True,
                               kv_block=self.kv_block,
                               kv_num_blocks=self.kv_blocks,
                               kv_attend=kv_attend)
        else:
            self.table_len = self.kv_blocks = None
            # The config refuses kv_attend="kernel" without a block table.
            self.cfg = replace(cfg, decode=True, kv_paged=False,
                               kv_attend=kv_attend)
        # One module serves both layouts: prefill runs it over a dense
        # cache, the step over the paged pool or the dense slot tensor.
        # This rank's pool is its dp shard's (serve/sharding.py).
        mcfg = self.cfg
        if self.kv_paged and self._dp > 1:
            mcfg = replace(mcfg, kv_num_blocks=local_pool_blocks(
                self._dp_index, self.kv_blocks, self._dp))
        self._model = load_params(Transformer(mcfg, device), params)
        self.device = self._model.device
        self.alloc = SlotAllocator(self.max_slots, dp=self._dp)
        if self.kv_paged:
            self.blocks = BlockAllocator(self.kv_blocks, dp=self._dp)
            self.prefix = PrefixCache(self.kv_block)
            self._cache = paged_cache_template(self._model, self._per)
        else:
            self.blocks = self.prefix = None
            self._cache = stack_slots(solo_cache_template(self._model),
                                      self._per)
        n, dev = self.max_slots, self.device
        self._logits = torch.zeros((n, cfg.vocab_size), dtype=torch.float32,
                                   device=dev)
        self._active = np.zeros(n, bool)
        # Sampling state on the device: each slot's key ladder (key i for
        # its step i), step index and parameters. The host keeps which
        # slots sample, to skip the sampler when no live lane does.
        self._keys = torch.zeros((n, cfg.max_seq_len, 2), dtype=torch.int64,
                                 device=dev)
        self._stepidx = torch.zeros(n, dtype=torch.int64, device=dev)
        self._temperature = torch.zeros(n, dtype=torch.float32, device=dev)
        self._top_p = torch.ones(n, dtype=torch.float32, device=dev)
        self._has_top_p = torch.zeros(n, dtype=torch.bool, device=dev)
        self._rows = torch.arange(n, device=dev)
        self._sampled = np.zeros(n, bool)
        # Constrained decoding: the pool's batch-wide allow/next tables
        # (row 0 the always-allow program) and each slot's FSM row, on the
        # device; the host keeps which program each slot holds.
        self.constrain_pool = ProgramPool(int(constrain_rows),
                                          cfg.vocab_size, device=dev)
        self._fsm = torch.zeros(n, dtype=torch.int32, device=dev)
        self._slot_program: dict[int, str] = {}  # slot -> bound digest
        self._last_logprobs = None  # (chosen, top_vals, top_ids) numpy
        # slot -> {"private": [...], "shared": [...],
        #          "cow": (entry, src, dst) | None}
        self._slot_state: dict[int, dict] = {}
        self.cow_copies = 0
        self.prefill_tokens_saved = 0
        self.steps_total = 0
        # Disaggregated prefill: shipments landed, and the prompt tokens
        # whose K/V arrived as wire rows instead of a local prefill.
        self.shipments_ingested = 0
        self.ship_tokens_ingested = 0
        # Fleet-global prefix reuse: the /healthz advertisement's width and
        # the /prefix/<digest> export count.
        self.prefix_advertise_max = 32
        self.prefix_exports = 0
        # A parallel engine's device sections open now (nested depth), the
        # dying prefix entries a release inside one queued for the tier,
        # and the bytes each rows-moving command moved on this rank: its
        # payload and what its collectives staged through the host.
        self._op_depth = 0
        self._spill_queue: list = []
        self.op_bytes = {"ship": 0, "export": 0, "spec": 0}
        # Prefix retention, 0 = off (every block returns at retire). When
        # > 0, each completed prompt's exact entry keeps one extra pool
        # reference per block past its slot, in a bounded LRU; every
        # retained hold gives way before an admission or an ingest reports
        # the pool exhausted, so retention can delay live work but never
        # starve it. A fleet server turns it on.
        self.prefix_retain_max = 0
        self._retained: dict[bytes, list[int]] = {}
        # The host KV tier (serve/tier.py), None = off: dying exact prefix
        # entries spill to it as wire payloads and admission restores them.
        # Off, the accounting is the tier-less one exactly (kv_debug has no
        # tier section, every spill and restore path returns at once).
        self.host_tier = None
        self.tier_spills = 0
        self.tier_restores = 0
        self.tier_restore_tokens = 0
        self.faults = faults or NULL_INJECTOR
        # Request id per slot (scheduler-set after join): the engine's own
        # spans (CoW copies fire inside step()) name the slot's request.
        self._slot_tags: dict[int, str] = {}
        if self.spec_k:
            self._init_spec(draft_params)
        SERVE_MESH_DEVICES.set(1 if mesh is None else int(mesh.size))
        self._set_block_gauges()
        if self._chan is not None and self._chan.leader:
            # The workers build their engines (a rebuild's fresh pools).
            self._chan.claim(self)

    # -- parallelism: rank 0's commands ------------------------------------

    def _device_op(self, op: str, args=(), payload=None):
        """The section of one device operation: on rank 0 of a parallel
        engine the command goes to the workers first and the channel stays
        held while this rank runs its share; nothing without a mesh."""
        if self._chan is None:
            return contextlib.nullcontext()
        return self._section(op, args, payload)

    @contextlib.contextmanager
    def _section(self, op: str, args, payload):
        """``_device_op`` over a mesh: the command's section, its bytes
        counted (``_count_bytes``) and, once the outermost section closes,
        the prefix entries a release inside it queued spilled to the tier
        (``_free_blocks``)."""
        from tf_operator_tpu_torch.parallel import sharding

        staged = sharding.staged_bytes
        self._op_depth += 1
        try:
            with self._chan.section(self, op, args, payload):
                yield
        finally:
            self._op_depth -= 1
        self._count_bytes(op, payload, staged)
        if not self._op_depth and self._spill_queue:
            dropped, self._spill_queue = self._spill_queue, []
            self._spill_entries(dropped)

    def _count_bytes(self, op: str, payload, staged: int) -> None:
        """Add what command ``op`` moved on this rank to ``op_bytes``: its
        payload's int64 words and the bytes its collectives staged through
        the host since ``staged`` (``parallel/sharding.py``)."""
        from tf_operator_tpu_torch.parallel import sharding

        if op in self.op_bytes:
            words = (0 if payload is None else payload.numel()
                     if isinstance(payload, torch.Tensor)
                     else int(np.size(payload)))
            self.op_bytes[op] += 8 * words + sharding.staged_bytes - staged

    def _mine(self, shard: int) -> bool:
        """Whether this rank holds dp shard ``shard``'s slots and blocks."""
        return shard == self._dp_index

    def _local(self, table):
        """Global block indices as indices of this rank's pool."""
        return local_block(table, self._dp_index, self.kv_blocks, self._dp)

    def _open_prefill(self, tokens: np.ndarray, shared: int, read_table,
                      chunk: int):
        """A prompt's prefill, the same on every rank of the owning dp
        shard: chunked (a ``ChunkedPrefill`` to feed, ``chunk`` > 0) or
        one-shot, run now -> (cache, logits); ``shared`` prompt rows come
        from the pool through ``read_table`` (global entries)."""
        seed = None
        if shared:
            seed = set_cache_index(
                gather_solo(self._cache, self._local(read_table)), shared)
            tokens = tokens[:, shared:]
        if chunk:
            return ChunkedPrefill(self._model, tokens, chunk,
                                  initial_cache=seed, base_index=shared)
        prompt = torch.as_tensor(tokens, device=self.device)
        if shared:
            return _prefill_extend(self._model, seed, prompt)
        return _prefill(self._model, prompt)

    def _prefill_home(self, shard: int, out):
        """A finished prefill's ``(cache, logits)`` as this rank keeps it:
        on rank 0, the last logits of a prefill another dp shard ran, by a
        broadcast from that shard's leader over the dp leaders (every
        leader takes part; the other ranks do not); elsewhere ``out``
        (None where the shard is not this rank's)."""
        if self._dp <= 1 or shard == 0 or self._tp.index != 0:
            return out
        if self._mine(shard):
            buf = out[1].reshape(-1).float().contiguous()
        else:
            buf = torch.empty(self.cfg.vocab_size, dtype=torch.float32,
                              device=self.device)
        self._dpc.broadcast_(buf, src_index=shard)
        if self._mine(shard):
            return out
        if self._dp_index == 0:
            self.logits_bytes += buf.numel() * buf.element_size()
        return None, buf

    def _open_planned(self, plan: AdmissionPlan, chunk: int):
        """Rank 0: ``_open_prefill`` of a plan on its dp shard, the workers
        told first; a one-shot prefill's logits come home at once."""
        pid = None
        payload = None
        shard = plan.dp_shard
        if self._chan is not None:
            self._next_pid += 1
            pid = plan.tp_pid = self._next_pid
            payload = plan.tokens.reshape(-1)
            if plan.shared_tokens:
                payload = np.concatenate([payload, plan.read_table])
        with self._device_op("open", (pid or 0, plan.shared_tokens, chunk,
                                      plan.prompt_len, shard), payload):
            out = None
            if self._mine(shard):
                out = self._open_prefill(plan.tokens, plan.shared_tokens,
                                         plan.read_table, chunk)
            if not chunk:
                out = self._prefill_home(shard, out)
        if chunk and self._chan is not None:
            n_chunks = -(-plan.prefill_tokens // chunk)
            return _TpPrefill(self, pid, shard, out, chunk, n_chunks)
        return out

    def _insert(self, slot: int, exact: bool, index: int, cache,
                write_table, read_table) -> None:
        """Land an admission in ``slot`` of this rank's cache (its dp
        shard's): the dense row, the exact-prefix table, or the paged
        prefill rows and table, the tables' global entries made local."""
        local = slot - self._dp_index * self._per
        if not self.kv_paged:
            dense_insert(self._cache, local, cache)
        elif exact:
            # Exact prefix match: every prompt row already lives in shared
            # blocks, so only the table row and the counter change.
            table_insert(self._cache, local, self._local(read_table), index)
        else:
            paged_insert(self._cache, local, self._local(write_table),
                         self._local(read_table), cache, self.kv_block)

    def _cow(self, slot: int, entry: int, src: int, dst: int) -> None:
        """A copy-on-write on the ranks of ``slot``'s dp shard."""
        if self._mine(shard_of_slot(slot, self.max_slots, self._dp)):
            cow_copy(self._cache, slot - self._dp_index * self._per, entry,
                     self._local(src), self._local(dst))

    def _forward_step(self, toks: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
        """One decode forward of this rank's dp shard's lanes (the live
        mask applied to their counters), then the ``[max_slots, vocab]``
        logits on rank 0: at dp > 1 the dp leaders all-gather their
        shards' rows (the other ranks return their own rows)."""
        lo = self._dp_index * self._per
        mask_inactive_indices(self._cache, active[lo:lo + self._per])
        return self._lanes_forward(self._model, self._cache,
                                   toks[lo:lo + self._per, None])[:, 0]

    def _lanes_forward(self, model, cache, x: torch.Tensor) -> torch.Tensor:
        """``model`` over this rank's dp shard's lanes (``x [per, t]``,
        ``cache`` its shard's), then ``[max_slots, t, vocab]`` logits on
        rank 0: at dp > 1 the dp leaders all-gather their shards' rows
        (the other ranks return their own)."""
        logits = model(x, cache)
        if self._dp <= 1 or self._tp.index != 0:
            return logits
        rows = self._dpc.all_gather(logits, 0)
        if self._dp_index == 0:
            self.logits_bytes += (rows.numel() - logits.numel()) * (
                rows.element_size())
        return rows

    def _spread(self, t: torch.Tensor | None) -> torch.Tensor:
        """Rank 0's ``[max_slots]`` integer vector ``t`` on every rank of
        the world, by a broadcast over it (a worker passes None and gets
        it as int32): the drafted tokens and the accept counts of a
        speculative round, which workers run on and never draw
        themselves. ``t`` itself without a mesh, and on rank 0."""
        if self._chan is None:
            return t
        if t is None:
            buf = torch.empty(self.max_slots, dtype=torch.int64,
                              device=self.device)
        else:
            buf = t.to(torch.int64).contiguous()
        self._chan.tp.broadcast_(buf)
        return buf.to(torch.int32) if t is None else t

    def _worker_cows(self, flat: np.ndarray) -> None:
        """A worker: the copy-on-write copies rank 0 made before a step or
        a round, ``(slot, entry, src, dst)`` each."""
        for slot, entry, src, dst in flat.reshape(-1, 4).tolist():
            self._cow(slot, entry, src, dst)

    def serve_command(self, op: str, args: list, payload: np.ndarray,
                      pending: dict) -> None:
        """A worker rank: run rank 0's command ``op`` on this engine (see
        ``serve/tp.py``); ``pending`` holds its open prefills by id. A
        command of another dp shard is skipped, but for what travels to
        rank 0 (a prefill's logits, exported rows), which every dp leader
        passes on. The rows-moving commands count their bytes
        (``op_bytes``)."""
        from tf_operator_tpu_torch.parallel import sharding

        staged = sharding.staged_bytes
        self._serve_command(op, args, payload, pending)
        self._count_bytes(op, payload, staged)

    def _serve_command(self, op: str, args: list, payload: np.ndarray,
                       pending: dict) -> None:
        with torch.no_grad():
            if op == "open":
                pid, shared, chunk, n, shard = args
                mine, out = self._mine(shard), None
                if mine:
                    tokens = payload[:n].astype(np.int32).reshape(1, n)
                    read = payload[n:].astype(np.int32) if shared else None
                    out = self._open_prefill(tokens, shared, read, chunk)
                if not chunk:
                    out = self._prefill_home(shard, out)
                if mine:
                    pending[pid] = out
            elif op == "feed":
                pid, n, shard = args[:3]
                if self._mine(shard):
                    pending[pid].feed(n)
            elif op == "finish":
                pid, shard = args[:2]
                out = pending[pid].result() if self._mine(shard) else None
                out = self._prefill_home(shard, out)
                if self._mine(shard):
                    pending[pid] = out
            elif op == "drop":
                pending.pop(args[0], None)
            elif op == "insert":
                pid, slot, exact, n = args[:4]
                tables = payload.astype(np.int32)
                prompt = None
                if self.spec_k:
                    # A speculative join's payload ends with its prompt,
                    # the draft's prefill.
                    tables, prompt = tables[:-n], tables[-n:].reshape(1, n)
                prefill = pending.pop(pid, None)
                if self._mine(shard_of_slot(slot, self.max_slots, self._dp)):
                    # The paged payload: the read table alone (exact), or
                    # the write table then the read table.
                    write, read = ((None, tables) if exact
                                   else np.split(tables, 2))
                    self._insert(slot, exact, n, prefill and prefill[0],
                                 write, read)
                    if prompt is not None:
                        self._draft_insert(slot, prompt)
            elif op == "step":
                n = self.max_slots
                data = torch.as_tensor(payload, device=self.device)
                toks, active = data[:n], data[n:2 * n].bool()
                self._worker_cows(payload[2 * n:])
                self._forward_step(toks, active)
            elif op == "spec":
                n = self.max_slots
                data = torch.as_tensor(payload[:2 * n], device=self.device)
                pend, active = data[:n].to(torch.int32), data[n:].bool()
                self._worker_cows(payload[2 * n:])
                self._spec_lanes(pend, active, lambda j, logits: None,
                                 lambda tlogits, drafted: None)
            elif op == "ship":
                shard, cap = args[:2]
                if self._mine(shard):
                    self._write_rows(payload[:cap], self._unpack_rows(
                        payload[cap:], cap * self.kv_block))
            elif op == "export":
                shard, n = args[:2]
                self._export_gather(shard, payload[:n])
            else:
                raise RuntimeError(f"unknown tp command {op!r}")

    def pool_bytes(self) -> int:
        """Bytes of this rank's KV storage (pools or dense rows, with the
        kv8 scales): the per-rank footprint tp divides."""
        return sum(leaf.numel() * leaf.element_size()
                   for layer in self._cache["layers"]
                   for leaf in layer.values())

    # -- batch-wide speculative decode ------------------------------------

    def _init_spec(self, draft_params) -> None:
        """The speculative state: the draft model over a dense slot tensor
        of its own (a counter a lane), and per slot the pending token and
        the key chain (solo ``speculative_generate``'s split-per-round
        schedule: the round count is data, so the chain is state, not a
        precomputed ladder)."""
        n, dev = self.max_slots, self.device
        # Over a mesh the draft runs the target's layout (its slices, its
        # KV/tp heads) over its dp shard's slots.
        dcfg = replace(self.draft_cfg, decode=True, remat=False,
                       kv_paged=False, kv_attend="gather", mesh=self.mesh)
        self._draft_model = load_params(Transformer(dcfg, dev), draft_params)
        self._draft_cache = stack_slots(
            solo_cache_template(self._draft_model), self._per)
        self._pend = torch.zeros(n, dtype=torch.int32, device=dev)
        self._spec_rng = torch.zeros((n, 2), dtype=torch.int64, device=dev)
        self.spec_rounds_total = 0       # rounds with a live lane
        self.spec_lane_rounds_total = 0  # (live slot, round) pairs
        self.spec_tokens_total = 0       # emitted tokens across lanes

    # -- admission planning ----------------------------------------------

    def validate_request(self, prompt_len: int, num_steps: int) -> None:
        """The solo generation budget, the chunked-prefill padding budget
        when chunks are configured, and the whole-pool block budget (a
        request that could never fit must not queue forever)."""
        if num_steps < 1:
            raise ValueError(f"num_steps={num_steps} must be >= 1")
        if prompt_len < 1:
            raise ValueError("prompt must have at least one token")
        margin = self._spec_margin
        if prompt_len + num_steps + margin > self.cfg.max_seq_len:
            with_margin = f" + speculation margin {margin}" if margin else ""
            raise ValueError(
                f"prompt {prompt_len} + steps {num_steps}{with_margin} "
                f"exceeds max_seq_len {self.cfg.max_seq_len}"
            )
        if self.prefill_chunk is not None:
            _validate_prefill_chunk(self.cfg, prompt_len, self.prefill_chunk)
        if not self.kv_paged:
            return
        cap = self._block_cap(prompt_len, num_steps)
        limit = self._max_alloc_blocks()
        if cap > limit:
            where = ("the pool" if self._dp <= 1
                     else "each dp shard's extent")
            raise ValueError(
                f"prompt {prompt_len} + steps {num_steps} needs {cap} KV "
                f"blocks of {self.kv_block}; {where} has only {limit} "
                "allocatable"
            )

    def _max_alloc_blocks(self) -> int:
        """The most blocks one request can ever hold: the allocatable pool,
        or at dp > 1 the widest shard extent (a request lives in one)."""
        if self._dp <= 1:
            return self.kv_blocks - 1
        return max(hi - lo for lo, hi in (self.blocks.shard_extent(i)
                                          for i in range(self._dp)))

    def _shard_free_blocks(self, shard: int | None) -> int:
        """Free blocks of the whole pool (``shard`` None) or of one dp
        shard's extent."""
        if shard is None:
            return self.blocks.free_blocks
        return self.blocks.free_in(shard)

    def _pick_dp_shard(self, tokens) -> int | None:
        """Global admission's dp shard (paged, dp > 1): every shard's
        extent-local prefix depth, probed by ``PrefixCache.peek`` (no
        counter or LRU moves for the shards not chosen), ranked by
        ``choose_dp_shard``. None when no shard has a free slot."""
        dp = self._dp
        depths = [self.prefix.peek(tokens,
                                   within=self.blocks.shard_extent(i))[0]
                  for i in range(dp)]
        return choose_dp_shard([self.alloc.free_in(i) for i in range(dp)],
                               [self.blocks.free_in(i) for i in range(dp)],
                               depths)

    def _block_cap(self, prompt_len: int, num_steps: int) -> int:
        """Table entries one admission reserves: prompt + decode horizon
        plus, on a speculative engine, the k + 1 rows of ``spec_margin``,
        so a rejected speculative write lands in a block the slot owns and
        never in one another lane may be given meanwhile."""
        return -(-(prompt_len + num_steps + self._spec_margin)
                 // self.kv_block)

    def plan_admission(self, tokens, num_steps: int) -> AdmissionPlan | None:
        """Reserve capacity for one request, or None (the caller queues).
        Dense: a free slot. Paged: a free slot AND enough free blocks after
        the shared-prefix credit; a shared partial last block reserves one
        extra private block for its copy-on-write. At dp > 1 the owning
        shard comes first: paged, JAX's ``choose_dp_shard``, then the
        prefix lookup and the blocks within its extent (a donor on another
        shard is a miss); dense, the shard of the lowest free slot, which
        the join then takes as JAX's global acquire would."""
        tokens = np.array(tokens, np.int32)
        n_prompt, n_steps = int(tokens.shape[1]), int(num_steps)
        self.validate_request(n_prompt, n_steps)
        if self.faults.fire("alloc_exhaust") is not None:
            return None  # injected slot/block-pool exhaustion
        if self.alloc.free == 0:
            return None
        if not self.kv_paged:
            shard = next(i for i in range(self._dp) if self.alloc.free_in(i))
            return AdmissionPlan(tokens, n_prompt, n_steps, dp_shard=shard)
        blk = self.kv_block
        cap = self._block_cap(n_prompt, n_steps)
        shard = within = None
        if self._dp > 1:
            shard = self._pick_dp_shard(tokens[0])
            if shard is None:
                return None  # no dp shard has a free slot
            within = self.blocks.shard_extent(shard)
        n, shared, logits = self.prefix.lookup(tokens[0], within=within)
        shared_entries = -(-n // blk)
        cow_needed = n == n_prompt and n % blk != 0
        need = cap - shared_entries + (1 if cow_needed else 0)
        priv = self.blocks.alloc(need, shard=shard)
        if priv is None and self._retained:
            # Pool pressure: retained prefix holds give way to a live
            # admission before the caller is told to queue, sparing the
            # donor this plan shares from.
            self._evict_retained(until_free=need, keep=shared, shard=shard)
            priv = self.blocks.alloc(need, shard=shard)
        if priv is None:
            return None  # block exhaustion: the caller queues
        if n:
            self.blocks.ref(shared)
        cow = None
        tail = list(priv)
        if cow_needed:
            # The CoW destination, reserved now so the copy cannot fail.
            cow = (shared_entries - 1, tail.pop())
        read = np.zeros(self.table_len, np.int32)
        write = np.zeros(self.table_len, np.int32)
        read[:shared_entries] = shared
        read[shared_entries:cap] = tail
        write[shared_entries:cap] = tail
        self._set_block_gauges()
        return AdmissionPlan(
            tokens, n_prompt, n_steps, shared_tokens=n,
            shared_blocks=tuple(shared), private_blocks=tuple(priv),
            read_table=read, write_table=write, cow=cow, logits=logits,
            dp_shard=shard or 0,
        )

    def release_plan(self, plan: AdmissionPlan | None) -> None:
        """Undo a plan's reservations. Idempotent; a no-op for a plan a
        join consumed (its blocks belong to the slot then), and for every
        dense plan (it reserves nothing)."""
        if plan is None or plan.settled:
            return
        if plan.tp_pid is not None:
            pid, plan.tp_pid = plan.tp_pid, None
            with self._device_op("drop", (pid,)):
                pass
        if not self.kv_paged:
            return
        plan.settled = True
        self._free_blocks(
            list(plan.private_blocks) + list(plan.shared_blocks))

    def _free_blocks(self, blks) -> None:
        """THE block release path: drop refcounts, invalidate the prefix
        entries whose last holder just left and, with a host tier, spill
        the dying exact entries into it first. Every release (retire,
        retention eviction, plan and shipment release, a CoW source) goes
        through here, so no prefix vanishes without the tier seeing it.
        Over a mesh a spill is a command, which must not start inside
        another's section: a release there queues its dying entries, and
        the section's close spills them (``_section``)."""
        freed = self.blocks.free(list(blks))
        if freed:
            dropped = self.prefix.invalidate_blocks(freed)
            if dropped and self.host_tier is not None:
                if self._op_depth:
                    self._spill_queue.extend(dropped)
                else:
                    self._spill_entries(dropped)
        self._set_block_gauges()

    # -- the host KV tier (serve/tier.py) ---------------------------------

    def _spill_entries(self, dropped) -> None:
        """Serialize dying prefix entries into the host tier as wire
        payloads. Safe exactly here: the freed blocks are back in the
        allocator's heap, but their pool rows stay intact until a later
        allocation, and the gather and its copy to the host finish before
        this returns (one stream; ``.cpu()`` waits for it). Over a mesh the
        gather is an ``export`` command, run from ``_free_blocks`` or, for
        a release inside a section, when the outermost section closes: in
        both places no allocation has run since the release (rank 0
        allocates only outside a section), and no write of a section lands
        in a freed block (a freed block is in no live table; a retired
        lane's counter is masked to 0). Only exact
        entries (stored sampling logits) spill: an aligned sub-prefix is
        subsumed by its prompt's exact entry (a restore registers the
        whole chain again), and the wire format cannot ship it.
        Best-effort: a failed export drops that entry (its blocks were
        dying anyway) and never breaks the release."""
        from tf_operator_tpu_torch.serve.disagg import export_shipment
        from tf_operator_tpu_torch.serve.tier import payload_nbytes

        t0 = time.monotonic()
        spilled = nbytes = 0
        for e in dropped:
            if e.logits is None:
                continue
            try:
                solo = self._export_rows(e.blocks)
                payload = export_shipment(solo, e.tokens, e.logits,
                                          self.kv_block)
            except Exception:  # noqa: BLE001 — spill is best-effort
                continue
            if self.host_tier.put(payload):
                spilled += 1
                nbytes += payload_nbytes(payload)
        if spilled:
            self.tier_spills += spilled
            t1 = time.monotonic()
            SERVE_TRACER.record("kv.spill", t0, t1, entries=spilled,
                                bytes=nbytes)
            SERVE_PHASE_SECONDS.inc(t1 - t0, phase="tier_spill")

    def restore_from_tier(self, tokens, reserve_steps: int = 0):
        """Deepest-chain host-tier restore for one prompt: find the longest
        stored chain prefix STRICTLY deeper than the live prefix hit,
        decode its payload and land it through ``ingest_shipment``, after
        which ``plan_admission`` finds the restored prefix as if it had
        never left the pool (table-insert join, bit-identical decode).

        Returns ``(hold, outcome)``: ``(ShipHold, "ok")``, whose hold the
        caller releases once its plan holds references; ``(None,
        "exhausted")``, a restorable entry exists but the pool cannot hold
        prompt + ``reserve_steps`` (the can-restore wait: the caller
        requeues knowing that capacity, not recompute, is what it waits
        for); ``(None, "miss")``, nothing stored deeper than what the pool
        already shares; ``(None, "failed")``, the stored payload no longer
        decodes (dropped as poison; a local prefill serves the request).
        Never raises. Runs on the serving loop's thread, as every device
        write does. A dense engine has nothing to restore into: a miss."""
        from tf_operator_tpu_torch.serve.disagg import (
            chain_digests,
            decode_shipment,
        )
        from tf_operator_tpu_torch.serve.tier import payload_nbytes

        if self.host_tier is None or not self.kv_paged:
            return None, "miss"
        tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        n_tok, blk = int(tokens.shape[0]), self.kv_block
        chain = chain_digests(tokens, blk)  # hex, shortest first
        lengths = [(k + 1) * blk for k in range(n_tok // blk)]
        if n_tok % blk:
            lengths.append(n_tok)
        n_live, _, live_logits = self.prefix.lookup(tokens)
        if n_live == n_tok and live_logits is not None:
            return None, "miss"  # already hot: the plan exact-joins
        t0 = time.monotonic()
        outcome = "miss"
        for length, hx in zip(reversed(lengths), reversed(chain)):
            if length <= n_live:
                break  # the pool already shares this deep: nothing to gain
            payload = self.host_tier.get(hx)
            if payload is None:
                continue
            try:
                shp = decode_shipment(payload)
                # Budget the WHOLE request, not just the stored prefix: the
                # plan that follows still needs blocks for the un-restored
                # prompt tail and the decode horizon.
                hold = self.ingest_shipment(
                    shp, reserve_steps=int(reserve_steps) + (n_tok - length),
                    _source="tier")
            except Exception:  # noqa: BLE001 — poison payload: drop it;
                # a local prefill serves the request.
                self.host_tier.discard(hx)
                outcome = "failed"
                break
            if hold is None:
                outcome = "exhausted"
                break
            self.tier_restores += 1
            self.tier_restore_tokens += length
            t1 = time.monotonic()
            SERVE_TRACER.record("kv.restore", t0, t1, tokens=length,
                                blocks=len(hold.blocks), digest=hx[:12],
                                bytes=payload_nbytes(payload))
            SERVE_PHASE_SECONDS.inc(t1 - t0, phase="tier_restore")
            SERVE_KV_TIER_RESTORES.inc(outcome="ok")
            return hold, "ok"
        SERVE_KV_TIER_RESTORES.inc(outcome=outcome)
        return None, outcome

    def tier_probe(self, tokens) -> bool:
        """Could a queued prompt restore from the host tier? A host-side
        membership probe (no LRU change, no device work): the
        block-exhaustion requeue's must-wait vs can-restore, safe from any
        thread."""
        if self.host_tier is None or not self.kv_paged:
            return False
        from tf_operator_tpu_torch.serve.disagg import chain_digests

        tokens = np.asarray(tokens, np.int32).reshape(-1)
        return self.host_tier.deepest(
            chain_digests(tokens, self.kv_block)) is not None

    def advertised_tier_prefixes(self) -> list[str]:
        """Hex digests of the warmest host-tier payloads, MRU first, under
        the hot advertisement's ``prefix_advertise_max`` cap: the /healthz
        ``tier_prefixes`` list. Empty without a tier, and dense."""
        if self.host_tier is None or not self.kv_paged:
            return []
        return self.host_tier.advertise(self.prefix_advertise_max)

    # -- prefix retention ---------------------------------------------------

    def _retain_prefix(self, tokens) -> None:
        """Pin a just-registered prompt's EXACT prefix entry past its slot:
        one extra pool reference per block, recorded in the bounded
        ``_retained`` LRU. A duplicate prompt refreshes recency without a
        second reference (first writer wins keeps the entry's blocks). A
        no-op unless retention is on."""
        if self.prefix_retain_max <= 0:
            return
        hold = self.prefix.exact_hold(tokens)
        if hold is None:
            return
        key, blks = hold
        old = self._retained.pop(key, None)
        if old is not None:
            self._retained[key] = old
            return
        self.blocks.ref(blks)
        self._retained[key] = list(blks)
        self._evict_retained()

    def _evict_retained(self, until_free: int | None = None,
                        keep=(), shard: int | None = None) -> None:
        """Drop retained prefix holds, oldest first: down to the
        ``prefix_retain_max`` cap (no argument), or until the pool (dp
        shard ``shard``'s extent, when given) has ``until_free`` free
        blocks (admission or ingest pressure). Holds overlapping ``keep``
        (the donor an in-flight plan shares from) are spared."""
        keep = set(int(b) for b in keep)
        for key in list(self._retained):
            if until_free is None:
                if len(self._retained) <= max(0, int(self.prefix_retain_max)):
                    break
            elif self._shard_free_blocks(shard) >= until_free:
                break
            blks = self._retained[key]
            if keep and not keep.isdisjoint(blks):
                continue
            del self._retained[key]
            self._free_blocks(blks)

    # -- shipped-KV ingest (disaggregated prefill) ---------------------------

    def ingest_shipment(self, shp: Any, reserve_steps: int = 0,
                        _source: str = "ship") -> ShipHold | None:
        """Land one verified shipment (``serve/disagg.py`` ``Shipment``) in
        the block pool: allocate ``ceil(L/B)`` blocks, write the shipped
        rows into them, and register the prompt (blocks and the shipped
        last-position logits) in the PrefixCache, after which the request's
        own ``plan_admission`` finds an EXACT prefix match and joins through
        the table insert, bit-identical to a local exact-prefix hit.
        Returns None on block exhaustion (the caller requeues, as on a plan
        miss). Raises ValueError on a geometry mismatch (another kv_block,
        row shapes, layers or parts): the caller falls back to a local
        prefill.

        ``reserve_steps`` is the request's decode horizon: the ingest
        refuses (None) while the pool cannot hold prompt + steps, because a
        shipment the plan cannot use yet would be written, released and
        written again once a loop iteration until capacity frees.

        The decode step is untouched (``decode_step_compiles`` does not
        change). kv_int8 pools ingest too: ``_ship_rows`` derives the parts
        a layer needs from the LIVE pool leaves, so a kv8 engine refuses a
        shipment without scales and a bf16 or f32 one a shipment with them,
        both as ValueError, never a partial write.

        A dense engine answers None without looking at the shipment: it has
        no pool to land rows in, and the caller prefills locally."""
        if not self.kv_paged:
            return None
        if int(shp.kv_block) != self.kv_block:
            raise ValueError(
                f"shipment kv_block={shp.kv_block} != engine "
                f"kv_block={self.kv_block}"
            )
        tokens = np.asarray(shp.tokens, np.int32).reshape(-1)
        n_tok, blk = int(tokens.shape[0]), self.kv_block
        cap = -(-n_tok // blk)
        limit = self._max_alloc_blocks()
        if cap > limit:
            where = ("the pool" if self._dp <= 1
                     else "each dp shard's extent")
            raise ValueError(
                f"shipment of {n_tok} tokens needs {cap} blocks; {where} "
                f"has only {limit} allocatable"
            )
        n, _, logits = self.prefix.lookup(tokens)
        if n == n_tok and logits is not None:
            # Already registered live (a duplicate prompt in flight):
            # nothing to write; admission exact-hits the existing entry. An
            # empty hold keeps release idempotent.
            return ShipHold((), n_tok, settled=True)
        shard = None
        if self._dp > 1:
            # The dp shard that will SEAT the request, by the policy
            # plan_admission runs, so its plan finds the prefix inside its
            # own shard's extent (JAX's ingest).
            shard = self._pick_dp_shard(tokens)
            if shard is None:
                return None  # no dp shard has a free slot: requeue
        # The whole request's budget, not just the shipment's: the plan
        # that follows also needs the decode horizon's blocks (and the CoW
        # destination when the prompt ends mid-block).
        need = -(-(n_tok + int(reserve_steps)) // blk)
        if n_tok % blk:
            need += 1
        if self._shard_free_blocks(shard) < need and self._retained:
            self._evict_retained(until_free=need, shard=shard)
        if self._shard_free_blocks(shard) < need:
            return None  # pool exhaustion: the caller requeues
        blocks = self.blocks.alloc(cap, shard=shard)
        if blocks is None:
            return None
        try:
            # Checked against the pool before any rank writes.
            rows = self._ship_rows(shp, cap * blk)
            self._land_rows(blocks, rows, shard or 0)
        except Exception:
            self._free_blocks(blocks)
            raise
        self.prefix.register(tokens, blocks,
                             np.asarray(shp.logits, np.float32))
        self._retain_prefix(tokens)
        if _source == "ship":
            # A host-tier restore reuses this path but is not a shipment:
            # it keeps its own counters (tier_restores).
            self.shipments_ingested += 1
            self.ship_tokens_ingested += n_tok
            SERVE_SHIP_TOKENS_TOTAL.inc(n_tok)
        self._set_block_gauges()
        return ShipHold(tuple(blocks), n_tok)

    def _ship_rows(self, shp: Any, cap_rows: int) -> list[dict]:
        """The shipped rows by layer as ``{pool leaf: tensor}``, checked
        against the pool: the JAX engine's ``_padded_ship_rows`` without
        the padding (``pool_write`` moves only the shipment's rows). The
        parts a layer needs come from its LIVE pool leaves
        (``POOL_WIRE_PARTS``): K/V rows always, the f32 scales exactly when
        the pool is kv_int8. A shipment that does not match the pool's
        quantization is a geometry error, never a partial write."""
        from tf_operator_tpu_torch.serve.disagg import layer_path

        # wire path -> wire part -> (pool leaf, its per-row trailing shape:
        # (KV, Dh) for K/V, (KV,) for the scales; every KV head, also where
        # a tp rank's pool holds its part of them)
        kv = self.cfg.kv_heads
        want = {
            layer_path(i): {POOL_WIRE_PARTS[name]: (name, (kv,) + tuple(
                leaf.shape[3:])) for name, leaf in layer.items()
                            if name in POOL_WIRE_PARTS}
            for i, layer in enumerate(self._cache["layers"])
        }
        # Every layer must be covered: a partial shipment would decode
        # garbage for the missing layers.
        if set(shp.rows) != set(want):
            raise ValueError(
                f"shipment covers layers {sorted(shp.rows)} but the engine "
                f"has {sorted(want)}"
            )
        out = []
        for path, parts in want.items():
            if set(shp.rows[path]) != set(parts):
                raise ValueError(
                    f"shipment rows {path} carry parts "
                    f"{sorted(shp.rows[path])} but the pool needs "
                    f"{sorted(parts)} (kv-int8 pools require the scale "
                    f"sidecars; bf16 pools reject them)"
                )
            layer = {}
            for part, (name, trail) in parts.items():
                arr = torch.as_tensor(shp.rows[path][part])
                if tuple(arr.shape) != (cap_rows,) + trail:
                    raise ValueError(
                        f"shipped rows {path}:{part} shape "
                        f"{tuple(arr.shape)} != {(cap_rows,) + trail}"
                    )
                layer[name] = arr
            out.append(layer)
        return out

    def _row_leaves(self) -> list[tuple[int, str]]:
        """(layer, pool leaf) of every shipped part, in one order on every
        rank: the order rows travel in a ``ship`` command."""
        return [(i, name) for i, layer in enumerate(self._cache["layers"])
                for name in layer if name in POOL_WIRE_PARTS]

    def _land_rows(self, blocks, rows: list[dict], shard: int) -> None:
        """Write checked, whole-head shipped rows into ``blocks`` (global
        indices in dp shard ``shard``'s extent). Over a mesh, the ``ship``
        command first carries the block list and the rows, cast to the
        pool's dtypes, to every rank; the shard's ranks write their own
        heads."""
        if self._chan is None:
            self._write_rows(blocks, rows)
            return
        order = self._row_leaves()
        rows = [{name: t.to(self._cache["layers"][i][name].dtype)
                 for name, t in layer.items()}
                for i, layer in enumerate(rows)]
        flat = _pack([rows[i][name].cpu() for i, name in order])
        payload = np.concatenate([np.asarray(blocks, np.int64),
                                  _words(flat)])
        with self._device_op("ship", (shard, len(blocks)), payload):
            if self._mine(shard):
                self._write_rows(blocks, rows)

    def _unpack_rows(self, words: np.ndarray, n_rows: int) -> list[dict]:
        """A worker: the whole-head rows of a ``ship`` payload's words."""
        order = self._row_leaves()
        like = [((n_rows, self.cfg.kv_heads)
                 + tuple(self._cache["layers"][i][name].shape[3:]),
                 self._cache["layers"][i][name].dtype) for i, name in order]
        raw = torch.from_numpy(
            np.ascontiguousarray(words).view(np.uint8).copy())
        rows: list[dict] = [{} for _ in self._cache["layers"]]
        for (i, name), t in zip(order, _unpack(raw, like)):
            rows[i][name] = t
        return rows

    def _write_rows(self, blocks, rows: list[dict]) -> None:
        """``pool_write`` of whole-head rows into ``blocks`` of this rank's
        pool: the tile's local blocks, and under tp its own heads
        (``serve/sharding.py`` ``ship_heads``)."""
        table = np.zeros(self.table_len, np.int64)
        table[:len(blocks)] = np.asarray(blocks, np.int64)
        if self._tp is not None and self._tp.size > 1:
            wire = {i: {POOL_WIRE_PARTS[name]: t
                        for name, t in layer.items()}
                    for i, layer in enumerate(rows)}
            mine = ship_heads(wire, self._tp.size, self._tp.index)
            leaf = {part: name for name, part in POOL_WIRE_PARTS.items()}
            rows = [{leaf[part]: t for part, t in mine[i].items()}
                    for i in range(len(rows))]
        with torch.no_grad():
            pool_write(self._cache, self._local(table), rows, self.kv_block)

    def _dense_like(self, n_rows: int, heads: int) -> list[tuple]:
        """(layer, dense leaf, shape, dtype) of every leaf of a solo dense
        cache of ``n_rows`` rows at ``heads`` KV heads, as ``gather_solo``
        lays them out."""
        return [(i, POOL_KEYS[p], (1, n_rows, heads) + tuple(leaf.shape[3:]),
                 leaf.dtype)
                for i, layer in enumerate(self._cache["layers"])
                for p, leaf in layer.items() if p in POOL_KEYS]

    def _export_gather(self, shard: int, blocks) -> torch.Tensor | None:
        """Every rank's share of an ``export`` of ``blocks`` (global, in dp
        shard ``shard``'s extent): the shard's ranks gather their heads of
        the rows (``gather_solo`` over their tile) and all-gather them
        over tp; then, where the shard is not rank 0's, its leader sends
        them to rank 0 by a broadcast over the dp leaders, as a prefill's
        last row goes. Returns the whole rows as one byte vector on rank 0
        (and on the shard's ranks), else None."""
        n_rows = len(blocks) * self.kv_block
        flat = None
        if self._mine(shard):
            with torch.no_grad():
                solo = gather_solo(self._cache, self._local(
                    np.asarray(blocks, np.int64)))
            local = self._dense_like(n_rows, self._model.kv_heads)
            flat = _pack([solo["layers"][i][d] for i, d, _, _ in local])
            if self._model.kv_heads < self.cfg.kv_heads:  # split over tp
                every = self._tp.all_gather(flat[None], 0)
                parts = [_unpack(row, [(shape, dt) for *_, shape, dt
                                       in local]) for row in every]
                flat = _pack([torch.cat([p[j] for p in parts], 2)
                              for j in range(len(local))])
        if self._dp <= 1 or shard == 0 or self._tp.index != 0:
            return flat
        if not self._mine(shard):
            nbytes = sum(math.prod(shape) * _itemsize(dt) for *_, shape, dt
                         in self._dense_like(n_rows, self.cfg.kv_heads))
            flat = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        self._dpc.broadcast_(flat, src_index=shard)
        return flat

    def _shard_of_block(self, block: int) -> int:
        """The dp shard whose extent holds global block ``block``."""
        for i in range(self._dp):
            lo, hi = self.blocks.shard_extent(i)
            if lo <= block < hi:
                return i
        return 0

    def _export_rows(self, blocks) -> dict:
        """The solo dense cache (whole heads, counter 0) of an entry's
        ``blocks``: ``gather_solo`` here, or over a mesh the ``export``
        command to the shard whose extent holds them."""
        blocks = np.asarray(blocks, np.int64)
        if self._chan is None:
            with torch.no_grad():
                return gather_solo(self._cache, blocks)
        shard = self._shard_of_block(int(blocks[0]))
        with self._device_op("export", (shard, len(blocks)), blocks):
            flat = self._export_gather(shard, blocks)
        like = self._dense_like(len(blocks) * self.kv_block,
                                self.cfg.kv_heads)
        layers: list[dict] = [{} for _ in self._cache["layers"]]
        for (i, d, _, _), t in zip(like, _unpack(flat, [
                (shape, dt) for *_, shape, dt in like])):
            layers[i][d] = t
        return {"layers": layers, "cache_index": 0}

    def release_shipment(self, hold: ShipHold | None) -> None:
        """Drop the ingest-time hold (idempotent): after the shipped
        request's plan has referenced its blocks, or on any error path
        before that. Blocks whose refcount hits zero return to the pool and
        invalidate their prefix entries, the retire bookkeeping."""
        if hold is None or hold.settled or not self.kv_paged:
            return
        hold.settled = True
        self._free_blocks(list(hold.blocks))

    # -- fleet-global prefix reuse --------------------------------------------

    def advertised_prefixes(self) -> list[str]:
        """Hex digests of the hottest PrefixCache entries, MRU first,
        capped at ``prefix_advertise_max``: the /healthz advertisement a
        fleet router scores prefix hits from. A host-side read under the
        PrefixCache's lock, safe from any thread. Empty on a dense engine
        (no prefix cache)."""
        if not self.kv_paged:
            return []
        return self.prefix.advertise(self.prefix_advertise_max)

    def export_prefix(self, digest_hex: str) -> dict:
        """The replica side of a cross-replica prefix pull (``GET
        /prefix/<digest>``): the live EXACT PrefixCache entry under
        ``digest_hex`` as the shipped-KV wire payload, its blocks gathered
        back into the dense row layout (``gather_solo``) and rendered by
        ``disagg.export_shipment``, so the puller lands it through the
        ordinary ``ingest_shipment`` and exact-prefix table insert,
        bit-identical to decoding here. A digest that is no longer (or was
        never) hot may still sit in the host tier, which stores the same
        payload: it answers from there, with no device work.

        Raises the typed ``PrefixNotFound`` when the digest names no live
        exact entry (a stale advertisement: the blocks were freed, or the
        digest was only ever a longer prompt's aligned prefix, which has no
        sampling logits to ship). The entry is checked again after the
        gather, so one that left meanwhile is the typed miss, never rows of
        reused blocks. Runs on the serving loop's thread (the scheduler's
        ``call_engine``). A dense engine holds no prefix: always the typed
        miss."""
        from tf_operator_tpu_torch.serve.disagg import export_shipment
        from tf_operator_tpu_torch.serve.resilience import PrefixNotFound

        if not self.kv_paged:
            raise PrefixNotFound("dense engine holds no prefix blocks")
        entry = self.prefix.entry_for_hex(digest_hex)
        if entry is None:
            payload = self._tier_export(digest_hex)
            if payload is not None:
                return payload
            raise PrefixNotFound(
                f"no live exact prefix entry for {digest_hex[:12]}"
            )
        tokens, _, blocks, logits = entry
        solo = self._export_rows(blocks)
        again = self.prefix.entry_for_hex(digest_hex)
        if again is None or tuple(again[2]) != tuple(blocks):
            # A release racing this export spilled the entry (the free path
            # goes through the tier), so the tier may still answer.
            payload = self._tier_export(digest_hex)
            if payload is not None:
                return payload
            raise PrefixNotFound(
                f"prefix entry {digest_hex[:12]} retired mid-export"
            )
        payload = export_shipment(solo, tokens, logits, self.kv_block)
        self.prefix_exports += 1
        return payload

    def _tier_export(self, digest_hex: str) -> dict | None:
        """The host tier's stored payload for an export, or None."""
        if self.host_tier is None:
            return None
        payload = self.host_tier.get(digest_hex)
        if payload is not None:
            self.prefix_exports += 1
        return payload

    # -- joins --------------------------------------------------------------

    def prefill_planned(self, plan: AdmissionPlan) -> ChunkedPrefill | None:
        """The resumable prefill a planned admission still needs, or None
        when there is nothing to feed: an exact prefix match (the plan
        carries the sampling logits), an engine without ``prefill_chunk``
        (the prefill runs inside ``join_planned``), or a shared suffix
        whose chunk padding would not fit the cache (one-shot)."""
        if plan.prefill_tokens == 0 or self.prefill_chunk is None:
            return None
        if plan.shared_tokens:
            padded = (-(-plan.prefill_tokens // self.prefill_chunk)
                      * self.prefill_chunk)
            if plan.shared_tokens + padded > self.cfg.max_seq_len:
                return None
        # Validated before any command goes out: a refused chunking opens
        # nothing on the workers.
        _validate_prefill_chunk(self.cfg, plan.prefill_tokens,
                                self.prefill_chunk, base=plan.shared_tokens)
        return self._open_planned(plan, self.prefill_chunk)

    def join(self, prompt, *, num_steps: int, temperature: float = 0.0,
             top_p: float | None = None, seed: int = 0,
             program: Any = None) -> int | None:
        """Plan, prefill and join in one call: the slot index, or None
        when slots, blocks or constraint rows are short."""
        plan = self.plan_admission(prompt, num_steps)
        if plan is None:
            return None
        try:
            pf = self.prefill_planned(plan)
            if pf is not None:
                pf.feed(pf.n_chunks)
        except Exception:
            self.release_plan(plan)
            raise
        return self.join_planned(plan, pf, temperature=temperature,
                                 top_p=top_p, seed=seed, program=program)

    def join_planned(self, plan: AdmissionPlan,
                     pf: ChunkedPrefill | None = None, *,
                     temperature: float = 0.0, top_p: float | None = None,
                     seed: int = 0, program: Any = None) -> int | None:
        """Complete a planned admission: collect or run whatever prefill
        the plan still needs (``pf`` is ``prefill_planned``'s, fed to the
        end by the caller), insert into a free slot with its sampling
        state, and register the prompt's blocks for later sharers. On an
        error, the bad sampling parameters included, the plan is released
        and no slot state is written.

        ``program`` is an optional ``CompiledProgram``: its rows bind into
        the constraint pool here; a bind that cannot fit (every resident
        program still referenced) releases the plan and returns None."""
        try:
            _check_sampling(temperature, top_p)
            with torch.no_grad():
                if pf is not None:
                    cache, logits = pf.result()
                elif plan.prefill_tokens == 0:
                    cache = None
                    logits = torch.as_tensor(plan.logits, device=self.device)
                else:
                    cache, logits = self._open_planned(plan, 0)
        except Exception:
            self.release_plan(plan)
            raise
        return self._join_slot(plan, cache, logits, temperature, top_p,
                               seed, program)

    def _set_sampling(self, slot: int, num_steps: int, temperature: float,
                      top_p: float | None, seed: int) -> None:
        """The slot's sampling state, as JAX's ``_sampling_state`` builds
        it: at temperature > 0 the key ladder is solo ``generate``'s
        ``split(PRNGKey(seed), num_steps)`` (zeros past it, and all zeros
        for a greedy lane); the step index restarts at 0."""
        self._keys[slot].zero_()
        if temperature > 0 and not self.spec_k:
            # A speculative lane carries its key chain instead
            # (``_join_spec_state``).
            self._keys[slot, :num_steps] = split(
                PRNGKey(seed, self.device), num_steps)
        self._stepidx[slot] = 0
        self._temperature[slot] = max(0.0, float(temperature))
        self._top_p[slot] = 1.0 if top_p is None else float(top_p)
        self._has_top_p[slot] = top_p is not None
        self._sampled[slot] = temperature > 0

    def _join_slot(self, plan: AdmissionPlan, cache: dict | None,
                   logits: torch.Tensor, temperature: float,
                   top_p: float | None, seed: int,
                   program: Any = None) -> int | None:
        """Land a prefilled admission in a free slot: bind its program,
        insert its rows (dense: the whole row of the slot tensor, JAX's
        ``join_prefilled``; paged: the plan's blocks and table), seed the
        logits, sampling and speculative state, and, paged, hand the
        plan's blocks to the slot and register its prompt."""
        base = None
        if program is not None:
            base = self.constrain_pool.bind(program)
            if base is None:
                # Constraint-pool saturation: the requeue contract of
                # block exhaustion.
                self.release_plan(plan)
                return None
        # At dp > 1 the slot comes from the plan's shard: its tables may
        # reference only that shard's blocks.
        slot = self.alloc.acquire(
            shard=plan.dp_shard if self._dp > 1 else None)
        if slot is None:  # the single-caller contract makes this unreachable
            if program is not None:
                self.constrain_pool.release(program.digest)
            self.release_plan(plan)
            return None
        pid, plan.tp_pid = plan.tp_pid, None
        exact = plan.prefill_tokens == 0
        payload = None
        if self._chan is not None:
            parts = []
            if self.kv_paged:
                parts = ([plan.read_table] if exact else
                         [plan.write_table, plan.read_table])
            if self.spec_k:
                parts.append(plan.tokens.reshape(-1))  # the draft's prompt
            payload = np.concatenate(parts) if parts else None
        with self._device_op("insert", (pid or 0, slot, exact,
                                        plan.prompt_len), payload):
            if self._mine(plan.dp_shard):
                self._insert(slot, exact, plan.prompt_len, cache,
                             plan.write_table, plan.read_table)
                if self.spec_k:
                    self._draft_insert(slot, plan.tokens)
        row = logits.reshape(-1).float()
        self._logits[slot] = row
        self._set_sampling(slot, plan.num_steps, temperature, top_p, seed)
        if self.spec_k:
            self._join_spec_state(slot, row, temperature, top_p, seed,
                                  program, base)
        elif program is not None:
            # Prompt tokens are unconstrained: the slot enters at the
            # program's start state and the mask applies from the first
            # GENERATED token, the solo oracle's convention.
            self._fsm[slot] = base
        if program is not None:
            self._slot_program[slot] = program.digest
        self._active[slot] = True
        plan.settled = True  # the blocks now belong to the slot
        if not self.kv_paged:
            return slot
        cow = None
        if plan.cow is not None:
            entry, dst = plan.cow
            cow = (entry, int(plan.read_table[entry]), dst)
        self._slot_state[slot] = {
            "private": list(plan.private_blocks),
            "shared": list(plan.shared_blocks),
            "cow": cow,
        }
        # Prompt rows only: generated tokens never enter the registry. The
        # stored row lets an exact re-admission skip prefill.
        prompt_blocks = plan.read_table[: -(-plan.prompt_len // self.kv_block)]
        self.prefix.register(plan.tokens[0], prompt_blocks,
                             row.cpu().numpy())
        self._retain_prefix(plan.tokens[0])
        self.prefill_tokens_saved += plan.shared_tokens
        if plan.shared_tokens:
            SERVE_PREFILL_SAVED_TOTAL.inc(plan.shared_tokens)
        return slot

    # -- decode -------------------------------------------------------------

    def _run_pending_cows(self) -> list:
        """Copy-on-write for every active slot about to take its first
        decode write into a shared partial block, before that step.
        Returns the copies made, ``(slot, entry, src, dst)`` each (a tp
        step sends them to the workers)."""
        done = []
        for slot, st in self._slot_state.items():
            if st["cow"] is None or not self._active[slot]:
                continue
            entry, src, dst = st["cow"]
            t0 = time.monotonic()
            self._cow(slot, entry, src, dst)
            done.append((slot, entry, src, dst))
            t1 = time.monotonic()
            # Host-side span around the enqueued copy; the tag names the
            # owner.
            SERVE_TRACER.record(
                "kv.cow", t0, t1, request_id=self._slot_tags.get(slot, ""),
                slot=slot, src_block=src, dst_block=dst,
            )
            SERVE_PHASE_SECONDS.inc(t1 - t0, phase="cow")
            st["cow"] = None
            st["shared"].remove(src)
            self._free_blocks([src])
            self.cow_copies += 1
            SERVE_KV_COW_TOTAL.inc()
        return done

    def step(self) -> np.ndarray:
        """One decode iteration over ALL slots: every active slot advances
        one token. Returns the ``[max_slots]`` int32 tokens (inactive
        rows are dead compute: ignore them). The fault points fire first,
        as in the JAX engine: ``step_raise`` raises ``InjectedFault``,
        ``step_stall`` sleeps its argument (default 1 s)."""
        if self.spec_k:
            raise RuntimeError(
                "speculative engines decode via spec_step() (rounds emit "
                "between 1 and k+1 tokens per slot)"
            )
        self._fire_step_faults()
        return self._step()

    def spec_step(self) -> tuple[np.ndarray, np.ndarray]:
        """One speculative ROUND over all slots: draft k + 1 tokens a lane,
        verify the k + 1 chunk in one batched target forward, accept and
        rewind each lane. Returns ``(toks, counts)``: ``toks
        [max_slots, k + 1]`` int32, of which row i's first ``counts[i]``
        are slot i's new tokens (its pending token and its accepted
        prefix; 1 <= counts <= k + 1 on a live lane, 0 on an inactive
        one). The caller trims each window to its request's budget. The
        fault points and pending copy-on-writes run first, as in
        ``step``."""
        if not self.spec_k:
            raise RuntimeError("spec_step() needs an engine built with "
                               "spec_k >= 1")
        self._fire_step_faults()
        toks, counts = self._spec_round()
        if self._active.any():
            emitted = counts[self._active]
            self.spec_rounds_total += 1
            self.spec_lane_rounds_total += len(emitted)
            self.spec_tokens_total += int(emitted.sum())
            SERVE_SPEC_ROUNDS_TOTAL.inc()
            for c in emitted:
                SERVE_SPEC_ACCEPT_TOKENS.observe(float(c))
        return toks, counts

    def _fire_step_faults(self) -> None:
        if self.faults.fire("step_raise") is not None:
            raise InjectedFault("step_raise")
        self.faults.maybe_sleep("step_stall", default=1.0)

    def warmup(self) -> None:
        """One step (a round, on a speculative engine) over no live lane
        (no fault point fires), then the step count back at 0: on the card
        it builds or loads every kernel the step launches and runs each
        once, so a server's first request pays neither. The JAX engine
        warms its compiled step in its constructor; this one is called by
        the caller that wants it. Inactive lanes' writes land in the
        pinned garbage block (paged) or their own rows (the draft, the
        dense slot tensor), and every join overwrites its lane's logits,
        rows and pending token, so no later token changes."""
        if self._active.any():
            raise RuntimeError("warmup() runs before any join")
        if self.spec_k:
            self._spec_round()
        else:
            self._step()
        self.steps_total = 0

    def _step(self) -> np.ndarray:
        cows = self._run_pending_cows()
        with torch.no_grad():
            active = torch.as_tensor(self._active, device=self.device)
            masked = self._mask(self._logits)
            if self._sampled[self._active].any():
                toks = self._sample(masked)
            else:
                toks = masked.argmax(-1).to(torch.int32)
            self._advance(toks)
            if self.logprobs_k:
                lp = self._logprob_outputs(masked, toks)
            payload = None
            if self._chan is not None:
                payload = torch.cat([
                    toks.long(), active.long(),
                    torch.as_tensor(np.asarray(cows, np.int64).reshape(-1),
                                    device=self.device)])
            with self._device_op("step", (len(cows),), payload):
                self._logits = self._forward_step(toks, active)
        if self.logprobs_k:
            self._last_logprobs = tuple(x.cpu().numpy() for x in lp)
        self.steps_total += 1
        return toks.cpu().numpy()

    def _mask(self, logits: torch.Tensor) -> torch.Tensor:
        """The batch-wide constraint gather: each slot's allow row (row 0
        = always-allow) as an additive mask, before temperature — the solo
        ``constrained_generate`` op order; +0.0 for unconstrained lanes."""
        allow = self.constrain_pool.allow_pool[self._fsm.long()]
        return logits + torch.where(allow, 0.0, NEG_MASK)

    def _advance(self, toks: torch.Tensor) -> None:
        """Each slot's FSM row through its sampled token, on the device
        (``next_pool[fsm, toks]``, int32)."""
        self._fsm = self.constrain_pool.next_pool[self._fsm.long(),
                                                  toks.long()]

    def _logprob_outputs(self, masked: torch.Tensor, toks: torch.Tensor):
        """JAX's per-token logprob rows: the chosen token's logprob and
        the top-K (values, ids), all from log_softmax of the MASKED logits
        (temperature-independent; disallowed tokens sit at -1e30, so a
        constrained row renormalizes over the legal set). The order is a
        stable descending sort, as ``jax.lax.top_k`` orders ties: the lower
        id first."""
        lp = torch.log_softmax(masked, dim=-1)
        chosen = lp.gather(1, toks[:, None].long())[:, 0]
        vals, ids = torch.sort(lp, dim=-1, descending=True, stable=True)
        k = self.logprobs_k
        return chosen, vals[:, :k], ids[:, :k].to(torch.int32)

    def last_logprobs(self):
        """The most recent step's ``(chosen [n], top_vals [n, K],
        top_ids [n, K])`` numpy rows: None until a step ran, and only on
        engines built with ``logprobs_k`` > 0. The scheduler reads its
        slots' rows right after the step that produced them."""
        return self._last_logprobs

    def _sample(self, masked: torch.Tensor) -> torch.Tensor:
        """The sampled step's tokens (JAX's paged step): each slot's key
        at its step index, then ``_sample_token`` over the masked logits;
        every step index moves on. A step with no sampling lane skips this:
        no live lane reads a key, and each join restarts its lane's
        index."""
        at = self._stepidx.clamp(max=self.cfg.max_seq_len - 1)
        keys = self._keys[self._rows, at]
        self._stepidx += 1
        return _sample_token(masked, keys, self._temperature,
                             self._top_p, self._has_top_p)

    def _draft_insert(self, slot: int, tokens: np.ndarray) -> None:
        """The draft's half of a speculative join, on every rank of the
        slot's dp shard: the draft prefills the WHOLE prompt into the
        slot's draft rows (through ``ChunkedPrefill`` under
        ``prefill_chunk``; the draft shares nothing, so a prefix join skips
        only the target's prefill)."""
        prompt = torch.as_tensor(tokens, device=self.device)
        with torch.no_grad():
            if self.prefill_chunk is not None:
                pf = ChunkedPrefill(self._draft_model, prompt,
                                    self.prefill_chunk)
                pf.feed(pf.n_chunks)
                dcache, _ = pf.result()
            else:
                dcache, _ = _prefill(self._draft_model, prompt)
            dense_insert(self._draft_cache,
                         slot - self._dp_index * self._per, dcache)

    def _join_spec_state(self, slot: int, row: torch.Tensor,
                         temperature: float, top_p: float | None, seed: int,
                         program: Any, base: int | None) -> None:
        """Seed a slot's pending token at join (after ``_draft_insert``),
        drawn from the prefill row as solo ``speculative_generate`` draws
        it: a sampled lane splits ``PRNGKey(seed)`` and samples the
        tempered, nucleus-filtered row; a greedy lane takes the argmax and
        carries ``PRNGKey(0)`` unused. Under a ``program`` (bound at
        ``base``) the row takes the start state's mask first, and the FSM
        enters at the state AFTER pend, the invariant every round keeps."""
        with torch.no_grad():
            row = row.reshape(1, -1)
            if program is not None:
                allow = torch.as_tensor(program.allow[0], device=self.device)
                row = row + torch.where(allow, 0.0, NEG_MASK)
            if temperature > 0:
                rng, k0 = split(PRNGKey(seed, self.device))
                scaled = row / torch.tensor(float(temperature),
                                            device=self.device)
                if top_p is not None:
                    scaled = _nucleus_filter(scaled, float(top_p))
                pend = categorical(k0, scaled)[0]
            else:
                rng = PRNGKey(0, self.device)
                pend = row[0].argmax(-1)
            self._pend[slot] = pend
            self._spec_rng[slot] = rng
        if program is not None:
            self._fsm[slot] = int(base) + int(program.next[0, int(pend)])

    def _spec_round(self) -> tuple[np.ndarray, np.ndarray]:
        """The round, JAX's draft and verify executables in one eager pass.
        A round where no live lane samples draws nothing (greedy lanes
        discard their draws, so their tokens are the same). Over a mesh
        the ``spec`` command carries each lane's pending token and the
        live mask; rank 0 picks every token (``_spec_lanes``)."""
        cows = self._run_pending_cows()
        k = self.spec_k
        pool = self.constrain_pool
        sampled = bool(self._sampled[self._active].any())
        with torch.no_grad():
            active = torch.as_tensor(self._active, device=self.device)
            # Draft: each lane's key splits into (chain, draft, accept,
            # residual, bonus) keys, then k + 1 draft steps from pend, the
            # FSM walked inside: the masked logits are the proposals' q.
            if sampled:
                parts = split(self._spec_rng, 5)  # [n, 5, 2]
                self._spec_rng = parts[:, 0].contiguous()
                step_keys = split(parts[:, 1], k + 1)  # [n, k + 1, 2]
            walk = {"st": self._fsm, "q": []}

            def draft_pick(j, logits):
                st = walk["st"]
                masked = logits + torch.where(pool.allow_pool[st.long()],
                                              0.0, NEG_MASK)
                if sampled:
                    tok = _sample_token(masked, step_keys[:, j],
                                        self._temperature, self._top_p,
                                        self._has_top_p)
                    walk["q"].append(masked)
                else:
                    tok = masked.argmax(-1).to(torch.int32)
                walk["st"] = pool.next_pool[st.long(), tok.long()]
                return tok

            def verify_pick(tlogits, drafted):
                # Every verify row masked by the FSM state it is sampled
                # at, then JAX's accept/emit over all lanes at once.
                drafted = torch.stack(drafted, 1)  # [n, k + 1]
                seq = [self._fsm]
                for j in range(k):
                    seq.append(pool.next_pool[seq[-1].long(),
                                              drafted[:, j].long()])
                st_seq = torch.stack(seq, 1)  # [n, k + 1]
                tlogits = tlogits + torch.where(
                    pool.allow_pool[st_seq.long()], 0.0, NEG_MASK)
                chunk = torch.cat([self._pend[:, None], drafted[:, :k]], 1)
                if sampled:
                    toks, counts, nxt = lane_accept_emit(
                        k, tlogits, torch.stack(walk["q"], 1), drafted,
                        self._pend, parts[:, 2], parts[:, 3], parts[:, 4],
                        self._temperature, self._top_p, self._has_top_p)
                else:
                    targmax = tlogits.argmax(-1)  # [n, k + 1]
                    accept = drafted[:, :k].long() == targmax[:, :k]
                    m = torch.cumprod(accept.long(), 1).sum(1)
                    toks = chunk.to(torch.int32)
                    counts = (1 + m).to(torch.int32)
                    nxt = targmax.gather(1, m[:, None])[:, 0].to(
                        torch.int32)
                counts = torch.where(active, counts, 0)
                walk.update(toks=toks, nxt=nxt, st_seq=st_seq)
                return counts

            payload = None
            if self._chan is not None:
                payload = torch.cat([
                    self._pend.long(), active.long(),
                    torch.as_tensor(np.asarray(cows, np.int64).reshape(-1),
                                    device=self.device)])
            with self._device_op("spec", (len(cows),), payload):
                counts = self._spec_lanes(self._pend, active, draft_pick,
                                          verify_pick)
            toks, nxt, st_seq = walk["toks"], walk["nxt"], walk["st_seq"]
            # The new FSM: the state after the accepted prefix, advanced
            # through the next pend; inactive lanes keep theirs.
            s_m = st_seq.gather(1, (counts.long() - 1).clamp(0, k)[:, None])
            self._fsm = torch.where(
                active, pool.next_pool[s_m[:, 0].long(), nxt.long()],
                self._fsm)
            self._pend = torch.where(active, nxt, self._pend)
        self.steps_total += 1
        return toks.cpu().numpy(), counts.cpu().numpy()

    def _spec_lanes(self, pend: torch.Tensor, active: torch.Tensor,
                    draft_pick, verify_pick) -> torch.Tensor:
        """A round's device work on this rank, over its dp shard's lanes:
        k + 1 draft steps from ``pend``, one target forward of the k + 1
        chunk ``[pend, d_1..d_k]`` (t = k + 1 rows a lane, each lane at its
        own counter, over the paged pool or the dense slot tensor: JAX's
        vmapped solo chunk forward), then each lane's rewind in both
        caches to its accepted count: rejected rows go invisible to the
        masked reads, and the next round's chunk overwrites them. Rank 0
        passes ``draft_pick(j, logits [n, vocab]) -> tokens`` and
        ``verify_pick(logits [n, k + 1, vocab], drafted) -> counts``; a
        worker's picks return None and it takes rank 0's (``_spread``).
        Returns the ``[max_slots]`` accept counts."""
        k = self.spec_k
        lo, per = self._dp_index * self._per, self._per
        mine = active[lo:lo + per]
        dcache = mask_inactive_indices(self._draft_cache, mine)
        d_idx = dcache["cache_index"].clone()
        tok, drafted = pend, []
        for j in range(k + 1):
            logits = self._lanes_forward(self._draft_model, dcache,
                                         tok[lo:lo + per, None].long())
            tok = draft_pick(j, logits[:, 0])
            if j < k:
                tok = self._spread(tok)  # the next draft step's input
            drafted.append(tok)
        chunk = torch.cat([pend[:, None], torch.stack(drafted[:k], 1)], 1)
        cache = mask_inactive_indices(self._cache, mine)
        t_idx = cache["cache_index"].clone()
        tlogits = self._lanes_forward(self._model, cache,
                                      chunk[lo:lo + per].long())
        counts = self._spread(verify_pick(tlogits, drafted))
        mine_counts = counts[lo:lo + per]
        set_cache_index(cache, torch.where(mine, t_idx + mine_counts, 0))
        set_cache_index(dcache, torch.where(mine, d_idx + mine_counts, 0))
        return counts

    def spec_debug(self) -> dict:
        """Speculation telemetry for /debug/serve, JAX's keys: k, rounds,
        lane-rounds, emitted tokens and the accept rate, accepted draft
        tokens over drafted ones: ``(tokens per lane-round - 1) / k``."""
        lanes = self.spec_lane_rounds_total
        tpr = (self.spec_tokens_total / lanes) if lanes else 0.0
        return {
            "k": self.spec_k,
            "rounds": self.spec_rounds_total,
            "lane_rounds": lanes,
            "tokens": self.spec_tokens_total,
            "tokens_per_lane_round": round(tpr, 3),
            "accept_rate": round(max(0.0, tpr - 1.0) / self.spec_k, 4)
            if lanes else 0.0,
        }

    def retire(self, slot: int) -> None:
        """Release a slot: its program reference drops, its private blocks
        return to the pool, shared refcounts drop, and prefix entries whose
        last holder this was are invalidated. The lane's stale rows are
        masked, never cleared."""
        self._slot_tags.pop(slot, None)
        self._active[slot] = False
        digest = self._slot_program.pop(slot, None)
        if digest is not None:
            # Drop the program reference (its rows stay resident for reuse
            # until a bind needs them) and park the lane on row 0.
            self.constrain_pool.release(digest)
            self._fsm[slot] = 0
        st = self._slot_state.pop(slot, None)
        if st is not None:
            self._free_blocks(st["private"] + st["shared"])
        self.alloc.release(slot)

    def tag_slot(self, slot: int, request_id: str) -> None:
        """Name the request occupying ``slot`` so the engine's own spans
        (CoW) carry its id; cleared on retire."""
        self._slot_tags[slot] = request_id

    # -- observability ------------------------------------------------------

    def _set_block_gauges(self) -> None:
        if not self.kv_paged:
            return  # no pool: the block gauges are the paged engine's
        SERVE_KV_BLOCKS.set(self.blocks.free_blocks, state="free")
        SERVE_KV_BLOCKS.set(self.blocks.used, state="used")
        SERVE_KV_BLOCKS.set(self.blocks.shared, state="shared")

    def mesh_info(self) -> dict:
        """The mesh's shape for /debug/serve and /healthz, the JAX
        engine's keys: ``mesh_debug``'s, and under a mesh the tp and dp
        sizes and whether the KV heads are split."""
        from tf_operator_tpu_torch.serve.sharding import mesh_debug

        info = mesh_debug(self.mesh)
        if self.mesh is not None:
            tp = self._tp.size
            info["tp"] = tp
            info["dp"] = self._dp
            info["kv_heads_sharded"] = bool(
                tp > 1 and self.cfg.kv_heads % tp == 0)
        return info

    @property
    def free_block_fraction(self) -> float:
        """Fraction of the allocatable KV pool still free: the degraded
        mode's watermark input. A dense engine runs out of nothing but
        slots, so it reads 1.0."""
        if not self.kv_paged:
            return 1.0
        return self.blocks.free_blocks / max(1, self.kv_blocks - 1)

    @property
    def decode_step_compiles(self) -> int:
        """The JAX engine's count of its compiled decode step's
        executables, the zero-recompile pin. The step here is eager and
        compiles nothing, so it reads 0, as does ``warmup_compiles``, in
        both layouts: the zero-recompile pin holds trivially."""
        return 0

    @property
    def warmup_compiles(self) -> int:
        """``decode_step_compiles`` after ``warmup``: 0 (see there)."""
        return 0

    def constrain_debug(self) -> dict:
        """Constraint-pool telemetry for /debug/serve, JAX's keys:
        resident programs/rows, live refs, bind/eviction counters, the
        slots decoding under a program, and ``logprobs_k``."""
        out = dict(self.constrain_pool.debug())
        out["slots_constrained"] = len(self._slot_program)
        out["logprobs_k"] = self.logprobs_k
        return out

    def kv_debug(self) -> dict:
        """KV stats, named as the JAX engine names them: the dense slot
        tensor's shape, or the block pool's counters with the ``tier``
        section only with a host tier attached."""
        if not self.kv_paged:
            return {"mode": "dense", "cache_rows": self.max_slots,
                    "max_seq_len": self.cfg.max_seq_len}
        out = {
            "mode": "paged",
            "block": self.kv_block,
            "table_len": self.table_len,
            "blocks_total": self.kv_blocks,
            "blocks_free": self.blocks.free_blocks,
            "blocks_used": self.blocks.used,
            "blocks_shared": self.blocks.shared,
            "blocks_high_water": self.blocks.high_water,
            "cow_copies": self.cow_copies,
            "prefix_entries": self.prefix.entries,
            "prefix_hits": self.prefix.hits,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "shipments_ingested": self.shipments_ingested,
            "ship_tokens_ingested": self.ship_tokens_ingested,
            # Entries served to pulling routers, and completed-request
            # entries pinned past their slots.
            "prefix_exports": self.prefix_exports,
            "prefix_retained": len(self._retained),
        }
        if self._dp > 1:
            # Each dp shard's capacity, JAX's rows (only at dp > 1).
            out["dp_shards"] = [
                {"shard": i, "extent": list(self.blocks.shard_extent(i)),
                 "blocks_free": self.blocks.free_in(i),
                 "slots_free": self.alloc.free_in(i)}
                for i in range(self._dp)]
        if self.host_tier is not None:
            out["tier"] = dict(self.host_tier.snapshot(),
                               restores=self.tier_restores,
                               restore_tokens=self.tier_restore_tokens)
        return out

    @property
    def active_slots(self) -> int:
        return self.alloc.in_use

    @property
    def occupancy(self) -> float:
        return self.alloc.in_use / self.max_slots


class _TpPrefill:
    """Rank 0's chunked prefill on an engine over a mesh: each ``feed`` and
    the ``result`` issue their command first, so every rank of the owning
    dp shard runs the same chunk forwards (and the head's gather) in step.
    ``inner`` is this rank's ``ChunkedPrefill``, None when another dp
    shard runs it (then ``result`` carries only the logits, from that
    shard's leader)."""

    def __init__(self, engine: ContinuousEngine, pid: int, shard: int,
                 inner: ChunkedPrefill | None, chunk: int,
                 n_chunks: int) -> None:
        self._engine, self.pid, self.shard = engine, pid, shard
        self._inner = inner
        self.chunk, self.n_chunks = chunk, n_chunks
        self._at = 0

    @property
    def done(self) -> bool:
        return self._at >= self.n_chunks

    def feed(self, max_chunks: int = 1) -> int:
        n = min(max_chunks, self.n_chunks - self._at)
        if n <= 0:
            return 0
        with self._engine._device_op("feed", (self.pid, n, self.shard)):
            if self._inner is not None:
                self._inner.feed(n)
        self._at += n
        return n * self.chunk

    def result(self):
        if not self.done:
            raise RuntimeError("prefill not finished")
        with self._engine._device_op("finish", (self.pid, self.shard)):
            out = self._inner.result() if self._inner is not None else None
            return self._engine._prefill_home(self.shard, out)


def _check_spec(cfg: TransformerConfig, k: int,
                draft_cfg: TransformerConfig | None, draft_params,
                kv_attend: str, device: torch.device) -> None:
    """A speculative engine's checks, before any device work: JAX's (k,
    the draft, int8_decode, the draft's length) and the paged kernel's
    row cap. Under ``kv_attend="kernel"`` the verify runs B4 at t = k + 1
    query rows a lane, t x (heads / KV heads) rows per KV head, which the
    kernel takes up to ``MAX_ROWS``; a k past it raises here, on every
    device, rather than running the verify anywhere else."""
    if k < 1:
        raise ValueError(f"spec_k={k} must be >= 1")
    if draft_cfg is None or draft_params is None:
        raise ValueError(
            "spec_k needs draft_cfg and draft_params (the draft model "
            "that proposes k tokens per round)"
        )
    for name, c in (("target", cfg), ("draft", draft_cfg)):
        if c.int8_decode:
            raise ValueError(
                f"{name} cfg.int8_decode is not supported by speculative "
                "decoding (same contract as solo speculative_generate)"
            )
    if draft_cfg.max_seq_len < cfg.max_seq_len:
        raise ValueError(
            f"draft max_seq_len {draft_cfg.max_seq_len} < target "
            f"max_seq_len {cfg.max_seq_len}: the draft cache must hold "
            "every position the target budget admits"
        )
    if kv_attend != "kernel":
        return
    g = cfg.n_heads // cfg.kv_heads
    if (k + 1) * g > MAX_ROWS or (device.type == "cuda"
                                   and not paged_attend_supported(
                                       k + 1, cfg.n_heads, cfg.kv_heads,
                                       cfg.head_dim, cfg.dtype)):
        raise ValueError(
            f"spec_k={k}: the verify round runs the paged kernel at "
            f"t = k + 1 = {k + 1} query rows a lane, {(k + 1) * g} rows per "
            f"KV head at {g} query heads a KV head; the kernel takes at "
            f"most MAX_ROWS = {MAX_ROWS} (and Dh in {HEAD_DIMS}, f32 or "
            f"bf16): use spec_k <= {MAX_ROWS // g - 1} or "
            'kv_attend="gather"'
        )


def _check_sampling(temperature: float, top_p: float | None) -> None:
    """JAX's checks of a request's sampling parameters."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if top_p is not None and temperature <= 0:
        raise ValueError("top_p requires temperature > 0 (greedy ignores it)")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _pack(tensors) -> torch.Tensor:
    """Tensors of any dtypes as one uint8 vector of their bytes, in order
    (each made contiguous), on their device: what one collective moves."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(flat: torch.Tensor, like) -> list[torch.Tensor]:
    """``_pack``'s inverse: ``like`` is each tensor's (shape, dtype)."""
    out, at = [], 0
    for shape, dtype in like:
        size = _itemsize(dtype)
        n = math.prod(shape) * size
        chunk = flat[at:at + n]
        if chunk.storage_offset() % size:
            chunk = chunk.clone()  # a view of another dtype needs alignment
        out.append(chunk.view(dtype).reshape(shape))
        at += n
    return out


def _words(flat: torch.Tensor) -> np.ndarray:
    """A uint8 vector as int64 words on the host (zero-padded to a
    whole word): a command payload."""
    raw = flat.cpu().numpy()
    pad = (-raw.size) % 8
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    return raw.view(np.int64)
