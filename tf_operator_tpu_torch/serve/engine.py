"""Continuous-batching decode engine over the block-paged KV pool, in
PyTorch.

Counterpart of ``tf_operator_tpu/serve/engine.py::ContinuousEngine`` in
its plain paged mode. Requests join whenever a slot and enough blocks
are free, every step advances all active slots by one token in ONE
batched forward of the paged model, and slots retire one by one. KV
lives in per-layer pools of ``kv_block``-token blocks; each slot owns a
block table sized to its actual length (prompt + decode horizon).

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

Serving hooks, as the JAX engine has them: ``faults`` (``alloc_exhaust``
in ``plan_admission``, ``step_raise`` and ``step_stall`` in ``step``),
``tag_slot`` (the request id the engine's own ``kv.cow`` spans carry),
``mesh_info``, ``free_block_fraction``, the ``tpu_serve_kv_*`` gauges and
counters, and ``warmup`` (a step over no live lane, run by a server's
engine factory so the kernels are built and loaded before it reports
ready). Speculative decoding, disaggregation, the host tier and meshes
are later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from tf_operator_tpu_torch.models.convert import load_params
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
from tf_operator_tpu_torch.random import PRNGKey, gumbel, split
from tf_operator_tpu_torch.runtime.metrics import (
    SERVE_KV_BLOCKS,
    SERVE_KV_COW_TOTAL,
    SERVE_MESH_DEVICES,
    SERVE_PHASE_SECONDS,
    SERVE_PREFILL_SAVED_TOTAL,
)
from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER
from tf_operator_tpu_torch.serve.constrain import NEG_MASK, ProgramPool
from tf_operator_tpu_torch.serve.faultinject import (
    NULL_INJECTOR,
    InjectedFault,
)
from tf_operator_tpu_torch.serve.kvcache import (
    BlockAllocator,
    PrefixCache,
    SlotAllocator,
    cow_copy,
    gather_solo,
    mask_inactive_indices,
    paged_cache_template,
    paged_insert,
    table_insert,
)


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
    settled: bool = False         # consumed by a join OR released

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens this admission still has to prefill."""
        return self.prompt_len - self.shared_tokens


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
    ``device`` defaults to the CUDA card."""

    def __init__(self, cfg: TransformerConfig, params, max_slots: int, *,
                 kv_block: int = 64, kv_blocks: int | None = None,
                 kv_attend: str = "gather",
                 prefill_chunk: int | None = None, faults: Any = None,
                 constrain_rows: int = 128, logprobs_k: int = 0,
                 device=None) -> None:
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        # Per-token logprobs: static at construction, as in JAX (K shapes
        # the step's extra outputs); a request opts in at the scheduler.
        self.logprobs_k = int(logprobs_k or 0)
        if self.logprobs_k < 0 or self.logprobs_k > cfg.vocab_size:
            raise ValueError(
                f"logprobs_k={logprobs_k} must be in [0, vocab_size]"
            )
        self.prefill_chunk = prefill_chunk
        self.max_slots = int(max_slots)
        self.kv_block = int(kv_block)
        self.kv_attend = kv_attend
        self.table_len = cfg.max_seq_len // self.kv_block
        if kv_blocks is None:
            # Every slot at max length, plus the pinned garbage block.
            kv_blocks = self.max_slots * self.table_len + 1
        self.kv_blocks = int(kv_blocks)
        # The config validates kv_attend and the block geometry.
        self.cfg = replace(cfg, decode=True, kv_paged=True,
                           kv_block=self.kv_block,
                           kv_num_blocks=self.kv_blocks, kv_attend=kv_attend)
        # One module serves both layouts: prefill runs it over a dense
        # cache, the step over the paged one.
        self._model = load_params(Transformer(self.cfg, device), params)
        self.device = self._model.device
        self.alloc = SlotAllocator(self.max_slots)
        self.blocks = BlockAllocator(self.kv_blocks)
        self.prefix = PrefixCache(self.kv_block)
        self._cache = paged_cache_template(self._model, self.max_slots)
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
        self.faults = faults or NULL_INJECTOR
        # Request id per slot (scheduler-set after join): the engine's own
        # spans (CoW copies fire inside step()) name the slot's request.
        self._slot_tags: dict[int, str] = {}
        SERVE_MESH_DEVICES.set(1)
        self._set_block_gauges()

    # -- admission planning ----------------------------------------------

    def validate_request(self, prompt_len: int, num_steps: int) -> None:
        """The solo generation budget, the chunked-prefill padding budget
        when chunks are configured, and the whole-pool block budget (a
        request that could never fit must not queue forever)."""
        if num_steps < 1:
            raise ValueError(f"num_steps={num_steps} must be >= 1")
        if prompt_len < 1:
            raise ValueError("prompt must have at least one token")
        if prompt_len + num_steps > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt {prompt_len} + steps {num_steps} exceeds "
                f"max_seq_len {self.cfg.max_seq_len}"
            )
        if self.prefill_chunk is not None:
            _validate_prefill_chunk(self.cfg, prompt_len, self.prefill_chunk)
        cap = self._block_cap(prompt_len, num_steps)
        if cap > self.kv_blocks - 1:
            raise ValueError(
                f"prompt {prompt_len} + steps {num_steps} needs {cap} KV "
                f"blocks of {self.kv_block}; the pool has only "
                f"{self.kv_blocks - 1} allocatable"
            )

    def _block_cap(self, prompt_len: int, num_steps: int) -> int:
        """Table entries one admission reserves: prompt + decode horizon."""
        return -(-(prompt_len + num_steps) // self.kv_block)

    def plan_admission(self, tokens, num_steps: int) -> AdmissionPlan | None:
        """Reserve a slot's worth of blocks for one request, or None (the
        caller queues): a free slot AND enough free blocks after the
        shared-prefix credit. A shared partial last block reserves one
        extra private block for its copy-on-write."""
        tokens = np.array(tokens, np.int32)
        n_prompt, n_steps = int(tokens.shape[1]), int(num_steps)
        self.validate_request(n_prompt, n_steps)
        if self.faults.fire("alloc_exhaust") is not None:
            return None  # injected slot/block-pool exhaustion
        if self.alloc.free == 0:
            return None
        blk = self.kv_block
        cap = self._block_cap(n_prompt, n_steps)
        n, shared, logits = self.prefix.lookup(tokens[0])
        shared_entries = -(-n // blk)
        cow_needed = n == n_prompt and n % blk != 0
        need = cap - shared_entries + (1 if cow_needed else 0)
        priv = self.blocks.alloc(need)
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
        )

    def release_plan(self, plan: AdmissionPlan | None) -> None:
        """Undo a plan's reservations. Idempotent; a no-op for a plan a
        join consumed (its blocks belong to the slot then)."""
        if plan is None or plan.settled:
            return
        plan.settled = True
        self._free_blocks(
            list(plan.private_blocks) + list(plan.shared_blocks))

    def _free_blocks(self, blks) -> None:
        """The one block release path: drop refcounts, and invalidate the
        prefix entries whose last holder just left."""
        freed = self.blocks.free(list(blks))
        if freed:
            self.prefix.invalidate_blocks(freed)
        self._set_block_gauges()

    def _seed_cache(self, plan: AdmissionPlan) -> dict:
        """A solo dense cache seeded with the plan's shared prefix rows,
        its counter at the shared length: the suffix prefill's start."""
        cache = gather_solo(self._cache, plan.read_table)
        return set_cache_index(cache, plan.shared_tokens)

    # -- joins --------------------------------------------------------------

    def prefill_planned(self, plan: AdmissionPlan) -> ChunkedPrefill | None:
        """The resumable prefill a planned admission still needs, or None
        when there is nothing to feed: an exact prefix match (the plan
        carries the sampling logits), an engine without ``prefill_chunk``
        (the prefill runs inside ``join_planned``), or a shared suffix
        whose chunk padding would not fit the cache (one-shot)."""
        if plan.prefill_tokens == 0 or self.prefill_chunk is None:
            return None
        if not plan.shared_tokens:
            return ChunkedPrefill(self._model, plan.tokens,
                                  self.prefill_chunk)
        padded = (-(-plan.prefill_tokens // self.prefill_chunk)
                  * self.prefill_chunk)
        if plan.shared_tokens + padded > self.cfg.max_seq_len:
            return None
        return ChunkedPrefill(
            self._model, plan.tokens[:, plan.shared_tokens:],
            self.prefill_chunk, initial_cache=self._seed_cache(plan),
            base_index=plan.shared_tokens,
        )

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
                elif plan.shared_tokens:
                    suffix = plan.tokens[:, plan.shared_tokens:]
                    cache, logits = _prefill_extend(
                        self._model, self._seed_cache(plan),
                        torch.as_tensor(suffix, device=self.device),
                    )
                else:
                    cache, logits = _prefill(
                        self._model,
                        torch.as_tensor(plan.tokens, device=self.device),
                    )
        except Exception:
            self.release_plan(plan)
            raise
        return self._join_paged(plan, cache, logits, temperature, top_p,
                                seed, program)

    def _set_sampling(self, slot: int, num_steps: int, temperature: float,
                      top_p: float | None, seed: int) -> None:
        """The slot's sampling state, as JAX's ``_sampling_state`` builds
        it: at temperature > 0 the key ladder is solo ``generate``'s
        ``split(PRNGKey(seed), num_steps)`` (zeros past it, and all zeros
        for a greedy lane); the step index restarts at 0."""
        self._keys[slot].zero_()
        if temperature > 0:
            self._keys[slot, :num_steps] = split(
                PRNGKey(seed, self.device), num_steps)
        self._stepidx[slot] = 0
        self._temperature[slot] = max(0.0, float(temperature))
        self._top_p[slot] = 1.0 if top_p is None else float(top_p)
        self._has_top_p[slot] = top_p is not None
        self._sampled[slot] = temperature > 0

    def _join_paged(self, plan: AdmissionPlan, cache: dict | None,
                    logits: torch.Tensor, temperature: float,
                    top_p: float | None, seed: int,
                    program: Any = None) -> int | None:
        base = None
        if program is not None:
            base = self.constrain_pool.bind(program)
            if base is None:
                # Constraint-pool saturation: the requeue contract of
                # block exhaustion.
                self.release_plan(plan)
                return None
        slot = self.alloc.acquire()
        if slot is None:  # the single-caller contract makes this unreachable
            if program is not None:
                self.constrain_pool.release(program.digest)
            self.release_plan(plan)
            return None
        if cache is None:
            # Exact prefix match: every prompt row already lives in shared
            # blocks, so only the table row and the counter change.
            table_insert(self._cache, slot, plan.read_table, plan.prompt_len)
        else:
            paged_insert(self._cache, slot, plan.write_table,
                         plan.read_table, cache, self.kv_block)
        row = logits.reshape(-1).float()
        self._logits[slot] = row
        self._set_sampling(slot, plan.num_steps, temperature, top_p, seed)
        if program is not None:
            # Prompt tokens are unconstrained: the slot enters at the
            # program's start state and the mask applies from the first
            # GENERATED token, the solo oracle's convention.
            self._fsm[slot] = base
            self._slot_program[slot] = program.digest
        self._active[slot] = True
        plan.settled = True  # the blocks now belong to the slot
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
        self.prefill_tokens_saved += plan.shared_tokens
        if plan.shared_tokens:
            SERVE_PREFILL_SAVED_TOTAL.inc(plan.shared_tokens)
        return slot

    # -- decode -------------------------------------------------------------

    def _run_pending_cows(self) -> None:
        """Copy-on-write for every active slot about to take its first
        decode write into a shared partial block, before that step."""
        for slot, st in self._slot_state.items():
            if st["cow"] is None or not self._active[slot]:
                continue
            entry, src, dst = st["cow"]
            t0 = time.monotonic()
            cow_copy(self._cache, slot, entry, src, dst)
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

    def step(self) -> np.ndarray:
        """One decode iteration over ALL slots: every active slot advances
        one token. Returns the ``[max_slots]`` int32 tokens (inactive
        rows are dead compute: ignore them). The fault points fire first,
        as in the JAX engine: ``step_raise`` raises ``InjectedFault``,
        ``step_stall`` sleeps its argument (default 1 s)."""
        if self.faults.fire("step_raise") is not None:
            raise InjectedFault("step_raise")
        self.faults.maybe_sleep("step_stall", default=1.0)
        return self._step()

    def warmup(self) -> None:
        """One step over no live lane (no fault point fires), then the
        step count back at 0: on the card it builds or loads every kernel
        the step launches and runs each once, so a server's first request
        pays neither. The JAX engine warms its compiled step in its
        constructor; this one is called by the caller that wants it.
        Inactive lanes' writes land in the pinned garbage block and every
        join overwrites its lane's logits, so no later token changes."""
        if self._active.any():
            raise RuntimeError("warmup() runs before any join")
        self._step()
        self.steps_total = 0

    def _step(self) -> np.ndarray:
        self._run_pending_cows()
        with torch.no_grad():
            active = torch.as_tensor(self._active, device=self.device)
            mask_inactive_indices(self._cache, active)
            masked = self._mask(self._logits)
            if self._sampled[self._active].any():
                toks = self._sample(masked)
            else:
                toks = masked.argmax(-1).to(torch.int32)
            self._advance(toks)
            if self.logprobs_k:
                lp = self._logprob_outputs(masked, toks)
            self._logits = self._model(toks[:, None], self._cache)[:, 0]
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
        SERVE_KV_BLOCKS.set(self.blocks.free_blocks, state="free")
        SERVE_KV_BLOCKS.set(self.blocks.used, state="used")
        SERVE_KV_BLOCKS.set(self.blocks.shared, state="shared")

    def mesh_info(self) -> dict:
        """The JAX engine's answer for one device (no mesh)."""
        return {"devices": 1}

    @property
    def free_block_fraction(self) -> float:
        """Fraction of the allocatable KV pool still free: the degraded
        mode's watermark input."""
        return self.blocks.free_blocks / max(1, self.kv_blocks - 1)

    @property
    def decode_step_compiles(self) -> int:
        """The JAX engine's count of its compiled decode step's
        executables, the zero-recompile pin. The step here is eager and
        compiles nothing, so it reads 0, as does ``warmup_compiles``,
        until the decode step runs as a captured CUDA graph (ROADMAP A5),
        when both count captures."""
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
        """Block-pool stats, named as the JAX engine names them."""
        return {
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
        }

    @property
    def active_slots(self) -> int:
        return self.alloc.in_use

    @property
    def occupancy(self) -> float:
        return self.alloc.in_use / self.max_slots


def _check_sampling(temperature: float, top_p: float | None) -> None:
    """JAX's checks of a request's sampling parameters."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if top_p is not None and temperature <= 0:
        raise ValueError("top_p requires temperature > 0 (greedy ignores it)")
