"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device line: the card's name and power limit (nvidia-smi) and the
   torch version; TF32 off for matmuls and cuDNN;
2. build: every CUDA kernel of the paths from the sources in this
   checkout (one nvcc per source, started together), with ptxas's
   register and spill lines; it fails unless it finds every TMA instance
   (``TMA_INSTANCES``: the six flash ones, B5's wgmma tile) and none
   spills;
3. paged kernel vs plain: the paged-attention kernel's design (one
   launch a call: a thread-block cluster of S CTAs a lane and KV head,
   ``paged_attention.SPLITS``, walks the lane's blocks strided and merges
   through distributed shared memory; S printed) against its plain
   PyTorch version at the serving slice's shapes (4 lanes at
   3500/1750/875/437 tokens, H=16, KV=4, Dh=64, blk=128, S=4096), for
   t=1, t=3 and a lane at index 0 with an all-zero table, in bf16 and
   f32, each a single launch; then its device time (CUDA-graph replay)
   beside its eager time per call, the plain version's device time, the
   byte bound and, as a yardstick the port never calls,
   scaled_dot_product_attention over the pre-gathered K/V;
4. flash kernels vs plain: the design each instance runs (bf16 and f32,
   Dh 32, 64 and 128; flash_design: "tma-wgmma", the warp-specialised TMA
   + wgmma kernels of bf16 B1 and B3, or "mma.sync"), then the forward (O
   and LSE), dQ and dK/dV kernels against their plain versions at B=2,
   H=16, Dh=64, causal at T=1024 and T=1000 (a ragged tail, once with q,
   k, v as strided slices of one fused projection) and full at tq=512,
   tk=1024, in bf16 and f32; each element within the rule of
   tf_operator_tpu_torch.testing;
5. flash at the training shape (B=2, H=16, T=8192, Dh=64, bf16, causal,
   q, k, v strided slices of one [B, T, 3, H, Dh] projection as the
   trainer hands them over): it asserts that B1, B2 and B3 run the TMA +
   wgmma design there and prints each kernel's design; every output
   against the plain versions (run a head at a time) and, with the plain
   versions, against an f32 evaluation (the kernels no less exact:
   F32_RMS_RATIO); then each kernel's device time (CUDA-graph replay),
   the forward's and forward+backward's eager time, the plain versions'
   time (at T=8192 when their f32 scores fit, else at T=2048, the shape
   printed), the operation bound at 989 TFLOP/s, and as a yardstick the
   device time of aten's flash-attention forward and backward (the
   backward computes dQ, dK and dV in one call);
6. engine, f32: the full-width paged-decode LM (vocab 32768, d 1024, 16
   heads, 4 KV heads, 8 layers, d_ff 4096, S 4096; random weights from a
   seed) in ContinuousEngine with kv_attend="kernel" and "gather": four
   prompts join, 64 decode steps, two lanes retire, a prompt sharing the
   first two blocks of lane 0 and an exact copy of lane 1's prompt join
   (prefix share and copy-on-write), 16 more steps. Greedy tokens must
   be identical between the two reads, and the kernel must have launched
   n_layers times per decode forward;
7. engine, bf16: the same schedule with the kernel; decode tokens/s and
   prefill seconds; its last 8 steps under torch.profiler (device busy
   share of a step, the kernels that take most device time);
8. trainer, f32: the LM at bench.py's width (vocab 32768, d 1024, 16
   heads, 8 layers, d_ff 4096, max_seq_len 8192; random weights from
   seed 0) at B=2, T=1024, 3 steps of adamw(warmup_cosine(...)), once
   through the flash kernels and once with reference_attention in their
   place: the step-0 gradients (lr 0, weights unchanged) leaf by leaf,
   the losses and, as a looser second check, the final weights must
   agree, and the kernels must have run 8 times a step;
9. trainer, bf16: bench.py's training shape (B=2, T=8192, chunked loss
   1024 with a bf16 head dot, adamw(1e-4)) for 7 steps on one seeded
   batch: step seconds after one warm-up step, tokens/s and MFU
   (bench.py's count: 6 N + 6 L d S flops a token, at 989 TFLOP/s), one
   more step under torch.profiler (device busy share, the kernels that
   take most device time: the step's breakdown); losses finite and
   falling, and 8 forward, 8 dQ and 8 dK/dV launches a step (each
   kernel's design printed: phase 5 asserts it for this shape);
10. int8 matmul vs plain (B5, the int8_decode path): the design each call
    takes (int8_design: the weight stream at m <= 8, the TMA + wgmma tile
    for bf16 x and the mma.sync tile for f32 x beyond), asserted; then the
    kernel against its plain version for m in {1, 4, 437, 3500} at each
    projection's
    (k, n) = (1024, 1024), (1024, 512), (1024, 4096), (4096, 1024) and m in
    {1, 4} at the head's (1024, 32768), x in bf16 and f32, out in f32 and
    bf16, every element by the rule of tf_operator_tpu_torch.testing;
    then device times (CUDA-graph replay) at m=4 for each (k, n), for one
    decode forward's 41 calls over distinct weights, and at m=3500 for
    (1024, 4096), beside the byte bound (m=4) or the operation bound
    (m=3500), the plain version's time and, as a yardstick the port never
    calls, torch.mm of bf16 x against bf16 copies of the weights (twice
    the weight bytes);
11. paged kv8 vs plain (the kv_int8 variant of the paged kernel, the
    same one-launch cluster design, S printed): at phase 3's shapes, t=1,
    t=3 and a lane at index 0, q in bf16 and f32, int8 pools with f32
    scale pools, each a single launch; then its device time, the byte
    bound, the plain version's time and SDPA over pre-gathered,
    dequantized K/V;
12. engine, f32, int8_decode + kv_int8: phase 6's schedule with weights
    from quantize_decode_params(init_params(cfg, 0)), through both kernels
    and, in lockstep with it, with kv_attend="gather" and int8_apply
    pointed at its plain version, teacher-forced (``lockstep_phase`` says
    why): the logits of every lane after every prefill and step within
    LOGIT_TOL, kv_debug equal, a prefix share and a copy-on-write, 8 kv8
    launches per decode forward and 41 int8 matmul launches per forward
    (decode step or prefill), none of them on the wgmma tile (f32 x);
13. engine, bf16, int8_decode + kv_int8 through the kernels, the tree
    quantized from the bf16-rounded weights as bench.py's int8 legs do:
    decode tokens/s, prefill seconds and the last 8 steps under
    torch.profiler, beside phase 7's bf16 numbers; 41 int8 matmul
    launches per forward, a prefill's 40 projections on the wgmma tile;
14. the sampler (``tf_operator_tpu_torch/random.py``, ``generate``, the
    engine's sampled lanes): (a) on the card, Threefry-2x32 against
    Random123's three known answers, ``split(PRNGKey(0), 3)`` and
    ``fold_in(PRNGKey(0), 7)`` against JAX's values, and ``random_bits``
    and ``uniform`` over [4, 32768] bitwise equal to the CPU's; (b) phase
    6's f32 engine with a sampled mix (``SAMPLING``: lane 0 greedy, lane 1
    at T 0.9, lane 2 at T 0.7 with top_p 0.8, lane 3 at T 1.0 with top_p
    0.95), 64 steps with kv_attend="kernel" and "gather": tokens identical,
    n_layers kernel launches a forward, and each lane against the solo
    ``generate`` of its prompt and seed on the card: tokens identical or,
    in at most one lane, parting at a near-tie (the solo run's top two
    values of gumbel + scaled logits, at the first step where they part,
    within ``NEAR_TIE``); (c) the mix in bf16 through the kernel: decode
    tokens/s and 8 steps under torch.profiler, device busy time and
    device operations a step, in turns with the same prompts all greedy
    (greedy, sampled, sampled, greedy); (d)
    ``generate`` with int8_decode + kv_int8 at B=4 prompts of 875 tokens,
    64 steps, T 0.9 and top_p 0.9: in f32 the kernel route against
    ``plain_int8_apply`` step by step, teacher-forced on the kernel run's
    tokens (``int8_generate_phase`` says why), and in bf16 decode
    tokens/s and B5's launches (41 a forward on the weight stream; the
    prefill's 40 projections on the wgmma tile);
15. the serving front (``tf_operator_tpu_torch/serve/serve_lm.py``'s
    ``build_front``: the supervisor, the scheduler and the HTTP server
    over ContinuousEngine at phase 6's width, 4 slots, blk 128,
    kv_attend="kernel"), reached over HTTP on 127.0.0.1 from client
    threads: (a) f32, eight /generate requests at once (phase 6's prompts
    greedy, then with ``SAMPLING``'s mix, 64 steps): each greedy response
    equal to its prompt's solo ``generate`` on the card, each sampled one
    equal or parting at a near-tie (phase 14 (b)'s rule); a ``stream``
    request equal to the buffered greedy response; /healthz with the JAX
    front's keys (``READINESS_KEYS``), /metrics with its ``tpu_serve_*``
    families (``SERVE_FAMILIES``), /debug/serve equal to the supervisor's
    snapshot; B4 at n_layers launches a decode forward; (b) bf16, the
    eight requests at once and then at a steady arrival rate (half the
    burst's requests/s): requests/s, TTFT and ITL p50/p99 (the server's
    per-row timing) and decode tokens/s beside phase 7's engine-only
    rate, then 8 decode steps with four lanes live under torch.profiler
    (busy share); (c) bf16 ``int8_decode`` + ``kv_int8`` over phase 13's
    tree: the four greedy responses equal phase 13's engine's first 64
    tokens of each lane (else, teacher-forced, each token is the plain
    route's greedy choice or within ``INT8_NEAR_TIE`` of it), the kv8
    B4, B5's stream and its wgmma tile each launched; (d) f32 with ``step_raise`` armed once: the four greedy
    responses, replayed across the watchdog's rebuild, equal (a)'s and
    /healthz reads one restart; then the drain with requests in flight:
    /healthz reads ``draining``, the four admitted requests finish whole,
    the two queued ones get the typed 503 (``draining``);
16. the ``kernels`` JSON line (each kernel with its design; B5 as two
    entries, the weight stream and the wgmma tile, each with its own
    launches; ``paths`` gives each kernel's launches on every path of
    this run that drives it, and ``launches`` is their sum), the card
    line, and last the result line.

It exits non-zero without a result when torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = 1e-4  # paged and kv8: f32 sums over up to 4096 keys, in another order
LANES = [3500, 1750, 875, 437]
H, KV, DH, BLK, S = 16, 4, 64, 128, 4096
LAYERS, FIRST_STEPS, LATER_STEPS = 8, 64, 16
SHARED_TAIL = 300  # fresh tokens after the two shared blocks
PROFILE_STEPS = 8  # of the bf16 run's last steps, under torch.profiler
# The LM training width: bench.py's LM_SIZE (MHA) at max_seq_len 8192.
LM = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
          max_seq_len=8192)
TRAIN_B, TRAIN_T = 2, 8192
F32_TRAIN_T, F32_STEPS = 1024, 3
BF16_STEPS = 7  # one warm-up step, six timed
XENT_CHUNK = 1024  # bench.py's chunked loss
# Flash kernels vs plain: (name, tq, tk, causal, fused q/k/v slices).
FLASH_CASES = [("causal T=1024", 1024, 1024, True, False),
               ("causal T=1000", 1000, 1000, True, False),
               ("fused causal T=1000", 1000, 1000, True, True),
               ("full tq=512 tk=1024", 512, 1024, False, False)]
# bf16 kernels against an f32 evaluation: their rms error over the row
# scale within this factor of the plain versions' (both round P and dS to
# bf16; measured equal to 2 %).
F32_RMS_RATIO = 1.25
FLASH_OUTS = {"o": "flash_fwd", "lse": "flash_fwd", "dq": "flash_dq",
              "dk": "flash_dkv", "dv": "flash_dkv"}
# flash_design's answers, and its kernel numbers.
FLASH_DESIGNS = {0: "mma.sync", 1: "tma-wgmma"}
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# int8_design's answers.
INT8_DESIGNS = {0: "mma.sync tile", 1: "stream", 2: "tma-wgmma"}
# The TMA instances ptxas compiles in each library, none of which may
# spill: the three flash kernels at Dh 64 and 128; B5's wgmma tile (out
# bf16 and f32).
TMA_INSTANCES = {"flash_attention": 6, "int8_dense": 2}
# The kernels line's design of the other kernels (their source notes).
OTHER_DESIGNS = {
    "paged_attend": "one launch: a cluster of S={S} CTAs a lane and KV "
                    "head walks its blocks strided (cp.async double "
                    "buffer), merged through distributed shared memory in "
                    "split order, f32 on CUDA cores",
    "paged_attend_kv8": "one launch: a cluster of S={S} CTAs a lane and KV "
                        "head walks its int8 blocks strided (cp.async "
                        "double buffer), merged through distributed shared "
                        "memory in split order, f32 on CUDA cores",
    "int8_matmul": "m <= 8 (decode): weight stream, cluster split-k, f32 "
                   "FMAs",
    "int8_matmul_prefill": "m > 8, bf16 x (prefill): TMA + wgmma tile, "
                           "out^T = W^T x^T, weights widened into register "
                           "A fragments"}
# f32 trainer, kernels vs plain attention. Step-0 gradients, leaf by leaf,
# each element within GRAD_RTOL |plain| + GRAD_ATOL x the rms of its row
# of plain (the rule of tf_operator_tpu_torch.testing): the attention
# outputs differ in the last f32 places (two summation orders) and 8
# layers of backward carry that on; a gradient off by a constant
# factor of 1e-2 fails. The key bias is left out: its gradient is 0 in
# exact arithmetic (it shifts a row's scores by a constant), so every
# element of it is rounding noise. Losses within 1e-4 (of ~10.4).
# Weights after 3 steps, the looser second check: Adam moves an element
# by about lr * g / (|g| + eps), so where a gradient cancels down to
# |g| ~ eps (1e-8) the last-place differences of two summation orders move
# it by a sizeable share of lr. No element may differ by more than 4 x
# the summed learning rate (Adam's step is about lr at most), and at most
# 1e-5 of the elements (key bias aside) by more than 1 % of it.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-3
TRAIN_LOSS_TOL, ADAM_BOUND, TRAIN_PARAM_FRAC, TRAIN_FAR_SHARE = (
    1e-4, 4.0, 1e-2, 1e-5)
# Int8 matmul (B5) at the serving slice's projections: (k, n) -> its calls
# in one decode forward (per layer q and out at 1024x1024, kv, in_proj,
# out_proj; the head once), and the row counts checked at each.
INT8_CALLS = {(1024, 1024): 2 * LAYERS, (1024, 512): LAYERS,
              (1024, 4096): LAYERS, (4096, 1024): LAYERS, (1024, 32768): 1}
INT8_ROWS = {shape: (1, 4) if shape[1] == 32768 else (1, 4, 437, 3500)
             for shape in INT8_CALLS}
DECODE_M, PREFILL_M = 4, 3500
# Phase 12, the f32 int8 + kv8 engine through the kernels against the
# plain versions: each active lane's logits (rms ~1) after every prefill and
# step. The int8 path rounds every projection's input to bf16, so the two
# summation orders' last-place differences flip roundings and part the
# logits by about 2e-2 (phase 12 prints the largest). tools/plant_fault.py
# reads this check on planted faults (PERF.md section 6 has its readings).
LOGIT_TOL = 5e-2
# Phase 14, the sampler. Random123's Threefry-2x32 known answers (key,
# counter, output); JAX 0.9.0's split(PRNGKey(0), 3) and
# fold_in(PRNGKey(0), 7).
WORD = 0xFFFFFFFF
RANDOM123 = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((WORD, WORD), (WORD, WORD), (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
SPLIT_0_3 = [[1797259609, 2579123966], [928981903, 3453687069],
             [4146024105, 2718843009]]
FOLD_IN_0_7 = [2716826189, 292468403]
# The sampled mix, lane by lane: (temperature, top_p, seed).
SAMPLING = [(0.0, None, 0), (0.9, None, 101), (0.7, 0.8, 102),
            (1.0, 0.95, 103)]
# (b): where a lane's tokens part from its solo run, the solo run's top two
# values of gumbel + scaled logits (logits, greedy) at the first parting
# step lie within NEAR_TIE; at most one lane parts.
NEAR_TIE = 1e-4
# (d): generate with int8_decode + kv_int8, B prompts of P tokens.
INT8_GEN_B, INT8_GEN_P, INT8_GEN_STEPS = 4, 875, 64
INT8_GEN_T, INT8_GEN_TOP_P, INT8_GEN_SEED = 0.9, 0.9, 104
# (d), f32: a decision of the kernel route and the plain route, fed the
# same tokens, may differ only at a near-tie: where the kernel route's top
# two values lie within what LOGIT_TOL of logit difference moves a value at
# T, or at the nucleus cutoff, where one route keeps a token the other drops
# and the token's probability mass ranked ahead of it lies, in both routes,
# within what that difference moves a mass (each probability by a factor
# within exp(+-2 LOGIT_TOL / T)) of top_p. Phase 15 (c) holds a greedy
# token that is not the plain route's choice to the same tie, in logits.
INT8_NEAR_TIE = LOGIT_TOL / INT8_GEN_T
INT8_MASS_TOL = math.expm1(2 * LOGIT_TOL / INT8_GEN_T)
# Phase 15, the serving front: the keys of the JAX front's /healthz
# (serve/httpapi.py readiness_payload over a supervisor that has served,
# plus serve_lm's own two) and its tpu_serve_* families, less those of
# the items the port has not ported (KV shipments, speculative decode,
# the host tier, constrained decoding).
READINESS_KEYS = ("ok", "active_slots", "queue_depth", "max_slots",
                  "mesh_devices", "mesh_axes", "requests_done",
                  "tokens_generated", "watchdog_restarts", "ttft_p99_s",
                  "itl_p99_s", "served", "engine")
SERVE_FAMILIES = tuple(f"tpu_serve_{n}" for n in (
    "queue_depth", "active_slots", "slot_capacity", "requests_total",
    "generated_tokens_total", "prefill_tokens_total", "ttft_seconds",
    "itl_seconds", "phase_seconds_total", "step_seconds", "kv_blocks",
    "kv_cow_copies_total", "prefill_tokens_saved_total",
    "watchdog_restarts_total", "deadline_exceeded_total", "shed_total",
    "degraded", "mesh_devices", "batch_occupancy"))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ws_spills(log: str) -> dict:
    """{instance: spill-store bytes} of the TMA kernels in a ``ptxas -v``
    log: the warp-specialised flash kernels (``flash_*_ws<Dh>``) and B5's
    wgmma tile (``int8_wgmma<...>``, its template arguments as the mangled
    name spells them, bf16 written out)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_[a-z]+_ws)ILi(\d+)E", line)
            i = re.search(r"(int8_wgmma)I(.*?)EEv", line)
            name = (f"{m[1]}<{m[2]}>" if m else
                    f"{i[1]}<{i[2].replace('13__nv_bfloat16', 'bf16')}>"
                    if i else None)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = int(m[1])
            name = None
    return out


def _events_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per eager call of ``fn(i)`` over ``iters`` calls, by CUDA
    events, after one warm-up call. When the host enqueues slower than
    the card runs, this is the host's time per call."""
    fn(0)
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn(i) for i in range(iters)]) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device ms per call of ``fn(i)``: ``iters`` calls captured in
    one CUDA graph (after an eager warm-up on a side stream), replayed
    once to warm up and three times under CUDA events. No host work
    sits between the launches, so this is the card's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(lambda: [graph.replay() for _ in range(3)])
    del graph
    return ms / (3 * iters)


def paged_case(lanes, t, dtype, seed, layers=1):
    """Seeded q, per-layer pools and block tables at the slice's shapes.
    Each live lane owns distinct blocks for its index + t rows; a lane at
    index 0 keeps an all-zero table."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = len(lanes) * (S // BLK) + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pools = [(randn(nb, BLK, KV, DH), randn(nb, BLK, KV, DH))
             for _ in range(layers)]
    q = randn(len(lanes), t, H, DH)
    table = np.zeros((len(lanes), S // BLK), np.int32)
    nxt = 1
    for lane, n in enumerate(lanes):
        if n == 0:
            continue
        for e in range(-(-(n + t) // BLK)):
            table[lane, e] = nxt
            nxt += 1
    index = torch.tensor(lanes, dtype=torch.int32, device=dev)
    return q, pools, torch.from_numpy(table).to(dev), index


def bound_ms(lanes, t, dtype, kv8=False) -> tuple[float, str]:
    """Least time for one call: the bytes it must move (q, the K/V rows
    the lanes own, under kv8 in int8 with their f32 scales, the table
    entries it reads, the index, the f32 output) over the memory rate,
    against its flops over the peak for the type."""
    elem = torch.tensor([], dtype=dtype).element_size()
    b = len(lanes)
    rows = sum(n + t for n in lanes)
    nblk = sum(-(-(n + t) // BLK) for n in lanes)
    kv_bytes = 2 * rows * KV * (DH + 4) if kv8 else 2 * rows * KV * DH * elem
    nbytes = (b * t * H * DH * elem + kv_bytes
              + 4 * nblk + 4 * b + 4 * b * t * H * DH)
    # q.k and p.v: 2 flops per multiply-add, per key row, per query head.
    flops = 2 * 2 * t * H * DH * sum(n + t for n in lanes)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attend_case(lanes, t, dtype, seed, kv8, layers=1):
    """``paged_case`` as paged_attend's arguments, layer by layer: q,
    [(key pool, value pool, scale-pool keywords)], table, index. Under
    kv8 the pools are quantized as the kv_int8 cache stores them (int8,
    f32 scale pools), q stays in ``dtype``."""
    from tf_operator_tpu_torch.models.transformer import _kv8_quant

    q, pools, table, index = paged_case(
        lanes, t, torch.float32 if kv8 else dtype, seed, layers)
    if not kv8:
        return q, [(pk, pv, {}) for pk, pv in pools], table, index
    quantized = []
    for pk, pv in pools:
        (k8, ks), (v8, vs) = _kv8_quant(pk), _kv8_quant(pv)
        quantized.append((k8, v8, dict(k_scale_pool=ks, v_scale_pool=vs)))
    return q.to(dtype), quantized, table, index


def kernel_phase(pa, kv8=False) -> dict:
    """The paged kernel (its kv8 variant with ``kv8``) against its plain
    version, then timed."""
    label = "paged_attend_kv8" if kv8 else "paged_attend"
    print(f"{label} design: " + OTHER_DESIGNS[label].format(S=pa.SPLITS),
          flush=True)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, lanes, t in (("t=1", LANES, 1), ("t=3", LANES, 3),
                               ("inactive lane", [3500, 0, 875, 437], 1)):
            q, pools, table, index = attend_case(lanes, t, dtype, t, kv8)
            pk, pv, scales = pools[0]
            before = pa.launches + pa.kv8_launches
            got = pa.paged_attend(q, pk, pv, table, index, **scales)
            torch.cuda.synchronize()
            if pa.launches + pa.kv8_launches != before + 1:
                raise AssertionError(f"{label} {name}: not one launch")
            want = pa.paged_attend_reference(q, pk, pv, table, index,
                                             **scales)
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{label} {name} {dtype}: bad output")
            case_err = (got - want).abs().max().item()
            print(f"{label} vs plain, q {dtype}, {name}: max_abs_err "
                  f"{case_err:.3e} (tolerance {TOL})", flush=True)
            if not case_err <= TOL:
                raise AssertionError(f"{label} {name} {dtype} disagrees")
            err = max(err, case_err)

    # Time at the main path's shapes: bf16 q, t=1, one pool pair per layer
    # (135 MB in all for bf16, beyond the 50 MB L2), walked in layer order.
    # Device times come from CUDA-graph replay (device_ms); the kernel's
    # eager time per call, host wrapper included, is printed beside them.
    q, pools, table, index = attend_case(LANES, 1, torch.bfloat16, 9, kv8,
                                         layers=LAYERS)

    def call(attend):
        def run(i):
            pk, pv, scales = pools[i % LAYERS]
            return attend(q, pk, pv, table, index, **scales)
        return run

    eager_ms = cuda_ms(call(pa.paged_attend), 400)
    kernel_ms = device_ms(call(pa.paged_attend), 400)
    plain_ms = device_ms(call(pa.paged_attend_reference), 40)
    # The yardstick reads bf16 K/V: under kv8, dequantized.
    dense = [(pk, pv) if not kv8 else tuple(
        (x.float() * s[..., None]).bfloat16()
        for x, s in ((pk, sc["k_scale_pool"]), (pv, sc["v_scale_pool"])))
        for pk, pv, sc in pools]
    library_ms = sdpa_ms(q, dense, table, index)
    bms, bound_by = bound_ms(LANES, 1, torch.bfloat16, kv8)
    print(f"{label} bf16 t=1, S={pa.SPLITS}: kernel_ms {kernel_ms:.6f} "
          f"(eager, host included: {eager_ms:.6f}) plain_ms {plain_ms:.6f} "
          f"library_ms {library_ms:.6f} (SDPA over pre-gathered bf16 K/V) "
          f"bound_us "
          f"{bms * 1e3:.4f} ({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bound_by, library_ms=library_ms)


def sdpa_ms(q, pools, table, index) -> float:
    """Device ms of scaled_dot_product_attention, the yardstick the port
    never calls, over K/V pre-gathered from each layer's (key, value)
    pools to the dense [b, H, S, Dh] layout, expanded to every query head,
    the lanes' lengths as its mask."""
    g = H // KV
    valid = (torch.arange(S, device="cuda")[None, :]
             <= index.long()[:, None])[:, None, None, :]  # [b, 1, 1, S]
    dense = [tuple(p[table.long()].reshape(len(LANES), S, KV, DH)
                   .transpose(1, 2).repeat_interleave(g, dim=1)
                   for p in pair) for pair in pools]
    qh = q.transpose(1, 2)
    return device_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            qh, *dense[i % len(dense)], attn_mask=valid), 100)


def int8_weights(k, n, copies, seed):
    """``copies`` seeded int8 weights ``[k, n]`` with their f32 scales and
    biases, quantized from normal weights of variance 1/k, each with an
    all-zero column (scale 1.0)."""
    from tf_operator_tpu_torch.ops.int8_dense import quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(copies):
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        w[:, 5] = 0
        out.append((*quantize_int8(w),
                    torch.randn((n,), generator=gen, device="cuda") * 0.1))
    return out


def int8_bounds_ms(m, k, n, out_bytes=4) -> tuple[float, float]:
    """(bytes, operations) times of one int8 matmul as the decode path
    calls it (bf16 x, a bias): the int8 weights, the scales, the bias, x
    and the output once each over the memory rate; 2 m k n operations at
    the bf16 peak."""
    nbytes = k * n + 8 * n + 2 * m * k + out_bytes * m * n
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2 * m * k * n / PEAK_FLOPS[torch.bfloat16] * 1e3)


def int8_designs(i8) -> None:
    """Assert the design B5 runs at each of the main path's calls: the
    weight stream at m=1 and 4 (bf16 and f32 x), the
    TMA + wgmma tile for bf16 x at m=437 and 3500 (prefill), the mma.sync
    tile for f32 x there (the f32 engine's prefills)."""
    lib = i8._library()
    for (k, n), rows in INT8_ROWS.items():
        got = {(m, x_bf16): INT8_DESIGNS.get(lib.int8_design(m, k, n, x_bf16))
               for m in rows for x_bf16 in (1, 0)}
        want = {(m, x_bf16): "stream" if m <= 8 else
                "tma-wgmma" if x_bf16 else "mma.sync tile"
                for m, x_bf16 in got}
        shown = ", ".join(f"m={m} x {'bf16' if b else 'f32'}: {d}"
                          for (m, b), d in got.items())
        print(f"int8_matmul designs, k={k} n={n}: {shown}", flush=True)
        if got != want:
            raise AssertionError(f"int8_matmul k={k} n={n}: designs {got}, "
                                 f"want {want}")


def int8_check_phase(i8) -> dict:
    """The int8 matmul kernel against its plain version at every shape of
    the slice, each element by the shared rule; returns the largest
    max-abs error of each design (int8_design's name)."""
    from tf_operator_tpu_torch.testing import INT8_TOL, excess

    int8_designs(i8)
    lib = i8._library()
    err = dict.fromkeys(INT8_DESIGNS.values(), 0.0)
    for (k, n), rows in INT8_ROWS.items():
        ((w_q, scale, bias),) = int8_weights(k, n, 1, seed=k + n)
        gen = torch.Generator(device="cuda").manual_seed(k * n)
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for m, x_dtype, out_dtype, b in itertools.product(
                rows, (torch.bfloat16, torch.float32),
                (torch.float32, torch.bfloat16), (None, bias)):
            x = torch.randn((m, k), generator=gen, device="cuda").to(x_dtype)
            got = i8.int8_matmul(x, w_q, scale, out_dtype, b)
            torch.cuda.synchronize()
            want = i8.int8_matmul_reference(x, w_q, scale, out_dtype, b)
            share = excess(got, want, *INT8_TOL[out_dtype])
            design = INT8_DESIGNS[lib.int8_design(
                m, k, n, int(x_dtype == torch.bfloat16))]
            err[design] = max(err[design], (got.float() - want.float())
                              .abs().max().item())
            worst[out_dtype] = max(worst[out_dtype], share)
            if not share <= 1:
                raise AssertionError(
                    f"int8_matmul m={m} k={k} n={n} x {x_dtype} out "
                    f"{out_dtype} bias {b is not None}: {share:.4f} of its "
                    "bound")
        print(f"int8_matmul vs plain, k={k} n={n}, m in {rows}, x bf16/f32, "
              f"with and without a bias: "
              f"largest share of the bound, out f32 "
              f"{worst[torch.float32]:.4f} (rtol, atol "
              f"{INT8_TOL[torch.float32]}), out bf16 "
              f"{worst[torch.bfloat16]:.4f} ({INT8_TOL[torch.bfloat16]})",
              flush=True)
    return err


def int8_forward_case():
    """The int8 matmuls of one bf16 decode forward at m=4, as Int8Dense
    makes them: distinct seeded weights for each of its 41 calls (121.6 MB
    of int8, beyond the 50 MB L2; the head gets a second copy, for its own
    timing), bf16 x, a bias, bf16 out (the head's f32). Returns
    ({(k, n): [(w_q, scale, bias)]}, {k: x}, and the calls in order as
    int8_matmul's arguments (x, w_q, scale, out_dtype, bias))."""
    weights = {shape: int8_weights(*shape, max(calls, 2), seed=sum(shape))
               for shape, calls in INT8_CALLS.items()}
    gen = torch.Generator(device="cuda").manual_seed(12)
    xs = {k: torch.randn((DECODE_M, k), generator=gen, device="cuda")
          .bfloat16() for k in (1024, 4096)}
    forward = [(xs[k], w_q, scale, head_dtype(n), bias)
               for (k, n), calls in INT8_CALLS.items()
               for w_q, scale, bias in weights[(k, n)][:calls]]
    return weights, xs, forward


def head_dtype(n: int) -> torch.dtype:
    """The output dtype of the int8 matmul of n columns in the bf16 model:
    f32 for the head (vocab 32768), bf16 for every projection."""
    return torch.float32 if n == 32768 else torch.bfloat16


def int8_timing_phase(i8, card: str) -> tuple[dict, dict]:
    """The int8 matmul kernel's device times: at m=4 for each (k, n), for
    one decode forward's 41 calls (``int8_forward_case``), and at m=3500
    for (1024, 4096); beside its bounds, the plain version's time and
    torch.mm on bf16 copies. Returns the decode forward's numbers and the
    m=3500 call's (the wgmma tile), for the kernels line."""
    weights, xs, forward = int8_forward_case()
    gen = torch.Generator(device="cuda").manual_seed(13)

    for (k, n), ws in weights.items():
        ms = device_ms(lambda i: i8.int8_matmul(
            xs[k], *ws[i % len(ws)][:2], head_dtype(n), ws[i % len(ws)][2]),
            64)
        by_bytes, _ = int8_bounds_ms(DECODE_M, k, n, 4 if n == 32768 else 2)
        print(f"int8_matmul m={DECODE_M} k={k} n={n}: kernel_ms {ms:.6f} "
              f"bound_ms {by_bytes:.6f} (bytes)", flush=True)

    def run(mm):
        return lambda i: [mm(*call) for call in forward]

    kernel_ms = device_ms(run(i8.int8_matmul), 10)
    plain_ms = cuda_ms(run(i8.int8_matmul_reference), 3)
    lib = [(x, (w_q.float() * scale).bfloat16())
           for x, w_q, scale, _, _ in forward]
    library_ms = device_ms(lambda i: [torch.mm(x, w) for x, w in lib], 10)
    del lib
    bounds = [int8_bounds_ms(x.shape[0], *w_q.shape, 4 if dt == torch.float32
                             else 2) for x, w_q, _, dt, _ in forward]
    by_bytes = sum(b for b, _ in bounds)
    by_ops = sum(o for _, o in bounds)
    bms = max(by_bytes, by_ops)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    weight_mb = sum(call[1].numel() for call in forward) / 1e6
    print(f"int8_matmul, one decode forward (m={DECODE_M}, {len(forward)} "
          f"calls, {weight_mb:.1f} MB of int8 weights): kernel_ms "
          f"{kernel_ms:.6f} bound_ms {bms:.6f} ({bound_by}) plain_ms "
          f"{plain_ms:.6f} library_ms {library_ms:.6f} (torch.mm, bf16 x "
          f"against bf16 weight copies: twice the weight bytes) on {card}",
          flush=True)

    k, n = 1024, 4096
    ws = [(w_q, scale, torch.bfloat16, bias) for w_q, scale, bias
          in weights[(k, n)]]
    x = torch.randn((PREFILL_M, k), generator=gen, device="cuda").bfloat16()
    pre_ms = device_ms(lambda i: i8.int8_matmul(x, *ws[i % len(ws)]), 16)
    pre_plain = cuda_ms(lambda i: i8.int8_matmul_reference(
        x, *ws[i % len(ws)]), 3)
    wb = [(w_q.float() * scale).bfloat16() for w_q, scale, _, _ in ws]
    pre_lib = device_ms(lambda i: torch.mm(x, wb[i % len(wb)]), 16)
    pre_bytes, pre_ops = int8_bounds_ms(PREFILL_M, k, n, 2)
    pre_bound_by = "bytes" if pre_bytes >= pre_ops else "operations"
    print(f"int8_matmul m={PREFILL_M} k={k} n={n}: kernel_ms {pre_ms:.6f} "
          f"bound_ms {max(pre_bytes, pre_ops):.6f} ({pre_bound_by}; "
          f"operations at 989 TFLOP/s) plain_ms {pre_plain:.6f} library_ms "
          f"{pre_lib:.6f} (torch.mm bf16)", flush=True)
    del weights, forward, wb
    torch.cuda.empty_cache()
    return (dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=bound_by, library_ms=library_ms),
            dict(ms=pre_ms, plain_ms=pre_plain,
                 bound_ms=max(pre_bytes, pre_ops), bound_by=pre_bound_by,
                 library_ms=pre_lib))


def plain_int8_apply(x, w_q, scale, out_dtype=torch.float32, bias=None):
    """``int8_apply`` through the plain version on any device: what phase
    12's comparison run puts in the model's place."""
    from tf_operator_tpu_torch.ops.int8_dense import int8_matmul_reference

    out = int8_matmul_reference(x.reshape(-1, x.shape[-1]), w_q, scale,
                                out_dtype, bias)
    return out.reshape(*x.shape[:-1], w_q.shape[1])


def bf16_rounded(tree: dict) -> dict:
    """A numpy tree with every leaf rounded to bf16 (kept as f32)."""
    return {k: bf16_rounded(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v)).bfloat16().float().numpy()
            for k, v in tree.items()}


def int8_engine_phases(pa, base, params, prompts, card,
                       bf16_ref) -> tuple[dict, dict, np.ndarray]:
    """Phases 12 and 13: the int8_decode + kv_int8 engine in f32 through
    the kernels against the plain versions, then in bf16 through the
    kernels; returns the kernel runs' launches (f32, bf16) and the bf16
    run's first FIRST_STEPS greedy tokens ``[lane, step]``."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params

    cfg = replace(base, int8_decode=True, kv_int8=True)
    qparams = quantize_decode_params(params)
    kern = lockstep_phase(pa, cfg, qparams, prompts)
    # Five projections a layer (q, kv, out, in_proj, out_proj) and the
    # head: 41 int8 matmuls a forward, decode step or prefill alike.
    calls = 5 * cfg.n_layers + 1
    want = dict(paged_attend=0,
                paged_attend_kv8=cfg.n_layers * kern["forwards"],
                int8_matmul=calls * (kern["forwards"] + kern["prefills"]),
                int8_wgmma=0)  # f32 x: the prefills take the mma.sync tile
    if kern["launches"] != want:
        raise AssertionError(f"int8 + kv8 f32 launches {kern['launches']}, "
                             f"want {want} (the plain run launches none)")
    del qparams
    torch.cuda.empty_cache()

    q16 = quantize_decode_params(bf16_rounded(params))
    bf16 = engine_run(pa, replace(cfg, dtype=torch.bfloat16), q16, "kernel",
                      prompts, profile=PROFILE_STEPS)
    # A prefill's projections take the wgmma tile, its head (the last row)
    # and every decode step the weight stream.
    want = dict(paged_attend=0,
                paged_attend_kv8=cfg.n_layers * bf16["forwards"],
                int8_matmul=calls * (bf16["forwards"] + bf16["prefills"]),
                int8_wgmma=(calls - 1) * bf16["prefills"])
    if bf16["launches"] != want:
        raise AssertionError(f"int8 + kv8 bf16 launches {bf16['launches']}, "
                             f"want {want}")
    def busy(run):
        prof = run["profile"]
        return (f"device busy us/step {prof.get('busy_us', 'not measured')} "
                f"busy share {prof.get('busy_share', 'not measured')}")

    print(f"engine bf16 int8 + kv8 kernel: decode tokens/s "
          f"{bf16['decode_tok_s']:.2f} prefill_s {bf16['prefill_s']:.4f} "
          f"{busy(bf16)}; phase 7's bf16 engine in this run: decode tokens/s "
          f"{bf16_ref['decode_tok_s']:.2f} prefill_s "
          f"{bf16_ref['prefill_s']:.4f} {busy(bf16_ref)}; on {card}",
          flush=True)
    return (kern["launches"], bf16["launches"],
            bf16["tokens"][:FIRST_STEPS].T)


def flash_inputs(b, tq, tk, dtype, seed, fused=False):
    """Seeded q, k, v and dO of ``[b, T, H, Dh]`` at the slice's heads;
    with ``fused`` (tq == tk), q, k and v are the strided slices of one
    ``[b, T, 3, H, Dh]`` tensor, as the training forward's qkv projection
    hands them over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if fused:
        return (*randn(b, tq, 3, H, DH).unbind(2), randn(b, tq, H, DH))
    return randn(b, tq, H, DH), randn(b, tk, H, DH), randn(b, tk, H, DH), \
        randn(b, tq, H, DH)


def flash_compare(label, got, want, worst) -> None:
    """Hold each flash output against its plain version by the shared
    rule; print the max-abs errors and each output's largest share of its
    bound; keep each kernel's largest max-abs error in ``worst``."""
    from tf_operator_tpu_torch.testing import (
        FLASH_TOL,
        LSE_ATOL,
        flash_excess,
    )

    parts, bad = [], []
    for out, kernel in FLASH_OUTS.items():
        share = flash_excess(out, got[out], want[out])
        err = (got[out].float() - want[out].float()).abs().max().item()
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        parts.append(f"{out} {err:.3e} ({share:.3f})")
        if not share <= 1:
            bad.append(out)
    dtype = want["o"].dtype
    print(f"flash vs plain, {label}: max_abs_err (share of the bound) "
          f"{', '.join(parts)}; bound per element rtol|plain| + "
          f"atol rms(its row of plain), (rtol, atol) {FLASH_TOL[dtype]}, lse "
          f"{LSE_ATOL} absolute", flush=True)
    if bad:
        raise AssertionError(f"flash {label}: {bad} disagree")


def flash_designs(fa, dtype, dh) -> dict:
    """{kernel: the design its (dtype, dh) instance runs}, from the
    library's flash_design."""
    lib = fa._library()
    out = {}
    for i, name in enumerate(FLASH_KERNELS):
        code = lib.flash_design(int(dtype == torch.bfloat16), dh, i)
        if code not in FLASH_DESIGNS:
            raise AssertionError(f"flash_design({dtype}, {dh}, {name}) = "
                                 f"{code}")
        out[name] = FLASH_DESIGNS[code]
    return out


def flash_check_phase(fa) -> dict:
    """Each flash kernel against its plain version on the same inputs;
    the backward kernels are fed the plain forward's statistics. Returns
    each kernel's largest max-abs error over its outputs and the cases."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for dh in fa.HEAD_DIMS:
            print(f"flash designs, {dtype}, Dh={dh}: "
                  f"{flash_designs(fa, dtype, dh)}", flush=True)
        for seed, (name, tq, tk, causal, fused) in enumerate(FLASH_CASES):
            q, k, v, do = flash_inputs(2, tq, tk, dtype, seed, fused)
            scale = DH ** -0.5
            o, lse = fa.flash_fwd(q, k, v, causal, scale)
            o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
            delta = (do.float() * o_ref.float()).sum(-1).transpose(
                1, 2).contiguous()
            stats = (q, k, v, do, lse_ref, delta, causal, scale)
            dq = fa.flash_dq(*stats)
            dk, dv = fa.flash_dkv(*stats)
            torch.cuda.synchronize()
            dk_ref, dv_ref = fa.flash_dkv_reference(*stats)
            flash_compare(f"{dtype}, {name}",
                          dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv),
                          dict(o=o_ref, lse=lse_ref,
                               dq=fa.flash_dq_reference(*stats),
                               dk=dk_ref, dv=dv_ref), worst)
    return worst


def flash_reference_by_head(fa, q, k, v, do, lse, delta, causal, scale):
    """The plain versions' o, lse, dq, dk and dv, one head at a time
    (their f32 scores for every head at once would not fit)."""
    outs = {name: [] for name in FLASH_OUTS}
    for h in range(q.shape[2]):
        at = slice(h, h + 1)
        stats = (q[:, :, at], k[:, :, at], v[:, :, at], do[:, :, at],
                 lse[:, at], delta[:, at], causal, scale)
        o, l = fa.flash_fwd_reference(*stats[:3], causal, scale)
        dk, dv = fa.flash_dkv_reference(*stats)
        for name, x in zip(FLASH_OUTS, (o, l, fa.flash_dq_reference(*stats),
                                        dk, dv)):
            outs[name].append(x)
    return {name: torch.cat(xs, dim=1 if name == "lse" else 2)
            for name, xs in outs.items()}


def flash_bounds(b, t, causal=True) -> dict:
    """Least time of each kernel at [b, t, H, Dh] bf16: the bytes it must
    move (each input read once, each output written once) over the memory
    rate, against its products' flops (2 Dh a product per query-key pair
    the mask lets in) over the bf16 peak."""
    pairs = b * H * (t * (t + 1) // 2 if causal else t * t)
    tensor, row = b * t * H * DH * 2, b * H * t * 4
    work = {"flash_fwd": (2, 4 * tensor + row),        # q k v -> o, lse
            "flash_dq": (3, 5 * tensor + 2 * row),     # q k v do lse delta -> dq
            "flash_dkv": (4, 6 * tensor + 2 * row)}    # ... -> dk, dv
    out = {}
    for name, (products, nbytes) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = products * 2 * DH * pairs / PEAK_FLOPS[torch.bfloat16] * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations")
    return out


def flash_against_f32(fa, stats, got, want) -> None:
    """Kernel and plain version alike against the plain versions run in
    f32 on the same (bf16-valued) inputs: the rms and the largest error
    over each row's scale. The kernel's rms may exceed the plain
    version's by at most F32_RMS_RATIO: the kernel is no less exact."""
    from tf_operator_tpu_torch.testing import row_scale

    q, k, v, do, *rest = stats
    truth = flash_reference_by_head(
        fa, *(x.float() for x in (q, k, v, do)), *rest)
    parts, bad = [], []
    for out in ("o", "dq", "dk", "dv"):
        scale = row_scale(truth[out])
        errs = [((x[out].float() - truth[out]) / scale)
                for x in (got, want)]
        rms = [e.square().mean().sqrt().item() for e in errs]
        top = [e.abs().max().item() for e in errs]
        parts.append(f"{out} rms {rms[0]:.3e} / {rms[1]:.3e} max "
                     f"{top[0]:.3e} / {top[1]:.3e}")
        if not rms[0] <= F32_RMS_RATIO * rms[1]:
            bad.append(out)
    print(f"flash bf16 at the training shape against f32, over each row's "
          f"scale, kernel / plain: {'; '.join(parts)}", flush=True)
    if bad:
        raise AssertionError(f"flash kernels less exact than plain: {bad}")


def flash_timing_phase(fa, worst) -> dict:
    """The kernels at the training shape, checked against their plain
    versions and timed beside them and the library yardstick; returns
    {kernel: {ms, plain_ms, bound_ms, bound_by, library_ms, design}}."""
    b, t, scale = TRAIN_B, TRAIN_T, DH ** -0.5
    designs = flash_designs(fa, torch.bfloat16, DH)
    print(f"flash designs at the training shape: {designs}", flush=True)
    if set(designs.values()) != {"tma-wgmma"}:
        raise AssertionError(f"B1, B2 and B3 must run the TMA + wgmma design "
                             f"at the training shape: {designs}")
    q, k, v, do = flash_inputs(b, t, t, torch.bfloat16, seed=11, fused=True)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    stats = (q, k, v, do, lse, delta, True, scale)
    dq = fa.flash_dq(*stats)
    dk, dv = fa.flash_dkv(*stats)
    torch.cuda.synchronize()
    # The backward's plain versions get the kernel forward's lse and delta,
    # as the backward kernels do.
    want = flash_reference_by_head(fa, *stats)
    got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    flash_compare(f"{torch.bfloat16}, training shape B={b} T={t} fused",
                  got, want, worst)
    flash_against_f32(fa, stats, got, want)
    del want, got, dq, dk, dv
    torch.cuda.empty_cache()

    def fwd_bwd(i):
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        d = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return fa.flash_bwd_from_stats(q, k, v, do, lse, d, True, scale)

    ms = {"flash_fwd": device_ms(lambda i: fa.flash_fwd(q, k, v, True,
                                                        scale), 10),
          "flash_dq": device_ms(lambda i: fa.flash_dq(*stats), 10),
          "flash_dkv": device_ms(lambda i: fa.flash_dkv(*stats), 10)}
    fwd_bwd_ms = device_ms(fwd_bwd, 5)
    eager_fwd = cuda_ms(lambda i: fa.flash_fwd(q, k, v, True, scale), 10)
    eager_fwd_bwd = cuda_ms(fwd_bwd, 5)

    # The plain versions hold a few [b, H, t, t] f32 tensors at once: at
    # the training shape when eight of them fit in free memory, else at
    # T=2048.
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    pt = t if free >= 8 * b * H * t * t * 4 else 2048
    pq, pk, pv, pdo = (x[:, :pt] for x in (q, k, v, do))
    po, plse = fa.flash_fwd_reference(pq, pk, pv, True, scale)
    pdelta = (pdo.float() * po.float()).sum(-1).transpose(1, 2).contiguous()
    pstats = (pq, pk, pv, pdo, plse, pdelta, True, scale)
    torch.cuda.reset_peak_memory_stats()
    plain = {"flash_fwd": cuda_ms(lambda i: fa.flash_fwd_reference(
                 pq, pk, pv, True, scale), 2),
             "flash_dq": cuda_ms(lambda i: fa.flash_dq_reference(*pstats), 2),
             "flash_dkv": cuda_ms(lambda i: fa.flash_dkv_reference(*pstats),
                                  2)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del po, plse, pdelta, pstats
    torch.cuda.empty_cache()

    # Yardsticks the port never calls, on [b, H, t, Dh] copies: the
    # forward as scaled_dot_product_attention (whichever backend it picks),
    # the backward as aten's flash-attention backward, which computes dQ,
    # dK and dV in one call, and that pair's forward and backward.
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd_op = torch.ops.aten._scaled_dot_product_flash_attention
    lib_bwd_op = torch.ops.aten._scaled_dot_product_flash_attention_backward

    def lib_fwd():
        return lib_fwd_op(qh, kh, vh, 0.0, True, False, scale=scale)

    def lib_bwd(out):
        return lib_bwd_op(doh, qh, kh, vh, *out[:6], 0.0, True, *out[6:8],
                          scale=scale)

    out = lib_fwd()
    lib = {"flash_fwd": device_ms(lambda i: sdpa(qh, kh, vh, is_causal=True,
                                                 scale=scale), 10)}
    lib["flash_dq"] = lib["flash_dkv"] = device_ms(lambda i: lib_bwd(out), 10)
    lib_fwd_bwd_ms = device_ms(lambda i: lib_bwd(lib_fwd()), 5)
    del out, qh, kh, vh, doh

    bounds = flash_bounds(b, t)
    result = {}
    for name in ms:
        bms, by = bounds[name]
        result[name] = dict(ms=ms[name], plain_ms=plain[name], bound_ms=bms,
                            bound_by=by, library_ms=lib[name],
                            design=designs[name])
        print(f"{name} bf16 B={b} H={H} T={t} Dh={DH} causal: kernel_ms "
              f"{ms[name]:.6f} bound_ms {bms:.6f} ({by}) plain_ms "
              f"{plain[name]:.6f} at T={pt} library_ms {lib[name]:.6f}",
              flush=True)
    fwd_bound = bounds["flash_fwd"][0]
    bwd_bound = bounds["flash_dq"][0] + bounds["flash_dkv"][0]
    print(f"flash fwd: device_ms {ms['flash_fwd']:.6f} eager_ms "
          f"{eager_fwd:.6f}; fwd+bwd: device_ms {fwd_bwd_ms:.6f} eager_ms "
          f"{eager_fwd_bwd:.6f} bound_ms {fwd_bound + bwd_bound:.6f}; "
          f"plain versions at T={pt} (peak {peak_gb:.2f} GB); yardsticks, "
          f"not called by the port, device_ms: SDPA fwd "
          f"{lib['flash_fwd']:.6f}, aten flash bwd {lib['flash_dq']:.6f}, "
          f"aten flash fwd+bwd {lib_fwd_bwd_ms:.6f}", flush=True)
    return result


def profile_steps(run, steps: int, label: str) -> dict:
    """Where a step's time goes: ``steps`` calls of ``run()`` under
    torch.profiler. From the trace's device events it prints the busy
    time (the union of their intervals) against the host's wall time,
    and the kernels that take most of it; "not measured" when the trace
    holds no device event. The profiler's own cost is in the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        print(f"profile, {label}: device busy share not measured (the "
              "trace holds no device event)", flush=True)
        return {}
    busy, end, by_name = 0.0, -math.inf, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    print(f"profile, {steps} {label}: wall_us/step {wall_us / steps:.1f}"
          f" device_busy_us/step {busy / steps:.1f} busy share "
          f"{busy / wall_us:.4f} device events/step {len(spans) / steps:.1f}",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile:   {us / steps:9.1f} us/step  {name[:100]}",
              flush=True)
    return dict(busy_share=busy / wall_us, busy_us=busy / steps,
                events=len(spans) / steps)


def engine_run(pa, cfg, params, attend, prompts, profile: int = 0) -> dict:
    """The schedule of phases 6 and 7 through ContinuousEngine, with every
    serving kernel's count set to 0 just before the first join; with
    ``profile``, the last that many steps run under the profiler."""
    from tf_operator_tpu_torch.ops import int8_dense as i8
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                              kv_attend=attend)
    budget = FIRST_STEPS + LATER_STEPS
    pa.launches = pa.kv8_launches = i8.launches = i8.wgmma_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [engine.join(p, num_steps=budget) for p in prompts]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if slots != list(range(len(prompts))):
        raise AssertionError(f"joins got slots {slots}")
    tokens = []
    t0 = time.perf_counter()
    for _ in range(FIRST_STEPS):
        tokens.append(engine.step())
    decode_s = time.perf_counter() - t0
    engine.retire(2)
    engine.retire(3)
    rejoined = [engine.join(p, num_steps=LATER_STEPS)
                for p in later_prompts(prompts, cfg.vocab_size)]
    if rejoined != [2, 3]:
        raise AssertionError(f"re-joins got slots {rejoined}")
    for _ in range(LATER_STEPS - profile):
        tokens.append(engine.step())
    prof = (profile_steps(lambda: tokens.append(engine.step()), profile,
                          "decode steps") if profile else {})
    torch.cuda.synchronize()
    if not torch.isfinite(engine._logits).all():
        raise AssertionError("non-finite logits")
    launches = dict(paged_attend=pa.launches,
                    paged_attend_kv8=pa.kv8_launches,
                    int8_matmul=i8.launches, int8_wgmma=i8.wgmma_launches)
    # Prefills: one per prompt, and the shared-prefix join's suffix (the
    # exact re-join reuses the registered prompt and prefills nothing).
    out = dict(tokens=np.stack(tokens), kv=engine.kv_debug(),
               launches=launches, forwards=engine.steps_total,
               prefills=len(prompts) + 1, prefill_s=prefill_s,
               decode_tok_s=len(prompts) * FIRST_STEPS / decode_s,
               profile=prof)
    flags = "".join(f" {f}" for f in ("int8_decode", "kv_int8")
                    if getattr(cfg, f))
    print(f"engine {cfg.dtype}{flags} {attend}: prefill_s {prefill_s:.4f} "
          f"decode tokens/s {out['decode_tok_s']:.2f} forwards "
          f"{out['forwards']} kernel launches {launches} kv {out['kv']}",
          flush=True)
    del engine
    torch.cuda.empty_cache()
    return out


def later_prompts(prompts, vocab: int) -> list:
    """The schedule's two re-joins after lanes 2 and 3 retire: a prompt
    sharing lane 0's first two blocks (a suffix prefill), and an exact
    copy of lane 1's prompt (no prefill; its partial last block is copied
    on write)."""
    tail = np.random.default_rng(2).integers(0, vocab, (1, SHARED_TAIL))
    shared = np.concatenate([prompts[0][:, :2 * BLK], tail.astype(np.int32)],
                            1)
    return [shared, prompts[1]]


def lockstep_phase(pa, cfg, params, prompts) -> dict:
    """Phase 12: the engine through the kernels (a) and the same engine on
    the plain versions (b: kv_attend="gather", int8_apply pointed at its
    plain version) driven in lockstep on phase 6's schedule. After every
    prefill and every step each active lane's logits are held to
    LOGIT_TOL of b's, and then b is handed a's logits, so that both feed
    the same tokens at the next step (teacher forcing): with f32 weights
    the int8 path still rounds every projection's input to bf16, so two
    summation orders part by a few 1e-3 of a logit and a greedy choice
    between two logits that close is a coin toss, after which free-running
    lanes no longer compare. Returns a's launches, forwards and prefills."""
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.ops import int8_dense as i8
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    plain = mock.patch.object(transformer, "int8_apply", plain_int8_apply)
    a = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                         kv_attend="kernel")
    b = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                         kv_attend="gather")
    pa.launches = pa.kv8_launches = i8.launches = i8.wgmma_launches = 0
    worst, flips, decisions = 0.0, 0, 0

    def compare(slots):
        nonlocal worst, flips, decisions
        la, lb = a._logits[slots], b._logits[slots]
        gap = (la - lb).abs().max().item()  # a NaN counts as infinitely far
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
        flips += (la.argmax(-1) != lb.argmax(-1)).sum().item()
        decisions += len(slots)
        b._logits = a._logits.clone()

    def join(prompt, steps):
        slot = a.join(prompt, num_steps=steps)
        with plain:
            if b.join(prompt, num_steps=steps) != slot:
                raise AssertionError("lockstep engines joined other slots")
        compare([slot])

    def step(n):
        for _ in range(n):
            ta = a.step()
            with plain:
                tb = b.step()
            live = np.flatnonzero(a._active)
            if not np.array_equal(ta[live], tb[live]):
                raise AssertionError("teacher-forced tokens differ")
            compare(live.tolist())

    for p in prompts:
        join(p, FIRST_STEPS + LATER_STEPS)
    step(FIRST_STEPS)
    for engine in (a, b):
        engine.retire(2)
        engine.retire(3)
    for p in later_prompts(prompts, cfg.vocab_size):
        join(p, LATER_STEPS)
    step(LATER_STEPS)
    torch.cuda.synchronize()
    kv = a.kv_debug()
    if kv != b.kv_debug() or kv["prefix_hits"] < 1 or kv["cow_copies"] < 1:
        raise AssertionError(f"lockstep kv_debug {kv} and {b.kv_debug()}: "
                             "want them equal, a prefix share and a CoW")
    print(f"engine {cfg.dtype} int8_decode kv_int8, kernels vs plain in "
          f"lockstep: {decisions} greedy decisions, logits at most "
          f"{worst:.4e} apart (tolerance {LOGIT_TOL}), {flips} greedy "
          f"choices differing (each between two logits closer than that); "
          f"kv {kv}", flush=True)
    if not worst <= LOGIT_TOL:
        raise AssertionError("int8 + kv8 kernels and plain versions disagree")
    return dict(launches=dict(paged_attend=pa.launches,
                              paged_attend_kv8=pa.kv8_launches,
                              int8_matmul=i8.launches,
                              int8_wgmma=i8.wgmma_launches),
                forwards=a.steps_total,
                prefills=len(prompts) + 1)


def sampler_known_answers() -> None:
    """Phase 14 (a): the sampler's integer parts on the card against
    Random123's and JAX's known answers, and against the CPU bit for bit
    (a uniform float is a bitcast of its bits)."""
    from tf_operator_tpu_torch import random as tr

    for key, ctr, out in RANDOM123:
        words = (torch.tensor(w, dtype=torch.int64, device="cuda")
                 for w in (*key, *ctr))
        got = [int(w) for w in tr.threefry2x32(*words)]
        if got != list(out):
            raise AssertionError(f"threefry2x32 key {key} counter {ctr}: "
                                 f"{got}, want {list(out)}")
    key = tr.PRNGKey(0, "cuda")
    split, fold = tr.split(key, 3).tolist(), tr.fold_in(key, 7).tolist()
    if split != SPLIT_0_3 or fold != FOLD_IN_0_7:
        raise AssertionError(f"split(PRNGKey(0), 3) {split}, fold_in("
                             f"PRNGKey(0), 7) {fold}")
    shape, key = (4, 32768), tr.PRNGKey(2024, "cuda")
    same_bits = torch.equal(tr.random_bits(key, shape).cpu(),
                            tr.random_bits(key.cpu(), shape))
    same_floats = torch.equal(
        tr.uniform(key, shape).cpu().view(torch.int32),
        tr.uniform(key.cpu(), shape).view(torch.int32))
    print(f"sampler on the card: threefry2x32 at Random123's 3 known "
          f"answers, split(PRNGKey(0), 3) = {split}, fold_in(PRNGKey(0), 7) "
          f"= {fold}; random_bits {shape} equal to the CPU's: {same_bits}, "
          f"uniform: {same_floats}", flush=True)
    if not (same_bits and same_floats):
        raise AssertionError("the card's random bits differ from the CPU's")


def replay_values(model, prompt, feed, temperature, top_p, seed, steps):
    """What a solo run at (temperature, top_p, seed) samples from at each
    of ``steps`` steps when fed the tokens ``feed`` ``[B, steps]``
    (teacher forcing): ``[steps, B, V]`` f32, gumbel(key i) + the scaled,
    nucleus-filtered logits (the logits, greedy), by generate's own
    operations, so their argmax is the token generate takes; and the
    scaled logits before the filter."""
    from tf_operator_tpu_torch.models.transformer import (
        _nucleus_filter,
        _prefill,
    )
    from tf_operator_tpu_torch.random import PRNGKey, gumbel, split

    keys = split(PRNGKey(seed, prompt.device), steps)
    temp = torch.tensor(temperature, dtype=torch.float32,
                        device=prompt.device)
    out, pre = [], []
    with torch.no_grad():
        cache, logits = _prefill(model, prompt)
        for i in range(steps):
            values = scaled = logits
            if temperature > 0:
                scaled = logits / temp
                kept = (scaled if top_p is None
                        else _nucleus_filter(scaled, top_p))
                values = gumbel(keys[i], scaled.shape) + kept
            out.append(values)
            pre.append(scaled)
            if i + 1 < steps:
                logits = model(feed[:, i:i + 1], cache)[:, 0]
    return torch.stack(out), torch.stack(pre)


def mass_ahead(scaled: torch.Tensor) -> torch.Tensor:
    """Each token's probability mass ranked ahead of it in a row of scaled
    logits (the nucleus filter's cutoff statistic), in f64."""
    order = torch.argsort(scaled, stable=True).flip(-1)
    p = torch.softmax(scaled.double()[order], -1)
    out = torch.empty_like(p)
    out[order] = p.cumsum(-1) - p
    return out


def top_two_gap(values: torch.Tensor) -> torch.Tensor:
    """Each row's largest value minus its second largest."""
    top = values.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def solo_parting(model, base, prompt, got, t, tp, seed):
    """Where a lane's tokens ``got`` (numpy) part from the solo
    ``generate`` of its prompt and sampling parameters on the card: None
    when they are identical, else (the first parting step, the solo run's
    top-two gap there), which phases 14 (b) and 15 (a) hold to
    ``NEAR_TIE``."""
    from tf_operator_tpu_torch.models.transformer import generate
    from tf_operator_tpu_torch.random import PRNGKey

    steps = len(got)
    prompt = torch.as_tensor(prompt, device=model.device)
    kw = dict(temperature=t, top_p=tp, rng=PRNGKey(seed, model.device)) \
        if t > 0 else {}
    solo = generate(base, model, prompt, steps, **kw)
    want = solo[0].cpu().numpy()
    if np.array_equal(want, got):
        return None
    step = int(np.flatnonzero(want != got)[0])
    values, _ = replay_values(model, prompt, solo, t, tp, seed, steps)
    return step, top_two_gap(values[step, 0]).item()


def sampled_engine_run(pa, cfg, params, attend, prompts, steps,
                       profile: int = 0, mix=SAMPLING) -> dict:
    """Phase 14's engine: the prompts join with ``mix``'s parameters (B4's
    counts set to 0 just before the first join), ``steps`` timed steps,
    then ``profile`` more under torch.profiler."""
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                              kv_attend=attend)
    pa.launches = pa.kv8_launches = 0
    slots = [engine.join(p, num_steps=steps + profile, temperature=t,
                         top_p=tp, seed=seed)
             for p, (t, tp, seed) in zip(prompts, mix)]
    if slots != list(range(len(prompts))):
        raise AssertionError(f"sampled joins got slots {slots}")
    torch.cuda.synchronize()
    tokens = []
    t0 = time.perf_counter()
    for _ in range(steps):
        tokens.append(engine.step())
    decode_s = time.perf_counter() - t0
    label = "sampled" if mix == SAMPLING else "greedy"
    prof = (profile_steps(engine.step, profile, f"{label} decode steps")
            if profile else {})
    torch.cuda.synchronize()
    if not torch.isfinite(engine._logits).all():
        raise AssertionError("non-finite logits")
    out = dict(tokens=np.stack(tokens), launches=pa.launches,
               forwards=engine.steps_total,
               decode_tok_s=len(prompts) * steps / decode_s, profile=prof)
    print(f"engine {cfg.dtype} {label} mix {attend}: decode tokens/s "
          f"{out['decode_tok_s']:.2f} forwards {out['forwards']} "
          f"paged_attend launches {out['launches']}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return out


def sampler_engine_phase(pa, base, params, prompts, card) -> dict:
    """Phase 14 (b) and (c): the sampled mix through the engine in f32
    (kernel against gather, each lane against its solo generate), then in
    bf16 through the kernel in turns with the same prompts all greedy
    (greedy, sampled, sampled, greedy), each timed and its last steps
    profiled: the sampler's cost. Returns B4's launches on the f32 kernel
    run and the first bf16 sampled run."""
    from tf_operator_tpu_torch.models.transformer import _decode_model

    runs = {attend: sampled_engine_run(pa, base, params, attend, prompts,
                                       FIRST_STEPS)
            for attend in ("kernel", "gather")}
    kern = runs["kernel"]
    if (kern["launches"] != LAYERS * kern["forwards"]
            or runs["gather"]["launches"]):
        raise AssertionError(f"sampled engine paged_attend launches "
                             f"{kern['launches']} over {kern['forwards']} "
                             f"forwards (gather {runs['gather']['launches']})")
    if not np.array_equal(kern["tokens"], runs["gather"]["tokens"]):
        diff = np.argwhere(kern["tokens"] != runs["gather"]["tokens"])
        raise AssertionError(f"sampled kernel tokens differ from gather at "
                             f"(step, slot) {diff[:8].tolist()}")
    model = _decode_model(base, params, None)
    parted = []
    for lane, (prompt, (t, tp, seed)) in enumerate(zip(prompts, SAMPLING)):
        part = solo_parting(model, base, prompt, kern["tokens"][:, lane], t,
                            tp, seed)
        if part is not None:
            parted.append((lane, *part))
    del model
    torch.cuda.empty_cache()
    print(f"engine f32 sampled mix {SAMPLING} (temperature, top_p, seed): "
          f"kernel tokens == gather tokens over {kern['tokens'].shape} "
          f"(step, slot); lanes parting from their solo generate (lane, "
          f"first step, the solo run's top-two gap there): {parted} "
          f"(limit {NEAR_TIE}, at most one lane)", flush=True)
    if len(parted) > 1 or any(gap > NEAR_TIE for _, _, gap in parted):
        raise AssertionError(f"sampled lanes part from solo generate away "
                             f"from a near-tie: {parted}")

    greedy = [(0.0, None, 0)] * len(prompts)
    turns = [(name, sampled_engine_run(
        pa, replace(base, dtype=torch.bfloat16), params, "kernel", prompts,
        FIRST_STEPS, profile=PROFILE_STEPS, mix=mix))
        for name, mix in (("greedy", greedy), ("sampled", SAMPLING),
                          ("sampled", SAMPLING), ("greedy", greedy))]
    for name, run in turns:
        if run["launches"] != LAYERS * run["forwards"]:
            raise AssertionError(f"bf16 {name} launches {run['launches']}")

    def read(name, key):
        return [run["profile"].get(key, "not measured")
                for n, run in turns if n == name]

    print(f"engine bf16 kernel, in turns greedy, sampled, sampled, greedy: "
          f"decode tokens/s {[round(r['decode_tok_s'], 2) for _, r in turns]}"
          f"; device busy us/step sampled {read('sampled', 'busy_us')} "
          f"greedy {read('greedy', 'busy_us')}; device operations/step "
          f"sampled {read('sampled', 'events')} greedy "
          f"{read('greedy', 'events')}; busy share sampled "
          f"{read('sampled', 'busy_share')} greedy "
          f"{read('greedy', 'busy_share')} on {card}", flush=True)
    return {"sampled engine f32 (14b)": kern["launches"],
            "sampled engine bf16 (14c)": turns[1][1]["launches"]}


def int8_generate_phase(i8, base, params, card) -> dict:
    """Phase 14 (d): ``generate`` with int8_decode + kv_int8 at B=4
    prompts of 875 tokens, 64 sampled steps. In f32 through the kernels,
    with B5's counts set to 0 just before it; then the kernel route and
    the plain route (``plain_int8_apply``) replayed on the kernel run's
    tokens, step by step (``replay_values``): the kernel replay must take
    every token generate took, the values both routes keep must lie within
    LOGIT_TOL / T, and each plain decision must equal the kernel's or fall
    at a near-tie (``INT8_NEAR_TIE``, ``INT8_MASS_TOL``).
    Teacher-forced, as phase 12: the int8 path rounds every projection's
    input to bf16, so the two routes' logits part by up to ~2e-2, and a
    free-running lane parts at a Gumbel gap that small (a chance of that
    size a step) and then no longer compares. Then bf16: tokens/s and
    B5's launches. Returns B5's launches by kernel and run."""
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.convert import quantize_decode_params
    from tf_operator_tpu_torch.models.transformer import (
        _decode_model,
        _prefill,
        generate,
    )
    from tf_operator_tpu_torch.random import PRNGKey

    cfg = replace(base, int8_decode=True, kv_int8=True)
    model = _decode_model(cfg, quantize_decode_params(params), None)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (INT8_GEN_B, INT8_GEN_P)).astype(np.int32),
        device=model.device)
    t, tp, seed, steps = (INT8_GEN_T, INT8_GEN_TOP_P, INT8_GEN_SEED,
                          INT8_GEN_STEPS)
    kw = dict(temperature=t, top_p=tp, rng=PRNGKey(seed, model.device))
    calls = 5 * cfg.n_layers + 1
    # A prefill and steps - 1 decode forwards (the last step's is not run).
    want_calls = calls * steps

    i8.launches = i8.wgmma_launches = 0
    toks = generate(cfg, model, prompt, steps, **kw)
    torch.cuda.synchronize()
    f32 = (i8.launches, i8.wgmma_launches)
    if f32 != (want_calls, 0):  # f32 x: the prefill takes the mma.sync tile
        raise AssertionError(f"int8 generate f32 launches {f32}, want "
                             f"{(want_calls, 0)}")
    values, scaled = replay_values(model, prompt, toks, t, tp, seed, steps)
    if not torch.equal(values.argmax(-1).T.to(torch.int32), toks):
        raise AssertionError("the kernel replay does not take generate's "
                             "tokens")
    with mock.patch.object(transformer, "int8_apply", plain_int8_apply):
        plain, plain_scaled = replay_values(model, prompt, toks, t, tp, seed,
                                            steps)
    kept = (values > -1e29) & (plain > -1e29)
    worst = (values - plain).abs()[kept].max().item()
    mine, theirs = values.argmax(-1), plain.argmax(-1)
    gaps = top_two_gap(values)
    decisions, unexplained = [], []
    for i, b in (mine != theirs).nonzero().tolist():
        ahead = (mass_ahead(scaled[i, b]), mass_ahead(plain_scaled[i, b]))
        # A token one route's nucleus keeps and the other's drops, its mass
        # ahead within INT8_MASS_TOL of top_p in both.
        cut = [x for x in {mine[i, b].item(), theirs[i, b].item()}
               if (values[i, b, x] > -1e29) != (plain[i, b, x] > -1e29)
               and all(abs(m[x].item() - tp) <= INT8_MASS_TOL
                       for m in ahead)]
        row = dict(step=i, row=b, gap=gaps[i, b].item(), cutoff=[
            (x, ahead[0][x].item(), ahead[1][x].item()) for x in cut])
        decisions.append(row)
        if not (row["gap"] <= INT8_NEAR_TIE or cut):
            unexplained.append(row)
    print(f"generate f32 int8_decode kv_int8 B={INT8_GEN_B} P={INT8_GEN_P} "
          f"steps {steps} T {t} top_p {tp}, kernels vs plain_int8_apply "
          f"fed the same tokens: kept values at most {worst:.4e} apart "
          f"(tolerance {LOGIT_TOL / t:.4e}); {len(decisions)} of "
          f"{mine.numel()} decisions differ: {decisions} (each at a "
          f"top-two gap within {INT8_NEAR_TIE:.4e}, or at the nucleus "
          f"cutoff: token, mass ahead in the kernel and the plain route, "
          f"within {INT8_MASS_TOL:.4e} of top_p); B5 launches {f32[0]}",
          flush=True)
    if unexplained or not worst <= LOGIT_TOL / t:
        raise AssertionError(f"int8 generate: kernel and plain routes "
                             f"disagree: {unexplained}")
    del model, values, plain, scaled, plain_scaled
    torch.cuda.empty_cache()

    cfg16 = replace(cfg, dtype=torch.bfloat16)
    model = _decode_model(cfg16, quantize_decode_params(
        bf16_rounded(params)), None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _prefill(model, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    i8.launches = i8.wgmma_launches = 0
    t0 = time.perf_counter()
    toks = generate(cfg16, model, prompt, steps, **kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    bf16 = (i8.launches, i8.wgmma_launches)
    # The prefill's 40 projections on the wgmma tile; its head row and
    # every decode forward on the weight stream.
    if bf16 != (want_calls, calls - 1):
        raise AssertionError(f"int8 generate bf16 launches {bf16}, want "
                             f"{(want_calls, calls - 1)}")
    if toks.shape != (INT8_GEN_B, steps) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("int8 generate bf16: bad tokens")
    print(f"generate bf16 int8_decode kv_int8 B={INT8_GEN_B} P={INT8_GEN_P} "
          f"steps {steps}: {gen_s:.4f} s, prefill alone {prefill_s:.4f} s, "
          f"decode tokens/s {INT8_GEN_B * steps / (gen_s - prefill_s):.2f} "
          f"(generate's time less the prefill's); B5 launches {bf16[0]}, "
          f"{bf16[1]} of them on the wgmma tile ({calls} a forward) on "
          f"{card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"int8_matmul": {"int8 generate f32 (14d)": f32[0] - f32[1],
                            "int8 generate bf16 (14d)": bf16[0] - bf16[1]},
            "int8_matmul_prefill": {"int8 generate bf16 (14d)": bf16[1]}}


def http(base_url: str, path: str, body: dict | None = None,
         timeout: float = 300.0):
    """One request to the front: (status, parsed JSON) — NDJSON as a list
    of lines, /metrics as text."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base_url + path, data=data, headers={
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
    return status, (json.loads(raw) if "json" in kind else raw)


def front_requests(prompts) -> list[dict]:
    """Phase 15's eight /generate bodies: phase 6's four prompts greedy,
    then the same four with ``SAMPLING``'s mix, 64 steps each."""
    greedy = [dict(tokens=p.tolist(), num_steps=FIRST_STEPS, timing=True)
              for p in prompts]
    sampled = [dict(tokens=p.tolist(), num_steps=FIRST_STEPS, timing=True,
                    temperature=t, seed=seed,
                    **({} if tp is None else {"top_p": tp}))
               for p, (t, tp, seed) in zip(prompts, SAMPLING)]
    return greedy + sampled


def send_all(base_url: str, bodies, interval: float = 0.0) -> tuple:
    """POST ``bodies`` to /generate from one client thread each, started
    ``interval`` seconds apart; returns (responses in order, wall s)."""
    out = [None] * len(bodies)

    def client(i):
        out[i] = http(base_url, "/generate", bodies[i])

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
        if interval:
            time.sleep(interval)
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    bad = [(i, r) for i, r in enumerate(out) if r is None or r[0] != 200]
    if bad:
        raise AssertionError(f"/generate failed: {bad[:2]}")
    return [r[1] for r in out], wall


def latency_line(label: str, responses, wall: float) -> dict:
    """Requests/s, TTFT and ITL p50/p99 (the server's per-row timing),
    and decode tokens/s over the wall time, for one round."""
    rows = [t for r in responses for t in r["timing"]]
    ttft = np.array([t["ttft_ms"] for t in rows])
    itl = np.concatenate([t.get("itl_ms", []) for t in rows])
    toks = sum(len(x) for r in responses for x in r["tokens"])
    out = dict(rps=len(responses) / wall, tok_s=toks / wall,
               ttft=np.percentile(ttft, [50, 99]).tolist(),
               itl=np.percentile(itl, [50, 99]).tolist())
    print(f"front {label}: {len(responses)} requests in {wall:.4f} s: "
          f"requests/s {out['rps']:.4f}, TTFT p50/p99 ms "
          f"{out['ttft'][0]:.3f}/{out['ttft'][1]:.3f}, ITL p50/p99 ms "
          f"{out['itl'][0]:.3f}/{out['itl'][1]:.3f}, decode tokens/s "
          f"{out['tok_s']:.2f} ({toks} tokens over the wall time)",
          flush=True)
    return out


def open_front(cfg, params, **flags):
    """The port's server at phase 6's serving width (4 slots, blk 128,
    the kernel read) on an ephemeral port, serving: (supervisor, server,
    base URL)."""
    from tf_operator_tpu_torch.serve import serve_lm

    args = serve_lm.front_args(
        device="cuda", max_batch=len(LANES), kv_block=BLK,
        kv_attend="kernel", max_seq_len=cfg.max_seq_len, port=0, **flags)
    supervisor, server = serve_lm.build_front(cfg, params, args)
    server.start()
    return supervisor, server, "http://" + server.endpoint


def reset_counts(pa, i8) -> None:
    pa.launches = pa.kv8_launches = i8.launches = i8.wgmma_launches = 0


def front_f32_phase(pa, i8, base, params, prompts) -> tuple[dict, list]:
    """Phase 15 (a): the f32 front. The eight requests at once; each
    greedy response equal to its prompt's solo ``generate`` on the card,
    each sampled one equal or parting at a near-tie (phase 14 (b)'s
    rule); a streamed request equal to the buffered greedy one;
    /healthz, /metrics and /debug/serve in the JAX front's shapes; B4 at
    n_layers launches a decode forward. Returns (B4's launches, the
    greedy responses' tokens)."""
    from tf_operator_tpu_torch.models.transformer import _decode_model

    supervisor, server, url = open_front(base, params)
    reset_counts(pa, i8)
    bodies = front_requests(prompts)
    responses, wall = send_all(url, bodies)
    engine = supervisor.engine
    launches, forwards = pa.launches, engine.steps_total
    status, lines = http(url, "/generate", dict(
        tokens=prompts[0].tolist(), num_steps=FIRST_STEPS, stream=True))
    streamed = [t for line in lines for t in line["tokens"][0]]
    if status != 200 or streamed != responses[0]["tokens"][0]:
        raise AssertionError(f"stream {status} differs from the buffered "
                             f"greedy response")
    _, health = http(url, "/healthz")
    _, metrics = http(url, "/metrics")
    _, debug = http(url, "/debug/serve")
    snapshot = json.loads(json.dumps(supervisor.debug_snapshot()))
    families = set(re.findall(r"^# TYPE (tpu_serve_\S+)", metrics, re.M))
    missing = [k for k in READINESS_KEYS if k not in health]
    if missing or families != set(SERVE_FAMILIES) or debug != snapshot:
        raise AssertionError(f"/healthz lacks {missing}, /metrics families "
                             f"{sorted(families ^ set(SERVE_FAMILIES))} "
                             f"differ, or /debug/serve != the snapshot")
    if launches != LAYERS * forwards or not forwards:
        raise AssertionError(f"front f32 B4 launches {launches} over "
                             f"{forwards} forwards")
    server.drain()
    del supervisor, server, engine
    model = _decode_model(base, params, None)
    parted = []
    for i, (body, resp) in enumerate(zip(bodies, responses)):
        part = solo_parting(model, base, np.asarray(body["tokens"]),
                            np.asarray(resp["tokens"][0]),
                            body.get("temperature", 0.0), body.get("top_p"),
                            body.get("seed", 0))
        if part is not None:
            parted.append((i, *part, body.get("temperature", 0.0)))
    del model
    torch.cuda.empty_cache()
    print(f"front f32: 8 requests ({wall:.4f} s), {forwards} decode "
          f"forwards, B4 launches {launches}; responses parting from their "
          f"solo generate (request, first step, top-two gap, temperature): "
          f"{parted} (greedy: none; sampled: limit {NEAR_TIE}, at most one);"
          f" stream == buffered greedy ({len(streamed)} tokens); /healthz "
          f"{sorted(health)}; /metrics {len(families)} tpu_serve_* "
          f"families; /debug/serve == snapshot", flush=True)
    if (any(t <= 0 for *_, t in parted) or len(parted) > 1
            or any(gap > NEAR_TIE for _, _, gap, _ in parted)):
        raise AssertionError(f"front responses part from solo generate: "
                             f"{parted}")
    return launches, [r["tokens"][0] for r in responses[:len(prompts)]]


def front_bf16_phase(pa, i8, base, params, prompts, card,
                     engine_ref) -> int:
    """Phase 15 (b): the bf16 front, what a serving user feels. The
    eight requests at once, then at a steady arrival rate (half the
    burst's requests/s), each with requests/s, TTFT and ITL p50/p99 and
    decode tokens/s beside phase 7's engine-only rate; then 8 decode
    steps with four lanes live, under torch.profiler. Returns B4's
    launches."""
    cfg = replace(base, dtype=torch.bfloat16)
    supervisor, server, url = open_front(cfg, params)
    reset_counts(pa, i8)
    bodies = front_requests(prompts)
    burst = latency_line("bf16 burst", *send_all(url, bodies))
    steady = latency_line("bf16 steady", *send_all(
        url, bodies, interval=2.0 / burst["rps"]))
    sched = supervisor.scheduler
    # As long as the longest prompt leaves room for, so that every lane
    # still decodes once the profiler has started (its start takes
    # seconds on a busy host) and through its steps.
    long = [dict(b, num_steps=cfg.max_seq_len - max(LANES) - 1)
            for b in bodies[:len(prompts)]]
    clients = threading.Thread(target=send_all, args=(url, long),
                               daemon=True)
    clients.start()
    limit = time.monotonic() + 120
    while supervisor.active_slots < len(prompts) or sched._prefilling:
        if time.monotonic() > limit:
            raise AssertionError("front bf16: lanes never all decoding")
        time.sleep(0.001)

    def next_step():
        at, limit = sched.decode_steps, time.monotonic() + 60
        while sched.decode_steps == at:
            if time.monotonic() > limit or not supervisor.active_slots:
                raise AssertionError("front bf16: the loop stopped "
                                     "decoding under the profiler")
            time.sleep(0.0002)

    next_step()
    prof = profile_steps(next_step, PROFILE_STEPS,
                         "front bf16 decode steps (4 lanes live)")
    clients.join(timeout=600)
    launches, forwards = pa.launches, supervisor.engine.steps_total
    server.drain()
    if launches != LAYERS * forwards:
        raise AssertionError(f"front bf16 B4 launches {launches} over "
                             f"{forwards} forwards")
    print(f"front bf16: decode tokens/s burst {burst['tok_s']:.2f}, steady "
          f"{steady['tok_s']:.2f}; phase 7's engine alone in this run "
          f"{engine_ref['decode_tok_s']:.2f}; device busy share of the "
          f"profiled steps {prof.get('busy_share', 'not measured')}; B4 "
          f"launches {launches} over {forwards} forwards, on {card}",
          flush=True)
    del supervisor, server
    torch.cuda.empty_cache()
    return launches


def plain_greedy_shortfalls(cfg, tree, prompts, got) -> list:
    """Each lane's greedy tokens ``got`` held, teacher-forced, against the
    plain route: the lane's prompt and its own tokens fed through the
    decode model with ``plain_int8_apply`` in B5's place. Returns each
    decision that is not the plain route's greedy choice as (lane, step,
    token, plain max minus the token's plain logit)."""
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.transformer import _decode_model

    model = _decode_model(cfg, tree, None)
    out = []
    with mock.patch.object(transformer, "int8_apply", plain_int8_apply):
        for lane, (prompt, toks) in enumerate(zip(prompts, got)):
            feed = torch.as_tensor(np.asarray([toks], dtype=np.int32),
                                   device=model.device)
            values, _ = replay_values(
                model, torch.as_tensor(prompt, device=model.device), feed,
                0.0, None, 0, feed.shape[1])
            values = values[:, 0].float()
            picked = values.gather(-1, feed[0, :, None].long())[:, 0]
            short = values.max(-1).values - picked
            out += [(lane, step, int(toks[step]), short[step].item())
                    for step in short.nonzero().flatten().tolist()]
    del model
    torch.cuda.empty_cache()
    return out


def front_int8_phase(pa, i8, base, params, prompts, want) -> dict:
    """Phase 15 (c): the bf16 ``--int8 --kv-int8`` front over the tree
    quantized from the bf16-rounded weights, as phase 13's: four greedy
    requests, each equal to phase 13's engine's first tokens of its lane
    ``want`` (the same engine, tree and one-shot prefill; a decode step
    computes every slot, so a lane's tokens do not depend on when the
    others join). Where a lane parts from them, its tokens are held
    teacher-forced against the plain route (``plain_greedy_shortfalls``):
    each must be the plain route's greedy choice or lie within
    ``INT8_NEAR_TIE`` of it. The kv8 B4 at n_layers launches a decode
    forward, B5's stream at 41 a forward and its wgmma tile on every
    prefill. Returns the launches by kernel."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params

    cfg = replace(base, dtype=torch.bfloat16, int8_decode=True,
                  kv_int8=True)
    tree = quantize_decode_params(bf16_rounded(params))
    supervisor, server, url = open_front(cfg, tree)
    reset_counts(pa, i8)
    responses, wall = send_all(url, front_requests(prompts)[:len(prompts)])
    forwards = supervisor.engine.steps_total
    got = dict(paged_attend=pa.launches, paged_attend_kv8=pa.kv8_launches,
               int8_matmul=i8.launches - i8.wgmma_launches,
               int8_matmul_prefill=i8.wgmma_launches)
    server.drain()
    del supervisor, server
    torch.cuda.empty_cache()
    calls = 5 * cfg.n_layers + 1
    print(f"front bf16 int8 + kv8: 4 requests in {wall:.4f} s, {forwards} "
          f"decode forwards, launches {got}", flush=True)
    if (got["paged_attend"]
            or got["paged_attend_kv8"] != cfg.n_layers * forwards
            or got["int8_matmul"] < calls * forwards
            or got["int8_matmul_prefill"] < calls - 1):
        raise AssertionError(f"front int8 + kv8: launches {got}")
    tokens = [r["tokens"][0] for r in responses]
    if any(len(t) != FIRST_STEPS for t in tokens):
        raise AssertionError(f"front int8 + kv8: response lengths "
                             f"{[len(t) for t in tokens]}")
    parted = [lane for lane, t in enumerate(tokens)
              if t != want[lane].tolist()]
    print(f"front bf16 int8 + kv8: lanes whose greedy tokens part from "
          f"phase 13's engine: {parted}", flush=True)
    if parted:
        short = plain_greedy_shortfalls(
            cfg, tree, [prompts[i] for i in parted],
            [tokens[i] for i in parted])
        short = [(parted[lane], *rest) for lane, *rest in short]
        print(f"front bf16 int8 + kv8, teacher-forced against "
              f"plain_int8_apply: decisions off the plain route's greedy "
              f"choice (lane, step, token, shortfall): {short} (each within "
              f"{INT8_NEAR_TIE:.4e})", flush=True)
        if any(gap > INT8_NEAR_TIE for *_, gap in short):
            raise AssertionError(f"front int8 + kv8 tokens part from the "
                                 f"plain route beyond a near-tie: {short}")
    return got


def front_fault_phase(pa, i8, base, params, prompts, greedy) -> int:
    """Phase 15 (d): the f32 front with ``step_raise`` armed once: the
    four greedy requests replayed across the watchdog's rebuild equal
    (a)'s responses and /healthz reads one restart; then the drain with
    requests in flight: the admitted ones finish whole, the queued ones
    get the typed 503. Returns B4's launches."""
    supervisor, server, url = open_front(
        base, params, faults=f"step_raise@{FIRST_STEPS // 2}")
    reset_counts(pa, i8)
    bodies = front_requests(prompts)[:len(prompts)]
    responses, _ = send_all(url, bodies)
    _, health = http(url, "/healthz")
    replayed = [r["tokens"][0] for r in responses]
    if replayed != greedy or health.get("watchdog_restarts") != 1:
        raise AssertionError(f"faulted front: tokens equal (a)'s "
                             f"{replayed == greedy}, restarts "
                             f"{health.get('watchdog_restarts')}")
    launches = pa.launches
    out = [None] * 6

    def client(i):
        out[i] = http(url, "/generate", bodies[i % len(bodies)])

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads[:4]:
        t.start()
    limit = time.monotonic() + 120
    while supervisor.active_slots < 4:
        if time.monotonic() > limit:
            raise AssertionError("drain: slots never filled")
        time.sleep(0.001)
    for t in threads[4:]:
        t.start()
    while supervisor.queue_depth < 2:
        if time.monotonic() > limit:
            raise AssertionError("drain: requests never queued")
        time.sleep(0.001)
    server.done.set()
    _, draining = http(url, "/healthz")
    server.drain()
    for t in threads:
        t.join(timeout=120)
    done = [(s, b["tokens"][0]) for s, b in out[:4]]
    queued = [(s, b.get("code")) for s, b in out[4:]]
    print(f"front faults: step_raise at step {FIRST_STEPS // 2}, the 4 "
          f"greedy responses == (a)'s across {health['watchdog_restarts']} "
          f"restart; drain: /healthz draining {draining.get('draining')}, "
          f"admitted {[s for s, _ in done]}, queued {queued}", flush=True)
    if (not draining.get("draining")
            or [s for s, _ in done] != [200] * 4
            or [t for _, t in done] != greedy
            or queued != [(503, "draining")] * 2):
        raise AssertionError("the front's drain: admitted requests must "
                             "finish, queued ones get the typed 503")
    del supervisor, server
    torch.cuda.empty_cache()
    return launches


def key_bias_rows(name: str, p: torch.Tensor):
    """The key-bias slice of an attention bias, or None."""
    if name.endswith("attn.qkv.bias"):
        return p[1]
    if name.endswith("attn.kv.bias"):
        return p[0]
    return None


def train_run(cfg, params, batch, steps: int, tx, *, plain=False,
              profile=False, first_grads=False, **step_kw) -> dict:
    """``steps`` train steps from ``params`` on one batch, with the flash
    counts set to 0 just before the first; with ``plain``,
    reference_attention takes the kernels' place in the model. Returns the
    model, the losses, the counts, after one warm-up step each step's
    seconds and, with ``first_grads``, a copy of the first step's
    gradients by parameter name."""
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        make_lm_train_step,
    )

    model = load_params(transformer.Transformer(cfg), params)
    state = TrainState.create(model, tx)
    step = make_lm_train_step(model, tx, **step_kw)
    forced = mock.patch.object(
        transformer, "attention",
        lambda q, k, v, causal: fa.reference_attention(q, k, v, causal))
    losses, seconds, grads = [], [], {}
    with forced if plain else contextlib.nullcontext():
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            if i:
                seconds.append(time.perf_counter() - t0)
            elif first_grads:
                grads = {name: p.grad.detach().clone()
                         for name, p in model.named_parameters()}
        counts = dict(fwd=fa.fwd_launches, dq=fa.dq_launches,
                      dkv=fa.dkv_launches)
        prof = (profile_steps(lambda: step(state, batch), 1, "train step")
                if profile else {})
    return dict(model=model, losses=losses, seconds=seconds, counts=counts,
                grads=grads, profile=prof)


def train_f32_phase(params) -> dict:
    """The f32 trainer through the kernels against the same trainer with
    reference_attention, 3 steps of adamw on the warmup-cosine schedule:
    step 0's gradients (at lr 0), the losses, then the weights. Returns
    the kernel run's flash launches."""
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.testing import excess
    from tf_operator_tpu_torch.train.steps import adamw, warmup_cosine

    cfg = TransformerConfig(dtype=torch.float32, **LM)
    rng = np.random.default_rng(5)
    batch = {name: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, F32_TRAIN_T)).astype(np.int64)).cuda()
        for name in ("tokens", "targets")}
    tx = adamw(warmup_cosine(1e-3, 10, warmup_steps=1))
    if tx.learning_rate(0) != 0:
        raise AssertionError("step 0 must run at lr 0")
    runs = {plain: train_run(cfg, params, batch, F32_STEPS, tx, plain=plain,
                             first_grads=True)
            for plain in (False, True)}
    kern, ref = runs[False], runs[True]
    want = (cfg.n_layers * F32_STEPS,) * 3
    got = tuple(kern["counts"][k] for k in ("fwd", "dq", "dkv"))
    if got != want or any(ref["counts"].values()):
        raise AssertionError(f"f32 trainer counts {kern['counts']} (plain "
                             f"run {ref['counts']}), want {want}")

    # Step 0's gradients, leaf by leaf.
    shares = {}
    for name, g in kern["grads"].items():
        g, w = g.clone(), ref["grads"][name].clone()
        for x in (g, w):
            rows = key_bias_rows(name, x)
            if rows is not None:
                rows.zero_()
        shares[name] = excess(g, w, GRAD_RTOL, GRAD_ATOL)
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    print(f"trainer f32 step-0 gradients, {len(shares)} leaves: largest "
          f"shares of the bound (rtol {GRAD_RTOL} |plain| + atol "
          f"{GRAD_ATOL} rms(row of plain)) "
          + ", ".join(f"{n} {x:.4f}" for n, x in worst), flush=True)

    loss_err = max(abs(a - b) for a, b in zip(kern["losses"],
                                              ref["losses"]))
    lr_sum = sum(tx.learning_rate(i) for i in range(F32_STEPS))
    max_err, far, total, at = -1.0, 0, 0, None
    ref_params = dict(ref["model"].named_parameters())
    for name, p in kern["model"].named_parameters():
        diff = (p.detach() - ref_params[name].detach()).abs()
        if diff.max().item() > max_err:
            max_err, at = diff.max().item(), (name, diff.argmax().item())
        rows = key_bias_rows(name, diff)
        if rows is not None:
            rows.zero_()
        far += (diff > TRAIN_PARAM_FRAC * lr_sum).sum().item()
        total += diff.numel()
    # Adam's amplification: the step-0 gradients at the element whose
    # weight moved most apart, beside its leaf's gradient rms.
    g_k = kern["grads"][at[0]].flatten()[at[1]].item()
    g_p = ref["grads"][at[0]].flatten()[at[1]].item()
    g_rms = ref["grads"][at[0]].square().mean().sqrt().item()
    print(f"trainer f32 B={TRAIN_B} T={F32_TRAIN_T}: losses kernels "
          f"{kern['losses']} plain {ref['losses']} (max diff {loss_err:.3e},"
          f" tolerance {TRAIN_LOSS_TOL}); weights max diff {max_err:.3e} "
          f"(tolerance {ADAM_BOUND * lr_sum:.3e}) in {at[0]}[{at[1]}], "
          f"whose step-0 gradient is {g_k:.3e} (kernels) {g_p:.3e} (plain) "
          f"against its leaf's rms {g_rms:.3e}; {far} of {total} beyond "
          f"{TRAIN_PARAM_FRAC * lr_sum:.3e} (tolerance share "
          f"{TRAIN_FAR_SHARE}); counts {kern['counts']}", flush=True)
    if not max(shares.values()) <= 1:
        raise AssertionError(f"f32 trainer: step-0 gradients disagree: "
                             f"{worst}")
    if not (loss_err <= TRAIN_LOSS_TOL and max_err <= ADAM_BOUND * lr_sum
            and far <= TRAIN_FAR_SHARE * total):
        raise AssertionError("f32 trainer: kernels and plain attention "
                             "disagree")
    if not all(math.isfinite(x) for x in kern["losses"]):
        raise AssertionError("f32 trainer: non-finite loss")
    counts = kern["counts"]
    del runs, kern, ref, ref_params
    torch.cuda.empty_cache()
    return dict(flash_fwd=counts["fwd"], flash_dq=counts["dq"],
                flash_dkv=counts["dkv"])


def train_bf16_phase(params, card: str) -> dict:
    """bench.py's LM training step at full width; returns the flash
    launches of the timed run."""
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.train.steps import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    designs = flash_designs(fa, cfg.dtype, cfg.d_model // cfg.n_heads)
    rng = np.random.default_rng(0)
    batch = {name: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T)).astype(np.int64)).cuda()
        for name in ("tokens", "targets")}
    torch.cuda.reset_peak_memory_stats()
    run = train_run(cfg, params, batch, BF16_STEPS, adamw(1e-4),
                    profile=True, xent_chunk=XENT_CHUNK,
                    xent_dot_dtype=torch.bfloat16)
    losses, counts = run["losses"], run["counts"]
    want = cfg.n_layers * BF16_STEPS
    if (counts["fwd"], counts["dq"], counts["dkv"]) != (want,) * 3:
        raise AssertionError(f"bf16 trainer counts {counts}, want {want} "
                             "of each kernel")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 trainer losses {losses}")
    n_params = sum(p.numel() for p in run["model"].parameters())
    step_s = sum(run["seconds"]) / len(run["seconds"])
    tok_s = TRAIN_B * TRAIN_T / step_s
    flops_tok = 6 * n_params + 6 * cfg.n_layers * cfg.d_model * TRAIN_T
    mfu = tok_s * flops_tok / PEAK_FLOPS[torch.bfloat16]
    print(f"trainer bf16 B={TRAIN_B} T={TRAIN_T} ({n_params} params): "
          f"losses {losses}; step_s {run['seconds']} mean {step_s:.6f} "
          f"(median {float(np.median(run['seconds'])):.6f}) "
          f"tokens/s {tok_s:.2f} MFU {mfu:.6f} (6N + 6LdS = {flops_tok} "
          f"flops a token at 989 TFLOP/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; counts "
          f"{counts}, designs {designs} on {card}", flush=True)
    launches = dict(flash_fwd=counts["fwd"], flash_dq=counts["dq"],
                    flash_dkv=counts["dkv"])
    del run
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import int8_dense as i8
    from tf_operator_tpu_torch.ops import paged_attention as pa

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"kind {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sources = ("flash_attention", "int8_dense", "paged_attention")
    _build.build(*sources)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "setmaxnreg")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    for name, count in TMA_INSTANCES.items():
        log = _build.build_log(name)
        if not log:
            continue
        spills = ws_spills(log)
        print(f"ptxas {name}: spill stores (bytes) of the TMA instances "
              f"{spills}", flush=True)
        if len(spills) != count or any(spills.values()):
            raise AssertionError(f"{name}: want {count} TMA instances and no "
                                 f"spill: {spills}")

    kernel = kernel_phase(pa)
    flash_err = flash_check_phase(fa)
    flash = flash_timing_phase(fa, flash_err)

    base = TransformerConfig(vocab_size=32768, d_model=1024, n_heads=H,
                             n_kv_heads=KV, n_layers=LAYERS, d_ff=4096,
                             max_seq_len=S, dtype=torch.float32)
    params = init_params(base, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab_size, (1, n)).astype(np.int32)
               for n in LANES]

    f32 = {attend: engine_run(pa, base, params, attend, prompts)
           for attend in ("kernel", "gather")}
    want = dict(paged_attend=LAYERS * f32["kernel"]["forwards"],
                paged_attend_kv8=0, int8_matmul=0, int8_wgmma=0)
    if (f32["kernel"]["launches"] != want
            or any(f32["gather"]["launches"].values())):
        raise AssertionError(
            f"kernel launches {f32['kernel']['launches']} (gather "
            f"{f32['gather']['launches']}), want {want} and 0")
    if not np.array_equal(f32["kernel"]["tokens"], f32["gather"]["tokens"]):
        diff = np.argwhere(f32["kernel"]["tokens"] != f32["gather"]["tokens"])
        raise AssertionError(f"f32 kernel tokens differ from gather at "
                             f"(step, slot) {diff[:8].tolist()}")
    kv = f32["kernel"]["kv"]
    if kv["prefix_hits"] < 1 or kv["cow_copies"] < 1:
        raise AssertionError(f"no prefix share or CoW: {kv}")
    print(f"engine f32: kernel tokens == gather tokens over "
          f"{f32['kernel']['tokens'].shape} (step, slot)", flush=True)

    bf16 = engine_run(pa, replace(base, dtype=torch.bfloat16), params,
                      "kernel", prompts, profile=PROFILE_STEPS)
    if bf16["launches"]["paged_attend"] != LAYERS * bf16["forwards"]:
        raise AssertionError(f"bf16 kernel launches {bf16['launches']}")
    print(f"engine bf16 kernel: decode tokens/s {bf16['decode_tok_s']:.2f} "
          f"prefill_s {bf16['prefill_s']:.4f} on {card}", flush=True)
    torch.cuda.empty_cache()

    lm_params = init_params(TransformerConfig(**LM), seed=0)
    flash_f32 = train_f32_phase(lm_params)
    flash_bf16 = train_bf16_phase(lm_params, card)
    del lm_params

    int8_err = int8_check_phase(i8)
    int8, int8_prefill = int8_timing_phase(i8, card)
    kv8 = kernel_phase(pa, kv8=True)
    int8_f32, int8_bf16, int8_greedy = int8_engine_phases(
        pa, base, params, prompts, card, bf16)

    sampler_known_answers()
    sampled = sampler_engine_phase(pa, base, params, prompts, card)
    int8_gen = int8_generate_phase(i8, base, params, card)

    front_f32, greedy = front_f32_phase(pa, i8, base, params, prompts)
    front_bf16 = front_bf16_phase(pa, i8, base, params, prompts, card, bf16)
    front_int8 = front_int8_phase(pa, i8, base, params, prompts,
                                  int8_greedy)
    front_faults = front_fault_phase(pa, i8, base, params, prompts, greedy)

    # Each kernel's launches on every path of this run that drives it.
    paths = {
        "paged_attend": {
            "engine f32 (6)": f32["kernel"]["launches"]["paged_attend"],
            "engine bf16 (7)": bf16["launches"]["paged_attend"], **sampled,
            "front f32 (15a)": front_f32, "front bf16 (15b)": front_bf16,
            "front faults f32 (15d)": front_faults},
        "paged_attend_kv8": {
            "int8 engine f32 (12)": int8_f32["paged_attend_kv8"],
            "int8 engine bf16 (13)": int8_bf16["paged_attend_kv8"],
            "front int8 (15c)": front_int8["paged_attend_kv8"]},
        "int8_matmul": {
            "int8 engine f32 (12)": (int8_f32["int8_matmul"]
                                     - int8_f32["int8_wgmma"]),
            "int8 engine bf16 (13)": (int8_bf16["int8_matmul"]
                                      - int8_bf16["int8_wgmma"]),
            **int8_gen["int8_matmul"],
            "front int8 (15c)": front_int8["int8_matmul"]},
        "int8_matmul_prefill": {
            "int8 engine bf16 (13)": int8_bf16["int8_wgmma"],
            **int8_gen["int8_matmul_prefill"],
            "front int8 (15c)": front_int8["int8_matmul_prefill"]},
    }
    for name in flash_bf16:
        paths[name] = {"trainer f32 (8)": flash_f32[name],
                       "trainer bf16 (9)": flash_bf16[name]}

    src = "tf_operator_tpu_torch/ops/csrc/"
    replaces = {"flash_fwd": 253, "flash_dq": 297, "flash_dkv": 331}
    kernels = [dict(
        name="paged_attend", route="cuda", source=src + "paged_attention.cu",
        replaces="tf_operator_tpu/ops/paged_attention.py:126", **kernel,
        design=OTHER_DESIGNS["paged_attend"].format(S=pa.SPLITS),
    ), dict(
        name="paged_attend_kv8", route="cuda",
        source=src + "paged_attention.cu",
        replaces="tf_operator_tpu/ops/paged_attention.py:126", **kv8,
        design=OTHER_DESIGNS["paged_attend_kv8"].format(S=pa.SPLITS),
    ), dict(
        name="int8_matmul", route="cuda", source=src + "int8_dense.cu",
        replaces="tf_operator_tpu/ops/int8_dense.py:47",
        max_abs_err=int8_err["stream"], **int8,
        design=OTHER_DESIGNS["int8_matmul"],
    ), dict(
        name="int8_matmul_prefill", route="cuda",
        source=src + "int8_dense.cu",
        replaces="tf_operator_tpu/ops/int8_dense.py:47",
        max_abs_err=int8_err["tma-wgmma"], **int8_prefill,
        design=OTHER_DESIGNS["int8_matmul_prefill"],
    )] + [dict(
        name=name, route="cuda", source=src + "flash_attention.cu",
        replaces=f"tf_operator_tpu/ops/flash_attention.py:{line}",
        max_abs_err=flash_err[name], **flash[name],
    ) for name, line in replaces.items()]
    for k in kernels:
        k["paths"] = paths[k["name"]]
        k["launches"] = sum(k["paths"].values())
        if not all(k["paths"].values()):
            raise AssertionError(f"{k['name']} not launched on a path: "
                                 f"{k['paths']}")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
