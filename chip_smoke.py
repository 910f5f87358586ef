"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device line: the card's name and power limit (nvidia-smi) and the
   torch version; TF32 off for matmuls and cuDNN;
2. build: every CUDA kernel of the path from the sources in this
   checkout (one nvcc per source, started together);
3. kernel vs plain: the paged-attention kernel against its plain PyTorch
   version at the slice's shapes (4 lanes at 3500/1750/875/437 tokens,
   H=16, KV=4, Dh=64, blk=128, S=4096), for t=1, t=3 and a lane at index
   0 with an all-zero table, in bf16 and f32; then its device time
   (CUDA-graph replay) beside its eager time per call, the plain
   version's device time, the byte bound and, as a yardstick the port
   never calls, scaled_dot_product_attention over the pre-gathered K/V;
4. engine, f32: the full-width paged-decode LM (vocab 32768, d 1024, 16
   heads, 4 KV heads, 8 layers, d_ff 4096, S 4096; random weights from a
   seed) in ContinuousEngine with kv_attend="kernel" and "gather": four
   prompts join, 64 decode steps, two lanes retire, a prompt sharing the
   first two blocks of lane 0 and an exact copy of lane 1's prompt join
   (prefix share and copy-on-write), 16 more steps. Greedy tokens must
   be identical between the two reads, and the kernel must have launched
   n_layers times per decode forward;
5. engine, bf16: the same schedule with the kernel; decode tokens/s and
   prefill seconds; its last 8 steps under torch.profiler (device busy
   share of a step, the kernels that take most device time);
6. the ``kernels`` JSON line, the card line, and last the result line.

It exits non-zero without a result when torch sees no CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = 1e-4  # f32 sums over up to 4096 keys, in another order
LANES = [3500, 1750, 875, 437]
H, KV, DH, BLK, S = 16, 4, 64, 128, 4096
LAYERS, FIRST_STEPS, LATER_STEPS = 8, 64, 16
SHARED_TAIL = 300  # fresh tokens after the two shared blocks
PROFILE_STEPS = 8  # of the bf16 run's last steps, under torch.profiler


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def bound_ms(lanes, t, dtype) -> tuple[float, str]:
    """Least time for one call: the bytes it must move (q, the K/V rows
    the lanes own, the table entries it reads, the index, the f32 output)
    over the memory rate, against its flops over the peak for the type."""
    elem = torch.tensor([], dtype=dtype).element_size()
    b = len(lanes)
    rows = sum(n + t for n in lanes)
    nblk = sum(-(-(n + t) // BLK) for n in lanes)
    nbytes = (b * t * H * DH * elem + 2 * rows * KV * DH * elem
              + 4 * nblk + 4 * b + 4 * b * t * H * DH)
    # q.k and p.v: 2 flops per multiply-add, per key row, per query head.
    flops = 2 * 2 * t * H * DH * sum(n + t for n in lanes)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_phase(pa) -> dict:
    """The kernel against its plain version, then timed."""
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, lanes, t in (("t=1", LANES, 1), ("t=3", LANES, 3),
                               ("inactive lane", [3500, 0, 875, 437], 1)):
            q, pools, table, index = paged_case(lanes, t, dtype, seed=t)
            pk, pv = pools[0]
            got = pa.paged_attend(q, pk, pv, table, index)
            torch.cuda.synchronize()
            want = pa.paged_attend_reference(q, pk, pv, table, index)
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"kernel {name} {dtype}: bad output")
            case_err = (got - want).abs().max().item()
            print(f"kernel vs plain, {dtype}, {name}: max_abs_err "
                  f"{case_err:.3e} (tolerance {TOL})", flush=True)
            if not case_err <= TOL:
                raise AssertionError(f"kernel {name} {dtype} disagrees")
            err = max(err, case_err)

    # Time at the main path's shapes: bf16, t=1, one pool pair per layer
    # (135 MB in all, beyond the 50 MB L2), walked in layer order.
    # Device times come from CUDA-graph replay (device_ms); the kernel's
    # eager time per call, host wrapper included, is printed beside them.
    q, pools, table, index = paged_case(LANES, 1, torch.bfloat16, seed=9,
                                        layers=LAYERS)

    def kernel(i):
        return pa.paged_attend(q, *pools[i % LAYERS], table, index)

    eager_ms = cuda_ms(kernel, 400)
    kernel_ms = device_ms(kernel, 400)
    plain_ms = device_ms(lambda i: pa.paged_attend_reference(
        q, *pools[i % LAYERS], table, index), 40)
    g = H // KV
    valid = (torch.arange(S, device="cuda")[None, :]
             <= index.long()[:, None])[:, None, None, :]  # [b, 1, 1, S]
    dense = []
    for pk, pv in pools:
        # Pre-gathered dense K/V, expanded to every query head.
        k, v = (p[table.long()].reshape(len(LANES), S, KV, DH)
                .transpose(1, 2).repeat_interleave(g, dim=1)
                for p in (pk, pv))
        dense.append((k, v))
    qh = q.transpose(1, 2)
    library_ms = device_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            qh, *dense[i % LAYERS], attn_mask=valid), 100)
    bms, bound_by = bound_ms(LANES, 1, torch.bfloat16)
    print(f"paged_attend bf16 t=1: kernel_ms {kernel_ms:.6f} (eager, host "
          f"included: {eager_ms:.6f}) plain_ms {plain_ms:.6f} library_ms "
          f"{library_ms:.6f} bound_us {bms * 1e3:.4f} ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bound_by, library_ms=library_ms)


def profile_steps(engine, steps: int, tokens: list) -> None:
    """Where a decode step's time goes: ``steps`` engine steps under
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
                tokens.append(engine.step())
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
        print("profile: device busy share not measured (the trace holds "
              "no device event)", flush=True)
        return
    busy, end, by_name = 0.0, -math.inf, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    print(f"profile, {steps} decode steps: wall_us/step {wall_us / steps:.1f}"
          f" device_busy_us/step {busy / steps:.1f} busy share "
          f"{busy / wall_us:.4f} device events/step {len(spans) / steps:.1f}",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile:   {us / steps:9.1f} us/step  {name[:100]}",
              flush=True)


def engine_run(pa, cfg, params, attend, prompts, profile: int = 0) -> dict:
    """The schedule of phases 4 and 5 through ContinuousEngine; with
    ``profile``, the last that many steps run under the profiler."""
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                              kv_attend=attend)
    budget = FIRST_STEPS + LATER_STEPS
    pa.launches = 0
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
    rng = np.random.default_rng(2)
    shared = np.concatenate(
        [prompts[0][:, :2 * BLK],
         rng.integers(0, cfg.vocab_size, (1, SHARED_TAIL)).astype(np.int32)], 1)
    rejoined = [engine.join(shared, num_steps=LATER_STEPS),
                engine.join(prompts[1], num_steps=LATER_STEPS)]
    if rejoined != [2, 3]:
        raise AssertionError(f"re-joins got slots {rejoined}")
    for _ in range(LATER_STEPS - profile):
        tokens.append(engine.step())
    if profile:
        profile_steps(engine, profile, tokens)
    torch.cuda.synchronize()
    if not torch.isfinite(engine._logits).all():
        raise AssertionError("non-finite logits")
    out = dict(tokens=np.stack(tokens), kv=engine.kv_debug(),
               launches=pa.launches, forwards=engine.steps_total,
               prefill_s=prefill_s,
               decode_tok_s=len(prompts) * FIRST_STEPS / decode_s)
    print(f"engine {cfg.dtype} {attend}: prefill_s {prefill_s:.4f} decode "
          f"tokens/s {out['decode_tok_s']:.2f} forwards {out['forwards']} "
          f"kernel launches {out['launches']} kv {out['kv']}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.ops import _build
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
    _build.build("paged_attention")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log("paged_attention").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    kernel = kernel_phase(pa)

    base = TransformerConfig(vocab_size=32768, d_model=1024, n_heads=H,
                             n_kv_heads=KV, n_layers=LAYERS, d_ff=4096,
                             max_seq_len=S, dtype=torch.float32)
    params = init_params(base, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab_size, (1, n)).astype(np.int32)
               for n in LANES]

    f32 = {attend: engine_run(pa, base, params, attend, prompts)
           for attend in ("kernel", "gather")}
    want = LAYERS * f32["kernel"]["forwards"]
    if f32["kernel"]["launches"] != want or f32["gather"]["launches"]:
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
    if bf16["launches"] != LAYERS * bf16["forwards"]:
        raise AssertionError(f"bf16 kernel launches {bf16['launches']}")
    print(f"engine bf16 kernel: decode tokens/s {bf16['decode_tok_s']:.2f} "
          f"prefill_s {bf16['prefill_s']:.4f} on {card}", flush=True)

    kernels = [dict(
        name="paged_attend", route="cuda",
        source="tf_operator_tpu_torch/ops/csrc/paged_attention.cu",
        replaces="tf_operator_tpu/ops/paged_attention.py:126",
        launches=bf16["launches"], **kernel,
    )]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
