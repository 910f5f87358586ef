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
   f32, each a single launch, and at a speculative verify's rows, t=5
   and t=8 (``SPEC_LANES``: four lanes at different counters, one lane's
   rows straddling a block boundary, one at counter 0); then its device
   time (CUDA-graph replay) beside its eager time per call, the plain
   version's device time, the byte bound and, as a yardstick the port
   never calls, scaled_dot_product_attention over the pre-gathered K/V,
   at t=1 and at t=8;
4. flash kernels vs plain: the design each instance runs (bf16 and f32,
   Dh 32, 64 and 128; flash_design: "tma-wgmma", the warp-specialised TMA
   + wgmma kernels of bf16 B1 and B3, or "mma.sync"), then the forward (O
   and LSE), dQ and dK/dV kernels against their plain versions at B=2,
   H=16, Dh=64, causal at T=1024 and T=1000 (a ragged tail, once with q,
   k, v as strided slices of one fused projection) and full at tq=512,
   tk=1024, in bf16 and f32, and the instance phase 18 (b)'s entry point
   runs (f32, B=8, T=128, H=4, Dh=128, causal, fused q/k/v:
   ``entry_flash_shape``); each element within the rule of
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
    t=3, a lane at index 0 and the speculative t=5 and t=8 cases, q in
    bf16 and f32, int8 pools with f32 scale pools, each a single launch;
    then its device time, the byte bound, the plain version's time and
    SDPA over pre-gathered, dequantized K/V, at t=1 and t=8;
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
16. constrained decoding (``serve/constrain.py``, the engine's constraint
    pool and logprobs) at phase 6's width, over the identity vocabulary:
    (a) f32, kv_attend="kernel", 4 slots, one lane each under a regex, a
    choices and a json_schema program and one free lane
    (``CONSTRAINED_LANES``), greedy and then with ``SAMPLING``'s mix: each
    lane equal to its solo ``constrained_generate`` (the free lane:
    ``generate``) on the card or parting at a near-tie (phase 14 (b)'s
    rule), every token legal at its state, every grammar complete and
    parsed, B4 at n_layers launches a forward; (b) bf16 through
    ``build_front`` with ``--logprobs-k 5``: one /generate request each
    with json_schema, regex, choices, logprobs and n = 4 at T 0.8, then
    one with a stop sequence (finish reasons, trimming, the logprob rows'
    order and the greedy token's logprob the top one, the n-best
    ``choices``), each spec's compile seconds from the server's spans,
    decode tokens/s of all-free and all-constrained bursts in turns, and
    the device operations and time the mask adds to a bf16 step (8
    profiled steps with it and without it, in turns); (c) one constrained
    greedy lane on the bf16 int8 + kv8 engine over phase 13's tree: legal
    and complete, the kv8 B4 and both B5 routes launched; the phase's wall
    time printed;
17. speculative decoding (``models/spec_decode.py``, the engine's
    ``spec_step``, ``--spec-k``) at phase 6's width, 4 slots, the kernel
    read: (a) f32, the target as its own draft at k = 4: the kernel read's
    tokens equal the gather read's, each lane equal to phase 6's plain
    engine and to its solo ``speculative_generate`` on the card (or
    parting at a near-tie, phase 14 (b)'s rule), nearly every proposal
    accepted, B4 at n_layers launches a round (t = 5); (b) bf16, a draft
    of the target's first 4 blocks (and its embeddings, norm and head) at
    k = 7, the largest the kernel's row cap takes, ``SAMPLING``'s mix: 8
    rounds under torch.profiler (device operations and busy us a round),
    the accept rate, rounds and decode tokens/s beside phase 7's plain
    engine, each lane equal to its solo stream or parting where the solo
    run's decision margin is within ``BF16_TIE`` (``spec_replay``); (c)
    bf16 on kv8 pools, one lane at k = 4: the kv8 B4 at t = 5, the solo
    kv8 stream; (d) the f32 front with ``--spec-k 4`` (serve_lm's default
    draft depth: the same truncated draft): four greedy requests at once,
    each equal to (a)'s engine stream, /healthz and /debug/serve with the
    ``spec`` section, /metrics with both spec families counted; (e) k = 8
    refused at construction, naming ``MAX_ROWS``, before any device work;
18. checkpoints, resume and eval (``train/checkpoint.py``,
    ``train/dist_lm.py``, ``evaluate_lm``): (a) at phase 9's shape,
    ``CKPT_STEPS`` bf16 steps, a save through ``CheckpointManager`` (the
    blocking host copy and the write until durable timed apart, the bytes
    on disk), a restore into a fresh model and optimiser (timed) that must
    equal the saved state bitwise (every weight, moment and step count),
    then ``CKPT_MORE`` steps of the restored trainer and of its
    uninterrupted twin, their losses within ``CKPT_LOSS_TOL``; then
    ``evaluate_lm`` over three batches of ``EVAL_ROWS`` rows (the last
    short) at T = 8192: B1 n_layers times a batch and no B2/B3, the loss
    within ``EVAL_LOSS_TOL`` and the final hidden states within
    ``EVAL_HIDDEN_TOL`` (max-abs) of the same eval through
    reference_attention, while a control (that eval with a non-causal
    attention) must read above both, eval tokens/s; (b) the entry point as a subprocess on the card with no
    ``--device`` (``ENTRY_ARGS``): run 1 with ``TPU_CKPT_ACK_FILE`` gets
    one SIGTERM after its first ack, must ack a forced save (read with the
    port's ``read_ack``), keep training and exit 138 at ``ENTRY_FAIL_AT``;
    run 2 prints ``resumed from step`` ``ENTRY_FAIL_AT + 1`` and exits 0;
    run 3, uninterrupted, must end on run 2's final checkpoint (bitwise,
    else within phase 8's Adam bound, the largest difference printed);
    phase 26 (k) runs in a thread beside (b) (neither times anything);
19. disaggregated prefill, prefix pulls and the host KV tier
    (``serve/disagg.py``, ``serve/tier.py``, the engine's ingest, export,
    retention, spill and restore) at phase 6's width: (a) f32, a
    ``PrefillWorker`` on the card prefills the four prompts (lane 1 in
    chunks of ``SHIP_CHUNK``), each payload through ``json``, a fresh
    engine ingests them (each ingest timed), the lanes join by their exact
    prefixes and decode 64 greedy steps, bitwise phase 6's tokens, B4 at
    n_layers launches a forward, the decode step's compile count unmoved;
    lane 0's export (timed), ingested by a second fresh engine, decodes 16
    steps, again phase 6's; (b) f32 with retention and a ``TIER_BYTES``
    host tier in a pool that holds lanes 0 and 1 but not all four
    (``tier_pool_blocks``): the four prompts served, then served again,
    each lane bitwise its first round and phase 6, at least two restores,
    the second round's prefill tokens fewer by the restored lengths, each
    spill and restore timed from its span (bytes, ms, GB/s); then one lane
    on phase 13's bf16 int8 + kv8 tree spilled and restored, bitwise its
    unspilled run, with the kv8 B4 and both B5 routes launched; (c) bf16
    over HTTP on 127.0.0.1: a ``--role prefill`` replica
    (``serve_lm.build_prefill``) and two decode fronts, L and S (S with
    the tier): the four prompts at once on L, each prompt's POST /prefill
    (payload bytes, seconds), then the four ``shipped_kv`` requests at
    once on S, each equal to L's response; a prompt sharing lane 0's
    first two blocks served on L, pulled from L by ``GET
    /prefix/<digest>`` and sent to S as ``shipped_kv``, equal; a tampered
    payload gets ``ship_failed``, an unknown digest ``prefix_not_found``;
    S's /healthz ``prefixes`` and ``tier_prefixes``, /metrics the five
    ship and tier families counted; the TTFT p50 of shipped against local
    requests; the phase's wall time;
20. the dense slot engine and the legacy coalescing engine at phase 6's
    width: (a) ``ContinuousEngine(kv_paged=False)`` in bf16, the four
    prompts, 64 greedy steps (decode tokens/s beside phase 7's paged
    engine, the slot tensor's bytes, 8 steps under torch.profiler), each
    lane equal to phase 7's lane or parting where the solo run's margin
    between the two choices is within ``BF16_TIE``; its f32 twin against
    phase 6 (``NEAR_TIE``); (b) the f32 dense spec engine, the target as
    its own draft at k = 4, against (a)'s f32 twin and each lane's solo
    ``speculative_generate``; (c) phase 13's int8 + kv8 tree on the dense
    engine, one lane, against solo ``generate``, with B5's stream and
    wgmma tile launched; (d) over HTTP on 127.0.0.1: a ``--kv-dense``
    front (the four prompts at once equal to (a); a ``shipped_kv``
    request prefilled locally, counted ``unsupported``; ``GET
    /prefix/<digest>`` the typed ``prefix_not_found``), then a legacy
    front, ``--batch-window 250 --max-batch 8``: six same-shape greedy
    prompts alone, then twice at once (fewer decodes than requests, a
    batch of two rows or more, each answer its solo answer or parting at
    a near-tie, the second burst bitwise the first). No hand kernel runs
    on the dense bf16 path: the dense read has no block table for B4,
    and the prefill is the decode read's, as in JAX;
21. the image classifiers (``models/resnet.py``, ``models/mnist.py``, the
    classifier steps, ``train/device_input.py``, ``train/dist_mnist.py``;
    no hand kernel lies on this path: cuDNN's convolutions and BatchNorm):
    (a) a reduced f32 ResNet (``CHECK_STAGES``, width 16, 64^2, B = 8)
    from ``convert.py``'s initialiser, 3 SGD steps on the card against
    the same steps on the CPU, TF32 off (losses and logits within
    ``CLS_LOGIT_RTOL``, every param and batch_stats leaf within
    ``CLS_LEAF_RTOL``), and a control with TF32 on that must read above
    the logits' limit; (b) bf16 ResNet-50 at ``bench.py``'s resident cell
    (B = 256, 224^2 crops of 1024 uint8 records of 256^2 on the card, 1000
    classes, ``sgd_momentum(0.1)``, ``make_resident_train_loop`` of 20
    steps), each stem: a warm call, 2 timed calls (images/s, MFU by
    ``bench.py``'s 3 x 4.09e9 flops an image), peak memory, one profiled
    step, a finite loss; (c) ``evaluate`` over 256 + 256 + 100 rows, the
    count exactly 612, each batch padded to 256; (d) ``python -m
    tf_operator_tpu_torch.train.dist_mnist --steps 60 --batch 256`` to
    ``OK``, a run killed at step 30 (exit 138) resumed to ``OK`` beside an
    evaluator replica (TF_CONFIG ``evaluator``) that reaches ``DONE``, run
    in a thread beside phase 22 (c) and (d) (its img/s read beside them);
    the phase's seconds. ``tools/torch_classifier_probe.py`` runs this
    phase alone;
22. Mixture-of-Experts (``models/moe.py``, the MoE blocks, the aux loss;
    no hand kernel of its own: B1-B3 run in the attention blocks, B4 kv8
    and B5 in the int8 engine): (a) f32, TF32 off, a reduced MoE LM
    (``MOE_F32``: d 256, 4 heads of 64, 2 layers, every block MoE, 4
    experts, top-2), B 2 x T 256 on the card and on the CPU: each layer's
    routes equal but at near-ties (``MOE_ROUTE_TIE``, the count printed),
    router probabilities within ``MOE_PROB_TOL``, a TF32 control that
    must read above it; 3 AdamW steps with aux 0.01, losses and aux
    within ``MOE_LOSS_TOL``, weights by phase 8's Adam rule; (b) bf16 at
    ``bench.py``'s LM width with ``examples/dist_lm.py``'s MoE settings
    (``MOE_BENCH``: every 2nd block, 8 experts, top-2, capacity 1.25,
    aux 0.01), B 2 x T 8192, chunked loss, ``adamw(1e-4)``: step seconds,
    tokens/s, MFU by the counted flops, peak memory, a profiled step, each
    MoE layer's dropped share of assignments and aux (each in (0, E + 1]), 8
    launches of B1, B2 and B3 a step; (c) phase 12's lockstep over an MoE
    tree (int8 + kv8, f32, every 2nd block MoE, 8 experts, top-2), its
    MoE leaves unquantized, logits within ``LOGIT_TOL`` of the plain
    route's, kv8 B4 and B5 launched; (d) ``python -m
    tf_operator_tpu_torch.train.dist_lm --moe-every-n 2 --moe-experts 4``
    to OK with flash launches; the phase's seconds;
23. the record input (``native/``: the C++ record pipeline and augment
    stage built with g++, their ctypes bindings; ``train/data.py``'s
    readers; ``dist_lm --data``; no hand kernel in (a) and (b), B1-B3 in
    (c)): (a) the host half on the card's host: both sources built and
    ``os.cpu_count()`` printed; the native and Python ``RecordPipeline``
    engines bitwise over two looping epochs of two shards (the native
    engine asserted by name); ``MMapRecordPipeline`` + ``augment_gather``
    bitwise ``record_dataset(engine="native", crop_hw)``; the host
    loader's images/s at ``bench.py``'s shapes (256^2 records -> 224^2
    crops, B = 256, 8 threads), mmap + ``augment_gather`` and the pread
    ring + ``augment_records``; (b) ``bench.py``'s streamed ResNet-50
    cell: phase 21 (b)'s cell and records, conv7, fed by ``fill_stacked``
    into pinned buffers of 20 steps, copied on a side stream, double-
    buffered, normalised on the card: the first batch on the card bitwise
    the CPU's Python ``augment_gather`` (uint8 and normalised), a warm
    call and 2 timed calls (images/s, MFU, beside phase 21 (b)'s resident
    conv7 images/s), the copy's time, one profiled streamed step, a finite
    loss; (c) the model's embedding backward over a step's ids three
    times, bitwise (``F.embedding``'s printed beside it: ROADMAP C2), then
    ``python -m tf_operator_tpu_torch.train.dist_lm --data``
    over 4096 sequences of the +1 chain at ``--seq 1024``, d_model 512, 2
    layers, batch 8, 30 steps: run 1 exits 138 at step 20, run 2 resumes
    to OK, a twin runs uninterrupted, the final checkpoints bitwise, flash
    launches in each run; the phase's seconds;
24. data parallelism over processes (``train/distributed.py``,
    ``parallel/``, the steps' ``mesh``; B1-B3 in every rank): (a) an NCCL
    world of 1 in this process (``init_process_group`` on a ``HashStore``
    of its own): phase 9's bf16 step (B = 2, T = 8192, chunked loss) with
    ``mesh={"dp": 1}`` against the same step without a mesh, from one
    tree and batch, 3 steps each: losses and every weight bitwise (the
    mean over one rank is the identity), in turns without, with, with,
    without; both tokens/s, the B1-B3 launches; the group destroyed; (b) ``python -m
    tf_operator_tpu_torch.train.dist_lm --dist-backend gloo`` as 2
    processes sharing the card (``TPU_NUM_PROCESSES``, ``TPU_WORKER_ID``,
    ``TPU_COORDINATOR_ADDRESS``) at phase 18 (b)'s flags beside one
    process at the same flags: the printed losses within ``DP_LOSS_TOL``,
    both to OK; then 2-process ``--data`` at phase 23 (c)'s flags cut to
    ``DP_DATA_STEPS``: killed at ``DP_DATA_FAIL_AT`` (138 on both),
    resumed, and its uninterrupted 2-process twin, the final checkpoints
    and losses bitwise; (c) 2-process
    ``dist_mnist`` under gloo at tests/test_examples.py's flags, OK on
    both, run in a thread beside (b)'s ``--data`` runs (they time nothing
    against another run); the phase's seconds;
25. tensor-parallel serving (``serve/tp.py``, the engine's ``mesh``,
    the model's Megatron layout; B4 on every rank, B5 and the kv8 B4
    under int8; each serving world's workers of 25, 27 and 28 start
    ahead of it, ``serve/tp.py`` ``prestart``: 25 (b)'s as (a) begins,
    25 (c)'s after (b)'s timed requests, 27's as 26 (b)'s ranks end,
    28's after 27 (a)'s timed requests, so each "world start" is rank
    0's part): (a) an NCCL world of 1 in this process: phase 7's bf16
    engine built with ``mesh={"tp": 1}``, so every device operation goes
    through the command path and every all-reduce and gather through
    NCCL, in turns with the plain engine (plain, tp, tp, plain): tokens
    and final logits bitwise the first run's, both decode tokens/s; (b)
    ``serve_lm``'s front at phase 15's bf16 width, first at ``--tp 1``
    alone, then at ``--tp 2 --dist-backend gloo`` (rank 0 in this
    process, its worker a process of its own on the same card), phase
    15's eight requests each: tokens equal the tp 1 front's but at a
    ``BF16_TIE`` near-tie, each rank's KV pool half tp 1's bytes,
    requests/s, TTFT and ITL p50/p99 of both; then one ``step_raise``: the
    supervisor's rebuild reaches the worker and the greedy request
    replays; (c) the bf16 int8 + kv8 tree at tp 2 (whole on each rank,
    B5 at the full projections, the kv8 B4 on each rank's 2 KV heads) in
    lockstep with the tp 1 engine, teacher-forced, logits within
    ``LOGIT_TOL``; each path's launches summed over the ranks (a worker's
    counts reach rank 0 through the ``report`` command); the phase's
    seconds;
26. tensor-, sequence-, fully sharded, expert- and pipeline-parallel
    training
    (the Megatron layout's backward,
    ``sharded_lm_xent``, dp x tp meshes, checkpoints under tp; B1-B3 on
    every rank over its heads) at phase 9's training cell: (a) an NCCL
    world of 1 in this process, the step over ``mesh={"dp": 1, "tp":
    1}`` (a model built over it: every Megatron collective an NCCL call)
    in turns with the plain step (plain, tp, tp, plain), ``TP_TRAIN_STEPS``
    steps each: losses and weights bitwise the first run's, both tokens/s;
    (b) tp 2 as two gloo processes sharing the card (``tp_train_rank``),
    from the seeded tree (a) starts from, after (a)'s last plain run:
    each step's loss within ``TP_TRAIN_LOSS_RTOL`` of it, the gathered
    weights within ``ADAM_BOUND`` x the summed learning rate of its, each
    rank's weight and AdamW bytes against tp 1's, the flash launches and
    the bytes staged through the host a step of each rank, the pair's
    tokens/s (host staging, not what tp costs over NVLink); (c)
    ``dist_lm --tp 2 --dist-backend gloo`` at phase 18 (b)'s model and
    ``TP_ENTRY_STEPS`` steps: 2 ranks killed at ``TP_ENTRY_FAIL_AT`` and
    resumed, bitwise an
    uninterrupted twin's final checkpoint; 4 ranks (dp 2 x tp 2) beside
    the resume, each printed loss within ``DP_LOSS_TOL`` of the twin's;
    the killed run's tp 2 checkpoint restored into a tp 1 state built as
    ``dist_lm`` builds it, bitwise the saved (gathered) tree, and a tp 1
    ``dist_lm`` resuming from it, (c) run beside (b) in a thread of its
    own (each is host staging and process start-up: together they take
    the longer one's time, not the sum); (d) sequence-parallel training in
    (b)'s two running ranks after their tp 2 run, over a ``{"sp": 2}``
    mesh of the same world (each rank T = 4096 of each row, the whole
    model): (i) one layer-shaped ``ring_flash_attention`` at
    ``RING_CHECK`` bf16, forward and q/k/v gradients, against
    ``flash_attention`` (B1-B3) on the whole sequence in the same
    process, by ``flash_compare``'s row-scaled rule (rank 0 runs the
    diagonal and skips the future block, rank 1 the diagonal and the past
    block), and ``ulysses_attention`` on the same blocks against the same
    reference and rule (B1-B3 over 8 heads of the whole sequence, both
    all-to-alls and their gradients); (ii) ``TP_TRAIN_STEPS`` steps with
    ``ring_impl="auto"`` (the flash ring on the card) from the seeded
    tree: each loss within
    ``TP_TRAIN_LOSS_RTOL`` of (a)'s tp 1 run, the weights within
    ``ADAM_BOUND`` x the summed lr, B1-B3 each launched exactly 8 x steps
    on rank 0 and 16 x steps on rank 1 (a causal ring of 2: one block and
    two a layer); (iii) ``SP_ULYSSES_STEPS`` Ulysses steps, each loss held
    to (a)'s at that step, each kernel launched once a layer a step on each
    rank; the bytes staged a step and the step seconds (host staging on
    one card, not what sp costs over NVLink); (e) Adafactor at tp 2 in the
    same ranks, ``ADAFACTOR_STEPS`` steps from the seeded tree, against a
    plain tp 1 Adafactor run of as many steps that (a) adds: losses within
    ``TP_TRAIN_LOSS_RTOL``, each leaf within ``adafactor_bounds``, the
    weights' distance from tp 1's within ``ADAFACTOR_MOVE_RATIO`` of tp
    1's move from the seed (a state that never moved reads 1); (f) after
    go, in a new NCCL world of 1 in this process, phase 9's step under
    FSDP over ``{"fsdp": 1}`` and ZeRO-1 over ``{"dp": 1}``
    (``weight_update_shardings``), each bitwise (a)'s last plain run, and
    phase 22 (b)'s MoE cell plain then over ``{"dp": 1, "ep": 1}``,
    bitwise; (g) in (b)'s ranks after (e), FSDP over ``{"fsdp": 2}`` and
    ZeRO-1 over ``{"dp": 2}`` (each rank one of the two rows) from the
    seeded tree, held to (a)'s tp 1 run as (b) is, each rank's weight and
    AdamW bytes against the whole (about half of each under FSDP; the
    whole weights and about half of the moments under ZeRO-1), bytes
    staged, step seconds, peak memory and launches; (h) in the same
    ranks, the MoE cell over ``{"ep": 2}`` (each rank 4 of 8 experts a
    MoE layer: 276,960,256 parameters, 134,217,728 of them experts) held
    to (f)'s plain MoE run by (b)'s bounds, with the bytes of the ep
    all-reduces a step; (i) after (f)'s runs in its NCCL world of 1,
    the cell over ``{"pp": 1}`` (``train/pp_lm.py``) by GPipe and by 1F1B
    at ``PP_MICRO`` microbatches, held to (a)'s last plain run by (b)'s
    bounds, with each kernel's exact launches (a microbatch's blocks run
    once a microbatch; 1F1B recomputes the forward); (j) in (b)'s ranks
    after (h), the cell over ``{"pp": PP}`` (4 blocks a rank) by each
    schedule from the seeded tree, held to (a)'s tp 1 run by (b)'s bounds,
    with each rank's weight and AdamW bytes, bytes staged a step, peak
    memory, stash high-water mark, step seconds and exact launches; (k)
    (run in a thread beside 18 (b)) ``dist_lm --pp PP`` at ENTRY_ARGS by
    1F1B (``PP_ENTRY_MICRO`` microbatches), killed at ``ENTRY_FAIL_AT``
    and resumed, then ``serve_lm --from-pp PP`` over its checkpoint
    answering ``PP_PROMPT`` with ``PP_ANSWER``; (l) after (f)'s runs in
    its NCCL world of 1, the training cell and the MoE cell cut to
    ``A8I_LAYERS`` blocks, each plain, then the MoE cell over ``{"ep": 1,
    "tp": 1}`` and the training cell under FSDP over ``{"fsdp": 1, "tp":
    1}`` and ZeRO-1 over ``{"dp": 1, "tp": 1}``, each bitwise its plain
    run (their weights written for (m)); (m) a world of ``A8I_WORLD``
    gloo ranks of its own (``a8i_rank``, started at go, going once (c) is
    done), the MoE cell over ``{"ep": 2, "tp": 2}``, FSDP over ``{"fsdp":
    2, "tp": 2}`` and ZeRO-1 over ``{"dp": 2, "tp": 2}`` (A8i), each
    rank's parts of the weights and its losses held to (l)'s plain run by
    (b)'s bounds, its weight and AdamW bytes exactly the layout's
    (``A8I_PARAMS``, ``A8I_MOMENTS``), the bytes staged a step, peak
    memory, step seconds and exact launches; every step second and
    tokens/s of (b) and (d) to (j) and (m) is read with (c) (and (f),
    (i), (l)) running beside them on the same card and host cores; the
    phase's seconds; each leg of (a)-(j) runs ``TP_TRAIN_STEPS`` steps;
27. tensor x data parallel serving (``serve_lm --dp``; the dp half of
    ``serve/sharding.py``, the dp allocators, global dp admission; B4 on
    every rank over its pool tile): (a) ``serve_lm``'s front at phase
    25 (b)'s bf16 width at ``--tp 2 --dp 2 --dist-backend gloo`` (rank 0
    in this process, three workers on the same card; each rank 8 of 16
    heads, 2 of 4 KV heads, 2 of 4 slots and half the pool's blocks),
    phase 15's eight requests: tokens equal 25 (b)'s tp 1 front's but at
    a ``BF16_TIE`` near-tie, each rank's pool its tile of the pool (JAX's
    block count rounded up to a dp multiple) plus the one garbage block
    of shard 1, both shards seated with every table in its shard's
    extent, requests/s, TTFT and ITL p50/p99 beside 25 (b)'s tp 1 and
    tp 2, the bytes staged through the host and the logits bytes by
    rank, B4's launches over the four ranks; (b) one ``step_raise``: the
    supervisor's rebuild reaches all three workers (each runs the new
    engine's steps) and the greedy request replays; /healthz shows the
    restart and the mesh; (c) in the same running world, before its
    drain: one of phase 15's prompts (``SHIP_LANE``) prefilled by a bf16
    ``PrefillWorker`` in this process and sent as ``shipped_kv``
    (``SHIP_STEPS`` steps), after 27 (a)'s retained entries were
    dropped: it is ingested (the ok count of
    ``tpu_serve_kv_ship_ingest_total`` moves) on the shard
    ``_pick_dp_shard`` names, inside that shard's extent, and its tokens
    equal the first as many of 27 (a)'s unshipped run of the prompt but
    at a ``BF16_TIE`` near-tie; then ``GET /prefix/<digest>`` of the prompt, whose rows must
    be bitwise the shipped rows (ingest and export move them with no
    arithmetic between); the ingest and export milliseconds, B4's
    launches over the four ranks and the bytes each command moved by
    rank; the phase's seconds;
28. speculative decoding and the host tier under tp: ``serve_lm``'s front
    at 27's width at ``--tp 2 --spec-k 4 --host-tier-bytes
    --kv-pool-blocks SPEC_POOL_BLOCKS --dist-backend gloo`` (a new world:
    rank 0 here, its worker on the same card), the draft the target's
    first ``DRAFT_LAYERS`` blocks (``truncated_draft``): (a) phase 15's
    greedy requests of lanes ``SPEC_LANES_28`` at once, ``SPEC_STEPS_28``
    steps each, equal to the first as many of 25 (b)'s tp 2 tokens but
    at a ``BF16_TIE`` near-tie (greedy spec emits the target's greedy
    tokens), the acceptance, tokens a round,
    requests/s, TTFT and ITL beside 25 (b)'s tp 2, B4's launches at t = 5
    on each rank; (b) a fresh prompt under the small pool makes a
    retained prefix give way and spill, and a repeat of that prompt
    restores from the tier (``tier_restores`` moves) with its first
    run's tokens; the spill and restore GB/s; the phase's seconds;
29. the ``kernels`` JSON line (each kernel with its design; B5 as two
    entries, the weight stream and the wgmma tile, each with its own
    launches; ``paths`` gives each kernel's launches on every path of
    this run that drives it, and ``launches`` is their sum; the paged
    kernel's entries carry their t=8 times as ``spec_t8``), the card
    line, and last the result line.

It exits non-zero without a result when torch sees no CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import re
import shutil
import signal
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
# The kernel at a speculative verify's rows: t = k + 1 = SPEC_T at k = 7,
# four lanes at different counters, lane 1's rows straddling a block
# boundary (1790 + 8 > 14 x 128), lane 3 inactive (counter 0).
SPEC_T = 8
SPEC_LANES = [3500, 1790, 875, 0]
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
# plus serve_lm's own two) and its tpu_serve_* families.
# The five families of KV shipments and the host tier (phase 19 reads
# them counted).
SHIP_TIER_FAMILIES = ("kv_ship_ingest_total", "ship_tokens_total",
                      "kv_tier_bytes", "kv_tier_restores_total",
                      "kv_tier_spills_total")
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
    "degraded", "mesh_devices", "batch_occupancy",
    "constrained_requests_total", "constrained_stops_total",
    "constrain_programs", "constrain_evictions_total",
    "spec_accept_tokens", "spec_rounds_total") + SHIP_TIER_FAMILIES)
# Phase 16, constrained decoding, over the identity vocabulary (token i =
# chr(i)). (a): one lane each under these programs, lane 3 free; every
# grammar here completes within CONSTRAIN_STEPS. (b): the server's
# --logprobs-k, the n-best candidates, and the unbounded grammars of the
# all-constrained burst (each lane decodes its whole budget).
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 4}, "ok": {"type": "boolean"}}}
CONSTRAINED_LANES = [{"regex": "[0-9]{2,6}"},
                     {"choices": ["cat", "car", "dog", "bird"]},
                     {"json_schema": SCHEMA}, None]
CONSTRAIN_STEPS = 32
FRONT_LOGPROBS_K, N_BEST = 5, 4
UNBOUNDED = [{"regex": "[0-9]+"}, {"regex": "[a-z]+"}, {"regex": "[A-Z]+"},
             {"regex": "[0-9a-f]+"}]
# Phase 17, speculative decoding at the serving width, each lane
# SPEC_STEPS tokens: (a) the target as its own draft at k = 4, f32; (b) a
# draft of the target's first DRAFT_LAYERS blocks at k = SPEC_T - 1 = 7,
# the largest the kernel's row cap takes at 4 query heads a KV head, bf16,
# SAMPLING's mix; (c) one lane of (b)'s draft at k = 4 on kv8 pools; (d)
# the f32 front at k = 4 with serve_lm's default draft depth (the same
# truncated draft); (e) k = 8 refused.
SPEC_SELF_K, SPEC_K, SPEC_KV8_K = 4, SPEC_T - 1, 4
DRAFT_LAYERS = LAYERS // 2
SPEC_STEPS = FIRST_STEPS
# bf16: where a lane parts from its solo stream, the solo run's decision
# margin there (spec_replay: the logit change that flips no decision of
# that round) lies within BF16_TIE. The engine's verify (B4, four lanes a
# GEMM) and the solo target (einsums, one lane) round bf16 activations in
# other orders: phase 12 reads such rounding parting logits by about
# 2e-2, within LOGIT_TOL. f32 lanes keep phase 14 (b)'s NEAR_TIE, on the
# top-two gap (twice the margin).
BF16_TIE = LOGIT_TOL
# Phase 18, checkpoints and eval. (a) At bench.py's training shape: train
# CKPT_STEPS steps, save, restore into a fresh model and optimiser
# (bitwise), then CKPT_MORE more steps of both the restored trainer and
# its uninterrupted twin. Their losses are expected bitwise (one process,
# the same kernels on bitwise the same state); CKPT_LOSS_TOL covers only a
# reduction whose order changes from call to call, which moves a ~10.4
# loss in its last bf16 places (< 1e-4), while a moment or step count
# restored wrong changes the update by tens of percent. The eval: three
# batches of EVAL_ROWS rows (the last short, so padding runs) through
# evaluate_lm, against the same eval with reference_attention in the
# kernels' place, and a control: the plain eval with a non-causal
# attention, a fault the checks must see. The mean loss over 40,960
# random tokens barely depends on attention: on the H100 the kernels read
# 6.1e-6 from the plain eval and the control 9.6e-4, so EVAL_LOSS_TOL
# lies between them. The final hidden states (every token, after the
# final norm) tell a fault apart better: max-abs 7.8e-2 for the kernels
# (bf16 roundings of P and O over 8 layers) and 2.18 for the control,
# against EVAL_HIDDEN_TOL. The run fails unless the control reads above
# both limits (PERF.md, phase 18's eval readings).
CKPT_STEPS, CKPT_MORE = 2, 2
CKPT_LOSS_TOL = 1e-3
EVAL_ROWS = (2, 2, 1)
EVAL_LOSS_TOL = 1e-4
EVAL_HIDDEN_TOL = 0.25
# (b) The entry point (python -m tf_operator_tpu_torch.train.dist_lm, no
# --device) at d_model 512 (4 heads of 128, the flash kernels' f32
# mma.sync design), 2 layers, vocab 256, seq 128, batch 8, lr 3e-3: the +1
# chain falls below 0.5 in 30 steps (0.0803 on the CPU). Run 1 is
# signalled after its first ack and exits 138 at ENTRY_FAIL_AT; run 2
# resumes; run 3 trains uninterrupted. The final checkpoints are expected
# bitwise (each state restores bitwise and the kernels are deterministic);
# otherwise weights within ADAM_BOUND x the learning rate summed over the
# resumed steps, phase 8's rule, with the largest difference printed.
ENTRY_ARGS = ["--d-model", "512", "--layers", "2", "--vocab", "256",
              "--seq", "128", "--batch", "8", "--steps", "30",
              "--lr", "3e-3", "--target-loss", "0.5"]
ENTRY_FAIL_AT = 20
ENTRY_HEADS = 4  # the entry point's model, as examples/dist_lm.py's
# Phase 19, disaggregated prefill, prefix pulls and the host KV tier at
# phase 6's width. (a) f32: a PrefillWorker ships the four prompts, lane
# SHIP_CHUNKED_LANE's in chunks of SHIP_CHUNK tokens; a fresh engine
# ingests them and decodes FIRST_STEPS greedy steps; lane 0's export,
# ingested by a second fresh engine, decodes PULL_STEPS. (b) f32 beside a
# TIER_BYTES host tier, in a pool that holds lanes 0 and 1 but not all
# four (``tier_pool_blocks``), so retention gives way and entries spill;
# then the kv8 case, lane TIER_KV8_LANE's prompt on phase 13's tree for
# TIER_KV8_STEPS steps. (c) bf16 over HTTP: a prefill replica and two
# decode fronts, the second with the tier.
SHIP_CHUNK = 512
SHIP_CHUNKED_LANE = 1
PULL_STEPS = LATER_STEPS
TIER_BYTES = 2 << 30
TIER_KV8_LANE = 2
TIER_KV8_STEPS = 32
# Phase 20, the dense slot engine and the legacy coalescing engine at phase
# 6's width: (a) bf16 and f32, the four prompts, DENSE_STEPS greedy steps;
# (b) f32 spec, the target as its own draft at k = 4; (c) the int8 + kv8
# tree, one lane; (d) a --kv-dense front, and a legacy front coalescing
# COALESCE_N greedy prompts of COALESCE_P tokens (COALESCE_STEPS each)
# within a COALESCE_WINDOW_MS window.
DENSE_STEPS = FIRST_STEPS
COALESCE_N, COALESCE_P, COALESCE_STEPS = 6, 437, FIRST_STEPS
COALESCE_WINDOW_MS = 250.0
# Phase 21, the image classifiers. (a) A reduced ResNet (CHECK_STAGES,
# width CHECK_WIDTH, 1000 classes) at CHECK_HW^2, B = CHECK_B, f32, from
# models/convert.py's initialiser: CHECK_STEPS SGD steps on the card and the
# same on the CPU in this process, TF32 off for cuDNN and matmuls (phase 1
# turns it off; (a) asserts it). Losses and logits within CLS_LOGIT_RTOL of
# their largest magnitude, every param and batch_stats leaf within
# CLS_LEAF_RTOL of its own: on the CPU, f32 against float64 read <= 1e-5 for
# both after 3 steps, and the card's cuDNN sums in yet another order. A
# control repeats the card's steps with TF32 on and must read above
# CLS_LOGIT_RTOL in the logits, so the check sees TF32.
CHECK_STAGES, CHECK_WIDTH, CHECK_HW, CHECK_B, CHECK_STEPS = (
    (1, 1, 1, 1), 16, 64, 8, 3)
CLS_LOGIT_RTOL, CLS_LEAF_RTOL = 1e-5, 1e-4
# (a) bf16 and (b)'s first step of each stem: one bf16 train step and one
# inference pass with every Conv, BatchNorm and the head held against its
# plain version on the same inputs (bf16_layer_check). A conv's bf16
# output against float32 F.conv2d of the same bf16 operands with flax's
# pads, and a BatchNorm's output against the float64 formula, both within
# CLS_BF16_RTOL of the layer's largest magnitude (one bf16 rounding is
# 2^-8 = 3.9e-3 of a value); the batch statistics each BatchNorm folds into
# its running mean and variance, read back as (new - 0.9 old) / 0.1,
# against float64 ones of its input within CLS_STAT_RTOL (of the largest
# variance; the mean against its square root): cuDNN reduces in f32. The
# f32 head against float64 and the step's loss against float64 cross-
# entropy of its logits within CLS_HEAD_RTOL. Two controls: the unbiased
# variance in the running statistics (torch's own rule) reads 1/(n - 1)
# of the variance, 1/31 at (a)'s last stage, and must exceed CLS_STAT_RTOL
# there; at ResNet-50's shapes n >= 12,544, so that mix-up moves the
# variance by < 8e-5 and the control is printed only. Inference-mode
# BatchNorm on the batch's own statistics must exceed CLS_BF16_RTOL at
# both shapes.
CLS_BF16_RTOL, CLS_STAT_RTOL, CLS_HEAD_RTOL = 1e-2, 1e-4, 1e-5
# (b) bench.py's resident ResNet-50 cell (bench_resnet_resident): B = 256
# crops of 224^2 from RESNET_RECORDS uint8 records of RESNET_RECORD^2 (its
# ensure_bench_records layout: image bytes + a label byte, seeded numpy),
# 1000 classes, bf16, sgd_momentum(0.1), RESNET_STEPS steps a call; one warm
# call, then RESNET_CALLS timed calls, each stem. MFU by bench.py's count:
# 3 x 4.09e9 flops an image.
RESNET_B, RESNET_HW, RESNET_RECORDS, RESNET_RECORD = 256, 224, 1024, 256
RESNET_STEPS, RESNET_CALLS, RESNET_FWD_FLOPS = 20, 2, 4.09e9
# (c) the eval over batches of these rows, against a plain inference pass
# over the same rows (the tail zero-padded to the first batch's rows, so
# cuDNN runs the same shapes): the loss within CLS_EVAL_RTOL of the plain
# float64 sum, the correct count exact; a control, the plain pass with
# BatchNorm on batch statistics, must part by more. (d) the MNIST entry
# point.
CLS_EVAL_ROWS = (256, 256, 100)
CLS_EVAL_RTOL = 1e-5
MNIST_ARGS = ["--steps", "60", "--batch", "256"]
MNIST_FAIL_AT = 30
# Phase 22, Mixture-of-Experts. (a) the reduced f32 MoE LM on the card
# (TF32 off) and on the CPU from one tree and batch. The router's
# product and softmax run in f32 on both, in other summation orders and
# after the flash kernels' attention (f32 mma.sync at Dh 64) on the card:
# probabilities ~1e-7 apart, within MOE_PROB_TOL, and a route may differ
# only where its two competing probabilities lie within MOE_ROUTE_TIE. A
# TF32 router (inputs rounded to 10 bits) moves them by ~1e-4: the
# control must read above MOE_PROB_TOL. Losses and aux within
# MOE_LOSS_TOL after each of 3 AdamW steps; weights by phase 8's rule.
MOE_F32 = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2,
               d_ff=1024, max_seq_len=256, moe_every_n=1, moe_experts=4,
               moe_top_k=2)
MOE_F32_B, MOE_F32_T, MOE_F32_STEPS, MOE_F32_LR = 2, 256, 3, 1e-3
MOE_PROB_TOL, MOE_ROUTE_TIE, MOE_LOSS_TOL = 1e-5, 1e-5, 1e-4
MOE_AUX_WEIGHT = 0.01  # examples/dist_lm.py's
# (b) bench.py's LM_SIZE with examples/dist_lm.py's MoE settings.
MOE_BENCH = dict(moe_every_n=2, moe_experts=8, moe_top_k=2,
                 moe_capacity_factor=1.25)
# (d) the entry point with the MoE flags, its other flags the defaults.
MOE_ENTRY_ARGS = ["--moe-every-n", "2", "--moe-experts", "4"]
# Phase 23, the record input (native/, train/data.py's readers). (a) The
# host half: both RecordPipeline engines batch for batch over two looping
# epochs of each of two shards of a small file (CHECK_RECORDS records of
# CHECK_RECORD_BYTES, batches of 4, so each epoch ends short), bitwise;
# MMapRecordPipeline + augment_gather against record_dataset(engine=
# "native", crop_hw) over LOADER_CHECK_BATCHES batches of phase 21's
# records, bitwise; then the host loader's images/s at bench.py's shapes
# (256^2 records -> 224^2 crops, B = 256, threads 8), perf_probe.py's two
# paths: mmap + augment_gather and the pread ring (prefetch 8, 4 reader
# threads) + augment_records, LOADER_BATCHES batches each after a warm one.
CHECK_RECORDS, CHECK_RECORD_BYTES = 23, 64
LOADER_CHECK_BATCHES, LOADER_BATCHES = 2, 20
# (b) bench.py's streamed ResNet-50 cell (bench_resnet): phase 21 (b)'s
# cell and records, the conv7 stem (bench.py's default), fed by its
# next_stacked (train/data.py fill_stacked: MMapRecordPipeline seed
# STREAM_SEED, augment_gather seed STREAM_AUGMENT_SEED, STREAM_THREADS
# threads) into pinned [RESNET_STEPS, B, 224, 224, 3] uint8 buffers, copied
# to the card on a side stream and double-buffered; uint8 -> bf16, -127.5,
# /127.5 on the card. One warm call, then RESNET_CALLS timed calls.
STREAM_SEED, STREAM_AUGMENT_SEED, STREAM_THREADS = 0, 1, 8
# (c) the entry point with --data over DATA_ROWS sequences of the +1 chain
# mod 256 (seeded starts) at --seq 1024, 16.8 MB: run 1 stops at
# DATA_FAIL_AT (exit 138), run 2 resumes to OK, a twin runs uninterrupted;
# the final checkpoints bitwise (the stream fast-forwards to the step).
DATA_ROWS = 4096
DATA_ARGS = ["--d-model", "512", "--layers", "2", "--vocab", "256",
             "--seq", "1024", "--batch", "8", "--steps", "30"]
DATA_FAIL_AT = 20
# The bitwise resume rests on a deterministic embedding backward (ROADMAP
# C2): (c) first runs the model's Embed backward over a step's ids this
# many times and wants one result.
EMBED_REPEATS = 3
# Phase 24, data parallelism. (a) DP_STEPS bf16 steps at phase 9's shape
# with and without mesh={"dp": 1} over an NCCL world of 1, in turns
# (without, with, with, without): bitwise, tokens/s by the median step of
# each side (a run's first step is its warm-up). (b)
# dist_lm as 2 gloo processes on the one card against 1 process at
# ENTRY_ARGS (f32, the same global batch of 8): each printed loss (steps 1
# and 20, the final) within DP_LOSS_TOL. The two runs sum the same f32
# terms in other orders (two ranks' means averaged, cuBLAS at 4 rows a
# rank); with --device cpu at these flags the two print the same 4
# decimals at every printed step, so 1e-3 allows the card's kernels their
# own roundings and no more. Then
# the 2-process --data runs at DATA_ARGS, killed at DATA_FAIL_AT: bitwise.
# (c) dist_mnist as 2 gloo processes at DP_MNIST_ARGS.
DP_STEPS = 3
DP_LOSS_TOL = 1e-3
# (b)'s --data runs at DATA_ARGS cut to DP_DATA_STEPS, killed at
# DP_DATA_FAIL_AT: 16 steps take the loss under dist_lm's target (0.24 on
# the CPU) and the resume is bitwise at any step; every step writes a
# checkpoint, which is most of a run's time.
DP_DATA_STEPS, DP_DATA_FAIL_AT = 16, 10
DP_MNIST_ARGS = ["--steps", "30", "--batch", "64", "--target-loss", "0.8"]
# Phase 25, tensor-parallel serving at phase 7's bf16 width (16 heads, 4 KV
# heads: 8 and 2 a rank at tp 2). (b)'s step_raise fires this many steps
# into its one replayed request.
TP = 2
TP_FAULT_AT = 8
# Phase 27, tensor x data parallel serving at phase 25 (b)'s width: dp 2
# shards of TP ranks, 2 of the 4 slots and half the pool's blocks each.
# (c) ships the prompt of lane SHIP_LANE (437 tokens: 4 blocks) and decodes
# SHIP_STEPS steps, held against the first as many of 27 (a)'s run (a
# greedy stream is a prefix of a longer one).
DP = 2
SHIP_LANE, SHIP_STEPS = 3, 16
# Phase 28, spec and the tier at tp 2: k = SPEC_K_28 (t = 5 verify rows a
# lane, 20 rows a KV head at g = 4, under the kernel's cap of 32); the
# greedy requests of lanes SPEC_LANES_28 (875 and 437 tokens: 7 and 4
# blocks with their steps and the k + 1 margin) at once in a pool of
# SPEC_POOL_BLOCKS (13 allocatable), so once both are retained (7 + 4) a
# fresh prompt of SPEC_FRESH_TOKENS (one step, 4 blocks) makes one give
# way. The requests and the
# repeat decode SPEC_STEPS_28 steps (held against the first as many of
# 25 (b)'s tokens: greedy streams are prefixes of longer ones).
SPEC_K_28 = 4
SPEC_LANES_28 = (2, 3)
SPEC_POOL_BLOCKS = 14
SPEC_STEPS_28 = 16
SPEC_FRESH_TOKENS = 437
# Phase 26, tensor-parallel training at phase 9's training cell (B=2 x
# T=8192, bf16 over f32 weights, xent_chunk 1024 with the bf16 head dot,
# adamw(1e-4)): 8 heads, d_ff 2048 and 16384 vocabulary rows a rank at tp
# 2. (a) TP_TRAIN_STEPS steps a run, bitwise. (b) tp 2 against (a)'s tp 1
# run: the row-split products add two bf16-rounded partial sums where tp 1
# rounds one sum, and the vocabulary-parallel loss takes its max and sums
# in another order, so each step's loss within TP_TRAIN_LOSS_RTOL
# (relative, of ~10.4), and after the AdamW steps every weight within
# ADAM_BOUND x the summed learning rate (phase 8's rule: Adam moves an
# element by about lr a step, whatever its gradient's rounding).
TP_TRAIN_STEPS = 2
TP_TRAIN_LR = 1e-4
TP_TRAIN_LOSS_RTOL = 2e-3
TP_TRAIN_DEVICE = "cuda"  # (b)'s ranks' device
# (c) at ENTRY_ARGS cut to TP_ENTRY_STEPS, killed at TP_ENTRY_FAIL_AT: the
# loss is under its target by step 20 (0.2269) and the resume bitwise at
# any step.
TP_ENTRY_STEPS, TP_ENTRY_FAIL_AT = 20, 12
# (d) sequence parallelism over SP ranks in (b)'s world: (i) the ring's
# check at one layer's attention, [B, T, H, Dh] = RING_CHECK, bf16;
# (ii) TP_TRAIN_STEPS flash-ring steps, (iii) SP_ULYSSES_STEPS Ulysses
# steps, each held as (b) is. (e) ADAFACTOR_STEPS Adafactor steps at tp 2
# against (a)'s tp 1 run of as many (adafactor_bounds).
# Two Adafactor runs of 2 steps sit within the triangle bound whatever
# they do, and their losses part by less than the loss moves in 2 steps,
# so (e) also holds the distance of tp 2's weights from tp 1's, over all
# leaves, to ADAFACTOR_MOVE_RATIO of the distance tp 1 moved from the
# seed: a tp 2 state that never moved reads 1, one that moved as tp 1
# did, up to the rounding of its bf16 products, near 0.
SP = 2
RING_CHECK = (TRAIN_B, TRAIN_T, 16, 64)
SP_ULYSSES_STEPS = 2
ADAFACTOR_STEPS = 2
ADAFACTOR_MOVE_RATIO = 0.5
# (f) FSDP at {"fsdp": 1}, ZeRO-1 at {"dp": 1} (weight_update_shardings)
# and the MoE cell (phase 22 (b)'s) at {"ep": 1}, each in (a)'s NCCL world
# of 1 in turns with the plain step: TP_TRAIN_STEPS steps, bitwise. (g)
# FSDP over {"fsdp": FSDP} and ZeRO-1 over {"dp": FSDP} in (b)'s ranks
# (each rank B / 2 rows), held to (a)'s tp 1 run as (b) is. (h) the MoE
# cell over {"ep": EP} in (b)'s ranks (4 of 8 experts a MoE layer a rank,
# both ranks on the whole batch) against (f)'s plain MoE run by (b)'s
# bounds: a route may part only at a near-tie of two router
# probabilities, and Adam moves a weight by about lr a step whatever its
# gradient, so ADAM_BOUND holds either way.
FSDP = EP = 2
# (l) and (m): expert parallelism, FSDP and ZeRO-1 beside tp (A8i) at the
# training cell's width cut to A8I_LAYERS blocks (the MoE cell: one dense
# block, then one MoE block of MOE_BENCH's 8 experts). (l) in (f)'s NCCL
# world of 1, each cell plain and then over a mesh of ones, bitwise; (m) in
# a world of A8I_WORLD gloo ranks of its own sharing the card, each leg
# TP_TRAIN_STEPS steps from the seeded tree held to (l)'s plain run of its
# cell by (b)'s bounds. A8I_LEGS: leg -> (cell, (m)'s mesh, (l)'s mesh).
A8I_LAYERS, A8I_WORLD = 2, 4
A8I_LEGS = {
    "moe": ("moe", {"ep": 2, "tp": 2}, {"ep": 1, "tp": 1}),
    "fsdp": ("lm", {"fsdp": 2, "tp": 2}, {"fsdp": 1, "tp": 1}),
    "zero": ("lm", {"dp": 2, "tp": 2}, {"dp": 1, "tp": 1}),
}
# What a rank of (m) holds, from the layout (``param_shapes``, the Megatron
# and expert rules, ``fsdp_spec`` of the whole leaves): the MoE cell's
# weights at ep 2 x tp 2; the training cell's under FSDP 2 x tp 2 (its tp
# parts cut again); under ZeRO-1 dp 2 x tp 2 its tp parts whole and half
# of their moments. AdamW keeps two f32 moments an element.
A8I_PARAMS = {"moe": 83_945_472, "fsdp": 27_295_744, "zero": 54_582_272}
A8I_MOMENTS = {"moe": 83_945_472, "fsdp": 27_295_744, "zero": 27_295_744}
# (i) pipeline parallelism (train/pp_lm.py) on phase 9's cell: in (a)'s
# NCCL world of 1, the cell over {"pp": 1} at PP_MICRO microbatches by
# GPipe and by 1F1B, after (a)'s last plain run, TP_TRAIN_STEPS steps each
# from the seeded tree; (j) in (b)'s ranks over {"pp": PP} (4 of the 8
# blocks a rank), the same. Both are held to (a)'s tp 1 run by (b)'s
# bounds: the pipelined head runs in f32 where tp 1's product is bf16
# (JAX's pp step takes no head dtype), which moves the loss by ~1e-6 of
# it on random weights, and a microbatch's products and the gradients'
# sums over microbatches round in another order. (k) dist_lm --pp PP at
# ENTRY_ARGS by 1F1B at PP_ENTRY_MICRO microbatches, killed at
# ENTRY_FAIL_AT and resumed, beside 18 (b); then serve_lm --from-pp PP
# over its checkpoint answers PP_PROMPT with PP_ANSWER
# (tests/test_examples.py's check; 20 steps at these flags are too few
# for a 4-token prompt, 30 are enough on the CPU).
PP, PP_MICRO, PP_ENTRY_MICRO = 2, 2, 4
PP_SCHEDULES = ("gpipe", "1f1b")
PP_PROMPT, PP_ANSWER = [5, 6, 7, 8], [9, 10, 11, 12]


def entry_flash_shape() -> tuple[int, int, int, int]:
    """``[B, T, H, Dh]`` of the q/k/v the entry point hands the flash
    kernels under ENTRY_ARGS."""
    def arg(flag):
        return int(ENTRY_ARGS[ENTRY_ARGS.index(flag) + 1])

    return (arg("--batch"), arg("--seq"), ENTRY_HEADS,
            arg("--d-model") // ENTRY_HEADS)


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
    version, then timed at t = 1 and, as a speculative verify runs it, at
    t = SPEC_T."""
    label = "paged_attend_kv8" if kv8 else "paged_attend"
    print(f"{label} design: " + OTHER_DESIGNS[label].format(S=pa.SPLITS),
          flush=True)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, lanes, t in (("t=1", LANES, 1), ("t=3", LANES, 3),
                               ("inactive lane", [3500, 0, 875, 437], 1),
                               ("spec t=5", SPEC_LANES, 5),
                               ("spec t=8", SPEC_LANES, SPEC_T)):
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

    times = {t: kernel_times(pa, t, kv8, label) for t in (1, SPEC_T)}
    return dict(max_abs_err=err, **times[1], spec_t8=times[SPEC_T])


def kernel_times(pa, t, kv8, label) -> dict:
    """Time at the main path's shapes: bf16 q, t rows a lane (1: a decode
    step; SPEC_T: phase 17 (b)'s verify), one pool pair per layer (135 MB
    in all for bf16, beyond the 50 MB L2), walked in layer order. Device
    times come from CUDA-graph replay (device_ms); the kernel's eager time
    per call, host wrapper included, is printed beside them."""
    q, pools, table, index = attend_case(LANES, t, torch.bfloat16, 9, kv8,
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
    bms, bound_by = bound_ms(LANES, t, torch.bfloat16, kv8)
    print(f"{label} bf16 t={t}, S={pa.SPLITS}: kernel_ms {kernel_ms:.6f} "
          f"(eager, host included: {eager_ms:.6f}) plain_ms {plain_ms:.6f} "
          f"library_ms {library_ms:.6f} (SDPA over pre-gathered bf16 K/V) "
          f"bound_us "
          f"{bms * 1e3:.4f} ({bound_by})", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bound_by, library_ms=library_ms)


def sdpa_ms(q, pools, table, index) -> float:
    """Device ms of scaled_dot_product_attention, the yardstick the port
    never calls, over K/V pre-gathered from each layer's (key, value)
    pools to the dense [b, H, S, Dh] layout, expanded to every query head,
    the lanes' lengths as its mask (query row i of a lane at index n sees
    keys <= n + i)."""
    g = H // KV
    t = q.shape[1]
    rows = index.long()[:, None] + torch.arange(t, device="cuda")[None, :]
    valid = (torch.arange(S, device="cuda")[None, None, :]
             <= rows[:, :, None])[:, None]  # [b, 1, t, S]
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


def flash_inputs(b, tq, tk, dtype, seed, fused=False, h=H, dh=DH):
    """Seeded q, k, v and dO of ``[b, T, h, dh]`` (by default the slice's
    heads); with ``fused`` (tq == tk), q, k and v are the strided slices
    of one ``[b, T, 3, h, dh]`` tensor, as the training forward's qkv
    projection hands them over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if fused:
        return (*randn(b, tq, 3, h, dh).unbind(2), randn(b, tq, h, dh))
    return randn(b, tq, h, dh), randn(b, tk, h, dh), randn(b, tk, h, dh), \
        randn(b, tq, h, dh)


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


def flash_check_case(fa, label, inputs, causal, worst) -> None:
    """One flash case: each kernel against its plain version on
    ``inputs`` (q, k, v, dO); the backward kernels are fed the plain
    forward's statistics."""
    q, k, v, do = inputs
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    stats = (q, k, v, do, lse_ref, delta, causal, scale)
    dq = fa.flash_dq(*stats)
    dk, dv = fa.flash_dkv(*stats)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_dkv_reference(*stats)
    flash_compare(label, dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv),
                  dict(o=o_ref, lse=lse_ref, dq=fa.flash_dq_reference(*stats),
                       dk=dk_ref, dv=dv_ref), worst)


def flash_check_phase(fa) -> dict:
    """Each flash kernel against its plain version on the same inputs:
    FLASH_CASES at the slice's heads in f32 and bf16, then the instance
    phase 18 (b)'s entry point runs (``entry_flash_shape``: f32, Dh 128,
    causal, fused q/k/v). Returns each kernel's largest max-abs error
    over its outputs and the cases."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for dh in fa.HEAD_DIMS:
            print(f"flash designs, {dtype}, Dh={dh}: "
                  f"{flash_designs(fa, dtype, dh)}", flush=True)
        for seed, (name, tq, tk, causal, fused) in enumerate(FLASH_CASES):
            flash_check_case(fa, f"{dtype}, {name}",
                             flash_inputs(2, tq, tk, dtype, seed, fused),
                             causal, worst)
    b, t, h, dh = entry_flash_shape()
    flash_check_case(fa, f"torch.float32, entry point (18b) fused causal "
                     f"[{b}, {t}, {h}, {dh}]",
                     flash_inputs(b, t, t, torch.float32, len(FLASH_CASES),
                                  True, h, dh), True, worst)
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


def engine_run(pa, cfg, params, attend, prompts, profile: int = 0,
               mesh=None) -> dict:
    """The schedule of phases 6 and 7 through ContinuousEngine, with every
    serving kernel's count set to 0 just before the first join; with
    ``profile``, the last that many steps run under the profiler; with
    ``mesh``, the engine of a tensor-parallel world (phase 25 (a))."""
    from tf_operator_tpu_torch.ops import int8_dense as i8
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                              kv_attend=attend, mesh=mesh)
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
               logits=engine._logits.clone(),
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


def replay_values(model, prompt, feed, temperature, top_p, seed, steps,
                  program=None):
    """What a solo run at (temperature, top_p, seed) samples from at each
    of ``steps`` steps when fed the tokens ``feed`` ``[B, steps]``
    (teacher forcing): ``[steps, B, V]`` f32, gumbel(key i) + the scaled,
    nucleus-filtered logits (the logits, greedy), by generate's own
    operations, so their argmax is the token generate takes; and the
    scaled logits before the filter. With a constraint ``program`` the
    logits first take the mask of each step's state along ``feed``, as
    ``constrained_generate`` adds it."""
    from tf_operator_tpu_torch.models.transformer import (
        _nucleus_filter,
        _prefill,
    )
    from tf_operator_tpu_torch.random import PRNGKey, gumbel, split
    from tf_operator_tpu_torch.serve.constrain import NEG_MASK, oracle_tables

    keys = split(PRNGKey(seed, prompt.device), steps)
    temp = torch.tensor(temperature, dtype=torch.float32,
                        device=prompt.device)
    out, pre = [], []
    if program is not None:
        allow, nxt = oracle_tables(program, prompt.device)
        state = torch.zeros(feed.shape[0], dtype=torch.int64,
                            device=prompt.device)
    with torch.no_grad():
        cache, logits = _prefill(model, prompt)
        for i in range(steps):
            if program is not None:
                logits = logits + torch.where(allow[state], 0.0, NEG_MASK)
                state = nxt[state, feed[:, i].long()].long()
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


def solo_parting(model, base, prompt, got, t, tp, seed, program=None):
    """Where a lane's tokens ``got`` (numpy) part from the solo
    ``generate`` (``constrained_generate`` under a ``program``) of its
    prompt and sampling parameters on the card: None when they are
    identical, else (the first parting step, the solo run's top-two gap
    there), which phases 14 (b), 15 (a) and 16 (a) hold to
    ``NEAR_TIE``."""
    from tf_operator_tpu_torch.models.transformer import generate
    from tf_operator_tpu_torch.random import PRNGKey
    from tf_operator_tpu_torch.serve.constrain import constrained_generate

    steps = len(got)
    prompt = torch.as_tensor(prompt, device=model.device)
    kw = dict(temperature=t, top_p=tp, rng=PRNGKey(seed, model.device)) \
        if t > 0 else {}
    if program is None:
        solo = generate(base, model, prompt, steps, **kw)
    else:
        solo = constrained_generate(base, model, prompt, steps,
                                    program=program, **kw)
    want = solo[0].cpu().numpy()
    if np.array_equal(want, got):
        return None
    step = int(np.flatnonzero(want != got)[0])
    values, _ = replay_values(model, prompt, solo, t, tp, seed, steps,
                              program)
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


def open_front(cfg, params, draft_params=None, spawned=None, **flags):
    """The port's server at phase 6's serving width (4 slots, blk 128,
    the kernel read) on an ephemeral port, serving: (supervisor, server,
    base URL). ``draft_params`` is the draft's tree under ``spec_k``;
    ``spawned`` a tp world's workers started ahead (``serve/tp.py``
    ``prestart``)."""
    from tf_operator_tpu_torch.serve import serve_lm

    args = serve_lm.front_args(
        device="cuda", max_batch=len(LANES), kv_block=BLK,
        kv_attend="kernel", max_seq_len=cfg.max_seq_len, port=0, **flags)
    supervisor, server = serve_lm.build_front(cfg, params, args,
                                              draft_params, spawned)
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



def grammar_check(program, toks, spec) -> str:
    """Every token up to the grammar's completion is legal at its state
    (the program's own walk), the lane completes within its tokens, and
    the completed text parses: ``json.loads`` for a schema, membership for
    choices, ``re.fullmatch`` for a regex. Returns the text."""
    state, done = 0, None
    for i, tok in enumerate(toks):
        if not program.allow[state, tok]:
            raise AssertionError(f"{spec}: token {tok} at step {i} is "
                                 f"illegal at state {state}")
        state = program.walk(state, tok)
        if program.complete[state]:
            done = i
            break
    if done is None:
        raise AssertionError(f"{spec}: no completion in {len(toks)} tokens")
    text = "".join(chr(t) for t in toks[:done + 1])
    if "json_schema" in spec:
        obj = json.loads(text)
        ok = isinstance(obj.get("ok"), bool) and len(obj["name"]) <= 4
    elif "choices" in spec:
        ok = text in spec["choices"]
    else:
        ok = re.fullmatch(spec["regex"], text) is not None
    if not ok:
        raise AssertionError(f"{spec}: {text!r} does not parse")
    return text


def constrained_engine_phase(pa, i8, base, params, prompts):
    """Phase 16 (a): the f32 engine at phase 6's width through the kernel,
    one lane each under ``CONSTRAINED_LANES``' regex, choices and
    json_schema programs and one free lane, greedy and then with
    ``SAMPLING``'s mix (B4's counts set to 0 just before each run's joins):
    each lane equal to its solo ``constrained_generate`` (``generate``, the
    free lane) on the card or parting at a near-tie (phase 14 (b)'s rule),
    every token legal and every grammar complete and parsed, B4 at
    n_layers launches a forward. Returns (the compiler, B4's launches)."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.serve.constrain import (
        ConstraintCompiler,
        default_vocab,
    )
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    comp = ConstraintCompiler(default_vocab(base.vocab_size))
    programs, compile_s = [], {}
    for spec in CONSTRAINED_LANES:
        t0 = time.perf_counter()
        programs.append(None if spec is None else comp.compile(spec))
        if spec is not None:
            compile_s[next(iter(spec))] = round(time.perf_counter() - t0, 4)
    print(f"constrained engine: cold compile seconds at vocab "
          f"{base.vocab_size} {compile_s}, states "
          f"{[p.n_states for p in programs if p is not None]}", flush=True)
    launches = 0
    for label, mix in (("greedy", [(0.0, None, 0)] * len(prompts)),
                       ("sampled", SAMPLING)):
        engine = ContinuousEngine(base, params, len(prompts), kv_block=BLK,
                                  kv_attend="kernel")
        reset_counts(pa, i8)
        slots = [engine.join(p, num_steps=CONSTRAIN_STEPS, temperature=t,
                             top_p=tp, seed=seed, program=prog)
                 for p, (t, tp, seed), prog in zip(prompts, mix, programs)]
        if slots != list(range(len(prompts))):
            raise AssertionError(f"constrained joins got slots {slots}")
        tokens = np.stack([engine.step() for _ in range(CONSTRAIN_STEPS)])
        torch.cuda.synchronize()
        forwards, runs = engine.steps_total, pa.launches
        debug = engine.constrain_debug()
        del engine
        torch.cuda.empty_cache()
        if runs != LAYERS * forwards:
            raise AssertionError(f"constrained engine {label}: B4 launches "
                                 f"{runs} over {forwards} forwards")
        launches += runs
        model = _decode_model(base, params, None)
        parted, texts = [], []
        for lane, (prompt, (t, tp, seed), prog, spec) in enumerate(
                zip(prompts, mix, programs, CONSTRAINED_LANES)):
            got = tokens[:, lane]
            part = solo_parting(model, base, prompt, got, t, tp, seed, prog)
            if part is not None:
                parted.append((lane, *part))
            if prog is not None:
                texts.append(grammar_check(prog, got.tolist(), spec))
        del model
        torch.cuda.empty_cache()
        print(f"constrained engine f32 {label} (lanes regex, choices, "
              f"json_schema, free): texts {texts}; lanes parting from their "
              f"solo run (lane, first step, top-two gap): {parted} (limit "
              f"{NEAR_TIE}, at most one lane); B4 launches {runs} over "
              f"{forwards} forwards; pool {debug}", flush=True)
        if len(parted) > 1 or any(gap > NEAR_TIE for _, _, gap in parted):
            raise AssertionError(f"constrained lanes part from their solo "
                                 f"run away from a near-tie: {parted}")
    return comp, launches


def masked_step_profile(pa, i8, cfg, params, prompts, card) -> int:
    """What the mask adds to a decode step: a bf16 engine with four lanes
    under ``UNBOUNDED`` programs, 8 steps under torch.profiler with the
    mask and the FSM advance, then 8 with both patched out, in turns
    (mask, none, mask, none). Returns B4's launches."""
    from tf_operator_tpu_torch.serve.constrain import (
        ConstraintCompiler,
        default_vocab,
    )
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    comp = ConstraintCompiler(default_vocab(cfg.vocab_size))
    engine = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                              kv_attend="kernel")
    reset_counts(pa, i8)
    for p, spec in zip(prompts, UNBOUNDED):
        engine.join(p, num_steps=4 * PROFILE_STEPS + 4,
                    program=comp.compile(spec))
    for _ in range(2):
        engine.step()
    turns = []
    for label in ("mask", "no mask", "mask", "no mask"):
        with contextlib.ExitStack() as stack:
            if label == "no mask":
                stack.enter_context(mock.patch.object(
                    engine, "_mask", lambda logits: logits))
                stack.enter_context(mock.patch.object(
                    engine, "_advance", lambda toks: None))
            turns.append((label, profile_steps(
                engine.step, PROFILE_STEPS, f"bf16 decode steps, {label}")))
    torch.cuda.synchronize()
    launches, forwards = pa.launches, engine.steps_total
    del engine
    torch.cuda.empty_cache()
    if launches != LAYERS * forwards:
        raise AssertionError(f"mask profile: B4 launches {launches} over "
                             f"{forwards} forwards")

    def mean(label, key):
        vals = [t[key] for name, t in turns if name == label and key in t]
        return sum(vals) / len(vals) if vals else None

    adds = {key: (None if mean("mask", key) is None
                  else round(mean("mask", key) - mean("no mask", key), 3))
            for key in ("events", "busy_us")}
    print(f"constrained step, bf16, 4 constrained lanes: the mask and FSM "
          f"advance add {adds['events']} device operations and "
          f"{adds['busy_us']} us of device time a step (means over two "
          f"turns of {PROFILE_STEPS} profiled steps each; None: not "
          f"measured) on {card}", flush=True)
    return launches


def constrained_front_phase(pa, i8, base, params, prompts, card, comp):
    """Phase 16 (b): the bf16 front with ``--logprobs-k 5``: one request
    each with json_schema, regex, choices (``grammar_complete``, legal,
    parsed), logprobs (``length``, rows with top values descending and
    the greedy token's logprob the top one) and ``n`` = 4 at T 0.8 (four
    candidates at seed + j); then a stop request on two of the logprobs
    request's tokens (``stop_sequence``, trimmed by apply_stop's rule).
    Each spec's compile seconds from the server's ``constrain.compile``
    spans; decode tokens/s of an all-free and an all-constrained burst
    in turns (free, constrained, constrained, free); then what the mask
    adds to a step (``masked_step_profile``). Returns B4's launches by
    run."""
    from tf_operator_tpu_torch.serve.constrain import apply_stop

    cfg = replace(base, dtype=torch.bfloat16)
    supervisor, server, url = open_front(cfg, params,
                                         logprobs_k=FRONT_LOGPROBS_K)
    reset_counts(pa, i8)
    specs = [s for s in CONSTRAINED_LANES if s is not None]
    bodies = [dict(tokens=p.tolist(), num_steps=CONSTRAIN_STEPS, **spec)
              for p, spec in zip(prompts, specs)]
    tail = prompts[-1].tolist()
    bodies += [dict(tokens=tail, num_steps=CONSTRAIN_STEPS, logprobs=True),
               dict(tokens=tail, num_steps=CONSTRAIN_STEPS, n=N_BEST,
                    temperature=0.8, seed=5)]
    responses, wall = send_all(url, bodies)
    for spec, resp in zip(specs, responses):
        if resp["finish_reason"] != ["grammar_complete"]:
            raise AssertionError(f"{spec}: finish {resp['finish_reason']}")
        grammar_check(comp.compile(spec), resp["tokens"][0], spec)
    lp = responses[len(specs)]
    rows = lp["logprobs"][0]
    free = lp["tokens"][0]
    if (lp["finish_reason"] != ["length"] or len(rows) != len(free)
            or len(free) != CONSTRAIN_STEPS):
        raise AssertionError(f"logprobs response {lp['finish_reason']} "
                             f"{len(rows)} rows, {len(free)} tokens")
    for row in rows:
        vals = row["top_logprobs"]
        if (len(vals) != FRONT_LOGPROBS_K
                or any(a < b for a, b in zip(vals, vals[1:]))
                or row["logprob"] != vals[0]
                or row["top_ids"][0] != row["token"]):
            raise AssertionError(f"logprob row inconsistent: {row}")
    nb = responses[len(specs) + 1]
    choices = nb.get("choices", [])
    if ([c["seed"] for c in choices] != [5 + j for j in range(N_BEST)]
            or [c["tokens"] for c in choices] != nb["tokens"]
            or any(len(c["tokens"]) != CONSTRAIN_STEPS for c in choices)):
        raise AssertionError(f"n-best payload {nb}")
    stop = [free[3:5]]
    status, st = http(url, "/generate", dict(
        tokens=tail, num_steps=CONSTRAIN_STEPS, stop=stop, logprobs=True))
    want = apply_stop(free, [tuple(stop[0])])
    if (status != 200 or st["finish_reason"] != ["stop_sequence"]
            or st["tokens"] != [want]
            or len(st["logprobs"][0]) != len(want)):
        raise AssertionError(f"stop request {status} {st}, want {want}")
    _, traces = http(url, "/debug/traces")
    compile_s = {}
    for e in traces["traceEvents"]:
        if e["name"] == "constrain.compile":
            kind = e["args"].get("kind")
            compile_s[kind] = max(compile_s.get(kind, 0.0),
                                  e["dur"] / 1e6)
    _, metrics = http(url, "/metrics")
    _, debug = http(url, "/debug/serve")
    if ('tpu_serve_constrained_stops_total{reason="stop_sequence"}'
            not in metrics or "compiler" not in debug.get("constrain", {})):
        raise AssertionError("constrain metrics or /debug/serve section "
                             "missing")
    print(f"constrained front bf16: {len(bodies)} requests in {wall:.4f} s "
          f"and a stop request ({len(free)} -> {len(want)} tokens); the "
          f"server's compile seconds at vocab {cfg.vocab_size} (longest "
          f"span by kind) {compile_s}; /debug/serve constrain "
          f"{debug['constrain']}", flush=True)
    free_bodies = [dict(tokens=p.tolist(), num_steps=FIRST_STEPS,
                        timing=True) for p in prompts]
    con_bodies = [dict(b, **spec) for b, spec in zip(free_bodies, UNBOUNDED)]
    rates = []
    for label, group in (("free", free_bodies), ("constrained", con_bodies),
                         ("constrained", con_bodies), ("free", free_bodies)):
        out, took = send_all(url, group)
        rates.append((label, latency_line(f"bf16 {label} burst", out,
                                          took)["tok_s"]))
        if label == "constrained":
            for spec, resp in zip(UNBOUNDED, out):
                text = "".join(chr(t) for t in resp["tokens"][0])
                if re.fullmatch(spec["regex"], text) is None:
                    raise AssertionError(f"{spec}: {text!r}")
    launches, forwards = pa.launches, supervisor.engine.steps_total
    server.drain()
    del supervisor, server
    torch.cuda.empty_cache()
    if launches != LAYERS * forwards:
        raise AssertionError(f"constrained front B4 launches {launches} over "
                             f"{forwards} forwards")
    print(f"constrained front bf16: decode tokens/s in turns (free, "
          f"constrained, constrained, free) "
          f"{[round(r, 2) for _, r in rates]} on {card}", flush=True)
    profile = masked_step_profile(pa, i8, cfg, params, prompts, card)
    return {"constrained front bf16 (16b)": launches,
            "mask profile bf16 (16b)": profile}


def constrained_int8_phase(pa, i8, base, params, prompts, comp) -> dict:
    """Phase 16 (c): one constrained greedy lane (the json_schema program)
    on the bf16 int8_decode + kv_int8 engine over phase 13's tree: every
    token legal and the grammar complete and parsed; the kv8 B4 at
    n_layers launches a forward, B5's stream at 41 a forward and its
    wgmma tile on the prefill. Returns the launches by kernel."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    cfg = replace(base, dtype=torch.bfloat16, int8_decode=True,
                  kv_int8=True)
    engine = ContinuousEngine(cfg, quantize_decode_params(
        bf16_rounded(params)), len(prompts), kv_block=BLK,
        kv_attend="kernel")
    spec = {"json_schema": SCHEMA}
    prog = comp.compile(spec)
    reset_counts(pa, i8)
    slot = engine.join(prompts[2], num_steps=CONSTRAIN_STEPS, program=prog)
    toks = [int(engine.step()[slot]) for _ in range(CONSTRAIN_STEPS)]
    torch.cuda.synchronize()
    forwards = engine.steps_total
    got = dict(paged_attend=pa.launches, paged_attend_kv8=pa.kv8_launches,
               int8_matmul=i8.launches - i8.wgmma_launches,
               int8_matmul_prefill=i8.wgmma_launches)
    del engine
    torch.cuda.empty_cache()
    text = grammar_check(prog, toks, spec)
    calls = 5 * cfg.n_layers + 1
    print(f"constrained int8 + kv8 bf16: {text!r}, {forwards} forwards, "
          f"launches {got}", flush=True)
    if (got["paged_attend"]
            or got["paged_attend_kv8"] != cfg.n_layers * forwards
            or got["int8_matmul"] < calls * forwards
            or got["int8_matmul_prefill"] < calls - 1):
        raise AssertionError(f"constrained int8 + kv8: launches {got}")
    return got


def truncated_draft(params: dict, layers: int) -> dict:
    """Phase 17's draft: the target's embeddings, position table, first
    ``layers`` blocks, final norm and head (a flax-layout tree), so it is
    cheap and agrees with the target at some positions."""
    return {name: leaf for name, leaf in params.items()
            if not name.startswith("block_")
            or int(name.split("_")[1]) < layers}


def spec_replay(tmodel, dmodel, prompt, steps, k, t, tp, seed):
    """Solo ``speculative_generate`` at b = 1 by its own operations (the
    per-round key split, the draft's draws, the accept test, the residual
    and bonus draws), with the margin of the decisions behind each emitted
    token: the largest change of every logit, in both models, that cannot
    flip any decision of the round that emitted it (greedy: half the
    verify rows' top-two gaps; a draw: half the gap of gumbel + scaled
    values, times T; an accept test: a quarter of its log-ratio margin,
    times T, since the ratio moves with both models' log-softmaxes).
    Returns (tokens, margins), each ``steps`` long."""
    from tf_operator_tpu_torch.models.spec_decode import (
        _log_softmax,
        residual_distribution,
    )
    from tf_operator_tpu_torch.models.transformer import (
        _nucleus_filter,
        _prefill,
        set_cache_index,
    )
    from tf_operator_tpu_torch.random import PRNGKey, gumbel, split, uniform

    dev = tmodel.device
    temp = torch.tensor(float(t or 1.0), device=dev)

    def scale(x):
        s = x / temp
        return s if tp is None else _nucleus_filter(s, tp)

    def gap(vals, rows=slice(None)):
        top = vals.topk(2, dim=-1).values[..., rows, :]
        return float((top[..., 0] - top[..., 1]).min())

    def draw(key, logits):
        if not t:
            return logits.argmax(-1), math.inf
        vals = gumbel(key, logits.shape) + scale(logits)
        return vals.argmax(-1), gap(vals[:, None]) * t / 2

    with torch.no_grad():
        prompt = torch.as_tensor(prompt, device=dev)
        tcache, tlogits = _prefill(tmodel, prompt)
        dcache, _ = _prefill(dmodel, prompt)
        rng, k0 = split(PRNGKey(seed, dev)) if t else (None, None)
        pend, margin = draw(k0, tlogits)
        toks = [int(pend)]
        margins = [margin if t else gap(tlogits[:, None]) / 2]
        while len(toks) < steps:
            t_idx, d_idx = tcache["cache_index"], dcache["cache_index"]
            keys = [None] * (k + 1)
            if t:
                rng, k_draft, k_acc, k_res, k_bonus = split(rng, 5)
                keys = split(k_draft, k + 1)
            tok, drafted, qlogits, worst = pend, [], [], math.inf
            for j in range(k + 1):
                logits = dmodel(tok[:, None], dcache)[:, 0]
                tok, margin = draw(keys[j], logits)
                worst = min(worst, margin)
                drafted.append(tok)
                qlogits.append(logits)
            props = torch.stack(drafted, 1)[:, :k]
            tlogits = tmodel(torch.cat([pend[:, None], props], 1), tcache)
            if t:
                logp = _log_softmax(scale(tlogits[:, :k]))
                logq = _log_softmax(scale(torch.stack(qlogits, 1)[:, :k]))
                sel = props[..., None]
                ratio = (logp.gather(-1, sel)
                         - logq.gather(-1, sel))[..., 0].clamp(max=0.0)
                log_u = torch.log(uniform(k_acc, (1, k), 1e-38, 1.0))
                accept = log_u < ratio
                worst = min(worst, float((log_u - ratio).abs().min()) * t / 4)
            else:
                accept = props == tlogits.argmax(-1)[:, :k]
            m = int(torch.cumprod(accept.long(), 1).sum())
            if not t:
                worst = gap(tlogits, slice(0, m + 1)) / 2
                nxt = tlogits.argmax(-1)[:, m]
            elif m == k:
                nxt, margin = draw(k_bonus, tlogits[:, k])
                worst = min(worst, margin)
            else:
                res = torch.log(residual_distribution(
                    torch.exp(logp), torch.exp(logq)) + 1e-38)
                vals = gumbel(k_res, res.shape) + res
                worst = min(worst, gap(vals[:, m:m + 1]) * t / 2)
                nxt = vals[:, m].argmax(-1)
            toks += [int(x) for x in props[0, :m]] + [int(nxt)]
            margins += [worst] * (m + 1)
            set_cache_index(tcache, t_idx + 1 + m)
            set_cache_index(dcache, d_idx + 1 + m)
            pend = nxt
    return toks[:steps], margins[:steps]


def spec_parting(tmodel, dmodel, prompt, got, k, t, tp, seed):
    """Where a lane's engine tokens ``got`` part from the solo
    ``speculative_generate`` of its prompt and sampling parameters on the
    card: None when identical, else (the first parting step, the solo
    run's decision margin there by ``spec_replay``, whose tokens must be
    the solo run's)."""
    from tf_operator_tpu_torch.models.spec_decode import speculative_generate
    from tf_operator_tpu_torch.random import PRNGKey

    steps = len(got)
    kw = (dict(temperature=t, top_p=tp, rng=PRNGKey(seed, tmodel.device))
          if t > 0 else {})
    solo, _ = speculative_generate(
        tmodel.cfg, tmodel, dmodel.cfg, dmodel,
        torch.as_tensor(prompt, device=tmodel.device), steps, k=k, **kw)
    want = solo[0].tolist()
    if want == list(got):
        return None
    step = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    toks, margins = spec_replay(tmodel, dmodel, prompt, steps, k, t, tp,
                                seed)
    if toks != want:
        raise AssertionError("spec_replay's tokens differ from the solo "
                             "speculative_generate run")
    return step, margins[step]


def spec_engine_run(pa, cfg, params, dcfg, dparams, k, prompts, mix,
                    attend="kernel", profile=0, **engine_kw) -> dict:
    """Speculative rounds through ContinuousEngine: the engine warmed, the
    prompts joined with ``mix``'s parameters and SPEC_STEPS each (B4's
    counts set to 0 just before), ``profile`` rounds under torch.profiler,
    then timed rounds until every lane is done; each round's windows
    delivered trimmed to the budget, a lane retired the round it
    completes. B4 (or kv8 B4) must have launched n_layers times a round
    under the kernel read, never under the gather read. Returns the
    lanes' tokens, the round count, the launches, the engine's
    spec_debug, tokens/s of the timed rounds and the profile.
    ``engine_kw`` goes to the engine (``kv_paged=False``: phase 20 (b))."""
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(cfg, params, len(prompts), kv_block=BLK,
                              kv_attend=attend, spec_k=k, draft_cfg=dcfg,
                              draft_params=dparams, **engine_kw)
    engine.warmup()
    pa.launches = pa.kv8_launches = 0
    slots = [engine.join(p, num_steps=SPEC_STEPS, temperature=t, top_p=tp,
                         seed=seed) for p, (t, tp, seed) in zip(prompts, mix)]
    if slots != list(range(len(prompts))):
        raise AssertionError(f"spec joins got slots {slots}")
    out = {slot: [] for slot in slots}
    live = set(slots)

    def round_():
        toks, counts = engine.spec_step()
        emitted = 0
        for slot in sorted(live):
            window = toks[slot, :counts[slot]].tolist()
            take = window[:SPEC_STEPS - len(out[slot])]
            out[slot] += take
            emitted += len(take)
            if len(out[slot]) >= SPEC_STEPS:
                engine.retire(slot)
                live.discard(slot)
        return emitted

    prof = (profile_steps(round_, profile, "spec rounds") if profile
            else {})
    torch.cuda.synchronize()
    t0, emitted = time.perf_counter(), 0
    while live:
        emitted += round_()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    result = dict(tokens=[out[s] for s in slots], rounds=engine.steps_total,
                  launches=pa.launches + pa.kv8_launches,
                  debug=engine.spec_debug(), tok_s=emitted / decode_s,
                  profile=prof)
    del engine
    torch.cuda.empty_cache()
    want = LAYERS * result["rounds"] if attend == "kernel" else 0
    if result["launches"] != want:
        raise AssertionError(f"spec engine {attend}: B4 launches "
                             f"{result['launches']} over {result['rounds']} "
                             f"rounds, want {want}")
    return result


def spec_lanes_check(label, tmodel, dmodel, prompts, runs, k, mix, tie,
                     one_lane=False) -> list:
    """Each lane of ``runs`` (engine tokens) against its solo
    ``speculative_generate`` on the card: identical, or parting where the
    solo run's decision margin is within ``tie`` (at most one lane with
    ``one_lane``). Returns the partings (lane, step, margin)."""
    parted = []
    for lane, (prompt, got, (t, tp, seed)) in enumerate(
            zip(prompts, runs, mix)):
        part = spec_parting(tmodel, dmodel, prompt, got, k, t, tp, seed)
        if part is not None:
            parted.append((lane, *part))
    print(f"{label}: lanes parting from their solo speculative_generate "
          f"(lane, first step, the solo run's decision margin there): "
          f"{parted} (limit {tie}{', at most one lane' if one_lane else ''})",
          flush=True)
    if ((one_lane and len(parted) > 1)
            or any(margin > tie for _, _, margin in parted)):
        raise AssertionError(f"{label}: lanes part from solo away from a "
                             f"near-tie: {parted}")
    return parted


def spec_phase(pa, base, params, prompts, plain_f32, plain_bf16, card):
    """Phase 17, speculative decoding at the serving width. Returns B4's
    and the kv8 B4's launches by path."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.ops.paged_attention import MAX_ROWS
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    greedy = [(0.0, None, 0)] * len(prompts)
    # (a) f32, the target as its own draft: the kernel read against the
    # gather read, each lane against phase 6's plain engine and its solo
    # speculative_generate.
    runs = {attend: spec_engine_run(pa, base, params, base, params,
                                    SPEC_SELF_K, prompts, greedy, attend)
            for attend in ("kernel", "gather")}
    kern = runs["kernel"]
    if kern["tokens"] != runs["gather"]["tokens"]:
        raise AssertionError("spec f32: kernel tokens differ from gather")
    model = _decode_model(base, params, None)
    plain_parted = []
    for lane, (prompt, got) in enumerate(zip(prompts, kern["tokens"])):
        if got != plain_f32[:SPEC_STEPS, lane].tolist():
            plain_parted.append((lane, *solo_parting(
                model, base, prompt, np.asarray(got), 0.0, None, 0)))
    print(f"spec f32 (17a), self-draft k={SPEC_SELF_K}: kernel tokens == "
          f"gather tokens over {len(prompts)} lanes x {SPEC_STEPS}; "
          f"{kern['rounds']} rounds, B4 launches {kern['launches']}, "
          f"{kern['debug']}; lanes parting from phase 6's plain engine "
          f"(lane, step, generate's top-two gap): {plain_parted}",
          flush=True)
    if len(plain_parted) > 1 or any(g > NEAR_TIE for *_, g in plain_parted):
        raise AssertionError(f"spec f32 parts from the plain engine: "
                             f"{plain_parted}")
    if kern["debug"]["accept_rate"] < 0.9:
        raise AssertionError("a self-draft should accept nearly every "
                             f"proposal: {kern['debug']}")
    spec_lanes_check("spec f32 (17a)", model, model, prompts, kern["tokens"],
                     SPEC_SELF_K, greedy, NEAR_TIE / 2, one_lane=True)
    del model
    torch.cuda.empty_cache()

    # (b) bf16, the truncated draft at k = 7, SAMPLING's mix: 8 rounds
    # profiled, then timed; each lane against its solo stream.
    cfg = replace(base, dtype=torch.bfloat16)
    dcfg = replace(cfg, n_layers=DRAFT_LAYERS)
    dparams = truncated_draft(params, DRAFT_LAYERS)
    bf16 = spec_engine_run(pa, cfg, params, dcfg, dparams, SPEC_K, prompts,
                           SAMPLING, profile=PROFILE_STEPS)
    prof = bf16["profile"]
    print(f"spec bf16 (17b), draft of {DRAFT_LAYERS} layers, k={SPEC_K}, "
          f"{SAMPLING} (temperature, top_p, seed): {bf16['debug']}; "
          f"{bf16['rounds']} rounds; B4 launches {bf16['launches']}; per "
          f"round (8 profiled, four lanes live): device operations "
          f"{prof.get('events', 'not measured')}, device busy us "
          f"{prof.get('busy_us', 'not measured')}, busy share "
          f"{prof.get('busy_share', 'not measured')}; decode tokens/s "
          f"{bf16['tok_s']:.2f} against phase 7's plain engine "
          f"{plain_bf16:.2f} in this run, on {card}. Random weights: the "
          f"draft seldom agrees with the target, so these are the spec "
          f"rounds' overhead, not a speed-up", flush=True)
    tmodel = _decode_model(cfg, params, None)
    dmodel = _decode_model(dcfg, dparams, None)
    spec_lanes_check("spec bf16 (17b)", tmodel, dmodel, prompts,
                     bf16["tokens"], SPEC_K, SAMPLING, BF16_TIE)
    del tmodel, dmodel
    torch.cuda.empty_cache()

    # (c) bf16 on kv8 pools, one greedy lane at k = 4.
    cfg8 = replace(cfg, kv_int8=True)
    dcfg8 = replace(dcfg, kv_int8=True)
    kv8 = spec_engine_run(pa, cfg8, params, dcfg8, dparams, SPEC_KV8_K,
                          prompts[:1], greedy[:1])
    print(f"spec kv8 bf16 (17c), one lane, k={SPEC_KV8_K}: {kv8['debug']}; "
          f"kv8 B4 launches {kv8['launches']} over {kv8['rounds']} rounds "
          f"(t = {SPEC_KV8_K + 1})", flush=True)
    tmodel = _decode_model(cfg8, params, None)
    dmodel = _decode_model(dcfg8, dparams, None)
    spec_lanes_check("spec kv8 bf16 (17c)", tmodel, dmodel, prompts[:1],
                     kv8["tokens"], SPEC_KV8_K, greedy[:1], BF16_TIE)
    del tmodel, dmodel
    torch.cuda.empty_cache()

    # (d) the f32 front with --spec-k 4 and serve_lm's default draft depth
    # (layers // 2: the truncated draft).
    supervisor, server, url = open_front(
        base, params, spec_k=SPEC_SELF_K,
        draft_params=truncated_draft(params, LAYERS // 2))
    pa.launches = pa.kv8_launches = 0
    bodies = [dict(tokens=p.tolist(), num_steps=SPEC_STEPS) for p in prompts]
    responses, wall = send_all(url, bodies)
    engine = supervisor.engine
    front_launches, rounds = pa.launches, engine.steps_total
    _, health = http(url, "/healthz")
    _, debug = http(url, "/debug/serve")
    _, metrics = http(url, "/metrics")
    server.drain()
    del supervisor, server, engine
    model = _decode_model(base, params, None)
    front_parted = []
    for lane, (prompt, resp) in enumerate(zip(prompts, responses)):
        got = resp["tokens"][0]
        if got != kern["tokens"][lane]:
            front_parted.append((lane, *solo_parting(
                model, base, prompt, np.asarray(got), 0.0, None, 0)))
    del model
    torch.cuda.empty_cache()
    samples = {f: float(re.search(rf"^{f} (\S+)$", metrics, re.M)[1])
               for f in ("tpu_serve_spec_rounds_total",
                         "tpu_serve_spec_accept_tokens_count")}
    print(f"spec front f32 (17d), --spec-k {SPEC_SELF_K}, draft of "
          f"{LAYERS // 2} layers: 4 requests in {wall:.4f} s, {rounds} "
          f"rounds, B4 launches {front_launches}; /healthz spec "
          f"{health.get('spec')}; /debug/serve spec {debug.get('spec')}; "
          f"/metrics {samples}; responses parting from (a)'s engine streams "
          f"(lane, step, generate's top-two gap): {front_parted}",
          flush=True)
    if (front_launches != LAYERS * rounds or not rounds
            or debug.get("spec", {}).get("k") != SPEC_SELF_K
            or "spec" not in health or not all(samples.values())
            or len(front_parted) > 1
            or any(g > NEAR_TIE for *_, g in front_parted)):
        raise AssertionError("spec front: launches, sections, families or "
                             "tokens are off")

    # (e) the row cap: k = 8 at 4 query heads a KV head is 36 rows.
    before = torch.cuda.memory_allocated()
    try:
        ContinuousEngine(base, params, len(prompts), kv_block=BLK,
                         kv_attend="kernel", spec_k=SPEC_K + 1,
                         draft_cfg=base, draft_params=params)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError(f"spec_k={SPEC_K + 1} built past the row cap")
    if (f"MAX_ROWS = {MAX_ROWS}" not in refused
            or torch.cuda.memory_allocated() != before):
        raise AssertionError(f"row cap refusal {refused!r} or device work "
                             "before it")
    print(f"spec row cap (17e): spec_k={SPEC_K + 1} refused before any "
          f"device work: {refused}", flush=True)
    return ({"spec f32 (17a)": kern["launches"],
             "spec bf16 (17b)": bf16["launches"],
             "spec front f32 (17d)": front_launches},
            {"spec kv8 bf16 (17c)": kv8["launches"]})


def key_bias_rows(name: str, p: torch.Tensor):
    """The key-bias slice of an attention bias, or None."""
    if name.endswith("attn.qkv.bias"):
        return p[1]
    if name.endswith("attn.kv.bias"):
        return p[0]
    return None


def train_run(cfg, params, batch, steps: int, tx, *, plain=False,
              profile=False, first_grads=False, place=None,
              **step_kw) -> dict:
    """``steps`` train steps from ``params`` on one batch, with the flash
    counts set to 0 just before the first; with ``plain``,
    reference_attention takes the kernels' place in the model; ``place``
    (a function of the model) cuts it before its state is made. Returns the
    model, the losses (and an MoE model's aux losses), the counts, after
    one warm-up step each step's seconds and, with ``first_grads``, a copy
    of the first step's gradients by parameter name."""
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        make_lm_train_step,
    )

    model = load_params(transformer.Transformer(cfg), params)
    if place is not None:
        place(model)
    state = TrainState.create(model, tx)
    step = make_lm_train_step(model, tx, **step_kw)
    forced = mock.patch.object(
        transformer, "attention",
        lambda q, k, v, causal: fa.reference_attention(q, k, v, causal))
    losses, auxes, seconds, grads = [], [], [], {}
    with forced if plain else contextlib.nullcontext():
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            if "aux_loss" in metrics:
                auxes.append(metrics["aux_loss"].item())
            if i:
                seconds.append(time.perf_counter() - t0)
            elif first_grads:
                grads = {name: p.grad.detach().clone()
                         for name, p in model.named_parameters()}
        counts = dict(fwd=fa.fwd_launches, dq=fa.dq_launches,
                      dkv=fa.dkv_launches)
        prof = (profile_steps(lambda: step(state, batch), 1, "train step")
                if profile else {})
    return dict(model=model, losses=losses, auxes=auxes, seconds=seconds,
                counts=counts, grads=grads, profile=prof)


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


def state_tensors(state) -> dict:
    """Every weight, AdamW moment and step count of a TrainState by name,
    and its step."""
    out = {"step": torch.tensor(state.step)}
    for name, p in state.model.named_parameters():
        out[name] = p.detach()
        for key, val in state.optimizer.state.get(p, {}).items():
            out[f"{name}/{key}"] = val
    return out


def ckpt_phase(params, card) -> dict:
    """Phase 18 (a): save, restore and carry on at bench.py's training
    shape, then evaluate_lm there through B1 and through the plain
    attention. Returns the phase's flash launches."""
    from tf_operator_tpu_torch.models import transformer
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adamw,
        evaluate_lm,
        make_lm_eval_step,
        make_lm_train_step,
    )

    cfg = transformer.TransformerConfig(dtype=torch.bfloat16, **LM)
    rng = np.random.default_rng(18)
    batches = [{name: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T)).astype(np.int64)).cuda()
        for name in ("tokens", "targets")}
        for _ in range(CKPT_STEPS + CKPT_MORE)]
    tx = adamw(1e-4)

    def trainer(tree):
        model = transformer.Transformer(cfg)
        if tree is not None:
            load_params(model, tree)
        return TrainState.create(model, tx), make_lm_train_step(
            model, tx, xent_chunk=XENT_CHUNK, xent_dot_dtype=torch.bfloat16)

    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    twin, twin_step = trainer(params)
    for batch in batches[:CKPT_STEPS]:
        twin, _ = twin_step(twin, batch)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, max_to_keep=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not mgr.save(CKPT_STEPS - 1, twin):
            raise AssertionError("the save was refused")
        copy_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        step_dir = os.path.join(tmp, str(CKPT_STEPS - 1))
        disk = sum(os.path.getsize(os.path.join(step_dir, f))
                   for f in os.listdir(step_dir))
        restored, restored_step = trainer(None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(None, restored)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mgr.close()
    want, got = state_tensors(twin), state_tensors(restored)
    bad = sorted(k for k in want if k not in got
                 or want[k].dtype != got[k].dtype
                 or want[k].device != got[k].device
                 or not torch.equal(want[k].cpu(), got[k].cpu()))
    if got.keys() != want.keys() or bad:
        raise AssertionError(f"restored state differs: {bad[:8]}, keys "
                             f"{sorted(got.keys() ^ want.keys())[:8]}")
    moments = sum(v.numel() for k, v in want.items()
                  if k.endswith("exp_avg") or k.endswith("exp_avg_sq"))
    losses = {"twin": [], "restored": []}
    for batch in batches[CKPT_STEPS:]:
        twin, m = twin_step(twin, batch)
        losses["twin"].append(m["loss"].item())
        restored, m = restored_step(restored, batch)
        losses["restored"].append(m["loss"].item())
    loss_diff = max(abs(a - b) for a, b in zip(*losses.values()))
    n_params = sum(p.numel() for p in twin.model.parameters())
    print(f"checkpoint (18a) {n_params} params + {moments} moment elements "
          f"at step {CKPT_STEPS - 1}: save {save_s:.6f} s (blocking host "
          f"copy {copy_s:.6f} s, write until durable {save_s - copy_s:.6f} "
          f"s), {disk} bytes on disk, restore {restore_s:.6f} s; restored "
          f"state bitwise ({len(want)} tensors); losses after the restore "
          f"{losses['restored']} vs the uninterrupted twin "
          f"{losses['twin']} (max diff {loss_diff:.3e}, tolerance "
          f"{CKPT_LOSS_TOL}) on {card}", flush=True)
    if not loss_diff <= CKPT_LOSS_TOL:
        raise AssertionError("the restored trainer parts from its twin")
    train = dict(fwd=fa.fwd_launches, dq=fa.dq_launches, dkv=fa.dkv_launches)
    del restored, restored_step
    torch.cuda.empty_cache()

    rows = [{name: rng.integers(0, cfg.vocab_size, (n, TRAIN_T)).astype(
        np.int32) for name in ("tokens", "targets")} for n in EVAL_ROWS]
    hidden = []
    hook = twin.model.register_forward_hook(
        lambda module, args, out: hidden.append(out.detach()))

    def eval_run(plain_causal=None):
        """evaluate_lm through the kernels, or with reference_attention in
        their place (``plain_causal`` False: the control's non-causal
        fault); returns its result and its batches' final hidden
        states."""
        hidden.clear()
        step = make_lm_eval_step(twin.model, xent_chunk=XENT_CHUNK)
        if plain_causal is None:
            res = evaluate_lm(step, twin, rows)
        else:
            with mock.patch.object(
                    transformer, "attention",
                    lambda q, k, v, causal: fa.reference_attention(
                        q, k, v, plain_causal)):
                res = evaluate_lm(step, twin, rows)
        return res, list(hidden)

    def hidden_diff(got, want):
        return max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want, strict=True))

    try:
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, out_hidden = eval_run()
        eval_s = time.perf_counter() - t0
        counts = dict(fwd=fa.fwd_launches, dq=fa.dq_launches,
                      dkv=fa.dkv_launches)
        plain, plain_hidden = eval_run(plain_causal=True)
        control, control_hidden = eval_run(plain_causal=False)
    finally:
        hook.remove()
    eval_diff = abs(out["loss"] - plain["loss"])
    control_diff = abs(control["loss"] - plain["loss"])
    h_diff = hidden_diff(out_hidden, plain_hidden)
    h_control = hidden_diff(control_hidden, plain_hidden)
    h_scale = max(h.float().abs().max().item() for h in plain_hidden)
    print(f"eval (18a) {len(EVAL_ROWS)} batches of {list(EVAL_ROWS)} rows x "
          f"{TRAIN_T}: loss {out['loss']:.6f} (plain attention "
          f"{plain['loss']:.6f}, diff {eval_diff:.3e}, tolerance "
          f"{EVAL_LOSS_TOL}; control, non-causal plain attention "
          f"{control['loss']:.6f}, diff {control_diff:.3e}); final hidden "
          f"states max-abs diff {h_diff:.3e} (tolerance {EVAL_HIDDEN_TOL}; "
          f"control {h_control:.3e}; max |plain| {h_scale:.3e}); "
          f"perplexity {out['perplexity']:.2f}, {out['tokens']:.0f} tokens "
          f"in {eval_s:.6f} s: eval tokens/s {out['tokens'] / eval_s:.2f}; "
          f"launches {counts} on {card}", flush=True)
    want_fwd = cfg.n_layers * len(EVAL_ROWS)
    if counts != dict(fwd=want_fwd, dq=0, dkv=0):
        raise AssertionError(f"eval launches {counts}, want {want_fwd} "
                             "forwards and no backward")
    if out["tokens"] != sum(EVAL_ROWS) * TRAIN_T or not (
            eval_diff <= EVAL_LOSS_TOL and h_diff <= EVAL_HIDDEN_TOL
            and math.isfinite(out["loss"])):
        raise AssertionError(f"eval {out} against plain {plain}")
    if not (h_control > EVAL_HIDDEN_TOL and control_diff > EVAL_LOSS_TOL):
        raise AssertionError("the eval's checks cannot tell a non-causal "
                             "attention from the plain one")
    del out_hidden, plain_hidden, control_hidden
    del twin, twin_step
    torch.cuda.empty_cache()
    return {"flash_fwd": train["fwd"] + counts["fwd"],
            "flash_dq": train["dq"], "flash_dkv": train["dkv"]}


def entry_point_phase(card) -> dict:
    """Phase 18 (b): ``python -m tf_operator_tpu_torch.train.dist_lm`` on
    the card with no --device. Run 1 (with TPU_CKPT_ACK_FILE) gets one
    SIGTERM after its first ack, must ack a forced save, keep training
    and exit 138 at ENTRY_FAIL_AT; run 2 resumes from the next step and
    exits 0; run 3 (beside run 1) trains uninterrupted, and its final
    checkpoint is run 2's. Returns the flash launches the runs print."""
    from tf_operator_tpu_torch.ckpt import protocol
    from tf_operator_tpu_torch.train import checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in (
        protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
        protocol.ENV_RESUME_STEP)}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_lm",
           *ENTRY_ARGS]
    procs = []
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck, twin = os.path.join(tmp, "ck"), os.path.join(tmp, "twin")
        ack = os.path.join(tmp, "ack.json")
        logs = [os.path.join(tmp, f"run{i}.log") for i in (1, 2, 3)]

        def start(i, args, extra_env=None):
            with open(logs[i - 1], "w") as out:
                proc = subprocess.Popen(cmd + args, cwd=root,
                                        env={**env, **(extra_env or {})},
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc

        def log(i):
            with open(logs[i - 1]) as f:
                return f.read()

        try:
            first = start(1, ["--checkpoint-dir", ck, "--fail-at-step",
                              str(ENTRY_FAIL_AT)], {protocol.ENV_ACK_FILE: ack})
            third = start(3, ["--checkpoint-dir", twin])
            limit = time.monotonic() + 300
            while protocol.read_ack(ack) is None:
                if first.poll() is not None or time.monotonic() > limit:
                    raise AssertionError(f"run 1 never acked: {log(1)}")
                time.sleep(0.005)
            first_ack = protocol.read_ack(ack).step
            first.send_signal(signal.SIGTERM)
            rc1, rc3 = first.wait(timeout=300), third.wait(timeout=300)
            acked = re.search(r"eviction signal — checkpoint durable at step "
                              r"(\d+)", log(1))
            final_ack = protocol.read_ack(ack)
            if (rc1 != 138 or acked is None
                    or f"simulating preemption at step {ENTRY_FAIL_AT}"
                    not in log(1) or final_ack.step < int(acked.group(1))
                    or final_ack.directory != os.path.abspath(ck)):
                raise AssertionError(f"run 1: rc {rc1}, ack {final_ack}: "
                                     f"{log(1)}")
            second = start(2, ["--checkpoint-dir", ck, "--fail-at-step",
                               str(ENTRY_FAIL_AT)])
            rc2 = second.wait(timeout=300)
            if (rc2 != 0 or f"dist_lm: resumed from step {ENTRY_FAIL_AT + 1}"
                    not in log(2) or "dist_lm: OK" not in log(2)):
                raise AssertionError(f"run 2: rc {rc2}: {log(2)}")
            if rc3 != 0 or "dist_lm: OK" not in log(3):
                raise AssertionError(f"run 3: rc {rc3}: {log(3)}")
            last = checkpoint.latest_step(ck)
            a, _ = checkpoint.read(ck, last)
            b, _ = checkpoint.read(twin, last)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
        for i in (1, 2, 3):
            m = re.findall(r"flash launches fwd=(\d+) dq=(\d+) dkv=(\d+)",
                           log(i))
            for key, n in zip(launches, m[-1]):
                launches[key] += int(n)
        losses = [re.search(r"final loss (\S+)", log(i)).group(1)
                  for i in (2, 3)]

    def leaves(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, f"{prefix}{key}/")
            else:
                yield prefix + key, val

    fa_, fb = dict(leaves(a)), dict(leaves(b))
    if fa_.keys() != fb.keys():
        raise AssertionError("the two final checkpoints hold other trees")
    diffs = {k: (fa_[k].double() - fb[k].double()).abs().max().item()
             for k in fa_}
    worst = max(diffs.items(), key=lambda kv: kv[1])
    bitwise = all(torch.equal(fa_[k], fb[k]) for k in fa_)
    lr = float(ENTRY_ARGS[ENTRY_ARGS.index("--lr") + 1])
    steps = int(ENTRY_ARGS[ENTRY_ARGS.index("--steps") + 1])
    bound = ADAM_BOUND * lr * (steps - ENTRY_FAIL_AT - 1)
    print(f"entry point (18b): run 1 acked step {first_ack} first, took "
          f"SIGTERM, acked its forced save at step {acked.group(1)}, kept "
          f"training and exited {rc1} at step {ENTRY_FAIL_AT}; run 2 resumed "
          f"from step {ENTRY_FAIL_AT + 1} and exited {rc2}; the final "
          f"checkpoint (step {last}) against the uninterrupted run 3: "
          f"{'bitwise' if bitwise else 'NOT bitwise'} ({len(fa_)} tensors, "
          f"largest difference {worst[1]:.3e} in {worst[0]}, tolerance "
          f"{bound:.3e}); final losses {losses[0]} / {losses[1]}; "
          f"launches {launches}; {time.perf_counter() - t_start:.1f} s on "
          f"{card}", flush=True)
    if not bitwise and not worst[1] <= bound:
        raise AssertionError("the resumed run parts from the uninterrupted "
                             "one")
    if not all(launches.values()):
        raise AssertionError(f"the entry point ran no kernel: {launches}")
    return launches


def blocks_of(n: int) -> int:
    return -(-n // BLK)


def wire_bytes(payload: dict) -> tuple[int, int]:
    """(decoded bytes, JSON bytes) of a shipped-KV payload."""
    from tf_operator_tpu_torch.serve.tier import payload_nbytes

    return payload_nbytes(payload), len(json.dumps(payload))


def span_ms(name: str) -> list[tuple[float, dict]]:
    """(ms, attrs) of the trace ring's ``name`` spans."""
    from tf_operator_tpu_torch.runtime.tracing import SERVE_TRACER

    return [(sp.duration_us / 1e3, sp.attrs)
            for sp in SERVE_TRACER.spans(name)]


def ship_engine_phase(pa, i8, base, params, prompts, want, card) -> int:
    """Phase 19 (a): f32 shipping at phase 6's width. A PrefillWorker on the
    card prefills the four prompts (lane SHIP_CHUNKED_LANE's in chunks of
    SHIP_CHUNK), each payload goes through json, a fresh engine ingests
    them, the four join by their exact prefixes and decode FIRST_STEPS
    greedy steps, which must equal phase 6's tokens (``want``, [step,
    lane]) with B4 at n_layers launches a forward and the decode step's
    compile count unmoved. Then lane 0's digest is exported from that
    engine, ingested by a second fresh engine and decoded PULL_STEPS steps,
    again phase 6's tokens. Returns B4's launches."""
    from tf_operator_tpu_torch.models.transformer import (
        _decode_model,
        _prefill,
    )
    from tf_operator_tpu_torch.serve import disagg
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    # A local prefill of lane 0's prompt (warmed once): the device work a
    # shipment spares the decode replica.
    model = _decode_model(base, params, None)
    prompt0 = torch.as_tensor(prompts[0], device=model.device)
    with torch.no_grad():
        _prefill(model, prompt0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _prefill(model, prompt0)
        torch.cuda.synchronize()
    local_ms = (time.perf_counter() - t0) * 1e3
    del model
    one_shot = disagg.PrefillWorker(base, params, kv_block=BLK)
    chunked = disagg.PrefillWorker(base, params, kv_block=BLK,
                                   prefill_chunk=SHIP_CHUNK)
    shipments, rows = [], []
    for lane, prompt in enumerate(prompts):
        worker = chunked if lane == SHIP_CHUNKED_LANE else one_shot
        t0 = time.perf_counter()
        payload = worker.prefill(prompt)
        t1 = time.perf_counter()
        payload = json.loads(json.dumps(payload))
        t2 = time.perf_counter()
        shipments.append(disagg.decode_shipment(payload,
                                                expect_tokens=prompt[0]))
        t3 = time.perf_counter()
        nbytes, json_bytes = wire_bytes(payload)
        rows.append(dict(lane=lane, tokens=prompt.shape[1], bytes=nbytes,
                         json_bytes=json_bytes, prefill_ship_s=t1 - t0,
                         json_s=t2 - t1, verify_s=t3 - t2))
    del one_shot, chunked
    engine = ContinuousEngine(base, params, len(prompts), kv_block=BLK,
                              kv_attend="kernel")
    # Retention, as serve_lm turns it on: the exact entry of a prompt that
    # ends mid-block outlives its copy-on-write, so it can be exported.
    engine.prefix_retain_max = 32
    compiles0 = engine.decode_step_compiles
    reset_counts(pa, i8)
    holds = []
    for shp, row in zip(shipments, rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        holds.append(engine.ingest_shipment(
            shp, reserve_steps=FIRST_STEPS))
        torch.cuda.synchronize()
        row["ingest_ms"] = (time.perf_counter() - t0) * 1e3
    slots = [engine.join(p, num_steps=FIRST_STEPS) for p in prompts]
    for hold in holds:
        engine.release_shipment(hold)
    if slots != list(range(len(prompts))) or None in holds:
        raise AssertionError(f"ship: holds {holds}, slots {slots}")
    tokens = np.stack([engine.step() for _ in range(FIRST_STEPS)])
    torch.cuda.synchronize()
    launches, forwards = pa.launches, engine.steps_total
    kv = engine.kv_debug()
    digest = disagg.chain_digests(prompts[0][0], BLK)[-1]
    t0 = time.perf_counter()
    exported = engine.export_prefix(digest)
    export_ms = (time.perf_counter() - t0) * 1e3
    del engine, holds
    torch.cuda.empty_cache()
    pulled = ContinuousEngine(base, params, len(prompts), kv_block=BLK,
                              kv_attend="kernel")
    hold = pulled.ingest_shipment(disagg.decode_shipment(
        json.loads(json.dumps(exported)), expect_tokens=prompts[0][0]),
        reserve_steps=PULL_STEPS)
    slot = pulled.join(prompts[0], num_steps=PULL_STEPS)
    pulled.release_shipment(hold)
    pull_tokens = [int(pulled.step()[slot]) for _ in range(PULL_STEPS)]
    pull_kv = pulled.kv_debug()
    del pulled
    torch.cuda.empty_cache()
    for row in rows:
        print(f"ship f32 (19a) lane {row['lane']}: {row['tokens']} tokens, "
              f"payload {row['bytes']} bytes decoded, {row['json_bytes']} "
              f"bytes of JSON; prefill and ship "
              f"{row['prefill_ship_s']:.4f} s, json round trip "
              f"{row['json_s']:.4f} s, verify {row['verify_s']:.4f} s, "
              f"ingest (pool write) {row['ingest_ms']:.3f} ms"
              + (f" (chunks of {SHIP_CHUNK})"
                 if row["lane"] == SHIP_CHUNKED_LANE else "")
              + f"; on {card}", flush=True)
    print(f"ship f32 (19a): local prefill of lane 0's {prompts[0].shape[1]} "
          f"tokens {local_ms:.3f} ms, its ingest {rows[0]['ingest_ms']:.3f} "
          f"ms; export of lane 0 {export_ms:.3f} ms "
          f"({wire_bytes(exported)[0]} bytes); {forwards} forwards, B4 "
          f"launches {launches}; kv {kv}; on {card}", flush=True)
    parted = np.argwhere(tokens != want[:FIRST_STEPS])
    if parted.size:
        raise AssertionError(f"ship f32: shipped tokens differ from phase "
                             f"6's at (step, lane) {parted[:8].tolist()}")
    if pull_tokens != want[:PULL_STEPS, 0].tolist():
        raise AssertionError(f"ship f32: the pulled lane differs: "
                             f"{pull_tokens} vs {want[:PULL_STEPS, 0]}")
    if (launches != LAYERS * forwards
            or kv["shipments_ingested"] != len(prompts)
            or pull_kv["shipments_ingested"] != 1
            or kv["prefill_tokens_saved"] != sum(LANES)
            or compiles0 != 0):
        raise AssertionError(f"ship f32: launches {launches} over {forwards}"
                             f" forwards, kv {kv}, pulled kv {pull_kv}")
    return launches


def tier_pool_blocks(steps: int) -> int:
    """(b)'s pool: lanes 0 and 1 at once and the pinned block, so lanes 2
    and 3 wait for them and retention must give way."""
    return 1 + sum(blocks_of(n + steps) for n in LANES[:2])


def tier_round(sched, prompts, steps) -> tuple[list, float]:
    """One round of (b): the prompts queued together in lane order, each
    greedy for ``steps``; (requests, wall s)."""
    from tf_operator_tpu_torch.serve.resilience import await_request
    from tf_operator_tpu_torch.serve.scheduler import ServeRequest

    t0 = time.perf_counter()
    reqs = [sched.enqueue(ServeRequest(p, steps)) for p in prompts]
    for req in reqs:
        await_request(req, timeout=600)
    return reqs, time.perf_counter() - t0


def tier_phase(pa, i8, base, params, prompts, want, card) -> dict:
    """Phase 19 (b): the host tier. f32 at phase 6's width, retention on,
    a TIER_BYTES tier, a pool of ``tier_pool_blocks``: the four prompts
    served (round 1, lanes 2 and 3 waiting for 0 and 1; retention gives way
    and entries spill), then served again (round 2): each lane's tokens
    those of round 1 and of phase 6, at least two restores, and round 2's
    prefill tokens fewer by the restored lengths. Then the kv8 case: lane
    TIER_KV8_LANE's prompt on phase 13's bf16 int8 + kv8 tree, spilled and
    restored, its tokens those of its unspilled run, with the kv8 B4 and
    both B5 routes launched. Returns the launches by kernel."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params
    from tf_operator_tpu_torch.runtime.metrics import (
        SERVE_PHASE_SECONDS,
        SERVE_PREFILL_TOKENS_TOTAL,
    )
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.scheduler import ContinuousScheduler
    from tf_operator_tpu_torch.serve.tier import HostTier

    def tiered(cfg, tree, blocks=None):
        engine = ContinuousEngine(cfg, tree, len(prompts), kv_block=BLK,
                                  kv_blocks=blocks, kv_attend="kernel")
        engine.prefix_retain_max = engine.prefix_advertise_max = 32
        engine.host_tier = HostTier(TIER_BYTES)
        return engine, ContinuousScheduler(engine).start()

    engine, sched = tiered(base, params, tier_pool_blocks(FIRST_STEPS))
    reset_counts(pa, i8)
    phase0 = {p: SERVE_PHASE_SECONDS.value(phase=p)
              for p in ("tier_spill", "tier_restore")}
    pf0 = SERVE_PREFILL_TOKENS_TOTAL.value()
    first, wall1 = tier_round(sched, prompts, FIRST_STEPS)
    pf1 = SERVE_PREFILL_TOKENS_TOTAL.value()
    restored0 = engine.tier_restore_tokens
    second, wall2 = tier_round(sched, prompts, FIRST_STEPS)
    pf2 = SERVE_PREFILL_TOKENS_TOTAL.value()
    sched.stop(timeout=120)
    torch.cuda.synchronize()
    f32_launches = pa.launches
    kv = engine.kv_debug()
    restored = engine.tier_restore_tokens - restored0
    # No earlier phase has a tier: every spill and restore span is (b)'s.
    spills = span_ms("kv.spill")
    restores = span_ms("kv.restore")
    phase_s = {p: SERVE_PHASE_SECONDS.value(phase=p) - v
               for p, v in phase0.items()}
    del engine, sched
    torch.cuda.empty_cache()
    spill_bytes = sum(a["bytes"] for _, a in spills)
    restore_bytes = sum(a["bytes"] for _, a in restores)
    for label, events in (("spill", spills), ("restore", restores)):
        for ms, a in events:
            what = (f"{a['entries']} entries" if label == "spill"
                    else f"{a['tokens']} tokens")
            print(f"tier f32 (19b): {label} of {what}, {a['bytes']} bytes, "
                  f"{ms:.3f} ms, {a['bytes'] / ms / 1e6:.4f} GB/s; on "
                  f"{card}", flush=True)
    print(f"tier f32 (19b): pool {tier_pool_blocks(FIRST_STEPS)} blocks; "
          f"round 1 {wall1:.3f} s, prefill tokens {pf1 - pf0}; round 2 "
          f"{wall2:.3f} s, prefill tokens {pf2 - pf1}, restored tokens "
          f"{restored}; {len(spills)} spills, {spill_bytes} bytes in "
          f"{phase_s['tier_spill']:.4f} s; {len(restores)} restores, "
          f"{restore_bytes} bytes in {phase_s['tier_restore']:.4f} s; B4 "
          f"launches {f32_launches}; kv {kv}; on {card}", flush=True)
    for lane, (a, b) in enumerate(zip(first, second)):
        if a.out != b.out or a.out != want[:FIRST_STEPS, lane].tolist():
            raise AssertionError(f"tier f32: lane {lane} differs between "
                                 f"the rounds or from phase 6")
    if (kv["tier"]["restores"] < 2 or pf2 - pf1 != (pf1 - pf0) - restored
            or not any(r.tier_join for r in second) or not f32_launches):
        raise AssertionError(f"tier f32: restores {kv['tier']}, prefill "
                             f"tokens {pf1 - pf0} then {pf2 - pf1}, restored "
                             f"{restored}")

    cfg8 = replace(base, dtype=torch.bfloat16, int8_decode=True,
                   kv_int8=True)
    engine, sched = tiered(cfg8, quantize_decode_params(bf16_rounded(params)))
    reset_counts(pa, i8)
    prompt = prompts[TIER_KV8_LANE]
    (unspilled,), _ = tier_round(sched, [prompt], TIER_KV8_STEPS)
    sched.call_engine(lambda e: e._evict_retained(until_free=10 ** 9))
    (restored_req,), _ = tier_round(sched, [prompt], TIER_KV8_STEPS)
    sched.stop(timeout=120)
    torch.cuda.synchronize()
    got = dict(paged_attend_kv8=pa.kv8_launches,
               int8_matmul=i8.launches - i8.wgmma_launches,
               int8_matmul_prefill=i8.wgmma_launches)
    kv8 = engine.kv_debug()["tier"]
    del engine, sched
    torch.cuda.empty_cache()
    print(f"tier kv8 bf16 (19b): lane {TIER_KV8_LANE}, {TIER_KV8_STEPS} "
          f"steps, restored == unspilled: {restored_req.out == unspilled.out}"
          f", tier {kv8}, launches {got}; on {card}", flush=True)
    if (restored_req.out != unspilled.out or not restored_req.tier_join
            or pa.launches or not all(got.values())):
        raise AssertionError(f"tier kv8: tokens or launches {got}")
    got["paged_attend"] = f32_launches
    return got


def ship_front_phase(pa, i8, base, params, prompts, card) -> int:
    """Phase 19 (c): bf16 over HTTP on 127.0.0.1 in this process: a
    ``--role prefill`` replica (``serve_lm.build_prefill``), front L (local
    prefill) and front S (``--host-tier-bytes``). The four prompts at once
    on L; each prompt's POST /prefill, then the four /generate requests
    with ``shipped_kv`` at once on S: each response equal to L's. A prompt
    sharing lane 0's first two blocks, served on L, pulled from L by ``GET
    /prefix/<digest>`` (advertised on L's /healthz) and sent to S as
    ``shipped_kv``: S's response equal to L's. A tampered payload gets the
    typed ``ship_failed``, an unknown digest ``prefix_not_found``; S's
    /healthz carries ``prefixes`` and, after its retention cap drops to 2,
    ``tier_prefixes``; /metrics counts the ship and tier families. Prints
    the payload bytes, the prefill-and-ship seconds and the TTFT p50 of
    shipped against local requests. Returns B4's launches."""
    from tf_operator_tpu_torch.serve import disagg, serve_lm

    cfg = replace(base, dtype=torch.bfloat16)
    pre = serve_lm.build_prefill(cfg, params, serve_lm.front_args(
        device="cuda", role="prefill", kv_block=BLK,
        max_seq_len=cfg.max_seq_len, port=0)).start()
    pre_url = "http://" + pre.endpoint
    sup_l, srv_l, url_l = open_front(cfg, params)
    sup_s, srv_s, url_s = open_front(cfg, params,
                                     host_tier_bytes=TIER_BYTES)
    try:
        reset_counts(pa, i8)
        bodies = [dict(tokens=p.tolist(), num_steps=FIRST_STEPS, timing=True)
                  for p in prompts]
        local, local_wall = send_all(url_l, bodies)
        payloads, ship_s = [], []
        for p in prompts:
            t0 = time.perf_counter()
            status, out = http(pre_url, "/prefill", {"tokens": p.tolist()})
            ship_s.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"/prefill {status}: {out}")
            payloads.append(out["shipped_kv"])
        shipped, ship_wall = send_all(url_s, [
            dict(b, shipped_kv=pl) for b, pl in zip(bodies, payloads)])
        later = later_prompts(prompts, cfg.vocab_size)[0]
        body = dict(tokens=later.tolist(), num_steps=PULL_STEPS)
        _, ref = http(url_l, "/generate", body)
        _, health_l = http(url_l, "/healthz")
        digest = disagg.chain_digests(later[0], BLK)[-1]
        t0 = time.perf_counter()
        status, pulled = http(url_l, f"/prefix/{digest}")
        pull_ms = (time.perf_counter() - t0) * 1e3
        if status != 200 or digest not in health_l.get("prefixes", ()):
            raise AssertionError(f"pull {status}: {digest} not advertised "
                                 f"or not exported")
        _, via = http(url_s, "/generate",
                      dict(body, shipped_kv=pulled["shipment"]))
        bad = dict(payloads[0], rows_sha1="0" * 40)
        bad_status, bad_out = http(url_s, "/generate",
                                   dict(bodies[0], shipped_kv=bad))
        miss_status, miss = http(url_l, "/prefix/" + "cd" * 20)
        _, health_s = http(url_s, "/healthz")

        def shrink(engine):
            engine.prefix_retain_max = 2
            engine._evict_retained()

        sup_s.scheduler.call_engine(shrink)
        _, tiered = http(url_s, "/healthz")
        _, metrics = http(url_s, "/metrics")
        kv_s = sup_s.debug_snapshot()["kv_cache"]
        torch.cuda.synchronize()
        launches = pa.launches
    finally:
        for server in (srv_l, srv_s):
            server.drain()
        pre.stop()
        del sup_l, sup_s
        torch.cuda.empty_cache()
    counted = {f: sum(float(v) for v in re.findall(
        rf"^tpu_serve_{f}(?:{{[^}}]*}})? (\S+)$", metrics, re.M))
        for f in SHIP_TIER_FAMILIES}
    sizes = [wire_bytes(pl) for pl in payloads]
    ttft = {label: float(np.percentile(
        [t["ttft_ms"] for r in rs for t in r["timing"]], 50))
        for label, rs in (("shipped", shipped), ("local", local))}
    for lane, (p, (nb, nj), s) in enumerate(zip(prompts, sizes, ship_s)):
        print(f"ship front bf16 (19c) lane {lane}: {p.shape[1]} tokens, "
              f"payload {nb} bytes decoded, {nj} bytes of JSON, POST "
              f"/prefill {s:.4f} s; on {card}", flush=True)
    print(f"ship front bf16 (19c): TTFT p50 shipped {ttft['shipped']:.3f} "
          f"ms (burst {ship_wall:.4f} s) vs local {ttft['local']:.3f} ms "
          f"(burst {local_wall:.4f} s); GET /prefix {pull_ms:.3f} ms "
          f"({wire_bytes(pulled['shipment'])[0]} bytes); S kv {kv_s}; "
          f"/metrics {counted}; B4 launches {launches}; on {card}",
          flush=True)
    for lane, (a, b) in enumerate(zip(shipped, local)):
        if a["tokens"] != b["tokens"] or not a["timing"][0].get(
                "shipped_kv"):
            raise AssertionError(f"ship front: lane {lane}'s shipped "
                                 f"response differs from the local one")
    if via.get("tokens") != ref["tokens"]:
        raise AssertionError("ship front: the pulled prefix's response "
                             "differs from front L's")
    if (bad_status, bad_out.get("code")) != (503, "ship_failed") or (
            miss_status, miss.get("code")) != (404, "prefix_not_found"):
        raise AssertionError(f"ship front: tampered {bad_status} {bad_out}, "
                             f"unknown digest {miss_status} {miss}")
    if (not health_s.get("prefixes") or not tiered.get("tier_prefixes")
            or kv_s["shipments_ingested"] != len(prompts) + 1
            or not all(counted[f] for f in ("kv_ship_ingest_total",
                                            "ship_tokens_total",
                                            "kv_tier_bytes",
                                            "kv_tier_spills_total"))
            or not launches):
        raise AssertionError(f"ship front: /healthz {sorted(health_s)} "
                             f"then {sorted(tiered)}, kv {kv_s}, /metrics "
                             f"{counted}, launches {launches}")
    return launches


def ship_phase(pa, i8, base, params, prompts, want, card) -> dict:
    """Phase 19; returns each serving kernel's launches by path."""
    t0 = time.perf_counter()
    ship = ship_engine_phase(pa, i8, base, params, prompts, want, card)
    tier = tier_phase(pa, i8, base, params, prompts, want, card)
    front = ship_front_phase(pa, i8, base, params, prompts, card)
    print(f"phase 19 (disaggregated prefill, prefix pulls, host tier): "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    label = "tier kv8 bf16 (19b)"
    return {
        "paged_attend": {"ship engine f32 (19a)": ship,
                         "tier engine f32 (19b)": tier["paged_attend"],
                         "ship front bf16 (19c)": front},
        "paged_attend_kv8": {label: tier["paged_attend_kv8"]},
        "int8_matmul": {label: tier["int8_matmul"]},
        "int8_matmul_prefill": {label: tier["int8_matmul_prefill"]},
    }


def pair_margin(model, prompt, got, other):
    """Where two greedy token runs of one prompt part: None when they are
    identical, else (the first parting step, half the gap between the two
    chosen tokens' logits there on the solo run fed their common prefix:
    the least logit change that flips that decision)."""
    got, other = np.asarray(got), np.asarray(other)
    if np.array_equal(got, other):
        return None
    step = int(np.flatnonzero(got != other)[0])
    feed = torch.as_tensor(got[None, :step + 1], device=model.device)
    values, _ = replay_values(model, torch.as_tensor(
        prompt, device=model.device), feed, 0.0, None, 0, step + 1)
    row = values[step, 0]
    return step, abs(row[int(got[step])] - row[int(other[step])]).item() / 2


def partings(label, model, prompts, runs, wants, tie) -> list:
    """Each lane of ``runs`` against ``wants`` (``[lane][step]`` greedy
    tokens): identical, or parting where the solo margin is within
    ``tie``. Returns the partings (lane, step, margin)."""
    parted = []
    for lane, (prompt, got, want) in enumerate(zip(prompts, runs, wants)):
        part = pair_margin(model, prompt, got, want)
        if part is not None:
            parted.append((lane, *part))
    print(f"{label}: lanes parting (lane, first step, the solo run's "
          f"margin between the two choices there): {parted} (limit {tie})",
          flush=True)
    if any(margin > tie for *_, margin in parted):
        raise AssertionError(f"{label}: parts away from a near-tie: "
                             f"{parted}")
    return parted


def dense_engine_run(pa, i8, cfg, params, prompts, steps,
                     profile: int = 0) -> dict:
    """Phase 20's engine: ContinuousEngine(kv_paged=False) warmed, every
    serving kernel's count set to 0 just before the prompts join (greedy,
    ``steps`` + ``profile`` each), ``steps`` timed steps, then ``profile``
    more under torch.profiler."""
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine

    engine = ContinuousEngine(cfg, params, len(prompts), kv_paged=False)
    engine.warmup()
    reset_counts(pa, i8)
    fa.fwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [engine.join(p, num_steps=steps + profile) for p in prompts]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if slots != list(range(len(prompts))):
        raise AssertionError(f"dense joins got slots {slots}")
    tokens = []
    t0 = time.perf_counter()
    for _ in range(steps):
        tokens.append(engine.step())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    prof = (profile_steps(engine.step, profile, "dense decode steps")
            if profile else {})
    torch.cuda.synchronize()
    if not torch.isfinite(engine._logits).all():
        raise AssertionError("non-finite logits")
    kv = engine.kv_debug()
    if kv != {"mode": "dense", "cache_rows": len(prompts),
              "max_seq_len": cfg.max_seq_len}:
        raise AssertionError(f"dense kv_debug {kv}")
    out = dict(
        tokens=np.stack(tokens).T, prefill_s=prefill_s,
        decode_tok_s=len(prompts) * steps / decode_s, profile=prof,
        launches=dict(paged_attend=pa.launches,
                      paged_attend_kv8=pa.kv8_launches,
                      int8_matmul=i8.launches, int8_wgmma=i8.wgmma_launches,
                      flash_fwd=fa.fwd_launches),
        slot_bytes=sum(leaf.numel() * leaf.element_size()
                       for layer in engine._cache["layers"]
                       for leaf in layer.values()))
    flags = "".join(f" {f}" for f in ("int8_decode", "kv_int8")
                    if getattr(cfg, f))
    print(f"dense engine {cfg.dtype}{flags}, {len(prompts)} lane(s): "
          f"prefill_s {prefill_s:.4f} decode tokens/s "
          f"{out['decode_tok_s']:.2f}, slot tensor {out['slot_bytes']} "
          f"bytes, launches {out['launches']}", flush=True)
    if pa.launches or pa.kv8_launches:
        raise AssertionError("the dense engine launched the paged kernel")
    del engine
    torch.cuda.empty_cache()
    return out


def dense_front_phase(pa, i8, cfg, params, prompts, want) -> dict:
    """Phase 20 (d), first half: a ``--kv-dense`` front at (a)'s width
    (``open_front``'s kernel read is forced to the gather's): the four
    prompts at once, each equal to (a)'s lane or parting at a near-tie; a
    ``shipped_kv`` request (a PrefillWorker's payload of lane 3's prompt)
    prefilled locally, counted ``unsupported`` and equal to lane 3's
    response; ``GET /prefix/<lane 0's first digest>`` the typed 404."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.runtime.metrics import SERVE_SHIP_INGEST_TOTAL
    from tf_operator_tpu_torch.serve.disagg import (
        PrefillWorker,
        chain_digests,
    )

    supervisor, server, url = open_front(cfg, params, kv_paged=False)
    engine = supervisor.engine
    bodies = [dict(tokens=p.tolist(), num_steps=FIRST_STEPS)
              for p in prompts]
    responses, wall = send_all(url, bodies)
    payload = PrefillWorker(cfg, params, kv_block=BLK).prefill(prompts[3])
    unsupported = SERVE_SHIP_INGEST_TOTAL.value(outcome="unsupported")
    status, shipped = http(url, "/generate",
                           dict(bodies[3], shipped_kv=payload))
    counted = (SERVE_SHIP_INGEST_TOTAL.value(outcome="unsupported")
               - unsupported)
    digest = chain_digests(prompts[0].reshape(-1), BLK)[0]
    pstatus, miss = http(url, f"/prefix/{digest}")
    _, debug = http(url, "/debug/serve")
    server.drain()
    del supervisor, server, engine
    model = _decode_model(cfg, params, None)
    got = [r["tokens"][0] for r in responses]
    parted = partings("dense front bf16 (20d) against (a)", model, prompts,
                      got, want, BF16_TIE)
    del model
    torch.cuda.empty_cache()
    print(f"dense front bf16 (20d): 4 requests at once in {wall:.4f} s; "
          f"shipped_kv answered {status}, counted unsupported {counted}, "
          f"== lane 3's response {shipped.get('tokens') == [got[3]]}; GET "
          f"/prefix/{digest[:12]}... {pstatus} {miss.get('code')}; "
          f"/debug/serve kv_cache {debug['kv_cache']}", flush=True)
    if (status != 200 or counted != 1 or shipped["tokens"] != [got[3]]
            or pstatus != 404 or miss.get("code") != "prefix_not_found"
            or debug["kv_cache"].get("mode") != "dense"):
        raise AssertionError("dense front: shipment, prefix or mode off")
    return dict(wall=wall, parted=parted)


def coalesce_front_phase(pa, i8, cfg, params) -> dict:
    """Phase 20 (d), second half: the legacy front, ``--batch-window
    COALESCE_WINDOW_MS --max-batch 8``, over COALESCE_N same-shape greedy
    prompts: each alone first (its solo answer), then two bursts of all at
    once. The bursts must run as fewer decodes than requests, a batch of
    at least two rows; each burst answer equal to its solo answer or
    parting at a near-tie (a batch of 8 rows rounds bf16 in other orders
    than one row); the second burst bitwise the first."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.serve import serve_lm

    args = serve_lm.front_args(device="cuda", batch_window=COALESCE_WINDOW_MS,
                               max_batch=8, max_seq_len=cfg.max_seq_len,
                               port=0)
    supervisor, server = serve_lm.build_front(cfg, params, args)
    if supervisor is not None or server.coalescer is None:
        raise AssertionError("--batch-window did not select the legacy "
                             "coalescing front")
    server.start()
    url = "http://" + server.endpoint
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, (1, COALESCE_P)).astype(
        np.int32) for _ in range(COALESCE_N)]
    bodies = [dict(tokens=p.tolist(), num_steps=COALESCE_STEPS)
              for p in prompts]
    reset_counts(pa, i8)
    t0 = time.perf_counter()
    alone = [send_all(url, [b])[0][0]["tokens"][0] for b in bodies]
    alone_s = time.perf_counter() - t0
    _, before = http(url, "/healthz")
    first, first_s = send_all(url, bodies)
    second, second_s = send_all(url, bodies)
    _, health = http(url, "/healthz")
    server.drain()
    model = _decode_model(cfg, params, None)
    burst = [r["tokens"][0] for r in first]
    parted = partings("coalesce burst bf16 (20d) against each alone", model,
                      prompts, burst, alone, BF16_TIE)
    del model
    torch.cuda.empty_cache()
    batches = health["coalesced_batches"] - before["coalesced_batches"]
    print(f"coalesce front bf16 (20d): {COALESCE_N} prompts of "
          f"{COALESCE_P} tokens x {COALESCE_STEPS} steps; alone "
          f"{alone_s:.4f} s in all, burst {first_s:.4f} s and {second_s:.4f}"
          f" s ({COALESCE_N * COALESCE_STEPS / first_s:.2f} and "
          f"{COALESCE_N * COALESCE_STEPS / second_s:.2f} tokens/s with the "
          f"{COALESCE_WINDOW_MS:.0f} ms window); bursts ran {batches} "
          f"batch(es), max_batch_rows {health['max_batch_rows']}, second "
          f"burst == first {second == first}; launches "
          f"{dict(paged_attend=pa.launches, int8_matmul=i8.launches)}",
          flush=True)
    if (not 2 <= batches < 2 * COALESCE_N or health["max_batch_rows"] < 2
            or second != first or health["engine"] != "coalesce"):
        raise AssertionError(f"coalescing: {batches} batches, {health}, "
                             f"second burst == first {second == first}")
    return dict(batches=batches, alone_s=alone_s, burst_s=first_s,
                parted=parted)


def dense_phase(pa, i8, base, params, prompts, plain_f32, plain_bf16,
                card) -> dict:
    """Phase 20, the dense slot engine and the legacy coalescing engine
    at phase 6's width and prompts. Returns B5's launches by path."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params
    from tf_operator_tpu_torch.models.transformer import (
        _decode_model,
        generate,
    )

    t0 = time.perf_counter()
    greedy = [(0.0, None, 0)] * len(prompts)
    # (a) bf16, four lanes: against phase 7's paged engine on the same
    # prompts and schedule; then the f32 twin against phase 6's.
    cfg = replace(base, dtype=torch.bfloat16)
    bf16 = dense_engine_run(pa, i8, cfg, params, prompts, DENSE_STEPS,
                            profile=PROFILE_STEPS)
    model = _decode_model(cfg, params, None)
    partings("dense bf16 (20a) against phase 7's paged engine", model,
             prompts, bf16["tokens"],
             plain_bf16["tokens"][:DENSE_STEPS].T, BF16_TIE)
    del model
    torch.cuda.empty_cache()
    prof = bf16["profile"]
    print(f"dense bf16 (20a): decode tokens/s {bf16['decode_tok_s']:.2f} "
          f"against phase 7's paged engine {plain_bf16['decode_tok_s']:.2f}"
          f" in this run; per step ({PROFILE_STEPS} profiled, four lanes "
          f"live): device operations {prof.get('events', 'not measured')}, "
          f"device busy us {prof.get('busy_us', 'not measured')}, busy "
          f"share {prof.get('busy_share', 'not measured')}; slot tensor "
          f"{bf16['slot_bytes']} bytes; flash forward launches "
          f"{bf16['launches']['flash_fwd']} (the prefill is the decode "
          f"read's, as JAX's); on {card}", flush=True)
    f32 = dense_engine_run(pa, i8, base, params, prompts, DENSE_STEPS)
    model = _decode_model(base, params, None)
    partings("dense f32 (20a) against phase 6's paged engine", model,
             prompts, f32["tokens"], plain_f32[:DENSE_STEPS].T, NEAR_TIE / 2)

    # (b) f32 dense spec, the target as its own draft at k = 4.
    spec = spec_engine_run(pa, base, params, base, params, SPEC_SELF_K,
                           prompts, greedy, attend="gather", kv_paged=False)
    partings("dense spec f32 (20b) against (a)'s f32 twin", model, prompts,
             spec["tokens"], f32["tokens"][:, :SPEC_STEPS], NEAR_TIE / 2)
    spec_lanes_check("dense spec f32 (20b)", model, model, prompts,
                     spec["tokens"], SPEC_SELF_K, greedy, NEAR_TIE / 2,
                     one_lane=True)
    print(f"dense spec f32 (20b), self-draft k={SPEC_SELF_K}: "
          f"{spec['rounds']} rounds, {spec['debug']}, decode tokens/s "
          f"{spec['tok_s']:.2f}", flush=True)
    if spec["debug"]["accept_rate"] < 0.9:
        raise AssertionError("a self-draft should accept nearly every "
                             f"proposal: {spec['debug']}")
    del model
    torch.cuda.empty_cache()

    # (c) phase 13's int8 + kv8 tree (quantized from the bf16-rounded
    # weights), one lane: the prefill's projections take B5's wgmma tile,
    # its head row and every step the weight stream.
    cfg8 = replace(cfg, int8_decode=True, kv_int8=True)
    q16 = quantize_decode_params(bf16_rounded(params))
    lane = prompts[2:3]
    i8run = dense_engine_run(pa, i8, cfg8, q16, lane, DENSE_STEPS)
    calls = 5 * cfg8.n_layers + 1
    want = dict(paged_attend=0, paged_attend_kv8=0,
                int8_matmul=calls * (DENSE_STEPS + 1),
                int8_wgmma=calls - 1, flash_fwd=0)
    if i8run["launches"] != want:
        raise AssertionError(f"dense int8 + kv8 launches "
                             f"{i8run['launches']}, want {want}")
    model = _decode_model(cfg8, q16, None)
    solo = generate(cfg8, model, torch.as_tensor(lane[0],
                                                 device=model.device),
                    DENSE_STEPS)[0].cpu().numpy()
    partings("dense int8 + kv8 bf16 (20c) against solo generate", model,
             lane, i8run["tokens"], [solo], BF16_TIE)
    del model, q16
    torch.cuda.empty_cache()

    # (d) over HTTP.
    front = dense_front_phase(pa, i8, cfg, params, prompts, bf16["tokens"])
    legacy = coalesce_front_phase(pa, i8, cfg, params)
    print(f"phase 20 (dense and coalesce): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"int8_matmul": {"dense int8 bf16 (20c)": (
                i8run["launches"]["int8_matmul"]
                - i8run["launches"]["int8_wgmma"])},
            "int8_matmul_prefill": {
                "dense int8 bf16 (20c)": i8run["launches"]["int8_wgmma"]},
            "front": front, "legacy": legacy}


def classifier_tree_errors(got: dict, want: dict) -> dict:
    """{leaf path: max |got - want| / max |want|} over two exported
    classifier trees."""
    from tf_operator_tpu_torch.models.convert import _leaves

    out = {}
    for coll in want:
        flat_got = dict(_leaves(got[coll]))
        for path, w in _leaves(want[coll]):
            scale = max(float(np.abs(w).max()), 1e-30)
            out[f"{coll}/{'/'.join(path)}"] = float(
                np.abs(flat_got[path] - w).max()) / scale
    return out


def flax_conv_pads(conv, h: int, w: int) -> tuple[int, int, int, int]:
    """The pads of a port ``Conv`` as flax computes them, in F.pad's order
    (w low, w high, h low, h high): its explicit pads, or ``"SAME"``'s
    ``total = max((ceil(n / s) - 1) s + k - n, 0)`` split low-first."""
    if conv.padding != "SAME":
        (h0, h1), (w0, w1) = conv.padding
        return w0, w1, h0, h1
    out = []
    for n, k in ((w, conv.kernel.shape[3]), (h, conv.kernel.shape[2])):
        total = max((-(-n // conv.strides) - 1) * conv.strides + k - n, 0)
        out += [total // 2, total - total // 2]
    return tuple(out)


def bf16_layer_check(model, state, step, batch, probe) -> dict:
    """One train step of the bf16 ``model`` on ``batch`` and one inference
    pass over ``probe``, with forward hooks that hold every Conv,
    BatchNorm and the head against its plain version on the same inputs
    (see CLS_BF16_RTOL). Returns the worst error of each kind, the two
    controls and the smallest BatchNorm count n; raises on a layer in the
    wrong dtype."""
    import torch.nn.functional as F

    from tf_operator_tpu_torch.models.resnet import BatchNorm, Conv

    worst = dict(conv=0.0, bn=0.0, stats=0.0, eval_bn=0.0, head=0.0,
                 loss=0.0, unbiased=0.0, batch_stats_in_eval=0.0)
    before, logits, n_min = {}, [], [None]

    def note(key, err):
        worst[key] = max(worst[key], float(err))

    def rel(got, want):
        return (got - want).abs().max() / want.abs().max().clamp_min(1e-30)

    def conv_hook(mod, inp, out):
        x = inp[0]
        if x.dtype != mod.dtype or out.dtype != mod.dtype:
            raise AssertionError(f"conv in {x.dtype} -> {out.dtype}, the "
                                 f"model computes in {mod.dtype}")
        with torch.no_grad():
            xf = F.pad(x.detach().to(mod.dtype).float(),
                       flax_conv_pads(mod, *x.shape[2:]))
            bias = (None if mod.bias is None
                    else mod.bias.to(mod.dtype).float())
            plain = F.conv2d(xf, mod.kernel.detach().to(mod.dtype).float(),
                             bias, stride=mod.strides)
            note("conv", rel(out.detach().float(), plain))

    def bn_pre(mod, inp):
        before[mod] = (mod.mean.detach().clone(), mod.var.detach().clone())

    def bn_hook(mod, inp, out):
        x, train = inp
        if out.dtype != x.dtype:
            raise AssertionError(f"BatchNorm {x.dtype} -> {out.dtype}")
        with torch.no_grad():
            xd = x.detach().double()
            n = xd.numel() // xd.shape[1]
            m = xd.mean(dim=(0, 2, 3))
            v = xd.var(dim=(0, 2, 3), unbiased=False)
            scale = mod.scale.detach().double()
            bias = mod.bias.detach().double()

            def norm(mean, var):
                shape = (1, -1, 1, 1)
                return ((xd - mean.view(shape))
                        / torch.sqrt(var.view(shape) + 1e-5)
                        * scale.view(shape) + bias.view(shape))

            got = out.detach().double()
            if train:
                note("bn", rel(got, norm(m, v)))
                old_m, old_v = (t.double() for t in before.pop(mod))
                got_m = (mod.mean.double() - 0.9 * old_m) / 0.1
                got_v = (mod.var.double() - 0.9 * old_v) / 0.1
                vmax = v.max().clamp_min(1e-30)
                note("stats", max((got_m - m).abs().max() / vmax.sqrt(),
                                  (got_v - v).abs().max() / vmax))
                note("unbiased", (v * (n / (n - 1)) - v).abs().max() / vmax)
                n_min[0] = n if n_min[0] is None else min(n_min[0], n)
            else:
                want = norm(mod.mean.double(), mod.var.double())
                note("eval_bn", rel(got, want))
                note("batch_stats_in_eval", rel(norm(m, v), want))

    def head_hook(mod, inp, out):
        if out.dtype != torch.float32:
            raise AssertionError(f"the head computes in {out.dtype}")
        with torch.no_grad():
            plain = (inp[0].detach().double() @ mod.kernel.detach().double()
                     + mod.bias.detach().double())
            note("head", rel(out.detach().double(), plain))
            logits.append(out.detach())

    handles = []
    for mod in model.modules():
        if isinstance(mod, Conv):
            handles.append(mod.register_forward_hook(conv_hook))
        elif isinstance(mod, BatchNorm):
            handles.append(mod.register_forward_pre_hook(bn_pre))
            handles.append(mod.register_forward_hook(bn_hook))
    handles.append(model.Dense_0.register_forward_hook(head_hook))
    try:
        state, metrics = step(state, batch)
        labels = torch.as_tensor(batch["label"]).to(model.device).long()
        loss = float(metrics["loss"])
        plain = F.cross_entropy(logits[0].double(), labels).item()
        note("loss", abs(loss - plain) / abs(plain))
        with torch.no_grad():
            model(torch.as_tensor(probe).to(model.device), train=False)
    finally:
        for h in handles:
            h.remove()
    return dict(worst, n_min=n_min[0])


def bf16_check_line(label: str, got: dict) -> str:
    return (f"{label}: worst conv {got['conv']:.3e}, BatchNorm {got['bn']:.3e}"
            f", inference BatchNorm {got['eval_bn']:.3e} (limit "
            f"{CLS_BF16_RTOL}), batch statistics {got['stats']:.3e} (limit "
            f"{CLS_STAT_RTOL}), head {got['head']:.3e}, loss {got['loss']:.3e}"
            f" (limit {CLS_HEAD_RTOL}); controls: unbiased variance "
            f"{got['unbiased']:.3e} (smallest n {got['n_min']}), inference "
            f"on batch statistics {got['batch_stats_in_eval']:.3e}")


def bf16_check_failures(got: dict, unbiased_control: bool) -> list[str]:
    bad = [k for k, lim in (("conv", CLS_BF16_RTOL), ("bn", CLS_BF16_RTOL),
                            ("eval_bn", CLS_BF16_RTOL),
                            ("stats", CLS_STAT_RTOL),
                            ("head", CLS_HEAD_RTOL), ("loss", CLS_HEAD_RTOL))
           if not got[k] <= lim]
    if not got["batch_stats_in_eval"] > CLS_BF16_RTOL:
        bad.append("control: inference on batch statistics within the limit")
    if unbiased_control and not got["unbiased"] > CLS_STAT_RTOL:
        bad.append("control: the unbiased variance within the limit")
    return bad


def classifier_check_run(device, tree, batches, probe) -> dict:
    """(a)'s CHECK_STEPS SGD steps of the reduced f32 ResNet on
    ``device``: the losses, then the logits of ``probe`` in inference
    mode and the exported tree."""
    from tf_operator_tpu_torch.models.convert import (
        export_variables,
        load_variables,
    )
    from tf_operator_tpu_torch.models.resnet import ResNet
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        make_classifier_train_step,
        sgd_momentum,
    )

    model = load_variables(ResNet(CHECK_STAGES, 1000, CHECK_WIDTH,
                                  torch.float32, device=device), tree)
    tx = sgd_momentum(0.1)
    state = TrainState.create(model, tx)
    step = make_classifier_train_step(model, tx)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        logits = model(torch.from_numpy(probe).to(device), train=False)
    return {"losses": np.array(losses), "logits": logits.cpu().numpy(),
            "tree": export_variables(model)}


def classifier_check_phase(card: str) -> None:
    """Phase 21 (a): the reduced f32 ResNet's steps on the card against
    the same steps on the CPU, and the TF32 control."""
    from tf_operator_tpu_torch.models.convert import init_variables
    from tf_operator_tpu_torch.models.resnet import ResNet

    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("(a) needs TF32 off for cuDNN and matmuls")
    tree = init_variables(ResNet(CHECK_STAGES, 1000, CHECK_WIDTH,
                                 torch.float32, device="cpu"), 0)
    rng = np.random.default_rng(21)
    batches = [{"image": rng.normal(size=(CHECK_B, CHECK_HW, CHECK_HW, 3))
                .astype(np.float32),
                "label": rng.integers(0, 1000, (CHECK_B,)).astype(np.int32)}
               for _ in range(CHECK_STEPS)]
    probe = rng.normal(size=(CHECK_B, CHECK_HW, CHECK_HW, 3)).astype(
        np.float32)
    cpu = classifier_check_run("cpu", tree, batches, probe)

    def errors(run):
        scale = max(float(np.abs(cpu["logits"]).max()), 1e-30)
        return (float(np.abs(run["losses"] - cpu["losses"]).max()
                      / np.abs(cpu["losses"]).max()),
                float(np.abs(run["logits"] - cpu["logits"]).max()) / scale,
                classifier_tree_errors(run["tree"], cpu["tree"]))

    card_run = classifier_check_run("cuda", tree, batches, probe)
    loss_err, logit_err, leaf_err = errors(card_run)
    worst = max(leaf_err.items(), key=lambda kv: kv[1])
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = classifier_check_run("cuda", tree, batches, probe)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    c_loss, c_logit, c_leaf = errors(control)
    c_worst = max(c_leaf.items(), key=lambda kv: kv[1])
    print(f"classifier f32 (21a): ResNet{CHECK_STAGES} width {CHECK_WIDTH} "
          f"at {CHECK_HW}^2, B={CHECK_B}, {CHECK_STEPS} SGD steps, TF32 off: "
          f"losses {card_run['losses'].tolist()} (CPU "
          f"{cpu['losses'].tolist()}), loss rel err {loss_err:.3e}, logits "
          f"rel err {logit_err:.3e} (limit {CLS_LOGIT_RTOL}), worst of "
          f"{len(leaf_err)} leaves {worst[1]:.3e} in {worst[0]} (limit "
          f"{CLS_LEAF_RTOL}); control with TF32 on: loss {c_loss:.3e}, "
          f"logits {c_logit:.3e}, worst leaf {c_worst[1]:.3e} in "
          f"{c_worst[0]}; on {card}", flush=True)
    if not (loss_err <= CLS_LOGIT_RTOL and logit_err <= CLS_LOGIT_RTOL
            and worst[1] <= CLS_LEAF_RTOL):
        raise AssertionError("(a): the card's f32 steps part from the CPU's")
    if not c_logit > CLS_LOGIT_RTOL:
        raise AssertionError("(a): the TF32 control reads within the limit")

    # The same model in bf16 on the card: (a)'s first batch, layer by layer.
    from tf_operator_tpu_torch.models.convert import load_variables
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        make_classifier_train_step,
        sgd_momentum,
    )

    model = load_variables(ResNet(CHECK_STAGES, 1000, CHECK_WIDTH,
                                  torch.bfloat16, device="cuda"), tree)
    tx = sgd_momentum(0.1)
    got = bf16_layer_check(model, TrainState.create(model, tx),
                           make_classifier_train_step(model, tx), batches[0],
                           probe)
    print(bf16_check_line(f"classifier bf16 (21a): ResNet{CHECK_STAGES} "
                          f"width {CHECK_WIDTH} at {CHECK_HW}^2, B={CHECK_B}",
                          got) + f"; on {card}", flush=True)
    bad = bf16_check_failures(got, unbiased_control=True)
    if bad:
        raise AssertionError(f"(a) bf16: {bad}")


def write_bench_records(path: str) -> tuple[int, int]:
    """bench.py's ensure_bench_records layout at its shapes, seeded numpy
    (seed 0): RESNET_RECORDS records of RESNET_RECORD^2 x 3 image bytes
    and a label byte. Returns (record size, record bytes)."""
    rec_bytes = RESNET_RECORD * RESNET_RECORD * 3 + 1
    rng = np.random.default_rng(0)
    rng.integers(0, 256, (RESNET_RECORDS, rec_bytes),
                 dtype=np.uint8).tofile(path)
    return RESNET_RECORD, rec_bytes


def resnet_bench_phase(card: str, images, labels) -> dict:
    """Phase 21 (b): bf16 ResNet-50 from the resident records, both stems:
    images/s and MFU of RESNET_CALLS timed calls of RESNET_STEPS steps
    after a warm call, peak memory, one profiled step. Returns the s2d
    run's trained state for (c)."""
    from tf_operator_tpu_torch.models.convert import (
        init_variables,
        load_variables,
    )
    from tf_operator_tpu_torch.models.resnet import resnet50
    from tf_operator_tpu_torch.random import PRNGKey
    from tf_operator_tpu_torch.train.device_input import (
        make_resident_sampler,
        make_resident_train_loop,
    )
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        make_classifier_train_step,
        sgd_momentum,
    )

    from torch.utils.flop_counter import FlopCounterMode

    sample = make_resident_sampler(images, labels, RESNET_B, RESNET_HW)
    out = {}
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for stem in ("conv7", "s2d"):
            torch.cuda.empty_cache()
            model = resnet50(stem=stem)
            load_variables(model, init_variables(model, 0))
            tx = sgd_momentum(0.1)
            state = TrainState.create(model, tx)
            step = make_classifier_train_step(model, tx)
            # The first step layer by layer against the plain versions,
            # then torch's count of the second step's flops.
            got = bf16_layer_check(model, state, step, sample(PRNGKey(1)),
                                   sample(PRNGKey(2))["image"])
            print(bf16_check_line(f"resnet50 bf16 (21b) stem {stem}: first "
                                  f"step, B={RESNET_B} {RESNET_HW}^2", got)
                  + f"; on {card}", flush=True)
            bad = bf16_check_failures(got, unbiased_control=False)
            if bad:
                raise AssertionError(f"(b) {stem}: {bad}")
            counter = FlopCounterMode(display=False)
            with counter:
                state, _ = step(state, sample(PRNGKey(3)))
            counted = counter.get_total_flops() / RESNET_B
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fused = make_resident_train_loop(step, sample, RESNET_STEPS)
            key = PRNGKey(0)
            t0 = time.perf_counter()
            state, metrics, key = fused(state, key)
            warm_loss = float(metrics["loss"])
            warm_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RESNET_CALLS):
                state, metrics, key = fused(state, key)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if not (math.isfinite(loss) and math.isfinite(warm_loss)):
                raise AssertionError(f"resnet50 {stem}: loss {loss}")
            images_n = RESNET_B * RESNET_STEPS * RESNET_CALLS
            img_s = images_n / dt
            mfu = (3 * RESNET_FWD_FLOPS * images_n / dt
                   / PEAK_FLOPS[torch.bfloat16])
            mfu_counted = counted * images_n / dt / PEAK_FLOPS[torch.bfloat16]
            peak = torch.cuda.max_memory_allocated() / 1e9
            one = make_resident_train_loop(step, sample, 1)
            holder = {"state": state, "key": key}

            def one_step():
                holder["state"], _, holder["key"] = one(holder["state"],
                                                        holder["key"])

            one_step()
            prof = profile_steps(one_step, 1, f"resnet50 {stem} bf16 step "
                                              f"(B={RESNET_B})")
            print(f"resnet50 bf16 (21b) stem {stem}: B={RESNET_B} "
                  f"{RESNET_HW}^2 crops of {RESNET_RECORDS} resident "
                  f"{RESNET_RECORD}^2 records, {RESNET_CALLS} calls x "
                  f"{RESNET_STEPS} steps in {dt:.4f} s: images/s "
                  f"{img_s:.2f}, step_s {dt / RESNET_STEPS / RESNET_CALLS:.6f}"
                  f", MFU {mfu:.6f} (bench.py's count, 3 x 4.09e9 flops an "
                  f"image, at 989 TFLOP/s; 4.09e9 is ResNet-50's multiply-"
                  f"adds), MFU {mfu_counted:.6f} by torch.utils.flop_counter's"
                  f" count of a step, {counted:.6e} flops an image; warm call {warm_s:.2f} s (loss {warm_loss:.4f})"
                  f", final loss {loss:.4f}; peak memory {peak:.2f} GB; "
                  f"cudnn.benchmark on; on {card}", flush=True)
            out[stem] = dict(images_s=img_s, mfu=mfu, mfu_counted=mfu_counted,
                             flops_image=counted, peak_gb=peak, **prof)
            if stem == "s2d":
                out["state"] = holder["state"]
            del model, state, holder, fused, one
    finally:
        torch.backends.cudnn.benchmark = benchmark
    return out


def classifier_eval_phase(state, images_np, labels_np, card: str) -> None:
    """Phase 21 (c): make_classifier_eval_step + evaluate over batches of
    CLS_EVAL_ROWS rows (centre crops of the records, f32 on the host):
    the count exact, every batch padded to the first one's rows, the loss
    and accuracy those of a plain inference pass (CLS_EVAL_RTOL)."""
    import torch.nn.functional as F

    from tf_operator_tpu_torch.train.steps import (
        evaluate,
        make_classifier_eval_step,
    )

    lo = (RESNET_RECORD - RESNET_HW) // 2
    crops = ((images_np[:, lo:lo + RESNET_HW, lo:lo + RESNET_HW]
              .astype(np.float32) - 127.5) / 127.5)
    batches, start = [], 0
    for n in CLS_EVAL_ROWS:
        batches.append({"image": crops[start:start + n],
                        "label": labels_np[start:start + n] % 1000})
        start += n
    eval_step = make_classifier_eval_step(state.model)
    rows = []

    class Counted:
        shard_count = eval_step.shard_count

        def __call__(self, st, batch):
            rows.append(batch["image"].shape[0])
            return eval_step(st, batch)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = evaluate(Counted(), state, iter(batches))
    dt = time.perf_counter() - t0

    def plain(model, train):
        """The loss sum (float64) and correct count of ``model`` over the
        same rows, each batch zero-padded to the first one's rows."""
        loss_sum, correct = 0.0, 0
        with torch.no_grad():
            for b in batches:
                n = b["image"].shape[0]
                image = np.zeros((CLS_EVAL_ROWS[0],) + b["image"].shape[1:],
                                 np.float32)
                image[:n] = b["image"]
                logits = model(torch.from_numpy(image).cuda(),
                               train=train)[:n].double()
                label = torch.from_numpy(b["label"].astype(np.int64)).cuda()
                loss_sum += F.cross_entropy(logits, label,
                                            reduction="sum").item()
                correct += int((logits.argmax(-1) == label).sum())
        return loss_sum, correct

    total = sum(CLS_EVAL_ROWS)
    p_loss, p_correct = plain(state.model, False)
    c_loss, _ = plain(copy.deepcopy(state.model), True)
    loss_err = abs(m["loss"] - p_loss / total) / (p_loss / total)
    c_err = abs(c_loss - p_loss) / p_loss
    print(f"classifier eval (21c): batches {list(CLS_EVAL_ROWS)} padded to "
          f"{rows}: count {m['count']}, accuracy {m['accuracy']:.4f}, loss "
          f"{m['loss']:.6f}; plain inference pass: accuracy "
          f"{p_correct / total:.4f}, loss {p_loss / total:.6f}, loss rel "
          f"diff {loss_err:.3e} (limit {CLS_EVAL_RTOL}); control, BatchNorm "
          f"on batch statistics: {c_err:.3e}; "
          f"{total / dt:.2f} images/s on {card}", flush=True)
    if (m["count"] != total
            or rows != [CLS_EVAL_ROWS[0]] * len(CLS_EVAL_ROWS)
            or not math.isfinite(m["loss"])):
        raise AssertionError(f"(c): count {m['count']}, rows {rows}, {m}")
    if not (loss_err <= CLS_EVAL_RTOL
            and round(m["accuracy"] * total) == p_correct):
        raise AssertionError(f"(c): evaluate {m} parts from the plain pass "
                             f"(loss {p_loss / total}, correct {p_correct})")
    if not c_err > CLS_EVAL_RTOL:
        raise AssertionError("(c): the batch-statistics control reads within "
                             "the limit")


def mnist_entry_phase(card: str) -> None:
    """Phase 21 (d): ``python -m tf_operator_tpu_torch.train.dist_mnist``
    on the card with no --device: a plain run to OK beside a run killed
    at MNIST_FAIL_AT (exit 138); then the resumed run to OK beside an
    evaluator replica (TF_CONFIG task.type evaluator) that follows its
    checkpoints to DONE."""
    from tf_operator_tpu_torch.ckpt import protocol

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in (
        protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
        protocol.ENV_RESUME_STEP, "TF_CONFIG")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist",
           *MNIST_ARGS]
    procs = []
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        fail = ["--checkpoint-dir", ck, "--fail-at-step", str(MNIST_FAIL_AT)]

        def start(name, args, extra_env=None):
            with open(os.path.join(tmp, name), "w") as out:
                proc = subprocess.Popen(cmd + args, cwd=root,
                                        env={**env, **(extra_env or {})},
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc

        def log(name):
            with open(os.path.join(tmp, name)) as f:
                return f.read()

        try:
            plain, first = start("plain", []), start("first", fail)
            rc_plain, rc_first = plain.wait(timeout=300), first.wait(
                timeout=300)
            if rc_plain != 0 or "dist_mnist: OK" not in log("plain"):
                raise AssertionError(f"plain run: rc {rc_plain}: "
                                     f"{log('plain')}")
            if (rc_first != 138 or f"simulating preemption at step "
                    f"{MNIST_FAIL_AT}" not in log("first")):
                raise AssertionError(f"run 1: rc {rc_first}: {log('first')}")
            evaluator = start("eval", ["--checkpoint-dir", ck,
                                       "--eval-timeout", "120"],
                              {"TF_CONFIG": json.dumps(
                                  {"task": {"type": "evaluator"}})})
            resumed = start("resumed", fail)
            rc_resumed = resumed.wait(timeout=300)
            rc_eval = evaluator.wait(timeout=300)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        logs = {name: log(name) for name in ("plain", "first", "resumed",
                                             "eval")}
    if (rc_resumed != 0 or f"dist_mnist: resumed from step "
            f"{MNIST_FAIL_AT + 1}" not in logs["resumed"]
            or "dist_mnist: OK" not in logs["resumed"]):
        raise AssertionError(f"run 2: rc {rc_resumed}: {logs['resumed']}")
    evals = re.findall(r"dist_mnist eval: step (\d+) accuracy=(\S+) "
                       r"loss=(\S+)", logs["eval"])
    if rc_eval != 0 or "dist_mnist eval: DONE" not in logs["eval"]:
        raise AssertionError(f"evaluator: rc {rc_eval}: {logs['eval']}")
    final = {name: re.search(r"final loss (\S+)", logs[name]).group(1)
             for name in ("plain", "resumed")}
    rate = re.search(r"\((\d+) img/s", logs["plain"]).group(1)
    print(f"dist_mnist (21d): {' '.join(MNIST_ARGS)} on the card: plain run "
          f"OK (final loss {final['plain']}, {rate} img/s), run 1 exited "
          f"{rc_first} at step {MNIST_FAIL_AT}, run 2 resumed from step "
          f"{MNIST_FAIL_AT + 1} and exited {rc_resumed} (final loss "
          f"{final['resumed']}); the evaluator read steps "
          f"{[int(s) for s, _, _ in evals]} (last accuracy "
          f"{evals[-1][1]}, loss {evals[-1][2]}) and exited {rc_eval} after "
          f"DONE; {time.perf_counter() - t_start:.1f} s (beside phase 22 (c) "
          f"and (d)) on {card}",
          flush=True)


def classifier_phase(card: str) -> float:
    """Phase 21: the image classifiers, (a) to (c) ((d) runs beside phase
    22 (c) and (d), ``moe_phase``). Returns (b)'s conv7 images/s, the
    resident reading phase 23 (b) stands beside."""
    from tf_operator_tpu_torch.train.device_input import load_records_numpy

    t0 = time.perf_counter()
    classifier_check_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "records.bin")
        record, rec_bytes = write_bench_records(path)
        images_np, labels_np = load_records_numpy(path, rec_bytes, record)
    images = torch.from_numpy(images_np).cuda()
    labels = torch.from_numpy(labels_np).cuda()
    print(f"resident records: {images.numel() + labels.numel() * 4} bytes "
          f"on the card", flush=True)
    bench = resnet_bench_phase(card, images, labels)
    classifier_eval_phase(bench.pop("state"), images_np, labels_np, card)
    del images, labels
    torch.cuda.empty_cache()
    print(f"phase 21 (image classifiers): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return bench["conv7"]["images_s"]


def moe_routes(model, tokens) -> list:
    """Each MoE layer's (top_idx, probs) on the host, from one no-grad
    forward of ``model`` (in layer order)."""
    from tf_operator_tpu_torch.models import moe

    seen, route = [], moe.MoeMlp.route

    def record(self, x, group=None):
        out = route(self, x, group)
        seen.append((out[0].cpu(), out[2].float().cpu()))
        return out

    with mock.patch.object(moe.MoeMlp, "route", record), torch.no_grad():
        model(tokens, return_aux=True)
    return seen


def route_partings(got, want) -> tuple[int, float]:
    """(tokens whose choices differ, the widest gap between the two
    competing probabilities of such a token, read from ``want``'s): for
    each layer's (top_idx, probs) of two runs."""
    parted, widest = 0, 0.0
    for (gi, _), (wi, wp) in zip(got, want):
        diff = (gi != wi).any(-1)
        parted += int(diff.sum())
        for g, s in zip(*torch.nonzero(diff, as_tuple=True)):
            j = int(torch.nonzero(gi[g, s] != wi[g, s])[0])
            p = wp[g, s]
            widest = max(widest, abs(float(p[gi[g, s, j]]
                                           - p[wi[g, s, j]])))
    return parted, widest


def moe_train(cfg, params, batch, device, steps) -> dict:
    """``steps`` AdamW steps with the aux loss on ``device`` from
    ``params``; the flash counts set to 0 just before the first."""
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import Transformer
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_train_step,
    )

    model = load_params(Transformer(cfg, device), params)
    tx = adamw(MOE_F32_LR)
    state = TrainState.create(model, tx)
    step = make_lm_train_step(model, tx, aux_loss_weight=MOE_AUX_WEIGHT)
    batch = {k: v.to(model.device) for k, v in batch.items()}
    losses, auxes = [], []
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        auxes.append(m["aux_loss"].item())
    return dict(model=model, losses=losses, auxes=auxes, counts=dict(
        flash_fwd=fa.fwd_launches, flash_dq=fa.dq_launches,
        flash_dkv=fa.dkv_launches))


def moe_check_phase() -> dict:
    """Phase 22 (a): the reduced f32 MoE LM, card against CPU; returns the
    card run's flash launches."""
    from tf_operator_tpu_torch.models.convert import init_params, load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )

    cfg = TransformerConfig(dtype=torch.float32, **MOE_F32)
    params = init_params(cfg, seed=3)
    rng = np.random.default_rng(6)
    batch = {name: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_F32_B, MOE_F32_T)).astype(np.int64))
        for name in ("tokens", "targets")}
    cpu = moe_routes(load_params(Transformer(cfg, "cpu"), params),
                     batch["tokens"])
    card_model = load_params(Transformer(cfg), params)
    card = moe_routes(card_model, batch["tokens"].cuda())
    prob_err = max((g[1] - w[1]).abs().max().item()
                   for g, w in zip(card, cpu))
    parted, widest = route_partings(card, cpu)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = moe_routes(card_model, batch["tokens"].cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    control = max((g[1] - w[1]).abs().max().item()
                  for g, w in zip(tf32, cpu))
    tf32_parted, _ = route_partings(tf32, cpu)
    del card_model
    runs = {dev: moe_train(cfg, params, batch, dev, MOE_F32_STEPS)
            for dev in ("cuda", "cpu")}
    kern, ref = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(kern["losses"],
                                              ref["losses"]))
    aux_err = max(abs(a - b) for a, b in zip(kern["auxes"], ref["auxes"]))
    lr_sum = MOE_F32_LR * MOE_F32_STEPS
    max_err, far, total = 0.0, 0, 0
    ref_params = dict(ref["model"].named_parameters())
    for name, p in kern["model"].named_parameters():
        diff = (p.detach().cpu() - ref_params[name].detach()).abs()
        rows = key_bias_rows(name, diff)
        if rows is not None:
            rows.zero_()
        max_err = max(max_err, diff.max().item())
        far += (diff > TRAIN_PARAM_FRAC * lr_sum).sum().item()
        total += diff.numel()
    tokens = MOE_F32_B * MOE_F32_T * cfg.n_layers
    print(f"moe f32 (22a) card vs CPU, TF32 off: router probabilities at "
          f"most {prob_err:.3e} apart (tolerance {MOE_PROB_TOL}); {parted} "
          f"of {tokens} token-layers route differently, the widest "
          f"competing gap {widest:.3e} (near-tie limit {MOE_ROUTE_TIE}); "
          f"TF32 control {control:.3e} ({tf32_parted} routes differ); "
          f"losses card {kern['losses']} CPU {ref['losses']} (max diff "
          f"{loss_err:.3e}), aux card {kern['auxes']} CPU {ref['auxes']} "
          f"(max diff {aux_err:.3e}; tolerance {MOE_LOSS_TOL}); weights max "
          f"diff {max_err:.3e} (tolerance {ADAM_BOUND * lr_sum:.3e}), {far} "
          f"of {total} beyond {TRAIN_PARAM_FRAC * lr_sum:.3e}; counts "
          f"{kern['counts']}", flush=True)
    if not (prob_err <= MOE_PROB_TOL and widest <= MOE_ROUTE_TIE):
        raise AssertionError("moe f32: the card's routes part from the CPU's")
    if not control > MOE_PROB_TOL:
        raise AssertionError("moe f32: the TF32 control reads within the "
                             "tolerance")
    if not (loss_err <= MOE_LOSS_TOL and aux_err <= MOE_LOSS_TOL
            and max_err <= ADAM_BOUND * lr_sum
            and far <= TRAIN_FAR_SHARE * total):
        raise AssertionError("moe f32: card and CPU steps disagree")
    want = cfg.n_layers * MOE_F32_STEPS
    if tuple(kern["counts"].values()) != (want,) * 3:
        raise AssertionError(f"moe f32 counts {kern['counts']}, want {want}")
    return kern["counts"]


def moe_flops_per_token(cfg, n_params: int, t: int) -> tuple[float, float]:
    """Training flops a token of an MoE LM (forward and backward, 3 x the
    forward's 2 per multiply-add): bench.py's 6 N + 6 L d T over the
    parameters outside the experts, plus each MoE layer's expert products
    as computed (E x C slots a group of S tokens: (E C / S) x 2 d f
    multiply-adds a token, C = ceil(cf k S / E)); and, second, JAX's
    dispatch and combine einsums (2 x E C d multiply-adds a token a layer),
    which the port does as copies. -> (flops without, with them)."""
    from tf_operator_tpu_torch.models.moe import MoeConfig, _group_size

    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    n_moe = sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    s = _group_size(MoeConfig(n_experts=e, d_model=d, d_ff=f), t)
    c = max(1, math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * s / e))
    dense = n_params - n_moe * e * 2 * d * f
    base = (6 * dense + 6 * cfg.n_layers * d * t
            + n_moe * 6 * (e * c / s) * 2 * d * f)
    return base, base + n_moe * 6 * 2 * e * c * d


def moe_bench_phase(card: str) -> dict:
    """Phase 22 (b): the bf16 MoE trainer at bench.py's LM width; returns
    its flash launches."""
    from tf_operator_tpu_torch.models import moe
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.train.steps import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM, **MOE_BENCH)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    batch = {name: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T)).astype(np.int64)).cuda()
        for name in ("tokens", "targets")}
    first, last, route = {}, {}, moe.MoeMlp.route

    def record(self, x, group=None):
        out = route(self, x, group)
        # Each layer's first and last routes; no host sync in the loop.
        first.setdefault(id(self), out)
        last[id(self)] = out
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(moe.MoeMlp, "route", record):
        run = train_run(cfg, params, batch, BF16_STEPS, adamw(1e-4),
                        profile=True, xent_chunk=XENT_CHUNK,
                        xent_dot_dtype=torch.bfloat16,
                        aux_loss_weight=MOE_AUX_WEIGHT)
    del params
    losses, auxes, counts = run["losses"], run["auxes"], run["counts"]
    e = cfg.moe_experts

    def layer_stats(routes):
        """Each MoE layer's (dropped share of assignments, aux)."""
        out = []
        for idx, _, probs, cap in routes.values():
            first_oh = torch.nn.functional.one_hot(idx[..., 0], e).float()
            aux = e * (first_oh.mean((0, 1)) * probs.mean((0, 1))).sum()
            kept = moe._positions(idx, e, cap)[1].float().mean()
            out.append((round(1 - kept.item(), 6), round(aux.item(), 6)))
        return out

    at_first, at_last = layer_stats(first), layer_stats(last)
    want = cfg.n_layers * BF16_STEPS
    if (counts["fwd"], counts["dq"], counts["dkv"]) != (want,) * 3:
        raise AssertionError(f"moe bf16 trainer counts {counts}, want "
                             f"{want} of each kernel")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe bf16 trainer losses {losses}")
    # The aux the step reports is the MoE layers' sum; each layer's lies in
    # (0, E], at E when one expert takes every token and all the mass.
    if not all(0 < a <= e + 1 for _, a in at_first + at_last):
        raise AssertionError(f"moe bf16 trainer layer aux {at_first} "
                             f"{at_last}")
    n_params = sum(p.numel() for p in run["model"].parameters())
    step_s = sum(run["seconds"]) / len(run["seconds"])
    tok_s = TRAIN_B * TRAIN_T / step_s
    flops, flops_einsums = moe_flops_per_token(cfg, n_params, TRAIN_T)
    mfu = tok_s * flops / PEAK_FLOPS[torch.bfloat16]
    mfu_einsums = tok_s * flops_einsums / PEAK_FLOPS[torch.bfloat16]
    print(f"moe trainer bf16 (22b) B={TRAIN_B} T={TRAIN_T} ({n_params} "
          f"params; every {cfg.moe_every_n}nd block {cfg.moe_experts} "
          f"experts top-{cfg.moe_top_k} capacity "
          f"{cfg.moe_capacity_factor}): losses {losses}; aux (the layers' "
          f"sum) {auxes}; "
          f"step_s {run['seconds']} mean {step_s:.6f} (median "
          f"{float(np.median(run['seconds'])):.6f}) tokens/s {tok_s:.2f} MFU "
          f"{mfu:.6f} ({flops:.6e} flops a token: 6 N_dense + 6 L d T + "
          f"the expert products as computed; {mfu_einsums:.6f} with JAX's "
          f"dispatch and combine einsums, {flops_einsums:.6e}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; by MoE layer "
          f"(dropped share of assignments, aux) at the first step "
          f"{at_first} and the profiled one {at_last}; counts {counts} on "
          f"{card}", flush=True)
    launches = dict(flash_fwd=counts["fwd"], flash_dq=counts["dq"],
                    flash_dkv=counts["dkv"])
    del run
    torch.cuda.empty_cache()
    return launches


def moe_int8_phase(pa, base, prompts) -> dict:
    """Phase 22 (c): phase 12's lockstep (kernels against plain versions,
    teacher-forced) over an MoE tree quantized for int8 + kv8; returns the
    kernel engine's launches."""
    from tf_operator_tpu_torch.models.convert import (
        init_params,
        quantize_decode_params,
    )

    cfg = replace(base, int8_decode=True, kv_int8=True, **MOE_BENCH)
    qparams = quantize_decode_params(init_params(cfg, seed=0))
    leaf = qparams["block_1"]["moe"]["w_in"]
    if leaf.dtype != np.float32 or leaf.shape != (
            cfg.moe_experts, cfg.d_model, cfg.d_ff):
        raise AssertionError(f"moe leaves were quantized: {leaf.dtype}")
    kern = lockstep_phase(pa, cfg, qparams, prompts)
    n_moe = sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    # q, kv and out in every layer, in_proj and out_proj in the dense ones,
    # and the head: the MoE blocks' experts stay in f32.
    calls = 3 * cfg.n_layers + 2 * (cfg.n_layers - n_moe) + 1
    want = dict(paged_attend=0,
                paged_attend_kv8=cfg.n_layers * kern["forwards"],
                int8_matmul=calls * (kern["forwards"] + kern["prefills"]),
                int8_wgmma=0)
    if kern["launches"] != want:
        raise AssertionError(f"moe int8 + kv8 launches {kern['launches']}, "
                             f"want {want}")
    del qparams
    torch.cuda.empty_cache()
    got = kern["launches"]
    return dict(paged_attend_kv8=got["paged_attend_kv8"],
                int8_matmul=got["int8_matmul"] - got["int8_wgmma"])


def moe_entry_phase() -> dict:
    """Phase 22 (d): the entry point with the MoE flags on the card, no
    --device; returns the flash launches it prints."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_lm",
         *MOE_ENTRY_ARGS], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    out = done.stdout
    counts = re.search(r"flash launches fwd=(\d+) dq=(\d+) dkv=(\d+)", out)
    final = [ln for ln in out.splitlines() if "final loss" in ln]
    print(f"moe entry point (22d) {' '.join(MOE_ENTRY_ARGS)}: rc "
          f"{done.returncode}; {final[-1] if final else 'no final loss'}; "
          f"{counts.group(0) if counts else 'no launch line'} (beside 21 (d))",
          flush=True)
    if done.returncode != 0 or "dist_lm: OK" not in out or counts is None:
        raise AssertionError(f"moe entry point: {out[-2000:]}"
                             f"{done.stderr[-2000:]}")
    got = dict(flash_fwd=int(counts.group(1)), flash_dq=int(counts.group(2)),
               flash_dkv=int(counts.group(3)))
    if not all(got.values()):
        raise AssertionError(f"moe entry point ran no kernel: {got}")
    return got


def moe_phase(pa, base, prompts, card: str) -> dict:
    """Phase 22, (a) to (d), with phase 21 (d) (the MNIST job, processes
    of its own) in a thread beside (c) and (d), which time nothing against
    another run: each path's launches by kernel."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    out = {"moe trainer f32 (22a)": moe_check_phase()}
    torch.cuda.empty_cache()
    out["moe trainer bf16 (22b)"] = moe_bench_phase(card)
    with ThreadPoolExecutor(1) as pool:
        mnist = pool.submit(mnist_entry_phase, card)
        out["moe int8 engine f32 (22c)"] = moe_int8_phase(pa, base, prompts)
        out["moe entry point f32 (22d)"] = moe_entry_phase()
        mnist.result()
    print(f"phase 22 (Mixture-of-Experts): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def host_input_phase(path: str, rec_bytes: int, record: int) -> None:
    """Phase 23 (a): build the two C++ sources, hold the engines and the
    two image paths bitwise, and time the host loader at bench.py's
    shapes."""
    from tf_operator_tpu_torch.native import load_library
    from tf_operator_tpu_torch.native.augment import (
        augment_gather,
        augment_records,
    )
    from tf_operator_tpu_torch.native.pipeline import (
        MMapRecordPipeline,
        RecordPipeline,
        write_records,
    )
    from tf_operator_tpu_torch.train.data import record_dataset

    t0 = time.perf_counter()
    for source in ("record_pipeline.cc", "augment.cc"):
        load_library(source)
    print(f"record input (23a): g++ build of record_pipeline.cc and "
          f"augment.cc {time.perf_counter() - t0:.2f} s; host "
          f"os.cpu_count() {os.cpu_count()}", flush=True)

    names = {"native": "NativeEngine", "python": "PythonEngine"}
    per_shard = CHECK_RECORDS // 2
    count = 2 * -(-per_shard // 4)  # two epochs of batches of 4
    with tempfile.TemporaryDirectory() as tmp:
        small = os.path.join(tmp, "small.bin")
        rows = np.random.default_rng(2).integers(
            0, 256, (CHECK_RECORDS, CHECK_RECORD_BYTES), dtype=np.uint8)
        write_records(small, rows)
        for shard in range(2):
            got = {}
            for engine in names:
                with RecordPipeline(small, CHECK_RECORD_BYTES, 4, seed=7,
                                    loop=True, engine=engine,
                                    shard_id=shard, num_shards=2) as pipe:
                    if pipe.engine_name != names[engine]:
                        raise AssertionError(f"{engine}: {pipe.engine_name}")
                    it = iter(pipe)
                    got[engine] = [next(it) for _ in range(count)]
            for i, (a, b) in enumerate(zip(got["native"], got["python"])):
                if not np.array_equal(a, b):
                    raise AssertionError(f"shard {shard}/2 batch {i}: the "
                                         f"native and Python engines differ")
    print(f"record input (23a): native == Python engine bitwise, {count} "
          f"batches (two looping epochs, each ending on "
          f"{per_shard % 4} rows) of each of 2 shards of {CHECK_RECORDS} "
          f"records", flush=True)

    image_shape, crop = (record, record, 3), (RESNET_HW, RESNET_HW)
    stream = record_dataset(path, image_shape, np.uint8, RESNET_B,
                            label_dtype=np.uint8, seed=STREAM_SEED,
                            engine="native", crop_hw=crop,
                            threads=STREAM_THREADS)
    pipe = MMapRecordPipeline(path, rec_bytes, RESNET_B, seed=STREAM_SEED,
                              loop=True)
    index0 = 0
    try:
        for i in range(LOADER_CHECK_BATCHES):
            want = next(stream)
            idx = pipe.next_indices()
            got = augment_gather(pipe.data, idx, rec_bytes, image_shape,
                                 crop, seed=STREAM_SEED, index0=index0,
                                 threads=STREAM_THREADS, engine="native")
            index0 += len(idx)
            if not (np.array_equal(got, want["image"]) and np.array_equal(
                    pipe.labels(idx).astype(np.uint8), want["label"])):
                raise AssertionError(f"batch {i}: mmap + augment_gather "
                                     "differs from record_dataset")
    finally:
        stream.close()
        pipe.close()
    print(f"record input (23a): mmap + augment_gather == record_dataset("
          f"engine='native', crop_hw={crop}) bitwise over "
          f"{LOADER_CHECK_BATCHES} batches of {RESNET_B}", flush=True)

    def batch_of(next_batch, take):
        got = next_batch()
        while len(got) < RESNET_B:  # an epoch's short last batch
            got = take(got, next_batch())
        return got

    out = np.empty((RESNET_B, RESNET_HW, RESNET_HW, 3), np.uint8)
    pipe = MMapRecordPipeline(path, rec_bytes, RESNET_B, seed=STREAM_SEED,
                              loop=True)
    pipe.next_indices()  # warm
    t0 = time.perf_counter()
    for i in range(LOADER_BATCHES):
        idx = batch_of(pipe.next_indices, lambda a, b: np.concatenate(
            [a, b])[:RESNET_B])
        augment_gather(pipe.data, idx, rec_bytes, image_shape, crop,
                       seed=STREAM_AUGMENT_SEED, index0=i * RESNET_B,
                       threads=STREAM_THREADS, engine="native", out=out)
        pipe.labels(idx)
    mmap_s = LOADER_BATCHES * RESNET_B / (time.perf_counter() - t0)
    pipe.close()
    with RecordPipeline(path, rec_bytes, RESNET_B, prefetch=8, threads=4,
                        seed=STREAM_SEED, loop=True,
                        engine="native") as ring:
        if ring.engine_name != "NativeEngine":
            raise AssertionError(f"pread ring: {ring.engine_name}")
        it = iter(ring)
        next(it)  # warm
        t0 = time.perf_counter()
        for i in range(LOADER_BATCHES):
            raw = batch_of(lambda: next(it), lambda a, b: np.concatenate(
                [a, b])[:RESNET_B])
            augment_records(raw, image_shape, crop,
                            seed=STREAM_AUGMENT_SEED, index0=i * RESNET_B,
                            threads=STREAM_THREADS, engine="native")
        pread_s = LOADER_BATCHES * RESNET_B / (time.perf_counter() - t0)
    print(f"record input (23a): host loader images/s, {LOADER_BATCHES} "
          f"batches of {RESNET_B} {record}^2 records -> {RESNET_HW}^2 crops, "
          f"threads {STREAM_THREADS}: mmap + augment_gather {mmap_s:.2f}, "
          f"pread ring + augment_records {pread_s:.2f}; host os.cpu_count() "
          f"{os.cpu_count()}", flush=True)


def streamed_resnet_phase(card: str, path: str, rec_bytes: int,
                          record: int, resident: float) -> None:
    """Phase 23 (b): bf16 ResNet-50 (conv7) fed from the record file as
    bench.py's bench_resnet feeds it. Each call trains RESNET_STEPS steps
    from one card buffer while a worker thread fills the other pinned host
    buffer (fill_stacked: the C++ crop releases the GIL; the host thread
    meanwhile enqueues the eager steps, where JAX's one fused call returns
    at once) and a side stream copies it to the other card buffer once
    the steps that read it are done; the steps wait on the copy's event.
    Images/s and MFU of RESNET_CALLS timed calls after a warm one, beside
    phase 21 (b)'s resident reading; the copy's time; one profiled
    streamed step; the first batch on the card against the CPU's Python
    engine, bitwise."""
    from concurrent.futures import ThreadPoolExecutor

    from tf_operator_tpu_torch.models.convert import (
        init_variables,
        load_variables,
    )
    from tf_operator_tpu_torch.models.resnet import resnet50
    from tf_operator_tpu_torch.native.augment import augment_gather
    from tf_operator_tpu_torch.native.pipeline import MMapRecordPipeline
    from tf_operator_tpu_torch.train.data import fill_stacked
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        make_classifier_train_step,
        sgd_momentum,
    )

    image_shape = (record, record, 3)
    shape = (RESNET_STEPS, RESNET_B, RESNET_HW, RESNET_HW, 3)
    host = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    host_labels = [torch.empty(shape[:2], dtype=torch.int32,
                               pin_memory=True) for _ in range(2)]
    card_images = [torch.empty(shape, dtype=torch.uint8, device="cuda")
                   for _ in range(2)]
    card_labels = [torch.empty(shape[:2], dtype=torch.int32, device="cuda")
                   for _ in range(2)]
    side = torch.cuda.Stream()
    copied = [torch.cuda.Event() for _ in range(2)]
    used = [torch.cuda.Event() for _ in range(2)]
    pipe = MMapRecordPipeline(path, rec_bytes, RESNET_B, seed=STREAM_SEED,
                              loop=True)
    counter = [0]

    def fill(k):
        counter[0] = fill_stacked(
            pipe, image_shape, host[k].numpy(), host_labels[k].numpy(),
            seed=STREAM_AUGMENT_SEED, index0=counter[0],
            threads=STREAM_THREADS)

    def put(k):
        # Host buffer k to card buffer k on the side stream, once the
        # steps that read card buffer k have run.
        side.wait_event(used[k])
        with torch.cuda.stream(side):
            card_images[k].copy_(host[k], non_blocking=True)
            card_labels[k].copy_(host_labels[k], non_blocking=True)
        copied[k].record(side)

    def normalise(images):
        return (images.to(torch.bfloat16) - 127.5) / 127.5

    model = resnet50(stem="conv7")
    load_variables(model, init_variables(model, 0))
    tx = sgd_momentum(0.1)
    state = TrainState.create(model, tx)
    step = make_classifier_train_step(model, tx)
    pool = ThreadPoolExecutor(max_workers=1)

    def call(state, k):
        nxt = 1 - k
        copied[nxt].synchronize()  # host buffer nxt's last copy is done
        filling = pool.submit(fill, nxt)
        torch.cuda.current_stream().wait_event(copied[k])
        metrics = None
        for s in range(RESNET_STEPS):
            state, metrics = step(state, {
                "image": normalise(card_images[k][s]),
                "label": card_labels[k][s]})
        used[k].record()
        filling.result()
        put(nxt)
        return state, metrics

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        fill(0)
        put(0)
        torch.cuda.synchronize()
        # The first batch on the card against the CPU's Python engine over
        # the same indices (a fresh pipeline of the same seed).
        ref = MMapRecordPipeline(path, rec_bytes, RESNET_B,
                                 seed=STREAM_SEED, loop=True)
        idx = ref.next_indices()
        want = augment_gather(ref.data, idx, rec_bytes, image_shape,
                              (RESNET_HW, RESNET_HW),
                              seed=STREAM_AUGMENT_SEED, index0=0,
                              engine="python")
        want_labels = ref.labels(idx) % 1000
        ref.close()
        first = card_images[0][0]
        same_bytes = torch.equal(first.cpu(), torch.from_numpy(want))
        same_norm = torch.equal(normalise(first).cpu(),
                                normalise(torch.from_numpy(want)))
        same_labels = torch.equal(card_labels[0][0].cpu(),
                                  torch.from_numpy(want_labels))
        print(f"streamed resnet50 (23b): the first batch on the card against "
              f"the CPU's Python augment_gather of the same indices: uint8 "
              f"{'bitwise' if same_bytes else 'DIFFERENT'}, normalised bf16 "
              f"{'bitwise' if same_norm else 'DIFFERENT'}, labels "
              f"{'equal' if same_labels else 'DIFFERENT'}", flush=True)
        if not (same_bytes and same_norm and same_labels):
            raise AssertionError("the streamed first batch is not the CPU's")

        t0 = time.perf_counter()
        state, metrics = call(state, 0)
        warm_loss = float(metrics["loss"])
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RESNET_CALLS):
            state, metrics = call(state, (i + 1) % 2)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if not (math.isfinite(loss) and math.isfinite(warm_loss)):
            raise AssertionError(f"streamed resnet50: loss {loss}")
        images_n = RESNET_B * RESNET_STEPS * RESNET_CALLS
        img_s = images_n / dt
        mfu = (3 * RESNET_FWD_FLOPS * images_n / dt
               / PEAK_FLOPS[torch.bfloat16])
        torch.cuda.synchronize()

        def copy_ms(src, dst):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                dst.copy_(src, non_blocking=True)
                end.record(side)
            end.synchronize()
            return start.elapsed_time(end)

        call_ms = copy_ms(host[0], card_images[0])
        step_ms = copy_ms(host[0][0], card_images[0][0])
        print(f"streamed resnet50 (23b): pinned host -> card copy, on an idle "
              f"card: a call's {host[0].numel()} bytes {call_ms:.4f} ms "
              f"({host[0].numel() / call_ms / 1e6:.2f} GB/s), a step's "
              f"{host[0][0].numel()} bytes {step_ms:.4f} ms "
              f"({host[0][0].numel() / step_ms / 1e6:.2f} GB/s)", flush=True)

        holder = {"state": state}

        def one_step():
            # One streamed step: a step's images copied on the side stream,
            # the step waiting on the copy.
            with torch.cuda.stream(side):
                card_images[0][0].copy_(host[0][0], non_blocking=True)
            copied[0].record(side)
            torch.cuda.current_stream().wait_event(copied[0])
            holder["state"], _ = step(holder["state"], {
                "image": normalise(card_images[0][0]),
                "label": card_labels[0][0]})

        one_step()
        profile_steps(one_step, 1, f"streamed resnet50 conv7 bf16 step "
                                   f"(B={RESNET_B}, its batch copied from "
                                   f"pinned memory)")
        print(f"streamed resnet50 bf16 (23b) stem conv7: B={RESNET_B} "
              f"{RESNET_HW}^2 crops streamed from {RESNET_RECORDS} "
              f"{record}^2 records (mmap + augment_gather, threads "
              f"{STREAM_THREADS}, pinned double buffer, side-stream copy), "
              f"{RESNET_CALLS} calls x {RESNET_STEPS} steps in {dt:.4f} s: "
              f"images/s {img_s:.2f}, step_s "
              f"{dt / RESNET_STEPS / RESNET_CALLS:.6f}, MFU {mfu:.6f} "
              f"(bench.py's count, 3 x 4.09e9 flops an image, at 989 "
              f"TFLOP/s); phase 21 (b)'s resident conv7 in this run: images/s "
              f"{resident:.2f} (streamed/resident {img_s / resident:.4f}); "
              f"warm call {warm_s:.2f} s (loss {warm_loss:.4f}), final loss "
              f"{loss:.4f}; host os.cpu_count() {os.cpu_count()}; on {card}",
              flush=True)
    finally:
        torch.backends.cudnn.benchmark = benchmark
        pool.shutdown(wait=True)
        pipe.close()


def embedding_backward_check(ids: np.ndarray, d_model: int,
                             vocab: int) -> None:
    """Phase 23 (c), first: the model's ``Embed`` backward over a step's
    ids (the corpus's first rows) EMBED_REPEATS times from one gradient,
    bitwise each time; ``F.embedding``'s CUDA backward over the same ids
    beside it, the control ROADMAP C2 names (printed: its summation order
    may or may not differ in a given call)."""
    from tf_operator_tpu_torch.models.transformer import Embed, _Store

    torch.manual_seed(0)
    ids = torch.from_numpy(ids).cuda()
    grad = torch.randn(*ids.shape, d_model, device="cuda")
    embed = Embed(vocab, d_model, torch.float32,
                  _Store(torch.float32, False, torch.device("cuda")))
    with torch.no_grad():
        embed.weight.normal_()
    ours, control = set(), set()
    for _ in range(EMBED_REPEATS):
        embed.weight.grad = None
        embed(ids).backward(grad)
        ours.add(embed.weight.grad.cpu().numpy().tobytes())
        weight = embed.weight.detach().clone().requires_grad_(True)
        torch.nn.functional.embedding(ids, weight).backward(grad)
        control.add(weight.grad.cpu().numpy().tobytes())
    print(f"dist_lm --data (23c): Embed's backward over {ids.numel()} ids "
          f"of {vocab}, {EMBED_REPEATS} times: {len(ours)} distinct "
          f"result(s); F.embedding's CUDA backward (control): "
          f"{len(control)} distinct", flush=True)
    if len(ours) != 1:
        raise AssertionError("Embed's backward is not deterministic")


def data_entry_phase(card: str) -> dict:
    """Phase 23 (c): ``python -m tf_operator_tpu_torch.train.dist_lm
    --data`` on the card with no --device. Run 1 stops at DATA_FAIL_AT
    (exit 138), run 2 resumes to OK, run 3 (beside run 1) trains
    uninterrupted; the final checkpoints must be bitwise. Returns the
    flash launches the runs print."""
    from tf_operator_tpu_torch.ckpt import protocol
    from tf_operator_tpu_torch.models.convert import _leaves
    from tf_operator_tpu_torch.train import checkpoint
    from tf_operator_tpu_torch.train.data import write_token_records

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in (
        protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
        protocol.ENV_RESUME_STEP)}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    seq = int(DATA_ARGS[DATA_ARGS.index("--seq") + 1])
    vocab = int(DATA_ARGS[DATA_ARGS.index("--vocab") + 1])
    t_start = time.perf_counter()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.bin")
        start = np.random.default_rng(0).integers(0, vocab, (DATA_ROWS, 1))
        rows = ((start + np.arange(seq + 1)) % vocab).astype(np.int32)
        write_token_records(corpus, rows)
        batch = int(DATA_ARGS[DATA_ARGS.index("--batch") + 1])
        embedding_backward_check(
            rows[:batch, :-1],
            int(DATA_ARGS[DATA_ARGS.index("--d-model") + 1]), vocab)
        cmd = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_lm",
               *DATA_ARGS, "--data", corpus]
        dirs = {i: os.path.join(tmp, f"ck{i}") for i in (1, 3)}
        dirs[2] = dirs[1]
        logs = {i: os.path.join(tmp, f"run{i}.log") for i in (1, 2, 3)}

        def start_run(i):
            args = ["--checkpoint-dir", dirs[i]]
            if i != 3:
                args += ["--fail-at-step", str(DATA_FAIL_AT)]
            with open(logs[i], "w") as out:
                proc = subprocess.Popen(cmd + args, cwd=root, env=env,
                                        stdout=out, stderr=subprocess.STDOUT)
            procs.append(proc)
            return proc

        def log(i):
            with open(logs[i]) as f:
                return f.read()

        try:
            first, third = start_run(1), start_run(3)
            rc1, rc3 = first.wait(timeout=300), third.wait(timeout=300)
            rc2 = start_run(2).wait(timeout=300)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if rc1 != 138 or (f"simulating preemption at step {DATA_FAIL_AT}"
                          not in log(1)):
            raise AssertionError(f"--data run 1: rc {rc1}: {log(1)[-3000:]}")
        if rc2 != 0 or (f"dist_lm: resumed from step {DATA_FAIL_AT + 1}"
                        not in log(2) or "dist_lm: OK" not in log(2)):
            raise AssertionError(f"--data run 2: rc {rc2}: {log(2)[-3000:]}")
        if rc3 != 0 or "dist_lm: OK" not in log(3):
            raise AssertionError(f"--data run 3: rc {rc3}: {log(3)[-3000:]}")
        engines = [re.search(r"through the (\S+) record engine",
                             log(i)) for i in (1, 2, 3)]
        engines = [m.group(1) if m else None for m in engines]
        if engines != ["native"] * 3:
            raise AssertionError(f"--data runs 1-3 read through the "
                                 f"{engines} record engines, not native")
        last = checkpoint.latest_step(dirs[1])
        a = dict(_leaves(checkpoint.read(dirs[1], last)[0]))
        b = dict(_leaves(checkpoint.read(dirs[3], last)[0]))
        launches, idle = dict.fromkeys(FLASH_KERNELS, 0), []
        for i in (1, 2, 3):
            counts = re.findall(r"flash launches fwd=(\d+) dq=(\d+) "
                                r"dkv=(\d+)", log(i))
            if not counts or not all(int(n) for n in counts[-1]):
                idle.append(i)
            for key, n in zip(FLASH_KERNELS, counts[-1] if counts else ()):
                launches[key] += int(n)
        losses = [re.search(r"final loss (\S+)", log(i)).group(1)
                  for i in (2, 3)]
    bitwise = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                           for k in a)
    print(f"dist_lm --data (23c) {' '.join(DATA_ARGS)} over {DATA_ROWS} "
          f"token records ({DATA_ROWS * (seq + 1) * 4} bytes) through the "
          f"native record engine: run 1 exited "
          f"{rc1} at step {DATA_FAIL_AT}, run 2 resumed from step "
          f"{DATA_FAIL_AT + 1} and exited {rc2}, run 3 exited {rc3}; the "
          f"final checkpoint (step {last}) against run 3's: "
          f"{'bitwise' if bitwise else 'NOT bitwise'} ({len(a)} tensors); "
          f"final losses {losses[0]} / {losses[1]}; launches {launches}; "
          f"{time.perf_counter() - t_start:.1f} s on {card}", flush=True)
    if not bitwise:
        raise AssertionError("the resumed --data run parts from the "
                             "uninterrupted one")
    if idle:
        raise AssertionError(f"--data runs {idle} ran no kernel")
    return launches


def record_input_phase(card: str, resident: float) -> dict:
    """Phase 23, (a) to (c); returns (c)'s flash launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "records.bin")
        record, rec_bytes = write_bench_records(path)
        host_input_phase(path, rec_bytes, record)
        streamed_resnet_phase(card, path, rec_bytes, record, resident)
    torch.cuda.empty_cache()
    launches = data_entry_phase(card)
    print(f"phase 23 (the record input): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def dp_nccl_phase(card: str) -> dict:
    """Phase 24 (a): phase 9's bf16 step with and without a ``{"dp": 1}``
    mesh over an NCCL world of 1 in this process, from one tree and batch,
    in turns (without, with, with, without): every run's losses and
    weights bitwise the first's. Returns the mesh runs' flash
    launches."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train.steps import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    batch = {name: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T)).astype(np.int64)).cuda()
        for name in ("tokens", "targets")}
    kw = dict(xent_chunk=XENT_CHUNK, xent_dot_dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    first, differ = None, []
    seconds = {"plain": [], "dp": []}
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    losses = {}
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        mesh = create_mesh({"dp": 1}, device="cuda")
        for i, side in enumerate(("plain", "dp", "dp", "plain")):
            run = train_run(cfg, params, batch, DP_STEPS, adamw(1e-4),
                            **kw, **({"mesh": mesh} if side == "dp"
                                     else {}))
            weights = {n: p.detach() for n, p
                       in run.pop("model").named_parameters()}
            if first is None:
                first = {"losses": run["losses"], "weights": {
                    n: w.clone() for n, w in weights.items()}}
            differ += [f"{i} {side} {n}" for n, w in weights.items()
                       if not torch.equal(w, first["weights"][n])]
            losses.setdefault(side, run["losses"])
            if run["losses"] != first["losses"]:
                differ.append(f"{i} {side} losses {run['losses']}")
            seconds[side] += run["seconds"]
            if side == "dp":
                for key, n in zip(FLASH_KERNELS, run["counts"].values()):
                    launches[key] += n
            del run, weights
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    tok_s = {side: TRAIN_B * TRAIN_T / float(np.median(sec))
             for side, sec in seconds.items()}
    print(f"dp nccl world 1 (24a): bf16 B={TRAIN_B} T={TRAIN_T}, "
          f"{DP_STEPS} steps a run from one tree, in turns without, with "
          f"{mesh}, with, without: losses {losses['plain']} without, "
          f"{losses['dp']} with; "
          f"{'every run bitwise the first' if not differ else differ[:8]} "
          f"({len(first['weights'])} weights); tokens/s by the median step "
          f"without {tok_s['plain']:.2f}, with {tok_s['dp']:.2f} (ratio "
          f"{tok_s['dp'] / tok_s['plain']:.4f}; step_s {seconds}); "
          f"launches of the mesh runs {launches} on {card}", flush=True)
    if differ:
        raise AssertionError("the dp world of 1 parts from the plain step")
    want = 2 * cfg.n_layers * DP_STEPS
    if set(launches.values()) != {want}:
        raise AssertionError(f"24a launches {launches}, want {want} of each")
    del first
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(module: str, args: list, world: int | None, tmp: str,
                tag: str, procs: list) -> list:
    """``world`` processes of ``python -m module args`` joined by gloo on
    the card (one plain process for ``world`` None), output to files under
    ``tmp``; appends them to ``procs`` and returns their log paths."""
    from tf_operator_tpu_torch.ckpt import protocol

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in (
        protocol.ENV_ACK_FILE, protocol.ENV_CKPT_DIR,
        protocol.ENV_RESUME_STEP, "TF_CONFIG", "TPU_WORKER_ID",
        "TPU_NUM_PROCESSES", "TPU_COORDINATOR_ADDRESS",
        "MEGASCALE_NUM_SLICES")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # One host thread a process, as torchrun sets it: the processes share
    # the host's cores.
    env.setdefault("OMP_NUM_THREADS", "1")
    port = free_port()
    logs = []
    for r in range(world or 1):
        rank_env = dict(env)
        if world:
            rank_env.update(TPU_NUM_PROCESSES=str(world),
                            TPU_WORKER_ID=str(r),
                            TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        log = os.path.join(tmp, f"{tag}{r}.log")
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args, "--dist-backend",
                 "gloo"], cwd=root, env=rank_env, stdout=out,
                stderr=subprocess.STDOUT))
        logs.append(log)
    return logs


def wait_all(procs: list, timeout: float = 300.0) -> list:
    """Each process's exit code, killing those still running at the
    timeout."""
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [proc.returncode for proc in procs]


def read_log(path: str) -> str:
    with open(path) as f:
        return f.read()


def rank_launches(logs: list, label: str) -> dict:
    """B1-B3's launches summed over the runs' last ``flash launches``
    lines; fails for a run that launched none."""
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for log in logs:
        counts = re.findall(r"flash launches fwd=(\d+) dq=(\d+) dkv=(\d+)",
                            read_log(log))
        if not counts or not all(int(n) for n in counts[-1]):
            raise AssertionError(f"{label}: {log} ran no kernel: "
                                 f"{read_log(log)[-2000:]}")
        for key, n in zip(FLASH_KERNELS, counts[-1]):
            launches[key] += int(n)
    return launches


def dp_entry_phase(card: str, beside=None) -> dict:
    """Phase 24 (b): ``dist_lm`` as 2 gloo processes on the card against
    one process, then 2-process ``--data`` killed, resumed and against its
    twin, ``beside()`` called as the ``--data`` runs start (24 (c) runs
    beside them). Returns the 2-process runs' flash launches."""
    from tf_operator_tpu_torch.models.convert import _leaves
    from tf_operator_tpu_torch.train import checkpoint
    from tf_operator_tpu_torch.train.data import write_token_records

    module = "tf_operator_tpu_torch.train.dist_lm"
    procs: list = []
    rank_logs = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # One after the other, so that each run has the card to itself.
            one = start_ranks(module, ENTRY_ARGS, None, tmp, "one", procs)
            codes = wait_all(procs)
            walls = [time.perf_counter() - t0]
            procs.clear()
            two = start_ranks(module, ENTRY_ARGS, 2, tmp, "two", procs)
            codes = wait_all(procs) + codes
            walls.insert(0, time.perf_counter() - t0 - walls[0])
            outs = [read_log(p) for p in two + one]
            if codes != [0, 0, 0] or not all("dist_lm: OK" in o
                                              for o in outs):
                raise AssertionError(f"24b entry: rc {codes}: "
                                     + "\n".join(o[-2000:] for o in outs))
            losses = [re.findall(r"step (\d+) loss=(\S+)", o)
                      + re.findall(r"(final) loss (\S+)", o) for o in outs]
            if losses[0] != losses[1]:
                raise AssertionError(f"the 2 ranks print other losses: "
                                     f"{losses[:2]}")
            worst = max(abs(float(a[1]) - float(b[1]))
                        for a, b in zip(losses[0], losses[2]))
            rates = [re.search(r"\((\d+) tokens/s", o).group(1)
                     for o in outs[1:]]
            print(f"dist_lm 2 ranks (24b): {' '.join(ENTRY_ARGS)} as 2 gloo "
                  f"processes on one card: printed losses {losses[0]}; one "
                  f"process {losses[2]}; largest difference {worst:.2e} "
                  f"(tolerance {DP_LOSS_TOL}); tokens/s 2 ranks "
                  f"{rates[0]}, 1 process {rates[1]} (ratio "
                  f"{int(rates[0]) / int(rates[1]):.4f}); wall 2 ranks "
                  f"{walls[0]:.1f} s, 1 process {walls[1]:.1f} s (each run "
                  f"alone on the card) on {card}", flush=True)
            if len(losses[0]) != len(losses[2]) or not worst <= DP_LOSS_TOL:
                raise AssertionError("2 ranks part from one process")
            rank_logs += two

            corpus = os.path.join(tmp, "corpus.bin")
            seq = int(DATA_ARGS[DATA_ARGS.index("--seq") + 1])
            vocab = int(DATA_ARGS[DATA_ARGS.index("--vocab") + 1])
            start = np.random.default_rng(0).integers(0, vocab,
                                                      (DATA_ROWS, 1))
            write_token_records(corpus, ((start + np.arange(seq + 1))
                                         % vocab).astype(np.int32))
            data_args = with_flags(DATA_ARGS, steps=DP_DATA_STEPS)
            data = [*data_args, "--data", corpus]
            ck, twin = os.path.join(tmp, "ck"), os.path.join(tmp, "twin")
            if beside is not None:
                beside()
            t1 = time.perf_counter()
            procs.clear()
            first = start_ranks(module, data + [
                "--checkpoint-dir", ck, "--fail-at-step",
                str(DP_DATA_FAIL_AT)], 2, tmp, "first", procs)
            third = start_ranks(module, data + ["--checkpoint-dir", twin], 2,
                                tmp, "twin", procs)
            codes = wait_all(procs)
            procs.clear()
            second = start_ranks(module, data + [
                "--checkpoint-dir", ck, "--fail-at-step",
                str(DP_DATA_FAIL_AT)], 2, tmp, "second", procs)
            codes += wait_all(procs)
            data_wall = time.perf_counter() - t1
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outs = {name: [read_log(p) for p in logs] for name, logs in
                (("first", first), ("twin", third), ("second", second))}
        if codes != [138, 138, 0, 0, 0, 0] or not all(
                f"simulating preemption at step {DP_DATA_FAIL_AT}" in o
                for o in outs["first"]) or not all(
                f"dist_lm: resumed from step {DP_DATA_FAIL_AT + 1}" in o
                and "dist_lm: OK" in o for o in outs["second"]):
            raise AssertionError(f"24b --data: rc {codes}: " + "\n".join(
                o[-2000:] for v in outs.values() for o in v))
        last = checkpoint.latest_step(ck)
        a = dict(_leaves(checkpoint.read(ck, last)[0]))
        b = dict(_leaves(checkpoint.read(twin, last)[0]))
        bitwise = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                               for k in a)
        final = {name: [re.search(r"final loss (\S+)", o).group(1)
                        for o in v] for name, v in outs.items()
                 if name != "first"}
        rank_logs += first + third + second
        launches = rank_launches(rank_logs, "24b")
    print(f"dist_lm --data 2 ranks (24b): {' '.join(data_args)}: run 1 "
          f"exited {codes[:2]} at step {DP_DATA_FAIL_AT}, run 2 resumed from "
          f"step {DP_DATA_FAIL_AT + 1} and exited {codes[4:]}, the twin "
          f"{codes[2:4]}; the final checkpoint (step {last}) against the "
          f"twin's: {'bitwise' if bitwise else 'NOT bitwise'} ({len(a)} "
          f"tensors); final losses resumed {final['second']} twin "
          f"{final['twin']}; {data_wall:.1f} s; launches of all 2-rank "
          f"runs {launches}; {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    if not bitwise or final["second"] != final["twin"]:
        raise AssertionError("the resumed 2-process run parts from its twin")
    return launches


def dp_mnist_phase(card: str) -> None:
    """Phase 24 (c): ``dist_mnist`` as 2 gloo processes on the card."""
    procs: list = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        logs = start_ranks("tf_operator_tpu_torch.train.dist_mnist",
                           DP_MNIST_ARGS, 2, tmp, "mnist", procs)
        codes = wait_all(procs)
        outs = [read_log(p) for p in logs]
    if codes != [0, 0] or not all(
            o.rstrip().endswith("dist_mnist: OK")
            and f"process {r}/2, 2 global devices" in o
            for r, o in enumerate(outs)):
        raise AssertionError(f"24c: rc {codes}: "
                             + "\n".join(o[-2000:] for o in outs))
    final = [re.search(r"final loss (\S+)", o).group(1) for o in outs]
    print(f"dist_mnist 2 ranks (24c): {' '.join(DP_MNIST_ARGS)} as 2 gloo "
          f"processes on one card: both OK, final losses {final}; "
          f"{time.perf_counter() - t0:.1f} s (beside 24 (b)'s --data runs) "
          f"on {card}", flush=True)


def dp_phase(card: str) -> dict:
    """Phase 24, (a) to (c); returns {path label: flash launches}."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    nccl = dp_nccl_phase(card)
    with ThreadPoolExecutor(1) as pool:
        mnist: list = []
        # 24 (c) beside (b)'s --data runs, which time nothing against
        # another run: each is process start-up and checkpoint writes.
        entry = dp_entry_phase(card, beside=lambda: mnist.append(
            pool.submit(dp_mnist_phase, card)))
        for done in mnist:
            done.result()
    print(f"phase 24 (data parallelism): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"dp nccl world 1 (24a)": nccl, "dist_lm 2 ranks (24b)": entry}


def tp_nccl_phase(pa, base, params, prompts, card) -> int:
    """Phase 25 (a): phase 7's bf16 engine with ``mesh={"tp": 1}`` over
    an NCCL world of 1 in this process (every device operation a command,
    every all-reduce and gather an NCCL call over one rank) in turns with
    the plain engine: plain, tp, tp, plain, each run's tokens and final
    logits bitwise the first's. Returns the tp runs' B4 launches."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import create_mesh

    cfg = replace(base, dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    first, differ, launches = None, [], 0
    tok_s = {"plain": [], "tp": []}
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        mesh = create_mesh({"tp": 1}, device="cuda")
        for i, side in enumerate(("plain", "tp", "tp", "plain")):
            run = engine_run(pa, cfg, params, "kernel", prompts,
                             mesh=mesh if side == "tp" else None)
            if first is None:
                first = run
            elif not (np.array_equal(run["tokens"], first["tokens"])
                      and torch.equal(run["logits"], first["logits"])):
                differ.append(f"{i} {side}")
            tok_s[side].append(run["decode_tok_s"])
            if side == "tp":
                if run["launches"]["paged_attend"] != (
                        LAYERS * run["forwards"]):
                    raise AssertionError(f"25a launches {run['launches']}")
                launches += run["launches"]["paged_attend"]
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"tp nccl world 1 (25a): phase 7's bf16 engine, in turns plain, "
          f"tp, tp, plain: "
          f"{'every run bitwise the first' if not differ else differ} "
          f"(tokens {first['tokens'].shape} and final logits); decode "
          f"tokens/s plain {tok_s['plain']}, tp {tok_s['tp']}; B4 launches "
          f"of the tp runs {launches} on {card}", flush=True)
    if differ:
        raise AssertionError("the tp world of 1 parts from the plain engine")
    return launches


def tp_parting(model, body, got, other):
    """Where two token runs of one request part: None when identical,
    else (the first parting step, half the gap there between the two
    chosen tokens' values, gumbel + the scaled logits for a sampled
    request, on the single-device run fed ``got``: the least change that
    flips that decision)."""
    got, other = np.asarray(got), np.asarray(other)
    if np.array_equal(got, other):
        return None
    step = int(np.flatnonzero(got != other)[0])
    prompt = torch.as_tensor(np.asarray(body["tokens"]), device=model.device)
    feed = torch.as_tensor(got[None, :], device=model.device)
    values, _ = replay_values(model, prompt, feed,
                              body.get("temperature", 0.0),
                              body.get("top_p"), body.get("seed", 0),
                              len(got))
    row = values[step, 0]
    return step, abs(row[int(got[step])] - row[int(other[step])]).item() / 2


def tp_front_phase(pa, i8, base, params, prompts, card, ref: dict,
                   ahead: dict) -> int:
    """Phase 25 (b): the bf16 front at ``--tp 1`` alone, then at ``--tp 2
    --dist-backend gloo``, phase 15's eight requests each; the tp 2
    tokens equal tp 1's but at a ``BF16_TIE`` near-tie, each rank's pool
    half tp 1's bytes; then one ``step_raise`` replayed across a rebuild
    that reaches the worker. Returns B4's launches over both ranks, and
    fills ``ref`` with what phase 27 holds its run against: tp 1's tokens,
    pool bytes and latency line, tp 2's tokens and latency line. Takes
    ``ahead["25b"]``'s workers and starts (c)'s (``ahead["25c"]``)."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.serve.tp import prestart, report

    cfg = replace(base, dtype=torch.bfloat16)
    bodies = front_requests(prompts)
    supervisor, server, url = open_front(cfg, params)
    one_responses, one_wall = send_all(url, bodies)
    one = latency_line("tp 1 (25b)", one_responses, one_wall)
    one_tokens = [r["tokens"][0] for r in one_responses]
    one_pool = supervisor.engine.pool_bytes()
    server.drain()
    del supervisor, server
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    supervisor, server, url = open_front(cfg, params, tp=TP,
                                         dist_backend="gloo",
                                         spawned=ahead.get("25b"))
    start_s = time.perf_counter() - t0
    try:
        reset_counts(pa, i8)
        before = report(supervisor.engine)
        responses, wall = send_all(url, bodies)
        two = latency_line("tp 2 (25b)", responses, wall)
        # (c)'s worker starts once the timed requests are answered.
        ahead["25c"] = prestart(TP, "cuda", "gloo")
        faults = supervisor.faults
        faults.arm(f"step_raise@"
                   f"{faults.invocations['step_raise'] + TP_FAULT_AT}")
        replay, _ = send_all(url, bodies[:1])
        _, health = http(url, "/healthz")
        rows = report(supervisor.engine)
        staged = [r["staged_bytes"] - b["staged_bytes"]
                  for r, b in zip(rows, before)]
    finally:
        server.drain()
    launches = sum(r["paged_launches"] - b["paged_launches"]
                   for r, b in zip(rows, before))
    pools = [r["pool_bytes"] for r in rows]
    model = _decode_model(cfg, params, None)
    parted = []
    for i, (body, resp, want) in enumerate(zip(bodies, responses,
                                               one_tokens)):
        part = tp_parting(model, body, resp["tokens"][0], want)
        if part is not None:
            parted.append((i, *part))
    replay_part = tp_parting(model, bodies[0], replay[0]["tokens"][0],
                             responses[0]["tokens"][0])
    del model
    torch.cuda.empty_cache()
    ref.update(tokens=one_tokens, pool=one_pool, one=one, two=two,
               tp2_tokens=[r["tokens"][0] for r in responses])
    print(f"serve_lm tp 2 (25b): rank 0 in this process, its worker a "
          f"process on the same card, gloo; world start {start_s:.1f} s; "
          f"pool bytes a rank {pools} (tp 1 {one_pool}); requests/s "
          f"{two['rps']:.4f} (tp 1 {one['rps']:.4f}, ratio "
          f"{two['rps'] / one['rps']:.4f}); TTFT p50/p99 ms "
          f"{two['ttft'][0]:.3f}/{two['ttft'][1]:.3f} (tp 1 "
          f"{one['ttft'][0]:.3f}/{one['ttft'][1]:.3f}); ITL p50/p99 ms "
          f"{two['itl'][0]:.3f}/{two['itl'][1]:.3f} (tp 1 "
          f"{one['itl'][0]:.3f}/{one['itl'][1]:.3f}); requests parting "
          f"from tp 1 (request, first step, margin): {parted} (limit "
          f"{BF16_TIE}); step_raise replay: restarts "
          f"{health.get('watchdog_restarts')}, parting {replay_part}; bytes "
          f"staged through the host by rank {staged}; B4 launches over both "
          f"ranks {launches} on {card}", flush=True)
    if pools != [one_pool // TP] * TP:
        raise AssertionError(f"25b pool bytes {pools}, want {one_pool // TP} "
                             "a rank")
    if any(m > BF16_TIE for *_, m in parted) or (
            replay_part is not None and replay_part[1] > BF16_TIE):
        raise AssertionError("tp 2 parts from tp 1 away from a near-tie")
    if health.get("watchdog_restarts") != 1 or not launches:
        raise AssertionError(f"25b: restarts {health}, launches {launches}")
    return launches


def tp_int8_phase(pa, i8, base, params, prompts, card, ahead: dict) -> dict:
    """Phase 25 (c): the bf16 int8 + kv8 tree at tp 2 (whole on each rank,
    as JAX's; rank 0 here, the worker a process of its own) in lockstep
    with the tp 1 engine on phase 6's schedule, teacher-forced: after
    every prefill and step each live lane's logits within ``LOGIT_TOL``
    of tp 1's, which then takes tp 2's. Returns the tp engine's launches
    over both ranks (rank 0's counted around its own calls)."""
    from tf_operator_tpu_torch.models.convert import quantize_decode_params
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.tp import report, start_world

    cfg = replace(base, dtype=torch.bfloat16, int8_decode=True,
                  kv_int8=True)
    tree = quantize_decode_params(params)
    kw = dict(cfg=cfg, max_slots=len(prompts), kv_block=BLK,
              kv_attend="kernel")
    names = ("paged_attend", "paged_attend_kv8", "int8_matmul",
             "int8_matmul_prefill")
    mine = dict.fromkeys(names, 0)

    def counts():
        return (pa.launches, pa.kv8_launches, i8.launches - i8.wgmma_launches,
                i8.wgmma_launches)

    def counted(fn, *args, **kwargs):
        at = counts()
        out = fn(*args, **kwargs)
        for name, a, b in zip(names, at, counts()):
            mine[name] += b - a
        return out

    t0 = time.perf_counter()
    world = start_world(TP, "cuda", "gloo", kw, tree,
                        spawned=ahead.get("25c"))
    try:
        a = ContinuousEngine(params=tree, device="cuda", mesh=world.mesh,
                             **kw)
        b = ContinuousEngine(params=tree, device="cuda", **kw)
        before = report(a)
        worst, decisions = 0.0, 0

        def compare(slots):
            nonlocal worst, decisions
            gap = (a._logits[slots] - b._logits[slots]).abs().max().item()
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
            decisions += len(slots)
            b._logits = a._logits.clone()

        def join(prompt, steps):
            slot = counted(a.join, prompt, num_steps=steps)
            if b.join(prompt, num_steps=steps) != slot:
                raise AssertionError("25c engines joined other slots")
            compare([slot])

        def step(n):
            for _ in range(n):
                ta = counted(a.step)
                tb = b.step()
                live = np.flatnonzero(a._active)
                if not np.array_equal(ta[live], tb[live]):
                    raise AssertionError("25c teacher-forced tokens differ")
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
        rows = report(a)
        pools = [r["pool_bytes"] for r in rows]
        one_pool = b.pool_bytes()
        kv = a.kv_debug()
    finally:
        world.close()
    worker = {name: sum(r[key] - s[key] for r, s in zip(rows[1:],
                                                         before[1:]))
              for name, key in zip(names, ("paged_launches", "kv8_launches",
                                           "int8_launches",
                                           "int8_wgmma_launches"))}
    worker["int8_matmul"] -= worker["int8_matmul_prefill"]
    launches = {name: mine[name] + worker[name] for name in names}
    print(f"serve_lm tp 2 int8kv8 (25c): bf16 int8 + kv8 at tp 2 against "
          f"tp 1 in lockstep, teacher-forced: {decisions} decisions, logits "
          f"at most {worst:.4e} apart (tolerance {LOGIT_TOL}); pool bytes a "
          f"rank {pools} (tp 1 {one_pool}); kv {kv}; launches rank 0 "
          f"{mine}, worker {worker}; {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    if not worst <= LOGIT_TOL:
        raise AssertionError("25c: tp 2 int8 + kv8 parts from tp 1")
    if pools != [one_pool // TP] * TP:
        raise AssertionError(f"25c pool bytes {pools}")
    if launches["paged_attend"] or not all(
            launches[n] for n in names[1:]):
        raise AssertionError(f"25c launches {launches}")
    return launches


def tp_phase(pa, i8, base, params, prompts, card, ref: dict,
             ahead: dict) -> dict:
    """Phase 25, (a) to (c); returns {kernel: {path label: launches}} and
    fills ``ref`` (25 (b)'s references for phase 27). The serving worlds'
    workers start ahead (``serve/tp.py`` ``prestart``), kept in
    ``ahead`` by the world they are for."""
    from tf_operator_tpu_torch.serve.tp import prestart

    t0 = time.perf_counter()
    # 25 (b)'s worker starts while (a) runs.
    ahead["25b"] = prestart(TP, "cuda", "gloo")
    nccl = tp_nccl_phase(pa, base, params, prompts, card)
    front = tp_front_phase(pa, i8, base, params, prompts, card, ref, ahead)
    int8 = tp_int8_phase(pa, i8, base, params, prompts, card, ahead)
    print(f"phase 25 (tensor-parallel serving): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    label = "serve_lm tp 2 int8kv8 (25c)"
    return {"paged_attend": {"tp nccl world 1 (25a)": nccl,
                             "serve_lm tp 2 (25b)": front},
            **{name: {label: n} for name, n in int8.items()
               if name != "paged_attend"}}


def tpdp_front_phase(pa, i8, base, params, prompts, card, ref: dict,
                     ahead: dict) -> int:
    """Phase 27 (a) and (b): the bf16 front at ``--tp 2 --dp 2
    --dist-backend gloo`` (rank 0 here, three workers on the card), phase
    15's eight requests, held against 25 (b)'s tp 1 front (``ref``):
    tokens but at a ``BF16_TIE`` near-tie, each rank's pool its tile plus
    shard 1's garbage block, both dp shards seated with every table in its
    extent; then one ``step_raise`` replayed across a rebuild that reaches
    every worker. Returns B4's launches over the four ranks."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.sharding import (
        local_pool_blocks,
        shard_of_slot,
    )
    from tf_operator_tpu_torch.serve.tp import prestart, report

    cfg = replace(base, dtype=torch.bfloat16)
    bodies = front_requests(prompts)
    seats = []
    join_slot = ContinuousEngine._join_slot

    def seated(engine, plan, *args, **kwargs):
        # Every seat of a dp engine: its shard, and whether the slot and
        # every block it holds lie in that shard's slice and extent.
        slot = join_slot(engine, plan, *args, **kwargs)
        if slot is not None and engine._dp > 1:
            lo, hi = engine.blocks.shard_extent(plan.dp_shard)
            blocks = list(plan.private_blocks) + list(plan.shared_blocks)
            seats.append((plan.dp_shard, shard_of_slot(
                slot, engine.max_slots, engine._dp) == plan.dp_shard
                and all(lo <= b < hi for b in blocks)))
        return slot

    t0 = time.perf_counter()
    with mock.patch.object(ContinuousEngine, "_join_slot", seated):
        supervisor, server, url = open_front(
            cfg, params, tp=TP, dp=DP, dist_backend="gloo",
            spawned=ahead.get("27"))
        start_s = time.perf_counter() - t0
        try:
            reset_counts(pa, i8)
            engine = supervisor.engine
            before = report(engine)
            responses, wall = send_all(url, bodies)
            four = latency_line("tp 2 x dp 2 (27a)", responses, wall)
            # Phase 28's worker starts once the timed requests are
            # answered.
            ahead["28"] = prestart(TP, "cuda", "gloo")
            kv = engine.kv_debug()
            mid = report(engine)
            faults = supervisor.faults
            faults.arm(f"step_raise@"
                       f"{faults.invocations['step_raise'] + TP_FAULT_AT}")
            replay, _ = send_all(url, bodies[:1])
            _, health = http(url, "/healthz")
            rebuilt = supervisor.engine is not engine
            rows = report(supervisor.engine)
            ship = tpdp_ship_leg(cfg, params, prompts, supervisor, url,
                                 dict(bodies[SHIP_LANE],
                                      num_steps=SHIP_STEPS))
        finally:
            server.drain()
    launches = sum(r["paged_launches"] - b["paged_launches"]
                   for r, b in zip(rows, before))
    # Each worker ran the rebuilt engine's steps: its B4 count moved
    # after the fault.
    reached = [r["paged_launches"] > m["paged_launches"]
               for r, m in zip(rows[1:], mid[1:])]
    staged = [r["staged_bytes"] - b["staged_bytes"]
              for r, b in zip(rows, before)]
    logits = [r["logits_bytes"] for r in mid]
    pools = [r["pool_bytes"] for r in rows]
    # tp 1's pool bytes a block, over TP ranks: each rank's pool is its
    # dp shard's blocks of the pool rounded up to a dp multiple, as JAX.
    one_blocks = len(LANES) * (S // BLK) + 1
    nb = one_blocks + (-one_blocks) % DP
    per_block = ref["pool"] // one_blocks // TP
    want = [per_block * local_pool_blocks(r // TP, nb, DP)
            for r in range(TP * DP)]
    model = _decode_model(cfg, params, None)
    parted = []
    for i, (body, resp, tok) in enumerate(zip(bodies, responses,
                                               ref["tokens"])):
        part = tp_parting(model, body, resp["tokens"][0], tok)
        if part is not None:
            parted.append((i, *part))
    replay_part = tp_parting(model, bodies[0], replay[0]["tokens"][0],
                             responses[0]["tokens"][0])
    ship_part = tp_parting(model, bodies[SHIP_LANE], ship["tokens"],
                           responses[SHIP_LANE]["tokens"][0][:SHIP_STEPS])
    del model
    torch.cuda.empty_cache()
    one, two = ref["one"], ref["two"]
    shards = sorted({s for s, _ in seats})
    as_tp2 = sum(r["tokens"][0] == t for r, t in zip(responses,
                                                      ref["tp2_tokens"]))
    print(f"serve_lm tp 2 x dp 2 (27a): rank 0 in this process, 3 workers "
          f"on the same card, gloo; world start {start_s:.1f} s; seats by "
          f"shard {[sum(1 for s, _ in seats if s == i) for i in range(DP)]}"
          f", every slot and table in its shard's slice and extent: "
          f"{all(ok for _, ok in seats)}; dp_shards {kv.get('dp_shards')}; "
          f"pool bytes a rank {pools} (want {want}: {nb} blocks over dp "
          f"{DP}, the garbage block on shard 1; tp 1 {ref['pool']}, a "
          f"quarter {ref['pool'] // (TP * DP)}); requests/s "
          f"{four['rps']:.4f} (tp 1 {one['rps']:.4f}, tp 2 "
          f"{two['rps']:.4f}); TTFT p50/p99 ms {four['ttft'][0]:.3f}/"
          f"{four['ttft'][1]:.3f} (tp 1 {one['ttft'][0]:.3f}/"
          f"{one['ttft'][1]:.3f}, tp 2 {two['ttft'][0]:.3f}/"
          f"{two['ttft'][1]:.3f}); ITL p50/p99 ms {four['itl'][0]:.3f}/"
          f"{four['itl'][1]:.3f} (tp 1 {one['itl'][0]:.3f}/"
          f"{one['itl'][1]:.3f}, tp 2 {two['itl'][0]:.3f}/"
          f"{two['itl'][1]:.3f}); requests parting from tp 1 (request, "
          f"first step, margin): {parted} (limit {BF16_TIE}), {as_tp2} of "
          f"{len(bodies)} requests equal to tp 2's; bytes staged "
          f"through the host by rank {staged} and logits rows taken by rank "
          f"0 from shard 1 {logits} (four ranks on one card and 8 cores: "
          f"host staging, not what dp costs); B4 launches over the four "
          f"ranks {launches} on {card}", flush=True)
    print(f"serve_lm tp 2 x dp 2 step_raise (27b): restarts "
          f"{health.get('watchdog_restarts')}, mesh "
          f"{health.get('mesh_devices')} devices {health.get('mesh_axes')}, "
          f"a new engine {rebuilt}, every worker ran its steps {reached}, "
          f"replay parting {replay_part}", flush=True)
    if pools != want or any(
            p - ref["pool"] / (TP * DP) > 1.5 * per_block for p in pools):
        raise AssertionError(f"27a pool bytes {pools}, want {want}")
    if shards != list(range(DP)) or not all(ok for _, ok in seats):
        raise AssertionError(f"27a seats {seats}")
    if any(m > BF16_TIE for *_, m in parted) or (
            replay_part is not None and replay_part[1] > BF16_TIE):
        raise AssertionError("tp 2 x dp 2 parts from tp 1 away from a "
                             "near-tie")
    if (health.get("watchdog_restarts") != 1 or not rebuilt
            or not all(reached) or health.get("mesh_axes") != {
                "tp": TP, "dp": DP} or not launches or not logits[0]):
        raise AssertionError(f"27b: restarts {health}, rebuilt {rebuilt}, "
                             f"workers {reached}, launches {launches}, "
                             f"logits bytes {logits}")
    print(f"serve_lm tp 2 x dp 2 ship (27c): lane {SHIP_LANE}'s prompt "
          f"({prompts[SHIP_LANE].shape[1]} tokens) prefilled in "
          f"{ship['prefill_ms']:.3f} ms and shipped ({ship['bytes'][0]} "
          f"row bytes, {ship['bytes'][1]} JSON bytes); ingest ok count "
          f"+{ship['ok']:g}, on shard {ship['named']} (named by "
          f"_pick_dp_shard; blocks {ship['blocks']}, in its extent "
          f"{ship['in_extent']}); ingest {ship['ingest_ms']:.3f} ms "
          f"(kv.ship span; phase 19's single process 10.987 ms); parting "
          f"from 27a's unshipped run {ship_part} (limit {BF16_TIE}); "
          f"export {ship['export_ms']:.3f} ms in the engine, "
          f"{ship['pull_ms']:.3f} ms for GET /prefix; exported rows "
          f"bitwise the shipped rows: {ship['bitwise']}; bytes the ship "
          f"command moved by rank {ship['ship_bytes']}, the export "
          f"{ship['export_bytes']}; B4 launches over the four ranks "
          f"{ship['launches']}; {ship['seconds']:.1f} s on {card}",
          flush=True)
    if (ship["ok"] != 1 or ship["named"] is None or not ship["in_extent"]
            or not ship["bitwise"] or not ship["shipped"]
            or not ship["launches"]):
        raise AssertionError(f"27c: {ship}")
    if ship_part is not None and ship_part[1] > BF16_TIE:
        raise AssertionError(f"27c parts from 27a away from a near-tie: "
                             f"{ship_part}")
    return launches, ship["launches"]


def tpdp_ship_leg(cfg, params, prompts, supervisor, url, body) -> dict:
    """Phase 27 (c), in 27's running world: ``body``'s prompt prefilled by
    a bf16 ``PrefillWorker`` here, 27 (a)'s retained entries dropped (so
    the ingest writes rather than finding the prompt live), the prompt
    sent as ``shipped_kv`` and pulled back by ``GET /prefix/<digest>``.
    Returns what 27's checks read."""
    from tf_operator_tpu_torch.runtime.metrics import SERVE_SHIP_INGEST_TOTAL
    from tf_operator_tpu_torch.serve.disagg import (
        PrefillWorker,
        chain_digests,
        decode_shipment,
    )
    from tf_operator_tpu_torch.serve.engine import ContinuousEngine
    from tf_operator_tpu_torch.serve.tp import report

    t_leg = time.perf_counter()
    prompt = np.asarray(body["tokens"], np.int32)
    worker = PrefillWorker(cfg, params, kv_block=BLK, device="cuda")
    t0 = time.perf_counter()
    payload = worker.prefill(prompt)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del worker
    torch.cuda.empty_cache()
    shipped = decode_shipment(payload)
    supervisor.scheduler.call_engine(
        lambda e: e._evict_retained(until_free=10 ** 9))
    engine = supervisor.engine
    seen, timed = [], []
    ingest, export = (ContinuousEngine.ingest_shipment,
                      ContinuousEngine.export_prefix)

    def spy_ingest(eng, shp, *args, **kwargs):
        shard = eng._pick_dp_shard(np.asarray(shp.tokens, np.int32))
        hold = ingest(eng, shp, *args, **kwargs)
        if hold is not None and hold.blocks:
            lo, hi = eng.blocks.shard_extent(shard)
            seen.append((shard, list(hold.blocks),
                         all(lo <= b < hi for b in hold.blocks)))
        return hold

    def spy_export(eng, digest):
        t = time.perf_counter()
        out = export(eng, digest)
        timed.append((time.perf_counter() - t) * 1e3)
        return out

    before = report(engine)
    ok = SERVE_SHIP_INGEST_TOTAL.value(outcome="ok")
    with mock.patch.object(ContinuousEngine, "ingest_shipment", spy_ingest), \
            mock.patch.object(ContinuousEngine, "export_prefix", spy_export):
        status, resp = http(url, "/generate", dict(body,
                                                   shipped_kv=payload))
        t0 = time.perf_counter()
        pull_status, pulled = http(url, "/prefix/" + chain_digests(
            prompt[0], BLK)[-1])
        pull_ms = (time.perf_counter() - t0) * 1e3
    after = report(engine)
    if status != 200 or pull_status != 200:
        raise AssertionError(f"27c: /generate {status}, /prefix "
                             f"{pull_status}: {resp if status != 200 else pulled}")
    back = decode_shipment(pulled["shipment"], expect_tokens=prompt[0])
    bitwise = set(back.rows) == set(shipped.rows) and all(
        set(back.rows[p]) == set(parts) and all(
            torch.equal(back.rows[p][k], v) for k, v in parts.items())
        for p, parts in shipped.rows.items())
    spans = span_ms("kv.ship")
    named, blocks, in_extent = seen[-1] if seen else (None, [], False)
    return dict(
        tokens=resp["tokens"][0], shipped=resp["timing"][0].get("shipped_kv"),
        prefill_ms=prefill_ms, bytes=wire_bytes(payload),
        ok=SERVE_SHIP_INGEST_TOTAL.value(outcome="ok") - ok, named=named,
        blocks=blocks, in_extent=in_extent,
        ingest_ms=spans[-1][0] if spans else float("nan"),
        export_ms=timed[-1] if timed else float("nan"), pull_ms=pull_ms,
        bitwise=bitwise,
        ship_bytes=[a["ship_bytes"] - b["ship_bytes"]
                    for a, b in zip(after, before)],
        export_bytes=[a["export_bytes"] - b["export_bytes"]
                      for a, b in zip(after, before)],
        launches=sum(a["paged_launches"] - b["paged_launches"]
                     for a, b in zip(after, before)),
        seconds=time.perf_counter() - t_leg)


def tpdp_phase(pa, i8, base, params, prompts, card, ref: dict,
               ahead: dict) -> dict:
    """Phase 27 (its workers ``ahead["27"]``, phase 28's started into
    ``ahead["28"]``); returns {kernel: {path label: launches}}."""
    t0 = time.perf_counter()
    front, ship = tpdp_front_phase(pa, i8, base, params, prompts, card, ref,
                                   ahead)
    print(f"phase 27 (tensor x data parallel serving): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"paged_attend": {"serve_lm tp 2 x dp 2 (27)": front,
                             "serve_lm tp 2 x dp 2 ship (27c)": ship}}


def tp_spec_phase(pa, i8, base, params, prompts, card, ref: dict,
                  ahead: dict) -> dict:
    """Phase 28: spec and the host tier at ``--tp 2`` (see the module
    docstring; its worker ``ahead["28"]``); ``ref`` is 25 (b)'s. Returns
    {kernel: {path: launches}}."""
    from tf_operator_tpu_torch.models.transformer import _decode_model
    from tf_operator_tpu_torch.serve.disagg import chain_digests
    from tf_operator_tpu_torch.serve.tp import report

    t_phase = time.perf_counter()
    cfg = replace(base, dtype=torch.bfloat16)
    bodies = [dict(front_requests(prompts)[i], num_steps=SPEC_STEPS_28)
              for i in SPEC_LANES_28]
    rng = np.random.default_rng(28)
    fresh = dict(tokens=rng.integers(0, cfg.vocab_size, (
        1, SPEC_FRESH_TOKENS)).astype(np.int32).tolist(),
                 num_steps=1, timing=True)
    # The trace ring also holds phase 19's tier spans: read only this
    # phase's.
    seen = {name: len(span_ms(name)) for name in ("kv.spill", "kv.restore")}
    t0 = time.perf_counter()
    supervisor, server, url = open_front(
        cfg, params, truncated_draft(params, DRAFT_LAYERS), tp=TP,
        dist_backend="gloo", spec_k=SPEC_K_28, host_tier_bytes=1 << 30,
        kv_pool_blocks=SPEC_POOL_BLOCKS, spawned=ahead.get("28"))
    start_s = time.perf_counter() - t0
    try:
        engine = supervisor.engine
        reset_counts(pa, i8)
        before = report(engine)
        responses, wall = send_all(url, bodies)
        line = latency_line("tp 2 spec (28a)", responses, wall)
        _, debug = http(url, "/debug/serve")
        mid = report(engine)
        # (b): the fresh prompt needs blocks only a retained prefix frees.
        send_all(url, [fresh])
        _, health = http(url, "/healthz")
        digests = [chain_digests(np.asarray(b["tokens"][0], np.int32),
                                 BLK)[-1] for b in bodies]
        spilled = [i for i, d in enumerate(digests)
                   if d in health.get("tier_prefixes", [])]
        if not spilled:
            raise AssertionError(f"28b: no retained prefix spilled: "
                                 f"{health.get('tier_prefixes')}")
        pick = spilled[0]
        again, _ = send_all(url, [bodies[pick]])
        _, after = http(url, "/debug/serve")
        rows = report(engine)
    finally:
        server.drain()
    b4 = [r["paged_launches"] - b["paged_launches"]
          for r, b in zip(mid, before)]
    launches = sum(r["paged_launches"] - b["paged_launches"]
                   for r, b in zip(rows, before))
    spec = debug["spec"]
    tier = after["kv_cache"]["tier"]
    restores = tier["restores"] - debug["kv_cache"]["tier"]["restores"]
    rates = {name: [(a.get("bytes", 0) / 1e9) / (ms / 1e3)
                    for ms, a in span_ms(name)[n:] if ms > 0]
             for name, n in seen.items()}
    model = _decode_model(cfg, params, None)
    parted = []
    for lane, body, resp in zip(SPEC_LANES_28, bodies, responses):
        part = tp_parting(model, body, resp["tokens"][0],
                          ref["tp2_tokens"][lane][:SPEC_STEPS_28])
        if part is not None:
            parted.append((lane, *part))
    del model
    torch.cuda.empty_cache()
    first = responses[pick]["tokens"][0]
    two = ref["two"]
    print(f"serve_lm tp 2 spec (28a): rank 0 in this process, its worker "
          f"on the same card, gloo; world start {start_s:.1f} s; k "
          f"{spec['k']}, rounds {spec['rounds']}, lane-rounds "
          f"{spec['lane_rounds']}, tokens {spec['tokens']}: tokens a "
          f"lane-round {spec['tokens_per_lane_round']}, acceptance "
          f"{spec['accept_rate']}; requests/s {line['rps']:.4f} (25b tp 2 "
          f"{two['rps']:.4f}, 8 requests there), TTFT p50/p99 ms "
          f"{line['ttft'][0]:.3f}/{line['ttft'][1]:.3f}, ITL p50/p99 ms "
          f"{line['itl'][0]:.3f}/{line['itl'][1]:.3f}; B4 launches at t = "
          f"{SPEC_K_28 + 1} by rank {b4}; lanes parting from 25b's tp 2 "
          f"tokens (lane, first step, margin): {parted} (limit "
          f"{BF16_TIE}); spec bytes moved by rank "
          f"{[r['spec_bytes'] - b['spec_bytes'] for r, b in zip(mid, before)]}"
          f" on {card}", flush=True)
    print(f"serve_lm tp 2 tier (28b): pool {SPEC_POOL_BLOCKS} blocks; lane "
          f"{SPEC_LANES_28[pick]}'s prefix spilled for a fresh "
          f"{SPEC_FRESH_TOKENS}-token prompt, restores +{restores} (tier "
          f"{tier}); its repeat equals its first run's "
          f"{SPEC_STEPS_28} tokens: {again[0]['tokens'][0] == first}; "
          f"spill GB/s {[round(x, 4) for x in rates['kv.spill']]}, restore "
          f"GB/s {[round(x, 4) for x in rates['kv.restore']]} (export and "
          f"ingest commands, JSON and SHA-1 included); export bytes by rank "
          f"{[r['export_bytes'] - m['export_bytes'] for r, m in zip(rows, mid)]}"
          f", ship bytes "
          f"{[r['ship_bytes'] - m['ship_bytes'] for r, m in zip(rows, mid)]}",
          flush=True)
    print(f"phase 28 (spec and the tier under tp): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if any(m > BF16_TIE for *_, m in parted):
        raise AssertionError("28a parts from 25b's tp 2 tokens away from a "
                             "near-tie")
    if (len(set(b4)) != 1 or not b4[0] or spec["rounds"] < 1
            or restores < 1 or again[0]["tokens"][0] != first):
        raise AssertionError(f"28: B4 {b4}, spec {spec}, restores "
                             f"{restores}, repeat {again[0]['tokens'][0]} "
                             f"first {first}")
    return {"paged_attend": {"serve_lm tp 2 spec (28)": launches}}


def tp_train_batch(vocab: int, b: int, t: int, device) -> dict:
    """Phase 26's batch: phase 24 (a)'s seeded tokens and targets."""
    rng = np.random.default_rng(0)
    return {name: torch.from_numpy(rng.integers(
        0, vocab, (b, t)).astype(np.int64)).to(device)
        for name in ("tokens", "targets")}


def adafactor_bounds(rms0: float, size: int, steps: int, lr: float
                     ) -> tuple[float, float]:
    """(rms, elementwise) bounds on how far two Adafactor runs of ``steps``
    steps at ``lr`` from one leaf (its rms ``rms0``, ``size`` elements)
    may part. After the clip rms(u) <= 1, so a step moves the leaf by an
    update of rms at most ``lr * max(rms(p), 1e-3)``, and rms(p) grows by
    at most that factor ``1 + lr`` a step; the two runs part in rms by at
    most the sum of both runs' moves, and an element by at most sqrt(size)
    times that (an update of rms r has no element above sqrt(size) r)."""
    scale = max(rms0, 1e-3) * (1.0 + lr) ** steps
    rms = 2 * steps * lr * scale
    return rms, math.sqrt(size) * rms


def tp_train_nccl_phase(card: str) -> tuple[dict, dict]:
    """Phase 26 (a): phase 9's bf16 step over ``mesh={"dp": 1, "tp": 1}``
    (the model built over it) in an NCCL world of 1 in this process, in
    turns with the plain step (plain, tp, tp, plain): every run's losses
    and weights bitwise the first's; then a plain Adafactor run of
    ``ADAFACTOR_STEPS`` steps for (e). Returns the tp runs' flash
    launches and the references: the last plain AdamW run (tp 1: its
    losses, weights on the host and weight bytes), the Adafactor run's
    losses and weights (``adafactor``) and each leaf's rms and size at
    the seeded tree (``leaves``, by flax path)."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import (
        _leaves,
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train.steps import adafactor, adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    params = init_params(cfg, seed=0)
    batch = tp_train_batch(cfg.vocab_size, TRAIN_B, TRAIN_T, "cuda")
    kw = dict(xent_chunk=XENT_CHUNK, xent_dot_dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    first, differ, ref = None, [], None
    sides = ("plain", "tp", "tp", "plain")
    seconds = {"plain": [], "tp": []}
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    losses = {}
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        mesh = create_mesh({"dp": 1, "tp": 1}, device="cuda")
        tp_cfg = replace(cfg, mesh=mesh)
        for i, side in enumerate(sides):
            run = train_run(tp_cfg if side == "tp" else cfg, params, batch,
                            TP_TRAIN_STEPS, adamw(TP_TRAIN_LR), **kw,
                            **({"mesh": mesh} if side == "tp" else {}))
            model = run.pop("model")
            weights = {n: p.detach() for n, p in model.named_parameters()}
            if first is None:
                first = {"losses": run["losses"], "weights": {
                    n: w.clone() for n, w in weights.items()}}
            differ += [f"{i} {side} {n}" for n, w in weights.items()
                       if not torch.equal(w, first["weights"][n])]
            losses.setdefault(side, run["losses"])
            if run["losses"] != first["losses"]:
                differ.append(f"{i} {side} losses {run['losses']}")
            seconds[side] += run["seconds"]
            if side == "tp":
                if model.tp_plan is None:
                    raise AssertionError("26a: the tp model has no plan")
                for key, n in zip(FLASH_KERNELS, run["counts"].values()):
                    launches[key] += n
            if i == len(sides) - 1:
                ref = {"losses": run["losses"], "weights": {
                    n: w.float().cpu() for n, w in weights.items()},
                    "param_bytes": sum(p.numel() * p.element_size()
                                       for p in model.parameters())}
            del run, weights, model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    tok_s = {side: TRAIN_B * TRAIN_T / float(np.median(sec))
             for side, sec in seconds.items()}
    print(f"train tp nccl world 1 (26a): bf16 B={TRAIN_B} T={TRAIN_T}, "
          f"{TP_TRAIN_STEPS} steps a run from one tree, in turns plain, tp "
          f"over {mesh}, tp, plain: losses {losses['plain']} plain, "
          f"{losses['tp']} tp; "
          f"{'every run bitwise the first' if not differ else differ[:8]} "
          f"({len(first['weights'])} weights); tokens/s by the median step "
          f"plain {tok_s['plain']:.2f}, tp {tok_s['tp']:.2f} (ratio "
          f"{tok_s['tp'] / tok_s['plain']:.4f}; step_s {seconds}); "
          f"launches of the tp runs {launches} on {card}", flush=True)
    if differ:
        raise AssertionError("the tp world of 1 parts from the plain step")
    want = 2 * cfg.n_layers * TP_TRAIN_STEPS
    if set(launches.values()) != {want}:
        raise AssertionError(f"26a launches {launches}, want {want} of each")
    del first
    torch.cuda.empty_cache()
    ref["plain_s"] = seconds["plain"]
    run = train_run(cfg, params, batch, ADAFACTOR_STEPS,
                    adafactor(TP_TRAIN_LR), **kw)
    model = run.pop("model")
    seed = dict(load_params(Transformer(cfg), params).named_parameters())
    ref["adafactor"] = {"losses": run["losses"], "weights": {
        n: p.detach().float().cpu() for n, p in model.named_parameters()},
        "move_sq": {n: float((p.detach().float() - seed[n].detach().float()
                              ).square().sum())
                    for n, p in model.named_parameters()}}
    del seed
    ref["leaves"] = {"/".join(path): (float(np.sqrt(np.mean(np.square(
        leaf, dtype=np.float64)))), int(leaf.size))
        for path, leaf in _leaves(params)}
    print(f"train adafactor tp 1 (26a): bf16 B={TRAIN_B} T={TRAIN_T}, "
          f"adafactor({TP_TRAIN_LR}) {ADAFACTOR_STEPS} steps from the seeded "
          f"tree: losses {run['losses']}, step_s {run['seconds']} on {card}",
          flush=True)
    del run, model
    torch.cuda.empty_cache()
    return launches, ref


def pp_rank_run(cfg, tree: dict, mesh, batch: dict, schedule: str,
                device) -> tuple[dict, object]:
    """``TP_TRAIN_STEPS`` steps of the pipelined cell (``cfg``, no mesh of
    its own) over ``mesh`` by ``schedule`` at ``PP_MICRO`` microbatches,
    this rank's stage built from ``tree`` (``split_pp_params``' layout) and
    its rows of the host ``batch``, the peak memory reset first:
    ``rank_steps``' numbers plus the stash's high-water mark, the weight
    and AdamW bytes this rank holds and its peak device bytes; and the
    stage model."""
    from tf_operator_tpu_torch.train import pp_lm
    from tf_operator_tpu_torch.train.steps import TrainState, adamw

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = pp_lm.pp_model(cfg, mesh, tree, device=device)
    tx = adamw(TP_TRAIN_LR)
    state = TrainState.create(model, tx)
    step = pp_lm.make_pp_lm_train_step(cfg, mesh, tx, num_micro=PP_MICRO,
                                       xent_chunk=XENT_CHUNK,
                                       schedule=schedule)
    leg = rank_steps(step, state, pp_lm.pp_rows(mesh, batch, PP_MICRO),
                     TP_TRAIN_STEPS, cuda)
    leg.update(
        mark=step.stash_mark,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        adam_bytes=sum(v.numel() * v.element_size()
                       for st in state.optimizer.state.values()
                       for v in st.values()
                       if isinstance(v, torch.Tensor) and v.dim()),
        peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
    return leg, model


def pp_world1_runs(card: str, cfg, params: dict, ref: dict,
                   device: str = "cuda") -> dict:
    """Phase 26 (i), in (f)'s NCCL world of 1 after go: the cell over
    ``{"pp": 1}`` by GPipe and by 1F1B at ``PP_MICRO`` microbatches from
    the seeded tree, each held to (a)'s last plain run by (b)'s bounds.
    Returns {path label: flash launches}."""
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train.pp_lm import split_pp_params

    mesh = create_mesh({"pp": 1}, device=device)
    tree = dict(zip(("outer", "stages"),
                    split_pp_params(params, cfg.n_layers, 1)))
    batch = tp_train_batch(cfg.vocab_size, TRAIN_B, TRAIN_T, "cpu")
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    out, lines, bad = {}, [], []
    plain_tok_s = TRAIN_B * TRAIN_T / float(np.median(ref["plain_s"]))
    for sched in PP_SCHEDULES:
        leg, model = pp_rank_run(cfg, tree, mesh, batch, sched, device)
        loss_err = [abs(a - b) / abs(b) for a, b in zip(leg["losses"],
                                                        ref["losses"])]
        errs = {n: float((p.detach().float().cpu() - ref["weights"][n]
                          ).abs().max())
                for n, p in model.named_parameters()}
        at = max(errs, key=errs.get)
        bitwise = leg["losses"] == ref["losses"] and not any(errs.values())
        # A microbatch's blocks run once a microbatch: twice a layer a step
        # (1F1B: its backward recomputes the forward).
        want = {"fwd": (2 if sched == "1f1b" else 1),
                "dq": 1, "dkv": 1}
        want = {k: v * PP_MICRO * cfg.n_layers * TP_TRAIN_STEPS
                for k, v in want.items()}
        tok_s = TRAIN_B * TRAIN_T / float(np.median(leg["seconds"][1:]))
        lines.append(
            f"{sched}: losses {leg['losses']} (relative "
            f"{[f'{e:.3e}' for e in loss_err]}), largest weight difference "
            f"{errs[at]:.3e} in {at}, "
            f"{'bitwise' if bitwise else 'not bitwise'}; stash mark "
            f"{leg['mark']}, peak {leg['peak_bytes']} bytes, step_s "
            f"{leg['seconds']}, tokens/s {tok_s:.2f} ({tok_s / plain_tok_s:.4f}"
            f" of the plain step's), launches {leg['counts']}")
        if (not max(loss_err) <= TP_TRAIN_LOSS_RTOL
                or not errs[at] <= ADAM_BOUND * lr_sum
                or leg["counts"] != want):
            bad.append(f"{sched}: losses {loss_err}, weights {errs[at]}, "
                       f"launches {leg['counts']} (want {want})")
        out[f"train pp {sched} nccl world 1 (26i)"] = dict(zip(
            FLASH_KERNELS, leg["counts"].values()))
        del leg, model
        if device == "cuda":
            torch.cuda.empty_cache()
    print(f"train pp nccl world 1 (26i): bf16 B={TRAIN_B} T={TRAIN_T} over "
          f"{mesh}, {PP_MICRO} microbatches, {TP_TRAIN_STEPS} steps a run "
          f"from the seeded tree against (a)'s last plain run (losses "
          f"{ref['losses']}, tolerances {TP_TRAIN_LOSS_RTOL} and "
          f"{ADAM_BOUND * lr_sum:.3e}; (a)'s plain tokens/s "
          f"{plain_tok_s:.2f}): {'; '.join(lines)} (after go, beside (b)'s "
          f"ranks and (c)) on {card}", flush=True)
    if bad:
        raise AssertionError(f"26i: {bad}")
    return out


def sharded_world1_phase(card: str, ref: dict, tmp: str) -> dict:
    """Phase 26 (f), run after go, beside (b)'s ranks and (c): in an NCCL
    world of 1 in this process, phase 9's bf16 step under FSDP over
    ``{"fsdp": 1}`` and under ZeRO-1 over ``{"dp": 1}``
    (``weight_update_shardings``), ``TP_TRAIN_STEPS`` steps each from the
    seeded tree: losses and weights bitwise (a)'s last plain run; then
    (i) (``pp_world1_runs``); then the MoE cell plain and over ``{"dp":
    1, "ep": 1}`` (``moe_world1_runs``); then (l) (``a8i_world1_runs``,
    its references written under ``tmp``). Sets ``ref["moe"]`` and
    ``ref["a8i"]``; returns {path label: flash launches}."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        fsdp_sharding_tree,
        shard_params_fsdp,
        weight_update_shardings,
    )
    from tf_operator_tpu_torch.train.steps import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    params = init_params(cfg, seed=0)
    batch = tp_train_batch(cfg.vocab_size, TRAIN_B, TRAIN_T, "cuda")
    kw = dict(xent_chunk=XENT_CHUNK, xent_dot_dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    out, lines = {}, []
    try:
        fmesh = create_mesh({"fsdp": 1}, device="cuda")
        zmesh = create_mesh({"dp": 1}, device="cuda")
        for side, label, side_kw in (
                ("fsdp", "train fsdp nccl world 1 (26f)", dict(
                    mesh=fmesh, data_axis="fsdp",
                    param_shardings=fsdp_sharding_tree(fmesh, params),
                    place=lambda m: shard_params_fsdp(fmesh, m))),
                ("zero", "train zero1 nccl world 1 (26f)", dict(
                    mesh=zmesh, opt_shardings=weight_update_shardings(
                        zmesh, params)))):
            run = train_run(cfg, params, batch, TP_TRAIN_STEPS,
                            adamw(TP_TRAIN_LR), **kw, **side_kw)
            model = run.pop("model")
            if side == "fsdp" and not model.fsdp.cuts:
                raise AssertionError("26f: FSDP cut no leaf")
            differ = [n for n, p in model.named_parameters()
                      if not torch.equal(p.detach().float().cpu(),
                                         ref["weights"][n])]
            if run["losses"] != ref["losses"]:
                differ.append(f"losses {run['losses']}")
            lines.append(f"{side} over {side_kw['mesh']}: losses "
                         f"{run['losses']}, "
                         f"{'bitwise' if not differ else differ[:8]}, step_s "
                         f"{run['seconds']}, launches {run['counts']}")
            out[label] = dict(zip(FLASH_KERNELS, run["counts"].values()))
            want = cfg.n_layers * TP_TRAIN_STEPS
            if differ or set(run["counts"].values()) != {want}:
                raise AssertionError(f"26f {side}: {differ[:8]}, launches "
                                     f"{run['counts']} (want {want})")
            del run, model
            torch.cuda.empty_cache()
        print(f"train fsdp and zero1 nccl world 1 (26f): bf16 B={TRAIN_B} "
              f"T={TRAIN_T}, {TP_TRAIN_STEPS} steps each from the seeded "
              f"tree against (a)'s plain run (losses {ref['losses']}): "
              f"{'; '.join(lines)} (beside (b)'s ranks and (c)) on {card}",
              flush=True)
        out.update(pp_world1_runs(card, cfg, params, ref))
        del params
        moe_launches, ref["moe"] = moe_world1_runs(card)
        out["train moe ep nccl world 1 (26f)"] = moe_launches
        a8i, ref["a8i"] = a8i_world1_runs(card, tmp)
        out.update(a8i)
    finally:
        dist.destroy_process_group()
    return out


def moe_world1_runs(card: str) -> tuple[dict, dict]:
    """26 (f)'s MoE cell (phase 22 (b)'s: the training cell with every 2nd
    block 8 experts, top-2, aux weight 0.01) in the NCCL world of 1, plain
    and over ``{"dp": 1, "ep": 1}`` (the model and the step over it), in
    turns, ``TP_TRAIN_STEPS`` steps each from the seeded tree: bitwise.
    Returns the ep run's flash launches and the plain run (losses, aux,
    weights on the host by parameter name, weight bytes) for (h)."""
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train.steps import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM, **MOE_BENCH)
    params = init_params(cfg, seed=0)
    batch = tp_train_batch(cfg.vocab_size, TRAIN_B, TRAIN_T, "cuda")
    mesh = create_mesh({"dp": 1, "ep": 1}, device="cuda")
    kw = dict(xent_chunk=XENT_CHUNK, xent_dot_dtype=torch.bfloat16,
              aux_loss_weight=MOE_AUX_WEIGHT)
    runs = {}
    for side in ("plain", "ep"):
        run = train_run(replace(cfg, mesh=mesh) if side == "ep" else cfg,
                        params, batch, TP_TRAIN_STEPS, adamw(TP_TRAIN_LR),
                        **kw, **({"mesh": mesh} if side == "ep" else {}))
        model = run.pop("model")
        run["weights"] = {n: p.detach().float().cpu()
                          for n, p in model.named_parameters()}
        run["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in model.parameters())
        runs[side] = run
        del model
        torch.cuda.empty_cache()
    plain, ep = runs["plain"], runs["ep"]
    differ = [n for n, w in ep["weights"].items()
              if not torch.equal(w, plain["weights"][n])]
    if ep["losses"] != plain["losses"] or ep["auxes"] != plain["auxes"]:
        differ.append("losses")
    print(f"train moe ep nccl world 1 (26f): phase 22 (b)'s MoE cell, bf16 "
          f"B={TRAIN_B} T={TRAIN_T}, {TP_TRAIN_STEPS} steps a run from the "
          f"seeded tree, plain then over {mesh}: losses {plain['losses']} "
          f"plain, {ep['losses']} ep, aux {plain['auxes']} / {ep['auxes']}; "
          f"{'bitwise' if not differ else differ[:8]} "
          f"({len(plain['weights'])} weights, {plain['param_bytes']} bytes); "
          f"step_s plain {plain['seconds']}, ep {ep['seconds']} (beside "
          f"(b)'s ranks and (c)); launches of the ep run {ep['counts']} on "
          f"{card}", flush=True)
    if differ:
        raise AssertionError("26f: the MoE cell at ep 1 parts from plain")
    want = cfg.n_layers * TP_TRAIN_STEPS
    if set(ep["counts"].values()) != {want}:
        raise AssertionError(f"26f moe launches {ep['counts']}, want {want}")
    return dict(zip(FLASH_KERNELS, ep["counts"].values())), {
        k: plain[k] for k in ("losses", "auxes", "weights", "param_bytes")}


def a8i_cells() -> dict:
    """(l)'s and (m)'s cells by name: the training cell and the MoE cell,
    each cut to ``A8I_LAYERS`` blocks (keywords of ``TransformerConfig``
    but its dtype)."""
    lm = dict(LM, n_layers=A8I_LAYERS)
    return {"lm": lm, "moe": dict(lm, **MOE_BENCH)}


def a8i_world1_runs(card: str, tmp: str) -> tuple[dict, dict]:
    """Phase 26 (l), in (f)'s NCCL world of 1 after its MoE runs: each of
    ``a8i_cells`` plain, then over (l)'s meshes of ``A8I_LEGS`` (the MoE
    cell's model over ``{"ep": 1, "tp": 1}``; the training cell's under
    FSDP over ``{"fsdp": 1, "tp": 1}`` and under ZeRO-1 over ``{"dp": 1,
    "tp": 1}``), ``TP_TRAIN_STEPS`` steps each from the seeded tree:
    losses and weights bitwise the plain run. Writes each plain run's
    host weights (by parameter name) to ``tmp/a8i_{cell}.pt`` for (m).
    Returns ({path label: flash launches}, {cell: the plain run's losses,
    aux and weight bytes})."""
    from tf_operator_tpu_torch.models.convert import init_params
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import (
        fsdp_sharding_tree,
        shard_params_fsdp,
        weight_update_shardings,
    )
    from tf_operator_tpu_torch.train.steps import adamw

    batch = tp_train_batch(LM["vocab_size"], TRAIN_B, TRAIN_T, "cuda")
    out, refs, lines, bad = {}, {}, [], []
    want = A8I_LAYERS * TP_TRAIN_STEPS
    for cell, kwargs in a8i_cells().items():
        cfg = TransformerConfig(dtype=torch.bfloat16, **kwargs)
        params = init_params(cfg, seed=0)
        kw = dict(xent_chunk=XENT_CHUNK, xent_dot_dtype=torch.bfloat16)
        if cell == "moe":
            kw["aux_loss_weight"] = MOE_AUX_WEIGHT
        plain = train_run(cfg, params, batch, TP_TRAIN_STEPS,
                          adamw(TP_TRAIN_LR), **kw)
        model = plain.pop("model")
        weights = {n: p.detach().float().cpu()
                   for n, p in model.named_parameters()}
        refs[cell] = {"losses": plain["losses"], "auxes": plain["auxes"],
                      "param_bytes": sum(p.numel() * p.element_size()
                                         for p in model.parameters())}
        torch.save({"weights": weights}, os.path.join(tmp, f"a8i_{cell}.pt"))
        del model
        torch.cuda.empty_cache()
        for leg, (leg_cell, _, axes) in A8I_LEGS.items():
            if leg_cell != cell:
                continue
            mesh = create_mesh(axes, device="cuda")
            side_kw, place = dict(kw, mesh=mesh), None
            if leg == "fsdp":
                side_kw.update(data_axis="fsdp",
                               param_shardings=fsdp_sharding_tree(mesh,
                                                                  params))

                def place(m, mesh=mesh):
                    return shard_params_fsdp(mesh, m)
            elif leg == "zero":
                side_kw["opt_shardings"] = weight_update_shardings(mesh,
                                                                   params)
            run = train_run(replace(cfg, mesh=mesh), params, batch,
                            TP_TRAIN_STEPS, adamw(TP_TRAIN_LR), place=place,
                            **side_kw)
            model = run.pop("model")
            differ = [n for n, p in model.named_parameters()
                      if not torch.equal(p.detach().float().cpu(),
                                         weights[n])]
            if (run["losses"] != plain["losses"]
                    or run["auxes"] != plain["auxes"]):
                differ.append(f"losses {run['losses']} aux {run['auxes']}")
            label = {"moe": "train moe ep 1 x tp 1 nccl world 1 (26l)",
                     "fsdp": "train fsdp 1 x tp 1 nccl world 1 (26l)",
                     "zero": "train zero1 dp 1 x tp 1 nccl world 1 (26l)"}[
                         leg]
            out[label] = dict(zip(FLASH_KERNELS, run["counts"].values()))
            lines.append(
                f"{leg} over {mesh}: losses {run['losses']}"
                + (f", aux {run['auxes']}" if run["auxes"] else "")
                + f" against plain {plain['losses']}; "
                f"{'bitwise' if not differ else differ[:8]}; step_s "
                f"{run['seconds']} (plain {plain['seconds']}); launches "
                f"{run['counts']}")
            if differ or set(run["counts"].values()) != {want}:
                bad.append(f"{leg}: {differ[:8]}, launches {run['counts']} "
                           f"(want {want})")
            del run, model
            torch.cuda.empty_cache()
        del params, weights
    print(f"train a8i nccl world 1 (26l): bf16 B={TRAIN_B} T={TRAIN_T}, the "
          f"training cell and the MoE cell at {A8I_LAYERS} blocks, "
          f"{TP_TRAIN_STEPS} steps a run from the seeded tree, each plain "
          f"then over a mesh of ones: {'; '.join(lines)} (after go, beside "
          f"(b)'s ranks and (c)) on {card}", flush=True)
    if bad:
        raise AssertionError(f"26l: {bad}")
    return out, refs


def start_a8i_ranks(tmp: str, procs: list, logs: list) -> None:
    """Phase 26 (m)'s ``A8I_WORLD`` gloo ranks (``a8i_rank``), started on
    the card at go so that their imports, the world's join and the host
    trees overlap (b)'s ranks and (c); each waits for ``tmp/go_m``.
    Appends the processes and their log paths to ``procs`` and
    ``logs``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in (
        "TF_CONFIG", "TPU_WORKER_ID", "TPU_NUM_PROCESSES",
        "TPU_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    port = free_port()
    for r in range(A8I_WORLD):
        rank_env = dict(env, TPU_NUM_PROCESSES=str(A8I_WORLD),
                        TPU_WORKER_ID=str(r),
                        TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        logs.append(os.path.join(tmp, f"a8i{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.a8i_rank(sys.argv[1]))", tmp],
                cwd=root, env=rank_env, stdout=log,
                stderr=subprocess.STDOUT))


def a8i_rank(out: str) -> int:
    """One rank of phase 26 (m), a process of its own (``python -c``):
    joins the gloo world of ``A8I_WORLD`` the operator's env names, makes
    (l)'s seeded trees on the host, waits for ``out/go_m``, then runs each
    leg of ``A8I_LEGS`` over its (m) mesh (this rank's tp slices of the
    tree, its experts over ep, its FSDP shards; its data index's rows of
    phase 26's batch), ``TP_TRAIN_STEPS`` steps: ``rank_steps``' numbers,
    the weight and optimiser bytes it holds, its peak device bytes, and
    its weights against (l)'s plain run (``out/a8i_{cell}.pt``) cut to
    its parts: the largest difference, where, and the elements beyond 1 %
    of the summed lr. Writes them to ``out/a8i{r}.json``."""
    from tf_operator_tpu_torch.models.convert import (
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.moe import moe_param_sharding_rules
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import distributed
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_train_step,
        param_cuts,
    )

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    topo = distributed.initialize(distributed.from_env(), device=device,
                                  backend="gloo")
    fa._library()
    cells = a8i_cells()
    trees = {name: init_params(TransformerConfig(**kw), seed=0)
             for name, kw in cells.items()}
    batch = tp_train_batch(LM["vocab_size"], TRAIN_B, TRAIN_T, device)
    ready = time.perf_counter()
    deadline = time.monotonic() + 900.0
    while not os.path.exists(os.path.join(out, "go_m")):
        if time.monotonic() > deadline:
            raise TimeoutError("26m: no go within 900 s")
        time.sleep(0.05)
    result = {"waited": time.perf_counter() - ready}
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    for leg, (cell, axes, _) in A8I_LEGS.items():
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = create_mesh(axes, device=device)
        rules = dict(param_sharding_rules())
        if cell == "moe":
            rules.update(moe_param_sharding_rules())
        cfg = TransformerConfig(dtype=torch.bfloat16, mesh=mesh, **cells[cell])
        model = load_params(Transformer(cfg, device), sharding.
                            shard_params_by_rules(mesh, trees[cell], rules))
        data = {"fsdp": "fsdp"}.get(leg, "dp")
        kw = dict(mesh=mesh, data_axis=data, xent_chunk=XENT_CHUNK,
                  xent_dot_dtype=torch.bfloat16)
        if leg == "fsdp":
            kw["param_shardings"] = sharding.fsdp_sharding_tree(mesh,
                                                                trees[cell])
            sharding.shard_params_fsdp(mesh, model)
        elif leg == "zero":
            kw["opt_shardings"] = sharding.weight_update_shardings(
                mesh, trees[cell])
        else:
            kw["aux_loss_weight"] = MOE_AUX_WEIGHT
        tx = adamw(TP_TRAIN_LR)
        state = TrainState.create(model, tx)
        step = make_lm_train_step(model, tx, **kw)
        rows = sharding.DataParallel(mesh, data)
        n = TRAIN_B // rows.size
        mine = {k: v[rows.index * n:(rows.index + 1) * n]
                for k, v in batch.items()}
        got = rank_steps(step, state, mine, TP_TRAIN_STEPS, True)
        got["param_bytes"], got["adam_bytes"] = held_bytes(state)
        got["peak_bytes"] = torch.cuda.max_memory_allocated()
        ref = torch.load(os.path.join(out, f"a8i_{cell}.pt"), mmap=True,
                         weights_only=True)["weights"]
        cuts = param_cuts(model)
        max_err, at, far, total = 0.0, None, 0, 0
        for name, p in model.named_parameters():
            want = ref[name]
            if id(p) in cuts:
                want = cuts[id(p)].part(want)
            diff = (p.detach().float().cpu() - want).abs()
            err = float(diff.max())
            if err > max_err:
                max_err, at = err, name
            far += int((diff > 0.01 * lr_sum).sum())
            total += diff.numel()
        got.update(max_err=max_err, at=at, far=far, total=total,
                   leg_s=time.perf_counter() - t0)
        result[leg] = got
        del model, state, step, tx, ref
    with open(os.path.join(out, f"a8i{topo.process_id}.json"), "w") as f:
        json.dump(result, f)
    distributed.shutdown()
    return 0


def a8i_pair_phase(card: str, ref: dict, tmp: str, procs: list,
                   logs: list, t0: float) -> dict:
    """Phase 26 (m): the ranks ``start_a8i_ranks`` started, told to go at
    ``t0``, against (l)'s plain runs (``ref``): printed, checked (an
    ``AssertionError`` on a failure) and returned as {path label: the
    ranks' summed flash launches}."""
    codes = wait_all(procs, timeout=900.0)
    if codes != [0] * A8I_WORLD:
        raise AssertionError(f"26m: rc {codes}: " + "\n".join(
            read_log(p)[-3000:] for p in logs))
    ranks = []
    for r in range(A8I_WORLD):
        with open(os.path.join(tmp, f"a8i{r}.json")) as f:
            ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    want_n = A8I_LAYERS * TP_TRAIN_STEPS
    paths, bad = {}, []
    for leg, (cell, axes, _) in A8I_LEGS.items():
        legs = [r[leg] for r in ranks]
        plain = ref[cell]
        loss_err = [abs(a - b) / abs(b) for a, b in zip(legs[0]["losses"],
                                                        plain["losses"])]
        max_err = max(g["max_err"] for g in legs)
        at = next(g["at"] for g in legs if g["max_err"] == max_err)
        label = {"moe": "train moe ep 2 x tp 2 (26m)",
                 "fsdp": "train fsdp 2 x tp 2 (26m)",
                 "zero": "train zero1 dp 2 x tp 2 (26m)"}[leg]
        aux = (f"aux {legs[0]['auxes']} against {plain['auxes']}; "
               if legs[0]["auxes"] else "")
        print(f"{label}: bf16 B={TRAIN_B} T={TRAIN_T}, the {cell} cell at "
              f"{A8I_LAYERS} blocks over {axes} as {A8I_WORLD} gloo "
              f"processes on one card, {TP_TRAIN_STEPS} steps from the "
              f"seeded tree: losses {legs[0]['losses']} against the plain "
              f"run's {plain['losses']}, relative "
              f"{[f'{e:.3e}' for e in loss_err]} (tolerance "
              f"{TP_TRAIN_LOSS_RTOL}); {aux}each rank's parts of the weights "
              f"against the plain run's: largest difference {max_err:.3e} in "
              f"{at} (tolerance {ADAM_BOUND * lr_sum:.3e}), "
              f"{sum(g['far'] for g in legs)} of "
              f"{sum(g['total'] for g in legs)} beyond 1 % of the summed lr; "
              f"weight bytes a rank {[g['param_bytes'] for g in legs]} "
              f"(whole {plain['param_bytes']}, want "
              f"{4 * A8I_PARAMS[leg]}), AdamW bytes a rank "
              f"{[g['adam_bytes'] for g in legs]} (want "
              f"{8 * A8I_MOMENTS[leg]}); bytes staged through the host a "
              f"step {[g['staged'] for g in legs]}; peak device bytes a rank "
              f"{[g['peak_bytes'] for g in legs]}; step_s "
              f"{[g['seconds'] for g in legs]}; leg seconds a rank "
              f"{[round(g['leg_s'], 1) for g in legs]}; flash launches a "
              f"rank {[g['counts'] for g in legs]} (host staging on one "
              f"card) on {card}", flush=True)
        if (any(g["losses"] != legs[0]["losses"] for g in legs)
                or not max(loss_err) <= TP_TRAIN_LOSS_RTOL
                or not max_err <= ADAM_BOUND * lr_sum):
            bad.append(f"{leg}: parts from the plain run")
        if any(g["param_bytes"] != 4 * A8I_PARAMS[leg]
               or g["adam_bytes"] != 8 * A8I_MOMENTS[leg] for g in legs):
            bad.append(f"{leg}: bytes a rank off the layout")
        if any(set(g["counts"].values()) != {want_n} for g in legs):
            bad.append(f"{leg} launches {[g['counts'] for g in legs]}, "
                       f"want {want_n} of each a rank")
        paths[label] = {k: sum(counts_of(g)[k] for g in legs)
                        for k in FLASH_KERNELS}
    print(f"train a8i (26m): {wall:.1f} s from go_m to the ranks' exit, the "
          f"ranks ready {[round(r['waited'], 1) for r in ranks]} s before "
          f"go_m (started at go) on {card}", flush=True)
    if bad:
        raise AssertionError(f"26m: {bad}")
    return paths


def rank_steps(step, state, batch, steps: int, cuda: bool) -> dict:
    """``steps`` steps of a rank's train ``step`` on ``batch``, the flash
    counts and ``staged_bytes`` set to 0 before the first: its losses, the
    seconds and the bytes staged through the host of each step, and the
    flash launches."""
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import sharding

    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    losses, auxes, seconds, staged = [], [], [], []
    for _ in range(steps):
        sharding.staged_bytes = 0
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        if "aux_loss" in metrics:
            auxes.append(metrics["aux_loss"].item())
        seconds.append(time.perf_counter() - t0)
        staged.append(sharding.staged_bytes)
    return {"losses": losses, "auxes": auxes, "seconds": seconds,
            "staged": staged,
            "counts": dict(fwd=fa.fwd_launches, dq=fa.dq_launches,
                           dkv=fa.dkv_launches)}


def save_whole(model, mesh, rules, path: str | None) -> None:
    """The model's weights, gathered whole over tp (collective), saved by
    rank 0 to ``path`` as {flax path: f32 host tensor}."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import (
        _leaves,
        flax_path,
        param_shapes,
    )
    from tf_operator_tpu_torch.parallel import sharding

    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        path_ = flax_path(name)
        for key in path_[:-1]:
            node = node.setdefault(key, {})
        node[path_[-1]] = p.detach()
    whole = sharding.gather_params_by_rules(mesh, tree, rules,
                                            param_shapes(model.cfg))
    if dist.get_rank() == 0:
        torch.save({"/".join(k): v.float().cpu() for k, v in _leaves(whole)},
                   path)


def ring_check_rank(axis, device, shape) -> dict:
    """26 (d) (i) on this rank: one ``ring_flash_attention`` and one
    ``ulysses_attention`` over its block of seeded bf16 q, k, v and dO of
    ``shape`` (``RING_CHECK``; the same on every rank), forward and q/k/v
    gradients, against ``flash_attention`` on the whole sequence here:
    each output's share of the flash rule's bound and max-abs error, and
    the launches, the ring's at the top level and Ulysses' under
    ``"ulysses"``."""
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.ring_attention import (
        ring_flash_attention,
    )
    from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention
    from tf_operator_tpu_torch.testing import flash_excess

    b, t, h, dh = shape
    gen = torch.Generator(device=device).manual_seed(23)
    q, k, v, do = (torch.randn((b, t, h, dh), generator=gen, device=device
                               ).to(torch.bfloat16) for _ in range(4))
    whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*whole, causal=True).backward(do)
    n = t // axis.size
    cols = slice(axis.index * n, (axis.index + 1) * n)
    with torch.no_grad():
        want_o = fa.flash_attention(q, k, v, causal=True)[:, cols]
    want = dict(o=want_o, dq=whole[0].grad[:, cols],
                dk=whole[1].grad[:, cols], dv=whole[2].grad[:, cols])

    def held(attend) -> dict:
        part = [x[:, cols].clone().requires_grad_(True) for x in (q, k, v)]
        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        out = attend(*part, axis, causal=True)
        out.backward(do[:, cols].contiguous())
        counts = dict(fwd=fa.fwd_launches, dq=fa.dq_launches,
                      dkv=fa.dkv_launches)
        got = dict(o=out.detach(), dq=part[0].grad, dk=part[1].grad,
                   dv=part[2].grad)
        return {"share": {o: flash_excess(o, got[o], want[o]) for o in got},
                "err": {o: (got[o].float() - want[o].float()).abs().max(
                    ).item() for o in got},
                "counts": counts}

    return {**held(ring_flash_attention), "ulysses": held(ulysses_attention)}


def tp_train_rank(out: str) -> int:
    """One rank of phase 26 (b), (d) and (e), a process of its own
    (``python -c``): joins the gloo world the operator's env names, builds
    its part of the cell ``out/cell.json`` names (phase 9's) over ``{"tp":
    TP}`` from the seeded tree, runs ``TP_TRAIN_STEPS`` steps on phase
    26's batch and gathers the weights whole (rank 0 saves them under
    ``out``); then, in the same world, (d) the ring's check and the
    sequence-parallel model over ``{"sp": SP}`` (the flash ring, then
    Ulysses) and (e) Adafactor at tp 2, each from the seeded tree, rank 0
    saving the weights of (d)'s flash ring and of (e); then (g) and (h)
    (``sharded_legs``) and (j) (``pp_legs``); writes its numbers to
    ``out/rank{r}.json``."""
    from concurrent.futures import ThreadPoolExecutor

    from tf_operator_tpu_torch.models.convert import (
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        param_sharding_rules,
    )
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train import distributed
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adafactor,
        adamw,
        make_lm_train_step,
    )

    with open(os.path.join(out, "cell.json")) as f:
        cell = json.load(f)
    device = torch.device(cell["device"])
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    topo = distributed.initialize(distributed.from_env(), device=device,
                                  backend="gloo")
    rank = topo.process_id
    mesh = create_mesh({"tp": TP}, device=device)
    cfg = TransformerConfig(dtype=torch.bfloat16, mesh=mesh, **cell["lm"])
    rules = param_sharding_rules()
    tree = init_params(TransformerConfig(**cell["lm"]), seed=0)
    kw = dict(xent_chunk=cell["chunk"], xent_dot_dtype=torch.bfloat16)
    batch = tp_train_batch(cfg.vocab_size, cell["b"], cell["t"], device)
    if cuda:
        from tf_operator_tpu_torch.ops import flash_attention as fa

        fa._library()
    # (h)'s seeded MoE tree, made on the host while the legs before it
    # wait on the card and the collectives.
    pool = ThreadPoolExecutor(1)
    moe_tree = pool.submit(init_params, TransformerConfig(
        **cell["lm"], **MOE_BENCH), seed=0)
    # Started while (a) runs: wait here, the world joined and the card
    # up, until the phase says go.
    ready = time.perf_counter()
    deadline = time.monotonic() + 600.0
    while not os.path.exists(os.path.join(out, "go")):
        if time.monotonic() > deadline:
            raise TimeoutError("26b: no go within 600 s")
        time.sleep(0.05)
    waited = time.perf_counter() - ready

    def tp_leg(tx, steps: int, save: str) -> tuple[dict, list]:
        model = load_params(Transformer(cfg, device),
                            sharding.shard_params_by_rules(mesh, tree, rules))
        state = TrainState.create(model, tx)
        step = make_lm_train_step(model, tx, mesh=mesh, **kw)
        got = rank_steps(step, state, batch, steps, cuda)
        state_t = [v for st in state.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor)]
        save_whole(model, mesh, rules, os.path.join(out, save))
        return got, [model, state_t]

    result, held = tp_leg(adamw(TP_TRAIN_LR), TP_TRAIN_STEPS, "weights.pt")
    model, opt_t = held
    result.update(
        waited=waited,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        adam_bytes=sum(v.numel() * v.element_size() for v in opt_t
                       if v.dim()),
        peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
    del model, opt_t, held

    # (d) the sequence-parallel legs over the same world.
    sp_mesh = create_mesh({"sp": SP}, device=device)
    axis = sharding.TensorParallel(sp_mesh, "sp")
    if cuda:
        torch.cuda.empty_cache()
    result["ring"] = ring_check_rank(axis, device, cell["ring"])
    block = sharding.token_block(sp_mesh, batch)
    for impl, steps, save in (("auto", TP_TRAIN_STEPS, "sp.pt"),
                              ("ulysses", SP_ULYSSES_STEPS, None)):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sp_cfg = TransformerConfig(dtype=torch.bfloat16, mesh=sp_mesh,
                                   ring_impl=impl, **cell["lm"])
        model = load_params(Transformer(sp_cfg, device), tree)
        tx = adamw(TP_TRAIN_LR)
        step = make_lm_train_step(model, tx, mesh=sp_mesh, **kw)
        leg = rank_steps(step, TrainState.create(model, tx), block, steps,
                         cuda)
        leg["grad_bytes"] = sum(p.numel() * 4 for p in model.parameters())
        leg["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        if save and rank == 0:
            torch.save({"/".join(k): v.float().cpu() for k, v in
                        _named_flax(model)}, os.path.join(out, save))
        result["sp" if impl == "auto" else "ulysses"] = leg
        del model, step, tx
    # (e) Adafactor at tp 2.
    if cuda:
        torch.cuda.empty_cache()
    result["adafactor"], held = tp_leg(adafactor(TP_TRAIN_LR),
                                       ADAFACTOR_STEPS, "adafactor.pt")
    del held
    # (g) FSDP and ZeRO-1, (h) expert parallel, over the same world.
    result.update(sharded_legs(cell, tree, moe_tree.result(), batch, device,
                               out))
    pool.shutdown()
    # (j) the pipelined cell over the same world.
    result["pp"] = pp_legs(cell, tree, device, out)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    distributed.shutdown()
    return 0


def held_bytes(state) -> tuple[int, int]:
    """(weight bytes, optimiser-state bytes but step counts) a rank's
    ``TrainState`` holds."""
    opt = state.optimizer.state
    return (sum(p.numel() * p.element_size()
                for p in state.model.parameters()),
            sum(v.numel() * v.element_size() for st in opt.values()
                for v in st.values()
                if isinstance(v, torch.Tensor) and v.dim()))


def save_cut_whole(model, path: str | None) -> None:
    """The model's weights with every cut leaf (FSDP, ep) gathered whole
    (collective), saved by rank 0 to ``path`` as {flax path: f32 host
    tensor}."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models.convert import flax_path
    from tf_operator_tpu_torch.train.steps import param_cuts

    cuts = param_cuts(model)
    whole = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if id(p) in cuts:
            t = cuts[id(p)].gather(t)
        whole["/".join(flax_path(name))] = t.float().cpu()
    if dist.get_rank() == 0:
        torch.save(whole, path)


def sharded_legs(cell: dict, tree: dict, moe_tree: dict, batch: dict,
                 device, out: str) -> dict:
    """26 (g) and (h) on this rank of (b)'s world: FSDP over ``{"fsdp":
    FSDP}`` and ZeRO-1 over ``{"dp": FSDP}`` on phase 9's cell (this
    rank's B / 2 rows), then the MoE cell over ``{"ep": EP}`` (the whole
    batch), ``TP_TRAIN_STEPS`` steps each from the seeded trees (``tree``,
    ``moe_tree``); rank 0
    saves each leg's weights whole. Returns each leg's numbers: losses,
    step seconds, bytes staged a step, flash launches, the weight and
    optimiser bytes this rank holds, peak device bytes."""
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.moe import moe_param_sharding_rules
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.parallel import sharding
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_train_step,
    )

    cuda = device.type == "cuda"
    kw = dict(xent_chunk=cell["chunk"], xent_dot_dtype=torch.bfloat16)
    fmesh = create_mesh({"fsdp": FSDP}, device=device)
    zmesh = create_mesh({"dp": FSDP}, device=device)
    legs = {"fsdp": (fmesh, "fsdp"), "zero": (zmesh, "dp")}
    result = {}
    for name, (mesh, axis) in legs.items():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = TransformerConfig(dtype=torch.bfloat16, **cell["lm"])
        model = load_params(Transformer(cfg, device), tree)
        step_kw = dict(kw, mesh=mesh, data_axis=axis)
        if name == "fsdp":
            step_kw["param_shardings"] = sharding.fsdp_sharding_tree(
                mesh, tree)
            sharding.shard_params_fsdp(mesh, model)
        else:
            step_kw["opt_shardings"] = sharding.weight_update_shardings(
                mesh, tree)
        tx = adamw(TP_TRAIN_LR)
        state = TrainState.create(model, tx)
        step = make_lm_train_step(model, tx, **step_kw)
        rows = sharding.DataParallel(mesh, axis)
        n = cell["b"] // rows.size
        mine = {k: v[rows.index * n:(rows.index + 1) * n]
                for k, v in batch.items()}
        leg = rank_steps(step, state, mine, TP_TRAIN_STEPS, cuda)
        leg["param_bytes"], leg["adam_bytes"] = held_bytes(state)
        leg["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        save_cut_whole(model, os.path.join(out, f"{name}.pt"))
        result[name] = leg
        del model, state, step, tx
    # (h) the MoE cell over ep.
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    emesh = create_mesh({"ep": EP}, device=device)
    cfg = TransformerConfig(dtype=torch.bfloat16, mesh=emesh, **cell["lm"],
                            **MOE_BENCH)
    model = load_params(Transformer(cfg, device), sharding.
                        shard_params_by_rules(emesh, moe_tree,
                                              moe_param_sharding_rules()))
    tx = adamw(TP_TRAIN_LR)
    state = TrainState.create(model, tx)
    step = make_lm_train_step(model, tx, mesh=emesh,
                              aux_loss_weight=MOE_AUX_WEIGHT, **kw)
    leg = rank_steps(step, state, batch, TP_TRAIN_STEPS, cuda)
    leg["param_bytes"], leg["adam_bytes"] = held_bytes(state)
    leg["expert_bytes"] = sum(
        p.numel() * p.element_size() for n, p in model.named_parameters()
        if n.endswith(("moe.w_in", "moe.w_out")))
    leg["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    save_cut_whole(model, os.path.join(out, "ep.pt"))
    result["ep"] = leg
    return result


def pp_legs(cell: dict, tree: dict, device, out: str) -> dict:
    """26 (j) on this rank of (b)'s world: phase 9's cell over ``{"pp":
    PP}`` (this rank's stage, ``PP_MICRO`` microbatches of the whole
    batch) by each of ``PP_SCHEDULES`` from the seeded tree, this rank's
    weights saved under their places in the whole stack to
    ``out/pp_{schedule}_{rank}.pt``. Returns each schedule's numbers
    (``pp_rank_run``)."""
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.train.pp_lm import split_pp_params

    cfg = TransformerConfig(dtype=torch.bfloat16, **cell["lm"])
    mesh = create_mesh({"pp": PP}, device=device)
    pp_tree = dict(zip(("outer", "stages"),
                       split_pp_params(tree, cfg.n_layers, PP)))
    batch = tp_train_batch(cfg.vocab_size, cell["b"], cell["t"], "cpu")
    result = {}
    for sched in PP_SCHEDULES:
        leg, model = pp_rank_run(cfg, pp_tree, mesh, batch, sched, device)
        stage = model.pipeline.stage
        k = cfg.n_layers // stage.size
        mine = {}
        for path, p in _named_flax(model):
            if path[0].startswith("block_"):
                path = (f"block_{stage.index * k + int(path[0][6:])}",
                        *path[1:])
            mine["/".join(path)] = p.float().cpu()
        torch.save(mine, os.path.join(out, f"pp_{sched}_{stage.index}.pt"))
        result[sched] = leg
        del model, mine
    return result


def pp_pair_checks(ranks: list, ref: dict, tmp: str, card: str) -> dict:
    """26 (j) from the ranks' numbers and saved weights: printed, checked
    against (a)'s tp 1 run by (b)'s bounds (an ``AssertionError`` on a
    failure) and returned as {path label: the ranks' summed flash
    launches}."""
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    k = LM["n_layers"] // PP
    out, bad = {}, []
    for sched in PP_SCHEDULES:
        legs = [r["pp"][sched] for r in ranks]
        got = {}
        for r in range(PP):
            got.update(torch.load(os.path.join(tmp, f"pp_{sched}_{r}.pt"),
                                  weights_only=True))
        max_err, at, far, total = weights_apart(got, ref["weights"], lr_sum)
        loss_err = [abs(a - b) / abs(b) for a, b in zip(legs[0]["losses"],
                                                        ref["losses"])]
        want = {"fwd": 2 if sched == "1f1b" else 1, "dq": 1, "dkv": 1}
        want = {c: n * PP_MICRO * k * TP_TRAIN_STEPS for c, n in want.items()}
        marks = [min(PP_MICRO, 2 * PP - 1 - 2 * s) if sched == "1f1b" else 0
                 for s in range(PP)]
        print(f"train pp {PP} {sched} (26j): bf16 B={TRAIN_B} T={TRAIN_T} "
              f"over {{'pp': {PP}}} as {PP} gloo processes on one card, {k} "
              f"blocks a rank, {PP_MICRO} microbatches, {TP_TRAIN_STEPS} "
              f"steps from the seeded tree: losses {legs[0]['losses']} (rank "
              f"1 {legs[1]['losses']}) against tp 1's {ref['losses']}, "
              f"relative {[f'{e:.3e}' for e in loss_err]} (tolerance "
              f"{TP_TRAIN_LOSS_RTOL}); weights against tp 1's: largest "
              f"difference {max_err:.3e} in {at} (tolerance "
              f"{ADAM_BOUND * lr_sum:.3e}), {far} of {total} beyond 1 % of "
              f"the summed lr; weight bytes a rank "
              f"{[g['param_bytes'] for g in legs]}, AdamW bytes a rank "
              f"{[g['adam_bytes'] for g in legs]}; bytes staged through the "
              f"host a step {[g['staged'] for g in legs]}; peak device "
              f"bytes a rank {[g['peak_bytes'] for g in legs]}; stash "
              f"high-water mark a rank {[g['mark'] for g in legs]}; step_s "
              f"{[g['seconds'] for g in legs]}; flash launches a rank "
              f"{[g['counts'] for g in legs]} (host staging on one card, "
              f"read with 26 (c) beside) on {card}", flush=True)
        if (legs[0]["losses"] != legs[1]["losses"]
                or not max(loss_err) <= TP_TRAIN_LOSS_RTOL
                or not max_err <= ADAM_BOUND * lr_sum
                or any(g["counts"] != want for g in legs)
                or [g["mark"] for g in legs] != marks):
            bad.append(sched)
        out[f"train pp {PP} {sched} (26j)"] = {
            key: sum(g["counts"][c] for g in legs)
            for key, c in zip(FLASH_KERNELS, ("fwd", "dq", "dkv"))}
    if bad:
        raise AssertionError(f"26j: pp {PP} parts from tp 1 or its launches "
                             f"or stash marks are off: {bad}")
    return out


def _named_flax(model):
    """(flax path, parameter) of each of ``model``'s parameters."""
    from tf_operator_tpu_torch.models.convert import flax_path

    for name, p in model.named_parameters():
        yield flax_path(name), p.detach()


def weights_apart(got: dict, want: dict, lr_sum: float) -> tuple:
    """(largest difference, its parameter, elements beyond 1 % of
    ``lr_sum``, elements) of ``got`` ({flax path: tensor}) against
    ``want`` ({parameter name: tensor})."""
    from tf_operator_tpu_torch.models.convert import flax_path

    max_err, at, far, total = 0.0, None, 0, 0
    for name, w in want.items():
        diff = (got["/".join(flax_path(name))] - w).abs()
        err = float(diff.max())
        if err > max_err:
            max_err, at = err, name
        far += int((diff > 0.01 * lr_sum).sum())
        total += diff.numel()
    return max_err, at, far, total


def counts_of(rank: dict) -> dict:
    """A rank's flash counts by kernel name."""
    return {key: rank["counts"][c]
            for key, c in zip(FLASH_KERNELS, ("fwd", "dq", "dkv"))}


def start_tp_train_ranks(tmp: str, procs: list, logs: list) -> None:
    """Phase 26 (b)'s two gloo ranks (``tp_train_rank``), started on the
    card before (a) so that their imports, the world's join and the card's
    start-up overlap (a); each waits for ``tmp/go``. Appends the processes
    and their log paths to ``procs`` and ``logs``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in (
        "TF_CONFIG", "TPU_WORKER_ID", "TPU_NUM_PROCESSES",
        "TPU_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    port = free_port()
    with open(os.path.join(tmp, "cell.json"), "w") as f:
        json.dump({"lm": LM, "b": TRAIN_B, "t": TRAIN_T,
                   "chunk": XENT_CHUNK, "device": TP_TRAIN_DEVICE,
                   "ring": RING_CHECK}, f)
    for r in range(TP):
        rank_env = dict(env, TPU_NUM_PROCESSES=str(TP),
                        TPU_WORKER_ID=str(r),
                        TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        logs.append(os.path.join(tmp, f"tptrain{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.tp_train_rank(sys.argv[1]))",
                 tmp], cwd=root, env=rank_env, stdout=log,
                stderr=subprocess.STDOUT))


def tp_train_pair_phase(card: str, ref: dict, tmp: str, procs: list,
                        logs: list, t0: float) -> dict:
    """Phase 26 (b), (d), (e), (g), (h) and (j): the ranks
    ``start_tp_train_ranks`` started, told to go at ``t0``, against (a)'s
    and (f)'s runs. Returns {path label: the ranks' summed flash
    launches}."""
    codes = wait_all(procs, timeout=600.0)
    if codes != [0] * TP:
        raise AssertionError(f"26b: rc {codes}: " + "\n".join(
            read_log(p)[-3000:] for p in logs))
    ranks = []
    for r in range(TP):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    saved = {name: torch.load(os.path.join(tmp, name + ".pt"),
                              weights_only=True)
             for name in ("weights", "sp", "adafactor", "fsdp", "zero",
                          "ep")}
    wall = time.perf_counter() - t0
    want = ref["weights"]
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    max_err, at, far, total = weights_apart(saved.pop("weights"), want,
                                            lr_sum)
    loss_err = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                    ref["losses"])]
    steps_s = [float(np.median(r["seconds"][1:])) for r in ranks]
    pair_tok_s = TRAIN_B * TRAIN_T / max(steps_s)
    tp1_bytes = ref["param_bytes"]
    launches = {key: sum(r["counts"][c] for r in ranks)
                for key, c in zip(FLASH_KERNELS, ("fwd", "dq", "dkv"))}
    print(f"train tp 2 (26b): bf16 B={TRAIN_B} T={TRAIN_T} over {{'tp': "
          f"{TP}}} as 2 gloo processes on one card, {TP_TRAIN_STEPS} steps "
          f"from the seeded tree: losses {ranks[0]['losses']} (rank 1 "
          f"{ranks[1]['losses']}) against tp 1's {ref['losses']}, relative "
          f"{[f'{e:.3e}' for e in loss_err]} (tolerance "
          f"{TP_TRAIN_LOSS_RTOL}); gathered weights against tp 1's: largest "
          f"difference {max_err:.3e} in {at} (tolerance "
          f"{ADAM_BOUND * lr_sum:.3e}), {far} of {total} beyond 1 % of the "
          f"summed lr; weight bytes a rank {[r['param_bytes'] for r in ranks]}"
          f" against tp 1's {tp1_bytes} (ratio "
          f"{ranks[0]['param_bytes'] / tp1_bytes:.4f}), AdamW bytes a rank "
          f"{[r['adam_bytes'] for r in ranks]} against {2 * tp1_bytes}; "
          f"peak device bytes a rank {[r['peak_bytes'] for r in ranks]}; "
          f"flash launches a rank {[r['counts'] for r in ranks]}; bytes "
          f"staged through the host a step {[r['staged'] for r in ranks]}; "
          f"step_s {[r['seconds'] for r in ranks]}; the pair's tokens/s "
          f"{pair_tok_s:.2f} by the slower rank's median step (two ranks on "
          f"one card staging every collective through the host over gloo: "
          f"host staging, not what tp costs over NVLink; read with 26 (c) "
          f"running beside); {wall:.1f} s from go to the ranks' exit, the "
          f"ranks ready {[round(r['waited'], 1) for r in ranks]} s before "
          f"go (started before (a)) on {card}", flush=True)
    if (ranks[0]["losses"] != ranks[1]["losses"]
            or not max(loss_err) <= TP_TRAIN_LOSS_RTOL
            or not max_err <= ADAM_BOUND * lr_sum):
        raise AssertionError("tp 2 parts from tp 1")
    paths = sp_pair_checks(ranks, ref, saved, card)
    paths.update(sharded_pair_checks(ranks, ref, saved, card))
    paths.update(pp_pair_checks(ranks, ref, tmp, card))
    want_n = TP * LM["n_layers"] * TP_TRAIN_STEPS
    if set(launches.values()) != {want_n}:
        raise AssertionError(f"26b launches {launches}, want {want_n}")
    check_sp_launches(ranks)
    return {"train tp 2 (26b)": launches, **paths}


def check_sp_launches(ranks: list) -> None:
    """26 (d) and (e)'s launches, exactly: the ring's check one block pair
    a rank (rank i: i + 1), Ulysses' check one of each kernel a rank, the
    flash ring 8 x steps on rank 0 and 16 x
    steps on rank 1 (a causal ring of 2), Ulysses and Adafactor each
    kernel once a layer a step on each rank."""
    layers, bad = LM["n_layers"], []
    for i, r in enumerate(ranks):
        r = dict(r, ring_ulysses=r["ring"]["ulysses"])
        for leg, want_n in (("ring", i + 1), ("ring_ulysses", 1),
                            ("sp", layers * (i + 1) * TP_TRAIN_STEPS),
                            ("ulysses", layers * SP_ULYSSES_STEPS),
                            ("adafactor", layers * ADAFACTOR_STEPS)):
            if set(r[leg]["counts"].values()) != {want_n}:
                bad.append(f"rank {i} {leg} {r[leg]['counts']}, want "
                           f"{want_n} of each")
    if bad:
        raise AssertionError(f"26d/e launches: {bad}")


def sp_pair_checks(ranks: list, ref: dict, saved: dict, card: str) -> dict:
    """26 (d) and (e) from the ranks' numbers and rank 0's saved weights:
    printed, checked (an ``AssertionError`` on a failure) and returned as
    {path label: the ranks' summed flash launches}."""
    from tf_operator_tpu_torch.models.convert import flax_path

    ring = [r["ring"] for r in ranks]
    uly_fn = [r["ulysses"] for r in ring]
    print(f"ring flash check (26d i): ring_flash_attention over {{'sp': "
          f"{SP}}} at {list(RING_CHECK)} bf16, causal, forward and q/k/v "
          f"gradients, against flash_attention on the whole sequence: "
          f"max_abs_err by rank {[r['err'] for r in ring]}, shares of the "
          f"flash rule's bound {[r['share'] for r in ring]}; the ring's "
          f"launches by rank {[r['counts'] for r in ring]} (rank 0: the "
          f"diagonal block, the future one skipped; rank 1: the diagonal "
          f"and the past block) on {card}", flush=True)
    print(f"ulysses check (26d i): ulysses_attention on the same blocks "
          f"(each rank the whole sequence of {RING_CHECK[2] // SP} heads), "
          f"forward and q/k/v gradients through both all-to-alls, against "
          f"the same whole-sequence flash_attention: max_abs_err by rank "
          f"{[r['err'] for r in uly_fn]}, shares of the flash rule's bound "
          f"{[r['share'] for r in uly_fn]}; launches by rank "
          f"{[r['counts'] for r in uly_fn]} on {card}", flush=True)
    bad = [f"rank {i} {side} {o}" for i, r in enumerate(ring)
           for side, got in (("ring", r), ("ulysses", r["ulysses"]))
           for o, share in got["share"].items() if not share <= 1]
    if bad:
        raise AssertionError(f"26d (i): {bad}")
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    sp = [r["sp"] for r in ranks]
    uly = [r["ulysses"] for r in ranks]
    ada = [r["adafactor"] for r in ranks]
    max_err, at, far, total = weights_apart(saved["sp"], ref["weights"],
                                            lr_sum)
    loss_err = [abs(a - b) / abs(b) for a, b in zip(sp[0]["losses"],
                                                    ref["losses"])]
    uly_err = [abs(a - b) / abs(b) for a, b in zip(uly[0]["losses"],
                                                   ref["losses"])]
    print(f"train sp 2 (26d ii): bf16 B={TRAIN_B} T={TRAIN_T} over {{'sp': "
          f"{SP}}} (each rank T={TRAIN_T // SP} of each row, the whole model) "
          f"as (b)'s 2 gloo processes, ring_impl auto (the flash ring), "
          f"{TP_TRAIN_STEPS} steps from the seeded tree: losses "
          f"{sp[0]['losses']} (rank 1 {sp[1]['losses']}) against tp 1's "
          f"{ref['losses']}, relative {[f'{e:.3e}' for e in loss_err]} "
          f"(tolerance {TP_TRAIN_LOSS_RTOL}); weights against tp 1's: largest "
          f"difference {max_err:.3e} in {at} (tolerance "
          f"{ADAM_BOUND * lr_sum:.3e}), {far} of {total} beyond 1 % of the "
          f"summed lr; flash launches a rank {[r['counts'] for r in sp]}; "
          f"bytes staged through the host a step (the ring's K/V, dK/dV) "
          f"{[r['staged'] for r in sp]}, and a gradient all-reduce of "
          f"{sp[0]['grad_bytes']} bytes a step over gloo beside them; step_s "
          f"{[r['seconds'] for r in sp]}; peak device bytes a rank "
          f"{[r['peak_bytes'] for r in sp]} (two ranks on one card staging "
          f"the ring and the gradients through the host over gloo: host "
          f"staging, not what sp costs over NVLink; read with 26 (c) running "
          f"beside) on {card}", flush=True)
    print(f"train sp 2 ulysses (26d iii): {SP_ULYSSES_STEPS} step(s) from "
          f"the seeded tree: losses {uly[0]['losses']} (rank 1 "
          f"{uly[1]['losses']}) against tp 1's, relative "
          f"{[f'{e:.3e}' for e in uly_err]} (tolerance {TP_TRAIN_LOSS_RTOL});"
          f" flash launches a rank {[r['counts'] for r in uly]}; bytes staged"
          f" a step {[r['staged'] for r in uly]}; step_s "
          f"{[r['seconds'] for r in uly]} (with 26 (c) running beside) on "
          f"{card}", flush=True)
    if (sp[0]["losses"] != sp[1]["losses"]
            or not max(loss_err) <= TP_TRAIN_LOSS_RTOL
            or not max_err <= ADAM_BOUND * lr_sum):
        raise AssertionError("26d: sp 2 parts from tp 1")
    if (uly[0]["losses"] != uly[1]["losses"]
            or not max(uly_err) <= TP_TRAIN_LOSS_RTOL):
        raise AssertionError("26d: Ulysses parts from tp 1")
    # (e) each leaf by adafactor_bounds from its seeded rms and size.
    want = ref["adafactor"]
    ada_err = [abs(a - b) / abs(b) for a, b in zip(ada[0]["losses"],
                                                   want["losses"])]
    worst, beyond = (0.0, None), []
    apart_sq, worst_move = 0.0, (0.0, None)
    for name, w in want["weights"].items():
        path = "/".join(flax_path(name))
        diff = saved["adafactor"][path] - w
        rms_b, elem_b = adafactor_bounds(*ref["leaves"][path],
                                         ADAFACTOR_STEPS, TP_TRAIN_LR)
        rms = float(diff.square().mean().sqrt())
        elem = float(diff.abs().max())
        worst = max(worst, (rms / rms_b, name))
        if not (rms <= rms_b and elem <= elem_b):
            beyond.append((name, rms, rms_b, elem, elem_b))
        d_sq, m_sq = float(diff.square().sum()), want["move_sq"][name]
        apart_sq += d_sq
        worst_move = max(worst_move, (math.sqrt(d_sq / max(m_sq, 1e-30)),
                                      name))
    # A tp 2 state left at the seed reads 1.0: it is as far from tp 1's as
    # tp 1's moved.
    move_ratio = math.sqrt(apart_sq / sum(want["move_sq"].values()))
    print(f"train adafactor tp 2 (26e): bf16 B={TRAIN_B} T={TRAIN_T} over "
          f"{{'tp': {TP}}}, adafactor({TP_TRAIN_LR}) {ADAFACTOR_STEPS} steps "
          f"from the seeded tree: losses {ada[0]['losses']} (rank 1 "
          f"{ada[1]['losses']}) against tp 1's {want['losses']}, relative "
          f"{[f'{e:.3e}' for e in ada_err]} (tolerance {TP_TRAIN_LOSS_RTOL});"
          f" every leaf's rms and largest difference from tp 1's within "
          f"adafactor_bounds: {not beyond} (largest share of the rms bound "
          f"{worst[0]:.3e} in {worst[1]}); distance from tp 1's weights "
          f"over tp 1's move from the seed, all leaves {move_ratio:.4e} "
          f"(limit {ADAFACTOR_MOVE_RATIO}; a state left at the seed reads "
          f"1), largest leaf {worst_move[0]:.4e} in {worst_move[1]}; flash "
          f"launches a rank {[r['counts'] for r in ada]}; bytes staged a "
          f"step {[r['staged'] for r in ada]}; step_s "
          f"{[r['seconds'] for r in ada]} (with 26 (c) running beside) on "
          f"{card}", flush=True)
    if (ada[0]["losses"] != ada[1]["losses"]
            or not max(ada_err) <= TP_TRAIN_LOSS_RTOL or beyond
            or not move_ratio <= ADAFACTOR_MOVE_RATIO):
        raise AssertionError(f"26e: Adafactor tp 2 parts from tp 1: "
                             f"{beyond[:4]}, move ratio {move_ratio}")
    return {"train sp 2 ring flash (26d)": {
        k: sum(counts_of(r)[k] for r in sp) for k in FLASH_KERNELS},
        "train sp 2 ulysses (26d)": {
        k: sum(counts_of(r)[k] for r in uly) for k in FLASH_KERNELS},
        "train adafactor tp 2 (26e)": {
        k: sum(counts_of(r)[k] for r in ada) for k in FLASH_KERNELS}}


def sharded_pair_checks(ranks: list, ref: dict, saved: dict,
                        card: str) -> dict:
    """26 (g) and (h) from the ranks' numbers and rank 0's saved weights:
    printed, checked (an ``AssertionError`` on a failure) and returned as
    {path label: the ranks' summed flash launches}."""
    lr_sum = TP_TRAIN_LR * TP_TRAIN_STEPS
    whole = ref["param_bytes"]
    bad, paths = [], {}
    for name, label, ref_run in (
            ("fsdp", f"train fsdp {FSDP} (26g)", ref),
            ("zero", f"train zero1 dp {FSDP} (26g)", ref),
            ("ep", f"train moe ep {EP} (26h)", ref["moe"])):
        legs = [r[name] for r in ranks]
        max_err, at, far, total = weights_apart(saved[name],
                                                ref_run["weights"], lr_sum)
        loss_err = [abs(a - b) / abs(b) for a, b in zip(legs[0]["losses"],
                                                        ref_run["losses"])]
        what = {"fsdp": f"FSDP over {{'fsdp': {FSDP}}} (each rank B/{FSDP} "
                        "rows; weights and AdamW state cut)",
                "zero": f"ZeRO-1 over {{'dp': {FSDP}}} (each rank B/{FSDP} "
                        "rows; weights whole, AdamW state cut)",
                "ep": f"phase 22 (b)'s MoE cell over {{'ep': {EP}}} (both "
                      "ranks the whole batch; 4 of 8 experts a MoE layer a "
                      "rank)"}[name]
        extra = ""
        if name == "ep":
            extra = (f"aux {legs[0]['auxes']} against {ref_run['auxes']}; "
                     f"expert bytes a rank "
                     f"{[r['expert_bytes'] for r in legs]}; weight bytes "
                     f"against ep 1's {ref_run['param_bytes']}; ")
        print(f"{label}: bf16 B={TRAIN_B} T={TRAIN_T} {what} as (b)'s 2 "
              f"gloo processes, {TP_TRAIN_STEPS} steps from the seeded "
              f"tree: losses {legs[0]['losses']} (rank 1 "
              f"{legs[1]['losses']}) against the plain run's "
              f"{ref_run['losses']}, relative "
              f"{[f'{e:.3e}' for e in loss_err]} (tolerance "
              f"{TP_TRAIN_LOSS_RTOL}); gathered weights: largest difference "
              f"{max_err:.3e} in {at} (tolerance {ADAM_BOUND * lr_sum:.3e}), "
              f"{far} of {total} beyond 1 % of the summed lr; weight bytes a "
              f"rank {[r['param_bytes'] for r in legs]} (whole {whole} for "
              f"phase 9's cell), AdamW bytes a rank "
              f"{[r['adam_bytes'] for r in legs]}; {extra}peak device bytes "
              f"a rank {[r['peak_bytes'] for r in legs]}; bytes staged "
              f"through the host a step {[r['staged'] for r in legs]}; "
              f"flash launches a rank {[r['counts'] for r in legs]}; step_s "
              f"{[r['seconds'] for r in legs]} (two ranks on one card over "
              f"gloo, with 26 (c) running beside) on {card}", flush=True)
        if (legs[0]["losses"] != legs[1]["losses"]
                or not max(loss_err) <= TP_TRAIN_LOSS_RTOL
                or not max_err <= ADAM_BOUND * lr_sum):
            bad.append(f"{name}: parts from the plain run")
        want_n = LM["n_layers"] * TP_TRAIN_STEPS
        if any(set(r["counts"].values()) != {want_n} for r in legs):
            bad.append(f"{name} launches {[r['counts'] for r in legs]}, "
                       f"want {want_n} of each a rank")
        paths[label] = {k: sum(counts_of(r)[k] for r in legs)
                        for k in FLASH_KERNELS}
    fsdp, zero, ep = ([r[n] for r in ranks] for n in ("fsdp", "zero", "ep"))
    # About half of each under FSDP; whole weights and about half of the
    # moments under ZeRO-1 (leaves under 2**11 elements stay whole).
    if not all(r["param_bytes"] < 0.55 * whole
               and r["adam_bytes"] < 0.55 * 2 * whole for r in fsdp):
        bad.append("fsdp: a rank holds more than ~half")
    if not all(r["param_bytes"] == whole
               and r["adam_bytes"] < 0.55 * 2 * whole for r in zero):
        bad.append("zero: weights not whole or moments not ~half")
    # 276,960,256 parameters a rank, 134,217,728 of them its experts.
    if not all(r["param_bytes"] == 4 * 276_960_256
               and r["expert_bytes"] == 4 * 134_217_728 for r in ep):
        bad.append("ep: the experts are not split in half")
    if bad:
        raise AssertionError(f"26g/h: {bad}")
    return paths


def with_flags(args: list, **flags) -> list:
    """``args`` with each ``--flag value`` of ``flags`` (underscores for
    dashes) set, added when absent."""
    out = list(args)
    for name, value in flags.items():
        flag = "--" + name.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


def tp_entry_phase(card: str) -> dict:
    """Phase 26 (c): ``dist_lm --tp 2`` at ENTRY_ARGS: 2 ranks killed and
    resumed (bitwise their twin), 4 ranks as dp 2 x tp 2 beside the
    resume, the killed run's checkpoint restored at tp 1 in this process
    and by a tp 1 ``dist_lm``. Returns {path label: flash launches}."""
    from tf_operator_tpu_torch.models.convert import (
        _leaves,
        flax_path,
        init_params,
        load_params,
    )
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import checkpoint
    from tf_operator_tpu_torch.train.steps import TrainState, adamw

    module = "tf_operator_tpu_torch.train.dist_lm"
    tp2 = with_flags(ENTRY_ARGS, tp=TP, steps=TP_ENTRY_STEPS)
    procs: list = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck, twin = os.path.join(tmp, "ck"), os.path.join(tmp, "twin")
        one_dir = os.path.join(tmp, "tp1")
        try:
            first = start_ranks(module, tp2 + [
                "--checkpoint-dir", ck, "--fail-at-step",
                str(TP_ENTRY_FAIL_AT)], TP, tmp, "tpfirst", procs)
            third = start_ranks(module, tp2 + ["--checkpoint-dir", twin],
                                TP, tmp, "tptwin", procs)
            codes = wait_all(procs)
            procs.clear()
            if codes != [138, 138, 0, 0]:
                raise AssertionError(f"26c: rc {codes}: " + "\n".join(
                    read_log(p)[-2000:] for p in first + third))
            shutil.copytree(ck, one_dir)
            second = start_ranks(module, tp2 + [
                "--checkpoint-dir", ck, "--fail-at-step",
                str(TP_ENTRY_FAIL_AT)], TP, tmp, "tpsecond", procs)
            four = start_ranks(module, tp2, 2 * TP, tmp, "tpfour", procs)
            one = start_ranks(module, with_flags(
                ENTRY_ARGS, checkpoint_dir=one_dir,
                steps=TP_ENTRY_FAIL_AT + 2, target_loss=10), None, tmp,
                "tpone", procs)
            codes = wait_all(procs)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outs = {name: [read_log(p) for p in logs] for name, logs in (
            ("twin", third), ("second", second), ("four", four),
            ("one", one))}
        resumed = f"dist_lm: resumed from step {TP_ENTRY_FAIL_AT + 1}"
        if codes != [0] * 7 or not all(
                resumed in o and "dist_lm: OK" in o
                for o in outs["second"] + outs["one"]) or not all(
                f"process {r}/4, mesh {{'dp': 2, 'sp': 1, 'tp': 2}}" in o
                and "dist_lm: OK" in o
                for r, o in enumerate(outs["four"])):
            raise AssertionError(f"26c: rc {codes}: " + "\n".join(
                o[-2000:] for v in outs.values() for o in v))
        last = checkpoint.latest_step(ck)
        a = dict(_leaves(checkpoint.read(ck, last)[0]))
        b = dict(_leaves(checkpoint.read(twin, last)[0]))
        bitwise = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                               for k in a)
        printed = {name: [re.findall(r"step (\d+) loss=(\S+)", o)
                          + re.findall(r"(final) loss (\S+)", o)
                          for o in v] for name, v in outs.items()}
        # The killed run's checkpoint (step TP_ENTRY_FAIL_AT, written whole
        # by tp 2's rank 0) restored into a tp 1 state as dist_lm builds it.
        saved, _ = checkpoint.read(one_dir, TP_ENTRY_FAIL_AT)

        def arg(flag):
            return int(ENTRY_ARGS[ENTRY_ARGS.index(flag) + 1])

        d = arg("--d-model")
        cfg = TransformerConfig(
            vocab_size=arg("--vocab"), d_model=d, n_heads=ENTRY_HEADS,
            n_layers=arg("--layers"), d_ff=2 * d, max_seq_len=arg("--seq"),
            dtype=torch.float32)
        model = load_params(Transformer(cfg), init_params(cfg, 0))
        state = TrainState.create(model, adamw(3e-3))
        with checkpoint.CheckpointManager(one_dir) as mgr:
            mgr.restore(TP_ENTRY_FAIL_AT, state)
        restored_diff = []
        for name, p in model.named_parameters():
            path = flax_path(name)
            if not torch.equal(p.detach().cpu(), checkpoint._tree_get(
                    saved["params"], path)):
                restored_diff.append(name)
            for key in ("exp_avg", "exp_avg_sq"):
                if not torch.equal(state.optimizer.state[p][key].cpu(),
                                   checkpoint._tree_get(saved["opt"][key],
                                                        path)):
                    restored_diff.append(f"{key} {name}")
        del model, state
        launches = {
            "dist_lm tp 2 (26c)": rank_launches(first + third + second,
                                                "26c tp 2"),
            "dist_lm dp 2 x tp 2 (26c)": rank_launches(four,
                                                       "26c dp 2 x tp 2")}
    worst = max(abs(float(x[1]) - float(y[1])) for x, y in zip(
        printed["four"][0], printed["twin"][0]))
    same = all(p == printed["four"][0] for p in printed["four"])
    print(f"dist_lm tp 2 (26c): {' '.join(tp2)} --dist-backend gloo: run 1 "
          f"exited 138 at step {TP_ENTRY_FAIL_AT} on both ranks, run 2 "
          f"resumed from step {TP_ENTRY_FAIL_AT + 1}; the final checkpoint "
          f"(step {last}) "
          f"against the uninterrupted twin's: "
          f"{'bitwise' if bitwise else 'NOT bitwise'} ({len(a)} tensors); "
          f"printed losses resumed {printed['second'][0]}, twin "
          f"{printed['twin'][0]}; 4 ranks as dp 2 x tp 2 "
          f"{printed['four'][0]} (every rank the same: {same}), largest "
          f"difference from the twin {worst:.2e} (tolerance {DP_LOSS_TOL}); "
          f"the tp 2 checkpoint of step {TP_ENTRY_FAIL_AT} restored at tp 1: "
          f"{'bitwise the saved tree' if not restored_diff else restored_diff[:6]}"
          f", and a tp 1 dist_lm resumed from it ({printed['one'][0]}); "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    if (not bitwise or printed["second"][0][-1] != printed["twin"][0][-1]
            or not same or not worst <= DP_LOSS_TOL or restored_diff):
        raise AssertionError("26c: dist_lm --tp 2 fails its checks")
    return launches


def pp_entry_phase(card: str) -> dict:
    """Phase 26 (k), run in a thread beside 18 (b) (neither times
    anything): ``dist_lm --pp PP`` at ENTRY_ARGS by 1F1B at
    ``PP_ENTRY_MICRO`` microbatches as PP gloo ranks, killed at
    ``ENTRY_FAIL_AT`` and resumed; then ``serve_lm --from-pp PP`` over its
    checkpoint answers ``PP_PROMPT`` with ``PP_ANSWER``. Returns {path
    label: flash launches}."""
    module = "tf_operator_tpu_torch.train.dist_lm"
    args = with_flags(ENTRY_ARGS, pp=PP, pp_schedule="1f1b",
                      pp_microbatches=PP_ENTRY_MICRO)
    procs: list = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        logs: dict = {}
        try:
            for leg, kill in (("first", ["--fail-at-step",
                                         str(ENTRY_FAIL_AT)]),
                              ("second", [])):
                logs[leg] = start_ranks(module, args + [
                    "--checkpoint-dir", ck, *kill], PP, tmp, f"pp{leg}",
                    procs)
                codes = wait_all(procs)
                procs.clear()
                if codes != [138 if kill else 0] * PP:
                    raise AssertionError(f"26k {leg}: rc {codes}: " + "\n"
                                         .join(read_log(p)[-2000:]
                                               for p in logs[leg]))
            serve_log = start_ranks(
                "tf_operator_tpu_torch.serve.serve_lm", [
                    "--port", str(port := free_port()), "--checkpoint-dir",
                    ck, "--from-pp", str(PP), "--requests", "1",
                    *with_flags([], d_model=512, layers=2, vocab=256,
                                max_seq_len=128)],
                None, tmp, "ppserve", procs)[0]
            url = f"http://127.0.0.1:{port}"
            limit = time.monotonic() + 120
            while True:
                try:
                    http(url, "/healthz", timeout=5)
                    break
                except OSError:
                    if (procs[0].poll() is not None
                            or time.monotonic() > limit):
                        raise AssertionError(
                            f"26k: serve_lm --from-pp: "
                            f"{read_log(serve_log)[-2000:]}")
                    time.sleep(0.2)
            status, body = http(url, "/generate", {
                "tokens": [PP_PROMPT], "num_steps": len(PP_ANSWER)})
            code = wait_all(procs, timeout=60)[0]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outs = [read_log(p) for p in logs["second"]]
        served = read_log(serve_log)
        launches = {f"dist_lm pp {PP} 1f1b (26k)": rank_launches(
            logs["first"] + logs["second"], "26k")}
    printed = [re.findall(r"step (\d+) loss=(\S+)", o)
               + re.findall(r"(final) loss (\S+)", o) for o in outs]
    last = int(ENTRY_ARGS[ENTRY_ARGS.index("--steps") + 1]) - 1
    restored = (f"serve_lm: restored target checkpoint step {last} "
                f"(merged from pp={PP})")
    print(f"dist_lm pp {PP} (26k): {' '.join(args)} --dist-backend gloo: "
          f"killed at step {ENTRY_FAIL_AT} (exit 138 on both ranks) and "
          f"resumed from step {ENTRY_FAIL_AT + 1}; printed losses after the "
          f"resume {printed}; serve_lm --from-pp {PP} over its checkpoint: "
          f"{status} {body} for {PP_PROMPT} (want {PP_ANSWER}), exit {code};"
          f" launches {launches}; {time.perf_counter() - t0:.1f} s beside 18 "
          f"(b) on {card}", flush=True)
    resumed = f"dist_lm: resumed from step {ENTRY_FAIL_AT + 1}"
    if (not all(resumed in o and "dist_lm: OK" in o
                and f"process {r}/{PP}, mesh {{'dp': 1, 'sp': 1, 'tp': 1, "
                    f"'pp': {PP}}}" in o for r, o in enumerate(outs))
            or status != 200 or body["tokens"][0] != PP_ANSWER
            or code != 0 or restored not in served):
        raise AssertionError("26k: dist_lm --pp or serve_lm --from-pp fails "
                             "its checks: " + served[-2000:])
    return launches


def tp_train_phase(card: str, ahead: dict) -> dict:
    """Phase 26, (a) to (j), (l) and (m): (b)'s ranks started before (a)
    and waiting for it, (c) in a thread beside (b), (d) to (j); (f), (i)
    and (l) in this process after go; (m)'s ranks started at go, going
    once (c) is done and (l) has written its references; returns {path
    label: flash launches}. (k) runs beside 18 (b) (``pp_entry_phase``). Phase 27's
    serving workers start as (b)'s ranks end (``ahead["27"]``)."""
    from concurrent.futures import ThreadPoolExecutor

    from tf_operator_tpu_torch.serve.tp import prestart

    t0 = time.perf_counter()
    procs: list = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            logs: list = []
            start_tp_train_ranks(tmp, procs, logs)
            nccl, ref = tp_train_nccl_phase(card)
            with ThreadPoolExecutor(1) as pool:
                entry = pool.submit(tp_entry_phase, card)
                go = time.perf_counter()
                open(os.path.join(tmp, "go"), "w").close()
                # (m)'s ranks start after (a), whose step times they would
                # share the host with.
                a8i_procs, a8i_logs = [], []
                start_a8i_ranks(tmp, a8i_procs, a8i_logs)
                procs += a8i_procs
                world1 = sharded_world1_phase(card, ref, tmp)
                entry = entry.result()
            go_m = time.perf_counter()
            open(os.path.join(tmp, "go_m"), "w").close()
            pair = tp_train_pair_phase(card, ref, tmp, procs[:TP], logs,
                                       go)
            ahead["27"] = prestart(TP * DP, "cuda", "gloo", dp=DP)
            a8i = a8i_pair_phase(card, ref["a8i"], tmp, a8i_procs, a8i_logs,
                                 go_m)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    del ref
    print(f"phase 26 (tensor-, sequence-, fully sharded, expert- and "
          f"pipeline-parallel training): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"train tp nccl world 1 (26a)": nccl, **world1, **pair,
            **entry, **a8i}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

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

    t0 = time.perf_counter()
    comp, con_f32 = constrained_engine_phase(pa, i8, base, params, prompts)
    con_front = constrained_front_phase(pa, i8, base, params, prompts, card,
                                        comp)
    con_int8 = constrained_int8_phase(pa, i8, base, params, prompts, comp)
    print(f"phase 16 (constrained decoding): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    spec_b4, spec_kv8 = spec_phase(pa, base, params, prompts,
                                   f32["kernel"]["tokens"],
                                   bf16["decode_tok_s"], card)
    print(f"phase 17 (speculative decoding): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    flash_ckpt = ckpt_phase(lm_params, card)
    del lm_params
    # 26 (k) runs beside 18 (b): neither times anything.
    with ThreadPoolExecutor(1) as pool:
        pp_entry = pool.submit(pp_entry_phase, card)
        flash_entry = entry_point_phase(card)
        pp_entry = pp_entry.result()
    print(f"phase 18 (checkpoints, resume and eval; 26 (k) beside): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    shipped = ship_phase(pa, i8, base, params, prompts,
                         f32["kernel"]["tokens"], card)
    dense = dense_phase(pa, i8, base, params, prompts,
                        f32["kernel"]["tokens"], bf16, card)
    torch.cuda.empty_cache()
    resident = classifier_phase(card)
    torch.cuda.empty_cache()
    moe = moe_phase(pa, base, prompts, card)
    torch.cuda.empty_cache()
    flash_data = record_input_phase(card, resident)
    torch.cuda.empty_cache()
    flash_dp = dp_phase(card)
    torch.cuda.empty_cache()
    ref25: dict = {}
    # Serving workers started ahead of their worlds, by world.
    ahead: dict = {}
    try:
        tp = tp_phase(pa, i8, base, params, prompts, card, ref25, ahead)
        torch.cuda.empty_cache()
        tp_train = tp_train_phase(card, ahead)
        torch.cuda.empty_cache()
        tpdp = tpdp_phase(pa, i8, base, params, prompts, card, ref25, ahead)
        torch.cuda.empty_cache()
        tp_spec = tp_spec_phase(pa, i8, base, params, prompts, card, ref25,
                                ahead)
    finally:
        for spawned in ahead.values():
            spawned.discard()

    # Each kernel's launches on every path of this run that drives it.
    paths = {
        "paged_attend": {
            "engine f32 (6)": f32["kernel"]["launches"]["paged_attend"],
            "engine bf16 (7)": bf16["launches"]["paged_attend"], **sampled,
            "front f32 (15a)": front_f32, "front bf16 (15b)": front_bf16,
            "front faults f32 (15d)": front_faults,
            "constrained engine f32 (16a)": con_f32, **con_front,
            **spec_b4},
        "paged_attend_kv8": {
            "int8 engine f32 (12)": int8_f32["paged_attend_kv8"],
            "int8 engine bf16 (13)": int8_bf16["paged_attend_kv8"],
            "front int8 (15c)": front_int8["paged_attend_kv8"],
            "constrained int8 (16c)": con_int8["paged_attend_kv8"],
            **spec_kv8},
        "int8_matmul": {
            "int8 engine f32 (12)": (int8_f32["int8_matmul"]
                                     - int8_f32["int8_wgmma"]),
            "int8 engine bf16 (13)": (int8_bf16["int8_matmul"]
                                      - int8_bf16["int8_wgmma"]),
            **int8_gen["int8_matmul"],
            "front int8 (15c)": front_int8["int8_matmul"],
            "constrained int8 (16c)": con_int8["int8_matmul"]},
        "int8_matmul_prefill": {
            "int8 engine bf16 (13)": int8_bf16["int8_wgmma"],
            **int8_gen["int8_matmul_prefill"],
            "front int8 (15c)": front_int8["int8_matmul_prefill"],
            "constrained int8 (16c)": con_int8["int8_matmul_prefill"]},
    }
    for name, by_path in shipped.items():
        paths[name].update(by_path)
    for name in ("int8_matmul", "int8_matmul_prefill"):
        paths[name].update(dense[name])
    for name in flash_bf16:
        paths[name] = {"trainer f32 (8)": flash_f32[name],
                       "trainer bf16 (9)": flash_bf16[name],
                       "checkpoint + eval bf16 (18a)": flash_ckpt[name],
                       "entry point f32 (18b)": flash_entry[name]}
    for label, counts in moe.items():
        for name, n in counts.items():
            paths[name][label] = n
    for name, n in flash_data.items():
        paths[name]["dist_lm --data (23c)"] = n
    for label, counts in flash_dp.items():
        for name, n in counts.items():
            paths[name][label] = n
    for name, by_path in itertools.chain(tp.items(), tpdp.items(),
                                         tp_spec.items()):
        paths[name].update(by_path)
    for label, counts in itertools.chain(tp_train.items(),
                                         pp_entry.items()):
        for name, n in counts.items():
            paths[name][label] = n

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
