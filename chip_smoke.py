#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Device: the card's name, count and power limit.
2. Build: the seven CUDA libraries from ``src/repro_torch/csrc`` (one
   ``nvcc`` each, in parallel), with their ``-Xptxas -v`` register,
   shared-memory and spill lines.
3. Sandwich forward (two kernels: the truncated factors, then the row
   products) vs its plain twins at the three full-width sites of
   ``smollm-135m-butterfly`` (up/gate 576->1536, down 1536->576, lm_head
   576->49152) and the widest output the kernels take (32->262144): the
   factor kernel against ``sandwich_factors_plain`` within 1e-5, and the
   whole forward against the stage-by-stage ``sandwich_plain`` at 8, 8x4
   (the verify pass of ``spec_k`` 3), 8x16 and the training run's 8192 rows, float32 at 2e-4 and bfloat16 at 5e-2.
4. Paged decode kernels (the split over runs of 4 pages, then the
   combine) vs their plain twin: 8 slots, 3 KV heads, 3 query heads per
   group, head dim 64, pages of 16, at the serving engine's 512 positions
   and at a long 2048 (7,883 live positions), with a dirty trash page,
   stale rows and NaN pages past ``cur_pos``; float32 at 1e-5 and bfloat16
   at 2e-2; two launches bit-identical. The same at the zoo's decode
   shapes, 512 positions: OLMoE-1B-7B (16 KV heads, 1 query head each,
   head dim 128), DBRX-132B (8, 6, 128), Mistral-Large-123B (8, 12, 128),
   Gemma-7B (16, 1, 256: float32 rows take two vectors a lane),
   Gemma3-27B (16, 2, 128; also at the long 2048, its serving max_len),
   InternVL2-1B (2, 7, 64) and SeamlessM4T-medium (16, 1, 64).
5. Sandwich backward (six kernels: the factors again, the row products,
   the column products, their sum over row splits, the factor-row VJP, the
   reduction) vs its plain
   twin at the three sites, at 256 rows and at the training run's 8192 (the
   head at 2048: the plain twin's memory), and at ``bench_backward``'s 8192
   -> 8192 sandwich (k = 13, 64 rows), float32 at 1e-5 and bfloat16 at 8%
   of max|want|; two launches bit-identical. The factor-row VJP alone vs
   its twin (autograd through the plain factors) at each site, float32 at
   1e-5 of max|want|, two launches bit-identical.
5a. Widths past the smollm sites: the sandwich forward and backward at
   mistral-large-123b's ``down`` site (28,672 -> 12,288, n1 = 32,768, n2 =
   16,384, k = log2 n) at 64 rows, float32 and bfloat16, against the plain
   twins at the tolerances above; then the zoo's widest sites at 8 and 256
   rows: Gemma-7B's up/gate (3072 -> 24,576), down (24,576 -> 3072, n1 =
   32,768) and head (3072 -> 256,000, n2 = 262,144), OLMoE's head (2048 ->
   50,304), DBRX's (6144 -> 100,352), Gemma3-27B's up/gate (5376 ->
   21,504), down (21,504 -> 5376, n1 = 32,768) and head (5376 -> 262,144),
   RecurrentGemma-2B's up/gate (2560 -> 7680), down (7680 -> 2560) and
   head (2560 -> 256,000), xLSTM-125M's head (768 -> 50,304),
   InternVL2-1B's up/gate (896 -> 4,864), down and head (896 -> 151,655)
   and SeamlessM4T-medium's up (1,024 -> 4,096), down and head (1,024 ->
   256,206).
6. Serving: a ServeEngine on full-width ``smollm-135m-butterfly``
   (random weights from seed 0, bfloat16 compute, 8 slots, max_len 512,
   prefill chunks of 16, greedy) serves 16 requests with prompts of 5 to
   200 tokens and 32 new tokens each, every decode and chunk tick the
   replay of a CUDA graph captured once per key (the key's first tick is
   its warm-up, run eagerly, then the capture). Checks: every request gets
   its 32 tokens, the kernels' launch counters rose by 2 x 91 (sandwich:
   factors and rows) and 2 x 30 (paged: split and combine) per decode tick
   and 2 x 91 per chunk tick, every tick after a key's build is a replay
   of it, each key's graph holds its tick's launches, no NaN
   appears in the logits or the KV pool, and a pooled decode tick on live
   engine state agrees with the plain versions layer by layer: each of the
   30 layers and the head runs under both on the same input, within 5e-2
   in relative norm; a replay of the decode graph agrees with the same
   tick run eagerly through the kernels within 5e-2 in relative norm
   (whether bit for bit is printed). Prints each key's captures, replays,
   launches per replay and capture time, the graphs' shared pool (its
   segments in the allocator's snapshot), decode tok/s over all decode
   ticks and over the replays alone (a key's first tick, its warm-up and
   capture, is set-up). (The whole
   tick's logits through kernels and plain versions are printed, not
   held: bf16 rounding differences grow through a random-init stack.)
6e. The dense pool: phase 6's 16 requests on ``pool="dense"`` (a full
   512-position row per slot, whole prompts prefilled eagerly in
   power-of-two buckets from 8 to 512 and spliced into the slot, decode on
   one CUDA graph): phase 6's checks, with 2 x 91 sandwich launches per
   decode tick and per prefill and no paged launch, and its printed
   readings, each prefill's ms by prompt length among them.
6a. Greedy tokens on the card: ``smollm-135m-butterfly-smoke`` in float32
   compute, weights made once from seed 0 on the CPU, served by one engine
   on the card (the kernels, on graphs) and one on the CPU (the plain
   versions): 4 prompts (5, 23, 11 and 3 tokens) into 2 slots, prefill
   chunks of 16 (the 23-token prompt chunks twice), 16 new tokens each,
   three times: eager admission, incremental admission on 3 usable pages
   of 16 (at least one preemption and recompute required) and ``spec_k=3``
   speculative decoding; and a fourth time on the card through two
   replicas behind a ``Router`` on its driver thread, replica 0 swapping
   in mid-run a port-written checkpoint of the same weights whose newest
   step is torn (the swap must restore the older step), then the prompts
   again (some on the swapped replica). The tokens must be equal; at a
   flip the request, the step and the CPU run's top-1 minus top-2 logit
   gap there are printed and the phase fails; the card's sandwich and
   paged launch counters must rise.
6b. Incremental admission at full width: the 16 requests of phase 6 on a
   pool of 40 usable pages (a fifth of the dense-equivalent 256), on
   graphs: at least one preemption, every request finished, launch
   counters on the per-tick formula; ticks, preemptions, recompute tokens,
   peak pages, TTFT and decode tok/s printed, and how many bfloat16 tokens
   agree with phase 6's eager-admission run (not held: a recomputed prefix
   rounds otherwise than decoding did in bfloat16).
6c. Speculative decoding at full width: ``spec_k`` 3 on a probe engine's
   live state, the draft and verify graphs' replay against the same verify
   pass run eagerly through the kernels, within 5e-2 in relative norm
   (whether bit for bit is printed); then the 16 requests of phase 6 on
   graphs: every request finished, the launch counters on the formula
   (2 x 91 per verify and chunk tick, 2 x 3 head calls per draft, no paged
   launch: the verify reads the pool through the plain gather), each key's
   replays and launches per replay held; acceptance, tok/s and how many
   bfloat16 tokens agree with phase 6's run printed (not held).
6d. The serving tier at full width through the CLI,
   ``launch.serve.main`` in process: ``smollm-135m-butterfly`` in
   bfloat16, 2 replicas x 8 slots, max_len 512, 32 requests of 5-200
   uniform prompt tokens and 32 new tokens, open loop at 10 req/s, four
   times in turns: without a live ``Tracer``, with one (``--trace-out``),
   with one, without. Held: every request finished, no replica dead, each
   Chrome trace valid under ``repro_torch.obs.validate`` with one
   ``finish`` per request, and each run's launch counters (summed over
   both replicas: the counters are process-wide) equal to the per-tick
   formula summed over both engines' ticks. Printed per run: the router
   snapshot's TTFT and latency p50/p95 and dispatch, decode tok/s and the
   mean tick; then both means with and without the tracer, and the
   phase's seconds.
7. Timing: each forward kernel, its plain twin, and one library call as
   a yardstick the port never calls (for the sandwich a ``torch.matmul``
   by its materialized dense matrix, at 8 rows and at the training run's
   8192, each with its bound, by CUDA events; for the paged kernels
   ``scaled_dot_product_attention`` over gathered KV, at both shapes of 4,
   by device time from ``torch.profiler`` beside the CUDA-event figure over
   back-to-back calls, which the host's enqueue can set); each kernel's
   bound from its bytes and operations (the sandwich's on the support it
   needs) over the H100's 3.35 TB/s and peak rates.
8. Profile: ``torch.profiler`` over three pooled decode ticks replayed
   from the decode graph and three of the same ticks run eagerly through
   the kernels — device time by kernel and the device-busy share of the
   ticks' wall time; each sandwich and paged kernel's launches a tick in
   the graphed ticks' device trace must equal the decode graph's launches
   per replay.
9. Training: ``Trainer`` on full-width ``smollm-135m-butterfly`` (bf16
   compute, remat), seq_len 2048 x batch 4, 2 warm and 5 timed steps;
   finite losses, 2 x 181 forward and 6 x 91 backward sandwich launches
   per step; one more step under ``torch.profiler``.
10. Gradient checks of one step (seq_len 256, batch 1): each layer and the
    head under the kernels and the plain versions on the plain path's
    inputs and cotangents, every butterfly leaf within 5e-2 in relative
    norm; and the whole step in float32 compute, every butterfly leaf
    within 1e-3.
11. Timing of the backward kernels per train step, their plain twin, their
    bound, and the dense layer's backward by ``torch.matmul`` (``dx = g·W``,
    ``dW = gᵀ·x`` by the materialized W) as the yardstick, at 256 rows and
    at the training run's 8192.
12. Butterfly kernels (forward and backward) vs their plain twins at the
    encoder's 70,000 x 1024, Olivetti faces' 400 x 4096, 5 x 1024,
    1237 x 2048, 300 x 8192 and 64 x 32,768 (the widest the kernels take),
    both directions, float32 within 1e-5 and
    bfloat16 within 5e-2 of max|want|; the backward with and without dx,
    two launches bit-identical, its stage applications for the first row
    equal to ``stage_applies`` and at most 3p.
13. The encoder-decoder (paper §4) at the MNIST auto-encoder's shape:
    n = 784 (padded to 1024), d = 70,000, k = 32, on the stand-in
    ``synthetic_image_matrix(784, 70000, 0)``: the closed-form loss against
    the Theorem 1 prediction (rtol 1e-3), FJLT+PCA, and the two-phase row
    of ``launch.encdec`` (400 + 300 Adam steps) with finite losses, phase 1
    no better than the prediction, phase 2 within 1.02 of phase 1, and the
    butterfly launches the design implies; step time p50 and peak memory.
14. The same path through kernels and plain versions, float32: one
    gradient of B, E, D within 1e-4 and 10 phase-2 losses at rtol 1e-4.
15. Timing of the butterfly kernels at 70,000 x 1024: kernel, plain twin,
    bound, and for the forward a matmul by the materialized B, by device
    time beside CUDA events; then both kernels by device time at every
    shape of the butterfly checks.
16. Flash-attention kernels (forward, dq, dkv) vs their plain twins: o and
    lse, and dq/dk/dv for one dO, at (a) the training attention of
    ``smollm-135m-butterfly`` (B 4, H 9, S 2048, D 64, bf16, causal), (b)
    ``bench_backward``'s B 1, H 2, D 64, float32, causal at S 1024 and
    8192, (c) a ``gemma3-27b`` local layer (B 1, H 32, S 4096, D 128,
    window 1024, bf16), (d) B 2, H 3, S 1000, D 256, non-causal, float32,
    (e) D 8 and 192 at S 77, ``causal=False, window=24``, both dtypes;
    forward within 1e-5 (float32) / 2e-2 (bf16) of max|want|, lse 1e-5,
    gradients 1e-4 / 5e-2; two backward launches bit-identical.
17. The benches (``launch.speed``): every ``kernel/*``, ``speed/*`` and
    ``backward/*`` row at the reference's sizes, with the counts set to 0
    just before and read just after; every row present and timed, and the
    launches of every kernel equal to what the timed calls imply.
18. ``FlashFn`` through autograd at (a), kernels against plain twins, 1
    forward and 2 backward launches per call.
19. Timing of the flash kernels at (a) and (b): kernel, plain twin,
    bound, ``scaled_dot_product_attention`` forward and backward, and at
    (a) the port's plain ``_attend_masked`` in grouped layout; the three
    kernels and SDPA's forward and backward by device time beside their
    CUDA-event figures, the float32 kernels' bounds at the 3xTF32 rate
    (495/3 TFLOP/s) beside the CUDA-core ones.

20. The layer API (paper §3.2, Proposition 3.1): ``ButterflyLinear.
    from_dense`` of a seeded dense W at ``smollm-135m-butterfly``'s MLP up
    site (576 -> 1536, k = log2 n, with a bias) and the quickstart's 512 x
    512 at k = 64, the kernels' forward against ``to_dense() @ x`` (+ bias)
    within 2e-4 of max|want|; the quickstart's fit (X 1024 x 512, 300 Adam
    steps through ``SandwichFn``): its first step's forward and backward
    (k 64) through the kernels against the plain versions (2e-4; 1e-5 of
    max|want|, two backward launches bit-identical), the final loss below
    the first, 2 forward and 6 backward sandwich launches a step;
    Proposition 3.1's error at init, the parameter counts and the fit's
    step time printed.
21. The learned butterfly sketch (§6) at IVY19's HS-SOD matrix shape, 1024
    x 768, on the bench's synthetic ``hyper_like`` data: 24 train and 8
    test matrices, ell 20, k 10, batch 6, lr 3e-3, 120 steps, and the four
    baselines of ``sketch/*``. Held: every loss finite; the learned
    butterfly's test error below the same spec's untrained FJLT
    butterfly's and the Gaussian sketch's; the first step's loss and dw
    through the kernels against the plain twins within 1e-4 of max|want|;
    1 forward and 2 backward butterfly launches a step and a forward per
    test matrix. Printed: the errors, step time p50, peak memory, and one
    step under ``torch.profiler`` split into the butterfly kernels, the
    SVDs and the rest.
22. The gated butterfly (§7) on the card against the CPU (float32, 1e-5
    of max|want|) at 512 x 64 and 768 x 1024; the ``nonlinear/*`` rows
    (300 steps; the linear arm's first step, loss and dw at 512 x 64,
    through the kernels against the plain twins within 1e-5 of max|want|,
    and its butterfly launches held) and ``lm_butterfly/final_loss`` (60
    steps; the Trainer's first step on ``smollm-135m-butterfly-smoke``
    through the kernels against the plain versions, layer by layer and in
    float32, as in phase 10; finite losses, the sandwich launches of the
    butterfly variant's steps and the reference's parameter counts
    139,584 and 83,314 held). Each phase's seconds printed.

23. The training entry point and the execution context at full width:
    ``launch.train.main`` (seq_len 2048 x batch 4, bfloat16) 4 steps with a
    checkpoint every 2; a second run resumed from its step 2 in another
    directory ("resumed from step 2"), its two losses within 1e-6 relative
    of the first run's last two; 2 steps each with ``--grad-compression
    topk`` and ``int8`` (finite losses; one step's raw and wire bytes by
    ``compression_stats`` printed); the sandwich launches of every run on
    the per-step formula. Then the first step of ``Trainer.run`` for one
    built normally against one built inside ``use_execution("torch")``, at
    phase 10's float32 shape and seed: the second records ``torch`` and
    launches nothing; the loss and every butterfly leaf of Adam's first
    moment (the step's gradient, unclipped) within 1e-3; seed 0 is read.
    Then the butterfly backward at 70,000 x 1024 float32 under
    ``ExecutionContext(segment=4)``: dx and dw bit-identical to the unset
    field's; segments 1 and 10 refused, naming ROADMAP item 7, before any
    launch.

24. Serving the zoo at full width (ROADMAP 5a), phase 6's path and checks
    for each arch in turn, the other's weights freed first:
    ``olmoe-1b-7b-butterfly`` (16 layers, d_model 2048, 16 heads of 128,
    64 experts top-8, d_ff 1024, vocab 50,304; the sandwich on the head
    alone, MoE blocks having no MLP site) and ``gemma-7b-butterfly`` (28
    layers, d_model 3072, 16 heads of 256, GeGLU sandwiches 3072 -> 24,576
    -> 3072, a sandwich head to 256,000), random float32 weights from seed
    0 drawn on the CPU and moved (the seconds printed), bfloat16 compute,
    8 slots, max_len 512, pages and chunks of 16, greedy, eager admission,
    on CUDA graphs, 16 requests of 5-200 prompt tokens and 32 new. Held:
    every request finished; the launch counters on the per-tick formula
    (OLMoE 2 x 1 sandwich and 2 x 16 paged launches a decode tick, Gemma
    2 x 85 and 2 x 28); every tick after a key's build a replay; no NaN in
    the pool or the replayed logits; the live decode tick layer by layer
    against the plain versions and its replay against eager, within 5e-2
    in relative norm. Printed: init seconds, TTFT p50/p95, decode tok/s
    over all ticks and over replays, the mean replayed tick, peak memory.
    Then phase 8's profile of the arch's decode tick, graphed and eager,
    with the device time by kind (sandwich, paged, matmul, copy/cast,
    other).
25. Training the MoE: ``Trainer`` on ``olmoe-1b-7b-butterfly`` at full
    width, 4 of its 16 layers (Adam's state for all 16 would need ~110
    GB), seq_len 2048 x batch 4 (8,192 tokens, capacity 1,280 an expert),
    bfloat16 compute, remat, 2 warm and 3 timed steps. First its head's
    sandwich (2048 -> 50,304) against the plain versions at the run's
    shapes, float32 and bfloat16: the forward at 8,192 rows (two launches
    bit-identical, SANDWICH_TOL), the backward at 2,048 (HEAD_BWD_ROWS;
    GRAD_TOL). Then the run: every loss, ce and
    aux finite, 2 x 1 forward and 6 x 1 backward sandwich launches a step;
    step p50, tokens/s and peak memory printed.
26. Phase 6a's eager, incremental and ``spec_k=3`` token cases again on
    ``olmoe-1b-7b-butterfly-smoke`` in float32: the card's tokens equal to
    the CPU's; then the eager case on ``gemma3-27b-butterfly-smoke``
    (window 16, prompts of 5, 16, 20 and 40 tokens, max_len 64, whole
    prompts beside rings) and ``smollm-135m-butterfly-smoke`` on the dense
    pool, tokens equal; gemma3's incremental and ``spec_k=3`` engines are
    refused, as the reference refuses them.
27. Timing at the zoo's shapes (bfloat16): the paged kernel at each of
    phase 4's zoo shapes (device time, plain, SDPA, bound) and the sandwich
    forward at each zoo site at 8 rows (kernels, plain, a matmul by the
    dense matrix, bound).
28. ``gemma3-27b-butterfly`` served at full width (ROADMAP 5b; 62 layers,
    ten units of five ``local`` and one ``global`` and a two-layer
    ``local`` tail, d_model 5376, 32 heads and 16 KV heads of 128, GeGLU
    5376 -> 21,504, vocab 262,144, window 1,024), phase 24's path and
    checks with the other archs' weights freed first: random float32
    weights from seed 0, bfloat16 compute, 8 slots, max_len 2048 (rings of
    1,024 that wrap), pages of 16, greedy, eager admission of whole prompts
    at their exact lengths, decode on CUDA graphs; 16 requests of 32 new
    tokens, phase 6's twelve shortest prompts and four of 1,000, 1,020,
    1,300 and 1,500 tokens; the probe tick at positions 6 to 1,501, across
    the wrap. Held: every request finished; 2 x 187 sandwich launches per
    decode tick and per prefill, 2 x 10 paged per decode tick; every tick
    after the build a replay; no NaN in pages, rings or logits; the tick
    layer by layer and its replay against eager within 5e-2. Printed: as
    phase 24, each prefill's ms by prompt length, then phase 8's profile.
29. ``gemma3-27b-butterfly`` trained at 8 of its 62 layers (one unit and
    the two-layer tail: Adam's state for all would not fit), seq_len 2048
    x batch 2 (the window masks), bfloat16, remat, 2 warm and 3 timed
    steps, its sites first held against plain at the run's rows (forward
    4,096, the head's backward 2,048): finite losses, 2 x 49 forward and 6
    x 25 backward sandwich launches a step; step p50, tokens/s and peak
    memory printed.
30. The recurrent archs served at full width (ROADMAP 5c), phase 24's path
    and checks with the other archs' weights freed first, on the dense
    pool (recurrent state cannot be paged), whole prompts at their exact
    lengths, max_len 2048, 8 slots, decode on CUDA graphs; 16 requests of
    32 new tokens, phase 6's fourteen shortest prompts and two of 1,000
    and 1,500 tokens (past the mLSTM's chunk of 256 and not a multiple of
    it: the padded chunkwise prefill): ``recurrentgemma-2b-butterfly`` (26
    layers, eight units of two ``rec`` blocks and a ``local`` one and a
    two-layer ``rec`` tail, d_model and lru_width 2560, 10 heads and 1 KV
    head of 256, window 2,048, GeGLU 2560 -> 7680, vocab 256,000) and
    ``xlstm-125m-butterfly`` (12 layers, two units of five ``mlstm`` and
    one ``slstm``, d_model 768, 4 heads, mLSTM heads of 384, chunk 256,
    vocab 50,304; the head its only sandwich site). Held: every request
    finished; 2 x 79 (recurrentgemma) and 2 x 1 (xLSTM) sandwich launches
    per decode tick and per prefill, none paged; every tick after the
    build a replay; no NaN in any state stack; the tick layer by layer and
    its replay against eager within 5e-2 (the replay puts the recurrent
    state back). Printed: init seconds, TTFT p50/p95, decode tok/s over all
    ticks and over replays, the mean replayed tick, each prefill's ms by
    prompt length, peak memory, then phase 8's profile of the decode tick
    by kind, and the phase's seconds.
31. Both recurrent archs trained at all their layers: recurrentgemma at
    seq_len 2048 x batch 2, xLSTM at 1024 x 2 (four mLSTM chunks),
    bfloat16, remat, 2 warm and 3 timed steps, their sandwich sites first
    held against plain at the run's rows (forward at all of them, the
    head's backward at 2,048): finite losses, 2 x 157 forward and 6 x 79
    backward (recurrentgemma) and 2 x 1 and 6 x 1 (xLSTM) sandwich
    launches a step; the warm steps' ms, step p50, tokens/s, peak memory,
    for recurrentgemma one more step's device time by kernel and by kind
    (``torch.profiler``; xLSTM's ~200,000 launches a step would hold the
    profiler's event processing for minutes), and the phase's seconds
    printed.
32. Phase 26's eager token case on ``recurrentgemma-2b-butterfly-smoke``
    and ``xlstm-125m-butterfly-smoke`` in float32, prompts of 1, 2, 3 and
    20 tokens (shorter than the conv's history of 3 rows, and past the
    smoke mLSTM's chunk of 16), max_len 64, on the dense pool: the card's
    tokens equal to the CPU's; incremental admission and ``spec_k=3`` are
    refused, as the reference refuses them.
33. The frontend and encoder archs served at full width (ROADMAP 5d),
    phase 24's path and checks with the other archs' weights freed first,
    on phase 6's paged engine (8 slots, max_len 512, 16 requests of 5-200
    prompt tokens and 32 new, greedy), whole prompts in power-of-two
    buckets, each request's stub inputs drawn from the serving CLI's
    stream ``default_rng([0, 2])``: ``internvl2-1b-butterfly`` (24 layers,
    d_model 896, 14 heads and 2 KV heads of 64, SwiGLU 896 -> 4,864, vocab
    151,655; 256 patch embeddings projected and prepended to each prompt,
    so a slot's pages hold 768 positions) and
    ``seamless-m4t-medium-butterfly`` (a 12-layer bidirectional encoder
    over 1,536 frames inside each prefill, 12 ``xdec`` layers: paged
    self-attention, cross-attention to the encoder's rows cached dense per
    slot, GeLU MLP 1,024 -> 4,096; 16 heads of 64, vocab 256,206). Held:
    every request finished; 2 x 73 (InternVL) and 2 x 25 (Seamless)
    sandwich launches per decode tick and per prefill, plus 2 x 24 at the
    encoder's sites per Seamless prefill; 2 x 24 and 2 x 12 paged launches
    per decode tick; every tick after the build a replay; no NaN in pages,
    cross rows or logits; the tick layer by layer and its replay against
    eager within 5e-2. Printed: as phase 24, each prefill's ms by prompt
    length, then phase 8's profile of the decode tick by kind, and the
    phase's seconds.
34. Both trained at all their layers, seq_len 2048 x batch 2 text tokens
    (InternVL's 256 prefix tokens a sequence and Seamless's 1,536 frames
    besides, the trainer's stub inputs), bfloat16, remat, 2 warm and 3
    timed steps, their sandwich sites first held against plain at the
    run's rows (4,608 and 4,096; the head's backward at 2,048): finite
    losses, 2 x 145 forward and 6 x 73 backward (InternVL) and 2 x 73 and
    6 x 49 (Seamless: the encoder's 24 sites once, not checkpointed)
    sandwich launches a step; step p50, tokens/s, peak memory printed.
35. Phase 26's eager token case, on the paged and the dense pool, on
    ``internvl2-1b-butterfly-smoke`` and
    ``seamless-m4t-medium-butterfly-smoke`` in float32 with their stub
    inputs: the card's tokens equal to the CPU's; incremental admission
    and ``spec_k=3`` are refused, as the reference refuses them.
36. The launch tooling (ROADMAP item 7): ``repro_torch.launch.dryrun``
    over every registry arch x shape for one H100 (each step built and
    tallied on meta tensors, no allocation, no launch) into a temporary
    directory, its tables rendered by ``repro_torch.launch.report`` and
    printed (``dryrun |`` lines), its wall held under 60 s; its
    ``param_counts`` equal to the parameters of every full-width model the
    phases before built, its argument bytes no more than each of their
    runs' measured peak; the tile rule (``repro_torch.kernels.tuning``):
    every (kernel, n, dtype, mode) the phases launched (recorded from the
    libraries' entry points) named in ``cache_entries()``, each modeled
    shared-memory footprint within the device's opt-in limit, the
    butterfly backward's launched tiles and the flash backward's owned
    rows as the rule models them, a ``block_b`` the rule honours giving the
    default's bits and refused ones raising before any launch, and the
    Trainer's ``ExecutionRecord.tuning`` filled. Every bound the script
    prints comes from ``repro_torch.launch.roofline``.
37. Training on a butterfly data mesh (ROADMAP item 6a): two ranks of one
    world share the card over gloo (``repro_torch.runtime.dist.
    spawn_ranks``; NCCL refuses two ranks on one device); printed: the
    backend, each rank's device, the collectives gloo took on CUDA
    tensors, and a one-rank NCCL world's all_reduce with NCCL's version.
    ``sharded_sandwich_apply`` at the three full-width sites at 8,192 and
    8,191 rows and ``sharded_butterfly_apply`` at 70,000 x 1024 on a
    ``(2,)`` mesh against the unsharded kernel on the same inputs: the
    forward within rtol/atol 1e-5, dx and the weight gradients within
    1e-5 of max|want|, the ranks' results bit-identical, each rank's
    launches (one forward and one backward call's), the collectives'
    bytes and ms a call. ``smollm-135m-butterfly`` trained in float32 from
    seed 0 at 256 x 4 for 3 steps unsharded here, then on the mesh: the
    first loss within rtol 1e-4 and all within rtol 5e-3 / atol 1e-4,
    every butterfly leaf within 1e-3 relative norm, the ranks' parameters
    bit-identical, ``mesh_layout`` ``data=2``, each rank's sandwich
    launches a step the unsharded run's; step p50, peak memory and the
    all_reduce and gather ms a step per rank. The training CLI with
    ``--simulated-devices 2 --mesh-shape 2 --device cuda`` on the smoke
    arch as a subprocess: rc 0, its ``[train]`` lines. The phase's seconds
    (budget 90).
38. Sharded serving (ROADMAP item 6b): ``smollm-135m-butterfly`` at full
    width and depth in float32 from seed 0 on the paged pool (8 slots,
    max_len 512, chunks of 16), 8 greedy requests of 5 to 200 prompt
    tokens and 16 new tokens each, first unsharded (graphed) here, then
    on a ``(2,)`` mesh of two ranks sharing the card over gloo, rank 0
    submitting through its ``MeshServe`` and rank 1 following
    (``repro_torch.launch.mesh_check.serve``): every rank's tokens equal
    to the unsharded engine's, the ranks' tokens and ticks equal, each
    rank's decode tick at 2 x 91 sandwich and 2 x 30 paged launches and
    91 gathers; printed: the decode tick's p50 on the mesh and
    unsharded, the gathers' share of a tick, peak MiB a rank. The serving
    CLI with ``--simulated-devices 2 --mesh-shape 2 --replicas 2`` on the
    smoke arch as a subprocess: rc 0, its header ending ``mesh=data=2``,
    every request served. The phase's seconds (budget 120). Phase 36 also
    runs the dry-run on the production meshes (``--mesh all``) and prints
    each cell's argument bytes a card and fit on ``pod16x16`` and
    ``pod2x16x16``.
39. Expert parallelism and the GPipe pipeline (ROADMAP item 6d), on two
    ranks sharing the card over gloo, spawned once
    (``repro_torch.launch.mesh_check.ep_pipeline``): OLMoE-1B-7B's MoE
    layer (d_model 2048, 64 experts, top 8, d_ff 1024, capacity 1.25) on
    a ``(model,)`` mesh of 2, in float32 at 8 x 2048 tokens (two chunks of
    8,192) and in bfloat16 at 4 x 2048, against the port's one-rank
    ``moe_apply`` run chunk by chunk: output, aux loss and every gradient
    within 1e-4 of max|want| (float32) or 5e-2 relative norm (bfloat16);
    ``olmoe-1b-7b-butterfly`` at 2 of its 16 layers in float32, 2 x 1024
    tokens, one forward and backward on the mesh against the same model
    without it: loss and every butterfly leaf's gradient within 1e-3, the
    head's sandwich launches as unsharded; ``smollm-135m-butterfly``'s
    residual MLP block (576 -> 1536 -> 576 through the sandwich kernels)
    stacked over 2 stages through ``pipeline_apply`` on a ``(stage,)``
    mesh, x 8 x 256 x 576, 4 microbatches, against ``reference_apply``:
    forward within 2e-4 and every gradient within 1e-3 of max|want|, each
    rank's launches those of its 4 stage calls. Printed: each part's ms a
    call on the mesh and alone, the all-reduces' and the handover's
    calls, bytes and seconds (the handover an all-gather: gloo takes no
    point-to-point operations on CUDA tensors). The phase's seconds
    (budget 90).

The script refuses to start when ``REPRO_KERNEL_BACKEND`` names anything
but ``auto`` or ``cuda``: the plain versions would stand in for the
kernels. Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without the last line; so does a machine without a CUDA
device or a directory without ``src/repro_torch``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PROFILE_TRIES = 3         # device_ms: profiler windows read before events
# the times that device_ms took by CUDA events, the profiler having seen
# no device time
EVENT_FALLBACKS: list = []
SANDWICH_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
FACTOR_TOL = 1e-5         # the factors are float32 in both routes
WIDEST = ("widest", 32, 262144)   # n2 = 4096 x 64, the kernels' limit
# mistral-large-123b's down site (configs/mistral_large_123b.py: d_ff 28,672
# -> d_model 12,288): n1 = 32,768, the sandwich kernels' widest input
WIDE = ("mistral_down", 28672, 12288)
WIDE_ROWS = 64
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SLOTS, MAX_LEN, CHUNK, NEW_TOKENS, N_REQUESTS = 8, 512, 16, 32, 16
SPEC_K = 3                # draft tokens per slot tick of the speculative run
# incremental admission's pool: 40 usable pages of 16 (plus the trash page),
# a fifth of the dense-equivalent 8 x 512 / 16 = 256
INCR_PAGES = 41
LAYER_TOL = 5e-2          # bf16 model checks, relative norm per layer
# the paged kernel's shapes (cur_pos per slot, pages of 16): the serving
# engine's (max_len 512) and a long one at the 2048-token context of
# SmolLM-135M, the training run's seq_len (7,883 live positions)
PAGED_SHAPES = (("serve", (0, 15, 16, 100, 255, 300, 511, 47), MAX_LEN),
                ("long", (2047, 2000, 1500, 1024, 777, 511, 16, 0), 2048))


def say(*parts) -> None:
    sys.stdout.write(" ".join(str(p) for p in parts) + "\n")
    sys.stdout.flush()


def sites(cfg) -> dict:
    """The sandwich sites of ``cfg``: name -> (site key, n_in, n_out)."""
    E, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    return {"up_gate": ("mlp_up", E, F), "down": ("mlp_down", F, E),
            "lm_head": ("lm_head", E, V)}


# the block types with an MLP (an ``moe`` block has the MoE instead, the
# xLSTM blocks neither); an encoder's ``enc`` layers have one too
# (:func:`enc_sites`)
MLP_BLOCKS = ("attn", "local", "global", "rec", "xdec")


def mlp_layers(cfg) -> int:
    """The layers of ``cfg`` that run an MLP."""
    from repro_torch.models import lm
    return sum(t in MLP_BLOCKS for t in lm.layer_types(cfg))


def called_sites(cfg) -> tuple:
    """The names of :func:`sites` that a forward pass of ``cfg`` calls: the
    MLP's where ``mlp`` is a butterfly site and some layer has an MLP
    (:data:`MLP_BLOCKS`), and the head where ``lm_head`` is one and not
    tied."""
    bc = cfg.butterfly
    if bc is None:
        return ()
    mlp = "mlp" in bc.sites and mlp_layers(cfg) > 0
    head = "lm_head" in bc.sites and not cfg.tie_embeddings
    return ("up_gate", "down") * mlp + ("lm_head",) * head


def enc_sites(cfg) -> int:
    """Sandwich sites of the encoder, which runs once per whole-prompt
    prefill and per training forward (not checkpointed): its layers' MLP
    sites, which share the decoder's site keys."""
    if "down" not in called_sites(cfg) or not cfg.n_enc_layers:
        return 0
    per_layer = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    return per_layer * cfg.n_enc_layers


def with_extras(np, cfg, prompts, seed: int = 0) -> list:
    """``(prompt, extras)`` pairs: a frontend arch's stub inputs for each
    prompt, drawn as the serving CLI draws them
    (``np.random.default_rng([seed, 2])``); ``None`` for a text-only arch."""
    from repro_torch.serve.trace import stub_extras
    xrng = np.random.default_rng([seed, 2])
    return [(p, stub_extras(cfg, xrng)) for p in prompts]


def train_rows(cfg, seq_len: int, batch: int) -> int:
    """Rows of a train step's decoder sites: a vision arch's prefix tokens
    ride with the text."""
    front = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    return batch * (seq_len + front)


def sandwich_sites(cfg) -> tuple:
    """(sandwich sites a forward pass calls, those inside the layers): up,
    gate and down per MLP layer at :func:`called_sites`' MLP
    (``gelu_mlp`` has no gate), and the head."""
    called = called_sites(cfg)
    per_layer = 0
    if "down" in called:
        per_layer = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    in_layers = per_layer * mlp_layers(cfg)
    return in_layers + int("lm_head" in called), in_layers


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Device milliseconds per call of ``fn``: the durations of the kernels
    and copies it launches, read from ``torch.profiler`` over ``reps``
    calls after ``warm`` calls. Unlike :func:`cuda_ms`, the host's enqueue
    rate cannot set it: gaps between launches do not count. The profiler
    records a window of ``reps`` calls after a window of as many that it
    traces and drops: without it the profiler lost some of the first
    calls' kernels, and at a window's edge it may still drop one or carry
    one over. So each kernel's mean duration counts as many times a call
    as it ran per call, rounded (a kernel seen fewer than reps/2 times is
    a stray and does not count); a window with no device time is read
    again, up to PROFILE_TRIES times. Where every window came back empty
    (CUPTI now and then delivers no device records, for a whole run of
    windows), the call is timed with CUDA events instead (:func:`cuda_ms`,
    host gaps included, so never below the device time), said on a line of
    its own and counted in :data:`EVENT_FALLBACKS`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = sum(e.self_device_time_total / e.count * round(e.count / reps)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count)
        if us:
            return us / 1e3
        say(f"device_ms: no device time over {reps} calls; read again")
    ms = cuda_ms(torch, fn, reps=reps, warm=0)
    EVENT_FALLBACKS.append(ms)
    say(f"device_ms: the profiler saw no device time over {reps} calls in "
        f"each of {PROFILE_TRIES} windows; timed by CUDA events instead: "
        f"{ms:.4f} ms")
    return ms


def clocks(dev) -> str:
    """The card's SM clock and power draw now, for a timing line (calls
    land on cards at other clocks); empty off the card."""
    if dev.type != "cuda":
        return ""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return f"; SM clock, power after: {out}"


def allclose_or_raise(torch, what, got, want, tol) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol·|want|
    everywhere and ``got`` is finite."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    limit = tol + tol * want.abs()
    if not bool((err <= limit).all()):
        rel = float((got - want).norm() / want.norm())
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} "
                             f"beyond atol=rtol={tol} (relative norm "
                             f"{rel:.3e}, {int((err > limit).sum())} of "
                             f"{err.numel()} outside)")
    return float(err.max())


# -- phases -----------------------------------------------------------------

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # the plain float32 twins and the encoder-decoder's products must stay
    # float32: no TF32 in matmuls or convolutions (set and checked)
    from repro_torch.launch.encdec import full_float32
    full_float32()
    say("device:", torch.cuda.get_device_name(0), "| count:",
        torch.cuda.device_count(), "| torch", torch.__version__, "cuda",
        torch.version.cuda)
    say(smi)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    logs = build.build()
    say(f"build: {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill", "smem")):
                say(f"ptxas[{name}]: {line.strip()}")
    for name in ("butterfly", "butterfly_bwd"):
        say(f"ptxas[{name}] spills: {ptxas_spills(logs[name])}")


def ptxas_spills(log: str) -> str:
    """The kernels of one ``-Xptxas -v`` report with their spill stores:
    how many kernels, the most registers one uses, and each that spills."""
    import re
    kernels, spills, regs = 0, [], 0
    name = "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, kernels = m.group(1), kernels + 1
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            spills.append(f"{name} {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
    return (f"{kernels} kernels, at most {regs} registers, "
            + (f"spill stores in {len(spills)}: " + "; ".join(spills)
               if spills else "no spill stores"))


def sandwich_site(torch, cfg, site: str, dev):
    """Spec and random weights of one full-width sandwich site."""
    from repro_torch.models import common as cm
    from repro_torch.nn import ButterflyLinear
    key, n_in, n_out = sites(cfg)[site]
    bc = cfg.butterfly
    spec = cm.site_butterfly_spec(bc.seed, key, n_in, n_out, bc.k_factor,
                                  bc.use_bias)
    layer = ButterflyLinear(spec, generator=torch.Generator().manual_seed(7))
    return spec, layer.to(dev)


def sandwich_call(torch, spec, layer, x, backend):
    from repro_torch.kernels import sandwich as ks
    return ks.sandwich_forward(
        x, layer.b_in, layer.core, layer.b_out, layer.idx_in, layer.idx_out,
        scale_in=spec.scale_in, scale_out=spec.scale_out, n_out=spec.n_out,
        context=backend)


def phase_sandwich_factors(torch, cfg, dev, kernel: str) -> float:
    """The factor kernel against its plain twin at the three full-width
    sites and the widest output, for both dtypes the weights are rounded
    to: F_in and F_out within FACTOR_TOL (atol = rtol)."""
    from repro_torch.core import layers as blayers
    from repro_torch.kernels import sandwich as ks
    from repro_torch.nn import ButterflyLinear
    worst = 0.0
    cases = [(site, *sandwich_site(torch, cfg, site, dev)) for site in
             sites(cfg)]
    name, n_in, n_out = WIDEST
    gen = torch.Generator().manual_seed(11)
    spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
    cases.append((name, spec, ButterflyLinear(spec, generator=gen).to(dev)))
    for site, spec, layer in cases:
        for dtype in ("float32", "bfloat16"):
            got, want = (ks.sandwich_factors(
                layer.b_in.detach(), layer.b_out.detach(), layer.idx_in,
                layer.idx_out, n_in=spec.n_in, n_out=spec.n_out,
                dtype=getattr(torch, dtype), context=b)
                for b in (kernel, "torch"))
            sync(torch, dev)
            errs = [allclose_or_raise(
                torch, f"sandwich factors {site} {dtype} {part}", g, w,
                FACTOR_TOL) for part, g, w in zip(("F_in", "F_out"), got,
                                                   want)]
            say(f"sandwich factors {site:8s} {dtype:9s} F_in "
                f"{tuple(got[0].shape)} F_out {tuple(got[1].shape)}: "
                f"max|err| {errs[0]:.3e} / {errs[1]:.3e} (tol {FACTOR_TOL})")
            worst = max(worst, *errs)
    return worst


def phase_sandwich(torch, cfg, dev, kernel: str, train_rows: int) -> float:
    """The forward kernel against its plain twin at the three full-width
    sites: the decode, verify and chunk ticks' rows and the training
    run's."""
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for site in sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            for rows in sorted({SLOTS, SLOTS * (SPEC_K + 1), SLOTS * CHUNK,
                                train_rows}):
                for dtype in ("float32", "bfloat16"):
                    x = torch.randn(rows, spec.n_in, generator=gen).to(
                        dev, getattr(torch, dtype))
                    got = sandwich_call(torch, spec, layer, x, kernel)
                    want = sandwich_call(torch, spec, layer, x, "torch")
                    sync(torch, dev)
                    err = allclose_or_raise(
                        torch, f"sandwich {site} rows={rows} {dtype}", got,
                        want, SANDWICH_TOL[dtype])
                    say(f"sandwich {site:8s} rows={rows:4d} {dtype:9s} "
                        f"max|err|={err:.3e} (tol {SANDWICH_TOL[dtype]})")
                    if dtype == cfg.compute_dtype:
                        worst = max(worst, err)
    return worst


def paged_inputs(torch, cfg, dtype, dev, seed=2, shape=PAGED_SHAPES[0]):
    """q, pools, page table and cur_pos at one of PAGED_SHAPES (the
    engine's decode shape by default), with a dirty trash page, stale rows
    and NaN pages past cur_pos."""
    from repro_torch.kernels import paged_attention as pa
    KV, D = cfg.n_kv_heads, cfg.head_dim_
    G = cfg.n_heads // KV
    _, cur, max_len = shape
    ps, P = 16, max_len // 16
    gen = torch.Generator().manual_seed(seed)
    N = 1 + SLOTS * P
    k_pool = torch.randn(N, ps, KV, D, generator=gen)
    v_pool = torch.randn(N, ps, KV, D, generator=gen)
    ids = (torch.randperm(N - 1, generator=gen) + 1).reshape(SLOTS, P)
    cur = torch.tensor(cur)
    k_pool[pa.TRASH_PAGE] = 1e4
    v_pool[pa.TRASH_PAGE] = -1e4
    for b in range(SLOTS):
        last, off = int(cur[b]) // ps, int(cur[b]) % ps + 1
        k_pool[ids[b, last], off:] = 7e3
        v_pool[ids[b, last], off:] = -7e3
        for p in range(last + 1, P):
            k_pool[ids[b, p]] = float("nan")
            v_pool[ids[b, p]] = float("nan")
    q = torch.randn(SLOTS, KV, G, D, generator=gen)
    return [q.to(dev, dtype), k_pool.to(dev, dtype), v_pool.to(dev, dtype),
            ids.int().to(dev), cur.int().to(dev)]


def check_paged(torch, pcfg, dev, kernel: str, shape, dtype: str,
                label: str) -> float:
    """The paged kernels against their plain twin on :func:`paged_inputs`
    of ``pcfg`` (its KV heads, group and head dim) at ``shape``: two
    launches bit-identical, within PAGED_TOL[dtype]; prints one line and
    returns max|err|."""
    from repro_torch.kernels import paged_attention as pa
    args = paged_inputs(torch, pcfg, getattr(torch, dtype), dev, shape=shape)
    got = pa.paged_decode_attention(*args, context=kernel)
    again = pa.paged_decode_attention(*args, context=kernel)
    want = pa.paged_decode_attention(*args, context="torch")
    sync(torch, dev)
    if not torch.equal(got, again):
        raise AssertionError(f"paged {label} {dtype}: two launches differ")
    err = allclose_or_raise(torch, f"paged {label} {dtype}", got, want,
                            PAGED_TOL[dtype])
    say(f"paged {label} B={SLOTS} {tuple(args[0].shape)} ps=16 "
        f"P={args[3].shape[1]} {dtype:9s} max|err|={err:.3e} (tol "
        f"{PAGED_TOL[dtype]}); two launches bit-identical")
    return err


def phase_paged(torch, cfg, dev, kernel: str, zoo_archs=(),
                long_archs=()) -> float:
    """The paged kernels against their plain twin (:func:`check_paged`) at
    PAGED_SHAPES, both dtypes; then at the serving shape for each of
    ``zoo_archs``' decode shapes (KV heads, group, head dim), and at the
    long shape for ``long_archs``. Returns the worst error in the compute
    dtype at the serving shape."""
    from repro_torch.configs import registry
    cases = [(cfg, shape, f"{shape[0]:5s}") for shape in PAGED_SHAPES]
    for arch, shape in ([(a, PAGED_SHAPES[0]) for a in zoo_archs]
                        + [(a, PAGED_SHAPES[1]) for a in long_archs]):
        z = registry.get(arch)
        cases.append((z, shape, f"{arch} KV={z.n_kv_heads} "
                      f"G={z.n_heads // z.n_kv_heads} D={z.head_dim_}"))
    worst = 0.0
    with torch.no_grad():
        for pcfg, shape, label in cases:
            for dtype in ("float32", "bfloat16"):
                err = check_paged(torch, pcfg, dev, kernel, shape, dtype,
                                  label)
                if dtype == cfg.compute_dtype and shape is PAGED_SHAPES[0]:
                    worst = max(worst, err)
    return worst


_MODELS = {}
# phase 36's records: each full-width model the phases built (name ->
# (config, parameters)) and each run's measured peak (kind, config,
# (seq_len, batch), peak bytes)
BUILT: dict = {}
PEAKS: list = []


def built(cfg, model) -> None:
    BUILT[cfg.name] = (cfg, sum(p.numel() for p in model.parameters()))


def model_of(cfg, dev):
    """The served model: random weights from seed 0, built once per run."""
    from repro_torch.serve import loader
    if (cfg, dev) not in _MODELS:
        _MODELS.clear()
        _MODELS[cfg, dev] = loader.init_params(cfg, seed=0, device=dev)
        built(cfg, _MODELS[cfg, dev])
    return _MODELS[cfg, dev]


def layerwise_check(torch, eng, kernel: str) -> None:
    """The pooled decode tick ``eng`` would run next, one layer at a time
    on a copy of its KV pool: each layer, then the final norm and head, runs
    under ``kernel`` and under the plain versions on the same input, the
    plain path's state, so each comparison sees one layer's rounding and
    not its growth through the stack after it; a recurrent layer's state,
    which a step advances, is copied for each path. Each output must be finite
    and within 5e-2 of the plain one in relative norm, |got - want| /
    |want|. The norm, not a per-element bound: the residual add can cancel
    large terms, so one bfloat16 step of a term (8 at magnitude 1024) may
    land on a small output element."""
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serve import steps
    cfg, model, tol = eng.cfg, eng.model, LAYER_TOL
    tokens, cur_pos, active = (torch.from_numpy(a).to(eng.device)
                               for a in eng.decode_inputs())
    table = eng.pool.gather_args().get("page_table")      # None: dense pool
    if table is not None:
        table = steps.mask_table(table, active)
    caches = {t: c.clone() for t, c in eng.caches.items()}
    index = lm.cache_index(cfg)
    positions = cur_pos[:, None].contiguous()
    pairs = []

    def own(cache):
        return ({f: t.clone() for f, t in cache.items()}
                if isinstance(cache, dict) else cache)

    with torch.no_grad():
        x = cm.embed(cfg, model.embed, tokens[:, None])
        for i, layer in enumerate(model.layers):
            cache = lm.layer_cache(cfg, caches, i, index)
            got, want = (lm.layer_apply(cfg, layer, x, positions=positions,
                                        cache=own(cache), page_table=table,
                                        context=b)[0]
                         for b in (kernel, "torch"))
            pairs.append((f"layer {i}", got.float(), want.float()))
            x = want
        h = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
        got, want = (cm.head_apply(cfg, model.head, h, b)[:, 0]
                     for b in (kernel, "torch"))
        pairs.append(("logits", got.float(), want.float()))
    rel = [float((g - w).norm() / w.norm()) for _, g, w in pairs]
    big = [float((g - w).abs().max()) for _, g, w in pairs]
    say(f"decode tick layer by layer, kernels vs plain on the same input, "
        f"relative norm of the difference per layer: "
        f"{' '.join(f'{e:.1e}' for e in rel[:-1])}; logits {rel[-1]:.3e}; "
        f"tol {tol}; max|err| {max(big):.3e} ({pairs[big.index(max(big))][0]})"
        f", logits {big[-1]:.3e} at |logit| max "
        f"{float(pairs[-1][2].abs().max()):.2f}")
    for (what, got, _), r in zip(pairs, rel):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode tick {what}: not finite")
        if not r <= tol:
            raise AssertionError(f"decode tick {what}: relative norm of the "
                                 f"difference {r:.3e} beyond {tol}")


def replay_vs_eager(torch, eng, kernel: str) -> dict:
    """The next pooled decode tick's logits through a replay of the engine's
    decode graph (``replay_decode_logits``) against the same tick run
    eagerly through the kernels (``decode_logits``), on the same state:
    finite and within ``LAYER_TOL`` in relative norm; reports whether they
    are bit for bit."""
    eager = eng.decode_logits(context=kernel)
    graph = eng.replay_decode_logits()
    if not bool(torch.isfinite(graph).all()):
        raise AssertionError("replayed decode logits are not finite")
    g, e = graph.float(), eager.float()
    out = {"rel": float((g - e).norm() / e.norm()),
           "max_abs": float((g - e).abs().max()),
           "bitwise": bool(torch.equal(graph, eager))}
    say(f"decode tick replay vs eager ({kernel}), {eng.cfg.compute_dtype}: "
        f"relative norm of the difference {out['rel']:.3e} (tol "
        f"{LAYER_TOL}), max|err| {out['max_abs']:.3e}, bit for bit: "
        f"{out['bitwise']}")
    if not out["rel"] <= LAYER_TOL:
        raise AssertionError(f"replayed decode logits differ from the eager "
                             f"tick by {out['rel']:.3e} in relative norm")
    return out


def paged_layers(eng) -> int:
    """The layers whose decode reads ``eng``'s pool through the paged
    kernels: the full-attention ones on a paged pool (a ``local`` layer's
    ring and the dense pool's rows take the plain dense branch, as in the
    reference), none on a dense pool."""
    return paged_per_tick(eng.cfg) if eng.pool.kind == "paged" else 0


def paged_per_tick(cfg) -> int:
    """Paged kernel calls a decode tick of ``cfg`` on the paged pool makes:
    one per full-attention layer (``local`` layers read their rings)."""
    from repro_torch.models import lm
    return sum(t != "local" for t in lm.layer_types(cfg))


def serve_launches_want(cfg, snap, on_card: bool, spec_k: int = 0,
                        paged=None, prefills: int = 0) -> dict:
    """Kernel launches a serving run must count: the sandwich's
    ``FWD_KERNELS`` at every site (up, gate, down per layer and the head)
    per decode (or verify) and chunk tick and per whole-prompt prefill
    (``prefills``, each one call a site, and one at each of the encoder's
    sites, :func:`enc_sites`), and at the head ``spec_k`` times
    per speculative tick's draft; the paged kernels' ``PAGED_KERNELS`` per
    paged layer (``paged``, all ``cfg.n_layers`` by default;
    :func:`paged_layers`) per decode tick (a verify pass reads the pool
    through the plain gather, as the chunk does); none off the card."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    per_tick, in_layers = sandwich_sites(cfg)
    decode = snap["decode_steps"]
    paged = cfg.n_layers if paged is None else paged
    return {"sandwich_fwd": on_card * ks.FWD_KERNELS
            * (per_tick * (decode + snap["chunk_ticks"] + prefills)
               + enc_sites(cfg) * prefills
               + spec_k * (per_tick - in_layers) * decode),
            "paged_decode_attention": on_card * pa.PAGED_KERNELS
            * paged * decode * (not spec_k)}


def read_launches() -> dict:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    return {"sandwich_fwd": ks.sandwich_forward.launches,
            "paged_decode_attention": pa.paged_decode_attention.launches}


def zero_launches() -> None:
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    ks.sandwich_forward.launches = 0
    pa.paged_decode_attention.launches = 0


def graph_report(eng, snap, on_card: bool) -> dict:
    """Print each graph key's captures, replays, kernel launches per replay
    and warm-up and capture seconds, and the graphs' shared pool; hold the
    replays to the ticks (every tick after a key's build is a replay) and,
    on the card, each key's launches per replay to the per-tick formula."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    cfg, stats = eng.cfg, eng.graphs.stats()
    ticks = {"decode": snap["decode_steps"], "chunk_prefill":
             snap["chunk_ticks"], "spec_draft": snap["decode_steps"],
             "spec_verify": snap["decode_steps"]}
    # (sandwich, paged) launches of one replay: every site of the model, or
    # the head alone spec_k times in the draft; the paged kernels in the
    # decode tick only
    sites_ = ks.FWD_KERNELS * sandwich_sites(cfg)[0]
    per_replay = {"decode": (sites_, pa.PAGED_KERNELS * paged_layers(eng)),
                  "chunk_prefill": (sites_, 0), "spec_verify": (sites_, 0),
                  "spec_draft": (ks.FWD_KERNELS * eng.spec_k * (
                      sandwich_sites(cfg)[0] - sandwich_sites(cfg)[1]), 0)}
    for key, st in stats.items():
        say(f"graph {key}: captures {st['captures']}, replays "
            f"{st['replays']}, launches per replay "
            f"{st['launches_per_replay']}, warm-up {st['warmup_s']:.3f} s, "
            f"capture {st['capture_s']:.3f} s")
        kind = key.split(" | ")[0]
        if st["replays"] != ticks[kind] - 1:
            raise AssertionError(f"graph {key}: {st['replays']} replays for "
                                 f"{ticks[kind]} ticks")
        want = dict(zip(("sandwich_fwd", "paged_decode_attention"),
                        per_replay[kind]))
        if on_card and st["launches_per_replay"] != want:
            raise AssertionError(f"graph {key}: launches per replay "
                                 f"{st['launches_per_replay']}, expected "
                                 f"{want}")
    pool = eng.graphs.pool_bytes()
    capture = sum(st["capture_s"] for st in stats.values())
    say(f"graphs: {len(stats)} keys, capture {capture:.3f} s in all, shared "
        f"graph pool " + ("not measured (the allocator's snapshot names no "
                          "pools)" if pool is None else
                          f"{pool / 2**20:.1f} MiB (its segments in the "
                          f"allocator's snapshot)"))
    return {"pool_bytes": pool, **{
        key: {n: st[n] for n in ("replays", "launches_per_replay",
                                 "capture_s")} for key, st in stats.items()}}


def serve_prompts(np, cfg, long=()):
    """Phase 6's prompt lengths (16 from 5 to 200) in a seeded order and
    their tokens; ``long`` lengths take the places of the longest."""
    rng = np.random.default_rng(0)
    lens = np.linspace(5, 200, N_REQUESTS).astype(int)
    if long:
        lens = np.concatenate([lens[:N_REQUESTS - len(long)], long])
    lens = rng.permutation(lens)
    return lens, [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]


# phase 6's engine: the paged pool at max_len 512, prompts into chunks;
# ``probe`` the probe engine's prompt lengths (None: 5 to 12 tokens, cut
# from the run's prompts), ``long`` the run's long prompts
SERVE_PAGED = dict(pool="paged", max_len=MAX_LEN, long=(), probe=None)
# phase 6e: the same requests on the dense pool (a full row per slot,
# whole prompts in power-of-two buckets from 8 to 512)
SERVE_DENSE = dict(SERVE_PAGED, pool="dense")


def phase_serve(torch, np, cfg, dev, kernel: str, tag: str = "",
                sizes=SERVE_PAGED) -> tuple:
    """The main path's serving run on ``cfg``: a probe engine's live decode
    tick held layer by layer and as a replay against eager, then 16
    requests to completion with the counts set to 0 just before and read
    just after. ``sizes`` (:data:`SERVE_PAGED`) sets the pool, ``max_len``
    and the long prompts; a run that admits whole prompts prints each
    prefill's time by its length (its engine's tracer spans). Returns
    (launches, summary, tokens); ``tag`` names the run in its lines
    (``serve <tag>:``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.obs import Tracer
    from repro_torch.serve import Request, ServeEngine

    head = f"serve {tag}:" if tag else "serve:"
    geometry = dict(slots=SLOTS, max_len=sizes["max_len"],
                    pool=sizes["pool"], prefill_chunk=CHUNK, device=dev)
    t0 = time.monotonic()
    model = model_of(cfg, dev)
    init_s = time.monotonic() - t0
    say(f"{head} init: {init_s:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters "
        f"({cfg.param_dtype}, drawn on the CPU and moved)")
    lens, prompts = serve_prompts(np, cfg, sizes["long"])
    per_tick = sandwich_sites(cfg)[0]     # up, gate, down per layer + head

    # kernels vs plain on live engine state (also warms the path up)
    probe = ServeEngine(cfg, model, **geometry)
    whole = probe.prefill_chunk is None          # whole-prompt admission
    if sizes["probe"]:
        rng = np.random.default_rng(5)
        probe_prompts = [rng.integers(0, cfg.vocab_size, n)
                         for n in sizes["probe"]]
    else:                                  # <= 12 tokens: one chunk each
        probe_prompts = [prompts[n][:5 + n] for n in range(SLOTS)]
    for p, x in with_extras(np, cfg, probe_prompts, seed=5):
        probe.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS, extras=x))
    probe.step()
    if sizes["probe"]:
        ring = probe.caches.get("ring_k")
        say(f"{head} probe tick at positions "
            f"{probe.decode_inputs()[1].tolist()} (ring "
            f"{'none' if ring is None else ring.shape[2]})")
    layerwise_check(torch, probe, kernel)
    # the whole tick through both paths, for the record only: rounding
    # differences of bf16 compound over the random-init layer stack
    auto = probe.decode_logits(context=kernel)
    plain = probe.decode_logits(context="torch")
    sync(torch, dev)
    say(f"decode-tick logits through all {cfg.n_layers} layers, kernels vs "
        f"plain (not held): max|err|="
        f"{float((auto.float() - plain.float()).abs().max()):.3e}, "
        f"argmax agrees on {int((auto.argmax(-1) == plain.argmax(-1)).sum())}"
        f" of {SLOTS} slots")
    replay = replay_vs_eager(torch, probe, kernel)
    del probe

    # the main path: counters from 0, 16 requests to completion
    tracer = Tracer() if whole else None
    eng = ServeEngine(cfg, model, tracer=tracer, **geometry)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS,
                               extras=x))
            for p, x in with_extras(np, cfg, prompts)]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = eng.metrics.snapshot()
    tokens = [f.result(timeout=0).tokens for f in futs]
    for i, toks in enumerate(tokens):
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"request {i}: {len(toks)} tokens, "
                                 f"expected {NEW_TOKENS}")
    on_card = dev.type == "cuda"       # on the CPU the plain versions run
    want = serve_launches_want(cfg, snap, on_card, paged=paged_layers(eng),
                               prefills=snap["prefills"] * whole)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    for name, pool in eng.caches.items():
        if not bool(torch.isfinite(pool).all()):
            raise AssertionError(f"non-finite values in the {name} pool")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    PEAKS.append(("serve", cfg, (sizes["max_len"], SLOTS), peak))
    say(f"{head} {N_REQUESTS} requests, prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens, {snap['ticks']} ticks "
        f"({snap['chunk_ticks']} chunk, {snap['decode_steps']} decode), "
        f"wall {wall:.3f} s, on graphs ({eng.compile_stats['compiles']} "
        f"built); pool {eng.pool.kind}, max_len {eng.max_len}, "
        f"{'whole-prompt prefill' if whole else f'chunks of {CHUNK}'}")
    say(f"{head} TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s over all decode ticks, "
        f"{snap['decode_tok_per_s_steady']:.1f} tok/s over the replays; "
        f"{snap['build']['ticks']} ticks built a graph, "
        f"{snap['build']['time_s']:.3f} s in all (set-up); peak memory "
        f"{peak / 2**20:.1f} MiB")
    m = eng.metrics
    replayed = (m.decode_time_s - m.build_decode_time_s) * 1e3 / (
        m.decode_steps - 1)
    say(f"{head} decode ticks, host clock: {replayed:.3f} ms a replayed "
        f"tick on average over {m.decode_steps - 1}; the "
        f"decode key's build tick (warm-up + capture) "
        f"{m.build_decode_time_s * 1e3:.3f} ms")
    prefill_ms = {}
    if whole:
        spans = [e for e in tracer.events() if e["name"] == "prefill"]
        prefill_ms = {int(e["args"]["tokens"]): e["dur"] / 1e3
                      for e in sorted(spans, key=lambda e: e["args"]
                                      ["tokens"])}
        say(f"{head} whole-prompt prefill ms by prompt length (host clock, "
            f"eager, the splice and first token included): "
            + ", ".join(f"{n}: {ms:.1f}" for n, ms in prefill_ms.items()))
    enc = (f" + {ks.FWD_KERNELS} x {enc_sites(cfg)} encoder sites x whole "
           f"prefills" if enc_sites(cfg) else "")
    say(f"{head} launches {launches} = {ks.FWD_KERNELS} x {per_tick}/tick x "
        f"(decode + chunk + whole prefills {snap['prefills'] * whole})"
        f"{enc}, {pa.PAGED_KERNELS} x {paged_layers(eng)}/decode tick")
    graphs = graph_report(eng, snap, on_card)
    summary = {"ttft_p50_ms": snap["ttft_ms"]["p50"],
               "ttft_p95_ms": snap["ttft_ms"]["p95"],
               "tpot_p50_ms": snap["tpot_ms"]["p50"],
               "decode_tok_per_s": snap["decode_tok_per_s"],
               "decode_tok_per_s_steady": snap["decode_tok_per_s_steady"],
               "build_s": snap["build"]["time_s"],
               "replayed_decode_tick_ms": replayed,
               "peak_mib": peak / 2**20, "wall_s": wall,
               "ticks": snap["ticks"], "graphs": graphs, "init_s": init_s,
               "replay_vs_eager": replay}
    if whole:
        summary["prefill_ms_by_len"] = prefill_ms
    return launches, summary, tokens


def phase_serve_incremental(torch, np, cfg, dev, eager_tokens) -> dict:
    """The main path's 16 requests under incremental admission on a pool of
    ``INCR_PAGES - 1`` usable pages, a fifth of the dense-equivalent 256:
    at least one preemption, every request finished with its tokens, the
    launch counters on the per-tick formula. Prints how many tokens agree
    with the eager-admission run (not held: in bfloat16 a recomputed prefix
    rounds otherwise than decoding did)."""
    from repro_torch.serve import Request, ServeEngine
    _, prompts = serve_prompts(np, cfg)
    eng = ServeEngine(cfg, model_of(cfg, dev), slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, num_pages=INCR_PAGES,
                      admission="incremental", device=dev)
    sync(torch, dev)
    zero_launches()
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
            for p in prompts]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = eng.metrics.snapshot()
    tokens = [f.result(timeout=0).tokens for f in futs]
    if any(len(t) != NEW_TOKENS for t in tokens):
        raise AssertionError("incremental run: a request came back short")
    if snap["preempted"] < 1:
        raise AssertionError(f"incremental run on {INCR_PAGES - 1} pages "
                             f"preempted nothing")
    want = serve_launches_want(cfg, snap, dev.type == "cuda")
    if launches != want:
        raise AssertionError(f"incremental run: launch counts {launches}, "
                             f"expected {want}")
    same = sum(a == b for x, y in zip(tokens, eager_tokens)
               for a, b in zip(x, y))
    whole = sum(x == y for x, y in zip(tokens, eager_tokens))
    total = sum(map(len, tokens))
    say(f"serve incremental: {INCR_PAGES - 1} usable pages, {snap['ticks']} "
        f"ticks ({snap['chunk_ticks']} chunk, {snap['decode_steps']} "
        f"decode), {snap['preempted']} preemptions, "
        f"{snap['recompute_tokens']} recompute tokens, peak pages "
        f"{snap['pool']['pages_hwm']}, max concurrent slots "
        f"{snap['max_concurrent_slots']}, wall {wall:.3f} s")
    say(f"serve incremental: TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s over all decode ticks, "
        f"{snap['decode_tok_per_s_steady']:.1f} over the replays; launches "
        f"{launches}")
    say(f"serve incremental: {cfg.compute_dtype} tokens equal to the eager "
        f"admission run at {same} of {total} positions, {whole} of "
        f"{len(tokens)} requests whole (not held)")
    return {"incr_ticks": snap["ticks"], "incr_preempted": snap["preempted"],
            "incr_recompute_tokens": snap["recompute_tokens"],
            "incr_pages_hwm": snap["pool"]["pages_hwm"],
            "incr_decode_tok_per_s": snap["decode_tok_per_s"],
            "incr_decode_tok_per_s_steady": snap["decode_tok_per_s_steady"],
            "incr_ttft_p50_ms": snap["ttft_ms"]["p50"],
            "incr_ttft_p95_ms": snap["ttft_ms"]["p95"],
            "incr_tokens_agree": same, "incr_tokens": total}


def verify_replay_vs_eager(torch, eng, kernel: str) -> dict:
    """The next speculative tick's verify logits through replays of the
    engine's draft and verify graphs (``replay_verify_logits``) against the
    verify pass run eagerly through the kernels on the same drafts
    (``verify_logits``), on the same state: finite and within ``LAYER_TOL``
    in relative norm; reports whether they are bit for bit."""
    tokens, graph = eng.replay_verify_logits()
    eager = eng.verify_logits(tokens, context=kernel)
    if not bool(torch.isfinite(graph).all()):
        raise AssertionError("replayed verify logits are not finite")
    g, e = graph.float(), eager.float()
    out = {"rel": float((g - e).norm() / e.norm()),
           "max_abs": float((g - e).abs().max()),
           "bitwise": bool(torch.equal(graph, eager))}
    say(f"verify tick replay vs eager ({kernel}), {eng.cfg.compute_dtype}, "
        f"{tuple(tokens.shape)} tokens: relative norm of the difference "
        f"{out['rel']:.3e} (tol {LAYER_TOL}), max|err| "
        f"{out['max_abs']:.3e}, bit for bit: {out['bitwise']}")
    if not out["rel"] <= LAYER_TOL:
        raise AssertionError(f"replayed verify logits differ from the eager "
                             f"pass by {out['rel']:.3e} in relative norm")
    return out


def phase_serve_spec(torch, np, cfg, dev, kernel: str, eager_tokens) -> dict:
    """The main path's 16 requests with ``spec_k = SPEC_K`` at full width,
    on graphs (the draft through the butterfly head, the verify in one
    batched pass). First, on a probe engine's live state, a replay of the
    draft and verify graphs against the same verify pass run eagerly
    (:func:`verify_replay_vs_eager`). Then every request finished with its
    tokens, the launch counters on the formula and every graph key's
    replays and launches per replay held; acceptance, tok/s and how many
    bfloat16 tokens agree with the eager-admission run printed (not held:
    the verify pass's products have other shapes than a decode tick's, so
    they round otherwise)."""
    from repro_torch.serve import Request, ServeEngine
    model = model_of(cfg, dev)
    _, prompts = serve_prompts(np, cfg)
    probe = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                        prefill_chunk=CHUNK, spec_k=SPEC_K, device=dev)
    for n in range(SLOTS):
        probe.submit(Request(prompt=prompts[n][:5 + n],
                             max_new_tokens=NEW_TOKENS))
    probe.step()                     # the chunk, then the first spec tick
    replay = verify_replay_vs_eager(torch, probe, kernel)
    del probe
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, spec_k=SPEC_K, device=dev)
    sync(torch, dev)
    zero_launches()
    futs = [eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
            for p in prompts]
    t0 = time.monotonic()
    eng.run_until_idle()
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches()
    snap = eng.metrics.snapshot()
    tokens = [f.result(timeout=0).tokens for f in futs]
    if any(len(t) != NEW_TOKENS for t in tokens):
        raise AssertionError("speculative run: a request came back short")
    want = serve_launches_want(cfg, snap, dev.type == "cuda", SPEC_K)
    if launches != want:
        raise AssertionError(f"speculative run: launch counts {launches}, "
                             f"expected {want}")
    graph_report(eng, snap, dev.type == "cuda")
    same = sum(a == b for x, y in zip(tokens, eager_tokens)
               for a, b in zip(x, y))
    whole = sum(x == y for x, y in zip(tokens, eager_tokens))
    total = sum(map(len, tokens))
    sp = snap["spec"]
    say(f"serve spec_k={SPEC_K}: {snap['ticks']} ticks ({snap['chunk_ticks']}"
        f" chunk, {snap['decode_steps']} speculative), acceptance "
        f"{sp['acceptance_rate']} ({sp['accepted_draft_tokens']} of "
        f"{sp['draft_tokens']} drafts), {sp['tokens_per_slot_tick']} tokens "
        f"per slot tick, wall {wall:.3f} s")
    say(f"serve spec_k={SPEC_K}: TTFT p50 {snap['ttft_ms']['p50']} ms, p95 "
        f"{snap['ttft_ms']['p95']} ms; TPOT p50 {snap['tpot_ms']['p50']} ms; "
        f"decode {snap['decode_tok_per_s']:.1f} tok/s over all speculative "
        f"ticks, {snap['decode_tok_per_s_steady']:.1f} over the replays; "
        f"launches {launches}")
    say(f"serve spec_k={SPEC_K}: {cfg.compute_dtype} tokens equal to the "
        f"eager admission run at {same} of {total} positions, {whole} of "
        f"{len(tokens)} requests whole (not held)")
    return {"spec_ticks": snap["ticks"],
            "spec_acceptance": sp["acceptance_rate"],
            "spec_tokens_per_slot_tick": sp["tokens_per_slot_tick"],
            "spec_decode_tok_per_s": snap["decode_tok_per_s"],
            "spec_decode_tok_per_s_steady": snap["decode_tok_per_s_steady"],
            "spec_ttft_p50_ms": snap["ttft_ms"]["p50"],
            "spec_tokens_agree": same, "spec_tokens": total,
            "spec_replay_vs_eager": replay}


TOKEN_ARCH = "smollm-135m-butterfly-smoke"
TOKEN_PROMPTS = (5, 23, 11, 3)   # tests/test_torch_serve.py's greedy prompts
TOKEN_NEW = 16
# the token runs' engines: eager admission; incremental admission on 3
# usable pages of 16 tokens (two requests' whole budgets do not fit, so
# decoding slots are preempted and recomputed: twice on the CPU); eager
# with 3 drafts a tick
TOKEN_CASES = {"eager": {},
               "incremental": dict(admission="incremental", num_pages=4),
               "spec": dict(spec_k=3),
               "router": {},
               "dense": dict(pool="dense")}
# phase 6a's cases; the dense pool's is phase 26's
PHASE_6A = ("eager", "incremental", "spec", "router")
# phase 26's windowed arch (window 16): prompts below, at and past it
WINDOW_PROMPTS = (5, 16, 20, 40)
# phase 32's recurrent archs: prompts shorter than the conv's three rows of
# history, at them, and past the smoke mLSTM's chunk of 16
RECURRENT_PROMPTS = (1, 2, 3, 20)
# the router case's driver watchdog: above a first-use nvcc build
TICK_TIMEOUT = 120.0


def serve_router_tokens(cfg, dev, model, prompts) -> tuple:
    """The router token case on ``dev``: two replicas (each its own copy of
    ``model``'s weights) behind a ``Router`` on its driver thread. The
    prompts are submitted; replica 0 then swaps in a checkpoint written
    by the port's ``CheckpointManager`` in the trainer's layout from the
    same weights, steps 1 and 2 with step 2 torn, so the swap must restore
    step 1; then the prompts again, some dispatched to the swapped
    replica. Returns ``(first round's tokens, second round's tokens, the
    router's snapshot)``; raises unless the swap restored step 1, no
    replica died and the swapped replica served in the second round."""
    import copy
    import tempfile

    from repro_torch import convert
    from repro_torch.checkpoint.checkpointing import CheckpointManager
    from repro_torch.serve import Request, Router, ServeEngine
    from repro_torch.serve import tear_checkpoint
    engines = [ServeEngine(cfg, copy.deepcopy(model), slots=2, max_len=48,
                           prefill_chunk=16, device=dev, replica=i)
               for i in range(2)]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        mgr = CheckpointManager(ckpt)
        tree = {"params": convert.to_jax_params(
            dict(model.named_parameters()), cfg)}
        mgr.save(1, tree)
        mgr.save(2, tree)
        tear_checkpoint(ckpt)
        with Router(engines, tick_timeout=TICK_TIMEOUT) as router:
            first = [router.submit(Request(prompt=p,
                                           max_new_tokens=TOKEN_NEW))
                     for p in prompts]
            step = router.swap_checkpoint(0, ckpt, timeout=600)
            before = router.replicas[0].dispatched
            second = [router.submit(Request(prompt=p,
                                            max_new_tokens=TOKEN_NEW))
                      for p in prompts]
            rounds = [[f.result(timeout=600).tokens for f in futs]
                      for futs in (first, second)]
        snap = router.snapshot()
    dead = [p["dead"] for p in snap["per_replica"] if p["dead"]]
    if step != 1 or snap["swaps"] != 1 or dead:
        raise AssertionError(f"router token case: swap restored step "
                             f"{step}, {snap['swaps']} swaps, dead {dead}")
    if router.replicas[0].dispatched == before:
        raise AssertionError("router token case: the swapped replica served "
                             "nothing after the swap")
    return rounds[0], rounds[1], snap


def serve_tokens_case(torch, np, dev, mode: str, arch: str = TOKEN_ARCH,
                      lens=TOKEN_PROMPTS, max_len: int = 48) -> dict:
    """Greedy tokens through the kernels against the plain path, one
    engine configuration of ``TOKEN_CASES``: ``arch`` in float32 compute,
    weights made once from seed 0 on the CPU, one engine on ``dev`` (in
    the router case two replicas behind a ``Router``,
    :func:`serve_router_tokens`) and one on the CPU, prompts of ``lens``
    tokens (the greedy test's by default) into 2 slots with prefill chunks
    of 16 where the engine chunks. Every request's tokens must be equal
    (and the incremental case must preempt); at a flip, prints the
    request, the step and the CPU run's top-1 minus top-2 logit gap there,
    and raises. Returns the card engine's snapshot."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine, loader
    cfg = registry.get(arch).with_(compute_dtype="float32")
    cpu_model = loader.init_params(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    assert max(lens) > 16                      # one prompt chunks twice
    before = read_launches()
    runs, snaps = [], []                    # the card's run, then the CPU's
    card_pool = "paged"                     # the router's replicas page
    for where, model in ((dev, card_model), (torch.device("cpu"),
                                             cpu_model)):
        if mode == "router" and not runs:
            first, second, rsnap = serve_router_tokens(cfg, dev, model,
                                                       prompts)
            runs.append(first + second)
            snaps.append(rsnap["per_replica"][0]["engine"])
            continue
        eng = ServeEngine(cfg, model, slots=2, max_len=max_len,
                          prefill_chunk=16, device=where,
                          **TOKEN_CASES[mode])
        futs = [eng.submit(Request(prompt=p, max_new_tokens=TOKEN_NEW,
                                   extras=x))
                for p, x in with_extras(np, cfg, prompts)]
        eng.run_until_idle(max_ticks=1000)
        runs.append([f.result(timeout=0).tokens for f in futs])
        snaps.append(eng.metrics.snapshot())
        if len(runs) == 1:
            card_pool = eng.pool.kind
    card, cpu = runs
    if mode == "router":                    # both rounds against the CPU's
        cpu, prompts = cpu * 2, prompts * 2
    after = read_launches()
    rose = {k: after[k] - before[k] for k in after}
    # every kernel of the path must have launched on the card; a speculative
    # run has no paged decode tick (verify reads the pool through the plain
    # gather, as the chunk does), nor has the dense pool
    need = ("sandwich_fwd",) + (("paged_decode_attention",)
                                if mode != "spec" and card_pool == "paged"
                                else ())
    if dev.type == "cuda" and not all(rose[k] for k in need):
        raise AssertionError(f"the card's engine ({mode}) launched "
                             f"{rose}: none of {need} may be 0")
    snap = snaps[0]
    if mode == "incremental" and not snap["preempted"]:
        raise AssertionError("the incremental token run preempted nothing")
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a == b:
            continue
        step = next(j for j, (u, v) in enumerate(zip(a, b)) if u != v)
        ctx = torch.tensor(np.concatenate([prompts[i], b[:step]]))[None]
        ex = {k: torch.from_numpy(v) for k, v in
              (with_extras(np, cfg, prompts)[i % len(lens)][1] or {}).items()}
        with torch.no_grad():
            x = lm.embed_inputs(cpu_model, ctx, ex.get("frontend_embeds"))
            enc_out = (lm.run_encoder(cpu_model, ex["frames"], "torch")
                       if cfg.n_enc_layers else None)
            pos = torch.arange(x.shape[1], dtype=torch.int32)[None]
            x, _ = lm.backbone(cpu_model, x, positions=pos, context="torch",
                               enc_out=enc_out)
            x = cm.rmsnorm(x, cpu_model.final_norm, cfg.norm_eps)
            top = cm.head_apply(cfg, cpu_model.head, x, "torch")[0, -1].float(
                ).topk(2).values
        say(f"serve tokens {mode}: request {i} flips at step {step}: card "
            f"token {a[step]}, CPU token {b[step]}; the CPU run's top-1 "
            f"minus top-2 logit gap there {float(top[0] - top[1]):.3e}")
        raise AssertionError(f"greedy tokens differ ({mode}), request {i} "
                             f"step {step}")
    tier = (" (two replicas behind a Router, a torn-checkpoint swap on "
            "replica 0 mid-run, the prompts twice)" if mode == "router"
            else "")
    admit = ("chunks of 16" if eng.prefill_chunk else
             f"whole prompts on the {eng.pool.kind} pool")
    say(f"serve tokens {mode}: {cfg.name} float32, {len(prompts)} prompts of "
        f"{tuple(lens)} tokens into 2 slots{tier}, {admit}, "
        f"{TOKEN_NEW} new "
        f"tokens each: kernels on {dev.type} and plain on the CPU give the "
        f"same greedy tokens ({sum(map(len, card))} tokens; preempted "
        f"{snap['preempted']}, spec ticks {snap['spec']['ticks']}; launches "
        f"on the card: sandwich {rose['sandwich_fwd']}, paged "
        f"{rose['paged_decode_attention']})")
    return snap


# the serving tier's full-width run through the CLI (phase 6d)
CLI_SERVE = dict(replicas=2, slots=SLOTS, max_len=MAX_LEN, requests=32,
                 min_prompt=5, max_prompt=200, max_new=NEW_TOKENS, rate=10.0)


def _tier_rates(doc) -> dict:
    """Decode tok/s of both replicas together (their decode tokens over their
    decode seconds, build ticks inside) and the mean engine tick (the
    ``serve_tick_seconds`` histogram) of one CLI run's telemetry
    document."""
    per = [p["engine"] for p in doc["summary"]["per_replica"]]
    toks = sum(e["decode_tokens"] for e in per)
    secs = sum(e["decode_tokens"] / e["decode_tok_per_s"] for e in per
               if e["decode_tok_per_s"])
    ticks = doc["metrics"]["metrics"]["serve_tick_seconds"]["samples"]
    n = sum(s["value"]["count"] for s in ticks)
    return {"tok_s": toks / secs if secs else 0.0,
            "tick_ms": sum(s["value"]["sum"] for s in ticks) * 1e3 / max(1, n),
            "ticks": n}


def phase_serve_cli(torch, cfg, dev, sizes=CLI_SERVE) -> tuple:
    """Phase 6d: ``launch.serve.main`` in process over ``sizes``' tier, four
    times in turns: without a tracer, with one, with one, without (so the
    comparison does not ride on the order). Returns the launches summed
    over the runs and a summary."""
    import contextlib
    import gc
    import io

    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs.validate import validate_chrome_trace
    out = ROOT / "build" / "serve_cli"
    out.mkdir(parents=True, exist_ok=True)
    argv = ["--arch", cfg.name, "--device", dev.type, "--seed", "0",
            "--mix", "uniform"]
    for key in ("replicas", "slots", "requests", "min_prompt", "max_prompt",
                "rate"):
        argv += [f"--{key.replace('_', '-')}", str(sizes[key])]
    argv += ["--max-len", str(sizes["max_len"]), "--max-new",
             str(sizes["max_new"])]
    t_phase = time.monotonic()
    total, runs = {}, []
    for n, label in enumerate(("null", "tracer", "tracer", "null")):
        trace = out / f"trace_{n}.json"
        extra = ["--trace-out", str(trace)] if label == "tracer" else []
        gc.collect()          # the last run's garbage, not inside this one
        sync(torch, dev)
        zero_launches()
        text = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(text):
            doc = serve_cli.main(argv + extra + [
                "--metrics-json", str(out / f"metrics_{n}.json")])
        sync(torch, dev)
        wall = time.monotonic() - t0
        launches = read_launches()
        for line_ in text.getvalue().splitlines():
            if line_.startswith(("[serve] router", "  replica[")):
                say(f"serve cli run {n} ({label}): {line_.strip()}")
        snap = doc["summary"]
        dead = [p["dead"] for p in snap["per_replica"] if p["dead"]]
        if snap["requests_finished"] != sizes["requests"] or dead:
            raise AssertionError(f"serve cli run {n}: "
                                 f"{snap['requests_finished']} of "
                                 f"{sizes['requests']} requests finished, "
                                 f"dead replicas {dead}")
        want = {}
        for p in snap["per_replica"]:
            for k, v in serve_launches_want(cfg, p["engine"],
                                            dev.type == "cuda").items():
                want[k] = want.get(k, 0) + v
        if launches != want:
            raise AssertionError(f"serve cli run {n}: launches {launches}, "
                                 f"expected {want} (both replicas' ticks)")
        if extra:
            with open(trace) as f:
                events = validate_chrome_trace(json.load(f))
            finishes = sum(e["name"] == "finish" for e in events)
            if finishes != sizes["requests"]:
                raise AssertionError(f"serve cli run {n}: {finishes} finish "
                                     f"events for {sizes['requests']} "
                                     f"requests")
            say(f"serve cli run {n} ({label}): trace {len(events)} events, "
                f"valid")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs.append((label, snap, {**_tier_rates(doc), "wall_s": wall}))
    say(f"serve cli: {cfg.name} {cfg.compute_dtype}, {sizes['replicas']} "
        f"replicas x {sizes['slots']} slots, {sizes['requests']} requests "
        f"of {sizes['min_prompt']}-{sizes['max_prompt']} prompt tokens and "
        f"{sizes['max_new']} new, open loop at {sizes['rate']} req/s, "
        f"runs without, with, with, without a tracer:")
    for n, (label, snap, r) in enumerate(runs):
        say(f"serve cli run {n} ({label}): TTFT p50 "
            f"{snap['ttft_ms']['p50']} ms, p95 {snap['ttft_ms']['p95']} ms; "
            f"latency p50 {snap['latency_ms']['p50']} ms, p95 "
            f"{snap['latency_ms']['p95']} ms; dispatched "
            f"{[p['dispatched'] for p in snap['per_replica']]}; decode "
            f"tok/s of both replicas {r['tok_s']:.1f} (build ticks inside); "
            f"mean tick {r['tick_ms']:.3f} ms over {r['ticks']} ticks; wall "
            f"{r['wall_s']:.3f} s")

    def mean(label, key):
        vals = [r[key] for lab, _, r in runs if lab == label]
        return sum(vals) / len(vals)
    say(f"serve cli: decode tok/s with a tracer {mean('tracer', 'tok_s'):.1f}"
        f", without {mean('null', 'tok_s'):.1f}; mean tick "
        f"{mean('tracer', 'tick_ms'):.3f} ms with, "
        f"{mean('null', 'tick_ms'):.3f} ms without (means of two runs each, "
        f"not held); launches {total}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    out_summary = {"cli_phase_s": time.monotonic() - t_phase,
                   "cli_tok_s_tracer": mean("tracer", "tok_s"),
                   "cli_tok_s_null": mean("null", "tok_s"),
                   "cli_tick_ms_tracer": mean("tracer", "tick_ms"),
                   "cli_tick_ms_null": mean("null", "tick_ms")}
    for n, (label, snap, _) in enumerate(runs):
        out_summary[f"cli_run{n}_{label}"] = {
            "ttft_ms": snap["ttft_ms"], "latency_ms": snap["latency_ms"],
            "dispatched": [p["dispatched"] for p in snap["per_replica"]]}
    return total, out_summary


def phase_serve_tokens(torch, np, dev, arch: str = TOKEN_ARCH,
                       modes=PHASE_6A, **kw) -> None:
    """:func:`serve_tokens_case` on ``arch`` for every configuration of
    ``modes`` (``kw``: its prompt lengths and ``max_len``)."""
    for mode in modes:
        serve_tokens_case(torch, np, dev, mode, arch, **kw)


def phase_window_refusals(dev, arch: str) -> None:
    """Phase 26's refusals on the card: ``arch``'s rings (or recurrent
    state, phase 32, or its frontend or encoder, phase 35) keep it off
    chunked prefill, so incremental admission and ``spec_k > 0``, which
    ride the chunk machinery, are refused at construction, as the
    reference's engine refuses them."""
    from repro_torch.configs import registry
    from repro_torch.serve import ServeEngine, loader
    cfg = registry.get(arch).with_(compute_dtype="float32")
    model = loader.init_params(cfg, seed=0, device="cpu")
    for kw, what in ((dict(admission="incremental"), "incremental"),
                     (dict(spec_k=3), "spec_k")):
        try:
            ServeEngine(cfg, model, slots=2, max_len=64, device=dev, **kw)
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"{arch} {kw}: refused for another "
                                     f"reason: {e}")
            say(f"serve tokens {arch} {what}: refused ({str(e)[:60]}...)")
            continue
        raise AssertionError(f"{arch} {kw}: not refused without chunked "
                             f"prefill")


def phase_timing(torch, cfg, dev, kernel, time_fn, device_fn, launches,
                 errs, train_rows: int) -> list:
    """Times of the forward kernels. The sandwich: its two
    kernels together, the factor kernel alone, the plain twin, the bound
    and, as the library yardstick, one ``torch.matmul`` by its dense (n_in,
    n_out) matrix (materialized outside the timed window, in the compute
    dtype), over a decode tick's site mix at 8 rows and a train step's
    forward at ``train_rows``, with the bound at both, by CUDA events. The
    paged kernel at PAGED_SHAPES (:func:`time_paged`): its device time and
    SDPA's, which the kernels line carries, beside their event figures."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import roofline as rl
    dt = cfg.compute_dtype
    gen = torch.Generator().manual_seed(3)
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    keys = ("ms", "factors_ms", "plain_ms", "bound_ms", "library_ms",
            "train_ms", "train_bound_ms", "train_library_ms")
    tick = dict.fromkeys(keys, 0.0)
    for key in ("bytes", "ops", "train_bytes", "train_ops"):
        tick[key] = 0
    with torch.no_grad():
        for site, count in mix.items():
            spec, layer = sandwich_site(torch, cfg, site, dev)
            x = torch.randn(SLOTS, spec.n_in, generator=gen).to(
                dev, getattr(torch, dt))
            ms = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, kernel), reps=200)
            fac = time_fn(torch, lambda: ks.sandwich_factors(
                layer.b_in, layer.b_out, layer.idx_in, layer.idx_out,
                n_in=spec.n_in, n_out=spec.n_out, dtype=x.dtype,
                context=kernel), reps=200)
            plain = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, "torch"), reps=20)
            eye = torch.eye(spec.n_in, device=dev)
            dense = sandwich_call(torch, spec, layer, eye, "torch").to(x.dtype)
            lib = time_fn(torch, lambda: torch.matmul(x, dense), reps=200)
            xt = torch.randn(train_rows, spec.n_in, generator=gen).to(
                dev, getattr(torch, dt))
            ms_t = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, xt, kernel), reps=5)
            lib_t = time_fn(torch, lambda: torch.matmul(xt, dense), reps=5)
            del eye, dense, xt
            nbytes, ops = rl.sandwich_fwd_work(spec, SLOTS, dt)
            bnd, _ = rl.bound_ms(nbytes, ops, rl.PEAK_FP32)
            t_bytes, t_ops = rl.sandwich_fwd_work(spec, train_rows, dt)
            t_bnd, t_by = rl.bound_ms(t_bytes, t_ops, rl.PEAK_FP32)
            say(f"time sandwich {site:8s} rows={SLOTS} {dt}: kernels "
                f"{ms:.4f} ms (factors alone {fac:.4f}), plain {plain:.4f} "
                f"ms, matmul by the dense matrix {lib:.4f} ms, bound "
                f"{bnd:.5f} ms ({nbytes} B, {ops} ops); rows={train_rows}: "
                f"kernels {ms_t:.4f} ms, matmul {lib_t:.4f} ms, bound "
                f"{t_bnd:.5f} ms ({t_by}: {t_bytes} B, {t_ops} ops); x{count}"
                f" per decode tick and train step")
            for key, val in (("ms", ms), ("factors_ms", fac),
                             ("plain_ms", plain), ("bound_ms", bnd),
                             ("library_ms", lib), ("train_ms", ms_t),
                             ("train_bound_ms", t_bnd),
                             ("train_library_ms", lib_t)):
                tick[key] += count * val
            tick["bytes"] += count * nbytes
            tick["ops"] += count * ops
            tick["train_bytes"] += count * t_bytes
            tick["train_ops"] += count * t_ops
        _, by = rl.bound_ms(tick["bytes"], tick["ops"], rl.PEAK_FP32)
        _, t_by = rl.bound_ms(tick["train_bytes"], tick["train_ops"],
                              rl.PEAK_FP32)
        say(f"time sandwich per decode tick ({sum(mix.values())} calls of "
            f"{ks.FWD_KERNELS} launches): kernels {tick['ms']:.4f} ms "
            f"(factors alone {tick['factors_ms']:.4f}), plain "
            f"{tick['plain_ms']:.4f} ms, matmul {tick['library_ms']:.4f} ms, "
            f"bound {tick['bound_ms']:.5f} ms ({by}); per train step's "
            f"forward at {train_rows} rows: kernels {tick['train_ms']:.4f} "
            f"ms, matmul {tick['train_library_ms']:.4f} ms, bound "
            f"{tick['train_bound_ms']:.5f} ms ({t_by})")

        paged = {}
        for shape in PAGED_SHAPES:
            paged[shape[0]] = time_paged(torch, cfg, dev, kernel, time_fn,
                                         device_fn, shape)
    p = paged[PAGED_SHAPES[0][0]]
    long_p = paged[PAGED_SHAPES[1][0]]

    return [
        {"name": "sandwich_fwd (sandwich_factors + sandwich_rows)",
         "counter": "sandwich_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/sandwich.cu",
         "replaces": "src/repro/kernels/sandwich.py:75",
         "launches": launches["sandwich_fwd"],
         "max_abs_err": errs["sandwich_fwd"],
         "ms": tick["ms"], "plain_ms": tick["plain_ms"],
         "bound_ms": tick["bound_ms"], "bound_by": by,
         "library_ms": tick["library_ms"],
         "factors_ms": tick["factors_ms"], "train_ms": tick["train_ms"],
         "train_bound_ms": tick["train_bound_ms"], "train_bound_by": t_by,
         "train_library_ms": tick["train_library_ms"],
         "per": f"decode tick: {sum(mix.values())} calls of "
                f"{ks.FWD_KERNELS} launches at {SLOTS} rows (library: "
                f"torch.matmul by the dense matrix); train_*: a train "
                f"step's forward mix at {train_rows} rows"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:92",
         "launches": launches["paged_decode_attention"],
         "max_abs_err": errs["paged_decode_attention"],
         "ms": p["ms"], "event_ms": p["event_ms"], "plain_ms": p["plain_ms"],
         "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
         "library_ms": p["library_ms"],
         "library_event_ms": p["library_event_ms"],
         "long_ms": long_p["ms"], "long_bound_ms": long_p["bound_ms"],
         "long_library_ms": long_p["library_ms"],
         "per": f"call ({pa.PAGED_KERNELS} launches), device time: "
                f"B={SLOTS}, {p['live']} live positions (library: sdpa over "
                f"KV gathered beforehand); long_*: {long_p['live']} live "
                f"positions"},
    ]


def time_paged(torch, cfg, dev, kernel, time_fn, device_fn, shape) -> dict:
    """The paged kernel at one of PAGED_SHAPES in the compute dtype: device
    time per call (``device_fn``) and the CUDA-event figure (``time_fn``)
    of the kernel and of the yardstick, one ``scaled_dot_product_attention``
    over KV gathered and head-expanded beforehand (not timed); the plain
    twin by events; the bound from the live rows' bytes."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import roofline as rl
    dt = cfg.compute_dtype
    q, k_pool, v_pool, ids, cur = paged_inputs(
        torch, cfg, getattr(torch, dt), dev, shape=shape)

    def call():
        return pa.paged_decode_attention(q, k_pool, v_pool, ids, cur,
                                         context=kernel)

    r = {"ms": device_fn(torch, call, reps=200),
         "event_ms": time_fn(torch, call, reps=500),
         "plain_ms": time_fn(torch, lambda: pa.paged_decode_attention(
             q, k_pool, v_pool, ids, cur, context="torch"), reps=20)}
    B, KV, G, D = q.shape
    L = ids.shape[1] * k_pool.shape[1]

    def heads(pool):       # head = kv * G + g
        kv = pa.gather_pages(pool, ids).permute(0, 2, 1, 3)
        return kv.repeat_interleave(G, dim=1).contiguous()

    kg, vg = heads(k_pool), heads(v_pool)
    mask = (torch.arange(L, device=dev)[None, :]
            <= cur[:, None].long())[:, None, None, :]
    qh = q.reshape(B, KV * G, 1, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r["library_ms"] = device_fn(torch, lambda: sdpa(qh, kg, vg,
                                                    attn_mask=mask), reps=200)
    r["library_event_ms"] = time_fn(torch, lambda: sdpa(
        qh, kg, vg, attn_mask=mask), reps=500)
    live = int((cur.long() + 1).sum())
    nbytes, ops = rl.paged_decode_work(B, KV, G, D, live, ids.shape[1], dt)
    r["bound_ms"], r["bound_by"] = rl.bound_ms(nbytes, ops, rl.PEAK_OPS[dt])
    r["live"] = live
    say(f"time paged {shape[0]} B={B} P={ids.shape[1]} live positions={live}"
        f" {dt}: kernel {r['ms']:.5f} ms device ({r['event_ms']:.5f} ms by "
        f"events over back-to-back calls), plain {r['plain_ms']:.4f} ms, sdpa "
        f"{r['library_ms']:.5f} ms device ({r['library_event_ms']:.5f} by "
        f"events), bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes} B,"
        f" {ops} ops); x{paged_per_tick(cfg)} per decode tick"
        f"{clocks(dev)}")
    return r


def profile_window(torch, dev, fn, ticks: int):
    """``torch.profiler`` over ``ticks`` calls of ``fn``: wall ms per call,
    and the device-side events (kernels, copies) as (name, device us,
    count); the host ops that launch them carry the same device time
    again, so they are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync(torch, dev)
        t0 = time.monotonic()
        for _ in range(ticks):
            fn()
        sync(torch, dev)
        wall_us = (time.monotonic() - t0) * 1e6
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    return wall_us, events


# the kernels a graphed decode tick must show in its device trace
GRAPHED_KERNELS = ("sandwich_factors_kernel", "sandwich_rows_kernel",
                   "paged_split_kernel", "paged_combine_kernel")


# kinds of device events in a profiled tick, by substrings of their names
# (lower case): the first that matches names the kind, else "other"
PROFILE_KINDS = (("sandwich", ("sandwich_",)), ("paged", ("paged_",)),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                 ("copy/cast", ("copy",)))


def event_kind(key: str) -> str:
    low = key.lower()
    for kind, parts in PROFILE_KINDS:
        if any(p in low for p in parts):
            return kind
    return "other"


#: profiler windows of graphed decode ticks read at most: a second only
#: where the first's device trace lost kernel records
GRAPHED_WINDOWS = 2


def phase_profile(torch, np, cfg, dev, tag: str = "",
                  sizes=SERVE_PAGED) -> dict:
    """Where a pooled decode tick's time goes, graphed and eager:
    ``torch.profiler`` over three decode ticks of 8 slots (prompts of 5
    tokens) replayed from the engine's decode graph, then over three of
    the same ticks run eagerly through the kernels (``decode_logits``,
    which also copies the KV pool once a call); device time by kernel and
    the device-busy share of the ticks' wall time, and its shares by kind
    (:data:`PROFILE_KINDS`). Each sandwich and paged kernel's launches a
    tick in the graphed window's device trace must equal the decode
    graph's launches per replay; a window whose trace lost kernel records
    (fewer, never more) is read once more, and the check fails when the
    second window lost records too (:data:`GRAPHED_WINDOWS`; the windows
    read are printed and returned). ``tag`` prefixes the printed lines.
    Returns the per-tick wall and busy ms and device launches of both
    windows ({} where the profiler saw no device time)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.graphs import format_key
    eng = ServeEngine(cfg, model_of(cfg, dev), slots=SLOTS,
                      max_len=sizes["max_len"], pool=sizes["pool"],
                      prefill_chunk=CHUNK, device=dev)
    rng = np.random.default_rng(4)
    for p, x in with_extras(np, cfg, [rng.integers(0, cfg.vocab_size, 5)
                                      for _ in range(SLOTS)]):
        eng.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS, extras=x))
    eng.step()          # prefill + first decode: both graphs built
    eng.step()          # the first decode replay
    ticks, out = 3, {}
    head = f"profile {tag} " if tag else "profile "
    windows = (("graphed", eng.step),
               ("eager", lambda: eng.decode_logits(context="cuda")))
    lpr = eng.graphs.stats()[format_key(eng._decode_entry().key)][
        "launches_per_replay"]
    for name, fn in windows:
        if name == "eager" and dev.type != "cuda":
            continue
        for windows_read in range(1, GRAPHED_WINDOWS + 1):
            wall_us, events = profile_window(torch, dev, fn, ticks)
            if name != "graphed" or not sum(e[1] for e in events):
                break
            seen = {k: sum(e[2] for e in events if k in e[0]) / ticks
                    for k in GRAPHED_KERNELS}
            want = {k: lpr[c] / n for k, (c, n) in zip(GRAPHED_KERNELS, (
                ("sandwich_fwd", ks.FWD_KERNELS),) * 2 + ((
                    "paged_decode_attention", pa.PAGED_KERNELS),) * 2)}
            if (seen == want or any(seen[k] > want[k] for k in want)
                    or windows_read == GRAPHED_WINDOWS):
                break
            # the profiler lost kernel records of a replay (never adds
            # any): read one more window, whose counts must hold
            say(f"{head}graphed: the device trace lost launches {seen} "
                f"of {want} a tick (window {windows_read}); profiling "
                f"again")
        busy_us = sum(e[1] for e in events)
        if not busy_us:
            say(f"{head}{name}: device time not measured")
            return {}
        n = sum(e[2] for e in events) // ticks
        say(f"{head}{name}: {ticks} decode ticks, wall "
            f"{wall_us / ticks / 1e3:.3f} ms/tick, device busy "
            f"{busy_us / ticks / 1e3:.3f} ms/tick "
            f"({100 * busy_us / wall_us:.1f}% of wall), {n} device "
            f"launches/tick")
        for key, us, count in sorted(events, key=lambda e: -e[1])[:10]:
            say(f"{head}{name}: {us / ticks / 1e3:8.3f} ms/tick "
                f"{count // ticks:5d} launches/tick  {key[:90]}")
        kinds = {}
        for key, us, _ in events:
            kinds[event_kind(key)] = kinds.get(event_kind(key), 0.0) + us
        say(f"{head}{name}: device time by kind, ms/tick (share of busy): "
            + ", ".join(f"{k} {us / ticks / 1e3:.3f} "
                        f"({100 * us / busy_us:.1f}%)" for k, us in
                        sorted(kinds.items(), key=lambda kv: -kv[1])))
        if name == "graphed":
            # each kernel's launches a tick in the replayed ticks' device
            # trace against the decode graph's launches per replay, which
            # the counters add back at each replay: the trace shows that
            # every replay ran them
            say(f"{head}graphed: launches a tick in the device trace "
                f"{seen} (window {windows_read} of at most "
                f"{GRAPHED_WINDOWS}), the decode graph's launches per "
                f"replay {lpr}")
            out["profile_windows"] = windows_read
            if seen != want:
                raise AssertionError(f"the graphed decode ticks' device "
                                     f"trace shows {seen} launches a tick, "
                                     f"the decode graph holds {want}")
            if dev.type == "cuda":
                # the decode graph replayed back to back (its K/V writes at
                # cur_pos repeat the same values): the device's span of a
                # replay, gaps between its nodes included
                entry = eng._decode_entry()
                span = cuda_ms(torch, lambda: eng.graphs.run(entry), 20)
                # one replay alone, as a tick runs it: the host's time in
                # the launch call, then the wait until the device is done
                launch, wait = [], []
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.graphs.run(entry)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    launch.append(t1 - t0)
                    wait.append(time.perf_counter() - t1)
                launch_ms = 1e3 * sorted(launch)[5]
                wait_ms = 1e3 * sorted(wait)[5]
                say(f"{head}graphed: one replay of the decode graph "
                    f"{span:.3f} ms by CUDA events over 20 back-to-back "
                    f"replays; one replay alone (median of 10, host clock) "
                    f"{launch_ms:.3f} ms in the launch call, then "
                    f"{wait_ms:.3f} ms until the device is done")
                out.update({"profile_replay_ms": span,
                            "profile_replay_launch_ms": launch_ms,
                            "profile_replay_wait_ms": wait_ms})
        tag = "" if name == "graphed" else "eager_"
        out.update({f"profile_{tag}wall_ms_per_tick": wall_us / ticks / 1e3,
                    f"profile_{tag}busy_ms_per_tick": busy_us / ticks / 1e3,
                    f"profile_{tag}launches_per_tick": n})
    return out


# -- training (slice 2) -------------------------------------------------------

GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.08}   # fraction of max|want|
BWD_ROWS = 256            # kernel-vs-plain rows per site, besides the
                          # training run's rows (the row loops of a block)
HEAD_BWD_ROWS = 2048      # at most, at the head: the plain twin's autograd
                          # keeps ~20 stage activations of 65,536 floats a row
TRAIN_STEPS = (2, 5)      # warm, timed
LEAF_TOL = 5e-2           # per butterfly leaf, relative norm
STEP_F32_TOL = 1e-3       # per butterfly leaf of a whole float32 step


def grad_close_or_raise(torch, what, got, want, dtype) -> tuple:
    """Max |got - want| and its share of max|want|; raises unless |got - want| <= frac·max|want| +
    frac·|want| everywhere (float32 frac 1e-5, bfloat16 0.08: the
    reference's gradient tolerances) and ``got`` is finite."""
    got, want = got.float(), want.float()
    frac = GRAD_TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel gradient is not finite")
    err = (got - want).abs()
    limit = frac * max(float(want.abs().max()), 1e-3) + frac * want.abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} "
                             f"beyond {frac} of max|want| "
                             f"{float(want.abs().max()):.3e} "
                             f"({int((err > limit).sum())} of {err.numel()} "
                             f"outside)")
    return float(err.max()), float(err.max()) / float(want.abs().max())


def sandwich_bwd_call(torch, spec, layer, x, g, backend):
    from repro_torch.kernels import sandwich as ks
    return ks.sandwich_backward(
        x, layer.b_in, layer.core, layer.b_out, layer.idx_in, layer.idx_out,
        g, scale_in=spec.scale_in, scale_out=spec.scale_out,
        n_out=spec.n_out, context=backend)


def check_sandwich_bwd(torch, dev, what, spec, layer, x, g, kernel: str,
                       dtype: str) -> list:
    """The backward kernel against its plain twin on (x, g): two launches
    bit-identical, each gradient within GRAD_TOL; prints one line, returns
    [(max|err|, share of max|want|)] for dx, d b_in, d core, d b_out."""
    names = ("dx", "d b_in", "d core", "d b_out")
    got = sandwich_bwd_call(torch, spec, layer, x, g, kernel)
    again = sandwich_bwd_call(torch, spec, layer, x, g, kernel)
    want = sandwich_bwd_call(torch, spec, layer, x, g, "torch")
    sync(torch, dev)
    errs = []
    for name, a, b, w in zip(names, got, again, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} {name}: two launches differ")
        errs.append(grad_close_or_raise(torch, f"{what} {name}", a, w, dtype))
    say(f"{what} max|err| (share of max|want|) "
        + " ".join(f"{n.replace(' ', '')} {e:.3e} ({r:.1e})"
                   for n, (e, r) in zip(names, errs))
        + f"; tol {GRAD_TOL[dtype]} of max|want|; repeat bit-identical")
    return errs


def check_factors_vjp(torch, dev, what, spec, layer, kernel: str, gen
                      ) -> None:
    """The factor-row VJP (the backward's kernels 3 and 4 alone) against its
    twin, autograd through ``sandwich_factors_plain``, for random
    cotangents of F_in and F_out, with the weights rounded to each dtype:
    two launches bit-identical, within GRAD_TOL["float32"] (both are
    float32; only the summation order differs)."""
    from repro_torch.kernels import sandwich as ks
    d_f_in = torch.randn(spec.k_in, spec.n_in, generator=gen).to(dev)
    d_f_out = torch.randn(spec.k_out, spec.n_out, generator=gen).to(dev)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        got, again, want = (ks.sandwich_factors_vjp(
            layer.b_in.detach(), layer.b_out.detach(), layer.idx_in,
            layer.idx_out, d_f_in, d_f_out, dtype=dtype, context=b)
            for b in (kernel, kernel, "torch"))
        sync(torch, dev)
        for name, a, b, w in zip(("d b_in", "d b_out"), got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} {name}: two launches differ")
            errs.append(grad_close_or_raise(
                torch, f"{what} {str(dtype)[6:]} {name}", a, w, "float32"))
    say(f"{what} max|err| (share of max|want|) "
        + " ".join(f"{n} {e:.3e} ({r:.1e})" for n, (e, r) in zip(
            ("db_in f32", "db_out f32", "db_in bf16", "db_out bf16"), errs))
        + f"; tol {GRAD_TOL['float32']} of max|want|; repeat bit-identical")


def phase_sandwich_bwd(torch, cfg, dev, kernel: str, train_rows: int
                       ) -> float:
    """The backward kernels against their plain twin at the three
    full-width sites, float32 and bfloat16, at BWD_ROWS rows and at the
    training run's ``train_rows`` (the head at no more than HEAD_BWD_ROWS),
    where the column kernel splits the rows; two launches on the same
    inputs must give bit-identical gradients. Then the factor-row VJP alone
    against its twin at each site."""
    worst = 0.0
    gen = torch.Generator().manual_seed(11)
    cases = [(site, rows, dtype) for site in sites(cfg)
             for rows in sorted({BWD_ROWS, train_rows if site != "lm_head"
                                 else min(train_rows, HEAD_BWD_ROWS)})
             for dtype in ("float32", "bfloat16")]
    with torch.no_grad():
        for site, rows, dtype in cases:
            spec, layer = sandwich_site(torch, cfg, site, dev)
            dt = getattr(torch, dtype)
            x = torch.randn(rows, spec.n_in, generator=gen).to(dev, dt)
            g = torch.randn(rows, spec.n_out, generator=gen).to(dev, dt)
            errs = check_sandwich_bwd(
                torch, dev, f"sandwich_bwd {site:8s} rows={rows:4d} "
                f"{dtype:9s}", spec, layer, x, g, kernel, dtype)
            if dtype == cfg.compute_dtype:
                worst = max(worst, *(e for e, _ in errs))
        for site in sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            check_factors_vjp(torch, dev, f"sandwich factors vjp {site:8s}",
                              spec, layer, kernel, gen)
    return worst


def phase_wide(torch, dev, kernel: str, wide=WIDE, rows: int = WIDE_ROWS
               ) -> None:
    """The sandwich kernels at ``wide`` (name, n_in, n_out), past the smollm
    sites' widths: the spec from ``make_spec`` (k = log2 n), the layer's own
    weights, ``rows`` rows; the forward against ``sandwich_plain`` at
    SANDWICH_TOL and the backward against ``sandwich_bwd_plain`` at
    GRAD_TOL (two launches bit-identical), float32 and bfloat16, and the
    factor-row VJP against its twin."""
    from repro_torch.core import layers as blayers
    from repro_torch.nn import ButterflyLinear
    name, n_in, n_out = wide
    gen = torch.Generator().manual_seed(14)
    spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen).to(dev)
    head = (f"{name} {n_in}->{n_out} (n1 {spec.pad_in}, n2 {spec.pad_out}, "
            f"k {spec.k_in}/{spec.k_out}) rows={rows}")
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn(rows, n_in, generator=gen).to(dev, dt)
            g = torch.randn(rows, n_out, generator=gen).to(dev, dt)
            got = sandwich_call(torch, spec, layer, x, kernel)
            want = sandwich_call(torch, spec, layer, x, "torch")
            sync(torch, dev)
            err = allclose_or_raise(torch, f"sandwich {head} {dtype}", got,
                                    want, SANDWICH_TOL[dtype])
            say(f"sandwich {head} {dtype:9s} max|err|={err:.3e} (tol "
                f"{SANDWICH_TOL[dtype]})")
            del got, want
            check_sandwich_bwd(torch, dev, f"sandwich_bwd {head} {dtype:9s}",
                               spec, layer, x, g, kernel, dtype)
        check_factors_vjp(torch, dev, f"sandwich factors vjp {head}", spec,
                          layer, kernel, gen)


def phase_train_sites(torch, cfg, dev, kernel: str, train_rows: int
                      ) -> float:
    """The sandwich sites a training run of ``cfg`` calls
    (:func:`called_sites`), kernels against plain at the run's shapes, in
    float32 and bfloat16: the forward at ``train_rows`` rows (two launches
    bit-identical, within SANDWICH_TOL) and the backward at ``train_rows``,
    the head at no more than HEAD_BWD_ROWS (:func:`check_sandwich_bwd`).
    Returns the worst forward error in ``cfg``'s compute dtype."""
    worst = 0.0
    gen = torch.Generator().manual_seed(25)
    with torch.no_grad():
        for site in called_sites(cfg):
            spec, layer = sandwich_site(torch, cfg, site, dev)
            bwd_rows = (train_rows if site != "lm_head"
                        else min(train_rows, HEAD_BWD_ROWS))
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                what = f"train site {cfg.name} {site}"
                x = torch.randn(train_rows, spec.n_in, generator=gen).to(
                    dev, dt)
                got, again, want = (sandwich_call(torch, spec, layer, x, b)
                                    for b in (kernel, kernel, "torch"))
                sync(torch, dev)
                if not torch.equal(got, again):
                    raise AssertionError(f"{what} forward: two launches "
                                         f"differ")
                err = allclose_or_raise(torch, f"{what} rows={train_rows} "
                                        f"{dtype}", got, want,
                                        SANDWICH_TOL[dtype])
                say(f"{what} {spec.n_in}->{spec.n_out} rows={train_rows} "
                    f"{dtype:9s} forward max|err|={err:.3e} (tol "
                    f"{SANDWICH_TOL[dtype]}); repeat bit-identical")
                if dtype == cfg.compute_dtype:
                    worst = max(worst, err)
                del got, again, want
                g = torch.randn(bwd_rows, spec.n_out, generator=gen).to(
                    dev, dt)
                check_sandwich_bwd(torch, dev, f"{what} rows={bwd_rows} "
                                   f"{dtype:9s} backward", spec, layer,
                                   x[:bwd_rows], g, kernel, dtype)
    return worst


def phase_sandwich_bwd_bench(torch, dev, kernel: str, n: int,
                             rows: int = 64) -> None:
    """The backward kernel against its plain twin at ``bench_backward``'s
    widest sandwich, n -> n with k = log2 n at its batch of 64 rows (at n =
    8192 the input side's checkpoints live in device memory), float32 and
    bfloat16, two launches bit-identical."""
    from repro_torch.core import layers as blayers
    from repro_torch.nn import ButterflyLinear
    k = max(2, int(math.log2(n)))
    gen = torch.Generator().manual_seed(12)
    spec = blayers.make_spec(gen, n, n, k_in=k, k_out=k, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen).to(dev)
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn(rows, n, generator=gen).to(dev, dt)
            g = torch.randn(rows, n, generator=gen).to(dev, dt)
            check_sandwich_bwd(torch, dev, f"sandwich_bwd bench n={n} k={k} "
                               f"rows={rows} {dtype:9s}", spec, layer, x, g,
                               kernel, dtype)


def train_counts(cfg) -> tuple:
    """Sandwich forward and backward launches per train step: every site
    once forward (two kernels: factors, rows) and once backward (six
    kernels: factors, rows, columns, their sum, factor-row VJP, reduction),
    the encoder's (:func:`enc_sites`) among them, and with remat the
    decoder's MLP sites (the checkpointed layers; 90 on smollm) once more
    forward inside the backward pass."""
    from repro_torch.kernels import sandwich as ks
    sites_per_step, in_layers = sandwich_sites(cfg)
    sites_per_step += enc_sites(cfg)
    return (ks.FWD_KERNELS * (sites_per_step
                              + (in_layers if cfg.remat else 0)),
            ks.BWD_KERNELS * sites_per_step)


def phase_train(torch, np, cfg, dev, seq_len: int, batch: int,
                steps: tuple = TRAIN_STEPS, profile: bool = True) -> tuple:
    """The training main path: Trainer on ``cfg`` from seed 0, TrainConfig
    defaults with warmup_steps=2, ``steps`` (warm, timed) steps; counts set
    to 0 just before and read just after; every step's loss, ce and aux
    finite. With ``profile`` one more step under ``torch.profiler``.
    Returns (launches, summary)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import sandwich as ks
    from repro_torch.train.trainer import Trainer
    warm, timed = steps
    t0 = time.monotonic()
    trainer = Trainer(cfg, TrainConfig(warmup_steps=2), seq_len=seq_len,
                      global_batch=batch, device=dev)
    model, opt_state = trainer.init_state(seed=0)
    built(cfg, model)
    on_card = dev.type == "cuda"
    sync(torch, dev)
    init_s = time.monotonic() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ks.sandwich_forward.launches = 0
    ks.sandwich_backward.launches = 0
    res = trainer.run(warm + timed, model=model, opt_state=opt_state)
    sync(torch, dev)
    launches = {"sandwich_fwd": ks.sandwich_forward.launches,
                "sandwich_bwd": ks.sandwich_backward.launches}
    fwd, bwd = train_counts(cfg)
    steps = warm + timed
    want = {"sandwich_fwd": on_card * fwd * steps,
            "sandwich_bwd": on_card * bwd * steps}
    if launches != want:
        raise AssertionError(f"train launch counts {launches}, expected "
                             f"{want}")
    if not all(math.isfinite(v) for m in res.metrics for v in m.values()):
        raise AssertionError(f"non-finite training metrics: {res.metrics}")
    ms = sorted(1e3 * t for t in res.step_times[warm:])
    p50 = ms[len(ms) // 2]
    tokens = seq_len * batch
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    PEAKS.append(("train", cfg, (seq_len, batch), peak))
    say(f"train: {cfg.name}, {cfg.n_layers} layers, seq_len {seq_len} x "
        f"batch {batch} = {tokens} tokens/step, remat {cfg.remat}, init "
        f"{init_s:.1f} s, "
        f"{warm} warm + {timed} timed steps (warm ms "
        f"{' '.join(f'{1e3 * t:.1f}' for t in res.step_times[:warm])}); "
        f"step ms p50 {p50:.1f} (min "
        f"{ms[0]:.1f}, max {ms[-1]:.1f}); {tokens / p50 * 1e3:.0f} tokens/s; "
        f"peak memory {peak / 2**20:.1f} MiB; straggler EMA "
        f"{1e3 * res.step_time_ema:.1f} ms")
    aux = [m["aux"] for m in res.metrics]
    say(f"train: losses {' '.join(f'{v:.4f}' for v in res.losses)}"
        + (f"; of which aux {' '.join(f'{v:.5f}' for v in aux)}"
           if cfg.n_experts else ""))
    say(f"train: launches {launches} = ({fwd} fwd, {bwd} bwd) per step x "
        f"{steps} steps")
    summary = {"train_step_ms_p50": p50,
               "train_tokens_per_s": tokens / p50 * 1e3,
               "train_peak_mib": peak / 2**20, "train_losses": res.losses,
               "train_aux": aux, "train_init_s": init_s}
    if profile:
        summary.update(profile_train_step(torch, trainer, model, opt_state,
                                          dev))
    return launches, summary


def profile_train_step(torch, trainer, model, opt_state, dev) -> dict:
    """Device time of one more train step by kernel, ``torch.profiler``;
    {} where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return {}
    batch = trainer._batch(trainer.data.batch(0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch, dev)
        t0 = time.monotonic()
        trainer.step_fn(model, opt_state, batch)
        sync(torch, dev)
        wall_us = (time.monotonic() - t0) * 1e6
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e[1] for e in events)
    if not busy_us:
        say("profile train: device time not measured")
        return {}
    # the factor kernel serves the forward and the backward alike: its time
    # is split between them by their launches (train_counts)
    from repro_torch.kernels import sandwich as ks
    fwd_n, bwd_n = train_counts(trainer.cfg)
    fac_fwd, fac_bwd = fwd_n // ks.FWD_KERNELS, bwd_n // ks.BWD_KERNELS
    fac_us = sum(e[1] for e in events if "sandwich_factors" in e[0])
    fac_n = sum(e[2] for e in events if "sandwich_factors" in e[0])
    bwd_us = (sum(e[1] for e in events if "sandwich_bwd" in e[0])
              + fac_us * fac_bwd / (fac_fwd + fac_bwd))
    fwd_us = (sum(e[1] for e in events if "sandwich_rows" in e[0])
              + fac_us * fac_fwd / (fac_fwd + fac_bwd))
    say(f"profile train: one step, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e[2] for e in events)} device launches; sandwich backward "
        f"kernels {bwd_us / 1e3:.3f} ms, forward {fwd_us / 1e3:.3f} ms (the "
        f"factor kernel's {fac_us / 1e3:.3f} ms over {fac_n} launches split "
        f"{fac_fwd}:{fac_bwd} by launches)")
    for key, us, count in sorted(events, key=lambda e: -e[1])[:10]:
        say(f"profile train: {us / 1e3:9.3f} ms {count:6d} launches  "
            f"{key[:90]}")
    kinds = {}
    for key, us, _ in events:
        kinds[event_kind(key)] = kinds.get(event_kind(key), 0.0) + us
    say("profile train: device time by kind, ms (share of busy): "
        + ", ".join(f"{k} {us / 1e3:.3f} ({100 * us / busy_us:.1f}%)"
                    for k, us in sorted(kinds.items(), key=lambda kv: -kv[1])))
    for key, us, count in sorted(events, key=lambda e: -e[1]):
        if "sandwich" in key:
            say(f"profile train sandwich: {us / 1e3:8.3f} ms {count:5d} "
                f"launches {us / count:8.2f} us each  {key[:70]}")
    return {"train_profile_wall_ms": wall_us / 1e3,
            "train_profile_busy_ms": busy_us / 1e3,
            "train_profile_sandwich_bwd_ms": bwd_us / 1e3,
            "train_profile_sandwich_fwd_ms": fwd_us / 1e3}


def phase_train_gradcheck(torch, np, cfg, dev, kernel: str,
                          seq_len: int = 256, global_batch: int = 1,
                          seed: int = 1) -> None:
    """One train step's gradients layer by layer (the model and the data's
    batch 0 from ``seed``): a plain forward and backward gives each layer's
    input and the cotangent of its output; each layer, and the final norm,
    head and loss, then runs under ``kernel`` and under the plain versions
    on that input and cotangent. Every butterfly leaf (b_in, core, b_out of
    each site) must be finite and within LEAF_TOL of the plain gradient in
    relative norm of the difference, for the serving check's reason:
    rounding differences of a correct kernel compound through the stack
    after it. The whole step's loss and leaf gradients through both paths
    are printed, not held."""
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.train import steps
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(seed)).to(
        dev)
    raw = for_model(cfg, seq_len, global_batch, seed=seed).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    S = batch["tokens"].shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def head_loss(x, backend):
        h = cm.rmsnorm(x, model.final_norm, cfg.norm_eps)
        logits = cm.head_apply(cfg, model.head, h, backend)
        return cm.cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                                batch["mask"][:, 1:])

    # the plain path: each layer's input and its output's cotangent
    with torch.no_grad():
        xs = [cm.embed(cfg, model.embed, batch["tokens"])]
    ins, outs = [], []
    for layer in model.layers:
        ins.append(xs[-1].detach().requires_grad_())
        outs.append(lm.layer_apply(cfg, layer, ins[-1], positions=positions,
                                   context="torch")[0])
        xs.append(outs[-1].detach())
    last = xs[-1].detach().requires_grad_()
    (cot,) = torch.autograd.grad(head_loss(last, "torch"), last)
    cots = [cot]                      # cots[i]: cotangent of layer i's output
    for i in reversed(range(1, cfg.n_layers)):
        (g,) = torch.autograd.grad(outs[i], ins[i], grad_outputs=cots[0])
        cots.insert(0, g)
    del ins, outs

    def leaves(module, prefix):
        return {f"{prefix}.{n}": p for n, p in module.named_parameters()
                if n.endswith(("b_in", "core", "b_out"))}

    rel, plain = {}, {}
    for i, layer in enumerate(model.layers):
        ps = leaves(layer.ffn, f"layers.{i}.ffn")
        grads = []
        for backend in (kernel, "torch"):
            out, _ = lm.layer_apply(cfg, layer, xs[i], positions=positions,
                                    context=backend)
            grads.append(torch.autograd.grad(out, list(ps.values()),
                                             grad_outputs=cots[i]))
        for name, gk, gp in zip(ps, *grads):
            if not bool(torch.isfinite(gk).all()):
                raise AssertionError(f"train gradcheck {name}: not finite")
            rel[name] = float((gk - gp).norm() / gp.norm())
            plain[name] = gp
    ps = leaves(model.head, "head")
    gk, gp = (torch.autograd.grad(head_loss(xs[-1], b), list(ps.values()))
              for b in (kernel, "torch"))
    for name, a, b in zip(ps, gk, gp):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"train gradcheck {name}: not finite")
        rel[name] = float((a - b).norm() / b.norm())
        plain[name] = b
    worst = max(rel, key=rel.get)
    say(f"train gradcheck, layer by layer on the plain path's inputs and "
        f"cotangents: {len(rel)} butterfly leaves, relative norm of the "
        f"difference max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e}; tol {LEAF_TOL}")
    # the whole step through both paths, for the record only
    (lk, gwk), (lp, gwp) = (steps.loss_and_grads(model, batch, context=b)
                            for b in (kernel, "torch"))
    whole = [float((gwk[n] - gwp[n]).norm() / gwp[n].norm()) for n in rel]
    # the layer-by-layer plain gradients are the whole plain step's
    drift = max(float((plain[n] - gwp[n]).norm() / gwp[n].norm())
                for n in rel)
    if not drift <= 1e-2:
        raise AssertionError(f"train gradcheck: layer-by-layer plain "
                             f"gradients differ from the whole step's by "
                             f"{drift:.3e}")
    say(f"train gradcheck, whole step through all {cfg.n_layers} layers "
        f"(not held): loss {float(lk):.6f} vs {float(lp):.6f} (diff "
        f"{abs(float(lk) - float(lp)):.3e}); leaf relative norm max "
        f"{max(whole):.3e}, median {sorted(whole)[len(whole) // 2]:.3e}; "
        f"plain layer-by-layer vs whole-step gradients {drift:.1e}")
    bad = {n: r for n, r in rel.items() if not r <= LEAF_TOL}
    if bad:
        raise AssertionError(f"train gradcheck: {len(bad)} leaves beyond "
                             f"{LEAF_TOL}: {dict(list(bad.items())[:5])}")


def phase_train_step_f32(torch, cfg, dev, kernel: str, seq_len: int = 256,
                         global_batch: int = 1, seed: int = 1) -> None:
    """The gradient check's whole train step (same weights and batch, from
    ``seed``) in float32 compute, through ``kernel`` and through the plain
    versions. Without bfloat16's rounding points the differences of a
    correct kernel stay near float32 rounding through all the layers, so
    each butterfly leaf must be finite and within STEP_F32_TOL of the plain
    gradient in relative norm; a fault that shows only on the kernel path's
    own activations would not stay there. The other leaves are printed."""
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg32 = cfg.with_(compute_dtype="float32")
    model = lm.LM(cfg32, generator=torch.Generator().manual_seed(seed)).to(
        dev)
    raw = for_model(cfg32, seq_len, global_batch, seed=seed).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    (lk, gk), (lp, gp) = (steps.loss_and_grads(model, batch, context=b)
                          for b in (kernel, "torch"))
    rel = {n: float((gk[n] - gp[n]).norm()
                    / gp[n].norm().clamp_min(1e-30)) for n in gp}
    leaves = [n for n in rel if n.endswith(("b_in", "core", "b_out"))]
    others = [n for n in rel if n not in leaves]
    worst = max(leaves, key=rel.get)
    say(f"train step float32, whole step through all {cfg.n_layers} layers, "
        f"kernels vs plain: loss {float(lk):.6f} vs {float(lp):.6f} (diff "
        f"{abs(float(lk) - float(lp)):.3e}); {len(leaves)} butterfly leaves, "
        f"relative norm of the difference max {rel[worst]:.3e} ({worst}), "
        f"median {sorted(rel[n] for n in leaves)[len(leaves) // 2]:.3e}; "
        f"tol {STEP_F32_TOL}; other leaves max "
        f"{max(rel[n] for n in others):.3e}")
    for n in leaves:
        if not bool(torch.isfinite(gk[n]).all()):
            raise AssertionError(f"train step float32 {n}: not finite")
    bad = {n: rel[n] for n in leaves if not rel[n] <= STEP_F32_TOL}
    if bad:
        raise AssertionError(f"train step float32: {len(bad)} leaves beyond "
                             f"{STEP_F32_TOL}: {dict(list(bad.items())[:5])}")


CLI_STEPS = (4, 2)          # continuous run, then resumed from its step 2
RESUME_RTOL = 1e-6          # resumed losses against the continuous run
COMPRESSION_STEPS = 2       # each of topk and int8
TRAINER_SEEDS = (1, 0)      # the Trainer check: phase 10's seed held, then
                            # one read


def _train_cli(torch, dev, argv: list) -> tuple:
    """``launch.train.main(argv)`` in process with the sandwich counts set
    to 0 just before and read just after; returns (result, launches, its
    printed lines)."""
    import contextlib
    import io

    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import train as train_cli
    ks.sandwich_forward.launches = 0
    ks.sandwich_backward.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_cli.main(argv + ["--device", dev.type])
    sync(torch, dev)
    return res, {"sandwich_fwd": ks.sandwich_forward.launches,
                 "sandwich_bwd": ks.sandwich_backward.launches}, \
        buf.getvalue().splitlines()


def _checkpoint_shapes(np, ckdir: Path) -> dict:
    """The params' shapes of the newest checkpoint in ``ckdir``, from its
    manifest."""
    newest = sorted(ckdir.glob("step_*"))[-1]
    paths = json.loads((newest / "manifest.json").read_text())["paths"]
    return {k: tuple(v["shape"]) for k, v in paths.items()
            if k.startswith("params.")}


def phase_train_cli(torch, np, cfg, dev, kernel: str, seq_len: int,
                    batch: int, bfly_shape) -> dict:
    """Phase 23, the training entry point and the execution context:
    ``launch.train.main`` at ``cfg``'s width, continuous (CLI_STEPS[0]
    steps, a checkpoint every 2), resumed from its step 2 in another
    directory (its losses within RESUME_RTOL of the continuous run's last
    two), and COMPRESSION_STEPS steps each with ``--grad-compression topk``
    and ``int8``; then the first float32 step of ``Trainer.run`` for one
    built normally against one built inside ``use_execution("torch")``
    (the record says ``torch`` and no kernel launches; at phase 10's seed
    the loss and each butterfly leaf of Adam's first moment within
    STEP_F32_TOL, at TRAINER_SEEDS' others read), and the
    butterfly backward at ``bfly_shape`` under ``ExecutionContext(segment=
    ⌈√p⌉)``, bit-identical to the unset field, with 1 and p refused.
    Returns the launches of the CLI runs and a summary."""
    import shutil

    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import sandwich as ks
    from repro_torch.kernels.context import ExecutionContext, use_execution
    from repro_torch.optim.compression import compression_stats
    from repro_torch.train.trainer import Trainer
    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    fwd, bwd = train_counts(cfg)
    out = ROOT / "build" / "train_cli"
    shutil.rmtree(out, ignore_errors=True)
    whole_dir, rest_dir = out / "continuous", out / "resumed"
    argv = ["--arch", cfg.name, "--seq-len", str(seq_len), "--global-batch",
            str(batch), "--warmup-steps", "2", "--seed", "0"]
    total, part = CLI_STEPS
    launches = {"sandwich_fwd": 0, "sandwich_bwd": 0}

    def held(what, res, got, steps_run, lines):
        want = {"sandwich_fwd": on_card * fwd * steps_run,
                "sandwich_bwd": on_card * bwd * steps_run}
        if got != want:
            raise AssertionError(f"train cli {what}: launches {got}, "
                                 f"expected {want}")
        if not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"train cli {what}: non-finite loss "
                                 f"{res.losses}")
        if res.execution.backend != kernel.replace("auto", "cuda"):
            raise AssertionError(f"train cli {what}: ran under "
                                 f"{res.execution.describe()}")
        for k in launches:
            launches[k] += got[k]
        for line in lines:
            say(f"train cli {what}: {line}")
        say(f"train cli {what}: step ms "
            + " ".join(f"{1e3 * t:.1f}" for t in res.step_times))

    res, got, lines = _train_cli(torch, dev, argv + [
        "--steps", str(total), "--checkpoint-every", "2",
        "--checkpoint-dir", str(whole_dir)])
    held("continuous", res, got, total, lines)
    whole = res.losses
    ms = sorted(1e3 * t for t in res.step_times[1:])
    p50 = ms[len(ms) // 2]
    rest_dir.mkdir(parents=True)
    shutil.copytree(whole_dir / "step_000000002",
                    rest_dir / "step_000000002")
    res, got, lines = _train_cli(torch, dev, argv + [
        "--steps", str(part), "--checkpoint-every", "2",
        "--checkpoint-dir", str(rest_dir)])
    held("resumed", res, got, part, lines)
    if res.resumed_from != 2 or "resumed from step 2" not in lines[-1]:
        raise AssertionError(f"train cli: the second run did not resume "
                             f"from step 2: {lines[-1]}")
    diff = max(abs(a - b) / abs(b) for a, b in zip(res.losses,
                                                   whole[total - part:]))
    say(f"train cli resume: losses {res.losses} against the continuous "
        f"run's {whole[total - part:]}, largest relative difference "
        f"{diff:.3e} (tol {RESUME_RTOL})")
    if not diff <= RESUME_RTOL:
        raise AssertionError(f"train cli resume: relative difference "
                             f"{diff:.3e} beyond {RESUME_RTOL}")
    shapes = _checkpoint_shapes(np, whole_dir)
    wire = {}
    for kind in ("topk", "int8"):
        res, got, lines = _train_cli(torch, dev, argv + [
            "--steps", str(COMPRESSION_STEPS), "--grad-compression", kind])
        held(kind, res, got, COMPRESSION_STEPS, lines)
        raw = sent = 0
        for shape in shapes.values():
            r, w = compression_stats(kind, torch.empty(
                shape, dtype=torch.float32, device="meta"))
            raw, sent = raw + r, sent + w
        wire[kind] = (raw, sent, 1e3 * res.step_times[-1])
        say(f"train cli {kind}: losses {res.losses}; last step "
            f"{1e3 * res.step_times[-1]:.1f} ms (the continuous run's p50 "
            f"{p50:.1f}); one step's gradients {raw} raw bytes, {sent} on "
            f"the wire ({sent / raw:.4f})")

    # the same first step through each Trainer's own loop: the kernels,
    # and built inside use_execution("torch"). Without clipping Adam's
    # first moment after one step is (1 - b1) * g, so it holds each leaf's
    # gradient as the Trainer's step_fn took it. Seed 1 is phase 10's
    # model and batch, held at its tolerance; seed 0 is read, not held
    # (its whole float32 step differs by ~1.2e-3 on dense and butterfly
    # leaves alike, through the Trainer and in phase 10's own check)
    cfg32 = cfg.with_(compute_dtype="float32")
    for seed in TRAINER_SEEDS:
        tc = TrainConfig(warmup_steps=2, max_grad_norm=0.0,
                         checkpoint_every=0, seed=seed)
        normal = Trainer(cfg32, tc, seq_len=256, global_batch=1, device=dev)
        with use_execution("torch"):
            plain = Trainer(cfg32, tc, seq_len=256, global_batch=1,
                            device=dev)
        if plain.exec_ctx.backend != "torch":
            raise AssertionError(f"a Trainer built inside use_execution("
                                 f"'torch') resolved "
                                 f"{plain.exec_ctx.describe()}")
        first = {}
        for name, tr in (("kernels", normal), ("plain", plain)):
            ks.sandwich_forward.launches = 0
            ks.sandwich_backward.launches = 0
            res = tr.run(1)
            sync(torch, dev)
            n = ks.sandwich_forward.launches + ks.sandwich_backward.launches
            if (n > 0) != (name == "kernels" and on_card):
                raise AssertionError(f"trainer {name} "
                                     f"({tr.exec_ctx.describe()}): {n} "
                                     f"sandwich launches")
            (adam,) = [s for s in tr.opt_state if hasattr(s, "mu")]
            first[name] = (res.losses[0], {k: v for k, v in adam.mu.items()
                                           if v is not None})
            del tr.model, tr.opt_state
        (lk, gk), (lp, gp) = first["kernels"], first["plain"]
        rel = {n: float((gk[n] - gp[n]).norm()
                        / gp[n].norm().clamp_min(1e-30)) for n in gp}
        leaves = [n for n in rel if n.endswith(("b_in", "core", "b_out"))]
        worst = max(leaves, key=rel.get)
        loss_rel = abs(lk - lp) / abs(lp)
        held_here = seed == TRAINER_SEEDS[0]
        say(f"train context seed {seed}: Trainer records "
            f"{normal.kernel_backend} and, built inside use_execution("
            f"'torch'), {plain.kernel_backend}; first float32 step of each "
            f"Trainer's run (seq_len 256 x 1): loss {lk:.6f} vs {lp:.6f} "
            f"(relative difference {loss_rel:.3e}); {len(leaves)} butterfly "
            f"leaves of Adam's first moment, max relative difference "
            f"{rel[worst]:.3e} ({worst}), median "
            f"{sorted(rel[n] for n in leaves)[len(leaves) // 2]:.3e}; other "
            f"leaves max {max(v for n, v in rel.items() if n not in leaves):.3e}"
            f"; " + (f"tol {STEP_F32_TOL}" if held_here else "not held"))
        bad = {n: rel[n] for n in leaves if not rel[n] <= STEP_F32_TOL}
        if not loss_rel <= STEP_F32_TOL:
            bad["loss"] = loss_rel
        if held_here and (bad or not all(torch.isfinite(gk[n]).all()
                                         for n in leaves)):
            raise AssertionError(f"train context: kernels against "
                                 f"use_execution('torch'): {bad}")
        del first, gk, gp, normal, plain

    # the butterfly backward takes one segment: ⌈√p⌉ named explicitly
    # gives the unset field's bits, others are refused before any launch
    name, rows, n = bfly_shape
    p = int(math.log2(n))
    x, w, g = butterfly_case(torch, rows, n, "float32", dev, seed=7)
    seg = kb.default_segment(p)
    base = kb.butterfly_backward(x, w, g, context=kernel)
    dx, dw = kb.butterfly_backward(
        x, w, g, context=ExecutionContext(backend=kernel, segment=seg))
    sync(torch, dev)
    if not (torch.equal(dx, base[0]) and torch.equal(dw, base[1])):
        raise AssertionError(f"butterfly backward {name}: segment {seg} "
                             f"named differs from the unset field")
    before = kb.butterfly_backward.launches
    for s in (1, p):
        try:
            kb.butterfly_backward(
                x, w, g, context=ExecutionContext(backend=kernel, segment=s))
        except ValueError as e:
            if "item 7" not in str(e):
                raise
        else:
            raise AssertionError(f"butterfly backward {name}: segment {s} "
                                 f"was not refused")
    if kb.butterfly_backward.launches != before:
        raise AssertionError(f"butterfly backward {name}: a refused segment "
                             f"launched")
    say(f"segments: butterfly backward {name} {rows}x{n} float32: segment "
        f"{seg} named gives the unset field's bits; 1 and {p} refused "
        f"(ROADMAP item 7)")
    del x, w, g, base, dx, dw
    shutil.rmtree(out, ignore_errors=True)
    say(f"train cli: step ms p50 {p50:.1f} over the continuous run's steps "
        f"2-{total}; phase {time.monotonic() - t_phase:.1f} s")
    return launches, {"train_cli_step_ms_p50": p50,
                      "train_cli_resume_max_rel_diff": diff,
                      "train_cli_compression_bytes": wire}


def phase_timing_bwd(torch, cfg, dev, kernel, time_fn, launches, err,
                     train_rows: int) -> dict:
    """CUDA-event times of the backward over one train step's site mix: the
    kernels, the plain twin, the bound and the dense layer's backward at
    BWD_ROWS rows (the plain twin cannot take the head at the training
    run's rows), and the kernels, the bound and the dense backward at the
    training run's ``train_rows``. The dense backward, the yardstick the
    port never calls, is ``dx = g·W`` and ``dW = gᵀ·x`` by ``torch.matmul``
    with W (n_out, n_in) the sandwich materialized in the compute dtype
    outside the timed window. ``launches`` counts kernels, BWD_KERNELS per
    call."""
    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import roofline as rl
    dt = cfg.compute_dtype
    gen = torch.Generator().manual_seed(13)
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "train_ms",
            "train_bound_ms", "train_library_ms")
    step = dict.fromkeys(keys, 0.0)
    step.update(bytes=0, ops=0, train_bytes=0, train_ops=0)
    with torch.no_grad():
        for site, count in mix.items():
            spec, layer = sandwich_site(torch, cfg, site, dev)

            def inputs(rows):
                return (torch.randn(rows, spec.n_in, generator=gen).to(
                    dev, getattr(torch, dt)),
                    torch.randn(rows, spec.n_out, generator=gen).to(
                    dev, getattr(torch, dt)))

            eye = torch.eye(spec.n_in, device=dev)
            w = sandwich_call(torch, spec, layer, eye, "torch").T.contiguous(
                ).to(getattr(torch, dt))
            del eye

            def dense(x, g):
                return torch.matmul(g, w), torch.matmul(g.T, x)

            x, g = inputs(BWD_ROWS)
            ms = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, x, g, kernel), reps=20)
            plain = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, x, g, "torch"), reps=5)
            lib = time_fn(torch, lambda: dense(x, g), reps=20)
            nbytes, ops = rl.sandwich_bwd_work(spec, BWD_ROWS, dt)
            bnd, by = rl.bound_ms(nbytes, ops, rl.PEAK_FP32)
            xf, gf = inputs(train_rows)
            full = time_fn(torch, lambda: sandwich_bwd_call(
                torch, spec, layer, xf, gf, kernel), reps=10)
            lib_t = time_fn(torch, lambda: dense(xf, gf), reps=10)
            fbytes, fops = rl.sandwich_bwd_work(spec, train_rows, dt)
            fbnd, fby = rl.bound_ms(fbytes, fops, rl.PEAK_FP32)
            del xf, gf, w
            say(f"time sandwich_bwd {site:8s} {dt}: rows={BWD_ROWS} kernels "
                f"{ms:.4f} ms, plain {plain:.4f} ms, dense backward "
                f"{lib:.4f} ms, bound {bnd:.5f} ms ({by}); rows={train_rows} "
                f"kernels {full:.4f} ms, dense backward {lib_t:.4f} ms, bound "
                f"{fbnd:.5f} ms ({fby}: {fbytes} B, {fops} ops); x{count} per "
                f"train step")
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd), ("library_ms", lib),
                             ("train_ms", full), ("train_bound_ms", fbnd),
                             ("train_library_ms", lib_t)):
                step[key] += count * val
            step["bytes"] += count * nbytes
            step["ops"] += count * ops
            step["train_bytes"] += count * fbytes
            step["train_ops"] += count * fops
    _, by = rl.bound_ms(step["bytes"], step["ops"], rl.PEAK_FP32)
    _, t_by = rl.bound_ms(step["train_bytes"], step["train_ops"],
                          rl.PEAK_FP32)
    say(f"time sandwich_bwd per train step ({sum(mix.values())} calls of "
        f"{ks.BWD_KERNELS} launches): rows={BWD_ROWS} kernels "
        f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, dense "
        f"backward {step['library_ms']:.4f} ms, bound {step['bound_ms']:.5f} "
        f"ms ({by}); rows={train_rows} kernels {step['train_ms']:.4f} ms, "
        f"dense backward {step['train_library_ms']:.4f} ms, bound "
        f"{step['train_bound_ms']:.5f} ms ({t_by})")
    return {"name": "sandwich_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/sandwich_bwd.cu",
            "replaces": "src/repro/kernels/sandwich.py:89",
            "launches": launches, "max_abs_err": err,
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": by,
            "library_ms": step["library_ms"],
            "train_ms": step["train_ms"],
            "train_bound_ms": step["train_bound_ms"], "train_bound_by": t_by,
            "train_library_ms": step["train_library_ms"],
            "per": f"train step: {sum(mix.values())} calls of "
                   f"{ks.BWD_KERNELS} launches (factors, rows, columns, "
                   f"their sum, factor-row VJP, reduction; the factor kernel "
                   f"from src/repro_torch/csrc/sandwich_factors.cuh) at "
                   f"{BWD_ROWS} rows "
                   f"(library: the dense layer's backward, dx = g·W and dW "
                   f"= gT·x by torch.matmul); train_*: the same at "
                   f"{train_rows} rows"}


# -- the encoder-decoder (slice 3) --------------------------------------------

MNIST = (784, 70000, 32)      # n (28 x 28 pixels, padded to 1024), d, k
TWO_PHASE_STEPS = (400, 300)  # bench_two_phase.py: lr 3e-3, then 1e-3
# (name, rows, n) of the butterfly kernels against their plain twins: the
# encoder's product, Olivetti faces (400 images of 64 x 64), fewer rows than
# blocks, a row count that the chunks do not divide, n = 8192 (checkpoints
# in device memory) and the widest n (every working row there)
BFLY_SHAPES = (("mnist", 70000, 1024), ("olivetti", 400, 4096),
               ("few_rows", 5, 1024), ("ragged", 1237, 2048),
               ("n8192", 300, 8192), ("n32768", 64, 32768))
BFLY_TOL = {"float32": 1e-5, "bfloat16": 5e-2}   # fractions of max|want|


def close_to_max_or_raise(torch, what, got, want, frac) -> tuple:
    """Max |got - want| and its share of max|want|; raises unless it is
    within frac·max|want| + frac·|want| everywhere and ``got`` is
    finite."""
    got, want = got.detach().float(), want.detach().float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    limit = frac * max(float(want.abs().max()), 1e-3) + frac * want.abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3e} "
                             f"beyond {frac} of max|want| "
                             f"{float(want.abs().max()):.3e} "
                             f"({int((err > limit).sum())} of {err.numel()} "
                             f"outside)")
    return float(err.max()), float(err.max()) / max(
        float(want.abs().max()), 1e-30)


def butterfly_case(torch, rows, n, dtype, dev, seed):
    from repro_torch.core import butterfly as bf
    gen = torch.Generator().manual_seed(seed)
    w = bf.random_weights(gen, n).to(dev)
    x = torch.randn(rows, n, generator=gen).to(dev, getattr(torch, dtype))
    g = torch.randn(rows, n, generator=gen).to(dev, getattr(torch, dtype))
    return x, w, g


def phase_butterfly(torch, dev, kernel: str, shapes) -> dict:
    """The butterfly kernels against their plain twins at ``shapes``, both
    directions, float32 and bfloat16: the forward; the backward with and
    without dx, two launches bit-identical and dw the same without dx; the
    kernel's stage-application count for the first row equal to
    ``stage_applies(p, ⌈√p⌉)`` and at most 3p. Returns the worst float32
    max|err| of the forward and of dw."""
    from repro_torch.kernels import butterfly as kb
    on_card = dev.type == "cuda"
    worst = {"butterfly_fwd": 0.0, "butterfly_bwd": 0.0}
    seed = 20
    for name, rows, n in shapes:
        p = int(math.log2(n))
        want_applied = kb.stage_applies(p)
        if want_applied > 3 * p:
            raise AssertionError(f"stage_applies({p}) = {want_applied} > 3p")
        for transpose in (False, True):
            for dtype in ("float32", "bfloat16"):
                seed += 1
                what = (f"butterfly {name} {rows}x{n} "
                        f"{'Bt' if transpose else 'B '} {dtype}")
                frac = BFLY_TOL[dtype]
                x, w, g = butterfly_case(torch, rows, n, dtype, dev, seed)
                with torch.no_grad():
                    got = kb.butterfly_forward(x, w, transpose=transpose,
                                               context=kernel)
                    want = kb.butterfly_forward(x, w, transpose=transpose,
                                                context="torch")
                sync(torch, dev)
                e_fwd = close_to_max_or_raise(torch, what, got, want, frac)
                del got, want
                applied = torch.zeros(1, dtype=torch.int32, device=dev)
                dx, dw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                               context=kernel,
                                               applied=applied)
                dx2, dw2 = kb.butterfly_backward(x, w, g,
                                                 transpose=transpose,
                                                 context=kernel)
                none, dw3 = kb.butterfly_backward(
                    x, w, g, transpose=transpose, need_dx=False,
                    context=kernel)
                pdx, pdw = kb.butterfly_backward(
                    x, w, g, transpose=transpose, context="torch")
                sync(torch, dev)
                if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
                    raise AssertionError(f"{what}: two backward launches "
                                         f"differ")
                if none is not None or not torch.equal(dw, dw3):
                    raise AssertionError(f"{what}: the backward without dx "
                                         f"gives another dw")
                e_dx = close_to_max_or_raise(torch, f"{what} dx", dx, pdx,
                                             frac)
                e_dw = close_to_max_or_raise(torch, f"{what} dw", dw, pdw,
                                             frac)
                got_applied = int(applied) if on_card else want_applied
                if got_applied != want_applied:
                    raise AssertionError(f"{what}: the kernel applied "
                                         f"{got_applied} stages for its "
                                         f"first row, stage_applies gives "
                                         f"{want_applied}")
                say(f"{what:38s} max|err| (share of max|want|) "
                    + " ".join(f"{k} {e:.3e} ({r:.1e})" for k, (e, r) in
                               (("fwd", e_fwd), ("dx", e_dx), ("dw", e_dw)))
                    + f"; tol {frac} of max|want|; dw bit-identical (repeat,"
                      f" no dx); stage applications {got_applied} (3p = "
                      f"{3 * p})")
                if name == "mnist" and dtype == "float32" and not transpose:
                    worst["butterfly_fwd"] = max(worst["butterfly_fwd"],
                                                 e_fwd[0])
                    worst["butterfly_bwd"] = max(worst["butterfly_bwd"],
                                                 e_dw[0])
                del x, w, g, dx, dw, dx2, dw2, dw3, pdx, pdw
    return worst


def encdec_setup(torch, dev, shape, seed=0):
    """The MNIST-shape problem: the stand-in data, a spec and params from
    seeds, as ``launch.encdec`` sets them up."""
    from repro_torch.core import encdec as ed
    from repro_torch.data.synthetic import synthetic_image_matrix
    n, d, k = shape
    t0 = time.monotonic()
    X_np = synthetic_image_matrix(n, d, seed)
    say(f"encdec data: synthetic_image_matrix({n}, {d}, {seed}) in "
        f"{time.monotonic() - t0:.1f} s")
    X = torch.from_numpy(X_np).to(dev)
    spec = ed.make_spec(torch.Generator().manual_seed(seed), n=n, d=d, k=k)
    params = ed.init_params(torch.Generator().manual_seed(seed + 1), spec,
                            device=dev)
    return spec, params, X


def encdec_step_p50(torch, spec, params, X, dev, train_B, reps=10):
    """p50 ms of one train step (host clock, synchronised): ``reps`` calls
    of one step each."""
    from repro_torch.core import encdec as ed
    ts = []
    for _ in range(reps):
        sync(torch, dev)
        t0 = time.monotonic()
        ed.train(spec, params, X, X, steps=1, lr=1e-3, train_B=train_B)
        sync(torch, dev)
        ts.append(1e3 * (time.monotonic() - t0))
    return sorted(ts)[len(ts) // 2]


def phase_encdec(torch, dev, shape, steps) -> tuple:
    """The encoder-decoder main path at ``shape``: the Theorem 1 row (the
    closed form against the prediction, rtol 1e-3), FJLT+PCA, and the
    two-phase row (``steps`` of phase 1 and 2 with the bench's rates) with
    the counts set to 0 just before and read just after; every loss finite,
    phase 1 no better than the prediction, phase 2 within 2% of phase 1 or
    better, launches as the design implies. Returns (launches, summary,
    (spec, params, X))."""
    from repro_torch.core import encdec as ed
    from repro_torch.kernels import butterfly as kb
    from repro_torch.launch import encdec as launch
    on_card = dev.type == "cuda"
    spec, params, X = encdec_setup(torch, dev, shape)
    n, d, k = shape
    t0 = time.monotonic()
    th = launch.theorem1_row(spec, params, X)
    fjlt = float(ed.fjlt_pca_loss(torch.Generator().manual_seed(2), X, k,
                                  spec.ell))
    sync(torch, dev)
    say(f"encdec n={n} (pad {spec.pad_n}) d={d} k={k} ell={spec.ell}: "
        f"closed-form loss {th['measured']:.4f}, theorem1_loss "
        f"{th['predicted']:.4f}, rel_err {th['rel_err']:.3e} (tol 1e-3); "
        f"fjlt_pca_loss {fjlt:.4f} ({time.monotonic() - t0:.1f} s)")
    if not th["rel_err"] <= 1e-3:
        raise AssertionError(f"closed-form loss {th['measured']} is not the "
                             f"Theorem 1 prediction {th['predicted']}")
    s1, s2 = steps
    sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kb.butterfly_forward.launches = 0
    kb.butterfly_backward.launches = 0
    t0 = time.monotonic()
    row = launch.two_phase_row(spec, params, X, steps1=s1, steps2=s2,
                               log_every=1)
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = {"butterfly_fwd": kb.butterfly_forward.launches,
                "butterfly_bwd": kb.butterfly_backward.launches}
    # a forward per step of both phases, and for the prediction and the two
    # final losses; phase 1 leaves B out of the gradient, so backward
    # launches come from phase 2 only
    want = {"butterfly_fwd": on_card * (s1 + s2 + 3),
            "butterfly_bwd": on_card * kb.BWD_KERNELS * s2}
    if launches != want:
        raise AssertionError(f"encdec launch counts {launches}, expected "
                             f"{want}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    losses = row["h1"] + row["h2"] + [row["phase1"], row["phase2"],
                                      row["thm1_prediction"], row["pca"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite encdec loss: {row['derived']}")
    pred = row["thm1_prediction"]
    if not row["phase1"] >= pred * (1 - 1e-3):
        raise AssertionError(f"phase 1 loss {row['phase1']} beats the "
                             f"global optimum {pred}")
    if not row["phase2"] <= row["phase1"] * 1.02:
        raise AssertionError(f"phase 2 loss {row['phase2']} above phase 1 "
                             f"{row['phase1']} x 1.02")
    p50 = {b: encdec_step_p50(torch, spec, params, X, dev, b)
           for b in (False, True)}
    say(f"encdec {row['name']}: {row['derived']}; fjlt_pca={fjlt:.4f}")
    say(f"encdec two-phase: {s1} + {s2} steps in {wall:.2f} s; step ms p50 "
        f"phase 1 {p50[False]:.3f}, phase 2 {p50[True]:.3f} (one-step "
        f"calls, host clock, synchronised); peak memory "
        f"{peak / 2**20:.1f} MiB; launches {launches} = {s1 + s2} + 3 "
        f"forward, {kb.BWD_KERNELS} x {s2} backward")
    summary = {"encdec_closed_loss": th["measured"],
               "encdec_theorem1_loss": pred, "encdec_pca_loss": row["pca"],
               "encdec_fjlt_pca_loss": fjlt,
               "encdec_phase1_loss": row["phase1"],
               "encdec_phase2_loss": row["phase2"],
               "encdec_two_phase_wall_s": wall,
               "encdec_step_ms_p50_phase1": p50[False],
               "encdec_step_ms_p50_phase2": p50[True],
               "encdec_peak_mib": peak / 2**20}
    return launches, summary, (spec, params, X)


def phase_encdec_vs_plain(torch, dev, kernel, spec, params, X) -> None:
    """Kernels against the plain versions on the whole path, float32: one
    loss gradient (B, E, D each within 1e-4 in relative norm of the
    difference) and the losses of 10 phase-2 steps (rtol 1e-4)."""
    from repro_torch.core import encdec as ed
    grads = {}
    for backend in (kernel, "torch"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = ed.loss_fn(spec, leaves, X, X, context=backend)
        grads[backend] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    rel = {k: float((grads[kernel][k] - grads["torch"][k]).norm()
                    / grads["torch"][k].norm()) for k in params}
    hist = {b: ed.train(spec, params, X, X, steps=10, lr=1e-3, train_B=True,
                        log_every=1, context=b)[1] for b in (kernel, "torch")}
    worst = max(abs(a - b) / abs(b) for a, b in zip(hist[kernel],
                                                    hist["torch"]))
    say(f"encdec kernels vs plain: gradient relative norm of the difference "
        f"{' '.join(f'{k} {v:.2e}' for k, v in rel.items())} (tol 1e-4); "
        f"10 phase-2 steps, losses {hist[kernel][0]:.4f} .. "
        f"{hist[kernel][-1]:.4f}, max rel diff {worst:.2e} (tol 1e-4)")
    bad = {k: v for k, v in rel.items() if not v <= 1e-4}
    if bad:
        raise AssertionError(f"encdec gradients beyond 1e-4: {bad}")
    if not worst <= 1e-4:
        raise AssertionError(f"encdec 10-step losses differ: {hist}")


def phase_timing_butterfly(torch, dev, kernel, time_fn, device_fn, launches,
                           errs, shape, shapes) -> list:
    """Times at the encoder's product, float32, as the path calls them (B x
    forward, the backward without dx): each kernel, its plain twin and, for
    the forward, one ``torch.matmul`` of x by the materialized B
    (materialized outside the timed window) as a yardstick the port never
    calls, all by device time (``device_fn``) beside their CUDA-event
    figures (``time_fn``); each kernel's bound. Then both kernels by device
    time at every shape of ``shapes`` (float32, B x, without dx)."""
    from repro_torch.core import butterfly as bf
    from repro_torch.kernels import butterfly as kb
    from repro_torch.launch import roofline as rl
    n = 1 << (shape[0] - 1).bit_length()
    rows = shape[1]
    x, w, g = butterfly_case(torch, rows, n, "float32", dev, seed=40)
    Bm = bf.materialize(w)
    calls = {
        "fwd": (lambda: kb.butterfly_forward(x, w, context=kernel), 20),
        "fwd_plain": (lambda: kb.butterfly_forward(x, w, context="torch"),
                      5),
        "matmul": (lambda: torch.matmul(x, Bm.T), 5),
        "bwd": (lambda: kb.butterfly_backward(x, w, g, need_dx=False,
                                              context=kernel), 10),
        "bwd_plain": (lambda: kb.butterfly_backward(
            x, w, g, need_dx=False, context="torch"), 3)}
    t = {}
    with torch.no_grad():     # the plain backward enables its own autograd
        for name, (fn, reps) in calls.items():
            t[name] = (device_fn(torch, fn, reps=reps),
                       time_fn(torch, fn, reps=reps))
    clk = clocks(dev)
    del Bm
    fb, fo = rl.butterfly_fwd_work(rows, n, "float32")
    bb, bo = rl.butterfly_bwd_work(rows, n, "float32")
    bnd_f, by_f = rl.bound_ms(fb, fo, rl.PEAK_FP32)
    bnd_b, by_b = rl.bound_ms(bb, bo, rl.PEAK_FP32)
    (ms_f, ev_f), (plain_f, plain_ev_f), (lib_f, lib_ev_f) = (
        t["fwd"], t["fwd_plain"], t["matmul"])
    (ms_b, ev_b), (plain_b, plain_ev_b) = t["bwd"], t["bwd_plain"]
    say(f"time butterfly_fwd {rows}x{n} float32: kernel {ms_f:.4f} ms device "
        f"({ev_f:.4f} ms by events), plain {plain_f:.4f} ms ({plain_ev_f:.4f}"
        f"), matmul by materialized B {lib_f:.4f} ms ({lib_ev_f:.4f}; "
        f"{2 * rows * n * n} flop), bound {bnd_f:.5f} ms ({by_f}: {fb} B, "
        f"{fo} ops){clk}")
    say(f"time butterfly_bwd {rows}x{n} float32 without dx: kernel "
        f"{ms_b:.4f} ms device ({ev_b:.4f} ms by events; {kb.BWD_KERNELS} "
        f"launches), plain {plain_b:.4f} ms ({plain_ev_b:.4f}), no library "
        f"call, bound {bnd_b:.5f} ms ({by_b}: {bb} B, {bo} ops){clk}")
    del x, w, g
    for name, srows, sn in shapes:
        x, w, g = butterfly_case(torch, srows, sn, "float32", dev, seed=41)
        with torch.no_grad():
            sf = device_fn(torch, lambda: kb.butterfly_forward(
                x, w, context=kernel), reps=10)
            sb = device_fn(torch, lambda: kb.butterfly_backward(
                x, w, g, need_dx=False, context=kernel), reps=10)
        say(f"time butterfly {name} {srows}x{sn} float32: forward {sf:.4f} "
            f"ms, backward without dx {sb:.4f} ms (device)")
        del x, w, g
    per = f"launch: {rows} rows x n {n}, float32"
    return [
        {"name": "butterfly_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/butterfly.cu",
         "replaces": "src/repro/kernels/butterfly.py:96",
         "launches": launches["butterfly_fwd"],
         "max_abs_err": errs["butterfly_fwd"], "ms": ms_f,
         "plain_ms": plain_f, "bound_ms": bnd_f, "bound_by": by_f,
         "library_ms": lib_f, "event_ms": ev_f,
         "library_event_ms": lib_ev_f,
         "launches_by_path": {"encdec": launches["butterfly_fwd"]},
         "per": per},
        {"name": "butterfly_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/butterfly_bwd.cu",
         "replaces": "src/repro/kernels/butterfly.py:168",
         "launches": launches["butterfly_bwd"],
         "max_abs_err": errs["butterfly_bwd"], "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bnd_b, "bound_by": by_b,
         "library_ms": None, "event_ms": ev_b,
         "launches_by_path": {"encdec": launches["butterfly_bwd"]},
         "per": f"call of {kb.BWD_KERNELS} launches without dx: {rows} rows "
                f"x n {n}, float32"},
    ]


# -- flash attention and the benches (slice 4) --------------------------------

# (name, B, H, S, D, dtypes, causal, window), besides (a) the training
# attention, which :func:`run` takes from the config (seq_len 2048 x batch
# 4, 9 heads from 3 KV heads expanded, head_dim 64, bf16, causal): (b)
# bench_backward's flash rows, (c) a gemma3-27b local layer
# (configs/gemma3_27b.py), (d) ragged and wide, (e) the narrowest and a
# wide head under the asymmetric non-causal window
FLASH_SHAPES = (
    ("bench_s1024", 1, 2, 1024, 64, ("float32",), True, 0),
    ("bench_s8192", 1, 2, 8192, 64, ("float32",), True, 0),
    ("gemma3_local", 1, 32, 4096, 128, ("bfloat16",), True, 1024),
    ("ragged_d256", 2, 3, 1000, 256, ("float32",), False, 0),
    ("d8_window", 2, 3, 77, 8, ("float32", "bfloat16"), False, 24),
    ("d192_window", 2, 3, 77, 192, ("float32", "bfloat16"), False, 24),
)
# timed besides (a); the first is the bench path's widest flash call, whose
# numbers the kernels line reports
FLASH_TIMED = ("bench_s8192",)
# fractions of max|want|: float32 sums run in another order; bfloat16
# rounds once at the output
FLASH_FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_LSE_TOL = 1e-5
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# bfloat16 is held row by row besides: each row of o and dq, each key's row
# of dk and dv, within 1% of its own norm (one bf16 step is at most 2^-7 of
# a value), so that a small row cannot pass against the tensor's largest
FLASH_ROW_TOL = 1e-2
# the bench path's rows against the plain versions on their own inputs, all
# float32: (output, gradients) as fractions of max|want|
BENCH_TOL = {"butterfly": (BFLY_TOL["float32"], BFLY_TOL["float32"]),
             "sandwich": (SANDWICH_TOL["float32"], GRAD_TOL["float32"]),
             "flash": (FLASH_FWD_TOL["float32"], FLASH_GRAD_TOL["float32"])}


def rows_close_or_raise(torch, what, got, want, rel) -> float:
    """The largest ‖got − want‖ over a row (the last dim) against the row's
    ‖want‖; raises unless every row is within rel·(‖want_row‖ + 1e-3·the
    largest ‖want_row‖, at least 1e-3, as close_to_max_or_raise floors
    it)."""
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    scale = ref + 1e-3 * max(float(ref.max()), 1e-3)
    if not bool((err <= rel * scale).all()):
        raise AssertionError(f"{what}: {int((err > rel * scale).sum())} of "
                             f"{err.numel()} rows beyond {rel} of their norm "
                             f"(worst {float((err / scale).max()):.3e})")
    return float((err / scale).max())


def flash_inputs(torch, shape, dtype, dev, seed):
    """q, k, v, dO of one flash shape, standard normal from ``seed``."""
    _, B, H, S, D = shape[:5]
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=gen).to(dev,
                                                      getattr(torch, dtype))
            for _ in range(4)]


def phase_flash(torch, dev, kernel: str, shapes) -> dict:
    """The three flash kernels against their plain twins at ``shapes``: o
    and lse of the forward; dq, dk, dv of the backward for one dO from the
    plain forward's o and lse, two launches bit-identical; in bfloat16 also
    row by row (FLASH_ROW_TOL). Returns {shape name: max|err|} in the
    shape's first dtype: the forward's, dq's, and the larger of dk's and
    dv's."""
    from repro_torch.kernels import flash as kf
    found = {}
    seed = 60
    for shape in shapes:
        name, B, H, S, D, dtypes, causal, window = shape
        for dtype in dtypes:
            seed += 1
            q, k, v, do = flash_inputs(torch, shape, dtype, dev, seed)
            kw = dict(causal=causal, window=window)
            what = (f"flash {name} B={B} H={H} S={S} D={D} {dtype} "
                    f"causal={causal} window={window}")
            out, lse = kf.flash_forward(q, k, v, context=kernel, **kw)
            pout, plse = kf.flash_forward(q, k, v, context="torch", **kw)
            sync(torch, dev)
            errs = {"o": close_to_max_or_raise(torch, f"{what} o", out, pout,
                                               FLASH_FWD_TOL[dtype]),
                    "lse": close_to_max_or_raise(torch, f"{what} lse", lse,
                                                 plse, FLASH_LSE_TOL)}
            by_row = {}
            if dtype == "bfloat16":
                by_row["o"] = rows_close_or_raise(torch, f"{what} o", out,
                                                  pout, FLASH_ROW_TOL)
            del out, lse
            got = kf.flash_backward(q, k, v, pout, plse, do, context=kernel,
                                    **kw)
            again = kf.flash_backward(q, k, v, pout, plse, do,
                                      context=kernel, **kw)
            want = kf.flash_backward(q, k, v, pout, plse, do,
                                     context="torch", **kw)
            sync(torch, dev)
            for g, a, w, n in zip(got, again, want, ("dq", "dk", "dv")):
                if not torch.equal(g, a):
                    raise AssertionError(f"{what} {n}: two backward launches "
                                         f"differ")
                errs[n] = close_to_max_or_raise(torch, f"{what} {n}", g, w,
                                                FLASH_GRAD_TOL[dtype])
                if dtype == "bfloat16":
                    by_row[n] = rows_close_or_raise(torch, f"{what} {n}", g,
                                                    w, FLASH_ROW_TOL)
            say(f"{what}: max|err| (share of max|want|) "
                + " ".join(f"{n} {e:.3e} ({r:.1e})"
                           for n, (e, r) in errs.items())
                + f"; max|want| dq {float(want[0].abs().max()):.3e}; tol "
                  f"{FLASH_FWD_TOL[dtype]} / {FLASH_LSE_TOL} / "
                  f"{FLASH_GRAD_TOL[dtype]} of max|want|; backward "
                  f"bit-identical"
                + ("; worst row |err|/|want| " + " ".join(
                    f"{n} {r:.1e}" for n, r in by_row.items())
                   + f" (tol {FLASH_ROW_TOL})" if by_row else ""))
            if dtype == dtypes[0]:
                found[name] = {"flash_fwd": errs["o"][0],
                               "flash_bwd_dq": errs["dq"][0],
                               "flash_bwd_dkv": max(errs["dk"][0],
                                                    errs["dv"][0])}
            del q, k, v, do, pout, plse, got, again, want
    return found


def phase_flash_autograd(torch, dev, kernel: str, shape) -> None:
    """``FlashFn`` through ``torch.autograd.grad`` at ``shape``: the
    gradients of ``vdot(c, flash_attention(q, k, v))`` through the kernels
    against the same through the plain twins, at the flash tolerances (in
    bfloat16 also row by row); one forward and two backward launches per
    call."""
    from repro_torch.kernels import flash as kf
    name, B, H, S, D, (dtype, *_), causal, window = shape
    q, k, v, c = flash_inputs(torch, shape, dtype, dev, seed=80)
    on_card = dev.type == "cuda"
    grads = {}
    for backend in (kernel, "torch"):
        f0, b0 = kf.flash_forward.launches, kf.flash_backward.launches
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = kf.flash_attention(*leaves, causal=causal, window=window,
                                 context=backend)
        grads[backend] = torch.autograd.grad((c.float() * out.float()).sum(),
                                             leaves)
        sync(torch, dev)
        rose = (kf.flash_forward.launches - f0,
                kf.flash_backward.launches - b0)
        want = (1, kf.BWD_KERNELS) if backend == "cuda" else (0, 0)
        if rose != want:
            raise AssertionError(f"flash_attention ({backend}): launches "
                                 f"rose by {rose}, expected {want}")
    names = ("dq", "dk", "dv")
    errs = [close_to_max_or_raise(torch, f"FlashFn {name} {n}", g, w,
                                  FLASH_GRAD_TOL[dtype])
            for n, g, w in zip(names, grads[kernel], grads["torch"])]
    by_row = ([rows_close_or_raise(torch, f"FlashFn {name} {n}", g, w,
                                   FLASH_ROW_TOL)
               for n, g, w in zip(names, grads[kernel], grads["torch"])]
              if dtype == "bfloat16" else [])
    say(f"FlashFn {name} {dtype} through autograd, kernels vs plain: "
        + " ".join(f"{n} {e:.3e} ({r:.1e})" for n, (e, r) in zip(names, errs))
        + ("; worst row |err|/|want| " + " ".join(
            f"{n} {r:.1e}" for n, r in zip(names, by_row))
           + f" (tol {FLASH_ROW_TOL})" if by_row else "")
        + f"; launches per call 1 + {kf.BWD_KERNELS}"
        + ("" if on_card else " (plain: 0)"))


def bench_want(rows, on_card: bool) -> dict:
    """The launches of every kernel that the timed calls of ``rows`` imply:
    ``kernel/*`` the butterfly forward; ``speed/*`` the sandwich forward (2
    launches), and its train step the sandwich backward (6); each fused
    ``backward/*`` step one forward and one backward call of its op."""
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import flash as kf
    from repro_torch.kernels import sandwich as ks
    calls = {}
    for r in rows:
        kind = r["name"].split("_n")[0]
        calls[kind] = calls.get(kind, 0) + r["calls"]
    bfly = calls.get("backward/butterfly_fwdbwd_fused", 0)
    sand = (calls.get("speed/train", 0)
            + calls.get("backward/sandwich_fwdbwd_fused", 0))
    flash = calls.get("backward/flash_fwdbwd_fused", 0)
    want = {"butterfly_fwd": calls.get("kernel/butterfly", 0) + bfly,
            "butterfly_bwd": kb.BWD_KERNELS * bfly,
            "sandwich_fwd": ks.FWD_KERNELS * (calls.get("speed/forward", 0)
                                              + sand),
            "sandwich_bwd": ks.BWD_KERNELS * sand,
            "flash_fwd": flash, "flash_bwd": kf.BWD_KERNELS * flash}
    return {k: on_card * v for k, v in want.items()}


def check_bench(torch, dev, kernel: str, checks) -> None:
    """Each kernel row of the bench path run once through ``kernel`` and
    once through the plain versions on that row's own inputs: the output,
    and a step's gradients, within BENCH_TOL."""
    for name, op, make in checks:
        got, want = make(kernel)(), make("torch")()
        sync(torch, dev)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        if len(got) != len(want):
            raise AssertionError(f"bench {name}: {len(got)} results against "
                                 f"the plain version's {len(want)}")
        tol_out, tol_grad = BENCH_TOL[op]
        errs = [close_to_max_or_raise(
            torch, f"bench {name} {'out' if i == 0 else f'grad {i}'}", g, w,
            tol_out if i == 0 else tol_grad)
            for i, (g, w) in enumerate(zip(got, want))]
        say(f"bench {name} kernels vs plain, float32: max|err| (share of "
            f"max|want|) out {errs[0][0]:.3e} ({errs[0][1]:.1e})"
            + "".join(f", grad {i} {e:.3e} ({r:.1e})"
                      for i, (e, r) in enumerate(errs[1:], 1))
            + f"; tol {tol_out} / {tol_grad} of max|want|")
        del got, want


def phase_bench(torch, dev, kernel: str, bench: dict) -> dict:
    """The benches' main path: ``launch.speed.run`` at the reference's sizes
    (``bench`` may cut them for a rehearsal), with every launch counter set
    to 0 just before and read just after. Every reference row name must be
    present; on the card every row is timed and finite, and each kernel's
    launches are what the timed calls imply (:func:`bench_want`). Then
    every kernel row is held against the plain versions on its own inputs
    (:func:`check_bench`). Returns the launches by kernel."""
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import flash as kf
    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import speed
    on_card = dev.type == "cuda"
    counters = {"butterfly_fwd": kb.butterfly_forward,
                "butterfly_bwd": kb.butterfly_backward,
                "sandwich_fwd": ks.sandwich_forward,
                "sandwich_bwd": ks.sandwich_backward,
                "flash_fwd": kf.flash_forward,
                "flash_bwd": kf.flash_backward}
    sync(torch, dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    checks = []
    rows = speed.run(dev, checks=checks, **bench)
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for r in rows:
        say("bench: " + speed.line(r))
    names = [r["name"] for r in rows]
    want_names = speed.row_names(ns=bench.get("ns"))
    if names != want_names:
        raise AssertionError(f"bench rows {names} are not the reference's "
                             f"{want_names}")
    for r in rows:
        us = r["us_per_call"]
        fused = "_fused_" in r["name"]
        if on_card and (us is None or not math.isfinite(us)):
            raise AssertionError(f"bench row {r['name']} not timed: {r}")
        if not on_card and fused and "reason=no_cuda" not in r["derived"]:
            raise AssertionError(f"bench row {r['name']}: {r['derived']}")
    want = bench_want(rows, on_card)
    if launches != want:
        raise AssertionError(f"bench launches {launches}, expected {want}")
    if on_card and not all(launches.values()):
        raise AssertionError(f"a kernel of the bench path never launched: "
                             f"{launches}")
    say(f"bench: {len(rows)} rows in {wall:.1f} s; launches {launches} as "
        f"the timed calls imply")
    check_bench(torch, dev, kernel, checks)
    return launches


def phase_timing_flash(torch, dev, kernel, time_fn, device_fn, launches,
                       errs, shapes, entry: str, kv_heads: int) -> list:
    """Times of the three flash kernels at ``shapes`` (the training
    attention first): each kernel alone and SDPA's forward and backward by
    device time (``device_fn``) beside their CUDA-event figures
    (``time_fn``), the plain twins by CUDA events; each kernel's bound (in
    float32 at the 3xTF32 rate, the CUDA-core one printed beside it), and
    as the library yardstick the port never calls
    ``scaled_dot_product_attention(is_causal=True)``: its forward for the
    forward, its backward (fwd+bwd through ``torch.autograd.grad`` minus
    fwd) for the dq/dkv pair. At the first shape also the port's plain
    ``models.attention._attend_masked`` forward and fwd+bwd in grouped
    layout over ``kv_heads`` heads, without KV expansion. The kernels
    line's entries carry the numbers of the shape named ``entry``, where
    the bench path launches them, with ``errs[entry]`` from
    :func:`phase_flash`; the other shapes go in ``per``. The SDPA backward
    computes dq, dk and dv in one: it stands as ``library_ms`` of the dq
    entry, for the pair, and the dkv entry has none."""
    from repro_torch.kernels import flash as kf
    from repro_torch.launch import roofline as rl
    from repro_torch.models.attention import _attend_masked
    work = {"flash_fwd": rl.flash_fwd_work, "flash_bwd_dq": rl.flash_dq_work,
            "flash_bwd_dkv": rl.flash_dkv_work}
    on_card = dev.type == "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dq_k = kf.dq_cuda if on_card else kf.flash_dq_plain
    dkv_k = kf.dkv_cuda if on_card else kf.flash_dkv_plain
    found = {}
    for shape in shapes:
        name, B, H, S, D, (dtype, *_), causal, window = shape
        q, k, v, do = flash_inputs(torch, shape, dtype, dev, seed=90)
        kw = dict(causal=causal, window=window)
        with torch.no_grad():
            out, lse = kf.flash_forward(q, k, v, context=kernel, **kw)
            delta = kf.row_delta(out, do)
        reps = 10 if S >= 4096 else 20

        calls = {
            "flash_fwd": lambda: kf.flash_forward(q, k, v, context=kernel,
                                                  **kw),
            "flash_bwd_dq": lambda: dq_k(q, k, v, do, lse, delta, **kw),
            "flash_bwd_dkv": lambda: dkv_k(q, k, v, do, lse, delta, **kw)}
        plains = {
            "flash_fwd": lambda: kf.flash_forward(q, k, v, context="torch",
                                                  **kw),
            "flash_bwd_dq": lambda: kf.flash_dq_plain(q, k, v, do, lse,
                                                      delta, **kw),
            "flash_bwd_dkv": lambda: kf.flash_dkv_plain(q, k, v, do, lse,
                                                        delta, **kw)}
        t = {}
        with torch.no_grad():     # both figures of a kernel back to back
            for kname, fn in calls.items():
                t[kname] = (device_fn(torch, fn, reps=reps),
                            time_fn(torch, fn, reps=reps), clocks(dev),
                            time_fn(torch, plains[kname], reps=3))
            lib_f = device_fn(torch, lambda: sdpa(q, k, v, is_causal=causal),
                              reps=reps)
            lib_f_event = time_fn(torch, lambda: sdpa(q, k, v,
                                                      is_causal=causal),
                                  reps=reps)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def sdpa_fwdbwd():
            return torch.autograd.grad(sdpa(*leaves, is_causal=causal),
                                       leaves, grad_outputs=do)

        lib_fb = device_fn(torch, sdpa_fwdbwd, reps=reps)
        lib_fb_event = time_fn(torch, sdpa_fwdbwd, reps=reps)
        lib = {"flash_fwd": (lib_f, lib_f_event),
               "flash_bwd_dq": (lib_fb - lib_f, lib_fb_event - lib_f_event),
               "flash_bwd_dkv": (lib_fb - lib_f, lib_fb_event - lib_f_event)}
        res = {}
        for kname, (ms, event, clk, plain) in t.items():
            nbytes, ops = work[kname](B, H, S, D, dtype, causal, window)
            bnd, by = rl.bound_ms(nbytes, ops, rl.PEAK_OPS[dtype])
            tf32 = ""
            if dtype == "float32":
                # the float32 route runs in 3xTF32: its bound is at that
                # rate, the CUDA-core bound printed beside it
                tf32 = f" (CUDA-core float32 bound {bnd:.5f} ms)"
                bnd, by = rl.bound_ms(nbytes, ops, rl.PEAK_3XTF32)
            res[kname] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                              bound_by=by, library_ms=lib[kname][0],
                              event_ms=event,
                              library_event_ms=lib[kname][1])
            say(f"time {kname} {name} B={B} H={H} S={S} D={D} {dtype}: "
                f"kernel {ms:.4f} ms device ({event:.4f} ms by events), "
                f"plain {plain:.4f} ms, bound {bnd:.5f} ms ({by}: {nbytes} "
                f"B, {ops} ops){tf32}, sdpa "
                f"{'forward' if kname == 'flash_fwd' else 'backward (pair)'}"
                f" {lib[kname][0]:.4f} ms device ({lib[kname][1]:.4f} ms by "
                f"events){clk}")
        if shape is shapes[0]:
            KV = kv_heads
            G = H // KV
            qg = q.permute(0, 2, 1, 3).reshape(B, S, KV, G, D).contiguous()
            kg, vg = (x[:, ::G].permute(0, 2, 1, 3).contiguous()
                      for x in (k, v))
            pos = torch.arange(S, device=dev)[None].expand(B, S)
            dog = do.permute(0, 2, 1, 3).reshape(B, S, KV, G, D)
            with torch.no_grad():
                m_f = time_fn(torch, lambda: _attend_masked(qg, kg, vg, pos,
                                                            pos), reps=5)
            gl = [x.detach().requires_grad_() for x in (qg, kg, vg)]
            m_fb = time_fn(torch, lambda: torch.autograd.grad(
                _attend_masked(*gl, pos, pos), gl, grad_outputs=dog), reps=5)
            fl = sum(res[n]["ms"] for n in res)
            say(f"time attention {name} B={B} S={S} {H} heads ({KV} KV) "
                f"D={D} {dtype}: plain _attend_masked forward {m_f:.4f} ms, "
                f"fwd+bwd {m_fb:.4f} ms (by events); flash kernels forward "
                f"{res['flash_fwd']['ms']:.4f} ms, fwd+bwd (3 kernels) "
                f"{fl:.4f} ms; sdpa forward {lib_f:.4f} ms, fwd+bwd "
                f"{lib_fb:.4f} ms (device)")
            res["flash_fwd"]["attend_masked_fwd_ms"] = m_f
            res["flash_fwd"]["attend_masked_fwdbwd_ms"] = m_fb
            del qg, kg, vg, gl, dog
        found[name] = (shape, res)
        del q, k, v, do, out, lse, delta, leaves
    at_shape, at = found[entry]
    _, B, H, S, D, (dtype, *_), causal, window = at_shape
    lib_what = {"flash_fwd": "sdpa forward",
                "flash_bwd_dq": "sdpa backward, for the dq/dkv pair",
                "flash_bwd_dkv": "none: sdpa's backward stands on "
                                 "flash_bwd_dq for the pair"}
    entries = []
    for kname, src, line in (("flash_fwd", "flash.cu", 69),
                             ("flash_bwd_dq", "flash_bwd.cu", 101),
                             ("flash_bwd_dkv", "flash_bwd.cu", 130)):
        counter = "flash_fwd" if kname == "flash_fwd" else "flash_bwd"
        n = launches[counter] // (1 if kname == "flash_fwd" else 2)
        other = "; ".join(
            f"{nm} (B={sh[1]} H={sh[2]} S={sh[3]} D={sh[4]} {sh[5][0]}): "
            f"kernel {r[kname]['ms']:.4f} ms, plain "
            f"{r[kname]['plain_ms']:.4f} ms, sdpa "
            f"{'forward' if kname == 'flash_fwd' else 'backward (pair)'} "
            f"{r[kname]['library_ms']:.4f} ms, bound "
            f"{r[kname]['bound_ms']:.5f} ms ({r[kname]['bound_by']})"
            for nm, (sh, r) in found.items() if nm != entry)
        e = {"name": kname, "route": "cuda",
             "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/flash.py:{line}",
             "launches": n, "max_abs_err": errs[entry][kname],
             "launches_by_path": {"bench": n},
             "per": f"launch at {entry}, B={B} H={H} S={S} D={D} {dtype} "
                    f"causal={causal} window={window} (library: "
                    f"{lib_what[kname]}); {other}"}
        e.update(at[kname])
        if kname == "flash_bwd_dkv":
            e["library_ms"] = e["library_event_ms"] = None
        entries.append(e)
    return entries

# -- the layer API and the paper's remaining experiments (slice 12) ----------

# from_dense layers held against their dense equivalent: (name, n_in, n_out,
# k_in, k_out, rows, bias); k None is the paper's log2(n). The MLP up site
# of smollm-135m-butterfly and the quickstart's layer
LAYER_API_LAYERS = (("mlp_up", 576, 1536, None, None, 64, True),
                    ("quickstart", 512, 512, 64, 64, 64, False))
QUICKSTART_FIT = (512, 64, 1024, 300)     # n, k, rows of X, Adam steps
# SANDWICH_TOL's float32 2e-4, as a fraction of max|want|: the sandwich
# against a product by its dense matrix sums other terms in another order,
# and at k = log2 n the outputs run to hundreds (Proposition 3.1's error at
# init is ~100 ||W|| there), so a float32 error follows the size of the
# terms, not of an output near 0
LAYER_API_TOL = SANDWICH_TOL["float32"]
# the learned sketch at the shape of IVY19's HS-SOD matrices (1024 x 768),
# on the bench's synthetic hyper_like data: n, d, ell, k, train and test
# matrices, steps (the bench's lr and batch, launch.paper's SKETCH_LR and
# SKETCH_BATCH)
SKETCH_RUN = (1024, 768, 20, 10, 24, 8, 120)
SKETCH_TOL = 1e-4           # fraction of max|want|: loss and dw, float32
GATED_TOL = 1e-5            # the gated butterfly, card against the CPU
GATED_SHAPES = ((512, 64), (768, 1024))   # rows, n: the bench's and wider
NONLINEAR_STEPS = 300       # bench_nonlinear.py's default
LM_STEPS = 60               # bench_lm_butterfly.py's default
# the parameter counts the reference prints (BENCH_quick.json,
# lm_butterfly/final_loss); they depend on no draw
LM_PARAMS = {"smollm-135m-smoke": 139584,
             "smollm-135m-butterfly-smoke": 83314}
# the kernels each path of phases 20-22 drives
PAPER_PATHS = {"layer_api": ("sandwich_fwd", "sandwich_bwd"),
               "sketch": ("butterfly_fwd", "butterfly_bwd"),
               "nonlinear": ("butterfly_fwd", "butterfly_bwd"),
               "lm_butterfly": ("sandwich_fwd", "sandwich_bwd")}


def paper_counts() -> dict:
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import sandwich as ks
    return {"sandwich_fwd": ks.sandwich_forward.launches,
            "sandwich_bwd": ks.sandwich_backward.launches,
            "butterfly_fwd": kb.butterfly_forward.launches,
            "butterfly_bwd": kb.butterfly_backward.launches}


def zero_paper_counts() -> None:
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import sandwich as ks
    ks.sandwich_forward.launches = ks.sandwich_backward.launches = 0
    kb.butterfly_forward.launches = kb.butterfly_backward.launches = 0


def hold_counts(what: str, got: dict, want: dict) -> None:
    """Raises unless every counter in ``got`` is ``want``'s (0 where
    ``want`` has none)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, want {full}")


def _gen(torch, seed: int):
    return torch.Generator().manual_seed(seed)


def phase_layer_api(torch, np, dev, kernel: str, layers=LAYER_API_LAYERS,
                    fit=QUICKSTART_FIT) -> tuple:
    """Phase 20: ``ButterflyLinear.from_dense`` layers' forward through the
    kernels against ``to_dense() @ x`` (+ bias); then the quickstart's fit
    through ``SandwichFn`` with its launches held. Returns (launches of the
    fit, summary)."""
    from repro_torch import nn
    from repro_torch.examples import quickstart
    from repro_torch.kernels import sandwich as ks
    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    tol = LAYER_API_TOL
    for name, n_in, n_out, k_in, k_out, rows, with_bias in layers:
        rng = np.random.default_rng(n_in + n_out)
        W = (rng.normal(size=(n_out, n_in)) / math.sqrt(n_in)).astype(
            np.float32)
        b = rng.normal(size=(n_out,)).astype(np.float32) if with_bias \
            else None
        layer = nn.ButterflyLinear.from_dense(
            _gen(torch, 0), W, bias=b, k_in=k_in, k_out=k_out, device=dev)
        x = torch.randn(rows, n_in, generator=_gen(torch, 1)).to(dev)
        with torch.no_grad():
            got = layer(x, context=kernel)
            want = x @ layer.to_dense().T + (layer.bias if with_bias else 0)
        sync(torch, dev)
        err, share = close_to_max_or_raise(torch, f"layer api {name}", got,
                                           want, tol)
        e31 = quickstart.init_error(layer, torch.from_numpy(W).to(dev),
                                    x[0] / x[0].norm())
        say(f"layer api {name} {n_in}->{n_out} (k {layer.spec.k_in}/"
            f"{layer.spec.k_out}) rows={rows}: from_dense forward "
            f"({kernel}) vs to_dense() @ x{' + bias' if with_bias else ''} "
            f"max|err| {err:.3e} ({share:.1e} of max|want| "
            f"{float(want.abs().max()):.1f}; tol {tol}); Proposition 3.1 "
            f"error at init {e31:.3f} ||W||; params "
            f"{layer.param_count():,} vs dense {layer.dense_param_count():,}")
    n, k, rows, steps = fit
    W = np.random.default_rng(0).normal(size=(n, n)).astype(np.float32)
    W /= np.sqrt(n)
    layer = nn.ButterflyLinear.from_dense(_gen(torch, 0), W, k_in=k,
                                          k_out=k, device=dev)
    Wt = torch.from_numpy(W).to(dev)
    X = torch.randn(rows, n, generator=_gen(torch, 2)).to(dev)
    Y = X @ Wt.T
    # the fit's first step through the kernels against the plain versions
    with torch.no_grad():
        got = layer(X, context=kernel)
        want = layer(X, context="torch")
    sync(torch, dev)
    err = allclose_or_raise(torch, "quickstart fit forward", got, want,
                            SANDWICH_TOL["float32"])
    say(f"layer api quickstart fit forward {rows}x{n} k {k} float32 "
        f"({kernel}) vs plain: max|err| {err:.3e} (tol "
        f"{SANDWICH_TOL['float32']})")
    g = torch.randn(rows, n, generator=_gen(torch, 3)).to(dev)
    check_sandwich_bwd(torch, dev, f"layer api quickstart fit backward "
                       f"{rows}x{n} k {k} float32", layer.spec, layer, X, g,
                       kernel, "float32")
    del got, want, g
    zero_paper_counts()
    losses, times = quickstart.fit(layer, X, Y, steps)
    launches = paper_counts()
    hold_counts("quickstart fit", launches, {
        "sandwich_fwd": on_card * ks.FWD_KERNELS * steps,
        "sandwich_bwd": on_card * ks.BWD_KERNELS * steps})
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"quickstart fit: losses {losses[0]} -> "
                             f"{losses[-1]}")
    p50 = float(np.median(times[1:] or times)) * 1e3
    wall = time.monotonic() - t_phase
    say(f"layer api quickstart fit {n}x{n} k {k}, X {rows}x{n}, {steps} "
        f"Adam steps through SandwichFn: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; step ms p50 {p50:.3f} (each step ends in a wait "
        f"for the device); launches {launches} ({ks.FWD_KERNELS} forward + "
        f"{ks.BWD_KERNELS} backward a step); phase {wall:.1f} s")
    return launches, {"layer_api_fit_step_ms_p50": p50,
                      "layer_api_phase_s": wall}


def profile_sketch_step(torch, dev, spec, w, train) -> dict:
    """One training step of the learned sketch under ``torch.profiler``:
    wall, device busy, and device time in the butterfly kernels, in the
    SVDs (``aten::linalg_svd`` and its backward, children included) and
    in the rest; {} off the card or without device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import sketch
    from repro_torch.launch import paper
    if dev.type != "cuda":
        say("profile sketch: not measured (no card)")
        return {}

    def step():
        sketch.train_butterfly_sketch(spec, None, train, 1,
                                      lr=paper.SKETCH_LR,
                                      batch=paper.SKETCH_BATCH, w0=w,
                                      device=dev)

    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(torch, dev)
        t0 = time.monotonic()
        step()
        sync(torch, dev)
        wall_us = (time.monotonic() - t0) * 1e6
    avg = prof.key_averages()
    kern = [(e.key, e.self_device_time_total, e.count) for e in avg
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e[1] for e in kern)
    if not busy:
        say("profile sketch: device time not measured")
        return {}
    bfly = sum(us for key, us, _ in kern if "butterfly" in key)
    svd_ops = ("aten::linalg_svd",
               "autograd::engine::evaluate_function: LinalgSvdBackward0")
    svd = sum(getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0) for e in avg
              if e.key in svd_ops and e.device_type == DeviceType.CPU)
    rest = busy - bfly - svd
    say(f"profile sketch: one step, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
        f"{sum(e[2] for e in kern)} device launches; butterfly kernels "
        f"{bfly / 1e3:.3f} ms ({100 * bfly / busy:.1f}% of busy), SVDs "
        f"{svd / 1e3:.3f} ms ({100 * svd / busy:.1f}%), the rest "
        f"{rest / 1e3:.3f} ms")
    for key, us, count in sorted(kern, key=lambda e: -e[1])[:8]:
        say(f"profile sketch: {us / 1e3:8.3f} ms {count:5d} launches  "
            f"{key[:90]}")
    return {"sketch_profile_wall_ms": wall_us / 1e3,
            "sketch_profile_busy_ms": busy / 1e3,
            "sketch_profile_butterfly_ms": bfly / 1e3,
            "sketch_profile_svd_ms": svd / 1e3}


def phase_sketch(torch, np, dev, kernel: str, run_=SKETCH_RUN) -> tuple:
    """Phase 21: the learned butterfly sketch (§6) and its four baselines
    on ``hyper_like`` at ``run_``'s shape; the first step's loss and dw
    through the kernels against the plain twins; the butterfly launches
    held; the learned sketch's test error below the untrained FJLT
    butterfly's and the Gaussian's. Returns (launches, summary)."""
    from repro_torch.core import butterfly as bf
    from repro_torch.core import sketch
    from repro_torch.data.synthetic import sketch_datasets
    from repro_torch.kernels import butterfly as kb
    from repro_torch.launch import paper
    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    n, d, ell, k, t_train, t_test, steps = run_
    batch = paper.SKETCH_BATCH
    data, _ = sketch_datasets(n, d, t_train, t_test)
    X = torch.from_numpy(np.stack(data["hyper_like"])).to(dev)
    del data
    train, test = X[:t_train], X[t_train:]
    # the first step's batch (the trainer's draw) through both routes
    spec = sketch.make_spec(_gen(torch, 0), n=n, ell=ell, k=k)
    w0 = bf.fjlt_weights(_gen(torch, 1), spec.pad_n).to(dev)
    idx = np.random.default_rng(0).choice(t_train, size=min(batch, t_train),
                                          replace=False)
    Xb = train[torch.as_tensor(idx, device=dev)]
    first = {}
    for backend in dict.fromkeys((kernel, "torch")):
        w = w0.clone().requires_grad_()
        loss = sketch.reconstruction_loss(
            Xb, sketch.butterfly_sketch(spec, w, Xb, context=backend),
            k).mean()
        first[backend] = (loss.detach(), torch.autograd.grad(loss, [w])[0])
    e_loss = close_to_max_or_raise(torch, "sketch first step loss",
                                   first[kernel][0], first["torch"][0],
                                   SKETCH_TOL)
    e_dw = close_to_max_or_raise(torch, "sketch first step dw",
                                 first[kernel][1], first["torch"][1],
                                 SKETCH_TOL)
    say(f"sketch first step ({batch} x {n}x{d}, ell {ell}, k {k}) through "
        f"{kernel} vs the plain twins: loss {float(first['torch'][0]):.4f} "
        f"max|err| {e_loss[0]:.3e} ({e_loss[1]:.1e} of it), dw max|err| "
        f"{e_dw[0]:.3e} ({e_dw[1]:.1e} of max|want|); tol {SKETCH_TOL}")
    del first, Xb
    base = 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) / 2**20
    zero_paper_counts()
    times = []
    t0 = time.monotonic()
    e = paper.sketch_errors(train, test, ell, k, steps, log_every=1,
                            step_times=times)
    sync(torch, dev)
    wall = time.monotonic() - t0
    launches = paper_counts()
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20 - base
            if on_card else 0.0)
    hold_counts("sketch", launches, {
        "butterfly_fwd": on_card * (steps + t_test),
        "butterfly_bwd": on_card * kb.BWD_KERNELS * steps})
    untrained = sketch.test_error(
        lambda Xi: sketch.butterfly_sketch(e["spec"], e["w0"], Xi), test, k)
    errs = {key: e[key] for key in ("butterfly_learned", "sparse_learned",
                                    "cw_random", "gaussian",
                                    "dense_learned")}
    errs["butterfly_untrained"] = untrained
    bad = [key for key, v in errs.items() if not math.isfinite(v)]
    if bad or not all(math.isfinite(v) for v in e["history"]):
        raise AssertionError(f"sketch: non-finite {bad or 'losses'}")
    if not (errs["butterfly_learned"] < untrained
            and errs["butterfly_learned"] < errs["gaussian"]):
        raise AssertionError(f"sketch: the learned butterfly's test error "
                             f"{errs['butterfly_learned']:.4f} is not below "
                             f"the untrained FJLT's {untrained:.4f} and the "
                             f"Gaussian's {errs['gaussian']:.4f}")
    p50 = float(np.median(times)) * 1e3
    say(f"sketch hyper_like {n}x{d} x {t_train}+{t_test}, ell {ell}, k {k}, "
        f"batch {batch}, {steps} steps: test error "
        + ";".join(f"{key}={v:.4f}" for key, v in errs.items())
        + f"; loss {e['history'][0]:.4f} -> {e['history'][-1]:.4f}")
    say(f"sketch: butterfly step ms p50 {p50:.3f} (kernel call over "
        f"{batch * d} x {spec.pad_n}, two batched SVDs, Adam); all five "
        f"sketches {wall:.2f} s; peak {peak:.1f} MiB above the {base:.1f} "
        f"MiB held before (the data and earlier phases'); launches "
        f"{launches}")
    summary = {"sketch_step_ms_p50": p50, "sketch_peak_mib": peak,
               "sketch_base_mib": base, "sketch_errors": errs}
    summary.update(profile_sketch_step(torch, dev, e["spec"], e["w"],
                                       train))
    summary["sketch_phase_s"] = time.monotonic() - t_phase
    say(f"sketch: phase {summary['sketch_phase_s']:.1f} s")
    return launches, summary


def phase_paper_rows(torch, np, dev, kernel: str, shapes=GATED_SHAPES,
                     nonlinear_steps=NONLINEAR_STEPS, lm_steps=LM_STEPS
                     ) -> tuple:
    """Phase 22: the gated butterfly on the card against the CPU; the
    ``nonlinear/*`` rows with the linear arm's butterfly launches held; the
    ``lm_butterfly/final_loss`` row with its sandwich launches and the
    reference's parameter counts held. Returns ({path: launches},
    summary)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import butterfly as bf
    from repro_torch.kernels import butterfly as kb
    from repro_torch.launch import paper
    from repro_torch.launch.speed import line
    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    for rows, n in shapes:
        gen = _gen(torch, rows + n)
        w = bf.random_weights(gen, n)
        x = torch.randn(rows, n, generator=gen)
        want = bf.butterfly_apply_nonlinear(w, x)
        got = bf.butterfly_apply_nonlinear(w.to(dev), x.to(dev))
        sync(torch, dev)
        err = close_to_max_or_raise(torch, f"gated butterfly {rows}x{n}",
                                    got.cpu(), want, GATED_TOL)
        say(f"gated butterfly {rows}x{n} float32 (tanh GELU) on {dev.type} "
            f"vs the CPU: max|err| {err[0]:.3e} ({err[1]:.1e} of max|want|; "
            f"tol {GATED_TOL})")
    # the linear arm's first step through the kernels against the plain
    # versions, on the bench's inputs
    X, targets, w0 = paper.nonlinear_problem(dev)
    for name, Y in targets.items():
        first = {}
        for backend in dict.fromkeys((kernel, "torch")):
            w = w0.clone().requires_grad_()
            loss = paper.mse(lambda w, X: paper.linear_arm(w, X, backend), w,
                             X, Y)
            first[backend] = (loss.detach(),
                              torch.autograd.grad(loss, [w])[0])
        sync(torch, dev)
        tol = BFLY_TOL["float32"]
        e_loss, e_dw = (close_to_max_or_raise(
            torch, f"nonlinear {name} first step {what}", first[kernel][i],
            first["torch"][i], tol) for i, what in enumerate(("loss", "dw")))
        say(f"nonlinear {name} linear arm first step ({X.shape[0]} x "
            f"{X.shape[1]}, float32) through {kernel} vs the plain twins: "
            f"loss {float(first['torch'][0]):.4f} max|err| {e_loss[0]:.3e}, "
            f"dw max|err| {e_dw[0]:.3e} ({e_dw[1]:.1e} of max|want|); tol "
            f"{tol}")
    del X, targets, w0, first
    # lm_butterfly's first step (the Trainer's model and batch 0, both from
    # its seed) through the kernels against the plain versions
    lm_cfg = registry.get(paper.LM_VARIANTS[1])
    seed = TrainConfig().seed
    say(f"lm_butterfly first step, {lm_cfg.name} seq_len {paper.LM_SEQ_LEN} "
        f"x batch {paper.LM_BATCH}, seed {seed}:")
    phase_train_gradcheck(torch, np, lm_cfg, dev, kernel, paper.LM_SEQ_LEN,
                          paper.LM_BATCH, seed)
    phase_train_step_f32(torch, lm_cfg, dev, kernel, paper.LM_SEQ_LEN,
                         paper.LM_BATCH, seed)
    out = {}
    zero_paper_counts()
    t0 = time.monotonic()
    rows = paper.nonlinear_rows(dev, nonlinear_steps)
    sync(torch, dev)
    t_nl = time.monotonic() - t0
    out["nonlinear"] = paper_counts()
    hold_counts("nonlinear", out["nonlinear"], {
        "butterfly_fwd": on_card * 2 * (nonlinear_steps + 1),
        "butterfly_bwd": on_card * 2 * kb.BWD_KERNELS * nonlinear_steps})
    for r in rows:
        if not all(math.isfinite(r[key]) for key in (
                "linear_butterfly", "gated_butterfly", "target_var")):
            raise AssertionError(f"{r['name']}: not finite: {r['derived']}")
        say("paper: " + line(r))
    zero_paper_counts()
    t0 = time.monotonic()
    lm = paper.lm_butterfly_row(dev, lm_steps)
    t_lm = time.monotonic() - t0
    out["lm_butterfly"] = paper_counts()
    fwd, bwd = train_counts(lm_cfg)
    hold_counts("lm_butterfly", out["lm_butterfly"], {
        "sandwich_fwd": on_card * fwd * lm_steps,
        "sandwich_bwd": on_card * bwd * lm_steps})
    losses = lm["dense_losses"] + lm["butterfly_losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("lm_butterfly: non-finite losses")
    got = {paper.LM_VARIANTS[0]: lm["dense_params"],
           paper.LM_VARIANTS[1]: lm["butterfly_params"]}
    if got != LM_PARAMS:
        raise AssertionError(f"lm_butterfly: parameters {got}, the "
                             f"reference's {LM_PARAMS}")
    say("paper: " + line(lm))
    say(f"lm_butterfly {lm_steps} steps: dense losses "
        f"{lm['dense_losses'][0]:.4f} -> {lm['dense_losses'][-1]:.4f}, "
        f"butterfly {lm['butterfly_losses'][0]:.4f} -> "
        f"{lm['butterfly_losses'][-1]:.4f}; launches {out}")
    wall = time.monotonic() - t_phase
    say(f"paper rows: phase {wall:.1f} s (nonlinear rows {t_nl:.1f} s, "
        f"{4 * nonlinear_steps} Adam steps; lm_butterfly {t_lm:.1f} s, "
        f"{2 * lm_steps} train steps)")
    return out, {"paper_rows_phase_s": wall, "nonlinear_s": t_nl,
                 "lm_butterfly_s": t_lm}


def phase_paper(torch, np, dev, kernel: str, kernels: dict, layers,
                fit, sketch_run, gated, nonlinear_steps, lm_steps) -> dict:
    """Phases 20 to 22; each path's launches join its kernels' entries in
    ``kernels``. Returns the summary."""
    launches, summary = phase_layer_api(torch, np, dev, kernel, layers, fit)
    paths = {"layer_api": launches}
    paths["sketch"], sk = phase_sketch(torch, np, dev, kernel, sketch_run)
    summary.update(sk)
    rows, rs = phase_paper_rows(torch, np, dev, kernel, gated,
                                nonlinear_steps, lm_steps)
    paths.update(rows)
    summary.update(rs)
    for path, counters in PAPER_PATHS.items():
        add_launches(kernels, path, {c: paths[path][c] for c in counters})
    return summary


# ---------------------------------------------------------------------------
# The zoo's paged-servable archs (ROADMAP queue 1, item 5a): the kernels at
# their shapes, serving and training at full width, the MoE's tokens
# ---------------------------------------------------------------------------

ZOO = dict(
    # the paged kernel at each arch's decode shape: (KV heads, query heads
    # per KV head, head dim) = (16, 1, 128), (8, 6, 128), (8, 12, 128),
    # (16, 1, 256), gemma3's (16, 2, 128), internvl2-1b's (2, 7, 64) and
    # seamless-m4t-medium's (16, 1, 64), at the serving engine's 512
    # positions; gemma3's also at the long 2048 (its serving max_len)
    paged=("olmoe-1b-7b", "dbrx-132b", "mistral-large-123b", "gemma-7b",
           "gemma3-27b", "internvl2-1b", "seamless-m4t-medium"),
    paged_long=("gemma3-27b",),
    # the widest sandwich sites: Gemma-7B's MLP (its down site has n1 =
    # 32,768) and head (n2 = 262,144, the kernels' widest output), OLMoE's
    # and DBRX's heads, gemma3's three (up/gate 5376 -> 21,504, down n1 =
    # 32,768, head n2 = 262,144); each at a decode tick's and a check's
    # rows; recurrentgemma's three and xLSTM's head (phase 30);
    # internvl2-1b's three and seamless-m4t-medium's (phase 33: up 1,024
    # -> 4,096, down, head to 256,206, padded n2 262,144)
    sites=(("gemma_up", 3072, 24576), ("gemma_down", 24576, 3072),
           ("gemma_head", 3072, 256000), ("olmoe_head", 2048, 50304),
           ("dbrx_head", 6144, 100352), ("gemma3_up", 5376, 21504),
           ("gemma3_down", 21504, 5376), ("gemma3_head", 5376, 262144),
           ("rgemma_up", 2560, 7680), ("rgemma_down", 7680, 2560),
           ("rgemma_head", 2560, 256000), ("xlstm_head", 768, 50304),
           ("internvl_up", 896, 4864), ("internvl_down", 4864, 896),
           ("internvl_head", 896, 151655), ("seamless_up", 1024, 4096),
           ("seamless_down", 4096, 1024),
           ("seamless_head", 1024, 256206)),
    rows=(SLOTS, 256),
    # served at full width, in this order, each through phase 6's path
    serve=("olmoe-1b-7b-butterfly", "gemma-7b-butterfly"),
    # the MoE's training run: arch, layers kept (Adam's state for all 16
    # would need ~110 GB), (seq_len, batch), (warm, timed) steps
    train=("olmoe-1b-7b-butterfly", 4, (2048, 4), (2, 3)),
    # phase 6a's token case again, on the MoE
    tokens="olmoe-1b-7b-butterfly-smoke",
    # phase 28: gemma3 (5 local : 1 global, 1,024-token windows) on the
    # paged pool with rings beside the pages, whole-prompt admission, at
    # max_len 2048 so that the rings wrap: phase 6's twelve shortest
    # prompts and four of 1,000-1,500 tokens; the probe tick at positions
    # below, at and past the wrap
    windowed=("gemma3-27b-butterfly",
              dict(SERVE_PAGED, max_len=2048, long=(1000, 1020, 1300, 1500),
                   probe=(5, 12, 1000, 1023, 1024, 1025, 1300, 1500))),
    # phase 29: gemma3 trained at one unit and the two-layer local tail
    # (8 of 62 layers: Adam's state for all would not fit), sequences
    # past the window
    windowed_train=("gemma3-27b-butterfly", 8, (2048, 2), (2, 3)),
    # phase 26's windowed token case (window 16)
    windowed_tokens=("gemma3-27b-butterfly-smoke", WINDOW_PROMPTS, 64),
    # phase 30: the recurrent archs on the dense pool at max_len 2048,
    # whole prompts at exact lengths: phase 6's fourteen shortest prompts
    # and two past the mLSTM's chunk of 256 and not multiples of it
    recurrent=tuple((arch, dict(SERVE_DENSE, max_len=2048,
                                long=(1000, 1500)))
                    for arch in ("recurrentgemma-2b-butterfly",
                                 "xlstm-125m-butterfly")),
    # phase 31: both trained at all their layers; recurrentgemma's step
    # profiled (xLSTM's ~200k launches a step would hold the profiler's
    # event processing for minutes)
    recurrent_train=(("recurrentgemma-2b-butterfly", 26, (2048, 2), (2, 3)),
                     ("xlstm-125m-butterfly", 12, (1024, 2), (2, 3))),
    profiled_train=("recurrentgemma-2b-butterfly",),
    # phase 32: their smoke archs' token cases, prompts shorter than the
    # conv's history of 3 rows and one past the smoke mLSTM's chunk of 16
    recurrent_tokens=(("recurrentgemma-2b-butterfly-smoke",
                       "xlstm-125m-butterfly-smoke"), RECURRENT_PROMPTS, 64),
    # phase 33: the vision prefix and the encoder-decoder on phase 6's
    # paged engine (whole prompts in power-of-two buckets, each request's
    # stub inputs from the serving CLI's stream)
    frontends=tuple((arch, SERVE_PAGED)
                    for arch in ("internvl2-1b-butterfly",
                                 "seamless-m4t-medium-butterfly")),
    # phase 34: both trained at all their layers, 2048 text tokens x 2
    # (internvl's 256 prefix tokens and seamless's 1,536 frames besides)
    frontend_train=(("internvl2-1b-butterfly", 24, (2048, 2), (2, 3)),
                    ("seamless-m4t-medium-butterfly", 12, (2048, 2),
                     (2, 3))),
    # phase 35: their smoke archs' token cases on both pools
    frontend_tokens=(("internvl2-1b-butterfly-smoke",
                      "seamless-m4t-medium-butterfly-smoke"), TOKEN_PROMPTS,
                     48),
)


def free_device(torch, dev) -> None:
    """Drop the served model and return cached blocks, so that the next
    full-width model has the card."""
    import gc
    _MODELS.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def phase_zoo_timing(torch, dev, kernel, time_fn, device_fn, zoo) -> dict:
    """The zoo's new kernel shapes in bfloat16: the paged kernel at each
    arch's decode shape (:func:`time_paged`: device time, plain, SDPA,
    bound) and the sandwich forward at each site at 8 rows (kernels, plain,
    a ``torch.matmul`` by the dense matrix, bound, by ``time_fn``)."""
    from repro_torch.configs import registry
    from repro_torch.core import layers as blayers
    from repro_torch.launch import roofline as rl
    from repro_torch.nn import ButterflyLinear
    out = {"paged": {}, "sandwich": {}}
    shapes = [(arch, PAGED_SHAPES[0]) for arch in zoo["paged"]] + [
        (arch, PAGED_SHAPES[1]) for arch in zoo["paged_long"]]
    for arch, shape in shapes:
        zcfg = registry.get(arch)
        p = time_paged(torch, zcfg, dev, kernel, time_fn, device_fn,
                       (arch,) + shape[1:])
        name = arch if shape is PAGED_SHAPES[0] else f"{arch} {shape[0]}"
        out["paged"][name] = {k: p[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms")}
    gen = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for name, n_in, n_out in zoo["sites"]:
            spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
            layer = ButterflyLinear(spec, generator=gen).to(dev)
            x = torch.randn(SLOTS, n_in, generator=gen).to(dev,
                                                           torch.bfloat16)
            ms = time_fn(torch, lambda: sandwich_call(torch, spec, layer, x,
                                                      kernel), reps=100)
            plain = time_fn(torch, lambda: sandwich_call(
                torch, spec, layer, x, "torch"), reps=5)
            eye = torch.eye(n_in, device=dev)
            dense = sandwich_call(torch, spec, layer, eye, kernel).to(x.dtype)
            del eye
            lib = time_fn(torch, lambda: torch.matmul(x, dense), reps=100)
            del dense
            nbytes, ops = rl.sandwich_fwd_work(spec, SLOTS, "bfloat16")
            bnd, by = rl.bound_ms(nbytes, ops, rl.PEAK_FP32)
            say(f"time sandwich {name} {n_in}->{n_out} rows={SLOTS} "
                f"bfloat16: kernels {ms:.4f} ms, plain {plain:.4f} ms, "
                f"matmul by the dense matrix {lib:.4f} ms, bound {bnd:.5f} ms "
                f"({by}: {nbytes} B, {ops} ops){clocks(dev)}")
            out["sandwich"][name] = {"ms": ms, "plain_ms": plain,
                                     "library_ms": lib, "bound_ms": bnd}
    return out


def phase_zoo(torch, np, dev, kernel: str, kernels: dict, time_fn,
              device_fn, zoo=ZOO) -> dict:
    """The zoo phases, each main path with the counts set to 0 just before
    and read just after: serving each of ``zoo["serve"]`` at full width
    (phase 6's checks and readings, :func:`phase_serve`, then its decode
    tick profiled, :func:`phase_profile`), the MoE's training run at
    reduced depth (:func:`phase_train`), its sandwich sites first held
    against plain at the run's rows (:func:`phase_train_sites`), phase
    6a's token
    case on ``zoo["tokens"]`` (eager, incremental, ``spec_k=3``), and the
    timing of the new kernel shapes; the windowed arch's serving, training
    and tokens (phases 26, 28, 29), the recurrent archs' (phases 30-32)
    and the frontend and encoder archs' (phases 33-35) go the same ways.
    Each path's launches join its kernels' entries in ``kernels``. Returns
    the summary."""
    from repro_torch.configs import registry
    summary = {}
    served = [(arch, SERVE_PAGED) for arch in zoo["serve"]]
    for arch, sizes in (served + [zoo["windowed"]]
                        + list(zoo["recurrent"]) + list(zoo["frontends"])):
        free_device(torch, dev)
        t0 = time.monotonic()
        zcfg = registry.get(arch)
        launches, s, _ = phase_serve(torch, np, zcfg, dev, kernel, tag=arch,
                                     sizes=sizes)
        s.update(phase_profile(torch, np, zcfg, dev, tag=arch, sizes=sizes))
        free_device(torch, dev)
        s["phase_s"] = time.monotonic() - t0
        say(f"serve {arch}: phase {s['phase_s']:.1f} s")
        summary[f"serve {arch}"] = s
        add_launches(kernels, f"serve {arch}", {
            c: launches[c] for c in ("sandwich_fwd", "paged_decode_attention")
            if c == "sandwich_fwd" or sizes["pool"] == "paged"})
    trained = ((zoo["train"], zoo["windowed_train"])
               + tuple(zoo["recurrent_train"]) + tuple(zoo["frontend_train"]))
    for arch, layers, (seq_len, batch), steps in trained:
        t0 = time.monotonic()
        full = registry.get(arch).n_layers
        tcfg = registry.get(arch).with_(n_layers=layers)
        say(f"train {arch}: {layers} of {full} layers"
            + (" (depth cut: Adam's state for all would not fit one card)"
               if layers < full else "")
            + f"; units {tcfg.unit_repeats} x {tcfg.block_unit}, tail "
            f"{tcfg.tail_layers}")
        phase_train_sites(torch, tcfg, dev, kernel,
                          train_rows(tcfg, seq_len, batch))
        launches, s = phase_train(torch, np, tcfg, dev, seq_len, batch,
                                  steps=steps,
                                  profile=arch in zoo["profiled_train"])
        free_device(torch, dev)
        s["phase_s"] = time.monotonic() - t0
        say(f"train {arch}: phase {s['phase_s']:.1f} s")
        summary[f"train {arch}"] = s
        add_launches(kernels, f"train {arch}", {
            c: launches[c] for c in ("sandwich_fwd", "sandwich_bwd")})
    phase_serve_tokens(torch, np, dev, zoo["tokens"],
                       modes=("eager", "incremental", "spec"))
    warch, wlens, wmax = zoo["windowed_tokens"]
    phase_serve_tokens(torch, np, dev, warch, modes=("eager",), lens=wlens,
                       max_len=wmax)
    phase_window_refusals(dev, warch)
    phase_serve_tokens(torch, np, dev, modes=("dense",))
    rarchs, rlens, rmax = zoo["recurrent_tokens"]
    for arch in rarchs:
        t0 = time.monotonic()
        phase_serve_tokens(torch, np, dev, arch, modes=("eager",),
                           lens=rlens, max_len=rmax)
        phase_window_refusals(dev, arch)
        say(f"serve tokens {arch}: phase {time.monotonic() - t0:.1f} s")
    farchs, flens, fmax = zoo["frontend_tokens"]
    for arch in farchs:
        t0 = time.monotonic()
        phase_serve_tokens(torch, np, dev, arch, modes=("eager", "dense"),
                           lens=flens, max_len=fmax)
        phase_window_refusals(dev, arch)
        say(f"serve tokens {arch}: phase {time.monotonic() - t0:.1f} s")
    timing = phase_zoo_timing(torch, dev, kernel, time_fn, device_fn, zoo)
    entry(kernels, "sandwich_fwd")["zoo"] = timing["sandwich"]
    entry(kernels, "paged_decode_attention")["zoo"] = timing["paged"]
    return summary


# phase 36: the launch tooling (ROADMAP item 7): the dry-run over every
# registry arch x shape on one H100 (tallied on meta tensors, the card
# idle), held against the models and runs of the phases before it, and the
# tile rule held against the launches they made
LAUNCH = dict(archs=None, shapes=None, limit_s=60.0)
# the cells each kernel's launch names in the tile rule's record, from the
# C calls themselves (kernel, mode) -> a function of the call's arguments
# giving (n, dtype code)
TUNED_CALLS = {
    ("sandwich", "sandwich_fwd", "fwd"): lambda a: (max(a[10], a[12]), a[-2]),
    ("sandwich_bwd", "sandwich_bwd", "bwd"):
        lambda a: (max(a[14], a[17]), a[-2]),
    ("butterfly", "butterfly_fwd", "fwd"): lambda a: (a[4], a[6]),
    ("butterfly_bwd", "butterfly_bwd", "bwd"): lambda a: (a[9], a[14]),
    ("flash", "flash_fwd", "fwd"): lambda a: (a[7], a[11]),
    ("flash_bwd", "flash_bwd_dq", "bwd"): lambda a: (a[9], a[13]),
    ("flash_bwd", "flash_bwd_dkv", "bwd"): lambda a: (a[10], a[14]),
}
LAUNCHED: set = set()
# the butterfly backward's launches: (n, dtype, tile rows, tiles in device
# memory), held against the rule's model of its plans
BFLY_TILES: set = set()


def record_launches() -> None:
    """Wrap the built libraries' launch entry points so that every launch
    adds its (kernel, n, dtype, mode) cell to LAUNCHED: the record the tile
    rule's is held against, taken from the C calls and not from the rule.
    A CUDA graph's capture runs them once, its replays not at all."""
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import flash as kf
    from repro_torch.kernels import sandwich as ks
    libs = {"sandwich": ks._lib, "sandwich_bwd": ks._bwd_lib,
            "butterfly": kb._lib, "butterfly_bwd": kb._bwd_lib,
            "flash": kf._lib, "flash_bwd": kf._bwd_lib}
    codes = {0: "float32", 1: "bfloat16"}
    for (lib, fn, mode), key in TUNED_CALLS.items():
        cdll = libs[lib]()            # the wrappers' own handle
        real = getattr(cdll, fn)
        kernel = lib.split("_")[0]

        def wrapped(*a, _real=real, _key=key, _kernel=kernel, _mode=mode,
                    _fn=fn):
            n, dtype = _key(a)
            LAUNCHED.add((_kernel, int(n), codes[int(dtype)], _mode))
            if _fn == "butterfly_bwd":
                BFLY_TILES.add((int(n), codes[int(dtype)], int(a[12]),
                                a[6] is not None))
            return _real(*a)
        setattr(cdll, fn, wrapped)


def phase_launch_tools(torch, np, dev, kernel: str, sizes=LAUNCH) -> dict:
    """Phase 36. The dry-run (``repro_torch.launch.dryrun``) over
    ``sizes``' archs x shapes (every registry arch and shape by default)
    into a temporary directory, its tables rendered by
    ``repro_torch.launch.report``, its wall held under ``limit_s``; its
    ``param_counts`` equal to the parameters of every full-width model the
    phases before built, and its argument bytes no more than the peak each
    of their runs measured. The tile rule: ``cache_entries()`` names every
    (kernel, n, dtype, mode) the phases launched (:func:`record_launches`)
    and each choice's modeled shared memory fits the device's opt-in limit;
    the butterfly backward's plans agree with the rule's model of them and
    the flash backward's owned rows with the library's; an honoured
    ``block_b`` gives the default's bits and a refused one raises before any
    launch; the Trainer's ``ExecutionRecord.tuning`` is filled on the card
    (on the CPU nothing is queried and it stays empty)."""
    import shutil
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES, ShapeConfig, TrainConfig
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import context as exctx
    from repro_torch.kernels import flash as kf
    from repro_torch.kernels import sandwich as ks
    from repro_torch.kernels import tuning
    from repro_torch.launch import dryrun, report
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import specs
    from repro_torch.train.trainer import Trainer
    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    archs = sizes["archs"] or registry.names()
    shapes = sizes["shapes"] or [s.name for s in SHAPES]
    meshes = dryrun.MESH_CHOICES["all"]
    out = tempfile.mkdtemp(prefix="dryrun_")
    try:
        run_ = dryrun.run(archs, shapes, out, verbose=False, meshes=meshes)
        wall = run_["seconds"]
        if run_["failures"]:
            raise AssertionError(f"dry-run: {run_['failures']} cells failed")
        records = report.load(out)
        if len(records) != len(archs) * len(shapes) * len(meshes):
            raise AssertionError(f"dry-run: {len(records)} JSONs for "
                                 f"{len(archs)} x {len(shapes)} x "
                                 f"{len(meshes)} cells")
        one = [r for r in records if r["mesh"] == dryrun.MESH]
        for line in report.render(one).splitlines():
            say(f"dryrun | {line}" if line else "dryrun |")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    pods = {(r["arch"], r["shape"], r["mesh"]): r for r in records
            if r["mesh"] != dryrun.MESH and r["status"] == "ok"}
    for r in one:
        if r["status"] != "ok":
            continue
        say(f"dryrun pods {r['arch']} x {r['shape']}: " + "; ".join(
            f"{m} {p['argument_bytes'] / 1e9:.3f} GB a card, fit "
            f"{p['hbm_fit']}" for m in meshes[1:]
            for p in [pods[r["arch"], r["shape"], m]]))
    ok = sum(r["status"] == "ok" for r in records)
    say(f"dryrun: {ok} tallied, {len(records) - ok} skipped, 0 failed over "
        f"{len(archs)} archs x {len(shapes)} shapes x {len(meshes)} meshes "
        f"({', '.join(meshes)}; collectives not modelled) in {wall:.1f} s "
        f"(limit {sizes['limit_s']} s); {rl.CARD} bounds")
    if sizes["limit_s"] and wall > sizes["limit_s"]:
        raise AssertionError(f"dry-run took {wall:.1f} s, over "
                             f"{sizes['limit_s']} s")

    # the dry-run's counts against the models and runs the phases made
    for name, (cfg, numel) in sorted(BUILT.items()):
        total, active = specs.param_counts(cfg)
        if total != numel:
            raise AssertionError(f"{name}: param_counts {total} != the "
                                 f"built model's {numel} parameters")
        say(f"dryrun params {name} ({cfg.n_layers} layers): param_counts "
            f"{total} (active {active}) = the model built on "
            f"{dev.type}")
    for kind, cfg, (seq_len, batch), peak in PEAKS:
        shape = ShapeConfig(kind, seq_len, batch,
                            "train" if kind == "train" else "decode")
        args = dryrun.argument_bytes(cfg, shape)["total"]
        if on_card and args > peak:
            raise AssertionError(f"{kind} {cfg.name}: the dry-run's "
                                 f"argument bytes {args} exceed the run's "
                                 f"measured peak {peak}")
        say(f"dryrun args {kind} {cfg.name} {seq_len} x {batch}: "
            f"{args / 2**20:.1f} MiB <= measured peak "
            + (f"{peak / 2**20:.1f} MiB" if on_card else "not measured "
               "(no card)"))

    # the tile rule against the launches
    entries = tuning.cache_entries()
    choices = tuning.choices()
    limit = rl.smem_optin_bytes()
    for k, n, dtype, mode in sorted(LAUNCHED):
        key = f"{k}/{mode}/n{n}/{dtype}"
        if key not in entries:
            raise AssertionError(f"tile rule: no choice recorded for the "
                                 f"launched {key}")
    for key, c in sorted(choices.items()):
        if c.smem_bytes > limit or c.smem_limit != limit:
            raise AssertionError(f"tile rule {key}: modeled shared memory "
                                 f"{c.smem_bytes} over the opt-in {limit}")
        if c.kernel == "flash" and c.mode == "bwd" and on_card:
            lib = kf.tile_rows(c.n, getattr(torch, c.dtype))
            if lib != (c.block_q, c.block_kv):
                raise AssertionError(f"tile rule {key}: flash rows "
                                     f"{(c.block_q, c.block_kv)}, library "
                                     f"{lib}")
    for n, dtype, tile, in_device in sorted(BFLY_TILES):
        c = tuning.choice("butterfly", n, dtype, "bwd")
        if tile not in c.takes or in_device != c.tiles_in_device_memory:
            raise AssertionError(f"tile rule butterfly/bwd n={n} {dtype}: "
                                 f"launched tile {tile} (in device memory "
                                 f"{in_device}), the rule's model takes "
                                 f"{c.takes[0]}..{c.takes[-1]} (in device "
                                 f"memory {c.tiles_in_device_memory})")
    say(f"tuning: {len(entries)} choices, every one of the {len(LAUNCHED)} "
        f"launched cells named; modeled shared memory within the opt-in "
        f"{limit} B: " + (tuning.describe() if entries else
                          "no kernel tuning queried (plain versions)"))
    if not on_card and entries:
        raise AssertionError("the plain versions queried the tile rule")

    # overrides: honoured (the same bits) or refused before any launch
    n, rows = 1024, 300
    x, w, g = butterfly_case(torch, rows, n, "float32", dev, seed=50)
    fwd_b = tuning.choice("butterfly", n, "float32", "fwd").block_b
    bwd = tuning.choice("butterfly", n, "float32", "bwd")
    base_y = kb.butterfly_forward(x, w, context=kernel)
    base = kb.butterfly_backward(x, w, g, context=kernel)
    plan_tile = (tuning.butterfly_bwd_plan(rows, n, False, "float32",
                                           dev.index or 0)[3]
                 if on_card else None)
    honoured = next(b for b in bwd.takes if b != plan_tile and b != fwd_b)
    for b, what in ((fwd_b, "fwd"), (honoured, "bwd")):
        ctx = exctx.ExecutionContext(backend=kernel, block_b=b)
        if what == "fwd":
            same = torch.equal(kb.butterfly_forward(x, w, context=ctx),
                               base_y)
        else:
            if on_card:
                tile = tuning.butterfly_bwd_plan(rows, n, False, "float32",
                                                 dev.index or 0, b)[3]
                if tile != b:
                    raise AssertionError(f"block_b={b}: launch tile {tile}")
            got = kb.butterfly_backward(x, w, g, context=ctx)
            same = all(torch.equal(u, v) for u, v in zip(got, base))
        if not same:
            raise AssertionError(f"butterfly {what} at block_b={b}: not the "
                                 f"default's bits")
    counts = (kb.butterfly_forward.launches, kb.butterfly_backward.launches,
              ks.sandwich_forward.launches)
    refused = []
    for b, call in ((honoured + 1, lambda c: kb.butterfly_backward(
            x, w, g, context=c)), (fwd_b * 2, lambda c: kb.butterfly_forward(
            x, w, context=c))):
        try:
            call(exctx.ExecutionContext(backend=kernel, block_b=b))
        except ValueError as e:
            refused.append(str(e).split(" (")[0])
            continue
        raise AssertionError(f"block_b={b} was not refused")
    spec, layer = sandwich_site(torch, registry.get(
        "smollm-135m-butterfly-smoke"), "up_gate", dev)
    xs = torch.randn(8, spec.n_in, device=dev)
    try:
        with torch.no_grad():
            sandwich_call(torch, spec, layer, xs, exctx.ExecutionContext(
                backend=kernel, block_b=32))
        raise AssertionError("sandwich block_b=32 was not refused")
    except ValueError as e:
        refused.append(str(e).split(" (")[0])
    if (kb.butterfly_forward.launches, kb.butterfly_backward.launches,
            ks.sandwich_forward.launches) != counts:
        raise AssertionError("a refused block_b launched a kernel")
    say(f"tuning overrides: butterfly {rows}x{n} float32 forward block_b="
        f"{fwd_b} and backward block_b={honoured} (plan tile {plan_tile}) "
        f"give the default's bits; refused before any launch: "
        + "; ".join(refused))
    del x, w, g, base, base_y

    # the Trainer's record
    tcfg = registry.get("smollm-135m-butterfly-smoke")
    trainer = Trainer(tcfg, TrainConfig(warmup_steps=2, checkpoint_every=0),
                      seq_len=16, global_batch=2, device=dev)
    tuned = trainer.run(1).execution.tuning
    if on_card != bool(tuned):
        raise AssertionError(f"ExecutionRecord.tuning {tuned!r} on "
                             f"{dev.type}")
    say(f"tuning record: Trainer on {dev.type}: "
        f"{tuned[:160] if tuned else repr(tuned)}")
    phase_s = time.monotonic() - t_phase
    say(f"launch tools: phase {phase_s:.1f} s")
    return {"dryrun_s": wall, "dryrun_cells": len(records),
            "launch_tools_s": phase_s, "tuning_choices": len(entries)}


# phase 37's sizes: the three full-width sites at the training run's rows
# (and one fewer: the padded case), the encoder's butterfly shape, the
# training run (seq_len, global batch, steps), the CLI's smoke run (arch,
# steps, seq_len, global batch)
MESH = dict(ranks=2, rows=(8192, 8191), butterfly=(70000, 1024),
            train=(256, 4, 3), cli=("smollm-135m-butterfly-smoke", 2, 32, 4),
            budget_s=90.0)
SITE_TOL = 1e-5             # the reference's sharded-vs-unsharded gate
MESH_LOSS_TOL = ((1e-4, 0.0), (5e-3, 1e-4))   # (rtol, atol): first, all


def _mb(n: float) -> str:
    return f"{n / 2**20:.2f} MiB"


def _per_call(stats: dict) -> str:
    """A collectives' record as calls, bytes and ms per call."""
    return "; ".join(
        f"{k} {int(v['calls'])} calls, {_mb(v['bytes'] / max(v['calls'], 1))}"
        f" and {1e3 * v['seconds'] / max(v['calls'], 1):.3f} ms a call"
        for k, v in stats.items() if v["calls"])


def phase_mesh(torch, np, cfg, dev, kernel: str, kernels: dict,
               sizes=MESH) -> dict:
    """Phase 37, training on a butterfly data mesh
    (:mod:`repro_torch.runtime.butterfly_sharding`): ``sizes["ranks"]``
    ranks of one world on ``dev`` (:func:`repro_torch.runtime.dist.
    spawn_ranks`; on one card they share it over gloo), the rank side in
    :mod:`repro_torch.launch.mesh_check`.

    a. The world: backend, each rank's device, the collectives the backend
       took on its tensors; on a card also a one-rank NCCL world's
       all_reduce and NCCL's version.
    b. ``sharded_sandwich_apply`` at ``cfg``'s three sites at each of
       ``sizes["rows"]`` and ``sharded_butterfly_apply`` at
       ``sizes["butterfly"]`` on a ``(ranks,)`` mesh against ``kernel``
       alone on the same inputs: forward within SITE_TOL (rtol and atol),
       every gradient within GRAD_TOL of max|want|, the ranks' results
       equal bit for bit; each rank's launches and the collectives' bytes
       and ms a call.
    c. ``cfg`` trained in float32 from seed 0 at ``sizes["train"]``, first
       unsharded in this process, then on the mesh: losses within
       MESH_LOSS_TOL, every butterfly leaf after the last step within
       STEP_F32_TOL of the unsharded run in relative norm, the ranks'
       parameters equal bit for bit, ``mesh_layout`` ``data=<ranks>``, each
       rank's sandwich launches a step the unsharded run's. Step p50, peak
       memory and the collectives' ms a step per rank.
    d. The training CLI with ``--simulated-devices`` and ``--mesh-shape``
       as a subprocess: rc 0, its ``[train]`` lines.

    A failed rank fails the phase. Returns a summary."""
    import os

    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh_check
    from repro_torch.models import common as cm
    from repro_torch.runtime import dist as rdist
    from repro_torch.train.trainer import Trainer
    t_phase = time.monotonic()
    n = sizes["ranks"]
    free_device(torch, dev)
    on_card = dev.type == "cuda"
    from repro_torch.kernels import butterfly as kb
    from repro_torch.kernels import sandwich as ks

    # c, first half: the unsharded run, here
    seq, batch, steps = sizes["train"]
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=20,
                     checkpoint_every=0)
    mesh_check.zero_launches()
    trainer = Trainer(mesh_check.mesh_config(cfg, None), tc, seq_len=seq,
                      global_batch=batch, device=dev)
    base = trainer.run(steps)
    sync(torch, dev)
    base_per_step = {k: v / steps for k, v in mesh_check.launches().items()}
    base_leaves = {name: p.detach().float().cpu().numpy()
                   for name, p in trainer.model.named_parameters()
                   if name.endswith(mesh_check.LEAVES)}
    del trainer
    free_device(torch, dev)
    if on_card:
        # a one-rank NCCL world, joined here: the backend of ranks that
        # each own a card
        rdist.init_world(0, 1, f"tcp://localhost:{rdist._free_port()}",
                         "cuda")
        try:
            nccl = mesh_check.probe_nccl()
        finally:
            rdist.shutdown()

    # the ranks: a, b and c's second half in one world
    bc = cfg.butterfly
    specs = [(name, cm.site_butterfly_spec(bc.seed, key, n_in, n_out,
                                           bc.k_factor, bc.use_bias))
             for name, (key, n_in, n_out) in sites(cfg).items()]
    t_ranks = time.monotonic()
    per_rank = rdist.spawn_ranks(
        n, mesh_check.phase, specs, sizes["rows"], sizes["butterfly"], (n,),
        kernel, mesh_check.mesh_config(cfg, (n,)), tc, seq, batch, steps,
        device=dev.type)
    say(f"mesh ranks: {n} spawned, their work and exit "
        f"{time.monotonic() - t_ranks:.1f} s")

    # a. the world and its collectives
    for r in per_rank:
        p = r["probe"]
        say(f"mesh world: {p['world']}; took {', '.join(p['took'])}"
            + (f"; refused {p['refused']}" if p["refused"] else ""))
    if on_card:
        say(f"mesh nccl: {nccl['world']}, NCCL {nccl['nccl']}, all_reduce "
            f"of 4 MiB {nccl['ms']:.3f} ms")

    # b. the sites against the kernel alone
    want_launches = {"sandwich": {"sandwich_fwd": ks.FWD_KERNELS,
                                  "sandwich_bwd": ks.BWD_KERNELS,
                                  "butterfly_fwd": 0, "butterfly_bwd": 0},
                     "butterfly": {"sandwich_fwd": 0, "sandwich_bwd": 0,
                                   "butterfly_fwd": 1,
                                   "butterfly_bwd": kb.BWD_KERNELS}}
    worst = {"fwd": 0.0, "grad": 0.0}
    for i, case in enumerate(per_rank[0]["sites"]["cases"]):
        what = case["what"]
        others = [r["sites"]["cases"][i] for r in per_rank]
        if len({c["digest"] for c in others}) != 1:
            raise AssertionError(f"mesh site {what}: the ranks differ "
                                 f"({[c['digest'] for c in others]})")
        for c in others:
            want = {k: v * on_card for k, v in
                    want_launches[what.split()[0]].items()}
            if c["launches"] != want:
                raise AssertionError(f"mesh site {what}: rank launches "
                                     f"{c['launches']}, expected {want}")
        if not case["fwd_ok"] or not case["grad_err"] <= GRAD_TOL["float32"]:
            raise AssertionError(
                f"mesh site {what}: forward max|Δ| {case['fwd_err']:.3e} "
                f"(rtol/atol {SITE_TOL}: {case['fwd_ok']}), gradients "
                f"max|Δ|/max|want| {case['grad_err']:.3e} (tol "
                f"{GRAD_TOL['float32']})")
        worst["fwd"] = max(worst["fwd"], case["fwd_err"])
        worst["grad"] = max(worst["grad"], case["grad_err"])
        say(f"mesh site {what} on {n} ranks vs {kernel} alone: forward "
            f"max|Δ| {case['fwd_err']:.3e}, gradients max|Δ|/max|want| "
            f"{case['grad_err']:.3e}; sharded {case['ms']:.2f} ms vs "
            f"{case['local_ms']:.2f} ms alone; each rank's launches "
            f"{case['launches']}; {_per_call(case['collectives'])}")
    bfly = per_rank[0]["sites"]["cases"][-1]
    add_launches(kernels, "mesh butterfly rank 0",
                 {k: v for k, v in bfly["launches"].items()
                  if k.startswith("butterfly")})

    # c. training on the mesh against the unsharded run
    ranks = [r["train"] for r in per_rank]
    (rtol0, atol0), (rtol, atol) = MESH_LOSS_TOL
    for r in ranks:
        got, want = np.array(r["losses"]), np.array(base.losses)
        ok = (abs(got[0] - want[0]) <= atol0 + rtol0 * abs(want[0])
              and np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))
        if not ok or r["mesh_layout"] != f"data={n}":
            raise AssertionError(f"mesh train rank {r['rank']}: losses "
                                 f"{r['losses']} vs unsharded "
                                 f"{base.losses}, layout "
                                 f"{r['mesh_layout']!r}")
        if r["launches_per_step"] != base_per_step:
            raise AssertionError(f"mesh train rank {r['rank']}: launches a "
                                 f"step {r['launches_per_step']} vs "
                                 f"unsharded {base_per_step}")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError(f"mesh train: the ranks' parameters differ "
                             f"({[r['digest'] for r in ranks]})")
    rel = {k: float(np.linalg.norm(v - base_leaves[k])
                    / max(np.linalg.norm(base_leaves[k]), 1e-30))
           for k, v in ranks[0]["leaves"].items()}
    if set(rel) != set(base_leaves) or not max(rel.values()) <= STEP_F32_TOL:
        bad = {k: v for k, v in rel.items() if not v <= STEP_F32_TOL}
        raise AssertionError(f"mesh train: butterfly leaves beyond "
                             f"{STEP_F32_TOL}: {dict(list(bad.items())[:5])}")
    say(f"mesh train {cfg.name} float32, {seq} x {batch}, {steps} steps, "
        f"unsharded vs {n} ranks: losses "
        + " ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(base.losses,
                                                        ranks[0]["losses"]))
        + f"; {len(rel)} butterfly leaves, relative norm of the difference "
        f"max {max(rel.values()):.3e}; ranks bit-identical "
        f"({ranks[0]['digest']}); {ranks[0]['exec']}; launches a step "
        f"{base_per_step}")
    summary = {"mesh_train_losses": ranks[0]["losses"],
               "mesh_train_unsharded_losses": base.losses,
               "mesh_leaf_rel_max": max(rel.values())}
    base_ms = sorted(1e3 * t for t in base.step_times)
    say(f"mesh train unsharded: step p50 {base_ms[len(base_ms) // 2]:.1f} "
        f"ms (steps " + " ".join(f"{t:.1f}" for t in base_ms) + ")")
    for r in ranks:
        ms = sorted(1e3 * t for t in r["step_times"])
        coll = " ".join(f"{k} {1e3 * v['seconds'] / steps:.2f} ms "
                        f"({v['calls'] / steps:.0f} calls, "
                        f"{_mb(v['bytes'] / steps)})"
                        for k, v in r["collectives"].items() if v["calls"])
        peak = ("not measured (no card)" if r["peak_mib"] is None
                else f"{r['peak_mib']:.1f} MiB")
        say(f"mesh train rank {r['rank']}: step p50 {ms[len(ms) // 2]:.1f} "
            f"ms (steps " + " ".join(f"{t:.1f}" for t in ms) + f"), peak "
            f"{peak}; a step's collectives: {coll}")
        summary[f"mesh_rank{r['rank']}_step_p50_ms"] = ms[len(ms) // 2]
    add_launches(kernels, "mesh train rank 0",
                 {k: int(v * steps) for k, v in
                  ranks[0]["launches_per_step"].items()
                  if k.startswith("sandwich")})

    # d. the CLI
    arch, cli_steps, cli_seq, cli_batch = sizes["cli"]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--simulated-devices", str(n), "--mesh-shape", str(n), "--device",
           dev.type, "--steps", str(cli_steps), "--seq-len", str(cli_seq),
           "--global-batch", str(cli_batch), "--checkpoint-every", "0"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    done = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(ROOT))
    lines = [ln for ln in done.stdout.splitlines()
             if ln.startswith("[train]")]
    for ln in lines:
        say(f"mesh cli: {ln}")
    if (done.returncode != 0 or len(lines) != 2
            or not lines[1].endswith(f"mesh=data={n}]")):
        raise AssertionError(f"mesh cli: rc {done.returncode}, "
                             f"{len(lines)} [train] lines; stderr "
                             f"{done.stderr[-2000:]}")
    phase_s = time.monotonic() - t_phase
    say(f"mesh: phase {phase_s:.1f} s (budget {sizes['budget_s']} s)")
    summary["mesh_s"] = phase_s
    summary["mesh_site_err"] = dict(worst)
    return summary


# phase 38's sizes: the ranks, the engine (slots, max_len, chunk), the
# requests (count, shortest and longest prompt, new tokens), the CLI's
# (arch, requests) and the phase's budget
MESH_SERVE = dict(ranks=2, engine=(SLOTS, MAX_LEN, CHUNK),
                  requests=(8, 5, 200, 16),
                  cli=("smollm-135m-butterfly-smoke", 6), budget_s=120.0)
MESH_GROUP_TIMEOUT = 300.0   # a rank's wait for its peer's collective


def _decode_ticks(records) -> list:
    """The records of pure decode ticks (no prefill chunk)."""
    return [r for r in records if r["decode"] and not r["chunk"]]


def _p50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_mesh_serve(torch, np, cfg, dev, kernel: str, kernels: dict,
                     sizes=MESH_SERVE) -> dict:
    """Phase 38, sharded serving (:mod:`repro_torch.serve.mesh_serve`):
    ``cfg`` in float32 from seed 0 served greedily, first unsharded here
    (graphed on a card), then by ``sizes["ranks"]`` ranks of one world on
    ``dev`` over a ``(ranks,)`` mesh (:func:`repro_torch.launch.
    mesh_check.serve`; on one card they share it over gloo). Every rank's
    tokens equal the unsharded run's; the ranks' ticks equal; each rank's
    pure decode ticks launch ``FWD_KERNELS`` at every site and
    ``PAGED_KERNELS`` at every layer (none off the card) and gather once a
    site. Printed: the decode tick's p50 on the mesh and unsharded, the
    gathers' share of a mesh tick, each rank's peak memory. Then the
    serving CLI on the mesh with two replicas, as a subprocess. A failed
    rank fails the phase. Returns a summary."""
    import os

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import mesh_check
    from repro_torch.runtime import dist as rdist
    from repro_torch.serve import Request, ServeEngine, loader
    t_phase = time.monotonic()
    n = sizes["ranks"]
    slots, max_len, chunk = sizes["engine"]
    count, lo, hi, max_new = sizes["requests"]
    on_card = dev.type == "cuda"
    cfg = cfg.with_(compute_dtype="float32")
    rng = np.random.default_rng(38)
    lens = rng.permutation(np.linspace(lo, hi, count).astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
               for k in lens]
    if max(lens) <= chunk:
        raise AssertionError("mesh serve: no prompt spans two chunks")
    free_device(torch, dev)

    # the unsharded engine, here
    model = loader.init_params(cfg, seed=0, device=dev)
    built(cfg, model)
    eng = ServeEngine(cfg, model, slots=slots, max_len=max_len,
                      prefill_chunk=chunk, device=dev)
    futs = [eng.submit(Request(prompt=p, max_new_tokens=max_new))
            for p in prompts]
    base_ms = []
    while eng.has_work():
        m = eng.metrics
        c0, d0 = m.chunk_ticks, m.decode_steps
        sync(torch, dev)
        t0 = time.perf_counter()
        eng.step()
        sync(torch, dev)
        if m.decode_steps > d0 and m.chunk_ticks == c0:
            base_ms.append((time.perf_counter() - t0) * 1e3)
    want = [f.result(0).tokens for f in futs]
    base_ticks = eng.metrics.ticks
    graphed = eng.graphs.captures
    del eng, model, futs
    free_device(torch, dev)

    # the mesh
    t_ranks = time.monotonic()
    per_rank = rdist.spawn_ranks(
        n, mesh_check.serve, cfg, prompts, slots, max_len, chunk, max_new,
        MESH_GROUP_TIMEOUT, device=dev.type, group_timeout=MESH_GROUP_TIMEOUT)
    ranks_s = time.monotonic() - t_ranks
    per_tick, _ = sandwich_sites(cfg)
    want_tick = {"sandwich": on_card * ks.FWD_KERNELS * per_tick,
                 "paged": on_card * pa.PAGED_KERNELS * paged_per_tick(cfg),
                 "gathers": per_tick}
    summary = {}
    for r in per_rank:
        if r["tokens"] != want:
            bad = [i for i, (a, b) in enumerate(zip(r["tokens"], want))
                   if a != b]
            raise AssertionError(f"mesh serve rank {r['rank']}: tokens of "
                                 f"requests {bad} differ from the unsharded "
                                 f"engine's")
        if (r["ticks"] != per_rank[0]["ticks"] or r["layout"] != f"data={n}"
                or r["captures"]):
            raise AssertionError(f"mesh serve rank {r['rank']}: ticks "
                                 f"{r['ticks']} (rank 0 "
                                 f"{per_rank[0]['ticks']}), layout "
                                 f"{r['layout']!r}, captures {r['captures']}")
        dec = _decode_ticks(r["records"])
        for rec in dec:
            got = {k: rec[k] for k in want_tick}
            if got != want_tick:
                raise AssertionError(f"mesh serve rank {r['rank']}: a decode "
                                     f"tick's {got}, expected {want_tick}")
        ms = _p50([x["ms"] for x in dec])
        share = (sum(x["gather_ms"] for x in dec)
                 / max(sum(x["ms"] for x in dec), 1e-9))
        peak = ("not measured (no card)" if r["peak_mib"] is None
                else f"{r['peak_mib']:.1f} MiB")
        say(f"mesh serve rank {r['rank']} ({r['world']}): {len(prompts)} "
            f"requests, {r['ticks']} ticks, tokens equal to the unsharded "
            f"engine's; decode tick p50 {ms:.2f} ms over {len(dec)} ticks "
            f"(gathers {100 * share:.1f}% of it), launches a decode tick "
            f"{want_tick['sandwich']} sandwich, {want_tick['paged']} paged, "
            f"{want_tick['gathers']} gathers; peak {peak}")
        summary[f"mesh_serve_rank{r['rank']}_decode_p50_ms"] = ms
        summary[f"mesh_serve_rank{r['rank']}_gather_share"] = share
    base = _p50(base_ms) if base_ms else float("nan")
    say(f"mesh serve unsharded ({'graphed' if graphed else 'eager'}): "
        f"{base_ticks} ticks, decode tick p50 {base:.2f} ms over "
        f"{len(base_ms)} ticks; ranks spawned, served and exited in "
        f"{ranks_s:.1f} s")
    summary["mesh_serve_unsharded_decode_p50_ms"] = base
    r0 = per_rank[0]["records"]
    add_launches(kernels, "mesh serve rank 0",
                 {"sandwich_fwd": sum(x["sandwich"] for x in r0),
                  "paged_decode_attention": sum(x["paged"] for x in r0)})

    # the CLI
    arch, requests = sizes["cli"]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--simulated-devices", str(n), "--mesh-shape", str(n),
           "--replicas", "2", "--device", dev.type, "--requests",
           str(requests), "--max-new", "4", "--rate", "50"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    done = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(ROOT))
    lines = [ln for ln in done.stdout.splitlines()
             if ln.startswith("[serve]")]
    for ln in lines:
        say(f"mesh serve cli: {ln}")
    if (done.returncode != 0 or not lines
            or not lines[0].endswith(f"| mesh=data={n}")
            or not any(ln.startswith(f"[serve] router: {requests} requests")
                       for ln in lines)):
        raise AssertionError(f"mesh serve cli: rc {done.returncode}, "
                             f"[serve] lines {lines}; stderr "
                             f"{done.stderr[-2000:]}")
    phase_s = time.monotonic() - t_phase
    say(f"mesh serve: phase {phase_s:.1f} s (budget {sizes['budget_s']} s)")
    if sizes["budget_s"] and phase_s > sizes["budget_s"]:
        raise AssertionError(f"mesh serve: phase {phase_s:.1f} s over its "
                             f"budget {sizes['budget_s']} s")
    summary["mesh_serve_s"] = phase_s
    return summary


# phase 39's sizes: the ranks; the MoE layer (arch, moe_token_chunk, its
# (dtype, batch, seq) shapes); the MoE LM (arch, layers, seq, batch); the
# pipeline (arch, stages, batch, seq, microbatches); the phase's budget
EP_PIPE = dict(ranks=2,
               layer=("olmoe-1b-7b", 8192, (("float32", 8, 2048),
                                            ("bfloat16", 4, 2048))),
               lm=("olmoe-1b-7b-butterfly", 2, 1024, 2),
               pipeline=("smollm-135m-butterfly", 2, 8, 256, 4),
               budget_s=90.0)
EP_TOL = {"float32": 1e-4,    # of each leaf's max|want|
          "bfloat16": 5e-2}   # relative norm
PIPE_TOL = (2e-4, 1e-3)       # forward, gradients: of max|want|


def _coll(stats: dict, kind: str) -> str:
    s = stats[kind]
    return (f"{kind} {int(s['calls'])} calls, {_mb(s['bytes'])}, "
            f"{s['seconds']:.3f} s")


def _held(what: str, errs: dict, rule: str, tol: float) -> float:
    """The worst error of ``errs`` (name -> :func:`mesh_check._errs`) by
    ``rule`` (``"max"``: max|Δ| over max|want|, ``"rel"``: relative
    norm); raises past ``tol`` or on a value that is not finite."""
    worst = 0.0
    for name, e in errs.items():
        err = e["max"] / max(e["scale"], 1e-30) if rule == "max" \
            else e["rel"]
        if not e["finite"] or not err <= tol:
            raise AssertionError(f"{what}: {name} {rule} error {err:.3e} "
                                 f"beyond {tol} (finite {e['finite']})")
        worst = max(worst, err)
    return worst


def phase_ep_pipeline(torch, np, dev, kernel: str, kernels: dict,
                      sizes=EP_PIPE) -> dict:
    """Phase 39, expert parallelism and the GPipe pipeline (ROADMAP 6d):
    ``sizes["ranks"]`` ranks of one world on ``dev``, spawned once
    (:func:`repro_torch.launch.mesh_check.ep_pipeline`; on one card they
    share it over gloo).

    a. The MoE layer of ``sizes["layer"]``'s arch at each of its shapes on
       a ``(model,)`` mesh of the ranks, against the port's one-rank
       ``moe_apply`` run chunk by chunk on rank 0 without the mesh: the
       output, the aux loss and every gradient of ``sum(c * y) + aux``
       within EP_TOL (float32: max|Δ| over each leaf's max|want|;
       bfloat16: relative norm), the ranks' results' checksums equal.
       Then the MoE LM of ``sizes["lm"]`` (float32, its first layers),
       one forward and backward under the same mesh against the same
       model on rank 0 without it: the loss and every butterfly leaf's
       gradient within STEP_F32_TOL (relative), the ranks' losses equal,
       and each rank's sandwich launches those of the run without the
       mesh.
    b. ``sizes["pipeline"]``'s arch's residual MLP block, stacked over the
       stages, through ``pipeline_apply`` on a ``(stage,)`` mesh of the
       ranks against ``reference_apply`` on rank 0: the forward and every
       gradient within PIPE_TOL of max|want|; each rank's sandwich
       launches those of its microbatches' stage calls; the handover's
       route and its calls, bytes and seconds.

    Printed: each part's ms a call on the mesh and alone, the
    all-reduces' (and shifts') calls, bytes and seconds. A failed rank or
    check fails the phase, and so does a wall past ``sizes["budget_s"]``.
    Returns a summary."""
    from repro_torch.kernels import sandwich as ks
    from repro_torch.launch import mesh_check
    from repro_torch.runtime import dist as rdist
    t_phase = time.monotonic()
    n = sizes["ranks"]
    on_card = dev.type == "cuda"
    if sizes["pipeline"][1] != n:
        raise AssertionError(f"ep pipeline: {sizes['pipeline'][1]} stages "
                             f"on {n} ranks")
    free_device(torch, dev)
    per_rank = rdist.spawn_ranks(n, mesh_check.ep_pipeline, sizes, kernel,
                                 device=dev.type,
                                 group_timeout=MESH_GROUP_TIMEOUT)
    r0 = per_rank[0]
    for r in per_rank:
        say(f"ep world: {r['world']}"
            + (f"; peak {r['peak_mib']:.1f} MiB" if on_card else "")
            + "; walls " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in r["walls"].items()))
    summary = {}

    # a. the layer
    arch, chunk, _ = sizes["layer"]
    for i, layer in enumerate(r0["layer"]):
        dt, tokens = layer["dtype"], layer["tokens"]
        what = f"ep layer {arch} {dt} {tokens} tokens"
        if any(r["layer"][i]["checksums"] != layer["checksums"]
               for r in per_rank):
            raise AssertionError(f"{what}: the ranks differ")
        for r in per_rank:
            if r["layer"][i]["collectives"]["all_reduce"]["calls"] != 3:
                raise AssertionError(
                    f"{what}: rank {r['rank']} took "
                    f"{r['layer'][i]['collectives']} (the expert-parallel "
                    f"path all-reduces the output, the aux loss and the "
                    f"gradients)")
        rule = "max" if dt == "float32" else "rel"
        worst = _held(what, layer["errs"], rule, EP_TOL[dt])
        chunks = tokens // chunk if tokens > chunk and not tokens % chunk \
            else 1
        say(f"{what} ({chunks} chunk(s) of {min(chunk, tokens)}) on {n} "
            f"model ranks vs one rank chunk by chunk: worst {rule} error "
            f"{worst:.3e} (y {layer['errs']['y'][rule]:.3e}, aux "
            f"{layer['errs']['aux']['rel']:.3e}); ms a call (forward and "
            f"backward) "
            + ", ".join(f"rank {r['rank']} {r['layer'][i]['ms']:.1f}"
                        for r in per_rank)
            + f", alone {layer['alone_ms']:.1f}; rank 0's "
            + _coll(layer["collectives"], "all_reduce"))
        summary[f"ep_layer_{dt}_ms"] = layer["ms"]
        summary[f"ep_layer_{dt}_alone_ms"] = layer["alone_ms"]
        summary[f"ep_layer_{dt}_err"] = worst

    # the LM
    lm_arch, layers, seq, batch = sizes["lm"]
    lm = r0["lm"]
    what = f"ep lm {lm_arch} {layers} layers float32 {batch} x {seq}"
    losses = [r["lm"]["loss"] for r in per_rank]
    if len(set(losses)) != 1:
        raise AssertionError(f"{what}: the ranks' losses differ {losses}")
    checksums_agree = all(r["lm"]["checksums"] == lm["checksums"]
                          for r in per_rank)
    worst = _held(what, lm["errs"], "rel", STEP_F32_TOL)
    want_head = {"sandwich_fwd": ks.FWD_KERNELS * on_card,
                 "sandwich_bwd": ks.BWD_KERNELS * on_card}
    for r in per_rank:
        got = {k: r["lm"]["launches"][k] for k in want_head}
        if got != want_head or r["lm"]["launches"] != lm["alone_launches"]:
            raise AssertionError(f"{what}: rank {r['rank']} launches "
                                 f"{r['lm']['launches']}, without the mesh "
                                 f"{lm['alone_launches']}")
    say(f"{what} on {n} model ranks vs one rank: loss {lm['loss']:.6f} / "
        f"{lm['alone_loss']:.6f} (aux {lm['aux']:.6f}), worst relative "
        f"error {worst:.3e} over the loss and "
        f"{len(lm['errs']) - 2} butterfly leaves' gradients (the ranks' "
        f"checksums {'equal' if checksums_agree else 'differ'}); each "
        f"rank's "
        f"launches {lm['launches']} as without the mesh; ms a step "
        + ", ".join(f"rank {r['rank']} {r['lm']['ms']:.1f}"
                    for r in per_rank)
        + f", alone {lm['alone_ms']:.1f}; rank 0's "
        + _coll(lm["collectives"], "all_reduce"))
    add_launches(kernels, "ep lm rank 0",
                 {k: lm["launches"][k] for k in want_head})
    summary.update(ep_lm_ms=lm["ms"], ep_lm_alone_ms=lm["alone_ms"],
                   ep_lm_err=worst)

    # b. the pipeline
    p_arch, stages, batch, seq, micro = sizes["pipeline"]
    pipe = r0["pipeline"]
    what = (f"pipeline {p_arch} MLP blocks, {stages} stages, {batch} x "
            f"{seq}, {micro} microbatches")
    if any(r["pipeline"]["checksums"] != pipe["checksums"]
           for r in per_rank):
        raise AssertionError(f"{what}: the ranks differ")
    fwd = _held(what, {"y": pipe["errs"]["y"]}, "max", PIPE_TOL[0])
    grad = _held(what, {k: v for k, v in pipe["errs"].items() if k != "y"},
                 "max", PIPE_TOL[1])
    sites_a_stage = 3
    want_pipe = {"sandwich_fwd": micro * sites_a_stage * ks.FWD_KERNELS,
                 "sandwich_bwd": micro * sites_a_stage * ks.BWD_KERNELS}
    want_pipe = {k: v * on_card for k, v in want_pipe.items()}
    for r in per_rank:
        got = {k: r["pipeline"]["launches"][k] for k in want_pipe}
        if got != want_pipe:
            raise AssertionError(f"{what}: rank {r['rank']} launches {got}, "
                                 f"expected {want_pipe}")
    want_route = "gather" if on_card else "p2p"
    if pipe["route"] != want_route:
        raise AssertionError(f"{what}: handover {pipe['route']!r}, "
                             f"expected {want_route!r}")
    say(f"{what} on {n} stage ranks vs reference_apply on one rank: "
        f"forward max|Δ|/max|want| {fwd:.3e}, gradients {grad:.3e}; "
        f"handover {pipe['route']} ({r0['world'].split(' over ')[-1]} on "
        f"{dev.type} tensors): rank 0's "
        + _coll(pipe["collectives"], "shift") + ", "
        + _coll(pipe["collectives"], "all_reduce")
        + f"; each rank's launches {want_pipe}; ms a call (forward and "
        f"backward) "
        + ", ".join(f"rank {r['rank']} {r['pipeline']['ms']:.1f}"
                    for r in per_rank)
        + f", alone {pipe['alone_ms']:.1f}")
    add_launches(kernels, "pipeline rank 0",
                 {k: pipe["launches"][k] for k in want_pipe})
    summary.update(pipeline_ms=pipe["ms"], pipeline_alone_ms=pipe["alone_ms"],
                   pipeline_fwd_err=fwd, pipeline_grad_err=grad)

    phase_s = time.monotonic() - t_phase
    say(f"ep pipeline: phase {phase_s:.1f} s (budget {sizes['budget_s']} s)")
    if sizes["budget_s"] and phase_s > sizes["budget_s"]:
        raise AssertionError(f"ep pipeline: phase {phase_s:.1f} s over its "
                             f"budget {sizes['budget_s']} s")
    summary["ep_pipeline_s"] = phase_s
    return summary


# the kernels line's entries, in its order; the timing phases fill them in
KERNEL_ORDER = ("sandwich_fwd (sandwich_factors + sandwich_rows)",
                "paged_decode_attention", "sandwich_bwd", "butterfly_fwd",
                "butterfly_bwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
COUNTER_ENTRY = {"sandwich_fwd": KERNEL_ORDER[0],
                 **{n: n for n in KERNEL_ORDER[1:]}}
# run()'s phases by group, in order (the CPU rehearsal runs them a group
# at a time): the kernels' checks (phases 3-5, the wide and zoo sites, the
# butterfly and flash kernels), serving (6-8, 6a-6e), training (9-11, the
# CLI), the encoder-decoder and benches, the paper's layers (20-22), the
# zoo (24-35), the launch tooling (36), the mesh (37), sharded serving
# (38), expert parallelism and the pipeline (39)
GROUPS = ("kernels", "serve", "train", "encdec", "paper", "zoo", "launch",
          "mesh", "mesh_serve", "ep_pipe")


def entry(kernels: dict, counter: str) -> dict:
    """The kernels line's entry of ``counter`` (a launch counter's name): a
    stub without launches until its timing phase fills it in, which a
    group run alone leaves as it is."""
    name = COUNTER_ENTRY[counter]
    return kernels.setdefault(name, {"name": name, "launches": 0,
                                     "launches_by_path": {}})


def add_launches(kernels: dict, path: str, launches: dict) -> None:
    """``launches`` (counter -> launches of ``path``'s run) into the
    entries' totals and ``launches_by_path``."""
    for counter, n in launches.items():
        e = entry(kernels, counter)
        e["launches_by_path"][path] = n
        e["launches"] += n


def run(torch, np, cfg, dev, *, kernel: str, time_fn, device_fn=None,
        train_shape=(2048, 4), encdec_shape=MNIST,
        encdec_steps=TWO_PHASE_STEPS, bfly_shapes=BFLY_SHAPES,
        flash_shapes=FLASH_SHAPES, flash_timed=FLASH_TIMED,
        bench=None, wide=WIDE, cli=CLI_SERVE, layers=LAYER_API_LAYERS,
        fit=QUICKSTART_FIT, sketch_run=SKETCH_RUN, gated=GATED_SHAPES,
        nonlinear_steps=NONLINEAR_STEPS, lm_steps=LM_STEPS, zoo=ZOO,
        launch=LAUNCH, mesh=MESH, mesh_serve=MESH_SERVE, ep_pipe=EP_PIPE,
        groups=GROUPS) -> list:
    """Phases 3 to 39 on ``cfg`` and ``dev``; ``kernel`` is the backend
    held against the plain versions (``"cuda"`` on the card),
    ``train_shape`` the training run's (seq_len, global_batch),
    ``encdec_shape`` the encoder-decoder's (n, d, k), ``encdec_steps`` its
    two phases' steps, ``bfly_shapes`` the butterfly kernels' checks,
    ``flash_shapes`` the flash kernels' besides the training attention
    (``train_shape``, ``cfg``'s heads), ``flash_timed`` the names of those
    timed besides it (the first is the one the kernels line reports),
    ``bench`` the keyword arguments of ``launch.speed.run`` (none: the
    reference's sizes), ``wide`` the sandwich widths of
    :func:`phase_wide` and ``cli`` the serving tier's sizes of
    :func:`phase_serve_cli`; ``layers``, ``fit``, ``sketch_run``,
    ``gated``, ``nonlinear_steps`` and ``lm_steps`` size phases 20 to 22,
    ``zoo`` the zoo's phases (:data:`ZOO`), ``launch`` phase 36's
    (:data:`LAUNCH`), ``mesh`` phase 37's (:data:`MESH`),
    ``mesh_serve`` phase 38's (:data:`MESH_SERVE`) and ``ep_pipe`` phase
    39's (:data:`EP_PIPE`). ``groups``
    (of :data:`GROUPS`; all on the card) picks the phases run; a group run
    without the one before it takes no error from it and adds its launches
    to stub entries.
    Prints a ``summary:`` line of the end-to-end readings and returns the
    ``kernels`` list."""
    device_fn = device_fn or time_fn
    train_rows = train_shape[0] * train_shape[1]
    kernels: dict = {}
    summary: dict = {}
    errs: dict = {}
    flash_errs: dict = {}
    train_attn = ("train", train_shape[1], cfg.n_heads, train_shape[0],
                  cfg.head_dim_, (cfg.compute_dtype,), True, 0)
    flash_shapes = (train_attn, *flash_shapes)
    if "kernels" in groups:
        errs["sandwich_fwd"] = max(
            phase_sandwich_factors(torch, cfg, dev, kernel),
            phase_sandwich(torch, cfg, dev, kernel, train_rows))
        errs["paged_decode_attention"] = phase_paged(
            torch, cfg, dev, kernel, zoo["paged"], zoo["paged_long"])
        errs["sandwich_bwd"] = phase_sandwich_bwd(torch, cfg, dev, kernel,
                                                  train_rows)
        phase_wide(torch, dev, kernel, wide)
        for site in zoo["sites"]:
            for rows in zoo["rows"]:
                phase_wide(torch, dev, kernel, site, rows)
        errs.update(phase_butterfly(torch, dev, kernel, bfly_shapes))
        from repro_torch.launch import speed
        phase_sandwich_bwd_bench(
            torch, dev, kernel,
            max((bench or {}).get("ns") or speed.BACKWARD_NS))
        flash_errs = phase_flash(torch, dev, kernel, flash_shapes)
    for name in ("sandwich_fwd", "paged_decode_attention", "sandwich_bwd",
                 "butterfly_fwd", "butterfly_bwd"):
        errs.setdefault(name, 0.0)
    if "serve" in groups:
        launches, summary, eager_tokens = phase_serve(torch, np, cfg, dev,
                                                      kernel)
        dense_launches, summary["serve dense"], _ = phase_serve(
            torch, np, cfg, dev, kernel, tag=f"{cfg.name} dense",
            sizes=SERVE_DENSE)
        phase_serve_tokens(torch, np, dev)
        summary.update(phase_serve_incremental(torch, np, cfg, dev,
                                               eager_tokens))
        summary.update(phase_serve_spec(torch, np, cfg, dev, kernel,
                                        eager_tokens))
        router_launches, cli_summary = phase_serve_cli(torch, cfg, dev, cli)
        summary.update(cli_summary)
        for e in phase_timing(torch, cfg, dev, kernel, time_fn, device_fn,
                              launches, errs, train_rows):
            e["launches_by_path"] = {"serve": e["launches"]}
            kernels[e["name"]] = e
        add_launches(kernels, "router", router_launches)
        add_launches(kernels, "serve dense",
                     {"sandwich_fwd": dense_launches["sandwich_fwd"]})
        summary.update(phase_profile(torch, np, cfg, dev))
    if "train" in groups:
        train_launches, train_summary = phase_train(torch, np, cfg, dev,
                                                    *train_shape)
        summary.update(train_summary)
        phase_train_gradcheck(torch, np, cfg, dev, kernel)
        phase_train_step_f32(torch, cfg, dev, kernel)
        cli_launches, cli_summary = phase_train_cli(
            torch, np, cfg, dev, kernel, *train_shape, bfly_shapes[0])
        summary.update(cli_summary)
        e = phase_timing_bwd(torch, cfg, dev, kernel, time_fn,
                             train_launches["sandwich_bwd"],
                             errs["sandwich_bwd"], train_rows)
        e["launches"] = 0
        e["launches_by_path"] = {}
        kernels[e["name"]] = e
        add_launches(kernels, "train", train_launches)
        add_launches(kernels, "train_cli", cli_launches)
    if "encdec" in groups:
        encdec_launches, encdec_summary, problem = phase_encdec(
            torch, dev, encdec_shape, encdec_steps)
        summary.update(encdec_summary)
        phase_encdec_vs_plain(torch, dev, kernel, *problem)
        del problem
        for e in phase_timing_butterfly(torch, dev, kernel, time_fn,
                                        device_fn, encdec_launches, errs,
                                        encdec_shape, bfly_shapes):
            kernels[e["name"]] = e
        bench_launches = phase_bench(torch, dev, kernel, bench or {})
        phase_flash_autograd(torch, dev, kernel, flash_shapes[0])
        add_launches(kernels, "bench", {
            c: n for c, n in bench_launches.items()
            if n and c in ("sandwich_fwd", "sandwich_bwd", "butterfly_fwd",
                           "butterfly_bwd")})
        for e in phase_timing_flash(
                torch, dev, kernel, time_fn, device_fn, bench_launches,
                flash_errs or {flash_timed[0]: dict.fromkeys(
                    KERNEL_ORDER[5:], 0.0)},
                [train_attn] + [s for s in flash_shapes
                                if s[0] in flash_timed],
                flash_timed[0], cfg.n_kv_heads):
            kernels[e["name"]] = e
    if "paper" in groups:
        summary.update(phase_paper(torch, np, dev, kernel, kernels, layers,
                                   fit, sketch_run, gated, nonlinear_steps,
                                   lm_steps))
    if "zoo" in groups:
        summary.update(phase_zoo(torch, np, dev, kernel, kernels, time_fn,
                                 device_fn, zoo))
    if "launch" in groups:
        summary.update(phase_launch_tools(torch, np, dev, kernel, launch))
    if "mesh" in groups:
        summary.update(phase_mesh(torch, np, cfg, dev, kernel, kernels,
                                  mesh))
    if "mesh_serve" in groups:
        summary.update(phase_mesh_serve(torch, np, cfg, dev, kernel,
                                        kernels, mesh_serve))
    if "ep_pipe" in groups:
        summary.update(phase_ep_pipeline(torch, np, dev, kernel, kernels,
                                         ep_pipe))
    say("summary: " + json.dumps(summary))
    return [kernels[n] for n in KERNEL_ORDER if n in kernels]


def main() -> int:
    import os

    import torch
    routed = os.environ.get("REPRO_KERNEL_BACKEND", "").strip().lower()
    if routed not in ("", "auto", "cuda"):
        # the plain versions would stand in for every kernel of the run
        sys.stderr.write(f"chip_smoke: REPRO_KERNEL_BACKEND={routed!r} "
                         f"routes the kernels to the plain versions; unset "
                         f"it (or set auto or cuda)\n")
        return 2
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing was run\n")
        return 2
    if not (SRC / "repro_torch").is_dir():
        sys.stderr.write(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from a checkout of the repository\n")
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.configs import registry

    t_start = time.monotonic()
    smi = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    record_launches()
    kernels = run(torch, np, registry.get("smollm-135m-butterfly"), dev,
                  kernel="cuda", time_fn=cuda_ms, device_fn=device_ms)
    say(f"total: {time.monotonic() - t_start:.1f} s")
    say(f"device_ms: {len(EVENT_FALLBACKS)} timings by CUDA events where "
        f"the profiler saw no device time")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
