#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --kernels  # build, phases 2, 6, 8, 12(a), 19(a)
                                     # (no result line)
    python3 chip_smoke.py --kernels 19a 21   # build, then those phases
                                     # alone (21 runs phases 3-5 first)
    python3 chip_smoke.py --kernels 22   # build, phase 17(b), phase 22
    python3 chip_smoke.py --kernels 16   # build, phase 16 alone
    python3 chip_smoke.py --kernels 23   # build, phase 23 alone
    python3 chip_smoke.py --kernels 24   # build, phase 24 alone
    python3 chip_smoke.py --cards    # phases 21-22 over nccl, one rank a card

Phases (any failure raises, so the exit code is non-zero):

  1. the card's name and power limit; build every CUDA kernel of
     `src/repro_torch/kernels/csrc/` with nvcc (sm_90a);
  2. kernel parity: each kernel against its plain PyTorch version on the
     same CUDA tensors, at the serving shapes (m in {4, 8} rows against the
     5120 x 51200 and 25600 x 5120 MLP projections, and against
     deepseek-v2's layer-0 5120 x 24576 and 12288 x 5120 and the two MLP
     projections of each of phase 16's four models (gemma3-12b 3840 x
     30720 and 15360 x 3840, also at its 64-row prefill chunk;
     phi-3-vision 3072 x 16384 and 8192 x 3072; deepseek-67b 8192 x 44032
     and 22016 x 8192; mistral-large 12288 x 57344 and 28672 x 12288)
     under PAPER_NOISE with chip 7), the largest im2col
     sheets of the four paper CNNs at eval batch 512 (mobilenet_v3
     conv_stem 524288 x 27 x 16, alexnet conv1 524288 x 27 x 24 and conv2
     131072 x 216 x 48, vgg16 conv1_2 524288 x 144 x 16, resnet18 l1
     524288 x 216 x 24; PAPER_NOISE, IS and WS), a ragged shape and, for
     osa_matmul, 524,289 rows (past the
     grid's y limit), the robust gated evaluator's cells (a chip,
     PAPER_NOISE, gate 0 / 1 and mgate 0 / 1 on alexnet conv2 at 128
     images, 32768 x 216 x 48), held to the flip-aware one-LSB bound; two
     launches
     on the same inputs must give equal bits.  Timed rows: the median of
     10 per-call CUDA-event times, a kernel-only time (one event pair
     around 20 back-to-back launches replayed from a CUDA graph, over 20:
     no wrapper host time between them), the plain version, the bound
     (for rosa_fused also its bytes at the card's measured copy rate) and,
     for
     osa_matmul fused, the one PyTorch call computing the same function
     (`torch.matmul(q, w)` under ideal gains); rosa_fused also at phase
     17's 2048-row tall rows, at 22(e)'s rank shares (IDEAL and with
     PAPER_NOISE and chip 7), ANALOG at a rank's mlp/wo and a non-ideal
     OSA at gemma3's chunk, each tall row with its route (codes, tf32x2,
     tf32x3) and the route's bound beside the float32 one; every tall
     row of a TF32 route also within twice the plain version's distance
     from the float64 product, plus 2^-20 of its terms' root-sum-square
     (`split_tf32_parity`); the
     requantized codes through an identity weight at 8, 64 and 2048 rows
     must equal the plain version's;
  3. serve: qwen3-32b at full width, depth cut to 4 of 64 layers, random
     weights from seed 0, through the optical engine with the `rosa_fused`
     kernel and chip 7 pinned: 6 seeded Poisson requests, continuous
     batching over 4 slots.  The launch counts are reset just before the
     run and read just after; every routed MLP projection must have
     launched the kernel, and continuous batching must give the
     sequential oracle's greedy tokens;
  4. a 2-request stream through the `osa_matmul` kernel ("pallas" backend);
  5. end-to-end cross-check: one prompt's prefill logits through the fused
     kernel and through the plain composed ("ref") pipeline, held within
     4x the float-order floor the script measures (see serve_phase);
  6. ssd_scan parity and times: the kernel against its plain version at
     mamba2-1.3b's served shape (B 1, H 64, P 64, G 1, S 128, chunk 128)
     for L in {1, 127, 128, 129, 512, 1000} (ragged tails), one case with
     G 2 and B 2, one with G = H, and zamba2-1.2b's shape (S 64) at L 128
     and 700, held to 1e-4 of max|y| on y and of max|state| on the final
     state; two launches must give equal bits; per-call and kernel-only
     times as in phase 2, the bound and its share, the launches' resident
     blocks per SM;
  7. serve: mamba2-1.3b at full width and depth (48 layers, 1.34e9 params,
     random weights from seed 0) with the optical engine on (the block
     routes nothing), 8 seeded Poisson requests (prompts 200-700 tokens,
     generations 8-32), 4 slots, max_len 768, greedy; every prompt
     prefills whole through the `ssd_scan` kernel, 48 launches each.  The
     continuous stream's tokens must equal the sequential oracle's, and
     one prefill's logits on the kernel path must agree with the same
     prefill through the plain scan within 4x a measured float-order
     floor, with the same greedy token;
  8. mrr_transfer parity and times: the kernel against its plain version
     on the same CUDA tensors, bit for bit, at the mobilenet_v3 depthwise
     weight (60, 25) with noise and a chip (per row), the conv_stem IS
     activation sheet at eval batch 512 (524288, 27) without and with a
     chip (per column), qwen3-32b's mlp/wi (5120, 51200) with noise and
     with a chip only, and a ragged 1-D n = 1,000,003; per-call and
     kernel-only times as in phase 2, the bound and its share;
  9. the paper's Table 4 pipeline over the four paper CNNs (alexnet,
     vgg16, resnet18, mobilenet_v3) at the reference's widths through
     `launch.table4.run`, one model per main-path run: 200 QAT steps at
     batch 64 on 4096 synth-CIFAR images, the per-layer noise profile
     (n_mc 3), the hybrid plan, the five accuracies on the 512-image test
     split, and the EDP of WS, hybrid and DEAP-CNNs; then the paper's three
     averages.  The launch counts are reset just before each model and
     read just after: rosa_fused must have run every noisy conv/fc
     evaluation and mrr_transfer every noisy depthwise conditioning,
     counted from the specs and the plan; the WS and DEAP EDPs must equal
     the reference's floats (TABLE4_EDP);
 10. card vs the reference: the golden file of tests/test_torch_cnn.py
     (JAX-trained mobilenet_v3, a JAX chip, JAX's logits).  Clean accuracy
     within 2 images and chip-pinned WS / IS (per-shot noise ideal)
     within 5 images of 512 of the reference's; the kernel path's logits
     within 4x the float-order floor of the plain path on the card (the
     plain path with permuted channels, as in phase 5);
 11. the paper's energy model in float64 on the card: Figs. 7-9, Table 1,
     the model-zoo DSE sweep (16 workloads, 5176 layer rows, 33
     candidates), the EDP-only hybrid plan on five zoo architectures and
     Table 4's EDP-only averages, each within 1e-9 relative of the
     reference's value (ENERGY_REF; labels and counts equal); the zoo
     sweep's wall, the median of 10 after 2 warm-ups;
 12. robust: (a) the mrr_transfer backward kernel against its plain
     derivative on the same CUDA tensors, bit for bit, at mobilenet_v3's
     four depthwise weights with a chip (per row), with and without
     draws, a chip per column, a full-shape chip field, no chip, and the
     (5120, 51200) sheet with a chip, with and without draws; times and
     bound as in phase 8 (bytes: w, g and dq, and the draws), and each
     case's SASS instruction floor and registers a thread;
     (b) variation-aware QAT: `train_cnn` of mobilenet_v3, 200 steps at
     batch 64 over an 8-chip antithetic wafer, every parameter finite and
     the launches exactly 200 x 11 rosa_fused and 200 x 4 mrr_transfer
     forward and backward (the clean evaluation after training launches
     nothing); then `evaluate_cnn_ensemble` of it and of phase 9's plainly
     trained mobilenet_v3 on a fresh 16-chip wafer at PAPER_NOISE, with
     launches counted from the specs; (c) the robust CLI runners on alexnet
     with phase 9's parameters at the reference's defaults (ensemble: 64
     chips, 4 probes, 512 images; sensitivity: 16 chips, 256 images;
     drift: 16 chips, 256 images, sine, re-trim every 900 s; sweep: 32
     chips, 5 scales), each a main-path run with launches counted from the
     run's shape, and the sensitivity plan and EDP ratio recomputed from
     its own degradation matrix in float64;
 13. compile once and drift-adaptive serving: (a) qwen3-32b's serving
     Program (full width, 4 of 64 layers, backend fused) compiled twice
     against one `rosa.PlanCache`: the first searches, the second loads
     the plan (cache_hit), both plans IS/IS as phase 3's, and `python -m
     repro_torch.rosa stats` counts one plan; (b) the reference bench's
     full-size drift_serve scenario (sine 0.6 K over 96 ticks, 16 Poisson
     requests at 0.5 a tick, 4 slots, max_len 56, chunk 8, probes of 16 x
     4 tokens every 2 ticks, warm-up 6, chip 0, a forced replan at tick 30)
     on qwen3-32b at full width, uncontrolled then controlled, each arm a
     main-path run: no request dropped, the requests done before the
     first actuator write bit-exact between the arms, and every decode
     step up to it too, no swap downtime, at least one replan, and
     rosa_fused launched exactly once per routed projection of every
     decode step, prefill chunk, warm-up step and chip-pinned probe
     forward; recovery and the agreements are recorded; (c) `run_smoke`
     twice on phase 9's alexnet with one cache: the second run finds the
     degradation matrix, and its launches show the Monte-Carlo stage did
     not run;
 14. serve the moe and mla_moe families at full width, one after the
     other (the first freed before the second): qwen3-moe-235b-a22b at 3
     of 94 layers (8.7e9 params) and deepseek-v2-236b at 3 of 60 (layer 0
     and 2 MoE layers, 9.3e9 params), random weights from seed 0, optical
     engine on (backend fused, chip 7), 6 seeded Poisson requests as in
     phase 3, 4 slots.  qwen3-moe's plan must be empty and launch nothing;
     deepseek-v2 routes layer 0's two MLP projections, and rosa_fused must
     launch exactly 2 x (decode steps + prefill chunks) times, nothing
     else.  Continuous batching must give the sequential oracle's greedy
     tokens, deepseek-v2's fused prefill logits must stay within 4x the
     float-order floor of the "ref" pipeline (phase 5's rule, the floor
     taken by permuting only the reduction axis of layer 0's two optical
     projections, with every run routing each token to the same
     experts), and the peak memory of each model must stay under 70 GiB.  tokens/s, ticks,
     peak GiB and set-up seconds are printed;
 15. the hybrid and encdec families at full width and depth: (a)
     zamba2-1.2b (38 Mamba-2 layers in 6 groups of 6 and a tail of 2,
     one shared attention + MLP block after each group; 1.10e9 params,
     random weights from seed 0) served as phase 7 serves mamba2 (8
     seeded Poisson requests, prompts 200-700, generations 8-32, 4 slots,
     max_len 768, optical engine on): the plan must be empty and nothing
     but ssd_scan launch, exactly 38 times per whole prefill; continuous
     batching must give the sequential oracle's greedy tokens; in one
     700-token prompt's prefill each of the 38 scans, kernel and plain
     scan on the operands the model gives it, must agree within 1e-4 of
     the max magnitude on y and on the final state, and the whole
     prefill through the kernel and through the plain scan within 4x
     the float-order floor (phase 7's rule; the hidden and state
     dimensions permuted) on the logits and on every ssm state leaf,
     with the same argmax;
     (b) seamless-m4t-medium (12 + 12 layers, vocab 256206, 9.78e8
     params) through the `--policy batch` entry function
     (`launch.serve.run_batch`: batch 4, prompt and source 32 tokens, 16
     generated), once greedy and once at temperature 0.7, launching no
     kernel: the card's prefill logits against the port's own CPU prefill
     of the same parameters and inputs within 4x the card's float-order
     floor (phase 5's rule; the hidden dimension of the params and the
     source permuted), with the same argmax; after `pad_cache` the cross
     K/V keep the source's 32 positions and the self K/V grow to 32 + 17;
     zero source embeddings must change the prefill logits.  tokens/s,
     ticks, peak GiB and set-up seconds are printed;
 16. the four dense configs at full width, random weights from seed 0,
     each freed before the next, served as phase 3 serves qwen3-32b
     (optical engine on, backend fused, chip 7, 6 seeded Poisson requests,
     4 slots): the plan routes every layer's two MLP projections, and
     rosa_fused must launch exactly 2 x layers x (decode steps + prefill
     chunks) times and nothing else launch; continuous batching must give
     the sequential oracle's greedy tokens; the peak stays under 70 GiB.
     (a) gemma3-12b at 6 of 48 layers (5 local, 1 global; cut from
     full depth to make room for phase 22; 2.4e9 params), max_len
     1200, 64-token prefill chunks, plus one 1100-token prompt past the
     1024-token window of its 40 local layers: lifting the window must
     move that prompt's prefill logits (a whole prefill each way, the
     MLPs plain); fused vs "ref" prefill logits within 4x the float-order
     floor (phase 14's rule: only the optical products' reduction axis
     permuted), the argmax equal unless the ref's top two logits lie
     within that bound of each other, and then the fused pick within it
     of the ref's top; (b)
     deepseek-67b and mistral-large-123b cut to 4 layers (4.4e9 / 6.3e9
     params), phase 3's traffic, the same checks as (a); (c)
     phi-3-vision-4.2b at 16 of 32 layers (cut for phase 22; 2.0e9
     params):
     first
     through `--policy batch` (batch 4, 32 prompt tokens, 16 zero patch
     embeddings, 16 generated; greedy and at 0.7) launching no kernel,
     the self K/V 16 + 32 + 17 long after `pad_cache`, non-zero patches
     moving the prefill logits, and the card's prefill at the first 8
     layers (random patches) against the port's CPU prefill within 4x
     the card's float-order floor (phase 15(b)'s rule), the argmax equal;
     then served text-only through the Scheduler as (b).  tokens/s,
     ticks, peak GiB and set-up seconds are printed;
 17. the LM training path, qwen3-32b at full width, random weights from
     seed 0 (2 of 64 layers, cut from 4 for phase 22; 22(a) reads
     17(b)): (a) `python -m repro_torch.launch.train --n-layers 2 --steps
     10 --batch 8 --seq 256 --warmup 2` in-process (plain MLPs, as the
     reference's CLI configures it; no checkpoint written), each step's
     loss, |g| and wall, tokens/s after one warm-up step, peak GiB: every
     loss and |g| finite, peak under 70 GiB, no kernel launched; (b)
     `make_train_step` on the same model with `rosa_mlp` and the "fused"
     backend (IDEAL noise, WS, no chip) for 2 steps on the CLI's batches:
     rosa_fused exactly 2 projections x (forward + remat recompute) x 2
     layers x 2 steps = 16 times and nothing else; the same steps with
     the "ref" backend launch nothing, and the fused losses and the first
     step's gradients agree with them within 4x a float-order floor
     (phase 14's rule: each optical product's reduction axis permuted,
     two seeds; per step for the loss, per leaf for the gradients); (c)
     one train step at full width and 1 layer (batch 1 x 64) on the card
     and on the CPU from the same params: loss, |g| and every gradient
     leaf within 4x the card's float-order floor (the hidden and MLP axes
     of the params permuted, two seeds), then one AdamW update of the
     card's gradients on each side within 1e-6 of every leaf's max (the
     host's available memory checked first); (d) qwen3-32b-smoke, 4
     steps straight against 2 steps, a checkpoint saved and restored on
     the card, and 2 more: params and optimizer state bit for bit.  Phase
     2 times rosa_fused at the train step's tall rows (2048 x 5120 x
     51200 and 2048 x 25600 x 5120, WS, IDEAL noise, 3 calls each);
 18. observability and the static checks, qwen3-32b as phase 3 serves
     it: the same requests once untraced and once under a `Tracer`, a
     fresh metrics registry and `obs.install_kernel_hooks()`, each a
     main-path run: identical tokens and rosa_fused launches (every routed
     projection), one `serve.tick` span per tick, one prefill / decode
     span per chunk / step, one request begin, first_token and end per
     request, `serve.requests_completed` equal to the requests, and the
     `energy.decode` track's final J equal to the decode steps times the
     ledger's priced decode step (1e-12 relative); `python -m
     repro_torch.obs summarize` on the saved trace; `python -m
     repro_torch.launch.serve ... --trace` at the same width (its trace
     holds the ticks, the request events and energy.decode); the
     analysis CLI (`python -m repro_torch.analysis`'s `main`, in this
     process) against the package baseline on the card; and
     `rosa.compile(verify="error")` of phase 13's serving program, which
     must return the Program.  The traced and untraced tok/s and the
     trace's size are printed, not gated.
 19. training the ssm and hybrid families at full width and depth,
     random weights from seed 0: (a) the ssd_scan backward kernel
     against the float64 plain backward on the same CUDA tensors at
     mamba2-1.3b's and zamba2-1.2b's train shapes (B 8, L 256, H 64, P
     64, G 1, S 128 / 64, chunk 128), at L 1, L 129, a ragged L 700 at G
     2 and B 2, and G = H, each with N(0, 1) cotangents and a non-zero
     dstate: each gradient within 4x the float32 plain backward's
     distance from float64 (plus 1e-6 of its max) and within 1e-4 of its
     max, finite, two launches equal bit for bit, a None dstate giving a
     zero one's bits; L 1 again on 16 seeds of its own under the same
     gates, its float32 floor the largest over 4 orders of the heads
     (db and dc sum one-row products over a group's heads, and one
     order can land far closer to float64 than another), each seed's
     ratio to that floor printed; times as
     phase 6 against the bound of the route
     the kernel takes (its matrix products in 3xTF32 at the dense TF32
     rate, the rest at the float32 rate; the summary's `bound_ms`) and,
     beside it, the bound of the chunked formulas' operations all at the
     float32 rate (`f32_bound_ms`); and each of its four
     launches' kernel-only time alone (`ops.backward_stages`, after a
     whole backward filled the workspace), printed on a line of its own;
     (b) `python -m
     repro_torch.launch.train --arch mamba2-1.3b --steps 4 --batch 8
     --seq 256` in-process (48 layers, 1.34e9 params): losses and |g|
     finite, peak under 70 GiB, ssd_scan exactly 2 x 48 x 4 launches
     (forward and remat recompute) and its backward 48 x 4, nothing else;
     (c) zamba2-1.2b the same way (38 layers: the 36 in recomputed
     groups twice a step, the 2 tail layers once, the backward 38 a
     step); (d) one train step of mamba2-1.3b at full width and 1 layer
     (batch 1 x 64, a single ragged chunk) on the card and on the CPU
     from the same params: loss, |g| and every gradient leaf within 4x
     the card's float-order floor (phase 17(c)'s rule with the hidden,
     head and state axes permuted, or, where larger, the distance of the
     card's float32 step through the plain scan from its float64 step).
     s a step, tokens/s and peak GiB are printed, not gated.
 20. the dry run (`repro_torch.launch.dryrun`, on the CPU beside the
     card): (a) `run_cell` of one arch per family on both production
     meshes — qwen3-32b and deepseek-v2-236b train_4k, mamba2-1.3b
     decode_32k (not prefill_32k: its trace took 92 s), zamba2-1.2b
     long_500k,
     seamless-m4t-medium and
     phi-3-vision-4.2b decode_32k — each over a "fake" process group of
     256 / 512 ranks, its arguments meta DTensors and its step traced on
     meta tensors: every record "ok" with FLOPs; (b) rank 0's local
     shards of deepseek-v2-236b train_4k on the single-pod mesh (10.74
     GiB) allocated on the card: the caching allocator's requested bytes
     grow by exactly the record's `argument_bytes`, and
     `torch.cuda.memory_allocated()` by that with each tensor rounded up
     to 512 B plus what the allocator leaves unsplit of a large block (at
     most 1 MiB a tensor above 1 MiB).  One process a cell (a spawned
     pool; the scan's plain version traces its chunks one by one, so
     mamba2's prefill takes the longest).  The phase's wall is printed.

 21. serving across ranks (`repro_torch.distributed.runtime.spawn`, the
     kernels built here first; by default the ranks share card 0 over
     gloo, with `--cards` one rank a card over nccl): (a) phase 3's
     qwen3-32b stream
     with its 4 slots over 2 ranks (`Scheduler(mesh=make_test_mesh(2, 1,
     "cuda"))`): every completion's tokens equal phase 3's one-process
     Scheduler's and `run_sequential`'s, each rank's `rosa_fused`
     launches exactly 2 x layers x (its decode steps + prefill chunks),
     peak < 70 GiB a card over the ranks and the parent; tok/s and the
     card's busy share (a profiled second run) printed; (b) qwen3-32b at
     full width and 2 layers, 4 slots, a 32768-position bfloat16 cache
     from a seed, its sequence over 4 ranks (SERVE_RULES with no axis for
     the KV heads: the port splits no heads), 8 teacher-forced decode
     steps from ragged positions on both sides of slice boundaries:
     `flash_decode` in every layer and step (counted), each rank 1/4 of
     the cache's bytes, rank 0's logits within 4x the float-order floor
     (the params' hidden and MLP dimensions permuted, 2 seeds) plus 1e-5
     of the whole-cache steps' in the parent, argmax equal wherever the
     top-two gap exceeds that bound, and `flash_decode` alone with a
     4096-token window within 4x its floor (the keys permuted) plus 1e-6
     of the whole cache's attention; (c) one MoE block of qwen3-moe-235b-
     a22b and of deepseek-v2-236b (two shared experts: `_shared_tp`) at
     full width, experts over 4 ranks (each draws only its own from
     per-expert seeds), through `_ffn_apply` under a live context, a
     decode batch (4 x 1) and a 64-token chunk: a2a False at capacity
     1.25 equal to `moe_ep_local` as one rank in the parent, both
     dispatch modes at a capacity that drops nothing equal to `moe_ref`,
     each within 4x a floor (the experts' d_ff permuted) plus 1e-6; each
     rank holds 1/4 of the expert bytes; dropped assignments printed.
     Walls and peaks printed per sub-phase.
 22. training across ranks (`launch.steps.train_layout` /
     `make_train_step(layout=)`, `launch.train --devices`; the ranks
     share card 0 in a gloo group, their CUDA collectives' data through
     card buffers mapped across them with CUDA IPC, or with `--cards` one
     a card over nccl): (a)
     qwen3-32b at full width and 2 layers, batch 8 x 256, 2 ranks on
     (data 2, model 1), the plain step and the optical one (`rosa_mlp`,
     "fused", as 17(b)), 2 steps each from seed 0, against the
     one-process steps (17(b)'s fused run, a plain run here): every
     rank's losses and |g| and its shards of every leaf after the steps
     within 4x the float-order floor (the params' hidden and MLP axes and
     the batch rows permuted, two seeds; for the optical run at least
     17(b)'s k-permuted floor) plus 1e-6, `rosa_fused` exactly 2 x 2 x
     layers x steps a rank, a rank's param and moment bytes its
     TRAIN_RULES shards' exactly, peak < 70 GiB over the card; the plain
     run's params after the steps saved from the ranks (`checkpoint.save
     (specs=)`: each leaf gathered whole, rank 0 writing; the 3.1 GB embed
     and unembed among them) and restored onto them: the file holds the
     one-process layout (every key, whole shapes) and the restored shards
     equal the held ones bit for bit (so the file holds the one-process
     params within the gate above); (e) in the same group, the plain
     run and an optical one with chip 7 pinned and the paper's per-shot
     noise (WS) on (data 1, model 2): heads, MLP (`rosa_fused` at a
     rank's wi columns, K 5120 x N 25600, and wo rows, K 12800 x N 5120)
     and vocab split over the model ranks, the draws made at the whole
     operands' shapes; against the plain one-process side and a
     one-process run with the same noisy engine (its rosa_fused launches
     counted, each with a draw pair at the whole weight's shape, every
     rank's draws those shapes too),
     with the floors of (a), the same launch counts, a rank's first-step
     matmul FLOPs (`FlopCounterMode`) within 2 % of half of the
     one-process step's, a rank's peak below 22(a)'s; (b)
     mamba2-1.3b at full width and depth, 4 ranks on (2, 2), 2 steps with
     phase 19(b)'s schedule, the same gates (the floor: hidden and head
     axes and rows permuted), `ssd_scan` 2 x 48 x 2 at 32 of 64 heads and
     its backward 48 x 2 a rank, a rank's FLOPs within 3 % of a quarter
     of the one-process step's; in (a), (b) and (e) the bytes a rank's
     gathers hand back equal its non-"model" shards' from the specs
     exactly; (c) the elastic restart through the CLI, mistral-
     large-123b-smoke at batch 4 x 32: one process to step 4, then
     `--devices 4 --data-axis 2 --resume` to 6 in a subprocess: 'resumed
     from step 4' printed once, its losses within 6e-5 (plus the CLI's
     4-decimal rounding) of a one-process continuation; (d)
     qwen3-moe-235b-a22b-smoke with `moe_ep_local` in the train step on 4
     ranks (2, 2), the same group on the card and on the CPU from the
     same params: losses, |g| and every leaf within 4x the card-vs-CPU
     floor of the one-process steps plus 1e-6, dropped assignments
     printed.  s a step, the card's kernel and copy shares of the last
     step, walls and peaks printed per sub-phase.
 23. serving under SERVE_RULES across 4 ranks on card 0
     (`launch.steps.serve_layout` / `make_serve_step`: each rank its 2-D
     weight shards, the embed dims gathered over "data" layer by layer,
     heads, KV heads, MLP and vocab computed over "model", its rows and
     part of the cache), all cells in one group: (a) qwen3-32b at 2
     layers, optical MLPs ("fused", chip 7, each row at its own
     full-scale), on (2, 2): decode_32k at 32 x 32768 (3 steps) and
     prefill_32k at 2 x 4096; (b) gemma3-12b long_500k at 6 layers on
     (4, 1), the 524288 positions over the four ranks (`flash_decode`);
     (c) mamba2-1.3b at full width and depth on (2, 2): decode_32k at 128
     rows, prefill_32k at 4 x 4096 (`ssd_scan` at 32 of 64 heads).  The
     params and caches are drawn from seeds block by block on the cell's
     mesh (`sr_params`, `sr_cache`: a rank draws only its blocks, one
     process all of them).  Each cell against the same run in one
     process after the ranks exit (a decode step on a data rank's rows
     at a time): every step's logits and the cache parts within 4x the
     float-order floor (the params' hidden, MLP and query-head, or
     hidden and head, axes permuted, 2 seeds) plus 1e-6, the argmax
     equal past that bound,
     `rosa_fused` exactly 2 x layers x steps a rank at (K, N) (5120,
     25600) and (12800, 5120), `ssd_scan` 48 a prefill, a rank's bytes
     `dryrun.cell_bytes` of the cell on its mesh and cut shape exactly,
     the ranks' peaks < 70 GiB over the card; ms a step, tok/s, peaks
     and walls printed.
 24. the MoE families served under SERVE_RULES across 4 ranks on card
     0, phase 23's machinery and gates, all cells in one group, on (2,
     2): (a) qwen3-moe-235b-a22b at 2 layers, its experts over "model"
     through `moe_ep_local` (their d_model gathered over "data" inside)
     beside split heads; (b) deepseek-v2-236b at 2 layers (`layer0`,
     optical: "fused", chip 7; one MoE layer), its MLA heads over
     "model" and its latent cache's sequence over "model" (MLA's decode
     with the query heads gathered, `layers.seq_combine`); (b') (b) with
     a plain `layer0`, whose floor binds the MoE layer's MLA and experts
     at full width ((b)'s flipped optical codes move a row's logits by
     up to a third of their max).  A plain MoE cell's rows jump one at
     a time under any reordering, so its logits gate holds each step's
     median row within 4x the floor runs' median plus 1e-6 and its
     worst row within 4x their worst of any step.  decode_32k at 32 x
     32768 (3 steps), prefill_32k at 2 x 1024 (a) and 2 x 384 (b, b'):
     the longest whose card sum of rank peaks stays under 70 GiB
     (`tools/serve_moe_peaks.py`).  The capacity factor E / k drops
     nothing, so one process's `moe_ref` computes the same function (no
     drop gated), and one more decode step at the arch's 1.25 prints
     each rank's drops.  The floor permutes the hidden axis, the experts
     (the router's columns with them), the query heads and the MLP axes;
     `rosa_fused` exactly 2 x 3 a rank a decode at M 16 and 2 a prefill,
     at (K, N) (5120, 12288) and (6144, 5120).

Every compile of the run goes through a fresh plan cache (a temporary
`ROSA_PLAN_CACHE` under build/, removed at the end), so each starts
cold.  It prints one JSON line summarizing the kernels, then the card's
name and power limit, then `{"ok": true, "device": {...}}` as the last
line.  Per-case numbers go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12           # H100 SXM dense TF32 on the tensor cores
INT8_OPS = 1979e12            # H100 SXM dense int8 on the tensor cores
M_ROWS = (4, 8)               # decode batch (4 slots) and a prefill chunk
PROJ = {"mlp/wi": (5120, 51200), "mlp/wo": (25600, 5120)}
# a rank's share of them over 2 model ranks (phase 22(e): wi's columns,
# wo's rows)
PROJ_SPLIT = {"mlp/wi": (5120, 25600), "mlp/wo": (12800, 5120)}
# deepseek-v2's dense layer 0 (d_ff 12288): its MLP projections are the
# optical ones of phase 14
LAYER0_PROJ = {"mlp/wi": (5120, 24576), "mlp/wo": (12288, 5120)}
# the MLP projections (K, N) of the four dense configs of phase 16
DENSE_PROJ = {
    "gemma3-12b": {"mlp/wi": (3840, 30720), "mlp/wo": (15360, 3840)},
    "phi-3-vision-4.2b": {"mlp/wi": (3072, 16384), "mlp/wo": (8192, 3072)},
    "deepseek-67b": {"mlp/wi": (8192, 44032), "mlp/wo": (22016, 8192)},
    "mistral-large-123b": {"mlp/wi": (12288, 57344),
                           "mlp/wo": (28672, 12288)},
}
GEMMA_CHUNK = 64           # phase 16(a)'s prefill chunk: the tall path
TRAIN_ROWS = 2048          # phase 17's train batch: 8 x 256 tokens
RAGGED = (13, 1000, 300)
# ssd_scan cases (B, L, H, P, G, S, chunk): mamba2-1.3b's served shape at
# one step, a chunk's edges, the served L, a ragged 1000; G 2 at B 2; G = H;
# zamba2-1.2b's (S 64) at one chunk and at its longest prompt
SSD_CASES = [(1, 1, 64, 64, 1, 128, 128), (1, 127, 64, 64, 1, 128, 128),
             (1, 128, 64, 64, 1, 128, 128), (1, 129, 64, 64, 1, 128, 128),
             (1, 512, 64, 64, 1, 128, 128), (1, 1000, 64, 64, 1, 128, 128),
             (2, 700, 64, 64, 2, 128, 128), (1, 512, 64, 64, 64, 128, 128),
             (1, 128, 64, 64, 1, 64, 128), (1, 700, 64, 64, 1, 64, 128),
             (4, 256, 32, 64, 1, 128, 128)]   # a (2, 2) rank's (22(b))
SSD_SERVED_L = 512
MAMBA_PARAMS = 1_343_532_032  # mamba2-1.3b at full width and depth


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-call times from CUDA events (device time of the work
    `fn` enqueues, host gaps included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_only_ms(fn, n: int = 20) -> float:
    """Device time of `n` back-to-back calls of `fn` under one CUDA-event
    pair, over n.  The calls are captured once into a CUDA graph and the
    graph is replayed, so no host work (the wrapper's checks, allocations
    and ctypes call) sits between the kernels; the difference to
    `median_ms` is that host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    torch.cuda.empty_cache()
    return a.elapsed_time(b) / n


def distinct_bytes(*tensors) -> int:
    """Bytes of the distinct elements of float32 operands (a stride-0
    broadcast view counts its stored extent once); None entries and
    tuples of tensors are taken as they come."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, (tuple, list)):
            total += distinct_bytes(*t)
            continue
        total += 4 * math.prod(n for n, st in zip(t.shape, t.stride())
                               if st != 0)
    return total


def quantized_parity(y, y_ref, what: str, qmax: int = 127,
                     tight: float = 2e-4) -> float:
    """Flip-aware bound: deviations relative to the reference's full scale
    stay within one requantization LSB (2/qmax), and rows beyond float
    tightness (code flips at rounding boundaries) stay rare.  Returns the
    max absolute error."""
    import torch
    y = y.double().reshape(-1, y.shape[-1])
    r = y_ref.double().reshape(y.shape)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    scale = max(float(r.abs().max()), 1.0)
    d = (y - r).abs() / scale
    if float(d.max()) > 2.0 / qmax:
        raise AssertionError(f"{what}: deviation {float(d.max()):.3e} "
                             "exceeds the one-LSB flip bound")
    bad = int((d.amax(dim=1) > tight).sum())
    if bad > max(2, -(-y.shape[0] // 4)):
        raise AssertionError(f"{what}: {bad} of {y.shape[0]} rows beyond "
                             "the tight tolerance")
    return float((y - r).abs().max())


def split_tf32_parity(y, y_plain, args, static, what: str) -> dict:
    """Float32 accuracy of rosa_fused's TF32 routes.  The reference is the
    product of the conditioned operands (`ops.conditioned`) in float64,
    flushed by the plain version's float32 scale.  The kernel's largest
    distance from it must stay within twice the float32 plain version's
    plus 2^-20 of the terms' root-sum-square (sqrt(sum_k (a w)^2) times
    the scale): room for the split's residue (2^-22 a term) and the
    tensor cores' truncation inside an mma, which at short K (a CNN
    sheet's 27 lanes) outweigh the plain version's few roundings.  A
    one-pass TF32 product errs ~2^-12 a term, and summing all of K inside
    the mma errs as K grows: each fails it.  Returns the three numbers."""
    import torch
    from repro_torch.kernels.rosa_fused import ops
    a, w_eff = (t.double() for t in ops.conditioned(*args, **static))
    s2, sw = args[3][:, 2:3], args[4][2]
    qf = torch.tensor(float(static["qmax"]), device=s2.device)
    scale = (s2 * sw if static["analog"] else s2 * (sw / qf)).double()
    ref = (a @ w_eff) * scale
    rss = float(((a * a) @ (w_eff * w_eff)).sqrt().mul_(scale.abs()).max())
    del a, w_eff
    e = float((y.double() - ref).abs().max())
    e_plain = float((y_plain.double() - ref).abs().max())
    limit = 2 * e_plain + 2.0**-20 * rss
    if not e <= limit:
        raise AssertionError(
            f"{what}: {e:.3e} from the float64 product, past 2 x the plain "
            f"version's {e_plain:.3e} + 2^-20 x {rss:.3e} = {limit:.3e}")
    return {"f64_err": e, "plain_f64_err": e_plain, "f64_limit": limit}


def _launch_counters():
    from repro_torch.kernels.mrr_transfer import ops as mrr_ops
    from repro_torch.kernels.osa_matmul import ops as osa_ops
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"rosa_fused": fused_ops.LAUNCHES, "osa_matmul": osa_ops.LAUNCHES,
            "ssd_scan": ssd_ops.LAUNCHES, "mrr_transfer": mrr_ops.LAUNCHES,
            "mrr_transfer_bwd": mrr_ops.LAUNCHES_BWD,
            "ssd_scan_bwd": ssd_ops.LAUNCHES_BWD}


def reset_launches() -> None:
    """Every kernel's launch count to 0 (just before a main path runs)."""
    for c in _launch_counters().values():
        c.reset()


def launch_counts() -> dict:
    return {name: c.count for name, c in _launch_counters().items()}


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    tb, tf = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernel parity and times
# ---------------------------------------------------------------------------
# the paper CNNs' largest im2col sheets at eval batch 512 on 32x32 inputs
# (rows, lanes, outs), from the traced lite nets (models/cnn.py)
CONV_STEM = (524288, 27, 16)           # mobilenet_v3
CNN_SHEETS = {"conv_stem": CONV_STEM,
              "alexnet conv1": (524288, 27, 24),
              "alexnet conv2": (131072, 216, 48),
              "vgg16 conv1_2": (524288, 144, 16),
              "resnet18 l1": (524288, 216, 24)}
GATED_SHEET = (32768, 216, 48)         # alexnet conv2, 128 images
PROBE_ROWS = 64                        # drift probes: 16 prompts x 4 tokens
CODE_ROWS = (8, 64, 2048)              # the identity-weight code check
PROBE_SHIFT_K = 0.3                    # a thermal residual on the chip


def fused_cases():
    """(m, k, n, what, keywords, timed)."""
    from repro_torch.core.constants import ComputeMode, Mapping
    from repro_torch.core.osa import OSAConfig
    is_apv = dict(mapping=Mapping.IS, act_per_vector=True)
    cases = [(m, k, n, f"IS realize_x {name}", is_apv, True)
             for name, (k, n) in PROJ.items() for m in M_ROWS]
    k, n = PROJ["mlp/wo"]
    cases += [(4, k, n, "WS realize_w mlp/wo", dict(mapping=Mapping.WS),
               True),
              (8, *PROJ["mlp/wi"], "mgate 0.5 mlp/wi",
               dict(mapping=Mapping.WS, mgate=0.5, act_per_vector=True),
               False),
              (4, *PROJ["mlp/wi"], "ANALOG mlp/wi",
               dict(mode=ComputeMode.ANALOG), False)]
    # the Table 4 evaluations' largest sheets: PAPER_NOISE, no chip
    cases += [(*sheet, f"{mp} {name} noisy",
               dict(mapping=Mapping[mp], noisy=True, chip=False), True)
              for name, sheet in CNN_SHEETS.items() for mp in ("IS", "WS")]
    # the gated evaluator's cells (robust.sensitivity): a chip,
    # PAPER_NOISE, one-hot analog gates (0 or 1) and constant mapping gates
    # (0 = WS, 1 = IS), at one micro-batch of 128 images
    cases += [(*GATED_SHEET, f"gate {g:g} mgate {mg:g} alexnet conv2 b128",
               dict(mapping=Mapping.WS, noisy=True, gate=g, mgate=mg), False)
              for g in (0.0, 1.0) for mg in (0.0, 1.0)]
    # the drift probes' and replan cells' forwards (phase 13(b)): the gated
    # evaluator at qwen3-32b width, IDEAL per-shot noise, per-layer analog
    # and mapping gates of 0 or 1, the pinned chip shifted by a residual
    cases += [(PROBE_ROWS, k, n, f"{mp} gate {g:g} mgate {mg:g} probe "
               f"{name}", dict(mapping=Mapping[mp], act_per_vector=True,
                               gate=g, mgate=mg, shift_k=PROBE_SHIFT_K),
               False)
              for name, (k, n) in PROJ.items() for mp in ("IS", "WS")
              for g in (0.0, 1.0) for mg in (0.0, 1.0)]
    # deepseek-v2's layer-0 MLP at phase 14's decode and chunk rows: IS
    # with per-row scales as served, PAPER_NOISE, chip 7 (the served chip)
    cases += [(m, k, n, f"IS noisy chip 7 layer0 {name}",
               dict(is_apv, noisy=True, chip=(LAYER0_PROJ, name)), True)
              for name, (k, n) in LAYER0_PROJ.items() for m in M_ROWS]
    # the four dense configs' MLPs (phase 16) likewise, and gemma3's at
    # its 64-row prefill chunk (the tall path)
    cases += [(m, k, n, f"IS noisy chip 7 {arch} {name}",
               dict(is_apv, noisy=True, chip=(proj, name)), True)
              for arch, proj in DENSE_PROJ.items()
              for name, (k, n) in proj.items() for m in M_ROWS]
    cases += [(GEMMA_CHUNK, k, n, f"IS noisy chip 7 gemma3-12b {name}",
               dict(is_apv, noisy=True,
                    chip=(DENSE_PROJ["gemma3-12b"], name)), True)
              for name, (k, n) in DENSE_PROJ["gemma3-12b"].items()]
    # the optical train step's forward (phase 17(b)): qwen3-32b's MLPs at
    # the CLI's 2048 rows, WS, IDEAL noise, no chip (the tall path); timed
    # over fewer calls, each a large fraction of a second
    cases += [(TRAIN_ROWS, k, n, f"WS ideal train {name}",
               dict(mapping=Mapping.WS, chip=False), "tall")
              for name, (k, n) in PROJ.items()]
    # and a model rank's share of them in the split train step (22(e)),
    # IDEAL and, as 22(e)'s optical run takes them, with the paper's
    # per-shot noise and chip 7 (WS realized: the tf32x2 route)
    cases += [(TRAIN_ROWS, k, n, f"WS ideal train split {name}",
               dict(mapping=Mapping.WS, chip=False), "tall")
              for name, (k, n) in PROJ_SPLIT.items()]
    cases += [(TRAIN_ROWS, k, n, f"WS noisy chip 7 train split {name}",
               dict(mapping=Mapping.WS, noisy=True,
                    chip=(PROJ_SPLIT, name)), "tall")
              for name, (k, n) in PROJ_SPLIT.items()]
    # both tf32x3 causes on the tall path: ANALOG at a rank's mlp/wo, a
    # non-ideal OSA (splitter imbalance) at gemma3's chunk
    cases += [(TRAIN_ROWS, *PROJ_SPLIT["mlp/wo"], "ANALOG train split "
               "mlp/wo", dict(mode=ComputeMode.ANALOG, chip=False), "tall"),
              (GEMMA_CHUNK, *DENSE_PROJ["gemma3-12b"]["mlp/wo"],
               "IS osa imbalance gemma3-12b mlp/wo",
               dict(is_apv, chip=False, osa_cfg=OSAConfig(
                   splitter_imbalance=0.01)), True)]
    m, k, n = RAGGED
    cases += [(m, k, n, "IS ragged", is_apv, False),
              (m, k, n, "WS gate 0.3 ragged",
               dict(mapping=Mapping.WS, gate=0.3), False),
              (m, k, n, "ANALOG gate 0.7 ragged",
               dict(mode=ComputeMode.ANALOG, gate=0.7), False),
              (m, k, n, "WS noisy pam2 ragged",
               dict(mapping=Mapping.WS, noisy=True, pam_bits=2), False)]
    return cases


def fused_flops(m, k, n, static) -> int:
    """Float operations of one call: the contraction, the conditioning of
    each activation (~12, ~40 with the realization chain) and of each
    weight (~6, ~46 with the chain)."""
    return (2 * m * k * n + (40 if static["realize_x"] else 12) * m * k
            + (46 if static["realize_w"] else 6) * k * n)


def fused_route_bound(m, k, n, static, route, nbytes) -> tuple[float, str]:
    """Least time of one call on the tall path's route: the larger of the
    products as int8 operations at 1,979 TOP/s (codes) or as 2 or 3 TF32
    passes at 495 TFLOP/s, the conditioning at the float32 rate (other
    units: they may overlap) and the bytes."""
    prods = 2 * m * k * n
    cond = fused_flops(m, k, n, static) - prods
    tp = (prods / INT8_OPS if route == "codes"
          else {"tf32x2": 2, "tf32x3": 3}[route] * prods / TF32_FLOPS)
    tb, tf = nbytes / HBM_BYTES_PER_S, max(tp, cond / F32_FLOPS)
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_row(row, fn, plain_fn, nbytes, flops, reps: int = 10) -> None:
    """Per-call median of `reps` calls, kernel-only time (over 2 x reps
    graph-replayed launches, at most 20), plain version and bound."""
    row["ms"] = median_ms(fn, reps=reps)
    row["kernel_ms"] = kernel_only_ms(fn, n=min(2 * reps, 20))
    row["plain_ms"] = median_ms(plain_fn, reps=min(reps, 5))
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]


def timing_text(row) -> str:
    if "ms" not in row:
        return ""
    return (f"  kernel {row['ms']:.4f} ms (kernel only "
            f"{row['kernel_ms']:.4f})  plain {row['plain_ms']:.3f} ms"
            + (f"  matmul {row['library_ms']:.4f} ms (kernel only "
               f"{row['library_kernel_ms']:.4f})"
               if row.get("library_ms") is not None else "")
            + f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{100 * row['bound_share']:.1f} %)"
            + (f"; {row['route']} route {row['route_bound_ms']:.4f} ms "
               f"({row['route_bound_by']}, "
               f"{100 * row['route_bound_share']:.1f} %)"
               if "route_bound_ms" in row else "")
            + (f"; at the measured copy rate {row['copy_bound_ms']:.4f} ms"
               if "copy_bound_ms" in row else ""))


def copy_rate() -> float:
    """The card's measured device-to-device copy rate [bytes/s]: a 1 GiB
    buffer copied kernel-only (read and write both counted)."""
    import torch
    src = torch.empty(2**28, device=DEVICE)
    dst = torch.empty_like(src)
    ms = kernel_only_ms(lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    return 2 * 2**30 / (ms * 1e-3)


def served_chip(proj: dict, name: str):
    """Chip 7's static variation of projection `name` of a model whose
    optical projections are `proj` {name: (K, N)}, as a Scheduler with
    variation_seed 7 samples it (phases 14 and 16)."""
    import torch
    from repro_torch.robust.variation import sample_chip
    lanes = {nm: k for nm, (k, _) in proj.items()}
    return sample_chip(torch.Generator().manual_seed(7), dims=lanes,
                       device=DEVICE)[name]


def fused_phase(report: dict) -> dict:
    import torch
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.kernels.rosa_fused import ops

    g = torch.Generator(DEVICE).manual_seed(1)
    err, rows, served = 0.0, [], None
    rate = copy_rate()
    report["copy_rate_bytes_per_s"] = rate
    print(f"  measured device copy rate {rate / 1e12:.3f} TB/s (data sheet "
          f"{HBM_BYTES_PER_S / 1e12:.2f})")
    for m, k, n, what, kw, timed in fused_cases():
        kw = dict(kw)
        gate, mgate = kw.pop("gate", None), kw.pop("mgate", None)
        chip = kw.pop("chip", True)
        shift_k = kw.pop("shift_k", None)
        key = None
        if kw.pop("noisy", False):
            kw["noise"] = mrr.PAPER_NOISE
            key = torch.Generator(DEVICE).manual_seed(2)
        x = torch.randn(m, k, device=DEVICE, generator=g)
        w = torch.randn(k, n, device=DEVICE, generator=g)
        if isinstance(chip, tuple):
            var = served_chip(*chip)
        else:
            var = mrr.StaticVariation(
                0.01 * torch.randn(k, device=DEVICE, generator=g),
                0.04 * torch.randn(k, device=DEVICE, generator=g),
                0.01 * torch.randn(k, device=DEVICE, generator=g)) \
                if chip else None
        if shift_k is not None:
            var = var.shift_ddt(shift_k)
        args, static = ops.operands(x, w, key, var, gate, mgate, **kw)
        y = ops.launch(*args, **static)
        y_plain = ops.plain(*args, **static)
        torch.cuda.synchronize()
        e = quantized_parity(y, y_plain, f"rosa_fused {what} {m}x{k}x{n}")
        err = max(err, e)
        # the route of the tall path (a parent tree's ops have none)
        route = ("decode" if m <= 16 else ops.route_of(k, **static)
                 if hasattr(ops, "route_of") else "-")
        row = {"case": what, "m": m, "k": k, "n": n, "max_abs_err": e,
               "route": route}
        if route in ("tf32x2", "tf32x3"):
            row.update(split_tf32_parity(y, y_plain, args, static,
                                         f"rosa_fused {what} {m}x{k}x{n}"))
        if timed:
            if not torch.equal(y, ops.launch(*args, **static)):
                raise AssertionError(f"rosa_fused {what}: two launches on "
                                     "the same inputs differ")
            nbytes = distinct_bytes(*args) + 4 * m * n
            time_row(row, lambda: ops.launch(*args, **static),
                     lambda: ops.plain(*args, **static), nbytes,
                     fused_flops(m, k, n, static),
                     reps=3 if timed == "tall" else 10)
            # the same bytes at the copy rate this card measured
            row["copy_bound_ms"] = nbytes / rate * 1e3
            if route in ("codes", "tf32x2", "tf32x3"):
                row["route_bound_ms"], row["route_bound_by"] = \
                    fused_route_bound(m, k, n, static, route, nbytes)
                row["route_bound_share"] = (row["route_bound_ms"]
                                            / row["kernel_ms"])
            if what == "IS realize_x mlp/wi" and m == 4:
                served = row             # the decode tick's larger launch
        rows.append(row)
        print(f"  rosa_fused {what:24s} {m}x{k}x{n} [{route}]: max_abs_err "
              f"{e:.3e}" + (f"  float64: {row['f64_err']:.3e} (plain "
                            f"{row['plain_f64_err']:.3e}, limit "
                            f"{row['f64_limit']:.3e})"
                            if "f64_err" in row else "")
              + timing_text(row), flush=True)
        del x, w, args, y, y_plain
        torch.cuda.empty_cache()
    # the requantized 8-bit codes, read back through an identity weight:
    # the kernel's realization must equal the plain version's bit for bit,
    # on the decode path (8 rows) and the tall path's codes route (64 rows
    # in one short tile, 2048 in 128-row tiles)
    k = PROJ["mlp/wi"][0]
    var = mrr.StaticVariation(
        *(s * torch.randn(k, device=DEVICE, generator=g)
          for s in (0.01, 0.04, 0.01)))
    eye = torch.eye(k, device=DEVICE)
    flips = {}
    for rows_x in CODE_ROWS:
        x = 3 * torch.randn(rows_x, k, device=DEVICE, generator=g)
        args, static = ops.operands(x, eye, None, var, mapping=Mapping.IS,
                                    act_per_vector=True)
        s2 = args[3][:, 2:3]
        codes = [torch.round(y * 127 / s2) for y in
                 (ops.launch(*args, **static), ops.plain(*args, **static))]
        flips[rows_x] = int((codes[0] != codes[1]).sum())
        print(f"  rosa_fused IS codes through an identity weight "
              f"{rows_x}x{k} [{'decode' if rows_x <= 16 else 'tall'}]: "
              f"{flips[rows_x]} of {codes[0].numel()} differ")
        del x, args, codes
    if any(flips.values()):
        raise AssertionError("rosa_fused: the kernel's requantized codes "
                             "differ from the plain version's")
    report["rosa_fused_cases"] = rows
    report["rosa_fused_code_flips"] = flips
    return dict(served, max_abs_err=err)


def osa_phase(report: dict) -> dict:
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.kernels.osa_matmul import ops

    g = torch.Generator(DEVICE).manual_seed(3)
    gains = Q.plane_weights(device=DEVICE)
    shapes = [(m, k, n) for (k, n) in PROJ.values() for m in M_ROWS]
    # past the grid's y limit of 65535 row tiles: no ported path runs
    # osa_matmul this tall, the launcher must take it all the same
    tall = (CONV_STEM[0] + 1, *CONV_STEM[1:])
    err, rows, served = 0.0, [], None
    for m, k, n in shapes + [RAGGED, tall]:
        x = torch.randn(m, k, device=DEVICE, generator=g)
        w = torch.randn(k, n, device=DEVICE, generator=g)
        q, _ = Q.quantize(x, per_vector=True)
        for fused in (True, False):
            y = ops.launch(q, w, gains, n_planes=7, fused=fused)
            y_plain = ops.plain(q, w, gains, n_planes=7, fused=fused)
            torch.cuda.synchronize()
            what = f"osa_matmul {'fused' if fused else 'per-plane'}"
            e = quantized_parity(y, y_plain, f"{what} {m}x{k}x{n}")
            err = max(err, e)
            row = {"case": what, "m": m, "k": k, "n": n, "max_abs_err": e}
            if (m, k, n) in shapes:
                if not torch.equal(y, ops.launch(q, w, gains, n_planes=7,
                                                 fused=fused)):
                    raise AssertionError(f"{what} {m}x{k}x{n}: two launches "
                                         "on the same inputs differ")
                # per-plane: one contraction per plane, 7x the operations
                planes = 1 if fused else 7
                time_row(row,
                         lambda: ops.launch(q, w, gains, n_planes=7,
                                            fused=fused),
                         lambda: ops.plain(q, w, gains, n_planes=7,
                                           fused=fused),
                         4 * (m * k + k * n + m * n + 7),
                         planes * 2 * m * k * n + 21 * m * k)
                row["library_ms"] = row["library_kernel_ms"] = None
                if fused:
                    row["library_ms"] = median_ms(lambda: torch.matmul(q, w))
                    row["library_kernel_ms"] = kernel_only_ms(
                        lambda: torch.matmul(q, w))
                if (m, k, n) == (4, *PROJ["mlp/wi"]) and fused:
                    served = row
            rows.append(row)
            print(f"  {what:25s} {m}x{k}x{n}: max_abs_err {e:.3e}"
                  + timing_text(row), flush=True)
        del x, w, q, y, y_plain
        torch.cuda.empty_cache()
    report["osa_matmul_cases"] = rows
    return dict(served, max_abs_err=err)


# ---------------------------------------------------------------------------
# Phases 3-5: serving
# ---------------------------------------------------------------------------
def check_run(rep, reqs, vocab: int, what: str) -> None:
    for r in reqs:
        toks = rep.completions[r.rid].tokens
        if len(toks) != r.max_new_tokens:
            raise AssertionError(f"{what}: request {r.rid} got {len(toks)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{what}: token id out of range")


def prefill_logits(sched, prompt):
    import torch
    from repro_torch.serve.decode import PrefillTask
    with torch.inference_mode():
        task = PrefillTask(sched.bundle, sched.scfg, prompt, sched.chunk_fn,
                           sched.device, sched.whole_fn)
        while not task.advance(sched.params):
            pass
    torch.cuda.synchronize()
    return task.logits.float()


def permuted_params(sched, sizes: dict, seed: int):
    """The scheduler's params with the named logical axes permuted (one
    random permutation per axis, `sizes` {axis: length}): the same
    function, every reduction over those axes summed in another order.
    Returns (params, {axis: permutation})."""
    import torch
    from repro_torch.models.module import leaves

    g = torch.Generator().manual_seed(seed)
    perm = {name: torch.randperm(n, generator=g).to(DEVICE)
            for name, n in sizes.items()}
    params: dict = {}
    for path, d in leaves(sched.bundle.skeleton):
        t = sched.params
        for k in path:
            t = t[k]
        for ax, name in enumerate(d.axes):
            if name in perm:
                t = t.index_select(ax, perm[name])
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return params, perm


def permuted(cfg, ref, seed: int):
    """The "ref" Scheduler `ref` again with the hidden ("embed") and MLP
    ("mlp") dimensions of its params and pinned chip permuted."""
    from repro_torch.core import mrr
    from repro_torch.serve import Scheduler

    params, perm = permuted_params(
        ref, {"embed": ref.cfg.d_model, "mlp": ref.cfg.d_ff}, seed)
    lanes = {"mlp/wi": perm["embed"], "mlp/wo": perm["mlp"]}
    chip = {name: mrr.StaticVariation(v.dv[lanes[name]], v.ddt[lanes[name]],
                                      v.dlam[lanes[name]])
            for name, v in ref.engine.variation.items()}
    return Scheduler(cfg, ref.scfg, params=params, chip=chip, device=DEVICE)


def float_order_floor(rebuild, prompt, lr, logits=prefill_logits) -> float:
    """The float-order floor of phases 5 and 14: the largest deviation from
    `lr` of the "ref" pipeline's prefill logits under a function-preserving
    reordering of its sums, relative to max|lr|, over seeds 1 and 2
    (`rebuild(seed)` gives the reordered Scheduler)."""
    import torch
    scale = float(lr.abs().max())
    floor = 0.0
    for seed in (1, 2):
        sched_p = rebuild(seed)
        lp = logits(sched_p, prompt)
        dev = float((lp - lr).abs().max()) / scale
        floor = max(floor, dev)
        print(f"  ref vs ref with permuted reductions (seed {seed}): "
              f"max rel dev {dev:.3e}, argmax {int(lp.argmax())}")
        del sched_p
        torch.cuda.empty_cache()
    return floor


def check_sequential(rep, cfg, scfg, params, reqs, what: str) -> dict:
    """Continuous batching must give each request the greedy tokens it
    gets decoded alone (`run_sequential`); returns those tokens."""
    from repro_torch.serve import run_sequential
    seq = run_sequential(cfg, scfg, params, reqs, device=DEVICE)
    same = sum(rep.completions[r].tokens == v["tokens"]
               for r, v in seq.items())
    print(f"  continuous vs sequential oracle: {same} of {len(reqs)} "
          "requests give identical tokens")
    if same != len(reqs):
        raise AssertionError(f"{what}: continuous tokens differ from the "
                             "sequential oracle's")
    return {r: v["tokens"] for r, v in seq.items()}


def serve_setup():
    """Phase 3's model, serving config and requests (phases 18 and 21
    serve the same)."""
    from repro_torch.serve import ServeConfig, poisson_requests
    cfg = qwen_cfg()
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    reqs = poisson_requests(6, 1.0, vocab=cfg.vocab, prompt_len=(4, 8),
                            gen_len=(2, 40), seed=0)
    return cfg, scfg, reqs


def serve_phase(report: dict) -> dict:
    import torch
    from repro_torch.core.constants import ROSA_OPTIMAL
    from repro_torch.serve import Scheduler, poisson_requests, report_metrics

    cfg, scfg, reqs = serve_setup()
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = {k: v.name for k, v in sched.program.plan.mapping_plan().items()}
    print(f"  qwen3-32b full width, 4 of 64 layers, "
          f"{sched.bundle.n_params:,} params (f32), set-up {setup_s:.1f} s")
    print(f"  plan {plan}")
    if plan != {"mlp/wi": "IS", "mlp/wo": "IS"}:
        raise AssertionError(f"unexpected plan {plan}")

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rep = sched.run(reqs)
    n = launch_counts()
    n_fused, n_osa = n["rosa_fused"], n["osa_matmul"]
    check_run(rep, reqs, cfg.vocab, "fused serve")
    routed = 2 * cfg.n_layers * (rep.decode_steps + rep.prefill_chunks)
    energy = sched.engine.ledger.per_token(ROSA_OPTIMAL, batch=scfg.n_slots)
    metrics = {m.name: m.value for m in report_metrics(rep)}
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} prefill "
          f"chunks, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"  energy_per_token {energy!r} J (ledger)")
    print(f"  rosa_fused launches {n_fused} (routed projections {routed}), "
          f"osa_matmul launches {n_osa}, mrr_transfer launches "
          f"{n['mrr_transfer']} (the fused kernel realizes inside)")
    if n_fused == 0 or n_fused != routed or n_osa != 0 or n["ssd_scan"] \
            or n["mrr_transfer"]:
        raise AssertionError("the served path did not run every routed "
                             "projection through rosa_fused")
    seq_tokens = check_sequential(rep, cfg, scfg, sched.params, reqs,
                                  "qwen3-32b")

    # ---- phase 4: the osa_matmul path -------------------------------------
    pallas = Scheduler(cfg, dataclasses.replace(scfg, rosa_backend="pallas"),
                       params=sched.params, device=DEVICE)
    reqs2 = poisson_requests(2, 1.0, vocab=cfg.vocab, prompt_len=(4, 8),
                             gen_len=(2, 40), seed=1)
    reset_launches()
    rep2 = pallas.run(reqs2)
    n = launch_counts()
    n_osa2, n_fused2 = n["osa_matmul"], n["rosa_fused"]
    check_run(rep2, reqs2, cfg.vocab, "pallas serve")
    routed2 = 2 * cfg.n_layers * (rep2.decode_steps + rep2.prefill_chunks)
    print(f"  pallas stream: {rep2.total_tokens} tokens, osa_matmul launches "
          f"{n_osa2} (routed {routed2}), rosa_fused launches {n_fused2}, "
          f"mrr_transfer launches {n['mrr_transfer']} (one per routed "
          "projection: the IS activation under chip 7)")
    if n_osa2 == 0 or n_osa2 != routed2 or n_fused2 != 0 \
            or n["mrr_transfer"] != routed2:
        raise AssertionError("the pallas path did not run osa_matmul and "
                             "mrr_transfer on every routed projection")

    # ---- phase 5: fused vs the plain composed pipeline, end to end --------
    # Bound.  Both backends realize and requantize the activations bit for
    # bit alike (phase 2 checks the 8-bit codes through an identity weight),
    # so they differ only in the summation order of their contractions.  A
    # different order moves a sum by ~1e-6, which flips a requantization
    # code wherever a value sits on a rounding boundary; a flipped code of
    # the heavy-tailed SwiGLU activation moves its row by one LSB of the
    # row's full scale, and the flips cascade through the layers.  How far
    # that moves this model's logits is measured, not assumed: the same
    # "ref" pipeline runs again with the model's hidden and MLP dimensions
    # permuted (a function-preserving reordering of every reduction, the
    # chip's per-lane variation permuted alike).  The fused kernel must
    # stay within 4x the largest such float-order deviation over two
    # permutations (plus 1e-5 of full scale).
    ref = Scheduler(cfg, dataclasses.replace(scfg, rosa_backend="ref"),
                    params=sched.params, device=DEVICE)
    prompt = reqs[0].prompt
    lf, lr = prefill_logits(sched, prompt), prefill_logits(ref, prompt)
    if not bool(torch.isfinite(lf).all()) or lf.shape != (cfg.vocab,):
        raise AssertionError("fused prefill logits not finite / bad shape")
    rel = float((lf - lr).abs().max()) / float(lr.abs().max())
    floor = float_order_floor(lambda seed: permuted(cfg, ref, seed), prompt,
                              lr)
    bound = 4 * floor + 1e-5
    print(f"  fused vs ref prefill logits: max rel dev {rel:.3e} (bound "
          f"{bound:.3e}), argmax {int(lf.argmax())} vs {int(lr.argmax())}")
    if rel > bound:
        raise AssertionError("fused and ref logits disagree beyond the bound")

    report["serve"] = dict(metrics, energy_per_token_j=energy, plan=plan,
                           tokens={r: c.tokens
                                   for r, c in rep.completions.items()},
                           sequential_tokens=seq_tokens,
                           rosa_fused_launches=n_fused, routed=routed,
                           osa_matmul_launches=n_osa2, setup_s=setup_s,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           fused_vs_ref_logits_rel=rel,
                           ref_float_order_floor_rel=floor)
    return {"rosa_fused": n_fused, "osa_matmul": n_osa2}


# ---------------------------------------------------------------------------
# Phases 6-7: the SSD scan and mamba2-1.3b serving
# ---------------------------------------------------------------------------
def ssd_bound(bsz, l, h, p, g, s, q) -> tuple[float, str]:
    """Least time of one scan: the bytes of x, loga, b, c in and y, state
    out, against the float32 operations the chunked form needs on these
    inputs: per chunk of n valid steps, C B^T on the causal triangle once
    per group; per head the decay mask, att X on the triangle, C S_in (from
    the second chunk on: the first state is zero), the carry (B w)^T X and
    the state decay."""
    nbytes = 4 * (2 * bsz * l * h * p + bsz * l * h + 2 * bsz * l * g * s
                  + bsz * h * s * p)
    flops = 0
    for lo in range(0, l, q):
        n = min(q, l - lo)
        tri = n * (n + 1) // 2
        flops += bsz * g * 2 * tri * s
        per_head = (2 * tri + 2 * tri * p + 2 * n * s * p + n * s
                    + s * p + (2 * n * s * p + n * p if lo else 0))
        flops += bsz * h * per_head
    return bound_ms(nbytes, flops)


def ssd_inputs(bsz, l, h, p, g, s, gen):
    """Scan operands as the served model makes them: log a = -dt with dt
    a softplus (mean ~0.8, so l reaches about -100 within a 128-step chunk
    and exp(l) leaves float32's normal range)."""
    import torch
    x = torch.randn(bsz, l, h, p, device=DEVICE, generator=gen)
    loga = -torch.nn.functional.softplus(
        torch.randn(bsz, l, h, device=DEVICE, generator=gen))
    b = torch.randn(bsz, l, g, s, device=DEVICE, generator=gen)
    c = torch.randn(bsz, l, g, s, device=DEVICE, generator=gen)
    return x, loga, b, c


def ssd_phase(report: dict) -> dict:
    import torch
    from repro_torch.kernels.ssd_scan import ops

    if hasattr(ops, "plan"):         # the chunk-parallel launches' plan
        lib = ops._lib()
        smem = {n: lib.ssd_scan_smem_bytes(i)
                for i, n in enumerate(ops.LAUNCH_NAMES)}
        if smem != ops.SMEM:
            raise AssertionError(f"ssd_scan: the kernels' shared memory "
                                 f"{smem} disagrees with the plan's")
        report["ssd_scan_occupancy"] = ops.occupancy()
        print(f"  resident blocks per SM: {report['ssd_scan_occupancy']}")
    gen = torch.Generator(DEVICE).manual_seed(4)
    rows, served, err = [], None, 0.0
    for bsz, l, h, p, g, s, q in SSD_CASES:
        args = ssd_inputs(bsz, l, h, p, g, s, gen)
        y, st = ops.launch(*args, q)
        y_plain, st_plain = ops.plain(*args, q)
        y2, st2 = ops.launch(*args, q)
        torch.cuda.synchronize()
        what = f"ssd_scan B{bsz} L{l} H{h} P{p} G{g} S{s} Q{q}"
        rel = {}
        for name, a, r in (("y", y, y_plain), ("state", st, st_plain)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{what}: non-finite {name}")
            rel[name] = float((a - r).abs().max() / r.abs().max())
            if rel[name] > 1e-4:
                raise AssertionError(f"{what}: {name} deviates by "
                                     f"{rel[name]:.3e} of its max > 1e-4")
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError(f"{what}: two launches on the same inputs "
                                 "differ")
        e = max(float((y - y_plain).abs().max()),
                float((st - st_plain).abs().max()))
        err = max(err, e)
        row = {"case": what, "B": bsz, "L": l, "H": h, "P": p, "G": g,
               "S": s, "Q": q, "rel_err_y": rel["y"],
               "rel_err_state": rel["state"], "max_abs_err": e,
               "ms": median_ms(lambda: ops.launch(*args, q)),
               "kernel_ms": kernel_only_ms(lambda: ops.launch(*args, q)),
               "plain_ms": median_ms(lambda: ops.plain(*args, q), reps=5)}
        row["bound_ms"], row["bound_by"] = ssd_bound(bsz, l, h, p, g, s, q)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        if hasattr(ops, "plan"):
            row["executed_flops"] = ops.plan(bsz, l, h, p, g, s, q)["flops"]
        rows.append(row)
        if (bsz, l, g) == (1, SSD_SERVED_L, 1):
            served = row
        print(f"  {what}: rel err y {rel['y']:.3e} state "
              f"{rel['state']:.3e}, two launches equal" + timing_text(row))
        del args, y, st, y_plain, st_plain, y2, st2
    report["ssd_scan_cases"] = rows
    return dict(served, max_abs_err=err)


def mamba_phase(report: dict) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm as SSM
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)

    cfg = get_config("mamba2-1.3b")
    scfg = ServeConfig(n_slots=4, max_len=768, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sched.bundle.n_params
    print(f"  mamba2-1.3b full width and depth, {cfg.n_layers} layers, "
          f"{n_params:,} params (f32), set-up {setup_s:.1f} s; routed "
          f"projections {len(sched.program.trace)}")
    if n_params != MAMBA_PARAMS:
        raise AssertionError("not mamba2-1.3b at full width and depth")
    reqs = poisson_requests(8, 1.0, vocab=cfg.vocab, prompt_len=(200, 700),
                            gen_len=(8, 32), seed=0)

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rep = sched.run(reqs)
    n = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_run(rep, reqs, cfg.vocab, "mamba2 serve")
    metrics = {m.name: m.value for m in report_metrics(rep)}
    want = cfg.n_layers * rep.prefill_chunks
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} whole "
          f"prefills (prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens), peak "
          f"{peak_gib:.1f} GiB")
    print(f"  ssd_scan launches {n['ssd_scan']} ({cfg.n_layers} x "
          f"{rep.prefill_chunks} "
          f"prefills = {want}), rosa_fused {n['rosa_fused']}, osa_matmul "
          f"{n['osa_matmul']}")
    if rep.prefill_chunks != len(reqs) or n["ssd_scan"] != want \
            or n["rosa_fused"] or n["osa_matmul"] or n["mrr_transfer"]:
        raise AssertionError("the mamba2 prefills did not each run the "
                             "ssd_scan kernel once per layer")

    # ---- continuous batching against the per-request oracle ---------------
    check_sequential(rep, cfg, scfg, sched.params, reqs, "mamba2-1.3b")

    # ---- the kernel against the plain scan, end to end --------------------
    # Bound: the same prefill with the model's hidden, head and state
    # dimensions permuted (a function-preserving reordering of every
    # reduction, the scan's included) through the plain scan measures the
    # float-order floor; the kernel path must stay within 4x its largest
    # deviation over two permutations (plus 1e-5 of full scale).
    prompt = reqs[0].prompt
    lk = prefill_logits(sched, prompt)
    if not bool(torch.isfinite(lk).all()) or lk.shape != (cfg.vocab,):
        raise AssertionError("mamba2 prefill logits not finite / bad shape")
    SSM.ssd_scan = ssd_ops.plain       # the plain scan, on the card
    try:
        lp = prefill_logits(sched, prompt)
        scale = float(lp.abs().max())
        floor = 0.0
        for seed in (1, 2):
            params_p, _ = permuted_params(
                sched, {"embed": cfg.d_model, "heads": cfg.ssm.n_heads,
                        "state": cfg.ssm.d_state}, seed)
            perm = Scheduler(cfg, scfg, params=params_p, device=DEVICE)
            dev = float((prefill_logits(perm, prompt) - lp).abs().max())
            floor = max(floor, dev / scale)
            print(f"  plain vs plain with permuted reductions (seed {seed}):"
                  f" max rel dev {dev / scale:.3e}")
            del params_p, perm
            torch.cuda.empty_cache()
    finally:
        SSM.ssd_scan = ssd_ops.ssd_scan
    rel = float((lk - lp).abs().max()) / scale
    bound = 4 * floor + 1e-5
    print(f"  ssd_scan kernel vs plain scan, prefill of {len(prompt)} "
          f"tokens: logits max rel dev {rel:.3e} (bound {bound:.3e}), "
          f"argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    if rel > bound or int(lk.argmax()) != int(lp.argmax()):
        raise AssertionError("kernel and plain-scan logits disagree")

    report["mamba2_serve"] = dict(
        metrics, n_params=n_params, setup_s=setup_s,
        prompt_lens=[len(r.prompt) for r in reqs],
        ssd_scan_launches=n["ssd_scan"], peak_gib=peak_gib,
        kernel_vs_plain_logits_rel=rel, plain_float_order_floor_rel=floor)
    return n["ssd_scan"]


# ---------------------------------------------------------------------------
# Phase 8: mrr_transfer
# ---------------------------------------------------------------------------
# (what, shape, per-shot noise, the axis a chip's per-lane fields run
# along: 0 per row, as against a (K, N) weight; 1 per column, as against
# (M, K) activations; None without a chip)
MRR_CASES = [("mobilenet_v3 mb6_dw weight", (60, 25), True, 0),
             ("conv_stem IS sheet, batch 512", (524288, 27), True, None),
             ("conv_stem IS sheet, chip per column", (524288, 27), True, 1),
             ("qwen3-32b mlp/wi", (5120, 51200), True, None),
             ("qwen3-32b mlp/wi, chip only", (5120, 51200), False, 0),
             ("ragged 1-D", (1_000_003,), True, None)]
MRR_SERVED = "mobilenet_v3 mb6_dw weight"     # the main path's largest
# float operations per element of the chain (a division or square root
# counted as one): 38, plus 4 for the draws and 3 for a chip's fields
MRR_OPS = (38, 4, 3)


def mrr_bound(n: int, noisy: bool, lanes: int) -> tuple[float, str]:
    """Least time of one realization: w in and the result out (and the two
    draws in when noisy), the chip's three per-lane fields once, against
    the chain's float operations."""
    nbytes = 4 * n * (4 if noisy else 2) + (12 * lanes)
    ops = n * (MRR_OPS[0] + MRR_OPS[1] * noisy + MRR_OPS[2] * bool(lanes))
    return bound_ms(nbytes, ops)


SASS_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_fast_path(sass: str, func: str) -> tuple[int, int]:
    """(instructions, elements stored) of one pass of the innermost loop
    that stores, in `cuobjdump -sass` output, along the fast path: each
    in-loop branch is taken when the code it skips calls a slow-path
    subroutine (IEEE division and square root) or, in a kernel with
    16-byte accesses, holds the ragged edge's scalar loads and stores."""
    start = sass.index(func)
    end = sass.find("Function :", start + len(func))
    ins = [(int(a, 16), p.strip(), op, x) for a, p, op, x in
           SASS_INSTR.findall(sass[start:end if end > 0 else None])]
    at = {a: i for i, (a, *_) in enumerate(ins)}

    def target(x):
        return int(re.findall(r"0x[0-9a-f]+", x)[-1], 16)

    def scalar_mem(op):
        return op.split(".")[0] in ("LDG", "STG") and ".128" not in op

    wide = any(".128" in op for _, _, op, _ in ins)
    loops = [(at[target(x)], i) for i, (a, _, op, x) in enumerate(ins)
             if op == "BRA" and target(x) < a
             and any(o.startswith("STG") for _, _, o, _ in
                     ins[at[target(x)]:i])]
    head, back = min(loops, key=lambda hb: hb[1] - hb[0])
    i, count, stored = head, 0, 0
    while True:
        a, p, op, x = ins[i]
        count += 1
        if op.startswith("STG"):
            stored += 4 if op.endswith(".128") else 1
        if i == back:
            return count, stored
        j = at.get(target(x), -1) if op == "BRA" else -1
        if op == "BRA" and not p and "P" not in x:
            i = j
        elif head < j <= back and j > i:
            seg = ins[i + 1:j]
            slow = any(o.startswith("CALL") for _, _, o, _ in seg)
            ragged = wide and any(scalar_mem(o) for _, _, o, _ in seg)
            i = j if slow or ragged else i + 1
        else:
            i += 1


# the kernels of the wide sheets: noise without a chip (one stream), a
# chip (per row) without noise (tiles), both with 16-byte accesses
# (mangled template arguments: NOISE, [VAR,] BWD, V)
MRR_SASS = {
    "qwen3-32b mlp/wi": "transfer_kernel_flatILb1ELb0ELi4E",
    "qwen3-32b mlp/wi, chip only": "transfer_kernel_tilesILb0ELi1ELb0ELi4E"}


RESOURCE = re.compile(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) "
                      r"SHARED:(\d+) LOCAL:(\d+)")


def kernel_resources(lib) -> dict:
    """{mangled kernel name: (registers a thread, local bytes a thread)}
    of a built library, from `cuobjdump --dump-resource-usage` (local
    bytes are spills and stack arrays)."""
    import os
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = subprocess.run([tool, "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return {m[0]: (int(m[1]), int(m[4])) for m in RESOURCE.findall(out)}


def mrr_instruction_floor(rows: list, kernels_by_case: dict = MRR_SASS,
                          label: str = "mrr_transfer") -> None:
    """The chain's instruction floor: SASS instructions a thread issues
    per element on the fast path (`sass_fast_path` over the built
    library), times n, over 132 SMs x 128 lanes x the SM's maximum clock
    (4 warp schedulers issue one warp instruction a cycle each); and the
    kernel's registers and local bytes a thread.  `kernels_by_case` names
    each case's kernel."""
    import os
    from repro_torch import kernels
    lib = kernels.build_all(["mrr_transfer"])["mrr_transfer"]
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    resources = kernel_resources(lib)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for row in rows:
        func = kernels_by_case.get(row["case"])
        if func is None or func not in sass:    # no kernel named for it
            continue
        count, stored = sass_fast_path(sass, func)
        n = math.prod(row["shape"])
        row["kernel"] = func
        row["instr_per_element"] = count / stored
        row["instr_floor_ms"] = n * count / stored / (
            n_sm * 128 * mhz * 1e6) * 1e3
        row["registers"], row["local_bytes"] = next(
            v for k, v in resources.items() if func in k)
        print(f"  {label} {row['case']}: {count} SASS instructions per "
              f"{stored} elements on the fast path, floor "
              f"{row['instr_floor_ms']:.4f} ms at {mhz:.0f} MHz x {n_sm} "
              f"SMs (kernel only {row['kernel_ms']:.4f} ms); "
              f"{row['registers']} registers, {row['local_bytes']} local "
              "bytes a thread")


def mrr_phase(report: dict) -> dict:
    import torch
    from repro_torch.core import mrr
    from repro_torch.kernels.mrr_transfer import ops

    g = torch.Generator(DEVICE).manual_seed(5)
    rows, served = [], None
    for what, shape, noisy, axis in MRR_CASES:
        w = 2 * torch.rand(shape, device=DEVICE, generator=g) - 1
        var, lanes = None, 0
        if axis is not None:
            lanes = shape[axis]
            var = mrr.StaticVariation(
                *(s * torch.randn(lanes, device=DEVICE, generator=g)
                  for s in (0.01, 0.04, 0.01)))
            if axis == 0:
                var = mrr.expand_lanes(var, w)
        sig = (mrr.PAPER_NOISE.sigma_dac, mrr.PAPER_NOISE.sigma_th) \
            if noisy else (0.0, 0.0)
        eps = mrr.draw_eps(torch.Generator(DEVICE).manual_seed(6), shape,
                           DEVICE) if noisy else (None, None)
        y = ops.launch(w, *eps, *sig, var=var)
        y_plain = ops.plain(w, *eps, *sig, var=var)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"mrr_transfer {what}: non-finite output")
        e = float((y - y_plain).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"mrr_transfer {what}: kernel differs from "
                                 f"the plain version by {e:.3e}")
        row = {"case": what, "shape": list(shape), "noise": noisy,
               "chip_axis": axis, "max_abs_err": e,
               "ms": median_ms(lambda: ops.launch(w, *eps, *sig, var=var)),
               "kernel_ms": kernel_only_ms(
                   lambda: ops.launch(w, *eps, *sig, var=var)),
               "plain_ms": median_ms(
                   lambda: ops.plain(w, *eps, *sig, var=var))}
        row["bound_ms"], row["bound_by"] = mrr_bound(w.numel(), noisy, lanes)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        if what == MRR_SERVED:
            served = row
        print(f"  mrr_transfer {what:36s} {tuple(shape)}: bitwise equal"
              + timing_text(row), flush=True)
        del w, var, eps, y, y_plain
        torch.cuda.empty_cache()
    mrr_instruction_floor(rows)
    report["mrr_transfer_cases"] = rows
    return dict(served, max_abs_err=max(r["max_abs_err"] for r in rows))


# ---------------------------------------------------------------------------
# Phases 9-10: the Table 4 pipeline over the four paper CNNs, and the
# mobilenet_v3 golden file
# ---------------------------------------------------------------------------
CNNS = ("alexnet", "vgg16", "resnet18", "mobilenet_v3")
CNN = "mobilenet_v3"                   # the golden file's network
# QAT at batch 64 on 4096 images (cut from 400 steps to fit the script's
# time with phase 22(e))
TABLE4 = dict(steps=200, n_mc=3)
# EDP [J*s] of WS and of DEAP-CNNs on each network's full-size rows at
# batch 128: the reference's floats (core.mapping.plan_edp and
# core.energy.network_energy of src/repro), which
# tests/test_torch_table4.py holds equal to the reference's
TABLE4_EDP = {"alexnet": (0.09528840575672215, 38968.06817541521),
              "vgg16": (0.04198542905483209, 119085.41858453903),
              "resnet18": (0.06639472322351758, 435459.5256307617),
              "mobilenet_v3": (1.794560881706427e-05, 52.23022904750444)}
GOLDEN = ROOT / "tests" / "data" / "torch_cnn_mobilenet_v3.npz"
TRAINED: dict = {}                     # phase 9's parameters, by model


def noisy_launches(specs, noisy: set[str], evals: int) -> dict:
    """Launches of `evals` evaluations with the layers `noisy` noisy on the
    card: one rosa_fused per noisy conv/fc matmul, one mrr_transfer per
    noisy depthwise weight (its conditioning ignores the mapping)."""
    dw = sum(1 for s in specs if s.name in noisy and s.kind == "dwconv")
    routed = sum(1 for s in specs if s.name in noisy and s.kind != "dwconv")
    return {"rosa_fused": evals * routed, "mrr_transfer": evals * dw}


def table4_launches(specs, plan: dict, n_mc: int) -> dict:
    """What the pipeline must launch: the profile makes each layer alone
    noisy under IS and under WS (n_mc evaluations each); WS, IS, the
    hybrid plan and ANALOG make every layer noisy (n_mc each); training
    and the clean evaluations take the ideal fake-quant path."""
    total = {"rosa_fused": 0, "mrr_transfer": 0}

    def add(c):
        for k in total:
            total[k] += c[k]

    for s in specs:
        add(noisy_launches(specs, {s.name}, 2 * n_mc))
    every = {s.name for s in specs}
    for _ in ("ws", "is", "analog"):
        add(noisy_launches(specs, every, n_mc))
    add(noisy_launches(specs, set(plan), n_mc))       # hybrid
    return total


def table4_phase(report: dict) -> dict:
    """`launch.table4.run` over the four CNNs, one model per main-path run
    (counts from 0 before each, read right after); returns the launches
    summed over the four runs."""
    import torch
    from repro_torch.launch import table4
    from repro_torch.models.cnn import LITE_MODELS

    results, total = {}, {"rosa_fused": 0, "mrr_transfer": 0}
    print(f"  {TABLE4['steps']} QAT steps at batch 64, n_mc "
          f"{TABLE4['n_mc']}, eval batch 512")
    for model in CNNS:
        specs = LITE_MODELS[model]
        # ---- the main path: counts from 0, read right after --------------
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = table4.run([model], TABLE4["steps"], TABLE4["n_mc"],
                         device=DEVICE, verbose=False,
                         keep_params=True)[model]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        TRAINED[model] = res.pop("params")       # for phase 12
        want = table4_launches(specs, res["plan"], TABLE4["n_mc"])
        accs, edp = res["accs"], res["edp"]
        print(f"  {model}: {len(specs)} layers; plan "
              f"{res['plan_is_layers']}/{len(res['plan'])} layers IS "
              f"{sorted(k for k, v in res['plan'].items() if v == 'input_stationary')}")
        print("    acc[%]: " + "  ".join(f"{k}={v:.2f}"
                                         for k, v in accs.items())
              + f"  hybrid - WS {accs['hybrid'] - accs['ws']:+.2f} pp")
        print(f"    EDP[J*s]: WS={edp['ws']!r} hybrid={edp['hybrid']!r} "
              f"DEAP={edp['deap']!r}; hybrid below WS by "
              f"{(1 - edp['hybrid'] / edp['ws']) * 100:.1f}%, below DEAP by "
              f"{(1 - edp['hybrid'] / edp['deap']) * 100:.4f}%")
        print("    wall s: " + "  ".join(f"{k}={v:.2f}"
                                         for k, v in res["wall_s"].items())
              + f"  (total {wall:.2f}, peak {peak:.2f} GiB)")
        print(f"    launches {n} (want rosa_fused {want['rosa_fused']}, "
              f"mrr_transfer {want['mrr_transfer']})", flush=True)
        if n["rosa_fused"] != want["rosa_fused"] or n["mrr_transfer"] \
                != want["mrr_transfer"] or n["osa_matmul"] or n["ssd_scan"] \
                or n["mrr_transfer_bwd"]:
            # every noisy evaluation must launch these kernels, so equal
            # counts also show that the QAT training launched neither
            raise AssertionError(f"{model}: the Table 4 pipeline did not run "
                                 "its noisy evaluations through "
                                 "rosa_fused/mrr_transfer")
        if not all(math.isfinite(a) and 0.0 <= a <= 100.0
                   for a in accs.values()):
            raise AssertionError(f"{model}: accuracies out of range: {accs}")
        if (edp["ws"], edp["deap"]) != TABLE4_EDP[model]:
            raise AssertionError(f"{model}: EDP differs from the reference's:"
                                 f" WS, DEAP {edp['ws']!r}, {edp['deap']!r} "
                                 f"vs {TABLE4_EDP[model]!r}")
        results[model] = res
        report.setdefault("table4", {})[model] = dict(
            res, launches=n, want_launches=want, total_wall_s=wall,
            peak_gib=peak)
        for k in total:
            total[k] += n[k]
    avg = table4.averages(results)
    table4.print_averages(avg)
    report["table4_averages"] = avg
    return total


def load_golden(device):
    """(params, chip, labels, {name: logits}) of the golden file."""
    import numpy as np
    import torch
    from repro_torch.core import mrr

    params: dict = {}
    fields: dict = {}
    logits: dict = {}
    with np.load(GOLDEN) as z:
        labels = torch.from_numpy(z["labels"]).to(device)
        for k in z.files:
            kind, *rest = k.split(".")
            t = torch.from_numpy(z[k]).to(device)
            if kind == "params":
                params.setdefault(rest[0], {})[rest[1]] = t
            elif kind == "chip":
                fields.setdefault(rest[0], {})[rest[1]] = t
            elif kind == "logits":
                logits[rest[0]] = t
    chip = {k: mrr.StaticVariation(v["dv"], v["ddt"], v["dlam"])
            for k, v in fields.items()}
    return params, chip, labels, logits


def permuted_cnn(params, chip, specs, seed: int):
    """The CNN's parameters and chip with every channel axis permuted (one
    random permutation per layer output, the input's RGB included): the
    same function, every reduction summed in another order.  Returns
    (params, chip, input channel permutation)."""
    import torch
    from repro_torch.core import mrr

    g = torch.Generator().manual_seed(seed)
    perm = lambda n: torch.randperm(n, generator=g).to(DEVICE)
    p_in = p0 = perm(3)
    out_p, out_c = {}, {}
    for i, s in enumerate(specs):
        w, b = params[s.name]["w"], params[s.name]["b"]
        if s.kind == "dwconv":
            p_out = lanes = p_in
            w2 = w[p_in]
        else:
            p_out = (torch.arange(s.c_out, device=DEVICE)
                     if i == len(specs) - 1 else perm(s.c_out))
            kk = s.k * s.k if s.kind == "conv" else 1
            lanes = (p_in[:, None] * kk
                     + torch.arange(kk, device=DEVICE)).reshape(-1)
            w2 = w[lanes][:, p_out]
        out_p[s.name] = {"w": w2, "b": b[p_out]}
        v = chip[s.name]
        out_c[s.name] = mrr.StaticVariation(v.dv[lanes], v.ddt[lanes],
                                            v.dlam[lanes])
        p_in = p_out
    return out_p, out_c, p0


def plain_kernels():
    """Context: route the rosa_fused and mrr_transfer wrappers to their
    plain versions on the card (the plain path)."""
    import contextlib

    from repro_torch.kernels.mrr_transfer import ops as mrr_ops
    from repro_torch.kernels.rosa_fused import ops as fused_ops

    @contextlib.contextmanager
    def ctx():
        saved = fused_ops.launch, mrr_ops.launch
        fused_ops.launch, mrr_ops.launch = fused_ops.plain, mrr_ops.plain
        try:
            yield
        finally:
            fused_ops.launch, mrr_ops.launch = saved

    return ctx()


def golden_phase(report: dict) -> dict:
    import dataclasses as dc

    import torch
    from repro_torch import rosa
    from repro_torch.core.constants import Mapping
    from repro_torch.data.synth_cifar import synth_cifar
    from repro_torch.models.cnn import LITE_MODELS
    from repro_torch.training.cnn_train import QAT_CFG, cnn_program

    specs = LITE_MODELS[CNN]
    names = [s.name for s in specs]
    params, chip, labels, gold = load_golden(DEVICE)
    xte, yte = synth_cifar(512, seed=1, noise=0.35)    # the test split
    x = torch.from_numpy(xte).to(DEVICE)
    if not torch.equal(torch.from_numpy(yte).to(DEVICE), labels):
        raise AssertionError("the golden labels are not the test split's")
    progs = {"clean": cnn_program(CNN, rosa.Engine.from_config(
                 QAT_CFG, layers=names)),
             "ws": cnn_program(CNN, rosa.Engine.from_config(
                 dc.replace(QAT_CFG, mapping=Mapping.WS), layers=names)),
             "is": cnn_program(CNN, rosa.Engine.from_config(
                 dc.replace(QAT_CFG, mapping=Mapping.IS), layers=names))}
    out: dict = {}
    for name, prog in progs.items():
        var = None if name == "clean" else chip
        reset_launches()
        with torch.no_grad():
            lk = prog(params, x, variation=var)
        torch.cuda.synchronize()
        n = launch_counts()
        want = noisy_launches(specs, set() if var is None else set(names), 1)
        if not bool(torch.isfinite(lk).all()) or lk.shape != (512, 10):
            raise AssertionError(f"{name}: logits not finite / bad shape")
        if n["rosa_fused"] != want["rosa_fused"] \
                or n["mrr_transfer"] != want["mrr_transfer"]:
            raise AssertionError(f"{name}: launches {n}, want {want}")
        right = int((lk.argmax(-1) == labels).sum())
        right_ref = int((gold[name].argmax(-1) == labels).sum())
        scale = float(gold[name].abs().max())
        vs_ref = float((lk - gold[name]).abs().max()) / scale
        row = {"correct": right, "correct_reference": right_ref,
               "acc": 100.0 * right / 512, "launches": n,
               "logits_vs_reference_rel": vs_ref}
        tol = 2 if name == "clean" else 5
        print(f"  {name:5s}: {right}/512 right (reference {right_ref}), "
              f"logits vs reference max rel dev {vs_ref:.3e}, launches "
              f"rosa_fused {n['rosa_fused']} mrr_transfer "
              f"{n['mrr_transfer']}")
        if abs(right - right_ref) > tol:
            raise AssertionError(f"{name}: {right} right vs the reference's "
                                 f"{right_ref} (more than {tol} apart)")
        if var is not None:
            # kernel path vs the plain path on the card, within 4x the
            # float-order floor of the plain path under permuted channels
            with plain_kernels(), torch.no_grad():
                lp = prog(params, x, variation=var)
                sc = float(lp.abs().max())
                floor = 0.0
                for seed in (1, 2):
                    pp, cp, p0 = permuted_cnn(params, chip, specs, seed)
                    dev = float((prog(pp, x[..., p0], variation=cp)
                                 - lp).abs().max()) / sc
                    floor = max(floor, dev)
            rel = float((lk - lp).abs().max()) / sc
            bound = 4 * floor + 1e-5
            row.update(kernel_vs_plain_rel=rel, plain_floor_rel=floor)
            print(f"         kernel vs plain path logits max rel dev "
                  f"{rel:.3e} (bound {bound:.3e}, float-order floor "
                  f"{floor:.3e})")
            if rel > bound:
                raise AssertionError(f"{name}: kernel and plain logits "
                                     "disagree beyond the bound")
        out[name] = row
    report["golden"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 11: the paper's energy model on the card, in float64
# ---------------------------------------------------------------------------
# The reference's values: benchmarks/fig7_array_dse, fig8_osa,
# fig9_power_breakdown, table1_modes, the dse_zoo and hybrid_zoo benches of
# benchmarks/run.py and tests/test_paper_golden.py::_table4_edp_reductions,
# run on src/repro in float64; tests/test_torch_dse.py holds every entry
# equal to the reference's.
ENERGY_REF = {
    "fig7_best_label": "R=8,C=8,T=16",
    "fig7_reduction_vs_deap": 0.33517400209471915,
    "fig7_reduction_vs_compact": 0.22607095668842447,
    "fig8_geomean_reduction_osa": 0.28580986529830166,
    "fig8_geomean_reduction_osa_ode": 0.33332575119641483,
    "fig9_n_workloads": 4,
    "fig9_alexnet_adc_power_reduction": 0.8571428571428571,
    "table1_ops_mixed_vs_analog": 31250.000000000004,
    "table1_mixed_edp": 2.180631443342872e-05,
    "table1_mixed_oadc_energy": 1.5925248e-05,
    "zoo_n_workloads": 16,
    "zoo_n_layer_rows": 5176,
    "zoo_n_candidates": 33,
    "zoo_best_label": "R=16,C=8,T=8",
    "zoo_best_metric": 0.7640359493852568,
    "hybrid_zoo_qwen3-32b": 0.5225714748299136,
    "hybrid_zoo_mamba2-1.3b": 0.9408820185426022,
    "hybrid_zoo_gemma3-12b": 0.5698857465373174,
    "hybrid_zoo_zamba2-1.2b": 0.8661936049304755,
    "hybrid_zoo_seamless-m4t-medium": 0.4955234548765315,
    "table4_avg_hybrid_vs_ws_edp_red": 0.2850777915075481,
    "table4_avg_hybrid_vs_deap_edp_red": 0.9999997594171288,
}
ENERGY_REL = 1e-9     # only the order of the per-workload sums may differ
HYBRID_ZOO = ("qwen3-32b", "mamba2-1.3b", "gemma3-12b", "zamba2-1.2b",
              "seamless-m4t-medium")
ZOO_BATCH = 8


def hybrid_zoo(device) -> dict:
    """EDP of the per-layer hybrid plan over all-WS on zoo architectures
    (accuracy term muted: no behavioural twin for the LLM stacks)."""
    from repro_torch.configs import get_workload_zoo
    from repro_torch.core import mapping as M
    from repro_torch.core.constants import ROSA_OPTIMAL, Mapping

    out = {}
    for wl in get_workload_zoo(include_paper=False, archs=list(HYBRID_ZOO)):
        profs = M.profile_layers_fast(wl.layers, ROSA_OPTIMAL,
                                      batch=ZOO_BATCH, device=device)
        plan = M.hybrid_plan(profs)
        e_h = M.plan_edp(wl.layers, plan, ROSA_OPTIMAL, batch=ZOO_BATCH)
        e_ws = M.plan_edp(wl.layers, {p.name: Mapping.WS for p in profs},
                          ROSA_OPTIMAL, batch=ZOO_BATCH)
        out[f"hybrid_zoo_{wl.name}"] = e_h / e_ws
    return out


def table4_edp_only(device) -> dict:
    """Table 4's EDP side without the behavioural profile: the per-layer
    EDP argmin on each CNN's lite layers (vectorized profile), priced by
    the scalar model; averages over the four CNNs."""
    from repro_torch.core import energy as E
    from repro_torch.core import mapping as M
    from repro_torch.core.constants import (DEAP_HIGH_CHANNEL, ROSA_OPTIMAL,
                                            ComputeMode, Mapping)
    from repro_torch.launch.table4 import mapped_layers

    ws_red, deap_red = [], []
    for model in CNNS:
        mapped = mapped_layers(model)
        plan = M.hybrid_plan(M.profile_layers_fast(
            mapped, ROSA_OPTIMAL, batch=128, device=device))
        e_h = M.plan_edp(mapped, plan, ROSA_OPTIMAL, batch=128)
        e_ws = M.plan_edp(mapped, {}, ROSA_OPTIMAL, batch=128)
        e_deap = E.network_energy(mapped, DEAP_HIGH_CHANNEL, Mapping.WS,
                                  ComputeMode.ANALOG, E.NO_OSA,
                                  batch=128).edp
        ws_red.append(1 - e_h / e_ws)
        deap_red.append(1 - e_h / e_deap)
    return {"table4_avg_hybrid_vs_ws_edp_red": sum(ws_red) / len(ws_red),
            "table4_avg_hybrid_vs_deap_edp_red":
                sum(deap_red) / len(deap_red)}


def energy_values(device) -> dict:
    """Every value of ENERGY_REF, computed by the port on `device`."""
    from repro_torch.configs import get_workload_zoo
    from repro_torch.core import dse
    from repro_torch.launch import (fig7_array_dse, fig8_osa,
                                    fig9_power_breakdown, table1_modes)

    f7 = fig7_array_dse.run(verbose=False, device=device)
    f8 = fig8_osa.run(verbose=False, device=device)
    f9 = fig9_power_breakdown.run(verbose=False, device=device)
    t1 = table1_modes.run(verbose=False, device=device)
    alex = f9["alexnet"]
    wls = get_workload_zoo()
    pts = dse.sweep(wls, batch=ZOO_BATCH, device=device)
    return {
        "fig7_best_label": f7["best"].label,
        "fig7_reduction_vs_deap": f7["reduction_vs_deap"],
        "fig7_reduction_vs_compact": f7["reduction_vs_compact"],
        "fig8_geomean_reduction_osa": f8["geomean_reduction_osa"],
        "fig8_geomean_reduction_osa_ode": f8["geomean_reduction_osa_ode"],
        "fig9_n_workloads": len(f9),
        "fig9_alexnet_adc_power_reduction":
            1 - alex["osa"]["adc"] / alex["no_osa"]["adc"],
        "table1_ops_mixed_vs_analog":
            t1["mixed"]["ops"] / t1["analog"]["ops"],
        "table1_mixed_edp": t1["mixed"]["edp"],
        "table1_mixed_oadc_energy": t1["mixed"]["oadc_energy"],
        "zoo_n_workloads": len(wls),
        "zoo_n_layer_rows": sum(len(w.layers) for w in wls),
        "zoo_n_candidates": len(pts),
        "zoo_best_label": pts[0].label,
        "zoo_best_metric": pts[0].metric,
        **hybrid_zoo(device),
        **table4_edp_only(device),
    }


def energy_mismatches(got: dict, want: dict) -> tuple[list, float]:
    """([keys that differ], largest relative difference of the floats):
    labels and counts must be equal, floats within ENERGY_REL."""
    bad, worst = [], 0.0
    for k, v in want.items():
        g = got.get(k)
        if isinstance(v, float) and isinstance(g, float):
            rel = abs(g - v) / abs(v)
            worst = max(worst, rel)
            if not rel <= ENERGY_REL:
                bad.append(k)
        elif g != v:
            bad.append(k)
    return bad + sorted(set(got) - set(want)), worst


def energy_phase(report: dict) -> dict:
    import torch

    got = energy_values(DEVICE)
    bad, worst = energy_mismatches(got, ENERGY_REF)
    for k, v in got.items():
        print(f"  {k:36s} {v!r}" + ("" if k not in bad else
                                    f"   REFERENCE {ENERGY_REF.get(k)!r}"))
    print(f"  largest relative difference from the reference: {worst:.3e} "
          f"(bound {ENERGY_REL:g})")
    if bad:
        raise AssertionError(f"energy model differs from the reference: "
                             f"{bad}")
    # the zoo sweep's wall on the card (the workloads built once, as the
    # reference's dse_zoo bench times it): median of 10 after 2 warm-ups
    from repro_torch.configs import get_workload_zoo
    from repro_torch.core import dse

    wls, times = get_workload_zoo(), []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dse.sweep(wls, batch=ZOO_BATCH, device=DEVICE)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    print(f"  zoo sweep (16 workloads x 5176 rows x 33 candidates, float64):"
          f" median {wall:.4f} s of 10 on {report['card']}")
    report["energy"] = dict(values=got, max_rel_diff=worst,
                            zoo_sweep_s=wall, zoo_sweep_runs_s=times)
    return got


# ---------------------------------------------------------------------------
# Phase 12: robust — the mrr_transfer backward kernel, variation-aware QAT,
# chip ensembles and the robust CLI runners
# ---------------------------------------------------------------------------
MOBILENET_DW = ((16, 9), (36, 9), (48, 25), (60, 25))   # mb1/2/4/6_dw
# (what, shape, draws, the chip's layout as in MRR_CASES, or "any" for a
# full-shape field)
MRR_BWD_CASES = [
    *(((f"mobilenet_v3 dw {r}x{c}, chip" + (", draws" if noisy else "")),
       (r, c), noisy, 0) for r, c in MOBILENET_DW for noisy in (False, True)),
    ("conv_stem IS sheet, chip per column, draws", (524288, 27), True, 1),
    ("full-shape chip field", (4096, 100), False, "any"),
    ("ragged 1-D, draws, no chip", (1_000_003,), True, None),
    ("(5120, 51200), chip", (5120, 51200), False, 0),
    ("(5120, 51200), chip, draws", (5120, 51200), True, 0)]
MRR_BWD_SERVED = "mobilenet_v3 dw 60x25, chip"   # QAT's largest dw weight


def mrr_kernel(shape, noisy: bool, axis, bwd: bool) -> str:
    """The mangled name (its template arguments NOISE, [VAR,] BWD, V) of
    the csrc/mrr_transfer.cu kernel that a case launches, its streams
    16-byte aligned: one stream without a chip, tiles with one (VAR 1 per
    row, 2 per column, 3 any), V 4 when the rows allow 16-byte accesses."""
    var = {None: 0, 0: 1, 1: 2, "any": 3}[axis]
    v = 4 if var == 0 or shape[-1] % 4 == 0 or len(shape) == 1 else 1
    if var == 0:
        return f"transfer_kernel_flatILb{int(noisy)}ELb{int(bwd)}ELi{v}E"
    return (f"transfer_kernel_tilesILb{int(noisy)}ELi{var}ELb{int(bwd)}"
            f"ELi{v}E")


# every case's backward kernel
MRR_BWD_SASS = {what: mrr_kernel(shape, noisy, axis, True)
                for what, shape, noisy, axis in MRR_BWD_CASES}
# float operations per element of the recomputed chain and its derivative
# in the reciprocal form, each arithmetic operation, min / max, comparison
# and select one (a division or square root one too): 82, plus 4 for the
# draws and 3 for a chip's fields
MRR_BWD_OPS = (82, 4, 3)
ROBUST_QAT = dict(steps=200, batch=64, n_chips=8)   # cut from 400 steps
ROBUST_EVAL_CHIPS = 16
ROBUST_MODEL = "alexnet"
ROBUST_RUNS = {"ensemble": dict(n_chips=64, n_probe=4, n_eval=512),
               "sensitivity": dict(n_chips=16, n_eval=256),
               "drift": dict(n_chips=16, n_eval=256, kind="sine",
                             retrim_every=900.0),
               "sweep": dict(n_chips=32, n_eval=256,
                             scales=(0.0, 0.5, 1.0, 1.5, 2.0))}


def mrr_bwd_bound(n: int, noisy: bool, lanes: int) -> tuple[float, str]:
    """Least time of one backward: w and g in, dq out (and the two draws
    in when noisy), the chip's three fields once, against the float
    operations of the recomputed chain and its derivative."""
    nbytes = 4 * n * (5 if noisy else 3) + 12 * lanes
    ops = n * (MRR_BWD_OPS[0] + MRR_BWD_OPS[1] * noisy
               + MRR_BWD_OPS[2] * bool(lanes))
    return bound_ms(nbytes, ops)


def mrr_bwd_phase(report: dict) -> dict:
    """12(a): the backward kernel against its plain derivative, bit for
    bit, with per-call and kernel-only times, the bound and its share,
    each case's instruction floor and registers."""
    import torch
    from repro_torch.core import mrr
    from repro_torch.kernels.mrr_transfer import ops

    g = torch.Generator(DEVICE).manual_seed(12)
    rows, served = [], None
    for what, shape, noisy, axis in MRR_BWD_CASES:
        w = 2.2 * torch.rand(shape, device=DEVICE, generator=g) - 1.1
        gr = torch.randn(shape, device=DEVICE, generator=g)
        var, lanes = None, 0
        if axis == "any":
            var = mrr.StaticVariation(
                *(s * torch.randn(shape, device=DEVICE, generator=g)
                  for s in (0.01, 0.04, 0.01)))
            lanes = math.prod(shape)
        elif axis is not None:
            lanes = shape[axis]
            var = mrr.StaticVariation(
                *(s * torch.randn(lanes, device=DEVICE, generator=g)
                  for s in (0.01, 0.04, 0.01)))
            if axis == 0:
                var = mrr.expand_lanes(var, w)
        sig = (mrr.PAPER_NOISE.sigma_dac, mrr.PAPER_NOISE.sigma_th) \
            if noisy else (0.0, 0.0)
        eps = mrr.draw_eps(torch.Generator(DEVICE).manual_seed(13), shape,
                           DEVICE) if noisy else (None, None)

        def kernel():
            return ops.launch_backward(gr, w, *eps, *sig, var=var)

        def plain():
            return ops.plain_grad(gr, w, *eps, *sig, var=var)

        y, y_plain = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"mrr_transfer_bwd {what}: non-finite")
        e = float((y - y_plain).abs().max())
        if not torch.equal(y, y_plain):
            raise AssertionError(f"mrr_transfer_bwd {what}: kernel differs "
                                 f"from the plain derivative by {e:.3e}")
        del y, y_plain
        row = {"case": what, "shape": list(shape), "noise": noisy,
               "chip_axis": axis, "max_abs_err": e, "ms": median_ms(kernel),
               "kernel_ms": kernel_only_ms(kernel),
               "plain_ms": median_ms(plain, reps=5)}
        row["bound_ms"], row["bound_by"] = mrr_bwd_bound(w.numel(), noisy,
                                                         lanes)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        if what == MRR_BWD_SERVED:
            served = row
        print(f"  mrr_transfer_bwd {what:44s}: bitwise equal"
              + timing_text(row), flush=True)
        del w, gr, var, eps
        torch.cuda.empty_cache()
    mrr_instruction_floor(rows, MRR_BWD_SASS, "mrr_transfer_bwd")
    report["mrr_transfer_bwd_cases"] = rows
    return dict(served, max_abs_err=max(r["max_abs_err"] for r in rows))


def qat_launches(specs, steps: int) -> dict:
    """Variation-aware QAT with a chip pinned on every step: one rosa_fused
    per conv/fc forward, one mrr_transfer forward and one backward per
    depthwise weight; the clean evaluation after training takes the ideal
    fake-quant path and launches nothing."""
    dw = sum(1 for s in specs if s.kind == "dwconv")
    return {"rosa_fused": steps * (len(specs) - dw),
            "mrr_transfer": steps * dw, "mrr_transfer_bwd": steps * dw,
            "osa_matmul": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def robust_qat(report: dict) -> dict:
    """12(b): variation-aware QAT of mobilenet_v3 over an 8-chip
    antithetic wafer, then both it and phase 9's plainly trained
    mobilenet_v3 over a fresh 16-chip wafer at PAPER_NOISE."""
    import dataclasses as dc

    import torch
    from repro_torch import rosa
    from repro_torch.core import mrr
    from repro_torch.models.cnn import LITE_MODELS
    from repro_torch.robust import ensemble as ENS
    from repro_torch.robust import variation as V
    from repro_torch.training.cnn_train import QAT_CFG, train_cnn

    specs = LITE_MODELS[CNN]
    dims = V.cnn_lane_dims(CNN)
    wafer = V.sample_ensemble(torch.Generator(DEVICE).manual_seed(17),
                              ROBUST_QAT["n_chips"], dims, antithetic=True,
                              device=DEVICE)
    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    t0 = time.perf_counter()
    params, clean = train_cnn(CNN, steps=ROBUST_QAT["steps"],
                              batch=ROBUST_QAT["batch"], ensemble=wafer,
                              device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launch_counts()
    want = qat_launches(specs, ROBUST_QAT["steps"])
    print(f"  variation-aware QAT {CNN}: {ROBUST_QAT['steps']} steps over "
          f"{ROBUST_QAT['n_chips']} chips in {wall:.2f} s, clean acc "
          f"{clean:.2f} %; launches {n} (want {want})", flush=True)
    if n != want:
        raise AssertionError("variation-aware QAT did not run each step's "
                             "conv/fc through rosa_fused and its depthwise "
                             "weights through mrr_transfer forward and "
                             "backward")
    if not all(bool(torch.isfinite(t).all()) for layer in params.values()
               for t in layer.values()):
        raise AssertionError("variation-aware QAT: non-finite parameters")
    names = [s.name for s in specs]
    engine = rosa.Engine.from_config(
        dc.replace(QAT_CFG, noise=mrr.PAPER_NOISE), layers=names)
    k_ens, k_mc = mrr.split(torch.Generator(DEVICE).manual_seed(18))
    fresh = V.sample_ensemble(k_ens, ROBUST_EVAL_CHIPS, dims, device=DEVICE)
    out = {"qat_wall_s": wall, "qat_clean_acc": clean, "qat_launches": n,
           "qat_want_launches": want}
    for label, p in (("variation-aware", params), ("plain", TRAINED[CNN])):
        reset_launches()
        t0 = time.perf_counter()
        res = ENS.evaluate_cnn_ensemble(p, CNN, engine, fresh, k_mc)
        torch.cuda.synchronize()
        ev_wall, ev_n = time.perf_counter() - t0, launch_counts()
        forwards = ROBUST_EVAL_CHIPS * 512 // 128
        ev_want = noisy_launches(specs, set(names), forwards)
        print(f"  {label:15s} {CNN} on {ROBUST_EVAL_CHIPS} fresh chips, "
              f"PAPER_NOISE: clean {res.clean_acc:.2f} %, mean "
              f"{res.mean_acc:.2f} %, min {res.min_acc:.2f} %, yield(2pp) "
              f"{res.yield_frac(2.0):.3f}; {ev_wall:.2f} s, launches "
              f"rosa_fused {ev_n['rosa_fused']} mrr_transfer "
              f"{ev_n['mrr_transfer']}", flush=True)
        if ev_n["rosa_fused"] != ev_want["rosa_fused"] \
                or ev_n["mrr_transfer"] != ev_want["mrr_transfer"]:
            raise AssertionError(f"{label} ensemble evaluation: launches "
                                 f"{ev_n}, want {ev_want}")
        if not (len(res.accs) == ROBUST_EVAL_CHIPS and all(
                math.isfinite(a) and 0.0 <= a <= 100.0 for a in res.accs)):
            raise AssertionError(f"{label}: accuracies out of range")
        out[label] = dict(res.summary(), wall_s=ev_wall, launches=ev_n)
    return out


def check_sensitivity(summary: dict) -> dict:
    """The sensitivity runner's plan and EDP ratio recomputed from its own
    degradation matrix: the search order (`searched_hybrid_plan`'s key over
    `profile_layers_mc`'s profiles), the plan as that order's prefix of
    the chosen length, and the ratio of `mapping.plan_edp` in float64."""
    import numpy as np
    from repro_torch.configs.paper_cnns import CNN_WORKLOADS
    from repro_torch.core import mapping as M
    from repro_torch.core.constants import ROSA_OPTIMAL, Mapping
    from repro_torch.robust import sensitivity as S

    deg, search = summary["degradation"], summary["search"]
    rows = [l for l in CNN_WORKLOADS[ROBUST_MODEL] if l.name in deg]
    prof = {p.name: p for p in S.profile_layers_mc(
        rows, ROSA_OPTIMAL, deg, batch=128, device=DEVICE)}
    order = sorted((n for n, p in prof.items() if p.d_is <= p.d_ws + 0.5),
                   key=lambda n: (prof[n].d_is - prof[n].d_ws) + 0.5 * np.log(
                       max(prof[n].e_is, 1e-30) / max(prof[n].e_ws, 1e-30)))
    order = order[:6]
    plan = set(summary["plan"])
    # an empty plan is also the runner's fallback to pure WS
    want_plan = set(order[:search["n_is"]]) if plan else set()
    is_plan = {n: Mapping.IS for n in plan}
    ratio = (M.plan_edp(rows, is_plan, ROSA_OPTIMAL, batch=128)
             / M.plan_edp(rows, {}, ROSA_OPTIMAL, batch=128))
    if order != search["order"] or plan != want_plan \
            or ratio != summary["hybrid_vs_ws_edp"]:
        raise AssertionError(
            f"sensitivity: order {search['order']} / plan {sorted(plan)} / "
            f"EDP ratio {summary['hybrid_vs_ws_edp']!r} differ from the "
            f"recomputed {order} / {sorted(want_plan)} / {ratio!r}")
    return {"order": order, "plan": sorted(plan), "edp_ratio": ratio}


def cli_launches(name: str, kw: dict, summary: dict) -> dict:
    """What a runner must launch on alexnet (8 conv/fc layers, no
    depthwise): one rosa_fused per layer and noisy forward of a
    micro-batch (the clean references take the ideal path); the ensemble's
    surrogate one mrr_transfer per (chip, layer).  Micro-batches are 128
    images, 64 in the plan search; the drift grid has 9 times, twice."""
    from repro_torch.models.cnn import LITE_MODELS
    layers = len(LITE_MODELS[ROBUST_MODEL])
    chips, chunks = kw["n_chips"], kw["n_eval"] // 128
    if name == "ensemble":
        return {"rosa_fused": kw["n_probe"] * chunks * layers,
                "mrr_transfer": chips * layers, "mrr_transfer_bwd": 0,
                "osa_matmul": 0, "ssd_scan": 0}
    if name == "sensitivity":
        cells = 2 * layers * chunks                      # IS, WS x layers
        search = (len(summary["search"]["order"]) + 1) * (kw["n_eval"] // 64)
        forwards = chips * (cells + search + 2 * chunks)  # + hybrid, WS
    elif name == "drift":
        forwards = 2 * 9 * chips * chunks
    else:
        forwards = len(kw["scales"]) * chips * chunks
    return {"rosa_fused": forwards * layers, "mrr_transfer": 0,
            "mrr_transfer_bwd": 0, "osa_matmul": 0, "ssd_scan": 0}


def robust_cli(report: dict) -> dict:
    """12(c): the four CLI runners on alexnet at the reference's defaults,
    with phase 9's alexnet parameters; each a main-path run of its own
    (counts from 0 before, read right after)."""
    import torch
    from repro_torch.robust import cli

    out = {}
    for name, kw in ROBUST_RUNS.items():
        reset_launches()
        t0 = time.perf_counter()
        summary, metrics = cli.RUNNERS[name](
            ROBUST_MODEL, params=TRAINED[ROBUST_MODEL], device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, launch_counts()
        head = {m.name: m.value for m in metrics}
        print(f"  robust.{name} {ROBUST_MODEL}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in head.items()) + f"; {wall:.2f} s; launches "
            f"rosa_fused {n['rosa_fused']} mrr_transfer "
            f"{n['mrr_transfer']}", flush=True)
        if "n_chips" in head and head["n_chips"] != kw["n_chips"]:
            raise AssertionError(f"robust.{name}: n_chips {head['n_chips']}")
        if not all(math.isfinite(v) for v in head.values()
                   if isinstance(v, float)):
            raise AssertionError(f"robust.{name}: non-finite metric")
        want = cli_launches(name, kw, summary)
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"robust.{name}: launches {n}, want {want}")
        row = {"metrics": head, "wall_s": wall, "launches": n}
        if name == "sensitivity":
            row["recomputed"] = check_sensitivity(summary)
            row["plan"] = summary["plan"]
            row["degradation"] = summary["degradation"]
            print(f"    plan {sorted(summary['plan'])}, search order "
                  f"{summary['search']['order']}, EDP ratio "
                  f"{summary['hybrid_vs_ws_edp']!r} (recomputed equal)")
        if name == "sweep":
            row["rows"] = summary["rows"]
        out[name] = row
    return out


def robust_phase(report: dict) -> dict:
    """12(b) and 12(c); returns the mrr_transfer_bwd launches of the
    variation-aware QAT run."""
    print(f"phase 12(b): variation-aware QAT, {CNN}")
    qat = robust_qat(report)
    print(f"phase 12(c): the robust CLI runners, {ROBUST_MODEL}")
    cli_rows = robust_cli(report)
    report["robust"] = {"qat": qat, "cli": cli_rows}
    return qat["qat_launches"]


# ---------------------------------------------------------------------------
# Phase 13: compile-once Programs with the plan cache, drift-adaptive
# serving of qwen3-32b at full width, and the robust smoke run
# ---------------------------------------------------------------------------
SMOKE_RUN = dict(n_chips=16, n_probe=2, n_eval=64, max_candidates=3)


def qwen_cfg():
    """qwen3-32b at full width, depth cut to 4 of 64 layers (phase 3)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-32b"), n_layers=4)


def compile_once(report: dict) -> dict:
    """13(a): the serving Program compiled twice against one PlanCache:
    cold searches (on the card's energy model), warm loads."""
    import os
    import torch
    from repro_torch import rosa
    from repro_torch.models.model import build_model
    from repro_torch.serve import (ServeConfig, build_serving_program,
                                   serving_model_config)

    bundle = build_model(serving_model_config(qwen_cfg(), rosa=True))
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused")
    root = pathlib.Path(os.environ["ROSA_PLAN_CACHE"]) / "13a"
    progs, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        progs.append(build_serving_program(bundle, scfg, device=DEVICE,
                                           cache=rosa.PlanCache(root)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    cold, warm = progs
    plans = [{k: v.name for k, v in p.plan.mapping_plan().items()}
             for p in progs]
    stats = json.loads(subprocess.run(
        [sys.executable, "-m", "repro_torch.rosa", "stats", "--root",
         str(root)], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))).stdout)
    print(f"  compile walls: cold {walls[0] * 1e3:.2f} ms (searched "
          f"{cold.searched}), warm {walls[1] * 1e3:.2f} ms (cache_hit "
          f"{warm.cache_hit}); plan {plans[1]}; stats: {stats['plans']} "
          f"plan(s), {stats['bytes']} bytes")
    if not (cold.searched and not cold.cache_hit and warm.cache_hit
            and not warm.searched and cold.cache_key == warm.cache_key):
        raise AssertionError("13(a): cold compile must search, warm hit")
    if plans[0] != plans[1] or plans[1] != {"mlp/wi": "IS", "mlp/wo": "IS"}:
        raise AssertionError(f"13(a): plans {plans} differ from phase 3's")
    if stats["plans"] != 1:
        raise AssertionError(f"13(a): cache stats {stats}")
    return {"cold_ms": walls[0] * 1e3, "warm_ms": walls[1] * 1e3,
            "plan": plans[1], "stats": stats}


def arm_launches(rep, routed: int, chip_forwards: int,
                 warm_steps: int) -> int:
    """rosa_fused launches of one A/B arm: every routed projection of every
    decode step, prefill chunk, warm-up step of a swapped-in program and
    chip-pinned probe forward (a probe's clean reference is the ideal
    digital path and launches nothing)."""
    return routed * (rep.decode_steps + rep.prefill_chunks + warm_steps
                     + chip_forwards)


SPANS = {"serve.decode_step": "decode", "serve.prefill_chunk": "prefill",
         "adaptive.probe": "probes", "adaptive.replan": "replans"}


def span_walls(tracer) -> dict:
    """Host walls [s] of one arm by span: decode steps (each up to the read
    of its tokens), prefill chunks, health probes and replans (each ending
    in a read of the device's result, so it covers its device work)."""
    walls = dict.fromkeys(SPANS.values(), 0.0)
    for ev in tracer.events:
        if ev.get("ph") == "X" and ev["name"] in SPANS:
            walls[SPANS[ev["name"]]] += ev["dur"] * 1e-6
    return walls


def tokens_through(rep, tick: int) -> dict:
    """Each request's tokens emitted at or before `tick`: the prefill's
    token at first_token_tick, then one a decode step from admit_tick
    through done_tick."""
    out = {}
    for rid, c in rep.completions.items():
        if len(c.tokens) != c.done_tick - c.admit_tick + 2:
            raise AssertionError(f"13(b): request {rid} did not emit one "
                                 "token a tick from admission to done")
        n = int(c.first_token_tick <= tick) \
            + max(0, min(tick, c.done_tick) - c.admit_tick + 1)
        out[rid] = c.tokens[:n]
    return out


def drift_serve(report: dict) -> dict:
    """13(b): the reference bench's full-size drift_serve scenario
    (`drift_serve_metrics(quick=False)`) on qwen3-32b at full width, built
    as `run_scenario` builds it; each arm (`run_arm`) a main-path run of
    its own, its walls from the scheduler's and the controller's spans."""
    import torch
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.serve.adaptive import (ScenarioConfig, ScenarioResult,
                                            run_arm, scenario_metrics,
                                            scenario_parts)

    cfg = ScenarioConfig(force_replan_at=30)
    model_cfg = qwen_cfg()
    t0 = time.perf_counter()
    parts = scenario_parts(model_cfg, cfg, device=DEVICE)
    torch.cuda.synchronize()
    sched, reqs, probes = parts.sched, parts.requests, parts.probes
    routed = 2 * model_cfg.n_layers
    names = len(probes.names)
    plan = {k: v.name for k, v in sched.program.plan.mapping_plan().items()}
    print(f"  set-up {time.perf_counter() - t0:.1f} s; {cfg.n_requests} "
          f"requests at {cfg.rate}/tick, sine {cfg.amp_k} K over "
          f"{cfg.period_ticks:g} ticks, probes every {cfg.probe_every} "
          f"ticks ({cfg.n_probes} x {cfg.prompt_len} tokens), forced "
          f"replan at tick {cfg.force_replan_at}; plan {plan}")

    arms, launches, walls = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for arm in ("uncontrolled", "controlled"):
        tracer = Tracer()
        reset_launches()                  # counts from 0, read right after
        with tracing(tracer):
            arms[arm] = run_arm(parts, controlled=arm == "controlled")
        launches[arm] = launch_counts()
        walls[arm] = span_walls(tracer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    (monitor, rep_u), (controller, rep_c) = arms.values()
    want = {
        # golden, ref and the probes
        "uncontrolled": arm_launches(rep_u, routed,
                                     2 + len(monitor.series), 0),
        # ref, the probes and every replan's (mapping x layer) cells
        "controlled": arm_launches(
            rep_c, routed, 1 + len(controller.series)
            + controller.replans * 2 * names, controller.replans)}

    res = ScenarioResult.from_arms(cfg, sched, arms["uncontrolled"],
                                   arms["controlled"])
    s = res.summary()
    s["dropped_requests"] = res.dropped_requests(reqs)
    metrics = {m.name: m.value for m in scenario_metrics(res, reqs)}
    for arm, (_, rep) in arms.items():
        n, w = launches[arm], walls[arm]
        w["rest"] = rep.wall_s - sum(w.values())
        print(f"  {arm} wall {rep.wall_s:.2f} s: decode steps "
              f"{w['decode']:.2f}, prefill chunks {w['prefill']:.2f}, "
              f"health probes {w['probes']:.2f}, replans "
              f"{w['replans']:.2f}, host {w['rest']:.2f}")
        print(f"  {arm}: {rep.total_tokens} tokens in {rep.wall_s:.2f} s "
              f"({rep.tokens_per_s:.2f} tok/s), {rep.ticks} ticks, "
              f"{rep.decode_steps} decode steps, {rep.prefill_chunks} "
              f"prefill chunks; rosa_fused launches {n['rosa_fused']} "
              f"(want {want[arm]}), osa_matmul {n['osa_matmul']}, "
              f"mrr_transfer {n['mrr_transfer']}", flush=True)
        if n["rosa_fused"] != want[arm] or n["osa_matmul"] \
                or n["mrr_transfer"] or n["ssd_scan"]:
            raise AssertionError(f"13(b) {arm}: launches {n}, want "
                                 f"rosa_fused {want[arm]} and nothing else")
    print(f"  agreements: ref {s['ref_agreement']!r}, uncontrolled "
          f"{s['uncontrolled_agreement']!r}, controlled "
          f"{s['controlled_agreement']!r}; recovery {s['recovery']!r}; "
          f"retrims {s['retrims']}, trim updates {s['trim_updates']}, "
          f"replans {s['replans']} (plans "
          f"{[w['plan'] for w in controller.swaps]})")
    print(f"  swap wall {s['swap_wall_ms']:.2f} ms, downtime "
          f"{s['swap_downtime_ticks']} ticks; p99 tick {s['p99_tick_ms']:.2f}"
          f" ms; epoch requests {s['epoch_requests']} bit-exact "
          f"{s['epoch_bitexact']}; dropped {s['dropped_requests']}; peak "
          f"{peak:.1f} GiB")
    # both arms run the same ticks; every token emitted up to the first
    # actuator write must be the same bit for bit, finished or not
    tick = res.first_action_tick
    epoch = tokens_through(rep_u, tick)
    n_epoch = sum(map(len, epoch.values()))
    first_done = min(c.done_tick for c in rep_u.completions.values())
    same = epoch == tokens_through(rep_c, tick)
    print(f"  pre-action epoch: {n_epoch} tokens through tick {tick}, "
          f"equal in both arms {same}; first request done at tick "
          f"{first_done}")
    if s["dropped_requests"] != 0 or not s["epoch_bitexact"] \
            or s["swap_downtime_ticks"] != 0 or s["replans"] < 1:
        raise AssertionError(f"13(b): scenario gates failed: {s}")
    if not n_epoch or not same:
        raise AssertionError("13(b): the arms' tokens differ before the "
                             "first actuator write")
    if not all(math.isfinite(v) for v in (
            s["ref_agreement"], s["uncontrolled_agreement"],
            s["controlled_agreement"], s["recovery"])):
        raise AssertionError("13(b): non-finite agreement")
    return {"summary": s, "metrics": metrics, "peak_gib": peak,
            "epoch_tokens": n_epoch, "first_done_tick": first_done,
            "walls_s": walls,
            "tokens_per_s": {a: r.tokens_per_s for a, (_, r) in arms.items()},
            "launches": launches,
            "rosa_fused": sum(n["rosa_fused"] for n in launches.values())}


def smoke_launches(order: int, cold: bool) -> dict:
    """What `run_smoke` launches on alexnet (8 conv/fc layers, no
    depthwise): one rosa_fused per layer and chip-pinned forward (the
    ensemble probes, the degradation cells when the matrix is not cached,
    the search's candidates, the two final plans; each at one micro-batch
    of n_eval images), one mrr_transfer per (chip, layer) for the
    surrogate."""
    from repro_torch.models.cnn import LITE_MODELS
    layers = len(LITE_MODELS[ROBUST_MODEL])
    cells = 2 * layers if cold else 0
    forwards = SMOKE_RUN["n_probe"] * (1 + cells + order + 1 + 2)
    return {"rosa_fused": forwards * layers,
            "mrr_transfer": SMOKE_RUN["n_chips"] * layers,
            "mrr_transfer_bwd": 0, "osa_matmul": 0, "ssd_scan": 0}


def robust_smoke(report: dict) -> dict:
    """13(c): `run_smoke` twice on phase 9's alexnet with one cache: the
    second run finds the degradation matrix and launches none of the
    Monte-Carlo stage."""
    import os
    import torch
    from repro_torch import rosa
    from repro_torch.robust import cli

    root = pathlib.Path(os.environ["ROSA_PLAN_CACHE"]) / "13c"
    rows, total = [], 0
    for i in range(2):
        reset_launches()
        t0 = time.perf_counter()
        summary, metrics = cli.run_smoke(
            ROBUST_MODEL, params=TRAINED[ROBUST_MODEL],
            cache=rosa.PlanCache(root), device=DEVICE, **SMOKE_RUN)
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, launch_counts()
        want = smoke_launches(len(summary["search"]["order"]), i == 0)
        head = {m.name: m.value for m in metrics}
        print(f"  run {i + 1}: matrix_cached {summary['matrix_cached']}, "
              f"plan {sorted(summary['plan'])}, hybrid "
              f"{summary['hybrid_mean_acc']:.2f} % vs WS "
              f"{summary['ws_mean_acc']:.2f} %; {wall:.2f} s; launches "
              f"rosa_fused {n['rosa_fused']} mrr_transfer "
              f"{n['mrr_transfer']} (want {want['rosa_fused']}, "
              f"{want['mrr_transfer']})", flush=True)
        if summary["matrix_cached"] != (i == 1):
            raise AssertionError(f"13(c) run {i + 1}: matrix_cached "
                                 f"{summary['matrix_cached']}")
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"13(c) run {i + 1}: launches {n}, want "
                                 f"{want}")
        if not all(math.isfinite(v) for v in head.values()
                   if isinstance(v, float)):
            raise AssertionError(f"13(c) run {i + 1}: non-finite metric")
        rows.append({"matrix_cached": summary["matrix_cached"],
                     "plan": summary["plan"], "wall_s": wall,
                     "launches": n, "metrics": head})
        total += n["rosa_fused"]
    if rows[0]["plan"] != rows[1]["plan"]:
        raise AssertionError("13(c): the warm run chose another plan")
    return {"runs": rows, "rosa_fused": total}


def adaptive_phase(report: dict) -> int:
    """13(a)-(c); returns phase 13's rosa_fused launches."""
    print("phase 13(a): compile once, the plan cache")
    report["compile_once"] = compile_once(report)
    print("phase 13(b): drift-adaptive serving, qwen3-32b full width")
    drift = drift_serve(report)
    report["drift_serve"] = drift
    print(f"phase 13(c): the robust smoke run twice, {ROBUST_MODEL}")
    smoke = robust_smoke(report)
    report["robust_smoke"] = smoke
    return drift["rosa_fused"] + smoke["rosa_fused"]


# ---------------------------------------------------------------------------
# Phase 14: the moe and mla_moe families at full width
# ---------------------------------------------------------------------------
# (arch, layers kept, params at that depth): full width, depth cut
MOE_MODELS = (("qwen3-moe-235b-a22b", 3, 8_707_928_832),
              ("deepseek-v2-236b", 3, 9_330_795_520))
PEAK_GIB = 70.0


def k_permuted_engine(engine, perms: dict):
    """`engine` with the reduction axis of each named optical product
    permuted (x's columns and w's rows alike, `perms` {name: index}): the
    same function, every routed sum in another order."""
    class KPermuted(type(engine)):
        def matmul(self, x, w, *, name="", **kw):
            p = perms.get(name)
            if p is not None and x.device.type != "meta":  # not the trace
                x, w = x.index_select(-1, p), w.index_select(0, p)
            return super().matmul(x, w, name=name, **kw)

    return KPermuted(**{f.name: getattr(engine, f.name)
                        for f in dataclasses.fields(engine)})


def k_permuted(cfg, ref, seed: int):
    """The "ref" Scheduler `ref` again with each optical contraction's
    reduction axis permuted: x's columns, w's rows and the pinned chip's
    lanes alike.  The same function with every routed sum in another
    order, and nothing else moved: the model's own axes, and with them the
    MoE routing, stay as they are."""
    import torch
    from repro_torch.core import mrr
    from repro_torch.serve import Scheduler

    g = torch.Generator().manual_seed(seed)
    perms = {name: torch.randperm(v.dv.shape[0], generator=g).to(DEVICE)
             for name, v in ref.engine.variation.items()}
    engine = k_permuted_engine(ref.engine, perms)
    chip = {name: mrr.StaticVariation(v.dv[perms[name]], v.ddt[perms[name]],
                                      v.dlam[perms[name]])
            for name, v in ref.engine.variation.items()}
    return Scheduler(cfg, ref.scfg, params=ref.params, device=DEVICE,
                     engine=engine.with_variation(chip).with_ledger(None))


@contextlib.contextmanager
def recorded_routes():
    """The expert ids `moe._route` picks inside the block, in call order."""
    from repro_torch.models import moe
    route, ids = moe._route, []

    def recording(p, cfg, x2):
        w, i = route(p, cfg, x2)
        ids.append(i)
        return w, i

    moe._route = recording
    try:
        yield ids
    finally:
        moe._route = route


def moe_serve(arch: str, layers: int, n_params: int) -> dict:
    """One phase-14 model: serve 6 requests at full width, then the
    checks.  Returns its report entry (rosa_fused launches included)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    optical = cfg.first_dense_ff > 0      # deepseek-v2's dense layer 0
    scfg = ServeConfig(n_slots=4, max_len=56, prefill_chunk=8, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = {k: v.name for k, v in sched.program.plan.mapping_plan().items()}
    print(f"  {arch} full width, {layers} of {get_config(arch).n_layers} "
          f"layers, {sched.bundle.n_params:,} params (f32), set-up "
          f"{setup_s:.1f} s; plan {plan}")
    if sched.bundle.n_params != n_params:
        raise AssertionError(f"{arch}: not the full-width model")
    if set(plan) != ({"mlp/wi", "mlp/wo"} if optical else set()):
        raise AssertionError(f"{arch}: unexpected plan {plan}")
    reqs = poisson_requests(6, 1.0, vocab=cfg.vocab, prompt_len=(4, 8),
                            gen_len=(2, 40), seed=0)

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    rep = sched.run(reqs)
    n = launch_counts()
    check_run(rep, reqs, cfg.vocab, f"{arch} serve")
    metrics = {m.name: m.value for m in report_metrics(rep)}
    routed = (2 * (rep.decode_steps + rep.prefill_chunks) if optical
              else 0)
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} prefill "
          f"chunks, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"  rosa_fused launches {n['rosa_fused']} (routed projections "
          f"{routed}), osa_matmul {n['osa_matmul']}, mrr_transfer "
          f"{n['mrr_transfer']}, ssd_scan {n['ssd_scan']}")
    if n["rosa_fused"] != routed or n["osa_matmul"] or n["mrr_transfer"] \
            or n["ssd_scan"] or n["mrr_transfer_bwd"]:
        raise AssertionError(f"{arch}: the kernels launched are not the "
                             "routed projections")

    check_sequential(rep, cfg, scfg, sched.params, reqs, arch)
    out = dict(metrics, n_params=sched.bundle.n_params, layers=layers,
               plan=plan, setup_s=setup_s, rosa_fused_launches=n["rosa_fused"],
               routed=routed)

    # ---- deepseek-v2: fused vs the plain composed pipeline (phase 5) ------
    # Phase 5's bound, with a floor from layer 0's optical MLP alone, the
    # only place where fused and ref differ: permuting the model's hidden
    # axis would reorder the router's sums too and flip top-k choices,
    # which the fused path does not do.  Every run must route each token
    # to the experts the "ref" run picks.
    if optical:
        ref = Scheduler(cfg, dataclasses.replace(scfg, rosa_backend="ref"),
                        params=sched.params, device=DEVICE)
        prompt = reqs[0].prompt
        with recorded_routes() as want:
            lr = prefill_logits(ref, prompt)

        def routed_logits(s, prompt):
            with recorded_routes() as ids:
                out = prefill_logits(s, prompt)
            if len(ids) != len(want) or not all(
                    torch.equal(a, b) for a, b in zip(ids, want)):
                raise AssertionError(f"{arch}: the experts routed differ "
                                     "from the ref pipeline's")
            return out

        lf = routed_logits(sched, prompt)
        if not bool(torch.isfinite(lf).all()) or lf.shape != (cfg.vocab,):
            raise AssertionError("fused prefill logits not finite / bad "
                                 "shape")
        rel = float((lf - lr).abs().max()) / float(lr.abs().max())
        floor = float_order_floor(lambda seed: k_permuted(cfg, ref, seed),
                                  prompt, lr, routed_logits)
        bound = 4 * floor + 1e-5
        print(f"  fused vs ref prefill logits: max rel dev {rel:.3e} (bound "
              f"{bound:.3e}), argmax {int(lf.argmax())} vs "
              f"{int(lr.argmax())}; routed experts equal in every run")
        if rel > bound:
            raise AssertionError("fused and ref logits disagree beyond the "
                                 "bound")
        out.update(fused_vs_ref_logits_rel=rel,
                   ref_float_order_floor_rel=floor)
        del ref
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["peak_gib"] = peak
    print(f"  peak {peak:.1f} GiB over the phase (limit {PEAK_GIB:.0f})")
    if peak >= PEAK_GIB:
        raise AssertionError(f"{arch}: peak {peak:.1f} GiB")
    return out


def moe_phase(report: dict) -> int:
    """Phase 14: qwen3-moe-235b-a22b, then deepseek-v2-236b, each freed
    before the next.  Returns phase 14's rosa_fused launches."""
    import gc
    import torch
    rows = {}
    for arch, layers, n_params in MOE_MODELS:
        rows[arch] = moe_serve(arch, layers, n_params)
        gc.collect()
        torch.cuda.empty_cache()
    report["moe_serve"] = rows
    return sum(r["rosa_fused_launches"] for r in rows.values())


# ---------------------------------------------------------------------------
# Phase 15: the hybrid and encdec families at full width and depth
# ---------------------------------------------------------------------------
ZAMBA_PARAMS = 1_104_777_344      # zamba2-1.2b at full width and depth
ZAMBA_PROMPT = 700                # the kernel-vs-plain prefill's length
SEAMLESS_PARAMS = 977_758_208     # seamless-m4t-medium, 12 + 12 layers
SEAMLESS_ARGS = ["--arch", "seamless-m4t-medium", "--policy", "batch",
                 "--batch", "4", "--prompt-len", "32", "--gen", "16"]


def max_rel(got, want) -> float:
    """max|got - want| over max|want| (both moved to float32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def zamba_phase(report: dict) -> int:
    """15(a): zamba2-1.2b served at full width and depth.  Returns the
    main path's ssd_scan launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm as SSM
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)

    cfg = get_config("zamba2-1.2b")
    scfg = ServeConfig(n_slots=4, max_len=768, rosa=True,
                       rosa_backend="fused", variation_seed=7)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sched.bundle.n_params
    plan = sched.program.plan.mapping_plan()
    print(f"  zamba2-1.2b full width and depth, {cfg.n_layers} layers "
          f"({cfg.n_layers // cfg.shared_every} groups of "
          f"{cfg.shared_every} and a tail of "
          f"{cfg.n_layers % cfg.shared_every}), {n_params:,} params (f32), "
          f"set-up {setup_s:.1f} s; routed projections "
          f"{len(sched.program.trace)}, plan {plan}")
    if n_params != ZAMBA_PARAMS:
        raise AssertionError("not zamba2-1.2b at full width and depth")
    if plan or len(sched.program.trace):
        raise AssertionError("zamba2: the shared MLP must bypass the "
                             "optical engine (empty plan)")
    reqs = poisson_requests(8, 1.0, vocab=cfg.vocab, prompt_len=(200, 700),
                            gen_len=(8, 32), seed=0)

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    rep = sched.run(reqs)
    n = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_run(rep, reqs, cfg.vocab, "zamba2 serve")
    metrics = {m.name: m.value for m in report_metrics(rep)}
    want = cfg.n_layers * len(reqs)
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} whole "
          f"prefills (prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens), peak "
          f"{peak_gib:.1f} GiB")
    print(f"  ssd_scan launches {n['ssd_scan']} ({cfg.n_layers} x "
          f"{len(reqs)} prefills = {want}), rosa_fused {n['rosa_fused']}, "
          f"osa_matmul {n['osa_matmul']}, mrr_transfer {n['mrr_transfer']}")
    if rep.prefill_chunks != len(reqs) or n["ssd_scan"] != want \
            or n["rosa_fused"] or n["osa_matmul"] or n["mrr_transfer"] \
            or n["mrr_transfer_bwd"]:
        raise AssertionError("the zamba2 prefills did not each run the "
                             "ssd_scan kernel once per ssm layer, and "
                             "nothing else")

    # ---- continuous batching against the per-request oracle ---------------
    check_sequential(rep, cfg, scfg, sched.params, reqs, "zamba2-1.2b")

    # ---- one 700-token prefill: the kernel against the plain scan ---------
    # Each of its 38 scans runs the kernel and the plain scan on the
    # operands the model gives it: y and the final state within 1e-4 of
    # their max (the CPU tests' bound).  The whole prefill, through the
    # kernel and through the plain scan, is held to phase 7's rule: 4x the
    # float-order floor of the plain path (the hidden and state
    # dimensions permuted, every reduction summed in another order), on
    # the logits and on every state leaf; a random-weight stack this deep
    # moves by more than 1e-4 under a mere reordering (phase 7: 9e-5 to
    # 1.2e-4 at 48 layers), so a fixed 1e-4 on the whole model would
    # measure float noise, not the kernel.
    prompt = torch.randint(0, cfg.vocab, (1, ZAMBA_PROMPT),
                           generator=torch.Generator().manual_seed(15),
                           dtype=torch.int32).to(DEVICE)
    per_scan = []

    def both(x, loga, b, c, chunk):
        y, st = ssd_ops.ssd_scan(x, loga, b, c, chunk)
        yp, sp = ssd_ops.plain(x, loga, b, c, chunk)
        per_scan.append((max_rel(y, yp), max_rel(st, sp)))
        return y, st

    def prefill(params):
        with torch.inference_mode():
            logits, cache = sched.whole_fn(params, {"tokens": prompt})
        states = {"groups.state": cache["groups"]["ssm"]["state"],
                  "tail.state": cache["tail"]["state"]}
        return dict(states, logits=logits)

    SSM.ssd_scan = both
    try:
        kern = prefill(sched.params)
        SSM.ssd_scan = ssd_ops.plain       # the plain scan, on the card
        plain = prefill(sched.params)
        floor = dict.fromkeys(plain, 0.0)
        for seed in (1, 2):
            params_p, perm = permuted_params(
                sched, {"embed": cfg.d_model, "state": cfg.ssm.d_state},
                seed)
            got = prefill(params_p)
            # the permuted run's states hold the state axis permuted
            dev = {k: max_rel(got[k], want if k == "logits" else
                              want.index_select(-2, perm["state"]))
                   for k, want in plain.items()}
            floor = {k: max(floor[k], dev[k]) for k in plain}
            print(f"  plain vs plain with permuted reductions (seed {seed}):"
                  " max rel dev " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in dev.items()))
            del params_p, got
            torch.cuda.empty_cache()
    finally:
        SSM.ssd_scan = ssd_ops.ssd_scan
    torch.cuda.synchronize()
    lk, lp = kern["logits"], plain["logits"]
    if not bool(torch.isfinite(lk).all()) or lk.shape != (1, cfg.vocab):
        raise AssertionError("zamba2 prefill logits not finite / bad shape")
    scan_y = max(e for e, _ in per_scan)
    scan_state = max(e for _, e in per_scan)
    print(f"  {len(per_scan)} scans of a {ZAMBA_PROMPT}-token prefill, "
          f"kernel vs plain on the same operands: max rel dev y "
          f"{scan_y:.3e}, state {scan_state:.3e} (bound 1e-4)")
    if len(per_scan) != cfg.n_layers or max(scan_y, scan_state) > 1e-4:
        raise AssertionError("zamba2: a scan of the prefill disagrees with "
                             "the plain scan")
    rel = {k: max_rel(kern[k], plain[k]) for k in plain}
    bound = {k: 4 * floor[k] + 1e-5 for k in plain}
    same = int(lk.argmax()) == int(lp.argmax())
    print("  whole prefill through the kernel vs through the plain scan: "
          "max rel dev " + ", ".join(
              f"{k} {rel[k]:.3e} (bound {bound[k]:.3e})" for k in rel)
          + f", argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    if any(rel[k] > bound[k] for k in rel) or not same:
        raise AssertionError("zamba2: kernel and plain-scan prefills "
                             "disagree beyond the float-order bound")
    report["zamba2_serve"] = dict(
        metrics, n_params=n_params, setup_s=setup_s, peak_gib=peak_gib,
        prompt_lens=[len(r.prompt) for r in reqs],
        ssd_scan_launches=n["ssd_scan"], scan_max_rel_y=scan_y,
        scan_max_rel_state=scan_state, kernel_vs_plain_rel=rel,
        plain_float_order_floor_rel=floor)
    return n["ssd_scan"]


def batch_run(what: str, base_args: list, temperature: str) -> dict:
    """One `--policy batch` run (batch 4, 16 generated) on the card, the
    launch counts from 0 just before it and read just after; no kernel
    may launch."""
    import torch
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        base_args + ["--temperature", temperature, "--device", DEVICE])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = serve_cli.run_batch(args)
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = launch_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  temperature {temperature}: {res['tok_s']:.2f} tok/s, "
          f"prefill {res['prefill_s']:.3f} s, peak {res['peak_gib']:.1f} "
          f"GiB, launches {res['launches']}")
    if any(res["launches"].values()):
        raise AssertionError(f"{what}: the batch path launched a kernel")
    toks, vocab = res["tokens"], res["bundle"].cfg.vocab
    if toks.shape != (4, 16) or not bool(((toks >= 0)
                                          & (toks < vocab)).all()):
        raise AssertionError(f"{what}: bad tokens {tuple(toks.shape)}")
    return res


def seamless_phase(report: dict) -> None:
    """15(b): seamless-m4t-medium through `--policy batch`, greedy and at
    temperature 0.7."""
    import gc
    import torch
    from repro_torch.models.module import map_tree

    res = batch_run("seamless", SEAMLESS_ARGS, "0.0")
    bundle, params, batch = res["bundle"], res["params"], res["batch"]
    if bundle.n_params != SEAMLESS_PARAMS:
        raise AssertionError("not seamless-m4t-medium at full width and "
                             "depth")
    lg = res["logits"]
    if lg.shape != (4, bundle.cfg.vocab) or not bool(
            torch.isfinite(lg).all()):
        raise AssertionError("seamless prefill logits not finite / bad "
                             "shape")
    lens = {k: [t.shape[2] for t in res["cache"]["layers"][k]]
            for k in ("self", "cross")}
    print(f"  cache lengths after pad_cache: {lens}")
    if lens != {"self": [32 + 17] * 2, "cross": [32] * 2}:
        raise AssertionError("seamless: pad_cache grew the wrong axes")

    # ---- the card against the port's own CPU prefill (TF32 off) ----------
    # Bound: phase 5's rule.  The CPU sums in another order than the card,
    # and a random-weight stack of 24 layers moves its logits by more
    # than float rounding under any reordering.  How far is measured on
    # the card: the same prefill with the hidden ("embed") dimension of
    # the params and of the source embeddings permuted (a function-
    # preserving reordering of every reduction over it).  The CPU prefill
    # must stay within 4x the largest such deviation over two
    # permutations (plus 1e-5 of full scale), with the same argmax.
    t0 = time.perf_counter()
    with torch.inference_mode():
        lc, _ = bundle.prefill(map_tree(lambda t: t.cpu(), params),
                               {k: v.cpu() for k, v in batch.items()})
        lz, _ = bundle.prefill(params, dict(
            batch, src_embeds=torch.zeros_like(batch["src_embeds"])))
    cpu_s = time.perf_counter() - t0
    floor = 0.0
    for seed in (1, 2):
        params_p, perm = permuted_params(
            types.SimpleNamespace(bundle=bundle, params=params),
            {"embed": bundle.cfg.d_model}, seed)
        src_p = batch["src_embeds"].index_select(-1, perm["embed"])
        with torch.inference_mode():
            lperm, _ = bundle.prefill(params_p, dict(batch, src_embeds=src_p))
        dev = max_rel(lperm, lg)
        floor = max(floor, dev)
        print(f"  card vs card with permuted reductions (seed {seed}): max "
              f"rel dev {dev:.3e}")
        del params_p, lperm
        torch.cuda.empty_cache()
    rel = max_rel(lg.cpu(), lc)
    bound = 4 * floor + 1e-5
    same = torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
    zero_rel = max_rel(lz, lg)
    print(f"  card vs CPU prefill logits: max rel dev {rel:.3e} (bound "
          f"{bound:.3e}), argmax equal {same}; zero source embeddings move "
          f"the logits by {zero_rel:.3e} of their max (CPU prefill "
          f"{cpu_s:.1f} s)")
    if rel > bound or not same:
        raise AssertionError("seamless: card and CPU prefills disagree "
                             "beyond the float-order bound")
    if zero_rel < 1e-3:
        raise AssertionError("seamless: the decoder does not read the "
                             "encoder memory")
    greedy = res["tokens"]
    out = {"n_params": bundle.n_params, "card_vs_cpu_logits_rel": rel,
           "card_float_order_floor_rel": floor,
           "zero_src_logits_rel": zero_rel, "cache_lengths": lens,
           "greedy": {k: res[k] for k in ("tok_s", "prefill_s", "decode_s",
                                          "wall_s", "peak_gib")},
           "greedy_tokens_row0": greedy[0].tolist()}
    del res, bundle, params, batch, lg, lc, lz
    gc.collect()
    torch.cuda.empty_cache()

    hot = batch_run("seamless", SEAMLESS_ARGS, "0.7")
    if not torch.equal(hot["tokens"][:, 0], greedy[:, 0]):
        raise AssertionError("seamless: the first token (the prefill's "
                             "argmax) differs between the two runs")
    out["sampled"] = {k: hot[k] for k in ("tok_s", "prefill_s", "decode_s",
                                          "wall_s", "peak_gib")}
    report["seamless_batch"] = out
    del hot
    gc.collect()
    torch.cuda.empty_cache()


def family_phase(report: dict) -> int:
    """Phase 15: zamba2-1.2b, then seamless-m4t-medium, the first freed
    before the second.  Returns 15(a)'s ssd_scan launches."""
    import gc
    import torch
    print("phase 15(a): serving zamba2-1.2b at full width and depth")
    n = zamba_phase(report)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 15(b): seamless-m4t-medium --policy batch at full width "
          "and depth")
    seamless_phase(report)
    return n


# ---------------------------------------------------------------------------
# Phase 16: the four dense configs at full width
# ---------------------------------------------------------------------------
# (arch, layers served, params at that depth), each cut: gemma3-12b from
# 48 layers and phi-3-vision-4.2b from 32 to make room for phase 22
# (gemma3 keeps 5 local layers and 1 global)
GEMMA3 = ("gemma3-12b", 6, 2_351_484_672)
DENSE_CUT = (("deepseek-67b", 4, 4_446_035_968),
             ("mistral-large-123b", 4, 6_341_898_240))
PHI3V = ("phi-3-vision-4.2b", 16, 2_009_041_920)
PHASE3_SERVE = dict(max_len=56, prefill_chunk=8)
# gemma3: one prompt past the 1024-token window of its 40 local layers
LONG_PROMPT = 1100
GEMMA_SERVE = dict(max_len=1200, prefill_chunk=GEMMA_CHUNK)
PHI3V_ARGS = ["--arch", "phi-3-vision-4.2b", "--n-layers", "16",
              "--policy", "batch", "--batch", "4", "--prompt-len", "32",
              "--gen", "16"]
PHI3V_PATCHES = 16                # the zero patches `--policy batch` feeds
PHI3V_CPU_LAYERS = 8              # depth of the card-vs-CPU prefill check


def dense_serve(arch: str, layers: int, n_params: int, serve_kw: dict,
                long_prompt: int = 0, ref_check: bool = True) -> dict:
    """One phase-16 model served through the optical engine (fused, chip
    7): 6 seeded Poisson requests as in phase 3 (plus one `long_prompt`
    prompt), 4 slots; every layer's two MLP projections launch
    rosa_fused once per decode step and prefill chunk, nothing else
    launches, continuous == sequential and, with `ref_check`, fused vs
    "ref" prefill logits within 4x the float-order floor (phase 14's rule:
    only the optical products' reduction axis permuted).  Returns its
    report entry."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import (Scheduler, ServeConfig, poisson_requests,
                                   report_metrics)
    from repro_torch.serve.scheduler import Request

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    scfg = ServeConfig(n_slots=4, rosa=True, rosa_backend="fused",
                       variation_seed=7, **serve_kw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = {k: v.name for k, v in sched.program.plan.mapping_plan().items()}
    lanes = {e.name: (e.k, e.n) for e in sched.program.trace.entries}
    print(f"  {arch} full width, {layers} of {get_config(arch).n_layers} "
          f"layers, {sched.bundle.n_params:,} params (f32), set-up "
          f"{setup_s:.1f} s; plan {plan}, projections {lanes}")
    if sched.bundle.n_params != n_params:
        raise AssertionError(f"{arch}: not the full-width model")
    if lanes != DENSE_PROJ[arch] or set(plan) != set(lanes):
        raise AssertionError(f"{arch}: unexpected plan {plan} / {lanes}")
    reqs = poisson_requests(6, 1.0, vocab=cfg.vocab, prompt_len=(4, 8),
                            gen_len=(2, 40), seed=0)
    if long_prompt:
        prompt = torch.randint(0, cfg.vocab, (long_prompt,),
                               generator=torch.Generator().manual_seed(16),
                               dtype=torch.int32).numpy()
        reqs.append(Request(rid=len(reqs), prompt=prompt, max_new_tokens=8))

    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    rep = sched.run(reqs)
    n = launch_counts()
    check_run(rep, reqs, cfg.vocab, f"{arch} serve")
    metrics = {m.name: m.value for m in report_metrics(rep)}
    routed = 2 * layers * (rep.decode_steps + rep.prefill_chunks)
    print(f"  served {rep.total_tokens} tokens in {rep.wall_s:.2f} s: "
          f"{rep.tokens_per_s:.2f} tok/s, {rep.ticks} ticks, "
          f"{rep.decode_steps} decode steps, {rep.prefill_chunks} prefill "
          f"chunks, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"  rosa_fused launches {n['rosa_fused']} (2 x {layers} x "
          f"(steps + chunks) = {routed}), osa_matmul {n['osa_matmul']}, "
          f"mrr_transfer {n['mrr_transfer']}, ssd_scan {n['ssd_scan']}")
    if n["rosa_fused"] != routed or n["osa_matmul"] or n["mrr_transfer"] \
            or n["ssd_scan"] or n["mrr_transfer_bwd"]:
        raise AssertionError(f"{arch}: the kernels launched are not the "
                             "routed projections")
    check_sequential(rep, cfg, scfg, sched.params, reqs, arch)
    out = dict(metrics, ticks=rep.ticks, decode_steps=rep.decode_steps,
               prefill_chunks=rep.prefill_chunks, n_params=n_params,
               layers=layers, plan=plan, setup_s=setup_s,
               rosa_fused_launches=n["rosa_fused"], routed=routed)

    # ---- fused vs the plain composed pipeline (phases 5 and 14) -----------
    if ref_check:
        ref = Scheduler(cfg, dataclasses.replace(scfg, rosa_backend="ref"),
                        params=sched.params, device=DEVICE)
        prompt = reqs[0].prompt
        lr, lf = prefill_logits(ref, prompt), prefill_logits(sched, prompt)
        if not bool(torch.isfinite(lf).all()) or lf.shape != (cfg.vocab,):
            raise AssertionError(f"{arch}: fused prefill logits not finite "
                                 "/ bad shape")
        rel = max_rel(lf, lr)
        floor = float_order_floor(lambda seed: k_permuted(cfg, ref, seed),
                                  prompt, lr)
        bound = 4 * floor + 1e-5
        # the argmax: the same, unless the ref's top two logits lie within
        # the bound of each other (a reordering of the sums can then swap
        # them); the fused pick must then be one of the ref's logits
        # within the bound of its top
        scale = float(lr.abs().max())
        top2 = torch.topk(lr, 2).values
        gap = float(top2[0] - top2[1]) / scale
        pick = int(lf.argmax())
        near = float(lr.max() - lr[pick]) / scale
        print(f"  fused vs ref prefill logits: max rel dev {rel:.3e} (bound "
              f"{bound:.3e}), argmax {pick} vs {int(lr.argmax())} (the "
              f"ref's top-two gap {gap:.3e}; the fused pick's ref logit "
              f"{near:.3e} below its top)")
        if rel > bound or (gap > bound and pick != int(lr.argmax())) \
                or near > bound:
            raise AssertionError(f"{arch}: fused and ref logits disagree "
                                 "beyond the bound")
        out.update(fused_vs_ref_logits_rel=rel,
                   ref_float_order_floor_rel=floor, ref_top2_gap_rel=gap,
                   fused_argmax_below_ref_top_rel=near)
        del ref

    # ---- gemma3: the window cuts the long prompt --------------------------
    # its last token's local layers see 1024 of the 1100 positions; with
    # the window lifted (thetas kept) they see all, and the logits move.
    # Attention alone decides this: the whole prompt prefills once each
    # way with the MLPs plain (cuBLAS), not through 18 optical chunks
    if long_prompt:
        tokens = torch.from_numpy(reqs[-1].prompt)[None].to(DEVICE)
        plain_cfg = dataclasses.replace(cfg, rosa_mlp=False)
        with torch.inference_mode():
            windowed = T.prefill(sched.params, plain_cfg,
                                 {"tokens": tokens})[0]
            lifted = T.prefill(sched.params, dataclasses.replace(
                plain_cfg, window=0), {"tokens": tokens})[0]
        moved = max_rel(lifted, windowed)
        print(f"  {long_prompt}-token prompt: lifting the {cfg.window}-token "
              f"window moves its prefill logits by {moved:.3e} of their max")
        if moved < 1e-3:
            raise AssertionError(f"{arch}: the sliding window cuts nothing")
        out.update(long_prompt=long_prompt, window_lift_logits_rel=moved)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out["peak_gib"] = peak
    print(f"  peak {peak:.1f} GiB over the model (limit {PEAK_GIB:.0f})")
    if peak >= PEAK_GIB:
        raise AssertionError(f"{arch}: peak {peak:.1f} GiB")
    del sched
    return out


def phi3v_batch(report: dict) -> None:
    """16(c), first half: phi-3-vision-4.2b through `--policy batch` with
    16 zero patch embeddings, greedy and at temperature 0.7."""
    import gc
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.models.module import map_tree

    arch, layers, n_params = PHI3V
    res = batch_run(arch, PHI3V_ARGS, "0.0")
    bundle, params, batch = res["bundle"], res["params"], res["batch"]
    cfg = bundle.cfg
    if bundle.n_params != n_params or cfg.n_layers != layers:
        raise AssertionError(f"not {arch} at full width and {layers} layers")
    lg = res["logits"]
    if lg.shape != (4, cfg.vocab) or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{arch}: prefill logits not finite / bad "
                             "shape")
    img = batch["patch_embeds"]
    lens = [t.shape[2] for t in res["cache"]["layers"]]
    want = PHI3V_PATCHES + 32 + 17
    print(f"  patch embeddings {tuple(img.shape)} {img.dtype}, zero: "
          f"{not bool(img.any())}; K/V lengths after pad_cache {lens} "
          f"({PHI3V_PATCHES} + 32 + 17 = {want})")
    if img.shape != (4, PHI3V_PATCHES, cfg.d_model) or bool(img.any()) \
            or lens != [want] * 2:
        raise AssertionError(f"{arch}: the patches or the cache lengths "
                             "are not the batch policy's")
    # non-zero patches must move the prefill logits
    g = torch.Generator(DEVICE).manual_seed(17)
    patches = torch.randn(img.shape, generator=g, device=DEVICE).to(
        torch.bfloat16)
    with torch.inference_mode():
        lp, _ = bundle.prefill(params, dict(batch, patch_embeds=patches))
    moved = max_rel(lp, lg)

    # ---- the card against the port's own CPU prefill (TF32 off) ----------
    # phase 15(b)'s rule at a cut depth (the first PHI3V_CPU_LAYERS
    # layers, with the random patches): 4x the card's float-order floor,
    # the hidden dimension of the params and of the patches permuted
    cut_cfg = dataclasses.replace(cfg, n_layers=PHI3V_CPU_LAYERS)
    cut_bundle = build_model(cut_cfg)
    cut = dict(params, layers=map_tree(lambda a: a[:PHI3V_CPU_LAYERS],
                                       params["layers"]))
    cut_batch = dict(batch, patch_embeds=patches)
    t0 = time.perf_counter()
    with torch.inference_mode():
        lcard, _ = cut_bundle.prefill(cut, cut_batch)
        lc, _ = cut_bundle.prefill(map_tree(lambda t: t.cpu(), cut),
                                   {k: v.cpu() for k, v in
                                    cut_batch.items()})
    cpu_s = time.perf_counter() - t0
    floor = 0.0
    for seed in (1, 2):
        params_p, perm = permuted_params(
            types.SimpleNamespace(bundle=cut_bundle, params=cut),
            {"embed": cfg.d_model}, seed)
        with torch.inference_mode():
            lperm, _ = cut_bundle.prefill(params_p, dict(
                cut_batch, patch_embeds=patches.index_select(
                    -1, perm["embed"])))
        dev = max_rel(lperm, lcard)
        floor = max(floor, dev)
        print(f"  card vs card with permuted reductions (seed {seed}, "
              f"{PHI3V_CPU_LAYERS} layers): max rel dev {dev:.3e}")
        del params_p, lperm
        torch.cuda.empty_cache()
    rel = max_rel(lcard.cpu(), lc)
    bound = 4 * floor + 1e-5
    same = torch.equal(lcard.argmax(-1).cpu(), lc.argmax(-1))
    print(f"  card vs CPU prefill logits at {PHI3V_CPU_LAYERS} of {layers} "
          f"layers: max rel dev {rel:.3e} (bound {bound:.3e}), argmax equal "
          f"{same} (CPU prefill {cpu_s:.1f} s); non-zero patches move the "
          f"{layers}-layer logits by {moved:.3e} of their max")
    if rel > bound or not same:
        raise AssertionError(f"{arch}: card and CPU prefills disagree "
                             "beyond the float-order bound")
    if moved < 1e-3:
        raise AssertionError(f"{arch}: the model does not read the patches")
    greedy = res["tokens"]
    out = {"n_params": n_params, "card_vs_cpu_logits_rel": rel,
           "card_vs_cpu_layers": PHI3V_CPU_LAYERS,
           "card_float_order_floor_rel": floor, "patch_logits_rel": moved,
           "cache_lengths": lens,
           "greedy": {k: res[k] for k in ("tok_s", "prefill_s", "decode_s",
                                          "wall_s", "peak_gib")}}
    del res, bundle, params, batch, cut, lg, lp, lcard, lc
    gc.collect()
    torch.cuda.empty_cache()

    hot = batch_run(arch, PHI3V_ARGS, "0.7")
    if not torch.equal(hot["tokens"][:, 0], greedy[:, 0]):
        raise AssertionError(f"{arch}: the first token (the prefill's "
                             "argmax) differs between the two runs")
    out["sampled"] = {k: hot[k] for k in ("tok_s", "prefill_s", "decode_s",
                                          "wall_s", "peak_gib")}
    report["phi3v_batch"] = out
    peak = max(out["greedy"]["peak_gib"], out["sampled"]["peak_gib"])
    if peak >= PEAK_GIB:
        raise AssertionError(f"{arch}: peak {peak:.1f} GiB")
    del hot
    gc.collect()
    torch.cuda.empty_cache()


def dense_phase(report: dict) -> int:
    """Phase 16: gemma3-12b, then deepseek-67b and mistral-large-123b, then
    phi-3-vision-4.2b, each freed before the next.  Returns the main
    paths' rosa_fused launches."""
    import gc
    import torch
    rows = {}

    def serve(arch, layers, n_params, **kw):
        rows[arch] = dense_serve(arch, layers, n_params, **kw)
        gc.collect()
        torch.cuda.empty_cache()

    print("phase 16(a): gemma3-12b at full width and depth")
    serve(*GEMMA3, serve_kw=GEMMA_SERVE, long_prompt=LONG_PROMPT)
    print("phase 16(b): deepseek-67b and mistral-large-123b at full width")
    for model in DENSE_CUT:
        serve(*model, serve_kw=PHASE3_SERVE)
    print("phase 16(c): phi-3-vision-4.2b at full width and depth")
    phi3v_batch(report)
    serve(*PHI3V, serve_kw=PHASE3_SERVE, ref_check=False)
    report["dense_serve"] = rows
    return sum(r["rosa_fused_launches"] for r in rows.values())


# ---------------------------------------------------------------------------
# Phase 17: the LM training path
# ---------------------------------------------------------------------------
# qwen3-32b at full width, depth cut to 4 of 64 layers: params, grads and
# AdamW's two float32 moments are 4 x 14.0 GB
TRAIN = ("qwen3-32b", 2, 2_531_026_432)   # cut from 4 layers (phase 22)
TRAIN_CLI = ["--arch", "qwen3-32b", "--n-layers", "2", "--steps", "10",
             "--batch", "8", "--seq", "256", "--warmup", "2",
             "--ckpt-every", "100", "--log-every", "1"]
OPT_STEPS = 2                     # 17(b)'s optical train steps
TRAIN_CPU = (1, 2_043_428_096)    # 17(c): layers, params
TRAIN_CPU_BATCH = (1, 64)
RESUME_STEPS = (2, 2)             # 17(d): steps before and after the save


def train_opt_cfg():
    """17(a)'s optimizer: the CLI's cosine schedule for its flags."""
    from repro_torch.optim import AdamWConfig, cosine_schedule
    return AdamWConfig(lr=cosine_schedule(3e-4, 2, 10))


def train_cli_phase(report: dict) -> dict:
    """17(a): `python -m repro_torch.launch.train` as the reference's CLI
    configures it (plain MLPs), in-process: 10 steps at batch 8 x 256."""
    import gc
    import torch
    from repro_torch.launch import train

    args = train.build_parser().parse_args(TRAIN_CLI + [
        "--device", DEVICE, "--ckpt-dir", str(ROOT / "build" / "ckpt-17a")])
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    res = train.run(args)
    n = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = res["history"]
    if res["bundle"].n_params != TRAIN[2]:
        raise AssertionError("17(a): not qwen3-32b at full width")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist) or len(hist) != args.steps:
        raise AssertionError("17(a): a loss or |g| is not finite")
    if any(n.values()):
        raise AssertionError(f"17(a): plain MLPs launched kernels {n}")
    if peak >= PEAK_GIB:
        raise AssertionError(f"17(a): peak {peak:.1f} GiB")
    steady = [h["wall_s"] for h in hist[1:]]
    tokens = args.batch * args.seq
    tok_s = tokens * len(steady) / sum(steady)
    for h in hist:
        print(f"  step {h['step']}: loss {h['loss']:.6f}  |g| "
              f"{h['grad_norm']:.4f}  lr {h['lr']:.3e}  wall "
              f"{h['wall_s']:.3f} s")
    print(f"  {tok_s:.1f} tokens/s over steps 1-{len(hist) - 1} (median "
          f"step {statistics.median(steady):.3f} s), peak {peak:.1f} GiB, "
          f"no kernel launched")
    out = {"history": hist, "tokens_per_s": tok_s, "peak_gib": peak,
           "median_step_s": statistics.median(steady),
           "n_params": res["bundle"].n_params}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def leaf_rel(got: dict, want: dict) -> dict:
    """{path: max|got - want| / max|want|} over two trees' leaves."""
    from repro_torch.models.module import leaves
    w = dict(leaves(want))
    return {"/".join(p): max_rel(g, w[p]) for p, g in leaves(got)}


def optical_train_phase(report: dict) -> int:
    """17(b): `make_train_step` on 17(a)'s model with `rosa_mlp` and the
    "fused" backend (IDEAL noise, WS, no chip), 2 steps on the CLI's
    batches; then the "ref" backend on the same steps.  Returns the main
    path's rosa_fused launches."""
    import gc
    import torch
    from repro_torch import rosa
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import (init_opt_state, loss_and_grads,
                                          make_train_step)
    from repro_torch.models.model import build_model
    from repro_torch.rosa.backends import RosaConfig

    arch, layers, n_params = TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              rosa_mlp=True)
    bundle = build_model(cfg)
    if bundle.n_params != n_params:
        raise AssertionError("17(b): not qwen3-32b at full width")
    b, s = (int(TRAIN_CLI[TRAIN_CLI.index(f) + 1])
            for f in ("--batch", "--seq"))
    pipe = TokenPipeline(cfg.vocab, s, b, seed=0)
    batches = [pipe.batch(i, DEVICE) for i in range(OPT_STEPS)]
    engines = {be: rosa.Engine.from_config(RosaConfig(backend=be))
               for be in ("fused", "ref")}
    g = torch.Generator().manual_seed(1)
    perm_sets = [{"mlp/wi": torch.randperm(cfg.d_model, generator=g)
                  .to(DEVICE),
                  "mlp/wo": torch.randperm(cfg.d_ff, generator=g)
                  .to(DEVICE)} for _ in (1, 2)]

    def init():
        return bundle.init(torch.Generator(DEVICE).manual_seed(0),
                           device=DEVICE)

    def train(engine, keep=None) -> list:
        params = init()
        opt = init_opt_state(params)
        step = make_train_step(bundle, train_opt_cfg())
        out = []
        with rosa.engine_context(engine):
            for batch in batches:
                params, opt, m = step(params, opt, batch)
                out.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        del opt
        if keep is not None:
            keep(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return out

    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    t0 = time.perf_counter()
    # the params after the steps: 22(a)'s one-process optical side
    fused = train(engines["fused"],
                  keep=lambda p: RT_SIDE.update(optical=rt_share(p)))
    wall = time.perf_counter() - t0
    n = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # two MLP projections a layer, each once in the forward and once more
    # when remat "full" recomputes the block in the backward
    want = 2 * 2 * layers * OPT_STEPS
    print(f"  fused: {OPT_STEPS} steps in {wall:.2f} s, losses "
          f"{[round(l, 6) for l, _ in fused]}, |g| "
          f"{[round(x, 4) for _, x in fused]}; rosa_fused launches "
          f"{n['rosa_fused']} (2 projections x (forward + recompute) x "
          f"{layers} layers x {OPT_STEPS} steps = {want}); peak {peak:.1f} "
          "GiB")
    if n["rosa_fused"] != want or any(v for k, v in n.items()
                                      if k != "rosa_fused"):
        raise AssertionError(f"17(b): launches {n}, wanted {want} of "
                             "rosa_fused and nothing else")
    if peak >= PEAK_GIB:
        raise AssertionError(f"17(b): peak {peak:.1f} GiB")
    reset_launches()
    kept: dict = {}
    ref = train(engines["ref"], keep=lambda p: kept.update(ref=p))
    if any(launch_counts().values()):
        raise AssertionError("17(b): the ref backend launched a kernel")
    # ---- fused vs ref: 4x the float order floor (phase 14's rule) --------
    # Both backends quantize alike and differ only in the order of the
    # optical products' sums, so the floor permutes only their reduction
    # axes ("ref" again with each product's K permuted).
    # and each run's params after the steps against the ref's: 22(a)'s
    # floors per leaf
    param_floor: dict = {}

    def floor_of(p):
        for k, d in leaf_rel(p, kept["ref"]).items():
            param_floor[k] = max(param_floor.get(k, 0.0), d)
    perm = [train(k_permuted_engine(engines["ref"], ps), keep=floor_of)
            for ps in perm_sets]
    del kept["ref"]
    torch.cuda.empty_cache()
    RT_SIDE["floor"] = {
        "loss": [max(abs(p[i][0] - ref[i][0]) / abs(ref[i][0])
                     for p in perm) for i in range(OPT_STEPS)],
        "gn": [max(abs(p[i][1] - ref[i][1]) / abs(ref[i][1])
                   for p in perm) for i in range(OPT_STEPS)],
        "params": param_floor}
    RT_SIDE["optical_hist"] = fused
    loss_dev, loss_floor = [], []
    for i in range(OPT_STEPS):
        lr_ = ref[i][0]
        loss_dev.append(abs(fused[i][0] - lr_) / abs(lr_))
        loss_floor.append(max(abs(p[i][0] - lr_) / abs(lr_) for p in perm))
    print(f"  ref: losses {[round(l, 6) for l, _ in ref]}, no launch; "
          f"fused vs ref loss rel dev {[f'{d:.2e}' for d in loss_dev]}, "
          f"floor {[f'{f:.2e}' for f in loss_floor]}")
    if any(d > 4 * f + 1e-6 for d, f in zip(loss_dev, loss_floor)):
        raise AssertionError("17(b): fused and ref losses disagree beyond "
                             "4x the float-order floor")
    # gradients of the first step, leaf by leaf (no optimizer state held)
    params = init()

    def grads_of(engine):
        with rosa.engine_context(engine):
            return loss_and_grads(bundle, params, batches[0])[1]

    g_ref = grads_of(engines["ref"])
    dev = leaf_rel(grads_of(engines["fused"]), g_ref)
    floor = {k: 0.0 for k in dev}
    for ps in perm_sets:
        for k, d in leaf_rel(grads_of(k_permuted_engine(engines["ref"], ps)),
                             g_ref).items():
            floor[k] = max(floor[k], d)
        torch.cuda.empty_cache()
    worst = max(dev, key=lambda k: dev[k] / (4 * floor[k] + 1e-6))
    print(f"  step-1 gradients fused vs ref: the leaf nearest its bound is "
          f"{worst} at {dev[worst]:.3e} (floor {floor[worst]:.3e}); largest "
          f"deviation {max(dev.values()):.3e}")
    bad = [k for k, d in dev.items() if d > 4 * floor[k] + 1e-6]
    if bad:
        raise AssertionError(f"17(b): gradient leaves beyond 4x their "
                             f"float-order floor: {bad}")
    report["train_optical"] = {
        "launches": n["rosa_fused"], "wanted": want, "wall_s": wall,
        "peak_gib": peak, "fused": fused, "ref": ref,
        "loss_rel_dev": loss_dev, "loss_floor": loss_floor,
        "grad_rel_dev": dev, "grad_floor": floor}
    del params, g_ref
    gc.collect()
    torch.cuda.empty_cache()
    return n["rosa_fused"]


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def card_vs_cpu_grads(bundle, params, batch, sizes: dict, what: str,
                      plain=None):
    """One train step's loss, |g| and gradients on the card and on the
    CPU from the same params: each within 4x the card's float-order floor
    (the axes `sizes` names permuted in the params, two seeds; 1e-6 of
    slack for a floor of 0).  `plain`, where given, is a context manager
    that routes the step's kernels to their plain versions; the floor is
    then the larger of the permutations' and the distance of the card's
    float32 step through the plain versions from its float64 step, a
    floor that runs none of the kernels under test.  Returns the card's
    loss and grads, the params on the host, the deviations, the floors
    and the CPU step's seconds."""
    import gc
    import types as _types
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.module import leaves, map_tree
    from repro_torch.optim import global_norm

    loss, grads = loss_and_grads(bundle, params, batch)
    gnorm = global_norm(grads)
    floor = {"loss": 0.0, "grad_norm": 0.0}
    axes = dict(leaves(map_tree(lambda d: d.axes, bundle.skeleton)))
    for seed in (1, 2):
        pp, perm = permuted_params(
            _types.SimpleNamespace(bundle=bundle, params=params), sizes, seed)
        lp, gp = loss_and_grads(bundle, pp, batch)
        floor["loss"] = max(floor["loss"], max_rel(lp, loss))
        floor["grad_norm"] = max(floor["grad_norm"],
                                 max_rel(global_norm(gp), gnorm))
        gp_by_path = dict(leaves(gp))
        for path, t in leaves(grads):
            for ax, name in enumerate(axes[path]):
                if name in perm:
                    t = t.index_select(ax, perm[name])
            k = "/".join(path)
            floor[k] = max(floor.get(k, 0.0), max_rel(gp_by_path[path], t))
        del pp, lp, gp, gp_by_path
        torch.cuda.empty_cache()
    if plain is not None:
        with plain():
            l32, g32 = loss_and_grads(bundle, params, batch)
            l64, g64 = loss_and_grads(
                bundle, map_tree(torch.Tensor.double, params), batch)
        f64 = {"loss": max_rel(l32, l64),
               "grad_norm": max_rel(global_norm(g32), global_norm(g64))}
        f64.update(leaf_rel(g32, g64))
        for k, v in f64.items():
            floor[k] = max(floor[k], v)
        del l32, g32, l64, g64
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params_c = map_tree(lambda t: t.cpu(), params)
    lc, gc_ = loss_and_grads(bundle, params_c,
                             {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    dev = {"loss": max_rel(lc, loss.cpu()),
           "grad_norm": max_rel(global_norm(gc_), gnorm.cpu())}
    dev.update(leaf_rel(gc_, map_tree(lambda t: t.cpu(), grads)))
    del gc_
    gc.collect()
    bad = [k for k in dev if dev[k] > 4 * floor[k] + 1e-6]
    worst = max(dev, key=lambda k: dev[k] / (4 * floor[k] + 1e-6))
    print(f"  card vs CPU (CPU step {cpu_s:.1f} s): loss {dev['loss']:.2e} "
          f"(floor {floor['loss']:.2e}), |g| {dev['grad_norm']:.2e} (floor "
          f"{floor['grad_norm']:.2e}); nearest its bound: {worst} "
          f"{dev[worst]:.2e} (floor {floor[worst]:.2e})")
    if bad:
        raise AssertionError(f"{what}: card and CPU beyond 4x the card's "
                             f"float-order floor at {bad}")
    return loss, grads, params_c, dev, floor, cpu_s


def card_vs_cpu_phase(report: dict) -> None:
    """17(c): one train step's loss, |g| and gradients of qwen3-32b at
    full width and 1 layer (batch 1 x 64) on the card and on the CPU from
    the same params, within 4x the card's float-order floor (the hidden
    and MLP axes of the params permuted, as phases 5 and 15(b) measure
    it); then one AdamW update of the card's gradients on each side,
    every leaf within 1e-6 of its max."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.models.module import map_tree
    from repro_torch.optim import adamw_init, adamw_update

    layers, n_params = TRAIN_CPU
    cfg = dataclasses.replace(get_config(TRAIN[0]), n_layers=layers)
    bundle = build_model(cfg)
    if bundle.n_params != n_params:
        raise AssertionError("17(c): not qwen3-32b at full width")
    # host: the params, the CPU's grads, the card's grads and the two
    # moments, float32
    need = 5 * 4 * n_params / 2**30 + 4
    avail = mem_available_gib()
    print(f"  host memory available {avail:.1f} GiB, needed {need:.1f}")
    if avail < need:
        raise AssertionError(f"17(c): {avail:.1f} GiB of host memory "
                             f"available, {need:.1f} needed")
    params = bundle.init(torch.Generator(DEVICE).manual_seed(0),
                         device=DEVICE)
    b, s = TRAIN_CPU_BATCH
    batch = TokenPipeline(cfg.vocab, s, b, seed=0).batch(0, DEVICE)
    _, grads, params_c, dev, floor, cpu_s = card_vs_cpu_grads(
        bundle, params, batch, {"embed": cfg.d_model, "mlp": cfg.d_ff},
        "17(c)")
    # one AdamW update of the same (the card's) gradients on each side
    cfg_opt = train_opt_cfg()
    st = adamw_init(params)
    adamw_update(params, grads, st, cfg_opt)
    grads_c = map_tree(lambda t: t.cpu(), grads)
    del grads
    torch.cuda.empty_cache()
    st_c = adamw_init(params_c)
    adamw_update(params_c, grads_c, st_c, cfg_opt)
    upd = leaf_rel({"params": map_tree(lambda t: t.cpu(), params),
                    "mu": map_tree(lambda t: t.cpu(), st["mu"]),
                    "nu": map_tree(lambda t: t.cpu(), st["nu"])},
                   {"params": params_c, "mu": st_c["mu"], "nu": st_c["nu"]})
    worst_u = max(upd.values())
    print(f"  one AdamW update on the card vs the CPU: largest leaf "
          f"deviation {worst_u:.2e} (bound 1e-6)")
    if worst_u > 1e-6:
        raise AssertionError("17(c): the AdamW updates disagree")
    report["train_card_vs_cpu"] = {"dev": dev, "floor": floor,
                                   "cpu_step_s": cpu_s,
                                   "adamw_max_rel": worst_u}
    del params, params_c, grads_c, st, st_c
    gc.collect()
    torch.cuda.empty_cache()


def resume_phase(report: dict) -> None:
    """17(d): qwen3-32b-smoke on the card, 4 steps straight against 2
    steps, a checkpoint saved and restored, and 2 more: params and
    optimizer state equal bit for bit."""
    import shutil
    import torch
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_smoke
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.models.module import leaves, map_tree
    from repro_torch.optim import AdamWConfig, cosine_schedule

    cfg = get_smoke(TRAIN[0])
    bundle = build_model(cfg)
    pipe = TokenPipeline(cfg.vocab, 32, 2, seed=0)
    first, then = RESUME_STEPS
    step = make_train_step(bundle, AdamWConfig(
        lr=cosine_schedule(1e-3, 1, first + then)))

    def fresh():
        p = bundle.init(torch.Generator(DEVICE).manual_seed(0),
                        device=DEVICE)
        return p, init_opt_state(p)

    def run(p, o, steps):
        for i in steps:
            p, o, _ = step(p, o, pipe.batch(i, DEVICE))
        return p, o

    straight = dict(zip(("params", "opt"),
                        run(*fresh(), range(first + then))))
    p, o = run(*fresh(), range(first))
    root = ROOT / "build" / "ckpt-17d"
    shutil.rmtree(root, ignore_errors=True)
    save(str(root), first, {"params": p, "opt": o}, meta={"arch": cfg.name})
    like = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"),
                    {"params": p, "opt": o})
    back = restore(str(root), first, like, device=DEVICE)
    p, o = run(back["params"], back["opt"], range(first, first + then))
    resumed = {"params": p, "opt": o}
    shutil.rmtree(root, ignore_errors=True)
    differ = [("/".join(k), a.dtype) for (k, a), (_, b) in
              zip(leaves(resumed), leaves(straight), strict=True)
              if a.dtype != b.dtype or not torch.equal(a, b)]
    n = sum(1 for _ in leaves(resumed))
    print(f"  {first} + save/restore + {then} steps against {first + then} "
          f"straight: {n - len(differ)} of {n} leaves equal bit for bit "
          f"(step counter {int(o['adam']['step'])})")
    if differ:
        raise AssertionError(f"17(d): resumed state differs at {differ}")
    report["train_resume"] = {"leaves": n, "equal": n - len(differ)}


def train_phase(report: dict) -> int:
    """Phase 17; returns the main path's rosa_fused launches (17(b))."""
    print(f"phase 17(a): python -m repro_torch.launch.train, {TRAIN[0]} "
          f"full width, {TRAIN[1]} layers")
    report["train_cli"] = train_cli_phase(report)
    print("phase 17(b): the optical train step (rosa_mlp, fused vs ref)")
    n = optical_train_phase(report)
    print("phase 17(c): a full-width 1-layer train step, card vs CPU")
    card_vs_cpu_phase(report)
    print("phase 17(d): resume on the card")
    resume_phase(report)
    return n


# ---------------------------------------------------------------------------
# Phase 18: observability and the static checks at qwen3-32b's full width
# ---------------------------------------------------------------------------
SERVE_CLI = ["--arch", "qwen3-32b", "--n-layers", "4", "--rosa",
             "--rosa-backend", "fused", "--variation-seed", "7",
             "--requests", "6"]
ENERGY_J_REL = 1e-12     # a sum of n equal steps against n times the step


def run_module(*args: str, what: str) -> str:
    """`python -m <args>` in a subprocess from this checkout; fails on a
    non-zero exit.  Returns its standard output."""
    import os
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if proc.returncode != 0:
        raise AssertionError(f"18: {what} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def trace_counts(events: list) -> dict:
    """Spans by name, request events by (phase, name) per id, and each
    counter track's values in order."""
    spans: dict = {}
    requests: dict = {}
    tracks: dict = {}
    for e in events:
        ph = e.get("ph")
        if ph == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
        elif ph in ("b", "n", "e"):
            requests.setdefault(e["id"], []).append((ph, e["name"]))
        elif ph == "C":
            tracks.setdefault(e["name"], []).append(e["args"])
    return {"spans": spans, "requests": requests, "tracks": tracks}


def check_traced_run(rep, reqs, counts: dict, reg, step_j: float,
                     what: str) -> float:
    """The trace of one serving run against its report: one tick, prefill
    and decode span per tick, chunk and step; one b, first_token and e per
    request; every request completed; the energy.decode track the decode
    steps times the priced step.  Returns its final J."""
    spans = counts["spans"]
    want = {"serve.tick": rep.ticks, "serve.prefill_chunk":
            rep.prefill_chunks, "serve.decode_step": rep.decode_steps}
    got = {k: spans.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{what}: spans {got} != report {want}")
    for r in reqs:
        evs = counts["requests"].get(str(r.rid), [])
        if [evs.count(k) for k in (("b", "request"), ("n", "first_token"),
                                   ("e", "request"))] != [1, 1, 1]:
            raise AssertionError(f"{what}: request {r.rid} events {evs}")
    done = reg.counter("serve.requests_completed").value
    if done != len(reqs):
        raise AssertionError(f"{what}: serve.requests_completed {done}")
    track = counts["tracks"].get("energy.decode")
    if not track:
        raise AssertionError(f"{what}: no energy.decode track")
    final_j = track[-1]["J"]
    want_j = rep.decode_steps * step_j
    if not (final_j > 0 and abs(final_j - want_j) <= ENERGY_J_REL * want_j):
        raise AssertionError(f"{what}: energy.decode {final_j!r} J != "
                             f"{rep.decode_steps} x {step_j!r} J")
    return final_j


def obs_phase(report: dict) -> int:
    """18: phase 3's serving run untraced, then traced (tracer, a fresh
    registry, the kernel-build hooks); the summarizer, the `--trace` CLI,
    the analysis CLI and `rosa.compile(verify="error")` on the card.
    Returns the phase's rosa_fused launches."""
    import gc
    import io
    import torch
    from repro_torch import obs, rosa
    from repro_torch.analysis import cli as analysis_cli
    from repro_torch.core.constants import ROSA_OPTIMAL
    from repro_torch.models.model import build_model
    from repro_torch.serve import Scheduler, serving_model_config
    from repro_torch.serve.metrics import abstract_decode_batch

    cfg, scfg, reqs = serve_setup()
    sched = Scheduler(cfg, scfg, init_seed=0, device=DEVICE)

    # ---- the main path, untraced then traced: counts from 0 each ---------
    reset_launches()
    rep0 = sched.run(reqs)
    n0 = launch_counts()["rosa_fused"]
    tracer, reg = obs.Tracer(), obs.MetricsRegistry()
    obs.install_kernel_hooks()
    reset_launches()
    with obs.tracing(tracer), obs.swap_registry(reg):
        rep1 = sched.run(reqs)
    n1 = launch_counts()["rosa_fused"]

    routed = 2 * cfg.n_layers * (rep1.decode_steps + rep1.prefill_chunks)
    if {r: c.tokens for r, c in rep0.completions.items()} != \
            {r: c.tokens for r, c in rep1.completions.items()}:
        raise AssertionError("18: traced tokens differ from untraced")
    if not n0 == n1 == routed:
        raise AssertionError(f"18: rosa_fused launches {n0} untraced, {n1} "
                             f"traced, {routed} routed")
    step_j = sched.engine.ledger.breakdown(ROSA_OPTIMAL, batch=1,
                                           tag="decode").energy
    path = ROOT / "chiprun_out" / "phase18_serve.trace.json"
    path.parent.mkdir(exist_ok=True)
    tracer.save(path)
    counts = trace_counts(json.loads(path.read_text())["traceEvents"])
    final_j = check_traced_run(rep1, reqs, counts, reg, step_j, "18")
    summary = run_module("repro_torch.obs", "summarize", str(path),
                         what="python -m repro_torch.obs summarize")
    print(f"  untraced {rep0.tokens_per_s:.2f} tok/s, traced "
          f"{rep1.tokens_per_s:.2f} tok/s ({rep1.total_tokens} tokens, "
          f"{rep1.ticks} ticks); rosa_fused {n0} / {n1} launches; trace "
          f"{len(tracer)} events, {path.stat().st_size} bytes; "
          f"energy.decode {final_j!r} J = {rep1.decode_steps} x "
          f"{step_j!r} J")
    print("  summarizer: " + summary.splitlines()[0])
    del sched
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the CLIs at the same width ---------------------------------------
    cli_path = path.with_name("phase18_cli.trace.json")
    t0 = time.perf_counter()
    out = run_module("repro_torch.launch.serve", *SERVE_CLI, "--device",
                     DEVICE, "--trace", str(cli_path),
                     what="launch.serve --trace")
    cli_s = time.perf_counter() - t0
    cli = trace_counts(json.loads(cli_path.read_text())["traceEvents"])
    begins = sum(evs.count(("b", "request"))
                 for evs in cli["requests"].values())
    if not cli["spans"].get("serve.tick") or begins != 6 \
            or "energy.decode" not in cli["tracks"]:
        raise AssertionError("18: the --trace CLI's trace lacks serve.tick, "
                             "the request events or energy.decode")
    print(f"  launch.serve --trace: {cli['spans']['serve.tick']} ticks, "
          f"{begins} requests, {cli_path.stat().st_size} bytes, "
          f"{cli_s:.1f} s; " + next(line for line in out.splitlines()
                                    if line.startswith("trace:")))
    # the analysis CLI in this process: the card is initialized already
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = analysis_cli.main(["--device", DEVICE])
    analysis_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"18: python -m repro_torch.analysis exited "
                             f"{rc}:\n{out.getvalue()[-3000:]}")
    print(f"  analysis: {out.getvalue().splitlines()[-1]} "
          f"({analysis_s:.1f} s)")

    # ---- rosa.compile(verify="error") on phase 13's serving program ------
    bundle = build_model(serving_model_config(cfg, rosa=True))
    base = rosa.RosaConfig(backend="fused", act_per_vector=True)
    t0 = time.perf_counter()
    prog = rosa.compile(
        lambda eng, p, b: bundle.decode_step(p, b),
        rosa.Engine.from_config(base),
        (bundle.abstract(torch.float32),
         abstract_decode_batch(bundle.cfg, scfg)),
        autotune=rosa.AutotuneConfig(ope=ROSA_OPTIMAL, batch=1),
        device=DEVICE, verify="error")
    verify_s = time.perf_counter() - t0
    if not isinstance(prog, rosa.Program):
        raise AssertionError("18: verify='error' returned no Program")
    plan = {k: v.name for k, v in prog.plan.mapping_plan().items()}
    print(f"  rosa.compile(verify='error'): a Program, plan {plan} "
          f"({verify_s:.1f} s)")
    del prog, bundle
    gc.collect()
    torch.cuda.empty_cache()
    report["obs"] = {
        "untraced_tok_s": rep0.tokens_per_s, "traced_tok_s":
        rep1.tokens_per_s, "untraced_wall_s": rep0.wall_s,
        "traced_wall_s": rep1.wall_s, "trace_events": len(tracer),
        "trace_bytes": path.stat().st_size, "spans": counts["spans"],
        "energy_decode_j": final_j, "decode_step_j": step_j,
        "rosa_fused": [n0, n1], "registry": reg.snapshot(),
        "cli_s": cli_s, "analysis_s": analysis_s, "verify_s": verify_s}
    return n0 + n1


# ---------------------------------------------------------------------------
# Phase 19: training the ssm and hybrid families
# ---------------------------------------------------------------------------
# ssd_scan backward cases (B, L, H, P, G, S, chunk): mamba2-1.3b's and
# zamba2-1.2b's train shapes (8 x 256), one step, a chunk and one, a
# ragged 700 at G 2 and B 2, G = H
SSD_BWD_CASES = [(8, 256, 64, 64, 1, 128, 128), (8, 256, 64, 64, 1, 64, 128),
                 (1, 1, 64, 64, 1, 128, 128), (1, 129, 64, 64, 1, 128, 128),
                 (2, 700, 64, 64, 2, 128, 128),
                 (1, 256, 64, 64, 64, 128, 128),
                 (4, 256, 32, 64, 1, 128, 128)]   # a (2, 2) rank's (22(b))
SSD_BWD_SERVED = (8, 256, 1, 128)          # (B, L, G, S) of the train step
SSD_BWD_L1_SEEDS = 16                      # 19(a): L 1's further inputs
SSD_BWD_L1_ORDERS = 4                      # and the head orders of its floor
SSM_TRAIN = (("mamba2-1.3b", MAMBA_PARAMS), ("zamba2-1.2b", ZAMBA_PARAMS))
SSM_TRAIN_CLI = ["--steps", "4", "--batch", "8", "--seq", "256",
                 "--warmup", "2", "--ckpt-every", "100", "--log-every", "1"]
SSM_CPU = ("mamba2-1.3b", 1)               # 19(d): arch, layers
SSM_CPU_BATCH = (1, 64)


def ssd_bwd_work(bsz, l, h, p, g, s, q) -> tuple[int, int, int]:
    """(bytes, product operations, other operations) of one scan's
    backward given the forward's saved l, C B^T and incoming states: the
    bytes of x, b, c, dy, dstate, l, C B^T on each chunk's causal triangle
    and the incoming states in, dx, dloga, db, dc out; the float32
    operations the chunked formulas need on these inputs
    (ref.ssd_chunked_backward), term by term below, the matrix products
    apart: the triangle's products once per head, the state's from the
    second chunk on (the first state is zero, and the first chunk's dS_in
    is no output); per group the heads' dB and dC summed."""
    r = h // g
    nc = -(-l // q)
    tri_all = sum(n * (n + 1) // 2 for n in (min(q, l - lo)
                                              for lo in range(0, l, q)))
    nbytes = 4 * (2 * bsz * l * h * p + 2 * bsz * l * g * s
                  + bsz * h * s * p + bsz * h * nc * q + bsz * g * tri_all
                  + bsz * h * nc * s * p
                  + bsz * l * h * p + bsz * l * h + 2 * bsz * l * g * s)
    prods = others = 0
    for lo in range(0, l, q):
        n = min(q, l - lo)
        tri = n * (n + 1) // 2
        prod = (2 * tri * p              # dY X^T
                + 2 * tri * p            # M^T dY
                + 4 * tri * s            # D^T C, D B
                + 4 * n * s * p)         # B G, X G^T
        other = (2 * tri                 # the decay: a difference, an exp
                 + 5 * tri               # D, M, A; A's row and column sums
                 + 2 * n * p + 2 * n * s     # the carry scaled, added
                 + 3 * n * p             # the carry's dot products
                 + 3 * n)                # dl's terms, the reverse cumsum
        if lo:                           # an incoming state
            prod += (2 * n * s * p       # dY S_in^T into dC
                     + 2 * n * s * p)    # C^T diag(exp l) dY
            other += (2 * n * s          # dY S_in^T scaled, added
                      + 3 * n * s        # its dot products with C
                      + n * s            # C . exp l
                      + 4 * s * p)       # G's decay, <S_in, G>
        prods += bsz * h * prod
        others += bsz * h * other + bsz * g * (r - 1) * 2 * n * s
    return nbytes, prods, others


def ssd_bwd_bound(bsz, l, h, p, g, s, q) -> tuple[float, str]:
    """Least time of one scan's backward on the CUDA cores: its bytes
    (`ssd_bwd_work`) against all its operations at the float32 rate."""
    nbytes, prods, others = ssd_bwd_work(bsz, l, h, p, g, s, q)
    return bound_ms(nbytes, prods + others)


def ssd_bwd_tc_bound(bsz, l, h, p, g, s, q) -> tuple[float, str]:
    """Least time of the same work on the route the kernel takes: the
    matrix products in 3xTF32 (three TF32 products each) at the dense
    TF32 rate plus the other operations at the float32 rate, against the
    bytes."""
    nbytes, prods, others = ssd_bwd_work(bsz, l, h, p, g, s, q)
    tb = nbytes / HBM_BYTES_PER_S
    tf = 3 * prods / TF32_FLOPS + others / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def ssd_bwd_phase(report: dict) -> dict:
    """19(a): the ssd_scan backward kernel against the float64 plain
    backward on the same CUDA tensors: each of dx, dloga, db, dc within 4x
    the float32 plain backward's own distance from float64 (plus 1e-6 of
    its max: at L 1 d loga is exactly 0 on every path) and within 1e-4 of
    its max; every value finite and two launches equal bit for bit.  The
    cotangents are N(0, 1) with a non-zero dstate; at the train shape a
    None dstate must give the zero dstate's bits; L 1 again on
    `SSD_BWD_L1_SEEDS` seeds under the same gates, its floor the largest
    over `SSD_BWD_L1_ORDERS` orders of the heads.
    Times as phase 6, the
    bound of the kernel's route (`ssd_bwd_tc_bound`, 3xTF32) as
    `bound_ms` and the float32 one (`ssd_bwd_bound`) as `f32_bound_ms`,
    and each of the four launches' kernel-only time
    alone (`ops.backward_stages`) on the workspace a whole backward
    filled."""
    import torch
    from repro_torch.kernels.ssd_scan import ops

    lib = ops._lib()
    smem = {n: lib.ssd_scan_backward_smem_bytes(i)
            for i, n in enumerate(ops.BWD_NAMES)}
    if smem != ops.SMEM_BWD:
        raise AssertionError(f"ssd_scan_bwd: the kernels' shared memory "
                             f"{smem} disagrees with the plan's")
    report["ssd_scan_bwd_occupancy"] = ops.occupancy_backward()
    print(f"  resident blocks per SM: {report['ssd_scan_bwd_occupancy']}")
    gen = torch.Generator(DEVICE).manual_seed(19)
    rows, served, err = [], None, 0.0
    for bsz, l, h, p, g, s, q in SSD_BWD_CASES:
        x, loga, b, c = ssd_inputs(bsz, l, h, p, g, s, gen)
        dy = torch.randn(bsz, l, h, p, device=DEVICE, generator=gen)
        ds = torch.randn(bsz, h, s, p, device=DEVICE, generator=gen)
        _, _, ws = ops._launch(x, loga, b, c, q)

        def run(dstate=ds):
            return ops.launch_backward(x, b, c, dy, dstate, ws, q)
        what = f"ssd_scan_bwd B{bsz} L{l} H{h} P{p} G{g} S{s} Q{q}"
        row = {"case": what, "B": bsz, "L": l, "H": h, "P": p, "G": g,
               "S": s, "Q": q}
        e = 0.0
        for name, dev, floor, _ in ssd_bwd_check(
                what, run, (x, loga, b, c, dy, ds), q):
            row[f"err_{name}"], row[f"floor_{name}"] = dev, floor
            e = max(e, dev)
        if (bsz, l, g, s) == SSD_BWD_SERVED:
            zero = run(torch.zeros_like(ds))
            none = run(None)
            if not all(torch.equal(a, b_) for a, b_ in zip(zero, none)):
                raise AssertionError(f"{what}: a None dstate differs from "
                                     "a zero one")
        err = max(err, e)
        row["max_abs_err"] = e
        row["ms"] = median_ms(run)
        row["kernel_ms"] = kernel_only_ms(run)
        row["plain_ms"] = median_ms(
            lambda: ops.plain_backward(x, loga, b, c, dy, ds, q), reps=5)
        # the bound of the route the kernel takes (3xTF32 products), and
        # the float32 one beside it
        row["bound_ms"], row["bound_by"] = ssd_bwd_tc_bound(
            bsz, l, h, p, g, s, q)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["f32_bound_ms"], row["f32_bound_by"] = ssd_bwd_bound(
            bsz, l, h, p, g, s, q)
        row["f32_bound_share"] = row["f32_bound_ms"] / row["kernel_ms"]
        stage, _ = ops.backward_stages(x, b, c, dy, ds, ws, q)
        stage(None)
        row["launch_ms"] = {n: kernel_only_ms(lambda i=i: stage(i))
                            for i, n in enumerate(ops.BWD_NAMES)}
        del stage
        if (bsz, l, g) == SSD_BWD_SERVED[:3]:    # a train step's forward
            row["fwd_kernel_ms"] = kernel_only_ms(
                lambda: ops.launch(x, loga, b, c, q))
        rows.append(row)
        if (bsz, l, g, s) == SSD_BWD_SERVED:
            served = row
        print(f"  {what}: err / float32 floor " + ", ".join(
            f"{n} {row['err_' + n]:.2e} / {row['floor_' + n]:.2e}"
            for n in ("dx", "dloga", "db", "dc"))
            + ", two launches equal" + timing_text(row).replace(
                "  bound", "  3xTF32 bound")
            + f"; float32 bound {row['f32_bound_ms']:.4f} ms "
            f"({row['f32_bound_by']}, {100 * row['f32_bound_share']:.1f} %)")
        print("    kernel-only by launch: " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in row["launch_ms"].items()))
        del x, loga, b, c, dy, ds, ws
        torch.cuda.empty_cache()
    report["ssd_scan_bwd_cases"] = rows
    # L 1 on more seeds: there dc (and db) is a sum over the group's heads
    # of one-row products, and one float32 order of that sum can land far
    # closer to float64 than the kernel's order; the floor is the largest
    # distance over `SSD_BWD_L1_ORDERS` orders of the heads (phase 17's
    # rule), and the 4x gate applies on every seed
    ratios, seeds = {}, []
    for seed in range(SSD_BWD_L1_SEEDS):
        gen = torch.Generator(DEVICE).manual_seed(seed)
        x, loga, b, c = ssd_inputs(1, 1, 64, 64, 1, 128, gen)
        dy = torch.randn(1, 1, 64, 64, device=DEVICE, generator=gen)
        ds = torch.randn(1, 64, 128, 64, device=DEVICE, generator=gen)
        _, _, ws = ops._launch(x, loga, b, c, 128)
        l1 = ssd_bwd_rows(
            f"ssd_scan_bwd L1 seed {seed}",
            lambda: ops.launch_backward(x, b, c, dy, ds, ws, 128),
            (x, loga, b, c, dy, ds), 128,
            orders=head_orders(64, 1, SSD_BWD_L1_ORDERS, seed))
        seeds.append(l1)
        for name, dev, floor, _ in l1:
            ratios.setdefault(name, []).append(dev / floor if floor
                                               else 0.0)
    for name in ("db", "dc"):
        print(f"  L 1, {name} / its floor over {SSD_BWD_L1_ORDERS} head "
              f"orders, seeds 0-{SSD_BWD_L1_SEEDS - 1}: "
              + " ".join(f"{r:.2f}" for r in ratios[name]))
    worst = {}
    for seed, l1 in enumerate(seeds):
        for name, dev, floor, share in ssd_bwd_gate(
                f"ssd_scan_bwd L1 seed {seed}", l1):
            w = worst.setdefault(name, {"ratio": 0.0, "share": 0.0})
            w["ratio"] = max(w["ratio"], dev / floor if floor else 0.0)
            w["share"] = max(w["share"], share)
    report["ssd_scan_bwd_l1_seeds"] = {"seeds": SSD_BWD_L1_SEEDS,
                                       "orders": SSD_BWD_L1_ORDERS,
                                       "worst": worst, "ratios": ratios}
    print(f"  L 1 on {SSD_BWD_L1_SEEDS} seeds within the 4x gate, the most: "
          + ", ".join(f"{n} {w['ratio']:.2f}x the float32 floor "
                      f"({100 * w['share']:.0f} % of the gate)"
                      for n, w in worst.items()))
    return dict(served, max_abs_err=err)


def head_orders(h: int, g: int, n: int, seed: int) -> list:
    """`n` orders of `h` heads, the identity first, each of the others a
    random permutation within each of the `g` groups (a group's heads
    share its B and C): index tensors on the card."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    r = h // g
    out = [torch.arange(h)]
    for _ in range(n - 1):
        out.append(torch.cat([k * r + torch.randperm(r, generator=gen)
                              for k in range(g)]))
    return [o.to(DEVICE) for o in out]


def ssd_bwd_check(what, run, inputs, q, orders=None):
    """19(a)'s gates on one case: `run()` launched twice against the float64
    and float32 plain backwards of `inputs` (x, loga, b, c, dy, dstate);
    yields (name, distance from float64, the float32 floor, the share of
    the 4x gate) a gradient."""
    return ssd_bwd_gate(what, ssd_bwd_rows(what, run, inputs, q, orders))


def ssd_bwd_rows(what, run, inputs, q, orders=None) -> list:
    """(name, distance from float64, the float32 floor, the float64 max)
    of each gradient of `run()`, every value finite and two launches equal
    bit for bit.  The floor is the float32 plain backward's distance from
    float64, the largest over `orders` of the heads where given (each
    order's dx and d loga put back in place; db and dc, sums over a
    group's heads, are what the order moves)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    got, again = run(), run()
    want = ops.plain_backward(*(t.double() for t in inputs), q)
    floors = [0.0] * 4
    for perm in orders or [None]:
        x, loga, b, c, dy, ds = inputs
        if perm is not None:
            x, loga, dy, ds = x[:, :, perm], loga[:, :, perm], \
                dy[:, :, perm], ds[:, perm]
        p32 = list(ops.plain_backward(x, loga, b, c, dy, ds, q))
        if perm is not None:
            inv = torch.argsort(perm)
            p32[0], p32[1] = p32[0][:, :, inv], p32[1][:, :, inv]
        floors = [max(f, float((a.double() - w).abs().max()))
                  for f, a, w in zip(floors, p32, want)]
    rows = []
    for name, a, a2, w, floor in zip(("dx", "dloga", "db", "dc"), got,
                                     again, want, floors):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        if not torch.equal(a, a2):
            raise AssertionError(f"{what}: two launches differ in {name}")
        rows.append((name, float((a.double() - w).abs().max()), floor,
                     float(w.abs().max())))
    return rows


def ssd_bwd_gate(what, rows):
    """Each row of `ssd_bwd_rows` within 4x its float32 floor (plus 1e-6
    of its max) and within 1e-4 of its max; yields (name, distance, floor,
    share of the 4x gate)."""
    for name, dev, floor, scale in rows:
        if dev > 4 * floor + 1e-6 * scale or dev > 1e-4 * scale:
            raise AssertionError(
                f"{what}: {name} deviates by {dev:.3e} from float64 "
                f"(float32 floor {floor:.3e}, max {scale:.3e})")
        yield name, dev, floor, dev / (4 * floor + 1e-6 * scale or 1.0)


def ssm_train_cli(arch: str, n_params: int) -> dict:
    """19(b) / (c): `python -m repro_torch.launch.train --arch ARCH` at full
    width and depth, batch 8 x 256, in-process: losses and |g| finite,
    peak under 70 GiB, and the scans' launches exactly as many as the
    layers give (remat "full": each recomputed layer's scan twice a step,
    zamba2's tail layers once; the backward once a layer)."""
    import gc
    import torch
    from repro_torch.launch import train
    from repro_torch.models.transformer import hybrid_depth

    args = train.build_parser().parse_args(
        ["--arch", arch] + SSM_TRAIN_CLI
        + ["--device", DEVICE, "--ckpt-dir", str(ROOT / "build" / "ckpt-19")])
    cfg = train.model_config(args)
    if cfg.family == "hybrid":
        n_groups, tail = hybrid_depth(cfg)
        recomputed = n_groups * cfg.shared_every
    else:
        recomputed, tail = cfg.n_layers, 0
    want = {"ssd_scan": (2 * recomputed + tail) * args.steps,
            "ssd_scan_bwd": (recomputed + tail) * args.steps}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0, read right after ------------------
    reset_launches()
    res = train.run(args)
    n = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = res["history"]
    if res["bundle"].n_params != n_params:
        raise AssertionError(f"19: not {arch} at full width and depth")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist) or len(hist) != args.steps:
        raise AssertionError(f"19: {arch}: a loss or |g| is not finite")
    others = {k: v for k, v in n.items() if k not in want and v}
    if any(n[k] != v for k, v in want.items()) or others:
        raise AssertionError(f"19: {arch}: launches {n}, want {want}")
    if peak >= PEAK_GIB:
        raise AssertionError(f"19: {arch}: peak {peak:.1f} GiB")
    steady = [h["wall_s"] for h in hist[1:]]
    tok_s = args.batch * args.seq * len(steady) / sum(steady)
    for h in hist:
        print(f"  step {h['step']}: loss {h['loss']:.6f}  |g| "
              f"{h['grad_norm']:.4f}  wall {h['wall_s']:.3f} s")
    print(f"  {arch}: {cfg.n_layers} layers, {res['bundle'].n_params:,} "
          f"params; {statistics.median(steady):.3f} s a step (median of "
          f"steps 1-{len(hist) - 1}), {tok_s:.1f} tokens/s, peak "
          f"{peak:.1f} GiB; ssd_scan {n['ssd_scan']}, ssd_scan_bwd "
          f"{n['ssd_scan_bwd']} launches (want {want['ssd_scan']}, "
          f"{want['ssd_scan_bwd']})")
    out = {"history": hist, "tokens_per_s": tok_s, "peak_gib": peak,
           "median_step_s": statistics.median(steady),
           "n_params": res["bundle"].n_params, "launches": n,
           "d_state": cfg.ssm.d_state}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_card_vs_cpu(report: dict) -> None:
    """19(d): one train step of mamba2-1.3b at full width and 1 layer
    (batch 1 x 64: one ragged chunk) on the card and on the CPU from the
    same params: loss, |g| and every gradient leaf within 4x the card's
    float-order floor, the larger of two: the hidden, head and state axes
    permuted (as phase 7 measures it; two seeds), and the card's float32
    step through the plain scan against its float64 step (neither runs
    the kernels).  The permutations leave the scan's sums over time and
    every elementwise op in their order, and at 1 layer the card's
    float32 error is up to 3x their floor (on an H100: gate_norm 1.44e-5
    from float64 through the plain scan against 4.67e-6 permuted)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import build_model

    arch, layers = SSM_CPU
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    bundle = build_model(cfg)
    need = 5 * 4 * bundle.n_params / 2**30 + 4
    avail = mem_available_gib()
    print(f"  {arch} at {layers} layer, {bundle.n_params:,} params; host "
          f"memory available {avail:.1f} GiB, needed {need:.1f}")
    if avail < need:
        raise AssertionError(f"19(d): {avail:.1f} GiB of host memory "
                             f"available, {need:.1f} needed")
    params = bundle.init(torch.Generator(DEVICE).manual_seed(0),
                         device=DEVICE)
    b, s = SSM_CPU_BATCH
    batch = TokenPipeline(cfg.vocab, s, b, seed=0).batch(0, DEVICE)

    @contextlib.contextmanager
    def plain_scan():
        SSM.ssd_scan = ssd_ops.plain
        try:
            yield
        finally:
            SSM.ssd_scan = ssd_ops.ssd_scan

    _, grads, params_c, dev, floor, cpu_s = card_vs_cpu_grads(
        bundle, params, batch, {"embed": cfg.d_model,
                                "heads": cfg.ssm.n_heads,
                                "state": cfg.ssm.d_state}, "19(d)",
        plain_scan)
    report["ssm_train_card_vs_cpu"] = {"dev": dev, "floor": floor,
                                       "cpu_step_s": cpu_s}
    del params, params_c, grads
    gc.collect()
    torch.cuda.empty_cache()


def ssm_train_phase(report: dict) -> tuple[dict, dict]:
    """Phase 19; returns the backward's timed row (19(a)) and the main
    path's launches (19(b) and (c))."""
    print("phase 19(a): the ssd_scan backward against its plain version")
    row = ssd_bwd_phase(report)
    launches = {"ssd_scan": 0, "ssd_scan_bwd": 0}
    for tag, (arch, n_params) in zip("bc", SSM_TRAIN):
        print(f"phase 19({tag}): python -m repro_torch.launch.train --arch "
              f"{arch}, full width and depth")
        res = ssm_train_cli(arch, n_params)
        # the scans' device time a step: launches x 19(a)'s kernel-only
        # times at this model's train shape
        case = next(r for r in report["ssd_scan_bwd_cases"]
                    if (r["B"], r["L"], r["G"]) == SSD_BWD_SERVED[:3]
                    and r["S"] == res["d_state"])
        steps = len(res["history"])
        res["scan_ms_per_step"] = (
            res["launches"]["ssd_scan"] * case["fwd_kernel_ms"]
            + res["launches"]["ssd_scan_bwd"] * case["kernel_ms"]) / steps
        print(f"  the scans' kernels ≈ {res['scan_ms_per_step']:.1f} ms a "
              f"step ({100 * res['scan_ms_per_step'] / 1e3 / res['median_step_s']:.1f}"
              f" % of it; forward {case['fwd_kernel_ms']:.4f} ms, "
              f"backward {case['kernel_ms']:.4f} ms kernel-only a call)")
        report[f"ssm_train_{arch}"] = res
        for k in launches:
            launches[k] += res["launches"][k]
    print(f"phase 19(d): a full-width 1-layer {SSM_CPU[0]} train step, card "
          "vs CPU")
    ssm_card_vs_cpu(report)
    return row, launches


# ---------------------------------------------------------------------------
# Phase 20: the dry run
# ---------------------------------------------------------------------------
# one arch per family at one of its assigned shapes, on both meshes
DRYRUN_CELLS = [("qwen3-32b", "train_4k"), ("deepseek-v2-236b", "train_4k"),
                # decode_32k, not prefill_32k: that trace of the plain
                # scan's chunks took 92 s of the phase
                ("mamba2-1.3b", "decode_32k"), ("zamba2-1.2b", "long_500k"),
                ("seamless-m4t-medium", "decode_32k"),
                ("phi-3-vision-4.2b", "decode_32k")]
DRYRUN_ALLOC = ("deepseek-v2-236b", "train_4k", "single")   # the largest
ALLOC_ROUND = 512              # the caching allocator's block granularity
ALLOC_UNSPLIT = 1 << 20        # the most of a large block it leaves unsplit


def dryrun_cells(arch: str, shape: str) -> list:
    """20(a)'s worker, a process of its own (its own fake group): the
    records of `run_cell(arch, shape)` on both production meshes."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    try:
        return [dryrun.run_cell(arch, shape, kind)
                for kind in dryrun.MESH_KINDS]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_phase(report: dict) -> None:
    """20: (a) `launch.dryrun.run_cell` of `DRYRUN_CELLS` on both
    production meshes, each over a "fake" process group of its 256 / 512
    ranks with meta DTensors and a meta trace on the host's CPU, one
    process a cell (the ssm scan's plain version traces its chunks one by
    one): every record "ok" with a positive FLOP count; (b) meanwhile,
    rank 0's local shards of `DRYRUN_ALLOC` allocated on the card: the
    allocator's requested bytes grow by exactly the record's
    `argument_bytes`, and `torch.cuda.memory_allocated()` by that with
    each tensor rounded up to 512 B, plus what the allocator leaves
    unsplit of a large block (at most 1 MiB a tensor above 1 MiB)."""
    import concurrent.futures
    import multiprocessing
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(DRYRUN_CELLS), mp_context=ctx) as pool:
        futures = [pool.submit(dryrun_cells, arch, shape)
                   for arch, shape in DRYRUN_CELLS]
        try:
            local = [t for _, t in dryrun.shards(
                dryrun.cell_arguments(*DRYRUN_ALLOC))]
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        sizes = [t.numel() * t.element_size() for t in local]
        rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in sizes)
        slack = ALLOC_UNSPLIT * sum(n > ALLOC_UNSPLIT for n in sizes)
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        before = (stats["requested_bytes.all.current"],
                  torch.cuda.memory_allocated())
        held = [torch.empty(t.shape, dtype=t.dtype, device=DEVICE)
                for t in local]
        torch.cuda.synchronize()
        requested = torch.cuda.memory_stats()[
            "requested_bytes.all.current"] - before[0]
        grew = torch.cuda.memory_allocated() - before[1]
        del held
        torch.cuda.empty_cache()
        rows = [rec for f in futures for rec in f.result()]
    for rec in rows:
        if rec["status"] != "ok" or not rec["matmul_flops_global"] > 0:
            raise AssertionError(f"dry run {rec['arch']} {rec['shape']} "
                                 f"{rec['mesh']}: {rec}")
        print(f"  {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"{rec['argument_bytes'] / 2**30:.3f} GiB a device "
              f"(params {rec['params_bytes'] / 2**30:.3f}, "
              f"opt_state {rec['opt_state_bytes'] / 2**30:.3f}, "
              f"batch {rec['batch_bytes'] / 2**30:.3f}), "
              f"{rec['matmul_flops_global'] / 1e12:.1f} TFLOP a step; "
              f"build {rec['build_s']:.2f} s, trace {rec['trace_s']:.1f} s"
              + (" (reused)" if rec["trace_reused"] else ""))
    rec = next(r for r in rows
               if (r["arch"], r["shape"], r["mesh"]) == DRYRUN_ALLOC)
    print(f"  {' '.join(DRYRUN_ALLOC)} on the card: {len(local)} local "
          f"shards; requested {requested} B against the record's "
          f"argument_bytes {rec['argument_bytes']} B; allocated {grew} B "
          f"against {rounded} B with each tensor rounded up to "
          f"{ALLOC_ROUND} B (+{grew - rounded} B unsplit, at most "
          f"{slack})")
    if sum(sizes) != rec["argument_bytes"] \
            or requested != rec["argument_bytes"] \
            or not rounded <= grew <= rounded + slack:
        raise AssertionError(f"dry run {DRYRUN_ALLOC}: requested "
                             f"{requested} B, allocated {grew} B; the "
                             f"record gives {rec['argument_bytes']} B, "
                             f"{rounded} B rounded")
    report["dryrun"] = {
        "cells": rows,
        "alloc": {"cell": list(DRYRUN_ALLOC), "shards": len(local),
                  "argument_bytes": rec["argument_bytes"],
                  "requested_bytes": requested, "rounded_bytes": rounded,
                  "allocated_bytes": grew, "unsplit_bound": slack}}


# ---------------------------------------------------------------------------
# Phase 21: serving across ranks
# ---------------------------------------------------------------------------
RANK_CARDS = False             # --cards: nccl, one rank a card
RANK_TIMEOUT = 600.0           # seconds a group of ranks may take
SLOT_RANKS = 2                 # 21(a): four replicas of 14 GB do not fit
SEQ_RANKS = 4                  # 21(b), 21(c)
SEQ_LEN = 32768                # 21(b)'s cache positions, over "model"
SEQ_LAYERS = 2                 # four replicas of the params + rank 0's
SEQ_STEPS = 8
SEQ_POS = (24572, 16380, 8190, 30000)   # each slot's first position
SEQ_WINDOW = 4096              # flash_decode alone with a window
EP_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
EP_SLOTS, EP_CHUNK = 4, 64     # a decode batch, a prefill chunk


def rank_backend() -> str:
    return "nccl" if RANK_CARDS else "gloo"


def rank_layout(n: int) -> str:
    return (f"backend={rank_backend()} ranks={n} "
            + ("one a card" if RANK_CARDS else "on 1 card"))


def rank_setup(device):
    """What every rank of phase 21 sets first: the parent's matmul
    precision and the port on its path."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)


def busy_ms(prof) -> float:
    """Summed kernel time (ms) of a profiled run (one process's)."""
    total = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and evt.device_type.name == "CUDA":
            total += dev_us / 1e3
    return total


def slot_run(sched, reqs) -> dict:
    """One main-path run of a rank's Scheduler, the counts from 0."""
    import torch
    reset_launches()
    rep = sched.run(reqs)
    torch.cuda.synchronize()
    return {"tokens": {r: c.tokens for r, c in rep.completions.items()},
            "launches": launch_counts(), "decode_steps": rep.decode_steps,
            "prefill_chunks": rep.prefill_chunks, "wall_s": rep.wall_s,
            "tok_s": rep.tokens_per_s, "total_tokens": rep.total_tokens}


def slot_rank(rank: int, world: int, device) -> dict:
    """21(a) on one rank, on a (world, 1) mesh: phase 3's 4 slots over
    the ranks (the main path's run, then the same requests under the
    profiler for the card's busy share), and 4 slots a rank (phase 3's
    decode width) on the same params.  Rank 0 also runs, alone, the
    one-process Scheduler and the sequential oracle at its 2-row width."""
    rank_setup(device)
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import Scheduler, run_sequential

    cfg, scfg, reqs = serve_setup()
    mesh = make_test_mesh(world, 1, device.type)
    t0 = time.perf_counter()
    sched = Scheduler(cfg, scfg, init_seed=0, device=device, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out = {"n_local": sched.n_local, "setup_s": setup_s,
           "run": slot_run(sched, reqs),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "params_digest": params_digest(sched.params)}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = sched.run(reqs)
        out["profiled_wall_s"] = time.perf_counter() - t0
    out["busy_ms"] = busy_ms(prof)
    out["profiled_tokens"] = {r: c.tokens
                              for r, c in rep.completions.items()}
    wide = dataclasses.replace(scfg, n_slots=scfg.n_slots * world)
    out["wide"] = slot_run(Scheduler(cfg, wide, params=sched.params,
                                     device=device, mesh=mesh), reqs)
    if rank == 0:
        # one process, no collective, at this rank's decode width
        local = dataclasses.replace(scfg, n_slots=sched.n_local)
        one = Scheduler(cfg, local, params=sched.params, device=device)
        out["one_local"] = {r: c.tokens for r, c in
                            one.run(reqs).completions.items()}
        out["seq_local"] = {r: v["tokens"] for r, v in run_sequential(
            cfg, local, sched.params, reqs, device=device).items()}
    return out


def params_digest(params) -> list:
    """Sums of a few leaves: equal params on every rank and in the
    parent (each inits from the same seed on its own).  Summed in the
    leaves' float32: a float64 sum would cast a copy of each first."""
    from repro_torch.models.module import leaves
    return [float(t.sum()) for _, t in list(leaves(params))[:4]]


def token_diff(got: dict, want: dict) -> dict:
    """{rid: index of the first differing token} where they differ."""
    return {r: next(i for i, (a, b) in enumerate(
        zip(got[r] + [None], want[r] + [None])) if a != b)
        for r in want if got[r] != want[r]}


def slot_phase(report: dict) -> int:
    """21(a): phase 3's qwen3-32b stream, slots over 2 ranks.  Gated:
    with phase 3's 4 slots (2 a rank) every completion's tokens equal
    the one-process Scheduler's and `run_sequential`'s at the rank's
    2-row width on this card; with 4 slots a rank (8 in all, phase 3's
    decode width) they equal phase 3's one-process Scheduler's and
    `run_sequential`'s; each rank's `rosa_fused` launches equal 2 x
    layers x (its decode steps + prefill chunks) in each run; the ranks'
    peaks plus the parent's allocation < 70 GiB a card.  Printed: the
    4-slot run against phase 3's tokens (the card's decode is not
    batch-width invariant), tok/s, the card's busy share.  Returns the
    ranks' `rosa_fused` launches."""
    import torch
    from repro_torch.distributed import runtime

    cfg, scfg, reqs = serve_setup()
    if "serve" not in report:         # phase 21 alone: phases 3-5 first
        print("phases 3-5: serving (phase 21(a) reads phase 3's tokens)")
        serve_phase(report)
        torch.cuda.empty_cache()
    one = report["serve"]["tokens"]
    seq = report["serve"]["sequential_tokens"]
    print(f"  21(a): {rank_layout(SLOT_RANKS)}; qwen3-32b full width, "
          f"{cfg.n_layers} layers, phase 3's 6 requests; {scfg.n_slots} "
          f"slots over the ranks, then {scfg.n_slots} a rank")
    parent = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    outs = runtime.spawn(slot_rank, SLOT_RANKS, device_type=DEVICE,
                         backend=rank_backend(), timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    routed = 2 * cfg.n_layers
    fused = 0
    for r, o in enumerate(outs):
        for name in ("run", "wide"):
            run = o[name]
            n = run["launches"]
            want = routed * (run["decode_steps"] + run["prefill_chunks"])
            fused += n["rosa_fused"]
            print(f"  rank {r}, {o['n_local'] if name == 'run' else scfg.n_slots}"
                  f" slots: {run['total_tokens']} tokens in "
                  f"{run['wall_s']:.2f} s ({run['tok_s']:.2f} tok/s), "
                  f"{run['decode_steps']} decode steps, "
                  f"{run['prefill_chunks']} prefill chunks, rosa_fused "
                  f"launches {n['rosa_fused']} (2 x {cfg.n_layers} x "
                  f"(steps + chunks) = {want})")
            if n["rosa_fused"] != want or any(
                    v for k, v in n.items() if k != "rosa_fused"):
                raise AssertionError(f"21(a) rank {r} {name}: launches {n},"
                                     f" wanted rosa_fused {want} and "
                                     "nothing else")
            if run["tokens"] != outs[0][name]["tokens"]:
                raise AssertionError(f"21(a) rank {r} {name}: the ranks' "
                                     "tokens differ")
        print(f"  rank {r}: set-up {o['setup_s']:.1f} s, peak "
              f"{o['peak_bytes'] / 2**30:.2f} GiB")
        if o["profiled_tokens"] != o["run"]["tokens"]:
            raise AssertionError(f"21(a) rank {r}: the profiled run's "
                                 "tokens differ")
        if o["params_digest"] != outs[0]["params_digest"]:
            raise AssertionError("21(a): the ranks' params differ")
    got, wide = outs[0]["run"]["tokens"], outs[0]["wide"]["tokens"]
    n_local = outs[0]["n_local"]
    checks = ((f"{scfg.n_slots} slots over the ranks", got,
               f"the one-process Scheduler at {n_local} slots",
               outs[0]["one_local"], True),
              (f"{scfg.n_slots} slots over the ranks", got,
               f"run_sequential at {n_local} rows", outs[0]["seq_local"],
               True),
              (f"{scfg.n_slots} a rank", wide,
               f"phase 3's one-process Scheduler ({scfg.n_slots} slots)",
               one, True),
              (f"{scfg.n_slots} a rank", wide,
               f"run_sequential at {scfg.n_slots} rows", seq, True),
              (f"{scfg.n_slots} slots over the ranks", got,
               f"phase 3's one-process Scheduler ({scfg.n_slots} slots)",
               one, False))
    for what, tokens, name, want, gated in checks:
        diff = token_diff(tokens, want)
        print(f"  {what} vs {name}: {len(want) - len(diff)} of "
              f"{len(want)} requests give identical tokens"
              + (f"; first differing token by request {diff}" if diff
                 else "") + ("" if gated else " (not gated: the widths "
                             "differ)"))
        if gated and diff:
            raise AssertionError(f"21(a): {what}: tokens differ from "
                                 f"{name}'s")
    peak = (max(o["peak_bytes"] for o in outs) if RANK_CARDS else
            sum(o["peak_bytes"] for o in outs)) + parent
    busy = sum(o["busy_ms"] for o in outs)
    pwall = max(o["profiled_wall_s"] for o in outs) * 1e3
    share = busy / pwall / (SLOT_RANKS if RANK_CARDS else 1)
    print(f"  21(a): peak {peak / 2**30:.2f} GiB a card (ranks + parent "
          f"{parent / 2**30:.2f}); busy {busy:.1f} ms of kernels over "
          f"{pwall:.1f} ms profiled ({100 * share:.1f} % of the card"
          + (" each" if RANK_CARDS else "") + f"); wall {wall:.1f} s")
    if peak >= PEAK_GIB * 2**30:
        raise AssertionError(f"21(a): peak {peak / 2**30:.1f} GiB")
    report["ranks_slots"] = {
        "backend": rank_backend(), "ranks": SLOT_RANKS,
        "one_card": not RANK_CARDS, "wall_s": wall,
        "peak_gib": peak / 2**30, "busy_share": share,
        "vs_phase3_differ": token_diff(got, one),
        "rosa_fused_launches": [[o[k]["launches"]["rosa_fused"]
                                 for k in ("run", "wide")] for o in outs],
        "tok_s": [[o[k]["tok_s"] for k in ("run", "wide")] for o in outs],
        "setup_s": [o["setup_s"] for o in outs]}
    return fused


# ---- 21(b): the KV cache's sequence over ranks -----------------------------
def seq_model(device):
    """21(b)'s qwen3-32b (full width, SEQ_LAYERS layers) and its params
    from seed 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=SEQ_LAYERS)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device).manual_seed(0),
                         device=device)
    return cfg, bundle, params


def seq_cache(cfg, device, part: tuple[int, int] | None = None) -> dict:
    """21(b)'s decode cache: 4 slots x SEQ_LEN positions of K / V filled
    from seed 11, leaf by leaf, in bfloat16; with `part` (first, count)
    only those positions (a rank's slice).  pos = SEQ_POS."""
    import torch
    g = torch.Generator(device).manual_seed(11)
    b, kv, hd = len(SEQ_POS), cfg.n_kv_heads, cfg.head_dim
    lo, n = part or (0, SEQ_LEN)
    kvs = []
    for _ in range(2):
        leaf = torch.empty((cfg.n_layers, b, n, kv, hd),
                           dtype=cfg.cache_dtype, device=device)
        for i in range(cfg.n_layers):
            full = torch.randn((b, SEQ_LEN, kv, hd), generator=g,
                               device=device)
            leaf[i].copy_(full[:, lo:lo + n])
            del full
        kvs.append(leaf)
    return {"layers": tuple(kvs),
            "pos": torch.tensor(SEQ_POS, dtype=torch.int32, device=device)}


def seq_tokens(cfg):
    import numpy as np
    import torch
    rng = np.random.default_rng(21)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (len(SEQ_POS),
                                                        SEQ_STEPS))
                            .astype(np.int32))


def seq_decode(bundle, params, cache, tokens) -> "torch.Tensor":
    """SEQ_STEPS decode steps teacher-forced with `tokens` (B, steps):
    the logits (steps, B, V) on the host."""
    import torch
    out = []
    with torch.inference_mode():
        for i in range(SEQ_STEPS):
            lg, stepped = bundle.decode_step(params, {
                "token": tokens[:, i].to(cache["pos"].device),
                "pos": cache["pos"], "cache": cache})
            cache["pos"].copy_(stepped["pos"])
            out.append(lg.float().cpu())
    return torch.stack(out)


def window_case(cfg, device):
    """flash_decode alone with a window: q from seed 12, layer 0's K / V
    of `seq_cache`."""
    import torch
    g = torch.Generator(device).manual_seed(12)
    return torch.randn((len(SEQ_POS), 1, cfg.n_heads, cfg.head_dim),
                       generator=g, device=device)


def seq_refs(cfg, bundle, params) -> dict:
    """21(b)'s one-process side: the decode steps over the whole cache,
    their float-order floor (the same steps with the hidden and MLP
    dimensions of the params permuted, seeds 1 and 2: a reordering of
    every sum but the attention's), and the windowed attention over the
    whole cache with its floor (the key axis permuted)."""
    import torch
    from repro_torch.models import layers as L
    tokens = seq_tokens(cfg)
    lr = seq_decode(bundle, params, seq_cache(cfg, DEVICE), tokens)
    scale = lr.abs().amax(dim=(1, 2))
    floor = torch.zeros(SEQ_STEPS)
    holder = types.SimpleNamespace(bundle=bundle, params=params)
    for seed in (1, 2):
        pp, _ = permuted_params(holder, {"embed": cfg.d_model,
                                         "mlp": cfg.d_ff}, seed)
        lp = seq_decode(bundle, pp, seq_cache(cfg, DEVICE), tokens)
        floor = torch.maximum(floor,
                              (lp - lr).abs().amax(dim=(1, 2)) / scale)
        del pp
        torch.cuda.empty_cache()
    # flash_decode alone, windowed: the whole cache's attention
    cache = seq_cache(cfg, DEVICE)
    q = window_case(cfg, DEVICE)
    kc, vc = cache["layers"][0][0], cache["layers"][1][0]
    pos = cache["pos"]
    k_pos = torch.arange(SEQ_LEN, device=DEVICE)[None].expand(len(pos), -1)
    bias = L._mask_bias(pos[:, None], k_pos, True, SEQ_WINDOW,
                        k_len_valid=(pos + 1)[:, None])

    def attend(perm):
        return L.attention_core(q, kc[:, perm], vc[:, perm],
                                bias[..., perm]).cpu()

    ident = torch.arange(SEQ_LEN, device=DEVICE)
    ow = attend(ident)
    gp = torch.Generator().manual_seed(3)
    op = attend(torch.randperm(SEQ_LEN, generator=gp).to(DEVICE))
    wfloor = float((op - ow).abs().max() / ow.abs().max())
    del cache, kc, vc
    torch.cuda.empty_cache()
    return {"tokens": tokens, "logits": lr, "floor": floor, "window": ow,
            "window_floor": wfloor}


def seq_rank(rank: int, world: int, device, mesh) -> dict:
    """21(b) on one rank: the decode steps on its quarter of the cache
    under a live context (flash_decode counted), and flash_decode alone
    with a window."""
    import torch
    from repro_torch.distributed.sharding import SERVE_RULES, use_sharding
    from repro_torch.distributed.runtime import axis_index
    from repro_torch.models import layers as L

    cfg, bundle, params = seq_model(device)
    # the port splits no heads: the sequence takes "model" (under
    # SERVE_RULES qwen3-32b's 8 KV heads would claim it first)
    rules = dict(SERVE_RULES, kv_heads=())
    s_loc = SEQ_LEN // world
    axes = ("data", "model")
    lo = axis_index(axes, mesh) * s_loc
    cache = seq_cache(cfg, device, (lo, s_loc))
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in cache["layers"])
    q = window_case(cfg, device)
    with use_sharding(mesh, rules, {"cache_seq": SEQ_LEN}):
        calls = L.FLASH_DECODES["calls"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = seq_decode(bundle, params, cache, seq_tokens(cfg))
        step_s = (time.perf_counter() - t0) / SEQ_STEPS
        calls = L.FLASH_DECODES["calls"] - calls
        spec = L.seq_shard(cache["layers"][0][0])
        fresh = seq_cache(cfg, device, (lo, s_loc))
        ow = L.flash_decode(q, fresh["layers"][0][0], fresh["layers"][1][0],
                            fresh["pos"], SEQ_WINDOW, cfg.n_heads)
    # host values only: the ranks exit right after handing them over
    return {"logits": logits.numpy() if rank == 0 else None,
            "calls": calls, "cache_bytes": cache_bytes, "slice": (lo, s_loc),
            "seq_axes": spec[0], "window": ow.cpu().numpy(),
            "step_s": step_s,
            "params_digest": params_digest(params),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def seq_check(refs: dict, outs: list, whole_bytes: int,
              report: dict) -> None:
    """21(b)'s gates on the ranks' results."""
    import torch
    lr, floor = refs["logits"], refs["floor"]
    bound = 4 * floor + 1e-5
    for r, o in enumerate(outs):
        if o["calls"] != SEQ_LAYERS * SEQ_STEPS:
            raise AssertionError(f"21(b) rank {r}: flash_decode ran "
                                 f"{o['calls']} times, wanted "
                                 f"{SEQ_LAYERS} x {SEQ_STEPS}")
        if o["cache_bytes"] * SEQ_RANKS != whole_bytes:
            raise AssertionError(f"21(b) rank {r}: {o['cache_bytes']} B of "
                                 f"cache, not 1/{SEQ_RANKS} of {whole_bytes}")
    lg = torch.from_numpy(outs[0]["logits"])
    if lg.shape != lr.shape or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"21(b): logits {tuple(lg.shape)} not finite "
                             "or of the wrong shape")
    scale = lr.abs().amax(dim=(1, 2))
    rel = (lg - lr).abs().amax(dim=(1, 2)) / scale
    top2 = lr.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / scale[:, None]
    clear = gap > bound[:, None]
    same = lg.argmax(-1) == lr.argmax(-1)
    for i in range(SEQ_STEPS):
        print(f"  step {i}: sharded vs whole-cache logits max rel dev "
              f"{float(rel[i]):.3e}, floor {float(floor[i]):.3e}, bound "
              f"{float(bound[i]):.3e}; argmax equal "
              f"{int(same[i].sum())} of {len(SEQ_POS)} "
              f"({int(clear[i].sum())} past the bound)")
    if bool((rel > bound).any()) or bool((clear & ~same).any()):
        raise AssertionError("21(b): the sharded decode's logits leave the "
                             "bound of the whole cache's")
    ow, wf = refs["window"], refs["window_floor"]
    wbound = 4 * wf + 1e-6
    for r, o in enumerate(outs):
        wrel = float((torch.from_numpy(o["window"]) - ow).abs().max()
                     / ow.abs().max())
        if wrel > wbound:
            raise AssertionError(f"21(b) rank {r}: windowed flash_decode "
                                 f"{wrel:.3e} from the whole cache's "
                                 f"(bound {wbound:.3e})")
    print(f"  window {SEQ_WINDOW}: flash_decode vs the whole cache's "
          f"attention max rel dev {wrel:.3e} (floor {wf:.3e}, bound "
          f"{wbound:.3e}); each rank's cache {outs[0]['cache_bytes']} B of "
          f"{whole_bytes}, slices {[o['slice'][0] for o in outs]}, over "
          f"{outs[0]['seq_axes']}; {1e3 * outs[0]['step_s']:.1f} ms a "
          "sharded decode step")
    report["ranks_seq"] = {
        "rel": rel.tolist(), "floor": floor.tolist(),
        "window_rel": wrel, "window_floor": wf,
        "cache_bytes": outs[0]["cache_bytes"], "whole_bytes": whole_bytes,
        "step_ms": [1e3 * o["step_s"] for o in outs]}


# ---- 21(c): experts over ranks ---------------------------------------------
def ep_block(arch: str, device, experts=None) -> dict:
    """One MoE block of `arch` at full width, from seeds: the router and
    the shared experts from seed 5, expert e's wi / wo from seeds 1000 + e
    / 5000 + e, so a rank draws only its own experts (`experts`, default
    all)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    m = get_config(arch).moe
    defs = MOE.moe_def(m)
    g = torch.Generator(device).manual_seed(5)
    p = {k: torch.randn(d.shape, generator=g, device=device) * d.std
         for k, d in sorted(defs.items()) if k not in ("wi", "wo")}
    experts = range(m.n_experts) if experts is None else experts
    for k, base in (("wi", 1000), ("wo", 5000)):
        d = defs[k]
        t = torch.empty((len(experts), *d.shape[1:]), device=device)
        for j, e in enumerate(experts):
            ge = torch.Generator(device).manual_seed(base + e)
            t[j] = torch.randn(d.shape[1:], generator=ge,
                               device=device) * d.std
        p[k] = t
    return p


def ep_inputs(arch: str, device) -> dict:
    """21(c)'s traffic: a decode batch (EP_SLOTS x 1) and a prefill chunk
    (1 x EP_CHUNK) of hidden states from seed 9."""
    import torch
    from repro_torch.configs import get_config
    d = get_config(arch).moe.d_model
    g = torch.Generator(device).manual_seed(9)
    return {"decode": torch.randn((EP_SLOTS, 1, d), generator=g,
                                  device=device),
            "chunk": torch.randn((1, EP_CHUNK, d), generator=g,
                                 device=device)}


def no_drop(m):
    """The MoE config with a capacity that drops nothing (every token
    fits every expert)."""
    return dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)


def ep_refs(arch: str) -> dict:
    """21(c)'s one-process side: `moe_ep_local` as one rank (capacity
    1.25) and `moe_ref`, with float-order floors from the experts' d_ff
    permuted (a reordering of the second product's sum that leaves the
    routing alone), and the dropped assignments."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import moe as MOE
    m = get_config(arch).moe
    one = MeshShape(("data", "model"), (1, 1))
    p = ep_block(arch, DEVICE)
    xs = ep_inputs(arch, DEVICE)
    g = torch.Generator().manual_seed(4)
    perm = torch.randperm(m.d_ff, generator=g).to(DEVICE)
    pp = dict(p, wi=p["wi"][..., perm], wo=p["wo"][:, perm])
    if m.n_shared:
        sp = torch.randperm(m.n_shared * m.d_ff, generator=g).to(DEVICE)
        pp["shared_wi"] = p["shared_wi"][..., sp]
        pp["shared_wo"] = p["shared_wo"][sp]
    out = {"whole_bytes": sum(p[k].numel() * p[k].element_size()
                              for k in ("wi", "wo"))}
    with torch.inference_mode():
        for kind, x in xs.items():
            def ep(params):
                return MOE.moe_ep_local(params, m, x, fsdp_axes=(),
                                        mesh=one)
            y1, y1p = ep(p), ep(pp)
            yr, yrp = MOE.moe_ref(p, no_drop(m), x), \
                MOE.moe_ref(pp, no_drop(m), x)
            x2 = x.reshape(-1, m.d_model)
            ids = MOE._route(p, m, x2)[1]
            out[kind] = {
                "one": y1.cpu(), "ref": yr.cpu(),
                "one_floor": float((y1p - y1).abs().max() / y1.abs().max()),
                "ref_floor": float((yrp - yr).abs().max() / yr.abs().max()),
                "dropped": MOE.dropped_assignments(
                    ids, m.n_experts, MOE.capacity_of(x2.shape[0], m)),
                "assignments": ids.numel()}
    del p, pp
    torch.cuda.empty_cache()
    return out


def ep_rank(rank: int, world: int, device, mesh) -> dict:
    """21(c) on one rank, each model after the other: its quarter of the
    experts, then `_ffn_apply` under a live context for each traffic
    kind: a2a False at capacity 1.25, both modes at a capacity that drops
    nothing, a2a True at 1.25 (its drops printed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.runtime import axis_index
    from repro_torch.distributed.sharding import (SERVE_RULES,
                                                  ep_param_specs,
                                                  shard_local, use_sharding)
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    zero3 = dict(SERVE_RULES, batch=("pod", "data", "model"))
    chosen = []
    real = MOE.moe_ep_local

    def spy(*a, **kw):
        chosen.append(kw["a2a"])
        return real(*a, **kw)

    MOE.moe_ep_local = spy
    out = {}
    try:
        for arch in EP_ARCHS:
            cfg = get_config(arch)
            m = cfg.moe
            e_local = m.n_experts // world
            first = axis_index("model", mesh) * e_local
            whole = ep_block(arch, device, experts=range(0))
            p = ep_block(arch, device, range(first, first + e_local))
            specs = ep_param_specs(whole, ("data",))
            for k in ("shared_wi", "shared_wo"):
                if k in whole:
                    p[k] = shard_local(whole[k], specs[k],
                                       mesh).contiguous()
            xs = ep_inputs(arch, device)
            res = {"expert_bytes": sum(p[k].numel() * p[k].element_size()
                                       for k in ("wi", "wo"))}
            for kind, x in xs.items():
                # a2a: the tokens over "model" (the chunk's 64 tokens as
                # a batch: the FFN is position-wise)
                xt = x.reshape(-1, 1, m.d_model)
                lo = axis_index(("data", "model"), mesh) * (
                    xt.shape[0] // world)
                xl = xt[lo:lo + xt.shape[0] // world]
                runs = {}
                for name, mm, a2a in (("cap", m, False),
                                      ("nodrop", no_drop(m), False),
                                      ("nodrop_a2a", no_drop(m), True),
                                      ("cap_a2a", m, True)):
                    c = dataclasses.replace(cfg, moe=mm)
                    rules, sizes, xin = ((zero3, {"batch": xt.shape[0]}, xl)
                                         if a2a else (SERVE_RULES, {}, x))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with torch.inference_mode(), \
                            use_sharding(mesh, rules, sizes):
                        y = T._ffn_apply(p, c, xin)
                    torch.cuda.synchronize()
                    runs[name] = {"y": y.cpu().numpy(), "a2a": chosen[-1],
                                  "ms": 1e3 * (time.perf_counter() - t0)}
                x2 = xl.reshape(-1, m.d_model)
                ids = MOE._route(p, m, x2)[1]
                runs["cap_a2a"]["dropped"] = MOE.dropped_assignments(
                    ids, m.n_experts, MOE.capacity_of(x2.shape[0], m))
                res[kind] = runs
            out[arch] = res
            del p, whole
            torch.cuda.empty_cache()
    finally:
        MOE.moe_ep_local = real
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def ep_check(arch: str, refs: dict, outs: list, report: dict) -> None:
    """21(c)'s gates for one model."""
    import torch
    rows = {}
    for r, o in enumerate(outs):
        if o[arch]["expert_bytes"] * SEQ_RANKS != refs["whole_bytes"]:
            raise AssertionError(f"21(c) {arch} rank {r}: "
                                 f"{o[arch]['expert_bytes']} B of experts, "
                                 f"not 1/{SEQ_RANKS} of "
                                 f"{refs['whole_bytes']}")
    for kind in ("decode", "chunk"):
        ref = refs[kind]
        runs = [{n: dict(v, y=torch.from_numpy(v["y"]))
                 for n, v in o[arch][kind].items()} for o in outs]
        for name in ("cap", "nodrop", "nodrop_a2a", "cap_a2a"):
            a2a = name.endswith("a2a")
            if any(rn[name]["a2a"] != a2a for rn in runs):
                raise AssertionError(f"21(c) {arch} {kind} {name}: "
                                     "_ffn_apply took the other dispatch")
        # a2a False: every rank holds the whole output; a2a: its rows
        shape = ref["one"].shape
        got = {n: (torch.cat([rn[n]["y"] for rn in runs]).reshape(shape)
                   if n.endswith("a2a") else runs[0][n]["y"])
               for n in ("cap", "nodrop", "nodrop_a2a", "cap_a2a")}
        for n in ("cap", "nodrop"):
            for rn in runs[1:]:
                if not torch.equal(rn[n]["y"], runs[0][n]["y"]):
                    raise AssertionError(f"21(c) {arch} {kind} {n}: the "
                                         "ranks' outputs differ")
        checks = (("cap", "one", "one_floor"), ("nodrop", "ref", "ref_floor"),
                  ("nodrop_a2a", "ref", "ref_floor"))
        line = []
        for n, want, fl in checks:
            w = ref[want]
            rel = float((got[n] - w).abs().max() / w.abs().max())
            bound = 4 * ref[fl] + 1e-6
            rows[f"{kind}_{n}"] = {"rel": rel, "floor": ref[fl]}
            line.append(f"{n} vs {want} {rel:.3e} (bound {bound:.3e})")
            if rel > bound or not bool(torch.isfinite(got[n]).all()):
                raise AssertionError(f"21(c) {arch} {kind}: {n} {rel:.3e} "
                                     f"from {want} (bound {bound:.3e})")
        drops = sum(rn["cap_a2a"]["dropped"] for rn in runs)
        ms = {n: max(rn[n]["ms"] for rn in runs)
              for n in ("cap", "nodrop", "nodrop_a2a", "cap_a2a")}
        rows[f"{kind}_dropped"] = {"one": ref["dropped"], "a2a": drops,
                                   "assignments": ref["assignments"]}
        rows[f"{kind}_ms"] = ms
        print(f"  {arch} {kind} {tuple(shape)}: " + "; ".join(line)
              + f"; dropped at 1.25: {ref['dropped']} of "
              f"{ref['assignments']} assignments (a2a: {drops}); ms "
              + ", ".join(f"{n} {v:.1f}" for n, v in ms.items()))
    report.setdefault("ranks_ep", {})[arch] = rows


def seq_ep_rank(rank: int, world: int, device) -> dict:
    """21(b) then 21(c) on one rank of SEQ_RANKS (one group: each rank
    reaches the card once)."""
    rank_setup(device)
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, world, device.type)
    t0 = time.perf_counter()
    seq = seq_rank(rank, world, device, mesh)
    torch.cuda.synchronize()
    seq["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ep = ep_rank(rank, world, device, mesh)
    ep["wall_s"] = time.perf_counter() - t0
    return {"seq": seq, "ep": ep}


def ranks_phase(report: dict) -> int:
    """21: serving across ranks.  Returns 21(a)'s rosa_fused launches."""
    import torch
    from repro_torch.distributed import runtime

    t_phase = time.perf_counter()
    fused = slot_phase(report)
    torch.cuda.empty_cache()

    # 21(b) and (c): the one-process sides here, then one group of ranks
    t0 = time.perf_counter()
    cfg, bundle, params = seq_model(DEVICE)
    digest = params_digest(params)
    refs = seq_refs(cfg, bundle, params)
    whole_bytes = 2 * cfg.n_layers * len(SEQ_POS) * SEQ_LEN \
        * cfg.n_kv_heads * cfg.head_dim * 2
    del params, bundle
    torch.cuda.empty_cache()
    ep = {arch: ep_refs(arch) for arch in EP_ARCHS}
    refs_s = time.perf_counter() - t0
    parent = torch.cuda.memory_allocated()
    print(f"  21(b, c): {rank_layout(SEQ_RANKS)}; one-process sides "
          f"{refs_s:.1f} s")
    t0 = time.perf_counter()
    outs = runtime.spawn(seq_ep_rank, SEQ_RANKS, device_type=DEVICE,
                         backend=rank_backend(), timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    seqs = [o["seq"] for o in outs]
    if any(s["params_digest"] != digest for s in seqs):
        raise AssertionError("21(b): a rank's params differ from the "
                             "parent's")
    print(f"  21(b): qwen3-32b full width, {SEQ_LAYERS} layers, "
          f"{len(SEQ_POS)} slots, a {SEQ_LEN}-position cache over "
          f"{SEQ_RANKS} ranks, {SEQ_STEPS} decode steps from positions "
          f"{SEQ_POS}")
    seq_check(refs, seqs, whole_bytes, report)
    print(f"  21(c): one MoE block at full width, experts over "
          f"{SEQ_RANKS} ranks, through _ffn_apply")
    for arch in EP_ARCHS:
        ep_check(arch, ep[arch], [o["ep"] for o in outs], report)
    peak_b = (max(s["peak_bytes"] for s in seqs) if RANK_CARDS else
              sum(s["peak_bytes"] for s in seqs)) + parent
    peak_c = (max(o["ep"]["peak_bytes"] for o in outs) if RANK_CARDS else
              sum(o["ep"]["peak_bytes"] for o in outs)) + parent
    walls = (max(s["wall_s"] for s in seqs),
             max(o["ep"]["wall_s"] for o in outs))
    print(f"  21(b) on the ranks {walls[0]:.1f} s, peak {peak_b / 2**30:.2f}"
          f" GiB a card (ranks "
          + ", ".join(f"{s['peak_bytes'] / 2**30:.2f}" for s in seqs)
          + f"); 21(c) {walls[1]:.1f} s, peak {peak_c / 2**30:.2f} GiB a "
          "card (ranks "
          + ", ".join(f"{o['ep']['peak_bytes'] / 2**30:.2f}" for o in outs)
          + f"); the parent {parent / 2**30:.2f} GiB; the group "
          f"{wall:.1f} s")
    if max(peak_b, peak_c) >= PEAK_GIB * 2**30:
        raise AssertionError(f"21(b, c): peak {max(peak_b, peak_c) / 2**30:.1f}"
                             " GiB")
    report["ranks_seq_ep"] = {
        "backend": rank_backend(), "ranks": SEQ_RANKS,
        "one_card": not RANK_CARDS, "refs_s": refs_s, "group_s": wall,
        "seq_s": walls[0], "ep_s": walls[1], "peak_gib_b": peak_b / 2**30,
        "peak_gib_c": peak_c / 2**30,
        "phase_s": time.perf_counter() - t_phase}
    return fused


# ---------------------------------------------------------------------------
# Phase 22: training across ranks
# ---------------------------------------------------------------------------
RT_STEPS = 2                   # each sharded run's train steps
RT_QWEN = ("qwen3-32b", 2, (2, 1))          # 22(a): arch, layers, mesh
RT_MAMBA = ("mamba2-1.3b", 0, (2, 2))       # 22(b): full depth
RT_QWEN_SPLIT = (1, 2)         # 22(e): 22(a)'s runs over 2 model ranks
RT_CHIP = 7                    # 22(e)'s optical run: this chip, per-shot noise
# a rank's matmul FLOPs of a step against 1 / (data x model) of the
# one-process step's: 22(b)'s and 22(e)'s tolerances
RT_FLOPS_TOL = {"22(b)": 0.03, "22(e)": 0.02}
RT_BATCH = (8, 256)
RT_QWEN_OPT = (3e-4, 2, 10)    # 22(a): phase 17's (train_opt_cfg)
RT_MAMBA_OPT = (3e-4, 2, 4)    # 22(b): phase 19(b)'s
ELASTIC_CLI = ["--arch", "mistral-large-123b", "--smoke", "--batch", "4",
               "--seq", "32", "--log-every", "1"]
ELASTIC_STEPS = (4, 6)         # 22(c): one process to 4, 4 ranks to 6
ELASTIC_ATOL = 6e-5            # the CPU tests' bound on resumed losses
RT_MOE = ("qwen3-moe-235b-a22b", (2, 2))    # 22(d): smoke, moe_ep


# 17(b) leaves 22(a)'s one-process optical side here: its params after
# the steps ("optical") and the k-permuted floors ("floor")
RT_SIDE: dict = {}


def host_register(t) -> None:
    """Page-lock a host tensor's memory for the card's copies (4-8 GB/s
    pageable, 12-25 pinned on the H100's host); raises if CUDA refuses."""
    import torch
    err = torch.cuda.cudart().cudaHostRegister(
        t.data_ptr(), t.numel() * t.element_size(), 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister failed ({err})")


def host_unregister(t) -> None:
    import torch
    torch.cuda.cudart().cudaHostUnregister(t.data_ptr())


def rt_share(params) -> dict:
    """The params in one shared-memory block (page-locked while the card
    writes it) that the ranks attach by name: {"params": {path: host
    view}, "block": its descriptor (pickles as the block's name and the
    leaves' places), "amax": {path: max |leaf|}}."""
    import torch
    from multiprocessing import shared_memory
    from repro_torch.models.module import leaves
    places, off = {}, 0
    for p, t in leaves(params):
        places["/".join(p)] = (off, tuple(t.shape), str(t.dtype))
        off += -(-t.numel() * t.element_size() // 64) * 64
    blk = shared_memory.SharedMemory(create=True, size=max(off, 64))
    desc = {"shm": blk, "leaves": places}
    host = host_views(desc)
    whole = torch.frombuffer(blk.buf, dtype=torch.uint8, count=max(off, 64))
    pin = torch.cuda.is_available() and DEVICE == "cuda"
    if pin:
        host_register(whole)
    amax = {}
    for p, t in leaves(params):
        k = "/".join(p)
        amax[k] = float(t.abs().max())
        host[k].copy_(t)
    if pin:
        host_unregister(whole)
    del whole
    return {"params": host, "block": desc, "amax": amax}


def host_views(desc: dict) -> dict:
    """{path: tensor} views of a `rt_share` block (in any process)."""
    import torch
    out = {}
    for k, (off, shape, dt) in desc["leaves"].items():
        dtype = getattr(torch, dt.split(".")[-1])
        n = math.prod(shape)
        out[k] = torch.frombuffer(desc["shm"].buf, dtype=dtype, count=n,
                                  offset=off).view(shape)
    return out


def host_free(side: dict) -> None:
    """Drop a `rt_share` block (the views first)."""
    side.pop("params", None)
    blk = side.pop("block")["shm"]
    import gc
    gc.collect()
    try:
        blk.close()
    except BufferError:             # a view is still held: left mapped
        pass
    blk.unlink()


def rt_cfg(arch: str, layers: int, smoke: bool = False, **kw):
    from repro_torch.configs import get_config, get_smoke
    cfg = (get_smoke if smoke else get_config)(arch)
    if layers:
        kw["n_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def rt_opt(spec):
    from repro_torch.optim import AdamWConfig, cosine_schedule
    return AdamWConfig(lr=cosine_schedule(*spec))


def rt_batches(cfg, device) -> list:
    """The CLI's batches of the first RT_STEPS steps (seed 0)."""
    from repro_torch.data import TokenPipeline
    b, s = RT_BATCH
    pipe = TokenPipeline(cfg.vocab, s, b, seed=0)
    return [pipe.batch(i, device) for i in range(RT_STEPS)]


def rt_engine(optical, cfg=None):
    """The engine of a run: none (`optical` False), phase 17(b)'s (True:
    IDEAL, WS, no chip) or, for "chip", WS with the paper's per-shot
    noise and chip RT_CHIP pinned over `cfg`'s MLP projections (22(e)'s
    optical run), its draws keyed on the card."""
    import contextlib
    import torch
    from repro_torch import rosa
    from repro_torch.rosa.backends import RosaConfig
    if not optical:
        return contextlib.nullcontext()
    if optical != "chip":
        return rosa.engine_context(rosa.Engine.from_config(
            RosaConfig(backend="fused")))
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.robust.variation import sample_chip
    chip = sample_chip(torch.Generator().manual_seed(RT_CHIP),
                       {"mlp/wi": cfg.d_model, "mlp/wo": cfg.d_ff},
                       device=DEVICE)
    return rosa.engine_context(rosa.Engine.from_config(
        RosaConfig(noise=mrr.PAPER_NOISE, mapping=Mapping.WS,
                   backend="fused"),
        key=torch.Generator(DEVICE).manual_seed(3)).with_variation(chip))


def step_flops(step, *args):
    """(`step(*args)`, its matmul FLOPs under `FlopCounterMode`)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    return out, counter.get_total_flops()


def rt_one_process(cfg, opt, optical, device=None, start=None,
                   rows=None, flops: bool = False):
    """A one-process run of RT_STEPS steps from seed 0 (or from `start`)
    on `device` (default: the card), the batch rows permuted by `rows`
    when given: (history, params, launches, the first step's matmul FLOPs
    when `flops`, else None); the moments freed."""
    import gc
    import torch
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.model import build_model
    device = device or DEVICE
    bundle = build_model(cfg)
    params = start if start is not None else bundle.init(
        torch.Generator(device).manual_seed(0), device=device)
    state = init_opt_state(params)
    step = make_train_step(bundle, opt)
    hist, f = [], None
    reset_launches()
    with rt_engine(optical, cfg):
        for i, batch in enumerate(rt_batches(cfg, device)):
            if rows is not None:
                batch = {k: v[rows.to(v.device)] for k, v in batch.items()}
            if flops and i == 0:
                (params, state, m), f = step_flops(step, params, state,
                                                   batch)
            else:
                params, state, m = step(params, state, batch)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
    n = launch_counts()
    del state
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return hist, params, n, f


def rt_floor(cfg, opt, optical: bool, side: dict, sizes: dict) -> dict:
    """The float-order floor of a one-process side (`side`: its history
    and its params after the steps on the host): the largest distance from
    it over 2 runs of the same function with both reductions a
    data-parallel split reorders permuted, the params' logical axes
    `sizes` (phase 17(c)'s rule: every sum over them in another order) and
    the batch rows (the sums over rows); per step for the loss and |g|,
    per leaf for the params after the steps (permuted back)."""
    import gc
    import types as _types
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.models.module import leaves, map_tree
    hist = side["hist"]
    floor = {"loss": [0.0] * RT_STEPS, "gn": [0.0] * RT_STEPS,
             "params": {k: 0.0 for k in side["params"]}}
    bundle = build_model(cfg)
    axes = dict(leaves(map_tree(lambda d: d.axes, bundle.skeleton)))
    for seed in (1, 2):
        init = bundle.init(torch.Generator(DEVICE).manual_seed(0),
                           device=DEVICE)
        start, perm = permuted_params(
            _types.SimpleNamespace(bundle=bundle, params=init), sizes, seed)
        del init
        rows = torch.randperm(RT_BATCH[0],
                              generator=torch.Generator().manual_seed(seed))
        ph, pp, _, _ = rt_one_process(cfg, opt, optical, start=start,
                                      rows=rows)
        del start
        for i in range(RT_STEPS):
            for key, j in (("loss", 0), ("gn", 1)):
                floor[key][i] = max(floor[key][i], abs(ph[i][j] - hist[i][j])
                                    / abs(hist[i][j]))
        for p, got in leaves(pp):
            # the base's leaf permuted as this run's
            t = side["params"]["/".join(p)].to(DEVICE)
            for ax, name in enumerate(axes[p]):
                if name in perm:
                    t = t.index_select(ax, perm[name])
            k = "/".join(p)
            floor["params"][k] = max(floor["params"][k], max_rel(got, t))
            del t
        del pp
        gc.collect()
        torch.cuda.empty_cache()
    return floor


def rt_reference(what: str, cfg, opt, optical: bool, sizes: dict,
                 side: dict | None = None) -> dict:
    """A one-process side of a sharded run (RT_STEPS steps from seed 0;
    `side` when a phase already ran it): its history, its params after
    the steps in shared host memory with each leaf's max |.|, and its
    float-order floor (`rt_floor`)."""
    import gc
    import torch
    t0 = time.perf_counter()
    if side is None:
        hist, params, _, flops = rt_one_process(cfg, opt, optical,
                                                flops=True)
        side = dict(rt_share(params), hist=hist, flops=flops)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    floor = rt_floor(cfg, opt, optical, side, sizes)
    hist = side["hist"]
    print(f"  {what}, one process: losses "
          f"{[round(l, 6) for l, _ in hist]}, |g| "
          f"{[round(x, 4) for _, x in hist]}; floor ({', '.join(sizes)} "
          f"and the batch rows permuted, 2 seeds): loss "
          f"{[f'{f:.2e}' for f in floor['loss']]}, |g| "
          f"{[f'{f:.2e}' for f in floor['gn']]}, params up to "
          f"{max(floor['params'].values()):.2e}; "
          + (f"the first step's matmul FLOPs {side['flops']:.4e}; "
             if side.get("flops") else "")
          + f"{time.perf_counter() - t0:.1f} s")
    return dict(side, floor_loss=floor["loss"], floor_gn=floor["gn"],
                floor_params=floor["params"])


def rt_gathered_want(bundle, layout, mesh) -> int:
    """The bytes a rank's gathers hand back in one step, from the specs:
    every leaf with a dim split over an axis other than the step's
    tensor-parallel ones, at its shape whole but for its tensor-parallel
    dims (`local_specs`: its non-"model" shard), once for a top-level
    leaf and twice for a stacked one under remat (the forward and the
    recompute).  Dense and ssm configs (no experts, no zamba2 tail)."""
    from repro_torch.distributed.sharding import (local_shape, local_specs,
                                                  spec_axes, tp_axes,
                                                  use_sharding)
    from repro_torch.models.module import leaves
    cfg = bundle.cfg
    assert cfg.family in ("dense", "ssm") and cfg.moe is None
    with use_sharding(mesh, layout.rules, params=layout.specs,
                      batch_axes=layout.batch_axes):
        keep = tp_axes()
    spec_of = dict(leaves(layout.specs))
    local = dict(leaves(local_specs(layout.specs, lambda path: keep)))
    total = 0
    for p, d in leaves(bundle.skeleton):
        if spec_axes(spec_of[p]) == spec_axes(local[p]):
            continue                    # nothing of it is gathered
        n = math.prod(local_shape(d.shape, local[p], mesh)) * 4
        total += n * (2 if p[0] == "layers" and cfg.remat != "none" else 1)
    return total


@contextlib.contextmanager
def counting_drops():
    """Within it `moe._pack_local` adds each call's dropped assignments
    (the rank's routed to its experts past their capacity) to a tensor
    on the call's device, so a timed step syncs nothing for them.  Yields
    `take()`, which reads the sum once and starts it again from 0."""
    from repro_torch.models import moe as MOE
    real, total = MOE._pack_local, [0]

    def counting(x2, w, ids, first, count, cap):
        res = real(x2, w, ids, first, count, cap)
        total[0] = total[0] + (((ids >= first) & (ids < first + count))
                               .sum() - res[2].sum())
        return res

    def take() -> int:
        n, total[0] = total[0], 0
        return int(n)
    MOE._pack_local = counting
    try:
        yield take
    finally:
        MOE._pack_local = real


def rt_rank(rank: int, world: int, device, job: dict) -> dict:
    """One rank of a 22 group: each of `job["runs"]` (its config, schedule
    and whether optical, on its `mesh` or the job's) on this rank's
    shards and rows, from seed 0, against `want`, whole params after the
    same steps in shared host memory (each rank reads its shards); with a
    `sink` (shared whole tensors) the rank writes its final shards there.
    It counts the first step's matmul FLOPs, the bytes its gathers hand
    back (`sharding.GATHERED`) and the heads of its scans and the (K, N)
    of its `rosa_fused` calls.  Hands back host values only."""
    import gc
    import torch
    rank_setup(device)
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.sharding import shard_local
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (init_opt_state, init_sharded,
                                          make_train_step, train_layout)
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import build_model
    from repro_torch.models.module import leaves
    meshes: dict = {}
    rank_device = device
    out = {}
    # the operands the model hands the two kernels' wrappers
    shapes: dict = {}
    real_ssd, real_fused = SSM.ssd_scan, fused_ops.rosa_fused

    def ssd_scan(x, *a, **k):
        shapes.setdefault("ssd_scan_heads", set()).add(int(x.shape[2]))
        return real_ssd(x, *a, **k)

    def rosa_fused(x, w, *a, **k):
        shapes.setdefault("rosa_fused_kn", set()).add(
            (int(x.shape[1]), int(w.shape[1])))
        return real_fused(x, w, *a, **k)
    SSM.ssd_scan, fused_ops.rosa_fused = ssd_scan, rosa_fused
    draws = rt_count_draws()
    for run in job["runs"]:
        shape = tuple(run.get("mesh") or job["mesh"])
        if shape not in meshes:
            meshes[shape] = make_test_mesh(*shape, rank_device.type)
        mesh = meshes[shape]
        # a run may name the CPU: the same ranks and mesh, host tensors
        device = torch.device(run.get("device") or rank_device)
        threads = torch.get_num_threads()
        if device.type == "cpu":
            torch.set_num_threads(2)
        cfg = run["cfg"]
        bundle = build_model(cfg)
        layout = train_layout(bundle, mesh, RT_BATCH[0])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        if run.get("start") is not None:
            from repro_torch.distributed.sharding import shard_tree
            from repro_torch.models.module import unflatten
            params = shard_tree(unflatten(
                (tuple(k.split("/")), v)
                for k, v in host_views(run["start"]).items()),
                layout.specs, mesh, device=device)
        else:
            params = init_sharded(bundle, torch.Generator(device)
                                  .manual_seed(0), layout, device=device)
        state = init_opt_state(params)
        held = sum(t.numel() * t.element_size()
                   for _, t in leaves({"params": params, "opt": state}))
        want_bytes = 3 * layout.shard_bytes(bundle.skeleton) + 4
        step = make_train_step(bundle, rt_opt(run["opt"]), layout=layout)
        batches = [layout.local_batch(b) for b in
                   rt_batches(cfg, device)]
        set_up = time.perf_counter() - t0
        hist, walls, busy, flops = [], [], None, None
        # ---- the main path: counts from 0, read right after --------------
        reset_launches()
        SH.GATHERED["bytes"] = 0
        shapes.clear()
        draws.clear()
        with counting_drops() as take_drops, rt_engine(run["optical"], cfg):
            for i, batch in enumerate(batches):
                ts = time.perf_counter()
                if i == len(batches) - 1 and device.type == "cuda":
                    from torch.profiler import (ProfilerActivity,
                                                profile)
                    with profile(activities=[ProfilerActivity.CUDA]) \
                            as prof:
                        params, state, m = step(params, state, batch)
                        loss = float(m["loss"])
                    busy = rt_busy(prof)
                elif i == 0:
                    (params, state, m), flops = step_flops(
                        step, params, state, batch)
                    loss = float(m["loss"])
                else:
                    params, state, m = step(params, state, batch)
                    loss = float(m["loss"])
                hist.append((loss, float(m["grad_norm"])))
                walls.append(time.perf_counter() - ts)
            drops = take_drops()
        n = launch_counts()
        gathered = SH.GATHERED["bytes"]
        gathered_want = (rt_gathered_want(bundle, layout, mesh) * len(batches)
                         if run.get("gathers") else None)
        ckpt = rt_ckpt(run["ckpt"], params, layout, mesh) \
            if run.get("ckpt") else None
        # the rank's shards against `want` after the same steps
        spec_of = dict(leaves(layout.specs))
        dev = {}
        sink = host_views(run["sink"]) if run.get("sink") else None
        wants = host_views(run["want"]) if run.get("want") else None
        for p, t in leaves(params):
            k = "/".join(p)
            if sink is not None:
                shard_local(sink[k], spec_of[p], mesh).copy_(t)
            if wants is not None:
                want = shard_local(wants[k], spec_of[p], mesh).to(device)
                dev[k] = float((t.float() - want.float()).abs().max())
                del want
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        out[run["name"]] = {
            "hist": hist, "walls": walls, "busy_ms": busy, "set_up_s": set_up,
            "launches": n, "held": held, "want_bytes": want_bytes,
            "dev": dev, "peak_bytes": peak, "drops": drops,
            "rows": layout.rows(), "ckpt": ckpt, "flops": flops,
            "gathered": gathered, "gathered_want": gathered_want,
            "shapes": {k: sorted(v) for k, v in shapes.items()},
            "draws": dict(draws)}
        del params, state, step, sink, wants
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        torch.set_num_threads(threads)
    SSM.ssd_scan, fused_ops.rosa_fused = real_ssd, real_fused
    return out


def rt_ckpt(root: str, params, layout, mesh) -> dict:
    """22(a)'s checkpoint on a rank: its param shards saved from the
    ranks (each leaf gathered whole, rank 0 writes the one-process file)
    and restored onto them (to the host: the card holds no second copy);
    the restored shards against the held ones, bit for bit."""
    import torch
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.models.module import leaves
    tree, specs = {"params": params}, {"params": layout.specs}
    t0 = time.perf_counter()
    CK.save(root, RT_STEPS, tree, {"phase": "22(a)"}, specs=specs,
            mesh=mesh)
    t1 = time.perf_counter()
    back = CK.restore(root, RT_STEPS, tree, "cpu", specs=specs, mesh=mesh)
    t2 = time.perf_counter()
    equal = all(torch.equal(a, b.cpu()) for (_, a), (_, b)
                in zip(leaves(back), leaves(tree), strict=True))
    return {"save_s": t1 - t0, "restore_s": t2 - t1, "equal": equal}


def rt_ckpt_check(root, outs: list, side: dict) -> dict:
    """22(a)'s checkpoint, checked here: the one-process layout (every key
    of the params, whole shapes) and every rank's restored shards equal to
    its held ones, which `rt_check` holds to the one-process params (so
    the file holds them within the same bound)."""
    import os
    from repro_torch.checkpoint import checkpoint as CK
    meta = CK.read_meta(root, RT_STEPS)
    want = {f"params/{k}": v for k, v in side["params"].items()}
    bad = []
    if sorted(meta["keys"]) != sorted(want) or any(
            meta["shapes"][k] != list(v.shape) for k, v in want.items()):
        bad.append("the file's keys or shapes are not the one-process "
                   "layout")
    size = os.path.getsize(os.path.join(root, f"step_{RT_STEPS:08d}",
                                        "arrays.npz"))
    cks = [o["plain"]["ckpt"] for o in outs]
    if not all(c["equal"] for c in cks):
        bad.append("a rank's restored shards differ from its held ones")
    res = {"bytes": size, "save_s": max(c["save_s"] for c in cks),
           "restore_s": max(c["restore_s"] for c in cks)}
    print(f"  22(a) checkpoint: {size / 2**30:.2f} GiB of params saved from "
          f"the ranks in {res['save_s']:.1f} s (the one-process layout), "
          f"restored onto them in {res['restore_s']:.1f} s, equal to the "
          "held shards bit for bit")
    if bad:
        raise AssertionError("22(a) checkpoint: " + "; ".join(bad))
    return res


def rt_check(what: str, ref: dict, outs: list, want_launches: dict,
             key: str) -> dict:
    """A sharded run's gates: every rank's losses and |g| within 4x the
    one-process floor of the one-process run's (plus 1e-6 relative), its
    shards of every leaf within 4x that leaf's floor (plus 1e-6 of its
    max), its bytes its TRAIN_RULES shards', its launches exactly
    `want_launches`."""
    rel = {}
    for r, o in enumerate(outs):
        res = o[key]
        if res["held"] != res["want_bytes"]:
            raise AssertionError(f"{what}: rank {r} holds {res['held']} "
                                 f"bytes of params and moments, its "
                                 f"TRAIN_RULES shards {res['want_bytes']}")
        for i, ((l, gn), (wl, wg)) in enumerate(zip(res["hist"],
                                                     ref["hist"])):
            for name, got, want, fl in (("loss", l, wl, ref["floor_loss"][i]),
                                        ("|g|", gn, wg, ref["floor_gn"][i])):
                d = abs(got - want) / abs(want)
                if d > 4 * fl + 1e-6:
                    raise AssertionError(
                        f"{what}: rank {r} step {i} {name} {got} vs one "
                        f"process {want} (rel {d:.2e}, floor {fl:.2e})")
        for k, d in res["dev"].items():
            rel[k] = max(rel.get(k, 0.0), d / ref["amax"][k])
        others = {n: v for n, v in res["launches"].items()
                  if v and n not in want_launches}
        if any(res["launches"][n] != v for n, v in want_launches.items()) \
                or others:
            raise AssertionError(f"{what}: rank {r} launched "
                                 f"{res['launches']}, want {want_launches}")
    bad = [k for k, d in rel.items()
           if d > 4 * ref["floor_params"][k] + 1e-6]
    worst = max(rel, key=lambda k: rel[k] / (4 * ref["floor_params"][k]
                                             + 1e-6))
    print(f"  {what}: losses {[round(l, 6) for l, _ in outs[0][key]['hist']]}"
          f", |g| {[round(g, 4) for _, g in outs[0][key]['hist']]}; the "
          f"leaf nearest its bound {worst} at {rel[worst]:.2e} (floor "
          f"{ref['floor_params'][worst]:.2e}); launches a rank "
          f"{ {n: v for n, v in outs[0][key]['launches'].items() if v} }; "
          f"bytes a rank {outs[0][key]['held'] / 2**30:.3f} GiB = its "
          "TRAIN_RULES shards")
    if bad:
        raise AssertionError(f"{what}: params beyond 4x their floor: {bad}")
    return rel


def rt_busy(prof) -> tuple[float, float]:
    """(kernels, copies) ms of a profiled run's device time: the copies
    are the collectives' host staging."""
    kern = copy = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or evt.device_type.name != "CUDA":
            continue
        if evt.key.startswith(("Memcpy", "Memset")):
            copy += dev_us / 1e3
        else:
            kern += dev_us / 1e3
    return kern, copy


def rt_summary(what: str, outs: list, key: str, parent: int) -> dict:
    """Walls, s a step, the card's busy share (every rank's kernel time in
    the profiled last step over its wall; the copies' beside it) and the
    peaks."""
    runs = [o[key] for o in outs]
    step_s = max(r["walls"][-1] for r in runs)
    kern = sum((r["busy_ms"] or (0.0, 0.0))[0] for r in runs) / 1e3
    copy = sum((r["busy_ms"] or (0.0, 0.0))[1] for r in runs) / 1e3
    share = kern / step_s if step_s > 0 else 0.0
    copy_share = copy / step_s if step_s > 0 else 0.0
    peak = (max(r["peak_bytes"] for r in runs) if RANK_CARDS else
            sum(r["peak_bytes"] for r in runs)) + parent
    print(f"  {what}: {step_s:.3f} s a step (the last, profiled; first "
          f"{max(r['walls'][0] for r in runs):.3f} s), set-up "
          f"{max(r['set_up_s'] for r in runs):.1f} s, the card's kernels "
          f"{100 * share:.1f} % of it (host copies {100 * copy_share:.1f} "
          f"%), peak {peak / 2**30:.2f} GiB a card "
          "(ranks " + ", ".join(f"{r['peak_bytes'] / 2**30:.2f}"
                                for r in runs) + ")")
    if peak >= PEAK_GIB * 2**30:
        raise AssertionError(f"{what}: peak {peak / 2**30:.1f} GiB")
    return {"step_s": step_s, "first_step_s": max(r["walls"][0]
                                                  for r in runs),
            "busy_share": share, "copy_share": copy_share,
            "peak_gib": peak / 2**30,
            "rank_peak_gib": [r["peak_bytes"] / 2**30 for r in runs],
            "hist": runs[0]["hist"], "drops": [r["drops"] for r in runs]}


def rt_group(mesh: tuple, runs: list, device_type: str = None) -> tuple:
    import torch
    from repro_torch.distributed import runtime
    t0 = time.perf_counter()
    device_type = device_type or DEVICE
    outs = runtime.spawn(rt_rank, mesh[0] * mesh[1], device_type=device_type,
                         backend=rank_backend(),
                         args=({"mesh": mesh, "runs": runs},),
                         timeout=RANK_TIMEOUT)
    return outs, time.perf_counter() - t0


def rt_qwen(report: dict) -> int:
    """22(a) and (e); returns their rosa_fused launches (every rank's).  The
    one-process sides: a plain run here and phase 17(b)'s fused run (the
    same model, schedule and batches), and for 22(e)'s optical run a
    noisy one with chip RT_CHIP (`rt_chip_side`); the floors: `rt_floor`'s
    (the hidden and MLP axes and the batch rows permuted) and, for the
    optical runs, at least 17(b)'s k-permuted ones (its "ref" runs with
    each optical product's reduction axis permuted, two seeds)."""
    import shutil
    import torch
    arch, layers, mesh = RT_QWEN
    n = mesh[0] * mesh[1]
    t_phase = time.perf_counter()
    if layers != TRAIN[1] or RT_STEPS != OPT_STEPS or "optical" not in RT_SIDE:
        raise AssertionError("22(a) reads phase 17(b)'s run at its depth "
                             "and steps")
    cfg = rt_cfg(arch, layers)
    sizes = {"embed": cfg.d_model, "mlp": cfg.d_ff}
    sides = {"plain": rt_reference("22(a) plain", cfg, rt_opt(RT_QWEN_OPT),
                                   False, sizes)}
    opt_side = rt_reference(
        "22(a) optical", rt_cfg(arch, layers, rosa_mlp=True),
        rt_opt(RT_QWEN_OPT), True, sizes,
        side=dict(RT_SIDE["optical"], hist=RT_SIDE["optical_hist"]))
    k = RT_SIDE["floor"]
    print("  22(a) optical: 17(b)'s k-permuted floor: loss "
          f"{[f'{f:.2e}' for f in k['loss']]}, |g| "
          f"{[f'{f:.2e}' for f in k['gn']]}, params up to "
          f"{max(k['params'].values()):.2e}")
    opt_side["floor_loss"] = [max(a, b) for a, b in
                              zip(opt_side["floor_loss"], k["loss"])]
    opt_side["floor_gn"] = [max(a, b) for a, b in
                            zip(opt_side["floor_gn"], k["gn"])]
    opt_side["floor_params"] = {
        p: max(v, k["params"].get(p, 0.0))
        for p, v in opt_side["floor_params"].items()}
    sides["optical"] = opt_side
    sides["chip"] = rt_chip_side(rt_cfg(arch, layers, rosa_mlp=True),
                                 opt_side)
    ckpt = ROOT / "build" / "ckpt-22a"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = [{"name": name, "cfg": rt_cfg(arch, layers, rosa_mlp=optical),
             "opt": RT_QWEN_OPT, "optical": optical,
             "want": sides[name]["block"], "gathers": True}
            for name, optical in (("plain", False), ("optical", True))]
    # 22(e): the same runs over 2 model ranks in the same group (its mesh
    # a run's own), the optical one with chip RT_CHIP and per-shot noise,
    # each held to its one-process side
    runs += [dict(runs[0], name="plain_split", mesh=RT_QWEN_SPLIT),
             dict(runs[1], name="chip_split", mesh=RT_QWEN_SPLIT,
                  optical="chip", want=sides["chip"]["block"])]
    runs[0]["ckpt"] = str(ckpt)
    parent = torch.cuda.memory_allocated()
    print(f"  22(a): {rank_layout(n)}, mesh (data, model) {mesh}; "
          f"{arch} full width, {layers} layers, batch {RT_BATCH}; then "
          f"22(e): the same on {RT_QWEN_SPLIT}, heads, MLP and vocab split")
    outs, wall = rt_group(mesh, runs)
    launches = 0
    res = {"group_s": wall}
    fails = []
    for r in runs:
        base = r["name"].removesuffix("_split")
        tag = "22(e)" if "mesh" in r else "22(a)"
        ref = sides[base]
        res[r["name"]] = dict(rt_summary(f"{tag} {base}", outs,
                                         r["name"], parent),
                              one_process=ref["hist"])
        # 2 projections x (forward + remat recompute) x layers x steps
        want = ({"rosa_fused": 2 * 2 * layers * RT_STEPS} if r["optical"]
                else {})
        try:
            rel = rt_check(f"{tag} {base}", ref, outs, want, r["name"])
            res[r["name"]]["worst_leaf_rel"] = max(rel.values())
        except AssertionError as e:
            fails.append(str(e))
        try:
            res[r["name"]].update(rt_split_check(
                tag, r, outs, ref.get("flops") if not r["optical"]
                else sides["plain"]["flops"], r.get("mesh") or mesh,
                gate_flops=tag == "22(e)" and not r["optical"]))
        except AssertionError as e:
            fails.append(str(e))
        if r["optical"]:
            launches += sum(o[r["name"]]["launches"]["rosa_fused"]
                            for o in outs)
    cfg = runs[0]["cfg"]
    kn = {(cfg.d_model, cfg.d_ff), (cfg.d_ff // 2, cfg.d_model)}
    for o in outs:
        got = {tuple(x) for x in
               o["chip_split"]["shapes"].get("rosa_fused_kn", [])}
        if got != kn:
            fails.append(f"22(e) chip: rosa_fused launched at (K, N) "
                         f"{sorted(got)}, want {sorted(kn)}")
    for base, name in (("plain", "plain_split"), ("optical", "chip_split")):
        split = max(o[name]["peak_bytes"] for o in outs)
        whole = min(o[base]["peak_bytes"] for o in outs)
        print(f"  22(e) {name}: peak a rank {split / 2**30:.2f} GiB against "
              f"22(a)'s {whole / 2**30:.2f}")
        if split >= whole:
            fails.append(f"22(e) {name}: a rank's peak {split} is not below "
                         f"22(a)'s {whole}")
    print(f"  22(e) chip: rosa_fused at (K, N) {sorted(kn)} on every rank")
    for r, o in enumerate(outs):
        if o["chip_split"]["draws"] != sides["chip"]["draws"]:
            fails.append(f"22(e) chip: rank {r} drew pairs "
                         f"{o['chip_split']['draws']}, one process "
                         f"{sides['chip']['draws']}")
    print("  22(e) chip: every rank's draw pairs at the whole weights' "
          f"shapes, as one process's: {outs[0]['chip_split']['draws']}")
    try:
        res["ckpt"] = rt_ckpt_check(str(ckpt), outs, sides["plain"])
    except AssertionError as e:
        fails.append(str(e))
    shutil.rmtree(ckpt, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  22(a) and (e): the group {wall:.1f} s, the sub-phases "
          f"{res['phase_s']:.1f} s")
    report["train_ranks_a"] = res
    for r in runs:
        r.pop("want")
    RT_SIDE.clear()
    for side in sides.values():
        host_free(side)
    if fails:
        raise AssertionError("; ".join(fails))
    return launches


def rt_count_draws() -> dict:
    """Count the per-shot draw pairs the noisy chain makes from here on,
    by shape ({shape: n}; `mrr._eps_pair` wrapped): a split rank's are
    made at the whole operand's shape."""
    from repro_torch.core import mrr
    counts: dict = {}
    real = mrr._eps_pair

    def eps_pair(key, shape, *a, **k):
        shape = tuple(int(n) for n in shape)
        counts[shape] = counts.get(shape, 0) + 1
        return real(key, shape, *a, **k)
    mrr._eps_pair = eps_pair
    return counts


def rt_chip_side(cfg, ideal: dict) -> dict:
    """22(e)'s optical side: one process, RT_STEPS steps of `cfg` with
    chip RT_CHIP pinned and per-shot noise (`rt_engine("chip")`), shared
    as `rt_share` does, with its draw pairs by shape (`rt_count_draws`);
    its floors those of the same run without noise (`ideal`: the same
    products summed in the same orders, the draws the same numbers on
    every layout).  Gates: its rosa_fused launches, and a draw pair at
    each MLP weight's whole shape for each of those launches."""
    import gc
    import torch
    from repro_torch.core import mrr
    t0 = time.perf_counter()
    real = mrr._eps_pair
    draws = rt_count_draws()
    try:
        hist, params, n, _ = rt_one_process(cfg, rt_opt(RT_QWEN_OPT),
                                            "chip")
    finally:
        mrr._eps_pair = real
    side = dict(rt_share(params), hist=hist, floor_loss=ideal["floor_loss"],
                floor_gn=ideal["floor_gn"], floor_params=ideal["floor_params"],
                draws=dict(draws))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    want = 2 * 2 * cfg.n_layers * RT_STEPS
    whole = {(cfg.d_model, 2 * cfg.d_ff): want // 2,
             (cfg.d_ff, cfg.d_model): want // 2}
    print(f"  22(e) chip, one process: chip {RT_CHIP}, per-shot noise, WS; "
          f"losses {[round(l, 6) for l, _ in hist]}, |g| "
          f"{[round(x, 4) for _, x in hist]} (without noise "
          f"{[round(l, 6) for l, _ in ideal['hist']]}, "
          f"{[round(x, 4) for _, x in ideal['hist']]}); rosa_fused "
          f"{n['rosa_fused']}; draw pairs by shape {side['draws']}; "
          f"{time.perf_counter() - t0:.1f} s")
    if n["rosa_fused"] != want or side["draws"] != whole:
        raise AssertionError(f"22(e) chip, one process: rosa_fused "
                             f"{n['rosa_fused']}, want {want}; draw pairs "
                             f"{side['draws']}, want {whole}")
    return side


def rt_split_check(tag: str, run: dict, outs: list, one_flops, mesh,
                   gate_flops: bool) -> dict:
    """A run's split gates on every rank: the bytes its gathers handed
    back equal its non-"model" shards' from the specs exactly, and (when
    `gate_flops`) its first step's matmul FLOPs are 1 / (data x model) of
    the one-process step's within `RT_FLOPS_TOL`; printed."""
    key = run["name"]
    share = 1.0 / (mesh[0] * mesh[1])
    got = [o[key]["gathered"] for o in outs]
    want = [o[key]["gathered_want"] for o in outs]
    flops = [o[key]["flops"] for o in outs]
    ratio = [f / one_flops for f in flops] if one_flops else None
    print(f"  {tag} {key}: gathered {got[0] / 2**30:.3f} GiB a rank over "
          f"{RT_STEPS} steps (its non-\"model\" shards from the specs: "
          f"{want[0] / 2**30:.3f}); the first step's matmul FLOPs a rank "
          f"{flops[0]:.4e}" + (f", {ratio[0]:.4f} of the one-process "
                               f"step's (1/{mesh[0] * mesh[1]} = "
                               f"{share:.4f})" if ratio else ""))
    if got != want:
        raise AssertionError(f"{tag} {key}: gathered bytes {got} a rank, "
                             f"its non-model shards {want}")
    if gate_flops and any(abs(r / share - 1.0) > RT_FLOPS_TOL[tag]
                          for r in ratio):
        raise AssertionError(f"{tag} {key}: a rank's FLOPs {ratio} of the "
                             f"one-process step's, want {share:.4f} within "
                             f"{100 * RT_FLOPS_TOL[tag]:.0f} %")
    return {"gathered_bytes": got[0], "flops": flops[0],
            "flops_share": ratio[0] if ratio else None}


def rt_mamba(report: dict) -> dict:
    """22(b), and 22(d) in the same group of ranks (its runs after 22(b)'s:
    the CPU one, then the card one); returns 22(b)'s ssd_scan launches
    (every rank's)."""
    import torch
    arch, layers, mesh = RT_MAMBA
    n = mesh[0] * mesh[1]
    t_phase = time.perf_counter()
    cfg = rt_cfg(arch, layers)
    ref = rt_reference("22(b)", cfg, rt_opt(RT_MAMBA_OPT), False,
                       {"embed": cfg.d_model, "heads": cfg.ssm.n_heads})
    cli = report.get(f"ssm_train_{arch}", {}).get("history")
    if cli is not None:
        same = all(abs(h["loss"] - l) == 0 and abs(h["grad_norm"] - g) == 0
                   for h, (l, g) in zip(cli, ref["hist"]))
        print(f"  22(b): phase 19(b)'s first {RT_STEPS} steps "
              + ("equal" if same else "differ from")
              + " this one-process side bit for bit")
    moe = rt_moe_sides()
    assert RT_MOE[1] == mesh, "22(d) runs in 22(b)'s group"
    runs = [{"name": "mamba", "cfg": cfg, "opt": RT_MAMBA_OPT,
             "optical": False, "want": ref["block"], "gathers": True}
            ] + moe["runs"]
    parent = torch.cuda.memory_allocated()
    print(f"  22(b): {rank_layout(n)}, mesh (data, model) {mesh}; {arch} "
          f"full width and depth, batch {RT_BATCH}; then 22(d)'s runs")
    outs, wall = rt_group(mesh, runs)
    # phase 19's formula at a rank's rows: one launch a layer whatever
    # the rows, the forward twice under remat "full"
    want = {"ssd_scan": 2 * cfg.n_layers * RT_STEPS,
            "ssd_scan_bwd": cfg.n_layers * RT_STEPS}
    res = dict(rt_summary("22(b)", outs, "mamba", parent), group_s=wall,
               one_process=ref["hist"], floor_loss=ref["floor_loss"],
               floor_gn=ref["floor_gn"])
    report["train_ranks_b"] = res
    for r in runs:
        r.pop("want", None)
    host_free(ref)
    fails = []
    try:
        rel = rt_check("22(b)", ref, outs, want, "mamba")
        res["worst_leaf_rel"] = max(rel.values())
    except AssertionError as e:
        fails.append(str(e))
    try:
        res.update(rt_split_check("22(b)", runs[0], outs, ref["flops"],
                                  mesh, gate_flops=True))
    except AssertionError as e:
        fails.append(str(e))
    heads = [o["mamba"]["shapes"].get("ssd_scan_heads") for o in outs]
    print(f"  22(b): ssd_scan at {heads[0]} heads a rank of the model's "
          f"{cfg.ssm.n_heads}")
    if any(h != [cfg.ssm.n_heads // mesh[1]] for h in heads):
        fails.append(f"22(b): ssd_scan launched at {heads} heads, want "
                     f"{cfg.ssm.n_heads // mesh[1]} on every rank")
    res["scan_heads"] = heads[0]
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  22(b) and (d): the group {wall:.1f} s, the sub-phases "
          f"{res['phase_s']:.1f} s")
    try:
        rt_moe_check(report, moe, outs)
    except AssertionError as e:
        fails.append(str(e))
    if fails:
        raise AssertionError("; ".join(fails))
    return {k: sum(o["mamba"]["launches"][k] for o in outs) for k in want}


def rt_elastic_start() -> dict:
    """22(c), started: one process writes step 4 and a one-process
    continuation runs to step 6, in this process; then `--devices 4
    --data-axis 2 --resume` from the same checkpoint starts in a
    subprocess (its ranks on the card) and runs beside 22(a) and (b): its
    processes spend their time starting up, the card's work is small."""
    import os
    import shutil
    from repro_torch.launch import train
    t0 = time.perf_counter()
    d = ROOT / "build" / "ckpt-22c"
    shutil.rmtree(d, ignore_errors=True)
    first, last = ELASTIC_STEPS
    base = ELASTIC_CLI + ["--device", DEVICE, "--ckpt-dir", str(d),
                          "--steps", str(last)]
    train.run(train.build_parser().parse_args(
        base[:-1] + [str(first), "--ckpt-every", str(first)]))
    one = train.run(train.build_parser().parse_args(
        base + ["--resume", "--ckpt-every", "100"]))["history"]
    out = open(d / "ranks.out", "w")
    err = open(d / "ranks.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *base,
         "--resume", "--ckpt-every", "100", "--devices", "4",
         "--data-axis", "2"] + (["--cards"] if RANK_CARDS else []),
        stdout=out, stderr=err, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return {"proc": proc, "files": (out, err), "dir": d, "one": one,
            "t0": t0, "own_s": time.perf_counter() - t0}


def rt_elastic_finish(job: dict, report: dict) -> None:
    """22(c), checked: 'resumed from step 4' printed once by the 4-rank
    resume, its losses within 6e-5 (plus the CLI's 4-decimal rounding) of
    the one-process continuation."""
    import shutil
    first, last = ELASTIC_STEPS
    rc = job["proc"].wait(timeout=RANK_TIMEOUT)
    for f in job["files"]:
        f.close()
    stdout = (job["dir"] / "ranks.out").read_text()
    if rc != 0:
        raise AssertionError(f"22(c): the 4-rank resume exited {rc}:\n"
                             f"{stdout[-3000:]}\n"
                             f"{(job['dir'] / 'ranks.err').read_text()[-3000:]}")
    lines = stdout.splitlines()
    if sum(f"resumed from step {first}" in ln for ln in lines) != 1:
        raise AssertionError(f"22(c): 'resumed from step {first}' not "
                             f"printed once:\n{stdout[-2000:]}")
    got = [float(ln.split("loss")[1].split()[0]) for ln in lines
           if ln.startswith("step")]
    want = [h["loss"] for h in job["one"]]
    dev = [abs(g - w) for g, w in zip(got, want)]
    wall = time.perf_counter() - job["t0"]
    print(f"  22(c): 1 process to step {first}, then --devices 4 "
          f"--data-axis 2 --resume: 'resumed from step {first}' once; "
          f"losses {got} vs the one-process continuation "
          f"{[round(w, 6) for w in want]} (|dev| {[f'{x:.1e}' for x in dev]}"
          f"); its own {job['own_s']:.1f} s in this process, done "
          f"{wall:.1f} s after its start")
    if len(got) != last - first or any(x > ELASTIC_ATOL + 5e-5
                                       for x in dev):
        raise AssertionError(f"22(c): resumed losses {got} vs {want}")
    report["train_ranks_c"] = {"losses": got, "one_process": want,
                               "own_s": job["own_s"], "wall_s": wall}
    shutil.rmtree(job["dir"], ignore_errors=True)


def rt_moe_sides() -> dict:
    """22(d)'s one-process sides and runs: qwen3-moe-235b-a22b-smoke with
    `moe_ep_local` in the train step, the same ranks on the CPU (writing
    their params after the steps into a shared block) and then on the
    card, both from the card's draws (a CPU generator draws others); the
    floor: the card-vs-CPU distance of the same config's one-process
    steps (`moe_ref`)."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.models.module import leaves, map_tree
    arch, _ = RT_MOE
    cfg = rt_cfg(arch, 0, smoke=True, moe_ep=True)
    opt = (3e-4, 2, RT_STEPS)
    init = build_model(cfg).init(torch.Generator(DEVICE).manual_seed(0),
                                 device=DEVICE)
    start = rt_share(init)
    hc, pc, _, _ = rt_one_process(cfg, rt_opt(opt), False,
                                  start=map_tree(torch.clone, init))
    hh, ph, _, _ = rt_one_process(cfg, rt_opt(opt), False, "cpu",
                                  start=map_tree(lambda t: t.cpu(), init))
    floor = {"loss": [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(hc, hh)],
             "gn": [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(hc, hh)],
             "params": {"/".join(p): max_rel(a.cpu(), b) for (p, a), (_, b)
                        in zip(leaves(pc), leaves(ph), strict=True)}}
    sink = rt_share(ph)                 # the CPU run's params land here
    base = {"cfg": cfg, "opt": opt, "optical": False,
            "start": start["block"]}
    return {"floor": floor, "start": start, "sink": sink,
            "runs": [dict(base, name="moe_cpu", device="cpu",
                          sink=sink["block"]),
                     dict(base, name="moe", want=sink["block"])]}


def rt_moe_check(report: dict, moe: dict, outs: list) -> None:
    """22(d)'s gates: the card run's losses and |g| against the CPU run's,
    and its shards of every leaf against the CPU run's params, within 4x
    the card-vs-CPU floor plus 1e-6; the dropped assignments printed."""
    arch, mesh = RT_MOE
    floor = moe["floor"]
    a, b = outs[0]["moe"], outs[0]["moe_cpu"]
    fails = []
    for i, ((l, g), (wl, wg)) in enumerate(zip(a["hist"], b["hist"])):
        for name, x, y, fl in (("loss", l, wl, floor["loss"][i]),
                               ("|g|", g, wg, floor["gn"][i])):
            if abs(x - y) / abs(y) > 4 * fl + 1e-6:
                fails.append(f"step {i} {name} card {x} vs CPU {y} "
                             f"(floor {fl:.2e})")
    views = moe["sink"]["params"]
    rel = {k: max(o["moe"]["dev"][k] for o in outs)
           / float(views[k].abs().max()) for k in a["dev"]}
    del views
    for r in moe["runs"]:
        for k in ("start", "sink", "want"):
            r.pop(k, None)
    host_free(moe["sink"])
    host_free(moe["start"])
    bad = [k for k, d in rel.items() if d > 4 * floor["params"][k] + 1e-6]
    worst = max(rel, key=lambda k: rel[k] / (4 * floor["params"][k] + 1e-6))
    drops = [o["moe"]["drops"] for o in outs]
    drops_cpu = [o["moe_cpu"]["drops"] for o in outs]
    walls = [max(sum(o[k]["walls"]) for o in outs) for k in ("moe", "moe_cpu")]
    print(f"  22(d): {arch}-smoke, moe_ep_local in the train step, 4 ranks "
          f"{mesh}: card losses {[round(l, 6) for l, _ in a['hist']]}, "
          f"CPU {[round(l, 6) for l, _ in b['hist']]} (floor "
          f"{[f'{f:.1e}' for f in floor['loss']]}); the leaf nearest its "
          f"bound {worst} at {rel[worst]:.2e} (floor "
          f"{floor['params'][worst]:.2e}); dropped assignments a rank over "
          f"the forward passes and recomputations: card {drops}, CPU "
          f"{drops_cpu}; steps {walls[0]:.1f} s on the card, "
          f"{walls[1]:.1f} s on the CPU")
    report["train_ranks_d"] = {"card": a["hist"], "cpu": b["hist"],
                               "drops": drops, "drops_cpu": drops_cpu,
                               "worst_leaf_rel": rel[worst],
                               "steps_s": walls}
    if bad:
        fails.append(f"leaves beyond 4x the floor: {bad}")
    if fails:
        raise AssertionError("22(d): " + "; ".join(fails))


def train_ranks_phase(report: dict) -> dict:
    """22: training across ranks; returns the main paths' launches
    (22(a)'s and 22(e)'s rosa_fused, 22(b)'s ssd_scan and its backward,
    every rank's)."""
    import gc
    import torch
    t0 = time.perf_counter()
    print("phase 22(c): the elastic restart through the CLI, started")
    elastic = rt_elastic_start()
    try:
        print("phase 22(a): qwen3-32b across 2 data ranks, plain and "
              "optical; 22(e): across 2 model ranks, plain and optical with "
              "chip 7 and per-shot noise, in the same group")
        n = {"rosa_fused": rt_qwen(report)}
        gc.collect()
        torch.cuda.empty_cache()
        print("phase 22(b): mamba2-1.3b across 4 ranks, full width and "
              "depth; 22(d): qwen3-moe-235b-a22b-smoke, experts over ranks "
              "in the train step, card vs CPU, in the same group")
        n.update(rt_mamba(report))
        gc.collect()
        torch.cuda.empty_cache()
        print("phase 22(c): the elastic restart, checked")
        rt_elastic_finish(elastic, report)
    finally:
        if elastic["proc"].poll() is None:
            elastic["proc"].kill()
            elastic["proc"].wait()
    report["train_ranks_s"] = time.perf_counter() - t0
    return n


# ---------------------------------------------------------------------------
# Phase 23: serving under SERVE_RULES across ranks
# ---------------------------------------------------------------------------
SR_STEPS = 3                   # each decode cell's steps, teacher-forced
SR_SEED = 23                   # the prompts', tokens' and caches' seed
SR_PARAM_SEED = 24             # the params' blocks' seeds
SR_ROWS = 8                    # an ssm decode cache's rows compared: every 8th
SR_CHIP = 7                    # (a)'s served chip
# (tag, arch, layers (0: all), ModelConfig overrides, (data, model),
# ShapeSpec fields): (a) qwen3-32b's optical MLPs (chip 7, "fused") at
# decode_32k (128 rows cut to 32: the one-process side holds 8.6 GB of
# cache and its float32 copy) and prefill_32k (32 x 32768 cut to 2 x
# 4096: the scores are (B, H, S, S) float32); (b) gemma3-12b's
# long_500k at 6 of 48 layers (one global) on (4, 1): on (2, 2)
# SERVE_RULES gives the KV heads "model" and the sequence no axis (every
# suffix of its rule holds "model"), so a rank holds half of the 25.8 GB
# cache and four of them do not fit one card; (c) mamba2-1.3b at full
# width and depth
SR_CELLS = (
    ("a decode", "qwen3-32b", 2, {"rosa_mlp": True}, (2, 2),
     ("decode_32k", "decode", 32768, 32)),
    ("a prefill", "qwen3-32b", 2, {"rosa_mlp": True}, (2, 2),
     ("prefill_32k", "prefill", 4096, 2)),
    ("b long", "gemma3-12b", 6, {}, (4, 1),
     ("long_500k", "decode", 524288, 1)),
    ("c decode", "mamba2-1.3b", 0, {}, (2, 2),
     ("decode_32k", "decode", 32768, 128)),
    ("c prefill", "mamba2-1.3b", 0, {}, (2, 2),
     ("prefill_32k", "prefill", 4096, 4)),
)


def sr_cfg(cell):
    """A cell's config: its arch at its layers and ModelConfig overrides,
    a `capacity_factor` one the MoE config's (`dryrun.cell_config`'s
    rule, so `cell_bytes` reads the same cell)."""
    kw = dict(cell[3])
    cap = kw.pop("capacity_factor", None)
    cfg = rt_cfg(cell[1], cell[2], **kw)
    if cap is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cap))
    return cfg


def sr_shape(cell):
    from repro_torch.models.model import ShapeSpec
    return ShapeSpec(*cell[5])


def sr_perms(cfg, seed: int) -> dict:
    """The permutations of a cell's float-order floor, by logical axis:
    the sums a split reorders.  An attention model's hidden axis and its
    query heads (within each KV head's group, so the KV heads and the
    cache stay; MLA's all, its latent cache has no heads); a dense MLP's
    axis, or a MoE model's routed experts (the router's columns with
    them) and its MLP axes by length (`layer0`'s and the shared
    experts').  An ssm model's hidden and head axes (one B / C group: its
    cache's heads move with them)."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def perm(n):
        return torch.randperm(n, generator=g).to(DEVICE)
    if cfg.family == "ssm":
        return {"embed": perm(cfg.d_model), "heads": perm(cfg.ssm.n_heads)}
    out = {"embed": perm(cfg.d_model)}
    if cfg.mla is not None:
        out["heads"] = perm(cfg.mla.n_heads)
    else:
        per = cfg.n_heads // cfg.n_kv_heads
        out["heads"] = torch.cat([
            j * per + torch.randperm(per, generator=g)
            for j in range(cfg.n_kv_heads)]).to(DEVICE)
    if cfg.moe is None:
        out["mlp"] = perm(cfg.d_ff)
        return out
    out["experts"] = perm(cfg.moe.n_experts)
    mlp = {n: perm(n) for n in (cfg.first_dense_ff,
                                cfg.moe.n_shared * cfg.moe.d_ff) if n}
    if mlp:
        out["mlp"] = mlp
    return out


def sr_tokens(cfg, shape):
    """A prefill cell's prompt (B, S), a decode cell's teacher-forced
    tokens (B, SR_STEPS): int32 from SR_SEED, on the host."""
    import numpy as np
    import torch
    n = shape.seq_len if shape.kind == "prefill" else SR_STEPS
    rng = np.random.default_rng(SR_SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (
        shape.global_batch, n)).astype(np.int32))


def sr_cache(cfg, shape, device, mesh=None):
    """A decode cell's cache filled from seeds block by block (K / V and
    the ssm leaves N(0, 1), the ssm state N(0, 0.01)), its cursor at
    seq_len - SR_STEPS.  A block is a (layer, half of the rows, 1/64 of a
    long dim 2) piece drawn from a seed of its own, so on a live `mesh`
    (the cell's SERVE_RULES layout) a rank draws only the blocks it
    holds, and every layout holds the same numbers."""
    import torch
    from repro_torch.distributed.runtime import axis_index
    from repro_torch.distributed.sharding import (P, SERVE_RULES,
                                                  local_shape, resolve_spec,
                                                  spec_axes, zip_tree)
    from repro_torch.models.model import cache_axes, make_inputs
    meta = make_inputs(cfg, shape)[0]["cache"]
    count = [0]

    def fill(t, axes):
        spec = (resolve_spec(tuple(t.shape), axes, SERVE_RULES, mesh)
                if mesh is not None else P())
        if axes[0] == "layers" or axes == ("cache_batch",):
            return drawn(t, axes, spec)
        # an unstacked leaf (deepseek-v2's `layer0`): one layer of blocks
        return drawn(t[None], ("layers",) + axes, P(None, *spec))[0]

    def drawn(t, axes, spec):
        leaf, count[0] = count[0], count[0] + 1
        loc = local_shape(tuple(t.shape), spec, mesh) if mesh is not None \
            else tuple(t.shape)
        off = [axis_index(spec_axes(P(spec[i])), mesh) * loc[i]
               if i < len(spec) and spec[i] else 0 for i in range(len(loc))]
        out = torch.empty(loc, dtype=t.dtype, device=device)
        if axes == ("cache_batch",):
            return out.fill_(shape.seq_len - SR_STEPS)
        n_l, n_b, rest = t.shape[0], t.shape[1], tuple(t.shape[2:])
        rb = n_b // 2 if n_b % 2 == 0 else n_b
        n_c = 64 if rest[0] >= 4096 else (2 if rest[0] % 2 == 0 else 1)
        ch = rest[0] // n_c
        if off[1] % rb or loc[1] % rb or off[2] % ch or loc[2] % ch:
            raise AssertionError(f"23: a rank's part {loc} at {off} cuts a "
                                 f"seeded block ({rb}, {ch})")
        scale = 0.1 if "state" in axes else 1.0
        for li in range(n_l):
            for b in range(off[1] // rb, (off[1] + loc[1]) // rb):
                for c in range(off[2] // ch, (off[2] + loc[2]) // ch):
                    g = torch.Generator(device).manual_seed(
                        SR_SEED + ((leaf * n_l + li) * (n_b // rb) + b)
                        * n_c + c)
                    blk = torch.randn((rb, ch) + rest[1:], generator=g,
                                      device=device)
                    for j, n in enumerate(loc[3:]):
                        blk = blk.narrow(j + 2, off[3 + j], n)
                    out[li, b * rb - off[1]:(b + 1) * rb - off[1],
                        c * ch - off[2]:(c + 1) * ch - off[2]].copy_(
                            blk * scale)
        return out
    return zip_tree(meta, cache_axes(cfg), fill)


def sr_params(bundle, device, grid: tuple, mesh=None) -> dict:
    """A cell's params drawn block by block: every leaf cut into the
    blocks of its SERVE_RULES spec on the cell's (data, model) `grid`,
    each block N(0, std^2) (the whole leaf's `ParamDef.std`) from a seed
    of its own.  On a live `mesh` (of that grid) a rank draws only its
    shard, its one block, so none draws a whole stacked expert leaf; one
    process draws every block into the whole leaf; both hold the same
    numbers."""
    import itertools
    import torch
    from repro_torch.distributed.runtime import axis_index
    from repro_torch.distributed.sharding import (P, SERVE_RULES, mesh_axes,
                                                  param_shardings, spec_axes)
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.module import leaves, map_tree, unflatten
    shape = MeshShape(("data", "model"), grid)
    sizes = mesh_axes(shape)
    spec_of = dict(leaves(map_tree(lambda sh: sh.spec, param_shardings(
        bundle.skeleton, shape, SERVE_RULES))))
    out = []
    for leaf, (path, d) in enumerate(leaves(bundle.skeleton)):
        spec = tuple(spec_of[path]) + (None,) * (len(d.shape)
                                                 - len(spec_of[path]))
        groups = [spec_axes(P(p)) for p in spec]
        n = [math.prod(sizes[a] for a in g) for g in groups]
        blk = tuple(s // k for s, k in zip(d.shape, n))
        if d.init != "normal":
            fill = 0.0 if d.init == "zeros" else 1.0
            out.append((path, torch.full(blk if mesh is not None
                                         else d.shape, fill,
                                         device=device)))
            continue
        if mesh is not None:
            idx = [tuple(axis_index(g, mesh) if g else 0 for g in groups)]
            t = torch.empty(blk, device=device)
        else:
            idx = itertools.product(*(range(k) for k in n))
            t = torch.empty(d.shape, device=device)
        for ix in idx:
            flat = 0
            for i, k in zip(ix, n):
                flat = flat * k + i
            g = torch.Generator(device).manual_seed(
                SR_PARAM_SEED + 4096 * leaf + flat)
            v = torch.randn(blk, generator=g, device=device).mul_(d.std)
            if mesh is not None:
                t.copy_(v)
            else:
                t[tuple(slice(i * b, (i + 1) * b)
                        for i, b in zip(ix, blk))].copy_(v)
            del v
        out.append((path, t))
    return unflatten(out)


def sr_chip(cfg, perm=None):
    """Chip 7 over `cfg`'s MLP projections, as a served model pins it;
    with `perm` its lanes permuted as the params' hidden and MLP axes."""
    import torch
    from repro_torch.core import mrr
    from repro_torch.robust.variation import sample_chip
    ff = cfg.first_dense_ff or cfg.d_ff      # deepseek-v2: its layer 0's
    chip = sample_chip(torch.Generator().manual_seed(SR_CHIP),
                       {"mlp/wi": cfg.d_model, "mlp/wo": ff},
                       device=DEVICE)
    if perm is None:
        return chip
    mlp = perm["mlp"]
    lanes = {"mlp/wi": perm["embed"],
             "mlp/wo": mlp[ff] if isinstance(mlp, dict) else mlp}
    return {n: mrr.StaticVariation(v.dv[lanes[n]], v.ddt[lanes[n]],
                                   v.dlam[lanes[n]])
            for n, v in chip.items()}


def sr_engine(cfg, perm=None):
    """(a)'s serving engine: "fused", each activation row at its own
    full-scale (the Scheduler's), chip 7 pinned; none for a plain MLP."""
    from repro_torch import rosa
    from repro_torch.rosa.backends import RosaConfig
    if not cfg.rosa_mlp:
        return contextlib.nullcontext()
    return rosa.engine_context(rosa.Engine.from_config(RosaConfig(
        backend="fused", act_per_vector=True)).with_variation(
            sr_chip(cfg, perm)))


def sr_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(sr_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(sr_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def sr_attn_leaves(cache, specs=None) -> list:
    """(name, leaf, spec, sequence dim) of every leaf of an attention
    cache (K / V or MLA's latent pair): the stacked layers' and
    deepseek-v2's `layer0`'s; `specs`, the cache's spec tree."""
    return [(f"{key}/{i}", t, specs[key][i] if specs else None, seq)
            for key, seq in (("layers", 2), ("layer0", 1))
            for i, t in enumerate(cache.get(key, ()))]


def sr_parts(cfg, shape, cache) -> dict:
    """The leaves of a whole cache a cell compares: an attention decode's
    positions the steps wrote, an attention prefill's whole cache, an ssm
    cache's first and last layers (a decode's every SR_ROWS-th row), as
    float32 on the host."""
    out = {}
    if cfg.family != "ssm":
        p0 = shape.seq_len - SR_STEPS
        for k, t, _, seq in sr_attn_leaves(cache):
            out[k] = (t.narrow(seq, p0, SR_STEPS) if shape.kind == "decode"
                      else t)
    else:
        ends = [0, cfg.n_layers - 1]
        rows = slice(None, None, SR_ROWS if shape.kind == "decode" else 1)
        for k, t in cache["layers"].items():
            out[f"layers/{k}"] = t[ends][:, rows]
    return {k: v.float().cpu() for k, v in out.items()}


def sr_rank_parts(cfg, shape, cache, layout, mesh) -> dict:
    """`sr_parts` of the whole cache from a rank's part (every rank joins
    the collectives; the values are rank 0's to hand back): the written
    positions of a sequence-sharded cache `psum`-med over its ranks (the
    others hold zeros there), every other split dim gathered."""
    import torch
    from repro_torch.distributed import runtime as rt
    from repro_torch.distributed.sharding import (P, gather, resolve_spec,
                                                  spec_axes)
    from repro_torch.launch.steps import serve_layout
    from repro_torch.models.model import ShapeSpec, build_model, cache_axes
    from repro_torch.models import layers as L
    if shape.kind == "prefill":
        # the prefill's part: the decode layout's of these rows with
        # every position (its sequence whole)
        lay = serve_layout(build_model(cfg), mesh, ShapeSpec(
            "x", "decode", shape.seq_len, shape.global_batch))
        specs, axes = lay.inputs["cache"], cache_axes(cfg)
    else:
        specs, axes = layout.inputs["cache"], cache_axes(cfg)
    out = {}
    if cfg.family != "ssm":
        for k, t, sp, dim in sr_attn_leaves(cache, specs):
            spec = list(sp) + [None] * t.ndim
            if shape.kind == "decode":
                p0, n = shape.seq_len - SR_STEPS, SR_STEPS
                seq = spec_axes(P(spec[dim]))
                lo = rt.axis_index(seq, mesh) * t.shape[dim] if seq else 0
                part = torch.zeros(t.shape[:dim] + (n,) + t.shape[dim + 1:],
                                   dtype=t.dtype, device=t.device)
                a, b = max(p0, lo), min(p0 + n, lo + t.shape[dim])
                if a < b:
                    part.narrow(dim, a - p0, b - a).copy_(
                        t.narrow(dim, a - lo, b - a))
                t = rt.psum(part.float(), seq, mesh) if seq else part
            spec[dim] = None
            out[k] = gather(t, P(*spec[:t.ndim]), mesh)
    else:
        ends = [0, cfg.n_layers - 1]
        rows = slice(None, None, SR_ROWS if shape.kind == "decode" else 1)
        for k, t in cache["layers"].items():
            out[f"layers/{k}"] = gather(t[ends], specs["layers"][k],
                                        mesh)[:, rows]
    return {k: v.float().cpu() for k, v in out.items()}


def sr_rank(rank: int, world: int, device, job: dict) -> dict:
    """One rank of phase 23 or 24: every cell on this rank's SERVE_RULES
    shards (`sr_params`), rows and part of the cache; the main path's
    launches counted from 0, the kernels' operand shapes recorded, its
    walls and peak; a MoE cell's dropped assignments, and for a decode
    cell one more step at the arch's own capacity factor (ungated).
    Hands back host values only (the gathered logits and cache parts:
    rank 0's)."""
    import gc
    import torch
    rank_setup(device)
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import P, gather, shard_local
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_serve_step, serve_layout
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import build_model
    shapes: dict = {}
    real_ssd, real_fused = SSM.ssd_scan, fused_ops.rosa_fused

    def ssd_scan(x, *a, **k):
        shapes.setdefault("ssd_scan_heads", set()).add(int(x.shape[2]))
        return real_ssd(x, *a, **k)

    def rosa_fused(x, w, *a, **k):
        shapes.setdefault("rosa_fused_kn", set()).add(
            (int(x.shape[1]), int(w.shape[1])))
        return real_fused(x, w, *a, **k)
    SSM.ssd_scan, fused_ops.rosa_fused = ssd_scan, rosa_fused
    meshes: dict = {}
    out = {}
    for cell in job["cells"]:
        tag, cfg, shape = cell[0], sr_cfg(cell), sr_shape(cell)
        if cell[4] not in meshes:
            meshes[cell[4]] = make_test_mesh(*cell[4], device.type)
        mesh = meshes[cell[4]]
        bundle = build_model(cfg)
        layout = serve_layout(bundle, mesh, shape)
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params = sr_params(bundle, device, cell[4], mesh)
        toks = sr_tokens(cfg, shape)
        row_spec = P(layout.batch_axes or None)

        def rows(t):
            return shard_local(t, row_spec, mesh).contiguous().to(device)
        if shape.kind == "prefill":
            batch = layout.local_inputs({"tokens": toks}, device)
        else:
            cache = sr_cache(cfg, shape, device, mesh)
            batch = {"token": rows(toks[:, 0]), "pos": cache["pos"].clone(),
                     "cache": cache}
        held = sr_nbytes(params) + sr_nbytes(batch)
        pos0 = batch["pos"].clone() if shape.kind == "decode" else None
        step = make_serve_step(bundle, layout)
        torch.cuda.synchronize(device)
        set_up = time.perf_counter() - t0
        logits, walls = [], []
        # ---- the main path: counts from 0, read right after --------------
        with counting_drops() as take_drops, sr_engine(cfg), \
                torch.inference_mode():
            reset_launches()
            shapes.clear()
            for i in range(1 if shape.kind == "prefill" else SR_STEPS):
                ts = time.perf_counter()
                lg, cache = step(params, batch)
                torch.cuda.synchronize(device)
                walls.append(time.perf_counter() - ts)
                logits.append(lg)
                if shape.kind == "decode" and i + 1 < SR_STEPS:
                    batch = {"token": rows(toks[:, i + 1]),
                             "pos": cache["pos"], "cache": cache}
            n = launch_counts()
            gated_drops = take_drops()
            lg = [gather(t, row_spec, mesh).float().cpu() for t in logits]
            parts = sr_rank_parts(cfg, shape, cache, layout, mesh)
            ungated = None
            if cfg.moe is not None and shape.kind == "decode":
                # the first step again at the arch's own capacity factor:
                # its drops (not gated)
                own = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe,
                    capacity_factor=get_config(cell[1]).moe.capacity_factor))
                ts = time.perf_counter()
                make_serve_step(build_model(own), layout)(params, {
                    "token": rows(toks[:, 0]), "pos": pos0, "cache": cache})
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - ts
                ungated = {"capacity_factor": own.moe.capacity_factor,
                           "drops": take_drops(), "wall": wall}
        out[tag] = {
            "launches": n, "walls": walls, "set_up_s": set_up,
            "held": held, "rows": layout.batch_axes,
            "kv": (tuple(layout.inputs["cache"]["layers"][0])
                   if shape.kind == "decode" and cfg.family != "ssm"
                   else None),
            "drops": gated_drops, "ungated": ungated,
            "shapes": {k: sorted(v) for k, v in shapes.items()},
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "logits": [t.numpy() for t in lg] if rank == 0 else None,
            "parts": ({k: v.numpy() for k, v in parts.items()}
                      if rank == 0 else None)}
        del params, batch, cache, logits, lg, parts, step
    SSM.ssd_scan, fused_ops.rosa_fused = real_ssd, real_fused
    return out


def sr_permute_(tree, axes_of, perm: dict, inverse: bool = False) -> None:
    """Permute in place every axis of `tree`'s leaves that `axes_of(path)`
    names in `perm` ({logical axis: permutation, or {length: permutation}
    where one name has several lengths}), or undo it; one leading index
    at a time where the leaf has a layers dim."""
    import torch
    from repro_torch.models.module import leaves
    for path, t in leaves(tree):
        for ax, name in enumerate(axes_of(path)):
            if name not in perm:
                continue
            p = perm[name]
            if isinstance(p, dict):         # by the axis's length
                p = p[t.shape[ax]]
            if inverse:
                p = torch.argsort(p)
            if ax > 0 and t.shape[0] > 1 and axes_of(path)[0] == "layers":
                for i in range(t.shape[0]):
                    t[i].copy_(t[i].index_select(ax - 1, p))
            else:
                t.copy_(t.index_select(ax, p))


def sr_one(cell) -> dict:
    """A cell in one process on the card, from the same params, prompt,
    tokens and cache (a decode step on a data rank's rows at a time, the
    ranks' width): its logits and cache parts, and its float-order
    floor (the largest distance from them of the same run with the
    params' axes `sr_perms` names permuted, two seeds; the chip's lanes
    and an ssm cache's heads permuted with them), each relative to max
    |.|; a MoE cell's routed experts drop nothing (its capacity factor
    E / k), so one process's `moe_ref` computes the ranks' function; and
    each step's median over the rows of that distance, the larger run's
    (`sr_rows`)."""
    import gc
    import torch
    from repro_torch.distributed.sharding import mesh_axes
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import serve_layout
    from repro_torch.models.model import build_model, cache_axes
    from repro_torch.models.module import leaves, map_tree
    cfg, shape = sr_cfg(cell), sr_shape(cell)
    bundle = build_model(cfg)
    toks = sr_tokens(cfg, shape).to(DEVICE)
    p_axes = dict(leaves(map_tree(lambda d: d.axes, bundle.skeleton)))
    if cfg.moe is not None:
        # the router's columns are the experts
        p_axes[("layers", "ffn", "router")] = ("layers", "embed", "experts")
    c_axes = dict(leaves(cache_axes(cfg)["layers"]
                         if cfg.family == "ssm" else {}))
    c_all = cache_axes(cfg)
    # a decode step runs on a data rank's rows at a time: float32
    # products are not batch-width invariant on the card (`rosa_fused`
    # takes its decode path at 16 rows or fewer, its tall one above)
    grid = MeshShape(("data", "model"), cell[4])
    width = len(toks) // math.prod(
        mesh_axes(grid)[a]
        for a in serve_layout(bundle, grid, shape).batch_axes)
    cache = None
    runs, t0 = [], time.perf_counter()
    for seed in (None, 1, 2):
        perm = sr_perms(cfg, seed) if seed is not None else None
        params = sr_params(bundle, DEVICE, cell[4])
        if perm:
            sr_permute_(params, lambda p: p_axes[p], perm)
        if shape.kind == "decode" and (cache is None
                                       or cfg.family == "ssm"):
            # an attention cache's positions the steps read they write
            # first, so it serves every run; an ssm state is advanced
            del cache
            gc.collect()
            cache = sr_cache(cfg, shape, DEVICE)
        if shape.kind == "decode" and perm and c_axes:
            sr_permute_(cache["layers"], lambda p: c_axes[p], perm)
        if shape.kind == "decode":
            cache["pos"].fill_(shape.seq_len - SR_STEPS)
        logits = []
        with sr_engine(cfg, perm), torch.inference_mode():
            reset_launches()
            if shape.kind == "prefill":
                lg, out_cache = bundle.prefill(params, {"tokens": toks})
                logits.append(lg.float().cpu())
            else:
                pos = cache["pos"].clone()
                for i in range(SR_STEPS):
                    lg = [bundle.decode_step(params, {
                        "token": toks[lo:lo + width, i],
                        "pos": pos[lo:lo + width],
                        "cache": sr_rows_of(cache, c_all, lo, width)})[0]
                          for lo in range(0, len(toks), width)]
                    logits.append(torch.cat(lg).float().cpu())
                    pos = pos + 1
                out_cache = cache
            torch.cuda.synchronize()
            n = launch_counts()
            if perm and c_axes:
                sr_permute_(out_cache["layers"], lambda p: c_axes[p], perm,
                            inverse=True)
        runs.append((torch.stack(logits), sr_parts(cfg, shape, out_cache),
                     n))
        del params, out_cache, lg
        gc.collect()
        torch.cuda.empty_cache()
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    base, parts, n = runs[0]
    floor = torch.zeros(len(base))
    median = torch.zeros(len(base))
    pfloor = {k: 0.0 for k in parts}
    for lg, pp, _ in runs[1:]:
        rows = sr_rows(lg, base)
        floor = torch.maximum(floor, rows.amax(-1))
        median = torch.maximum(median, rows.median(-1).values)
        for k, v in pp.items():
            pfloor[k] = max(pfloor[k], max_rel(v, parts[k]))
    return {"logits": base, "parts": parts, "floor": floor,
            "median": median, "part_floor": pfloor, "launches": n,
            "wall_s": time.perf_counter() - t0}


def sr_rows_of(cache, axes, lo: int, n: int):
    """Rows lo..lo + n of a cache (`axes`, its `cache_axes`): views, so a
    decode step that advances them in place advances the whole cache."""
    from repro_torch.distributed.sharding import zip_tree
    return zip_tree(cache, axes, lambda t, ax: t.narrow(
        ax.index("cache_batch"), lo, n))


def sr_rows(lg, base):
    """(steps, rows): each row's largest distance of `lg` from `base`,
    relative to the step's max |base|."""
    return ((lg - base).abs().amax(-1)
            / base.abs().amax(dim=(1, 2))[:, None])


def sr_want(cfg, shape) -> dict:
    """A rank's main-path launches: two optical products an optical MLP a
    step (or prefill): every layer's, or a MoE model's dense `layer0`'s
    (its MoE FFNs ignore `rosa_mlp`); an ssm model's scan a layer in a
    prefill."""
    steps = 1 if shape.kind == "prefill" else SR_STEPS
    optical = (cfg.n_layers if cfg.moe is None
               else 1 if cfg.first_dense_ff else 0)
    if cfg.rosa_mlp and optical:
        return {"rosa_fused": 2 * optical * steps}
    if cfg.family == "ssm" and shape.kind == "prefill":
        return {"ssd_scan": cfg.n_layers}
    return {}


def sr_check(cell, one: dict, outs: list, parent: int,
             ph: str = "23") -> dict:
    """A cell's gates on every rank: the logits of every step within 4x
    the one-process floor plus 1e-6 of max |.|, the argmax equal wherever
    the top-two gap exceeds that bound (a plain MoE cell's: its floor
    the largest of any step, and every step's median row within 4x the
    floor runs' median plus 1e-6), every cache part within 4x its
    floor plus 1e-6, its launches exactly `sr_want`, its bytes
    `dryrun.cell_bytes` of the cell on its mesh and cut shape (float32
    params), the ranks' peaks < PEAK_GIB over the card, a MoE cell's
    routed experts dropping nothing; printed with ms a step, tok/s, the
    peaks and each rank's drops at the arch's own capacity factor.  `ph`,
    the phase its messages name."""
    import numpy as np
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    tag, cfg, shape = cell[0], sr_cfg(cell), sr_shape(cell)
    res = [o[tag] for o in outs]
    fails = []
    want_n = sr_want(cfg, shape)
    ov = dict(cell[3], **({"n_layers": cell[2]} if cell[2] else {}))
    want_bytes = dryrun.cell_bytes(
        cell[1], shape.name, None, ov, param_dtype=torch.float32,
        mesh=MeshShape(("data", "model"), cell[4]),
        shape=shape)["argument_bytes"]
    for r, o in enumerate(res):
        others = {k: v for k, v in o["launches"].items()
                  if v and k not in want_n}
        if any(o["launches"][k] != v for k, v in want_n.items()) or others:
            fails.append(f"{ph}({tag}) rank {r} launched {o['launches']}, "
                         f"want {want_n}")
        if o["held"] != want_bytes:
            fails.append(f"{ph}({tag}) rank {r} holds {o['held']} B, "
                         f"cell_bytes {want_bytes}")
        if o["drops"]:
            fails.append(f"{ph}({tag}) rank {r} dropped {o['drops']} "
                         "assignments at a capacity that drops none")
    lg = torch.from_numpy(np.stack(res[0]["logits"]))
    base, floor = one["logits"], one["floor"]
    # a plain MoE stack's rows jump one at a time under any reordering:
    # each step's median row is held to the floor runs' median, the worst
    # row to their worst of any step (an optical one's rows move by the
    # codes they flip, most rows at once: its worst row each step)
    by_median = cfg.moe is not None and not cfg.rosa_mlp
    if by_median:
        floor = torch.full_like(floor, float(floor.max()))
    bound = 4 * floor + 1e-6
    scale = base.abs().amax(dim=(1, 2))
    dev = sr_rows(lg, base)
    rel = dev.amax(-1)
    med = dev.median(-1).values
    med_bound = 4 * one["median"] + 1e-6
    top2 = base.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) / scale[:, None] > bound[:, None]
    same = lg.argmax(-1) == base.argmax(-1)
    if lg.shape != base.shape or not bool(torch.isfinite(lg).all()):
        fails.append(f"{ph}({tag}) logits {tuple(lg.shape)} not finite or "
                     f"not {tuple(base.shape)}")
    elif bool((rel > bound).any()) or bool((clear & ~same).any()):
        fails.append(f"{ph}({tag}) logits {rel.tolist()} from one process's, "
                     f"bound {bound.tolist()}; argmax differs past it")
    elif by_median and bool((med > med_bound).any()):
        fails.append(f"{ph}({tag}) logits' median row {med.tolist()} from "
                     f"one process's, bound {med_bound.tolist()}")
    worst = ("", 0.0, 0.0)
    for k, v in res[0]["parts"].items():
        d = max_rel(torch.from_numpy(v), one["parts"][k])
        b = 4 * one["part_floor"][k] + 1e-6
        if d / b > worst[1] / max(worst[2], 1e-30) or not worst[0]:
            worst = (k, d, b)
        if d > b:
            fails.append(f"{ph}({tag}) cache {k} {d:.3e} from one process's, "
                         f"bound {b:.3e}")
    peak = (max if RANK_CARDS else sum)(o["peak_bytes"] for o in res) \
        + parent
    if peak >= PEAK_GIB * 2**30:
        fails.append(f"{ph}({tag}) peak {peak / 2**30:.1f} GiB")
    # the last step: a decode's first pays the cell's warm-up
    step_s = max(o["walls"][-1] for o in res)
    rows = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                 else 1)
    kn = sorted({tuple(x) for o in res for x in
                 o["shapes"].get("rosa_fused_kn", [])})
    heads = sorted({x for o in res for x in
                    o["shapes"].get("ssd_scan_heads", [])})
    print(f"  {ph}({tag}) {cell[1]} {shape.name} {shape.global_batch} x "
          f"{shape.seq_len} on (data, model) {cell[4]}, rows over "
          f"{res[0]['rows'] or 'no axis'}"
          + (f", KV cache {res[0]['kv']}" if res[0]["kv"] else "")
          + f": {1e3 * step_s:.1f} ms the last step (every step on "
          "rank 0: " + ", ".join(f"{1e3 * w:.1f}" for w in res[0]["walls"])
          + f"), {rows / step_s:.0f} tok/s; logits max rel dev "
          + ", ".join(f"{x:.2e}" for x in rel.tolist()) + " (floor "
          + ", ".join(f"{x:.2e}" for x in floor.tolist()) + "); argmax "
          f"equal {int(same.sum())} of {same.numel()} "
          f"({int(clear.sum())} past the bound)"
          + ("; median row " + ", ".join(f"{x:.2e}" for x in med.tolist())
             + " (floor " + ", ".join(f"{x:.2e}" for x in
                                      one["median"].tolist()) + ")"
             if by_median else "")
          + "; cache part nearest its "
          f"bound {worst[0]} {worst[1]:.2e} (bound {worst[2]:.2e}); "
          f"launches a rank {want_n or 'none'}"
          + (f" at (K, N) {kn}" if kn else "")
          + (f", ssd_scan at {heads} heads" if heads else "")
          + (f"; at capacity factor {res[0]['ungated']['capacity_factor']}"
             " one step drops " + ", ".join(str(o["ungated"]["drops"])
                                            for o in res)
             + " assignments a rank ("
             + f"{1e3 * max(o['ungated']['wall'] for o in res):.1f} ms)"
             if res[0]["ungated"] else "")
          + f"; {res[0]['held'] / 2**30:.3f} GiB a rank = cell_bytes; "
          f"peaks " + ", ".join(f"{o['peak_bytes'] / 2**30:.2f}"
                                for o in res)
          + f" GiB (card {peak / 2**30:.2f}); set-up "
          f"{max(o['set_up_s'] for o in res):.1f} s")
    ff = cfg.first_dense_ff or cfg.d_ff
    if want_n.get("rosa_fused") and kn != sorted({
            (cfg.d_model, ff), (ff // cell[4][1], cfg.d_model)}):
        fails.append(f"{ph}({tag}) rosa_fused at (K, N) {kn}")
    if want_n.get("ssd_scan") and heads != [cfg.ssm.n_heads // cell[4][1]]:
        fails.append(f"{ph}({tag}) ssd_scan at {heads} heads")
    return {"fails": fails, "launches": {
        k: sum(o["launches"].get(k, 0) for o in res) for k in want_n},
        "step_ms": 1e3 * step_s, "tok_s": rows / step_s,
        "walls_ms": [[1e3 * w for w in o["walls"]] for o in res],
        "rel": rel.tolist(), "floor": one["floor"].tolist(),
        "median": med.tolist(), "median_floor": one["median"].tolist(),
        "peak_gib": [o["peak_bytes"] / 2**30 for o in res],
        "card_peak_gib": peak / 2**30, "bytes": res[0]["held"],
        "one_process_s": one["wall_s"],
        "ungated": [o["ungated"] for o in res]}


def serve_ranks_phase(report: dict, ph: str = "23", cells=None,
                      key: str = "serve_ranks") -> dict:
    """23 (or `ph`): serving under SERVE_RULES across 4 ranks, the
    `cells` (default SR_CELLS) in one group; then each cell in one
    process with its floor (`sr_one`) and the gates (`sr_check`), the
    results under `report[key]`.  Returns the main path's rosa_fused and
    ssd_scan launches (every rank's)."""
    import gc
    import torch
    from repro_torch.distributed import runtime
    cells = SR_CELLS if cells is None else cells
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    parent = torch.cuda.memory_allocated()
    print(f"  {ph}: {rank_layout(4)}; cells "
          + "; ".join(f"({c[0]}) {c[1]} {c[5][0]} on {c[4]}"
                      for c in cells))
    outs = runtime.spawn(sr_rank, 4, device_type=DEVICE,
                         backend=rank_backend(),
                         args=({"cells": cells},), timeout=RANK_TIMEOUT)
    group_s = time.perf_counter() - t0
    print(f"  {ph}: the group {group_s:.1f} s")
    res, fails = {"group_s": group_s}, []
    n = {"rosa_fused": 0, "ssd_scan": 0}
    for cell in cells:
        one = sr_one(cell)
        got = sr_check(cell, one, outs, parent, ph)
        fails += got.pop("fails")
        for k, v in got["launches"].items():
            n[k] += v
        res[cell[0]] = got
    res["phase_s"] = time.perf_counter() - t0
    report[key] = res
    if fails:
        raise AssertionError("; ".join(fails))
    return n


# ---------------------------------------------------------------------------
# Phase 24: the MoE families served under SERVE_RULES across ranks
# ---------------------------------------------------------------------------
SP_PREFILL = {"qwen3-moe-235b-a22b": (2, 1024), "deepseek-v2-236b": (2, 384)}
SP_CAPACITY = {"qwen3-moe-235b-a22b": 128 / 8, "deepseek-v2-236b": 160 / 6}


def sp_cell(tag: str, arch: str, kind: str, **ov):
    """A phase 24 cell (SR_CELLS' fields): `arch` at 2 layers on (2, 2)
    at decode_32k (32 of 128 rows, all 32768 positions) or prefill_32k
    (SP_PREFILL's rows x positions), its capacity factor n_experts /
    top_k so every rank's capacity is its tokens and nothing drops."""
    b, n = (32, 32768) if kind == "decode" else SP_PREFILL[arch]
    return (tag, arch, 2, dict(ov, capacity_factor=SP_CAPACITY[arch]),
            (2, 2), (f"{kind}_32k", kind, n, b))


# (a) qwen3-moe-235b-a22b at 2 of 94 layers, moe_ep, experts over
# "model" through moe_ep_local beside split heads; (b) deepseek-v2-236b
# at 2 of 60 layers (`layer0` and one MoE layer), its MLA heads and its
# latent cache's sequence over "model", optical `layer0` ("fused", chip
# 7): a flipped code moves a row's logits by up to a third of their
# max, so its logits gate binds little (its launches, bytes, peaks and
# caches bind); (b') the same with a plain `layer0`, whose median-row
# gate binds the MoE layer's MLA decode over the sharded latent cache
# and its split experts at ≈ 1e-4 of the logits' max.  The prefills
# are the longest the card's sum of rank peaks keeps under PEAK_GIB
# (`tools/serve_moe_peaks.py`): a rank's no-drop expert buffers are
# (its experts, its tokens, d_model) float32, beside its experts
# gathered over "data" (4.8 / 7.5 GB).
SP_CELLS = (
    sp_cell("a decode", "qwen3-moe-235b-a22b", "decode"),
    sp_cell("a prefill", "qwen3-moe-235b-a22b", "prefill"),
    sp_cell("b decode", "deepseek-v2-236b", "decode", rosa_mlp=True),
    sp_cell("b prefill", "deepseek-v2-236b", "prefill", rosa_mlp=True),
    sp_cell("b' decode", "deepseek-v2-236b", "decode"),
    sp_cell("b' prefill", "deepseek-v2-236b", "prefill"),
)


def moe_serve_ranks_phase(report: dict) -> dict:
    """24: the MoE families served under SERVE_RULES across 4 ranks, the
    cells of SP_CELLS in one group (phase 23's machinery and gates)."""
    return serve_ranks_phase(report, "24", SP_CELLS, "serve_ranks_moe")


# `--kernels`: the phases it runs alone, by name: (title, [(tag, phase)])
PHASES = {
    "2": ("2: kernel parity against the plain versions",
          [("2 rosa_fused", fused_phase), ("2 osa_matmul", osa_phase)]),
    "6": ("6: ssd_scan parity against the plain version",
          [("6", ssd_phase)]),
    "8": ("8: mrr_transfer parity against the plain version",
          [("8", mrr_phase)]),
    "12a": ("12(a): the mrr_transfer backward against its plain derivative",
            [("12a", mrr_bwd_phase)]),
    "19a": ("19(a): the ssd_scan backward against its plain version",
            [("19a", ssd_bwd_phase)]),
    "16": ("16: the four dense configs at full width",
           [("16", dense_phase)]),
    "21": ("21: serving across ranks", [("21", ranks_phase)]),
    "22": ("22: training across ranks (17(b) first: 22(a) reads it)",
           [("17b", optical_train_phase), ("22", train_ranks_phase)]),
    "23": ("23: serving under SERVE_RULES across ranks",
           [("23", serve_ranks_phase)]),
    "24": ("24: the MoE families served under SERVE_RULES across ranks",
           [("24", moe_serve_ranks_phase)]),
}
KERNEL_PHASES = ("2", "6", "8", "12a", "19a")   # `--kernels` alone


def write_report(report: dict, t_start: float) -> int:
    report["wall_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "CUDA card (all phases by default).")
    ap.add_argument("--cards", action="store_true",
                    help="phases 21-22 over nccl, one rank a card (the "
                    "host must have 4 cards); default: the ranks share "
                    "card 0 in a gloo group, the CUDA collectives through "
                    "card buffers)")
    ap.add_argument("--kernels", nargs="*", metavar="PHASE",
                    choices=PHASES,
                    help="build and run the kernel phases 2, 6, 8, "
                    "12a and 19a only (parity and times of all six "
                    "kernels), or those named (16, 21 too, which runs "
                    "phases 3-5 first for their tokens; 22, which runs "
                    "17(b) first); prints no summary and no result line")
    opts = ap.parse_args(argv)
    global RANK_CARDS
    RANK_CARDS = opts.cards
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # a fresh plan cache for this run: every compile starts cold
    import os
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    plan_cache = tempfile.mkdtemp(prefix="plan-cache-", dir=ROOT / "build")
    os.environ["ROSA_PLAN_CACHE"] = plan_cache
    try:
        return run_phases(opts)
    finally:
        shutil.rmtree(plan_cache, ignore_errors=True)


def kernel_spills(log: str) -> dict[str, int]:
    """The kernels of an nvcc `-Xptxas -v` log that spill: {name (the
    last component of the mangled name, the template's argument after a
    colon): bytes of spill stores}."""
    out = {}
    for part in re.split(r"Compiling entry function '", log)[1:]:
        mangled = part.split("'", 1)[0]
        m = re.search(r"(\d+) bytes spill stores", part)
        if not m or not int(m.group(1)):
            continue
        i, name = mangled.find("_Z") + 2 + (mangled[2:3] == "N"), mangled
        while i < len(mangled) and mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group(0)
            i += len(n)
            name, i = mangled[i:i + int(n)], i + int(n)
        arg = re.match(r"ILi(\d+)E", mangled[i:])
        out[name + (f":{arg.group(1)}" if arg else "")] = int(m.group(1))
    return out


def run_phases(opts) -> int:
    import torch
    from repro_torch import kernels

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print("phase 1: build")
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(libs):
        log = kernels.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spilled = kernel_spills(log)
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)}"
              f" registers a thread, {sum(spilled.values())} bytes of spill "
              "stores" + "".join(f"; {k} {n}" for k, n in spilled.items()))

    report: dict = {"card": card, "phase_s": {}}

    def phase(name, fn):
        t = time.perf_counter()
        out = fn(report)
        report["phase_s"][name] = time.perf_counter() - t
        print(f"  ({name}: {report['phase_s'][name]:.1f} s)", flush=True)
        return out

    if opts.kernels is not None:
        for name in opts.kernels or KERNEL_PHASES:
            title, fns = PHASES[name]
            print(f"phase {title}")
            for tag, fn in fns:
                phase(tag, fn)
        return write_report(report, t_start)
    print("phase 2: kernel parity against the plain versions")
    fused = phase("2 rosa_fused", fused_phase)
    osa = phase("2 osa_matmul", osa_phase)
    print("phases 3-5: serving")
    launches = phase("3-5", serve_phase)
    print("phase 6: ssd_scan parity against the plain version")
    ssd = phase("6", ssd_phase)
    print("phase 7: serving mamba2-1.3b")
    launches["ssd_scan"] = phase("7", mamba_phase)
    print("phase 8: mrr_transfer parity against the plain version")
    mrr_row = phase("8", mrr_phase)
    print(f"phase 9: the Table 4 pipeline, {', '.join(CNNS)}")
    launches["mrr_transfer"] = phase("9", table4_phase)["mrr_transfer"]
    print(f"phase 10: {CNN} on the card against the reference's golden file")
    phase("10", golden_phase)
    print("phase 11: the paper's energy model on the card (float64)")
    phase("11", energy_phase)
    print("phase 12(a): the mrr_transfer backward against its plain "
          "derivative")
    bwd = phase("12a", mrr_bwd_phase)
    launches["mrr_transfer_bwd"] = phase("12bc", robust_phase)[
        "mrr_transfer_bwd"]
    launches["rosa_fused"] += phase("13", adaptive_phase)
    print("phase 14: serving qwen3-moe-235b-a22b and deepseek-v2-236b at "
          "full width")
    launches["rosa_fused"] += phase("14", moe_phase)
    launches["ssd_scan"] += phase("15", family_phase)
    launches["rosa_fused"] += phase("16", dense_phase)
    launches["rosa_fused"] += phase("17", train_phase)
    print("phase 18: observability and the static checks, qwen3-32b full "
          "width")
    launches["rosa_fused"] += phase("18", obs_phase)
    print("phase 19: training mamba2-1.3b and zamba2-1.2b at full width and "
          "depth")
    ssd_bwd, ssm_n = phase("19", ssm_train_phase)
    launches["ssd_scan"] += ssm_n["ssd_scan"]
    print("phase 20: the dry run, one arch per family on the production "
          "meshes")
    phase("20", dryrun_phase)
    print("phase 21: serving across ranks (slots, the KV cache's sequence, "
          "experts)")
    launches["rosa_fused"] += phase("21", ranks_phase)
    print("phase 22: training across ranks (params and moments sharded, "
          "the gathers' transposes, experts in the train step, the elastic "
          "restart)")
    rt_n = phase("22", train_ranks_phase)
    launches["rosa_fused"] += rt_n["rosa_fused"]
    launches["ssd_scan"] += rt_n["ssd_scan"]
    ssm_n["ssd_scan_bwd"] += rt_n["ssd_scan_bwd"]
    print("phase 23: serving under SERVE_RULES across ranks (heads, KV "
          "heads, MLP and vocab over \"model\", the weights' embed dims "
          "over \"data\")")
    sr_n = phase("23", serve_ranks_phase)
    launches["rosa_fused"] += sr_n["rosa_fused"]
    launches["ssd_scan"] += sr_n["ssd_scan"]
    print("phase 24: the MoE families served under SERVE_RULES across "
          "ranks (experts over \"model\" through moe_ep_local, MLA heads "
          "over \"model\" beside a latent cache whose sequence takes it)")
    launches["rosa_fused"] += phase("24", moe_serve_ranks_phase)[
        "rosa_fused"]

    summary = {"kernels": [
        {"name": "rosa_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rosa_fused.cu",
         "replaces": "src/repro/kernels/rosa_fused/rosa_fused.py:193",
         "launches": launches["rosa_fused"],
         "max_abs_err": fused["max_abs_err"], "ms": fused["ms"],
         "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": None},
        {"name": "osa_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/osa_matmul.cu",
         "replaces": "src/repro/kernels/osa_matmul/osa_matmul.py:90",
         "launches": launches["osa_matmul"],
         "max_abs_err": osa["max_abs_err"], "ms": osa["ms"],
         "plain_ms": osa["plain_ms"], "bound_ms": osa["bound_ms"],
         "bound_by": osa["bound_by"], "library_ms": osa["library_ms"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:73",
         "launches": launches["ssd_scan"],
         "max_abs_err": ssd["max_abs_err"], "ms": ssd["ms"],
         "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
         "bound_by": ssd["bound_by"], "library_ms": None},
        {"name": "mrr_transfer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mrr_transfer.cu",
         "replaces": "src/repro/kernels/mrr_transfer/mrr_transfer.py:69",
         "launches": launches["mrr_transfer"],
         "max_abs_err": mrr_row["max_abs_err"], "ms": mrr_row["ms"],
         "plain_ms": mrr_row["plain_ms"], "bound_ms": mrr_row["bound_ms"],
         "bound_by": mrr_row["bound_by"], "library_ms": None},
        {"name": "mrr_transfer_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mrr_transfer.cu",
         "replaces": "src/repro/core/mrr.py:265",
         "launches": launches["mrr_transfer_bwd"],
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": None},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/models/ssm.py:94",
         "launches": ssm_n["ssd_scan_bwd"],
         "max_abs_err": ssd_bwd["max_abs_err"], "ms": ssd_bwd["ms"],
         "plain_ms": ssd_bwd["plain_ms"], "bound_ms": ssd_bwd["bound_ms"],
         "bound_by": ssd_bwd["bound_by"],
         "f32_bound_ms": ssd_bwd["f32_bound_ms"], "library_ms": None},
    ]}
    report["summary"] = summary
    write_report(report, t_start)
    for k in summary["kernels"]:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} not finite")
    print(f"total {report['wall_s']:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
