#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a) into
             one shared library; print the time and ptxas' register lines.
3. kernels — hold each of the eleven kernels and their bf16 entries
             against its plain PyTorch version on the card: small edge
             cases, then the shapes the
             full-width serving paths give it (phi3-mini widths for the
             engine, gemma3-1b, qwen2-moe-a2.7b, mamba2-370m, zamba2-7b and
             deepseek-v2-lite-16b widths for the layer-stack batcher,
             seamless-m4t-medium's for the encoder-decoder: among them
             flash_decode's wide layout at MLA's D 576 / Dv 512, flash_attention
             non-causal with Sq != Skv and at D 192 / Dv 128 and D 112,
             ssd_scan at 112 heads, batched_gemm at MLA's absorbed E 16, M
             4; and MLA's k_cat copy, which is not a kernel); time
             kernel, plain version and one PyTorch library call with CUDA
             events (cold L2), beside the least time the card could take
             (H100 SXM data-sheet peaks: 67 TFLOP/s fp32, 3.35 TB/s).  The two paged kernels run in both
             modes (fp32 and int8 pages); their fp32 output must be bitwise
             equal to the dense kernel's on the gathered cache, and the
             dense kernel's time at the same logical shape is their
             yardstick (no PyTorch call reads KV through a block table).
             The cache-write ops of the three serving paths are timed too.
             The split-KV partial kernel (flash_decode_partial) is held
             against its plain version on lengths 0, wholly empty shards
             and lengths across shard edges, GQA 1-8, D 64-256 with Dv != D,
             n_splits 2/4/8, then timed with the cuda_split backend
             (kernel + combine kernel) beside flash_decode and SDPA at
             phi3-mini's engine decode and at gemma3-1b's global decode for
             n_splits 2/4/8/16; the combine kernel (combine_partials) is
             held against combine_partials_ref and timed at the partials
             flash_decode merges at those two shapes and at the split
             backend's; gemm is held at M on both sides of the
             skinny/tiled threshold; conv2d cuda (im2col + gemm) is timed beside its
             plain version and the torch backend (F.conv2d) at three
             ResNet-50 layers.  The SSD scan is also timed as the mamba
             layer calls it (with D) at every chunk-padded prompt length of
             phase 10, and one empty kernel launched through the same
             ctypes path gives the floor under every short row; after
             phase 12, torch.profiler gives the device time alone of the
             empty launch, of rmsnorm beside F.rms_norm (bf16 too, at the
             prefill rows), of the narrow bf16 decode beside SDPA and of the
             SSD scan's three kernels.  The
             attention kernel (flash_attention.cu:
             chunk, paged chunk and whole-sequence, one body over shards of
             attention_shard_cols(S) columns and a combine) is held over
             several shards at D 96-256 and Dv != D, and its rows must be
             bitwise the same at B = 1 and B = 4, in one T = 64 chunk or in
             two (17 + 47), through fp32 pages and with fewer query rows;
             batched_gemm's rows bitwise at M = 1-128 (both kernels, both
             tiles) and equal to gemm's product per expert.  The chunk
             and paged chunk kernels are also held at phase 14's verify
             shape (phi3-mini, B 4, T = spec_k + 1 = 4, S 1024, starts
             731/400/129/0): verify_attention, paged_verify_attention over
             fp32 pages (bitwise the dense kernel's) and the two-source
             paged_verify_attention_q over int8 pages, each beside SDPA;
             dense_q is timed at phi3-mini's engine decode and prefill
             shapes as ref (float64), torch (dequantize + matmul) and the
             fp32 gemm.cu on fp32 weights (numbers only: no int8 kernel).
             The bf16 entries (gemm, rmsnorm, flash_attention, flash_decode
             with its wide layout, the combine, batched_gemm and ssd_scan)
             run at every call shape of the bfloat16 configs (every
             layer-stack config's decode step and prefill, seamless-m4t's;
             the MoE router stays an fp32 gemm; the scan's dt and A fp32,
             and ssd_scan with D at phases 10 and 19's prompt lengths):
             each must equal the fp32 entry's output on the upcast inputs
             rounded once, bit for bit (the scan's state equal), but gemm's,
             batched_gemm's and flash_attention's, which multiply on the
             tensor cores (wgmma), rmsnorm's (16-byte bf16 pieces, its own
             order) and the narrow flash_decode's (D, Dv <= 256: mma.sync,
             the shards merged in a cluster; the wide layout stays bitwise),
             and lie within one bf16 ulp (+1e-4) of its
             plain version; the two GEMM entries are also held at ragged
             edge shapes (both plans, TMA and element staging) and to one K
             order for every row: rows at M = 1-256 bitwise one M = 1024
             call's whichever plan runs either, at gemma3-1b's, qwen2's and
             a ragged width, each expert's rows bitwise gemm_bf16's; the
             attention body at edge shapes (element loads, GQA 1-64, rows
             that see nothing, a ragged last tile, five shards) and to one
             order for every row: rows from 1-511 on of a B = 1 call bitwise
             a B = 2 call's at D 64-256, Dv 64-256 and a ragged 30, causal,
             windowed and not, G = 1 (one shard) and G = 4 (shards);
             rmsnorm and the narrow decode at edge shapes (widths off 8,
             unaligned x or q, D 9000's two-pass path, the residual, length
             0 giving 0, one to eight shards, two head groups) and to one
             order for every row: rmsnorm rows bitwise across calls of
             1-1024 rows at every served D, with and without the residual;
             decode rows of a B = 4 call bitwise the B = 1 call at D 64,
             112, 128 and 256, G 1 and 4, lengths 0, 1, 63-65 and S; timed beside
             the fp32 entry, the plain version and the library call on
             bf16 inputs, the bound at 2 bytes a value and 989 TFLOP/s.
             The fp32 entries of batched_gemm, ssd_scan and flash_attention
             (FP32_ROWS: no full-width phase runs them) get their own rows
             at the same calls on the upcast inputs.  The partial kernel's
             bf16 entry (flash_decode_partial_bf16, phase 24's length-sharded
             decode) runs at SPLIT_BF16_SHAPES: phi3-mini's engine decode at
             n_splits 2, gemma3-1b's global decode at n_splits 2-16 and MLA's
             absorbed decode (D 576, Dv 512) at n_splits 2; its acc must be
             the fp32 entry's acc on the upcast inputs rounded once and its
             m and l the fp32 entry's, bit for bit, within one bf16 ulp
             (+1e-4; m and l 1e-4) of its plain version, and cuda_split at
             bf16 within the roundings of the merge of the plain partials.
4. model   — a small model's prefill and decode Programs on the card agree
             with the same Programs on the CPU (plain PyTorch path): dense,
             paged fp32 (1e-4) and paged int8 (logits within 5e-2); and the
             reduced gemma3-1b, qwen2-moe-a2.7b, mamba2-370m, zamba2-7b and
             deepseek-v2-lite-16b layer-stack LMs' and the reduced
             seamless-m4t-medium EncDec's prefill, caches and decode on the
             card agree with the CPU's (1e-4).  The reduced layer-stack LMs
             serve fp32: their launches are the "model" path of the kernels
             line, which must hold every FP32_ROWS entry.
5. serving — phi3-mini widths, depth cut to SERVE_LAYERS = 4 of 32 (for
             the script's time limit; phases 5-7, 11 and 13-17 serve this
             model), random weights from a seed:
             the engine serves 8 requests (4 slots, chunk 64, cache 1024);
             every request's tokens must equal the unbatched reference's,
             every kernel's launch count must rise, and the step assignment
             must show ``cuda`` for dense, rmsnorm and both attentions.
6. paged   — the same model, weights, slots, chunk and cache with the paged
             fp32 cache (page 16, 256 blocks = the dense memory), in two
             waves: phase 5's requests plus A (a 512-token shared prefix S
             and a tail), then B and C (S plus other tails) and D (A's
             written stream plus one diverging token, which claims A's
             partial tail page and copies it on its first write).  Every
             request must be token-exact against the dense reference, wave
             2 must hit the prefix cache and copy on write, and only the
             paged attention kernels may run.
7. kv8     — the same two waves with int8 pages and the block count of
             equal bytes; completion, launches, hits and copies are checked,
             and agreement with the fp32 reference is reported, not
             asserted (int8 KV is lossy).
8. layerstack — gemma3-1b at its published widths, all 26 layers, at its
             published bfloat16 (serving_config: every kernel op it runs
             has a bf16 body; 2.6 GB of weights with the transposed tied
             embedding), random weights from seed 0 drawn on the card: the continuous
             batcher (4 slots, cache 2048) serves 8 requests of 200-1400
             prompt tokens (both sides of the 512 window) and STACK_NEW (16)
             new tokens each; every request must equal the unbatched
             greedy prefill + decode on the card token for token, and flash_attention,
             flash_decode, rmsnorm and gemm must launch as the path needs,
             every launch on their bf16 entries, with every weight and
             cache bf16 and every kernel op on cuda.
9. moe     — qwen2-moe-a2.7b at its published widths, all 24 layers, at
             its published bfloat16 (weights drawn on the card from seed 0,
             the router fp32 as JAX's init makes it; 64 experts of which 60
             routed, top-4, local dispatch): the same batcher set-up serves
             8 requests of 200-1400 tokens, 16 new tokens each, token-exact
             against batch-1 greedy; batched_gemm (72 launches per call),
             gemm, rmsnorm, flash_attention and flash_decode launch exactly
             as the path needs, on their bf16 entries, the router on the
             fp32 gemm.
10. ssm    — mamba2-370m at its published widths, all 48 layers, bfloat16
             (dt_bias, A_log and D fp32): 8 requests of 200-1400 tokens, 16
             new each, token-exact; ssd_scan_bf16 launches 48 times per
             prefill.  Each layer-stack phase prints its weights' GB and
             every leaf's elements by element size.
             Phase 3 times every kernel call of phases 8-10 at a batch-4
             decode step and a 1024-token prefill, and each phase's time is
             printed by kernel beside the sum of the kernels' bounds.
11. split  — (run right after phase 7, on phase 5's weights) phase 5's
             model, requests, slots, chunk and cache served by
             build_lm_serving under FixedPolicy(per_op={"decode_attention":
             ("cuda_split", "cuda", "ref")}): every request token-exact
             against an UnbatchedReference compiled under the same policy,
             flash_decode_partial launched once per layer per decode tick
             and flash_decode never, the decode assignment cuda_split;
             agreement with phase 5's tokens is reported, not asserted (the
             split reorders float adds).  Then the engine's decode and
             prefill Programs are compiled under AutotunePolicy (a cache
             file in a temporary directory) and CostModelPolicy(H100_SXM):
             their picks and decode_attention's timings are printed, no
             cuda* backend may be timed as inf, and a second
             AutotunePolicy on the same file must measure nothing.
12. cnn    — the paper's five CNNs (WRN-40-2, MobileNetV1, ResNet-18,
             Inception-v3, ResNet-50) at their published widths and input
             sizes, batch 1, simplified once and compiled under the six
             assignments of repro_torch.launch.cnn_eval (gemm, cuda,
             direct, winograd, cost_model, autotune): every output within
             max|a - b| / max|b| <= 1e-4 of the gemm assignment's (1e-3
             where an assignment holds a winograd layer), the simplified
             graph within 1e-4 of the unsimplified one, gemm.cu launched
             once per cuda conv node and no other kernel; ms per model and
             assignment (median of 5 after a warm-up, synchronised), the
             winner, and ResNet-50's five slowest layers under autotune
             (run_instrumented).  Then cnn_eval --int8: each model's fp32
             and int8 Programs under (torch, ref), the int8 output within
             JAX_INT8_MAX_ABS_ERR x INT8_ERR_MARGIN of the fp32 one (the JAX
             package's run_quant error at the same seed), weights >= 3.9x
             smaller.
13. int8w  — (after phase 11, on phase 5's weights) phase 5's requests
             served by build_lm_serving(quantize="int8") on the dense cache:
             every request token-exact against the quantized unbatched
             reference (one shared calibration on the card); agreement with
             phase 5's fp32 tokens reported; every dense node dense_q on ref
             (no gemm launch), rmsnorm and the attention kernels launched
             exactly as the graphs need; the quantized weights >= 3.9x
             smaller (the whole Program's ratio printed: the embedding stays
             fp32); decode and prefill ms a tick, peak GB.
14. spec   — the same model and requests with spec_k 3 and the default
             draft (half the layers): the dense, paged fp32 and int8-weight
             engines token-exact against their references (phases 5 and
             13); then the int8-page engine over phase 7's two waves, its
             tokens bitwise phase 7's.  Each prints spec ticks, proposed,
             accepted, accept rate, ms per emitted token and peak GB;
             conservation and pool integrity are checked, and every Program
             call (prefill, draft prefill, draft, verify, commit) launches
             exactly its graph's kernels: the verify rows once per layer a
             verify call, the kv8 verify's paged decode (spec_k + 1) x the layer
             count times.  The dense stepper's verify logits are compared with
             its decode logits at the same positions (max |diff| and the
             top-2 gap wherever the argmax differs are printed).
15. heal   — (after 14, on phase 5's weights) four engines built with
             self_heal: dense and spec dense (spec_k 3) over phase 5's
             requests, paged fp32 (256 blocks) and paged int8 (1021) over
             phases 6 and 7's two waves.  Each is warmed with one request,
             its hang deadline set to 4x its slowest warm call + 1 s, then
             three faults at call indices drawn from HEAL_SEED land in it: a
             Python exception, a real CUDA out-of-memory error (an
             allocation of the card's whole memory) and a device spin
             (torch.cuda._sleep) that overruns the deadline; at least one
             in a prefill call, one in a decode (spec: verify) call.  Every
             request must finish with the uninterrupted phase's tokens
             (5, 6, 7, 14) and stream them without duplicate or skip;
             crash / hang / recovery counts exactly as injected; the pool
             intact after each recovery and leak-free at the end; rows
             resumed from surviving state; the coordinator's generation up
             once per recovery; every Program call launching exactly its
             graph's kernels.  Prints failed ticks, recovered rows, extra
             prefill ticks, ms from each failure to the next good tick, the
             run's wall time beside the uninterrupted one, and the resumed
             chunk-kernel logits against the decode (verify) logits the
             failed tick computed at the same positions.
16. load   — benchmarks/serve_bench.py's overload experiment at phi3-mini
             width on the paged fp32 engine (page 16, 4 slots, chunk 64,
             cache 1024, max_queue 8, self_heal, a pool sized so slots and
             not blocks bind): 48 requests of a seeded two-tier trace
             (phase16_trace_config) at 2x the drain rate, tier-blind then
             tier-aware (slo_ttft_ticks 24), each after one warm-up
             request.  Conservation, tier-aware high-tier SLO attainment
             over offered requests strictly above tier-blind's, no
             preemption blind and at least one aware, and every preempted
             victim's and 8 other requests' tokens equal to the unbatched
             reference; prints per tier attainment, goodput, TTFT in ticks
             and seconds, shed and dropped.

17. deploy — OXF bundles and the asyncio front end; 17a, 17c and 17d run
             right after phase 5 on its weights and engine (which then goes,
             as in the phases after it), 17b right after phase 13.
             17a: phase 5's decode (B 4, cache 1024) and prefill (chunk 64)
             Programs rebuilt at DEPLOY_LAYERS (2) layers on phase 5's
             weights under FixedPolicy, each saved to its own bundle in a
             temporary directory under build/ and loaded with load_program
             on the card: model.json pins "pallas" where the Program ran
             "cuda", the loaded assignment equals the original's, every
             output on two seeded inputs equals the original's bitwise with
             the same kernel launches per call, and 16 greedy tokens of 4
             prompts through the loaded prefill and decode pair equal the
             originals'.  17b: phase 13's int8-weight decode Program (all
             its layers, shared calibration) saved, loaded and held the same
             way, program.json saying quantized; footprint_table of phase
             5's fp32 and this int8 decode Program.  17c: the golden bundle
             tests/golden/tiny_int8 (pinned xla: torch in the port) gives
             its expected_y on the card (rtol 1e-5, atol 1e-6) and re-saves
             model.json and program.json byte-identical.  17d: phase 5's
             engine, its metrics reset, streams phase 5's 8 requests as 8
             concurrent AsyncEngine.generate streams driven by run(): every
             stream equals phase 5's tokens, in phase 5's tick counts; then
             launch.serve --engine --int8 at its defaults, in-process.
             Prints bundle bytes, save, load and first-call seconds and the
             async tokens/s beside phase 5's.
18. tp     — tensor-parallel serving (right after phase 16), at phi3-mini's
             widths with depth cut to TP_LAYERS = 4 of 32 (for the
             script's time limit; phase 5's weights are dropped and the
             seed-0 weights drawn at that depth): the parent serves phase
             5's 8 requests (32 new) on single-rank dense, paged fp32 and
             paged int8 engines (phases 5-7's settings), then drops them
             and the weights; gloo's
             batch_isend_irecv is tried directly on CUDA tensors by a
             pair of ranks (a refusal may abort the pair: why the ring
             matmul stages through host memory); then two ranks on cuda:0
             over gloo (launch/mesh.py spawn_ranks) each draw the seed-0
             weights on the card and build build_lm_serving(mesh=...) for
             the three engines at the same depth: every attention node of
             the decode and prefill Programs on "tp", each rank's caches
             at 16 of 32 kv heads, tokens equal to the single-rank
             engine's on both ranks, launches a rank exactly the tick
             counts' (flash_decode + combine_partials or flash_paged_decode
             + combine_partials a decode tick, flash_chunk_attention or
             flash_paged_chunk_attention a prefill tick, 8 each, at 16 of
             32 query heads; gemm and rmsnorm replicated); a self_heal
             paged fp32 engine with crashes at stepper calls TP_HEAL_CALLS
             on both ranks, two recoveries, the clean run's tokens; each
             rank's flash_decode, flash_chunk_attention and the paged
             kernels (fp32 and int8) at 16 of 32 heads against their
             plain versions (phase 3's shapes and tolerance);
             ring_allgather_matmul at the decode gemm against the whole
             product (its chunks host-staged over gloo); then
             tree_decode_attention at phase 3's engine decode shape and
             the gemma3-1b global shape, the KV length split over the
             ranks, within 1e-4 of flash_decode with one
             flash_decode_partial launch a rank.  Prints ms a tick TP
             against single-rank, the all-gathers' share of the ticks of
             a short extra run on each TP engine under torch.profiler on
             rank 0, peak GB a rank, the backend and transport; two
             ranks on one card check the sharded path, they do not
             measure TP speed.

19. hybrid — zamba2-7b at its published widths, all 81 blocks (70 Mamba2,
             11 applications of two alternating shared attention blocks on
             concat(h, emb0)), bfloat16 (weights from seed 0 on the card):
             phase 8's batcher set-up, 8 requests of 200-1400 tokens,
             16 new each, token-exact against batch-1 greedy; 11
             flash_attention and 70 ssd_scan launches a prefill, 11
             flash_decode launches a step, every kernel exactly as
             stack_calls counts.
20. mla    — deepseek-v2-lite-16b at its published widths, all 27 MLA + MoE
             layers (64 routed experts top-6, 2 shared, local dispatch),
             bfloat16: the same set-up and gates; the absorbed decode
             launches flash_decode_bf16's wide layout (D 576, Dv 512, 16
             query heads on 1 KV head) 27 times a step and batched_gemm_bf16
             2 x 27 times for its per-head products.
21. encdec — seamless-m4t-medium at its published widths (12 encoder + 12
             decoder layers, bfloat16 as serving_config picks it, 1.6 GB;
             the launches on the bf16 entries): EncDec.prefill of 4 sources of
             ENCDEC_SRC (1024) numpy-seeded frame embeddings with
             ENCDEC_PROMPT (64)-token prompts, then ENCDEC_NEW (32) greedy
             tokens by decode_step; every source's tokens equal a batch-1
             run of it; 12 non-causal encoder, 12 cross and 12 causal
             flash_attention launches a prefill, 24 flash_decode launches a
             step (12 self, 12 cross over the encoder rows).
             Phases 19-21 run after 8-10, each dropping its weights first.
22. train  — (after 21, every engine dropped) gemma3-1b at its published
             widths and depth (26 layers, d_model 1152, 4 heads on 1 kv
             head of 256, d_ff 6912, tied vocab 262144; 1.00 B params),
             fp32, trained through the port's path: strip_derived
             (init_params(0)), AdamW (lr 1e-3, warmup_cosine(lr, 20,
             TRAIN_STEPS)), make_train_step(donate=True) with remat, on
             TRAIN_BATCH x TRAIN_SEQ (4 x 1024) SyntheticLM tokens, for
             TRAIN_STEPS (8) steps; CheckpointManager saves params and
             optimizer state (16 GB) under build/ at step TRAIN_SAVE_AT
             (4), restores them into fresh tensors (a meta target) and
             reruns steps 5-8.  Fails unless every loss and grad norm is
             finite, every param leaf moved, the resumed losses and params
             are bitwise the uninterrupted run's, and no kernel of the
             port launched (training runs on the config's differentiable
             plain backends, as the JAX package's does).  Prints ms a step
             (median of steps 2-8, synchronised), tokens/s, peak GB, the
             step's bound ((6 N T + 3x the forward attention) FLOP at 67
             TFLOP/s), checkpoint bytes, save (device-to-host copy, then
             write) and restore seconds.
22b. train_bf16 — (after 22) gemma3-1b at its published widths, depth
             and dtypes: bf16 params (init_params(0), no override), f32
             masters, mu and nu; phase 22's AdamW, schedule, batches and
             make_train_step(donate=True) with remat, TRAIN_BF16_STEPS (4)
             steps, step 1 also run from a copy of the initial state.  Fails
             unless the losses and grad norms are finite, every master leaf
             moved, every param leaf is its master rounded once to bf16 (the
             norm scales at 1.0 keep their value under the warmup's lr: less
             than half a bf16 ulp), the dtypes hold, step 1 repeated is
             bitwise step 1, step 1's loss lies within 1e-2 relative of
             phase 22's fp32 step-1 loss and no kernel launched.  No
             checkpoint: a bf16 leaf does not restore in either package.
             Prints ms a step (median of steps 2-4) and step 1, tokens/s,
             peak GB and the bounds (train_flops at 989 TFLOP/s bf16;
             AdamW's pass over 2 + 4 + 4 + 4 bytes a parameter, read and
             written once, at 3.35 TB/s).
23. mesh_train — (after 22) gemma3-1b at its published widths cut to
             MESH_TRAIN_PERIODS (1) period, 6 layers (5 sliding-window + 1
             global; 0.46 B params, the 1.21 GB tied vocab included), fp32:
             23a one process, init_params(0), phase 22's AdamW and schedule,
             TRAIN_BATCH x TRAIN_SEQ SyntheticLM tokens, remat: step 1's
             value_and_grad, then MESH_TRAIN_STEPS (2) make_train_step
             (donate=False) steps, gradients, losses, grad norms and params
             kept on the host; 23b four ranks on the card over gloo
             (spawn_ranks, make_mesh((2, 2), ("data", "model"))), each
             sharding the same init by train_state_shardings: step 1's
             value_and_grad(mesh=...) and two donated
             make_train_step(mesh=...) steps, rank 0 saving the state
             through CheckpointManager(specs=, mesh=); 23c pipeline_apply on
             a ("pod",) mesh of the same ranks: blocks 0-3 of the init as
             four stages of one sliding-window block's train-mode forward
             on PIPE_MICRO (8) seeded (1, 1024, 1152) microbatches.  Fails
             unless step 1's gathered gradients lie within 1e-4 of each
             leaf's largest |value| of 23a's, the losses and grad norms
             within 1e-5 relative on every rank, the gathered params after
             step 2 within 1e-4, every rank's mu holds the elements its
             specs give it (fewer than the params'), the checkpoint
             restored in this process on one device has the sha256 of every
             leaf rank 0 gathered, the pipeline equals the sequential
             blocks within 1e-5 of its largest |value| on every rank, each
             stage running once a microbatch (8 times in the schedule's
             11 ticks), and no kernel launched.  23c's backward pass: every
             rank backpropagates the same seeded loss sum(y * G) through
             pipeline_apply, and each stage's gradient of its block's params
             and every rank's gradient of the input must lie within 1e-4 of
             the largest |value| of the sequential blocks' gradient, which
             the rank computes in its own process.  Prints ms a step of 23a and of
             23b by rank (functional: gloo through the host on one card, no
             DP or TP speed), peak GB a rank and their sum, rank 0's bytes
             gathered and all-reduced in a step, checkpoint save and restore
             seconds, the pipeline's ticks and bubble (3/11).
24. mesh_serve — (in phase 23's four ranks, after 23c dropped the training
             state) gemma3-1b at its published widths, depth and bfloat16
             (26 layers, 4 heads on 1 KV head of 256), init_params(0) whole
             on every rank, every kernel op on ``cuda`` (CUDA_BACKENDS), on
             the (data 2, model 2) mesh: runtime/serve.py's
             make_prefill_step (SERVE_BATCH (4) seeded prompts of
             SERVE_PROMPT (1000) tokens into a cache of SERVE_CAP (2048))
             then SERVE_STEPS (16) make_decode_step steps on three paths:
             seq_shard_fallback on (1 KV head: every k / v length over
             "model", the tree decode on flash_decode_partial_bf16), off
             (the caches replicated over "model", flash_decode_bf16), and
             batch 1 for SERVE_STEPS_B1 (8) steps (the length over "data").
             Rank 0 runs the one-process reference (LM.prefill,
             LM.decode_step on the whole cache, greedy) and the same config
             at fp32 on the upcast weights fed its tokens, and broadcasts
             them.  The replicated path decodes greedily and must give the
             reference's tokens and logits bit for bit (every op is
             batch-invariant); the length-sharded paths round each rank's
             partial acc to bf16 (as JAX's step does) and are fed the
             reference's tokens: their logits must lie within the bound,
             twice the reference's bf16-vs-fp32 gap (relative to its
             largest |logit|), and an argmax may differ from the
             reference's only where its top-2 logits lie within that row's
             window, twice the row's |bf16 - fp32| at that step (the count,
             the gaps and the windows are printed).  Every path's logits are bf16, its
             kernel launched and no fp32 decode entry ran.  Prints ms a
             decode step by rank (functional: gloo through the host on one
             card) and rank 0's bytes gathered and all-reduced a step.  The
             kernels line's "mesh_serve" launches are the three paths' on
             every rank; the reference's stay in the phase record.
25. dryrun — (on the host) build_cell of phase 22's step (gemma3-1b, 26
             layers, fp32, TRAIN_BATCH x TRAIN_SEQ, one device) lowered on
             fake tensors: its FLOPs (FlopCounterMode) against train_flops
             (a ratio, not gated) and its H100 roofline (datasheet
             constants: derived, not measured) beside phase 22's measured
             median step; then ``python -m repro_torch.launch.dryrun --arch
             gemma3-1b --shape decode_32k --mesh single`` in a subprocess
             (one rank of a fake 256-rank group).  Fails unless the step
             counts FLOPs and bytes and the cell's record has status "ok",
             FLOPs > 0 and wire bytes > 0.

The last three lines of standard output are JSON: the serving numbers
(phases 15, 16, 17 and 18 under "heal", "load", "deploy" and "tp"; 19-21 under
"hybrid", "mla" (with the k_cat copy's time) and "encdec"; 22 under "train",
22b under "train_bf16", 23 under "mesh_train", 24 under "mesh_serve", 25 under "dryrun"), one entry per kernel (``{"kernels": [...]}``), and the result line.  Without a CUDA device, or away from the
repository's ``src/``, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # H100 SXM, dense bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3
# a bf16 entry against its plain version: one bf16 ulp (at most 2^-7 of the
# value; both round one fp32 result once) plus the fp32 full-width atol
BF16_TOL = dict(atol=1e-4, rtol=2.0 ** -7)
BF16_KERNELS = ("gemm", "rmsnorm", "flash_decode", "flash_attention", "combine_partials",
                "batched_gemm", "ssd_scan")
# the bf16 entries that multiply on the tensor cores (wgmma, csrc/gemm.cu
# and csrc/flash_attention.cu): not the fp32 entry's arithmetic, so held to
# their plain version within BF16_TOL and to one order for every row
# (bf16_gemm_cases, bf16_attention_cases), not bitwise to the fp32 entry's
# output rounded once
TENSOR_CORE_BF16 = ("gemm", "batched_gemm", "flash_attention")
# the served widths of the bf16 bodies with an order of their own since the
# tensor-core GEMM and attention: rmsnorm_bf16 (its 16-byte bf16 layout) at
# every served D, and the narrow flash_decode_bf16 (mma.sync, the shards
# merged in a cluster) at every served narrow head width; both held to
# their plain version within BF16_TOL and to one order for every row
# (bf16_norm_decode_cases), not to the fp32 entry's output rounded once
BF16_NORM_DS = (1024, 1152, 2048, 3584, 7168)
BF16_NORM_ROWS = (1, 4, 17, 256, 1024)
BF16_DECODE_DS = (64, 112, 128, 256)
BF16_DECODE_LENS = (0, 1, 63, 64, 65)
# the M of the bf16 GEMM's row gate: both sides of every plan's 64-row
# warpgroup and 128-row tile
BF16_GEMM_MS = (1, 4, 16, 17, 32, 63, 64, 65, 127, 128, 256)
# the bf16 attention body's row gate: every panel count of Dv, D off 16
# (112) and off 8 (30: element loads); rows from both sides of a 64-row
# tile's edge and of the 256-column shards
BF16_ATTN_WIDTHS = ((64, 64), (112, 112), (128, 128), (192, 128), (256, 256), (30, 30))
BF16_ATTN_FIRSTS = (1, 63, 64, 65, 255, 257, 511)
# the kernels whose fp32 entries no full-width serving phase runs (every
# layer-stack config serves bf16): phase 3 times them at the same calls on
# the upcast inputs, beside their bf16 entries
FP32_ROWS = ("batched_gemm", "ssd_scan", "flash_attention")

# Max |int8 - fp32| of each CNN's output as the JAX package reports it:
# benchmarks/fig2_inference_time.py::run_quant([model]) for each model alone
# (FixedPolicy(("xla", "ref")), the input the first draw of seed 0,
# calibrated on it), run on the CPU;
# tests/test_torch_quant.py recomputes two of them.  Phase 12 holds the
# card's int8 outputs to these times INT8_ERR_MARGIN: the port calibrates
# in another summation order, so a few activations round the other way
# (on the CPU its errors lie within 0.06% of these).
JAX_INT8_MAX_ABS_ERR = {
    "wrn-40-2": 0.0486445426940918,
    "mobilenet-v1": 0.0015187263488769531,
    "resnet-18": 0.024120330810546875,
    "inception-v3": 0.003762483596801758,
    "resnet-50": 0.0269317626953125,
}
INT8_ERR_MARGIN = 1.05
# phi3-mini's depth in the engine phases (5-7, 11, 13-18), of its 32: the
# script's time limit (every layer is the same shapes, so the kernels see
# what the full depth gives them; each tick launches them per layer)
SERVE_LAYERS = 4
# new tokens a request in the layer-stack phases (8-10, 19, 20): the
# script's time limit (each phase's batch-1 reference decodes them too)
STACK_NEW = 16


def fail(msg: str, code: int = 1) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(*parts) -> None:
    print(*parts, flush=True)


def release(torch) -> None:
    """Free the card's memory of what a phase dropped: count_calls' wrappers
    hold their stepper in a reference cycle, which only the collector
    breaks."""
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# measurement helpers
# --------------------------------------------------------------------------- #

class Timer:
    """Median time of ``fn()`` over ``reps`` launches, each after a write of
    a buffer larger than the 50 MB L2, with CUDA events around the call
    alone (the serving path finds its weights and caches cold)."""

    def __init__(self, torch, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            times.append((e0, e1))
        torch.cuda.synchronize()
        vals = sorted(a.elapsed_time(b) for a, b in times)
        return vals[len(vals) // 2]


def device_ms(torch, timer, fn, reps=15):
    """Device time of ``fn``'s kernels per call, by kernel name, from
    torch.profiler (each call after the Timer's L2 flush, whose fill kernel
    is left out): what a short row's event time holds besides its launch
    path.  {} when the profiler records no device time on this machine."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and "fill" not in e.key.lower() and not e.key.startswith(("aten::", "cuda")):
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            out[name.split("(")[0].split("::")[-1][:40]] = t / reps / 1e3
    return out


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(least ms, what bounds it): the operations over ``peak`` (fp32 FFMA,
    or the bf16 tensor-core rate for a bf16 row) or the bytes over HBM."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def max_err(torch, got, want) -> float:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("non-finite kernel output")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_close(torch, name, got, want, atol, rtol) -> float:
    err = max_err(torch, got, want)
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()):
        fail(f"{name}: max |err| {err:.3e} exceeds atol {atol} + rtol {rtol}*|plain|")
    return err


def instance_name(fn, kernels):
    """``kernel<template ints and bools>`` for a mangled function name that
    holds one of ``kernels``, else None."""
    for kernel in (k for k in kernels if k in fn):
        args = re.search(rf"{kernel}I(.*?)EEv", fn)
        ints = re.findall(r"L[ib](\d+)E", args.group(1) + "E") if args else []
        return f"{kernel}<{', '.join(ints)}>" if ints else fn
    return None


def ptxas_usage(log, kernels):
    """{instance: (registers, spill store bytes)} from nvcc's -Xptxas -v
    lines for every entry function whose name holds one of ``kernels``."""
    usage, name, spill = {}, None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name, spill = instance_name(entry.group(1), kernels), 0
        elif name is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name is not None and re.search(r"Used \d+ registers", line):
            usage[name] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
            name = None
    return usage


def sass_counts(cuda_mod, lib_path, opcodes):
    """{instance (its template arguments): lines of its kernel's opcode in its
    SASS} for every function of the built library whose name holds a kernel
    of ``opcodes`` ({kernel: opcode}; cuobjdump -sass, beside nvcc, read
    once)."""
    tool = Path(cuda_mod._nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300)
    if dump.returncode != 0:
        fail(f"cuobjdump -sass failed: {dump.stderr.strip()[-500:]}")
    counts, name, opcode = {}, None, None
    for line in dump.stdout.splitlines():
        if "Function :" in line:
            name = instance_name(line.split("Function :", 1)[1].strip(), tuple(opcodes))
            if name is not None:
                counts[name] = 0
                opcode = opcodes[name.split("<")[0]]
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


# --------------------------------------------------------------------------- #
# phase 3: kernels
# --------------------------------------------------------------------------- #

def kernel_cases(torch, K):
    """Small edge cases of each kernel against its plain version.  Tolerance
    2e-5 (abs and rel): both sides are fp32, summed in another order."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    tol = dict(atol=2e-5, rtol=2e-5)
    n = 0
    for m, nn, kk in ((5, 37, 19), (1, 64, 64), (64, 130, 33), (4, 3, 1), (70, 65, 200),
                      (16, 300, 301), (17, 300, 301), (16, 77, 300), (17, 77, 300)):
        x, w = rn(m, kk), rn(kk, nn)
        check_close(torch, f"gemm {m}x{nn}x{kk}", K.gemm(x, w), K.gemm_plain(x, w), **tol)
        n += 1
    # rows bitwise through the skinny/tiled threshold and across the tiles:
    # M = 256 takes 128x128 at this N, M = 17..127 take 32x64
    x, w = rn(256, 301), rn(301, 8269)
    full = K.gemm(x, w)
    for m in (1, 4, 16, 17, 127):
        if not torch.equal(K.gemm(x[:m].contiguous(), w), full[:m]):
            fail(f"gemm: rows at M={m} are not bitwise those at M=256")
        n += 1
    for rows, d in ((1, 8), (7, 96), (3, 3072), (5, 100), (2, 3), (3, 7168), (2, 9001)):
        x, w, r = rn(rows, d), rn(d), rn(rows, d)
        check_close(torch, "rmsnorm", K.rmsnorm(x, w), K.rmsnorm_plain(x, w), **tol)
        check_close(torch, "rmsnorm+res", K.rmsnorm(x, w, residual=r),
                    K.rmsnorm_plain(x, w, residual=r), **tol)
        n += 2
    for hq, hk in ((1, 1), (2, 1), (4, 2), (4, 4)):
        for d, dv in ((8, 8), (96, 96), (8, 16), (96, 64)):
            for scale in (None, 0.0):
                b, s = 3, 70
                q, k, v = rn(b, hq, d), rn(b, s, hk, d), rn(b, s, hk, dv)
                lengths = torch.tensor([0, s, 37], dtype=torch.int32, device="cuda")
                sc = (1.0 / math.sqrt(d)) if scale is None else scale
                got = K.flash_decode(q, k, v, lengths, scale=scale)
                check_close(torch, f"flash_decode hq={hq} hk={hk} d={d} dv={dv}",
                            got, K.flash_decode_plain(q, k, v, lengths, sc), **tol)
                if float(got[0].abs().max()) != 0.0:
                    fail("flash_decode: a length-0 row is not 0")
                n += 1
            b, t, s = 3, 16, 48
            q, k, v = rn(b, t, hq, d), rn(b, s, hk, d), rn(b, s, hk, d)
            for start_vals in ((0, 5, s - t), (s - t, 0, 20)):  # start + T == cap
                start = torch.tensor(start_vals, dtype=torch.int32, device="cuda")
                for scale in (None, 0.0):
                    sc = (1.0 / math.sqrt(d)) if scale is None else scale
                    check_close(torch, f"flash_chunk_attention hq={hq} hk={hk} d={d}",
                                K.flash_chunk_attention(q, k, v, start, scale=scale),
                                K.flash_chunk_attention_plain(q, k, v, start, sc), **tol)
                    n += 1
    # flash_attention: causal or not, windows 1, 16, past the sequence and
    # none, Sq < Skv, GQA 1/2/4, D 16-256, Dv != D, lengths off the tiles
    for b, sq, skv, hq, hk, d, dv in ((2, 37, 37, 4, 4, 16, 16), (1, 70, 100, 4, 2, 96, 96),
                                      (2, 45, 45, 4, 1, 128, 128), (1, 130, 130, 4, 1, 256, 256),
                                      (1, 33, 50, 2, 1, 24, 16), (3, 20, 97, 2, 2, 96, 64)):
        q, k, v = rn(b, sq, hq, d), rn(b, skv, hk, d), rn(b, skv, hk, dv)
        for causal in (True, False):
            for window in (None, 1, 16, skv + 5):
                got = K.flash_attention(q, k, v, causal=causal, window=window)
                check_close(torch, f"flash_attention {b}x{sq}x{skv} hq={hq} hk={hk} d={d} "
                            f"dv={dv} causal={causal} window={window}", got,
                            K.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                    scale=1.0 / math.sqrt(d)), **tol)
                n += 1
    q, k, v = rn(4, 4, 256), rn(4, 512, 1, 256), rn(4, 512, 1, 256)   # gemma3's decode
    lengths = torch.tensor([512, 300, 1, 0], dtype=torch.int32, device="cuda")
    check_close(torch, "flash_decode D=256 G=4", K.flash_decode(q, k, v, lengths),
                K.flash_decode_plain(q, k, v, lengths, 1.0 / 16), **tol)
    n += 1
    # batched_gemm: M, N and K ragged against the tiles and the K steps, M on
    # both sides of the skinny/tiled threshold, one expert to 64
    for e, m, nn, kk in ((3, 5, 37, 19), (1, 64, 64, 64), (8, 70, 65, 200), (64, 3, 16, 33),
                         (5, 16, 77, 300), (5, 17, 77, 300)):
        x, w = rn(e, m, kk), rn(e, kk, nn)
        check_close(torch, f"batched_gemm {e}x{m}x{nn}x{kk}", K.batched_gemm(x, w),
                    K.batched_gemm_plain(x, w), **tol)
        n += 1
    # ssd_scan: chunks of 10-128 (37 rows: off the 32-step contraction and the
    # 64-row tile), 1-4 chunks, G = 1-3 groups, state 5-128, P and N off the
    # 64-wide tiles (72, 70) and off the float4 groups (6, 5), with and without D
    for b, sl, h, p, grp, nn, q in ((2, 64, 4, 16, 1, 16, 16), (1, 37, 6, 8, 3, 32, 128),
                                   (1, 128, 2, 64, 2, 128, 64), (2, 96, 4, 24, 1, 8, 32),
                                   (2, 256, 2, 72, 1, 70, 128), (1, 60, 2, 6, 1, 5, 10)):
        x, bm, cm = rn(b, sl, h, p), 0.3 * rn(b, sl, grp, nn), 0.3 * rn(b, sl, grp, nn)
        dt = torch.nn.functional.softplus(rn(b, sl, h) - 2.0)
        a = -torch.linspace(0.5, 4.0, h, device="cuda")
        for dd in (None, rn(h)):
            y, st = K.ssd_scan(x, dt, a, bm, cm, dd, chunk=q)
            yp, stp = K.ssd_scan_plain(x, dt, a, bm, cm, dd, chunk=q)
            tag = (f"ssd_scan B={b} S={sl} H={h} P={p} G={grp} N={nn} Q={min(q, sl)} "
                   f"D={dd is not None}")
            check_close(torch, f"{tag} y", y, yp, **tol)
            check_close(torch, f"{tag} state", st, stp, **tol)
            n += 1
    torch.cuda.synchronize()
    return (n + paged_kernel_cases(torch, K, rn, g, tol) + split_kernel_cases(torch, K, rn, tol)
            + shard_kernel_cases(torch, K, rn, tol))


def bf16_gemm_cases(torch, K, limit_line):
    """The tensor-core bf16 GEMM (gemm_bf16, batched_gemm_bf16): edge shapes
    within BF16_TOL of the plain version (both plans; TMA staging and, with
    K or N off 8, element loads; M, N and K ragged against the 64-row
    warpgroup, the tiles and the 64-deep stages); then one K order for
    every row: at gemma3-1b's, qwen2's and a ragged width, the rows of a
    call at every M of BF16_GEMM_MS (the first rows and the last, so at
    other places in the tile) bitwise those of one M = 1024 call, whichever
    plan runs either; each expert's rows bitwise the batched call's at every
    M and gemm_bf16's product x[e] @ w[e] at M = 1 and 32.  Then the host
    cost of a call (the tensor maps are encoded at every launch) beside the
    fp32 entry's and the empty launch's at gemma3-1b's decode.  Returns
    the record."""
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    bf16 = torch.bfloat16

    def rb(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(bf16)

    n, worst = 0, 0.0
    for m, kk, nn in ((1, 64, 96), (4, 1152, 1000), (5, 37, 19), (16, 300, 264), (17, 64, 130),
                      (63, 15, 37), (64, 16, 40), (65, 17, 33), (127, 301, 19), (129, 301, 72),
                      (300, 1152, 6912), (1024, 6912, 1152), (1030, 301, 2050)):
        x, w = rb(m, kk), rb(kk, nn, scale=kk ** -0.5)
        worst = max(worst, check_close(torch, f"gemm_bf16 {m}x{nn}x{kk}", K.gemm(x, w).float(),
                                       K.gemm_plain(x, w).float(), **BF16_TOL))
        n += 1
    for e, m, kk, nn in ((3, 5, 37, 19), (64, 3, 16, 33), (8, 70, 65, 200), (5, 17, 77, 300),
                         (2, 130, 300, 264), (64, 130, 300, 264), (64, 32, 2048, 1408),
                         (64, 80, 1408, 2048), (16, 4, 128, 512)):
        x, w = rb(e, m, kk), rb(e, kk, nn, scale=kk ** -0.5)
        worst = max(worst, check_close(torch, f"batched_gemm_bf16 {e}x{m}x{nn}x{kk}",
                                       K.batched_gemm(x, w).float(),
                                       K.batched_gemm_plain(x, w).float(), **BF16_TOL))
        n += 1
    plans = set()
    for tag, kk, nn in (("gemma3-1b gate/up", 1152, 6912), ("gemma3-1b down", 6912, 1152),
                        ("gemma3-1b head", 1152, 262144), ("qwen2 expert", 2048, 1408),
                        ("ragged", 301, 2050)):
        x, w = rb(1024, kk), rb(kk, nn, scale=kk ** -0.5)
        full = K.gemm(x, w)
        plans.add(K.gemm_bf16_plan(1024, nn))
        for m in BF16_GEMM_MS:
            plans.add(K.gemm_bf16_plan(m, nn))
            if not (torch.equal(K.gemm(x[:m].contiguous(), w), full[:m])
                    and torch.equal(K.gemm(x[-m:].contiguous(), w), full[-m:])):
                fail(f"gemm_bf16 {tag}: rows at M={m} are not bitwise those at M=1024")
            n += 2
        del x, w, full
    if plans != set(K.BF16_TILES):
        fail(f"gemm_bf16: the row gate ran plans {sorted(plans)}, not every one of "
             f"{K.BF16_TILES}")
    for tag, kk, nn in (("qwen2 expert", 2048, 1408), ("qwen2 expert down", 1408, 2048),
                        ("MLA absorbed", 128, 512), ("ragged", 301, 250)):
        x, w = rb(8, 256, kk), rb(8, kk, nn, scale=kk ** -0.5)
        full = K.batched_gemm(x, w)
        for m in BF16_GEMM_MS:
            part = K.batched_gemm(x[:, :m].contiguous(), w)
            if not (torch.equal(part, full[:, :m])
                    and torch.equal(K.batched_gemm(x[:, -m:].contiguous(), w), full[:, -m:])):
                fail(f"batched_gemm_bf16 {tag}: rows at M={m} are not bitwise those at M=256")
            if m in (1, 32) and not all(torch.equal(part[e], K.gemm(x[e, :m].contiguous(), w[e]))
                                        for e in range(8)):
                fail(f"batched_gemm_bf16 {tag}: an expert's rows at M={m} are not bitwise "
                     "gemm_bf16's product")
            n += 2
        del x, w, full
    torch.cuda.synchronize()
    say(f"  bf16 GEMM (tensor cores): {n} checks, edge shapes within BF16_TOL (max |err| "
        f"{worst:.3e}); rows bitwise across M = {list(BF16_GEMM_MS)} and the plans "
        f"{sorted(plans)}, experts bitwise gemm_bf16's")
    # the host's cost of a call at gemma3-1b's decode q/k/v/o shape (no sync)
    x, w = rb(4, 1152), rb(1152, 1152)
    xf, wf = x.float(), w.float()
    host = {}
    for tag, fn in (("gemm bf16", lambda: K.gemm(x, w)),
                    ("gemm fp32", lambda: K.gemm(xf, wf)),
                    ("empty launch", lambda: K.empty_launch(x))) * 2:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        host[tag] = min(host.get(tag, us), us)
    say("  host us a call at 4x1152 -> 1152 (best of 2 x 500, no sync): "
        + ", ".join(f"{k} {v:.3f}" for k, v in host.items()) + f"  [{limit_line}]")
    return {"checks": n, "max_abs_err_edges": worst, "plans": sorted(plans), "host_us": host}


def bf16_attention_cases(torch, K):
    """The tensor-core bf16 attention body (flash_attention_bf16): edge
    shapes within BF16_TOL of the plain version (D or Dv off 8 and an
    unaligned q: element loads; D off 16; GQA 3, 8 and 64; rows before
    position 0 that see nothing and give 0; a ragged last tile in one shard;
    five shards), then one order for every row: at each width of
    BF16_ATTN_WIDTHS, causal, window 512 and non-causal, G = 1 (16 heads:
    one shard) and G = 4 (one kv head: 256-column shards), the rows of a
    B = 1 call from each ``first`` of BF16_ATTN_FIRSTS on bitwise those of
    a B = 2 call over all 700.  Returns the record."""
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    bf16 = torch.bfloat16

    def rb(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf16)

    def unaligned(x):  # the same values at a data pointer 2 bytes off 16
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    if -(-2100 // K.attention_shard_cols_bf16(2100, 1, 1)) != 5:
        fail("flash_attention_bf16: the edge shapes no longer hold a five-shard case")
    n, worst = 0, 0.0
    for b, sq, skv, hq, hk, d, dv, causal, window in (
            (1, 50, 50, 2, 2, 30, 30, False, None), (2, 300, 300, 4, 2, 6, 10, True, None),
            (2, 64, 700, 4, 2, 96, 96, True, None), (2, 80, 80, 8, 1, 128, 128, True, 17),
            (1, 700, 700, 64, 1, 64, 64, True, None), (1, 130, 130, 12, 4, 72, 40, False, None),
            (1, 80, 50, 4, 2, 64, 64, True, None), (2, 1030, 1030, 8, 8, 128, 128, True, None),
            (1, 2100, 2100, 1, 1, 256, 256, True, 1000)):
        q, k, v = rb(b, sq, hq, d), rb(b, skv, hk, d), rb(b, skv, hk, dv)
        label = (f"flash_attention_bf16 B={b} Sq={sq} Skv={skv} Hq={hq} Hk={hk} D={d} Dv={dv} "
                 f"causal={causal} window={window}")
        got = K.flash_attention(q, k, v, causal=causal, window=window)
        want = K.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       scale=1.0 / math.sqrt(d))
        worst = max(worst, check_close(torch, label, got.float(), want.float(), **BF16_TOL))
        if sq > skv and causal and bool(got[:, :sq - skv].float().abs().max() != 0):
            fail(f"{label}: rows that see no column are not 0")
        if d == 64 and not torch.equal(K.flash_attention(unaligned(q), k, v, causal=causal,
                                                         window=window), got):
            fail(f"{label}: an unaligned q (element loads) changes the bits")
        n += 1
    shards = set()
    for d, dv in BF16_ATTN_WIDTHS:
        for hq, hk in ((16, 16), (4, 1)):
            shards.add(K.attention_shard_cols_bf16(700, hq, hk))
            q, k, v = rb(2, 700, hq, d), rb(2, 700, hk, d), rb(2, 700, hk, dv)
            for causal, window in ((True, None), (True, 512), (False, None)):
                full = K.flash_attention(q, k, v, causal=causal, window=window)
                for first in BF16_ATTN_FIRSTS:
                    part = K.flash_attention(q[:1, first:].contiguous(), k[:1].contiguous(),
                                             v[:1].contiguous(), causal=causal, window=window)
                    if not torch.equal(part, full[:1, first:]):
                        fail(f"flash_attention_bf16 D={d} Dv={dv} Hq={hq} Hk={hk} "
                             f"causal={causal} window={window}: rows from {first} at B=1 are "
                             "not bitwise those of the B=2 call")
                    n += 1
            del q, k, v, full
    if len(shards) != 2:
        fail(f"flash_attention_bf16: the row gate ran shard sizes {sorted(shards)}, not both "
             "the one-shard plan and the 256-column shards")
    torch.cuda.synchronize()
    say(f"  bf16 attention (tensor cores): {n} checks, edge shapes within BF16_TOL (max |err| "
        f"{worst:.3e}); rows bitwise across B = 1 / 2 and the query offsets "
        f"{list(BF16_ATTN_FIRSTS)} at (D, Dv) {list(BF16_ATTN_WIDTHS)}, three masks, G = 1 "
        f"and 4, shards of {sorted(shards)} columns")
    return {"checks": n, "max_abs_err_edges": worst, "shards": sorted(shards)}


def bf16_own_order(kernel, shape):
    """Whether a bf16 call runs a body with an order of its own (held to its
    plain version within BF16_TOL and to one order for every row by
    bf16_gemm_cases, bf16_attention_cases and bf16_norm_decode_cases), not
    the fp32 entry's arithmetic rounded once: the tensor-core bodies,
    rmsnorm_bf16, and flash_decode_bf16 at D, Dv <= 256 (the wide layout
    stays the fp32 body on bf16 rings)."""
    if kernel == "flash_decode":
        return max(shape[3], shape[4]) <= 256
    return kernel in TENSOR_CORE_BF16 or kernel == "rmsnorm"


def bf16_norm_decode_cases(torch, K):
    """The bf16 bodies of rmsnorm (16-byte bf16 pieces, w once a block) and
    of the narrow flash_decode (mma.sync, shards merged in a cluster): edge
    shapes within BF16_TOL of the plain version (widths off 8 and an
    unaligned x or q: element loads; D 9000: rmsnorm's two-pass path; the
    residual; a length-0 sequence giving 0; one to eight shards; G 8 and 12,
    two head groups), then one order for every row: an rmsnorm row bitwise
    the same in calls of BF16_NORM_ROWS rows, with and without the residual,
    at every served D (BF16_NORM_DS); a flash_decode row of a B = 4 call
    bitwise the B = 1 call at every served narrow width (BF16_DECODE_DS), G 1
    and 4, lengths BF16_DECODE_LENS and S.  Returns the record."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    bf16 = torch.bfloat16

    def rb(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(bf16)

    def unaligned(x):  # the same values at a data pointer 2 bytes off 16
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    n, worst, shards = 0, 0.0, set()
    for rows, d in ((5, 30), (64, 1027), (300, 1152), (17, 9000), (3, 8)):
        x, r, w = rb(rows, d), rb(rows, d), 1.0 + rb(d, scale=0.1)
        for res in (None, r):
            label = f"rmsnorm_bf16 {rows}x{d} residual={res is not None}"
            got = K.rmsnorm(x, w, residual=res)
            worst = max(worst, check_close(torch, label, got.float(),
                                           K.rmsnorm_plain(x, w, residual=res).float(),
                                           **BF16_TOL))
            if d % 8 == 0 and not torch.equal(K.rmsnorm(unaligned(x), w, residual=res), got):
                fail(f"{label}: an unaligned x (element loads) changes the bits")
            n += 1
    for b, s_len, hq, hk, d, dv, lens in (
            (3, 70, 8, 2, 30, 30, (0, 70, 37)), (2, 200, 4, 4, 128, 64, (199, 1)),
            (2, 90, 8, 1, 64, 40, (90, 33)), (2, 300, 12, 1, 112, 112, (300, 17)),
            (4, 2048, 4, 1, 256, 256, DECODE_LENS), (2, 130, 4, 4, 40, 24, (130, 0)),
            (2, 16, 4, 4, 64, 64, (16, 5))):
        q, k, v = rb(b, hq, d), rb(b, s_len, hk, d), rb(b, s_len, hk, dv)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        shards.add(K.decode_plan_bf16(s_len, hq, hk)[1])
        label = f"flash_decode_bf16 B={b} S={s_len} Hq={hq} Hk={hk} D={d} Dv={dv} len={lens}"
        got = K.flash_decode(q, k, v, lengths)
        worst = max(worst, check_close(torch, label, got.float(), K.flash_decode_plain(
            q, k, v, lengths, 1.0 / math.sqrt(d)).float(), **BF16_TOL))
        if any(bool(got[i].float().abs().max() != 0) for i, m in enumerate(lens) if m == 0):
            fail(f"{label}: a length-0 sequence is not 0")
        if d % 8 == 0 and not torch.equal(K.flash_decode(unaligned(q), k, v, lengths), got):
            fail(f"{label}: an unaligned q (element loads) changes the bits")
        n += 1
    if not {1, 8} <= shards or len(shards) < 4:
        fail(f"flash_decode_bf16: the edge shapes ran shard counts {sorted(shards)}")
    for d in BF16_NORM_DS:
        x, r, w = rb(max(BF16_NORM_ROWS), d), rb(max(BF16_NORM_ROWS), d), 1.0 + rb(d, scale=0.1)
        for res in (None, r):
            full = K.rmsnorm(x, w, residual=res)
            for m in BF16_NORM_ROWS:
                part = K.rmsnorm(x[-m:].contiguous(), w,
                                 residual=None if res is None else res[-m:].contiguous())
                if not torch.equal(part, full[-m:]):
                    fail(f"rmsnorm_bf16 D={d} residual={res is not None}: rows at {m} rows are "
                         f"not bitwise those at {max(BF16_NORM_ROWS)}")
                n += 1
        del x, r, w, full
    for d in BF16_DECODE_DS:
        for hq, hk in ((4, 4), (4, 1)):
            for s_len in (2048, 512, 96):
                lens = (BF16_DECODE_LENS + (s_len,))
                b = len(lens)
                q, k, v = rb(b, hq, d), rb(b, s_len, hk, d), rb(b, s_len, hk, d)
                lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                full = K.flash_decode(q, k, v, lengths)
                for i0 in range(0, b, 4):   # B = 4 calls over the lengths, then B = 1
                    four = K.flash_decode(q[i0:i0 + 4].contiguous(), k[i0:i0 + 4].contiguous(),
                                          v[i0:i0 + 4].contiguous(),
                                          lengths[i0:i0 + 4].contiguous())
                    if not torch.equal(four, full[i0:i0 + 4]):
                        fail(f"flash_decode_bf16 D={d} Hq={hq} Hk={hk} S={s_len}: rows of a "
                             f"B=4 call are not bitwise those of the B={b} call")
                    n += 1
                for i in range(b):
                    one = K.flash_decode(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                         v[i:i + 1].contiguous(), lengths[i:i + 1].contiguous())
                    if not torch.equal(one[0], full[i]):
                        fail(f"flash_decode_bf16 D={d} Hq={hq} Hk={hk} S={s_len} "
                             f"len={lens[i]}: the B=1 row is not bitwise the batched one")
                    n += 1
                del q, k, v, full
    torch.cuda.synchronize()
    say(f"  bf16 rmsnorm and narrow decode: {n} checks, edge shapes within BF16_TOL (max |err| "
        f"{worst:.3e}; decode shard counts {sorted(shards)}); rmsnorm rows bitwise across "
        f"{list(BF16_NORM_ROWS)} rows at D {list(BF16_NORM_DS)} with and without the residual; "
        f"decode rows bitwise across B at D {list(BF16_DECODE_DS)}, G 1 and 4, lengths "
        f"{list(BF16_DECODE_LENS)} and S = 2048 / 512 / 96")
    return {"checks": n, "max_abs_err_edges": worst, "decode_shards": sorted(shards)}


def shard_kernel_cases(torch, K, rn, tol):
    """The attention kernel over several shards of attention_shard_cols(S)
    and batched_gemm across its variants: the plain versions within
    ``tol``, and rows bitwise at B = 1 and B = 4, in one T = 64 chunk or two
    (17 then 47) at the same positions, through fp32 pages, with fewer
    query rows, and (batched_gemm) at every M and against gemm per expert."""
    n = 0
    s_len = 1024
    for hq, hk, d in ((8, 8, 96), (4, 1, 256)):
        q, k, v = rn(4, 64, hq, d), rn(4, s_len, hk, d), rn(4, s_len, hk, d)
        sh = K.attention_shard_cols(s_len)
        start = torch.tensor([sh - 18, 2 * sh - 1, 0, s_len - 64], dtype=torch.int32,
                             device="cuda")
        full = K.flash_chunk_attention(q, k, v, start)
        check_close(torch, f"flash_chunk_attention S={s_len} hq={hq} hk={hk} d={d}", full,
                    K.flash_chunk_attention_plain(q, k, v, start, 1.0 / math.sqrt(d)), **tol)
        for i in range(4):
            one = K.flash_chunk_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                          v[i:i + 1].contiguous(), start[i:i + 1].contiguous())
            if not torch.equal(one, full[i:i + 1]):
                fail(f"flash_chunk_attention d={d}: sequence {i} at B=1 is not bitwise B=4's")
        split = torch.cat([K.flash_chunk_attention(q[:, :17].contiguous(), k, v, start),
                           K.flash_chunk_attention(q[:, 17:].contiguous(), k, v, start + 17)],
                          dim=1)
        if not torch.equal(split, full):
            fail(f"flash_chunk_attention d={d}: chunks of 17 + 47 are not bitwise one of 64")
        page = 16
        tables = torch.arange(4 * s_len // page, dtype=torch.int32,
                              device="cuda").reshape(4, -1)
        pk, pv = (x.reshape(-1, page, hk, d) for x in (k, v))
        if not torch.equal(K.flash_paged_chunk_attention(q, pk, pv, tables, start), full):
            fail(f"flash_paged_chunk_attention d={d}: not bitwise equal to the dense kernel")
        n += 4
    for d, dv in ((96, 96), (128, 128), (256, 256), (128, 64)):
        q, k, v = rn(2, 700, 4, d), rn(2, 700, 1, d), rn(2, 700, 1, dv)
        for causal, window in ((True, None), (True, 512), (False, 300)):
            full = K.flash_attention(q, k, v, causal=causal, window=window)
            check_close(torch, f"flash_attention L=700 d={d} dv={dv} causal={causal} "
                        f"window={window}", full,
                        K.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                scale=1.0 / math.sqrt(d)), **tol)
            for first in (1, 255, 257, 511):
                part = K.flash_attention(q[:1, first:].contiguous(), k[:1].contiguous(),
                                         v[:1].contiguous(), causal=causal, window=window)
                if not torch.equal(part, full[:1, first:]):
                    fail(f"flash_attention d={d} causal={causal} window={window}: rows from "
                         f"{first} at B=1 are not bitwise those of the whole batch")
            n += 2
    # widths off the float4 groups (4-byte copies; int8 loads element by
    # element) over two shards
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    q, k, v = rn(2, 300, 4, 6), rn(2, 300, 2, 6), rn(2, 300, 2, 10)
    check_close(torch, "flash_attention L=300 d=6 dv=10", K.flash_attention(q, k, v),
                K.flash_attention_plain(q, k, v, causal=True, window=None,
                                        scale=1.0 / math.sqrt(6)), **tol)
    start = torch.tensor([250, 0], dtype=torch.int32, device="cuda")
    qc = rn(2, 16, 4, 6)
    for quant in (False, True):
        pk, pv, tables, sc = paged_layout(torch, g, b=2, n=43, page=16, mp=20, hk=2, d=6,
                                          dv=10, lengths=[266, 16], quant=quant)
        got = K.flash_paged_chunk_attention(qc, pk, pv, tables, start, **sc)
        check_close(torch, f"flash_paged_chunk_attention d=6 dv=10 quant={quant}", got,
                    K.flash_paged_chunk_attention_plain(qc, pk, pv, tables, start,
                                                        1.0 / math.sqrt(6), sc.get("k_scales"),
                                                        sc.get("v_scales")), **tol)
        if not quant and not torch.equal(got, K.flash_chunk_attention(
                qc, K.gather_pages(pk, tables), K.gather_pages(pv, tables), start)):
            fail("flash_paged_chunk_attention d=6 dv=10: not bitwise equal to the dense kernel")
        n += 2
    for kk, nn in ((2048, 1408), (1408, 2048)):
        x, w = rn(64, 128, kk), rn(64, kk, nn) / math.sqrt(kk)
        full = K.batched_gemm(x, w)
        check_close(torch, f"batched_gemm E=64 M=128 {kk}->{nn}", full,
                    K.batched_gemm_plain(x, w), atol=1e-4, rtol=1e-4)
        for m in (1, 8, 16, 17, 32, 80):
            if not torch.equal(K.batched_gemm(x[:, :m].contiguous(), w), full[:, :m]):
                fail(f"batched_gemm {kk}->{nn}: rows at M={m} are not bitwise those at M=128")
        for e in (0, 63):
            if not torch.equal(full[e], K.gemm(x[e].contiguous(), w[e].contiguous())):
                fail(f"batched_gemm {kk}->{nn}: expert {e} is not bitwise gemm's product")
        n += 8
    torch.cuda.synchronize()
    return n


def combine_check(torch, K, tag, parts, tol):
    """The combine kernel against combine_partials_ref on partials; a row
    whose shards are all empty must give 0.  Returns the max |err|."""
    got = K.combine_partials(*parts)
    err = check_close(torch, f"combine_partials {tag}", got, K.combine_partials_ref(*parts),
                      **tol)
    empty = (parts[2] == 0).all(dim=0)
    if bool(empty.any()) and float(got[empty].abs().max()) != 0.0:
        fail(f"combine_partials {tag}: an all-empty row is not 0")
    return err


def split_kernel_cases(torch, K, rn, tol):
    """flash_decode_partial against its plain version: shards of 96 rows (a
    ragged second tile), lengths 0, 1, on and across the shard edges and
    the whole cache, so some shards are wholly empty; GQA groups 1-8, D
    64-256 with Dv != D, n_splits 2/4/8.  An empty shard must give acc 0,
    m -1e30 and l 0; the cuda_split backend must agree with flash_decode."""
    n = 0
    for n_splits in (2, 4, 8):
        part = 96
        s_len = part * n_splits
        lens = [0, 1, part - 1, part, part + 1, s_len // 2 + 5, s_len - 1, s_len]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        shard0 = part * torch.arange(n_splits, device="cuda")[:, None]
        empty = (lengths[None, :] - shard0) <= 0
        for hq, hk in ((1, 1), (2, 1), (4, 2), (8, 1)):
            for d, dv in ((64, 64), (96, 96), (128, 64), (256, 256), (96, 128)):
                q, k, v = rn(len(lens), hq, d), rn(len(lens), s_len, hk, d), \
                    rn(len(lens), s_len, hk, dv)
                tag = f"flash_decode_partial n_splits={n_splits} hq={hq} hk={hk} d={d} dv={dv}"
                got = K.flash_decode_partial(q, k, v, lengths, n_splits=n_splits)
                want = K.flash_decode_partial_plain(q, k, v, lengths, 1.0 / math.sqrt(d),
                                                    n_splits)
                for part_name, a, b in zip(("acc", "m", "l"), got, want):
                    check_close(torch, f"{tag} {part_name}", a, b, **tol)
                acc, m, l = got
                if not (bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
                        and float(acc[empty].abs().max()) == 0.0):
                    fail(f"{tag}: an empty shard is not (acc 0, m -1e30, l 0)")
                check_close(torch, f"{tag} cuda_split",
                            K.decode_attention(q, k, v, lengths, backend="cuda_split",
                                               n_splits=n_splits),
                            K.flash_decode(q, k, v, lengths), **tol)
                combine_check(torch, K, tag, got, tol)
                n += 2
    torch.cuda.synchronize()
    return n


def paged_layout(torch, g, *, b, n, page, mp, hk, d, dv, lengths, quant):
    """A scrambled page pool: the live pages of every sequence are distinct
    blocks in random order, table entries past them are junk (any id, even
    out of range: the kernels clip and never read them), and int8 pools
    hold one all-zero page with scale 0.  Returns (pages_k, pages_v,
    tables, scales kwargs)."""
    perm = torch.randperm(n, generator=g, device=g.device)
    tables = torch.randint(-2, n + 2, (b, mp), generator=g, device=g.device)
    used = 0
    for bi, length in enumerate(lengths):
        live = -(-min(length, mp * page) // page)
        tables[bi, :live] = perm[used:used + live]
        used += live
    tables = tables.to(torch.int32)
    if not quant:
        return (torch.randn(n, page, hk, d, generator=g, device=g.device),
                torch.randn(n, page, hk, dv, generator=g, device=g.device), tables, {})
    pk = torch.randint(-127, 128, (n, page, hk, d), generator=g, device=g.device,
                       dtype=torch.int8)
    pv = torch.randint(-127, 128, (n, page, hk, dv), generator=g, device=g.device,
                       dtype=torch.int8)
    ks = torch.rand(n, hk, generator=g, device=g.device) * 0.05
    vs = torch.rand(n, hk, generator=g, device=g.device) * 0.05
    zero = int(perm[0])
    pk[zero], pv[zero], ks[zero], vs[zero] = 0, 0, 0.0, 0.0
    return pk, pv, tables, dict(k_scales=ks, v_scales=vs)


def paged_kernel_cases(torch, K, rn, g, tol):
    """The paged kernels, both modes: GQA groups, pages of 1 to 128 rows,
    lengths 0 and MP*P, start + T == MP*P, scale None and 0.0, scrambled
    tables with junk entries, an all-zero int8 page.  fp32 pages must give
    the dense kernel's output on the gathered cache bit for bit."""
    n = 0
    for quant in (False, True):
        mode = "int8" if quant else "fp32"
        for hq, hk in ((1, 1), (2, 1), (4, 2), (4, 4)):
            for page, mp in ((1, 70), (5, 14), (16, 5), (64, 2), (128, 1)):
                cap = page * mp
                for scale in (None, 0.0):
                    lens = [0, cap, 37, 1]
                    pk, pv, tables, sc = paged_layout(torch, g, b=4, n=4 * mp + 3, page=page,
                                                      mp=mp, hk=hk, d=96, dv=64, lengths=lens,
                                                      quant=quant)
                    q = rn(4, hq, 96)
                    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                    s = (1.0 / math.sqrt(96)) if scale is None else scale
                    tag = f"{mode} hq={hq} hk={hk} P={page} scale={scale}"
                    got = K.flash_paged_decode(q, pk, pv, tables, lengths, scale=scale, **sc)
                    check_close(torch, f"flash_paged_decode {tag}", got,
                                K.flash_paged_decode_plain(q, pk, pv, tables, lengths, s,
                                                           sc.get("k_scales"),
                                                           sc.get("v_scales")), **tol)
                    if float(got[0].abs().max()) != 0.0:
                        fail(f"flash_paged_decode {tag}: a length-0 row is not 0")
                    if not quant and not torch.equal(got, K.flash_decode(
                            q, K.gather_pages(pk, tables), K.gather_pages(pv, tables),
                            lengths, scale=scale)):
                        fail(f"flash_paged_decode {tag}: not bitwise equal to flash_decode")
                    t = 16
                    pk, pv, tables, sc = paged_layout(torch, g, b=4, n=4 * mp + 3, page=page,
                                                      mp=mp, hk=hk, d=64, dv=64,
                                                      lengths=[cap] * 4, quant=quant)
                    q = rn(4, t, hq, 64)
                    start = torch.tensor([0, cap - t, 5, cap // 2], dtype=torch.int32,
                                         device="cuda")
                    s = 0.125 if scale is None else scale
                    got = K.flash_paged_chunk_attention(q, pk, pv, tables, start, scale=scale,
                                                        **sc)
                    check_close(torch, f"flash_paged_chunk_attention {tag}", got,
                                K.flash_paged_chunk_attention_plain(
                                    q, pk, pv, tables, start, s, sc.get("k_scales"),
                                    sc.get("v_scales")), **tol)
                    if not quant and not torch.equal(got, K.flash_chunk_attention(
                            q, K.gather_pages(pk, tables), K.gather_pages(pv, tables), start,
                            scale=scale)):
                        fail(f"flash_paged_chunk_attention {tag}: not bitwise equal to "
                             "flash_chunk_attention")
                    n += 2
    torch.cuda.synchronize()
    return n


def full_width_shapes(cfg, n_slots, chunk, cache_cap):
    """The shapes the serving path gives each kernel (first one per kernel
    is the headline reported in the JSON line)."""
    dm, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    gemm = []
    for m, tag in ((n_slots, "engine decode"), (n_slots * chunk, "engine prefill"),
                   (1, "reference decode"), (chunk, "reference prefill")):
        for kk, nn, what in ((dm, ff, "gate/up"), (dm, dm, "q/k/v/o"),
                             (ff, dm, "down"), (dm, v, "lm_head")):
            gemm.append((f"{tag} {what}", m, nn, kk))
    rms = [("engine decode", n_slots), ("engine prefill", n_slots * chunk),
           ("reference decode", 1), ("reference prefill", chunk)]
    return gemm, rms


def kernels_phase(torch, K, cfg, scfgs, n_slots, chunk, cache_cap, page, pools, limit_line):
    timer = Timer(torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    F = torch.nn.functional
    results, by_tag, shapes = {}, {}, {}
    full_tol = dict(atol=1e-4, rtol=1e-4)

    def record(name, tag, shape_tag, err, ms, plain_ms, lib_ms, flops, nbytes,
               mode=None, dense_ms=None, peak=PEAK_FP32_FLOPS, fp32_ms=None):
        by_tag[(name, tag)] = ms
        b_ms, b_by = bound(flops, nbytes, peak)
        other = (f"dense kernel {dense_ms:.4g} ms" if dense_ms is not None
                 else "no library call" if lib_ms is None else f"library {lib_ms:.4g} ms")
        if fp32_ms is not None:
            other += f"  fp32 kernel {fp32_ms:.4g} ms"
        say(f"  {name:27s} {shape_tag:44s} err {err:.2e}  kernel {ms:.4g} ms  "
            f"plain {plain_ms:.4g} ms  {other}  bound {b_ms:.4g} ms ({b_by})  "
            f"[{limit_line}]")
        entry = dict(shape=shape_tag, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if dense_ms is not None:
            entry["dense_kernel_ms"] = dense_ms
        if fp32_ms is not None:
            entry["fp32_kernel_ms"] = fp32_ms
        shapes.setdefault(name, []).append(entry)
        if name not in results:
            results[name] = entry
        elif mode is not None and mode not in results[name]:
            results[name][mode] = entry
        else:
            target = results[name] if mode is None else results[name][mode]
            target["max_abs_err"] = max(target["max_abs_err"], err)

    gemm_shapes, rms_shapes = full_width_shapes(cfg, n_slots, chunk, cache_cap)
    for tag, m, nn, kk in gemm_shapes:
        x, w = rn(m, kk), rn(kk, nn, scale=1.0 / math.sqrt(kk))
        got = K.gemm(x, w)
        err = check_close(torch, f"gemm {tag}", got, K.gemm_plain(x, w), **full_tol)
        ms = timer.ms(lambda: K.gemm(x, w))
        plain = timer.ms(lambda: K.gemm_plain(x, w))
        lib = timer.ms(lambda: torch.matmul(x, w))
        variant = K.gemm_variant(m) + (f" {K.gemm_tile(m, nn)}" if m > K.SKINNY_MAX_M else "")
        record("gemm", tag, f"{tag} M={m} N={nn} K={kk} [{variant}]", err, ms, plain, lib,
               2.0 * m * nn * kk, 4.0 * (m * kk + kk * nn + m * nn))
        del x, w, got

    d = cfg.d_model
    for tag, rows in rms_shapes:
        x, w = rn(rows, d), 1.0 + 0.1 * rn(d)
        err = check_close(torch, f"rmsnorm {tag}", K.rmsnorm(x, w, eps=cfg.eps),
                          K.rmsnorm_plain(x, w, eps=cfg.eps), **full_tol)
        ms = timer.ms(lambda: K.rmsnorm(x, w, eps=cfg.eps))
        plain = timer.ms(lambda: K.rmsnorm_plain(x, w, eps=cfg.eps))
        lib = timer.ms(lambda: F.rms_norm(x, (d,), w, cfg.eps))
        record("rmsnorm", tag, f"{tag} rows={rows} D={d}", err, ms, plain, lib,
               3.0 * rows * d, 4.0 * (2 * rows * d + d))
    # the floor under every short row: one empty kernel through the same
    # ctypes launch path (stream lookup, call, error check), same timer
    empty_ms = timer.ms(lambda: K.empty_launch(x))
    say(f"  {'empty launch':27s} {'one empty kernel through _cuda':44s} kernel {empty_ms:.4g} ms"
        f"  (the floor of every wrapper's call)  [{limit_line}]")

    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for tag, b, lens in (("engine decode", n_slots, [731, 400, 129, 0]),
                         ("reference decode", 1, [731])):
        q = rn(b, hq, dh)
        k, v = rn(b, cache_cap, hk, dh), rn(b, cache_cap, hk, dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(dh)
        err = check_close(torch, f"flash_decode {tag}", K.flash_decode(q, k, v, lengths),
                          K.flash_decode_plain(q, k, v, lengths, sc), **full_tol)
        ms = timer.ms(lambda: K.flash_decode(q, k, v, lengths))
        plain = timer.ms(lambda: K.flash_decode_plain(q, k, v, lengths, sc))
        pos = torch.arange(cache_cap, device="cuda")
        mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
        live = sum(min(max(x, 0), cache_cap) for x in lens)
        record("flash_decode", tag, f"{tag} B={b} S={cache_cap} len={lens}", err, ms, plain,
               lib, 2.0 * live * hq * 2 * dh,
               4.0 * (live * hk * 2 * dh + 2 * b * hq * dh + b))
        del q, k, v

    for tag, b, starts in (("engine prefill", n_slots, [640, 320, 64, 0]),
                           ("reference prefill", 1, [640])):
        t = chunk
        q = rn(b, t, hq, dh)
        k, v = rn(b, cache_cap, hk, dh), rn(b, cache_cap, hk, dh)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(dh)
        err = check_close(torch, f"flash_chunk_attention {tag}",
                          K.flash_chunk_attention(q, k, v, start),
                          K.flash_chunk_attention_plain(q, k, v, start, sc), **full_tol)
        ms = timer.ms(lambda: K.flash_chunk_attention(q, k, v, start))
        plain = timer.ms(lambda: K.flash_chunk_attention_plain(q, k, v, start, sc))
        qpos = start[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (torch.arange(cache_cap, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
        cols = sum(min(cache_cap, s0 + i + 1) for s0 in starts for i in range(t))
        rows_read = sum(min(cache_cap, s0 + t) for s0 in starts)
        record("flash_chunk_attention", tag, f"{tag} B={b} T={t} S={cache_cap} start={starts}",
               err, ms, plain, lib, 2.0 * cols * hq * 2 * dh,
               4.0 * (rows_read * hk * 2 * dh + 2 * b * t * hq * dh + b))
        del q, k, v

    extra = {"empty_launch_ms": empty_ms, "shapes": shapes,
             "bf16_gemm": bf16_gemm_cases(torch, K, limit_line),
             "bf16_attention": bf16_attention_cases(torch, K),
             "bf16_norm_decode": bf16_norm_decode_cases(torch, K),
             "combine": combine_kernels(torch, K, rn, timer, record, full_tol),
             "split": split_kernels(torch, K, rn, timer, record, full_tol, limit_line),
             "split_bf16": split_bf16_kernels(torch, K, rn, timer, record, full_tol,
                                              limit_line),
             "conv2d": conv_kernels(torch, rn, timer, full_tol, limit_line)}
    stack_est = {c.name: stack_kernels(torch, K, c, rn, timer, record, full_tol, limit_line)
                 for c in scfgs}

    # the paged kernels at the engine's shapes: pools of the serving phases
    # (fp32: 256 blocks, int8: the block count of equal bytes), page 16
    mp = cache_cap // page
    t = chunk
    for mode, n_blocks in pools.items():
        quant = mode == "int8"
        item = 1 if quant else 4
        lens = [731, 400, 129, 0]
        pk, pv, tables, sc = paged_layout(torch, g, b=n_slots, n=n_blocks, page=page, mp=mp,
                                          hk=hk, d=dh, dv=dh, lengths=lens, quant=quant)
        q = rn(n_slots, hq, dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc_ = 1.0 / math.sqrt(dh)
        k, v = K.gather_pages(pk, tables, sc.get("k_scales")), \
            K.gather_pages(pv, tables, sc.get("v_scales"))
        got = K.flash_paged_decode(q, pk, pv, tables, lengths, **sc)
        err = check_close(torch, f"flash_paged_decode {mode}", got,
                          K.flash_paged_decode_plain(q, pk, pv, tables, lengths, sc_,
                                                     sc.get("k_scales"), sc.get("v_scales")),
                          **full_tol)
        if not quant and not torch.equal(got, K.flash_decode(q, k, v, lengths)):
            fail("flash_paged_decode fp32: not bitwise equal to flash_decode at full width")
        ms = timer.ms(lambda: K.flash_paged_decode(q, pk, pv, tables, lengths, **sc))
        plain = timer.ms(lambda: K.flash_paged_decode_plain(
            q, pk, pv, tables, lengths, sc_, sc.get("k_scales"), sc.get("v_scales")))
        dense = timer.ms(lambda: K.flash_decode(q, k, v, lengths))
        live = sum(lens)
        pages_live = sum(-(-x // page) for x in lens)
        record("flash_paged_decode", f"{mode} engine decode",
               f"{mode} B={n_slots} P={page} MP={mp} N={n_blocks} len={lens}", err, ms, plain,
               None, 2.0 * live * hq * 2 * dh,
               item * live * hk * 2 * dh + (8.0 * pages_live * hk if quant else 0.0)
               + 4.0 * (pages_live + 2 * n_slots * hq * dh + n_slots),
               mode=mode, dense_ms=dense)
        starts = [640, 320, 64, 0]
        ends = [s0 + t for s0 in starts]
        pk, pv, tables, sc = paged_layout(torch, g, b=n_slots, n=n_blocks, page=page, mp=mp,
                                          hk=hk, d=dh, dv=dh, lengths=ends, quant=quant)
        q = rn(n_slots, t, hq, dh)
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        k, v = K.gather_pages(pk, tables, sc.get("k_scales")), \
            K.gather_pages(pv, tables, sc.get("v_scales"))
        got = K.flash_paged_chunk_attention(q, pk, pv, tables, start, **sc)
        err = check_close(torch, f"flash_paged_chunk_attention {mode}", got,
                          K.flash_paged_chunk_attention_plain(
                              q, pk, pv, tables, start, sc_, sc.get("k_scales"),
                              sc.get("v_scales")), **full_tol)
        if not quant and not torch.equal(got, K.flash_chunk_attention(q, k, v, start)):
            fail("flash_paged_chunk_attention fp32: not bitwise equal to "
                 "flash_chunk_attention at full width")
        ms = timer.ms(lambda: K.flash_paged_chunk_attention(q, pk, pv, tables, start, **sc))
        plain = timer.ms(lambda: K.flash_paged_chunk_attention_plain(
            q, pk, pv, tables, start, sc_, sc.get("k_scales"), sc.get("v_scales")))
        dense = timer.ms(lambda: K.flash_chunk_attention(q, k, v, start))
        cols = sum(min(cache_cap, s0 + i + 1) for s0 in starts for i in range(t))
        rows_read = sum(min(cache_cap, e) for e in ends)
        pages_live = sum(-(-e // page) for e in ends)
        record("flash_paged_chunk_attention", f"{mode} engine prefill",
               f"{mode} B={n_slots} T={t} P={page} N={n_blocks} start={starts}", err, ms, plain,
               None, 2.0 * cols * hq * 2 * dh,
               item * rows_read * hk * 2 * dh + (8.0 * pages_live * hk if quant else 0.0)
               + 4.0 * (pages_live + 2 * n_slots * t * hq * dh + n_slots),
               mode=mode, dense_ms=dense)
        del pk, pv, k, v, q

    extra["verify"] = verify_kernels(torch, K, g, rn, timer, record, full_tol, cfg,
                                     n_slots=n_slots, cache_cap=cache_cap, page=page,
                                     pools=pools, limit_line=limit_line)
    extra["dense_q"] = dense_q_times(torch, K, rn, timer, cfg, n_slots, chunk, limit_line)

    # the cache writes of the three serving paths (plain PyTorch ops, not
    # kernels): each copies its whole cache or pool (functional, as in JAX);
    # the int8 write also requantizes the whole pool
    from repro_torch.core.registry import get_impl
    ops_ms = {}
    for phase, tt in (("decode", 1), ("prefill", t)):
        new = rn(n_slots, tt, hk, dh)
        begin = torch.tensor([731, 400, 129, 0] if tt == 1 else [640, 320, 64, 0],
                             dtype=torch.int32, device="cuda")
        n_new = torch.tensor([tt, tt, tt, 0], dtype=torch.int32, device="cuda")
        cache = torch.zeros(n_slots, cache_cap, hk, dh, device="cuda")
        fn = get_impl("cache_update", "ref")
        ops_ms[("dense", phase)] = timer.ms(lambda: fn([cache, new, begin, n_new], {}))
        del cache
        for mode, n_blocks in pools.items():
            tables = torch.arange(n_slots * mp, dtype=torch.int32,
                                  device="cuda").reshape(n_slots, mp) % n_blocks
            if mode == "int8":
                pool = torch.zeros(n_blocks, page, hk, dh, dtype=torch.int8, device="cuda")
                scales = torch.zeros(n_blocks, hk, device="cuda")
                fn = get_impl("paged_cache_update_q", "ref")
                args = [pool, scales, new, tables, begin, n_new]
            else:
                pool = torch.zeros(n_blocks, page, hk, dh, device="cuda")
                fn = get_impl("paged_cache_update", "ref")
                args = [pool, new, tables, begin, n_new]
            ops_ms[(f"paged {mode}", phase)] = timer.ms(lambda: fn(args, {}))
            del pool, args
    for (path, phase), ms in ops_ms.items():
        say(f"  cache write op ({path}, {phase}) {ms:.4g} ms per call, "
            f"{2 * cfg.n_layers} calls per tick  [{limit_line}]")
    del timer
    torch.cuda.empty_cache()
    return results, by_tag, ops_ms, stack_est, extra


SPEC_K = 3                       # phase 14's speculation width is SPEC_K + 1
VERIFY_STARTS = [731, 400, 129, 0]


def verify_kernels(torch, K, g, rn, timer, record, full_tol, cfg, *, n_slots, cache_cap, page,
                   pools, limit_line):
    """Rows 2 and 3 at the speculative verify shape of phase 14 (phi3-mini,
    B = 4, T = SPEC_K + 1 = 4, S = 1024, starts 731/400/129/0): the dense
    chunk kernel (``verify_attention``), the paged chunk kernel over fp32 and
    int8 pages (``paged_verify_attention``), and ``paged_verify_attention_q``'s
    cuda backend (gather, dequantize and patch in PyTorch, then the dense
    chunk kernel; two-source, so its bytes count the committed prefix from
    int8 pages and the T new rows in fp32).  Each held against its plain
    version; SDPA timed on the dense (gathered) cache.  Returns the rows."""
    import numpy as np
    from repro_torch.core.registry import get_impl
    F = torch.nn.functional
    hq, hk, dh, t = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, SPEC_K + 1
    mp, b, sc_ = cache_cap // page, n_slots, 1.0 / math.sqrt(cfg.d_head)
    starts = VERIFY_STARTS
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ends = [s0 + t for s0 in starts]
    cols = sum(min(cache_cap, s0 + i + 1) for s0 in starts for i in range(t))
    rows_read = sum(min(cache_cap, e) for e in ends)
    flops = 2.0 * cols * hq * 2 * dh
    qpos = start[:, None] + torch.arange(t, device="cuda")[None, :]
    mask = (torch.arange(cache_cap, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]

    def sdpa(q, k, v):
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        return timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))

    out = []
    q = rn(b, t, hq, dh)
    k, v = rn(b, cache_cap, hk, dh), rn(b, cache_cap, hk, dh)
    fn = get_impl("verify_attention", "cuda")
    got = fn([q, k, v, start], {})[0]
    err = check_close(torch, "verify_attention", got,
                      K.flash_chunk_attention_plain(q, k, v, start, sc_), **full_tol)
    ms = timer.ms(lambda: fn([q, k, v, start], {}))
    plain = timer.ms(lambda: K.flash_chunk_attention_plain(q, k, v, start, sc_))
    lib = sdpa(q, k, v)
    record("flash_chunk_attention", "verify", f"verify B={b} T={t} S={cache_cap} "
           f"start={starts}", err, ms, plain, lib, flops,
           4.0 * (rows_read * hk * 2 * dh + 2 * b * t * hq * dh + b), mode="verify")
    out.append(dict(op="verify_attention", kernel="flash_chunk_attention", ms=ms,
                    plain_ms=plain, sdpa_ms=lib, max_abs_err=err))
    del k, v
    for mode, n_blocks in pools.items():
        quant = mode == "int8"
        pk, pv, tables, scs = paged_layout(torch, g, b=b, n=n_blocks, page=page, mp=mp, hk=hk,
                                           d=dh, dv=dh, lengths=ends, quant=quant)
        kd = K.gather_pages(pk, tables, scs.get("k_scales"))
        vd = K.gather_pages(pv, tables, scs.get("v_scales"))
        pages_live = sum(-(-e // page) for e in ends)
        if not quant:
            fn = get_impl("paged_verify_attention", "cuda")
            args = [q, pk, pv, tables, start]
            got = fn(args, {})[0]
            if not torch.equal(got, K.flash_chunk_attention(q, kd, vd, start)):
                fail("paged_verify_attention fp32: not bitwise equal to the dense chunk "
                     "kernel at the verify shape")
            want = K.flash_paged_chunk_attention_plain(q, pk, pv, tables, start, sc_)
            plain_fn = (lambda: K.flash_paged_chunk_attention_plain(q, pk, pv, tables,
                                                                    start, sc_))
            name, kern, nbytes = "paged_verify_attention", "flash_paged_chunk_attention", \
                4.0 * (rows_read * hk * 2 * dh + pages_live + 2 * b * t * hq * dh + b)
        else:
            # the int8 verify op is two-source: the call's own rows are fp32
            kn, vn = rn(b, t, hk, dh), rn(b, t, hk, dh)
            fn = get_impl("paged_verify_attention_q", "cuda")
            ref = get_impl("paged_verify_attention_q", "ref")
            args = [q, pk, scs["k_scales"], pv, scs["v_scales"], tables, start, kn, vn]
            got = fn(args, {})[0]
            want = ref(args, {})[0]
            plain_fn = (lambda: ref(args, {}))
            committed = sum(min(cache_cap, s0) for s0 in starts)
            name, kern = "paged_verify_attention_q", "flash_chunk_attention"
            nbytes = (committed * hk * 2 * dh + 8.0 * pages_live * hk
                      + 4.0 * (2 * b * t * hk * dh + pages_live + 2 * b * t * hq * dh + b))
        err = check_close(torch, f"{name} {mode}", got, want, **full_tol)
        ms = timer.ms(lambda: fn(args, {}))
        plain = timer.ms(plain_fn)
        dense = timer.ms(lambda: K.flash_chunk_attention(q, kd, vd, start))
        lib = sdpa(q, kd, vd)
        say(f"    SDPA on the gathered {mode} cache: {lib:.4g} ms  [{limit_line}]")
        tag = "verify int8 two-source" if quant else "verify fp32"
        record(kern, tag, f"{name} {mode} B={b} T={t} P={page} N={n_blocks} start={starts}",
               err, ms, plain, None, flops, nbytes, mode=tag, dense_ms=dense)
        out.append(dict(op=name, kernel=kern, pages=mode, ms=ms, plain_ms=plain, sdpa_ms=lib,
                        dense_kernel_ms=dense, max_abs_err=err))
        del pk, pv, kd, vd, args
    return out


def dense_q_times(torch, K, rn, timer, cfg, n_slots, chunk, limit_line):
    """``dense_q`` at phi3-mini's engine decode (M = 4) and prefill (M =
    256) shapes: ``ref`` (int8 values accumulated in float64, the
    batch-invariant oracle phase 13 serves on), ``torch`` (dequantize, then
    one fp32 ``matmul``) and the fp32 ``gemm.cu`` on fp32 weights of the same
    shape.  Numbers for the record: dense_q has no kernel."""
    from repro_torch.core.quant import quantize_weight
    from repro_torch.core.registry import get_impl
    dm, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    rows = []
    for m, tag in ((n_slots, "engine decode"), (n_slots * chunk, "engine prefill")):
        for kk, nn, what in ((dm, ff, "gate/up"), (dm, dm, "q/k/v/o"), (ff, dm, "down"),
                             (dm, v, "lm_head")):
            x, w = rn(m, kk), rn(kk, nn, scale=1.0 / math.sqrt(kk))
            w_q, w_s = quantize_weight(w, 1)
            attrs = {"w_scale": w_s, "zero_point": 0,
                     "x_scale": float(x.abs().max()) / 127}
            ref, lib = get_impl("dense_q", "ref"), get_impl("dense_q", "torch")
            err = max_err(torch, ref([x, w_q], attrs)[0], lib([x, w_q], attrs)[0])
            row = dict(shape=f"{tag} {what} M={m} N={nn} K={kk}",
                       ref_ms=timer.ms(lambda: ref([x, w_q], attrs)),
                       torch_ms=timer.ms(lambda: lib([x, w_q], attrs)),
                       gemm_fp32_ms=timer.ms(lambda: K.gemm(x, w)),
                       int8_bound_ms=bound(2.0 * m * nn * kk,
                                           kk * nn + 4.0 * (m * kk + m * nn + nn))[0],
                       ref_vs_torch_max_abs=err)
            say(f"  dense_q {row['shape']:42s} ref (float64) {row['ref_ms']:.4g} ms  torch "
                f"{row['torch_ms']:.4g} ms  fp32 gemm.cu {row['gemm_fp32_ms']:.4g} ms  "
                f"|ref - torch| {err:.2e}  [{limit_line}]")
            rows.append(row)
            del x, w, w_q
    return rows


def device_times(torch, K, limit_line):
    """Device time (torch.profiler) of the empty launch, of rmsnorm beside
    F.rms_norm at the row counts and widths the paths run, of ssd_scan's
    three kernels at mamba2-370m's 1024-token prefill (with D; fp32 and
    bf16), and of the
    fp32 and bf16 entries of rmsnorm, the gemm head and flash_decode at
    gemma3-1b's batch-4 decode step, of the bf16 rmsnorm at the prefill
    rows beside bf16 F.rms_norm, of the narrow bf16 flash_decode at the
    served families' decode shapes beside bf16 SDPA (and, at gemma3-1b's
    rolling and zamba2's shapes, with every length 0: its fixed cost), and
    of the bf16 GEMM's short rows (gemma3-1b's decode q projection, MLA's
    absorbed products) beside matmul / bmm (their event times hold the
    launch path).  Run after the serving phases: the profiler's hooks stay
    in the process and slow every later launch on the host."""
    F = torch.nn.functional
    timer = Timer(torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(2)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    one = rn(1)
    out = {"empty launch": device_ms(torch, timer, lambda: K.empty_launch(one))}
    for rows, d in ((4, 3072), (256, 3072), (4, 1152), (1024, 1152), (1024, 1024),
                    (1024, 2048), (4, 7168)):
        x, w = rn(rows, d), 1.0 + 0.1 * rn(d)
        out[f"rmsnorm {rows}x{d}"] = device_ms(torch, timer, lambda: K.rmsnorm(x, w))
        out[f"F.rms_norm {rows}x{d}"] = device_ms(
            torch, timer, lambda: F.rms_norm(x, (d,), w, 1e-6))
    sl, h, p, n = LAYERSTACK_PREFILL, 32, 64, 128
    args = (rn(1, sl, h, p), F.softplus(rn(1, sl, h) - 3.0),
            -torch.linspace(1.0, 16.0, h, device="cuda"), 0.3 * rn(1, sl, 1, n),
            0.3 * rn(1, sl, 1, n), rn(h))
    out[f"ssd_scan mamba2 S={sl} with D"] = device_ms(torch, timer, lambda: K.ssd_scan(*args))
    args = [a.to(torch.bfloat16) if i in (0, 3, 4) else a for i, a in enumerate(args)]
    out[f"ssd_scan bf16 mamba2 S={sl} with D"] = device_ms(torch, timer,
                                                          lambda: K.ssd_scan(*args))
    del args
    lengths = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x, w = rn(4, 1152).to(dt), (rn(1152, 262144) * 1152 ** -0.5).to(dt)
        out[f"gemm {tag} gemma3 head 4x1152->262144"] = device_ms(
            torch, timer, lambda: K.gemm(x, w))
        nw = (1.0 + 0.1 * rn(1152)).to(dt)
        out[f"rmsnorm {tag} gemma3 step 4x1152"] = device_ms(
            torch, timer, lambda: K.rmsnorm(x, nw))
        q, k, v = rn(4, 4, 256).to(dt), rn(4, 2048, 1, 256).to(dt), rn(4, 2048, 1, 256).to(dt)
        out[f"flash_decode {tag} gemma3 global S=2048"] = device_ms(
            torch, timer, lambda: K.flash_decode(q, k, v, lengths))
        del x, w, q, k, v
    # the bf16 rmsnorm's prefill rows and the narrow bf16 decode's rows of
    # the served families, beside bf16 F.rms_norm and SDPA on the same inputs
    bf16 = torch.bfloat16
    for rows, d in ((4096, 1024), (1024, 1024), (1024, 2048), (1024, 7168)):
        x, nw = rn(rows, d).to(bf16), (1.0 + 0.1 * rn(d)).to(bf16)
        out[f"rmsnorm bf16 prefill {rows}x{d}"] = {
            **device_ms(torch, timer, lambda: K.rmsnorm(x, nw)),
            **{f"F.rms_norm {k}": v for k, v in device_ms(
                torch, timer, lambda: F.rms_norm(x, (d,), nw, 1e-6)).items()}}
        del x, nw
    for tag, hq, hk, dh, s_len, lens in (
            ("seamless cross", 16, 16, 64, ENCDEC_SRC, (ENCDEC_SRC,) * 4),
            ("gemma3 rolling", 4, 1, 256, 512, tuple(min(n, 512) for n in DECODE_LENS)),
            ("qwen2", 16, 16, 128, 2048, DECODE_LENS), ("zamba2", 32, 32, 112, 2048, DECODE_LENS),
            ("gemma3 global", 4, 1, 256, 2048, DECODE_LENS)):
        q, k, v = rn(4, hq, dh).to(bf16), rn(4, s_len, hk, dh).to(bf16), rn(4, s_len, hk, dh).to(bf16)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s_len, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        out[f"flash_decode bf16 narrow {tag} S={s_len}"] = {
            **device_ms(torch, timer, lambda: K.flash_decode(q, k, v, lengths)),
            **{f"SDPA {k_}": v_ for k_, v_ in device_ms(torch, timer, lambda: (
                F.scaled_dot_product_attention(q[:, :, None, :], k.transpose(1, 2),
                                               v.transpose(1, 2), attn_mask=mask,
                                               enable_gqa=True))).items()}}
        if tag in ("gemma3 rolling", "zamba2"):
            # the same grid with every length 0: the body's fixed cost (q,
            # the merges, the cluster's barriers) without a row of the cache
            none = torch.zeros_like(lengths)
            out[f"flash_decode bf16 narrow {tag} S={s_len} all lengths 0"] = device_ms(
                torch, timer, lambda: K.flash_decode(q, k, v, none))
        del q, k, v
    # the short bf16 GEMM rows, whose event times hold the launch path:
    # gemma3-1b's decode q projection and MLA's absorbed products, beside
    # matmul / bmm on the same inputs
    x, w = rn(4, 1152).bfloat16(), (rn(1152, 1024) * 1152 ** -0.5).bfloat16()
    out["gemm bf16 gemma3 decode q 4x1152->1024"] = device_ms(torch, timer, lambda: K.gemm(x, w))
    out["matmul bf16 gemma3 decode q 4x1152->1024"] = device_ms(
        torch, timer, lambda: torch.matmul(x, w))
    for kk, nn in ((128, 512), (512, 128)):
        x, w = rn(16, 4, kk).bfloat16(), (rn(16, kk, nn) * kk ** -0.5).bfloat16()
        out[f"batched_gemm bf16 MLA E=16 M=4 {kk}->{nn}"] = device_ms(
            torch, timer, lambda: K.batched_gemm(x, w))
        out[f"bmm bf16 MLA E=16 M=4 {kk}->{nn}"] = device_ms(torch, timer,
                                                             lambda: torch.bmm(x, w))
    del x, w
    for what, kernels in out.items():
        parts = ", ".join(f"{k} {v:.4g} ms" for k, v in kernels.items()) or "not measured"
        say(f"  device time (torch.profiler) {what:34s} {parts}  [{limit_line}]")
    return out


# (tag, B, Hq, Hk, D, S, lengths, n_splits timed): phi3-mini's engine decode
# (phase 11's shape, n_splits 2 as served) and gemma3-1b's global decode
SPLIT_SHAPES = (
    ("phi3-mini engine decode", 4, 32, 32, 96, 1024, [731, 400, 129, 0], (2,)),
    ("gemma3-1b global decode", 4, 4, 1, 256, 2048, [1400, 1000, 600, 250], (2, 4, 8, 16)),
)


def split_kernels(torch, K, rn, timer, record, full_tol, limit_line):
    """flash_decode_partial and the cuda_split backend (kernel + combine)
    at SPLIT_SHAPES beside flash_decode and SDPA at the same shape.  The
    kernel's bound counts q, the live K/V rows and the lengths read once and
    the partials n_splits * B * Hq * (Dv + 2) floats written once; the
    backend's adds the partials read again by the combine and the output
    written.  Returns the rows (the n_splits curve)."""
    F = torch.nn.functional
    rows = []
    for tag, b, hq, hk, dh, s_len, lens, splits in SPLIT_SHAPES:
        q, k, v = rn(b, hq, dh), rn(b, s_len, hk, dh), rn(b, s_len, hk, dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(dh)
        mask = (torch.arange(s_len, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        dense_ms = timer.ms(lambda: K.flash_decode(q, k, v, lengths))
        sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True))
        live = sum(min(max(x, 0), s_len) for x in lens)
        flops = 2.0 * live * hq * 2 * dh
        for n_splits in splits:
            got = K.flash_decode_partial(q, k, v, lengths, n_splits=n_splits)
            want = K.flash_decode_partial_plain(q, k, v, lengths, sc, n_splits)
            err = max(check_close(torch, f"flash_decode_partial {tag} n_splits={n_splits}",
                                  a, b_, **full_tol) for a, b_ in zip(got, want))
            check_close(torch, f"cuda_split {tag} n_splits={n_splits}",
                        K.decode_attention(q, k, v, lengths, backend="cuda_split",
                                           n_splits=n_splits),
                        K.flash_decode(q, k, v, lengths), **full_tol)
            ms = timer.ms(lambda: K.flash_decode_partial(q, k, v, lengths, n_splits=n_splits))
            plain = timer.ms(lambda: K.flash_decode_partial_plain(q, k, v, lengths, sc,
                                                                  n_splits))
            split_ms = timer.ms(lambda: K.decode_attention(q, k, v, lengths,
                                                           backend="cuda_split",
                                                           n_splits=n_splits))
            partials = 4.0 * n_splits * b * hq * (dh + 2)
            kbytes = 4.0 * (live * hk * 2 * dh + b * hq * dh + b) + partials
            sbytes = kbytes + partials + 4.0 * b * hq * dh
            record("flash_decode_partial", f"{tag} n_splits={n_splits}",
                   f"{tag} B={b} Hq={hq} Hk={hk} D={dh} S={s_len} len={lens} "
                   f"n_splits={n_splits}", err, ms, plain, None, flops, kbytes)
            b_split, _ = bound(flops, sbytes)
            say(f"    cuda_split backend (kernel + combine) {split_ms:.4g} ms (bound "
                f"{b_split:.4g} ms); flash_decode {dense_ms:.4g} ms; SDPA {sdpa_ms:.4g} ms; "
                f"blocks B*Hk*n_splits = {b * hk * n_splits} on 132 SMs  [{limit_line}]")
            rows.append(dict(shape=tag, n_splits=n_splits, blocks=b * hk * n_splits,
                             kernel_ms=ms, kernel_bound_ms=bound(flops, kbytes)[0],
                             split_ms=split_ms, split_bound_ms=b_split, plain_ms=plain,
                             flash_decode_ms=dense_ms, sdpa_ms=sdpa_ms, max_abs_err=err))
        del q, k, v
    return rows


# the bf16 partial's shapes: phi3-mini's engine decode, gemma3-1b's global
# decode (phase 24's length-sharded decode) over the n_splits curve and
# deepseek-v2-lite's absorbed MLA decode (the wide layout): (tag, B, Hq, Hk,
# D, Dv, S, lengths, n_splits)
SPLIT_BF16_SHAPES = (
    ("phi3-mini engine decode", 4, 32, 32, 96, 96, 1024, [731, 400, 129, 0], (2,)),
    ("gemma3-1b global decode", 4, 4, 1, 256, 256, 2048, [1400, 1000, 600, 250], (2, 4, 8, 16)),
    ("deepseek-v2-lite MLA absorbed decode", 4, 16, 1, 576, 512, 2048, [1400, 1000, 600, 250],
     (2,)),
)


def split_bf16_kernels(torch, K, rn, timer, record, full_tol, limit_line):
    """flash_decode_partial's bf16 entry at SPLIT_BF16_SHAPES: its acc
    bitwise the fp32 entry's acc on the upcast inputs rounded once, m and l
    bitwise the fp32 entry's, acc within one bf16 ulp (+1e-4) and m, l
    within the fp32 tolerance of the plain version; timed beside the fp32
    entry on the upcast inputs, the plain version and the cuda_split
    backend at bf16 (kernel + combine, the merge rounded once; against the
    merge of the plain partials within the roundings both make: each rounds
    every shard's acc and the output, 2^-7 of the merge of the shards' |acc|
    plus 2^-7 of |out|, since the shards' acc may cancel).  The bound counts q, the live K/V rows at 2 bytes
    a value and the lengths read once, the partials written once (acc 2
    bytes a value, m and l 4 each).  Returns the rows."""
    bf16, rows = torch.bfloat16, []
    for tag, b, hq, hk, d, dv, s_len, lens, splits in SPLIT_BF16_SHAPES:
        q, k, v = (rn(*shape).to(bf16) for shape in ((b, hq, d), (b, s_len, hk, d),
                                                       (b, s_len, hk, dv)))
        up = (q.float(), k.float(), v.float())
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        sc = 1.0 / math.sqrt(d)
        live = sum(min(max(x, 0), s_len) for x in lens)
        flops = 2.0 * live * hq * (d + dv)
        for ns in splits:
            label = (f"{tag} B={b} Hq={hq} Hk={hk} D={d} Dv={dv} S={s_len} len={lens} "
                     f"n_splits={ns} bf16")
            got = K.flash_decode_partial(q, k, v, lengths, n_splits=ns)
            f32 = K.flash_decode_partial(*up, lengths, n_splits=ns)
            if got[0].dtype != bf16 or not torch.equal(got[0], f32[0].to(bf16)) or not (
                    torch.equal(got[1], f32[1]) and torch.equal(got[2], f32[2])):
                fail(f"flash_decode_partial_bf16 {label}: not the fp32 entry's partials on the "
                     f"upcast inputs (acc rounded once, m and l bitwise)")
            want = K.flash_decode_partial_plain(q, k, v, lengths, sc, ns)
            err = max(check_close(torch, f"flash_decode_partial_bf16 {label} acc",
                                  got[0].float(), want[0].float(), **BF16_TOL),
                      check_close(torch, f"flash_decode_partial_bf16 {label} m", got[1], want[1],
                                  **full_tol),
                      check_close(torch, f"flash_decode_partial_bf16 {label} l", got[2], want[2],
                                  **full_tol))
            split = K.decode_attention(q, k, v, lengths, backend="cuda_split", n_splits=ns)
            merged = K.combine_partials_ref(want[0].float(), want[1], want[2]).to(bf16).float()
            mag = K.combine_partials_ref(want[0].float().abs(), want[1], want[2])
            if bool(((split.float() - merged).abs()
                     > 2.0 ** -7 * (mag + merged.abs()) + BF16_TOL["atol"]).any()):
                fail(f"cuda_split bf16 {label}: past the roundings of the plain route "
                     f"(max |err| {float((split.float() - merged).abs().max()):.3e})")
            ms = timer.ms(lambda: K.flash_decode_partial(q, k, v, lengths, n_splits=ns))
            fp32_ms = timer.ms(lambda: K.flash_decode_partial(*up, lengths, n_splits=ns))
            plain = timer.ms(lambda: K.flash_decode_partial_plain(q, k, v, lengths, sc, ns))
            split_ms = timer.ms(lambda: K.decode_attention(q, k, v, lengths,
                                                           backend="cuda_split", n_splits=ns))
            nbytes = 2.0 * (live * hk * (d + dv) + b * hq * d) + 4.0 * b \
                + ns * b * hq * (2.0 * dv + 8.0)
            record("flash_decode_partial_bf16", f"{tag} n_splits={ns}", label, err, ms, plain,
                   None, flops, nbytes, peak=PEAK_BF16_FLOPS, fp32_ms=fp32_ms)
            say(f"    cuda_split backend at bf16 (kernel + combine) {split_ms:.4g} ms  "
                f"[{limit_line}]")
            rows.append(dict(shape=tag, n_splits=ns, kernel_ms=ms, fp32_kernel_ms=fp32_ms,
                             plain_ms=plain, split_ms=split_ms, max_abs_err=err,
                             bound_ms=bound(flops, nbytes, PEAK_BF16_FLOPS)[0]))
            del got, f32, want, split, merged
        del q, k, v, up
    return rows


def combine_kernels(torch, K, rn, timer, record, full_tol):
    """The combine kernel at SPLIT_SHAPES, on the partials it merges there:
    flash_decode's shards of decode_shard_rows(S) rows (gemma3-1b's global
    decode first: the headline) and the cuda_split backend's n_splits as
    phase 11 serves it (phi3-mini, 2) and the widest curve point (gemma3-1b,
    16).  Plain version: combine_partials_ref; no single PyTorch call merges
    flash partials.  Bound: the partials read once and the output written
    once; 3 flops per partial element (exp weight, multiply, add)."""
    rows = []
    for tag, b, hq, hk, dh, s_len, lens, splits in reversed(SPLIT_SHAPES):
        q, k, v = rn(b, hq, dh), rn(b, s_len, hk, dh), rn(b, s_len, hk, dh)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for what, ns in (("flash_decode", s_len // K.decode_shard_rows(s_len)),
                         ("cuda_split", max(splits))):
            parts = K.flash_decode_partial(q, k, v, lengths, n_splits=ns)
            err = combine_check(torch, K, f"{tag} {what} {ns} shards", parts, full_tol)
            ms = timer.ms(lambda: K.combine_partials(*parts))
            plain = timer.ms(lambda: K.combine_partials_ref(*parts))
            label = f"{tag} {what} shards={ns} B={b} Hq={hq} Dv={dh}"
            record("combine_partials", f"{tag} {what}", label, err, ms, plain, None,
                   3.0 * ns * b * hq * dh, 4.0 * (ns * b * hq * (dh + 2) + b * hq * dh))
            rows.append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain))
            if what == "flash_decode" and tag.startswith("gemma3"):
                # the bf16 merge (the wide flash_decode_bf16 ends with it, and
                # cuda_split at bf16), timed on gemma3-1b's partials
                bf16 = torch.bfloat16
                got = K.combine_partials(*parts, dtype=bf16)
                if not torch.equal(got, K.combine_partials(*parts).to(bf16)):
                    fail(f"combine_partials_bf16 {tag}: not the fp32 merge rounded once")
                err = check_close(torch, f"combine_partials_bf16 {tag}", got.float(),
                                  K.combine_partials_ref(*parts), **BF16_TOL)
                ms = timer.ms(lambda: K.combine_partials(*parts, dtype=bf16))
                plain = timer.ms(lambda: K.combine_partials_ref(*parts).to(bf16))
                record("combine_partials_bf16", f"{tag} {what}", label + " bf16 out", err, ms,
                       plain, None, 3.0 * ns * b * hq * dh,
                       4.0 * ns * b * hq * (dh + 2) + 2.0 * b * hq * dh, peak=PEAK_BF16_FLOPS)
            del parts
        del q, k, v
    return rows


# ResNet-50's 7x7/2 stem, a 3x3 at 56x56x64 and a 1x1 at 7x7x2048
CONV_LAYERS = (("resnet-50 stem 7x7/2", (1, 224, 224, 3), (7, 7, 3, 64), 2),
               ("resnet-50 3x3 at 56x56x64", (1, 56, 56, 64), (3, 3, 64, 64), 1),
               ("resnet-50 1x1 at 7x7x2048", (1, 7, 7, 2048), (1, 1, 2048, 512), 1))


def conv_kernels(torch, rn, timer, full_tol, limit_line):
    """conv2d cuda (im2col in PyTorch + gemm.cu) at CONV_LAYERS beside its
    plain version (the ref backend: im2col + matmul) and the torch backend
    (one F.conv2d, F.pad first where SAME pads unevenly; TF32 off), with the
    bound of the convolution (x, w, out bytes; 2 * MACs)."""
    from repro_torch.core.registry import get_impl
    cuda, ref, lib = (get_impl("conv2d", b) for b in ("cuda", "ref", "torch"))
    rows = []
    for tag, xs, ws, stride in CONV_LAYERS:
        attrs = {"stride": stride, "padding": "SAME"}
        x, w = rn(*xs), rn(*ws, scale=1.0 / math.sqrt(ws[0] * ws[1] * ws[2]))
        (got,) = cuda([x, w], attrs)
        err = check_close(torch, f"conv2d cuda {tag}", got, ref([x, w], attrs)[0], **full_tol)
        check_close(torch, f"conv2d torch {tag}", lib([x, w], attrs)[0], got, **full_tol)
        ms = timer.ms(lambda: cuda([x, w], attrs))
        plain = timer.ms(lambda: ref([x, w], attrs))
        lib_ms = timer.ms(lambda: lib([x, w], attrs))
        n, oh, ow, co = got.shape
        flops = 2.0 * n * oh * ow * co * ws[0] * ws[1] * ws[2]
        nbytes = 4.0 * (x.numel() + w.numel() + got.numel())
        b_ms, b_by = bound(flops, nbytes)
        say(f"  conv2d cuda (im2col + gemm) {tag:27s} err {err:.2e}  kernel {ms:.4g} ms  plain "
            f"{plain:.4g} ms  torch (F.conv2d) {lib_ms:.4g} ms  bound {b_ms:.4g} ms ({b_by})  "
            f"[{limit_line}]")
        rows.append(dict(shape=f"{tag} x={xs} w={ws} stride={stride}", max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        del x, w, got
    return rows


def attention_pairs(sq, skv, causal, window):
    """(query row, column) pairs flash_attention's mask allows (row i at
    position skv - sq + i): the work this input needs."""
    n = 0
    for i in range(sq):
        row = skv - sq + i
        hi = min(skv - 1, row) if causal else skv - 1
        lo = max(0, row - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def ssd_flops(b, sl, h, p, g, n, q, per_head_scores=False):
    """Operations the SSD scan needs (2 per multiply-add), in each chunk of
    q: the score product C.B over the q(q+1)/2 causal pairs once per
    (sequence, group), since the heads of a group share it; per (sequence,
    head) the score-xbar product over those pairs, C.state and the state
    update.  ``per_head_scores`` counts the scores once per head, as PRs
    14-17 did."""
    q = min(q, sl)
    pairs = q * (q + 1) / 2
    scores = (h if per_head_scores else g) * pairs * 2.0 * n
    return b * -(-sl // q) * (scores + h * (pairs * 2.0 * p + 4.0 * q * n * p))


LAYERSTACK_PREFILL = 1024     # the prompt length phase 3 times the prefill kernels at
DECODE_LENS = (1400, 1000, 600, 250)   # the cache lengths it times a batch-4 decode step at
# phase 21 (seamless-m4t-medium, EncDec): sources of ENCDEC_SRC frames and
# prompts of ENCDEC_PROMPT tokens, prefilled together, then ENCDEC_NEW tokens
ENCDEC_SRC, ENCDEC_PROMPT, ENCDEC_NEW = 1024, 64, 32


def stack_calls(cfg, phase, n_slots=4, cache_cap=2048):
    """The kernel calls of one batch-4 decode step (``phase="decode"``) or
    one prefill of a layer-stack config: {(entry, shape): calls}, the entry
    the kernel's name, ``<kernel>_bf16`` for a call on bf16 inputs (every
    call of a bfloat16 config but the MoE router's, which is an fp32
    ``dense`` in both packages).  A
    decoder-only config's prefill is one LAYERSTACK_PREFILL-token sequence;
    the encoder-decoder's is phase 21's: ``n_slots`` sources of ENCDEC_SRC
    frames through the encoder, then their ENCDEC_PROMPT-token prompts, and
    its decode step reads a self-attention cache of ENCDEC_PROMPT +
    ENCDEC_NEW rows and the encoder's ENCDEC_SRC rows.  gemm shapes are (M,
    K, N), batched_gemm (E, M, K, N), flash_decode (B, Hq, Hk, D, Dv, rows,
    lengths), flash_attention (B, Sq, Skv, Hq, Hk, D, Dv, causal, window);
    a sliding-window layer's decode reads its rolling cache of ``window``
    rows, and its prefill attends within the window.  MLA's decode runs
    its two absorbed products as batched_gemm (heads as experts) around
    one wide flash_decode over the latent cache."""
    from repro_torch.layers.moe import _capacity
    dec = phase == "decode"
    encdec = bool(cfg.n_encoder_layers)
    pb = n_slots if encdec else 1                       # sequences a prefill call holds
    sq = ENCDEC_PROMPT if encdec else LAYERSTACK_PREFILL
    m, d = (n_slots if dec else pb * sq), cfg.d_model
    if encdec:
        cache_cap = ENCDEC_PROMPT + ENCDEC_NEW
        lens_all = (ENCDEC_PROMPT + ENCDEC_NEW // 2,) * n_slots
    else:
        lens_all = DECODE_LENS[:n_slots]
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sfx = "_bf16" if cfg.dtype == "bfloat16" else ""
    calls = {}

    def add(kernel, shape, n=1, fp32=False):
        key = (kernel + ("" if fp32 else sfx), shape)
        calls[key] = calls.get(key, 0) + n

    def attention(rows, window, causal=True, seq=sq):
        """q/k/v/o projections of ``rows`` rows and the attention kernel
        (at prefill over ``seq`` rows a sequence)."""
        for kk, nn in ((d, hq * dh), (d, hk * dh), (d, hk * dh), (hq * dh, d)):
            add("gemm", (rows, kk, nn))
        if dec:
            cap = min(window or cache_cap, cache_cap)
            add("flash_decode", (n_slots, hq, hk, dh, dh, cap,
                                 tuple(min(n, cap) for n in lens_all)))
        else:
            add("flash_attention", (pb, seq, seq, hq, hk, dh, dh, causal, window))

    def ffn(kind, rows, width):
        add("rmsnorm", (rows, d))
        add("gemm", (rows, d, width), 2 if kind == "swiglu" else 1)
        add("gemm", (rows, width, d))

    for blk in cfg.plan.all_blocks():
        if blk.mixer != "shared_attn":                  # a shared block norms inside
            add("rmsnorm", (m, d))
        if blk.mixer == "mamba":
            s = cfg.ssm
            gn = s.n_groups * s.state
            for nn in (s.d_inner, s.d_inner, gn, gn, s.n_heads):
                add("gemm", (m, d, nn))
            add("gemm", (m, s.d_inner, d))
            add("rmsnorm", (m, s.d_inner))
            if not dec:
                add("ssd_scan", (1, m, s.n_heads, s.head_dim, s.n_groups, s.state, s.chunk))
        elif blk.mixer == "mla":
            ml = cfg.mla
            for nn in (hq * ml.qk_dim, ml.kv_lora_rank, ml.rope_dim):
                add("gemm", (m, d, nn))
            if dec:
                add("batched_gemm", (hq, n_slots, ml.nope_dim, ml.kv_lora_rank))
                add("flash_decode", (n_slots, hq, 1, ml.kv_lora_rank + ml.rope_dim,
                                     ml.kv_lora_rank, cache_cap, lens_all))
                add("batched_gemm", (hq, n_slots, ml.kv_lora_rank, ml.v_dim))
            else:
                add("gemm", (m, ml.kv_lora_rank, hq * ml.nope_dim))
                add("gemm", (m, ml.kv_lora_rank, hq * ml.v_dim))
                add("flash_attention", (pb, sq, sq, hq, hq, ml.qk_dim, ml.v_dim, True, None))
            add("gemm", (m, hq * ml.v_dim, d))
        elif blk.mixer == "shared_attn":                # fuse, norm, attention, norm, SwiGLU
            add("gemm", (m, 2 * d, d))
            add("rmsnorm", (m, d))
            attention(m, None)
            ffn("swiglu", m, cfg.d_ff)
        else:
            attention(m, cfg.window if blk.mixer == "attn_local" else None)
        if blk.cross:                                   # decoder rows over the encoder's
            add("rmsnorm", (m, d))
            add("gemm", (m, d, hq * dh))
            if dec:
                add("flash_decode", (n_slots, hq, hk, dh, dh, ENCDEC_SRC,
                                     (ENCDEC_SRC,) * n_slots))
            else:
                add("gemm", (pb * ENCDEC_SRC, d, hk * dh), 2)
                add("flash_attention", (pb, sq, ENCDEC_SRC, hq, hk, dh, dh, False, None))
            add("gemm", (m, hq * dh, d))
        if blk.ffn == "moe":
            mo = cfg.moe
            add("rmsnorm", (m, d))
            add("gemm", (m, d, mo.n_experts), fp32=True)          # the router
            if mo.n_shared:
                add("gemm", (m, d, mo.d_shared), 2)
                add("gemm", (m, mo.d_shared, d))
            rows = n_slots * _capacity(1, cfg) if dec else _capacity(m, cfg)
            add("batched_gemm", (mo.n_experts, rows, d, mo.d_expert), 2)
            add("batched_gemm", (mo.n_experts, rows, mo.d_expert, d))
        elif blk.ffn != "none":
            ffn(blk.ffn, m, cfg.d_ff)
    if encdec and not dec:                              # the encoder: non-causal attn + MLP
        rows = pb * ENCDEC_SRC
        for _ in range(cfg.n_encoder_layers):
            add("rmsnorm", (rows, d))
            attention(rows, None, causal=False, seq=ENCDEC_SRC)
            ffn("mlp", rows, cfg.d_ff)
        add("rmsnorm", (rows, d))                       # enc_norm
    add("rmsnorm", (m, d))
    add("gemm", (n_slots if dec else pb, d, cfg.vocab_padded))
    return calls


def stack_launches(cfg, prefills, steps, names):
    """Each kernel entry's launches over ``prefills`` prefills and ``steps``
    decode steps of a layer-stack config (every name in ``names`` a key),
    each call counted on the entry of its inputs' dtype (stack_calls): a
    bfloat16 config's on the bf16 entries but for the MoE router's fp32
    ``gemm``."""
    want = dict.fromkeys(names, 0)
    for phase, n in (("prefill", prefills), ("decode", steps)):
        for (entry, _), calls in stack_calls(cfg, phase).items():
            want[entry] += calls * n
    # a merge per fp32 flash_decode and per wide bf16 one (D or Dv past 256);
    # the narrow bf16 decode merges inside its one launch
    want["combine_partials"] = want["flash_decode"]
    want["combine_partials_bf16"] = sum(
        calls * n for phase, n in (("prefill", prefills), ("decode", steps))
        for (entry, shape), calls in stack_calls(cfg, phase).items()
        if entry == "flash_decode_bf16" and not bf16_own_order("flash_decode", shape))
    return want


def stack_kernels(torch, K, cfg, rn, timer, record, full_tol, limit_line):
    """Every kernel call of ``cfg``'s batch-4 decode step and 1024-token
    prefill (stack_calls): each distinct shape checked against its plain
    version and timed with it and with one PyTorch library call (matmul,
    rms_norm, SDPA with the same boolean mask and GQA, bmm; the SSD scan
    has none).  A call on a bf16 entry (a bfloat16 config's, recorded as
    ``<kernel>_bf16``) runs on bf16 inputs (the scan's dt and A stay fp32,
    as the mamba layer passes them): held within BF16_TOL of its plain
    version and, but for the bodies with an order of their own
    (bf16_own_order: the tensor-core bodies, rmsnorm, the narrow
    flash_decode), bitwise to the fp32 entry's output on the upcast inputs
    rounded once (the scan's state bitwise the fp32 entry's), timed beside
    that fp32 entry and the library call on bf16 inputs; the bound counts
    2 bytes a bf16 value and the bf16 tensor-core rate.  The fp32 entries
    of FP32_ROWS, which no full-width config runs any more, get their own
    row from the same call on the upcast inputs.  Returns {phase: ({kernel:
    ms per phase}, sum of the calls' bounds in ms)}."""
    F = torch.nn.functional
    times = {}

    def measure(entry, shape, phase):
        bf16 = entry.endswith("_bf16")
        kernel = entry[:-len("_bf16")] if bf16 else entry
        label = f"{cfg.name} {phase} {kernel} {shape}"
        lib, cast = None, None                # cast: the arguments a bf16 call takes in bf16
        if kernel == "gemm":
            m, kk, nn = shape
            args = (rn(m, kk), rn(kk, nn, scale=1.0 / math.sqrt(kk)))
            fn, plain, lib = K.gemm, K.gemm_plain, torch.matmul
            flops = 2.0 * m * kk * nn
            nb = lambda es: es * (m * kk + kk * nn + m * nn)                # noqa: E731
        elif kernel == "batched_gemm":
            e, m, kk, nn = shape
            args = (rn(e, m, kk), rn(e, kk, nn, scale=1.0 / math.sqrt(kk)))
            fn, plain, lib = K.batched_gemm, K.batched_gemm_plain, torch.bmm
            flops = 2.0 * e * m * kk * nn
            nb = lambda es: es * e * (m * kk + kk * nn + m * nn)            # noqa: E731
        elif kernel == "rmsnorm":
            rows, d = shape
            eps = cfg.norm_eps
            args = (rn(rows, d), 1.0 + 0.1 * rn(d))
            fn = lambda x, w: K.rmsnorm(x, w, eps=eps)                      # noqa: E731
            plain = lambda x, w: K.rmsnorm_plain(x, w, eps=eps)             # noqa: E731
            lib = lambda x, w: F.rms_norm(x, (d,), w, eps)                  # noqa: E731
            flops = 3.0 * rows * d
            nb = lambda es: es * (2 * rows * d + d)                         # noqa: E731
        elif kernel == "flash_decode":
            b, hq, hk, dh, dv, s_len, lens = shape
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            args = (rn(b, hq, dh), rn(b, s_len, hk, dh), rn(b, s_len, hk, dv))
            mask = (torch.arange(s_len, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            fn = lambda q, k, v: K.flash_decode(q, k, v, lengths)           # noqa: E731
            plain = lambda q, k, v: K.flash_decode_plain(q, k, v, lengths,  # noqa: E731
                                                         1.0 / math.sqrt(dh))
            lib = lambda q, k, v: F.scaled_dot_product_attention(           # noqa: E731
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)
            live = sum(lens)
            flops = 2.0 * live * hq * (dh + dv)
            nb = lambda es: es * (live * hk * (dh + dv) + b * hq * (dh + dv)) + 4.0 * b  # noqa
        elif kernel == "flash_attention":
            b, sq, skv, hq, hk, dh, dv, causal, window = shape
            args = (rn(b, sq, hq, dh), rn(b, skv, hk, dh), rn(b, skv, hk, dv))
            row = torch.arange(skv - sq, skv, device="cuda")[:, None]
            col = torch.arange(skv, device="cuda")[None, :]
            mask = ((col <= row) if causal else torch.ones_like(col <= row)) & (
                (col > row - window) if window is not None else True)
            fn = lambda q, k, v: K.flash_attention(                         # noqa: E731
                q, k, v, causal=causal, window=window)
            plain = lambda q, k, v: K.flash_attention_plain(                # noqa: E731
                q, k, v, causal=causal, window=window, scale=1.0 / math.sqrt(dh))
            lib = lambda q, k, v: F.scaled_dot_product_attention(           # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)
            flops = 2.0 * b * attention_pairs(sq, skv, causal, window) * hq * (dh + dv)
            nb = lambda es: es * b * (sq * hq * (dh + dv) + skv * hk * (dh + dv))  # noqa: E731
        else:                                                               # ssd_scan
            b, sl, h, p, grp, nn, q = shape
            args = (rn(b, sl, h, p), F.softplus(rn(b, sl, h) - 3.0),   # dt ~ mamba2's 1e-3..0.1
                    -torch.linspace(1.0, 16.0, h, device="cuda"),
                    0.3 * rn(b, sl, grp, nn), 0.3 * rn(b, sl, grp, nn))
            cast = (0, 3, 4)                                            # x, B, C
            fn = lambda *a: K.ssd_scan(*a, chunk=q)                         # noqa: E731
            plain = lambda *a: K.ssd_scan_plain(*a, chunk=q)                # noqa: E731
            flops = ssd_flops(b, sl, h, p, grp, nn, q)
            say(f"  ssd_scan bound at {shape}: {flops / 1e9:.4g} GFLOP with the scores once "
                f"per group, {ssd_flops(b, sl, h, p, grp, nn, q, True) / 1e9:.4g} GFLOP "
                "counted once per head (PRs 14-17)")
            # x, B, C and y in the entry's type; dt, A and the state fp32
            nb = lambda es: (es * (2 * b * sl * h * p + 2 * b * sl * grp * nn)  # noqa: E731
                             + 4.0 * (b * sl * h + h + b * h * p * nn))
        def tup(x):
            return x if isinstance(x, tuple) else (x,)

        name, peak, fp32_ms, nbytes = kernel, PEAK_FP32_FLOPS, None, nb(4.0)
        if bf16:
            if kernel not in BF16_KERNELS:
                fail(f"{cfg.name} is bfloat16 but runs {kernel}, which has no bf16 entry")
            cast = range(len(args)) if cast is None else cast
            args = tuple(a.to(torch.bfloat16) if i in cast else a for i, a in enumerate(args))
            up = tuple(a.float() for a in args)            # the upcast inputs
            name, peak, nbytes, label = entry, PEAK_BF16_FLOPS, nb(2.0), label + " bf16"
            if kernel == "flash_attention":
                label += f" shard {K.attention_shard_cols_bf16(*shape[2:5])}"
            elif kernel == "flash_decode" and bf16_own_order(kernel, shape):
                label += f" plan {K.decode_plan_bf16(shape[5], shape[1], shape[2])}"
            elif kernel in TENSOR_CORE_BF16:
                m, count = (shape[0], 1) if kernel == "gemm" else (shape[1], shape[0])
                label += f" plan {K.gemm_bf16_plan(m, shape[-1], count)}"
        outs, wants = tup(fn(*args)), tup(plain(*args))
        if bf16:
            outs32 = tup(fn(*up))
            # the first output is bf16, the fp32 entry's rounded once (but
            # for the bodies with an order of their own: bf16_gemm_cases,
            # bf16_attention_cases and bf16_norm_decode_cases hold those);
            # the scan's state stays fp32, bitwise the fp32 entry's
            own = bf16_own_order(kernel, shape)
            if outs[0].dtype != torch.bfloat16 or (not own and (
                    not torch.equal(outs[0], outs32[0].to(torch.bfloat16)) or not all(
                        torch.equal(a, b_) for a, b_ in zip(outs[1:], outs32[1:])))):
                fail(f"{label}: not the fp32 entry's output on the upcast inputs rounded once")
            err = max([check_close(torch, label, outs[0].float(), wants[0].float(), **BF16_TOL)]
                      + [check_close(torch, label, a, b_, **full_tol)
                         for a, b_ in zip(outs[1:], wants[1:])])
            fp32_ms = timer.ms(lambda: fn(*up))
            if kernel in FP32_ROWS:
                label32 = f"{cfg.name} {phase} {kernel} {shape} (fp32 entry, upcast inputs)"
                err32 = max(check_close(torch, label32, a, b_, **full_tol)
                            for a, b_ in zip(outs32, tup(plain(*up))))
                record(kernel, f"{cfg.name} {phase}", label32, err32, fp32_ms,
                       timer.ms(lambda: plain(*up)),
                       None if lib is None else timer.ms(lambda: lib(*up)), flops, nb(4.0))
            del up, outs32
        else:
            err = max(check_close(torch, label, a, b_, **full_tol) for a, b_ in zip(outs, wants))
        ms = timer.ms(lambda: fn(*args))
        plain_ms = timer.ms(lambda: plain(*args))
        lib_ms = None if lib is None else timer.ms(lambda: lib(*args))
        record(name, f"{cfg.name} {phase}", label, err, ms, plain_ms, lib_ms, flops, nbytes,
               peak=peak, fp32_ms=fp32_ms)
        del args, outs, wants
        return ms, bound(flops, nbytes, peak)[0]

    out = {}
    for phase in ("decode", "prefill"):
        parts, bound_ms = {}, 0.0
        for (entry, shape), calls in stack_calls(cfg, phase).items():
            if (entry, shape) not in times:
                times[(entry, shape)] = measure(entry, shape, phase)
            ms, b_ms = times[(entry, shape)]
            kernel = entry[:-len("_bf16")] if entry.endswith("_bf16") else entry
            parts[kernel] = parts.get(kernel, 0.0) + calls * ms
            bound_ms += calls * b_ms
        out[phase] = (parts, bound_ms)
    if cfg.ssm is not None:
        ssd_path_shapes(torch, K, cfg, rn, timer, record, full_tol)
    if cfg.mla is not None:
        out["k_cat"] = mla_k_cat(torch, cfg, rn, timer, limit_line)
    return out


def mla_k_cat(torch, cfg, rn, timer, limit_line, n_slots=4, cache_cap=2048):
    """The copy MLA's absorbed decode makes every layer and step (not a
    kernel): torch.cat of the latent and rope caches (in the config's
    dtype) into the decode kernel's K, at the batch-4 decode step's cache,
    beside its bound (read both caches, write the copy once)."""
    ml = cfg.mla
    dt = getattr(torch, cfg.dtype)
    ckv = rn(n_slots, cache_cap, ml.kv_lora_rank).to(dt)
    kpe = rn(n_slots, cache_cap, ml.rope_dim).to(dt)
    ms = timer.ms(lambda: torch.cat([ckv, kpe], dim=-1))
    nbytes = 2.0 * ckv.element_size() * (ckv.numel() + kpe.numel())
    layers = sum(b.mixer == "mla" for b in cfg.plan.all_blocks())
    rec = {"shape": f"B={n_slots} S={cache_cap} {ml.kv_lora_rank}+{ml.rope_dim} {cfg.dtype}",
           "ms": ms, "bound_ms": bound(0.0, nbytes)[0], "calls_per_step": layers,
           "ms_per_step": ms * layers}
    say(f"  {'MLA k_cat copy (torch.cat)':27s} {rec['shape']:44s} {ms:.4g} ms a call, "
        f"{layers} calls a step ({rec['ms_per_step']:.4g} ms)  bound {rec['bound_ms']:.4g} ms "
        f"(bytes)  [{limit_line}]")
    del ckv, kpe
    return rec


def ssd_path_shapes(torch, K, cfg, rn, timer, record, full_tol):
    """ssd_scan as the mamba layer calls it (with D) at the
    LAYERSTACK_PREFILL-token prefill and at every chunk-padded prompt length
    phases 10 and 19 prefill (layerstack_phase's requests), each against its
    plain version and timed with it (no PyTorch call computes the scan).  A
    bfloat16 config's calls run the bf16 entry on bf16 x, B and C (dt, A
    and D fp32): y bitwise the fp32 entry's rounded once and within
    BF16_TOL of the plain version, the state bitwise the fp32 entry's,
    timed beside the fp32 entry."""
    import numpy as np
    F = torch.nn.functional
    s = cfg.ssm
    h, p, grp, nn, q = s.n_heads, s.head_dim, s.n_groups, s.state, s.chunk
    bf16 = cfg.dtype == "bfloat16"
    es = 2.0 if bf16 else 4.0
    name = "ssd_scan_bf16" if bf16 else "ssd_scan"
    lens = np.random.default_rng(0).integers(200, 1401, 8)     # layerstack_phase's prompts
    padded = sorted({-(-int(n) // q) * q for n in lens} | {LAYERSTACK_PREFILL})
    for sl in padded:
        args = [rn(1, sl, h, p), F.softplus(rn(1, sl, h) - 3.0),
                -torch.linspace(1.0, 16.0, h, device="cuda"), 0.3 * rn(1, sl, grp, nn),
                0.3 * rn(1, sl, grp, nn), rn(h)]
        label = f"{cfg.name} prefill ssd_scan with D, S={sl} (the batcher's prompts)"
        fp32_ms = None
        if bf16:
            for i in (0, 3, 4):
                args[i] = args[i].to(torch.bfloat16)
            up = [a.float() for a in args]
            label += " bf16"
        got, want = K.ssd_scan(*args, chunk=q), K.ssd_scan_plain(*args, chunk=q)
        if bf16:
            y32, st32 = K.ssd_scan(*up, chunk=q)
            if not (torch.equal(got[0], y32.to(torch.bfloat16)) and torch.equal(got[1], st32)):
                fail(f"{label}: not the fp32 entry's output on the upcast inputs rounded once")
            err = max(check_close(torch, label, got[0].float(), want[0].float(), **BF16_TOL),
                      check_close(torch, label, got[1], want[1], **full_tol))
            fp32_ms = timer.ms(lambda: K.ssd_scan(*up, chunk=q))
            del up, y32, st32
        else:
            err = max(check_close(torch, label, a, b, **full_tol) for a, b in zip(got, want))
        ms = timer.ms(lambda: K.ssd_scan(*args, chunk=q))
        plain_ms = timer.ms(lambda: K.ssd_scan_plain(*args, chunk=q))
        nbytes = es * 2 * (sl * h * p + sl * grp * nn) + 4.0 * (sl * h + 2 * h + h * p * nn)
        record(name, f"{cfg.name} prefill S={sl} with D", label, err, ms, plain_ms, None,
               ssd_flops(1, sl, h, p, grp, nn, q), nbytes,
               peak=PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS, fp32_ms=fp32_ms)
        del args, got, want


def tick_estimate(by_tag, ops_ms, n_layers, path, split_ms=None):
    """Milliseconds of one engine tick of a serving path, by part: each
    kernel's time at the tick's shapes (phase 3) times its launches per
    tick, and the cache-write ops' time times their calls per tick.
    Attention is timed at representative cache lengths, not the run's
    own; on the "split" path (phase 11, the dense cache) the decode's is
    the cuda_split backend's time, ``split_ms`` (kernel + combine).  Each
    part was timed alone, from its first launch to its last kernel's end;
    in the engine the host's dispatch of one part overlaps the device work
    of the one before, so the parts can add up to more than the tick."""
    L = n_layers
    out = {}
    for phase, attn in (("decode", "flash_decode"), ("prefill", "flash_chunk_attention")):
        tag = f"engine {phase}"

        def g(what):
            return by_tag[("gemm", f"{tag} {what}")]

        if path == "split" and phase == "decode":
            attn_ms = split_ms
        elif path in ("dense", "split"):
            attn_ms = by_tag[(attn, tag)]
        else:
            mode = path.split()[-1]
            attn_ms = by_tag[(attn.replace("flash_", "flash_paged_"), f"{mode} {tag}")]
        out[phase] = {
            "gemm": 4 * L * g("q/k/v/o") + 2 * L * g("gate/up") + L * g("down") + g("lm_head"),
            "rmsnorm": (2 * L + 1) * by_tag[("rmsnorm", tag)],
            "attention": L * attn_ms,
            "cache writes": 2 * L * ops_ms[("dense" if path == "split" else path, phase)],
        }
    return out


# --------------------------------------------------------------------------- #
# phase 4: small model, card vs CPU
# --------------------------------------------------------------------------- #

def model_phase(torch):
    """Returns the worst |card - CPU| over the dense and paged fp32 Programs'
    outputs (tolerance 1e-4) and over the int8-paged Programs' logits
    (bound 5e-2: a K/V value an ulp apart on the two sides can round to
    another int8 level).  int8 pages may differ by one level and scales by
    1e-4 relative."""
    import numpy as np
    from repro_torch.core.program import compile
    from repro_torch.models.graph_lm import (GraphLMConfig, build_decode_graph,
                                             build_paged_decode_graph,
                                             build_paged_prefill_graph,
                                             build_prefill_graph, init_lm_params)
    cfg = GraphLMConfig(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96)
    params = init_lm_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    b, t, cap = 3, 16, 40
    page, mp = 5, 8                               # cap = 40 logical rows
    n_blocks = b * mp + 2
    tables = rng.permutation(n_blocks)[:b * mp].reshape(b, mp).astype(np.int32)
    paged = dict(n_blocks=n_blocks, page_size=page, max_pages=mp)
    graphs = [(build_prefill_graph(cfg, params, batch=b, chunk=t, cache_cap=cap), t),
              (build_decode_graph(cfg, params, batch=b, cache_cap=cap), 1)]
    for kv in ("float32", "int8"):
        graphs += [(build_paged_prefill_graph(cfg, params, batch=b, chunk=t, kv_dtype=kv,
                                              **paged), t),
                   (build_paged_decode_graph(cfg, params, batch=b, kv_dtype=kv, **paged), 1)]
    worst, worst_kv8 = 0.0, 0.0
    for graph, tt in graphs:
        inputs = {"tokens": rng.integers(0, cfg.vocab, (b, tt)).astype(np.int32),
                  "start": np.array([0, 7, cap - tt], np.int32),
                  "n_new": np.array([tt, 0, tt], np.int32)}
        if "block_tables" in graph.inputs:
            inputs["block_tables"] = tables
        for name, spec in graph.inputs.items():
            if not name.startswith("cache_"):
                continue
            if spec.dtype == "int8":
                inputs[name] = rng.integers(-127, 128, spec.shape).astype(np.int8)
            elif name.endswith("_scale"):
                inputs[name] = (rng.random(spec.shape) * 0.05).astype(np.float32)
            else:
                inputs[name] = rng.standard_normal(spec.shape).astype(np.float32)
        on_card = compile(graph, device="cuda")(**inputs)
        on_cpu = compile(graph, device="cpu")(**inputs)
        kv8 = "kv8" in graph.name
        for name, got, want in zip(graph.outputs, on_card, on_cpu):
            got = got.cpu()
            if not kv8:
                worst = max(worst, check_close(torch, f"{graph.name} {name}", got, want,
                                               atol=1e-4, rtol=1e-4))
            elif name == "logits":
                worst_kv8 = max(worst_kv8, check_close(torch, f"{graph.name} {name}", got,
                                                       want, atol=5e-2, rtol=0.0))
            elif got.dtype == torch.int8:
                if int((got.int() - want.int()).abs().max()) > 1:
                    fail(f"{graph.name} {name}: int8 pages differ by more than one level")
            else:
                check_close(torch, f"{graph.name} {name}", got, want, atol=0.0, rtol=1e-4)
    return worst, worst_kv8


def layerstack_model_phase(torch, arch):
    """A reduced layer-stack LM (gemma3-1b: local and global layers, MQA;
    qwen2-moe-a2.7b: MoE FFNs; mamba2-370m: SSD mixers; zamba2-7b: Mamba2
    and shared attention blocks; deepseek-v2-lite-16b: MLA and MoE): prefill of two
    24-token prompts (past gemma3's window of 16, off mamba2's chunk of 16),
    its caches, and four decode steps on the card (the kernels) against the
    CPU (the plain path), from the same weights.  Returns the worst
    |card - CPU| (tolerance 1e-4)."""
    import numpy as np
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import LM, params_from_numpy

    card, cpu = (LM(serving_config(arch, device=d)) for d in ("cuda", "cpu"))
    p_cpu = cpu.init_params(4, device="cpu")
    p_card = params_from_numpy(p_cpu, "cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cpu.cfg.vocab, (2, 28))
                            .astype(np.int32))
    runs = []
    for model, params, dev in ((card, p_card, "cuda"), (cpu, p_cpu, "cpu")):
        t = toks.to(dev)
        lg, caches, lengths = model.prefill(params, {"tokens": t[:, :24]}, cache_cap=40)
        outs = [lg] + _leaves(caches)
        for i in range(24, 28):
            lg, caches = model.decode_step(params, t[:, i], caches, lengths)
            lengths = lengths + 1
            outs.append(lg)
        runs.append(outs + _leaves(caches))
    return max(check_close(torch, f"{arch} layer-stack LM card vs CPU", got.cpu(), want,
                           atol=1e-4, rtol=1e-4) for got, want in zip(*runs))


def encdec_model_phase(torch):
    """The reduced seamless-m4t-medium encoder-decoder: two sources of 30
    frames, prefill of two 12-token prompts, its self- and cross-attention
    caches, and four decode steps on the card (the kernels) against the CPU
    (the plain path), from the same weights.  Returns the worst |card -
    CPU| (tolerance 1e-4)."""
    import numpy as np
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.lm import params_from_numpy

    card, cpu = (EncDec(serving_config("seamless-m4t-medium", device=d)) for d in ("cuda", "cpu"))
    p_cpu = cpu.init_params(4, device="cpu")
    p_card = params_from_numpy(p_cpu, "cuda")
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.standard_normal((2, 30, cpu.cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cpu.cfg.vocab, (2, 16)).astype(np.int32))
    runs = []
    for model, params, dev in ((card, p_card, "cuda"), (cpu, p_cpu, "cpu")):
        t = toks.to(dev)
        lg, caches, lengths = model.prefill(params, {"src_embeds": src.to(dev),
                                                     "tokens": t[:, :12]}, cache_cap=20)
        enc_lengths = torch.full((2,), 30, dtype=torch.int32, device=dev)
        outs = [lg] + _leaves(caches)
        for i in range(12, 16):
            lg, caches = model.decode_step(params, t[:, i], caches, lengths, enc_lengths)
            lengths = lengths + 1
            outs.append(lg)
        runs.append(outs + _leaves(caches))
    return max(check_close(torch, "seamless-m4t-medium EncDec card vs CPU", got.cpu(), want,
                           atol=1e-4, rtol=1e-4) for got, want in zip(*runs))


# --------------------------------------------------------------------------- #
# phase 5: serving at full width
# --------------------------------------------------------------------------- #

def serving_phase(torch, K, cfg, params, n_slots, chunk, cache_cap, n_requests, max_new):
    """Returns the launches, the serving numbers, each request's prompt
    with the reference's tokens (phases 6 and 7 serve the same prompts) and
    the engine (phase 17 streams the requests again through it)."""
    import numpy as np
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    t0 = time.perf_counter()
    n_params = sum(p.numel() for p in params.values())
    engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                         cache_cap=cache_cap, params=params,
                                         device="cuda")
    torch.cuda.synchronize()
    say(f"  weights {n_params / 1e9:.3f} B params ({4 * n_params / 1e9:.2f} GB fp32), "
        f"engine built in {time.perf_counter() - t0:.1f} s")
    summary = engine.stepper.backend_summary()
    for phase, op in (("prefill", "dense"), ("prefill", "rmsnorm"),
                      ("prefill", "chunk_attention"), ("decode", "dense"),
                      ("decode", "rmsnorm"), ("decode", "decode_attention")):
        if set(summary[phase][op]) != {"cuda"}:
            fail(f"{phase} {op} assigned {summary[phase][op]}, expected cuda only")
    say(f"  step assignment: {json.dumps(summary, sort_keys=True)}")

    rng = np.random.default_rng(0)
    reqs = [EngineRequest(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(128, 701)))
                          .astype(np.int32), max_new_tokens=max_new)
            for i in range(n_requests)]
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    for r in reqs:
        if not engine.submit(r):
            fail(f"request {r.uid} rejected: {r.dropped}")
    t_run = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    say(f"  engine: {len(reqs)} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"{m.tokens_out} tokens in {t_run:.2f} s; {m.prefill_ticks} prefill + "
        f"{m.decode_ticks} decode ticks")
    say(f"  launches during the engine run: {launches}")
    for name, n in launches.items():
        if (n == 0) != (name not in ("gemm", "rmsnorm", "flash_decode", "flash_chunk_attention",
                                     "combine_partials")):
            fail(f"kernel {name}: {n} launches by the dense-cache engine")
    if launches["combine_partials"] != launches["flash_decode"]:
        fail(f"combine_partials: {launches['combine_partials']} launches, expected one per "
             f"flash_decode call ({launches['flash_decode']})")
    ticks = m.prefill_ticks + m.decode_ticks
    per_tick = {"gemm": 7 * cfg.n_layers + 1, "rmsnorm": 2 * cfg.n_layers + 1}
    for name, n in per_tick.items():
        if launches[name] != n * ticks:
            fail(f"{name}: {launches[name]} launches, expected {n} x {ticks} ticks")
    if launches["flash_decode"] != cfg.n_layers * m.decode_ticks or \
            launches["flash_chunk_attention"] != cfg.n_layers * m.prefill_ticks:
        fail(f"attention launches {launches} do not match the tick counts")
    peak = torch.cuda.max_memory_allocated()
    stats = {
        "tokens_per_s": m.tokens_per_s,
        "ttft_p50_s": m.summary()["ttft_s"]["p50"],
        "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
        "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
        "max_memory_allocated_gb": peak / 1e9,
        "engine_wall_s": t_run,
        "prefill_ticks": m.prefill_ticks,
        "decode_ticks": m.decode_ticks,
    }
    say(f"  serving: {json.dumps(stats)}")
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail("not every request finished with its tokens")

    t_ref = time.perf_counter()
    served = []
    for r in reqs:
        want = reference.generate(r.prompt, max_new, chunk=chunk)
        if r.out_tokens != want:
            fail(f"request {r.uid}: engine {r.out_tokens} != reference {want}")
        served.append((r.prompt, want))
    say(f"  all {len(reqs)} requests token-exact against the unbatched reference "
        f"({time.perf_counter() - t_ref:.2f} s)")
    return launches, stats, served, engine


def first_divergence(got, want):
    """Index of the first token where two streams differ, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def paged_serving_phase(torch, K, cfg, params, served, ref_cache, *, n_slots, chunk,
                        cache_cap, page, n_blocks, kv_dtype, max_new, card, spec_k=0,
                        expect=None):
    """Phases 6 and 7 (and phase 14's kv8 spec engine): the paged engine in
    two waves (see the module docstring).  ``served`` is phase 5's (prompt,
    reference tokens) list; ``ref_cache`` maps a prompt's bytes to the dense
    reference's tokens and is filled here, so phase 7 reuses phase 6's
    reference runs.  With ``spec_k`` the engine speculates and every
    request's tokens must equal ``expect`` (uid -> tokens, phase 7's).
    Returns the launches, the serving numbers, the agreement record, every
    request's tokens by uid and the two waves' (uid, prompt) lists (phase 15
    serves them again)."""
    import numpy as np
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    t0 = time.perf_counter()
    engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                         cache_cap=cache_cap, params=params, paged=True,
                                         page_size=page, n_blocks=n_blocks,
                                         kv_dtype=kv_dtype, spec_k=spec_k, device="cuda")
    st, pool = engine.stepper, engine.stepper.pool
    say(f"  {kv_dtype} pool: {n_blocks} blocks of {page} rows, "
        f"{pool.page_bytes * n_blocks / 1e9:.3f} GB ({pool.page_bytes} B per page); "
        f"engine built in {time.perf_counter() - t0:.1f} s")
    q = "_q" if kv_dtype == "int8" else ""
    summary = st.backend_summary()
    for phase, op in (("prefill", f"paged_chunk_attention{q}"),
                      ("decode", f"paged_decode_attention{q}"),
                      ("prefill", "dense"), ("decode", "dense"), ("decode", "rmsnorm")):
        if set(summary[phase][op]) != {"cuda"}:
            fail(f"{kv_dtype} {phase} {op} assigned {summary[phase][op]}, expected cuda only")
    say(f"  step assignment: {json.dumps(summary, sort_keys=True)}")

    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab, 512).astype(np.int32)      # S

    def extend(tail_len):
        return np.concatenate([shared, rng.integers(0, cfg.vocab, tail_len).astype(np.int32)])

    wave1 = [EngineRequest(uid=i, prompt=p, max_new_tokens=max_new)
             for i, (p, _) in enumerate(served)]
    a = EngineRequest(uid=len(wave1), prompt=extend(40), max_new_tokens=max_new)
    wave1.append(a)              # last: its pages are the newest cached ones
    b_prompt, c_prompt = extend(24), extend(80)
    counted = count_calls(K, st) if spec_k else None
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    t_run = time.perf_counter()
    for r in wave1:
        if not engine.submit(r):
            fail(f"{kv_dtype} request {r.uid} rejected: {r.dropped}")
    engine.run()
    # D: A's written stream (its prompt and every output but the last,
    # which is emitted and never written) plus one diverging token
    stream = np.concatenate([a.prompt, np.asarray(a.out_tokens[:-1], np.int32)])
    d_prompt = np.concatenate([stream, np.asarray([(a.out_tokens[-1] + 1) % cfg.vocab],
                                                  np.int32)])
    hits0, cow0 = pool.hit_tokens, pool.cow_count
    wave2 = [EngineRequest(uid=len(wave1) + i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate((b_prompt, c_prompt, d_prompt))]
    for r in wave2:
        if not engine.submit(r):
            fail(f"{kv_dtype} request {r.uid} rejected: {r.dropped}")
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    hits, cows = pool.hit_tokens - hits0, pool.cow_count - cow0
    pool.check_integrity()
    m = engine.metrics
    reqs = wave1 + wave2
    say(f"  engine: {len(reqs)} requests in two waves, {m.tokens_out} tokens in "
        f"{t_run:.2f} s; {m.prefill_ticks} prefill + {m.decode_ticks} decode ticks; "
        f"D = {len(stream)} written rows of A ({len(stream) % page} in a partial page) + 1")
    say(f"  pool: wave 2 prefix hits {hits} tokens, {cows} copy-on-write copies; "
        f"stats {json.dumps(pool.stats())}")
    say(f"  launches during the engine run: {launches}")
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail(f"{kv_dtype}: not every request finished with its tokens")
    need = 2 * len(shared) + len(d_prompt) - 1
    if hits < need or cows < 1:
        fail(f"{kv_dtype}: wave 2 hit {hits} tokens (need >= {need}) with {cows} copies "
             "(need >= 1)")
    L, ticks = cfg.n_layers, m.prefill_ticks + m.decode_ticks
    want = dict.fromkeys(launches, 0)
    want.update({"gemm": (7 * L + 1) * ticks, "rmsnorm": (2 * L + 1) * ticks,
                 "flash_paged_chunk_attention": L * m.prefill_ticks,
                 "flash_paged_decode": L * m.decode_ticks,
                 "combine_partials": L * m.decode_ticks})
    if counted is not None:
        check_launches(f"spec {kv_dtype}", K, st, counted, launches, L)
    elif launches != want:
        fail(f"{kv_dtype}: launches {launches} != expected {want}")
    stats = {
        "tokens_per_s": m.tokens_per_s,
        "ttft_p50_s": m.summary()["ttft_s"]["p50"],
        "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
        "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "engine_wall_s": t_run,
        "prefill_ticks": m.prefill_ticks,
        "decode_ticks": m.decode_ticks,
        "wave2_hit_tokens": hits,
        "wave2_cow_copies": cows,
    }
    if spec_k:
        stats.update(spec_stats(m))
    say(f"  serving ({kv_dtype} pages{', spec' if spec_k else ''}): {json.dumps(stats)} "
        f"[{card}]")
    tokens = {r.uid: list(r.out_tokens) for r in reqs}
    if expect is not None:
        differ = [u for u in expect if tokens[u] != expect[u]]
        if differ:
            fail(f"spec {kv_dtype}: requests {differ} differ from the non-speculative "
                 f"engine's tokens")
        say(f"  all {len(reqs)} requests' tokens bitwise equal to the non-speculative "
            f"{kv_dtype} engine's (phase 7)")

    t_ref = time.perf_counter()
    known = {p.tobytes(): toks for p, toks in served}
    known.update(ref_cache)
    agreement = {"exact": 0, "requests": len(reqs), "first_divergence": {}}
    for r in reqs:
        key = r.prompt.tobytes()
        if key not in known:
            known[key] = ref_cache[key] = reference.generate(r.prompt, max_new, chunk=chunk)
        div = first_divergence(r.out_tokens, known[key])
        if div is None:
            agreement["exact"] += 1
        else:
            agreement["first_divergence"][r.uid] = div
            if kv_dtype == "float32":
                fail(f"paged request {r.uid} (prompt {len(r.prompt)}): engine {r.out_tokens} "
                     f"!= reference {known[key]}")
    say(f"  {agreement['exact']} of {len(reqs)} requests token-exact against the dense fp32 "
        f"reference; first divergence (request: token index) "
        f"{agreement['first_divergence']} ({time.perf_counter() - t_ref:.2f} s)")
    waves = [[(r.uid, r.prompt) for r in wave] for wave in (wave1, wave2)]
    return launches, stats, agreement, tokens, waves


# --------------------------------------------------------------------------- #
# launch accounting of the int8-weight and speculative engines
# --------------------------------------------------------------------------- #

# op -> the kernels its cuda backend launches (one each per call)
OP_KERNELS = {
    "dense": ("gemm",), "rmsnorm": ("rmsnorm",),
    "decode_attention": ("flash_decode", "combine_partials"),
    "chunk_attention": ("flash_chunk_attention",),
    "verify_attention": ("flash_chunk_attention",),
    "paged_verify_attention_q": ("flash_chunk_attention",),
    "paged_chunk_attention": ("flash_paged_chunk_attention",),
    "paged_chunk_attention_q": ("flash_paged_chunk_attention",),
    "paged_verify_attention": ("flash_paged_chunk_attention",),
    "paged_decode_attention": ("flash_paged_decode", "combine_partials"),
    "paged_decode_attention_q": ("flash_paged_decode", "combine_partials"),
}
STEPPER_PROGRAMS = {"prefill": "prefill_program", "decode": "decode_program",
                    "verify": "verify_program", "draft": "draft_program",
                    "draft_prefill": "draft_prefill_program",
                    "commit_spec": "spec_commit_program"}


def program_launches(K, prog):
    """Kernel launches one call of ``prog`` makes: one per kernel of every
    node assigned ``cuda`` (OP_KERNELS)."""
    out = {kern.__name__: 0 for kern in K.KERNELS}
    for node in prog.graph.nodes:
        if prog.assignment[node.name] == "cuda":
            for name in OP_KERNELS[node.op]:
                out[name] += 1
    return out


def count_calls(K, stepper):
    """Wrap the stepper's Program-calling methods to count their calls and
    the kernel launches made inside each: (calls, launches by method)."""
    names = [n for n, attr in STEPPER_PROGRAMS.items() if hasattr(stepper, attr)]
    calls = dict.fromkeys(names, 0)
    inside = {n: {kern.__name__: 0 for kern in K.KERNELS} for n in names}
    for n in names:
        def wrapped(*args, _fn=getattr(stepper, n), _n=n):
            before = [kern.launches for kern in K.KERNELS]
            out = _fn(*args)
            calls[_n] += 1
            for kern, b in zip(K.KERNELS, before):
                inside[_n][kern.__name__] += kern.launches - b
            return out
        setattr(stepper, n, wrapped)
    return calls, inside


def check_launches(tag, K, stepper, counted, launches, n_layers):
    """Every Program call launched exactly its graph's kernels, and all the
    run's launches happened inside those calls; the verify calls launch the
    verify rows (the chunk kernels once per layer; the decode-unrolled
    verify of int8 pages or int8 weights its decode kernel (SPEC_K + 1) x
    n_layers times)."""
    calls, inside = counted
    total = {kern.__name__: 0 for kern in K.KERNELS}
    for n, c in calls.items():
        per_call = program_launches(K, getattr(stepper, STEPPER_PROGRAMS[n]))
        want = {k: v * c for k, v in per_call.items()}
        if inside[n] != want:
            fail(f"{tag}: {n} x {c} launched {inside[n]}, its graph needs {want}")
        for k, v in inside[n].items():
            total[k] += v
    if total != launches:
        fail(f"{tag}: launches {launches} outside the Program calls ({total} inside)")
    v = calls.get("verify", 0)
    if getattr(stepper, "spec_k", 0):
        vops = {node.op for node in stepper.verify_program.graph.nodes}
        attn, stages = next((OP_KERNELS[op][0], n) for op, n in (
            ("verify_attention", 1), ("paged_verify_attention", 1),
            ("decode_attention", SPEC_K + 1), ("paged_decode_attention", SPEC_K + 1),
            ("paged_decode_attention_q", SPEC_K + 1)) if op in vops)
        per = n_layers * stages
        if v == 0 or inside["verify"][attn] != per * v:
            fail(f"{tag}: {v} verify calls launched {attn} {inside['verify'][attn]} times, "
                 f"expected {per} per call")
    say(f"  calls {json.dumps(calls)}; launches inside verify {json.dumps(inside.get('verify'))}")


def spec_stats(m):
    return {"spec_ticks": m.spec_ticks, "proposed": m.spec_proposed,
            "accepted": m.spec_accepted, "accept_rate": m.accept_rate,
            "ms_per_emitted_token": 1e3 * m.decode_wall_s / max(m.decode_tokens, 1)}


def weight_split(params, prog):
    """(fp32 bytes of the weights the int8 Program quantized, their int8
    bytes with the fp32 scales, fp32 bytes of every weight, bytes of the
    int8 Program's weights)."""
    from repro_torch.tools.report import weight_bytes
    fp32_q = int8_q = 0
    for node in prog.graph.nodes:
        if node.op.endswith("_q"):
            w = prog.graph.params[node.inputs[1]]
            fp32_q += 4 * w.numel()
            int8_q += w.numel() + 4 * node.attrs["w_scale"].numel()
    return fp32_q, int8_q, sum(4 * p.numel() for p in params.values()), weight_bytes(prog)


# --------------------------------------------------------------------------- #
# phase 13: int8 weights on the dense-cache engine
# --------------------------------------------------------------------------- #

def int8w_phase(torch, K, cfg, params, served, *, n_slots, chunk, cache_cap, max_new, card):
    """Phase 13: phase 5's model, weights and requests served by
    build_lm_serving(quantize="int8"); every request token-exact against
    the quantized UnbatchedReference (same shared calibration); agreement
    with phase 5's fp32 tokens reported.  Returns the launches, the numbers,
    the reference's tokens, its calibration ranges and the engine's decode
    Program (phase 17 saves it)."""
    import numpy as np
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                         cache_cap=cache_cap, params=params,
                                         quantize="int8", device="cuda")
    torch.cuda.synchronize()
    build_s, build_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    st, L = engine.stepper, cfg.n_layers
    summary = st.backend_summary()
    for phase, attn in (("prefill", "chunk_attention"), ("decode", "decode_attention")):
        ops = summary[phase]
        if "dense" in ops or ops["dense_q"] != {"ref": 7 * L + 1}:
            fail(f"int8w {phase}: dense nodes {ops.get('dense')}, dense_q {ops['dense_q']}; "
                 f"expected every one of the {7 * L + 1} dense_q on ref")
        if ops["rmsnorm"] != {"cuda": 2 * L + 1} or ops[attn] != {"cuda": L}:
            fail(f"int8w {phase}: rmsnorm {ops['rmsnorm']}, {attn} {ops[attn]}")
    fp32_q, int8_q, fp32_all, int8_all = weight_split(params, st.decode_program)
    ratio = fp32_q / int8_q
    say(f"  engine built in {build_s:.1f} s (shared calibration included; peak "
        f"{build_gb:.2f} GB); quantized weights {fp32_q / 1e9:.3f} GB fp32 -> "
        f"{int8_q / 1e9:.3f} GB int8 + scales, ratio {ratio:.3f}; the whole Program "
        f"{fp32_all / 1e9:.3f} -> {int8_all / 1e9:.3f} GB ({fp32_all / int8_all:.3f}x: the "
        f"embedding table stays fp32, as in JAX)")
    if ratio < 3.9:
        fail(f"int8w: weight-bytes ratio {ratio:.3f} < 3.9")
    counted = count_calls(K, st)
    reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=max_new)
            for i, (p, _) in enumerate(served)]
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    t_run = time.perf_counter()
    for r in reqs:
        if not engine.submit(r):
            fail(f"int8w request {r.uid} rejected: {r.dropped}")
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    say(f"  engine: {len(reqs)} requests, {m.tokens_out} tokens in {t_run:.2f} s; "
        f"{m.prefill_ticks} prefill + {m.decode_ticks} decode ticks; launches {launches}")
    check_launches("int8w", K, st, counted, launches, L)
    if launches["gemm"] != 0 or launches["rmsnorm"] == 0:
        fail(f"int8w: launches {launches}")
    engine.sched.check_conservation()
    stats = {
        "tokens_per_s": m.tokens_per_s,
        "ttft_p50_s": m.summary()["ttft_s"]["p50"],
        "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
        "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "build_max_memory_allocated_gb": build_gb,
        "engine_wall_s": t_run,
        "quantized_weight_bytes_fp32": fp32_q, "quantized_weight_bytes_int8": int8_q,
        "weight_bytes_ratio": ratio, "program_weight_bytes_fp32": fp32_all,
        "program_weight_bytes_int8": int8_all,
    }
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail("int8w: not every request finished with its tokens")
    t_ref = time.perf_counter()
    qtokens, same_fp32 = {}, 0
    for r, (prompt, fp32_tokens) in zip(reqs, served):
        want = reference.generate(prompt, max_new, chunk=chunk)
        if r.out_tokens != want:
            fail(f"int8w request {r.uid}: engine {r.out_tokens} != quantized reference {want}")
        qtokens[prompt.tobytes()] = want
        same_fp32 += first_divergence(want, fp32_tokens) is None
    stats["same_as_fp32"] = same_fp32
    say(f"  serving (int8 weights): {json.dumps(stats)} [{card}]")
    say(f"  all {len(reqs)} requests token-exact against the quantized unbatched reference "
        f"({time.perf_counter() - t_ref:.2f} s); {same_fp32} of {len(reqs)} equal phase 5's "
        f"fp32 tokens (reported, not asserted: int8 weights are lossy)")
    return launches, stats, qtokens, reference._ranges, st.decode_program


# --------------------------------------------------------------------------- #
# phase 17: deploy — OXF bundles and the asyncio front end
# --------------------------------------------------------------------------- #

GOLDEN = ROOT / "tests" / "golden" / "tiny_int8"
DEPLOY_LAYERS = 2              # 17a's depth: each phi3-mini layer adds 0.45 GB to an fp32 bundle
GREEDY_TOKENS = 16


def kernel_counts(K):
    return {kern.__name__: kern.launches for kern in K.KERNELS}


def bundle_inputs(torch, cfg, prog, *, chunk, cache_cap, seed):
    """Seeded inputs of a dense decode (T = 1) or prefill (T = chunk)
    Program: phase 3's starts, random caches on the card."""
    import numpy as np
    t = prog.graph.inputs["tokens"].shape[1]
    b = prog.graph.inputs["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    feed = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
            "start": np.asarray(VERIFY_STARTS if t == 1 else [640, 320, 64, 0], np.int32),
            "n_new": np.asarray([1] * b if t == 1 else [chunk, chunk, chunk - 27, chunk],
                                np.int32)}
    for name in prog.graph.inputs:
        if name.startswith("cache_"):
            feed[name] = torch.randn((b, cache_cap, cfg.n_kv_heads, cfg.d_head),
                                     generator=gen, device="cuda")
    return feed


def timed_call(torch, K, prog, feed):
    """(outputs, seconds, kernel launches) of one synchronised call."""
    before = kernel_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = prog(**feed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return outs, dt, {k: v - before[k] for k, v in kernel_counts(K).items()}


def bundle_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def check_bundle(torch, K, tag, prog, path, feeds, card):
    """Save ``prog`` to ``path``, load it on the card, and hold the loaded
    Program to the original: the format's pins (``pallas`` where it ran
    ``cuda``), the same assignment, every output bitwise equal and the same
    launches per call on each feed.  Returns (loaded Program, numbers)."""
    from repro_torch.core import load_program
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.save(str(path))
    save_s = time.perf_counter() - t0
    with open(Path(path) / "model.json") as f:
        pins = {nd["name"]: nd["backend"] for nd in json.load(f)["nodes"]}
    want_pins = {n: {"cuda": "pallas", "cuda_split": "pallas_split", "torch": "xla"}.get(b, b)
                 for n, b in prog.assignment.items()}
    if pins != want_pins or ("cuda" in prog.assignment.values()
                             and "pallas" not in pins.values()):
        fail(f"deploy {tag}: model.json pins {sorted(set(pins.values()))} are not the "
             f"format's names of {sorted(set(prog.assignment.values()))}")
    t0 = time.perf_counter()
    loaded = load_program(str(path))
    load_s = time.perf_counter() - t0
    if loaded.device.type != "cuda" or loaded.assignment != prog.assignment:
        fail(f"deploy {tag}: loaded on {loaded.device} with another assignment")
    first_s = None
    for i, feed in enumerate(feeds):
        want, _, want_n = timed_call(torch, K, prog, feed)
        got, dt, got_n = timed_call(torch, K, loaded, feed)
        first_s = dt if first_s is None else first_s
        if got_n != want_n:
            fail(f"deploy {tag}: a loaded call launched {got_n}, the original {want_n}")
        for j, (a, b) in enumerate(zip(want, got)):
            if not torch.equal(a, b):
                fail(f"deploy {tag}: output {j} of call {i} differs from the original's "
                     f"(max |diff| {float((a - b).abs().max()):.3e})")
    per_call = {k: v for k, v in want_n.items() if v}
    numbers = {"bundle_bytes": bundle_bytes(path), "save_s": save_s, "load_s": load_s,
               "first_call_s": first_s, "launches_per_call": per_call}
    say(f"  {tag}: {numbers['bundle_bytes'] / 1e9:.3f} GB on disk; save {save_s:.2f} s, "
        f"load {load_s:.2f} s, first call {first_s:.3f} s; outputs bitwise the "
        f"original's, launches per call {json.dumps(per_call)} "
        f"[{card}]")
    return loaded, numbers


def greedy_pair(torch, pre, dec, prompts, *, chunk, n_tokens):
    """Greedy tokens for a batch of prompts through a prefill and a decode
    Program (every row prefilled chunk by chunk, then decoded)."""
    import numpy as np
    b = len(prompts)
    caches = {name: torch.zeros(spec.shape, dtype=torch.float32, device="cuda")
              for name, spec in pre.graph.inputs.items() if name.startswith("cache_")}

    def call(prog, tokens, start, n_new):
        outs = prog(tokens=tokens, start=start, n_new=n_new, **caches)
        for name, arr in zip(prog.graph.outputs[1:], outs[1:]):
            caches[name.replace("new_", "")] = arr
        return outs[0].cpu().numpy()

    lens = np.asarray([len(p) for p in prompts])
    last = [None] * b
    for pos in range(0, int(lens.max()), chunk):
        n = np.clip(lens - pos, 0, chunk).astype(np.int32)
        toks = np.zeros((b, chunk), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :n[i]] = p[pos:pos + n[i]]
        logits = call(pre, toks, np.full(b, pos, np.int32), n)
        for i in range(b):
            if n[i]:
                last[i] = logits[i, n[i] - 1]
    out = [[int(np.argmax(row))] for row in last]
    length = lens.astype(np.int32)
    while len(out[0]) < n_tokens:
        logits = call(dec, np.asarray([[o[-1]] for o in out], np.int32), length,
                      np.ones(b, np.int32))
        length = length + 1
        for i in range(b):
            out[i].append(int(np.argmax(logits[i])))
    return out


def deploy_phase(torch, K, cfg, params, engine, served, serve_stats, *, n_slots, chunk,
                 cache_cap, max_new, card):
    """Phase 17, run right after phase 5 on its weights and engine: 17a the
    fp32 decode and prefill Programs at DEPLOY_LAYERS layers through
    bundles, 17c the golden bundle on the card, 17d phase 5's engine
    through AsyncEngine and ``launch.serve --engine --int8``.  Returns the
    launches of the phase and its numbers."""
    import asyncio
    import dataclasses
    import numpy as np
    from repro_torch.core import FixedPolicy, compile, load_program
    from repro_torch.models.graph_lm import build_decode_graph, build_prefill_graph
    from repro_torch.runtime.engine import AsyncEngine

    record = {}
    for kern in K.KERNELS:
        kern.launches = 0
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="bundles-") as tmp:
        tmp = Path(tmp)
        # 17a. fp32 at phi3-mini width, DEPLOY_LAYERS layers, phase 5's weights
        cfg2 = dataclasses.replace(cfg, n_layers=DEPLOY_LAYERS)
        keep = {f"l{i}." for i in range(DEPLOY_LAYERS)}
        params2 = {k: v for k, v in params.items()
                   if "." not in k or k[:k.index(".") + 1] in keep}
        progs = {"decode": compile(build_decode_graph(cfg2, params2, batch=n_slots,
                                                      cache_cap=cache_cap),
                                   FixedPolicy(), device="cuda"),
                 "prefill": compile(build_prefill_graph(cfg2, params2, batch=n_slots,
                                                        chunk=chunk, cache_cap=cache_cap),
                                    FixedPolicy(), device="cuda")}
        loaded = {}
        for kind, prog in progs.items():
            feeds = [bundle_inputs(torch, cfg2, prog, chunk=chunk, cache_cap=cache_cap,
                                   seed=seed) for seed in (17, 18)]
            loaded[kind], record[f"fp32 {kind}"] = check_bundle(
                torch, K, f"17a fp32 {kind} ({DEPLOY_LAYERS} layers)", prog, tmp / kind,
                feeds, card)
            del feeds
        rng = np.random.default_rng(17)
        prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                   for n in rng.integers(17, 300, n_slots)]
        want = greedy_pair(torch, progs["prefill"], progs["decode"], prompts, chunk=chunk,
                           n_tokens=GREEDY_TOKENS)
        got = greedy_pair(torch, loaded["prefill"], loaded["decode"], prompts, chunk=chunk,
                          n_tokens=GREEDY_TOKENS)
        if got != want:
            fail(f"deploy 17a: greedy tokens of the loaded pair {got} != the originals' {want}")
        say(f"  17a: {GREEDY_TOKENS} greedy tokens of {n_slots} prompts (lengths "
            f"{[len(p) for p in prompts]}) through the loaded prefill + decode pair equal "
            f"the originals'")
        del progs, loaded
        release(torch)

        # 17c. the golden bundle on the card
        golden = load_program(str(GOLDEN))
        if set(golden.assignment.values()) != {"torch"}:
            fail(f"deploy 17c: golden assignment {golden.assignment}, expected torch")
        y = golden(x=np.load(GOLDEN / "input_x.npy"))[0]
        expected = np.load(GOLDEN / "expected_y.npy")
        err = float(np.abs(y.cpu().numpy() - expected).max())
        if not (y.is_cuda and np.allclose(y.cpu().numpy(), expected, rtol=1e-5, atol=1e-6)):
            fail(f"deploy 17c: golden output max |err| {err:.3e} (rtol 1e-5, atol 1e-6)")
        golden.save(str(tmp / "golden"))
        for name in ("model.json", "program.json"):
            if (tmp / "golden" / name).read_bytes() != (GOLDEN / name).read_bytes():
                fail(f"deploy 17c: the re-saved {name} differs from the golden file")
        say(f"  17c: tests/golden/tiny_int8 on the card (xla pins -> torch): expected_y "
            f"within rtol 1e-5, atol 1e-6 (max |err| {err:.3e}); model.json and "
            f"program.json re-saved byte-identical")
        record["golden_max_abs_err"] = err

    # 17d. phase 5's engine through AsyncEngine
    engine.reset_metrics()
    aeng = AsyncEngine(engine)

    async def collect(prompt):
        return [tok async for tok in aeng.generate(prompt, max_new)]

    async def stream_all():
        return await asyncio.gather(*[collect(p) for p, _ in served], aeng.run())

    t0 = time.perf_counter()
    streams = asyncio.run(stream_all())[:-1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, (stream, (_, want_tokens)) in enumerate(zip(streams, served)):
        if stream != want_tokens:
            fail(f"deploy 17d: stream {i} {stream} != phase 5's {want_tokens}")
    m = engine.metrics
    ticks = (m.prefill_ticks, m.decode_ticks)
    if ticks != (serve_stats["prefill_ticks"], serve_stats["decode_ticks"]):
        fail(f"deploy 17d: {ticks} prefill + decode ticks, phase 5 ran "
             f"{(serve_stats['prefill_ticks'], serve_stats['decode_ticks'])}")
    engine.sched.check_conservation()
    n_tok = sum(len(st) for st in streams)
    # tokens_per_s is EngineMetrics' (first tick to last), as phase 5's
    record["async"] = {"tokens": n_tok, "tokens_per_s": m.tokens_per_s,
                       "phase5_tokens_per_s": serve_stats["tokens_per_s"],
                       "wall_s": wall, "wall_tokens_per_s": n_tok / wall,
                       "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
                       "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
                       "prefill_ticks": ticks[0], "decode_ticks": ticks[1]}
    say(f"  17d: {len(streams)} AsyncEngine streams of {max_new} tokens equal phase 5's, "
        f"{ticks[0]} prefill + {ticks[1]} decode ticks as phase 5; {m.tokens_per_s:.2f} "
        f"tokens/s (phase 5 {serve_stats['tokens_per_s']:.2f}), decode "
        f"{record['async']['decode_ms_per_tick']:.2f} / prefill "
        f"{record['async']['prefill_ms_per_tick']:.2f} ms a tick (phase 5 "
        f"{serve_stats['decode_ms_per_tick']:.2f} / {serve_stats['prefill_ms_per_tick']:.2f}); "
        f"{n_tok / wall:.2f} tokens/s over asyncio.run's wall [{card}]")

    # 17d. launch.serve --engine --int8 at its defaults, in-process
    from repro_torch.launch import serve
    argv = sys.argv
    sys.argv = ["repro_torch.launch.serve", "--engine", "--int8"]
    try:
        t0 = time.perf_counter()
        serve.main()
        record["serve_int8_s"] = time.perf_counter() - t0
    finally:
        sys.argv = argv
    say(f"  17d: launch.serve --engine --int8 on the card took {record['serve_int8_s']:.2f} s "
        f"[{card}]")
    launches = kernel_counts(K)
    say(f"  launches during phase 17 (a, c, d): {launches}")
    for name in ("gemm", "rmsnorm", "flash_decode", "flash_chunk_attention", "combine_partials"):
        if launches[name] == 0:
            fail(f"deploy: kernel {name} launched no time in phase 17 (a, c, d)")
    return launches, record


def deploy_int8_phase(torch, K, cfg, fp32_decode, int8_decode, *, chunk, cache_cap, card):
    """Phase 17b, run right after phase 13: its int8-weight decode Program
    (every layer phase 13 serves) through a bundle, and footprint_table of phase 5's fp32
    decode Program beside it.  Returns the launches and the numbers."""
    from repro_torch.tools.report import footprint_table, weight_bytes

    record = {}
    for kern in K.KERNELS:
        kern.launches = 0
    say(f"  17b: phase 13's int8-weight decode Program, {cfg.n_layers} layers, "
        f"weight_bytes {weight_bytes(int8_decode)} ({weight_bytes(int8_decode) / 1e9:.3f} "
        f"GB; phase 5's fp32 decode Program {weight_bytes(fp32_decode) / 1e9:.3f} GB) "
        f"[{card}]")
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="bundles-") as tmp:
        feeds = [bundle_inputs(torch, cfg, int8_decode, chunk=chunk, cache_cap=cache_cap,
                               seed=19)]
        loaded, record["int8 decode"] = check_bundle(
            torch, K, f"17b int8 decode ({cfg.n_layers} layers)", int8_decode,
            Path(tmp) / "int8", feeds, card)
        with open(Path(tmp) / "int8" / "program.json") as f:
            if json.load(f)["quantized"] is not True:
                fail("deploy 17b: program.json of the int8 bundle does not say quantized")
        del feeds, loaded
    table = footprint_table([("phase 5 fp32 decode", fp32_decode),
                             ("phase 13 int8 decode", int8_decode)])
    say("  17b footprint_table:")
    for line in table.splitlines():
        say(f"    {line}")
    record["footprint_table"] = table
    launches = kernel_counts(K)
    say(f"  launches during phase 17b: {launches}")
    for name in ("rmsnorm", "flash_decode", "combine_partials"):
        if launches[name] == 0:
            fail(f"deploy: kernel {name} launched no time in phase 17b")
    return launches, record


# --------------------------------------------------------------------------- #
# phase 14: speculative decoding on the dense, paged fp32, kv8 and int8 engines
# --------------------------------------------------------------------------- #

def verify_vs_decode(torch, st, prompts, chunk):
    """The dense stepper's verify logits against its decode logits at the
    same positions: slot 0 prefills a prompt, decodes SPEC_K + 1 greedy
    tokens, then verifies those tokens from the same start.  Returns the max
    |verify - decode| logit and the decode top-2 gap at every position whose
    argmax differs."""
    import numpy as np
    b, w = st.n_slots, SPEC_K + 1
    worst, gaps = 0.0, []
    for prompt in prompts:
        pos, logits = 0, None
        while pos < len(prompt):
            n = min(chunk, len(prompt) - pos)
            toks = np.zeros((b, chunk), np.int32)
            toks[0, :n] = prompt[pos:pos + n]
            logits = st.prefill(toks, np.asarray([pos] + [0] * (b - 1), np.int32),
                                np.asarray([n] + [0] * (b - 1), np.int32))
            pos += n
        fed, dec = [int(np.argmax(logits[0, n - 1]))], []
        for i in range(w):
            toks = np.zeros((b, 1), np.int32)
            toks[0, 0] = fed[-1]
            lg = st.decode(toks, np.asarray([len(prompt) + i] + [0] * (b - 1), np.int32),
                           np.asarray([1] + [0] * (b - 1), np.int32))
            dec.append(lg[0])
            fed.append(int(np.argmax(lg[0])))
        vt = np.zeros((b, w), np.int32)
        vt[0] = fed[:w]
        ver = st.verify(vt, np.asarray([len(prompt)] + [0] * (b - 1), np.int32),
                        np.asarray([w] + [0] * (b - 1), np.int32))[0]
        for i in range(w):
            worst = max(worst, float(np.abs(ver[i] - dec[i]).max()))
            if int(np.argmax(ver[i])) != int(np.argmax(dec[i])):
                top = np.sort(dec[i])[-2:]
                gaps.append(float(top[1] - top[0]))
    return worst, gaps


def spec_engine_run(torch, K, tag, engine, reference, prompts, want, *, chunk, max_new, card):
    """Serve ``prompts`` on a speculative engine: every request's tokens
    equal ``want`` (the reference's, by prompt bytes; generated here when
    missing), launches exactly as its graphs need, conservation (and pool
    integrity).  Returns (launches, stats)."""
    from repro_torch.runtime.engine import EngineRequest
    st = engine.stepper
    counted = count_calls(K, st)
    reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    t_run = time.perf_counter()
    for r in reqs:
        if not engine.submit(r):
            fail(f"{tag} request {r.uid} rejected: {r.dropped}")
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    check_launches(tag, K, st, counted, launches, engine.stepper.cfg.n_layers)
    engine.sched.check_conservation()
    if engine.paged:
        engine.stepper.pool.check_integrity()
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail(f"{tag}: not every request finished with its tokens")
    for r in reqs:
        key = r.prompt.tobytes()
        if key not in want:
            want[key] = reference.generate(r.prompt, max_new, chunk=chunk)
        if r.out_tokens != want[key]:
            fail(f"{tag} request {r.uid}: engine {r.out_tokens} != reference {want[key]} "
                 f"(first divergence {first_divergence(r.out_tokens, want[key])})")
    stats = {"tokens_per_s": m.tokens_per_s, "engine_wall_s": t_run,
             "prefill_ticks": m.prefill_ticks, "decode_ticks": m.decode_ticks,
             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             **spec_stats(m)}
    say(f"  {tag}: {len(reqs)} requests, {m.tokens_out} tokens in {t_run:.2f} s, all "
        f"token-exact against the unbatched reference; {json.dumps(stats)}  [{card}]")
    return launches, stats


def spec_phase(torch, K, cfg, params, served, qtokens, q_ranges, *, n_slots, chunk,
               cache_cap, max_new, card):
    """Phase 14, the dense-cache and paged fp32 engines and the int8-weight
    dense engine with SPEC_K = 3 and the default draft (the first half of
    the layers), each token-exact against its UnbatchedReference (phase 5's
    and phase 13's tokens).  The kv8 engine runs in paged_serving_phase.
    Returns {path: (launches, stats)} and the verify-vs-decode record."""
    from repro_torch.runtime.engine import build_lm_serving
    prompts = [p for p, _ in served]
    fp32_want = {p.tobytes(): toks for p, toks in served}
    runs, record = {}, {}
    for tag, kw in (("spec dense", {}), ("spec paged fp32", dict(paged=True, page_size=16)),
                    ("spec int8w", dict(quantize="int8"))):
        t0 = time.perf_counter()
        engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                             cache_cap=cache_cap, params=params,
                                             spec_k=SPEC_K, device="cuda", **kw)
        st = engine.stepper
        say(f"  [{tag}] built in {time.perf_counter() - t0:.1f} s: draft {st.draft_layers} of "
            f"{cfg.n_layers} layers, draft caches {st.draft_cap} rows; verify assignment "
            f"{json.dumps(st.backend_summary()['verify'], sort_keys=True)}")
        want = fp32_want
        if kw.get("quantize"):
            same = reference._ranges == q_ranges
            say(f"  [{tag}] shared calibration {'equal to' if same else 'DIFFERENT from'} "
                f"phase 13's: {'its' if same else 'a new'} reference's tokens")
            want = dict(qtokens) if same else {}
        runs[tag] = spec_engine_run(torch, K, tag, engine, reference, prompts, want,
                                    chunk=chunk, max_new=max_new, card=card)
        if tag == "spec dense":
            worst, gaps = verify_vs_decode(torch, st, prompts[:2], chunk)
            record = {"max_abs_verify_minus_decode_logit": worst, "argmax_flips": len(gaps),
                      "top2_gaps_at_flips": gaps}
            say(f"  verify vs decode logits at {2 * (SPEC_K + 1)} positions: max |diff| "
                f"{worst:.3e}; argmax differs at {len(gaps)} (decode top-2 gaps {gaps})")
        del engine, reference, st
        release(torch)
    return runs, record


# --------------------------------------------------------------------------- #
# phase 12, continued: the int8 CNN builds
# --------------------------------------------------------------------------- #

def cnn_int8_phase(torch, card):
    """cnn_eval --int8 on the card: each CNN's fp32 and int8 Programs under
    the library assignment (torch, ref); the int8 output within
    JAX_INT8_MAX_ABS_ERR x INT8_ERR_MARGIN of the fp32 one, weights at
    least 3.9x smaller.  Returns the rows."""
    from repro_torch.launch import cnn_eval
    from repro_torch.models.cnn import CNN_MODELS
    # each model alone, as JAX_INT8_MAX_ABS_ERR was taken: its input is
    # the first draw of seed 0
    rows = [cnn_eval.run_quant([name], reps=5, device="cuda")[0] for name in CNN_MODELS]
    for r in rows:
        bound_err = JAX_INT8_MAX_ABS_ERR[r["model"]] * INT8_ERR_MARGIN
        say(f"  {r['model']}: fp32 {1e3 * r['fp32_s']:.3f} ms, int8 {1e3 * r['int8_s']:.3f} ms; "
            f"weights {r['fp32_weight_bytes']} -> {r['int8_weight_bytes']} B "
            f"({r['bytes_ratio']:.3f}x); max |int8 - fp32| {r['max_abs_err']:.4g} (JAX "
            f"run_quant {JAX_INT8_MAX_ABS_ERR[r['model']]:.4g})  [{card}]")
        if not r["max_abs_err"] <= bound_err:
            fail(f"{r['model']} int8: max abs error {r['max_abs_err']:.4g} > {bound_err:.4g}")
        if r["bytes_ratio"] < 3.9:
            fail(f"{r['model']} int8: weight-bytes ratio {r['bytes_ratio']:.3f} < 3.9")
    return rows


# --------------------------------------------------------------------------- #
# phase 15: self-healing under injected faults
# --------------------------------------------------------------------------- #

HEAL_SEED = 15            # fixes each heal engine's fault calls (printed)


def plan_faults(rng, score_phase):
    """Three faults — a Python exception ("crash"), a real CUDA out-of-memory
    error ("oom") and a device-side overrun ("hang") — at (method, call
    index) pairs: at least one prefill call and one ``score_phase`` call
    (decode, or verify for a spec engine)."""
    phases = ["prefill", score_phase, str(rng.choice(["prefill", score_phase]))]
    rng.shuffle(phases)
    faults = {}
    for kind, phase in zip(("crash", "oom", "hang"), phases):
        at = (phase, int(rng.integers(2, 13 if phase == "prefill" else 41)))
        while at in faults:
            at = (phase, at[1] + 1)
        faults[at] = kind
    return faults


def sleep_cycles_per_s(torch):
    """Device clock cycles ``torch.cuda._sleep`` spins per second (CUDA
    events over one 50M-cycle spin)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / (start.elapsed_time(end) / 1e3)


def inject_faults(torch, engine, faults, hang_cycles, capture):
    """Wrap the stepper's methods (outside count_calls' wrappers) so the
    planned calls fail: "crash" raises after the call's work, "oom"
    allocates more than the card has free after it, "hang" queues a device
    spin before the call so its host read waits past the deadline.  Every
    decode / verify call's logits at each active slot's scored position go
    to ``capture["scored"]`` ((uid, position) -> logits) and every prefill
    that ends a resumed decoding request's stream to ``capture["resumed"]``,
    so the resumed chunk-kernel logits can be held against the decode
    kernel's.  Returns the calls by method."""
    import numpy as np
    st, calls = engine.stepper, {}
    for name in {p for p, _ in faults} | {"prefill"}:
        calls[name] = 0

        def wrapped(*args, _fn=getattr(st, name), _name=name):
            calls[_name] += 1
            kind = faults.get((_name, calls[_name]))
            live = [(s, x) for s, x in enumerate(engine.slots) if x is not None]
            if kind == "hang":
                torch.cuda._sleep(hang_cycles)
            out = _fn(*args)
            tokens, start, n_new = args
            for s, x in live:
                if _name == "prefill" and x.stream is not None and x.req.out_tokens \
                        and start[s] + n_new[s] == len(x.stream):
                    capture["resumed"][(x.req.uid, int(start[s] + n_new[s] - 1))] = \
                        np.array(out[s, n_new[s] - 1])
                elif _name in ("decode", "verify") and n_new[s] > 0:
                    capture["scored"][(x.req.uid, int(start[s]))] = \
                        np.array(out[s] if _name == "decode" else out[s, 0])
            if kind == "crash":
                raise RuntimeError(f"injected fault at {_name} call {calls[_name]}")
            if kind == "oom":
                free, total = torch.cuda.mem_get_info()
                torch.empty(total, dtype=torch.uint8, device=st.device)   # > free: raises
            return out
        setattr(st, name, wrapped)
    return calls


def heal_engine_run(torch, K, tag, engine, waves, want, faults, cycles_per_s, uninterrupted,
                    card):
    """One phase-15 engine (built with self_heal, a coordinator attached):
    warm it with one request, derive the hang deadline from its slowest
    call, rebuild the Engine on the warm stepper with that deadline, inject
    ``faults`` and serve ``waves`` (lists of (uid, prompt)), holding every
    hard gate of the module docstring.  Returns (launches, stats)."""
    import numpy as np
    from repro_torch.ft.coordinator import Coordinator
    from repro_torch.runtime.engine import Engine, EngineRequest
    st = engine.stepper
    names = [n for n, attr in STEPPER_PROGRAMS.items() if hasattr(st, attr)]
    slowest = [0.0]
    for n in names:                          # time every call of the warm-up
        def timed(*args, _fn=getattr(st, n)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*args)
            torch.cuda.synchronize()
            slowest[0] = max(slowest[0], time.perf_counter() - t)
            return out
        setattr(st, n, timed)
    warm_prompt = np.random.default_rng(99).integers(0, st.cfg.vocab, 100).astype(np.int32)
    warm = EngineRequest(uid=-1, prompt=warm_prompt, max_new_tokens=6)
    engine.submit(warm)
    engine.run()
    for n in names:
        delattr(st, n)
    if not warm.done:
        fail(f"{tag}: warm-up request did not finish")
    hang_timeout = 4 * slowest[0] + 1.0
    hang_cycles = int(cycles_per_s * (1.25 * hang_timeout + 0.25))
    coord = Coordinator(deadline=3600.0)
    engine = Engine(st, self_heal=True, hang_timeout=hang_timeout, coordinator=coord,
                    host_id=tag)
    gen0 = coord.generation
    counted = count_calls(K, st)
    capture = {"scored": {}, "resumed": {}}
    calls = inject_faults(torch, engine, faults, hang_cycles, capture)
    t_fail, to_next = [], []          # failures not yet followed by a good tick
    recover, step = engine._recover, engine.step

    def recover_checked(ckpt, failure):
        t_fail.append(time.perf_counter())
        recover(ckpt, failure)
        if engine.paged:
            st.pool.check_integrity()

    def step_timed():
        ticks = engine.metrics.prefill_ticks + engine.metrics.decode_ticks
        n_rec = engine.metrics.n_recoveries
        step()
        done = engine.metrics.prefill_ticks + engine.metrics.decode_ticks > ticks
        if done and engine.metrics.n_recoveries == n_rec:
            now = time.perf_counter()
            to_next.extend(1e3 * (now - t) for t in t_fail)
            t_fail.clear()

    engine._recover, engine.step = recover_checked, step_timed
    for kern in K.KERNELS:
        kern.launches = 0
    reqs, streams = [], {}
    t_run = time.perf_counter()
    for wave in waves:
        for uid, prompt in wave:
            toks = streams[uid] = []
            r = EngineRequest(uid=uid, prompt=prompt, max_new_tokens=len(want[uid]),
                              on_token=lambda _r, t, toks=toks: toks.append(t))
            if not engine.submit(r):
                fail(f"{tag} request {uid} rejected: {r.dropped}")
            reqs.append(r)
        engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    check_launches(tag, K, st, counted, launches, st.cfg.n_layers)
    engine.sched.check_conservation()
    for r in reqs:
        if not r.done or r.dropped is not None:
            fail(f"{tag} request {r.uid}: done {r.done}, dropped {r.dropped}")
        if streams[r.uid] != r.out_tokens:
            fail(f"{tag} request {r.uid}: streamed {streams[r.uid]} != {r.out_tokens}")
        if r.out_tokens != want[r.uid]:
            fail(f"{tag} request {r.uid}: {r.out_tokens} != the uninterrupted run's "
                 f"{want[r.uid]} (first divergence "
                 f"{first_divergence(r.out_tokens, want[r.uid])})")
    kinds = list(faults.values())
    expect = (kinds.count("crash") + kinds.count("oom"), kinds.count("hang"), len(faults))
    got = (m.n_crash_failures, m.n_hang_failures, m.n_recoveries)
    if got != expect or m.failed_ticks != len(faults):
        fail(f"{tag}: crash / hang / recoveries {got}, failed ticks {m.failed_ticks}; "
             f"injected {expect}")
    if m.recovered_rows <= 0:
        fail(f"{tag}: no rows resumed from surviving state")
    if coord.generation != gen0 + m.n_recoveries:
        fail(f"{tag}: coordinator generation {gen0} -> {coord.generation} over "
             f"{m.n_recoveries} recoveries")
    if engine.paged and (st.pool.live_sequences or st.pool.stats()["reserved_blocks"]):
        fail(f"{tag}: pool leaks {st.pool.live_sequences} sequences, "
             f"{st.pool.stats()['reserved_blocks']} reserved blocks")
    if engine.paged:
        st.pool.check_integrity()
    diffs, gaps = [], []
    for key, got_logits in capture["resumed"].items():
        ref_logits = capture["scored"].get(key)
        if ref_logits is None:
            continue
        diffs.append(float(np.abs(got_logits - ref_logits).max()))
        if int(np.argmax(got_logits)) != int(np.argmax(ref_logits)):
            top = np.sort(ref_logits)[-2:]
            gaps.append(float(top[1] - top[0]))
    stats = {
        "faults": {f"{p} call {i}": k for (p, i), k in sorted(faults.items())},
        "calls": calls, "hang_timeout_s": hang_timeout, "slowest_warm_call_s": slowest[0],
        "failed_ticks": m.failed_ticks, "n_crash_failures": m.n_crash_failures,
        "n_hang_failures": m.n_hang_failures, "n_recoveries": m.n_recoveries,
        "requeued_requests": m.requeued_requests, "recovered_rows": m.recovered_rows,
        "prefill_ticks": m.prefill_ticks, "decode_ticks": m.decode_ticks,
        "extra_prefill_ticks": m.prefill_ticks - uninterrupted["prefill_ticks"],
        "ms_failure_to_next_tick": to_next, "engine_wall_s": t_run,
        "uninterrupted_wall_s": uninterrupted["engine_wall_s"],
        "coordinator_generations": coord.generation - gen0,
        "resumed_positions_compared": len(diffs),
        "max_abs_resumed_minus_scored_logit": max(diffs, default=None),
        "argmax_flips": len(gaps), "top2_gaps_at_flips": gaps,
    }
    say(f"  {tag}: {len(reqs)} requests token-exact against the uninterrupted run, streams "
        f"without duplicate or skip; {json.dumps(stats)}  [{card}]")
    return launches, stats


def heal_phase(torch, K, cfg, params, served, paged_waves, paged_tokens, uninterrupted, *,
               n_slots, chunk, cache_cap, page, pools, card):
    """Phase 15 (see the module docstring).  Returns {path: (launches, stats)}."""
    import numpy as np
    from repro_torch.runtime.engine import build_lm_serving
    rng = np.random.default_rng(HEAL_SEED)
    cycles_per_s = sleep_cycles_per_s(torch)
    say(f"  fault seed {HEAL_SEED}; torch.cuda._sleep spins {cycles_per_s:.4g} cycles a second")
    dense_waves = [[(i, p) for i, (p, _) in enumerate(served)]]
    dense_want = {i: toks for i, (_, toks) in enumerate(served)}
    runs = {}
    for tag, kw, waves, want, score in (
            ("heal dense", {}, dense_waves, dense_want, "decode"),
            ("heal paged fp32", dict(paged=True, page_size=page, n_blocks=pools["fp32"]),
             paged_waves["fp32"], paged_tokens["fp32"], "decode"),
            ("heal paged int8", dict(paged=True, page_size=page, n_blocks=pools["int8"],
                                     kv_dtype="int8"),
             paged_waves["int8"], paged_tokens["int8"], "decode"),
            ("heal spec dense", dict(spec_k=SPEC_K), dense_waves, dense_want, "verify")):
        faults = plan_faults(rng, score)
        t0 = time.perf_counter()
        engine, _ = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap,
                                     params=params, self_heal=True, device="cuda", **kw)
        say(f"  [{tag}] built in {time.perf_counter() - t0:.1f} s; faults "
            f"{json.dumps({f'{p} call {i}': k for (p, i), k in sorted(faults.items())})}")
        runs[tag] = heal_engine_run(torch, K, tag, engine, waves, want, faults, cycles_per_s,
                                    uninterrupted[tag], card)
        del engine
        release(torch)
    return runs


# --------------------------------------------------------------------------- #
# phase 16: overload, tier-blind against tier-aware
# --------------------------------------------------------------------------- #

LOAD_SEED = 3             # serve_bench's overload trace seed (its seed 0 + 3)
LOAD_SLO = (24, 12)       # (ttft_ticks, gap_ticks)


def phase16_trace_config():
    """benchmarks/serve_bench.py's overload trace at phi3-mini serving
    shapes: 48 requests offered at 2x the drain rate of 4 slots at chunk 64
    (a request costs prompt // chunk + 1 prefill and new-token decode
    ticks), prompts of 256 mean tokens, 24 mean new tokens with a fat tail,
    two tiers."""
    from repro_torch.runtime.loadgen import TierSpec, TraceConfig
    n_slots, chunk, prompt_mean, new_mean = 4, 64, 256, 24
    cost = prompt_mean // chunk + 1 + new_mean
    return TraceConfig(
        seed=LOAD_SEED, n_requests=48, vocab=32064,
        mean_interarrival_ticks=cost / (2 * n_slots), arrival="gamma", burstiness=4.0,
        prompt_len_mean=float(prompt_mean), prompt_len_sigma=0.4, prompt_len_max=768,
        new_tokens_mean=float(new_mean), new_tokens_sigma=0.8, new_tokens_max=64,
        tiers=(TierSpec("interactive", priority=1, weight=0.35, deadline_ticks=400),
               TierSpec("batch", priority=0, weight=0.65)))


def load_phase(torch, K, cfg, params, *, n_slots, chunk, cache_cap, page, card):
    """Phase 16 (see the module docstring).  Returns {path: (launches,
    stats)} and the phase's record."""
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving
    from repro_torch.runtime.kv_cache import pages_needed
    from repro_torch.runtime.loadgen import SLO, generate_trace, run_load
    tcfg = phase16_trace_config()
    trace = generate_trace(tcfg)
    slo = SLO(ttft_ticks=LOAD_SLO[0], gap_ticks=LOAD_SLO[1])
    n_blocks = (n_slots + 2 * n_slots) * pages_needed(tcfg.prompt_len_max,
                                                      tcfg.new_tokens_max, page)
    say(f"  trace seed {LOAD_SEED}, digest {trace.digest()}; {json.dumps(trace.stats()['tiers'])}"
        f", mean interarrival {tcfg.mean_interarrival_ticks} ticks; SLO ttft {slo.ttft_ticks} "
        f"/ gap {slo.gap_ticks} ticks; pool {n_blocks} blocks of {page}")
    runs, record, served, reference = {}, {"digest": trace.digest()}, {}, None
    for policy in ("tier_blind", "tier_aware"):
        aware = policy == "tier_aware"
        engine, reference = build_lm_serving(
            cfg, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap, params=params,
            paged=True, page_size=page, n_blocks=n_blocks, max_queue=2 * n_slots,
            self_heal=True, tier_aware=aware, slo_ttft_ticks=slo.ttft_ticks if aware else None,
            device="cuda")
        warm = EngineRequest(uid=-1, prompt=trace.requests[0].prompt, max_new_tokens=2)
        engine.submit(warm)
        engine.run()
        engine.reset_metrics()
        submitted, submit = [], engine.submit
        engine.submit = lambda r, _s=submit: (submitted.append(r), _s(r))[1]
        for kern in K.KERNELS:
            kern.launches = 0
        report = run_load(engine, trace, slo, tier_blind=not aware)
        torch.cuda.synchronize()
        launches = {kern.__name__: kern.launches for kern in K.KERNELS}
        m = engine.metrics
        ov = report["overall"]
        if ov["n_incomplete"] or ov["n_finished"] + ov["n_shed"] + ov["n_dropped"] != \
                ov["n_offered"]:
            fail(f"load {policy}: conservation {json.dumps(ov)}")
        if m.n_crash_failures or m.n_hang_failures:
            fail(f"load {policy}: {m.n_crash_failures} crashes, {m.n_hang_failures} hangs "
                 "(none injected)")
        engine.sched.check_conservation()
        engine.stepper.pool.check_integrity()
        served[policy] = {r.uid: r for r in submitted}
        tiers = {}
        for name, t in report["tiers"].items():
            tiers[name] = {
                "offered": t["n_offered"], "finished": t["n_finished"], "slo_met": t["n_slo_met"],
                "attainment_finished": t["slo_attainment"],
                "attainment_offered": t["n_slo_met"] / t["n_offered"] if t["n_offered"] else None,
                "goodput_requests_per_s": t["goodput_requests_per_s"],
                "goodput_tokens_per_s": t["goodput_tokens_per_s"],
                "ttft_ticks_p50": t["ttft_ticks"]["p50"], "ttft_ticks_p99": t["ttft_ticks"]["p99"],
                "ttft_s_p50": t["ttft_s"]["p50"], "ttft_s_p99": t["ttft_s"]["p99"],
                "shed": t["n_shed"], "dropped": t["n_dropped"]}
        stats = {"tiers": tiers, "n_preempted": m.n_preempted, "n_tier_shed": m.n_tier_shed,
                 "ticks": report["ticks"], "wall_s": report["wall_s"],
                 "recovered_rows": m.recovered_rows, "prefill_ticks": m.prefill_ticks,
                 "decode_ticks": m.decode_ticks,
                 "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
                 "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1)}
        say(f"  {policy}: {json.dumps(stats)}  [{card}]")
        runs[f"load {policy}"] = (launches, stats)
        record[policy] = stats
        del engine
        release(torch)
    att = {p: record[p]["tiers"]["interactive"]["attainment_offered"] or 0.0
           for p in ("tier_blind", "tier_aware")}
    record["high_tier_attainment_offered"] = att
    if not att["tier_aware"] > att["tier_blind"]:
        fail(f"load: tier-aware high-tier attainment {att['tier_aware']} is not above "
             f"tier-blind's {att['tier_blind']}")
    if record["tier_blind"]["n_preempted"] != 0 or record["tier_aware"]["n_preempted"] < 1:
        fail(f"load: preemptions blind {record['tier_blind']['n_preempted']}, aware "
             f"{record['tier_aware']['n_preempted']} (want 0 and >= 1)")
    victims = sorted(u for u, r in served["tier_aware"].items() if r.n_requeues)
    others = sorted(u for u, r in served["tier_aware"].items()
                    if r.done and not r.n_requeues)[:8]
    t_ref = time.perf_counter()
    for uid in victims + others:
        r = served["tier_aware"][uid]
        want = reference.generate(r.prompt, r.max_new_tokens, chunk=chunk)
        for policy in ("tier_blind", "tier_aware"):
            got = served[policy][uid].out_tokens
            if got != want[:len(got)] or (served[policy][uid].done and got != want):
                fail(f"load {policy} request {uid}: {got} != reference {want}")
    record["checked"] = {"victims": victims, "others": others}
    say(f"  tier-aware high-tier attainment over offered {att['tier_aware']:.4f} against "
        f"tier-blind's {att['tier_blind']:.4f}; {len(victims)} preempted victims and "
        f"{len(others)} other finished requests token-exact against the unbatched reference "
        f"in both runs ({time.perf_counter() - t_ref:.1f} s)  [{card}]")
    del reference
    release(torch)
    return runs, record


# --------------------------------------------------------------------------- #
# phase 11: split-KV decode under the selection policies
# --------------------------------------------------------------------------- #

SERVING_OPS = ("embedding", "dense", "rmsnorm", "swiglu", "cache_update", "chunk_attention",
               "decode_attention")


def _picks(prog):
    """{op: {backend: nodes}} of a Program, for the serving ops."""
    out = {}
    for node in prog.graph.nodes:
        if node.op in SERVING_OPS:
            by = out.setdefault(node.op, {})
            b = prog.assignment[node.name]
            by[b] = by.get(b, 0) + 1
    return out


def split_phase(torch, K, cfg, params, served, *, n_slots, chunk, cache_cap, max_new, card):
    """Phase 11 (see the module docstring).  Returns the launches, the
    serving numbers and a record of the agreement and the policies' picks."""
    from repro_torch.core.program import compile
    from repro_torch.core.selector import (H100_SXM, AutotunePolicy, CostModelPolicy,
                                           FixedPolicy)
    from repro_torch.runtime.engine import EngineRequest, build_lm_serving

    policy = FixedPolicy(per_op={"decode_attention": ("cuda_split", "cuda", "ref")})
    t0 = time.perf_counter()
    engine, reference = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk,
                                         cache_cap=cache_cap, params=params, policy=policy,
                                         device="cuda")
    say(f"  engine built in {time.perf_counter() - t0:.1f} s")
    summary = engine.stepper.backend_summary()
    if set(summary["decode"]["decode_attention"]) != {"cuda_split"}:
        fail(f"decode_attention assigned {summary['decode']['decode_attention']}, expected "
             "cuda_split only")
    for phase, op in (("prefill", "dense"), ("prefill", "chunk_attention"),
                      ("decode", "dense"), ("decode", "rmsnorm")):
        if set(summary[phase][op]) != {"cuda"}:
            fail(f"split: {phase} {op} assigned {summary[phase][op]}, expected cuda only")
    say(f"  step assignment: {json.dumps(summary, sort_keys=True)}")
    reqs = [EngineRequest(uid=i, prompt=prompt, max_new_tokens=max_new)
            for i, (prompt, _) in enumerate(served)]
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    for r in reqs:
        if not engine.submit(r):
            fail(f"split request {r.uid} rejected: {r.dropped}")
    t_run = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    say(f"  engine: {len(reqs)} requests, {m.tokens_out} tokens in {t_run:.2f} s; "
        f"{m.prefill_ticks} prefill + {m.decode_ticks} decode ticks")
    say(f"  launches during the engine run: {launches}")
    L, ticks = cfg.n_layers, m.prefill_ticks + m.decode_ticks
    want = dict.fromkeys(launches, 0)
    want.update({"gemm": (7 * L + 1) * ticks, "rmsnorm": (2 * L + 1) * ticks,
                 "flash_chunk_attention": L * m.prefill_ticks,
                 "flash_decode_partial": L * m.decode_ticks,
                 "combine_partials": L * m.decode_ticks})
    if launches != want:
        fail(f"split: launches {launches} != expected {want}")
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        fail("split: not every request finished with its tokens")
    stats = {
        "tokens_per_s": m.tokens_per_s,
        "ttft_p50_s": m.summary()["ttft_s"]["p50"],
        "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
        "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "engine_wall_s": t_run,
    }
    say(f"  serving (cuda_split decode): {json.dumps(stats)} [{card}]")
    t_ref = time.perf_counter()
    same_as_phase5 = 0
    for r, (prompt, phase5) in zip(reqs, served):
        ref = reference.generate(r.prompt, max_new, chunk=chunk)
        if r.out_tokens != ref:
            fail(f"split request {r.uid}: engine {r.out_tokens} != reference {ref}")
        same_as_phase5 += r.out_tokens == phase5
    say(f"  all {len(reqs)} requests token-exact against the unbatched reference under the "
        f"same policy ({time.perf_counter() - t_ref:.2f} s); {same_as_phase5} of {len(reqs)} "
        "equal phase 5's tokens (reported, not asserted: the split reorders float adds)")

    st = engine.stepper
    graphs = {"decode": st.decode_program.graph, "prefill": st.prefill_program.graph}
    record = {"same_as_phase5": same_as_phase5, "requests": len(reqs), "picks": {}}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune.json")
        tune = AutotunePolicy(reps=5, cache_path=cache, device="cuda")
        for label, pol in (("autotune", tune), ("cost_model", CostModelPolicy(H100_SXM))):
            t = time.perf_counter()
            for phase, g in graphs.items():
                prog = compile(g, policy=pol, pipeline=(), device="cuda")
                record["picks"][f"{label} {phase}"] = _picks(prog)
                if phase == "decode":
                    node = next(n for n in prog.graph.nodes if n.op == "decode_attention")
                    specs = [prog.graph.spec_of(v) for v in node.inputs]
                    if label == "autotune":
                        record["decode_attention_timings_s"] = tune.timings(node, specs)
                    else:
                        record["decode_attention_estimates_s"] = pol.estimate(node, specs)
                del prog
            say(f"  {label}: picks {json.dumps(record['picks'][f'{label} decode'])} (decode), "
                f"{json.dumps(record['picks'][f'{label} prefill'])} (prefill); compiled in "
                f"{time.perf_counter() - t:.1f} s")
        say(f"  decode_attention autotune timings (s, min of 5, lengths drawn in {{0, 1}} as "
            f"JAX's inputs): {json.dumps(record['decode_attention_timings_s'])}; cost-model "
            f"estimates (s): {json.dumps(record['decode_attention_estimates_s'])} [{card}]")
        inf = [(key, b) for key, times in tune._timings.items() for b, t in times.items()
               if b.startswith("cuda") and t == float("inf")]
        if inf:
            fail(f"autotune timed cuda backends as inf (could not run): {inf}")
        again = AutotunePolicy(reps=5, cache_path=cache, device="cuda")
        for g in graphs.values():
            compile(g, policy=again, pipeline=(), device="cuda")
        if again.n_measured != 0:
            fail(f"a second AutotunePolicy on the same cache measured {again.n_measured} "
                 "signatures")
        say(f"  autotune measured {tune.n_measured} signatures; a second policy on the same "
            f"file loaded {again.n_loaded} and measured {again.n_measured}")
        record["autotune_measured"] = tune.n_measured
    del engine, reference
    return launches, stats, record


# --------------------------------------------------------------------------- #
# phase 12: the paper's five CNNs under six assignments
# --------------------------------------------------------------------------- #

def cnn_phase(torch, K, card):
    """Phase 12 (see the module docstring).  Returns the launches over one
    forward pass of every model under every assignment, the rows {model,
    assignment: ms, winner}, and ResNet-50's five slowest layers under
    autotune."""
    import numpy as np
    from repro_torch.core.pipeline import default_pipeline
    from repro_torch.core.program import compile
    from repro_torch.launch import cnn_eval
    from repro_torch.models.cnn import CNN_MODELS, build_cnn

    rng = np.random.default_rng(0)
    total = {kern.__name__: 0 for kern in K.KERNELS}
    rows, slowest = [], []
    with tempfile.TemporaryDirectory() as tmp:
        pols = cnn_eval.policies(autotune_cache=os.path.join(tmp, "autotune.json"),
                                 device="cuda")
        for name in CNN_MODELS:
            t = time.perf_counter()
            raw = build_cnn(name, batch=1)
            g = default_pipeline().run(raw)
            x = torch.from_numpy(rng.standard_normal(g.inputs["x"].shape)
                                 .astype(np.float32)).cuda()
            progs = cnn_eval.compile_all(g, pols, device="cuda")
            outs, row, errs = {}, {"model": name}, {}
            for label, prog in progs.items():
                for kern in K.KERNELS:
                    kern.launches = 0
                (y,) = prog(x=x)
                torch.cuda.synchronize()
                launches = {kern.__name__: kern.launches for kern in K.KERNELS}
                n_cuda = sum(b == "cuda" for b in prog.assignment.values())
                if launches != {**dict.fromkeys(launches, 0), "gemm": n_cuda}:
                    fail(f"{name} {label}: launches {launches}, expected gemm x {n_cuda} only")
                if label == "cuda" and n_cuda == 0:
                    fail(f"{name}: the cuda assignment runs no cuda conv")
                for k_, v_ in launches.items():
                    total[k_] += v_
                if not bool(torch.isfinite(y).all()) or y.shape[0] != 1:
                    fail(f"{name} {label}: output {tuple(y.shape)} not finite")
                outs[label] = y
            base = outs["gemm"]
            for label, y in outs.items():
                rel = float((y - base).abs().max() / base.abs().max())
                tol = 1e-3 if "winograd" in progs[label].assignment.values() else 1e-4
                if rel > tol:
                    fail(f"{name} {label}: max|a - b| / max|b| = {rel:.2e} against gemm > {tol}")
                errs[label] = rel
            (y_raw,) = compile(raw, policy=pols["gemm"], pipeline=(), device="cuda")(x=x)
            rel_raw = float((y_raw - base).abs().max() / base.abs().max())
            if rel_raw > 1e-4:
                fail(f"{name}: simplified vs unsimplified graph {rel_raw:.2e} > 1e-4")
            for label, prog in progs.items():
                row[label] = 1e3 * cnn_eval.time_program(prog, x, reps=5)
            best = min(row[label] for label in progs)
            row["winner"] = next(label for label in progs if row[label] == best)
            mix = {label: sorted(set(prog.assignment.values())) for label, prog in progs.items()}
            n_conv = sum(n.op.startswith("conv2d") for n in g.nodes)
            say(f"  {name}: {len(g.nodes)} nodes ({n_conv} conv), "
                f"{sum(p.nbytes for p in g.params.values()) / 1e6:.1f} MB of weights; ms "
                + ", ".join(f"{label} {row[label]:.3f}" for label in progs)
                + f"; winner {row['winner']}  [{card}]")
            say(f"    max|a - gemm| / max|gemm|: {json.dumps(errs)}; simplified vs raw "
                f"{rel_raw:.2e}; backends per assignment {json.dumps(mix)}; "
                f"{time.perf_counter() - t:.1f} s")
            if name == "resnet-50":
                _, reports = progs["autotune"].run_instrumented(x=x)
                top = sorted(reports, key=lambda r: -r.seconds)[:5]
                slowest = [dict(name=r.name, op=r.op, backend=r.backend, ms=1e3 * r.seconds,
                                out=list(r.out_spec.shape)) for r in top]
                total_ms = 1e3 * sum(r.seconds for r in reports)
                say(f"    resnet-50 autotune, run_instrumented: {len(reports)} nodes, "
                    f"{total_ms:.3f} ms summed; five slowest {json.dumps(slowest)}  [{card}]")
            rows.append(row)
            del progs, outs
            torch.cuda.empty_cache()
        inf = [(key, b) for key, times in pols["autotune"]._timings.items()
               for b, t_ in times.items() if b.startswith("cuda") and t_ == float("inf")]
        if inf:
            fail(f"cnn autotune timed cuda backends as inf (could not run): {inf}")
    return total, rows, slowest


# --------------------------------------------------------------------------- #
# phase 8: the layer-stack LM under the continuous batcher, at full width
# --------------------------------------------------------------------------- #

def layerstack_phase(torch, K, cfg, card, *, n_slots=4, cache_cap=2048, n_requests=8,
                     max_new=32, tag="layerstack"):
    """``cfg`` (a config at its published widths and bfloat16 from
    ``serving_config``: gemma3-1b in phase 8, qwen2-moe-a2.7b in 9,
    mamba2-370m in 10, zamba2-7b in 19, deepseek-v2-lite-16b in 20) served
    by the continuous batcher through the entry points a user calls
    (``LM``, ``ContinuousBatcher``).  Returns the launches and the serving
    numbers; fails unless every request equals the unbatched greedy prefill
    + decode on the card, each kernel launched exactly as the path needs
    (a bfloat16 config's on the bf16 entries, the MoE router on the fp32
    gemm) and the weights and caches are in their dtypes
    (check_served_dtype)."""
    import numpy as np
    from repro_torch.models.lm import LM
    from repro_torch.runtime.batching import ContinuousBatcher, Request

    class TimedLM(LM):
        """Host clock around each prefill and decode step, ending in a
        synchronise (the batcher reads the argmax right after anyway)."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.prefill_s, self.decode_s = [], []

        def prefill(self, *args, **kw):
            t = time.perf_counter()
            out = super().prefill(*args, **kw)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t)
            return out

        def decode_step(self, *args, **kw):
            t = time.perf_counter()
            out = super().decode_step(*args, **kw)
            torch.cuda.synchronize()
            self.decode_s.append(time.perf_counter() - t)
            return out

    model = TimedLM(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    torch.cuda.synchronize()
    check_served_dtype(torch, cfg, params, tag)
    _, weight_b = weights_line(torch, cfg, params, t0)
    rng = np.random.default_rng(0)
    lens = rng.integers(200, 1401, n_requests)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]
    if cfg.window and not (min(lens) <= cfg.window < max(lens)):
        fail(f"prompt lengths {lens.tolist()} do not straddle the window {cfg.window}")
    batcher = ContinuousBatcher(model, params, n_slots=n_slots, cache_cap=cache_cap, eos_id=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    for r in reqs:
        batcher.submit(r)
    t_run = time.perf_counter()
    finished = batcher.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    # every cache in the config's dtype but Mamba2's state, fp32 in both packages
    cache_dtypes = sorted({f"{name} {x.dtype}" for name, x in _named_leaves(batcher.caches)
                           if x.dtype != (torch.float32 if name == "ssm" else
                                          getattr(torch, cfg.dtype))})
    if cache_dtypes:
        fail(f"{tag}: caches {cache_dtypes}, the config's dtype is {cfg.dtype} (the SSM "
             "state fp32)")
    say(f"  batcher: {len(reqs)} requests, prompts {lens.tolist()}, {batcher.steps} decode "
        f"steps in {t_run:.2f} s; caches {cfg.dtype}" + (", the SSM state float32"
                                                          if cfg.ssm is not None else ""))
    say(f"  launches during the batcher run: {launches}")
    if len(finished) != len(reqs) or any(len(r.out_tokens) != max_new for r in reqs):
        fail(f"{tag}: not every request finished with its tokens")
    want = stack_launches(cfg, len(reqs), batcher.steps, launches)
    if launches != want:
        fail(f"{tag}: launches {launches} != expected {want}")
    n_out = sum(len(r.out_tokens) for r in reqs)
    stats = {
        "prefill_ms_per_request": 1e3 * sum(model.prefill_s) / len(model.prefill_s),
        "prefill_ms_per_token": 1e3 * sum(model.prefill_s) / int(lens.sum()),
        "decode_ms_per_step": 1e3 * sum(model.decode_s) / len(model.decode_s),
        "tokens_per_s": n_out / t_run,
        "slot_utilisation": batcher.utilisation,
        "max_memory_allocated_gb": peak / 1e9,
        "batcher_wall_s": t_run,
        "decode_steps": batcher.steps,
        "prompt_tokens": int(lens.sum()),
        "tokens_out": n_out,
        "dtype": cfg.dtype,
        "weights_gb": weight_b / 1e9,
    }
    say(f"  serving ({tag} batcher): {json.dumps(stats)} [{card}]")
    del batcher                    # its caches; the reference makes its own
    torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    for r in reqs:
        lg, caches, lengths = model.prefill(
            params, {"tokens": torch.as_tensor(r.prompt, device="cuda")[None]},
            cache_cap=cache_cap)
        ref = [int(lg[0].argmax())]
        while len(ref) < max_new:
            lg, caches = model.decode_step(
                params, torch.tensor([ref[-1]], dtype=torch.int32, device="cuda"), caches,
                lengths)
            lengths = lengths + 1
            ref.append(int(lg[0].argmax()))
        if r.out_tokens != ref:
            fail(f"{tag} request {r.uid} (prompt {len(r.prompt)}): batcher "
                 f"{r.out_tokens} != unbatched {ref}")
    say(f"  all {len(reqs)} requests token-exact against the unbatched greedy prefill + "
        f"decode on the card ({time.perf_counter() - t_ref:.2f} s)")
    del params
    return launches, stats


# the leaves JAX's init makes fp32 whatever the param dtype: the MoE router
# (src/repro/layers/moe.py:42) and Mamba2's dt_bias, A_log and D
# (src/repro/layers/ssm.py:68-70)
FP32_LEAVES = ("router", "dt_bias", "A_log", "D")


def _named_leaves(tree, name=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, k)]
    if isinstance(tree, list):
        return [x for v in tree for x in _named_leaves(v, name)]
    return [(name, tree)]


def check_served_dtype(torch, cfg, params, tag):
    """The config's kernel ops all on ``cuda`` (no ``ref`` on the path) and
    every weight in the dtype JAX's init gives it: FP32_LEAVES fp32, every
    other leaf the config's param dtype."""
    bad = {op: cfg.backend(op) for op in ("attention", "decode_attention", "rmsnorm", "dense",
                                          "moe_gemm", "ssd") if cfg.backend(op) != "cuda"}
    if bad:
        fail(f"{tag}: ops off the kernels: {bad}")
    want = getattr(torch, cfg.param_dtype)
    wrong = sorted({f"{name} {x.dtype}" for name, x in _named_leaves(params)
                    if x.dtype != (torch.float32 if name in FP32_LEAVES else want)})
    if wrong:
        fail(f"{tag}: weights not in JAX's init dtypes ({cfg.param_dtype}, fp32 for "
             f"{FP32_LEAVES}): {wrong}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


DERIVED_LEAVES = ("embed_t", "wuk_h", "wuv_h")    # copies the port makes once from JAX's leaves


def weights_line(torch, cfg, params, t0):
    """Print the weights' parameters and bytes (the derived leaves apart:
    the transposed tied embedding, MLA's per-head up-projections) and every
    leaf's elements by element size; returns (params, bytes) without the
    derived leaves."""
    leaves = _leaves(params)
    derived, derived_b = _derived_numel(params), _derived_numel(params, nbytes=True)
    n_params = sum(x.numel() for x in leaves) - derived
    weight_b = sum(x.numel() * x.element_size() for x in leaves) - derived_b
    by_size = {}
    for x in leaves:
        by_size[x.element_size()] = by_size.get(x.element_size(), 0) + x.numel()
    sizes = ", ".join(f"{n:,} elements at {sz} bytes ({sz * n / 1e9:.3f} GB)"
                      for sz, n in sorted(by_size.items()))
    kept = sorted({name for name, x in _named_leaves(params) if name in FP32_LEAVES})
    say(f"  weights {n_params / 1e9:.4f} B params, {weight_b / 1e9:.3f} GB ({cfg.param_dtype}"
        f"{', ' + '/'.join(kept) + ' fp32' if kept else ''}), plus {derived_b / 1e9:.3f} GB of derived leaves; every leaf by "
        f"element size: {sizes}; drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return n_params, weight_b


def _derived_numel(tree, nbytes=False):
    """Elements (or with ``nbytes`` bytes) of the DERIVED_LEAVES in ``tree``."""
    if isinstance(tree, dict):
        return sum(v.numel() * (v.element_size() if nbytes else 1) if k in DERIVED_LEAVES
                   else _derived_numel(v, nbytes) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_derived_numel(v, nbytes) for v in tree)
    return 0


# --------------------------------------------------------------------------- #
# phase 21: the encoder-decoder at full width
# --------------------------------------------------------------------------- #

def encdec_phase(torch, K, cfg, card, *, n_src=4, tag="encdec"):
    """seamless-m4t-medium at its published widths (bfloat16, from
    ``serving_config``) through ``EncDec``: ``n_src`` sources of ENCDEC_SRC
    frames (numpy-seeded normal embeddings, the audio frontend's stub) with
    ENCDEC_PROMPT-token prompts prefilled in one call, then ENCDEC_NEW
    greedy tokens by ``decode_step``.  Fails unless each source's tokens
    equal a batch-1 run of it and every kernel launched exactly as the path
    needs (stack_calls).  Returns the launches and the serving numbers."""
    import numpy as np
    from repro_torch.models.encdec import EncDec

    model = EncDec(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    torch.cuda.synchronize()
    check_served_dtype(torch, cfg, params, tag)
    _, weight_b = weights_line(torch, cfg, params, t0)
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((n_src, ENCDEC_SRC, cfg.d_model))
                           .astype(np.float32)).cuda()
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (n_src, ENCDEC_PROMPT))
                               .astype(np.int32)).cuda()
    cache_cap = ENCDEC_PROMPT + ENCDEC_NEW

    def greedy(s, t, clock=None):
        t_pre = time.perf_counter()
        lg, caches, lengths = model.prefill(params, {"src_embeds": s, "tokens": t},
                                            cache_cap=cache_cap)
        out = [lg.argmax(-1).to(torch.int32)]
        torch.cuda.synchronize()
        t_dec = time.perf_counter()
        enc_lengths = torch.full((s.shape[0],), s.shape[1], dtype=torch.int32, device="cuda")
        while len(out) < ENCDEC_NEW:
            lg, caches = model.decode_step(params, out[-1], caches, lengths, enc_lengths)
            lengths = lengths + 1
            out.append(lg.argmax(-1).to(torch.int32))
        toks = torch.stack(out, 1).tolist()
        if clock is not None:
            clock.update(prefill_s=t_dec - t_pre, decode_s=time.perf_counter() - t_dec)
        return toks

    greedy(src[:1], prompts[:1])                # warm-up: first calls, workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in K.KERNELS:
        kern.launches = 0
    clock = {}
    got = greedy(src, prompts, clock)
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    say(f"  launches during the batch-{n_src} run: {launches}")
    want = stack_launches(cfg, 1, ENCDEC_NEW - 1, launches)
    if launches != want:
        fail(f"{tag}: launches {launches} != expected {want}")
    steps = ENCDEC_NEW - 1
    stats = {
        "prefill_ms": 1e3 * clock["prefill_s"],
        "decode_ms_per_step": 1e3 * clock["decode_s"] / steps,
        "tokens_per_s": n_src * ENCDEC_NEW / (clock["prefill_s"] + clock["decode_s"]),
        "max_memory_allocated_gb": peak / 1e9,
        "sources": n_src, "source_frames": ENCDEC_SRC, "prompt_tokens": ENCDEC_PROMPT,
        "tokens_out": n_src * ENCDEC_NEW, "decode_steps": steps, "dtype": cfg.dtype,
        "weights_gb": weight_b / 1e9,
    }
    say(f"  serving ({tag}, batch {n_src}): {json.dumps(stats)} [{card}]")
    t_ref = time.perf_counter()
    for i in range(n_src):
        one = greedy(src[i:i + 1], prompts[i:i + 1])[0]
        if one != got[i]:
            fail(f"{tag} source {i}: batch-{n_src} {got[i]} != batch-1 {one}")
    say(f"  all {n_src} sources token-exact against batch-1 runs on the card "
        f"({time.perf_counter() - t_ref:.2f} s)")
    del params, src
    return launches, stats


# --------------------------------------------------------------------------- #
# phase 22: training at full width
# --------------------------------------------------------------------------- #

TRAIN_BATCH, TRAIN_SEQ = 4, 1024     # SyntheticLM rows and tokens a row
TRAIN_STEPS, TRAIN_SAVE_AT = 8, 4    # steps run; the checkpoint the resumed run starts from
TRAIN_LR = 1e-3                      # launch/train.py's default, with its warmup_cosine(lr, 20, steps)


def train_flops(cfg, n_params, batch, seq):
    """Operations one train step needs: 6 N T for the N trainable params
    over T tokens (forward 2 N T, backward 4 N T; the tied head is the
    embedding's product) plus 3 times the forward attention's score and
    value products over the pairs the causal or window mask allows.  The
    recomputation of remat is not counted: it is not needed work."""
    attn = 0.0
    for blk in cfg.plan.all_blocks():
        window = cfg.window if blk.mixer == "attn_local" else None
        attn += 4.0 * batch * cfg.n_heads * attention_pairs(seq, seq, True, window) \
            * cfg.head_dim
    return 6.0 * n_params * batch * seq + 3.0 * attn


def train_phase(torch, K, card):
    """gemma3-1b at its published widths and depth, fp32, through the
    port's training path: ``make_train_step(donate=True)`` (AdamW with
    ``warmup_cosine``, remat on) on TRAIN_BATCH x TRAIN_SEQ SyntheticLM
    tokens for TRAIN_STEPS steps, a CheckpointManager save at step
    TRAIN_SAVE_AT under build/, then a restore into fresh tensors and steps
    TRAIN_SAVE_AT + 1 .. TRAIN_STEPS again.  Fails unless the losses and
    grad norms are finite, every param leaf moved, the resumed params are
    bitwise the uninterrupted run's, and no kernel of the port launched
    (training runs on the differentiable plain backends).  Returns the
    numbers."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models.lm import LM, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.runtime.train import make_train_step

    cfg = get_config("gemma3-1b").with_overrides(dtype="float32", param_dtype="float32")
    model = LM(cfg)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, schedule=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
    before = kernel_counts(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = strip_derived(model.init_params(0, device="cuda"))
    opt = adamw.init(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    say(f"  weights {n_params / 1e9:.4f} B params ({4 * n_params / 1e9:.2f} GB fp32; with "
        f"grads, master, mu and nu {20 * n_params / 1e9:.2f} GB), drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; remat {cfg.remat}")
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    step_fn = make_train_step(model, cfg, opt_cfg, donate=True)
    sums0 = [float(x.double().sum()) for x in tree_leaves(params)]

    ckpt_dir = Path(tempfile.mkdtemp(prefix="phase22_ckpt_", dir=ROOT / "build"))
    free = shutil.disk_usage(ckpt_dir).free
    if free < 17 * n_params:
        fail(f"train: {free / 1e9:.1f} GB free under build/, the checkpoint needs "
             f"{16 * n_params / 1e9:.1f} GB")
    mgr = CheckpointManager(str(ckpt_dir), keep=1)

    def run(p, o, first):
        ms, losses, gnorms = [], [], []
        for i in range(first, TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, o, m = step_fn(p, o, batches[i])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if i + 1 == TRAIN_SAVE_AT and first == 0:
                t = time.perf_counter()
                mgr.save(i + 1, {"params": p, "opt": o}, {"loss": losses[-1]})
                copy_s = time.perf_counter() - t
                mgr.wait()
                clock.update(save_copy_s=copy_s, save_s=time.perf_counter() - t)
        return p, o, ms, losses, gnorms

    clock = {}
    try:
        params, opt, ms, losses, gnorms = run(params, opt, 0)
        peak = torch.cuda.max_memory_allocated()
        say(f"  losses {losses}; grad norms {gnorms}; ms a step {[round(x, 1) for x in ms]}")
        if not all(math.isfinite(x) for x in losses + gnorms):
            fail(f"train: a loss or grad norm is not finite: {losses}, {gnorms}")
        sums = [float(x.double().sum()) for x in tree_leaves(params)]
        still = sum(a == b for a, b in zip(sums0, sums))
        if still:
            fail(f"train: {still} of {len(sums)} param leaves did not move in {TRAIN_STEPS} "
                 f"steps")
        ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
        target = tree_map(lambda t: torch.empty_like(t, device="meta"),
                          {"params": params, "opt": opt})
        del opt
        release(torch)
        t = time.perf_counter()
        restored = mgr.restore(target, device="cuda", step=TRAIN_SAVE_AT)
        torch.cuda.synchronize()
        clock["restore_s"] = time.perf_counter() - t
        p_r, o_r, ms_r, losses_r, _ = run(restored["params"], restored["opt"], TRAIN_SAVE_AT)
        del restored
    finally:
        mgr.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if losses_r != losses[TRAIN_SAVE_AT:]:
        fail(f"train: resumed losses {losses_r} != uninterrupted {losses[TRAIN_SAVE_AT:]}")
    differ = [i for i, (a, b) in enumerate(zip(tree_leaves(params), tree_leaves(p_r)))
              if not torch.equal(a, b)]
    if differ:
        fail(f"train: {len(differ)} resumed param leaves differ from the uninterrupted run's")
    if int(o_r["step"]) != TRAIN_STEPS:
        fail(f"train: the resumed optimizer counts {int(o_r['step'])} steps, not {TRAIN_STEPS}")
    after = kernel_counts(K)
    if after != before:
        fail(f"train: kernels launched during training: "
             f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }")
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    stats = {
        "arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "resumed_steps": TRAIN_STEPS - TRAIN_SAVE_AT,
        "ms_per_step_median_2_to_8": step_ms, "ms_per_step": ms, "resumed_ms_per_step": ms_r,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "max_memory_allocated_gb": peak / 1e9,
        "step_flops": flops, "bound_ms": flops / PEAK_FP32_FLOPS * 1e3, "bound_by": "operations",
        "checkpoint_bytes": ckpt_bytes, "save_copy_s": clock["save_copy_s"],
        "save_s": clock["save_s"], "restore_s": clock["restore_s"],
        "losses": losses, "grad_norms": gnorms, "resumed_bitwise": True, "launches": 0,
    }
    say(f"  resumed at step {TRAIN_SAVE_AT}: steps {TRAIN_SAVE_AT + 1}-{TRAIN_STEPS} give the "
        f"uninterrupted run's losses and params bit for bit; no kernel launched")
    say(f"  training ({cfg.name}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens a step): {json.dumps(stats)} "
        f"[{card}]")
    del params, p_r, o_r, batches
    return stats


TRAIN_BF16_STEPS = 4                 # phase 22b's steps (step 1 then repeated from a copy)
ADAMW_BYTES = 2 + 4 + 4 + 4          # a parameter's bf16 grad / param, f32 master, mu, nu


def train_bf16_phase(torch, K, card, fp32_record):
    """Phase 22b: gemma3-1b at its published widths, depth and dtypes (bf16
    params from ``init_params(0)`` with no override, f32 masters and
    moments), phase 22's AdamW, schedule, batches and
    ``make_train_step(donate=True)`` with remat, TRAIN_BF16_STEPS steps;
    step 1 also from a copy of the initial state.  Fails unless the losses
    and grad norms are finite, every master leaf moved and every param leaf
    is its master rounded once to bf16 (a param leaf whose master moved by
    less than half a bf16 ulp keeps its value: the norm scales at 1.0, under
    the warmup's lr), the dtypes hold, step 1 repeated is bitwise step 1,
    step 1's loss lies within 1e-2 relative of phase 22's fp32 step-1 loss
    on the same batch and no kernel of the port launched.  Returns the
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models.lm import LM, strip_derived
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.runtime.train import make_train_step

    cfg = get_config("gemma3-1b")
    model = LM(cfg)
    # phase 22's schedule, over phase 22's steps: the same lr at each step
    opt_cfg = AdamWConfig(lr=TRAIN_LR, schedule=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
    before = kernel_counts(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = strip_derived(model.init_params(0, device="cuda"))
    opt = adamw.init(params, opt_cfg)
    copy = tree_map(torch.clone, {"params": params, "opt": opt})
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    dtypes = ({str(x.dtype) for x in tree_leaves(params)},
              {str(x.dtype) for k in ("master", "mu", "nu") for x in tree_leaves(opt[k])})
    if dtypes != ({"torch.bfloat16"}, {"torch.float32"}):
        fail(f"train_bf16: params {dtypes[0]}, masters and moments {dtypes[1]}")
    say(f"  weights {n_params / 1e9:.4f} B params, bf16 ({2 * n_params / 1e9:.2f} GB; with bf16 "
        f"grads and f32 masters, mu and nu {16 * n_params / 1e9:.2f} GB, and a copy of the "
        f"initial state for the repeat), drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"remat {cfg.remat}, dtype {cfg.dtype}, param_dtype {cfg.param_dtype}")
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch_at(i).items()}
               for i in range(TRAIN_BF16_STEPS)]
    step_fn = make_train_step(model, cfg, opt_cfg, donate=True)
    masters0 = [float(x.double().sum()) for x in tree_leaves(opt["master"])]
    params0 = [float(x.double().sum()) for x in tree_leaves(params)]

    def timed(p, o, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        torch.cuda.synchronize()
        return p, o, m, 1e3 * (time.perf_counter() - t)

    ms, losses, gnorms = [], [], []
    for i in range(TRAIN_BF16_STEPS):
        params, opt, m, t_ms = timed(params, opt, batches[i])
        ms.append(t_ms)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i == 0:
            # step 1 again, from the copy of the initial state
            p_r, o_r, m_r, repeat_ms = timed(copy["params"], copy["opt"], batches[0])
            same = [torch.equal(a, b) for a, b in zip(tree_leaves({"p": params, "o": opt}),
                                                      tree_leaves({"p": p_r, "o": o_r}))]
            if not all(same) or float(m_r["loss"]) != losses[0]:
                fail(f"train_bf16: step 1 repeated from a copy of the initial state differs in "
                     f"{same.count(False)} of {len(same)} state leaves (loss "
                     f"{float(m_r['loss'])} against {losses[0]})")
            del copy, p_r, o_r, m_r
            release(torch)
    peak = torch.cuda.max_memory_allocated()
    say(f"  losses {losses}; grad norms {gnorms}; ms a step {[round(x, 1) for x in ms]}, step 1 "
        f"repeated {repeat_ms:.1f}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"train_bf16: a loss or grad norm is not finite: {losses}, {gnorms}")
    still = sum(a == float(b.double().sum()) for a, b in zip(masters0, tree_leaves(opt["master"])))
    if still:
        fail(f"train_bf16: {still} master leaves did not move in {TRAIN_BF16_STEPS} steps")
    cast = [torch.equal(p, w.to(torch.bfloat16))
            for p, w in zip(tree_leaves(params), tree_leaves(opt["master"]))]
    if not all(cast):
        fail(f"train_bf16: {cast.count(False)} param leaves are not their masters rounded once")
    moved = sum(a != float(b.double().sum()) for a, b in zip(params0, tree_leaves(params)))
    fp32_loss = fp32_record["losses"][0]
    if not abs(losses[0] - fp32_loss) <= 1e-2 * abs(fp32_loss):
        fail(f"train_bf16: step 1's loss {losses[0]} is not within 1e-2 of phase 22's fp32 "
             f"{fp32_loss}")
    after = kernel_counts(K)
    if after != before:
        fail(f"train_bf16: kernels launched during training: "
             f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }")
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    adamw_bytes = 2.0 * ADAMW_BYTES * n_params
    stats = {
        "arch": cfg.name, "params": n_params, "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_BF16_STEPS, "ms_per_step_median_2_to_4": step_ms, "ms_per_step": ms,
        "step1_ms": ms[0], "step1_repeated_ms": repeat_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "max_memory_allocated_gb": peak / 1e9, "step_flops": flops,
        "bound_ms": flops / PEAK_BF16_FLOPS * 1e3, "bound_by": "operations",
        "adamw_bytes": adamw_bytes, "adamw_bytes_ms": adamw_bytes / PEAK_HBM_BYTES * 1e3,
        "losses": losses, "grad_norms": gnorms, "fp32_step1_loss": fp32_loss,
        "param_leaves_moved": moved, "param_leaves": len(cast), "step1_repeat_bitwise": True,
        "launches": 0,
    }
    say(f"  step 1 repeated from a copy of the initial state: bitwise; {moved} of {len(cast)} "
        f"param leaves moved (each param its master rounded once; every master moved); step 1 "
        f"loss {losses[0]:.6f} against phase 22's fp32 {fp32_loss:.6f}; no kernel launched")
    say(f"  training bf16 ({cfg.name}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens a step; bound: "
        f"{flops / 1e12:.2f} TFLOP at 989 TFLOP/s bf16, AdamW's pass {adamw_bytes / 1e9:.1f} GB "
        f"at 3.35 TB/s): {json.dumps(stats)} [{card}]")
    del params, opt, batches
    return stats


# --------------------------------------------------------------------------- #
# phase 23: sharded training on a (data 2, model 2) process mesh, and the
# pipeline over "pod", four ranks on one card over gloo
# --------------------------------------------------------------------------- #

MESH_TRAIN_PERIODS = 1            # depth cut: 6 of 26 layers, one period of 5 local + 1 global
MESH_TRAIN_STEPS = 2
MESH_SHAPE = (2, 2)               # (data, model)
PIPE_STAGES, PIPE_MICRO, PIPE_SEED = 4, 8, 23


def mesh_train_setup(torch, device):
    """(cfg, model, AdamW config, batches) of phase 23: gemma3-1b's widths at
    MESH_TRAIN_PERIODS periods, fp32, phase 22's AdamW and schedule, its
    first MESH_TRAIN_STEPS SyntheticLM batches on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerPlan
    from repro_torch.data import SyntheticLM
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    cfg = get_config("gemma3-1b")
    cfg = cfg.with_overrides(dtype="float32", param_dtype="float32",
                             plan=LayerPlan(period=cfg.plan.period, n_periods=MESH_TRAIN_PERIODS))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, schedule=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in ds.batch_at(i).items()}
               for i in range(MESH_TRAIN_STEPS)]
    return cfg, LM(cfg), opt_cfg, batches


def pipe_parts(torch, cfg, params, device):
    """23c's stage weights (blocks 0-3 of the period, stacked on a stage
    axis, copies), its seeded (PIPE_MICRO, 1, TRAIN_SEQ, d) input and its
    stage function: one sliding-window block's train-mode forward."""
    import numpy as np
    from repro_torch.core.tree import tree_map
    from repro_torch.models.stack import block_apply
    per = params["stack"]["period"]
    blocks = tree_map(lambda *xs: torch.stack(xs),
                      *[tree_map(lambda a: a[0], per[j]) for j in range(PIPE_STAGES)])
    x = np.random.default_rng(PIPE_SEED).standard_normal(
        (PIPE_MICRO, 1, TRAIN_SEQ, cfg.d_model)).astype(np.float32)
    blk = cfg.plan.period[0]
    return blocks, torch.from_numpy(x).to(device), \
        lambda p, h: block_apply(p, h, blk, cfg=cfg, mode="train")[0]


def sha256_all(arrays):
    """The sha256 of each host array's bytes, hashed on threads (hashlib
    releases the interpreter lock on large buffers)."""
    import concurrent.futures
    import hashlib
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda a: hashlib.sha256(a.data).hexdigest(), arrays))


def shard_numel(shape, spec, sizes):
    """Elements of one rank's slice of ``shape`` under ``spec``."""
    from repro_torch.sharding.specs import spec_axes
    n = math.prod(shape)
    for entry in spec:
        for a in spec_axes(entry):
            n //= sizes[a]
    return n


def mesh_train_rank(ckpt_dir, device):
    """One rank of phase 23 (run by spawn_ranks): the same init sharded by
    train_state_shardings, step 1's value_and_grad and MESH_TRAIN_STEPS
    donated make_train_step(mesh=...) steps, the CheckpointManager save,
    the sha256 of every state leaf gathered to rank 0, then 23c's pipeline on
    a ("pod",) mesh of the same ranks.  Returns what the parent checks."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.io import gather_to_host
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import strip_derived
    from repro_torch.optim import adamw
    from repro_torch.runtime.pipeline import pipeline_apply
    from repro_torch.runtime.train import make_train_step, train_state_shardings, value_and_grad
    from repro_torch.sharding.specs import shard_tree
    K = Kernels()
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), device=device)
    dev, rank0 = mesh.device, mesh.rank == 0
    cfg, model, opt_cfg, batches = mesh_train_setup(torch, dev)
    full = strip_derived(model.init_params(0, device=dev))
    blocks, x, stage = pipe_parts(torch, cfg, full, dev)
    p_spec, o_spec, _ = train_state_shardings(model, cfg, mesh, batches[0], opt_cfg)
    params = shard_tree(full, p_spec, mesh)
    opt = shard_tree(adamw.init(full, opt_cfg), o_spec, mesh)
    del full
    release(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_counts(K)

    t = time.perf_counter()
    _, _, grads = value_and_grad(model, params, batches[0], mesh=mesh, specs=p_spec)
    grads_host = gather_to_host(grads, p_spec, mesh)
    grads_host = list(grads_host.values()) if rank0 else None
    del grads
    clock = {"setup_s": t - t_start, "value_and_grad_s": time.perf_counter() - t}
    step_fn = make_train_step(model, cfg, opt_cfg, mesh=mesh, batch_example=batches[0],
                              donate=True)
    ms, losses, gnorms, traffic = [], [], [], []
    for i in range(MESH_TRAIN_STEPS):
        mesh.traffic.update(gathered=0, reduced=0)
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[i])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        traffic.append(dict(mesh.traffic))
    peak = torch.cuda.max_memory_allocated()
    state, specs = {"params": params, "opt": opt}, {"params": p_spec, "opt": o_spec}
    t = time.perf_counter()
    CheckpointManager(ckpt_dir, keep=1).save(MESH_TRAIN_STEPS, state, specs=specs, mesh=mesh)
    clock["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    whole = gather_to_host(state, specs, mesh)
    digests = sha256_all(whole.values()) if rank0 else None
    del whole
    clock["digest_s"] = time.perf_counter() - t
    mu_numel = sum(v.numel() for v in tree_leaves(opt["mu"]))
    del state, params, opt
    release(torch)

    pod = make_mesh((PIPE_STAGES,), ("pod",), device=device)
    calls = []

    def counted(p, h):
        calls.append(1)
        return stage(p, h)

    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = pipeline_apply(pod, counted, blocks, x, axis="pod")
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t
    pipe_grads = pipe_grad_check(torch, pod, stage, blocks, x)
    after = kernel_counts(K)
    out = {"coords": dict(mesh.coords), "backend": mesh.backend, "ms": ms, "losses": losses,
           "grad_norms": gnorms, "traffic": traffic, "peak": peak, "mu_numel": mu_numel,
           "clock": clock, "grads": grads_host, "digests": digests,
           "pipe": y.cpu().numpy() if rank0 else None, "pipe_calls": len(calls), "pipe_s": pipe_s,
           "pipe_grads": pipe_grads,
           "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
    del blocks, x, y
    release(torch)
    out["serve"] = mesh_serve_rank(torch, K, mesh)
    return out


def pipe_grad_check(torch, pod, stage, blocks, x):
    """23c's backward pass on this rank: every rank backpropagates the same
    seeded loss sum(y * G) through pipeline_apply; this process also runs
    the sequential blocks and backpropagates it there.  Returns the stage's
    largest |difference| a leaf over that leaf's largest |value| in the
    sequential gradient, the same for x, and the seconds."""
    from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.runtime.pipeline import pipeline_apply
    gen = torch.Generator(device=x.device)
    gen.manual_seed(PIPE_SEED + 1)
    g = torch.randn(x.shape, generator=gen, device=x.device)

    def fresh():
        leaves = [a.detach().clone().requires_grad_() for a in tree_leaves(blocks)]
        return leaves, tree_unflatten(blocks, leaves), x.detach().clone().requires_grad_()

    leaves_p, bp, xp = fresh()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (pipeline_apply(pod, stage, bp, xp, axis="pod") * g).sum().backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t
    leaves_s, bs, xs = fresh()
    seq = []
    for mb in range(PIPE_MICRO):
        h = xs[mb]
        for s in range(PIPE_STAGES):
            h = stage(tree_map(lambda a: a[s], bs), h)
        seq.append(h)
    (torch.stack(seq) * g).sum().backward()
    s = pod.axis_index("pod")
    w_err = max(float((a.grad[s] - b.grad[s]).abs().max() / b.grad[s].abs().max().clamp(min=1e-30))
                for a, b in zip(leaves_p, leaves_s))
    x_err = float((xp.grad - xs.grad).abs().max() / xs.grad.abs().max())
    return {"stage": s, "w_err": w_err, "x_err": x_err, "s": pipe_s}


# --------------------------------------------------------------------------- #
# phase 24: serving on the (data 2, model 2) mesh of phase 23's ranks
# --------------------------------------------------------------------------- #

SERVE_BATCH, SERVE_PROMPT, SERVE_CAP = 4, 1000, 2048
SERVE_STEPS, SERVE_STEPS_B1, SERVE_SEED = 16, 8, 24
# (path, seq_shard_fallback, batch, decode steps)
SERVE_PATHS = (("seqshard", True, SERVE_BATCH, SERVE_STEPS),
               ("replicated", False, SERVE_BATCH, SERVE_STEPS),
               ("batch1", True, 1, SERVE_STEPS_B1))


def serve_config(dtype=None):
    """Phase 24's config: gemma3-1b at its published widths, depth and
    bfloat16, on the kernels the port serves with (CUDA_BACKENDS: every
    kernel of the path gives a row the same bits at any batch, so a rank's
    rows of the replicated mode are the one-process run's); ``dtype``
    "float32": the same on the upcast weights (the yardstick of the bound)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import CUDA_BACKENDS
    cfg = get_config("gemma3-1b").with_overrides(backends={**CUDA_BACKENDS})
    return cfg if dtype is None else cfg.with_overrides(dtype=dtype, param_dtype=dtype)


def greedy_run(torch, prefill, decode, params, prompts, steps, mesh=None, forced=None):
    """Greedy decode after the prefill: (logits a step (steps, B, V), the
    argmax tokens (steps, B), ms a decode step (synchronised; after a
    barrier on a mesh), the mesh's bytes gathered and all-reduced a decode
    step).  With ``forced`` ((steps, B) tokens) step t feeds forced[t]
    instead of its own argmax (teacher forcing: every step's logits answer
    the inputs of the run that chose ``forced``)."""
    import torch.distributed as dist
    logits, caches, lengths = prefill(params, {"tokens": prompts})
    all_logits, tokens, ms, traffic = [], [], [], []
    for t in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)   # ties: the lowest id
        all_logits.append(logits)
        tokens.append(tok)
        torch.cuda.synchronize()
        if mesh is not None:
            dist.barrier()
            mesh.traffic.update(gathered=0, reduced=0)
        t0 = time.perf_counter()
        logits, caches = decode(params, tok if forced is None else forced[t], caches, lengths)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if mesh is not None:
            traffic.append(dict(mesh.traffic))
        lengths = lengths + 1
    return torch.stack(all_logits), torch.stack(tokens), ms, traffic


def serve_reference(torch, model, params, prompts, steps):
    """Rank 0's one-process references at one batch: the bf16 greedy run
    (LM.prefill, LM.decode_step on the whole cache) and the same config at
    fp32 on the upcast weights fed the bf16 run's tokens.  Returns the bf16
    logits (as float32, exact: what rank 0 broadcasts) and tokens, JAX's bf16 convention's bound on the length-sharded
    modes (twice the largest |bf16 - fp32| over the steps, relative to the
    largest |logit|: the sharded steps round each rank's partial acc to bf16,
    as JAX's do), the top-2 gap of the bf16 logits a step and row, and the
    near-tie window a step and row: twice that row's largest |bf16 - fp32|
    at that step (the same convention, row by row)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.lm import LM
    logits, tokens, _, _ = greedy_run(
        torch, lambda p, i: model.prefill(p, i, cache_cap=SERVE_CAP), model.decode_step,
        params, prompts, steps)
    m32 = LM(serve_config("float32"))
    p32 = tree_map(lambda x: x.float(), params)
    l32, _, _, _ = greedy_run(torch, lambda p, i: m32.prefill(p, i, cache_cap=SERVE_CAP),
                              m32.decode_step, p32, prompts, steps, forced=tokens)
    del p32
    l16 = logits.float()
    gap = float((l16 - l32).abs().max() / l32.abs().max())
    top2 = l16.topk(2, dim=-1).values
    return l16, tokens, torch.tensor([2.0 * gap, gap], device=l16.device), \
        top2[..., 0] - top2[..., 1], 2.0 * (l16 - l32).abs().amax(dim=-1)


def mesh_serve_rank(torch, K, mesh):
    """Phase 24 on one rank of phase 23's (data 2, model 2) mesh: the whole
    bf16 params on every rank (init_params(0)); rank 0's one-process
    references (serve_reference) broadcast to every rank; then each of
    SERVE_PATHS through make_prefill_step / make_decode_step, held against
    them here: the replicated mode greedy on its own tokens, the
    length-sharded modes fed the reference's tokens.  Returns what the
    parent gates and prints."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.models.lm import LM
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    t0 = time.perf_counter()
    dev, rank0 = mesh.device, mesh.rank == 0
    cfg = serve_config()
    model = LM(cfg)
    params = model.init_params(0, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)).to(dev)
    out = {"paths": {}, "ref": {}, "setup_s": time.perf_counter() - t0}
    refs = {}
    with torch.no_grad():
        for b, steps in ((SERVE_BATCH, SERVE_STEPS), (1, SERVE_STEPS_B1)):
            t = time.perf_counter()
            before = kernel_counts(K)
            if rank0:
                ref = serve_reference(torch, model, params, prompts[:b], steps)
            else:
                ref = (torch.empty((steps, b, cfg.vocab_padded), device=dev),
                       torch.empty((steps, b), dtype=torch.int32, device=dev),
                       torch.empty(2, device=dev), torch.empty((steps, b), device=dev),
                       torch.empty((steps, b), device=dev))
            after = kernel_counts(K)
            for x in ref:
                dist.broadcast(x, src=0)
            refs[b] = ref
            out["ref"][b] = {"s": time.perf_counter() - t, "bound": float(ref[2][0]),
                             "bf16_vs_fp32": float(ref[2][1]), "launches": {
                                 k: after[k] - before[k] for k in after if after[k] != before[k]}}
        for path, fallback, b, steps in SERVE_PATHS:
            kw = dict(batch=b, cache_cap=SERVE_CAP, seq_shard_fallback=fallback)
            prefill = make_prefill_step(model, cfg, mesh, seq=SERVE_PROMPT, **kw)
            decode = make_decode_step(model, cfg, mesh, **kw)
            ref_logits, ref_tokens, bound_gap, top2, tie_window = refs[b]
            before = kernel_counts(K)
            t = time.perf_counter()
            logits, tokens, ms, traffic = greedy_run(
                torch, prefill, decode, params, prompts[:b], steps, mesh,
                forced=None if path == "replicated" else ref_tokens)
            seconds = time.perf_counter() - t
            after = kernel_counts(K)
            scale = float(ref_logits.abs().max())
            flips = tokens != ref_tokens
            out["paths"][path] = {
                "ms": ms, "s": seconds, "traffic": traffic[-1],
                "err": float((logits.float() - ref_logits).abs().max()) / scale,
                "bound": float(bound_gap[0]), "dtype": str(logits.dtype),
                "tokens_equal": bool(torch.equal(tokens, ref_tokens)),
                "logits_equal": bool(torch.equal(logits.float(), ref_logits)),
                "flips": int(flips.sum()),
                "flips_off_ties": int((flips & (top2 > tie_window)).sum()),
                "top2_at_flips": [float(x) for x in top2[flips]],
                "window_at_flips": [float(x) for x in tie_window[flips]],
                "tokens": tokens.cpu().tolist(),
                "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
            del logits, tokens
        del refs, params
    release(torch)
    out["s"] = time.perf_counter() - t0
    return out


# the decode entries a path may launch: bf16 only (no fp32 decode entry)
FP32_DECODE = ("flash_decode", "flash_decode_partial", "flash_paged_decode")


def mesh_serve_gates(ranks, card):
    """Phase 24's gates on the ranks' results, and its record."""
    paths = {}
    for path, fallback, b, steps in SERVE_PATHS:
        per = [r["serve"]["paths"][path] for r in ranks]
        kernel = "flash_decode_bf16" if path == "replicated" else "flash_decode_partial_bf16"
        for r, p in zip(ranks, per):
            where = f"mesh_serve: {path} on the rank at {r['coords']}"
            if p["dtype"] != "torch.bfloat16":
                fail(f"{where}: logits are {p['dtype']}, not bf16")
            if path == "replicated":
                # every op batch-invariant: a rank's rows are the reference's bit for bit
                if not (p["tokens_equal"] and p["logits_equal"]):
                    fail(f"{where}: greedy tokens {p['tokens']} or logits (within "
                         f"{p['err']:.3e} of the largest |logit|) differ from rank 0's "
                         f"one-process reference")
            elif not p["err"] <= p["bound"]:
                fail(f"{where}: logits within {p['err']:.3e} of the reference's largest "
                     f"|logit|, past the bound {p['bound']:.3e} (twice its bf16-vs-fp32 gap)")
            elif p["flips_off_ties"]:
                fail(f"{where}: {p['flips_off_ties']} of {p['flips']} argmax flips lie where the "
                     f"reference's top-2 gap {p['top2_at_flips']} exceeds its row's window "
                     f"{p['window_at_flips']}")
            if not p["launches"].get(kernel, 0) > 0:
                fail(f"{where} launched no {kernel}: {p['launches']}")
            if any(p["launches"].get(k, 0) for k in FP32_DECODE):
                fail(f"{where} launched an fp32 decode entry: {p['launches']}")
        paths[path] = {
            "seq_shard_fallback": fallback, "batch": b, "steps": steps,
            "teacher_forced": path != "replicated",
            "ms_per_step_by_rank": [p["ms"] for p in per],
            "median_ms_by_rank": [sorted(p["ms"])[len(p["ms"]) // 2] for p in per],
            "err_by_rank": [p["err"] for p in per], "bound": per[0]["bound"],
            "flips_by_rank": [p["flips"] for p in per],
            "top2_at_flips_by_rank": [p["top2_at_flips"] for p in per],
            "window_at_flips_by_rank": [p["window_at_flips"] for p in per],
            "s_by_rank": [p["s"] for p in per],
            "launches_by_rank": [p["launches"] for p in per],
            "bytes_a_step_rank0": per[0]["traffic"]}
    r0 = ranks[0]["serve"]
    stats = {"arch": "gemma3-1b", "layers": 26, "dtype": "bfloat16",
             "mesh": {"data": 2, "model": 2}, "prompt": SERVE_PROMPT, "cache": SERVE_CAP,
             "paths": paths, "reference": {str(b): v for b, v in r0["ref"].items()},
             "rank_s": [r["serve"]["s"] for r in ranks], "setup_s": r0["setup_s"]}
    for path, rec in paths.items():
        how = ("greedy tokens and logits equal rank 0's one-process reference bit for bit on "
               "every rank" if path == "replicated" else
               f"fed the reference's tokens: argmax flips by rank {rec['flips_by_rank']}, each "
               f"where the reference's top-2 gap (by rank {rec['top2_at_flips_by_rank']}) is "
               f"within its row's window (twice that row's |bf16 - fp32| at that step: "
               f"{rec['window_at_flips_by_rank']})")
        say(f"  24 {path} (seq_shard_fallback={rec['seq_shard_fallback']}, batch {rec['batch']}, "
            f"{rec['steps']} steps, bf16): {how}; logits within {max(rec['err_by_rank']):.3e} of "
            f"the reference's largest |logit| (bound {rec['bound']:.3e}: twice rank 0's "
            f"bf16-vs-fp32 gap); median ms a decode step by rank "
            f"{[round(v, 2) for v in rec['median_ms_by_rank']]} (functional: four gloo ranks on "
            f"one card); rank 0 a step: gathered "
            f"{rec['bytes_a_step_rank0']['gathered'] / 1e6:.3f} MB, all-reduced "
            f"{rec['bytes_a_step_rank0']['reduced'] / 1e6:.3f} MB; launches by rank "
            f"{rec['launches_by_rank']} [{card}]")
    say(f"  24 reference (rank 0, one process, bf16 and the fp32 yardstick): "
        f"{json.dumps(stats['reference'])}; phase seconds by rank "
        f"{[round(v, 1) for v in stats['rank_s']]} [{card}]")
    return stats


def mesh_train_phase(torch, K, card, device="cuda:0"):
    """Phase 23 (see the module docstring): the main process and the four
    ranks on ``device``.  Returns its record."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_test_mesh, spawn_ranks
    from repro_torch.models.lm import strip_derived
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import make_train_step, train_state_shardings, value_and_grad
    from repro_torch.sharding.specs import spec_leaves

    # 23a: one process
    t0 = time.perf_counter()
    cfg, model, opt_cfg, batches = mesh_train_setup(torch, device)
    before = kernel_counts(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = strip_derived(model.init_params(0, device=device))
    blocks, x, stage = pipe_parts(torch, cfg, params, device)
    n_params = sum(v.numel() for v in tree_leaves(params))
    opt = adamw.init(params, opt_cfg)
    say(f"  {cfg.plan.n_layers} layers ({n_params / 1e6:.2f} M params, "
        f"{4 * n_params / 1e9:.2f} GB fp32), {TRAIN_BATCH}x{TRAIN_SEQ} tokens a step")
    _, _, grads = value_and_grad(model, params, batches[0])
    ref_grads = [g.cpu() for g in tree_leaves(grads)]
    del grads
    step_fn = make_train_step(model, cfg, opt_cfg, donate=False)
    ms_a, losses, gnorms = [], [], []
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[i])
        torch.cuda.synchronize()
        ms_a.append(1e3 * (time.perf_counter() - t))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    ref_params = [v.cpu() for v in tree_leaves(params)]
    peak_a = torch.cuda.max_memory_allocated()
    target = tree_map(lambda v: torch.empty_like(v, device="meta"), {"params": params, "opt": opt})
    del params, opt
    release(torch)
    one_s = time.perf_counter() - t0
    say(f"  23a one process: losses {losses}, grad norms {gnorms}, ms a step "
        f"{[round(v, 2) for v in ms_a]}, peak {peak_a / 1e9:.2f} GB [{card}]")

    # 23b and 23c: four ranks on one card
    ckpt_dir = Path(tempfile.mkdtemp(prefix="phase23_ckpt_", dir=ROOT / "build"))
    try:
        free = shutil.disk_usage(ckpt_dir).free
        if free < 20 * n_params:
            fail(f"mesh_train: {free / 1e9:.1f} GB free under build/, the checkpoint needs "
                 f"{16 * n_params / 1e9:.1f} GB")
        t = time.perf_counter()
        ranks = spawn_ranks(mesh_train_rank, math.prod(MESH_SHAPE), str(ckpt_dir), device,
                            timeout=600)
        spawn_s = time.perf_counter() - t
        t = time.perf_counter()
        restored = CheckpointManager(str(ckpt_dir)).restore(target, device=device,
                                                            step=MESH_TRAIN_STEPS)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        t = time.perf_counter()
        host = [v.cpu() for v in tree_leaves(restored)]
        digests = sha256_all([v.numpy() for v in host])
        digest_s = time.perf_counter() - t
        got_params = host[:len(tree_leaves(restored["params"]))]
        del restored, host
        release(torch)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    r0 = ranks[0]

    # gates
    grad_err = max(float((a - torch.from_numpy(b)).abs().max() / max(float(a.abs().max()), 1e-30))
                   for a, b in zip(ref_grads, r0["grads"]))
    if not grad_err <= 1e-4:
        fail(f"mesh_train: step 1's gathered gradients differ from one process's by {grad_err:.3e} "
             f"of a leaf's largest")
    for r in ranks:
        for name, got, want in (("loss", r["losses"], losses), ("grad norm", r["grad_norms"], gnorms)):
            if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(got, want)):
                fail(f"mesh_train: rank at {r['coords']}: {name}es {got} != one process's {want}")
        if r["launches"]:
            fail(f"mesh_train: kernels launched on rank {r['coords']}: {r['launches']}")
    if digests != r0["digests"]:
        bad = sum(a != b for a, b in zip(digests, r0["digests"]))
        fail(f"mesh_train: {bad} restored leaves are not bitwise the gathered shards")
    param_err = max(float((a - b).abs().max()) for a, b in zip(ref_params, got_params))
    if not param_err < 1e-4:
        fail(f"mesh_train: params after step {MESH_TRAIN_STEPS} differ from one process's by "
             f"{param_err:.3e}")
    _, o_spec, _ = train_state_shardings(model, cfg, make_test_mesh(*MESH_SHAPE), batches[0],
                                         opt_cfg)
    sizes = dict(zip(("data", "model"), MESH_SHAPE))
    mu_leaves = target["opt"]["mu"]
    for r in ranks:
        want = sum(shard_numel(v.shape, sp, sizes) for v, sp in
                   zip(tree_leaves(mu_leaves), spec_leaves(mu_leaves, o_spec["mu"])))
        if r["mu_numel"] != want or not want < n_params:
            fail(f"mesh_train: rank at {r['coords']} holds {r['mu_numel']} mu elements; the "
                 f"specs give {want} of {n_params}")
    with torch.no_grad():
        seq = []
        for mb in range(PIPE_MICRO):
            h = x[mb]
            for s in range(PIPE_STAGES):
                h = stage(tree_map(lambda a: a[s], blocks), h)
            seq.append(h)
        seq = torch.stack(seq).cpu()
    scale = float(seq.abs().max())
    pipe_err = float((torch.from_numpy(r0["pipe"]) - seq).abs().max()) / scale
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    if not pipe_err <= 1e-5:
        fail(f"mesh_train: the pipeline differs from the sequential blocks by {pipe_err:.3e} of "
             f"the largest |value|")
    for r in ranks:
        if r["pipe_calls"] != PIPE_MICRO:
            fail(f"mesh_train: the stage at {r['coords']} ran {r['pipe_calls']} times, not once "
                 f"a microbatch ({PIPE_MICRO})")
        pg = r["pipe_grads"]
        if not (pg["w_err"] <= 1e-4 and pg["x_err"] <= 1e-4):
            fail(f"mesh_train: the pipeline's gradients at stage {pg['stage']} differ from the "
                 f"sequential blocks' by {pg['w_err']:.3e} (weights) and {pg['x_err']:.3e} (x) "
                 f"of the largest |value|")
    if sorted(r["pipe_grads"]["stage"] for r in ranks) != list(range(PIPE_STAGES)):
        fail(f"mesh_train: the pipeline's stages {[r['pipe_grads']['stage'] for r in ranks]}")
    grad_w = max(r["pipe_grads"]["w_err"] for r in ranks)
    grad_x = max(r["pipe_grads"]["x_err"] for r in ranks)
    after = kernel_counts(K)
    if after != before:
        fail(f"mesh_train: kernels launched: "
             f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }")
    del blocks, x, seq

    ms_b = [r["ms"] for r in ranks]
    peaks = [r["peak"] / 1e9 for r in ranks]
    stats = {
        "arch": cfg.name, "layers": cfg.plan.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "mesh": dict(zip(("data", "model"), MESH_SHAPE)),
        "backend": r0["backend"], "steps": MESH_TRAIN_STEPS,
        "one_process_ms_per_step": ms_a, "one_process_peak_gb": peak_a / 1e9,
        "mesh_ms_per_step_by_rank": ms_b, "mesh_peak_gb_by_rank": peaks,
        "mesh_peak_gb_sum": sum(peaks), "bytes_a_step_rank0": r0["traffic"][-1],
        "losses": losses, "grad_norms": gnorms, "grad_err": grad_err, "param_err": param_err,
        "mu_numel_by_rank": [r["mu_numel"] for r in ranks],
        "rank0_clock_s": r0["clock"], "restore_s": restore_s, "main_digest_s": digest_s,
        "one_process_s": one_s, "spawn_s": spawn_s,
        "pipeline": {"stages": PIPE_STAGES, "micro": PIPE_MICRO, "ticks": ticks,
                     "bubble": (PIPE_STAGES - 1) / ticks, "err": pipe_err,
                     "s": r0["pipe_s"], "grad_w_err": grad_w, "grad_x_err": grad_x,
                     "grad_s": r0["pipe_grads"]["s"]},
        "launches": 0,
    }
    say(f"  23b mesh {stats['mesh']} ({r0['backend']}, four ranks on one card: functional; "
        f"gloo through the host, no DP or TP speed): ms a step by rank "
        f"{[[round(v, 1) for v in ms] for ms in ms_b]}; peak GB a rank "
        f"{[round(p, 2) for p in peaks]}, sum {sum(peaks):.2f}; bytes a step (rank 0) gathered "
        f"{r0['traffic'][-1]['gathered'] / 1e9:.3f} GB, all-reduced "
        f"{r0['traffic'][-1]['reduced'] / 1e9:.3f} GB; step-1 gradients within {grad_err:.2e} of "
        f"a leaf's largest, params within {param_err:.2e}, losses and grad norms within 1e-5; "
        f"mu a rank {stats['mu_numel_by_rank']} of {n_params}; checkpoint save "
        f"{r0['clock']['save_s']:.1f} s, restored on one device bitwise the gathered shards "
        f"(sha256 a leaf) in {restore_s:.1f} s; seconds: 23a {one_s:.1f}, ranks {spawn_s:.1f} "
        f"(rank 0: {json.dumps({k: round(v, 1) for k, v in r0['clock'].items()})}), "
        f"digests here {digest_s:.1f} [{card}]")
    say(f"  23c pipeline: {PIPE_STAGES} stages x {PIPE_MICRO} microbatches of "
        f"(1, {TRAIN_SEQ}, {cfg.d_model}) in {ticks} ticks, bubble {PIPE_STAGES - 1}/{ticks} = "
        f"{(PIPE_STAGES - 1) / ticks:.4f}, within {pipe_err:.2e} of the sequential blocks, "
        f"{r0['pipe_s']:.2f} s; backward (the same loss on every rank): each stage's weight "
        f"gradients within {grad_w:.2e} and x's within {grad_x:.2e} of the sequential blocks' "
        f"largest |value| (one process), {r0['pipe_grads']['s']:.2f} s; no kernel launched "
        f"[{card}]")
    serve = mesh_serve_gates(ranks, card)
    # The paths' own launches only: rank 0's one-process reference is not the
    # path, and its launches stay in the phase record ("reference").
    launches = {k: 0 for k in kernel_counts(K)}
    for r in ranks:
        for rec in r["serve"]["paths"].values():
            for k, v in rec["launches"].items():
                launches[k] += v
    return stats, serve, launches


# --------------------------------------------------------------------------- #
# phase 25: the dry run on the host
# --------------------------------------------------------------------------- #

def dryrun_phase(train_record, card):
    """Phase 25 (see the module docstring).  Returns its record."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.cells import build_cell
    from repro_torch.tools.roofline import H100, analyze, model_flops_for
    cfg = get_config("gemma3-1b").with_overrides(dtype="float32", param_dtype="float32")
    shape = ShapeCfg("phase22", "train", TRAIN_SEQ, TRAIN_BATCH)
    t = time.perf_counter()
    cell = build_cell("gemma3-1b", shape, None, cfg=cfg)
    low = cell.lower()
    lower_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in tree_leaves(cell.args["params"]))
    want = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    rep = analyze(cell.name, "one device", 1, low.cost(), "",
                  model_flops=model_flops_for(cfg, "train", TRAIN_SEQ, TRAIN_BATCH),
                  bytes_per_device=low.bytes_per_device, collectives=low.collectives)
    measured = train_record["ms_per_step_median_2_to_8"]
    if not (rep.hlo_flops > 0 and low.bytes_accessed > 0):
        fail(f"dryrun: phase 22's step lowered to {rep.hlo_flops} FLOPs and "
             f"{low.bytes_accessed} bytes")
    say(f"  25 phase 22's step on fake tensors in {lower_s:.1f} s: {rep.hlo_flops / 1e12:.3f} "
        f"TFLOP counted (FlopCounterMode, remat's recompute included) against train_flops' "
        f"{want / 1e12:.3f} (ratio {rep.hlo_flops / want:.4f}, not gated); bytes accessed "
        f"{low.bytes_accessed / 1e9:.2f} GB (unfused), arguments {low.bytes_per_device / 1e9:.2f} "
        f"GB; roofline on H100 datasheet constants ({H100.peak_flops / 1e12:.0f} TFLOP/s, "
        f"{H100.hbm_bw / 1e12:.2f} TB/s; derived, not measured): compute "
        f"{rep.compute_s * 1e3:.2f} ms, memory {rep.memory_s * 1e3:.2f} ms, bottleneck "
        f"{rep.bottleneck}, against phase 22's measured median step {measured:.2f} ms [{card}]")
    out_dir = tempfile.mkdtemp(prefix="phase25_dryrun_", dir=ROOT / "build")
    t = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma3-1b", "--shape",
             "decode_32k", "--mesh", "single", "--out", out_dir], capture_output=True, text=True,
            timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        cell_s = time.perf_counter() - t
        if res.returncode != 0:
            fail(f"dryrun: launch.dryrun exited {res.returncode}:\n{res.stdout[-2000:]}\n"
                 f"{res.stderr[-2000:]}")
        rec = json.loads((Path(out_dir) / "gemma3-1b__decode_32k__single.json").read_text())
    finally:
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)
    if not (rec["status"] == "ok" and rec["hlo_flops"] > 0 and rec["wire_bytes_per_chip"] > 0):
        fail(f"dryrun: the production cell's record: status {rec['status']}, flops "
             f"{rec.get('hlo_flops')}, wire {rec.get('wire_bytes_per_chip')}: "
             f"{rec.get('error', '')}")
    keys = ("hlo_flops", "hlo_bytes", "wire_bytes_per_chip", "per_type", "counts",
            "bytes_per_device", "compute_s", "memory_s", "collective_s", "bottleneck",
            "useful_ratio", "chips", "lower_s", "compile_s")
    cell_rec = {k: rec[k] for k in keys}
    say(f"  25 production cell gemma3-1b/decode_32k on one rank of (data 16, model 16) "
        f"(subprocess {cell_s:.1f} s): {json.dumps(cell_rec)} (H100 datasheet roofline, "
        f"derived) [{card}]")
    return {"phase22_step": {"flops": rep.hlo_flops, "train_flops": want,
                             "ratio": rep.hlo_flops / want, "bytes_accessed": low.bytes_accessed,
                             "arg_bytes": low.bytes_per_device, "roofline_s": rep.roofline_s,
                             "compute_s": rep.compute_s, "memory_s": rep.memory_s,
                             "bottleneck": rep.bottleneck, "measured_ms": measured,
                             "lower_s": lower_s},
            "decode_32k_single": cell_rec, "subprocess_s": cell_s}


# --------------------------------------------------------------------------- #
# phase 18: tensor-parallel serving, two ranks on one card over gloo
# --------------------------------------------------------------------------- #

TP_DEGREE = 2
TP_LAYERS = SERVE_LAYERS         # phi3-mini's depth here (of 32): the script's time limit
TP_HEAL_CALLS = (9, 40)          # stepper calls that raise on every rank (a prefill, a decode)
# tree decode shapes: (tag, B, Hq, Hk, D, S, lengths) — phase 3's engine decode and
# gemma3-1b's global decode
TREE_SHAPES = (("phi3-mini engine decode", 4, 32, 32, 96, 1024, (731, 400, 129, 0)),
               ("gemma3-1b global decode", 4, 4, 1, 256, 2048, (1400, 1000, 600, 250)))
TP_MODES = (("dense", {}), ("paged fp32", dict(paged=True, kv_dtype="float32")),
            ("paged int8", dict(paged=True, kv_dtype="int8")))


def tp_engine_kwargs(mode, page, pools):
    kw = dict(TP_MODES)[mode]
    if not kw:
        return {}
    return dict(kw, page_size=page, n_blocks=pools["int8" if kw["kv_dtype"] == "int8" else "fp32"])


def tp_requests(cfg, n_requests=8):
    """Phase 5's requests (the same seeded prompts), fresh."""
    import numpy as np
    from repro_torch.runtime.engine import EngineRequest
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, cfg.vocab, int(rng.integers(128, 701))).astype(np.int32))
            for i in range(n_requests)]


def _on_card(torch, dev, fn, *args):
    """``torch.cuda.<fn>(*args)`` on a card, else nothing (a CPU rehearsal)."""
    return getattr(torch.cuda, fn)(*args) if dev.type == "cuda" else 0


def tp_serve(torch, K, engine, prompts, max_new, inject=()):
    """Serve ``prompts`` once on a (rank's) engine: tokens, launches,
    tick numbers and the peak memory."""
    from repro_torch.runtime.engine import EngineRequest
    dev = engine.stepper.device
    if inject:
        calls = [0]
        for phase in ("decode", "prefill"):
            orig = getattr(engine.stepper, phase)

            def wrapped(*args, _orig=orig):
                calls[0] += 1
                if calls[0] in inject:
                    raise RuntimeError(f"injected fault at call {calls[0]}")
                return _orig(*args)
            setattr(engine.stepper, phase, wrapped)
    reqs = [EngineRequest(uid=i, prompt=p, max_new_tokens=max_new) for i, p in prompts]
    _on_card(torch, dev, "synchronize", dev)
    _on_card(torch, dev, "reset_peak_memory_stats", dev)
    for kern in K.KERNELS:
        kern.launches = 0
    for r in reqs:
        if not engine.submit(r):
            raise RuntimeError(f"request {r.uid} rejected: {r.dropped}")
    t0 = time.perf_counter()
    engine.run()
    _on_card(torch, dev, "synchronize", dev)
    wall = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    m = engine.metrics
    if any(not r.done or len(r.out_tokens) != max_new for r in reqs):
        raise RuntimeError("not every request finished with its tokens")
    return {"tokens": {r.uid: list(r.out_tokens) for r in reqs}, "launches": launches,
            "stats": {"tokens_per_s": m.tokens_per_s, "engine_wall_s": wall,
                      "decode_ms_per_tick": 1e3 * m.decode_wall_s / max(m.decode_ticks, 1),
                      "prefill_ms_per_tick": 1e3 * m.prefill_wall_s / max(m.prefill_ticks, 1),
                      "decode_ticks": m.decode_ticks, "prefill_ticks": m.prefill_ticks,
                      "recoveries": m.n_recoveries, "crash_failures": m.n_crash_failures,
                      "recovered_rows": m.recovered_rows,
                      "max_memory_allocated_gb":
                          _on_card(torch, dev, "max_memory_allocated", dev) / 1e9}}


def tp_gather_profile(torch, engine, prompts, rank, n_requests=2, max_new=8):
    """The all-gathers' share of the ticks of a short extra run (the first
    ``n_requests`` prompts, ``max_new`` tokens) on a TP engine, profiled
    with torch.profiler on rank 0; the other ranks serve it unprofiled, in
    step.  A gather spans from its call (``c10d::allgather_``, on the
    serving thread) to the end of its gloo work (``gloo:all_gather``, on
    gloo's thread), which the caller waits for; the span includes waiting
    for the device work queued before the gather's input.  None off rank
    0."""
    from repro_torch.runtime.engine import EngineRequest
    m = engine.metrics
    before = m.decode_wall_s + m.prefill_wall_s
    for i, p in prompts[:n_requests]:
        if not engine.submit(EngineRequest(uid=10_000 + i, prompt=p, max_new_tokens=max_new)):
            raise RuntimeError(f"profiled request {i} rejected")
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            if rank == 0 else None)
    if prof is not None:
        prof.start()
    engine.run()
    _on_card(torch, engine.stepper.device, "synchronize", engine.stepper.device)
    if prof is None:
        return None
    prof.stop()
    tick_s = m.decode_wall_s + m.prefill_wall_s - before
    events = prof.events()
    calls = sorted(float(ev.time_range.start) for ev in events if ev.name == "c10d::allgather_")
    ends = sorted(float(ev.time_range.end) for ev in events if ev.name == "gloo:all_gather")
    if not calls or len(calls) != len(ends):
        names = sorted({ev.name for ev in events if "gather" in ev.name.lower()})
        raise RuntimeError(f"profile: {len(calls)} gather calls, {len(ends)} gloo gathers "
                           f"(events {names})")
    span_s = sum(e - c for c, e in zip(calls, ends)) / 1e6
    return {"gathers": len(calls), "gather_s": span_s, "tick_s": tick_s,
            "share_of_ticks": span_s / tick_s}


def tp_local_kernels(torch, K, cfg, dev, *, n_slots, chunk, cache_cap, page, pools):
    """Each attention kernel of the tp nodes at one rank's shapes (Hq / TP_DEGREE
    query and Hk / TP_DEGREE kv heads; phase 3's lengths, starts and page
    pools) against its plain version on the same inputs, at phase 3's
    tolerance.  Returns {kernel [mode]: max |err|}; raises on a miss."""
    hq, hk, dh = cfg.n_heads // TP_DEGREE, cfg.n_kv_heads // TP_DEGREE, cfg.d_head
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    errs = {}

    def check(name, got, want, atol=1e-4, rtol=1e-4):
        diff = (got - want).abs()
        if bool((diff > atol + rtol * want.abs()).any()):
            raise RuntimeError(f"{name} at {hq} of {cfg.n_heads} heads: max |err| "
                               f"{float(diff.max()):.3e} exceeds atol {atol} + rtol {rtol}*|plain|")
        errs[name] = float(diff.max())

    sc = 1.0 / math.sqrt(dh)
    lens, starts = [731, 400, 129, 0], [640, 320, 64, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    q, qc = rn(n_slots, hq, dh), rn(n_slots, chunk, hq, dh)
    k, v = rn(n_slots, cache_cap, hk, dh), rn(n_slots, cache_cap, hk, dh)
    check("flash_decode", K.flash_decode(q, k, v, lengths),
          K.flash_decode_plain(q, k, v, lengths, sc))
    check("flash_chunk_attention", K.flash_chunk_attention(qc, k, v, start),
          K.flash_chunk_attention_plain(qc, k, v, start, sc))
    del k, v
    mp = cache_cap // page
    for mode, n_blocks in pools.items():
        quant = mode == "int8"
        pk, pv, tables, scs = paged_layout(torch, g, b=n_slots, n=n_blocks, page=page, mp=mp,
                                           hk=hk, d=dh, dv=dh, lengths=lens, quant=quant)
        check(f"flash_paged_decode {mode}", K.flash_paged_decode(q, pk, pv, tables, lengths, **scs),
              K.flash_paged_decode_plain(q, pk, pv, tables, lengths, sc, scs.get("k_scales"),
                                         scs.get("v_scales")))
        pk, pv, tables, scs = paged_layout(torch, g, b=n_slots, n=n_blocks, page=page, mp=mp,
                                           hk=hk, d=dh, dv=dh,
                                           lengths=[s0 + chunk for s0 in starts], quant=quant)
        check(f"flash_paged_chunk_attention {mode}",
              K.flash_paged_chunk_attention(qc, pk, pv, tables, start, **scs),
              K.flash_paged_chunk_attention_plain(qc, pk, pv, tables, start, sc,
                                                  scs.get("k_scales"), scs.get("v_scales")))
        del pk, pv
    return errs


def tp_probe_rank(device):
    """gloo's batch_isend_irecv on CUDA tensors, directly (no staging): a
    rank of the pair returns what came back; gloo may abort the process
    instead."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(TP_DEGREE, device=device)
    x = torch.full((4, 8), float(mesh.rank + 1), device=mesh.device)
    out = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, (mesh.rank + 1) % TP_DEGREE),
        dist.P2POp(dist.irecv, out, (mesh.rank - 1) % TP_DEGREE)])
    for w in works:
        w.wait()
    _on_card(torch, mesh.device, "synchronize")
    return out.cpu().tolist()


def tp_rank(cfg_kw, n_slots, chunk, cache_cap, page, pools, max_new, prompts, device):
    """One rank of phase 18 (run by spawn_ranks): the weights of seed 0 on
    the card, the three TP engines (each followed by a short run profiled
    on rank 0), the crash-injected paged fp32 engine, the attention kernels
    at the rank's heads against their plain versions, the ring matmul,
    then tree decode.  Returns what the parent checks and prints."""
    sys.path.insert(0, str(ROOT / "src"))
    import gc as gc_
    import torch
    from repro_torch.kernels.serving_ops import TP_ATTENTION_OPS
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params_torch
    from repro_torch.runtime.engine import build_lm_serving
    from repro_torch.sharding.collectives import ring_allgather_matmul, tree_decode_attention
    K = Kernels()
    cfg = GraphLMConfig(**cfg_kw)
    mesh = make_serving_mesh(TP_DEGREE, device=device)
    if mesh.device != torch.device(device) or mesh.backend != "gloo":
        raise RuntimeError(f"rank on {mesh.device} over {mesh.backend}, not {device} over gloo")
    t0 = time.perf_counter()
    params = init_lm_params_torch(cfg, seed=0, device=mesh.device)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
           "weights_s": time.perf_counter() - t0, "engines": {}}
    for mode, inject in (("dense", ()), ("paged fp32", ()), ("paged int8", ()),
                         ("heal paged fp32", TP_HEAL_CALLS)):
        base = mode.replace("heal ", "")
        t0 = time.perf_counter()
        engine = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap,
                                  params=params, mesh=mesh, self_heal=bool(inject),
                                  **tp_engine_kwargs(base, page, pools))[0]
        build_s = time.perf_counter() - t0
        nodes = {}
        for phase, prog in (("decode", engine.stepper.decode_program),
                            ("prefill", engine.stepper.prefill_program)):
            asn = prog.assignment
            attn = [n.name for n in prog.graph.nodes if n.op in TP_ATTENTION_OPS]
            if not attn or any(asn[n] != "tp" for n in attn):
                raise RuntimeError(f"{mode} {phase}: attention not on tp: "
                                   f"{ {n: asn[n] for n in attn} }")
            nodes[phase] = attn
        heads = sorted({int(c.shape[2]) for c in engine.stepper.caches.values() if c.dim() == 4})
        run = tp_serve(torch, K, engine, prompts, max_new, inject=inject)
        run["gather_profile"] = (None if inject else
                                 tp_gather_profile(torch, engine, prompts, mesh.rank))
        run.update(build_s=build_s, tp_nodes={p: len(v) for p, v in nodes.items()},
                   tp_node_names={p: v[:2] + ["..."] for p, v in nodes.items()},
                   local_cache_heads=heads)
        out["engines"][mode] = run
        del engine
        gc_.collect()
        _on_card(torch, mesh.device, "empty_cache")
    del params
    gc_.collect()
    _on_card(torch, mesh.device, "empty_cache")
    out["local_kernels"] = tp_local_kernels(torch, K, cfg, mesh.device, n_slots=n_slots,
                                            chunk=chunk, cache_cap=cache_cap, page=page,
                                            pools=pools)
    # the ring matmul at the engine's decode gemm (M = n_slots x TP_DEGREE rows in all):
    # over gloo its chunks travel through host memory
    g = torch.Generator(device=mesh.device)
    g.manual_seed(19)
    x = torch.randn((n_slots * TP_DEGREE, cfg.d_model), generator=g, device=mesh.device)
    w = torch.randn((cfg.d_model, cfg.d_ff), generator=g, device=mesh.device) \
        / math.sqrt(cfg.d_model)
    rows = slice(mesh.rank * n_slots, (mesh.rank + 1) * n_slots)
    before = K.gemm.launches
    got = ring_allgather_matmul(mesh, x[rows].contiguous(), w)
    launched = K.gemm.launches - before
    want = K.gemm_plain(x, w)
    bad = (got - want).abs() > 1e-4 + 1e-4 * want.abs()
    if got.device != mesh.device or bool(bad.any()):
        raise RuntimeError(f"ring_allgather_matmul on {got.device}: max |err| "
                           f"{float((got - want).abs().max()):.3e} against the whole product")
    out["ring"] = {"max_abs_err": float((got - want).abs().max()), "gemm_launches": launched,
                   "shape": f"M={x.shape[0]} K={cfg.d_model} N={cfg.d_ff}"}
    del x, w, got, want
    out["tree"] = []
    for tag, b, hq, hk, d, s_len, lens in TREE_SHAPES:
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(18)
        q = torch.randn((b, hq, d), generator=gen, device=mesh.device)
        k = torch.randn((b, s_len, hk, d), generator=gen, device=mesh.device)
        v = torch.randn((b, s_len, hk, d), generator=gen, device=mesh.device)
        lengths = torch.tensor(lens, dtype=torch.int32, device=mesh.device)
        part = s_len // TP_DEGREE
        rows = slice(mesh.rank * part, (mesh.rank + 1) * part)
        k_loc, v_loc = k[:, rows].contiguous(), v[:, rows].contiguous()
        want = K.flash_decode(q, k, v, lengths)
        before = K.flash_decode_partial.launches
        got = tree_decode_attention(mesh, q, k_loc, v_loc, lengths)
        _on_card(torch, mesh.device, "synchronize")
        launched = K.flash_decode_partial.launches - before
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"tree decode {tag}: non-finite output")
        times = []
        for _ in range(5):
            _on_card(torch, mesh.device, "synchronize")
            t0 = time.perf_counter()
            tree_decode_attention(mesh, q, k_loc, v_loc, lengths)
            _on_card(torch, mesh.device, "synchronize")
            times.append(time.perf_counter() - t0)
        out["tree"].append({"shape": tag, "max_abs_err": err, "partial_launches": launched,
                            "host_ms_median_of_5": 1e3 * sorted(times)[2]})
    out["peak_gb"] = _on_card(torch, mesh.device, "max_memory_allocated", mesh.device) / 1e9
    return out


def tp_phase(torch, K, cfg, *, n_slots, chunk, cache_cap, page, pools, max_new,
             card, device="cuda:0"):
    """Phase 18 (see the module docstring), at TP_LAYERS of ``cfg``'s depth.
    The parent draws the seed-0 weights at that depth, as the ranks draw
    theirs, serves the three single-rank engines on them, then drops the
    engines and the weights before the ranks start.  Returns ({path:
    (launches, stats)}, the serving record)."""
    import dataclasses
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.graph_lm import init_lm_params_torch
    from repro_torch.runtime.engine import build_lm_serving
    cfg = dataclasses.replace(cfg, n_layers=TP_LAYERS)
    params = init_lm_params_torch(cfg, seed=0, device=device)
    prompts = tp_requests(cfg)
    single = {}
    for mode, _ in TP_MODES:
        t0 = time.perf_counter()
        # the reference is not kept: it would hold the weights past their release
        engine = build_lm_serving(cfg, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap,
                                  params=params, device=device,
                                  **tp_engine_kwargs(mode, page, pools))[0]
        single[mode] = tp_serve(torch, K, engine, prompts, max_new)
        single[mode]["build_s"] = time.perf_counter() - t0
        st = single[mode]["stats"]
        say(f"  [single {mode}] {st['prefill_ticks']} prefill + {st['decode_ticks']} decode "
            f"ticks, decode {st['decode_ms_per_tick']:.2f} ms, prefill "
            f"{st['prefill_ms_per_tick']:.2f} ms a tick, {st['tokens_per_s']:.2f} tokens/s, "
            f"peak {st['max_memory_allocated_gb']:.2f} GB [{card}]")
        del engine
        release(torch)
    del params
    release(torch)
    say(f"  the parent's engines and weights released: "
        f"{_on_card(torch, torch.device(device), 'memory_allocated') / 1e9:.2f} GB allocated "
        f"here [{card}]")
    # gloo's point-to-point ops on CUDA tensors, alone in a pair of ranks:
    # why the ring matmul stages its chunks through host memory (the engines
    # and tree decode send all_gather and all_reduce directly)
    t0 = time.perf_counter()
    try:
        got = spawn_ranks(tp_probe_rank, TP_DEGREE, device, timeout=120)
        probe = "taken" if got[0] == [[2.0] * 8] * 4 else f"wrong result {got[0][:1]}"
    except RuntimeError as e:
        probe = "refused (" + str(e).splitlines()[-1][:120] + ")"
    say(f"  [probe] gloo batch_isend_irecv on CUDA tensors, direct: {probe} "
        f"({time.perf_counter() - t0:.1f} s)")
    transport = {"all_gather": "direct", "all_reduce": "direct",
                 "batch_isend_irecv": "host-staged"}
    cfg_kw = {f: getattr(cfg, f) for f in ("vocab", "d_model", "n_layers", "n_heads",
                                           "n_kv_heads", "d_ff")}
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, TP_DEGREE, cfg_kw, n_slots, chunk, cache_cap, page, pools,
                        max_new, prompts, device, timeout=900)
    spawn_s = time.perf_counter() - t0
    say(f"  ranks: {[(r['rank'], r['device'], r['backend']) for r in ranks]}; transport "
        f"{json.dumps(transport)}; {spawn_s:.1f} s from spawn to the ranks' results [{card}]")
    runs, record = {}, {"single": {m: v["stats"] for m, v in single.items()},
                        "probe_batch_isend_irecv": probe,
                        "transport": transport, "backend": "gloo",
                        "devices": [r["device"] for r in ranks], "spawn_s": spawn_s,
                        "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
                        "weights_s_by_rank": [r["weights_s"] for r in ranks], "card": card}
    n_layers = cfg.n_layers
    for mode in [m for m, _ in TP_MODES] + ["heal paged fp32"]:
        base = mode.replace("heal ", "")
        want = single[base]["tokens"]
        paged = base != "dense"
        dec_k = "flash_paged_decode" if paged else "flash_decode"
        pre_k = "flash_paged_chunk_attention" if paged else "flash_chunk_attention"
        by_rank = []
        for r in ranks:
            run = r["engines"][mode]
            st = run["stats"]
            if run["tokens"] != want:
                uid = next(u for u in want if run["tokens"][u] != want[u])
                fail(f"tp {mode} rank {r['rank']}: request {uid} tokens "
                     f"{run['tokens'][uid]} != single-rank {want[uid]}")
            heads = cfg.n_kv_heads // TP_DEGREE
            if run["local_cache_heads"] != [heads]:
                fail(f"tp {mode} rank {r['rank']}: cache heads {run['local_cache_heads']}")
            la = run["launches"]
            ticks = st["prefill_ticks"] + st["decode_ticks"]
            if mode.startswith("heal"):
                if st["recoveries"] != len(TP_HEAL_CALLS) or \
                        st["crash_failures"] != len(TP_HEAL_CALLS):
                    fail(f"tp {mode} rank {r['rank']}: {st['recoveries']} recoveries, "
                         f"{st['crash_failures']} crashes; {len(TP_HEAL_CALLS)} injected")
            else:
                expect = {"gemm": (7 * n_layers + 1) * ticks, "rmsnorm": (2 * n_layers + 1) * ticks,
                          dec_k: n_layers * st["decode_ticks"],
                          "combine_partials": n_layers * st["decode_ticks"],
                          pre_k: n_layers * st["prefill_ticks"]}
                for name, n in la.items():
                    if n != expect.get(name, 0):
                        fail(f"tp {mode} rank {r['rank']}: {name} {n} launches, expected "
                             f"{expect.get(name, 0)}")
            by_rank.append(run)
        s0, s1 = by_rank[0]["stats"], single[base]["stats"]
        launches = {k: sum(run["launches"][k] for run in by_rank) for k in by_rank[0]["launches"]}
        runs[f"tp {mode}"] = (launches, s0)
        record[mode] = {"rank_stats": [run["stats"] for run in by_rank],
                        "build_s": [run["build_s"] for run in by_rank],
                        "tp_nodes": by_rank[0]["tp_nodes"],
                        "launches_per_rank": by_rank[0]["launches"],
                        "gather_profile_rank0": by_rank[0]["gather_profile"]}
        say(f"  [tp {mode}] token-exact on both ranks against the single-rank engine "
            f"({len(want)} requests x {max_new}); tp nodes {by_rank[0]['tp_node_names']} "
            f"({by_rank[0]['tp_nodes']} a Program), {dec_k} / {pre_k} at "
            f"{cfg.n_heads // TP_DEGREE} of {cfg.n_heads} query heads and "
            f"{cfg.n_kv_heads // TP_DEGREE} of {cfg.n_kv_heads} kv heads a rank; launches a "
            f"rank {json.dumps({k: v for k, v in by_rank[0]['launches'].items() if v})}")
        say(f"  [tp {mode}] rank 0: decode {s0['decode_ms_per_tick']:.2f} ms a tick (single "
            f"{s1['decode_ms_per_tick']:.2f}), prefill {s0['prefill_ms_per_tick']:.2f} ms "
            f"(single {s1['prefill_ms_per_tick']:.2f}), {s0['tokens_per_s']:.2f} tokens/s "
            f"(single {s1['tokens_per_s']:.2f}); peak "
            f"{[round(run['stats']['max_memory_allocated_gb'], 2) for run in by_rank]} GB a "
            f"rank; recoveries {s0['recoveries']} [{card}]")
        prof = by_rank[0]["gather_profile"]
        if prof is not None:
            say(f"  [tp {mode}] rank 0, a short run under torch.profiler (2 requests x 8 new): "
                f"{prof['gathers']} all-gathers, {prof['gather_s']:.3f} s of "
                f"{prof['tick_s']:.3f} s of ticks = {100 * prof['share_of_ticks']:.1f}% "
                f"(from the call to the end of gloo's work) [{card}]")
    for r in ranks:
        say(f"  [tp kernels] rank {r['rank']}: at {cfg.n_heads // TP_DEGREE} of {cfg.n_heads} "
            f"heads against the plain versions (atol 1e-4 + rtol 1e-4), max |err| "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in r['local_kernels'].items()})}; "
            f"ring_allgather_matmul {r['ring']['shape']} (chunks host-staged over gloo) "
            f"{r['ring']['max_abs_err']:.3e} from the whole product, "
            f"{r['ring']['gemm_launches']} gemm launches [{card}]")
        if r["ring"]["gemm_launches"] != TP_DEGREE:
            fail(f"ring_allgather_matmul rank {r['rank']}: {r['ring']['gemm_launches']} gemm "
                 f"launches, expected {TP_DEGREE}")
    record["local_kernels"] = [r["local_kernels"] for r in ranks]
    record["ring"] = [r["ring"] for r in ranks]
    tree_launches = {k.__name__: 0 for k in K.KERNELS}
    for r in ranks:
        for row in r["tree"]:
            if row["max_abs_err"] > 1e-4:
                fail(f"tree decode {row['shape']} rank {r['rank']}: max |err| "
                     f"{row['max_abs_err']:.3e} against flash_decode (1e-4)")
            if row["partial_launches"] != 1:
                fail(f"tree decode {row['shape']} rank {r['rank']}: "
                     f"{row['partial_launches']} flash_decode_partial launches, expected 1")
            tree_launches["flash_decode_partial"] += row["partial_launches"]
    record["tree"] = [r["tree"] for r in ranks]
    runs["tp tree"] = (tree_launches, {"rows": record["tree"]})
    for row0, row1 in zip(ranks[0]["tree"], ranks[1]["tree"]):
        say(f"  [tp tree] {row0['shape']}: max |err| against flash_decode {row0['max_abs_err']:.3e}"
            f" / {row1['max_abs_err']:.3e} (ranks 0 / 1; 1e-4), flash_decode_partial launches "
            f"{row0['partial_launches']} / {row1['partial_launches']}, host ms (sync, gloo "
            f"all_reduce included) {row0['host_ms_median_of_5']:.3f} [{card}]")
    say(f"  peak GB a rank {[round(r['peak_gb'], 2) for r in ranks]}; two ranks on one card "
        f"over gloo check the sharded path, they do not measure TP speed [{card}]")
    return runs, record


class Kernels:
    """The port's kernel wrappers and their plain versions."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ssd
        from repro_torch.kernels.gemm import (BF16_TILES, SKINNY_MAX_M, batched_gemm,
                                              batched_gemm_plain, gemm, gemm_bf16_plan,
                                              gemm_plain, gemm_tile, gemm_variant)
        from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
        self.gemm, self.gemm_plain = gemm, gemm_plain
        self.gemm_variant, self.gemm_tile = gemm_variant, gemm_tile
        self.gemm_bf16_plan, self.BF16_TILES = gemm_bf16_plan, BF16_TILES
        self.SKINNY_MAX_M = SKINNY_MAX_M
        self.batched_gemm, self.batched_gemm_plain = batched_gemm, batched_gemm_plain
        self.ssd_scan, self.ssd_scan_plain = ssd.ssd_scan, ssd.ssd_scan_plain
        self.rmsnorm, self.rmsnorm_plain = rmsnorm, rmsnorm_plain
        self.flash_decode, self.flash_decode_plain = fd.flash_decode, fd.flash_decode_plain
        self.decode_plan_bf16 = fd.decode_plan_bf16
        self.flash_chunk_attention = fa.flash_chunk_attention
        self.flash_chunk_attention_plain = fa.flash_chunk_attention_plain
        self.flash_paged_decode = fd.flash_paged_decode
        self.flash_paged_decode_plain = fd.flash_paged_decode_plain
        self.flash_paged_chunk_attention = fa.flash_paged_chunk_attention
        self.flash_paged_chunk_attention_plain = fa.flash_paged_chunk_attention_plain
        self.flash_attention = fa.flash_attention
        self.flash_attention_plain = fa.flash_attention_plain
        self.gather_pages = fd.gather_pages
        self.flash_decode_partial = fd.flash_decode_partial
        self.flash_decode_partial_plain = fd.flash_decode_partial_plain
        self.combine_partials = fd.combine_partials
        self.decode_shard_rows = fd.decode_shard_rows
        self.attention_shard_cols = fa.attention_shard_cols
        self.attention_shard_cols_bf16 = fa.attention_shard_cols_bf16
        from repro_torch.kernels.ref import combine_partials_ref
        self.combine_partials_ref = combine_partials_ref
        from repro_torch.kernels._cuda import empty_launch
        self.empty_launch = empty_launch
        from repro_torch.kernels.ops import decode_attention
        self.decode_attention = decode_attention
        # each wrapper's fp32 count, then the bf16 entries' (wrapper.bf16)
        self.KERNELS = (gemm, rmsnorm, fd.flash_decode, fa.flash_chunk_attention,
                        fd.flash_paged_decode, fa.flash_paged_chunk_attention,
                        fa.flash_attention, batched_gemm, ssd.ssd_scan,
                        fd.flash_decode_partial, fd.combine_partials,
                        gemm.bf16, rmsnorm.bf16, fd.flash_decode.bf16, fa.flash_attention.bf16,
                        fd.combine_partials.bf16, batched_gemm.bf16, ssd.ssd_scan.bf16,
                        fd.flash_decode_partial.bf16)


SOURCES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:64"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:39"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:148"),
    "flash_chunk_attention": ("src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:207"),
    "flash_paged_decode": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:206"),
    "flash_paged_chunk_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:297"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:94"),
    "batched_gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:92"),
    "ssd_scan": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd.py:73"),
    "flash_decode_partial": ("src/repro_torch/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_decode.py:158"),
    # JAX merges the split partials in plain jnp (ops.py:201, the
    # pallas_split backend): no Pallas kernel, the port's merge is a kernel
    "combine_partials": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/ops.py:201"),
    # the bf16 entries: the same TPU kernels at bf16 inputs
    "gemm_bf16": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:64"),
    "rmsnorm_bf16": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:39"),
    "flash_decode_bf16": ("src/repro_torch/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_decode.py:148"),
    "flash_attention_bf16": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:94"),
    "combine_partials_bf16": ("src/repro_torch/csrc/flash_decode.cu",
                              "src/repro/kernels/ops.py:201"),
    "batched_gemm_bf16": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:92"),
    "ssd_scan_bf16": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd.py:73"),
    "flash_decode_partial_bf16": ("src/repro_torch/csrc/flash_decode.cu",
                                  "src/repro/kernels/flash_decode.py:158"),
}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail(f"src/repro_torch not found beside {Path(__file__).name}; run from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU", code=2)
    t_start = time.perf_counter()
    phase_s = {}

    # 1. device
    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    limit_line = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"torch.cuda.get_device_name(0) = {kind}; device_count = {count}")
    say("[device] nvidia-smi name, power.limit:")
    say(limit_line)
    phase_s["device"] = time.perf_counter() - t

    # 2. build
    t = time.perf_counter()
    from repro_torch.kernels import _cuda
    path, build_s, log = _cuda.build()
    _cuda.library()
    say(f"[build] {path.relative_to(ROOT)} built in {build_s:.1f} s "
        f"({len(_cuda.SOURCES)} nvcc processes in parallel, then one link)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"[build]   {line.strip()}")
    # the tensor-core bf16 bodies: wgmma (HGMMA) in the GEMM and attention,
    # mma.sync (HMMA) in the narrow decode
    bodies = {"GEMM": ("gemm_wgmma_kernel", "HGMMA"),
              "attention": ("attention_wgmma_kernel", "HGMMA"),
              "narrow decode": ("decode_tc_kernel", "HMMA")}
    tc = sass_counts(_cuda, path, dict(bodies.values()))
    for body, (kernel, opcode) in bodies.items():
        counts = {k: c for k, c in tc.items() if k.startswith(kernel)}
        say(f"[build] {opcode} (tensor-core) instructions in the SASS of each bf16 {body} "
            f"instance (cuobjdump -sass): {counts}")
        if not counts or not all(counts.values()):
            fail(f"the bf16 {body}'s instances issue no {opcode}: {counts}")
    if log:  # empty when an existing library was reused
        say("[build] registers and spill-store bytes of each tensor-core and bf16 rmsnorm "
            "instance (-Xptxas -v): "
            f"{ptxas_usage(log, tuple(k for k, _ in bodies.values()) + ('rmsnorm_bf16_kernel',))}")
    phase_s["build"] = time.perf_counter() - t

    from repro_torch.core.device import resolve_device
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.graph_lm import GraphLMConfig, init_lm_params_torch
    from repro_torch.runtime.kv_cache import kv_page_bytes
    resolve_device("cuda")  # pins fp32 matmuls (no TF32) for the plain versions
    K = Kernels()

    # phi3-mini-3.8b widths (src/repro/configs/phi3_mini_3_8b.py): d_model 3072,
    # 32 heads, 32 kv heads (d_head 96), SwiGLU d_ff 8192, vocab 32064, 32 layers
    # cut to SERVE_LAYERS
    cfg = GraphLMConfig(vocab=32064, d_model=3072, n_layers=SERVE_LAYERS, n_heads=32,
                        n_kv_heads=32, d_ff=8192)
    n_slots, chunk, cache_cap, page, max_new = 4, 64, 1024, 16, 32
    # the paged pools: fp32 with the dense cache's memory (build_lm_serving's
    # default), int8 with the same bytes
    n_fp32 = n_slots * (cache_cap // page)
    n_int8 = n_fp32 * kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.d_head, page) \
        // kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.d_head, page, "int8")
    pools = {"fp32": n_fp32, "int8": n_int8}
    # the layer-stack phases at published widths and bfloat16, with their new
    # tokens:
    # 8. gemma3-1b (src/repro/configs/gemma3_1b.py): d_model 1152, 4 heads on 1
    #    kv head of 256, d_ff 6912, vocab 262144 (tied), 26 layers (5 local : 1
    #    global, window 512), RoPE theta 1e6;
    # 9. qwen2-moe-a2.7b (src/repro/configs/qwen2_moe_a2_7b.py): d_model 2048,
    #    16 heads on 16 kv heads of 128, 24 layers, 64 experts (60 routed,
    #    top-4) of width 1408, a shared SwiGLU of 5632, local dispatch at
    #    capacity factor 1.25, untied vocab 151936;
    # 10. mamba2-370m (src/repro/configs/mamba2_370m.py): d_model 1024, 48
    #    layers, d_inner 2048 in 32 heads of 64, state 128, 1 group, conv 4,
    #    chunk 128, tied vocab 50280
    # 19. zamba2-7b (src/repro/configs/zamba2_7b.py): d_model 3584, 81 blocks (11
    #    periods of 6 Mamba2 + 1 shared-attention application, then 4 Mamba2),
    #    d_inner 7168 in 112 heads of 64, state 64, 1 group; two alternating
    #    shared blocks (32 heads of 112, SwiGLU 14336) on concat(h, emb0);
    #    untied vocab 32000;
    # 20. deepseek-v2-lite-16b (src/repro/configs/deepseek_v2_lite_16b.py):
    #    d_model 2048, 27 MLA + MoE layers (16 heads, latent 512, rope 64, nope
    #    128, v 128; 64 routed experts of 1408, top-6, 2 shared as one 2816-wide
    #    SwiGLU, local dispatch), untied vocab 102400
    stack_phases = [(phase, serving_config(arch, full=True, device="cuda"), STACK_NEW)
                    for phase, arch in (("layerstack", "gemma3-1b"), ("moe", "qwen2-moe-a2.7b"),
                                        ("ssm", "mamba2-370m"), ("hybrid", "zamba2-7b"),
                                        ("mla", "deepseek-v2-lite-16b"))]
    # 21. seamless-m4t-medium (src/repro/configs/seamless_m4t_medium.py): 12
    #    encoder + 12 decoder layers (self, cross, ReLU MLP 4096), d_model 1024, 16
    #    heads of 64, untied vocab 256206 (padded to 256256)
    encdec_cfg = serving_config("seamless-m4t-medium", full=True, device="cuda")

    # 3. kernels
    t = time.perf_counter()
    n_cases = kernel_cases(torch, K)
    say(f"[kernels] {n_cases} small cases match their plain versions "
        f"(atol = rtol = 2e-5); fp32 paged outputs bitwise equal to the dense kernels")
    say(f"[kernels] full-width shapes (tolerance atol = rtol = 1e-4; median of 15 "
        f"cold-L2 launches; bound from 67 TFLOP/s fp32 and 3.35 TB/s):")
    results, by_tag, ops_ms, stack_est, extra = kernels_phase(
        torch, K, cfg, [c for _, c, _ in stack_phases] + [encdec_cfg], n_slots, chunk,
        cache_cap, page, pools, limit_line)
    phase_s["kernels"] = time.perf_counter() - t

    # 4. small model, card vs CPU
    t = time.perf_counter()
    worst, worst_kv8 = model_phase(torch)
    say(f"[model] small model prefill + decode Programs, dense and paged fp32: card vs CPU "
        f"max |err| {worst:.2e} (atol = rtol = 1e-4); paged int8: max |logit err| "
        f"{worst_kv8:.2e} (bound 5e-2)")
    # the reduced configs serve fp32: the path of the fp32 entries that no
    # full-width phase runs any more (FP32_ROWS), counted as the "model" path
    for kern in K.KERNELS:
        kern.launches = 0
    for arch in ("gemma3-1b", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-7b",
                 "deepseek-v2-lite-16b"):
        worst_ls = layerstack_model_phase(torch, arch)
        say(f"[model] reduced {arch} layer-stack LM, prefill + caches + 4 decode steps: card "
            f"vs CPU max |err| {worst_ls:.2e} (atol = rtol = 1e-4)")
    model_launches = {kern.__name__: kern.launches for kern in K.KERNELS}
    say(f"[model] launches of the reduced layer-stack LMs on the card: {model_launches}")
    if not all(model_launches[name] for name in FP32_ROWS):
        fail(f"model: an fp32 entry of {FP32_ROWS} launched no time: {model_launches}")
    worst_ed = encdec_model_phase(torch)
    say(f"[model] reduced seamless-m4t-medium EncDec, encode + prefill + self and cross "
        f"caches + 4 decode steps: card vs CPU max |err| {worst_ed:.2e} (atol = rtol = 1e-4)")
    phase_s["model"] = time.perf_counter() - t

    t = time.perf_counter()
    params = init_lm_params_torch(cfg, seed=0, device="cuda")
    phase_s["weights"] = time.perf_counter() - t
    estimates, serving = {}, {}

    # 5. serving, dense cache
    t = time.perf_counter()
    say(f"[serving] phi3-mini widths, {cfg.n_layers} layers (depth cut from 32), {n_slots} "
        f"slots, chunk {chunk}, cache {cache_cap} [{limit_line}]")
    launches, stats, served, engine5 = serving_phase(torch, K, cfg, params, n_slots, chunk,
                                                     cache_cap, n_requests=8, max_new=max_new)
    torch.cuda.empty_cache()
    phase_s["serving"] = time.perf_counter() - t
    runs = {"model": (model_launches, {}), "dense": (launches, stats)}

    # 17. deploy (a, c, d): OXF bundles of phase 5's Programs at 2 layers, the
    # golden bundle, phase 5's engine through AsyncEngine; then the engine
    # goes, as in every phase after 5 (only its decode Program stays, for
    # 17b's footprint table: it shares phase 5's weights)
    t = time.perf_counter()
    say(f"[deploy] phi3-mini widths: fp32 bundles at {DEPLOY_LAYERS} layers, the golden "
        f"bundle, AsyncEngine on phase 5's engine [{limit_line}]")
    launches, deploy_record = deploy_phase(
        torch, K, cfg, params, engine5, served, stats, n_slots=n_slots, chunk=chunk,
        cache_cap=cache_cap, max_new=max_new, card=limit_line)
    runs["deploy"] = (launches, deploy_record)
    fp32_decode = engine5.stepper.decode_program
    del engine5
    release(torch)
    phase_s["deploy"] = time.perf_counter() - t

    # 6. and 7. serving, paged cache
    ref_cache = {}
    agreement, paged_tokens, paged_waves = {}, {}, {}
    for phase, mode, kv_dtype in (("paged", "fp32", "float32"), ("kv8", "int8", "int8")):
        t = time.perf_counter()
        say(f"[{phase}] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk "
            f"{chunk}, cache {cache_cap}, {kv_dtype} pages of {page} rows, {pools[mode]} "
            f"blocks [{limit_line}]")
        launches, stats, agree, paged_tokens[mode], paged_waves[mode] = paged_serving_phase(
            torch, K, cfg, params, served, ref_cache, n_slots=n_slots, chunk=chunk,
            cache_cap=cache_cap, page=page, n_blocks=pools[mode], kv_dtype=kv_dtype,
            max_new=max_new, card=limit_line)
        torch.cuda.empty_cache()
        runs[f"paged {mode}"] = (launches, stats)
        agreement[mode] = agree
        phase_s[phase] = time.perf_counter() - t

    # 11. split-KV decode under the selection policies, on phase 5's weights
    t = time.perf_counter()
    say(f"[split] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap}, decode_attention cuda_split (n_splits 2) [{limit_line}]")
    launches, stats, split_record = split_phase(
        torch, K, cfg, params, served, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap,
        max_new=max_new, card=limit_line)
    runs["split"] = (launches, stats)
    torch.cuda.empty_cache()
    phase_s["split"] = time.perf_counter() - t

    # 13. int8 weights, on phase 5's weights and requests
    t = time.perf_counter()
    say(f"[int8w] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap}, build_lm_serving(quantize=\"int8\") [{limit_line}]")
    launches, stats, qtokens, q_ranges, int8_decode = int8w_phase(
        torch, K, cfg, params, served, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap,
        max_new=max_new, card=limit_line)
    runs["int8w"] = (launches, stats)
    release(torch)
    phase_s["int8w"] = time.perf_counter() - t

    # 17b. deploy: phase 13's int8-weight decode Program through a bundle
    t = time.perf_counter()
    say(f"[deploy int8] phi3-mini widths, {cfg.n_layers} layers, phase 13's int8-weight "
        f"decode Program [{limit_line}]")
    launches, int8_record = deploy_int8_phase(torch, K, cfg, fp32_decode, int8_decode,
                                              chunk=chunk, cache_cap=cache_cap,
                                              card=limit_line)
    runs["deploy int8"] = (launches, int8_record)
    deploy_record.update(int8_record)
    del fp32_decode, int8_decode
    release(torch)
    phase_s["deploy int8"] = time.perf_counter() - t

    # 14. speculative decoding: dense, paged fp32, int8 weights, then kv8 pages
    t = time.perf_counter()
    say(f"[spec] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap}, spec_k {SPEC_K}, default draft [{limit_line}]")
    spec_runs, spec_record = spec_phase(
        torch, K, cfg, params, served, qtokens, q_ranges, n_slots=n_slots, chunk=chunk,
        cache_cap=cache_cap, max_new=max_new, card=limit_line)
    runs.update(spec_runs)
    say(f"  [spec kv8] phase 7's two waves, int8 pages of {page} rows, {pools['int8']} blocks")
    launches, stats, _, _, _ = paged_serving_phase(
        torch, K, cfg, params, served, ref_cache, n_slots=n_slots, chunk=chunk,
        cache_cap=cache_cap, page=page, n_blocks=pools["int8"], kv_dtype="int8",
        max_new=max_new, card=limit_line, spec_k=SPEC_K, expect=paged_tokens["int8"])
    runs["spec kv8"] = (launches, stats)
    phase_s["spec"] = time.perf_counter() - t

    # 15. self-healing under injected faults, on phase 5's weights; the
    # uninterrupted runs of phases 5, 6, 7 and 14 are the oracles
    t = time.perf_counter()
    say(f"[heal] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap}, self_heal; a crash, a CUDA OOM and a device hang per engine "
        f"[{limit_line}]")
    uninterrupted = {"heal dense": runs["dense"][1], "heal paged fp32": runs["paged fp32"][1],
                     "heal paged int8": runs["paged int8"][1],
                     "heal spec dense": runs["spec dense"][1]}
    heal_runs = heal_phase(torch, K, cfg, params, served, paged_waves, paged_tokens,
                           uninterrupted, n_slots=n_slots, chunk=chunk, cache_cap=cache_cap,
                           page=page, pools=pools, card=limit_line)
    runs.update(heal_runs)
    phase_s["heal"] = time.perf_counter() - t

    # 16. overload: serve_bench's overload trace, tier-blind then tier-aware
    t = time.perf_counter()
    say(f"[load] phi3-mini widths, {cfg.n_layers} layers, {n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap}, paged fp32 pages of {page}, max_queue {2 * n_slots}, self_heal, "
        f"2x the drain rate [{limit_line}]")
    load_runs, load_record = load_phase(torch, K, cfg, params, n_slots=n_slots, chunk=chunk,
                                        cache_cap=cache_cap, page=page, card=limit_line)
    runs.update(load_runs)
    phase_s["load"] = time.perf_counter() - t

    # 18. tensor-parallel serving at TP_LAYERS (phase 5's weights dropped):
    # single-rank engines here, then two ranks on this card over gloo
    t = time.perf_counter()
    say(f"[tp] phi3-mini widths, {TP_LAYERS} layers (depth cut from 32), "
        f"{n_slots} slots, chunk {chunk}, "
        f"cache {cache_cap}; build_lm_serving(tp={TP_DEGREE}) dense, paged fp32 and paged "
        f"int8, two ranks on cuda:0 over gloo, against single-rank engines [{limit_line}]")
    del params
    release(torch)
    tp_runs, tp_record = tp_phase(torch, K, cfg, n_slots=n_slots, chunk=chunk,
                                  cache_cap=cache_cap, page=page, pools=pools, max_new=max_new,
                                  card=limit_line)
    release(torch)
    runs.update(tp_runs)
    phase_s["tp"] = time.perf_counter() - t

    # 8., 9., 10., 19. and 20. the layer-stack LMs under the continuous batcher
    for phase, scfg, max_new in stack_phases:
        t = time.perf_counter()
        say(f"[{phase}] {scfg.name} widths, {scfg.n_layers} layers, {scfg.dtype}, 4 slots, "
            f"cache 2048, {max_new} new tokens [{limit_line}]")
        runs[phase] = layerstack_phase(torch, K, scfg, limit_line, max_new=max_new, tag=phase)
        release(torch)
        phase_s[phase] = time.perf_counter() - t

    # 21. the encoder-decoder
    t = time.perf_counter()
    say(f"[encdec] {encdec_cfg.name} widths, {encdec_cfg.n_encoder_layers} encoder + "
        f"{encdec_cfg.plan.n_layers} decoder layers, {encdec_cfg.dtype}, 4 sources of "
        f"{ENCDEC_SRC} frames, "
        f"{ENCDEC_PROMPT}-token prompts, {ENCDEC_NEW} new tokens [{limit_line}]")
    runs["encdec"] = encdec_phase(torch, K, encdec_cfg, limit_line)
    release(torch)
    phase_s["encdec"] = time.perf_counter() - t

    # 22. training gemma3-1b at full width, with a checkpoint and a resume
    t = time.perf_counter()
    say(f"[train] gemma3-1b widths, 26 layers, fp32, {TRAIN_BATCH}x{TRAIN_SEQ} SyntheticLM "
        f"tokens a step, make_train_step(donate=True), AdamW + warmup_cosine, remat, "
        f"{TRAIN_STEPS} steps, a checkpoint at step {TRAIN_SAVE_AT} and a resume "
        f"[{limit_line}]")
    train_record = train_phase(torch, K, limit_line)
    release(torch)
    phase_s["train"] = time.perf_counter() - t

    # 22b. training gemma3-1b at its published bfloat16 (f32 masters)
    t = time.perf_counter()
    say(f"[train_bf16] gemma3-1b widths, 26 layers, bf16 params and f32 masters, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} SyntheticLM tokens a step, make_train_step(donate=True), "
        f"phase 22's AdamW + warmup_cosine, remat, {TRAIN_BF16_STEPS} steps, step 1 repeated "
        f"[{limit_line}]")
    train_bf16_record = train_bf16_phase(torch, K, limit_line, train_record)
    release(torch)
    phase_s["train_bf16"] = time.perf_counter() - t

    # 23. sharded training on a (data 2, model 2) mesh and the pipeline over "pod"
    t = time.perf_counter()
    say(f"[mesh_train] gemma3-1b widths, {6 * MESH_TRAIN_PERIODS} layers (depth cut), fp32, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens a step: 23a one process, 23b make_train_step(mesh=...) "
        f"on (data {MESH_SHAPE[0]}, model {MESH_SHAPE[1]}), four ranks on one card over gloo, "
        f"23c pipeline_apply over 'pod' ({PIPE_STAGES} stages, {PIPE_MICRO} microbatches) "
        f"[{limit_line}]")
    mesh_train_record, mesh_serve_record, mesh_serve_launches = mesh_train_phase(
        torch, K, limit_line)
    runs["mesh_serve"] = (mesh_serve_launches, mesh_serve_record)
    release(torch)
    phase_s["mesh_train"] = time.perf_counter() - t
    phase_s["mesh_serve (in the ranks, rank 0)"] = mesh_serve_record["rank_s"][0]

    # 25. the dry run: phase 22's step lowered on fake tensors, one production cell
    t = time.perf_counter()
    say(f"[dryrun] build_cell of phase 22's step (gemma3-1b, {TRAIN_BATCH}x{TRAIN_SEQ}, one "
        f"device) on fake tensors; launch.dryrun --arch gemma3-1b --shape decode_32k --mesh "
        f"single in a subprocess [{limit_line}]")
    dryrun_record = dryrun_phase(train_record, limit_line)
    phase_s["dryrun"] = time.perf_counter() - t

    # 12. the paper's five CNNs under six assignments
    t = time.perf_counter()
    say(f"[cnn] five CNNs, batch 1, six assignments [{limit_line}]")
    cnn_launches, cnn_rows, cnn_slowest = cnn_phase(torch, K, limit_line)
    runs["cnn"] = (cnn_launches, {"ms": cnn_rows})
    say(f"[cnn] --int8: fp32 against int8 builds, (torch, ref) assignment [{limit_line}]")
    cnn_int8 = cnn_int8_phase(torch, limit_line)
    phase_s["cnn"] = time.perf_counter() - t

    # 3, continued: device-only times (torch.profiler), after every timed phase
    t = time.perf_counter()
    say(f"[kernels] device time by kernel (torch.profiler), mean of 15 cold-L2 calls "
        f"[{limit_line}]")
    extra["device_ms"] = device_times(torch, K, limit_line)
    phase_s["device_times"] = time.perf_counter() - t

    split_ms = next(r["split_ms"] for r in extra["split"]
                    if r["shape"] == "phi3-mini engine decode" and r["n_splits"] == 2)
    for path in ("int8w", "spec dense", "spec paged fp32", "spec int8w", "spec kv8"):
        serving[path] = runs[path][1]
    serving["heal"] = {path: heal_runs[path][1] for path in heal_runs}
    serving["load"] = load_record
    serving["deploy"] = deploy_record
    serving["tp"] = tp_record
    serving["train"] = train_record
    serving["train_bf16"] = train_bf16_record
    serving["mesh_train"] = mesh_train_record
    serving["mesh_serve"] = mesh_serve_record
    serving["dryrun"] = dryrun_record
    for path in ("dense", "paged fp32", "paged int8", "split"):
        stats = runs[path][1]
        estimates[path] = tick_estimate(by_tag, ops_ms, cfg.n_layers, path, split_ms)
        serving[path] = stats
        for phase in ("decode", "prefill"):
            tick_ms = stats[f"{phase}_ms_per_tick"]
            parts_ms = estimates[path][phase]
            rest = tick_ms - sum(parts_ms.values())
            parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / tick_ms:.0f}%)"
                              for k, v in parts_ms.items())
            say(f"[breakdown] {path} {phase} tick {tick_ms:.2f} ms: {parts}, remainder "
                f"(other plain ops, logits to host, Python, less the overlap of parts "
                f"timed alone) {rest:.2f} ms ({100 * rest / tick_ms:.0f}%) [{limit_line}]")
    for phase, scfg, _ in stack_phases + [("encdec", encdec_cfg, ENCDEC_NEW)]:
        stats = runs[phase][1]
        serving[phase] = stats
        estimates[phase] = {}
        prefill = ((stats["prefill_ms"], f"batch-4 prefill ({ENCDEC_SRC} frames, "
                    f"{ENCDEC_PROMPT}-token prompts)") if phase == "encdec" else
                   (stats["prefill_ms_per_token"] * LAYERSTACK_PREFILL,
                    f"{LAYERSTACK_PREFILL}-token prefill (measured ms per prompt token x "
                    f"{LAYERSTACK_PREFILL})"))
        for part, measured, what in (("decode", stats["decode_ms_per_step"], "step"),
                                     ("prefill", *prefill)):
            parts_ms, bound_ms = stack_est[scfg.name][part]
            estimates[phase][part] = {**parts_ms, "bound": bound_ms}
            parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / measured:.0f}%)"
                              for k, v in parts_ms.items())
            rest = measured - sum(parts_ms.values())
            say(f"[breakdown] {phase} ({scfg.name}) {part} {what} {measured:.2f} ms: {parts}, "
                f"remainder (plain ops, logits to host, Python, less overlap) {rest:.2f} ms "
                f"({100 * rest / measured:.0f}%); sum of the kernels' bounds {bound_ms:.2f} ms "
                f"[{limit_line}]")
    phase_s["total"] = time.perf_counter() - t_start
    say(f"[done] wall seconds per phase {json.dumps(phase_s)}")

    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        by_path = {path: run[0].get(name, 0) for path, run in runs.items()}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 **{k: r[k] for k in keys}}
        if name == "flash_decode_partial":
            entry["n_splits_curve"] = extra["split"]
        if name == "flash_decode_partial_bf16":
            entry["n_splits_curve"] = extra["split_bf16"]
        if name == "combine_partials":
            entry["shapes"] = extra["combine"]
        if name == "gemm":
            entry["conv2d"] = extra["conv2d"]
        if name.endswith("_bf16"):
            base = name[:-len("_bf16")]
            entry["all_shapes"] = extra["shapes"][name]
            entry["device_ms"] = {k: v for k, v in extra["device_ms"].items()
                                  if k.split()[0] == base}
        if name in ("rmsnorm", "ssd_scan"):
            entry["all_shapes"] = extra["shapes"][name]
            entry["empty_launch_ms"] = extra["empty_launch_ms"]
            entry["device_ms"] = {k: v for k, v in extra["device_ms"].items()
                                  if name in k or "rms_norm" in k or "empty" in k}
        for mode in ("verify", "verify fp32", "verify int8 two-source"):
            if mode in r:
                entry[mode] = {k: r[mode][k] for k in keys + ("dense_kernel_ms",)
                               if k in r[mode]}
        if "int8" in r:
            entry["dense_kernel_ms"] = r["dense_kernel_ms"]
            entry["fp32"] = {"launches": by_path["paged fp32"],
                             **{k: r[k] for k in keys}, "dense_kernel_ms": r["dense_kernel_ms"]}
            entry["int8"] = {"launches": by_path["paged int8"],
                             **{k: r["int8"][k] for k in keys},
                             "dense_kernel_ms": r["int8"]["dense_kernel_ms"]}
        kernels.append(entry)
    serving["mla"]["k_cat"] = stack_est["deepseek-v2-lite-16b"]["k_cat"]
    say(json.dumps({"serving": serving, "tick_ms_by_part": estimates,
                    "kv8_agreement": agreement, "split": split_record, "cnn_ms": cnn_rows,
                    "cnn_int8": cnn_int8, "spec_verify_vs_decode": spec_record,
                    "verify_rows": extra["verify"], "dense_q_ms": extra["dense_q"],
                    "cnn_resnet50_slowest": cnn_slowest,
                    "empty_launch_ms": extra["empty_launch_ms"], "card": limit_line}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
