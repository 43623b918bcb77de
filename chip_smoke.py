#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines and its wall time (any failure exits
non-zero):

  1. build   compile the kernels of src/repro_torch/csrc/ (paged
             decode attention, prefill flash attention and its
             backward, row copies between pools, AdamW's sums and
             update) with nvcc for sm_90a,
             one nvcc per source,
             in parallel; print ptxas' register and spill report; fail
             if an instance of the flash kernel's tensor-core body
             (`flash_wgmma_kernel<D>`, D = 160 among them) spills.
  2. kernel  run the paged kernel against its plain version
             (ref.paged_attention_ref)
             on the same CUDA tensors at the full-width decode shapes
             of internlm2-1.8b (B=8, KH=8, G=2, HD=128), of
             granite-moe-3b-a800m (G=3, HD=64), llama31-8b and
             granite-8b (G=4, HD=128), qwen3-32b (G=8, HD=128),
             stablelm-12b (G=4, HD=160), whisper-tiny (KH=6, G=1,
             HD=64) and zamba2-1.2b's attention sites (KH=32, G=1,
             HD=64), T=16, N in {64, 208}, bf16 pools,
             with holes, a permuted page list, partial pages and an
             all-hole lane; time it beside the plain version and one
             scaled_dot_product_attention call over the same keys.
             Then check (untimed) phase 10's decode shapes at B=4,
             where the launch plan splits the pages otherwise:
             internvl2-2b, granite-8b, stablelm-12b, whisper-tiny and
             zamba2-1.2b, each line ending with the plan it ran.
             Times are device times (CUDA-graph replay over input sets
             that overflow the L2); the kernel's eager per-call time,
             the host's launch cost included, is printed beside them.
             A third shape is overlap mode's host tier: N=208 with the
             pools in pinned host memory, read over the link, checked
             against the plain version on device copies; its bound is
             the K/V bytes over the link's peak (H100.link_bw, 64 GB/s
             each way), with the time the rate of one large
             pinned->device `copy_` (measured here) would give printed
             beside it, and its library time is that `copy_` of the
             pools plus SDPA (no PyTorch call reads a pinned pool inside
             a kernel).
  2c. copy   the row-copy kernel against its plain version at phase
             4's plan capacity: the promote gather (pinned -> card) and
             the demote scatter (card -> pinned) of one pool, each
             timed against the link's peak, the measured `copy_`
             rate and the nearest PyTorch composition (a host
             index_select / index_copy_ through a pinned buffer, and
             copy_: no one call does it); the same gather with the pool
             on the card (inline mode) against HBM's peak and
             PyTorch's indexing; each also timed eagerly (20 calls
             issued from Python); one layer's decode token write (K and
             V of 8 lanes into both tiers, lane 3 inactive) as one
             launch, exact with the host tier pinned and on the card,
             timed on the card beside its bytes bound and PyTorch's
             index assignments; and overlap prefill's gather of two
             lanes' HBM and pinned host slots (`lane_pages`, one
             launch), exact, timed beside the link's peak. Then the
             payback probe's link rate (what `measured_payback` hands
             cost_aware) at phase 4b's geometry four ways — the swap
             plan repeated over the same host pages, over pages no
             earlier repeat touched, its promotes alone, its demotes
             alone — each through the engine's plan, timer and
             baseline, with its spread over the repeats.
  2b. flash  run the flash kernel against its plain version
             (ref.flash_attention_ref) on CUDA tensors: the prefill
             shapes of phase 5 (B=4, S=2304, H=16 over KH=8, D=128,
             bf16, causal; also internvl2-2b's), phase 7 (H=24 over
             KH=8, D=64) and phase 10 (stablelm-12b: H=32 over 8,
             D=160; granite-8b: H=32 over 8, D=128; whisper-tiny's
             encoder: S=1500, H=KH=6, D=64, not causal; zamba2-1.2b's
             attention sites: H=KH=32, D=64, causal), a ragged S
             with KH == H (and one at H=KH=32, D=64), a non-causal case, the smoke shape in f32,
             a bf16 D=64 case with a ragged S, f32 ones with H/KH = 3
             and with D=160, a ragged D=160 one, whisper's decoder
             self-attention (B=4, S=64, causal) and its cross-attention
             (not causal, Sq = 64, 37 and 1 over Sk = 1500: keys past
             Sk masked); time it at the prefill shapes (whisper's
             cross-attention in prefill among them), a training rank's
             (phase 14), granite-moe's training shape (phase 15c),
             whisper's cross-attention on a training rank (phase 16)
             and a meshed `start`'s rank shapes (phase 17b: internlm2
             at H/KH = 8/4 and 4/2, llama31-8b at 16/4 and 8/2, B=4,
             S=2304, D=128)
             beside the plain version, one scaled_dot_product_attention
             call (enable_gqa, on [B, H, S, D] copies made outside the
             timed region) and its bound.
  2d. flash bwd print ptxas' registers and spills of the backward's
             delta, dkdv and dq kernels and fail if `cuobjdump -sass`
             finds no HGMMA in an instance of the bf16 dkdv or dq body
             (or if one spills); then the backward kernel
             (csrc/flash_attention_bwd.cu)
             against its plain version (ref.flash_attention_bwd_ref) on
             the forward kernel's own out and LSE (the LSE checked
             against the plain forward's): dq, dk, dv within 1e-2 (bf16)
             / 1e-4 (f32) of each gradient's max |value|, two runs
             bitwise equal, at phase 12's training shape (B=8, S=512,
             H=16 over KH=8, D=128, bf16, causal), the smoke shape in
             f32 with a ragged S, H/KH = 3 at D=64, H = KH = 32 at D=64,
             D=160 with a ragged S and whisper's cross-attention (not
             causal, Sq = 64 over Sk = 1500), a training rank's shapes
             (phase 14), granite-moe's training shape (phase 15c: B=8,
             S=512, H=24 over 8, D=64) and phase 16's ranks (internvl2
             at 8/4 and 4/2 heads over 768 positions, whisper's encoder,
             decoder and cross-attention at 3 heads, zamba2's sites at
             16 and 8 heads); the training shapes timed
             by CUDA-graph replay beside the plain version, the backward
             of one scaled_dot_product_attention (its forward outside
             the timed region; each call timed alone behind a spin
             kernel, the kernel's own time so printed beside it) and the
             bound (the larger of its bytes and 2.5x the forward's
             flops).
  2e. adamw  the AdamW kernels (csrc/adamw.cu, one launch for every
             leaf) against their plain versions on internlm2-1.8b's
             parameter leaves at full width (phase 12's tree: bf16 at 24
             layers, f32 at 6): each leaf's sum of squares within
             SUMSQ_RTOL of `g.float().square().sum()` and two runs
             bitwise equal; the update, with the clip active and idle,
             pure and donated (in place), bitwise the plain version's for
             the same scale, lr and bias corrections; at the bf16 tree
             each timed beside the plain version and its bytes bound;
             then granite-moe-3b-a800m's tree (3.978 B bf16 parameters)
             timed, the update in place, its sums held to the plain
             ones.
  3. parity  serve a small f32 request stream on the card and on the
             CPU (the plain path) with the same weights: greedy tokens,
             statuses and per-step byte counts must match exactly.
  3c. overlap the same stream in overlap mode (host pools pinned on
             the card, commits on a side stream): card and CPU equal
             again, and pages committed.
  3d. faults the smoke stream under a fault plane of every kind, SLO
             admission (TTFT targets 0 and infinity by tier) and serve
             trace capture, inline and in overlap mode, on the card and
             on the CPU: tokens, statuses, step bytes, events, the
             serve trace and its scores equal.
  3e. moe    the granite-moe and llama4 smoke configs (capacity factor
             0.5: choices drop) served through 8 slots on the card
             (captured chunks, their prefill planes bounded to the pages
             that hold every row's position) and on the CPU: tokens,
             statuses and step bytes equal, the captures within
             `serve_graph_bound`; served again on the card's engine, the
             same stream and no capture.
  3f. family the single stream (start + generate(16)) of the smoke
             configs of llama31-8b, granite-8b, qwen3-32b, stablelm-12b,
             internvl2-2b (vlm, patch embeddings from --seed),
             whisper-tiny (encdec, frame embeddings from --seed) and
             zamba2-1.2b (hybrid: Mamba2 state beside the sites' cache)
             in f32, on the card and on the CPU: tokens and step bytes
             equal, start logits within 1e-4, the host tier read. Then
             xlstm-125m's smoke config in f32: `Model.prefill` of 2
             prompts of 24 tokens and 16 greedy `decode_step`s on the
             card and on the CPU: tokens equal, logits and the
             recurrent state within 1e-4.
  3b. stream the single-stream path on the card and on the CPU, f32
             smoke config, same weights, under each of the five
             policies with Quest sparsity 0.5 and trace capture:
             `start` logits within 1e-4, `generate` tokens, StepStats
             bytes and the captured trace equal, and `run` over the
             generated tokens within 1e-4 of the CPU's logits.
  4. serve   ServingEngine.serve() at the full width of internlm2-1.8b
             (random bf16 weights from --seed): 12 greedy requests that
             spill into the host tier and reuse lanes; every status ok,
             every output its full budget, the paged kernel
             launched 2 x layers x decode-plane steps times, and each
             token write one row-copy launch (layers x steps of them);
             row-copy launches per decode-plane step printed.
  4b. overlap the same 12 requests with overlap_migrations and
             measured_payback: host pools in pinned host memory, the
             same checks, the measured link bandwidth and commit time,
             and the rate, TTFT and TPOT beside phase 4's.
  4c. serve cli (run after phase 6 frees its model) the one-card
             serve CLI, `repro_torch.launch.serve.main`, in this
             process at the same width (its own random weights): 8
             requests of 1024-1056 prompt tokens and 32-36 new through
             8 lanes at hbm_fraction 0.25 (~1 GB of KV, every lane
             spills), priced on the H100 spec; its summary lines
             (tokens/s, TTFT, TPOT, modeled rate, hit rate), the paged
             kernel and the row copy launched; then `--smoke --parity`
             (the f32 smoke stream of 272-304-token prompts, past its
             16-page HBM pool, on the card and on the CPU: tokens and
             statuses identical, hit and bound fractions close) must
             exit 0 with a hit fraction under 1.
  4d. example examples/torch_serve_two_tier.py's `main` on the card: 30
             training steps of the smoke config, the five-policy sweep
             scored against the SA bound, and a sampled serve with
             per-request scores; all six kernels must launch.
  5. sweep   the single-stream policy sweep at the same width, as the
             repo's benchmarks run it: per policy a fresh `start` of 4
             prompts of 2304 tokens (each spills ~1280 tokens to the
             host tier), `generate(64)`, then `score_headroom` against
             the SA, Belady and static bounds; for `importance` also
             `start` + `run` over the first 32 generated tokens. The flash
             kernel must launch once per layer per `start`, the paged
             kernel twice per layer per decode step.
  6. faulted phase 4's engine with `cost_aware` and serve-trace capture
             over phase 4's 12 requests plus 4 open-loop arrivals at
             0.5-2 s, SLO tiers by prompt length (interactive: TTFT 2 s,
             TPOT 0.2 s; batch: 30 s, 0.5 s; wall-clock shedding), one
             fault of each kind (the poison on a long request while it
             decodes); every request terminal, the poisoned one
             "failed", the TTFT identity, the fault events; then
             `collect_serve` and `goodput_curve` (`score_serve` inside,
             SAConfig(12, 4, 0)), timed.
  7. moe     granite-moe-3b-a800m at its published widths (32 layers,
             d_model 1536, 24 heads over 8, head_dim 64, 40 experts
             top-8; random bf16 weights), after the internlm2 model is
             dropped: phase 4's serve of its 8 long requests through
             captured chunks with the same checks, served again on the
             same engine (no capture; the same tokens, statuses and step
             bytes; paged launches 2 x layers x steps run), its numbers,
             capture seconds and graph pool beside the eager serve's
             (`EAGER_MOE_SERVE`), then `start` of 4 prompts of 2304
             tokens (32 flash launches) and `generate(32)`; phase 15a
             serves again on its weights.
  8. llama31-8b the paper's own model at its published widths (32
             layers, d_model 4096, 32 heads over 8, head_dim 128, vocab
             128256; random bf16 weights): phase 4's serve (4.56 GB of
             KV), its checks and numbers.
  9. qwen3-32b at its published widths (64 layers, d_model 5120, 64
             heads over 8, qk RMSNorm, vocab 151936: 65.5 GB of bf16
             weights): phase 4b's overlap serve with measured payback,
             the KV's host tier (6.98 GB) pinned while the weights fill
             the card; its checks, numbers, link rate and peak memory.
  10. single streams at published widths: `start` + `generate(32)` of 4
             prompts of stablelm-12b (2304 tokens; D = 160 in both
             kernels), granite-8b (2304), internvl2-2b (2048 tokens +
             256 patch embeddings), whisper-tiny (64 tokens over 1500
             frame embeddings) and zamba2-1.2b (2304 tokens; 38 Mamba2
             blocks, 2 attention sites at KH = 32, G = 1, HD = 64);
             start wall, decode rate, launches per KV layer (flash once
             per attention per `start`, encdec's cross-attention once
             per layer per step, paged twice per KV layer per step:
             zamba2 2 flash and 2 x 2 x 32 = 128 paged), the cache's
             and (zamba2) the Mamba2 state's bytes beside the peak
             memory, then `score_headroom` on the internvl2, whisper
             and zamba2 streams.
  11. xlstm  xlstm-125m at its published widths (12 blocks, 3 of them
             sLSTM, d_model 768, 4 heads, mLSTM head 384; random bf16
             weights): `Model.prefill` of 4 prompts of XLSTM_PROMPT
             tokens (one replayed decode step each, as the reference
             runs it), then 32 greedy `decode_step`s; prefill wall,
             decode rate, the recurrent state's bytes, peak memory,
             finite logits, and no kernel launched (the family has no
             attention and no cache). `ServingEngine.generate` on it
             must raise ValueError.
  12a. train parity three `make_train_step` steps (lr 1e-3, the last
             with accum_steps=2) of the f32 smoke configs of
             internlm2-1.8b, granite-moe-3b-a800m, whisper-tiny
             (encdec: the cross-attention's backward, Sq != Sk) and
             zamba2-1.2b (hybrid) on the card and on the CPU from one
             `init_train_state`: losses, grad norms and parameters
             within TRAIN_TOL, the flash backward launched on the card.
  12. train  internlm2-1.8b at full width and depth (24 layers, random
             bf16 weights from --seed), B=8 x S=512 tokens from
             `SyntheticCorpus`, remat on, 6 steps at lr 1e-4, each
             donated as the train CLI's (the new state written into the
             given one's tensors): loss, grad norm and ms per step, peak
             memory beside the unfused update's (UNFUSED_TRAIN), flash
             48, its backward 24 and each AdamW kernel 1 launch a step;
             the loss at step 6 below step
             1's (a sanity check of the loop: 12c checks the gradient).
             Then `save_pytree` of the parameters (bytes, seconds),
             `restore_pytree` into fresh tensors (bitwise equal,
             seconds), the optimizer state freed, and phase 4's stream
             served from the restored weights with phase 4's checks.
  12b. resume internlm2-1.8b at full width but 2 layers (a ~5 GB train
             state, not ~23 GB, so the phase stays short), every step
             donated: 4 steps straight against 2 steps, an async
             `CheckpointManager.save` of the whole TrainState, 2 more
             steps on that state (written in place while the save
             writes), and a restore into fresh tensors with the same 2
             steps; losses, parameters and optimizer state of both
             bitwise the straight run's.
  12c. witness phase 12's first step at full width, 2 layers: the bf16
             gradient against the same step with the weights widened to
             f32 on the card: loss, grad norm and each parameter's
             gradient (relative L2) within WITNESS_TOL.

  13a. mesh serve phase 4's stream, then phase 4b's (overlap mode:
             the commits' side stream beside the in-graph collectives),
             each on a new `ServingEngine(..., mesh=)` over a
             world-size-1 NCCL group (a `file://` store in a temporary
             directory) and `make_test_mesh(1, 1)`, at full width, after
             phase 6, on phase 4's model: every collective of the meshed
             path runs, inside the captured chunks; greedy tokens,
             statuses and step bytes equal phase 4's (4b's), captures
             within `serve_graph_bound` and none served again; tokens/s,
             TTFT and TPOT p50 beside the unmeshed serve's (the price of
             the collectives and the per-rank bookkeeping at world size
             1). The engines are freed, then the group is torn down.
  13b. tp split one full-width decode layer (B=8, 64 HBM + 208 host
             pages) split over a model axis of 2 and 4 (internlm2-1.8b)
             and 4 (qwen3-32b: 64/8 heads -> 16/2 a rank), rank after
             rank on one card: the ranks' partial attention and MLP
             outputs summed in bf16 against the unsplit layer within
             TP_TOL, the importance summed over ranks within 1e-4, and
             the paged kernel at each rank's KH against its plain
             version. The multi-rank path on cards is a four-card
             cell's.

  14a. mesh train phase 12's training on a world-size-1 NCCL mesh
             (`make_train_step(..., mesh=)`, `init_train_state(...,
             mesh=)`), internlm2-1.8b at full width and depth, B=8 x
             S=512, remat, 3 steps on phase 12's batches: every
             collective of the meshed step runs (each an identity at
             size 1), donated as phase 12's; losses, grad norms and
             parameters bitwise equal to phase 12's first 3 steps; flash
             48, its backward 24 and each AdamW kernel 1 launch a step
             (`mesh_train` in the kernels line). Then,
             at 2 layers (as 12b: the full-depth train state is ~19 GB),
             2 meshed steps, a save on the mesh, a restore without one
             and a third step: bitwise equal to 3 unmeshed steps.
  14b. train split one full-width internlm2-1.8b decoder layer's
             forward and backward split over (data, model) = (1, 2), (1,
             4), (2, 2) and (2, 4), rank after rank on one card, the
             collectives by hand in one autograd graph (FSDP blocks
             concatenated over data, partial outputs summed over model
             in bf16, the norms' input shared by the model ranks): dx
             and every weight's gradient, assembled from the ranks'
             blocks, against the unsplit layer's within
             TRAIN_SPLIT_TOL; the flash kernel and its backward at 8/4
             and 4/2 heads (`train_split`).

  15a. mesh moe serve (after phase 7, on its weights) phase 7's serve
             on a new `ServingEngine(..., mesh=)` over a world-size-1
             NCCL group: every collective of the meshed moe path (the
             experts' range, the lanes' rows bound for routing) runs
             inside the captured chunks; greedy tokens, statuses and
             step bytes equal phase 7's, served again too (no capture),
             captures within `serve_graph_bound`; tokens/s, TTFT and
             TPOT p50 beside phase 7's (`mesh_moe_serve` in the kernels
             line).
  15b. moe split one full-width granite-moe layer: a decode step of 8
             lanes (64 HBM + 208 host pages) and a 256-token prefill
             chunk, attention and the moe FFN, split over (data, model)
             = (1, 2), (1, 4), (2, 1) and (2, 2) rank after rank (24 or
             12 of the 48 padded experts a model rank; each data rank's
             lanes routed over every data rank's logits): against the
             unsplit layer within MOE_SPLIT_TOL, the importance summed
             over ranks, the paged kernel at each split's KH against
             its plain version (`moe_split`).
  15c. moe train granite-moe-3b-a800m at full width and all 32
             layers (the donated step's fused update holds 12 bytes a
             parameter, 47.6 GB), B=8 x S=512, remat, 3 steps
             unmeshed and 3 on a world-size-1 NCCL mesh from
             `init_train_state(..., mesh=)`: losses, grad norms and
             parameters bitwise equal, ms per step and peak memory
             beside the 16-layer run's; a run that does not fit
             fails with the bytes it reached (`moe_train`,
             `mesh_moe_train`); then one full-width
             granite-moe layer's attention and moe blocks, forward and
             backward, each on its own rows, split over (data, model) =
             (1, 2), (2, 2) and (1, 4) as 14b: each block's dx and every
             weight's gradient within MOE_TRAIN_SPLIT_TOL
             (`moe_train_split`).

  16a. family train internvl2-2b (256 patch embeddings before the text),
             whisper-tiny (1500 frame embeddings), zamba2-1.2b and
             xlstm-125m at full width and depth (FAMILY_TRAIN_ARCHS
             says why no depth is cut), B=8 x S=512, remat, 3 donated
             steps unmeshed and 3 on a world-size-1 NCCL mesh
             (`make_train_step(..., extra_keys=, mesh=)`): losses, grad
             norms and parameters bitwise equal, ms per step and peak
             memory beside the unfused update's, flash 2 x and its
             backward 1 x the attention calls of a forward and each
             AdamW kernel once each step (`family_train`,
             `mesh_family_train`).
  16b. family train split one full-width layer's blocks of each of
             those families (internvl2-2b's decoder layer, whisper-tiny's
             encoder layer and decoder layer with its cross-attention,
             zamba2-1.2b's Mamba2 block and shared attention site,
             xlstm-125m's mLSTM and sLSTM blocks), forward and backward,
             split over (data, model) = (1, 2), (2, 2) and (1, 4), and
             zamba2's blocks also over (1, 3) and xlstm's over (1, 8)
             (where the axis does not divide the KV heads: whisper's 6
             heads whole at model = 4, zamba2's Mamba2 block and xlstm's
             blocks run whole on every model rank), the ranks as threads
             each bound as the meshed train step binds it (`TrainMesh`
             over `ThreadMesh.collectives`, every enter and sum with its
             backward) and taking its own backward: each rank's dx and
             weight gradients within FAMILY_TRAIN_SPLIT_TOL of its block
             of the unsplit layer's; the launches counted are the
             ranks', not the unsplit layer's; the flash
             kernel and its backward at each rank's heads
             (`family_train_split`; phases 2b and 2d check those shapes
             against the plain versions).

  17a. mesh stream the single-stream path of a meshed engine at world
             size 1, on phase 4's internlm2-1.8b weights (after phase
             13a) and phase 7's granite-moe-3b-a800m weights (after 15a):
             `start` of 4 prompts of 2304 tokens (granite-moe: 1024),
             `run` of 32 teacher-forced tokens and `generate(64)` at
             telemetry_stride 16 on an unmeshed engine, freed, then on a
             new `ServingEngine(..., mesh=)` over a world-size-1 NCCL
             group: start logits, run logits, tokens and StepStats bytes
             bitwise equal; start wall, generate's tokens/s both ways and
             the captures; flash once per layer at `start`, the paged
             kernel twice per layer per step (`mesh_stream`).
  17b. prefill split one full-width layer's whole-prompt prefill (B=4,
             S=2304) of internlm2-1.8b and llama31-8b split over a model
             axis of 2 and 4, rank after rank on one card: each rank's
             K/V written to its cache equal to the unsplit cache's
             KV-head slices, the ranks' partial attention and MLP
             outputs summed in bf16 within PREFILL_SPLIT_TOL of the
             unsplit layer's, the flash kernel at each rank's heads
             against its plain version (`prefill_split`).

  18a. pages split one full-width layer of internlm2-1.8b (16/8 heads)
             and of qwen3-32b (64/8) split over a model axis of 16 that
             does not divide the KV heads (the reference's `pages` KV
             pool rule), the ranks as threads of this process
             (`ThreadMesh`) running the engine's rank-local code: each
             rank's pools hold 4 of phase 4's 64 HBM and 13 of its 208
             host slots a lane (B=8), every KV head, the tables whole; a
             decode step (`Model.decode_step`: the token written by the
             rank that holds its slot, the paged kernel on every rank's
             slots, the 32 partials merged, the importance at the rank's
             slots summed), a migration plan at the budget over random
             importance (rows crossing ranks exchanged over `model`), a
             32-token chunked-prefill slice (ranks past every prefix give
             zero partials) and `start` of 2 x 1536 tokens (flash at the
             rank's query heads over the KV heads they read): every
             rank's pools bitwise the unsplit pools' slots and its tables
             equal after each, logits and importance within
             PAGES_SPLIT_TOL of the unsplit layer's (`pages_split`);
             phase 2 times the paged kernel at a rank's slots (N = 4,
             13).
  18b. none split the internlm2-1.8b layer over a model axis of 3 (the
             `none` rule: pools and heads whole, the vocabulary split):
             pools, tables and importance exact (`none_split`).

  19a. kv train split one full-width decoder layer (random bf16
             weights) of internlm2-1.8b and qwen3-32b (qk norm) over a
             model axis of 16 that does not divide their 8 KV heads
             (each rank's query heads over every KV head, `wk`/`wv`
             whole on every rank) and of granite-moe-3b-a800m (its 24
             heads whole on every rank, 3 of its 48 experts a rank),
             forward and backward on B=8 x S=512 as threads, as 16b:
             each rank's dx and weight gradients within KV_SPLIT_TOL of
             its block of the unsplit layer's (`kv_train_split`, the
             ranks' launches).
  19b. kv train step internlm2-1.8b at full width and 4 of its 24 layers
             (depth cut) in f32: 2 donated steps unmeshed and 2 over
             (1, 16) as threads, each rank calling the meshed
             `make_train_step(..., mesh=, comm=, donate=True)` with the
             threads' collectives (backward
             included), its backward on its own thread: losses, grad
             norms, m and the parameters' update within KV_STEP_TOL
             (`kv_train_step`).

  20. family rank the rank-local prefill and decode of the vlm, encdec,
             hybrid, ssm and xlstm families: internvl2-2b, whisper-tiny
             (over its 1500 frames), zamba2-1.2b and xlstm-125m at full
             width (random bf16 weights), B=4 (FAMILY_RANK_SPLITS' prompt
             lengths), split over a model axis of 2 and one that divides
             no head count (whisper at 4: `pages`; zamba2 at 3: `none`,
             its Mamba2 blocks whole; xlstm at 8: its blocks whole), the
             ranks as threads (`ThreadMesh`) each binding
             `TensorParallel.serving` as the engine binds a rank: the
             prefill and 4 decode steps fed the unsplit run's greedy
             tokens, every rank's logits within FAMILY_RANK_TOL of the
             unsplit run's, its integer cache state equal; the flash and
             paged kernels' launches of the ranks (`family_rank`). Then
             one `--mesh multi` record of the dry run (qwen3-32b
             decode_32k, meta device), printed as a JSON line.

Then a `kernels` JSON line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
and prints no result. `--profile DIR` runs phase 4 under torch.profiler
and prints where the device time goes.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BW = 3.35e12         # H100 SXM HBM3 bytes/s (NVIDIA datasheet)
BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
TOL = {"out": 1e-2, "m": 1e-4, "lse": 1e-4, "l_rel": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls issued from Python
    (CUDA events): the host's launch cost included, as a caller that
    launches one call at a time sees it."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, n_sets: int, reps: int = 10) -> float:
    """Device milliseconds per call: `n_sets` calls (one per input set,
    so the 50 MB L2 cannot hold them) captured into one CUDA graph and
    replayed `reps` times, timed with CUDA events. The host's launch
    cost is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_sets):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * n_sets)
    del graph
    return ms


# --------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------

def paged_inputs(rng, B, KH, G, HD, N, T, dtype, device):
    """Decode-attention inputs with holes, a permuted page list, partial
    pages, pages listed with zero valid tokens, and an all-hole lane."""
    import torch
    P = N
    page_list = np.full((B, N), -1, np.int32)
    page_valid = np.zeros((B, N), np.int32)
    for b in range(B - 1):                      # lane B-1: all holes
        n_res = int(rng.integers(N // 2, N + 1))
        where = rng.choice(N, size=n_res, replace=False)
        page_list[b, where] = rng.permutation(P)[:n_res]
        page_valid[b, where] = T
        partial = rng.choice(where, size=max(1, n_res // 16), replace=False)
        page_valid[b, partial] = rng.integers(1, T, partial.size)
        page_valid[b, rng.choice(where)] = 0    # listed, but no token
    q = torch.randn((B, KH, G, HD), dtype=dtype, device=device)
    k = torch.randn((B, P, T, KH, HD), dtype=dtype, device=device)
    v = torch.randn((B, P, T, KH, HD), dtype=dtype, device=device)
    return (q, k, v, torch.as_tensor(page_list, device=device),
            torch.as_tensor(page_valid, device=device))


def work(inputs):
    """(bytes, flops) the function needs on these inputs: each input
    byte read once (only the valid K/V tokens), each output written
    once; 4 flops per (token, query row, head-dim element)."""
    q, k, _, page_list, page_valid = inputs
    B, KH, G, HD = q.shape
    N = page_list.shape[1]
    T = k.shape[2]
    tokens = int(page_valid.clamp(0, T)[page_list >= 0].sum())
    es = q.element_size()
    kv = 2 * tokens * KH * HD * es
    bytes_ = (q.numel() * es + kv + 2 * B * N * 4
              + q.numel() * es + 2 * B * KH * G * 4 + B * KH * G * N * 4)
    return bytes_, 4 * tokens * KH * G * HD


def kv_bytes(inputs):
    """The valid K/V bytes a paged call reads (what crosses the link
    when its pools are pinned host memory)."""
    _, k, _, page_list, page_valid = inputs
    KH, HD = k.shape[3], k.shape[4]
    tokens = int(page_valid.clamp(0, k.shape[2])[page_list >= 0].sum())
    return 2 * tokens * KH * HD * k.element_size()


def link_peak() -> float:
    """The host link's peak bytes/s each way, the bound of every copy
    over it: H100.link_bw (PCIe Gen5 x16, 64 GB/s before its 128b/130b
    encoding; repro_torch/core/tiers.py)."""
    from repro_torch.core.tiers import H100
    return H100.link_bw


def link_bandwidth(device, nbytes: int = 1 << 30):
    """Bytes/s of one large `copy_(non_blocking=True)` over the host
    link, each way (pinned host -> card, card -> pinned host): best of
    three, CUDA events."""
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        out[name] = nbytes / best
    log(f"link: {nbytes / 1e9:.3f} GB copy_ pinned -> card "
        f"{out['h2d'] / 1e9:.2f} GB/s, card -> pinned "
        f"{out['d2h'] / 1e9:.2f} GB/s (peak H100.link_bw "
        f"{link_peak() / 1e9:.0f} GB/s each way)")
    return out


def dense_for_sdpa(inputs):
    """The same valid keys as a dense [B, H, N*T, HD] buffer + mask, for
    the library yardstick (built outside the timed region)."""
    import torch
    q, k, v, page_list, page_valid = inputs
    B, KH, G, HD = q.shape
    N, T = page_list.shape[1], k.shape[2]
    slot = page_list.clamp_min(0).long()
    bidx = torch.arange(B, device=q.device)[:, None]
    kd = k[bidx, slot].reshape(B, N * T, KH, HD).permute(0, 2, 1, 3)
    vd = v[bidx, slot].reshape(B, N * T, KH, HD).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(G, dim=1).contiguous()
    vd = vd.repeat_interleave(G, dim=1).contiguous()
    tok = torch.arange(T, device=q.device)
    valid = (page_list[:, :, None] >= 0) & (tok < page_valid[:, :, None])
    mask = valid.reshape(B, 1, 1, N * T)
    return q.reshape(B, KH * G, 1, HD), kd, vd, mask


#: the paged kernel's decode shapes, by model: (KH, G, HD) at B=8, T=16
PAGED_MODELS = (("internlm2-1.8b", 8, 2, 128),
                ("granite-moe-3b-a800m", 8, 3, 64),
                ("llama31-8b", 8, 4, 128),          # and granite-8b
                ("qwen3-32b", 8, 8, 128),
                ("stablelm-12b", 8, 4, 160),
                ("whisper-tiny", 6, 1, 64),
                ("zamba2-1.2b", 32, 1, 64))


#: phase 10's single streams decode at B=4, where `choose_splits` plans
#: another split of the page range than at B=8: (model, KH, G, HD),
#: checked at both tiers' page counts
PAGED_STREAMS = (("internvl2-2b", 8, 2, 128), ("granite-8b", 8, 4, 128),
                 ("stablelm-12b", 8, 4, 160), ("whisper-tiny", 6, 1, 64),
                 ("zamba2-1.2b", 32, 1, 64))


def kernel_phase(rng, device):
    import torch
    link = link_bandwidth(device)
    shapes = []
    for model, KH, G, HD in PAGED_MODELS:
        shapes += paged_shapes(rng, device, model, KH, G, HD)
    # phase 18a's shard of internlm2's tiers: 4 HBM + 13 host slots
    _, Ph, Pe = PAGES_GEO
    for model, split in PAGES_SPLITS[:1]:
        shapes += paged_shapes(rng, device, model, 8, 2, 128,
                               Ns=(Ph // split, Pe // split), split=split)
    for model, KH, G, HD in PAGED_STREAMS:
        for N in (64, 208):
            check_paged(f"kernel {model} B=4 G={G} HD={HD} N={N}",
                        paged_inputs(rng, 4, KH, G, HD, N, 16,
                                     torch.bfloat16, device))
    shapes.append(pinned_shape(rng, device, link))
    paged_threads_check(rng, device)
    return shapes, link


def paged_threads_check(rng, device, threads=16, rounds=2000):
    """Phase 18a's two tiers of a rank (4 HBM and 13 host slots of
    internlm2's pools) launched from `threads` host threads at once,
    half of them each tier, `rounds` times each, through the library's
    launcher with little Python between calls. The two sizes need
    different dynamic shared memory, both over 48 KiB, and the
    function's limit is one for every thread, so no launch may fail
    when another thread asked for a smaller size in between (the ranks
    of phases 18 and 20 are such threads). Each tier's output, written
    by every launch of it, is then held against the plain version."""
    import threading
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    _, Ph, Pe = PAGES_GEO
    split = PAGES_SPLITS[0][1]
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    tiers, smem = [], []
    for N in (Ph // split, Pe // split):
        inputs = paged_inputs(rng, 8, 8, 2, 128, N, 16, torch.bfloat16,
                              device)
        plan = pa.launch_plan(8, 8, 2, 128, 16, N, 2, sm)
        smem.append(pa.smem_bytes(plan.warps, 2, 128, 16, 2, plan.per))
        # its own tickets: every launch runs on this stream, one by one
        tiers.append((inputs, *pa.launch_args(*inputs, ticket_set=len(
            tiers))))
    if len(set(smem)) < 2 or min(smem) <= 48 * 1024:
        raise AssertionError(f"paged threads: shared memory {smem} does "
                             f"not exercise the shared limit")
    launch = pa._library().paged_attention_launch
    start = threading.Barrier(threads, timeout=300)
    failed = collections.Counter()

    def run(i):
        args = tiers[i % 2][1]
        try:
            start.wait()
        except threading.BrokenBarrierError:
            return
        for _ in range(rounds):
            err = launch(*args)
            if err:
                failed[err] += 1
    pool = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    t = time.time()
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    torch.cuda.synchronize()
    wall = time.time() - t
    if failed:
        raise AssertionError(f"paged threads: launches failed, by CUDA "
                             f"error: {dict(failed)} of {threads * rounds}")
    err = 0.0
    for inputs, _, got in tiers:
        want = ref.paged_attention_ref(*inputs)
        err = max(err, float((got[0].float() - want[0].float()).abs()
                             .max()))
    log(f"paged threads: {threads} threads x {rounds} launches of two "
        f"tiers ({smem} bytes of shared memory) in {wall:.2f} s, none "
        f"failed; out max err {err:.3e} (tolerance {TOL['out']})")
    if not err <= TOL["out"]:
        raise AssertionError(f"paged threads: out {err}")

def check_paged(what, inputs):
    """The kernel against its plain version on one input set, with the
    launch plan it ran; the all-hole lane must come out empty. Returns
    the errors by output; raises past TOL."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    got = pa.paged_attention(*inputs)
    want = ref.paged_attention_ref(*inputs)
    torch.cuda.synchronize()
    err = {
        "out": float((got[0].float() - want[0].float()).abs().max()),
        "m": float((got[1] - want[1]).abs().max()),
        "l_rel": float(((got[2] - want[2]).abs()
                        / want[2].abs().clamp_min(1e-30)).max()),
        "lse": float((got[3] - want[3]).abs().max()),
    }
    q, k, _, page_list, _ = inputs
    B, KH, G, HD = q.shape
    if not bool((got[2][B - 1] == 0).all()) or \
            not bool((got[0][B - 1] == 0).all()):
        raise AssertionError(f"{what}: the all-hole lane is not empty")
    plan = pa.launch_plan(B, KH, G, HD, k.shape[2], page_list.shape[1],
                          k.element_size(),
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    log(f"{what}: max err out {err['out']:.3e} m {err['m']:.3e} "
        f"l(rel) {err['l_rel']:.3e} lse {err['lse']:.3e} "
        f"(tolerance {TOL})  {plan}")
    bad = {n: e for n, e in err.items() if not e <= TOL[n]}
    if bad:
        raise AssertionError(f"{what} disagrees with the plain version: "
                             f"{bad}")
    return err


def paged_shapes(rng, device, model, KH, G, HD, Ns=(64, 208), split=None):
    """The HBM tier (N=64) and host tier (N=208) of one model's decode,
    bf16 pools on the card: checked, then timed. `Ns`, `split`: a rank's
    block of those slots under the `pages` rule over a model axis of
    `split` (phase 18a's shapes)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    B, T = 8, 16
    shapes = []
    for N in Ns:
        per_copy = 2 * B * N * T * KH * HD * 2
        copies = max(2, math.ceil(256e6 / per_copy))   # beat the 50 MB L2
        sets = [paged_inputs(rng, B, KH, G, HD, N, T, torch.bfloat16, device)
                for _ in range(copies)]
        what = f"kernel {model} G={G} HD={HD} N={N}" + (
            f" (a rank's slots, pages rule, model={split})" if split else "")
        err = check_paged(what, sets[0])

        def kernel(i):
            return pa.paged_attention(*sets[i % copies])

        def plain(i):
            return ref.paged_attention_ref(*sets[i % copies])

        dense = [dense_for_sdpa(s) for s in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def library(i):
            d = dense[i % copies]
            return sdpa(*d[:3], attn_mask=d[3])

        ms = device_ms(kernel, copies)
        plain_ms = device_ms(plain, copies)
        lib_ms = device_ms(library, copies)
        kernel_eager = eager_ms(kernel, 200)
        # the mean over the timed input sets, whose valid pages differ
        nbytes, flops = (sum(x) / copies for x in zip(*map(work, sets)))
        bound = max(nbytes / HBM_BW, flops / BF16_FLOPS) * 1e3
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        log(f"{what}: device {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"sdpa {lib_ms:.4f} ms  bound {bound:.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)  "
            f"eager call {kernel_eager:.4f} ms  "
            f"{pa.launch_plan(B, KH, G, HD, T, N, 2, sms)}")
        shapes.append({"model": model, "G": G, "HD": HD, "N": N,
                       **({"pages_split": split} if split else {}),
                       "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": bound,
                       "eager_ms": kernel_eager,
                       "bytes": nbytes, "flops": flops,
                       "bound_by": "bytes" if nbytes / HBM_BW
                       >= flops / BF16_FLOPS else "operations",
                       "max_abs_err": err["out"], "errors": err})
        del sets, dense
    return shapes


def pinned_shape(rng, device, link):
    """The host tier of overlap mode: N=208 with the pools in pinned
    host memory, which the kernel reads in place over the link."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    B, KH, G, HD, T, N = 8, 8, 2, 128, 16, 208
    per_copy = 2 * B * N * T * KH * HD * 2
    copies = max(2, math.ceil(256e6 / per_copy))
    sets = [paged_inputs(rng, B, KH, G, HD, N, T, torch.bfloat16, device)
            for _ in range(copies)]
    pinned = [(q, k.cpu().pin_memory(), v.cpu().pin_memory(), pl, pv)
              for q, k, v, pl, pv in sets]
    got = pa.paged_attention(*pinned[0])
    want = ref.paged_attention_ref(*sets[0])       # on a device copy
    torch.cuda.synchronize()
    err = {
        "out": float((got[0].float() - want[0].float()).abs().max()),
        "m": float((got[1] - want[1]).abs().max()),
        "l_rel": float(((got[2] - want[2]).abs()
                        / want[2].abs().clamp_min(1e-30)).max()),
        "lse": float((got[3] - want[3]).abs().max()),
    }
    log(f"kernel N={N} pinned host pools: max err out {err['out']:.3e} m "
        f"{err['m']:.3e} l(rel) {err['l_rel']:.3e} lse {err['lse']:.3e} "
        f"(tolerance {TOL})")
    bad = {k: v for k, v in err.items() if not v <= TOL[k]}
    if bad:
        raise AssertionError(f"kernel over pinned pools disagrees with the "
                             f"plain version: {bad}")
    dense = [dense_for_sdpa(s) for s in sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k_card = torch.empty_like(sets[0][1])
    v_card = torch.empty_like(sets[0][2])

    def kernel(i):
        return pa.paged_attention(*pinned[i % copies])

    def plain(i):
        return ref.paged_attention_ref(*sets[i % copies])

    def library(i):
        # no PyTorch call reads a pinned pool in a kernel: copy the
        # pools over the link, then SDPA on the copy
        k_card.copy_(pinned[i % copies][1], non_blocking=True)
        v_card.copy_(pinned[i % copies][2], non_blocking=True)
        d = dense[i % copies]
        return sdpa(*d[:3], attn_mask=d[3])

    ms = device_ms(kernel, copies)
    plain_ms = device_ms(plain, copies)
    lib_ms = device_ms(library, copies)
    kernel_eager = eager_ms(kernel, 50)
    nbytes, flops = (sum(x) / copies for x in zip(*map(work, sets)))
    over_link = sum(map(kv_bytes, sets)) / copies
    t_link = over_link / link_peak() * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound = max(t_link, t_ops)
    at_copy = over_link / link["h2d"] * 1e3
    log(f"kernel N={N} pinned host pools: device {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms (device copies)  copy_+sdpa {lib_ms:.4f} ms  "
        f"bound {bound:.4f} ms ({over_link / 1e6:.2f} MB over the link's "
        f"peak {link_peak() / 1e9:.0f} GB/s; {at_copy:.4f} ms at the "
        f"measured copy_ rate {link['h2d'] / 1e9:.2f} GB/s)  "
        f"{over_link / ms / 1e6:.2f} GB/s  eager call {kernel_eager:.4f} ms")
    del sets, pinned, dense
    return {"model": "internlm2-1.8b", "G": G, "HD": HD, "N": N,
            "pools": "pinned host", "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "copy_ of the pools over the "
            "link + scaled_dot_product_attention", "bound_ms": bound,
            "copy_rate_ms": at_copy,
            "eager_ms": kernel_eager, "bytes": nbytes,
            "link_bytes": over_link, "flops": flops,
            "bound_by": "bytes" if t_link >= t_ops else "operations",
            "max_abs_err": err["out"], "errors": err}


# --------------------------------------------------------------------------
# phase 2c: the row-copy kernel against its plain version
# --------------------------------------------------------------------------

def host_composition_ms(pool, flat, staged, gather: bool,
                        reps: int = 5) -> float:
    """Mean wall milliseconds of the nearest PyTorch composition of a
    pinned pool's row copy: gather = `index_select` of the pool's pages
    on the host into a pinned buffer, then `copy_` onto the card (into a
    buffer of its own: `staged` is left as it is); scatter = `copy_` of
    `staged`'s rows into a pinned buffer, then `index_copy_` into the
    pool on the host (which it changes)."""
    import torch
    rows = pool.view(math.prod(pool.shape[:3]), -1)
    idx = torch.as_tensor(flat, dtype=torch.long)
    buf = torch.empty((len(flat), rows.shape[1]), dtype=rows.dtype,
                      pin_memory=True)
    card = staged.view(len(flat), -1)
    dst = torch.empty_like(card) if gather else None

    def once():
        if gather:
            torch.index_select(rows, 0, idx, out=buf)
            dst.copy_(buf, non_blocking=True)
        else:
            buf.copy_(card)
            rows.index_copy_(0, idx, buf)
        torch.cuda.synchronize()
    once()
    t = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t) / reps * 1e3


def page_moves(rng, device):
    """Phase 2c's page moves: one pool's pages of a full-capacity commit
    at phase 4's geometry, gathered out of a pinned host pool onto the
    card (overlap mode's promotes), scattered from the card into it
    (its demotes), and gathered with the pool on the card (inline
    mode's migrations). Returns (the moves, in that order: dicts of
    name, way, `kernel(i)` and `plain(i)` — the row copy and its plain
    version on device copies — and `exact()`; the shared tensors)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import page_copy as pc
    from repro_torch.kernels import ref
    from repro_torch.models.model import Model
    from repro_torch.serving import control
    from repro_torch.serving.engine import EngineConfig
    geo = Model(configs.get("internlm2-1.8b")).cache_geometry(8, 4096, 0.25)
    cap = control.plan_capacity(geo, EngineConfig().migration_budget_frac)
    L, B, Pe, T = geo.num_layers, geo.batch, geo.host_pages, geo.page_tokens
    page = (T, geo.kv_heads, geo.head_dim)
    flat = rng.choice(L * B * Pe, size=cap, replace=False)
    at = tuple(torch.as_tensor(c.astype(np.int32), device=device)
               for c in np.unravel_index(flat, (L, B, Pe)))
    pool_card = torch.randn((L, B, Pe) + page, device=device,
                            dtype=torch.bfloat16)
    pool = pool_card.cpu().pin_memory()
    staged = torch.randn((cap,) + page, device=device, dtype=torch.bfloat16)
    moves = []
    for name, way in (("gather", "pinned -> card"),
                      ("scatter", "card -> pinned"),
                      ("gather", "card -> card")):
        if way == "card -> pinned":
            want = pool_card.clone()

            def kernel(i):
                pc.page_copy((pool, at, staged, (None,)))

            def plain(i, want=want):
                ref.page_copy_ref((want, at, staged, (None,)))

            def exact(want=want):
                return torch.equal(pool.to(device), want)
        else:
            src = pool if way == "pinned -> card" else pool_card
            got = torch.empty_like(staged)
            want = torch.empty_like(staged)

            def kernel(i, src=src, got=got):
                pc.page_copy((got, (None,), src, at))

            def plain(i, want=want):
                ref.page_copy_ref((want, (None,), pool_card, at))

            def exact(got=got, want=want):
                return torch.equal(got, want)
        moves.append({"name": name, "way": way, "kernel": kernel,
                      "plain": plain, "exact": exact})
    shared = {"geo": geo, "cap": cap, "page": page, "flat": flat, "at": at,
              "pool_card": pool_card, "pool": pool, "staged": staged,
              "bytes": cap * math.prod(page) * 2}
    return moves, shared


def token_write_case(rng, device, geo, pinned: bool):
    """One layer's decode token write at phase 4's geometry: K and V of
    the 8 lanes, half of them into the HBM tier and half into the host
    tier (pinned host memory with `pinned`), lane 3 inactive, through
    `paged.write_token_layer`. Returns (write(i), check() -> (exact,
    launches of one write), args)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import COUNTS
    from repro_torch.kernels.page_copy import Split
    from repro_torch.kvcache import paged
    B, Ph, Pe, T = geo.batch, geo.hbm_pages, geo.host_pages, geo.page_tokens
    row = (geo.kv_heads, geo.head_dim)

    def randn(*shape):
        return torch.randn(shape, device=device, dtype=torch.bfloat16)
    kh, vh = randn(B, Ph, T, *row), randn(B, Ph, T, *row)
    ke, ve = randn(B, Pe, T, *row), randn(B, Pe, T, *row)
    if pinned:
        ke, ve = ke.cpu().pin_memory(), ve.cpu().pin_memory()
    slot = np.where(np.arange(B) % 2 == 0, rng.integers(0, Ph, B),
                    Ph + rng.integers(0, Pe, B)).astype(np.int32)
    slot = torch.as_tensor(slot, device=device)
    off = torch.as_tensor(rng.integers(0, T, B).astype(np.int32),
                          device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    active[3] = False
    k_new, v_new = randn(B, *row), randn(B, *row)
    args = (kh, vh, ke, ve, slot, off, k_new, v_new)

    def write(i):
        paged.write_token_layer(*args, active=active)

    def check():
        want = [t.to(device) for t in (kh, vh, ke, ve)]
        at = (None, slot, off)
        ref.page_copy_ref((Split(want[0], want[2], 1), at, k_new, (None,)),
                          (Split(want[1], want[3], 1), at, v_new, (None,)),
                          keep=active)
        before = COUNTS["page_copy"]
        write(0)
        torch.cuda.synchronize()
        launches = COUNTS["page_copy"] - before
        return (all(torch.equal(t.to(device), w)
                    for t, w in zip((kh, vh, ke, ve), want)), launches)
    return write, check, {"slot": slot, "off": off, "active": active,
                          "args": args}


def page_copy_phase(rng, device, link):
    """The page moves of `page_moves`, each against the plain version
    (exact) and timed beside the link's peak (HBM's for the card's),
    the measured `copy_` rate and the nearest PyTorch composition; one
    layer's decode token write (K and V, both tiers, one lane inactive)
    as one launch, exact with the host tier on the card and pinned,
    timed on the card beside its bytes bound and PyTorch's indexing; and
    overlap prefill's gather of two lanes' HBM and pinned host slots
    (`transformer.lane_pages`), exact, timed beside the link's peak. The
    kernels line's ms, plain_ms and bound_ms are the pinned gather plus
    scatter."""
    import torch
    moves, x = page_moves(rng, device)
    nbytes, cap, page = x["bytes"], x["cap"], x["page"]
    at_long = tuple(i.long() for i in x["at"])
    peak = link_peak()
    parts = []
    for mv in moves:
        name, way = mv["name"], mv["way"]
        lib = None
        mv["kernel"](0)
        mv["plain"](0)
        torch.cuda.synchronize()
        same = mv["exact"]()
        if not same:
            raise AssertionError(f"page_copy {name} ({way}) disagrees with "
                                 f"the plain version")
        plain_ms = eager_ms(mv["plain"], 20)
        eager = eager_ms(mv["kernel"], 20)
        if way == "card -> card":
            # each page read once and written once, at HBM's peak; the
            # library call is PyTorch's indexing gather
            ms = device_ms(mv["kernel"], 1)
            lib = device_ms(lambda i: x["pool_card"][at_long], 1)
            bound = 2 * nbytes / HBM_BW * 1e3
            yard = f"HBM peak {HBM_BW / 1e12:.2f} TB/s; indexing {lib:.4f} ms"
        else:
            ms = eager
            rate = link["h2d" if way == "pinned -> card" else "d2h"]
            bound = nbytes / peak * 1e3
            # no one PyTorch call moves rows between a pinned pool and
            # the card by index: the nearest composition gathers (or
            # scatters) on the host through a pinned staging buffer and
            # crosses the link with copy_
            composed = host_composition_ms(x["pool"], x["flat"], x["staged"],
                                           way == "pinned -> card")
            yard = (f"link peak {peak / 1e9:.0f} GB/s; "
                    f"{nbytes / rate * 1e3:.4f} ms at the measured copy_ "
                    f"rate {rate / 1e9:.2f} GB/s; host index_select/"
                    f"index_copy_ + copy_ {composed:.4f} ms")
        log(f"page_copy {name} ({way}, {cap} pages of "
            f"{math.prod(page) * 2} B): exact {same}, "
            f"{ms:.4f} ms ({nbytes / ms / 1e6:.2f} GB/s) eager {eager:.4f} "
            f"ms plain {plain_ms:.4f} ms (device copy) bound {bound:.4f} ms "
            f"({yard})")
        parts.append({"direction": f"{name} {way}", "ms": ms,
                      "eager_ms": eager, "plain_ms": plain_ms,
                      "bound_ms": bound, "library_ms": lib,
                      "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6})
        if way != "card -> card":
            parts[-1]["host_composition_ms"] = composed
    geo = x["geo"]
    del moves, x
    parts.append(token_write_part(rng, device, geo))
    parts.append(lane_pages_part(rng, device, geo))
    pinned = parts[:2]
    return {"ms": sum(p["ms"] for p in pinned),
            "plain_ms": sum(p["plain_ms"] for p in pinned),
            "bound_ms": sum(p["bound_ms"] for p in pinned),
            "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0,
            "per_direction": parts,
            "payback_probe": payback_probe_part(device)}


def payback_probe_part(device, iters: int = 8):
    """Phase 2c's payback probe: the link rate that `measured_payback`
    hands `cost_aware`, at phase 4b's geometry with pinned host pools,
    four ways, each through the engine's own plan (`swap_plan`), timer
    (`commit_seconds`) and baseline (the empty plan over the same
    cache): the full swap plan committed `iters` times over the same
    pages, as the engine's probe does (its demotes rewrite, as
    dem_dst = pro_src, the host pages the next repeat reads); the same
    commit over pages no earlier repeat touched (a disjoint range of
    host slots each repeat); its promotes alone and its demotes alone,
    each over untouched pages too.
    Each case: the best repeat's time over the empty plan's as bytes/s
    both ways summed, the link rate the engine's formula inverts it to,
    and the spread of the per-repeat bytes/s. The empty plan is also
    timed over one-page host pools on the card: its sentinel rows each
    stage a clamped host page, which every commit reads over the link."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.kvcache.migrate import MigrationPlan
    from repro_torch.kvcache.paged import init_cache
    from repro_torch.models.model import Model
    from repro_torch.serving import control
    from repro_torch.serving.engine import (
        EngineConfig, commit_seconds, measured_link_spec, swap_plan,
    )
    ecfg = EngineConfig()
    geo = Model(configs.get("internlm2-1.8b")).cache_geometry(8, 4096, 0.25)
    cap = control.plan_capacity(geo, ecfg.migration_budget_frac)
    per = cap // (geo.num_layers * geo.batch)       # rows per (layer, lane)
    if 3 * (iters + 1) * per > geo.host_pages:
        raise ValueError("payback probe: too few host slots for the ranges")
    cache = init_cache(geo, device=device, host_pinned=True)
    empty = MigrationPlan.empty(cap, device=device)
    page = cache.k_hbm.new_zeros((1, 1, 1) + cache.k_hbm.shape[3:])
    bare = dataclasses.replace(cache, k_host=page, v_host=page.clone())
    commit_seconds(cache, empty)
    t_empty = min(commit_seconds(cache, empty) for _ in range(iters))
    commit_seconds(bare, empty)
    t_bare = min(commit_seconds(bare, empty) for _ in range(iters))
    sentinel = cap * geo.page_bytes()
    log(f"payback probe empty plan: {t_empty * 1e3:.3f} ms over the pinned "
        f"pools, {t_bare * 1e3:.3f} ms over one-page host pools on the "
        f"card (its {cap} sentinel rows stage a clamped host page each: "
        f"{sentinel / 1e6:.1f} MB read over the link, "
        f"{sentinel / max(t_empty - t_bare, 1e-9) / 1e9:.2f} GB/s)")
    r = np.arange(cap)

    def fresh(case, **kw):
        """One plan a repeat, each over its own range of `per` host
        slots of every (layer, lane), the ranges of `case` apart from
        every other case's."""
        return [swap_plan(geo, cap, device, (case * (iters + 1) + i) * per
                          + r // (geo.num_layers * geo.batch), **kw)
                for i in range(iters + 1)]
    cases = {
        "rewritten pages": ([swap_plan(geo, cap, device)] * (iters + 1), 2),
        "untouched pages": (fresh(0), 2),
        "promotes alone, untouched": (fresh(1, demotes=False), 1),
        "demotes alone, untouched": (fresh(2, promotes=False), 1),
    }
    out = {"empty plan": {"ms": t_empty * 1e3,
                          "one_page_host_ms": t_bare * 1e3}}

    def gb_per_s(nbytes, seconds):
        """Negative where the case took less than the empty plan."""
        return nbytes / seconds / 1e9 if seconds else math.inf
    for name, (plans, ways) in cases.items():
        commit_seconds(cache, plans[0])            # warm (its own pages)
        times = [commit_seconds(cache, p) for p in plans[1:]]
        moved = ways * cap * geo.page_bytes()
        delta = min(times) - t_empty
        rates = [gb_per_s(moved, t - t_empty) for t in times]
        link = measured_link_spec(ecfg.spec, delta, moved, cap)[1][
            "measured_link_bw"]
        out[name] = {"gb_per_s": gb_per_s(moved, delta),
                     "link_gb_per_s": None if link is None else link / 1e9,
                     "spread": [min(rates), max(rates)], "bytes": moved,
                     "delta_ms": delta * 1e3}
        log(f"payback probe {name}: {cap} rows, {moved / 1e6:.1f} MB, "
            f"{delta * 1e3:.3f} ms over the empty plan -> "
            f"{out[name]['gb_per_s']:.2f} GB/s (repeats {min(rates):.2f}-"
            f"{max(rates):.2f}), engine formula link "
            f"{'None' if link is None else f'{link / 1e9:.2f} GB/s'} "
            f"(modeled {ecfg.spec.link_bw / 1e9:.0f} GB/s each way)")
    return out


def token_write_part(rng, device, geo):
    """Phase 2c's token write: exact and one launch with the host tier
    pinned and on the card; timed with both tiers on the card (inline
    mode, phase 4's path)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.page_copy import Split
    for pinned in (True, False):
        write, check, a = token_write_case(rng, device, geo, pinned)
        same, launches = check()
        where = "pinned" if pinned else "on the card"
        log(f"page_copy token write ({geo.batch} lanes x K and V of "
            f"{geo.kv_heads * geo.head_dim * 2} B, both tiers, host tier "
            f"{where}, lane 3 inactive): exact {same}, {launches} launch")
        if not same or launches != 1:
            raise AssertionError(f"page_copy token write ({where}): exact "
                                 f"{same}, {launches} launches (one "
                                 f"expected)")
    kh, vh, ke, ve, slot, off, k_new, v_new = a["args"]
    Ph = geo.hbm_pages
    keep = a["active"]
    lanes = torch.arange(geo.batch, device=device)
    # PyTorch's indexing, the tiers' lanes and slots found beforehand
    hb, eb = lanes[keep & (slot < Ph)], lanes[keep & (slot >= Ph)]
    hs, es = slot[hb].long(), slot[eb].long() - Ph
    ho, eo = off[hb].long(), off[eb].long()

    def library(i):
        kh[hb, hs, ho] = k_new[hb]
        vh[hb, hs, ho] = v_new[hb]
        ke[eb, es, eo] = k_new[eb]
        ve[eb, es, eo] = v_new[eb]

    def plain(i):
        at = (None, slot, off)
        ref.page_copy_ref((Split(kh, ke, 1), at, k_new, (None,)),
                          (Split(vh, ve, 1), at, v_new, (None,)), keep=keep)
    ms = device_ms(write, 1)
    eager = eager_ms(write, 200)
    lib = device_ms(library, 1)
    plain_ms = eager_ms(plain, 20)
    rows = int(keep.sum())
    row_bytes = geo.kv_heads * geo.head_dim * 2
    # each kept row read once and written once, K and V; slot, offset
    # and keep read once
    nbytes = 2 * 2 * rows * row_bytes + geo.batch * (4 + 4 + 1)
    bound = nbytes / HBM_BW * 1e3
    log(f"page_copy token write (one launch, both tiers on the card): "
        f"device {ms:.4f} ms eager {eager:.4f} ms plain {plain_ms:.4f} ms "
        f"indexing {lib:.4f} ms (4 index assignments) bound {bound:.6f} ms "
        f"({nbytes} B at HBM's peak)")
    return {"direction": "token write card -> card (K and V, both tiers, "
            "lane 3 inactive)", "ms": ms, "eager_ms": eager,
            "plain_ms": plain_ms, "bound_ms": bound, "library_ms": lib,
            "library": "4 index assignments pool[b, slot, off] = val",
            "bytes": nbytes, "launches": 1}


def lane_pages_part(rng, device, geo, lanes=(1, 6), seen=(64, 100)):
    """Overlap prefill's gather of `lanes`' first seen[0] HBM slots and
    seen[1] pinned host slots (`transformer.lane_pages`, K and V in one
    launch) at phase 4's geometry: exact against the tiers' slots
    concatenated on the card, timed eagerly beside the link's peak for
    the host bytes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import COUNTS
    from repro_torch.kernels.page_copy import Split
    from repro_torch.models import transformer
    B, Ph, Pe, T = geo.batch, geo.hbm_pages, geo.host_pages, geo.page_tokens
    row = (geo.kv_heads, geo.head_dim)

    def randn(*shape):
        return torch.randn(shape, device=device, dtype=torch.bfloat16)
    card = [randn(B, Ph, T, *row), randn(B, Ph, T, *row),
            randn(B, Pe, T, *row), randn(B, Pe, T, *row)]
    pools = card[:2] + [p.cpu().pin_memory() for p in card[2:]]
    lane_t = torch.as_tensor(lanes, device=device)
    n_h, n_e = seen
    before = COUNTS["page_copy"]
    keys, vals = transformer.lane_pages(pools, lane_t, seen)
    torch.cuda.synchronize()
    launches = COUNTS["page_copy"] - before
    li = lane_t.long()
    same = all(torch.equal(got, torch.cat([h[li, :n_h], e[li, :n_e]], 1))
               for got, h, e in ((keys, card[0], card[2]),
                                 (vals, card[1], card[3])))
    eager = eager_ms(lambda i: transformer.lane_pages(pools, lane_t, seen),
                     20)
    n = n_h + n_e
    at = (lane_t.to(torch.int32).repeat_interleave(n),
          torch.arange(n, dtype=torch.int32, device=device).repeat(len(lanes)))
    out = [torch.empty((len(lanes) * n, T) + row, dtype=torch.bfloat16,
                       device=device) for _ in range(2)]

    def plain(i):                   # on the card copies of the pools
        ref.page_copy_ref(
            (out[0], (None,), Split(card[0], card[2], 1, n_h), at),
            (out[1], (None,), Split(card[1], card[3], 1, n_h), at))
    plain_ms = eager_ms(plain, 20)
    page_bytes = T * math.prod(row) * 2
    host = 2 * len(lanes) * n_e * page_bytes
    total = 2 * len(lanes) * (n_h + n_e) * page_bytes
    bound = max(host / link_peak(), 2 * (total - host) / HBM_BW) * 1e3
    log(f"page_copy prefill gather ({len(lanes)} lanes x ({n_h} HBM + {n_e} "
        f"pinned host) pages, K and V): exact {same}, {launches} launch, "
        f"{eager:.4f} ms eager ({host / eager / 1e6:.2f} GB/s over the "
        f"link) plain {plain_ms:.4f} ms (device copies) bound "
        f"{bound:.4f} ms ({host / 1e6:.2f} MB at the link's peak)")
    if not same or launches != 1:
        raise AssertionError(f"page_copy prefill gather: exact {same}, "
                             f"{launches} launches (one expected)")
    return {"direction": "prefill gather pinned + card -> card (lane_pages)",
            "ms": eager, "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": bound, "library_ms": None, "bytes": total,
            "link_bytes": host,
            "launches": launches}


# --------------------------------------------------------------------------
# phase 2b: the flash kernel against its plain version
# --------------------------------------------------------------------------

#: (label, B, Sq, Sk, H, KH, D, dtype name, causal, timed): the
#: prefills of the main paths are timed — internlm2-1.8b's (phase 5)
#: and internvl2-2b's (phase 10: 2048 tokens + 256 patches), granite-
#: moe-3b-a800m's (phase 7, H/KH = 3), stablelm-12b's (phase 10, D =
#: 160), granite-8b's (phase 10, H/KH = 4), whisper-tiny's encoder
#: (phase 10: non-causal, G = 1, S = 1500) and its cross-attention in
#: prefill (Sq = 64 over Sk = 1500), zamba2-1.2b's attention sites
#: (phase 10: H = KH = 32, D = 64), and a training rank's (phase 14:
#: internlm2 at data = 2, 4 rows of 512, over model = 2 and 4); the
#: others are checked
FLASH_SHAPES = (
    ("internlm2-1.8b", 4, 2304, 2304, 16, 8, 128, "bf16", True, True),
    ("granite-moe-3b-a800m", 4, 2304, 2304, 24, 8, 64, "bf16", True, True),
    ("stablelm-12b", 4, 2304, 2304, 32, 8, 160, "bf16", True, True),
    ("granite-8b", 4, 2304, 2304, 32, 8, 128, "bf16", True, True),
    ("whisper-tiny encoder", 4, 1500, 1500, 6, 6, 64, "bf16", False, True),
    ("zamba2-1.2b", 4, 2304, 2304, 32, 32, 64, "bf16", True, True),
    ("ragged S, H = KH = 32", 2, 999, 999, 32, 32, 64, "bf16", True, False),
    ("ragged S, KH == H", 2, 1000, 1000, 16, 16, 128, "bf16", True, False),
    ("not causal", 2, 1000, 1000, 16, 8, 128, "bf16", False, False),
    ("smoke f32", 2, 300, 300, 4, 2, 16, "f32", True, False),
    ("D=64, ragged S", 2, 1000, 1000, 16, 8, 64, "bf16", True, False),
    ("H/KH = 3 f32", 2, 1000, 1000, 24, 8, 64, "f32", True, False),
    ("D=160 f32", 2, 1000, 1000, 32, 8, 160, "f32", True, False),
    ("D=160 ragged S", 2, 999, 999, 32, 8, 160, "bf16", True, False),
    # whisper's decoder in phase 10 (64-token prompts at B=4) and its
    # cross-attention over 1500 frames: the prompt's queries in prefill,
    # one query at decode; the keys past 1500 must be masked
    ("whisper-tiny decoder self", 4, 64, 64, 6, 6, 64, "bf16", True,
     False),
    ("whisper-tiny cross, prefill", 4, 64, 1500, 6, 6, 64, "bf16", False,
     True),
    ("whisper-tiny cross, ragged Sq", 4, 37, 1500, 6, 6, 64, "bf16", False,
     False),
    ("whisper-tiny cross, decode", 4, 1, 1500, 6, 6, 64, "bf16", False,
     False),
    # a rank's training shapes across a mesh (phase 14): internlm2 at
    # data = 2 (4 rows of 512) over model = 2 and 4
    ("internlm2-1.8b train rank, model=2", 4, 512, 512, 8, 4, 128, "bf16",
     True, True),
    ("internlm2-1.8b train rank, model=4", 4, 512, 512, 4, 2, 128, "bf16",
     True, True),
    # granite-moe's training shape (phase 15c)
    ("granite-moe-3b-a800m train", 8, 512, 512, 24, 8, 64, "bf16", True,
     True),
    # a meshed engine's `start` at a rank's heads (phase 17b): the whole
    # prompt of internlm2 and llama31-8b over model = 2 and 4
    ("internlm2-1.8b prefill rank, model=2", 4, 2304, 2304, 8, 4, 128,
     "bf16", True, True),
    ("internlm2-1.8b prefill rank, model=4", 4, 2304, 2304, 4, 2, 128,
     "bf16", True, True),
    ("llama31-8b prefill rank, model=2", 4, 2304, 2304, 16, 4, 128,
     "bf16", True, True),
    ("llama31-8b prefill rank, model=4", 4, 2304, 2304, 8, 2, 128,
     "bf16", True, True),
    # phase 16's training ranks: internvl2 (256 patches + 512 tokens),
    # whisper's encoder, decoder and cross-attention and zamba2's sites,
    # at model = 2 and 4
    ("internvl2-2b train rank, model=2", 8, 768, 768, 8, 4, 128, "bf16",
     True, False),
    ("internvl2-2b train rank, model=4", 8, 768, 768, 4, 2, 128, "bf16",
     True, False),
    ("whisper-tiny encoder train rank, model=2", 8, 1500, 1500, 3, 3, 64,
     "bf16", False, False),
    ("whisper-tiny decoder train rank, model=2", 8, 512, 512, 3, 3, 64,
     "bf16", True, False),
    ("whisper-tiny cross train rank, model=2", 8, 512, 1500, 3, 3, 64,
     "bf16", False, True),
    ("zamba2-1.2b train rank, model=2", 8, 512, 512, 16, 16, 64, "bf16",
     True, False),
    ("zamba2-1.2b train rank, model=4", 8, 512, 512, 8, 8, 64, "bf16",
     True, False),
    # phase 19's training ranks over 16 model ranks that do not divide
    # the KV heads: a rank's query heads over the one KV head they read
    # (internlm2: 1 over 1, timed; qwen3-32b: 4 over 1), and 19b's f32
    ("internlm2-1.8b train rank, model=16", 8, 512, 512, 1, 1, 128, "bf16",
     True, True),
    ("qwen3-32b train rank, model=16", 8, 512, 512, 4, 1, 128, "bf16",
     True, False),
    ("internlm2-1.8b f32 train rank, model=16", 8, 512, 512, 1, 1, 128,
     "f32", True, False),
)
FLASH_TOL = {"bf16": 1e-2, "f32": 2e-5}


def flash_work(B, Sq, Sk, H, KH, D, causal, itemsize):
    """(bytes, flops) of one call: q, k, v read once and out written
    once; 4*D flops per visible (query, key) pair per head (queries
    aligned at key 0 when causal)."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    return (2 * B * Sq * H * D + 2 * B * Sk * KH * D) * itemsize, \
        4 * B * H * D * pairs


def flash_phase(device):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    errs = []
    timed = []
    for label, B, Sq, Sk, H, KH, D, dt, causal, is_timed in FLASH_SHAPES:
        dtype = dtypes[dt]

        def inputs():
            return (torch.randn((B, Sq, H, D), device=device, dtype=dtype),
                    torch.randn((B, Sk, KH, D), device=device, dtype=dtype),
                    torch.randn((B, Sk, KH, D), device=device, dtype=dtype))
        x = inputs()
        got = fa.flash_attention(*x, causal=causal)
        want = ref.flash_attention_ref(*x, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs.append(err)
        shape = f"B={B} Sq={Sq} Sk={Sk} H={H}/{KH} D={D}"
        log(f"flash {label}: {shape} {dt} causal={causal}: max err out "
            f"{err:.3e} (tolerance {FLASH_TOL[dt]})")
        if not err <= FLASH_TOL[dt]:
            raise AssertionError(f"flash kernel disagrees with the plain "
                                 f"version at {label}: {shape} {dt}")
        if not is_timed:
            continue
        nbytes, flops = flash_work(B, Sq, Sk, H, KH, D, causal,
                                   got.element_size())
        copies = max(2, math.ceil(256e6 / nbytes))    # beat the 50 MB L2
        sets = [x] + [inputs() for _ in range(copies - 1)]
        # SDPA's layout, made outside the timed region
        bhsd = [tuple(t.transpose(1, 2).contiguous() for t in s)
                for s in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def kernel(i):
            return fa.flash_attention(*sets[i % copies], causal=causal)

        def plain(i):
            return ref.flash_attention_ref(*sets[i % copies], causal=causal)

        def library(i):
            return sdpa(*bhsd[i % copies], is_causal=causal, enable_gqa=True)

        ms = device_ms(kernel, copies)
        plain_ms = device_ms(plain, copies, reps=2)
        lib_ms = device_ms(library, copies)
        kernel_eager = eager_ms(kernel, 20)
        t_bytes, t_ops = nbytes / HBM_BW * 1e3, flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"flash {label}: {shape}: device {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bound:.4f} ms "
            f"(operations {t_ops:.4f}, bytes {t_bytes:.4f}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)  eager call "
            f"{kernel_eager:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s")
        timed.append({"model": label,
                      "shape": [B, Sq, Sk, H, KH, D, dt, causal], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "eager_ms": kernel_eager,
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "bytes": nbytes, "flops": flops,
                      "tflops": flops / ms / 1e9, "max_abs_err": err})
        del sets, bhsd
    # the line's numbers are internlm2's prefill; the others in per_shape
    return {**{k: v for k, v in timed[0].items()
               if k not in ("shape", "model")},
            "max_abs_err": max(errs), "per_shape": timed}

# --------------------------------------------------------------------------
# phase 2d: the flash backward kernel against its plain version
# --------------------------------------------------------------------------

#: (label, B, Sq, Sk, H, KH, D, dtype name, causal, timed): phase 12's
#: training shape is timed (internlm2-1.8b, S = 512 after the shift by
#: one), and a rank's at data = 2 over model = 2 and 4 (phase 14); the
#: others are checked
BWD_SHAPES = (
    ("internlm2-1.8b train", 8, 512, 512, 16, 8, 128, "bf16", True, True),
    ("smoke f32, ragged S", 2, 300, 300, 4, 2, 16, "f32", True, False),
    ("H/KH = 3", 2, 1000, 1000, 24, 8, 64, "bf16", True, False),
    ("H = KH = 32", 2, 700, 700, 32, 32, 64, "bf16", True, False),
    ("D=160 ragged S", 2, 300, 300, 32, 8, 160, "bf16", True, False),
    ("whisper-tiny cross", 4, 64, 1500, 6, 6, 64, "bf16", False, False),
    ("internlm2-1.8b train rank, model=2", 4, 512, 512, 8, 4, 128, "bf16",
     True, True),
    ("internlm2-1.8b train rank, model=4", 4, 512, 512, 4, 2, 128, "bf16",
     True, True),
    ("granite-moe-3b-a800m train", 8, 512, 512, 24, 8, 64, "bf16", True,
     True),
    # phase 16's training ranks, as in FLASH_SHAPES
    ("internvl2-2b train rank, model=2", 8, 768, 768, 8, 4, 128, "bf16",
     True, False),
    ("internvl2-2b train rank, model=4", 8, 768, 768, 4, 2, 128, "bf16",
     True, False),
    ("whisper-tiny encoder train rank, model=2", 8, 1500, 1500, 3, 3, 64,
     "bf16", False, False),
    ("whisper-tiny decoder train rank, model=2", 8, 512, 512, 3, 3, 64,
     "bf16", True, False),
    ("whisper-tiny cross train rank, model=2", 8, 512, 1500, 3, 3, 64,
     "bf16", False, True),
    ("zamba2-1.2b train rank, model=2", 8, 512, 512, 16, 16, 64, "bf16",
     True, False),
    ("zamba2-1.2b train rank, model=4", 8, 512, 512, 8, 8, 64, "bf16",
     True, False),
    # phase 19's, as in FLASH_SHAPES
    ("internlm2-1.8b train rank, model=16", 8, 512, 512, 1, 1, 128, "bf16",
     True, True),
    ("qwen3-32b train rank, model=16", 8, 512, 512, 4, 1, 128, "bf16",
     True, False),
    ("internlm2-1.8b f32 train rank, model=16", 8, 512, 512, 1, 1, 128,
     "f32", True, False),
)
#: max abs error of each of dq, dk, dv over that gradient's max |value|:
#: bf16 gradients are rounded once (one bf16 step is 2^-8 relative),
#: f32 ones sum in another order than the plain version
BWD_TOL = {"bf16": 1e-2, "f32": 1e-4}


def flash_bwd_work(B, Sq, Sk, H, KH, D, causal, itemsize):
    """(bytes, flops) of one backward: q, k, v, out, dout and the f32
    LSE read once, dq, dk, dv written once; 2.5x the forward's flops
    (the forward's two products and the backward's five, one of them
    the recomputed S: 10 against 4 flops per visible pair and dim)."""
    _, fwd = flash_work(B, Sq, Sk, H, KH, D, causal, itemsize)
    return ((4 * B * Sq * H * D + 4 * B * Sk * KH * D) * itemsize
            + 4 * B * H * Sq), 2.5 * fwd


def spun_ms(setup, fn, reps: int) -> float:
    """Mean device milliseconds of fn(setup(i)) over `reps` calls, each
    timed alone by CUDA events with `setup` outside the timed region: a
    spin kernel keeps the card busy while the host queues fn, so the
    host's cost of issuing it is not in the time."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn(setup(0))
    total = 0.0
    for i in range(reps):
        args = setup(i)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(args)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def demangled(mangled: str) -> str:
    """`base<template ints>` of a kernel's mangled name (its last
    length-prefixed part), with `bf16` or `f32` first where the kernel
    takes an element type; the name as given if it is not nested."""
    i, parts = mangled.find("_ZN") + 3, []
    while 2 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        parts.append(mangled[j:j + n])
        i = j + n
    args = re.match(r"I(.*?E)E", mangled[i:]) if parts else None
    if not args:
        return parts[-1] if parts else mangled
    ints = re.findall(r"Li(\d+)E", args.group(1))
    kind = ("bf16," if "bfloat16" in args.group(1) else
            "f32," if args.group(1).startswith("f") else "")
    return f"{parts[-1]}<{kind}{','.join(ints)}>"


def ptxas_usage(report: str):
    """{kernel: (registers, spill store bytes, spill load bytes)} of each
    entry function in ptxas' report, named as `demangled` names it."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            current = [demangled(m.group(1)), 0, 0, 0]
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current[2:4] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current[1] = int(m.group(1))
            out[current[0]] = tuple(current[1:])
            current = None
    return out


def sass_hgmma(lib) -> dict:
    """{function: whether its SASS holds an HGMMA instruction} of every
    function `cuobjdump -sass` finds in the built library."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        out[part.split()[0]] = "HGMMA" in part
    return out


def bwd_build_check(lib, report):
    """Phase 2d's build check: ptxas' registers and spills of the
    backward's delta, dkdv and dq kernels, and HGMMA in the SASS of
    every instance of the bf16 `dkdv` and `dq` bodies (failing if one
    has none, or if one of them spills)."""
    usage = ptxas_usage(report)
    for name, (regs, st, ld) in sorted(usage.items()):
        log(f"flash bwd ptxas {name}: {regs} registers, spill stores {st} "
            f"bytes, spill loads {ld} bytes")
    hgmma = {f: ok for f, ok in sass_hgmma(lib).items()
             if "wgmma_kernel" in f}
    bodies = {f for f in hgmma if "dkdv_wgmma" in f}, \
        {f for f in hgmma if "dq_wgmma" in f}
    log(f"flash bwd sass: HGMMA in {sum(hgmma.values())} of {len(hgmma)} "
        f"tensor-core bodies ({len(bodies[0])} dkdv, {len(bodies[1])} dq)")
    if not all(bodies) or not all(hgmma.values()):
        raise AssertionError(f"a tensor-core body of the backward has no "
                             f"HGMMA: {hgmma}")
    spilled = {n: u for n, u in usage.items()
               if "wgmma" in n and (u[1] or u[2])}
    if spilled:
        raise AssertionError(f"the backward's tensor-core bodies spill "
                             f"registers: {spilled}")
    return {n: u for n, u in usage.items() if "<f32" not in n}


def flash_bwd_phase(device, built):
    """Phase 2d: the build check (`bwd_build_check`, on `built`: the
    library and ptxas' report from `build.build_all`), then the backward
    kernel against `ref.flash_attention_bwd_ref` on the forward kernel's
    own `out` and LSE (the LSE checked against the plain forward's),
    twice for determinism (bitwise); the training shape timed beside the
    plain version, one SDPA backward and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    registers = bwd_build_check(*built)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    errs, rels, timed = [], [], []
    for label, B, Sq, Sk, H, KH, D, dt, causal, is_timed in BWD_SHAPES:
        dtype = dtypes[dt]

        def inputs():
            q = torch.randn((B, Sq, H, D), device=device, dtype=dtype)
            k = torch.randn((B, Sk, KH, D), device=device, dtype=dtype)
            v = torch.randn((B, Sk, KH, D), device=device, dtype=dtype)
            out, lse = fa.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
            return q, k, v, out, torch.randn_like(out), lse
        x = inputs()
        _, want_lse = ref.flash_attention_ref(*x[:3], causal=causal,
                                              return_lse=True)
        err_lse = float((x[5] - want_lse).abs().max())
        got = fa.flash_attention_bwd(*x, causal=causal)
        again = fa.flash_attention_bwd(*x, causal=causal)
        want = ref.flash_attention_bwd_ref(*x, causal)
        torch.cuda.synchronize()
        err = [float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want)]
        rel = [e / float(b.float().abs().max()) for e, b in zip(err, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs.append(max(err))
        rels.append(max(rel))
        shape = f"B={B} Sq={Sq} Sk={Sk} H={H}/{KH} D={D}"
        log(f"flash bwd {label}: {shape} {dt} causal={causal}: dq dk dv "
            f"max abs err {err[0]:.3e} {err[1]:.3e} {err[2]:.3e}, "
            f"{rel[0]:.3e} {rel[1]:.3e} {rel[2]:.3e} of max |grad| "
            f"(tolerance {BWD_TOL[dt]}), lse err {err_lse:.3e} (tolerance "
            f"{TOL['lse']}), two runs bitwise equal {same}")
        if not (max(rel) <= BWD_TOL[dt] and err_lse <= TOL["lse"] and same):
            raise AssertionError(f"flash backward disagrees with the plain "
                                 f"version or is not deterministic at "
                                 f"{label}: {shape} {dt}")
        if not is_timed:
            continue
        nbytes, flops = flash_bwd_work(B, Sq, Sk, H, KH, D, causal,
                                       got[0].element_size())
        copies = max(2, math.ceil(256e6 / nbytes))    # beat the 50 MB L2
        sets = [x] + [inputs() for _ in range(copies - 1)]

        def kernel(i):
            return fa.flash_attention_bwd(*sets[i % copies], causal=causal)

        def plain(i):
            return ref.flash_attention_bwd_ref(*sets[i % copies], causal)

        sdpa = torch.nn.functional.scaled_dot_product_attention

        def sdpa_forward(i):
            """SDPA's forward on [B, H, S, D] copies (not timed): its
            output, inputs and the incoming gradient."""
            q, k, v, _, g, _ = sets[i % copies]
            leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v)]
            out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
            return out, leaves, g.transpose(1, 2).contiguous()

        def library(args):
            out, leaves, g = args
            return torch.autograd.grad(out, leaves, g)

        ms = device_ms(kernel, copies)
        plain_ms = device_ms(plain, copies, reps=2)
        lib_ms = spun_ms(sdpa_forward, library, 20)
        kernel_spun = spun_ms(lambda i: i, kernel, 20)
        t_bytes, t_ops = nbytes / HBM_BW * 1e3, flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"flash bwd {label}: {shape}: device {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  sdpa backward {lib_ms:.4f} ms  bound "
            f"{bound:.4f} ms (operations {t_ops:.4f}, bytes {t_bytes:.4f}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)  timed alone "
            f"as sdpa {kernel_spun:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s")
        timed.append({"model": label,
                      "shape": [B, Sq, Sk, H, KH, D, dt, causal], "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "spun_ms": kernel_spun,
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "bytes": nbytes, "flops": flops,
                      "tflops": flops / ms / 1e9, "max_abs_err": max(err),
                      "max_rel_err": max(rel)})
        del sets
    return {**{k: v for k, v in timed[0].items()
               if k not in ("shape", "model")},
            "max_abs_err": max(errs), "max_rel_err": max(rels),
            "per_shape": timed, "ptxas": registers}



# --------------------------------------------------------------------------
# phase 2e: the AdamW kernels against their plain versions
# --------------------------------------------------------------------------

#: phase 2e's trees: internlm2-1.8b's parameter leaves at full width
#: (phase 12's: the stacked layers, the embedding and the head), bf16 at
#: all 24 layers and f32 at 6 (at 24 the f32 tree, its gradient, m, v
#: and the pure update's new tensors would take 53 GB before the plain
#: version's and the donated copies')
ADAMW_TREES = (("bf16", 24), ("f32", 6))
#: each leaf's sum of squares against the plain `g.float().square()
#: .sum()`, relative: the kernel adds the f32 squares in f64 and rounds
#: the total once, the plain version adds them in f32 in its own tree
#: (both within ~1e-7 of the exact sum at 4e8 elements)
SUMSQ_RTOL = 1e-6


def adamw_tree(dtype, layers, device, seed, arch="internlm2-1.8b"):
    """(grads, params, m, v): random lists shaped as `arch`'s parameter
    leaves at full width and `layers` layers, drawn on the card:
    gradients ~ 1e-4 and parameters ~ 2e-2 in `dtype`, m ~ 1e-3 and
    v ~ 1e-6 (non-negative) in f32."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.models.params import abstract_params
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(configs.get(arch), num_layers=layers)
    shapes = [tuple(t.shape) for t in tree_leaves(abstract_params(
        Model(cfg).schema(), cfg.param_dtype))]
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, std, out_dtype, square=False):
        x = torch.randn(shape, generator=gen, device=device)
        x = x.square_() if square else x
        return x.mul_(std).to(out_dtype)
    return ([draw(s, 1e-4, dtype) for s in shapes],
            [draw(s, 2e-2, dtype) for s in shapes],
            [draw(s, 1e-3, torch.float32) for s in shapes],
            [draw(s, 1e-6, torch.float32, square=True) for s in shapes])


def adamw_phase(device, seed):
    """Phase 2e: the two AdamW kernels (`kernels/adamw.py`) against
    their plain versions (`ref.grad_sumsq_ref`, `ref.adamw_apply_ref`)
    on ADAMW_TREES. The sums: each leaf's within SUMSQ_RTOL of the
    plain sum and two runs bitwise equal. The update, with the
    clip active (grad_clip half the norm, lr a tensor on the card: the
    cosine schedule's) and idle (twice the norm, lr TRAIN_LR), step 3:
    pure (new tensors) and donated (in place, on copies of p, m, v) both
    bitwise equal to the plain version given the same scale, lr and
    bias corrections. Each timed at the bf16 tree (the update in place,
    as the donated step runs it) beside the plain version and the bound
    (bytes over HBM_BW; no PyTorch call computes either function).
    Returns the two kernels' entries for the `kernels` line."""
    import torch
    from repro_torch.kernels import adamw, ref
    from repro_torch.training.optimizer import cosine_schedule
    sums_rows, update_rows = [], []
    for label, layers in ADAMW_TREES:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[label]
        free_card()
        g, p, m, v = adamw_tree(dtype, layers, device, seed)
        n = sum(t.numel() for t in p)
        what = f"internlm2-1.8b leaves, {layers} layers, {label}"
        sums = adamw.grad_sumsq(g)
        same = torch.equal(sums, adamw.grad_sumsq(g))
        plain = ref.grad_sumsq_ref(g)
        rel = float(((sums.double() - plain.double()).abs()
                     / plain.double()).max())
        g_bytes = sum(t.nbytes for t in g)
        row = {"tree": what, "leaves": len(g), "params": n,
               "max_abs_err": float((sums - plain).abs().max()),
               "max_rel_err": rel, "bitwise_runs": same,
               "bound_ms": (g_bytes + sums.nbytes) / HBM_BW * 1e3}
        if label == "bf16":
            row["ms"] = eager_ms(lambda _: adamw.grad_sumsq(g), 10)
            row["plain_ms"] = eager_ms(lambda _: ref.grad_sumsq_ref(g), 3)
        log(f"adamw grad_sumsq {what} ({len(g)} leaves, {n / 1e9:.3f} B "
            f"params): each leaf's sum within {rel:.3e} of the plain sum "
            f"(tolerance {SUMSQ_RTOL}), two runs bitwise equal {same}"
            + (f"; device {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} "
               f"ms  bound {row['bound_ms']:.4f} ms (bytes, "
               f"{g_bytes / 1e9:.2f} GB)" if "ms" in row else ""))
        if not (rel <= SUMSQ_RTOL and same):
            raise AssertionError(f"adamw grad_sumsq {what}: the sums "
                                 f"disagree with the plain version or "
                                 f"differ between runs")
        sums_rows.append(row)

        norm = torch.sqrt(sums.sum())
        step = torch.tensor(3, dtype=torch.int32, device=device)
        stepf = step.float()
        outs = [[torch.empty_like(t) for t in ts] for ts in (p, m, v)]
        for clip, lr in (("active", cosine_schedule(step)),
                         ("idle", TRAIN_LR)):
            grad_clip = float(norm) * (0.5 if clip == "active" else 2.0)
            scalars = dict(
                scale=torch.clamp(grad_clip / torch.clamp(norm, min=1e-12),
                                  max=1.0),
                lr=lr, bc1=1 - torch.pow(0.9, stepf),
                bc2=1 - torch.pow(0.95, stepf), b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1)
            adamw.adamw_apply(g, p, m, v, *outs, **scalars)
            pure = True
            for i in range(len(p)):             # the plain version, leaf
                want = [torch.empty_like(t) for t in (p[i], m[i], v[i])]
                ref.adamw_apply_ref([g[i]], [p[i]], [m[i]], [v[i]],
                                    *([w] for w in want), **scalars)
                pure &= all(torch.equal(a[i], b)
                            for a, b in zip(outs, want))
                del want
            copies = [[t.clone() for t in ts] for ts in (p, m, v)]
            adamw.adamw_apply(g, *copies, *copies, **scalars)
            donated = all(torch.equal(a, b) for x, y in zip(copies, outs)
                          for a, b in zip(x, y))
            moved = sum(t.nbytes for ts in (g, p, m, v, *outs) for t in ts)
            row = {"tree": what, "clip": clip, "leaves": len(p), "params": n,
                   "scale": float(scalars["scale"]), "pure_bitwise": pure,
                   "donated_bitwise": donated,
                   "bound_ms": moved / HBM_BW * 1e3, "bytes": moved}
            if label == "bf16" and clip == "active":
                row["ms"] = eager_ms(lambda _: adamw.adamw_apply(
                    g, *copies, *copies, **scalars), 5)
                row["pure_ms"] = eager_ms(lambda _: adamw.adamw_apply(
                    g, p, m, v, *outs, **scalars), 5)
                row["plain_ms"] = eager_ms(lambda _: ref.adamw_apply_ref(
                    g, p, m, v, *outs, **scalars), 2)
            lr_is = "a tensor" if isinstance(lr, torch.Tensor) else lr
            log(f"adamw adamw_apply {what}, clip {clip} (scale "
                f"{row['scale']:.4f}, lr {lr_is}): "
                f"pure bitwise the plain version {pure}, donated (in place) "
                f"bitwise {donated}"
                + (f"; device in place {row['ms']:.4f} ms  pure "
                   f"{row['pure_ms']:.4f} ms  plain {row['plain_ms']:.4f} "
                   f"ms  bound {row['bound_ms']:.4f} ms (bytes, "
                   f"{moved / 1e9:.2f} GB: {moved / n:.0f} a parameter)"
                   if "ms" in row else ""))
            if not (pure and donated):
                raise AssertionError(f"adamw adamw_apply {what}, clip "
                                     f"{clip}: the kernel's update is not "
                                     f"the plain version's, bitwise")
            update_rows.append(row)
            del copies
        del g, p, m, v, outs
    # granite-moe-3b-a800m's tree (phase 15c's), timed alone: its 47.7 GB
    # leave no room for the pure update's new tensors, so the update runs
    # in place and the sums are held to the plain ones
    free_card()
    what = "granite-moe-3b-a800m leaves, 32 layers, bf16"
    g, p, m, v = adamw_tree(torch.bfloat16, 32, device, seed,
                            "granite-moe-3b-a800m")
    n = sum(t.numel() for t in p)
    sums = adamw.grad_sumsq(g)
    plain = ref.grad_sumsq_ref(g).double()
    rel = float(((sums.double() - plain).abs() / plain).max())
    step = torch.tensor(3, dtype=torch.int32, device=device)
    scalars = dict(scale=torch.tensor(0.5, device=device), lr=TRAIN_LR, bc1=1 - torch.pow(0.9, step.float()),
                   bc2=1 - torch.pow(0.95, step.float()), b1=0.9, b2=0.95,
                   eps=1e-8, weight_decay=0.1)
    moved = sum(t.nbytes for ts in (g, p, m, v, p, m, v) for t in ts)
    g_bytes = sum(t.nbytes for t in g)
    sums_rows.append({"tree": what, "leaves": len(g), "params": n,
                      "max_rel_err": rel, "max_abs_err": float(
                          (sums.double() - plain).abs().max()),
                      "ms": eager_ms(lambda _: adamw.grad_sumsq(g), 10),
                      "bound_ms": (g_bytes + sums.nbytes) / HBM_BW * 1e3})
    update_rows.append({"tree": what, "leaves": len(p), "params": n,
                        "ms": eager_ms(lambda _: adamw.adamw_apply(
                            g, p, m, v, p, m, v, **scalars), 5),
                        "bound_ms": moved / HBM_BW * 1e3, "bytes": moved})
    finite = all(bool(torch.isfinite(t).all()) for t in p)
    log(f"adamw {what} ({len(p)} leaves, {n / 1e9:.3f} B params): "
        f"grad_sumsq {sums_rows[-1]['ms']:.4f} ms (bound "
        f"{sums_rows[-1]['bound_ms']:.4f}; each leaf's sum within "
        f"{rel:.3e} of the plain sum), adamw_apply in place "
        f"{update_rows[-1]['ms']:.4f} ms (bound "
        f"{update_rows[-1]['bound_ms']:.4f}, {moved / 1e9:.2f} GB), "
        f"parameters finite {finite}")
    if not (rel <= SUMSQ_RTOL and finite):
        raise AssertionError(f"adamw {what}: sums off by {rel:.3e} or "
                             f"parameters not finite")
    del g, p, m, v
    free_card()
    sums_entry = {**{k: v for k, v in sums_rows[0].items() if k != "tree"},
                  "max_abs_err": max(r["max_abs_err"] for r in sums_rows),
                  "max_rel_err": max(r["max_rel_err"] for r in sums_rows),
                  "bound_by": "bytes", "library_ms": None,
                  "per_shape": sums_rows}
    update_entry = {**{k: v for k, v in update_rows[0].items()
                       if k not in ("tree", "clip")},
                    "max_abs_err": 0.0, "bound_by": "bytes",
                    "library_ms": None, "per_shape": update_rows}
    return sums_entry, update_entry


# --------------------------------------------------------------------------
# phases 3-5: serving
# --------------------------------------------------------------------------

def smoke_f32(name, **moe_kw):
    """The smoke config of `name` in float32 (moe overrides applied)."""
    import dataclasses
    import torch
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_smoke(name), dtype=torch.float32,
                              param_dtype=torch.float32)
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return cfg


def card_vs_cpu(cfg, ecfg, reqs_of, seed, **serve_kw):
    """One stream served on the card and on the CPU with the same
    weights: per device (tokens, statuses with error codes, step bytes,
    events but an SLO shed's wall-clock reason), and the engines."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    runs, engines = {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(model, params, ecfg, device=dev)
        rep = eng.serve(reqs_of(), **serve_kw)
        runs[dev] = ({r.rid: r.output for r in rep.completed},
                     {r.rid: (r.status, r.error.code if r.error else None)
                      for r in rep.completed + rep.rejected},
                     [(s.h_read, s.e_read, s.m_in, s.m_out)
                      for s in eng.stats],
                     [{k: v for k, v in e.items()
                       if not (e["kind"] == "slo_shed" and k == "reason")}
                      for e in rep.events])
        engines[dev] = (eng, rep)
    return runs, engines


def parity_requests(seed, vocab):
    """Phase 3's stream: four f32-smoke requests, two of them spilling."""
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, (n,)) for n in (300, 40, 280, 20)]
    return [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]


def parity_runs(seed, overlap=False):
    """Phase 3's stream on the card and on the CPU (`card_vs_cpu`)."""
    from repro_torch.core.tiers import H100
    from repro_torch.serving.engine import EngineConfig
    cfg = smoke_f32("internlm2-1.8b")
    ecfg = EngineConfig(max_context=512, policy="importance", spec=H100,
                        prefill_chunk=32, telemetry_stride=8,
                        overlap_migrations=overlap)
    return card_vs_cpu(cfg, ecfg, lambda: parity_requests(seed, cfg.vocab),
                       seed, num_slots=2)


def serve_again(eng, seed):
    """Phase 3's stream served again on `eng`: `card_vs_cpu`'s tuple."""
    rep = eng.serve(parity_requests(seed, eng.model.cfg.vocab), num_slots=2)
    return ({r.rid: r.output for r in rep.completed},
            {r.rid: (r.status, r.error.code if r.error else None)
             for r in rep.completed + rep.rejected},
            [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats],
            [dict(e) for e in rep.events])


def graph_label(key) -> str:
    """A graph's key as printed: a serve key by its prefill plane,
    `serve/<pages>x<steps>`; a run/generate key by its mode and steps."""
    if key[0] == "serve":
        return f"serve/{key[-2]}x{key[-1]}"
    return f"{key[0]}/{key[-1]}"


def captures_line(eng) -> str:
    """The engine's graph captures and replays, one entry per key (the
    serve keys' last entry is the prefill bucket in pages)."""
    caps = {graph_label(k): n for k, n in eng.captures.items()}
    reps = {graph_label(k): n for k, n in eng._graphs.replays.items()}
    return f"captures {caps} replays {reps}"


def parity_phase(seed, overlap=False):
    """A small f32 stream, on the card and on the CPU, same weights; in
    overlap mode (phase 3c) the card's host pools are pinned and pages
    must be committed. The card serves through captured chunks; served
    again on the same engine it captures nothing."""
    runs, engines = parity_runs(seed, overlap)
    eng = engines["cuda"][0]
    if overlap and not eng.state.k_host.is_pinned():
        raise AssertionError("overlap mode: the host pools are not in "
                             "pinned host memory")
    same = [runs["cuda"][i] == runs["cpu"][i] for i in range(3)]
    migrated = sum(r[2] + r[3] for r in runs["cuda"][2])
    log(f"parity{' overlap' if overlap else ''}: tokens {same[0]} statuses "
        f"{same[1]} step bytes {same[2]} ({len(runs['cuda'][2])} decode "
        f"steps, {migrated:.0f} bytes migrated); {captures_line(eng)}")
    if not all(same):
        raise AssertionError("the card's serve disagrees with the CPU's")
    if overlap and migrated == 0:
        raise AssertionError("overlap parity: no page was committed")
    first = dict(eng.captures)
    again = serve_again(eng, seed)
    if again[:3] != runs["cuda"][:3] or dict(eng.captures) != first \
            or not eng._graphs.replays:
        raise AssertionError(f"parity: served again, the stream changed or "
                             f"captured: {captures_line(eng)}")


#: fused `run` against `step()` on the card: the logits' largest
#: difference allowed (see `fused_vs_eager`)
FUSED_TOL = 0.0


def fused_vs_eager(model, params, seed, *, batch, prompt_len, stride,
                   max_context, policy="importance"):
    """`run` over two strides (one eager chunk that is then captured,
    one replay) against as many `step()` calls from the same `start`,
    on the card. Returns {"logits_err", "int_state", "step_bytes",
    "captures", "replays", "steps"}."""
    import torch
    from repro_torch.core.tiers import H100
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    ecfg = EngineConfig(max_context=max_context, policy=policy, spec=H100,
                        telemetry_stride=stride, promote_thresh=1e-4,
                        attention_sparsity=0.5 if policy == "quest" else 0.0)
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (batch, prompt_len)), dtype=torch.int32)
    eng = ServingEngine(model, params, ecfg)
    K = 2 * stride

    def ints():
        c = eng.state
        return [getattr(c, f).clone() for f in (
            "page_table", "hbm_owner", "host_owner", "length")]

    tok = eng.start(prompt).argmax(-1).to(torch.int32)
    feed, steps = [], []
    for _ in range(K):
        feed.append(tok)
        logits = eng.step(tok)
        steps.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
    want_state = ints()
    want_bytes = [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats]
    eng.stats = []
    eng.start(prompt)
    got = eng.run(torch.stack(feed))
    torch.cuda.synchronize()
    return {"logits_err": float((got - torch.stack(steps)).abs().max()),
            "int_state": all(torch.equal(a, b)
                             for a, b in zip(ints(), want_state)),
            "step_bytes": [(s.h_read, s.e_read, s.m_in, s.m_out)
                           for s in eng.stats] == want_bytes,
            "captures": dict(eng.captures),
            "replays": sum(eng._graphs.replays.values()), "steps": K}


def fused_phase(model, params, seed):
    """Fused against eager at full width: phase 4's geometry (8 lanes,
    4096-token context), 1024-token prompts, 2 x 16 steps."""
    res = fused_vs_eager(model, params, seed, batch=8, prompt_len=1024,
                         stride=16, max_context=4096)
    log(f"fused vs eager: run of {res['steps']} steps through "
        f"{res['captures']} captures and {res['replays']} replays against "
        f"{res['steps']} step() calls: logits max |diff| "
        f"{res['logits_err']:.3e} (tolerance {FUSED_TOL}), integer state "
        f"{res['int_state']}, step bytes {res['step_bytes']}")
    if not (res["int_state"] and res["step_bytes"] and res["replays"]
            and res["logits_err"] <= FUSED_TOL):
        raise AssertionError(f"fused vs eager: {res}")
    return res


KERNEL_GROUPS = (   # (group, lower-case substrings of its kernel names)
    ("collectives (NCCL)", ("nccl",)),
    ("paged attention (csrc/paged_attention.cu)", ("paged_split_kernel",)),
    ("row copies (csrc/page_copy.cu)", ("page_copy_kernel",)),
    ("flash attention (csrc/flash_attention.cu)", ("flash_wgmma_kernel",
                                                    "flash_fma_kernel")),
    ("flash backward (csrc/flash_attention_bwd.cu)", (
        "dkdv_wgmma_kernel", "dq_wgmma_kernel", "dkdv_kernel", "dq_kernel",
        "delta_kernel")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")),
    ("softmax", ("softmax",)),
    ("gather / scatter / copy", ("index", "gather", "scatter", "copy",
                                 "cat")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA): (its result, profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
    return result, prof


def breakdown(prof, wall: float, out_dir: str) -> None:
    """Print the device's busy share over the window and its kernel time
    by group and by kernel; write the profiler's table to out_dir."""
    import torch
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = collections.Counter(e.name for e in events if e.name in (
        "cudaLaunchKernel", "cudaStreamSynchronize"))
    log(f"profile: host calls: {calls['cudaLaunchKernel']} kernel "
        f"launches, {calls['cudaStreamSynchronize']} stream syncs")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for s, e in spans:                      # union of kernel intervals
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    total = sum(e.time_range.elapsed_us() for e in kernels)
    log(f"profile: {len(kernels)} kernels, device busy "
        f"{busy / 1e6:.3f} s of {wall:.3f} s wall "
        f"({busy / 1e6 / wall:.4f}), kernel time {total / 1e6:.3f} s")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    groups = {}
    for name, (t, n) in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + t
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile: {group}: {t / 1e6:.3f} s ({t / total:.4f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, n) in top:
        log(f"profile:   {t / 1e6:.4f} s  {n:6d} x  {name[:110]}")
    os.makedirs(out_dir, exist_ok=True)
    avgs = prof.key_averages()
    device_key = "self_device_time_total" if hasattr(
        avgs[0], "self_device_time_total") else "self_cuda_time_total"
    with open(os.path.join(out_dir, "serve_profile.txt"), "w") as f:
        for key in ("self_cpu_time_total", device_key):
            f.write(f"sorted by {key}\n")
            f.write(avgs.table(sort_by=key, row_limit=40) + "\n")


POLICY_ENGINE = dict(attention_sparsity=0.5, promote_thresh=1e-4,
                     trace_telemetry=True)


def stream_parity_phase(seed):
    """start / generate / run on the card and on the CPU, f32 smoke
    config, same weights, every policy."""
    import torch
    from repro_torch.core.tiers import H100
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.policies import policy_names

    cfg = smoke_f32("internlm2-1.8b")
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (2, 300)), dtype=torch.int32)
    for policy in policy_names():
        ecfg = EngineConfig(max_context=512, policy=policy, spec=H100,
                            telemetry_stride=8, **POLICY_ENGINE)
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = ServingEngine(model, params, ecfg, device=dev)
            logits = eng.start(prompt)
            first = logits.argmax(-1).to(torch.int32)
            toks = eng.generate(first, 12)
            trace = [tuple(a.copy() for a in c) for c in eng._trace_log]
            eng.start(prompt)
            run = eng.run(torch.cat([first[None], toks[:-1]]))
            runs[dev] = (logits.cpu(), toks.cpu(), run.cpu(), trace,
                         [(s.h_read, s.e_read, s.m_in, s.m_out)
                          for s in eng.stats])
        card, cpu = runs["cuda"], runs["cpu"]
        err_start = float((card[0] - cpu[0]).abs().max())
        err_run = float((card[2] - cpu[2]).abs().max())
        same_tokens = torch.equal(card[1], cpu[1])
        same_trace = len(card[3]) == len(cpu[3]) and all(
            np.array_equal(a, b) for c, d in zip(card[3], cpu[3])
            for a, b in zip(c, d))
        same_bytes = card[4] == cpu[4]
        migrated = sum(r[2] + r[3] for r in card[4])
        log(f"stream {policy}: start logits err {err_start:.3e} run "
            f"logits err {err_run:.3e} (tolerance 1e-4), tokens "
            f"{same_tokens} step bytes {same_bytes} trace {same_trace} "
            f"({len(card[4])} steps, {migrated:.0f} bytes migrated)")
        if not (err_start <= 1e-4 and err_run <= 1e-4 and same_tokens
                and same_bytes and same_trace):
            raise AssertionError(f"stream {policy}: the card's single "
                                 f"stream disagrees with the CPU's")


def full_width(seed, name="internlm2-1.8b"):
    """`name` at its published widths, random bf16 weights."""
    import torch
    from repro_torch import configs
    from repro_torch.models.model import Model
    cfg = configs.get(name)
    model = Model(cfg)
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"model: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.kv_heads} vocab {cfg.vocab}, "
        f"{n_params / 1e9:.3f} B params bf16")
    return model, params


def phase4_requests(vocab, seed):
    """Phase 4's stream: 8 requests of 1200-3000 prompt tokens and 64
    new (every lane spills), then 4 of 64-256 and 16 (lanes reused)."""
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, (n,)),
                    max_new_tokens=64)
            for i, n in enumerate(rng.integers(1200, 3001, 8))]
    reqs += [Request(rid=8 + i, prompt=rng.integers(0, vocab, (n,)),
                     max_new_tokens=16)
             for i, n in enumerate(rng.integers(64, 257, 4))]
    return reqs


def chunk_list(chunks) -> str:
    """Each serve chunk as (prefill pages x steps, C captured and
    replayed / R replayed / E eager, host issue ms, span ms, device
    ms)."""
    return ", ".join(
        f"({c['prefill_pages']}x{c['prefill_steps']} "
        f"{'C' if c['captured'] else 'R' if c['replayed'] else 'E'} "
        f"{c['issue_s'] * 1e3:.1f} {c['span_s'] * 1e3:.1f} "
        f"{c['device_s'] * 1e3:.1f})" for c in chunks)


def p50_ms(values) -> float:
    return float(np.percentile(values, 50)) * 1e3 if values \
        else float("nan")


def graph_pool_bytes(eng):
    """(reserved, allocated) bytes of the engine's graph memory pool, the
    one private pool its captured chunks share: a private pool keeps
    every segment it took while its graphs live, so the reserved bytes
    are its high-water mark; the allocated ones are the graphs' live
    outputs."""
    import torch
    pool = eng._graphs._pool
    segs = [s for s in torch.cuda.memory_snapshot()
            if pool is not None
            and tuple(s.get("segment_pool_id", ())) == tuple(pool)]
    return (sum(s["total_size"] for s in segs),
            sum(s["allocated_size"] for s in segs))


def graph_report(eng, what, chunks, numbers, serve_again=None,
                 profile_dir=None):
    """Print a serve's captures, each graph's kernel nodes and replays,
    the seconds its captures took, its graph pool's bytes and its
    per-chunk host time beside its TPOT p50 and the card; with
    `serve_again`, serve the stream once more on the engine (under
    torch.profiler with `profile_dir`), print its numbers and fail if
    that captures anything or its paged launches are not 2 x layers x
    the steps it ran (its stream is `again_stream` of the result).
    Every serve must replay its graphs."""
    from repro_torch.kernels.build import COUNTS
    nodes = {graph_label(k): dict(g[2])
             for k, g in eng._graphs._graphs.items()}
    log(f"{what}: {captures_line(eng)}; kernel nodes per graph {nodes}")
    replayed = [c["issue_s"] for c in chunks
                if c["replayed"] and not c["captured"]]
    captured = [c["issue_s"] for c in chunks if c["captured"]]
    eager = [c["issue_s"] for c in chunks if not c["replayed"]]
    span = [c["span_s"] for c in chunks]
    pool, live = graph_pool_bytes(eng)
    log(f"{what}: per-chunk host time p50 {p50_ms(replayed):.3f} ms to "
        f"enqueue a replay ({len(replayed)} chunks), "
        f"{p50_ms(captured):.1f} ms to capture and enqueue one "
        f"({len(captured)}, {sum(captured):.2f} s in all), "
        f"{p50_ms(eager):.1f} ms to run one eagerly ({len(eager)}); chunk "
        f"span p50 {p50_ms(span):.1f} ms; TPOT p50 "
        f"{numbers['tpot_p50'] * 1e3:.2f} ms; graph pool "
        f"{pool / 1e9:.3f} GB reserved (its peak), {live / 1e9:.3f} GB "
        f"held by the graphs' outputs; card {card_line()}")
    log(f"{what}: chunks (prefill pages x steps, C captured and "
        f"replayed / R replayed / E eager, host issue ms, span ms, device "
        f"ms): "
        + chunk_list(chunks))
    out = {"captures": sum(eng.captures.values()),
           "replays": sum(eng._graphs.replays.values()),
           "chunk_issue_p50_ms": p50_ms(replayed),
           "capture_chunk_p50_ms": p50_ms(captured),
           "capture_s": sum(captured),
           "eager_chunk_p50_ms": p50_ms(eager),
           "chunk_span_p50_ms": p50_ms(span),
           "graph_pool_bytes": pool}
    if not (replayed or captured):
        raise AssertionError(f"{what}: no chunk replayed a graph")
    if serve_again:
        import torch
        before = dict(eng.captures)
        steps0 = eng.steps_run
        paged0 = COUNTS["paged_attention"]
        torch.cuda.synchronize()
        t0 = time.time()
        if profile_dir:
            rep, prof = profiled(serve_again)
        else:
            rep = serve_again()
        torch.cuda.synchronize()
        wall = time.time() - t0
        paged = COUNTS["paged_attention"] - paged0
        steps = eng.steps_run - steps0
        if profile_dir:
            breakdown(prof, wall, profile_dir)
        tokens = sum(len(r.output) for r in rep)
        span = [c["span_s"] for c in eng.chunk_log]
        log(f"{what}: served again, chunks: " + chunk_list(eng.chunk_log))
        log(f"{what}: served again on the same engine: {wall:.2f} s wall, "
            f"{tokens} tokens, {tokens / wall:.1f} tokens/s, TTFT p50 "
            f"{rep.ttft['p50']:.3f} s, TPOT p50 "
            f"{rep.tpot['p50'] * 1e3:.2f} ms, chunk span p50 "
            f"{p50_ms(span):.1f} ms over {len(span)} chunks "
            f"({sum(c['replayed'] for c in eng.chunk_log)} replayed); "
            f"{captures_line(eng)}; card {card_line()}")
        out.update(again_tokens_per_s=tokens / wall,
                   again_ttft_p50=rep.ttft["p50"],
                   again_tpot_p50=rep.tpot["p50"],
                   again_span_p50_ms=p50_ms(span),
                   again_stream=stream_outcome(eng, rep))
        if dict(eng.captures) != before:
            raise AssertionError(f"{what}: the second serve captured "
                                 f"{dict(eng.captures)} after {before}")
        if paged != 2 * eng.geo.num_layers * steps:
            raise AssertionError(f"{what}: served again, {paged} paged "
                                 f"launches for {steps} steps x "
                                 f"{eng.geo.num_layers} layers x 2")
    return out


def serve_phase(model, params, seed, profile_dir=None, overlap=False,
                inline=None, what=None, again=False, n_requests=12):
    """Phase 4, or with `overlap` phase 4b (overlap_migrations and
    measured_payback, host pools pinned), printed beside phase 4's
    numbers `inline`; phase 7 runs it on granite-moe-3b-a800m. Returns
    the launches by kernel and the numbers."""
    import torch
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models import transformer
    from repro_torch.serving.engine import (
        EngineConfig, ServingEngine, serve_graph_bound,
    )

    cfg = model.cfg
    ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                        policy="importance", prefill_chunk=256,
                        telemetry_stride=16, overlap_migrations=overlap,
                        measured_payback=overlap)
    what = what or ("serve overlap" if overlap else "serve")
    reqs = phase4_requests(cfg.vocab, seed)[:n_requests]
    eng = ServingEngine(model, params, ecfg)
    geo = model.cache_geometry(8, ecfg.max_context, ecfg.hbm_fraction)
    log(f"{what}: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, cache {geo.hbm_pages} HBM + "
        f"{geo.host_pages} host pages per lane per layer, "
        f"{2 * geo.num_layers * geo.batch * geo.max_pages * geo.page_tokens * geo.kv_heads * geo.head_dim * 2 / 1e9:.2f} GB of KV")
    # the payback probe (measured_payback) runs inside serve(): its
    # row copies are counted apart from the serve's own
    probe = collections.Counter()
    measure = eng._measure_migration_spec

    def counted_probe(*args, **kwargs):
        before = collections.Counter(COUNTS)
        out = measure(*args, **kwargs)
        probe.update(COUNTS - before)
        return out
    eng._measure_migration_spec = counted_probe
    # each token write's row-copy launches (one expected: K and V, both
    # tiers, one launch)
    writes = []
    real_write = transformer.write_token_layer

    def counted_write(*args, **kwargs):
        before = COUNTS["page_copy"]
        out = real_write(*args, **kwargs)
        writes.append(COUNTS["page_copy"] - before)
        return out
    transformer.write_token_layer = counted_write
    # the serve chunks the host runs in Python (eagerly, or to capture
    # them): each writes a token per layer per step
    traced = []
    real_chunk = eng._serve_chunk

    def counted_chunk(a, stride, *args):
        traced.append(stride)
        return real_chunk(a, stride, *args)
    eng._serve_chunk = counted_chunk
    gc.collect()            # an earlier phase's engine is not this peak's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()                          # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        if profile_dir and not again:
            rep, prof = profiled(lambda: eng.serve(reqs, num_slots=8,
                                                   seed=seed))
        else:
            rep = eng.serve(reqs, num_slots=8, seed=seed)
        torch.cuda.synchronize()
    finally:
        del eng._measure_migration_spec     # no cycle keeps the engine
        transformer.write_token_layer = real_write
    wall = time.time() - t0
    chunks = list(eng.chunk_log)
    steps_run = eng.steps_run
    if profile_dir and not again:
        breakdown(prof, wall, profile_dir)
    counts = dict(COUNTS - probe)
    launches = counts.get("paged_attention", 0)
    steps = len(eng.stats)
    tokens = sum(len(r.output) for r in rep)
    summ = eng.summary()
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: {wall:.2f} s wall, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s, TTFT p50 {rep.ttft['p50']:.3f} s, "
        f"TPOT p50 {rep.tpot['p50'] * 1e3:.2f} ms, mean HBM hit rate "
        f"{summ['mean_hbm_hit_rate']:.4f}, migrated "
        f"{summ['migrated_bytes']:.0f} bytes, {steps} decode-plane steps, "
        f"{launches} paged launches, {counts.get('page_copy', 0)} row-copy "
        f"launches, peak memory {peak / 1e9:.2f} GB")
    copies = counts.get("page_copy", 0)
    log(f"{what}: row-copy launches {copies / max(steps, 1):.2f} a "
        f"decode-plane step, {copies / max(steps_run, 1):.2f} a step run; "
        f"{len(writes)} token writes issued from Python ({cfg.num_layers} "
        f"layers x {sum(traced)} steps run eagerly or captured"
        f"{' x 2, put back' if cfg.family == 'moe' else ''}), launches "
        f"each {sorted(collections.Counter(writes).items())}")
    if any(w != 1 for w in writes) or (
            cfg.family != "moe" and
            len(writes) != cfg.num_layers * sum(traced)):
        raise AssertionError(f"{what}: token writes {len(writes)} with "
                             f"launches {collections.Counter(writes)}, not "
                             f"one launch a layer a step of the "
                             f"{sum(traced)} steps run in Python")
    numbers = {"tokens_per_s": tokens / wall, "ttft_p50": rep.ttft["p50"],
               "tpot_p50": rep.tpot["p50"], "peak_bytes": peak,
               "hit_rate": summ["mean_hbm_hit_rate"],
               "migrated": summ["migrated_bytes"], "steps": steps,
               "row_copies_per_step": copies / max(steps, 1),
               "token_writes": len(writes), "stream": stream_outcome(eng, rep)}
    numbers.update(graph_report(eng, what, chunks, numbers, again and (
        lambda: eng.serve(phase4_requests(cfg.vocab, seed)[:n_requests],
                          num_slots=8, seed=seed)), again and profile_dir))
    numbers["bound"] = serve_graph_bound(eng.geo, ecfg.telemetry_stride)
    if not 0 < numbers["captures"] <= numbers["bound"]:
        raise AssertionError(f"{what}: {numbers['captures']} captures, "
                             f"bound {numbers['bound']}")
    if overlap:
        pinned = sum(t.nbytes for t in (eng.state.k_host, eng.state.v_host))
        if not (eng.state.k_host.is_pinned() and eng.state.v_host.is_pinned()):
            raise AssertionError("serve overlap: host pools not pinned")
        ev = [e for e in rep.events if e["kind"] == "payback_measured"]
        if len(ev) != 1:
            raise AssertionError(f"serve overlap: events {rep.events}")
        bw = ev[0]["measured_link_bw"]
        log(f"serve overlap: measured payback: commit of {ev[0]['rows']} "
            f"swap rows ({ev[0]['bytes'] / 1e6:.1f} MB both ways) "
            f"{ev[0]['delta_s'] * 1e3:.3f} ms over the empty plan -> link "
            f"{'None' if bw is None else f'{bw / 1e9:.2f} GB/s'} (modeled "
            f"H100.link_bw {ev[0]['modeled_link_bw'] / 1e9:.0f} GB/s)")
        log(f"serve overlap: {pinned / 1e9:.3f} GB of host pools in pinned "
            f"host memory; row-copy launches {counts.get('page_copy', 0)} "
            f"in the serve, {probe['page_copy']} more in the payback probe")
        if inline:
            log(f"serve overlap vs inline (one process): tokens/s "
                f"{numbers['tokens_per_s']:.1f} vs "
                f"{inline['tokens_per_s']:.1f}, TTFT p50 "
                f"{numbers['ttft_p50']:.3f} vs {inline['ttft_p50']:.3f} s, "
                f"TPOT p50 {numbers['tpot_p50'] * 1e3:.2f} vs "
                f"{inline['tpot_p50'] * 1e3:.2f} ms, peak memory "
                f"{peak / 1e9:.2f} vs {inline['peak_bytes'] / 1e9:.2f} GB, "
                f"hit rate {numbers['hit_rate']:.4f} vs "
                f"{inline['hit_rate']:.4f}")
        numbers.update(pinned_bytes=pinned, payback=ev[0],
                       probe_launches=dict(probe))
    bad = {rid: s for rid, s in rep.statuses.items() if s != "ok"}
    short = {r.rid: len(r.output) for r in rep
             if len(r.output) != r.max_new_tokens}
    if bad or short or len(rep.statuses) != len(reqs):
        raise AssertionError(f"serve: statuses {bad}, short outputs {short}")
    if launches != 2 * cfg.num_layers * steps_run or steps == 0:
        raise AssertionError(f"serve: {launches} launches for "
                             f"{steps_run} steps x {cfg.num_layers} "
                             f"layers x 2 (the decode plane runs every "
                             f"step)")
    if summ["mean_hbm_hit_rate"] >= 1.0:
        raise AssertionError("serve: the stream never read the host tier")
    return counts, numbers


def serve_cli_phase(seed):
    """Phase 4c: the one-card serve CLI (`repro_torch.launch.serve.main`)
    in this process at internlm2-1.8b's full width: 8 requests of
    1024-1056 prompt tokens (every lane spills past its HBM pages) and
    32-36 new, its three summary lines; then `--smoke --parity` over
    prompts past the smoke config's HBM pool, which must exit 0 with a
    hit fraction under 1. Returns the full-width run's launches by kernel and its
    summary lines."""
    import contextlib
    import io

    import torch
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch import serve

    argv = ["--arch", "internlm2-1.8b", "--requests", "8", "--prompt-len",
            "1024", "--new-tokens", "32", "--batch-slots", "8",
            "--hbm-fraction", "0.25", "--spec", "h100", "--seed", str(seed)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()                          # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(COUNTS)
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"serve cli: {line}")
    log(f"serve cli: {' '.join(argv)}: exit {rc}, {wall:.2f} s wall (the "
        f"weights' init included), launches {counts}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if rc != 0 or len(lines) != 3 or not lines[0].startswith(
            "served 8 requests"):
        raise AssertionError(f"serve cli: exit {rc}, output {lines}")
    if not counts.get("paged_attention") or not counts.get("page_copy"):
        raise AssertionError(f"serve cli: launches {counts}")
    # 272-304-token prompts pass the smoke config's 16-page (256-token)
    # HBM pool, so the streams compared read and migrate host-tier pages
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--smoke", "--parity", "--prompt-len", "272",
                         "--seed", str(seed)])
    for line in out.getvalue().splitlines():
        log(f"serve cli --smoke --parity: {line}")
    log(f"serve cli --smoke --parity: exit {rc}, {time.time() - t0:.2f} s "
        f"wall")
    hit = re.search(r"PARITY OK: .*, hit ([0-9.]+) ", out.getvalue())
    if rc != 0 or hit is None or not float(hit.group(1)) < 1.0:
        raise AssertionError("serve cli: --smoke --parity failed or read "
                             "no host-tier page")
    return counts, lines


def example_phase():
    """Phase 4d: examples/torch_serve_two_tier.py's `main` on the card:
    training (flash forward and backward, the AdamW kernels), the policy
    sweep and a sampled serve (paged attention, row copies). Returns its
    launches by kernel; each of the six kernels must have launched."""
    import importlib.util

    import torch
    from repro_torch.kernels.build import COUNTS

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch_serve_two_tier.py")
    spec = importlib.util.spec_from_file_location("torch_serve_two_tier",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    COUNTS.clear()                          # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    rc = example.main([])
    torch.cuda.synchronize()
    counts = dict(COUNTS)
    log(f"example: examples/torch_serve_two_tier.py exit {rc}, "
        f"{time.time() - t0:.2f} s wall, launches {counts}")
    missing = [k for k in ("paged_attention", "flash_attention",
                           "flash_attention_bwd", "page_copy", "grad_sumsq",
                           "adamw_apply")
               if not counts.get(k)]
    if rc != 0 or missing:
        raise AssertionError(f"example: exit {rc}, never launched {missing}")
    return counts


def sweep_phase(model, params, seed):
    """The single-stream policy sweep (start, generate, score) at full
    width; returns the kernels' launches over its main-path runs."""
    import torch
    from repro_torch.core.sa import SAConfig
    from repro_torch.core.tiers import H100
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving import trace_bridge
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.policies import policy_names

    cfg = model.cfg
    L, B, S, steps = cfg.num_layers, 4, 2304, 64
    prompts = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int32, device="cuda")
    sa_cfg = SAConfig(max_evaluations=12, iters_per_level=4, seed=0)
    total = collections.Counter()

    def counted(fn):
        COUNTS.clear()                      # the main path's run only
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        total.update(COUNTS)
        return out, time.time() - t0, dict(COUNTS)

    def expect(what, counts, flash, paged):
        got = (counts.get("flash_attention", 0),
               counts.get("paged_attention", 0))
        if got != (flash, paged):
            raise AssertionError(f"sweep {what}: (flash, paged) launches "
                                 f"{got}, expected {(flash, paged)}")

    for policy in policy_names():
        ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                            policy=policy, telemetry_stride=16, spec=H100,
                            **POLICY_ENGINE)
        eng = ServingEngine(model, params, ecfg)
        logits, t_start, c_start = counted(lambda: eng.start(prompts))
        first = logits.argmax(-1).to(torch.int32)
        toks, t_dec, c_dec = counted(lambda: eng.generate(first, steps))
        expect(f"{policy} start", c_start, L, 0)
        expect(f"{policy} generate", c_dec, 0, 2 * L * steps)
        if tuple(logits.shape) != (B, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"sweep {policy}: start logits "
                                 f"{tuple(logits.shape)} not finite")
        summ = eng.summary()
        t = time.time()
        score = trace_bridge.score_headroom(trace_bridge.collect(eng), H100,
                                           sa_cfg=sa_cfg)
        t_score = time.time() - t
        log(f"sweep {policy}: start {t_start:.3f} s, decode "
            f"{B * steps / t_dec:.1f} tokens/s ({t_dec:.2f} s for {steps} "
            f"steps), live_hit_fraction {score['live_hit_fraction']:.4f} "
            f"bound_fraction {score['bound_fraction']:.4f} "
            f"headroom_vs_static {score['headroom_vs_static']:.4f}, "
            f"migrated {summ['migrated_bytes']:.0f} bytes, launches flash "
            f"{c_start.get('flash_attention', 0)} paged "
            f"{c_dec.get('paged_attention', 0)}, scoring {t_score:.2f} s")
        if not all(math.isfinite(v) for v in score.values()):
            raise AssertionError(f"sweep {policy}: score {score}")
        if score["live_hit_fraction"] >= 1.0 or \
                summ["mean_hbm_hit_rate"] >= 1.0:
            raise AssertionError(f"sweep {policy}: never read the host tier")
        migrated = summ["migrated_bytes"]
        if (policy == "static" and migrated != 0) or \
                (policy == "importance" and migrated == 0):
            raise AssertionError(f"sweep {policy}: migrated {migrated} "
                                 f"bytes")
        if policy == "importance":
            # teacher-forced replay of the first half of the tokens
            # generate fed itself
            n_run = steps // 2
            fed = torch.cat([first[None], toks[:n_run - 1]])
            _, t_s2, c_s2 = counted(lambda: eng.start(prompts))
            run, t_run, c_run = counted(lambda: eng.run(fed))
            expect("importance start (run)", c_s2, L, 0)
            expect("importance run", c_run, 0, 2 * L * n_run)
            same = torch.equal(run.argmax(-1).to(torch.int32),
                               toks[:n_run])
            log(f"sweep importance run: {t_run:.2f} s for {n_run} steps, "
                f"argmax reproduces the generated tokens: {same}")
            if not same:
                raise AssertionError("sweep: run's argmax differs from "
                                     "generate's tokens")
        del eng, logits
        torch.cuda.empty_cache()
    return total


def faulted_parity_phase(seed, overlap=False):
    """Phase 3d: a fault plane of every kind, SLO admission whose
    outcome cannot depend on the clock (TTFT targets of 0 and infinity
    by tier) and serve-trace capture, f32 smoke config, on the card and
    on the CPU: tokens, statuses, step bytes, events and the serve
    trace equal, and the scores of both traces equal."""
    from repro_torch.core.sa import SAConfig
    from repro_torch.core.tiers import H100
    from repro_torch.serving import trace_bridge
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.faults import (
        FaultPlane, MigrationFault, PoisonFault, PoolFault, TierFault,
    )
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.slo import SLOPolicy, SLOTarget

    cfg = smoke_f32("internlm2-1.8b")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, (n,))
               for n in (272, 288, 40, 280, 24, 30)]
    plane = FaultPlane(
        tier=(TierFault(start=8, stop=40, link_scale=0.25),),
        migration=(MigrationFault(start=16, stop=32, commit_frac=0.05),),
        pool=(PoolFault(step=24, delta=-2),),
        poison=(PoisonFault(rid=3, step=53),))
    slo = SLOPolicy({"interactive": SLOTarget(0.0, 1.0),
                     "batch": SLOTarget(math.inf, math.inf)})
    ecfg = EngineConfig(max_context=512, policy="importance",
                        attention_sparsity=0.5, promote_thresh=1e-4,
                        telemetry_stride=8, prefill_chunk=16,
                        trace_telemetry=True, overlap_migrations=overlap)
    runs, engines = card_vs_cpu(cfg, ecfg, lambda: [
        Request(rid=i, prompt=p, max_new_tokens=8,
                tier="interactive" if i >= 4 else "batch")
        for i, p in enumerate(prompts)], seed, num_slots=2, faults=plane,
        slo=slo)
    recs = {dev: trace_bridge.collect_serve(eng)
            for dev, (eng, _) in engines.items()}
    same_trace = all(np.array_equal(getattr(recs["cuda"], f),
                                    getattr(recs["cpu"], f))
                     for f in ("access", "tier", "emitted", "first", "rids",
                               "prompt_len"))
    sa = SAConfig(max_evaluations=8, iters_per_level=3, seed=0)
    scores = {dev: trace_bridge.score_serve(recs[dev], H100, sa_cfg=sa)
              ["aggregate"] for dev in recs}
    same = [runs["cuda"][i] == runs["cpu"][i] for i in range(4)]
    statuses = runs["cuda"][1]
    log(f"faults{' overlap' if overlap else ''}: tokens {same[0]} statuses "
        f"{same[1]} step bytes {same[2]} events {same[3]} trace "
        f"{same_trace} scores {scores['cuda'] == scores['cpu']} "
        f"({len(runs['cuda'][2])} decode steps, events "
        f"{[e['kind'] for e in runs['cuda'][3]]}, statuses {statuses})")
    if not (all(same) and same_trace and scores["cuda"] == scores["cpu"]):
        raise AssertionError("the card's faulted serve disagrees with the "
                             "CPU's")
    if statuses[3] != ("failed", "poisoned_logits") or \
            statuses[4] != ("rejected", "slo_shed"):
        raise AssertionError(f"faults: statuses {statuses}")


def moe_parity_phase(seed):
    """Phase 3e: the moe smoke configs (capacity factor 0.5, so choices
    drop) in f32, 10 requests through 8 slots, on the card through
    captured chunks and on the CPU: tokens, statuses and step bytes
    equal, the captures within `serve_graph_bound`; served again on the
    card's engine, the stream is the same and nothing is captured."""
    from repro_torch.serving.engine import EngineConfig, serve_graph_bound
    from repro_torch.serving.scheduler import Request
    for name in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b"):
        cfg = smoke_f32(name, capacity_factor=0.5)
        rng = np.random.default_rng(21)
        prompts = [rng.integers(0, cfg.vocab, (n,)) for n in
                   (300, 40, 280, 20, 150, 64, 260, 33, 90, 17)]
        ecfg = EngineConfig(max_context=512, policy="importance",
                            prefill_chunk=16, telemetry_stride=8,
                            promote_thresh=1e-4)

        def reqs():
            return [Request(rid=i, prompt=p, max_new_tokens=10)
                    for i, p in enumerate(prompts)]
        runs, engines = card_vs_cpu(cfg, ecfg, reqs, seed, num_slots=8)
        same = [runs["cuda"][i] == runs["cpu"][i] for i in range(3)]
        migrated = sum(r[2] + r[3] for r in runs["cuda"][2])
        eng = engines["cuda"][0]
        first = dict(eng.captures)
        bound = serve_graph_bound(eng.geo, ecfg.telemetry_stride)
        planes = sorted({(c["prefill_pages"], c["prefill_steps"])
                         for c in eng.chunk_log})
        log(f"moe parity {cfg.name}: tokens {same[0]} statuses {same[1]} "
            f"step bytes {same[2]} ({len(runs['cuda'][2])} decode steps, "
            f"{migrated:.0f} bytes migrated); prefill planes (pages, steps) "
            f"{planes} of {eng.geo.max_pages} pages; {captures_line(eng)}, "
            f"bound {bound}")
        if not all(same) or set(s for s, _ in runs["cuda"][1].values()) \
                != {"ok"}:
            raise AssertionError(f"moe parity {cfg.name}: the card's serve "
                                 f"disagrees with the CPU's")
        if not 0 < sum(first.values()) <= bound or not eng._graphs.replays:
            raise AssertionError(f"moe parity {cfg.name}: "
                                 f"{captures_line(eng)}, bound {bound}")
        rep = eng.serve(reqs(), num_slots=8)
        again = ({r.rid: r.output for r in rep.completed},
                 {r.rid: (r.status, r.error.code if r.error else None)
                  for r in rep.completed + rep.rejected},
                 [(s.h_read, s.e_read, s.m_in, s.m_out) for s in eng.stats])
        if again != runs["cuda"][:3] or dict(eng.captures) != first:
            raise AssertionError(f"moe parity {cfg.name}: served again, the "
                                 f"stream changed or captured: "
                                 f"{captures_line(eng)}")


#: phase 6's SLO tiers, by prompt length: (max prompt, tier, TTFT, TPOT)
PHASE6_TIERS = ((256, "interactive", 2.0, 0.2), (None, "batch", 30.0, 0.5))


def faulted_serve_phase(model, params, seed):
    """Phase 6: phase 4's engine with `cost_aware` and trace capture, its
    12 requests plus 4 open-loop arrivals at 0.5-2 s, SLO tiers by prompt
    length, and a fault plane of one fault of each kind (the poison on a
    long request before its budget ends); then the stream is scored
    (`collect_serve`, `goodput_curve`, which runs `score_serve`).
    Returns the launches by kernel and the numbers."""
    import torch
    from repro_torch.core.sa import SAConfig
    from repro_torch.core.tiers import H100
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving import slo as slo_mod
    from repro_torch.serving import trace_bridge
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.faults import (
        FaultPlane, MigrationFault, PoisonFault, PoolFault, TierFault,
    )
    from repro_torch.serving.scheduler import TERMINAL_STATUSES, Request

    cfg = model.cfg
    ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                        policy="cost_aware", prefill_chunk=256,
                        telemetry_stride=16, trace_telemetry=True)
    geo = model.cache_geometry(8, ecfg.max_context, ecfg.hbm_fraction)
    rng = np.random.default_rng(seed + 6)
    reqs = phase4_requests(cfg.vocab, seed)
    for i, (n, budget) in enumerate(((int(rng.integers(1200, 3001)), 64),
                                     (int(rng.integers(64, 257)), 16),
                                     (int(rng.integers(1200, 3001)), 64),
                                     (int(rng.integers(64, 257)), 16))):
        reqs.append(Request(rid=12 + i,
                            prompt=rng.integers(0, cfg.vocab, (n,)),
                            max_new_tokens=budget,
                            arrival_s=float(rng.uniform(0.5, 2.0))))
    targets = {}
    for r in reqs:
        for top, tier, ttft, tpot in PHASE6_TIERS:
            if top is None or r.prompt_len <= top:
                r.tier = tier
                targets[tier] = slo_mod.SLOTarget(ttft, tpot)
                break
    slo = slo_mod.SLOPolicy(targets)
    plane = FaultPlane(
        tier=(TierFault(start=16, stop=64, link_scale=0.5,
                        dram_scale=0.5),),
        migration=(MigrationFault(start=32, stop=48, commit_frac=0.25),),
        pool=(PoolFault(step=48, delta=-geo.max_pages),),
        poison=(PoisonFault(rid=0, step=40),))
    eng = ServingEngine(model, params, ecfg)
    log(f"serve faulted: {len(reqs)} requests (4 arriving at "
        f"{[round(r.arrival_s, 3) for r in reqs[12:]]} s), tiers "
        f"{collections.Counter(r.tier for r in reqs)}, SLO "
        f"{ {t: (v.ttft_s, v.tpot_s) for t, v in targets.items()} }, "
        f"faults {plane}")
    gc.collect()
    torch.cuda.empty_cache()
    COUNTS.clear()                          # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    rep = eng.serve(reqs, num_slots=8, seed=seed, faults=plane, slo=slo)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(COUNTS)
    steps = len(eng.stats)
    tokens = sum(len(r.output) for r in rep.completed)
    t = time.time()
    rec = trace_bridge.collect_serve(eng)
    curve = trace_bridge.goodput_curve(
        rec, H100, rep, slo, sa_cfg=SAConfig(max_evaluations=12,
                                             iters_per_level=4, seed=0))
    t_score = time.time() - t
    wall_goodput = slo_mod.score_goodput(rep, slo, latency="wall")
    agg = curve["aggregate"]
    modeled = {row["scale"]: row["goodput"] for row in curve["curve"]}
    residual = slo_mod.ttft_decomposition_residual(rep)
    statuses = collections.Counter(rep.statuses.values())
    kinds = collections.Counter(e["kind"] for e in rep.events)
    log(f"serve faulted: {wall:.2f} s wall, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s, TTFT p50 "
        f"{rep.ttft.get('p50', math.nan):.3f} s, TPOT p50 "
        f"{rep.tpot.get('p50', math.nan) * 1e3:.2f} ms, {steps} decode-plane "
        f"steps, {counts.get('paged_attention', 0)} paged and "
        f"{counts.get('page_copy', 0)} row-copy launches; statuses "
        f"{dict(statuses)}; events {dict(kinds)}; TTFT identity residual "
        f"max {residual.max():.3e} s")
    log(f"serve faulted: scoring {t_score:.2f} s ({len(rec.access)} steps, "
        f"{int(agg['requests'])} requests): live_hit_fraction "
        f"{agg['live_hit_fraction']:.4f} bound_fraction "
        f"{agg['bound_fraction']:.4f} headroom_vs_static "
        f"{agg['headroom_vs_static']:.4f} fault_events "
        f"{agg.get('fault_events', 0):.0f}; goodput wall "
        f"{wall_goodput['goodput']:.4f} ({wall_goodput['per_tier']}), "
        f"modeled by scale {modeled}")
    if len(rep.statuses) != len(reqs) or \
            not set(rep.statuses.values()) <= set(TERMINAL_STATUSES):
        raise AssertionError(f"serve faulted: statuses {rep.statuses}")
    poisoned = next(r for r in rep.completed if r.rid == 0)
    if poisoned.status != "failed" or \
            poisoned.error.code != "poisoned_logits" or \
            not 0 < len(poisoned.output) < poisoned.max_new_tokens:
        raise AssertionError(f"serve faulted: request 0 {poisoned.status} "
                             f"{poisoned.error} {len(poisoned.output)}")
    if residual.size == 0 or residual.max() > 2e-6:
        raise AssertionError(f"serve faulted: TTFT identity {residual}")
    want = {"tier_degradation", "payback_recalibration", "migration_fault",
            "pool_resize", "logit_poison"}
    if not want <= set(kinds):
        raise AssertionError(f"serve faulted: events {dict(kinds)}")
    if counts.get("paged_attention", 0) != 2 * cfg.num_layers * \
            eng.steps_run:
        raise AssertionError(f"serve faulted: {counts} for "
                             f"{eng.steps_run} steps")
    if not all(math.isfinite(v) for v in agg.values()) or \
            rec.access.shape[0] == 0:
        raise AssertionError(f"serve faulted: scores {agg}")
    numbers = {"tokens_per_s": tokens / wall, "wall_s": wall,
               "ttft_p50": rep.ttft.get("p50"),
               "tpot_p50": rep.tpot.get("p50"), "score_s": t_score,
               "statuses": dict(statuses), "events": dict(kinds),
               "aggregate": agg, "goodput_wall": wall_goodput["goodput"],
               "goodput_modeled": modeled}
    return counts, numbers


#: the moe serves' numbers when their chunks ran eagerly, not captured
#: (this script's phases 7 and 15a on an NVIDIA H100 80GB HBM3 at
#: 700.00 W, the same stream and weights): tokens/s, TTFT p50 s, TPOT
#: p50 s
EAGER_MOE_SERVE = {"serve moe": (29.5, 2.955, 0.20416),
                   "mesh moe serve": (24.0, 2.929, 0.25346)}


def beside_eager(what, numbers) -> str:
    """A captured moe serve's first and served-again tokens/s, TTFT and
    TPOT p50 beside its eager run's (`EAGER_MOE_SERVE`)."""
    rate, ttft, tpot = EAGER_MOE_SERVE[what]
    return (f"{what} captured vs eager: tokens/s first "
            f"{numbers['tokens_per_s']:.1f}, again "
            f"{numbers['again_tokens_per_s']:.1f} vs {rate}; TTFT p50 first "
            f"{numbers['ttft_p50']:.3f}, again {numbers['again_ttft_p50']:.3f}"
            f" vs {ttft} s; TPOT p50 first {numbers['tpot_p50'] * 1e3:.2f}, "
            f"again {numbers['again_tpot_p50'] * 1e3:.2f} vs "
            f"{tpot * 1e3:.2f} ms; captures {numbers['captures']} (bound "
            f"{numbers['bound']}) in {numbers['capture_s']:.2f} s; graph "
            f"pool {numbers['graph_pool_bytes'] / 1e9:.3f} GB")


def moe_phase(model, params, seed):
    """Phase 7: granite-moe-3b-a800m at its published widths (`model`,
    `params`: random bf16 weights): phase 4's serve of its 8 long
    requests through captured chunks, served again on the same engine
    (nothing captured, the same tokens, statuses and step bytes), then
    `start` of 4 prompts of 2304 tokens and `generate(32)`. Returns the
    launches by path and the numbers."""
    import torch
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg = model.cfg
    serve, numbers = serve_phase(model, params, seed, what="serve moe",
                                 n_requests=8, again=True)
    log(beside_eager("serve moe", numbers) + f"; card {card_line()}")
    if numbers.pop("again_stream") != numbers["stream"]:
        raise AssertionError("serve moe: served again, the tokens, "
                             "statuses or step bytes changed")
    L, B, S, steps = cfg.num_layers, 4, 2304, 32
    prompts = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int32, device="cuda")
    eng = ServingEngine(model, params, EngineConfig(
        max_context=4096, hbm_fraction=0.25, policy="importance",
        telemetry_stride=16))

    def counted(fn):
        COUNTS.clear()                      # the main path's run only
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0, dict(COUNTS)

    logits, t_start, c_start = counted(lambda: eng.start(prompts))
    first = logits.argmax(-1).to(torch.int32)
    toks, t_dec, c_dec = counted(lambda: eng.generate(first, steps))
    summ = eng.summary()
    log(f"moe single stream: start {t_start:.3f} s (B={B}, S={S}), decode "
        f"{B * steps / t_dec:.1f} tokens/s ({t_dec:.2f} s for {steps} "
        f"steps), mean HBM hit rate {summ['mean_hbm_hit_rate']:.4f}, "
        f"migrated {summ['migrated_bytes']:.0f} bytes, launches flash "
        f"{c_start.get('flash_attention', 0)} paged "
        f"{c_dec.get('paged_attention', 0)}")
    got = (c_start.get("flash_attention", 0), c_dec.get("paged_attention", 0))
    if got != (L, 2 * L * steps):
        raise AssertionError(f"moe single stream: (flash, paged) launches "
                             f"{got}, expected {(L, 2 * L * steps)}")
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            tuple(toks.shape) != (steps, B):
        raise AssertionError(f"moe single stream: logits "
                             f"{tuple(logits.shape)}, tokens "
                             f"{tuple(toks.shape)}")
    numbers.update(start_s=t_start, decode_tokens_per_s=B * steps / t_dec)
    del eng, logits
    free_card()
    return {"serve": serve, "start": c_start, "generate": c_dec}, numbers


#: the architectures of phase 3f's single streams: the dense configs
#: besides internlm2, the vlm, the encdec and the hybrid family
FAMILY_ARCHS = ("llama31-8b", "granite-8b", "qwen3-32b", "stablelm-12b",
                "internvl2-2b", "whisper-tiny", "zamba2-1.2b")


def family_extra(cfg, rng, batch):
    """`start`'s `extra` for cfg's family, from `rng`: the vlm family's
    patch or the encdec family's frame embeddings (the stubbed
    frontends' outputs, numpy f32, which `start` moves to its device),
    None for a dense model."""
    key = {"vlm": "patch_embeds", "encdec": "frame_embeds"}.get(cfg.family)
    if key is None:
        return None
    return {key: rng.standard_normal((batch, cfg.frontend.num_embeddings,
                                      cfg.d_model)).astype(np.float32)}


def stream_card_vs_cpu(name, seed):
    """The single stream of `name`'s smoke config in f32 on the card and
    on the CPU, same weights (from `seed`): `start` of 2 prompts of 300
    tokens (and the family's `extra`), then `generate(16)`. Returns
    (start logits' max abs difference, tokens equal, step bytes equal,
    the card's step bytes (h_read, e_read, m_in, m_out))."""
    import torch
    from repro_torch.core.tiers import H100
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = smoke_f32(name)
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    rng = np.random.default_rng(seed + 3)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 300)),
                              dtype=torch.int32)
    extra = family_extra(cfg, rng, 2)
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(model, params, EngineConfig(
            max_context=512, policy="importance", spec=H100,
            telemetry_stride=8, promote_thresh=1e-4), device=dev)
        logits = eng.start(prompts, extra=extra)
        toks = eng.generate(logits.argmax(-1).to(torch.int32), 16)
        runs[dev] = (logits.cpu(), toks.cpu(),
                     [(s.h_read, s.e_read, s.m_in, s.m_out)
                      for s in eng.stats])
    card, cpu = runs["cuda"], runs["cpu"]
    return (float((card[0] - cpu[0]).abs().max()),
            torch.equal(card[1], cpu[1]), card[2] == cpu[2], card[2])


def family_parity_phase(seed):
    """Phase 3f: `stream_card_vs_cpu` for each of FAMILY_ARCHS: tokens
    and step bytes equal, start logits within 1e-4, the host tier read;
    then `xlstm_card_vs_cpu`."""
    for name in FAMILY_ARCHS:
        cfg = smoke_f32(name)
        err, same_tokens, same_bytes, stats = stream_card_vs_cpu(name, seed)
        migrated = sum(r[2] + r[3] for r in stats)
        host_read = any(r[1] > 0 for r in stats)
        log(f"family parity {name} ({cfg.family}, head_dim {cfg.head_dim}, "
            f"G={cfg.q_per_kv}, {len(cfg.attention_layer_ids())} KV of "
            f"{cfg.num_layers} layers): start logits err {err:.3e} "
            f"(tolerance 1e-4), tokens {same_tokens} step bytes "
            f"{same_bytes} host tier read {host_read} ({migrated:.0f} "
            f"bytes migrated)")
        if not (err <= 1e-4 and same_tokens and same_bytes and host_read):
            raise AssertionError(f"family parity {name}: the card's single "
                                 f"stream disagrees with the CPU's")
    errs, same_tokens = xlstm_card_vs_cpu(seed)
    log(f"family parity xlstm-125m (xlstm, no KV layers): prefill + 16 "
        f"decode steps, logits err {errs['logits']:.3e} state err "
        f"{errs['state']:.3e} (tolerance 1e-4), tokens {same_tokens}")
    if not (errs["logits"] <= 1e-4 and errs["state"] <= 1e-4
            and same_tokens):
        raise AssertionError("family parity xlstm-125m: the card's prefill "
                             "and decode disagree with the CPU's")


def xlstm_steps(model, params, prompts, steps):
    """`Model.prefill` of `prompts` (one replayed decode step per token,
    as the reference runs it), then `steps` greedy `decode_step`s: the
    xlstm family's whole serving path (the engine has no cache of it to
    place). Returns (logits of each step [steps + 1, B, V], greedy
    tokens [steps, B], the final state, prefill seconds, decode
    seconds); times are wall clock around synchronised work on the
    card."""
    import torch

    def sync():
        if prompts.device.type == "cuda":
            torch.cuda.synchronize()
    sync()
    t0 = time.time()
    logits, state = model.prefill(params, prompts, None)
    sync()
    t1 = time.time()
    out, toks = [logits], []
    for _ in range(steps):
        tok = out[-1].argmax(-1).to(torch.int32)
        toks.append(tok)
        logits, state = model.decode_step(params, state, tok)
        out.append(logits)
    sync()
    return (torch.stack(out), torch.stack(toks), state, t1 - t0,
            time.time() - t1)


def xlstm_card_vs_cpu(seed, steps=16):
    """xlstm-125m's smoke config in f32 through `xlstm_steps` on the card
    and on the CPU, same weights (from `seed`), 2 prompts of 24 tokens.
    Returns ({"logits", "state"}: max abs differences, tokens equal)."""
    import torch
    from repro_torch.models.model import Model
    cfg = smoke_f32("xlstm-125m")
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    rng = np.random.default_rng(seed + 4)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)),
                              dtype=torch.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        p = {k: {n: t.to(dev) for n, t in v.items()}
             if isinstance(v, dict) else v.to(dev) for k, v in params.items()}
        logits, toks, state, _, _ = xlstm_steps(model, p, prompts.to(dev),
                                                steps)
        runs[dev] = (logits.cpu(), toks.cpu(),
                     {k: t.cpu() for k, t in state.items()})
    card, cpu = runs["cuda"], runs["cpu"]
    return ({"logits": float((card[0] - cpu[0]).abs().max()),
             "state": max(float((card[2][k] - cpu[2][k]).abs().max())
                          for k in cpu[2])},
            torch.equal(card[1], cpu[1]))


def free_card() -> None:
    """Drop what an earlier phase left on the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def big_serve_phase(name, seed, overlap=False):
    """Phases 8 and 9: phase 4's serve (or 4b's, with `overlap`) of its
    8 long requests (the 4 short ones, which reuse lanes, are phase 4's
    alone) at the published widths of `name`, random bf16 weights.
    Prints the weights' and the KV's share of the card. Returns the
    launches by kernel and the numbers."""
    import torch
    free_card()
    model, params = full_width(seed, name)
    weights = sum(p.numel() * p.element_size() for p in _leaves(params))
    geo = model.cache_geometry(8, 4096, 0.25)
    per_page = 2 * geo.page_tokens * geo.kv_heads * geo.head_dim * 2
    kv_card = geo.num_layers * 8 * geo.hbm_pages * per_page
    kv_host = geo.num_layers * 8 * geo.host_pages * per_page
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{name}: weights {weights / 1e9:.2f} GB of the card's "
        f"{total / 1e9:.2f} GB; KV {kv_card / 1e9:.2f} GB on the card + "
        f"{kv_host / 1e9:.2f} GB in the host tier")
    what = f"serve {name}{' overlap' if overlap else ''}"
    counts, numbers = serve_phase(model, params, seed, overlap=overlap,
                                  what=what, n_requests=8)
    numbers.update(weight_bytes=weights, kv_card_bytes=kv_card,
                   kv_host_bytes=kv_host, card_bytes=total)
    if numbers["peak_bytes"] < weights + kv_card:
        raise AssertionError(f"{what}: peak memory under weights + KV")
    del model, params
    free_card()
    return counts, numbers


#: phase 10: (architecture, prompt tokens) of each single stream at B=4
SINGLE_STREAMS = (("stablelm-12b", 2304), ("granite-8b", 2304),
                  ("internvl2-2b", 2048), ("whisper-tiny", 64),
                  ("zamba2-1.2b", 2304))


def single_stream_phase(seed):
    """Phase 10: `start` + `generate(32)` of 4 prompts at the published
    widths of each of SINGLE_STREAMS (vlm: plus 256 patch embeddings,
    encdec: over 1500 frame embeddings, from `seed`), then
    `score_headroom` on the internvl2, whisper and zamba2 streams.
    Launches are counted per KV layer (zamba2: its 2 attention sites).
    Returns the launches by stream and path, and the numbers."""
    import torch
    from repro_torch.core.sa import SAConfig
    from repro_torch.core.tiers import H100
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving import trace_bridge
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    B, steps = 4, 32
    launches, numbers = {}, {}

    def counted(fn):
        COUNTS.clear()                      # the main path's run only
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0, dict(COUNTS)

    for name, S in SINGLE_STREAMS:
        free_card()
        model, params = full_width(seed, name)
        cfg = model.cfg
        rng = np.random.default_rng(seed + 1)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                  dtype=torch.int32, device="cuda")
        extra = family_extra(cfg, rng, B)
        scored = cfg.family in ("vlm", "encdec", "hybrid")
        eng = ServingEngine(model, params, EngineConfig(
            max_context=4096, hbm_fraction=0.25, policy="importance",
            telemetry_stride=16, spec=H100, trace_telemetry=scored))
        torch.cuda.reset_peak_memory_stats()
        logits, t_start, c_start = counted(
            lambda: eng.start(prompts, extra=extra))
        first = logits.argmax(-1).to(torch.int32)
        toks, t_dec, c_dec = counted(lambda: eng.generate(first, steps))
        peak = torch.cuda.max_memory_allocated()
        summ = eng.summary()
        L = len(cfg.attention_layer_ids())          # the KV layers
        # whole-prompt prefill: one flash launch per attention (encdec:
        # encoder self, decoder self and cross; hybrid: each site);
        # decode: two paged launches per KV layer, and encdec's
        # cross-attention, one flash launch per layer
        if cfg.family == "encdec":
            want = {"start": (cfg.encdec.enc_layers + 2 * L, 0),
                    "generate": (L * steps, 2 * L * steps)}
        else:
            want = {"start": (L, 0), "generate": (0, 2 * L * steps)}
        got = {path: (c.get("flash_attention", 0),
                      c.get("paged_attention", 0))
               for path, c in (("start", c_start), ("generate", c_dec))}
        state = eng.state["kv"] if isinstance(eng.state, dict) else eng.state
        kv_bytes = sum(t.numel() * t.element_size() for t in (
            state.k_hbm, state.v_hbm, state.k_host, state.v_host))
        ssm = eng.state.get("ssm") if isinstance(eng.state, dict) else None
        ssm_bytes = sum(t.numel() * t.element_size()
                        for t in ssm.values()) if ssm else 0
        line = (f"single stream {name} ({cfg.family}, head_dim "
                f"{cfg.head_dim}, G={cfg.q_per_kv}): start {t_start:.3f} s "
                f"(B={B}, {S} tokens"
                f"{f' + {cfg.frontend.num_embeddings} patches' if cfg.family == 'vlm' else ''}"
                f"{f' over {cfg.frontend.num_embeddings} frames' if cfg.family == 'encdec' else ''}), "
                f"decode {B * steps / t_dec:.1f} tokens/s ({t_dec:.2f} s for "
                f"{steps} steps), mean HBM hit rate "
                f"{summ['mean_hbm_hit_rate']:.4f}, launches start flash "
                f"{got['start'][0]} paged {got['start'][1]}, generate flash "
                f"{got['generate'][0]} paged {got['generate'][1]} "
                f"({L} KV of {cfg.num_layers} layers), KV pools "
                f"{kv_bytes / 1e9:.3f} GB"
                f"{f', Mamba2 state {ssm_bytes / 1e9:.3f} GB' if ssm else ''}"
                f", peak memory {peak / 1e9:.2f} GB, cache length "
                f"{state.length.tolist()}")
        log(line)
        if got != want:
            raise AssertionError(f"single stream {name}: (flash, paged) "
                                 f"launches {got}, expected {want}")
        if tuple(logits.shape) != (B, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()) or \
                tuple(toks.shape) != (steps, B):
            raise AssertionError(f"single stream {name}: logits "
                                 f"{tuple(logits.shape)}, tokens "
                                 f"{tuple(toks.shape)}")
        n = numbers[name] = {"start_s": t_start,
                             "decode_tokens_per_s": B * steps / t_dec,
                             "hit_rate": summ["mean_hbm_hit_rate"],
                             "peak_bytes": peak, "kv_bytes": kv_bytes,
                             "ssm_bytes": ssm_bytes}
        if scored:
            t = time.time()
            score = trace_bridge.score_headroom(
                trace_bridge.collect(eng), H100,
                sa_cfg=SAConfig(max_evaluations=12, iters_per_level=4,
                                seed=0))
            n.update(score=score, score_s=time.time() - t)
            log(f"single stream {name}: score_headroom live_hit_fraction "
                f"{score['live_hit_fraction']:.4f} bound_fraction "
                f"{score['bound_fraction']:.4f} headroom_vs_static "
                f"{score['headroom_vs_static']:.4f}, scoring "
                f"{n['score_s']:.2f} s")
            if not all(math.isfinite(v) for v in score.values()):
                raise AssertionError(f"single stream {name}: score {score}")
        launches[name] = {"start": c_start, "generate": c_dec}
        del eng, logits, params, model, state, ssm
        free_card()
    return launches, numbers


#: phase 11's prompt length: the replayed prefill is one host-bound
#: decode step per token, so this sets the phase's wall time
XLSTM_PROMPT = 448


def xlstm_phase(seed):
    """Phase 11: xlstm-125m at its published widths (random bf16
    weights from `seed`) through `xlstm_steps`: prefill of 4 prompts of
    XLSTM_PROMPT tokens, 32 greedy decode steps. No kernel may launch.
    Then `ServingEngine.generate` on it must raise ValueError. Returns
    the numbers."""
    import torch
    from repro_torch.core.tiers import H100
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    free_card()
    model, params = full_width(seed, "xlstm-125m")
    cfg = model.cfg
    B, steps = 4, 32
    rng = np.random.default_rng(seed + 2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, XLSTM_PROMPT)),
                              dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()                          # the main path's run only
    logits, toks, state, t_pre, t_dec = xlstm_steps(model, params, prompts,
                                                    steps)
    launched = dict(COUNTS)
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    log(f"xlstm {cfg.name} ({cfg.num_layers} blocks, "
        f"{len(model._slstm_ids())} sLSTM, d_model {cfg.d_model}, mLSTM "
        f"head {cfg.xlstm.expand * cfg.d_model // cfg.num_heads}): prefill "
        f"{t_pre:.3f} s (B={B}, {XLSTM_PROMPT} tokens, "
        f"{B * XLSTM_PROMPT / t_pre:.1f} tokens/s replayed), decode "
        f"{B * steps / t_dec:.1f} tokens/s ({t_dec:.3f} s for {steps} "
        f"steps), recurrent state {state_bytes / 1e6:.2f} MB "
        f"({', '.join(f'{k} {list(t.shape)}' for k, t in state.items())}), "
        f"peak memory {peak / 1e9:.3f} GB, kernel launches {launched}")
    if any(launched.values()):
        raise AssertionError(f"xlstm launched kernels: {launched}")
    if tuple(logits.shape) != (steps + 1, B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()) or \
            tuple(toks.shape) != (steps, B) or \
            not all(bool(torch.isfinite(t).all()) for t in state.values()):
        raise AssertionError(f"xlstm: logits {tuple(logits.shape)}, tokens "
                             f"{tuple(toks.shape)}, or a non-finite value")
    eng = ServingEngine(model, params, EngineConfig(max_context=4096,
                                                    spec=H100))
    eng.start(prompts[:, :8])
    try:
        eng.generate(toks[-1], 2)
    except ValueError as e:
        log(f"xlstm: ServingEngine.generate refuses the family: {e}")
    else:
        raise AssertionError("xlstm: ServingEngine.generate did not raise")
    numbers = {"prompt": XLSTM_PROMPT, "prefill_s": t_pre,
               "decode_tokens_per_s": B * steps / t_dec,
               "state_bytes": state_bytes, "peak_bytes": peak}
    del eng, model, params, state, logits
    free_card()
    return numbers

# --------------------------------------------------------------------------
# phases 12a, 12, 12b: training, checkpoints, serving the trained weights
# --------------------------------------------------------------------------

#: phase 12a: one smoke config of each family whose attention trains
#: through the flash backward differently: dense, moe, encdec (the
#: cross-attention's Sq != Sk) and hybrid (the weight-shared sites)
TRAIN_PARITY_ARCHS = ("internlm2-1.8b", "granite-moe-3b-a800m",
                      "whisper-tiny", "zamba2-1.2b")
#: card against CPU after three f32 steps: the loss and the grad norm to
#: 1e-4 relative (f32 sums in other orders, the flash kernel against
#: the plain attention); the parameters to 2e-4, a fifth of one step at
#: lr = 1e-3 (AdamW's m / sqrt(v) turns f32 noise in near-zero
#: gradients into differences of part of a step)
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "params": 2e-4}
#: phase 12: internlm2-1.8b at full width and depth, B x S tokens a
#: step, at a fixed lr. AdamW's first steps move every weight by ~lr
#: and spike the loss at every rate and warm-up tried; whether step 6
#: ends below step 1 depends on the seed for most of them
#: (`scripts/train_lr_sweep.py`), so that check is a sanity check of
#: the loop, and phase 12c holds the full-width gradient itself
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 512, 6, 1e-4
#: phase 12c: the bf16 step against the f32 step, relative. bf16 keeps
#: 8 bits (a rounding error up to 2^-9 = 2e-3 of each stored value):
#: the loss averages 4096 tokens' errors (5e-3); the grad norm and each
#: parameter's gradient (relative L2) carry some tens of roundings in
#: series through two layers and the backward, ~1e-2 (2e-2, 0.1); a
#: gradient that is wrong for one head in 16 is off by ~0.25
WITNESS_TOL = {"loss": 5e-3, "grad_norm": 2e-2, "grads": 0.1}
#: ms a step and peak GB of each donated training phase's configuration
#: with the pure step and the plain PyTorch update that the AdamW kernels
#: replaced: `scripts/train_ab.py` on the tree before them (the mean of
#: two runs' medians, P C C P; NVIDIA H100 80GB HBM3, 700.00 W), printed
#: beside this run's (phase 12's steady mean, 12b's median, 14a's and
#: 16a's median, 19b's second unmeshed step; the peak from the state on)
UNFUSED_TRAIN = {
    "train": (337.9, 53.84), "train resume": (79.0, 15.86),
    "mesh train": (376.9, 53.84),
    "family train internvl2-2b": (423.3, 53.85),
    "family train whisper-tiny": (63.2, 4.98),
    "family train zamba2-1.2b": (581.0, 38.64),
    "family train xlstm-125m": (8547.6, 6.13),
    "mesh family train internvl2-2b": (595.2, 53.85),
    "mesh family train whisper-tiny": (136.2, 4.98),
    "mesh family train zamba2-1.2b": (1021.3, 38.64),
    "mesh family train xlstm-125m": (11782.4, 6.13),
    "kv train step": (348.6, 21.78)}


def beside_unfused(what, seconds, peak) -> str:
    """`what`'s ms a step and peak memory beside UNFUSED_TRAIN's."""
    old = UNFUSED_TRAIN.get(what)
    if old is None:
        return "(the unfused update's: not measured)"
    ms, gb = old
    return (f"(the unfused update: {ms} ms, {gb} GB; now "
            f"{seconds * 1e3 / ms:.2f}x the time, {peak / 1e9 - gb:+.2f} GB)")


def fused_update(counts, steps) -> bool:
    """Whether `steps` train steps launched each AdamW kernel once a step
    (every tree here has fewer leaves than one launch carries)."""
    return counts.get("grad_sumsq") == steps == counts.get("adamw_apply")


def train_card_vs_cpu(name, seed):
    """Three `make_train_step` steps of `name`'s smoke config in f32 on
    the card and on the CPU from one `init_train_state` (the last step
    with accum_steps=2), lr 1e-3. Returns ({"loss", "grad_norm",
    "params": the largest difference, relative for the first two},
    flash backward launches on the card)."""
    import torch
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_f32(name)
    model = Model(cfg)
    init = init_train_state(model, seed, "cpu")
    rng = np.random.default_rng(seed + 7)
    batches = []
    for _ in range(3):
        b = {"tokens": rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)}
        b.update(family_extra(cfg, rng, 4) or {})
        batches.append(b)
    keys = tuple(k for k in batches[0] if k != "tokens")
    steps = [make_train_step(model, lr=1e-3, extra_keys=keys)] * 2 + \
        [make_train_step(model, lr=1e-3, extra_keys=keys, accum_steps=2)]
    runs = {}
    for dev in ("cuda", "cpu"):
        state = tree_map(lambda t: t.to(dev), init)
        before = COUNTS["flash_attention_bwd"]
        metrics = []
        for step, b in zip(steps, batches):
            state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                    for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = (metrics, [t.cpu() for t in tree_leaves(state.params)],
                     COUNTS["flash_attention_bwd"] - before)
    card, cpu = runs["cuda"], runs["cpu"]
    errs = {"loss": max(abs(a[0] - b[0]) / abs(b[0])
                        for a, b in zip(card[0], cpu[0])),
            "grad_norm": max(abs(a[1] - b[1]) / abs(b[1])
                             for a, b in zip(card[0], cpu[0])),
            "params": max(float((a - b).abs().max())
                          for a, b in zip(card[1], cpu[1]))}
    return errs, card[2], card[0]


def train_parity_phase(seed):
    """Phase 12a: `train_card_vs_cpu` of each of TRAIN_PARITY_ARCHS."""
    for name in TRAIN_PARITY_ARCHS:
        errs, launches, metrics = train_card_vs_cpu(name, seed)
        log(f"train parity {name}: 3 steps (accum 2 on the last), losses "
            f"{[round(m[0], 4) for m in metrics]}, errors loss "
            f"{errs['loss']:.3e} grad norm {errs['grad_norm']:.3e} params "
            f"{errs['params']:.3e} (tolerances {TRAIN_TOL}), flash "
            f"backward launches {launches}")
        if not (all(errs[k] <= TRAIN_TOL[k] for k in TRAIN_TOL)
                and launches > 0):
            raise AssertionError(f"train parity {name}: the card's steps "
                                 f"disagree with the CPU's, or the flash "
                                 f"backward never launched")


def train_witness_phase(seed):
    """Phase 12c: the gradient of phase 12's first step at full width
    (internlm2-1.8b cut to 2 layers, phase 12's first batch, bf16, remat)
    against the same step with the same weights widened to f32 on the
    card, whose kernels phase 12a holds against the CPU and 2d against
    the plain backward. Returns the errors (loss and grad norm relative;
    "grads": the largest relative L2 error of one parameter's
    gradient, with the parameter's name)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.tree import leaves_with_path, tree_leaves, tree_map
    free_card()
    cfg = dataclasses.replace(configs.get("internlm2-1.8b"), num_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    params = Model(cfg).init(seed, device="cuda")
    tokens = train_batches(cfg.vocab, seed, 1)[0]
    before = COUNTS["flash_attention_bwd"]
    loss16, g16 = value_and_grad(Model(cfg), params, tokens)
    launched16 = COUNTS["flash_attention_bwd"] - before
    params = tree_map(lambda t: t.float(), params)
    loss32, g32 = value_and_grad(Model(cfg32), params, tokens)
    launched32 = COUNTS["flash_attention_bwd"] - before - launched16
    n16, n32 = float(global_norm(g16)), float(global_norm(g32))
    rel = {"/".join(map(str, path)): float((a.float() - b).norm() / b.norm())
           for (path, b), a in zip(leaves_with_path(g32), tree_leaves(g16))}
    worst = max(rel, key=rel.get)
    errs = {"loss": abs(float(loss16) - float(loss32)) / float(loss32),
            "grad_norm": abs(n16 - n32) / n32, "grads": rel[worst]}
    log(f"train witness: {cfg.name} at 2 layers, B={TRAIN_B} S={TRAIN_S}: "
        f"bf16 loss {float(loss16):.6f} grad norm {n16:.6f}, f32 loss "
        f"{float(loss32):.6f} grad norm {n32:.6f}; errors loss "
        f"{errs['loss']:.3e} grad norm {errs['grad_norm']:.3e}, gradient "
        f"relative L2 by parameter {{{', '.join(f'{k}: {v:.3e}' for k, v in rel.items())}}} "
        f"(tolerances {WITNESS_TOL}); flash backward launches bf16 "
        f"{launched16} f32 {launched32}")
    del params, g16, g32
    free_card()
    if not (all(errs[k] <= WITNESS_TOL[k] for k in WITNESS_TOL)
            and launched16 > 0 and launched32 > 0):
        raise AssertionError(f"train witness: the bf16 step's gradient "
                             f"disagrees with the f32 step's ({worst}) or "
                             f"the flash backward never launched")
    return dict(errs, worst=worst)


def train_batches(vocab, seed, steps, B=TRAIN_B, S=TRAIN_S):
    """`steps` batches of B x (S + 1) tokens (S positions after the
    shift by one) from `SyntheticCorpus`, on the card."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    corpus = SyntheticCorpus(DataConfig(vocab=vocab, seq_len=S + 1,
                                        global_batch=B, seed=seed))
    return [torch.as_tensor(corpus.batch(0, i)["tokens"], device="cuda")
            for i in range(steps)]


def train_phase(seed):
    """Phase 12: internlm2-1.8b at full width and depth (random bf16
    weights from `seed`) takes TRAIN_STEPS steps of TRAIN_B x TRAIN_S
    tokens at a fixed lr with remat; the loss must fall. Then its
    parameters are saved (`save_pytree`), restored into fresh tensors
    (bitwise equal), the optimizer state is freed and phase 4's stream
    is served from the restored weights. Returns (launches by kernel in
    the training steps, the serve's launches, numbers; "mesh_ref": the
    losses and grad norms of the first MESH_TRAIN_STEPS steps and the
    parameters after them, on the host, which phase 14a holds its
    meshed steps to)."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import restore_pytree, save_pytree
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    free_card()
    cfg = configs.get("internlm2-1.8b")
    model = Model(cfg)
    state = init_train_state(model, seed, "cuda")
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    batches = train_batches(cfg.vocab, seed, TRAIN_STEPS)
    step_fn = make_train_step(model, lr=TRAIN_LR, donate=True)
    log(f"train: {cfg.name} {cfg.num_layers} layers, {n_params / 1e9:.3f} "
        f"B params bf16, train state {state_bytes / 1e9:.2f} GB (bf16 "
        f"params, f32 m and v), B={TRAIN_B} S={TRAIN_S}, lr {TRAIN_LR}, "
        f"remat on, the step donated")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()                          # the main path's run only
    losses, gnorms, times = [], [], []
    for i, tokens in enumerate(batches):
        t = time.time()
        state, m = step_fn(state, {"tokens": tokens})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        times.append(time.time() - t)
        losses.append(loss)
        gnorms.append(gnorm)
        log(f"train step {i + 1}: loss {loss:.4f} grad norm {gnorm:.4f} "
            f"{times[-1] * 1e3:.1f} ms")
        if i + 1 == MESH_TRAIN_STEPS:       # phase 14a's reference
            mesh_ref = {"losses": list(losses), "grad_norms": list(gnorms),
                        "params": [p.to("cpu") for p in
                                   tree_leaves(state.params)]}
    counts = dict(COUNTS)
    peak = torch.cuda.max_memory_allocated()
    tokens_per_s = TRAIN_B * TRAIN_S * (TRAIN_STEPS - 1) / sum(times[1:])
    steady = sum(times[1:]) / (TRAIN_STEPS - 1)
    log(f"train: {TRAIN_STEPS} steps, steady {steady * 1e3:.1f} "
        f"ms/step ({tokens_per_s:.0f} tokens/s; the first step "
        f"{times[0] * 1e3:.1f} ms), peak memory {peak / 1e9:.2f} GB "
        f"{beside_unfused('train', steady, peak)}, launches {counts}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    per_step = 2 * cfg.num_layers * TRAIN_STEPS     # forward + recompute
    if counts.get("flash_attention") != per_step or \
            counts.get("flash_attention_bwd") != per_step // 2 or \
            not fused_update(counts, TRAIN_STEPS):
        raise AssertionError(f"train: launches {counts}, expected flash "
                             f"{per_step}, its backward {per_step // 2} and "
                             f"the AdamW kernels {TRAIN_STEPS} each")
    params = state.params
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        nbytes = save_pytree(params, d)
        save_s = time.time() - t
        t = time.time()
        restored = restore_pytree(tree_map(lambda x: x.to("meta"), params),
                                  d, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.time() - t
    raw = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(restored), tree_leaves(params)))
    log(f"train checkpoint: params {raw / 1e9:.3f} GB -> {nbytes / 1e9:.3f} "
        f"GB of chunks, save {save_s:.2f} s, restore {restore_s:.2f} s, "
        f"restored bitwise equal {same}")
    if not same:
        raise AssertionError("train: the restored parameters differ")
    del state, params, m
    free_card()                              # the optimizer state goes
    serve, numbers = serve_phase(model, restored, seed,
                                 what="serve trained")
    numbers.update(losses=losses, step_s=times, train_peak_bytes=peak,
                   tokens_per_s_train=tokens_per_s, save_s=save_s,
                   restore_s=restore_s, ckpt_bytes=nbytes,
                   mesh_ref=mesh_ref)
    del restored
    free_card()
    return counts, serve, numbers


def resume_phase(seed):
    """Phase 12b: internlm2-1.8b at full width but 2 layers (a ~5 GB
    train state, not ~23 GB, so the phase stays short), the step
    donated: 4 steps straight, against 2 steps, an async
    `CheckpointManager.save` of the whole TrainState, 2 more steps on
    that state (written in place while the save may still be writing),
    and a restore of the save into fresh tensors with the same 2 steps.
    Losses, parameters and optimizer state of both continuations must
    be bitwise the straight run's. Returns (launches by kernel,
    numbers)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    free_card()
    cfg = dataclasses.replace(configs.get("internlm2-1.8b"), num_layers=2)
    model = Model(cfg)
    batches = train_batches(cfg.vocab, seed + 1, 4)
    step_fn = make_train_step(model, lr=TRAIN_LR, donate=True)

    def run(state, steps):
        losses = []
        for i in steps:
            state, m = step_fn(state, {"tokens": batches[i]})
            losses.append(m["loss"])
        return state, losses

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()
    straight, times = init_train_state(model, seed, "cuda"), []
    l_straight = []
    for i in range(4):
        t = time.time()
        straight, loss = run(straight, [i])
        torch.cuda.synchronize()
        times.append(time.time() - t)
        l_straight += loss
    step_s = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated()
    half, l_half = run(init_train_state(model, seed, "cuda"), range(2))
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(half))
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        t = time.time()
        mgr.save(2, half)                   # async after the snapshot
        snapshot_s = time.time() - t
        on, l_on = run(half, range(2, 4))   # written into the saved tensors
        mgr.wait()
        write_s = time.time() - t
        t = time.time()
        resumed = mgr.restore(tree_map(lambda x: x.to("meta"), straight),
                              step=2, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.time() - t
    resumed, more = run(resumed, range(2, 4))
    counts = dict(COUNTS)
    same_loss = torch.equal(torch.stack(l_straight),
                            torch.stack(l_half + more)) and \
        torch.equal(torch.stack(l_straight), torch.stack(l_half + l_on))
    same_state = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                     zip(tree_leaves(straight), tree_leaves(resumed),
                         tree_leaves(on)))
    log(f"train resume: {cfg.name} at 2 layers, train state "
        f"{state_bytes / 1e9:.2f} GB, the step donated: "
        f"{[round(x * 1e3, 1) for x in times]} ms a step (median "
        f"{step_s * 1e3:.1f}), peak memory {peak / 1e9:.2f} GB "
        f"{beside_unfused('train resume', step_s, peak)}; async save "
        f"{snapshot_s:.2f} s to the host snapshot, {write_s:.2f} s to "
        f"COMMIT (2 donated steps on the saved state ran meanwhile), "
        f"restore {restore_s:.2f} s; losses straight "
        f"{[round(float(x), 4) for x in l_straight]} resumed "
        f"{[round(float(x), 4) for x in l_half + more]}; losses bitwise "
        f"equal {same_loss}, params and optimizer state bitwise equal "
        f"{same_state} (the restored run and the run that went on)")
    if not (same_loss and same_state):
        raise AssertionError("train resume: the resumed run differs from "
                             "the straight one")
    if not fused_update(counts, 10):
        raise AssertionError(f"train resume: launches {counts}, expected "
                             f"the AdamW kernels 10 times each")
    del straight, resumed, on, half
    free_card()
    return counts, {"state_bytes": state_bytes, "snapshot_s": snapshot_s,
                    "write_s": write_s, "restore_s": restore_s,
                    "step_s": step_s, "peak_bytes": peak}


def stream_outcome(eng, rep) -> dict:
    """What two serves of one stream must agree on: greedy tokens,
    statuses and every priced step's bytes."""
    return {"outputs": {r.rid: list(r.output) for r in rep},
            "statuses": rep.statuses,
            "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out)
                      for s in eng.stats]}


def mesh_serve_phase(model, params, seed, inline, overlap):
    """Phase 13a: phase 4's stream, then phase 4b's (overlap mode: the
    commits' side stream beside the in-graph collectives, pinned host
    pools, the measured payback agreed over the mesh), each on a new
    `ServingEngine(..., mesh=)` over a world-size-1 NCCL group (a
    `file://` store in a temporary directory: no network) and
    `make_test_mesh(1, 1)`, at full width: every collective of the
    meshed path runs on the card, inside the captured chunks. Greedy
    tokens, statuses and step bytes must equal the unmeshed serve's
    (`inline["stream"]`, `overlap["stream"]`), the captures stay within
    `serve_graph_bound` and serving again captures nothing. The engines
    are freed, then the group is torn down. Returns the launches by
    kernel by path ("mesh_serve", "mesh_serve_overlap": the latter with
    its payback probe's) and the numbers by mode."""
    counts, numbers = {}, {}
    with world_of_one("chip_smoke_mesh_") as mesh:
        for path, mode, want in (("mesh_serve", "inline", inline),
                                 ("mesh_serve_overlap", "overlap", overlap)):
            counts[path], numbers[mode] = mesh_serve_mode(
                model, params, seed, mesh, mode, want)
            free_card()
    return counts, numbers


def mesh_serve_mode(model, params, seed, mesh, mode, want):
    """One of phase 13a's serves (`mode` "inline" or "overlap") on a new
    meshed engine, against the unmeshed serve's numbers `want`."""
    import torch
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving.engine import (
        EngineConfig, ServingEngine, serve_graph_bound,
    )
    cfg = model.cfg
    overlap = mode == "overlap"
    what = f"mesh serve {mode}"
    ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                        policy="importance", prefill_chunk=256,
                        telemetry_stride=16, overlap_migrations=overlap,
                        measured_payback=overlap)
    eng = ServingEngine(model, params, ecfg, mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()                      # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    rep = eng.serve(phase4_requests(cfg.vocab, seed), num_slots=8,
                    seed=seed)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(COUNTS)
    steps_run = eng.steps_run
    got = stream_outcome(eng, rep)
    same = {k: got[k] == want["stream"][k] for k in want["stream"]}
    bound = serve_graph_bound(eng.geo, ecfg.telemetry_stride)
    captures = sum(eng.captures.values())
    tokens = sum(len(r.output) for r in rep)
    peak = torch.cuda.max_memory_allocated()
    pinned = overlap and eng.state.k_host.is_pinned() and \
        eng.state.v_host.is_pinned()
    log(f"{what}: {wall:.2f} s wall, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s (unmeshed: "
        f"{want['tokens_per_s']:.1f}), TTFT p50 "
        f"{rep.ttft['p50']:.3f} s ({want['ttft_p50']:.3f}), TPOT p50 "
        f"{rep.tpot['p50'] * 1e3:.2f} ms "
        f"({want['tpot_p50'] * 1e3:.2f}); data=1 model=1 over NCCL; "
        f"equal to the unmeshed serve: tokens {same['outputs']} statuses "
        f"{same['statuses']} step bytes {same['bytes']}; "
        f"{captures} captures of a bound of {bound}; "
        f"{counts.get('paged_attention', 0)} paged and "
        f"{counts.get('page_copy', 0)} row-copy launches, "
        f"{steps_run} steps run, peak memory {peak / 1e9:.2f} GB"
        f"{f', host pools pinned {pinned}' if overlap else ''}; "
        f"card {card_line()}")
    numbers = {"tokens_per_s": tokens / wall,
               "ttft_p50": rep.ttft["p50"], "tpot_p50": rep.tpot["p50"],
               "captures": captures, "bound": bound}
    numbers.update(graph_report(eng, what, list(eng.chunk_log), numbers,
                                lambda: eng.serve(
                                    phase4_requests(cfg.vocab, seed),
                                    num_slots=8, seed=seed)))
    log(f"{what} vs unmeshed, served again (one process): tokens/s "
        f"{numbers['again_tokens_per_s']:.1f} vs "
        f"{want['again_tokens_per_s']:.1f}, TTFT p50 "
        f"{numbers['again_ttft_p50']:.3f} vs "
        f"{want['again_ttft_p50']:.3f} s, TPOT p50 "
        f"{numbers['again_tpot_p50'] * 1e3:.2f} vs "
        f"{want['again_tpot_p50'] * 1e3:.2f} ms")
    if not all(same.values()):
        raise AssertionError(f"{what} differs from the unmeshed serve: "
                             f"{same}")
    if not 0 < captures <= bound:
        raise AssertionError(f"{what}: {captures} captures, bound {bound}")
    if counts.get("paged_attention", 0) != 2 * cfg.num_layers * steps_run:
        raise AssertionError(f"{what}: {counts} for {steps_run} steps")
    if overlap and not pinned:
        raise AssertionError(f"{what}: host pools not pinned")
    return counts, numbers


#: phase 13b's splits: (model, size of the model axis)
TP_SPLITS = (("internlm2-1.8b", 2), ("internlm2-1.8b", 4),
             ("qwen3-32b", 4))
#: a split decode layer against the unsplit one (bf16): max |split -
#: unsplit| over max |unsplit| of the attention block's and the MLP's
#: outputs, about twice the largest seen on an H100 (attention 7.7e-3,
#: MLP 6.8e-3: the ranks' partial products each rounded to bf16, then
#: summed in bf16); the importance summed over shards, absolute
TP_TOL = {"attn": 1.5e-2, "mlp": 1.5e-2, "importance": 1e-4}


def tp_pools(rng, B, Ph, Pe, T, KH, HD, device):
    """One layer's two tiers with a page list each (every lane's HBM
    pages full but its last, which takes this step's token; host pages
    full), and the write slot and offset of each lane's token."""
    import torch
    hl = np.full((B, Ph), -1, np.int32)
    hv = np.zeros((B, Ph), np.int32)
    el = np.full((B, Pe), -1, np.int32)
    ev = np.zeros((B, Pe), np.int32)
    slot = np.zeros((B,), np.int32)
    offset = np.zeros((B,), np.int32)
    for b in range(B):
        n_h = int(rng.integers(2, Ph + 1))
        n_e = int(rng.integers(0, Pe + 1))
        hl[b, :n_h] = np.arange(n_h)
        hv[b, :n_h] = T
        offset[b] = rng.integers(0, T)
        hv[b, n_h - 1] = offset[b]
        slot[b] = n_h - 1
        el[b, :n_e] = np.arange(n_e)
        ev[b, :n_e] = T
    pools = [torch.randn((B, P, T, KH, HD), dtype=torch.bfloat16,
                         device=device) for P in (Ph, Ph, Pe, Pe)]
    lists = [torch.as_tensor(x, device=device) for x in (hl, hv, el, ev)]
    return pools, lists, torch.as_tensor(slot, device=device), \
        torch.as_tensor(offset, device=device)


def tp_layer(lp, cfg, h, pos, pools, lists, slot, offset):
    """One decode layer's attention block (token write included, the
    paged kernel on the card) and the function giving its MLP block's
    output: a rank's partial sums under a rank-local `cfg`, the whole
    layer's under the whole one. Returns (attention output [B, 1, d],
    importance [B, Ph + Pe], mlp(h2) -> [B, 1, d])."""
    from repro_torch.kvcache.paged import write_token_layer
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm, swiglu
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = tfm.attn_qkv(x, lp, cfg, pos[:, None])
    write_token_layer(*pools, slot, offset, k[:, 0], v[:, 0])
    o, imp = tfm.paged_attend(q, pools, lists, slot, offset, cfg)

    def mlp(h2):
        return swiglu(rms_norm(h2, lp["mlp_norm"], cfg.norm_eps),
                      lp["w_gate"], lp["w_up"], lp["w_down"])
    return tfm.attn_out(o, lp), imp, mlp


def tp_split_phase(seed):
    """Phase 13b: the tensor-parallel split of one full-width decode
    layer on one card, rank after rank. For each of `TP_SPLITS`: one
    layer of the config at its published widths (random bf16 weights),
    B=8 lanes over 64 HBM and 208 host pages; every rank's shard
    (`bridge.shard_params` over a mesh of names and sizes,
    `ModelConfig.rank_local`) runs the attention block, its partial
    outputs summed in bf16 in rank order as `all_reduce_sum` sums them;
    then the MLP likewise on the summed residual. Against the unsplit
    layer within `TP_TOL`; the importance summed over shards against
    the unsplit importance; the paged kernel at each shard's KH against
    its plain version on the shard's inputs (`check_paged`, untimed)."""
    import dataclasses
    import torch
    from repro_torch import bridge, configs
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import layers_of
    device = torch.device("cuda")
    rng = np.random.default_rng(seed)
    out = []
    for name, m in TP_SPLITS:
        cfg = dataclasses.replace(configs.get(name), num_layers=1)
        params = Model(cfg).init(seed, device=device)
        B, Ph, Pe, T = 8, 64, 208, cfg.kv_page_tokens
        pools, lists, slot, offset = tp_pools(rng, B, Ph, Pe, T,
                                              cfg.kv_heads, cfg.head_dim,
                                              device)
        kh = cfg.kv_heads // m
        shard_pools = [[p[..., r * kh:(r + 1) * kh, :].contiguous()
                        for p in pools] for r in range(m)]
        h = torch.randn((B, 1, cfg.d_model), dtype=torch.bfloat16,
                        device=device)
        pos = (lists[1] > 0).sum(-1) * T        # any position will do
        attn, imp, mlp = tp_layer(layers_of(params["layers"])[0], cfg, h,
                                  pos, pools, lists, slot, offset)
        mesh = AbstractMesh(("data", "model"), (1, m))
        parts, imps, mlps = [], [], []
        for r in range(m):
            local = cfg.rank_local(m)
            lp = layers_of(bridge.shard_params(
                params, cfg, mesh, {"data": 0, "model": r})["layers"])[0]
            a, i, f = tp_layer(lp, local, h, pos, shard_pools[r], lists,
                               slot, offset)
            parts.append(a)
            imps.append(i)
            mlps.append(f)
            q = torch.randn((B, kh, local.q_per_kv, cfg.head_dim),
                            dtype=torch.bfloat16, device=device)
            for tier, (k, v, pl, pv) in enumerate((
                    (*shard_pools[r][:2], *lists[:2]),
                    (*shard_pools[r][2:], *lists[2:]))):
                pl, pv = pl.clone(), pv.clone()
                pl[B - 1], pv[B - 1] = -1, 0     # check_paged's empty lane
                check_paged(f"tp {name} model={m} rank {r} KH={kh} "
                            f"G={local.q_per_kv} HD={cfg.head_dim} "
                            f"{'host' if tier else 'HBM'} tier N="
                            f"{pl.shape[1]}", (q, k, v, pl, pv))
        summed = parts[0]
        for a in parts[1:]:
            summed = summed + a
        h2 = h + attn
        y = mlp(h2)
        y_split = mlps[0](h2)
        for f in mlps[1:]:
            y_split = y_split + f(h2)
        err = {
            "attn": float((summed.float() - attn.float()).abs().max()
                          / attn.float().abs().max()),
            "mlp": float((y_split.float() - y.float()).abs().max()
                         / y.float().abs().max()),
            "importance": float((sum(imps) - imp).abs().max()),
        }
        torch.cuda.synchronize()
        log(f"tp {name} model={m}: heads {cfg.num_heads}/{cfg.kv_heads} -> "
            f"{cfg.num_heads // m}/{kh} a rank, d_ff {cfg.d_ff} -> "
            f"{cfg.d_ff // m}, vocab rows {cfg.vocab // m}; split against "
            f"unsplit (max |diff| / max |value|): attention "
            f"{err['attn']:.3e} mlp {err['mlp']:.3e}, importance summed "
            f"over ranks {err['importance']:.3e} absolute (tolerance "
            f"{TP_TOL})")
        bad = {k: e for k, e in err.items() if not e <= TP_TOL[k]}
        if bad:
            raise AssertionError(f"tp {name} model={m}: {bad}")
        out.append({"model": name, "split": m, **err})
        del params, pools, shard_pools
        free_card()
    return out


#: phase 14a: the meshed steps held to phase 12's first steps
MESH_TRAIN_STEPS = 3


def mesh_train_phase(seed, ref):
    """Phase 14a: phase 12's training on a world-size-1 NCCL mesh (a
    `file://` store in a temporary directory) and `make_test_mesh(1,
    1)`: internlm2-1.8b at full width and depth, the same seed and
    batches, MESH_TRAIN_STEPS steps of `make_train_step(..., mesh=)`
    from `init_train_state(..., mesh=)`, so every collective of the
    meshed step runs on the card (each an identity at size 1), every
    step donated as phase 12's. Losses, grad norms and parameters must
    be bitwise phase 12's (`ref`). Then
    the checkpoint round trip at 2 layers (as phase 12b, whose whole
    train state takes a minute to write; at full depth it would be
    ~19 GB): 2 meshed steps, a save on the mesh (`CheckpointManager(
    mesh=)`, the leaves gathered whole), a restore without a mesh and
    one unmeshed step must equal 3 unmeshed steps, bitwise. The state
    is freed, then the group is torn down. Returns the launches by
    kernel of the full-depth meshed steps and numbers."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves
    free_card()
    with world_of_one("chip_smoke_train_mesh_") as mesh:
        cfg = configs.get("internlm2-1.8b")
        model = Model(cfg)
        state = init_train_state(model, seed, "cuda", mesh=mesh)
        step_fn = make_train_step(model, lr=TRAIN_LR, mesh=mesh,
                                  donate=True)
        batches = train_batches(cfg.vocab, seed, MESH_TRAIN_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        COUNTS.clear()                      # the main path's run only
        losses, gnorms, times = [], [], []
        for tokens in batches:
            t = time.time()
            state, m = step_fn(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            times.append(time.time() - t)
        counts = dict(COUNTS)
        peak = torch.cuda.max_memory_allocated()
        diffs = [float((a.float() - b.to(a.device).float()).abs().max())
                 for a, b in zip(tree_leaves(state.params), ref["params"])]
        same = {"losses": losses == ref["losses"],
                "grad_norms": gnorms == ref["grad_norms"],
                "params": all(torch.equal(a, b.to(a.device)) for a, b in
                              zip(tree_leaves(state.params),
                                  ref["params"]))}
        log(f"mesh train: {cfg.name} {cfg.num_layers} layers, data=1 "
            f"model=1 over NCCL, B={TRAIN_B} S={TRAIN_S}, lr {TRAIN_LR}, "
            f"remat on: losses {losses} grad norms {gnorms} (phase 12: "
            f"{ref['losses']} {ref['grad_norms']}); bitwise equal to phase "
            f"12's steps: losses {same['losses']} grad norms "
            f"{same['grad_norms']} parameters {same['params']} (largest "
            f"|diff| {max(diffs):.3e}); "
            f"{[round(x * 1e3, 1) for x in times]} ms a step, peak memory "
            f"{peak / 1e9:.2f} GB "
            f"{beside_unfused('mesh train', sorted(times)[1], peak)}, "
            f"launches {counts}")
        del state, m
        free_card()
        numbers = {"losses": losses, "grad_norms": gnorms, "step_s": times,
                   "peak_bytes": peak, "max_param_diff": max(diffs)}
        numbers.update(mesh_checkpoint_part(seed, mesh))
        per_step = 2 * cfg.num_layers * MESH_TRAIN_STEPS
        if not all(same.values()):
            raise AssertionError(f"mesh train: the meshed steps differ "
                                 f"from phase 12's: {same}")
        if counts.get("flash_attention") != per_step or \
                counts.get("flash_attention_bwd") != per_step // 2 or \
                not fused_update(counts, MESH_TRAIN_STEPS):
            raise AssertionError(f"mesh train: launches {counts}, expected "
                                 f"flash {per_step}, its backward "
                                 f"{per_step // 2} and the AdamW kernels "
                                 f"{MESH_TRAIN_STEPS} each")
        return counts, numbers


def mesh_checkpoint_part(seed, mesh):
    """Phase 14a's checkpoint round trip at 2 layers on `mesh`: 2 meshed
    steps, a save on the mesh, a restore without one and a third,
    unmeshed step against 3 unmeshed steps; losses and the whole train
    state bitwise equal. Returns its numbers."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.bridge import train_state_specs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(configs.get("internlm2-1.8b"), num_layers=2)
    model = Model(cfg)
    batches = train_batches(cfg.vocab, seed + 2, 3)

    def run(state, step_fn, which):
        losses = []
        for i in which:
            state, m = step_fn(state, {"tokens": batches[i]})
            losses.append(m["loss"])
        return state, losses

    plain = make_train_step(model, lr=TRAIN_LR, donate=True)
    straight, l_straight = run(init_train_state(model, seed, "cuda"), plain,
                               range(3))
    meshed, l_resumed = run(init_train_state(model, seed, "cuda",
                                             mesh=mesh),
                            make_train_step(model, lr=TRAIN_LR, mesh=mesh,
                                            donate=True),
                            range(2))
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        t = time.time()
        CheckpointManager(root, mesh=mesh).save(
            2, meshed, blocking=True, specs=train_state_specs(cfg, mesh))
        save_s = time.time() - t
        target = tree_map(lambda x: x.to("meta"), meshed)
        del meshed
        t = time.time()
        resumed = CheckpointManager(root).restore(target, step=2,
                                                  device="cuda")
        torch.cuda.synchronize()
        restore_s = time.time() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    resumed, more = run(resumed, plain, range(2, 3))
    l_resumed += more
    same_loss = torch.equal(torch.stack(l_straight), torch.stack(l_resumed))
    same_state = all(torch.equal(a, b) for a, b in
                     zip(tree_leaves(straight), tree_leaves(resumed)))
    log(f"mesh train checkpoint: {cfg.name} at 2 layers: 2 steps on the "
        f"mesh, saved on it ({save_s:.2f} s to COMMIT), restored without a "
        f"mesh ({restore_s:.2f} s), 1 more step; losses straight "
        f"{[round(float(x), 4) for x in l_straight]} resumed "
        f"{[round(float(x), 4) for x in l_resumed]}; losses bitwise equal "
        f"{same_loss}, params and optimizer state bitwise equal "
        f"{same_state}")
    del straight, resumed
    free_card()
    if not (same_loss and same_state):
        raise AssertionError("mesh train checkpoint: the run resumed from "
                             "the meshed save differs from the straight one")
    return {"ckpt_save_s": save_s, "ckpt_restore_s": restore_s}


#: phase 14b's splits: (data, model) over which one full-width
#: internlm2-1.8b layer trains (B = TRAIN_B rows of TRAIN_S tokens)
TRAIN_SPLITS = ((1, 2), (1, 4), (2, 2), (2, 4))
#: a split layer's gradients against the unsplit layer's (bf16): max
#: |split - unsplit| over max |unsplit| of dx and of every weight's
#: gradient, assembled from the ranks' blocks; about twice the largest
#: seen on an H100 (dx 1.50e-2 at model = 2: the ranks' partial outputs
#: each rounded to bf16, then summed in bf16, in the forward and in the
#: sums of their input's gradients; every weight 4e-3 to 1e-2)
TRAIN_SPLIT_TOL = 3e-2


def train_split_phase(seed):
    """Phase 14b: one full-width internlm2-1.8b decoder layer (attention
    and MLP blocks, random bf16 weights) forward AND backward, split
    over each of `TRAIN_SPLITS` rank after rank on one card, the
    collectives done by hand in one autograd graph: each rank's train-
    mode shards (`bridge.shard_params(..., mode="train")` over a mesh of
    names and sizes, `ModelConfig.rank_local`); a model rank's FSDP
    blocks concatenated over `data` once and used by every data rank
    (so autograd sums the data ranks' gradients into each block: the
    reduce-scatter); each data rank's rows through the rank-local
    blocks, the model ranks' partial outputs summed in bf16 in rank
    order (g), the norms computed once per data rank from leaves whole
    on both axes (so their input's gradient sums over the model ranks:
    f). dx and every weight's gradient, assembled from the ranks'
    blocks, against the unsplit layer's within TRAIN_SPLIT_TOL. The
    flash kernel and its backward run at each rank's heads (8/4 at
    model = 2, 4/2 at 4) and rows. Returns the launches by kernel and
    the errors."""
    import dataclasses
    import torch
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shardings import data_dim
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import attention, rms_norm, swiglu
    from repro_torch.models.model import Model
    free_card()
    device = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("internlm2-1.8b"), num_layers=1)
    params = Model(cfg).init(seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    h = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    dy = torch.randn(h.shape, generator=gen,
                     device=device).to(torch.bfloat16)
    pos = torch.arange(TRAIN_S, device=device)[None, :]

    def layer(x, lp, local):
        """The layer on rows `x` with the model ranks' weights `lp` (a
        list, one dict a model rank; norms from the first), their
        partial outputs summed in rank order."""
        xn = rms_norm(x, lp[0]["attn_norm"], cfg.norm_eps)
        att = None
        for w in lp:
            q, k, v = tfm.attn_qkv(xn, w, local, pos)
            part = tfm.attn_out(attention(q, k, v), w)
            att = part if att is None else att + part
        h1 = x + att
        xn2 = rms_norm(h1, lp[0]["mlp_norm"], cfg.norm_eps)
        mlp = None
        for w in lp:
            part = swiglu(xn2, w["w_gate"], w["w_up"], w["w_down"])
            mlp = part if mlp is None else mlp + part
        return h1 + mlp

    whole = {k: v[0].detach().clone().requires_grad_(True)
             for k, v in params["layers"].items()}
    x = h.clone().requires_grad_(True)
    torch.autograd.backward(layer(x, [whole], cfg), dy)
    want = {"dx": x.grad, **{k: v.grad for k, v in whole.items()}}
    COUNTS.clear()
    out = []
    for data, m in TRAIN_SPLITS:
        mesh = AbstractMesh(("data", "model"), (data, m))
        local = cfg.rank_local(m)
        specs = bridge.param_specs(cfg, mesh, "train")
        blocks = {(d, r): {k: v[0].detach().clone().requires_grad_(True)
                           for k, v in bridge.shard_params(
                               params, cfg, mesh, {"data": d, "model": r},
                               "train")["layers"].items()}
                  for d in range(data) for r in range(m)}
        dims = {k: data_dim(specs[f"layers/{k}"]) for k in whole}
        # a model rank's leaves whole on data: its FSDP blocks gathered
        # (the stacked leaf's dim less its [L] dim), the others its own
        gathered = [{k: torch.cat([blocks[(d, r)][k] for d in range(data)],
                                  dims[k] - 1) if dims[k] is not None
                     else blocks[(0, r)][k] for k in whole}
                    for r in range(m)]
        x = h.clone().requires_grad_(True)
        rows = TRAIN_B // data
        y = torch.cat([layer(x[d * rows:(d + 1) * rows], gathered, local)
                       for d in range(data)])
        torch.autograd.backward(y, dy)
        got = {"dx": x.grad}
        for k in whole:
            spec = specs[f"layers/{k}"][1:]
            grid = [[blocks[(d, r)][k].grad if blocks[(d, r)][k].grad is
                     not None else torch.zeros_like(blocks[(d, r)][k])
                     for r in range(m)] for d in range(data)]
            got[k] = assemble(grid, spec)
        err = {k: float((got[k].float() - want[k].float()).abs().max()
                        / want[k].float().abs().max()) for k in want}
        worst = max(err, key=err.get)
        log(f"train split data={data} model={m}: {cfg.num_heads // m}/"
            f"{cfg.kv_heads // m} heads, d_ff {local.d_ff}, {rows} rows a "
            f"rank; gradients against the unsplit layer (max |diff| / max "
            f"|value|): {', '.join(f'{k} {e:.3e}' for k, e in err.items())}"
            f" (tolerance {TRAIN_SPLIT_TOL})")
        if not err[worst] <= TRAIN_SPLIT_TOL:
            raise AssertionError(f"train split data={data} model={m}: "
                                 f"{worst} {err[worst]:.3e}")
        out.append({"data": data, "model": m, "errors": err})
        del blocks, gathered, y, x
    counts = dict(COUNTS)
    log(f"train split: launches {counts}")
    del params, whole
    free_card()
    if not counts.get("flash_attention") or \
            not counts.get("flash_attention_bwd"):
        raise AssertionError(f"train split: launches {counts}")
    return counts, out


# --------------------------------------------------------------------------
# phase 15: the moe family across a mesh
# --------------------------------------------------------------------------

@contextlib.contextmanager
def world_of_one(prefix):
    """A world-size-1 NCCL process group over a `file://` store in a
    temporary directory (no network) and its `make_test_mesh(1, 1)`;
    torn down once the caller's tensors are collected."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    tmp = tempfile.mkdtemp(prefix=prefix)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield make_test_mesh(1, 1)
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_moe_serve_phase(model, params, seed, want):
    """Phase 15a: phase 7's serve (granite-moe-3b-a800m at full width,
    phase 4's 8 long requests, the same stream: routing depends on a
    lane's company) on a new `ServingEngine(..., mesh=)` over a
    world-size-1 NCCL mesh, on phase 7's weights: every collective of
    the meshed moe path (the experts' range and the lanes' rows bound;
    each an identity at size 1) runs inside the captured chunks.
    Tokens, statuses and step bytes must equal phase 7's
    (`want["stream"]`), the captures stay within `serve_graph_bound`,
    and the stream served again on the engine captures nothing and
    equals it too; tokens/s, TTFT and TPOT p50 of both serves beside
    phase 7's. Returns the launches by kernel and the numbers."""
    import torch
    from repro_torch.kernels.build import COUNTS
    from repro_torch.serving.engine import (
        EngineConfig, ServingEngine, serve_graph_bound,
    )
    cfg = model.cfg
    what = "mesh moe serve"
    ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                        policy="importance", prefill_chunk=256,
                        telemetry_stride=16)
    with world_of_one("chip_smoke_moe_mesh_") as mesh:
        eng = ServingEngine(model, params, ecfg, mesh=mesh)
        reqs = phase4_requests(cfg.vocab, seed)[:8]
        free_card()
        torch.cuda.reset_peak_memory_stats()
        COUNTS.clear()                      # the main path's run only
        torch.cuda.synchronize()
        t0 = time.time()
        rep = eng.serve(reqs, num_slots=8, seed=seed)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = dict(COUNTS)
        steps_run = eng.steps_run
        got = stream_outcome(eng, rep)
        experts = eng._run[0].tp.experts
        tokens = sum(len(o) for o in got["outputs"].values())
        peak = torch.cuda.max_memory_allocated()
        numbers = {"tokens_per_s": tokens / wall,
                   "ttft_p50": rep.ttft["p50"], "tpot_p50": rep.tpot["p50"],
                   "peak_bytes": peak,
                   "bound": serve_graph_bound(eng.geo,
                                              ecfg.telemetry_stride)}
        numbers.update(graph_report(eng, what, list(eng.chunk_log), numbers,
                                    lambda: eng.serve(
                                        phase4_requests(cfg.vocab, seed)[:8],
                                        num_slots=8, seed=seed)))
        del eng
    same = {k: got[k] == want["stream"][k] for k in want["stream"]}
    again = numbers.pop("again_stream") == got
    log(f"{what}: {wall:.2f} s wall, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s (phase 7: "
        f"{want['tokens_per_s']:.1f}), TTFT p50 {rep.ttft['p50']:.3f} s "
        f"({want['ttft_p50']:.3f}), TPOT p50 {rep.tpot['p50'] * 1e3:.2f} "
        f"ms ({want['tpot_p50'] * 1e3:.2f}); served again "
        f"{numbers['again_tokens_per_s']:.1f} tokens/s "
        f"({want['again_tokens_per_s']:.1f}), TTFT p50 "
        f"{numbers['again_ttft_p50']:.3f} s ({want['again_ttft_p50']:.3f}), "
        f"TPOT p50 {numbers['again_tpot_p50'] * 1e3:.2f} ms "
        f"({want['again_tpot_p50'] * 1e3:.2f}); data=1 model=1 over NCCL, "
        f"experts {experts} of {cfg.moe.num_experts_padded}; equal to "
        f"phase 7's serve: tokens {same['outputs']} statuses "
        f"{same['statuses']} step bytes {same['bytes']}, served again "
        f"{again}; {numbers['captures']} captures of a bound of "
        f"{numbers['bound']}; {counts.get('paged_attention', 0)} paged and "
        f"{counts.get('page_copy', 0)} row-copy launches, {steps_run} "
        f"steps run, peak memory {peak / 1e9:.2f} GB; card {card_line()}")
    log(beside_eager(what, numbers))
    if not all(same.values()) or not again:
        raise AssertionError(f"{what} differs from phase 7's: {same}, "
                             f"served again equal {again}")
    if not 0 < numbers["captures"] <= numbers["bound"]:
        raise AssertionError(f"{what}: {numbers['captures']} captures, "
                             f"bound {numbers['bound']}")
    if counts.get("paged_attention", 0) != 2 * cfg.num_layers * steps_run:
        raise AssertionError(f"{what}: {counts} for {steps_run} steps")
    return counts, numbers


#: phase 15b's splits of one granite-moe layer: (data, model)
MOE_SPLITS = ((1, 2), (1, 4), (2, 1), (2, 2))
#: a split granite-moe layer against the unsplit one (bf16): max |split
#: - unsplit| over max |unsplit| of the attention blocks' and the moe
#: FFN's outputs, decode and prefill chunk, about twice the largest seen
#: on an H100 (attention 4.1e-3, moe 4.6e-3: partial outputs each
#: rounded to bf16, then summed in bf16; 0 at data = 2 alone); the
#: importance summed over shards, absolute, as TP_TOL
MOE_SPLIT_TOL = {"attn": 1e-2, "moe": 1e-2, "importance": 1e-4}


def moe_rank(cfg, data, m, i, r, logits_of):
    """The `TensorParallel` of (data rank i, model rank r) of a split
    done by hand on one card: its experts' range and rows, its partial
    sums left to the caller (`reduce` the identity), and the routing
    rows' gather concatenating every data rank's logits
    (`logits_of(j)`, this rank's own tensor for j == i)."""
    import torch
    from repro_torch.models.transformer import TensorParallel

    def gather_rows(t, dim):
        return torch.cat([t if j == i else logits_of(j)
                          for j in range(data)], dim)
    return TensorParallel.of(cfg, m, r, reduce=lambda t: t, gather=None,
                             gather_rows=gather_rows,
                             rows=(i, data) if data > 1 else None)


def moe_split_ffn(x, lps, cfg, local, data, m, group):
    """The moe FFN of `x` [B, S, d] (post-norm) split over (data, m) by
    hand: each data rank's rows through each model rank's experts
    (`lps[r]`, the router whole), the model ranks' partial outputs
    summed in bf16 in rank order, the data ranks' rows concatenated."""
    import torch
    from repro_torch.models.moe import moe_ffn
    rows = x.shape[0] // data
    xs = [x[i * rows:(i + 1) * rows] for i in range(data)]
    router = lps[0]["router"]

    def logits_of(j):
        return (xs[j].reshape(-1, x.shape[-1]) @ router).float()
    out = []
    for i, xi in enumerate(xs):
        y = None
        for r, w in enumerate(lps):
            part = moe_ffn(xi, {**w, "router": router}, local,
                           group_size=group,
                           tp=moe_rank(cfg, data, m, i, r, logits_of))
            y = part if y is None else y + part
        out.append(y)
    return torch.cat(out)


def moe_split_phase(seed):
    """Phase 15b: one full-width granite-moe-3b-a800m layer (random bf16
    weights) split over each of `MOE_SPLITS` rank after rank on one
    card: a decode step of B=8 lanes over 64 HBM and 208 host pages and
    a prefill chunk of 256 tokens a lane. Attention: each model rank's
    heads and KV-head pools (`bridge.shard_params`, `rank_local`; the
    paged kernel, and the chunk's `prefill_chunk_attn`), the partial
    outputs summed in bf16 in rank order, the importance summed over
    ranks. The moe FFN: each model rank's experts (24 or 12 of the 48
    padded ones) on each data rank's lanes, routed over every data
    rank's logits (`TensorParallel.rows`: the decode step's 8 lanes are
    one group across data ranks, the chunk's 2048 rows four groups of
    512, each inside one data rank's lanes at data = 2). Against the
    unsplit layer within `MOE_SPLIT_TOL`; the paged kernel at each
    model split's KH against its plain version. Returns the launches by
    kernel and the errors."""
    import dataclasses
    import torch
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import Model
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import TensorParallel
    free_card()
    device = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m"),
                              num_layers=1)
    params = Model(cfg).init(seed, device=device)
    lp = tfm.layers_of(params["layers"])[0]
    B, Ph, Pe, T, C = 8, 64, 208, cfg.kv_page_tokens, 256
    d = cfg.d_model
    pools, lists, slot, offset = tp_pools(rng, B, Ph, Pe, T, cfg.kv_heads,
                                          cfg.head_dim, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)
    h = torch.randn((B, 1, d), generator=gen, device=device).to(
        torch.bfloat16)
    hc = torch.randn((B, C, d), generator=gen, device=device).to(
        torch.bfloat16)
    pos = (lists[1] > 0).sum(-1) * T        # any position will do
    # the chunk: lane b's C tokens from position T * b, over its HBM
    # slots (a prefix of random K/V before them)
    start = torch.arange(B, device=device) * T
    cpos, cpage, coff, cvalid = tfm.chunk_coords(
        T, C, start, torch.full((B,), C, device=device))
    seen = (-(-(T * (B - 1) + C) // T), 0)
    lanes = torch.arange(B, device=device)

    def blocks(w, local, pl):
        """(decode attention, importance, chunk attention) of the
        weights `w` over the pools `pl` (a rank's partials)."""
        a, imp, _ = tp_layer(w, local, h, pos, pl, lists, slot, offset)
        parts = []
        capture = TensorParallel(size=1, rank=0, mlp_split=False,
                                 vocab=None, gather=None,
                                 reduce=lambda t: parts.append(t) or
                                 torch.zeros_like(t))
        tfm.prefill_chunk_attn(hc, w, local, pl, cpos, cpage, coff, cvalid,
                               lanes, seen, capture)
        return a, imp, parts[0]

    attn, imp, cattn = blocks(lp, cfg, [p.clone() for p in pools])
    x = rms_norm(h + attn, lp["moe_norm"], cfg.norm_eps)
    xc = rms_norm(hc + cattn, lp["moe_norm"], cfg.norm_eps)
    y = moe_ffn(x, lp, cfg, group_size=B)
    yc = moe_ffn(xc, lp, cfg)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())
    COUNTS.clear()
    out = []
    checked = set()
    checks = collections.Counter()      # the kernel checks' launches
    for data, m in MOE_SPLITS:
        mesh = AbstractMesh(("data", "model"), (data, m))
        local = cfg.rank_local(m)
        kh = cfg.kv_heads // m
        lps, parts = [], []
        for r in range(m):
            lps.append(tfm.layers_of(bridge.shard_params(
                params, cfg, mesh, {"data": 0, "model": r})["layers"])[0])
            parts.append(blocks(lps[r], local, [
                p[..., r * kh:(r + 1) * kh, :].clone(
                    memory_format=torch.contiguous_format) for p in pools]))
            if m > 1 and m not in checked:
                before = collections.Counter(COUNTS)
                q = torch.randn((B, kh, local.q_per_kv, cfg.head_dim),
                                dtype=torch.bfloat16, device=device)
                shard = [p[..., r * kh:(r + 1) * kh, :] for p in pools]
                for tier, (k, v, pl, pv) in enumerate((
                        (*shard[:2], *lists[:2]), (*shard[2:], *lists[2:]))):
                    pl, pv = pl.clone(), pv.clone()
                    pl[B - 1], pv[B - 1] = -1, 0  # check_paged's empty lane
                    check_paged(f"moe split model={m} rank {r} KH={kh} "
                                f"G={local.q_per_kv} HD={cfg.head_dim} "
                                f"{'host' if tier else 'HBM'} tier N="
                                f"{pl.shape[1]}",
                                (q, k.contiguous(), v.contiguous(), pl, pv))
                checks.update(COUNTS - before)
        checked.add(m)
        summed = [None] * 3
        for part in parts:
            summed = [p if s is None else s + p
                      for s, p in zip(summed, part)]
        err = {"attn": max(rel(summed[0], attn), rel(summed[2], cattn)),
               "importance": float((summed[1] - imp).abs().max()),
               "moe": max(rel(moe_split_ffn(x, lps, cfg, local, data, m, B),
                              y),
                          rel(moe_split_ffn(xc, lps, cfg, local, data, m,
                                            None), yc))}
        torch.cuda.synchronize()
        experts = cfg.moe.num_experts_padded // m
        log(f"moe split data={data} model={m}: heads {cfg.num_heads // m}/"
            f"{kh} and {experts} of {cfg.moe.num_experts_padded} experts a "
            f"model rank, {B // data} lanes a data rank; split against "
            f"unsplit (max |diff| / max |value|, decode and prefill chunk): "
            f"attention {err['attn']:.3e} moe {err['moe']:.3e}, importance "
            f"summed over ranks {err['importance']:.3e} absolute "
            f"(tolerance {MOE_SPLIT_TOL})")
        bad = {k: e for k, e in err.items() if not e <= MOE_SPLIT_TOL[k]}
        if bad:
            raise AssertionError(f"moe split data={data} model={m}: {bad}")
        out.append({"data": data, "model": m, **err})
    counts = dict(COUNTS - checks)
    log(f"moe split: launches {counts} (the kernel checks' "
        f"{dict(checks)} apart)")
    del params, pools, lps, parts
    free_card()
    return counts, out


#: phase 15c: granite-moe's training at full width and depth. Its 3.97
#: B parameters (the 48 padded experts) take 12 bytes each in the
#: donated step's update (bf16 weights and gradients, f32 m and v:
#: 47.6 GB), where the unfused, pure update held ~26 (~103 GB) and
#: phase 15c ran 16 of the 32 layers until the fused kernels
MOE_TRAIN_STEPS = 3
#: phase 15c's last run at 16 of the 32 layers, with the pure step and
#: the plain PyTorch update (NVIDIA H100 80GB HBM3, 700.00 W): peak
#: memory and ms a step (median), printed beside
MOE_TRAIN_16_LAYERS = {"peak_gb": 62.62, "ms": 548.6}


def moe_train_phase(seed):
    """Phase 15c: granite-moe-3b-a800m at full width and all 32 layers,
    B=8 x S=512 from `SyntheticCorpus` (8 routing groups of 512 tokens,
    each one row), remat on, MOE_TRAIN_STEPS donated steps at TRAIN_LR:
    unmeshed, then from `init_train_state(..., mesh=)` on a world-size-1
    NCCL mesh (`make_train_step(..., mesh=)`: every collective of the
    meshed moe step, the experts' range and the router's f). Losses,
    grad norms and parameters bitwise equal; ms per step and peak
    memory of each beside the last 16-layer run's (MOE_TRAIN_16_LAYERS).
    A run that does not fit
    the card fails with the bytes it reached. Returns the launches by
    path ("moe_train", "mesh_moe_train") and the numbers."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves
    free_card()
    cfg = configs.get("granite-moe-3b-a800m")
    model = Model(cfg)
    batches = train_batches(cfg.vocab, seed, MOE_TRAIN_STEPS)

    def run(make_state, step_fn, what):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        COUNTS.clear()                      # the main path's run only
        losses, gnorms, times = [], [], []
        try:
            state = make_state()
            for tokens in batches:
                t = time.time()
                state, m = step_fn(state, {"tokens": tokens})
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                times.append(time.time() - t)
        except torch.cuda.OutOfMemoryError as e:
            raise AssertionError(
                f"{what}: {cfg.name} at {cfg.num_layers} layers does not "
                f"fit the card: {torch.cuda.max_memory_allocated()} bytes "
                f"at the peak, {torch.cuda.memory_allocated()} allocated "
                f"after {len(times)} steps ({e})") from None
        counts = dict(COUNTS)
        peak = torch.cuda.max_memory_allocated()
        n = sum(p.numel() for p in tree_leaves(state.params))
        old = MOE_TRAIN_16_LAYERS
        log(f"{what}: {cfg.name} at {cfg.num_layers} layers "
            f"({n / 1e9:.3f} B params), B={TRAIN_B} S={TRAIN_S}, lr "
            f"{TRAIN_LR}, remat on, the step donated: losses {losses} grad "
            f"norms {gnorms}; {[round(x * 1e3, 1) for x in times]} ms a "
            f"step (median {sorted(times)[1] * 1e3:.1f}), peak memory "
            f"{peak / 1e9:.2f} GB (at 16 of 32 layers with the unfused "
            f"update: {old['ms']} ms, {old['peak_gb']} GB), launches "
            f"{counts}; card {card_line()}")
        return state, {"losses": losses, "grad_norms": gnorms,
                       "step_s": times, "peak_bytes": peak,
                       "counts": counts}

    state, plain = run(lambda: init_train_state(model, seed, "cuda"),
                       make_train_step(model, lr=TRAIN_LR, donate=True),
                       "moe train")
    ref = [p.cpu() for p in tree_leaves(state.params)]
    del state
    free_card()
    with world_of_one("chip_smoke_moe_train_mesh_") as mesh:
        state, meshed = run(lambda: init_train_state(model, seed, "cuda",
                                                     mesh=mesh),
                            make_train_step(model, lr=TRAIN_LR, mesh=mesh,
                                            donate=True),
                            "mesh moe train")
        same = {"losses": meshed["losses"] == plain["losses"],
                "grad_norms": meshed["grad_norms"] == plain["grad_norms"],
                "params": all(torch.equal(a, b.to(a.device)) for a, b in
                              zip(tree_leaves(state.params), ref))}
        del state
    log(f"mesh moe train: bitwise equal to the unmeshed steps: losses "
        f"{same['losses']} grad norms {same['grad_norms']} parameters "
        f"{same['params']}; ms a step (median) "
        f"{sorted(meshed['step_s'])[1] * 1e3:.1f} against "
        f"{sorted(plain['step_s'])[1] * 1e3:.1f} unmeshed")
    del ref
    free_card()
    per_step = 2 * cfg.num_layers * MOE_TRAIN_STEPS
    for what, c in (("moe train", plain["counts"]),
                    ("mesh moe train", meshed["counts"])):
        if c.get("flash_attention") != per_step or \
                c.get("flash_attention_bwd") != per_step // 2 or \
                not fused_update(c, MOE_TRAIN_STEPS):
            raise AssertionError(f"{what}: launches {c}, expected flash "
                                 f"{per_step}, its backward "
                                 f"{per_step // 2} and the AdamW kernels "
                                 f"{MOE_TRAIN_STEPS} each")
    if not all(same.values()):
        raise AssertionError(f"mesh moe train: the meshed steps differ "
                             f"from the unmeshed ones: {same}")
    if not all(math.isfinite(x) for x in plain["losses"]):
        raise AssertionError(f"moe train: losses {plain['losses']}")
    return {"moe_train": plain.pop("counts"),
            "mesh_moe_train": meshed.pop("counts")}, \
        {"plain": plain, "meshed": meshed}


#: phase 15c's splits of one granite-moe layer's training: (data, model)
MOE_TRAIN_SPLITS = ((1, 2), (2, 2), (1, 4))
#: its gradients against the unsplit layer's (bf16): max |split -
#: unsplit| over max |unsplit| of each block's dx and of every weight's
#: gradient, about twice the largest seen on an H100 (dx of the
#: attention block 7.8e-3; a model split alone leaves every weight's
#: gradient exact, each head's and each expert's computed whole on one
#: rank from the same inputs)
MOE_TRAIN_SPLIT_TOL = 1.6e-2


def moe_train_split_phase(seed):
    """Phase 15c's split: one full-width granite-moe-3b-a800m layer's
    attention block and moe block (random bf16 weights), each forward
    AND backward on its own TRAIN_B rows of TRAIN_S tokens, split over
    each of `MOE_TRAIN_SPLITS` rank after rank on one card, as phase
    14b: each rank's train-mode shards (a model rank's heads and
    experts, their `embed` over data), a model rank's FSDP blocks
    concatenated over data once and used by every data rank, the model
    ranks' partial outputs summed in bf16 in rank order, the norms and
    the router used whole by every rank (so their gradients sum over
    the ranks: f), each data rank's rows routed over every data rank's
    logits (`moe_rank`; at data = 2 each rank's 4 rows are whole routing
    groups). The blocks take separate inputs because a moe block fed
    the split attention's output (rounded otherwise in bf16) may route
    a near-tied token to another expert, a difference of routing, not
    of the split. dx of each block and every weight's gradient,
    assembled from the ranks' blocks, against the unsplit layer's
    within MOE_TRAIN_SPLIT_TOL; the flash kernel and its backward at
    12/4 and 6/2 heads. Returns the launches by kernel and the
    errors."""
    import dataclasses
    import torch
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shardings import data_dim
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import attention, rms_norm
    from repro_torch.models.model import Model
    from repro_torch.models.moe import moe_ffn
    free_card()
    device = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m"),
                              num_layers=1)
    params = Model(cfg).init(seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 7)
    shape = (TRAIN_B, TRAIN_S, cfg.d_model)
    h, dy = [[torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16) for _ in range(2)] for _ in range(2)]
    pos = torch.arange(TRAIN_S, device=device)[None, :]
    dmodel = cfg.d_model

    def layer(xs, lp, local, data):
        """(the attention block on rows xs[0], the moe block on rows
        xs[1]) split over `data` data ranks and the model ranks' weights
        `lp` (one dict a model rank; the norms and the router from the
        first); unsplit with one of each."""
        rows = TRAIN_B // data
        m = len(lp)
        ya = []
        for i in range(data):
            xi = xs[0][i * rows:(i + 1) * rows]
            xn = rms_norm(xi, lp[0]["attn_norm"], cfg.norm_eps)
            att = None
            for w in lp:
                q, k, v = tfm.attn_qkv(xn, w, local, pos)
                part = tfm.attn_out(attention(q, k, v), w)
                att = part if att is None else att + part
            ya.append(xi + att)
        xs1 = [xs[1][i * rows:(i + 1) * rows] for i in range(data)]
        xn2 = [rms_norm(t, lp[0]["moe_norm"], cfg.norm_eps) for t in xs1]
        router = lp[0]["router"]

        def logits_of(j):
            return (xn2[j].reshape(-1, dmodel) @ router).float()
        ym = []
        for i in range(data):
            y = None
            for r, w in enumerate(lp):
                tp = None if (data, m) == (1, 1) else \
                    moe_rank(cfg, data, m, i, r, logits_of)
                part = moe_ffn(xn2[i], {**w, "router": router}, local,
                               tp=tp)
                y = part if y is None else y + part
            ym.append(xs1[i] + y)
        return torch.cat(ya), torch.cat(ym)

    def run(lp, local, data):
        """The blocks' outputs backward from `dy`: (dx of each)."""
        xs = [t.clone().requires_grad_(True) for t in h]
        torch.autograd.backward(layer(xs, lp, local, data), dy)
        return {"dx attn": xs[0].grad, "dx moe": xs[1].grad}

    whole = {k: v[0].detach().clone().requires_grad_(True)
             for k, v in params["layers"].items()}
    want = run([whole], cfg, 1)
    want.update({k: v.grad for k, v in whole.items()})
    COUNTS.clear()
    out = []
    for data, m in MOE_TRAIN_SPLITS:
        mesh = AbstractMesh(("data", "model"), (data, m))
        local = cfg.rank_local(m)
        specs = bridge.param_specs(cfg, mesh, "train")
        blocks = {(i, r): {k: v[0].detach().clone().requires_grad_(True)
                           for k, v in bridge.shard_params(
                               params, cfg, mesh, {"data": i, "model": r},
                               "train")["layers"].items()}
                  for i in range(data) for r in range(m)}
        dims = {k: data_dim(specs[f"layers/{k}"]) for k in whole}
        gathered = [{k: torch.cat([blocks[(i, r)][k] for i in range(data)],
                                  dims[k] - 1) if dims[k] is not None
                     else blocks[(0, r)][k] for k in whole}
                    for r in range(m)]
        got = run(gathered, local, data)
        for k in whole:
            spec = specs[f"layers/{k}"][1:]
            grid = [[blocks[(i, r)][k].grad if blocks[(i, r)][k].grad is
                     not None else torch.zeros_like(blocks[(i, r)][k])
                     for r in range(m)] for i in range(data)]
            got[k] = assemble(grid, spec)
        err = {k: float((got[k].float() - want[k].float()).abs().max()
                        / want[k].float().abs().max()) for k in want}
        worst = max(err, key=err.get)
        log(f"moe train split data={data} model={m}: "
            f"{cfg.num_heads // m}/{cfg.kv_heads // m} heads and "
            f"{local.moe.local_experts} experts a model rank, "
            f"{TRAIN_B // data} rows a data rank; gradients against the "
            f"unsplit layer (max |diff| / max |value|): "
            f"{', '.join(f'{k} {e:.3e}' for k, e in err.items())} "
            f"(tolerance {MOE_TRAIN_SPLIT_TOL})")
        if not err[worst] <= MOE_TRAIN_SPLIT_TOL:
            raise AssertionError(f"moe train split data={data} model={m}: "
                                 f"{worst} {err[worst]:.3e}")
        out.append({"data": data, "model": m, "errors": err})
        del blocks, gathered, got
    counts = dict(COUNTS)
    log(f"moe train split: launches {counts}")
    del params, whole, want
    free_card()
    if not counts.get("flash_attention") or \
            not counts.get("flash_attention_bwd"):
        raise AssertionError(f"moe train split: launches {counts}")
    return counts, out


# --------------------------------------------------------------------------
# phase 16: training across a mesh for the vlm, encdec, hybrid, ssm and
# xlstm families
# --------------------------------------------------------------------------

#: phase 16a's models (the ssm family is zamba2's stack without its
#: sites, which 16b's Mamba2 block covers), all at full width and depth:
#: the unfused AdamW holds ~26 bytes a parameter at its update, ~49 GB
#: for internvl2-2b's 1.89 B (as phase 12's internlm2 at 1.89 B, peak
#: ~54 GB), ~30 GB for zamba2-1.2b's 1.17 B, less for the others, so no
#: depth is cut
FAMILY_TRAIN_ARCHS = ("internvl2-2b", "whisper-tiny", "zamba2-1.2b",
                      "xlstm-125m")
FAMILY_TRAIN_STEPS = 3


def attention_calls(cfg) -> int:
    """Whole-sequence attention calls of one forward of `cfg` (each a
    flash launch on the card): every decoder layer; whisper's encoder
    layers and each decoder layer's self- and cross-attention; a
    hybrid model's sites; none in an ssm or xlstm model."""
    if cfg.family == "encdec":
        return cfg.encdec.enc_layers + 2 * cfg.num_layers
    return len(cfg.attention_layer_ids())


def family_batch_extra(cfg, seed, rows=TRAIN_B):
    """The family's modality input of a train batch, from `seed`, on the
    card in the model dtype: the vlm family's patch embeddings or the
    encdec family's frame embeddings [rows, n, d]; {} otherwise."""
    import torch
    key = {"vlm": "patch_embeds", "encdec": "frame_embeds"}.get(cfg.family)
    if key is None:
        return {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    return {key: torch.randn((rows, cfg.frontend.num_embeddings,
                              cfg.d_model), generator=gen,
                             device="cuda").to(cfg.dtype)}


def family_train_phase(seed):
    """Phase 16a: internvl2-2b (256 patch embeddings before the text),
    whisper-tiny (1500 frame embeddings), zamba2-1.2b and xlstm-125m at
    full width and depth (random bf16 weights from `seed`), B=8 x S=512
    tokens from `SyntheticCorpus` (and the family's extra, from `seed`),
    remat on, FAMILY_TRAIN_STEPS donated steps at TRAIN_LR: unmeshed,
    then from `init_train_state(..., mesh=)` on a world-size-1 NCCL mesh
    (`make_train_step(..., extra_keys=, mesh=)`: every collective of the
    family's meshed step, each an identity at size 1). Losses, grad
    norms and parameters bitwise equal; ms per step and peak memory of
    each beside the unfused update's; flash 2 x and its backward 1 x
    `attention_calls` a step (none for xlstm), the AdamW kernels once
    each a step. Returns the launches by path ("family_train",
    "mesh_family_train") and the numbers by model."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves
    counts = {"family_train": collections.Counter(),
              "mesh_family_train": collections.Counter()}
    numbers = {}
    for name in FAMILY_TRAIN_ARCHS:
        free_card()
        cfg = configs.get(name)
        model = Model(cfg)
        extra = family_batch_extra(cfg, seed)
        batches = train_batches(cfg.vocab, seed, FAMILY_TRAIN_STEPS)

        def run(state, step_fn, what):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            COUNTS.clear()                  # the main path's run only
            losses, gnorms, times = [], [], []
            for tokens in batches:
                t = time.time()
                state, m = step_fn(state, {"tokens": tokens, **extra})
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                times.append(time.time() - t)
            c = dict(COUNTS)
            peak = torch.cuda.max_memory_allocated()
            n = sum(p.numel() for p in tree_leaves(state.params))
            shapes = "".join(f", {k} {list(v.shape)}"
                             for k, v in extra.items())
            log(f"{what}: {name} ({cfg.family}, {cfg.num_layers} layers, "
                f"{n / 1e9:.3f} B params{shapes}), B={TRAIN_B} "
                f"S={TRAIN_S}, lr {TRAIN_LR}, remat on, the step donated: "
                f"losses {losses} grad norms {gnorms}; "
                f"{[round(x * 1e3, 1) for x in times]} ms a step, peak "
                f"memory {peak / 1e9:.2f} GB "
                f"{beside_unfused(f'{what} {name}', sorted(times)[1], peak)}"
                f", launches {c}; card {card_line()}")
            return state, {"losses": losses, "grad_norms": gnorms,
                           "step_s": times, "peak_bytes": peak, "counts": c,
                           "params": n}

        keys = tuple(extra)
        state, plain = run(init_train_state(model, seed, "cuda"),
                           make_train_step(model, lr=TRAIN_LR,
                                           extra_keys=keys, donate=True),
                           "family train")
        ref = [p.cpu() for p in tree_leaves(state.params)]
        del state
        free_card()
        with world_of_one("chip_smoke_family_train_") as mesh:
            state, meshed = run(
                init_train_state(model, seed, "cuda", mesh=mesh),
                make_train_step(model, lr=TRAIN_LR, extra_keys=keys,
                                mesh=mesh, donate=True), "mesh family train")
            same = {"losses": meshed["losses"] == plain["losses"],
                    "grad_norms": meshed["grad_norms"] ==
                    plain["grad_norms"],
                    "params": all(torch.equal(a, b.to(a.device)) for a, b in
                                  zip(tree_leaves(state.params), ref))}
            del state
        del ref, extra
        log(f"mesh family train: {name}: bitwise equal to the unmeshed "
            f"steps: losses {same['losses']} grad norms "
            f"{same['grad_norms']} parameters {same['params']}; ms a step "
            f"(median) {sorted(meshed['step_s'])[1] * 1e3:.1f} against "
            f"{sorted(plain['step_s'])[1] * 1e3:.1f} unmeshed")
        calls = attention_calls(cfg) * FAMILY_TRAIN_STEPS
        for what, got in (("family train", plain), ("mesh family train",
                                                    meshed)):
            c = got["counts"]
            if c.get("flash_attention", 0) != 2 * calls or \
                    c.get("flash_attention_bwd", 0) != calls or \
                    not fused_update(c, FAMILY_TRAIN_STEPS):
                raise AssertionError(f"{what} {name}: launches {c}, "
                                     f"expected flash {2 * calls}, its "
                                     f"backward {calls} and the AdamW "
                                     f"kernels {FAMILY_TRAIN_STEPS} each")
            if not all(math.isfinite(x) for x in got["losses"]):
                raise AssertionError(f"{what} {name}: losses "
                                     f"{got['losses']}")
        if not all(same.values()):
            raise AssertionError(f"mesh family train {name}: the meshed "
                                 f"steps differ from the unmeshed ones: "
                                 f"{same}")
        counts["family_train"].update(plain.pop("counts"))
        counts["mesh_family_train"].update(meshed.pop("counts"))
        numbers[name] = {"plain": plain, "meshed": meshed}
    free_card()
    return {k: dict(v) for k, v in counts.items()}, numbers


class ThreadMesh:
    """The ranks of a (`data`, `model`) mesh as threads of this process,
    each running the port's own rank-local code on its shards: a
    training rank binds `TrainMesh` (and so `make_train_step`) to
    `collectives`, the meshed step's differentiable collectives with
    each exchange (forward and backward) across the threads, and takes
    its own gradient on its own thread; a serving rank its `serve_tp`.
    Every exchange waits at most `TIMEOUT_S` for its peers."""

    TIMEOUT_S = 300

    def __init__(self, data: int, model: int):
        import threading
        self.sizes = {"data": data, "model": model}
        self._lock = threading.Lock()
        self._calls = collections.Counter()
        self._slots = {}
        self._read = collections.Counter()
        self._barriers = {
            **{("model", d): threading.Barrier(model, timeout=self.TIMEOUT_S)
               for d in range(data)},
            **{("data", r): threading.Barrier(data, timeout=self.TIMEOUT_S)
               for r in range(model)}}

    def exchange(self, coord, axis, t):
        """The tensors of every rank of `coord`'s group on `axis`, in
        rank order (each rank of the group calls this at the same
        point of its code)."""
        group = (axis, coord["model" if axis == "data" else "data"])
        me, n = coord[axis], self.sizes[axis]
        with self._lock:
            call = self._calls[(group, me)]
            self._calls[(group, me)] += 1
            slot = self._slots.setdefault((group, call), [None] * n)
        slot[me] = t
        self._barriers[group].wait()
        parts = list(slot)
        with self._lock:              # the last reader lets the tensors go
            self._read[(group, call)] += 1
            if self._read[(group, call)] == n:
                del self._slots[(group, call)], self._read[(group, call)]
        return parts

    def sum(self, coord, axis, t):
        """The sum of the tensors of `coord`'s group on `axis`, in rank
        order (a new tensor)."""
        parts = self.exchange(coord, axis, t)
        out = parts[0].clone() if len(parts) == 1 else parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def model_collectives(self, coord):
        """(reduce, gather) over `model` for the rank at `coord`: the
        sum of the ranks' tensors in rank order, their concatenation."""
        import torch

        def reduce(t):
            return self.sum(coord, "model", t)

        def gather(t, dim):
            return torch.cat(self.exchange(coord, "model", t), dim)
        return reduce, gather

    def collectives(self, coord, device):
        """The meshed train step's collectives (`launch.mesh.
        Collectives`) of the rank at `coord`, over the threads: `sum`
        over an axis, `enter` the identity whose backward sums the
        gradient over `model`, `reduce` the sum whose backward passes
        the gradient through, `gather` whose backward keeps the rank's
        slice, `gather_data` whose backward reduce-scatters over `data`.
        Each backward exchanges with the peers' backward, so each rank
        runs its backward on its own thread
        (`torch.autograd.set_multithreading_enabled(False)`)."""
        import torch
        from repro_torch.launch.mesh import Collectives
        mesh = self

        class Enter(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return mesh.sum(coord, "model", g)

        class Sum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return mesh.sum(coord, "model", x)

            @staticmethod
            def backward(ctx, g):
                return g

        class Gather(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, axis, dim):
                ctx.axis, ctx.dim, ctx.size = axis, dim, x.shape[dim]
                return torch.cat(mesh.exchange(coord, axis, x), dim)

            @staticmethod
            def backward(ctx, g):
                if ctx.axis == "data":
                    g = mesh.sum(coord, "data", g)
                return g.narrow(ctx.dim, coord[ctx.axis] * ctx.size,
                                ctx.size).contiguous(), None, None

        return Collectives(
            coord=dict(coord), device=device,
            sum=lambda t, axis: self.sum(coord, axis, t),
            enter=Enter.apply, reduce=Sum.apply,
            gather=lambda t, dim: Gather.apply(t, "model", dim),
            gather_data=lambda t, dim: Gather.apply(t, "data", dim))

    def serve_tp(self, cfg, coord, geo):
        """The serving `TensorParallel` of the rank at `coord` over the
        whole model's `cfg` for a cache of `geo`'s tiers (the engine's
        `_bind_mesh`, `TensorParallel.serving`): its serve-mode blocks on
        `model`, its block of the pools' slots under the `pages` rule,
        the exchange its `reduce`."""
        from repro_torch.launch.mesh import AbstractMesh
        from repro_torch.models.transformer import TensorParallel
        reduce, gather = self.model_collectives(coord)
        mesh = AbstractMesh(("data", "model"), (self.sizes["data"],
                                                self.sizes["model"]))
        return TensorParallel.serving(cfg, mesh, coord, reduce=reduce,
                                      gather=gather, geo=geo)

    def run(self, fn):
        """{(data, model): fn(coord)} with every rank in a thread; the
        first error of a rank is raised (its peers' waits abort)."""
        import threading
        out, errors = {}, []

        def rank(coord):
            try:
                out[(coord["data"], coord["model"])] = fn(coord)
            except BaseException as e:      # noqa: BLE001 - re-raised
                errors.append(e)
                for b in self._barriers.values():
                    b.abort()
        threads = [threading.Thread(target=rank, args=(
            {"data": d, "model": r},)) for d in range(self.sizes["data"])
            for r in range(self.sizes["model"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


#: phase 16b's splits of one layer of each family: (data, model), and
#: those a family's cases add: a model axis that divides neither
#: zamba2's 32 heads (its Mamba2 block runs whole on every model rank,
#: `w_in` and the conv gathered; its site's heads whole) nor xlstm's 4
#: (both blocks whole, the mLSTM's inner width, which the rules still
#: cut at 8, gathered)
FAMILY_TRAIN_SPLITS = ((1, 2), (2, 2), (1, 4))
FAMILY_MORE_SPLITS = {"hybrid": ((1, 3),), "xlstm": ((1, 8),)}
#: each rank's gradients against its block of the unsplit layer's, by
#: the layer's dtype: max |split - unsplit| over max |unsplit| of dx and
#: of every weight's gradient; set at about twice the largest seen on an
#: H100 when the ranks' gradients were assembled (bf16: whisper's decoder
#: `ln2/w` 1.62e-2 at (2, 2)); with each rank's dx held alone the
#: largest is whisper's frames, 1.951e-2 at (1, 2) and (2, 2); f32, the
#: sLSTM block: `bi` 3.4e-5 against the floor below, every other leaf
#: under 1.5e-6
FAMILY_TRAIN_SPLIT_TOL = {"bf16": 3e-2, "f32": 7e-5}
#: the least max |unsplit| an error is taken relative to, as a share of
#: the layer's largest gradient: the sLSTM's input gate bias `bi` has a
#: gradient that is zero in exact arithmetic (rounding noise on both
#: sides), as tests/test_torch_train.py's floor says
FAMILY_SPLIT_FLOOR = 1e-3


def family_split_cases(seed, device, get, rows, seq):
    """(label, whole config, block(params, cfg, tp, inputs) -> output,
    inputs {name: [rows, ...] tensor}, names of the inputs to
    differentiate, (data, model) splits) of each layer phase 16b
    splits, over `seq` tokens (the vlm: its patches, then `seq`
    tokens): `get(name)` gives the config to cut."""
    import dataclasses
    import torch
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.model import Model
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 13)

    def h(cfg, S):
        return torch.randn((rows, S, cfg.d_model), generator=gen,
                           device=device).to(cfg.dtype)

    def encdec_layers(p, cfg, tp, x):
        return Model(cfg, tp=tp).forward_hidden(
            p, x["tokens"], extra={"frame_embeds": x["frames"]}, remat=False)

    def mamba_block(p, cfg, tp, x):
        lp = tfm.layers_of(p["mamba"])[0]
        return x["h"] + ssm_mod.mamba2_forward_layer(x["h"], lp, cfg, False,
                                                     tp)

    def site(p, cfg, tp, x):
        pos = torch.arange(x["h"].shape[1], device=device)[None, :]
        y, _ = tfm.full_attn_block(x["h"], p["shared_attn"], cfg, pos, tp,
                                   "shared_attn")
        return tfm.dense_mlp_block(y, p["shared_attn"], cfg, tp,
                                   "shared_attn")

    def mlstm_block(p, cfg, tp, x):
        lp = tfm.layers_of(p["mlstm"])[0]
        return x["h"] + xlstm_mod.mlstm_forward_layer(x["h"], lp, cfg, tp)

    def slstm_block(p, cfg, tp, x):
        lp = tfm.layers_of(p["slstm"])[0]
        return x["h"] + xlstm_mod.slstm_forward_layer(x["h"], lp, cfg, tp)

    vlm = dataclasses.replace(get("internvl2-2b"), num_layers=1)
    whisper = get("whisper-tiny")
    whisper = dataclasses.replace(whisper, num_layers=1,
                                  encdec=dataclasses.replace(
                                      whisper.encdec, enc_layers=1))
    zamba = get("zamba2-1.2b")
    zamba = dataclasses.replace(zamba, num_layers=1, ssm=dataclasses.replace(
        zamba.ssm, attn_every=1))
    xl = get("xlstm-125m")
    xl = dataclasses.replace(xl, num_layers=2, xlstm=dataclasses.replace(
        xl.xlstm, slstm_every=2))
    # the sLSTM's weights take their gradient as `seq` per-step
    # products summed in the weights' dtype: in bf16 two orders of that
    # sum (8 rows a step, or 4 on each of two data ranks) differ by ~7e-2
    # of its largest value, which swamps what a split changes
    f32_xl = dataclasses.replace(xl, dtype=torch.float32,
                                 param_dtype=torch.float32)
    n_vlm = vlm.frontend.num_embeddings + seq
    tokens = torch.randint(0, whisper.vocab, (rows, seq),
                           generator=gen, device=device)
    frames = torch.randn((rows, whisper.frontend.num_embeddings,
                          whisper.d_model), generator=gen,
                         device=device).to(whisper.dtype)
    cases = [
        (f"{vlm.name} decoder layer", vlm, decoder_layer,
         {"h": h(vlm, n_vlm)}, ("h",)),
        (f"{whisper.name} encoder + decoder layer", whisper, encdec_layers,
         {"tokens": tokens, "frames": frames}, ("frames",)),
        (f"{zamba.name} Mamba2 block", zamba, mamba_block,
         {"h": h(zamba, seq)}, ("h",)),
        (f"{zamba.name} shared attention site", zamba, site,
         {"h": h(zamba, seq)}, ("h",)),
        (f"{xl.name} mLSTM block", xl, mlstm_block, {"h": h(xl, seq)},
         ("h",)),
        (f"{xl.name} sLSTM block (f32)", f32_xl, slstm_block,
         {"h": h(f32_xl, seq)}, ("h",)),
    ]
    return [case + (FAMILY_TRAIN_SPLITS + FAMILY_MORE_SPLITS.get(
        case[1].family, ()),) for case in cases]


def decoder_layer(p, cfg, tp, x):
    """One decoder layer of a dense, vlm or moe model on inputs {"h"}:
    its attention block, then its MLP or moe block."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    lp = tfm.layers_of(p["layers"])[0]
    pos = torch.arange(x["h"].shape[1], device=x["h"].device)[None, :]
    y, _ = tfm.full_attn_block(x["h"], lp, cfg, pos, tp)
    if cfg.moe is not None:
        return moe_mod.moe_block(y, lp, cfg, tp=tp)
    return tfm.dense_mlp_block(y, lp, cfg, tp)


def head_split(cfg, m) -> str:
    """How a `model` axis of `m` splits `cfg`'s attention heads (the
    three shapes of `transformer.TensorParallel`), in words."""
    from repro_torch.models.transformer import TensorParallel
    tp = TensorParallel.of(cfg, m, 0, reduce=None, gather=None)
    if tp.kv_split:
        return "heads and KV heads split"
    if tp.heads is not None:
        return f"query heads {tp.heads} of rank 0 over every KV head"
    return "heads whole on every rank"


def split_check(what, label, cfg, block, inputs, diff, splits, seed, device,
                tol, floor=0.0):
    """The layer `block` of `cfg` (random weights from `seed`) forward AND
    backward on `inputs` (the rows split over `data`), whole and then
    split over each (data, model) of `splits`, the ranks as threads of
    this process (`ThreadMesh`), each bound as the meshed train step
    binds it (`TrainMesh.bind` over the threads' collectives: the port's
    rank-local blocks on their train-mode shards, every enter, sum and
    gather with its backward across the threads) and taking its own
    backward on its own thread: each rank's dx of the inputs named in
    `diff` (its rows) and its gradient of every weight (summed over
    `data` where that axis leaves the leaf whole, `TrainMesh.
    reduce_grads`) against its block of the unsplit layer's, as max
    |diff| over max |unsplit| (at least `floor` of the layer's largest
    gradient), the worst rank, within `tol`. Logs a `<what> <label>
    data=.. model=..` line a split; returns (the split ranks' launches
    by kernel, the unsplit layer's left out; their errors)."""
    import torch
    from repro_torch import bridge
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shardings import shard
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import TrainMesh
    from repro_torch.tree import leaves_with_path, path_name, tree_map
    params = Model(cfg).init(seed, device=device)
    rows = next(iter(inputs.values())).shape[0]

    def leaves(tree):
        return tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        tree)

    def fresh(lo, hi):
        return {k: v[lo:hi].detach().clone().requires_grad_(k in diff)
                for k, v in inputs.items()}
    whole = leaves(params)
    xs = fresh(0, rows)
    y = block(whole, cfg, None, xs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 17)
    dy = torch.randn(y.shape, generator=gen, device=device).to(y.dtype)
    torch.autograd.backward(y, dy)
    want_dx = {f"d{k}": xs[k].grad for k in diff}
    want = {path_name(p): t.grad for p, t in leaves_with_path(whole)
            if t.grad is not None}
    floor = floor * max(float(g.float().abs().max())
                        for g in [*want_dx.values(), *want.values()])
    del y, xs, whole
    out, launched = [], collections.Counter()
    for data, m in splits:
        mesh = AbstractMesh(("data", "model"), (data, m))
        specs = bridge.param_specs(cfg, mesh, "train")
        per = rows // data
        tm = ThreadMesh(data, m)

        def rank(c):
            """The rank's dx and weight gradients, by name."""
            ranked = TrainMesh.bind(Model(cfg), mesh,
                                    tm.collectives(c, device))
            run = ranked.model_for(rows)
            mine = leaves(bridge.shard_params(params, cfg, mesh, c,
                                              "train"))
            lo = c["data"] * per
            xs = fresh(lo, lo + per)
            with torch.autograd.set_multithreading_enabled(False):
                torch.autograd.backward(block(mine, run.cfg, run.tp, xs),
                                        dy[lo:lo + per])
            grads = ranked.reduce_grads(tree_map(
                lambda t: torch.zeros_like(t) if t.grad is None
                else t.grad, mine))
            got = {f"d{k}": xs[k].grad for k in diff}
            got.update((path_name(p), g) for p, g in leaves_with_path(grads))
            return got
        before = collections.Counter(COUNTS)
        ranks = tm.run(rank)
        launched.update(collections.Counter(COUNTS) - before)
        err = dict.fromkeys([*want_dx, *want], 0.0)
        for (d, r), got in ranks.items():
            coord = {"data": d, "model": r}
            for k in err:
                w = want_dx[k][d * per:(d + 1) * per] if k in want_dx \
                    else shard(want[k], specs[k], mesh, coord)
                big = want_dx[k] if k in want_dx else want[k]
                err[k] = max(err[k], float(
                    (got[k].float() - w.float()).abs().max()
                    / max(float(big.float().abs().max()), floor)))
        worst = max(err, key=err.get)
        local = cfg.rank_local(m)
        log(f"{what} {label} data={data} model={m}: "
            f"{local.num_heads}/{local.kv_heads} heads a model rank's "
            f"config ({head_split(cfg, m)}), "
            f"{per} rows a data rank; each rank's gradients against its "
            f"block of the unsplit layer's (max |diff| / max |value|, "
            f"the worst rank): "
            f"{', '.join(f'{k} {e:.3e}' for k, e in err.items())} "
            f"(tolerance {tol})")
        if not err[worst] <= tol:
            raise AssertionError(f"{what} {label} data={data} model={m}: "
                                 f"{worst} {err[worst]:.3e}")
        out.append({"layer": label, "data": data, "model": m,
                    "errors": err})
        del ranks
    del params, want, want_dx
    return dict(launched), out


def family_train_split_phase(seed, device="cuda", get=None, rows=TRAIN_B,
                             seq=TRAIN_S):
    """Phase 16b: one full-width layer's blocks of each family phase 16a
    trains (`family_split_cases`: internvl2-2b's decoder layer over 256
    patches + 512 tokens, whisper-tiny's encoder layer and decoder
    layer with its cross-attention over 1500 frames, zamba2-1.2b's
    Mamba2 block and its shared attention site, xlstm-125m's mLSTM and
    sLSTM blocks; random bf16 weights and inputs from `seed`), forward
    AND backward on `rows` x `seq`, split over each (data, model) of
    FAMILY_TRAIN_SPLITS and the family's FAMILY_MORE_SPLITS (whisper's
    6 heads whole at model = 4, zamba2's blocks at 3, xlstm's at 8),
    `split_check`'s threads against the unsplit layer within
    FAMILY_TRAIN_SPLIT_TOL. The flash kernel and its backward run at
    each rank's heads and rows (`family_train_split`); phases 2b and 2d
    hold them at those shapes against their plain versions. `device`,
    `get` (the configs by name; default the published ones), `rows`,
    `seq`: tests/test_torch_mesh_families.py runs the phase on the CPU
    at the f32 smoke configs. Returns the split ranks' launches by
    kernel and the errors."""
    import torch
    from repro_torch import configs
    device = torch.device(device)
    if device.type == "cuda":
        free_card()
    counts, out = collections.Counter(), []
    for label, cfg, block, inputs, diff, splits in family_split_cases(
            seed, device, get or configs.get, rows, seq):
        tol = FAMILY_TRAIN_SPLIT_TOL[
            {torch.bfloat16: "bf16"}.get(cfg.dtype, "f32")]
        launched, errors = split_check(
            "family train split", label, cfg, block, inputs, diff, splits,
            seed, device, tol, FAMILY_SPLIT_FLOOR)
        counts.update(launched)
        out += errors
    counts = dict(counts)
    log(f"family train split: launches {counts}")
    if device.type == "cuda":
        free_card()
        if not counts.get("flash_attention") or \
                not counts.get("flash_attention_bwd"):
            raise AssertionError(f"family train split: launches {counts}")
    return counts, out


# --------------------------------------------------------------------------
# phase 19: training across a model axis that does not divide the KV heads
# --------------------------------------------------------------------------

#: phase 19a's layers and splits: internlm2-1.8b and qwen3-32b at 16
#: model ranks (one query head, four, over one whole KV head a rank:
#: `wk`/`wv` whole on every rank) and granite-moe-3b-a800m at 16 (24
#: heads whole on every rank, 3 of its 48 padded experts a rank)
KV_SPLIT_ARCHS = ("internlm2-1.8b", "qwen3-32b", "granite-moe-3b-a800m")
KV_SPLITS = ((1, 16),)
#: its gradients against the unsplit layer's (bf16): max |split -
#: unsplit| over max |unsplit| of dx and of every weight's gradient,
#: about twice the largest seen on an H100 (internlm2's dx 1.449e-2: 16
#: ranks' bf16 partials summed after the attention and the MLP)
KV_SPLIT_TOL = 3e-2


def kv_train_split_phase(seed, device="cuda", get=None, rows=TRAIN_B,
                         seq=TRAIN_S, splits=KV_SPLITS):
    """Phase 19a: one full-width decoder layer (attention, then MLP or
    moe block) of each of KV_SPLIT_ARCHS, random bf16 weights and input
    from `seed`, forward AND backward on `rows` x `seq`, split over each
    (data, model) of `splits` (`split_check`'s threads: every rank runs
    the port's rank-local layer; under a model axis that splits the
    query heads over whole KV heads each rank's `wk`/`wv` copy takes the
    gradient its heads give, which the step sums over `model`): dx and
    every weight's gradient against the unsplit layer's within
    KV_SPLIT_TOL. The flash kernel and its backward run at each rank's
    heads (internlm2: 1 over 1 KV head; qwen3-32b: 4 over 1;
    granite-moe: 24 over 8); phases 2b and 2d hold the first at that
    shape against their plain versions. `device`, `get`, `rows`,
    `seq`, `splits`: tests/test_torch_mesh_kv_train.py runs the phase on
    the CPU at the f32 smoke configs. Returns the split ranks' launches
    by kernel and the errors."""
    import dataclasses
    import torch
    from repro_torch import configs
    device = torch.device(device)
    get = get or configs.get
    if device.type == "cuda":
        free_card()
    counts, out = collections.Counter(), []
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 19)
    for name in KV_SPLIT_ARCHS:
        cfg = dataclasses.replace(get(name), num_layers=1)
        h = torch.randn((rows, seq, cfg.d_model), generator=gen,
                        device=device).to(cfg.dtype)
        launched, errors = split_check(
            "kv train split", f"{cfg.name} layer", cfg, decoder_layer,
            {"h": h}, ("h",), splits, seed, device, KV_SPLIT_TOL,
            FAMILY_SPLIT_FLOOR)
        counts.update(launched)
        out += errors
        del h
        if device.type == "cuda":
            free_card()
    counts = dict(counts)
    log(f"kv train split: launches {counts}")
    if device.type == "cuda" and (not counts.get("flash_attention") or
                                  not counts.get("flash_attention_bwd")):
        raise AssertionError(f"kv train split: launches {counts}")
    return counts, out


#: phase 19b: internlm2-1.8b at full width, its depth cut to
#: KV_STEP_LAYERS of 24 layers (16 ranks' threads hold their shards, the
#: whole `wk`/`wv` on each, and the unmeshed state beside them), in f32
#: so that the split is compared with the unsplit step at f32's
#: precision, KV_STEP_STEPS steps at lr KV_STEP_LR over (1, 16)
KV_STEP_LAYERS, KV_STEP_STEPS, KV_STEP_LR, KV_STEP_MODEL = 4, 2, 1e-3, 16
#: the positions a step unembeds at a time (`make_train_step`'s
#: `logit_chunk`, meshed and unmeshed alike): 16 ranks' gathered logits
#: live at once, [B, chunk, V] f32 each
KV_STEP_CHUNK = 128
#: phase 19b's steps against the unmeshed steps (f32): loss and grad
#: norm relative (tests/test_torch_train.py's); AdamW's m, the gradient's
#: average, per leaf as max |diff| over max |value|; the parameters'
#: update over the steps as the L2 norm of its difference over its own
#: (AdamW's first update is g / |g| per element, so an element whose
#: gradient is f32 noise flips a whole step either way: the largest
#: parameter difference is logged, not held). m: about twice the
#: largest seen on an H100 (1.15e-4: the second step's gradient, at a
#: grad norm of 67, is taken at parameters that such flips moved by up
#: to 5.5e-4)
KV_STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "m": 2.5e-4,
               "update": 1e-3}


def kv_train_step_phase(seed, device="cuda", get=None, rows=TRAIN_B,
                        seq=TRAIN_S, layers=KV_STEP_LAYERS,
                        model=KV_STEP_MODEL):
    """Phase 19b: KV_STEP_STEPS train steps of internlm2-1.8b at full
    width and `layers` layers in f32 (random weights from `seed`, `rows`
    x `seq` tokens from `SyntheticCorpus`), unmeshed (`make_train_step`)
    and over (1, `model`) with the ranks as threads: each rank calls the
    meshed `make_train_step(..., mesh=, comm=)` on its train-mode shards,
    its collectives the threads' (`ThreadMesh.collectives`: each with
    its backward across threads; each rank's backward runs on its own
    thread). At 16 ranks the 16 query heads split one a
    rank over the 8 whole KV heads, the MLP and the vocabulary split;
    every rank's losses and grad norms and the whole parameters and m
    after the steps (the ranks' blocks joined) against the unmeshed
    steps' within KV_STEP_TOL. Returns the launches by kernel of the
    meshed steps and the numbers."""
    import dataclasses
    import torch
    from repro_torch import bridge, configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.shardings import spec_axes
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState, make_train_step
    from repro_torch.tree import leaves_with_path, path_name, tree_map
    device = torch.device(device)
    get = get or configs.get
    if device.type == "cuda":
        free_card()
    cfg = dataclasses.replace(get("internlm2-1.8b"), num_layers=layers,
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    whole = Model(cfg)
    params = whole.init(seed, device=device)
    if device.type == "cuda":
        batches = train_batches(cfg.vocab, seed, KV_STEP_STEPS, rows, seq)
    else:
        gen = torch.Generator().manual_seed(seed)
        batches = [torch.randint(0, cfg.vocab, (rows, seq + 1), generator=gen)
                   for _ in range(KV_STEP_STEPS)]

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t = time.time()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out, time.time() - t

    # the unmeshed steps
    state = TrainState(params=tree_map(torch.clone, params),
                       opt=adamw_init(params))
    step_fn = make_train_step(whole, lr=KV_STEP_LR, logit_chunk=KV_STEP_CHUNK,
                              donate=True)
    plain = {"losses": [], "grad_norms": [], "step_s": []}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for tokens in batches:
        (state, m), dt = timed(lambda: step_fn(state, {"tokens": tokens}))
        plain["losses"].append(float(m["loss"]))
        plain["grad_norms"].append(float(m["grad_norm"]))
        plain["step_s"].append(dt)
    plain["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if device.type == "cuda" else 0
    want = {"params": {path_name(p): t for p, t in
                       leaves_with_path(state.params)},
            "m": {path_name(p): t for p, t in leaves_with_path(state.opt.m)}}
    del state
    if device.type == "cuda":
        free_card()

    # the same steps over (1, model), a thread a rank
    mesh = AbstractMesh(("data", "model"), (1, model))
    specs = bridge.param_specs(cfg, mesh, "train")
    local = cfg.rank_local(model)
    shards = {r: tree_map(torch.clone, bridge.shard_params(
        params, cfg, mesh, {"data": 0, "model": r}, "train"))
        for r in range(model)}
    del params
    tm = ThreadMesh(1, model)

    def rank(c):
        mine = shards.pop(c["model"])
        state = TrainState(params=mine, opt=adamw_init(mine))
        step = make_train_step(whole, lr=KV_STEP_LR, mesh=mesh,
                               comm=tm.collectives(c, device),
                               logit_chunk=KV_STEP_CHUNK, donate=True)
        losses, gnorms = [], []
        with torch.autograd.set_multithreading_enabled(False):
            for tokens in batches:
                state, metrics = step(state, {"tokens": tokens})
                losses.append(float(metrics["loss"]))
                gnorms.append(float(metrics["grad_norm"]))
        return {"losses": losses, "grad_norms": gnorms,
                "params": {path_name(p): t for p, t in
                           leaves_with_path(state.params)},
                "m": {path_name(p): t for p, t in
                      leaves_with_path(state.opt.m)}}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()                          # the meshed steps' launches
    ranks, dt = timed(lambda: tm.run(rank))
    counts = dict(COUNTS)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0

    def joined(key, name):
        """A leaf of every rank's `key` tree, whole: the ranks' blocks
        concatenated where `model` splits it, else rank 0's (every rank
        holds the same whole leaf; checked)."""
        spec = specs[name]
        parts = [ranks[(0, r)][key][name] for r in range(model)]
        if "model" in spec_axes(spec):
            return torch.cat(parts, list(spec).index("model"))
        if not all(torch.equal(parts[0], p) for p in parts[1:]):
            raise AssertionError(f"kv train step: the ranks' copies of "
                                 f"{key} {name} differ")
        return parts[0]
    got = {key: {name: joined(key, name) for name in specs}
           for key in ("params", "m")}
    start = {path_name(p): t for p, t in leaves_with_path(
        whole.init(seed, device=device))}
    err = {"loss": max(abs(a - b) / abs(b) for res in ranks.values()
                       for a, b in zip(res["losses"], plain["losses"])),
           "grad_norm": max(abs(a - b) / abs(b) for res in ranks.values()
                            for a, b in zip(res["grad_norms"],
                                            plain["grad_norms"])),
           "m": max(float((got["m"][k] - want["m"][k]).abs().max()
                          / max(float(want["m"][k].abs().max()), 1e-30))
                    for k in specs),
           "update": float(torch.sqrt(sum(
               (got["params"][k] - want["params"][k]).double().square().sum()
               for k in specs) / sum(
               (want["params"][k] - start[k]).double().square().sum()
               for k in specs)))}
    max_param = max(float((got["params"][k] - want["params"][k]).abs().max())
                    for k in specs)
    n = sum(t.numel() for t in start.values())
    r0 = ranks[(0, 0)]
    unfused = beside_unfused("kv train step", plain["step_s"][-1],
                             plain["peak_bytes"])
    log(f"kv train step: {cfg.name} at full width, {layers} of "
        f"{get('internlm2-1.8b').num_layers} layers (depth cut), f32, "
        f"{n / 1e9:.3f} B params, B={rows} S={seq}, lr {KV_STEP_LR}: "
        f"unmeshed losses {plain['losses']} grad norms "
        f"{plain['grad_norms']}; data=1 model={model} as threads "
        f"({local.num_heads}/{local.kv_heads} heads a rank's config, "
        f"{head_split(cfg, model)}): "
        f"rank 0 losses {r0['losses']} grad norms {r0['grad_norms']}; "
        f"errors {', '.join(f'{k} {v:.3e}' for k, v in err.items())} "
        f"(tolerance {KV_STEP_TOL}), largest parameter |diff| "
        f"{max_param:.3e}; {dt:.1f} s for the threaded steps, peak memory "
        f"{peak / 1e9:.2f} GB; unmeshed "
        f"{[round(x * 1e3, 1) for x in plain['step_s']]} ms a step, peak "
        f"memory {plain['peak_bytes'] / 1e9:.2f} GB {unfused}, launches "
        f"{counts}")
    bad = {k: v for k, v in err.items() if not v <= KV_STEP_TOL[k]}
    if bad:
        raise AssertionError(f"kv train step: the threaded steps differ "
                             f"from the unmeshed ones: {bad}")
    if device.type == "cuda":
        calls = layers * KV_STEP_STEPS * model
        if counts.get("flash_attention") != 2 * calls or \
                counts.get("flash_attention_bwd") != calls or \
                not fused_update(counts, KV_STEP_STEPS * model):
            raise AssertionError(f"kv train step: launches {counts}, "
                                 f"expected flash {2 * calls}, its "
                                 f"backward {calls} and the AdamW kernels "
                                 f"{KV_STEP_STEPS * model} each")
        free_card()
    return counts, {"plain": plain, "errors": err, "threads_s": dt,
                    "peak_bytes": peak, "max_param_diff": max_param,
                    "losses": r0["losses"], "grad_norms": r0["grad_norms"]}


# --------------------------------------------------------------------------
# phase 17: the single-stream path of a meshed engine
# --------------------------------------------------------------------------

#: phase 17a's stream: lanes, teacher-forced `run` steps, `generate`
#: steps (at telemetry_stride 16: 2 and 4 chunks)
MESH_STREAM_B, MESH_STREAM_RUN, MESH_STREAM_GEN = 4, 32, 64
#: phase 17a's configs and prompt tokens
MESH_STREAMS = (("internlm2-1.8b", 2304), ("granite-moe-3b-a800m", 1024))


def mesh_stream_drive(eng, prompts, fed):
    """`start(prompts)`, `run` teacher-forced over its greedy token and
    then `fed` [MESH_STREAM_RUN - 1, B], `generate(MESH_STREAM_GEN)` from
    run's last greedy token (its chunks captured on a new engine), then
    `generate(MESH_STREAM_GEN)` again from its last token (replayed).
    Returns (the outputs and StepStats bytes, {"start_s", "generate_s",
    "again_s"}, the launches by kernel of the first three calls)."""
    import torch
    from repro_torch.kernels.build import COUNTS
    COUNTS.clear()                      # the main path's run only
    torch.cuda.synchronize()
    t0 = time.time()
    logits = eng.start(prompts)
    torch.cuda.synchronize()
    t_start = time.time() - t0
    run = eng.run(torch.cat([logits.argmax(-1).to(torch.int32)[None], fed]))
    torch.cuda.synchronize()
    t0 = time.time()
    tokens = eng.generate(run[-1].argmax(-1).to(torch.int32),
                          MESH_STREAM_GEN)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    counts = dict(COUNTS)
    t0 = time.time()
    again = eng.generate(tokens[-1], MESH_STREAM_GEN)
    torch.cuda.synchronize()
    t_again = time.time() - t0
    out = {"start": logits, "run": run, "tokens": tokens, "again": again,
           "bytes": [(s.h_read, s.e_read, s.m_in, s.m_out)
                     for s in eng.stats]}
    return out, {"start_s": t_start, "generate_s": t_gen,
                 "again_s": t_again}, counts


def mesh_stream_phase(model, params, seed, prompt_len):
    """Phase 17a: the single-stream path of a meshed engine at world size
    1. `start` of MESH_STREAM_B prompts of `prompt_len` tokens, `run` of
    MESH_STREAM_RUN teacher-forced tokens and `generate(MESH_STREAM_GEN)`
    at telemetry_stride 16, then `generate` again (replayed), on an
    unmeshed engine, which is then freed, and the same on a new
    `ServingEngine(..., mesh=)` over a world-size-1 NCCL group
    (`world_of_one`), on the same weights: the meshed stream's lanes,
    rank-local model and collectives (each an identity at size 1) inside
    its captured chunks. Start logits, run logits, generated tokens and
    every StepStats row's bytes must be bitwise equal; flash once per
    layer at `start`, the paged kernel twice per layer per decode step
    (of `start`, `run` and the first `generate`). Returns the meshed
    run's launches by kernel and the numbers."""
    import torch
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = model.cfg
    L, B = cfg.num_layers, MESH_STREAM_B
    rng = np.random.default_rng(seed + 17)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, prompt_len)),
                              dtype=torch.int32, device="cuda")
    fed = torch.as_tensor(rng.integers(0, cfg.vocab,
                                       (MESH_STREAM_RUN - 1, B)),
                          dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(max_context=4096, hbm_fraction=0.25,
                        policy="importance", telemetry_stride=16)
    eng = ServingEngine(model, params, ecfg)
    want, t_want, _ = mesh_stream_drive(eng, prompts, fed)
    captures_want = sum(eng.captures.values())
    del eng
    free_card()
    with world_of_one("chip_smoke_stream_") as mesh:
        eng = ServingEngine(model, params, ecfg, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        got, t_got, counts = mesh_stream_drive(eng, prompts, fed)
        captures = dict(eng.captures)
        peak = torch.cuda.max_memory_allocated()
        del eng
        free_card()
    same = {k: torch.equal(got[k], want[k])
            for k in ("start", "run", "tokens", "again")}
    same["bytes"] = got["bytes"] == want["bytes"]
    steps = MESH_STREAM_RUN + MESH_STREAM_GEN
    launches = (counts.get("flash_attention", 0),
                counts.get("paged_attention", 0))
    rate = {(k, g): B * MESH_STREAM_GEN / t[f"{g}_s"]
            for k, t in (("meshed", t_got), ("unmeshed", t_want))
            for g in ("generate", "again")}
    log(f"mesh stream {cfg.name}: B={B} S={prompt_len}, start "
        f"{t_got['start_s']:.3f} s (unmeshed {t_want['start_s']:.3f}), "
        f"generate({MESH_STREAM_GEN}) {rate['meshed', 'generate']:.1f} "
        f"tokens/s with its captures (unmeshed "
        f"{rate['unmeshed', 'generate']:.1f}), again "
        f"{rate['meshed', 'again']:.1f} replayed (unmeshed "
        f"{rate['unmeshed', 'again']:.1f}); data=1 model=1 over NCCL; "
        f"bitwise equal to the unmeshed stream: start logits "
        f"{same['start']} run logits {same['run']} tokens {same['tokens']} "
        f"again {same['again']} step bytes {same['bytes']}; captures "
        f"{sum(captures.values())} "
        f"(unmeshed {captures_want}): "
        f"{', '.join(graph_label(k) for k in captures)}; launches flash "
        f"{launches[0]} paged {launches[1]} row copies "
        f"{counts.get('page_copy', 0)}; peak memory {peak / 1e9:.2f} GB; "
        f"card {card_line()}")
    if not all(same.values()):
        raise AssertionError(f"mesh stream {cfg.name} differs from the "
                             f"unmeshed stream: {same}")
    if launches != (L, 2 * L * steps):
        raise AssertionError(f"mesh stream {cfg.name}: (flash, paged) "
                             f"launches {launches}, expected "
                             f"{(L, 2 * L * steps)}")
    return counts, {"start_s": t_got["start_s"],
                    "unmeshed_start_s": t_want["start_s"],
                    "tokens_per_s": rate["meshed", "generate"],
                    "unmeshed_tokens_per_s": rate["unmeshed", "generate"],
                    "again_tokens_per_s": rate["meshed", "again"],
                    "unmeshed_again_tokens_per_s": rate["unmeshed", "again"],
                    "captures": sum(captures.values()),
                    "unmeshed_captures": captures_want}


#: phase 17b's layers: (config, model axis sizes), B=4 x S=2304
PREFILL_SPLITS = (("internlm2-1.8b", (2, 4)), ("llama31-8b", (2, 4)))
#: a split prefill layer against the unsplit one (bf16): max |split -
#: unsplit| over max |unsplit| of the attention block's and the MLP's
#: outputs, the ranks' partial outputs summed in bf16 in rank order;
#: about twice the largest seen on an H100 (attention 7.6e-3, MLP
#: 7.5e-3, llama31-8b at model = 4)
PREFILL_SPLIT_TOL = {"attn": 1.5e-2, "mlp": 1.5e-2}


def prefill_layer(lp, cfg, h, positions, geo):
    """One layer's whole-prompt prefill under `cfg` (a rank-local one on
    a rank's shard): attention (the flash kernel on the card) and its
    K/V written to a fresh cache of `geo`, then the function giving the
    MLP's output. Returns (q, k, v, attention out [B, S, H, HD],
    attention output [B, S, d], the cache, mlp(h2) -> [B, S, d])."""
    from repro_torch.kvcache.paged import prefill_cache
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import attention, rms_norm, swiglu
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = tfm.attn_qkv(x, lp, cfg, positions)
    o = attention(q, k, v)
    cache = prefill_cache(geo, k[None], v[None], h.shape[1])

    def mlp(h2):
        return swiglu(rms_norm(h2, lp["mlp_norm"], cfg.norm_eps),
                      lp["w_gate"], lp["w_up"], lp["w_down"])
    return q, k, v, o, tfm.attn_out(o, lp), cache, mlp


def prefill_split_phase(seed):
    """Phase 17b: the tensor-parallel split of one full-width layer's
    whole-prompt prefill (B=4, S=2304, the path of a meshed engine's
    `start`) on one card, rank after rank, for each of PREFILL_SPLITS:
    each rank's shard (`bridge.shard_params`, `ModelConfig.rank_local`)
    runs the attention block (the flash kernel at the rank's heads, held
    against its plain version on the rank's q, k, v within FLASH_TOL)
    and writes its K/V into a cache of its KV heads, whose pools and
    tables must equal the unsplit layer's cache's KV-head slices; the
    ranks' partial outputs summed in bf16 in rank order (as
    `all_reduce_sum` sums them), then the MLP's likewise on the summed
    residual, within PREFILL_SPLIT_TOL of the unsplit layer's. Returns
    the launches by kernel of the split layers (`prefill_split`)."""
    import dataclasses
    import torch
    from repro_torch import bridge, configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import layers_of
    device = torch.device("cuda")
    B, S = 4, 2304
    total = collections.Counter()
    for name, sizes in PREFILL_SPLITS:
        cfg = dataclasses.replace(configs.get(name), num_layers=1)
        params = Model(cfg).init(seed, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 17)
        h = torch.randn((B, S, cfg.d_model), generator=gen, device=device,
                        dtype=torch.bfloat16)
        positions = torch.arange(S, device=device)[None]
        geo = Model(cfg).cache_geometry(B, 4096, hbm_fraction=0.25)
        _, k, v, _, attn, cache, mlp = prefill_layer(
            layers_of(params["layers"])[0], cfg, h, positions, geo)
        h2 = h + attn
        y = mlp(h2)
        for m in sizes:
            local = cfg.rank_local(m)
            kh = cfg.kv_heads // m
            lgeo = Model(local).cache_geometry(B, 4096, hbm_fraction=0.25)
            mesh = AbstractMesh(("data", "model"), (1, m))
            parts, mlps, flash_err, kv_err, kv_same = [], [], 0.0, 0.0, True
            for r in range(m):
                lp = layers_of(bridge.shard_params(
                    params, cfg, mesh, {"data": 0, "model": r})["layers"])[0]
                COUNTS.clear()
                q_r, k_r, v_r, o_r, a, c_r, f = prefill_layer(
                    lp, local, h, positions, lgeo)
                torch.cuda.synchronize()
                total.update(COUNTS)
                want = ref.flash_attention_ref(q_r, k_r, v_r, causal=True)
                flash_err = max(flash_err, float(
                    (o_r.float() - want.float()).abs().max()))
                heads = slice(r * kh, (r + 1) * kh)
                kv_same &= all(torch.equal(getattr(c_r, fld), getattr(
                    cache, fld)[..., heads, :]) for fld in (
                        "k_hbm", "v_hbm", "k_host", "v_host"))
                kv_same &= all(torch.equal(getattr(c_r, fld),
                                           getattr(cache, fld))
                               for fld in ("page_table", "hbm_owner",
                                           "host_owner", "length"))
                kv_err = max(kv_err, *(float((x.float() - w[:, :, heads]
                                              .float()).abs().max())
                                       for x, w in ((k_r, k), (v_r, v))))
                parts.append(a)
                mlps.append(f)
                del q_r, k_r, v_r, o_r, c_r, want
            summed = parts[0]
            for a in parts[1:]:
                summed = summed + a
            y_split = mlps[0](h2)
            for f in mlps[1:]:
                y_split = y_split + f(h2)
            err = {"attn": float((summed.float() - attn.float()).abs().max()
                                 / attn.float().abs().max()),
                   "mlp": float((y_split.float() - y.float()).abs().max()
                                / y.float().abs().max())}
            torch.cuda.synchronize()
            log(f"prefill split {name} model={m}: B={B} S={S} heads "
                f"{cfg.num_heads}/{cfg.kv_heads} -> {local.num_heads}/{kh} "
                f"a rank (flash H={local.num_heads}/{kh} D={cfg.head_dim} "
                f"max err against its plain version {flash_err:.3e}, "
                f"tolerance {FLASH_TOL['bf16']}); each rank's pools and "
                f"tables equal the unsplit cache's KV-head slices: "
                f"{kv_same} (its K/V against the unsplit's slices: max "
                f"|diff| {kv_err:.3e}); split against unsplit (max |diff| "
                f"/ max |value|): attention {err['attn']:.3e} mlp "
                f"{err['mlp']:.3e} (tolerance {PREFILL_SPLIT_TOL})")
            if not flash_err <= FLASH_TOL["bf16"]:
                raise AssertionError(f"prefill split {name} model={m}: "
                                     f"flash error {flash_err}")
            if not kv_same:
                raise AssertionError(f"prefill split {name} model={m}: a "
                                     f"rank's cache is not the unsplit "
                                     f"cache's KV-head slice")
            bad = {k: e for k, e in err.items()
                   if not e <= PREFILL_SPLIT_TOL[k]}
            if bad:
                raise AssertionError(f"prefill split {name} model={m}: "
                                     f"{bad}")
            del parts, mlps, summed, y_split
        del params, cache, k, v, attn, h, h2, y
        free_card()
    return dict(total)


#: phase 18a's layers split under the `pages` KV pool rule: (model,
#: model-axis size), 4 HBM + 13 host slots a rank at PAGES_GEO; 18b's
#: under the `none` rule (pools whole, heads whole: 16 over 3, the
#: vocabulary split)
PAGES_SPLITS = (("internlm2-1.8b", 16), ("qwen3-32b", 16))
NONE_SPLITS = (("internlm2-1.8b", 3),)
#: phase 4's lanes and pages a lane and layer (HBM, host)
PAGES_GEO = (8, 64, 208)
#: `start`'s lanes and prompt tokens a lane (96 pages: 32 past the HBM
#: tier; its logits at every position, whole on each of 16 ranks, bound
#: the lanes), the prefill chunk's tokens and the largest start of a
#: lane's chunk (so the ranks whose slots lie past every lane's prefix
#: give zero partials)
PAGES_START = (2, 1536)
PAGES_CHUNK, PAGES_CHUNK_START = 32, 700
#: a split layer against the unsplit one, by dtype: max |split -
#: unsplit| over max |unsplit| of the decode step's, the chunk's and
#: `start`'s logits; the decode importance absolute. About twice the
#: largest seen: bf16 on an H100 (logits 1.324e-2, internlm2's chunk:
#: the ranks' bf16 partial outputs, merged in f32, and the MLP's 16
#: partial sums in bf16; importance 7.7e-6, qwen3-32b), f32 on the CPU
#: at the smoke configs (logits 9.7e-7, importance 3.0e-8)
PAGES_SPLIT_TOL = {"bf16": {"decode": 2.7e-2, "chunk": 2.7e-2,
                            "start": 2.7e-2, "importance": 1.6e-5},
                   "f32": {"decode": 2e-6, "chunk": 2e-6, "start": 2e-6,
                           "importance": 6e-8}}


def pages_cache(geo, lengths, gen, device):
    """A whole cache of `geo` in static placement (`prefill_cache`) over
    random K/V, each lane holding `lengths[b]` tokens."""
    import torch
    from repro_torch.kvcache.paged import prefill_cache
    L, B, KH, HD = geo.num_layers, geo.batch, geo.kv_heads, geo.head_dim
    S = int(max(lengths))
    k, v = (torch.randn((L, B, S, KH, HD), generator=gen, device=device)
            .to(geo.dtype) for _ in range(2))
    return prefill_cache(geo, k, v, torch.as_tensor(
        lengths, dtype=torch.int32, device=device))


def rank_cache(cache, shard):
    """A rank's cache cut from the whole `cache`: its slots of each tier
    (`shard`, the `pages` rule; None: the whole pools), the tables whole;
    copies."""
    from repro_torch.kvcache.paged import PagedKVCache
    f = {n: getattr(cache, n).clone() for n in (
        "page_table", "hbm_owner", "host_owner", "length", "importance")}
    for n, tier in (("k_hbm", 0), ("v_hbm", 0), ("k_host", 1),
                    ("v_host", 1)):
        pool = getattr(cache, n)
        if shard is not None:
            lo, hi = (shard.hbm, shard.host)[tier]
            pool = pool[:, :, lo:hi]
        f[n] = pool.clone()
    return PagedKVCache(**f)


def same_as_slots(got, want, shard) -> bool:
    """Whether a rank's cache `got` holds bitwise the whole cache
    `want`'s pools at its slots (`shard`; None: every slot) and its
    tables."""
    import torch
    ok = all(torch.equal(getattr(got, n), getattr(want, n)) for n in (
        "page_table", "hbm_owner", "host_owner", "length"))
    for n, tier in (("k_hbm", 0), ("v_hbm", 0), ("k_host", 1),
                    ("v_host", 1)):
        pool = getattr(want, n)
        if shard is not None:
            lo, hi = (shard.hbm, shard.host)[tier]
            pool = pool[:, :, lo:hi]
        ok &= torch.equal(getattr(got, n), pool)
    return ok


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def pages_split_case(cfg, m, params, seed, device, geo_pages, start,
                     chunk, chunk_start):
    """One full-width layer of `cfg` split over a model axis of `m` as
    threads (`ThreadMesh`), each rank running the engine's rank-local
    code on its serve shards and its cache (`rank_cache`), against the
    unsplit layer: a decode step (`Model.decode_step`: the token written
    by the rank that holds its slot, the paged kernel on every rank's
    slots, the partials merged, the importance), a migration plan at the
    budget over random importance (`apply_migrations` with the rank's
    shard: rows exchanged across ranks), a chunked-prefill slice
    (`Model.prefill_chunk`) and `start`'s whole-prompt prefill
    (`Model.prefill` of `start` = (lanes, tokens): flash at the rank's
    heads). Returns (the errors,
    whether every rank's pools are bitwise the unsplit's slots and its
    tables equal, after each step, and facts for the log)."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.kvcache.migrate import apply_migrations
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import Model
    from repro_torch.serving import control
    B, Ph, Pe = geo_pages
    whole = Model(cfg)
    T = cfg.kv_page_tokens
    geo = dataclasses.replace(
        whole.cache_geometry(B, (Ph + Pe - 1) * T, hbm_fraction=0.25),
        hbm_pages=Ph, host_pages=Pe)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 18)
    rng = np.random.default_rng(seed + 18)
    mesh = ThreadMesh(1, m)
    local = cfg.rank_local(m)
    amesh = AbstractMesh(("data", "model"), (1, m))
    shards = [bridge.shard_params(params, cfg, amesh,
                                  {"data": 0, "model": r}) for r in range(m)]
    # the decode step's cache: lanes past the HBM tier, some at a page
    # boundary (a fresh page) and some inside one
    lengths = rng.integers((Ph - 8) * T, (Ph + Pe - 2) * T, B)
    lengths[: B // 2] = lengths[: B // 2] // T * T
    dec = pages_cache(geo, lengths, gen, device)
    token = torch.as_tensor(rng.integers(0, cfg.vocab, B), dtype=torch.int32,
                            device=device)
    slot = control.choose_write_slot(dec)
    imp = torch.rand(dec.importance.shape, generator=gen, device=device)
    budget = control.migration_budget(geo, 0.1)
    # the prefill chunk's cache: prefixes of up to `chunk_start` tokens
    starts = rng.integers(16, chunk_start, B)
    pre = pages_cache(geo, starts, gen, device)
    ctoks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, chunk)),
                            dtype=torch.int32, device=device)
    cstart = torch.as_tensor(starts, dtype=torch.int32, device=device)
    n_valid = torch.as_tensor(rng.integers(1, chunk + 1, B),
                              dtype=torch.int32, device=device)
    end = int((starts + chunk).max())
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, start),
                              dtype=torch.int32, device=device)
    geo_start = dataclasses.replace(geo, batch=start[0])

    def run(model, p, cache, pre_c, geo_r, shard):
        logits, after = model.decode_step(p, cache, token, write_slot=slot)
        decoded = rank_cache(after, None)       # before the migration
        plan = control.plan_migrations(dataclasses.replace(
            after, importance=imp), budget=budget, promote_thresh=0.0)[0]
        moved = apply_migrations(after, plan, shard)
        c_logits, chunked = model.prefill_chunk(p, pre_c, ctoks, cstart,
                                                n_valid, end)
        s_logits, started = model.prefill(p, prompts, geo_r)
        return {"decode": logits, "decoded": decoded, "plan": plan,
                "moved": moved, "chunk": c_logits, "chunked": chunked,
                "start": s_logits, "started": started}
    want = run(whole, params, rank_cache(dec, None), rank_cache(pre, None),
               geo_start, None)

    def rank(coord):
        tp = mesh.serve_tp(cfg, coord, geo)
        got = run(Model(local, tp=tp), shards[coord["model"]],
                  rank_cache(dec, tp.pool), rank_cache(pre, tp.pool),
                  geo_start, tp.pool)
        got["shard"], got["heads"] = tp.pool, tp.heads
        return got
    ranks = mesh.run(rank)
    err = {"decode": 0.0, "chunk": 0.0, "start": 0.0, "importance": 0.0}
    same = {"decode": True, "migration": True, "chunk": True,
            "start": True}
    for got in ranks.values():
        for k in ("decode", "chunk", "start"):
            err[k] = max(err[k], rel_err(got[k], want[k]))
        err["importance"] = max(err["importance"], float(
            (got["decoded"].importance - want["decoded"].importance)
            .abs().max()))
        for k, c in (("decode", "decoded"), ("migration", "moved"),
                     ("chunk", "chunked"), ("start", "started")):
            same[k] &= same_as_slots(got[c], want[c], got["shard"])
        same["migration"] &= all(torch.equal(getattr(got["plan"], f.name),
                                             getattr(want["plan"], f.name))
                                 for f in dataclasses.fields(want["plan"]))
    shard = ranks[(0, 0)]["shard"]
    plan = want["plan"]
    live = plan.pro_layer >= 0
    crossing = None
    if shard is not None:
        nh, ne = shard.counts
        crossing = int((live & (plan.pro_src // ne != plan.pro_dst // nh))
                       .sum())
    facts = {"rows": int(live.sum()), "crossing": crossing,
             "slots": shard.counts if shard is not None else (Ph, Pe),
             "heads": ranks[(0, 0)]["heads"],
             "zero_partials": sum(
                 1 for r in range(m) if shard is not None and
                 r * shard.counts[0] >= -(-end // T))}
    return err, same, facts


def pages_split_phase(seed, device="cuda", get=None, splits=None,
                      geo_pages=PAGES_GEO, start=PAGES_START,
                      chunk=PAGES_CHUNK, chunk_start=PAGES_CHUNK_START):
    """Phase 18: one full-width layer of each of `splits` (default
    PAGES_SPLITS, the `pages` rule, 18a, then NONE_SPLITS, the `none`
    rule, 18b) split over its model axis as threads of this process
    (`pages_split_case`; random bf16 weights from `seed`): the decode
    step's, the chunk's and `start`'s logits within PAGES_SPLIT_TOL of
    the unsplit layer's (the `none` rule's pools, tables and importance
    exact), every rank's pools bitwise the unsplit pools' slots and its
    tables equal after the decode step's write, the migration, the
    chunk's write and `start`. `device`, `get` (the configs by name),
    the geometry and sizes: tests/test_torch_mesh_pages.py runs the
    phase on the CPU at the f32 smoke configs. Returns (the launches by
    kernel of 18a and of 18b, the rows)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.models.model import Model
    device = torch.device(device)
    get = get or configs.get
    rows, launches = [], {}
    for rule, cases in splits or (("pages", PAGES_SPLITS),
                                  ("none", NONE_SPLITS)):
        COUNTS.clear()
        for name, m in cases:
            if device.type == "cuda":
                free_card()
            cfg = dataclasses.replace(get(name), num_layers=1)
            params = Model(cfg).init(seed, device=device)
            err, same, facts = pages_split_case(
                cfg, m, params, seed, device, geo_pages, start, chunk,
                chunk_start)
            if device.type == "cuda":
                torch.cuda.synchronize()
            tol = PAGES_SPLIT_TOL["f32" if cfg.dtype == torch.float32
                                  else "bf16"]
            log(f"{rule} split {cfg.name} model={m}: B={geo_pages[0]} "
                f"{geo_pages[1]} HBM + {geo_pages[2]} host pages, "
                f"{facts['slots'][0]} + {facts['slots'][1]} a rank, query "
                f"heads {facts['heads'] or 'whole'} of {cfg.num_heads} "
                f"over {cfg.kv_heads} KV heads whole; pools bitwise the "
                f"unsplit slots and tables equal after the decode write "
                f"{same['decode']}, the migration {same['migration']} "
                f"({facts['rows']} rows, {facts['crossing']} crossing "
                f"ranks), the chunk {same['chunk']} ({facts['zero_partials']}"
                f" ranks past every prefix) and start {same['start']}; "
                f"split against unsplit (max |diff| / max |logit|): decode "
                f"{err['decode']:.3e} chunk {err['chunk']:.3e} start "
                f"{err['start']:.3e}, importance {err['importance']:.3e} "
                f"absolute (tolerance {tol})")
            rows.append({"rule": rule, "model": cfg.name, "split": m,
                         "errors": err, "same": same, **facts})
            if not all(same.values()):
                raise AssertionError(f"{rule} split {cfg.name} model={m}: "
                                     f"a rank's cache is not the unsplit "
                                     f"cache's slots: {same}")
            if rule == "none" and err["importance"] != 0:
                raise AssertionError(f"none split {cfg.name}: importance "
                                     f"{err['importance']}")
            bad = {k: e for k, e in err.items() if not e <= tol[k]}
            if bad:
                raise AssertionError(f"{rule} split {cfg.name} model={m}: "
                                     f"{bad}")
            del params
        launches[rule] = dict(COUNTS)
        log(f"{rule} split: launches {dict(COUNTS)}")
    return launches, rows


# --------------------------------------------------------------------------
# phase 20: the rank-local decode and prefill of the vlm, encdec, hybrid,
# ssm and xlstm families
# --------------------------------------------------------------------------

#: phase 20's configs, the model-axis sizes each is split over (2, and
#: one that divides no head count: whisper's 6 at 4, zamba2's 32 at 3,
#: xlstm's 4 at 8), its prompt tokens a lane (internvl2: 2048 after its
#: 256 patches, phase 10's 2304 positions; whisper: phase 10's 64 over
#: its 1500 frames; xlstm: replayed one decode step a token, each step
#: of 8 threads gathering every leaf of its 12 blocks: 64 tokens took
#: 62.8 s at 8 on the card, so 16) and the dtype
#: it runs in. The recurrent configs run their random bf16 weights
#: widened to f32: with random weights their stacks amplify the ranks'
#: other order of sums with depth and time (zamba2 at its smoke widths,
#: 4 blocks: 2.7e-2 of max |logit| in bf16, 1.7e-6 in f32; 38 blocks:
#: 0.34 in bf16, 1.5e-5 in f32; on the card in bf16 at 2: zamba2 0.34,
#: xlstm 9.6e-2), so only f32 holds their split to a bound that would
#: show a fault
FAMILY_RANK_SPLITS = (("internvl2-2b", (2,), 2048, "bf16"),
                      ("whisper-tiny", (2, 4), 64, "bf16"),
                      ("zamba2-1.2b", (2, 3), 2304, "f32"),
                      ("xlstm-125m", (2, 8), 16, "f32"))
#: phase 20's lanes (phase 10's B) and greedy decode steps
FAMILY_RANK_B, FAMILY_RANK_STEPS = 4, 4
#: a rank's logits against the unsplit step's, max |diff| over max
#: |logit|, by dtype, about twice the largest seen on the card: bf16
#: internvl2's 24 layers at 2, 2.559e-2 (the ranks' bf16 partial sums);
#: f32 zamba2's 38 blocks at 2, 4.351e-5 (at the smoke widths on the
#: CPU: 1.66e-6; tests/test_torch_mesh_decode_families.py holds its own
#: bounds beside)
FAMILY_RANK_TOL = {"bf16": 5e-2, "f32": 1e-4}


def rank_state(state, tp, m: int):
    """A rank's block of the unsplit decode `state` (a `PagedKVCache`, or
    a family's dict) for the rank of `tp` on a model axis of `m`: its KV
    heads (the `kv_heads` rule) or its slots (`pages`) of each pool, the
    tables whole; the recurrent memories' heads where the axis splits
    them (`recurrent_split`), the conv states and the encoder output
    whole."""
    import dataclasses
    from repro_torch.kvcache.paged import PagedKVCache
    if isinstance(state, PagedKVCache):
        if tp.kv_split:
            kh = state.k_hbm.shape[4] // m
            pools = {n: getattr(state, n)[..., tp.rank * kh:
                                          (tp.rank + 1) * kh, :]
                     for n in ("k_hbm", "v_hbm", "k_host", "v_host")}
            return dataclasses.replace(rank_cache(state, None), **{
                n: t.clone() for n, t in pools.items()})
        return rank_cache(state, tp.pool)
    out = {}
    for k, v in state.items():
        if isinstance(v, (dict, PagedKVCache)):
            out[k] = rank_state(v, tp, m)
        elif k in ("enc", "conv", "m_conv") or not tp.recurrent_split:
            out[k] = v
        else:                               # [L, B, H, ...]: the heads
            n = v.shape[2] // m
            out[k] = v[:, :, tp.rank * n:(tp.rank + 1) * n]
    return out


def state_diff(got, want):
    """(whether every integer tensor of two decode states is equal, the
    largest |diff| over max |value| of their float tensors)."""
    import torch
    from repro_torch.tree import tree_leaves
    same, err = True, 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if g.dtype.is_floating_point:
            if w.numel():
                err = max(err, rel_err(g, w) if float(w.float().abs()
                                                      .max()) else float(
                    (g.float() - w.float()).abs().max()))
        else:
            same &= torch.equal(g, w)
    return same, err


def family_rank_case(cfg, m, params, seed, device, batch, prompt, steps):
    """`cfg` (the whole model, parameters `params`) split over a model
    axis of `m` as threads (`ThreadMesh`), each rank the rank-local
    model (`TensorParallel.serving`, the engine's binding for any
    family) on its serve shards and its own decode state: `Model.
    prefill` of `batch` prompts of `prompt` tokens (and the family's
    `extra`; ssm: none, the state from zero), then `steps` decode steps
    fed the unsplit run's greedy tokens. Returns (the unsplit run
    {"logits", "tokens", "state"}, {model rank: the rank's, with "tp"}).
    The launches of the ranks' run alone are left in `build.COUNTS`."""
    import torch
    from repro_torch import bridge
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import Model
    whole = Model(cfg)
    rng = np.random.default_rng(seed + 20)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt)),
                             dtype=torch.int32, device=device)
    extra = family_extra(cfg, rng, batch)
    if extra is not None:
        extra = {k: torch.as_tensor(v, device=device).to(cfg.dtype)
                 for k, v in extra.items()}
    ctx = prompt + steps + (cfg.frontend.num_embeddings
                            if cfg.family == "vlm" else 0)

    def run(model, p, fed=None):
        geo = model.cache_geometry(batch, ctx, hbm_fraction=0.25) \
            if cfg.attention_layer_ids() else None
        if cfg.family == "ssm":
            state = model.init_decode_state(batch, device=device)
            logits, state = model.decode_step(p, state, tokens[:, 0])
        else:
            logits, state = model.prefill(p, tokens, geo, extra=extra)
        out = {"logits": [logits], "tokens": []}
        for i in range(steps):
            tok = logits.argmax(-1).to(torch.int32)
            out["tokens"].append(tok)
            logits, state = model.decode_step(
                p, state, tok if fed is None else fed[i])
            out["logits"].append(logits)
        out["state"] = state
        return out
    want = run(whole, params)
    mesh = ThreadMesh(1, m)
    amesh = AbstractMesh(("data", "model"), (1, m))
    local = cfg.rank_local(m)
    geo = whole.cache_geometry(batch, ctx, hbm_fraction=0.25)
    shards = [bridge.shard_params(params, cfg, amesh,
                                  {"data": 0, "model": r}) for r in range(m)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    COUNTS.clear()                          # the ranks' run only

    def rank(coord):
        tp = mesh.serve_tp(cfg, coord, geo)
        got = run(Model(local, tp=tp), shards[coord["model"]],
                  want["tokens"])
        got["tp"] = tp
        return got
    ranks = {r: got for (_, r), got in mesh.run(rank).items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    return want, ranks


def family_rank_phase(seed, device="cuda", get=None, splits=None,
                      batch=FAMILY_RANK_B, steps=FAMILY_RANK_STEPS):
    """Phase 20: each of `splits` (default FAMILY_RANK_SPLITS: (config,
    model-axis sizes, prompt tokens, dtype)) at its published widths
    (random bf16 weights from `seed`; "f32": widened) through
    `family_rank_case`: every rank's
    logits of the prefill and each decode step within FAMILY_RANK_TOL of
    the unsplit run's, its greedy tokens beside (a near tie may flip one
    in bf16: counted, not held), its integer cache state (page table,
    owner maps, lengths) equal to the unsplit's, its pools' and
    recurrent state's error against its block of the unsplit state
    (`rank_state`) logged. Then one `--mesh multi` record of the dry run
    (qwen3-32b decode_32k, the meta device: host only), held complete.
    `device`, `get` (the configs by name), `batch`, `steps`:
    tests/test_torch_mesh_decode_families.py runs the phase on the CPU
    at the f32 smoke configs. Returns (the ranks' launches by kernel,
    the rows, the dry-run record)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.build import COUNTS
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map
    device = torch.device(device)
    get = get or configs.get
    rows, launches = [], collections.Counter()
    for name, sizes, prompt, dtype in splits or FAMILY_RANK_SPLITS:
        if device.type == "cuda":
            free_card()
        cfg = get(name)
        params = Model(cfg).init(seed, device=device)
        if dtype == "f32" and cfg.dtype != torch.float32:
            cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                      param_dtype=torch.float32)
            params = tree_map(lambda t: t.float(), params)
        tol = FAMILY_RANK_TOL["f32" if cfg.dtype == torch.float32
                              else "bf16"]
        for m in sizes:
            t = time.time()
            want, ranks = family_rank_case(cfg, m, params, seed, device,
                                           batch, prompt, steps)
            launches.update(COUNTS)
            launched = dict(COUNTS)
            err, flips, same, state_err = 0.0, 0, True, 0.0
            for r, got in ranks.items():
                for g, w in zip(got["logits"], want["logits"]):
                    err = max(err, rel_err(g, w))
                flips += sum(int((g != w).sum()) for g, w in zip(
                    (x.argmax(-1) for x in got["logits"]),
                    (x.argmax(-1) for x in want["logits"])))
                ok, e = state_diff(got["state"], rank_state(
                    want["state"], got["tp"], m))
                same &= ok
                state_err = max(state_err, e)
            tp = ranks[0]["tp"]
            rule = "no cache" if not cfg.attention_layer_ids() else \
                "kv_heads" if tp.kv_split else \
                "pages" if tp.pool is not None else "none"
            log(f"family rank {cfg.name} model={m} ({rule}; heads "
                f"{'split' if tp.heads_split else 'whole'}, recurrent "
                f"blocks {'split' if tp.recurrent_split else 'whole'}): "
                f"B={batch} x {prompt} prompt tokens, {steps} decode steps "
                f"on {m} threads in {time.time() - t:.1f} s; logits "
                f"{err:.3e} of max |logit| (tolerance {tol}), greedy "
                f"flips {flips}, integer state equal {same}, float state "
                f"{state_err:.3e} of max |value| against the rank's block; "
                f"launches {launched}")
            rows.append({"model": cfg.name, "split": m, "rule": rule,
                         "logits_err": err, "flips": flips,
                         "state_err": state_err, "launches": launched})
            if not same:
                raise AssertionError(f"family rank {cfg.name} model={m}: "
                                     f"an integer cache state differs")
            if not err <= tol:
                raise AssertionError(f"family rank {cfg.name} model={m}: "
                                     f"logits {err} over {tol}")
            del want, ranks
        del params
    t = time.time()
    record = dryrun.run_cell("qwen3-32b", "decode_32k", "multi")
    coll = record.get("collective_bytes_per_device") or {}
    if record.get("status") != "ok" or record.get("bytes_per_device") is \
            None or record["memory"].get("activation_bytes") is None or \
            set(coll.get("by_axis", {})) - {"pod", "data", "model"} or \
            not coll.get("total"):
        raise AssertionError(f"dry run multi record incomplete: {record}")
    log(f"family rank: dry run multi record of qwen3-32b decode_32k in "
        f"{time.time() - t:.1f} s (meta device)")
    print(json.dumps(record), flush=True)
    return dict(launches), rows, record


def assemble(grid, spec):
    """The whole gradient of a leaf from its ranks' blocks' gradients
    `grid[d][r]` (data rank d, model rank r) under `spec` (at most one
    dim on each axis): blocks concatenated along an axis that splits
    the leaf, the copies' gradients summed (in f32) along one that does
    not, as the meshed step's `enter` and `reduce_grads` sum them
    (phases 14b and 15c use one copy and give the others zeros; 16b's
    `ThreadMesh` ranks each use their own)."""
    import torch
    dims = {entry: d for d, entry in enumerate(spec) if entry is not None}

    def join(parts, axis):
        if axis in dims:
            return torch.cat(parts, dims[axis])
        return torch.stack([p.float() for p in parts]).sum(0)
    return join([join(blocks, "model") for blocks in grid], "data")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def wgmma_spills(report: str):
    """{head dim: (spill store bytes, spill load bytes)} of each
    instance of the flash kernel's tensor-core body in ptxas' report."""
    body = "flash_wgmma_kernel<"
    return {int(name[len(body):-1]): usage[1:]
            for name, usage in ptxas_usage(report).items()
            if name.startswith(body)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="run the full-width serve's second pass (every "
                    "chunk captured) under torch.profiler, print where the "
                    "device time goes and write the profiler's table to "
                    "DIR (that serve's wall time then includes the "
                    "profiler's cost)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import build

    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    t_all = time.time()

    def phase(name, fn):
        t = time.time()
        out = fn()
        log(f"phase {name}: {time.time() - t:.1f} s wall")
        return out

    built = phase("build", lambda: build.build_all(force=True))
    log(f"build: {', '.join(lib.name for lib, _ in built.values())} "
        f"(nvcc sm_90a, one process per source, in parallel)")
    for name, (_, report) in built.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {name}: {line.strip()}")
    spills = wgmma_spills(built["flash_attention"][1])
    log(f"build: flash_wgmma_kernel spill bytes (stores, loads) by head "
        f"dim: {spills}")
    if not spills or any(any(v) for v in spills.values()):
        raise AssertionError(f"the flash kernel's tensor-core bodies spill "
                             f"registers: {spills}")

    rng = np.random.default_rng(args.seed)
    device = torch.device("cuda")
    shapes, link = phase("kernel", lambda: kernel_phase(rng, device))
    copies = phase("copy", lambda: page_copy_phase(rng, device, link))
    flash = phase("flash", lambda: flash_phase(device))
    flash_bwd = phase("flash bwd", lambda: flash_bwd_phase(
        device, built["flash_attention_bwd"]))
    sums, update = phase("adamw", lambda: adamw_phase(device, args.seed))
    phase("parity", lambda: parity_phase(args.seed))
    phase("overlap parity", lambda: parity_phase(args.seed, overlap=True))
    phase("faults", lambda: faulted_parity_phase(args.seed))
    phase("faults overlap", lambda: faulted_parity_phase(args.seed,
                                                         overlap=True))
    phase("moe parity", lambda: moe_parity_phase(args.seed))
    phase("family parity", lambda: family_parity_phase(args.seed))
    phase("stream", lambda: stream_parity_phase(args.seed))
    model, params = phase("model", lambda: full_width(args.seed))
    phase("fused vs eager", lambda: fused_phase(model, params, args.seed))
    serve, inline = phase("serve", lambda: serve_phase(
        model, params, args.seed, args.profile, again=True))
    overlap, overlap_numbers = phase("serve overlap", lambda: serve_phase(
        model, params, args.seed, overlap=True, inline=inline, again=True))
    sweep = phase("sweep", lambda: sweep_phase(model, params, args.seed))
    faulted, faulted_numbers = phase("serve faulted", lambda:
                                     faulted_serve_phase(model, params,
                                                         args.seed))
    mesh_serve, _ = phase("mesh serve", lambda: mesh_serve_phase(
        model, params, args.seed, inline, overlap_numbers))
    mesh_stream, _ = phase("mesh stream", lambda: mesh_stream_phase(
        model, params, args.seed, dict(MESH_STREAMS)[model.cfg.name]))
    phase("tp split", lambda: tp_split_phase(args.seed))
    prefill_split = phase("prefill split", lambda: prefill_split_phase(
        args.seed))
    pages_split, _ = phase("pages split", lambda: pages_split_phase(
        args.seed))
    del model, params               # the CLI's model takes the card next
    gc.collect()
    torch.cuda.empty_cache()
    cli, _ = phase("serve cli", lambda: serve_cli_phase(args.seed))
    example = phase("example", example_phase)
    moe_model, moe_params = phase("moe model", lambda: full_width(
        args.seed, "granite-moe-3b-a800m"))
    moe, moe_numbers = phase("moe", lambda: moe_phase(
        moe_model, moe_params, args.seed))
    mesh_moe, _ = phase("mesh moe serve", lambda: mesh_moe_serve_phase(
        moe_model, moe_params, args.seed, moe_numbers))
    mesh_moe_stream, _ = phase("mesh moe stream", lambda: mesh_stream_phase(
        moe_model, moe_params, args.seed,
        dict(MESH_STREAMS)[moe_model.cfg.name]))
    mesh_stream = dict(collections.Counter(mesh_stream) +
                       collections.Counter(mesh_moe_stream))
    del moe_model, moe_params
    free_card()
    moe_split, _ = phase("moe split", lambda: moe_split_phase(args.seed))
    llama, _ = phase("llama31-8b", lambda: big_serve_phase(
        "llama31-8b", args.seed))
    qwen, _ = phase("qwen3-32b", lambda: big_serve_phase(
        "qwen3-32b", args.seed, overlap=True))
    streams, _ = phase("single streams", lambda: single_stream_phase(
        args.seed))
    phase("xlstm", lambda: xlstm_phase(args.seed))
    phase("train parity", lambda: train_parity_phase(args.seed))
    train, trained_serve, train_numbers = phase(
        "train", lambda: train_phase(args.seed))
    resume, _ = phase("train resume", lambda: resume_phase(args.seed))
    phase("train witness", lambda: train_witness_phase(args.seed))
    mesh_ref = train_numbers.pop("mesh_ref")
    mesh_train, _ = phase("mesh train", lambda: mesh_train_phase(
        args.seed, mesh_ref))
    del mesh_ref
    train_split, _ = phase("train split", lambda: train_split_phase(
        args.seed))
    moe_train, _ = phase("moe train", lambda: moe_train_phase(args.seed))
    moe_train_split, _ = phase("moe train split", lambda:
                               moe_train_split_phase(args.seed))
    family_train, _ = phase("family train", lambda: family_train_phase(
        args.seed))
    family_split, _ = phase("family train split", lambda:
                            family_train_split_phase(args.seed))
    kv_split, _ = phase("kv train split", lambda: kv_train_split_phase(
        args.seed))
    kv_step, _ = phase("kv train step", lambda: kv_train_step_phase(
        args.seed))
    family_rank, _, _ = phase("family rank", lambda: family_rank_phase(
        args.seed))
    log(f"all phases: {time.time() - t_all:.1f} s wall")

    # one inline internlm2 decode layer: the HBM-tier (N=64) + host-tier
    # (N=208) launch; granite-moe's and the pinned host tier of overlap
    # mode are in per_shape
    layer = [s for s in shapes if "pools" not in s
             and "pages_split" not in s and s["model"] == "internlm2-1.8b"]
    paths = {"serve": serve, "serve_overlap": overlap,
             "policy_sweep": sweep, "serve_faulted": faulted,
             "moe_serve": moe["serve"], "moe_generate": moe["generate"],
             "llama31_serve": llama, "qwen3_serve_overlap": qwen,
             "trained_serve": trained_serve, "serve_cli": cli,
             "example": example, **mesh_serve, "mesh_moe_serve": mesh_moe,
             "moe_split": moe_split, "mesh_stream": mesh_stream,
             "pages_split": pages_split["pages"],
             "none_split": pages_split["none"],
             "family_rank": family_rank,
             **{f"{name}_generate": c["generate"]
                for name, c in streams.items()}}
    paged_by_path = {k: c.get("paged_attention", 0)
                     for k, c in paths.items()}
    paged = {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:99",
        "launches": sum(paged_by_path.values()),
        "launches_by_path": paged_by_path,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum(s["ms"] for s in layer),
        "plain_ms": sum(s["plain_ms"] for s in layer),
        "bound_ms": sum(s["bound_ms"] for s in layer),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                   for s in layer) else "operations",
        "library_ms": sum(s["library_ms"] for s in layer),
        "eager_ms": sum(s["eager_ms"] for s in layer),
        "per_shape": shapes,
        "link_bytes_per_s": link,
    }
    copy_by_path = {k: c.get("page_copy", 0) for k, c in paths.items()}
    copy_entry = {
        "name": "page_copy", "route": "cuda",
        "source": "src/repro_torch/csrc/page_copy.cu",
        "replaces": None,
        "note": "not a TPU kernel: every move of pages and tokens into, "
                "out of and between the pools, where the reference uses XLA "
                "gathers and scatters (src/repro/kvcache/migrate.py:106,"
                "136); ms and bound_ms are one pool's gather (pinned -> "
                "card) plus scatter (card -> pinned) at plan capacity, "
                "bound by the link's peak; per_direction also holds the "
                "card gather, one layer's decode token write (one launch) "
                "and overlap prefill's gather (lane_pages, one launch); "
                "serve_overlap leaves out the payback probe's launches "
                "(payback_probe_launches), mesh_serve_overlap holds its "
                "own probe's",
        "launches": sum(copy_by_path.values()),
        "launches_by_path": copy_by_path,
        "payback_probe_launches": overlap_numbers["probe_launches"].get(
            "page_copy", 0),
        "launches_per_step": {
            "serve": inline["row_copies_per_step"],
            "serve_overlap": overlap_numbers["row_copies_per_step"]},
        **copies,
    }
    for entry in (paged, copy_entry):
        dead = [k for k, n in entry["launches_by_path"].items() if n == 0]
        if dead:
            raise AssertionError(f"{entry['name']} never launched on "
                                 f"{dead}")
    flash_by_path = {"policy_sweep": sweep["flash_attention"],
                     "train": train.get("flash_attention", 0),
                     "mesh_train": mesh_train.get("flash_attention", 0),
                     "train_split": train_split.get("flash_attention", 0),
                     **{k: c.get("flash_attention", 0)
                        for k, c in moe_train.items()},
                     "moe_train_split": moe_train_split.get(
                         "flash_attention", 0),
                     **{k: c.get("flash_attention", 0)
                        for k, c in family_train.items()},
                     "family_train_split": family_split.get(
                         "flash_attention", 0),
                     "kv_train_split": kv_split.get("flash_attention", 0),
                     "kv_train_step": kv_step.get("flash_attention", 0),
                     "example": example.get("flash_attention", 0),
                     "moe_start": moe["start"].get("flash_attention", 0),
                     "mesh_stream": mesh_stream.get("flash_attention", 0),
                     "prefill_split": prefill_split.get("flash_attention",
                                                        0),
                     **{f"{rule}_split": c.get("flash_attention", 0)
                        for rule, c in pages_split.items()},
                     "family_rank": family_rank.get("flash_attention", 0),
                     **{f"{name}_start": c["start"].get("flash_attention", 0)
                        for name, c in streams.items()},
                     "whisper-tiny_generate": streams["whisper-tiny"][
                         "generate"].get("flash_attention", 0)}
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:71",
        "launches": sum(flash_by_path.values()),
        "launches_by_path": flash_by_path,
        **flash,
    }
    bwd_by_path = {"train": train.get("flash_attention_bwd", 0),
                   "train_resume": resume.get("flash_attention_bwd", 0),
                   "mesh_train": mesh_train.get("flash_attention_bwd", 0),
                   "train_split": train_split.get("flash_attention_bwd", 0),
                   **{k: c.get("flash_attention_bwd", 0)
                      for k, c in moe_train.items()},
                   "moe_train_split": moe_train_split.get(
                       "flash_attention_bwd", 0),
                   **{k: c.get("flash_attention_bwd", 0)
                      for k, c in family_train.items()},
                   "family_train_split": family_split.get(
                       "flash_attention_bwd", 0),
                   "kv_train_split": kv_split.get("flash_attention_bwd", 0),
                   "kv_train_step": kv_step.get("flash_attention_bwd", 0),
                   "example": example.get("flash_attention_bwd", 0)}
    bwd_entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": None,
        "note": "not a TPU kernel: the gradient of the flash kernel "
                "(torch.autograd.Function), where the reference "
                "differentiates plain jnp attention by autodiff "
                "(src/repro/models/layers.py:131-217); one launch counts "
                "its three kernels (delta, dK/dV, dQ); library_ms is the "
                "backward of one scaled_dot_product_attention (enable_gqa) "
                "with its forward outside the timed region; max_rel_err is "
                "the largest error over its gradient's max |value|, which "
                "the tolerance bounds",
        "launches": sum(bwd_by_path.values()),
        "launches_by_path": bwd_by_path,
        **flash_bwd,
    }
    train_paths = {"train": train, "train_resume": resume,
                   "mesh_train": mesh_train, **moe_train, **family_train,
                   "kv_train_step": kv_step, "example": example}
    optimizer = []
    for name, entry in (("grad_sumsq", sums), ("adamw_apply", update)):
        by_path = {k: c.get(name, 0) for k, c in train_paths.items()}
        optimizer.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/adamw.cu", "replaces": None,
            "note": "not a TPU kernel: the reference's jitted, donated "
                    "train step (src/repro/launch/train.py:60-65), whose "
                    "adamw_update (src/repro/training/optimizer.py) XLA "
                    "fuses; one launch covers every leaf of the tree; ms "
                    "at internlm2-1.8b's 1.89 B bf16 parameters (the update "
                    "in place); no PyTorch call computes either function "
                    "(torch.optim.AdamW updates bf16 weights in bf16)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **entry})
    for entry in (flash_entry, bwd_entry, *optimizer):
        dead = [k for k, n in entry["launches_by_path"].items() if n == 0]
        if dead:
            raise AssertionError(f"{entry['name']} never launched on {dead}")
    print(json.dumps({"kernels": [paged, flash_entry, copy_entry,
                                  bwd_entry, *optimizer]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
