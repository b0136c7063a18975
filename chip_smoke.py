#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card: serve
Mistral-NeMo-12B, serve Mamba2-130M, run the DSE price phase, train
OLMo-1B, serve Minitron-4B (GQA group 3) and OLMoE-1B-7B (MoE) at full
width, run the modeled-vs-measured validation loop, serve
Llama-3.2-Vision-11B (cross-attention to image embeddings),
SeamlessM4T-medium (an encoder-decoder) and Jamba-v0.1 (hybrid
attention/SSM blocks with MoE) at full width, decode speculatively,
train through the fused RMSNorm and the SSD scan: Mamba2-130M at full
width and depth, Mistral-NeMo-12B at full width with two layers, and run
the multi-device layer: OLMo-1B on one NCCL rank's mesh with FSDP,
OLMoE-1B-7B served expert- and context-parallel on two gloo ranks that
share the card, and a data-parallel OLMo-1B step on two; then Mamba2-130M,
Llama-3.2-Vision-11B and SeamlessM4T-medium served with every layer kind
split over a model axis of two gloo ranks sharing the card; then the
kernels' contract on the paths: the head-dim-16 SMOKE configs served and
trained, every SMOKE config in float32 against the CPU, Mistral-NeMo-12B
served and OLMo-1B trained in float32 at full size; and Command-R-35B
served whole (40 layers at full width, 60.3 GiB of bf16 weights).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. the card and the toolchain;
  2. build every kernel from ``src/repro_torch/kernels/*/csrc`` with nvcc
     (sm_90a), one process per source (the float32 attention kernels'
     sources among them), and a small measurement helper (PROBE_SOURCE),
     all in parallel, printing ``-Xptxas -v``; every RMSNorm (bf16 and
     float32; the split-row launches' at each gate width), flash-attention
     and decode (hd 16, 32, 64, 128; bf16 and float32) and SSD
     instantiation's registers, spills (none allowed) and shared memory;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes its path gives it and at ragged ones, with its time, the plain
     version's, one PyTorch library call's (where one exists) and the least
     time the card could take (bound); the fused RMSNorm at the six shapes
     of the serving paths (RMSNORM_SHAPES: the residual norm of mistral and
     mamba2 and Mamba2's gated norm, decode and prefill) and at ragged and
     unaligned ones, y within one bf16 ulp of its f64 value, the residual
     bit for bit, the gated norm within one ulp of the unfused chain, a race
     check (a predecessor that writes x last, eagerly and replayed), each
     decode shape timed as 81 launches captured in one graph beside an
     empty kernel's, each prefill shape with the L2 flushed by a read and
     by a write; the pricing kernel at 2^20 rows, f64
     bit for bit and f32 within the drift band; the SSD scan in f32 within
     the reference's 2e-4, in the model's layout (B/C at head stride 0, or
     per head) and in the Pallas kernel's, at ragged lengths, P != N and a
     strong decay, two calls bit-identical; decode attention with a device
     kv_len at the serving cache (also kv_len 0, 1 and S) and GQA groups 3,
     8 and 16, each output also within one bf16 ulp of its f64 value, and one
     captured launch replayed with kv_len changed on the device; its time
     with the L2 flushed by a write and, beside SDPA, by a read;
     the serving forward at the mistral and minitron_4b prefill shapes,
     ragged lengths and its 128-row / 128-key tile edges, each
     query row within 2e-2 of that row's largest plain value; the three
     training attention kernels (forward with LSE, dK/dV, dQ) at the
     olmo_1b training shape (8, 16, 2048, 128) causal, a GQA ragged shape,
     hd 64 full attention and the same tile edges, each row of o, dq (per
     query) and dk, dv (per key) within 2e-2 of that row's largest plain
     value, and the backward kernels bit-identical across two calls; the
     shapes of the VLM's cross-attention (MEMORY_FLASH_CASES,
     MEMORY_DECODE_CASES: the flash forward without the mask over 1601
     image tokens, decode attention over the whole memory), SeamlessM4T's
     at hd 64 (:func:`check_hd64`: the flash forward's three-warpgroup
     form over the decoder's cross-attention, the encoder's 1024² and
     the decoder's causal 2048², decode over the memory and the decoder's
     cache, with kv_len at the 32-key tiles' edges replayed through one
     captured launch, the forward's 192-row items' edges, two calls the same
     bits, a step's 24 decode launches in one graph) and of command_r_35b's
     path
     (COMMAND_R_FLASH_CASES, COMMAND_R_DECODE_CASES: GQA group 8 at hd 128,
     the 4 x 2048 causal prefill and decode over its 2081-position cache at
     kv_len 2079), the SSD scan at Jamba's (4, 2048, 128, 64,
     16) and the gated norm at d_inner 8192 (RMSNORM_JAMBA), each held and
     timed beside its bound and, for attention, SDPA; the RMSNorm's
     backward kernel at the training shapes (RMSNORM_BWD_SHAPES: mamba2 8
     x 2048 residual and gated, mistral 2 x 2048 and its first norm) and
     ragged, unaligned and dr-less ones, against the plain backward and
     its f64 value (dx within one bf16 ulp; the gated chain's dy and dz
     within one of the f64 chain rounded where the chain rounds, but for
     at most RMSNORM_GATED_BEYOND_ONE_ULP of them, within
     RMSNORM_GATED_ULPS, where an intermediate rounding falls the other
     way; dw within RMSNORM_DW_REL of its row sum's condition), two calls
     bit-identical, timed beside its bound, the plain backward and
     F.rms_norm's backward under autograd; decode attention on one rank's
     block of a context-parallel cache (CP_DECODE_CASES: mistral's serving
     cache halved, the block full, empty and ragged), its LSE also held
     against the plain version's; the gated norm over rows split across
     ranks (RMSNORM_SPLIT_SHAPES: Mamba2's and Jamba's rank blocks at
     their serving shapes, ragged and odd widths, gates on 2, 4, 8 and 16
     bytes): each statistic and
     apply launch, forward and backward, against its plain version, and
     the blocks put together against the one-launch norm and its
     backward, each timed beside its bound; then the contract's further
     instantiations (:func:`check_contract`): hd 16 in bf16 (decode, the
     serving forward, the three training kernels) held as the bf16 ones
     are, float32 at hd 16, 32, 64 and 128 (decode over a bf16 and an f32
     cache, with a replayed captured launch; the serving forward; the
     training kernels, the backward bit-identical across two calls) and
     row 1 with its backward and split-row launches in float32, at the
     reference's float32 tolerances (2e-5 forward, 2e-4 backward), each
     timed beside its bound, its plain version and SDPA or F.rms_norm
     (SDPA's default call beside its memory-efficient backend over K/V
     expanded outside the call, the faster kept; float32 attention with
     two bounds, the split TF32 tensor cores' and the CUDA cores'; every
     attention entry also with the softmax's exponentials as a second
     bound, and bf16 decode at hd 16 also as GRAPH_LAUNCHES launches in a
     graph beside an empty kernel and SDPA, a launch over DECODE_STUCK_MS
     failing);
  4. the DSE path: ``DSEEngine.sweep`` on the seven smoke scenarios and a
     parallel sweep, then ``reprice_grid`` on the 100,224-cell dense grid,
     on the kernel backends, each against the numpy backend (rows and
     winners identical) with its launch counters zeroed before and read
     after; the price phase split into plan, copies and kernel (it runs
     before the serving paths' profiles, after which torch.profiler has
     missed the pricing kernel's event);
 4b. the DSE features that run through the pricing kernels, under a
     watchdog: the learned ranker fitted from the smoke sweeps on the
     kernel backend (equal to numpy's, recall at its target), every smoke
     scenario rank on and off on kernel, kernel-f32 and torch (rows and
     rank survivors equal numpy's); ``reprice_grid`` rank on at 100,224
     cells on both kernels (counts equal numpy's, price_s beside rank
     off); certified ``search`` (random, halving, surrogate on the llm
     smoke grid, halving on dense grids up to the largest that finishes
     within SEARCH_LIMIT_S), each equal to numpy's; then the DSE service
     daemon started after CUDA is initialized (its warm pool by
     forkserver, a serial session refused): two clients with 6
     overlapping cells, a search and a reprice request, rows equal to the
     numpy engine's, dedup hits equal to the overlap, pricing launches
     during the requests, a clean shutdown;
  5. the serving path: ``run_serve`` on the full mistral_nemo_12b config, 4
     requests x 2048-token prompts x 32 new tokens, random weights from a
     seed; the kernels' launch counters are zeroed just before and read just
     after, and must show every kernel on the path (the decode step runs as
     a captured CUDA graph, whose replays count their launches); the
     engine's graph tokens against eager ``decode_step`` calls for all 31
     steps (identical; the largest logit difference printed);
  6. a new engine's generate (one capture, its time), a warm one that
     captures nothing, steady-state decode through the graph, profiles of
     an eager and of a replayed decode step, and correctness checks: the
     kernels' model against the plain versions on a small config, and at
     full size the decode path's logits against a teacher-forced prefill
     over the generated tokens;
  7. the SSM serving path: ``run_serve`` on the full mamba2_130m config, 8
     requests x 2048-token prompts x 32 new tokens, counters zeroed just
     before and read just after; a second run from the seed, steady-state
     decode, the decode path (the recurrence) against a teacher-forced
     forward (the chunked scan), for the whole model and for each layer
     alone, the state handoff layer by layer, every sequence of the batch,
     on three weight seeds, once with the scan through the kernel and once
     through its plain version (the kernel route held to the plain route's
     readings, see SSM_REL), profiles of a prefill and a decode step, and
     the small config on the card against the plain versions; then one
     more profiled ``reprice_grid``, whose pricing
     events the profiler is asked for after the serving profiles
     (reported, not checked);
  8. training: the gradients of a 2-layer olmo_1b at full width, batch 2 x
     2048, through the kernels against the same model with the plain
     attention under autograd (every leaf within 2e-2 of its largest
     value, wq/wk/wv non-zero); the SMOKE config's 3 train steps on the
     card against the CPU; then ``run_train`` on the full olmo_1b, 8 x
     2048 tokens, 8 steps on one repeated batch, counters zeroed just
     before and read just after (2L forward-with-LSE launches per step
     under remat "full", L of each backward kernel), a finite loss that
     starts near ln V + 1/2 and falls, step time, tokens/s, the FLOP
     shares of the 989 TFLOP/s peak and peak memory; and a profile of one
     full step;
  9. a GQA group-3 serving path: ``run_serve`` on minitron_4b at full width
     (d_model 3072, 24/8 heads, vocab 256,000), its depth cut to
     MINITRON_LAYERS layers, counters zeroed just before and read just
     after, its graph tokens against eager ones, a new engine's generate,
     a warm one, steady decode through the graph, profiles of an eager and
     a replayed decode step, and its decode path's logits against a
     prefill of the same tokens; then a child process
     (``--capture-failure``) shows that a decode step that reads a value on
     the host cannot be captured and the engine raises;
 10. the MoE serving path: ``run_serve`` on the full olmoe_1b_7b config
     (64 experts top-8, 16 layers, d_model 2048, MHA 16/16 at hd 128), 4
     requests x 2048-token prompts x 32 new tokens, counters zeroed just
     before and read just after (rmsnorm, flash forward, decode attention),
     its graph tokens against eager ones;
 11. as phase 6 for it, and the tokens the default capacity factor drops
     in a prefill (a reading); the decode path (dropless ``moe_dense``)
     against a teacher-forced forward at the capacity where nothing drops,
     each sequence held before the first token the two route otherwise
     (bf16 near-ties), and the small config (olmoe_smoke) card vs CPU
     likewise;
 12. validation: the card calibrated (the reference's host-clock protocol,
     CUDA events beside it) and printed beside the catalog H100; the three
     cases (serving, mamba2, moe) built (each certifies its twin),
     predicted, their decode step counted on the kernels' route (the moe
     twin at its hd 16 on the kernels too), every case timed (a case
     without a wall clock fails); the reference's bands gate every row,
     and BENCH_validation_torch.json is written;
 13. a reading: the paper's serving model (``serving_sweep`` on a one-chip
     catalog H100) for mistral_nemo_12b, olmoe_1b_7b and command_r_35b
     beside their measured warm TTFT and steady TPOT, and the bytes each
     keeps resident beside the catalog memory's capacity (the model checks
     none);
 14. the VLM: llama32_vision_11b at full width and depth (40 layers, 8 of
     them cross-attending) through ``ServeEngine.generate(...,
     memory=...)`` with seeded (4, 1601, 4096) image embeddings, counters
     zeroed just before and read just after (1 + 2L + 8 norms a pass, 48
     flash launches at prefill, 48 decode launches a step); graph tokens
     against eager ones; a second memory changes the prefill and the
     replayed decode logits and is served by the warm engine without a
     new capture; steady decode; the decode path against a teacher-forced
     forward; profiles; the SMOKE config card vs CPU;
 15. the same for seamless_m4t_medium, the memory the encoder's output
     over seeded (4, 1024, 1024) audio frames (``encode``, timed on its
     own beside TTFT): 12 + 24 flash launches, 24 decode launches a step;
 16. Jamba's hybrid blocks: jamba_v01_52b at full width, depth cut to
     JAMBA_LAYERS (two blocks of 7 Mamba, 1 attention, 4 MoE layers) through
     ``run_serve`` as phases 5 and 9; its decode against a teacher-forced
     forward on the kernel and the plain scan (the kernel route within
     SSM_REL of the plain one, each sequence before its first route
     difference), the cache slots where ``cache_spec`` puts them, the
     SMOKE config card vs CPU;
 17. speculative decoding (olmo_1b SMOKE): the target as its own draft
     gives the engine's greedy tokens, another draft the CPU's tokens,
     acceptance rate and target calls;
 18. training through the fused RMSNorm and the SSD scan: (a) the
     gradients of 2-layer mamba2_130m and mistral_nemo_12b at full width,
     2 x 2048, through the kernels against the same model with the plain
     routes swapped in (loss and every leaf within SCALED_TOL_SMALL,
     launches exact), one SMOKE step of each RMSNorm config card vs CPU;
     (b) ``run_train`` on mamba2_130m at full width, MAMBA2_TRAIN_LAYERS of
     its 24 layers, 8 x 2048, TRAIN_STEPS steps
     (launches per step: 1 + 4L forward norms under remat "full", 1 + 2L
     backward, 2L scans, L plain scan backwards), a falling loss, step
     time, tokens/s, MFU, peak memory and one profiled step split into
     matmul, the scan forward, its plain backward, the norm forward and
     backward, other; (c) mistral_nemo_12b at full width with
     MISTRAL_TRAIN_LAYERS layers, 2 x 2048, under remat "full" and "dots",
     the losses within REMAT_LOSS_REL;
 20. the multi-device layer (``parallel/``, ``launch/mesh.py``,
     ``launch/shardings.py``), in child processes (``--phase20``) each
     killed past PHASE20_TIMEOUT_S: (a) ``run_train`` on the full olmo_1b,
     8 x 2048, MESH_TRAIN_STEPS steps, without a mesh and then on one NCCL
     rank with the (1, 1) mesh and FSDP, the losses alike and within phase
     8's bound, launches as phase 8's, step time and peak memory side by
     side; (b) olmoe_1b_7b at full width, CP_LAYERS of its 16 layers, on
     two gloo ranks sharing the card, mesh (1, 2), ``moe_dispatch="shard_map"`` and
     ``decode_attn="context_parallel"`` (32 experts, 8 heads, half the
     vocabulary and half the cache's sequence a rank), 4 x 2048 + 16
     tokens and 1 x 64 + 16 (rank 1's block empty in every step), every
     run routed as one device routed it (replayed): the engine (eager over
     gloo) timed for TTFT and TPOT beside one device's and held against
     it, the logits of every step up to a sequence's first token
     difference within SCALED_TOL_FULL, every decode step launching row 2
     L times on both ranks; eager steps fed one device's tokens, logits
     within SCALED_TOL_FULL; (c) one step of olmo_1b at full width with 2
     layers on two gloo ranks, mesh (2, 1), 2 x 2048 a rank, plain, with
     compressed gradients and with FSDP: loss and every gradient leaf (a
     rank's block under FSDP) against one process's 4 x 2048 step within
     SCALED_TOL_SMALL (INT8_SCALED more compressed), launches 2L / L / L
     a rank a step;
 21. every layer kind under a model axis (``launch/shardings.py``'s
     segmented Mamba2 split, the split-row gated norm, cross-attention on
     local heads, the encoder), in child processes on two gloo ranks
     sharing the card, mesh (1, 2), against one device in this process
     (MA_SERVE: mamba2_130m 8 x 2048 + 16 at full width and depth,
     llama32_vision_11b and seamless_m4t_medium 1 x 256 + 8 at full width
     and depth): the engine's sampled logits up to each sequence's first
     token difference (mamba2 relative to one device's own plain-scan
     reading), the launches (every gated norm a statistic and an apply
     launch), and a 2-layer mamba2_130m train step's loss and gradients
     (the split norm's backward launches), the gradients held relative to
     one device's own plain-scan reading as the logits are;
 22. head dim 16 in bf16: ``run_serve`` on the SMOKE configs of
     minitron_4b, command_r_35b, gpt3_175b and qwen3_moe_235b, 4 x 2048 +
     32, counters zeroed just before and read just after (flash and decode
     at bf16/hd16 on every layer), graph tokens against eager ones, each
     SMOKE config card vs CPU at 2e-2; qwen3_moe_235b's SMOKE config trains
     3 steps at its own hd 16, card vs CPU;
 23. float32: every architecture's SMOKE config, prefill and 4
     teacher-forced decode steps, card vs CPU at the CPU tests' float32
     tolerances (F32_PREFILL_TOL, F32_DECODE_TOL; the caches as
     check_small_model_f32 says), a MoE config routed as the CPU routed;
     3 train steps of mistral_nemo_12b's and minitron_4b's SMOKE configs
     (RMSNorm, LayerNorm) card vs CPU; counters zeroed just before and read
     just after;
 24. ``run_serve`` on mistral_nemo_12b in float32 at full width and depth,
     1 x 2048 + 32 (rows 1-3 in float32), counters zeroed just before and
     read just after, graph tokens identical to eager ones, the decode path
     against a teacher-forced forward within 1e-4 of the largest logit or
     within SSM_REL times the plain route's reading on the card, TTFT,
     TPOT and peak memory;
 25. ``run_train`` on olmo_1b in float32 at full width and depth, 4 x
     2048, 3 steps (rows 5-7 in float32), counters zeroed just before and
     read just after, a loss that starts near ln V + 1/2 and falls, step
     time and peak memory;
 26. (run after phases 10-11, where the allocator holds least, so that
     phase 13 reads it) command_r_35b whole: ``run_serve`` on the config as
     the repository defines it (40 layers, d_model 8192, 64/8 heads at hd
     128, d_ff 22528, vocabulary 256,000, LayerNorm), 4 x 2048 + 32, as
     phase 5: counters zeroed just before and read just after (flash 40,
     decode 1240, every other kernel 0), the memory ``run_serve`` leaves
     allocated (at most RUN_SERVE_LEFT_BYTES: its weights must be gone
     before they are drawn again), graph tokens against eager ones; the
     card's free memory printed before;
 27. as phase 6 for it; the peak allocated over both phases below the
     card's memory, printed with TTFT and the cold, warm and steady TPOT
     beside their floors (the prefill's FLOPs over the bf16 peak, a decode
     step's weights, and weights and cache, over HBM's rate);
 19. one JSON line of kernel numbers (the contract's instantiations as
     ``<kernel>[<dtype>/hd<hd>]``, each with its launches on the paths of
     phases 22-25), the card's name and power limit, the run's total time,
     and a last JSON line ``{"ok": true, "device": {...}}``; a kernel that
     the main path never launched fails the run.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet, dense, at its 700 W limit (the peak that the
# kernels' bounds use too: repro_torch.kernels.cost)
BF16_FLOP_PER_S = 989e12        # tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3

REQUESTS, PROMPT_LEN, NEW_TOKENS, SEED = 4, 2048, 32, 0
SSM_REQUESTS = 8                   # mamba2_130m: 8 x 2048 + 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 8   # olmo_1b: 8 x 2048
# minitron_4b (GQA group 3) serves at full width, its depth cut from 32 to
# this many layers to keep the phase short
MINITRON_LAYERS = 4
GRAD_LAYERS, GRAD_BATCH = 2, 2     # the full-width gradient check
TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 kernel vs plain, element-wise
SSD_TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's SSD tolerance, f32 math
# Decode attention averages ~2000 values, so its outputs are ~0.03: an
# absolute 2e-2 would hide a dropped split. Its limit is four bf16 ulps of
# the largest reference output instead.
DECODE_REL = 2.0 ** -6
SCALED_TOL_SMALL = 2e-2            # whole model, small config, bf16
TRAIN_ROW_REL = 2e-2               # training attention, each row's own scale
SCALED_TOL_FULL = 5e-2             # 40 bf16 layers, decode vs prefill path
# mamba2_130m at full depth with random weights amplifies bf16 rounding
# layer by layer (ROADMAP.md queue 3, "SSM"): the decode path (recurrence)
# and the teacher-forced forward (chunked scan) agree in layer 0's caches,
# then drift apart. Phase 7 reads that drift twice on the card, once with
# the scan through the kernel and once through its plain version
# (``plain_scan``), on SSM_SEEDS weight seeds and every sequence of the
# batch. On the H100, with the previous (CUDA-core f32) version of the SSD
# kernel (PERF.md §6), the deep readings, kernel / plain route, the
# largest over the seeds, were: logits 0.122 / 0.113, state handoff 0.148
# / 0.116, conv handoff 0.0952 / 0.0726 (ratios 1.08, 1.28, 1.31); seed 1
# read 0.148 / 0.116 on the state, so the earlier fixed limit of 0.1 was
# one reading, not a bound. What does not depend on depth was sharp on the
# kernel route: layer 0's state and conv handoff <= 1.5e-6, each layer
# alone's state and conv tail <= 4.1e-6 (the plain route read up to 8.6e-5
# there: its cumsum rounds otherwise). So the kernel route's layer 0
# handoff and each layer alone's state and conv tail are held within
# SSM_TIGHT; each layer alone's output within the repo's bf16 bound and
# greedy agreement at least 0.8 on both routes; and the deep readings
# relative to the plain route: the kernel route's largest over the seeds
# at most SSM_REL times the plain route's.
SSM_SEEDS = (SEED, SEED + 1, SEED + 2)
SSM_TIGHT = 1e-5
SSM_REL = 2.0

PRICE_ROWS, PRICE_TIMED_ROWS = 131072, 1 << 20
DRIFT_BAND = 1e-5                  # f32 pricing vs the f64 reference
# f32 pricing kernel vs its plain f32 version, relative, element-wise: the
# two differ only where the kernel contracts a product and a sum into an
# FMA; 2^-19 is 4 to 8 f32 ulps.
F32_PLAIN_REL = 2.0 ** -19
SMOKE_SCENARIOS = ("llm", "dlrm", "hpl", "fft", "moe", "mamba2", "serving")
PARALLEL_TIMEOUT_S = 600
# phase 4b: certified halving searches on dense grids of growing size
# (None: DenseGridSpec(), 864 cells; else DenseGridSpec.dense(size)); a
# size runs while its time, extrapolated from the last one, stays within
# SEARCH_LIMIT_S; the phase's watchdog is PHASE4B_TIMEOUT_S. The 100,000
# rung (100,224 cells, 103 s on the card once, predicted over the limit
# and skipped in two other runs) is cut to leave time for the MoE serving
# and validation phases, the 50,000 rung (50,112 cells, 67-68 s on the
# H100) to leave time for phase 20, the 20,000 rung (20,160 cells, 29.7-
# 31.9 s on the kernel and as long again on numpy) and the 10,000 rung
# (10,080 cells, 13.45 s on the kernel and about as long on numpy; cut
# when phases 26-27 put the total at 613.4 s) to hold the run under
# RUN_LIMIT_S.
SEARCH_LADDER = (None,)
SEARCH_LIMIT_S = 120
PHASE4B_TIMEOUT_S = 720
REPRICE_TURNS = 2                  # 3 before phase 20; cut to leave time for it
#: the whole run's time limit on the card, the kernels' build included
#: (PERF.md section 6 records each run's total against it). The run prints
#: each phase's seconds and flags a total over it; what was cut to stay
#: under it, in this order: the float32 mistral path to 1 request
#: (F32_REQUESTS), then the depth of phase 20's olmoe_1b_7b (CP_LAYERS)
#: and of phase 18's mamba2_130m training (MAMBA2_TRAIN_LAYERS), then the
#: size of phase 4b's largest dense search (SEARCH_LADDER). Phase 21's
#: mamba2_130m keeps its 24 layers: at 12 its two ranks read 0.101 against
#: a limit of twice one device's plain-scan reading, 0.032 there (the
#: H100), a noise reading that depth moves; at 24 the two read 0.12 and
#: 0.08
RUN_LIMIT_S = 614.7


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def say(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


# ------------------------------- measuring ------------------------------------
class Timer:
    """Device time of one call. The call is captured once into a CUDA graph
    and the graph replayed, so the host's share (Python, ctypes, allocation)
    is left out; CUDA events around each replay, averaged, with the L2
    cache flushed before each replay so every call reads device memory.

    The flush writes 256 MB (``zero_``), so the L2 holds dirty lines when
    the call starts, and a call that reads X bytes from device memory also
    makes the L2 write about X bytes back: a memory-bound kernel pays about
    twice its bytes. ``clean_l2=True`` flushes by reading the buffer
    instead, which leaves clean lines: the L2 a decode step inside the
    model finds (the weights it streams are read, not written)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def eager_ms(self, fn, iters: int) -> float:
        """CUDA events around each eager call (one that a graph cannot
        capture, such as autograd's backward), L2 flushed before each."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters

    def ms(self, fn, iters: int, clean_l2: bool = False) -> float:
        torch = self.torch
        flush = ((lambda: self.flush.max()) if clean_l2 else self.flush.zero_)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            flush()
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters


#: Kernel-name words of a MoE layer's routing, dispatch and combine (the
#: top-k sort, the rank scan, the scatters and gathers); the embedding's
#: row gather and the cache write land in this group too.
MOE_KERNEL_WORDS = ("sort", "scan", "scatter", "gather", "index", "topk")


def profile(torch, fn, moe: bool = False, host: bool = True) -> dict:
    """One call under torch.profiler: host wall time, device busy time by
    kernel group and the device's idle share (1 - busy / wall). Profiling
    slows the host, so the idle share is an upper bound. ``moe`` adds the
    group ``moe_dispatch_combine`` (MOE_KERNEL_WORDS). ``host=False``
    traces the device alone (a call of ~10^5 launches, whose host events
    take the profiler minutes to read back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with torch_profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)) / 1e3
        name = e.key
        group = ("rmsnorm_bwd" if "rmsnorm_bwd_kernel" in name or "rmsnorm_dw_kernel" in name else
                 "rmsnorm" if "rmsnorm_kernel" in name else
                 "decode_attention" if "decode_" in name and "_kernel" in name else
                 "flash_attention" if "flash_fwd_" in name else
                 "flash_attention_bwd" if "flash_bwd_" in name else
                 "ssd" if "ssd_chunk_kernel" in name else
                 "matmul" if any(w in name.lower() for w in
                                 ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
                 else "moe_dispatch_combine" if moe and any(
                     w in name.lower() for w in MOE_KERNEL_WORDS)
                 else "other")
        groups[group] = groups.get(group, 0.0) + t
        kernels.append((t, e.count, name[:90]))
    busy = sum(groups.values())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_ops": sum(n for _, n, _ in kernels),
            "idle_share": 1 - busy / wall if busy else None,
            "by_group_ms": {k: round(v, 4) for k, v in sorted(
                groups.items(), key=lambda kv: -kv[1])},
            "top": [(round(t, 4), n, k) for t, n, k in sorted(kernels)[::-1][:8]]}


def device_split(torch, fn):
    """Run ``fn`` once under torch.profiler; returns its result and the
    device time (ms) and count of the host->device copies, the pricing
    kernels, the device->host copies and anything else on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    split = {k: [0.0, 0] for k in ("h2d", "kernel", "d2h", "other")}
    events = []
    for e in prof.key_averages():
        memcpy = "Memcpy" in e.key
        if getattr(e, "device_type", None) != DeviceType.CUDA and not memcpy:
            continue
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)) / 1e3
        key = ("h2d" if "HtoD" in e.key else "d2h" if "DtoH" in e.key else
               "kernel" if "pricing_kernel" in e.key else "other")
        split[key][0] += t
        split[key][1] += e.count
        events.append((e.key[:48], str(getattr(e, "device_type", None)),
                       e.count, round(t, 6)))
    return out, {f"{k}_ms": t for k, (t, _) in split.items()} | {
        f"{k}_n": n for k, (_, n) in split.items()} | {"events": events}


def compare(torch, got, want, name: str, tol: dict = TOL) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {err.max().item():.3g}"
                             f" outside rtol={tol['rtol']:g}, atol={tol['atol']:g}")
    return err.max().item()


def compare_scaled(torch, got, want, name: str, rel: float) -> float:
    """max |got - want| <= rel * max |want|; returns max |got - want|."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    lim = rel * want.float().abs().max().item()
    if not err <= lim:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3g} > {lim:.3g}"
                             f" ({rel:g} x max |plain|)")
    return err


# A row's scale is its largest |plain| value, but at least this share of
# the tensor's: some rows are zero by cancellation (dq at query 0 of causal
# attention, where o = v_0 makes dS = 0), and the kernel's f32 rounding
# leaves ~1e-7 there.
ROW_SCALE_FLOOR = 1e-3


def row_scaled_errs(got, want) -> tuple[float, float]:
    """(max |got - want| / max |want| over the whole tensor, the same ratio
    taken row by row over the last dimension, each row's scale at least
    ROW_SCALE_FLOOR of the tensor's, maximised over rows). Causal
    attention's rows differ in size by two orders of magnitude (row 0 of o
    is one value of v, row 2047 a mean of 2048), so a limit scaled by the
    whole tensor's largest value may pass a kernel that drops a key or
    query tile deep in the sequence: the training kernels are held to the
    row ratio."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs()
    top = scale.max()
    whole = (err.max() / top).item()
    rows = (err.amax(-1) / scale.amax(-1).clamp_min(ROW_SCALE_FLOOR * top)
            ).max().item()
    return whole, rows


def sdpa(F, q, k, v, causal: bool):
    """The library yardstick for attention: one scaled_dot_product_attention
    call with grouped K/V (never called by the port)."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def sdpa_lse(torch, q, k, v, causal: bool):
    """The library yardstick for the forward with LSE: one aten call that
    returns O and the logsumexp, over K/V expanded across the GQA group
    outside the call (never called by the port): the flash backend's
    ``_scaled_dot_product_flash_attention`` or, where it refuses the inputs,
    the memory-efficient backend with ``compute_log_sumexp``. Returns (a
    callable giving (o, lse), the call's name)."""
    n_rep = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    aten = torch.ops.aten
    calls = (("_scaled_dot_product_flash_attention",
              lambda: aten._scaled_dot_product_flash_attention(q, ke, ve, 0.0, causal)[:2]),
             ("_scaled_dot_product_efficient_attention",
              lambda: aten._scaled_dot_product_efficient_attention(
                  q, ke, ve, None, True, 0.0, causal)[:2]))
    for name, call in calls:
        try:
            call()
            return call, name
        except RuntimeError as err:      # the backend refuses these inputs
            say(f"    {name}: {str(err).splitlines()[0][:120]}")
    raise AssertionError("no aten attention call returns the logsumexp for these inputs")


# ------------------------------- phase 2 --------------------------------------
FLASH_KERNELS = {"flash_fwd_kernel": 0, "flash_bwd_dkv_kernel": 1,
                 "flash_bwd_dq_kernel": 2, "flash_bwd_dkv_cluster_kernel": 3,
                 "flash_fwd_group_kernel": 4, "flash_bwd_dq_group_kernel": 5}
#: flash_attention_smem_bytes's id of the forward's three-warpgroup form
#: (hd 64 without LSE)
FLASH_FWD_WG3 = 6


def ptxas_report(log: str, entry: str, label, extra=lambda m: {}) -> dict:
    """Registers and spilled bytes per kernel instantiation, from ``nvcc
    -Xptxas -v``: each entry function whose mangled name matches the regex
    ``entry``, keyed by ``label(match)``, with ``extra(match)`` beside."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?" + entry, line)
        if m:
            name = label(m)
            out[name] = extra(m)
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name]["spill_bytes"] = int(st) + int(ld)
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
            name = None
    return out


#: Mangled entry names of the SSD kernel: ssd_chunk_kernel<T, NP>.
SSD_ENTRY = r"ssd_chunk_kernelI(13__nv_bfloat16|f)Li(\d+)E"


#: Mangled entry names of the RMSNorm kernel: rmsnorm_kernel<Elt, VW, PER,
#: GATE>, Elt bf16 or float.
RMSNORM_ENTRY = r"rmsnorm_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb([01])E"
#: its instantiations: (VW, PER) = (8, 1), (8, 2), (8, 4) and (1, 4), each
#: with and without the gate but (8, 4), in bf16 and in float32
RMSNORM_BUILDS = 14


def elt_label(mangled: str) -> str:
    return "f32" if mangled == "f" else "bf16"


def rmsnorm_label(m) -> str:
    return (f"rmsnorm<{elt_label(m.group(1))}, vw {m.group(2)}, per {m.group(3)}"
            f"{', gated' if m.group(4) == '1' else ''}>")


#: Mangled entry names of the RMSNorm backward: rmsnorm_bwd_kernel<Elt, VW,
#: PER, GATE> ((8, 1), (8, 2) and (1, 4), each with and without the gate, in
#: bf16 and float32) and rmsnorm_dw_kernel, which sums dw's per-block shares.
RMSNORM_BWD_ENTRY = (r"rmsnorm_(bwd_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb([01])E"
                     r"|dw_kernel)")
RMSNORM_BWD_BUILDS = 13


def rmsnorm_bwd_label(m) -> str:
    if m.group(2) is None:
        return "rmsnorm_dw"
    return (f"rmsnorm_bwd<{elt_label(m.group(2))}, vw {m.group(3)}, per {m.group(4)}"
            f"{', gated' if m.group(5) == '1' else ''}>")


#: Mangled entry names of the split-row norm's kernels (rmsnorm_split.cu):
#: split_{stat,apply,bwd_stat,bwd_apply}_kernel<Elt, VE, ZB> and
#: split_dw_kernel, which sums dw's per-block shares.
RMSNORM_SPLIT_ENTRY = (r"split_(?:(bwd_)?(stat|apply)_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E"
                       r"|dw_kernel)")
#: its instantiations: each of the four kernels on 16-byte vectors with the
#: gate in 16-, 8-, 4- and (bf16) 2-byte loads, and on the scalar path, in
#: bf16 and float32 (4 x (5 + 4)), and the dw kernel
RMSNORM_SPLIT_BUILDS = 37


def rmsnorm_split_label(m) -> str:
    if m.group(2) is None:
        return "split_dw"
    return (f"split_{m.group(1) or ''}{m.group(2)}<{elt_label(m.group(3))}, "
            f"ve {m.group(4)}, gate {m.group(5)} B>")


#: Mangled entry names of the decode kernels: decode_attention_kernel<HD,
#: NREP> (hd 32, 128) and decode_attention_lanes_kernel<HD, NREP> (hd 16,
#: 64); a parent's decode_attention_hd16_kernel<NREP> (tools/kernel_compare.py)
#: reads as hd 16 (groups 1 and 2 None)
DECODE_ENTRY = (r"decode_attention_(?:kernelILi(\d+)E|lanes_kernelILi(\d+)E|hd16_kernelI)"
                r"Li(\d+)E")
#: their instantiations: hd 16, 32, 64, 128, each at NREP 1, 2, 3, 4, 8
DECODE_BUILDS = 20
#: the forward with and without LSE (at hd 64 without it in its
#: three-warpgroup form), dK/dV and dQ at hd 32, 64 and 128, and kernels of
#: their own at hd 16: the grouped forward (with and without LSE), the
#: cluster dK/dV and the grouped dQ
FLASH_BUILDS = 16
#: the float32 decode kernel, decode_f32_kernel<HD, NREP, KV> (hd 16, 32,
#: 64, 128; NREP 1, 2, 3, 4, 8; a float32 or a bf16 cache), and the float32
#: flash kernels
DECODE_F32_ENTRY = r"decode_f32_kernelILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E"
DECODE_F32_BUILDS = 40
FLASH_F32_KERNELS = {"flash_fwd_f32_kernel": 0, "flash_bwd_dkv_f32_kernel": 1,
                     "flash_bwd_dq_f32_kernel": 2}
FLASH_F32_BUILDS = 16


def decode_label(m) -> str:
    if m.group(1):
        return f"decode<{m.group(1)}, {m.group(3)}>"
    if m.group(2):
        return f"decode_lanes<{m.group(2)}, {m.group(3)}>"
    return f"decode_hd16<{m.group(3)}>"


def decode_build_report(log: str) -> dict:
    """Per decode kernel instantiation (``decode<hd, nrep>``,
    ``decode_lanes<hd, nrep>``): :func:`ptxas_report` and the dynamic
    shared memory of a block."""
    return ptxas_report(log, DECODE_ENTRY, decode_label, lambda m: {
        "smem_bytes": decode_plan(1, int(m.group(3)), 1,
                                  int(m.group(1) or m.group(2) or 16))["smem_bytes"]})


def decode_f32_label(m) -> str:
    return f"decode_f32<{m.group(1)}, {m.group(2)}, {elt_label(m.group(3))} cache>"


def decode_f32_build_report(log: str) -> dict:
    """Per float32 decode kernel instantiation (``decode_f32<hd, nrep,
    cache>``): :func:`ptxas_report` and the dynamic shared memory of a
    block."""
    import torch

    return ptxas_report(log, DECODE_F32_ENTRY, decode_f32_label, lambda m: {
        "smem_bytes": decode_plan(1, int(m.group(2)), 1, int(m.group(1)),
                                  torch.float32 if m.group(3) == "f"
                                  else torch.bfloat16)["smem_bytes"]})


def flash_f32_build_report(log: str) -> dict:
    """Per float32 flash kernel instantiation (``kernel<hd[, lse]>``):
    :func:`ptxas_report` and the dynamic shared memory a launch takes."""
    import ctypes

    from repro_torch.kernels import _build

    smem = _build.bind("flash_attention_f32", "flash_attention_f32_smem_bytes",
                       [ctypes.c_int, ctypes.c_int])
    return ptxas_report(
        log, r"(" + "|".join(FLASH_F32_KERNELS) + r")ILi(\d+)E(Lb(\d)E)?",
        lambda m: f"{m.group(1)}<{m.group(2)}{', lse' if m.group(4) == '1' else ''}>",
        lambda m: {"smem_bytes": smem(FLASH_F32_KERNELS[m.group(1)], int(m.group(2)))})


def ssd_label(m) -> str:
    return f"ssd<{'bf16' if m.group(1) != 'f' else 'f32'}, {m.group(2)}>"


def flash_build_report(log: str) -> dict:
    """Per flash-attention kernel instantiation (``kernel<hd[, lse]>``):
    :func:`ptxas_report` (registers at entry: consumers get more through
    setmaxnreg) and the dynamic shared memory a launch takes, from the
    library."""
    import ctypes

    from repro_torch.kernels import _build

    smem = _build.bind("flash_attention", "flash_attention_smem_bytes",
                       [ctypes.c_int, ctypes.c_int])
    return ptxas_report(
        log, r"(" + "|".join(FLASH_KERNELS) + r")ILi(\d+)E(Lb(\d)E)?",
        lambda m: f"{m.group(1)}<{m.group(2)}{', lse' if m.group(4) == '1' else ''}>",
        lambda m: {"smem_bytes": smem(
            FLASH_FWD_WG3 if (m.group(1), m.group(2), m.group(4)) == ("flash_fwd_kernel", "64", "0")
            else FLASH_KERNELS[m.group(1)], int(m.group(2)))})


def ssd_build_report(log: str) -> dict:
    """Per SSD kernel instantiation (``ssd<dtype, NP>``, NP the padded N):
    :func:`ptxas_report` and the dynamic shared memory a launch at P = 64
    takes, from the library."""
    import ctypes

    from repro_torch.kernels import _build

    smem = _build.bind("ssd", "ssd_smem_bytes", [ctypes.c_int] * 3)
    return ptxas_report(log, SSD_ENTRY, ssd_label, lambda m: {
        "smem_bytes_p64": smem(64, int(m.group(2)), int(m.group(1) != "f"))})


#: phase 2's ptxas readings: each family's columns, and its count of kernels
BUILD_COLUMNS = {
    "rmsnorm": "registers, spilled bytes, static shared memory",
    "rmsnorm_bwd": "registers, spilled bytes, static shared memory",
    "rmsnorm_split": "registers, spilled bytes, static shared memory",
    "flash_attention": "registers at entry, spilled bytes, dynamic shared memory",
    "decode_attention": "registers, spilled bytes, dynamic shared memory",
    "flash_attention_f32": "registers, spilled bytes, shared memory",
    "decode_attention_f32": "registers, spilled bytes, dynamic shared memory",
    "ssd": "registers, spilled bytes, dynamic shared memory at P = 64"}
BUILD_COUNTS = {"rmsnorm": RMSNORM_BUILDS, "rmsnorm_bwd": RMSNORM_BWD_BUILDS,
                "rmsnorm_split": RMSNORM_SPLIT_BUILDS,
                "flash_attention": FLASH_BUILDS, "decode_attention": DECODE_BUILDS,
                "flash_attention_f32": FLASH_F32_BUILDS,
                "decode_attention_f32": DECODE_F32_BUILDS, "ssd": 4}


def build_reports(logs: dict[str, str]) -> tuple[dict[str, dict], list[str]]:
    """Phase 2: each kernel family's instantiations as ptxas reported them
    in ``logs`` (``_build.build_all``'s), and the faults: a family with
    another count of kernels than BUILD_COUNTS, or one that spilled."""
    reports = {
        "rmsnorm": ptxas_report(logs["rmsnorm"], RMSNORM_ENTRY, rmsnorm_label),
        "rmsnorm_bwd": ptxas_report(logs["rmsnorm"], RMSNORM_BWD_ENTRY, rmsnorm_bwd_label),
        "rmsnorm_split": ptxas_report(logs["rmsnorm_split"], RMSNORM_SPLIT_ENTRY,
                                      rmsnorm_split_label),
        "flash_attention": flash_build_report(logs["flash_attention"]),
        "decode_attention": decode_build_report(logs["decode_attention"]),
        "flash_attention_f32": flash_f32_build_report(logs["flash_attention_f32"]),
        "decode_attention_f32": decode_f32_build_report(logs["decode_attention_f32"]),
        "ssd": ssd_build_report(logs["ssd"])}
    faults = []
    for name, report in reports.items():
        spilled = [k for k, v in report.items() if v.get("spill_bytes", 1)]
        if len(report) != BUILD_COUNTS[name] or spilled:
            faults.append(f"{name} build: {len(report)} of {BUILD_COUNTS[name]} "
                          f"kernels, spills in {spilled}")
    return reports, faults


# ------------------------------- phase 3 --------------------------------------
def flash_cases(B, H, Hkv, S, hd):
    """The serving forward's cases, (label, (B, H, Hkv, Sq, Sk, hd, causal)):
    the mistral prefill, the minitron_4b prefill (GQA group 3), ragged
    lengths, and the edges of the kernel's 128-row blocks and 128-key tiles
    (127, 128, 129, 257), Sq > Sk causal, n_rep 4, hd 32, 64 and 128."""
    return (("serve", (B, H, Hkv, S, S, hd, True)),
            ("gqa3-minitron", (B, 24, 8, S, S, 128, True)),
            ("ragged-causal", (2, H, Hkv, 1000, 1000, hd, True)),
            ("ragged-full", (1, 8, 2, 70, 130, 64, False)),
            ("ragged-causal-sq>sk", (2, 4, 2, 130, 70, 32, True)),
            ("edge-127", (1, 8, 2, 127, 127, 128, True)),
            ("edge-128", (1, 8, 2, 128, 128, 64, True)),
            ("edge-129", (1, 8, 2, 129, 129, 32, True)),
            ("edge-257", (2, 8, 2, 257, 257, 128, True)),
            ("edge-257-full", (1, 8, 2, 257, 257, 64, False)),
            ("edge-sq>sk", (1, 8, 2, 300, 129, 128, True)))


# Decode attention's phase-3 cases, (label, (B, H, Hkv, S, hd, kv_len)): the
# serving cache of mistral_nemo_12b (B, S, Hkv, hd) = (4, 2081, 8, 128) read
# transposed at the last and the first decode step's kv_len, kv_len 0, 1 and
# S; ragged shapes; GQA group 3 (minitron_4b's 24/8 heads, compiled as it
# is), 8 (command_r_35b's 64/8) and 16 (qwen3_moe_235b's 64/4, in chunks of 8
# heads).
def decode_cases() -> tuple:
    s = PROMPT_LEN + NEW_TOKENS + 1
    last = PROMPT_LEN + NEW_TOKENS - 1
    return (("serve", (REQUESTS, 32, 8, s, 128, last)),
            ("serve-first", (REQUESTS, 32, 8, s, 128, PROMPT_LEN + 1)),
            ("kv_len 0", (REQUESTS, 32, 8, s, 128, 0)),
            ("kv_len 1", (REQUESTS, 32, 8, s, 128, 1)),
            ("kv_len S", (REQUESTS, 32, 8, s, 128, s)),
            ("ragged", (3, 8, 2, 37, 64, 29)),
            ("ragged-mha", (2, 4, 4, 300, 32, 300)),
            ("gqa3-minitron", (REQUESTS, 24, 8, s, 128, last)),
            ("gqa8-command_r", (REQUESTS, 64, 8, s, 128, last)),
            ("gqa16", (2, 64, 4, 600, 128, 577)))


#: the cases also run through one captured launch replayed at other kv_len
DECODE_REPLAYED = ("serve", "gqa3-minitron", "gqa8-command_r", "gqa16")

#: Row 2 on one rank's block of a context-parallel cache (phase 20b): the
#: mistral serving cache's sequence halved over a model axis of 2, (B, H,
#: Hkv, S_local, hd, local kv_len), the block full, empty (a rank whose block
#: lies past the prefix: the kernel gives o 0 and lse -1e30, its plain
#: version NaN, and the merge masks both) and ragged; the LSE is what the
#: merge reads, so it is held against the plain version's too.
CP_DECODE_S = -(-(PROMPT_LEN + NEW_TOKENS + 1) // 2)
CP_DECODE_CASES = (("cp block full", (REQUESTS, 32, 8, CP_DECODE_S, 128, CP_DECODE_S)),
                   ("cp block empty", (REQUESTS, 32, 8, CP_DECODE_S, 128, 0)),
                   ("cp block ragged", (REQUESTS, 32, 8, CP_DECODE_S, 128, 517)))

#: Cross-attention's shapes, held and timed in phase 3: the flash forward
#: without the mask (label, (B, H, Hkv, Sq, Sk, hd, causal)) over the VLM's
#: 1601 image tokens; decode attention (label, (B, H, Hkv, S, hd, kv_len))
#: over the whole memory, its K/V a (B, M, Hkv, hd) projection read
#: transposed. SeamlessM4T's (hd 64) are SEAMLESS_*_CASES.
MEMORY_FLASH_CASES = (("vision cross", (REQUESTS, 32, 8, PROMPT_LEN, 1601, 128, False)),)
MEMORY_DECODE_CASES = (("vision cross", (REQUESTS, 32, 8, 1601, 128, 1601)),)
#: SeamlessM4T-medium's attention (MHA 16/16 at hd 64), phase 15's shapes,
#: held and timed by :func:`check_hd64`: the flash forward without the mask
#: over the encoder's 1024 frames (the decoder's cross-attention), the
#: encoder's own 1024², the decoder's causal 2048²; decode over the memory
#: and over the decoder's serving cache at the last step's kv_len.
SEAMLESS_FLASH_CASES = (("seamless cross", (REQUESTS, 16, 16, PROMPT_LEN, 1024, 64, False)),
                        ("seamless encoder", (REQUESTS, 16, 16, 1024, 1024, 64, False)),
                        ("seamless self", (REQUESTS, 16, 16, PROMPT_LEN, PROMPT_LEN, 64, True)))
SEAMLESS_DECODE_CASES = (("seamless cross", (REQUESTS, 16, 16, 1024, 64, 1024)),
                         ("seamless self", (REQUESTS, 16, 16, PROMPT_LEN + NEW_TOKENS + 1, 64,
                                            PROMPT_LEN + NEW_TOKENS - 1)))
#: The hd-64 forward's edges beyond those, (label, (B, H, Hkv, Sq, Sk,
#: causal)): Sq off the 192-row items and Sk off the 128-key tiles, Sq != Sk
#: both ways, GQA groups 1, 3, 4 and 16 (the kernel reads kv head h // n_rep)
HD64_FLASH_EDGES = (("edge-191", (1, 8, 2, 191, 191, True)),
                    ("edge-193", (1, 8, 8, 193, 193, True)),
                    ("edge-385-full", (1, 4, 4, 385, 300, False)),
                    ("causal-sq>sk", (2, 4, 2, 300, 129, True)),
                    ("causal-sq<sk", (1, 4, 4, 129, 300, True)),
                    ("gqa3-ragged", (2, 6, 2, 1000, 1000, True)),
                    ("gqa16", (1, 64, 4, 200, 200, True)))
#: kv_len at the hd-64 decode's 32-key tile edges, two tiles' and four's,
#: and the caches' ends, each replayed through one captured launch
HD64_DECODE_LENS = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1024, 2079, 2081)
#: a SeamlessM4T decode step's attention launches, each layer's
#: self-attention then its cross-attention, over caches of their own
SEAMLESS_STEP_LAYERS = 12
#: command_r_35b's attention on its serving path (phases 26-27), held and
#: timed in phase 3: GQA group 8 at hd 128 (64 query heads over 8 KV heads),
#: the prefill's causal forward and decode over the serving cache at the last
#: step's kv_len (also among decode_cases, replayed at other kv_len)
COMMAND_R_FLASH_CASES = (("command_r_35b prefill",
                          (REQUESTS, 64, 8, PROMPT_LEN, PROMPT_LEN, 128, True)),)
COMMAND_R_DECODE_CASES = (("command_r_35b decode",
                           (REQUESTS, 64, 8, PROMPT_LEN + NEW_TOKENS + 1, 128,
                            PROMPT_LEN + NEW_TOKENS - 1)),)
# Each decode output within one bf16 ulp of its f64 value, plus this share
# of the largest |o|: the kernel's f32 arithmetic is ~1e-7 of the largest
# output, its rounding to bf16 half an ulp; a P rounded once to bf16 moves
# an output by ~1e-3 of the typical one, many ulps of the small ones.
DECODE_ULP_FLOOR = 2.0 ** -14


def decode_inputs(torch, g, shape):
    """Seeded bf16 q (B, H, hd) and the cache (B, S, Hkv, hd) handed over as
    (B, Hkv, S, hd) views, as the model passes it."""
    b, h, hkv, s, hd, _ = shape

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda").to(torch.bfloat16)
    return randn(b, h, hd), randn(b, s, hkv, hd).transpose(1, 2), \
        randn(b, s, hkv, hd).transpose(1, 2)


def decode_exact(torch, q, k, v, kv_len: int):
    """Decode attention over [0, kv_len) in float64: (o, lse)."""
    rep = q.shape[1] // k.shape[1]
    kk = k[:, :, :kv_len].double().repeat_interleave(rep, 1)
    vv = v[:, :, :kv_len].double().repeat_interleave(rep, 1)
    s = torch.einsum("bhd,bhkd->bhk", q.double(), kk) / q.shape[-1] ** 0.5
    lse = torch.logsumexp(s, -1)
    return torch.einsum("bhk,bhkd->bhd", torch.exp(s - lse[..., None]), vv), lse


def bf16_ulp(torch, x):
    """The bf16 unit in the last place at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def decode_check(torch, q, k, v, kv_len: int, o, lse, label: str,
                 check: bool = True) -> dict:
    """One decode call's outputs held: at kv_len 0, o = 0 and lse = -1e30;
    otherwise o within DECODE_REL x max |plain| of the plain version (f32)
    and element by element within one bf16 ulp + DECODE_ULP_FLOOR x max |o|
    of the f64 value, lse within 1e-3. Returns the readings; with ``check``
    raises on a failure."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    torch.cuda.synchronize()
    kv_len = max(0, min(kv_len, k.shape[2]))
    if kv_len == 0:
        zero = bool((o == 0).all()) and bool((lse == -1e30).all())
        if check and not zero:
            raise AssertionError(f"{label}: kv_len 0 must give o = 0, lse = -1e30")
        return {"o_err": 0.0 if zero else float("inf"), "lse_err": 0.0,
                "ulp_excess": 0.0 if zero else float("inf")}
    orf, lser = decode_attention_ref(q, k, v, kv_len, return_lse=True)
    o64, lse64 = decode_exact(torch, q, k, v, kv_len)
    finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
    err = (o.float() - orf.float()).abs().max().item()
    lim = DECODE_REL * orf.float().abs().max().item()
    lse_err = (lse.double() - lse64).abs().max().item()
    lse_lim = 1e-3 * max(1.0, lse64.abs().max().item())
    off = (o.double() - o64).abs()
    allowed = bf16_ulp(torch, o64) + DECODE_ULP_FLOOR * o64.abs().max()
    out = {"o_err": err if finite else float("inf"), "o_lim": lim,
           "lse_err": lse_err if finite else float("inf"),
           "ulp_excess": (off / allowed).max().item() if finite else float("inf"),
           "ulp_outside": int((off > allowed).sum())}
    if check:
        if not (finite and err <= lim):
            raise AssertionError(f"{label}: finite {finite}, max |kernel - plain| "
                                 f"{err:.3g} > {lim:.3g} ({DECODE_REL:g} x max |plain|)")
        if not lse_err <= lse_lim:
            raise AssertionError(f"{label}: lse error {lse_err:.3g}")
        if out["ulp_outside"]:
            raise AssertionError(
                f"{label}: {out['ulp_outside']} outputs further than one bf16 ulp + "
                f"{DECODE_ULP_FLOOR:g} x max |o| from the f64 value (worst "
                f"{out['ulp_excess']:.3g} x the allowance)")
    return out


def decode_replay_check(torch, fn, q, k, v, lens, label: str,
                        check: bool = True, hold=None) -> dict:
    """``fn(q, k, v, kv_len)`` captured once into a CUDA graph with a device
    kv_len, then replayed with kv_len set on the device to each of ``lens``
    (clamped to [0, S] by the kernel); each replay held by ``hold`` (by
    default :func:`decode_check`). Returns {kv_len: readings}."""
    hold = hold or decode_check
    kl = torch.zeros(1, dtype=torch.int32, device=q.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture
        fn(q, k, v, kl)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = fn(q, k, v, kl)
    out = {}
    for n in lens:
        kl.fill_(n)
        graph.replay()
        out[n] = hold(torch, q, k, v, n, o, lse, f"{label} at kv_len {n}", check)
    return out


def decode_plan(b: int, h: int, hkv: int, hd: int, cache=None) -> dict:
    from repro_torch.kernels.decode_attention.ops import plan
    return plan(b, h, hkv, hd, cache)


def check_hd64(torch, timer, probe) -> dict:
    """SeamlessM4T's attention at hd 64 (the flash forward's three-warpgroup
    form, the lanes decode): the flash forward at SEAMLESS_FLASH_CASES and HD64_FLASH_EDGES (element-wise at
    TOL, each query row within TRAIN_ROW_REL, two calls the same bits),
    decode at SEAMLESS_DECODE_CASES, the contract's decode cases at hd 64
    and every GQA group at the tile's edges (:func:`decode_check`), the
    seamless shapes' captured launch replayed at HD64_DECODE_LENS. Each
    seamless shape timed beside its bounds (bytes or operations, and the
    exponentials), the plain version and SDPA; decode also as one step's
    2 x SEAMLESS_STEP_LAYERS launches over caches of their own in one graph,
    the L2 flushed by a read before it, beside an empty kernel's graph and
    SDPA's. Returns {"flash_attention[bf16/hd64]": ..,
    "decode_attention[bf16/hd64]": ..}, each with the cross shape's numbers
    on top and every seamless shape's under "shapes"."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 64)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    # ---- the flash forward
    errs, rows, shapes = [], [], {}
    cases = [(label, s[:5] + s[6:]) for label, s in SEAMLESS_FLASH_CASES] + list(HD64_FLASH_EDGES)
    for label, (b, h, hkv, sq, sk, causal) in cases:
        qa, ka, va = randn(b, sq, h, 64), randn(b, sk, hkv, 64), randn(b, sk, hkv, 64)
        args = (qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2))
        o = flash_attention(*args, causal=causal)
        want = flash_attention_ref(*args, causal=causal)
        name = f"flash[bf16/hd64] {label}"
        errs.append(compare(torch, o, want, name))
        rows.append(row_scaled_errs(o, want)[1])
        if not rows[-1] <= TRAIN_ROW_REL:
            raise AssertionError(f"{name}: a row's max |kernel - plain| is {rows[-1]:.3g} x "
                                 f"its max |plain| (limit {TRAIN_ROW_REL:g})")
        if not torch.equal(o, flash_attention(*args, causal=causal)):
            raise AssertionError(f"{name}: two calls gave different bits")
        del o, want
        if not label.startswith("seamless"):
            continue
        b_ms, b_by = cost.flash_attention(b, h, hkv, sq, sk, 64, causal).bound_ms()
        shapes[label] = dict(
            max_abs_err=errs[-1], max_row_scaled_err=rows[-1],
            ms=timer.ms(lambda: flash_attention(*args, causal=causal), 20),
            plain_ms=timer.ms(lambda: flash_attention_ref(*args, causal=causal), 3),
            library_ms=timer.ms(lambda: sdpa(F, *args, causal=causal), 20),
            bound_ms=b_ms, bound_by=b_by,
            exp_bound_ms=cost.exponentials("flash_attention", b, h, hkv, sq, sk, 64,
                                           causal).bound_ms()[0],
            shape=[b, h, hkv, sq, sk, 64, causal])
        say(f"  flash_attention[bf16/hd64] {label}: {json.dumps(shapes[label])}")
        del qa, ka, va, args
    flash = dict(shapes["seamless cross"], max_abs_err=max(errs), max_row_scaled_err=max(rows),
                 row_scaled_err_limit=TRAIN_ROW_REL, shapes=shapes)

    # ---- decode
    errs, ulps, shapes = [], [], {}
    group_cases = [(f"gqa{n} kv_len {kv}", (2, 2 * n, 2, 300, 64, kv))
                   for n in (1, 2, 3, 4, 8, 16) for kv in (0, 1, 31, 32, 33, 64, 65, 300)]
    contract = [(label, (b, h, hkv, s, 64, kv))
                for label, (b, h, hkv, s, kv) in contract_decode_cases(64, "bf16")]
    for label, shape in (*SEAMLESS_DECODE_CASES, *contract, *group_cases):
        q, k, v = decode_inputs(torch, g, shape)
        kv_len = shape[-1]
        kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
        o, lse = decode_attention(q, k, v, kl)
        r = decode_check(torch, q, k, v, kv_len, o, lse, f"decode[bf16/hd64] {label}")
        errs.append(r["o_err"])
        ulps.append(r["ulp_excess"])
        del o, lse
        if not label.startswith("seamless"):
            continue
        reps = decode_replay_check(torch, decode_attention, q, k, v, HD64_DECODE_LENS,
                                   f"decode[bf16/hd64] {label} replayed")
        errs += [x["o_err"] for x in reps.values()]
        ulps += [x["ulp_excess"] for x in reps.values()]
        b, h, hkv, s, hd, _ = shape
        kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
        b_ms, b_by = cost.decode_attention(b, h, hkv, hd, kv_len).bound_ms()
        shapes[label] = dict(
            max_abs_err=r["o_err"], max_ulp_excess=r["ulp_excess"],
            replayed_at=list(HD64_DECODE_LENS),
            ms=timer.ms(lambda: decode_attention(q, k, v, kl), 200),
            plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kl, return_lse=True), 20),
            library_ms=timer.ms(lambda: sdpa(F, q[:, :, None], kc, vc, causal=False), 200),
            bound_ms=b_ms, bound_by=b_by,
            exp_bound_ms=cost.exponentials("decode_attention", b, h, hkv, hd,
                                           kv_len).bound_ms()[0],
            plan=decode_plan(b, h, hkv, hd), shape=list(shape))
        say(f"  decode_attention[bf16/hd64] {label}: {json.dumps(shapes[label])}")
        del q, k, v, kc, vc
    decode = dict(shapes["seamless cross"], max_abs_err=max(errs), max_ulp_excess=max(ulps),
                  shapes=shapes, step_graph=seamless_step_graph(torch, timer, probe))
    say(f"  decode_attention[bf16/hd64] a step's launches in one graph: "
        f"{json.dumps(decode['step_graph'])}")
    say(f"  launches a phase-15 run by shape, as the config gives them (phase 15 "
        f"counts them by kind): flash {json.dumps(SEAMLESS_FLASH_LAUNCHES)}, decode "
        f"{json.dumps(SEAMLESS_DECODE_LAUNCHES)}")
    return {"flash_attention[bf16/hd64]": flash, "decode_attention[bf16/hd64]": decode}


#: each seamless shape's launches a phase-15 run (4 x 2048 + 32 tokens:
#: 12 encoder layers, 12 decoder layers, 31 decode steps), as the config
#: gives them: printed beside phase 3's readings, never in the kernels
#: line (phase 15 counts the launches by kind, not by shape)
SEAMLESS_FLASH_LAUNCHES = {"seamless cross": 12, "seamless encoder": 12, "seamless self": 12}
SEAMLESS_DECODE_LAUNCHES = {"seamless cross": 12 * (NEW_TOKENS - 1),
                            "seamless self": 12 * (NEW_TOKENS - 1)}


def seamless_step_graph(torch, timer, probe) -> dict:
    """One SeamlessM4T decode step's attention launches, each layer's
    self-attention (over its own serving cache at the last step's kv_len)
    then its cross-attention (over its own memory), captured in one graph
    and replayed after a read of the flush buffer: ``graph_ms`` for the
    step's 2 x SEAMLESS_STEP_LAYERS launches, beside the summed bytes bound,
    SDPA's graph over the same inputs and an empty kernel's (the decode
    launch's block count and threads, the floor under a launch in a
    graph); ``self_graph_ms`` and ``cross_graph_ms`` each shape's launches
    alone, a graph each."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, cost
    from repro_torch.kernels.decode_attention.ops import decode_attention, plan

    g = torch.Generator(device="cuda").manual_seed(SEED + 65)
    steps = []
    for _ in range(SEAMLESS_STEP_LAYERS):
        for _, shape in reversed(SEAMLESS_DECODE_CASES):    # self, then cross
            q, k, v = decode_inputs(torch, g, shape)
            kl = torch.full((1,), shape[-1], dtype=torch.int32, device="cuda")
            steps.append((q, k, v, kl, shape))
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # noqa: E731
    blocks = [plan(*s[:3], s[4]) for *_, s in steps]

    def empty():
        for pl in blocks:
            _build.check("decode_attention", probe.empty_launch(
                pl["n_split"] * pl["groups"], DECODE_LANES_THREADS, stream()))
    bound = sum(cost.decode_attention(*s[:3], s[4], s[5]).bound_ms()[0] for *_, s in steps)
    out = dict(
        launches=len(steps),
        graph_ms=timer.ms(lambda: [decode_attention(q, k, v, kl) for q, k, v, kl, _ in steps],
                          20, clean_l2=True),
        # each shape's launches alone, one graph each
        **{f"{label.split()[-1]}_graph_ms": timer.ms(
            lambda i=i: [decode_attention(q, k, v, kl) for q, k, v, kl, _ in steps[i::2]],
            20, clean_l2=True) for i, (label, _) in enumerate(reversed(SEAMLESS_DECODE_CASES))},
        library_graph_ms=timer.ms(
            lambda: [sdpa(F, q[:, :, None], k[:, :, :s[5]], v[:, :, :s[5]], causal=False)
                     for q, k, v, _, s in steps], 20, clean_l2=True),
        empty_graph_ms=timer.ms(empty, 20, clean_l2=True), bound_ms=bound)
    out["share_of_bound"] = bound / out["graph_ms"]
    del steps
    return out


def check_kernels(torch, timer) -> dict:
    """Decode and flash attention against their plain versions at the
    serving shapes and at ragged ones; times at the heaviest serving
    shape."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = get_config("mistral_nemo_12b")
    B, S = REQUESTS, PROMPT_LEN
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    out = {}

    # ---- decode attention: every phase-3 case (decode_cases), each called
    # eagerly with a device kv_len and through one captured launch replayed
    # with kv_len changed between replays; times at the serving shape
    errs, ulps = [], []
    for label, shape in decode_cases():
        q, k, v = decode_inputs(torch, g, shape)
        kv_len = shape[-1]
        o, lse = decode_attention(q, k, v, torch.full((1,), kv_len, dtype=torch.int32,
                                                      device=dev))
        r = decode_check(torch, q, k, v, kv_len, o, lse, f"decode {label}")
        errs.append(r["o_err"])
        ulps.append(r["ulp_excess"])
        say(f"  decode_attention {label} q {tuple(q.shape)} cache "
            f"{(shape[0], shape[3], shape[2], shape[4])} kv_len {kv_len}: {json.dumps(r)}")
        if label in DECODE_REPLAYED:
            lens = (0, 1, 17, kv_len // 2, kv_len, shape[3], shape[3] + 100)
            reps = decode_replay_check(torch, decode_attention, q, k, v, lens,
                                       f"decode {label} replayed")
            errs += [x["o_err"] for x in reps.values()]
            ulps += [x["ulp_excess"] for x in reps.values()]
            say(f"    one captured launch replayed at kv_len {lens}: max|err| o "
                f"{max(x['o_err'] for x in reps.values()):.3g}, lse "
                f"{max(x['lse_err'] for x in reps.values()):.3g}")
        if label == "serve":
            main = (q, k, v, kv_len)
        del q, k, v, o, lse
    q, k, v, kv_len = main
    b, h, hd = q.shape
    hkv = k.shape[1]
    kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
    b_ms, b_by = cost.decode_attention(b, h, hkv, hd, kv_len).bound_ms()

    def sdpa_decode():
        return sdpa(F, q[:, :, None], kc, vc, causal=False)
    out["decode_attention"] = dict(
        max_abs_err=max(errs), max_ulp_excess=max(ulps),
        ms=timer.ms(lambda: decode_attention(q, k, v, kl), 200),
        plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kl,
                                                       return_lse=True), 20),
        library_ms=timer.ms(sdpa_decode, 200),
        bound_ms=b_ms, bound_by=b_by, plan=decode_plan(b, h, hkv, hd),
        clean_l2={"ms": timer.ms(lambda: decode_attention(q, k, v, kl), 200, True),
                  "library_ms": timer.ms(sdpa_decode, 200, True)},
        shape=[b, h, hkv, k.shape[2], hd, kv_len])
    say(f"  decode_attention serve {out['decode_attention']}")
    del q, k, v, kc, vc, main
    for group, cases in (("memory_shapes", MEMORY_DECODE_CASES),
                         ("command_r_35b", COMMAND_R_DECODE_CASES)):
        out["decode_attention"][group] = shapes = {}
        for label, shape in cases:
            q, k, v = decode_inputs(torch, g, shape)
            mb, mh, mhkv, m, mhd, kv_len = shape
            kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
            kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
            o, lse = decode_attention(q, k, v, kl)
            r = decode_check(torch, q, k, v, kv_len, o, lse, f"decode {label}")
            b_ms, b_by = cost.decode_attention(mb, mh, mhkv, mhd, kv_len).bound_ms()
            shapes[label] = dict(
                max_abs_err=r["o_err"], max_ulp_excess=r["ulp_excess"],
                ms=timer.ms(lambda: decode_attention(q, k, v, kl), 200),
                plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kl,
                                                               return_lse=True), 20),
                library_ms=timer.ms(lambda: sdpa(F, q[:, :, None], kc, vc,
                                                 causal=False), 200),
                bound_ms=b_ms, bound_by=b_by, plan=decode_plan(mb, mh, mhkv, mhd),
                shape=list(shape))
            say(f"  decode_attention {label} q {tuple(q.shape)} cache {(mb, m, mhkv, mhd)} "
                f"kv_len {kv_len}: {json.dumps(shapes[label])}")
            del q, k, v, kc, vc, o, lse
    out["decode_attention"]["context_parallel_shapes"] = shapes = {}
    for label, shape in CP_DECODE_CASES:
        q, k, v = decode_inputs(torch, g, shape)
        mb, mh, mhkv, m, mhd, kv_len = shape
        kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        o, lse = decode_attention(q, k, v, kl)
        r = decode_check(torch, q, k, v, kv_len, o, lse, f"decode {label}")
        _, lse_plain = decode_attention_ref(q, k, v, kl, return_lse=True)
        if kv_len:
            lse_err = (lse - lse_plain).abs().max().item()
            if not lse_err <= 1e-3 * max(1.0, lse_plain.abs().max().item()):
                raise AssertionError(f"decode {label}: lse vs plain {lse_err:.3g}")
        else:
            lse_err = 0.0       # held by decode_check: lse -1e30, o 0
        b_ms, b_by = cost.decode_attention(mb, mh, mhkv, mhd, kv_len).bound_ms()
        kc, vc = k[:, :, :kv_len], v[:, :, :kv_len]
        shapes[label] = dict(
            max_abs_err=r["o_err"], max_ulp_excess=r["ulp_excess"],
            lse_vs_plain=lse_err,
            ms=timer.ms(lambda: decode_attention(q, k, v, kl), 200),
            plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kl,
                                                           return_lse=True), 20),
            library_ms=(timer.ms(lambda: sdpa(F, q[:, :, None], kc, vc, causal=False), 200)
                        if kv_len else None),
            bound_ms=b_ms, bound_by=b_by, shape=list(shape))
        say(f"  decode_attention {label} q {tuple(q.shape)} cache block "
            f"{(mb, m, mhkv, mhd)}: {json.dumps(shapes[label])}")
        del q, k, v, o, lse, kc, vc

    # ---- flash attention: the prefill's (B, S, H, hd) activations, read
    # transposed; ragged lengths and the 128-row / 128-key tile edges;
    # element-wise and each query row within TRAIN_ROW_REL of its largest
    # plain value (a whole-tensor scale would pass a dropped deep tile)
    errs, rows = [], []
    for label, (b, h, hkv, sq, sk, dh, causal) in flash_cases(B, H, Hkv, S, hd):
        qa, ka, va = randn(b, sq, h, dh), randn(b, sk, hkv, dh), randn(b, sk, hkv, dh)
        args = (qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2))
        o = flash_attention(*args, causal=causal)
        want = flash_attention_ref(*args, causal=causal)
        errs.append(compare(torch, o, want, f"flash {label}"))
        rows.append(row_scaled_errs(o, want)[1])
        if not rows[-1] <= TRAIN_ROW_REL:
            raise AssertionError(
                f"flash {label}: a row's max |kernel - plain| is {rows[-1]:.3g} x "
                f"its max |plain| (limit {TRAIN_ROW_REL:g})")
        say(f"  flash_attention {label} q {tuple(args[0].shape)} k "
            f"{tuple(args[1].shape)} causal {causal} max|err| {errs[-1]:.3g}, "
            f"worst row |err| / row max {rows[-1]:.3g}")
        if label == "serve":
            main = args
        del qa, ka, va, args, o, want
    qf, kf, vf = main
    b_ms, b_by = cost.flash_attention(B, H, Hkv, S, S, hd, True).bound_ms()
    out["flash_attention"] = dict(
        max_abs_err=max(errs), max_row_scaled_err=max(rows),
        row_scaled_err_limit=TRAIN_ROW_REL,
        ms=timer.ms(lambda: flash_attention(qf, kf, vf, causal=True), 20),
        plain_ms=timer.ms(lambda: flash_attention_ref(qf, kf, vf, causal=True), 5),
        library_ms=timer.ms(lambda: sdpa(F, qf, kf, vf, causal=True), 20),
        bound_ms=b_ms, bound_by=b_by, shape=[B, H, Hkv, S, S, hd])
    say(f"  flash_attention serve {out['flash_attention']}")
    del qf, kf, vf, main
    for group, cases in (("memory_shapes", MEMORY_FLASH_CASES),
                         ("command_r_35b", COMMAND_R_FLASH_CASES)):
        out["flash_attention"][group] = shapes = {}
        for label, (mb, mh, mhkv, sq, sk, dh, causal) in cases:
            qa, ka, va = randn(mb, sq, mh, dh), randn(mb, sk, mhkv, dh), randn(mb, sk, mhkv, dh)
            args = (qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2))
            o = flash_attention(*args, causal=causal)
            want = flash_attention_ref(*args, causal=causal)
            err = compare(torch, o, want, f"flash {label}")
            row = row_scaled_errs(o, want)[1]
            if not row <= TRAIN_ROW_REL:
                raise AssertionError(
                    f"flash {label}: a row's max |kernel - plain| is {row:.3g} x "
                    f"its max |plain| (limit {TRAIN_ROW_REL:g})")
            del o, want
            b_ms, b_by = cost.flash_attention(mb, mh, mhkv, sq, sk, dh, causal).bound_ms()
            shapes[label] = dict(
                max_abs_err=err, max_row_scaled_err=row,
                ms=timer.ms(lambda: flash_attention(*args, causal=causal), 20),
                plain_ms=timer.ms(lambda: flash_attention_ref(*args, causal=causal), 5),
                library_ms=timer.ms(lambda: sdpa(F, *args, causal=causal), 20),
                bound_ms=b_ms, bound_by=b_by, shape=[mb, mh, mhkv, sq, sk, dh, causal])
            say(f"  flash_attention {label}: {json.dumps(shapes[label])}")
            del qa, ka, va, args
    return out


# ------------------------------- phase 3: RMSNorm -----------------------------
#: Row 1 at the shapes the serving paths give it, (label, rows, d, kind):
#: kind "residual" (the block's add + norm), "plain" (the first norm, no
#: residual) or "gated" (Mamba2's rmsnorm(y * silu(z), w): y float32, z a
#: slice of in_proj's output read through its row stride).
RMSNORM_SHAPES = (("mistral decode", REQUESTS, 5120, "residual"),
                  ("mistral prefill", REQUESTS * PROMPT_LEN, 5120, "residual"),
                  ("mamba2 decode", SSM_REQUESTS, 768, "residual"),
                  ("mamba2 decode gated", SSM_REQUESTS, 1536, "gated"),
                  ("mamba2 prefill", SSM_REQUESTS * PROMPT_LEN, 768, "residual"),
                  ("mamba2 prefill gated", SSM_REQUESTS * PROMPT_LEN, 1536, "gated"))
#: Jamba's gated norm at d_inner 8192, the widest row the gated kernel
#: takes (``rmsnorm.ops.MAX_D_GATED``): a decode step's and a prefill's rows,
#: checked and timed as RMSNORM_SHAPES are
RMSNORM_JAMBA = (("jamba decode gated", REQUESTS, 8192, "gated"),
                 ("jamba prefill gated", REQUESTS * PROMPT_LEN, 8192, "gated"))
#: further cases, checked and not timed: the first norm of a pass, widths
#: that take the scalar path, a gate whose rows do not start on 16 bytes
RMSNORM_EXTRA = (("mistral first norm", REQUESTS, 5120, "plain"),
                 ("ragged", 7, 100, "residual"), ("ragged gated", 7, 100, "gated"),
                 ("ragged", 3, 770, "residual"), ("ragged first norm", 3, 770, "plain"),
                 ("ragged gated", 3, 770, "gated"),
                 ("gated unaligned", SSM_REQUESTS, 1536, "gated-unaligned"))
#: launches a decode-shape timing graph holds, each on its own buffers: the
#: norms of one mistral_nemo_12b decode step (1 + 2 x 40)
GRAPH_LAUNCHES = 81
#: rows above which a shape is timed one launch a replay (a launch moves far
#: more than the L2 holds) instead of GRAPH_LAUNCHES
GRAPH_ROWS = 64
RMSNORM_EPS = 1e-6

#: A helper library for row 1's measurements, not a kernel of the port:
#: ``empty_launch`` launches an empty kernel with the geometry of a norm's
#: launch (the floor under its time); ``slow_copy`` triggers its dependents
#: at once, spins, then copies (the predecessor of the race check).
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void empty_kernel() {}
__global__ void slow_copy_kernel(const uint4* src, uint4* dst, long long n, long long spin) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {}
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}
extern "C" {
int empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
int slow_copy(const void* src, void* dst, long long bytes, long long spin, void* stream) {
  slow_copy_kernel<<<132, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, bytes / 16, spin);
  return (int)cudaGetLastError();
}
}
"""
#: the race check's predecessor spins this many SM cycles (~0.1 ms)
RACE_SPIN_CYCLES = 200_000


def probe_build_start():
    """Start ``nvcc`` on PROBE_SOURCE; :func:`probe_build_finish` loads it."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "rmsnorm-probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(PROBE_SOURCE)
    return out, subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-o", str(out / "libprobe.so"), str(out / "probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def probe_build_finish(started):
    import ctypes

    out, proc = started
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the measurement helper failed to build:\n{log}")
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    lib.empty_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.slow_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_void_p]
    return lib


def probe_library():
    return probe_build_finish(probe_build_start())


def rmsnorm_inputs(torch, g, rows: int, d: int, kind: str) -> dict:
    """Seeded inputs of one call: bf16 x (float32 when gated), bf16 r (for
    "residual"), f32 w in [0.5, 1.5); the gate z as the first d columns of a
    (rows, 2 d + 280) bf16 tensor, as the model slices it out of in_proj's
    output (one column further for "gated-unaligned")."""
    dev = torch.device("cuda")
    gated = kind.startswith("gated")
    inp = {"w": torch.rand(d, generator=g, device=dev) + 0.5, "r": None, "z": None}
    inp["x"] = torch.randn(rows, d, generator=g, device=dev)
    if not gated:
        inp["x"] = inp["x"].to(torch.bfloat16)
    if kind == "residual":
        inp["r"] = torch.randn(rows, d, generator=g, device=dev).to(torch.bfloat16)
    if gated:
        wide = (2 * torch.randn(rows, 2 * d + 280, generator=g, device=dev)).to(torch.bfloat16)
        lo = int(kind == "gated-unaligned")
        inp["z"] = wide[:, lo:lo + d]
    return inp


def rmsnorm_call(fn, inp):
    """``fn`` (fused_rmsnorm or a stand-in) on one case's inputs."""
    if inp["z"] is not None:
        return fn(inp["x"], inp["w"], gate=inp["z"], eps=RMSNORM_EPS)
    return fn(inp["x"], inp["w"], inp["r"], eps=RMSNORM_EPS)


def rmsnorm_chain(torch, inp):
    """The gated norm as the unfused chain computes it on the card: the cast,
    F.silu, the product and the norm, four launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    return fused_rmsnorm(inp["x"].to(torch.bfloat16) * F.silu(inp["z"]), inp["w"],
                         eps=RMSNORM_EPS)[0]


def rmsnorm_check(torch, inp, y, rout, label: str, check: bool = True) -> dict:
    """One call's outputs held: y within TOL of the plain version, and
    element by element within one bf16 ulp of its f64 value computed from
    the same inputs (gated: from the chain's g on the card); the new
    residual bit-identical to bf16(f32(x) + f32(r)) (x without a residual);
    gated, y within one bf16 ulp of the unfused chain (:func:`rmsnorm_chain`).
    A kernel that drops a warp's partial sum at d 5120 moves every y by
    ~2.6 %, inside TOL at |y| ~ 1 and several ulps off. Returns the
    readings; with ``check`` raises on a failure."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref

    torch.cuda.synchronize()
    gated = inp["z"] is not None
    yr = rmsnorm_call(fused_rmsnorm_ref, inp)[0]
    finite = bool(torch.isfinite(y.float()).all())
    err = (y.float() - yr.float()).abs()
    out = {"max_abs_err": err.max().item() if finite else float("inf"),
           "tol_outside": int((err > TOL["atol"] + TOL["rtol"] * yr.float().abs()).sum())}
    if gated:
        s = (inp["x"].to(torch.bfloat16) * F.silu(inp["z"])).double()
    else:
        s = inp["x"].double() + (inp["r"].double() if inp["r"] is not None else 0.0)
    y64 = s * torch.rsqrt((s * s).mean(-1, keepdim=True) + RMSNORM_EPS) * inp["w"].double()
    off = (y.double() - y64).abs() / bf16_ulp(torch, y64)
    out["ulp_excess"] = off.max().item() if finite else float("inf")
    out["ulp_outside"] = int((off > 1).sum()) if finite else y.numel()
    if gated:
        chain = rmsnorm_chain(torch, inp)
        gap = (y.double() - chain.double()).abs() / bf16_ulp(torch, chain.double())
        out["chain_ulp_excess"] = gap.max().item() if finite else float("inf")
        out["chain_identical_share"] = (y == chain).double().mean().item()
        out["residual_identical"] = rout is None
    else:
        want = (inp["x"].float() + (inp["r"].float() if inp["r"] is not None else 0.0))
        out["residual_identical"] = bool(torch.equal(rout, want.to(torch.bfloat16)))
    if check:
        bad = []
        if not finite or out["tol_outside"]:
            bad.append(f"max |kernel - plain| {out['max_abs_err']:.3g} outside "
                       f"rtol={TOL['rtol']:g}, atol={TOL['atol']:g} ({out['tol_outside']} outputs)")
        if out["ulp_outside"]:
            bad.append(f"{out['ulp_outside']} outputs further than one bf16 ulp from the f64 "
                       f"value (worst {out['ulp_excess']:.3g} ulps)")
        if not out["residual_identical"]:
            bad.append("the new residual is not bf16(f32(x) + f32(r)) bit for bit")
        if gated and not out["chain_ulp_excess"] <= 1:
            bad.append(f"the gated norm is {out['chain_ulp_excess']:.3g} ulps from the unfused chain")
        if bad:
            raise AssertionError(f"rmsnorm {label}: " + "; ".join(bad))
    return out


def rmsnorm_times(torch, timer, probe, fn, g, rows: int, d: int, kind: str,
                  yardsticks: bool = True) -> dict:
    """Device time per launch of ``fn`` at one shape. Up to GRAPH_ROWS rows
    (decode): GRAPH_LAUNCHES launches, each on its own inputs and outputs,
    captured in one graph, replayed with the L2 flushed by a read, per
    launch; beside it the same graph of an empty kernel with the norm's
    launch geometry (``floor_ms``) and of the library yardstick. More rows
    (prefill): one launch a replay, with the L2 flushed by a read (``ms``)
    and by a write (``write_flush_ms``). The yardstick: F.rms_norm(x + r),
    or for the gated norm the four-kernel chain it replaces."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import cost
    from repro_torch.kernels.rmsnorm.ops import plan

    n = GRAPH_LAUNCHES if rows <= GRAPH_ROWS else 1
    cases = [rmsnorm_inputs(torch, g, rows, d, kind) for _ in range(n)]
    pl = plan(rows, d, kind.startswith("gated"))
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # noqa: E731

    def graph(call, clean=True, iters=30 if n > 1 else 50):
        return timer.ms(lambda: [call(c) for c in cases], iters, clean) / n

    def empty(_):
        _build.check("rmsnorm", probe.empty_launch(pl["grid"], pl["threads"], stream()))

    def library(c):
        if c["z"] is not None:
            return rmsnorm_chain(torch, c)
        return F.rms_norm(c["x"] + c["r"], (d,), c["w"].to(torch.bfloat16), RMSNORM_EPS)
    b_ms, b_by = cost.rmsnorm(rows, d, kind).bound_ms()
    out = {"shape": [rows, d], "kind": kind, "launches_a_replay": n, "plan": pl,
           "ms": graph(lambda c: rmsnorm_call(fn, c)), "floor_ms": graph(empty),
           "bound_ms": b_ms, "bound_by": b_by}
    if yardsticks:
        out["library_ms"] = graph(library)
    if n == 1:
        out["write_flush_ms"] = graph(lambda c: rmsnorm_call(fn, c), clean=False)
        if yardsticks:
            out["library_write_flush_ms"] = graph(library, clean=False)
    out["bound_share"] = b_ms / out["ms"]
    return out


def rmsnorm_race_check(torch, probe, fn, check: bool = True, trials: int = 4) -> dict:
    """The norm reads x only after its predecessor is done: a predecessor
    that triggers its dependents at once, spins RACE_SPIN_CYCLES and only
    then copies new data into x is followed by the norm of x, eagerly and
    as one captured graph replayed with new data each time; every output
    must equal, bit for bit, the norm of the new data computed on its own.
    At the mistral and the gated mamba2 decode shapes. The port launches
    the norm plainly, so stream order alone holds this; launched as a
    programmatic dependent (``tools/rmsnorm_planted_faults.py``'s pdl_on
    and wait_after_x_loads), it holds only while the kernel waits before
    its first read of x. Returns the mismatching outputs per route; with
    ``check`` raises on any."""
    from repro_torch.kernels import _build

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    for label, rows, d, kind in (RMSNORM_SHAPES[0], RMSNORM_SHAPES[3]):
        inp = rmsnorm_inputs(torch, g, rows, d, kind)
        src = torch.empty_like(inp["x"])
        case = dict(inp, x=torch.zeros_like(inp["x"]))

        def step():
            _build.check("rmsnorm", probe.slow_copy(
                _build.ptr(src), _build.ptr(case["x"]), src.numel() * src.element_size(),
                RACE_SPIN_CYCLES, _build.stream_ptr(src.device)))
            return rmsnorm_call(fn, case)[0]

        def fresh():
            src.copy_(torch.randn(src.shape, generator=g, device="cuda").to(src.dtype))

        def wrong(y):
            torch.cuda.synchronize()
            want = rmsnorm_call(fn, dict(inp, x=src.clone()))[0]
            torch.cuda.synchronize()
            return int((y != want).sum())
        eager = []
        for _ in range(trials):
            fresh()
            eager.append(wrong(step()))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = step()
        replayed = []
        for _ in range(trials):
            fresh()
            graph.replay()
            replayed.append(wrong(y))
        out[label] = {"eager_wrong": eager, "replayed_wrong": replayed}
        if check and any(eager + replayed):
            raise AssertionError(f"rmsnorm race check {label}: outputs that are not the "
                                 f"norm of the new x: eager {eager}, replayed {replayed}")
        del graph
    return out


def check_rmsnorm(torch, timer, probe) -> dict:
    """Row 1: every case of RMSNORM_SHAPES, RMSNORM_JAMBA and RMSNORM_EXTRA
    held by :func:`rmsnorm_check`, one launch counted per call; the race
    check; the six serving shapes and Jamba's two timed
    (:func:`rmsnorm_times`). The top-level times are at the
    mistral prefill shape with the L2 flushed by a write, as every earlier
    reading of row 1 was taken and as row 2's are, the read flush's beside
    them (``clean_l2``)."""
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {}
    for label, rows, d, kind in RMSNORM_SHAPES + RMSNORM_JAMBA + RMSNORM_EXTRA:
        inp = rmsnorm_inputs(torch, g, rows, d, kind)
        n = fused_rmsnorm.launches
        y, rout = rmsnorm_call(fused_rmsnorm, inp)
        if fused_rmsnorm.launches != n + 1:
            raise AssertionError(f"rmsnorm {label}: {fused_rmsnorm.launches - n} launches "
                                 f"counted for one call")
        key = f"{label} ({rows}, {d})"
        checks[key] = rmsnorm_check(torch, inp, y, rout, key)
        say(f"  rmsnorm {key} {kind}: {json.dumps(checks[key])}")
    race = rmsnorm_race_check(torch, probe, fused_rmsnorm)
    say(f"  rmsnorm race check (a predecessor that writes x last): {json.dumps(race)}")
    shapes = {}
    for label, rows, d, kind in RMSNORM_SHAPES + RMSNORM_JAMBA:
        shapes[label] = rmsnorm_times(torch, timer, probe, fused_rmsnorm, g, rows, d, kind)
        say(f"  rmsnorm {label} {json.dumps(shapes[label])}")
    main = rmsnorm_inputs(torch, g, *RMSNORM_SHAPES[1][1:])
    top = shapes[RMSNORM_SHAPES[1][0]]
    return dict(max_abs_err=max(c["max_abs_err"] for c in checks.values()),
                max_ulp_excess=max(c["ulp_excess"] for c in checks.values()),
                ms=top["write_flush_ms"],
                plain_ms=timer.ms(lambda: rmsnorm_call(fused_rmsnorm_ref, main), 10),
                library_ms=top["library_write_flush_ms"],
                clean_l2={"ms": top["ms"], "library_ms": top["library_ms"]},
                bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], shape=top["shape"], shapes=shapes, race=race,
                checks=checks)


# ------------------------------- phase 3: RMSNorm backward --------------------
#: The backward at the training shapes, (label, rows, d, kind): mamba2_130m
#: at 8 x 2048 (the residual norm and the gated one), mistral_nemo_12b at 2
#: x 2048 and its first norm (no residual: its new residual is x). Timed.
RMSNORM_BWD_SHAPES = (("mamba2 train", TRAIN_BATCH * TRAIN_SEQ, 768, "residual"),
                      ("mamba2 train gated", TRAIN_BATCH * TRAIN_SEQ, 1536, "gated"),
                      ("mistral train", GRAD_BATCH * TRAIN_SEQ, 5120, "residual"),
                      ("mistral train first norm", GRAD_BATCH * TRAIN_SEQ, 5120, "plain"))
#: checked, not timed: the scalar path's widths, a gate whose rows do not
#: start on 16 bytes, the final norm (its new residual unused: no dr)
RMSNORM_BWD_EXTRA = (("ragged", 7, 100, "residual"), ("ragged gated", 7, 100, "gated"),
                     ("ragged first norm", 3, 770, "plain"), ("ragged", 3, 770, "residual"),
                     ("gated unaligned", 64, 1536, "gated-unaligned"),
                     ("final norm, no dr", 64, 5120, "residual-no-dr"))
#: dw against its f64 value, relative to the sum over rows of |dh s^| (the
#: sum's condition): the kernel adds the rows in f32 in its own order, ~100
#: additions deep (a block's rows, then the blocks' shares), each rounding
#: by at most 2^-24 of the running sum
RMSNORM_DW_REL = 1e-5
#: the f32 arithmetic's share of the terms an element of ds sums (rstd w dh,
#: rstd s^ mean, dr): where they cancel, one bf16 ulp of the result is
#: smaller than the f32 rounding of the terms
RMSNORM_BWD_FLOOR = 2.0 ** -16
#: dy and dz round to bf16 on the way (dg, then dy; dg, the SiLU's
#: gradient, then dz), as torch's autograd of the unfused chain does; the
#: f64 values round dg and the SiLU's gradient at the same points. Where
#: the kernel's f32 value and the f64 one of dg (or of the SiLU's gradient)
#: round to different bf16 neighbours, the output may part from the f64
#: chain by more than one ulp: at most this share of the outputs, each
#: within RMSNORM_GATED_ULPS
RMSNORM_GATED_BEYOND_ONE_ULP = 2.0 ** -8
RMSNORM_GATED_ULPS = 3


def rmsnorm_bwd_inputs(torch, g, rows: int, d: int, kind: str) -> dict:
    """:func:`rmsnorm_inputs` and the gradients of the outputs: dh (bf16),
    and dr (bf16) for the residual and the first norm (none gated, none for
    "residual-no-dr")."""
    base = kind.replace("-no-dr", "")
    inp = rmsnorm_inputs(torch, g, rows, d, base)
    inp["dh"] = torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)
    inp["dr"] = (None if base.startswith("gated") or kind.endswith("no-dr") else
                 torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16))
    return inp


def rmsnorm_bwd_call(fn, inp):
    """``fn`` (fused_rmsnorm_bwd or its plain version) on one case."""
    return fn(inp["dh"], inp["dr"], inp["x"], inp["w"], inp["r"], RMSNORM_EPS,
              inp["z"])


def rmsnorm_bwd_f64(torch, inp) -> dict:
    """The backward's f64 values from the same inputs: g from the chain's
    own bf16 product on the card (gated), then every step in f64, rounded
    only where the gated chain rounds on its way (dg and the SiLU's
    gradient, to bf16). Returns dx (dy gated), dz, dw, the magnitude of the
    terms each ds sums (``terms``, ``terms_dz``) and the sum over rows of
    |dh s^| (``dw_scale``)."""
    import torch.nn.functional as F

    z = inp["z"]
    if z is not None:
        xb, sz = inp["x"].to(torch.bfloat16), F.silu(z)
        s = (xb * sz).double()
    else:
        s = inp["x"].double() + (inp["r"].double() if inp["r"] is not None else 0.0)
    rstd = torch.rsqrt((s * s).mean(-1, keepdim=True) + RMSNORM_EPS)
    sh, dh = s * rstd, inp["dh"].double()
    gw = dh * inp["w"].double()
    mean = (gw * sh).mean(-1, keepdim=True)
    ds = rstd * (gw - sh * mean)
    terms = (rstd * gw).abs() + (rstd * sh * mean).abs()
    out = {"dw": (dh * sh).sum(0), "dw_scale": (dh * sh).abs().sum(0)}
    del gw, mean
    if z is None:
        if inp["dr"] is not None:
            ds = ds + inp["dr"].double()
            terms = terms + inp["dr"].double().abs()
        return out | {"dx": ds, "terms": terms, "dz": None}
    zf = z.double()
    sig = torch.sigmoid(zf)
    dg = ds.to(torch.bfloat16).double()
    dsz = (dg * xb.double()).to(torch.bfloat16).double()
    return out | {"dx": dg * sz.double(), "terms": terms * sz.double().abs(),
                  "dz": dsz * sig * (1 + zf * (1 - sig)),
                  "terms_dz": terms * (xb.double() * sig * (1 + zf * (1 - sig))).abs()}


def rmsnorm_bwd_check(torch, inp, got, label: str) -> dict:
    """One backward call held: dx (the residual form) within one bf16 ulp of
    its f64 value plus RMSNORM_BWD_FLOOR of its terms; gated, dy and dz
    within RMSNORM_GATED_ULPS (plus the floor) and at most
    RMSNORM_GATED_BEYOND_ONE_ULP of them beyond one; dw within RMSNORM_DW_REL
    of the sum over rows of |dh s^|; every output within TOL of the plain
    version on the same inputs. Raises on a failure."""
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_bwd_ref

    torch.cuda.synchronize()
    gated = inp["z"] is not None
    want = rmsnorm_bwd_call(fused_rmsnorm_bwd_ref, inp)
    exact = rmsnorm_bwd_f64(torch, inp)
    dx, d2, dw = got
    outs = [("dx", dx, want[0]), ("dw", dw, want[2])] + ([("dz", d2, want[1])] if gated else [])
    finite = all(bool(torch.isfinite(o.float()).all()) for _, o, _ in outs)
    out = {"max_abs_err": max((o.float() - w.float()).abs().max().item()
                              for _, o, w in outs) if finite else float("inf"),
           "tol_outside": sum(int(((o.float() - w.float()).abs() > TOL["atol"] + TOL["rtol"]
                                   * w.float().abs()).sum()) for _, o, w in outs)}
    bad = []
    for name, o, w64 in ([("dx", dx, exact["dx"])]
                         + ([("dz", d2, exact["dz"])] if gated else [])):
        terms = exact["terms"] if name == "dx" else exact["terms_dz"]
        off = ((o.double() - w64).abs() - RMSNORM_BWD_FLOOR * terms).clamp_min(0) \
            / bf16_ulp(torch, w64)
        out[f"{name}_ulp_excess"] = off.max().item() if finite else float("inf")
        out[f"{name}_beyond_one_ulp"] = int((off > 1).sum())
        if not gated and out[f"{name}_beyond_one_ulp"]:
            bad.append(f"{name}: {out[f'{name}_beyond_one_ulp']} outputs beyond one bf16 "
                       f"ulp of f64 (worst {out[f'{name}_ulp_excess']:.3g})")
        if gated and not (out[f"{name}_ulp_excess"] <= RMSNORM_GATED_ULPS
                          and out[f"{name}_beyond_one_ulp"]
                          <= RMSNORM_GATED_BEYOND_ONE_ULP * o.numel()):
            bad.append(f"{name}: worst {out[f'{name}_ulp_excess']:.3g} ulps of f64, "
                       f"{out[f'{name}_beyond_one_ulp']} beyond one")
    dw_err = ((dw.double() - exact["dw"]).abs() / exact["dw_scale"].clamp_min(1e-30)).max().item()
    out["dw_rel_err"] = dw_err
    if not dw_err <= RMSNORM_DW_REL:
        bad.append(f"dw {dw_err:.3g} of the sum of |dh s^| (limit {RMSNORM_DW_REL:g})")
    if not finite or out["tol_outside"]:
        bad.append(f"{out['tol_outside']} outputs outside rtol={TOL['rtol']:g}, "
                   f"atol={TOL['atol']:g} of the plain version, or not finite")
    if gated and d2.stride() != (d2.shape[1], 1):
        bad.append("dz is not contiguous")
    if bad:
        raise AssertionError(f"rmsnorm backward {label}: " + "; ".join(bad))
    return out


def rmsnorm_bwd_times(torch, timer, inp, rows: int, d: int, kind: str) -> dict:
    """Device time of one backward call (a graph replay, the L2 flushed by a
    write; ``clean_l2_ms`` by a read), its bound, the plain version's time,
    and the library yardstick's: the backward of F.rms_norm under autograd
    (eagerly, the L2 flushed by a write), of F.rms_norm(x + r) for the
    residual forms, of the unfused chain (cast, SiLU, product, F.rms_norm)
    when gated."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm_bwd, plan_bwd
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_bwd_ref

    gated = inp["z"] is not None
    b_ms, b_by = cost.rmsnorm_bwd(rows, d, kind.replace("-no-dr", ""),
                                  inp["dr"] is not None).bound_ms()
    w = inp["w"].to(torch.bfloat16).requires_grad_(True)
    if gated:
        xs = inp["x"].clone().requires_grad_(True)
        zs = inp["z"].detach().clone().requires_grad_(True)
        lib_out = F.rms_norm(xs.to(torch.bfloat16) * F.silu(zs), (d,), w, RMSNORM_EPS)
        leaves = [xs, zs, w]
    else:
        xs = inp["x"].clone().requires_grad_(True)
        s = xs + inp["r"] if inp["r"] is not None else xs
        lib_out = F.rms_norm(s, (d,), w, RMSNORM_EPS)
        leaves = [xs, w]
    out = {"shape": [rows, d], "kind": kind, "plan": plan_bwd(rows, d, gated),
           "ms": timer.ms(lambda: rmsnorm_bwd_call(fused_rmsnorm_bwd, inp), 30),
           "clean_l2_ms": timer.ms(lambda: rmsnorm_bwd_call(fused_rmsnorm_bwd, inp), 30,
                                   clean_l2=True),
           "plain_ms": timer.ms(lambda: rmsnorm_bwd_call(fused_rmsnorm_bwd_ref, inp), 10),
           "library_ms": timer.eager_ms(lambda: torch.autograd.grad(
               lib_out, leaves, inp["dh"], retain_graph=True), 20),
           "bound_ms": b_ms, "bound_by": b_by}
    out["bound_share"] = b_ms / out["ms"]
    return out


def check_rmsnorm_bwd(torch, timer) -> dict:
    """The RMSNorm backward kernel: every case of RMSNORM_BWD_SHAPES and
    RMSNORM_BWD_EXTRA held by :func:`rmsnorm_bwd_check`, one count per call,
    two calls bit-identical; the training shapes timed. The top-level
    numbers are at the mamba2 8 x 2048 residual shape, the main path's."""
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm_bwd

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    checks, shapes = {}, {}
    for label, rows, d, kind in RMSNORM_BWD_SHAPES + RMSNORM_BWD_EXTRA:
        inp = rmsnorm_bwd_inputs(torch, g, rows, d, kind)
        n = fused_rmsnorm_bwd.launches
        got = rmsnorm_bwd_call(fused_rmsnorm_bwd, inp)
        again = rmsnorm_bwd_call(fused_rmsnorm_bwd, inp)
        if fused_rmsnorm_bwd.launches != n + 2:
            raise AssertionError(f"rmsnorm backward {label}: "
                                 f"{fused_rmsnorm_bwd.launches - n} counted for two calls")
        key = f"{label} ({rows}, {d})"
        checks[key] = rmsnorm_bwd_check(torch, inp, got, key)
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        checks[key]["bit_identical_twice"] = same
        if not same:
            raise AssertionError(f"rmsnorm backward {key}: two calls differ")
        say(f"  rmsnorm backward {key} {kind}: {json.dumps(checks[key])}")
        if (label, rows, d, kind) in RMSNORM_BWD_SHAPES:
            shapes[label] = rmsnorm_bwd_times(torch, timer, inp, rows, d, kind)
            say(f"  rmsnorm backward {label} {json.dumps(shapes[label])}")
        del inp, got, again
    top = shapes[RMSNORM_BWD_SHAPES[0][0]]
    return dict(max_abs_err=max(c["max_abs_err"] for c in checks.values()),
                ms=top["ms"], plain_ms=top["plain_ms"], library_ms=top["library_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"], shape=top["shape"],
                clean_l2={"ms": top["clean_l2_ms"]}, shapes=shapes, checks=checks)


# ------------------------------- phase 3: split-row gated norm ---------------
#: The gated norm over rows split across the ranks of a model axis, (label,
#: rows, this rank's width, the full width, ranks): Mamba2's 1536 on two
#: ranks at the serving shapes of phase 21 (8 x 2048 prefill, 8 decode
#: rows), Jamba's 8192 on two at Part C's (4 x 2048, 4), and ragged rows.
#: Each rank's gate is a column slice of its own in_proj output, whose row
#: is 2 d + 2 N + H / ranks wide (mamba2: 1804 elements, rows on 8 bytes,
#: the gate in 8-byte loads; jamba: 8288, 16-byte ones); the other tensors
#: take 16-byte vectors. The further cases put the gate's rows on 2 and 4
#: bytes (strides 1801, 1802) and take the scalar path (width 100).
RMSNORM_SPLIT_SHAPES = (("mamba2 prefill", 8 * 2048, 768, 1536, 2, 1804),
                        ("mamba2 decode", 8, 768, 1536, 2, 1804),
                        ("jamba prefill", 4 * 2048, 4096, 8192, 2, 8288),
                        ("jamba decode", 4, 4096, 8192, 2, 8288))
RMSNORM_SPLIT_EXTRA = (("ragged", 100, 768, 3072, 4, 1600), ("one row", 1, 4096, 8192, 2, 8288),
                       ("odd width", 37, 100, 200, 2, 212),
                       ("gate on 2 bytes", 300, 768, 1536, 2, 1801),
                       ("gate on 4 bytes", 300, 768, 1536, 2, 1802))
#: the statistic launches' f32 row sums against their plain versions,
#: relative to the sum of the terms' magnitudes (another summation order)
SPLIT_SUM_REL = 1e-5


def split_inputs(torch, g, rows: int, d: int, dn: int, ranks: int, width: int) -> dict:
    """Every rank's block of one split row: y (f32), the gate (bf16, each
    rank's the first d columns of its own (rows, ``width``) in_proj output,
    read through that row stride), w and dh of the whole row; ``blocks``
    the column slices, ``z`` the whole gate (the blocks side by side)."""
    y = torch.randn(rows, dn, generator=g, device="cuda")
    zs = [torch.randn(rows, width, generator=g, device="cuda").to(torch.bfloat16)[:, :d]
          for _ in range(ranks)]
    w = torch.rand(dn, generator=g, device="cuda") + 0.5
    dh = torch.randn(rows, dn, generator=g, device="cuda").to(torch.bfloat16)
    return {"y": y, "zs": zs, "z": torch.cat(zs, 1), "w": w, "dh": dh,
            "blocks": [slice(r * d, (r + 1) * d) for r in range(ranks)]}


def split_blocks(inp, c):
    """One rank's block of y, z, w and dh (y, w and dh contiguous, z the
    rank's strided gate)."""
    r = c.start // (c.stop - c.start)
    return (inp["y"][:, c].contiguous(), inp["zs"][r], inp["w"][c].contiguous(),
            inp["dh"][:, c].contiguous())


def split_rows_check(torch, inp, dn: int, label: str) -> dict:
    """Each launch on every block against its plain version on the same
    inputs (the statistics within SPLIT_SUM_REL of the terms' magnitudes,
    the outputs within one bf16 ulp + 2^-14 of their largest, dw within
    TOL), and the blocks put together against the one-launch gated norm
    and its backward over the whole row (one bf16 ulp; the summed
    statistics differ from the one-launch sum in order only); the
    backward's dy and dz, which round twice after the sums, within
    RMSNORM_GATED_ULPS."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm import ref
    errs = {"stat": 0.0, "apply": 0.0, "bwd_stat": 0.0, "bwd_apply": 0.0,
            "whole_fwd_ulp": 0.0, "whole_bwd": 0.0}
    stats = bstats = 0
    for c in inp["blocks"]:
        y, z, w, dh = split_blocks(inp, c)
        got, want = ops.gated_norm_stat(y, z, w), ref.gated_norm_stat_ref(y, z)
        scale = ref.gated_norm_stat_ref(y.abs(), z).clamp_min(1e-30)
        errs["stat"] = max(errs["stat"], float(((got - want).abs() / scale).max()))
        stats = stats + got
        got, want = ops.gated_norm_bwd_stat(dh, y, z, w), ref.gated_norm_bwd_stat_ref(dh, y, z, w)
        g_abs = (y.to(torch.bfloat16).float() * torch.nn.functional.silu(z).float()).abs()
        scale = torch.stack([(g_abs * g_abs).sum(-1),
                             (dh.float().abs() * w * g_abs).sum(-1)], -1).clamp_min(1e-30)
        errs["bwd_stat"] = max(errs["bwd_stat"], float(((got - want).abs() / scale).max()))
        bstats = bstats + got
    for name, worst in (("stat", SPLIT_SUM_REL), ("bwd_stat", SPLIT_SUM_REL)):
        if not errs[name] <= worst:
            raise AssertionError(f"split norm {label}: {name} {errs[name]:.3g} > {worst}")
    outs, grads = [], []
    for c in inp["blocks"]:
        y, z, w, dh = split_blocks(inp, c)
        got = ops.gated_norm_apply(y, z, w, stats, dn)
        want = ref.gated_norm_apply_ref(y, z, w, stats, dn)
        errs["apply"] = max(errs["apply"], bf16_ulps_over(torch, got, want))
        outs.append(got)
        got = ops.gated_norm_bwd_apply(dh, y, z, w, bstats, dn)
        want = ref.gated_norm_bwd_apply_ref(dh, y, z, w, bstats, dn)
        for a, b in zip(got[:2], want[:2]):
            errs["bwd_apply"] = max(errs["bwd_apply"], bf16_ulps_over(torch, a, b))
        compare(torch, got[2], want[2], f"split norm {label} dw")
        grads.append(got)
    whole = ops.fused_rmsnorm(inp["y"], inp["w"], gate=inp["z"])[0]
    errs["whole_fwd_ulp"] = bf16_ulps_over(torch, torch.cat(outs, 1), whole)
    wdx, wdz, _ = ops.fused_rmsnorm_bwd(inp["dh"], None, inp["y"], inp["w"], gate=inp["z"])
    errs["whole_bwd"] = max(bf16_ulps_over(torch, torch.cat([g[0] for g in grads], 1), wdx),
                            bf16_ulps_over(torch, torch.cat([g[1] for g in grads], 1), wdz))
    for name, worst in (("apply", 1.0), ("whole_fwd_ulp", 1.0),
                        ("bwd_apply", RMSNORM_GATED_ULPS), ("whole_bwd", RMSNORM_GATED_ULPS)):
        if not errs[name] <= worst:
            raise AssertionError(f"split norm {label}: {name} {errs[name]:.3g} bf16 ulps "
                                 f"> {worst}")
    return errs


def bf16_ulps_over(torch, got, want) -> float:
    """The largest |got - want| in bf16 ulps of |want| (at least 2^-14 of
    the tensor's largest |want|, where a value near zero has tiny ulps)."""
    got, want = got.double(), want.double()
    floor = want.abs().max().clamp_min(1e-30) * 2.0 ** -14
    ulp = (want.abs() * 2.0 ** -7).clamp_min(floor)
    return float(((got - want).abs() / ulp).max())


def check_rmsnorm_split(torch, timer) -> dict:
    """Row 1's split-row form: every case of RMSNORM_SPLIT_SHAPES and
    RMSNORM_SPLIT_EXTRA held by :func:`split_rows_check`; at the serving
    shapes each of the four launches timed on rank 0's block (a graph
    replay, the L2 flushed by a write) beside its bound and its plain
    version, each tensor's load (``ops.split_widths``) and the plan it
    takes (its instantiation's registers and spills are phase 2's).
    Returns the four launches' rows for the kernels line, keyed as
    ``kernels.WRAPPERS``."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm import ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    checks, shapes = {}, {}
    for label, rows, d, dn, ranks, width in RMSNORM_SPLIT_SHAPES + RMSNORM_SPLIT_EXTRA:
        inp = split_inputs(torch, g, rows, d, dn, ranks, width)
        key = f"{label} ({rows}, {d} of {dn})"
        checks[key] = split_rows_check(torch, inp, dn, key)
        say(f"  split norm {key}: {json.dumps(checks[key])}")
        if (label, rows, d, dn, ranks, width) not in RMSNORM_SPLIT_SHAPES:
            continue
        y, z, w, dh = split_blocks(inp, inp["blocks"][0])
        st = ops.gated_norm_stat(y, z, w) * ranks
        bst = ops.gated_norm_bwd_stat(dh, y, z, w).contiguous()
        calls = {
            "rmsnorm_split_stat": (lambda: ops.gated_norm_stat(y, z, w),
                                   lambda: ref.gated_norm_stat_ref(y, z),
                                   cost.rmsnorm(rows, d, "gated_stat"), False),
            "rmsnorm_split_apply": (lambda: ops.gated_norm_apply(y, z, w, st, dn),
                                    lambda: ref.gated_norm_apply_ref(y, z, w, st, dn),
                                    cost.rmsnorm(rows, d, "gated_apply"), False),
            "rmsnorm_bwd_split_stat": (lambda: ops.gated_norm_bwd_stat(dh, y, z, w),
                                       lambda: ref.gated_norm_bwd_stat_ref(dh, y, z, w),
                                       cost.rmsnorm_bwd(rows, d, "gated_stat"), True),
            "rmsnorm_bwd_split_apply": (
                lambda: ops.gated_norm_bwd_apply(dh, y, z, w, bst, dn),
                lambda: ref.gated_norm_bwd_apply_ref(dh, y, z, w, bst, dn),
                cost.rmsnorm_bwd(rows, d, "gated_apply"), True)}
        widths = ops.split_widths(y, z, w, dh)
        for name, (fn, plain, work, bwd) in calls.items():
            b_ms, b_by = work.bound_ms()
            got, want = fn(), plain()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            t = {"max_abs_err": max(float((a.float() - b.float()).abs().max())
                                    for a, b in pairs),
                 "shape": [rows, d], "full_width": dn, "gate_row_stride": z.stride(0),
                 "load_bytes": widths,
                 "plan": ops.plan_split(name.replace("rmsnorm_", "").replace("split_", ""),
                                        rows, d, widths["y"] == 16, widths["gate"]),
                 "ms": timer.ms(fn, 30), "plain_ms": timer.ms(plain, 10),
                 "bound_ms": b_ms, "bound_by": b_by}
            t["bound_share"] = b_ms / t["ms"]
            shapes.setdefault(name, {})[label] = t
            say(f"  split norm {name} {label}: {json.dumps(t)}")
        del inp
    out = {}
    for name, by_shape in shapes.items():
        top = by_shape["mamba2 prefill"]
        out[name] = dict(max_abs_err=max(t["max_abs_err"] for t in by_shape.values()),
                         ms=top["ms"], plain_ms=top["plain_ms"], library_ms=None,
                         bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                         shape=top["shape"], shapes=by_shape,
                         **({"checks": checks} if name == "rmsnorm_split_stat" else {}))
    return out


# ------------------------------- phase 3: SSD ---------------------------------
def ssd_cases(torch, B, S, H, P, N, serve_only: bool = False):
    """(label, args, plain, (B, C) as stored) of every phase-3 SSD case: the
    serving shape of mamba2_130m in the model's layout, x, B and C slices of
    one convolution output and B/C shared by the heads (head stride 0), as
    ssm_layer passes them; B/C per head; the Pallas kernel's (BH, S, .)
    layout; ragged lengths (S = 100, S = 1, S = q + 1); P != N in f32; P = 40,
    N = 72 in bf16 and f32 (warps and N not filled); a strong decay. With
    ``serve_only``, the serving shape's case alone."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    def model_case(b, s, h, p, n, dtype, shared=True, decay=0.5):
        # x, B and C as ssm_layer passes them: slices of one (b, s, h p + 2n)
        # convolution output, a position stride of h p + 2n (B/C per head:
        # h p + 2 h n)
        nbc = n if shared else h * n
        xbc = randn(b, s, h * p + 2 * nbc)
        xbc[..., h * p:] *= 0.3
        xs, Bm, Cm = torch.split(xbc.to(dtype), [h * p, nbc, nbc], dim=-1)
        x = xs.view(b, s, h, p)
        dt = F.softplus(randn(b, s, h))
        dA = dt * -torch.exp(randn(h, scale=decay))
        if shared:
            bc = (Bm[:, :, None].expand(b, s, h, n), Cm[:, :, None].expand(b, s, h, n))
        else:
            bc = (Bm.view(b, s, h, n), Cm.view(b, s, h, n))
        args = (x, dt, *bc, dA)

        def plain():
            y, st = ssd_scan_ref(*(t.transpose(1, 2) for t in args))
            return y.transpose(1, 2), st
        return args, plain, (Bm, Cm)

    def contract_case(bh, s, p, n):
        dt = F.softplus(randn(bh, s))
        args = (randn(bh, s, p), dt, randn(bh, s, n, scale=0.3),
                randn(bh, s, n, scale=0.3), -0.1 * dt)
        return args, lambda: ssd_scan_ref(*args), args[2:4]

    bf = torch.bfloat16
    if serve_only:
        return (("serve", *model_case(B, S, H, P, N, bf)),)
    return (("serve", *model_case(B, S, H, P, N, bf)),
            ("per-head B/C", *model_case(2, 300, 4, P, N, bf, shared=False)),
            ("contract", *contract_case(48, 512, P, N)),
            ("ragged", *model_case(2, 100, 3, P, N, bf)),
            ("S=1", *model_case(2, 1, 3, P, N, bf)),
            ("S=q+1", *model_case(2, 65, 3, P, N, bf)),
            ("P!=N", *model_case(2, 300, 4, 16, 32, torch.float32)),
            ("P=40,N=72", *model_case(2, 300, 4, 40, 72, bf)),
            ("P=40,N=72 f32", *model_case(2, 300, 4, 40, 72, torch.float32, shared=False)),
            ("strong decay", *model_case(2, 1024, 4, P, N, bf, decay=2.0)))


def check_ssd(torch, timer) -> dict:
    """The SSD kernel against its plain version (f32 math, rtol = atol =
    2e-4 on y and the final state) on every case of :func:`ssd_cases`; two
    calls at the serving shape bit-identical; times at the serving shape.
    Two bounds: the f32 work on the CUDA cores (``f32_core_ms``, 67 TFLOP/s)
    and the same f32-accurate work on the bf16 tensor cores, the larger of
    its bytes and its split products at 989 TFLOP/s (``bound_ms``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost
    from repro_torch.kernels.ssd.ops import ssd_chunk

    cfg = get_config("mamba2_130m")
    d_in = cfg.ssm_expand * cfg.d_model
    B, S, H, P, N = SSM_REQUESTS, PROMPT_LEN, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    errs = []
    for label, args, plain, bc in ssd_cases(torch, B, S, H, P, N):
        y, st = ssd_chunk(*args)
        yr, sr = plain()
        errs += [compare(torch, y, yr, f"ssd {label} y", SSD_TOL),
                 compare(torch, st, sr, f"ssd {label} state", SSD_TOL)]
        say(f"  ssd {label} x {tuple(args[0].shape)} {str(args[0].dtype)[6:]} "
            f"strides {args[0].stride()} B strides {args[2].stride()} state "
            f"{tuple(st.shape)} max|err| y {errs[-2]:.3g} state {errs[-1]:.3g} "
            f"(max|y| {yr.abs().max().item():.3g})")
        if label == "serve":
            main = args, plain, bc, errs[-2]
            y2, st2 = ssd_chunk(*args)
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                raise AssertionError("ssd serve: two calls differ")
            say("  ssd serve: two calls bit-identical (y and state)")
        del y, st, yr, sr
    args, plain, bc, serve_err = main
    x, dt = args[:2]
    nb = cost.ssd_bytes(x.numel(), x.element_size(), dt.numel(), bc[0].numel(),
                        bc[0].element_size(), B * H * P * N)
    b_ms, b_by = cost.ssd(B, S, H, P, N, nb).bound_ms()
    f32_ms, _ = cost.ssd_f32_cores(B, S, H, P, N, nb).bound_ms()
    out = dict(max_abs_err=max(errs), serve_max_abs_err_y=serve_err,
               ms=timer.ms(lambda: ssd_chunk(*args), 20),
               plain_ms=timer.ms(plain, 5), library_ms=None,
               bound_ms=b_ms, bound_by=b_by, f32_core_ms=f32_ms,
               shape=[B, S, H, P, N])
    say(f"  ssd serve {out}")
    del args, plain, bc, main
    # Jamba's scan: N 16, the NP = 64 instantiation with 48 padded state
    # columns, at its prefill shape (d_inner 8192: 128 heads of 64)
    out["shapes"] = {}
    jb = get_config("jamba_v01_52b")
    jd = jb.ssm_expand * jb.d_model
    shape = (REQUESTS, PROMPT_LEN, jd // jb.ssm_head_dim, jb.ssm_head_dim, jb.ssm_state)
    (_, args, plain, bc), = ssd_cases(torch, *shape, serve_only=True)
    y, st = ssd_chunk(*args)
    yr, sr = plain()
    errs = [compare(torch, y, yr, "ssd jamba y", SSD_TOL),
            compare(torch, st, sr, "ssd jamba state", SSD_TOL)]
    del y, st, yr, sr
    x, dt = args[:2]
    nb = cost.ssd_bytes(x.numel(), x.element_size(), dt.numel(), bc[0].numel(),
                        bc[0].element_size(), math.prod(shape[0:1] + shape[2:]))
    b_ms, b_by = cost.ssd(*shape, nb).bound_ms()
    out["shapes"]["jamba"] = dict(
        max_abs_err=max(errs), ms=timer.ms(lambda: ssd_chunk(*args), 20),
        plain_ms=timer.ms(plain, 5), library_ms=None, bound_ms=b_ms,
        bound_by=b_by, shape=list(shape))
    say(f"  ssd jamba {json.dumps(out['shapes']['jamba'])}")
    return out


# ------------------------------- phase 3: pricing -----------------------------
def _max_abs_finite(a, b) -> float:
    """Largest |a - b| over the entries where both are finite."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0


def check_pricing(torch, timer) -> dict:
    """The pricing kernel, f64 and f32, on its two formulas: seeded rows plus
    hand-made edge rows (zero branches, NaN, ±inf, signed zeros). f64 must be
    bit-identical to its plain version on the card and to the numpy formula
    on the host; f32 within the drift band of that f64 reference, a feasible
    bit flipping only within the band of the capacity. The certification
    harnesses at n = 512, then times at 2^20 rows (the seeded rows tiled)."""
    import numpy as np

    from repro_torch.core.pricing import stack_plans
    from repro_torch.kernels import cost
    from repro_torch.kernels.pricing import (certify, certify_f32,
                                             pricing_f32, pricing_f64)
    from repro_torch.kernels.pricing.ops import f32_drift
    from repro_torch.kernels.pricing.ref import (FORMULAS, edge_plan_vectors,
                                                 pricing_ref,
                                                 random_plan_vectors,
                                                 random_roofline_columns)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    finite, special = edge_plan_vectors()
    inputs = {"price": stack_plans(random_plan_vectors(PRICE_ROWS, SEED)
                                   + finite + special),
              "roofline": random_roofline_columns(PRICE_ROWS, SEED)}
    say(f"  inputs: {PRICE_ROWS} seeded rows per formula, "
        f"{len(finite) + len(special)} edge rows for price "
        f"({time.perf_counter() - t0:.1f} s)")
    stacks, errs, drift_all = {}, {"pricing": 0.0, "pricing_f32": 0.0}, {}
    rel32 = 0.0
    for entry, cols in inputs.items():
        formula, names, outs, bools = FORMULAS[entry]
        x = torch.from_numpy(np.stack([cols[k] for k in names])).to(dev)
        stacks[entry] = x
        with np.errstate(all="ignore"):
            host = formula(np, cols)
        want = np.stack([np.asarray(host[k], np.float64) for k in outs])
        got = pricing_f64(x, entry)
        plain = pricing_ref(x, entry)
        torch.cuda.synchronize()
        got, plain = got.cpu().numpy(), plain.cpu().numpy()
        bad = {"plain": int((got.view(np.uint64) != plain.view(np.uint64)).sum()),
               "numpy": int((got.view(np.uint64) != want.view(np.uint64)).sum())}
        if any(bad.values()):
            raise AssertionError(f"pricing f64 {entry}: values whose bits "
                                 f"differ from the plain version / numpy: {bad}")
        errs["pricing"] = max(errs["pricing"], _max_abs_finite(got, plain))
        got32 = pricing_f32(x, entry)
        plain32 = pricing_ref(x, entry, f32=True)
        torch.cuda.synchronize()
        got32, plain32 = got32.cpu().numpy(), plain32.cpu().numpy()
        errs["pricing_f32"] = max(errs["pricing_f32"],
                                  _max_abs_finite(got32, plain32))
        got32_cols = {k: got32[i] != 0 if k in bools else got32[i]
                      for i, k in enumerate(outs)}
        vs_plain = f32_drift(got32_cols, {
            k: plain32[i] != 0 if k in bools else plain32[i].astype(np.float64)
            for i, k in enumerate(outs)}, cols.get("mem_capacity", 1.0))
        rel32 = max(rel32, max(vs_plain.values()))
        if not rel32 <= F32_PLAIN_REL:
            raise AssertionError(f"pricing f32 {entry}: relative difference "
                                 f"from its plain f32 version beyond "
                                 f"{F32_PLAIN_REL:g}: {vs_plain}")
        drifts = f32_drift(got32_cols, host, cols.get("mem_capacity", 1.0))
        drift_all[entry] = drifts
        say(f"  pricing {entry} {tuple(x.shape)}: f64 bit-identical to its "
            f"plain version and to numpy; f32 within "
            f"{max(vs_plain.values()):.3g} (relative) of its plain version, "
            f"largest relative drift from f64 per column "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in drifts.items()})}")
        if not max(drifts.values()) <= DRIFT_BAND:
            raise AssertionError(f"pricing f32 {entry}: drift beyond the band "
                                 f"{DRIFT_BAND:g}: {drifts}")
    rep64 = certify(n=512, device=dev)
    rep32 = certify_f32(n=512, band=DRIFT_BAND, device=dev)
    say(f"  certify: {rep64}; certify_f32: max drift {rep32['max_drift']:.3g}")

    numbers = {}
    reps = PRICE_TIMED_ROWS // PRICE_ROWS
    for name, kernel, f32 in (("pricing", pricing_f64, False),
                              ("pricing_f32", pricing_f32, True)):
        per = {}
        for entry, x in stacks.items():
            n_in, n_out = len(FORMULAS[entry][1]), len(FORMULAS[entry][2])
            xb = x[:, :PRICE_ROWS].repeat(1, reps)
            n = xb.shape[1]
            b_ms, b_by = cost.pricing(entry, n_in, n_out, n, f32).bound_ms()
            per[entry] = dict(
                ms=timer.ms(lambda: kernel(xb, entry), 50),
                plain_ms=timer.ms(lambda: pricing_ref(xb, entry, f32), 10),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=[n_in, n])
            del xb
        numbers[name] = dict(
            max_abs_err=errs[name], **per["price"], roofline=per["roofline"],
            **({"max_rel_err": rel32, "rel_err_limit": F32_PLAIN_REL,
                "max_rel_drift": max(max(d.values())
                                     for d in drift_all.values()),
                "drift_band": DRIFT_BAND}
               if f32 else {}))
        say(f"  {name} {numbers[name]}")
    return numbers


# ------------------------------- phase 3: training attention ------------------
TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
# the training kernels' cases: (label, (B, H, Hkv, Sq, Sk, hd, causal))
TRAIN_CASES = (("train", (TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, True)),
               ("gqa-ragged", (2, 24, 8, 1000, 1000, 128, True)),
               ("hd64-full", (2, 8, 2, 700, 900, 64, False)),
               # the forward's 128-row / 128-key tile edges, n_rep 4
               ("edge-127", (1, 8, 2, 127, 127, 128, True)),
               ("edge-128-full", (1, 8, 2, 128, 128, 128, False)),
               ("edge-129", (1, 8, 2, 129, 129, 64, True)),
               ("edge-257", (1, 8, 2, 257, 257, 32, True)),
               ("edge-sq>sk", (1, 8, 2, 300, 129, 128, True)))


def training_inputs(torch, shape, seed: int = SEED + 3):
    """Seeded bf16 q, k, v, dO in the model's (B, S, heads, hd) layout,
    handed over as (B, heads, S, hd) views."""
    b, h, hkv, sq, sk, hd, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda").bfloat16().transpose(1, 2)
    return (randn(b, sq, h, hd), randn(b, sk, hkv, hd), randn(b, sk, hkv, hd),
            randn(b, sq, h, hd))


def training_case(torch, q, k, v, do, causal: bool, label: str,
                  check: bool = True) -> dict:
    """Run the three training kernels once on (q, k, v, dO) and hold each
    output against its plain version: o, dq (per query row), dk, dv (per
    key row) within TRAIN_ROW_REL of their row's largest plain value, lse
    within 1e-3; with ``check``, a second call of each backward kernel must
    give the same bits (no atomics: one thread sums each output in one
    order). Returns, per output, the max abs error, the error over the
    whole tensor's max |plain| and the worst row's ratio. ``check=False``
    only measures (the planted-fault tool reads what would have failed)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd_lse)
    from repro_torch.kernels.flash_attention.ref import (
        attention_delta, flash_attention_bwd_dkv_ref,
        flash_attention_bwd_dq_ref, flash_attention_fwd_lse_ref)

    out = {}

    def held(name, got, want):
        torch.cuda.synchronize()
        whole, rows = row_scaled_errs(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        out[name] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                     "whole_scaled_err": whole, "row_scaled_err": rows,
                     "finite": finite}
        if check and not (finite and rows <= TRAIN_ROW_REL):
            raise AssertionError(
                f"{label} {name}: finite {finite}, a row's max |kernel - plain|"
                f" is {rows:.3g} x its max |plain| (limit {TRAIN_ROW_REL:g})")

    o, lse = flash_attention_fwd_lse(q, k, v, causal)
    orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
    held("o", o, orf)
    lse_err = (lse - lser).abs().max().item()
    out["lse"] = {"max_abs_err": lse_err}
    if check and not lse_err <= 1e-3 * max(1.0, lser.abs().max().item()):
        raise AssertionError(f"fwd_lse {label}: lse error {lse_err:.3g}")
    del orf
    # the backward kernels take the plain forward's statistics, so that
    # each kernel is held alone
    dd = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
    dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
    held("dk", dk, dkr)
    held("dv", dv, dvr)
    del dkr, dvr
    dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
    held("dq", dq, flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal))
    if check:
        dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
        dq2 = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
        out["bit_identical"] = all(bool(torch.equal(a, b)) for a, b in (
            (dk, dk2), (dv, dv2), (dq, dq2)))
        if not out["bit_identical"]:
            raise AssertionError(f"{label}: two calls of the backward kernels "
                                 f"gave different bits")
    out["inputs"] = (lse, dd)
    return out


def check_training_kernels(torch, timer) -> dict:
    """The forward with LSE and the dK/dV and dQ kernels against their plain
    versions (o and dq per query row, dk and dv per key row, within 2e-2 of
    the row's largest plain value; lse within 1e-3) at the olmo_1b training
    shape, a GQA ragged shape and hd 64 full attention, all in the model's
    (B, S, heads, hd) layout read transposed; times at the training shape.
    The library yardstick is scaled_dot_product_attention: its forward for
    the forward kernel; its backward (forward + backward through autograd,
    less the forward) does the work of both backward kernels together, so
    it stands beside their sum, not beside either one."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_fwd_lse)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
        flash_attention_fwd_lse_ref)

    cfg = get_config("olmo_1b")
    assert TRAIN_CASES[0][1][1:3] == (cfg.n_heads, cfg.n_kv_heads)
    assert TRAIN_CASES[0][1][5] == cfg.hd
    names = TRAIN_KERNELS
    errs = dict.fromkeys(names, 0.0)
    rel = dict.fromkeys(names, 0.0)
    of = {names[0]: ("o",), names[1]: ("dk", "dv"), names[2]: ("dq",)}
    for label, shape in TRAIN_CASES:
        q, k, v, do = training_inputs(torch, shape)
        causal = shape[-1]
        res = training_case(torch, q, k, v, do, causal, label)
        for name in names:
            errs[name] = max([errs[name]] + [res[x]["max_abs_err"] for x in of[name]])
            rel[name] = max([rel[name]] + [res[x]["row_scaled_err"] for x in of[name]])
        say(f"  training attention {label} q {tuple(q.shape)} k "
            f"{tuple(k.shape)} causal {causal}: worst row |err| / row max "
            + ", ".join(f"{x} {res[x]['row_scaled_err']:.3g}"
                        for x in ("o", "dk", "dv", "dq"))
            + f"; lse max|err| {res['lse']['max_abs_err']:.3g}; backward "
            f"bit-identical across two calls {res['bit_identical']}")
        if label == "train":
            main = (q, k, v, do, *res["inputs"])
        del res
        torch.cuda.empty_cache()

    q, k, v, do, lse, dd = main
    b, h, s, hd = q.shape
    work = {name: getattr(cost, name)(b, h, k.shape[1], s, s, hd, True)
            for name in names}
    calls = {names[0]: (lambda: flash_attention_fwd_lse(q, k, v, True),
                        lambda: flash_attention_fwd_lse_ref(q, k, v, True)),
             names[1]: (lambda: flash_attention_bwd_dkv(q, k, v, do, lse, dd, True),
                        lambda: flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, True)),
             names[2]: (lambda: flash_attention_bwd_dq(q, k, v, do, lse, dd, True),
                        lambda: flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, True))}
    # the kernels first, then the library, then the plain versions: a kernel
    # timed right after a plain version (GBs of f32 temporaries) can read
    # slower (dQ right after the plain dK/dV read 12 % slower on an H100)
    kernel_ms = {name: timer.ms(calls[name][0], 20) for name in names}
    lib_fwd = timer.ms(lambda: sdpa(F, q, k, v, causal=True), 20)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():
        for t in leaves:
            t.grad = None
        sdpa(F, *leaves, causal=True).backward(do)
    lib_fwd_bwd = timer.eager_ms(sdpa_fwd_bwd, 20)
    del leaves
    out = {}
    for name in names:
        plain = calls[name][1]
        b_ms, b_by = work[name].bound_ms()
        # no one library call computes dK/dV or dQ alone: SDPA's backward
        # is both kernels' work, and is given as the pair's yardstick
        lib = (dict(library_ms=lib_fwd) if name == names[0] else
               dict(library_ms=None,
                    library_bwd_pair_ms=lib_fwd_bwd - lib_fwd,
                    library_note="SDPA backward (forward + backward through "
                                 "autograd less the forward): the work of "
                                 "dK/dV and dQ together"))
        out[name] = dict(max_abs_err=errs[name], max_row_scaled_err=rel[name],
                         row_scaled_err_limit=TRAIN_ROW_REL,
                         ms=kernel_ms[name],
                         plain_ms=timer.ms(plain, 3), **lib,
                         bound_ms=b_ms, bound_by=b_by,
                         gflop=work[name].flops / 1e9,
                         shape=[b, h, k.shape[1], s, s, hd])
    pair = out[names[1]]["ms"] + out[names[2]]["ms"]
    for name in names[1:]:
        out[name]["bwd_pair_ms"] = pair
    for name in names:
        say(f"  {name} train {out[name]}")
    return out


# ------------------------------- phase 3: the kernels' contract ---------------
# The Pallas kernels take float32 and bfloat16 at any head dim that fits;
# the port's rows 1-3 and 5-7 take both dtypes at hd 16, 32, 64 and 128.
# Each instantiation of that contract beyond the bf16 ones at hd 32, 64 and
# 128 (hd 16 in bf16; float32 at every hd) is held here against its plain
# version, in bf16 at phase 3's TOL (and the
# row and ulp checks of the bf16 instantiations), in float32 at the
# reference's own float32 tolerances (tests/test_kernels.py,
# tests/test_flash_backward.py): 2e-5 for the forward kernels, 2e-4 for the
# backward, with TF32 off (main sets it). Each is timed at the shape its
# path gives it (hd 16: the SMOKE configs' heads at the serving length; f32
# hd 128: mistral_nemo_12b's float32 serving and olmo_1b's float32 training
# shapes) beside its bound, its plain version and SDPA twice: its default
# call (``enable_gqa``; the backend that answers is named by PyTorch's own
# chooser) and its memory-efficient backend over K/V expanded outside the
# call (where it runs), ``library_ms`` the faster. A float32 attention entry
# carries two bounds: ``bound_ms`` at the split rate of the TF32 tensor
# cores (the least time at float32 accuracy, as its kernel computes) and
# ``core_bound_ms`` at the CUDA cores' 67 TFLOP/s.
F32_TOL = dict(rtol=2e-5, atol=2e-5)
F32_BWD_TOL = dict(rtol=2e-4, atol=2e-4)
CONTRACT_HDS = (16, 32, 64, 128)
#: the float32 model's serving shape (phase 24: 1 request x 2048 + 32,
#: cut from 2 to hold the run under RUN_LIMIT_S)
F32_REQUESTS = 1
#: the float32 training shape (phase 8f: olmo_1b, 4 x 2048)
F32_TRAIN_BATCH = 4
#: the float32 head dims a main path runs (the SMOKE configs' 16 and 32,
#: the full configs' 128); hd 64 is held here and runs on no path
F32_PATH_HDS = (16, 32, 128)


def contract_flash_cases(hd: int, dtype: str) -> tuple:
    """The serving forward's cases at ``hd``: (label, (B, H, Hkv, Sq, Sk,
    causal)). The first is the timed one: the hd-16 SMOKE configs' heads
    (8/2) at the serving length, or mistral_nemo_12b's float32 prefill."""
    if hd == 128 and dtype == "f32":
        first = ("serve f32", (F32_REQUESTS, 32, 8, PROMPT_LEN, PROMPT_LEN, True))
    else:
        first = ("serve", (REQUESTS, 8, 2, PROMPT_LEN, PROMPT_LEN, True))
    return (first,
            ("smoke", (2, 6, 2, 16, 16, True)),          # minitron SMOKE's 6/2
            ("ragged-causal", (2, 8, 8, 1000, 1000, True)),
            ("ragged-full", (1, 8, 2, 70, 130, False)),
            ("causal-sq>sk", (2, 4, 2, 130, 70, True)),
            ("edge-127", (1, 8, 2, 127, 127, True)),
            ("edge-129", (1, 8, 2, 129, 129, True)),
            ("edge-257-full", (1, 8, 2, 257, 257, False)),
            ("gqa16", (1, 64, 4, 200, 200, True)))


def contract_train_cases(hd: int, dtype: str) -> tuple:
    """The training kernels' cases at ``hd``, the first timed: olmo_1b's
    float32 shape at hd 128, else the SMOKE heads at the training length."""
    if hd == 128 and dtype == "f32":
        first = ("train f32", (F32_TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, True))
    else:
        first = ("train", (F32_TRAIN_BATCH, 8, 2, TRAIN_SEQ, TRAIN_SEQ, True))
    return (first,
            ("smoke", (2, 4, 2, 16, 16, True)),
            ("gqa-ragged", (2, 6, 2, 1000, 1000, True)),
            ("full", (2, 8, 2, 300, 500, False)),
            ("edge-129", (1, 8, 2, 129, 129, True)),
            ("edge-sq>sk", (1, 8, 2, 300, 129, True)))


def contract_decode_cases(hd: int, dtype: str) -> tuple:
    """Decode's cases at ``hd``: (label, (B, H, Hkv, S, kv_len)), the first
    timed: the hd-16 SMOKE heads over the serving cache, or
    mistral_nemo_12b's float32 decode; kv_len 0, 1 and S; GQA 3 and 16."""
    s = PROMPT_LEN + NEW_TOKENS + 1
    last = PROMPT_LEN + NEW_TOKENS - 1
    if hd == 128 and dtype == "f32":
        first = ("serve f32", (F32_REQUESTS, 32, 8, s, last))
    else:
        first = ("serve", (REQUESTS, 8, 2, s, last))
    return (first,
            ("kv_len 0", (REQUESTS, 8, 2, s, 0)),
            ("kv_len 1", (REQUESTS, 8, 2, s, 1)),
            ("kv_len S", (REQUESTS, 8, 2, s, s)),
            ("smoke", (2, 6, 2, 21, 17)),
            ("ragged-mha", (3, 8, 8, 300, 299)),
            ("gqa16", (2, 64, 4, 600, 577)))


def contract_inputs(torch, g, b, heads, s, hd, dtype):
    """Seeded (B, heads, S, hd) views of (B, S, heads, hd) tensors."""
    return torch.randn((b, s, heads, hd), generator=g, device="cuda").to(dtype).transpose(1, 2)


def sdpa_yardstick(torch, timer, q, k, v, causal: bool, do=None) -> dict:
    """SDPA at a path's shape, two ways: the default call
    (``enable_gqa``), its backend named by PyTorch's own chooser
    (``torch._fused_sdp_choice``, what the call dispatches on), and the
    memory-efficient backend with K/V expanded over the GQA group outside
    the call (in float32 the split-TF32 kernel, where it runs). Forward times, or with
    ``do`` the backward's (forward and backward through autograd less the
    forward). Returns {"library_ms": the faster, "library_backend",
    "library_times": {way: ms}}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    n_rep = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(n_rep, 1) for t in (k, v))
    backend = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                                 enable_gqa=True)).name.lower()

    def efficient(*args):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*args, is_causal=causal)

    ways = {f"default ({backend})":
            (lambda *a: sdpa(F, *a, causal), (q, k, v)),
            "efficient, K/V expanded": (efficient, (q, ke, ve))}
    times = {}
    for way, (fn, args) in ways.items():
        try:
            fwd = timer.ms(lambda: fn(*args), 10)
            if do is None:
                times[way] = fwd
                continue
            leaves = [t.detach().clone().requires_grad_(True) for t in args]

            def fwd_bwd():
                for t in leaves:
                    t.grad = None
                fn(*leaves).backward(do)
            times[way] = timer.eager_ms(fwd_bwd, 10) - fwd
        except RuntimeError as err:      # the backend refuses these inputs
            say(f"    SDPA {way}: {str(err).splitlines()[0][:120]}")
    best = min(times, key=times.get)
    return dict(library_ms=times[best], library_backend=best, library_times=times)


def check_contract_flash(torch, timer, dtype: str, hd: int) -> dict:
    """The serving forward at ``hd`` in ``dtype`` against its plain version
    over :func:`contract_flash_cases`, timed at the first."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + hd)
    errs, rows, main = [], [], None
    for label, (b, h, hkv, sq, sk, causal) in contract_flash_cases(hd, dtype):
        args = (contract_inputs(torch, g, b, h, sq, hd, dt),
                contract_inputs(torch, g, b, hkv, sk, hd, dt),
                contract_inputs(torch, g, b, hkv, sk, hd, dt))
        o = flash_attention(*args, causal=causal)
        want = flash_attention_ref(*args, causal=causal)
        name = f"flash[{dtype}/hd{hd}] {label}"
        errs.append(compare(torch, o, want, name, F32_TOL if dtype == "f32" else TOL))
        rows.append(row_scaled_errs(o, want)[1])
        if dtype == "bf16" and not rows[-1] <= TRAIN_ROW_REL:
            raise AssertionError(f"{name}: a row's max |kernel - plain| is "
                                 f"{rows[-1]:.3g} x its max |plain|")
        if main is None:
            main = (args, (b, h, hkv, sq, sk, causal))
        del o, want
    args, (b, h, hkv, sq, sk, causal) = main
    w = cost.flash_attention(b, h, hkv, sq, sk, hd, causal, f32=dtype == "f32")
    b_ms, b_by = w.bound_ms()
    lib = sdpa_yardstick(torch, timer, *args, causal)
    if dtype == "f32":
        lib["core_bound_ms"] = cost.f32_cores(w).bound_ms()[0]
    lib["exp_bound_ms"] = cost.exponentials("flash_attention", b, h, hkv, sq, sk, hd, causal,
                                            f32=dtype == "f32").bound_ms()[0]
    return dict(max_abs_err=max(errs), max_row_scaled_err=max(rows),
                ms=timer.ms(lambda: flash_attention(*args, causal=causal), 10),
                plain_ms=timer.ms(lambda: flash_attention_ref(*args, causal=causal), 3),
                **lib, bound_ms=b_ms, bound_by=b_by, shape=[b, h, hkv, sq, sk, hd, causal])


def check_contract_training(torch, timer, dtype: str, hd: int) -> dict:
    """The forward with LSE, dK/dV and dQ at ``hd`` in ``dtype`` against
    their plain versions over :func:`contract_train_cases` (bf16: each row
    within TRAIN_ROW_REL, as phase 3's; f32: element-wise at F32_TOL and
    F32_BWD_TOL), the backward bit-identical across two calls; timed at the
    first case. In bf16 the forward with LSE's ``library_ms`` is the aten call
    that returns O and the logsumexp (:func:`sdpa_lse`), SDPA's forward
    beside it. Returns {wrapper: entry}."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd_lse)
    from repro_torch.kernels.flash_attention.ref import (
        attention_delta, flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
        flash_attention_fwd_lse_ref)

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 3 + hd)
    names = TRAIN_KERNELS
    errs = dict.fromkeys(names, 0.0)
    main = None
    for label, (b, h, hkv, sq, sk, causal) in contract_train_cases(hd, dtype):
        q = contract_inputs(torch, g, b, h, sq, hd, dt)
        k = contract_inputs(torch, g, b, hkv, sk, hd, dt)
        v = contract_inputs(torch, g, b, hkv, sk, hd, dt)
        do = contract_inputs(torch, g, b, h, sq, hd, dt)
        tag = f"training attention [{dtype}/hd{hd}] {label}"
        if dtype == "bf16":
            res = training_case(torch, q, k, v, do, causal, tag)
            lse, dd = res["inputs"]
            errs[names[0]] = max(errs[names[0]], res["o"]["max_abs_err"])
            errs[names[1]] = max(errs[names[1]], res["dk"]["max_abs_err"],
                                 res["dv"]["max_abs_err"])
            errs[names[2]] = max(errs[names[2]], res["dq"]["max_abs_err"])
        else:
            o, lse = flash_attention_fwd_lse(q, k, v, causal)
            orf, lser = flash_attention_fwd_lse_ref(q, k, v, causal)
            errs[names[0]] = max(errs[names[0]], compare(torch, o, orf, f"{tag} o", F32_TOL),
                                 compare(torch, lse, lser, f"{tag} lse", F32_TOL))
            dd = attention_delta(o, do)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
            dkr, dvr = flash_attention_bwd_dkv_ref(q, k, v, do, lser, dd, causal)
            errs[names[1]] = max(errs[names[1]],
                                 compare(torch, dk, dkr, f"{tag} dk", F32_BWD_TOL),
                                 compare(torch, dv, dvr, f"{tag} dv", F32_BWD_TOL))
            dq = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
            errs[names[2]] = max(errs[names[2]], compare(
                torch, dq, flash_attention_bwd_dq_ref(q, k, v, do, lser, dd, causal),
                f"{tag} dq", F32_BWD_TOL))
            dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lser, dd, causal)
            dq2 = flash_attention_bwd_dq(q, k, v, do, lser, dd, causal)
            if not all(bool(torch.equal(x, y)) for x, y in ((dk, dk2), (dv, dv2), (dq, dq2))):
                raise AssertionError(f"{tag}: two calls of the backward kernels "
                                     f"gave different bits")
            lse = lser
            del o, orf, dk, dv, dkr, dvr, dq, dk2, dv2, dq2
        if main is None:
            main = (q, k, v, do, lse, dd, (b, h, hkv, sq, sk, causal))
    q, k, v, do, lse, dd, (b, h, hkv, sq, sk, causal) = main
    calls = {names[0]: (lambda: flash_attention_fwd_lse(q, k, v, causal),
                        lambda: flash_attention_fwd_lse_ref(q, k, v, causal)),
             names[1]: (lambda: flash_attention_bwd_dkv(q, k, v, do, lse, dd, causal),
                        lambda: flash_attention_bwd_dkv_ref(q, k, v, do, lse, dd, causal)),
             names[2]: (lambda: flash_attention_bwd_dq(q, k, v, do, lse, dd, causal),
                        lambda: flash_attention_bwd_dq_ref(q, k, v, do, lse, dd, causal))}
    kernel_ms = {name: timer.ms(calls[name][0], 10) for name in names}
    lib_fwd = sdpa_yardstick(torch, timer, q, k, v, causal)
    if dtype == "bf16":
        # the one aten call that returns O and the logsumexp, as the kernel
        call, lse_call = sdpa_lse(torch, q, k, v, causal)
        lib_fwd = dict(library_ms=timer.ms(call, 10),
                       library_backend=f"aten.{lse_call} (K/V expanded outside the call)",
                       library_lse_err=(call()[1] - lse).abs().max().item(),
                       library_sdpa_fwd_ms=lib_fwd["library_ms"],
                       library_sdpa_fwd_backend=lib_fwd["library_backend"])
    bwd = sdpa_yardstick(torch, timer, q, k, v, causal, do)
    lib_pair = dict(library_bwd_pair_ms=bwd["library_ms"],
                    library_bwd_backend=bwd["library_backend"],
                    library_bwd_times=bwd["library_times"])
    out = {}
    for name in names:
        w = getattr(cost, name)(b, h, hkv, sq, sk, hd, causal, f32=dtype == "f32")
        b_ms, b_by = w.bound_ms()
        lib = (lib_fwd if name == names[0] else
               dict(library_ms=None, **lib_pair,
                    library_note="SDPA backward (forward + backward through "
                                 "autograd less the forward): the work of "
                                 "dK/dV and dQ together"))
        if dtype == "f32":
            lib = dict(lib, core_bound_ms=cost.f32_cores(w).bound_ms()[0])
        lib = dict(lib, exp_bound_ms=cost.exponentials(
            name, b, h, hkv, sq, sk, hd, causal, f32=dtype == "f32").bound_ms()[0])
        out[name] = dict(max_abs_err=errs[name], ms=kernel_ms[name],
                         plain_ms=timer.ms(calls[name][1], 3), **lib,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=[b, h, hkv, sq, sk, hd, causal])
    return out


def f32_decode_check(torch, q, k, v, kv_len: int, o, lse, label: str,
                     check: bool = True) -> dict:
    """A float32 decode call held (always; ``check`` is
    :func:`decode_check`'s): at kv_len 0 o = 0 and lse = -1e30, else o and
    lse within F32_TOL of the plain version. Returns {"o_err": max |o -
    plain|}."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    torch.cuda.synchronize()
    kv_len = max(0, min(kv_len, k.shape[2]))
    if kv_len == 0:
        if not (bool((o == 0).all()) and bool((lse == -1e30).all())):
            raise AssertionError(f"{label}: kv_len 0 must give o = 0, lse = -1e30")
        return {"o_err": 0.0}
    orf, lser = decode_attention_ref(q, k, v, kv_len, return_lse=True)
    compare(torch, lse, lser, f"{label} lse", F32_TOL)
    return {"o_err": compare(torch, o, orf, f"{label} o", F32_TOL)}


def decode_graph_times(torch, timer, probe, fn, b, h, hkv, s, hd, kv_len, dt) -> dict:
    """Decode at one shape as GRAPH_LAUNCHES launches, each over its own
    cache (~1 MB apiece at the hd-16 SMOKE shape, 86 MB in all: each launch
    reads device memory), captured in one graph and replayed after a read
    of the flush buffer, per launch; beside it the same graph of an empty
    kernel with the decode launch's block count and threads (the floor
    under a launch in a graph) and of SDPA over the valid prefix."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import plan

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    n = GRAPH_LAUNCHES
    cases = [(torch.randn((b, h, hd), generator=g, device="cuda").to(dt),
              contract_inputs(torch, g, b, hkv, s, hd, dt),
              contract_inputs(torch, g, b, hkv, s, hd, dt)) for _ in range(n)]
    kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
    pl = plan(b, h, hkv, hd)
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # noqa: E731

    def graph(call):
        return timer.ms(lambda: [call(c) for c in cases], 20, clean_l2=True) / n

    def empty(_=None):
        _build.check("decode_attention", probe.empty_launch(
            pl["n_split"] * pl["groups"], DECODE_LANES_THREADS, stream()))
    out = dict(graph_ms=graph(lambda c: fn(*c, kl)), empty_graph_ms=graph(empty),
               library_graph_ms=graph(lambda c: sdpa(F, c[0][:, :, None], c[1][:, :, :kv_len],
                                                     c[2][:, :, :kv_len], causal=False)),
               empty_ms=timer.ms(empty, 50), graph_launches=n)
    del cases
    return out


#: the hd-16 and hd-64 decode kernel's threads a block (decode_attention.cu,
#: LANES_THREADS): the empty launch beside it takes the same
DECODE_LANES_THREADS = 160
#: The times of the hd-16 kernels these replaced (the hd-128 designs
#: instantiated at hd 16) at the same shapes, as PERF.md section 6 records
#: them (chip_smoke.py on an H100 80GB HBM3, 700 W): printed beside this
#: run's readings, never in the kernels line.
RECORDED_HD16_MS = {"decode_attention": 0.01363, "flash_attention_bwd_dkv": 0.12171,
                    "flash_attention": 0.04921, "flash_attention_fwd_lse": 0.04947,
                    "flash_attention_bwd_dq": 0.05184}
#: a decode launch slower than this gave up a wait (its watchdog, ~2 s)
DECODE_STUCK_MS = 1.0


def check_contract_decode(torch, timer, dtype: str, hd: int, probe=None) -> dict:
    """Decode attention at ``hd`` in ``dtype`` against its plain version over
    :func:`contract_decode_cases`, each called eagerly with a device kv_len
    and, for the first case, through one captured launch replayed with
    kv_len changed on the device; bf16 held by :func:`decode_check`, f32
    at F32_TOL, over both a bf16 cache (a float32 model's) and an f32 one.
    Timed at the first case with the cache the path reads; a launch over
    DECODE_STUCK_MS fails (a wait that gave up leaves right outputs where it
    is the producer's last). bf16 at hd 16 with ``probe``: also
    :func:`decode_graph_times`."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    caches = (torch.bfloat16, torch.float32) if dtype == "f32" else (torch.bfloat16,)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7 + hd)
    errs, main = [], None
    for cdt in caches:
        for label, (b, h, hkv, s, kv_len) in contract_decode_cases(hd, dtype):
            q = torch.randn((b, h, hd), generator=g, device="cuda").to(dt)
            k = contract_inputs(torch, g, b, hkv, s, hd, cdt)
            v = contract_inputs(torch, g, b, hkv, s, hd, cdt)
            kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
            o, lse = decode_attention(q, k, v, kl)
            tag = f"decode[{dtype}/hd{hd}, {str(cdt)[6:]} cache] {label}"
            hold = decode_check if dtype == "bf16" else f32_decode_check
            errs.append(hold(torch, q, k, v, kv_len, o, lse, tag)["o_err"])
            if main is None:
                main = (q, k, v, kv_len, (b, h, hkv, s))
                lens = (0, 1, 17, kv_len // 2, kv_len, s, s + 100)
                reps = decode_replay_check(torch, decode_attention, q, k, v, lens,
                                           f"{tag} replayed", hold=hold)
                errs += [x["o_err"] for x in reps.values()]
            del o, lse
    q, k, v, kv_len, (b, h, hkv, s) = main
    kl = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
    kc, vc = k[:, :, :kv_len].to(dt), v[:, :, :kv_len].to(dt)
    b_ms, b_by = cost.decode_attention(b, h, hkv, hd, kv_len, f32=dtype == "f32",
                                       cache_bytes=k.element_size()).bound_ms()
    ms = timer.ms(lambda: decode_attention(q, k, v, kl), 50)
    if not ms < DECODE_STUCK_MS:
        raise AssertionError(f"decode[{dtype}/hd{hd}]: {ms:.3f} ms a launch: a wait gave up")
    extra = {}
    if (dtype, hd) == ("bf16", 16) and probe is not None:
        extra = decode_graph_times(torch, timer, probe, decode_attention, b, h, hkv, s, hd,
                                   kv_len, dt)
    return dict(max_abs_err=max(errs), ms=ms, **extra,
                exp_bound_ms=cost.exponentials("decode_attention", b, h, hkv, hd, kv_len,
                                               f32=dtype == "f32",
                                               cache_bytes=k.element_size()).bound_ms()[0],
                plain_ms=timer.ms(lambda: decode_attention_ref(q, k, v, kl,
                                                               return_lse=True), 10),
                library_ms=timer.ms(lambda: sdpa(F, q[:, :, None], kc, vc, causal=False), 50),
                library_note=("SDPA over the valid prefix of the cache in q's dtype"
                              + (" (the bf16 cache cast to f32 outside the call)"
                                 if k.dtype != dt else "")),
                bound_ms=b_ms, bound_by=b_by, cache_dtype=str(k.dtype),
                shape=[b, h, hkv, s, hd, kv_len])


#: row 1 in float32, (label, rows, d, kind): the float32 mistral_nemo_12b
#: serving path's residual norms (decode, 2 x 2048 prefill), the first norm,
#: Mamba2's gated norm with a float32 gate read through its row stride
#: (decode and prefill), ragged widths on the scalar path; the first shape
#: of each of the forward and the backward is timed.
RMSNORM_F32_SHAPES = (("mistral f32 prefill", F32_REQUESTS * PROMPT_LEN, 5120, "residual"),
                      ("mistral f32 decode", F32_REQUESTS, 5120, "residual"),
                      ("mistral f32 first norm", F32_REQUESTS, 5120, "plain"),
                      ("mamba2 f32 decode gated", SSM_REQUESTS, 1536, "gated"),
                      ("mamba2 f32 prefill gated", SSM_REQUESTS * PROMPT_LEN, 1536, "gated"),
                      ("wide f32", 300, 12288, "residual"),
                      ("ragged f32", 7, 100, "residual"),
                      ("ragged f32 gated", 3, 770, "gated"))


def rmsnorm_f32_inputs(torch, g, rows: int, d: int, kind: str) -> dict:
    """Seeded float32 inputs of one call: x, r (residual), w in [0.5, 1.5),
    the gate z as the first d columns of a wider (rows, 2 d + 280) tensor,
    and dh, dr for the backward."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    inp = {"x": randn(rows, d), "w": torch.rand(d, generator=g, device=dev) + 0.5,
           "r": randn(rows, d) if kind == "residual" else None,
           "z": (2 * randn(rows, 2 * d + 280))[:, :d] if kind == "gated" else None,
           "dh": randn(rows, d), "dr": randn(rows, d) if kind == "residual" else None}
    return inp


def check_contract_rmsnorm(torch, timer) -> dict:
    """Row 1 and its backward in float32 against their plain versions at
    RMSNORM_F32_SHAPES (F32_TOL forward, F32_BWD_TOL backward), the gated
    norm over rows split in two blocks (each statistic and apply launch,
    forward and backward, and the blocks against the one-launch norm);
    timed at the first shape beside F.rms_norm (after the add) and its
    backward under autograd. Returns {"rmsnorm": .., "rmsnorm_bwd": ..}."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.rmsnorm.ops import (
        MAX_D_BWD, fused_rmsnorm, fused_rmsnorm_bwd, gated_norm_apply,
        gated_norm_bwd_apply, gated_norm_bwd_stat, gated_norm_stat)
    from repro_torch.kernels.rmsnorm.ref import (fused_rmsnorm_bwd_ref,
                                                 fused_rmsnorm_ref)

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    errs, bwd_errs, main = [0.0], [0.0], None
    for label, rows, d, kind in RMSNORM_F32_SHAPES:
        inp = rmsnorm_f32_inputs(torch, g, rows, d, kind)
        x, w, r, z = inp["x"], inp["w"], inp["r"], inp["z"]
        y, rout = fused_rmsnorm(x, w, r, eps=RMSNORM_EPS, gate=z)
        wy, wr = fused_rmsnorm_ref(x, w, r, eps=RMSNORM_EPS, gate=z)
        errs.append(compare(torch, y, wy, f"rmsnorm f32 {label}", F32_TOL))
        if rout is not None:
            errs.append(compare(torch, rout, wr, f"rmsnorm f32 {label} residual", F32_TOL))
        dr = inp["dr"]
        if d > MAX_D_BWD:                   # the backward's widest row
            continue
        got = fused_rmsnorm_bwd(inp["dh"], dr, x, w, r, RMSNORM_EPS, z)
        want = fused_rmsnorm_bwd_ref(inp["dh"], dr, x, w, r, RMSNORM_EPS, z)
        for part, a, b in zip(("dx", "d2", "dw"), got, want):
            if b is not None:
                bwd_errs.append(compare(torch, a, b, f"rmsnorm_bwd f32 {label} {part}",
                                        F32_BWD_TOL))
        if main is None:
            main = inp
        say(f"  rmsnorm f32 {label} ({rows}, {d}) {kind}: forward max|err| "
            f"{max(errs):.3g}, backward {max(bwd_errs):.3g}")
    # the gated norm over rows split in two blocks, each launch alone
    inp = rmsnorm_f32_inputs(torch, g, SSM_REQUESTS * 64, 1536, "gated")
    x, w, z, dh = inp["x"], inp["w"], inp["z"], inp["dh"]
    half = x.shape[1] // 2
    blocks = [(x[:, i * half:(i + 1) * half].contiguous(), z[:, i * half:(i + 1) * half],
               w[i * half:(i + 1) * half].contiguous(), dh[:, i * half:(i + 1) * half].contiguous())
              for i in range(2)]
    stats = sum(gated_norm_stat(bx, bz, bw) for bx, bz, bw, _ in blocks)
    ys = [gated_norm_apply(bx, bz, bw, stats, x.shape[1], RMSNORM_EPS)
          for bx, bz, bw, _ in blocks]
    whole = fused_rmsnorm(x, w, eps=RMSNORM_EPS, gate=z)[0]
    errs.append(compare(torch, torch.cat(ys, 1), whole, "split f32 forward", F32_TOL))
    bstats = sum(gated_norm_bwd_stat(bdh, bx, bz, bw) for bx, bz, bw, bdh in blocks)
    parts = [gated_norm_bwd_apply(bdh, bx, bz, bw, bstats, x.shape[1], RMSNORM_EPS)
             for bx, bz, bw, bdh in blocks]
    wdx, wdz, wdw = fused_rmsnorm_bwd(dh, None, x, w, None, RMSNORM_EPS, z)
    for i, (name, want) in enumerate((("dy", wdx), ("dz", wdz), ("dw", wdw))):
        got = torch.cat([p[i] for p in parts], -1)
        bwd_errs.append(compare(torch, got, want, f"split f32 backward {name}", F32_BWD_TOL))
    say(f"  gated norm f32 over two blocks of {half}: forward and backward held")

    x, w, r, dh, dr = main["x"], main["w"], main["r"], main["dh"], main["dr"]
    rows, d = x.shape
    b_ms, b_by = cost.rmsnorm(rows, d, "residual", f32=True).bound_ms()
    fwd = dict(max_abs_err=max(errs),
               ms=timer.ms(lambda: fused_rmsnorm(x, w, r, eps=RMSNORM_EPS), 20),
               plain_ms=timer.ms(lambda: fused_rmsnorm_ref(x, w, r, eps=RMSNORM_EPS), 5),
               library_ms=timer.ms(lambda: F.rms_norm(x + r, (d,), w, RMSNORM_EPS), 20),
               library_note="F.rms_norm after the residual add (two calls)",
               bound_ms=b_ms, bound_by=b_by, shape=[rows, d, "residual"])
    b_ms, b_by = cost.rmsnorm_bwd(rows, d, "residual", True, f32=True).bound_ms()
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, r)]

    def library_bwd():
        for t in leaves:
            t.grad = None
        s = leaves[0] + leaves[2]
        torch.autograd.backward([F.rms_norm(s, (d,), leaves[1], RMSNORM_EPS), s], [dh, dr])
    bwd = dict(max_abs_err=max(bwd_errs),
               ms=timer.ms(lambda: fused_rmsnorm_bwd(dh, dr, x, w, r, RMSNORM_EPS), 20),
               plain_ms=timer.ms(lambda: fused_rmsnorm_bwd_ref(dh, dr, x, w, r, RMSNORM_EPS), 5),
               library_ms=timer.eager_ms(library_bwd, 10),
               library_note="F.rms_norm's backward under autograd (forward included)",
               bound_ms=b_ms, bound_by=b_by, shape=[rows, d, "residual"])
    return {"rmsnorm": fwd, "rmsnorm_bwd": bwd}


def check_contract(torch, timer, probe=None) -> tuple[dict, dict]:
    """Phase 3's checks of the contract's further instantiations: hd 16 in bf16
    (decode, the serving forward and the three training kernels) and float32
    at hd 16, 32, 64 and 128, and row 1 and its backward in float32. Each
    attention entry has the exponentials' second bound (``exp_bound_ms``);
    with ``probe`` (PROBE_SOURCE's library), bf16 decode at hd 16 is also
    timed as GRAPH_LAUNCHES launches in one graph beside an empty kernel
    (:func:`decode_graph_times`). Returns (entries keyed "<wrapper>[<kind>]"
    for the kinds a main path runs, the float32 hd-64 entries, held but on
    no path)."""
    out, off_path = {}, {}
    for dtype, hds in (("bf16", (16,)), ("f32", CONTRACT_HDS)):
        for hd in hds:
            kind = f"{dtype}/hd{hd}"
            got = {"flash_attention": check_contract_flash(torch, timer, dtype, hd),
                   "decode_attention": check_contract_decode(torch, timer, dtype, hd,
                                                             probe),
                   **check_contract_training(torch, timer, dtype, hd)}
            dest = out if dtype == "bf16" or hd in F32_PATH_HDS else off_path
            for name, entry in got.items():
                dest[f"{name}[{kind}]"] = entry
                say(f"  {name}[{kind}]: {json.dumps(entry)}")
                if kind == "bf16/hd16" and name in RECORDED_HD16_MS:
                    lib = entry.get("library_ms")
                    say(f"    beside the replaced kernel's {RECORDED_HD16_MS[name]} ms "
                        f"(recorded, PERF.md section 6): {entry['ms']:.5f} ms now, "
                        f"{RECORDED_HD16_MS[name] / entry['ms']:.2f}x; library "
                        + (f"{lib:.5f} ms" if lib is not None else
                           f"none alone (SDPA's backward pair "
                           f"{entry['library_bwd_pair_ms']:.5f} ms)")
                        + f"; bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}), "
                        f"exponentials {entry['exp_bound_ms']:.5f} ms "
                        f"({entry['exp_bound_ms'] / entry['ms']:.1%} of it)")
            torch.cuda.empty_cache()
    for name, entry in check_contract_rmsnorm(torch, timer).items():
        out[f"{name}[f32]"] = entry
        say(f"  {name}[f32]: {json.dumps(entry)}")
    return out, off_path


# ------------------------------- phase 4 --------------------------------------
def exact_rows(rows: list[dict]) -> list[dict]:
    """Sweep rows with every float spelled exactly (``float.hex``)."""
    return [{k: v.hex() if isinstance(v, float) else v for k, v in r.items()}
            for r in rows]


def _timed_out(what: str, seconds: float = PARALLEL_TIMEOUT_S) -> None:
    print(f"chip_smoke: FAILED: {what} did not finish in {seconds} s",
          file=sys.stderr, flush=True)
    os._exit(1)


def check_dse(kernels) -> dict[str, int]:
    """The DSE price phase on the card: every smoke scenario swept on the
    kernel backends (and the eager torch one) against the numpy backend, one
    parallel sweep after CUDA is initialized (forkserver workers), and
    ``reprice_grid`` on the dense grid with its phase split. Each run's
    launch counters are zeroed just before it and read just after; returns
    the pricing launches summed over the runs."""
    import warnings

    import torch

    from repro_torch.core import DSEEngine
    from repro_torch.search import DenseGridSpec
    from repro_torch.workloads.scenarios import get_scenario

    total = {"pricing": 0, "pricing_f32": 0}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        c = kernels.launches()
        if any(v for k, v in c.items() if k not in total):
            raise AssertionError(f"serving kernels launched on the DSE path: {c}")
        for k in total:
            total[k] += c[k]
        return out, c

    t0 = time.perf_counter()
    for name in SMOKE_SCENARIOS:
        want = exact_rows(DSEEngine(parallel=False, pricing_backend="numpy")
                          .sweep_scenario(name, smoke=True).rows())
        note = []
        for backend in ("kernel", "kernel-f32", "torch"):
            engine = DSEEngine(parallel=False, pricing_backend=backend)
            res, c = counted(lambda: engine.sweep_scenario(name, smoke=True))
            if exact_rows(res.rows()) != want:
                raise AssertionError(f"sweep {name} on {backend}: rows differ "
                                     f"from the numpy backend's")
            key = "pricing_f32" if backend == "kernel-f32" else "pricing"
            if backend != "torch" and not c[key]:
                raise AssertionError(f"sweep {name} on {backend}: no launch")
            note.append(f"{backend} {c[key] if backend != 'torch' else 0}")
            if backend == "kernel-f32":
                drift = engine.last_drift_stats
                if not drift["max_iter_drift"] <= DRIFT_BAND:
                    raise AssertionError(f"sweep {name}: drift {drift}")
                note.append(f"max iter drift {drift['max_iter_drift']:.3g}")
        say(f"  sweep {name} smoke: {len(want)} rows identical to numpy on "
            f"kernel, kernel-f32 and torch; launches {', '.join(note)}")
    say(f"  seven scenarios x four backends in {time.perf_counter() - t0:.1f} s")

    engine = DSEEngine(parallel=True, max_workers=2, pricing_backend="kernel")
    method = engine._start_method()
    if method != "forkserver":
        raise AssertionError(f"CUDA is initialized but the pool starts by {method}")
    watchdog = threading.Timer(PARALLEL_TIMEOUT_S, _timed_out,
                               ("the parallel sweep",))
    watchdog.daemon = True
    t0 = time.perf_counter()
    watchdog.start()
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="parallel sweep unavailable")
            res, c = counted(lambda: engine.sweep_scenario("llm", smoke=True))
    finally:
        watchdog.cancel()
    want = exact_rows(DSEEngine(parallel=False, pricing_backend="numpy")
                      .sweep_scenario("llm", smoke=True).rows())
    if exact_rows(res.rows()) != want or not c["pricing"]:
        raise AssertionError(f"parallel sweep: rows differ or no launch ({c})")
    say(f"  parallel sweep llm smoke ({method}, 2 workers) in "
        f"{time.perf_counter() - t0:.1f} s: rows identical to numpy; "
        f"launches {c['pricing']}; plan stats {engine.last_plan_stats}")

    grid = DenseGridSpec.dense(100_000)
    spec = grid.spec()
    work = get_scenario("llm", smoke=True).work_fn
    keys = ("cells", "groups", "enumerated", "survived", "priced_rows",
            "chunks")
    ref = DSEEngine(parallel=False, pricing_backend="numpy").reprice_grid(
        work, spec)
    say(f"  reprice_grid numpy (cold plan): {json.dumps(ref)}")
    for backend, key in (("kernel", "pricing"), ("kernel-f32", "pricing_f32")):
        engine = DSEEngine(parallel=False, pricing_backend=backend)
        (rep, c), split = device_split(
            torch, lambda: counted(lambda: engine.reprice_grid(work, spec)))
        if {k: rep[k] for k in keys} != {k: ref[k] for k in keys}:
            raise AssertionError(f"reprice_grid {backend}: report differs "
                                 f"from numpy's: {rep}")
        if c[key] != rep["chunks"] or not rep["winners_identical"]:
            raise AssertionError(f"reprice_grid {backend}: launches {c} for "
                                 f"{rep['chunks']} chunks")
        if split["kernel_n"] != sum(c.values()):
            raise AssertionError(f"reprice_grid {backend}: the profiler saw "
                                 f"{split['kernel_n']} pricing kernels, the "
                                 f"counters {c}; profiled device events "
                                 f"{split['events']}")
        device_s = (split["h2d_ms"] + split["kernel_ms"] + split["d2h_ms"]
                    + split["other_ms"]) / 1e3
        # the chunk's host->device copy alone, timed with CUDA events at the
        # same size and from the same kind of (pinned) buffer
        stack = torch.empty((25, rep["priced_rows"]), dtype=torch.float64,
                            pin_memory=True)
        h2d_ms = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            stack.to("cuda", non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            h2d_ms.append(start.elapsed_time(end))
        say(f"  reprice_grid {backend}: {rep['cells']} cells, "
            f"{rep['groups']} groups, {rep['priced_rows']} rows priced in "
            f"{rep['chunks']} chunk(s), {c[key]} launch(es); winners "
            f"identical to numpy; repriced_frac {rep['repriced_frac']:.6g}, "
            f"max iter drift "
            f"{(rep['drift'] or {}).get('max_iter_drift', 0.0):.6g}")
        say(f"    price phase split (torch.profiler device time): plan_s "
            f"{rep['plan_s']:.6f}, price_s {rep['price_s']:.6f} = "
            f"host->device {split['h2d_ms']:.6f} ms ({split['h2d_n']} copies)"
            f" + kernel {split['kernel_ms']:.6f} ms ({split['kernel_n']}) + "
            f"device->host {split['d2h_ms']:.6f} ms ({split['d2h_n']}) + "
            f"other device work {split['other_ms']:.6f} ms "
            f"({split['other_n']}) + the rest on the host (stacking, "
            f"concatenation, winner certification) "
            f"{rep['price_s'] - device_s:.6f} s")
        say(f"    profiled device events {split['events']}; host->device "
            f"copy of the chunk's (25, {rep['priced_rows']}) float64 "
            f"stack alone: {min(h2d_ms):.6f} ms (best of 5, CUDA events)")
    return total


def profiler_recheck(torch, kernels) -> dict:
    """``reprice_grid`` once more on the kernel backend under a fresh
    profiler, after the serving paths' profiles: the pricing-kernel and
    kernel-launch events it recorded beside the launch counter. Reported,
    not checked: once, after serving profiles, the profiler recorded no
    pricing-kernel event while the counter saw the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.core import DSEEngine
    from repro_torch.search import DenseGridSpec
    from repro_torch.workloads.scenarios import get_scenario

    engine = DSEEngine(parallel=False, pricing_backend="kernel")
    spec = DenseGridSpec.dense(100_000).spec()
    work = get_scenario("llm", smoke=True).work_fn
    engine.reprice_grid(work, spec)                 # warm the plan
    kernels.reset_launches()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        engine.reprice_grid(work, spec)
        torch.cuda.synchronize()
    seen = {}
    for e in prof.key_averages():
        if "pricing_kernel" in e.key or "LaunchKernel" in e.key:
            on = "device" if getattr(e, "device_type", None) == DeviceType.CUDA else "host"
            seen[f"{e.key[:40]} ({on})"] = e.count
    return {"counter": kernels.launches()["pricing"], "profiler": seen}


# ------------------------------- phase 4b -------------------------------------
def _search_policy(search, name: str, n: int):
    """A shipped policy and its certification budget: random and surrogate
    walk the whole grid, halving runs on a quarter of it."""
    if name == "random":
        return search.RandomSearch(seed=0, batch_size=8), n
    if name == "halving":
        return search.SuccessiveHalving(eta=4), max(1, -(-n // 4))
    return search.SurrogateSearch(seed=0, batch_size=6, min_train=6), n


def _search_key(res) -> tuple:
    return (res.evals_used, res.cheap_evals, res.best_index, res.oracle_index)


def check_dse_features(kernels) -> dict[str, int]:
    """Phase 4b: the learned rank stage, budgeted search and the DSE service
    daemon on the card, each against the numpy backend in this process.
    Every step is fatal; the launch counters are zeroed just before each
    step and read just after. Returns the pricing launches summed."""
    import warnings

    from repro_torch import learned, search
    from repro_torch.core import DSEEngine, clear_caches
    from repro_torch.search import DenseGridSpec
    from repro_torch.service import DSEClient, DSEService
    from repro_torch.workloads.scenarios import get_scenario

    total = {"pricing": 0, "pricing_f32": 0}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        c = kernels.launches()
        if any(v for k, v in c.items() if k not in total):
            raise AssertionError(f"serving kernels launched on the DSE path: {c}")
        for k in total:
            total[k] += c[k]
        return out, c

    def launched(backend: str, c: dict) -> int:
        key = "pricing_f32" if backend == "kernel-f32" else "pricing"
        n = c[key] if backend != "torch" else 0
        if backend in ("kernel", "kernel-f32") and not n:
            raise AssertionError(f"{backend}: no pricing launch")
        return n

    # 1. the ranker: fitted from the smoke sweeps' harvest on the card and
    # on numpy, then every scenario rank on against rank off
    t0 = time.perf_counter()
    models = {}
    for backend in ("kernel", "numpy"):
        clear_caches()
        eng = DSEEngine(parallel=False, pricing_backend=backend, prune="on")
        _, c = counted(lambda: [eng.sweep_scenario(n, smoke=True)
                                for n in SMOKE_SCENARIOS])
        launched(backend, c)
        models[backend] = learned.fit_ranker()
    got, want = models["kernel"], models["numpy"]
    fields = ("n_train", "n_groups", "keep_frac", "recall")
    say(f"  ranker from the seven smoke sweeps on kernel: "
        + ", ".join(f"{f} {getattr(got, f)!r}" for f in fields)
        + f" (recall target {got.recall_target}); numpy: "
        + ", ".join(f"{f} {getattr(want, f)!r}" for f in fields))
    if got.recall < got.recall_target:
        raise AssertionError(f"ranker recall {got.recall} < {got.recall_target}")
    if ([getattr(got, f) for f in fields] != [getattr(want, f) for f in fields]
            or got.fingerprint != want.fingerprint):
        raise AssertionError("the ranker fitted on kernel differs from numpy's")
    for name in SMOKE_SCENARIOS:
        ref = DSEEngine(parallel=False, pricing_backend="numpy", prune="on",
                        rank="on")
        rows = exact_rows(ref.sweep_scenario(name, smoke=True).rows())
        want = ref.last_plan_stats
        off = exact_rows(DSEEngine(parallel=False, pricing_backend="numpy",
                                   prune="on").sweep_scenario(
            name, smoke=True).rows())
        if rows != off or not want["rank"]:
            raise AssertionError(f"{name}: numpy rank on differs from off")
        note = []
        for backend in ("kernel", "kernel-f32", "torch"):
            for rank in ("on", "off"):
                eng = DSEEngine(parallel=False, pricing_backend=backend,
                                prune="on", rank=rank)
                res, c = counted(lambda: eng.sweep_scenario(name, smoke=True))
                st = eng.last_plan_stats
                if exact_rows(res.rows()) != rows:
                    raise AssertionError(f"{name} {backend} rank {rank}: "
                                         f"rows differ from numpy's")
                if rank == "on" and (not st["rank"] or any(
                        st[k] != want[k] for k in ("survived", "rank_survived",
                                                   "priced"))):
                    raise AssertionError(f"{name} {backend}: rank stats {st} "
                                         f"against numpy's {want}")
                note.append(f"{backend}/{rank} {launched(backend, c)}")
        say(f"  {name}: rank on prices {want['rank_survived']} of "
            f"{want['survived']} dominance survivors; rows identical to numpy "
            f"rank on and off; launches {', '.join(note)}")
    say(f"  ranker step in {time.perf_counter() - t0:.1f} s")

    # 2. reprice_grid with rank on at 100,224 cells: the grid's rank-off pass
    # first (it fills the harvest, so every rank-on engine below fits the
    # same model), then numpy's rank-on report as the reference
    t0 = time.perf_counter()
    spec = DenseGridSpec.dense(100_000).spec()
    work = get_scenario("llm", smoke=True).work_fn
    keys = ("cells", "enumerated", "survived", "rank_survived", "priced_rows",
            "chunks")
    DSEEngine(parallel=False, pricing_backend="numpy").reprice_grid(work, spec)
    ref = DSEEngine(parallel=False, pricing_backend="numpy",
                    rank="on").reprice_grid(work, spec)
    say(f"  reprice_grid numpy rank on: "
        + ", ".join(f"{k} {ref[k]}" for k in keys + ("rank", "rank_keep_frac")))
    if not ref["rank"] or ref["rank_survived"] >= ref["survived"]:
        raise AssertionError(f"reprice_grid numpy: the rank stage did not run: {ref}")
    for backend in ("kernel", "kernel-f32"):
        engines = {rank: DSEEngine(parallel=False, pricing_backend=backend,
                                   rank=rank) for rank in ("off", "on")}
        for eng in engines.values():
            eng.reprice_grid(work, spec)                      # warm the plan
        price_s = {"off": [], "on": []}
        rows = {}
        for _ in range(REPRICE_TURNS):                        # in turns
            for rank, eng in engines.items():
                rep, c = counted(lambda: eng.reprice_grid(work, spec))
                n = launched(backend, c)
                if n != rep["chunks"] or not rep["winners_identical"]:
                    raise AssertionError(
                        f"reprice_grid {backend} rank {rank}: {n} launches "
                        f"for {rep['chunks']} chunks")
                if rank == "on" and {k: rep[k] for k in keys} != {
                        k: ref[k] for k in keys}:
                    raise AssertionError(f"reprice_grid {backend} rank on: "
                                         f"{rep} against numpy's {ref}")
                price_s[rank].append(rep["price_s"])
                rows[rank] = (rep["priced_rows"], rep["drift"]["repriced"]
                              if rep["drift"] else 0)
        say(f"  reprice_grid {backend}: winners identical to numpy, one "
            f"launch a pass; price_s in turns, rank on ({rows['on'][0]} "
            f"rows, {rows['on'][1]} re-priced exactly) "
            + ", ".join(f"{t:.6f}" for t in price_s["on"])
            + f" s against rank off ({rows['off'][0]} rows, "
            f"{rows['off'][1]} re-priced exactly) "
            + ", ".join(f"{t:.6f}" for t in price_s["off"]) + " s")
    say(f"  reprice step in {time.perf_counter() - t0:.1f} s")

    # 3. certified searches on the card against numpy's
    t0 = time.perf_counter()
    sc = get_scenario("llm", smoke=True)

    def run_search(backend, work_fn, spec, make):
        eng = DSEEngine(parallel=False, pricing_backend=backend)
        pol, budget = make()
        t = time.perf_counter()
        res, c = counted(lambda: eng.search(work_fn, spec, policy=pol,
                                            budget=budget))
        secs = time.perf_counter() - t
        if not res.certified or res.best_index != res.oracle_index:
            raise AssertionError(f"search {res.policy} on {backend}: "
                                 f"not certified ({res.best_index}, "
                                 f"{res.oracle_index})")
        return res, launched(backend, c), secs

    def both(label, work_fn, spec, make):
        got, n, secs = run_search("kernel", work_fn, spec, make)
        want, _, _ = run_search("numpy", work_fn, spec, make)
        if _search_key(got) != _search_key(want):
            raise AssertionError(f"search {label}: {_search_key(got)} against "
                                 f"numpy's {_search_key(want)}")
        say(f"  search {label}: certified, best {got.best_index} = oracle, "
            f"{got.evals_used} full evaluations of {len(spec.grid())} cells, "
            f"{got.cheap_evals} cheap bounds, identical to numpy; "
            f"{n} launches; {secs:.2f} s on kernel")
        return secs

    n = len(sc.spec.grid())
    for policy in ("random", "halving", "surrogate"):
        both(f"{policy} llm smoke", sc.work_fn, sc.spec,
             lambda: _search_policy(search, policy, n))
    largest, secs, cells = None, 0.0, 0
    for size in SEARCH_LADDER:
        spec = (DenseGridSpec() if size is None
                else DenseGridSpec.dense(size)).spec()
        n = len(spec.grid())
        if cells and secs * n / cells > SEARCH_LIMIT_S:
            say(f"  search halving: dense({size}) ({n} cells) skipped, "
                f"predicted {secs * n / cells:.0f} s > {SEARCH_LIMIT_S} s")
            break
        secs = both(f"halving dense {n}", work, spec,
                    lambda: (search.SuccessiveHalving(eta=8), max(1, n // 5)))
        cells = n
        if secs <= SEARCH_LIMIT_S:
            largest = (n, secs)
    if largest is None:
        raise AssertionError(f"no dense search finished within "
                             f"{SEARCH_LIMIT_S} s")
    say(f"  largest dense grid searched (halving, certified) within "
        f"{SEARCH_LIMIT_S} s on the card: {largest[0]} cells in "
        f"{largest[1]:.2f} s")
    say(f"  search step in {time.perf_counter() - t0:.1f} s")

    # 4. the daemon: started after CUDA is initialized, its warm pool by
    # forkserver; two clients with 6 overlapping cells, a search, a reprice
    t0 = time.perf_counter()
    sc = get_scenario("llm", smoke=True)
    grid = sc.spec.grid()
    want = {it.index: (None if it.point is None else exact_rows([it.point.row()])[0])
            for it in DSEEngine(parallel=False, pricing_backend="numpy")
            .sweep_cells_iter(sc.work_fn, grid, sc.spec)}
    n = len(grid)
    a_cells, b_cells = list(range(0, 2 * n // 3)), list(range(n // 3, n))
    overlap = len(set(a_cells) & set(b_cells))
    svc = DSEService(max_workers=2, shared_cache=True,
                     pricing_backend="kernel", rank="on")
    method = svc.engine._start_method()
    if method != "forkserver":
        raise AssertionError(f"CUDA is initialized but the daemon's pool "
                             f"starts by {method}")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="warm session pool unavailable")
        svc.start()
    try:
        pool = svc.engine._session_pool
        if pool is None:
            raise AssertionError("the daemon has no warm pool")
        workers = list(pool._processes.values())
        replies: dict = {}

        def client(name, cells):
            with DSEClient(svc.path) as cli:
                replies[name] = cli.sweep(scenario="llm", smoke=True,
                                          cells=cells, client=name)

        kernels.reset_launches()
        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=("A", a_cells)),
                   threading.Thread(target=client, args=("B", b_cells))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        cold_s = time.perf_counter() - t
        with DSEClient(svc.path) as cli:
            sched = cli.stats()["scheduler"]
            t = time.perf_counter()
            warm = cli.sweep(scenario="llm", smoke=True)
            warm_s = time.perf_counter() - t
            found = cli.search(scenario="llm", smoke=True, policy="halving")
            rep = cli.reprice(scenario="llm", smoke=True)
            # a scenario no request has planned yet, on the warm workers
            t = time.perf_counter()
            other = cli.sweep(scenario="dlrm", smoke=True)
            other_s = time.perf_counter() - t
            stats = cli.stats()
        c = kernels.launches()
        for k in total:
            total[k] += c[k]
        for name, cells in (("A", a_cells), ("B", b_cells)):
            r = replies.get(name)
            got = {i: None if p is None else exact_rows([p.row()])[0]
                   for i, p in zip(r.indices, r.points)} if r else {}
            if got != {i: want[i] for i in cells}:
                raise AssertionError(f"daemon client {name}: rows differ from "
                                     f"the numpy engine's")
        if exact_rows(warm.rows()) != [want[i] for i in range(n) if want[i]]:
            raise AssertionError("daemon warm sweep: rows differ")
        if exact_rows(other.rows()) != exact_rows(
                p.row() for p in DSEEngine(parallel=False,
                                           pricing_backend="numpy")
                .sweep_scenario("dlrm", smoke=True).points):
            raise AssertionError("daemon dlrm sweep: rows differ")
        if sched["dedup_hits"] != overlap or sched["cells_priced"] != n:
            raise AssertionError(f"daemon dedup: {sched}, overlap {overlap}")
        ref = DSEEngine(parallel=False, pricing_backend="numpy").search(
            sc.work_fn, sc.spec, policy=search.SuccessiveHalving(), budget=n)
        s = found.summary
        if (not s["certified"] or (s["evals_used"], s["cheap_evals"],
                                   s["best_index"], s["oracle_index"])
                != _search_key(ref)):
            raise AssertionError(f"daemon search: {s} against numpy's "
                                 f"{_search_key(ref)}")
        if not rep["winners_identical"] or rep["backend"] != "kernel":
            raise AssertionError(f"daemon reprice: {rep}")
        if not c["pricing"]:
            raise AssertionError(f"daemon: no pricing launch during the "
                                 f"requests ({c})")
        say(f"  daemon (forkserver pool of 2, mmap store, rank on): cold "
            f"request (two clients, {overlap} overlapping of {n} cells) "
            f"{cold_s:.4f} s, warm repeat {warm_s:.4f} s, a new scenario "
            f"(dlrm, 18 cells) on the warm workers {other_s:.4f} s; rows "
            f"identical to "
            f"numpy; {sched['dedup_hits']} dedup hits, {sched['cells_priced']} "
            f"cells priced; search halving certified, best "
            f"{s['best_index']}, {s['evals_used']} evaluations; reprice "
            f"winners identical; {c['pricing']} pricing launches; "
            f"ranker fitted {stats['engine']['rank_model']}; store "
            f"{json.dumps(stats['shared_store_delta'])}")
    finally:
        svc.close()
    if os.path.exists(svc.path) or svc.engine._session_pool is not None:
        raise AssertionError("the daemon left its socket or its pool")
    for p in workers:
        p.join(timeout=10)
    alive = [p.pid for p in workers if p.is_alive()]
    if alive:
        raise AssertionError(f"daemon pool workers still alive: {alive}")
    # what a fresh pool worker pays before its first plan: the import of
    # the scenario registry a request's work_fn lives in (reported only)
    probe = subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); "
         "import repro_torch.workloads.scenarios; "
         "print(time.perf_counter() - t)"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    say(f"  daemon step in {time.perf_counter() - t0:.1f} s (shut down: "
        f"socket gone, {len(workers)} workers gone); importing "
        f"repro_torch.workloads.scenarios in a fresh process: "
        f"{probe.stdout.strip() or probe.stderr[-300:]} s")
    return total


# ------------------------------- phases 5-7 -----------------------------------
def scaled_err(got, want) -> float:
    """Largest difference over the largest reference value."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


#: float32 on the card against the CPU, at the tolerances at which the CPU
#: tests hold the float32 port to JAX (tests/test_torch_model.py,
#: tests/test_torch_ssm.py): prefill logits and the prefill's cache,
#: float32 entries at F32_PREFILL_TOL and bf16 ones (a float32 model keeps
#: its K/V and conv caches in bf16, as the reference) within one bf16 ulp of
#: the larger of the two plus 1e-5 (BF16_CACHE_TOL: an f32 difference at a
#: rounding boundary flips the last bit, and near zero the f32 projection's
#: own rounding is worth more than one bf16 ulp); each decode step's logits
#: at F32_DECODE_TOL; the cache after the decode steps, its float32
#: entries (the SSM states) at F32_FINAL_CACHE_TOL and its bf16 ones within
#: one bf16 ulp + 1e-3 (BF16_FINAL_CACHE_TOL). A decode step reads the
#: bf16 cache back, so its inputs, and what it writes, carry the one-ulp
#: differences the prefill's cache may have, as its logits do; so an SSM
#: state moves by ~1e-3 (the mamba2_130m and jamba SMOKE configs' states
#: read 1.25e-3 and 1.24e-3 after 4 steps on the H100, on the kernel and on
#: the plain scan alike, against 1.3e-5 and 8.6e-6 after the prefill; phase
#: 23 prints both routes' readings). atol 2e-3 clears those readings; as a
#: control, the states shifted by F32_CONTROL_SHIFT (a decode step's update
#: wrong by 1e-2) must fail it
F32_PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
F32_DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
F32_FINAL_CACHE_TOL = dict(rtol=1e-3, atol=2e-3)
F32_CONTROL_SHIFT = 1e-2
BF16_CACHE_TOL = dict(rtol=2.0 ** -7, atol=1e-5, of_larger=True)
BF16_FINAL_CACHE_TOL = dict(rtol=2.0 ** -7, atol=1e-3, of_larger=True)


def allclose_excess(got, want, tol: dict) -> float:
    """The largest |got - want| - (atol + rtol |want|), as numpy's allclose
    reads it (``of_larger``: rtol of the larger of |got|, |want|): at most 0
    where the two are close."""
    got, want = got.double(), want.double()
    scale = got.abs().maximum(want.abs()) if tol.get("of_larger") else want.abs()
    return ((got - want).abs() - (tol["atol"] + tol["rtol"] * scale)).max().item()


def cache_excess(got: dict, want: dict, f32_tol: dict, bf16_tol: dict) -> float:
    """:func:`allclose_excess` over a float32 model's cache entries: float32
    entries at ``f32_tol``, bf16 ones at ``bf16_tol``."""
    return max(allclose_excess(got[k], want[k],
                               f32_tol if want[k].element_size() == 4 else bf16_tol)
               for k in want if want[k].is_floating_point())


def check_small_model(torch, arch: str, dtype: str = "bfloat16") -> dict:
    """The kernels' model on the card against the plain versions on the CPU:
    the SMOKE config of ``arch`` in ``dtype``, same weights, prefill plus 4
    teacher-forced decode steps (attending to seeded image embeddings, or
    to the encoder's output over seeded audio frames, where the config
    cross-attends). bf16: logits of every step and the final cache, within
    2e-2 of their largest value. float32: element-wise at F32_PREFILL_TOL
    (prefill logits, float32 cache entries), F32_DECODE_TOL (each decode
    step's logits) and BF16_CACHE_TOL (bf16 cache entries); a MoE config's
    card run routed as the CPU run was (:func:`replayed_routes`), the
    tokens the two route otherwise counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, encode, init_params, prefill, to_device
    from repro_torch.models.transformer import compute_dtype

    cfg = get_config(arch, smoke=True)
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    cpu = init_params(cfg, seed=SEED, device="cpu")
    g = torch.Generator().manual_seed(SEED + 2)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=g)
    s, steps = 16, 4
    m = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    src = torch.randn((2, m, cfg.d_model), generator=g).to(compute_dtype(cfg)) if m else None

    def run(params, dev, keep_prefill=False):
        with torch.no_grad():
            memory = None if src is None else src.to(dev)
            if cfg.is_enc_dec:
                memory = encode(cfg, params, memory)
            lg, cache = prefill(cfg, params, toks[:, :s].to(dev), max_len=s + steps,
                                memory=memory)
            # a copy: decode_step writes the cache in place
            first = {k: v.cpu().clone() for k, v in cache.items()} if keep_prefill else None
            outs = [lg]
            for i in range(steps):
                lg, cache = decode_step(cfg, params, cache,
                                        toks[:, s + i].to(dev), s + i, memory=memory)
                outs.append(lg)
        final = {k: v.cpu() for k, v in cache.items()}
        return ([o.cpu() for o in outs], final) + ((first,) if keep_prefill else ())

    if dtype == "float32":
        return check_small_model_f32(torch, cfg, cpu, run)
    if cfg.moe_experts:
        return check_small_moe_model(torch, cfg, cpu, run, s + steps)
    want, want_cache = run(cpu, "cpu")
    got, got_cache = run(to_device(cpu, "cuda"), "cuda")
    out = {"scaled_err": max(scaled_err(a, w) for a, w in zip(got, want)),
           "cache_scaled_err": max(scaled_err(got_cache[k], want_cache[k])
                                   for k in want_cache)}
    if not max(out.values()) <= SCALED_TOL_SMALL:
        raise AssertionError(f"small model {arch}: card vs CPU {out}")
    return out


def check_small_model_f32(torch, cfg, cpu, run) -> dict:
    """:func:`check_small_model` in float32: ``run(params, device)`` on the
    CPU and on the card, held element-wise (see there)."""
    from repro_torch.models import to_device

    routes, card_routes = [], []
    moe = bool(cfg.moe_experts)
    with (recorded_routes(routes) if moe else contextlib.nullcontext()):
        want, want_cache, want_first = run(cpu, "cpu", keep_prefill=True)
    card = to_device(cpu, "cuda")
    if moe:
        with recorded_routes(card_routes):
            run(card, "cuda")
    with (replayed_routes(torch, routes) if moe else contextlib.nullcontext()):
        got, got_cache, got_first = run(card, "cuda", keep_prefill=True)
    out = {"prefill_excess": allclose_excess(got[0], want[0], F32_PREFILL_TOL),
           "decode_excess": max(allclose_excess(a, w, F32_DECODE_TOL)
                                for a, w in zip(got[1:], want[1:])),
           "prefill_cache_excess": cache_excess(got_first, want_first, F32_PREFILL_TOL,
                                                BF16_CACHE_TOL),
           "cache_excess": cache_excess(got_cache, want_cache, F32_FINAL_CACHE_TOL,
                                        BF16_FINAL_CACHE_TOL),
           "cache_max_abs_err": {k: (got_cache[k].double() - want_cache[k].double()
                                     ).abs().max().item()
                                 for k in want_cache if want_cache[k].is_floating_point()},
           "prefill_max_abs_err": (got[0] - want[0]).abs().max().item(),
           "decode_max_abs_err": max((a - w).abs().max().item()
                                     for a, w in zip(got[1:], want[1:]))}
    if moe:
        out["tokens_routed_otherwise_unreplayed"] = sum(
            int((a != b).any(-1).sum()) for a, b in zip(routes, card_routes))
    states = [k for k in want_cache if want_cache[k].dtype == torch.float32]
    if states:
        # the same run through the scan's plain version, and the control
        with plain_scan(), (replayed_routes(torch, routes) if moe
                            else contextlib.nullcontext()):
            _, plain_cache = run(card, "cuda")
        out["plain_scan_cache_max_abs_err"] = {
            k: (plain_cache[k].double() - want_cache[k].double()).abs().max().item()
            for k in states}
        out["control_excess"] = max(allclose_excess(
            got_cache[k] + F32_CONTROL_SHIFT, want_cache[k], F32_FINAL_CACHE_TOL)
            for k in states)
        if not out["control_excess"] > 0:
            raise AssertionError(f"small model {cfg.name} float32: the final cache's "
                                 f"check passed states shifted by {F32_CONTROL_SHIFT:g}")
    if not all(torch.isfinite(x).all() for x in got) or max(
            out[k] for k in ("prefill_excess", "decode_excess", "prefill_cache_excess",
                             "cache_excess")) > 0:
        raise AssertionError(f"small model {cfg.name} float32: card vs CPU {out}")
    return out


# ------------------------------- MoE ------------------------------------------
@contextlib.contextmanager
def recorded_routes(store: list):
    """Record the experts every MoE layer call chooses (``layers._route``):
    each call's (T, k) indices, sorted, on the CPU, in call order."""
    from repro_torch.models import layers

    route = layers._route

    def recording(p, xt, k):
        probs, gates, idx = route(p, xt, k)
        store.append(idx.sort(dim=-1).values.cpu())
        return probs, gates, idx

    layers._route = recording
    try:
        yield
    finally:
        layers._route = route


@contextlib.contextmanager
def replayed_routes(torch, routes: list):
    """Route the MoE layer calls made inside the block to the experts of
    ``routes`` (one (T, k) index tensor per call, in call order), gates
    taken from each call's own probabilities there: two runs then compute
    the same function, whatever their bf16 near-ties, and differ only by
    rounding."""
    from repro_torch.models import layers

    route, calls = layers._route, iter(routes)

    def replaying(p, xt, k):
        probs, _, _ = route(p, xt, k)
        idx = next(calls).to(xt.device)
        gates = probs.gather(1, idx)
        return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx

    layers._route = replaying
    try:
        yield
    finally:
        layers._route = route


def moe_layers(cfg) -> int:
    """The MoE layers of ``cfg``: the calls a pass makes to the router."""
    return sum(cfg.layer_is_moe(i % cfg.block_size) for i in range(cfg.n_layers))


def routes_by_layer(torch, routes: list, n_layers: int, batch: int) -> list:
    """Recorded routes, a sequence of passes of n_layers calls over
    consecutive positions of every sequence (a prefill, then a position a
    decode step), as one (batch, positions, k) tensor per layer."""
    return [torch.cat([r.view(batch, -1, r.shape[-1])
                       for r in routes[layer::n_layers]], 1)
            for layer in range(n_layers)]


def first_route_difference(torch, a: list, b: list, n_layers: int,
                           batch: int) -> list[int]:
    """Two runs' routes (:func:`recorded_routes`), each a sequence of passes
    of n_layers calls over consecutive positions of every sequence (a
    prefill, then one position a decode step): per sequence, the first
    position where some layer chose other experts in the two runs (the
    number of positions if none). A token routed otherwise changes its own
    output and, through attention, every later position's; the positions
    before it are computed alike (causal)."""
    same = None
    for la, lb in zip(routes_by_layer(torch, a, n_layers, batch),
                      routes_by_layer(torch, b, n_layers, batch)):
        eq = (la == lb).all(-1)
        same = eq if same is None else same & eq
    return [int((~row).nonzero()[0]) if bool((~row).any()) else row.numel()
            for row in same]


def check_small_moe_model(torch, cfg, cpu, run, positions: int) -> dict:
    """The MoE SMOKE config on the card against the CPU (the plain
    versions), bf16. The two round the hidden state in other places, so a
    token whose top-k experts nearly tie may be routed otherwise on each,
    both valid routes. Two checks, logits and K/V cache within
    SCALED_TOL_SMALL of the largest value: with each run's own routes, each
    sequence at every position before its first route difference
    (:func:`first_route_difference`; some position must be held); and with
    the card run routed as the CPU run was (:func:`replayed_routes`), at
    every position."""
    from repro_torch.models import to_device

    want_routes, got_routes = [], []
    card = to_device(cpu, "cuda")
    with recorded_routes(want_routes):
        want, want_cache = run(cpu, "cpu")
    with recorded_routes(got_routes):
        got, got_cache = run(card, "cuda")
    with replayed_routes(torch, want_routes):
        forced, forced_cache = run(card, "cuda")
    b = want[0].shape[0]
    clean = first_route_difference(torch, want_routes, got_routes,
                                   moe_layers(cfg), b)

    def by_position(outs):
        return torch.cat([outs[0], *[o[:, None] for o in outs[1:]]], 1)
    lw, lg = by_position(want), by_position(got)
    held = [(i, n) for i, n in enumerate(clean) if n]
    out = {"scaled_err": max((scaled_err(lg[i, :n], lw[i, :n])
                              for i, n in held), default=0.0),
           "cache_scaled_err": max((scaled_err(got_cache[k][:, :, i, :n],
                                               want_cache[k][:, :, i, :n])
                                    for k in ("k", "v") for i, n in held),
                                   default=0.0),
           "positions_held": clean, "positions": positions,
           "replayed_routes_scaled_err": scaled_err(by_position(forced), lw),
           "replayed_routes_cache_scaled_err": max(
               scaled_err(forced_cache[k], want_cache[k]) for k in want_cache)}
    errs = [v for k, v in out.items() if k.endswith("scaled_err")]
    if not (max(errs) <= SCALED_TOL_SMALL and held):
        raise AssertionError(f"small model {cfg.name}: card vs CPU {out}")
    return out


def no_drop(cfg):
    """``cfg`` with the capacity factor at which no token drops (E / k: an
    expert then has room for every token)."""
    import dataclasses
    return dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)


def moe_drops(torch, cfg, params, prompts) -> dict:
    """A reading: the (token, slot) pairs the default capacity factor drops
    in one prefill of ``prompts``, per layer, of the pairs routed."""
    from repro_torch.models import layers, prefill

    dispatch, dropped = layers.moe_dispatch, []

    def counting(p, xt, cfg_, capacity_factor=None):
        out = dispatch(p, xt, cfg_, capacity_factor)
        dropped.append(int((~out[3]).sum()))
        return out

    layers.moe_dispatch = counting
    try:
        with torch.no_grad():
            prefill(cfg, params, prompts)
    finally:
        layers.moe_dispatch = dispatch
    pairs = prompts.numel() * cfg.moe_top_k
    return {"capacity_factor": cfg.moe_capacity_factor,
            "dropped_by_layer": dropped, "routed_per_layer": pairs,
            "dropped_share": sum(dropped) / (pairs * len(dropped))}


def moe_model_readings(torch, cfg, params, prompts) -> dict:
    """At full size, with nothing dropped (:func:`no_drop`: a prefill at the
    default capacity drops tokens, the dropless decode does not): greedy
    decode (``moe_dense``) from a prefill of the prompts, against one
    teacher-forced forward (``moe``, every token kept) over the prompts and
    the generated tokens. Both run on the card in bf16 along different
    paths, so a near-tie may route a token otherwise in each. The largest
    scaled error of the decode logits and the greedy agreement: against the
    teacher with its own routes, each sequence's steps before its first
    route difference (:func:`first_route_difference`; the steps held are
    counted); against the teacher routed as the decode path was
    (:func:`replayed_routes`), every step. Reads, checks nothing."""
    from repro_torch.models import decode_step, forward, prefill

    nd = no_drop(cfg)
    b, s = prompts.shape
    n = NEW_TOKENS
    dec_routes, teacher_routes = [], []
    with torch.no_grad():
        with recorded_routes(dec_routes):
            logits, cache = prefill(nd, params, prompts, max_len=s + n)
            gen, dec = [logits[:, -1].argmax(-1)], []
            del logits
            for i in range(n - 1):
                lg, cache = decode_step(nd, params, cache, gen[-1], s + i)
                dec.append(lg.float())
                gen.append(lg.argmax(-1))
        del cache
        gen = torch.stack(gen, 1)                              # (B, n)
        with recorded_routes(teacher_routes):
            full = forward(nd, params, torch.cat([prompts, gen[:, :-1]], 1))
        teacher = full[:, s - 1:].float()                      # (B, n, V)
        del full
        replay = [r.reshape(-1, r.shape[-1]) for r in
                  routes_by_layer(torch, dec_routes, moe_layers(cfg), b)]
        with replayed_routes(torch, replay):
            full = forward(nd, params, torch.cat([prompts, gen[:, :-1]], 1))
        forced = full[:, s - 1:].float()
        del full
    clean = first_route_difference(torch, teacher_routes, dec_routes,
                                   moe_layers(cfg), b)
    forced_errs = [((dec[i][j] - forced[j, i + 1]).abs().max()
                    / forced[j, i + 1].abs().max()).item()
                   for i in range(n - 1) for j in range(b)]
    forced_agree = (forced.argmax(-1) == gen).float().mean().item()
    held, all_errs, agree = [], [], []
    for i in range(n - 1):
        for j in range(b):
            w = teacher[j, i + 1]
            e = ((dec[i][j] - w).abs().max() / w.abs().max()).item()
            all_errs.append(e)
            if s + i < clean[j]:
                held.append(e)
    for i in range(n):
        for j in range(b):
            if s - 1 + i < clean[j]:
                agree.append(bool(teacher[j, i].argmax() == gen[j, i]))
    out = {"capacity_factor": nd.moe_capacity_factor,
           "first_route_difference": clean, "prompt_len": s,
           "steps_held": len(held), "steps": len(all_errs),
           "decode_vs_prefill_scaled_err": max(held, default=None),
           "greedy_agreement": sum(agree) / len(agree) if agree else None,
           "all_steps_scaled_err": max(all_errs),
           "replayed_routes_decode_vs_prefill_scaled_err": max(forced_errs),
           "replayed_routes_greedy_agreement": forced_agree}
    return out


def check_moe_model(torch, cfg, params, prompts) -> dict:
    """:func:`moe_model_readings` held as phase 6 holds the dense path:
    decode logits within SCALED_TOL_FULL of the teacher's largest and
    greedy agreement at least 0.8, with its own routes (some step held) and
    with the decode path's routes replayed."""
    out = moe_model_readings(torch, cfg, params, prompts)
    if not (out["steps_held"] and out["decode_vs_prefill_scaled_err"] <= SCALED_TOL_FULL
            and out["greedy_agreement"] >= 0.8
            and out["replayed_routes_decode_vs_prefill_scaled_err"] <= SCALED_TOL_FULL
            and out["replayed_routes_greedy_agreement"] >= 0.8):
        raise AssertionError(f"full model ({cfg.name}): decode vs teacher-forced "
                             f"forward beyond {SCALED_TOL_FULL:g}, greedy "
                             f"agreement under 0.8, or no step held: {out}")
    return out


def seq_scaled_err(got, want) -> float:
    """The largest of each sequence's scaled error (leading dimension)."""
    g, w = got.float().flatten(1), want.float().flatten(1)
    return ((g - w).abs().amax(1) / w.abs().amax(1)).max().item()


def full_model_readings(torch, cfg, params, prompts, tokens,
                        memory=None) -> dict:
    """At full size: the decode path's logits (cache and ``decode_step``:
    the decode kernel, or the SSM recurrence) for the generated tokens
    against one forward pass (the flash kernel, or the chunked scan) over
    the prompt and those tokens, the largest of each sequence's scaled
    error; and the greedy tokens against that pass's argmax; both paths
    attend to ``memory`` where given. For an SSM config also the state
    handoff: the cache after the prompt's prefill and
    the decode steps against the cache of one prefill over the same tokens,
    layer by layer, the largest of each sequence's scaled error, and each
    layer alone (:func:`ssm_layers_alone`). Reads, checks nothing."""
    from repro_torch.models import decode_step, forward, prefill

    gen = torch.tensor(tokens, device=prompts.device).t()  # (B, n)
    n, s = gen.shape[1], prompts.shape[1]
    seq = torch.cat([prompts, gen[:, :-1]], 1)
    with torch.no_grad():
        # a copy of the compared positions, so the pass's logits (3.9 GiB at
        # a 256,000 vocabulary) are freed before the prefill
        teacher = forward(cfg, params, seq, memory=memory)[:, s - 1:].clone()
        if not bool(torch.isfinite(teacher.float()).all()):  # (B, n, V)
            raise AssertionError("full model: non-finite logits")
        agree = (teacher.argmax(-1) == gen).float().mean().item()
        cache = prefill(cfg, params, prompts, max_len=s + n, memory=memory)[1]
        worst = 0.0
        for i in range(n - 1):
            lg, cache = decode_step(cfg, params, cache, gen[:, i], s + i,
                                    memory=memory)
            worst = max(worst, seq_scaled_err(lg, teacher[:, i + 1]))
        del teacher
        out = {"decode_vs_prefill_scaled_err": worst, "greedy_agreement": agree}
        if not cfg.attention_free:
            return out
        _, whole = prefill(cfg, params, seq)
        for k in ("ssm", "conv"):
            out[f"{k}_handoff_scaled_err_by_layer"] = [
                float(f"{seq_scaled_err(cache[k][b], whole[k][b]):.3g}")
                for b in range(cfg.n_blocks)]
        del cache, whole
        out["layer_alone_scaled_err_by_layer"] = ssm_layers_alone(
            torch, cfg, params, seq, s)
    return out


def check_full_model(torch, cfg, params, prompts, tokens, memory=None) -> dict:
    """A dense config's :func:`full_model_readings`: decode vs prefill
    within SCALED_TOL_FULL and greedy agreement at least 0.8."""
    out = full_model_readings(torch, cfg, params, prompts, tokens, memory)
    if not (out["decode_vs_prefill_scaled_err"] <= SCALED_TOL_FULL
            and out["greedy_agreement"] >= 0.8):
        raise AssertionError(f"full model: decode vs prefill beyond "
                             f"{SCALED_TOL_FULL:g} or greedy agreement "
                             f"under 0.8: {out}")
    return out


@contextlib.contextmanager
def plain_scan():
    """The model's scan through ``ssd_scan_ref`` on the card, for the
    comparison route of phase 7 only: ``models.layers.ssd_chunk`` is
    replaced by the plain version, with the layout transposes the wrapper
    makes for CPU tensors, and restored on exit."""
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.models import layers

    kernel = layers.ssd_chunk

    def plain(x, dt, B, C, dA):
        y, h = ssd_scan_ref(*(t.transpose(1, 2) for t in (x, dt, B, C, dA)))
        return y.transpose(1, 2).contiguous(), h

    layers.ssd_chunk = plain
    try:
        yield
    finally:
        layers.ssd_chunk = kernel


def serve_inputs(torch, cfg, requests: int, seed: int):
    """The weights and prompts ``run_serve`` makes from ``seed``."""
    from repro_torch.models import init_params

    params = init_params(cfg, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (requests, PROMPT_LEN),
                            generator=gen, device="cuda")
    return params, prompts


def ssm_summary(r: dict) -> dict:
    """The readings phase 7 holds to a limit, from one route and seed."""
    ssm, conv = r["ssm_handoff_scaled_err_by_layer"], r["conv_handoff_scaled_err_by_layer"]
    alone = r["layer_alone_scaled_err_by_layer"]
    return {"logits": r["decode_vs_prefill_scaled_err"],
            "greedy": r["greedy_agreement"],
            "ssm": max(ssm), "ssm_layer": ssm.index(max(ssm)),
            "conv": max(conv), "conv_layer": conv.index(max(conv)),
            "first": max(ssm[0], conv[0]),
            "alone_out": max(e[0] for e in alone),
            "alone_state_conv": max(max(e[1:]) for e in alone)}


def ssm_model_readings(torch, cfg, requests: int, served_tokens,
                       routes=("kernel", "plain")) -> dict:
    """:func:`full_model_readings` of ``cfg`` for every seed of SSM_SEEDS
    and route: the served seed with the tokens ``run_serve`` generated,
    every other seed with the greedy tokens the kernel route generates
    from that seed's weights; both routes see the same tokens. Returns
    {route: {seed: readings}}."""
    from repro_torch.serve import ServeEngine

    out = {route: {} for route in routes}
    for seed in SSM_SEEDS:
        params, prompts = serve_inputs(torch, cfg, requests, seed)
        tokens = served_tokens
        if seed != SEED or tokens is None:
            engine = ServeEngine(cfg, params, max_batch=requests,
                                 max_len=PROMPT_LEN + NEW_TOKENS + 1,
                                 device=prompts.device)
            tokens = engine.generate(prompts, n_tokens=NEW_TOKENS).tokens
            del engine
        for route in routes:
            with plain_scan() if route == "plain" else contextlib.nullcontext():
                out[route][seed] = full_model_readings(torch, cfg, params,
                                                       prompts, tokens)
        del params
        torch.cuda.empty_cache()
    return out


def ssm_verdict(readings: dict) -> list[str]:
    """The limits of phase 7 (see SSM_TIGHT, SSM_REL) on
    :func:`ssm_model_readings`' result; returns the limits broken."""
    broken = []
    for route, by_seed in readings.items():
        for seed, r in by_seed.items():
            s = ssm_summary(r)
            tight = route == "kernel"
            for key, ok in (("greedy", s["greedy"] >= 0.8),
                            ("alone_out", s["alone_out"] <= SCALED_TOL_SMALL),
                            ("first", not tight or s["first"] <= SSM_TIGHT),
                            ("alone_state_conv", not tight
                             or s["alone_state_conv"] <= SSM_TIGHT)):
                if not ok:
                    broken.append(f"{route} seed {seed}: {key} {s[key]:.3g}")
    if {"kernel", "plain"} <= set(readings):
        for key in ("logits", "ssm", "conv"):
            got, base = (max(ssm_summary(r)[key] for r in readings[route].values())
                         for route in ("kernel", "plain"))
            if not got <= SSM_REL * base:
                broken.append(f"deep {key}: kernel {got:.3g} > {SSM_REL:g} x "
                              f"plain {base:.3g}")
    return broken


def check_ssm_model(torch, cfg, requests: int, served_tokens) -> dict:
    """Phase 7's whole-model check: :func:`ssm_model_readings` on both
    routes, printed per seed and route, then :func:`ssm_verdict`."""
    readings = ssm_model_readings(torch, cfg, requests, served_tokens)
    for route, by_seed in readings.items():
        for seed, r in by_seed.items():
            summary = {k: float(f"{v:.3g}") for k, v in ssm_summary(r).items()}
            say(f"    {route} route, seed {seed}: {json.dumps(summary)}")
            say(f"      ssm handoff by layer {r['ssm_handoff_scaled_err_by_layer']}")
            say(f"      conv handoff by layer {r['conv_handoff_scaled_err_by_layer']}")
    broken = ssm_verdict(readings)
    if broken:
        raise AssertionError(f"full model (mamba2): limits broken: {broken}")
    return {route: {seed: ssm_summary(r) for seed, r in by_seed.items()}
            for route, by_seed in readings.items()}


def ssm_layers_alone(torch, cfg, params, seq, s: int) -> list[float]:
    """Each SSM layer alone, on the inputs the teacher-forced forward gives
    it: its outputs at the positions after the first ``s``, from a prefill
    of the layer over those s positions (the chunked scan) and then its
    decode recurrence token by token from the state and conv tail that
    prefill left, against its outputs from one chunked scan over the whole
    sequence; and the state and conv tail the recurrence ends with against
    those of that scan. Depth amplifies nothing here. Scaled errors
    [output, state, conv tail], per layer."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _run_stack

    errs = []

    def mix(blk, slot, lp, h):
        p = lp["ssm"]
        whole, whole_state, whole_tail = L.ssm_layer(p, h, cfg)
        _, state, tail = L.ssm_layer(p, h[:, :s], cfg)
        tail = tail.contiguous()
        steps = [L.ssm_decode_step(p, h[:, t:t + 1], state, tail, cfg)[0]
                 for t in range(s, h.shape[1])]
        errs.append([float(f"{scaled_err(a, b):.3g}") for a, b in (
            (torch.cat(steps, 1), whole[:, s:]), (state, whole_state),
            (tail, whole_tail))])
        return whole

    with torch.no_grad():
        _run_stack(cfg, params, params["embed"][seq].to(torch.bfloat16), mix)
    return errs


def graph_vs_eager(torch, cfg, params, prompts, served=None, memory=None,
                   engine=None) -> dict:
    """The engine's decode path (the first step eager, then the captured
    step replayed) against ``decode_step`` called eagerly, greedy, over all
    NEW_TOKENS - 1 decode steps from the same prompts, both attending to
    ``memory`` where given: the tokens must be identical, to each other and
    to ``served`` (``run_serve``'s, where given), and the largest logit
    difference is reported (expected 0: the same kernels on the same
    inputs). A new engine must capture the step once; a warm ``engine``
    (given) must capture nothing and replay its graph. Also the engine's
    capture count and time."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import ServeEngine

    b, s = prompts.shape
    new = engine is None
    if new:
        engine = ServeEngine(cfg, params, max_batch=b, max_len=s + NEW_TOKENS + 1)
    before = engine.captures
    with torch.no_grad():
        logits, slot = engine._prefill(prompts, memory)
        graph_toks, graph_logits = [logits[:, -1].argmax(-1)], []
        for i in range(NEW_TOKENS - 1):
            lg = engine._decode(slot, graph_toks[-1], s + i, memory)
            graph_logits.append(lg.clone())
            graph_toks.append(lg.argmax(-1))
        captures, capture_s = engine.captures - before, engine.capture_s
        if new:
            del engine
        del slot, logits
        logits, cache = prefill(cfg, params, prompts, max_len=s + NEW_TOKENS + 1,
                                memory=memory)
        eager_toks, diff = [logits[:, -1].argmax(-1)], 0.0
        for i in range(NEW_TOKENS - 1):
            lg, cache = decode_step(cfg, params, cache, eager_toks[-1], s + i,
                                    memory=memory)
            diff = max(diff, (lg.float() - graph_logits[i].float()).abs().max().item())
            eager_toks.append(lg.argmax(-1))
        del cache, graph_logits
    graph_toks = [t.tolist() for t in graph_toks]
    eager_toks = [t.tolist() for t in eager_toks]
    out = {"steps": NEW_TOKENS - 1, "tokens_identical": graph_toks == eager_toks,
           "served_identical": served is None or graph_toks == served,
           "max_logit_diff": diff, "captures": captures, "capture_s": capture_s,
           "tokens": graph_toks}
    if not (out["tokens_identical"] and out["served_identical"]
            and captures == int(new)):
        raise AssertionError(f"{cfg.name}: the captured decode step differs from "
                             f"the eager one, or captured other than "
                             f"{int(new)} time(s): {out}")
    return out


def capture_failure_raises() -> int:
    """Child process of phase 9: a decode step that reads a value on the
    host (as a step still taking its position as a Python int would) cannot
    be captured; the engine must raise, not decode eagerly."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, engine as engine_mod

    cfg = get_config("mistral_nemo_12b", smoke=True)
    step = engine_mod.decode_step

    def host_reading_step(cfg, params, cache, token, pos, *memory):
        if torch.cuda.is_current_stream_capturing():
            int(pos.sum())
        return step(cfg, params, cache, token, pos, *memory)

    engine_mod.decode_step = host_reading_step
    engine = ServeEngine(cfg, init_params(cfg, seed=SEED), max_batch=2, max_len=16)
    prompts = torch.zeros((2, 8), dtype=torch.int64, device="cuda")
    try:
        engine.generate(prompts, n_tokens=4)
    except RuntimeError as e:
        if "does not decode eagerly" in str(e):
            cause = " ".join(str(e.__cause__).split())
            print(f"capture failure raised: {str(e)[:160]} (from "
                  f"{type(e.__cause__).__name__}: {cause[:160]})")
            return 0
        raise
    print("capture failure: generate returned", file=sys.stderr)
    return 1


#: the most device memory a ``run_serve`` call may leave allocated (its
#: weights and cache must be freed with it)
RUN_SERVE_LEFT_BYTES = 1 << 30


def check_serving(torch, kernels, arch: str, requests: int,
                  want: dict[str, int], phase: int, cfg=None,
                  short: bool = False) -> tuple[dict[str, int], dict]:
    """The serving path of ``arch`` (or of ``cfg``, a cut of it) at full
    size (phase N), then steady state and correctness (phase N + 1 for the
    dense path unless ``short``, the same phase for the SSM one). ``short``
    leaves out the small config (a cut config has none the kernels take).
    Returns the launch counts of the ``run_serve`` call, and the warm
    TTFT, the steady TPOT and the cold and warm generates' TPOT (seconds)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch) if cfg is None else cfg
    say(f"[{phase}] run_serve {cfg.name}: {requests} requests x {PROMPT_LEN} "
        f"prompt tokens x {NEW_TOKENS} new tokens, seed {SEED}")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    res = run_serve(cfg, requests=requests, prompt_len=PROMPT_LEN,
                    tokens=NEW_TOKENS, seed=SEED)
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    # what the call left allocated: its weights, engine, cache and graph
    # pool must be gone before the next phase draws the weights again
    left = torch.cuda.memory_allocated() - held
    want = {name: 0 for name in counts} | want
    say(f"    TTFT {res.ttft * 1e3:.3f} ms, TPOT {res.tpot * 1e3:.4f} ms, "
        f"{res.tokens_per_s:.2f} tokens/s, peak memory "
        f"{peak / 2**30:.3f} GiB, left allocated {left / 2**20:.1f} MiB; "
        f"launches {counts}")
    if counts != want:
        raise AssertionError(f"{arch}: launch counts {counts} != {want}")
    if left > RUN_SERVE_LEFT_BYTES:
        raise AssertionError(f"{arch}: run_serve left {left / 2**30:.3f} GiB "
                             f"allocated")
    if len(res.tokens) != NEW_TOKENS or any(
            len(t) != requests or not all(0 <= x < cfg.vocab for x in t)
            for t in res.tokens):
        raise AssertionError(f"{arch}: generated tokens malformed")

    params, prompts = serve_inputs(torch, cfg, requests, SEED)
    gve = graph_vs_eager(torch, cfg, params, prompts, res.tokens)
    gve.pop("tokens")
    say(f"    graph vs eager decode: {json.dumps(gve)}")
    engine = ServeEngine(cfg, params, max_batch=requests,
                         max_len=PROMPT_LEN + NEW_TOKENS + 1)
    cold = engine.generate(prompts, n_tokens=NEW_TOKENS)
    captures = engine.captures
    warm = engine.generate(prompts, n_tokens=NEW_TOKENS)
    if warm.tokens != res.tokens or cold.tokens != res.tokens:
        raise AssertionError(f"{arch}: a second run from the same seed gave "
                             f"other tokens")
    if captures != 1 or engine.captures != 1:
        raise AssertionError(f"{arch}: captures {captures} in a new engine's "
                             f"generate, {engine.captures} after a warm one")
    steady = engine.decode_steady(prompts, n_steps=16, warmup=2)
    if not (cfg.attention_free or short):
        phase += 1
    say(f"[{phase}] new engine's generate (captures the step once, "
        f"{engine.capture_s * 1e3:.3f} ms): TTFT {cold.ttft * 1e3:.3f} ms, TPOT "
        f"{cold.tpot * 1e3:.4f} ms")
    say(f"    warm generate (captures nothing): TTFT {warm.ttft * 1e3:.3f} ms, "
        f"TPOT {warm.tpot * 1e3:.4f} ms, {warm.tokens_per_s:.2f} tokens/s")
    say(f"    decode_steady through the graph: TPOT mean {steady.tpot * 1e3:.4f} "
        f"ms, min {min(steady.step_times) * 1e3:.4f}, max "
        f"{max(steady.step_times) * 1e3:.4f} over {len(steady.step_times)} "
        f"steps; {steady.tokens_per_s:.2f} tokens/s")
    if cfg.attention_free:
        say(f"    whole model, decode vs prefill, kernel and plain scan, seeds "
            f"{SSM_SEEDS}:")
        check_ssm_model(torch, cfg, requests, res.tokens)
    elif cfg.attn_every > 0:
        say(f"    prefill drops at the default capacity: "
            f"{json.dumps(moe_drops(torch, cfg, params, prompts))}")
        full = check_hybrid_model(torch, cfg, params, prompts)
        say(f"    full-size consistency, nothing dropped, kernel and plain "
            f"scan: {json.dumps(full)}")
        say(f"    cache slots: {json.dumps(cache_slot_check(torch, cfg, params, prompts))}")
    elif cfg.moe_experts:
        say(f"    prefill drops at the default capacity: "
            f"{json.dumps(moe_drops(torch, cfg, params, prompts))}")
        full = check_moe_model(torch, cfg, params, prompts)
        say(f"    full-size consistency, nothing dropped: {json.dumps(full)}")
    else:
        full = check_full_model(torch, cfg, params, prompts, res.tokens)
        say(f"    full-size consistency: {full}")
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=PROMPT_LEN + 2)
        tok = logits[:, -1].argmax(-1)
        decode_step(cfg, params, cache, tok, PROMPT_LEN)      # warm
        moe = bool(cfg.moe_experts)
        say(f"    profile of one eager decode step: {profile(torch, lambda: decode_step(cfg, params, cache, tok, PROMPT_LEN), moe)}")
        del logits, cache
        logits, slot = engine._prefill(prompts)
        tok = logits[:, -1].argmax(-1)
        engine._decode(slot, tok, PROMPT_LEN)                 # a replay, warm
        say(f"    profile of one replayed decode step (token and position "
            f"writes, the graph): {profile(torch, lambda: engine._decode(slot, tok, PROMPT_LEN + 1), moe)}")
        del logits, slot, engine
        say(f"    profile of one prefill: {profile(torch, lambda: prefill(cfg, params, prompts), moe)}")
    del params
    torch.cuda.empty_cache()
    if not short:
        small = check_small_model(torch, arch)
        say(f"    small config, card vs CPU plain: {small}")
    return counts, {"warm_ttft": warm.ttft, "tpot": steady.tpot,
                    "cold_tpot": cold.tpot, "warm_tpot": warm.tpot}


# ------------------------------- phases 14-17 ---------------------------------
# jamba_v01_52b serves at full width with its depth cut to two blocks of
# eight layers (each 7 Mamba, 1 attention, 4 MoE; 26.0 B parameters, 52 GB
# in bf16): the whole 52 B model (about 104 GB) does not fit one 80 GB
# card, and running it across cards is ROADMAP.md queue 1 item 9. One
# block (8 layers) peaked at 28.4 GiB on an H100; two blocks also put the
# cache's slots of a second block to the test.
JAMBA_LAYERS = 16


def memory_source(torch, cfg, seed: int):
    """Seeded (REQUESTS, M, d) bf16 on the card: the VLM's image
    embeddings, or the encoder-decoder's audio frames."""
    m = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((REQUESTS, m, cfg.d_model), generator=g,
                       device="cuda").to(torch.bfloat16)


def check_memory_serving(torch, kernels, cfg, want: dict[str, int],
                         phase: int, want_kind: dict[str, int] | None = None,
                         recorded: dict | None = None) -> tuple[dict, dict]:
    """A cross-attention config served at full size through ``ServeEngine``
    with a memory (the reference's ``run_serve`` passes none): the image
    embeddings, or the encoder's output over the audio frames (``encode``,
    timed on its own: TTFT leaves it out, as the reference's does). The
    counters are zeroed just before the encoder and ``generate`` and read
    just after (``want``). Then: graph tokens against eager ones; a second
    memory changes the prefill logits and the replayed decode logits, and
    the warm engine serves it without a new capture, its graph tokens
    equal to eager decoding with that memory; a warm generate and steady
    decode; the decode path's logits against a teacher-forced forward;
    profiles; the SMOKE config on the card against the CPU. ``want_kind``:
    launches by instantiation (``kernels.launches_by_kind``) the run must
    show as well; ``recorded``: an earlier run's warm TTFT and steady TPOT
    (ms), printed beside this run's. Returns the launch counts (by wrapper
    and by instantiation) and the warm TTFT, steady TPOT and encoder
    time."""
    from repro_torch.models import encode, prefill
    from repro_torch.serve import ServeEngine

    params, prompts = serve_inputs(torch, cfg, REQUESTS, SEED)
    sources = [memory_source(torch, cfg, SEED + 2), memory_source(torch, cfg, SEED + 3)]

    def to_memory(src):
        return encode(cfg, params, src) if cfg.is_enc_dec else src

    engine = ServeEngine(cfg, params, max_batch=REQUESTS,
                         max_len=PROMPT_LEN + NEW_TOKENS + 1)
    say(f"[{phase}] {cfg.name}: {REQUESTS} requests x {PROMPT_LEN} prompt tokens "
        f"x {NEW_TOKENS} new tokens, memory {tuple(sources[0].shape)} "
        f"({'audio frames through the encoder' if cfg.is_enc_dec else 'image embeddings'}), "
        f"seed {SEED}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        memory = to_memory(sources[0])
        torch.cuda.synchronize()
        encoder_s = time.perf_counter() - t0
    res = engine.generate(prompts, n_tokens=NEW_TOKENS, memory=memory)
    counts, kinds = kernels.launches(), kernels.launches_by_kind()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in counts} | want
    say(f"    encoder {encoder_s * 1e3:.3f} ms (cold), TTFT {res.ttft * 1e3:.3f} ms, "
        f"TPOT {res.tpot * 1e3:.4f} ms, {res.tokens_per_s:.2f} tokens/s, peak memory "
        f"{peak / 2**30:.3f} GiB; launches {counts}, by instantiation {kinds}")
    if counts != want:
        raise AssertionError(f"{cfg.name}: launch counts {counts} != {want}")
    if want_kind and any(kinds.get(k, 0) != n for k, n in want_kind.items()):
        raise AssertionError(f"{cfg.name}: launches by instantiation {kinds}, "
                             f"want {want_kind}")
    if len(res.tokens) != NEW_TOKENS or any(
            len(t) != REQUESTS or not all(0 <= x < cfg.vocab for x in t)
            for t in res.tokens):
        raise AssertionError(f"{cfg.name}: generated tokens malformed")
    if engine.captures != 1:
        raise AssertionError(f"{cfg.name}: {engine.captures} captures in a new "
                             f"engine's generate")
    gve = graph_vs_eager(torch, cfg, params, prompts, res.tokens, memory=memory)
    gve.pop("tokens")
    say(f"    graph vs eager decode (new engine): {json.dumps(gve)}")

    with torch.no_grad():
        other = to_memory(sources[1])
        logits, slot = engine._prefill(prompts, memory)
        first = logits[:, -1].clone()
        tok = first.argmax(-1)
        dec = engine._decode(slot, tok, PROMPT_LEN, memory).clone()
        logits, slot = engine._prefill(prompts, memory)       # the same cache
        dec_other = engine._decode(slot, tok, PROMPT_LEN, other).clone()
        logits, _ = engine._prefill(prompts, other)
        changed = {"prefill_logit_change": (logits[:, -1].float() - first.float()).abs().max().item(),
                   "replayed_decode_logit_change": (dec_other.float() - dec.float()).abs().max().item()}
        del logits, slot, first, dec, dec_other
    warm_other = graph_vs_eager(torch, cfg, params, prompts, memory=other, engine=engine)
    changed["tokens_changed"] = warm_other.pop("tokens") != res.tokens
    changed["warm_engine"] = warm_other
    say(f"    a second memory through the warm engine: {json.dumps(changed)}")
    if not (changed["prefill_logit_change"] > 0 and changed["replayed_decode_logit_change"] > 0
            and engine.captures == 1):
        raise AssertionError(f"{cfg.name}: a changed memory did not reach the "
                             f"prefill or the replayed decode, or was captured anew: "
                             f"{changed}, captures {engine.captures}")
    del other
    warm = engine.generate(prompts, n_tokens=NEW_TOKENS, memory=memory)
    if warm.tokens != res.tokens or engine.captures != 1:
        raise AssertionError(f"{cfg.name}: a warm generate gave other tokens or "
                             f"captured ({engine.captures})")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_memory(sources[0])
        torch.cuda.synchronize()
        warm_encoder_s = time.perf_counter() - t0
    steady = engine.decode_steady(prompts, n_steps=16, warmup=2, memory=memory)
    say(f"    warm generate (captures nothing): TTFT {warm.ttft * 1e3:.3f} ms, TPOT "
        f"{warm.tpot * 1e3:.4f} ms, {warm.tokens_per_s:.2f} tokens/s; warm encoder "
        f"{warm_encoder_s * 1e3:.3f} ms")
    say(f"    decode_steady through the graph: TPOT mean {steady.tpot * 1e3:.4f} "
        f"ms, min {min(steady.step_times) * 1e3:.4f}, max "
        f"{max(steady.step_times) * 1e3:.4f} over {len(steady.step_times)} "
        f"steps; {steady.tokens_per_s:.2f} tokens/s")
    if recorded:
        say(f"    beside {recorded['run']}: warm TTFT {warm.ttft * 1e3:.3f} ms against "
            f"{recorded['warm_ttft_ms']} ms, steady TPOT {steady.tpot * 1e3:.4f} ms "
            f"against {recorded['tpot_ms']} ms")
    full = check_full_model(torch, cfg, params, prompts, res.tokens, memory)
    say(f"    full-size consistency: {full}")
    with torch.no_grad():
        logits, slot = engine._prefill(prompts, memory)
        tok = logits[:, -1].argmax(-1)
        del logits
        engine._decode(slot, tok, PROMPT_LEN, memory)           # a replay, warm
        say(f"    profile of one replayed decode step (token, position and "
            f"memory writes, the graph): "
            f"{profile(torch, lambda: engine._decode(slot, tok, PROMPT_LEN + 1, memory))}")
        del slot, engine
        say(f"    profile of one prefill: "
            f"{profile(torch, lambda: prefill(cfg, params, prompts, memory=memory))}")
        if cfg.is_enc_dec:
            say(f"    profile of the encoder: "
                f"{profile(torch, lambda: to_memory(sources[0]))}")
    del params, memory, sources
    torch.cuda.empty_cache()
    say(f"    small config, card vs CPU plain: {check_small_model(torch, cfg.name)}")
    return counts | kinds, {"warm_ttft": warm.ttft, "tpot": steady.tpot,
                            "encoder_s": warm_encoder_s, "peak_bytes": peak}


def check_hybrid_model(torch, cfg, params, prompts) -> dict:
    """Jamba's decode path against a teacher-forced forward
    (:func:`moe_model_readings`, nothing dropped), once with the scan
    through the kernel and once through its plain version
    (:func:`plain_scan`), as phase 7 holds Mamba2 and phase 11 OLMoE: on
    both routes greedy agreement at least 0.8 and some step held before the
    first route difference; the kernel route's decode-vs-teacher errors,
    with its own routes and with the decode path's replayed, at most
    SSM_REL times the plain route's."""
    out = {}
    for route in ("kernel", "plain"):
        with plain_scan() if route == "plain" else contextlib.nullcontext():
            out[route] = moe_model_readings(torch, cfg, params, prompts)
        torch.cuda.empty_cache()
    broken = []
    for route, r in out.items():
        for key in ("greedy_agreement", "replayed_routes_greedy_agreement"):
            if r[key] is None or r[key] < 0.8:
                broken.append(f"{route} {key} {r[key]}")
        if not r["steps_held"]:
            broken.append(f"{route}: no step held")
    for key in ("decode_vs_prefill_scaled_err",
                "replayed_routes_decode_vs_prefill_scaled_err"):
        got, base = out["kernel"][key], out["plain"][key]
        if got is None or base is None or not got <= SSM_REL * base:
            broken.append(f"{key}: kernel {got} > {SSM_REL:g} x plain {base}")
    if broken:
        raise AssertionError(f"full model ({cfg.name}): limits broken: {broken}")
    return out


def cache_slot_check(torch, cfg, params, prompts) -> dict:
    """The cache that prefill fills, against each layer's own K/V, or state
    and conv tail, computed again on the same inputs: every attention layer
    in the ``k``/``v`` slot and every SSM layer in the ``ssm``/``conv`` slot
    that ``cache_spec`` gives its index in the block, bit for bit (the same
    kernels on the same inputs), and every slot filled once."""
    from repro_torch.models import cache_spec, layers as L, prefill
    from repro_torch.models.transformer import _rope, _run_stack, compute_dtype

    spec = cache_spec(cfg)
    order, equal = [], []
    with torch.no_grad():
        _, cache = prefill(cfg, params, prompts)
        rope = _rope(cfg, prompts.shape[1], prompts.device)

        def mix(blk, slot, lp, h):
            if "ssm" in lp:
                out, state, tail = L.ssm_layer(lp["ssm"], h, cfg)
                order.append(("ssm", blk, slot))
                equal.append(torch.equal(cache["ssm"][blk, slot], state)
                             and torch.equal(cache["conv"][blk, slot], tail))
                return out
            out, k, v = L.self_attention(lp["attn"], h, cfg, rope)
            order.append(("attn", blk, slot))
            equal.append(torch.equal(cache["k"][blk, slot], k)
                         and torch.equal(cache["v"][blk, slot], v))
            return out

        _run_stack(cfg, params, params["embed"][prompts].to(compute_dtype(cfg)), mix)
        del cache
    want = [("attn" if cfg.layer_kind(i) == "attn" else "ssm", b, spec.slot(i))
            for b in range(cfg.n_blocks) for i in range(cfg.block_size)]
    out = {"attn_slots": spec.attn_slots, "ssm_slots": spec.ssm_slots,
           "layers": len(order), "order_as_spec": order == want,
           "slots_filled_once": len(set(order)) == len(order) == cfg.n_layers,
           "bit_identical": all(equal)}
    if not (out["order_as_spec"] and out["slots_filled_once"] and out["bit_identical"]):
        raise AssertionError(f"{cfg.name}: the cache's slots are not where "
                             f"cache_spec puts them: {out} {order}")
    return out


def check_specdecode(torch, kernels) -> tuple[dict, dict]:
    """Greedy sequence speculative decoding on the card (olmo_1b SMOKE, hd
    32, random weights from the seed): with the target as its own draft,
    the tokens bit-identical to the engine's greedy tokens, acceptance rate
    1 and fewer target calls than tokens; with another draft (the target's
    first layer alone, an early-exit draft), tokens, rate and target calls
    equal to the same run on the CPU (the plain versions). The counters
    are zeroed before the card's runs and read after. Returns (launch
    counts, readings)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, to_device
    from repro_torch.serve import ServeEngine, speculative_generate

    cfg = get_config("olmo_1b", smoke=True)
    target = init_params(cfg, seed=SEED)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    draft = dict(target, stack=target["stack"][:1])
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab, (1, 16), generator=g, device="cuda")
    n, window = 16, 4
    kernels.reset_launches()
    plain = [t[0] for t in ServeEngine(cfg, target, max_batch=1, max_len=16 + n + 1)
             .generate(prompt, n_tokens=n).tokens]
    self_draft = speculative_generate(cfg, target, cfg, target, prompt, n, window)
    other = speculative_generate(cfg, target, dcfg, draft, prompt, n, window)
    counts = kernels.launches()
    cpu = speculative_generate(cfg, to_device(target, "cpu"), dcfg,
                               to_device(draft, "cpu"), prompt.cpu(), n, window)
    out = {"tokens": n, "window": window,
           "self_draft_identical_to_engine": self_draft[0] == plain,
           "self_draft_rate": self_draft[1], "self_draft_target_calls": self_draft[2],
           "other_draft_card_equals_cpu": other == cpu,
           "other_draft_rate": other[1], "other_draft_target_calls": other[2],
           "cpu_rate": cpu[1], "cpu_target_calls": cpu[2]}
    if not (out["self_draft_identical_to_engine"] and self_draft[1] == 1.0
            and self_draft[2] < n and out["other_draft_card_equals_cpu"]):
        raise AssertionError(f"speculative decoding: {out} {self_draft[0]} {plain} "
                             f"{other[0]} {cpu[0]}")
    return counts, out


def phase_vision(torch, kernels):
    """Phase 14: the VLM, cross-attention to image embeddings, at full
    width and depth. A pass runs 1 + 2L + n_cross norms, and flash (prefill)
    or decode attention for each of the L self-attention and n_cross
    cross-attention layers."""
    from repro_torch.configs import get_config

    cfg = get_config("llama32_vision_11b")
    n_cross = sum(cfg.layer_is_cross(i % cfg.block_size) for i in range(cfg.n_layers))
    return check_memory_serving(torch, kernels, cfg, {
        "rmsnorm": (1 + 2 * cfg.n_layers + n_cross) * NEW_TOKENS,
        "flash_attention": cfg.n_layers + n_cross,
        "decode_attention": (cfg.n_layers + n_cross) * (NEW_TOKENS - 1)}, phase=14)


#: phase 15's warm TTFT and steady TPOT on the hd-128 designs instantiated at
#: hd 64, as PERF.md section 6 records them (chip_smoke.py on an H100 80GB
#: HBM3, 700 W): printed beside this run's
SEAMLESS_RECORDED = {"run": "the previous hd-64 kernels' recorded run (PERF.md section 6)",
                     "warm_ttft_ms": 44.8, "tpot_ms": 3.547}


def phase_seamless(torch, kernels):
    """Phase 15: the encoder-decoder at full width and depth: the encoder's
    non-causal self-attention, then every decoder layer cross-attends to
    its output (LayerNorm: no rmsnorm); every attention launch at hd 64."""
    from repro_torch.configs import get_config

    cfg = get_config("seamless_m4t_medium")
    flash = cfg.encoder_layers + 2 * cfg.n_layers
    decode = 2 * cfg.n_layers * (NEW_TOKENS - 1)
    return check_memory_serving(torch, kernels, cfg, {
        "flash_attention": flash, "decode_attention": decode}, phase=15,
        want_kind={"flash_attention[bf16/hd64]": flash, "decode_attention[bf16/hd64]": decode},
        recorded=SEAMLESS_RECORDED)


def phase_jamba(torch, kernels):
    """Phase 16: Jamba's hybrid blocks at full width, the depth cut to
    JAMBA_LAYERS. A pass runs 1 + 2L residual norms and a gated norm in
    each SSM layer; the prefill runs the scan in each SSM layer; attention
    runs in the one attention layer of each block."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("jamba_v01_52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    n_ssm = sum(cfg.layer_kind(i % cfg.block_size) == "ssm" for i in range(cfg.n_layers))
    n_attn = cfg.n_layers - n_ssm
    say(f"[16] jamba_v01_52b serving: d_model {cfg.d_model}, d_inner "
        f"{cfg.ssm_expand * cfg.d_model}, SSM state {cfg.ssm_state}, "
        f"{cfg.moe_experts} experts top-{cfg.moe_top_k}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads}; depth cut from {full.n_layers} to "
        f"{cfg.n_layers} layers ({n_ssm} Mamba, {n_attn} attention, "
        f"{moe_layers(cfg)} MoE)")
    out = check_serving(torch, kernels, "jamba_v01_52b", REQUESTS, {
        "ssd": n_ssm, "flash_attention": n_attn,
        "decode_attention": n_attn * (NEW_TOKENS - 1),
        "rmsnorm": (1 + 2 * cfg.n_layers + n_ssm) * NEW_TOKENS}, phase=16,
        cfg=cfg, short=True)
    say(f"    small config (jamba_smoke), card vs CPU plain: "
        f"{check_small_model(torch, 'jamba_v01_52b')}")
    return out


def phase_specdecode(torch, kernels):
    """Phase 17: speculative decoding (:func:`check_specdecode`)."""
    say("[17] speculative decoding (olmo_1b SMOKE): self-draft against the "
        "engine's greedy tokens, another draft against the CPU")
    counts, out = check_specdecode(torch, kernels)
    say(f"    {json.dumps(out)}; launches {counts}")
    return counts, out


#: phases 14-17, (path, phase function)
NEW_PATHS = (("llama32_vision_11b", phase_vision),
             ("seamless_m4t_medium", phase_seamless),
             ("jamba_v01_52b", phase_jamba),
             ("olmo_1b_specdecode", phase_specdecode))


def check_memory_hybrid_paths(torch, kernels) -> dict[str, dict]:
    """Phases 14-17 (NEW_PATHS) in turn. Returns each path's launch counts
    and prints the serving paths' timings."""
    counts, timings = {}, {}
    for path, phase in NEW_PATHS:
        counts[path], timings[path] = phase(torch, kernels)
        torch.cuda.empty_cache()
    timings.pop("olmo_1b_specdecode")
    say(f"    memory and hybrid paths' timings: {json.dumps(timings)}")
    return counts


# ------------------------------- phase 8: training ----------------------------
def leaf_grads(torch, cfg, params, batch):
    """(loss, [gradient per leaf]) of ``loss_fn`` through autograd."""
    from repro_torch.models import loss_fn
    from repro_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), list(grads)


def check_train_grads(torch, kernels) -> dict:
    """olmo_1b at full width with 2 layers, batch 2 x 2048: loss and every
    parameter gradient through the kernels (flash_attention_train) against
    the same model whose attention is the plain forward under autograd,
    swapped in here for the comparison."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import init_params, layers, param_dtype, synth_batch

    cfg = dataclasses.replace(get_config("olmo_1b"), n_layers=GRAD_LAYERS)
    params = init_params(cfg, seed=SEED, dtype=param_dtype(cfg))
    batch = synth_batch(cfg, GRAD_BATCH, TRAIN_SEQ,
                        torch.Generator(device="cuda").manual_seed(SEED + 4))
    kernels.reset_launches()
    loss, grads = leaf_grads(torch, cfg, params, batch)
    counts = kernels.launches()
    kernel_attention = layers.flash_attention_train
    layers.flash_attention_train = flash_attention_ref
    try:
        kernels.reset_launches()
        want_loss, want = leaf_grads(torch, cfg, params, batch)
        if any(kernels.launches().values()):
            raise AssertionError(f"the plain model launched kernels: "
                                 f"{kernels.launches()}")
    finally:
        layers.flash_attention_train = kernel_attention
    # tree_leaves order: dict keys sorted (empty norm trees hold no leaf)
    names = ["embed", *[f"l{i}.{w}" for i in range(GRAD_LAYERS)
                        for w in ("wk", "wo", "wq", "wv", "mlp.wi", "mlp.wo")]]
    errs = [scaled_err(g, w) for g, w in zip(grads, want)]
    by_name = dict(zip(names, grads))
    attn_norms = {f"l{i}.{w}": by_name[f"l{i}.{w}"].norm().item()
                  for i in range(GRAD_LAYERS) for w in ("wq", "wk", "wv")}
    out = {"loss": loss.item(), "plain_loss": want_loss.item(),
           "max_scaled_err": max(errs), "launches": counts,
           "attn_grad_norms": attn_norms, "n_leaves": len(grads),
           "scaled_err_by_leaf": {k: float(f"{e:.3g}") for k, e in zip(names, errs)}}
    if len(grads) != len(names):
        raise AssertionError(f"gradient check: {len(grads)} leaves")
    n = cfg.n_layers
    if counts != {**dict.fromkeys(counts, 0), "flash_attention_fwd_lse": 2 * n,
                  "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}:
        raise AssertionError(f"gradient check: launches {counts}")
    if not (abs(out["loss"] - out["plain_loss"]) <= SCALED_TOL_SMALL * out["plain_loss"]
            and max(errs) <= SCALED_TOL_SMALL and min(attn_norms.values()) > 0
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError(f"gradient check beyond {SCALED_TOL_SMALL:g}, "
                             f"or a zero attention gradient: {out}")
    del params, grads, want
    torch.cuda.empty_cache()
    return out


def check_smoke_training(torch, arch: str = "olmo_1b", steps: int = 3,
                         dtype: str = "bfloat16") -> dict:
    """The SMOKE config's ``steps`` train steps in ``dtype`` on the card
    against the same steps on the CPU (plain versions): losses within 2e-2
    (float32: 1e-5, and the gradient norms within 1e-4, the float32
    tolerances of tests/test_torch_train.py and test_torch_train_rmsnorm.py),
    parameters at the reference's rtol 2e-2, atol 2e-3 (lr 1e-4, so that
    Adam's sign on a near-zero gradient moves a weight by at most 3 x
    2e-4). The batch carries the image embeddings or audio frames the
    config's memory takes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_dtype, to_device
    from repro_torch.train import AdamWConfig, SyntheticTokens, adamw_init, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(arch, smoke=True)
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    cpu = init_params(cfg, seed=SEED, device="cpu", dtype=param_dtype(cfg))
    gpu = to_device(cpu, "cuda")
    step = make_train_step(cfg, AdamWConfig(lr=1e-4))
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = (cfg.n_image_tokens, cfg.d_model)
    if cfg.is_enc_dec:
        extras["audio_frames"] = (cfg.n_audio_frames, cfg.d_model)
    data = iter(SyntheticTokens(cfg.vocab, 4, 64, seed=SEED, extras=extras))
    out = {"loss_cpu": [], "loss_card": [], "grad_norm_cpu": [], "grad_norm_card": []}
    opt_cpu, opt_gpu = adamw_init(cpu), adamw_init(gpu)
    for _ in range(steps):
        b = next(data)
        _, _, m = step(cpu, opt_cpu, b)
        out["loss_cpu"].append(float(m["loss"]))
        out["grad_norm_cpu"].append(float(m["grad_norm"]))
        _, _, m = step(gpu, opt_gpu, {k: v.cuda() for k, v in b.items()})
        out["loss_card"].append(float(m["loss"]))
        out["grad_norm_card"].append(float(m["grad_norm"]))
    rel = max(abs(a - b) / b for a, b in zip(out["loss_card"], out["loss_cpu"]))
    grad_rel = max(abs(a - b) / b for a, b in zip(out["grad_norm_card"],
                                                  out["grad_norm_cpu"]))
    worst = max(((a.cpu() - b).abs() - 2e-2 * b.abs()).max().item()
                for a, b in zip(tree_leaves(gpu), tree_leaves(cpu)))
    out.update(loss_rel_diff=rel, grad_norm_rel_diff=grad_rel,
               param_excess_over_rtol=worst)
    f32 = dtype == "float32"
    if not (rel <= (1e-5 if f32 else 2e-2) and worst <= 2e-3
            and (not f32 or grad_rel <= 1e-4)):
        raise AssertionError(f"SMOKE training {arch} {dtype} card vs CPU: {out}")
    return out


def mm_params(cfg, params) -> int:
    """Parameters of the 2-D matmul weights: every 2-D leaf but the SSM's
    depthwise convolution (``conv_w``) and, untied, the embedding (a row
    lookup; tied, it is the head). 1-D leaves (norms, the SSM's A_log, D,
    dt_bias) and the MoE's 3-D expert stacks are not counted."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return sum(walk(v, k) for k, v in node.items())
        if isinstance(node, list):
            return sum(walk(v, name) for v in node)
        skip = name == "conv_w" or (name == "embed" and not cfg.tie_embeddings)
        return 0 if skip or node.dim() != 2 else node.numel()
    return walk(params)


def train_flops(cfg, params, batch: int, seq: int) -> dict:
    """FLOPs of one step of T = batch x seq tokens. Model FLOPs (the MFU
    numerator): 6 N T for the N 2-D matmul weights (:func:`mm_params`),
    plus 3x the causal attention forward of each attention layer (4 B H hd
    a pair) and 3x the SSD scan's forward of each SSM layer (2 x
    ``cost.ssd_multiply_adds``), no recomputation. Executed: adds remat's
    second forward (2 N T, the attention forward, the scan's forward), the
    attention backward kernels' seven (S, S) x hd products a layer (3.5x
    the forward) and the plain SSD backward's own forward. Returns both
    and the model formula's terms."""
    from repro_torch.kernels.cost import attention_pairs, ssd_multiply_adds
    from repro_torch.models.layers import ssm_dims

    t = batch * seq
    kinds = [cfg.layer_kind(i % cfg.block_size) for i in range(cfg.n_layers)]
    n_mm = mm_params(cfg, params)
    attn_fwd = kinds.count("attn") * 4.0 * batch * cfg.n_heads * cfg.hd * \
        attention_pairs(seq, seq, True)
    ssd_fwd = 0.0
    if "ssm" in kinds:
        _, n, h, p = ssm_dims(cfg)
        ssd_fwd = kinds.count("ssm") * 2.0 * ssd_multiply_adds(batch, seq, h, p, n)
    model = 6.0 * n_mm * t + 3 * attn_fwd + 3 * ssd_fwd
    executed = 8.0 * n_mm * t + attn_fwd * (2 + 3.5) + 5 * ssd_fwd
    return {"model_flops": model, "executed_flops": executed,
            "formula": f"6 x {n_mm:,} matmul weights x {t} tokens + 3 x {attn_fwd:.4g} "
                       f"attention forward + 3 x {ssd_fwd:.4g} SSD forward"}


def check_training(torch, kernels) -> dict[str, int]:
    """``run_train`` on the full olmo_1b, 8 x 2048, on one repeated batch,
    launch counters zeroed just before and read just after; then one full
    step under the profiler. Returns the launch counts of the run."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_train
    from repro_torch.models import init_params, param_dtype
    from repro_torch.train import AdamWConfig, SyntheticTokens, adamw_init, make_train_step

    cfg = get_config("olmo_1b")
    say(f"[8] run_train {cfg.name}: {TRAIN_STEPS} steps x {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens on one repeated batch, seed {SEED}, remat "
        f"{cfg.remat}")
    kernels.reset_launches()
    res = run_train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    seed=SEED, repeat=True)
    counts = kernels.launches()
    n = cfg.n_layers * TRAIN_STEPS
    want = {**dict.fromkeys(counts, 0), "flash_attention_fwd_lse": 2 * n,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    steady = res.step_times[1:]
    shapes = init_params(cfg, seed=SEED, dtype=torch.bfloat16)
    fl = train_flops(cfg, shapes, TRAIN_BATCH, TRAIN_SEQ)
    del shapes
    mean = sum(steady) / len(steady)
    say(f"    {res.n_params:,} params; losses {[round(x, 4) for x in res.losses]}")
    say(f"    step times (s) {[round(x, 4) for x in res.step_times]}; steady "
        f"mean {mean:.4f} s, min {min(steady):.4f} s; {res.tokens_per_s:.1f} "
        f"tokens/s; peak memory {res.peak_memory_bytes / 2**30:.3f} GiB")
    say(f"    FLOPs per step: model {fl['model_flops']:.4g} ({fl['formula']}), "
        f"executed {fl['executed_flops']:.4g} (remat "
        f"and the 7-product backward); share of {BF16_FLOP_PER_S:.3g} "
        f"FLOP/s at the steady mean: MFU "
        f"{fl['model_flops'] / mean / BF16_FLOP_PER_S:.4f}, executed "
        f"{fl['executed_flops'] / mean / BF16_FLOP_PER_S:.4f}; floor "
        f"{fl['executed_flops'] / BF16_FLOP_PER_S:.4f} s")
    say(f"    launches {counts}")
    if counts != want:
        raise AssertionError(f"training: launch counts {counts} != {want}")
    first, last = res.losses[0], res.losses[-1]
    expect = math.log(cfg.vocab) + 0.5
    if not (all(math.isfinite(x) for x in res.losses)
            and abs(first - expect) <= 0.5 and last < first):
        raise AssertionError(f"training: losses {res.losses} (step 0 should "
                             f"be near {expect:.3f}, the last below it)")

    params = init_params(cfg, seed=SEED, dtype=param_dtype(cfg))
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig())
    batch = next(iter(SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED, device="cuda")))
    step(params, opt, batch)                         # warm
    say(f"    profile of one train step: "
        f"{profile(torch, lambda: float(step(params, opt, batch)[2]['loss']))}")
    del params, opt
    torch.cuda.empty_cache()
    return counts


# ------------------------------- phase 18: RMSNorm and SSM training ----------
#: mistral_nemo_12b trains at full width with its depth cut to this many
#: layers: at full depth (40) its f32 weights, gradients and AdamW moments
#: alone are ~190 GB; two layers are 1.9 B parameters, ~30 GB of them
MISTRAL_TRAIN_LAYERS = 2
#: steps of mistral_nemo_12b under each remat policy, on one repeated batch
MISTRAL_TRAIN_STEPS = 3
#: "full" and "dots" recompute the same functions (the matmuls' outputs
#: saved by "dots" are the ones "full" recomputes), so their losses may part
#: only by the f32 rounding of a sum taken in another order
REMAT_LOSS_REL = 1e-3
#: the RMSNorm and SSM configs whose SMOKE step is held card vs CPU
RMSNORM_ARCHS = ("mistral_nemo_12b", "mamba2_130m", "olmoe_1b_7b", "qwen3_moe_235b",
                 "llama32_vision_11b", "jamba_v01_52b")


@contextlib.contextmanager
def plain_training_routes():
    """The model's fused RMSNorm, SSD scan and training attention swapped for
    their plain versions under autograd, for phase 18's comparison route
    only; restored on exit."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
    from repro_torch.models import layers, transformer

    saved = (transformer.fused_rmsnorm, layers.fused_rmsnorm, layers.flash_attention_train)
    transformer.fused_rmsnorm = layers.fused_rmsnorm = fused_rmsnorm_ref
    layers.flash_attention_train = flash_attention_ref
    try:
        with plain_scan():
            yield
    finally:
        (transformer.fused_rmsnorm, layers.fused_rmsnorm,
         layers.flash_attention_train) = saved


def rmsnorm_train_launches(cfg, steps: int = 1) -> dict[str, int]:
    """Launches of ``steps`` train steps under remat "full" or "dots" (a
    checkpointed layer runs its forward twice): the first norm once and
    each layer's norms (its gated norm, lnx, ln2 and the residual norm into
    the next layer) twice forward, every norm once backward; the scan twice
    in each SSM layer; the training attention's forward with LSE twice and
    each backward kernel once in each attention layer (self-attention; the
    cross layers of a config with a memory add their cross-attention and
    its norm, lnx)."""
    kinds = [cfg.layer_kind(i % cfg.block_size) for i in range(cfg.n_layers)]
    n_ssm = kinds.count("ssm")
    n_cross = sum(cfg.layer_is_cross(i % cfg.block_size) for i in range(cfg.n_layers)) \
        if cfg.family == "vlm" else 0
    n_attn = kinds.count("attn") + n_cross
    norms = 1 + cfg.n_layers + n_ssm + n_cross + (cfg.n_layers if cfg.d_ff else 0)
    out = {"rmsnorm": (2 * norms - 1) * steps, "rmsnorm_bwd": norms * steps}
    if n_ssm:
        out["ssd"] = 2 * n_ssm * steps
    if n_attn:
        out |= {"flash_attention_fwd_lse": 2 * n_attn * steps,
                "flash_attention_bwd_dkv": n_attn * steps,
                "flash_attention_bwd_dq": n_attn * steps}
    return out


def check_rmsnorm_grads(torch, kernels, arch: str) -> dict:
    """Phase 18 (a): ``arch`` at full width with GRAD_LAYERS layers, batch
    GRAD_BATCH x TRAIN_SEQ: loss and every leaf's gradient through the
    kernels (the norm's backward kernel, the scan's kernel and plain
    backward, the training attention) against the same model with the
    plain routes swapped in (:func:`plain_training_routes`), each within
    SCALED_TOL_SMALL of its largest value; launch counts exact."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd_plain
    from repro_torch.models import init_params, param_dtype, synth_batch

    cfg = dataclasses.replace(get_config(arch), n_layers=GRAD_LAYERS)
    params = init_params(cfg, seed=SEED, dtype=param_dtype(cfg))
    batch = synth_batch(cfg, GRAD_BATCH, TRAIN_SEQ,
                        torch.Generator(device="cuda").manual_seed(SEED + 4))
    kernels.reset_launches()
    ssd_chunk_bwd_plain.calls = 0
    loss, grads = leaf_grads(torch, cfg, params, batch)
    counts, plain_bwd = kernels.launches(), ssd_chunk_bwd_plain.calls
    with plain_training_routes():
        kernels.reset_launches()
        want_loss, want = leaf_grads(torch, cfg, params, batch)
        if any(kernels.launches().values()):
            raise AssertionError(f"the plain model launched kernels: {kernels.launches()}")
    errs = [scaled_err(g, w) for g, w in zip(grads, want)]
    expect = rmsnorm_train_launches(cfg)
    n_ssm = expect.get("ssd", 0) // 2
    names = leaf_names(params)
    out = {"loss": loss.item(), "plain_loss": want_loss.item(), "n_leaves": len(grads),
           "max_scaled_err": max(errs),
           "scaled_err_by_leaf": {k: float(f"{e:.3g}") for k, e in zip(names, errs)},
           "launches": counts,
           "ssd_plain_backward_calls": plain_bwd,
           "zero_grad_leaves": sum(int(not bool(g.any())) for g in grads)}
    if counts != {**dict.fromkeys(counts, 0), **expect} or plain_bwd != n_ssm:
        raise AssertionError(f"gradient check {arch}: launches {counts} (want {expect}), "
                             f"plain SSD backward calls {plain_bwd} (want {n_ssm})")
    if not (abs(out["loss"] - out["plain_loss"]) <= SCALED_TOL_SMALL * out["plain_loss"]
            and max(errs) <= SCALED_TOL_SMALL and not out["zero_grad_leaves"]
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError(f"gradient check {arch} beyond {SCALED_TOL_SMALL:g}, or a "
                             f"zero or non-finite gradient: {out}")
    del params, grads, want
    torch.cuda.empty_cache()
    return out


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted names of a parameter tree's leaves, in ``tree_leaves`` order
    (dict keys sorted; a block list's entries numbered)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


#: phase 18 (b) trains mamba2_130m at full width with this many of its 24
#: layers, cut to hold the run under RUN_LIMIT_S (12 until the run's total
#: read 653.1 s, over the limit)
MAMBA2_TRAIN_LAYERS = 6


def check_mamba2_training(torch, kernels) -> dict[str, int]:
    """Phase 18 (b): ``run_train`` on mamba2_130m at full width with
    MAMBA2_TRAIN_LAYERS of its 24 layers, 8 x
    2048, TRAIN_STEPS steps on one repeated batch, remat "full", counters
    zeroed just before and read just after; a finite loss that falls; step
    time, tokens/s, MFU, peak memory; then one step profiled on the device
    and split: matmul, ssd forward (the kernel), ssd backward (plain tensor
    code: one layer's, profiled alone at the same shapes, times the layers,
    taken out of the groups its kernels fall in), rmsnorm forward, rmsnorm
    backward, other. Returns the run's launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd_plain
    from repro_torch.launch.train import run_train
    from repro_torch.models import init_params, param_dtype
    from repro_torch.train import AdamWConfig, SyntheticTokens, adamw_init, make_train_step

    cfg = dataclasses.replace(get_config("mamba2_130m"), n_layers=MAMBA2_TRAIN_LAYERS)
    say(f"[18b] run_train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{TRAIN_STEPS} steps x {TRAIN_BATCH} x {TRAIN_SEQ} tokens on one repeated "
        f"batch, seed {SEED}, remat {cfg.remat}")
    kernels.reset_launches()
    ssd_chunk_bwd_plain.calls = 0
    res = run_train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    seed=SEED, repeat=True)
    counts = kernels.launches()
    want = {**dict.fromkeys(counts, 0), **rmsnorm_train_launches(cfg, TRAIN_STEPS)}
    report_training(torch, cfg, res, "mamba2_130m", counts, TRAIN_BATCH)
    say(f"    plain SSD backward calls {ssd_chunk_bwd_plain.calls}")
    if counts != want or ssd_chunk_bwd_plain.calls != cfg.n_layers * TRAIN_STEPS:
        raise AssertionError(f"mamba2 training: launch counts {counts} != {want}, or "
                             f"{ssd_chunk_bwd_plain.calls} plain SSD backward calls")
    falling_loss(res.losses, "mamba2 training")

    params = init_params(cfg, seed=SEED, dtype=param_dtype(cfg))
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig())
    batch = next(iter(SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED, device="cuda")))
    step(params, opt, batch)                         # warm
    t0 = time.perf_counter()
    prof = profile(torch, lambda: float(step(params, opt, batch)[2]["loss"]), host=False)
    say(f"    profile of one train step (device only; read back in "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(prof)}")
    del params, opt
    torch.cuda.empty_cache()
    alone = ssd_backward_alone(torch, cfg)
    split = dict(prof["by_group_ms"])
    for g, ms in alone["profile"]["by_group_ms"].items():
        split[g] = split.get(g, 0.0) - cfg.n_layers * ms
    split["ssd_bwd_plain"] = cfg.n_layers * alone["profile"]["device_busy_ms"]
    wall_ms = cfg.n_layers * alone["wall_ms"]
    steady_ms = res_mean_ms(res)
    say(f"    one layer's plain SSD backward alone (device only): {json.dumps(alone)}")
    say(f"    the step's device time split ({cfg.n_layers} x one layer's plain SSD "
        f"backward taken out of its groups), ms: "
        f"{json.dumps({k: round(v, 3) for k, v in sorted(split.items(), key=lambda kv: -kv[1])})}")
    say(f"    plain SSD backward a step: {split['ssd_bwd_plain']:.3f} ms device "
        f"({split['ssd_bwd_plain'] / prof['device_busy_ms']:.4f} of the step's "
        f"{prof['device_busy_ms']:.3f} ms busy), {wall_ms:.1f} ms host wall "
        f"({wall_ms / steady_ms:.4f} of the steady step's {steady_ms:.1f} ms)")
    return counts


def res_mean_ms(res) -> float:
    """The steady mean step of a ``run_train`` result (after the first), ms."""
    steady = res.step_times[1:] or res.step_times
    return 1e3 * sum(steady) / len(steady)


def ssd_backward_alone(torch, cfg) -> dict:
    """One SSM layer's plain SSD backward (``ssd_chunk_bwd_plain``) at the
    training shape (TRAIN_BATCH x TRAIN_SEQ, the model's bf16 x and head-
    stride-0 B/C, f32 dt and dA, the gradient of y alone), on seeded inputs:
    its host wall time (synced, the mean of three calls after a warm one)
    and one call profiled on the device."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_bwd_plain
    from repro_torch.models.layers import ssm_dims

    _, n, h, p = ssm_dims(cfg)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(torch.bfloat16)
    dt = torch.rand(b, s, h, generator=g, device="cuda") * 0.1
    bc = [torch.randn(b, s, n, generator=g, device="cuda").to(torch.bfloat16)[:, :, None]
          .expand(b, s, h, n) for _ in range(2)]
    inputs = (x, dt, *bc, -dt)
    gy = torch.randn(b, s, h, p, generator=g, device="cuda")
    calls = ssd_chunk_bwd_plain.calls

    def run():
        ssd_chunk_bwd_plain(inputs, (True,) * 5, gy, None)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    out = {"wall_ms": wall, "profile": profile(torch, run, host=False)}
    ssd_chunk_bwd_plain.calls = calls
    return out


def falling_loss(losses, what: str) -> None:
    """Raise unless every loss is finite and the last is below the first."""
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses {losses} (finite, the last below the first)")


def report_training(torch, cfg, res, label: str, counts, batch: int) -> dict:
    """Print a ``run_train`` result of ``batch`` x TRAIN_SEQ tokens a step:
    losses, step times, tokens/s, peak memory, the FLOP shares of the peak
    (:func:`train_flops`, from a bf16 copy of the config's parameters made
    for their shapes), launches per step. Returns the numbers."""
    from repro_torch.models import init_params

    mean = res_mean_ms(res) / 1e3
    shapes = init_params(cfg, seed=SEED, dtype=torch.bfloat16)
    fl = train_flops(cfg, shapes, batch, TRAIN_SEQ)
    del shapes
    torch.cuda.empty_cache()
    out = {"losses": res.losses, "step_times_s": res.step_times, "steady_mean_s": mean,
           "tokens_per_s": res.tokens_per_s, "peak_memory_gib": res.peak_memory_bytes / 2**30,
           "mfu": fl["model_flops"] / mean / BF16_FLOP_PER_S,
           "executed_share": fl["executed_flops"] / mean / BF16_FLOP_PER_S,
           "launches_per_step": {k: v // len(res.losses) for k, v in counts.items() if v}}
    say(f"    {label}: {res.n_params:,} params; {json.dumps(out)}")
    say(f"    FLOPs per step: model {fl['model_flops']:.4g} = {fl['formula']}; "
        f"executed {fl['executed_flops']:.4g}; MFU {out['mfu']:.4f} of "
        f"{BF16_FLOP_PER_S:.3g} FLOP/s at the steady mean")
    return out


def check_mistral_training(torch, kernels) -> dict[str, int]:
    """Phase 18 (c): mistral_nemo_12b at full width with MISTRAL_TRAIN_LAYERS
    layers, GRAD_BATCH x TRAIN_SEQ, MISTRAL_TRAIN_STEPS steps on one
    repeated batch under remat "full" and under "dots", counters zeroed
    just before each and read just after; the two runs' losses within
    REMAT_LOSS_REL, each falling; step time and peak memory of each.
    Returns the launch counts of both runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_train

    full = get_config("mistral_nemo_12b")
    total = {}
    runs = {}
    for remat in ("full", "dots"):
        cfg = dataclasses.replace(full, n_layers=MISTRAL_TRAIN_LAYERS, remat=remat)
        say(f"[18c] run_train mistral_nemo_12b, depth cut from {full.n_layers} to "
            f"{cfg.n_layers} layers, {MISTRAL_TRAIN_STEPS} steps x {GRAD_BATCH} x "
            f"{TRAIN_SEQ}, remat {remat}")
        kernels.reset_launches()
        res = run_train(cfg, steps=MISTRAL_TRAIN_STEPS, batch=GRAD_BATCH, seq=TRAIN_SEQ,
                        seed=SEED, repeat=True)
        counts = kernels.launches()
        runs[remat] = report_training(torch, cfg, res, f"mistral remat {remat}", counts,
                                      GRAD_BATCH)
        want = {**dict.fromkeys(counts, 0),
                **rmsnorm_train_launches(cfg, MISTRAL_TRAIN_STEPS)}
        if counts != want:
            raise AssertionError(f"mistral training ({remat}): launches {counts} != {want}")
        falling_loss(res.losses, f"mistral training ({remat})")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["dots"]["losses"],
                                                   runs["full"]["losses"]))
    say(f"    losses full vs dots: largest relative difference {rel:.3g} (limit "
        f"{REMAT_LOSS_REL:g}); peak memory full {runs['full']['peak_memory_gib']:.3f} "
        f"GiB, dots {runs['dots']['peak_memory_gib']:.3f} GiB")
    if not rel <= REMAT_LOSS_REL:
        raise AssertionError(f"mistral training: full and dots losses part by {rel:.3g}")
    return total


def check_rmsnorm_training(torch, kernels) -> dict[str, dict]:
    """Phase 18: training through the fused RMSNorm and the SSD scan: (a)
    the full-width gradient checks of mamba2_130m and mistral_nemo_12b and
    one SMOKE step of every RMSNorm config card vs CPU, (b) ``run_train`` on
    mamba2_130m, (c) mistral_nemo_12b under "full" and "dots". Returns the
    launch counts of each path."""
    t0 = time.perf_counter()
    say("[18] training through the fused RMSNorm and the SSD scan")
    counts = {}
    for arch in ("mamba2_130m", "mistral_nemo_12b"):
        say(f"    [18a] {GRAD_LAYERS}-layer {arch} at full width, {GRAD_BATCH} x "
            f"{TRAIN_SEQ}, kernels vs plain routes: {check_rmsnorm_grads(torch, kernels, arch)}")
    for arch in RMSNORM_ARCHS:
        say(f"    [18a] SMOKE {arch}, one step card vs CPU: "
            f"{check_smoke_training(torch, arch, steps=1)}")
    counts["mamba2_130m_train"] = check_mamba2_training(torch, kernels)
    counts["mistral_nemo_12b_train"] = check_mistral_training(torch, kernels)
    say(f"    phase 18 in {time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------- phases 22-25: the kernels' contract ----------
#: the SMOKE configs whose head dim is 16
HD16_ARCHS = ("minitron_4b", "command_r_35b", "gpt3_175b", "qwen3_moe_235b")
#: the float32 SMOKE train steps: an RMSNorm config and a LayerNorm one (at
#: hd 32 and 16)
F32_TRAIN_ARCHS = ("mistral_nemo_12b", "minitron_4b")
F32_TRAIN_STEPS = 3
#: the float32 olmo_1b run: 4 x 2048 tokens, 3 steps
F32_RUN_STEPS = 3


def path_counts(kernels) -> dict[str, int]:
    """Every wrapper's launches since the reset, and each instantiation's
    (``kernels.launches_by_kind``)."""
    return kernels.launches() | kernels.launches_by_kind()


def phase22_hd16(torch, kernels) -> dict[str, int]:
    """Phase 22: head dim 16 in bf16. ``run_serve`` on the SMOKE config of
    each of HD16_ARCHS, 4 x 2048 + 32 tokens, counters zeroed just before
    and read just after (flash and decode at bf16/hd16 on every attention
    layer), its graph tokens against eager ones, the SMOKE config card vs
    CPU at 2e-2; then qwen3_moe_235b's SMOKE config trains 3 steps at its
    own hd 16, card vs CPU. Returns the launch counts of the runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve

    t0 = time.perf_counter()
    say(f"[22] head dim 16 (bf16): run_serve on the SMOKE configs of {HD16_ARCHS}, "
        f"{REQUESTS} x {PROMPT_LEN} + {NEW_TOKENS}, then qwen3_moe_235b SMOKE trains")
    runs = []
    for arch in HD16_ARCHS:
        cfg = get_config(arch, smoke=True)
        kernels.reset_launches()
        res = run_serve(cfg, requests=REQUESTS, prompt_len=PROMPT_LEN,
                        tokens=NEW_TOKENS, seed=SEED)
        counts = path_counts(kernels)
        want = {"flash_attention": cfg.n_layers,
                "flash_attention[bf16/hd16]": cfg.n_layers,
                "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
                "decode_attention[bf16/hd16]": cfg.n_layers * (NEW_TOKENS - 1)}
        got = {k: counts.get(k, 0) for k in want}
        say(f"    {cfg.name} (hd {cfg.hd}, {cfg.n_heads}/{cfg.n_kv_heads} heads): TTFT "
            f"{res.ttft * 1e3:.3f} ms, TPOT {res.tpot * 1e3:.4f} ms; launches {got}")
        if got != want:
            raise AssertionError(f"{cfg.name}: launches {got} != {want}")
        params, prompts = serve_inputs(torch, cfg, REQUESTS, SEED)
        gve = graph_vs_eager(torch, cfg, params, prompts, res.tokens)
        gve.pop("tokens")
        del params
        say(f"    graph vs eager decode: {json.dumps(gve)}")
        say(f"    small config, card vs CPU plain: {check_small_model(torch, arch)}")
        runs.append(counts)
    kernels.reset_launches()
    say(f"    qwen3_moe_235b SMOKE at hd 16, 3 steps, card vs CPU: "
        f"{check_smoke_training(torch, 'qwen3_moe_235b')}")
    counts = path_counts(kernels)
    ran = {k: counts.get(k, 0) for k in ("flash_attention_fwd_lse[bf16/hd16]",
                                          "flash_attention_bwd_dkv[bf16/hd16]",
                                          "flash_attention_bwd_dq[bf16/hd16]")}
    say(f"    training launches at hd 16: {ran}")
    if not all(ran.values()):
        raise AssertionError(f"qwen3_moe_235b SMOKE training at hd 16: launches {ran}")
    runs.append(counts)
    say(f"    phase 22 in {time.perf_counter() - t0:.1f} s")
    return summed(*runs)


def phase23_f32_smoke(torch, kernels) -> dict[str, int]:
    """Phase 23: every architecture's SMOKE config in float32 on the card
    against the CPU (:func:`check_small_model`: prefill and 4
    teacher-forced decode steps), then F32_TRAIN_STEPS train steps of each
    of F32_TRAIN_ARCHS in float32 card vs CPU; counters zeroed just before
    and read just after. Returns the launch counts."""
    from repro_torch.configs import ARCH_IDS, get_config

    t0 = time.perf_counter()
    say("[23] float32 SMOKE configs, card vs CPU: prefill logits and the prefill's "
        f"f32 cache within {F32_PREFILL_TOL} (bf16 cache {BF16_CACHE_TOL}), decode "
        f"logits within {F32_DECODE_TOL}, the final cache {F32_FINAL_CACHE_TOL} (bf16 "
        f"{BF16_FINAL_CACHE_TOL}); train steps of {F32_TRAIN_ARCHS}")
    kernels.reset_launches()
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        say(f"    {cfg.name} float32 (hd {cfg.hd}): "
            f"{json.dumps(check_small_model(torch, arch, dtype='float32'))}")
    for arch in F32_TRAIN_ARCHS:
        say(f"    {arch} SMOKE float32, {F32_TRAIN_STEPS} steps, card vs CPU: "
            f"{check_smoke_training(torch, arch, F32_TRAIN_STEPS, dtype='float32')}")
    counts = path_counts(kernels)
    say(f"    launches by instantiation {kernels.launches_by_kind()}")
    say(f"    phase 23 in {time.perf_counter() - t0:.1f} s")
    return counts


@contextlib.contextmanager
def plain_serving_routes():
    """The model's attention and fused RMSNorm through their plain versions
    on the card (phase 24's comparison route)."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
    from repro_torch.models import layers, transformer

    saved = (layers.flash_attention, layers.decode_attention, layers.fused_rmsnorm,
             transformer.fused_rmsnorm)
    layers.flash_attention = flash_attention_ref
    layers.decode_attention = decode_attention_ref
    layers.fused_rmsnorm = transformer.fused_rmsnorm = fused_rmsnorm_ref
    try:
        yield
    finally:
        (layers.flash_attention, layers.decode_attention, layers.fused_rmsnorm,
         transformer.fused_rmsnorm) = saved


def phase24_f32_serving(torch, kernels) -> dict[str, int]:
    """Phase 24: ``run_serve`` on mistral_nemo_12b in float32 at full width
    and depth, F32_REQUESTS x 2048 + 32 tokens, counters zeroed just before
    and read just after (rows 1-3 in float32: rmsnorm, flash and decode at
    f32/hd128, the decode reading the model's bf16 K/V cache); its graph
    tokens identical to eager ``decode_step``; the decode path's logits
    against a teacher-forced forward within 1e-4 of the largest logit, or
    within SSM_REL times the same reading on the plain route on the card
    where that is higher (the cache rounds K/V to bf16 where the forward
    attends in f32). Returns the launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serve

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("mistral_nemo_12b"), dtype="float32")
    say(f"[24] run_serve {cfg.name} in float32: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {F32_REQUESTS} requests x {PROMPT_LEN} + {NEW_TOKENS} tokens")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = run_serve(cfg, requests=F32_REQUESTS, prompt_len=PROMPT_LEN,
                    tokens=NEW_TOKENS, seed=SEED)
    counts = path_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention[f32/hd128]": cfg.n_layers,
            "decode_attention[f32/hd128]": cfg.n_layers * (NEW_TOKENS - 1),
            "rmsnorm[f32]": (1 + 2 * cfg.n_layers) * NEW_TOKENS}
    got = {k: counts.get(k, 0) for k in want}
    say(f"    TTFT {res.ttft * 1e3:.3f} ms, TPOT {res.tpot * 1e3:.4f} ms, "
        f"{res.tokens_per_s:.2f} tokens/s, peak memory {peak / 2**30:.3f} GiB; "
        f"launches {got}")
    if got != want:
        raise AssertionError(f"float32 serving: launches {got} != {want}")
    torch.cuda.empty_cache()
    params, prompts = serve_inputs(torch, cfg, F32_REQUESTS, SEED)
    gve = graph_vs_eager(torch, cfg, params, prompts, res.tokens)
    gve.pop("tokens")
    say(f"    graph vs eager decode: {json.dumps(gve)}")
    kernel_route = full_model_readings(torch, cfg, params, prompts, res.tokens)
    with plain_serving_routes():
        plain_route = full_model_readings(torch, cfg, params, prompts, res.tokens)
    del params
    torch.cuda.empty_cache()
    limit = max(1e-4, SSM_REL * plain_route["decode_vs_prefill_scaled_err"])
    out = {"kernel_route": kernel_route, "plain_route": plain_route, "limit": limit,
           "ttft_s": res.ttft, "tpot_s": res.tpot, "peak_memory_gib": peak / 2**30}
    say(f"    decode vs teacher-forced forward: {json.dumps(out)}")
    if not kernel_route["decode_vs_prefill_scaled_err"] <= limit:
        raise AssertionError(f"float32 serving: decode vs prefill {kernel_route} "
                             f"beyond {limit:.3g}")
    say(f"    phase 24 in {time.perf_counter() - t0:.1f} s")
    return counts


def phase25_f32_training(torch, kernels) -> dict[str, int]:
    """Phase 25: ``run_train`` on olmo_1b in float32 at full width and
    depth, F32_TRAIN_BATCH x 2048 tokens, F32_RUN_STEPS steps on one
    repeated batch, counters zeroed just before and read just after (rows
    5-7 in float32 at hd 128: 2L forward-with-LSE, L dK/dV and L dQ
    launches a step under remat "full"); a finite loss that starts near
    ln V + 1/2 and falls; step time and peak memory. Returns the counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_train

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmo_1b"), dtype="float32")
    say(f"[25] run_train {cfg.name} in float32: {cfg.n_layers} layers, "
        f"{F32_RUN_STEPS} steps x {F32_TRAIN_BATCH} x {TRAIN_SEQ} tokens on one "
        f"repeated batch, seed {SEED}, remat {cfg.remat}")
    torch.cuda.empty_cache()
    kernels.reset_launches()
    res = run_train(cfg, steps=F32_RUN_STEPS, batch=F32_TRAIN_BATCH, seq=TRAIN_SEQ,
                    seed=SEED, repeat=True)
    counts = path_counts(kernels)
    n = cfg.n_layers * F32_RUN_STEPS
    want = {"flash_attention_fwd_lse[f32/hd128]": 2 * n,
            "flash_attention_bwd_dkv[f32/hd128]": n, "flash_attention_bwd_dq[f32/hd128]": n}
    got = {k: counts.get(k, 0) for k in want}
    say(f"    losses {res.losses}; step times (s) {res.step_times}; "
        f"{res.tokens_per_s:.1f} tokens/s; peak memory "
        f"{res.peak_memory_bytes / 2**30:.3f} GiB; launches {got}")
    if got != want:
        raise AssertionError(f"float32 training: launches {got} != {want}")
    expect = math.log(cfg.vocab) + 0.5
    falling_loss(res.losses, "float32 training")
    if not abs(res.losses[0] - expect) <= 0.5:
        raise AssertionError(f"float32 training: first loss {res.losses[0]} not near "
                             f"{expect:.3f}")
    torch.cuda.empty_cache()
    say(f"    phase 25 in {time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------- phases 26-27 ---------------------------------
def phase26_command_r(torch, kernels) -> tuple[dict[str, int], dict]:
    """Phases 26-27: ``run_serve`` on command_r_35b whole, as phases 5-6
    (:func:`check_serving`): 40 layers at full width, 64/8 heads at hd 128
    (GQA group 8), LayerNorm as plain code, 60.3 GiB of bf16 weights, so
    flash attention L launches a prefill, decode attention L a step, and no
    other kernel. The allocator is emptied first and its free memory
    printed; the peak allocated over both phases must stay below the card's
    memory. Printed beside the measured TTFT and TPOT: their floors, the
    prefill's FLOPs over the bf16 peak (the projections, the head over every
    position and causal attention) and a decode step's bytes over HBM's
    rate (the weights, and the weights with the cache at the last step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("command_r_35b")
    n, hd = cfg.n_layers, cfg.hd
    weights = sum(t.numel() * t.element_size()
                  for t in _leaves(init_params(cfg, device="meta")))
    shown = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
             "norm", "gated", "rope_theta", "tie_embeddings")
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"[26] command_r_35b whole on one card: "
        f"{json.dumps({k: getattr(cfg, k) for k in shown})}, nothing cut; "
        f"weights {weights / 2**30:.3f} GiB; the card's free memory "
        f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB")
    t0 = time.perf_counter()
    counts, measured = check_serving(torch, kernels, "command_r_35b", REQUESTS, {
        "flash_attention": n, "decode_attention": n * (NEW_TOKENS - 1)},
        phase=26)
    peak = torch.cuda.max_memory_allocated()
    tokens = REQUESTS * PROMPT_LEN
    flops = (2 * (cfg.param_count() - cfg.vocab * cfg.d_model) * tokens
             + n * 2 * REQUESTS * cfg.n_heads * PROMPT_LEN ** 2 * hd)
    cache = (2 * n * REQUESTS * (PROMPT_LEN + NEW_TOKENS - 1) * cfg.n_kv_heads
             * hd * 2)
    out = {"peak_allocated_gib": peak / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
           "card_gib": total / 2**30,
           "ttft_floor_ms": flops / BF16_FLOP_PER_S * 1e3,
           "warm_ttft_ms": measured["warm_ttft"] * 1e3,
           "tpot_weight_floor_ms": weights / HBM_BYTES_PER_S * 1e3,
           "tpot_floor_with_cache_ms": (weights + cache) / HBM_BYTES_PER_S * 1e3,
           "cold_tpot_ms": measured["cold_tpot"] * 1e3,
           "warm_tpot_ms": measured["warm_tpot"] * 1e3,
           "steady_tpot_ms": measured["tpot"] * 1e3}
    say(f"    phases 26-27: {json.dumps(out)}; {time.perf_counter() - t0:.1f} s")
    if not peak < total:
        raise AssertionError(f"command_r_35b: peak {peak / 2**30:.3f} GiB is not "
                             f"below the card's {total / 2**30:.3f} GiB")
    return counts, measured


# ------------------------------- phases 12-13 ---------------------------------
def check_validation(card: str) -> dict:
    """Phase 12: the modeled-vs-measured loop on the card. Calibrates the
    card (the reference's host-clock protocol, CUDA events beside it),
    builds the three cases (each certifies its twin), predicts each at the
    calibrated rates, counts its decode step on the kernels' route (the moe
    twin's hd 16 among them) and times its steady decode; every case must
    have its wall clock; gates every row with the reference's bands and
    writes BENCH_validation_torch.json (with the card's name and power
    limit). Fatal on any band violation."""
    from repro_torch.systems.chips import H100, HBM
    from repro_torch.validation import (REPORT_PATH, check_report,
                                        measure_cases, write_report)

    report = measure_cases(log=say)
    cal = report["calibration"]
    say(f"    catalog H100 (systems/chips.py): {H100.peak_flops / 1e12:.4g} "
        f"TFLOP/s, HBM {HBM.bandwidth / 1e9:.6g} GB/s; calibrated / catalog: "
        f"{cal['flop_rate'] / H100.peak_flops:.4f} (events "
        f"{cal['event_flop_rate'] / H100.peak_flops:.4f}), "
        f"{cal['mem_bw'] / HBM.bandwidth:.4f} (events "
        f"{cal['event_mem_bw'] / HBM.bandwidth:.4f})")
    for row in report["cases"]:
        r, dry = row["ratios"], row["dryrun"]
        line = (f"    {row['case']}: dry run on the {dry['route']} route "
                f"({dry['aten_ops']} aten ops, kernel launches "
                f"{dry['kernel_launches']}): flops {dry['flops']:.6g} "
                f"(x{r['flops']:.4f} predicted), bytes {dry['bytes']:.6g} "
                f"(x{r['bytes']:.4f}), collective {dry['collective_bytes']:g}")
        if "wallclock" in row:
            w = row["wallclock"]
            line += (f"; TPOT {w['tpot'] * 1e3:.5f} ms (trimmed mean of "
                     f"{w['repeats']}, min {w['step_time_min'] * 1e3:.5f}, max "
                     f"{w['step_time_max'] * 1e3:.5f}), predicted "
                     f"{row['predicted']['step_time'] * 1e3:.5f} ms "
                     f"(x{r['step_time']:.4f}), compute term "
                     f"x{r['compute_term']:.4f}, hybrid "
                     f"{row['hybrid_step_time'] * 1e3:.5f} ms "
                     f"(x{r['hybrid']:.4f}){' [gated]' if row['wall_gate'] else ''}")
        else:
            line += f"; no wall clock: {row['wallclock_absent']}"
        say(line)
    name, limit = (x.strip() for x in card.rsplit(",", 1))
    report["device"] = {"name": name, "power_limit": limit}
    write_report(report)
    say(f"    wrote {REPORT_PATH.name}")
    problems = check_report(report) + [
        f"{row['case']}: no wall clock ({row.get('wallclock_absent')})"
        for row in report["cases"] if "wallclock" not in row]
    if problems:
        raise AssertionError(f"validation bands broken: {problems}")
    return report


def serving_model_reading(measured: dict) -> dict:
    """Phase 13 (a reading, no gate): the paper's serving model (§VIII.A,
    ``serving_sweep``) for each served config on a one-chip system of the
    catalog H100 and HBM, at the served shape (REQUESTS x PROMPT_LEN
    prefill, decode at kv_len PROMPT_LEN + NEW_TOKENS; a MoE decode prices
    every expert, as ``moe_dense`` runs them), beside the warm TTFT and
    the steady TPOT measured in its serving phase. The model prices a layer
    and checks no capacity, so beside it the bytes the served model keeps
    resident (bf16 weights, the K/V cache of its attention layers at the
    serving length) and the catalog memory's capacity."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import serving_sweep
    from repro_torch.systems.chips import H100, HBM, NVLINK
    from repro_torch.systems.system import SystemSpec
    from repro_torch.systems.topology import ring
    from repro_torch.workloads.llm import decode_layer_graph, gpt_layer_graph
    from repro_torch.workloads.scenarios import _shape_from_config

    system = SystemSpec("h100x1", H100, HBM, ring(1, NVLINK))
    out = {}
    for arch, got in measured.items():
        cfg = get_config(arch)
        shape = dataclasses.replace(_shape_from_config(cfg), seq=PROMPT_LEN,
                                    batch=REQUESTS)
        dec = dataclasses.replace(shape, seq=1)
        if cfg.moe_experts:
            dec = dataclasses.replace(dec, moe_top_k=cfg.moe_experts)
        (pt,) = serving_sweep(gpt_layer_graph(shape),
                              decode_layer_graph(dec, kv_len=PROMPT_LEN + NEW_TOKENS),
                              n_layers=cfg.n_layers, system=system,
                              batch=REQUESTS)
        resident = 2 * cfg.param_count() + (
            4 * cfg.n_layers * REQUESTS * (PROMPT_LEN + NEW_TOKENS + 1)
            * cfg.n_kv_heads * cfg.hd)
        out[arch] = {"resident_gb": resident / 1e9,
                     "catalog_capacity_gb": system.memory.capacity / 1e9,
                     "modeled_ttft_ms": pt.ttft * 1e3,
                     "measured_warm_ttft_ms": got["warm_ttft"] * 1e3,
                     "ttft_modeled_over_measured": pt.ttft / got["warm_ttft"],
                     "modeled_tpot_ms": pt.tpot * 1e3,
                     "measured_tpot_ms": got["tpot"] * 1e3,
                     "tpot_modeled_over_measured": pt.tpot / got["tpot"],
                     "breakdown_prefill": pt.breakdown_prefill,
                     "breakdown_decode": pt.breakdown_decode}
        say(f"    {arch}: {json.dumps(out[arch])}")
    return out


# ------------------------------- main -----------------------------------------
# ------------------------------- phase 20: the multi-device layer ------------
#: each of phase 20's child runs is killed past this many seconds (a hung
#: collective fails the phase)
PHASE20_TIMEOUT_S = 240
#: a collective of phase 20's children that waits longer than this raises
#: (NCCL's watchdog names it), and each child prints every thread's stack
#: this long before its kill
PHASE20_PG_TIMEOUT_S, PHASE20_STACKS_BEFORE_S = 150, 20
#: (a) olmo_1b steps with and without the (1, 1) mesh
MESH_TRAIN_STEPS = 4
#: (a) then olmo_1b served, 2 requests of this many tokens + new tokens
MESH_SERVE_PROMPT, MESH_SERVE_TOKENS = 512, 8
#: (b) olmoe_1b_7b on two gloo ranks: new tokens a request, and the short
#: request's prompt (rank 1's block of the cache, positions 1032 on, stays
#: empty for all of its steps)
CP_NEW_TOKENS, CP_SHORT_PROMPT = 16, 64
#: (b) olmoe_1b_7b at full width, its depth cut from 16 to this many
#: layers to hold the run under RUN_LIMIT_S (4 until the run's total read
#: 653.1 s, over the limit)
CP_LAYERS = 2
#: (c) olmo_1b at full width with this many layers, 2 x 2048 a rank
DP_LAYERS, DP_BATCH_PER_RANK = 2, 2
#: a gradient through int8 and back moves by at most half its block's step,
#: max |block| / 254, on each rank, and the step averages the two ranks':
#: at most 1/254 of a rank's largest value, held here as 1/127 of the
#: averaged gradient's largest (a rank's largest value at most twice it)
INT8_SCALED = 1.0 / 127


def phase20_cfg(part: str):
    import dataclasses

    from repro_torch.configs import get_config
    if part == "olmoe":
        return dataclasses.replace(get_config("olmoe_1b_7b"), moe_dispatch="shard_map",
                                   decode_attn="context_parallel", n_layers=CP_LAYERS)
    if part == "dp":
        return dataclasses.replace(get_config("olmo_1b"), n_layers=DP_LAYERS)
    return get_config("olmo_1b")


def phase20_join(job_dir: Path, part: str, rank: int, world: int, backend: str):
    """Join part ``part``'s process group through a FileStore of its own
    under ``job_dir``; returns this rank's card (card ``rank`` modulo the
    cards present: over gloo two ranks may share one)."""
    from repro_torch.launch.mesh import init_ranks
    return init_ranks("cuda", backend=backend, rank=rank, world_size=world,
                      init_method=f"file://{job_dir / f'store-{part}'}",
                      timeout=PHASE20_PG_TIMEOUT_S)


def phase20_progress(part: str, rank: int):
    """A function that prints one progress line of child ``part`` / ``rank``
    with the seconds since it was made (the child's output is unbuffered,
    so a killed child's log ends at its last line)."""
    t0 = time.perf_counter()

    def line(msg: str) -> None:
        say(f"[{part} rank {rank} {time.perf_counter() - t0:7.1f} s] {msg}")

    return line


def phase20_write(job_dir: Path, name: str, out: dict) -> None:
    (job_dir / f"{name}.json").write_text(json.dumps(out))


def mesh_train_one_rank(torch, job_dir: Path) -> None:
    """(a) run_train on the full olmo_1b, 8 x 2048, MESH_TRAIN_STEPS steps on
    one repeated batch: without a mesh, then on one NCCL rank with the
    (1, 1) mesh and FSDP (the sharded step at mesh size 1), counters
    zeroed just before and read just after. The mesh run's losses within
    1e-3 of the other's (relative: the global norm sums in another
    order), both finite and starting where phase 8's do. Then the engine
    without a mesh and on the (1, 1) mesh: each captures its decode step
    once (no collective spans two ranks), and the mesh engine's logits
    are held against the other's to its first token difference."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_axis_rules, parse_mesh
    from repro_torch.launch.train import run_train
    from repro_torch.models import init_params
    from repro_torch.parallel.logical import use_rules
    from repro_torch.serve import ServeEngine

    dev = phase20_join(job_dir, "a", 0, 1, "nccl")
    cfg = phase20_cfg("train")
    kw = dict(steps=MESH_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED,
              repeat=True, device=dev)
    base = run_train(cfg, **kw)
    torch.cuda.empty_cache()
    mesh = parse_mesh("1x1", dev)
    kernels.reset_launches()
    res = run_train(cfg, mesh=mesh, fsdp=True, **kw)
    counts = kernels.launches()
    n = cfg.n_layers * MESH_TRAIN_STEPS
    want = {**dict.fromkeys(counts, 0), "flash_attention_fwd_lse": 2 * n,
            "flash_attention_bwd_dkv": n, "flash_attention_bwd_dq": n}
    if counts != want:
        raise AssertionError(f"(a) launch counts {counts} != {want}")
    # phase 8's bound on its first step; four steps from this seed climb
    # at the fourth before they fall (phase 8 reads eight)
    expect = math.log(cfg.vocab) + 0.5
    for r in (base, res):
        if not (all(math.isfinite(x) for x in r.losses)
                and abs(r.losses[0] - expect) <= 0.5):
            raise AssertionError(f"(a) losses {r.losses} (step 0 should be near "
                                 f"{expect:.3f})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(res.losses, base.losses))
    if rel > 1e-3:
        raise AssertionError(f"(a) mesh losses {res.losses} vs {base.losses}")
    out = {"launches": counts, "loss_rel_diff": rel}
    for name, r in (("no_mesh", base), ("mesh_1x1_fsdp", res)):
        out[name] = {"losses": r.losses, "step_times_s": r.step_times,
                     "steady_mean_s": sum(r.step_times[1:]) / len(r.step_times[1:]),
                     "tokens_per_s": r.tokens_per_s,
                     "peak_memory_gib": (r.peak_memory_bytes or 0) / 2**30}
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (2, MESH_SERVE_PROMPT), generator=gen,
                            device=dev)
    served = {}
    for name, rules in (("no_mesh", None), ("mesh_1x1", make_axis_rules(mesh, cfg))):
        sampled = []
        with (use_rules(rules, mesh) if rules else contextlib.nullcontext()), \
                sampled_logits(sampled):
            engine = ServeEngine(cfg, params, max_batch=2, device=dev,
                                 max_len=MESH_SERVE_PROMPT + MESH_SERVE_TOKENS)
            r = engine.generate(prompts, n_tokens=MESH_SERVE_TOKENS)
        served[name] = (torch.tensor(r.tokens).t(),
                        torch.stack([lg for lg, _ in sampled], 1).cpu(), engine.captures)
    (t_mesh, lg_mesh, cap_mesh), (t_one, lg_one, cap_one) = served["mesh_1x1"], served["no_mesh"]
    out["serve"] = {**held_engine_steps(t_mesh, t_one, lg_mesh, lg_one),
                    "captures": [cap_one, cap_mesh]}
    if not (cap_one == cap_mesh == 1
            and out["serve"]["engine_scaled_err"] <= SCALED_TOL_SMALL):
        raise AssertionError(f"(a) the engine on the (1, 1) mesh {out['serve']}")
    phase20_write(job_dir, "a", out)
    dist.destroy_process_group()


def eager_serve(torch, kernels, cfg, params, prompts, feed, max_len: int) -> dict:
    """Prefill, then len(feed) - 1 eager decode steps fed ``feed`` (a list
    of (B,) token tensors, the first the prefill's): the logits of the
    prefill's last position and of every step, whole over the vocabulary,
    f32 on the CPU (B, steps, V), and the decode kernel's launches in each
    step."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.transformer import gather_vocab

    s = prompts.shape[1]
    per_step = []
    with torch.no_grad():
        logits, cache = prefill(cfg, params, prompts, max_len=max_len)
        outs = [gather_vocab(cfg, logits[:, -1]).float().cpu()]
        for i, tok in enumerate(feed[:-1]):
            before = kernels.launches()["decode_attention"]
            lg, cache = decode_step(cfg, params, cache, tok, s + i)
            outs.append(gather_vocab(cfg, lg).float().cpu())
            per_step.append(kernels.launches()["decode_attention"] - before)
    return {"logits": torch.stack(outs, 1), "per_step": per_step}


def olmoe_requests(torch, cfg, dev):
    """phase 20(b)'s prompts: REQUESTS x PROMPT_LEN from the serving seed,
    and the first one cut to CP_SHORT_PROMPT tokens."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN), generator=gen,
                            device=dev)
    return prompts, prompts[:1, :CP_SHORT_PROMPT].clone()


def olmoe_single(torch, job_dir: Path) -> None:
    """(b), the single-device side: olmoe_1b_7b through the engine (CUDA
    graph) for its TTFT and TPOT and greedy tokens, then eager steps fed
    those tokens with the routes recorded; the short request alike."""
    from repro_torch import kernels
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = phase20_cfg("olmoe")
    dev = torch.device("cuda")
    params = init_params(cfg, seed=SEED, device=dev)
    prompts, short = olmoe_requests(torch, cfg, dev)
    max_len = PROMPT_LEN + CP_NEW_TOKENS
    engine = ServeEngine(cfg, params, max_batch=REQUESTS, max_len=max_len,
                         device=dev)
    engine.generate(prompts, n_tokens=CP_NEW_TOKENS)
    warm = engine.generate(prompts, n_tokens=CP_NEW_TOKENS)
    short_res = engine.generate(short, n_tokens=CP_NEW_TOKENS)
    arrays, out = {}, {"ttft_s": warm.ttft, "tpot_s": warm.tpot}
    for name, p, res in (("long", prompts, warm), ("short", short, short_res)):
        feed = [torch.tensor(t, device=dev) for t in res.tokens]
        routes = []
        with recorded_routes(routes):
            run = eager_serve(torch, kernels, cfg, params, p, feed, max_len)
        arrays[f"{name}/tokens"] = torch.tensor(res.tokens).numpy()
        arrays[f"{name}/logits"] = run["logits"].numpy()
        for i, r in enumerate(routes):
            arrays[f"{name}/route{i}"] = r.numpy()
        out[f"{name}_routes"] = len(routes)
    import numpy as np
    np.savez(job_dir / "b_single.npz", **arrays)
    phase20_write(job_dir, "b_single", out)


def device_route_replay(torch, routes: list, rows: int):
    """:func:`replayed_routes` for a serving engine, whose decode step a CUDA
    graph may capture. ``routes`` on the device, a prefill's calls then one
    pass of calls a decode step: the prefill's calls (any token count but
    ``rows``) take theirs in call order from the host, the decode steps'
    calls (``rows`` tokens) theirs from a table on the device at a counter
    the step itself advances, so that a replayed graph reads the next
    step's. Returns a context manager; each entry starts again from the
    first call, with the same table and counter."""
    from repro_torch.models import layers

    prefill = [r for r in routes if r.shape[0] != rows]
    table = torch.stack([r for r in routes if r.shape[0] == rows])
    at = torch.zeros(1, dtype=torch.int64, device=table.device)

    @contextlib.contextmanager
    def run():
        route, calls = layers._route, iter(prefill)
        at.zero_()

        def replaying(p, xt, k):
            probs, _, _ = route(p, xt, k)
            if xt.shape[0] == rows:
                idx = table.index_select(0, at)[0]
                at.add_(1)
            else:
                idx = next(calls)
            gates = probs.gather(1, idx)
            return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx

        layers._route = replaying
        try:
            yield
        finally:
            layers._route = route

    return run


@contextlib.contextmanager
def sampled_logits(store: list):
    """The whole-vocabulary logits the engine samples each token from (f32,
    on the device), each with the decode kernel's launch count when the
    engine read them, in the order of the samples drawn inside the block."""
    from repro_torch import kernels
    from repro_torch.serve import engine

    gather = engine.gather_vocab

    def recording(cfg, logits):
        out = gather(cfg, logits)
        store.append((out.float(), kernels.launches()["decode_attention"]))
        return out

    engine.gather_vocab = recording
    try:
        yield
    finally:
        engine.gather_vocab = gather


def olmoe_rank(torch, job_dir: Path, rank: int, world: int, backend: str) -> None:
    """(b), one of two ranks, mesh (1, 2): each rank holds 32 experts, 8 of
    the 16 heads, half the vocabulary and the half of the cache's sequence
    that is its block. Every run routes each token to the experts the
    single-device run chose (:func:`device_route_replay`), so the two
    compute the same function: eager steps fed the single-device tokens,
    then the engine's generate twice, the second timed and read (its
    tokens, the logits it sampled them from, the decode kernel's launches
    in each step; counters zeroed just before and read just after); the
    short request alike. Over gloo (two ranks sharing the card) the engine
    decodes eagerly; over NCCL (a card a rank) it captures the step."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_axis_rules, parse_mesh
    from repro_torch.launch.shardings import param_shardings, shard_tree
    from repro_torch.models import init_params
    from repro_torch.parallel.logical import use_rules
    from repro_torch.serve import ServeEngine

    step = phase20_progress("b", rank)
    dev = phase20_join(job_dir, "b", rank, world, backend)
    step(f"joined over {backend} on {dev}")
    cfg = phase20_cfg("olmoe")
    mesh = parse_mesh(f"1x{world}", dev)
    step(f"{mesh}")
    with np.load(job_dir / "b_single.npz") as data:
        single = {k: data[k] for k in data.files}
    max_len = PROMPT_LEN + CP_NEW_TOKENS
    out: dict = {"rank": rank}
    arrays: dict = {}
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        for r in range(world):          # one rank at a time holds the whole
            if r == rank:
                full = init_params(cfg, seed=SEED, device=dev)
                params = shard_tree(full, param_shardings(cfg, mesh), mesh, copy=True)
                del full
                torch.cuda.empty_cache()
            dist.barrier()
        step("parameters sharded")
        out["local_params"] = sum(t.numel() for t in _leaves(params))
        out["local_experts"] = params["stack"][0]["l0"]["moe"]["wi"].shape[0]
        out["local_heads"] = params["stack"][0]["l0"]["attn"]["wq"].shape[1] // cfg.hd
        prompts, short = olmoe_requests(torch, cfg, dev)
        engine = ServeEngine(cfg, params, max_batch=REQUESTS, max_len=max_len,
                             device=dev)
        for name, p in (("long", prompts), ("short", short)):
            feed = [torch.from_numpy(t).to(dev) for t in single[f"{name}/tokens"]]
            n = sum(1 for k in single if k.startswith(f"{name}/route"))
            replay = device_route_replay(
                torch, [torch.from_numpy(single[f"{name}/route{i}"]).to(dev)
                        for i in range(n)], p.shape[0])
            step(f"{name}: eager steps")
            with replay():
                rep = eager_serve(torch, kernels, cfg, params, p, feed, max_len)
            arrays[f"{name}/replayed"] = rep["logits"].numpy()
            step(f"{name}: the engine's first run")
            with replay():              # the batch size's first run (a capture)
                engine.generate(p, n_tokens=CP_NEW_TOKENS)
            step(f"{name}: the engine's second run, {engine.captures} captured")
            sampled = []
            kernels.reset_launches()
            with replay(), sampled_logits(sampled):
                res = engine.generate(p, n_tokens=CP_NEW_TOKENS)
            step(f"{name}: done")
            out[name] = {"launches": kernels.launches(), "ttft_s": res.ttft,
                         "tpot_s": res.tpot, "tokens": res.tokens,
                         "per_step": [b - a for (_, a), (_, b) in zip(sampled, sampled[1:])]}
            arrays[f"{name}/engine"] = torch.stack([lg for lg, _ in sampled], 1).cpu().numpy()
        out["captures"] = engine.captures
        engine.close()
    if rank == 0:
        np.savez(job_dir / "b_ranks.npz", **arrays)
    phase20_write(job_dir, f"b_rank{rank}", out)
    dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)


@contextlib.contextmanager
def captured_grads(store: list):
    """The gradients each train step hands AdamW (reduced over the data
    axes, through int8 where compressed, this rank's block under FSDP), for
    phase 20(c)'s comparison."""
    from repro_torch.train import trainer

    update = trainer.adamw_update

    def capturing(params, grads, *args, **kw):
        store.append(grads)
        return update(params, grads, *args, **kw)

    trainer.adamw_update = capturing
    try:
        yield
    finally:
        trainer.adamw_update = update


#: (c)'s runs on the mesh: (name, compress_dp_grads, fsdp)
DP_RUNS = (("plain", False, False), ("compressed", True, False), ("fsdp", False, True))


def dp_train_rank(torch, job_dir: Path, rank: int, world: int, backend: str) -> None:
    """(c), one of two ranks, mesh (2, 1): olmo_1b at full width with
    DP_LAYERS layers on this rank's DP_BATCH_PER_RANK x TRAIN_SEQ rows of
    the global batch, each of DP_RUNS (plain, compressed gradients, FSDP);
    rank 0 first steps on the whole batch alone. Each run's first step
    gives the gradients the optimizer received, which rank 0 holds (and
    the loss) against the one-process step's (its block of them under
    FSDP); its second step is timed (the first pays the process's first
    launches)."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.device import synchronize
    from repro_torch.launch.mesh import make_axis_rules, parse_mesh
    from repro_torch.launch.shardings import param_shardings, shard_tree
    from repro_torch.models import init_params, param_dtype
    from repro_torch.parallel.logical import use_rules
    from repro_torch.train import (AdamWConfig, SyntheticTokens, adamw_init,
                                   make_train_step)

    dev = phase20_join(job_dir, "c", rank, world, backend)
    cfg = phase20_cfg("dp")
    batch = next(iter(SyntheticTokens(cfg.vocab, DP_BATCH_PER_RANK * world, TRAIN_SEQ,
                                      seed=SEED, device=dev)))

    def two_steps(step, params, together: bool):
        """(loss and gradient tree of the first step, seconds of the
        second); ``together``: every rank takes the steps (and starts the
        timed one at a barrier)."""
        opt = adamw_init(params)
        got = []
        with captured_grads(got):
            _, _, m = step(params, opt, batch)
        loss = float(m["loss"])
        if together:
            dist.barrier()
        synchronize(dev)
        t0 = time.perf_counter()
        float(step(params, opt, batch)[2]["loss"])
        return loss, got[0], time.perf_counter() - t0

    out: dict = {"rank": rank}
    if rank == 0:
        params = init_params(cfg, seed=SEED, device=dev, dtype=param_dtype(cfg))
        want_loss, want, out["single_step_s"] = two_steps(
            make_train_step(cfg, AdamWConfig()), params, together=False)
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = parse_mesh(f"{world}x1", dev)
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        for tag, compress, fsdp in DP_RUNS:
            specs = param_shardings(cfg, mesh, fsdp=fsdp)
            full = init_params(cfg, seed=SEED, device=dev, dtype=param_dtype(cfg))
            params = shard_tree(full, specs, mesh, copy=True)
            del full
            step = make_train_step(cfg, AdamWConfig(), compress_dp_grads=compress,
                                   fsdp=fsdp)
            kernels.reset_launches()
            loss, got, dt = two_steps(step, params, together=True)
            out[tag] = {"step_s": dt, "loss": loss, "launches": kernels.launches()}
            if rank == 0:
                errs = [scaled_err(g, w) for g, w in
                        zip(_leaves(got), _leaves(shard_tree(want, specs, mesh)))]
                lim = SCALED_TOL_SMALL + (INT8_SCALED if compress else 0.0)
                out[tag] |= {"loss_rel_diff": abs(loss - want_loss) / abs(want_loss),
                             "grad_scaled_err_max": max(errs), "limit": lim}
                if not (abs(loss - want_loss) <= SCALED_TOL_SMALL * abs(want_loss)
                        and max(errs) <= lim):
                    raise AssertionError(f"(c) {tag}: loss {loss} vs {want_loss}, "
                                         f"gradient scaled errors {max(errs):.3g} > {lim:.3g}")
            del params, got
            torch.cuda.empty_cache()
    phase20_write(job_dir, f"c_rank{rank}", out)
    dist.destroy_process_group()


# ------------------------------- phase 21: the model axis of every layer kind --
#: (arch, requests, prompt length, new tokens): mamba2_130m at full width
#: and depth; llama32_vision_11b and seamless_m4t_medium at full width and
#: depth with a short window, which bounds the host-staged collectives of
#: two gloo ranks sharing the card
MA_SERVE = (("mamba2_130m", 8, 2048, 16), ("llama32_vision_11b", 1, 256, 8),
            ("seamless_m4t_medium", 1, 256, 8))
#: the train step of the model axis: mamba2_130m at full width with this
#: many layers, MA_TRAIN_BATCH x MA_TRAIN_SEQ (the split norm's backward)
MA_TRAIN_LAYERS, MA_TRAIN_BATCH, MA_TRAIN_SEQ = 2, 2, 256
#: mamba2_130m's whole-model readings, two ranks against one device, are
#: held relative to one device's own bf16 noise: its logits through the
#: plain scan (``plain_scan``) against the kernel's, the same reading phase
#: 7 takes; the two ranks at most SSM_REL times that, with a floor of
#: SCALED_TOL_FULL (a reading below the other limits)
MA_SSM_FLOOR = SCALED_TOL_FULL
#: the train step's gradients, two ranks against one device, in bf16: the
#: model axis computes one device's gradients in f32 within 1e-6 of their
#: largest on the CPU (tests/test_torch_model_axis.py); in bf16 each split
#: sum rounds otherwise (the CPU's plain versions read up to 0.017 at 2 x
#: 64 tokens; the H100 read 0.032 at 2 x 256, PERF.md PR 26), so they are
#: held as the logits are: within SSM_REL times one device's plain-scan
#: reading, at least this
MA_GRAD_FLOOR = SCALED_TOL_FULL


def ma_cfg(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch)


def ma_inputs(torch, cfg, requests: int, prompt: int, dev):
    """The prompts and, for a VLM or an encoder-decoder, the memory source
    (image embeddings or audio frames), from the seeds."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (requests, prompt), generator=gen, device=dev)
    src = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        m = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
        src = torch.randn((requests, m, cfg.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
    return prompts, src


def ma_train_cfg():
    import dataclasses
    return dataclasses.replace(ma_cfg("mamba2_130m"), n_layers=MA_TRAIN_LAYERS)


def ma_train_batch(torch, cfg, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    t = torch.randint(0, cfg.vocab, (MA_TRAIN_BATCH, MA_TRAIN_SEQ + 1), generator=gen,
                      device=dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def ma_grads(torch, cfg, params, batch):
    """(loss, gradient of every leaf) of ``loss_fn`` at ``params``."""
    from repro_torch.models import loss_fn
    from repro_torch.train.optimizer import tree_leaves
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


def ma_serve(torch, kernels, cfg, params, requests, prompt, new, dev) -> dict:
    """The engine's generate twice (the first captures or warms), the second
    read: tokens, the logits each was sampled from (f32, on the host), the
    launches (counters zeroed just before), TTFT and TPOT."""
    from repro_torch.models import encode
    from repro_torch.serve import ServeEngine

    prompts, src = ma_inputs(torch, cfg, requests, prompt, dev)
    with torch.no_grad():
        memory = None if src is None else encode(cfg, params, src) if cfg.is_enc_dec else src
        engine = ServeEngine(cfg, params, max_batch=requests, max_len=prompt + new,
                             device=dev)
        engine.generate(prompts, n_tokens=new, memory=memory)
        sampled: list = []
        kernels.reset_launches()
        with sampled_logits(sampled):
            res = engine.generate(prompts, n_tokens=new, memory=memory)
    return {"tokens": torch.tensor(res.tokens).t(),
            "logits": torch.stack([lg for lg, _ in sampled], 1).cpu(),
            "launches": kernels.launches(), "ttft_s": res.ttft, "tpot_s": res.tpot,
            "captures": engine.captures}


def model_axis_single(torch, job_dir: Path) -> None:
    """Phase 21, one device: each MA_SERVE arch through the engine (its
    decode step captured), and mamba2_130m again with the scan through its
    plain version (one device's own bf16 noise); the train step's loss and
    gradients."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import init_params

    dev = torch.device("cuda")
    arrays, out = {}, {}
    for arch, requests, prompt, new in MA_SERVE:
        cfg = ma_cfg(arch)
        params = init_params(cfg, seed=SEED, device=dev)
        r = ma_serve(torch, kernels, cfg, params, requests, prompt, new, dev)
        arrays[f"{arch}/tokens"] = r["tokens"].numpy()
        arrays[f"{arch}/logits"] = r["logits"].numpy()
        out[arch] = {k: r[k] for k in ("launches", "ttft_s", "tpot_s", "captures")}
        if cfg.family == "ssm":
            with plain_scan():
                p = ma_serve(torch, kernels, cfg, params, requests, prompt, new, dev)
            held = held_engine_steps(p["tokens"], r["tokens"], p["logits"], r["logits"])
            out[arch]["plain_scan"] = held
        del params
        torch.cuda.empty_cache()
    cfg = ma_train_cfg()
    params = init_params(cfg, seed=SEED, device=dev, dtype=torch.float32)
    batch = ma_train_batch(torch, cfg, dev)
    loss, grads = ma_grads(torch, cfg, params, batch)
    with plain_scan():          # one device's own bf16 noise: the plain scan
        _, plain = ma_grads(torch, cfg, params, batch)
    out["train_loss"] = loss
    out["train_plain_scan_err"] = max(scaled_err(a, b) for a, b in zip(plain, grads))
    for i, g in enumerate(grads):
        arrays[f"train/grad{i}"] = g.float().cpu().numpy()
    np.savez(job_dir / "ma_single.npz", **arrays)
    phase20_write(job_dir, "ma_single", out)


def model_axis_rank(torch, job_dir: Path, rank: int, world: int, backend: str) -> None:
    """Phase 21, one of two ranks, mesh (1, 2): each MA_SERVE arch made as
    this rank's blocks (``init_local_params``: the Mamba2 layer by heads,
    attention, cross-attention, the encoder and the MLP by Megatron's
    split, the vocabulary in halves), served through the engine (eager over
    gloo); then the train step, its gradients gathered whole."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_axis_rules, parse_mesh
    from repro_torch.launch.shardings import gather_tree, init_local_params, param_shardings
    from repro_torch.parallel.logical import use_rules
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    step = phase20_progress("ma", rank)
    dev = phase20_join(job_dir, "ma", rank, world, backend)
    mesh = parse_mesh(f"1x{world}", dev)
    arrays, out = {}, {"rank": rank}
    for arch, requests, prompt, new in MA_SERVE:
        cfg = ma_cfg(arch)
        with use_rules(make_axis_rules(mesh, cfg), mesh):
            params = init_local_params(cfg, mesh, seed=SEED, device=dev)
            step(f"{arch}: weights made")
            r = ma_serve(torch, kernels, cfg, params, requests, prompt, new, dev)
        step(f"{arch}: served, TTFT {r['ttft_s']:.3f} s, TPOT {r['tpot_s']:.4f} s")
        arrays[f"{arch}/tokens"] = r["tokens"].numpy()
        arrays[f"{arch}/logits"] = r["logits"].numpy()
        out[arch] = {k: r[k] for k in ("launches", "ttft_s", "tpot_s", "captures")}
        out[arch]["local_params"] = sum(t.numel() for t in tree_leaves(params))
        del params
        torch.cuda.empty_cache()
    cfg = ma_train_cfg()
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        specs = param_shardings(cfg, mesh)
        params = init_local_params(cfg, mesh, seed=SEED, device=dev, dtype=torch.float32)
        kernels.reset_launches()
        loss, grads = ma_grads(torch, cfg, params, ma_train_batch(torch, cfg, dev))
        out["train_launches"] = kernels.launches()
        whole = gather_tree(tree_unflatten(params, list(grads)), specs, mesh)
    out["train_loss"] = loss
    for i, g in enumerate(tree_leaves(whole)):
        arrays[f"train/grad{i}"] = g.float().cpu().numpy()
    step("train step done")
    if rank == 0:
        np.savez(job_dir / "ma_ranks.npz", **arrays)
    phase20_write(job_dir, f"ma_rank{rank}", out)
    dist.destroy_process_group()


def phase21(torch, job_dir: Path, card: str) -> tuple[dict, dict]:
    """Phase 21: SSM, cross-attention and encoder layers under a model axis
    on two gloo ranks sharing the card, mesh (1, 2), against one device in
    the same run (its side in this process first, no collective). Holds:
    each arch's engine on the two ranks, per sequence up to its first token
    difference, the sampled logits within SCALED_TOL_FULL of one device's
    (mamba2_130m: within SSM_REL times one device's own plain-scan reading,
    at least MA_SSM_FLOOR); the ranks' tokens alike; the launches: the same
    as one device's but every gated norm a statistic and an apply launch
    of the split-row form; the train step's loss within 1e-3 relative and
    every gradient leaf within SSM_REL times one device's plain-scan
    reading of its largest (at least MA_GRAD_FLOOR), the split norm's
    backward launched. (The model axis computes one device's gradients in
    f32 to 1e-6 on the CPU, ``tests/test_torch_model_axis.py``; in bf16
    the split sums round otherwise.) Returns (launches summed over ranks and runs,
    readings)."""
    import numpy as np

    say(f"[21] every layer kind under a model axis on two gloo ranks sharing the "
        f"card, mesh (1, 2), against one device: "
        + ", ".join(f"{a} {r} x {p} + {n}" for a, r, p, n in MA_SERVE)
        + f"; a {MA_TRAIN_LAYERS}-layer mamba2_130m train step, "
        f"{MA_TRAIN_BATCH} x {MA_TRAIN_SEQ}")
    t0 = time.perf_counter()
    model_axis_single(torch, job_dir)
    torch.cuda.empty_cache()
    run_phase20_part("ma", 2, job_dir, "gloo")
    single = json.loads((job_dir / "ma_single.json").read_text())
    ranks = [json.loads((job_dir / f"ma_rank{r}.json").read_text()) for r in range(2)]
    with np.load(job_dir / "ma_single.npz") as d:
        s_arr = {k: torch.from_numpy(d[k]) for k in d.files}
    with np.load(job_dir / "ma_ranks.npz") as d:
        r_arr = {k: torch.from_numpy(d[k]) for k in d.files}
    readings, counts = {}, []
    for arch, requests, prompt, new in MA_SERVE:
        cfg = ma_cfg(arch)
        held = held_engine_steps(r_arr[f"{arch}/tokens"], s_arr[f"{arch}/tokens"],
                                 r_arr[f"{arch}/logits"], s_arr[f"{arch}/logits"])
        limit = SCALED_TOL_FULL
        if "plain_scan" in single[arch]:
            limit = max(MA_SSM_FLOOR, SSM_REL * single[arch]["plain_scan"]["engine_scaled_err"])
        one = single[arch]["launches"]
        n_ssm = sum(cfg.layer_kind(i % cfg.block_size) == "ssm" for i in range(cfg.n_layers))
        want = dict(one)
        if n_ssm:
            gated = n_ssm * new
            want |= {"rmsnorm": one["rmsnorm"] - gated, "rmsnorm_split_stat": gated,
                     "rmsnorm_split_apply": gated}
        readings[arch] = {**held, "limit": limit,
                          "single": {k: single[arch][k] for k in ("ttft_s", "tpot_s")},
                          "ranks_ttft_s": [x[arch]["ttft_s"] for x in ranks],
                          "ranks_tpot_s": [x[arch]["tpot_s"] for x in ranks],
                          "local_params": [x[arch]["local_params"] for x in ranks],
                          "plain_scan": single[arch].get("plain_scan")}
        say(f"    {arch}: {json.dumps(readings[arch])}")
        for r, x in enumerate(ranks):
            if x[arch]["launches"] != want:
                raise AssertionError(f"(21) {arch} rank {r}: launches {x[arch]['launches']} "
                                     f"!= {want}")
            counts.append(x[arch]["launches"])
        if not (held["engine_scaled_err"] <= limit and min(held["steps_held"]) >= 1):
            raise AssertionError(f"(21) {arch}: two ranks vs one device {readings[arch]}")
    grads = [(r_arr[f"train/grad{i}"], s_arr[f"train/grad{i}"])
             for i in range(sum(1 for k in s_arr if k.startswith("train/grad")))]
    errs = [scaled_err(a, b) for a, b in grads]
    loss_rel = abs(ranks[0]["train_loss"] - single["train_loss"]) / abs(single["train_loss"])
    grad_limit = max(MA_GRAD_FLOOR, SSM_REL * single["train_plain_scan_err"])
    readings["train"] = {"loss": [single["train_loss"], ranks[0]["train_loss"]],
                         "loss_rel_diff": loss_rel, "grad_scaled_err_max": max(errs),
                         "plain_scan_grad_scaled_err": single["train_plain_scan_err"],
                         "limit": grad_limit,
                         "launches_rank": [x["train_launches"] for x in ranks]}
    say(f"    train step: {json.dumps(readings['train'])}")
    for x in ranks:
        la = x["train_launches"]
        if not (la["rmsnorm_bwd_split_stat"] > 0
                and la["rmsnorm_bwd_split_stat"] == la["rmsnorm_bwd_split_apply"]):
            raise AssertionError(f"(21) train step launches {la}")
        counts.append(la)
    if not (loss_rel <= 1e-3 and max(errs) <= grad_limit):
        raise AssertionError(f"(21) train step: {readings['train']}")
    say(f"    phase 21 in {time.perf_counter() - t0:.1f} s on {card}")
    return summed(*counts), readings


def phase20_child(part: str, job_dir: str, rank: int, world: int, backend: str) -> int:
    """Entry of phase 20's child processes (``chip_smoke.py --phase20 PART
    DIR RANK WORLD BACKEND``)."""
    import faulthandler

    import torch

    faulthandler.dump_traceback_later(PHASE20_TIMEOUT_S - PHASE20_STACKS_BEFORE_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = {"a": lambda: mesh_train_one_rank(torch, Path(job_dir)),
          "b": lambda: olmoe_rank(torch, Path(job_dir), rank, world, backend),
          "c": lambda: dp_train_rank(torch, Path(job_dir), rank, world, backend),
          "ma": lambda: model_axis_rank(torch, Path(job_dir), rank, world, backend)}[part]
    fn()
    return 0


def run_phase20_part(part: str, world: int, job_dir: Path, backend: str,
                     script: str = __file__, timeout: float = PHASE20_TIMEOUT_S) -> None:
    """Start ``world`` children of ``part`` together (``script --phase20
    PART DIR RANK WORLD BACKEND``, each writing its output to a log under
    ``job_dir``) and wait for all of them; once one fails, or ``timeout``
    seconds have passed, kill the rest (a rank left waiting in a collective
    for a failed one never returns). Fails, with every rank's last lines,
    unless every one exited 0; relays the last lines of each otherwise."""
    logs = [job_dir / f"{part}-rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-u", script, "--phase20", part, str(job_dir),
                 str(r), str(world), backend], stdout=f, stderr=subprocess.STDOUT,
                env=dict(os.environ, NCCL_DEBUG="WARN")))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    tails = [[x for x in log.read_text().splitlines() if x.strip()] for log in logs]
    if any(p.returncode for p in procs):
        why = (f"not done within {timeout} s" if time.monotonic() > deadline
               else "a rank failed")
        raise AssertionError(
            f"phase 20 ({part}): {why}; exit codes {[p.returncode for p in procs]}\n"
            + "\n".join(f"[rank {r}] {x}" for r, t in enumerate(tails) for x in t[-40:]))
    for r, t in enumerate(tails):
        for line in t[-8:]:
            say(f"      [{part} rank {r}] {line}")


def held_engine_steps(tokens, want_tokens, logits, want_logits) -> dict:
    """Two engines' greedy runs of the same requests, tokens (B, n) and the
    logits each token was sampled from (B, n, V): per sequence, the steps
    up to and including the first where the tokens differ (all n if none),
    whose logits were computed from the same inputs and are held; the
    largest scaled difference of the logits over them."""
    held, errs = [], []
    for i in range(tokens.shape[0]):
        diff = (tokens[i] != want_tokens[i]).nonzero()
        k = int(diff[0]) + 1 if diff.numel() else tokens.shape[1]
        held.append(k)
        errs.append(scaled_err(logits[i, :k], want_logits[i, :k]))
    return {"steps_held": held, "engine_scaled_err": max(errs)}


def _two_ranks(backend: str) -> str:
    return ("two gloo ranks sharing the card" if backend == "gloo"
            else f"two {backend} ranks, a card each")


def phase20_a(job_dir: Path) -> tuple[dict, dict]:
    """(a): (launches, readings)."""
    say(f"[20a] olmo_1b run_train, {TRAIN_BATCH} x {TRAIN_SEQ}, {MESH_TRAIN_STEPS} "
        f"steps: no mesh, then one NCCL rank on the (1, 1) mesh with FSDP; then "
        f"served, 2 x {MESH_SERVE_PROMPT} + {MESH_SERVE_TOKENS} tokens, the step "
        f"captured with and without the mesh")
    run_phase20_part("a", 1, job_dir, "nccl")
    a = json.loads((job_dir / "a.json").read_text())
    say(f"    {json.dumps(a)}")
    return a["launches"], a


def phase20_b(torch, job_dir: Path, backend: str) -> tuple[dict, dict]:
    """(b) over ``backend``: (launches summed over the ranks, readings)."""
    import numpy as np

    cfg = phase20_cfg("olmoe")
    say(f"[20b] olmoe_1b_7b ({cfg.n_layers} layers) on {_two_ranks(backend)}, mesh (1, 2), moe_dispatch shard_map, "
        f"decode_attn context_parallel: {REQUESTS} x {PROMPT_LEN} + {CP_NEW_TOKENS} "
        f"tokens and 1 x {CP_SHORT_PROMPT} + {CP_NEW_TOKENS}, routed as one device "
        f"routed them, against one device")
    olmoe_single(torch, job_dir)        # no collective: in this process
    torch.cuda.empty_cache()
    run_phase20_part("b", 2, job_dir, backend)
    single = json.loads((job_dir / "b_single.json").read_text())
    ranks = [json.loads((job_dir / f"b_rank{r}.json").read_text()) for r in range(2)]
    with np.load(job_dir / "b_single.npz") as d:
        s_arr = {k: d[k] for k in d.files}
    with np.load(job_dir / "b_ranks.npz") as d:
        r_arr = {k: d[k] for k in d.files}
    steps = CP_NEW_TOKENS - 1
    L = cfg.n_layers
    want = {**dict.fromkeys(ranks[0]["long"]["launches"], 0),
            "decode_attention": L * steps, "flash_attention": L,
            "rmsnorm": (1 + 2 * L) * CP_NEW_TOKENS}
    for r, rk in enumerate(ranks):
        if not (rk["local_experts"] == cfg.moe_experts // 2
                and rk["local_heads"] == cfg.n_heads // 2):
            raise AssertionError(f"(b) rank {r} holds {rk['local_experts']} experts, "
                                 f"{rk['local_heads']} heads")
        for name in ("long", "short"):
            if rk[name]["launches"] != want or rk[name]["per_step"] != [L] * steps:
                raise AssertionError(
                    f"(b) rank {r} {name}: launches {rk[name]['launches']} != {want}, "
                    f"decode launches per step {rk[name]['per_step']} (want {L} each)")
            if rk[name]["tokens"] != ranks[0][name]["tokens"]:
                raise AssertionError(f"(b) {name}: the ranks returned other tokens")
    b_read = {"single_ttft_s": single["ttft_s"], "single_tpot_s": single["tpot_s"],
              "ranks_ttft_s": [rk["long"]["ttft_s"] for rk in ranks],
              "ranks_tpot_s": [rk["long"]["tpot_s"] for rk in ranks],
              "short_ranks_ttft_s": [rk["short"]["ttft_s"] for rk in ranks],
              "short_ranks_tpot_s": [rk["short"]["tpot_s"] for rk in ranks],
              "captures": [rk["captures"] for rk in ranks],
              "local_params": [rk["local_params"] for rk in ranks],
              "launches_rank": [rk["long"]["launches"] for rk in ranks]}
    for name in ("long", "short"):
        want_logits = torch.from_numpy(s_arr[f"{name}/logits"])
        held = held_engine_steps(
            torch.tensor(ranks[0][name]["tokens"]).t(),
            torch.from_numpy(s_arr[f"{name}/tokens"]).t(),
            torch.from_numpy(r_arr[f"{name}/engine"]), want_logits)
        rep = torch.from_numpy(r_arr[f"{name}/replayed"])
        b_read[name] = {**held, "replayed_routes_scaled_err": scaled_err(rep, want_logits),
                        "replayed_routes_greedy_agreement":
                        (rep.argmax(-1) == want_logits.argmax(-1)).float().mean().item()}
        x = b_read[name]
        if not (x["engine_scaled_err"] <= SCALED_TOL_FULL
                and x["replayed_routes_scaled_err"] <= SCALED_TOL_FULL
                and x["replayed_routes_greedy_agreement"] >= 0.8):
            raise AssertionError(f"(b) {name}: 2 ranks vs one device {x}")
    say(f"    {json.dumps(b_read)}")
    return summed(*[rk[name]["launches"] for rk in ranks for name in ("long", "short")]), b_read


def phase20_c(job_dir: Path, backend: str) -> tuple[dict, list]:
    """(c) over ``backend``: (launches summed over the ranks and runs,
    each rank's readings)."""
    say(f"[20c] olmo_1b at full width, {DP_LAYERS} layers, on {_two_ranks(backend)}, "
        f"mesh (2, 1), "
        f"{DP_BATCH_PER_RANK} x {TRAIN_SEQ} a rank, against one process's "
        f"{2 * DP_BATCH_PER_RANK} x {TRAIN_SEQ} step: plain, with compressed "
        f"gradients, with FSDP")
    run_phase20_part("c", 2, job_dir, backend)
    c = [json.loads((job_dir / f"c_rank{r}.json").read_text()) for r in range(2)]
    n = DP_LAYERS * 2                   # layers x the two steps of a run
    want = {**dict.fromkeys(c[0]["plain"]["launches"], 0),
            "flash_attention_fwd_lse": 2 * n, "flash_attention_bwd_dkv": n,
            "flash_attention_bwd_dq": n}
    for r, x in enumerate(c):
        for tag, _, _ in DP_RUNS:
            if x[tag]["launches"] != want:
                raise AssertionError(f"(c) rank {r} {tag}: launches "
                                     f"{x[tag]['launches']} != {want}")
    say(f"    {json.dumps(c)}")
    return summed(*[x[t]["launches"] for x in c for t, _, _ in DP_RUNS]), c


def summed(*runs: dict) -> dict:
    """The counts of ``runs`` added, key by key."""
    keys = {k: None for r in runs for k in r}
    return {k: sum(r.get(k, 0) for r in runs) for k in keys}


def check_multi_device(torch, card: str) -> tuple[dict, dict]:
    """Phase 20: the multi-device layer on the card, in child processes
    (each under PHASE20_TIMEOUT_S): (a) one NCCL rank, (b) two gloo ranks
    sharing the card serving OLMoE expert- and context-parallel, (c) two
    gloo ranks of data parallelism, plain, with compressed gradients and
    with FSDP. Returns the launch counts by path and the readings."""
    import tempfile

    job_dir = Path(tempfile.mkdtemp(prefix="phase20-"))
    t0 = time.perf_counter()
    counts, readings = {}, {}
    counts["olmo_1b_mesh_train"], readings["a"] = phase20_a(job_dir)
    counts["olmoe_1b_7b_two_ranks"], readings["b"] = phase20_b(torch, job_dir, "gloo")
    counts["olmo_1b_dp_train"], readings["c"] = phase20_c(job_dir, "gloo")
    say(f"    phase 20 in {time.perf_counter() - t0:.1f} s on {card}")
    return counts, readings


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    laps: dict[str, float] = {}

    def lap(phases: str) -> None:
        """Record the seconds since the previous lap under ``phases``."""
        laps[phases] = round(time.perf_counter() - t_start - sum(laps.values()), 1)

    # 1. card and toolchain
    card = nvidia_smi("name,power.limit")
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    nv = subprocess.run([_build.nvcc(), "--version"], check=True,
                        capture_output=True, text=True).stdout.strip()
    say(f"    nvcc: {nv.splitlines()[-1]}")
    try:
        import triton
        say(f"    triton {triton.__version__} (not used by this slice)")
    except ImportError:
        say("    triton: not installed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    probe_started = probe_build_start()
    logs = _build.build_all(verbose=True)
    probe = probe_build_finish(probe_started)
    say(f"[2] built {len(logs)} kernels for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "smem", "error", "warning")):
                say(f"    {name}: {line.strip()}")
    builds, faults = build_reports(logs)
    for name, report in builds.items():
        say(f"    {name} kernels ({BUILD_COLUMNS[name]}): {json.dumps(report)}")
    if faults:
        return fail("; ".join(faults))
    lap("1-2")

    # 3. kernels vs plain
    say("[3] kernels against their plain versions (bf16, rtol=atol=2e-2; "
        "rmsnorm also within one bf16 ulp of f64, the residual bit for bit; "
        f"decode o within {DECODE_REL:g} x max|plain|, lse within 1e-3; "
        "ssd rtol=atol=2e-4; training attention each row within "
        f"{TRAIN_ROW_REL:g} of its max|plain|; "
        f"pricing f64 bit for bit, f32 within {DRIFT_BAND:g} of f64)")
    timer = Timer(torch)
    numbers = {"rmsnorm": check_rmsnorm(torch, timer, probe) | {"build": builds["rmsnorm"]}}
    numbers["rmsnorm_bwd"] = check_rmsnorm_bwd(torch, timer) | {
        "build": builds["rmsnorm_bwd"]}
    numbers.update(check_rmsnorm_split(torch, timer))
    for name in ("rmsnorm_split_stat", "rmsnorm_split_apply", "rmsnorm_bwd_split_stat",
                 "rmsnorm_bwd_split_apply"):
        label = "split_" + name.replace("rmsnorm_", "").replace("split_", "") + "<"
        numbers[name]["build"] = {k: v for k, v in builds["rmsnorm_split"].items()
                                  if k.startswith(label) or (k == "split_dw" and "bwd_apply" in name)}
    numbers.update(check_kernels(torch, timer))
    numbers["decode_attention"]["build"] = builds["decode_attention"]
    numbers.update(check_hd64(torch, timer, probe))
    numbers["decode_attention[bf16/hd64]"]["build"] = {
        k: v for k, v in builds["decode_attention"].items() if k.startswith("decode_lanes<64,")}
    numbers["flash_attention[bf16/hd64]"]["build"] = builds["flash_attention"][
        "flash_fwd_kernel<64>"]
    numbers["ssd"] = check_ssd(torch, timer) | {"build": builds["ssd"]}
    numbers.update(check_training_kernels(torch, timer))
    for name, kernel in (("flash_attention", "flash_fwd_kernel<128>"),
                         ("flash_attention_fwd_lse", "flash_fwd_kernel<128, lse>"),
                         ("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel<128>"),
                         ("flash_attention_bwd_dq", "flash_bwd_dq_kernel<128>")):
        numbers[name]["build_hd128"] = builds["flash_attention"][kernel]
    numbers.update(check_pricing(torch, timer))
    say("[3] the contract's further instantiations: hd 16 in bf16 (held as "
        f"above), float32 at hd {CONTRACT_HDS} and row 1 in float32 (forward "
        f"{F32_TOL}, backward {F32_BWD_TOL}, TF32 off)")
    contract, off_path = check_contract(torch, timer, probe)
    for name, entry in contract.items():
        base, kind = name[:-1].split("[")
        hd = kind.split("/hd")[1] if "/hd" in kind else None
        if hd and base == "decode_attention":
            entry["build"] = builds["decode_attention" + ("" if kind.startswith("bf16") else "_f32")]
            entry["build"] = {k: v for k, v in entry["build"].items() if f"<{hd}," in k}
        elif hd:
            flash = builds["flash_attention" + ("" if kind.startswith("bf16") else "_f32")]
            entry["build"] = {k: v for k, v in flash.items() if f"<{hd}" in k}
    numbers.update(contract)
    say(f"    held, and run on no path (no configuration has a float32 hd-64 "
        f"attention): {sorted(off_path)}")
    del timer
    torch.cuda.empty_cache()
    lap("3")

    # 4. the DSE path
    say("[4] DSE price phase: sweeps, a parallel sweep and reprice_grid on "
        "the kernel backends against numpy")
    t0 = time.perf_counter()
    dse = check_dse(kernels)
    say(f"    DSE path in {time.perf_counter() - t0:.1f} s; pricing launches "
        f"{dse['pricing']}, pricing_f32 launches {dse['pricing_f32']}")

    # 4b. the learned rank stage, budgeted search and the service daemon
    say("[4b] DSE rank stage, certified searches and the service daemon on "
        "the kernel backends against numpy")
    t0 = time.perf_counter()
    watchdog = threading.Timer(PHASE4B_TIMEOUT_S, _timed_out,
                               ("phase 4b", PHASE4B_TIMEOUT_S))
    watchdog.daemon = True
    watchdog.start()
    try:
        features = check_dse_features(kernels)
    finally:
        watchdog.cancel()
    say(f"    phase 4b in {time.perf_counter() - t0:.1f} s; pricing launches "
        f"{features['pricing']}, pricing_f32 launches "
        f"{features['pricing_f32']}")
    lap("4-4b")

    # 5.-7. the serving paths
    cfg = get_config("mistral_nemo_12b")
    dense, dense_t = check_serving(torch, kernels, "mistral_nemo_12b", REQUESTS, {
        "flash_attention": cfg.n_layers,
        "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
        "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS}, phase=5)
    # an SSM layer has no MLP: per pass 1 + L residual norms and L gated
    # norms; the scan runs in prefill only, the decode step is a recurrence
    cfg = get_config("mamba2_130m")
    ssm, _ = check_serving(torch, kernels, "mamba2_130m", SSM_REQUESTS, {
        "ssd": cfg.n_layers,
        "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS}, phase=7)
    say(f"    pricing events profiled after the serving profiles: "
        f"{profiler_recheck(torch, kernels)}")
    torch.cuda.empty_cache()
    lap("5-7")

    # 8. the training path
    say("[8] training olmo_1b: full-width gradients against the plain "
        "attention, SMOKE steps against the CPU, then run_train")
    t0 = time.perf_counter()
    say(f"    2-layer olmo_1b, {GRAD_BATCH} x {TRAIN_SEQ}: "
        f"{check_train_grads(torch, kernels)}")
    say(f"    SMOKE, 3 steps, card vs CPU: {check_smoke_training(torch)}")
    train = check_training(torch, kernels)
    say(f"    training phase in {time.perf_counter() - t0:.1f} s")
    lap("8")

    # 9. a GQA group-3 serving path: minitron_4b at full width, depth cut
    full = get_config("minitron_4b")
    cfg = dataclasses.replace(full, n_layers=MINITRON_LAYERS)
    say(f"[9] minitron_4b serving, GQA {cfg.n_heads}/{cfg.n_kv_heads} (group "
        f"{cfg.n_heads // cfg.n_kv_heads}), d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}; depth cut from {full.n_layers} to {cfg.n_layers} layers")
    gqa3, _ = check_serving(torch, kernels, "minitron_4b", REQUESTS, {
        "flash_attention": cfg.n_layers,
        "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}, phase=9,
        cfg=cfg, short=True)
    child = subprocess.run([sys.executable, __file__, "--capture-failure"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        return fail(f"a decode step that cannot be captured did not raise: "
                    f"{child.stdout[-500:]} {child.stderr[-2000:]}")
    say(f"    {child.stdout.strip().splitlines()[-1]}")
    torch.cuda.empty_cache()
    lap("9")

    # 10.-11. the MoE serving path: olmoe_1b_7b at full width and depth
    cfg = get_config("olmoe_1b_7b")
    say(f"[10] olmoe_1b_7b serving: {cfg.moe_experts} experts top-"
        f"{cfg.moe_top_k} (expert d_ff {cfg.d_ff}), d_model {cfg.d_model}, "
        f"MHA {cfg.n_heads}/{cfg.n_kv_heads} at hd {cfg.hd}, vocab {cfg.vocab}, "
        f"{cfg.n_layers} layers, nothing cut")
    moe, moe_t = check_serving(torch, kernels, "olmoe_1b_7b", REQUESTS, {
        "flash_attention": cfg.n_layers,
        "decode_attention": cfg.n_layers * (NEW_TOKENS - 1),
        "rmsnorm": (1 + 2 * cfg.n_layers) * NEW_TOKENS}, phase=10)
    torch.cuda.empty_cache()
    lap("10-11")

    # 26.-27. command_r_35b whole (60.3 GiB of weights), where the allocator
    # holds least: after the serving phases, before the validation loop
    command_r, command_r_t = phase26_command_r(torch, kernels)
    torch.cuda.empty_cache()
    lap("26-27")

    # 12. the modeled-vs-measured validation loop
    say("[12] validation: the card calibrated, the three cases predicted, "
        "counted and timed, gated with the reference's bands")
    t0 = time.perf_counter()
    check_validation(card)
    say(f"    validation phase in {time.perf_counter() - t0:.1f} s")

    # 13. the paper's serving model beside the measured serving paths
    say("[13] serving model (serving_sweep, one-chip catalog H100 + HBM) "
        "against the measured warm TTFT and steady TPOT")
    serving_model_reading({"mistral_nemo_12b": dense_t, "olmoe_1b_7b": moe_t,
                           "command_r_35b": command_r_t})
    torch.cuda.empty_cache()
    lap("12-13")

    # 14.-17. cross-attention memory, the encoder, hybrid blocks and
    # speculative decoding
    new_paths = check_memory_hybrid_paths(torch, kernels)
    lap("14-17")

    # 18. training through the fused RMSNorm and the SSD scan
    rmsnorm_train = check_rmsnorm_training(torch, kernels)
    torch.cuda.empty_cache()
    lap("18")

    # 20. the multi-device layer: one NCCL rank, two gloo ranks sharing the
    # card (context- and expert-parallel serving, data-parallel training)
    multi_device, _ = check_multi_device(torch, card)
    lap("20")

    # 21. SSM, cross-attention and encoder layers under a model axis
    import tempfile
    model_axis, _ = phase21(torch, Path(tempfile.mkdtemp(prefix="phase21-")), card)
    lap("21")

    # 22.-25. head dim 16 and float32 on the paths
    hd16 = phase22_hd16(torch, kernels)
    lap("22")
    f32_smoke = phase23_f32_smoke(torch, kernels)
    lap("23")
    f32_serve = phase24_f32_serving(torch, kernels)
    lap("24")
    f32_train = phase25_f32_training(torch, kernels)
    lap("25")

    by_path = {"mistral_nemo_12b": dense, "mamba2_130m": ssm, "dse": dse,
               "dse_rank_search_service": features,
               "olmo_1b_train": train, "minitron_4b": gqa3,
               "olmoe_1b_7b": moe, "command_r_35b": command_r, **new_paths, **rmsnorm_train,
               **multi_device, "model_axis_two_ranks": model_axis,
               "hd16_smoke": hd16, "f32_smoke": f32_smoke,
               "mistral_nemo_12b_f32": f32_serve, "olmo_1b_f32_train": f32_train}
    counts = {name: sum(c.get(name, 0) for c in by_path.values())
              for name in numbers}

    # 19. result
    fa = "src/repro/kernels/flash_attention"
    # the backward has no Pallas counterpart: it computes the gradient the
    # reference takes of its plain rmsnorm under jax.value_and_grad
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:43",
                "rmsnorm_bwd": "src/repro/models/layers.py:47",
                # the gated norm's row split over a model axis: the Pallas
                # norm's statistic and apply, and the backward's alike
                "rmsnorm_split_stat": "src/repro/kernels/rmsnorm/kernel.py:43",
                "rmsnorm_split_apply": "src/repro/kernels/rmsnorm/kernel.py:43",
                "rmsnorm_bwd_split_stat": "src/repro/models/layers.py:47",
                "rmsnorm_bwd_split_apply": "src/repro/models/layers.py:47",
                "decode_attention": "src/repro/kernels/decode_attention/kernel.py:89",
                "flash_attention": f"{fa}/kernel.py:112",
                "flash_attention_fwd_lse": f"{fa}/backward.py:109",
                "flash_attention_bwd_dkv": f"{fa}/backward.py:252",
                "flash_attention_bwd_dq": f"{fa}/backward.py:283",
                "pricing": "src/repro/kernels/pricing/kernel.py:165",
                "pricing_f32": "src/repro/kernels/pricing/kernel.py:235",
                "ssd": "src/repro/kernels/ssd/kernel.py:86"}
    shown = {"rmsnorm_bwd": "fused_rmsnorm_bwd", "rmsnorm_split_stat": "gated_norm_stat",
             "rmsnorm_split_apply": "gated_norm_apply",
             "rmsnorm_bwd_split_stat": "gated_norm_bwd_stat",
             "rmsnorm_bwd_split_apply": "gated_norm_bwd_apply"}
    split = "rmsnorm/csrc/rmsnorm_split"
    sources = {"rmsnorm_bwd": "rmsnorm", "rmsnorm_split_stat": split,
               "rmsnorm_split_apply": split, "rmsnorm_bwd_split_stat": split,
               "rmsnorm_bwd_split_apply": split, "flash_attention_fwd_lse": "flash_attention",
               "flash_attention_bwd_dkv": "flash_attention",
               "flash_attention_bwd_dq": "flash_attention",
               "pricing_f32": "pricing"}
    idle = [name for name in numbers if not counts[name]]
    if idle:
        return fail(f"kernels never launched on the main path: {idle}")
    line = []
    for name, n in numbers.items():
        # "<wrapper>[<kind>]": one instantiation of the contract (a dtype and,
        # for attention, a head dim), its float32 attention in <source>_f32.cu
        base, _, kind = name.rstrip("]").partition("[")
        src = sources.get(base, base)
        path = src if "/" in src else f"{src}/csrc/{src}"
        if kind.startswith("f32") and "attention" in src:
            path += "_f32"
        line.append({"name": shown.get(base, base) + (f"[{kind}]" if kind else ""),
                     "route": "cuda", "source": f"src/repro_torch/kernels/{path}.cu",
                     "replaces": replaces[base], "launches": counts[name],
                     "launches_by_path": {p: c[name] for p, c in by_path.items()
                                          if c.get(name)},
                     **n})
    total = time.perf_counter() - t_start
    say(f"    seconds by phase: {json.dumps(laps)}")
    say(f"    total {total:.1f} s (limit {RUN_LIMIT_S} s, the kernels' build included)"
        + (f": OVER THE LIMIT by {total - RUN_LIMIT_S:.1f} s" if total > RUN_LIMIT_S
           else ""))
    say(json.dumps({"kernels": line}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--capture-failure"]:
        sys.path.insert(0, str(ROOT / "src"))
        sys.exit(capture_failure_raises())
    if sys.argv[1:2] == ["--phase20"]:
        sys.path.insert(0, str(ROOT / "src"))
        part, job_dir, rank, world, backend = sys.argv[2:7]
        sys.exit(phase20_child(part, job_dir, int(rank), int(world), backend))
    sys.exit(main())
