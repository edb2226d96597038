#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                      # from the root of a checkout
    python3 chip_smoke.py --profile DIR        # + the profiler's tables in DIR

Needs one CUDA card (an H100 for the numbers in PERF.md) and ``nvcc``; it
imports nothing of JAX or of the JAX package.  Phases:

1. the card (``nvidia-smi`` name and power limit), and whether torch's
   ``CUDAGraph`` has the conditional-node methods a lazy probe inside a
   chunk graph would need;
2. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving path gives it at ``eat-paper-8b`` width, in bf16 and f32,
   within the stated tolerances; then kernel, plain and (where one exists)
   library-call times with CUDA events, and the roofline bound.  Flash
   prints the variant it launched (``ops.flash_variant``: the bf16
   tensor-core kernel, or the scalar kernel for float32) and the ptxas
   registers and spills of every flash instantiation (the MLA kernel's
   too; phase 6b drives it).  The paged kernel
   runs the decode (m 1) and probe (m 2) reads over ~40 pages per row and
   a decode over 128 pages, each row with two whole splits of logical
   blocks unmapped; each line gives the split count and grid, and dense
   SDPA over the ring layout of the same keys as a yardstick of another
   layout; the ptxas lines of its three kernels follow.  bf16 flash is
   also timed against SDPA by CUDA-graph replay in turns (5 rounds,
   medians).  The flash-decode kernel (``decode_attention``), which no
   serve path calls, is driven through its op's entry point at the 8B
   decode shapes over a ring-rotated dense cache, and its launches are
   counted over that phase, per variant (``ops.decode_variant``: the bf16
   cases on the tensor-core kernel); each case prints the kernels of one
   call (two, by the profiler), the worst ratio of its error to the bar,
   and its time and SDPA's by graph replay in turns (5 rounds, medians,
   eager readings beside); the ptxas lines of its kernels come first;
   then the same at Gemma's head dim 256 (bf16 and float32, m 1, g 1 and
   8: the scalar kernel, K and V sharing one buffer).
   The entropy probe at ``eat-paper-8b`` width (B 4 and B 32), at
   ``qwen3-1.7b``'s tied table (its transposed view) and at
   ``mamba2-2.7b``'s width, each bf16 case routed to the tensor-core
   variant (``ops.entropy_variant``; checked) and both variants held to the
   plain version, timed in turns by CUDA-graph replay (5 rounds, medians),
   the routed call eager, the plain version, a bf16 ``torch.matmul(h, w)``
   as a yardstick of part of the work, the byte bound, and the kernels of
   one call (two, by the profiler); float32 on the scalar kernel; the
   ptxas lines of its kernels first.
   The SSD scan against its plain version at ``mamba2-2.7b``'s prefill
   shapes (zero and nonzero initial state), both variants
   (``ops.ssd_variant``: the chunk-parallel tensor-core kernels, which
   mamba2-2.7b takes, and the scalar kernel), with the kernels of one call
   (profiler), the ptxas lines of every scan kernel, both variants timed at
   B 4 and B 1, S 512 (the serve's cohort and admission prefills) by
   CUDA-graph replay in turns, the plain time, and two bounds of the
   function's work, C B^T once per group (3xTF32 on the tensor cores;
   float32 FMAs), with the same two for the TPU kernel's work beside;
4. ``eat-paper-8b`` at full width with seeded random weights made on the
   card: kernel path vs plain path on a short input (float32 with the depth
   cut to 4 layers, then bfloat16 at the full 36).  Then each serve
   configuration runs on one engine three times: a cold serve, whose decode
   (and shadow) chunks are captured as CUDA graphs (``[graphs]``: captures,
   seconds each, graph keys, pool memory), a warm serve that must capture
   nothing and replay every chunk (0 ``device_if`` reads), with every
   launch counted (the wrappers' eager calls plus each graph's captured
   calls once per replay), and an eager serve of the same engine (the
   guarded Python loop), which must give the graph serve's tokens, exits,
   slots, answers and EAT traces bitwise.  Each harvest's forced-answer
   rollout is a graph replay too (its own key: batch, tokens, greedy, cache
   shape), so a warm serve's replays are its chunks plus its rollouts.  Each chunk is timed on the card
   by CUDA events around the call (``[chunk]``: replay against the eager
   loop).  The paged self-EAT serve of 8 requests through 4 slots (every
   flash launch the tensor-core kernel: 36 per prefill, none scalar; every
   entropy call the tensor-core kernel) also runs 3 eager and 3 warm graph
   serves in turns, walls with medians and ranges; a ring serve of the same
   workload must give bitwise identical token streams;
   then the same workload served black-box (``monitor_mode == "proxy"``):
   once with the 8B model monitoring itself, which must give the self-EAT
   paged serve bitwise, and once monitored by ``qwen3-1.7b`` at full width
   and depth, with the generator's probe count 0 in both and every launch
   attributed to its tier (flash: 36 per 8B prefill and 28 per
   ``qwen3-1.7b`` prefill, all of them the tensor-core kernel; the proxy's
   entropy calls, on its tied table, too); every engine of this phase has
   the overlapped loop's headroom (one chunk of capacity, one row of
   pages), so that
4c. the overlapped serve loop (``serve(overlap=True)``,
   ``serving/pipeline.py``) replays the sync serves' graphs on the paged
   self-EAT engine and the ``qwen3-1.7b`` proxy engine: a cold overlapped
   serve (its captures printed), a warm one run whole under
   ``torch.cuda.set_sync_debug_mode("error")`` that must equal the warm
   sync serve bitwise and capture nothing (``[overlap]`` lines: chunk
   replays, idle replays with ``steps == 0``, skipped shadows, pages the
   ledger deferred, host reads), the walls of 3 sync and 3 overlapped
   serves in turns with the card's name and power limit, and one profiled
   overlapped serve (``[profile overlap ...]``: busy share, launch counts
   checked against the profiler);
5. ``mamba2-2.7b`` (the 8B engines freed first): kernel path vs plain path of
   the model (float32 cut to 4 layers, then bfloat16 at the full 64); a ring
   self-EAT serve of 8 requests through 4 slots at full width and depth,
   cold graph, warm graph and eager on one engine as above, with the
   launches of its kernels counted (every entropy call the tensor-core
   kernel); before it, one ``decode_and_probe`` against ``decode_step`` +
   ``probe_entropy`` from one cache state, bitwise (a recurrent stack's
   fused step is the separate step, as in the reference);
5b. ``deepseek-moe-16b`` (arXiv:2401.06066; the 8B and mamba2 engines freed,
   the 8B model kept for phase 6): flash (16 q and 16 kv heads: g = 1),
   paged (m 1 and 2, g = 1) and entropy (its untied 2048 x 102,400 head)
   against their plain versions at its shapes, timed (``[kernels] moe``
   lines); kernel path vs plain path of the model (float32 cut to 4 layers,
   1e-5; then bf16 at the full 28 layers within ``MOE_BF16_TOL``: the
   logits with the plain path's expert routes on both paths, the EAT with
   each path's own, and the routes the two paths pick differently
   counted); seeded random
   weights at full width and depth (16.4 B parameters, 32.8 GB); a paged
   self-EAT serve of phase 4's traffic (prompts drawn over its 102,400
   vocabulary) as cold graph, warm graph and eager serves of one engine,
   warm == eager bitwise, 0 captures and 0 ``device_if`` reads warm, flash
   all mma (28 per prefill), every entropy call mma, one more warm serve
   under the profiler (``[profile moe]``: launches checked, busy share);
   a ring serve of the same traffic, bitwise the paged streams; warm
   tokens/s, chunk ms on the card and the phase's peak memory;
Every serve prints its host reads (``[serve] ... host reads``): the
decode chunks it ran with their median time on the card, its
device-to-host snapshot copies, which must be one per chunk after the
setup's (one per shadow chunk for the proxy tier), its graph replays and
captures, and the ``device_if`` predicate reads, the only other host reads
in an eager chunk and none in a replayed one.  One more warm graph serve of
the 8B paged configuration and of ``mamba2-2.7b`` runs under the profiler:
the wrappers' launch counts over it (eager calls, plus each graph's
captured calls once per replay) must equal the kernels the profiler saw
(in one whole serve: one in which the profiler kept fewer is profiled
again, up to ``PROFILE_ATTEMPTS`` serves in all), and must equal the
unprofiled warm serve's; these checked counts are the
``launches`` of the result line.  ``--profile DIR`` writes their tables to
DIR and profiles the ``qwen3-1.7b`` proxy serve the same way.
6. the paper's evaluation path (App. H) on ``eat-paper-8b`` (``[trace]``):
   ``reason_with_trace`` over the first 4 prompts on a ring cache, every_n
   8, 64 tokens, K 4 forced rollouts of 4 tokens and a 5-token greedy
   confidence at every evaluation point, with the paper's sampler
   (temperature 0.6, top-p 0.95) and seeded generators, as a cold graph
   trace (its chunk and rollout graphs captured), a warm graph trace (no
   capture; every chunk and rollout a replay; its launches counted) and an
   eager trace, which must equal the warm one bitwise in every record
   field and in ``out_tokens``, with both generators at the same offsets;
   then the three Fig. 21 costs (``[fig21]``) at contexts 512 and 2048
   (B 4), each by graph replay (``graph_ms``): one ``eval_eat_now``, one
   ``decode_step`` (on a copy of the cache) and one ``rollout_answers`` of
   K 8 x 4 tokens; and the per-token loop (``_reason_per_token``) against
   ``reason`` on the chunk graphs, unmonitored, in tokens/s in turns (3
   each), which must give the same tokens;
6g. the fused decode-and-probe step (``Model.decode_and_probe``: one
   forward over ``[token, </think>, prefix]`` that commits the token
   alone) on the same 8B model (``fused_phase``): the paged kernel at m 3
   (12 rows at g 4) against its plain version at phase 3's bar, timed with
   its bound; at contexts 512 and 2048 (B 4), on a paged cache and on the
   ring, one fused step against one separate step from the same cache
   state and the two decode steps after each (``fused_vs_separate``:
   logits within 3e-2 relative L2 and max |diff| / max |logits|, EAT
   within 6e-2 nats; a stray stale probe key would hide inside these bf16
   bars: that the probe's K/V stay masked is held at 1e-5 in float32 by
   ``tests/test_torch_fused_probe.py``), the fused step's launches counted from 0 (36 paged,
   1 entropy, no flash), paged == ring bitwise; both steps timed as
   CUDA-graph replays in turns (5 rounds; ``[fig21]`` lines beside phase
   6's, with the bound of one read of the weights); then 16 greedy steps
   of ``build_serve_step_program(fused_probe=True)`` (every-token
   monitor), eager with their launches counted and captured as one CUDA
   graph whose cold and warm replays equal the eager run bitwise;
6b. ``deepseek-v2-236b`` (arXiv:2405.04434: multi-head latent attention
   and 160 routed + 2 shared experts; the 8B model freed first): the flash
   kernel at MLA's absorbed shapes (128 q heads of 576 against one kv head,
   values the 512-wide latent; the cohort prefill, m 512 over 512 slots,
   and a decode, m 1 over the serve's 704-slot view, split over the keys),
   bf16 on the MLA kernel (``flash_mla_kernel``, its ptxas lines printed)
   and float32 on the scalar one, and at the expanded training shape
   (192/128) on the scalar kernel, against the plain version and timed in
   turns with SDPA (``[kernels] mla`` lines); kernel path vs plain path at full width
   (float32 cut to 2 layers, 1e-5; bf16 at 8 layers within
   ``MOE_BF16_TOL``, the logits with shared expert routes); seeded random
   weights at full width and 8 of 60 layers (``MLA_LAYERS``: 58.38 GB of
   weights, what one card holds); the fused step at m 3 against the
   separate step (the bars of 6g, every flash launch ``mla``; the kernel
   at m 3 over the 704-slot view is one of the ``[kernels] mla`` cases);
   served as phase 5b serves (``serve_cell``):
   cold, warm and eager paged self-EAT serves of phase 4's traffic, warm ==
   eager bitwise, 0 captures, flash 8 ``mla`` launches per forward and
   none ``mma`` or ``scalar``, no paged read (MLA reads the gathered view),
   every entropy call mma, 3 eager and 3 warm graph serves in turns, a
   profiled serve (``[profile mla]``, with flash's share of the device
   time), a ring serve bitwise the paged one, tokens/s, chunk ms and the
   phase's peak memory;
6c. ``gemma-7b`` (arXiv:2403.08295: 28 layers, d 3072, 16 q / 16 kv heads
   of 256, GeGLU, a tied 256,000-row table; the MLA model freed first):
   the wide flash kernel (``flash_wide_kernel``, its ptxas line printed)
   at gemma-7b's and gemma-2b's prefills (g 1 and 8), timed in turns with
   SDPA, the scalar kernel forced at gemma-7b's as a yardstick;
   codeqwen1.5-7b's flash (32/32 heads of 128, ``mma``); paged at D 256
   (m 1 and 2, g 1 and 8) and codeqwen's; the entropy probe over the tied
   3072 and 2048 x 256,000 tables and codeqwen's untied 4096 x 92,416 head
   (``[kernels] gemma-7b|gemma-2b|codeqwen1.5-7b`` lines); kernel path vs
   plain path of gemma-7b (float32 cut to 2 layers, 1e-5; bf16 at 28
   layers, the logits within ``DENSE_BF16_TOL`` and the kernel path's EAT
   within ``DENSE_EAT_TOL`` nats of the same weights' in float32, flash 28
   ``wide`` on the kernel path); seeded random weights at full width and depth (8.54 B
   parameters, 17.1 GB), served as phase 5b serves (``serve_cell``):
   cold, warm and eager paged self-EAT serves of phase 4's traffic over
   its 256,000 vocabulary, warm == eager bitwise, 0 captures, flash 28
   ``wide`` per prefill and none ``scalar``, every entropy call mma, a
   profiled serve (busy share, flash's share), a ring serve bitwise the
   paged one, and the serves' peak memory against the weights; then
   ``gemma-2b`` and ``codeqwen1.5-7b`` at full width and depth, kernel
   path vs plain path only (the same bars; flash ``wide`` and ``mma``);
6d. ``zamba2-2.7b`` (arXiv:2411.15242: the hybrid, 45 Mamba2 blocks and one
   shared attention+MLP block applied 9 times on ``concat(x, emb0)``, d
   2560, 32 / 32 heads of 80, d_state 64, an untied 32,000 vocabulary; the
   gemma models freed first): flash on the ``(80, 80)`` instance of the
   tensor-core kernel at its prefill (its ptxas line printed), timed in
   turns with SDPA; paged at D 80 (m 1 and 2, g 1); the entropy probe over
   its untied 2560 x 32,000 head; the SSD scan at d_state 64, both
   variants at B 4 and B 1 (``[kernels] zamba2-2.7b`` lines); kernel path
   vs plain path (float32 cut to 12 blocks, two groups, 1e-5; bf16 at the
   full 54 on the weights of seeds 0, 1 and 2 (``HYBRID_SEEDS``), the logits
   within ``HYBRID_BF16_TOL`` and the kernel path's EAT within
   ``DENSE_EAT_TOL`` nats of float32, flash 9 ``mma`` and the scan 45
   ``mma``; where that check fails, ``hybrid_block_gap`` first prints
   where the two bf16 paths part: the residual stream's relative L2 after
   each of the 54 blocks of the prefill and of a decode step, and each
   block kind's growth factors, ``[zamba2 gap]`` lines); seeded random weights
   at full width and depth (2.08 B
   parameters, 4.17 GB), served as phase 5b serves (``serve_cell``): cold,
   warm and eager paged self-EAT serves of phase 4's traffic over its
   32,000 vocabulary, warm == eager bitwise, 0 captures, flash 9 ``mma``
   per prefill and none ``scalar``, the scan 45 ``mma`` per prefill, 9
   paged calls per decode and probe forward, every entropy call mma, a
   profiled serve, a ring serve bitwise the paged one, and the serves'
   peak memory against the weights;
6e. ``seamless-m4t-large-v2`` (arXiv:2308.11596: the encoder-decoder, 24
   encoder layers over 1024 stub frames and 24 decoder layers that
   cross-attend to them, d 1024, 16 / 16 heads of 64, GELU d_ff 8192, an
   untied 256,206 vocabulary; zamba2 freed first): the ``(64, 64)``
   instance's ptxas line (its spills), flash with ``causal=False`` at the
   encoder's self-attention (B 4, 1024 frames) and at cross-attention (m 1
   against 1024 frames, every query at position 0), each timed in turns
   with SDPA; paged at D 64 (m 1 and 2, g 1); the entropy probe over the
   untied 1024 x 256,256 head beside ``torch.matmul`` + ``logsumexp``
   (``[kernels] seamless-m4t-large-v2`` lines); kernel path vs plain path
   on frames (float32 cut to 2 + 2 layers, 1e-5; bf16 at the full 24 + 24,
   the logits within ``DENSE_BF16_TOL`` and the kernel path's EAT within
   ``DENSE_EAT_TOL`` nats of float32, flash 120 ``mma`` on the kernel
   path); seeded random weights at full width and depth (1.63 B
   parameters, 3.3 GB), reasoned as the reference serves this family
   (``reason_cell``: ``start(frames=)``, ``reason()``,
   ``force_answer(4)``; 4 rows of prompts of 128-512 tokens, a ring cache,
   budget 64, chunk 16, greedy, a probe every 8 tokens, exit at the 2nd
   evaluation): cold, warm and eager on one engine, then a second start
   with other prompts and frames through the same graphs, warm == eager
   bitwise (tokens, exits, EAT traces, answers), 0 captures and one
   snapshot per chunk warm, flash 72 ``mma`` per prefill and none
   ``scalar``, 24 flash and 24 paged calls per decode and probe forward,
   every entropy call mma, at least one EAT exit, a profiled warm reason
   and the reasons' peak memory against the weights;
6f. ``qwen2-vl-7b`` (arXiv:2409.12191: the VLM's language backbone, 28
   layers, d 3584, 28 q heads on 4 kv heads of 128 (g 7) with qkv bias,
   M-RoPE sections (16, 24, 24), an untied 152,064 vocabulary; 256 stub
   image patches per row, the vision tower a stub as in the reference; the
   encoder-decoder freed first): flash on the ``(128, 128)`` instance of
   the tensor-core kernel at the image prefill (B 4, 256 patches in slots
   before each row's pad slots, then 512 prompt slots) and at the text
   prefill, each timed in turns with SDPA; paged at g 7 (m 1 and 2); the
   entropy probe over the untied 3584 x 152,064 head beside
   ``torch.matmul`` + ``logsumexp`` (``[kernels] qwen2-vl-7b`` lines);
   kernel path vs plain path with 256 patches in front of the prompt
   (float32 cut to 2 layers, 1e-5; bf16 at the full 28, the logits within
   ``DENSE_BF16_TOL`` and the kernel path's EAT within ``DENSE_EAT_TOL``
   nats of float32, flash 28 ``mma``); seeded random weights at full width
   and depth (7.62 B parameters, 15.2 GB), served as phase 5b serves
   (``serve_cell``): cold, warm and eager paged self-EAT text serves of
   phase 4's traffic over its 152,064 vocabulary (the reference serves a
   VLM's queue text only), warm == eager bitwise, 0 captures, flash 28
   ``mma`` per prefill and none ``scalar``, 28 paged calls per decode and
   probe forward, every entropy call mma, a profiled serve, a ring serve
   bitwise the paged one; then ``reason_cell`` on image patches:
   ``start(image_embeds=)``, ``reason()``, ``force_answer(4)`` of 4 rows,
   two batches with their own seeded patches (4 x 256 x 3584) through one
   set of chunk graphs, warm == eager bitwise, 0 captures and one snapshot
   per chunk warm, flash 28 ``mma`` per prefill, 28 paged calls per
   forward, at least one EAT exit, a profiled warm reason; and the phase's
   peak memory against the weights;
7. the training path (``[train]`` lines, each with the card's name and
   power limit), the 8B model freed first: the training forward (plain
   attention, as the reference's trainer runs) against ``Model.prefill`` +
   ``logits`` on the flash kernel, same ``qwen3-1.7b`` weights, a 2 x 96
   token batch, float32 cut to 4 layers (max |diff| within 1e-5 of max
   |logits|) and bf16 at the full 28 (3e-2); the same for
   ``seamless-m4t-large-v2`` on seeded stub frames (2 x 1024 x 1024 at 0.1
   N(0, 1); float32 cut to 2 + 2 layers, bf16 at 24 + 24) and
   ``zamba2-2.7b`` (plain scan against the scan kernel; float32 cut to 12
   blocks, bf16 at 54 within ``HYBRID_BF16_TOL``); ``qwen3-1.7b``,
   ``mamba2-2.7b``, ``seamless-m4t-large-v2`` (each batch with 8 seeded
   stub frame sets of 1024 x 1024) and ``zamba2-2.7b`` in bf16 at full
   width and depth, 8 AdamW steps of 8
   ChainTask rows of 95 tokens each (remat, lr 3e-4, warmup 2): every loss,
   gradient norm and parameter finite, the last loss below the first, ms
   per step (median of steps 2-8), tokens/s, peak memory against the
   reckoned state (weights, gradients, float32 moments), and one more
   ``qwen3-1.7b`` step under the profiler (``[profile train ...]``: its top
   rows and the device's busy share; ``--profile DIR`` writes its table to
   DIR/profile_train.txt); then ``tiny-reasoner`` trained from scratch by
   ``examples/torch_train_reasoner.py``'s recipe (1200 steps of 64; the
   last loss below half the first), saved, reloaded bitwise and served
   greedy on the kernels (32 ChainTask prompts through 8 slots, paged,
   ``attn_impl="auto"``) with EAT (delta 1e-3, alpha 0.2) and with the
   token budget alone: the forced answers' accuracy, reasoning tokens,
   every request finished, and flash, paged and entropy launched during
   the EAT serve;
8. the ``[phases]`` lines: every phase's readings, then each phase's wall
   (host clock, 1 to 7, 6g after 6) and their sum; one JSON line per the contract:
   ``{"kernels": [...]}`` (five records; flash, paged and entropy carry a
   ``moe`` record: phase 5b's warm-serve launches and its kernel readings
   at the MoE's shapes, and a ``gemma`` record: phase 6c's, with gemma-2b's
   and codeqwen1.5-7b's shapes beside; flash, paged, entropy and ssd_scan a
   ``zamba2`` record: phase 6d's; flash, paged and entropy a ``seamless``
   record: phase 6e's; flash, paged and entropy a ``vlm`` record: phase
   6f's (the text serve's launches, the image reason's under
   ``image_launches``); flash an ``mla`` record: phase 6b's, with its
   kernel at m 3 under ``fused`` and the fused step's launches; paged a
   ``fused_m3`` record: phase 6g's kernel at m 3 and the 16-step program's
   launches;
   decode_attention its head-dim-256 cases under ``d256``), the card line,
   and the last line ``{"ok": true, "device": {...}}``.

Any failed check exits nonzero before the result lines are printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM (NVIDIA data sheet): HBM rate and dense peak per input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
L2_BYTES = 50 * 2**20

# kernel vs plain, on the card: both compute in float32 from the same
# inputs and differ by summation order only.  Absolute bars about ten times
# the errors read on an H100 at these shapes (PERF.md gives the readings);
# the entropy is float32 from either input type.  A bfloat16 paged output
# may differ by one rounding: one bfloat16 ulp, element by element, of the
# larger of the two outputs.  Flash attention rounds each probability to
# bfloat16 against its own running max (kv tiles of another size than the
# plain version's chunks), so each of its probabilities may differ by up to
# 2^-7 relative: its bar adds 2^-7 * sum_k p_k |v_k| / l, the attention of
# |v|, to the output ulp.  Flash-decode keeps its probabilities in float32
# as its plain version does, but splits the keys differently: where an
# output is near zero its float32 summation-order noise (up to 1.2e-7, the
# float32 readings on an H100) exceeds a bfloat16 ulp of that small value,
# so its bar adds DECODE_BF16_ATOL, about ten times that noise, to the ulp.
# The paged kernel rounds its probabilities where its plain version does,
# but folds the keys in splits and lanes: at an output near zero the plain
# version's own float32 sums may be the farther from exact.  At
# zamba2-2.7b's shapes (32 / 32 heads of 80, m 1) the two read 2 bf16 ulps
# apart at an output of ~1e-6, and against a float64 evaluation of the same
# rounding points (``paged_plain_f64``) the kernel read 0.504 ulp, the
# plain version 1.63 (an H100, phase 6d).  So a bf16 paged output that is
# not within one ulp of its plain version must be within one ulp of that
# float64 evaluation (``paged_agree``).
DECODE_BF16_ATOL = 1e-6
TOL = {("flash_attention", "float32"): 1e-5,
       ("paged_attention", "float32"): 1e-6,
       ("decode_attention", "float32"): 1e-5,
       ("entropy_probe", "float32"): 1e-5,
       ("entropy_probe", "bfloat16"): 1e-5}
# the SSD scan runs in float32 only (the model casts its inputs); kernel and
# plain version differ by summation order: the bar is 1e-5 of the largest
# output magnitude, for y and for the final state each (ROADMAP's fp32 bar)
SSD_REL_TOL = 1e-5
# mamba2-2.7b at 64 layers in bf16: the EAT of the kernel and plain paths
# (the scan is float32 on both, its output rounded to bf16; read on an
# H100: 0, and 8.2e-4 while the plain scan took two cumsums of logd)
MAMBA_EAT_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- timing


def time_ms(torch, fns, iters: int = 20, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls that cycle through ``fns``
    (closures over distinct input sets, so the working set exceeds L2)."""
    for f in fns[:warmup]:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fns, reps: int = 20) -> float:
    """Mean device ms per call of ``fns`` (one call of each) captured once
    into a CUDA graph and replayed ``reps`` times: the card's time for the
    work without the host's per-call overhead, which an eager loop of
    calls this short would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def in_turns(torch, a_fns, b_fns, rounds: int = 5, reps: int = 20):
    """``graph_ms`` of two sets of calls in turns, a, b, a, b, ... over
    ``rounds`` rounds in this call: (a's readings, b's readings)."""
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(graph_ms(torch, a_fns, reps))
        tb.append(graph_ms(torch, b_fns, reps))
    return ta, tb


def turns_text(ts) -> str:
    return f"{statistics.median(ts):.4f} ms (range {min(ts):.4f}-{max(ts):.4f})"


def device_kernels(torch, fn, sessions: int = 5) -> list[tuple[str, float]]:
    """(name, device µs) of each kernel one call of ``fn`` runs on the
    card, by torch.profiler (after one unprofiled call).  Now and then a
    session this short reads no device event at all on the card, which no
    call that launches a kernel can give: such a session is repeated, up to
    ``sessions`` in all (the list stays empty if every one is)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(e.key.removeprefix("void ").removeprefix("(anonymous namespace)::")
                    .split("<")[0].split("(")[0], e.self_device_time_total / e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   for _ in range(e.count)]
        if kernels:
            break
    return kernels


def n_sets(bytes_per_set: int) -> int:
    """Input sets to cycle through so one pass exceeds twice the L2."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(1, bytes_per_set))))


def bf16_bar_ratio(torch, out, ref, atol: float) -> float:
    """The largest |out - ref| over its bar: one bfloat16 ulp of the larger
    of the two values, plus ``atol``."""
    diff = (out.float() - ref.float()).abs()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return (diff / (ulp + atol)).max().item()


def agree(torch, name: str, dn: str, out, ref, spread=None, atol=0.0):
    """(max abs error, within the bar?, the reading and its bar as text).
    ``spread``: the attention of |v|, for the probability-rounding term;
    ``atol``: an absolute term added to the bfloat16 ulp."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if (name, dn) in TOL:
        return err, err <= TOL[name, dn], f"tol {TOL[name, dn]}"
    if atol:
        r = bf16_bar_ratio(torch, out, ref, atol)
        return err, r <= 1, f"{r:.3g} of the bar: 1 bf16 ulp + {atol:g}"
    big = torch.maximum(out.float().abs(), ref.float().abs())
    bar = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    if spread is None:
        return err, (diff <= bar).all().item(), \
            f"{(diff / bar).max().item():g} bf16 ulp, tol 1 ulp"
    bar = bar + 2.0 ** -7 * spread.float()
    r = (diff / bar).max().item()
    return err, r <= 1, f"{r:.3g} of the bar: 1 ulp + 2^-7 attention of |v|"


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ptxas_report(log: str, kernel: str) -> list[str]:
    """``nvcc -Xptxas=-v`` lines of each instantiation of ``kernel`` (a
    template or a plain function) in a build log, as "name<element type, int
    template args>: N registers, S bytes spill stores, L bytes spill
    loads"."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            name = None
            if re.search(rf"\d{kernel}[IE]", mangled):
                args = (["bf16"] if "bfloat16" in mangled else ["float"]) + \
                    re.findall(r"Li(\d+)E", mangled)
                name = f"{kernel}<{','.join(args)}>"
                out.append([name, "", ""])
        elif name and "registers" in line:
            out[-1][1] = re.search(r"Used (\d+) registers", line).group(1) + " registers"
        elif name and "spill" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[-1][2] = f"{st} B spill stores, {ld} B spill loads"
    return [f"{n}: {r}, {sp}" for n, r, sp in out]


def check_entropy_mma(what: str, counts: dict, calls: int) -> None:
    """Every entropy call of a bf16 serve is the tensor-core kernel."""
    check(calls > 0 and counts == {"mma": calls, "scalar": 0},
          f"{what}: entropy_probe calls per variant {counts}, expected all "
          f"{calls} on mma")


class Watch:
    """One engine, watched over its serves (its methods are wrapped once).
    Per serve (``begin`` to ``end``): for each tier (``executor``, and the
    ``proxy_executor`` in proxy mode) the decode or shadow chunks and the
    forced-answer rollouts it ran, each one's time on the card (CUDA events
    recorded around the call, no host read), its snapshot copies (one per chunk plus the setup's,
    checked), its chunk graphs' captures (seconds each), replays and the
    memory they added to the graph pool, the kernel launches made inside
    its calls and its model's probe calls; and the ``device_if`` predicate
    reads of the serve."""

    CHUNK = {"executor": "decode_chunk", "proxy_executor": "observe_chunk"}
    LAUNCHING = ("prefill", "rollout", "probe")

    def __init__(self, torch, eng, device_loop, kernels: dict):
        self.torch, self.device_loop, self.kernels = torch, device_loop, kernels
        self.tiers = {}
        for attr, chunk in self.CHUNK.items():
            ex = getattr(eng, attr, None)
            if ex is None:
                continue
            t = self.tiers[attr] = {"ex": ex, "chunks": [], "rollouts": [],
                                    "launches": {}, "probe_calls": 0, "depth": 0}
            for method in (chunk, *self.LAUNCHING):
                setattr(ex, method, self._wrap(t, getattr(ex, method), method))
            probe = ex.model.probe_entropy

            def counted(*a, _fn=probe, _t=t, **kw):
                _t["probe_calls"] += 1
                return _fn(*a, **kw)

            ex.model.probe_entropy = counted

    def _wrap(self, t, fn, method: str):
        torch = self.torch
        timed = ("chunks" if method in self.CHUNK.values() else
                 "rollouts" if method == "rollout" else None)

        def wrapped(*a, **kw):
            before = {n: k.launches for n, k in self.kernels.items()}
            t["depth"] += 1
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            try:
                return fn(*a, **kw)
            finally:
                t["depth"] -= 1
                if timed:
                    ev[1].record()
                    t[timed].append(ev)
                if t["depth"] == 0:
                    for n, k in self.kernels.items():
                        t["launches"][n] = (t["launches"].get(n, 0)
                                            + k.launches - before[n])

        return wrapped

    def begin(self) -> None:
        for t in self.tiers.values():
            g = t["ex"].graphs
            t.update(chunks=[], rollouts=[], launches={n: 0 for n in self.kernels},
                     probe_calls=0, reads0=t["ex"].snapshot_reads,
                     graphs0=(g.captures, len(g.capture_s), g.replays,
                              g.pool_bytes))
        self.if0 = self.device_loop.device_if.calls

    def end(self, what: str, setup_reads: int = 1) -> dict:
        """Checks one snapshot per chunk (plus the setup's, ``setup_reads``:
        a serve's one; a bare ``start()`` + ``reason()`` has none) in every
        tier; returns the serve's counts, with ``line`` the host-read
        text."""
        self.torch.cuda.synchronize()
        out, parts = {"tiers": {}}, []
        for name, t in self.tiers.items():
            g, (c0, s0, r0, p0) = t["ex"].graphs, t["graphs0"]
            reads = t["ex"].snapshot_reads - t["reads0"]
            chunks = len(t["chunks"])
            check(chunks > 0 and reads == chunks + setup_reads,
                  f"{what} {name}: {reads} snapshot reads for {chunks} chunks")
            ms = [a.elapsed_time(b) for a, b in t["chunks"]]
            rollouts = len(t["rollouts"])
            out["tiers"][name] = {
                "chunks": chunks, "snapshots": reads, "chunk_ms": ms,
                "rollout_ms": [a.elapsed_time(b) for a, b in t["rollouts"]],
                "captures": g.captures - c0, "capture_s": g.capture_s[s0:],
                "replays": g.replays - r0, "pool_bytes": g.pool_bytes - p0,
                "keys": len(g), "rollout_keys": rollout_keys(g),
                "rollouts": rollouts, "launches": dict(t["launches"]),
                "probe_calls": t["probe_calls"]}
            parts.append(
                f"{name} {chunks} chunks ({statistics.median(ms):.2f} ms each, "
                f"median on the card; range {min(ms):.2f}-{max(ms):.2f}), "
                f"{rollouts} rollouts, "
                f"{reads} snapshot reads ({(reads - setup_reads) / chunks:.1f} per "
                f"chunk after the setup's), {g.replays - r0} graph replays, "
                f"{g.captures - c0} captures")
        out["device_if"] = self.device_loop.device_if.calls - self.if0
        n = sum(v["chunks"] for v in out["tiers"].values())
        out["line"] = (f"{'; '.join(parts)}; {out['device_if']} device_if "
                       f"predicate reads ({out['device_if'] / n:.1f} per chunk)")
        return out


def rollout_keys(graphs) -> int:
    """The rollout programs among a runner's graph keys (the rest are
    chunks)."""
    return sum(key[0][0] == "rollout" for key in graphs.keys())


def graph_line(what: str, st: dict) -> str:
    """A serve's graph work: captures with their seconds, graph keys (chunk
    and rollout), replays and the pool memory the captures added, per
    tier."""
    parts = []
    for name, t in st["tiers"].items():
        cs = ", ".join(f"{x:.2f}" for x in t["capture_s"]) or "none"
        parts.append(f"{name} {t['captures']} captures ({cs} s), {t['keys']} "
                     f"graph keys ({t['keys'] - t['rollout_keys']} chunk, "
                     f"{t['rollout_keys']} rollout), {t['replays']} replays, pool +"
                     f"{t['pool_bytes'] / 2**20:.1f} MiB")
    return f"[graphs] {what}: " + "; ".join(parts)


def result_diff(a: list, b: list, np, *, slots: bool = True) -> str:
    """Empty where two serves' tokens, exits, answers and EAT traces (and
    slots) are equal; else the first request and field that differ."""
    if len(a) != len(b):
        return f"{len(a)} results against {len(b)}"
    fields = ("n_reasoning", "exit_reason", "slot", "reasoning_tokens",
              "answer_tokens", "eat_trace")
    for i, (x, y) in enumerate(zip(a, b)):
        for f in fields:
            if f == "slot" and not slots:
                continue
            u, v = x[f], y[f]
            if f == "eat_trace" and u != v:
                j = next((j for j, (p, q) in enumerate(zip(u, v)) if p != q),
                         min(len(u), len(v)))
                return (f"request {i}: eat_trace, {len(u)} against {len(v)} records, "
                        f"first apart at record {j}: "
                        f"{u[j] if j < len(u) else None} against "
                        f"{v[j] if j < len(v) else None}")
            if f != "eat_trace" and not np.array_equal(u, v):
                return f"request {i}: {f}, {u} against {v}"
    return ""


def check_same(a: list, b: list, np, msg: str, *, slots: bool = True) -> None:
    """``check`` that two serves' results are equal (``result_diff``); the
    failure names the first request and field that differ."""
    diff = result_diff(a, b, np, slots=slots)
    check(not diff, f"{msg} ({diff})")


def reset_counts(kernels: dict) -> None:
    """Every launch count to 0 (the flash kernel's per-variant counts too)."""
    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches.update({v: 0 for v in fn.variant_launches})


# --------------------------------------------------------------- phase 3 cases


def flash_case(torch, dtype, seed=0, B=4, S=512, Hq=32, Hkv=8, D=128):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, Hq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(dtype)
    # left-padded prompts, as prefill sees them: row b has 64*b pad slots
    ar = torch.arange(S, device="cuda", dtype=torch.int32)
    pad = torch.arange(B, device="cuda", dtype=torch.int32)[:, None] * 64
    pos = torch.where(ar[None] >= pad, ar[None] - pad, -1).to(torch.int32).contiguous()
    return dict(q=q, k=k, v=v, q_pos=pos, kv_pos=pos)


def paged_case(torch, pa, dtype, m, seed=0, B=4, Hq=32, Hkv=8, D=128, ps=16,
               n_mapped=40, step=2):
    """Rows of n_mapped - step*b mapped pages (shuffled physical ids, a
    partial last page) at 8B width, with m query positions at the end of
    each row: the decode (m=1) and probe (m=2) reads.  Logical blocks
    [2K, 4K) of every row are unmapped (K = the kernel's split length), so
    two whole splits are empty on the paged side and masked on the ring
    side.  Returns the kernel's arguments and the matching dense ring."""
    K = pa.split_plan(ps, 1)[0]               # logical blocks per split
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = n_mapped + 2 * K + 4                 # logical blocks per row
    P = B * NB + 1
    k_pool = torch.randn((P, ps, Hkv, D), generator=g, device="cuda").to(dtype)
    v_pool = torch.randn((P, ps, Hkv, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    pages = torch.zeros((B, n_mapped), dtype=torch.int32, device="cuda")
    logical = torch.zeros_like(pages)
    counts = torch.zeros((B,), dtype=torch.int32, device="cuda")
    kv_pos = torch.full((B, NB * ps), -1, dtype=torch.int32, device="cuda")
    k_ring = torch.zeros((B, NB * ps, Hkv, D), dtype=dtype, device="cuda")
    v_ring = torch.zeros_like(k_ring)
    q_pos = torch.zeros((B, m), dtype=torch.int32, device="cuda")
    for b in range(B):
        nb = n_mapped - step * b
        blocks = list(range(2 * K)) + list(range(4 * K, 4 * K + nb - 2 * K))
        n_tok = nb * ps - 5                    # partial last page
        pages[b, :nb] = perm[b * NB:b * NB + nb].to(torch.int32)
        logical[b, :nb] = torch.tensor(blocks, dtype=torch.int32, device="cuda")
        counts[b] = nb
        slots = (torch.tensor(blocks, device="cuda")[:, None] * ps
                 + torch.arange(ps, device="cuda")).reshape(-1)[:n_tok]
        kv_pos[b, slots] = torch.arange(n_tok, dtype=torch.int32, device="cuda")
        for r, blk in enumerate(blocks):
            k_ring[b, blk * ps:(blk + 1) * ps] = k_pool[pages[b, r].long()]
            v_ring[b, blk * ps:(blk + 1) * ps] = v_pool[pages[b, r].long()]
        q_pos[b] = torch.arange(n_tok - m, n_tok, dtype=torch.int32, device="cuda")
    bpos = pa.block_positions(kv_pos, pages, logical, ps).contiguous()
    q = torch.randn((B, m, Hq, D), generator=g, device="cuda").to(dtype)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, pages=pages, counts=counts,
                bpos=bpos, q_pos=q_pos, logical=logical,
                num_blocks=NB), (k_ring, v_ring, kv_pos)


def entropy_case(torch, dtype, B, d, Vp, vocab, tied):
    """h (B, d) and the unembedding w (d, Vp) at a model's width: untied, or
    for a tied config the transposed view of a (Vp, d) table."""
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn((B, d), generator=g, device="cuda").to(dtype)
    shape = (Vp, d) if tied else (d, Vp)
    w = (torch.randn(shape, generator=g, device="cuda") * (2.0 / d ** 0.5)).to(dtype)
    return dict(h=h, w=w.t() if tied else w, vocab=vocab)


# the entropy probe's phase-3 cases: (what, dtype name, B, d, Vp, vocab,
# tied): eat-paper-8b at the serve's 4 slots and at 32, qwen3-1.7b's tied
# table, mamba2-2.7b's; float32 at 8B width on the scalar kernel
ENTROPY_CASES = [
    ("eat-paper-8b", "bfloat16", 4, 4096, 152_064, 151_936, False),
    ("eat-paper-8b", "bfloat16", 32, 4096, 152_064, 151_936, False),
    ("qwen3-1.7b", "bfloat16", 4, 2048, 152_064, 151_936, True),
    ("mamba2-2.7b", "bfloat16", 4, 2560, 50_432, 50_280, False),
    ("eat-paper-8b", "float32", 4, 4096, 152_064, 151_936, False),
    ("eat-paper-8b", "float32", 32, 4096, 152_064, 151_936, False),
]


def entropy_check(torch, ep, ptxas):
    """Phase 3, the entropy probe: each case of ENTROPY_CASES against the
    plain version through the variant ``ep.entropy_variant`` picks (bf16:
    the tensor-core kernel, checked) and, for bf16, both variants forced;
    the kernels of one mma call by the profiler (two); both variants by
    CUDA-graph replay in turns (5 rounds, medians), the routed call eager,
    the plain version, ``torch.matmul(h, w)`` in bf16 by graph replay as a
    yardstick of part of the work (it writes the logits and computes no
    entropy) and the byte bound.  ``ptxas``: the lines of its kernels.
    Returns the record of the bf16 eat-paper-8b B 4 case, its error the
    largest of the bf16 cases'."""
    for line in ptxas:
        print(f"[kernels] entropy_probe ptxas {line}")
    bad, rec, err_bf16 = [], None, 0.0
    for what, dn, B, d, Vp, vocab, tied in ENTROPY_CASES:
        dtype = getattr(torch, dn)
        c = entropy_case(torch, dtype, B=B, d=d, vocab=vocab, Vp=Vp, tied=tied)
        h, w = c["h"], c["w"]
        variant = ep.entropy_variant(h, w)
        want = "mma" if dn == "bfloat16" else "scalar"
        if variant != want:
            bad.append(f"entropy_probe {what} {dn} B{B}: routes to {variant}, not {want}")
        ref = ep.next_token_entropy_plain(h, w, vocab)
        variants = ("mma", "scalar") if variant == "mma" else ("scalar",)
        errs = {}
        for v in variants:
            out = ep.entropy_probe_cuda(h, w, vocab, variant=v)
            errs[v], ok, tol = agree(torch, "entropy_probe", dn, out, ref)
            if not (ok and bool(torch.isfinite(out).all())
                    and float(out.max()) <= math.log(vocab)):
                bad.append(f"entropy_probe {what} {dn} B{B} {v}: max abs err "
                           f"{errs[v]:.3e} ({tol}), entropies {out.tolist()[:4]}...")
        if dn == "bfloat16":
            err_bf16 = max(err_bf16, errs[variant])
        calls = {v: [lambda v=v: ep.entropy_probe_cuda(h, w, vocab, variant=v)]
                 for v in variants}
        if variant == "mma":
            kernels = device_kernels(torch, calls["mma"][0])
            if len(kernels) != ep.KERNELS_PER_CALL["mma"]:
                bad.append(f"entropy_probe {what} B{B}: one mma call ran {kernels}")
            m_turns, s_turns = in_turns(torch, calls["mma"], calls["scalar"])
            timed = (f"graph replay in turns, 5 rounds: mma {turns_text(m_turns)}, "
                     f"scalar {turns_text(s_turns)}, mma / scalar "
                     f"{statistics.median(m_turns) / statistics.median(s_turns):.3f}; "
                     f"one mma call = {len(kernels)} kernels ("
                     + ", ".join(f"{n} {us:.1f} us" for n, us in kernels) + ", profiled)")
            k_ms = statistics.median(m_turns)
        else:
            k_ms = graph_ms(torch, calls["scalar"])
            timed = f"scalar {k_ms:.4f} ms (graph replay)"
        eager = time_ms(torch, [lambda: ep.entropy_probe_cuda(h, w, vocab)])
        p_ms = time_ms(torch, [lambda: ep.next_token_entropy_plain(h, w, vocab)], iters=6)
        mm_ms = graph_ms(torch, [lambda: torch.matmul(h, w)]) if dn == "bfloat16" else None
        b_ms, b_by = bound_ms(nbytes(h, w) + 4 * B, 2 * B * d * Vp, dn)
        print(f"[kernels] entropy_probe {what} {dn} B{B} d{d} Vp{Vp} vocab {vocab} "
              f"{'tied (Vp, d) table, transposed view' if tied else 'untied (d, Vp)'}: "
              f"variant {variant}; max_abs_err "
              + ", ".join(f"{v} {e:.3e}" for v, e in errs.items())
              + f" (tol {TOL['entropy_probe', dn]:g}); {timed}; eager {eager:.4f} ms; "
              f"plain {p_ms:.4f} ms; "
              + (f"matmul yardstick {mm_ms:.4f} ms (graph replay; logits only); "
                 if mm_ms is not None else "")
              + f"bound {b_ms:.4f} ms ({b_by}: {nbytes(h, w) / 1e6:.1f} MB), kernel at "
              f"{b_ms / k_ms:.3f} of it")
        if (what, dn, B) == ("eat-paper-8b", "bfloat16", 4):
            rec = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, variant=variant)
        del c, h, w, ref, calls
        torch.cuda.empty_cache()
    check(not bad, "; ".join(bad))
    rec["max_abs_err"] = err_bf16
    return rec


def valid_pairs(torch, q_pos, kv_pos, window=0):
    """(query, key) pairs a causal read must score: the data's own count."""
    qp, kp = q_pos[:, :, None].long(), kv_pos[:, None, :].long()
    valid = (kp >= 0) & (kp <= qp) & (qp >= 0)
    if window:
        valid &= (qp - kp) < window
    return int(valid.sum())


def kernel_checks(torch, F, fa, pa, flash_ptxas, paged_ptxas):
    """Phase 3.  Returns {kernel name: record} for the bf16 main-path case
    and prints every comparison; fails after all of them if any disagreed.
    ``flash_ptxas`` / ``paged_ptxas``: the ptxas lines of the flash and
    paged kernels, printed with their lines."""
    rec, bad = {}, []
    scale = 1.0 / math.sqrt(128)

    def held(ok: bool, what: str) -> None:
        if not ok:
            bad.append(what)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]

        # ---------------- flash attention (prefill)
        c = flash_case(torch, dtype)
        args = (c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
        variant = fa.flash_variant(dtype, 128, 128)
        before = dict(fa.flash_attention_cuda.variant_launches)
        out = fa.flash_attention_cuda(*args, scale=scale)
        after = fa.flash_attention_cuda.variant_launches
        held({x: after[x] - before[x] for x in after} == {x: int(x == variant) for x in after},
             f"flash_attention {dn}: launched {after} (before {before}), not one {variant}")
        ref = fa.attention_plain(*args, scale=scale)
        spread = (fa.attention_plain(c["q"], c["k"], c["v"].abs(), c["q_pos"],
                                     c["kv_pos"], scale=scale)
                  if dtype == torch.bfloat16 else None)
        err, ok, tol = agree(torch, "flash_attention", dn, out, ref, spread)
        held(ok, f"flash_attention {dn}: max abs err {err:.3e} ({tol})")
        per_set = nbytes(*args) + nbytes(out)
        sets = [flash_case(torch, dtype, seed=s) for s in range(n_sets(per_set))]
        k_ms = time_ms(torch, [lambda s=s: fa.flash_attention_cuda(
            s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale) for s in sets])
        p_ms = time_ms(torch, [lambda s=s: fa.attention_plain(
            s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale)
            for s in sets], iters=6)
        # the library yardstick: SDPA over (B, H, S, D) with a boolean mask
        # built outside the timed call from the same positions
        B, S, Hq, D = c["q"].shape
        mask = ((c["kv_pos"][:, None, None, :] >= 0)
                & (c["kv_pos"][:, None, None, :] <= c["q_pos"][:, None, :, None]))
        lib_sets = [(s["q"].transpose(1, 2), s["k"].transpose(1, 2).repeat_interleave(4, 1),
                     s["v"].transpose(1, 2).repeat_interleave(4, 1)) for s in sets]
        lib_calls = [lambda t=t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], attn_mask=mask, scale=scale) for t in lib_sets]
        l_ms = time_ms(torch, lib_calls)
        pairs = valid_pairs(torch, c["q_pos"], c["kv_pos"]) * Hq
        b_ms, b_by = bound_ms(per_set, pairs * 4 * D, dn)
        print(f"[kernels] flash_attention {dn} B{B} S{S} Hq{Hq} Hkv8 D{D} variant "
              f"{variant}: max_abs_err {err:.3e} ({tol}) kernel {k_ms:.4f} ms "
              f"plain {p_ms:.4f} ms sdpa {l_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})"
              f"{' (eager)' if dtype == torch.bfloat16 else ''}")
        if dtype == torch.bfloat16:
            # the tensor-core kernel against SDPA by graph replay, in turns
            k_turns, l_turns = in_turns(torch, [lambda s=s: fa.flash_attention_cuda(
                s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale)
                for s in sets], lib_calls)
            print(f"[kernels] flash_attention {dn} graph replay in turns, 5 rounds: "
                  f"kernel {turns_text(k_turns)}, sdpa {turns_text(l_turns)}; "
                  f"kernel / sdpa {statistics.median(k_turns) / statistics.median(l_turns):.3f}")
            for line in flash_ptxas:
                print(f"[kernels] flash_attention ptxas {line}")
            rec["flash_attention"] = dict(
                max_abs_err=err, ms=statistics.median(k_turns), plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=statistics.median(l_turns),
                variant=variant)
        del sets, lib_sets

        # ---------------- paged decode attention: the decode (m=1) and probe
        # (m=2) reads over ~40 pages per row, and a decode over 128 pages
        for m, n_mapped, step in ((1, 40, 2), (2, 40, 2), (1, 128, 0)):
            c, (k_ring, v_ring, kv_pos) = paged_case(torch, pa, dtype, m,
                                                     n_mapped=n_mapped, step=step)
            pargs = (c["q"], c["k_pool"], c["v_pool"], c["pages"], c["counts"],
                     c["bpos"], c["q_pos"])
            split = dict(logical=c["logical"], num_blocks=c["num_blocks"])
            out = pa.paged_attention_cuda(*pargs, scale=scale, **split)
            ref = pa.paged_attention_plain(*pargs, scale=scale)
            ring = pa.ring_decode_attention(c["q"], k_ring, v_ring, c["q_pos"],
                                            kv_pos, page_size=16, scale=scale,
                                            impl="cuda")
            what = f"paged_attention {dn} m={m} pages/row {n_mapped}"
            err, ok, tol = paged_agree(torch, c, scale, out, ref)
            held(ok, f"{what}: max abs err {err:.3e} ({tol})")
            held(torch.equal(out, ring), f"{what}: paged != ring bitwise")
            mapped = int(c["counts"].sum())
            B, _, Hq, D = c["q"].shape
            Pz, ps, Hkv, _ = c["k_pool"].shape
            K, n_split = pa.split_plan(ps, c["num_blocks"])
            per_set = (2 * mapped * ps * Hkv * D * c["k_pool"].element_size()
                       + nbytes(c["q"], c["pages"], c["logical"], c["counts"],
                                c["bpos"], c["q_pos"]) + nbytes(out))
            cases = [paged_case(torch, pa, dtype, m, seed=i, n_mapped=n_mapped, step=step)
                     for i in range(n_sets(nbytes(c["k_pool"], c["v_pool"])))]
            sets = [cs for cs, _ in cases]
            calls = [lambda s=s: pa.paged_attention_cuda(
                s["q"], s["k_pool"], s["v_pool"], s["pages"], s["counts"],
                s["bpos"], s["q_pos"], scale=scale, logical=s["logical"],
                num_blocks=s["num_blocks"]) for s in sets]
            k_ms = graph_ms(torch, calls)
            eager_ms = time_ms(torch, calls, iters=50)
            p_ms = time_ms(torch, [lambda s=s: pa.paged_attention_plain(
                s["q"], s["k_pool"], s["v_pool"], s["pages"], s["counts"],
                s["bpos"], s["q_pos"], scale=scale) for s in sets], iters=6)
            # a yardstick of another layout: SDPA over the dense ring of the
            # same keys (K/V repeated per q head, the boolean mask built
            # outside the timed call); no single PyTorch call reads pages
            g = Hq // Hkv
            lib_sets = [(cs["q"].transpose(1, 2),
                         kr.transpose(1, 2).repeat_interleave(g, 1),
                         vr.transpose(1, 2).repeat_interleave(g, 1),
                         ((kp[:, None, :] >= 0)
                          & (kp[:, None, :] <= cs["q_pos"][:, :, None]))[:, None])
                        for cs, (kr, vr, kp) in cases]
            l_ms = graph_ms(torch, [lambda t=t: F.scaled_dot_product_attention(
                t[0], t[1], t[2], attn_mask=t[3], scale=scale) for t in lib_sets])
            flat_pos = c["bpos"].reshape(c["bpos"].shape[0], -1)
            pairs = valid_pairs(torch, c["q_pos"], flat_pos) * Hq
            b_ms, b_by = bound_ms(per_set, pairs * 4 * D, dn)
            print(f"[kernels] paged_attention {dn} B{B} m{m} Hq{Hq} Hkv{Hkv} D{D} ps{ps} "
                  f"pages {mapped} of {B * c['num_blocks']} logical blocks: K {K} "
                  f"blocks/split, n_split {n_split}, grid ({B * Hkv}, {n_split}) x2 + "
                  f"merge ({B * Hkv}, {-(-m * Hq // Hkv * D // 128)}): "
                  f"max_abs_err {err:.3e} ({tol}) "
                  f"paged==ring bitwise; kernel {k_ms:.4f} ms (graph replay; eager "
                  f"{eager_ms:.4f} ms) plain {p_ms:.4f} ms bound {b_ms:.4f} ms "
                  f"({b_by}: {per_set / 1e6:.1f} MB); yardstick of another layout, "
                  f"dense-ring sdpa {l_ms:.4f} ms (graph replay)")
            if dtype == torch.bfloat16 and (m, n_mapped) == (1, 40):
                rec["paged_attention"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                              bound_ms=b_ms, bound_by=b_by,
                                              library_ms=None)
            elif dtype == torch.bfloat16:
                rec["paged_attention"]["max_abs_err"] = max(
                    rec["paged_attention"]["max_abs_err"], err)
            del cases, sets, lib_sets
        if dtype == torch.bfloat16:
            for line in paged_ptxas:
                print(f"[kernels] paged_attention ptxas {line}")

        torch.cuda.empty_cache()
    check(not bad, "kernel vs plain: " + "; ".join(bad))
    return rec


def decode_case(torch, dtype, m, seed=0, B=4, C=4096, Hq=32, Hkv=8, D=128):
    """A dense ring cache at eat-paper-8b decode width: row b holds
    positions 0..n_b-1 from a random ring offset with about 10% of its
    slots empty (-1), and m query positions at its end."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, m, Hq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, C, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, C, Hkv, D), generator=g, device="cuda").to(dtype)
    kv_pos = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
    q_pos = torch.zeros((B, m), dtype=torch.int32, device="cuda")
    for b in range(B):
        n = C - C // 10 - 8 * b
        rot = int(torch.randint(C, (1,), generator=g, device="cuda"))
        slots = (rot + torch.arange(n, device="cuda")) % C
        kv_pos[b, slots] = torch.arange(n, dtype=torch.int32, device="cuda")
        q_pos[b] = torch.arange(n - m, n, dtype=torch.int32, device="cuda")
    return dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)


def decode_check(torch, F, da, ptxas):
    """Phase 3, flash-decode: the op's entry point (the kernel on the card)
    against the plain version at the 8B decode shapes (m 1, 2, 8 in bf16
    and float32, window 0; bf16 m 1 with window 1024), each case's variant
    checked (bf16 at D 128: the tensor-core kernel) and a call's kernels
    counted by the profiler (two: the split kernel and the merge); then the
    kernel and SDPA by CUDA-graph replay in turns, 5 rounds, with eager
    readings beside, the plain version and the bound per case.  ``ptxas``:
    the lines of its kernels.  Then Gemma's head dim, 256 (the scalar
    kernel, its K and V tiles in one buffer), bf16 and float32 at m 1 over
    the same cache length: gemma-7b's 16 q / 16 kv heads (g 1) and
    gemma-2b's 8 on 1 (g 8), checked and timed the same way (the record's
    ``d256`` entries).  No serve path calls it: its launches are
    counted over this phase.  Returns (record, launches)."""
    # (dtype, m, window, Hq, Hkv, D)
    cases = [(dt, m, 0, 32, 8, 128) for dt in (torch.bfloat16, torch.float32)
             for m in (1, 2, 8)] + [(torch.bfloat16, 1, 1024, 32, 8, 128)]
    cases += [(dt, 1, 0, Hq, Hkv, 256) for dt in (torch.bfloat16, torch.float32)
              for Hq, Hkv in ((16, 16), (8, 1))]
    bad, rec, err_bf16, d256 = [], None, 0.0, {}
    reset_counts({"decode_attention": da.decode_attention_cuda})
    outs = []
    for dtype, m, window, Hq, Hkv, D in cases:
        c = decode_case(torch, dtype, m, Hq=Hq, Hkv=Hkv, D=D)
        outs.append(da.decode_attention(c["q"], c["k"], c["v"], c["q_pos"],
                                        c["kv_pos"], window=window,
                                        scale=1.0 / math.sqrt(D)))
    launches = da.decode_attention_cuda.launches
    variants = dict(da.decode_attention_cuda.variant_launches)
    want = {v: sum(da.decode_variant(dt, D, D) == v for dt, _, _, _, _, D in cases)
            for v in variants}
    check(launches == len(cases) and variants == want and want["mma"] == 4,
          f"decode_attention: {launches} launches through the op for "
          f"{len(cases)} calls on the card, per variant {variants}, expected {want}")
    for line in ptxas:
        print(f"[kernels] decode_attention ptxas {line}")
    for (dtype, m, window, Hq, Hkv, D), out in zip(cases, outs):
        dn = str(dtype).split(".")[-1]
        variant = da.decode_variant(dtype, D, D)
        scale = 1.0 / math.sqrt(D)
        c = decode_case(torch, dtype, m, Hq=Hq, Hkv=Hkv, D=D)
        args = (c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
        ref = da.decode_attention_plain(*args, window=window, scale=scale)
        err, ok, tol = agree(torch, "decode_attention", dn, out, ref,
                             atol=DECODE_BF16_ATOL)
        ratio = (bf16_bar_ratio(torch, out, ref, DECODE_BF16_ATOL)
                 if dtype == torch.bfloat16 else err / TOL["decode_attention", dn])
        if not (ok and bool(torch.isfinite(out).all())):
            bad.append(f"decode_attention {dn} m={m} window={window}: max abs err "
                       f"{err:.3e} ({tol})")
        if dtype == torch.bfloat16 and D == 128:
            err_bf16 = max(err_bf16, err)
        kernels = device_kernels(torch, lambda: da.decode_attention_cuda(
            *args, window=window, scale=scale))
        if len(kernels) != 2:
            bad.append(f"decode_attention {dn} m={m}: one call ran {kernels}, "
                       f"not two kernels")
        B, _, Hq, D = c["q"].shape
        C, Hkv = c["k"].shape[1:3]
        n_split, split_len = da.decode_attention_cuda.last_split  # the profiled call's
        # the bytes the data needs: K and V of every slot some query may
        # attend, q, the output and the positions
        qp, kp = c["q_pos"][:, :, None], c["kv_pos"][:, None, :]
        valid = (kp >= 0) & (kp <= qp)
        if window:
            valid &= (qp - kp) < window
        keys = int(valid.any(dim=1).sum())
        per_set = (keys * Hkv * 2 * D * c["k"].element_size()
                   + nbytes(c["q"], out, c["q_pos"], c["kv_pos"]))
        sets = [c] + [decode_case(torch, dtype, m, seed=s, Hq=Hq, Hkv=Hkv, D=D)
                      for s in range(1, n_sets(nbytes(c["k"], c["v"])))]
        calls = [lambda s=s: da.decode_attention_cuda(
            s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], window=window,
            scale=scale) for s in sets]
        p_ms = time_ms(torch, [lambda s=s: da.decode_attention_plain(
            s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], window=window,
            scale=scale) for s in sets], iters=6)
        # the library yardstick: SDPA over (B, Hq, ., D), K/V repeated per q
        # head and the boolean mask built outside the timed call
        g = Hq // Hkv
        lib_sets = [(s["q"].transpose(1, 2), s["k"].transpose(1, 2).repeat_interleave(g, 1),
                     s["v"].transpose(1, 2).repeat_interleave(g, 1), valid[:, None])
                    for s in sets]
        lib_calls = [lambda t=t: F.scaled_dot_product_attention(
            t[0], t[1], t[2], attn_mask=t[3], scale=scale) for t in lib_sets]
        k_turns, l_turns = in_turns(torch, calls, lib_calls)
        k_ms, l_ms = statistics.median(k_turns), statistics.median(l_turns)
        k_eager = time_ms(torch, calls, iters=50)
        l_eager = time_ms(torch, lib_calls, iters=50)
        pairs = valid_pairs(torch, c["q_pos"], c["kv_pos"], window) * Hq
        b_ms, b_by = bound_ms(per_set, pairs * 4 * D, dn)
        print(f"[kernels] decode_attention {dn} B{B} m{m} Hq{Hq} Hkv{Hkv} D{D} "
              f"C{C} window {window} variant {variant}, n_split {n_split} x "
              f"{split_len} keys, one call = {len(kernels)} kernels ("
              + ", ".join(f"{n} {us:.1f} us" for n, us in kernels)
              + f", profiled): "
              f"max_abs_err {err:.3e} ({tol}), worst ratio to its bar {ratio:.3f}; "
              f"graph replay in turns, 5 rounds: kernel {turns_text(k_turns)}, "
              f"sdpa {turns_text(l_turns)}, kernel / sdpa {k_ms / l_ms:.3f}; eager: "
              f"kernel {k_eager:.4f} ms, sdpa {l_eager:.4f} ms; plain {p_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {per_set / 1e6:.1f} MB)")
        if (dtype, m, window, D) == (torch.bfloat16, 1, 0, 128):
            rec = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=l_ms, variant=variant)
        elif D == 256:
            d256[f"{dn} Hq{Hq} Hkv{Hkv}"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms, variant=variant)
        del sets, lib_sets, c, ref
    del outs
    torch.cuda.empty_cache()
    check(not bad, "; ".join(bad))
    rec["max_abs_err"] = err_bf16
    rec["d256"] = d256
    return rec, launches


def ssd_case(torch, seed=0, B=4, S=512, nh=80, hp=64, G=1, N=128, h0=True):
    """Scan inputs at mamba2-2.7b's prefill shapes, shaped as ssm_forward
    makes them: logd = -dt * (h + 1) with dt in [1e-3, 1e-1] (A = -exp(A_log)
    runs to -80, so the later heads' exp(cumsum) underflows over a chunk)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((B, S, nh), generator=g, device="cuda") * (hi - lo) + lo)
    c = dict(u=torch.randn((B, S, nh, hp), generator=g, device="cuda") * 0.3,
             logd=-dt * torch.arange(1, nh + 1, device="cuda"),
             Bm=torch.randn((B, S, G, N), generator=g, device="cuda") * 0.4,
             Cm=torch.randn((B, S, G, N), generator=g, device="cuda") * 0.4)
    c["h0"] = (torch.randn((B, nh, N, hp), generator=g, device="cuda") * 0.2
               if h0 else None)
    return c


def ssd_check(torch, ss, ptxas, L=128, N=128, tag="mamba2-2.7b"):
    """Phase 3, the SSD scan: the scan against its plain version at the main-path
    prefill shapes, initial state zero (None) and nonzero, through each
    variant (``ss.ssd_variant`` must pick the tensor cores at these shapes);
    the kernels of one call by the profiler; then, at the serve's own calls
    (the cache's state passed as h0) at B 4 and B 1, S 512, both variants by
    CUDA-graph replay in turns (5 rounds, medians; eager beside), the plain
    version, the tensor-core bound (3xTF32: three products per product at
    the TF32 rate) and the float32-FMA bound of the function's work, and
    both for the TPU kernel's work (C B^T per head) beside.  ``ptxas``: the
    lines of the scan's kernels.  ``N``, ``tag``: the d_state and the model
    (mamba2-2.7b's 128; zamba2-2.7b's 64, phase 6d).  Returns the record of
    the variant the op picks at B 4."""
    hp = 64
    variant = ss.ssd_variant(L, N, hp)
    check(variant == "mma", f"ssd_scan: {tag}'s shapes route to {variant}")
    for line in ptxas:
        print(f"[kernels] ssd_scan ptxas {line}")
    bad, err = [], 0.0
    for with_h0 in (False, True):
        c = ssd_case(torch, seed=int(with_h0), h0=with_h0, N=N)
        args = (c["u"], c["logd"], c["Bm"], c["Cm"])
        ref = ss.ssd_scan_plain(*args, chunk=L, h0=c["h0"])
        for v in ss.KERNELS_PER_CALL:
            out = ss.ssd_scan_cuda(*args, chunk=L, h0=c["h0"], variant=v)
            for what, o, r in zip(("y", "h_final"), out, ref):
                e = (o - r).abs().max().item()
                bar = SSD_REL_TOL * r.abs().max().item()
                if not (bool(torch.isfinite(o).all()) and e <= bar):
                    bad.append(f"ssd_scan {v} h0={with_h0} {what}: max abs err "
                               f"{e:.3e} > {bar:.3e}")
                if what == "y" and v == variant:
                    err = max(err, e)
                print(f"[kernels] {tag} ssd_scan float32 B4 S512 nh80 hp64 G1 N{N} L{L} "
                      f"variant {v} h0={'nonzero' if with_h0 else 'none'} {what}: "
                      f"max_abs_err {e:.3e} (tol {SSD_REL_TOL:g} x max|{what}| = "
                      f"{bar:.3e}; {e / bar:.3f} of it)")
            del out
        del ref
    check(not bad, "; ".join(bad))
    rec = None
    for B in (4, 1):
        c = ssd_case(torch, seed=2, B=B, N=N)
        args = (c["u"], c["logd"], c["Bm"], c["Cm"])
        S, nh = c["u"].shape[1:3]
        y, hf = ss.ssd_scan_cuda(*args, chunk=L, h0=c["h0"])
        per_set = nbytes(*args, c["h0"], y, hf)
        sets = [c] + [ssd_case(torch, seed=s, B=B, N=N)
                      for s in range(3, 2 + n_sets(per_set))]
        calls = {v: [lambda s=s, v=v: ss.ssd_scan_cuda(
            s["u"], s["logd"], s["Bm"], s["Cm"], chunk=L, h0=s["h0"], variant=v)
            for s in sets] for v in ss.KERNELS_PER_CALL}
        kernels = {v: device_kernels(torch, calls[v][0]) for v in calls}
        for v, ks in kernels.items():
            if len(ks) != ss.KERNELS_PER_CALL[v]:
                bad.append(f"ssd_scan {v} B{B}: one call ran {ks}, not "
                           f"{ss.KERNELS_PER_CALL[v]} kernels")
        m_turns, s_turns = in_turns(torch, calls["mma"], calls["scalar"])
        eager = {v: time_ms(torch, calls[v]) for v in calls}
        p_ms = time_ms(torch, [lambda s=s: ss.ssd_scan_plain(
            s["u"], s["logd"], s["Bm"], s["Cm"], chunk=L, h0=s["h0"]) for s in sets],
            iters=6)
        # the function's work: per (b, group, chunk of l steps), C B^T over
        # the causal triangle, l (l + 1) / 2 entries at 2 N FLOPs (G = 1:
        # every head shares it); per (b, head, chunk), its product with U at
        # 2 hp FLOPs an entry, C h_prev and the state update 2 l N hp each.
        # A partial last chunk counts at its own length.  The TPU kernel
        # (and the scalar variant) computes C B^T per head: its work is
        # printed beside, as a yardstick.
        lens = [min(L, S - c0) for c0 in range(0, S, L)]
        cb_flops = B * sum(l * (l + 1) * N for l in lens)
        flops = cb_flops + B * nh * sum(l * (l + 1) * hp + 4 * l * N * hp for l in lens)
        tpu_flops = flops + (nh - 1) * cb_flops
        b_ms, b_by = bound_ms(per_set, 3 * flops, "tf32")
        f_ms, f_by = bound_ms(per_set, flops, "float32")
        t_ms, _ = bound_ms(per_set, 3 * tpu_flops, "tf32")
        tf_ms, _ = bound_ms(per_set, tpu_flops, "float32")
        m_ms, s_ms = statistics.median(m_turns), statistics.median(s_turns)
        print(f"[kernels] {tag} ssd_scan float32 B{B} S{S} nh{nh} hp{hp} G1 N{N} L{L} "
              f"h0=nonzero: graph replay in turns, 5 rounds: mma {turns_text(m_turns)}, "
              f"scalar {turns_text(s_turns)}, mma / scalar {m_ms / s_ms:.3f}; eager: "
              f"mma {eager['mma']:.4f} ms, scalar {eager['scalar']:.4f} ms; plain "
              f"{p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: 3 x {flops / 1e9:.2f} "
              f"GFLOP at the TF32 rate, {per_set / 1e6:.1f} MB), float32-FMA bound "
              f"{f_ms:.4f} ms ({f_by}); the TPU kernel's work (C B^T per head, "
              f"{tpu_flops / 1e9:.2f} GFLOP): 3xTF32 {t_ms:.4f} ms, float32-FMA "
              f"{tf_ms:.4f} ms; library: none, no single PyTorch call computes "
              f"the chunked scan")
        for v, ks in kernels.items():
            print(f"[kernels] {tag} ssd_scan B{B} variant {v}: one call = {len(ks)} kernels ("
                  + ", ".join(f"{n} {us:.1f} us" for n, us in ks) + ", profiled)")
        if B == 4:
            rec = dict(max_abs_err=err, ms=m_ms, plain_ms=p_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None, variant=variant)
        del sets, calls, c, y, hf
    torch.cuda.empty_cache()
    check(not bad, "; ".join(bad))
    return rec


# ------------------------------------------------------------------ phase 4


def serve_workload(np, n_req=8, vocab=151_936, seed=0):
    """8 seeded prompts of 128-512 tokens, left-padded to the longest."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 513, n_req)
    lens[0] = 512
    S = int(lens.max())
    prompts = np.zeros((n_req, S), np.int64)
    for i, n in enumerate(lens):
        prompts[i, S - n:] = rng.integers(16, vocab, n)
    return prompts, lens.astype(np.int32)


#: the kernels one op call of each wrapper launches (a first kernel of each
#: variant, and the kernels every call of it launches)
PROFILED = {"flash_attention": (("flash_mma_kernel", "flash_mla_kernel", "flash_wide_kernel",
                                 "flash_kernel"), ()),
            "paged_attention": (("paged_max_kernel",),
                                ("paged_fold_kernel", "paged_merge_kernel")),
            "entropy_probe": (("entropy_mma_kernel", "tile_stats_kernel"),
                              ("merge_kernel",)),
            "ssd_scan": (("ssd_state_kernel", "ssd_scan_kernel"), ())}


#: Profiled serves at most, in ``profile_serve``, to see every counted launch
#: in one of them.  On an H100 the profiler now and then keeps fewer device
#: records than a long run of CUDA-graph replays launched: one whole run of
#: this script saw 2001 of the MoE serve's 2072 counted paged calls, for each
#: of the call's three kernels alike, where the runs before it saw all 2072.
#: Kineto's own log (``KINETO_LOG_LEVEL=1``) counts the records it drops as
#: out of range, a few in a profiled MoE serve and more in each later one of
#: a process; a wider window around the serve does not lower that count.
PROFILE_ATTEMPTS = 3


def device_totals(torch, prof) -> dict:
    """{kernel name: [records, device us]} of a finished torch.profiler
    session, read from its raw device records (kernels, copies, sets), each
    distinct name demangled once.  ``key_averages`` builds a Python event
    for every record first, which took 90-100 s after one overlapped 8B
    serve on an H100."""
    from torch.autograd import DeviceType

    raw = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            r = raw.setdefault(e.name(), [0, 0])
            r[0] += 1
            r[1] += e.duration_ns()
    out = {}
    for name, (n, ns) in raw.items():
        r = out.setdefault(torch._C._demangle(name).removeprefix("void "), [0, 0.0])
        r[0] += n
        r[1] += ns / 1e3
    return out


def profile_serve(torch, serve, unprofiled_s: float, path: Path | None, tag: str,
                  kernels: dict) -> dict:
    """One more serve under torch.profiler, device activity only: its
    kernel table to ``path`` (if given), the top rows and the device busy
    share printed under ``[tag]``, and each wrapper's launch count over
    the serve (eager calls, plus each chunk graph's captured calls once
    per replay) checked against the kernels the profiler saw.  The
    profiler must see exactly the counted kernels of every wrapper in one
    whole serve: a serve in which it saw fewer of some kernel is printed
    and profiled again, up to ``PROFILE_ATTEMPTS`` serves; one in which it
    saw more fails at once.  Returns the checked counts."""
    from torch.profiler import ProfilerActivity, profile

    # the port's own kernels (csrc/*.cu, in an unnamed namespace), whatever
    # their rank in the table
    ours = "(anonymous namespace)::"
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        reset_counts(kernels)
        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = serve()
        stop_s = time.perf_counter() - t_prof - wall
        counted = {name: fn.launches for name, fn in kernels.items()}
        t_read = time.perf_counter()
        totals = device_totals(torch, prof)
        read_s = time.perf_counter() - t_read
        seen = {}
        for name, (n, _) in totals.items():
            if name.startswith(ours) and "at::" not in name:
                base = name[len(ours):].split("(")[0].split("<")[0]
                seen[base] = seen.get(base, 0) + n
        saw = {}
        for name, n in counted.items():
            first, every = PROFILED[name]
            got = [sum(seen.get(k, 0) for k in first)] + [seen.get(k, 0) for k in every]
            check(all(g <= n for g in got),
                  f"{tag}: {name} counted {n} launches, the profiler saw {got} "
                  f"kernels ({', '.join(first + every)})")
            saw[name] = got
        short = {name: got for name, got in saw.items()
                 if any(g != counted[name] for g in got)}
        if not short:
            break
        print(f"[{tag}] profiled serve {attempt} of at most {PROFILE_ATTEMPTS}: the "
              f"profiler kept fewer kernels than launched: "
              + "; ".join(f"{name} counted {counted[name]}, saw {got} "
                          f"({', '.join(sum(PROFILED[name], ()))})"
                          for name, got in short.items()))
    for name, got in short.items():
        first, every = PROFILED[name]
        check(False, f"{tag}: {name} counted {counted[name]} launches, the profiler saw "
                     f"{got} kernels ({', '.join(first + every)}) in each of "
                     f"{PROFILE_ATTEMPTS} profiled serves")
    busy_ms = sum(us for _, us in totals.values()) / 1e3
    rows = sorted(totals.items(), key=lambda kv: -kv[1][1])
    table = [f"{'device ms':>10} {'records':>8}  name"] + [
        f"{us / 1e3:10.3f} {n:8d}  {name}" for name, (n, us) in rows]
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(table) + "\n")
    print(f"[{tag}] " + f"\n[{tag}] ".join(line[:150] for line in table[:26]))
    for name, (n, us) in rows:
        if name.startswith(ours) and "at::" not in name:
            print(f"[{tag}] kernel {name[len(ours):].split('(')[0]}: "
                  f"{us / 1e3:.3f} ms device, {n} calls")
    print(f"[{tag}] launches counted by the wrappers {json.dumps(counted)}: "
          f"equal to the profiler's kernel counts"
          + (f" (profiled serve {attempt})" if attempt > 1 else "")
          + f"; the profiler's start and stop {stop_s:.1f} s, its records read in "
          f"{read_s:.1f} s")
    print(f"[{tag}] device busy {busy_ms:.1f} ms: {busy_ms / 1e3 / wall:.1%} of "
          f"the profiled serve ({wall:.3f} s), {busy_ms / 1e3 / unprofiled_s:.1%} "
          f"of the unprofiled one ({unprofiled_s:.3f} s)")
    flash_ms = sum(us for name, (_, us) in totals.items()
                   if name.startswith(ours + "flash_")) / 1e3
    print(f"[{tag}] flash kernels {flash_ms:.1f} ms of device time: "
          f"{flash_ms / busy_ms:.1%} of the busy {busy_ms:.1f} ms")
    return counted


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def kernel_vs_plain(torch, model, prompts, probe, frames=None, image=None):
    """Prefill the last 64 tokens of two prompts, decode one, probe: kernel
    path and plain path on the same weights (a ring cache; its decode and
    probe reads through the paged kernel's ring comparator; a hybrid's
    prefill through the SSD scan kernel or its plain version; an
    encoder-decoder's on ``frames`` (2, T, d), its encoder and every
    cross-attention through flash or the plain attention; a VLM's with
    ``image`` (2, P, d) patches in front of the tokens, every position
    through ``positions_for``).  Returns {impl: (prefill logits, decode
    logits, EAT)}."""
    from repro_torch.models.common import positions_for
    from repro_torch.serving.cache import alloc_cache

    P = 0 if image is None else image.shape[1]
    toks = torch.as_tensor(prompts[:2, -64:], device="cuda")
    pos = torch.arange(P + 64, dtype=torch.int32, device="cuda").expand(2, P + 64).contiguous()
    nxt = torch.full((2, 1), 7, dtype=torch.long, device="cuda")
    p1 = torch.full((2, 1), P + 64, dtype=torch.int32, device="cuda")
    pp = torch.tensor([[P + 65, P + 66]], dtype=torch.int32,
                      device="cuda").expand(2, 2).contiguous()
    ptoks = torch.tensor([probe.tokens], device="cuda").expand(2, 2)
    at = lambda q: positions_for(model.cfg, q)  # noqa: E731
    extra = {} if image is None else {"image_embeds": image}
    outs = {}
    for impl in ("cuda", "plain"):
        model.attn_impl = model.paged_attn_impl = model.scan_impl = impl
        cache = alloc_cache(model.cfg, 2, P + 96, device="cuda")
        hidden = model.prefill(toks, at(pos), pos, cache, frames=frames, **extra)
        logits = model.logits(hidden[:, -1]).float()
        dlog = model.decode_step(nxt, at(p1), p1, cache)[:, -1].float()
        eat = model.probe_entropy(ptoks, at(pp), pp, cache, entropy_impl=impl)
        outs[impl] = (logits, dlog, eat)
    model.attn_impl, model.paged_attn_impl, model.scan_impl = "auto", "gather", "auto"
    return outs


def mamba_phase(torch, np, kernels, phases, profile_dir=None) -> dict:
    """Phase 5: mamba2-2.7b, kernel path vs plain path, then the ring
    self-EAT serve with the launches of every kernel counted, and one more
    warm serve under the profiler (its table to ``profile_dir`` if given).
    Returns the launch counts of the profiled serve, checked against the
    profiler and equal to the warm serve's."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig, alloc_cache
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import SlotScheduler

    cfg = get_config("mamba2-2.7b")
    probe = make_probe(1, (6,))              # ids valid for a 50,280 vocab
    prompts, lens = serve_workload(np, vocab=cfg.vocab)
    check(int(prompts.max()) < cfg.vocab, "prompt ids past the vocab")

    def kernel_vs_plain(model, S=256):
        """Prefill the last S tokens of two prompts (row 1 left-padded:
        its pad steps masked), decode one, probe: scan kernel and entropy
        kernel vs their plain versions.  S > 16, so the prefill scans: one
        kernel launch per layer on the kernel path."""
        toks = torch.as_tensor(prompts[:2, -S:], device="cuda")
        n = torch.as_tensor(np.minimum(lens[:2], S), device="cuda")
        ar = torch.arange(S, device="cuda")[None]
        pos = torch.where(ar >= S - n[:, None], ar - (S - n[:, None]), -1).to(
            torch.int32).contiguous()
        nxt = torch.full((2, 1), 7, dtype=torch.long, device="cuda")
        p1 = n[:, None].to(torch.int32)
        pp = torch.cat([p1 + 1, p1 + 2], dim=1).contiguous()
        ptoks = torch.tensor([probe.tokens], device="cuda").expand(2, 2)
        outs = {}
        for impl in ("cuda", "plain"):
            model.scan_impl = impl
            cache = alloc_cache(model.cfg, 2, S + 32, device="cuda")
            before = kernels["ssd_scan"].launches
            hidden = model.prefill(toks, pos, pos, cache)
            launched = kernels["ssd_scan"].launches - before
            check(launched == (model.cfg.n_layers if impl == "cuda" else 0),
                  f"{model.cfg.name} {impl} prefill launched ssd_scan {launched} times")
            logits = model.logits(hidden[:, -1]).float()
            dlog = model.decode_step(nxt, p1, p1, cache)[:, -1].float()
            eat = model.probe_entropy(ptoks, pp, pp, cache, entropy_impl=impl)
            outs[impl] = (logits, dlog, eat)
        model.scan_impl = "auto"
        return outs

    # float32, full width, depth cut to 4 layers: logits to 1e-5 relative
    # L2, EAT to 1e-5 nats
    cfg32 = dataclasses.replace(cfg, name=cfg.name + "-4L-f32", n_layers=4,
                                dtype="float32")
    model32 = Model(cfg32, init_params(cfg32, torch.Generator(device="cuda").manual_seed(1),
                                       device="cuda"))
    outs = kernel_vs_plain(model32)
    for i, what in enumerate(("prefill logits", "decode logits")):
        rel = rel_l2(outs["cuda"][i], outs["plain"][i])
        check(bool(torch.isfinite(outs["cuda"][i]).all()) and rel < 1e-5,
              f"{cfg32.name} {what}: kernel vs plain relative L2 {rel}")
        print(f"[model] {cfg32.name} {what}: kernel vs plain relative L2 {rel:.3e} (tol 1e-5)")
    d_eat = (outs["cuda"][2] - outs["plain"][2]).abs().max().item()
    check(d_eat < 1e-5, f"{cfg32.name} EAT: kernel vs plain differ by {d_eat}")
    print(f"[model] {cfg32.name} EAT kernel vs plain max diff {d_eat:.3e} (tol 1e-5)")
    del model32, outs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda"))
    torch.cuda.synchronize()
    phases["mamba_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} d_inner "
          f"{cfg.ssm.expand * cfg.d_model} heads {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim}"
          f"x{cfg.ssm.head_dim} d_state {cfg.ssm.d_state} chunk {cfg.ssm.chunk} "
          f"Vp{cfg.padded_vocab} {cfg.dtype}: {n_params / 1e9:.3f} B params, init "
          f"{phases['mamba_init_s']:.1f} s")
    # bf16 at full depth: finite logits, EAT of the two paths within
    # MAMBA_EAT_TOL nats (the scan is float32 on both; its output is rounded
    # to bf16 and the differences compound over 64 layers)
    outs = kernel_vs_plain(model)
    for i, what in enumerate(("prefill logits", "decode logits")):
        check(bool(torch.isfinite(outs["cuda"][i]).all()), f"mamba2 {what} not finite")
        print(f"[model] {cfg.name} {what}: kernel vs plain relative L2 "
              f"{rel_l2(outs['cuda'][i], outs['plain'][i]):.3e}")
    eat_k, eat_p = outs["cuda"][2], outs["plain"][2]
    d_eat = (eat_k - eat_p).abs().max().item()
    check(bool(torch.isfinite(eat_k).all()) and d_eat < MAMBA_EAT_TOL,
          f"mamba2 EAT: kernel {eat_k.tolist()} vs plain {eat_p.tolist()}")
    print(f"[model] {cfg.name} EAT kernel {[round(x, 4) for x in eat_k.tolist()]} plain "
          f"{[round(x, 4) for x in eat_p.tolist()]} max diff {d_eat:.3e} "
          f"(tol {MAMBA_EAT_TOL:g})")
    del outs
    # the fused step of a recurrent stack is the separate step (the
    # reference's fallback): bitwise, after a 64-token prefill
    cache = alloc_cache(cfg, 2, 96, device="cuda")
    pos = torch.arange(64, dtype=torch.int32, device="cuda").expand(2, 64).contiguous()
    model.prefill(torch.as_tensor(prompts[:2, -64:], device="cuda"), pos, pos, cache)
    fused_vs_separate(torch, model, cache, torch.full((2, 1), 64, dtype=torch.int32,
                                                      device="cuda"),
                      probe, cfg.name, kernels, bitwise=True)
    del cache

    # the serve: 8 requests, 4 slots, ring, budget 64, chunk 16, greedy, an
    # EAT probe every 8 tokens, exit at the 2nd evaluation, forced answers
    n_req, batch, budget, chunk = len(lens), 4, 64, 16
    S = prompts.shape[1]
    ecfg = EngineConfig(
        max_reasoning_tokens=budget,
        capacity=SlotScheduler.required_capacity(S, n_req, batch, budget),
        chunk_len=chunk, sampler=SamplerConfig(greedy=True),
        cache=CacheConfig(kind="ring"))

    from repro_torch.serving import device_loop

    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e9), probe=probe,
                           schedule="every_n", every_n=8, min_evals=2)
    eng = ReasoningEngine(model, ecfg, mon)
    watch = Watch(torch, eng, device_loop, kernels)

    def serve(what: str, eager: bool = False):
        watch.begin()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.serve(prompts, lens, None, batch_size=batch, answer_len=4,
                        record_trace=True, eager=eager)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return res, wall, watch.end(f"mamba2 {what}")

    _, phases["mamba_cold_serve_s"], cold = serve("cold graph serve")
    check(cold["tiers"]["executor"]["captures"] > 0, "mamba2: no chunk graph captured")
    print(graph_line(f"{cfg.name} cold serve ({phases['mamba_cold_serve_s']:.3f} s)",
                     cold))
    reset_counts(kernels)
    res, phases["mamba_serve_s"], warm = serve("warm graph serve")
    launches = {name: fn.launches for name, fn in kernels.items()}
    ssd_variants = dict(kernels["ssd_scan"].variant_launches)
    entropy_variants = dict(kernels["entropy_probe"].variant_launches)
    wt = warm["tiers"]["executor"]
    check(wt["captures"] == 0 and wt["replays"] == wt["chunks"] + wt["rollouts"]
          and warm["device_if"] == 0,
          f"mamba2: the warm serve captured, ran a chunk or a rollout eagerly, or "
          f"read device_if: {warm['line']}")
    e_res, phases["mamba_eager_serve_s"], eager = serve("eager serve", eager=True)
    check_same(res, e_res, np, "mamba2: the graph serve differs from the "
               "eager serve")
    check(len(res) == n_req and all(r["status"] in ("exited", "exhausted") for r in res),
          "mamba2: not every request finished")
    exits = [r["exit_reason"] for r in res]
    check("eat" in exits, f"mamba2: no request exited by EAT: {exits}")
    check(all(len(r["answer_tokens"]) == 4 for r in res), "mamba2: missing answers")
    prefills = 1 + n_req - batch                    # the cohort, then admissions
    check(launches["ssd_scan"] == cfg.n_layers * prefills,
          f"mamba2: ssd_scan launched {launches['ssd_scan']} times, expected "
          f"{cfg.n_layers} per prefill x {prefills}")
    check(ssd_variants == {"mma": cfg.n_layers * prefills, "scalar": 0},
          f"mamba2: ssd_scan op calls per variant {ssd_variants}, expected every "
          f"one on the tensor cores")
    check_entropy_mma("mamba2 serve", entropy_variants, launches["entropy_probe"])
    n_tok = sum(r["n_reasoning"] for r in res)
    wall = phases["mamba_serve_s"]
    print(f"[serve] {cfg.name} ring: {sum(r['status'] in ('exited', 'exhausted') for r in res)}"
          f"/{n_req} requests finished through {batch} slots "
          f"{[r['slot'] for r in res]}, exits {exits} ({exits.count('eat')} by EAT), "
          f"reasoning tokens {[r['n_reasoning'] for r in res]}, {wall:.3f} s warm "
          f"graph serve, {n_tok / wall:.1f} reasoning tokens/s (cold serve "
          f"{phases['mamba_cold_serve_s']:.3f} s, eager serve "
          f"{phases['mamba_eager_serve_s']:.3f} s); graph serve == eager serve "
          f"bitwise (tokens, exits, slots, answers, EAT traces)")
    print(f"[serve] {cfg.name} host reads, warm graph serve: {warm['line']}")
    print(f"[serve] {cfg.name} host reads, eager serve: {eager['line']}")
    for kind in ("chunk", "rollout"):
        g = warm["tiers"]["executor"][f"{kind}_ms"]
        e = eager["tiers"]["executor"][f"{kind}_ms"]
        print(f"[{kind}] {cfg.name} executor: replay {statistics.median(g):.3f} ms "
              f"(range {min(g):.3f}-{max(g):.3f}, {len(g)} calls), eager "
              f"{statistics.median(e):.3f} ms (range {min(e):.3f}-{max(e):.3f}, "
              f"{len(e)} calls), median on the card")
    print(f"[graphs] {cfg.name}: graph pool {eng.executor.graphs.pool_bytes / 2**20:.1f} "
          f"MiB added by its captures; {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB peak allocated over the process")
    print(f"[serve] launches during the {cfg.name} warm graph serve: "
          f"{json.dumps(launches)} (ssd_scan {cfg.n_layers} op calls per prefill x "
          f"{prefills} prefills, per variant {json.dumps(ssd_variants)}; entropy_probe "
          f"per variant {json.dumps(entropy_variants)})")
    profiled = profile_serve(
        torch, lambda: serve("profiled serve")[:2], wall,
        Path(profile_dir) / "profile_mamba2.txt" if profile_dir else None,
        "profile mamba2", kernels)
    check(profiled == launches, f"mamba2: the profiled serve's launches {profiled} "
          f"differ from the warm serve's {launches}")
    return profiled


# ----------------------------------------------------------------- phase 5b

#: deepseek-moe-16b at full width and depth, bf16, against its plain path:
#: the relative L2 of the logits (both paths on the plain path's routes)
#: and the EAT difference in nats (read on an H100: 1.9e-2 and 4.4e-4)
MOE_BF16_TOL = 3e-2


def flash_shape_check(torch, F, fa, tag: str, Hq: int, Hkv: int, D: int, bad: list,
                      scalar: bool = False, case=None) -> dict:
    """bf16 flash at a model's prefill (B 4, S 512, left-padded, or the
    inputs ``case`` makes in ``flash_case``'s form; ``Hq`` q heads on
    ``Hkv`` kv heads of ``D``): one launch of the routed variant
    and nothing else, against the plain version within phase 3's bar (one
    ulp + 2^-7 x the attention of |v|), timed by graph replay in turns with
    SDPA (bool mask, K/V repeated per q head outside the timed call), the
    plain version by CUDA events, and the bound.  With ``scalar`` the
    scalar kernel, forced through the wrapper at the same inputs, is timed
    beside (a yardstick of what the routed kernel replaced).  Failures go
    to ``bad``.  Returns the record, with ``variant``."""
    dn, dtype = "bfloat16", torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    want = fa.flash_variant(dtype, D, D)
    case = case or flash_case
    c = case(torch, dtype, Hq=Hq, Hkv=Hkv, D=D)
    args = (c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, scale=scale)
    after = fa.flash_attention_cuda.variant_launches
    launched = {x: after[x] - before[x] for x in after}
    ref = fa.attention_plain(*args, scale=scale)
    spread = fa.attention_plain(c["q"], c["k"], c["v"].abs(), c["q_pos"], c["kv_pos"],
                                scale=scale)
    err, ok, tol = agree(torch, "flash_attention", dn, out, ref, spread)
    if launched != {x: int(x == want) for x in launched} or not ok:
        bad.append(f"{tag} flash_attention Hq{Hq} Hkv{Hkv} D{D}: launched {launched}, "
                   f"not one {want}; max abs err {err:.3e} ({tol})")
    per_set = nbytes(*args) + nbytes(out)
    sets = [c] + [case(torch, dtype, seed=s, Hq=Hq, Hkv=Hkv, D=D)
                  for s in range(1, n_sets(per_set))]
    calls = [lambda s=s: fa.flash_attention_cuda(
        s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale) for s in sets]
    g = Hq // Hkv
    mask = ((c["kv_pos"][:, None, None, :] >= 0)
            & (c["kv_pos"][:, None, None, :] <= c["q_pos"][:, None, :, None]))
    lib_sets = [(s["q"].transpose(1, 2), s["k"].transpose(1, 2).repeat_interleave(g, 1),
                 s["v"].transpose(1, 2).repeat_interleave(g, 1)) for s in sets]
    lib_calls = [lambda t=t: F.scaled_dot_product_attention(
        t[0], t[1], t[2], attn_mask=mask, scale=scale) for t in lib_sets]
    k_turns, l_turns = in_turns(torch, calls, lib_calls)
    p_ms = time_ms(torch, [lambda s=s: fa.attention_plain(
        s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale) for s in sets],
        iters=6)
    B, S = c["q"].shape[:2]
    pairs = valid_pairs(torch, c["q_pos"], c["kv_pos"]) * Hq
    b_ms, b_by = bound_ms(per_set, pairs * 4 * D, dn)
    k_ms, l_ms = statistics.median(k_turns), statistics.median(l_turns)
    rec = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=l_ms, variant=want)
    extra = ""
    if g > 1:   # one block per q head: each kv head's K/V tiles read g times
        extra = (f"; K/V re-read by the {g} q heads of a kv head: "
                 f"{(g - 1) * nbytes(c['k'], c['v']) / 1e6:.1f} MB past the bound's")
    if scalar:
        rec["scalar_ms"] = time_ms(torch, [lambda s=s: fa.flash_attention_cuda(
            s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale, variant="scalar")
            for s in sets], iters=3, warmup=1)
        extra += f"; the scalar kernel forced at these inputs {rec['scalar_ms']:.4f} ms (eager)"
    print(f"[kernels] {tag} flash_attention {dn} B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} variant "
          f"{want}: max_abs_err {err:.3e} ({tol}); graph replay in turns, 5 rounds: kernel "
          f"{turns_text(k_turns)}, sdpa {turns_text(l_turns)}; kernel / sdpa "
          f"{k_ms / l_ms:.3f}; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
          f"{per_set / 1e6:.1f} MB, {pairs * 4 * D / 1e9:.2f} GFLOP), kernel at "
          f"{b_ms / k_ms:.3f} of it{extra}")
    return rec


def paged_plain_f64(torch, c, scale: float):
    """``paged_attention_plain``'s rounding points (q scaled through bf16,
    float32 scores, each p = exp(s - the running max) in float32, rounded
    through bf16 for P.V) with the sums over keys (l and P.V) in float64:
    the plain version's arithmetic without its float32 summation noise."""
    from repro_torch.kernels.flash_attention import ops as fa

    q, k_pool, v_pool = c["q"], c["k_pool"], c["v_pool"]
    B, m, Hq, Dk = q.shape
    Hkv = k_pool.shape[2]
    qs = q * torch.full((), scale, dtype=q.dtype, device=q.device)
    qf = qs.float().reshape(B, m, Hkv, Hq // Hkv, Dk)
    qp = c["q_pos"][:, None, None, :, None]
    m_run = torch.full(qf.shape[:1] + qf.shape[2:4] + (m,), -1e30, device=q.device)
    l_run = torch.zeros_like(m_run, dtype=torch.float64)
    acc = None
    pages = c["pages"].long()
    for j in range(pages.shape[1]):
        kb, vb = k_pool[pages[:, j]], v_pool[pages[:, j]]
        kp = c["bpos"][:, j][:, None, None, None, :]
        valid = (kp >= 0) & (kp <= qp)
        sc = torch.where(valid, fa._scores(qf, kb), -1e30)
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        pr = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m_run - m_new).double()
        pv = torch.einsum("bhgqk,bkhd->bhgqd", pr.to(vb.dtype).double(), vb.double())
        l_run = l_run * alpha + pr.double().sum(dim=-1)
        acc = pv if acc is None else acc * alpha[..., None] + pv
        m_run = m_new
    out = torch.where(l_run[..., None] > 0, acc / l_run[..., None].clamp_min(1e-30), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, m, Hq, -1)


def paged_agree(torch, c, scale: float, out, ref):
    """``agree`` for a paged output: a bf16 one within one ulp of its plain
    version, or else within one ulp of ``paged_plain_f64`` (the plain
    version's float32 sums, not the kernel, then account for the gap).
    Returns (max abs error, within the bar?, the reading as text)."""
    err, ok, tol = agree(torch, "paged_attention", str(out.dtype).split(".")[-1],
                         out, ref)
    if ok or out.dtype != torch.bfloat16:
        return err, ok, tol
    exact = paged_plain_f64(torch, c, scale)
    k = bf16_bar_ratio(torch, out, exact, 0.0)
    return err, k <= 1, (f"{tol}; so against the float64 evaluation of the plain "
                         f"version's rounding points: kernel {k:.3g} bf16 ulp, tol 1 "
                         f"ulp, plain {bf16_bar_ratio(torch, ref, exact, 0.0):.3g}")


def paged_shape_check(torch, pa, tag: str, m: int, Hq: int, Hkv: int, D: int,
                      bad: list) -> dict:
    """bf16 paged reads at a model's heads (``m`` query positions over ~40
    pages per row, two whole splits unmapped): against the plain version
    within one bf16 ulp (``paged_agree``), paged == ring bitwise, timed by
    graph replay, the plain version by CUDA events, and the bound.  Returns
    the record."""
    dn, dtype = "bfloat16", torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    c, (k_ring, v_ring, kv_pos) = paged_case(torch, pa, dtype, m, Hq=Hq, Hkv=Hkv, D=D)
    pargs = (c["q"], c["k_pool"], c["v_pool"], c["pages"], c["counts"], c["bpos"],
             c["q_pos"])
    split = dict(logical=c["logical"], num_blocks=c["num_blocks"])
    out = pa.paged_attention_cuda(*pargs, scale=scale, **split)
    ref = pa.paged_attention_plain(*pargs, scale=scale)
    ring = pa.ring_decode_attention(c["q"], k_ring, v_ring, c["q_pos"], kv_pos,
                                    page_size=16, scale=scale, impl="cuda")
    err, ok, tol = paged_agree(torch, c, scale, out, ref)
    exact = paged_plain_f64(torch, c, scale)
    f64 = (f"; from the float64 evaluation of the plain version's rounding points: "
           f"kernel {bf16_bar_ratio(torch, out, exact, 0.0):.3g} bf16 ulp, plain "
           f"{bf16_bar_ratio(torch, ref, exact, 0.0):.3g}")
    del exact
    if not ok or not torch.equal(out, ring):
        bad.append(f"{tag} paged_attention Hq{Hq} Hkv{Hkv} D{D} m={m}: max abs err "
                   f"{err:.3e} ({tol}), paged == ring {torch.equal(out, ring)}")
    mapped = int(c["counts"].sum())
    B, ps = c["q"].shape[0], c["k_pool"].shape[1]
    per_set = (2 * mapped * ps * Hkv * D * c["k_pool"].element_size()
               + nbytes(c["q"], c["pages"], c["logical"], c["counts"], c["bpos"],
                        c["q_pos"]) + nbytes(out))
    sets = [c] + [paged_case(torch, pa, dtype, m, seed=i, Hq=Hq, Hkv=Hkv, D=D)[0]
                  for i in range(1, n_sets(nbytes(c["k_pool"], c["v_pool"])))]
    k_ms = graph_ms(torch, [lambda s=s: pa.paged_attention_cuda(
        s["q"], s["k_pool"], s["v_pool"], s["pages"], s["counts"], s["bpos"],
        s["q_pos"], scale=scale, logical=s["logical"], num_blocks=s["num_blocks"])
        for s in sets])
    p_ms = time_ms(torch, [lambda s=s: pa.paged_attention_plain(
        s["q"], s["k_pool"], s["v_pool"], s["pages"], s["counts"], s["bpos"],
        s["q_pos"], scale=scale) for s in sets], iters=6)
    flat_pos = c["bpos"].reshape(c["bpos"].shape[0], -1)
    b_ms, b_by = bound_ms(per_set, valid_pairs(torch, c["q_pos"], flat_pos) * Hq * 4 * D,
                          dn)
    K, n_split = pa.split_plan(ps, c["num_blocks"])
    print(f"[kernels] {tag} paged_attention {dn} B{B} m{m} Hq{Hq} Hkv{Hkv} D{D} ps{ps} "
          f"pages {mapped}: n_split {n_split}, grid ({B * Hkv}, {n_split}); "
          f"max_abs_err {err:.3e} ({tol}){f64}; paged==ring bitwise; kernel {k_ms:.4f} ms "
          f"(graph replay) plain {p_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
          f"{per_set / 1e6:.1f} MB), kernel at {b_ms / k_ms:.3f} of it")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def entropy_shape_check(torch, ep, tag: str, d: int, Vp: int, vocab: int, tied: bool,
                        bad: list) -> dict:
    """The bf16 entropy probe over a model's unembedding at B 4: the
    tensor-core variant (checked) against the plain version within 1e-5,
    timed by graph replay, the plain version by CUDA events, and the bound.
    Returns the record."""
    dn, dtype = "bfloat16", torch.bfloat16
    c = entropy_case(torch, dtype, 4, d, Vp, vocab, tied)
    h, w = c["h"], c["w"]
    variant = ep.entropy_variant(h, w)
    out = ep.entropy_probe_cuda(h, w, vocab)
    ref = ep.next_token_entropy_plain(h, w, vocab)
    err, ok, tol = agree(torch, "entropy_probe", dn, out, ref)
    if variant != "mma" or not ok or not bool(torch.isfinite(out).all()):
        bad.append(f"{tag} entropy_probe {d} x {Vp}: variant {variant}, max abs err "
                   f"{err:.3e} ({tol})")
    k_ms = graph_ms(torch, [lambda: ep.entropy_probe_cuda(h, w, vocab)])
    p_ms = time_ms(torch, [lambda: ep.next_token_entropy_plain(h, w, vocab)], iters=6)
    b_ms, b_by = bound_ms(nbytes(h, w) + 4 * 4, 2 * 4 * d * Vp, dn)
    print(f"[kernels] {tag} entropy_probe {dn} B4 d{d} Vp{Vp} vocab {vocab} "
          f"{'tied (Vp, d) table, transposed view' if tied else 'untied (d, Vp)'}: "
          f"variant {variant}; max_abs_err {err:.3e} ({tol}); kernel {k_ms:.4f} ms (graph "
          f"replay) plain {p_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes(h, w) / 1e6:.1f} MB), kernel at {b_ms / k_ms:.3f} of it")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def moe_kernel_checks(torch, F, fa, pa, ep) -> dict:
    """Phase 5b's kernel checks at ``deepseek-moe-16b``'s shapes, bf16:
    flash at B 4, S 512 with 16 q and 16 kv heads of 128 (g = 1: MHA),
    paged at m 1 and m 2 over ~40 pages per row with g = 1 (paged == ring
    bitwise), entropy over its untied 2048 x 102,400 head at B 4, each
    against its plain version within phase 3's bars and timed as there
    (flash and SDPA by graph replay in turns, paged and entropy by graph
    replay).  Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms}}."""
    bad, rec = [], {}
    rec["flash_attention"] = flash_shape_check(torch, F, fa, "moe", 16, 16, 128, bad)
    paged = [paged_shape_check(torch, pa, "moe", m, 16, 16, 128, bad) for m in (1, 2)]
    rec["paged_attention"] = dict(paged[0], max_abs_err=max(r["max_abs_err"]
                                                            for r in paged))
    rec["entropy_probe"] = entropy_shape_check(torch, ep, "moe", 2048, 102_400, 102_400,
                                               False, bad)
    torch.cuda.empty_cache()
    check(not bad, "moe kernel vs plain: " + "; ".join(bad))
    return rec


def moe_kernel_vs_plain(torch, model, prompts, probe):
    """``kernel_vs_plain`` on an MoE model twice: each path routing by its
    own router outputs, then both paths taking the plain path's routes
    (weights and experts, call by call).  Returns (free outputs, shared
    outputs, token-layer top-k sets the two paths picked differently in
    the first run, token-layer sets in all)."""
    from repro_torch.models import moe as moe_mod

    own = moe_mod.router_topk
    calls = []

    def recorded(p, x, cfg):
        out = own(p, x, cfg)
        calls.append(out[:2])
        return out

    moe_mod.router_topk = recorded
    try:
        free = kernel_vs_plain(torch, model, prompts, probe)   # kernel, then plain
    finally:
        moe_mod.router_topk = own
    n = len(calls) // 2
    kernel_calls, plain_calls = calls[:n], calls[n:]
    differ = sum(int((torch.sort(a[1], -1).values != torch.sort(b[1], -1).values)
                     .any(-1).sum()) for a, b in zip(kernel_calls, plain_calls))
    routes = sum(a[1][..., 0].numel() for a in kernel_calls)
    plain_routes = iter(plain_calls + plain_calls)

    def shared_routes(p, x, cfg):
        w, i = next(plain_routes)
        return w, i, own(p, x, cfg)[2]

    moe_mod.router_topk = shared_routes
    try:
        shared = kernel_vs_plain(torch, model, prompts, probe)
    finally:
        moe_mod.router_topk = own
    return free, shared, differ, routes


def f32_kernel_vs_plain(torch, cfg32, prompts, probe, frames=None, image=None) -> None:
    """A float32 model of ``cfg32`` (seeded random weights, depth cut by the
    caller) through ``kernel_vs_plain`` (on ``frames`` for an
    encoder-decoder, with ``image`` patches for a VLM): the logits'
    relative L2 and the EAT within 1e-5.  Frees the model."""
    from repro_torch.models.model import Model, init_params

    model32 = Model(cfg32, init_params(cfg32, torch.Generator(device="cuda").manual_seed(1),
                                       device="cuda"))
    outs = kernel_vs_plain(torch, model32, prompts, probe, frames, image)
    for i, what in enumerate(("prefill logits", "decode logits")):
        rel = rel_l2(outs["cuda"][i], outs["plain"][i])
        check(bool(torch.isfinite(outs["cuda"][i]).all()) and rel < 1e-5,
              f"{cfg32.name} {what}: kernel vs plain relative L2 {rel}")
        print(f"[model] {cfg32.name} {what}: kernel vs plain relative L2 {rel:.3e} "
              f"(tol 1e-5)")
    eat_k, eat_p = outs["cuda"][2], outs["plain"][2]
    d_eat = (eat_k - eat_p).abs().max().item()
    check(d_eat < 1e-5, f"{cfg32.name} EAT: kernel {eat_k.tolist()} vs plain "
          f"{eat_p.tolist()} differ by {d_eat}")
    print(f"[model] {cfg32.name} EAT kernel vs plain max diff {d_eat:.3e} (tol 1e-5); "
          f"kernel {eat_k.tolist()} plain {eat_p.tolist()}")
    del model32, outs
    gc.collect()
    torch.cuda.empty_cache()


def moe_bf16_kernel_vs_plain(torch, model, prompts, probe) -> None:
    """A bf16 MoE ``model`` through ``moe_kernel_vs_plain``.  Each path
    routes by its own float32 probabilities of its own bf16 activations,
    and near ties between the k-th and (k+1)-th expert pick differently on
    the two paths (read on an H100: 561 of 3,618 token-layer routes of
    deepseek-moe-16b), which moves the logits by more than the kernels do.
    So the logits are held to ``MOE_BF16_TOL`` with the plain path's routes
    on both paths (the kernels' own difference), and the EAT with each
    path's own routes; the logits of the free-routing comparison are
    printed beside."""
    cfg, mo = model.cfg, model.cfg.moe
    free, shared, differ, routes = moe_kernel_vs_plain(torch, model, prompts, probe)
    for i, what in enumerate(("prefill logits", "decode logits")):
        rel = rel_l2(shared["cuda"][i], shared["plain"][i])
        check(bool(torch.isfinite(free["cuda"][i]).all()) and rel < MOE_BF16_TOL,
              f"{cfg.name} {what}: kernel vs plain relative L2 {rel} (same routes)")
        print(f"[model] {cfg.name} {what}: kernel vs plain relative L2 {rel:.3e} with "
              f"the plain path's routes on both (tol {MOE_BF16_TOL:g}); each path "
              f"routing itself {rel_l2(free['cuda'][i], free['plain'][i]):.3e}")
    print(f"[model] {cfg.name}: the two paths routed {differ} of {routes} token-layer "
          f"top-{mo.top_k} sets differently")
    eat_k, eat_p = free["cuda"][2], free["plain"][2]
    d_eat = (eat_k - eat_p).abs().max().item()
    check(bool(torch.isfinite(eat_k).all()) and d_eat < MOE_BF16_TOL,
          f"{cfg.name} EAT: kernel {eat_k.tolist()} vs plain {eat_p.tolist()}")
    print(f"[model] {cfg.name} EAT (each path routing itself) kernel "
          f"{[round(x, 4) for x in eat_k.tolist()]} plain "
          f"{[round(x, 4) for x in eat_p.tolist()]} max diff {d_eat:.3e} "
          f"(tol {MOE_BF16_TOL:g})")
    del free, shared


def moe_phase(torch, np, F, kernels: dict, phases: dict, card: str,
              profile_dir=None) -> dict:
    """Phase 5b: ``deepseek-moe-16b``.  Its kernels at its shapes
    (``moe_kernel_checks``); kernel path vs plain path of the model
    (float32 cut to 4 layers, then bf16 at the full 28); seeded random
    weights at full width and depth on the card; a paged self-EAT serve of
    phase 4's traffic (prompts over its 102,400 vocabulary) as cold graph,
    warm graph and eager serves of one engine, warm == eager bitwise, and a
    ring serve of the same traffic, bitwise the paged one's streams; flash,
    paged and entropy launched in the warm serve (every flash call mma, 28
    per prefill; every entropy call mma); one more warm serve under the
    profiler, its counts checked.  ``kernels``: flash, paged and entropy's
    wrappers.  Returns {"launches": the profiled serve's counts, "kernels":
    the kernel records}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.models.model import Model, init_params

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    recs = moe_kernel_checks(torch, F, fa, pa, ep)

    cfg = get_config("deepseek-moe-16b")
    probe = make_probe(1, (6,))
    prompts, lens = serve_workload(np, vocab=cfg.vocab)
    check(int(prompts.max()) < cfg.vocab, "prompt ids past the vocab")

    # float32, full width, depth cut to 4 layers (1 dense, 3 MoE): the
    # kernels agree with the plain path to 1e-5 (relative L2 of the logits,
    # nats of EAT)
    cfg32 = dataclasses.replace(cfg, name=cfg.name + "-4L-f32", n_layers=4,
                                dtype="float32")
    f32_kernel_vs_plain(torch, cfg32, prompts, probe)

    t0 = time.perf_counter()
    model = Model(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda"))
    torch.cuda.synchronize()
    phases["moe_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    mo = cfg.moe
    print(f"[model] {cfg.name}: {cfg.n_layers} layers ({mo.first_k_dense} dense, ff "
          f"{mo.dense_d_ff}) d{cfg.d_model} Hq{cfg.n_heads}/Hkv{cfg.n_kv_heads} hd"
          f"{cfg.resolved_head_dim} experts {mo.n_routed} routed (top {mo.top_k}) + "
          f"{mo.n_shared} shared of {mo.d_expert} Vp{cfg.padded_vocab} {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B params, {n_params * 2 / 1e9:.2f} GB, init "
          f"{phases['moe_init_s']:.1f} s")
    # bf16 at full depth
    moe_bf16_kernel_vs_plain(torch, model, prompts, probe)

    # the serve: phase 4's traffic, its flash calls all on the tensor cores
    # (28 per prefill) and its paged reads launched
    L = cfg.n_layers
    profiled = serve_cell(
        torch, np, model, probe, prompts, lens, kernels, phases, card, key="moe",
        flash_want=lambda forwards, prefills: {"mma": L * prefills, "mla": 0, "wide": 0,
                                               "scalar": 0},
        flash_text=f"{L} mma per prefill", paged_want=None,
        profile_path=Path(profile_dir) / "profile_moe.txt" if profile_dir else None)
    del model
    phase_end(torch, phases, "moe", cfg.name, base, t_phase, card)
    return {"launches": profiled, "kernels": recs}


def phase_end(torch, phases: dict, key: str, name: str, base: int, t_phase: float,
              card: str, weights: int = 0, over: str = "the phase") -> None:
    """A serving phase's closing line: its engines' graph pools, its peak
    allocation ``over`` a stretch since the peak was reset, above the
    ``base`` it started with (against the model's ``weights`` bytes, if
    given), its wall; then frees what it left."""
    peak = torch.cuda.max_memory_allocated() - base
    phases[f"{key}_peak_gb"] = peak / 1e9
    phases[f"{key}_phase_s"] = time.perf_counter() - t_phase
    against = f", against {weights / 1e9:.2f} GB of weights" if weights else ""
    print(f"[graphs] {name}: graph pool {phases[f'{key}_pool_mib']:.1f} MiB added by "
          f"the engines' captures; {peak / 1e9:.2f} GB peak allocated over {over} "
          f"(max_memory_allocated above the {base / 1e9:.2f} GB held before the "
          f"phase{against}); phase {phases[f'{key}_phase_s']:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()


def serve_cell(torch, np, model, probe, prompts, lens, kernels: dict, phases: dict,
               card: str, *, key: str, flash_want, flash_text: str, paged_want,
               profile_path, turns: int = 0, scan_want=None) -> dict:
    """Phase 4's traffic (8 requests, 4 slots, budget 64, chunk 16, page 16,
    greedy, an EAT probe every 8 tokens, exit at the 2nd evaluation,
    answers of 4) on ``model``, paged self-EAT, as cold graph, warm graph
    and eager serves of one engine: warm == cold == eager bitwise, 0
    captures and 0 ``device_if`` reads warm, every request finished, a slot
    reused, at least one EAT exit, flash's launches per variant in the warm
    serve ``flash_want(model forwards, prefills)``, every entropy call
    mma, paged launched (``paged_want`` None) or launched ``paged_want``
    times (a number, or a function of model forwards and prefills), the
    scan's launches per variant ``scan_want(prefills)`` where given (the
    wrapper in ``kernels``); ``turns`` eager and warm graph serves in turns (eager first),
    each bitwise the warm serve; one more warm serve under the profiler,
    its counts checked; then a ring serve of the same traffic, bitwise the
    paged streams.
    Prints under ``[serve]``, ``[chunk]``, ``[rollout]``, ``[graphs]`` and
    ``[profile {key}]``; readings go to ``phases`` under ``key``.  Frees
    its engines.  Returns the profiled serve's launches."""
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.serving import device_loop
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import SlotScheduler

    cfg = model.cfg
    n_req, batch, budget, chunk = len(lens), 4, 64, 16
    capacity = SlotScheduler.required_capacity(prompts.shape[1], n_req, batch, budget)

    def engine(kind: str):
        ecfg = EngineConfig(max_reasoning_tokens=budget, capacity=capacity,
                            chunk_len=chunk, sampler=SamplerConfig(greedy=True),
                            cache=CacheConfig(kind=kind, page_size=16, attn_impl="auto"))
        mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e9), probe=probe,
                               schedule="every_n", every_n=8, min_evals=2)
        eng = ReasoningEngine(model, ecfg, mon)
        return eng, Watch(torch, eng, device_loop, kernels)

    def serve(eng, watch, what: str, eager: bool = False):
        watch.begin()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.serve(prompts, lens, None, batch_size=batch, answer_len=4,
                        record_trace=True, eager=eager)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return res, wall, watch.end(f"{cfg.name} {what}")

    eng, watch = engine("paged")
    cold_res, cold_s, cold = serve(eng, watch, "cold graph serve")
    check(cold["tiers"]["executor"]["captures"] > 0, f"{cfg.name}: no chunk graph captured")
    print(graph_line(f"{cfg.name} paged cold serve ({cold_s:.3f} s)", cold))
    reset_counts(kernels)
    res, warm_s, warm = serve(eng, watch, "warm graph serve")
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_variants = dict(kernels["flash_attention"].variant_launches)
    entropy_variants = dict(kernels["entropy_probe"].variant_launches)
    scan_variants = (dict(kernels["ssd_scan"].variant_launches) if scan_want is not None
                     else None)
    wt = warm["tiers"]["executor"]
    check(wt["captures"] == 0 and wt["replays"] == wt["chunks"] + wt["rollouts"]
          and warm["device_if"] == 0,
          f"{cfg.name}: the warm serve captured, ran a chunk or a rollout eagerly, "
          f"or read device_if: {warm['line']}")
    check_same(res, cold_res, np, f"{cfg.name}: cold and warm graph serves differ")
    e_res, eager_s, eager = serve(eng, watch, "eager serve", eager=True)
    check_same(res, e_res, np,
               f"{cfg.name}: the warm graph serve differs from the eager serve")
    check(len(res) == n_req and all(r["status"] in ("exited", "exhausted") for r in res),
          f"{cfg.name}: not every request finished")
    exits = [r["exit_reason"] for r in res]
    check("eat" in exits, f"{cfg.name}: no request exited by EAT: {exits}")
    slots = [r["slot"] for r in res]
    check(len(set(slots)) < len(slots), f"{cfg.name}: no slot served two requests: {slots}")
    prefills = 1 + n_req - batch                    # the cohort, then admissions
    # model forwards: the prefills, a decode and a probe forward per step of
    # each replayed chunk, answer_len + 1 per rollout, eager probes
    forwards = (prefills + 2 * chunk * wt["chunks"] + 5 * wt["rollouts"]
                + wt["probe_calls"])
    want = flash_want(forwards, prefills)
    check(flash_variants == want, f"{cfg.name}: flash launches per variant "
          f"{flash_variants}, expected {want} ({flash_text}; {prefills} prefills, "
          f"{forwards} forwards)")
    check_entropy_mma(f"{cfg.name} serve", entropy_variants, launches["entropy_probe"])
    check(launches["entropy_probe"] > 0, f"{cfg.name}: entropy_probe was not launched")
    n_paged = launches["paged_attention"]
    if callable(paged_want):
        paged_want = paged_want(forwards, prefills)
    check(n_paged > 0 if paged_want is None else n_paged == paged_want,
          f"{cfg.name}: paged_attention launched {n_paged} times, expected "
          + ("some" if paged_want is None else str(paged_want)))
    if scan_want is not None:
        check(scan_variants == scan_want(prefills),
              f"{cfg.name}: ssd_scan op calls per variant {scan_variants}, expected "
              f"{scan_want(prefills)} ({prefills} prefills)")
    n_tok = sum(r["n_reasoning"] for r in res)
    chunk_ms = statistics.median(wt["chunk_ms"])
    e_chunk_ms = statistics.median(eager["tiers"]["executor"]["chunk_ms"])
    phases.update({f"{key}_cold_serve_s": cold_s, f"{key}_serve_s": warm_s,
                   f"{key}_eager_serve_s": eager_s, f"{key}_tok_s": n_tok / warm_s,
                   f"{key}_chunk_ms": chunk_ms, f"{key}_eager_chunk_ms": e_chunk_ms})
    print(f"[serve] {cfg.name} paged: {n_req} requests through {batch} slots {slots}, "
          f"exits {exits} ({exits.count('eat')} by EAT), reasoning tokens "
          f"{[r['n_reasoning'] for r in res]}, {warm_s:.3f} s warm graph serve, "
          f"{n_tok / warm_s:.1f} reasoning tokens/s (cold serve {cold_s:.3f} s, eager "
          f"serve {eager_s:.3f} s); graph serve == eager serve bitwise (tokens, exits, "
          f"slots, answers, EAT traces) ({card})")
    print(f"[serve] {cfg.name} host reads, warm graph serve: {warm['line']}")
    print(f"[serve] {cfg.name} host reads, eager serve: {eager['line']}")
    for kind in ("chunk", "rollout"):
        g = wt[f"{kind}_ms"]
        e = eager["tiers"]["executor"][f"{kind}_ms"]
        print(f"[{kind}] {cfg.name} executor: replay {statistics.median(g):.3f} ms "
              f"(range {min(g):.3f}-{max(g):.3f}, {len(g)} calls), eager "
              f"{statistics.median(e):.3f} ms (range {min(e):.3f}-{max(e):.3f}, "
              f"{len(e)} calls), median on the card ({card})")
    print(f"[serve] launches during the {cfg.name} warm graph serve: "
          f"{json.dumps(launches)} (flash per variant {json.dumps(flash_variants)}: "
          f"{flash_text}: {prefills} prefills, {forwards} forwards; entropy per variant "
          f"{json.dumps(entropy_variants)}"
          + ("" if scan_variants is None else
             f"; ssd_scan per variant {json.dumps(scan_variants)}") + ")")
    walls = {"eager": [], "graph": []}
    for _ in range(turns):
        for mode in walls:
            r, wall, _ = serve(eng, watch, f"{mode} serve in turns", eager=mode == "eager")
            check_same(r, res, np, f"{cfg.name}: the {mode} serve in turns "
                       f"differs from the warm graph serve")
            walls[mode].append(wall)
    if turns:
        print(f"[serve] {cfg.name} paged walls in turns (eager, graph) x {turns}: "
              + "; ".join(f"{mode} {statistics.median(w):.3f} s (range {min(w):.3f}-"
                          f"{max(w):.3f}: {', '.join(f'{x:.3f}' for x in w)})"
                          for mode, w in walls.items()) + f" ({card})")
        phases[f"{key}_graph_turns_s"] = statistics.median(walls["graph"])
        phases[f"{key}_eager_turns_s"] = statistics.median(walls["eager"])
    profiled = profile_serve(
        torch, lambda: serve(eng, watch, "profiled serve")[:2], warm_s,
        profile_path, f"profile {key}", kernels)
    check(profiled == launches, f"{cfg.name}: the profiled serve's launches {profiled} "
          f"differ from the warm serve's {launches}")
    pool = eng.executor.graphs.pool_bytes
    del eng, watch

    # the ring serve of the same traffic: the paged serve's streams bitwise
    r_eng, r_watch = engine("ring")
    r_res, ring_s, _ = serve(r_eng, r_watch, "ring cold graph serve")
    check_same(res, r_res, np, f"{cfg.name}: the paged and ring streams differ",
               slots=False)
    pool += r_eng.executor.graphs.pool_bytes
    print(f"[serve] {cfg.name} ring: {ring_s:.3f} s (cold graph serve); paged == "
          f"ring bitwise (tokens, exits, answers, EAT traces)")
    del r_eng, r_watch
    phases[f"{key}_pool_mib"] = pool / 2**20
    return profiled


# ------------------------------------------------------------------ phase 6


def clone_tree(torch, tree):
    """A copy of every tensor of a (nested) state: a cache re-timed by a
    step that writes it."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(torch, v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(torch, v) for v in tree))
    return tree


def same_trace(np, a: list, b: list) -> bool:
    """Two traces' records equal bitwise, field by field."""
    return len(a) == len(b) and all(
        list(x) == list(y) and all(
            x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            and x[k].tobytes() == y[k].tobytes() for k in x)
        for x, y in zip(a, b))


def trace_phase(torch, np, model, probe, prompts, lens, kernels: dict,
                phases: dict) -> None:
    """The paper's evaluation path (App. H) on ``model``: ``reason_with_trace``
    over the first 4 prompts on a ring cache, every_n 8, 64 tokens, K 4
    rollouts of 4 tokens and a 5-token greedy confidence at every point,
    the paper's sampler (temperature 0.6, top-p 0.95) with seeded
    generators; cold graph, warm graph and eager traces (warm == eager
    bitwise, generators at the same offsets, no capture in the warm one,
    its launches counted); then the three Fig. 21 costs at contexts 512 and
    2048 by graph replay, and the per-token loop against the chunk graphs
    in turns."""
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    B, max_tokens, every_n, K, n_roll, n_conf = 4, 64, 8, 4, 4, 5
    P, L = prompts[:B], lens[:B]
    S = P.shape[1]
    cfg = model.cfg
    ecfg = EngineConfig(max_reasoning_tokens=max_tokens,
                        capacity=S + max_tokens + 16, chunk_len=every_n,
                        sampler=SamplerConfig(temperature=0.6, top_p=0.95),
                        cache=CacheConfig(kind="ring", attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e-3), probe=probe,
                           schedule="every_n", every_n=every_n, min_evals=2)
    eng = ReasoningEngine(model, ecfg, mon)
    graphs = eng.executor.graphs

    def trace(what: str, eager: bool = False):
        """One trace from seeded generators: (records, out_tokens, wall s,
        captures, replays, chain and rollout generator offsets)."""
        rng = torch.Generator(device="cuda").manual_seed(5)
        rr = torch.Generator(device="cuda").manual_seed(6)
        st = eng.start(P, L, rng)
        c0, r0 = graphs.captures, graphs.replays
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, tr = eng.reason_with_trace(
            st, max_tokens=max_tokens, rollout_k=K, rollout_len=n_roll,
            answer_extract=lambda r: r[:, 0], confidence_len=n_conf,
            rollout_rng=rr, eager=eager)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(len(tr) > 0 and all(np.isfinite(r["eat"]).all()
                                  and np.isfinite(r["confidence"]).all() for r in tr),
              f"trace {what}: no record, or a value not finite")
        return (tr, st.out_tokens.cpu().numpy(), wall, graphs.captures - c0,
                graphs.replays - r0, (rng.get_offset(), rr.get_offset()))

    t0 = time.perf_counter()
    cold = trace("cold graph")
    check(cold[3] > 0, "trace: the cold trace captured no graph")
    reset_counts(kernels)
    warm = trace("warm graph")
    launched = {name: fn.launches for name, fn in kernels.items()}
    eager = trace("eager", eager=True)
    n_rec, n_chunks = len(warm[0]), -(-(max_tokens - 1) // every_n)
    check(warm[3] == 0 and warm[4] == n_chunks + n_rec * (K + 1),
          f"trace: the warm trace made {warm[3]} captures and {warm[4]} replays, "
          f"expected 0 and {n_chunks} chunks + {n_rec} x {K + 1} rollouts")
    check(same_trace(np, warm[0], eager[0]) and np.array_equal(warm[1], eager[1]),
          "trace: the warm graph trace differs from the eager trace")
    check(same_trace(np, warm[0], cold[0]) and np.array_equal(warm[1], cold[1]),
          "trace: the warm graph trace differs from the cold one")
    check(warm[5] == eager[5], f"trace: generator offsets (chain, rollouts) after "
          f"the graph trace {warm[5]}, after the eager trace {eager[5]}")
    for name in ("flash_attention", "paged_attention", "entropy_probe"):
        check(launched[name] > 0, f"trace: {name} not launched in the warm trace")
    keys = graphs.keys()
    print(f"[trace] {cfg.name} ring, {B} prompts, every_n {every_n}, {max_tokens} "
          f"tokens, K {K} x {n_roll} rollout tokens, confidence {n_conf}, "
          f"temperature 0.6 top-p 0.95: {n_rec} records of {sorted(warm[0][0])}; "
          f"warm graph trace == eager trace bitwise (every record field, "
          f"out_tokens), generator offsets equal {warm[5]}")
    print(f"[trace] graph keys: {len(keys) - rollout_keys(graphs)} chunk "
          f"{[k[0] for k in keys if k[0][0] != 'rollout']}, {rollout_keys(graphs)} "
          f"rollout {[k[0] for k in keys if k[0][0] == 'rollout']}; cold trace "
          f"{cold[3]} captures ({', '.join(f'{x:.2f}' for x in graphs.capture_s)} s), "
          f"warm trace 0 captures, {warm[4]} replays ({n_chunks} chunks + {n_rec} x "
          f"{K + 1} rollouts)")
    print(f"[trace] walls: cold graph {cold[2]:.3f} s, warm graph {warm[2]:.3f} s, "
          f"eager {eager[2]:.3f} s; launches during the warm graph trace "
          f"{json.dumps(launched)}")
    phases.update(trace_cold_s=cold[2], trace_warm_s=warm[2], trace_eager_s=eager[2])

    # Fig. 21: one EAT probe, one decode step and one K 8 x 4 rollout
    # evaluation at a context of T tokens (B 4), each by graph replay
    for T in (512, 2048):
        toks = np.random.default_rng(T).integers(16, cfg.vocab, (B, T))
        st = eng.start(toks, np.full(B, T), None, capacity=T + 64)
        probe_ms = graph_ms(torch, [lambda: eng.eval_eat_now(st)])
        step = st._replace(cache=clone_tree(torch, st.cache))
        decode_ms = graph_ms(torch, [lambda: eng._decode_fn(step)])
        roll_ms = graph_ms(torch, [lambda: eng.rollout_answers(st, 8, 4, None,
                                                               eager=True)], reps=3)
        del step
        print(f"[fig21] context {T}, B {B}: eval_eat_now {probe_ms:.3f} ms, "
              f"decode_step {decode_ms:.3f} ms, rollout_answers K 8 x 4 tokens "
              f"{roll_ms:.3f} ms ({roll_ms / probe_ms:.1f} x the probe), graph "
              f"replay on the card")
        phases[f"fig21_{T}"] = {"probe_ms": probe_ms, "decode_ms": decode_ms,
                                "rollout_ms": roll_ms}

    # the per-token loop against reason() on the chunk graphs, unmonitored,
    # in turns from the same seed: the same tokens
    def run(per_token: bool):
        st = eng.start(P, L, torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        t = time.perf_counter()
        if per_token:
            st = eng._reason_per_token(st, max_tokens=max_tokens, use_monitor=False)
        else:
            st = eng.reason(st, max_tokens=max_tokens, use_monitor=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return st.out_tokens.cpu().numpy(), int(st.n_reasoning.sum()) - B, wall

    walls = {True: [], False: []}
    for _ in range(3):
        for per_token in (True, False):
            toks, n_tok, wall = run(per_token)
            walls[per_token].append(n_tok / wall)
            if per_token:
                ref = toks
            check(np.array_equal(toks, ref), "per-token loop and chunk graphs differ")
    per, chk = walls[True], walls[False]
    print(f"[trace] per-token loop {statistics.median(per):.1f} tokens/s (range "
          f"{min(per):.1f}-{max(per):.1f}) against reason() on the chunk graphs "
          f"{statistics.median(chk):.1f} tokens/s (range {min(chk):.1f}-"
          f"{max(chk):.1f}), unmonitored, {n_tok} tokens, in turns x 3; the same "
          f"tokens")
    phases["per_token_tok_s"] = statistics.median(per)
    phases["chunk_graph_tok_s"] = statistics.median(chk)
    phases["trace_phase_s"] = time.perf_counter() - t0



# ----------------------------------------------------------------- phase 6g


def tensor_leaves(torch, tree) -> list:
    """Every tensor of a (nested) state, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(torch, tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(torch, v)]
    return []


def fused_vs_separate(torch, model, base, p1, probe, what: str, kernels: dict, *,
                      bitwise: bool = False, tol: float = 3e-2,
                      eat_tol: float = 6e-2):
    """One fused step (``decode_and_probe``: token 7 at ``p1`` (B, 1) and the
    probe after it, one forward) and one separate step (``decode_step``,
    then ``probe_entropy``), each on its own copy of the cache ``base``,
    each followed by two ``decode_step``s.  The logits of each step are held
    to ``tol`` (relative L2 and max |diff| / max |logits|), the EAT to
    ``eat_tol`` nats, or everything to bitwise equality (``bitwise``: a
    recurrent stack's fused step is the separate step).  The bf16 bars
    check the fused step's results, not that its stale probe K/V stay
    masked (one stray key among hundreds would pass them): the float32 CPU
    tests hold that at 1e-5.  The fused step's
    launches are counted from 0 (``kernels``'s wrappers, flash per
    variant).  Returns (the fused path's [logits, EAT, next logits, next
    logits], its launches, flash per variant, its cache)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.common import positions_for

    cfg = model.cfg
    B, m = p1.shape[0], len(probe)
    at = lambda q: positions_for(cfg, q)  # noqa: E731
    tok = torch.full((B, 1), 7, dtype=torch.long, device="cuda")
    pos_all = (p1 + torch.arange(1 + m, dtype=torch.int32, device="cuda")[None]).contiguous()
    pp = pos_all[:, 1:].contiguous()
    ptoks = torch.tensor([probe.tokens], device="cuda").expand(B, m)
    fused_c, sep_c = clone_tree(torch, base), clone_tree(torch, base)
    reset_counts(kernels)
    f = list(model.decode_and_probe(tok, at(pos_all), pos_all, fused_c, ptoks))
    launched = {name: fn.launches for name, fn in kernels.items()}
    flash = dict(fa.flash_attention_cuda.variant_launches)
    s = [model.decode_step(tok, at(p1), p1, sep_c),
         model.probe_entropy(ptoks, at(pp), pp, sep_c)]
    for k in (1, 2):
        pk = p1 + k
        f.append(model.decode_step(tok, at(pk), pk, fused_c))
        s.append(model.decode_step(tok, at(pk), pk, sep_c))
    check(int(fused_c["cur"]) == int(sep_c["cur"]),
          f"{what}: cur {int(fused_c['cur'])} after the fused step, "
          f"{int(sep_c['cur'])} after the separate one")
    texts = []
    for i, name in enumerate(("fused step logits", "EAT", "decode step 1 logits",
                              "decode step 2 logits")):
        a, b = f[i].float(), s[i].float()
        check(bool(torch.isfinite(a).all()), f"{what} {name}: not finite")
        if bitwise:
            check(torch.equal(f[i], s[i]), f"{what} {name}: fused and separate differ")
            continue
        if name == "EAT":
            d = (a - b).abs().max().item()
            check(d <= eat_tol, f"{what} EAT: fused {a.tolist()} vs separate "
                  f"{b.tolist()} (tol {eat_tol:g} nats)")
            texts.append(f"EAT {d:.3e} nats (tol {eat_tol:g})")
            continue
        rel, top = rel_l2(a, b), ((a - b).abs().max() / b.abs().max()).item()
        check(rel <= tol and top <= tol, f"{what} {name}: fused vs separate relative "
              f"L2 {rel}, max |diff| / max |logits| {top} (tol {tol:g} each)")
        texts.append(f"{name} {rel:.3e} / {top:.3e}")
    print(f"[fused] {what}: fused step vs separate step (decode_step + probe_entropy) "
          f"from one cache state, then two decode steps from each cache: "
          + ("bitwise equal (logits, EAT, the next two steps' logits)" if bitwise else
             "; ".join(texts) + f" (relative L2 / max |diff| / max |logits|, tol "
             f"{tol:g})") + f"; the fused step's launches {json.dumps(launched)}, "
          f"flash {json.dumps(flash)}")
    del sep_c
    return f, launched, flash, fused_c


def fused_phase(torch, np, model, kernels: dict, phases: dict, card: str) -> dict:
    """Phase 6g: the fused decode-and-probe step (``Model.decode_and_probe``,
    one forward over ``[token, </think>, prefix]``) on ``model`` (the 8B at
    full width and depth, bf16), B 4, at contexts 512 and 2048.  The paged
    kernel at m 3 (its width here) against its plain version at phase 3's
    bar, timed with its bound; at each context, on a paged cache (shuffled
    pages) and on the ring (both read through the paged kernel, the ring
    by its identity page list): one fused step against one separate step
    from the same cache state (``fused_vs_separate``, the dense bars), its
    launches counted (one paged call per layer, one entropy call, no
    flash), the paged results equal to the ring's bitwise; the fused and
    the separate step timed as CUDA-graph replays in turns (5 rounds,
    ``cur`` put back after each call), beside the bound of one read of the
    weights.  Then a 16-step every-token run of
    ``build_serve_step_program(fused_probe=True)`` (greedy) at context 512,
    eager with its launches counted, and captured as one CUDA graph whose
    cold and warm replays must equal the eager run bitwise (tokens, monitor
    state, cache).  Returns the paged kernel's m 3 record with the
    16-step run's launches."""
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.models.common import positions_for
    from repro_torch.serving.cache import (alloc_cache, alloc_paged_cache,
                                           blocks_arrays, pack_paged_cache)
    from repro_torch.serving.executor import ServeStepConfig, build_serve_step_program
    from repro_torch.serving.sampler import SamplerConfig

    t0 = time.perf_counter()
    cfg = model.cfg
    probe = make_probe(1, (6,))
    m = len(probe)
    bad = []
    rec = paged_shape_check(torch, pa, f"{cfg.name} fused step", 1 + m, cfg.n_heads,
                            cfg.n_kv_heads, cfg.resolved_head_dim, bad)
    check(not bad, "fused step paged kernel vs plain: " + "; ".join(bad))
    saved = (model.paged_attn_impl, model.paged_attn_page)
    model.paged_attn_impl, model.paged_attn_page = "auto", 16
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    read_ms = weights / HBM_BYTES_PER_S * 1e3
    B, ps = 4, 16
    at = lambda q: positions_for(cfg, q)  # noqa: E731
    per_step = {"paged_attention": cfg.n_layers, "entropy_probe": 1, "flash_attention": 0}

    def caches(T: int) -> dict:
        """A ring and a paged cache (every block on a shuffled page, the
        compacted page list in order) after the prefill of T seeded tokens."""
        C = T + 64
        toks = torch.as_tensor(np.random.default_rng(T).integers(16, cfg.vocab, (B, T)),
                               device="cuda")
        pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
        ring = alloc_cache(cfg, B, C, device="cuda")
        model.prefill(toks, at(pos), pos, ring)
        NB = C // ps
        table = (np.random.default_rng(T + 1).permutation(B * NB) + 1).reshape(B, NB)
        paged = alloc_paged_cache(cfg, B, C, ps, 1 + B * NB, device="cuda")
        pack_paged_cache(paged, ring, table.astype(np.int32))
        logical = np.broadcast_to(np.arange(NB, dtype=np.int32), (B, NB)).copy()
        paged["blocks"] = blocks_arrays(table, logical, np.full(B, NB, np.int32),
                                        device="cuda")
        return {"paged": paged, "ring": ring}

    ptoks = torch.tensor([probe.tokens], device="cuda").expand(B, m)
    tok = torch.full((B, 1), 7, dtype=torch.long, device="cuda")
    for T in (512, 2048):
        base = caches(T)
        p1 = torch.full((B, 1), T, dtype=torch.int32, device="cuda")
        outs = {}
        for kind, c in base.items():
            f, launched, flash, _ = fused_vs_separate(
                torch, model, c, p1, probe, f"{cfg.name} {kind} context {T}", kernels)
            check(launched == per_step and flash.get("mma", 0) == 0,
                  f"{cfg.name} {kind} fused step launched {launched}, flash {flash}; "
                  f"expected {per_step}")
            outs[kind] = f
        check(all(torch.equal(a, b) for a, b in zip(outs["paged"], outs["ring"])),
              f"{cfg.name} context {T}: the fused step on the paged cache differs from "
              f"the ring's")
        print(f"[fused] {cfg.name} context {T}: paged == ring bitwise (the fused "
              f"step's logits and EAT, the next two steps' logits)")
        # the two steps by graph replay in turns, on a copy of the paged cache
        # whose cur is put back after every call (each replay the same step)
        work = clone_tree(torch, base["paged"])
        cur0 = work["cur"].clone()
        pos_all = (p1 + torch.arange(1 + m, dtype=torch.int32, device="cuda")[None]
                   ).contiguous()
        pp = pos_all[:, 1:].contiguous()

        def fused():
            model.decode_and_probe(tok, at(pos_all), pos_all, work, ptoks)
            work["cur"].copy_(cur0)

        def separate():
            model.decode_step(tok, at(p1), p1, work)
            model.probe_entropy(ptoks, at(pp), pp, work)
            work["cur"].copy_(cur0)

        f_t, s_t = in_turns(torch, [fused], [separate], rounds=5, reps=20)
        f_ms, s_ms = statistics.median(f_t), statistics.median(s_t)
        fig = phases.get(f"fig21_{T}", {})
        fig_text = (f"; phase 6's decode_step + eval_eat_now {fig['decode_ms']:.3f} + "
                    f"{fig['probe_ms']:.3f} = {fig['decode_ms'] + fig['probe_ms']:.3f} ms"
                    if fig else "")
        print(f"[fig21] context {T}, B {B}, paged: fused step (decode_and_probe) "
              f"{turns_text(f_t)}, separate step (decode_step + probe_entropy) "
              f"{turns_text(s_t)}, graph replay in turns, 5 rounds; fused / separate "
              f"{f_ms / s_ms:.3f}; one read of the {weights / 1e9:.2f} GB of weights "
              f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s {read_ms:.3f} ms{fig_text} ({card})")
        phases[f"fused_{T}"] = {"fused_ms": f_ms, "separate_ms": s_ms,
                                "fused_turns": f_t, "separate_turns": s_t,
                                "weight_read_ms": read_ms}
        del work
        if T == 512:
            base512 = base["paged"]
        else:
            del base
        torch.cuda.empty_cache()

    # the every-token serve-step program, fused, 16 greedy steps
    n_steps = 16
    scfg = ServeStepConfig(sampler=SamplerConfig(greedy=True), fused_probe=True)
    step, mon0 = build_serve_step_program(model, scfg, base512)
    pos0 = torch.full((B, 1), 512, dtype=torch.int32, device="cuda")

    def run(cache) -> list:
        """The tokens, the last stop flags, the evaluation counts, then
        every tensor of the monitor state."""
        t, p, mon = tok, pos0, mon0
        out = []
        for _ in range(n_steps):
            nxt, mon, stop = step(cache, t, p, mon, None)
            out.append(nxt)
            t, p = nxt[:, None], p + 1
        return [torch.stack(out, 1), stop, mon.n_evals] + tensor_leaves(torch, mon)

    eager_c = clone_tree(torch, base512)
    reset_counts(kernels)
    eager = run(eager_c)
    launched = {name: fn.launches for name, fn in kernels.items()}
    want = {k: v * n_steps for k, v in per_step.items()}
    check(launched == want and bool((eager[2] == n_steps).all()),
          f"serve-step program: {n_steps} eager steps launched {launched} (expected "
          f"{want}), evaluations {eager[2].tolist()} (expected {n_steps} a row)")
    graph_c = clone_tree(torch, base512)

    def restore() -> None:
        for a, b in zip(tensor_leaves(torch, graph_c), tensor_leaves(torch, base512)):
            a.copy_(b)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the capture
        run(graph_c)
    torch.cuda.current_stream().wait_stream(side)
    restore()
    graph, captures = torch.cuda.CUDAGraph(), 1
    t_cap = time.perf_counter()
    with torch.cuda.graph(graph):
        g_out = run(graph_c)
    cap_s = time.perf_counter() - t_cap
    times = []
    for replay in ("cold", "warm"):
        restore()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        same = (all(torch.equal(a, b) for a, b in zip(g_out, eager))
                and all(torch.equal(a, b) for a, b in
                        zip(tensor_leaves(torch, graph_c), tensor_leaves(torch, eager_c))))
        check(same, f"serve-step program: the {replay} graph replay differs from the "
              f"eager run")
    print(f"[fused] serve-step program (build_serve_step_program, fused_probe=True, "
          f"greedy, every-token monitor) on {cfg.name} paged, B {B}, context 512: "
          f"{n_steps} eager steps launched {json.dumps(launched)}; captured as one "
          f"CUDA graph ({captures} capture, {cap_s:.2f} s; 0 when warm), cold and warm "
          f"replays == the eager run bitwise (tokens, stop flags, monitor state, "
          f"cache); replay {times[0]:.3f} / {times[1]:.3f} ms, "
          f"{times[1] / n_steps:.3f} ms per step ({card})")
    phases["fused_program"] = {"launches": launched, "replay_ms": times,
                               "ms_per_step": times[1] / n_steps}
    model.paged_attn_impl, model.paged_attn_page = saved
    del base512, eager_c, graph_c, graph, g_out, eager
    gc.collect()
    torch.cuda.empty_cache()
    phases["fused_phase_s"] = time.perf_counter() - t0
    return dict(rec, launches=launched["paged_attention"])


# ----------------------------------------------------------------- phase 6b

#: deepseek-v2-236b's depth on one card: 8 of its 60 layers (1 dense, 7 MoE:
#: 58.38 GB of bf16 weights).  At 9 (66.33 GB) the init's transients, the
#: caches, the prefill's buffers and the graph pools would not fit beside
#: them in the card's 80 GB.
MLA_LAYERS = 8


def mla_attn_case(torch, dtype, m, C, *, expanded=False, seed=0):
    """Flash inputs at MLA's shapes, for the serve's B 4 rows and H 128
    heads.  Absorbed (the serving path): q (B, m, H, 576) against one kv
    head, k = cat(c, kr) (B, C, 1, 576) and v = c, the view k[..., :512]
    (B, C, 1, 512), as ``mla_absorbed_attend`` builds them.  Expanded (the training forward):
    q and k (B, C, H, 192), v (B, C, H, 128).  m == C: a left-padded
    prefill (row b has 64 b pad slots); m < C: the m newest of row b's
    C - 100 b tokens (the rest of the ring empty)."""
    B, H = 4, 128
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if expanded:
        q, k, v = rnd(B, m, H, 192), rnd(B, C, H, 192), rnd(B, C, H, 128)
    else:
        q, c, kr = rnd(B, m, H, 576), rnd(B, C, 512), rnd(B, C, 64)
        k = torch.cat([c, kr], dim=-1)[:, :, None, :]
        v = k[..., :512]
    ar = torch.arange(C, device="cuda", dtype=torch.int32)[None]
    rows = torch.arange(B, device="cuda", dtype=torch.int32)[:, None]
    if m == C:
        pad = rows * 64
        kv_pos = torch.where(ar >= pad, ar - pad, -1).to(torch.int32).contiguous()
        q_pos = kv_pos
    else:
        n = C - 100 * rows
        kv_pos = torch.where(ar < n, ar, -1).to(torch.int32).contiguous()
        q_pos = (n - m + ar[:, :m]).to(torch.int32).contiguous()
    return dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)


def mla_kernel_checks(torch, F, fa, capacity: int, ptxas: list[str]) -> dict:
    """Phase 6b's flash checks at the absorbed shapes of
    ``deepseek-v2-236b``'s serve (the cohort prefill, m 512 over 512 slots;
    a decode, m 1 over the paged view of ``capacity`` slots), bf16 on the
    MLA kernel (``"mla"``; the decode split over the keys, its split count
    printed) and float32 on the scalar kernel, and at the expanded training
    shape (192/128, 128 kv heads), both on the scalar kernel; each against
    the plain version within phase 3's bars (float32 1e-5; bf16 one ulp +
    2^-7 x the attention of |v|).  Each case is timed by CUDA-graph replay,
    in turns with SDPA where SDPA takes the shape (3 rounds, medians;
    whether the two ranges overlap is printed), the plain version by CUDA
    events, with its bound (the absorbed v is a view of k: its bytes are
    k's).  ``ptxas``: the MLA kernels' ptxas lines, printed first.  Returns
    the flash record: the bf16 prefill's readings, with ``decode`` and
    ``expanded`` records beside them."""
    scale = 1.0 / math.sqrt(128 + 64)
    bad, recs = [], {}
    for line in ptxas:
        print(f"[kernels] mla flash_attention ptxas {line}")
    cases = [("prefill", 512, 512, False), ("decode", 1, capacity, False),
             ("fused", 3, capacity, False), ("expanded", 512, 512, True)]
    for what, m, C, expanded in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).removeprefix("torch.")
            c = mla_attn_case(torch, dtype, m, C, expanded=expanded)
            args = (c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
            want = fa.flash_variant(dtype, c["q"].shape[-1], c["v"].shape[-1])
            check(want == ("mla" if dtype == torch.bfloat16 and not expanded
                           else "scalar"), f"mla {what} {dn}: routed to {want}")
            before = dict(fa.flash_attention_cuda.variant_launches)
            out = fa.flash_attention_cuda(*args, scale=scale)
            after = fa.flash_attention_cuda.variant_launches
            launched = {x: after[x] - before[x] for x in after}
            ref = fa.attention_plain(*args, scale=scale)
            spread = (fa.attention_plain(c["q"], c["k"], c["v"].abs(), c["q_pos"],
                                         c["kv_pos"], scale=scale)
                      if dtype == torch.bfloat16 else None)
            err, ok, tol = agree(torch, "flash_attention", dn, out, ref, spread)
            B, _, Hq, Dk = c["q"].shape
            Hkv, Dv = c["k"].shape[2], c["v"].shape[-1]
            label = f"{what} {dn} B{B} m{m} C{C} Hq{Hq} Hkv{Hkv} Dk{Dk} Dv{Dv}"
            if launched != {x: int(x == want) for x in launched} or not ok:
                bad.append(f"{label}: launched {launched}, max abs err {err:.3e} ({tol})")
            # each input read once: an absorbed v is k's first 512 columns
            per_set = (nbytes(c["q"], c["k"], c["q_pos"], c["kv_pos"], out)
                       + (0 if fa.is_k_prefix(c["v"], c["k"]) else nbytes(c["v"])))
            sets = [c] + [mla_attn_case(torch, dtype, m, C, expanded=expanded, seed=s)
                          for s in range(1, n_sets(per_set))]
            calls = [lambda s=s: fa.flash_attention_cuda(
                s["q"], s["k"], s["v"], s["q_pos"], s["kv_pos"], scale=scale)
                for s in sets]
            lib_calls, lib = None, None
            if dtype == torch.bfloat16:
                mask = ((c["kv_pos"][:, None, None, :] >= 0)
                        & (c["kv_pos"][:, None, None, :] <= c["q_pos"][:, None, :, None]))
                lib_calls = [lambda s=s: F.scaled_dot_product_attention(
                    s["q"].transpose(1, 2), s["k"].transpose(1, 2), s["v"].transpose(1, 2),
                    attn_mask=mask, scale=scale, enable_gqa=Hq != Hkv) for s in sets]
                try:
                    lib_calls[0]()
                    torch.cuda.synchronize()
                except (RuntimeError, TypeError) as e:
                    lib_calls, lib = None, f"none (SDPA refused: {str(e).splitlines()[0]})"
            reps = 3 if m > 1 else 20
            if lib_calls:
                k_t, l_t = in_turns(torch, calls, lib_calls, rounds=3, reps=reps)
                k_ms, l_ms = statistics.median(k_t), statistics.median(l_t)
                apart = max(k_t) < min(l_t) or max(l_t) < min(k_t)
                timing = (f"graph replay in turns, 3 rounds: kernel {turns_text(k_t)}, "
                          f"sdpa {turns_text(l_t)}, kernel / sdpa {k_ms / l_ms:.4f}, "
                          f"ranges {'apart' if apart else 'overlap'}")
            else:
                k_ms, l_ms = graph_ms(torch, calls, reps), None
                timing = f"kernel {k_ms:.4f} ms (graph replay), sdpa {lib or 'not timed'}"
            p_ms = time_ms(torch, [lambda: fa.attention_plain(*args, scale=scale)],
                           iters=3, warmup=1)
            pairs = valid_pairs(torch, c["q_pos"], c["kv_pos"])
            b_ms, b_by = bound_ms(per_set, pairs * Hq * 2 * (Dk + Dv), dn)
            n_split = fa.mla_splits(B, m, Hq, Hkv, C) if want == "mla" else 0
            splits = (f" ({n_split} splits of {fa.MLA_SPLIT_KEYS} keys + merge)"
                      if n_split else "")
            print(f"[kernels] mla flash_attention {label} variant {want}{splits}: max_abs_err "
                  f"{err:.3e} ({tol}); {timing}; plain {p_ms:.4f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by}: {pairs} valid pairs x {Hq} heads, "
                  f"{per_set / 1e6:.1f} MB), kernel at {b_ms / k_ms:.4f} of it")
            recs[what, dn] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=l_ms, variant=want)
            del c, sets, calls, lib_calls, out, ref, spread
            torch.cuda.empty_cache()
    check(not bad, "mla flash kernel vs plain: " + "; ".join(bad))
    rec = dict(recs["prefill", "bfloat16"])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    for what in ("decode", "fused", "expanded"):
        rec[what] = {k: v for k, v in recs[what, "bfloat16"].items() if k != "max_abs_err"}
    rec["float32_ms"] = {what: recs[what, "float32"]["ms"] for what in
                         ("prefill", "decode", "fused", "expanded")}
    return rec


def mla_phase(torch, np, F, kernels: dict, phases: dict, card: str,
              profile_dir=None) -> dict:
    """Phase 6b: ``deepseek-v2-236b`` (MLA + MoE) at full width and
    ``MLA_LAYERS`` of its 60 layers.  The flash kernel at MLA's shapes
    (``mla_kernel_checks``); kernel path vs plain path of the model
    (float32 cut to 2 layers, 1e-5; bf16 at 8 layers within
    ``MOE_BF16_TOL``, the logits with the plain path's expert routes on both
    paths); then ``serve_cell``: the paged self-EAT serve of phase 4's
    traffic, every flash call the MLA kernel (8 per forward: prefills,
    decodes, probes and rollouts all attend through the absorbed form) and
    none scalar, no paged read (MLA keeps the gather path), every entropy
    call mma, 3 eager and 3 warm graph serves in turns, and a ring serve
    bitwise the paged one.  Returns {"launches": the profiled
    serve's counts, "flash": the kernel record}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.scheduler import SlotScheduler

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe = make_probe(1, (6,))
    full = get_config("deepseek-v2-236b")
    prompts, lens = serve_workload(np, vocab=full.vocab)
    capacity = SlotScheduler.required_capacity(prompts.shape[1], len(lens), 4, 64)
    from repro_torch.kernels import _build

    ptxas = [line for kernel in ("flash_mla_kernel", "flash_mla_merge_kernel")
             for line in ptxas_report(_build.BUILD_LOG.get("flash_attention", ""), kernel)]
    rec = mla_kernel_checks(torch, F, fa, capacity, ptxas)

    # float32, full width, depth cut to 2 layers (1 dense, 1 MoE: 21.4 GB)
    cfg32 = dataclasses.replace(full, name=full.name + "-2L-f32", n_layers=2,
                                dtype="float32")
    f32_kernel_vs_plain(torch, cfg32, prompts, probe)

    cfg = dataclasses.replace(full, name=f"{full.name}-{MLA_LAYERS}L", n_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda"))
    torch.cuda.synchronize()
    phases["mla_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    mo, ml = cfg.moe, cfg.mla
    print(f"[model] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
          f"({mo.first_k_dense} dense, ff {mo.dense_d_ff}) d{cfg.d_model} H{cfg.n_heads} "
          f"MLA kv_lora {ml.kv_lora_rank} q_lora {ml.q_lora_rank} nope "
          f"{ml.qk_nope_head_dim} rope {ml.qk_rope_head_dim} v {ml.v_head_dim}; experts "
          f"{mo.n_routed} routed (top {mo.top_k}) + {mo.n_shared} shared of "
          f"{mo.d_expert} Vp{cfg.padded_vocab} {cfg.dtype}: {n_params / 1e9:.3f} B "
          f"params, {n_params * 2 / 1e9:.2f} GB, init {phases['mla_init_s']:.1f} s")
    # bf16 at 8 layers
    moe_bf16_kernel_vs_plain(torch, model, prompts, probe)
    # the fused step (m 3 through the absorbed MLA kernel) against the
    # separate step, after a 64-token prefill of two prompts
    from repro_torch.serving.cache import alloc_cache

    cache = alloc_cache(cfg, 2, 96, device="cuda")
    pos = torch.arange(64, dtype=torch.int32, device="cuda").expand(2, 64).contiguous()
    model.prefill(torch.as_tensor(prompts[:2, -64:], device="cuda"), pos, pos, cache)
    _, launched, flash, _ = fused_vs_separate(
        torch, model, cache, torch.full((2, 1), 64, dtype=torch.int32, device="cuda"),
        probe, cfg.name, kernels)
    want = {"mma": 0, "mla": cfg.n_layers, "wide": 0, "scalar": 0}
    check(flash == want and launched["entropy_probe"] == 1
          and launched["paged_attention"] == 0,
          f"{cfg.name} fused step: flash {flash} (expected {want}), launches {launched}")
    phases["mla_fused_launches"] = {"flash": flash, **launched}
    del cache

    L = cfg.n_layers
    profiled = serve_cell(
        torch, np, model, probe, prompts, lens, kernels, phases, card, key="mla",
        flash_want=lambda forwards, prefills: {"mma": 0, "mla": L * forwards, "wide": 0,
                                               "scalar": 0},
        flash_text=f"{L} mla per forward", paged_want=0, turns=3,
        profile_path=Path(profile_dir) / "profile_mla.txt" if profile_dir else None)
    del model
    phase_end(torch, phases, "mla", cfg.name, base, t_phase, card)
    return {"launches": profiled, "flash": rec}


# ----------------------------------------------------------------- phase 6c

#: the dense configs of phase 6c beside gemma-7b, each at full width and
#: depth, checked kernel path against plain path without a serve, with the
#: flash variant its bf16 prefills must take
DENSE_CHECKS = (("gemma-2b", "wide"), ("codeqwen1.5-7b", "mma"))


def wide_kernel_checks(torch, F, fa, pa, ep, ptxas: list[str]) -> dict:
    """Phase 6c's kernel checks, bf16: the wide flash kernel at gemma-7b's
    (16 q and 16 kv heads of 256) and gemma-2b's (8 q heads on 1 kv head)
    prefills, with the scalar kernel forced at gemma-7b's as a yardstick;
    codeqwen1.5-7b's flash (32/32 heads of 128, ``mma``); paged at D 256
    (m 1 and 2, g 1 and 8) and codeqwen's (m 1, 32/32 of 128); the entropy
    probe over gemma's tied 3072 and 2048 x 256,000 tables and codeqwen's
    untied 4096 x 92,416 head.  ``ptxas``: the wide kernel's ptxas lines,
    printed first.  Returns {kernel: the gemma-7b record, with the other
    shapes beside it}."""
    bad = []
    for line in ptxas:
        print(f"[kernels] gemma flash_attention ptxas {line}")
    flash = flash_shape_check(torch, F, fa, "gemma-7b", 16, 16, 256, bad, scalar=True)
    flash["gemma-2b"] = flash_shape_check(torch, F, fa, "gemma-2b", 8, 1, 256, bad)
    flash["codeqwen1.5-7b"] = flash_shape_check(torch, F, fa, "codeqwen1.5-7b", 32, 32,
                                                128, bad)
    paged = {(m, what): paged_shape_check(torch, pa, what, m, Hq, Hkv, D, bad)
             for what, Hq, Hkv, D in (("gemma-7b", 16, 16, 256), ("gemma-2b", 8, 1, 256))
             for m in (1, 2)}
    paged[1, "codeqwen1.5-7b"] = paged_shape_check(torch, pa, "codeqwen1.5-7b", 1, 32, 32,
                                                   128, bad)
    rec_paged = dict(paged[1, "gemma-7b"],
                     max_abs_err=max(r["max_abs_err"] for r in paged.values()))
    rec_paged.update({f"{what} m{m}": r for (m, what), r in paged.items()
                      if (m, what) != (1, "gemma-7b")})
    entropy = entropy_shape_check(torch, ep, "gemma-7b", 3072, 256_000, 256_000, True, bad)
    entropy["gemma-2b"] = entropy_shape_check(torch, ep, "gemma-2b", 2048, 256_000, 256_000,
                                              True, bad)
    entropy["codeqwen1.5-7b"] = entropy_shape_check(torch, ep, "codeqwen1.5-7b", 4096,
                                                    92_416, 92_416, False, bad)
    torch.cuda.empty_cache()
    check(not bad, "gemma kernel vs plain: " + "; ".join(bad))
    for rec in (flash, entropy):
        rec["max_abs_err"] = max([rec["max_abs_err"]] + [
            r["max_abs_err"] for r in rec.values() if isinstance(r, dict)])
    return {"flash_attention": flash, "paged_attention": rec_paged,
            "entropy_probe": entropy}


#: a bf16 dense model at full depth against its plain path: the logits'
#: relative L2 and their largest difference over max |logits| (phases 5b
#: and 6b's bar)
DENSE_BF16_TOL = 3e-2
#: the kernel path's EAT of a bf16 dense model at full depth against the
#: EAT of the same weights in float32 on the plain path, in nats.  Read on
#: an H100 (gemma-7b, whose peaked random-weight distributions give EATs of
#: 1.5-3.7 nats): the kernel path 4.16e-2 from float32, the bf16 plain path
#: 7.70e-2, the kernel path 3.54e-2 from the bf16 plain path.  The bar lies
#: between the kernel path's reading and what bf16 rounding moves the plain
#: path by
DENSE_EAT_TOL = 6e-2


#: zamba2-2.7b's logits, kernel path against plain path in bf16 at its 54
#: blocks (relative L2 and max |diff| / max |logits|, each).  Its 45 Mamba2
#: blocks carry bf16 differences further than a dense model's depth: read
#: on an H100 (phase 6d, the weights of seeds 0, 1 and 2, prefill and
#: decode): the kernel path 2.04e-2 to 3.03e-2 from the plain path, where
#: each bf16 path lies 5.09e-2 to 5.66e-2 (relative L2) from the float32
#: path of the same weights, the kernel path no farther than the plain
#: one.  The bar lies between the two.
HYBRID_BF16_TOL = 4.5e-2
#: the seeds of zamba2-2.7b weights held to HYBRID_BF16_TOL beside the
#: served model's (seed 0, ``dense_model``)
HYBRID_SEEDS = (1, 2)


def dense_bf16_kernel_vs_plain(torch, model, prompts, probe, flash_want: str,
                               tol: float = DENSE_BF16_TOL, frames=None,
                               flash_calls: int | None = None, image=None) -> None:
    """``kernel_vs_plain`` on a bf16 dense (or hybrid, or encoder-decoder on
    ``frames``, or VLM with ``image`` patches) model at full depth: the
    logits within ``tol``, and the
    kernel path's launches: ``flash_calls`` flash calls (by default one per
    attention block: the prefill), every one
    ``flash_want``, one scan call per SSM block on the tensor cores, and
    one entropy call on the tensor cores.  Then the same weights cast to float32
    (exactly: each bf16 value is a float32 one) through the plain path: the
    kernel path's EAT within ``DENSE_EAT_TOL`` nats of it.  Printed beside:
    both bf16 paths' logits' distance from it, the plain bf16 path's EAT
    distance from it (what bf16 rounding alone moves), and how far apart
    the float32 EATs of the two requests lie (what a probe of the wrong
    row would move).  The model is cast back to bf16 after, bitwise its
    weights before."""
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ss

    cfg = model.cfg
    n_attn = sum(kind != "ssm" for kind in cfg.block_kinds())
    n_ssm = cfg.n_layers - n_attn
    n_flash = n_attn if flash_calls is None else flash_calls
    f0 = dict(fa.flash_attention_cuda.variant_launches)
    e0 = dict(ep.entropy_probe_cuda.variant_launches)
    s0 = dict(ss.ssd_scan_cuda.variant_launches)
    outs = kernel_vs_plain(torch, model, prompts, probe, frames, image)
    flash = {x: n - f0[x] for x, n in fa.flash_attention_cuda.variant_launches.items()}
    ent = {x: n - e0[x] for x, n in ep.entropy_probe_cuda.variant_launches.items()}
    scan = {x: n - s0[x] for x, n in ss.ssd_scan_cuda.variant_launches.items()}
    check(flash == {x: n_flash * (x == flash_want) for x in flash}
          and ent == {"mma": 1, "scalar": 0} and scan == {"mma": n_ssm, "scalar": 0},
          f"{cfg.name}: kernel path launched flash {flash}, entropy {ent}, ssd_scan "
          f"{scan}; expected {n_flash} {flash_want}, one mma and {n_ssm} mma")
    # the float32 twin: the bf16 weights cast up in place (exactly), the
    # float32 ones (a Mamba2 block's dt_bias, A_log, D) as they are; cast
    # back after, bitwise the weights before
    bf16 = [p for p in model.parameters() if p.dtype == torch.bfloat16]
    for p in bf16:
        p.data = p.data.float()
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = kernel_vs_plain(torch, model, prompts, probe, frames, image)["plain"]
    for p in bf16:
        p.data = p.data.bfloat16()
    model.cfg = cfg
    for i, what in enumerate(("prefill logits", "decode logits")):
        k, p = outs["cuda"][i], outs["plain"][i]
        rel, top = rel_l2(k, p), ((k - p).abs().max() / p.abs().max()).item()
        check(bool(torch.isfinite(k).all()) and rel < tol and top < tol,
              f"{cfg.name} {what}: kernel vs plain relative L2 {rel}, max |diff| / "
              f"max |logits| {top} (tol {tol:g} each)")
        print(f"[model] {cfg.name} {what}: kernel vs plain relative L2 {rel:.3e}, max "
              f"|diff| / max |logits| {top:.3e} (tol {tol:g} each); against "
              f"the float32 path of the same weights, relative L2: kernel "
              f"{rel_l2(k, f32[i]):.3e}, plain {rel_l2(p, f32[i]):.3e}")
    eat_k, eat_p, eat_f = outs["cuda"][2], outs["plain"][2], f32[2]
    d_eat = (eat_k - eat_f).abs().max().item()
    check(bool(torch.isfinite(eat_k).all()) and d_eat < DENSE_EAT_TOL,
          f"{cfg.name} EAT: kernel path {eat_k.tolist()} vs float32 {eat_f.tolist()} "
          f"(tol {DENSE_EAT_TOL:g} nats)")
    print(f"[model] {cfg.name} EAT kernel {[round(x, 4) for x in eat_k.tolist()]} plain "
          f"{[round(x, 4) for x in eat_p.tolist()]} float32 "
          f"{[round(x, 4) for x in eat_f.tolist()]}: kernel from float32 max diff "
          f"{d_eat:.3e} (tol {DENSE_EAT_TOL:g} nats); plain from float32 "
          f"{(eat_p - eat_f).abs().max().item():.3e}, kernel from plain "
          f"{(eat_k - eat_p).abs().max().item():.3e}, the two requests' float32 EATs "
          f"{(eat_f - eat_f.flip(0)).abs().max().item():.3e} apart; kernel path "
          f"launches: flash {json.dumps(flash)}, entropy {json.dumps(ent)}")
    del outs, f32
    gc.collect()
    torch.cuda.empty_cache()


def dense_model(torch, cfg, phases: dict, key: str, card: str):
    """``cfg`` with seeded random weights on the card, its init timed and
    its shape printed.  Returns (model, weight bytes)."""
    from repro_torch.models.model import Model, init_params

    t0 = time.perf_counter()
    model = Model(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda"))
    torch.cuda.synchronize()
    phases[f"{key}_init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[model] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} Hq{cfg.n_heads}/"
          f"Hkv{cfg.n_kv_heads} hd{cfg.resolved_head_dim} ff{cfg.d_ff} ({cfg.activation}) "
          f"Vp{cfg.padded_vocab} {'tied' if cfg.tie_embeddings else 'untied'} "
          f"{cfg.dtype}: {n_params / 1e9:.3f} B params, {weights / 1e9:.2f} GB, init "
          f"{phases[f'{key}_init_s']:.1f} s ({card})")
    return model, weights


def gemma_phase(torch, np, F, kernels: dict, phases: dict, card: str,
                profile_dir=None) -> dict:
    """Phase 6c: ``gemma-7b`` (arXiv:2403.08295) at full width and depth,
    the MLA model freed first.  The kernels at its shapes and at gemma-2b's
    and codeqwen1.5-7b's (``wide_kernel_checks``); kernel path vs plain path
    of gemma-7b (float32 cut to 2 layers, 1e-5; bf16 at the full 28: the
    logits within ``DENSE_BF16_TOL``, the EAT within ``DENSE_EAT_TOL`` of
    float32); then ``serve_cell``: the paged self-EAT serve of phase 4's
    traffic (prompts over its 256,000 vocabulary), every flash
    call the wide kernel (28 per prefill) and none scalar, every entropy
    call mma, a profiled serve and a ring serve bitwise the paged one.
    Then gemma-2b and codeqwen1.5-7b at full width and depth, each freed
    before the next: kernel path vs plain path (float32 at 2 layers; bf16
    at full depth, flash ``wide`` and ``mma`` respectively).  Returns
    {"launches": the profiled serve's counts, "kernels": the records}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels import _build
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptxas = ptxas_report(_build.BUILD_LOG.get("flash_attention", ""), "flash_wide_kernel")
    recs = wide_kernel_checks(torch, F, fa, pa, ep, ptxas)
    probe = make_probe(1, (6,))

    cfg = get_config("gemma-7b")
    prompts, lens = serve_workload(np, vocab=cfg.vocab)
    check(int(prompts.max()) < cfg.vocab, "prompt ids past the vocab")
    f32_kernel_vs_plain(torch, dataclasses.replace(cfg, name=cfg.name + "-2L-f32",
                                                   n_layers=2, dtype="float32"),
                        prompts, probe)
    model, weights = dense_model(torch, cfg, phases, "gemma", card)
    dense_bf16_kernel_vs_plain(torch, model, prompts, probe, "wide")
    # the serves' peak, not the float32 twin's of the check above
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    profiled = serve_cell(
        torch, np, model, probe, prompts, lens, kernels, phases, card, key="gemma",
        flash_want=lambda forwards, prefills: {"mma": 0, "mla": 0, "wide": L * prefills,
                                               "scalar": 0},
        flash_text=f"{L} wide per prefill", paged_want=None,
        profile_path=Path(profile_dir) / "profile_gemma.txt" if profile_dir else None)
    del model
    phase_end(torch, phases, "gemma", cfg.name, base, t_phase, card, weights=weights,
              over="its serves")

    for name, variant in DENSE_CHECKS:
        t0 = time.perf_counter()
        full = get_config(name)
        ps, _ = serve_workload(np, vocab=full.vocab)
        f32_kernel_vs_plain(torch, dataclasses.replace(full, name=name + "-2L-f32",
                                                       n_layers=2, dtype="float32"),
                            ps, probe)
        model, _ = dense_model(torch, full, phases, name, card)
        dense_bf16_kernel_vs_plain(torch, model, ps, probe, variant)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        phases[f"{name}_s"] = time.perf_counter() - t0
    return {"launches": profiled, "kernels": recs}


# ----------------------------------------------------------------- phase 6d

def zamba_kernel_checks(torch, F, fa, pa, ep, ptxas: list[str]) -> dict:
    """Phase 6d's kernel checks at ``zamba2-2.7b``'s shapes: bf16 flash at the
    shared block's prefill (B 4, S 512, 32 q / 32 kv heads of 80, on the
    ``(80, 80)`` instance of the tensor-core kernel), paged at D 80 (m 1
    and 2, g 1) and the entropy probe over the untied 2560 x 32,000 head
    (the scan at d_state 64 runs in phase 3: a profiler session this late
    in the process reads no device events, and its check counts kernels
    by the profiler).  ``ptxas``: the (80, 80) instance's lines, printed
    first.  Returns {kernel: record}."""
    bad = []
    for line in ptxas:
        print(f"[kernels] zamba2 flash_attention ptxas {line}")
    flash = flash_shape_check(torch, F, fa, "zamba2-2.7b", 32, 32, 80, bad)
    if flash["variant"] != "mma":
        bad.append(f"zamba2-2.7b flash routes to {flash['variant']}, not mma")
    paged = [paged_shape_check(torch, pa, "zamba2-2.7b", m, 32, 32, 80, bad)
             for m in (1, 2)]
    rec_paged = dict(paged[0], max_abs_err=max(r["max_abs_err"] for r in paged),
                     m2=paged[1])
    entropy = entropy_shape_check(torch, ep, "zamba2-2.7b", 2560, 32_000, 32_000,
                                  False, bad)
    torch.cuda.empty_cache()
    check(not bad, "zamba2 kernel vs plain: " + "; ".join(bad))
    return {"flash_attention": flash, "paged_attention": rec_paged,
            "entropy_probe": entropy}


def hybrid_bf16_kernel_vs_plain(torch, model, prompts, probe, seed: int) -> None:
    """``dense_bf16_kernel_vs_plain`` at ``HYBRID_BF16_TOL``; where it fails,
    ``hybrid_block_gap`` first prints where the two paths part."""
    try:
        dense_bf16_kernel_vs_plain(torch, model, prompts, probe, "mma", HYBRID_BF16_TOL)
    except SystemExit:
        hybrid_block_gap(torch, model, prompts, seed)
        raise


def hybrid_block_gap(torch, model, prompts, seed: int) -> None:
    """Where a hybrid's kernel path and plain path part: the residual stream
    after every block of ``kernel_vs_plain``'s prefill (64 tokens of two
    prompts: the Mamba2 blocks on the SSD scan kernel or its plain version,
    the shared blocks on flash or the plain attention) and of its decode
    step (the shared blocks' paged read at D 80 or the plain attention; a
    decode's Mamba2 step has no kernel), recorded through the transformer's
    block functions, and its relative L2 between the two paths block by
    block.  Each block's growth factor (its gap over the previous block's)
    is given to the block's kind: the geometric mean and the product of the
    factors per kind say which kind carries the gap."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.cache import alloc_cache

    cfg = model.cfg
    kinds = cfg.block_kinds()
    names = ("ssm_block_full", "ssm_block_step", "attn_block_cached")
    originals = {n: getattr(tfm, n) for n in names}
    toks = torch.as_tensor(prompts[:2, -64:], device="cuda")
    pos = torch.arange(64, dtype=torch.int32, device="cuda").expand(2, 64).contiguous()
    nxt = torch.full((2, 1), 7, dtype=torch.long, device="cuda")
    p1 = torch.full((2, 1), 64, dtype=torch.int32, device="cuda")
    streams = {}
    try:
        for impl in ("cuda", "plain"):
            rec: list = []

            def wrap(fn):
                def call(*a, **kw):
                    out = fn(*a, **kw)
                    rec.append((out[0] if isinstance(out, tuple) else out).float())
                    return out
                return call

            for n in names:
                setattr(tfm, n, wrap(originals[n]))
            model.attn_impl = model.paged_attn_impl = model.scan_impl = impl
            cache = alloc_cache(cfg, 2, 96, device="cuda")
            model.prefill(toks, pos, pos, cache)
            prefill = list(rec)
            rec.clear()
            model.decode_step(nxt, p1, p1, cache)
            streams[impl] = (prefill, list(rec))
            for n in names:
                setattr(tfm, n, originals[n])
    finally:
        for n in names:
            setattr(tfm, n, originals[n])
        model.attn_impl, model.paged_attn_impl, model.scan_impl = "auto", "gather", "auto"
    for i, what in enumerate(("prefill", "decode")):
        k_s, p_s = streams["cuda"][i], streams["plain"][i]
        check(len(k_s) == len(p_s) == len(kinds), f"{cfg.name} block gap: recorded "
              f"{len(k_s)} and {len(p_s)} blocks, not {len(kinds)}")
        gaps = [rel_l2(a, b) for a, b in zip(k_s, p_s)]
        growth = {"ssm": [], "shared_attn": []}
        for j in range(1, len(gaps)):
            if gaps[j - 1] > 0 and gaps[j] > 0:
                growth[kinds[j]].append(gaps[j] / gaps[j - 1])
        per_kind = {k: {"blocks": len(v),
                        "geomean": math.exp(statistics.fmean(math.log(x) for x in v))
                        if v else None,
                        "product": math.prod(v) if v else None}
                    for k, v in growth.items()}
        print(f"[zamba2 gap] seed {seed} {what}: relative L2 of the residual stream, "
              f"kernel path vs plain path, after each of the {len(kinds)} blocks "
              f"(S ssm, A shared attention): "
              + " ".join(f"{'A' if k == 'shared_attn' else 'S'}{g:.2e}"
                         for k, g in zip(kinds, gaps)))
        print(f"[zamba2 gap] seed {seed} {what}: the first block's gap {gaps[0]:.3e} "
              f"({kinds[0]}), the last {gaps[-1]:.3e}; growth factor per block, "
              f"geometric mean (product): "
              + "; ".join(f"{k} {v['geomean']:.4f} ({v['product']:.3f}, {v['blocks']} "
                          f"blocks)" for k, v in per_kind.items() if v["geomean"]))


def zamba_phase(torch, np, F, kernels: dict, phases: dict, card: str, scan: dict,
                profile_dir=None) -> dict:
    """Phase 6d: ``zamba2-2.7b`` (arXiv:2411.15242: 45 Mamba2 blocks and one
    shared attention+MLP block applied 9 times, d 2560, 32 / 32 heads of
    80, d_state 64, an untied 32,000 vocabulary) at full width and depth,
    the gemma models freed first.  The kernels at its shapes
    (``zamba_kernel_checks``); kernel path vs plain path (float32 cut to
    12 blocks, two groups, 1e-5; bf16 at the full 54, on the weights of
    seed 0 and of each of ``HYBRID_SEEDS``: the logits within
    ``HYBRID_BF16_TOL``, the EAT within ``DENSE_EAT_TOL`` of float32, flash
    9 ``mma`` and the scan 45 ``mma`` on the kernel path); then
    ``serve_cell``: the paged self-EAT serve of phase 4's traffic (prompts
    over its 32,000 vocabulary), flash 9 ``mma`` per prefill and none
    scalar, the scan 45 ``mma`` per prefill, 9 paged calls per decode and
    probe forward, every entropy call mma, a profiled serve and a ring
    serve bitwise the paged one.  ``kernels``: flash, paged, entropy and
    the scan's wrappers; ``scan``: phase 3's record of the scan at
    d_state 64.  Returns {"launches": the profiled serve's counts,
    "kernels": the records}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels import _build
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.models.model import Model, init_params

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptxas = [line for line in ptxas_report(_build.BUILD_LOG.get("flash_attention", ""),
                                           "flash_mma_kernel")
             if ",80,80>" in line]
    recs = zamba_kernel_checks(torch, F, fa, pa, ep, ptxas)
    recs["ssd_scan"] = scan
    probe = make_probe(1, (6,))

    cfg = get_config("zamba2-2.7b")
    kinds = cfg.block_kinds()
    n_attn, n_ssm = kinds.count("shared_attn"), kinds.count("ssm")
    prompts, lens = serve_workload(np, vocab=cfg.vocab)
    check(int(prompts.max()) < cfg.vocab, "prompt ids past the vocab")
    f32_kernel_vs_plain(torch, dataclasses.replace(cfg, name=cfg.name + "-12L-f32",
                                                   n_layers=12, dtype="float32"),
                        prompts, probe)
    for seed in HYBRID_SEEDS:
        print(f"[model] {cfg.name}: the weights of seed {seed}")
        other = Model(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                       device="cuda"))
        hybrid_bf16_kernel_vs_plain(torch, other, prompts, probe, seed)
        del other
    model, weights = dense_model(torch, cfg, phases, "zamba2", card)
    hybrid_bf16_kernel_vs_plain(torch, model, prompts, probe, 0)
    # the serves' peak, not the float32 twin's of the check above
    torch.cuda.reset_peak_memory_stats()
    profiled = serve_cell(
        torch, np, model, probe, prompts, lens, kernels, phases, card, key="zamba2",
        flash_want=lambda forwards, prefills: {"mma": n_attn * prefills, "mla": 0,
                                               "wide": 0, "scalar": 0},
        flash_text=f"{n_attn} mma per prefill",
        paged_want=lambda forwards, prefills: n_attn * (forwards - prefills),
        scan_want=lambda prefills: {"mma": n_ssm * prefills, "scalar": 0},
        profile_path=Path(profile_dir) / "profile_zamba2.txt" if profile_dir else None)
    del model
    phase_end(torch, phases, "zamba2", cfg.name, base, t_phase, card, weights=weights,
              over="its serves")
    return {"launches": profiled, "kernels": recs}


# ----------------------------------------------------------------- phase 6e


def noncausal_flash_check(torch, F, fa, tag: str, m: int, T: int, bad: list, *,
                          encoder: bool, B: int = 4, H: int = 16, D: int = 64) -> dict:
    """bf16 flash with ``causal=False`` at an encoder-decoder's heads (``H``
    q and kv heads of ``D``) over ``T`` frames, every one valid: the
    encoder's self-attention (``encoder``: m = T queries at 0..T-1) or
    cross-attention (m queries, every one at position 0).  One launch of
    the routed variant and nothing else, against the plain version within
    phase 3's bar, timed by graph replay in turns with SDPA (no mask: every
    pair is valid), the plain version by CUDA events, and the bound.
    Failures go to ``bad``.  Returns the record, with ``variant``."""
    dn, dtype = "bfloat16", torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    want = fa.flash_variant(dtype, D, D)

    def case(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn((B, m, H, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
        kv_pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
        q_pos = (kv_pos.clone() if encoder
                 else torch.zeros((B, m), dtype=torch.int32, device="cuda"))
        return (q, k, v, q_pos, kv_pos)

    args = case(0)
    kw = dict(causal=False, scale=scale)
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, **kw)
    after = fa.flash_attention_cuda.variant_launches
    launched = {x: after[x] - before[x] for x in after}
    ref = fa.attention_plain(*args, **kw)
    spread = fa.attention_plain(*args[:2], args[2].abs(), *args[3:], **kw)
    err, ok, tol = agree(torch, "flash_attention", dn, out, ref, spread)
    if launched != {x: int(x == want) for x in launched} or not ok:
        bad.append(f"{tag} flash_attention non-causal m{m} T{T}: launched {launched}, "
                   f"not one {want}; max abs err {err:.3e} ({tol})")
    per_set = nbytes(*args) + nbytes(out)
    sets = [args] + [case(s) for s in range(1, n_sets(per_set))]
    calls = [lambda s=s: fa.flash_attention_cuda(*s, **kw) for s in sets]
    lib_sets = [tuple(x.transpose(1, 2) for x in s[:3]) for s in sets]
    lib_calls = [lambda t=t: F.scaled_dot_product_attention(*t, scale=scale)
                 for t in lib_sets]
    k_turns, l_turns = in_turns(torch, calls, lib_calls)
    p_ms = time_ms(torch, [lambda s=s: fa.attention_plain(*s, **kw) for s in sets],
                   iters=6)
    flops = 4 * B * H * m * T * D             # every (query, frame) pair
    b_ms, b_by = bound_ms(per_set, flops, dn)
    k_ms, l_ms = statistics.median(k_turns), statistics.median(l_turns)
    what = "the encoder's self-attention" if encoder else "cross-attention, q at 0"
    print(f"[kernels] {tag} flash_attention {dn} non-causal ({what}) B{B} m{m} T{T} "
          f"Hq{H} Hkv{H} D{D} variant {want}: max_abs_err {err:.3e} ({tol}); graph "
          f"replay in turns, 5 rounds: kernel {turns_text(k_turns)}, sdpa "
          f"{turns_text(l_turns)}; kernel / sdpa {k_ms / l_ms:.3f}; plain {p_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}: {per_set / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP), kernel at {b_ms / k_ms:.3f} of it")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms, variant=want)


def encdec_kernel_checks(torch, F, fa, pa, ep, ptxas: list[str]) -> dict:
    """Phase 6e's kernel checks at ``seamless-m4t-large-v2``'s shapes, bf16:
    flash with ``causal=False`` at the encoder's self-attention (B 4, 1024
    frames, 16 / 16 heads of 64) and at cross-attention (m 1 against 1024
    frames, q at 0), both on the ``(64, 64)`` instance of the tensor-core
    kernel; paged at D 64 (m 1 and 2, g 1); the entropy probe over the
    untied 1024 x 256,256 head, with ``torch.matmul`` + ``logsumexp`` (the
    logits and their normaliser, not the entropy) timed beside as a
    yardstick.  ``ptxas``: the (64, 64) instance's lines, printed first.
    Returns {kernel: record}, flash's cross-attention case under
    ``cross_m1``."""
    tag = "seamless-m4t-large-v2"
    bad = []
    for line in ptxas:
        print(f"[kernels] seamless flash_attention ptxas {line}")
    flash = noncausal_flash_check(torch, F, fa, tag, 1024, 1024, bad, encoder=True)
    flash["cross_m1"] = noncausal_flash_check(torch, F, fa, tag, 1, 1024, bad,
                                              encoder=False)
    for rec in (flash, flash["cross_m1"]):
        if rec["variant"] != "mma":
            bad.append(f"{tag} flash routes to {rec['variant']}, not mma")
    flash["max_abs_err"] = max(flash["max_abs_err"], flash["cross_m1"]["max_abs_err"])
    paged = [paged_shape_check(torch, pa, tag, m, 16, 16, 64, bad) for m in (1, 2)]
    rec_paged = dict(paged[0], max_abs_err=max(r["max_abs_err"] for r in paged),
                     m2=paged[1])
    entropy = entropy_shape_check(torch, ep, tag, 1024, 256_256, 256_206, False, bad)
    c = entropy_case(torch, torch.bfloat16, 4, 1024, 256_256, 256_206, False)
    entropy["matmul_logsumexp_ms"] = graph_ms(torch, [
        lambda: torch.logsumexp(torch.matmul(c["h"], c["w"]).float(), dim=-1)])
    print(f"[kernels] {tag} entropy_probe yardstick: bf16 torch.matmul(h, w) + float32 "
          f"logsumexp (the logits' normaliser, no entropy) "
          f"{entropy['matmul_logsumexp_ms']:.4f} ms (graph replay), the kernel "
          f"{entropy['ms']:.4f} ms")
    del c
    torch.cuda.empty_cache()
    check(not bad, "seamless kernel vs plain: " + "; ".join(bad))
    return {"flash_attention": flash, "paged_attention": rec_paged,
            "entropy_probe": entropy}


def reason_result(np, st, ans, trace) -> list[dict]:
    """Per row of a finished ``reason()``: its reasoning tokens, count, exit
    reason, forced answer and EAT trace (per chunk: tokens, evaluations,
    the EMA variance and the last EAT), for ``check_same``."""
    toks = st.out_tokens.cpu().numpy()
    n = st.n_reasoning.cpu().numpy()
    stop = st.monitor.stop_flag.cpu().numpy()
    ended = st.ended_think.cpu().numpy()
    ans = ans.cpu().numpy()
    rows = [[x.cpu().numpy().tolist() for x in rec] for rec in trace]
    return [{"n_reasoning": int(n[b]), "slot": b,
             "exit_reason": "eat" if stop[b] else "end_think" if ended[b] else "budget",
             "reasoning_tokens": toks[b, :n[b]], "answer_tokens": ans[b],
             "eat_trace": [tuple(r[b] for r in rec) for rec in rows]}
            for b in range(len(n))]


def reason_cell(torch, np, model, probe, prompts, lens, inputs: list, kernels: dict,
                phases: dict, card: str, *, key: str, profile_path, start_kw: str,
                per_prefill: int, prefill_text: str, flash_per_forward: int,
                extra_slots: int = 0) -> dict:
    """A model reasoned on side inputs the way the reference takes them
    (its ``serve()`` carries none): ``start(prompts, lens, **{start_kw:
    inputs[i]})`` (an encoder-decoder's ``frames``, a VLM's
    ``image_embeds``), ``reason()`` to every row's exit, ``force_answer(4)``,
    on one engine (ring cache of the prompts, ``extra_slots`` more (a VLM's
    patches), the budget and the answer; budget 64, chunk 16, greedy, an EAT
    probe every 8 tokens, exit at the 2nd evaluation).  Two batches
    (``prompts``/``lens`` halves and ``inputs[0]``, ``inputs[1]``): the
    first cold (its captures), warm and eager; the second warm and eager
    through the first's graphs.  Checks: warm == cold == eager bitwise in
    each batch (tokens, exits, per-chunk EAT traces, answers), 0 captures
    and one snapshot per chunk warm, ``per_prefill`` flash launches in each
    prefill, all ``mma`` (``prefill_text`` says which), flash
    ``flash_per_forward`` calls and paged one call per layer per decode and
    probe forward, every entropy call mma, at least one EAT exit; one more
    warm reason under the profiler, its counts the warm one's.  Returns the
    profiled reason's launches."""
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.serving import device_loop
    from repro_torch.serving.cache import CacheConfig, page_align
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = model.cfg
    B, budget, chunk, answer = 4, 64, 16, 4
    L = cfg.n_layers
    capacity = page_align(extra_slots + prompts.shape[1] + budget + len(probe) + answer
                          + 1, 16)
    ecfg = EngineConfig(max_reasoning_tokens=budget, capacity=capacity, chunk_len=chunk,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind="ring", page_size=16, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e9), probe=probe,
                           schedule="every_n", every_n=8, min_evals=2)
    eng = ReasoningEngine(model, ecfg, mon)
    watch = Watch(torch, eng, device_loop, kernels)
    trace = []
    decode_chunk = eng.executor.decode_chunk

    def traced(*a, **kw):
        st = decode_chunk(*a, **kw)
        s = st.monitor.stop_state
        # device copies: the replay's output buffers are written again by
        # the next chunk; read after the run, no host read inside it
        trace.append([x.clone() for x in (st.n_reasoning, st.monitor.n_evals,
                                          s.ema.var, s.last)])
        return st

    eng.executor.decode_chunk = traced
    fa = kernels["flash_attention"]

    def run(half: int, what: str, eager: bool = False):
        p, n = prompts[4 * half:4 * half + B], lens[4 * half:4 * half + B]
        trace.clear()
        watch.begin()
        torch.cuda.synchronize()
        t = time.perf_counter()
        f0 = dict(fa.variant_launches)
        st = eng.start(p, n, None, **{start_kw: inputs[half]})
        prefill_flash = {x: c - f0[x] for x, c in fa.variant_launches.items()}
        st = eng.reason(st, eager=eager)
        ans, _ = eng.force_answer(st, answer, greedy=True, eager=eager)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = watch.end(f"{cfg.name} {what}", setup_reads=0)
        check(prefill_flash == {x: per_prefill * (x == "mma") for x in prefill_flash},
              f"{cfg.name} {what}: the prefill launched flash {prefill_flash}, expected "
              f"{per_prefill} mma ({prefill_text})")
        return reason_result(np, st, ans, trace), wall, counts

    cold_res, cold_s, cold = run(0, "cold graph reason")
    check(cold["tiers"]["executor"]["captures"] > 0, f"{cfg.name}: no chunk graph captured")
    print(graph_line(f"{cfg.name} ring cold reason ({cold_s:.3f} s)", cold))
    reset_counts(kernels)
    res, warm_s, warm = run(0, "warm graph reason")
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_variants = dict(kernels["flash_attention"].variant_launches)
    entropy_variants = dict(kernels["entropy_probe"].variant_launches)
    wt = warm["tiers"]["executor"]
    check(wt["captures"] == 0 and wt["replays"] == wt["chunks"] + wt["rollouts"]
          and warm["device_if"] == 0,
          f"{cfg.name}: the warm reason captured, ran a chunk or a rollout eagerly, "
          f"or read device_if: {warm['line']}")
    check_same(res, cold_res, np, f"{cfg.name}: cold and warm graph reasons differ")
    e_res, eager_s, eager = run(0, "eager reason", eager=True)
    check_same(res, e_res, np, f"{cfg.name}: the warm graph reason differs from the eager")
    # the second batch, other prompts and frames, through the same graphs
    res2, warm2_s, warm2 = run(1, "second batch warm graph reason")
    w2 = warm2["tiers"]["executor"]
    check(w2["captures"] == 0 and w2["replays"] == w2["chunks"] + w2["rollouts"],
          f"{cfg.name}: the second batch captured or ran eagerly: {warm2['line']}")
    e_res2, eager2_s, _ = run(1, "second batch eager reason", eager=True)
    check_same(res2, e_res2, np, f"{cfg.name}: the second batch's warm graph reason "
               f"differs from its eager reason (the new {start_kw} in the kept cache)")
    check(any(not np.array_equal(a["reasoning_tokens"], b["reasoning_tokens"])
              for a, b in zip(res, res2)),
          f"{cfg.name}: the second batch reasoned the first batch's tokens")
    exits = [r["exit_reason"] for r in res + res2]
    check("eat" in exits, f"{cfg.name}: no row exited by EAT: {exits}")
    # forwards: a decode and a probe forward per step of each replayed
    # chunk, answer + 1 per rollout, eager probes; flash adds the prefill's
    forwards = (2 * chunk * wt["chunks"] + (answer + 1) * wt["rollouts"]
                + wt["probe_calls"])
    want = {x: (per_prefill + flash_per_forward * forwards) * (x == "mma")
            for x in flash_variants}
    check(flash_variants == want, f"{cfg.name}: flash launches per variant "
          f"{flash_variants}, expected {want} ({per_prefill} per prefill, "
          f"{flash_per_forward} per forward, {forwards} forwards)")
    check(launches["paged_attention"] == L * forwards,
          f"{cfg.name}: paged_attention launched {launches['paged_attention']} times, "
          f"expected {L} per forward x {forwards}")
    check_entropy_mma(f"{cfg.name} reason", entropy_variants, launches["entropy_probe"])
    n_tok = sum(r["n_reasoning"] for r in res)
    phases.update({f"{key}_cold_s": cold_s, f"{key}_reason_s": warm_s,
                   f"{key}_eager_s": eager_s, f"{key}_tok_s": n_tok / warm_s,
                   f"{key}_second_s": warm2_s, f"{key}_second_eager_s": eager2_s,
                   f"{key}_chunk_ms": statistics.median(wt["chunk_ms"]),
                   f"{key}_eager_chunk_ms":
                       statistics.median(eager["tiers"]["executor"]["chunk_ms"])})
    print(f"[serve] {cfg.name} ring, start({start_kw}=) + reason() + force_answer({answer}): "
          f"{B} rows, exits {[r['exit_reason'] for r in res]} then "
          f"{[r['exit_reason'] for r in res2]}, reasoning tokens "
          f"{[r['n_reasoning'] for r in res]} then {[r['n_reasoning'] for r in res2]}; "
          f"{warm_s:.3f} s warm graph reason, {n_tok / warm_s:.1f} reasoning tokens/s "
          f"(cold {cold_s:.3f} s, eager {eager_s:.3f} s; the second batch warm "
          f"{warm2_s:.3f} s, eager {eager2_s:.3f} s); graph == eager bitwise in both "
          f"batches (tokens, exits, EAT traces, answers) ({card})")
    print(f"[serve] {cfg.name} host reads, warm graph reason: {warm['line']}")
    print(f"[serve] {cfg.name} host reads, second batch warm graph reason: {warm2['line']}")
    for kind in ("chunk", "rollout"):
        g = wt[f"{kind}_ms"]
        e = eager["tiers"]["executor"][f"{kind}_ms"]
        print(f"[{kind}] {cfg.name} executor: replay {statistics.median(g):.3f} ms "
              f"(range {min(g):.3f}-{max(g):.3f}, {len(g)} calls), eager "
              f"{statistics.median(e):.3f} ms (range {min(e):.3f}-{max(e):.3f}, "
              f"{len(e)} calls), median on the card ({card})")
    print(f"[serve] launches during the {cfg.name} warm graph reason: "
          f"{json.dumps(launches)} (flash per variant {json.dumps(flash_variants)}: "
          f"{per_prefill} mma per prefill + {flash_per_forward} per forward over "
          f"{forwards} forwards; paged {L} per forward; entropy per variant "
          f"{json.dumps(entropy_variants)})")
    profiled = profile_serve(torch, lambda: run(0, "profiled reason")[:2], warm_s,
                             profile_path, f"profile {key}", kernels)
    check(profiled == launches, f"{cfg.name}: the profiled reason's launches {profiled} "
          f"differ from the warm reason's {launches}")
    phases[f"{key}_pool_mib"] = eng.executor.graphs.pool_bytes / 2**20
    eng.executor.decode_chunk = decode_chunk
    return profiled


def encdec_phase(torch, np, F, kernels: dict, phases: dict, card: str,
                 profile_dir=None) -> dict:
    """Phase 6e: ``seamless-m4t-large-v2`` (arXiv:2308.11596) at full width
    and depth, zamba2 freed first.  The kernels at its shapes
    (``encdec_kernel_checks``); kernel path vs plain path on frames (float32
    cut to 2 + 2 layers, 1e-5; bf16 at the full 24 + 24: the logits within
    ``DENSE_BF16_TOL``, the EAT within ``DENSE_EAT_TOL`` of float32, flash
    120 ``mma`` over a prefill, a decode and a probe); then
    ``reason_cell``: two batches of 4 of phase 4's prompts (over its
    256,206 vocabulary), each with its own seeded frames (4 x 1024 x 1024).
    Returns {"launches": the profiled reason's counts, "kernels": the
    records}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels import _build
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ptxas = [line for line in ptxas_report(_build.BUILD_LOG.get("flash_attention", ""),
                                           "flash_mma_kernel")
             if ",64,64>" in line]
    recs = encdec_kernel_checks(torch, F, fa, pa, ep, ptxas)
    probe = make_probe(1, (6,))

    cfg = get_config("seamless-m4t-large-v2")
    prompts, lens = serve_workload(np, vocab=cfg.vocab)
    check(int(prompts.max()) < cfg.vocab, "prompt ids past the vocab")
    frames = [torch.randn((4, cfg.encoder_len, cfg.d_model), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(10 + i))
              for i in range(2)]
    f32_kernel_vs_plain(torch, dataclasses.replace(cfg, name=cfg.name + "-2+2L-f32",
                                                   n_layers=2, n_encoder_layers=2,
                                                   dtype="float32"),
                        prompts, probe, frames[0][:2])
    model, weights = dense_model(torch, cfg, phases, "encdec", card)
    print(f"[model] {cfg.name}: and {cfg.n_encoder_layers} encoder layers over "
          f"{cfg.encoder_len} stub frames of {cfg.d_model}; cross K/V per row "
          f"{2 * cfg.n_layers * cfg.encoder_len * cfg.d_model * 2 / 1e6:.1f} MB")
    L = cfg.n_layers
    dense_bf16_kernel_vs_plain(torch, model, prompts, probe, "mma", frames=frames[0][:2],
                               flash_calls=cfg.n_encoder_layers + 2 * L + 2 * L)
    # the reasons' peak, not the float32 twin's of the check above
    torch.cuda.reset_peak_memory_stats()
    profiled = reason_cell(
        torch, np, model, probe, prompts, lens, frames, kernels, phases, card,
        key="encdec",
        profile_path=Path(profile_dir) / "profile_encdec.txt" if profile_dir else None,
        start_kw="frames", per_prefill=cfg.n_encoder_layers + 2 * L,
        prefill_text=f"{cfg.n_encoder_layers} encoder, {L} self, {L} cross",
        flash_per_forward=L)
    del model, frames
    phase_end(torch, phases, "encdec", cfg.name, base, t_phase, card, weights=weights,
              over="its reasons")
    return {"launches": profiled, "kernels": recs}


# ----------------------------------------------------------------- phase 6f


def image_flash_case(torch, dtype, seed=0, B=4, S=512, P=256, Hq=28, Hkv=4, D=128):
    """A VLM's image prefill in ``flash_case``'s form: P patch slots at
    positions 0..P-1, then row b's 64 b pad slots at -1, then its text at
    P.. (the layout ``ReasoningEngine.start(image_embeds=)`` gives: valid
    slots before pad slots before valid slots)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = P + S
    q = torch.randn((B, T, Hq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(dtype)
    ar = torch.arange(T, device="cuda", dtype=torch.int32)[None]
    text = ar - P - torch.arange(B, device="cuda", dtype=torch.int32)[:, None] * 64
    pos = torch.where(ar < P, ar, torch.where(text >= 0, text + P, -1))
    pos = pos.to(torch.int32).contiguous()
    return dict(q=q, k=k, v=v, q_pos=pos, kv_pos=pos)


def vlm_kernel_checks(torch, F, fa, pa, ep) -> dict:
    """Phase 6f's kernel checks at ``qwen2-vl-7b``'s shapes, bf16, 28 q heads
    on 4 kv heads of 128 (g 7): flash at the image prefill (B 4, 256
    patches then 512 prompt slots, the patches before each row's pad
    slots; ``image_flash_case``) and at the text prefill (B 4, S 512,
    left-padded), both on the ``(128, 128)`` instance of the tensor-core
    kernel and timed in turns with SDPA; paged at m 1 and 2; the entropy
    probe over the untied 3584 x 152,064 head, with ``torch.matmul`` +
    ``logsumexp`` timed beside as a yardstick.  Returns {kernel: record},
    flash's text prefill under ``text_prefill``, paged's m 2 under ``m2``."""
    tag = "qwen2-vl-7b"
    bad = []
    flash = flash_shape_check(torch, F, fa, tag + " image prefill", 28, 4, 128, bad,
                              case=image_flash_case)
    flash["text_prefill"] = flash_shape_check(torch, F, fa, tag + " text prefill", 28, 4,
                                              128, bad)
    for rec in (flash, flash["text_prefill"]):
        if rec["variant"] != "mma":
            bad.append(f"{tag} flash routes to {rec['variant']}, not mma")
    flash["max_abs_err"] = max(flash["max_abs_err"], flash["text_prefill"]["max_abs_err"])
    paged = [paged_shape_check(torch, pa, tag, m, 28, 4, 128, bad) for m in (1, 2)]
    rec_paged = dict(paged[0], max_abs_err=max(r["max_abs_err"] for r in paged),
                     m2=paged[1])
    entropy = entropy_shape_check(torch, ep, tag, 3584, 152_064, 152_064, False, bad)
    c = entropy_case(torch, torch.bfloat16, 4, 3584, 152_064, 152_064, False)
    entropy["matmul_logsumexp_ms"] = graph_ms(torch, [
        lambda: torch.logsumexp(torch.matmul(c["h"], c["w"]).float(), dim=-1)])
    print(f"[kernels] {tag} entropy_probe yardstick: bf16 torch.matmul(h, w) + float32 "
          f"logsumexp (the logits' normaliser, no entropy) "
          f"{entropy['matmul_logsumexp_ms']:.4f} ms (graph replay), the kernel "
          f"{entropy['ms']:.4f} ms")
    del c
    torch.cuda.empty_cache()
    check(not bad, "qwen2-vl-7b kernel vs plain: " + "; ".join(bad))
    return {"flash_attention": flash, "paged_attention": rec_paged,
            "entropy_probe": entropy}


def vlm_phase(torch, np, F, kernels: dict, phases: dict, card: str,
              profile_dir=None) -> dict:
    """Phase 6f: ``qwen2-vl-7b`` (arXiv:2409.12191: the VLM's language
    backbone, 28 layers, d 3584, 28 q / 4 kv heads of 128 with qkv bias,
    M-RoPE sections (16, 24, 24), an untied 152,064 vocabulary; the vision
    tower a stub, as in the reference) at full width and depth, the
    encoder-decoder freed first.  The kernels at its shapes
    (``vlm_kernel_checks``); kernel path vs plain path on 256 patches in
    front of the prompt (float32 cut to 2 layers, 1e-5; bf16 at the full
    28: the logits within ``DENSE_BF16_TOL``, the EAT within
    ``DENSE_EAT_TOL`` of float32, flash 28 ``mma``); then ``serve_cell``:
    the paged self-EAT text serve of phase 4's traffic (prompts over its
    152,064 vocabulary; the reference serves a VLM's queue text only),
    flash 28 ``mma`` per prefill and none scalar, 28 paged calls per
    decode and probe forward, every entropy call mma, a profiled serve and
    a ring serve bitwise the paged one; and ``reason_cell``: two batches
    of 4 of phase 4's prompts, each with its own 256 seeded stub patches
    (4 x 256 x 3584), through ``start(image_embeds=)``, ``reason()`` and
    ``force_answer(4)`` on one engine's graphs.  Returns {"launches": the
    profiled serve's counts, "image_launches": the profiled reason's,
    "kernels": the records}."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    recs = vlm_kernel_checks(torch, F, fa, pa, ep)
    probe = make_probe(1, (6,))

    cfg = get_config("qwen2-vl-7b")
    P, L = cfg.n_image_patches, cfg.n_layers
    prompts, lens = serve_workload(np, vocab=cfg.vocab)
    check(int(prompts.max()) < cfg.vocab, "prompt ids past the vocab")
    images = [torch.randn((4, P, cfg.d_model), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(20 + i))
              for i in range(2)]
    f32_kernel_vs_plain(torch, dataclasses.replace(cfg, name=cfg.name + "-2L-f32",
                                                   n_layers=2, dtype="float32"),
                        prompts, probe, image=images[0][:2])
    model, weights = dense_model(torch, cfg, phases, "vlm", card)
    print(f"[model] {cfg.name}: M-RoPE sections {cfg.mrope_sections}, {P} stub image "
          f"patches of {cfg.d_model} per row; K/V "
          f"{2 * L * cfg.n_kv_heads * cfg.resolved_head_dim * 2 / 1024:.0f} KiB per token")
    dense_bf16_kernel_vs_plain(torch, model, prompts, probe, "mma", image=images[0][:2])
    # the serves' peak, not the float32 twin's of the check above
    torch.cuda.reset_peak_memory_stats()
    profiled = serve_cell(
        torch, np, model, probe, prompts, lens, kernels, phases, card, key="vlm",
        flash_want=lambda forwards, prefills: {"mma": L * prefills, "mla": 0, "wide": 0,
                                               "scalar": 0},
        flash_text=f"{L} mma per prefill",
        paged_want=lambda forwards, prefills: L * (forwards - prefills),
        profile_path=Path(profile_dir) / "profile_vlm.txt" if profile_dir else None)
    image = reason_cell(
        torch, np, model, probe, prompts, lens, images, kernels, phases, card,
        key="vlm_image",
        profile_path=Path(profile_dir) / "profile_vlm_image.txt" if profile_dir else None,
        start_kw="image_embeds", per_prefill=L,
        prefill_text=f"{L} self-attention over {P} patches, pads and the prompt",
        flash_per_forward=0, extra_slots=P)
    del model, images
    phases["vlm_pool_mib"] += phases["vlm_image_pool_mib"]
    phase_end(torch, phases, "vlm", cfg.name, base, t_phase, card, weights=weights,
              over="its serves and reasons")
    return {"launches": profiled, "image_launches": image, "kernels": recs}


# ------------------------------------------------------------------ phase 7

def stub_frames(torch, cfg, B: int, seed: int):
    """An encoder-decoder's seeded stub frames (B, T, d) at 0.1 N(0, 1) on
    the card, as the reference's smoke tests make them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return 0.1 * torch.randn((B, cfg.encoder_len, cfg.d_model), generator=g,
                             device="cuda")


def train_run(torch, cfg, card: str, *, steps=8, batch=8, seq=96,
              profile: bool = False, table_path: Path | None = None):
    """``steps`` AdamW steps of ``cfg`` from seeded weights on ChainTask
    batches (the launcher's ``--seq``: ``seq`` - 1 input tokens a row; an
    encoder-decoder's batch with ``stub_frames`` of seed 100 + step beside),
    remat on, lr 3e-4 with 2 warmup steps, each step timed by the host
    clock between synchronisations.  Checks every loss and gradient norm
    finite, every parameter finite after the run, and the last loss below
    the first; prints the ``[train]`` lines, and with ``profile`` the
    profiler's table of one more step (written to ``table_path`` if given).
    Returns the phase record."""
    from repro_torch.data.pipeline import device_put_batch, train_batches
    from repro_torch.data.synthetic import ChainTask
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                                 make_train_step)
    from repro_torch.utils.treeutil import param_bytes, param_count, tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    n = param_count(state.params)
    w = param_bytes(state.params)
    reckoned = {"weights": w, "gradients": w, "moments": 8 * n}
    step = make_train_step(cfg, TrainConfig(
        opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps), remat=True))
    times, metrics = [], []
    for i, b in zip(range(steps), train_batches(ChainTask(seq_len=seq), batch, seed=0)):
        b = device_put_batch(b, "cuda")
        if cfg.arch_type == "encdec":
            b["frames"] = stub_frames(torch, cfg, batch, 100 + i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() - base
    busy = None
    if profile:
        busy = profile_step(torch, lambda: step(state, b), table_path,
                            f"profile train {cfg.name}", card)
    loss = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
    check(all(math.isfinite(x) for x in loss + gnorm) and finite,
          f"{cfg.name} training: a loss, a grad norm or a parameter is not "
          f"finite: loss {loss}, grad norm {gnorm}")
    check(loss[-1] < loss[0], f"{cfg.name} training: the loss did not fall: {loss}")
    ms = statistics.median(times[1:]) * 1e3
    tokens = batch * (seq - 1)
    gb = lambda x: x / 1e9  # noqa: E731
    frames = (f" + {cfg.encoder_len} x {cfg.d_model} stub frames a row through "
              f"{cfg.n_encoder_layers} encoder layers" if cfg.arch_type == "encdec" else "")
    print(f"[train] {cfg.name} {cfg.dtype} {cfg.n_layers} layers d{cfg.d_model}, "
          f"{n / 1e9:.3f} B params: {steps} steps of batch {batch} x {seq - 1} "
          f"tokens{frames}, remat, lr 3e-4 warmup 2; loss {', '.join(f'{x:.4f}' for x in loss)}; "
          f"grad norm {', '.join(f'{x:.3f}' for x in gnorm)} ({card})")
    print(f"[train] {cfg.name}: {ms:.1f} ms per step (median of steps 2-{steps}, "
          f"host clock with synchronize; range {min(times[1:]) * 1e3:.3f}-"
          f"{max(times[1:]) * 1e3:.3f}; first step {times[0] * 1e3:.1f}), "
          f"{tokens / ms * 1e3:.0f} tokens/s ({card})")
    print(f"[train] {cfg.name}: peak memory {gb(peak):.2f} GB "
          f"(torch.cuda.max_memory_allocated over the run) against the reckoned "
          f"state {gb(sum(reckoned.values())):.2f} GB: {cfg.dtype} weights "
          f"{gb(w):.2f} GB, {cfg.dtype} gradients {gb(w):.2f} GB, float32 moments "
          f"{gb(8 * n):.2f} GB ({card})")
    del state, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n, "ms_per_step": ms, "ms_range": [min(times[1:]) * 1e3,
                                                         max(times[1:]) * 1e3],
            "tokens_per_s": tokens / ms * 1e3,
            "peak_gb": gb(peak), "reckoned_gb": gb(sum(reckoned.values())),
            "loss_first": loss[0], "loss_last": loss[-1], "profiled": busy}


def profile_step(torch, run, path: Path | None, tag: str, card: str):
    """One more train step under torch.profiler: the top rows of its table
    (kernels and operators by their own device time) printed under
    ``[tag]``, the table written to ``path`` (if given), and
    the device's busy share of the step's wall.  Returns (busy ms, wall ms)
    or None when the profiler read no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    table = events.table(sort_by="self_cuda_time_total", row_limit=30)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(table)
    print(f"[{tag}] " + f"\n[{tag}] ".join(table.splitlines()[:20]))
    if not busy:
        print(f"[{tag}] the profiler read no device event ({card})")
        return None
    print(f"[{tag}] device busy {busy:.1f} ms of the profiled step's {wall:.1f} ms "
          f"({busy / wall:.1%}) ({card})")
    return busy, wall


def train_phase(torch, np, card: str, kernels: dict, phases: dict,
                profile_dir: str | None = None) -> None:
    """Phase 7, the training path: (a) the training forward (plain attention,
    as the reference's trainer) against the serving prefill (flash) on
    ``qwen3-1.7b``, float32 cut to 4 layers and bf16 at full depth; (b)
    ``qwen3-1.7b`` trained at full width and depth, one more step profiled;
    (c) ``mamba2-2.7b`` trained at full width and depth; (d) ``tiny-reasoner`` trained from scratch by
    ``examples/torch_train_reasoner.py``'s recipe, saved, reloaded bitwise
    and served on the kernels."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.data.synthetic import ChainTask, Tokens
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.model import Model, init_params, train_logits
    from repro_torch.serving.cache import CacheConfig, alloc_cache
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import SlotScheduler
    from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.utils.treeutil import tree_flatten_with_paths

    t_phase = time.perf_counter()
    qcfg = get_config("qwen3-1.7b")

    # (a) the training forward against the serving prefill, same weights, a
    # 96-token batch: max |difference| over max |logits|; float32 at reduced
    # depth, bf16 at full depth (zamba2-2.7b within its serve phase's bar)
    scfg, zcfg = get_config("seamless-m4t-large-v2"), get_config("zamba2-2.7b")
    for cfg, bar in ((dataclasses.replace(qcfg, name=qcfg.name + "-4L-f32",
                                          n_layers=4, dtype="float32"), 1e-5),
                     (qcfg, 3e-2),
                     (dataclasses.replace(scfg, name=scfg.name + "-2+2L-f32", n_layers=2,
                                          n_encoder_layers=2, dtype="float32"), 1e-5),
                     (scfg, 3e-2),
                     (dataclasses.replace(zcfg, name=zcfg.name + "-12L-f32", n_layers=12,
                                          dtype="float32"), 1e-5),
                     (zcfg, HYBRID_BF16_TOL)):
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                             device="cuda")
        model = Model(cfg, params)
        B, S = 2, 96
        toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(4))
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S).contiguous()
        frames = stub_frames(torch, cfg, B, 5) if cfg.arch_type == "encdec" else None
        n_flash = sum(kind != "ssm" for kind in cfg.block_kinds())
        if frames is not None:               # the encoder's, and each cross-attention
            n_flash += cfg.n_encoder_layers + cfg.n_layers
        before = dict(fa.flash_attention_cuda.variant_launches)
        with torch.no_grad():
            ref = train_logits(params, cfg, toks, pos, pos, remat=False,
                               frames=frames)[0].float()
            cache = alloc_cache(cfg, B, S, device="cuda")
            out = model.logits(model.prefill(toks, pos, pos, cache, frames=frames)).float()
        flash = {k: v - before[k] for k, v in fa.flash_attention_cuda.variant_launches.items()}
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        check(bool(torch.isfinite(out).all() and torch.isfinite(ref).all())
              and err <= bar and sum(flash.values()) == n_flash,
              f"{cfg.name}: training forward vs serving prefill {err} (bar {bar}), "
              f"flash launches {flash} (expected {n_flash})")
        plain = "plain attention" + (" and the plain scan" if "ssm" in cfg.block_kinds()
                                     else "")
        print(f"[train] {cfg.name}: training forward ({plain}) vs serving "
              f"prefill + logits (flash kernel, {json.dumps(flash)} launches), "
              f"B {B} x {S} tokens{' on stub frames' if frames is not None else ''}: "
              f"max |diff| / max |logits| {err:.3e} (bar {bar:g}; "
              f"max |logits| {ref.abs().max().item():.3f}) ({card})")
        phases[f"train_vs_prefill_{cfg.name}"] = err
        del params, model, ref, out, cache, frames
        gc.collect()
        torch.cuda.empty_cache()

    # (b) qwen3-1.7b at full width and depth
    phases["train_qwen"] = train_run(
        torch, qcfg, card, profile=True,
        table_path=Path(profile_dir) / "profile_train.txt" if profile_dir else None)

    # (c) mamba2-2.7b at full width and depth (8 steps take ~15 s: no cut)
    phases["train_mamba"] = train_run(torch, get_config("mamba2-2.7b"), card)

    # (c2) the encoder-decoder (on stub frames) and the hybrid at full width
    # and depth
    phases["train_seamless"] = train_run(torch, scfg, card)
    phases["train_zamba2"] = train_run(torch, zcfg, card)

    # (d) tiny-reasoner by the example's recipe, saved, reloaded, served
    sys.path.insert(0, str(ROOT / "examples"))
    from torch_train_reasoner import train

    steps = 1200
    t0 = time.perf_counter()
    cfg, params, hist = train(steps, "cuda", log=lambda line: print(
        f"[train] tiny-reasoner {line.strip()} ({card})"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    (_, l0, a0), (_, l1, a1) = hist[0], hist[-1]
    check(l1 < 0.5 * l0, f"tiny-reasoner: last loss {l1} not below half the first {l0}")
    print(f"[train] tiny-reasoner: {steps} steps of batch 64 in {train_s:.1f} s "
          f"({train_s / steps * 1e3:.1f} ms per step, host clock), loss {l0:.4f} -> "
          f"{l1:.4f}, accuracy {a0:.3f} -> {a1:.3f} ({card})")
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "tiny_reasoner_torch.ckpt")
        save_checkpoint(path, params, cfg)
        size = Path(path).stat().st_size
        back = load_checkpoint(path, cfg, device="cuda")
    same = all(a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_flatten_with_paths(back), tree_flatten_with_paths(params)))
    check(same, "tiny-reasoner: the reloaded checkpoint differs from the trained weights")
    print(f"[train] tiny-reasoner checkpoint: {size} bytes, reloaded onto the card "
          f"bitwise ({card})")

    model = Model(cfg, back)
    batch = ChainTask().serve_batch(np.random.default_rng(0), 32)
    slots, budget = 8, 110
    ecfg = EngineConfig(
        max_reasoning_tokens=budget, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, sampler=SamplerConfig(greedy=True),
        capacity=SlotScheduler.required_capacity(batch["prompts"].shape[1], 32,
                                                 slots, budget),
        cache=CacheConfig(kind="paged", page_size=16, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e-3),
                           probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)),
                           newline_id=Tokens.NEWLINE)
    eng = ReasoningEngine(model, ecfg, mon)
    served = {}
    for what, use_monitor in (("EAT delta 1e-3 alpha 0.2", True),
                              ("token budget alone", False)):
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = eng.serve(batch["prompts"], batch["prompt_len"], None,
                        batch_size=slots, answer_len=4, use_monitor=use_monitor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        check(len(res) == 32 and all(r["status"] in ("exited", "exhausted")
                                     for r in res),
              f"tiny-reasoner {what}: not every request finished")
        ans = np.array([ChainTask.extract_answer(r["answer_tokens"][None])[0]
                        for r in res])
        acc = float((ans == batch["answers"]).mean())
        n_tok = [r["n_reasoning"] for r in res]
        exits = {k: [r["exit_reason"] for r in res].count(k)
                 for k in ("eat", "end_think", "budget")}
        served[what] = {"accuracy": acc, "reasoning_tokens": sum(n_tok),
                        "wall_s": wall, "launches": launches}
        print(f"[train] tiny-reasoner served ({what}; 32 ChainTask prompts, {slots} "
              f"slots, paged, greedy, attn_impl auto): forced-answer accuracy "
              f"{acc:.3f}, reasoning tokens {sum(n_tok)} (per request "
              f"{min(n_tok)}-{max(n_tok)}), exits {json.dumps(exits)}, wall "
              f"{wall:.3f} s (first serve of its graphs: captures included); "
              f"launches {json.dumps(launches)} ({card})")
    eat = served["EAT delta 1e-3 alpha 0.2"]["launches"]
    check(all(n > 0 for n in eat.values()),
          f"tiny-reasoner EAT serve: a kernel was not launched: {eat}")
    phases["train_reasoner"] = {"train_s": train_s, "loss": [l0, l1],
                                "accuracy": [a0, a1], "served": served}
    del eng, model, params, back
    gc.collect()
    torch.cuda.empty_cache()
    phases["train_phase_s"] = time.perf_counter() - t_phase


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write the torch.profiler tables of the profiled paged "
                         "8B serve (DIR/profile.txt) and mamba2 serve "
                         "(DIR/profile_mamba2.txt) and qwen3-1.7b train step "
                         "(DIR/profile_train.txt), and profile one more "
                         "qwen3-1.7b proxy serve (DIR/profile_proxy.txt)")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # numbers are compared below
    torch.backends.cudnn.allow_tf32 = False
    phases = {}
    walls, t_last = {}, [T_START]

    def lap(name: str) -> None:
        """The wall of the phase that ends here (host clock), printed at
        once (a run that fails later still shows where its time went) and
        kept for the closing ``[phases]`` lines."""
        now = time.perf_counter()
        walls[name] = now - t_last[0]
        t_last[0] = now
        print(f"[phases] phase {name}: {walls[name]:.1f} s wall, {now - T_START:.1f} s "
              f"since the start")

    # ---- 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    missing = [name for name in ("begin_capture_to_if_node",
                                 "end_capture_to_conditional_node",
                                 "register_generator_state")
               if not hasattr(torch.cuda.CUDAGraph, name)]
    print("[card] CUDAGraph conditional nodes: "
          + (f"missing {', '.join(missing)}" if missing else "present")
          + "; decode and shadow chunks run as CUDA graphs of the fixed-length "
          "masked chunk (a probe every step, no if-node)")
    lap("1")

    # ---- 2. build
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    phases["build_s"] = time.perf_counter() - t0
    print(f"[build] {phases['build_s']:.2f} s; per kernel "
          + json.dumps({k: round(v, 2) for k, v in built.items()}))
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    from repro_torch.kernels.entropy_probe import ops as ep
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa

    lap("2")

    # ---- 3. kernels vs plain at main-path shapes
    t0 = time.perf_counter()
    flash_ptxas = [line for kernel in ("flash_mma_kernel", "flash_mla_kernel",
                                       "flash_mla_merge_kernel", "flash_wide_kernel",
                                       "flash_kernel")
                   for line in ptxas_report(_build.BUILD_LOG.get("flash_attention", ""),
                                            kernel)]
    paged_ptxas = [line for kernel in ("paged_max_kernel", "paged_fold_kernel",
                                       "paged_merge_kernel")
                   for line in ptxas_report(_build.BUILD_LOG.get("paged_attention", ""),
                                            kernel)]
    rec = kernel_checks(torch, F, fa, pa, flash_ptxas, paged_ptxas)
    entropy_ptxas = [line for kernel in ("entropy_mma_kernel", "tile_stats_kernel",
                                         "merge_kernel")
                     for line in ptxas_report(_build.BUILD_LOG.get("entropy_probe", ""),
                                              kernel)]
    rec["entropy_probe"] = entropy_check(torch, ep, entropy_ptxas)
    from repro_torch.kernels.decode_attention import ops as da

    decode_ptxas = [line for kernel in ("decode_mma_kernel", "decode_split_kernel",
                                        "decode_merge_kernel")
                    for line in ptxas_report(_build.BUILD_LOG.get("decode_attention", ""),
                                             kernel)]
    rec["decode_attention"], decode_launches = decode_check(torch, F, da, decode_ptxas)
    # the scan, at mamba2-2.7b's prefill shapes; its launches come from the
    # mamba2 serve of phase 5.  Here, before any serve is profiled: after a
    # long profiled serve, torch.profiler sessions as short as one call
    # have read no device events.
    from repro_torch.kernels.ssd_scan import ops as ss

    ssd_ptxas = [line for kernel in ("ssd_state_kernel", "ssd_pass_kernel",
                                     "ssd_out_kernel", "ssd_scan_kernel")
                 for line in ptxas_report(_build.BUILD_LOG.get("ssd_scan", ""), kernel)]
    rec["ssd_scan"] = ssd_check(torch, ss, ssd_ptxas)
    # zamba2-2.7b's scan (d_state 64) here too, for phase 6d's record
    zamba_scan = ssd_check(torch, ss, [], N=64, tag="zamba2-2.7b")
    phases["kernel_checks_s"] = time.perf_counter() - t0

    lap("3")

    # ---- 4. eat-paper-8b, full width and depth, random weights on the card
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig, alloc_cache
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.scheduler import SlotScheduler

    cfg = get_config("eat-paper-8b")
    probe = make_probe(1, (6,))
    prompts, lens = serve_workload(np)

    # float32 at full width, depth cut to 4 layers: the kernels must agree
    # with the plain path to 1e-5 (relative L2 of the logits, nats of EAT;
    # read on an H100: 1.5e-6 and 9.5e-7)
    cfg32 = dataclasses.replace(cfg, name=cfg.name + "-4L-f32", n_layers=4,
                                dtype="float32")
    model32 = Model(cfg32, init_params(cfg32, torch.Generator(device="cuda").manual_seed(1),
                                       device="cuda"))
    outs = kernel_vs_plain(torch, model32, prompts, probe)
    for i, what in enumerate(("prefill logits", "decode logits")):
        rel = rel_l2(outs["cuda"][i], outs["plain"][i])
        check(bool(torch.isfinite(outs["cuda"][i]).all()) and rel < 1e-5,
              f"{cfg32.name} {what}: kernel vs plain relative L2 {rel}")
        print(f"[model] {cfg32.name} {what}: kernel vs plain relative L2 {rel:.3e} (tol 1e-5)")
    d_eat = (outs["cuda"][2] - outs["plain"][2]).abs().max().item()
    check(d_eat < 1e-5, f"{cfg32.name} EAT: kernel vs plain differ by {d_eat}")
    print(f"[model] {cfg32.name} EAT kernel vs plain max diff {d_eat:.3e} (tol 1e-5)")
    del model32, outs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Model(cfg, init_params(cfg, gen, device="cuda"))
    torch.cuda.synchronize()
    phases["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] {cfg.name}: {cfg.n_layers} layers d{cfg.d_model} "
          f"Hq{cfg.n_heads}/Hkv{cfg.n_kv_heads} hd{cfg.resolved_head_dim} "
          f"ff{cfg.d_ff} Vp{cfg.padded_vocab} {cfg.dtype}: {n_params / 1e9:.3f} B "
          f"params, init {phases['init_s']:.1f} s")
    # bf16 at full depth: finite logits, and the EAT of the two paths within
    # 1e-3 nats (read on an H100: 1.1e-4; bf16 roundings at different points
    # compound over 36 layers, so the logits' relative L2 is printed, not
    # held to a bar)
    outs = kernel_vs_plain(torch, model, prompts, probe)
    for i, what in enumerate(("prefill logits", "decode logits")):
        check(bool(torch.isfinite(outs["cuda"][i]).all()), f"8B {what} not finite")
        print(f"[model] {what}: kernel vs plain relative L2 "
              f"{rel_l2(outs['cuda'][i], outs['plain'][i]):.3e}")
    eat_k, eat_p = outs["cuda"][2], outs["plain"][2]
    d_eat = (eat_k - eat_p).abs().max().item()
    check(bool(torch.isfinite(eat_k).all()) and d_eat < 1e-3,
          f"8B EAT: kernel {eat_k.tolist()} vs plain {eat_p.tolist()}")
    print(f"[model] EAT kernel {[round(x, 4) for x in eat_k.tolist()]} plain "
          f"{[round(x, 4) for x in eat_p.tolist()]} max diff {d_eat:.3e} (tol 1e-3)")
    del outs

    # the serve: 8 requests, 4 slots, budget 64, chunk 16, page 16, greedy,
    # an EAT probe every 8 tokens, exit at the 2nd evaluation (delta 1e9:
    # random weights never settle, the newline schedule would never fire)
    n_req, batch, budget, chunk = len(lens), 4, 64, 16
    S = prompts.shape[1]

    # every engine gets the overlapped loop's headroom (one chunk of
    # capacity, one row of pages), so that phase 4c's overlapped serves
    # replay the graphs of the sync serves (the pool size is in their key)
    capacity = SlotScheduler.required_capacity(S, n_req, batch, budget) + chunk
    n_blocks = -(-capacity // 16)

    def engine(kind: str, proxy=None):
        ecfg = EngineConfig(
            max_reasoning_tokens=budget, capacity=capacity,
            chunk_len=chunk, sampler=SamplerConfig(greedy=True),
            cache=CacheConfig(kind=kind, page_size=16, attn_impl="auto",
                              num_pages=(batch + 1) * n_blocks + 1))
        mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e9),
                               probe=probe, schedule="every_n", every_n=8,
                               min_evals=2)
        return ReasoningEngine(model, ecfg, mon, proxy=proxy)

    from repro_torch.serving import device_loop

    kernels = {"flash_attention": fa.flash_attention_cuda,
               "paged_attention": pa.paged_attention_cuda,
               "entropy_probe": ep.entropy_probe_cuda}

    def serve(eng, watch, what: str, eager: bool = False, overlap: bool = False,
              no_sync: bool = False):
        """One serve of ``eng`` (its chunks as graph replays, or with
        ``eager`` the eager loop; the overlapped loop with ``overlap``, the
        whole serve under sync debug mode "error" with ``no_sync``):
        (results, wall s, the watch's counts)."""
        watch.begin()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if no_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = eng.serve(prompts, lens, None, batch_size=batch, answer_len=4,
                            record_trace=True, eager=eager, overlap=overlap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return res, wall, watch.end(what)

    def graph_serves(eng, watch, what: str):
        """A cold graph serve (its captures counted and timed), a warm one
        with every launch counted (no capture: checked), and an eager serve
        of the same engine, which must give the warm serve's results
        bitwise.  Returns (warm results, cold, warm, eager (wall, counts)),
        the warm serve's launches per kernel and per variant."""
        cold = serve(eng, watch, f"{what} cold graph serve")
        check(all(t["captures"] > 0 for t in cold[2]["tiers"].values()),
              f"{what}: the cold serve captured no chunk graph")
        print(graph_line(f"{what} cold serve ({cold[1]:.3f} s)", cold[2]))
        reset_counts(kernels)
        res, w_wall, warm = serve(eng, watch, f"{what} warm graph serve")
        counted = ({name: fn.launches for name, fn in kernels.items()},
                   {name: dict(fn.variant_launches) for name, fn in kernels.items()
                    if hasattr(fn, "variant_launches")})
        check(all(t["captures"] == 0 and t["replays"] == t["chunks"] + t["rollouts"]
                  for t in warm["tiers"].values()) and warm["device_if"] == 0,
              f"{what}: the warm serve captured, ran a chunk or a rollout eagerly, "
              f"or read device_if: {warm['line']}")
        check_same(res, cold[0], np, f"{what}: cold and warm graph "
                   f"serves differ")
        e_res, e_wall, eager = serve(eng, watch, f"{what} eager serve", eager=True)
        check_same(res, e_res, np,
                   f"{what}: the graph serve differs from the eager serve")
        print(f"[serve] {what}: graph serve == eager serve bitwise (tokens, exits, "
              f"slots, answers, EAT traces); walls: cold graph {cold[1]:.3f} s, "
              f"warm graph {w_wall:.3f} s, eager {e_wall:.3f} s")
        print(f"[serve] {what} host reads, warm graph serve: {warm['line']}")
        print(f"[serve] {what} host reads, eager serve: {eager['line']}")
        return res, ((cold[1], cold[2]), (w_wall, warm), (e_wall, eager)), counted

    def chunk_line(what: str, runs) -> None:
        """The chunk's and the harvest rollout's own time on the card (CUDA
        events around each call): graph replay against the eager loop, per
        tier."""
        for tier in runs[1][1]["tiers"]:
            for kind in ("chunk", "rollout"):
                g = runs[1][1]["tiers"][tier][f"{kind}_ms"]
                e = runs[2][1]["tiers"][tier][f"{kind}_ms"]
                if g:
                    print(f"[{kind}] {what} {tier}: replay {statistics.median(g):.3f} ms "
                          f"(range {min(g):.3f}-{max(g):.3f}, {len(g)} calls), eager "
                          f"{statistics.median(e):.3f} ms (range {min(e):.3f}-"
                          f"{max(e):.3f}, {len(e)} calls), median on the card")

    eng_paged = engine("paged")
    watch_paged = Watch(torch, eng_paged, device_loop, kernels)
    paged_res, paged_runs, (launches, variants) = graph_serves(
        eng_paged, watch_paged, "paged")
    flash_variants, entropy_variants = (variants["flash_attention"],
                                        variants["entropy_probe"])
    phases["paged_cold_serve_s"] = paged_runs[0][0]
    phases["paged_serve_s"] = paged_runs[1][0]
    chunk_line("paged", paged_runs)
    # warm graph and eager walls of the same engine in turns, 3 each
    turns = {"graph": [], "eager": []}
    for _ in range(3):
        for mode in ("eager", "graph"):
            r, wall, _ = serve(eng_paged, watch_paged, f"paged {mode} serve in turns",
                               eager=mode == "eager")
            check_same(r, paged_res, np, f"paged {mode} serve in turns "
                       f"differs from the warm graph serve")
            turns[mode].append(wall)
    print(f"[serve] paged walls in turns (eager, graph) x 3: warm graph "
          f"{statistics.median(turns['graph']):.3f} s (range "
          f"{min(turns['graph']):.3f}-{max(turns['graph']):.3f}; "
          f"{', '.join(f'{w:.3f}' for w in turns['graph'])}), eager "
          f"{statistics.median(turns['eager']):.3f} s (range "
          f"{min(turns['eager']):.3f}-{max(turns['eager']):.3f}; "
          f"{', '.join(f'{w:.3f}' for w in turns['eager'])})")
    phases["paged_graph_turns_s"] = statistics.median(turns["graph"])
    phases["paged_eager_turns_s"] = statistics.median(turns["eager"])
    # the launches of the result line: one more warm graph serve, under the
    # profiler, whose kernel counts must equal the wrappers'
    profiled = profile_serve(
        torch, lambda: serve(eng_paged, watch_paged, "profiled paged")[:2],
        phases["paged_serve_s"],
        Path(args.profile) / "profile.txt" if args.profile else None,
        "profile", kernels)
    check(profiled == launches, f"paged: the profiled serve's launches {profiled} "
          f"differ from the warm serve's {launches}")
    launches = profiled

    eng_ring = engine("ring")
    ring_res, ring_runs, _ = graph_serves(eng_ring, Watch(torch, eng_ring,
                                                          device_loop, kernels),
                                          "ring")
    phases["ring_serve_s"] = ring_runs[1][0]
    chunk_line("ring", ring_runs)

    check(len(paged_res) == n_req and all(r["status"] in ("exited", "exhausted")
                                          for r in paged_res),
          "not every request finished")
    exits = [r["exit_reason"] for r in paged_res]
    check("eat" in exits, f"no request exited by EAT: {exits}")
    slots = [r["slot"] for r in paged_res]
    check(len(set(slots)) < len(slots), f"no slot served two requests: {slots}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched during the serve")
    prefills = 1 + n_req - batch                    # the cohort, then admissions

    def check_flash_variants(what, counts, per_prefill):
        """Every flash launch of a bf16 serve is the tensor-core kernel:
        one per layer per prefill of each model, none scalar."""
        want = {"mma": per_prefill * prefills, "mla": 0, "wide": 0, "scalar": 0}
        check(counts == want, f"{what}: flash launches per variant {counts}, "
              f"expected {want} ({per_prefill} per prefill x {prefills} prefills)")

    check_flash_variants("paged serve", flash_variants, cfg.n_layers)
    check_entropy_mma("paged serve", entropy_variants, launches["entropy_probe"])
    check_same(paged_res, ring_res, np, "paged and ring streams differ", slots=False)
    n_tok = sum(r["n_reasoning"] for r in paged_res)
    print(f"[serve] paged: {n_req} requests through {batch} slots {slots}, exits {exits}, "
          f"reasoning tokens {[r['n_reasoning'] for r in paged_res]}, "
          f"{phases['paged_serve_s']:.3f} s warm graph serve, "
          f"{n_tok / phases['paged_serve_s']:.1f} reasoning tokens/s (cold serve "
          f"{phases['paged_cold_serve_s']:.3f} s); ring {phases['ring_serve_s']:.3f} s; "
          f"paged == ring bitwise (tokens, answers, EAT traces)")
    print(f"[serve] launches during the paged warm graph serve: {json.dumps(launches)} "
          f"(paged_attention: op calls, three kernel launches each; chunk graphs: "
          f"their captured calls once per replay); flash per variant "
          f"{json.dumps(flash_variants)} ({cfg.n_layers} mma per prefill x "
          f"{prefills}); entropy per variant {json.dumps(entropy_variants)}")

    lap("4")

    # ---- 4b. the same workload served black-box: the generator decodes
    # unmonitored and a proxy model's EAT supplies the exits
    from repro_torch.serving.proxy import ProxyConfig

    def check_proxy(what, st, proxy_layers):
        """Per tier: the generator never probes; flash per prefill of each
        model, all on the tensor cores; every proxy entropy call too."""
        tiers = st["tiers"]
        gen, prx = tiers["executor"], tiers["proxy_executor"]
        check(gen["probe_calls"] == 0 == gen["launches"]["entropy_probe"],
              f"{what}: the generator probed: {tiers}")
        check(gen["launches"]["flash_attention"] == cfg.n_layers * prefills
              and prx["launches"]["flash_attention"] == proxy_layers * prefills,
              f"{what}: flash launches per tier {gen['launches']} {prx['launches']}")
        for name in kernels:
            check(prx["launches"][name] > 0, f"{what}: proxy {name} not launched")
        return {"generator": gen["launches"], "proxy": prx["launches"],
                "generator_probe_calls": gen["probe_calls"]}

    def proxy_phase(name, proxy_model, proxy_layers):
        eng = engine("paged", proxy=ProxyConfig(model=proxy_model))
        watch = Watch(torch, eng, device_loop, kernels)
        res, runs, (_, variants) = graph_serves(eng, watch, f"proxy {name}")
        chunk_line(f"proxy {name}", runs)
        tiers = check_proxy(f"proxy {name}", runs[1][1], proxy_layers)
        check_flash_variants(f"proxy {name}", variants["flash_attention"],
                             cfg.n_layers + proxy_layers)
        check_entropy_mma(f"proxy {name}", variants["entropy_probe"],
                          tiers["proxy"]["entropy_probe"])
        wall = runs[1][0]
        n_tok = sum(r["n_reasoning"] for r in res)
        ex = [r["exit_reason"] for r in res]
        print(f"[serve] proxy {name} monitoring {cfg.name}, paged: {n_req} requests "
              f"through {batch} slots {[r['slot'] for r in res]}, exits {ex} "
              f"({ex.count('eat')} by EAT), reasoning tokens "
              f"{[r['n_reasoning'] for r in res]}, {wall:.3f} s warm graph serve, "
              f"{n_tok / wall:.1f} reasoning tokens/s (cold {runs[0][0]:.3f} s, "
              f"eager {runs[2][0]:.3f} s); generator probe calls "
              f"{tiers['generator_probe_calls']}; launches per tier {json.dumps(tiers)}")
        return eng, watch, res, runs

    # (i) the 8B model monitoring itself: self-EAT's serve, bitwise
    eng_self, watch_self, res, runs = proxy_phase(f"{cfg.name} (same weights)",
                                                  model, cfg.n_layers)
    phases["proxy_self_serve_s"] = runs[1][0]
    check_same(paged_res, res, np,
               "same-params proxy serve differs from self-EAT")
    print("[serve] same-params proxy == self-EAT paged serve bitwise (tokens, exits, "
          "slots, answers, EAT traces)")
    # the watch holds the engine's executors, and through them the model:
    # phase 6b needs the 8B model's memory back once phase 6 drops it
    del eng_self, watch_self

    # (ii) qwen3-1.7b at full width and depth (seeded random weights, bf16,
    # tied 2048 x 151,936 table) monitoring the 8B generator
    qcfg = get_config("qwen3-1.7b")
    check(qcfg.vocab == cfg.vocab, "the proxy must share the generator's vocabulary")
    qmodel = Model(qcfg, init_params(qcfg, torch.Generator(device="cuda").manual_seed(2),
                                     device="cuda"))
    eng_q, watch_q, res, runs = proxy_phase(qcfg.name, qmodel, qcfg.n_layers)
    phases["proxy_qwen_serve_s"] = runs[1][0]
    ex = [r["exit_reason"] for r in res]
    check(len(res) == n_req and all(r["status"] in ("exited", "exhausted") for r in res),
          "qwen3-1.7b proxy: not every request finished")
    check("eat" in ex, f"qwen3-1.7b proxy: no EAT exit: {ex}")
    slots = [r["slot"] for r in res]
    check(len(set(slots)) < len(slots), f"qwen3-1.7b proxy: no slot reuse: {slots}")
    pool = sum(ex_.graphs.pool_bytes for e in (eng_paged, eng_ring, eng_q)
               for ex_ in (e.executor, e.proxy_executor) if ex_ is not None)
    print(f"[graphs] 8B phase: graph pool {pool / 2**20:.1f} MiB added by the captures "
          f"of the paged, ring and qwen3-1.7b proxy engines; "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak allocated")

    lap("4b")

    # ---- 4c. the overlapped serve loop (serving/pipeline.py) on the paged
    # self-EAT engine and the qwen3-1.7b proxy engine: cold, then warm
    # (== the warm sync serve bitwise, 0 captures, the whole serve under
    # sync debug mode "error"), walls in turns with the sync loop, a
    # profiled overlapped serve
    def overlap_phase(eng, watch, what, sync_res, sync_gen):
        cold = serve(eng, watch, f"{what} cold overlapped serve", overlap=True)
        print(graph_line(f"{what} cold overlapped serve ({cold[1]:.3f} s)", cold[2]))
        check_same(cold[0], sync_res, np,
                   f"{what}: the cold overlapped serve differs from the sync serve")
        res, wall, warm = serve(eng, watch, f"{what} warm overlapped serve",
                                overlap=True, no_sync=True)
        st = dict(eng.overlap_stats)
        check_same(res, sync_res, np,
                   f"{what}: the warm overlapped serve differs from the warm sync serve")
        check(all(t["captures"] == 0 and t["replays"] == t["chunks"] + t["rollouts"]
                  for t in warm["tiers"].values()) and warm["device_if"] == 0,
              f"{what}: the warm overlapped serve captured, ran a chunk or a "
              f"rollout eagerly, or read device_if: {warm['line']}")
        gen = warm["tiers"]["executor"]
        check(st["chunks"] == gen["chunks"],
              f"{what}: overlap stats {st} against {gen['chunks']} chunks")
        print(f"[overlap] {what}: warm overlapped serve == warm sync serve bitwise "
              f"(tokens, exits, slots, answers, EAT traces), 0 captures, the whole "
              f"serve under sync debug mode \"error\" ({wall:.3f} s; cold "
              f"{cold[1]:.3f} s); {st['chunks']} chunk replays, {st['idle_chunks']} "
              f"idle (steps == 0), {st['shadows_skipped']} shadows skipped, "
              f"{st['pages_deferred']} pages deferred by the ledger; sync serve: "
              f"{sync_gen['chunks']} chunk replays")
        print(f"[overlap] {what} host reads, warm overlapped serve: {warm['line']}")
        turns = {"sync": [], "overlap": []}
        for _ in range(3):
            for mode in ("sync", "overlap"):
                r, w, _ = serve(eng, watch, f"{what} {mode} serve in turns",
                                overlap=mode == "overlap")
                check_same(r, sync_res, np, f"{what} {mode} serve in "
                           f"turns differs from the warm sync serve")
                turns[mode].append(w)
        med = {m: statistics.median(v) for m, v in turns.items()}
        print(f"[overlap] {what} walls in turns (sync, overlapped) x 3 on {card}: "
              + "; ".join(f"{m} {med[m]:.3f} s (range {min(v):.3f}-{max(v):.3f}; "
                          f"{', '.join(f'{w:.3f}' for w in v)})"
                          for m, v in turns.items()))
        profiled = profile_serve(
            torch, lambda: serve(eng, watch, f"profiled overlapped {what}",
                                 overlap=True)[:2],
            wall, Path(args.profile) / f"profile_overlap_{what.split()[0]}.txt"
            if args.profile else None, f"profile overlap {what}", kernels)
        check(all(n > 0 for n in profiled.values()),
              f"{what}: a kernel was not launched in the overlapped serve: {profiled}")
        return {"warm_s": wall, "cold_s": cold[1], "turns_s": med, **st}

    phases["overlap_paged"] = overlap_phase(
        eng_paged, watch_paged, "paged", paged_res,
        paged_runs[1][1]["tiers"]["executor"])
    phases["overlap_qwen"] = overlap_phase(
        eng_q, watch_q, f"{qcfg.name} proxy", res, runs[1][1]["tiers"]["executor"])

    if args.profile:
        profile_serve(torch, lambda: serve(eng_q, watch_q, "profiled proxy")[:2],
                      phases["proxy_qwen_serve_s"],
                      Path(args.profile) / "profile_proxy.txt", "profile proxy",
                      kernels)
    del qmodel, eng_q, watch_q, eng_paged, watch_paged, eng_ring

    lap("4c")

    # ---- 5. mamba2-2.7b, the 8B engines freed first (the model stays)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels["ssd_scan"] = ss.ssd_scan_cuda
    m_launches = mamba_phase(torch, np, kernels, phases, args.profile)
    launches["ssd_scan"] = m_launches["ssd_scan"]
    phases["mamba_s"] = time.perf_counter() - t0

    lap("5")

    # ---- 5b. deepseek-moe-16b, full width and depth (the 8B model stays
    # for phase 6; its engines and mamba2's are freed)
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(torch, np, F, {name: kernels[name] for name in
                                   ("flash_attention", "paged_attention",
                                    "entropy_probe")}, phases, card,
                    profile_dir=args.profile)

    lap("5b")

    # ---- 6. the evaluation path on eat-paper-8b
    trace_phase(torch, np, model, probe, prompts, lens, kernels, phases)
    lap("6")

    # ---- 6g. the fused decode-and-probe step on eat-paper-8b, still held
    fused = fused_phase(torch, np, model, {name: kernels[name] for name in
                                           ("flash_attention", "paged_attention",
                                            "entropy_probe")}, phases, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    lap("6g")

    # ---- 6b. deepseek-v2-236b (MLA) at full width, 8 of 60 layers, the 8B
    # model freed first
    mla = mla_phase(torch, np, F, {name: kernels[name] for name in
                                   ("flash_attention", "paged_attention",
                                    "entropy_probe")}, phases, card,
                    profile_dir=args.profile)

    lap("6b")

    # ---- 6c. gemma-7b at full width and depth, the MLA model freed first;
    # then gemma-2b and codeqwen1.5-7b without a serve
    gemma = gemma_phase(torch, np, F, {name: kernels[name] for name in
                                       ("flash_attention", "paged_attention",
                                        "entropy_probe")}, phases, card,
                        profile_dir=args.profile)
    lap("6c")

    # ---- 6d. zamba2-2.7b (hybrid) at full width and depth, the gemma
    # models freed first
    gc.collect()
    torch.cuda.empty_cache()
    zamba = zamba_phase(torch, np, F, {name: kernels[name] for name in
                                       ("flash_attention", "paged_attention",
                                        "entropy_probe", "ssd_scan")}, phases, card,
                        zamba_scan, profile_dir=args.profile)
    lap("6d")

    # ---- 6e. seamless-m4t-large-v2 (encoder-decoder) at full width and
    # depth, zamba2 freed first
    gc.collect()
    torch.cuda.empty_cache()
    encdec = encdec_phase(torch, np, F, {name: kernels[name] for name in
                                         ("flash_attention", "paged_attention",
                                          "entropy_probe")}, phases, card,
                          profile_dir=args.profile)
    lap("6e")

    # ---- 6f. qwen2-vl-7b (VLM) at full width and depth, the encoder-decoder
    # freed first
    gc.collect()
    torch.cuda.empty_cache()
    vlm = vlm_phase(torch, np, F, {name: kernels[name] for name in
                                   ("flash_attention", "paged_attention",
                                    "entropy_probe")}, phases, card,
                    profile_dir=args.profile)
    lap("6f")

    # ---- 7. the training path, the 8B model freed first
    train_phase(torch, np, card, {name: kernels[name] for name in
                                  ("flash_attention", "paged_attention",
                                   "entropy_probe")}, phases,
                profile_dir=args.profile)
    lap("7")
    phases["walls_s"] = walls
    print("[phases] " + json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                                    for k, v in phases.items()}))
    print(f"[phases] walls per phase (s): "
          + json.dumps({k: round(v, 1) for k, v in walls.items()})
          + f"; {sum(walls.values()):.1f} s in all ({card})")

    # ---- 8. result lines: launches from the path each kernel serves (the
    # profiled 8B paged self-EAT serve; ssd_scan from the profiled mamba2
    # serve; decode_attention, which no serve path calls, from its own phase)
    launches["decode_attention"] = decode_launches
    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:78",
        "paged_attention": "src/repro/kernels/paged_attention/kernel.py:79",
        "entropy_probe": "src/repro/kernels/entropy_probe/kernel.py:72",
        "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:70",
        "decode_attention": "src/repro/kernels/decode_attention/kernel.py:66",
    }
    out = []
    for name in replaces:
        r = rec[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/csrc/{name}.cu",
                    "replaces": replaces[name], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        for key in ("variant", "d256"):
            if key in r:
                out[-1][key] = r[key]
        if name == "flash_attention":
            m = mla["flash"]
            out[-1]["mla"] = {"launches": mla["launches"][name],
                              "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                              "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                              "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                              "variant": m["variant"],
                              "decode": m["decode"], "fused": m["fused"],
                              "fused_launches": phases["mla_fused_launches"]["flash"]["mla"],
                              "expanded": m["expanded"],
                              "float32_ms": m["float32_ms"]}
        if name == "paged_attention":
            out[-1]["fused_m3"] = fused
        if name in gemma["launches"]:
            g = dict(gemma["kernels"][name])
            out[-1]["gemma"] = {"launches": gemma["launches"][name], **g}
        if name in zamba["launches"]:
            out[-1]["zamba2"] = {"launches": zamba["launches"][name],
                                 **zamba["kernels"][name]}
        if name in encdec["launches"]:
            out[-1]["seamless"] = {"launches": encdec["launches"][name],
                                   **encdec["kernels"][name]}
        if name in vlm["kernels"]:
            out[-1]["vlm"] = {"launches": vlm["launches"][name],
                              "image_launches": vlm["image_launches"][name],
                              **vlm["kernels"][name]}
        if name in moe["launches"]:
            m = moe["kernels"][name]
            out[-1]["moe"] = {"launches": moe["launches"][name],
                              "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                              "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                              "library_ms": m["library_ms"]}
    out[-1]["launches_counted_over"] = ("its own kernel phase: no serve path "
                                        "calls decode_attention")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
