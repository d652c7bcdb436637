#!/usr/bin/env python3
"""Drive the PyTorch port of BitDecoding on one NVIDIA GPU (written for an
H100), from the kernels' build to full-width decoding and serving of
llama3-8b (at full depth, by one-token cycles, on the async runtime and by
self-speculation; and through the exact-length shim), gemma-7b,
qwen3-moe-235b-a22b, deepseek-v3-671b (MLA), zamba2-7b (the Mamba2 hybrid)
and xlstm-1.3b (the recurrent xLSTM family, at full depth, through the
shim), and the dense loop of starcoder2-3b, command-r-35b,
seamless-m4t-medium (the encoder-decoder, at full depth) and qwen2-vl-7b
(the VLM stub with M-RoPE), and training: llama3-8b at full width cut to 4
layers, the train launcher, and every family's smoke config.

    python3 chip_smoke.py
    python3 chip_smoke.py --jax-init   # the init-scale witness, see below

Phases:
  1. device: name and power limit, SM count, kernel build time, ptxas's
     registers and spills per kernel, flash_prefill's shared memory per
     head dim and its HGMMA / UTMALDG instruction counts, and every
     bitdecode / paged_bitdecode instance's HMMA / LDGSTS counts
     (cuobjdump; the checks fail if any is 0);
  2. every CUDA kernel against its plain PyTorch version on the card
     (kv_quant bit for bit at every cache width of the configs, head dims
     32-576, alone and as the K + V pair written into a cache's first
     blocks with the blocks past them unchanged; residual_flush and
     paged_residual_flush bit for bit, with
     the pages a paged flush must not touch unchanged; the flush kernel's
     append mode, the decode step's whole cache update, dense and paged,
     over 384 consecutive steps at d 128 and 256, bits 2, 4, 8 and both K
     granularities, rows filling on different steps, one masked every
     fourth step, every array compared after every step; bitdecode and
     paged_bitdecode within out 2e-2 / lse 1e-3, over scrambled and
     identity page tables, at the decode shapes of llama3-8b, gemma-7b,
     starcoder2-3b, command-r-35b and qwen3-moe-235b-a22b (g 16), bits 2,
     4, 8, block_n 32-128, rows
     with fewer blocks than splits, empty rows and full residuals;
     paged_bitdecode on an identity table bit for bit equal to bitdecode;
     both decode kernels' speculative draft read (``draft_bits``: bits
     4 -> 1, 2, 3; 8 -> 2, 4; 2 -> 1; both K granularities; g 4, 1 and 16;
     a residual of block_n or block_n + 8 tokens with res_len > block_n)
     within the same tolerances, draft_bits = bits bit for bit the normal
     read; one decode call at most two launches; the split merge alone within
     1e-5 of its plain version; flash_prefill within out 3e-2 / lse 1e-3
     over head dims 32-256, 1, 4 and 12 query heads per KV head, S from one
     row to 2,100 across every edge of its 64-row warpgroups and 128-row KV
     tiles, causal and full, both layouts, head slices of a fused QKV
     buffer and qwen3-moe's prefill shape, 64/4 heads over 1,200 tokens);
     the MLA latent modes: bitdecode and paged_bitdecode in shared_kv mode
     at deepseek-v3's width (576 / 512, g 128) and the smoke config's (160 /
     128, g 4), split counts 1, 3 and auto, scrambled and identity tables,
     the draft read 4 -> 2 bits; residual_flush and paged_residual_flush in
     shared_kv mode at d 160 and 576, both modes, bit for bit;
     flash_prefill through the padded route at MLA's d_k 192 / d_v 128);
     zamba2-7b's head dim 112: bitdecode and paged_bitdecode at its decode
     shape (B 4, H_kv 32, g 1; bits 2, 4, 8, both K granularities, split
     counts 1, 3 and auto, the draft read), residual_flush and
     paged_residual_flush in both modes bit for bit (the append over 261
     steps with a masked row), flash_prefill's padded route (112 -> 128) at
     its prefill (B 4, 32 / 32 heads, S 2,000);
     then timed with CUDA events at the main paths' shapes beside
     its bound (bytes / 3.35 TB/s vs operations / peak rate): kv_quant at
     llama3-8b's and gemma-7b's prefill (K alone, V alone, the pair into the
     cache, and the parent's fill: two launches and six slice copies); the flush
     kernel in both modes on a step that flushes every row and on one that
     flushes none, beside its plain version, the unfused step it replaced
     and an empty kernel (the launch floor), at llama3-8b's and gemma-7b's
     decode caches; bitdecode and
     paged_bitdecode as whole calls (merge included) at the three decode
     shapes (at llama3-8b's also the draft read at 2 bits, same call),
     flash_prefill also at long context (one 8,192-token prompt) and beside
     PyTorch's ``scaled_dot_product_attention`` (the yardstick;
     the port never calls it), with its TFLOP/s and share of the bound;
     the MLA modes at deepseek-v3's width (the ``mla_`` keys), and the
     d 112 instances at zamba2-7b's shapes beside their bounds, flash_prefill
     there beside scaled_dot_product_attention (the ``zamba2_`` keys);
     flash_prefill's full mode at S != T (the ``cross_`` keys: S 100 decoder
     tokens over T 4,096 frames, 16 / 16 heads of 64) beside
     scaled_dot_product_attention (non-causal), and bitdecode at
     seamless-m4t-medium's static cross read and qwen2-vl-7b's decode shape
     (the ``cross_`` and ``qwen2vl_`` keys); the full mode is held against
     its plain version at that shape, at a ragged T (S 300, T 1,000, g 4),
     S > T (2,048 over 512), S < 16, T < one KV tile and d 256, and through
     ``blockwise_attention(causal=False)``, causal at S != T refused;
     bitdecode at qwen2-vl-7b's g 7 and at the static cross read (g 1, d 64,
     32 blocks, an empty residual); the split-KV modes at llama3-8b's decode
     shape over 4 ranks' windows: bitdecode's block window and
     paged_bitdecode's column window with ``page_lo`` (page-affine pools)
     bit for bit the same kernel over a contiguous copy of the window, the
     windows' partials merged within out 2e-2 of the whole call, and
     paged_residual_flush's page range over 261 steps (pages outside a
     range unchanged, inside bit for bit the whole pool's, residuals and
     lengths equal, the plain version bit for bit), each window timed beside
     the whole call;
  3. the dense path end to end: llama3-8b at full width and depth (32
     layers, random bf16 weights from a seeded torch.Generator), 4 ragged
     prompts prefilled (flash_prefill) into the 4-bit cache, 160 greedy
     decode steps; once with the plain versions, once with the kernels and
     once with the plain versions split three ways along the cache (a
     different summation order: the fidelity floor of two correct
     implementations), all fed the plain run's token stream; then the
     device time and the count of device kernels of three decode steps
     (torch.profiler), with the fused append and with the unfused one, and
     of one prefill, with the pair fill and with the parent's fill; then
     the kernel run's 160 steps again, each one replay of the decode step
     captured as a CUDA graph (``serve.async_runtime.CapturedDecodeStep``),
     its argmax and final caches bit for bit equal to the eager kernel
     run's, ms/step beside the eager step's, and one replay's device
     kernels against one eager step's under the profiler;
  4. the serving path end to end: the same model behind ``ServeEngine``
     (4 slots, max_seq 4096), ten staggered requests with a shared prefix
     and a copy-on-write pair, all on the kernels: (a) worst-case
     reservations with prefix sharing, (b) an oversubscribed pool that
     preempts, bit for bit equal to (a), (c) no prefix sharing, (d) the
     dense kernel path fed (c)'s token streams, within the decode tolerance
     of (c)'s logits; (e) and (f): (a) and (b) on the async runtime (two
     decode steps in flight, each one graph replay), token streams and
     terminal phases bit for bit equal to (a)'s, (f) preempting, every
     completion recorded once, tokens/s, TTFT, TPOT and the overlap-aware
     host_stall_fraction beside (a)'s; (g) and (h): (a)'s pool and (b)'s
     (preempting, with the async runtime's completion thread) decoding by
     self-speculation, spec_k 4, drafts read at 2 bits, each draft and
     verify pass one replay of its captured graph, token streams and
     terminal phases bit for bit equal to (a)'s, the spec counters
     conserved, tokens/s, TTFT, TPOT, cycles, spec_accept_rate and ms a
     draft and a verify replay (CUDA events) beside (a)'s and (e)'s; every
     run audited every cycle; (l) and (m): run (e) with a one-rank NCCL
     mesh and ``splitkv="always"``, (m) with page-affine pools as well:
     every decode step the captured split-KV step (its all-gather and the
     cross-rank merge in the graph), token streams and terminal phases bit
     for bit run (e)'s, no plain version called; then
     three engine cycles of four decoding slots under the profiler, as in
     phase 3.  Launches of a captured step or pass are counted at the
     capture: a path's count is the capture's count times the replays;
  5. gemma-7b at full width, cut to 14 of its 28 layers (head_dim 256,
     16/16 heads, GeGLU, (1 + w) RMSNorm, tied scaled embeddings; the cut
     keeps the script within its time since phase 4's runs (g) and (h)
     came): the dense loop
     as in phase 3 (plain vs kernels, every row flushing), then runs (a),
     (b) and (e) of the serve workload, (b) and (e) bit for bit equal to
     (a) (d = 256 instances of paged_bitdecode and the append under
     capture);
  6. the dense loop, plain vs kernels, at full width: starcoder2-3b cut to
     8 of its 30 layers (LayerNorm, GELU, biases, 12 query heads per KV
     head) and command-r-35b cut to 4 of its 40 layers (parallel residual,
     tied embeddings; its ~61 GB of bf16 weights leave too little room on
     one 80 GB card for the plain comparison), both cut for the time of
     phases 4 (runs (g), (h)) and 7;
  7. qwen3-moe-235b-a22b at full width, cut to 4 of its 94 layers (a
     full-width layer is ~4.98 GB of bf16, 4.83 GB of it the 128 experts'
     weights; 94 layers would be ~470 GB): top-8 MoE FFNs of d_expert 1536,
     q/k RMSNorm, 64/4 heads (16 query heads per KV head, K3/K4's largest
     g), vocab 151,936; the dense loop as in phase 5 with the plain run
     split three ways as in phase 3, the share of (token, layer) top-8 sets
     on which the kernel run and the split run route as the plain run does
     (by phase and layer, beside the plain run's router logit gap at the
     8th expert) and one decode step's device ms by part (the expert products,
     routing + dispatch + combine, the attention kernels, the rest) beside
     the bounds of reading all experts and only the routed ones; then serve
     runs (a) and (e), (e) bit for bit equal to (a) (the MoE decode step one
     graph replay);
  8. deepseek-v3-671b at full width, cut to 4 of its 61 layers (the first
     3 dense, as in the config, then one MoE layer of 256 experts top-8 with
     a sigmoid router and a shared expert; ~30 GB of bf16): MLA with its
     latent cache (one shared_kv head of 576 channels, V its first 512,
     read by g = 128 query rows; the prefill through flash_prefill's padded
     route), the dense loop as in phase 7 (plain, plain split three ways,
     kernels; routing agreement; one decode step's device ms by part, the
     absorbed products among them; a row outside the logits tolerance is
     excused only if it routes unlike the plain run and the split run
     departs as far on it, at most 1 of 4 a step; a kernel run with the
     plain run's top-8 sets forced holds every row at every step), then
     serve runs (a) and (e), the sharers' suffix prefills over a
     dequantized latent prior, (e) bit for bit equal to (a);
  9. zamba2-7b at full width, cut to 27 of its 81 layers for time (4 of its
     13 super-blocks of 6 Mamba2 layers and the shared attention + MLP
     block, and the tail of 3; 32 / 32 heads of d 112; random bf16
     weights, ~2.55 B parameters at this depth; 39 layers until phase 14
     came): the
     dense loop as in phase 5 with four prompts of exactly 2,000 tokens (the
     hybrid prefills without lengths) and 96 steps, every row flushing once,
     the kernel run's SSM states no further from the plain run's (relative
     norm) than 1.5x the plain run split three ways; serve runs
     (a), (e) and (g) (exact-length prefill groups, no prefix sharing, the
     Mamba2 states spliced into the slots in place), (e) and (g) bit for bit
     equal to (a); one decode step's device ms by part (the Mamba2 layers,
     the attention kernels, the shared block's projections and MLP, the
     rest) beside the step's bound, and the launches of a step and of a
     prefill checked exactly;
  10. seamless-m4t-medium at full width and depth (12 encoder + 12 decoder
     layers, d 1,024, 16 / 16 heads of 64, d_ff 4,096, vocab 256,206; ~0.88
     B parameters): B 4 stub frame sequences of 4,096 (encoded with
     flash_prefill's full mode; the static cross caches 32 packed blocks of
     kv_quant, an empty residual), decoder prompts of exactly 100 tokens, 30
     greedy steps (every row's self cache flushes once), the dense loop on
     the plain versions and on the kernels (the cross prefill through the
     full mode at S 100 over T 4,096, the cross read through bitdecode);
     logits around the first flush, the cross caches untouched by the steps
     and, from one memory, bit for bit between kv_quant and its plain
     version; prefill s (and the encoder's), ms a step, peak memory, one
     decode step by part (self attention, cross read, unembed, the rest)
     beside its bound; the engine refusing the model (ValueError);
  11. qwen2-vl-7b at full width, cut to 4 of its 28 layers for time (28 / 4
     heads of 128, g 7, M-RoPE sections 16/24/24, QKV biases, d_ff 18,944):
     1,024 stub patches on the 32 x 32 grid ahead of ragged text of 870-895
     tokens, 30 steps (every row flushes), plain vs kernels, with phase 10's
     checks, prints and refusal;
  12. (A) xlstm-1.3b at full width and depth (48 blocks: 6 super-blocks of
     7 mLSTM + 1 sLSTM, d 2,048, 4 heads of 512, vocab 50,304; ~1.24 B
     parameters): B 4 prompts of 1,024 tokens prefilled through the
     chunkwise mLSTM, and their first 512 tokens through the config's
     sequential recurrence and the chunkwise mLSTM (block 0's output within
     rtol 2e-2 / atol 3e-1 and its state within 1e-3; at full depth the last
     logits' and the states' gaps no larger than a rounding witness's:
     random weights amplify rounding from block to block), from the
     1,024-token state 64 greedy decode steps eager and as replays of the captured
     step, bit for bit equal, one eager step by part (mLSTM blocks, sLSTM
     blocks, unembed, the rest) beside its bound; then the engine's
     exact-length shim on eight requests of 128-512 tokens (whole 64-token
     chunks: the chunkwise prefill) and 32-64 new tokens, runs (a) sync,
     (e) async and (g) speculative (spec_k 4), (e) and (g) bit for bit equal
     to (a), (g) accepting every draft; no kernel launch and no plain
     kernel version anywhere in (A); (B) llama3-8b at full width, cut to 8
     of its 32 layers for time, through the forced shim (``paged=False``:
     one B 1 prefill a request through flash_prefill and kv_quant, the
     dense caches appended by residual_flush and read by bitdecode), phase
     4's ten requests without prefix sharing: runs (i) sync, (j) async and
     (k) speculative (drafts read at 2 bits through bitdecode's draft read,
     the verify pass appending with the row mask), (j) and (k) bit for bit
     equal to (i), each request's first token the argmax of a B 1
     dense-loop prefill of its prompt, and on the paged engine's token
     streams greedy agreement with the paged engine (no prefix sharing) of
     at least 0.9;
  then ``repro_torch.launch.serve --async-runtime`` once at the smoke width;
  13. split-KV across 4 ranks that share the card on gloo (the script
     started again once a rank, ``--rank r``; NCCL takes one rank a card):
     (A) llama3-8b's decode shape at the paper's long context (B 1, H_kv 8,
     g 4, d 128, 131,072 tokens: 1,024 blocks, ~128 MB of 4-bit K+V, a row
     whose blocks end before the last rank's window), each rank bitdecode
     over its window and paged_bitdecode over its column slice of rank-local
     page-affine pools, merged across the ranks within out 2e-2 of one
     unsplit call, every rank's bits the same, each rank's window timed
     alone beside the whole call; (B) llama3-8b at full width cut to 2
     layers, the JAX package's page-affine serving schedule at kv_block 128
     (a donor, a mid-block prefix of it copied on write, a prompt served
     twice: a retained prefix hit), eager and sync: page-affine streams
     bit for bit the replicated-pool split walk's, the short requests the
     unsplit engine's (a near tie may turn one), one copy on write, split
     steps, four pool shards of a quarter of the pages each, every rank's
     streams and free lists rank 0's; a rank that fails fails the script;
  14. training on one device, no kernel of K1-K6 launched anywhere in it
     (launch counts, and under the profiler the median of five sessions of
     a train step): (A) llama3-8b at full width, cut to 4 of its 32 layers
     (~1.92 B parameters; AdamW's ~16 bytes a parameter would put 32 layers
     at ~128 GB), its own AdamW (warmup 1 so that three steps move the
     weights), remat on, 8 microbatches of one 4,096-token row (train_4k's
     length, the global batch cut from 256 to 8): the loss and every
     gradient of one microbatch bit for bit with remat on and off, 3 steps
     through the launcher's loop (finite losses and grad norms, the
     parameters changed), ms a step, tokens/s, peak GiB and the share of the
     bf16 peak ((6 N tokens + attention FLOPs) / (time x 989 TFLOP/s)); (B)
     ``repro_torch.launch.train`` on the smoke config: 6 steps checkpointed
     every 2, the same with its fourth step failing once (rolled back to
     step 2) and a ``--resume`` from step 4, bit for bit equal; (C)
     qwen3-moe, deepseek-v3 (MLA, MTP, Adafactor), zamba2, xlstm, seamless
     and qwen2-vl at their smoke configs: the loss and gradients on the card
     within the CPU tests' bounds (2e-3, 3e-2 relative L2) of the same code
     on the CPU, a leaf past 3e-2 within its rounding witness's gap (how far
     the leaf moves on the card and on the CPU, the larger, with one bf16
     ulp added to every 101st parameter), and one train step with the
     family's optimizer;
  15. a JSON line per kernel, the card's name and power limit, and the
     result line.

Every kernel run (the dense loops' kernel runs, every serve run) counts the
calls of the kernels' plain versions and fails if one ran.

``--jax-init`` instead draws the weights at the JAX package's scales (the
3-D attention projections divided by the square root of the heads axis, not
of the true fan-in) and runs 32 decode steps of the plain path, the plain
path split three ways and the kernels, printing how far each departs from
the first: the evidence for the port's own init scale (models/params.py).

Exits non-zero, printing no result, when no CUDA device is present or any
check fails.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BLOCK_N, BITS = 128, 4
PROMPT_LENS = (1900, 2000, 2050, 2100)
DECODE_STEPS = 160
WITNESS_STEPS = 32
APPEND_STEPS = 384  # phase 2's append-mode runs: every row flushes at least twice

KERNELS = {
    "kv_quant": dict(source="src/repro_torch/csrc/kv_quant.cu",
                     replaces="src/repro/kernels/kv_quant/kernel.py:105"),
    "residual_flush": dict(source="src/repro_torch/csrc/residual_flush.cu",
                           replaces="src/repro/kernels/residual_flush/kernel.py:124"),
    "bitdecode": dict(source="src/repro_torch/csrc/bitdecode.cu",
                      replaces="src/repro/kernels/bitdecode/kernel.py:232"),
    "paged_residual_flush": dict(source="src/repro_torch/csrc/residual_flush.cu",
                                 replaces="src/repro/kernels/residual_flush/kernel.py:292"),
    "paged_bitdecode": dict(source="src/repro_torch/csrc/paged_bitdecode.cu",
                            replaces="src/repro/kernels/paged_bitdecode/kernel.py:99"),
    "flash_prefill": dict(source="src/repro_torch/csrc/flash_prefill.cu",
                          replaces="src/repro/kernels/flash_prefill/kernel.py:82"),
    # the split merge of K3 and K4 (the TPU version's XLA epilogue)
    "bitdecode_merge": dict(source="src/repro_torch/csrc/bitdecode.cu",
                            replaces="src/repro/kernels/bitdecode/kernel.py:126"),
}
# dense and paged x ((bits, unit rows) x head dims x g <= 8 or 16 x K params per
# channel or token, + (bits, unit rows) x d 112 at g <= 8 x K params, + the
# shared_kv latents: bits x d_k 160, 576 x g <= 8 or 16) (bd_dispatch in
# csrc/bitdecode_body.cuh)
DECODE_INSTANCES = 2 * (4 * 4 * 2 * 2 + 4 * 2 + 3 * 2 * 2)
BITWISE = ("kv_quant", "residual_flush", "paged_residual_flush")
# phase 2's kv_quant cases (B, H, S, d, block_n): the head dims of every
# config's cache (zamba2-7b 112, the MLA latents 160 and 576)
KV_QUANT_CASES = ((4, 8, 16 * 128, 128, 128), (2, 2, 3 * 64, 32, 64), (2, 3, 4 * 32, 64, 32),
                  (2, 3, 2 * 128, 112, 128), (2, 2, 3 * 64, 160, 64), (2, 4, 2 * 128, 256, 128),
                  (1, 2, 2 * 128, 576, 128))
TOLERANCE = {"bitdecode": "out 2e-2, lse 1e-3", "paged_bitdecode": "out 2e-2, lse 1e-3",
             "flash_prefill": "out 3e-2, lse 1e-3", "bitdecode_merge": "out 1e-5, lse 1e-5"}
# phases 3, 5, 6; at B = 4 every configuration's decode resolves to > 1 split
DENSE_PATH = ("kv_quant", "residual_flush", "bitdecode", "bitdecode_merge", "flash_prefill")
SERVE_PATH = ("kv_quant", "paged_residual_flush", "paged_bitdecode", "bitdecode_merge",
              "flash_prefill")  # phases 4, 5

# phases 5 and 6: the dense family at full width
FAMILY_PROMPT_LENS = (1000, 1080, 1150, 1200)  # every row flushes within the steps
FAMILY_STEPS = 96
# depths cut to keep the script within its time (runs (g) and (h) of phase 4
# took the time of gemma-7b's and starcoder2-3b's other half; phase 7 that
# of command-r-35b's 4 more layers and starcoder2-3b's 7)
FAMILY = (("gemma-7b", {"n_layers": 14}), ("starcoder2-3b", {"n_layers": 8}),
          ("command-r-35b", {"n_layers": 4}))
# phase 7: the MoE family at full width, cut to 4 of 94 layers (a layer is
# ~4.98 GB of bf16, 4.83 GB of it experts; 94 layers, ~470 GB, fit no card)
MOE = ("qwen3-moe-235b-a22b", {"n_layers": 4})
MOE_PARTS = ("route", "slots", "dispatch", "experts", "combine", "aux_loss")  # models/moe.py
# phase 8: MLA at full width, cut to 4 of 61 layers, the first 3 dense as in the
# config (a dense layer is ~1.17 GB of bf16, the MoE layer ~22.6 GB; 61 layers,
# ~1.3 TB, fit no card): 3 dense layers and 1 MoE layer of 256 experts
MLA = ("deepseek-v3-671b", {"n_layers": 4})
MLA_PARTS = ("absorb_query", "absorb_output")  # models/mla.py: the absorbed products
# phase 9: the Mamba2 hybrid at full width, cut to 27 of its 81 layers (4 of
# its 13 super-blocks of 6 Mamba2 layers and the shared attention + MLP block,
# and the tail of 3; 81 layers, ~6.79 B parameters, fit one card, but the
# phase's host-bound runs scale with depth, and phases 12 and 14 needed their
# time: 39 layers in PRs 25-26);
# B 4 prompts of one exact length (the hybrid prefills without lengths),
# 2,000 = 15 blocks + 80, so 96 steps flush every row once
HYBRID = "zamba2-7b"
HYBRID_LAYERS = 27
HYBRID_PROMPT, HYBRID_STEPS = 2000, 96
HYBRID_PARTS = ("mamba_decode", "shared_decode")  # HybridLM's methods, timed by name
UNEMBED_PARTS = ("unembed", "tied_unembed")  # models/layers.py: every model's unembedding
# the hybrid's dense loop: the kernel run's Mamba2 states may depart from the
# plain run's (relative norm) at most this many times as far as the plain run
# split three ways does.  Any rounding change opens about the same gap: at
# 39 layers 2.5e-2-2.6e-2 / 4.3e-2-4.4e-2 on an H100 (split, kernels, a
# plain prefill in 256-key blocks split, kernels split; two prompt seeds),
# kernels / split 1.01-1.02; at 81 layers 4.6e-2-4.8e-2 / 7.3e-2-7.7e-2,
# 1.00-1.05 (scripts/hybrid_ssm_spread.py)
SSM_SPREAD = 1.5
ZAMBA_KV = (32, 112)  # the shared block's cache: 32 KV heads of d 112 (g 1)
# the hybrid's dense-loop cache after its steps: what phase 2 times at d 112
ZAMBA_PB = [(HYBRID_PROMPT + HYBRID_STEPS) // BLOCK_N] * 4
ZAMBA_RL = [(HYBRID_PROMPT + HYBRID_STEPS) % BLOCK_N] * 4
# phase 10: the encoder-decoder at full width and depth (12 + 12 layers of d
# 1,024, 16 / 16 heads of 64, d_ff 4,096, vocab 256,206; ~0.88 B parameters,
# 1.75 GB of bf16): B 4 stub frame sequences of enc_len 4,096 (the cross caches:
# 32 packed blocks, an empty residual), decoder prompts of exactly 100 tokens
# (the enc-dec prefill takes no lengths), 30 steps: every row's self cache
# flushes once, in step 28, and one step reads the flushed block (few steps
# for the script's time)
ENCDEC = "seamless-m4t-medium"
ENCDEC_PROMPT, ENCDEC_STEPS = 100, 30
# phase 11: the VLM stub with M-RoPE at full width, cut to 4 of its 28 layers
# for time (as command-r-35b is cut); 1,024 stub patches on the 32 x 32 grid
# ahead of ragged text of 870-895 tokens (with lengths: 1,894-1,919 cached
# tokens, 14 packed blocks a row), 30 steps: every row flushes (L % 128 >= 102)
VLM = ("qwen2-vl-7b", {"n_layers": 4})
VLM_TEXT_LENS = (870, 880, 890, 895)
VLM_STEPS = 30
# the VLM's cache after phase 11's dense loop, and the enc-dec's static cross
# cache: what phase 2 checks and times K3 at
VLM_PB = [(1024 + n + VLM_STEPS) // BLOCK_N for n in VLM_TEXT_LENS]
VLM_RL = [(1024 + n + VLM_STEPS) % BLOCK_N for n in VLM_TEXT_LENS]
CROSS_PB, CROSS_RL = [4096 // BLOCK_N] * 4, [0] * 4
# phase 12 (A): the recurrent xLSTM family at full width and depth (48 blocks:
# 6 super-blocks of 7 mLSTM + 1 sLSTM, d 2,048, 4 heads of 512, vocab 50,304;
# ~1.24 B parameters): B 4 prompts of 1,024 tokens, 64 decode steps; the
# engine (the exact-length shim) on prompts of whole 64-token chunks, so the
# prefill takes the chunkwise mLSTM (the config's ``xlstm_chunkwise``)
XLSTM = "xlstm-1.3b"
XLSTM_PROMPT, XLSTM_STEPS = 1024, 64
# the sequential prefill's prompts (and its comparison with a chunkwise one of
# the same tokens): the first 512 of the 1,024, for the script's time (phase
# 13 came); the chunkwise 1,024-token prefill and the decode from it stay
XLSTM_SEQ_PROMPT = 512
XLSTM_PARTS = ("mlstm_layer", "slstm_layer")  # XLSTMLM's methods, timed by name
XLSTM_MAX_SEQ = 1024
# the chunkwise prefill is exact in exact arithmetic and sums in another order
# in f32; through 48 blocks of random weights a rounding-level change grows
# block to block (on an H100 the chunkwise form's last logits part from the
# sequential form's by 2.04, its states by 0.13-0.32 in relative norm; one
# bf16 ulp on every 101st embedded input opens 3.38 and 0.22-0.59 in the
# chunkwise form, while block 0 alone agrees to 1.6e-2).  So at full depth
# its gap from the sequential form may be at most this many times the gap
# that such an input change opens in the chunkwise form itself; block 0
# alone, before anything compounds, is held to the logits tolerance
XLSTM_SPREAD = 1.0
# phase 12 (B): llama3-8b at full width through the forced shim, cut to 8 of
# its 32 layers for time; phase 4's workload without prefix sharing
SHIM = ("llama3-8b", {"n_layers": 8})
SHIM_AGREEMENT = 0.9  # greedy agreement with the paged engine (phase 4's (d): 0.943)
# phases 10 and 11: the merge runs only where a call resolves to > 1 split
FRONT_PATH = ("kv_quant", "residual_flush", "bitdecode", "flash_prefill")
# the latent cache after phase 8's dense loop (FAMILY_PROMPT_LENS + FAMILY_STEPS:
# 4,814 tokens over B 4): pack_blocks and res_len, what phase 2 checks and times
MLA_PB = [(n + FAMILY_STEPS) // BLOCK_N for n in FAMILY_PROMPT_LENS]
MLA_RL = [(n + FAMILY_STEPS) % BLOCK_N for n in FAMILY_PROMPT_LENS]
# the plain versions of the kernels: none may run on a kernel path
PLAIN_VERSIONS = (
    ("repro_torch.kernels.kv_quant.ref", ("quantize_kv_ref", "quantize_kv_pair_ref")),
    ("repro_torch.kernels.residual_flush.ref", (
        "residual_flush_ref", "paged_residual_flush_ref", "append_flush_ref",
        "paged_append_flush_ref")),
    ("repro_torch.kernels.bitdecode.ref", ("bitdecode_attention_ref", "merge_partials")),
    ("repro_torch.kernels.paged_bitdecode.ref", ("paged_bitdecode_attention_ref",)),
    ("repro_torch.kernels.flash_prefill.ref", ("flash_prefill_ref",)),
    ("repro_torch.core.attention", ("blockwise_attention_plain",)),
)


# the serve phase: llama3-8b at full width and depth behind the paged engine
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 4096
SERVE_STAGGER = 8  # cycles between submissions after the first SERVE_SLOTS
SHARED_PREFIX = 1024  # 8 blocks shared by the four prefix sharers
ASYNC_WINDOW = 2  # runs (e), (f): decode steps in flight
SPEC_K, SPEC_BITS = 4, 2  # runs (g), (h): self-speculative decoding
# phase 2's draft reads: (bits, draft_bits)
DRAFT_PAIRS = ((4, 1), (4, 2), (4, 3), (8, 2), (8, 4), (2, 1))


def serve_workload(vocab: int, seed: int = 7) -> list:
    """The serve phase's ten requests as (uid, prompt, max_new_tokens), in
    submission order: a donor and three sharers of one 1,024-token prefix,
    two identical 100-token prompts that are the prefix's first 100 tokens
    (they end mid-block inside a resident page: the speculative tail, copied
    on write at their first flush), and four unrelated prompts.  Every
    request decodes past a block boundary, so every one flushes through the
    page table."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = lambda n: rng.integers(0, vocab, n).astype(np.int32)  # noqa: E731
    prefix = toks(SHARED_PREFIX)
    shared = lambda n: np.concatenate([prefix, toks(n)])  # noqa: E731
    spec = [  # prompt, max_new_tokens
        (shared(300), 200),        # the donor
        (toks(2600), 96), (toks(950), 110), (toks(1700), 100),
        (prefix[:100].copy(), 120), (prefix[:100].copy(), 120),  # the pair
        (shared(700), 150), (shared(1100), 130), (shared(450), 160),
        (toks(2000), 100),
    ]
    return [(uid, p, n) for uid, (p, n) in enumerate(spec)]


def serve_runs(work) -> dict:
    """Engine options of runs (a)-(c), (e)-(h): (a) worst-case reservations
    with prefix sharing, audited every cycle; (b) the same in a pool of the
    scratch pages plus half the worst case, expected-case reservations at
    quantile 0 (every decode-time page must be won, so it preempts); (c) no
    prefix sharing; (e) and (f): (a) and (b) on the async runtime, two steps
    in flight, each decode step one replay of the captured step; (g) and
    (h): (a)'s and (b)'s pools decoding by self-speculation (``spec_k`` 4,
    drafts read at 2 bits; each pass one graph replay), (h) with the async
    runtime's completion thread."""
    worst = SERVE_SLOTS * max((len(p) + n) // BLOCK_N for _, p, n in work)
    base = dict(audit_every=1)
    spec = dict(spec_k=SPEC_K, spec_bits=SPEC_BITS)
    return {
        "a": dict(base, share_prefix=True),
        "b": dict(base, share_prefix=True, n_pages=SERVE_SLOTS + -(-worst // 2),
                  reserve_policy="expected", expected_quantile=0.0),
        "c": dict(base, share_prefix=False),
        "e": dict(base, share_prefix=True, async_runtime=True, async_window=ASYNC_WINDOW),
        "f": dict(base, share_prefix=True, n_pages=SERVE_SLOTS + -(-worst // 2),
                  reserve_policy="expected", expected_quantile=0.0, async_runtime=True,
                  async_window=ASYNC_WINDOW),
        "g": dict(base, share_prefix=True, **spec),
        "h": dict(base, share_prefix=True, n_pages=SERVE_SLOTS + -(-worst // 2),
                  reserve_policy="expected", expected_quantile=0.0, async_runtime=True, **spec),
    }


def drive_engine(engine, work):
    """Submit ``work`` to ``engine`` (the first SERVE_SLOTS at once, then one
    every SERVE_STAGGER cycles) and run it dry.  Returns (requests, summary)."""
    import time as _time

    from repro_torch.serve import Request

    reqs = [Request(uid=uid, prompt=p, max_new_tokens=n) for uid, p, n in work]
    t0 = _time.perf_counter()
    for r in reqs[:SERVE_SLOTS]:
        engine.submit(r)
    pending, cycle = reqs[SERVE_SLOTS:], 0
    while pending or engine._has_work():
        engine.step()
        cycle += 1
        if pending and cycle % SERVE_STAGGER == 0:
            engine.submit(pending.pop(0))
    if engine._completions is not None:
        engine._completions.drain()  # every completion recorded
    wall = _time.perf_counter() - t0
    if engine.audit_every:
        engine.audit().raise_if_violations()
    return reqs, engine.summary(wall_s=wall)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Checks:
    """Collects failed checks; the script exits non-zero if any failed."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, ok: bool, what: str) -> bool:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
        return ok


def fidelity(lg_ref, lg) -> dict:
    """How far logits [steps, B, V] depart from the reference run's: mean KL,
    greedy agreement and the largest logit difference."""
    logp_r, logp = lg_ref.log_softmax(-1), lg.log_softmax(-1)
    return {"mean_kl": (logp_r.exp() * (logp_r - logp)).sum(-1).mean().item(),
            "greedy_agreement": (lg_ref.argmax(-1) == lg.argmax(-1)).float().mean().item(),
            "max_abs_dlogit": (lg - lg_ref).abs().max().item()}


def decode_run(model, params, tokens, lengths, steps, impl, num_splits="auto", feed=None):
    """Prefill the ragged batch, then ``steps`` greedy decode steps (or the
    tokens of ``feed``), the cache sized for :data:`PROFILE_STEPS` more.
    Returns (logits [steps + 1, B, V] of the last position, state, prefill
    s, decode s per step)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, {"tokens": tokens},
                                  tokens.shape[1] + steps + PROFILE_STEPS, lengths=lengths,
                                  impl=impl, quant_impl=impl)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    out = [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
        logits, state = model.decode_step(params, state, tok, impl=impl, quant_impl=impl,
                                          num_splits=num_splits)
        out.append(logits[:, -1])
    torch.cuda.synchronize()
    return torch.stack(out), state, t_prefill, (time.perf_counter() - t0) / steps


def model_inputs(cfg, dev, prompt_lens=PROMPT_LENS):
    import torch

    lengths = torch.tensor(prompt_lens, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab, (len(prompt_lens), max(prompt_lens)), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    return tokens, lengths


def build_random(name: str, dev, **change):
    """Config ``name`` (4-bit cache, 128-token blocks), its model, and
    random parameters from a seeded generator on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model

    cfg = get_config(name).with_(kv_bits=BITS, kv_block=BLOCK_N, kv_gran="channel", **change)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    moe = (f", {cfg.n_experts} experts of d_expert {cfg.d_expert}, top-{cfg.top_k}"
           if cfg.n_experts else "")
    log(f"  {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}{moe}, vocab {cfg.vocab}; "
        f"{n / 1e9:.2f} B parameters drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params, n


def dense_phase(model, params, cfg, check, dev, prompt_lens, steps, *, split3=False,
                captured=False, excuse_reroutes=False) -> dict:
    """The dense loop end to end: the ragged prompts prefilled into the
    4-bit cache and ``steps`` greedy decode steps, once on the plain
    versions and once on the kernels fed the plain run's tokens (and, with
    ``split3``, once more on the plain versions split three ways).  Checks
    that every kernel of the path was launched (flash_prefill and kv_quant
    once a layer in the prefill), that no plain version ran (the plain
    prefill loop included), the logits at prefill and around the first
    flush within rtol 2e-2 / atol 3e-1 (with ``excuse_reroutes``, bar the
    rows :func:`excused_rows` names, and then the kernels once more with
    the plain run's top-k sets forced, :func:`forced_routing`, every row at
    every step within it), every row flushed, and layer 0's cache bit for
    bit; for the hybrid (``split3`` required), its SSM states within
    :data:`SSM_SPREAD` times the split run's gap from the plain run's, in
    relative norm.  Without side state, the device profiles of a decode
    step and a prefill, each against the parent's unfused append and fill
    (:func:`device_profile`, :func:`prefill_profile`).  With ``captured``,
    the kernel run's steps once more as replays of the captured step
    (:func:`captured_loop`).
    For an MoE model, how alike the kernel run (and the split run) route
    as the plain run does (:func:`routing_agreement`); for an MoE model and
    for the hybrid, the device ms of one more decode step of the kernel
    run by part (:func:`moe_step_profile`, :func:`hybrid_step_profile`).
    Returns the report and the kernels' launches in the kernel run."""
    import torch

    from repro_torch.kernels import _build

    tokens, lengths = model_inputs(cfg, dev, prompt_lens)
    bn, name, moe = cfg.kv_block, cfg.name, bool(cfg.n_experts)
    spec = model.paged_spec()
    if spec.exact_prefill:  # the hybrid: every row real to its last token, no lengths
        if len(set(prompt_lens)) != 1:
            raise ValueError(f"{name} prefills at one exact length, got {prompt_lens}")
        lengths = None
    if spec.side_state and not split3:
        raise ValueError(f"{name}: its SSM states are held against the split run (split3)")
    attn_layers = spec.page_layers  # layers (invocations) with a quantized cache

    routes = {}

    def run(label, impl, feed=None, num_splits="auto"):
        with routing_recorder() if moe else contextlib.nullcontext([]) as seen:
            out = decode_run(model, params, tokens, lengths, steps, impl,
                             num_splits=num_splits, feed=feed)
        routes[label] = seen
        return out

    with torch.no_grad():
        for impl in ("torch", "auto"):  # warm-up (allocator, cuBLAS), untimed
            lg, st = model.prefill(params, {"tokens": tokens[:, :2 * bn]}, 4 * bn, impl=impl,
                                   quant_impl=impl)
            model.decode_step(params, st, lg[:, -1].argmax(-1)[:, None], impl=impl,
                              quant_impl=impl)
        del lg, st
        torch.cuda.reset_peak_memory_stats()
        lg_p, st_p, pre_p, step_p = run("plain", "torch")
        peak_plain = torch.cuda.max_memory_allocated()
        feed = list(lg_p[:-1].argmax(-1)[:, :, None])
        lg_p3, st_p3 = (run("plain_split3", "torch", feed, num_splits=3)[:2] if split3
                        else (None, None))
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        with plain_calls() as plain:
            lg_k, st_k, pre_k, step_k = run("kernels", "auto", feed)
        launches = dict(_build.launches)
        peak_kernel = torch.cuda.max_memory_allocated()
        if excuse_reroutes:  # the kernels once more, routed as the plain run
            with forced_routing(routes["plain"]):
                lg_f = decode_run(model, params, tokens, lengths, steps, "auto", feed=feed)[0]

    b = len(prompt_lens)
    log(f"  {name} prefill: plain {pre_p:.3f} s, kernels {pre_k:.3f} s; decode: plain "
        f"{step_p * 1e3:.2f} ms/step, kernels {step_k * 1e3:.2f} ms/step (B={b})")
    log(f"  {name} peak device memory: plain {peak_plain / 2**30:.2f} GiB, kernels "
        f"{peak_kernel / 2**30:.2f} GiB; launches {launches}")
    for k in DENSE_PATH:
        check(launches.get(k, 0) > 0, f"{name}: {k} launched on the dense path "
                                      f"({launches.get(k, 0)})")
    check(not plain, f"{name}: no plain kernel version ran in the kernel run ({dict(plain)})")
    check(launches.get("flash_prefill", 0) == attn_layers,
          f"{name}: flash_prefill once an attention layer in the prefill "
          f"({launches.get('flash_prefill', 0)} launches, {attn_layers} layers)")
    check(launches.get("kv_quant", 0) == attn_layers,
          f"{name}: kv_quant once an attention layer for K and V in the prefill "
          f"({launches.get('kv_quant', 0)} launches, {attn_layers} layers)")
    check(bool(torch.isfinite(lg_k).all()) and lg_k.shape == (steps + 1, b, cfg.padded_vocab),
          f"{name}: logits finite, shaped (the vocab padded to {cfg.padded_vocab})")
    c_p, c_k = st_p["caches"][0], st_k["caches"][0]
    check(torch.equal(c_p.pack_blocks, c_k.pack_blocks) and torch.equal(c_p.res_len, c_k.res_len),
          f"{name}: pack_blocks {c_k.pack_blocks[0].tolist()} and res_len "
          f"{c_k.res_len[0].tolist()} equal between the runs")
    expect = [(n + steps) // bn for n in prompt_lens]
    flushed = all((n + steps) // bn > n // bn for n in prompt_lens)
    check(c_k.pack_blocks[0].tolist() == expect and flushed,
          f"{name}: every row flushed: pack_blocks {expect}")
    layer0 = [bitwise(getattr(c_k, f)[0], getattr(c_p, f)[0])
              for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res")
              if getattr(c_k, f) is not None]  # a shared_kv latent has no V side
    check(all(layer0), f"{name}: layer 0's packed cache and residual bitwise equal between "
                       "the runs")
    # the hybrid's Mamba2 states after the loop in relative norm, as the
    # tests compare them: the kernel run's gap from the plain run, beside the
    # gap the plain run split three ways opens by rounding alone
    ssm_rel = {run_name: {path: ((st[path]["ssm"] - st_p[path]["ssm"]).norm()
                                 / st_p[path]["ssm"].norm()).item()
                          for path, _ in spec.side_state}
               for run_name, st in (("kernels", st_k), ("plain_split3", st_p3))
               if st is not None and spec.side_state}
    if ssm_rel:
        gaps = "; ".join(f"{r}: " + ", ".join(f"{k} {v:.2e}" for k, v in g.items())
                         for r, g in ssm_rel.items())
        check(all(g <= SSM_SPREAD * ssm_rel["plain_split3"][k]
                  for k, g in ssm_rel["kernels"].items()),
              f"{name}: the SSM states after {steps} steps as close to the plain run's as "
              f"{SSM_SPREAD:g}x the split run's, in relative norm ({gaps})")
    # row i of the logits is decode step i (row 0: prefill); the first flush
    # happens in step `flush` and the step after it reads the flushed block
    flush = min(bn - n % bn for n in prompt_lens)

    def same_routing(idx):
        """Rows whose top-k sets, in every MoE layer at the token whose
        logits row ``idx`` holds, are the plain run's."""
        ok = torch.ones(b, dtype=torch.bool, device=dev)
        n_moe, rows = cfg.n_layers - cfg.first_dense_layers, torch.arange(b, device=dev)
        at = lengths.long() - 1 if idx == 0 else torch.zeros(b, dtype=torch.long, device=dev)
        for c in range(n_moe * idx, n_moe * (idx + 1)):  # the prefill's calls, or the step's
            ek, ep = (routes[r][c][1][rows, at].sort(-1).values for r in ("kernels", "plain"))
            ok &= (ek == ep).all(-1)
        return ok

    def excused_rows(idx, ok):
        """Rows of logits row ``idx`` outside the tolerance (``ok`` False)
        that route differently from the plain run at that token (a near tie
        of the router flipped, and with it the token's FFN) and on which the
        plain run split three ways departs from the plain run at least as
        far: a difference of rounding that the plain versions make too."""
        d_k = (lg_k[idx] - lg_p[idx]).abs().amax(-1)
        d_3 = (lg_p3[idx] - lg_p[idx]).abs().amax(-1)
        return ~ok & ~same_routing(idx) & (d_3 >= d_k), d_k, d_3

    for idx, what in ((0, "prefill"), (flush, f"decode step {flush}, the first flush"),
                      (flush + 1, f"decode step {flush + 1}, after the first flush")):
        err = (lg_k[idx] - lg_p[idx]).abs().max().item()
        msg = f"{name}: {what} logits within rtol 2e-2 / atol 3e-1 (max |d| {err:.3f})"
        if not excuse_reroutes:
            check(torch.allclose(lg_k[idx], lg_p[idx], rtol=2e-2, atol=3e-1), msg)
            continue
        ok = torch.isclose(lg_k[idx], lg_p[idx], rtol=2e-2, atol=3e-1).all(-1)
        excused, d_k, d_3 = excused_rows(idx, ok)
        same, cap = same_routing(idx), b // 4
        out = ", ".join(f"row {r}: max |d| {d_k[r]:.3f}, the split-3 run's {d_3[r]:.3f}, "
                        f"{'routed as' if same[r] else 'routed unlike'} the plain run"
                        + (", excused" if excused[r] else "")
                        for r in range(b) if not ok[r])
        check(bool((ok | excused).all()) and int(excused.sum()) <= cap,
              msg + (f"; outside it: {out} (at most {cap} of {b} rows excused)" if out else ""))
    if excuse_reroutes:
        err = (lg_f - lg_p).abs().max().item()
        check(torch.allclose(lg_f, lg_p, rtol=2e-2, atol=3e-1),
              f"{name}: the kernels with the plain run's top-{cfg.top_k} sets forced: every "
              f"row's logits at every one of the {steps + 1} steps within rtol 2e-2 / atol "
              f"3e-1 (max |d| {err:.3f})")
    fid = {"kernels": fidelity(lg_p, lg_k)}
    if split3:
        fid["plain_split3"] = fidelity(lg_p, lg_p3)
    for run_name in fid if moe else ():
        r = routing_agreement(routes["plain"], routes[run_name], lengths,
                              cfg.n_layers - cfg.first_dense_layers)
        fid[run_name] |= {"routing_agreement": r["all"], "routing": r}
        k = cfg.top_k
        by_layer = {ph: ", ".join(f"{r[f'{ph} layer {i}']:.4f}" for i in range(r["layers"]))
                    for ph in ("prefill", "decode")}
        log(f"  {name}: {run_name} and plain runs route alike on {r['all']:.4f} of {r['sets']} "
            f"(token, layer) top-{k} sets (prefill {r['prefill']:.4f}, by MoE layer "
            f"{by_layer['prefill']}; decode {r['decode']:.4f}, by MoE layer "
            f"{by_layer['decode']}); the plain run's router logit gap between its experts "
            f"ranked {k} and {k + 1}: median {r['gap_median_all']:.4f} over all sets, "
            f"{_num(r['gap_median_flipped'])} over the {r['flipped']} that differ "
            f"({_num(r['flipped_below_p10'])} of them below the 10th percentile of all, "
            f"{r['gap_p10_all']:.4f}); {r['flipped_after_upstream']} of those follow a set of "
            f"an earlier MoE layer that differs at the same token (largest gap "
            f"{_num(r['gap_max_after_upstream'])}), the others' largest gap "
            f"{_num(r['gap_max_first'])}")
    for k, f in fid.items():
        log(f"  {name}, {k} vs plain over {steps + 1} steps: mean KL {f['mean_kl']:.3e}; "
            f"greedy agreement {f['greedy_agreement']:.3f}; max |dlogit| "
            f"{f['max_abs_dlogit']:.3f}")
    prof = pre = None
    if not spec.side_state:  # the hybrid's step is read by part instead, below
        prof, pre = profile_dense(model, params, cfg, check, tokens, lengths, attn_layers)
    report = {"prefill_s": {"plain": pre_p, "kernels": pre_k}, "device_profile": prof,
              "prefill_profile": pre,
              "decode_ms_per_step": {"plain": step_p * 1e3, "kernels": step_k * 1e3},
              "tokens_per_s": {"plain": b / step_p, "kernels": b / step_k},
              "peak_gib": {"plain": peak_plain / 2**30, "kernels": peak_kernel / 2**30},
              "mean_kl": fid["kernels"]["mean_kl"], "fidelity_vs_plain": fid, "batch": b,
              "prompt_lens": list(prompt_lens), "decode_steps": steps,
              "layers": cfg.n_layers, "launches": launches}
    if ssm_rel:
        report["ssm_state_rel_diff"] = ssm_rel
    if captured:
        report["captured"] = captured_loop(model, params, cfg, check, tokens, lengths, steps,
                                           feed, lg_k, st_k, step_k)
    # one more step by part, continuing the kernel run (it advances st_k)
    if moe:
        prof["moe_step"] = moe_step_profile(model, params, cfg, st_k, lg_k[-1])
    if spec.side_state:
        report["step_by_part"] = hybrid_step_profile(model, params, cfg, st_k, lg_k[-1], check)
    return report


def profile_dense(model, params, cfg, check, tokens, lengths, attn_layers):
    """The dense loop's device profiles: three decode steps and one
    prefill, each against the parent's unfused append and fill, with
    their checks.  Returns (decode profile, prefill profile)."""
    name = cfg.name
    prof = device_profile(model, params, tokens, lengths)
    log_profile(f"{name} decode step", prof)
    pre = prefill_profile(model, params, tokens, lengths)
    for p, how in ((pre, "the pair fill"), (pre["parent_fill"], "the parent's fill")):
        log(f"  {name} prefill, {how} (torch.profiler): {p['kernels']} device kernels, "
            f"{p['all_ms']:.3f} ms of kernels; kv_quant {p['kv_quant_kernels']} kernels, "
            f"{p['kv_quant_ms']:.3f} ms")
    if pre["all_ms"] > 0:  # else the profiler saw no device time: not measured
        check(pre["kv_quant_kernels"] == attn_layers
              and pre["kernels"] < pre["parent_fill"]["kernels"],
              f"{name}: the prefill runs kv_quant once an attention layer and fewer device "
              f"kernels than the parent's fill ({pre['kernels']} vs "
              f"{pre['parent_fill']['kernels']})")
    if prof["all_ms_per_step"] > 0:  # else the profiler saw no device time: not measured
        check(prof["decode_attention_ms_per_step"] > 0,
              f"{name}: the profiler saw the decode attention's kernels on the card")
        check(prof["kernels_per_step"] < prof["unfused"]["kernels_per_step"],
              f"{name}: the fused append takes fewer device kernels a decode step "
              f"({prof['kernels_per_step']:.0f} vs {prof['unfused']['kernels_per_step']:.0f})")
    return prof, pre


@contextlib.contextmanager
def routing_recorder():
    """Keep the router logits ([B, S, E] f32) and the top-k experts ([B, S,
    k]) of every ``moe.route`` call, in call order, while the context is
    open."""
    from repro_torch.models import moe

    seen, route = [], moe.route

    def recorded(p, cfg, x):
        out = route(p, cfg, x)
        seen.append((out[0], out[2]))
        return out

    moe.route = recorded
    try:
        yield seen
    finally:
        moe.route = route


def routing_agreement(ref, other, lengths, layers: int) -> dict:
    """How alike two runs route, from their records
    (:func:`routing_recorder`), over the prefill's real tokens
    (``lengths``) and every decode step: the share of (token, layer) top-k
    sets that agree, in all, by phase and by phase and MoE layer (the calls
    cycle through the model's ``layers`` MoE layers; in MoE layer 0 the
    runs differ only by that layer's attention when the cache it reads is
    the same); and the gap between the
    reference run's k-th and (k+1)-th router logit, its median and 10th
    percentile over all sets beside its median over the sets that differ
    and the share of those below that percentile (a set that a small
    difference upstream flips is a near tie).  A set that differs after a
    set of an earlier MoE layer differed at the same token saw another
    input (another FFN output upstream), so its gap says nothing of a near
    tie: such sets are counted apart, with their largest gap beside the
    largest of the others."""
    import torch

    count = {}  # key -> [agreeing, all]
    gaps, flipped, first, after = [], [], [], []
    upstream = None  # [B, S]: a set differed in an earlier MoE layer of this pass
    for i, ((lg, a), (_, b)) in enumerate(zip(ref, other)):
        same = (a.sort(-1).values == b.sort(-1).values).all(-1)  # [B, S]
        if i % layers == 0:  # the calls of a pass (the prefill, a step) go layer by layer
            upstream = torch.zeros_like(same)
        top = lg.topk(a.shape[-1] + 1, dim=-1).values
        gap = top[..., -2] - top[..., -1]
        if same.shape[1] > 1:  # a prefill call: its real tokens
            phase = "prefill"
            real = torch.arange(same.shape[1], device=same.device)[None] < lengths[:, None]
        else:
            phase, real = "decode", torch.ones_like(same)
        n_ok, n = int((same & real).sum()), int(real.sum())
        for key in ("all", phase, f"{phase} layer {i % layers}"):
            c = count.setdefault(key, [0, 0])
            c[0] += n_ok
            c[1] += n
        gaps.append(gap[real])
        flipped.append(gap[real & ~same])
        first.append(gap[real & ~same & ~upstream])
        after.append(gap[real & ~same & upstream])
        upstream = upstream | ~same
    gaps, flipped, first, after = map(torch.cat, (gaps, flipped, first, after))
    p10 = gaps.quantile(0.1).item()
    out = {key: ok / n for key, (ok, n) in count.items()}
    return out | {"sets": count["all"][1], "layers": layers, "flipped": flipped.numel(),
                  "flipped_after_upstream": after.numel(),
                  "gap_max_first": first.max().item() if first.numel() else None,
                  "gap_max_after_upstream": after.max().item() if after.numel() else None,
                  "gap_median_all": gaps.median().item(), "gap_p10_all": p10,
                  "gap_median_flipped": flipped.median().item() if flipped.numel() else None,
                  "flipped_below_p10": ((flipped < p10).float().mean().item()
                                        if flipped.numel() else None)}


@contextlib.contextmanager
def forced_routing(record):
    """``moe.route`` taking each call's top-k experts from ``record`` (another
    run's :func:`routing_recorder` record, in call order), their weights
    from this run's router scores: a run that routes as the recorded one, so
    its logits depart from that run's by what the rest of the model does."""
    import torch

    from repro_torch.models import moe

    route, calls = moe.route, iter(record)

    def forced(p, cfg, x):
        logits, top_e = route(p, cfg, x)[0], next(calls)[1]
        scores = (torch.sigmoid(logits) if cfg.router_score == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        top_w = scores.gather(-1, top_e)
        if cfg.router_norm_topk:
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
        return logits, top_w, top_e

    moe.route = forced
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def part_ranges():
    """Each part of the MoE FFN (``MOE_PARTS`` of ``models/moe.py``) inside a
    ``torch.profiler`` range named ``moe.<part>``, MLA's absorbed products
    (``MLA_PARTS`` of ``models/mla.py``) inside ``mla.<part>``, and the
    hybrid's Mamba2 layers and shared block (``HYBRID_PARTS``, methods of
    ``transformer.HybridLM``) inside ``HybridLM.<part>``, xLSTM's mLSTM and
    sLSTM blocks (``XLSTM_PARTS``) inside ``XLSTMLM.<part>``, and the
    unembedding (``layers.unembed`` / ``tied_unembed``) inside
    ``layers.<name>``."""
    from torch.profiler import record_function

    from repro_torch.models import layers, mla, moe
    from repro_torch.models.transformer import HybridLM, XLSTMLM

    saved = [(mod, n, getattr(mod, n)) for mod, names in ((moe, MOE_PARTS), (mla, MLA_PARTS),
                                                        (HybridLM, HYBRID_PARTS),
                                                        (XLSTMLM, XLSTM_PARTS),
                                                        (layers, UNEMBED_PARTS))
             for n in names]

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    for mod, n, fn in saved:
        setattr(mod, n, ranged(f"{mod.__name__.rsplit('.', 1)[-1]}.{n}", fn))
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every kernel's plain version (:data:`PLAIN_VERSIONS`)
    while the context is open: a kernel run must make none."""
    import collections
    import importlib

    seen = collections.Counter()
    saved = []
    for mod_name, names in PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        for n in names:
            fn = getattr(mod, n)
            saved.append((mod, n, fn))

            def counted(*a, _n=n, _fn=fn, **kw):
                seen[_n] += 1
                return _fn(*a, **kw)

            setattr(mod, n, counted)
    try:
        yield seen
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def step_parts(fn) -> tuple[dict, int, dict]:
    """One call of ``fn()`` under ``torch.profiler`` with :func:`part_ranges`:
    device ms of the expert products (``moe.experts``), of routing, dispatch
    and combine (the other MoE ranges, the auxiliary loss included), of MLA's
    absorbed products (``mla.*``), of the hybrid's Mamba2 layers and of its
    shared block's torch ops (projections, norms, RoPE, MLP), of xLSTM's
    mLSTM and sLSTM blocks, of the unembedding, of the attention kernels (K3/K4, the merge, the append),
    those of a cross read apart (``cross``), and of the rest; the count of
    device kernels, and of each device kernel by name, with ``cross_reads``
    the count of cross reads.  A kernel belongs to a range if the op that
    launched it ran inside it; the port's own kernels are launched through
    ctypes, by no op, and count only under the attention kernels.  A cross
    read is a K3/K4 call (with its merge) that no append precedes since the
    last one: a self read follows its layer's append in device order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = {f"moe.{n}": ("experts" if n == "experts" else "routing") for n in MOE_PARTS}
    labels |= {f"mla.{n}": "absorbed" for n in MLA_PARTS}
    labels |= {"HybridLM.mamba_decode": "mamba", "HybridLM.shared_decode": "shared"}
    labels |= {"XLSTMLM.mlstm_layer": "mlstm", "XLSTMLM.slstm_layer": "slstm"}
    labels |= {f"layers.{n}": "unembed" for n in UNEMBED_PARTS}
    with part_ranges(), torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = [(labels[e.name], e.thread, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CPU and e.name in labels]
    parts = ("experts", "routing", "absorbed", "mamba", "shared", "mlstm", "slstm", "unembed",
             "attention", "cross")
    us = dict.fromkeys(("all", *parts), 0.0)
    kernels, by_name, attn = 0, collections.Counter(), []
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in labels:
            kernels += 1
            by_name[e.name] += 1
            us["all"] += e.time_range.elapsed_us()
            if "bitdecode" in e.name or "residual_flush" in e.name:
                attn.append(e)
        elif e.device_type == DeviceType.CPU and e.kernels and e.name not in labels:
            part = next((p for p, th, t0, t1 in ranges if th == e.thread
                         and t0 <= e.time_range.start and e.time_range.end <= t1), None)
            if part is not None:
                us[part] += sum(k.duration for k in e.kernels)
    appended, cross, by_name["cross_reads"] = False, False, 0
    for e in sorted(attn, key=lambda e: e.time_range.start):
        if "residual_flush" in e.name:
            appended, cross = True, False
        elif "bitdecode_merge" not in e.name:  # a read: its merge follows it
            cross, appended = not appended, False
            by_name["cross_reads"] += cross
        us["cross" if cross else "attention"] += e.time_range.elapsed_us()
    us["rest"] = us["all"] - sum(us[k] for k in parts)
    return {f"{k}_ms": v / 1e3 for k, v in us.items()}, kernels, by_name


def step_profile(model, params, state, logits, *, routing=False):
    """One eager decode step on the kernels by part (:func:`step_parts`, the
    session with the median count of device kernels of
    :data:`PROFILE_ROUNDS`), continuing a dense loop's kernel run from its
    ``state`` and last ``logits`` [B, V]: a warm-up step first and, with
    ``routing``, one step under :func:`routing_recorder`.  Returns (parts,
    device kernels, device kernels by name, the recorded top-k sets, the
    state after)."""
    import torch

    box = {"state": state, "tok": logits.argmax(-1)[:, None]}

    def step():
        lg, box["state"] = model.decode_step(params, box["state"], box["tok"])
        box["tok"] = lg[:, -1].argmax(-1)[:, None]

    seen = []
    with torch.no_grad():
        step()
        if routing:
            with routing_recorder() as seen:
                step()
        torch.cuda.synchronize()
        rounds = sorted((step_parts(step) for _ in range(PROFILE_ROUNDS)), key=lambda r: r[1])
    return (*rounds[len(rounds) // 2], seen, box["state"])


def moe_step_profile(model, params, cfg, state, logits) -> dict:
    """The MoE model's decode step by part (:func:`step_profile`), beside two
    bounds of the expert products at 3.35 TB/s: all E experts' weights read
    (what the step does: capacity 1 over every expert, as in JAX) and only
    the experts that this step's rows route to; and of the whole step
    (every weight but the embedding table read once)."""
    parts, kernels, _, seen, _ = step_profile(model, params, state, logits, routing=True)
    b = logits.shape[0]
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    expert_bytes = d * 3 * f * 2  # wi [d, 2f] and wo [f, d], bf16
    routed = [int(t.unique().numel()) for _, t in seen]  # distinct experts a layer
    weight_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    weight_bytes -= params["embed"]["table"].numel() * 2  # only B rows of it are read
    out = dict(parts, kernels=kernels, routed_experts_per_layer=routed,
               experts_all_bound_ms=len(routed) * e * expert_bytes / HBM_BYTES_PER_S * 1e3,
               experts_routed_bound_ms=sum(routed) * expert_bytes / HBM_BYTES_PER_S * 1e3,
               step_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3)
    out["step_routed_bound_ms"] = (out["step_bound_ms"] - out["experts_all_bound_ms"]
                                   + out["experts_routed_bound_ms"])
    if parts["all_ms"] == 0 or parts["experts_ms"] == 0:
        log(f"  {cfg.name} decode step by part: the profiler saw no device time there "
            "(not measured)")
    else:
        log(f"  {cfg.name} decode step by part (torch.profiler, one eager step, B={b}): "
            f"{kernels} device kernels, {parts['all_ms']:.3f} ms; expert "
            f"products {parts['experts_ms']:.3f} ms (bound {out['experts_all_bound_ms']:.3f} "
            f"ms reading all {e} experts, {out['experts_routed_bound_ms']:.3f} ms reading the "
            f"{routed} routed a layer); routing + dispatch + combine + aux "
            f"{parts['routing_ms']:.3f} ms; "
            + (f"MLA absorbed products {parts['absorbed_ms']:.3f} ms; "
               if cfg.mixer == "mla" else "")
            + f"attention kernels {parts['attention_ms']:.3f} ms; unembed "
            f"{parts['unembed_ms']:.3f} ms; the rest "
            f"{parts['rest_ms']:.3f} ms; the whole step's bound {out['step_bound_ms']:.3f} ms "
            f"({out['step_routed_bound_ms']:.3f} reading only routed experts)")
    return out


def hybrid_step_profile(model, params, cfg, state, logits, check) -> dict:
    """The hybrid's decode step by part (:func:`step_profile`): the Mamba2
    layers, the shared block's attention kernels (K3, the merge, the K2
    append), its projections and MLP, and the rest, beside the step's bound
    at 3.35 TB/s: every Mamba2 weight and the unembedding read once, the
    shared block's weights once an invocation, the SSM and conv states read
    and written, the caches' valid words, params and residuals read.
    Checks the step's launches exactly (one K3 and one K2 an invocation,
    one merge with more than one split) and a prefill's of two blocks (one
    K1 and one K6 an invocation), each in the median session of
    :data:`PROFILE_ROUNDS`."""
    import torch

    from repro_torch.kernels.bitdecode import ops as bd_ops

    t0 = time.perf_counter()
    parts, kernels, by_name, _, state = step_profile(model, params, state, logits)
    b, n_inv, dev = logits.shape[0], model.n_super, logits.device
    short = torch.randint(0, cfg.vocab, (b, 2 * cfg.kv_block), device=dev,  # two blocks: every
                          generator=torch.Generator(device=dev).manual_seed(1))  # K1, K6 runs
    with torch.no_grad():
        pre_events, _ = median_traced(
            lambda: model.prefill(params, {"tokens": short}, short.shape[1] + 8))
    cache = state["caches"][0]
    h, d, bn = cache.kw.shape[2], cache.kw.shape[-1], cache.block_n
    npr = cache.kw.shape[-2]
    splits = bd_ops.resolve_num_splits(
        "auto", b, h, bd_ops.work_units(cache.kw.shape[3], bn, cache.bits, bn), dev, g=1, d=d,
        block_n=bn, bits=cache.bits)

    def count(key):
        return sum(c for n, c in by_name.items() if key in n)

    want = {"bitdecode_kernel": n_inv, "residual_flush_kernel": n_inv,
            "bitdecode_merge": n_inv if splits > 1 else 0}
    got = {k: count(k) for k in want}
    pre = {k: sum(c for n, (c, _) in pre_events.items() if k in n)
           for k in ("kv_quant", "flash_prefill")}
    if parts["all_ms"] == 0:
        log(f"  {cfg.name} decode step by part: the profiler saw no device time (not measured)")
    else:
        check(got == want, f"{cfg.name}: one decode step launches {got} device kernels of the "
                           f"attention path (want {want}: {n_inv} invocations, {splits} splits)")
        check(pre == {"kv_quant": n_inv, "flash_prefill": n_inv},
              f"{cfg.name}: one prefill launches {pre} (want one each an invocation, {n_inv})")
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))  # noqa: E731
    weights = (nbytes(params["main"]) + nbytes(params.get("tail", {}))
               + n_inv * nbytes(params["shared_attn"]) + nbytes(params["unembed"])
               + nbytes(params["final_norm"]) + b * cfg.d_model * 2)
    states = 2 * sum(nbytes(state[p]) for p in ("ssm_main", "ssm_tail") if p in state)
    pb, rl = cache.pack_blocks[0].tolist(), cache.res_len[0].tolist()
    caches = n_inv * (sum(pb) * h * (2 * npr * d * 4 + 2 * 2 * (d + bn)) + sum(rl) * h * 2 * d * 2)
    out = dict(parts, kernels=kernels, launches=got, prefill_launches=pre, num_splits=splits,
               weight_bytes=weights, state_bytes=states, cache_bytes=caches,
               step_bound_ms=(weights + states + caches) / HBM_BYTES_PER_S * 1e3)
    out["shared_proj_mlp_ms"] = out.pop("shared_ms")
    out["mamba2_ms"] = out.pop("mamba_ms")
    log(f"  {cfg.name} decode step by part (torch.profiler, one eager step, B={b}, median of "
        f"{PROFILE_ROUNDS} sessions): {kernels} device kernels, {parts['all_ms']:.3f} ms; "
        f"Mamba2 layers {out['mamba2_ms']:.3f} ms; the shared block's attention kernels (K3 + "
        f"merge + K2 append) {parts['attention_ms']:.3f} ms; its projections, norms and MLP "
        f"{out['shared_proj_mlp_ms']:.3f} ms; unembed {parts['unembed_ms']:.3f} ms; the rest "
        f"{parts['rest_ms']:.3f} ms; the step's "
        f"bound {out['step_bound_ms']:.3f} ms ({weights / 1e9:.2f} GB of weights, "
        f"{states / 1e9:.2f} GB of states read and written, {caches / 1e9:.3f} GB of caches); "
        f"the profiles took {time.perf_counter() - t0:.1f} s")
    return out


def front_inputs(cfg, dev, text_lens) -> tuple[dict, object, int]:
    """The batch of a stub-front family from a seeded generator: B 4 stub
    frame sequences of ``enc_len`` (the encoder-decoder) or ``n_patches``
    patch embeddings (the VLM stub), each of width d_model, and the text
    prompts (right-padded to the longest).  Returns (batch, lengths or None,
    the tokens ahead of the text in the decoder's cache)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    b, n_text = len(text_lens), max(text_lens)
    stub = "frames" if cfg.encdec else "patches"
    n_stub = cfg.enc_len if cfg.encdec else cfg.n_patches
    batch = {stub: torch.randn((b, n_stub, cfg.d_model), generator=gen, device=dev).to(
                 torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab, (b, n_text), device=dev, generator=gen)}
    if cfg.encdec:  # the enc-dec prefill takes no lengths: every row real to its last token
        if len(set(text_lens)) != 1:
            raise ValueError(f"{cfg.name} prefills at one exact length, got {text_lens}")
        return batch, None, 0
    return batch, torch.tensor(text_lens, dtype=torch.int32, device=dev), cfg.n_patches


def front_phase(model, params, cfg, check, dev, text_lens, steps) -> dict:
    """Phases 10 and 11: the dense loop of a family with a stub-modality
    front, which the engine refuses: the encoder-decoder over stub frames or
    the VLM stub over stub patches (:func:`front_inputs`), prefilled and
    decoded ``steps`` greedy steps on the plain versions, then on the
    kernels fed the plain run's tokens.  Checks that every kernel of the
    path launched (K6 once an encoder layer and twice a decoder layer: self
    and cross; K1 once a cache with a packed block), that no plain version
    ran, the logits at prefill and around the first flush within rtol 2e-2 /
    atol 3e-1, every row flushed, layer 0's self cache bit for bit; for the
    encoder-decoder, the cross caches untouched by the decode steps and,
    from one memory, K1's cross caches bit for bit equal to its plain
    version's; and that the engine refuses the model with the JAX engine's
    ValueError, ``paged=None`` and ``paged=False``.  Then one decode step of
    the kernel run by part (:func:`front_step_profile`), its launches
    checked.  Returns the report
    (with the kernel run's launches)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import attention as mattn
    from repro_torch.serve import ServeEngine

    name, bn, encdec = cfg.name, cfg.kv_block, cfg.encdec
    batch, lengths, n_lead = front_inputs(cfg, dev, text_lens)
    kw = {} if lengths is None else {"lengths": lengths}
    cached = [n_lead + n for n in text_lens]  # the self caches' tokens after the prefill
    max_seq = n_lead + max(text_lens) + steps + PROFILE_STEPS
    b = len(text_lens)

    def cross_fields(state):
        c = state["cross"]
        return [getattr(c, f).clone() for f in ("kw", "k_scale", "k_zero", "vw", "v_scale",
                                                "v_zero", "k_res", "v_res", "res_len")]

    def encoder_s(impl):
        """The encoder alone, on the host clock around a synchronised call."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode(params, batch["frames"], impl=impl)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run(impl, feed=None):
        """(logits [steps + 1, B, V], state, prefill s, decode s a step, the
        cross caches after the prefill)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, batch, max_seq, impl=impl, quant_impl=impl, **kw)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        cross0 = cross_fields(state) if encdec else None
        out = [logits[:, -1]]
        t0 = time.perf_counter()
        for i in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
            logits, state = model.decode_step(params, state, tok, impl=impl, quant_impl=impl)
            out.append(logits[:, -1])
        torch.cuda.synchronize()
        return torch.stack(out), state, t_pre, (time.perf_counter() - t0) / steps, cross0

    with torch.no_grad():
        for impl in ("torch", "auto"):  # warm-up (allocator, cuBLAS), untimed
            lg, st = model.prefill(params, batch, max_seq, impl=impl, quant_impl=impl, **kw)
            model.decode_step(params, st, lg[:, -1].argmax(-1)[:, None], impl=impl,
                              quant_impl=impl)
        del lg, st
        enc_p, enc_k = (encoder_s(impl) if encdec else 0.0 for impl in ("torch", "auto"))
        torch.cuda.reset_peak_memory_stats()
        lg_p, st_p, pre_p, step_p, _ = run("torch")
        peak_plain = torch.cuda.max_memory_allocated()
        feed = list(lg_p[:-1].argmax(-1)[:, :, None])
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        with plain_calls() as plain:
            lg_k, st_k, pre_k, step_k, cross0 = run("auto", feed)
        launches = dict(_build.launches)
        peak_kernel = torch.cuda.max_memory_allocated()

    log(f"  {name} prefill: plain {pre_p:.3f} s, kernels {pre_k:.3f} s"
        + (f" (the encoder alone: plain {enc_p:.3f} s, kernels {enc_k:.3f} s)" if encdec else "")
        + f"; decode: plain {step_p * 1e3:.2f} ms/step, kernels {step_k * 1e3:.2f} ms/step "
        f"(B={b})")
    log(f"  {name} peak device memory: plain {peak_plain / 2**30:.2f} GiB, kernels "
        f"{peak_kernel / 2**30:.2f} GiB; launches {launches}")
    for k in FRONT_PATH:
        check(launches.get(k, 0) > 0, f"{name}: {k} launched on the dense path "
                                      f"({launches.get(k, 0)})")
    check(not plain, f"{name}: no plain kernel version ran in the kernel run ({dict(plain)})")
    n_fp = cfg.enc_layers + 2 * cfg.dec_layers if encdec else cfg.n_layers
    self_layers = cfg.dec_layers if encdec else cfg.n_layers
    n_kq = self_layers * ((n_lead + max(text_lens) >= bn) + (encdec and cfg.enc_len >= bn))
    check(launches.get("flash_prefill", 0) == n_fp,
          f"{name}: flash_prefill {n_fp} times in the prefill ({launches.get('flash_prefill', 0)})"
          + (" (the encoder's layers, the decoder's self and cross attention)" if encdec else ""))
    check(launches.get("kv_quant", 0) == n_kq,
          f"{name}: kv_quant once a cache with a packed block in the prefill "
          f"({launches.get('kv_quant', 0)} launches, want {n_kq})")
    check(bool(torch.isfinite(lg_k).all()) and lg_k.shape == (steps + 1, b, cfg.padded_vocab),
          f"{name}: logits finite, shaped (the vocab padded to {cfg.padded_vocab})")
    c_p, c_k = (st["self"] if encdec else st["caches"][0] for st in (st_p, st_k))
    expect = [(n + steps) // bn for n in cached]
    check(torch.equal(c_p.pack_blocks, c_k.pack_blocks) and torch.equal(c_p.res_len, c_k.res_len)
          and c_k.pack_blocks[0].tolist() == expect
          and all((n + steps) // bn > n // bn for n in cached),
          f"{name}: every row flushed: pack_blocks {c_k.pack_blocks[0].tolist()} (want {expect}), "
          f"res_len {c_k.res_len[0].tolist()}, equal between the runs")
    layer0 = [bitwise(getattr(c_k, f)[0], getattr(c_p, f)[0])
              for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res")]
    check(all(layer0), f"{name}: layer 0's packed self cache and residual bitwise equal between "
                       "the runs")
    flush = min(bn - n % bn for n in cached)
    for idx, what in ((0, "prefill"), (flush, f"decode step {flush}, the first flush"),
                      (flush + 1, f"decode step {flush + 1}, after the first flush")):
        err = (lg_k[idx] - lg_p[idx]).abs().max().item()
        check(torch.allclose(lg_k[idx], lg_p[idx], rtol=2e-2, atol=3e-1),
              f"{name}: {what} logits within rtol 2e-2 / atol 3e-1 (max |d| {err:.3f})")
    fid = fidelity(lg_p, lg_k)
    log(f"  {name}, kernels vs plain over {steps + 1} steps: mean KL {fid['mean_kl']:.3e}; "
        f"greedy agreement {fid['greedy_agreement']:.3f}; max |dlogit| "
        f"{fid['max_abs_dlogit']:.3f}")
    report = {"prefill_s": {"plain": pre_p, "kernels": pre_k},
              "decode_ms_per_step": {"plain": step_p * 1e3, "kernels": step_k * 1e3},
              "tokens_per_s": {"plain": b / step_p, "kernels": b / step_k},
              "peak_gib": {"plain": peak_plain / 2**30, "kernels": peak_kernel / 2**30},
              "mean_kl": fid["mean_kl"], "fidelity_vs_plain": {"kernels": fid}, "batch": b,
              "text_lens": list(text_lens), "lead_tokens": n_lead, "decode_steps": steps,
              "layers": cfg.n_layers, "launches": launches}
    if encdec:
        report["encoder_s"] = {"plain": enc_p, "kernels": enc_k}
        check(all(bitwise(a, b_) for a, b_ in zip(cross0, cross_fields(st_k))),
              f"{name}: the static cross caches unchanged by the {steps} decode steps")
        with torch.no_grad():  # one memory, the cross caches by K1 and by its plain version
            mem = model.encode(params, batch["frames"])
            differ = collections.Counter()
            for li in range(cfg.dec_layers):
                p = {k: w[li] for k, w in params["decoder"]["xattn"].items()}
                got, want = (mattn.build_cross_cache(p, cfg, mem, quant_impl=impl)
                             for impl in ("cuda", "torch"))
                for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res",
                          "v_res", "pack_blocks", "res_len"):
                    a, b_ = getattr(got, f), getattr(want, f)
                    if a.dtype == torch.bfloat16:
                        a, b_ = a.view(torch.int16), b_.view(torch.int16)
                    differ[f] += int((a != b_).sum())
            del mem, got, want
        check(not +differ, f"{name}: the {cfg.dec_layers} cross caches of one memory "
                           f"({cfg.enc_len} frames, {cfg.enc_len // bn} packed blocks) bitwise "
                           f"equal, kv_quant against its plain version (elements apart: "
                           f"{dict(+differ) or 0})")
    for paged in (None, False):
        try:
            ServeEngine(model, params, slots=b, max_seq=max_seq, paged=paged, device=dev)
            msg = "built"
        except ValueError as e:
            msg = str(e)
        check("serveable cache family" in msg,
              f"{name}: the engine refuses it (paged={paged}): {msg}")
    report["step_by_part"] = front_step_profile(model, params, cfg, st_k, lg_k[-1], check)
    return report


def front_step_profile(model, params, cfg, state, logits, check) -> dict:
    """A stub-front family's decode step by part (:func:`step_profile`),
    continuing the dense loop's kernel run: the self attention's kernels
    (the K2 append, K3 and its merge), the cross read's (K3 and its merge
    over the static cache), the unembedding, and the rest (projections,
    norms, MLP, embedding); beside the step's bound at 3.35 TB/s: the
    weights the step reads once (the decoder's, the cross block's wq and wo
    but not its wk and wv, the unembedding, B rows of the embedding) and the
    caches' valid words, params and residuals.  Checks the step's launches
    exactly in the median session of :data:`PROFILE_ROUNDS`: one K2 and one
    self K3 a decoder layer, one cross K3 a decoder layer of the
    encoder-decoder, one merge a K3 call of more than one split."""
    import torch

    from repro_torch.kernels.bitdecode import ops as bd_ops

    t0 = time.perf_counter()
    parts, kernels, by_name, _, st = step_profile(model, params, state, logits)
    b, dev, encdec = logits.shape[0], logits.device, cfg.encdec
    n_dec = cfg.dec_layers if encdec else cfg.n_layers
    caches = {"self": st["self"] if encdec else st["caches"][0]}
    if encdec:
        caches["cross"] = st["cross"]

    def splits_of(c):  # a cache stacked over layers: [L, B, H, nb, npr, d]
        h, nb, d = c.kw.shape[2], c.kw.shape[3], c.kw.shape[-1]
        return bd_ops.resolve_num_splits(
            "auto", b, h, bd_ops.work_units(nb, c.block_n, c.bits, c.k_res.shape[3]), dev,
            g=cfg.n_heads // cfg.n_kv_heads, d=d, block_n=c.block_n, bits=c.bits,
            k_channel=c.k_gran == "channel")

    splits = {k: splits_of(c) for k, c in caches.items()}
    want = {"bitdecode_kernel": n_dec * len(caches), "residual_flush_kernel": n_dec,
            "bitdecode_merge": n_dec * sum(n > 1 for n in splits.values()),
            "cross_reads": n_dec if encdec else 0}
    got = {k: sum(c for n, c in by_name.items() if k in n) for k in want}
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))  # noqa: E731

    def cache_bytes(c):
        h, npr, d = c.kw.shape[-4], c.kw.shape[-2], c.kw.shape[-1]  # [layers, B, H, nb, ...]
        pb, rl = c.pack_blocks.sum().item(), c.res_len.sum().item()  # over layers and rows
        return pb * h * (2 * npr * d * 4 + 2 * 2 * (d + c.block_n)) + rl * h * 2 * d * 2

    if encdec:
        dec = params["decoder"]
        weights = nbytes(dec) - nbytes({k: dec["xattn"][k] for k in ("wk", "wv", "bk", "bv")})
    else:
        weights = sum(nbytes(v) for k, v in params.items() if k.startswith("stack_"))
    weights += (nbytes(params["unembed"]) + nbytes(params["final_norm"])
                + b * cfg.d_model * 2)
    cbytes = {k: cache_bytes(c) for k, c in caches.items()}
    out = dict(parts, kernels=kernels, launches=got, num_splits=splits, weight_bytes=weights,
               cache_bytes=cbytes, weights_bound_ms=weights / HBM_BYTES_PER_S * 1e3,
               step_bound_ms=(weights + sum(cbytes.values())) / HBM_BYTES_PER_S * 1e3)
    out["self_attention_ms"] = out.pop("attention_ms")
    out["cross_read_ms"] = out.pop("cross_ms")
    if parts["all_ms"] == 0:
        log(f"  {cfg.name} decode step by part: the profiler saw no device time (not measured)")
        return out
    check(got == want, f"{cfg.name}: one decode step launches {got} device kernels of the "
                       f"attention path (want {want}: {n_dec} decoder layers, splits {splits})")
    log(f"  {cfg.name} decode step by part (torch.profiler, one eager step, B={b}, median of "
        f"{PROFILE_ROUNDS} sessions): {kernels} device kernels, {parts['all_ms']:.3f} ms; self "
        f"attention (K2 + K3 + merge) {out['self_attention_ms']:.3f} ms"
        + (f"; cross read (K3 + merge) {out['cross_read_ms']:.3f} ms" if encdec else "")
        + f"; unembed {parts['unembed_ms']:.3f} ms; projections, norms, MLP and the rest "
        f"{parts['rest_ms']:.3f} ms; the step's bound {out['step_bound_ms']:.3f} ms "
        f"({weights / 1e9:.3f} GB of weights: {out['weights_bound_ms']:.3f} ms; caches "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in cbytes.items())
        + f"); the profiles took {time.perf_counter() - t0:.1f} s")
    return out


def captured_loop(model, params, cfg, check, tokens, lengths, steps, feed, lg_k, st_k,
                  step_k) -> dict:
    """The dense loop's decode steps once more, each one replay of the
    captured step (``serve.async_runtime.CapturedDecodeStep``) over a fresh
    prefill on the kernels, fed the eager kernel run's tokens: its argmax
    at every step and its whole final state must equal the eager kernel
    run's bit for bit.  Launches are counted at the capture: the capture's
    count of each kernel times the replays.  Then one replay and one eager
    run of the captured body under the profiler: the same device kernels."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.serve.async_runtime import CapturedDecodeStep

    name = cfg.name
    with torch.no_grad():
        _, state = model.prefill(params, {"tokens": tokens},  # sized as decode_run's
                                 tokens.shape[1] + steps + PROFILE_STEPS, lengths=lengths)
        t0 = time.perf_counter()
        step = CapturedDecodeStep(model, params, state)
        t_capture = time.perf_counter() - t0
        _build.launches.clear()
        nxt = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step.tokens.copy_(feed[i])
            step.replay()
            nxt.append(step.nxt.clone())
        torch.cuda.synchronize()
        step_g = (time.perf_counter() - t0) / steps
        eager_counted = dict(_build.launches)
    got, want = torch.stack(nxt), lg_k[1:].argmax(-1).to(torch.int32)
    check(torch.equal(got, want), f"{name} captured: the argmax of all {steps} replays equals "
                                  "the eager kernel run's bit for bit")
    same = [bitwise(getattr(a, f), getattr(b, f)) for a, b in zip(state["caches"], st_k["caches"])
            for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
                      "pack_blocks", "res_len", "arrive") if getattr(a, f) is not None]
    check(all(same) and torch.equal(state["pos"], st_k["pos"]),
          f"{name} captured: every layer's cache and pos after {steps} replays bitwise equal "
          "to the eager kernel run's")
    launches = step.launches
    check(all(step.capture_launches.get(k, 0) == model.paged_spec().page_layers
              for k in ("bitdecode", "residual_flush", "bitdecode_merge"))
          and not eager_counted and step.replays == steps,
          f"{name} captured: one capture, {steps} replays; the capture counts each decode "
          f"kernel once a layer ({dict(step.capture_launches)}), the replays count nothing "
          f"({eager_counted}): launches = capture x replays = {launches}")
    log(f"  {name} decode, captured: {step_g * 1e3:.2f} ms/step against the eager kernels' "
        f"{step_k * 1e3:.2f} ms/step (B={tokens.shape[0]}); capture with warm-up "
        f"{t_capture:.2f} s")
    prof = replay_vs_eager(step, f"{name} captured", check)
    return {"ms_per_step": {"captured": step_g * 1e3, "eager_kernels": step_k * 1e3},
            "tokens_per_s": tokens.shape[0] / step_g, "capture_s": t_capture,
            "capture_launches": dict(step.capture_launches), "replays": step.replays,
            "launches": launches, "profile": prof}


@contextlib.contextmanager
def unfused_appends():
    """Route the caches' decode appends through the parent's unfused step:
    the kernel's mode "flush" with the torch ops around it (the plain append
    with the kernel as its flush), to count and time what the fused append
    replaced."""
    from repro_torch.kernels.residual_flush import ops, ref

    saved = ops.append_flush, ops.paged_append_flush

    def unfused(plain, flush):
        return lambda *a, impl="auto", **kw: plain(*a, flush=functools.partial(flush, impl=impl),
                                                   **kw)

    ops.append_flush = unfused(ref.append_flush_ref, ops.residual_flush)
    ops.paged_append_flush = unfused(ref.paged_append_flush_ref, ops.paged_residual_flush)
    try:
        yield
    finally:
        ops.append_flush, ops.paged_append_flush = saved


def parent_fill(cache, k, v, n_full: int, quant_impl: str) -> None:
    """The parent's prefill fill of a layer's cache: K and V (K alone for a
    shared_kv latent) each through kv_quant into fresh outputs, then slice
    copies into the cache."""
    from repro_torch.kernels.kv_quant import ops as kq_ops

    if not n_full:
        return
    n = n_full * cache.block_n
    sides = [((cache.kw, cache.k_scale, cache.k_zero), k, cache.k_gran)]
    if not cache.shared_kv:  # the MLA latent: K alone
        sides.append(((cache.vw, cache.v_scale, cache.v_zero), v, "tensor"))
    for dst, x, gran in sides:
        out = kq_ops.quantize_kv(x[:, :, :n], cache.bits, gran, block_n=cache.block_n,
                                 param_dtype=dst[1].dtype, impl=quant_impl)
        for to, o in zip(dst, out):
            to[:, :, :n_full] = o


@contextlib.contextmanager
def parent_fills():
    """Route the prefill's cache fill through :func:`parent_fill`, to count
    and time what the pair launch replaced."""
    from repro_torch.core import qcache

    saved = qcache._quantize_full_region
    qcache._quantize_full_region = parent_fill
    try:
        yield
    finally:
        qcache._quantize_full_region = saved


def prefill_profile(model, params, tokens, lengths) -> dict:
    """torch.profiler over one prefill of the prompts on the kernels (the
    median of :data:`PROFILE_ROUNDS` sessions, :func:`median_traced`): the
    device kernels and their ms, and kv_quant's share; with the pair fill
    and (key ``parent_fill``) with the parent's fill."""
    import torch

    def run():
        def fill():
            model.prefill(params, {"tokens": tokens}, tokens.shape[1] + 1, lengths=lengths)

        with torch.no_grad():
            fill()
            torch.cuda.synchronize()
        events, _ = median_traced(fill)
        out = {"kernels": 0, "all_ms": 0.0, "kv_quant_ms": 0.0, "kv_quant_kernels": 0}
        for key, (count, us) in events.items():
            out["kernels"] += count
            out["all_ms"] += us / 1e3
            if "kv_quant" in key:
                out["kv_quant_ms"] += us / 1e3
                out["kv_quant_kernels"] += count
        return out

    out = run()
    with parent_fills():
        out["parent_fill"] = run()
    return out


def traced(fn, calls) -> tuple[dict, float]:
    """torch.profiler (CPU and CUDA activities) over ``calls`` calls of
    ``fn()``, ending in one synchronise.  Returns each device event's
    (count, own us) by name, and the calls' wall seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # the kernels' own rows, not the ops'
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0.0) if us is None else us
        count, total = events.get(ev.key, (0, 0.0))
        events[ev.key] = (count + ev.count, total + us)
    return events, wall


#: sessions whose median an exact count is read from (:func:`median_traced`)
PROFILE_ROUNDS = 5
# the steps :func:`step_profile` takes beyond a dense loop: a warm-up, one
# recording the routing, PROFILE_ROUNDS profiled, one spare
PROFILE_STEPS = PROFILE_ROUNDS + 3


def median_traced(fn) -> tuple[dict, float]:
    """:func:`traced` over one call of ``fn()`` in :data:`PROFILE_ROUNDS`
    sessions; returns the session whose count of device events is the
    median.  One session's count is not exact on the card: now and then a
    session loses a run of device records (on an H100 one session of run
    (e)'s step read 2,448 events against 2,456 for the same step run
    eagerly; ``scripts/captured_step_profile.py --repeats`` shows single
    sessions short of the others), so a check of an exact count reads the
    median of five."""
    rounds = sorted((traced(fn, 1) for _ in range(PROFILE_ROUNDS)),
                    key=lambda r: sum(c for c, _ in r[0].values()))
    return rounds[len(rounds) // 2]


def profile_steps(step, steps) -> dict:
    """:func:`summarise` of :func:`traced` over ``steps`` calls of ``step()``."""
    events, wall = traced(step, steps)
    return summarise(events, wall, steps)


def summarise(events, wall, steps) -> dict:
    """Device events of ``steps`` steps (:func:`traced`): ms a step for all
    kernels, for the decode attention (bitdecode / paged_bitdecode and the
    merge) and the flush (the whole fused append; in the unfused step only
    its flush), the device kernels a step (the profiler's count of device
    events), beside the steps' wall time under the profiler."""
    by_kind = {"all": 0.0, "decode_attention": 0.0, "flush": 0.0}
    kernels = 0
    for key, (count, us) in events.items():
        by_kind["all"] += us
        kernels += count
        if "bitdecode" in key:
            by_kind["decode_attention"] += us
        elif "residual_flush" in key:
            by_kind["flush"] += us
    out = {f"{k}_ms_per_step": v / steps / 1e3 for k, v in by_kind.items()}
    out["kernels_per_step"] = kernels / steps
    out["wall_ms_per_step_profiled"] = wall / steps * 1e3
    out["device_busy_share"] = by_kind["all"] / 1e3 / (wall * 1e3) if wall else None
    return out


def replay_vs_eager(step, label, check) -> dict:
    """One replay of the captured ``step`` and one eager run of its body,
    each the median of :data:`PROFILE_ROUNDS` profiled sessions
    (:func:`median_traced`): the same number of device events (a copy is a
    ``Memcpy DtoD`` eagerly and a ``memcpy32_post`` kernel node in the
    graph, so the totals are compared; on a mismatch the names whose counts
    differ are logged).  Returns the two profiles."""
    prof, events = {}, {}
    for how, fn in (("replay", step.replay), ("eager", step._body)):
        events[how], wall = median_traced(fn)
        p = prof[how] = summarise(events[how], wall, 1)
        log(f"  {label} step, one {how} (torch.profiler): {p['kernels_per_step']:.0f} device "
            f"kernels, {p['all_ms_per_step']:.3f} ms of kernels, "
            f"{p['wall_ms_per_step_profiled']:.2f} ms under the profiler")
    if prof["replay"]["all_ms_per_step"] == 0 or prof["eager"]["all_ms_per_step"] == 0:
        log(f"  {label}: the profiler saw no device time (not measured)")
        return prof
    if not check(prof["replay"]["kernels_per_step"] == prof["eager"]["kernels_per_step"],
                 f"{label}: one replay runs the eager step's device kernels "
                 f"({prof['replay']['kernels_per_step']:.0f} vs "
                 f"{prof['eager']['kernels_per_step']:.0f})"):
        r, e = ({k: c for k, (c, _) in events[how].items()} for how in ("replay", "eager"))
        differ = {k[:80]: (r.get(k, 0), e.get(k, 0)) for k in r.keys() | e.keys()
                  if r.get(k, 0) != e.get(k, 0)}
        log(f"    names whose counts differ (replay, eager): {differ}")
    return prof


def device_profile(model, params, tokens, lengths, steps=3) -> dict:
    """:func:`profile_steps` over ``steps`` decode steps on the kernels, from
    a fresh prefill of the same prompts; with the fused append and (key
    ``unfused``) with the parent's unfused append."""
    import torch

    def run():
        with torch.no_grad():
            logits, state = model.prefill(params, {"tokens": tokens},
                                          tokens.shape[1] + steps + 1, lengths=lengths)
            state = {"state": state, "tok": logits[:, -1].argmax(-1)[:, None]}

            def step():
                logits, state["state"] = model.decode_step(params, state["state"], state["tok"])
                state["tok"] = logits[:, -1].argmax(-1)[:, None]
            step()
            torch.cuda.synchronize()
            return profile_steps(step, steps)

    out = run()
    with unfused_appends():
        out["unfused"] = run()
    return out


def serve_profile(model, params, cfg, dev, steps=3) -> dict:
    """:func:`profile_steps` over ``steps`` engine cycles in steady decode:
    four of the serve workload's unrelated prompts on the four slots, all
    prefilled before the window; with the fused append and (key
    ``unfused``) with the parent's unfused append."""
    from repro_torch.serve import Request, ServeEngine

    work = serve_workload(cfg.vocab)

    def run():
        engine = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                             device=dev)
        for uid in (1, 2, 3, 9):
            engine.submit(Request(uid=uid, prompt=work[uid][1], max_new_tokens=work[uid][2]))
        for _ in range(8):  # admission and prefill, then one decode cycle
            engine.step()
            if len(engine.sched.active) == SERVE_SLOTS:
                break
        engine.step()
        if len(engine.sched.active) != SERVE_SLOTS:
            raise RuntimeError(f"serve_profile: {len(engine.sched.active)} slots decoding")
        return profile_steps(engine.step, steps)

    out = run()
    with unfused_appends():
        out["unfused"] = run()
    return out


def log_profile(what, prof) -> None:
    for p, how in ((prof, "fused append"), (prof["unfused"], "the parent's unfused append")):
        log(f"  {what}, {how} (torch.profiler, 3 steps): {p['kernels_per_step']:.0f} device "
            f"kernels a step; all kernels {p['all_ms_per_step']:.3f} ms, decode attention + "
            f"merge {p['decode_attention_ms_per_step']:.3f} ms, flush "
            f"{p['flush_ms_per_step']:.3f} ms, of {p['wall_ms_per_step_profiled']:.2f} ms a step "
            "under the profiler")


def bitwise(a, b):
    """Tensors equal bit for bit (bf16 compared as its raw bits)."""
    import torch

    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def capture_logits(engine, uids=None, feed=None):
    """Wrap ``engine._step`` to keep, per decode step of each active request
    (of ``uids``; teacher-forced replay steps skipped), the token it was fed
    and its logits row (CPU, f32).  ``feed`` (uid -> token list) overrides
    what those requests are fed: step k of request u takes ``feed[u][k]``.
    Returns (uid -> rows, uid -> fed tokens), filled as the engine runs."""
    import torch

    rows_of: dict = {}
    fed_of: dict = {}
    step = engine._step

    def run(p, s, t):
        take = [(slot, r.uid) for slot, r in engine.sched.active.items()
                if r.replay_left == 0 and (uids is None or r.uid in uids)]
        toks = {slot: int(engine.tokens[slot, 0]) for slot, _ in take}
        forced = {slot: feed[uid][len(fed_of.get(uid, ()))] for slot, uid in take
                  if feed is not None and uid in feed}
        if forced:
            toks.update(forced)
            t = t.clone()
            t[list(forced), 0] = torch.tensor(list(forced.values()), dtype=t.dtype,
                                              device=t.device)
        logits, s = step(p, s, t)
        if take:
            rows = logits[[slot for slot, _ in take], 0].float().cpu()
            for row, (slot, uid) in zip(rows, take):
                rows_of.setdefault(uid, []).append(row)
                fed_of.setdefault(uid, []).append(toks[slot])
        return logits, s

    engine._step = run
    return rows_of, fed_of


def serve_phase(model, params, cfg, check, dev, names="abcefgh", profile_replay=True) -> dict:
    """Runs (a)-(c), (e)-(h) of the serve workload (those of ``names``)
    through ``ServeEngine`` on the kernels, then, with (c), run (d): the
    dense kernel path fed (c)'s token streams as one ragged batch.  Run (c)
    feeds the prefix sharers (a)'s token streams (teacher forcing through
    the step function), so their logits with and without sharing compare
    step for step.  Runs (e) and (f), the async runtime, and (g) and (h),
    self-speculative decoding, must equal (a) bit for bit.  Returns the
    launches of runs (a), (e), (g) and (h) and a report."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.serve import AuditError, Phase, ServeEngine

    work = serve_workload(cfg.vocab)
    sharers, donor, pair = (6, 7, 8), 0, (4, 5)
    with torch.no_grad():  # warm-up (allocator, cuBLAS, the kernels), untimed
        warm = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=dev)
        drive_engine(warm, [(0, work[1][1][:300], 4)])
        del warm
    runs, launches, async_launches, spec_launches = {}, {}, {}, {}
    for name, kw in serve_runs(work).items():
        if name not in names:
            continue
        engine = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                             device=dev, **kw)
        rows, fed = {}, {}
        if name == "a":
            rows, fed = capture_logits(engine, set(sharers))
        elif name == "c" and "a" in runs:
            rows, fed = capture_logits(engine, feed={u: runs["a"]["out"][u] for u in sharers})
        pairs = time_replays(engine) if engine.spec_k > 1 else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        try:
            with plain_calls() as plain:
                reqs, summ = drive_engine(engine, work)
        except AuditError as err:
            check(False, f"run ({name}): audit failed: {err}")
            continue
        torch.cuda.synchronize()
        counted = dict(_build.launches)
        check(not plain, f"{cfg.name} run ({name}): no plain kernel version ran "
                         f"({dict(plain)})")
        if engine.spec_k > 1:
            counted = spec_checks(engine, name, reqs, summ, counted, cfg, check, pairs)
            spec_launches[name] = counted
        if engine._runner is not None:
            counted = async_checks(engine, name, reqs, summ, counted, cfg, check,
                                   profile_replay=profile_replay and name == "e")
            if name == "e":
                async_launches = counted
        if name == "a":
            launches = dict(_build.launches)
            n_kq, calls = launches.get("kv_quant", 0), summ["prefill_calls"]
            n_attn = engine.spec.page_layers
            check(n_kq % n_attn == 0 and 0 < n_kq <= n_attn * calls,
                  f"run (a): kv_quant once an attention layer in each prefill that packs a "
                  f"block ({n_kq} launches, {n_attn} layers, {calls} prefill calls)")
        peak = torch.cuda.max_memory_allocated() / 2**30
        pool = engine.pool
        log(f"  run ({name}) {kw}: {summ['steps']} cycles, {summ['decoded_tokens']} tokens, "
            f"{summ['tokens_per_s']:.1f} tokens/s, TTFT p50 {summ['ttft_p50_ms']:.0f} / p99 "
            f"{summ['ttft_p99_ms']:.0f} ms, TPOT p50 {summ['tpot_p50_ms']:.1f} / p99 "
            f"{summ['tpot_p99_ms']:.1f} ms, host_stall_fraction "
            f"{summ['host_stall_fraction']:.3f}, preempted {summ['preempted']}, cow "
            f"{summ['cow_copies']}, prefix hit blocks {summ['sched_prefix_hit_blocks']}, "
            f"discarded steps {summ['discarded_steps']}, peak {peak:.2f} GiB; launches {counted}")
        ph = summ["phase_s"]
        log(f"    phase seconds {ph}; a decode cycle (cycle time less prefill, over the "
            f"cycles) {(ph['cycle'] - ph['prefill']) / max(1, summ['steps']) * 1e3:.2f} ms")
        check(all(r.phase is Phase.DONE for r in reqs), f"run ({name}): all {len(reqs)} requests DONE")
        check(pool.n_free == pool.capacity and pool.reserved == 0,
              f"run ({name}): pool drained ({pool.n_free}/{pool.capacity} free, "
              f"{pool.reserved} reserved)")
        if name in "abefgh" and engine.spec.supports_prior:  # the hybrid shares no prefix
            check(summ["cow_copies"] > 0 and summ["sched_prefix_hit_blocks"] > 0,
                  f"run ({name}): copy on write ({summ['cow_copies']}) and prefix hits "
                  f"({summ['sched_prefix_hit_blocks']} blocks)")
        runs[name] = dict(out={r.uid: list(r.out_tokens) for r in reqs},
                          phases={r.uid: r.phase for r in reqs}, rows=rows, fed=fed,
                          peak=peak, summary=summ, launches=counted)
        engine.close()
        del engine
    spec_keys = ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
                 "spec_rejected_tokens", "spec_accept_rate", "draft_replay_ms",
                 "verify_replay_ms", "draft_replays", "verify_replays")
    report = {n: {k: r["summary"][k] for k in (
        "steps", "decoded_tokens", "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
        "tpot_p99_ms", "host_stall_fraction", "preempted", "cow_copies",
        "sched_prefix_hit_blocks", "discarded_steps", "wall_s", "phase_s")}
        | {k: r["summary"][k] for k in spec_keys if k in r["summary"]}
        | {"peak_gib": r["peak"], "launches": r["launches"],
           "replay_profile": r["summary"].get("replay_profile")} for n, r in runs.items()}
    out = {"launches": launches, "async_launches": async_launches,
           "spec_launches": spec_launches, "report": report,
           "streams": {n: (r["out"], r["phases"]) for n, r in runs.items()}}
    if "a" not in runs:
        return out
    a = runs["a"]
    for name in "befgh":
        if name not in runs:
            continue
        r = runs[name]
        diff = [u for u in a["out"] if a["out"][u] != r["out"][u]
                or a["phases"][u] != r["phases"][u]]
        check(not diff, f"run ({name}) token streams and terminal phases equal run (a)'s bit "
                        f"for bit (differ: {diff})")
        if name in "bfh":
            check(r["summary"]["preempted"] > 0,
                  f"run ({name}) preempted ({r['summary']['preempted']})")
    for name in "ef":
        if name in runs:
            ra, re_ = runs["a"]["summary"], runs[name]["summary"]
            log(f"  run ({name}) against (a), same process: tokens/s {re_['tokens_per_s']:.1f} vs "
                f"{ra['tokens_per_s']:.1f} ({re_['tokens_per_s'] / ra['tokens_per_s']:.2f}x), "
                f"TPOT p50 {re_['tpot_p50_ms']:.1f} vs {ra['tpot_p50_ms']:.1f} ms, TTFT p50 "
                f"{re_['ttft_p50_ms']:.0f} vs {ra['ttft_p50_ms']:.0f} ms, host_stall_fraction "
                f"{re_['host_stall_fraction']:.3f} (overlap-aware) vs "
                f"{ra['host_stall_fraction']:.3f}")
    for name in "gh":
        if name in runs:
            rs = runs[name]["summary"]
            ref = {n: runs[n]["summary"] for n in "ae" if n in runs}

            def beside(key, fmt, rs=rs, ref=ref):
                return f"{rs[key]:{fmt}} vs " + ", ".join(f"({n}) {r[key]:{fmt}}"
                                                         for n, r in ref.items())

            log(f"  run ({name}) against {', '.join(f'({n})' for n in ref)}, same process: "
                f"tokens/s {beside('tokens_per_s', '.1f')}; TTFT p50 "
                f"{beside('ttft_p50_ms', '.0f')} ms; TPOT p50 {beside('tpot_p50_ms', '.1f')} "
                f"ms; cycles {beside('steps', 'd')}; spec_accept_rate "
                f"{rs['spec_accept_rate']:.3f}; {_ms(rs['draft_replay_ms'])} a draft replay "
                f"({rs['draft_replays']}), {_ms(rs['verify_replay_ms'])} a verify replay "
                f"({rs['verify_replays']})")
    if "c" not in runs:
        return out
    c = runs["c"]
    same = [u for u in (donor, *pair) if a["out"][u] == c["out"][u] == c["fed"][u]]
    check(len(same) == 3, f"donor and copy-on-write pair equal with sharing on and off "
                          f"(equal: {same} of {[donor, *pair]})")
    sharer_fid = {}
    for u in sharers:  # (c) was fed (a)'s stream: the same history at every step
        f = fidelity(torch.stack(c["rows"][u])[:, None], torch.stack(a["rows"][u])[:, None])
        sharer_fid[u] = f
        log(f"  sharer {u}, (a) vs (c) on (a)'s token stream: mean KL {f['mean_kl']:.3e}, "
            f"greedy agreement {f['greedy_agreement']:.3f}, max |dlogit| "
            f"{f['max_abs_dlogit']:.3f} over {len(a['rows'][u])} steps (no tolerance: the "
            "suffix attends a dequantized prefix by design)")
    report["sharers_vs_unshared"] = sharer_fid

    # (d) the dense kernel path, fed (c)'s streams, one ragged batch
    lens = [len(p) for _, p, _ in work]
    steps = max(n for _, _, n in work)
    toks = torch.zeros((len(work), max(lens)), dtype=torch.long)
    for uid, p, _ in work:
        toks[uid, :len(p)] = torch.from_numpy(p)
    rows_d, rows_c, worst = [], [], (-1.0, (None, None))
    fails = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": toks.to(dev)}, max(lens) + steps,
                                      lengths=torch.tensor(lens, device=dev))
        for k in range(steps):
            feed = [[c["fed"][uid][k] if k < n else 0] for uid, _, n in work]
            logits, state = model.decode_step(params, state, torch.tensor(feed, device=dev))
            lg = logits[:, 0].float().cpu()
            for uid, _, n in work:
                if k < n:
                    ref = c["rows"][uid][k]
                    err = (lg[uid] - ref).abs().max().item()
                    if err > worst[0]:
                        worst = (err, (uid, k))
                    fails += not torch.allclose(lg[uid], ref, rtol=2e-2, atol=3e-1)
                    rows_d.append(lg[uid])
                    rows_c.append(ref)
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
    f = fidelity(torch.stack(rows_c)[:, None], torch.stack(rows_d)[:, None])
    check(fails == 0, f"run (d) dense kernel path vs (c): logits within rtol 2e-2 / atol 3e-1 "
                      f"at all {len(rows_d)} request-steps ({fails} outside; max |d| "
                      f"{worst[0]:.3f} at request {worst[1][0]}, step {worst[1][1]})")
    log(f"  run (d) vs (c): mean KL {f['mean_kl']:.3e}, greedy agreement "
        f"{f['greedy_agreement']:.3f}, max |dlogit| {f['max_abs_dlogit']:.3f}; "
        f"dense batch of {len(work)} took {t_dense:.1f} s")
    report["dense_vs_c"] = f | {"request_steps": len(rows_d), "outside_tolerance": fails}
    report["workload"] = [(len(p), n) for _, p, n in work]
    return out


def async_checks(engine, name, reqs, summ, counted, cfg, check, *, profile_replay) -> dict:
    """Checks of an async run: each decode step one replay of the one
    captured step, the completion ledger exactly once per request.  Returns
    the run's launches: the eager prefills' as counted, the decode steps'
    as the capture's count times the replays.  With ``profile_replay``, one
    replay and one eager run of the captured body under the profiler
    (:func:`replay_vs_eager`; gemma-7b's phase does not take it:
    ``scripts/captured_step_profile.py`` compares them at any model's
    shapes)."""
    runner = engine._runner
    step, comp = runner.step_fn, engine._completions
    n = engine.spec.page_layers
    check(step.graph is not None and step.replays == runner.dispatched == summ["steps"]
          and all(step.capture_launches.get(k, 0) == n for k in
                  ("paged_bitdecode", "paged_residual_flush", "bitdecode_merge")),
          f"run ({name}): one capture ({dict(step.capture_launches)}), one replay a decode "
          f"step ({step.replays} replays, {runner.dispatched} dispatches)")
    check(sorted(comp.records) == sorted(r.uid for r in reqs) and comp.duplicates == 0
          and summ["completions_enqueued"] == len(reqs),
          f"run ({name}): the completion ledger holds every uid once "
          f"({len(comp.records)} records, {comp.duplicates} duplicates)")
    total = dict(counted)
    for k, v in step.launches.items():
        total[k] = total.get(k, 0) + v
    for k in SERVE_PATH:
        check(total.get(k, 0) > 0, f"run ({name}): {k} launched ({total.get(k, 0)}; decode "
                                   "kernels counted as the capture's count x the replays)")
    if profile_replay:
        prof = replay_vs_eager(step, "run (e)", check)
        summ["replay_profile"] = prof
    return total


def time_replays(engine) -> dict:
    """Wrap the spec engine's draft and verify ``replay`` with CUDA events
    around each graph launch; returns name -> the event pairs, read after
    the run (each pass is followed by its read-back, so every pair has
    completed by then)."""
    import torch

    pairs: dict = {"draft": [], "verify": []}
    for name, ps in (("draft", engine._draft), ("verify", engine._verify)):
        replay = ps.replay

        def timed(replay=replay, out=pairs[name]):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            replay()
            e1.record()
            out.append((e0, e1))

        ps.replay = timed
    return pairs


def spec_checks(engine, name, reqs, summ, counted, cfg, check, pairs) -> dict:
    """Checks of a speculative run: each draft and verify pass one replay
    of its captured graph (a verify replay each cycle, the draft's only on
    the cycles with a row to draft for), the spec counters conserved, and
    with the async runtime every completion recorded once.  Records ms per
    draft and per verify replay (CUDA events) and the accept rate in
    ``summ``.  Returns the run's launches: the eager prefills' as counted,
    each pass's as its capture's count times its replays."""
    import torch

    draft, verify = engine._draft, engine._verify
    n = engine.spec.page_layers
    check(draft.graph is not None and verify.graph is not None
          and verify.replays == summ["spec_cycles"] == summ["steps"]
          and 0 < draft.replays <= verify.replays
          and draft.capture_launches.get("paged_bitdecode", 0) == n * (SPEC_K - 1)
          and draft.capture_launches.get("paged_residual_flush", 0) == 0
          and verify.capture_launches.get("paged_residual_flush", 0) == n * SPEC_K,
          f"run ({name}): draft and verify captured (draft {dict(draft.capture_launches)}, "
          f"verify {dict(verify.capture_launches)}), one verify replay a cycle "
          f"({verify.replays} replays, {summ['spec_cycles']} cycles), {draft.replays} draft "
          "replays")
    check(summ["spec_draft_tokens"] == summ["spec_accepted_tokens"]
          + summ["spec_rejected_tokens"] > 0,
          f"run ({name}): spec counters conserved (drafted {summ['spec_draft_tokens']} = "
          f"accepted {summ['spec_accepted_tokens']} + rejected {summ['spec_rejected_tokens']})")
    if engine._completions is not None:
        comp = engine._completions
        check(sorted(comp.records) == sorted(r.uid for r in reqs) and comp.duplicates == 0,
              f"run ({name}): the completion ledger holds every uid once "
              f"({len(comp.records)} records, {comp.duplicates} duplicates)")
    torch.cuda.synchronize()
    for what, ps in (("draft", draft), ("verify", verify)):
        ms = [a.elapsed_time(b) for a, b in pairs[what]]
        summ[f"{what}_replay_ms"] = sum(ms) / len(ms) if ms else None
        summ[f"{what}_replays"] = ps.replays
    total = dict(counted)
    for ps in (draft, verify):
        for k, v in ps.launches.items():
            total[k] = total.get(k, 0) + v
    for k in SERVE_PATH:
        check(total.get(k, 0) > 0, f"run ({name}): {k} launched ({total.get(k, 0)}; the "
                                   "passes' kernels counted as each capture's count x its "
                                   "replays)")
    return total


def xlstm_workload(vocab: int, seed: int = 11) -> list:
    """Phase 12 (A)'s eight requests as (uid, prompt, max_new_tokens):
    prompts of 128-512 tokens in whole 64-token chunks (the chunkwise
    prefill), 32-64 new tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, 64 * int(rng.integers(2, 9))).astype(np.int32),
             int(rng.integers(32, 65))) for uid in range(8)]


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def xlstm_step_profile(model, params, cfg, state, logits) -> dict:
    """xLSTM's decode step by part (:func:`step_profile`: the mLSTM blocks,
    the sLSTM blocks, the unembedding, the rest) beside the step's bound at
    3.35 TB/s: every weight read once (of the embedding table the B rows),
    every recurrent state read and written once."""
    parts, kernels, _, _, _ = step_profile(model, params, state, logits)
    b = logits.shape[0]
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))  # noqa: E731
    weights = (nbytes(params) - params["embed"]["table"].numel() * 2 + b * cfg.d_model * 2)
    states = 2 * nbytes(state["blocks"])
    out = dict(parts, kernels=kernels, weight_bytes=weights, state_bytes=states,
               step_bound_ms=(weights + states) / HBM_BYTES_PER_S * 1e3)
    if parts["all_ms"] == 0:
        log(f"  {cfg.name} decode step by part: the profiler saw no device time (not measured)")
        return out
    log(f"  {cfg.name} decode step by part (torch.profiler, one eager step, B={b}, median of "
        f"{PROFILE_ROUNDS} sessions): {kernels} device kernels, {parts['all_ms']:.3f} ms; "
        f"mLSTM blocks {parts['mlstm_ms']:.3f} ms, sLSTM blocks {parts['slstm_ms']:.3f} ms, "
        f"unembed {parts['unembed_ms']:.3f} ms, the rest {parts['rest_ms']:.3f} ms; the step's "
        f"bound {out['step_bound_ms']:.3f} ms ({weights / 1e9:.2f} GB of weights, "
        f"{states / 1e9:.2f} GB of recurrent states read and written)")
    return out


def _xlstm_prefill(model, params, tokens, *, perturb=False, block0=False):
    """xLSTM's prefill by its parts: the embedded prompt (with ``perturb``
    every 101st element raised by about one bf16 ulp) through every block,
    or through mLSTM block 0 alone (``block0``).  Returns (the last
    logits, or block 0's output, and the states)."""
    from repro_torch.models import layers, transformer

    x = layers.embed(params["embed"], tokens)
    if perturb:
        flat = x.view(-1)
        flat[::101] = flat[::101] * (1 + 2**-7)
    state = model.init_decode_state(tokens.shape[0], device=x.device)
    if block0:
        st = {k: v[0, 0] for k, v in state["blocks"]["mlstm"].items()}
        lp = transformer._layer(transformer._layer(params["blocks"], 0)["mlstm"], 0)
        return model.mlstm_layer(lp, x, st), st
    x = model._forward(params, x, state["blocks"])
    return model._logits(params, x[:, -1:]), state["blocks"]


def _rel_gaps(a: dict, b: dict) -> dict:
    """Relative-norm gap of each state tensor of ``a`` from ``b``'s (nested
    dicts of the same keys)."""
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            out |= {f"{k}.{kk}": g for kk, g in _rel_gaps(a[k], v).items()}
        else:
            out[k] = ((a[k] - v).norm() / v.norm()).item()
    return out


def xlstm_phase(model, params, cfg, check, dev) -> dict:
    """Phase 12 (A), the dense loop of xlstm-1.3b: B 4 prompts of
    :data:`XLSTM_PROMPT` tokens prefilled through the chunkwise mLSTM, and
    their first :data:`XLSTM_SEQ_PROMPT` tokens through the config's
    sequential recurrence and through the chunkwise mLSTM: block 0's output
    within rtol 2e-2 / atol 3e-1 and its state within 1e-3 in relative
    norm; at full depth the last logits' and every state's gap at most
    :data:`XLSTM_SPREAD` times the rounding witness's (the chunkwise form
    on the input with every 101st element one bf16 ulp up); then
    :data:`XLSTM_STEPS` greedy decode steps from the chunkwise state, eager
    and as replays of the captured step: the argmax of every step and the
    final states bit for bit equal.  No kernel launches and no plain
    version runs.  Then one eager step by part (:func:`xlstm_step_profile`)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.async_runtime import CapturedDecodeStep

    name = cfg.name
    chunked = build_model(cfg.with_(xlstm_chunkwise=True))
    tokens = torch.randint(0, cfg.vocab, (4, XLSTM_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    b, steps = tokens.shape[0], XLSTM_STEPS

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        for m in (model, chunked):  # warm-up (allocator, cuBLAS), untimed
            lg, st = m.prefill(params, {"tokens": tokens[:, :64]})
            m.decode_step(params, st, lg[:, -1].argmax(-1)[:, None])
        del lg, st
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        short = tokens[:, :XLSTM_SEQ_PROMPT]
        with plain_calls() as plain:
            (lg_s, st_s), t_seq = timed(lambda: model.prefill(params, {"tokens": short}))
            (lg_cs, st_cs), t_chunk_short = timed(lambda: chunked.prefill(params,
                                                                          {"tokens": short}))
            (lg_c, st_c), t_chunk = timed(lambda: chunked.prefill(params, {"tokens": tokens}))
            lg_w, st_w = _xlstm_prefill(chunked, params, short, perturb=True)
            (o0_s, s0_s), (o0_c, s0_c) = (_xlstm_prefill(m, params, short, block0=True)
                                          for m in (model, chunked))
            eager, graphed = _clone_tree(st_c), _clone_tree(st_c)
            tok, want = lg_c[:, -1].argmax(-1)[:, None], []

            def loop():
                nonlocal tok, eager
                for _ in range(steps):
                    lg, eager = chunked.decode_step(params, eager, tok)
                    tok = lg[:, -1].argmax(-1)[:, None]
                    want.append(tok[:, 0].to(torch.int32))
                return lg

            lg_e, t_eager = timed(loop)
            t0 = time.perf_counter()
            step = CapturedDecodeStep(chunked, params, graphed)
            t_capture = time.perf_counter() - t0
            step.tokens.copy_(lg_c[:, -1].argmax(-1)[:, None])
            got = []

            def replays():
                for _ in range(steps):
                    step.replay()
                    got.append(step.nxt.clone())

            _, t_graph = timed(replays)
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
    err = (lg_cs - lg_s).abs().max().item()
    check(bool(torch.isfinite(lg_c).all()) and lg_c.shape == (b, 1, cfg.padded_vocab),
          f"{name}: prefill logits finite, shaped (the vocab padded to {cfg.padded_vocab})")
    err0, gaps0 = (o0_c - o0_s).abs().max().item(), _rel_gaps(s0_c, s0_s)
    check(torch.allclose(o0_c, o0_s, rtol=2e-2, atol=3e-1) and max(gaps0.values()) < 1e-3,
          f"{name}: block 0's chunkwise output within rtol 2e-2 / atol 3e-1 of the sequential "
          f"one's (max |d| {err0:.3e}), its state within 1e-3 in relative norm ("
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps0.items()) + ")")
    gaps, wit = _rel_gaps(st_cs["blocks"], st_s["blocks"]), _rel_gaps(st_w, st_cs["blocks"])
    err_w = (lg_w - lg_cs).abs().max().item()
    check(err <= XLSTM_SPREAD * err_w and all(g <= XLSTM_SPREAD * wit[k] for k, g in gaps.items()),
          f"{name}: at full depth the chunkwise prefill departs from the sequential one (last "
          f"logits max |d| {err:.3f}; states " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f") at most {XLSTM_SPREAD:g}x as far as the rounding witness does (max |d| "
          f"{err_w:.3f}; " + ", ".join(f"{k} {v:.2e}" for k, v in wit.items()) + ")")
    log(f"  {name} prefill of B {b} x {XLSTM_SEQ_PROMPT} tokens: sequential {t_seq:.2f} s, "
        f"chunkwise {t_chunk_short:.2f} s; of B {b} x {XLSTM_PROMPT} tokens: chunkwise "
        f"{t_chunk:.2f} s")
    same = [bitwise(a, c) for kind in ("mlstm", "slstm")
            for a, c in zip(eager["blocks"][kind].values(), graphed["blocks"][kind].values())]
    check(torch.equal(torch.stack(got), torch.stack(want)) and all(same)
          and torch.equal(eager["pos"], graphed["pos"]),
          f"{name}: {steps} replays of the captured step equal the eager steps bit for bit "
          "(every argmax, every recurrent state and pos at the end)")
    check(bool(torch.isfinite(lg_e).all()), f"{name}: the decode logits finite")
    check(not launches and not step.capture_launches and not plain,
          f"{name}: no kernel launched ({launches}, capture {dict(step.capture_launches)}) and "
          f"no plain kernel version called ({dict(plain)}): no KV cache")
    log(f"  {name} decode, B={b}: eager {t_eager / steps * 1e3:.2f} ms/step, captured "
        f"{t_graph / steps * 1e3:.2f} ms/step (capture with warm-up {t_capture:.2f} s); peak "
        f"device memory {peak:.2f} GiB")
    prof = xlstm_step_profile(chunked, params, cfg, eager, lg_e[:, -1])
    return {"prefill_s": {"sequential": t_seq, "chunkwise_short": t_chunk_short,
                          "chunkwise": t_chunk, "sequential_prompt_len": XLSTM_SEQ_PROMPT},
            "chunkwise_vs_sequential": {"max_abs_dlogit": err, "state_rel_gap": gaps,
                                        "block0_max_abs_d": err0, "block0_state_rel_gap": gaps0},
            "rounding_witness": {"max_abs_dlogit": err_w, "state_rel_gap": wit},
            "decode_ms_per_step": {"eager": t_eager / steps * 1e3,
                                   "captured": t_graph / steps * 1e3},
            "capture_s": t_capture, "peak_gib": peak, "batch": b,
            "prompt_len": XLSTM_PROMPT, "decode_steps": steps, "launches": launches,
            "step_by_part": prof}


def shim_serve(model, params, cfg, check, dev, work, runs: dict, *, max_seq, path) -> dict:
    """The exact-length shim's runs (``runs``: name -> engine options; the
    first is the sync oracle) on ``work`` (:func:`drive_engine`), every run
    ``paged=False``: every request DONE, no pool, no plain kernel version
    called, the async and speculative runs each step or pass one replay of
    its captured graph and their streams and terminal phases bit for bit
    the first run's.  ``path``: the kernels each run must launch (the
    attention family) or () (xLSTM: none may launch).  Returns each run's
    launches (the captured steps' and passes' as capture x replays), the
    first run's requests and a report."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.serve import Phase, ServeEngine

    with torch.no_grad():  # warm-up (allocator, cuBLAS, the captures' side stream), untimed
        warm = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=max_seq, paged=False,
                           device=dev)
        drive_engine(warm, [(0, work[0][1][:128], 2)])
        del warm
    out, report, launches, first = {}, {}, {}, None
    n = cfg.n_layers
    for name, kw in runs.items():
        engine = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=max_seq, paged=False,
                             device=dev, audit_every=1, **kw)
        pairs = time_replays(engine) if engine.spec_k > 1 else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        with plain_calls() as plain:
            reqs, summ = drive_engine(engine, work)
        torch.cuda.synchronize()
        counted = dict(_build.launches)
        passes = [p for p in (engine._draft, engine._verify,
                              engine._runner.step_fn if engine._runner else None) if p is not None]
        for ps in passes:
            for k, v in ps.launches.items():
                counted[k] = counted.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(not engine.paged and engine.pool is None and not plain,
              f"{cfg.name} shim run ({name}): no pool, no plain kernel version called "
              f"({dict(plain)})")
        check(all(r.phase is Phase.DONE for r in reqs),
              f"{cfg.name} shim run ({name}): all {len(reqs)} requests DONE")
        if path:
            check(all(counted.get(k, 0) > 0 for k in path),
                  f"{cfg.name} shim run ({name}): {', '.join(path)} launched ({counted})")
        else:
            check(not counted and all(not p.capture_launches for p in passes),
                  f"{cfg.name} shim run ({name}): no kernel launched ({counted})")
        if engine._runner is not None:
            step, comp = engine._runner.step_fn, engine._completions
            want = {k: n for k in path if k in ("bitdecode", "residual_flush")}
            check(step.graph is not None and step.replays == engine._runner.dispatched
                  == summ["steps"] and all(step.capture_launches.get(k) == v
                                           for k, v in want.items())
                  and sorted(comp.records) == sorted(r.uid for r in reqs)
                  and comp.duplicates == 0,
                  f"{cfg.name} shim run ({name}): one capture ({dict(step.capture_launches)}), "
                  f"one replay a decode step ({step.replays} replays, "
                  f"{engine._runner.dispatched} dispatches), every completion recorded once")
        if engine.spec_k > 1:
            draft, verify = engine._draft, engine._verify
            want_d = {"bitdecode": n * (SPEC_K - 1)} if path else {}
            want_v = {"residual_flush": n * SPEC_K, "bitdecode": n * SPEC_K} if path else {}
            check(draft.graph is not None and verify.graph is not None
                  and verify.replays == summ["spec_cycles"] == summ["steps"]
                  and 0 < draft.replays <= verify.replays
                  and all(draft.capture_launches.get(k) == v for k, v in want_d.items())
                  and not draft.capture_launches.get("residual_flush")
                  and all(verify.capture_launches.get(k) == v for k, v in want_v.items())
                  and summ["spec_draft_tokens"] == summ["spec_accepted_tokens"]
                  + summ["spec_rejected_tokens"] > 0,
                  f"{cfg.name} shim run ({name}): draft and verify captured (draft "
                  f"{dict(draft.capture_launches)}, verify {dict(verify.capture_launches)}), "
                  f"one verify replay a cycle ({verify.replays}), {draft.replays} draft "
                  f"replays, spec counters conserved ({summ['spec_draft_tokens']} drafted)")
            torch.cuda.synchronize()
            for what, ps in (("draft", draft), ("verify", verify)):
                ms = [a.elapsed_time(b) for a, b in pairs[what]]
                summ[f"{what}_replay_ms"] = sum(ms) / len(ms) if ms else None
        ph = summ["phase_s"]
        log(f"  shim run ({name}) {kw}: {summ['steps']} cycles, {summ['decoded_tokens']} tokens, "
            f"{summ['tokens_per_s']:.1f} tokens/s, TTFT p50 {summ['ttft_p50_ms']:.0f} / p99 "
            f"{summ['ttft_p99_ms']:.0f} ms, TPOT p50 {summ['tpot_p50_ms']:.1f} / p99 "
            f"{summ['tpot_p99_ms']:.1f} ms, host_stall_fraction "
            f"{summ['host_stall_fraction']:.3f}, {summ['prefill_calls']} prefills "
            f"{ph['prefill']:.2f} s, peak {peak:.2f} GiB"
            + (f", spec_accept_rate {summ['spec_accept_rate']:.3f}, "
               f"{_ms(summ['draft_replay_ms'])} a draft replay, "
               f"{_ms(summ['verify_replay_ms'])} a verify replay" if engine.spec_k > 1 else "")
            + f"; launches {counted}")
        streams = ({r.uid: list(r.out_tokens) for r in reqs}, {r.uid: r.phase for r in reqs})
        if first is None:
            first = (name, streams, reqs)
        else:
            diff = [u for u in streams[0] if streams[0][u] != first[1][0][u]
                    or streams[1][u] != first[1][1][u]]
            check(not diff, f"{cfg.name} shim run ({name}) token streams and terminal phases "
                            f"equal run ({first[0]})'s bit for bit (differ: {diff})")
        launches[name] = counted
        report[name] = {k: summ[k] for k in (
            "steps", "decoded_tokens", "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
            "tpot_p50_ms", "tpot_p99_ms", "host_stall_fraction", "prefill_calls", "wall_s",
            "phase_s", "spec_accept_rate", "spec_draft_tokens", "spec_accepted_tokens",
            "draft_replay_ms", "verify_replay_ms") if k in summ} | {
            "peak_gib": peak, "launches": counted}
        engine.close()
        del engine
    out.update(launches=launches, report=report, reqs=first[2])
    return out


def shim_phase(model, params, cfg, check, dev) -> dict:
    """Phase 12 (B): llama3-8b through the forced shim (``paged=False``) on
    phase 4's workload without prefix sharing: runs (i) sync, (j) async and
    (k) speculative (``spec_k`` 4, drafts at 2 bits) by
    :func:`shim_serve`; each request's first token the argmax of a B 1
    dense-loop prefill of its prompt; and the shim's greedy agreement with
    the paged engine at the same depth (no prefix sharing) on one history:
    the paged run's logits and those of a shim run fed its token streams,
    at least :data:`SHIM_AGREEMENT`."""
    import torch

    from repro_torch.serve import ServeEngine

    work = serve_workload(cfg.vocab)
    runs = {"i": {}, "j": dict(async_runtime=True, async_window=ASYNC_WINDOW),
            "k": dict(spec_k=SPEC_K, spec_bits=SPEC_BITS)}
    sv = shim_serve(model, params, cfg, check, dev, work, runs, max_seq=SERVE_MAX_SEQ,
                    path=DENSE_PATH)
    firsts = []
    with torch.no_grad():
        for uid, prompt, _ in work:
            lg, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt[None]).long()
                                           .to(dev)}, len(prompt) + 8)
            firsts.append(int(lg[0, -1].argmax()))
    got = [r.out_tokens[0] for r in sv["reqs"]]
    check(got == firsts, f"{cfg.name} shim: every request's first token the argmax of a B 1 "
                         f"dense-loop prefill of its prompt ({sum(a == b for a, b in zip(got, firsts))}"
                         f" of {len(work)})")
    # one history for both: the paged engine's streams
    rows = {}
    for name, paged, feed in (("paged", None, None), ("shim", False, True)):
        engine = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                             paged=paged, share_prefix=False, device=dev)
        rows[name] = capture_logits(
            engine, feed={u: rows["paged"][1][u] for u, _, _ in work} if feed else None)
        with torch.no_grad():
            drive_engine(engine, work)
        engine.close()
        del engine
    ref = torch.stack([r for u, _, _ in work for r in rows["paged"][0][u]])[:, None]
    shim = torch.stack([r for u, _, _ in work for r in rows["shim"][0][u]])[:, None]
    f = fidelity(ref, shim)
    check(f["greedy_agreement"] >= SHIM_AGREEMENT,
          f"{cfg.name} shim vs the paged engine on the paged run's token streams: greedy "
          f"agreement {f['greedy_agreement']:.3f} >= {SHIM_AGREEMENT} over {ref.shape[0]} "
          f"request-steps (mean KL {f['mean_kl']:.3e}, max |dlogit| "
          f"{f['max_abs_dlogit']:.3f})")
    sv.pop("reqs")
    return sv | {"vs_paged": f | {"request_steps": ref.shape[0]},
                 "workload": [(len(p), n) for _, p, n in work]}


def serve_cli(check) -> dict:
    """``python -m repro_torch.launch.serve --async-runtime`` once, in
    process, at the smoke width on the card."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "llama3-8b", "--smoke", "--async-runtime", "--requests", "8",
            "--slots", "4", "--prompt-len", "96", "--max-new", "48", "--max-seq", "256",
            "--shared-prefix-len", "64", "--audit-every", "1"]
    stats = launch_serve.main(argv)
    check(stats["decoded_tokens"] == sum(48 + uid % 3 for uid in range(8))
          and stats["completions_enqueued"] == 8 and stats["budget_retired"] == 8,
          f"the serve CLI ({' '.join(argv)}): every request DONE ({stats['decoded_tokens']} "
          "tokens)")
    return {k: stats[k] for k in ("decoded_tokens", "tokens_per_s", "tpot_p50_ms",
                                  "host_stall_fraction", "discarded_steps")}


# ------------------------------------------------------------------ training
TRAIN = ("llama3-8b", {"n_layers": 4})  # phase 14 (A): full width, 4 of its 32 layers
TRAIN_BATCH = 8  # train_4k's length with its global batch cut from 256 to 8
TRAIN_STEPS = 3
TRAIN_PROFILE_SEQ = 512  # the profiled sessions' train step: B 1 x 512, one microbatch
TRAIN_FAMILIES = ("qwen3-moe-235b-a22b", "deepseek-v3-671b", "zamba2-7b", "xlstm-1.3b",
                  "seamless-m4t-medium", "qwen2-vl-7b")  # phase 14 (C), at their smoke configs
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 2e-3, 3e-2  # the CPU tests' bounds against JAX
# The one gradient leaf held past TRAIN_GRAD_REL_L2 on the card, by family:
# zamba2's tail dt_bias ([1, 8]) sums 64 terms that nearly cancel, so a
# rounding-level change moves it by several per cent (ROADMAP C;
# scripts/train_grad_spread.py).  It passes if its gap to the CPU is no larger
# than GRAD_SPREAD times its largest rounding witness: how far it moves, on the
# card and on the CPU, when one bf16 ulp is added to every 101st or every 13th
# parameter.  Every other leaf is held to TRAIN_GRAD_REL_L2.
GRAD_WITNESSED = (("zamba2-7b", "tail.mixer.dt_bias"),)
GRAD_NUDGES = (101, 13)
GRAD_SPREAD = 1.0
KERNEL_EVENTS = ("kv_quant_kernel", "residual_flush_kernel", "bitdecode", "flash_prefill_kernel")


def _kernel_events(events: dict) -> int:
    """Device events of K1-K6 (and the merge) among a profile's."""
    return sum(c for key, (c, _) in events.items() if any(k in key for k in KERNEL_EVENTS))


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def ulp_nudged(t, every: int = 101):
    """A copy of ``t`` with one ulp added to every ``every``-th element of a
    bf16 tensor (its 16-bit word plus one): a rounding-level change."""
    import torch

    if t.dtype != torch.bfloat16:
        return t.clone()
    words = t.clone().view(torch.int16).reshape(-1)
    words[::every] += 1
    return words.view(torch.bfloat16).reshape(t.shape)


def train_full_width(check, dev) -> dict:
    """Phase 14 (A): llama3-8b at full width, cut to 4 layers, remat on, 8
    microbatches of B 1 x 4,096: remat on vs off on one microbatch, 3 steps
    through the launcher's loop, 5 profiled sessions of one step."""
    import torch

    from repro_torch.configs import SHAPES, ShapeSpec
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import TrainState, make_train_step, value_and_grad

    name, change = TRAIN
    t0 = time.perf_counter()
    cfg, model, params, n = build_random(name, dev, **change)
    seq = SHAPES["train_4k"].seq_len
    check(cfg.remat == "full" and cfg.microbatches == 8 and cfg.optimizer == "adamw",
          f"{name}: its own remat ({cfg.remat}), microbatches ({cfg.microbatches}) and "
          f"optimizer ({cfg.optimizer})")
    out = {"n_params": n, "cut": f"cut to {change['n_layers']} of 32 layers",
           "batch": TRAIN_BATCH, "seq": seq}

    # remat on vs off, one microbatch, loss and every gradient bit for bit
    t1 = time.perf_counter()
    mb = make_batch(cfg, ShapeSpec("mb", seq, 1, "train"), step=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    loss_on, g_on = value_and_grad(model.loss, params, mb)
    torch.cuda.synchronize()
    peak_on = torch.cuda.max_memory_allocated() / 2**30
    t_on = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    loss_off, g_off = value_and_grad(build_model(cfg.with_(remat="none")).loss, params, mb)
    torch.cuda.synchronize()
    peak_off = torch.cuda.max_memory_allocated() / 2**30
    differ = [i for i, (a, b) in enumerate(zip(g_on, g_off)) if not torch.equal(a, b)]
    worst = max((_rel_l2(g_on[i], g_off[i]) for i in differ), default=0.0)
    check(torch.equal(loss_on, loss_off) and not differ,
          f"{name}: remat on = remat off on one microbatch of {seq} tokens, the loss and all "
          f"{len(g_on)} gradients bit for bit ({len(differ)} differ, worst relative L2 "
          f"{worst:.2e}; peak {peak_on:.1f} GiB with remat, {peak_off:.1f} GiB without)")
    out |= {"remat_bitwise": not differ, "remat_leaves_differ": len(differ),
            "remat_worst_rel_l2": worst, "peak_gib_remat_one_mb": peak_on,
            "peak_gib_no_remat_one_mb": peak_off, "remat_on_s": t_on,
            "remat_check_s": time.perf_counter() - t1}
    del g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()

    # 3 steps through the launcher's loop (no checkpoint at this width)
    t1 = time.perf_counter()
    opt = get_optimizer(cfg.optimizer, total_steps=TRAIN_STEPS, warmup=1)
    state = TrainState(params, opt.init(params), 0)
    probe = {k: params["stack_0"][k]["wo"][0, :64].clone() for k in ("attn", "mlp")}
    probe["embed"] = params["embed"]["table"][:64].clone()
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    state, records = launch_train.train_loop(
        model, opt, state, ShapeSpec("train_4k, batch cut", seq, TRAIN_BATCH, "train"),
        steps=TRAIN_STEPS, device=dev, log_every=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {k: v for k, v in _build.launches.items() if v}
    changed = {k: not torch.equal(v, (params["embed"]["table"][:64] if k == "embed" else
                                      params["stack_0"][k]["wo"][0, :64]))
               for k, v in probe.items()}
    check(len(records) == TRAIN_STEPS and all(
        math.isfinite(r.loss) and math.isfinite(r.grad_norm) for r in records),
        f"{name}: {TRAIN_STEPS} steps, loss and grad norm finite at every step "
        f"({[round(r.loss, 4) for r in records]}, {[round(r.grad_norm, 3) for r in records]})")
    check(all(changed.values()), f"{name}: the parameters changed ({changed})")
    check(not launched, f"{name}: no kernel of K1-K6 launched in the train steps "
          f"(counted: {launched or 'none'})")
    step_s = sum(r.seconds for r in records[1:]) / max(1, len(records) - 1)
    tokens = TRAIN_BATCH * seq
    attn_flops = 6 * TRAIN_BATCH * seq * seq * cfg.n_heads * cfg.head_dim * cfg.n_layers
    # the embedding table is a gather (its backward an index add), no product:
    # the share counts the parameters of the products alone (the untied
    # unembedding stays); 6 N tokens over every parameter is printed beside it
    n_embed = 0 if cfg.tie_embeddings else params["embed"]["table"].numel()
    model_flops = 6 * (n - n_embed) * tokens + attn_flops
    all_flops = 6 * n * tokens + attn_flops
    out |= {"losses": [r.loss for r in records], "grad_norms": [r.grad_norm for r in records],
            "step_s": [r.seconds for r in records], "ms_per_step": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "peak_gib": peak, "n_matmul_params": n - n_embed,
            "model_tflop_per_step": model_flops / 1e12,
            "all_params_tflop_per_step": all_flops / 1e12,
            "bf16_peak_share": model_flops / (step_s * BF16_OPS_PER_S),
            "bf16_peak_share_all_params": all_flops / (step_s * BF16_OPS_PER_S),
            "launches": launched, "steps_s": time.perf_counter() - t1}
    log(f"  (A) {step_s * 1e3:.0f} ms a step (steps 2-{TRAIN_STEPS}), "
        f"{tokens / step_s:,.0f} tokens/s, peak {peak:.1f} GiB, "
        f"{model_flops / 1e12:.0f} TFLOP a step (6 x {(n - n_embed) / 1e9:.2f} B parameters "
        f"in products x tokens + attention) = {out['bf16_peak_share']:.1%} of the bf16 peak "
        f"(989 TFLOP/s); with the embedding table counted, {all_flops / 1e12:.0f} TFLOP = "
        f"{out['bf16_peak_share_all_params']:.1%}; {gpu_name_power()}")

    # profiler: one train step (B 1, one microbatch) in 5 sessions, K1-K6 counted
    t1 = time.perf_counter()
    step1 = make_train_step(model, opt, microbatches=1)
    batch1 = make_batch(cfg, ShapeSpec("p", TRAIN_PROFILE_SEQ, 1, "train"), device=dev)
    holder = [state]

    def one_step():
        holder[0] = step1(holder[0], batch1)[0]

    events, _ = median_traced(one_step)  # no warm-up: the median drops a cold first session
    ours = _kernel_events(events)
    check(ours == 0, f"{name}: a train step's device kernels under the profiler (median of "
          f"{PROFILE_ROUNDS} sessions): {sum(c for c, _ in events.values())} kernels, {ours} "
          f"of K1-K6")
    out |= {"profiled_kernels": sum(c for c, _ in events.values()), "profiled_ours": ours,
            "profile_s": time.perf_counter() - t1, "part_s": time.perf_counter() - t0}
    del state, holder, params, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_argv(d, *extra) -> list:
    return ["--arch", "llama3-8b", "--smoke", "--steps", "6", "--batch", "8", "--seq", "32",
            "--ckpt-every", "2", "--log-every", "6", "--ckpt-dir", str(d), *extra]


def _same_state(a, b) -> bool:
    """Two train states equal leaf for leaf, bit for bit."""
    import torch

    from repro_torch.train import tree as tr

    la, lb = list(tr.leaves_with_paths(a)), list(tr.leaves_with_paths(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(la, lb))


def train_launcher(check) -> dict:
    """Phase 14 (B): ``repro_torch.launch.train`` on the card (the llama3-8b
    smoke config): 6 steps checkpointed every 2; the same with the fourth
    step (index 3) failing once, which rolls back to step 2; a ``--resume``
    from step 4's checkpoint; all three end bit for bit equal."""
    import tempfile

    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        want, records = launch_train.run(_train_argv(tmp / "a"))
        failed, rec_f = launch_train.run(_train_argv(tmp / "b"), fail_step=3)
        (tmp / "c" / "step_4").mkdir(parents=True)
        for f in (tmp / "a" / "step_4").iterdir():
            (tmp / "c" / "step_4" / f.name).write_bytes(f.read_bytes())
        resumed, rec_r = launch_train.run(_train_argv(tmp / "c", "--resume"))
    check(want.step == 6 and all(math.isfinite(r.loss) for r in records),
          f"the train CLI on the card: 6 steps, losses {[round(r.loss, 4) for r in records]}")
    check([r.step for r in rec_f] == [1, 2, 3, 3, 4, 5, 6] and _same_state(failed, want),
          "the train CLI: the fourth step failing once rolls back to step 2 and ends bit for "
          "bit equal to the uninterrupted run (params and optimizer state)")
    check([r.step for r in rec_r] == [5, 6] and _same_state(resumed, want),
          "the train CLI: --resume from step 4's checkpoint ends bit for bit equal")
    return {"losses": [r.loss for r in records], "part_s": time.perf_counter() - t0}


def train_families(check, dev) -> dict:
    """Phase 14 (C): every other family at its smoke config: the loss and
    its gradients on the card against the same code on the CPU (the
    parameters drawn once on the CPU), then one train step on the card with
    the family's own optimizer."""
    import torch

    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.zoo import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.train import tree as tr
    from repro_torch.train.step import TrainState, make_train_step, value_and_grad

    t0 = time.perf_counter()
    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = smoke_config(arch)
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        batch = make_batch(cfg, ShapeSpec("t", 32, 2, "train"), step=3, device="cpu")
        loss_c, g_c = value_and_grad(model.loss, cpu, batch)
        params = tr.map_leaves(lambda t: t.to(dev), cpu)
        on_card = {k: v.to(dev) for k, v in batch.items()}
        loss_g, g_g = value_and_grad(model.loss, params, on_card)
        loss_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        names = [".".join(map(str, path)) for path, _ in tr.leaves_with_paths(cpu)]
        gaps = {n: _rel_l2(a.cpu(), b) for n, a, b in zip(names, g_g, g_c)}
        named = dict(GRAD_WITNESSED).get(arch)
        witness = 0.0
        if named is not None:  # how far the named leaf moves under each nudge
            i = names.index(named)
            for every in GRAD_NUDGES:
                for ps, b, ref in ((params, on_card, g_g[i]), (cpu, batch, g_c[i])):
                    nudged = tr.map_leaves(lambda t: ulp_nudged(t, every), ps)
                    witness = max(witness, _rel_l2(value_and_grad(model.loss, nudged, b)[1][i],
                                                   ref))
        past = {n: g for n, g in gaps.items() if g > TRAIN_GRAD_REL_L2}
        grad_err = max(gaps.values())
        check(loss_err <= TRAIN_LOSS_RTOL and set(past) <= {named}
              and all(g <= GRAD_SPREAD * witness for g in past.values()),
              f"{arch} smoke: loss and gradients on the card vs the CPU (loss {loss_err:.1e} "
              f"relative, worst gradient {grad_err:.1e} relative L2; past "
              f"{TRAIN_GRAD_REL_L2:g}: " + (", ".join(f"{n} {g:.1e}" for n, g in past.items())
                                           or "none")
              + (f"; {named} held to its largest witness, {witness:.1e})" if named else ")"))
        opt = get_optimizer(cfg.optimizer)
        state, m = make_train_step(model, opt, microbatches=cfg.microbatches)(
            TrainState(params, opt.init(params), 0),
            make_batch(cfg, ShapeSpec("t", 32, 8, "train"), device=dev))
        ok = math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item())
        check(ok and state.step == 1, f"{arch} smoke: one train step with {cfg.optimizer}, "
              f"{cfg.microbatches} microbatches (loss {m['loss'].item():.4f}, grad norm "
              f"{m['grad_norm'].item():.3f})")
        out[arch] = {"loss_rel_err": loss_err, "grad_rel_l2": grad_err,
                     "past_bound": [{"leaf": n, "gap": g} for n, g in past.items()],
                     "witness": witness,
                     "optimizer": cfg.optimizer, "step_loss": m["loss"].item()}
    out["part_s"] = time.perf_counter() - t0
    return out


def train_phase(check, dev) -> dict:
    """Phase 14: training on one device, (A), (B) and (C); no kernel of
    K1-K6 launched anywhere in it."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    rep = {"A": train_full_width(check, dev)}
    log(f"  (A) took {rep['A']['part_s']:.1f} s: remat check {rep['A']['remat_check_s']:.1f} s "
        f"(the first microbatch, remat on, {rep['A']['remat_on_s']:.1f} s), "
        f"{TRAIN_STEPS} steps {rep['A']['steps_s']:.1f} s, profile {rep['A']['profile_s']:.1f} s")
    _build.launches.clear()
    rep["B"] = train_launcher(check)
    log(f"  (B) took {rep['B']['part_s']:.1f} s")
    rep["C"] = train_families(check, dev)
    log(f"  (C) took {rep['C']['part_s']:.1f} s")
    launched = {k: v for k, v in _build.launches.items() if v}
    check(not launched, f"phase 14 (B), (C): no kernel of K1-K6 launched ({launched or 'none'})")
    rep["phase_s"] = time.perf_counter() - t0
    log(f"  phase 14 took {rep['phase_s']:.1f} s")
    return rep


# ------------------------------------------------------------------ split-KV
SPLIT_RANKS = 4  # phase 2's windows and phase 13: the ranks of one split-KV walk
# phase 13 (A): llama3-8b's decode shape at the paper's long context, one row
# whose blocks end before the last rank's window (that rank reads the
# residual alone)
LONG_TOKENS, LONG_PB, LONG_RL = 131_072, [700], [77]
# phase 13 (B): the engine on four ranks, llama3-8b cut to 2 layers
SPLIT_ENGINE_LAYERS = 2
# phase 13's ranks start before phase 12 (B) (their imports and process
# group set up meanwhile) and wait at most this long for the go
SPLIT_RANKS_WAIT_S = 900


def splitkv_kernel_phase(check, stats, dev, gen, time_ms) -> None:
    """Phase 2's split-KV checks at llama3-8b's decode shapes (B 4, H_kv 8,
    g 4, d 128): K3's block window and K4's column window with ``page_lo``
    over SPLIT_RANKS ranks' windows against the same kernel over a
    contiguous copy of the window, bit for bit (rank 3's window holds no
    valid block of row 0); the four windows' partials merged against the
    whole call; K5's page range over a guard-filled pool (pages outside the
    range unchanged, pages inside bit for bit the whole pool's, residuals
    and lengths equal, the plain version bit for bit on one range); then
    the windowed calls timed beside the whole ones."""
    import torch

    from repro_torch.kernels.bitdecode import ops as bd_ops
    from repro_torch.kernels.kv_quant import ops as kq_ops
    from repro_torch.kernels.paged_bitdecode import ops as pg_ops
    from repro_torch.kernels.residual_flush import ops as rf_ops

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    b, h, g, d, bn, n = 4, 8, 4, 128, BLOCK_N, SPLIT_RANKS
    nb = -(-(max(PROMPT_LENS) + DECODE_STEPS) // bn)  # the dense loop's cache: 18 blocks
    nb_local = -(-nb // n)
    pb, rl = [14, 15, 16, 16], [108, 80, 2, 52]
    v_off = 2.0 * torch.randn(d, generator=gen, device=dev)
    packed = [*kq_ops.quantize_kv(randn(b, h, nb * bn, d), BITS, "channel", block_n=bn),
              *kq_ops.quantize_kv((randn(b, h, nb * bn, d) + v_off).to(torch.bfloat16), BITS,
                                  "tensor", block_n=bn)]
    q, res = randn(b, h, g, d), [randn(b, h, bn, d), (randn(b, h, bn, d) + v_off).to(
        torch.bfloat16)]
    pbt, rlt = ints(pb), ints(rl)
    kw = dict(bits=BITS, block_n=bn, k_gran="channel", return_lse=True, impl="cuda")

    def window_copy(arrays, lo):
        hi = min(nb, lo + nb_local)
        return [torch.cat([x[:, :, lo:hi], torch.zeros_like(x[:, :, :lo + nb_local - hi])],
                          dim=2).contiguous() for x in arrays]

    parts, same = [], []
    for r in range(n):
        lo, last = r * nb_local, r == n - 1
        got = bd_ops.bitdecode_attention(q, *packed, *res, pbt, rlt, block_lo=lo,
                                         n_blocks=nb_local, read_res=last, **kw)
        want = bd_ops.bitdecode_attention(q, *window_copy(packed, lo), *res,
                                          torch.clamp(pbt - lo, 0, nb_local),
                                          rlt if last else torch.zeros_like(rlt), **kw)
        same.append(bitwise(got[0], want[0]) and bitwise(got[1], want[1]))
        parts.append(got)
    check(all(same), f"bitdecode's block window over {n} ranks' windows of {nb} blocks equals "
                     f"the call over a contiguous copy bit for bit ({same})")
    merged = bd_ops.merge_cuda(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]))[0]
    whole = bd_ops.bitdecode_attention(q, *packed, *res, pbt, rlt, **kw)
    err = (merged - whole[0]).abs().max().item()
    check(torch.allclose(merged, whole[0], rtol=2e-2, atol=2e-2),
          f"bitdecode: the {n} windows' partials merged equal the whole call within out 2e-2 "
          f"(max |d| {err:.2e})")

    # K4: page-affine pools, column j of row b in page j * B + b (shard j // nb_local)
    nb_al = nb_local * n
    full = [torch.cat([x, torch.zeros_like(x[:, :, :nb_al - nb])], dim=2) for x in packed]
    pool = [x.movedim(2, 0).reshape(nb_al * b, *x.shape[1:2], *x.shape[3:]).contiguous()
            for x in full]  # page j * b + row
    table = (torch.arange(nb_al, device=dev)[None] * b + torch.arange(b, device=dev)[:, None]
             ).to(torch.int32)
    pp = nb_al * b // n
    same = []
    for r in range(n):
        lo, last, page_lo = r * nb_local, r == n - 1, r * pp
        local = [x[page_lo:page_lo + pp] for x in pool]
        got = pg_ops.paged_bitdecode_attention(q, *local, *res, table, pbt, rlt, block_lo=lo,
                                               n_blocks=nb_local, read_res=last,
                                               page_lo=page_lo, **kw)
        sub = torch.clamp(table[:, lo:lo + nb_local] - page_lo, 0, pp - 1).to(
            torch.int32).contiguous()
        want = pg_ops.paged_bitdecode_attention(
            q, *[x.clone() for x in local], *res, sub, torch.clamp(pbt - lo, 0, nb_local),
            rlt if last else torch.zeros_like(rlt), **kw)
        same.append(bitwise(got[0], want[0]) and bitwise(got[1], want[1]))
    check(all(same), f"paged_bitdecode's column window and page_lo over {n} ranks' page-affine "
                     f"pools equal the call over a copy of the sliced table bit for bit ({same})")

    # K5: the page range over a guard-filled pool, against the whole pool
    pages = nb_al * b
    guard = [torch.randint(-2**30, 2**30, x.shape, generator=gen, device=dev, dtype=x.dtype)
             if x.dtype == torch.int32 else randn(*x.shape) for x in pool]
    whole_a = [x.clone() for x in guard]
    ranged = [[x.clone() for x in guard] for _ in range(n)]
    plain = [x[pp:2 * pp].clone() for x in guard]
    res0 = [randn(b, h, bn, d) for _ in range(2)]
    start = [ints(pb), ints([5, 77, 120, 126])]

    def lens():
        return [x.clone() for x in start] + [ints([0] * b)]

    whole_l, ranged_l = lens(), [lens() for _ in range(n)]
    whole_r, ranged_r = [x.clone() for x in res0], [[x.clone() for x in res0] for _ in range(n)]
    plain_l, plain_r = lens(), [x.clone() for x in res0]
    fkw = dict(bits=BITS, block_n=bn, k_gran="channel")
    ok = True
    for step in range(2 * bn + 5):
        k_new, v_new = randn(b, 1, h, d).transpose(1, 2), randn(b, 1, h, d).transpose(1, 2)
        rf_ops.paged_append_flush(*whole_a, *whole_r, k_new, v_new, table, *whole_l,
                                  impl="cuda", **fkw)
        for r in range(n):
            rf_ops.paged_append_flush(*[x[r * pp:(r + 1) * pp] for x in ranged[r]],
                                      *ranged_r[r], k_new, v_new, table, *ranged_l[r],
                                      impl="cuda", page_lo=r * pp, pages_total=pages, **fkw)
        rf_ops.paged_append_flush(*plain, *plain_r, k_new, v_new, table, *plain_l,
                                  impl="torch", page_lo=pp, pages_total=pages, **fkw)
        for r in range(n):
            inside = slice(r * pp, (r + 1) * pp)
            ok &= all(bitwise(x[inside], y[inside]) for x, y in zip(ranged[r], whole_a))
            ok &= all(bitwise(torch.cat([x[:inside.start], x[inside.stop:]]),
                              torch.cat([y[:inside.start], y[inside.stop:]]))
                      for x, y in zip(ranged[r], guard))
            ok &= all(bitwise(x, y) for x, y in zip(ranged_r[r] + ranged_l[r],
                                                     whole_r + whole_l))
        ok &= all(bitwise(x, y[pp:2 * pp]) for x, y in zip(plain, ranged[1]))
        ok &= all(bitwise(x, y) for x, y in zip(plain_r + plain_l, whole_r + whole_l))
    flushed = (whole_l[0] - start[0]).tolist()
    check(ok and min(flushed) >= 2, f"paged_residual_flush's page range over {n} ranges of "
          f"{pp} pages: inside bit for bit the whole pool's, outside unchanged, residuals and "
          f"lengths equal, the plain version bit for bit, {2 * bn + 5} steps (flushes {flushed})")

    # the windowed calls beside the whole ones
    st, sp, sf = stats["bitdecode"], stats["paged_bitdecode"], stats["paged_residual_flush"]
    st["window_whole_ms"] = time_ms(lambda: bd_ops.bitdecode_attention(
        q, *packed, *res, pbt, rlt, **kw))
    st["window_ms"] = [time_ms(lambda r=r: bd_ops.bitdecode_attention(
        q, *packed, *res, pbt, rlt, block_lo=r * nb_local, n_blocks=nb_local,
        read_res=r == n - 1, **kw)) for r in range(n)]
    sp["window_whole_ms"] = time_ms(lambda: pg_ops.paged_bitdecode_attention(
        q, *pool, *res, table, pbt, rlt, **kw))
    sp["window_ms"] = [time_ms(lambda r=r: pg_ops.paged_bitdecode_attention(
        q, *[x[r * pp:(r + 1) * pp] for x in pool], *res, table, pbt, rlt,
        block_lo=r * nb_local, n_blocks=nb_local, read_res=r == n - 1, page_lo=r * pp, **kw))
        for r in range(n)]
    full_rl = ints([bn - 1] * b)  # every row flushes: reset on the card before each call

    def flush_prep(lens_):
        return lambda: (lens_[0].copy_(start[0]), lens_[1].copy_(full_rl))

    sf["window_whole_ms"] = time_ms(lambda: rf_ops.paged_append_flush(
        *whole_a, *whole_r, k_new, v_new, table, *whole_l, impl="cuda", **fkw),
        prep=flush_prep(whole_l))
    sf["window_ms"] = [time_ms(lambda r=r: rf_ops.paged_append_flush(
        *[x[r * pp:(r + 1) * pp] for x in ranged[r]], *ranged_r[r], k_new, v_new, table,
        *ranged_l[r], impl="cuda", page_lo=r * pp, pages_total=pages, **fkw),
        prep=flush_prep(ranged_l[r])) for r in range(n)]
    for name, s in (("bitdecode", st), ("paged_bitdecode", sp), ("paged_residual_flush", sf)):
        s["window_shape"] = dict(B=b, H_kv=h, g=g, d=d, nb=nb, ranks=n, nb_local=nb_local,
                                 pack_blocks=pb, res_len=rl)
        log(f"  time {name} split-KV windows of {n} ranks ({nb_local} of {nb} blocks"
            f"{'; pages ' + str(pp) + ' of ' + str(pages) if name != 'bitdecode' else ''}): "
            f"whole {s['window_whole_ms'] * 1e3:.1f} us, ranks "
            + ", ".join(f"{t * 1e3:.1f}" for t in s["window_ms"]) + " us"
            + (" (a step where every row flushes)" if name == "paged_residual_flush" else ""))


def one_rank_mesh():
    """A one-rank NCCL process group on the card and its 1-D mesh over axis
    "data" (what runs (l) and (m) walk split over)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    return init_device_mesh("cuda", (1,), mesh_dim_names=("data",))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def splitkv_serve_runs(model, params, cfg, check, dev, streams) -> dict:
    """Runs (l) and (m) of phase 4: run (e) (async runtime, two steps in
    flight) with a one-rank NCCL mesh and ``splitkv="always"``, (m) with
    page-affine pools as well: every decode step the split-KV step (its
    all-gather and the cross-rank merge captured in the graph), streams and
    terminal phases bit for bit run (e)'s (the merge of one partial is
    o * exp(0) / 1), no plain version called; launches counted as (e)'s."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.serve import ServeEngine

    work = serve_workload(cfg.vocab)
    e_kw = serve_runs(work)["e"]
    mesh = one_rank_mesh()
    out = {}
    for name, extra in (("l", {}), ("m", dict(page_affine=True))):
        t0 = time.perf_counter()
        engine = ServeEngine(model, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                             device=dev, mesh=mesh, splitkv="always", **e_kw, **extra)
        torch.cuda.synchronize()
        _build.launches.clear()
        with plain_calls() as plain:
            reqs, summ = drive_engine(engine, work)
        torch.cuda.synchronize()
        runner, step = engine._runner, engine._runner.step_fn
        total = dict(_build.launches)
        for k, v in step.launches.items():
            total[k] = total.get(k, 0) + v
        n = engine.spec.page_layers
        got = ({r.uid: list(r.out_tokens) for r in reqs}, {r.uid: r.phase for r in reqs})
        diff = [u for u in got[0] if (got[0][u], got[1][u]) != (streams["e"][0][u],
                                                              streams["e"][1][u])]
        check(not diff, f"run ({name}) token streams and terminal phases equal run (e)'s bit "
                        f"for bit (differ: {diff})")
        check(not plain, f"run ({name}): no plain kernel version ran ({dict(plain)})")
        check(step.graph is not None and step.replays == runner.dispatched == summ["steps"]
              == summ["splitkv_steps"] > 0 and step.splitkv is not None,
              f"run ({name}): every decode step one replay of the captured split-KV step "
              f"({summ['splitkv_steps']} split steps, {step.replays} replays)")
        check(all(step.capture_launches.get(k, 0) >= n for k in
                  ("paged_bitdecode", "paged_residual_flush", "bitdecode_merge"))
              and all(total.get(k, 0) > 0 for k in SERVE_PATH),
              f"run ({name}): the captured step launches K4, K5 and the merge once a layer "
              f"at least ({dict(step.capture_launches)}), every serve kernel launched")
        check(summ["pool_shards"] == (1 if not extra else dist.get_world_size()),
              f"run ({name}): pool_shards {summ['pool_shards']}")
        wall = time.perf_counter() - t0
        log(f"  run ({name}) = (e) + mesh of 1 rank, splitkv always{', page_affine' if extra else ''}"
            f": {summ['steps']} cycles, {summ['decoded_tokens']} tokens, "
            f"{summ['tokens_per_s']:.1f} tokens/s, TPOT p50 {summ['tpot_p50_ms']:.1f} ms, "
            f"split steps {summ['splitkv_steps']}, {wall:.1f} s with the engine's set-up; "
            f"capture {dict(step.capture_launches)}")
        out[name] = {k: summ[k] for k in ("steps", "decoded_tokens", "tokens_per_s",
                                          "tpot_p50_ms", "ttft_p50_ms", "splitkv_steps",
                                          "pool_shards", "wall_s")} | {
            "launches": total, "capture_launches": dict(step.capture_launches),
            "run_s": wall}
        engine.close()
        del engine
    dist.destroy_process_group()
    return out


def _time_alone(rank: int, world: int, fn, iters: int = 10) -> float:
    """ms of ``fn`` on the card (None: this rank times nothing), the ranks
    taking turns (the four ranks share one card): a barrier between turns,
    CUDA events around calls queued behind a spin kernel, so they bracket
    device work, not the host's launches."""
    import torch
    import torch.distributed as dist

    ms = 0.0
    for r in range(world):
        dist.barrier()
        if r == rank and fn is not None:
            fn()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)  # the host queues every call meanwhile
            e0.record()
            for _ in range(iters):
                fn()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / iters
    dist.barrier()
    return ms


def _time_together(fn, iters: int = 5) -> float:
    """ms of ``fn``, a collective every rank runs at once, on this rank's
    CUDA events: gloo stages a CUDA all-gather through the host, so the
    host's part is in it."""
    import torch
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def affine_schedule(model, params, cfg, dev, **kw) -> dict:
    """The JAX package's page-affine serving schedule (``tests/
    test_distributed.py``) at ``cfg.kv_block`` through ``ServeEngine(**kw)``,
    eager and sync: a donor of one block and 8 tokens, a strict mid-block
    prefix of it (copied on write at its first flush), a prompt of three
    blocks served twice (the second a retained prefix hit).  Without a mesh
    it also records the top logit and the top-2 gap of every step (what
    :func:`near_tie` reads)."""
    import numpy as np

    from repro_torch.serve import Request, ServeEngine

    bn = cfg.kv_block
    rng = np.random.default_rng(7)
    pa = rng.integers(0, cfg.vocab, bn + 8).astype(np.int32)
    pb = pa[:8].copy()
    pc = rng.integers(0, cfg.vocab, 3 * bn).astype(np.int32)
    eng = ServeEngine(model, params, slots=2, max_seq=8 * bn, retain_prefix=True, device=dev,
                      **kw)
    tops: dict = {}  # unsplit: uid -> (top logit, top-2 gap) a step
    if "mesh" not in kw:
        step = eng._step

        def recording(p, s, t):
            logits, s = step(p, s, t)
            for slot, req in eng.sched.active.items():
                top = logits[slot, 0].float().topk(2).values.tolist()
                tops.setdefault(req.uid, []).append((top[0], top[0] - top[1]))
            return logits, s

        eng._step = recording
    reqs = [Request(uid=0, prompt=pa.copy(), max_new_tokens=2 * bn),
            Request(uid=1, prompt=pb.copy(), max_new_tokens=bn)]
    eng.submit(reqs[0])
    eng.step()
    eng.submit(reqs[1])
    eng.run()
    for uid in (2, 3):  # the second a retained prefix hit
        reqs.append(Request(uid=uid, prompt=pc.copy(), max_new_tokens=4))
        eng.submit(reqs[-1])
        eng.run()
    summ = eng.summary()
    kwp = eng.state["caches"][0].kw
    eng.close()
    return {"out": [list(r.out_tokens) for r in reqs], "tops": tops, "cow": summ["cow_copies"],
            "splitkv_steps": summ["splitkv_steps"], "pool_shards": summ["pool_shards"],
            "retained_hits": eng.sched.stats["prefix_retained_hits"], "n_pages": eng.n_pages,
            "local_pages": kwp.shape[kwp.dim() - 4], "free": eng.pool.free_pages(),
            "steps": summ["steps"]}


def phase13_rank(rank: int, world: int, port: int, out: str) -> int:
    """One rank of phase 13 (a process of its own; the ranks share one card
    on gloo, whose all-gather takes CUDA tensors).  Started ahead of the
    phase: it sets up its process group and mesh, then waits for the file
    ``out/go`` before it touches the card.  (A) the split walk at
    llama3-8b's decode shape over 131,072 tokens, K3 over this rank's window
    of the dense cache and K4 over its column slice of rank-local
    page-affine pools, merged across the ranks, against one unsplit call;
    (B) JAX's page-affine serving schedule (:func:`affine_schedule`) on
    llama3-8b at full width, cut to 2 layers, split over replicated and over
    page-affine pools (the unsplit run is the main process's).  Writes its
    results to ``out/rank<r>.json``."""
    import hashlib

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import attention as catt
    from repro_torch.core import qcache
    from repro_torch.dist import splitkv as sk
    from repro_torch.dist import state_specs
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitdecode import ops as bd_ops
    from repro_torch.kernels.kv_quant import ops as kq_ops
    from repro_torch.kernels.paged_bitdecode import ops as pg_ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    res: dict = {"rank": rank}
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        go, t_wait = Path(out) / "go", time.perf_counter()
        while not go.exists():
            if time.perf_counter() - t_wait > SPLIT_RANKS_WAIT_S:
                raise TimeoutError(f"no go from the main process in {SPLIT_RANKS_WAIT_S} s")
            time.sleep(0.05)
        t0 = time.perf_counter()
        # ---- (A) the walk
        gen = torch.Generator(device=dev).manual_seed(13)  # the same data on every rank
        b, h, g, d, bn = 1, 8, 4, 128, BLOCK_N
        nb = LONG_TOKENS // bn
        v_off = 2.0 * torch.randn(d, generator=gen, device=dev)

        def randn(*shape, off=None):
            x = torch.randn(shape, generator=gen, device=dev)
            return (x if off is None else x + off).to(torch.bfloat16)

        with torch.no_grad():
            kw_, ks, kz = kq_ops.quantize_kv(randn(b, h, nb * bn, d), BITS, "channel",
                                             block_n=bn)
            vw, vs, vz = kq_ops.quantize_kv(randn(b, h, nb * bn, d, off=v_off), BITS, "tensor",
                                            block_n=bn)
            q = randn(b, 1, h * g, d)
            k_res, v_res = randn(b, h, bn, d), randn(b, h, bn, d, off=v_off)
            ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
            cache = qcache.QuantKVCache(kw_, ks, kz, vw, vs, vz, k_res, v_res, ints(LONG_PB),
                                        ints(LONG_RL), ints([0]), bits=BITS, block_n=bn,
                                        k_gran="channel")
            torch.cuda.synchronize()
            _build.launches.clear()
            split = sk.splitkv_decode_attention(q, cache, mesh)
            whole = catt.decode_attention(q, cache)
            res["dense_err"] = (split - whole).abs().max().item()
            res["dense_ok"] = bool(torch.allclose(split, whole, rtol=2e-2, atol=2e-2))
            # the paged walk: page j holds block j (one row), the pools cut to
            # this rank's range by the placements' helper
            pools = [x[0].movedim(1, 0).contiguous() for x in (kw_, ks, kz, vw, vs, vz)]
            paged = qcache.PagedQuantKVCache(
                *pools, k_res, v_res, torch.arange(nb, dtype=torch.int32, device=dev)[None],
                ints(LONG_PB), ints(LONG_RL), ints([0]), bits=BITS, block_n=bn,
                k_gran="channel")
            specs = {"caches": [dataclasses.replace(paged, **{
                f: state_specs.to_placements(("data",), mesh) for f in qcache._PAGED_POOL_FIELDS})]}
            local = state_specs.local_pools({"caches": [paged]}, specs, mesh, "data")["caches"][0]
            res["local_pages"] = local.n_pages
            psplit = sk.splitkv_paged_decode_attention(q, local, mesh, page_affine=True)
            pwhole = catt.decode_attention(q, paged)
            res["paged_err"] = (psplit - pwhole).abs().max().item()
            res["paged_ok"] = bool(torch.allclose(psplit, pwhole, rtol=2e-2, atol=2e-2))
            res["ranks_bitwise"] = [hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
                                    for x in (split, psplit)]
            res["walk_launches"] = dict(_build.launches)
            nb_local = -(-nb // world)
            qt = catt.query_transform(q, h)
            win = dict(block_lo=rank * nb_local, n_blocks=nb_local, read_res=rank == world - 1,
                       return_lse=True)
            fields = (kw_, ks, kz, vw, vs, vz, k_res, v_res, cache.pack_blocks, cache.res_len)
            kwk = dict(bits=BITS, block_n=bn, k_gran="channel")
            res["window_ms"] = _time_alone(rank, world, lambda: bd_ops.bitdecode_attention(
                qt, *fields, **kwk, **win))
            res["whole_ms"] = _time_alone(rank, world, (lambda: bd_ops.bitdecode_attention(
                qt, *fields, **kwk)) if rank == 0 else None)
            lp = (*[getattr(local, f) for f in qcache._PAGED_POOL_FIELDS], k_res, v_res,
                  paged.page_table, paged.pack_blocks, paged.res_len)
            res["paged_window_ms"] = _time_alone(rank, world, lambda: pg_ops.paged_bitdecode_attention(
                qt, *lp, page_lo=local.page_lo, **kwk, **win))
            res["split_call_ms"] = _time_together(lambda: sk.splitkv_decode_attention(
                q, cache, mesh))
            res["walk_s"] = time.perf_counter() - t0
            del kw_, ks, kz, vw, vs, vz, cache, paged, local, pools, fields, lp
            torch.cuda.empty_cache()

        # ---- (B) the engine: JAX's page-affine schedule at kv_block 128
        t1 = time.perf_counter()
        cfg, model, params, _ = build_random("llama3-8b", dev, n_layers=SPLIT_ENGINE_LAYERS)
        with torch.no_grad():
            _build.launches.clear()
            with plain_calls() as plain:
                res["sk"] = affine_schedule(model, params, cfg, dev, mesh=mesh,
                                            splitkv="always")
                res["aff"] = affine_schedule(model, params, cfg, dev, mesh=mesh,
                                             splitkv="always", page_affine=True)
            res["plain_calls"] = dict(plain)
            res["engine_launches"] = dict(_build.launches)
        res["engine_s"] = time.perf_counter() - t1
        res["ok"] = True
    except Exception as err:  # the parent fails the phase on it
        import traceback

        res["ok"] = False
        res["error"] = traceback.format_exc()[-4000:]
    finally:
        (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()
    return 0 if res["ok"] else 1


def near_tie(got: list, want: list, tops: list):
    """None when ``got`` equals ``want``; else (index, top logit, gap) of the
    first difference if the unsplit engine chose that token at a near tie
    (its top two logits within two bf16 ulps of the top: the split walk's
    other summation order may turn it, and the histories part after it),
    and False if not.  Token 0 is the prefill's, never split."""
    import math

    for k, (g, w) in enumerate(zip(got, want)):
        if g != w:
            if k == 0:
                return False
            top, gap = tops[k - 1]
            ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
            return (k, top, gap) if gap <= 2 * ulp else False
    return None if len(got) == len(want) else False


class SplitRanks:
    """Phase 13's SPLIT_RANKS rank processes (``chip_smoke.py --rank r``),
    started ahead of the phase: they wait for :meth:`go` before they touch
    the card.  :meth:`close` stops any still running (also at exit)."""

    def __init__(self):
        import atexit
        import tempfile

        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world",
             str(SPLIT_RANKS), "--port", str(port), "--out", self.tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(SPLIT_RANKS)]
        atexit.register(self.close)

    def go(self) -> None:
        (Path(self.tmp) / "go").write_text("go")

    def wait(self, timeout: float) -> list | None:
        """Each rank's results, or None if one did not finish in time."""
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            self.close()
            return None
        ranks = []
        for r, p in enumerate(self.procs):
            f = Path(self.tmp) / f"rank{r}.json"
            got = json.loads(f.read_text()) if f.exists() else {"ok": False}
            if not got.get("ok"):
                log(f"  rank {r} failed (exit {p.returncode}):\n{got.get('error', '')}\n"
                    f"{logs[r][-3000:]}")
            ranks.append(got)
        return ranks

    def close(self) -> None:
        import shutil

        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def splitkv_ranks_phase(check, job: SplitRanks, dev) -> dict:
    """Phase 13 on the ranks of ``job``: first the unsplit engine of (B) here
    (llama3-8b cut to SPLIT_ENGINE_LAYERS layers), then the go.  Every rank
    must finish; a rank that fails fails the phase.  (A) the merged walks
    within K3's output tolerance of one unsplit call, every rank's merged
    bits the same; (B) the page-affine streams bit for bit the
    replicated-pool split walk's, the short requests the unsplit engine's
    but for near ties, one copy on write, split steps, a retained prefix
    hit, four pool shards, each rank's pools a quarter of the pages, every
    rank's streams and free lists rank 0's."""
    import torch

    t0 = time.perf_counter()
    n = SPLIT_RANKS
    cfg, model, params, _ = build_random("llama3-8b", dev, n_layers=SPLIT_ENGINE_LAYERS)
    with torch.no_grad(), plain_calls() as plain:
        base = affine_schedule(model, params, cfg, dev)
    check(not plain, f"phase 13 (B): the unsplit engine called no plain kernel version "
                     f"({dict(plain)})")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t_base = time.perf_counter() - t0
    job.go()
    ranks = job.wait(timeout=300)
    if ranks is None:
        check(False, "phase 13: a rank did not finish within 300 s")
        return {}
    job.close()
    ok = all(r.get("ok") for r in ranks)
    check(ok, f"phase 13: all {n} ranks finished ({[r.get('ok') for r in ranks]})")
    if not ok:
        return {"ranks": ranks}
    r0 = ranks[0]
    check(all(r["dense_ok"] and r["paged_ok"] for r in ranks),
          f"phase 13 (A): the {n}-rank split walks (K3 window, K4 page-affine slice, the "
          f"cross-rank merge) within out 2e-2 of the unsplit call (max |d| dense "
          f"{max(r['dense_err'] for r in ranks):.2e}, paged {max(r['paged_err'] for r in ranks):.2e})")
    check(all(r["ranks_bitwise"] == r0["ranks_bitwise"] for r in ranks)
          and all(r["local_pages"] == LONG_TOKENS // BLOCK_N // n for r in ranks),
          f"phase 13 (A): every rank's merged output the same, each rank's pools "
          f"{r0['local_pages']} pages")
    skr, aff = r0["sk"], r0["aff"]
    check(aff["out"] == skr["out"], "phase 13 (B): page-affine streams equal the "
          "replicated-pool split walk's bit for bit")
    ties = [near_tie(aff["out"][u], base["out"][u], base["tops"][u]) for u in (1, 2, 3)]
    check(all(t is not False for t in ties) and sum(t is not None for t in ties) <= 1,
          f"phase 13 (B): the short requests equal the unsplit engine's but for a near tie "
          f"(first difference, the unsplit step's top logit and top-2 gap: {ties})")
    check(aff["cow"] == 1 and base["cow"] == 1 and aff["splitkv_steps"] > 0
          and aff["retained_hits"] > 0 and aff["pool_shards"] == n
          and all(r["aff"]["local_pages"] == aff["n_pages"] // n for r in ranks),
          f"phase 13 (B): cow {aff['cow']}, split steps {aff['splitkv_steps']}, retained hits "
          f"{aff['retained_hits']}, pool shards {aff['pool_shards']}, each rank's pools "
          f"{[r['aff']['local_pages'] for r in ranks]} of {aff['n_pages']} pages")
    check(all(r[k] == r0[k] for r in ranks for k in ("sk", "aff")),
          "phase 13 (B): every rank's streams and free lists equal rank 0's")
    check(not any(r["plain_calls"] for r in ranks), "phase 13 (B): no plain kernel version ran")
    wall = time.perf_counter() - t0
    log(f"  phase 13 (A) llama3-8b decode, B 1, H_kv 8, g 4, d 128, {LONG_TOKENS} tokens "
        f"(pack_blocks {LONG_PB}, res_len {LONG_RL}): whole K3 call "
        f"{r0['whole_ms'] * 1e3:.1f} us; each rank's window "
        + ", ".join(f"{r['window_ms'] * 1e3:.1f}" for r in ranks) + " us (K3), "
        + ", ".join(f"{r['paged_window_ms'] * 1e3:.1f}" for r in ranks) + " us (K4 over "
        "its own pages); the split call with the gloo all-gather (through the host) and "
        "merge "
        + ", ".join(f"{r['split_call_ms'] * 1e3:.1f}" for r in ranks) + " us; max |d| dense "
        f"{max(r['dense_err'] for r in ranks):.2e}, paged {max(r['paged_err'] for r in ranks):.2e}")
    log(f"  phase 13 (B) llama3-8b cut to {SPLIT_ENGINE_LAYERS} layers on {n} ranks: "
        f"streams {[len(o) for o in aff['out']]} tokens, cow {aff['cow']}, split steps "
        f"{aff['splitkv_steps']}, retained hits {aff['retained_hits']}, pool shards "
        f"{aff['pool_shards']}, pages a rank {aff['local_pages']} of {aff['n_pages']}; the "
        f"unsplit engine here {t_base:.1f} s, the split ones {max(r['engine_s'] for r in ranks):.1f}"
        f" s a rank; phase 13 took {wall:.1f} s")
    return {"ranks": [{k: v for k, v in r.items() if k != "sk"} for r in ranks],
            "base": {k: v for k, v in base.items() if k != "tops"}, "wall_s": wall}


SASS_SPECS = ((("HGMMA", "UTMALDG"), "flash_prefill"),
              (("HMMA", "LDGSTS", "MOVM"), "bitdecode_kernel"))


class SassJob:
    """``_build.sass_counts_many(SASS_SPECS)`` of the built library in a
    child process (started at once, read by :meth:`result`; killed at exit
    if still running)."""

    def __init__(self, library: str):
        import atexit

        code = ("import json, sys, time; t = time.perf_counter(); sys.path.insert(0, sys.argv[1]); "
                "from repro_torch.kernels import _build; "
                "r = _build.sass_counts_many(json.loads(sys.argv[3]), sys.argv[2]); "
                "print(json.dumps({'counts': r, 'seconds': time.perf_counter() - t}))")
        self.proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT / "src"), library,
                                      json.dumps(SASS_SPECS)], stdout=subprocess.PIPE, text=True)
        atexit.register(self.proc.kill)

    def result(self) -> dict:
        out, _ = self.proc.communicate()
        if self.proc.returncode:
            raise RuntimeError(f"the SASS count failed (exit {self.proc.returncode})")
        return json.loads(out)


def sass_checks(check, job: SassJob, flash_instances: int) -> None:
    """Phase 1's checks on the SASS counts of :class:`SassJob`."""
    rep = job.result()
    log(f"  (phase 1's SASS counts, one cuobjdump beside phase 2: {rep['seconds']:.1f} s)")
    if rep["counts"] is None:
        log("  cuobjdump: not available (no HGMMA / UTMALDG / HMMA / LDGSTS count)")
        return
    sass, decode = rep["counts"]
    for fn, cnt in sass.items():
        log(f"  sass {fn[:40]}...: HGMMA {cnt['HGMMA']}, UTMALDG {cnt['UTMALDG']}")
    check(len(sass) == flash_instances
          and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in sass.values()),
          f"every flash_prefill instance ({len(sass)}) runs wgmma (HGMMA) on TMA loads "
          "(UTMALDG)")
    for fn, cnt in decode.items():
        if any(f"ILi4ELi4ELi{d}ELi{d}ELi1ELb1E" in fn for d in (112, 128, 256)):
            log(f"  sass {fn[:48]}...: HMMA {cnt['HMMA']}, LDGSTS {cnt['LDGSTS']}, "
                f"MOVM {cnt['MOVM']}")
    check(len(decode) == DECODE_INSTANCES
          and all(c["HMMA"] > 0 and c["LDGSTS"] > 0 for c in decode.values()),
          f"every bitdecode / paged_bitdecode instance ({len(decode)} of {DECODE_INSTANCES}) "
          "runs mma.sync (HMMA) on words prefetched by cp.async (LDGSTS)")


def jax_init_witness(dev) -> int:
    """Full-width llama3-8b at the JAX package's init scales: the plain path
    split one way and three ways, and the kernels, over WITNESS_STEPS steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.params import P, init_tree
    from repro_torch.models.zoo import build_model

    def jax_scales(defs):
        if isinstance(defs, P):
            return dataclasses.replace(defs, fan_in=None)
        return {k: jax_scales(v) for k, v in defs.items()}

    cfg = get_config("llama3-8b").with_(kv_bits=BITS, kv_block=BLOCK_N, kv_gran="channel")
    model = build_model(cfg)
    params = init_tree(jax_scales(model.param_defs()),
                       torch.Generator(device=dev).manual_seed(0), dev)
    tokens, lengths = model_inputs(cfg, dev)
    with torch.no_grad():
        ref, *_ = decode_run(model, params, tokens, lengths, WITNESS_STEPS, "torch",
                             num_splits=1)
        feed = list(ref[:-1].argmax(-1)[:, :, None])
        runs = {name: decode_run(model, params, tokens, lengths, WITNESS_STEPS, impl,
                                 num_splits=ns, feed=feed)[0]
                for name, impl, ns in (("plain_split3", "torch", 3),
                                       ("kernels", "auto", "auto"))}
    result = {}
    for name, lg in runs.items():
        result[name] = {**fidelity(ref[1:], lg[1:]),
                        "first_step_max_abs_dlogit": (lg[1] - ref[1]).abs().max().item(),
                        "prefill_max_abs_dlogit": (lg[0] - ref[0]).abs().max().item()}
        log(f"  JAX init scales, {name} vs plain over {WITNESS_STEPS} decode steps: {result[name]}")
    print(json.dumps({"jax_init_witness": result, "decode_steps": WITNESS_STEPS,
                      "prompt_lens": PROMPT_LENS}), flush=True)
    print(gpu_name_power(), flush=True)
    return 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--jax-init", action="store_true",
                        help="run the init-scale witness instead of the smoke phases")
    # phase 13 starts the script again once a rank with these
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=SPLIT_RANKS, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.rank is not None:
        return phase13_rank(args.rank, args.world, args.port, args.out)

    from repro_torch.core import attention as catt
    from repro_torch.core import qcache
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitdecode import ops as bd_ops
    from repro_torch.kernels.bitdecode import ref as bd_ref
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.kv_quant import ops as kq_ops
    from repro_torch.kernels.paged_bitdecode import ops as pg_ops
    from repro_torch.kernels.residual_flush import ops as rf_ops
    from repro_torch.kernels.residual_flush import ref as rf_ref
    from repro_torch.models.zoo import build_model

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    check = Checks()
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}

    # ------------------------------------------------------------ 1. device
    log("== 1. device")
    power = gpu_name_power()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"  {power}; {sms} SMs; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build()
    log(f"  kernels built in {_build.build_seconds:.1f} s (nvcc, sm_90a)")
    decode_regs = {}  # bitdecode instance -> (registers, spill bytes)
    entry = None
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        if entry and "bitdecode_kernel" in entry:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            if regs:
                decode_regs[entry] = (int(regs.group(1)), decode_regs.get(entry, (0, 0))[1])
            if spill:
                decode_regs[entry] = (decode_regs.get(entry, (0, 0))[0], int(spill.group(1)))
            if "Used" in line and any(f"ILi4ELi4ELi{dk}ELi{dv}ELi{nt}ELb1E" in entry
                                      for dk, dv, nt in ((128, 128, 1), (256, 256, 1),
                                                         (128, 128, 2), (576, 128, 2),
                                                         (112, 112, 1))):
                log(f"  ptxas: {entry[:48]}...: {line.split(':', 1)[-1].strip()}")
        elif "Compiling entry" in line or "Used" in line or "spill" in line or "C75" in line:
            log(f"  ptxas: {line.strip()}")
    if decode_regs:
        spilled = sorted(e for e, (_, sp) in decode_regs.items() if sp)
        log(f"  ptxas: {len(decode_regs)} bitdecode / paged_bitdecode instances, "
            f"{min(r for r, _ in decode_regs.values())}-{max(r for r, _ in decode_regs.values())} "
            f"registers; spills in {len(spilled)} ({', '.join(e[:48] for e in spilled)})")
    for d in fp_ops.HEAD_DIMS:
        log(f"  flash_prefill d={d}: {_build.build().flash_prefill_smem_bytes(d)} bytes of "
            "dynamic shared memory a CTA")
    # the SASS counts (one cuobjdump of the library, ~40 s) run in a child
    # process beside phase 2; their checks follow it
    sass_job = SassJob(_build.build()._name)
    if args.jax_init:
        sass_checks(check, sass_job, len(fp_ops.HEAD_DIMS))
        return jax_init_witness(dev)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def note_err(name, a, b):
        err = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)

    # --------------------------------------------- 2. kernels vs plain versions
    log(f"== 2. kernels vs plain versions (at {time.perf_counter() - t_start:.1f} s)")
    # (B, H, S, d, block_n): the main path's K/V at prefill, the smoke model's,
    # and every other cache width of the configs (zamba2-7b's 112, the MLA
    # latents 160 and 576, gemma-7b's 256), as the model's strided views
    for b, h, s, d, bn in KV_QUANT_CASES:
        for bits in (2, 4, 8):
            for gran in ("channel", "tensor"):
                x = randn(b, s, h, d).transpose(1, 2)
                out = kq_ops.quantize_kv(x, bits, gran, block_n=bn, impl="cuda")
                ref = kq_ops.quantize_kv(x, bits, gran, block_n=bn, impl="torch")
                for o, r in zip(out, ref):
                    note_err("kv_quant", o, r)
                check(all(bitwise(o, r) for o, r in zip(out, ref)),
                      f"kv_quant bitwise B={b} H={h} S={s} d={d} block_n={bn} bits={bits} {gran}")
        # the pair (K and V in one launch) into the first blocks of a cache,
        # against the plain pair; the guard blocks past them unchanged
        fails = []
        for bits in (2, 4, 8):
            for gran in ("channel", "tensor"):
                k = randn(b, s, h, d).transpose(1, 2)
                v = randn(b, s, 2 * h, d)[:, :, h:].transpose(1, 2)
                cache = qcache.init_cache(b, h, d, s + 2 * bn, bits=bits, block_n=bn,
                                          k_gran=gran, device=dev)
                fields = [getattr(cache, f) for f in ("kw", "k_scale", "k_zero", "vw",
                                                      "v_scale", "v_zero")]
                for x in fields:  # guard contents: anything but zeros
                    x.copy_(torch.randint(-2**30, 2**30, x.shape, generator=gen, device=dev)
                            if x.dtype == torch.int32 else randn(*x.shape))
                twin, before = [x.clone() for x in fields], [x.clone() for x in fields]
                n_full = s // bn
                for arrays, impl in ((fields, "cuda"), (twin, "torch")):
                    heads = [x[:, :, :n_full] for x in arrays]
                    kq_ops.quantize_kv_pair(k, v, bits, gran, block_n=bn, out_k=heads[:3],
                                            out_v=heads[3:], impl=impl)
                for o, r in zip(fields, twin):
                    note_err("kv_quant", o, r)
                if not (all(bitwise(o, r) for o, r in zip(fields, twin)) and all(
                        bitwise(o[:, :, n_full:], b0[:, :, n_full:])
                        for o, b0 in zip(fields, before))):
                    fails.append((bits, gran))
        check(not fails, f"kv_quant pair into a cache bitwise B={b} H={h} S={s} d={d} "
                         f"block_n={bn}, bits 2/4/8 x both K granularities, guard blocks "
                         f"unchanged (failed: {fails})")

    for b, h, nb, d, bn in ((4, 8, 18, 128, 128), (4, 2, 3, 32, 64),
                            (4, ZAMBA_KV[0], 17, ZAMBA_KV[1], 128)):
        for bits in (2, 4, 8):
            for gran in ("channel", "tensor"):
                k = randn(b, h, nb * bn, d)
                v = randn(b, h, nb * bn, d)
                args = [*kq_ops.quantize_kv(k, bits, gran, block_n=bn, impl="torch"),
                        *kq_ops.quantize_kv(v, bits, "tensor", block_n=bn, impl="torch"),
                        randn(b, h, bn, d), randn(b, h, bn, d),
                        ints([1, 0, 1, 1]), ints([nb - 1, 0, nb + 5, 1])]  # nb + 5 clamps
                twin = [a.clone() for a in args]
                kw = dict(bits=bits, block_n=bn, k_gran=gran)
                out = rf_ops.residual_flush(*args, impl="cuda", **kw)
                ref = rf_ops.residual_flush(*twin, impl="torch", **kw)
                for o, r in zip(out, ref):
                    note_err("residual_flush", o, r)
                check(all(bitwise(o, r) for o, r in zip(out, ref)),
                      f"residual_flush bitwise B={b} H={h} nb={nb} d={d} block_n={bn} "
                      f"bits={bits} {gran}, mixed full, dest past nb-1")

    def decode_case(b, h, g, d, nb, bn, bits, gran, pb, rl, q_scale=1.0):
        # per-channel V offsets keep the output O(1), so the 2e-2 tolerance
        # is small beside it and a fault on the PV side (a missed rescale, a
        # wrong dequant) shows; q_scale > 1 puts the scores in the hundreds
        v_off = 2.0 * torch.randn(d, generator=gen, device=dev)
        kw_ = kq_ops.quantize_kv(randn(b, h, nb * bn, d), bits, gran, block_n=bn, impl="cuda")
        vw_ = kq_ops.quantize_kv((randn(b, h, nb * bn, d) + v_off).to(torch.bfloat16), bits,
                                 "tensor", block_n=bn, impl="cuda")
        return dict(q=(randn(b, h, g, d) * q_scale).to(torch.bfloat16), kw=kw_[0],
                    k_scale=kw_[1], k_zero=kw_[2], vw=vw_[0], v_scale=vw_[1], v_zero=vw_[2],
                    k_res=randn(b, h, bn, d), v_res=(randn(b, h, bn, d) + v_off).to(torch.bfloat16),
                    pack_blocks=ints(pb), res_len=ints(rl))

    def splits_of(ns, b, h, g, d, nb, bn, bits, gran="channel"):
        units = bd_ops.work_units(nb, bn, bits, bn)
        return bd_ops.resolve_num_splits(ns, b, h, units, dev, g=g, d=d, block_n=bn, bits=bits,
                                         k_channel=gran == "channel")

    def decode_close(name, what, got, ref, pb, rl):
        """Rows with a valid token within out 2e-2 / lse 1e-3 of the plain
        version; a row with none (pack_blocks 0, res_len 0) o = 0 and lse
        ~ -1e37, as an empty split (the plain version has no defined value
        there: a uniform softmax over masked slots).  Returns (ok, what)."""
        (out_k, lse_k), (out_r, lse_r) = got, ref
        live = torch.tensor([p > 0 or r > 0 for p, r in zip(pb, rl)], device=dev)
        note_err(name, out_k[live], out_r[live])
        ok = (torch.allclose(out_k[live], out_r[live], rtol=2e-2, atol=2e-2)
              and torch.allclose(lse_k[live], lse_r[live], rtol=1e-3, atol=1e-3)
              and not out_k[~live].any() and bool((lse_k[~live] < -1e36).all()))
        empty = int((~live).sum())
        return ok, (f"{name} {what}: max|dout| "
                    f"{(out_k[live] - out_r[live]).abs().max().item():.2e} (max|out| "
                    f"{out_r[live].abs().max().item():.2f}), max|dlse| "
                    f"{(lse_k[live] - lse_r[live]).abs().max().item():.2e}"
                    + (f"; {empty} empty row(s): o = 0, lse < -1e36" if empty else ""))

    def check_decode(name, what, got, ref, pb, rl):
        check(*decode_close(name, what, got, ref, pb, rl))

    # B, H_kv, g, d, nb, block_n, bits, K granularity, pack_blocks, res_len
    llama = (4, 8, 4, 128, 18, 128, 4, "channel", [14, 15, 16, 16], [108, 80, 2, 52])
    gemma = (4, 16, 1, 256, 11, 128, 4, "channel", [8, 8, 9, 9], [104, 56, 126, 48])
    starcoder = (4, 2, 12, 128, 11, 128, 4, "channel", [8, 8, 9, 9], [104, 56, 126, 48])
    qwen3 = (4, 4, 16, 128, 11, 128, 4, "channel", [8, 8, 9, 9], [104, 56, 126, 48])
    decode_cases = [  # label, case args, split counts
        ("B=4 4K ctx", (4, 8, 4, 128, 32, 128, 4, "channel", [32, 31, 30, 32], [5, 127, 64, 0]),
         (1, 3, "auto")),
        ("smoke d=32 bits=2 tensor-K", (2, 2, 2, 32, 4, 64, 2, "tensor", [4, 3], [37, 1]),
         (1, 3, "auto")),
        ("empty split, res_len 0, pack_blocks 0", (2, 8, 4, 128, 4, 128, 8, "channel",
                                                   [0, 1], [9, 0]), (1, 3)),
        ("B=1 32K ctx", (1, 8, 4, 128, 256, 128, 4, "channel", [256], [77]), (1, "auto")),
        ("B=4 4K ctx, scores in the hundreds", (4, 8, 4, 128, 32, 128, 4, "channel",
                                                [32, 31, 30, 32], [5, 127, 64, 0], 256.0),
         (1, 3, "auto")),
        ("llama3-8b decode shape", llama, (1, 3, "auto")),
        ("gemma-7b decode shape g=1 d=256", gemma, (1, 3, "auto")),
        ("starcoder2-3b decode shape g=12", starcoder, (1, 3, "auto")),
        ("qwen3-moe-235b-a22b decode shape g=16", qwen3, (1, 3, "auto")),
        ("command-r-35b g=8", (4, 8, 8, 128, 18, 128, 4, "channel", [14, 15, 16, 16],
                               [108, 80, 2, 52]), (1, "auto")),
        ("qwen2-vl-7b decode shape g=7", (4, 4, 7, 128, 16, 128, 4, "channel", VLM_PB, VLM_RL),
         (1, 3, "auto")),
        ("seamless-m4t-medium static cross read g=1 d=64, empty residual",
         (4, 16, 1, 64, 32, 128, 4, "channel", CROSS_PB, CROSS_RL), (1, 3, "auto")),
        ("bits=2 block_n=64", (2, 4, 4, 64, 8, 64, 2, "tensor", [8, 5], [17, 64]), (1, 3, "auto")),
        ("bits=8 block_n=64", (2, 4, 2, 128, 8, 64, 8, "channel", [6, 8], [64, 3]),
         (1, 3, "auto")),
        ("bits=4 block_n=32", (2, 4, 4, 64, 12, 32, 4, "channel", [12, 7], [31, 16]), (1, 3)),
        ("fewer blocks than splits, pack_blocks 0 with res_len 0, full residuals",
         (4, 8, 4, 128, 18, 128, 4, "channel", [1, 0, 2, 16], [0, 0, 128, 128]), (1, 3, 16, "auto")),
    ]
    for label, args, splits in decode_cases:
        case = decode_case(*args)
        kw = dict(bits=args[6], block_n=args[5], k_gran=args[7], return_lse=True)
        ref = bd_ops.bitdecode_attention(**case, impl="torch", num_splits=1, **kw)
        for ns in splits:
            resolved = splits_of(ns, *args[:8])
            got = bd_ops.bitdecode_attention(**case, impl="cuda", num_splits=ns, **kw)
            check_decode("bitdecode", f"{label} num_splits={ns} (->{resolved})", got, ref,
                         args[8], args[9])

    def pools_of(case, fields=("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")):
        """The case's dense [B, H, nb, ...] fields as pools [B * nb, H, ...]:
        row b's block j is page b * nb + j."""
        return [case[f].movedim(2, 1).reshape(-1, *case[f].shape[1:2], *case[f].shape[3:])
                .contiguous() for f in fields]

    def pools_of_latent(case):  # a shared_kv latent: K's fields alone
        return pools_of(case, ("kw", "k_scale", "k_zero"))

    serve_lens = ([10, 20, 7, 13], [100, 60, 30, 90])
    paged_cases = [  # label, case args, table, split counts
        ("serve shapes", (4, 8, 4, 128, 32, 128, 4, "channel", [14, 20, 0, 32], [5, 127, 128, 0]),
         "scrambled", (1, 2, 5, 16, "auto")),
        ("serve shapes", (4, 8, 4, 128, 32, 128, 4, "channel", [14, 20, 0, 32], [5, 127, 128, 0]),
         "identity", (1, "auto")),
        ("bits=2 tensor-K", (4, 8, 4, 128, 8, 128, 2, "tensor", [8, 3, 0, 5], [0, 64, 17, 128]),
         "scrambled", (1, 3, "auto")),
        ("bits=8", (2, 8, 4, 128, 16, 128, 8, "channel", [16, 9], [77, 0]), "scrambled",
         (1, 4, 16)),
        ("smoke d=32 bits=4 tensor-K", (2, 2, 2, 32, 6, 64, 4, "tensor", [6, 0], [64, 33]),
         "scrambled", (1, 3, "auto")),
        ("gemma-7b serve shapes g=1 d=256", (*gemma[:4], 32, *gemma[5:8], *serve_lens),
         "scrambled", (1, 3, "auto")),
        ("gemma-7b serve shapes g=1 d=256", (*gemma[:4], 32, *gemma[5:8], *serve_lens),
         "identity", (1, "auto")),
        ("starcoder2-3b serve shapes g=12", (*starcoder[:4], 32, *starcoder[5:8], *serve_lens),
         "scrambled", (1, 3, "auto")),
        ("starcoder2-3b serve shapes g=12", (*starcoder[:4], 32, *starcoder[5:8], *serve_lens),
         "identity", (1, "auto")),
        ("qwen3-moe-235b-a22b serve shapes g=16", (*qwen3[:4], 32, *qwen3[5:8], *serve_lens),
         "scrambled", (1, 3, "auto")),
        ("qwen3-moe-235b-a22b serve shapes g=16", (*qwen3[:4], 32, *qwen3[5:8], *serve_lens),
         "identity", (1, "auto")),
        ("bits=2 block_n=64, fewer blocks than splits, an empty row",
         (2, 4, 4, 64, 8, 64, 2, "tensor", [0, 1], [0, 64]), "scrambled", (1, 3, "auto")),
        ("bits=8 block_n=64, full residual", (2, 4, 2, 128, 8, 64, 8, "channel", [8, 6], [64, 3]),
         "scrambled", (1, 3)),
    ]
    for label, args, kind, splits in paged_cases:
        case = decode_case(*args)
        b, nb = args[0], args[4]
        pools = pools_of(case)
        order = (torch.randperm(b * nb, generator=gen, device=dev) if kind == "scrambled"
                 else torch.arange(b * nb, device=dev))
        table = order.reshape(b, nb).to(torch.int32)
        pools = [torch.empty_like(p).index_copy_(0, order, p) for p in pools]  # page = order
        pargs = [case["q"], *pools, case["k_res"], case["v_res"], table, case["pack_blocks"],
                 case["res_len"]]
        kw = dict(bits=args[6], block_n=args[5], k_gran=args[7], return_lse=True)
        ref = pg_ops.paged_bitdecode_attention(*pargs, impl="torch", num_splits=1, **kw)
        for ns in splits:
            resolved = splits_of(ns, *args[:8])
            got = pg_ops.paged_bitdecode_attention(*pargs, impl="cuda", num_splits=ns, **kw)
            check_decode("paged_bitdecode", f"{label}, {kind} table, num_splits={ns} "
                                            f"(->{resolved})", got, ref, args[8], args[9])
            if kind == "identity":  # one body with the dense kernel: bit for bit
                out_d, lse_d = bd_ops.bitdecode_attention(**case, impl="cuda", num_splits=ns,
                                                          **kw)
                check(torch.equal(got[0], out_d) and torch.equal(got[1], lse_d),
                      f"paged_bitdecode == bitdecode bit for bit, {label}, identity table, "
                      f"num_splits={ns}")

    # the speculative draft read (draft_bits) of K3 and K4 (a scrambled
    # table) against their plain versions: bits 4 -> 1, 2, 3; 8 -> 2, 4;
    # 2 -> 1; both K granularities; g 4, 1 and 16 (qwen3-moe's) at d 128,
    # 256 and 128; a residual of block_n tokens or widened by 8 (the draft
    # pass's), with a row whose res_len runs past block_n; draft_bits = bits
    # is the normal read bit for bit
    n_draft, draft_fail = 0, []
    for (bits_, dbits), gran, (g_, d_), res_n in itertools.product(
            DRAFT_PAIRS, ("channel", "tensor"), ((4, 128), (1, 256), (16, 128)),
            (BLOCK_N, BLOCK_N + 8)):
        rl = [res_n, 57]
        case = decode_case(2, 4, g_, d_, 6, BLOCK_N, bits_, gran, [6, 4], rl)
        if res_n > BLOCK_N:
            for f in ("k_res", "v_res"):
                case[f] = torch.cat([case[f], case[f][:, :, :8]], 2).contiguous()
        pools = pools_of(case)
        order = torch.randperm(12, generator=gen, device=dev)
        table = order.reshape(2, 6).to(torch.int32)
        pools = [torch.empty_like(p_).index_copy_(0, order, p_) for p_ in pools]
        pargs = [case["q"], *pools, case["k_res"], case["v_res"], table, case["pack_blocks"],
                 case["res_len"]]
        kw = dict(bits=bits_, block_n=BLOCK_N, k_gran=gran, return_lse=True)
        what = f"bits {bits_} -> {dbits} {gran} g={g_} d={d_} residual {res_n}"
        for name, call in (("bitdecode", lambda **x: bd_ops.bitdecode_attention(**case, **kw, **x)),
                           ("paged_bitdecode", lambda **x: pg_ops.paged_bitdecode_attention(
                               *pargs, **kw, **x))):
            ref = call(impl="torch", num_splits=1, draft_bits=dbits)
            for ns in (1, "auto"):
                got = call(impl="cuda", num_splits=ns, draft_bits=dbits)
                (out_k, lse_k), (out_r, lse_r) = got, ref
                note_err(name, out_k, out_r)
                n_draft += 1
                if not (torch.allclose(out_k, out_r, rtol=2e-2, atol=2e-2)
                        and torch.allclose(lse_k, lse_r, rtol=1e-3, atol=1e-3)):
                    draft_fail.append(f"{name} {what} num_splits={ns}: max|dout| "
                                      f"{(out_k - out_r).abs().max().item():.2e}")
            full = call(impl="cuda", num_splits="auto")
            same = call(impl="cuda", num_splits="auto", draft_bits=bits_)
            if not (torch.equal(full[0], same[0]) and torch.equal(full[1], same[1])):
                draft_fail.append(f"{name} {what}: draft_bits = bits is not the normal read")
    check(not draft_fail, f"bitdecode and paged_bitdecode draft reads within out 2e-2 / lse "
                          f"1e-3 of their plain versions ({n_draft} calls: bits 4 -> 1/2/3, "
                          f"8 -> 2/4, 2 -> 1, both K granularities, g/d 4/128, 1/256, "
                          f"16/128, residual "
                          f"{BLOCK_N}/{BLOCK_N + 8} with res_len > block_n), draft_bits = bits "
                          f"bit for bit the normal read (failed: {draft_fail})")

    # the MLA latent (shared_kv: V the first d_v channels of K, K's params
    # per channel) through K3 and K4: deepseek-v3's full width (one latent
    # head of 576, d_v 512, g 128) at phase 8's dense-loop lengths and at
    # the serve phase's, and the smoke config's (160 / 128, g 4); split
    # counts 1, 3 and auto, K4 on a scrambled table and on the identity (bit
    # for bit K3), the draft read 4 -> 2 bits
    def latent_case(b, g, dk, nb, bn, bits, pb, rl):
        off = 2.0 * torch.randn(dk, generator=gen, device=dev)  # O(1) outputs (V = K)
        kq_ = kq_ops.quantize_kv((randn(b, 1, nb * bn, dk) + off).to(torch.bfloat16), bits,
                                 "channel", block_n=bn, impl="cuda")
        return dict(q=randn(b, 1, g, dk), kw=kq_[0], k_scale=kq_[1], k_zero=kq_[2], vw=None,
                    v_scale=None, v_zero=None,
                    k_res=(randn(b, 1, bn, dk) + off).to(torch.bfloat16), v_res=None,
                    pack_blocks=ints(pb), res_len=ints(rl))

    mla_sm = 1.0 / 192**0.5  # 1 / sqrt(qk_nope + qk_rope) at full width
    latent_cases = [  # label, (B, g, d_k, d_v, nb, block_n, bits, pack_blocks, res_len)
        ("deepseek-v3 dense-loop lengths", (4, 128, 576, 512, 11, BLOCK_N, 4, MLA_PB, MLA_RL)),
        ("deepseek-v3 serve lengths", (4, 128, 576, 512, 32, BLOCK_N, 4, *serve_lens)),
        ("deepseek-v3 bits=2, an empty row", (2, 128, 576, 512, 8, BLOCK_N, 2, [0, 5], [0, 77])),
        ("deepseek-v3 bits=8 g=16", (2, 16, 576, 512, 8, BLOCK_N, 8, [3, 8], [128, 1])),
        ("smoke latent 160/128 g=4", (2, 4, 160, 128, 4, 64, 4, [4, 1], [37, 0])),
    ]
    for label, (b_, g_, dk, dv, nb_, bn_, bits_, pb, rl) in latent_cases:
        case = latent_case(b_, g_, dk, nb_, bn_, bits_, pb, rl)
        pools = pools_of_latent(case)
        order = torch.randperm(b_ * nb_, generator=gen, device=dev)
        scrambled = [torch.empty_like(p_).index_copy_(0, order, p_) for p_ in pools]
        tables = {"scrambled": order.reshape(b_, nb_).to(torch.int32),
                  "identity": torch.arange(b_ * nb_, dtype=torch.int32, device=dev).reshape(
                      b_, nb_)}
        kw = dict(bits=bits_, block_n=bn_, k_gran="channel", shared_kv=True, d_v=dv,
                  sm_scale=mla_sm, return_lse=True)

        def dense(**x):
            return bd_ops.bitdecode_attention(**case, **kw, **x)

        def paged(kind, **x):
            return pg_ops.paged_bitdecode_attention(
                case["q"], *(scrambled if kind == "scrambled" else pools), None, None, None,
                case["k_res"], None, tables[kind], case["pack_blocks"], case["res_len"],
                **kw, **x)

        for db in (None, 2) if bits_ == 4 else (None,):
            what = label + ("" if db is None else f", draft read {bits_} -> {db} bits")
            ref = dense(impl="torch", num_splits=1, draft_bits=db)
            for ns in (1, 3, "auto"):
                resolved = bd_ops.resolve_num_splits(
                    ns, b_, 1, bd_ops.work_units(nb_, bn_, bits_, bn_), dev, g=g_, d=dk,
                    block_n=bn_, bits=bits_, shared_kv=True, d_v=dv)
                got = dense(impl="cuda", num_splits=ns, draft_bits=db)
                check_decode("bitdecode", f"shared_kv {what} num_splits={ns} (->{resolved})",
                             got, ref, pb, rl)
                check_decode("paged_bitdecode", f"shared_kv {what}, scrambled table, "
                             f"num_splits={ns}", paged("scrambled", impl="cuda", num_splits=ns,
                                                        draft_bits=db), ref, pb, rl)
                ident = paged("identity", impl="cuda", num_splits=ns, draft_bits=db)
                check(torch.equal(ident[0], got[0]) and torch.equal(ident[1], got[1]),
                      f"paged_bitdecode == bitdecode bit for bit, shared_kv {what}, identity "
                      f"table, num_splits={ns}")

    # K3 and K4 at zamba2-7b's decode shape (B 4, H_kv 32, g 1, d 112: PV's
    # last 32-channel group half full): bits 2, 4, 8, both K granularities,
    # split counts 1, 3 and auto, rows of unequal lengths (one with no
    # packed block, one with a full residual); K4 on a scrambled table and on
    # the identity (bit for bit K3); the normal read and the draft read (4 ->
    # 2, 8 -> 4, 2 -> 1 bits).  One check a (bits, granularity, read)
    zh, zd = ZAMBA_KV
    zpb, zrl, znb = [16, 15, 0, 16], [48, 127, 100, 128], 17
    for bits_, gran in itertools.product((2, 4, 8), ("channel", "tensor")):
        case = decode_case(4, zh, 1, zd, znb, BLOCK_N, bits_, gran, zpb, zrl)
        pools = pools_of(case)
        order = torch.randperm(4 * znb, generator=gen, device=dev)
        arrays = {"scrambled": [torch.empty_like(p_).index_copy_(0, order, p_) for p_ in pools],
                  "identity": pools}
        tables = {"scrambled": order.reshape(4, znb).to(torch.int32),
                  "identity": torch.arange(4 * znb, dtype=torch.int32, device=dev).reshape(
                      4, znb)}
        kw = dict(bits=bits_, block_n=BLOCK_N, k_gran=gran, return_lse=True)
        for db in (None, {4: 2, 8: 4, 2: 1}[bits_]):
            what = (f"zamba2-7b decode shape B=4 H={zh} g=1 d={zd} bits={bits_} {gran}"
                    + ("" if db is None else f", draft read -> {db} bits"))
            ref = bd_ops.bitdecode_attention(**case, impl="torch", num_splits=1, draft_bits=db,
                                             **kw)
            fails, worst = [], ""
            for ns in (1, 3, "auto"):
                got = bd_ops.bitdecode_attention(**case, impl="cuda", num_splits=ns,
                                                 draft_bits=db, **kw)
                ok, msg = decode_close("bitdecode", f"num_splits={ns}", got, ref, zpb, zrl)
                fails += [] if ok else [msg]
                worst = msg
                for kind in ("scrambled", "identity"):
                    pg_ = pg_ops.paged_bitdecode_attention(
                        case["q"], *arrays[kind], case["k_res"], case["v_res"], tables[kind],
                        case["pack_blocks"], case["res_len"], impl="cuda", num_splits=ns,
                        draft_bits=db, **kw)
                    ok, msg = decode_close("paged_bitdecode", f"{kind} num_splits={ns}", pg_,
                                           ref, zpb, zrl)
                    if kind == "identity" and not (torch.equal(pg_[0], got[0])
                                                   and torch.equal(pg_[1], got[1])):
                        ok, msg = False, f"paged_bitdecode != bitdecode, identity, {ns} splits"
                    fails += [] if ok else [msg]
            check(not fails, f"bitdecode and paged_bitdecode (scrambled and identity tables, "
                             f"the identity bit for bit bitdecode), {what}, num_splits 1 / 3 / "
                             f"auto: {fails or worst}")

    # one call on the card is at most two launches: the kernel, and the
    # merge when it runs as more than one split
    case = decode_case(*llama)
    for name, ns, want in (("bitdecode", 1, {"bitdecode": 1}),
                           ("bitdecode", "auto", {"bitdecode": 1, "bitdecode_merge": 1}),
                           ("paged_bitdecode", "auto",
                            {"paged_bitdecode": 1, "bitdecode_merge": 1})):
        kw = dict(bits=BITS, block_n=BLOCK_N, k_gran="channel", num_splits=ns)
        if name == "bitdecode":
            call = lambda: bd_ops.bitdecode_attention(**case, **kw)  # noqa: E731
        else:
            ident = torch.arange(4 * 18, dtype=torch.int32, device=dev).reshape(4, 18)
            call = lambda: pg_ops.paged_bitdecode_attention(  # noqa: E731
                case["q"], *pools_of(case), case["k_res"], case["v_res"], ident,
                case["pack_blocks"], case["res_len"], **kw)
        call()
        torch.cuda.synchronize()
        _build.launches.clear()
        call()
        check(dict(_build.launches) == want, f"one {name} call, num_splits={ns}: launches "
                                             f"{dict(_build.launches)} (want {want})")
    # the merge on its own against ref.merge_partials, with empty splits
    for s_, rows, dv in ((8, (4, 8, 4), 128), (2, (4, 16, 1), 256), (16, (4, 2, 12), 128)):
        o_p = torch.randn((s_, *rows, dv), generator=gen, device=dev)
        l_p = 4.0 * torch.randn((s_, *rows), generator=gen, device=dev)
        l_p[0] = -1e37  # an empty split
        got = bd_ops.merge_cuda(o_p, l_p)
        ref = bd_ref.merge_partials(o_p, l_p)
        note_err("bitdecode_merge", got[0], ref[0])
        check(torch.allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
              and torch.allclose(got[1], ref[1], rtol=1e-5, atol=1e-5),
              f"bitdecode_merge S={s_} rows={rows} d_v={dv}, an empty split: max|dout| "
              f"{(got[0] - ref[0]).abs().max().item():.2e}, max|dlse| "
              f"{(got[1] - ref[1]).abs().max().item():.2e}")

    n_pages = SERVE_SLOTS * (SERVE_MAX_SEQ // BLOCK_N) + SERVE_SLOTS  # the serve pool
    for (h, d), bits, gran in itertools.product(((8, 128), ZAMBA_KV), (2, 4, 8),
                                                ("channel", "tensor")):
        b, bn = 4, BLOCK_N
        pool = [*kq_ops.quantize_kv(randn(1, h, n_pages * bn, d), bits, gran, block_n=bn),
                *kq_ops.quantize_kv(randn(1, h, n_pages * bn, d), bits, "tensor", block_n=bn)]
        pool = [x[0].movedim(1, 0).contiguous() for x in pool]
        res = [randn(b, h, bn, d), randn(b, h, bn, d)]
        full, dest = ints([1, 0, 1, 1]), ints([37, 1, 90, n_pages + 50])  # clamps to P-1
        before = [x.clone() for x in pool]
        twin = [x.clone() for x in pool]
        kw = dict(bits=bits, block_n=bn, k_gran=gran)
        out = rf_ops.paged_residual_flush(*pool, *res, full, dest, impl="cuda", **kw)
        ref = rf_ops.paged_residual_flush(*twin, *res, full, dest, impl="torch", **kw)
        kept = torch.tensor([p for p in range(n_pages) if p not in (37, 90, n_pages - 1)],
                            device=dev)
        for o, r in zip(out, ref):
            note_err("paged_residual_flush", o, r)
        check(all(bitwise(o, r) for o, r in zip(out, ref))
              and all(bitwise(o[kept], b0[kept]) for o, b0 in zip(out, before)),
              f"paged_residual_flush bitwise P={n_pages} H={h} d={d} bits={bits} {gran}, "
              "mixed full, dest past P-1; every other page unchanged")

    # residual_flush's append mode (the decode step's cache update) against
    # its plain version over APPEND_STEPS consecutive steps, dense and
    # paged (a scrambled table), every array and length compared after
    # every step: rows start at different res_len so they fill on different
    # steps, row 3 is masked every fourth step, every row flushes twice or
    # more; then every block or page the run did not flush into is unchanged
    def append_run(paged, h, d, bits, gran, steps=APPEND_STEPS):
        b, bn, nb = 4, BLOCK_N, 6
        name = "paged_residual_flush" if paged else "residual_flush"
        arrays = [*kq_ops.quantize_kv(randn(b, h, nb * bn, d), bits, gran, block_n=bn),
                  *kq_ops.quantize_kv(randn(b, h, nb * bn, d), bits, "tensor", block_n=bn)]
        lens = [ints([0, 1, 0, 2]), ints([5, 60, 127, 90]), ints([0] * b)]
        if paged:  # pools of 8 pages a row, pages [0, b) the scratch pages
            arrays = [x.movedim(2, 1).reshape(-1, *x.shape[1:2], *x.shape[3:]) for x in arrays]
            arrays = [torch.cat([x, x[:2 * b]]).contiguous() for x in arrays]
            table = (b + torch.randperm(8 * b - b, generator=gen, device=dev)[:6 * b]
                     ).reshape(b, 6).to(torch.int32)
            lens = [table, *lens]
        arrays += [randn(b, h, bn, d), randn(b, h, bn, d)]
        twin = [x.clone() for x in arrays + lens]
        start = [x.clone() for x in arrays + lens]
        fn = rf_ops.paged_append_flush if paged else rf_ops.append_flush
        kw = dict(bits=bits, block_n=bn, k_gran=gran)
        bad_step = None
        for step in range(steps):
            k_new = randn(b, 1, h, d).transpose(1, 2)  # the model's strided views
            v_new = randn(b, 1, 2 * h, d)[:, :, h:].transpose(1, 2)
            mask = torch.tensor([True, True, True, step % 4 != 3], device=dev)
            fn(*arrays, k_new, v_new, *lens, mask=mask, impl="cuda", **kw)
            fn(*twin[:8], k_new, v_new, *twin[8:], mask=mask, impl="torch", **kw)
            if bad_step is None and not all(bitwise(x, y) for x, y in zip(arrays + lens, twin)):
                bad_step = step
        for o, r in zip(arrays + lens, twin):
            note_err(name, o, r)
        pb_s, pb_e = start[-3].tolist(), lens[-3].tolist()
        flushed = [e - s_ for s_, e in zip(pb_s, pb_e)]
        kept = []  # packed fields: every block / page no flush wrote
        for i in range(6):
            x, x0 = arrays[i], start[i]
            if paged:
                written = {int(table[r, min(j, 5)]) for r in range(b) for j in range(pb_s[r], pb_e[r])}
                keep = [p for p in range(x.shape[0]) if p not in written]
                kept.append(bitwise(x[keep], x0[keep]))
            else:
                kept += [bitwise(x[r, :, :pb_s[r]], x0[r, :, :pb_s[r]])
                         and bitwise(x[r, :, pb_e[r]:], x0[r, :, pb_e[r]:]) for r in range(b)]
        check(bad_step is None and min(flushed) >= 2 and all(kept) and not lens[-1].any(),
              f"{name} append mode bitwise over {steps} steps B={b} H={h} d={d} "
              f"bits={bits} {gran}{', scrambled table' if paged else ''}, row 3 masked every "
              f"fourth step: flushes {flushed}, first differing step {bad_step}, untouched "
              f"{'pages' if paged else 'blocks'} unchanged {all(kept)}, counter back at 0")

    for paged in (False, True):
        for h, d in ((8, 128), (16, 256)):
            for bits in (2, 4, 8):
                for gran in ("channel", "tensor"):
                    append_run(paged, h, d, bits, gran)
    # zamba2-7b's caches (H 32, d 112: per-token statistics over 14 of 16
    # lanes) over 2 * block_n + 5 steps: every row still flushes twice
    for paged in (False, True):
        for bits in (2, 4, 8):
            for gran in ("channel", "tensor"):
                append_run(paged, ZAMBA_KV[0], ZAMBA_KV[1], bits, gran, steps=2 * BLOCK_N + 5)

    # the MLA latent's flush and append (shared_kv: K alone, per channel) at
    # d 160 and 576, dense and paged (a scrambled table), bits 2, 4, 8: mode
    # "flush" once (mixed full, a destination past the end), then mode
    # "append" over 2 * block_n + 5 steps (row 1 masked every third step),
    # every array and length bit for bit the plain version's after each call
    def latent_flush_run(paged, d, bits):
        b, bn, nb = 3, BLOCK_N, 6
        name = "paged_residual_flush" if paged else "residual_flush"
        arrays = list(kq_ops.quantize_kv(randn(b, 1, nb * bn, d), bits, "channel", block_n=bn))
        if paged:
            arrays = [x.movedim(2, 1).reshape(-1, *x.shape[1:2], *x.shape[3:]).contiguous()
                      for x in arrays]
        k_res = randn(b, 1, bn, d)
        kw = dict(bits=bits, block_n=bn, k_gran="channel", shared_kv=True)
        flush = rf_ops.paged_residual_flush if paged else rf_ops.residual_flush
        full, dest = ints([1, 0, 1]), ints([7, 1, 40] if paged else [0, 1, 9])
        twin = [x.clone() for x in arrays]
        flush(*arrays, None, None, None, k_res, None, full, dest, impl="cuda", **kw)
        flush(*twin, None, None, None, k_res, None, full, dest, impl="torch", **kw)
        flush_ok = all(bitwise(x, y) for x, y in zip(arrays, twin))
        lens = [ints([0, 1, 0]), ints([5, 100, 127]), ints([0, 0, 0])]
        if paged:
            lens = [(b + torch.randperm(nb * b - b, generator=gen, device=dev)[:4 * b]
                     ).reshape(b, 4).to(torch.int32)] + lens
        state, twin = arrays + [k_res] + lens, [x.clone() for x in arrays + [k_res] + lens]
        append = rf_ops.paged_append_flush if paged else rf_ops.append_flush
        bad_step = None
        for step in range(2 * bn + 5):
            k_new = randn(b, 1, 1, d)
            mask = torch.tensor([True, step % 3 != 1, True], device=dev)
            for arr, impl in ((state, "cuda"), (twin, "torch")):
                append(*arr[:3], None, None, None, arr[3], None, k_new, None, *arr[4:],
                       mask=mask, impl=impl, **kw)
            if bad_step is None and not all(bitwise(x, y) for x, y in zip(state, twin)):
                bad_step = step
        for o, r in zip(state, twin):
            note_err(name, o, r)
        flushes = state[-3].tolist()
        check(flush_ok and bad_step is None and min(flushes) >= 2 and not state[-1].any(),
              f"{name} shared_kv bitwise d={d} bits={bits}: mode flush {flush_ok}; mode "
              f"append over {2 * bn + 5} steps (pack_blocks {flushes}), first differing step "
              f"{bad_step}, counter back at 0")

    for d in (160, 576):
        for paged in (False, True):
            for bits in (2, 4, 8):
                latent_flush_run(paged, d, bits)

    # flash_prefill over head dims x query heads per KV head x causal, S
    # cycling through shorter than a tile, ragged and aligned, both layouts;
    # per-channel V offsets keep the output O(1) beside the tolerance
    def v_off(v):
        return (v + 2.0 * torch.randn(v.shape[-1], generator=gen, device=dev)).to(torch.bfloat16)

    def flash_case(q, k, v, causal, layout, what):
        d = q.shape[-1]
        kw = dict(causal=causal, layout=layout, return_lse=True)
        out_k, lse_k = fp_ops.flash_prefill_attention(q, k, v, impl="cuda", **kw)
        out_r, lse_r = fp_ops.flash_prefill_attention(q, k, v, impl="torch", **kw)
        note_err("flash_prefill", out_k, out_r)
        ok = (torch.allclose(out_k.float(), out_r.float(), rtol=3e-2, atol=3e-2)
              and torch.allclose(lse_k, lse_r, rtol=1e-3, atol=1e-3))
        check(ok, f"flash_prefill {what} d={d} {'causal' if causal else 'full'} {layout}: "
                  f"max|dout| {(out_k.float() - out_r.float()).abs().max().item():.2e} (max|out| "
                  f"{out_r.float().abs().max().item():.2f}), max|dlse| "
                  f"{(lse_k - lse_r).abs().max().item():.2e}")

    for i, (d, g, causal) in enumerate(itertools.product((32, 64, 128, 256), (1, 4, 12),
                                                         (True, False))):
        s, layout = (48, 500, 1900, 2048)[i % 4], ("bhsd", "bshd")[(i // 2) % 2]
        hkv = 4 if g == 1 else 2
        shape = (lambda h: (2, h, s, d)) if layout == "bhsd" else (lambda h: (2, s, h, d))
        flash_case(randn(*shape(g * hkv)), randn(*shape(hkv)), v_off(randn(*shape(hkv))), causal,
                   layout, f"B=2 Hq={g * hkv} Hkv={hkv} S={s}")
    # the edges of the 64-row consumer warpgroups and the 128-row KV tiles,
    # and a long ragged S: every head dim, g 12, 4 and 1, causal and full
    for i, s in enumerate((1, 63, 64, 65, 127, 128, 129, 2100)):
        for causal in (True, False):
            d, g = (64, 32, 128, 256)[i % 4], (12, 4, 1)[(i + causal) % 3]
            hkv = 1 if g == 12 else 2
            flash_case(randn(2, s, g * hkv, d), randn(2, s, hkv, d), v_off(randn(2, s, hkv, d)),
                       causal, "bshd", f"B=2 Hq={g * hkv} Hkv={hkv} S={s}")
    # qwen3-moe-235b-a22b's prefill: 64 query heads on 4 KV heads (g 16) at
    # d 128 over the dense loop's 1,200 padded tokens
    flash_case(randn(4, 1200, 64, 128), randn(4, 1200, 4, 128), v_off(randn(4, 1200, 4, 128)),
               True, "bshd", "qwen3-moe-235b-a22b prefill shape B=4 Hq=64 Hkv=4 S=1200")
    # head slices of one fused [B, S, Hq + 2 Hkv, d] projection, read through
    # their strides
    qkv = randn(2, 300, 8 + 2 * 2, 128)
    qkv[:, :, 10:] = v_off(qkv[:, :, 10:])
    flash_case(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:], True, "bshd",
               "B=2 Hq=8 Hkv=2 S=300, q/k/v head slices of one fused buffer,")
    # MLA's prefill through the padded route of core.attention.blockwise_attention
    # (d_k 192, d_v 128 zero-padded to the d = 256 instance, the output sliced
    # back): deepseek-v3's 128/128 heads over 1,200 tokens, against the plain
    # loop on the unpadded inputs (out 3e-2); its lse, the kernel's on the
    # padded inputs against the plain version's (1e-3)
    q_, k_ = randn(1, 1200, 128, 192), randn(1, 1200, 128, 192)
    v_ = v_off(randn(1, 1200, 128, 128))
    _build.launches.clear()
    got = catt.blockwise_attention(q_, k_, v_, sm_scale=mla_sm, impl="cuda")
    one = dict(_build.launches) == {"flash_prefill": 1}
    want = catt.blockwise_attention(q_, k_, v_, sm_scale=mla_sm, impl="torch")
    note_err("flash_prefill", got, want)
    pad = [torch.nn.functional.pad(x, (0, 256 - x.shape[-1])) for x in (q_, k_, v_)]
    lse_k, lse_r = (fp_ops.flash_prefill_attention(*pad, sm_scale=mla_sm, layout="bshd",
                                                   impl=impl, return_lse=True)[1]
                    for impl in ("cuda", "torch"))
    check(one and got.shape == want.shape
          and torch.allclose(got.float(), want, rtol=3e-2, atol=3e-2)
          and torch.allclose(lse_k, lse_r, rtol=1e-3, atol=1e-3),
          f"flash_prefill padded route (MLA d_k 192 / d_v 128 -> 256) B=1 Hq=Hkv=128 S=1200: "
          f"one launch {one}, max|dout| {(got.float() - want).abs().max().item():.2e} (max|out| "
          f"{want.abs().max().item():.2f}), max|dlse| {(lse_k - lse_r).abs().max().item():.2e}")
    del q_, k_, v_, pad, got, want
    # zamba2-7b's prefill (B 4, 32 / 32 heads, S 2,000, d 112 zero-padded to
    # the d = 128 instance, the default scale 1 / sqrt(112)) through the
    # same route against the plain loop on the unpadded inputs; its lse, the
    # kernel's on the padded inputs against the plain version's
    q_, k_ = randn(4, HYBRID_PROMPT, zh, zd), randn(4, HYBRID_PROMPT, zh, zd)
    v_ = v_off(randn(4, HYBRID_PROMPT, zh, zd))
    _build.launches.clear()
    got = catt.blockwise_attention(q_, k_, v_, impl="cuda")
    one = dict(_build.launches) == {"flash_prefill": 1}
    want = catt.blockwise_attention(q_, k_, v_, impl="torch")
    note_err("flash_prefill", got, want)
    pad = [torch.nn.functional.pad(x, (0, 128 - zd)) for x in (q_, k_, v_)]
    lse_k, lse_r = (fp_ops.flash_prefill_attention(*pad, sm_scale=1.0 / zd**0.5, layout="bshd",
                                                   impl=impl, return_lse=True)[1]
                    for impl in ("cuda", "torch"))
    check(one and got.shape == want.shape
          and torch.allclose(got.float(), want, rtol=3e-2, atol=3e-2)
          and torch.allclose(lse_k, lse_r, rtol=1e-3, atol=1e-3),
          f"flash_prefill padded route (zamba2-7b d 112 -> 128) B=4 Hq=Hkv={zh} "
          f"S={HYBRID_PROMPT}: one launch {one}, max|dout| "
          f"{(got.float() - want).abs().max().item():.2e} (max|out| "
          f"{want.abs().max().item():.2f}), max|dlse| {(lse_k - lse_r).abs().max().item():.2e}")
    del q_, k_, v_, pad, got, want
    # the full mode with a key length of its own (an encoder-decoder's cross
    # attention, S decoder tokens over T encoder frames): seamless-m4t-medium's
    # cross prefill (S 100 < one 128-row q-tile), a ragged T with g 4, S > T,
    # S < 16 and T < one KV tile, d 256 (64-key tiles); both layouts; and
    # through blockwise_attention(causal=False) on the model's layout
    for (b_, hq_, hkv_, s_, t_, d_), layout in (
            ((4, 16, 16, 100, 4096, 64), "bshd"), ((2, 8, 2, 300, 1000, 128), "bhsd"),
            ((2, 8, 8, 2048, 512, 128), "bshd"), ((2, 12, 1, 7, 300, 32), "bshd"),
            ((2, 8, 2, 200, 50, 128), "bhsd"), ((1, 4, 4, 130, 70, 256), "bshd")):
        shape = (lambda h, n: (b_, h, n, d_)) if layout == "bhsd" else (
            lambda h, n: (b_, n, h, d_))
        flash_case(randn(*shape(hq_, s_)), randn(*shape(hkv_, t_)), v_off(randn(*shape(hkv_, t_))),
                   False, layout, f"cross B={b_} Hq={hq_} Hkv={hkv_} S={s_} T={t_}")
    # phases 10 and 11's other prefill calls: qwen2-vl-7b's causal prefill
    # (28 / 4 heads, g 7, d 128, over 1,024 patches and up to 895 text
    # tokens), seamless-m4t-medium's encoder (full, S = T = 4,096) and its
    # decoder's self attention (causal, S 100), 16 / 16 heads of 64
    n_vlm = 1024 + max(VLM_TEXT_LENS)
    flash_case(randn(4, n_vlm, 28, 128), randn(4, n_vlm, 4, 128), v_off(randn(4, n_vlm, 4, 128)),
               True, "bshd", f"qwen2-vl-7b prefill shape B=4 Hq=28 Hkv=4 S={n_vlm}")
    for s_, causal, what in ((4096, False, "encoder"), (ENCDEC_PROMPT, True, "decoder self")):
        flash_case(randn(4, s_, 16, 64), randn(4, s_, 16, 64), v_off(randn(4, s_, 16, 64)),
                   causal, "bshd", f"seamless-m4t-medium {what} shape B=4 Hq=Hkv=16 S={s_}")
    q_, k_ = randn(4, ENCDEC_PROMPT, 16, 64), randn(4, 4096, 16, 64)
    v_ = v_off(randn(4, 4096, 16, 64))
    _build.launches.clear()
    got = catt.blockwise_attention(q_, k_, v_, causal=False, impl="cuda")
    one = dict(_build.launches) == {"flash_prefill": 1}
    want = catt.blockwise_attention(q_, k_, v_, causal=False, impl="torch")
    note_err("flash_prefill", got, want)
    refused = False
    try:
        catt.blockwise_attention(q_, k_, v_, causal=True, impl="cuda")
    except ValueError:
        refused = True
    check(one and refused and torch.allclose(got.float(), want, rtol=3e-2, atol=3e-2),
          f"flash_prefill cross through blockwise_attention(causal=False) B=4 Hq=Hkv=16 "
          f"S={ENCDEC_PROMPT} T=4096: one launch {one}, max|dout| "
          f"{(got.float() - want).abs().max().item():.2e}; causal at S != T refused {refused}")
    del q_, k_, v_, got, want
    torch.cuda.synchronize()

    # timing at the main path's shapes: device time of one call, L2 scrubbed
    # before each; the host enqueues every iteration behind a spin kernel, so
    # the events bracket device work only, not Python launch gaps
    scrub = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)  # > the 50 MB L2

    def time_ms(fn, iters=10, prep=lambda: None):
        """``prep`` runs before each call, outside the timed pair (the
        append's lengths reset to the state timed)."""
        prep()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s: enough for the host to queue all
        pairs = []
        for _ in range(iters):
            scrub.zero_()
            prep()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    def bound(name, nbytes, ops, peak):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        stats[name].update(bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations")

    b, h, d, g, bn = 4, 8, 128, 4, BLOCK_N
    npr = bn * BITS // 32
    x = randn(b, max(PROMPT_LENS), h, d).transpose(1, 2)[:, :, :16 * bn]
    kq = lambda impl: kq_ops.quantize_kv(x, BITS, "channel", block_n=bn, impl=impl)  # noqa: E731
    stats["kv_quant"].update(ms=time_ms(lambda: kq("cuda")), plain_ms=time_ms(lambda: kq("torch")))
    n_el = x.numel()
    bound("kv_quant", n_el * 2 + n_el * BITS // 8 + 2 * 2 * b * h * 16 * d, 8 * n_el, F32_OPS_PER_S)

    def time_fill(key, b, h, prompt, d):
        """K1 at one model's prefill (prompt-long K and V as the model's
        strided views, their full blocks quantized): K alone (params per
        channel, fresh outputs; the row's own time is llama3-8b's, timed
        above), V alone (per token), the pair into a cache's first blocks
        (what the prefill runs), and the parent's fill (the two launches
        into fresh outputs and six slice copies), each beside its bound."""
        st, n_full = stats["kv_quant"], prompt // bn
        n = n_full * bn
        k, v = randn(b, prompt, h, d).transpose(1, 2), randn(b, prompt, h, d).transpose(1, 2)
        cache = qcache.init_cache(b, h, d, prompt + bn, device=dev)
        heads = [getattr(cache, f)[:, :, :n_full] for f in ("kw", "k_scale", "k_zero", "vw",
                                                              "v_scale", "v_zero")]
        calls = {
            "": lambda: kq_ops.quantize_kv(k[:, :, :n], BITS, "channel", block_n=bn),
            "v_": lambda: kq_ops.quantize_kv(v[:, :, :n], BITS, "tensor", block_n=bn),
            "pair_": lambda: kq_ops.quantize_kv_pair(k[:, :, :n], v[:, :, :n], BITS, "channel",
                                                     block_n=bn, out_k=heads[:3], out_v=heads[3:]),
            "fill_parent_": lambda: parent_fill(cache, k, v, n_full, "cuda"),
        }
        el = b * h * n * d
        k_bytes = el * 2 + el * BITS // 8 + 2 * 2 * b * h * n_full * d
        v_bytes = el * 2 + el * BITS // 8 + 2 * 2 * b * h * n_full * bn
        for part, call in calls.items():
            if key or part:  # llama3-8b's K alone is the row's own time
                st[key + part + "ms"] = time_ms(call)
            nbytes = {"": k_bytes, "v_": v_bytes}.get(part, k_bytes + v_bytes)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 8 * el * (1 if part in ("", "v_") else 2) / F32_OPS_PER_S * 1e3
            st[key + part + "bound_ms"] = max(t_bytes, t_ops)
        st[key + "shape"] = dict(B=b, H_kv=h, tokens=n, d=d, bits=BITS, block_n=bn)
        log(f"  time kv_quant {key or 'llama3_'}{st[key + 'shape']}: K alone "
            f"{st[key + 'ms'] * 1e3:.1f} us, V alone {st[key + 'v_ms'] * 1e3:.1f} us, the pair "
            f"into the cache {st[key + 'pair_ms'] * 1e3:.1f} us, the parent's fill (2 launches, "
            f"6 copies) {st[key + 'fill_parent_ms'] * 1e3:.1f} us; bounds "
            f"{st[key + 'bound_ms'] * 1e3:.2f} / {st[key + 'v_bound_ms'] * 1e3:.2f} / "
            f"{st[key + 'pair_bound_ms'] * 1e3:.2f} us (bytes)")

    time_fill("", b, h, max(PROMPT_LENS), d)
    time_fill("gemma_", 4, 16, max(FAMILY_PROMPT_LENS), 256)

    nb = -(-(max(PROMPT_LENS) + DECODE_STEPS) // bn)
    packed = [*kq_ops.quantize_kv(randn(b, h, nb * bn, d), BITS, "channel", block_n=bn),
              *kq_ops.quantize_kv(randn(b, h, nb * bn, d), BITS, "tensor", block_n=bn)]
    res = [randn(b, h, bn, d), randn(b, h, bn, d)]

    def time_decode(key, paged, b, h, g, d, pb, rl, cache, table=None, draft=False):
        """One whole call of K3 / K4 (wrapper, kernel, merge) and its plain
        version at these lengths; the lengths are on the card before the
        timed calls, as the model's are.  With ``draft``, also the draft
        read at SPEC_BITS in the same call (``draft_ms``: the same bytes)."""
        q_, res_ = randn(b, h, g, d), [randn(b, h, bn, d), randn(b, h, bn, d)]
        pbt, rlt = ints(pb), ints(rl)
        name, kw = ("paged_bitdecode" if paged else "bitdecode"), dict(
            bits=BITS, block_n=bn, k_gran="channel")
        if paged:
            call = lambda impl, **x: pg_ops.paged_bitdecode_attention(  # noqa: E731
                q_, *cache, *res_, table, pbt, rlt, impl=impl, **kw, **x)
        else:
            call = lambda impl, **x: bd_ops.bitdecode_attention(  # noqa: E731
                q_, *cache, *res_, pbt, rlt, impl=impl, **kw, **x)
        st = stats[name]
        st[key + "ms"] = time_ms(lambda: call("cuda"))
        st[key + "plain_ms"] = time_ms(lambda: call("torch"), iters=3)
        if draft:
            st[key + "draft_ms"] = time_ms(lambda: call("cuda", draft_bits=SPEC_BITS))
            st[key + "draft_plain_ms"] = time_ms(lambda: call("torch", draft_bits=SPEC_BITS),
                                                 iters=3)
        nb_ = table.shape[1] if paged else cache[0].shape[2]
        st[key + "num_splits"] = splits_of("auto", b, h, g, d, nb_, bn, BITS)
        npr_ = bn * BITS // 32
        nbytes = (sum(pb) * h * (2 * npr_ * d * 4 + 2 * 2 * (d + bn))  # valid words + params
                  + sum(rl) * h * 2 * d * 2 + q_.numel() * 2           # valid residual + q
                  + 8 * b + (4 * sum(pb) if paged else 0)              # lengths, table entries
                  + b * h * g * (d + 1) * 4)                           # out + lse
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * 2 * g * d * h * (sum(pb) * bn + sum(rl)) / BF16_OPS_PER_S * 1e3
        st[key + "bound_ms"] = max(t_bytes, t_ops)
        st[key + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        st[key + "shape"] = dict(B=b, H_kv=h, g=g, d=d, nb=nb_, pack_blocks=pb, res_len=rl)
        st[key + "share_of_bound"] = st[key + "bound_ms"] / st[key + "ms"]
        log(f"  time {name} {key or 'llama3_'}{st[key + 'shape']}: call {st[key + 'ms'] * 1e3:.1f} us "
            f"({st[key + 'num_splits']} splits, {st[key + 'share_of_bound']:.1%} of the bound), "
            f"plain {st[key + 'plain_ms'] * 1e3:.1f} us, bound {st[key + 'bound_ms'] * 1e3:.2f} us "
            f"({st[key + 'bound_by']})"
            + (f"; the draft read at {SPEC_BITS} bits {st[key + 'draft_ms'] * 1e3:.1f} us "
               f"(plain {st[key + 'draft_plain_ms'] * 1e3:.1f} us), same call" if draft else ""))

    def decode_cache(paged, b, h, d, nb):
        rows, n = (1, n_pages * bn) if paged else (b, nb * bn)
        cache = [*kq_ops.quantize_kv(randn(rows, h, n, d), BITS, "channel", block_n=bn),
                 *kq_ops.quantize_kv(randn(rows, h, n, d), BITS, "tensor", block_n=bn)]
        return [x[0].movedim(1, 0).contiguous() for x in cache] if paged else cache

    # the dense loop's cache after its prompts (pack_blocks 14/15/16/16 of
    # nb 18), for llama3-8b and, cut at their prompts, gemma-7b and
    # starcoder2-3b
    pb_main, rl_main = [14, 15, 16, 16], [108, 80, 2, 52]
    pb_fam, rl_fam = [8, 8, 9, 9], [104, 56, 126, 48]
    time_decode("", False, b, h, g, d, pb_main, rl_main, packed, draft=True)
    for key, (b_, h_, g_, d_) in (("gemma_", (4, 16, 1, 256)), ("starcoder2_", (4, 2, 12, 128))):
        nb_fam = -(-(max(FAMILY_PROMPT_LENS) + FAMILY_STEPS) // bn)
        time_decode(key, False, b_, h_, g_, d_, pb_fam, rl_fam, decode_cache(False, b_, h_, d_, nb_fam))
    # zamba2-7b's dense loop at its end (2,096 tokens a row), and the draft read
    time_decode("zamba2_", False, 4, zh, 1, zd, ZAMBA_PB, ZAMBA_RL,
                decode_cache(False, 4, zh, zd, znb), draft=True)
    # the merge alone at the llama3-8b call's split count
    s_ = stats["bitdecode"]["num_splits"]
    o_p = torch.randn((s_, b, h, g, d), generator=gen, device=dev)
    l_p = 4.0 * torch.randn((s_, b, h, g), generator=gen, device=dev)
    st = stats["bitdecode_merge"]
    st["ms"] = time_ms(lambda: bd_ops.merge_cuda(o_p, l_p))
    st["plain_ms"] = time_ms(lambda: bd_ref.merge_partials(o_p, l_p))
    bound("bitdecode_merge", (s_ + 1) * b * h * g * (d + 1) * 4, 3 * s_ * b * h * g * d,
          F32_OPS_PER_S)
    st["shape"] = dict(S=s_, B=b, H_kv=h, g=g, d_v=d)
    st["share_of_bound"] = st["bound_ms"] / st["ms"]

    # the paged kernels at the serve phase's shapes: its pool, a scrambled
    # table, the block counts of a mid-run decode step
    nb_max = SERVE_MAX_SEQ // bn
    pool = [*kq_ops.quantize_kv(randn(1, h, n_pages * bn, d), BITS, "channel", block_n=bn),
            *kq_ops.quantize_kv(randn(1, h, n_pages * bn, d), BITS, "tensor", block_n=bn)]
    pool = [x[0].movedim(1, 0).contiguous() for x in pool]
    table = (b + torch.randperm(n_pages - b, generator=gen, device=dev)[:b * nb_max]
             ).reshape(b, nb_max).to(torch.int32)
    pb_serve, rl_serve = [10, 20, 7, 13], [100, 60, 30, 90]  # a mid-run decode step
    time_decode("", True, b, h, g, d, pb_serve, rl_serve, pool, table, draft=True)
    for key, (b_, h_, g_, d_) in (("gemma_", (4, 16, 1, 256)), ("starcoder2_", (4, 2, 12, 128)),
                                  ("zamba2_", (4, zh, 1, zd))):
        time_decode(key, True, b_, h_, g_, d_, pb_serve, rl_serve,
                    decode_cache(True, b_, h_, d_, nb_max), table)

    def time_flush(paged, h, d, key):
        """K2 / K5 at one model's decode cache (B 4, 4-bit, channel K, the
        phase-3 cache or the serve pool and a scrambled table): mode
        "append" (the decode step's whole cache update), its plain version,
        the parent's unfused step (mode "flush" plus the torch ops around
        it) and mode "flush" alone, on a step where every row flushes and on
        one where none does, beside the bound.  The lengths are reset before
        each timed call."""
        name = "paged_residual_flush" if paged else "residual_flush"
        st, bn = stats[name], BLOCK_N
        arrays = decode_cache(paged, b, h, d, nb) + [randn(b, h, bn, d), randn(b, h, bn, d)]
        pb0 = ints(pb_serve if paged else pb_main)
        lens = [pb0.clone(), ints([0] * b), ints([0] * b)]
        lens = [table, *lens] if paged else lens
        k_new = randn(b, 1, h, d).transpose(1, 2)  # the model's strided views
        v_new = randn(b, 1, 2 * h, d)[:, :, h:].transpose(1, 2)
        kw = dict(bits=BITS, block_n=bn, k_gran="channel")
        fused = rf_ops.paged_append_flush if paged else rf_ops.append_flush
        flush_mode = rf_ops.paged_residual_flush if paged else rf_ops.residual_flush
        unfused = functools.partial(rf_ref.paged_append_flush_ref if paged else
                                    rf_ref.append_flush_ref,
                                    flush=functools.partial(flush_mode, impl="cuda"))
        for rl, sfx in ((bn - 1, ""), (5, "_no_flush")):
            def prep(rl=rl):
                lens[-3].copy_(pb0)
                lens[-2].fill_(rl)
            for field, call in (("ms", functools.partial(fused, impl="cuda")),
                                ("plain_ms", functools.partial(fused, impl="torch")),
                                ("unfused_ms", unfused)):
                st[key + field + sfx] = time_ms(
                    lambda: call(*arrays, k_new, v_new, *lens, **kw), prep=prep)
            full = ints([int(rl == bn - 1)] * b)
            dest = (table[:, 12].contiguous() if sfx == "" else ints(list(range(b)))
                    ) if paged else pb0
            st[key + "flush_mode_ms" + sfx] = time_ms(
                lambda: flush_mode(*arrays[:8], full, dest, impl="cuda", **kw))
        n_res, tok = 2 * b * h * bn * d, 2 * 2 * b * h * d * 2  # new tokens in, rows out
        t_bytes = (n_res * 2 + n_res * BITS // 8 + 2 * 2 * b * h * (d + bn) + tok + 16 * b
                   + (4 * b if paged else 0)) / HBM_BYTES_PER_S * 1e3
        t_ops = 8 * n_res / F32_OPS_PER_S * 1e3
        st[key + "bound_ms"] = max(t_bytes, t_ops)
        st[key + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        st[key + "bound_ms_no_flush"] = (tok + 16 * b) / HBM_BYTES_PER_S * 1e3
        st[key + "launch_floor_ms"] = floor_ms
        st[key + "shape"] = dict(B=b, H_kv=h, d=d, bits=BITS, block_n=bn, k_gran="channel",
                                 **({"P": arrays[0].shape[0], "nb_max": table.shape[1]} if paged
                                    else {"nb": nb}), pack_blocks=pb0.tolist())
        log(f"  time {name} {key or 'llama3_'}{st[key + 'shape']}: append mode "
            f"{st[key + 'ms'] * 1e3:.1f} us a flush step / {st[key + 'ms_no_flush'] * 1e3:.1f} "
            f"without (plain {st[key + 'plain_ms'] * 1e3:.1f} / "
            f"{st[key + 'plain_ms_no_flush'] * 1e3:.1f}; the parent's unfused step "
            f"{st[key + 'unfused_ms'] * 1e3:.1f} / {st[key + 'unfused_ms_no_flush'] * 1e3:.1f}); "
            f"mode flush {st[key + 'flush_mode_ms'] * 1e3:.1f} / "
            f"{st[key + 'flush_mode_ms_no_flush'] * 1e3:.1f}; bound "
            f"{st[key + 'bound_ms'] * 1e3:.2f} ({st[key + 'bound_by']}) / "
            f"{st[key + 'bound_ms_no_flush'] * 1e3:.3f} us; launch floor {floor_ms * 1e3:.1f} us")

    floor_ms = time_ms(lambda: torch.cuda._sleep(0))  # an empty kernel: the launch floor
    for paged in (False, True):
        for key, (h_, d_) in (("", (h, d)), ("gemma_", (16, 256)), ("zamba2_", ZAMBA_KV)):
            time_flush(paged, h_, d_, key)
    # flash_prefill at the dense prefills' shapes (llama3-8b in phase 3,
    # gemma-7b in phase 5) and at long context (llama3-8b, one 8,192-token
    # prompt), in the model's [B, S, H, d] layout, beside PyTorch's
    # scaled_dot_product_attention on contiguous [B, H, S, d]; the plain
    # version is not timed at 8,192 (its f32 score matrix alone is 8.6 GB)
    for key, (b, hq, hkv, s, d) in (("", (4, 32, 8, 2048, 128)),
                                    ("gemma_", (4, 16, 16, 1200, 256)),
                                    ("long_", (1, 32, 8, 8192, 128))):
        q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fp = lambda impl: fp_ops.flash_prefill_attention(  # noqa: E731
            q, k, v, layout="bshd", impl=impl)
        st = stats["flash_prefill"]
        st[key + "ms"] = time_ms(lambda: fp("cuda"))
        st[key + "plain_ms"] = time_ms(lambda: fp("torch"), iters=3) if key != "long_" else None
        st[key + "library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * s
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        ops = 4 * b * hq * d * (s * (s + 1) // 2)  # QK^T and PV over the causal half
        t_ops = ops / BF16_OPS_PER_S * 1e3
        st[key + "bound_ms"] = max(t_bytes, t_ops)
        st[key + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        st[key + "shape"] = dict(B=b, Hq=hq, Hkv=hkv, S=s, d=d)
        st[key + "tflops"] = ops / st[key + "ms"] / 1e9
        st[key + "share_of_bound"] = st[key + "bound_ms"] / st[key + "ms"]
        st[key + "vs_library"] = st[key + "ms"] / st[key + "library_ms"]
        plain = "not timed" if st[key + "plain_ms"] is None else f"{st[key + 'plain_ms'] * 1e3:.1f} us"
        log(f"  time flash_prefill {st[key + 'shape']}: kernel {st[key + 'ms'] * 1e3:.1f} us "
            f"({st[key + 'tflops']:.0f} TFLOP/s, {st[key + 'share_of_bound']:.1%} of the bound), "
            f"plain {plain}, scaled_dot_product_attention {st[key + 'library_ms'] * 1e3:.1f} us "
            f"(kernel / sdpa {st[key + 'vs_library']:.2f}), bound {st[key + 'bound_ms'] * 1e3:.2f} "
            f"us ({st[key + 'bound_by']})")
        del q, k, v, qh, kh, vh
    # the MLA modes at deepseek-v3's full width (the "mla_" keys): K3 at phase
    # 8's final dense-loop lengths (4,814 tokens over B 4, g 128, the latent
    # 576 / 512) with the draft read at SPEC_BITS, K4 at the serve phase's
    # lengths over its pool and a scrambled table; K2 / K5's append on a
    # step that flushes every row and on one that flushes none; K6 through
    # the padded route at the dense loop's prefill (B 4, S 1,200, 128 / 128
    # heads, d_k 192, d_v 128), beside scaled_dot_product_attention on the
    # unpadded [B, H, S, d] inputs
    def time_latent_decode(paged, pb, rl):
        name = "paged_bitdecode" if paged else "bitdecode"
        b_, g_, dk, dv = 4, 128, 576, 512
        if paged:
            rows = kq_ops.quantize_kv(randn(1, 1, n_pages * bn, dk), BITS, "channel", block_n=bn)
            cache = [x[0].movedim(1, 0).contiguous() for x in rows]
            tbl = (b_ + torch.randperm(n_pages - b_, generator=gen, device=dev)[:b_ * nb_max]
                   ).reshape(b_, nb_max).to(torch.int32)
        else:
            cache = list(kq_ops.quantize_kv(randn(b_, 1, 11 * bn, dk), BITS, "channel",
                                            block_n=bn))
        q_, k_res_ = randn(b_, 1, g_, dk), randn(b_, 1, bn, dk)
        pbt, rlt = ints(pb), ints(rl)
        kw = dict(bits=BITS, block_n=bn, k_gran="channel", shared_kv=True, d_v=dv,
                  sm_scale=mla_sm)
        if paged:
            call = lambda impl, **x: pg_ops.paged_bitdecode_attention(  # noqa: E731
                q_, *cache, None, None, None, k_res_, None, tbl, pbt, rlt, impl=impl, **kw, **x)
        else:
            call = lambda impl, **x: bd_ops.bitdecode_attention(  # noqa: E731
                q_, *cache, None, None, None, k_res_, None, pbt, rlt, impl=impl, **kw, **x)
        st = stats[name]
        st["mla_ms"] = time_ms(lambda: call("cuda"))
        st["mla_plain_ms"] = time_ms(lambda: call("torch"), iters=3)
        if not paged:
            st["mla_draft_ms"] = time_ms(lambda: call("cuda", draft_bits=SPEC_BITS))
        nb_ = tbl.shape[1] if paged else 11
        st["mla_num_splits"] = bd_ops.resolve_num_splits(
            "auto", b_, 1, bd_ops.work_units(nb_, bn, BITS, bn), dev, g=g_, d=dk, block_n=bn,
            bits=BITS, shared_kv=True, d_v=dv)
        tokens = sum(pb) * bn + sum(rl)
        nbytes = (sum(pb) * (npr * dk * 4 + 2 * 2 * dk) + sum(rl) * dk * 2 + q_.numel() * 2
                  + 8 * b_ + (4 * sum(pb) if paged else 0) + b_ * g_ * (dv + 1) * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * g_ * (dk + dv) * tokens / BF16_OPS_PER_S * 1e3
        st["mla_bound_ms"] = max(t_bytes, t_ops)
        st["mla_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        st["mla_shape"] = dict(B=b_, H_kv=1, g=g_, d_k=dk, d_v=dv, nb=nb_, pack_blocks=pb,
                               res_len=rl, tokens=tokens)
        st["mla_share_of_bound"] = st["mla_bound_ms"] / st["mla_ms"]
        log(f"  time {name} mla_{st['mla_shape']}: call {st['mla_ms'] * 1e3:.1f} us "
            f"({st['mla_num_splits']} splits, {st['mla_share_of_bound']:.1%} of the bound), "
            f"plain {st['mla_plain_ms'] * 1e3:.1f} us, bound {st['mla_bound_ms'] * 1e3:.2f} us "
            f"({st['mla_bound_by']})"
            + ("" if paged else f"; the draft read at {SPEC_BITS} bits "
               f"{st['mla_draft_ms'] * 1e3:.1f} us"))

    def time_latent_flush(paged):
        name = "paged_residual_flush" if paged else "residual_flush"
        st, d_ = stats[name], 576
        rows = kq_ops.quantize_kv(randn(1 if paged else b, 1, (n_pages if paged else nb) * bn, d_),
                                  BITS, "channel", block_n=bn)
        arrays = ([x[0].movedim(1, 0).contiguous() for x in rows] if paged else list(rows))
        arrays += [randn(b, 1, bn, d_)]
        pb0 = ints(pb_serve if paged else pb_main)
        lens = [pb0.clone(), ints([0] * b), ints([0] * b)]
        lens = [table, *lens] if paged else lens
        k_new = randn(b, 1, 1, d_)
        kw = dict(bits=BITS, block_n=bn, k_gran="channel", shared_kv=True)
        fused = rf_ops.paged_append_flush if paged else rf_ops.append_flush
        for rl, sfx in ((bn - 1, ""), (5, "_no_flush")):
            def prep(rl=rl):
                lens[-3].copy_(pb0)
                lens[-2].fill_(rl)
            for field, impl in (("mla_ms", "cuda"), ("mla_plain_ms", "torch")):
                st[field + sfx] = time_ms(lambda: fused(
                    *arrays[:3], None, None, None, arrays[3], None, k_new, None, *lens,
                    impl=impl, **kw), prep=prep)
        n_res, tok = b * bn * d_, 2 * b * d_ * 2
        t_bytes = (n_res * 2 + n_res * BITS // 8 + 2 * 2 * b * d_ + tok + 16 * b
                   + (4 * b if paged else 0)) / HBM_BYTES_PER_S * 1e3
        t_ops = 8 * n_res / F32_OPS_PER_S * 1e3
        st["mla_bound_ms"] = max(t_bytes, t_ops)
        st["mla_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        st["mla_bound_ms_no_flush"] = (tok + 16 * b) / HBM_BYTES_PER_S * 1e3
        st["mla_shape"] = dict(B=b, H_kv=1, d=d_, bits=BITS, block_n=bn, shared_kv=True,
                               pack_blocks=pb0.tolist())
        log(f"  time {name} mla_{st['mla_shape']}: append mode {st['mla_ms'] * 1e3:.1f} us a "
            f"flush step / {st['mla_ms_no_flush'] * 1e3:.1f} without (plain "
            f"{st['mla_plain_ms'] * 1e3:.1f} / {st['mla_plain_ms_no_flush'] * 1e3:.1f}); bound "
            f"{st['mla_bound_ms'] * 1e3:.2f} ({st['mla_bound_by']}) / "
            f"{st['mla_bound_ms_no_flush'] * 1e3:.3f} us")

    b, h, d, g, bn = 4, 8, 128, 4, BLOCK_N
    time_latent_decode(False, MLA_PB, MLA_RL)
    time_latent_decode(True, pb_serve, rl_serve)
    for paged in (False, True):
        time_latent_flush(paged)
    b_, s_, h_, dk_, dv_ = 4, max(FAMILY_PROMPT_LENS), 128, 192, 128
    q, k, v = randn(b_, s_, h_, dk_), randn(b_, s_, h_, dk_), randn(b_, s_, h_, dv_)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    st = stats["flash_prefill"]
    st["mla_ms"] = time_ms(lambda: catt.blockwise_attention(q, k, v, sm_scale=mla_sm, impl="cuda"))
    st["mla_plain_ms"] = time_ms(lambda: catt.blockwise_attention(q, k, v, sm_scale=mla_sm,
                                                                  impl="torch"), iters=3)
    st["mla_library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, scale=mla_sm))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + b_ * s_ * h_ * dv_)
    ops = 2 * b_ * h_ * (dk_ + dv_) * (s_ * (s_ + 1) // 2)  # QK^T and PV over the causal half
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    st["mla_bound_ms"] = max(t_bytes, t_ops)
    st["mla_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    st["mla_shape"] = dict(B=b_, Hq=h_, Hkv=h_, S=s_, d_k=dk_, d_v=dv_, padded_to=256)
    st["mla_share_of_bound"] = st["mla_bound_ms"] / st["mla_ms"]
    st["mla_vs_library"] = st["mla_ms"] / st["mla_library_ms"]
    log(f"  time flash_prefill mla_{st['mla_shape']} (the padded route, pad copies and slice "
        f"included): {st['mla_ms'] * 1e3:.1f} us ({st['mla_share_of_bound']:.1%} of the bound), "
        f"plain {st['mla_plain_ms'] * 1e3:.1f} us, scaled_dot_product_attention "
        f"{st['mla_library_ms'] * 1e3:.1f} us (ours / sdpa {st['mla_vs_library']:.2f}), bound "
        f"{st['mla_bound_ms'] * 1e3:.2f} us ({st['mla_bound_by']})")
    del q, k, v, qh, kh, vh
    # K6 through the padded route at zamba2-7b's prefill (B 4, S 2,000, 32 /
    # 32 heads, d 112 -> 128, pad copies and slice included), beside
    # scaled_dot_product_attention on the unpadded [B, H, S, d] inputs
    b_, s_ = 4, HYBRID_PROMPT
    q, k, v = randn(b_, s_, zh, zd), randn(b_, s_, zh, zd), randn(b_, s_, zh, zd)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    st = stats["flash_prefill"]
    st["zamba2_ms"] = time_ms(lambda: catt.blockwise_attention(q, k, v, impl="cuda"))
    st["zamba2_plain_ms"] = time_ms(lambda: catt.blockwise_attention(q, k, v, impl="torch"),
                                    iters=3)
    st["zamba2_library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    nbytes = 2 * 4 * q.numel()  # q, k, v in, o out, unpadded bf16
    ops = 4 * b_ * zh * zd * (s_ * (s_ + 1) // 2)  # QK^T and PV over the causal half
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    st["zamba2_bound_ms"] = max(t_bytes, t_ops)
    st["zamba2_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    st["zamba2_shape"] = dict(B=b_, Hq=zh, Hkv=zh, S=s_, d=zd, padded_to=128)
    st["zamba2_share_of_bound"] = st["zamba2_bound_ms"] / st["zamba2_ms"]
    st["zamba2_vs_library"] = st["zamba2_ms"] / st["zamba2_library_ms"]
    log(f"  time flash_prefill zamba2_{st['zamba2_shape']} (the padded route, pad copies and "
        f"slice included): {st['zamba2_ms'] * 1e3:.1f} us ({st['zamba2_share_of_bound']:.1%} of "
        f"the bound), plain {st['zamba2_plain_ms'] * 1e3:.1f} us, scaled_dot_product_attention "
        f"{st['zamba2_library_ms'] * 1e3:.1f} us (ours / sdpa {st['zamba2_vs_library']:.2f}), "
        f"bound {st['zamba2_bound_ms'] * 1e3:.2f} us ({st['zamba2_bound_by']})")
    del q, k, v, qh, kh, vh
    # K6's full mode at seamless-m4t-medium's cross prefill (B 4, 16 / 16
    # heads of 64, S 100 decoder tokens over T 4,096 frames; one 128-row
    # q-tile a (row, head): 64 work tiles on the SMs, no split over T), beside
    # scaled_dot_product_attention (non-causal) on contiguous [B, H, S, d]
    b_, h_, s_, t_, d_ = 4, 16, ENCDEC_PROMPT, 4096, 64
    q, k, v = randn(b_, s_, h_, d_), randn(b_, t_, h_, d_), randn(b_, t_, h_, d_)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fp = lambda impl: fp_ops.flash_prefill_attention(  # noqa: E731
        q, k, v, causal=False, layout="bshd", impl=impl)
    st = stats["flash_prefill"]
    st["cross_ms"] = time_ms(lambda: fp("cuda"))
    st["cross_plain_ms"] = time_ms(lambda: fp("torch"), iters=3)
    st["cross_library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b_ * h_ * s_  # lse f32
    ops = 4 * b_ * h_ * s_ * t_ * d_  # QK^T and PV over every key
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    st["cross_bound_ms"] = max(t_bytes, t_ops)
    st["cross_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    st["cross_shape"] = dict(B=b_, Hq=h_, Hkv=h_, S=s_, T=t_, d=d_, causal=False)
    st["cross_work_tiles"] = fp_ops.work_tiles(b_, h_, s_)
    st["cross_share_of_bound"] = st["cross_bound_ms"] / st["cross_ms"]
    st["cross_vs_library"] = st["cross_ms"] / st["cross_library_ms"]
    log(f"  time flash_prefill cross_{st['cross_shape']}: kernel {st['cross_ms'] * 1e3:.1f} us "
        f"({st['cross_work_tiles']} work tiles on {sms} SMs, {st['cross_share_of_bound']:.1%} of "
        f"the bound), plain {st['cross_plain_ms'] * 1e3:.1f} us, scaled_dot_product_attention "
        f"{st['cross_library_ms'] * 1e3:.1f} us (kernel / sdpa {st['cross_vs_library']:.2f}), "
        f"bound {st['cross_bound_ms'] * 1e3:.2f} us ({st['cross_bound_by']}: "
        f"{nbytes / 1e6:.1f} MB)")
    del q, k, v, qh, kh, vh
    # K3 at seamless-m4t-medium's static cross read (16 KV heads of 64, g 1, 32
    # packed blocks, an empty residual) and at qwen2-vl-7b's decode shape (4 KV
    # heads of 128, g 7) after phase 11's loop
    time_decode("cross_", False, 4, 16, 1, 64, CROSS_PB, CROSS_RL,
                decode_cache(False, 4, 16, 64, CROSS_PB[0]))
    time_decode("qwen2vl_", False, 4, 4, 7, 128, VLM_PB, VLM_RL,
                decode_cache(False, 4, 4, 128, max(VLM_PB) + 1))
    splitkv_kernel_phase(check, stats, dev, gen, time_ms)
    for name, st in stats.items():
        if name != "flash_prefill":  # its shapes are printed above
            log(f"  time {name}: kernel {st['ms'] * 1e3:.1f} us, plain {st['plain_ms'] * 1e3:.1f} "
                f"us, bound {st['bound_ms'] * 1e3:.2f} us ({st['bound_by']})")
    del scrub, packed, res, x, pool
    sass_checks(check, sass_job, len(fp_ops.HEAD_DIMS))

    # ------------------------------------------------------------ 3. end to end
    log(f"== 3. end to end: llama3-8b, full width and depth (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    cfg, model, params, n_params = build_random("llama3-8b", dev)
    dense = dense_phase(model, params, cfg, check, dev, PROMPT_LENS, DECODE_STEPS, split3=True,
                        captured=True)
    launches = dict(dense.pop("launches"))

    # ------------------------------------------------------------ 4. serve
    log(f"== 4. serve: llama3-8b behind the paged engine, full width and depth (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    serve = serve_phase(model, params, cfg, check, dev)
    t_lm = time.perf_counter()
    serve["splitkv"] = splitkv_serve_runs(model, params, cfg, check, dev, serve.pop("streams"))
    serve["report"]["splitkv"] = serve["splitkv"]
    log(f"  runs (l) and (m) took {time.perf_counter() - t_lm:.1f} s")
    serve["report"]["device_profile"] = serve_profile(model, params, cfg, dev)
    log_profile("serve engine cycle, 4 slots decoding", serve["report"]["device_profile"])
    launches.update({k: v for k, v in serve["launches"].items() if k not in DENSE_PATH})
    for name in SERVE_PATH:
        n = serve["launches"].get(name, 0)
        check(n > 0, f"{name} launched in serve run (a) ({n})")
    del model, params
    gc.collect()  # the engines' logit captures form reference cycles
    torch.cuda.empty_cache()

    # ------------------------------------------------- 5.-6. the dense family
    family = {}
    for name, change in FAMILY:
        phase = 5 if name == "gemma-7b" else 6
        cut = f", cut to {change['n_layers']} layers" if "n_layers" in change else ""
        log(f"== {phase}. {name} at full width{cut or ' and depth'}: the dense loop"
            + (" and the engine" if phase == 5 else "")
            + f" (at {time.perf_counter() - t_start:.1f} s)")
        cfg, model, params, n = build_random(name, dev, **change)
        rep = dense_phase(model, params, cfg, check, dev, FAMILY_PROMPT_LENS, FAMILY_STEPS)
        rep |= {"n_params": n, "cut": cut.lstrip(", ") or None}
        if phase == 5:
            sv = serve_phase(model, params, cfg, check, dev, names="abe", profile_replay=False)
            for k in SERVE_PATH:
                cnt = sv["launches"].get(k, 0)
                check(cnt > 0, f"{name}: {k} launched in serve run (a) ({cnt})")
            rep |= {"serve": sv["report"], "serve_launches": sv["launches"],
                    "async_launches": sv["async_launches"]}
        family[name] = rep
        del model, params
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ 7. MoE
    name, change = MOE
    log(f"== 7. {name} at full width, cut to {change['n_layers']} layers: the dense loop and "
        f"the engine (at {time.perf_counter() - t_start:.1f} s)")
    t_moe = time.perf_counter()
    cfg, model, params, n = build_random(name, dev, **change)
    rep = dense_phase(model, params, cfg, check, dev, FAMILY_PROMPT_LENS, FAMILY_STEPS,
                      split3=True)
    sv = serve_phase(model, params, cfg, check, dev, names="ae", profile_replay=False)
    for k in SERVE_PATH:
        cnt = sv["launches"].get(k, 0)
        check(cnt > 0, f"{name}: {k} launched in serve run (a) ({cnt})")
    family[name] = rep | {"n_params": n, "cut": f"cut to {change['n_layers']} layers",
                          "serve": sv["report"], "serve_launches": sv["launches"],
                          "async_launches": sv["async_launches"],
                          "phase_s": time.perf_counter() - t_moe}
    log(f"  phase 7 took {family[name]['phase_s']:.1f} s")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 8. MLA
    name, change = MLA
    log(f"== 8. {name} at full width, cut to {change['n_layers']} layers: the dense loop and "
        f"the engine on the MLA latent cache (at {time.perf_counter() - t_start:.1f} s)")
    t_mla = time.perf_counter()
    cfg, model, params, n = build_random(name, dev, **change)
    log(f"  MLA: q_lora {cfg.q_lora}, kv_lora {cfg.kv_lora}, qk_nope {cfg.qk_nope}, qk_rope "
        f"{cfg.qk_rope}, v_head_dim {cfg.v_head_dim}: one latent head of "
        f"{cfg.kv_lora + cfg.qk_rope} channels (d_v {cfg.kv_lora}) read by g = {cfg.n_heads}; "
        f"stacks {model.stacks}")
    rep = dense_phase(model, params, cfg, check, dev, FAMILY_PROMPT_LENS, FAMILY_STEPS,
                      split3=True, excuse_reroutes=True)
    sv = serve_phase(model, params, cfg, check, dev, names="ae", profile_replay=False)
    for k in SERVE_PATH:
        cnt = sv["launches"].get(k, 0)
        check(cnt > 0, f"{name}: {k} launched in serve run (a) ({cnt})")
    k3 = stats["bitdecode"]
    ms = rep["device_profile"]["moe_step"]
    log(f"  {name} decode step beside its bounds: attention kernels {ms['attention_ms']:.3f} ms "
        f"(K3 alone at these lengths {k3['mla_ms'] * 1e3:.1f} us a call in phase 2 against its "
        f"bound {k3['mla_bound_ms'] * 1e3:.2f} us, {k3['mla_bound_by']}), absorbed products "
        f"{ms['absorbed_ms']:.3f} ms, expert products {ms['experts_ms']:.3f} ms (bound "
        f"{ms['experts_all_bound_ms']:.3f} ms), unembed {ms['unembed_ms']:.3f} ms, the rest "
        f"{ms['rest_ms']:.3f} ms; the step "
        f"{ms['all_ms']:.3f} ms against {ms['step_bound_ms']:.3f} ms reading its weights once")
    family[name] = rep | {"n_params": n, "cut": f"cut to {change['n_layers']} layers",
                          "serve": sv["report"], "serve_launches": sv["launches"],
                          "async_launches": sv["async_launches"],
                          "phase_s": time.perf_counter() - t_mla}
    log(f"  phase 8 took {family[name]['phase_s']:.1f} s")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 9. hybrid
    name = HYBRID
    log(f"== 9. {name} at full width, cut to {HYBRID_LAYERS} layers: the dense loop and the "
        f"engine on the Mamba2 hybrid (at {time.perf_counter() - t_start:.1f} s)")
    t_hyb = time.perf_counter()
    cfg, model, params, n = build_random(name, dev, n_layers=HYBRID_LAYERS)
    log(f"  hybrid: {model.n_super} super-blocks of {cfg.attn_every} Mamba2 layers and the "
        f"shared attention + MLP block, a tail of {model.tail}; Mamba2 d_inner "
        f"{cfg.mamba_d_inner}, {cfg.mamba_heads} heads, ssm_state {cfg.ssm_state}, groups "
        f"{cfg.mamba_groups}, chunk {cfg.mamba_chunk}")
    rep = dense_phase(model, params, cfg, check, dev, (HYBRID_PROMPT,) * 4, HYBRID_STEPS,
                      split3=True)
    sv = serve_phase(model, params, cfg, check, dev, names="aeg", profile_replay=False)
    for k in SERVE_PATH:
        cnt = sv["launches"].get(k, 0)
        check(cnt > 0, f"{name}: {k} launched in serve run (a) ({cnt})")
    family[name] = rep | {"n_params": n, "cut": f"cut to {HYBRID_LAYERS} layers",
                          "serve": sv["report"], "serve_launches": sv["launches"],
                          "async_launches": sv["async_launches"],
                          "spec_launches": sv["spec_launches"],
                          "phase_s": time.perf_counter() - t_hyb}
    log(f"  phase 9 took {family[name]['phase_s']:.1f} s")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------- 10.-11. the stub-front families
    for phase, name, change, text_lens, steps in (
            (10, ENCDEC, {}, (ENCDEC_PROMPT,) * 4, ENCDEC_STEPS),
            (11, VLM[0], VLM[1], VLM_TEXT_LENS, VLM_STEPS)):
        cut = f", cut to {change['n_layers']} layers" if change else " and depth"
        log(f"== {phase}. {name} at full width{cut}: the dense loop (the engine refuses it) (at "
            f"{time.perf_counter() - t_start:.1f} s)")
        t_ph = time.perf_counter()
        cfg, model, params, n = build_random(name, dev, **change)
        if cfg.encdec:
            log(f"  encoder-decoder: {cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, "
                f"{cfg.enc_len} stub frames, LayerNorm, GELU, biases; cross attention over a "
                "static 4-bit cache")
        else:
            log(f"  VLM stub: {cfg.n_patches} stub patches on a {cfg.patch_grid} grid, M-RoPE "
                f"sections {cfg.mrope_sections}, g {cfg.g_q}, QKV biases")
        rep = front_phase(model, params, cfg, check, dev, text_lens, steps)
        family[name] = rep | {"n_params": n, "cut": cut.lstrip(", ") if change else None,
                              "phase_s": time.perf_counter() - t_ph}
        log(f"  phase {phase} took {family[name]['phase_s']:.1f} s")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()

    # ---------------------------------------- 12. xLSTM and the exact-length shim
    log(f"== 12. (A) {XLSTM} at full width and depth: the dense loop and the engine's "
        f"exact-length shim (at {time.perf_counter() - t_start:.1f} s)")
    t_12 = time.perf_counter()
    cfg, model, params, n = build_random(XLSTM, dev)
    log(f"  xLSTM: {model.n_super} super-blocks of {cfg.mlstm_per_slstm} mLSTM + 1 sLSTM, "
        f"{cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}; chunkwise chunk "
        f"{cfg.xlstm_time_chunk}")
    rep = xlstm_phase(model, params, cfg, check, dev)
    chunked = build_model(cfg.with_(xlstm_chunkwise=True))
    runs = {"a": {}, "e": dict(async_runtime=True, async_window=ASYNC_WINDOW),
            "g": dict(spec_k=SPEC_K, spec_bits=SPEC_BITS)}
    sv = shim_serve(chunked, params, cfg, check, dev, xlstm_workload(cfg.vocab), runs,
                    max_seq=XLSTM_MAX_SEQ, path=())
    check(sv["report"]["g"]["spec_accept_rate"] == 1.0,
          f"{XLSTM} shim run (g): every draft accepted (spec_accept_rate "
          f"{sv['report']['g']['spec_accept_rate']:.3f}: the draft runs the same math)")
    family[XLSTM] = rep | {"n_params": n, "cut": None, "serve": sv["report"],
                           "shim_launches": sv["launches"]}
    del model, chunked, params
    gc.collect()
    torch.cuda.empty_cache()
    name, change = SHIM
    log(f"== 12. (B) {name} at full width, cut to {change['n_layers']} layers, through the "
        f"forced exact-length shim (paged=False) (at {time.perf_counter() - t_start:.1f} s)")
    split_ranks = SplitRanks()  # phase 13's ranks set up meanwhile, off the card
    cfg, model, params, n = build_random(name, dev, **change)
    shim = shim_phase(model, params, cfg, check, dev) | {
        "n_params": n, "cut": f"cut to {change['n_layers']} layers"}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t_12 = time.perf_counter() - t_12
    family[XLSTM]["phase_s"] = t_12
    log(f"  phase 12 took {t_12:.1f} s")

    # -------------------------------------------------------------- the CLI
    log(f"== the serve CLI, async runtime, smoke llama3-8b (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    cli = serve_cli(check)

    # ----------------------------------------------- 13. split-KV on 4 ranks
    log(f"== 13. split-KV on {SPLIT_RANKS} ranks sharing the card (gloo): (A) the walk at "
        f"{LONG_TOKENS} tokens, (B) the page-affine engine (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    ranks = splitkv_ranks_phase(check, split_ranks, dev)

    # --------------------------------------------------- 14. training on one device
    log(f"== 14. training: (A) {TRAIN[0]} at full width, cut to {TRAIN[1]['n_layers']} "
        f"layers, batch {TRAIN_BATCH} x 4,096; (B) the train CLI with a rollback and a resume; "
        f"(C) the other families' smoke configs (at {time.perf_counter() - t_start:.1f} s)")
    train = train_phase(check, dev)

    # ------------------------------------------------------------ 15. summary
    rows = []
    for name, meta in KERNELS.items():
        st = stats[name]
        by_path = {"llama3-8b dense": launches.get(name, 0) if name in DENSE_PATH else 0,
                   "llama3-8b dense captured": dense["captured"]["launches"].get(name, 0),
                   "llama3-8b serve (a)": serve["launches"].get(name, 0),
                   "llama3-8b serve (e), async": serve["async_launches"].get(name, 0),
                   **{f"llama3-8b serve ({r}), spec": n.get(name, 0)
                      for r, n in serve["spec_launches"].items()}}
        for fam, rep in family.items():
            by_path[f"{fam} dense"] = rep["launches"].get(name, 0)
            if "serve_launches" in rep:
                by_path[f"{fam} serve (a)"] = rep["serve_launches"].get(name, 0)
                by_path[f"{fam} serve (e), async"] = rep["async_launches"].get(name, 0)
            for r, cnt in rep.get("spec_launches", {}).items():
                by_path[f"{fam} serve ({r}), spec"] = cnt.get(name, 0)
            for r, cnt in rep.get("shim_launches", {}).items():
                by_path[f"{fam} shim ({r})"] = cnt.get(name, 0)
        for r, cnt in shim["launches"].items():
            by_path[f"llama3-8b shim ({r})"] = cnt.get(name, 0)
        for r, rep in serve["splitkv"].items():
            by_path[f"llama3-8b serve ({r}), split-KV async"] = rep["launches"].get(name, 0)
        for rep in ranks.get("ranks", ()):
            by_path[f"phase 13 rank {rep['rank']}, walk + engine"] = (
                rep.get("walk_launches", {}).get(name, 0)
                + rep.get("engine_launches", {}).get(name, 0))
        rows.append({
            "name": name, "route": "cuda", **meta, "launches": launches.get(name, 0),
            "serve_launches": serve["launches"].get(name, 0),
            "async_launches": serve["async_launches"].get(name, 0),
            "shim_launches": shim["launches"]["i"].get(name, 0),
            "launches_by_path": by_path,
            "parity": "bitwise" if name in BITWISE else TOLERANCE[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st.get("library_ms"),
            "us": st["ms"] * 1e3, "plain_us": st["plain_ms"] * 1e3, "bound_us": st["bound_ms"] * 1e3,
            "library_us": None if "library_ms" not in st else st["library_ms"] * 1e3,
            **{k: v for k, v in st.items() if k in ("ms_no_flush", "plain_ms_no_flush",
                                                    "num_splits", "shape")
               or k.startswith(("gemma_", "long_", "starcoder2_", "unfused_", "flush_mode_",
                                "bound_ms_no_flush", "launch_floor", "v_", "pair_",
                                "fill_parent_", "draft_", "mla_", "zamba2_", "cross_",
                                "qwen2vl_", "window_"))
               or k in ("tflops", "share_of_bound", "vs_library")},
        })
    total_s = time.perf_counter() - t_start
    print(json.dumps({"kernels": rows, "e2e": dense, "serve": serve["report"], "family": family,
                      "shim": shim, "cli": cli, "splitkv_ranks": ranks, "train": train,
                      "n_params": n_params, "build_s": _build.build_seconds,
                      "total_s": total_s}), flush=True)
    log(f"  chip_smoke took {total_s:.1f} s, the build {_build.build_seconds:.1f} s of it")
    if check.failed:
        for what in check.failed:
            print(f"chip_smoke: FAIL {what}", file=sys.stderr)
        print(f"chip_smoke: {len(check.failed)} check(s) failed", file=sys.stderr)
        return 1
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.2f} ms"


def _num(x) -> str:
    return "none" if x is None else f"{x:.4f}"


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
