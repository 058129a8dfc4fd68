#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run in order, each of which must pass:
  1. build   — compile every hand-written kernel under ``src/repro_torch/
               kernels/csrc`` (three forward, three backward) with nvcc, one
               process per source, in parallel;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card: the shape sweeps of ``tests/test_kernels.py`` in f32 and
               bf16, the edges of the bf16 tensor-core attention kernel, plus
               the shapes the serving paths give it (the scan there in f32
               too; K2 at hd 128 and at Whisper's ragged 1500 keys, K1 at
               d = 2048);
     kernels_bwd — each backward kernel, through its autograd Function,
               against autograd through its plain version, f32 and bf16:
               the sweeps, the edges of the bf16 tensor-core attention
               kernels and of the RMSNorm backward's paths, and the shapes
               training gives it;
  3. small   — qwen2-0.5b, hymba-1.5b, falcon-mamba-7b and whisper-medium
               at ``reduced()`` in f32: the card's engine (through the
               kernels) against the CPU engine (plain versions), the hymba
               ring cache wrapped, Whisper's cross-attention made causal and
               an erf GELU planted; then qwen2-0.5b, hymba-1.5b,
               qwen2-moe-a2.7b, phi3.5-moe-42b-a6.6b and llava-next-mistral-
               7b (through ``lm.prefill(patches=)``) at full width and 2
               layers in bf16: prefill logits through the kernels against the
               plain versions, planted attention faults and the pad-expert
               mask dropped must land above the limit;
     lm_small — qwen2-0.5b, hymba-1.5b, falcon-mamba-7b, qwen2-moe-a2.7b,
               llava-next-mistral-7b and whisper-medium at full width, 2
               layers, f32: the training loss (the moe aux included) and
               every gradient leaf through the kernels (forward and
               backward) against the plain versions, the launch counts
               exact; planted backward faults (dV zeroed, the GQA sum
               dropped, ds or da skipped) must land LM_SMALL_FAULT_FACTOR
               times beyond the limit.  An moe comparison holds the plain
               run's expert choices to the kernel run's (``pinned_routes``)
               and reports how many tokens it had to move;
  4. serve   — each serving path at full width in bf16, random weights from
               seed 0, through ``ServeEngine.generate``: qwen2-0.5b (dense:
               K2, K1), hymba-1.5b (hybrid, full depth: K2, K3, K1),
               falcon-mamba-7b (ssm: K3, K1), qwen2-moe-a2.7b (moe, full
               depth: K2, K1) and whisper-medium (encdec, full depth, 1500
               source frames: K2 in prefill only).  Each path is one main
               run with the launch counts set to 0 just before and read just
               after; the counts must be exact, tokens must repeat, and the
               default ``"auto"`` engine must take every kernel too.  Where
               an f32 copy of the weights fits beside the bf16 ones (not
               qwen2-moe-a2.7b's 15 B), prefill logits in f32 must agree
               with the all-plain engine while planted kernel faults must
               not, and in bf16 the kernels must drift from the f32 run no
               further than twice what the plain versions drift;
     tier_serve — tier-fed serving: a ``StandaloneTier`` in this process
               over the PtychoNN store of the surrogate cells (8192 samples
               of 16 KiB, seed 0), its first 2048 ids resident (that
               cell's buffer) and the rest read through its PFS fallback;
               tenant 1 the serving replica (unlimited), tenant 2 a batch
               reader at 64 rows/s, burst 16.  A wrong token must raise
               ``TierAuthError``.  qwen2-0.5b at full width and depth through
               the CLI, ``python -m repro_torch.launch.serve --data-tier``
               in a child process, batch 4 from id 2046 (two hits, two PFS
               reads): it must print ``tier served 4/4`` and launch counts
               equal to ``expected_counts``, and its tokens must equal the
               same engine's here; then qwen2-0.5b and hymba-1.5b in this
               process through ``ServeEngine.generate_from_tier``, hymba's
               main run under a tenant-2 read storm that must be shed while
               tenant 1 never is.  Each main run's launch counts must equal
               ``expected_counts`` and its tokens ``generate`` on the
               store's rows mapped by ``rows_to_prompts``, exactly.  Prints a
               ``{"tier_serve": [...]}`` line;
     dist_tier_serve — the same store and tenants with the tier held by
               four launcher ranks (``run_distributed(serve_tier=)`` in a
               thread of this process, the ranks replaying a SOLAR plan with
               the peer tier on): hymba-1.5b at full width and depth serves
               batch 4 from id 2046 through ``generate_from_tier`` twice,
               alone and while tenant 2 storms from a process of its own
               (``repro_torch.serve.tenant_load``), then ``generate`` once
               with the ranks gone (no loader).  The ranks' digests must
               equal ``in_process_digests``, with no stale refusals and no
               peer fallbacks; the rows the store's; the launch counts
               ``expected_counts``; the tokens the direct-prompt run's;
               tenant 2 shed and tenant 1 never; the run still live when the
               stormed main run ends; the ranks' traces must pass
               ``repro_torch.obs.report.check``.  Prints a
               ``{"dist_tier_serve": [...]}`` line;
  5. train_small — each CNN surrogate at ``reduced()`` in f32 (TF32 off):
               five training steps through the launcher's code path on the
               card follow the same run on the CPU, in per-step loss and
               final params, within ``TRAIN_SMALL_LIMIT``; three faults
               planted by patching the model module ((1, 1) padding at n=16,
               a transposed conv without the flip, an NCDHW flatten) must
               land above it;
  6. train   — each surrogate at full width (``TRAIN``), naive then solar,
               over a synthetic binary store on local disk, through
               ``launch.train_surrogate``: the loss is finite and falls,
               every step weighs the global batch, solar's and naive's
               gradients agree at the first steps (paper Eq. 3), and a
               checkpoint at step k resumes into the same step ids.  No
               hand-written kernel lies on this path: the launch counts,
               set to 0 before each run, must read 0 after it.  Prints a
               ``{"train": [...]}`` line of step, load and loader readings;
     lm_train — hymba-1.5b at full width and depth, qwen2-0.5b at full
               width, falcon-mamba-7b at 8 of 64 layers, qwen2-moe-a2.7b at 3
               of 24, llava-next-mistral-7b at 8 of 32 (576 zero patches),
               whisper-medium whole (448 tokens, 1500 zero source frames),
               bf16, through ``launch.train`` on SOLAR-planned token
               batches: a warm-up
               step and timed steps (compute, load, wait, wall, tokens/s),
               the device time and busy share of one more step, peak
               memory; every forward and backward launch count must equal
               ``expected_train_counts`` and every loss be finite.  Prints a
               ``{"lm_train": [...]}`` line;
  7. report  — a ``{"kernels": [...]}`` JSON line (times are CUDA-event
               medians of CUDA-graph replays at the serving shapes; the
               attention row adds its TFLOP/s, the share of computed scores
               the mask admits and the f32 kernel's time, the scan row the
               time of its earlier design (built from ``kernels/baselines/``
               and timed in the same run) and its f32 error, the norm row its
               decode-row times; the backward rows at hymba-1.5b's training
               shapes and the other models' (K2 qwen2-0.5b's, K3
               falcon-mamba-7b's, K1 both), the library's backward timed
               eagerly and by its kernels' device time; K2 forward and
               backward at qwen2-moe-a2.7b's and llava-next-mistral-7b's
               training shapes (hd 128) and at whisper-medium's encoder and
               cross-attention, K1 at d = 2048), the card's name
               and power limit, and last
               the ``{"ok": true, "device": ...}`` line.

Exits non-zero and prints no result when there is no card or a phase
fails.  Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, f32 CUDA-core
# peak, HBM3 rate; special function units (exp2) per SM per clock and SMs.
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
HBM_BYTE_S = 3.35e12
SFU_PER_SM_CLK = 16
SMS = 132

# Kernel vs plain version, as in tests/test_kernels.py:35,60,72.
TOL = {
    "flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "selective_scan": {torch.float32: 1e-4, torch.bfloat16: 5e-2},
    "rms_norm": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
}
ATTN_SWEEP = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 96, 16, False, 0),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 2, 2, 80, 112, 32, False, 0),
]
# Edges of the bf16 tensor-core kernel (64-row query tiles over 64-key
# tiles), as in tests/test_torch_cuda.py: ragged Sq/Sk and Sq != Sk, windows
# that start mid-tile, GQA groups 5 and 7, hd 16/32/128, one query tile.
ATTN_TC_EDGES = [
    (1, 2, 1, 100, 150, 64, True, 0),
    (1, 2, 2, 130, 70, 64, False, 0),
    (1, 4, 2, 300, 300, 64, True, 100),
    (1, 2, 1, 200, 230, 32, False, 37),
    (1, 10, 2, 128, 128, 64, True, 0),
    (1, 14, 2, 96, 96, 64, True, 0),
    (2, 2, 1, 128, 128, 16, True, 0),
    (1, 2, 1, 160, 200, 128, True, 70),
    (2, 3, 1, 40, 40, 64, True, 0),
]
# Edges of the bf16 tensor-core backward (64 x 64 tiles), as in
# tests/test_torch_cuda.py: ragged Sq/Sk, windows mid-tile, hd 16 and 128
# with GQA groups 1 and 7, keys past every causal query row.
ATTN_BWD_TC_EDGES = [
    (1, 2, 2, 100, 150, 16, True, 0),
    (1, 14, 2, 130, 70, 128, False, 0),
    (2, 7, 1, 200, 200, 64, True, 37),
    (1, 2, 2, 190, 230, 128, True, 70),
    (1, 7, 1, 77, 300, 16, False, 100),
    (1, 4, 4, 65, 129, 64, True, 0),
]
# The shapes prefill gives the flash kernel: qwen2-0.5b (B=4, H=14, K=2,
# S=512, causal) and hymba-1.5b (B=4, H=25, K=5, S=1536, window 1024).
ATTN_QWEN = (4, 14, 2, 512, 512, 64, True, 0)
ATTN_HYMBA = (4, 25, 5, 1536, 1536, 64, True, 1024)
# The shapes the moe, vlm and encdec paths give it: qwen2-moe-a2.7b's
# prefill (H = K = 16, hd 128), whisper-medium's encoder over 1500 frames and
# its cross-attention from a 64-token prompt (both non-causal; 1500 = 23 * 64
# + 28 keys, so the last key tile is ragged), and llava-next-mistral-7b's
# training microbatch (GQA 32/8, hd 128, 576 patches + 2048 tokens).
ATTN_QWEN_MOE = (4, 16, 16, 512, 512, 128, True, 0)
ATTN_WHISPER_ENC = (4, 16, 16, 1500, 1500, 64, False, 0)
ATTN_WHISPER_CROSS = (4, 16, 16, 64, 1500, 64, False, 0)
ATTN_LLAVA_TRAIN = (4, 32, 8, 2624, 2624, 128, True, 0)
ATTN_QWEN_MOE_TRAIN = (8, 16, 16, 2048, 2048, 128, True, 0)
ATTN_SERVE = [ATTN_QWEN, ATTN_HYMBA, ATTN_QWEN_MOE, ATTN_WHISPER_ENC, ATTN_WHISPER_CROSS,
              ATTN_LLAVA_TRAIN]
# The report's forward rows at these paths' shapes (training shapes for the
# hd 128 models, serving shapes for whisper-medium).
ATTN_MORE = {"qwen2-moe-a2.7b prefill": ATTN_QWEN_MOE,
             "qwen2-moe-a2.7b train": ATTN_QWEN_MOE_TRAIN,
             "llava-next-mistral-7b train": ATTN_LLAVA_TRAIN,
             "whisper-medium encoder": ATTN_WHISPER_ENC,
             "whisper-medium cross": ATTN_WHISPER_CROSS}
# (B, S, DI, N): tests/test_kernels.py:46-48, a ragged DI, and the serving
# shapes of hymba-1.5b and falcon-mamba-7b.
SCAN_SWEEP = [(2, 64, 32, 8), (1, 96, 64, 16), (2, 50, 32, 4), (1, 100, 200, 16)]
SCAN_HYMBA = (4, 1536, 3200, 16)
SCAN_FALCON = (4, 512, 8192, 16)
# (rows, d): tests/test_kernels.py:66, then the rows of the serving paths:
# prefill (batch x prompt) and decode (batch) for qwen2-0.5b (d=896),
# hymba-1.5b (d=1600), falcon-mamba-7b (d=4096) and qwen2-moe-a2.7b
# (d=2048).
NORM_SWEEP = [(64, 128), (37, 256), (5, 64)]
NORM_HYMBA = (6144, 1600)
NORM_FALCON = (2048, 4096)
NORM_QWEN_MOE = (2048, 2048)
NORM_DECODE = [(4, 896), (4, 1600), (4, 4096), (4, 2048)]
NORM_SERVE = [(2048, 896), NORM_HYMBA, NORM_FALCON, NORM_QWEN_MOE] + NORM_DECODE

# Serving paths, each at full width and depth: (arch, batch, prompt, new tokens).
# whisper-medium's prompt follows 1500 source frames.
SERVE = [
    ("qwen2-0.5b", 4, 512, 32),
    ("hymba-1.5b", 4, 1536, 32),
    ("falcon-mamba-7b", 4, 512, 32),
    ("qwen2-moe-a2.7b", 4, 512, 32),
    ("whisper-medium", 4, 64, 32),
]
# Prefill logits through the kernels vs through the plain versions, full
# width and depth, with the weights widened to f32 and the model run in f32.
# In bf16 the comparison cannot tell a fault from rounding: with random
# weights any two bf16 paths drift apart layer by layer, and on an H100
# hymba-1.5b's bf16 plain engine lands 2.55 from its f32 run at 32 layers,
# falcon-mamba-7b's 4.70 at 64 (PERF.md §6).  In f32 the kernels read
# 1.0e-3 (hymba) and 1.9e-3 (falcon) from the plain versions; the limit sits
# 5x above that and below every planted fault.
LOGIT_ATOL_F32 = 1e-2
# The bf16 engine through the kernels must not drift from the f32 plain
# engine by more than this multiple of the bf16 plain engine's own drift.
BF16_DRIFT_RATIO = 2.0
# Small f32 check, card kernels vs CPU plain versions: a few f32 ulps per op.
SMALL_TOL = 1e-4
# bf16 prefill logits through the kernels against the plain versions at full
# width and 2 layers, the serving batch and prompt: shallow enough that bf16
# rounding cannot hide a fault of the bf16 tensor-core attention kernel,
# which the f32 checks above do not run.  On an H100 the gap read 0.049
# (qwen2) and 0.038 (hymba), the planted attention faults 0.33-6.96; the
# limit sits 3x above the gap and 2x below the smallest fault (PERF.md §6).
SMALL_BF16 = [("qwen2-0.5b", 4, 512), ("hymba-1.5b", 4, 1536), ("qwen2-moe-a2.7b", 4, 512),
              ("phi3.5-moe-42b-a6.6b", 4, 512), ("llava-next-mistral-7b", 4, 512)]
SMALL_BF16_ATOL = 0.15

# Tier-fed serving: (arch, batch, prompt, new tokens, run through the CLI),
# over the PtychoNN store of the surrogate cells (8192 samples of 64x64x1
# f32, 16 KiB each, seed 0) with its first 2048 ids resident and the batch
# read from id 2046, across that edge.  Tenant 2 is a batch reader held to
# 64 rows/s with a burst of 16; its storm reads 8 ids every 2 ms.
TIER_SERVE = [("qwen2-0.5b", 4, 512, 32, True), ("hymba-1.5b", 4, 1536, 32, False)]
TIER_SAMPLES, TIER_RESIDENT, TIER_FIRST_ID = 8192, 2048, 2046
TIER_TOKENS = {1: "serving-replica", 2: "batch-reader"}
TIER_BATCH_RATE, TIER_BATCH_BURST = 64.0, 16.0
TIER_STORM_IDS, TIER_STORM_PAUSE_S = 8, 0.002
TIER_CLI_TIMEOUT_S = 600

# The same store and tenants with the tier held by launcher ranks (the JAX
# package's layout, DESIGN.md §12): 4 rank processes replay a SOLAR plan over
# the store (local batch 16, buffer 2048, peer tier on, capacity factor 1.0,
# prefetch depth 1) and serve tenants from their live buffers; hymba-1.5b
# serves batch 4 from id 2046 through them, once alone and once while
# tenant 2 storms from a process of its own.  The run must still be live
# when the stormed main run ends: the ranks took ~3.5 ms a step on the H100
# machine (16 epochs of 128 steps were over within ~8 s of the tier coming
# up), so 64 epochs last ~30 s, and the serving side needs ~11 s of it.
DIST_TIER = ("hymba-1.5b", 4, 1536, 32)
DIST_TIER_NODES, DIST_TIER_LOCAL_BATCH, DIST_TIER_BUFFER = 4, 16, 2048
DIST_TIER_EPOCHS, DIST_TIER_DEPTH = 64, 1
DIST_TIER_TIMEOUT_S = 600

# Surrogate training, card against CPU at reduced() in f32 with TF32 off:
# the drift is the larger of the per-step losses' relative difference and
# the final params' relative L2 difference after TRAIN_SMALL_STEPS solar
# steps.  Both runs take the same batches from the same plan and start from
# the same params, so only the f32 order of the convolutions' sums differs
# (~1e-6 relative, tests/test_torch_cnn.py); one Adam step can turn an
# element whose gradient is that close to 0 the other way, which moves the
# params' L2 by ~2e-4 relative.  A planted fault changes every step.
TRAIN_SMALL_STEPS = 5
TRAIN_SMALL_LIMIT = 1e-3
# Faults planted in the card's run, and the surrogates each one reaches.
TRAIN_FAULTS = {
    "pad (1, 1) at n=16": ("ptychonn", "autophasenn", "cosmoflow"),
    "conv transpose without the flip": ("ptychonn", "autophasenn"),
    "NCDHW flatten": ("cosmoflow",),
}
# Full-width training: (arch, samples, nodes, local batch, buffer, steps).
# Samples are 16 KiB (ptychonn 64x64x1), 128 KiB (autophasenn 32^3x1) and
# 4 MiB (cosmoflow 64^3x4) of f32.
TRAIN = [
    ("ptychonn", 8192, 4, 16, 2048, 200),
    ("autophasenn", 2048, 4, 8, 256, 100),
    ("cosmoflow", 512, 4, 4, 64, 50),
]
# solar's and naive's weighted-sum gradients at the first steps: the same
# global batch in another row order, f32 sums over up to 64 rows and every
# spatial position; limit on max |diff| over the leaf's max |g|.
TRAIN_GRAD_STEPS = 3
TRAIN_GRAD_TOL = 1e-4
# the resume check: checkpoint at step k, resume, train k more steps; their
# losses against the uninterrupted run's (cuDNN may sum in another order).
TRAIN_RESUME_AT = 5
TRAIN_RESUME_RTOL = 1e-3

# Backward kernels against autograd through their plain versions: max |diff|
# over max |reference| (at least 1) of each gradient.  f32: sums in another
# order; bf16: bf16 outputs, and for attention the bf16 forward's rounding of
# P and O, which the backward reads back through D = rowsum(dO O).
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The shapes training gives each backward kernel: a microbatch of 2 (hymba,
# falcon; qwen2 4) sequences of 2048 tokens.
# qwen2-moe-a2.7b 8 (hd 128), llava-next-mistral-7b 4 of 576 + 2048
# positions (hd 128), whisper-medium 8 of 448 tokens over 1500 frames.
ATTN_TRAIN = {"hymba-1.5b": (2, 25, 5, 2048, 2048, 64, True, 1024),
              "qwen2-0.5b": (4, 14, 2, 2048, 2048, 64, True, 0),
              "qwen2-moe-a2.7b": ATTN_QWEN_MOE_TRAIN,
              "llava-next-mistral-7b": ATTN_LLAVA_TRAIN,
              "whisper-medium encoder": (8, 16, 16, 1500, 1500, 64, False, 0),
              "whisper-medium cross": (8, 16, 16, 448, 1500, 64, False, 0)}
SCAN_TRAIN = {"hymba-1.5b": (2, 2048, 3200, 16), "falcon-mamba-7b": (2, 2048, 8192, 16)}
NORM_TRAIN = {"hymba-1.5b": (4096, 1600), "qwen2-0.5b": (8192, 896),
              "falcon-mamba-7b": (4096, 4096), "qwen2-moe-a2.7b": (16384, 2048)}
# Edges of the RMSNorm backward's paths, each in f32 and bf16 x: (rows, d,
# scale dtype (None: x's), x's offset in elements from a 16-byte boundary).
# Scalar loads (d % 8 != 0), a row wider than the register path (streaming),
# one row (one block, split over 2 and 4 warps), fewer rows than a block's
# teams, an f32 x with a bf16 scale, and an x that starts off 16 bytes.
NORM_BWD_EDGES = [(37, 1001, None, 0), (64, 8192, None, 0), (1, 1600, None, 0),
                  (1, 4096, None, 0), (3, 896, None, 0), (3, 1600, None, 0),
                  (300, 2048, torch.bfloat16, 0), (4, 1600, None, 1)]

# LM training through the kernels against the plain versions, f32, full width
# and few layers: (arch, layers, batch, sequence).  The drift is the larger
# of the loss's relative difference and, over every gradient leaf, max |diff|
# over the leaf's max |value|.  Both runs take the same weights and batch; the
# kernels sum in other orders than the plain versions (f32 SIMT attention,
# the scan's lane reductions), a few f32 ulps of the largest element.  Each
# planted fault must land LM_SMALL_FAULT_FACTOR times beyond the limit.
LM_SMALL = [("qwen2-0.5b", 2, 2, 2048), ("hymba-1.5b", 2, 2, 2048),
            ("falcon-mamba-7b", 2, 2, 1024), ("qwen2-moe-a2.7b", 2, 2, 2048),
            ("llava-next-mistral-7b", 2, 2, 1024), ("whisper-medium", 2, 2, 448)]
LM_SMALL_LIMIT = 1e-3
LM_SMALL_FAULT_FACTOR = 10
# LM training at full width on SOLAR's planned token batches, bf16 params,
# through launch.train: (arch, layers (None: full depth), timed steps after
# one warm-up step, tokens a sequence).  2 nodes x local batch 5 pad to a
# capacity of 8 rows a node: 16 sequences a step, in the configs' grad_accum
# microbatches.  Bf16 params, f32 moments and the f32 accumulation buffer
# take ~14 bytes a param, so falcon-mamba-7b trains 8 of its 64 layers and
# llava-next-mistral-7b 8 of 32 (576 zero patches before its 2048 tokens).
# qwen2-moe-a2.7b trains 3 of 24 (0.6 B params a layer): at 4 its step ran
# out of the card's 80 GB in AdamW, which holds the old and the new params
# and moments (~24 bytes a param) beside the gradients (68.6 GiB allocated,
# 7.7 GiB fragmented, on an H100).
# whisper-medium trains whole, on 448 tokens (its text context) over 1500
# zero source frames.
LM_TRAIN = [("hymba-1.5b", None, 3, 2048), ("qwen2-0.5b", None, 3, 2048),
            ("falcon-mamba-7b", 8, 2, 2048), ("qwen2-moe-a2.7b", 3, 2, 2048),
            ("llava-next-mistral-7b", 8, 2, 2048), ("whisper-medium", None, 2, 448)]
LM_TRAIN_ARGS = ["--nodes", "2", "--local-batch", "5", "--buffer", "64",
                 "--epochs", "1", "--num-samples", "256", "--num-workers", "2"]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def counters():
    """{kernel: (wrapper module, its launch count's name)}: the six kernels."""
    from repro_torch.kernels import flash_attention, rmsnorm, selective_scan

    return {"flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches"),
            "selective_scan": (selective_scan, "launches"),
            "selective_scan_bwd": (selective_scan, "bwd_launches"),
            "rms_norm": (rmsnorm, "launches"),
            "rms_norm_bwd": (rmsnorm, "bwd_launches")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def cuda_ms(fn, *, iters: int = 20, repeats: int = 7, warmup: int = 3) -> float:
    """Median over ``repeats`` of CUDA-event time per call, ``iters`` eager
    calls between two events, after ``warmup`` calls.  Where a call's device
    time is near its host cost this reads the host's launch rate."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, *, iters: int = 20, repeats: int = 7, warmup: int = 3) -> float:
    """Median over ``repeats`` of device time per call: ``iters`` calls of
    ``fn`` captured in one CUDA graph and replayed between two CUDA events,
    so the host's launch rate stays out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def host_ms(fn, *, repeats: int = 5) -> float:
    """Median wall time of ``fn`` ending in a device synchronise."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled(cpu: bool = True):
    """A profiler of the card's kernels, and of the host's ops with ``cpu``
    (which a training step's tens of thousands of ops make slow to trace)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA])


def profiled_run(fn, cpu: bool = True):
    torch.cuda.synchronize()
    with profiled(cpu) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_time(run, wall_ms: float, calls: int) -> dict:
    """Device kernel time per call from a ``torch.profiler`` trace of
    ``run()`` (which returns the profiler), against the unprofiled wall
    time ``wall_ms`` of one call: one stream, so kernels do not overlap and
    their sum over the wall time is the device's busy share.  None where the
    trace holds no device time."""
    from torch.autograd import DeviceType

    # Device-side events only (kernels, copies): a host op's own device total
    # counts the kernels it launched a second time.
    events = [e for e in run().key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return e.self_device_time_total

    total_ms = sum(dev_us(e) for e in events) / 1e3 / calls
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return {
        "device_ms": total_ms or None,
        "wall_ms": wall_ms,
        "busy_share": total_ms / wall_ms if total_ms else None,
        "top": [(e.key[:48], round(dev_us(e) / 1e3 / calls, 4)) for e in top
                if dev_us(e)],
    }


# ---------------------------------------------------------------------------
# Inputs and bounds
# ---------------------------------------------------------------------------


def attention_label(shape) -> str:
    b, h, kh, sq, sk, hd, causal, window = shape
    return (f"q [{b},{h},{sq},{hd}] k/v [{b},{kh},{sk},{hd}] bf16 "
            + ("causal" if causal else "non-causal") + (f" window {window}" if window else ""))


def attention_inputs(shape, dtype, seed=7):
    b, h, kh, sq, sk, hd, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd))]


def scan_inputs(shape, dtype, seed=7):
    """u, dt, a, b, c, d_skip as the Mamba block makes them: dt = softplus,
    a = -exp(.) < 0, working-dtype u/dt/b/c, f32 a and d_skip."""
    b, s, di, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda")

    u, bm, cm = randn(b, s, di), randn(b, s, n), randn(b, s, n)
    dt = torch.nn.functional.softplus(randn(b, s, di))
    a = -torch.exp(0.3 * randn(di, n))
    d = 1.0 + 0.1 * randn(di)
    return [u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype), d]


def norm_inputs(shape, dtype, seed=7):
    rows, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    return x, (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)


def mask_ok(sq, sk, causal, window, device="cpu"):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    return ok


def score_entries(shape) -> tuple:
    """(admitted, computed): the score entries the mask admits, and those the
    bf16 kernel computes (whole 64x64 tiles over each query tile's
    ``key_tile_range``), over all heads."""
    from repro_torch.kernels import flash_attention as fa

    b, h, _, sq, sk, _, causal, window = shape
    admitted = int(mask_ok(sq, sk, causal, window).sum())
    tiles = 0
    for q0 in range(0, sq, fa.BLOCK_Q):
        begin, end = fa.key_tile_range(q0, sq, sk, causal, window)
        tiles += -(-(end - begin) // fa.BLOCK_K)
    return admitted * b * h, tiles * fa.BLOCK_Q * fa.BLOCK_K * b * h


def attention_bound(q, k, causal: bool, window: int):
    """Least time (ms) for attention on these inputs: the larger of the bytes
    (q, k, v read once, o written once) over HBM and the FLOPs of the
    unmasked score/value products over the bf16 tensor-core peak."""
    b, h, sq, hd = q.shape
    flops = 4 * hd * int(mask_ok(sq, k.shape[2], causal, window).sum()) * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def scan_bound(u, a, clock_hz: float):
    """Least time (ms) for the selective scan on these inputs: the largest of
    the bytes (u, dt, B, C, a, d_skip read once; y and h_last written once
    in f32) over HBM, one exp per (b, t, d, n) over the special function
    units (16 per clock per SM at the card's maximum SM clock), and six f32
    operations per (b, t, d, n) (dt*a; decay*h + du*B; y += h*C) over the f32
    peak.  Returns (ms, 'bytes'|'operations', parts)."""
    b, s, di = u.shape
    n = a.shape[1]
    elems = b * s * di * n
    nbytes = (2 * u.numel() + 2 * b * s * n) * u.element_size() \
        + (a.numel() + di) * 4 + (u.numel() + b * di * n) * 4
    parts = {"bytes": nbytes / HBM_BYTE_S * 1e3,
             "exp": elems / (SFU_PER_SM_CLK * SMS * clock_hz) * 1e3,
             "f32_ops": 6 * elems / PEAK_F32_FLOP_S * 1e3}
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts


def norm_bound(x, scale):
    """Least time (ms) for RMSNorm: x read once, out written once, scale
    read once, over HBM (a few f32 operations per element are far below)."""
    nbytes = 2 * x.numel() * x.element_size() + scale.numel() * scale.element_size()
    return nbytes / HBM_BYTE_S * 1e3, "bytes"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    kernels = _build.names()
    if kernels != ["flash_attention", "flash_attention_bwd", "rms_norm", "rms_norm_bwd",
                   "selective_scan", "selective_scan_bwd"]:
        raise AssertionError(f"unexpected kernel set {kernels}")
    t0 = time.perf_counter()
    # the scan's earlier design too, built only to time the current one against
    libs = _build.build_all(kernels + ["selective_scan_per_channel"])
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f}s")
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.name}; ptxas, per entry function:")
        for fn, info in _build.ptxas_report(lib.with_suffix(".log").read_text()):
            log(f"[build]   {fn}: {info}")
    log("[build] flash_attention bf16 dynamic shared memory per block: "
        + ", ".join(f"hd {hd}: {fa.tc_smem_bytes(hd)} B" for hd in fa.HEAD_DIMS)
        + "; backward (dK/dV, dQ): "
        + ", ".join(f"hd {hd}: {fa.bwd_tc_smem_bytes(hd)} B" for hd in fa.HEAD_DIMS))


def _agree(name, label, got, want, dtype) -> float:
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    tol = TOL[name][dtype]
    ok = all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
             for g, w in zip(got, want))
    log(f"[kernels] {name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} "
        f"(tol {tol:g}) {'ok' if ok and math.isfinite(err) else 'FAIL'}")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name} disagrees with its plain version at {label} {dtype}")
    return err


def phase_kernels():
    """Returns {kernel: {"float32"|"bfloat16"|"serve": worst max abs err}}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import selective_scan as ss

    worst = {name: {} for name in TOL}

    def note(name, key, err):
        worst[name][key] = max(worst[name].get(key, 0.0), err)

    for shape in ATTN_SWEEP + ATTN_TC_EDGES + ATTN_SERVE:
        serve = shape in ATTN_SERVE
        bf16_only = serve or shape in ATTN_TC_EDGES
        for dtype in [torch.bfloat16] if bf16_only else list(TOL["flash_attention"]):
            q, k, v = attention_inputs(shape, dtype)
            causal, window = shape[6], shape[7]
            err = _agree("flash_attention", str(shape), [fa.flash_attention(
                q, k, v, causal=causal, window=window)], [ref.attention_ref(
                    q, k, v, causal=causal, window=window)], dtype)
            note("flash_attention", "serve" if serve else str(dtype)[6:], err)
    # K3 in both dtypes at every shape: in f32 the serving shapes check the
    # order of summation of the lanes' reduce-scatter at 1e-4.
    for shape in SCAN_SWEEP + [SCAN_HYMBA, SCAN_FALCON]:
        serve = shape in (SCAN_HYMBA, SCAN_FALCON)
        for dtype in TOL["selective_scan"]:
            args = scan_inputs(shape, dtype)
            err = _agree("selective_scan", str(shape), ss.selective_scan(*args),
                         ref.selective_scan_ref(*args), dtype)
            key = ("serve" if dtype == torch.bfloat16 else "serve_f32") if serve \
                else str(dtype)[6:]
            note("selective_scan", key, err)
    for shape in NORM_SWEEP + NORM_SERVE:
        serve = shape in NORM_SERVE
        for dtype in TOL["rms_norm"]:
            x, scale = norm_inputs(shape, dtype)
            # the sweep's scale is f32; a serving path's is in the param dtype
            scale = scale if serve else scale.float()
            err = _agree("rms_norm", str(shape), [rn.rms_norm(x, scale, eps=1e-6)],
                         [ref.rms_norm_ref(x, scale, 1e-6)], dtype)
            bf16_serve = serve and dtype == torch.bfloat16
            note("rms_norm", "serve" if bf16_serve else str(dtype)[6:], err)
    return worst


def _agree_grads(name, label, got, want, dtype) -> float:
    """The worst max |diff| / max(1, max |want|) over the gradients, each
    within ``TOL_BWD`` of ``dtype``, or of bf16 for a bf16 gradient of an
    f32 input (RMSNorm's ds for a bf16 scale rounds as bf16)."""
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name} {label}: gradient {g.dtype} {tuple(g.shape)}, "
                                 f"plain {w.dtype} {tuple(w.shape)}")
        scale = max(1.0, w.float().abs().max().item())
        e = (g.float() - w.float()).abs().max().item() / scale
        ok &= math.isfinite(e) and e <= TOL_BWD[torch.bfloat16 if g.dtype == torch.bfloat16
                                                else dtype]
        err = max(err, e)
    tol = TOL_BWD[dtype]
    log(f"[kernels_bwd] {name} {label} {str(dtype)[6:]}: max |diff| / max |ref| {err:.3e} "
        f"(tol {tol:g}; bf16 gradients {TOL_BWD[torch.bfloat16]:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with autograd through its plain version at "
                             f"{label} {dtype}")
    return err


def _grads(fn, inputs, cotangent):
    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    if out.grad_fn is None:
        raise AssertionError("a kernel's output carries no backward")
    return torch.autograd.grad(out, leaves, cotangent)


def cotangent(shape, dtype, seed=9):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def phase_kernels_bwd():
    """Each backward kernel, through its autograd Function, against autograd
    through its plain version: the sweeps of tests/test_kernels.py and the
    training shapes, f32 and bf16.  Returns {kernel: {key: worst error}}."""
    from repro_torch.kernels import ops, ref

    worst = {"flash_attention_bwd": {}, "selective_scan_bwd": {}, "rms_norm_bwd": {}}

    def note(name, key, err):
        worst[name][key] = max(worst[name].get(key, 0.0), err)

    train_attn = list(ATTN_TRAIN.values())
    for shape in ATTN_SWEEP + ATTN_TC_EDGES + ATTN_BWD_TC_EDGES + train_attn:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attention_inputs(shape, dtype)
            causal, window = shape[6], shape[7]
            do = cotangent(q.shape, dtype)
            err = _agree_grads("flash_attention_bwd", str(shape), _grads(
                lambda *t: ops.flash_attention(*t, causal=causal, window=window), (q, k, v), do),
                ref.attention_ref_bwd(q, k, v, do, causal=causal, window=window), dtype)
            train = shape in train_attn
            note("flash_attention_bwd", ("train_" if train else "") + str(dtype)[6:], err)
    train_scan = list(SCAN_TRAIN.values())
    for shape in SCAN_SWEEP + train_scan:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(shape, dtype)
            dy = cotangent(args[0].shape, torch.float32)
            err = _agree_grads("selective_scan_bwd", str(shape),
                               _grads(ops.selective_scan, args, dy),
                               ref.selective_scan_ref_bwd(*args, dy), dtype)
            train = shape in train_scan
            note("selective_scan_bwd", ("train_" if train else "") + str(dtype)[6:], err)
    train_norm = list(NORM_TRAIN.values())
    for shape in NORM_SWEEP + train_norm:
        for dtype in (torch.float32, torch.bfloat16):
            train = shape in train_norm
            x, scale = norm_inputs(shape, dtype)
            scale = scale if train else scale.float()  # a model's scale is in its param dtype
            dy = cotangent(x.shape, dtype)
            err = _agree_grads("rms_norm_bwd", str(shape), _grads(
                lambda x_, s_: ops.rms_norm(x_, s_, eps=1e-6), (x, scale), dy),
                ref.rms_norm_ref_bwd(x, scale, dy, 1e-6), dtype)
            note("rms_norm_bwd", ("train_" if train else "") + str(dtype)[6:], err)
    for rows, d, scale_dtype, offset in NORM_BWD_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            x, scale = norm_inputs((rows, d), dtype)
            scale = scale.to(scale_dtype or dtype)
            if offset:
                buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
                x = buf[offset:].view(rows, d).copy_(x)
                if x.data_ptr() % 16 == 0:
                    raise AssertionError("the offset view starts on 16 bytes")
            dy = cotangent(x.shape, dtype)
            label = f"edge {(rows, d)} scale {str(scale.dtype)[6:]} offset {offset}"
            err = _agree_grads("rms_norm_bwd", label, _grads(
                lambda x_, s_: ops.rms_norm(x_, s_, eps=1e-6), (x, scale), dy),
                ref.rms_norm_ref_bwd(x, scale, dy, 1e-6), dtype)
            note("rms_norm_bwd", "edge_" + str(dtype)[6:], err)
    return worst


def phase_small():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    impls = dict(attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas")
    for arch in ("qwen2-0.5b", "hymba-1.5b", "falcon-mamba-7b"):
        cfg = get_config(arch).reduced()
        params = lm.init_lm(cfg, seed=1, device="cpu")
        g = torch.Generator().manual_seed(2)
        leaves = [params["final_norm"]]
        stack = [params["layers"]]
        while stack:
            for leaf in stack.pop().values():
                (stack if isinstance(leaf, dict) else leaves).append(leaf)
        for leaf in leaves:  # nonzero biases and norm scales
            leaf.add_(0.05 * torch.randn(leaf.shape, generator=g))
        # 40 prompt tokens: past hymba's reduced window of 32, so the ring
        # cache wraps (max_len 49 > 32) and decode continues the ring.
        prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
        card = ServeEngine(cfg, params, max_len=49, device="cuda", **impls)
        host = ServeEngine(cfg, params, max_len=49, device="cpu", **impls)
        reset_counts()
        got = card.prefill(prompts)[0].cpu()
        counts = read_counts()
        want = host.prefill(prompts)[0]
        err = (got - want).abs().max().item()
        toks, want_toks = card.generate(prompts, 8), host.generate(prompts, 8)
        log(f"[small] {arch} reduced f32 (ring {card.spec.ring}) prefill logits card vs "
            f"cpu: max_abs_err {err:.3e} (tol {SMALL_TOL:g}); greedy tokens equal: "
            f"{np.array_equal(toks, want_toks)}; prefill launches {counts}")
        if not err <= SMALL_TOL or not np.array_equal(toks, want_toks):
            raise AssertionError(f"reduced {arch} on the card disagrees with the CPU")
    phase_small_encdec()
    phase_small_bf16()


def phase_small_encdec():
    """whisper-medium at ``reduced()`` in f32: the card's engine against the
    CPU engine, with its cross-attention made causal and an erf GELU in
    place of the tanh form planted on the card, each of which must land
    above ``SMALL_TOL``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, lm
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import ServeEngine

    arch = "whisper-medium"
    cfg = get_config(arch).reduced()
    params = encdec.init_encdec(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    for name, leaf in lm.flat_params(params).items():  # biases and scales off 0 and 1
        if name != "embed":
            leaf.add_(0.05 * torch.randn(leaf.shape, generator=g))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    source = rng.standard_normal((3, cfg.source_len, cfg.d_model)).astype(np.float32)
    card = ServeEngine(cfg, params, max_len=21, device="cuda", attn_impl="pallas")
    host = ServeEngine(cfg, params, max_len=21, device="cpu", attn_impl="pallas")
    reset_counts()
    got = card.prefill(prompts, source)[0].cpu()
    counts = read_counts()
    want = host.prefill(prompts, source)[0]
    err = (got - want).abs().max().item()
    toks = card.generate(prompts, 8, source=source)
    same = np.array_equal(toks, host.generate(prompts, 8, source=source))
    real_attn, real_gelu = ops.flash_attention, L.gelu_mlp

    def causal_cross(q, k, v, *, causal=True, window=0, **kw):
        return real_attn(q, k, v, causal=causal or q.shape[2] != k.shape[2], window=window,
                         **kw)

    def erf_gelu(x, wi, bi, wo, bo):
        return F.gelu((x @ wi) + bi) @ wo + bo

    faults = {}
    for fault, (mod, attr, fn) in {"cross_attention_causal": (ops, "flash_attention",
                                                               causal_cross),
                                   "erf_gelu": (L, "gelu_mlp", erf_gelu)}.items():
        saved = getattr(mod, attr)
        setattr(mod, attr, fn)
        try:
            faults[fault] = (card.prefill(prompts, source)[0].cpu() - want).abs().max().item()
        finally:
            setattr(mod, attr, saved)
    want_counts = expected_counts(cfg, 0)
    log(f"[small] {arch} reduced f32 prefill logits card vs cpu: max_abs_err {err:.3e} (tol "
        f"{SMALL_TOL:g}); greedy tokens equal: {same}; planted faults "
        f"{ {k: float(f'{v:.4g}') for k, v in faults.items()} } (each must exceed the tol); "
        f"prefill launches {counts}")
    if any(counts[k] != want_counts[k] for k in counts):
        raise AssertionError(f"{arch}: launches {counts}, want {want_counts}")
    if not err <= SMALL_TOL or not same:
        raise AssertionError(f"reduced {arch} on the card disagrees with the CPU")
    if not all(v > SMALL_TOL for v in faults.values()):
        raise AssertionError(f"{arch}: the limit misses a planted fault: {faults}")


@contextlib.contextmanager
def pinned_routes(routes: list, replay: bool):
    """Through ``layers.route``, record every moe routing decision of the
    block into ``routes`` (``replay`` False), or hold each one to the
    recorded decision, in call order (``replay`` True): the experts
    recorded, gated by the run's own router probabilities renormalised as
    ``route`` does.  A kernels-versus-plain comparison replays the kernel
    run's routes in the plain run, so a near-tie that rounding tips the
    other way does not read as a kernel fault.  Yields {"moved": tokens
    whose own top-k differed, "calls": routes replayed}."""
    from repro_torch.models import layers as L

    real = L.route
    stats = {"moved": 0, "calls": 0}
    recorded = iter(routes)

    def record(x, router_w, **kw):
        out = real(x, router_w, **kw)
        routes.append(out[2])
        return out

    def hold(x, router_w, **kw):
        probs, _, own = real(x, router_w, **kw)
        idx = next(recorded)
        stats["moved"] += int((own != idx).any(dim=-1).sum())
        stats["calls"] += 1
        gates = probs.gather(-1, idx)
        return probs, gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9), idx

    L.route = hold if replay else record
    try:
        yield stats
    finally:
        L.route = real


def phase_small_bf16():
    """``SMALL_BF16``'s models at full width and 2 layers in bf16, through
    ``lm.prefill`` (llava-next-mistral-7b with patch embeddings): prefill
    logits through the kernels within ``SMALL_BF16_ATOL`` of the plain
    versions' (the moe routes of the plain run pinned to the kernel run's),
    every planted attention fault and the pad-expert mask dropped beyond
    it.  The moe router must run in full f32: TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the moe router would not run in full f32")
    for arch, batch, prompt in SMALL_BF16:
        cfg = get_config(arch).replace(num_layers=2)
        params = lm.init_lm(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).cuda()
        patches = None
        if cfg.family == "vlm":
            patches = torch.from_numpy(rng.standard_normal(
                (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)).cuda()
        spec = lm.CacheSpec.build(cfg, cfg.num_patches + prompt + 1)

        def prefill(impl):
            with torch.inference_mode():
                return lm.prefill(params, tokens, cfg, spec, patches=patches, attn_impl=impl,
                                  ssm_impl=impl, norm_impl=impl)[0]

        routes = []
        reset_counts()
        with pinned_routes(routes, replay=False):
            got = prefill("pallas")
        counts = read_counts()
        with pinned_routes(routes, replay=True) as pinned:
            want = prefill("ref")
        err = (got.float() - want.float()).abs().max().item()
        faults = planted_fault_diffs(lambda: prefill("pallas"), want.float(), cfg,
                                     only=("flash_attention", "route"))
        want_counts = expected_counts(cfg, 0)
        log(f"[small] {arch} full width, 2 layers, bf16, batch {batch} prompt {prompt}"
            f"{f' after {cfg.num_patches} patches' if patches is not None else ''}: prefill "
            f"logits kernels vs plain max_abs_err {err:.4f} (tol {SMALL_BF16_ATOL}); planted "
            f"faults { {k: round(v, 4) for k, v in faults.items()} } (each must exceed the "
            f"tol); |logits| max {want.float().abs().max().item():.2f}; moe routes pinned "
            f"{pinned}; launches {counts}")
        if any(counts[k] != want_counts[k] for k in counts):
            raise AssertionError(f"{arch}: launches {counts}, want {want_counts}")
        if not torch.isfinite(got).all() or not err <= SMALL_BF16_ATOL:
            raise AssertionError(f"{arch}: 2-layer bf16 prefill logits disagree")
        if not faults or not all(d > SMALL_BF16_ATOL for d in faults.values()):
            raise AssertionError(f"{arch}: the 2-layer bf16 limit misses a planted fault")
        del params, routes
        gc.collect()
        torch.cuda.empty_cache()


def attention_layers(cfg) -> int:
    """Attention calls of one forward pass: one a layer (none in the ssm
    family); the encoder-decoder's encoder self-attention, and its decoder's
    self- and cross-attention."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return 0 if cfg.family == "ssm" else cfg.num_layers


def norm_layers(cfg) -> int:
    """RMSNorms of one forward pass's blocks: ln1 and ln2 a layer (hybrid
    also ln_ssm, ssm ln1 only, the encoder-decoder's LayerNorm none)."""
    per = {"dense": 2, "moe": 2, "vlm": 2, "hybrid": 3, "ssm": 1, "encdec": 0}[cfg.family]
    return per * cfg.num_layers


def expected_counts(cfg, gen: int) -> dict:
    """Kernel launches of one ``generate``: K2 per attention and K3 per
    layer in prefill; K1 per block norm plus the final norm (none in the
    encoder-decoder), in prefill and in every decode step."""
    scan = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    norms = norm_layers(cfg) + (cfg.family != "encdec")
    return {"flash_attention": attention_layers(cfg), "flash_attention_bwd": 0,
            "selective_scan": scan, "selective_scan_bwd": 0,
            "rms_norm": norms * (1 + gen), "rms_norm_bwd": 0, "rms_norm_per_pass": norms}


def planted_fault_diffs(prefill, ref_logits, cfg, only=None) -> dict:
    """Max abs prefill-logit difference from ``ref_logits`` when a kernel is
    fed a planted fault; ``prefill()`` returns the logits and ``only`` names
    the faulted functions to keep (``flash_attention``, ``selective_scan``,
    ``rms_norm``, ``route``).  The negative control of the logit tolerance.
    Attention: no causal mask, scale 1/hd instead of 1/sqrt(hd), each query
    head reading the next kv head.  Scan: no D*u skip, exp(A) in place of
    exp(dt*A), B and C swapped.  Norm: scale in place of 1 + scale.  Router
    (moe with pad experts): the pad experts' mask dropped."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    real = {"flash_attention": ops.flash_attention,
            "selective_scan": ops.selective_scan, "rms_norm": ops.rms_norm}

    def attend(fault):
        def run(q, k, v, *, causal=True, window=0, **kw):
            if fault == "no_causal_mask":
                causal, window = False, 0
            elif fault == "scale_1/hd":
                q = (q.float() / math.sqrt(q.shape[-1])).to(q.dtype)
            else:
                k, v = k.roll(1, dims=1).contiguous(), v.roll(1, dims=1).contiguous()
            return real["flash_attention"](q, k, v, causal=causal, window=window, **kw)
        return run

    def scan(fault):
        def run(u, dt, a, b, c, d_skip, **kw):
            if fault == "no_D_skip":
                return real["selective_scan"](u, dt, a, b, c, torch.zeros_like(d_skip), **kw)
            if fault == "exp(A)_not_exp(dt*A)":
                # exp(1*A) h + 1*(dt u) B, then D u restored outside
                du = (dt.float() * u.float()).to(u.dtype)
                y, h = real["selective_scan"](du, torch.ones_like(dt), a, b, c, d_skip, **kw)
                return y + d_skip * (u.float() - du.float()), h
            return real["selective_scan"](u, dt, a, c, b, d_skip, **kw)
        return run

    def norm(x, scale, **kw):
        return real["rms_norm"](x, scale - 1, **kw)

    route = L.route

    def no_pad_mask(x, router_w, **kw):
        return route(x, router_w, **{**kw, "num_real_experts": router_w.shape[1]})

    faults = {}  # fault -> (module, function name, planted function)
    fams = kernel_families(cfg)
    if "flash_attention" in fams:
        faults.update({f: (ops, "flash_attention", attend(f)) for f in
                       ("no_causal_mask", "scale_1/hd", "wrong_kv_head")})
    if "selective_scan" in fams:
        faults.update({f: (ops, "selective_scan", scan(f)) for f in
                       ("no_D_skip", "exp(A)_not_exp(dt*A)", "B_C_swapped")})
    if "rms_norm" in fams:
        faults["norm_scale_not_1+scale"] = (ops, "rms_norm", norm)
    if lm.padded_experts(cfg) > cfg.num_experts:
        faults["pad_expert_mask_dropped"] = (L, "route", no_pad_mask)
    if only:
        faults = {f: v for f, v in faults.items() if v[1] in only}
    diffs = {}
    for fault, (mod, name, fn) in faults.items():
        saved = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            got = prefill()
        finally:
            setattr(mod, name, saved)
        diffs[fault] = (got.float() - ref_logits).abs().max().item()
    return diffs


def serve_model(arch, batch, prompt, gen) -> dict:
    """One serving path at full width and depth; returns its main-run launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
    params = init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {arch} full width and depth ({cfg.family}, {cfg.num_layers}L "
        f"(+{cfg.encoder_layers} encoder) d={cfg.d_model} h={cfg.num_heads} "
        f"kv={cfg.num_kv_heads} hd={cfg.resolved_head_dim} experts={cfg.num_experts} "
        f"(padded {lm.padded_experts(cfg)}) top_k={cfg.top_k} DI={cfg.ssm_d_inner} "
        f"N={cfg.ssm_state} window={cfg.sliding_window} vocab={cfg.vocab_size}) "
        f"{cfg.param_dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f}s; batch {batch}, prompt {prompt}, {gen} new tokens"
        + (f", {cfg.source_len} source frames" if cfg.family == "encdec" else ""))
    max_len = prompt + gen + 1
    kernels = dict(attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas")
    eng = ServeEngine(cfg, params, max_len=max_len, device="cuda", **kernels)
    if eng.spec.ring:
        log(f"[serve] {arch} ring KV cache of {eng.spec.cache_len} positions, prefill "
            f"roll shift {prompt % eng.spec.cache_len}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    source = None  # the encoder-decoder's frame embeddings
    if cfg.family == "encdec":
        source = np.random.default_rng(1).standard_normal(
            (batch, cfg.source_len, cfg.d_model)).astype(np.float32)
    want = expected_counts(cfg, gen)

    # The main path: counts set to 0 just before, read just after.
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, gen, source=source)
    first_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] {arch} generate {out.shape} first run {first_s * 1e3:.1f} ms; "
        f"launches {counts} (want {want})")
    if any(counts[k] != want[k] for k in counts):
        raise AssertionError(f"{arch}: launches {counts}, want {want}")
    if out.shape != (batch, gen) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens: shape {out.shape}")

    reset_counts()
    logits, cache = eng.prefill(prompts, source)
    prefill_counts = read_counts()
    reset_counts()
    eng.step(cache, torch.argmax(logits, dim=-1))
    step_counts = read_counts()
    log(f"[serve] {arch} launches per prefill {prefill_counts}, per decode step "
        f"{step_counts}")
    if prefill_counts["rms_norm"] != want["rms_norm_per_pass"] or \
            step_counts != {**{k: 0 for k in step_counts},
                            "rms_norm": want["rms_norm_per_pass"]}:
        raise AssertionError(f"{arch}: per-pass launches differ from {want}")

    reset_counts()
    t0 = time.perf_counter()
    again = eng.generate(prompts, gen, source=source)
    gen_s = time.perf_counter() - t0
    if read_counts() != counts or not np.array_equal(out, again):
        raise AssertionError(f"{arch}: repeat run differs")

    plain = dict(attn_impl="ref", ssm_impl="ref", norm_impl="ref")
    ref_eng = ServeEngine(cfg, eng.params, max_len=max_len, device="cuda", **plain)
    reset_counts()
    ref_logits, _ = ref_eng.prefill(prompts, source)
    if any(read_counts().values()):
        raise AssertionError(f"{arch}: the all-plain engine launched a kernel")
    diff = (logits - ref_logits).abs().max().item()
    agree = (out == ref_eng.generate(prompts, gen, source=source)).mean()
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: prefill logits are not finite")

    # The same weights in f32, where a copy fits beside the bf16 ones:
    # kernels against plain versions, then planted faults, then how far each
    # bf16 engine drifts from the f32 plain run.
    tol = LOGIT_ATOL_F32
    diff32 = drift = plain_drift = fault_diffs = None
    free, _ = torch.cuda.mem_get_info()
    if 4 * n_params > 0.75 * free:
        log(f"[serve] {arch} f32 checks skipped: an f32 copy takes {4 * n_params / 2**30:.1f} "
            f"GiB, {free / 2**30:.1f} GiB free; bf16 prefill logits kernels vs plain "
            f"max_abs_diff {diff:.4f} (not gated: bf16 drift and expert choices tipped by "
            f"rounding; phase small gates this model at 2 layers); |logits| max "
            f"{ref_logits.abs().max().item():.2f}; bf16 greedy token agreement {agree:.3f}")
    else:
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        params32 = _to_f32(eng.params)
        eng32 = ServeEngine(cfg32, params32, max_len=max_len, device="cuda", **kernels)
        ref32 = ServeEngine(cfg32, params32, max_len=max_len, device="cuda", **plain)
        logits32 = eng32.prefill(prompts, source)[0]
        ref_logits32 = ref32.prefill(prompts, source)[0]
        diff32 = (logits32 - ref_logits32).abs().max().item()
        drift = (logits.float() - ref_logits32).abs().max().item()
        plain_drift = (ref_logits.float() - ref_logits32).abs().max().item()
        log(f"[serve] {arch} prefill logits kernels vs plain: f32 max_abs_diff {diff32:.3e} "
            f"(tol {tol}); bf16 max_abs_diff {diff:.4f}; bf16 drift from the f32 plain run: "
            f"kernels {drift:.4f}, plain {plain_drift:.4f} (ratio limit {BF16_DRIFT_RATIO}); "
            f"|logits| max {ref_logits.abs().max().item():.2f}; bf16 greedy token agreement "
            f"{agree:.3f}")
        if not diff32 <= tol:
            raise AssertionError(f"{arch}: f32 prefill logits disagree with the plain engine")
        if not drift <= BF16_DRIFT_RATIO * plain_drift:
            raise AssertionError(f"{arch}: the bf16 kernels drift further than the plain path")
        fault_diffs = planted_fault_diffs(lambda: eng32.prefill(prompts, source)[0],
                                          ref_logits32, cfg)
        log(f"[serve] {arch} planted faults, f32 prefill logits vs plain: max_abs_diff "
            f"{ {k: round(v, 4) for k, v in fault_diffs.items()} } (each must exceed tol "
            f"{tol})")
        if not fault_diffs or not all(d > tol for d in fault_diffs.values()):
            raise AssertionError(f"{arch}: the logit tolerance does not catch a planted fault")
        del eng32, ref32, params32
        gc.collect()
        torch.cuda.empty_cache()

    # The engine's defaults ("auto") take every kernel on the card.
    auto_eng = ServeEngine(cfg, eng.params, max_len=max_len, device="cuda")
    reset_counts()
    auto_logits, _ = auto_eng.prefill(prompts, source)
    auto_counts = read_counts()
    log(f"[serve] {arch} default 'auto' prefill launches {auto_counts}")
    if auto_counts != prefill_counts or not torch.equal(auto_logits, logits):
        raise AssertionError(f"{arch}: 'auto' does not run the kernels on the card")

    prefill_ms = host_ms(lambda: eng.prefill(prompts, source), repeats=3)
    ref_prefill_ms = host_ms(lambda: ref_eng.prefill(prompts, source), repeats=3)

    decode_ms = statistics.median(decode(eng, prompts, gen, source) for _ in range(3))
    busy = {"prefill": device_time(lambda: profiled_run(lambda: eng.prefill(prompts, source),
                                                        cpu=False), prefill_ms, 1),
            "decode_step": device_time(lambda: decode(eng, prompts, gen, source, profile=True),
                                       decode_ms, gen)}
    for name, b in busy.items():
        log(f"[serve] {arch} {name} device busy {b['device_ms']} ms of {b['wall_ms']:.3f} "
            f"ms wall (share {b['busy_share']}); top kernels {b['top']}")
    metrics = {
        "arch": arch, "layers": cfg.num_layers,
        "batch": batch, "prompt": prompt, "gen": gen,
        "prefill_ms": prefill_ms, "prefill_plain_ms": ref_prefill_ms,
        "decode_ms_per_token": decode_ms,
        "generate_tokens_per_s": batch * gen / gen_s,
        "generate_ms": gen_s * 1e3, "peak_mem_gib": peak_gib,
        "logit_f32_max_abs_diff": diff32, "logit_f32_tol": tol,
        "logit_bf16_max_abs_diff": diff, "bf16_drift_kernels": drift,
        "bf16_drift_plain": plain_drift,
        "planted_fault_min_diff": min(fault_diffs.values()) if fault_diffs else None,
        "greedy_agreement_vs_plain": float(agree),
        "prefill_device_ms": busy["prefill"]["device_ms"],
        "decode_device_ms": busy["decode_step"]["device_ms"],
        "prefill_device_busy_share": busy["prefill"]["busy_share"],
        "decode_device_busy_share": busy["decode_step"]["busy_share"],
        "launches": counts,
    }
    log("[serve] " + json.dumps(metrics))
    del eng, ref_eng, auto_eng, params, cache, logits, ref_logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def decode(eng, prompts, gen, source=None, profile=False):
    """Host ms per decode step over ``gen`` steps after a prefill, from
    token 0 (or, with ``profile``, the profiler of those steps)."""
    _, cache = eng.prefill(prompts, source)
    tok = torch.zeros(len(prompts), dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    prof = profiled(cpu=False) if profile else None
    if prof:
        prof.__enter__()
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = eng.step(cache, tok)
        tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / gen
    if prof:
        prof.__exit__(None, None, None)
        return prof
    return ms


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def phase_serve() -> dict:
    """Returns {kernel: {arch: launches of that path's main run}}."""
    launches = {name: {} for name in counters()}
    for arch, batch, prompt, gen in SERVE:
        t0 = time.perf_counter()
        counts = serve_model(arch, batch, prompt, gen)
        for name, n in counts.items():
            launches[name][arch] = n
        log(f"[serve] {arch} phase {time.perf_counter() - t0:.1f}s")
    return launches


def _tier_cli(arch, batch, prompt, gen, endpoint) -> dict:
    """The serving CLI reading its prompts from the tier, in a child process
    on the card: its printed served count, tokens, wall and launch counts."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--batch", str(batch), "--prompt-len", str(prompt), "--gen", str(gen),
           "--data-tier", f"{endpoint[0]}:{endpoint[1]}", "--tenant", "1",
           "--token", TIER_TOKENS[1], "--first-id", str(TIER_FIRST_ID)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=TIER_CLI_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    for line in (res.stdout + res.stderr).strip().splitlines()[-12:]:
        log(f"[tier_serve] {arch} CLI| {line}")
    if res.returncode != 0:
        raise AssertionError(f"{arch}: the serving CLI exited {res.returncode}")
    lines = res.stdout.splitlines()

    def after(prefix):
        found = [ln[len(prefix):] for ln in lines if ln.startswith(prefix)]
        if len(found) != 1:
            raise AssertionError(f"{arch}: the CLI printed {len(found)} {prefix!r} lines")
        return found[0].strip()

    served = after("tier served ")
    if not served.startswith(f"{batch}/{batch} samples"):
        raise AssertionError(f"{arch}: the CLI's tier served {served}")
    generated = after("generated ")
    return {"served": served, "first_sequence": json.loads(after("first sequence:")),
            "launches": json.loads(after("kernel launches:")),
            "generate_s": float(generated.split(" in ")[1].split("s ")[0]),
            "process_wall_s": wall_s}


def _storm(endpoint, stop) -> dict:
    """Tenant 2 reading ``TIER_STORM_IDS`` random ids every
    ``TIER_STORM_PAUSE_S`` until ``stop`` is set; returns its client stats."""
    from repro_torch.serve.datatier import DataTierClient

    rng = np.random.default_rng(2)
    out = {}
    client = DataTierClient({0: endpoint}, tenant=2, token=TIER_TOKENS[2], timeout_s=10.0,
                            shed_wait_s=0.001, max_shed_retries=0)
    try:
        while not stop.is_set():
            client.read(rng.integers(0, TIER_SAMPLES, TIER_STORM_IDS))
            time.sleep(TIER_STORM_PAUSE_S)
    finally:
        out.update(client.stats())
        client.close()
    return out


def tier_model(tier, store, arch, batch, prompt, gen, cli, card) -> tuple[dict, dict]:
    """One model served from the tier at full width and depth; returns its
    ``tier_serve`` row and {path: main-run launch counts}."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.datatier import DataTierClient, rows_to_prompts
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    want = expected_counts(cfg, gen)
    kernels = ("flash_attention", "selective_scan", "rms_norm")
    ids = np.arange(TIER_FIRST_ID, TIER_FIRST_ID + batch, dtype=np.int64)
    launches = {}
    before = tier.stats()["per_tenant"]
    cli_run = None
    if cli:
        cli_run = _tier_cli(arch, batch, prompt, gen, tier.endpoint)
        launches[f"{arch} tier CLI"] = cli_run["launches"]
        if any(cli_run["launches"][k] != want[k] for k in kernels):
            raise AssertionError(f"{arch}: CLI launches {cli_run['launches']}, want {want}")
        after_cli = tier.stats()["per_tenant"]["1"]
        if after_cli["hits"] - before["1"]["hits"] < 2 or \
                after_cli["pfs_fallbacks"] - before["1"]["pfs_fallbacks"] < 2:
            raise AssertionError(f"{arch}: the CLI's read took {after_cli}, want >= 2 hits "
                                 f"and >= 2 PFS fallbacks")
        log(f"[tier_serve] {arch} CLI served {cli_run['served']}; launches "
            f"{cli_run['launches']}; generate {cli_run['generate_s']:.2f} s; process "
            f"{cli_run['process_wall_s']:.1f} s")

    # The same engine the CLI builds: random weights from seed 0, defaults.
    params = lm.init_lm(cfg, seed=0, device="cuda")
    eng = ServeEngine(cfg, params, max_len=prompt + gen + 1, device="cuda")
    client = DataTierClient({0: tier.endpoint}, tenant=1, token=TIER_TOKENS[1],
                            timeout_s=10.0)
    stop = threading.Event()
    storm_stats = {}
    storm = None
    try:
        read_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            rows, ok = client.read(ids)
            read_ms.append((time.perf_counter() - t0) * 1e3)
        if not ok.all() or rows.tobytes() != store.read_scattered(ids).tobytes():
            raise AssertionError(f"{arch}: the tier's rows differ from the store's")
        if not cli:  # the main run under tenant 2's storm
            storm = threading.Thread(target=lambda: storm_stats.update(
                _storm(tier.endpoint, stop)), name="tenant-2-storm")
            storm.start()
            time.sleep(0.2)
        # The main path: counts set to 0 just before, read just after.
        reset_counts()
        t0 = time.perf_counter()
        out, served = eng.generate_from_tier(client, ids, gen, prompt_len=prompt)
        gen_s = time.perf_counter() - t0
        counts = read_counts()
        stop.set()
        if storm is not None:
            storm.join(timeout=60.0)
        launches[f"{arch} tier"] = counts
        log(f"[tier_serve] {arch} generate_from_tier {out.shape} in {gen_s * 1e3:.1f} ms"
            f"{' under the tenant-2 storm' if storm else ''}; served {served.tolist()}; "
            f"launches {counts} (want {want})")
        if any(counts[k] != want[k] for k in counts):
            raise AssertionError(f"{arch}: launches {counts}, want {want}")
        if not served.all():
            raise AssertionError(f"{arch}: the tier served {served.tolist()}")
        prompts = rows_to_prompts(store.read_scattered(ids), prompt, cfg.vocab_size)
        direct = eng.generate(prompts, gen)
        if not np.array_equal(out, direct):
            raise AssertionError(f"{arch}: tier-fed tokens differ from direct-prompt tokens "
                                 f"in {(out != direct).sum()} of {out.size}")
        if cli_run and out[0][:16].tolist() != cli_run["first_sequence"]:
            raise AssertionError(f"{arch}: the CLI's tokens {cli_run['first_sequence']} differ "
                                 f"from this process's {out[0][:16].tolist()}")
        prefill_ms = host_ms(lambda: eng.prefill(prompts), repeats=3)
        decode_ms = statistics.median(decode(eng, prompts, gen) for _ in range(3))
    finally:
        stop.set()
        if storm is not None:
            storm.join(timeout=60.0)
        client.close()
    stats = tier.stats()
    per = stats["per_tenant"]
    row = {
        "arch": arch, "layers": cfg.num_layers, "batch": batch, "prompt": prompt,
        "gen": gen, "first_id": int(ids[0]), "resident_ids": TIER_RESIDENT,
        "cli": cli_run, "read_ms_median_of_5": statistics.median(read_ms),
        "read_ms": read_ms, "rows_served": client.stats()["rows_served"],
        "rows_unserved": client.stats()["rows_unserved"],
        "tenant_hits": stats["tenant_hits"],
        "tenant_pfs_fallbacks": stats["tenant_pfs_fallbacks"],
        "tenant_sheds": stats["tenant_sheds"], "per_tenant": per,
        "storm_client": storm_stats or None,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "generate_ms": gen_s * 1e3, "launches": counts, "card": card,
    }
    log("[tier_serve] " + json.dumps(row))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches


def phase_tier_serve(card: str) -> tuple[list, dict]:
    """Returns the ``tier_serve`` rows and {kernel: {path: launches}}."""
    import tempfile

    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.launch import train_surrogate
    from repro_torch.serve.datatier import (DataTierClient, ServeTierConfig,
                                            StandaloneTier, TenantConfig, TierAuthError)

    config = ServeTierConfig(tenants=(
        TenantConfig(1, TIER_TOKENS[1]),
        TenantConfig(2, TIER_TOKENS[2], rate=TIER_BATCH_RATE, burst=TIER_BATCH_BURST)))
    rows, launches = [], {name: {} for name in counters()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tier_") as tmp:
        t0 = time.perf_counter()
        store = train_surrogate.make_store(SURROGATES["ptychonn"], f"{tmp}/ptychonn.bin",
                                           "binary", TIER_SAMPLES)
        try:
            with StandaloneTier(store, config,
                                resident_ids=np.arange(TIER_RESIDENT)) as tier:
                log(f"[tier_serve] tier on {tier.endpoint}: {TIER_SAMPLES} samples of "
                    f"{store.sample_bytes} B, {TIER_RESIDENT} resident; up in "
                    f"{time.perf_counter() - t0:.1f}s")
                bad = DataTierClient({0: tier.endpoint}, tenant=1, token="not-the-token",
                                     timeout_s=10.0)
                try:
                    bad.warmup()
                except TierAuthError as e:
                    log(f"[tier_serve] a wrong token is refused: {e}")
                else:
                    raise AssertionError("the tier accepted a wrong token")
                finally:
                    bad.close()
                for arch, batch, prompt, gen, cli in TIER_SERVE:
                    t1 = time.perf_counter()
                    row, by_path = tier_model(tier, store, arch, batch, prompt, gen, cli, card)
                    rows.append(row)
                    for path, counts in by_path.items():
                        for name, n in counts.items():
                            launches[name][path] = n
                    log(f"[tier_serve] {arch} {time.perf_counter() - t1:.1f}s")
                per = tier.stats()["per_tenant"]
        finally:
            store.close()
    if per["1"]["sheds"] != 0 or per["2"]["sheds"] == 0:
        raise AssertionError(f"tenant sheds {per}: tenant 2 must be shed, tenant 1 never")
    return rows, launches


def _start_storm(endpoints) -> subprocess.Popen:
    """Tenant 2's read storm in a process of its own
    (``repro_torch.serve.tenant_load``, numpy-only), attached on return."""
    book = ",".join(f"{n}={h}:{p}" for n, (h, p) in sorted(endpoints.items()))
    cmd = [sys.executable, "-m", "repro_torch.serve.tenant_load", "--endpoints", book,
           "--tenant", "2", "--token", TIER_TOKENS[2], "--num-samples", str(TIER_SAMPLES),
           "--ids", str(TIER_STORM_IDS), "--pause", str(TIER_STORM_PAUSE_S), "--seed", "2"]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.strip() or json.loads(line) != {"ready": True}:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the storm process did not attach: {line!r}")
    return proc


def _stop_storm(proc: subprocess.Popen) -> dict:
    """Close the storm's stdin; returns its client stats."""
    out, _ = proc.communicate(timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"the storm process exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def _dist_tier_spec(path):
    from repro_torch.core.scheduler import SolarConfig
    from repro_torch.data import LoaderSpec

    return LoaderSpec(
        loader="solar", backend="binary", path=path, num_nodes=DIST_TIER_NODES,
        local_batch=DIST_TIER_LOCAL_BATCH, num_epochs=DIST_TIER_EPOCHS,
        buffer_size=DIST_TIER_BUFFER, seed=0, collect_data=True, peer_fetch=True,
        transport="socket", prefetch_depth=DIST_TIER_DEPTH,
        solar=SolarConfig(num_nodes=DIST_TIER_NODES, local_batch=DIST_TIER_LOCAL_BATCH,
                          buffer_size=DIST_TIER_BUFFER, seed=0, capacity_factor=1.0,
                          enable_peer=True))


def _dist_main_runs(eng, endpoints, ids, direct, store_rows, want, runner) -> dict:
    """The reads and the two main runs (alone, then under tenant 2's storm)
    against the ranks' tier; returns their readings and launch counts."""
    from repro_torch.serve.datatier import DataTierClient

    arch, _, prompt, gen = DIST_TIER
    out_row = {"read_ms": [], "launches": {}}
    client = DataTierClient(endpoints, tenant=1, token=TIER_TOKENS[1], timeout_s=10.0)
    storm = None
    try:
        for _ in range(5):
            t0 = time.perf_counter()
            rows, ok = client.read(ids)
            out_row["read_ms"].append((time.perf_counter() - t0) * 1e3)
        if not ok.all() or rows.tobytes() != store_rows.tobytes():
            raise AssertionError("the ranks' tier rows differ from the store's")
        for label in ("alone", "storm"):
            if label == "storm":
                storm = _start_storm(endpoints)
                time.sleep(0.2)
            # The main path: counts set to 0 just before, read just after.
            reset_counts()
            t0 = time.perf_counter()
            out, served = eng.generate_from_tier(client, ids, gen, prompt_len=prompt)
            out_row[f"generate_ms_{label}"] = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            live = runner.is_alive()
            out_row["launches"][f"{arch} dist tier {label}"] = counts
            log(f"[dist_tier_serve] {arch} generate_from_tier {label}: "
                f"{out_row[f'generate_ms_{label}']:.1f} ms; served {served.tolist()}; "
                f"launches {counts}; run live {live}")
            if any(counts[k] != want[k] for k in counts):
                raise AssertionError(f"{arch}: launches {counts}, want {want}")
            if not served.all():
                raise AssertionError(f"{arch}: the ranks' tier served {served.tolist()}")
            if not np.array_equal(out, direct):
                raise AssertionError(f"{arch}: tier-fed tokens differ from direct-prompt "
                                     f"tokens in {(out != direct).sum()} of {out.size}")
            if not live:
                raise AssertionError(f"the distributed run ended before the {label} main run "
                                     f"did: raise DIST_TIER_EPOCHS ({DIST_TIER_EPOCHS})")
        out_row["storm_client"] = _stop_storm(storm)
        storm = None
        out_row["tenant_1_client"] = client.stats()
    finally:
        client.close()
        if storm is not None:
            storm.kill()
            storm.communicate()
    return out_row


def phase_dist_tier_serve(card: str) -> tuple[list, dict]:
    """hymba-1.5b served from a data tier held by launcher ranks; returns the
    ``dist_tier_serve`` rows and {kernel: {path: launches}}.

    ``run_distributed`` runs in a thread of this process and its ranks are
    spawned processes: each imports this script again (as ``__mp_main__``:
    ~2-3 s and ~0.2 GB for its torch import, no CUDA context), then the
    numpy-only loader.  ``on_tier_ready`` only hands the endpoints over, so
    the launcher's poll loop never blocks; serving runs on this thread."""
    import tempfile
    import threading

    from repro_torch.configs import get_config
    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.data import plan
    from repro_torch.launch import train_surrogate
    from repro_torch.models import lm
    from repro_torch.obs import report as obs_report
    from repro_torch.runtime import in_process_digests, run_distributed
    from repro_torch.serve.datatier import ServeTierConfig, TenantConfig, rows_to_prompts
    from repro_torch.serve.engine import ServeEngine

    arch, batch, prompt, gen = DIST_TIER
    cfg = get_config(arch)
    want = expected_counts(cfg, gen)
    ids = np.arange(TIER_FIRST_ID, TIER_FIRST_ID + batch, dtype=np.int64)
    config = ServeTierConfig(tenants=(
        TenantConfig(1, TIER_TOKENS[1]),
        TenantConfig(2, TIER_TOKENS[2], rate=TIER_BATCH_RATE, burst=TIER_BATCH_BURST)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_tier_") as tmp:
        t0 = time.perf_counter()
        store = train_surrogate.make_store(SURROGATES["ptychonn"], f"{tmp}/ptychonn.bin",
                                           "binary", TIER_SAMPLES)
        try:
            store_rows = store.read_scattered(ids)
        finally:
            store.close()  # the ranks reopen it
        spec = _dist_tier_spec(f"{tmp}/ptychonn.bin")
        schedule = plan(spec)
        log(f"[dist_tier_serve] store and plan ({schedule.num_steps} steps) in "
            f"{time.perf_counter() - t0:.1f}s")
        # The engine the CLI builds, warmed by the direct-prompt run that the
        # tier-fed runs must equal.
        params = lm.init_lm(cfg, seed=0, device="cuda")
        eng = ServeEngine(cfg, params, max_len=prompt + gen + 1, device="cuda")
        prompts = rows_to_prompts(store_rows, prompt, cfg.vocab_size)
        direct = eng.generate(prompts, gen)

        ready, run = threading.Event(), {}

        def on_tier_ready(info):  # called from the launcher's poll loop
            run["info"] = info
            ready.set()

        def launch():
            try:
                run["report"] = run_distributed(
                    spec, schedule=schedule, timeout_s=DIST_TIER_TIMEOUT_S, serve_tier=config,
                    on_tier_ready=on_tier_ready, trace_dir=f"{tmp}/traces")
            except BaseException as e:  # re-raised on this thread
                run["error"] = e
            finally:
                ready.set()

        runner = threading.Thread(target=launch, name="run-distributed")
        t_run = time.perf_counter()
        runner.start()
        try:
            if not ready.wait(120.0) or "info" not in run:
                raise AssertionError(f"the ranks' tier never came up: {run.get('error')!r}")
            log(f"[dist_tier_serve] tier up on {len(run['info']['endpoints'])} ranks in "
                f"{time.perf_counter() - t_run:.1f}s")
            main = _dist_main_runs(eng, run["info"]["endpoints"], ids, direct, store_rows,
                                   want, runner)
        finally:
            runner.join(timeout=DIST_TIER_TIMEOUT_S)
        run_s = time.perf_counter() - t_run
        if "error" in run:
            raise run["error"]
        report = run["report"]
        t0 = time.perf_counter()
        ref = in_process_digests(spec, schedule=schedule)
        ref_s = time.perf_counter() - t0
        summ = report.summary()
        if not report.ok or report.digests() != ref:
            raise AssertionError(f"the ranks' digests differ from in_process_digests "
                                 f"(dead ranks {report.dead})")
        if summ["stale_refusals"] or summ["peer_fallbacks"]:
            raise AssertionError(f"the storm reached the loader: {summ['stale_refusals']} "
                                 f"stale refusals, {summ['peer_fallbacks']} peer fallbacks")
        per = {}
        for r in report.ranks:
            for tid, c in r.tenants.get("per_tenant", {}).items():
                row = per.setdefault(tid, dict.fromkeys(("hits", "peer_reads",
                                                         "pfs_fallbacks", "sheds"), 0))
                for k in row:
                    row[k] += int(c.get(k, 0))
        if per["1"]["sheds"] != 0 or per["2"]["sheds"] == 0:
            raise AssertionError(f"tenant sheds {per}: tenant 2 must be shed, tenant 1 never")
        trace_failures = obs_report.check(f"{tmp}/traces")
        if trace_failures:
            raise AssertionError(f"the ranks' traces fail the report's check: {trace_failures}")
        trace = obs_report.analyze(f"{tmp}/traces")["cluster"]
    # The same generate with no loader running: what the ranks' load costs.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, gen)
    idle_ms = (time.perf_counter() - t0) * 1e3
    prefill_ms = host_ms(lambda: eng.prefill(prompts), repeats=3)
    decode_ms = statistics.median(decode(eng, prompts, gen) for _ in range(3))
    launches = {name: {path: counts[name] for path, counts in main["launches"].items()}
                for name in counters()}
    row = {
        "arch": arch, "layers": cfg.num_layers, "batch": batch, "prompt": prompt, "gen": gen,
        "first_id": int(ids[0]), "ranks": DIST_TIER_NODES, "plan_steps": schedule.num_steps,
        "epochs": DIST_TIER_EPOCHS, "prefetch_depth": DIST_TIER_DEPTH,
        "read_ms_median_of_5": statistics.median(main["read_ms"]), "read_ms": main["read_ms"],
        "generate_ms_alone": main["generate_ms_alone"],
        "generate_ms_storm": main["generate_ms_storm"],
        "storm_over_alone": main["generate_ms_storm"] / main["generate_ms_alone"],
        "generate_ms_no_loader": idle_ms,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "per_tenant": per, "tenant_1_client": main["tenant_1_client"],
        "storm_client": main["storm_client"],
        "rank_step_ms_p50": summ["latency"]["step_ms_p50"],
        "rank_step_ms_p95": summ["latency"]["step_ms_p95"],
        "rank_steps": summ["latency"]["step_count"], "run_wall_s": report.wall_time_s,
        "run_s": run_s, "reference_digests_s": ref_s, "trace_check": "OK",
        "trace_coverage": trace["coverage"],
        "trace_barrier_ms_per_step": trace["barrier_ms_per_step"],
        "stale_refusals": summ["stale_refusals"], "peer_fallbacks": summ["peer_fallbacks"],
        "launches": main["launches"], "card": card,
    }
    log("[dist_tier_serve] " + json.dumps(row))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return [row], launches


def time_calls(calls: dict, **kw) -> dict:
    """Graph-replay device ms per call of each entry (eager logged beside)."""
    graph = {name: graph_ms(fn, **kw) for name, fn in calls.items()}
    eager = {name: cuda_ms(fn, iters=kw.get("iters", 20)) for name, fn in calls.items()}
    return {"graph": graph, "eager": eager}


def phase_report(launches: dict, worst: dict, worst_bwd: dict, library_device_ms: dict) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import scan_variants
    from repro_torch.kernels import selective_scan as ss

    clock_hz = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def attn_times(shape, **kw):
        q, k, v = attention_inputs(shape, torch.bfloat16)
        causal, window = shape[6], shape[7]
        mask = mask_ok(shape[3], shape[4], causal, window, "cuda")
        t = time_calls(**kw, calls={
            "kernel": lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
            "plain": lambda: ref.attention_ref(q, k, v, causal=causal, window=window),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=None if window == 0 else mask,
                is_causal=causal and window == 0, enable_gqa=True),
        })
        bound_ms, bound_by = attention_bound(q, k, causal, window)
        admitted, computed = score_entries(shape)
        g = t["graph"]
        g["tflop_s"] = 4 * shape[5] * admitted / (g["kernel"] * 1e-3) / 1e12
        g["admitted_share"] = admitted / computed
        log(f"[report] flash_attention {shape} ms per call: {t}; bound {bound_ms:.4f} "
            f"({bound_by}); {g['tflop_s']:.1f} TFLOP/s of admitted scores; mask admits "
            f"{admitted} of {computed} computed scores ({g['admitted_share']:.4f})")
        return g, bound_ms, bound_by

    hy, hy_bound, hy_by = attn_times(ATTN_HYMBA)
    qw, qw_bound, qw_by = attn_times(ATTN_QWEN)
    q32, k32, v32 = attention_inputs(ATTN_QWEN, torch.float32)
    f32_ms = graph_ms(lambda: fa.flash_attention(q32, k32, v32, causal=True))
    log(f"[report] flash_attention {ATTN_QWEN} f32 (SIMT kernel) ms per call (graph): "
        f"{f32_ms:.4f}")
    # the moe, vlm and encdec paths' shapes: hd 128, non-causal ragged keys
    more = {}
    for name, shape in ATTN_MORE.items():
        t, bound_ms, bound_by = attn_times(shape, iters=5, repeats=5)
        more[name] = {"shape": attention_label(shape), "kernel_ms": t["kernel"],
                      "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": t["library"], "tflop_s": t["tflop_s"],
                      "admitted_share": t["admitted_share"]}
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "shape": "q [4,25,1536,64] k/v [4,5,1536,64] bf16 causal window 1024 (hymba-1.5b)",
        "launches": sum(launches["flash_attention"].values()),
        "launches_by_path": launches["flash_attention"],
        "max_abs_err": worst["flash_attention"]["serve"],
        "tolerance": TOL["flash_attention"][torch.bfloat16],
        "sweep_max_abs_err": {k: v for k, v in worst["flash_attention"].items() if k != "serve"},
        "ms": hy["kernel"], "kernel_ms": hy["kernel"], "plain_ms": hy["plain"],
        "bound_ms": hy_bound, "bound_by": hy_by, "library_ms": hy["library"],
        "tflop_s": hy["tflop_s"], "admitted_share": hy["admitted_share"],
        "qwen2_shape": {"shape": "q [4,14,512,64] k/v [4,2,512,64] bf16 causal",
                        "kernel_ms": qw["kernel"], "plain_ms": qw["plain"],
                        "bound_ms": qw_bound, "bound_by": qw_by,
                        "library_ms": qw["library"], "tflop_s": qw["tflop_s"],
                        "admitted_share": qw["admitted_share"],
                        "f32_simt_kernel_ms": f32_ms},
        "more_shapes": more,
    })

    def scan_times(shape):
        args = scan_inputs(shape, torch.bfloat16)
        # the earlier one-thread-per-channel design, timed beside the kernel
        earlier = scan_variants.per_channel(args)
        err = max((g - w).abs().max().item()
                  for g, w in zip(earlier(), ref.selective_scan_ref(*args)))
        if err > TOL["selective_scan"][torch.bfloat16]:
            raise AssertionError(f"earlier scan kernel {shape}: max_abs_err {err:.3e}")
        g = time_calls({"kernel": lambda: ss.selective_scan(*args), "earlier": earlier})["graph"]
        # the plain version is ~7 launches per timestep: fewer calls per graph
        t = {**g, "plain": graph_ms(lambda: ref.selective_scan_ref(*args), iters=2, repeats=3,
                                    warmup=1)}
        bound_ms, bound_by, parts = scan_bound(args[0], args[2], clock_hz)
        log(f"[report] selective_scan {shape} bf16 ms per call: {t}; bound "
            f"{bound_ms:.4f} ({bound_by}; parts {parts}, max SM clock {clock_hz / 1e6:.0f} "
            f"MHz); {ss.launch_plan(*shape, sms=sms)}; earlier design's max_abs_err {err:.3e}")
        return t, bound_ms, bound_by

    sh, sh_bound, sh_by = scan_times(SCAN_HYMBA)
    sf, sf_bound, sf_by = scan_times(SCAN_FALCON)
    rows.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:61",
        "shape": "u/dt [4,1536,3200] B/C [4,1536,16] bf16, a [3200,16] f32 (hymba-1.5b)",
        "launches": sum(launches["selective_scan"].values()),
        "launches_by_path": launches["selective_scan"],
        "max_abs_err": worst["selective_scan"]["serve"],
        "tolerance": TOL["selective_scan"][torch.bfloat16],
        "sweep_max_abs_err": {k: v for k, v in worst["selective_scan"].items()
                              if not k.startswith("serve")},
        "ms": sh["kernel"], "kernel_ms": sh["kernel"], "plain_ms": sh["plain"],
        "bound_ms": sh_bound, "bound_by": sh_by,
        "library_ms": None,  # no PyTorch call computes a selective scan
        "earlier_ms": sh["earlier"],
        "f32_max_abs_err": worst["selective_scan"]["serve_f32"],
        "f32_tolerance": TOL["selective_scan"][torch.float32],
        "falcon_shape": {"shape": "u/dt [4,512,8192] B/C [4,512,16] bf16",
                         "kernel_ms": sf["kernel"], "plain_ms": sf["plain"],
                         "bound_ms": sf_bound, "bound_by": sf_by, "library_ms": None,
                         "earlier_ms": sf["earlier"]},
    })

    def norm_times(shape):
        x, scale = norm_inputs(shape, torch.bfloat16)
        weight = 1 + scale  # precomputed outside the timed library call
        t = time_calls({
            "kernel": lambda: rn.rms_norm(x, scale, eps=1e-6),
            "plain": lambda: ref.rms_norm_ref(x, scale, 1e-6),
            "library": lambda: F.rms_norm(x, (shape[1],), weight=weight, eps=1e-6),
        })["graph"]
        bound_ms, bound_by = norm_bound(x, scale)
        log(f"[report] rms_norm {shape} bf16 ms per call (graph): {t}; bound "
            f"{bound_ms:.4f} ({bound_by}); {rn.launch_shape(*shape, x.dtype)}")
        return t, bound_ms, bound_by

    nh, nh_bound, nh_by = norm_times(NORM_HYMBA)
    nf, nf_bound, nf_by = norm_times(NORM_FALCON)
    nm, nm_bound, nm_by = norm_times(NORM_QWEN_MOE)
    decode = {}
    for shape in NORM_DECODE:
        t, bound_ms, _ = norm_times(shape)
        decode[f"{shape[0]}x{shape[1]}"] = {
            "kernel_ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
            "library_ms": t["library"]}
    rows.append({
        "name": "rms_norm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:26",
        "shape": "x [6144,1600] bf16, scale [1600] bf16 (hymba-1.5b prefill)",
        "launches": sum(launches["rms_norm"].values()),
        "launches_by_path": launches["rms_norm"],
        "max_abs_err": worst["rms_norm"]["serve"],
        "tolerance": TOL["rms_norm"][torch.bfloat16],
        "sweep_max_abs_err": {k: v for k, v in worst["rms_norm"].items() if k != "serve"},
        "ms": nh["kernel"], "kernel_ms": nh["kernel"], "plain_ms": nh["plain"],
        "bound_ms": nh_bound, "bound_by": nh_by, "library_ms": nh["library"],
        "falcon_shape": {"shape": "x [2048,4096] bf16", "kernel_ms": nf["kernel"],
                         "plain_ms": nf["plain"], "bound_ms": nf_bound,
                         "bound_by": nf_by, "library_ms": nf["library"]},
        "qwen2_moe_shape": {"shape": "x [2048,2048] bf16 (qwen2-moe-a2.7b prefill)",
                            "kernel_ms": nm["kernel"], "plain_ms": nm["plain"],
                            "bound_ms": nm_bound, "bound_by": nm_by,
                            "library_ms": nm["library"]},
        "decode_rows": decode,
    })
    rows += report_bwd(launches, worst_bwd, clock_hz, library_device_ms)
    return rows


def attention_bwd_bound(q, k, causal: bool, window: int):
    """Least time (ms) for attention's backward: the larger of the bytes (q,
    k, v, o, dO and the row log-sum-exp read once; dq, dk, dv written once)
    over HBM and 10 * hd FLOPs per admitted score (S recomputed, dP, dV, dQ,
    dK: five products) over the bf16 tensor-core peak."""
    b, h, sq, hd = q.shape
    flops = 10 * hd * int(mask_ok(sq, k.shape[2], causal, window).sum()) * b * h
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def scan_bwd_bound(u, a, clock_hz: float):
    """Least time (ms) for the scan's backward: the largest of the bytes (u,
    dt, B, C, a, d_skip and the f32 dy read once; du, ddt, dB, dC in the
    input dtype and the f32 da, dd_skip written once) over HBM, one exp per
    (b, t, d, n) (each step's decay) over the special function units, and
    14 f32 operations per (b, t, d, n) (dh = decay * dh + C dy; one FMA each
    into dA, ddt, du, dB and dC) over the f32 peak."""
    b, s, di = u.shape
    n = a.shape[1]
    elems = b * s * di * n
    nbytes = 2 * (2 * u.numel() + 2 * b * s * n) * u.element_size() \
        + 2 * (a.numel() + di) * 4 + u.numel() * 4
    parts = {"bytes": nbytes / HBM_BYTE_S * 1e3,
             "exp": elems / (SFU_PER_SM_CLK * SMS * clock_hz) * 1e3,
             "f32_ops": 14 * elems / PEAK_F32_FLOP_S * 1e3}
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts


def _grad_device_ms(out, leaves, grad, calls: int) -> list:
    """Device time (ms) of the kernels one ``torch.autograd.grad`` call of
    ``out`` launches, from ``torch.profiler`` traces of ``calls`` calls after
    one untraced.  On the H100 a trace may lose some or all of a call's
    kernels (one of F.rms_norm's backward held only its weight-gradient
    kernel, some held none), so calls are traced, at most 4 * calls times,
    until ``calls`` traces hold every kernel as often as any trace did; only
    those count."""
    from torch.autograd import DeviceType

    def call():
        torch.autograd.grad(out, leaves, grad, retain_graph=True)

    call()
    traces, whole = [], []
    for _ in range(4 * calls):
        events = profiled_run(call, cpu=False).key_averages()
        traces.append({e.key: (e.count, e.self_device_time_total / 1e3) for e in events
                       if e.device_type == DeviceType.CUDA})
        most = {}
        for t in traces:
            for key, (count, _) in t.items():
                most[key] = max(most.get(key, 0), count)
        whole = [t for t in traces if {k: c for k, (c, _) in t.items()} == most]
        if len(whole) >= calls:
            break
    return [sum(ms for _, ms in t.values()) for t in whole[:calls]]


def bwd_device_ms(calls: int = 5) -> dict:
    """Device times from ``torch.profiler`` traces, by arch.  The library's
    backward, as the device time of its kernels (median of ``calls`` traced
    ``torch.autograd.grad`` calls): SDPA's at ``ATTN_TRAIN``'s shapes (the
    window's mask where there is one, else ``is_causal``) under
    ``"attention"``, ``F.rms_norm``'s (weight 1 + scale) at ``NORM_TRAIN``'s
    under ``"rms_norm"``.  Under ``"rms_norm_bwd_kernels"``, the mean device
    ms a call of each of the RMSNorm backward's two kernels over 20 traced
    calls.  Taken right after ``kernels_bwd``: on the H100 the same trace
    taken in the report phase, after the serving and training phases'
    traces, held no device time."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    from repro_torch.kernels import rmsnorm as rn

    out = {"attention": {}, "rms_norm": {}, "rms_norm_bwd_kernels": {}}
    for name, shape in ATTN_TRAIN.items():
        q, k, v = attention_inputs(shape, torch.bfloat16)
        causal, window = shape[6], shape[7]
        do = cotangent(q.shape, torch.bfloat16)
        mask = mask_ok(shape[3], shape[4], causal, window, "cuda") if window else None
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           is_causal=causal and not window, enable_gqa=True)
        times = _grad_device_ms(o, leaves, do, calls)
        out["attention"][name] = statistics.median(times) if times else None
        log(f"[report] SDPA backward {shape} bf16, device ms of its kernels per call: "
            f"{times}")
    for name, shape in NORM_TRAIN.items():
        x, scale = norm_inputs(shape, torch.bfloat16)
        leaves = [x.detach().requires_grad_(True), (1 + scale).detach().requires_grad_(True)]
        out_ = F.rms_norm(leaves[0], (shape[1],), weight=leaves[1], eps=1e-6)
        times = _grad_device_ms(out_, leaves, cotangent(x.shape, torch.bfloat16), calls)
        out["rms_norm"][name] = statistics.median(times) if times else None
        log(f"[report] F.rms_norm backward {shape} bf16, device ms of its kernels per call: "
            f"{times}")
        dy = cotangent(x.shape, torch.bfloat16)
        rn.rms_norm_bwd(x, scale, dy)
        for _ in range(5):  # until a trace holds both kernels (the split is not checked)
            events = profiled_run(lambda: [rn.rms_norm_bwd(x, scale, dy) for _ in range(20)],
                                  cpu=False).key_averages()
            by_kernel = {e.key.split("<")[0].split("::")[-1]:
                         e.self_device_time_total / 1e3 / e.count
                         for e in events if e.device_type == DeviceType.CUDA and e.count}
            if len(by_kernel) == 2:
                break
        out["rms_norm_bwd_kernels"][name] = by_kernel
        log(f"[report] rms_norm_bwd {shape} bf16, device ms per call by kernel: {by_kernel}")
    for lib in ("attention", "rms_norm"):
        for name, ms in out[lib].items():
            if not ms:
                raise AssertionError(f"no trace of the {lib} library backward at {name} "
                                     "held its kernels")
    return out


def report_bwd(launches: dict, worst_bwd: dict, clock_hz: float,
               library_device_ms: dict) -> list:
    """The backward kernels' rows: CUDA-graph times at the training shapes
    (hymba-1.5b's, and the other models' beside it), the
    plain versions (autograd through ``kernels/ref.py``) and the library's
    backward, timed eagerly (host clock included) and, from
    ``bwd_device_ms``, as its kernels' device time."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import selective_scan as ss

    rows = []
    eager = dict(iters=1, repeats=3, warmup=1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def lib_bwd(fn, inputs, grad):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)

    def attn_bwd_times(shape):
        q, k, v = attention_inputs(shape, torch.bfloat16)
        causal, window = shape[6], shape[7]
        do = cotangent(q.shape, torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
        mask = mask_ok(shape[3], shape[4], causal, window, "cuda") if window else None
        library = lib_bwd(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask, is_causal=causal and not window, enable_gqa=True),
            (q, k, v), do)
        t = {"kernel": graph_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                               causal=causal, window=window)),
             "plain": cuda_ms(lambda: ref.attention_ref_bwd(q, k, v, do, causal=causal,
                                                            window=window), **eager),
             "library": cuda_ms(library, **eager)}
        splits = fa.bwd_gqa_splits(*shape[:5], causal, window, sms=sms)
        bound_ms, bound_by = attention_bwd_bound(q, k, causal, window)
        log(f"[report] flash_attention_bwd {shape} bf16 ms per call: {t}; bound {bound_ms:.4f} "
            f"({bound_by}); dK/dV and dQ blocks' shared memory {fa.bwd_tc_smem_bytes(shape[5])} B;"
            f" GQA group in {splits} chunks")
        return t, bound_ms, bound_by, splits

    hy, hy_bound, hy_by, hy_splits = attn_bwd_times(ATTN_TRAIN["hymba-1.5b"])
    qw, qw_bound, qw_by, qw_splits = attn_bwd_times(ATTN_TRAIN["qwen2-0.5b"])
    more = {}
    for name, shape in ATTN_TRAIN.items():
        if name in ("hymba-1.5b", "qwen2-0.5b"):
            continue
        t, bound_ms, bound_by, splits = attn_bwd_times(shape)
        more[name] = {"shape": attention_label(shape) + " (training microbatch)",
                      "kernel_ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": t["library"],
                      "library_device_ms": library_device_ms["attention"][name],
                      "gqa_splits": splits}
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "note": "the TPU kernel has no VJP; this is the gradient of its plain path",
        "shape": "q/dO [2,25,2048,64] k/v [2,5,2048,64] bf16 causal window 1024 "
                 "(hymba-1.5b training microbatch)",
        "launches": sum(launches["flash_attention_bwd"].values()),
        "launches_by_path": launches["flash_attention_bwd"],
        "max_abs_err": worst_bwd["flash_attention_bwd"]["train_bfloat16"],
        "error_measure": "max |diff| / max(1, max |plain|) over dq, dk, dv",
        "tolerance": TOL_BWD[torch.bfloat16],
        "sweep_max_abs_err": worst_bwd["flash_attention_bwd"],
        "ms": hy["kernel"], "kernel_ms": hy["kernel"], "plain_ms": hy["plain"],
        "bound_ms": hy_bound, "bound_by": hy_by,
        # SDPA's backward (with the window's mask; causal alone: is_causal):
        # eager host-clock time, and the device time of its kernels
        "library_ms": hy["library"],
        "library_device_ms": library_device_ms["attention"]["hymba-1.5b"],
        "gqa_splits": hy_splits,
        "qwen2_shape": {"shape": "q/dO [4,14,2048,64] k/v [4,2,2048,64] bf16 causal "
                                 "(qwen2-0.5b training microbatch)",
                        "kernel_ms": qw["kernel"], "plain_ms": qw["plain"],
                        "bound_ms": qw_bound, "bound_by": qw_by, "library_ms": qw["library"],
                        "library_device_ms": library_device_ms["attention"]["qwen2-0.5b"],
                        "gqa_splits": qw_splits},
        "more_shapes": more,
    })

    def scan_bwd_times(shape):
        args = scan_inputs(shape, torch.bfloat16)
        dy = cotangent(args[0].shape, torch.float32)
        _, _, hck = ss.selective_scan_fwd(*args, checkpoints=True)
        t = {"kernel": graph_ms(lambda: ss.selective_scan_bwd(*args, hck, dy)),
             "plain": cuda_ms(lambda: ref.selective_scan_ref_bwd(*args, dy), **eager)}
        bound_ms, bound_by, parts = scan_bwd_bound(args[0], args[2], clock_hz)
        plan = ss.bwd_launch_plan(*shape)
        log(f"[report] selective_scan_bwd {shape} bf16 ms per call: {t}; bound {bound_ms:.4f} "
            f"({bound_by}; parts {parts}); {plan}")
        return t, bound_ms, bound_by, parts, plan

    sh, sh_bound, sh_by, sh_parts, sh_plan = scan_bwd_times(SCAN_TRAIN["hymba-1.5b"])
    sf, sf_bound, sf_by, sf_parts, sf_plan = scan_bwd_times(SCAN_TRAIN["falcon-mamba-7b"])
    rows.append({
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "replaces": "src/repro/kernels/selective_scan.py:61",
        "note": "the TPU kernel has no VJP; this is the gradient of its plain path",
        "shape": "u/dt [2,2048,3200] B/C [2,2048,16] bf16, dy f32 (hymba-1.5b training "
                 "microbatch)",
        "launches": sum(launches["selective_scan_bwd"].values()),
        "launches_by_path": launches["selective_scan_bwd"],
        "max_abs_err": worst_bwd["selective_scan_bwd"]["train_bfloat16"],
        "error_measure": "max |diff| / max(1, max |plain|) over du, ddt, da, dB, dC, dD",
        "tolerance": TOL_BWD[torch.bfloat16],
        "sweep_max_abs_err": worst_bwd["selective_scan_bwd"],
        "ms": sh["kernel"], "kernel_ms": sh["kernel"], "plain_ms": sh["plain"],
        "bound_ms": sh_bound, "bound_by": sh_by, "bound_parts_ms": sh_parts,
        "library_ms": None,  # no PyTorch call computes a selective scan
        "plan": [sh_plan.lanes, sh_plan.per_lane],
        "falcon_shape": {"shape": "u/dt [2,2048,8192] B/C [2,2048,16] bf16, dy f32 "
                                  "(falcon-mamba-7b training microbatch)",
                         "kernel_ms": sf["kernel"], "plain_ms": sf["plain"],
                         "bound_ms": sf_bound, "bound_by": sf_by, "bound_parts_ms": sf_parts,
                         "library_ms": None, "plan": [sf_plan.lanes, sf_plan.per_lane]},
    })

    def norm_bwd_times(arch):
        shape = NORM_TRAIN[arch]
        x, scale = norm_inputs(shape, torch.bfloat16)
        dy = cotangent(x.shape, torch.bfloat16)
        library = lib_bwd(lambda x_, w_: F.rms_norm(x_, (shape[1],), weight=w_, eps=1e-6),
                          (x, 1 + scale), dy)
        t = {"kernel": graph_ms(lambda: rn.rms_norm_bwd(x, scale, dy, eps=1e-6)),
             "plain": graph_ms(lambda: ref.rms_norm_ref_bwd(x, scale, dy, 1e-6)),
             "library": cuda_ms(library, iters=20)}
        # x and dy read once, dx written once, scale read and ds written once
        nbytes = 3 * x.numel() * x.element_size() + 2 * scale.numel() * scale.element_size()
        bound_ms = nbytes / HBM_BYTE_S * 1e3
        plan = rn.bwd_launch_shape(*shape, x.dtype, sms=sms)
        log(f"[report] rms_norm_bwd {shape} bf16 ms per call: {t}; bound {bound_ms:.4f} (bytes); "
            f"F.rms_norm backward device ms {library_device_ms['rms_norm'][arch]:.5f}; {plan}")
        return {"shape": f"x/dy {list(shape)} bf16, scale [{shape[1]}] bf16 ({arch} training "
                         "microbatch)",
                "kernel_ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": t["library"],
                "library_device_ms": library_device_ms["rms_norm"][arch],
                "plan": plan._asdict(),
                "kernels_device_ms": library_device_ms["rms_norm_bwd_kernels"][arch]}

    norm = {arch: norm_bwd_times(arch) for arch in NORM_TRAIN}
    hy = norm["hymba-1.5b"]
    rows.append({
        "name": "rms_norm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rms_norm_bwd.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:26",
        "note": "the TPU kernel has no VJP; this is the JAX package's custom VJP of "
                "its plain rms_norm (src/repro/models/layers.py:63)",
        "shape": hy["shape"],
        "launches": sum(launches["rms_norm_bwd"].values()),
        "launches_by_path": launches["rms_norm_bwd"],
        "max_abs_err": worst_bwd["rms_norm_bwd"]["train_bfloat16"],
        "error_measure": "max |diff| / max(1, max |plain|) over dx, ds",
        "tolerance": TOL_BWD[torch.bfloat16],
        "sweep_max_abs_err": worst_bwd["rms_norm_bwd"],
        "ms": hy["kernel_ms"], "kernel_ms": hy["kernel_ms"], "plain_ms": hy["plain_ms"],
        "bound_ms": hy["bound_ms"], "bound_by": "bytes",
        # F.rms_norm's backward: eager host-clock time, and the device time of its kernels
        "library_ms": hy["library_ms"], "library_device_ms": hy["library_device_ms"],
        "plan": hy["plan"], "kernels_device_ms": hy["kernels_device_ms"],
        "qwen2_shape": norm["qwen2-0.5b"], "falcon_shape": norm["falcon-mamba-7b"],
        "qwen2_moe_shape": norm["qwen2-moe-a2.7b"],
    })
    return rows


def _train_args(arch, nodes, local_batch, buffer, steps, epochs):
    from repro_torch.launch import train_surrogate

    return train_surrogate.build_parser().parse_args([
        "--arch", arch, "--nodes", str(nodes), "--local-batch", str(local_batch),
        "--buffer", str(buffer), "--steps", str(steps), "--epochs", str(epochs)])


@contextlib.contextmanager
def planted(fault: str | None):
    """Patch one fault into ``repro_torch.models.cnn`` for the block."""
    from repro_torch.models import cnn

    saved = {name: getattr(cnn, name) for name in ("same_pads", "_conv_transpose", "_flatten")}
    if fault == "pad (1, 1) at n=16":
        cnn.same_pads = lambda n, *a: (1, 1) if n == 16 else saved["same_pads"](n, *a)
    elif fault == "conv transpose without the flip":
        cnn._conv_transpose = lambda x, w, b, rank: saved["_conv_transpose"](
            x, w.flip(tuple(range(2, rank + 2))), b, rank)
    elif fault == "NCDHW flatten":
        cnn._flatten = lambda h, rank: h.reshape(h.shape[0], -1)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cnn, name, fn)


def phase_train_small():
    """Each surrogate at reduced() in f32: TRAIN_SMALL_STEPS solar steps on
    the card against the CPU; the planted faults must exceed the limit."""
    import tempfile

    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.launch import train_surrogate
    from repro_torch.models import cnn

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_small_") as tmp:
        for arch in ("ptychonn", "autophasenn", "cosmoflow"):
            cfg = SURROGATES[arch].reduced()
            args = _train_args(arch, 2, 4, 16, TRAIN_SMALL_STEPS, 1)
            args.num_workers = 2
            store = train_surrogate.make_store(cfg, f"{tmp}/{arch}.bin", "binary", 64)
            init = cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(1),
                                      device="cpu")

            def run(dev, fault=None):
                params = {k: v.to(dev) for k, v in init.items()}
                with planted(fault):
                    t = train_surrogate.train_loader(cfg, store, "solar", args, dev,
                                                     params=params)
                return ([m["loss"] for m in t.metrics_history],
                        {k: v.cpu().double() for k, v in t.state["params"].items()})

            try:
                want = run("cpu")
                reset_counts()
                got = run("cuda")
                counts = read_counts()

                def drift(run_):
                    (la, pa), (lb, pb) = run_, want
                    loss = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
                    num = math.sqrt(sum(float(((pa[k] - pb[k]) ** 2).sum()) for k in pb))
                    den = math.sqrt(sum(float((pb[k] ** 2).sum()) for k in pb))
                    return max(loss, num / den), loss, num / den

                d, dl, dp = drift(got)
                faults = {f: drift(run("cuda", f))[0]
                          for f, archs in TRAIN_FAULTS.items() if arch in archs}
            finally:
                store.close()
            log(f"[train_small] {arch} reduced f32, {TRAIN_SMALL_STEPS} solar steps, "
                f"card vs cpu: drift {d:.3e} (loss {dl:.3e}, params {dp:.3e}; limit "
                f"{TRAIN_SMALL_LIMIT:g}); planted faults "
                f"{ {k: float(f'{v:.4g}') for k, v in faults.items()} } (each must exceed "
                f"the limit); losses {[round(v, 6) for v in got[0]]}; launches {counts}")
            if len(got[0]) != TRAIN_SMALL_STEPS or not all(map(math.isfinite, got[0])):
                raise AssertionError(f"{arch}: the card's small run did not finish")
            if not d <= TRAIN_SMALL_LIMIT:
                raise AssertionError(f"{arch}: the card's training drifts {d:.3e} from the CPU")
            if not all(v > TRAIN_SMALL_LIMIT for v in faults.values()):
                raise AssertionError(f"{arch}: the limit misses a planted fault: {faults}")
            if any(counts.values()):
                raise AssertionError(f"{arch}: a hand-written kernel ran: {counts}")


def _first_grads(cfg, store, loader, args, params, n):
    """Weighted-sum gradients of the first ``n`` steps of ``loader``'s plan."""
    from repro_torch.data import build_pipeline
    from repro_torch.launch import train_surrogate
    from repro_torch.models import cnn

    pipe = build_pipeline(train_surrogate.loader_spec(store, loader, args,
                                                      num_epochs=1, prefetch_depth=0))
    make_batch = train_surrogate.make_batch_fn(cfg, pipe.capacity)
    out = []
    for sb in pipe:
        if len(out) == n:
            break
        b = {k: torch.from_numpy(v).cuda() for k, v in make_batch(sb).items()}
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss, m = cnn.surrogate_loss(leaves, b, cfg)
        out.append(dict(zip(leaves, torch.autograd.grad(loss * m["tokens"],
                                                        list(leaves.values())))))
    return out


def _step_device_time(cfg, store, loader, args, init, calls=5) -> dict:
    """Device time of the training step alone, from a profiler trace of
    ``calls`` steps on ``loader``'s first batch (padded to its capacity),
    against their unprofiled wall time."""
    from repro_torch.data import build_pipeline
    from repro_torch.launch import train_surrogate
    from repro_torch.train.step import init_train_state

    pipe = build_pipeline(train_surrogate.loader_spec(store, loader, args, prefetch_depth=0))
    sb = next(iter(pipe))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_surrogate.make_batch_fn(cfg, pipe.capacity)(sb).items()}
    opt, step = train_surrogate.make_step(cfg, args)
    state = init_train_state({k: v.cuda() for k, v in init.items()}, opt)

    def steps():
        nonlocal state
        for _ in range(calls):
            state, _ = step(state, batch)

    steps()  # warm-up: cuDNN picks its algorithms
    wall = host_ms(steps) / calls
    return device_time(lambda: profiled_run(steps), wall, calls)


def phase_train() -> list:
    """Each surrogate at full width through the launcher, naive then solar;
    returns the ``train`` line's rows."""
    import tempfile

    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.launch import train_surrogate
    from repro_torch.models import cnn

    rows = []
    for arch, samples, nodes, local_batch, buffer, steps in TRAIN:
        cfg = SURROGATES[arch]
        args = _train_args(arch, nodes, local_batch, buffer, steps, 6)
        global_batch = nodes * local_batch
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            t0 = time.perf_counter()
            store = train_surrogate.make_store(cfg, f"{tmp}/{arch}.bin", "binary", samples)
            log(f"[train] {arch}: {samples} samples of {store.sample_bytes} B, store "
                f"written in {time.perf_counter() - t0:.1f}s")
            init = cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
            try:
                runs = {}
                for loader in ("naive", "solar"):
                    store.reset_counters()
                    params = {k: v.cuda() for k, v in init.items()}
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    t = train_surrogate.train_loader(cfg, store, loader, args, "cuda",
                                                     params=params)
                    counts = read_counts()
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    hist = t.metrics_history
                    wall = t.wait_time_s + t.load_time_s + t.compute_time_s
                    losses = [m["loss"] for m in hist]
                    rep_ = t.loader.report
                    n = len(hist)
                    row = {
                        "arch": arch, "loader": loader, "steps": n,
                        "global_batch": global_batch,
                        "rows_per_step": nodes * t.loader.capacity,
                        "sample_bytes": store.sample_bytes,
                        "compute_ms_per_step": 1e3 * t.compute_time_s / n,
                        "load_ms_per_step": 1e3 * t.load_time_s / n,
                        "wait_ms_per_step": 1e3 * t.wait_time_s / n,
                        "wall_ms_per_step": 1e3 * wall / n,
                        "load_frac": t.load_time_s / (t.load_time_s + t.compute_time_s),
                        "samples_per_s": sum(m["tokens"] for m in hist) / wall,
                        "numPFS": rep_.total_pfs, "hit_rate": rep_.hit_rate,
                        "modeled_pfs_s": rep_.modeled_time_s,
                        "loader_wall_s": rep_.wall_time_s,
                        "peak_device_gib": peak,
                        "first_loss": losses[0], "last_loss": losses[-1],
                        "kernel_launches": counts,
                    }
                    busy = _step_device_time(cfg, store, loader, args, init)
                    row["device_ms_per_step"] = busy["device_ms"]
                    row["step_alone_wall_ms"] = busy["wall_ms"]
                    row["device_busy_share"] = (busy["device_ms"] or 0.0) / row["wall_ms_per_step"]
                    log(f"[train] {arch} {loader}: one step alone: device "
                        f"{busy['device_ms']} ms of {busy['wall_ms']:.3f} ms wall (busy "
                        f"{busy['busy_share']}); top kernels {busy['top']}")
                    rows.append(row)
                    runs[loader] = hist
                    log(f"[train] {arch} {loader}: {json.dumps(row)}")
                    tail = losses[-max(n // 10, 1):]
                    if n != steps or not all(map(math.isfinite, losses)):
                        raise AssertionError(f"{arch} {loader}: {n} of {steps} steps, "
                                             "or a loss that is not finite")
                    if not sum(tail) / len(tail) < losses[0]:
                        raise AssertionError(f"{arch} {loader}: the loss did not fall")
                    if any(m["tokens"] != global_batch for m in hist):
                        raise AssertionError(f"{arch} {loader}: a step's weight is not "
                                             f"the global batch {global_batch}")
                    if any(counts.values()):
                        raise AssertionError(f"{arch} {loader}: a hand-written kernel "
                                             f"ran on the training path: {counts}")

                # paper Eq. 3: solar's step-k batch gives naive's step-k gradient
                params = {k: v.cuda() for k, v in init.items()}
                gn = _first_grads(cfg, store, "naive", args, params, TRAIN_GRAD_STEPS)
                gs = _first_grads(cfg, store, "solar", args, params, TRAIN_GRAD_STEPS)
                grad_err = max(
                    float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
                    for a, b in zip(gs, gn) for k in b)
                log(f"[train] {arch}: solar vs naive gradients, first {len(gn)} steps: max "
                    f"|diff| / max |g| {grad_err:.3e} (tol {TRAIN_GRAD_TOL:g})")
                if len(gn) != TRAIN_GRAD_STEPS or not grad_err <= TRAIN_GRAD_TOL:
                    raise AssertionError(f"{arch}: solar's gradient is not naive's")

                # a checkpoint at step k resumes into the same step ids
                k = TRAIN_RESUME_AT
                ckpt = f"{tmp}/ckpt"
                train_surrogate.train_loader(
                    cfg, store, "solar", args, "cuda", max_steps=k, checkpoint_dir=ckpt,
                    checkpoint_every=k, params={n_: v.cuda() for n_, v in init.items()})
                res = train_surrogate.train_loader(
                    cfg, store, "solar", args, "cuda", max_steps=2 * k, checkpoint_dir=ckpt,
                    resume=True, params={n_: v.cuda() for n_, v in init.items()})
                ids = [m["step"] for m in res.metrics_history]
                want = runs["solar"][k:2 * k]
                loss_err = max(abs(m["loss"] - w["loss"]) / abs(w["loss"])
                               for m, w in zip(res.metrics_history, want))
                log(f"[train] {arch}: resumed at step {k}: step ids {ids}; losses vs the "
                    f"uninterrupted run: max rel diff {loss_err:.3e} (tol "
                    f"{TRAIN_RESUME_RTOL:g})")
                if ids != [m["step"] for m in want] or not loss_err <= TRAIN_RESUME_RTOL:
                    raise AssertionError(f"{arch}: the resumed run is not the same run")
                for row in rows[-2:]:
                    row["grad_max_rel_err"] = grad_err
                    row["resume_loss_rel_err"] = loss_err
            finally:
                store.close()
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def expected_train_counts(cfg, microbatches: int) -> dict:
    """Kernel launches of ``microbatches`` forward-and-backward passes of
    the family's ``train_loss``: K2 per attention (``attention_layers``) and
    K3 per layer (ssm, hybrid) once in each forward and once in the
    backward; K1 per block norm (``norm_layers``) plus the final norm (none
    in the encoder-decoder).  Remat runs each block's forward again in the
    backward (a two-level scan a third time); the final norm lies outside
    the blocks."""
    layers = cfg.num_layers
    passes = 1 + bool(cfg.remat) + bool(cfg.remat and cfg.scan_block
                                        and layers % cfg.scan_block == 0
                                        and cfg.family != "encdec")
    attn = attention_layers(cfg)
    scan = layers if cfg.family in ("ssm", "hybrid") else 0
    norms, final = norm_layers(cfg), int(cfg.family != "encdec")
    return {k: v * microbatches for k, v in {
        "flash_attention": attn * passes, "flash_attention_bwd": attn,
        "selective_scan": scan * passes, "selective_scan_bwd": scan,
        "rms_norm": norms * passes + final, "rms_norm_bwd": norms + final}.items()}


def kernel_families(cfg) -> set:
    """The hand-written kernels ``cfg``'s forward path runs."""
    fam = set()
    if cfg.family != "encdec":
        fam.add("rms_norm")
    if cfg.family != "ssm":
        fam.add("flash_attention")
    if cfg.family in ("ssm", "hybrid"):
        fam.add("selective_scan")
    return fam


@contextlib.contextmanager
def planted_bwd(fault: str | None):
    """Patch one fault into a backward kernel's wrapper for the block (the
    autograd Functions look the wrappers up when they run)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import selective_scan as ss

    saved = (fa.flash_attention_bwd, rn.rms_norm_bwd, ss.selective_scan_bwd)

    def attn(q, k, v, o, lse, do, **kw):
        dq, dk, dv = saved[0](q, k, v, o, lse, do, **kw)
        if fault == "dV zeroed":
            return dq, dk, torch.zeros_like(dv)
        # "GQA sum dropped": dK, dV of the first query head of each group only
        g = q.shape[1] // k.shape[1]

        def first(t):
            return t[:, ::g].contiguous()
        _, dk1, dv1 = saved[0](first(q), k, v, first(o), first(lse), first(do), **kw)
        return dq, dk1, dv1

    def norm(*a, **kw):
        dx, ds = saved[1](*a, **kw)
        return dx, torch.zeros_like(ds)

    def scan(*a, **kw):
        du, ddt, da, db, dc, dd = saved[2](*a, **kw)
        return du, ddt, torch.zeros_like(da), db, dc, dd

    if fault in ("dV zeroed", "GQA sum dropped"):
        fa.flash_attention_bwd = attn
    elif fault == "ds skipped":
        rn.rms_norm_bwd = norm
    elif fault == "da skipped":
        ss.selective_scan_bwd = scan
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        fa.flash_attention_bwd, rn.rms_norm_bwd, ss.selective_scan_bwd = saved


def lm_batch(cfg, batch, seq, seed=0) -> dict:
    """Tokens, shifted labels (a few ignored: -1) and weights on the card;
    standard normal f32 patch embeddings (vlm) or source frames (encdec)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :7] = -1
    out = {"tokens": torch.from_numpy(tokens).cuda(),
           "labels": torch.from_numpy(labels).cuda(),
           "weights": torch.ones(batch, device="cuda")}
    prefix = {"vlm": ("patches", cfg.num_patches), "encdec": ("source", cfg.source_len)}
    if cfg.family in prefix:
        name, n = prefix[cfg.family]
        out[name] = torch.from_numpy(
            rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)).cuda()
    return out


def phase_lm_small():
    """``LM_SMALL``: loss (the moe aux included) and every gradient leaf
    through the kernels against the same weights through the plain versions,
    in f32 at full width (the encoder-decoder: ``layers`` encoder and decoder
    layers, ``seq`` decoder tokens over its 1500 source frames; the vlm
    family: after its 576 patches), the plain run's moe routes pinned to the
    kernel run's; the planted backward faults must land
    LM_SMALL_FAULT_FACTOR times beyond the limit."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, lm

    for arch, layers, batch, seq in LM_SMALL:
        cfg = get_config(arch).replace(num_layers=layers, param_dtype="float32",
                                       compute_dtype="float32")
        if cfg.family == "encdec":
            cfg = cfg.replace(encoder_layers=layers)
            model, impl_names = encdec, ("attn_impl",)
        else:
            model, impl_names = lm, ("attn_impl", "ssm_impl", "norm_impl")
        kernels = dict.fromkeys(impl_names, "pallas")
        plain = dict.fromkeys(impl_names, "ref")
        init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
        flat = lm.flat_params(init(cfg, seed=0, device="cuda"))
        g = torch.Generator(device="cuda").manual_seed(1)
        for name, t in flat.items():  # the zero-initialised norm scales and biases
            if not t.abs().max().item():
                t.add_(0.05 * torch.randn(t.shape, generator=g, device="cuda"))
        b = lm_batch(cfg, batch, seq)

        def run(impls):
            leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
            loss, _ = model.train_loss(lm.nested_params(leaves), b, cfg, **impls)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), dict(zip(leaves, grads))

        routes = []
        reset_counts()
        with pinned_routes(routes, replay=False):
            got_loss, got = run(kernels)
        counts = read_counts()
        with pinned_routes(routes, replay=True) as pinned:
            want_loss, want = run(plain)

        def drift(got_loss, got):
            worst = abs(got_loss.item() - want_loss.item()) / abs(want_loss.item())
            for k, w in want.items():
                scale = max(w.abs().max().item(), 1e-30)
                worst = max(worst, (got[k] - w).abs().max().item() / scale)
            return worst

        want_counts = expected_train_counts(cfg, 1)
        d = drift(got_loss, got)
        fams = kernel_families(cfg)
        faults = (["ds skipped"] if "rms_norm" in fams else []) + \
            (["dV zeroed"] if "flash_attention" in fams else []) + \
            (["GQA sum dropped"] if "flash_attention" in fams
             and cfg.num_heads != cfg.num_kv_heads else []) + \
            (["da skipped"] if "selective_scan" in fams else [])
        fault_drift = {}
        for fault in faults:
            with planted_bwd(fault):
                fault_drift[fault] = drift(*run(kernels))
        shape = f"batch {batch} x {seq}" + (
            f" after {cfg.num_patches} patches" if cfg.family == "vlm" else
            f" over {cfg.source_len} source frames" if cfg.family == "encdec" else "")
        log(f"[lm_small] {arch} full width, {layers} layers, f32, {shape}: "
            f"loss {got_loss.item():.6f} (plain {want_loss.item():.6f}); drift kernels vs "
            f"plain {d:.3e} (limit {LM_SMALL_LIMIT:g}); planted faults "
            f"{ {k: float(f'{v:.4g}') for k, v in fault_drift.items()} } (each must exceed "
            f"{LM_SMALL_FAULT_FACTOR}x the limit); moe routes pinned {pinned}; launches "
            f"{counts}")
        if counts != want_counts:
            raise AssertionError(f"{arch}: launches {counts}, want {want_counts}")
        if not math.isfinite(got_loss.item()) or not d <= LM_SMALL_LIMIT:
            raise AssertionError(f"{arch}: gradients through the kernels drift {d:.3e}")
        if not fault_drift or not all(v >= LM_SMALL_FAULT_FACTOR * LM_SMALL_LIMIT
                                      for v in fault_drift.values()):
            raise AssertionError(f"{arch}: the limit misses a planted fault: {fault_drift}")
        del flat, got, want, routes
        gc.collect()
        torch.cuda.empty_cache()


def phase_lm_train() -> tuple[list, dict]:
    """``LM_TRAIN`` through ``launch.train`` on the card: returns the
    ``lm_train`` line's rows and {kernel: {"<arch> train": launches}}."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as ltrain

    rows, launches = [], {name: {} for name in counters()}
    for arch, layers, timed, seq in LM_TRAIN:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
            args = ltrain.build_parser().parse_args(
                ["train", "--arch", arch, "--seq-len", str(seq), *LM_TRAIN_ARGS,
                 "--steps", str(1 + timed), "--data", f"{tmp}/{arch}.bin"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # The main path: counts set to 0 just before, read just after.
            reset_counts()
            t0 = time.perf_counter()
            trainer = ltrain.train(args, "cuda", cfg=cfg)
            run_s = time.perf_counter() - t0
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
        hist, times = trainer.metrics_history, trainer.step_times
        rows_per_step = args.nodes * trainer.loader.capacity
        want = {k: v * (1 + timed) for k, v in expected_train_counts(
            cfg, cfg.grad_accum).items()}
        losses = [m["loss"] for m in hist]
        steps = []
        for m, st in list(zip(hist, times))[1:]:
            wall = st["wait_s"] + st["load_s"] + st["compute_s"]
            steps.append({"step": m["step"], "loss": m["loss"], "tokens": m["tokens"],
                          "compute_ms": st["compute_s"] * 1e3, "load_ms": st["load_s"] * 1e3,
                          "wait_ms": st["wait_s"] * 1e3, "wall_ms": wall * 1e3,
                          "tokens_per_s": m["tokens"] / wall})
        # one more step on a batch of the same shape: its device time from a
        # trace of the card's kernels, against the timed steps' mean wall time
        _, step = ltrain.make_step(cfg, args)
        b = lm_batch(cfg, rows_per_step, args.seq_len, seed=1)
        state = {"s": trainer.state}

        def one_step():
            state["s"], _ = step(state["s"], b)

        wall_ms = statistics.mean(s_["wall_ms"] for s_ in steps)
        busy = device_time(lambda: profiled_run(one_step, cpu=False), wall_ms, 1)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        for name, n in counts.items():
            launches[name][f"{arch} train"] = n
        row = {
            "arch": arch, "layers": cfg.num_layers, "family": cfg.family,
            "param_dtype": cfg.param_dtype, "params": cfg.num_params(),
            "encoder_layers": cfg.encoder_layers, "seq_len": args.seq_len,
            "patches": cfg.num_patches, "source_frames": cfg.source_len,
            "rows_per_step": rows_per_step,
            "grad_accum": cfg.grad_accum, "microbatch": rows_per_step // cfg.grad_accum,
            "steps": len(hist), "timed_steps": steps, "first_loss": losses[0],
            "last_loss": losses[-1], "run_s": run_s,
            "compute_ms_per_step": statistics.mean(s_["compute_ms"] for s_ in steps),
            "load_ms_per_step": statistics.mean(s_["load_ms"] for s_ in steps),
            "wait_ms_per_step": statistics.mean(s_["wait_ms"] for s_ in steps),
            "wall_ms_per_step": statistics.mean(s_["wall_ms"] for s_ in steps),
            "tokens_per_s": sum(s_["tokens"] for s_ in steps)
            / (sum(s_["wall_ms"] for s_ in steps) / 1e3),
            "step_device_ms": busy["device_ms"],
            "device_busy_share": busy["busy_share"], "top_kernels": busy["top"],
            "peak_device_gib": peak, "launches": counts, "expected_launches": want,
        }
        rows.append(row)
        for s_ in steps:
            log(f"[lm_train] {arch} step {s_['step']}: loss {s_['loss']:.4f}, compute "
                f"{s_['compute_ms']:.1f} ms, load {s_['load_ms']:.1f} ms, wait "
                f"{s_['wait_ms']:.1f} ms, wall {s_['wall_ms']:.1f} ms, "
                f"{s_['tokens_per_s']:.0f} tokens/s")
        log(f"[lm_train] {arch}: {json.dumps(row)}")
        if counts != want:
            raise AssertionError(f"{arch}: launches {counts}, want {want}")
        if len(hist) != 1 + timed or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{arch}: {len(hist)} steps, or a loss that is not finite")
        if any(m["tokens"] <= 0 for m in hist):
            raise AssertionError(f"{arch}: a step weighed no token")
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        card = nvidia_smi("name,power.limit")
        log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
        # Plain versions in full f32: no TF32 in matmuls or convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("[device] allow_tf32 = False (matmul and cudnn)")
        start = t0 = time.perf_counter()

        def done(phase):
            nonlocal t0
            log(f"[time] {phase} {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()

        phase_build()
        done("build")
        worst = phase_kernels()
        done("kernels")
        worst_bwd = phase_kernels_bwd()
        library_device_ms = bwd_device_ms()
        done("kernels_bwd")
        phase_small()
        done("small")
        phase_lm_small()
        done("lm_small")
        launches = phase_serve()
        done("serve")
        tier_rows, tier_launches = phase_tier_serve(card)
        for name, by_path in tier_launches.items():
            launches[name].update(by_path)
        done("tier_serve")
        dist_rows, dist_launches = phase_dist_tier_serve(card)
        for name, by_path in dist_launches.items():
            launches[name].update(by_path)
        done("dist_tier_serve")
        phase_train_small()
        done("train_small")
        train_rows = phase_train()
        done("train")
        lm_rows, lm_launches = phase_lm_train()
        done("lm_train")
        for name, by_path in lm_launches.items():
            launches[name].update(by_path)
        rows = phase_report(launches, worst, worst_bwd, library_device_ms)
        done("report")
        log(f"[time] all phases {time.perf_counter() - start:.1f}s")
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    print(json.dumps({"train": train_rows}), flush=True)
    print(json.dumps({"lm_train": lm_rows}), flush=True)
    print(json.dumps({"tier_serve": tier_rows}), flush=True)
    print(json.dumps({"dist_tier_serve": dist_rows}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
