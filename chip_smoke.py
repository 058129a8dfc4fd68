#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run in order, each of which must pass:
  1. build   — compile every hand-written kernel under ``src/repro_torch/
               kernels/csrc`` (three forward, three backward and the stem
               convolution's weight gradient) with nvcc, one process per
               source, in parallel;
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
               language model's kernel lies on this path: their launch
               counts, set to 0 before each run, must read 0 after it; the
               stem convolution's weight gradient must launch once a step
               for each of ``cnn.stem_layers`` (train_small too).  Prints a
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
     stream_train — hymba-1.5b at full width and depth, bf16, trains on
               sealed stream windows while two producer threads ingest
               (``repro_torch.stream.run_stream``, overlapped planning,
               ``prefetch_depth`` 2, ``verify``): a memory store of 1024
               token rows of 2049, reservoir admission of 512, 3 windows of
               2 steps of 2 nodes x 8 rows.  The ``on_batch`` hook stages
               each batch through ``PinnedBatchStager`` and runs
               ``launch.train``'s step.  Plan and stream parity with the
               one-shot offline replan, 3 windows and 6 steps, launch counts
               of 6 x ``expected_train_counts``, finite losses and 16
               weighted rows a step; then ``python -m repro_torch.launch.
               train stream --verify`` in three child processes (overlapped,
               ``--stop-the-world``, ``--distributed``), each of which must
               exit 0.  Prints a ``{"stream_train": [...]}`` line;
     sharded — in a spawned child process owning a one-rank NCCL group and
               its (1, 1) ``("data", "model")`` mesh (``make_local_mesh``):
               hymba-1.5b at full width and depth, bf16, on ``lm_train``'s
               planned batches (2 nodes x capacity 8, grad_accum 8), 2 steps
               with params and moments as DTensors against 2
               plain steps from the same init (losses and every param leaf
               equal bit for bit, launches 2 x ``expected_train_counts``
               each); the sharded state checkpointed whole, restored with
               ``shardings=`` and stepped once more, equal to the step
               without the round trip; ``compressed_psum`` of one
               microbatch's gradient of ``layers.ssm.in_proj`` equal to
               ``quantize_dequantize``; minitron-8b at full width and depth
               serving batch 4, prompt 512, 32 tokens with its 8 kv heads
               repeated to 16 (``model_axis`` 16) and as they are: greedy
               tokens, prefill logits (the cache layout leaves prefill as
               it was) and decode logits (each query head reads its kv
               head among the repeated ones) equal bit for bit, launches
               exact, prefill and decode timed in alternating turns.  Prints a ``{"sharded": [...]}``
               line;
     dryrun  — ``repro_torch.launch.dryrun``: a spawned child owning the
               fake process group reckons qwen2-0.5b ``train_4k`` and
               hymba-1.5b ``prefill_32k`` on the 16x16 and 2x16x16 meshes
               (every cell ``ok``) while this process reckons the cells'
               one-card programs on meta tensors; then each program runs on
               the card at full width and depth, bf16, seed 0 (qwen2-0.5b's
               step on the 16x16 data rank's 16 rows × 4096 at grad_accum
               4, hymba-1.5b's prefill of 2 × 32768): warm-up, a main run
               timed with the launch counts set to 0 just before and read
               just after, a traced run, a run under ``op_analysis``.  Dot
               FLOPs by dtype, traffic bytes and the kernels' work must
               equal the meta reckoning, the launches its kernel calls, the
               reckoned peak ``max_memory_allocated`` within
               ``DRYRUN_PEAK_TOL``, the roofline bound at most
               ``DRYRUN_MAX_SHARE`` of the device time, and the 16x16
               cell's dot FLOPs a device the closed form of the card's
               split along ``model`` (``whole_dot_flops``).  Prints a
               ``{"dryrun": [...]}`` line;
     tp      — tensor parallelism along ``model``: two spawned model ranks
               of a (data 1, model 2) mesh on the one card over gloo train
               (``launch.train.make_step(mesh=)``) and serve
               (``ServeEngine(mesh=)``) ``TP_MODELS`` in bf16 while a third
               process reckons their programs on meta tensors; rank 0 then
               runs the plain bf16 and f32 programs.  Each rank's dot FLOPs
               and kernel work (``op_analysis`` on the card) must equal the
               reckoning, which must equal the plain program's whole parts
               (qwen2-moe-a2.7b's router and slot products among them,
               whisper-medium's logits) and half the rest; every K2 and K3
               launch takes the rank's heads and channels and every moe
               layer the rank's 32 of 64 experts, each rank's cache holds
               its kv heads (whisper-medium's self- and cross-attention
               caches) or, hymba-1.5b's, its 512 of 1024 slots, the launch
               counts are the plain run's, both ranks'
               expert choices are equal (digests) and the plain runs
               replay rank 0's (``pinned_routes``, tokens moved reported),
               each rank's peak lies below the plain run's, every K2 and K3
               input rank 0 met is held, through the kernel and its backward,
               against the plain version at ``TOL`` and ``TOL_BWD``, and
               losses (their mean over the steps), params and logits drift
               from the f32 run at most ``BF16_DRIFT_RATIO`` times the plain
               bf16 run's (greedy tokens equal where the plain top-2 margin
               exceeds that).  Prints a ``{"tp": [...]}`` line;
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
               cross-attention, K1 at d = 2048; the stem convolution's
               weight gradient at cosmoflow's cell shape, B 24 of 128^3 x
               4, beside its f32 bound, its plain version and cuDNN's
               ``conv3d_weight``), the card's name and power limit, and last
               the ``{"ok": true, "device": ...}`` line.

Exits non-zero and prints no result when there is no card or a phase
fails.  Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# Streaming: hymba-1.5b (seq 2048) on 3 windows of 2 steps, 2 nodes x 8 rows
# (a stream's capacity is its local batch: no padding rows), over 1024 token
# rows that two producers ingest at 64 rows/s into a reservoir of 512; a seal
# waits for 32 fresh rows.
STREAM_TRAIN = ("hymba-1.5b", 2048)
STREAM_ROWS = 1024
STREAM_SPEC = dict(num_nodes=2, local_batch=8, buffer_size=64, seed=0, prefetch_depth=2)
STREAM_WINDOWS = dict(window_steps=2, admission="reservoir", reservoir_size=512,
                      watermark=32, max_windows=3)
STREAM_INGEST = dict(seed=0, admission="reservoir", reservoir_size=512, max_pending=256)
STREAM_PRODUCERS = dict(threads=2, data_seed=0, rate_hz=64)
STREAM_CLI = ["stream", "--nodes", "2", "--num-samples", "2048", "--window-steps", "8",
              "--watermark", "32", "--verify"]
STREAM_CLI_MODES = {"overlap": [], "stop_the_world": ["--stop-the-world"],
                    "distributed": ["--distributed"]}
STREAM_CLI_TIMEOUT_S = 300
# Sharding: hymba-1.5b whole (bf16, launch.train's init and AdamW) on
# lm_train's batches (2 nodes x capacity 8 of 2048 tokens, grad_accum 8), 2
# steps on a (1, 1) NCCL mesh and 2 plain ones, then a third after a
# checkpoint round trip; compressed_psum over one gradient leaf; minitron-8b
# whole (nvidia/Minitron-8B-Base) serving batch 4, prompt 512, 32 new tokens
# with its 8 kv heads repeated to 16 and as they are.
SHARDED_TRAIN = ("hymba-1.5b", 2048)
SHARDED_STEPS = 2
SHARDED_PSUM_LEAF = "layers.ssm.in_proj"
SHARDED_SERVE = ("minitron-8b", 4, 512, 32)
SHARDED_MODEL_AXES = (16, 1)
SHARDED_TIMEOUT_S = 600

# The dry run (``repro_torch.launch.dryrun``): cells reckoned in a child on
# both production meshes, and the per-device programs of those cells run on
# the card against the same programs reckoned on meta tensors: qwen2-0.5b's
# train step on the 16x16 mesh's data-rank batch (rows, seq) and hymba-1.5b's
# prefill of its rows, the cache built for the model axis of 16.
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("hymba-1.5b", "prefill_32k"))
DRYRUN_DATA_RANKS = 16
DRYRUN_MODEL_AXIS = 16
DRYRUN_TIMEOUT_S = 300
#: the reckoned peak against ``torch.cuda.max_memory_allocated``
DRYRUN_PEAK_TOL = 0.10
#: the largest roofline bound / measured device time that passes: a count
#: that misses work gives a bound above the time the card took
DRYRUN_MAX_SHARE = 1.05

# Tensor parallelism (``repro_torch.distributed.tensor_parallel``): two model
# ranks of a (data 1, model 2) mesh, two processes on the one card over a
# gloo group (NCCL refuses two ranks on one device), bf16, random weights
# from seed 0.  {arch: (layers (None: whole; the encoder's too), train
# steps, serving batch, prompt, decode steps, train sequence)}; the depths
# are cut (qwen2-0.5b 12 of 24 layers, hymba-1.5b 4 of 32, whisper-medium
# 2 + 2 of 24 + 24) so that the script keeps to its time limit.
# qwen2-0.5b splits everything: K2 on 7 of 14 query heads and 1 of 2 kv
# heads, a 2432-wide MLP, 75968 vocabulary columns; hymba-1.5b's 25 heads
# and 32001 vocabulary do not divide 2, so its attention and logits run
# whole on both ranks, K3 on 1600 of 3200 channels and a 2752-wide MLP,
# and its 5 kv heads do not divide 2 either, so each rank's decode cache
# holds 512 of its ring's 1024 slots (the prompt of 1536 wraps it) and
# decode attends them with a partial softmax all-reduced over the ranks.
# whisper-medium at full width (1500 source frames): K2 on 8 of 16 heads
# in its encoder's self-attention and its decoder's self- and
# cross-attention, 2048 of the GELU MLPs' 4096 hidden units; its
# vocabulary of 51865 does not divide 2, so its tied logits run whole; it
# trains on 448-token rows, whisper's longest decode.
# qwen2-moe-a2.7b at full width, 2 of its 24 layers: K2 on 8 of 16 query
# and kv heads at hd 128, 32 of the 64 padded experts a rank (rank 1's
# block holds the pad experts 60-63), 2816 of the shared expert's 5632
# hidden units, 75968 vocabulary columns, the router whole on both ranks;
# its plain bf16 and f32 runs beside the split state fit the card at 2
# layers.  Each trains on lm_train's 16 rows of 2048
# tokens a step in its config's microbatches.
TP_MODELS = {"qwen2-0.5b": (12, 2, 4, 1536, 32, 2048),
             "hymba-1.5b": (4, 2, 4, 1536, 8, 2048),
             "qwen2-moe-a2.7b": (2, 2, 4, 1536, 8, 2048),
             "whisper-medium": (2, 2, 4, 64, 8, 448)}
TP_ROWS = 16
TP_RANKS = 2
TP_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def counters():
    """{kernel: (wrapper module, its launch count's name)}: the six kernels of
    the language models (the stem's weight gradient counts apart)."""
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
    from repro_torch.kernels import work

    b, h, _, sq, sk, _, causal, window = shape
    admitted = work.admitted_scores(sq, sk, causal, window)
    tiles = 0
    for q0 in range(0, sq, fa.BLOCK_Q):
        begin, end = fa.key_tile_range(q0, sq, sk, causal, window)
        tiles += -(-(end - begin) // fa.BLOCK_K)
    return admitted * b * h, tiles * fa.BLOCK_Q * fa.BLOCK_K * b * h


def attention_bound(q, k, causal: bool, window: int):
    """Least time (ms) for attention on these inputs: the larger of the bytes
    (q, k, v read once, o written once) over HBM and the FLOPs of the
    unmasked score/value products over the bf16 tensor-core peak
    (``kernels/work.attention``)."""
    from repro_torch.kernels import work

    (b, h, sq, hd), (kh, sk) = q.shape, k.shape[1:3]
    w = work.attention(b, h, kh, sq, sk, hd, causal, window, q.element_size())
    t_ops, t_bytes = w.dot_flops / PEAK_BF16_FLOP_S, w.bytes / HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def scan_bound(u, a, clock_hz: float):
    """Least time (ms) for the selective scan on these inputs: the largest of
    the bytes (u, dt, B, C, a, d_skip read once; y and h_last written once
    in f32) over HBM, one exp per (b, t, d, n) over the special function
    units (16 per clock per SM at the card's maximum SM clock), and six f32
    operations per (b, t, d, n) (dt*a; decay*h + du*B; y += h*C) over the f32
    peak (``kernels/work.scan``).  Returns (ms, 'bytes'|'operations', parts)."""
    from repro_torch.kernels import work

    return work_bound(work.scan(*u.shape, a.shape[1], u.element_size()), clock_hz)


def work_bound(w, clock_hz: float):
    """(ms, 'bytes'|'operations', parts) of a ``kernels/work.Work`` of the
    scan: its bytes over HBM, its exps over the special function units (16
    per clock per SM at ``clock_hz``) and its f32 operations over the f32
    peak."""
    parts = {"bytes": w.bytes / HBM_BYTE_S * 1e3,
             "exp": w.exps / (SFU_PER_SM_CLK * SMS * clock_hz) * 1e3,
             "f32_ops": w.f32_ops / PEAK_F32_FLOP_S * 1e3}
    worst = max(parts, key=parts.get)
    return parts[worst], ("bytes" if worst == "bytes" else "operations"), parts


def norm_bound(x, scale):
    """Least time (ms) for RMSNorm: x read once, out written once, scale
    read once, over HBM (a few f32 operations per element are far below;
    ``kernels/work.norm``)."""
    from repro_torch.kernels import work

    w = work.norm(x.numel() // x.shape[-1], x.shape[-1], x.element_size(),
                  scale.element_size())
    return w.bytes / HBM_BYTE_S * 1e3, "bytes"


# cosmoflow's stem in the benchmark's cell: 24 rows of 128^3 x 4 -> 32 channels
STEM_SHAPE = (24, 4, 32, (128, 128, 128))


def stem_inputs(n, cin, cout, dims, seed=5):
    """x and dy of the stem convolution, channels-last as the model hands
    them to the kernel, and the pads ``models/cnn.py`` gives ``dims``."""
    from repro_torch.models import cnn

    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last_3d
    x = torch.randn((n, cin) + dims, generator=g, device="cuda").contiguous(memory_format=cl)
    dy = torch.randn((n, cout) + tuple(-(-s // 2) for s in dims), generator=g,
                     device="cuda").contiguous(memory_format=cl)
    return x, dy, cnn.conv_pads(dims)


def stem_wgrad_row(launches_by_path: dict) -> dict:
    """The stem weight gradient at ``STEM_SHAPE``: the kernel's CUDA-graph
    median, its bound (f32 FFMA and bytes, ``kernels/work.conv_wgrad``), the
    plain version's time and cuDNN's ``conv3d_weight`` (TF32 off) as the
    library's, and the kernel's error against the plain version in f64.
    ``launches_by_path`` are the training runs' launch counts (train_small,
    train); ``report_calls`` counts this row's own calls apart."""
    import torch.nn.functional as F

    from repro_torch.kernels import conv_wgrad, ref, work

    n, cin, cout, dims = STEM_SHAPE
    x, dy, pads = stem_inputs(n, cin, cout, dims)
    assert not torch.backends.cudnn.allow_tf32
    before = conv_wgrad.launches
    got = conv_wgrad.conv3d_stem_wgrad(x, dy, pads)
    want = ref.conv3d_stem_wgrad_ref(x.double(), dy.double(), pads)
    err = max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
    del want
    again = conv_wgrad.conv3d_stem_wgrad(x, dy, pads)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    xp = F.pad(x, pads)
    w_shape = (cout, cin, 3, 3, 3)
    kernel_ms = graph_ms(lambda: conv_wgrad.conv3d_stem_wgrad(x, dy, pads))
    plain_ms = cuda_ms(lambda: ref.conv3d_stem_wgrad_ref(x, dy, pads), iters=3, repeats=3,
                       warmup=1)
    library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(xp, w_shape, dy, stride=2),
                         iters=2, repeats=3, warmup=1)
    w = work.conv_wgrad(dy.numel() // cout, 27 * cin, cout, x.numel())
    parts = {"f32_ops": w.f32_ops / PEAK_F32_FLOP_S * 1e3, "bytes": w.bytes / HBM_BYTE_S * 1e3}
    bound_by = max(parts, key=parts.get)
    report_calls = conv_wgrad.launches - before
    log(f"[report] conv3d_stem_wgrad x [{n},{cin},{dims}] dy [{n},{cout},...] f32: kernel "
        f"{kernel_ms:.4f} ms (graph), plain {plain_ms:.3f}, cuDNN conv3d_weight {library_ms:.3f};"
        f" bound {parts[bound_by]:.4f} ({bound_by}; parts {parts}); max rel err {err:.2e}; "
        f"same bits {same_bits}; training launches {launches_by_path}; report calls "
        f"{report_calls}")
    if not err <= 1e-5 or not same_bits:
        raise AssertionError(f"conv3d_stem_wgrad: error {err:.3e} or runs that differ")
    return {"name": "conv3d_stem_wgrad", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/conv3d_stem_wgrad.cu", "replaces": None,
            "shape": f"x [{n},{cin},{dims[0]},{dims[1]},{dims[2]}] f32 channels-last, dy "
                     f"[{n},{cout},64,64,64] (cosmoflow's stem in its cell)",
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "report_calls": report_calls, "max_rel_err": err, "same_bits": same_bits,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": parts[bound_by], "bound_by": bound_by, "bound_parts_ms": parts,
            "library_ms": library_ms, "library": "torch.nn.grad.conv3d_weight (cuDNN, TF32 off)"}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    kernels = _build.names()
    if kernels != ["conv3d_stem_wgrad", "flash_attention", "flash_attention_bwd", "rms_norm",
                   "rms_norm_bwd", "selective_scan", "selective_scan_bwd"]:
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

    def erf_gelu(x, wi, bi, wo, bo, split=None):  # the engine's params are whole
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
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg)
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
    rows.append(stem_wgrad_row(launches["conv3d_stem_wgrad"]))
    return rows


def attention_bwd_bound(q, k, causal: bool, window: int):
    """Least time (ms) for attention's backward: the larger of the bytes (q,
    k, v, o, dO and the row log-sum-exp read once; dq, dk, dv written once)
    over HBM and 10 * hd FLOPs per admitted score (S recomputed, dP, dV, dQ,
    dK: five products) over the bf16 tensor-core peak
    (``kernels/work.attention_bwd``)."""
    from repro_torch.kernels import work

    (b, h, sq, hd), (kh, sk) = q.shape, k.shape[1:3]
    w = work.attention_bwd(b, h, kh, sq, sk, hd, causal, window, q.element_size())
    t_ops, t_bytes = w.dot_flops / PEAK_BF16_FLOP_S, w.bytes / HBM_BYTE_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def scan_bwd_bound(u, a, clock_hz: float):
    """Least time (ms) for the scan's backward: the largest of the bytes (u,
    dt, B, C, a, d_skip and the f32 dy read once; du, ddt, dB, dC in the
    input dtype and the f32 da, dd_skip written once) over HBM, one exp per
    (b, t, d, n) (each step's decay) over the special function units, and
    14 f32 operations per (b, t, d, n) (dh = decay * dh + C dy; one FMA each
    into dA, ddt, du, dB and dC) over the f32 peak (``kernels/work.scan_bwd``)."""
    from repro_torch.kernels import work

    return work_bound(work.scan_bwd(*u.shape, a.shape[1], u.element_size()), clock_hz)


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
    from repro_torch.kernels import work

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
        nbytes = work.norm_bwd(*shape, x.element_size(), scale.element_size()).bytes
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


def phase_train_small() -> dict:
    """Each surrogate at reduced() in f32: TRAIN_SMALL_STEPS solar steps on
    the card against the CPU; the planted faults must exceed the limit.
    Returns the stem wgrad kernel's launches in each card run, by path."""
    import tempfile

    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.kernels import conv_wgrad
    from repro_torch.launch import train_surrogate
    from repro_torch.models import cnn

    stem_launches = {}
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
                conv_wgrad.launches = 0
                got = run("cuda")
                counts = read_counts()
                stem = conv_wgrad.launches

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
                f"the limit); losses {[round(v, 6) for v in got[0]]}; launches {counts}; "
                f"stem wgrad launches {stem} ({cnn.stem_layers(cfg)} a step)")
            if len(got[0]) != TRAIN_SMALL_STEPS or not all(map(math.isfinite, got[0])):
                raise AssertionError(f"{arch}: the card's small run did not finish")
            if not d <= TRAIN_SMALL_LIMIT:
                raise AssertionError(f"{arch}: the card's training drifts {d:.3e} from the CPU")
            if not all(v > TRAIN_SMALL_LIMIT for v in faults.values()):
                raise AssertionError(f"{arch}: the limit misses a planted fault: {faults}")
            if any(counts.values()):
                raise AssertionError(f"{arch}: a language model's kernel ran: {counts}")
            if stem != TRAIN_SMALL_STEPS * len(cnn.stem_layers(cfg)):
                raise AssertionError(f"{arch}: {stem} stem wgrad launches in "
                                     f"{TRAIN_SMALL_STEPS} steps")
            stem_launches[f"{arch} train_small"] = stem
    return stem_launches


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


def phase_train() -> tuple[list, dict]:
    """Each surrogate at full width through the launcher, naive then solar;
    returns the ``train`` line's rows and the stem wgrad kernel's launches
    in each run, by path."""
    import tempfile

    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.kernels import conv_wgrad
    from repro_torch.launch import train_surrogate
    from repro_torch.models import cnn

    rows, stem_launches = [], {}
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
                    conv_wgrad.launches = 0
                    t = train_surrogate.train_loader(cfg, store, loader, args, "cuda",
                                                     params=params)
                    counts = read_counts()
                    stem = conv_wgrad.launches
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
                        "kernel_launches": counts, "stem_wgrad_launches": stem,
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
                        raise AssertionError(f"{arch} {loader}: a language model's kernel "
                                             f"ran on the training path: {counts}")
                    if stem != n * len(cnn.stem_layers(cfg)):
                        raise AssertionError(f"{arch} {loader}: {stem} stem wgrad launches "
                                             f"in {n} steps")
                    stem_launches[f"{arch} train {loader}"] = stem

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
    return rows, stem_launches


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
        flat = lm.flat_params(init_params(cfg))
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


def _stream_clis(tmp: str) -> list:
    """``python -m repro_torch.launch.train stream --verify`` in one child
    process per mode, all started together, each over its own store; each
    must exit 0.  Returns a row per child."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for mode, extra in STREAM_CLI_MODES.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *STREAM_CLI, *extra,
               "--data", f"{tmp}/cli_{mode}"]
        procs[mode] = (subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter())
    rows = []
    try:
        for mode, (proc, t0) in procs.items():
            out, err = proc.communicate(timeout=STREAM_CLI_TIMEOUT_S)
            wall_s = time.perf_counter() - t0
            for line in err.strip().splitlines()[-6:]:
                log(f"[stream_train] CLI {mode}| {line}")
            if proc.returncode != 0:
                raise AssertionError(f"stream CLI ({mode}) exited {proc.returncode}")
            summary = json.loads(out[out.index("{"):out.rindex("}") + 1])
            rows.append({"run": f"cli {mode}", "windows": summary["windows"],
                         "steps": summary["steps"],
                         "blocked_on_planning_s": summary.get("blocked_on_planning_s"),
                         "verify": summary["verify"], "process_wall_s": wall_s})
            log(f"[stream_train] CLI {mode}: {json.dumps(rows[-1])}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows


def phase_stream_train() -> tuple[list, dict]:
    """hymba-1.5b trains on sealed stream windows while producers ingest
    (``STREAM_*``), then the stream CLI runs in child processes: returns the
    ``stream_train`` line's rows and {kernel: {"<arch> stream_train":
    launches}}."""
    import tempfile
    import threading

    from repro_torch.configs import get_config
    from repro_torch.data import DatasetSpec, LoaderSpec, build_store
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm
    from repro_torch.stream import (IngestSession, StreamSpec, run_producers,
                                    run_stream)
    from repro_torch.train.step import init_train_state
    from repro_torch.train.trainer import PinnedBatchStager

    arch, seq = STREAM_TRAIN
    cfg = get_config(arch)
    steps = STREAM_WINDOWS["window_steps"] * STREAM_WINDOWS["max_windows"]
    rows_per_step = STREAM_SPEC["num_nodes"] * STREAM_SPEC["local_batch"]
    args = ltrain.build_parser().parse_args(["train", "--arch", arch, "--steps", str(steps)])
    opt, step = ltrain.make_step(cfg, args)
    state = {"s": init_train_state(lm.flat_params(lm.init_lm(cfg, seed=ltrain.SEED,
                                                             device="cuda")), opt)}
    make_batch = ltrain.make_batch_fn(cfg, STREAM_SPEC["local_batch"])
    stage = PinnedBatchStager(torch.device("cuda"))
    timed, last = [], {}

    def on_batch(sb):
        batch = make_batch(sb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["s"], m = step(state["s"], stage(batch))
        loss, tokens = float(m["loss"]), float(m["tokens"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        timed.append({"window": sb.epoch, "step": sb.step, "loss": loss, "tokens": tokens,
                      "rows": float(batch["weights"].sum()),
                      "compute_ms": (t1 - t0) * 1e3,
                      "wall_ms": (t1 - last["t"]) * 1e3 if last else None})
        last["t"] = t1

    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        spec = LoaderSpec(loader="stream", backend="memory", path=f"{tmp}/tokens",
                          collect_data=True, **STREAM_SPEC,
                          stream=StreamSpec(**STREAM_WINDOWS))
        store = build_store(spec, create=True,
                            dataset=DatasetSpec(STREAM_ROWS, (seq + 1,), "<i4"),
                            fill="zeros")
        session = IngestSession(store, **STREAM_INGEST)
        producer = threading.Thread(
            target=run_producers, args=(session, range(STREAM_ROWS)),
            kwargs=STREAM_PRODUCERS, name="chip-smoke-producers", daemon=True)
        try:
            producer.start()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # The main path: counts set to 0 just before, read just after
            # (verify's re-execution of the offline replan runs no model).
            reset_counts()
            report = run_stream(spec.replace(store=store, path=None), session,
                                overlap=True, verify=True, on_batch=on_batch)
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            # a producer blocked on put() must not outlive the phase
            session.close()
            producer.join(timeout=30.0)
            store.close()
        if producer.is_alive():
            raise AssertionError("a stream producer outlived its closed session")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        cli_rows = _stream_clis(tmp)

    want = {k: v * steps for k, v in expected_train_counts(cfg, cfg.grad_accum).items()}
    summary = report.summary()
    later = timed[1:]
    row = {
        "run": "main", "arch": arch, "layers": cfg.num_layers,
        "param_dtype": cfg.param_dtype, "params": cfg.num_params(), "seq_len": seq,
        "rows_per_step": rows_per_step, "grad_accum": cfg.grad_accum,
        "store_rows": STREAM_ROWS, "stream": STREAM_WINDOWS, "ingest_config": STREAM_INGEST,
        "producers": STREAM_PRODUCERS, "prefetch_depth": STREAM_SPEC["prefetch_depth"],
        "steps": report.steps, "windows": report.windows, "wall_s": report.wall_s,
        "bootstrap_s": report.bootstrap_s,
        "blocked_on_planning_s": report.blocked_on_planning_s, "plan_s": report.plan_s,
        "window_meta": report.window_meta, "timed_steps": timed,
        "compute_ms_per_step": statistics.mean(s_["compute_ms"] for s_ in later),
        "wall_ms_per_step": statistics.mean(s_["wall_ms"] for s_ in later),
        "tokens_per_s": sum(s_["tokens"] for s_ in later)
        / (sum(s_["wall_ms"] for s_ in later) / 1e3),
        "ingest": summary["ingest"], "loader": summary["loader"],
        "verify": report.verify, "peak_device_gib": peak,
        "launches": counts, "expected_launches": want,
    }
    for s_ in timed:
        log(f"[stream_train] {arch} window {s_['window']} step {s_['step']}: loss "
            f"{s_['loss']:.4f}, {s_['tokens']:.0f} tokens over {s_['rows']:.0f} rows, "
            f"compute {s_['compute_ms']:.1f} ms, wall {s_['wall_ms'] or 0:.1f} ms")
    log(f"[stream_train] {arch}: {json.dumps(row)}")
    if not report.ok:
        raise AssertionError(f"stream parity with the offline replan failed: {report.verify}")
    if (report.windows, report.steps, len(timed)) != (STREAM_WINDOWS["max_windows"], steps,
                                                      steps):
        raise AssertionError(f"{report.windows} windows, {report.steps} steps, "
                             f"{len(timed)} trained")
    if counts != want:
        raise AssertionError(f"{arch} stream: launches {counts}, want {want}")
    if not all(math.isfinite(s_["loss"]) for s_ in timed):
        raise AssertionError(f"{arch} stream: a loss that is not finite")
    if any(s_["rows"] != rows_per_step or s_["tokens"] != rows_per_step * seq
           for s_ in timed):
        raise AssertionError(f"{arch} stream: a step weighed other than "
                             f"{rows_per_step} rows of {seq} labels")
    for r in cli_rows:
        parity = "rank_parity" if r["run"] == "cli distributed" else "stream_parity"
        if not (r["verify"]["plan_parity"] and r["verify"][parity]):
            raise AssertionError(f"stream CLI parity failed: {r}")
    launches = {name: {f"{arch} stream_train": n} for name, n in counts.items()}
    return [row] + cli_rows, launches


# ---------------------------------------------------------------------------
# Sharding: the sharded train step, compressed_psum, the elastic restore and
# repeated-head serving, in a child process that owns the NCCL group
# ---------------------------------------------------------------------------


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN patterns included)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _whole_params(state) -> dict:
    """Copies of the state's params, whole, on the card."""
    return {k: (p.full_tensor() if type(p).__name__ == "DTensor" else p).clone()
            for k, p in state["params"].items()}


def _params_diff(got: dict, want: dict) -> tuple[bool, float]:
    """(every leaf equal bit for bit, the largest |difference|)."""
    same = all(_bitwise(got[k], want[k]) for k in want)
    worst = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    return same, worst


def _sharded_batches(cfg, tmp: str, steps: int) -> tuple:
    """(the launcher's args, ``steps`` planned global batches of
    ``lm_train``'s pipeline on the card: 2 SOLAR nodes, capacity 8,
    zero-weight padding rows)."""
    from repro_torch.data import DatasetSpec, build_pipeline, build_store
    from repro_torch.launch import train as ltrain

    arch, seq = SHARDED_TRAIN
    args = ltrain.build_parser().parse_args(
        ["train", "--arch", arch, "--seq-len", str(seq), *LM_TRAIN_ARGS,
         "--steps", str(steps), "--data", f"{tmp}/{arch}.bin"])
    spec = ltrain.loader_spec(args)
    store = build_store(spec, create=True,
                        dataset=DatasetSpec(args.num_samples, (seq + 1,), "<i4"),
                        fill="random")
    try:
        loader = build_pipeline(spec, store=store)
        make_batch = ltrain.make_batch_fn(cfg, loader.capacity)
        out = []
        for sb in loader:
            out.append({k: torch.from_numpy(v).cuda() for k, v in make_batch(sb).items()})
            if len(out) == steps:
                break
    finally:
        store.close()
    return args, out


def _train_run(step, state, batches) -> tuple:
    """Train ``batches`` from ``state``: (state, losses, compute ms per step,
    launch counts, peak GiB).  The main path: counts set to 0 just before,
    read just after.  The caller keeps no reference to ``state``, so each
    step frees the state before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    reset_counts()
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    return state, losses, ms, counts, torch.cuda.max_memory_allocated() / 2**30


def _stand_in(state) -> dict:
    """A restore template of ``state``'s shapes and dtypes that holds no
    memory: each leaf a broadcast scalar."""
    from repro_torch.optim.adamw import OptState

    def leaf(t):
        return torch.empty((), dtype=t.dtype, device="cuda").expand(t.shape)

    opt = state["opt"]
    return {"params": {k: leaf(v) for k, v in state["params"].items()},
            "opt": OptState({k: leaf(v) for k, v in opt.mu.items()},
                            {k: leaf(v) for k, v in opt.nu.items()}, leaf(opt.step))}


def _sharded_train_part(mesh, tmp: str) -> tuple[list, dict]:
    """(a) 2 sharded steps against 2 plain ones from the same init, (c) a
    checkpoint round trip before a third sharded step, (b)
    ``compressed_psum`` over a gradient leaf."""
    from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import compressed_psum, quantize_dequantize
    from repro_torch.distributed.sharding import param_sharding
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm
    from repro_torch.train.step import init_train_state

    arch, seq = SHARDED_TRAIN
    cfg = get_config(arch)
    args, batches = _sharded_batches(cfg, tmp, SHARDED_STEPS + 1)
    first, third = batches[:SHARDED_STEPS], batches[SHARDED_STEPS]
    one = expected_train_counts(cfg, cfg.grad_accum)
    want = {k: v * SHARDED_STEPS for k, v in one.items()}
    times = {}
    t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        times[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    def init():
        return lm.flat_params(lm.init_lm(cfg, seed=ltrain.SEED, device="cuda"))

    # (a) the sharded run: params and moments as DTensors
    opt, sstep = ltrain.make_step(cfg, args, mesh=mesh)
    state, s_losses, s_ms, s_counts, s_peak = _train_run(
        sstep, init_train_state(init(), opt, mesh=mesh), first)
    s_params = _whole_params(state)
    lap("sharded steps")
    # (c) a checkpoint of the sharded state after step 2, written whole
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_", dir=tmp) as ckdir:
        path = save_checkpoint(ckdir, SHARDED_STEPS, state)
        lap("save")
        # the third step without the round trip, traced for the busy share
        out = {}

        def third_step():
            out["s"], out["m"] = sstep(state, third)

        s_busy = device_time(lambda: profiled_run(third_step, cpu=False),
                             statistics.mean(s_ms[1:]), 1)
        direct_params, direct_loss = _whole_params(out["s"]), float(out["m"]["loss"])
        template = _stand_in(out["s"])
        del state, out
        gc.collect()
        lap("traced third step")
        restored, meta = restore_checkpoint(path, template,
                                            shardings=param_sharding(template, mesh))
        lap("restore")
        reset_counts()
        restored, m = sstep(restored, third)
        r_loss = float(m["loss"])
        r_counts = read_counts()
        same_c, worst_c = _params_diff(_whole_params(restored), direct_params)
        r_dtensor = all(type(p).__name__ == "DTensor" for p in restored["params"].values())
        del restored, m, direct_params
        lap("restored step")
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the plain run from the same init and batches; the sharded params
    # wait on the host, out of its peak
    s_params = {k: v.cpu() for k, v in s_params.items()}
    _, pstep = ltrain.make_step(cfg, args)
    state, p_losses, p_ms, p_counts, p_peak = _train_run(
        pstep, init_train_state(init(), opt), first)
    same_ap, worst_ap = _params_diff({k: v.cuda() for k, v in s_params.items()},
                                     state["params"])
    del s_params
    lap("plain steps")
    # (b) one microbatch's gradient of the scan's input projection, reduced
    # in int8 over the mesh's data axis
    mb = {k: v[: v.shape[0] // cfg.grad_accum] for k, v in first[0].items()}
    leaves = {k: p.detach().requires_grad_(k == SHARDED_PSUM_LEAF)
              for k, p in state["params"].items()}
    loss, _ = lm.train_loss(lm.nested_params(leaves), mb, cfg)
    grad = torch.autograd.grad(loss, leaves[SHARDED_PSUM_LEAF])[0]
    del leaves, loss, state
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    summed = compressed_psum(grad, mesh.get_group("data"))
    torch.cuda.synchronize()
    psum_ms = (time.perf_counter() - t1) * 1e3
    psum_equal = _bitwise(summed, quantize_dequantize(grad))
    psum_row = {"part": "compressed_psum", "leaf": SHARDED_PSUM_LEAF,
                "shape": list(grad.shape), "dtype": str(grad.dtype),
                "group_size": mesh.size(0), "ms": psum_ms, "equal": psum_equal,
                "max_abs": float(grad.float().abs().max())}
    del grad, summed
    gc.collect()
    torch.cuda.empty_cache()
    lap("compressed_psum")
    base = {"arch": arch, "layers": cfg.num_layers, "param_dtype": cfg.param_dtype,
            "params": cfg.num_params(), "seq_len": seq,
            "rows_per_step": int(first[0]["tokens"].shape[0]),
            "real_rows": [float(b["weights"].sum()) for b in batches],
            "grad_accum": cfg.grad_accum, "steps": SHARDED_STEPS,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "expected_launches": want}
    rows = [{**base, "part": "train", "run": "sharded", "losses": s_losses,
             "step_ms": s_ms, "compute_ms_per_step": statistics.mean(s_ms[1:]),
             "peak_device_gib": s_peak, "third_step_device": s_busy,
             "launches": s_counts},
            {**base, "part": "train", "run": "plain", "losses": p_losses,
             "step_ms": p_ms, "compute_ms_per_step": statistics.mean(p_ms[1:]),
             "peak_device_gib": p_peak, "launches": p_counts},
            {"part": "train", "run": "sharded vs plain",
             "losses_equal": s_losses == p_losses, "params_bitwise": same_ap,
             "max_abs_diff": worst_ap},
            psum_row,
            {"part": "elastic_restore", "arch": arch, "save_s": times["save"],
             "restore_s": times["restore"], "step": meta["step"], "dtensor": r_dtensor,
             "loss": r_loss, "loss_without": direct_loss, "params_bitwise": same_c,
             "max_abs_diff": worst_c, "launches": r_counts, "expected_launches": one},
            {"part": "times_s", **times}]
    launches = {name: {f"{arch} sharded train": s_counts[name],
                       f"{arch} sharded vs plain train": p_counts[name],
                       f"{arch} restored step": r_counts[name]} for name in counters()}
    for r in rows:
        log(f"[sharded] {json.dumps(r)}")
    if s_counts != want or p_counts != want or r_counts != one:
        raise AssertionError(f"launches: sharded {s_counts}, plain {p_counts}, "
                             f"restored {r_counts}; want {want} and {one}")
    if not all(map(math.isfinite, s_losses + p_losses)):
        raise AssertionError(f"a loss that is not finite: {s_losses}, {p_losses}")
    if s_losses != p_losses or not same_ap:
        raise AssertionError(f"sharded against plain: losses {s_losses} and {p_losses}, "
                             f"params max |diff| {worst_ap}")
    if not psum_equal:
        raise AssertionError("compressed_psum over one rank differs from quantize_dequantize")
    if not (same_c and r_dtensor and r_loss == direct_loss and meta["step"] == SHARDED_STEPS):
        raise AssertionError(f"the restored step differs: max |diff| {worst_c}, loss "
                             f"{r_loss} against {direct_loss}, DTensors {r_dtensor}")
    return rows, launches


def _serve_turns(engines: dict, prompts, gen, turns: int = 3) -> dict:
    """{key: {"prefill_ms", "decode_ms_per_token"}}: medians over ``turns``
    alternating turns of every engine (host clock, as ``serve``)."""
    pre = {k: [] for k in engines}
    dec = {k: [] for k in engines}
    for _ in range(turns):
        for k, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(prompts)
            torch.cuda.synchronize()
            pre[k].append((time.perf_counter() - t0) * 1e3)
            dec[k].append(decode(eng, prompts, gen))
    return {k: {"prefill_ms": statistics.median(pre[k]),
                "decode_ms_per_token": statistics.median(dec[k])} for k in engines}


def _sharded_serve_part() -> tuple[list, dict]:
    """(d) minitron-8b at full width and depth serves with its 8 kv heads
    repeated to 16 (``model_axis`` 16) and as they are (1)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    arch, batch, prompt, gen = SHARDED_SERVE
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    times = {"init": time.perf_counter() - t0}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt))
    rows, launches, runs, heads = [], {name: {} for name in counters()}, {}, {}
    want = {k: v for k, v in expected_counts(cfg, gen).items() if k in counters()}
    engines = {axis: ServeEngine(cfg, params, max_len=prompt + gen + 1, model_axis=axis,
                                 device="cuda") for axis in SHARDED_MODEL_AXES}
    for axis, eng in engines.items():
        eng.generate(prompts[:, :16], 2)  # first calls out of the timed runs
        torch.cuda.synchronize()
        reset_counts()
        logits, cache = eng.prefill(prompts)
        prefill_counts = read_counts()
        tokens = [torch.argmax(logits, dim=-1)]
        step_logits = []
        reset_counts()
        for _ in range(gen):
            step, cache = eng.step(cache, tokens[-1])
            step_logits.append(step.float().cpu())
            tokens.append(torch.argmax(step, dim=-1))
        step_counts = read_counts()
        main = {k: prefill_counts[k] + step_counts[k] for k in prefill_counts}
        kv_heads = heads[axis] = int(cache["k"].shape[2])
        runs[axis] = {"logits": logits.float().cpu(), "steps": step_logits,
                      "tokens": torch.stack(tokens[:gen], 1).cpu()}
        del cache, logits
        row = {"part": "serve", "arch": arch, "layers": cfg.num_layers,
               "param_dtype": cfg.param_dtype, "params": cfg.num_params(), "batch": batch,
               "prompt": prompt, "gen": gen, "model_axis": axis, "kv_heads": kv_heads,
               "true_kv_heads": cfg.num_kv_heads, "prefill_launches": prefill_counts,
               "launches": main, "expected_launches": want,
               "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
        rows.append(row)
        for name in counters():
            launches[name][f"{arch} model_axis {axis}"] = main[name]
        times[f"model_axis {axis}"] = time.perf_counter() - t0 - sum(times.values())
        log(f"[sharded] {json.dumps(row)}")
        if main != want:
            raise AssertionError(f"{arch} model_axis {axis}: launches {main}, want {want}")
    timed = _serve_turns(engines, prompts, gen)
    for row in rows:
        row.update(timed[row["model_axis"]])
        log(f"[sharded] {arch} model_axis {row['model_axis']}: {timed[row['model_axis']]}")
    times["timing turns"] = time.perf_counter() - t0 - sum(times.values())
    del engines
    a, b = (runs[x] for x in SHARDED_MODEL_AXES)
    tokens_equal = torch.equal(a["tokens"], b["tokens"])
    # prefill attends the un-repeated k/v: equal logits say the cache layout
    # leaves prefill as it was.  Decode reads the cache, so its logits are
    # what tests the repeated heads: each query head must read its own kv
    # head's values among the 16
    prefill_equal = _bitwise(a["logits"], b["logits"])
    decode_equal = all(map(_bitwise, a["steps"], b["steps"]))
    diffs = [float((x - y).abs().max()) for x, y in zip(a["steps"], b["steps"])]
    rows.append({"part": "serve", "run": "model_axis 16 vs 1", "tokens_equal": tokens_equal,
                 "prefill_logits_bitwise": prefill_equal,
                 "decode_logits_bitwise": decode_equal,
                 "decode_logits_max_abs_diff": max(diffs), "times_s": times})
    log(f"[sharded] {json.dumps(rows[-1])}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not (tokens_equal and prefill_equal and decode_equal):
        raise AssertionError(f"{arch}: model_axis 16 against 1: tokens equal {tokens_equal}, "
                             f"prefill logits equal {prefill_equal}, decode logits equal "
                             f"{decode_equal} (max |diff| {max(diffs)})")
    if heads != {16: 2 * cfg.num_kv_heads, 1: cfg.num_kv_heads}:  # each kv head twice
        raise AssertionError(f"{arch}: cached kv heads {heads} at model axes 16 and 1")
    return rows, launches


def _sharded_child(result_path: str) -> None:
    """The ``sharded`` phase's process: a one-rank NCCL group and its (1, 1)
    mesh for the whole phase; writes ``{"rows", "launches"}`` (or the
    traceback) as JSON to ``result_path``."""
    import torch.distributed as dist

    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch.mesh import make_local_mesh

        t0 = time.perf_counter()
        mesh = make_local_mesh()
        log(f"[sharded] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{dist.get_backend()} in {time.perf_counter() - t0:.1f}s")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
            rows, launches = _sharded_train_part(mesh, tmp)
        serve_rows, serve_launches = _sharded_serve_part()
        for name, by_path in serve_launches.items():
            launches[name].update(by_path)
        out = {"rows": rows + serve_rows, "launches": launches}
    except BaseException:  # the parent fails the phase with it
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        Path(result_path).write_text(json.dumps(out))


def phase_sharded() -> tuple[list, dict]:
    """The sharded path in a spawned child process (which imports this
    script again), so the NCCL group lives and dies with it: returns the
    ``sharded`` line's rows and {kernel: {path: launches}}."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_result_") as tmp:
        result = Path(tmp) / "result.json"
        proc = mp.get_context("spawn").Process(target=_sharded_child, args=(str(result),),
                                               name="chip-smoke-sharded")
        proc.start()
        proc.join(SHARDED_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join(30)
            raise AssertionError(f"the sharded child outlived {SHARDED_TIMEOUT_S} s")
        out = json.loads(result.read_text()) if result.exists() else {}
    if "error" in out:
        raise AssertionError(f"the sharded child failed:\n{out['error']}")
    if proc.exitcode != 0 or "rows" not in out:
        raise AssertionError(f"the sharded child exited {proc.exitcode} with no result")
    return out["rows"], out["launches"]


def _dryrun_child(result_path: str) -> None:
    """The ``dryrun`` phase's process: owns the fake process group of each
    production mesh in turn and reckons ``DRYRUN_CELLS`` on it; writes
    ``{"rows"}`` (or the traceback) as JSON to ``result_path``."""
    out = {}
    try:
        from repro_torch.launch.dryrun import analyze_cell, fake_world
        from repro_torch.launch.mesh import make_production_mesh

        rows = []
        for multi_pod in (False, True):
            with fake_world(512 if multi_pod else 256):
                mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
                for arch, shape in DRYRUN_CELLS:
                    rows.append(analyze_cell(arch, shape, multi_pod=multi_pod, mesh=mesh))
        out = {"rows": rows}
    except BaseException:  # the parent fails the phase with it
        out = {"error": traceback.format_exc()}
    finally:
        Path(result_path).write_text(json.dumps(out))


def _dryrun_programs() -> list:
    """[(label, cfg, one-card shape, card args)] of the calibration programs:
    the per-device programs of ``DRYRUN_CELLS`` on the 16x16 mesh, full width
    and depth, bf16, random weights from seed 0."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import clamp_accum
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state

    out = []
    for arch, name in DRYRUN_CELLS:
        cfg, shape = get_config(arch), SHAPES[name]
        shape = dataclasses.replace(shape, global_batch=shape.global_batch // DRYRUN_DATA_RANKS)
        params = lm.flat_params(lm.init_lm(cfg, seed=0, device="cuda"))
        if shape.kind == "train":
            cfg = cfg.replace(grad_accum=clamp_accum(
                cfg, SHAPES[name], DRYRUN_DATA_RANKS * DRYRUN_MODEL_AXIS, DRYRUN_MODEL_AXIS))
            state = init_train_state(params, AdamWConfig(state_dtype=cfg.opt_state_dtype))
            args = (state, lm_batch(cfg, shape.global_batch, shape.seq_len, seed=0))
        else:
            rng = np.random.default_rng(0)
            tokens = rng.integers(0, cfg.vocab_size, (shape.global_batch, shape.seq_len))
            args = (params, {"tokens": torch.from_numpy(tokens.astype(np.int32)).cuda()})
        out.append((f"{arch} {name}", cfg, shape, args))
        del params
    return out


def _calibrate(label, cfg, shape, args, meta) -> tuple[dict, dict]:
    """Run one calibration program on the card (warm-up, the main run timed
    with the launch counts set to 0 just before and read just after and the
    peak memory, a traced run, a run under ``op_analysis``) and hold it
    against ``meta``, its reckoning on meta tensors.  Returns (row, counts)."""
    from repro_torch.launch import dryrun, op_analysis, roofline

    fn, _ = dryrun.cell_program(cfg, shape, None, dryrun.impls("pallas"),
                                model_axis=DRYRUN_MODEL_AXIS)

    def run():
        fn(*args)

    run()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    others = torch.cuda.memory_allocated() - op_analysis.storage_bytes(args, "cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wall_ms = host_ms(run, repeats=1)
    counts = read_counts()
    card_peak = torch.cuda.max_memory_allocated() - others
    busy = device_time(lambda: profiled_run(run, cpu=False), wall_ms, 1)
    t0 = time.perf_counter()
    card = op_analysis.program_stats(fn, *args)
    counted_s = time.perf_counter() - t0
    report = roofline.analyze(cfg.name, shape.name, "1 card", 1, card,
                              roofline.model_flops(cfg, shape))
    bound_ms = report.step_time_s * 1e3
    measured = busy["device_ms"] or wall_ms
    calls = {k: card["kernels"].get(k, {}).get("calls", 0) for k in counts}
    row = {
        "program": label, "rows": shape.global_batch, "seq_len": shape.seq_len,
        "grad_accum": cfg.grad_accum if shape.kind == "train" else None,
        "layers": cfg.num_layers, "param_dtype": cfg.param_dtype,
        "wall_ms": wall_ms, "device_ms": busy["device_ms"],
        "device_busy_share": busy["busy_share"], "top_kernels": busy["top"],
        "bound_ms": bound_ms, "bound_by": report.bottleneck,
        "compute_ms": report.compute_term_s * 1e3, "memory_ms": report.memory_term_s * 1e3,
        "bound_share": bound_ms / measured,
        "peak_gb_card": card_peak / 1e9, "peak_gb_reckoned": meta["peak_bytes"] / 1e9,
        "peak_ratio": meta["peak_bytes"] / card_peak,
        "dot_flops_by_dtype": card["dot_flops_by_dtype"],
        "traffic_bytes": card["traffic_bytes"], "ops": card["ops"],
        "kernel_work": card["kernels"], "launches": counts, "counted_run_s": counted_s,
    }
    log(f"[dryrun] {label}: {json.dumps(row)}")
    checks = {
        "dot FLOPs by dtype": (card["dot_flops_by_dtype"], meta["dot_flops_by_dtype"]),
        "traffic bytes": (card["traffic_bytes"], meta["traffic_bytes"]),
        "kernel work": (card["kernels"], meta["kernels"]),
        "launches against the reckoned calls": (counts, calls),
    }
    def floats(x):  # the reckoning's scaled counts come back as ints or floats
        return {k: floats(v) for k, v in x.items()} if isinstance(x, dict) else float(x)

    for what, (got, want) in checks.items():
        if floats(got) != floats(want):
            raise AssertionError(f"{label}: {what} on the card {got}, reckoned {want}")
    if not any(counts.values()):
        raise AssertionError(f"{label}: no kernel launched")
    if abs(row["peak_ratio"] - 1) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"{label}: reckoned peak {row['peak_gb_reckoned']:.3f} GB, card "
                             f"{row['peak_gb_card']:.3f} GB")
    if row["bound_share"] > DRYRUN_MAX_SHARE:
        raise AssertionError(f"{label}: bound {bound_ms:.2f} ms above the measured "
                             f"{measured:.2f} ms: the count misses work")
    return row, counts


def phase_dryrun() -> tuple[list, dict]:
    """The ``dryrun`` phase: ``DRYRUN_CELLS`` reckoned in a spawned child (the
    fake process groups live and die with it) while this process reckons the
    calibration programs on meta tensors; then each program on the card
    against its reckoning.  Returns the ``dryrun`` line's rows and {kernel:
    {path: launches}}."""
    import multiprocessing as mp

    from repro_torch.launch import dryrun

    rows, launches = [], {name: {} for name in counters()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        result = Path(tmp) / "result.json"
        proc = mp.get_context("spawn").Process(target=_dryrun_child, args=(str(result),),
                                               name="chip-smoke-dryrun")
        proc.start()
        try:
            programs = _dryrun_programs()
            metas = {}
            for label, cfg, shape, _ in programs:
                t0 = time.perf_counter()
                metas[label], how = dryrun.reckon(cfg, shape, None, dryrun.impls("pallas"),
                                                  model_axis=DRYRUN_MODEL_AXIS)
                log(f"[dryrun] {label} reckoned on meta in {time.perf_counter() - t0:.1f}s: "
                    f"{json.dumps(how)}")
        finally:
            proc.join(DRYRUN_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join(30)
                raise AssertionError(f"the dryrun child outlived {DRYRUN_TIMEOUT_S} s")
        out = json.loads(result.read_text()) if result.exists() else {}
    if "error" in out:
        raise AssertionError(f"the dryrun child failed:\n{out['error']}")
    if proc.exitcode != 0 or "rows" not in out:
        raise AssertionError(f"the dryrun child exited {proc.exitcode} with no result")
    cells = {(r["arch"], r["shape"], r["mesh"]): r for r in out["rows"]}
    for r in cells.values():
        log(f"[dryrun] {dryrun.fmt_row(r)}")
        if r["status"] != "ok":
            raise AssertionError(f"dry run cell {r['arch']} {r['shape']} {r['mesh']}: {r}")
        rf, m = r["roofline"], r["memory"]
        rows.append({"cell": f"{r['arch']} {r['shape']}", "mesh": r["mesh"],
                     "per_device_gb": m["per_device_gb"], "fits_80gb": m["fits_80gb"],
                     "bound_ms": max(rf["compute_s"], rf["memory_s"], rf["collective_s"]) * 1e3,
                     "bottleneck": rf["bottleneck"], "useful_ratio": rf["useful_ratio"],
                     "dot_flops": r["op_stats"]["dot_flops"],
                     "collective_bytes": r["collectives"]["total"],
                     "grad_accum": r["grad_accum"], "reckon_s": r["reckon_s"]})
    for label, cfg, shape, args in programs:
        row, counts = _calibrate(label, cfg, shape, args, metas[label])
        arch, name = label.split()
        mesh_cell = cells[arch, name, "16x16"]
        # the cell's device splits along model what its plan splits: its dot
        # FLOPs are the card's whole parts and a 16th of the rest
        parts = split_parts(cfg, DRYRUN_MODEL_AXIS, DRYRUN_DATA_RANKS)
        whole = whole_dot_flops(cfg, parts, shape.global_batch, shape.seq_len, shape.kind,
                                _k2_dot(row["kernel_work"]))
        row["mesh_cell_dot_flops"] = mesh_cell["op_stats"]["dot_flops"]
        row["mesh_cell_parts"] = parts
        row["mesh_cell_closed_form"] = split_dot_flops(
            sum(row["dot_flops_by_dtype"].values()), whole, DRYRUN_MODEL_AXIS)
        if row["mesh_cell_dot_flops"] != row["mesh_cell_closed_form"]:
            raise AssertionError(f"{label}: the 16x16 cell's dot FLOPs a device "
                                 f"{row['mesh_cell_dot_flops']} differ from the closed form "
                                 f"{row['mesh_cell_closed_form']} of the card's "
                                 f"{row['dot_flops_by_dtype']}")
        rows.append(row)
        for name_, n in counts.items():
            launches[name_][f"dryrun {label}"] = n
        del args
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


# -- tensor parallelism: two model ranks on the one card --------------------------


class _PlanMesh:
    """What ``tensor_parallel.split_plan`` reads of a (data, model) mesh, for
    a plan read without a process group."""

    def __init__(self, shape):
        self.shape, self.mesh_dim_names = tuple(shape), ("data", "model")

    def size(self, d=None):
        return math.prod(self.shape) if d is None else self.shape[d]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """The family's init (nested)."""
    from repro_torch.models import encdec, lm

    init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
    return init(cfg, seed=seed, device=device)


def split_parts(cfg, model_axis: int, data_axis: int = 1) -> dict:
    """{part: whether it splits} of ``cfg``'s plan on a (data, model) mesh."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm

    plan = tp.split_plan(cfg, lm.flat_params(init_params(cfg, device="meta")),
                         _PlanMesh((data_axis, model_axis)))
    return {p: bool(plan is not None and getattr(plan, p))
            for p in ("attention", "mlp", "mamba", "vocab", "experts")}


def whole_dot_flops(cfg, parts: dict, rows: int, seq: int, kind: str, k2_dot: int) -> int:
    """Dot FLOPs of the parts of a one-card program that a split plan leaves
    whole on every model rank, in closed form: attention's projections
    (2·d·hd·(2H + 2K) a token and layer) with K2's products (``k2_dot``, the kernels'
    record), the logits (2·d·V a position that computes them) and, in the
    moe family, the router (2·d·E_pad a token and layer) and the chosen
    slot's product over every expert (2·E_pad a choice), which every rank
    computes whole; the encoder-decoder, whose heads and hidden split,
    leaves only its tied logits whole (its embedding is a gather, no dot).
    A training step (remat, no two-level scan) runs each
    four times: forward, remat's recompute (which stops before a block's
    last product, the MLP's or the shared expert's, not before attention's
    or the router's; the chunked CE recomputes its logits) and the
    backward's two products; the slot's product has no gradient, so it
    runs twice.  Prefill computes the last position's logits.  Every other
    product of the families that split is linear in a split dim (the moe
    dispatch and combine in the rank's experts), so the split program
    computes ``w + (plain - w) / model_axis`` (:func:`split_dot_flops`)."""
    from repro_torch.models.lm import padded_experts

    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"no closed form for the {cfg.family} family")
    if (not parts["mlp"] and (cfg.family in ("dense", "hybrid", "encdec") or
                              (cfg.family == "moe" and cfg.num_shared_experts))) or \
            (not parts["mamba"] and cfg.family in ("ssm", "hybrid")) or \
            (not parts["experts"] and cfg.family == "moe") or \
            (not parts["attention"] and cfg.family == "encdec"):
        raise ValueError("the closed form leaves only attention, the vocabulary and the "
                         "router whole (the encoder-decoder's: the vocabulary)")
    train = kind == "train"
    # the encoder-decoder's layer loops ignore scan_block
    if train and (not cfg.remat or (cfg.scan_block and cfg.family != "encdec")):
        raise ValueError("the closed form takes remat without a two-level scan")
    d, hd, h, k = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    tokens, out = rows * seq, 0
    if cfg.family != "ssm" and not parts["attention"]:
        out += (4 if train else 1) * cfg.num_layers * tokens * 2 * d * hd * (2 * h + 2 * k) \
            + k2_dot
    if not parts["vocab"]:
        out += (4 * tokens if train else rows) * 2 * d * cfg.vocab_size
    if cfg.family == "moe":
        e = padded_experts(cfg)
        out += cfg.num_layers * tokens * ((4 if train else 1) * 2 * d * e
                                          + (2 if train else 1) * 2 * e * cfg.top_k)
    return out


def split_dot_flops(plain: int, whole: int, model_axis: int) -> int:
    """A model rank's dot FLOPs: the whole parts' and its share of the rest."""
    share, rest = divmod(int(plain) - int(whole), model_axis)
    if rest:
        raise AssertionError(f"{plain - whole} split dot FLOPs do not divide by {model_axis}")
    return int(whole) + share


def _k2_dot(kernels: dict) -> int:
    return int(sum(kernels.get(k, {}).get("dot_flops", 0)
                   for k in ("flash_attention", "flash_attention_bwd")))


@contextlib.contextmanager
def kernel_shapes(seen: dict, keep: dict | None = None):
    """Record the (query heads, kv heads) of each K2 forward launch, the
    channels of each K3 launch (their wrappers' inputs) and the experts each
    moe layer's expert einsums take (its expert leaves') in ``seen``; with
    ``keep``, also a host copy of the first inputs of each distinct shape
    and keywords, and whether autograd will call the backward on them
    (:func:`tp_kernel_checks`)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    fa, ss, moe = ops.flash_attention, ops.selective_scan, L.moe_layer

    def kept(name, args, kw):
        if keep is None:
            return
        key = (name, tuple(tuple(a.shape) for a in args), tuple(sorted(kw.items())))
        # remat runs a block's forward without autograd, then again with it
        bwd = torch.is_grad_enabled() and any(a.requires_grad for a in args)
        if key not in keep:
            keep[key] = {"args": [a.detach().cpu() for a in args], "kw": dict(kw),
                         "bwd": bwd}
        keep[key]["bwd"] |= bwd

    def attention(q, k, v, **kw):
        seen.setdefault("flash_attention", set()).add((int(q.shape[1]), int(k.shape[1])))
        kept("flash_attention", (q, k, v), kw)
        return fa(q, k, v, **kw)

    def scan(u, *a, **kw):
        seen.setdefault("selective_scan", set()).add(int(u.shape[-1]))
        kept("selective_scan", (u, *a), kw)
        return ss(u, *a, **kw)

    def experts(x, router_w, we_gate, *a, **kw):
        seen.setdefault("experts", set()).add(int(we_gate.shape[0]))
        return moe(x, router_w, we_gate, *a, **kw)

    ops.flash_attention, ops.selective_scan, L.moe_layer = attention, scan, experts
    try:
        yield seen
    finally:
        ops.flash_attention, ops.selective_scan, L.moe_layer = fa, ss, moe


def tp_kernel_checks(keep: dict) -> list:
    """Each K2 and K3 input that :func:`kernel_shapes` kept, through the
    kernel's wrapper and its plain version at the kernels phase's
    tolerances (``TOL``), and, where training took its gradient, through
    the backward kernel and autograd of the plain version (``TOL_BWD``) with
    a random cotangent.  Raises on a mismatch; returns a row a check."""
    from repro_torch.kernels import ops, ref

    rows = []
    for (name, shapes, _), entry in keep.items():
        args = [a.cuda() for a in entry["args"]]
        kw = {k: v for k, v in entry["kw"].items() if k != "h0"}
        label = f"tp {shapes} {kw}"
        dtype = args[0].dtype
        if name == "flash_attention":
            fwd, plain = ops.flash_attention, ref.attention_ref
        else:
            fwd, plain = ops.selective_scan, ref.selective_scan_ref
        with torch.no_grad():
            got, want = fwd(*args, **kw), plain(*args, **kw)
        got, want = (got, want) if isinstance(got, tuple) else ([got], [want])
        row = {"kernel": name, "shapes": [list(s) for s in shapes], **kw,
               "max_abs_err": _agree(name, label, got, want, dtype)}
        del got, want
        if entry["bwd"]:
            if name == "flash_attention":
                dy = cotangent(args[0].shape, dtype)
                want = ref.attention_ref_bwd(*args, dy, **kw)
            else:
                dy = cotangent(args[0].shape, torch.float32)
                want = ref.selective_scan_ref_bwd(*args, dy)
            got = _grads(lambda *t: fwd(*t, **kw), args, dy)
            row["bwd_rel_err"] = _agree_grads(f"{name}_bwd", label, got, want, dtype)
            del got, want
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def _tp_cfg(arch):
    from repro_torch.configs import get_config

    layers = TP_MODELS[arch][0]
    cfg = get_config(arch)
    if layers is None:
        return cfg
    return cfg.replace(num_layers=layers,
                       encoder_layers=layers if cfg.encoder_layers else 0)


def _host(params: dict) -> dict:
    return {k: v.float().cpu() for k, v in params.items()}


def _routes_digest(routes: list) -> str:
    """sha256 of the expert choices ``pinned_routes`` recorded, in call order."""
    h = hashlib.sha256()
    for r in routes:
        h.update(r.cpu().numpy().tobytes())
    return h.hexdigest()


def _drift(got: dict, want: dict) -> dict:
    """max |got - want| and the L2 norm of got - want over every leaf."""
    sq, worst = 0.0, 0.0
    for k in want:
        d = got[k] - want[k]
        sq += float(torch.linalg.vector_norm(d)) ** 2
        worst = max(worst, float(d.abs().max()))
    return {"max_abs": worst, "l2": math.sqrt(sq)}


def _tp_train(arch, cfg, mesh, rank, keep) -> dict:
    """Train ``TP_MODELS[arch]``'s steps split on the mesh (both ranks; one
    more step counted by ``op_analysis`` on the card; K2's and K3's inputs
    kept in ``keep`` on rank 0; the moe expert choices recorded), then, on
    rank 0, the plain bf16 run and the plain f32 run from the same init and
    batches, each replaying the split run's expert choices."""
    import torch.distributed as dist

    from repro_torch.distributed import fsdp
    from repro_torch.launch import op_analysis
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm
    from repro_torch.train.step import init_train_state

    steps, seq = TP_MODELS[arch][1], TP_MODELS[arch][5]
    args = ltrain.build_parser().parse_args(
        ["train", "--arch", arch, "--seq-len", str(seq), *LM_TRAIN_ARGS,
         "--steps", str(steps)])
    batches = [lm_batch(cfg, TP_ROWS, seq, seed=i) for i in range(steps)]

    def init():
        return lm.flat_params(init_params(cfg))

    routes = []

    def run(step, make_state, keep=None, replay=True):
        # the state goes to _train_run with no other reference, so each step
        # frees the one before it
        seen = {}
        with kernel_shapes(seen, keep), pinned_routes(routes, replay) as pinned:
            state, losses, ms, counts, peak = _train_run(step, make_state(), batches)
        out = {"losses": losses, "step_ms": ms, "launches": counts, "peak_gib": peak,
               "kernel_shapes": {k: sorted(v) for k, v in seen.items()},
               "routes_moved": pinned["moved"]}
        return state, out

    opt, sstep = ltrain.make_step(cfg, args, mesh=mesh)
    state, split = run(sstep, lambda: init_train_state(init(), opt, mesh=mesh),
                       keep if rank == 0 else None, replay=False)
    split["routes_digest"], split["route_calls"] = _routes_digest(routes), len(routes)
    log(f"[tp] rank {rank} {arch}: split steps {split['step_ms']} ms")
    s_params = _host({k: fsdp.whole(p) for k, p in state["params"].items()})
    t0 = time.perf_counter()
    card = op_analysis.program_stats(sstep, state, batches[0])
    split["counted_s"] = time.perf_counter() - t0
    split["card"] = {k: card[k] for k in ("dot_flops", "dot_flops_by_dtype", "kernels",
                                          "collectives")}
    log(f"[tp] rank {rank} {arch}: counted step in {split['counted_s']:.1f}s")
    del state, card
    gc.collect()
    torch.cuda.empty_cache()
    out = {"split": split}
    if rank == 0:
        _, pstep = ltrain.make_step(cfg, args)
        state, out["plain"] = run(pstep, lambda: init_train_state(init(), opt))
        p_params = _host(state["params"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        _, fstep = ltrain.make_step(cfg32, args)
        state, out["f32"] = run(fstep, lambda: init_train_state(
            {k: v.float() for k, v in init().items()}, opt))
        f_params = _host(state["params"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out["params_split_f32"] = _drift(s_params, f_params)
        out["params_plain_f32"] = _drift(p_params, f_params)
        out["params_split_plain"] = _drift(s_params, p_params)
        del p_params, f_params
    del s_params
    dist.barrier()
    return out


def _tp_serve(arch, cfg, mesh, rank, keep) -> dict:
    """Prefill and greedy decode through a model rank's engine (both ranks;
    the prefill counted by ``op_analysis`` on the card; K2's and K3's
    inputs kept in ``keep`` on rank 0; the moe expert choices recorded),
    then on rank 0 the plain bf16 and f32 engines fed the split run's
    tokens and expert choices (the encoder-decoder: and the same source
    frames)."""
    import torch.distributed as dist

    from repro_torch.launch import op_analysis
    from repro_torch.models import encdec, lm
    from repro_torch.serve.engine import ServeEngine

    _, _, batch, prompt, gen, _ = TP_MODELS[arch]
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt))
    source = (rng.standard_normal((batch, cfg.source_len, cfg.d_model)).astype(np.float32)
              if cfg.family == "encdec" else None)
    max_len = prompt + gen + 1

    routes = []

    def serve(eng, tokens=None, keep=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen = {}
        reset_counts()
        with kernel_shapes(seen, keep), pinned_routes(routes, tokens is not None) as pinned:
            logits, cache = eng.prefill(prompts, source)
            outs, chosen = [logits.float().cpu()], []
            for i in range(gen):
                tok = torch.argmax(logits, dim=-1) if tokens is None else tokens[i].cuda()
                chosen.append(tok.cpu())
                logits, cache = eng.step(cache, tok)
                outs.append(logits.float().cpu())
        res = {"launches": read_counts(),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "kernel_shapes": {k: sorted(v) for k, v in seen.items()},
               "kv_heads": int(cache["k"].shape[2]) if "k" in cache else 0,
               "cross_kv_heads": int(cache["ck"].shape[2]) if "ck" in cache else 0,
               "slots": int(cache["k"].shape[3]) if "k" in cache else 0,
               "ssm_channels": int(cache["ssm_h"].shape[2]) if "ssm_h" in cache else 0,
               "routes_moved": pinned["moved"]}
        del cache
        return res, outs, chosen

    params = init_params(cfg)
    eng = ServeEngine(cfg, params, max_len=max_len, mesh=mesh, device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    split, s_logits, tokens = serve(eng, keep=keep if rank == 0 else None)
    split["routes_digest"], split["route_calls"] = _routes_digest(routes), len(routes)
    log(f"[tp] rank {rank} {arch}: split prefill and {gen} decode steps")
    tok = torch.as_tensor(prompts, dtype=torch.long, device="cuda")

    def prefill(t, src):  # as the dry run's program: under no_grad
        with torch.no_grad():
            if cfg.family == "encdec":
                return encdec.prefill(eng.params, t, src, cfg, eng.spec)
            return lm.prefill(eng.params, t, cfg, eng.spec)

    card = op_analysis.program_stats(
        prefill, tok, None if source is None else torch.from_numpy(source).cuda())
    split["card"] = {k: card[k] for k in ("dot_flops", "dot_flops_by_dtype", "kernels",
                                          "collectives")}
    del eng, card
    gc.collect()
    torch.cuda.empty_cache()
    out = {"split": split}
    if rank == 0:
        eng = ServeEngine(cfg, init_params(cfg), max_len=max_len, device="cuda")
        out["plain"], p_logits, _ = serve(eng, tokens)
        del eng
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        eng = ServeEngine(cfg32, _to_f32(init_params(cfg)), max_len=max_len, device="cuda")
        out["f32"], f_logits, _ = serve(eng, tokens)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        steps = []
        for s_, p_, f_ in zip(s_logits, p_logits, f_logits):
            top2 = torch.topk(p_, 2, dim=-1).values
            steps.append({"split_f32": float((s_ - f_).abs().max()),
                          "plain_f32": float((p_ - f_).abs().max()),
                          "split_plain": float((s_ - p_).abs().max()),
                          "margins": (top2[:, 0] - top2[:, 1]).tolist(),
                          "same_token": (s_.argmax(-1) == p_.argmax(-1)).tolist(),
                          "finite": bool(torch.isfinite(s_).all())})
        out["logits"] = steps
    dist.barrier()
    return out


def _tp_rank(rank: int, init_file: str, result_path: str) -> None:
    """One model rank of the ``tp`` phase: joins the 2-rank gloo group, runs
    ``TP_MODELS`` on the (1, 2) mesh; writes {arch: results} (or the
    traceback) as JSON to ``result_path``."""
    import faulthandler

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    faulthandler.enable()  # a fatal signal prints the rank's stack
    out, keep = {}, {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=TP_RANKS, rank=rank)
        mesh = init_device_mesh("cuda", (1, TP_RANKS), mesh_dim_names=("data", "model"))
        for arch in TP_MODELS:
            cfg = _tp_cfg(arch)
            t0 = time.perf_counter()
            keep[arch] = {}
            out[arch] = {"train": _tp_train(arch, cfg, mesh, rank, keep[arch])}
            out[arch]["train_s"] = time.perf_counter() - t0
            out[arch]["serve"] = _tp_serve(arch, cfg, mesh, rank, keep[arch])
            out[arch]["serve_s"] = time.perf_counter() - t0 - out[arch]["train_s"]
            log(f"[tp] rank {rank} {arch}: train {out[arch]['train_s']:.1f}s, serve "
                f"{out[arch]['serve_s']:.1f}s")
        for arch in keep if rank == 0 else ():  # after every launch the runs count
            t0 = time.perf_counter()
            out[arch]["kernel_checks"] = tp_kernel_checks(keep[arch])
            log(f"[tp] {arch}: {len(keep[arch])} kernel inputs checked in "
                f"{time.perf_counter() - t0:.1f}s")
    except BaseException:  # the parent fails the phase with it
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        Path(result_path).write_text(json.dumps(out))


def _tp_meta_child(result_path: str) -> None:
    """The ``tp`` phase's reckonings on meta tensors, in a fake group of 2:
    each model's split (rank 0 of the (1, 2) mesh) and plain train step and
    prefill; writes {arch: {kind: {run: stats}}} (or the traceback)."""
    out = {}
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun

        with dryrun.fake_world(TP_RANKS):
            mesh = init_device_mesh("cpu", (1, TP_RANKS), mesh_dim_names=("data", "model"))
            for arch, (_, _, batch, prompt, _, seq) in TP_MODELS.items():
                cfg = _tp_cfg(arch)
                out[arch] = {}
                for kind, shape in (("train", ShapeConfig("tp", seq, TP_ROWS, "train")),
                                    ("prefill", ShapeConfig("tp", prompt, batch, "prefill"))):
                    out[arch][kind] = {}
                    for run, m in (("split", mesh), ("plain", None)):
                        stats, _ = dryrun.reckon(cfg, shape, m, dryrun.impls("pallas"),
                                                 scale=False)
                        out[arch][kind][run] = {k: stats[k] for k in (
                            "dot_flops", "dot_flops_by_dtype", "kernels", "collectives")}
    except BaseException:  # the parent fails the phase with it
        out = {"error": traceback.format_exc()}
    finally:
        Path(result_path).write_text(json.dumps(out))


def _floats(x):
    return {k: _floats(v) for k, v in x.items()} if isinstance(x, dict) else float(x)


def _tp_check(arch: str, ranks: list, meta: dict) -> tuple[list, dict, list]:
    """The ``tp`` phase's gates for one model (module constants): rows,
    {kernel: {path: launches}} and the gates that failed."""
    from repro_torch.models.lm import CacheSpec, padded_experts

    cfg = _tp_cfg(arch)
    _, steps, batch, prompt, gen, seq = TP_MODELS[arch]
    parts = split_parts(cfg, TP_RANKS)
    h, k = cfg.num_heads, cfg.num_kv_heads
    heads = (h // TP_RANKS, max(k // TP_RANKS, 1)) if parts["attention"] else (h, k)
    di = cfg.ssm_d_inner // (TP_RANKS if parts["mamba"] else 1)
    want_shapes = {}
    if cfg.family != "ssm":
        want_shapes["flash_attention"] = [list(heads)]
    if cfg.family in ("ssm", "hybrid"):
        want_shapes["selective_scan"] = [di]
    experts = padded_experts(cfg) // (TP_RANKS if parts["experts"] else 1)
    if cfg.family == "moe":
        want_shapes["experts"] = [experts]
    want_train = expected_train_counts(cfg, cfg.grad_accum * steps)
    want_serve = {n: v for n, v in expected_counts(cfg, gen).items() if n in counters()}
    # the decode cache's slots a rank: half where neither the heads split nor
    # the kv heads divide the axis, and the slots do (the sequence split)
    spec = CacheSpec.build(cfg, prompt + gen + 1, TP_RANKS)
    seq_split = (cfg.family not in ("ssm", "encdec") and not parts["attention"]
                 and spec.kv_heads % TP_RANKS != 0 and spec.cache_len % TP_RANKS == 0)
    want_slots = 0 if cfg.family == "ssm" else spec.cache_len // (TP_RANKS if seq_split else 1)
    r0 = ranks[0]
    rows, launches = [], {name: {} for name in counters()}
    fails = []
    for kind in ("train", "prefill"):
        split, plain = meta[kind]["split"], meta[kind]["plain"]
        rows_, len_ = (TP_ROWS, seq) if kind == "train" else (batch, prompt)
        whole = whole_dot_flops(cfg, parts, rows_, len_, kind, _k2_dot(plain["kernels"]))
        want_dot = split_dot_flops(plain["dot_flops"], whole, TP_RANKS)
        ratio = {"flash_attention": heads[0] / h if cfg.family != "ssm" else 1,
                 "selective_scan": di / cfg.ssm_d_inner if cfg.ssm_d_inner else 1}
        work_ok = True
        for name, w in plain["kernels"].items():
            got = split["kernels"].get(name, {})
            r = ratio.get(name.removesuffix("_bwd"), 1)
            for key in ("calls", "dot_flops", "f32_ops", "exps"):
                scale = 1 if key == "calls" else r
                work_ok &= got.get(key, 0) == w.get(key, 0) * scale
            if name.startswith("rms_norm"):
                work_ok &= got.get("bytes") == w.get("bytes")
        row = {"arch": arch, "part": kind, "layers": cfg.num_layers, "parts": parts,
               "per_rank_heads": list(heads) if cfg.family != "ssm" else None,
               "per_rank_channels": di if cfg.ssm_d_inner else None,
               "per_rank_experts": experts or None,
               "dot_flops_split": split["dot_flops"], "dot_flops_plain": plain["dot_flops"],
               "dot_flops_whole_parts": whole, "dot_flops_closed_form": want_dot,
               "split_share": split["dot_flops"] / plain["dot_flops"],
               "collective_bytes_split": split["collectives"]["total"],
               "kernel_work_split": split["kernels"], "kernel_work_plain": plain["kernels"]}
        if split["dot_flops"] != want_dot:
            fails.append(f"{arch} {kind}: split dot FLOPs {split['dot_flops']}, closed form "
                         f"{want_dot}")
        if not work_ok:
            fails.append(f"{arch} {kind}: kernel work {split['kernels']} against the plain "
                         f"{plain['kernels']} at shares {ratio}")
        for rank, res in enumerate(ranks):
            part = res[arch]["train" if kind == "train" else "serve"]["split"]
            card = part["card"]
            if _floats(card["dot_flops_by_dtype"]) != _floats(split["dot_flops_by_dtype"]) \
                    or _floats(card["kernels"]) != _floats(split["kernels"]):
                fails.append(f"{arch} {kind} rank {rank}: on the card {card['dot_flops_by_dtype']}"
                             f" {card['kernels']}, reckoned {split['dot_flops_by_dtype']} "
                             f"{split['kernels']}")
            row[f"card_dot_flops_rank{rank}"] = card["dot_flops"]
        rows.append(row)
    for rank, res in enumerate(ranks):
        tr, sv = res[arch]["train"]["split"], res[arch]["serve"]["split"]
        for name in counters():
            launches[name][f"{arch} tp train rank {rank}"] = tr["launches"][name]
            launches[name][f"{arch} tp serve rank {rank}"] = sv["launches"][name]
        if tr["launches"] != want_train or sv["launches"] != want_serve:
            fails.append(f"{arch} rank {rank}: launches train {tr['launches']} (want "
                         f"{want_train}), serve {sv['launches']} (want {want_serve})")
        for got in (tr["kernel_shapes"], sv["kernel_shapes"]):
            if got != want_shapes:
                fails.append(f"{arch} rank {rank}: kernel inputs {got}, want {want_shapes}")
        if not tr["peak_gib"] < r0[arch]["train"]["plain"]["peak_gib"] or \
                not sv["peak_gib"] < r0[arch]["serve"]["plain"]["peak_gib"]:
            fails.append(f"{arch} rank {rank}: peak GiB train {tr['peak_gib']}, serve "
                         f"{sv['peak_gib']}; plain {r0[arch]['train']['plain']['peak_gib']}, "
                         f"{r0[arch]['serve']['plain']['peak_gib']}")
        want_kv = 0 if cfg.family == "ssm" else (k // TP_RANKS if parts["attention"] else k)
        if sv["kv_heads"] != want_kv or \
                sv["cross_kv_heads"] != (want_kv if cfg.family == "encdec" else 0):
            fails.append(f"{arch} rank {rank}: the cache holds {sv['kv_heads']} kv heads "
                         f"({sv['cross_kv_heads']} cross)")
        if sv["slots"] != want_slots:
            fails.append(f"{arch} rank {rank}: the cache holds {sv['slots']} slots, want "
                         f"{want_slots}")
        if rank and tr["losses"] != r0[arch]["train"]["split"]["losses"]:
            fails.append(f"{arch}: the model ranks' losses differ")
        for part, res_ in (("train", tr), ("serve", sv)):
            mine = r0[arch][part]["split"]
            if (res_["routes_digest"], res_["route_calls"]) != (mine["routes_digest"],
                                                                mine["route_calls"]) \
                    or (cfg.family == "moe") != (res_["route_calls"] > 0):
                fails.append(f"{arch} {part} rank {rank}: expert choices {res_['route_calls']} "
                             f"calls {res_['routes_digest']}, rank 0 {mine['route_calls']} "
                             f"{mine['routes_digest']}")
    # K2 and K3 on the inputs each met on rank 0 (forward, and backward
    # where training took it), held against their plain versions
    checks = r0[arch].get("kernel_checks", [])
    for name in set(want_shapes) & {"flash_attention", "selective_scan"}:
        mine = [c for c in checks if c["kernel"] == name]
        if not mine or not any("bwd_rel_err" in c for c in mine):
            fails.append(f"{arch}: {name} was not checked forward and backward at the "
                         f"ranks' shapes: {mine}")
    # bf16 against the plain run: each drift from the f32 plain run within
    # BF16_DRIFT_RATIO times the plain bf16 run's own; a loss is one scalar
    # a step, so the losses' drifts are taken as their mean over the steps
    t0_, ts = r0[arch]["train"], r0[arch]["serve"]
    s_l, p_l, f_l = (t0_[r]["losses"] for r in ("split", "plain", "f32"))
    loss_drift = {"split_f32": float(np.mean([abs(s - f) for s, f in zip(s_l, f_l)])),
                  "plain_f32": float(np.mean([abs(p - f) for p, f in zip(p_l, f_l)]))}
    loss_ok = loss_drift["split_f32"] <= BF16_DRIFT_RATIO * loss_drift["plain_f32"]
    params_ok = t0_["params_split_f32"]["l2"] <= BF16_DRIFT_RATIO * t0_["params_plain_f32"]["l2"]
    logit_ok, tokens_ok, counted = True, True, 0
    for st in ts["logits"]:
        tol = BF16_DRIFT_RATIO * st["plain_f32"]
        logit_ok &= st["finite"] and st["split_f32"] <= tol
        for margin, same in zip(st["margins"], st["same_token"]):
            if margin > tol:
                counted += 1
                tokens_ok &= same
    rows.append({"arch": arch, "part": "against plain", "layers": cfg.num_layers,
                 "encoder_layers": cfg.encoder_layers,
                 "steps": steps, "rows": TP_ROWS, "seq_len": seq,
                 "grad_accum": cfg.grad_accum, "decode_steps": gen,
                 "losses": {r: t0_[r]["losses"] for r in ("split", "plain", "f32")},
                 "loss_drift_mean": loss_drift,
                 "kernel_checks": checks,
                 "params_drift": {k_: t0_[k_] for k_ in ("params_split_f32",
                                                         "params_plain_f32",
                                                         "params_split_plain")},
                 "logits_drift": [{k_: st[k_] for k_ in ("split_f32", "plain_f32",
                                                         "split_plain")}
                                  for st in ts["logits"]],
                 "greedy_tokens_counted": counted, "greedy_tokens_equal": tokens_ok,
                 "route_calls": {p_: r0[arch][p_]["split"]["route_calls"]
                                 for p_ in ("train", "serve")},
                 "routes_digest": {p_: r0[arch][p_]["split"]["routes_digest"]
                                   for p_ in ("train", "serve")},
                 "routes_moved": {f"{p_} {r}": r0[arch][p_][r]["routes_moved"]
                                  for p_ in ("train", "serve") for r in ("plain", "f32")},
                 "step_ms": {f"rank {r}": res[arch]["train"]["split"]["step_ms"]
                             for r, res in enumerate(ranks)}
                 | {"plain": t0_["plain"]["step_ms"]},
                 "peak_gib": {f"rank {r}": [res[arch]["train"]["split"]["peak_gib"],
                                            res[arch]["serve"]["split"]["peak_gib"]]
                              for r, res in enumerate(ranks)}
                 | {"plain": [t0_["plain"]["peak_gib"], ts["plain"]["peak_gib"]]},
                 "kv_heads": ts["split"]["kv_heads"],
                 "cross_kv_heads": ts["split"]["cross_kv_heads"],
                 "cache_slots": [ts["split"]["slots"], spec.cache_len],
                 "ssm_channels": ts["split"]["ssm_channels"],
                 "counted_s": t0_["split"]["counted_s"],
                 "train_s": ranks[0][arch]["train_s"], "serve_s": ranks[0][arch]["serve_s"]})
    if not (loss_ok and params_ok and logit_ok and tokens_ok):
        fails.append(f"{arch}: against the plain run: losses {loss_ok}, params {params_ok}, "
                     f"logits {logit_ok}, greedy tokens {tokens_ok}: {rows[-1]}")
    for r in rows:
        log(f"[tp] {json.dumps(r)}")
    return rows, launches, fails


def phase_tp() -> tuple[list, dict]:
    """The ``tp`` phase: two spawned model ranks on the card (the gloo group
    lives and dies with them) while a third process reckons their programs
    on meta tensors; then the gates of :func:`_tp_check`.  Returns the
    ``tp`` line's rows and {kernel: {path: launches}}."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        meta_path = Path(tmp) / "meta.json"
        procs = [ctx.Process(target=_tp_meta_child, args=(str(meta_path),),
                             name="chip-smoke-tp-meta")]
        procs += [ctx.Process(target=_tp_rank, args=(r, str(Path(tmp) / "pg"),
                                                     str(Path(tmp) / f"rank{r}.json")),
                              name=f"chip-smoke-tp-{r}") for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        late = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        if late:
            raise AssertionError(f"{late} outlived {TP_TIMEOUT_S} s")
        outs = [json.loads(path.read_text()) if path.exists() else {}
                for path in [meta_path] + [Path(tmp) / f"rank{r}.json"
                                           for r in range(TP_RANKS)]]
    for p, out in zip(procs, outs):
        if "error" in out:
            raise AssertionError(f"{p.name} failed:\n{out['error']}")
        if p.exitcode != 0 or not out:
            raise AssertionError(f"{p.name} exited {p.exitcode} with no result")
    meta, ranks = outs[0], outs[1:]
    rows, launches, fails = [], {name: {} for name in counters()}, []
    for arch in TP_MODELS:
        r, l, f = _tp_check(arch, ranks, meta[arch])
        rows += r
        fails += f
        for name, by_path in l.items():
            launches[name].update(by_path)
    if fails:
        raise AssertionError("; ".join(fails))
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
        launches["conv3d_stem_wgrad"] = phase_train_small()
        done("train_small")
        train_rows, stem_launches = phase_train()
        launches["conv3d_stem_wgrad"].update(stem_launches)
        done("train")
        lm_rows, lm_launches = phase_lm_train()
        done("lm_train")
        for name, by_path in lm_launches.items():
            launches[name].update(by_path)
        stream_rows, stream_launches = phase_stream_train()
        done("stream_train")
        for name, by_path in stream_launches.items():
            launches[name].update(by_path)
        sharded_rows, sharded_launches = phase_sharded()
        done("sharded")
        for name, by_path in sharded_launches.items():
            launches[name].update(by_path)
        dryrun_rows, dryrun_launches = phase_dryrun()
        done("dryrun")
        for name, by_path in dryrun_launches.items():
            launches[name].update(by_path)
        tp_rows, tp_launches = phase_tp()
        done("tp")
        for name, by_path in tp_launches.items():
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
    print(json.dumps({"stream_train": stream_rows}), flush=True)
    print(json.dumps({"sharded": sharded_rows}), flush=True)
    print(json.dumps({"dryrun": dryrun_rows}), flush=True)
    print(json.dumps({"tp": tp_rows}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
