"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``--phases 18,19`` builds the kernels and runs only the listed phases of
those that stand alone (4, 17, 18, 19), and prints no kernels line.

It imports the port (``src/repro_torch``) and nothing of the JAX package,
builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and then:

1. holds every kernel of the search path against its plain PyTorch version
   on the card, bit for bit (packed domination words and dominator counts
   are integers: tolerance 0), at the main path's shapes and at ragged
   sizes, on the search's populations and on edge cases (NaN, -0.0, +inf,
   ties, m 3 and 8), and times kernel, plain version and the kernel's lower
   bound; it prints both kernels' SASS instructions per pair (FSETP, VOTE,
   POPC, LDS of their 32-column loop) and the instruction floor they imply;
2. checks the tiled ranking on the card against the dense ranking on the
   CPU on a small population (exact ranks);
3. drives the search path once through ``repro_torch.explore.run_spec``:
   the full-size EfficientNet-B0 on a four-platform chain, searched by
   ``torch_nsga2`` at population 16384 for 10 generations, with each
   kernel's launch count set to 0 just before and read just after; checks
   the front against the exact NumPy evaluator;
4. holds the sliding-window attention kernel against its plain version on
   the card at ragged sizes (head dims 32, 64, 128 and 160; groups 1, 3
   and 7) and at the two LM shapes that take it (smollm-360m: 2 prompts of
   8192 tokens, 15 heads over 5 of dim 64, window 4096; qwen2-vl-7b: 2 x
   8192 positions, 28 heads over 4 of dim 128, window 4096), and times
   kernel, plain version, bound and ``scaled_dot_product_attention`` (the
   library yardstick, called here only) at each; the bound counts the
   3xTF32 products at the TF32 tensor-core peak, with the float32
   CUDA-core bound beside it, and the kernel's tensor-core (HMMA)
   instructions are counted in its SASS;
5. drives the LM inference path once at full width, with every launch
   count set to 0 just before and read just after: the explorer picks the
   cut of smollm-360m (8192 tokens) between two platforms (``torch_nsga2``,
   through the Pareto kernels), ``lm_block_cuts`` maps it to block cuts,
   the model's forward over two 8192-token prompts runs through the window
   kernel (32 launches) and agrees with the plain attention, the
   partitioned runner agrees with the monolithic forward, and the
   generation engine answers 8 requests (prompt 128, 32 new tokens,
   greedy) whose first-step logits agree with the forward;
6. holds the SSD scan kernel against its plain version on the card, at the
   reference's sweep shapes and at mamba2-370m's and zamba2-2.7b's head and
   state sizes over two 8192-token rows, and times kernel, plain version
   and both bounds, as phase 4 (no single PyTorch call computes the scan),
   and counts its HMMA instructions;
7. drives the SSM inference path once at full width and depth, with every
   launch count set to 0 just before and read just after: the explorer
   picks the cut of mamba2-370m (8192 tokens) between the two platforms of
   phase 5, the model's forward over two 8192-token prompts runs through
   the SSD scan kernel (48 launches) and agrees with the plain scan, and
   the generation engine answers 8 requests whose first-step logits agree
   with the forward;
8. holds the fake-quant int8 product kernel against its plain version on
   the card, at the reference's sweep (x float32 and x rounded through
   bf16), its block variants' shape, ragged shapes, EfficientNet-B0's
   classifier (per-channel int8 weights of the phase-9 model, its pooled
   features of 256 images) and VGG-16's three classifier layers at batch
   256, and bit for bit against the exact reference
   (``repro_torch.testing.quant_matmul_exact``) at each; prints each
   launch's split over K, grid and copy width of w_q; times kernel, plain
   version, bound and ``torch._int_mm`` on the same int8 operands (the
   product only: no single PyTorch call quantizes, multiplies and scales;
   at the head the wrapper's host time exceeds the card's, which
   ``chip_variants.py --qmm`` times alone in a CUDA graph);
   counts the IMMA (int8 tensor-core) and IDP4A instructions of its SASS;
9. drives the accuracy path once at full width: EfficientNet-B0 at 224
   with seeded weights on the card (BatchNorm scales, shifts and biases
   drawn as the CPU tests draw them, running statistics measured on a
   calibration batch, so that the logits depend on the image), 256
   synthetic images; the monolithic forward gives many classes, the
   partitioned runner with quantization off equals it bit for bit (cuDNN
   deterministic, TF32 off), the quantized runner moves its logits by more
   than a floor and keeps most of its top-1; ``cnn_measured_accuracy``
   with the four platforms' specs scores up to 8 cut vectors of phase 3's
   front and ``(-1, -1, -1)``.  The accuracy path, like the reference's,
   reaches no kernel: its launches of the product kernel are counted and
   reported (0).  Then the model's int8 classifier runs through the
   product kernel (``ops.quant_matmul``), with the count set to 0 just
   before and read just after, and agrees with the fake-quant classifier;
10. drives online re-partitioning once: ``OnlineRepartitioner`` on phase
    3's spec takes a cold update on the baseline chain, then the drift
    mission of ``repro_torch.launch.drift`` (link 0 slowed 4x, then 32x,
    platform 1 dropped, link 0 recovered with the node still down), each
    update with the Pareto kernels' counts set to 0 just before and read
    just after; every front equals the exact NumPy evaluator on its
    drifted system, the dropped platform gets no layers, each warm update
    counts a warm start, all five systems keep one table shape signature,
    and the decisions' Chrome trace validates;
11. drives a campaign and the fleet once: the paper's six CNNs at 224 on
    phase 3's chain and on two platforms, searched as phase 3 searches,
    first serially through ``Campaign.run`` (launch counts read; its copy
    of phase 3's cell finds phase 3's front), then by two fleet worker
    processes on the same card through ``run_fleet``, whose merged report
    has the serial report's fingerprint; a second ``run_fleet`` on the
    complete manifest starts no worker and rewrites no shard;
12. drives the serve runtime once at full width, with every launch count
    set to 0 just before and read just after (0 for all five kernels, as
    in the reference: the cached attention takes no kernel): phase 5's
    smollm-360m cut at phase 5's block cuts, a Poisson burst of 16
    requests (prompt 128, 8 new tokens, greedy) routed by a
    ``ReplicaRouter`` over two ``PipelineServeEngine`` replicas (8 slots in
    4 waves, eth10 links), once with a thread and a CUDA stream per stage
    and link and once serially; nothing is dropped, the two modes give the
    same tokens, and each request's tokens are ``GenerationEngine``'s
    except after a printed near tie (top-2 logits within ``LOGIT_TOL``);
    ``SlotDecoder`` admits a second request mid-flight without changing
    the first's tokens; then the drift driver's ``--serve`` and
    ``--measured`` run on the card, the latter firing its re-partition
    from the measured link divergence;
13. drives the training side once at full width, with every launch count
    set to 0 just before and read just after (0 for all five kernels in
    every train step, as in the reference, whose training takes ``impl=
    "ref"``; K1 and K2 only in the search that picks the oracle's cut
    vectors): smollm-360m at its published size (remat on) takes one SGD
    step on the card and on the CPU from the same seeded weights (loss and
    parameters agree), SGD steps with remat on and off and with four
    microbatches against one (parameters agree), two Adafactor steps
    (the loss falls) and 10 AdamW steps on ``launch/train.py``'s schedule
    at 8 x 128 tokens (finite losses, the last below the first; step
    times, tok/s, the optimizer step alone, grad norm, peak memory); then
    the registered ``cnn_fakequant`` oracle, built through its
    ``AccuracySpec`` on the card, trains EfficientNet-B0 at full width and
    its own data size (32 x 32, 10 classes, eval set 256; 100 steps) and
    scores up to 8 cut vectors of a search over its graph on phase 3's
    chain (float top-1 above 0.30; a fresh runner over the model it
    trained gives each score again bit for bit),
    and QAT at 4 bits keeps the reference test's three gates;
14. runs the launchers in-process: ``launch.train`` at full width for 4
    steps with a checkpoint, restored into a fresh model (every tensor and
    the logits bit for bit), then ``launch.serve`` at the reference's
    defaults (reduced smollm-360m warm-trained 30 steps, 16 requests,
    prompt 8, 12 new tokens, 2 replicas, eth10): nothing dropped, async
    tokens equal to serial tokens;
15. runs quantized LM stages once at full width, with every launch count
    set to 0 just before and read just after (0 for all five kernels, as
    in the reference): phase 5's smollm-360m (rebuilt from its seed) at
    phase 5's block cuts, each stage fake-quantized to its platform's
    width in the LM search's system (16 and 8 bits), the weights
    calibrated over the stage's stacked layers and the links
    fake-quantized; the logits move from the float runner's by more than
    phase 9's floor and keep most of its top-1, each link carries the float
    runner's bytes x bits/32, and a prefill through ``stage_step_fn`` over
    the quantized ``stage_weights`` gives the quantized runner's
    last-position logits;
16. drives the moe family once at full width, each part with every launch
    count set to 0 just before and read just after (0 for all five: MoE
    and MLA reach no kernel, as in the reference), each model freed before
    the next: deepseek-moe-16b at full width and depth (16.38 B
    parameters on the card) runs a forward over 2 x 2048 tokens (finite,
    its dropped fraction and balance losses printed) and
    ``GenerationEngine`` answers 8 requests whose first-step logits agree
    with the forward (the routing of both compared first: a row whose
    first MoE call routes otherwise at near ties only is reported, not
    gated); at full width and depth 2 the card agrees with the CPU on the
    router's indices (near ties reported), the logits and one SGD step,
    four microbatches agree with one within the reference's MoE bound and
    with the mean of one SGD step on each microbatch within the card-vs-CPU
    bounds, and three AdamW steps lower the loss; deepseek-v3-671b at full
    width and depth 2 with its MTP block, at the 16b model's traffic,
    gives finite ``mtp_logits`` and ``lm_loss`` in a ``train=True``
    forward over 2 x 2048 tokens (the chunked attention of the
    decompressed MLA), and ``GenerationEngine``'s first-step logits for 8
    requests, through the absorbed MLA decode, agree with the
    decompressed forward; its latent cache's bytes a token are printed
    against a GQA cache's;
17. drives the audio and vlm families once at full width, each part with
    every launch count set to 0 just before and read just after (K5 28
    times in qwen2-vl-7b's forward through the kernel, 0 elsewhere; K1 and
    K2 in the two searches; K3 and K4 never), each model freed before the
    next: qwen2-vl-7b at its published size (7.63 B parameters) has its
    cut searched between two platforms, forwards 2 x (256 seeded patch
    embeddings at Qwen2-VL's 16 x 16 grid positions + 7936 tokens) through
    the window kernel in agreement with ``chunked_sdpa``, answers 8 text
    requests whose first-step logits agree with the forward, and runs the
    partitioned runner with vision equal to the monolithic forward and at
    its platforms' 16 and 8 bits within phase 9's gates; at full width and
    depth 2 one SGD step agrees between card and CPU and four microbatches
    with one; musicgen-large at its published size (3.25 B parameters)
    has its cut searched, forwards 4 clips of 1500 frames (logits (B, T,
    4, 2048)), runs the runner equal to the monolithic forward, decodes 8
    requests of 250 + 100 frames greedily through ``decode_step`` (its
    first step agreeing with the forward), lowers its loss in 3 AdamW
    steps at depth 24 (peak memory printed) and agrees between card and
    CPU for one SGD step at depth 2;
18. drives the pipeline once at full width, with every launch count set
    to 0 just before and read just after each run: smollm-360m at its
    published size forwards 4 prompts of 8192 tokens through
    ``launch.pipeline.pipelined_apply`` at 2 and at 4 stages (each stage
    on its own CUDA stream of the one card) over 4 microbatches of 1 x
    8192 tokens, through the window kernel in every block of every
    microbatch (exactly 32 x 4 launches), in agreement with the monolithic
    forward through the kernel; the inputs of each run's last window
    launch (1 x 8192 tokens, the microbatch's shape) are kept and the
    kernel on them is held against its plain version (within ``WA_TOL``);
    it prints the link tensor's bytes a handoff and the handoffs, both
    walls, peak memory, and the explorer's stage boundary beside the
    balanced split (not gated);
19. checks the pod tooling: ``launch.dryrun`` of the reference's two
    smoke pairs (single- and multi-pod, on the ``meta`` device) with 0
    errors and ``diagnose`` of one pair (``--all``'s 40 pairs take over
    two minutes of CPU, so they run in the CPU tests); then the dry-run's
    estimate of phase 13's smollm-360m AdamW step (8 x 128,
    remat, built by ``launch.steps.build_train_setup``) is held against
    that step on the card: argument bytes within 1 % of the allocator's
    after set-up,
    FLOPs equal to the dispatch counter's on the real step (``impl
    "ref"``), the estimated peak within 0.5-2x of the allocator's, and the
    step's wall beside the roofline's ``bound_s``.

It prints one line per kernel, a JSON line ``{"kernels": [...]}``, the
card's name and power limit (also beside every time of phases 6 to 19),
and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result line; so does a machine without a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# dense int8 tensor-core operations/s of one H100 SXM (NVIDIA data sheet):
# the bound of the int8 product kernel
PEAK_INT8_OPS_S = 1979e12
# dense TF32 tensor-core operations/s of one H100 SXM (NVIDIA data sheet):
# window_attn and ssd_scan take each float32 product as three TF32
# products (3xTF32), so their bound counts 3 x their operations at it
PEAK_TF32_OPS_S = 495e12

POP, N_GEN, SEED = 16384, 10, 0
RANK_BLOCK = 2048            # the auto policy's tile rows at this population
RAGGED = (33, 97, 130)

# the LM path: smollm-360m at full width, two prompts of 8192 tokens (the
# window is 4096); the search runs at the search path's population so that
# ranking takes the tiled kernel and the final front the counting kernel
# (66 cut positions alone would need far fewer), for 5 generations
LM_ARCH, LM_B, LM_T, LM_GEN = "smollm-360m", 2, 8192, 5
# the two platforms of launch/serve.py, each given 1 GiB: at the default
# 64 and 128 MiB no cut of the 362M-parameter model fits (Def. 3)
LM_MEM = 2 ** 30
GEN_REQUESTS, GEN_PROMPT, GEN_NEW = 8, 128, 32
WA_RAGGED_T, WA_RAGGED_W = (1, 100, 128, 1000), (1, 64, 100, None)
# (query heads, KV heads): groups 1 and 3 (smollm-360m's), and 7
# (qwen2-vl-7b's 28 over 4) at one and two KV heads; every head dim the
# kernel is built for, 128 being qwen2-vl-7b's
WA_RAGGED_HEADS = ((2, 2), (6, 2), (7, 1), (14, 2))
WA_RAGGED_HD = (32, 64, 128, 160)
# window_attn against its plain version: float32 both, summed in another
# order (an online softmax over 64-key tiles against one softmax per row).
# 2e-5 is the reference's own tolerance (t <= 512); at t = 8192 a row sums
# up to 4096 keys, so the stated bound there is 1e-4
WA_TOL, WA_TOL_MAIN = 2e-5, 1e-4
# logits (std ~0.6) of the forward through the kernel against the forward
# through chunked_sdpa, and of the engine's first step against the forward:
# the attention's summation order differs in each of the 32 layers
LOGIT_TOL = 2e-4
# the partitioned runner repeats the monolithic forward's operations in the
# same order: bit-identical expected, 1e-6 absorbs a change of algorithm
PART_TOL = 1e-6
# the SSM path: mamba2-370m at full width and depth (48 layers, d 1024,
# N 128), the LM path's prompts, search and requests
SSM_ARCH = "mamba2-370m"
SSD_MODELS = ("mamba2-370m", "zamba2-2.7b")
SSD_SWEEP = tuple((t, chunk, h, p, n) for t, chunk in ((128, 32), (256, 64),
                                                        (192, 64))
                  for h, p, n in ((2, 16, 8), (3, 32, 16)))
# ssd_scan against its plain version, float32 both, the sums taken in other
# orders.  At the reference's sweep its own tolerance, 2e-4.  At the models'
# shapes (chunk 128, N 128 or 64) terms reach |y| ~ 20-30, and the plain
# version's cumulative decay, which the card sums in another order than the
# kernel's sequential one, moves exponents of up to |cs| ~ 50 by ~1e-5,
# i.e. terms by up to ~3e-4: the stated bound there is 1e-3 (rtol and atol);
# a fault of indexing or masking would be O(1)
SSD_TOL, SSD_TOL_MODEL = 2e-4, 1e-3
# the accuracy path: EfficientNet-B0 at its published size, 256 synthetic
# images (the reference oracle's eval_size), up to 8 of phase 3's cuts
CNN_BATCH, CNN_CUTS = 256, 8
# BatchNorm running statistics are measured on 64 other images of the set
CNN_CALIB = 64
# what shows that the full-width model computes something of its input:
# the monolithic forward's top-1 takes at least 16 classes over the 256
# images (the default init, BN mean 0 and var 1 with zero biases, gives
# one), and the quantized runner at the widest cut vector moves the logits
# by at least 1e-3 of max|logits| (float32 noise is ~1e-6 of it; the 8-bit
# stages and links move them by ~1e-1 on a reduced-resolution probe of the
# same model) while agreeing with the float top-1 on at least half the
# images (0.94 on that probe; a stage on wrong weights agrees on ~1/1000)
CNN_MIN_CLASSES, QUANT_MOVE, QUANT_AGREE = 16, 1e-3, 0.5
QMM_SWEEP = ((128, 128, 128), (256, 384, 128), (128, 256, 256))
QMM_BLOCKS = (256, 256, 256)
QMM_RAGGED = ((100, 96, 50), (1, 1, 1), (3, 5, 7), (65, 130, 67),
              (100, 96, 1000), (1, 1280, 1000), (70, 443, 129))
VGG_FC = ((25088, 4096), (4096, 4096), (4096, 1000))
# quant_matmul against its plain version: int32 sums are exact, the plain
# version's float32 sums of integer products too while they stay below
# 2^24 (they do here), and the epilogue is the same two products: the
# reference's tolerance 1e-5 (rtol and atol) at its sweep and the ragged
# shape; at the classifiers' shapes (K up to 25088) a relative bound,
# max_abs_err <= 1e-6 * max|y|.  Against the exact reference (the sum in
# float64, rounded once to float32, the same two products) the kernel's
# int32 sum is equal bit for bit at every shape: tolerance 0
QMM_TOL, QMM_REL = 1e-5, 1e-6
# the model's int8 classifier through the kernel against the same
# classifier fake-quantized in float32 (x and per-channel weights each
# dequantized, then summed in float): the same products rounded and summed
# in another order, so a bound relative to the largest sum of |terms|
HEAD_REL = 1e-5

# phase 11: the paper's six CNNs, searched as phase 3
# searches, serially and then by two fleet worker processes on the one card
CAMPAIGN_MODELS = ("vgg16", "resnet50", "squeezenet11", "googlenet",
                   "regnetx_400mf", "efficientnet_b0")
FLEET_WORKERS = 2

# phase 12: the serve runtime at full width with the reference launcher's
# replicas (src/repro/launch/serve.py: 8 slots in 4 waves each, eth10
# links, seed 123) and caches (prompt 128 + 32 new tokens), the burst sent
# twice, through the async pipeline and through the serial handoff.  Its
# requests ask 8 new tokens, not phase 5's 32: on the card machine a
# 16-block stage step took ~85 ms of host wall with the two serial
# replicas' threads sharing the interpreter and ~340 ms with the two async
# replicas' four stage threads, so 32 tokens took 75 s of the phase
# (PERF.md §6)
SERVE_REQUESTS, SERVE_RPS, SERVE_SEED, SERVE_NEW = 16, 200.0, 123, 8
SERVE_REPLICAS, SERVE_SLOTS, SERVE_GROUPS = 2, 8, 4
SERVE_LINK = "eth10"

# phase 13: training at full width.  smollm-360m at its published size
# (32 blocks, d 960, vocab 49152, remat on as its config sets it), AdamW on
# launch/train.py's schedule (warmup_cosine(3e-4, steps // 10, steps)) for
# 10 steps of make_batch_for(cfg, 8, 128, seed=i)
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 8, 128, 10, 3e-4
# one SGD step (momentum 0, lr 0.1, no clip) at 1 x 32 tokens from the
# seeded weights, on the card and on the CPU: the same float32 operations
# summed in other orders (cuBLAS against the CPU's GEMMs, the embedding's
# backward by atomics on the card), so the losses agree within 1e-5
# (relative) and each parameter within SGD_PARAM_REL of the step's largest
# change |lr * g|: a relative error of 1e-4 in a gradient is ~100x what
# float32 sums over these lengths (<= 49152 terms) leave
SGD_B, SGD_T, SGD_LR = 1, 32, 0.1
SGD_LOSS_REL, SGD_PARAM_REL = 1e-5, 1e-4
# remat on against off, grad_accum 4 against 1 (SGD, no clip, 8 x 128):
# recomputing a block repeats its operations (only the atomics' order may
# differ), and tests/test_grad_accum.py's bound for four microbatches
REMAT_TOL, ACCUM_TOL = 1e-6, 1e-4
# Adafactor, 2 steps on one batch (tests/test_training_serving.py:39-51's
# check at its learning rate and batch)
ADAFACTOR_LR, ADAFACTOR_B, ADAFACTOR_T = 1e-2, 4, 32
# the cnn_fakequant oracle on EfficientNet-B0 at full width and its own
# data size (src/repro/core/accuracy.py:141-174: 32 x 32, 10 classes,
# batch 64, eval set 256), phase 3's chain and search settings over this
# model's graph, up to 8 cut vectors of the front; the trained float top-1
# above the reference's bar (tests/test_training_serving.py:77).  100
# steps, not the oracle's default 200, to keep phases 13-14 near 45 s
FQ_OPTS = {"in_hw": 32, "w": 1.0, "n_classes": 10}
FQ_STEPS, FQ_EVAL, FQ_BAR = 100, 256, 0.30
# QAT at 4 bits, 40 steps of adamw(5e-4) from the trained model, at the
# reference test's batch 64 from seed 500 (tests/test_training_serving.py:
# 80-92, whose three gates phase 13 keeps)
QAT_BITS, QAT_STEPS, QAT_LR = 4, 40, 5e-4

# phase 15: quantized LM stages on phase 5's smollm-360m (rebuilt from the
# same seed) at phase 5's block cuts and prompts, each stage at the width
# of its platform in lm_spec (16 and 8 bits), links fake-quantized; the
# gates are phase 9's (QUANT_MOVE, QUANT_AGREE).  The stage-step check
# prefills QLM_STEP_B prompts of GEN_PROMPT tokens through stage_step_fn
# over the quantized stage_weights, against the quantized runner
QLM_STEP_B = 2

# phase 16: the moe family at full width.  deepseek-moe-16b at its
# published size (28 layers, d 2048, 64 experts top-6 + 2 shared, vocab
# 102400; 16.38 B parameters, 61.0 GiB in float32): a forward over 2 x
# 2048 tokens (t >= 2048 takes the chunked attention) and 8 requests
# (prompt 128, 16 new tokens, greedy).  Then at full width and depth 2
# (first_dense 1, one MoE layer): card against CPU, one SGD step (phase
# 13's batch and gates), four microbatches against one at 8 x 128 (see
# moe_train_path), three AdamW steps on one batch.  deepseek-v3-671b at
# full width (d 7168, 128 heads, MLA ranks 1536/512, 256 experts top-8 +
# 1 shared, vocab 129280) at depth 2 (first_dense 1) with its one MTP
# block, at the 16b model's traffic: a train=True forward over 2 x 2048
# tokens (the decompressed MLA takes the chunked attention) and 8
# requests (prompt 128, 16 new tokens) through the absorbed MLA decode
MOE_ARCH, V3_ARCH = "deepseek-moe-16b", "deepseek-v3-671b"
MOE_B, MOE_T, MOE_NEW = 2, 2048, 16
# tests/test_grad_accum.py:19's MoE bound for four microbatches against
# one batch: 0.15 on the parameters, 10x that on the loss
MOE_ACCUM_TOL, MOE_ACCUM_LOSS, MOE_ADAMW_LR = 0.15, 1.5, 3e-4
# a token whose k-th and (k+1)-th router scores lie closer than TIE_TOL
# (in both runs) is a near tie: float32 sums in another order (card
# against CPU, the cache path against the forward) may route it to the
# other expert, which changes its row's logits by far more than
# LOGIT_TOL.  A row's first MoE call that routes otherwise must do so only
# at near ties; it is reported, not failed, and the row's later calls and
# its logits, which it feeds, are not gated.  At least half the rows must
# be gated
TIE_TOL = 1e-5

# phase 17: the audio and vlm families at full width.  qwen2-vl-7b at its
# published size (28 layers, d 3584, 28 query heads over 4 KV heads of dim
# 128, window 4096, vocab 152064; 7.63 B parameters, 28.4 GiB): two rows of
# its 256 patches (n_patches, a 16 x 16 grid) and 7936 text tokens, T =
# 8192, a multiple of chunked_sdpa's 512-row chunks (otherwise it takes one
# (T, T) chunk), at Qwen2-VL's grid positions (patches t 0, h row, w col;
# text from 16 on all three axes).  The forward through K5 (impl "cuda",
# one launch a block) against chunked_sdpa (impl "ref"): both mask by the
# row index, and the logits agree within LOGIT_TOL.  8 text requests of
# GEN_PROMPT + GEN_NEW; the runner at cuts of a search over its graph
# between lm_spec's two platforms given VLM_MEM each (at phase 5's 1 GiB no
# cut of the 7.6 B-parameter model fits, Def. 3), over 2 x (256 + 1792)
# positions with vision, float (PART_TOL) and at the platforms' 16 and 8
# bits (QUANT_MOVE, QUANT_AGREE).  At full width and depth 2 (28 -> 2
# layers): one SGD step card against CPU (phase 13's batch and gates), and
# four microbatches against one at 8 x 16 tokens (+ 256 patches) within
# the reference's bound for this model (tests/test_grad_accum.py:15,
# ACCUM_TOL)
VLM_ARCH, AUDIO_ARCH = "qwen2-vl-7b", "musicgen-large"
# phase 18: smollm-360m's 4 prompts of 8192 tokens in 4 microbatches of 1,
# at 2 and 4 stages; pipelined against monolithic at the reference test's
# bound (tests/test_pipeline_multidev.py)
PIPE_B, PIPE_M, PIPE_STAGES, PIPE_TOL = 4, 4, (2, 4), 2e-4
# phase 19: the card check's step is phase 13's (TRAIN_B x TRAIN_T, AdamW,
# remat)
ARG_BYTES_REL = 0.01
PEAK_RATIO = (0.5, 2.0)
WA_VLM_NAME = "window_attn[qwen2-vl-7b]"
VLM_B, VLM_T, VLM_RUN_TEXT = 2, 8192, 1792
VLM_MEM = 8 * 2 ** 30
VLM_ACCUM_B, VLM_ACCUM_T = 8, 16
# musicgen-large at its published size (48 layers, d 2048, 32 heads, 4
# codebooks of 2048; 3.25 B parameters, 12.1 GiB): a forward over 4 clips
# of 1500 frames (30 s at EnCodec's 50 Hz, the paper's segment length; t
# < 2048 takes the sdpa branch), the runner at a searched cut (its graph at
# 1500 frames, VLM_MEM each), and a greedy decode loop through
# decode_step({"codes": ...}) for 8 requests of 250 + 100 frames (the
# engine takes tokens only).  AdamW, 3 steps on one 4 x 256 batch, at depth
# 24: the optimizer holds the parameters, their stacked copy, the stacked
# gradients and both moments, and its out-of-place steps add two more
# copies, about 7 x 12.1 GiB at depth 48 (> 80 GB), 7 x 6.1 at 24.  One
# SGD step card against CPU at depth 2
AUDIO_B, AUDIO_T = 4, 1500
AUDIO_REQUESTS, AUDIO_PROMPT, AUDIO_NEW = 8, 250, 100
AUDIO_TRAIN_B, AUDIO_TRAIN_T, AUDIO_ADAMW_DEPTH = 4, 256, 24


def population(n, m=3, infeas=0.3, seed=0):
    """Objectives with duplicated rows (ties) and a share of infeasible
    individuals with repeated violations, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return F, CV


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, after
    one warm-up call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def pair_ops(F, CV, rows_alive=None):
    """Float32 compares the domination test needs on these inputs: 2m per
    (feasible row, feasible column) pair, 1 per (infeasible, infeasible)
    pair, none for a mixed pair (decided by the feasibility bits), plus one
    feasibility compare per row and column."""
    m = F.shape[1]
    feas = CV <= 0
    rows = feas if rows_alive is None else feas[rows_alive]
    n_rows = len(rows)
    fr, fc = int(rows.sum()), int(feas.sum())
    ir, ic = n_rows - fr, len(feas) - fc
    return fr * fc * 2 * m + ir * ic + n_rows + len(feas)


def bound(n_bytes, ops, peak_ops=PEAK_F32_OPS_S):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bounds_3xtf32(n_bytes, ops):
    """The bound of a 3xTF32 kernel (3 TF32 operations for each float32
    one, at the TF32 peak) and, beside it, the float32 CUDA-core bound of
    the same work: ((ms, by), (ms, by))."""
    t, by = bound(n_bytes, 3 * ops, PEAK_TF32_OPS_S)
    return ((t, "operations (3xTF32)" if by == "operations" else by),
            bound(n_bytes, ops))


def print_hmma(source):
    """Print the HMMA (tensor-core) instructions of each kernel of
    ``source``'s library, from ``cuobjdump -sass`` where the toolkit has
    it."""
    from repro_torch.kernels import _build
    counts = _build.opcode_counts(source, "HMMA")
    if counts is None:
        print(f"  {source}: no cuobjdump in the toolkit, HMMA not counted")
        return
    print(f"  {source} HMMA instructions by kernel: "
          + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def inner_loop(instrs, holding="VOTE"):
    """The instructions of the smallest loop (a backward branch) that holds
    an instruction ``holding`` (a warp vote: the Pareto kernels' walk over
    32 columns; IMMA: the int8 product's k-step); None if the listing
    shows no such loop."""
    best = None
    for addr, op, args in instrs:
        target = re.match(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if target is None or int(target.group(1), 16) >= addr:
            continue
        body = [i for i in instrs
                if int(target.group(1), 16) <= i[0] <= addr]
        if any(i[1].startswith(holding) for i in body) and (
                best is None or len(body) < len(best)):
            best = body
    return best


def print_pareto_sass(pairs):
    """Instructions per pair of K1 and K2 (m <= 3) from their SASS: the
    loop over 32 columns holds 32 x R pairs a lane (R word rows a warp),
    and the instruction floor that implies on this card (one warp instruction a
    clock on each of 4 schedulers an SM, at the card's maximum SM clock).
    ``pairs``: kernel name -> pair tests of its main-path call."""
    from repro_torch.kernels import _build, pareto_rank
    listing = _build.sass("pareto_rank.cu")
    if listing is None:
        print("  pareto_rank.cu: no cuobjdump in the toolkit, SASS not read")
        return
    lane_pairs = 32 * pareto_rank._lib().pareto_rows_per_lane()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n_pairs in pairs.items():
        instrs = listing[f"{name}_kernel<3>"]
        loop = inner_loop(instrs)
        where = "the 32-column loop"
        if loop is None:
            loop, where = instrs, "the whole kernel (no loop found)"
        by_op = collections.Counter(op for _, op, _ in loop)
        per_pair = len(loop) / lane_pairs
        floor_ms = per_pair * n_pairs / 32 / (sms * 4 * clock_mhz * 1e6) * 1e3
        counts = ", ".join(f"{op} {by_op[op] / lane_pairs:.3f}"
                           for op in ("FSETP", "VOTE", "POPC", "LDS"))
        top = ", ".join(f"{op} {c}" for op, c in by_op.most_common(8))
        print(f"  {name} SASS, {where} ({len(loop)} instructions for "
              f"{lane_pairs} pairs a lane): {per_pair:.3f} a pair ({counts}); "
              f"most common {top}; instruction floor {floor_ms:.4f} ms for "
              f"{n_pairs:.3e} pairs ({sms} SMs at {clock_mhz:.0f} MHz)")


def check_kernels(dev):
    """Phase 1: each kernel against its plain version on the card; returns
    the per-kernel records (launches filled in after the main path)."""
    from repro_torch.kernels import ops, pareto_rank, ref
    from repro_torch.testing import edge_population

    cases = [(n, p, s) for n in RAGGED for p, s in ((0.3, n), (1.0, n + 1),
                                                    (0.0, n + 2))]
    for n, infeas, seed in cases:
        alive = torch.from_numpy(np.random.default_rng(seed).random(n)
                                 < 0.5).to(dev)
        inputs = [tuple(torch.from_numpy(a) for a in population(
            n, infeas=infeas, seed=seed))]
        inputs += [edge_population(n, m, infeas, seed) for m in (3, 8)]
        for F, CV in inputs:
            F, CV = F.to(dev), CV.to(dev)
            for block, bq in ((32, 32), (64, ops._COL_TILE)):
                got = pareto_rank.packed_domination(
                    F, CV, F, CV, bp=ops._row_tile(block), bq=bq)
                want = ref.packed_domination(F, CV, F, CV, block)
                assert torch.equal(got, want), ("packed_domination", n,
                                                 infeas)
            for mask in (torch.ones_like(alive), alive):
                assert torch.equal(
                    pareto_rank.domination_counts(F, CV, mask),
                    ref.domination_counts(F, CV, mask)), (
                    "domination_counts", n, infeas)
    print(f"ragged sizes {RAGGED} x infeasible share (0.3, 1.0, 0.0), the "
          f"search's populations and the edge cases (NaN, -0.0, +inf, ties; "
          f"m 3 and 8), all alive and under a mask: both kernels bit-exact")

    records = []
    # K1 at the first ranking's shape (the initial population)
    Fh, CVh = population(POP, seed=5)
    F, CV = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    tile = dict(bp=ops._row_tile(RANK_BLOCK), bq=ops._COL_TILE)
    assert torch.equal(pareto_rank.packed_domination(F, CV, F, CV, **tile),
                       ref.packed_domination(F, CV, F, CV, RANK_BLOCK))
    ms = cuda_ms(lambda: pareto_rank.packed_domination(F, CV, F, CV, **tile),
                 20)
    print(f"packed_domination at the first ranking's shape (n {POP}, 1 "
          f"launch a search): kernel {ms:.4f} ms, bit-exact")
    # K1 at the main path's shape: the combined population of a generation
    n2 = 2 * POP
    Fh, CVh = population(n2, seed=1)
    F, CV = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    tile = dict(bp=ops._row_tile(RANK_BLOCK), bq=ops._COL_TILE)
    got = pareto_rank.packed_domination(F, CV, F, CV, **tile)
    want = ref.packed_domination(F, CV, F, CV, RANK_BLOCK)
    err = max_abs_err(got, want)
    assert err == 0 and torch.equal(got, want), "packed_domination differs"
    ms = cuda_ms(lambda: pareto_rank.packed_domination(F, CV, F, CV, **tile),
                 20)
    plain = cuda_ms(lambda: ref.packed_domination(F, CV, F, CV, RANK_BLOCK),
                    3)
    m = Fh.shape[1]
    n_bytes = 2 * n2 * (m + 1) * 4 + got.numel() * 4
    b_ms, b_by = bound(n_bytes, pair_ops(Fh, CVh))
    records.append(dict(
        name="packed_domination", route="cuda",
        source="src/repro_torch/kernels/csrc/pareto_rank.cu",
        replaces="src/repro/kernels/pareto_rank.py:50",
        shape=f"F ({n2}, {m}) f32 -> words {tuple(got.shape)} int32",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))

    # K2 at the main path's shape: the final population, every row alive,
    # and again under an alive mask
    Fh, CVh = population(POP, seed=2)
    F, CV = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    mask_h = np.random.default_rng(3).random(POP) < 0.5
    ones = torch.ones(POP, dtype=torch.bool, device=dev)
    err = 0
    for mask in (ones, torch.from_numpy(mask_h).to(dev)):
        got = pareto_rank.domination_counts(F, CV, mask)
        want = ref.domination_counts(F, CV, mask, RANK_BLOCK)
        err = max(err, max_abs_err(got, want))
        assert torch.equal(got, want), "domination_counts differs"
    ms = cuda_ms(lambda: pareto_rank.domination_counts(F, CV, ones), 20)
    plain = cuda_ms(lambda: ref.domination_counts(F, CV, ones, RANK_BLOCK), 3)
    n_bytes = POP * (m + 1) * 4 + POP * 4 + POP * 4
    b_ms, b_by = bound(n_bytes, pair_ops(Fh, CVh))
    records.append(dict(
        name="domination_counts", route="cuda",
        source="src/repro_torch/kernels/csrc/pareto_rank.cu",
        replaces="src/repro/kernels/pareto_rank.py:94",
        shape=f"F ({POP}, {m}) f32, all alive -> counts ({POP},) int32",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    print_pareto_sass({"packed_domination": n2 * n2,
                       "domination_counts": POP * POP})
    return records


def check_ranking(dev):
    """Phase 2: tiled ranking through the kernel on the card equals the
    dense ranking on the CPU on a small population."""
    from repro_torch.core.nsga2_torch import nondominated_rank
    n = 3000
    Fh, CVh = population(n, seed=4)
    cpu = [nondominated_rank(torch.from_numpy(Fh), torch.from_numpy(CVh), cap)
           for cap in (None, n // 2)]
    Fd, CVd = torch.from_numpy(Fh).to(dev), torch.from_numpy(CVh).to(dev)
    for want, cap in zip(cpu, (None, n // 2)):
        got = nondominated_rank(Fd, CVd, cap, rank_block=512).cpu()
        assert torch.equal(got, want), ("rank", cap)
    print(f"tiled ranking on the card == dense ranking on the CPU "
          f"(n={n}, caps None and {n // 2})")


def main_spec():
    """The main path's spec: full-size EfficientNet-B0 on the four-platform
    chain, searched by ``torch_nsga2`` at population 16384."""
    from repro_torch.explore import (ExplorationSpec, ModelRef, PlatformSpec,
                                     SearchSettings, SystemSpec)
    return ExplorationSpec(
        model=ModelRef("cnn", "efficientnet_b0", {"in_hw": 224, "w": 1.0}),
        system=SystemSpec(
            platforms=(PlatformSpec("cam0", "eyr", bits=16),
                       PlatformSpec("cam1", "eyr", bits=16),
                       PlatformSpec("edge", "smb", bits=8),
                       PlatformSpec("central", "smb", bits=8)),
            links=("gige", "gige", "gige")),
        objectives=("latency", "energy", "throughput"),
        search=SearchSettings(strategy="torch_nsga2", pop_size=POP,
                              n_gen=N_GEN, seed=SEED))


def pareto_kernels():
    """The two search kernels' wrappers by name (each counts its launches
    in its ``launches`` attribute)."""
    from repro_torch.kernels import pareto_rank
    return {"packed_domination": pareto_rank.packed_domination,
            "domination_counts": pareto_rank.domination_counts}


def read_launches(kernels):
    """The launch counts of ``kernels``; fails unless each launched."""
    launches = {name: k.launches for name, k in kernels.items()}
    assert all(v > 0 for v in launches.values()), launches
    return launches


def assert_exact_front(res, graph, schedule, system_spec):
    """The front of ``res`` is the exact NumPy ``evaluate_batch`` of its cut
    vectors on ``system_spec``, bit for bit, and the scalar ``evaluate``
    within rtol 1e-12 (it sums in another order)."""
    from repro_torch.core.accuracy import ProxyAccuracy
    from repro_torch.core.partition import PartitionEvaluator

    assert [l.name for l in schedule] == [l.name for l in res.schedule]
    system = system_spec.build()
    ev = PartitionEvaluator(graph, schedule, system,
                            accuracy_fn=ProxyAccuracy(schedule, system))
    cuts = np.array([p.cuts for p in res.pareto])
    assert res.pareto == ev.evaluate_batch(cuts).to_evals()
    for p in res.pareto:
        exact = ev.evaluate(p.cuts)
        assert p.memory_bytes == exact.memory_bytes
        assert p.link_bytes == exact.link_bytes
        np.testing.assert_allclose(
            [p.latency_s, p.energy_j, p.throughput, p.accuracy],
            [exact.latency_s, exact.energy_j, exact.throughput,
             exact.accuracy], rtol=1e-12)


def main_path(dev, records):
    """Phase 3: the search path once, with the launch counts read."""
    from repro_torch.core.graph import linearize
    from repro_torch.explore import run_spec

    spec = main_spec()
    kernels = pareto_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = run_spec(spec, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    assert res.strategy_used == "torch_nsga2", res.strategy_used
    assert res.pareto, "empty front"
    assert len(res.schedule) == 207, len(res.schedule)

    # the front against the exact NumPy evaluator on the same cuts
    graph, _ = spec.model.build()
    assert_exact_front(res, graph, linearize(graph, spec.schedule_policy),
                       spec.system)
    F = np.array([p.as_objectives(spec.objectives) for p in res.pareto])
    assert np.isfinite(F).all() and F.shape == (len(res.pareto), 3)
    evals_s = POP * (N_GEN + 1) / wall
    print(f"main path: efficientnet_b0 224 ({len(res.schedule)} positions), "
          f"4 platforms, torch_nsga2 pop {POP} x {N_GEN} gen: "
          f"wall {wall:.3f} s, {evals_s:.0f} evals/s, front "
          f"{len(res.pareto)} points, launches {launches}, peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    return res


def valid_pairs(t: int, window: int) -> int:
    """(query, key) pairs the window admits over one (batch row, head)."""
    w = min(window, t)
    return w * (w + 1) // 2 + (t - w) * w


def window_attn_plain(q, k, v, w):
    """K5's plain version, one batch row and one KV head's query group at
    a time: a row's (H, T, T) scores are 4 GB at smollm-360m's 15 heads,
    7.5 GB at qwen2-vl-7b's 28."""
    from repro_torch.kernels import ops
    b, kv = q.shape[0], k.shape[2]
    group = q.shape[2] // kv
    return torch.cat([torch.cat([ops.window_attn(
        q[i:i + 1, :, j * group:(j + 1) * group],
        k[i:i + 1, :, j:j + 1], v[i:i + 1, :, j:j + 1], w, impl="ref")
        for j in range(kv)], dim=2) for i in range(b)])


def window_attn_shape(dev, arch, b, t, name, replaces):
    """K5 at ``arch``'s attention shape over ``b`` rows of ``t`` tokens
    against its plain version (within ``WA_TOL_MAIN``), timed beside the
    plain version, SDPA and the bound; returns its record (launches filled
    in by the path that runs the model)."""
    import torch.nn.functional as F

    from repro_torch.kernels import window_attn
    from repro_torch.models.registry import get_config
    cfg = get_config(arch)
    h, kv, hd, w = cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim, cfg.window
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=dev)
               for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))

    def plain():
        return window_attn_plain(q, k, v, w)

    got = window_attn.window_attn(q, k, v, w)
    want = plain()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=WA_TOL_MAIN, atol=WA_TOL_MAIN)
    del want
    ms = cuda_ms(lambda: window_attn.window_attn(q, k, v, w), 10)
    plain_ms = cuda_ms(plain, 2)
    # the library yardstick: K/V expanded and the boolean window mask built
    # outside the timed region, (B, H, T, hd) views
    pos = torch.arange(t, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    qt, kt, vt = (x.repeat_interleave(h // x.shape[2], 2).transpose(1, 2)
                  for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 3)
    lib_err = float((F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask).transpose(1, 2) - got).abs().max())
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    ops_ = b * h * valid_pairs(t, w) * 4 * hd
    (b_ms, b_by), (f32_ms, f32_by) = bounds_3xtf32(n_bytes, ops_)
    print(f"window_attn at {arch}'s shape: max_abs_err {err:.3e} (bound "
          f"{WA_TOL_MAIN}); library call differs from the kernel by "
          f"{lib_err:.3e}")
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; float32 on the "
          f"CUDA cores {f32_ms:.4f} ms, {f32_by}); {ops_:.4e} operations "
          f"over {valid_pairs(t, w)} pairs a head")
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/window_attn.cu",
        replaces=replaces,
        shape=f"q ({b}, {t}, {h}, {hd}), k/v ({b}, {t}, {kv}, {hd}) f32, "
              f"window {w}",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
        library_ms=lib_ms)


def check_window_attn(dev):
    """Phase 4: the window kernel against its plain version on the card, at
    ragged sizes and at the two LM shapes that take it (smollm-360m's and
    qwen2-vl-7b's); returns their records (launches filled in by phases 5
    and 17)."""
    from repro_torch.kernels import ops, window_attn

    def qkv(b, t, h, kv, hd, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(s, generator=g, device=dev)
                     for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))

    n = 0
    for t in WA_RAGGED_T:
        for w in WA_RAGGED_W:
            w = t + 37 if w is None else w
            for h, kv in WA_RAGGED_HEADS:
                for hd in WA_RAGGED_HD:
                    q, k, v = qkv(2, t, h, kv, hd, n)
                    got = window_attn.window_attn(q, k, v, w)
                    want = ops.window_attn(q, k, v, w, impl="ref")
                    torch.testing.assert_close(got, want, rtol=WA_TOL,
                                               atol=WA_TOL)
                    n += 1
    print(f"window_attn: {n} ragged cases (t {WA_RAGGED_T}, windows "
          f"(1, 64, 100, t+37), (heads, KV heads) {WA_RAGGED_HEADS} "
          f"(groups 1, 3 and 7), hd {WA_RAGGED_HD}) within {WA_TOL}")
    records = [window_attn_shape(dev, LM_ARCH, LM_B, LM_T, "window_attn",
                                 "src/repro/kernels/window_attn.py:77")]
    torch.cuda.empty_cache()
    records.append(window_attn_shape(
        dev, VLM_ARCH, VLM_B, VLM_T, WA_VLM_NAME,
        "src/repro/kernels/window_attn.py:77"))
    torch.cuda.empty_cache()
    print_hmma("window_attn.cu")
    return records


def lm_spec(arch=LM_ARCH, mem=LM_MEM, seq=LM_T):
    """The LM paths' search: ``arch`` at ``seq`` tokens between the serve
    launcher's two platforms, ``mem`` bytes each, over one eth10 link."""
    from repro_torch.explore import (ExplorationSpec, ModelRef, PlatformSpec,
                                     SearchSettings, SystemSpec)
    return ExplorationSpec(
        model=ModelRef("registry", arch, {"seq": seq}),
        system=SystemSpec(
            platforms=(PlatformSpec("A", "eyr", bits=16, mem_capacity=mem),
                       PlatformSpec("B", "smb", bits=8, mem_capacity=mem)),
            links=("eth10",)),
        objectives=("latency", "energy", "throughput"),
        search=SearchSettings(strategy="torch_nsga2", pop_size=POP,
                              n_gen=LM_GEN, seed=SEED))


def timed(fn):
    """``fn()`` and its wall seconds, between two synchronizes."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def lm_path(dev, records):
    """Phase 5: the LM inference path once, with the launch counts read."""
    from repro_torch.explore import lm_block_cuts, run_spec
    from repro_torch.kernels import pareto_rank, window_attn
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serving import GenerationEngine, PartitionedLMRunner

    cfg = get_config(LM_ARCH)
    kernels = {"packed_domination": pareto_rank.packed_domination,
               "domination_counts": pareto_rank.domination_counts,
               "window_attn": window_attn.window_attn}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0

    t0 = time.perf_counter()
    res = run_spec(lm_spec(), device=str(dev))
    sel = res.selected.cuts if res.selected is not None else (1,)
    cuts = lm_block_cuts(sel, cfg.n_layers)
    search_s = time.perf_counter() - t0
    assert res.strategy_used == "torch_nsga2" and res.pareto, "no front"
    print(f"LM search: smollm-360m seq {LM_T} ({len(res.schedule)} "
          f"positions), 2 platforms, torch_nsga2 pop {POP} x {LM_GEN} gen: "
          f"{search_s:.3f} s, front {len(res.pareto)} points, selected "
          f"{tuple(sel)} -> block cuts {cuts}")

    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_B, LM_T))).to(dev)}

    logits, fwd_s = timed(lambda: model(batch, impl="cuda"))
    assert window_attn.window_attn.launches == cfg.n_layers, (
        window_attn.window_attn.launches)
    assert logits.shape == (LM_B, LM_T, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    ref_logits, ref_s = timed(lambda: model(batch, impl="ref"))
    fwd_err = float((logits - ref_logits).abs().max())
    torch.testing.assert_close(logits, ref_logits, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    del logits
    print(f"LM forward: {n_params / 1e6:.1f}M parameters, {LM_B} x {LM_T} "
          f"tokens: through the kernel {fwd_s:.3f} s "
          f"({LM_B * LM_T / fwd_s:.0f} tok/s), through chunked_sdpa "
          f"{ref_s:.3f} s; logits max_abs_err {fwd_err:.3e} (bound "
          f"{LOGIT_TOL})")

    runner = PartitionedLMRunner(model, cuts)
    part, rep = runner.forward(batch)
    part_err = float((part - ref_logits).abs().max())
    assert part_err <= PART_TOL, part_err
    del part, ref_logits
    print(f"partitioned runner: {runner.n_stages} stages {runner.ranges}, "
          f"stage latencies {[round(x, 4) for x in rep.latency_s]} s, link "
          f"bytes {rep.link_bytes}, Def.-4 throughput "
          f"{rep.throughput():.3f} /s; vs monolithic max_abs_err "
          f"{part_err:.3e} (bit-identical: {part_err == 0.0})")

    engine = GenerationEngine(model, max_seq=GEN_PROMPT + GEN_NEW)
    prompts = rng.integers(0, cfg.vocab, (GEN_REQUESTS, GEN_PROMPT))
    first, _ = engine.prefill(prompts)
    want = model({"tokens": torch.from_numpy(prompts).to(dev)})[:, -1]
    first_err = float((first - want).abs().max())
    torch.testing.assert_close(first, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    gen = engine.generate(prompts, max_new=GEN_NEW)
    assert gen.tokens.shape == (GEN_REQUESTS, GEN_NEW), gen.tokens.shape
    assert (gen.tokens[:, 0] == first.argmax(-1).cpu().numpy()).all()
    assert ((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()

    launches = {name: k.launches for name, k in kernels.items()}
    assert all(v > 0 for v in launches.values()), launches
    for rec in records:
        if rec["name"] == "window_attn":
            rec["launches"] = launches["window_attn"]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    print(f"generation: {GEN_REQUESTS} requests, prompt {GEN_PROMPT}, "
          f"{GEN_NEW} new tokens greedy: prefill {gen.prefill_s:.3f} s "
          f"({GEN_REQUESTS * GEN_PROMPT / gen.prefill_s:.0f} tok/s), decode "
          f"{gen.decode_s:.3f} s ({gen.tokens_per_s:.1f} tok/s); first-step "
          f"logits vs forward max_abs_err {first_err:.3e}")
    print(f"LM path: launches {launches}, peak device memory {peak:.0f} MiB")
    return model, cuts


def ssd_work(b, t, h, p, n, chunk):
    """Bytes and float32 operations of one SSD scan on these shapes: each
    input read once and each output written once; C·Bᵀ over the causal
    triangle once per (b, chunk), that triangle against dt·x, C·stateᵀ and
    the state update per (b, chunk, h), and the recurrence across chunks."""
    nc = t // chunk
    tri = chunk * (chunk + 1) // 2
    ops = (b * nc * tri * n * 2
           + b * nc * h * (tri * p * 2 + 2 * chunk * n * p * 2)
           + b * nc * h * p * n * 2)
    n_bytes = 4 * (2 * b * t * h * p + b * t * h + h + 2 * b * t * n
                   + b * h * p * n)
    return n_bytes, ops


def check_ssd_scan(dev, card):
    """Phase 6: the SSD scan kernel against its plain version on the card;
    returns its record (launches filled in by the SSM path)."""
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models.registry import get_config

    def inputs(b, t, h, p, n, seed):
        """The distribution of the reference's sweep (tests/test_kernels.py)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((b, t, h, p), generator=g, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((b, t, h), generator=g, device=dev) - 1)
        A = -torch.exp(torch.randn((h,), generator=g, device=dev) * 0.3)
        B = torch.randn((b, t, n), generator=g, device=dev) * 0.5
        C = torch.randn((b, t, n), generator=g, device=dev) * 0.5
        return x, dt, A, B, C

    def check(args, chunk, tol):
        y, st = ssd_scan.ssd_scan(*args, chunk)
        y_ref, st_ref = ops.ssd_scan(*args, chunk, impl="ref")
        err = max(float((y - y_ref).abs().max()),
                  float((st - st_ref).abs().max()))
        print(f"  max_abs_err {err:.3e} (max |y| "
              f"{float(y_ref.abs().max()):.2f}, bound {tol})")
        torch.testing.assert_close(y, y_ref, rtol=tol, atol=tol)
        torch.testing.assert_close(st, st_ref, rtol=tol, atol=tol)
        return err

    for i, (t, chunk, h, p, n) in enumerate(SSD_SWEEP):
        check(inputs(2, t, h, p, n, i), chunk, SSD_TOL)
    print(f"ssd_scan: {len(SSD_SWEEP)} sweep cases (t, chunk, h, p, n) "
          f"{SSD_SWEEP} within {SSD_TOL}")

    record = None
    for arch in SSD_MODELS:
        cfg = get_config(arch)
        b, t, chunk = LM_B, LM_T, cfg.ssm_chunk
        h = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        p, n = cfg.ssm_headdim, cfg.ssm_state
        args = inputs(b, t, h, p, n, 1)
        print(f"ssd_scan at {arch}'s shape:")
        err = check(args, chunk, SSD_TOL_MODEL)
        ms = cuda_ms(lambda: ssd_scan.ssd_scan(*args, chunk), 10)
        plain_ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk, impl="ref"), 2)
        (b_ms, b_by), (f32_ms, f32_by) = bounds_3xtf32(
            *ssd_work(b, t, h, p, n, chunk))
        print(f"  x ({b}, {t}, {h}, {p}), B/C ({b}, {t}, {n}), chunk {chunk}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; float32 on the CUDA cores "
              f"{f32_ms:.4f} ms, {f32_by}) [{card}]")
        if arch == SSM_ARCH:
            record = dict(
                name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:71",
                shape=f"x ({b}, {t}, {h}, {p}), B/C ({b}, {t}, {n}) f32, "
                      f"chunk {chunk}",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
                library_ms=None)
        del args
    print_hmma("ssd_scan.cu")
    return record


def ssm_path(dev, records, card):
    """Phase 7: the SSM inference path once, with the launch counts read."""
    from repro_torch.explore import run_spec
    from repro_torch.kernels import pareto_rank, ssd_scan
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serving import GenerationEngine

    cfg = get_config(SSM_ARCH)
    kernels = {"packed_domination": pareto_rank.packed_domination,
               "domination_counts": pareto_rank.domination_counts,
               "ssd_scan": ssd_scan.ssd_scan}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0

    res, search_s = timed(lambda: run_spec(lm_spec(SSM_ARCH),
                                           device=str(dev)))
    assert res.strategy_used == "torch_nsga2" and res.pareto, "no front"
    sel = res.selected.cuts if res.selected is not None else None
    print(f"SSM search: {SSM_ARCH} seq {LM_T} ({len(res.schedule)} "
          f"positions), 2 platforms, torch_nsga2 pop {POP} x {LM_GEN} gen: "
          f"{search_s:.3f} s, front {len(res.pareto)} points, selected "
          f"{sel} [{card}]")

    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_B, LM_T))).to(dev)}
    logits, fwd_s = timed(lambda: model(batch, impl="cuda"))
    fwd_launches = ssd_scan.ssd_scan.launches
    assert fwd_launches == cfg.n_layers, fwd_launches
    assert logits.shape == (LM_B, LM_T, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    ref_logits, ref_s = timed(lambda: model(batch, impl="ref"))
    fwd_err = float((logits - ref_logits).abs().max())
    print(f"SSM forward: {n_params / 1e6:.1f}M parameters, {cfg.n_layers} "
          f"layers, {LM_B} x {LM_T} tokens: through the kernel {fwd_s:.3f} s "
          f"({LM_B * LM_T / fwd_s:.0f} tok/s, {fwd_launches} launches), "
          f"through the plain scan {ref_s:.3f} s; logits max_abs_err "
          f"{fwd_err:.3e} (bound {LOGIT_TOL}) [{card}]")
    torch.testing.assert_close(logits, ref_logits, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    del logits, ref_logits

    engine = GenerationEngine(model, max_seq=GEN_PROMPT + GEN_NEW)
    prompts = rng.integers(0, cfg.vocab, (GEN_REQUESTS, GEN_PROMPT))
    first, _ = engine.prefill(prompts)
    want = model({"tokens": torch.from_numpy(prompts).to(dev)},
                 impl="cuda")[:, -1]
    first_err = float((first - want).abs().max())
    torch.testing.assert_close(first, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    gen = engine.generate(prompts, max_new=GEN_NEW)
    assert gen.tokens.shape == (GEN_REQUESTS, GEN_NEW), gen.tokens.shape
    assert (gen.tokens[:, 0] == first.argmax(-1).cpu().numpy()).all()
    assert ((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()

    launches = {name: k.launches for name, k in kernels.items()}
    assert all(v > 0 for v in launches.values()), launches
    for rec in records:
        if rec["name"] == "ssd_scan":
            rec["launches"] = launches["ssd_scan"]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    print(f"SSM generation: {GEN_REQUESTS} requests, prompt {GEN_PROMPT}, "
          f"{GEN_NEW} new tokens greedy: prefill {gen.prefill_s:.3f} s "
          f"({GEN_REQUESTS * GEN_PROMPT / gen.prefill_s:.0f} tok/s), decode "
          f"{gen.decode_s:.3f} s ({gen.tokens_per_s:.1f} tok/s); first-step "
          f"logits vs forward max_abs_err {first_err:.3e} [{card}]")
    print(f"SSM path: launches {launches} (ssd_scan: {cfg.n_layers} in the "
          f"forward, {cfg.n_layers} in the first-step check), peak device "
          f"memory {peak:.0f} MiB")


def int8_columns(w_out_in):
    """A Dense weight in the port's (out, in) layout as the product kernel
    takes it: w_q (in, out) int8 and w_scale (out,), symmetric 8-bit per
    output channel (the port's calibration and scale)."""
    from repro_torch.core.quant import (QuantSpec, calibrate,
                                        compute_scale_zp)
    w = w_out_in.t().contiguous()
    spec = QuantSpec(8, per_channel=True, channel_axis=1)
    scale, _ = compute_scale_zp(*calibrate(w, spec), spec)
    w_q = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
    return w_q, scale.reshape(-1).contiguous()


def act_scale(x):
    """The per-tensor symmetric 8-bit scale of an activation, on the card."""
    return x.abs().max() / 127.0


def draw_statistics(model, calib, generator):
    """Give the seeded ``model`` what a trained one has and the reference's
    init lacks: BatchNorm scales in [0.5, 1.5], BatchNorm shifts and conv
    and Dense biases normal with sd 0.1 (as the CPU tests draw them), and
    each BatchNorm's running mean and variance measured on its input in a
    forward of ``calib``.  With the init alone (mean 0, variance 1, zero
    biases) the activations shrink through the depth and every image of
    the set gets the same class."""
    from repro_torch.nn.layers import BatchNorm2d, Conv2d, Dense

    def measure(bn, inputs):
        a = inputs[0]
        bn.mean.copy_(a.mean((0, 2, 3)))
        bn.var.copy_(a.var((0, 2, 3), unbiased=False))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv2d, Dense)) and m.b is not None:
                m.b.normal_(0.0, 0.1, generator=generator)
            elif isinstance(m, BatchNorm2d):
                m.scale.uniform_(0.5, 1.5, generator=generator)
                m.bias.normal_(0.0, 0.1, generator=generator)
        hooks = [m.register_forward_pre_hook(measure)
                 for m in model.modules() if isinstance(m, BatchNorm2d)]
        try:
            model(calib)
        finally:
            for h in hooks:
                h.remove()


def cnn_setup(dev):
    """The accuracy path's model and data: EfficientNet-B0 at 224, w 1.0,
    1000 classes, seeded weights on the card with drawn statistics
    (:func:`draw_statistics`), 256 synthetic images, and the model's pooled
    features of them (the classifier's input)."""
    from repro_torch.data import SyntheticImages
    from repro_torch.models.cnn.zoo import build_cnn, run_blocks
    from repro_torch.nn.layers import global_avg_pool

    torch.backends.cudnn.deterministic = True
    model = build_cnn("efficientnet_b0", in_hw=224, w=1.0, n_classes=1000)
    g = torch.Generator(device=dev).manual_seed(SEED)
    model.init_weights(g, dev)
    data = SyntheticImages(n_classes=1000, hw=224)
    calib, _ = data.batch(CNN_CALIB, seed=SEED)
    draw_statistics(model, torch.from_numpy(calib).to(dev), g)
    vx, vy = data.eval_set(CNN_BATCH)
    xd = torch.from_numpy(vx).to(dev)
    with torch.no_grad():
        pooled = global_avg_pool(run_blocks(model.blocks[:-1], xd))
    return model, vx, vy, xd, pooled


def check_quant_matmul(dev, card, model, pooled):
    """Phase 8: the int8 product kernel against its plain version on the
    card; returns its record at EfficientNet-B0's classifier (launches
    filled in by phase 9)."""
    from repro_torch.kernels import ops, quant_matmul
    from repro_torch.nn.module import kaiming
    from repro_torch.testing import quant_matmul_exact

    def operands(m, k, n, bf16, seed):
        """The reference sweep's distribution (tests/test_kernels.py)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((m, k), generator=g, device=dev)
        if bf16:
            x = x.bfloat16().float()
        w = torch.randn((n, k), generator=g, device=dev) * 0.05
        return (x, *int8_columns(w), act_scale(x))

    def check(args, rel=None):
        got = quant_matmul.quant_matmul(*args)
        want = ops.quant_matmul(*args, impl="ref")
        err = float((got - want).abs().max())
        if rel is None:
            torch.testing.assert_close(got, want, rtol=QMM_TOL, atol=QMM_TOL)
        else:
            assert err <= rel * float(want.abs().max()), (err, rel)
        exact = quant_matmul_exact(*args)
        assert torch.equal(got, exact), (
            f"{int((got != exact).sum())} of {got.numel()} elements differ "
            f"from the exact reference")
        return got, err

    def design(args):
        """The launch's split over K, grid and copy width of w_q."""
        x, w_q = args[:2]
        m, k = x.shape
        n = w_q.shape[1]
        splits = quant_matmul.split_count(m, k, n, quant_matmul._sms(0))
        width = quant_matmul._lib().quant_matmul_copy_width(w_q.data_ptr(),
                                                            n)
        tile = quant_matmul.TILE
        return (f"splits {splits}, grid {-(-m // tile)} x {-(-n // tile)} x "
                f"{splits}, copy width {width}")

    def measure(label, args, out):
        x, w_q, w_scale, x_scale = args
        m, k = x.shape
        n = w_q.shape[1]
        ms = cuda_ms(lambda: quant_matmul.quant_matmul(*args), 20)
        plain_ms = cuda_ms(lambda: ops.quant_matmul(*args, impl="ref"), 5)
        n_bytes = 4 * m * k + k * n + 4 * n + 4 + 4 * m * n
        b_ms, b_by = bound(n_bytes, 2 * m * k * n, PEAK_INT8_OPS_S)
        xq = torch.clamp(torch.round(x / x_scale), -128, 127).to(torch.int8)
        # torch._int_mm takes M > 16 and K, N multiples of 8; cuBLASLt then
        # refuses M = 100 (CUBLAS_STATUS_NOT_SUPPORTED on an H100): M too
        int_mm = (cuda_ms(lambda: torch._int_mm(xq, w_q), 20)
                  if m > 16 and m % 8 == 0 and k % 8 == 0 and n % 8 == 0
                  else None)
        lib = "n/a" if int_mm is None else f"{int_mm:.4f} ms"
        print(f"  {label} ({m}, {k}) x ({k}, {n}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"_int_mm (product only) {lib}, max_abs_err {out[1]:.3e} "
              f"(max |y| {float(out[0].abs().max()):.3e}), bit-exact; "
              f"{design(args)} [{card}]")
        return ms, plain_ms, b_ms, b_by, int_mm

    print(f"quant_matmul at the reference's sweep (x float32 and through "
          f"bf16), its block variants' shape and ragged shapes, within "
          f"{QMM_TOL} of the plain version and bit for bit the exact "
          f"reference:")
    cases = [(f"sweep{' bf16' if bf16 else ''}", shape, bf16, sum(shape))
             for shape in QMM_SWEEP for bf16 in (False, True)]
    cases += [("blocks", QMM_BLOCKS, False, 0)]
    cases += [("ragged", shape, False, i + 1)
              for i, shape in enumerate(QMM_RAGGED)]
    for label, shape, bf16, seed in cases:
        args = operands(*shape, bf16, seed)
        measure(label, args, check(args))

    print("quant_matmul at the zoo's classifiers, batch "
          f"{CNN_BATCH}:")
    head = (pooled, *int8_columns(model.cls.head.w), act_scale(pooled))
    out = check(head, QMM_REL)
    ms, plain_ms, b_ms, b_by, int_mm = measure(
        "efficientnet_b0 classifier", head, out)
    record = dict(
        name="quant_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/quant_matmul.cu",
        replaces="src/repro/kernels/quant_matmul.py:44",
        design=("int8 tensor cores (mma.sync m16n8k32, csrc/mma_s8.cuh), "
                "128 x 128 tiles, 64-deep k-steps in a 4-stage cp.async "
                "ring, codes in fragment order, w_q transposed in shared "
                "memory by __byte_perm, split K added in int32 by atomicAdd "
                "and scaled by an epilogue launch; " + design(head)),
        shape=f"x ({CNN_BATCH}, 1280) f32, w_q (1280, 1000) int8",
        launches=0, max_abs_err=out[1], ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, int_mm_ms=int_mm)

    g = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.relu(torch.randn((CNN_BATCH, VGG_FC[0][0]), generator=g,
                               device=dev))
    for i, (k, n) in enumerate(VGG_FC):
        w = kaiming((n, k), fan_in=k, generator=g, device=dev)
        args = (h, *int8_columns(w), act_scale(h))
        out = check(args, QMM_REL)
        measure(f"vgg16 classifier fc{i}", args, out)
        h = torch.relu(out[0])
        del args, w
    from repro_torch.kernels import _build
    imma = _build.opcode_counts("quant_matmul.cu", "IMMA")
    if imma is None:
        print("  quant_matmul.cu: no cuobjdump in the toolkit, IMMA not "
              "counted")
        return record
    dp4a = _build.opcode_counts("quant_matmul.cu", "IDP4A")
    print("  quant_matmul.cu IMMA / IDP4A instructions by kernel: "
          + ", ".join(f"{k} {imma[k]} / {dp4a[k]}" for k in sorted(imma)))
    product = [k for k in imma if k.startswith("qmm_product_kernel")]
    assert product and all(imma[k] > 0 and dp4a[k] == 0
                           for k in product), (imma, dp4a)
    return record


def widest_split(model, schedule, cuts, quant_specs):
    """The cut vector of ``cuts`` that runs in the most stages, with its
    block cuts and stage specs (``quantize.partition_plan``)."""
    from repro_torch.quantize import partition_plan
    plans = [(c, *partition_plan(model, schedule, c, quant_specs))
             for c in cuts]
    return max(plans, key=lambda p: len(p[1]))


def cnn_path(dev, records, card, model, vx, vy, xd, front):
    """Phase 9: the accuracy path once at full width, then the model's
    int8 classifier through the product kernel, the kernel's launches
    counted in each."""
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import QuantSpec, fake_quant
    from repro_torch.kernels import ops, quant_matmul
    from repro_torch.models.cnn.zoo import run_blocks
    from repro_torch.nn.layers import global_avg_pool
    from repro_torch.quantize import cnn_measured_accuracy
    from repro_torch.serving import PartitionedCNNRunner

    spec = main_spec()
    quant_specs = [p.quant for p in spec.system.build().platforms]
    schedule = linearize(model.to_graph(), spec.schedule_policy)
    assert len(schedule) == 207, len(schedule)
    cuts = list(dict.fromkeys([tuple(c) for c in front[:CNN_CUTS]]
                              + [(-1, -1, -1)]))
    split, block_cuts, stage_specs = widest_split(model, schedule, cuts,
                                                  quant_specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    quant_matmul.quant_matmul.launches = 0

    with torch.no_grad():
        mono, mono_s = timed(lambda: model(xd))
    assert mono.shape == (CNN_BATCH, 1000), mono.shape
    assert bool(torch.isfinite(mono).all()), "non-finite logits"
    top1 = mono.argmax(-1)
    n_classes = int(top1.unique().numel())
    assert n_classes >= CNN_MIN_CLASSES, n_classes
    part, _ = PartitionedCNNRunner(model, block_cuts).run(xd)
    part_err = float((part - mono).abs().max())
    assert torch.equal(part, mono), part_err
    print(f"CNN forward: efficientnet_b0 224, {CNN_BATCH} images: "
          f"{mono_s:.3f} s ({CNN_BATCH / mono_s:.0f} images/s), top-1 over "
          f"{n_classes} classes, max |logits| {float(mono.abs().max()):.3e}; "
          f"partitioned at blocks {block_cuts} with quantization off equals "
          f"it bit for bit [{card}]")

    runner = PartitionedCNNRunner(model, block_cuts, stage_specs)
    runner.run(xd, time_stages=True)                 # warm
    logits, rep = runner.run(xd, time_stages=True)
    assert bool(torch.isfinite(logits).all())
    moved = float((logits - mono).abs().max() / mono.abs().max())
    q_agree = float((logits.argmax(-1) == top1).float().mean())
    assert moved >= QUANT_MOVE, moved
    assert q_agree >= QUANT_AGREE, q_agree
    print(f"quantized runner at the cut vector {split} (blocks {block_cuts}, "
          f"bits {[q.bits for q in stage_specs]}): stage latencies "
          f"{[round(t, 5) for t in rep.latency_s]} s, Def.-4 throughput "
          f"{rep.throughput():.3f} batches/s "
          f"({CNN_BATCH * rep.throughput():.0f} images/s), link bytes "
          f"{rep.link_bytes}; logits moved {moved:.3e} of max |logits| "
          f"from the float forward, top-1 agrees on {q_agree:.4f} [{card}]")

    measure = cnn_measured_accuracy(model, schedule, vx, vy, quant_specs)
    accs, acc_s = timed(lambda: [measure(c) for c in cuts])
    for c, a in zip(cuts, accs):
        assert 0.0 <= a <= 1.0
    print(f"measured accuracy (top-1 of {CNN_BATCH}, random weights: near "
          f"chance) over {len(cuts)} cut vectors in {acc_s:.3f} s: "
          + ", ".join(f"{c}: {a:.4f}" for c, a in zip(cuts, accs))
          + f" [{card}]")
    path_launches = quant_matmul.quant_matmul.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20

    # the int8 classifier through the product kernel, on the features of
    # the same images: the fake-quant classifier computed in integers
    quant_matmul.quant_matmul.launches = 0
    with torch.no_grad():
        pooled = global_avg_pool(run_blocks(model.blocks[:-1], xd))
        w_q, w_scale = int8_columns(model.cls.head.w)
        x_scale = act_scale(pooled)
        int8_logits = ops.quant_matmul(pooled, w_q, w_scale, x_scale) \
            + model.cls.head.b
        xf = fake_quant(pooled, x_scale, torch.zeros_like(x_scale),
                        QuantSpec(8))
        wf = w_q.float() * w_scale[None, :]
        fq = xf @ wf + model.cls.head.b
        terms = float((xf.abs() @ wf.abs()).max())
    head_err = float((int8_logits - fq).abs().max())
    assert head_err <= HEAD_REL * terms, (head_err, terms)
    agree = float((int8_logits.argmax(-1) == top1).float().mean())
    launches = quant_matmul.quant_matmul.launches
    assert launches > 0, launches
    for rec in records:
        if rec["name"] == "quant_matmul":
            rec["launches"] = launches
            rec["launches_in"] = (
                f"phase 9's int8 classifier ({launches}); the accuracy path "
                f"(cnn_measured_accuracy, PartitionedCNNRunner), like the "
                f"reference's, launched it {path_launches} times")
    print(f"int8 classifier through quant_matmul: vs the fake-quant "
          f"classifier max_abs_err {head_err:.3e} (bound {HEAD_REL} of the "
          f"largest sum of |terms| {terms:.3e}; max |y| "
          f"{float(fq.abs().max()):.3e}), top-1 agrees with the float model "
          f"on {agree:.4f} of the images [{card}]")
    print(f"CNN path: launches of quant_matmul on the accuracy path "
          f"{path_launches}, in the int8 classifier {launches}; peak device "
          f"memory of the accuracy path {peak:.0f} MiB [{card}]")

class FrontCount:
    """While installed, counts the fronts the searches' peel takes (one
    host sync each: the bottleneck of the search, PERF.md §5)."""

    def __enter__(self):
        from repro_torch.core import nsga2_torch
        self.module, self.peel, self.fronts = nsga2_torch, nsga2_torch._peel, 0

        def counting(*args):
            out = self.peel(*args)
            self.fronts += out[1]
            return out

        nsga2_torch._peel = counting
        return self

    def __exit__(self, *exc):
        self.module._peel = self.peel


def online_path(dev, card):
    """Phase 10: ``OnlineRepartitioner`` on the card over the reference's
    drift mission, phase 3's spec, each update's launch counts read."""
    import tempfile

    from repro_torch.core.graph import linearize
    from repro_torch.explore import OnlineRepartitioner
    from repro_torch.launch.drift import drift_schedule, table_signature
    from repro_torch.obs import (Obs, load_chrome_trace,
                                 validate_chrome_trace, write_chrome_trace)
    from repro_torch.obs.metrics import default_registry

    spec = main_spec()
    graph, _ = spec.model.build()
    schedule = linearize(graph, spec.schedule_policy)
    kernels = pareto_kernels()
    warm = default_registry().counter("search_warm_starts")
    warm0 = warm.value
    obs = Obs.on()
    rp = OnlineRepartitioner(spec, device=str(dev), obs=obs)
    mission = [spec.system] + drift_schedule(spec.system)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for step, system in enumerate(mission):
        for k in kernels.values():
            k.launches = 0
        with FrontCount() as fronts:
            d = rp.update(system)
        launches = read_launches(kernels)
        assert d.strategy_used == "torch_nsga2", d.strategy_used
        assert d.result.pareto, f"empty front at {d.label}"
        assert_exact_front(d.result, graph, schedule, system)
        if step >= 3:                     # platform 1 dropped
            b = [-1] + list(d.cuts)
            assert d.feasible and b[2] <= b[1], (d.label, d.cuts)
        print(f"online {d.label}: {d.repartition_ms:.1f} ms, cuts "
              f"{d.cuts}, changed {d.changed}, feasible {d.feasible}, "
              f"front {d.pareto_size}, fronts peeled {fronts.fronts}, "
              f"launches {launches} [{card}]")
    assert warm.value - warm0 == len(mission) - 1, warm.value - warm0
    sigs = {table_signature(rp, system) for system in mission}
    assert len(sigs) == 1, "drift changed a table shape"
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/online_trace.json"
        write_chrome_trace(path, obs.tracer)
        trace = load_chrome_trace(path)
    assert validate_chrome_trace(trace) == []
    marks = [e for e in trace["traceEvents"] if e.get("ph") == "i"]
    assert len(marks) == len(mission), len(marks)
    ms = [d.repartition_ms for d in rp.decisions]
    summary = obs.metrics.histogram("repartition_ms").summary()
    print(f"online path: efficientnet_b0 224, 4 platforms, torch_nsga2 pop "
          f"{POP} x {N_GEN} gen, {len(mission)} decisions: cold "
          f"{ms[0]:.1f} ms, warm {[round(m, 1) for m in ms[1:]]} ms, "
          f"repartition_ms {json.dumps(summary)}, 1 table shape signature, "
          f"trace {len(trace['traceEvents'])} events valid; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB "
          f"[{card}]")


def campaign_sweep():
    """Phase 11's sweep: the paper's six CNNs at 224 on phase 3's chain and
    on two platforms, with phase 3's search settings."""
    from repro_torch.explore import (Campaign, ModelRef, PlatformSpec,
                                     SystemSpec)
    spec = main_spec()
    four = dataclasses.replace(spec.system, name="4-chain")
    two = SystemSpec(platforms=(PlatformSpec("sensor", "eyr", bits=16),
                                PlatformSpec("central", "smb", bits=8)),
                     links=("gige",), name="2-chain")
    models = [ModelRef("cnn", name, {"in_hw": 224, "w": 1.0})
              for name in CAMPAIGN_MODELS]
    return Campaign(spec, models=models, systems=[four, two])


def campaign_path(dev, card, main_res):
    """Phase 11: the campaign serially on the card, then as a fleet of two
    worker processes on the same card, merged and compared; then a resume
    of the complete manifest."""
    import tempfile

    from repro_torch.fleet import launch, report_fingerprint, run_fleet

    camp = campaign_sweep()
    kernels = pareto_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with FrontCount() as fronts:
        serial = camp.run(device=str(dev))
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    assert len(serial.entries) == 2 * len(CAMPAIGN_MODELS)
    for e in serial.entries:
        assert e.result.strategy_used == "torch_nsga2", e.result.strategy_used
        assert e.result.pareto, (e.model, e.system)
    # the campaign's own copy of phase 3's cell finds phase 3's front
    cell = serial.get("efficientnet_b0", "4-chain")
    assert cell.pareto == main_res.pareto
    for e in serial.entries:
        print(f"campaign {e.model} x {e.system}: {e.wall_s:.3f} s, "
              f"{len(e.result.schedule)} positions, front "
              f"{len(e.result.pareto)} [{card}]")

    # every worker's exit code, kept from the launcher's wait
    codes = []
    wait = launch.wait_workers

    def keep_codes(procs):
        got = wait(procs)
        codes.extend(got)
        return got

    launch.wait_workers = keep_codes
    torch.cuda.empty_cache()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            manifest = camp.to_manifest(tmp)
            t0 = time.perf_counter()
            merged = run_fleet(tmp, workers=FLEET_WORKERS, device=str(dev))
            fleet_wall = time.perf_counter() - t0
            assert codes == [0] * FLEET_WORKERS, codes
            failed = list(Path(tmp, "failed").iterdir())
            assert not failed, failed
            assert report_fingerprint(merged) == \
                report_fingerprint(serial.report), "fleet != serial"
            assert [(e["model"], e["system"]) for e in merged.entries] == \
                [(e["model"], e["system"]) for e in serial.report.entries]
            shards = {c.id: Path(manifest._shard_path(c.id)).stat()
                      .st_mtime_ns for c in manifest.cells}
            codes.clear()
            again = run_fleet(tmp, workers=FLEET_WORKERS, device=str(dev))
            assert codes == [], "a resume of a complete manifest started " \
                "workers"
            assert report_fingerprint(again) == report_fingerprint(merged)
            assert {c.id: Path(manifest._shard_path(c.id)).stat()
                    .st_mtime_ns for c in manifest.cells} == shards
    finally:
        launch.wait_workers = wait
    for e in merged.entries:
        print(f"fleet {e['model']} x {e['system']}: {e['wall_s']:.3f} s "
              f"[{card}]")
    print(f"campaign path: {len(CAMPAIGN_MODELS)} CNNs x 2 systems, "
          f"torch_nsga2 pop {POP} x {N_GEN} gen: serial wall "
          f"{serial_wall:.3f} s (launches {launches}, fronts peeled "
          f"{fronts.fronts}, peak device memory "
          f"{peak:.0f} MiB), fleet of {FLEET_WORKERS} worker processes "
          f"{fleet_wall:.3f} s wall ({merged.wall_s:.3f} s in cells), "
          f"fleet == serial by fingerprint, resume started no worker and "
          f"rewrote no shard [{card}]")


def all_kernels():
    """The five kernels' wrappers by name."""
    from repro_torch.kernels import (pareto_rank, quant_matmul, ssd_scan,
                                     window_attn)
    return {"packed_domination": pareto_rank.packed_domination,
            "domination_counts": pareto_rank.domination_counts,
            "quant_matmul": quant_matmul.quant_matmul,
            "ssd_scan": ssd_scan.ssd_scan,
            "window_attn": window_attn.window_attn}


def first_vs_rest(times, first):
    """``times``' first ``first`` entries (ms) and the median of the rest,
    the rest's the steady state: what a run's first items pay more."""
    ms = [round(t * 1e3, 2) for t in times]
    rest = sorted(ms[first:])
    return ms[:first], rest[len(rest) // 2] if rest else None


def near_tie(model, prompt, tokens, step):
    """The two largest logits of the next token after ``prompt`` and
    ``tokens[:step]`` (the forward without cache), and their tokens."""
    dev = model.device
    seq = np.concatenate([prompt, np.asarray(tokens[:step], prompt.dtype)])
    with torch.no_grad():
        logits = model({"tokens": torch.from_numpy(seq[None]).to(dev)})
    top = torch.topk(logits[0, -1], 2)
    return top.values.tolist(), top.indices.tolist()


def serve_path(dev, card, model, cuts):
    """Phase 12: the serve runtime at full width on phase 5's model and
    cuts, async and serial, with every kernel's launch count read; then
    the drift driver's serve modes."""
    import tempfile

    from repro_torch.core.link import get_link
    from repro_torch.launch.drift import main as drift_main
    from repro_torch.serve import (PipelineServeEngine, ReplicaRouter,
                                   Request, ServeLink, poisson_traffic)
    from repro_torch.serving import GenerationEngine, PartitionedLMRunner
    from repro_torch.serving.engine import SlotDecoder

    cfg = model.cfg
    capacity = GEN_PROMPT + GEN_NEW
    runner = PartitionedLMRunner(model, cuts)
    reqs = [Request(r.rid, r.prompt, r.max_new, 0.0) for r in poisson_traffic(
        SERVE_REQUESTS, rate_rps=SERVE_RPS, vocab=cfg.vocab,
        prompt_len=GEN_PROMPT, max_new=SERVE_NEW, seed=SERVE_SEED)]
    kernels = all_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0

    tokens, summaries = {}, {}
    for mode in ("async", "serial"):
        replicas = [PipelineServeEngine(
            runner, n_slots=SERVE_SLOTS, n_groups=SERVE_GROUPS, eos=None,
            mode=mode, capacity=capacity, name=f"replica{i}",
            links=[ServeLink(model=get_link(SERVE_LINK))
                   for _ in range(runner.n_stages - 1)])
            for i in range(SERVE_REPLICAS)]
        for eng in replicas:
            eng.warmup(prompt_len=GEN_PROMPT)
        rep = ReplicaRouter(replicas).serve(reqs, realtime=False,
                                            max_wall_s=600.0)
        assert rep.n_done == len(reqs) and rep.n_failed == 0, (
            mode, rep.n_done, rep.n_failed)
        assert all(len(r.tokens) == SERVE_NEW for r in rep.records)
        tokens[mode] = {r.rid: r.tokens for r in rep.records}
        summaries[mode] = s = rep.summary()
        print(f"serve {mode}: {runner.n_stages} stages {runner.ranges}, "
              f"{SERVE_REPLICAS} replicas x {SERVE_SLOTS} slots in "
              f"{SERVE_GROUPS} waves, {len(reqs)} requests x {SERVE_NEW} "
              f"tokens: wall {s['wall_s']} s, {s['tokens_per_s']} tok/s, "
              f"TTFT p50/p95 {s['ttft_p50_ms']}/{s['ttft_p95_ms']} ms, "
              f"latency p50/p95 {s['latency_p50_ms']}/"
              f"{s['latency_p95_ms']} ms, routed "
              f"{s['routed_per_replica']} [{card}]")
        for eng in replicas:
            st = eng.stats
            ttft = {r.rid: round(r.ttft_s * 1e3, 1) for r in rep.records
                    if r.replica == eng.name}
            print(f"  {eng.name}: decode steps {st['decode_steps']}, Def.-4 "
                  f"{st['def4_steps_per_s']} steps/s against measured "
                  f"{st['measured_steps_per_s']}, stage_step_s "
                  f"{st['stage_step_s']}, link_step_s {st['link_step_s']}, "
                  f"link_model_s {st['link_model_s']}; TTFT ms by rid "
                  f"{ttft}")
            for si, stage in enumerate(eng.stages):
                print(f"    stage {si}: first prefill/steady ms "
                      f"{first_vs_rest(stage.prefill_s, 1)}, first "
                      f"{SERVE_GROUPS} decodes/steady ms "
                      f"{first_vs_rest(stage.decode_s, SERVE_GROUPS)}")
    assert tokens["async"] == tokens["serial"], "async != serial tokens"
    ratio = (summaries["async"]["tokens_per_s"]
             / summaries["serial"]["tokens_per_s"])
    print(f"serve: async == serial tokens; async/serial tok/s {ratio:.3f}")

    engine = GenerationEngine(model, max_seq=capacity)
    prompts = np.stack([r.prompt for r in reqs])
    gen = engine.generate(prompts, max_new=SERVE_NEW)
    ties = 0
    for i, r in enumerate(reqs):
        got, want = tokens["serial"][r.rid], list(gen.tokens[i])
        diff = [s for s in range(SERVE_NEW) if got[s] != want[s]]
        if not diff:
            continue
        step = diff[0]
        vals, idx = near_tie(model, r.prompt, want, step)
        gap = vals[0] - vals[1]
        print(f"serve: rid {r.rid} departs from GenerationEngine at step "
              f"{step}: served {got[step]}, engine {want[step]}, top-2 "
              f"tokens {idx} logits {vals} (gap {gap:.3e}, LOGIT_TOL "
              f"{LOGIT_TOL})")
        assert gap <= LOGIT_TOL and {got[step], want[step]} <= set(idx), (
            r.rid, step, vals, idx)
        ties += 1
    print(f"serve: tokens equal GenerationEngine's for "
          f"{len(reqs) - ties}/{len(reqs)} requests, the others after a "
          f"near tie")

    rng = np.random.default_rng(SERVE_SEED)
    pa, pb = rng.integers(0, cfg.vocab, (2, GEN_PROMPT)).astype(np.int32)

    def roll(interleave):
        sd = SlotDecoder(model, n_slots=2, max_seq=capacity)
        seq, rows = [int(np.argmax(sd.prefill(0, pa)))], []
        for step in range(8):
            if interleave and step == 2:
                sd.prefill(1, pb)          # admission into the other slot
            logits = sd.decode(np.array([seq[-1], 0], np.int32))
            rows.append(logits[0])
            seq.append(int(np.argmax(logits[0])))
        return seq, np.stack(rows)

    alone, alone_logits = roll(False)
    mixed, mixed_logits = roll(True)
    assert alone == mixed, (alone, mixed)
    bleed = float(np.abs(alone_logits - mixed_logits).max())
    launches = {name: k.launches for name, k in kernels.items()}
    assert all(v == 0 for v in launches.values()), launches
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    print(f"serve: SlotDecoder slot 0 unchanged by a mid-flight admission "
          f"(tokens equal, logits max|diff| {bleed:.3e}); launches "
          f"{launches}; peak device memory {peak:.0f} MiB [{card}]")

    common = ["--device", str(dev), "--pop", "128", "--gens", "16"]
    t0 = time.perf_counter()
    assert drift_main(common + ["--serve"]) == 0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/drift_timeline.json"
        assert drift_main(common + ["--measured", "--timeline", path]) == 0
        with open(path) as f:
            timeline = json.load(f)
    assert timeline["decision"]["trigger"] == "measured", timeline["decision"]
    print(f"drift driver on the card: --serve and --measured in "
          f"{time.perf_counter() - t0:.1f} s, measured trigger fired after "
          f"{len(timeline['divergence_series'])} observations, decision "
          f"{timeline['decision']} [{card}]")


def param_gib(model):
    """GiB of ``model``'s parameters (what the card holds for its weights,
    apart from what earlier phases left allocated)."""
    return sum(p.numel() * p.element_size()
               for p in model.parameters()) / 2 ** 30


def snapshot(model):
    """A copy of every parameter, to start each comparison from."""
    return [p.detach().clone() for p in model.parameters()]


@torch.no_grad()
def restore_params(model, snap):
    for p, s in zip(model.parameters(), snap):
        p.copy_(s)


def params_max_diff(a, b):
    """Largest |a - b| over two models' (or snapshots') parameters, on the
    device of ``b``."""
    pa = a if isinstance(a, list) else list(a.parameters())
    pb = b if isinstance(b, list) else list(b.parameters())
    return max(float((x.detach().to(y.device) - y.detach()).abs().max())
               for x, y in zip(pa, pb))


def one_step(model, cfg, opt, batch, **kw):
    """One train step of ``model`` from a fresh optimizer state; returns
    its metrics (device tensors)."""
    from repro_torch.training import init_params, make_train_step
    step = make_train_step(model, cfg, opt, **kw)
    _, metrics = step(opt.init(init_params(model)), batch)
    return metrics


def lm_train_path(dev, card, kernels):
    """Phase 13, the LM part: smollm-360m at full width trained 10 AdamW
    steps (times, tok/s, optimizer-step ms, grad norm, peak memory); one
    SGD step on the card against the CPU; remat on against off;
    grad_accum 4 against 1; Adafactor's loss falls."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models.convert import reference_leaves
    from repro_torch.models.registry import get_config
    from repro_torch.optim import (adafactor, adamw, apply_updates,
                                   clip_by_global_norm, sgd, stacked_grads,
                                   stacked_params, warmup_cosine)
    from repro_torch.training import init_params, lm_loss, make_train_step

    cfg = get_config(LM_ARCH)
    assert cfg.remat, "full-size configs checkpoint their blocks"
    model, snap, cpu = card_and_cpu(dev, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    sgd_card_vs_cpu(model, cpu, snap, cfg, card, LM_ARCH)
    del cpu

    # remat on against off, grad_accum 4 against 1 (SGD, no clip)
    batch = make_batch_for(cfg, TRAIN_B, TRAIN_T, SEED)
    after = {}
    for name, remat, accum in (("remat", True, 1), ("no remat", False, 1),
                               ("accum 4", True, 4)):
        restore_params(model, snap)
        model.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        m, s = timed(lambda: one_step(model, model.cfg, sgd(
            SGD_LR, momentum=0.0), batch, clip_norm=None, grad_accum=accum))
        after[name] = snapshot(model)
        print(f"SGD step, {name}: loss {float(m['loss']):.6f}, {s:.3f} s, "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    model.cfg = cfg
    remat_diff = params_max_diff(after["remat"], after["no remat"])
    accum_diff = params_max_diff(after["remat"], after["accum 4"])
    del after
    print(f"remat on vs off: parameters max |diff| {remat_diff:.3e} (bound "
          f"{REMAT_TOL}); grad_accum 4 vs 1: {accum_diff:.3e} (bound "
          f"{ACCUM_TOL})")
    assert remat_diff <= REMAT_TOL, remat_diff
    assert accum_diff <= ACCUM_TOL, accum_diff

    # Adafactor: two steps on one batch, the loss falls
    restore_params(model, snap)
    opt = adafactor(ADAFACTOR_LR)
    step = make_train_step(model, cfg, opt)
    state = opt.init(init_params(model))
    batch = make_batch_for(cfg, ADAFACTOR_B, ADAFACTOR_T, SEED)
    ada = []
    for _ in range(2):
        state, m = step(state, batch)
        ada.append(float(m["loss"]))
    print(f"Adafactor (lr {ADAFACTOR_LR}) 2 steps on one batch: losses "
          f"{ada}")
    assert ada[1] < ada[0], ada
    del state, step

    # AdamW on the train launcher's schedule, 10 steps at 8 x 128
    restore_params(model, snap)
    del snap
    opt = adamw(warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS))
    step = make_train_step(model, cfg, opt)
    state = opt.init(init_params(model))
    batches = [make_batch_for(cfg, TRAIN_B, TRAIN_T, i)
               for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, metrics = [], []
    for b in batches:
        (state, m), s = timed(lambda: step(state, b))
        step_s.append(s)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    toks = TRAIN_B * TRAIN_T
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses

    # the optimizer step alone (update + apply), timed on fresh gradients
    leaves = reference_leaves(model)
    lm_loss(cfg, model(batches[0], train=True), {"labels": torch.as_tensor(
        batches[0]["labels"], device=dev)}, {})[0].backward()
    grads, _ = clip_by_global_norm(stacked_grads(leaves), 1.0)

    def opt_step():
        nonlocal state
        with torch.no_grad():
            upd, state = opt.update(grads, state, stacked_params(leaves))
            apply_updates(leaves, upd)
    opt_ms = cuda_ms(opt_step, 3)
    print(f"train: {LM_ARCH} {n_params / 1e6:.1f}M parameters, {len(leaves)} "
          f"reference leaves over {sum(1 for _ in model.parameters())} "
          f"tensors, AdamW warmup_cosine({TRAIN_LR}, {TRAIN_STEPS // 10}, "
          f"{TRAIN_STEPS}), {TRAIN_B} x {TRAIN_T} tokens, remat on: step s "
          f"first {step_s[0]:.3f}, steady (median of the rest) {steady:.4f} "
          f"(all {[round(x, 4) for x in step_s]}); {toks / steady:.0f} "
          f"tok/s; optimizer step {opt_ms:.2f} ms; losses "
          f"{[round(x, 4) for x in losses]}; grad norm first {gnorm[0]:.3f} "
          f"last {gnorm[-1]:.3f}; peak device memory {peak:.2f} GiB [{card}]")
    launches = {name: k.launches for name, k in kernels.items()}
    assert all(v == 0 for v in launches.values()), launches
    print(f"train steps: launches {launches}")


def fakequant_path(dev, card, kernels):
    """Phase 13, the CNN part: the ``cnn_fakequant`` oracle on
    EfficientNet-B0 at full width, scoring up to 8 cut vectors of a search
    over its graph (K1/K2 launch there only), a fresh runner scoring them
    again bit for bit, then QAT at 4 bits."""
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import QuantSpec
    from repro_torch.data.synthetic import batch_iterator
    from repro_torch.explore import AccuracySpec, ModelRef, run_spec
    from repro_torch.optim import adamw
    from repro_torch.quantize.evaluate import (cnn_measured_accuracy,
                                               qat_finetune, quantized_eval)
    from repro_torch.training import evaluate_classifier

    spec = dataclasses.replace(
        main_spec(), model=ModelRef("cnn", "efficientnet_b0", FQ_OPTS))
    res, search_s = timed(lambda: run_spec(spec, device=str(dev)))
    search_launches = {name: k.launches for name, k in kernels.items()}
    assert search_launches["packed_domination"] > 0, search_launches
    assert res.pareto, "empty front"
    cuts = list(dict.fromkeys([tuple(p.cuts) for p in res.pareto[:CNN_CUTS]]
                              + [(-1, -1, -1)]))
    print(f"cnn_fakequant search: efficientnet_b0 {FQ_OPTS} "
          f"({len(res.schedule)} positions), phase 3's chain, pop {POP} x "
          f"{N_GEN}: {search_s:.3f} s, front {len(res.pareto)} points; "
          f"launches {search_launches}")
    for k in kernels.values():
        k.launches = 0

    # the registered oracle, built as a spec builds it on the search's
    # device; the model it trained and its data come with it for QAT
    graph, _ = spec.model.build()
    system = spec.system.build()
    oracle = AccuracySpec(kind="measured", measure="cnn_fakequant", options={
        "name": "efficientnet_b0", "steps": FQ_STEPS, "eval_size": FQ_EVAL,
        **FQ_OPTS})
    acc, train_s = timed(lambda: oracle.build(graph, res.schedule, system,
                                              dev))
    model, ds = acc.measure.model, acc.measure.dataset
    assert model.device.type == dev.type, model.device
    assert [l.name for l in linearize(model.to_graph(), spec.schedule_policy)
            ] == [l.name for l in res.schedule]
    vx, vy = ds.eval_set(FQ_EVAL)
    acc_fp = evaluate_classifier(model, vx, vy)
    scores, score_s = timed(lambda: [acc(c) for c in cuts])
    again = cnn_measured_accuracy(model, res.schedule, vx, vy,
                                  [p.quant for p in system.platforms])
    assert [again(c) for c in cuts] == scores, "a fresh runner disagrees"
    assert all(0.0 <= a <= 1.0 for a in scores), scores
    print(f"cnn_fakequant oracle built (trained {FQ_STEPS} AdamW steps at "
          f"batch 64) in {train_s:.2f} s ({FQ_STEPS / train_s:.1f} steps/s), "
          f"float top-1 "
          f"{acc_fp:.4f} over {FQ_EVAL} (bar {FQ_BAR}); {len(cuts)} cut "
          f"vectors scored in {score_s:.3f} s, again bit for bit by a fresh "
          f"runner: " + ", ".join(f"{c}: {a:.4f}" for c, a in
                                  zip(cuts, scores)) + f" [{card}]")
    assert acc_fp > FQ_BAR, acc_fp

    spec_q = QuantSpec(bits=QAT_BITS)
    acc_q = quantized_eval(model, vx, vy, spec_q)
    _, qat_s = timed(lambda: qat_finetune(
        model, spec_q, adamw(QAT_LR), batch_iterator(ds, 64, start_seed=500),
        steps=QAT_STEPS))
    acc_qat = quantized_eval(model, vx, vy, spec_q)
    print(f"QAT at {QAT_BITS} bits: float {acc_fp:.4f}, quantized "
          f"{acc_q:.4f}, after {QAT_STEPS} steps of adamw({QAT_LR}) "
          f"{acc_qat:.4f} ({qat_s:.2f} s) [{card}]")
    assert acc_q <= acc_fp + 0.02, (acc_q, acc_fp)
    assert acc_qat >= acc_q - 0.02, (acc_qat, acc_q)
    assert acc_qat >= 0.9 * acc_q, (acc_qat, acc_q)
    launches = {name: k.launches for name, k in kernels.items()}
    assert all(v == 0 for v in launches.values()), launches
    print(f"cnn_fakequant training, scoring and QAT: launches {launches}")


def train_phase(dev, card):
    """Phase 13: the training side at full width, every kernel's launches
    counted over the phase (0 in every train step; K1/K2 only in the
    search that picks the oracle's cut vectors)."""
    kernels = all_kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    lm_train_path(dev, card, kernels)
    fakequant_path(dev, card, kernels)
    print(f"phase 13 in {time.perf_counter() - t0:.1f} s")


def launcher_phase(dev, card):
    """Phase 14: ``launch.train`` at full width with a checkpoint restored
    into a fresh model bit for bit, then ``launch.serve`` at the
    reference's defaults."""
    import tempfile

    from repro_torch.checkpoint import restore
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.launch import serve, train
    from repro_torch.models.convert import (load_reference_params,
                                            reference_params)
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run = train.run(["--arch", LM_ARCH, "--steps", "4", "--log-every",
                         "2", "--ckpt", tmp, "--device", str(dev)])
        model = run.model
        fresh = build_model(model.cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1))
        like = {k: v.cpu().numpy() for k, v in
                reference_params(fresh).items()}
        load_reference_params(fresh, restore(tmp, like))
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
    batch = {"tokens": torch.from_numpy(make_batch_for(
        model.cfg, 2, TRAIN_T, SEED)["tokens"]).to(dev)}
    with torch.no_grad():
        same = torch.equal(model(batch), fresh(batch))
    assert same, "restored logits differ"
    print(f"launch.train: {LM_ARCH} at full width, 4 steps, checkpoint "
          f"restored into a fresh model: every tensor and the logits bit "
          f"for bit; losses {[round(float(m['loss']), 4) for m in run.metrics]} "
          f"[{card}]")
    del run, model, fresh

    out = serve.run(["--device", str(dev)])
    assert not out.dropped, "dropped requests"
    tokens = [{r.rid: r.tokens for r in rep.records}
              for rep in (out.async_report, out.serial_report)]
    assert tokens[0] == tokens[1], "async != serial tokens"
    print(f"launch.serve: {len(tokens[0])} requests, no drops, async tokens "
          f"== serial tokens, block cuts {out.cuts}; phase 14 in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def quant_lm_path(dev, card, cuts):
    """Phase 15: quantized LM stages on phase 5's model and cuts, each
    stage at its platform's width, with every kernel's launch count read
    (0: the runner reaches no kernel, as in the reference)."""
    from repro_torch.core.quant import QuantSpec
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serving import PartitionedLMRunner

    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    plats = lm_spec().system.build().platforms
    specs = [plats[min(i, len(plats) - 1)].quant or QuantSpec(8)
             for i in range(len(cuts) + 1)]
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_B, LM_T))).to(dev)}
    kernels = all_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0

    flt = PartitionedLMRunner(model, cuts)
    (want, frep), f_s = timed(lambda: flt.forward(batch))
    q, build_s = timed(lambda: PartitionedLMRunner(model, cuts, specs,
                                                   link_quant=True))
    (got, qrep), q_s = timed(lambda: q.forward(batch))
    assert bool(torch.isfinite(got).all()), "non-finite quantized logits"
    scale = float(want.abs().max())
    move = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    del got
    print(f"quantized LM stages: {LM_ARCH} at full width, {q.n_stages} "
          f"stages {q.ranges} at {[s.bits for s in specs]} bits, links "
          f"fake-quantized, {LM_B} x {LM_T} tokens: weights quantized in "
          f"{build_s:.3f} s, forward {q_s:.3f} s (float {f_s:.3f} s), stage "
          f"latencies {[round(x, 4) for x in qrep.latency_s]} s; logits "
          f"max|diff| from float {move:.3e} of max|logits| {scale:.3f} "
          f"(floor {QUANT_MOVE} of it), top-1 agreement {agree:.4f} "
          f"(floor {QUANT_AGREE}) [{card}]")
    assert move >= QUANT_MOVE * scale, (move, scale)
    assert agree >= QUANT_AGREE, agree
    want_bytes = [math.ceil(b * s.bits / 32)
                  for b, s in zip(frep.link_bytes, specs)]
    print(f"quantized LM stages: link bytes {qrep.link_bytes} against the "
          f"float runner's {frep.link_bytes} x bits/32 = {want_bytes}")
    assert qrep.link_bytes == want_bytes, (qrep.link_bytes, want_bytes)
    del want

    # one prefill through the quantized stage_weights, by stage_step_fn
    # (the serve runtime's path), against the quantized runner with float
    # links (the serve runtime's links quantize on their own)
    q.link_quant = False
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (QLM_STEP_B, GEN_PROMPT))).to(dev)
    want, _ = q.forward({"tokens": prompts})
    x = prompts
    for si in range(q.n_stages):
        caches = q.init_stage_caches(si, QLM_STEP_B, GEN_PROMPT)
        x, _ = q.stage_step_fn(si)(q.stage_weights(si), caches, x)
    step_err = float((x[:, -1] - want[:, -1]).abs().max())
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"quantized LM stages: stage_step_fn prefill ({QLM_STEP_B} x "
          f"{GEN_PROMPT}) vs the quantized runner's last-position logits "
          f"max_abs_err {step_err:.3e} (bound {LOGIT_TOL}); launches "
          f"{launches}; peak device memory {peak:.2f} GiB [{card}]")
    assert step_err <= LOGIT_TOL, step_err
    assert all(v == 0 for v in launches.values()), launches


class RouteLog:
    """Every MoE FFN call's routing, recorded by forward hooks: the sorted
    top-k expert indices (B, T, k) and the gap between the k-th and the
    (k+1)-th score (B, T), per call in the order of the calls."""

    def __init__(self, model):
        self.calls = []
        self.handles = [blk.moe.register_forward_hook(self._hook)
                        for blk in model.blocks if blk.kind == "moe"]

    def _hook(self, mod, args, out):
        with torch.no_grad():
            _, scores, _, idx = mod.route(args[0])
            top = torch.topk(scores, mod.k + 1, dim=-1).values
            self.calls.append((idx.sort(-1).values,
                               top[..., -2] - top[..., -1]))

    def take(self):
        calls, self.calls = self.calls, []
        return calls

    def close(self):
        for h in self.handles:
            h.remove()


def routing_flips(a, b):
    """Rows (batch index) whose routing differs between two runs' calls
    of the same MoE layers in the same order: for each, its first such
    call and the largest score gap (the larger of the two runs') over the
    tokens routed otherwise there.  Later calls of the row take inputs
    that the flip changed, so they are not examined."""
    rows = {}
    for c, ((ia, ga), (ib, gb)) in enumerate(zip(a, b)):
        diff = (ia != ib.to(ia.device)).any(-1)              # (B, T)
        gap = torch.maximum(ga, gb.to(ga.device))
        for r in diff.any(-1).nonzero().flatten().tolist():
            if r not in rows:
                rows[r] = (c, float(gap[r][diff[r]].max()))
    return rows


def gated_rows(flips, n, what):
    """The rows whose logits are gated: those without a routing flip;
    each row's first flip must be at near ties only, and at least half
    the rows gated."""
    for r, (call, gap) in sorted(flips.items()):
        print(f"{what}: row {r} first routed otherwise in MoE call {call} "
              f"at a score gap of {gap:.3e} (near-tie tolerance {TIE_TOL}):"
              f" reported, its later calls and logits not gated")
        assert gap <= TIE_TOL, (what, r, call, gap)
    rows = [r for r in range(n) if r not in flips]
    assert len(rows) >= n / 2, (what, flips)
    return rows


def engine_vs_forward(model, prompts, what):
    """``GenerationEngine``'s first-step logits against the forward's last
    position, the routing of both compared first; returns the engine and
    the first-step logits."""
    from repro_torch.serving import GenerationEngine
    dev = model.device
    engine = GenerationEngine(model, max_seq=prompts.shape[1] + MOE_NEW)
    log = RouteLog(model)
    try:
        first, _ = engine.prefill(prompts)
        pre = log.take()
        with torch.no_grad():
            want = model({"tokens": torch.from_numpy(prompts).to(dev)})[:, -1]
        fwd = log.take()
    finally:
        log.close()
    rows = gated_rows(routing_flips(pre, fwd), len(prompts), what)
    err = float((first[rows] - want[rows]).abs().max())
    print(f"{what}: first-step logits vs forward max_abs_err {err:.3e} "
          f"over {len(rows)}/{len(prompts)} rows (bound {LOGIT_TOL})")
    assert err <= LOGIT_TOL, err
    return engine, first


def moe_full_path(dev, card):
    """Phase 16, part 1: deepseek-moe-16b at full width and depth."""
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config(MOE_ARCH)
    model, build_s = timed(lambda: build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    weights = param_gib(model)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (MOE_B, MOE_T))).to(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        (logits, aux), fwd_s = timed(lambda: model.forward_aux(batch))
    assert logits.shape == (MOE_B, MOE_T, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    del logits
    aux = {k: float(v) for k, v in aux.items()}
    assert all(np.isfinite(v) for v in aux.values()), aux
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{MOE_ARCH}: full width and depth ({cfg.n_layers} layers, "
          f"{cfg.first_dense} dense, {cfg.n_experts} experts top-"
          f"{cfg.top_k} + {cfg.n_shared} shared), {n_params / 1e9:.3f} B "
          f"parameters, {weights:.2f} GiB of weights, built in "
          f"{build_s:.2f} s; forward {MOE_B} x {MOE_T} tokens {fwd_s:.3f} s "
          f"({MOE_B * MOE_T / fwd_s:.0f} tok/s); dropped {aux['dropped']:.4f}"
          f", lb_loss {aux['lb_loss']:.4f}, z_loss {aux['z_loss']:.4f}; peak "
          f"device memory {peak:.2f} GiB [{card}]")

    prompts = rng.integers(0, cfg.vocab, (GEN_REQUESTS, GEN_PROMPT))
    engine, first = engine_vs_forward(model, prompts, MOE_ARCH)
    gen = engine.generate(prompts, max_new=MOE_NEW)
    assert gen.tokens.shape == (GEN_REQUESTS, MOE_NEW), gen.tokens.shape
    assert (gen.tokens[:, 0] == first.argmax(-1).cpu().numpy()).all()
    assert ((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{MOE_ARCH}: {GEN_REQUESTS} requests, prompt {GEN_PROMPT}, "
          f"{MOE_NEW} new tokens greedy: prefill {gen.prefill_s:.3f} s "
          f"({GEN_REQUESTS * GEN_PROMPT / gen.prefill_s:.0f} tok/s), decode "
          f"{gen.decode_s:.3f} s ({gen.tokens_per_s:.1f} tok/s); peak device "
          f"memory {peak:.2f} GiB [{card}]")


def moe_train_path(dev, card):
    """Phase 16, part 2: deepseek-moe-16b at full width and depth 2, card
    against CPU (routing, logits, one SGD step), four microbatches against
    one, three AdamW steps."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models.registry import get_config
    from repro_torch.optim import adamw, sgd

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=2,
                              first_dense=1)
    model, snap, cpu = card_and_cpu(dev, cfg)
    n_params = sum(p.numel() for p in model.parameters())

    # routing first, then logits, on the same tokens
    tok = make_batch_for(cfg, TRAIN_B, TRAIN_T, SEED)["tokens"]
    calls, logits = [], []
    for m in (model, cpu):
        log = RouteLog(m)
        with torch.no_grad():
            logits.append(m({"tokens": tok}))
        calls.append(log.take())
        log.close()
    (idx_card, _), (idx_cpu, gap) = calls[0][0], calls[1][0]
    near = gap <= TIE_TOL
    differ = (idx_card.cpu() != idx_cpu).any(-1)
    rows = gated_rows(routing_flips(calls[1], calls[0]), TRAIN_B,
                      f"{MOE_ARCH} depth 2, card vs CPU")
    err = float((logits[0][rows].cpu() - logits[1][rows]).abs().max())
    print(f"{MOE_ARCH} at depth 2 ({n_params / 1e9:.3f} B parameters), card "
          f"vs CPU on {TRAIN_B} x {TRAIN_T} tokens: router top-{cfg.top_k} "
          f"indices equal for {int((~differ).sum())}/{differ.numel()} "
          f"tokens, {int(near.sum())} near ties (gap <= {TIE_TOL}), "
          f"{int(differ.sum())} routed otherwise; logits max_abs_err "
          f"{err:.3e} (bound {LOGIT_TOL}) [{card}]")
    assert err <= LOGIT_TOL, err
    del logits
    sgd_card_vs_cpu(model, cpu, snap, cfg, card, f"{MOE_ARCH} depth 2")
    del cpu

    # four microbatches.  Each row routes as its own group in every run,
    # so capacities and drops are the same, but the load-balance loss is
    # a product of batch-wide means (each expert's mean score and share
    # of choices): the whole batch's loss and gradient are not the
    # microbatches' mean, which is why the reference holds four
    # microbatches against one batch to its loose MoE bound.  The
    # accumulation itself is held tight: an SGD step (momentum 0) on the
    # mean of four gradients is the mean of four SGD steps, one on each
    # microbatch, so grad_accum 4 agrees with those as the card agrees
    # with the CPU (SGD_PARAM_REL of the step's largest change, the loss
    # within SGD_LOSS_REL of their mean); skipping a microbatch or not
    # dividing by 4 moves the parameters by about the step's change.  The
    # four steps are averaged in float64; each stored step, and
    # grad_accum's, is rounded to half a float32 ulp of its parameter
    # (1.2e-7 at the norm scales' 1.0, about the bound itself here), so
    # 2 ulps of each parameter are taken off its difference first
    batch = make_batch_for(cfg, TRAIN_B, TRAIN_T, SEED)
    n_mb = TRAIN_B // 4
    after, loss = {}, {}
    for accum in (1, 4):
        restore_params(model, snap)
        m, s = timed(lambda: one_step(model, cfg, sgd(SGD_LR, momentum=0.0),
                                      batch, clip_norm=None,
                                      grad_accum=accum))
        after[accum], loss[accum] = snapshot(model), float(m["loss"])
        print(f"{MOE_ARCH} depth 2, SGD step grad_accum {accum}: loss "
              f"{loss[accum]:.6f}, lb_loss {float(m['lb_loss']):.4f}, "
              f"dropped {float(m['dropped']):.4f}, {s:.3f} s")
    accum_diff = params_max_diff(after[1], after[4])
    mean, mb_loss = [torch.zeros_like(p, dtype=torch.float64)
                     for p in snap], []
    for i in range(4):
        restore_params(model, snap)
        mb = {k: v[i * n_mb:(i + 1) * n_mb] for k, v in batch.items()}
        mb_loss.append(float(one_step(model, cfg, sgd(SGD_LR, momentum=0.0),
                                      mb, clip_norm=None)["loss"]))
        with torch.no_grad():
            for acc, p in zip(mean, model.parameters()):
                acc.add_(p.double(), alpha=0.25)
    change = params_max_diff(snap, after[4])
    mb_diff = mb_excess = 0.0
    for acc, p in zip(mean, after[4]):
        d = (acc - p.double()).abs()
        mb_diff = max(mb_diff, float(d.max()))
        mb_excess = max(mb_excess, float((d - 2 * torch.finfo(
            torch.float32).eps * p.double().abs()).max()))
    mb_rel = abs(loss[4] - sum(mb_loss) / 4) / abs(loss[4])
    del after, mean
    print(f"{MOE_ARCH} depth 2, grad_accum 4 vs 1: parameters max |diff| "
          f"{accum_diff:.3e} (bound {MOE_ACCUM_TOL}), loss diff "
          f"{abs(loss[1] - loss[4]):.3e} (bound {MOE_ACCUM_LOSS}); "
          f"grad_accum 4 vs the mean of one SGD step on each microbatch: "
          f"parameters max |diff| {mb_diff:.3e}, beyond 2 float32 ulps "
          f"{mb_excess:.3e} against the step's largest change {change:.3e} "
          f"(bound {SGD_PARAM_REL} of it), loss rel diff {mb_rel:.3e} "
          f"(bound {SGD_LOSS_REL})")
    assert accum_diff <= MOE_ACCUM_TOL, accum_diff
    assert abs(loss[1] - loss[4]) <= MOE_ACCUM_LOSS, loss
    assert mb_excess <= SGD_PARAM_REL * change, (mb_excess, change)
    assert mb_rel <= SGD_LOSS_REL, (loss[4], mb_loss)

    restore_params(model, snap)
    del snap
    from repro_torch.training import init_params, make_train_step
    opt = adamw(MOE_ADAMW_LR)
    step = make_train_step(model, cfg, opt)
    state = opt.init(init_params(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    adam, step_s = [], []
    for _ in range(3):
        (state, m), s = timed(lambda: step(state, batch))
        adam.append(float(m["loss"]))
        step_s.append(s)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{MOE_ARCH} depth 2, AdamW ({MOE_ADAMW_LR}) 3 steps on one "
          f"{TRAIN_B} x {TRAIN_T} batch: losses {[round(x, 4) for x in adam]}"
          f", step s {[round(x, 3) for x in step_s]}, peak device memory "
          f"{peak:.2f} GiB [{card}]")
    assert all(np.isfinite(adam)) and adam[-1] < adam[0], adam


def v3_path(dev, card):
    """Phase 16, part 3: deepseek-v3-671b at full width and depth 2 with
    its MTP block."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.training import lm_loss

    full = get_config(V3_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, first_dense=1)
    model, build_s = timed(lambda: build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    weights = param_gib(model)
    batch = make_batch_for(cfg, MOE_B, MOE_T, SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        (logits, aux), fwd_s = timed(lambda: model.forward_aux(
            batch, train=True))
        loss, metrics = lm_loss(cfg, logits, {"labels": torch.as_tensor(
            batch["labels"], device=dev)}, aux)
    assert aux["mtp_logits"].shape == (MOE_B, MOE_T, cfg.vocab)
    assert bool(torch.isfinite(aux["mtp_logits"]).all()), "mtp_logits"
    assert bool(torch.isfinite(logits).all()) and np.isfinite(float(loss))
    del logits, aux
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{V3_ARCH}: full width (d {cfg.d_model}, {cfg.n_heads} heads, MLA "
          f"q/kv ranks {cfg.q_lora_rank}/{cfg.kv_lora_rank}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared} shared, "
          f"vocab {cfg.vocab}) at depth {cfg.n_layers} (first_dense "
          f"{cfg.first_dense}; published {full.n_layers} and "
          f"{full.first_dense}) with {cfg.mtp} MTP block: {n_params / 1e9:.3f}"
          f" B parameters, {weights:.2f} GiB, built in {build_s:.2f} s; "
          f"train=True forward {MOE_B} x {MOE_T} tokens {fwd_s:.3f} s "
          f"({MOE_B * MOE_T / fwd_s:.0f} tok/s): lm_loss "
          f"{float(loss):.4f} (ce {float(metrics['ce']):.4f}, mtp "
          f"{float(metrics['mtp']):.4f}, lb_loss "
          f"{float(metrics['lb_loss']):.4f}, dropped "
          f"{float(metrics['dropped']):.4f}); peak device memory {peak:.2f} "
          f"GiB [{card}]")

    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (GEN_REQUESTS, GEN_PROMPT))
    engine, first = engine_vs_forward(model, prompts,
                                      f"{V3_ARCH} absorbed MLA decode")
    gen = engine.generate(prompts, max_new=MOE_NEW)
    assert gen.tokens.shape == (GEN_REQUESTS, MOE_NEW)
    assert (gen.tokens[:, 0] == first.argmax(-1).cpu().numpy()).all()
    caches = model.init_caches(1, 1, torch.float32)
    latent = sum(c["ckv"][:, 0, 0].numel() + c["kr"][:, 0, 0].numel()
                 for c in caches.values()) * 4
    gqa = cfg.n_layers * 2 * cfg.n_kv * cfg.resolved_head_dim * 4
    mha = cfg.n_layers * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                                        + cfg.v_head_dim) * 4
    print(f"{V3_ARCH}: {GEN_REQUESTS} requests, prompt {GEN_PROMPT}, "
          f"{MOE_NEW} new tokens greedy: prefill {gen.prefill_s:.3f} s "
          f"({GEN_REQUESTS * GEN_PROMPT / gen.prefill_s:.0f} tok/s), decode "
          f"{gen.decode_s:.3f} s ({gen.tokens_per_s:.1f} tok/s); cache bytes a "
          f"token over {cfg.n_layers} layers (float32): latent {latent}, a "
          f"GQA cache of n_kv {cfg.n_kv} x head_dim "
          f"{cfg.resolved_head_dim} {gqa} ({gqa / latent:.1f}x), the "
          f"decompressed keys and values {mha} ({mha / latent:.1f}x) "
          f"[{card}]")


def moe_phase(dev, card):
    """Phase 16: the moe family at full width, every kernel's launch count
    set to 0 just before and read just after (0 for all five: MoE and MLA
    reach no kernel, as in the reference); each model freed before the
    next is built."""
    kernels = all_kernels()
    t0 = time.perf_counter()
    for part in (moe_full_path, moe_train_path, v3_path):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        part(dev, card)
        launches = {name: k.launches for name, k in kernels.items()}
        print(f"phase 16 {part.__name__}: launches {launches}")
        assert all(v == 0 for v in launches.values()), launches
    torch.cuda.empty_cache()
    print(f"phase 16 in {time.perf_counter() - t0:.1f} s [{card}]")


def max_abs_diff(a, b, rows=1024):
    """max |a - b| over two tensors of one shape, ``rows`` rows of their
    last axis at a time (two 10 GB logits leave no room for a third)."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return max(float((a[i:i + rows] - b[i:i + rows]).abs().max())
               for i in range(0, a.shape[0], rows))


def grid_positions(b, side, n_text, dev):
    """Qwen2-VL's M-RoPE ids (3, b, side**2 + n_text) of a side x side
    patch grid (t 0, h row, w col) followed by n_text tokens, which
    continue from ``side`` on all three axes."""
    rows, cols = np.divmod(np.arange(side * side), side)
    text = side + np.arange(n_text)
    pos = np.stack([np.concatenate([np.zeros(side * side, np.int64), text]),
                    np.concatenate([rows, text]),
                    np.concatenate([cols, text])])
    return torch.from_numpy(np.broadcast_to(
        pos[:, None], (3, b, pos.shape[1])).copy()).to(dev)


def vlm_batch(cfg, b, n_text, rng, dev):
    """``b`` rows of the config's n_patches seeded vision embeddings and
    ``n_text`` seeded tokens at grid positions."""
    side = math.isqrt(cfg.n_patches)
    assert side * side == cfg.n_patches, cfg.n_patches
    return {"vision_embeds": torch.from_numpy(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(dev),
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (b, n_text))).to(dev),
            "positions3": grid_positions(b, side, n_text, dev)}


def searched_cuts(arch, seq, dev):
    """Block cuts of ``arch`` from a search over its graph at ``seq``
    tokens between lm_spec's two platforms, VLM_MEM each."""
    from repro_torch.explore import lm_block_cuts, run_spec
    from repro_torch.models.registry import get_config
    res, search_s = timed(lambda: run_spec(lm_spec(arch, VLM_MEM, seq),
                                           device=str(dev)))
    assert res.strategy_used == "torch_nsga2" and res.pareto, "no front"
    sel = res.selected.cuts if res.selected is not None else (1,)
    cuts = lm_block_cuts(sel, get_config(arch).n_layers)
    print(f"{arch} search: seq {seq} ({len(res.schedule)} positions), 2 "
          f"platforms of {VLM_MEM / 2 ** 30:.0f} GiB, torch_nsga2 pop {POP} "
          f"x {LM_GEN} gen: {search_s:.3f} s, front {len(res.pareto)} "
          f"points, selected {tuple(sel)} -> block cuts {cuts}")
    return cuts


def card_and_cpu(dev, cfg):
    """``cfg``'s model with seeded weights on the card, a snapshot of
    those weights, and a copy of the model on the CPU."""
    from repro_torch.models.registry import build_model
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    snap = snapshot(model)
    cpu = build_model(cfg, device="meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict(model.state_dict())
    return model, snap, cpu


def sgd_card_vs_cpu(model, cpu, snap, cfg, card, what):
    """One SGD step (momentum 0, lr SGD_LR, no clip) at SGD_B x SGD_T from
    the same weights on the card and on the CPU: the losses within
    SGD_LOSS_REL, every parameter within SGD_PARAM_REL of the step's
    largest change."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.optim import sgd

    batch = make_batch_for(cfg, SGD_B, SGD_T, SEED)
    losses = {}
    for name, m in (("cuda", model), ("cpu", cpu)):
        t0 = time.perf_counter()
        losses[name] = float(one_step(m, cfg, sgd(SGD_LR, momentum=0.0),
                                      batch, clip_norm=None)["loss"])
        print(f"{what}, SGD step on {name}: loss {losses[name]:.7f} in "
              f"{time.perf_counter() - t0:.2f} s")
    change = params_max_diff(snap, cpu)
    sgd_diff = params_max_diff(model, cpu)
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{what} ({n_params / 1e9:.3f} B parameters), SGD step (lr "
          f"{SGD_LR}, {SGD_B} x {SGD_T} tokens) card vs CPU: loss rel diff "
          f"{rel:.3e} (bound {SGD_LOSS_REL}), parameters max |diff| "
          f"{sgd_diff:.3e} against the step's largest change {change:.3e} "
          f"(bound {SGD_PARAM_REL} of it) [{card}]")
    assert rel <= SGD_LOSS_REL, rel
    assert sgd_diff <= SGD_PARAM_REL * change, (sgd_diff, change)


def vlm_path(dev, card, records):
    """Phase 17, part 1: qwen2-vl-7b at full width and depth: its cut
    searched, the forward over 2 x (256 patches + 7936 tokens) through K5
    against chunked_sdpa, 8 text requests, the runner float and
    quantized."""
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels import window_attn
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serving import GenerationEngine, PartitionedLMRunner

    cfg = get_config(VLM_ARCH)
    cuts = searched_cuts(VLM_ARCH, VLM_T, dev)
    model, build_s = timed(lambda: build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    weights = param_gib(model)
    rng = np.random.default_rng(SEED)
    batch = vlm_batch(cfg, VLM_B, VLM_T - cfg.n_patches, rng, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    k5 = window_attn.window_attn
    before = k5.launches
    logits, fwd_s = timed(lambda: model(batch, impl="cuda"))
    k5_launches = k5.launches - before
    assert k5_launches == cfg.n_layers, k5_launches
    assert logits.shape == (VLM_B, VLM_T, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    ref_logits, ref_s = timed(lambda: model(batch, impl="ref"))
    err = max_abs_diff(logits, ref_logits)
    del logits, ref_logits
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{VLM_ARCH}: full width and depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv} KV heads of "
          f"dim {cfg.resolved_head_dim}, window {cfg.window}, M-RoPE "
          f"{cfg.mrope_sections}), {n_params / 1e9:.3f} B parameters, "
          f"{weights:.2f} GiB of weights, built in {build_s:.2f} s; "
          f"forward {VLM_B} x ({cfg.n_patches} patches + "
          f"{VLM_T - cfg.n_patches} tokens) at grid positions through K5 "
          f"{fwd_s:.3f} s ({VLM_B * VLM_T / fwd_s:.0f} tok/s, K5 launches "
          f"{k5_launches}), through chunked_sdpa {ref_s:.3f} s; logits "
          f"max_abs_err {err:.3e} (bound {LOGIT_TOL}); peak device memory "
          f"{peak:.2f} GiB [{card}]")
    assert err <= LOGIT_TOL, err
    for rec in records:
        if rec["name"] == WA_VLM_NAME:
            rec["launches"] = k5_launches

    engine = GenerationEngine(model, max_seq=GEN_PROMPT + GEN_NEW)
    prompts = rng.integers(0, cfg.vocab, (GEN_REQUESTS, GEN_PROMPT))
    first, _ = engine.prefill(prompts)
    with torch.no_grad():
        want = model({"tokens": torch.from_numpy(prompts).to(dev)})[:, -1]
    first_err = float((first - want).abs().max())
    assert first_err <= LOGIT_TOL, first_err
    gen = engine.generate(prompts, max_new=GEN_NEW)
    assert gen.tokens.shape == (GEN_REQUESTS, GEN_NEW), gen.tokens.shape
    assert (gen.tokens[:, 0] == first.argmax(-1).cpu().numpy()).all()
    assert ((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()
    print(f"{VLM_ARCH}: {GEN_REQUESTS} text requests, prompt {GEN_PROMPT}, "
          f"{GEN_NEW} new tokens greedy: prefill {gen.prefill_s:.3f} s "
          f"({GEN_REQUESTS * GEN_PROMPT / gen.prefill_s:.0f} tok/s), decode "
          f"{gen.decode_s:.3f} s ({gen.tokens_per_s:.1f} tok/s); first-step "
          f"logits vs forward max_abs_err {first_err:.3e} (bound "
          f"{LOGIT_TOL}) [{card}]")

    run_batch = vlm_batch(cfg, VLM_B, VLM_RUN_TEXT, rng, dev)
    with torch.no_grad():
        mono = model(run_batch)
    runner = PartitionedLMRunner(model, cuts)
    (part, rep), part_s = timed(lambda: runner.forward(run_batch))
    part_err = float((part - mono).abs().max())
    assert part_err <= PART_TOL, part_err
    del part
    print(f"{VLM_ARCH} runner: {runner.n_stages} stages {runner.ranges}, "
          f"{VLM_B} x ({cfg.n_patches} + {VLM_RUN_TEXT}) positions with "
          f"vision: {part_s:.3f} s, stage latencies "
          f"{[round(x, 4) for x in rep.latency_s]} s, link bytes "
          f"{rep.link_bytes}; vs monolithic max_abs_err {part_err:.3e} "
          f"(bound {PART_TOL})")
    plats = lm_spec(VLM_ARCH, VLM_MEM, VLM_T).system.build().platforms
    specs = [plats[min(i, len(plats) - 1)].quant or QuantSpec(8)
             for i in range(len(cuts) + 1)]
    q, qbuild_s = timed(lambda: PartitionedLMRunner(model, cuts, specs,
                                                    link_quant=True))
    (got, qrep), q_s = timed(lambda: q.forward(run_batch))
    assert bool(torch.isfinite(got).all()), "non-finite quantized logits"
    scale = float(mono.abs().max())
    move = float((got - mono).abs().max())
    agree = float((got.argmax(-1) == mono.argmax(-1)).float().mean())
    del got, mono, q
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{VLM_ARCH} quantized runner at {[s.bits for s in specs]} bits, "
          f"links fake-quantized: weights quantized in {qbuild_s:.3f} s, "
          f"forward {q_s:.3f} s; logits max|diff| from float {move:.3e} of "
          f"max|logits| {scale:.3f} (floor {QUANT_MOVE} of it), top-1 "
          f"agreement {agree:.4f} (floor {QUANT_AGREE}), link bytes "
          f"{qrep.link_bytes}; peak device memory {peak:.2f} GiB [{card}]")
    assert move >= QUANT_MOVE * scale, (move, scale)
    assert agree >= QUANT_AGREE, agree


def vlm_train_path(dev, card, records):
    """Phase 17, part 2: qwen2-vl-7b at full width and depth 2: one SGD
    step card against CPU, four microbatches against one."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models.registry import get_config
    from repro_torch.optim import sgd

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=2)
    model, snap, cpu = card_and_cpu(dev, cfg)
    sgd_card_vs_cpu(model, cpu, snap, cfg, card, f"{VLM_ARCH} depth 2")
    del cpu
    batch = make_batch_for(cfg, VLM_ACCUM_B, VLM_ACCUM_T, SEED)
    after, loss = {}, {}
    for accum in (1, 4):
        restore_params(model, snap)
        m, s = timed(lambda: one_step(model, cfg, sgd(SGD_LR, momentum=0.0),
                                      batch, clip_norm=None,
                                      grad_accum=accum))
        after[accum], loss[accum] = snapshot(model), float(m["loss"])
        print(f"{VLM_ARCH} depth 2, SGD step grad_accum {accum} at "
              f"{VLM_ACCUM_B} x ({cfg.n_patches} + {VLM_ACCUM_T}): loss "
              f"{loss[accum]:.6f}, {s:.3f} s")
    accum_diff = params_max_diff(after[1], after[4])
    print(f"{VLM_ARCH} depth 2, grad_accum 4 vs 1: parameters max |diff| "
          f"{accum_diff:.3e} (bound {ACCUM_TOL}), losses {loss}")
    assert accum_diff <= ACCUM_TOL, accum_diff


def audio_path(dev, card, records):
    """Phase 17, part 3: musicgen-large at full size: its cut searched,
    the forward over 4 clips of 1500 frames, the runner, a greedy decode
    loop over codes."""
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serving import PartitionedLMRunner

    cfg = get_config(AUDIO_ARCH)
    k = cfg.n_codebooks
    cuts = searched_cuts(AUDIO_ARCH, AUDIO_T, dev)
    model, build_s = timed(lambda: build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED)))
    n_params = sum(p.numel() for p in model.parameters())
    weights = param_gib(model)
    rng = np.random.default_rng(SEED)
    batch = {"codes": torch.from_numpy(rng.integers(
        0, cfg.vocab, (AUDIO_B, k, AUDIO_T))).to(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    logits, fwd_s = timed(lambda: model(batch))
    assert logits.shape == (AUDIO_B, AUDIO_T, k, cfg.vocab), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{AUDIO_ARCH}: full size ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads, {k} codebooks of "
          f"{cfg.vocab}), {n_params / 1e9:.3f} B parameters, {weights:.2f} "
          f"GiB of weights, built in {build_s:.2f} s; forward {AUDIO_B} "
          f"clips x {AUDIO_T} frames {fwd_s:.3f} s "
          f"({AUDIO_B * AUDIO_T / fwd_s:.0f} frames/s); peak device memory "
          f"{peak:.2f} GiB [{card}]")
    runner = PartitionedLMRunner(model, cuts)
    (part, rep), part_s = timed(lambda: runner.forward(batch))
    part_err = float((part - logits).abs().max())
    assert part_err <= PART_TOL, part_err
    del part, logits
    print(f"{AUDIO_ARCH} runner: {runner.n_stages} stages {runner.ranges}: "
          f"{part_s:.3f} s, stage latencies "
          f"{[round(x, 4) for x in rep.latency_s]} s, link bytes "
          f"{rep.link_bytes}; vs monolithic max_abs_err {part_err:.3e} "
          f"(bound {PART_TOL})")

    # greedy decode over codes, every codebook's argmax each frame (the
    # engine takes tokens only)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (AUDIO_REQUESTS, k, AUDIO_PROMPT))).to(dev)
    with torch.no_grad():
        want = model({"codes": prompts})[:, -1]
        caches = model.init_caches(AUDIO_REQUESTS, AUDIO_PROMPT + AUDIO_NEW,
                                   torch.float32)
        (first, caches), prefill_s = timed(lambda: model.decode_step(
            caches, {"codes": prompts}))
        first = first[:, -1]
        first_err = float((first - want).abs().max())
        assert first_err <= LOGIT_TOL, first_err
        cur, out = first, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AUDIO_NEW):
            nxt = cur.argmax(-1)                               # (B, K)
            out.append(nxt)
            logits, caches = model.decode_step(caches, {"codes": nxt[:, :,
                                                                     None]})
            cur = logits[:, -1]
        frames = torch.stack(out, dim=-1).cpu()
        decode_s = time.perf_counter() - t0
    assert frames.shape == (AUDIO_REQUESTS, k, AUDIO_NEW), frames.shape
    assert int(caches["dense"]["pos"][0]) == AUDIO_PROMPT + AUDIO_NEW
    assert bool(((frames >= 0) & (frames < cfg.vocab)).all())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{AUDIO_ARCH}: {AUDIO_REQUESTS} requests, prompt {AUDIO_PROMPT} "
          f"frames, {AUDIO_NEW} new frames greedy through decode_step: "
          f"prefill {prefill_s:.3f} s "
          f"({AUDIO_REQUESTS * AUDIO_PROMPT / prefill_s:.0f} frames/s), "
          f"decode {decode_s:.3f} s "
          f"({AUDIO_REQUESTS * AUDIO_NEW / decode_s:.1f} frames/s); "
          f"first-step logits vs forward max_abs_err {first_err:.3e} "
          f"(bound {LOGIT_TOL}); peak device memory {peak:.2f} GiB [{card}]")


def audio_train_path(dev, card, records):
    """Phase 17, part 4: musicgen-large at full width, 3 AdamW steps at
    depth AUDIO_ADAMW_DEPTH; one SGD step card against CPU at depth 2."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.optim import adamw
    from repro_torch.training import init_params, make_train_step

    full = get_config(AUDIO_ARCH)
    cfg = dataclasses.replace(full, n_layers=AUDIO_ADAMW_DEPTH)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    weights = param_gib(model)
    opt = adamw(MOE_ADAMW_LR)
    step = make_train_step(model, cfg, opt)
    state = opt.init(init_params(model))
    batch = make_batch_for(cfg, AUDIO_TRAIN_B, AUDIO_TRAIN_T, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    for _ in range(3):
        (state, m), s = timed(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        step_s.append(s)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    frames = AUDIO_TRAIN_B * AUDIO_TRAIN_T
    print(f"{AUDIO_ARCH} at full width and depth {cfg.n_layers} (published "
          f"{full.n_layers}), {n_params / 1e9:.3f} B parameters ({weights:.2f}"
          f" GiB), AdamW ({MOE_ADAMW_LR}) 3 steps on one {AUDIO_TRAIN_B} x "
          f"{AUDIO_TRAIN_T} batch, remat {cfg.remat}: losses "
          f"{[round(x, 4) for x in losses]}, step s "
          f"{[round(x, 3) for x in step_s]} ({frames / step_s[-1]:.0f} "
          f"frames/s at the last), peak device memory {peak:.2f} GiB "
          f"({peak / weights:.2f} x the weights) [{card}]")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    del state, step, model
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, n_layers=2)
    model, snap, cpu = card_and_cpu(dev, cfg)
    sgd_card_vs_cpu(model, cpu, snap, cfg, card, f"{AUDIO_ARCH} depth 2")


def family_phase(dev, card, records):
    """Phase 17: the audio and vlm families at full width, each part with
    every kernel's launch count set to 0 just before and read just after:
    K5 28 times in qwen2-vl-7b's forward through the kernel and nowhere
    else, K1 and K2 in the two searches, K3 and K4 never; each model freed
    before the next is built."""
    from repro_torch.models.registry import get_config
    kernels = all_kernels()
    t0 = time.perf_counter()
    for part, searches in ((vlm_path, True), (vlm_train_path, False),
                           (audio_path, True), (audio_train_path, False)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        part(dev, card, records)
        launches = {name: k.launches for name, k in kernels.items()}
        print(f"phase 17 {part.__name__}: launches {launches}")
        k5 = get_config(VLM_ARCH).n_layers if part is vlm_path else 0
        assert launches["window_attn"] == k5, launches
        assert launches["quant_matmul"] == launches["ssd_scan"] == 0, launches
        for name in ("packed_domination", "domination_counts"):
            assert (launches[name] > 0) == searches, launches
    torch.cuda.empty_cache()
    print(f"phase 17 in {time.perf_counter() - t0:.1f} s [{card}]")


def pipeline_phase(dev, card, records):
    """Phase 18: smollm-360m at full width pipelined at 2 and 4 stages
    (stage streams on the one card, 4 microbatches) against the
    monolithic forward, K5 counted in each pipelined run."""
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.launch.pipeline import (explorer_stage_boundary,
                                             pipelined_apply, stack_stages)
    from repro_torch.models.registry import build_model, get_config

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    kernels = all_kernels()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (PIPE_B, LM_T))).to(dev)}
    with torch.no_grad():
        model(batch, impl="cuda")                      # warm-up
        mono, mono_s = timed(lambda: model(batch, impl="cuda"))
    mb = PIPE_B // PIPE_M
    link = mb * LM_T * cfg.d_model * 4                 # float32 (mb, T, d)
    k5 = {}
    for n_stages in PIPE_STAGES:
        stages = stack_stages(model, n_stages)
        mesh = make_stage_mesh(n_stages, dev)

        def run():
            return pipelined_apply(model, stages, batch, mesh, PIPE_M,
                                   impl="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k.launches = 0
        with keep_window_attn_inputs(cfg.n_layers * PIPE_M - 1) as kept:
            piped, first_s = timed(run)
        launches = {name: k.launches for name, k in kernels.items()}
        assert launches["window_attn"] == cfg.n_layers * PIPE_M, launches
        assert sum(launches.values()) == launches["window_attn"], launches
        k5[n_stages] = launches["window_attn"]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        err = max_abs_diff(piped, mono)
        del piped
        piped_s = timed(run)[1]
        bubble = (n_stages - 1) / (PIPE_M + n_stages - 1)
        print(f"pipeline: {LM_ARCH} ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, window {cfg.window}) {PIPE_B} x {LM_T} tokens "
              f"at {n_stages} stages of {cfg.n_layers // n_stages} blocks, "
              f"{PIPE_M} microbatches of {mb} x {LM_T}: K5 launches "
              f"{k5[n_stages]} ({cfg.n_layers} x {PIPE_M}); link tensor "
              f"{link} B ({link / 2 ** 20:.2f} MiB) a handoff, "
              f"{(n_stages - 1) * PIPE_M} handoffs; pipelined "
              f"{first_s:.3f} s first, {piped_s:.3f} s second, monolithic "
              f"{mono_s:.3f} s (ratio {piped_s / mono_s:.3f}; GPipe bubble "
              f"(S-1)/(M+S-1) = {bubble:.3f}); peak device memory "
              f"{peak:.2f} GiB; vs monolithic max_abs_err {err:.3e} (bound "
              f"{PIPE_TOL}) [{card}]")
        assert err <= PIPE_TOL, err
        check_window_attn_kept(kept, f"{n_stages} stages' last launch", card)
        del kept
    del mono, model
    torch.cuda.empty_cache()
    for rec in records:
        if rec["name"] == "window_attn":
            rec["launches_in"] = (
                f"phase 5's forward ({rec['launches']}); phase 18's pipelined "
                f"forwards " + ", ".join(f"{n} at {s} stages" for s, n in
                                         k5.items())
                + f" ({cfg.n_layers} blocks x {PIPE_M} microbatches)")
    for n_stages in PIPE_STAGES:
        (cuts, res), search_s = timed(lambda: explorer_stage_boundary(
            cfg, LM_T, n_stages, device=dev))
        step = cfg.n_layers // n_stages
        balanced = [(k + 1) * step - 1 for k in range(n_stages - 1)]
        print(f"explorer_stage_boundary({LM_ARCH}, {LM_T}, {n_stages}): cut "
              f"after blocks {cuts} ({res.strategy_used}, {search_s:.2f} s); "
              f"balanced split {balanced}; agree: {cuts == balanced}")
    print(f"phase 18 in {time.perf_counter() - t0:.1f} s [{card}]")


@contextlib.contextmanager
def keep_window_attn_inputs(call: int):
    """Inside, clones of the inputs of K5's ``call``-th launch (from 0) go
    into the yielded dict, made on the stream that launched it.  The
    dispatch's module handle is swapped, not the wrapper, whose count is
    its own attribute."""
    from repro_torch.kernels import ops
    module, kept, n = ops._wa, {}, [0]

    def keeping(q, k, v, window):
        if n[0] == call:
            kept.update(q=q.clone(), k=k.clone(), v=v.clone(), w=window)
        n[0] += 1
        return module.window_attn(q, k, v, window)
    ops._wa = types.SimpleNamespace(window_attn=keeping)
    try:
        yield kept
    finally:
        ops._wa = module
    assert kept, f"K5 was launched {n[0]} times, not {call + 1}"


def check_window_attn_kept(kept, what, card):
    """K5 on inputs the main path gave it against its plain version (within
    ``WA_TOL``), both timed."""
    from repro_torch.kernels import window_attn
    q, k, v, w = kept["q"], kept["k"], kept["v"], kept["w"]
    got = window_attn.window_attn(q, k, v, w)
    want = window_attn_plain(q, k, v, w)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=WA_TOL, atol=WA_TOL)
    del got, want
    ms = cuda_ms(lambda: window_attn.window_attn(q, k, v, w), 10)
    plain_ms = cuda_ms(lambda: window_attn_plain(q, k, v, w), 2)
    print(f"window_attn on {what}'s inputs: q {tuple(q.shape)}, k/v "
          f"{tuple(k.shape)}, window {w}, max|q| {float(q.abs().max()):.3e}, "
          f"max|v| {float(v.abs().max()):.3e}: max_abs_err {err:.3e} against "
          f"the plain version (bound {WA_TOL}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms [{card}]")


def pod_phase(dev, card):
    """Phase 19: the reference's smoke pairs and ``diagnose`` on ``meta``,
    then the dry-run's estimate of phase 13's step held against that step
    on the card."""
    t0 = time.perf_counter()
    smoke_pairs(card)
    card_check(dev, card)
    print(f"phase 19 in {time.perf_counter() - t0:.1f} s [{card}]")


def smoke_pairs(card):
    """The reference's two smoke pairs (tests/test_pipeline_multidev.py)
    and ``diagnose`` of one pair, on ``meta``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.diagnose import diagnose
    t0 = time.perf_counter()
    for arch, shape_name, multi_pod in (("smollm-360m", "decode_32k", False),
                                        ("mamba2-370m", "train_4k", True)):
        row = dryrun.dryrun_one(arch, shape_name, multi_pod=multi_pod)
        assert "error" not in row, row
        assert row["n_devices"] == (512 if multi_pod else 256), row
        assert row["flops_per_device"] > 0 and row["bound_s"] > 0, row
    diagnose(LM_ARCH, "train_4k", k=5)
    print(f"dry-run smoke pairs and diagnose in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def card_check(dev, card):
    """The dry-run's estimate of phase 13's step (built and counted on
    meta) against that step on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import get_config
    from repro_torch.nn import sharding as shd

    cfg = get_config(LM_ARCH)
    shape = ShapeConfig("phase13", TRAIN_T, TRAIN_B, "train")
    mesh = make_host_mesh(device=dev)
    rules = dryrun.run_rules(mesh, shape, False)
    with shd.mesh_context(mesh, rules):
        counter = CostCounter()
        est, est_s = timed(lambda: build_train_setup(cfg, shape, mesh,
                                                     counter=counter))
        memory, roof = dryrun.account(est, counter, shape, mesh)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        setup = build_train_setup(cfg, shape, mesh, device=dev, seed=SEED)
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (TRAIN_B, TRAIN_T + 1)).astype(np.int32)).to(dev)
        batch = {"tokens": tokens[:, :-1].contiguous(),
                 "labels": tokens[:, 1:].contiguous()}
        args = (*setup.args[:3], batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev) - base
        arg_err = abs(held - memory["argument_bytes"]) / held
        torch.cuda.reset_peak_memory_stats(dev)
        real = CostCounter()
        with real:
            out, first_s = timed(lambda: setup.step_fn(*args))
        peak = torch.cuda.max_memory_allocated(dev) - base
        args = (args[0], out[1], args[2], batch)
        out, step_s = timed(lambda: setup.step_fn(*args))
        loss = float(out[3]["loss"])
    del setup, out, args
    torch.cuda.empty_cache()
    ratio = memory["step_peak_bytes"] / peak
    print(f"dry-run vs card: {LM_ARCH} AdamW step {TRAIN_B} x {TRAIN_T} "
          f"(remat, {est.cfg.dtype}; built and counted on meta in "
          f"{est_s:.2f} s): argument bytes estimated "
          f"{memory['argument_bytes']} against {held} allocated after set-up "
          f"(off by {arg_err:.2e}, bound {ARG_BYTES_REL}); FLOPs on meta "
          f"{counter.flops:.6e}, counted on the card's step {real.flops:.6e}; "
          f"peak estimated {memory['step_peak_bytes'] / 2 ** 30:.3f} GiB "
          f"against {peak / 2 ** 30:.3f} GiB allocated (ratio {ratio:.3f}, "
          f"gate {PEAK_RATIO}); step wall {step_s:.4f} s (first, counted: "
          f"{first_s:.4f} s), roofline bound {roof.bound_s:.4e} s "
          f"({roof.dominant}: compute {roof.compute_s:.4e} s, memory "
          f"{roof.memory_s:.4e} s) = {roof.bound_s / step_s:.4f} of the "
          f"wall; loss {loss:.4f} [{card}]")
    assert math.isfinite(loss), loss
    assert arg_err <= ARG_BYTES_REL, (held, memory["argument_bytes"])
    assert real.flops == counter.flops, (real.flops, counter.flops)
    assert PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1], ratio


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the phases that stand alone (``--phases``): what each needs of no other
ALONE = {
    "4": lambda dev, card, records: records.extend(check_window_attn(dev)),
    "17": family_phase,
    "18": pipeline_phase,
    "19": lambda dev, card, records: pod_phase(dev, card),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", type=lambda v: v.split(","),
                    help=f"run only these phases, of {', '.join(ALONE)}")
    args = ap.parse_args(argv)
    if args.phases and not set(args.phases) <= set(ALONE):
        ap.error(f"--phases: only {', '.join(ALONE)} run alone")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    card = card_line()
    if args.phases:
        records = []
        for phase in args.phases:
            ALONE[phase](dev, card, records)
        print(f"phases {', '.join(args.phases)} passed")
    else:
        report(all_phases(dev, card))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def all_phases(dev, card):
    """Phases 1-19; the kernels' records."""
    records = check_kernels(dev)
    check_ranking(dev)
    res = main_path(dev, records)
    records += check_window_attn(dev)
    lm_model, lm_cuts = lm_path(dev, records)
    records.append(check_ssd_scan(dev, card))
    ssm_path(dev, records, card)
    model, vx, vy, xd, pooled = cnn_setup(dev)
    records.append(check_quant_matmul(dev, card, model, pooled))
    del pooled
    cnn_path(dev, records, card, model, vx, vy, xd,
             [p.cuts for p in res.pareto])
    del model, vx, vy, xd
    online_path(dev, card)
    campaign_path(dev, card, res)
    serve_path(dev, card, lm_model, lm_cuts)
    del lm_model
    train_phase(dev, card)
    launcher_phase(dev, card)
    t0 = time.perf_counter()
    quant_lm_path(dev, card, lm_cuts)
    print(f"phase 15 in {time.perf_counter() - t0:.1f} s [{card}]")
    moe_phase(dev, card)
    family_phase(dev, card, records)
    pipeline_phase(dev, card, records)
    pod_phase(dev, card)
    return records


def report(records):
    """The kernels' lines and their JSON line."""
    for r in records:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        if r.get("int_mm_ms") is not None:
            lib += f" (torch._int_mm, product only: {r['int_mm_ms']:.4f} ms)"
        launches = r.get("launches_in",
                         f"on the main path {r['launches']}")
        f32 = ("" if r.get("bound_f32_ms") is None else
               f"; float32 CUDA-core bound {r['bound_f32_ms']:.4f} ms")
        print(f"{r['name']}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}{f32}), library {lib}, launches {launches}, "
              f"max_abs_err {r['max_abs_err']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_f32_ms",
            "library_ms", "launches_in", "design")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))


if __name__ == "__main__":
    sys.exit(main())
