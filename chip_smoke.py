#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (prdisagg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Phases:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles every CUDA kernel from the sources in prdisagg_torch/csrc,
   one nvcc per source, all started together, and finds wgmma (HGMMA)
   instructions in K1's SASS and 16-byte loads and stores (LDG.E.128,
   STG.E.128) in K2's;
3. kernel check (K1): the upsample-conv kernel against its plain PyTorch
   version at the flagship generator's three stage shapes (batch 1000) and
   at the 64x64 domain's last stage (batch 8), in float32 and bfloat16, at
   the training shapes (batch 160 and 32, both dtypes), and at the 64x64
   generator's three stages (large_k1_cases) and at the spatial and fused
   paths' shapes (spatial_k1_cases), with its time beside the
   plain version's, one cuDNN convolution of the upsampled input (timed
   only) and the card's bound for the same work; every shape must take the
   main path's kernel (bf16 on wgmma, f32 on the halo forward's 3xTF32
   wgmma); at batch 32,
   at a gloo rank's 16, at the 64x64 f32 step's 4, at the spatial
   step's 2, and at the fused steps' 192 and 24 also its backward
   kernels (bf16: dx and dkernel on halo boxes, splits summed in a
   cluster, the fold with the bias sums; f32: the same on 3xTF32 wgmma
   after the weight pack, whose kernel is held against its plain version
   bit for bit), held against autograd through the plain
   version and a second call bit for bit, timed beside the plain backward
   (the phase convolutions' cuDNN gradients), autograd through the cuDNN
   convolution and the bound (f32: the exact-FMA and the 3xTF32 bounds,
   held to the smaller), with the bias gradient's share of the
   kernels' time and the autograd node's device time;
   then K1's backward node split by kernel and stage at the 16x16, 64x64
   and fused steps' shapes in bf16 and the 16x16 and 64x64 f32 steps'
   (profiled, in a process of its own; [k1_split] lines; alone with
   --k1-backward-split); then the fused pixel-norm and leaky ReLU kernel
   against the plain chain at the flagship stages' outputs (B 1000) and
   the 64x64 last stage's (B 512), with its time, the plain chain's and
   the bound ([kernel] lines; alone with --pixel-norm);
4. dataset: a synthetic radar tensor of 448 days x 24 h x 256 x 256 (2.8 GB
   of float32, a multi-year store) made on the card from --seed with the
   synthetic-data recipe, and its valid patch indices;
5. gather check (K2): the patch-gather kernel against its plain version,
   bit for bit, at one train step's real gathers (160 patches), a bulk draw
   (5000), the generator update's conditions from the daily sums
   (32 patches, nh = 1), 160 patches of the 64x64 domain from the same
   tensor and a step's two gathers on one rank of a world of 2 (80 and
   16), with each call's device time, its time with the Python launch
   included, and its host cost;
6. slice: a flagship float32 PretrainedGenerator built from seeded random
   weights, written to .npz and loaded back, generates 1000 scenarios; the
   kernel's launch count (3, all of the fast variant), shapes, finiteness
   and conservation of the daily sum are checked, as are the pixel-norm
   kernel's 3 launches; the result is held
   against the CPU path on a few samples, and scenarios/s and peak memory
   per scenario are measured;
7. serve: a ScenarioServer answers ping, info, a b64 map request, a stack
   request, reload, stats and shutdown;
8. train: Trainer.fit at the flagship defaults (bf16, batch 32, n_disc 5)
   on the card-resident dataset, the step a CUDA graph: one epoch with the
   warm-up and capture, then 2 calls of 50 replays timed; checks finite
   metrics, changed parameters, the kernel counts (6 K1 launches, all fast,
   3 K1 backward passes with their halo dx, dk and fold kernels, and 2 K2
   launches per step, through the wrappers
   at warm-up and capture and per replay after), the checkpoint and
   exports; then EAGER_STEPS eager steps (draw_step_inputs +
   train_step_on) for the eager rate, the graphed step's peak memory (it
   must not copy the data), conservation of the trained generator, a
   profile of one call of 10 replays (device busy and idle share, and the
   hand-written kernels, K1's backward ones too, counted by name inside the
   graph), profiles of one eager step with K1's backward kernels and with
   the plain backward in their place (K1's backward device time, the
   elementwise and layout kernels' counts; no cuDNN gradient inside K1's
   backward node with the kernels) and one float32 step on the card
   against the same step on the CPU path; then the same Trainer.fit in
   float32 as `cli train --f32-parity` builds it (graphed, 2 calls of 50
   replays timed, the kernels counted through the wrappers and by name in
   a profiled call of 10 replays, K1's backward share of busy time, the
   idle share and conservation; [f32_train] lines; alone with --f32-step);
9. graph check: float32, smoke width, dropout on, from mid-training Adam
   moments: the graphed step against eager steps from the same state and
   generator state, draws bit for bit, losses and parameters within 1e-4
   of their scale (and the parameter that moved most), and successive
   replays drawing different rows and latents;
10. resume check: flagship bf16, 2 epochs with a checkpoint each, resumed
   by a new Trainer to epoch 3, against an uninterrupted 3-epoch run
   (parameters within 1e-4 of their scale, the same hist.csv epochs);
11. cli: ``python -m prdisagg_torch.cli train --synthetic`` at the flagship
   width for 2 epochs, then ``--resume`` to a third, as subprocesses;
12. eval: the slice phase's flagship float32 generator scored on the
   card-resident dataset at the reference protocol's sizes, plots off:
   crps_gan (50 samples x 1000 members, K1 launches counted), the random
   baseline against a 5000-patch ensemble drawn by K2, Evaluator phases 2
   (1000 samples) and 5 (2 pairs x 1000 members) with conservation of
   every generated field and the daily-cycle correlation, the n = 1000
   pairwise-LSD summary (24,000 spectra; seconds and peak memory); then
   CRPS and LSD against float64 on the CPU with TF32 allowed globally (and
   the TF32 value beside), the device median against the full reduction's
   at n = 20, and ``cli evaluate --smoke --no-plots`` and ``cli crps`` as
   subprocesses;
13. rainfarm: RainFARM on the card-resident dataset: calibrate at
   RainFarmConfig's defaults (10 repeats of 5000 patches drawn by K2),
   1000 real test patches drawn by K2 scored by crps_rainfarm at 1000
   members (cut from the protocol's 10,000 samples; samples/s, peak
   memory), generate_for_daily_sums of their 1000 daily sums
   (conservation), the three-arm CRPS protocol (GAN, random, RainFARM) on
   50 of them, a profile of crps_rainfarm on 20 samples, then the
   estimators on the CPU against the card (float64,
   1e-8 relative) and the downscaling on the card against the CPU on
   identical phases (1e-5 of the maximum);
14. serve_cli: ``cli inspect``, ``cli generate`` (one condition, a stack
   of 8, the float16 wire; 1000 scenarios each), ``cli serve`` answering a
   client and a second one stopped by SIGTERM, ``cli rainfarm-calibrate``
   then ``rainfarm-crps``, and ``example`` / ``rainfarm-generate``, which
   must refuse to start, naming matplotlib, where it is not installed; all
   as subprocesses started together;
15. dp: data parallelism, its worker processes started by this script with
   the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
   MASTER_PORT; a free localhost port).  One card, so NCCL runs at world
   1 and world 2 runs over gloo, both ranks on the card.  NCCL world 1,
   alone: Trainer.fit at the flagship defaults on its own 2.8 GB tensor,
   the step a CUDA graph with its n_disc + 1 all-reduces inside (graphed
   steps/s beside the same run without the mesh, in the order mesh,
   alone, alone, mesh in that process, and the train phase's; NCCL
   kernels counted by name and timed in a profiled call of 10 replays;
   the idle share), and its parameters against a non-data-parallel run
   from the same seed (deterministic cuDNN, 1e-4 of max|p|).  Then together: gloo world 2 (one flagship float32 eager step
   from mid-training Adam moments against the single-process step on the
   same global draws, the ranks bit-identical; crps_gan of 10 samples x
   1000 members against the single-device rows; generate_scenarios(cond,
   1000) against the single-device output, and conservation), and
   ``cli train --synthetic``, ``cli crps --dp 1`` and ``cli serve --dp 1``
   (a map and a stack request, against one device's generator) under a
   launched world of 1.  Each worker reports its K1 and K2 launches;
   gloo's rates are printed and compared with nothing.  ``python3
   chip_smoke.py --dp-worker nccl|gloo`` is that worker, for this script's
   own use;
16. data: the data pipeline at the per-day size of a real day, 4 days of
   288 five-minute frames of the dataset's 256 x 256 grid, dated across a
   leap day: raw SMHI bytes made on the card from --seed (255 missing, dBZ
   = x * 0.4 - 30, drifting rain blobs, a missing border); TIFFs through
   ``cli convert-tiffs`` where Pillow is installed, otherwise ``cli
   convert-tiffs`` must refuse, naming rasterio and Pillow, and
   convert_and_write_days writes the .nc files; ``cli reformat-nc`` (the
   tensor bit for bit convert_day's of the raw days, the doy sidecar the
   dates' days); ``cli compute-indices`` on the card (the rows
   compute_valid_indices' on the CPU); extract_patch_store on the
   tensor's memmap through K2 (bit-exact against the plain gather and
   against numpy slices of the memmap, one launch a day with rows; days/s
   and rows/s); the streamed scan at two chunk sizes (the same rows);
   ``cli train --conditioning doy`` on the files at the flagship defaults
   (bf16, B 32, graphed), 2 epochs, and the trained generator's 8 x 125
   scenarios in one f32 forward at B 1000, a K1 shape held above, with
   their conservation; ``[data]`` lines with each stage's seconds and
   MB/s;
17. ops: ``cli doctor`` (rc 0, the probe's latency), ``cli doctor
   --timeout`` shorter than a torch import (rc 1, detail "timeout"), and
   ``cli supervise`` around ``cli train --synthetic --resume`` continuing
   the cli phase's run: after its first heartbeat the training child
   (found by its workdir in /proc/*/cmdline) is SIGSTOPped; the supervisor
   must kill its group, probe the card, relaunch, and the relaunch resume
   and finish (rc 0, restarts=1 stalls=1, every epoch once in hist.csv);
18. protocols: every prdisagg_torch.protocols driver as a subprocess on
   the card at flagship width, cut in depth (large_domain, variants,
   paper with --mini's battery, then paper again in its workdir, every
   stage from its cache with the same verdict, and paper_finish,
   l1_rehearsal), each exiting 0;
19. variants: the 64x64 large domain trained graphed on the dataset's
   tensor (kernel counts by name in the replays, busy ms and K1's share of
   a step, idle share, peak bytes, conservation, an f32 step with K1's
   kernels against K1's plain route on the card), 64x64 f32
   generate_scenarios at the default max_batch (peak within half the
   card), and lon trained graphed with its .npz export's forward against
   the live generator's.

20. fused: fused_gen_forward (one (n_disc + 1) B generator forward, its
   gradient run after the critic updates) beside the default step, both
   CUDA graphs in one process at the flagship defaults: steps/s over
   calls of 50 replays in the order default, fused, fused, default, the
   fused replay's kernels through the wrappers (3 K1 forward launches, K1's
   backward at B 192), and one f32 step of each from the same state and
   draws (metrics within 2e-4, parameters within 1e-4 of max|p|);
21. spatial: the conv activations' y rows split over a mesh axis, through
   4 gloo workers on the one card started by this script: the 64x64
   (large_domain_experiment) generator's and critic's forward at B 32, y
   split 4 ways and 2 ways (the spatial axis of a 2 x 2 data x spatial
   grid), in f32 (within 1e-5 of max) and bf16 (K1's bf16 limits) against
   the same forward without a mesh; the f32 step on the grid (B 4, n_disc
   2, mid-training Adam moments) against the single-process step on the
   same global draws (losses within 1e-4 of their scale, parameters of
   max|p|, every gradient that reaches an update within 1e-2 of its
   parameter's largest), and the same step with a fault planted (the
   latent projection's gradient summed over the spatial axis), which the
   gradient check must catch; the seconds of a forward and a step, the
   halo exchanges' share of them, each rank's peak bytes beside one
   device's, and the graphed step's refusal of gloo.  ``python3 chip_smoke.py --spatial-worker`` is
   that worker, for this script's own use.

The phases that only check subprocesses (cli, eval_cli, serve_cli and the
protocol drivers) run together, each printing its own seconds; every phase
that times the card or the host (data and ops among them) runs alone.
Prints a {"kernels": [...]} line
and, last, a device line.  Exits non-zero, printing no result, if any
phase fails or no CUDA device is present.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import os
import pickle
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_F32_FLOPS = 67e12      # float32 FMA, outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 tensor cores (3xTF32 is f32-accurate)
PEAK_BF16_FLOPS = 989e12    # bf16 tensor cores
PEAK_BYTES = 3.35e12        # HBM3

STAGES = [  # (name, batch, D, H, W, Cin, Cout)
    ("stage0", 1000, 3, 2, 2, 256, 256),
    ("stage1", 1000, 6, 4, 4, 256, 128),
    ("stage2", 1000, 12, 8, 8, 128, 64),
    ("stage2_64x64", 8, 12, 32, 32, 128, 64),
]
MAIN_PATH_STAGES = ("stage0", "stage1", "stage2")
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}  # rtol, atol/max
SCENARIOS = 1000
CONSERVATION_RTOL = 1e-5  # |sum_h scenarios - cond| <= this * max(cond)

TRAIN_BATCH = 32
N_DISC = 5
# K1 at the training shapes: the held-over fake forward (n_disc * batch) and
# the generator update (batch), bf16
TRAIN_STAGES = [(f"{name}_b{b}", b, d, h, w, cin, cout)
                for b in (N_DISC * TRAIN_BATCH, TRAIN_BATCH)
                for name, _, d, h, w, cin, cout in STAGES[:3]]
DATASET_SHAPE = (448, 24, 256, 256)  # days, hours, ny, nx: 2.8 GB float32
ND_LARGE = 64  # the 64x64 domain's patch, gathered from the same tensor
# the 64x64 large domain's generator stages (name, D, H, W, Cin, Cout)
LARGE_STAGES = [("ld_stage0", 3, 8, 8, 256, 256),
                ("ld_stage1", 6, 16, 16, 256, 128),
                ("ld_stage2", 12, 32, 32, 128, 64)]
# its graphed Trainer.fit at the training cell's defaults (bf16, B 32, n_disc
# 5): a warm-up epoch, then timed epochs of one call of replays each
LARGE_WARM_EPOCHS, LARGE_TIMED_EPOCHS, LARGE_STEPS = 1, 2, 10
# its profiled call: 3 replays (about 10,000 device events; CUPTI dropped
# some of the 32,000 of 10 replays once)
LARGE_PROFILE_REPLAYS = 3
# its float32 step: K1's kernels against K1's plain route on the card
LARGE_F32_CHECK = dict(n_disc=2, batch=4, rtol=1e-4)
# The f32 latent projection (taken in float64 above 1,024 inputs) and head
# (models/generator.py), timed at the 64x64 serving batch and the 64x64
# f32 step's, the head at 16x16 and 64x64 serving's; each held to the CPU
# tests' bound on its distance from a float64 product of the same operands
# (tests/test_torch_precision.py PROJ_BOUND, HEAD_BOUND), the head on
# HEAD_F64_BATCH samples.
PROJ_BATCHES = (("serving", 512), ("step", 4))
HEAD_SHAPES = (("16x16_serving", 1000, 16), ("64x64_serving", 512, 64))
PROJ_F64_BOUND, HEAD_F64_BOUND = 1e-7, 3e-7
HEAD_F64_BATCH = 8
# sample_statistics' chunk, the large-domain protocol's 64x64 f32 forward
EVAL_CHUNK = 500
# the lon variant's graphed Trainer.fit at the flagship 16x16
LON_EPOCHS, LON_STEPS = 2, 20
# a K1 shape with at least this many FLOPs is timed over fewer calls
HEAVY_FLOPS = 1e12
# the protocols phase: the large-domain and variants drivers' days, the
# paper protocol's (days, held-out days, epochs) at --mini's battery, and
# each driver's time limit
PROTOCOL_DAYS = 8
PAPER_RUN = (16, 16, 2)
PROTOCOL_LIMIT_S = 600
# Trainer.fit: one epoch with the warm-up and capture, then 2 x 50 graphed
# steps timed, one call of 50 replays an epoch
WARM_EPOCHS, TIMED_EPOCHS, STEPS_PER_EPOCH = 1, 2, 50
PROFILE_REPLAYS = 10  # the profiled call of the graphed step
DEVICE_TRACE_TRIES = 3  # device_ms: traces taken before an empty one fails
EAGER_STEPS = 50  # timed eager steps, for the eager rate
GRAPH_CHECK_STEPS = 4  # graphed vs eager steps
RESUME_STEPS = 4  # steps per epoch of the resume check
CLI_STEPS = 4  # steps per epoch of the CLI runs
CARD = "cuda"  # where the dataset and the train phase live
F32_CHECK = dict(n_disc=2, batch=8, rtol=1e-4)
# evaluation at the reference protocol's sizes: 1000-member ensembles in
# batches of 500, a 5000-patch random baseline, n = 1000 LSD populations
# (24,000 spectra each) and phase 5's 2 pairs x 1000 members
EVAL_SAMPLES, EVAL_MEMBERS, EVAL_MEMBER_BATCH = 50, 1000, 500
EVAL_BASELINE = 5000
EVAL_N = 1000  # Evaluator phase-2 samples, and the LSD populations' n
EVAL_KS_PAIRS, EVAL_KS_MEMBERS = 2, 1000
CRPS_F64 = dict(samples=4, rtol=1e-5)  # card vs float64, relative
LSD_F64 = dict(spectra=256, rtol=2e-5)  # card vs float64, of the largest
MEDIAN_CHECK = dict(n=20, rtol=2e-5)  # device vs full reduction
CLI_CRPS = dict(samples=10, baseline=1000)
# RainFARM: calibration at RainFarmConfig's defaults (10 repeats of 5000
# patches), the CRPS protocol's 1000 members on 1000 samples (cut from
# 10,000), the three-arm protocol on EVAL_SAMPLES samples
RAINFARM_SAMPLES, RAINFARM_MEMBERS = 1000, 1000
RAINFARM_PROFILED = 20  # samples in the profiled crps_rainfarm call
RAINFARM_CHECK = dict(members=8, ds_factor=4, rtol=1e-5, slope_rtol=1e-8)
# the serving CLI: --n-scenarios for generate; the stack's conditions and
# its per-forward cap (4 forwards of 2000); f16 wire conservation
CLI_SCENARIOS, CLI_STACK, CLI_STACK_MAX_BATCH = 1000, 8, 2000
WIRE_F16_RTOL = 1e-3
# kernel launches of one flagship train step, through the wrappers: K1's
# forward, its backward passes and K2 (K1's backward kernels by
# train_per_step())
TRAIN_PER_STEP = {"upsample2_conv3": 6, "upsample2_conv3_backward": 3,
                  "gather_patches": 2}
# data parallelism: gloo's world on the one card; the crps_gan check's
# samples (at EVAL_MEMBERS members); the gloo step's dataset (days, ny, nx)
DP_GLOO_WORLD = 2
DP_CRPS_SAMPLES = 10
DP_GLOO_DATASET = (32, 128, 128)
DP_TOL = 1e-4  # losses of their scale, parameters of max|p|
# K1 at the data-parallel shapes: a gloo rank's shards of the step (f32,
# and bf16 as NCCL at world 2 would run them), and crps_gan's and
# generate_scenarios' member batch on each rank (f32)
DP_STAGES = [(f"{name}_b{b}", b, d, h, w, cin, cout)
             for b in (N_DISC * TRAIN_BATCH // DP_GLOO_WORLD,
                       TRAIN_BATCH // DP_GLOO_WORLD)
             for name, _, d, h, w, cin, cout in STAGES[:3]]
DP_SCORE_STAGES = [(f"{name}_b{EVAL_MEMBER_BATCH}", EVAL_MEMBER_BATCH, d, h, w,
                    cin, cout) for name, _, d, h, w, cin, cout in STAGES[:3]]
# the data phase: DATA_DAYS real-size days (288 five-minute frames of the
# dataset's grid) from DATA_FIRST_DAY, across a leap day; the streamed
# scan at two chunk sizes; cli train's steps per epoch (2 epochs); the
# trained generator's conditions and scenarios for its conservation check,
# one f32 forward at B = SCENARIOS, a shape K1_CASES holds (stage0-2)
DATA_DAYS, DATA_FIRST_DAY = 4, "2012-02-27"
DATA_SCAN_CHUNKS = (1, DATA_DAYS)
DATA_TRAIN_STEPS = 4
DATA_CONDS, DATA_SCENARIOS = 8, 125
# the ops phase: the supervised run resumes the cli phase's run (3 epochs)
# to OPS_EPOCHS; its stall timeout, the supervisor's own limit, and a doctor
# timeout shorter than a torch import
OPS_EPOCHS, OPS_STALL_S, OPS_TIMEOUT_S = 6, 10, 240
OPS_SHORT_TIMEOUT = 0.3
# the fused generator forward (phase 20): replays in a timed call of each
# graphed step; the fused f32 step's metrics within JAX's rtol
# (tests/test_train_step.py), losses of their scale
FUSED_STEPS = 50
FUSED_RTOL = 2e-4
# spatial sharding (phase 21): one gloo world of SPATIAL_WORLD ranks on the
# card (y split 4 ways, and 2 ways on a (data 2, spatial 2) grid), the
# 64x64 forward's batch, timed calls, the step's dataset (days, ny, nx) and
# the workers' time limit
SPATIAL_WORLD = 4
SPATIAL_BATCH = 32
SPATIAL_REPS = 3
SPATIAL_DATASET = (8, 128, 128)
SPATIAL_LIMIT_S = 420
# the grid step's gradients against one device's, each parameter's of its
# largest (_grad_err): a gradient counted twice reads about 1, the clean
# step up to 7.4e-4 on the card (the critic's conv1 bias in its second
# update, alike on every rank and run)
SPATIAL_GRAD_TOL = 1e-2
# K1's backward split by kernel and stage (phase_k1_backward_split): the
# generator update's three stages, bf16, in the 16x16 step (B 32), the 64x64
# step (B 32) and the fused step (B (n_disc + 1) * 32); in f32 the 16x16
# step (B 32, what cli train --f32-parity runs) and the 64x64 f32 step check's
# (B 4); calls a stage, each after a synchronise and a host pause that leaves
# a gap on the card
SPLIT_STEPS = (("16x16", TRAIN_BATCH, [s[2:] for s in STAGES[:3]], "bfloat16"),
               ("64x64", TRAIN_BATCH, [s[1:] for s in LARGE_STAGES],
                "bfloat16"),
               ("fused", (N_DISC + 1) * TRAIN_BATCH,
                [s[2:] for s in STAGES[:3]], "bfloat16"),
               ("16x16_f32", TRAIN_BATCH, [s[2:] for s in STAGES[:3]],
                "float32"),
               ("64x64_f32", LARGE_F32_CHECK["batch"],
                [s[1:] for s in LARGE_STAGES], "float32"))
SPLIT_REPS, SPLIT_GAP_S = 5, 0.003
# _launches: the pause after each traced call, which parts the calls' events
LAUNCH_GAP_S = 0.05
K1_CASES = ([(s, ("float32", "bfloat16")) for s in STAGES]
            + [(s, ("float32", "bfloat16")) for s in TRAIN_STAGES]
            + [(s, ("float32", "bfloat16")) for s in DP_STAGES]
            + [(s, ("float32",)) for s in DP_SCORE_STAGES])


def large_k1_cases() -> list:
    """K1_CASES' counterpart at the 64x64 generator's stages: bf16 at the
    step's n_disc * B and B (the backward at B), f32 at serving's default
    max_batch, at sample_statistics' chunk, and at the f32 step check's
    n_disc * B and B (the backward at B)."""
    from prdisagg_torch.api.pretrained import default_max_batch

    f32_b = LARGE_F32_CHECK["batch"]
    per_dtype = {"bfloat16": (N_DISC * TRAIN_BATCH, TRAIN_BATCH),
                 "float32": (default_max_batch(ND_LARGE), EVAL_CHUNK,
                             LARGE_F32_CHECK["n_disc"] * f32_b, f32_b)}
    return [((f"{name}_b{b}", b, d, h, w, cin, cout), (dtype,))
            for name, d, h, w, cin, cout in LARGE_STAGES
            for dtype, batches in per_dtype.items() for b in batches]


def spatial_k1_cases() -> list:
    """K1 at the spatial and fused paths' new shapes: the 64x64 generator's
    stage inputs on one rank's rows with a halo row each side (y 8/P + 2,
    16/P + 2, 32/P + 2 at P 2 and 4) in f32 and bf16 at the forward's
    batch; at P 2 the f32 step's held-over and generator-update batches on
    one data rank (of 2); the fused step's (n_disc + 1) B at 16x16, bf16,
    and the f32 fused check's.  phase_kernel_check runs the backward at
    SPATIAL_BATCH, the data rank's update batch and both fused batches."""
    c = LARGE_F32_CHECK
    local = c["batch"] // 2
    cases = [((f"sp{p}_{name}_b{SPATIAL_BATCH}", SPATIAL_BATCH, d, h // p + 2,
               w, cin, cout), ("float32", "bfloat16"))
             for p in (2, 4) for name, d, h, w, cin, cout in LARGE_STAGES]
    cases += [((f"sp2_{name}_b{b}", b, d, h // 2 + 2, w, cin, cout),
               ("float32",))
              for b in (c["n_disc"] * local, local)
              for name, d, h, w, cin, cout in LARGE_STAGES]
    for b, dtype in (((N_DISC + 1) * TRAIN_BATCH, "bfloat16"),
                     ((F32_CHECK["n_disc"] + 1) * F32_CHECK["batch"],
                      "float32")):
        cases += [((f"fused_{name}_b{b}", b, d, h, w, cin, cout), (dtype,))
                  for name, _, d, h, w, cin, cout in STAGES[:3]]
    return cases


def train_per_step(dtype: str = "bfloat16", batch: int = TRAIN_BATCH,
                   stages=None) -> dict:
    """The wrappers' counts of one flagship train step whose generator
    update runs at `batch` in `dtype`: TRAIN_PER_STEP, and K1's backward
    kernels at each stage as k1_backward_plan picks them
    (:func:`_backward_expected`).  `stages` are the
    generator's (name, D, H, W, Cin, Cout), the 16x16 ones by default."""
    import torch

    from prdisagg_torch.ops import upsample_conv

    per = dict(TRAIN_PER_STEP)
    per.update({f"upsample2_conv3_backward_{k}": 0
                for k in upsample_conv.BACKWARD_KERNELS})
    if stages is None:
        stages = [s[:1] + s[2:] for s in STAGES[:3]]
    # the held-over n_disc*B forward and the generator update's B
    per.update({f"upsample2_conv3_{v}": n for v, n in k1_forward_expected(
        dtype, (N_DISC * batch, batch), stages).items()})
    for _, d, h, w, cin, cout in stages:
        plan = upsample_conv.k1_backward_plan(getattr(torch, dtype), batch, d,
                                              h, w, cin, cout)
        for k in _backward_expected(plan):
            per[f"upsample2_conv3_backward_{k}"] += 1
    # one pixel-norm pass a stage's forward, the update's under grad too
    per["pixel_norm_leaky"] = per["upsample2_conv3"]
    return per


def _backward_expected(plan) -> dict:
    """The kernels one K1 backward launches under `plan`: dx, dk and dk's
    fold, the f32 halo dx's weight pack, and dx's reduce where an FMA dx
    reduction is split (the halo kernels sum their splits in a cluster)."""
    want = {f"dx_{plan.variant}": 1, f"dk_{plan.variant}": 1, "dk_fold": 1,
            "pack_tf32": int(plan.variant == "halo_f32"),
            "dx_reduce": int(not plan.variant.startswith("halo")
                             and plan.dx.splits > 1)}
    return {n: c for n, c in want.items() if c}


def backward_workspace_bytes(plan, b, d, h, w, cin, cout) -> int:
    """The f32 bytes one K1 backward under `plan` writes to device memory
    beside its outputs: the halo kernels' summed phase-tap tiles and
    phases' bias sums, or the FMA kernels' split partials (dx's when split,
    dk's always)."""
    if plan.variant != "general":
        return 4 * (64 * cin * cout + 8 * cout)
    dx = plan.dx.splits * b * d * h * w * cin if plan.dx.splits > 1 else 0
    return 4 * (dx + plan.dk.splits * 64 * cin * cout)


def check(ok: bool, what) -> None:
    """An assertion that also holds under python -O."""
    if not ok:
        raise AssertionError(what)


def reset_k1_counts() -> None:
    """Zero K1's launch counters, in total and by kernel variant, and the
    pixel-norm pass's (one a K1 forward: each stage's output)."""
    from prdisagg_torch.ops import core, upsample_conv

    core.pixel_norm_launches = 0
    upsample_conv.launches = upsample_conv.backward_calls = 0
    upsample_conv.launches_by_variant = dict.fromkeys(
        upsample_conv.VARIANTS, 0)
    upsample_conv.backward_launches_by_variant = dict.fromkeys(
        upsample_conv.BACKWARD_KERNELS, 0)


def fast_only(n: int) -> dict:
    """K1's launches by variant when the main path made n, all fast (bf16:
    wgmma)."""
    return {"fast": n, "general": 0, "halo_f32": 0}


def main_only(by_variant: dict, n: int) -> bool:
    """Whether K1's launches by variant are n on the main path's kernels
    (fast or halo_f32), none general."""
    return by_variant["general"] == 0 and sum(by_variant.values()) == n


def k1_forward_expected(dtype: str, batches, stages=None) -> dict:
    """K1's launches by variant of one generator forward at each of
    `batches`, as k1_plan picks them; `stages` (name, D, H, W, Cin, Cout),
    the 16x16 ones by default."""
    import torch

    from prdisagg_torch.ops import upsample_conv

    if stages is None:
        stages = [s[:1] + s[2:] for s in STAGES[:3]]
    want = dict.fromkeys(upsample_conv.VARIANTS, 0)
    for b in batches:
        for _, d, h, w, cin, cout in stages:
            want[upsample_conv.k1_plan(getattr(torch, dtype), b, d, h, w,
                                       cin, cout).variant] += 1
    return want


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of fn() over `reps` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, reps: int = 200) -> float:
    """Mean host microseconds per call of fn over `reps` calls enqueued
    back to back with no synchronisation: what each call costs the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over `reps` calls queued
    behind a spin kernel: the host enqueues every call while the card
    spins, so the CUDA events around the calls see device time only, not
    the Python launches (which take longer than a small kernel).  The spin
    doubles until it outlasts the host's enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin_cycles = 10_000_000  # about 5 ms at the H100's 1.98 GHz boost
    for _ in range(8):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(spin_cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        marks[2].record()
        marks[2].synchronize()
        if host_ms < 0.8 * marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / reps
        spin_cycles *= 2
    raise AssertionError("the host could not queue the calls ahead of the "
                         "card")


def phase_device() -> str:
    """Prints and returns the card's name and power limit, as nvidia-smi
    gives them."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from prdisagg_torch import _build

    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernel source(s) built in "
          f"{secs:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # the bf16 K1 kernels must run on the tensor cores (wgmma is HGMMA in
    # SASS); K2's copy and the pixel-norm pass on 16-byte loads and stores
    wants = {"upsample_conv": ("HGMMA",), "gather": ("LDG.E.128", "STG.E.128"),
             "pixel_norm": ("LDG.E.128", "STG.E.128")}
    for name, ops in wants.items():
        sass = _sass(name)
        for op in ops:
            found = [ln for ln in sass if op in ln]
            print(f"[build] {name} SASS: {len(found)} {op} instructions, "
                  f"e.g. {found[:1]}")
            check(found, f"no {op} instruction in the {name} library")


def _sass(name: str) -> list:
    """The instructions of one built kernel library, from cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    from prdisagg_torch import _build

    out = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         str(_build._library_path(name))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    return [ln.split(";")[0].split("*/")[-1].strip()
            for ln in out.splitlines() if ";" in ln]


def _bound(flops: float, nbytes: float, dtype: str, prefix: str = "") -> dict:
    """The least time the card could take for `flops` operations on
    `nbytes` bytes: the larger of FLOPs over the type's peak and bytes over
    HBM's rate, and which bounds it.  f32 work has two routes: exact FMA
    (PEAK_F32_FLOPS) and 3xTF32 on the tensor cores (3 TF32 products a
    product, PEAK_TF32_FLOPS); its rows carry both (bound_fma_ms,
    bound_tf32x3_ms) and are held to the smaller."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    if dtype != "float32" or not flops:
        ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
        return {f"{prefix}bound_ms": max(ops_ms, bytes_ms),
                f"{prefix}bound_by": "operations" if ops_ms >= bytes_ms
                else "bytes"}
    fma_ms = 1e3 * flops / PEAK_F32_FLOPS
    tf32_ms = 3e3 * flops / PEAK_TF32_FLOPS
    ops_ms = min(fma_ms, tf32_ms)
    return {f"{prefix}bound_ms": max(ops_ms, bytes_ms),
            f"{prefix}bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes",
            f"{prefix}bound_fma_ms": max(fma_ms, bytes_ms),
            f"{prefix}bound_tf32x3_ms": max(tf32_ms, bytes_ms)}


def _kernel_row(name, dtype, shape, flops, nbytes, **kw) -> dict:
    """A [kernel] line's fields, with the card's bound for the work
    (:func:`_bound`), and the kernel's share of that bound and its ratio to
    the library call."""
    bound = _bound(flops, nbytes, dtype)
    return dict(stage=name, dtype=dtype, shape=shape, **kw, **bound,
                bound_share=bound["bound_ms"] / kw["ms"],
                library_ratio=kw["ms"] / kw["library_ms"])


def _plain_backward_ms(fn, dtype) -> dict:
    """The plain backward's device time by :func:`queued_ms`; in float32,
    where cuDNN makes the host wait inside a call so that the calls cannot
    be queued (at every float32 shape measured on an H100), and wherever
    queueing fails, the median of CUDA-event-timed calls instead, and
    which of the two it is."""
    import torch

    if dtype != torch.float32:
        try:
            return {"backward_plain_ms": queued_ms(fn, 10),
                    "backward_plain_timer": "queued"}
        except AssertionError:
            pass
    return {"backward_plain_ms": cuda_ms(fn, 10),
            "backward_plain_timer": "events"}


def _k1_backward(x, k, bias, g, flops: float, tol: tuple) -> dict:
    """K1's backward kernels (through the autograd.Function) against
    autograd through the plain version (rtol, atol of the maximum in
    `tol`), a second call bit for bit, and the kernels k1_backward_plan
    names; device times (:func:`queued_ms`) of the kernels
    (upsample2_conv3_backward_cuda on the forward's packed weights, as the
    main path calls it, and ``call_ms`` with CUDA events around one call),
    of the plain backward (the phase convolutions' cuDNN
    gradients, upsample2_conv3_backward) and of autograd through one cuDNN
    conv of the upsampled input (the library), beside the bound
    (:func:`_bound`): 2x the forward's FLOPs (dx and dkernel) or the bytes
    of x, g, dx, the kernel and its gradient, whichever is larger.  In f32
    also the weight pack's kernel against its plain version, bit for
    bit."""
    import torch
    import torch.nn.functional as F

    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.ops.core import upsample3d_nearest
    from prdisagg_torch.ops.upsample_conv import (
        k1_backward_plan,
        pack_phase_kernels,
        upsample2_conv3,
        upsample2_conv3_backward,
        upsample2_conv3_backward_cuda,
        upsample2_conv3_reference,
    )

    leaves = [t.detach().requires_grad_(True) for t in (x, k, bias)]
    before = dict(upsample_conv.backward_launches_by_variant)
    got = torch.autograd.grad(upsample2_conv3(*leaves), leaves, g)
    ran = {n: c - before[n] for n, c in
           upsample_conv.backward_launches_by_variant.items()
           if c != before[n]}
    again = torch.autograd.grad(upsample2_conv3(*leaves), leaves, g)
    want = torch.autograd.grad(upsample2_conv3_reference(*leaves), leaves, g)
    torch.cuda.synchronize()
    plan = k1_backward_plan(x.dtype, *x.shape, k.shape[-1])
    expect = _backward_expected(plan)
    rtol, atol = tol
    within = all(bool(((a.float() - c.float()).abs()
                       <= atol * c.float().abs().max()
                       + rtol * c.float().abs()).all().item())
                 for a, c in zip(got, want))
    lx, lk, lb = (t.detach().requires_grad_(True) for t in (x, k, bias))
    lib_leaves = [lx, lk, lb]
    xu = upsample3d_nearest(lx, 2).permute(0, 4, 1, 2, 3)
    lib_out = F.conv3d(xu, lk.permute(4, 3, 0, 1, 2).to(x.dtype),
                       lb.to(x.dtype), padding=1)
    lib_g = g.permute(0, 4, 1, 2, 3)
    nbytes = (x.element_size() * (2 * x.numel() + g.numel())
              + 2 * 4 * k.numel())
    # as the main path calls them: on the forward's packed weights, with
    # the bias gradient; and without it, and the whole autograd node
    kp = pack_phase_kernels(k, x.dtype)
    pack = {}
    if x.dtype == torch.float32:
        pack = {"backward_pack_bit_exact": torch.equal(
            upsample_conv.pack_tf32_cuda(kp),
            upsample_conv.pack_backward_kernels_tf32(kp))}
    kernels = lambda: upsample2_conv3_backward_cuda(  # noqa: E731
        x, k, g, kp=kp, need_db=True)
    kernels_ms = queued_ms(kernels, 10)
    no_db_ms = queued_ms(
        lambda: upsample2_conv3_backward_cuda(x, k, g, kp=kp), 10)
    node_leaves = [t.detach().requires_grad_(True) for t in (x, k, bias)]
    node_out = upsample2_conv3(*node_leaves)
    node_ms = queued_ms(lambda: torch.autograd.grad(
        node_out, node_leaves, g, retain_graph=True), 10)
    return dict(
        backward_ok=within and ran == expect and all(
            torch.equal(a, b) for a, b in zip(got, again))
        and all(pack.values()), **pack,
        backward_within_tol=within,
        backward_bit_identical=all(torch.equal(a, b)
                                   for a, b in zip(got, again)),
        backward_kernels=ran, backward_expected_kernels=expect,
        backward_plan={"variant": plan.variant, "dx": plan.dx._asdict(),
                       "dk": plan.dk._asdict()},
        backward_max_abs_err=max((a.float() - c.float()).abs().max().item()
                                 for a, c in zip(got, want)),
        backward_max_err_over_max=max(
            ((a.float() - c.float()).abs().max()
             / c.float().abs().max()).item() for a, c in zip(got, want)),
        backward_ms=kernels_ms,
        backward_call_ms=cuda_ms(kernels, 10),
        # what the bias gradient adds to the kernels, and the node's
        # device time beside the kernels' (the autograd node's casts,
        # copies and reductions)
        backward_db_ms=kernels_ms - no_db_ms,
        backward_node_ms=node_ms,
        backward_nonkernel_ms=node_ms - kernels_ms,
        **_plain_backward_ms(lambda: upsample2_conv3_backward(x, k, g),
                             x.dtype),
        **_bound(2 * flops, nbytes, "float32" if x.dtype == torch.float32
                 else "bfloat16", "backward_"),
        backward_library_ms=queued_ms(lambda: torch.autograd.grad(
            lib_out, lib_leaves, lib_g, retain_graph=True), 10))


def _split_kind(name: str):
    """Which of K1's backward kernels a profiled kernel is, by its name."""
    for key, kind in (("k1_dx_reduce", "dx_reduce"), ("k1_dk_fold", "dk_fold"),
                      ("k1_dx", "dx"), ("k1_dk", "dk")):
        if key in name:
            return kind
    return None


def _split_call(events: list) -> dict:
    """One backward call's device ms by part: K1's kernels by kind, the
    other kernels before the first of them (the weight permutation), the
    reductions after the last (the bias gradient's sum) and the other
    kernels after it (the bias gradient's f32 copy of g) or between them."""
    kinds = [_split_kind(e.name) for e in events]
    k1 = [i for i, k in enumerate(kinds) if k]
    parts: dict = {}
    for i, (e, kind) in enumerate(zip(events, kinds)):
        if kind is None:
            if not k1 or i < k1[0]:
                kind = "before_kernels"
            elif i > k1[-1]:
                kind = "db_sum" if "reduce_kernel" in e.name else "after_kernels"
            else:
                kind = "between_kernels"
        parts[kind] = parts.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    return parts


def phase_k1_backward_split(seed: int) -> dict:
    """K1's backward node split by kernel and by stage, in device ms, for
    each of SPLIT_STEPS: one profiled trace a step, SPLIT_REPS calls of the
    node (torch.autograd.grad through upsample2_conv3, the forward outside
    the trace) at each stage, calls told apart by the gap a host pause
    leaves on the card.  Prints one [k1_split] line a stage and a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prdisagg_torch.ops.upsample_conv import (
        k1_backward_plan,
        upsample2_conv3,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    out = {}
    for step, b, stages, dname in SPLIT_STEPS:
        dtype = getattr(torch, dname)
        calls = []
        for d, h, w, cin, cout in stages:
            x = torch.randn((b, d, h, w, cin), generator=gen,
                            device=dev).to(dtype).requires_grad_(True)
            k = (0.02 * torch.randn((3, 3, 3, cin, cout), generator=gen,
                                    device=dev)).requires_grad_(True)
            bias = (0.02 * torch.randn((cout,), generator=gen,
                                       device=dev)).requires_grad_(True)
            y = upsample2_conv3(x, k, bias)
            g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
            calls.append((x, k, bias, y, g))

        def run():
            for x, k, bias, y, g in calls:
                for _ in range(SPLIT_REPS):
                    torch.autograd.grad(y, (x, k, bias), g, retain_graph=True)
                    torch.cuda.synchronize()
                    time.sleep(SPLIT_GAP_S)

        run()
        rows = None
        for _ in range(DEVICE_TRACE_TRIES):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
            dev_ev = sorted(_device_events(prof),
                            key=lambda e: e.time_range.start)
            groups, cur = [], []
            for e in dev_ev:
                if cur and (e.time_range.start - cur[-1].time_range.end
                            > SPLIT_GAP_S * 1e6 / 3):  # us
                    groups.append(cur)
                    cur = []
                cur.append(e)
            if cur:
                groups.append(cur)
            if len(groups) == len(stages) * SPLIT_REPS:
                rows = []
                for s, (d, h, w, cin, cout) in enumerate(stages):
                    mine = groups[s * SPLIT_REPS:(s + 1) * SPLIT_REPS]
                    parts: dict = {}
                    for grp in mine:
                        for kind, ms in _split_call(grp).items():
                            parts[kind] = parts.get(kind, 0.0) + ms / len(mine)
                    names = collections.Counter(
                        _split_kind(e.name) or e.name[:60] for e in mine[0])
                    plan = k1_backward_plan(dtype, b, d, h, w, cin, cout)
                    rows.append({"step": step, "stage": s, "dtype": dname,
                                 "shape": [b, d, h, w, cin, cout],
                                 "workspace_mb": backward_workspace_bytes(
                                     plan, b, d, h, w, cin, cout) / 1e6,
                                 "node_ms": sum(parts.values()),
                                 "k1_kernels_ms": sum(
                                     v for n, v in parts.items()
                                     if n in ("dx", "dk", "dx_reduce",
                                              "dk_fold")),
                                 "parts_ms": parts,
                                 "launches": dict(names)})
                break
            print(f"[k1_split] {step}: {len(groups)} call groups in the "
                  f"trace, {len(stages) * SPLIT_REPS} expected; tracing again")
        if rows is None:
            print(f"[k1_split] {step}: not measured")
            continue
        for row in rows:
            print("[k1_split] " + json.dumps(row))
        total = {"step": step, "dtype": dname, "stages": len(rows),
                 "node_ms": sum(r["node_ms"] for r in rows),
                 "k1_kernels_ms": sum(r["k1_kernels_ms"] for r in rows),
                 "workspace_mb": sum(r["workspace_mb"] for r in rows),
                 "launches": sum(sum(r["launches"].values()) for r in rows),
                 "k1_launches": sum(
                     n for r in rows for k, n in r["launches"].items()
                     if k in ("dx", "dk", "dx_reduce", "dk_fold"))}
        for kind in sorted({k for r in rows for k in r["parts_ms"]}):
            total[kind] = sum(r["parts_ms"].get(kind, 0.0) for r in rows)
        print("[k1_split] " + json.dumps(total))
        out[step] = {"stages": rows, "total": total}
        del calls
        torch.cuda.empty_cache()
    return out


# K1's f32 forward by kernel: (name, batch, D, H, W, Cin, Cout) at the
# serving batches (16x16 B 1000, 64x64 B 512 and 488), the f32 step's
# (B 32, its fused B 192, the 64x64 step's B 4), crps_gan's member batch,
# a spatial rank's slab and small or ragged batches
K1_FORWARD_CASES = (
    [(f"serve16_{n}", 1000, *s[1:]) for n, *s in STAGES[:3]]
    + [(f"serve64_{n}", 512, d, h, w, cin, cout)
       for n, d, h, w, cin, cout in LARGE_STAGES]
    + [("serve64_last_b488", 488, *LARGE_STAGES[2][1:])]
    + [(f"step16_{n}", TRAIN_BATCH, *s[1:]) for n, *s in STAGES[:3]]
    + [(f"fused16_{n}", (N_DISC + 1) * TRAIN_BATCH, *s[1:])
       for n, *s in STAGES[:3]]
    + [(f"step64_{n}", LARGE_F32_CHECK["batch"], d, h, w, cin, cout)
       for n, d, h, w, cin, cout in LARGE_STAGES]
    + [(f"crps_{n}", EVAL_MEMBER_BATCH, *s[1:]) for n, *s in STAGES[:3]]
    + [("slab64_p4_stage2", 4, 12, 32 // 4 + 2, 32, 128, 64),
       ("small_b3_stage0", 3, 3, 2, 2, 256, 256),
       ("small_b5_stage1", 5, 6, 4, 4, 256, 128),
       ("ragged_b33_stage1", 33, 6, 4, 4, 256, 128),
       ("cin32_b1000", 1000, 6, 4, 4, 32, 64),
       ("cin96_b7", 7, 5, 3, 9, 96, 128)])


def _ptxas_lines(name: str, kernels: tuple) -> list:
    """The ptxas report (registers, spills) of the kernels whose mangled
    names contain one of `kernels`, from this process's build log."""
    from prdisagg_torch import _build

    lines = _build.build_logs.get(name, "").splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(
                k in line for k in kernels):
            out += [ln.strip() for ln in lines[i:i + 5]
                    if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return out


def phase_k1_forward(seed: int) -> dict:
    """K1's f32 forward by kernel at K1_FORWARD_CASES: the halo forward at
    k1_plan's tile and at each of HALO_F32_FW_TILES, and the general
    kernel, each against the plain version (TF32 off; rtol 1e-4, atol
    1e-5 of the largest value) and timed in device ms (queued_ms), beside
    the plain version, the exact-FMA and 3xTF32 bounds; the weight split
    bit for bit against its plain version.  Prints [k1_forward] rows."""
    import torch

    from prdisagg_torch.ops import upsample_conv as uc
    from prdisagg_torch.ops.core import full_f32

    for line in _ptxas_lines("upsample_conv", ("k1_f32_halo",
                                               "k1_pack_fwd_tf32")):
        print("[k1_forward] ptxas " + line)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    rtol, atol = TOL["float32"]
    rows, ok, packs = [], True, set()
    for name, b, d, h, w, cin, cout in K1_FORWARD_CASES:
        x = torch.randn((b, d, h, w, cin), generator=gen, device=dev)
        k = 0.02 * torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev)
        bias = 0.02 * torch.randn((cout,), generator=gen, device=dev)
        kp = uc.pack_phase_kernels(k, torch.float32)
        if (cin, cout) not in packs:
            packs.add((cin, cout))
            same = torch.equal(uc.pack_fwd_tf32_cuda(kp),
                               uc.pack_phase_kernels_tf32(kp))
            print(f"[k1_forward] pack Cin {cin} Cout {cout}: bit for bit "
                  f"{same}")
            ok &= same
        flops = 2 * 64 * b * d * h * w * cin * cout
        heavy = flops > HEAVY_FLOPS
        with full_f32():
            ref = uc.upsample2_conv3_reference(x, k, bias)
            plain_ms = queued_ms(
                lambda: uc.upsample2_conv3_reference(x, k, bias),
                1 if heavy else 5)
        chosen = uc.k1_plan(torch.float32, b, d, h, w, cin, cout)
        plans = [chosen] + [
            p for p in (uc._halo_forward_plan(b, d, h, w, cout, (bm,))
                        for bm in uc.HALO_F32_FW_TILES)
            if p != chosen] + [
            uc.general_plan(b, d, h, w, cout)]
        for plan in plans:
            got = uc.upsample2_conv3_cuda(x, kp, bias, plan)
            torch.cuda.synchronize()
            good, err, scale = _compare(got, ref, rtol, atol)
            del got
            ms = queued_ms(lambda: uc.upsample2_conv3_cuda(x, kp, bias, plan),
                           2 if heavy else 10)
            row = {"case": name, "shape": [b, d, h, w, cin, cout],
                   "variant": plan.variant, "chosen": plan == chosen,
                   "tile": [plan.bm, plan.bn], "block": list(plan.block),
                   "ctas": plan.ctas, "ok": good, "max_err_over_max": err /
                   scale, "ms": ms, "plain_ms": plain_ms,
                   "fma_bound_ms": 1e3 * flops / PEAK_F32_FLOPS,
                   "tf32x3_bound_ms": 3e3 * flops / PEAK_TF32_FLOPS,
                   "tf32x3_share": 3e3 * flops / PEAK_TF32_FLOPS / ms}
            print("[k1_forward] " + json.dumps(row), flush=True)
            rows.append(row)
            ok &= good
        del x, ref, kp
        torch.cuda.empty_cache()
    check(ok, "K1's f32 forward disagrees with its plain version (see "
          "[k1_forward] lines)")
    return {"rows": rows}


# the split phase's own process: its time limit
SPLIT_LIMIT_S = 300


def phase_k1_backward_split_proc(seed: int) -> dict:
    """phase_k1_backward_split in a process of its own (`chip_smoke.py
    --k1-backward-split`, which finds the kernels built): its profiler
    sessions, one a step, left the profiler of this process seeing no
    device events in the phases after it.  Echoes and returns its
    [k1_split] rows by step."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--k1-backward-split", "--seed", str(seed)],
                       cwd=root, capture_output=True, text=True,
                       timeout=SPLIT_LIMIT_S)
    out: dict = {}
    for line in r.stdout.splitlines():
        if line.startswith("[k1_split]"):
            print(line)
            if line.startswith("[k1_split] {"):
                row = json.loads(line[len("[k1_split] "):])
                step = out.setdefault(row["step"], {"stages": []})
                if "stage" in row:
                    step["stages"].append(row)
                else:
                    step["total"] = row
    check(r.returncode == 0, f"the split phase's process: rc "
          f"{r.returncode}\n{r.stderr[-3000:]}")
    return out


def _compare(got, ref, rtol: float, atol: float) -> tuple:
    """(every element within rtol * |ref| + atol * max|ref|, max |got -
    ref|, max |ref|), a batch slice at a time: the difference of a whole
    64x64 f32 stage at serving's batch would hold another 13 GB."""
    step = max(1, (1 << 28) // max(1, ref[0].numel()))
    chunks = range(0, len(ref), step)
    scale = max(ref[i:i + step].float().abs().max().item() for i in chunks)
    ok, worst = True, 0.0
    for i in chunks:
        r, e = ref[i:i + step].float(), got[i:i + step].float()
        e = (e - r).abs()
        ok &= bool((e <= atol * scale + rtol * r.abs()).all().item())
        worst = max(worst, e.max().item())
    return ok, worst, scale


def phase_kernel_check(seed: int) -> dict:
    """K1 against its plain version at every shape of K1_CASES and
    large_k1_cases(), with its time beside the plain version's and one
    cuDNN convolution of the upsampled input (timed only); at the generator
    update's batch (one card's, a gloo rank's and the 64x64 f32 step
    check's) also its backward.  Forward times are device times
    (:func:`queued_ms`); ``call_ms`` is one call timed with CUDA events,
    launch included."""
    import torch
    import torch.nn.functional as F

    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.ops.core import full_f32, upsample3d_nearest
    from prdisagg_torch.ops.upsample_conv import (
        pack_phase_kernels,
        upsample2_conv3_cuda,
        upsample2_conv3_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    ok = True
    backward_batches = (TRAIN_BATCH, TRAIN_BATCH // DP_GLOO_WORLD,
                        LARGE_F32_CHECK["batch"], LARGE_F32_CHECK["batch"] // 2,
                        (N_DISC + 1) * TRAIN_BATCH,
                        (F32_CHECK["n_disc"] + 1) * F32_CHECK["batch"])
    for (name, b, d, h, w, cin, cout), dtypes in (
            K1_CASES + large_k1_cases() + spatial_k1_cases()):
        x32 = torch.randn((b, d, h, w, cin), generator=gen, device=dev)
        k = 0.02 * torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev)
        bias = 0.02 * torch.randn((cout,), generator=gen, device=dev)
        for dname in dtypes:
            dtype = getattr(torch, dname)
            x = x32.to(dtype)
            kp = pack_phase_kernels(k, dtype)
            rtol, atol = TOL[dname]
            es = x.element_size()
            flops = 2 * 64 * b * d * h * w * cin * cout
            with full_f32():
                ref = upsample2_conv3_reference(x, k, bias)
                counts = upsample_conv.launches_by_variant
                before = dict(counts)
                got = upsample2_conv3_cuda(x, kp, bias)
                torch.cuda.synchronize()
                variant = [v for v in counts if counts[v] != before[v]]
                plan = upsample_conv.k1_plan(dtype, b, d, h, w, cin, cout)
                good, max_err, scale = _compare(got, ref, rtol, atol)
                # every flagship and 64x64 stage takes the main path's
                # kernel (k1_plan's: fast, or halo_f32 in f32)
                good &= variant == [plan.variant] != ["general"]
                out_shape = ref.shape
                del got, ref
                extra = {}
                # the generator update's backward, at one card's batch,
                # at a rank's of the gloo world and at the 64x64 f32 step's
                if b in backward_batches:
                    g = torch.randn(out_shape, generator=gen,
                                    device=dev).to(dtype)
                    extra = _k1_backward(x, k, bias, g, flops, (rtol, atol))
                    good &= extra["backward_ok"]
                    del g
                reps = 10 if flops < HEAVY_FLOPS else 1
                ms = queued_ms(lambda: upsample2_conv3_cuda(x, kp, bias), reps)
                # one call timed with CUDA events, the Python launch included
                call_ms = cuda_ms(lambda: upsample2_conv3_cuda(x, kp, bias),
                                  reps, warmup=min(reps, 2))
                plain_ms = queued_ms(
                    lambda: upsample2_conv3_reference(x, k, bias), reps)
                # library yardstick: one cuDNN conv of the upsampled input
                xu = upsample3d_nearest(x, 2).permute(0, 4, 1, 2, 3)
                wt = k.permute(4, 3, 0, 1, 2).to(dtype)
                bt = bias.to(dtype)
                library_ms = queued_ms(
                    lambda: F.conv3d(xu, wt, bt, padding=1), reps)
                del xu
            row = _kernel_row(
                name, dname, [b, d, h, w, cin, cout], flops,
                b * d * h * w * cin * es + 64 * cin * cout * es + 4 * cout
                + 8 * b * d * h * w * cout * es,
                ok=good, variant=variant[0], tile=[plan.bm, plan.bn],
                ctas=plan.ctas, max_abs_err=max_err, max_ref=scale, rtol=rtol,
                atol_over_max=atol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, tflops=flops / ms / 1e9, **extra)
            if row["variant"] == "fast":
                # what the CTAs copy from L2 into shared memory: every
                # (phase, tap) re-reads the input rows, every M tile the
                # weights; 128 bytes per tile row and reduction slice
                bk = upsample_conv.FAST_BK
                row["tile_load_bytes"] = (plan.ctas * (8 * cin // bk)
                                          * (plan.bm + plan.bn) * 128)
                row["tile_load_tb_per_s"] = row["tile_load_bytes"] / ms / 1e9
            rows.append(row)
            ok &= good
            print("[kernel] " + json.dumps(row))
        del x32, x, kp
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("upsample2_conv3 kernel disagrees with its "
                             "plain version (see [kernel] lines)")
    return {"rows": rows}


def phase_dataset(seed: int):
    """The card-resident training dataset, made on the card."""
    import torch

    from prdisagg_torch.core.config import DataConfig
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset_torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_days, _, ny, nx = DATASET_SHAPE
    data, indices, cfg = make_synthetic_dataset_torch(
        n_days, ny, nx, seed, CARD, cfg=DataConfig())
    ds = DeviceDataset.from_tensor(data, indices, cfg)
    torch.cuda.synchronize()
    nbytes = data.numel() * data.element_size()
    print(f"[dataset] {tuple(data.shape)} float32 on the card "
          f"({nbytes / 1e9:.3f} GB), {ds.n_samples} valid patches, made in "
          f"{time.perf_counter() - t0:.1f} s")
    check(data.data_ptr() == ds.data.data_ptr(), "from_tensor copied data")
    return ds


def _rows_nd(ds, b: int, nd: int, gen):
    """b index rows of nd-wide patches inside ds's tensor, on the sweep's
    stride as the dataset's valid rows are."""
    import torch

    n_days, _, ny, nx = ds.data.shape
    stride = ds.cfg.stride
    cols = [torch.randint(0, hi, (b,), generator=gen, device=ds.device)
            for hi in (n_days, (ny - nd) // stride + 1,
                       (nx - nd) // stride + 1)]
    return torch.stack([cols[0], stride * cols[1], stride * cols[2]],
                       1).to(torch.int32)


def phase_gather_check(ds, seed: int) -> dict:
    """K2 against its plain version, bit for bit, with fresh index rows for
    every timed call (a real draw finds its patches outside the L2).  Times
    are device times from the profiler (:func:`device_ms`); ``call_ms`` is
    one call timed with CUDA events, the Python launch included."""
    import torch

    from prdisagg_torch.core.config import RainFarmConfig
    from prdisagg_torch.ops.gather import (
        gather_patches_cuda,
        gather_patches_reference,
    )

    gen = torch.Generator(device=ds.device).manual_seed(seed + 3)
    rows, ok = [], True
    reps = 20
    step_b, bulk_b = N_DISC * TRAIN_BATCH, RainFarmConfig().n_calib
    nd16 = ds.cfg.ndomain
    shard_b = TRAIN_BATCH // DP_GLOO_WORLD
    # one step's real gathers, a bulk draw (RainFARM's calibration), the
    # generator update's conditions from the daily sums, one step's real
    # gathers at the 64x64 domain from the same tensor, and a step's two
    # gathers on one rank of the dp phase's world of 2
    for name, b, nd, from_dsum in (
            (f"real_b{step_b}", step_b, nd16, False),
            (f"bulk_b{bulk_b}", bulk_b, nd16, False),
            (f"cond_b{TRAIN_BATCH}", TRAIN_BATCH, nd16, True),
            (f"real_b{step_b}_nd{ND_LARGE}", step_b, ND_LARGE, False),
            (f"real_b{N_DISC * shard_b}", N_DISC * shard_b, nd16, False),
            (f"cond_b{shard_b}", shard_b, nd16, True)):
        src = ds.dsum[:, None] if from_dsum else ds.data
        nh = src.shape[1]
        batches = [ds.draw_rows(b, gen) if nd == nd16
                   else _rows_nd(ds, b, nd, gen) for _ in range(reps + 2)]
        idx = batches[0]
        got = gather_patches_cuda(src, idx, nd)
        want = gather_patches_reference(src, idx, nd)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        max_err = (got - want).abs().max().item()
        del got, want
        ok &= equal
        cycle = itertools.cycle(batches)
        longs = itertools.cycle([[c.long() for c in i.unbind(1)]
                                 for i in batches])
        windows = src.unfold(2, nd, 1).unfold(3, nd, 1)

        def library():
            t, y, x = next(longs)
            return windows[t, :, y, x]

        nbytes = 2 * b * nh * nd * nd * 4
        row = _kernel_row(
            name, "float32", [b, nh, nd, nd], 0, nbytes,
            ok=equal, exact=equal, max_abs_err=max_err,
            ms=device_ms(lambda: gather_patches_cuda(src, next(cycle), nd),
                         reps),
            plain_ms=device_ms(
                lambda: gather_patches_reference(src, next(cycle), nd), reps),
            library_ms=device_ms(library, reps),
            # CUDA events around each call: the launch from Python included
            call_ms=cuda_ms(lambda: gather_patches_cuda(src, next(cycle), nd),
                            reps),
            host_us=host_us(
                lambda: gather_patches_cuda(src, next(cycle), nd)))
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        rows.append(row)
        print("[kernel] " + json.dumps(row))
    if not ok:
        raise AssertionError("gather_patches kernel is not bit-exact "
                             "(see [kernel] lines)")
    return {"rows": rows}


# pixel-norm and leaky ReLU after each stage of the main path: the 16x16
# stages' outputs at the serving batch, and the 64x64 last stage's at
# max_batch 512 (3.2e9 floats, past 32-bit offsets)
PIXEL_NORM_CASES = [("pn_stage0", (SCENARIOS, 6, 4, 4, 256)),
                    ("pn_stage1", (SCENARIOS, 12, 8, 8, 128)),
                    ("pn_stage2", (SCENARIOS, 24, 16, 16, 64)),
                    ("pn_large_stage2_b512", (512, 24, 64, 64, 64))]


def phase_pixel_norm_check(seed: int) -> dict:
    """The fused pixel-norm and leaky ReLU kernel against the plain chain
    it replaces (square, mean, product, leaky ReLU) at PIXEL_NORM_CASES:
    elementwise within the mean's summation order, device times of both
    (:func:`queued_ms`) and of the library's nearest pair of calls
    (``F.rms_norm``, then ``F.leaky_relu_``), the call's time with its
    Python launch, and the bound, one read and one write over HBM's
    rate."""
    import torch
    import torch.nn.functional as F

    from prdisagg_torch.ops import core

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rows, ok = [], True

    def plain(x):
        return core.leaky_relu(core.pixel_norm(x), 0.2)

    def library(x):
        # PyTorch's fused RMS norm, then the leaky ReLU in place
        return F.leaky_relu_(F.rms_norm(x, (x.shape[-1],), eps=1e-8), 0.2)

    for name, shape in PIXEL_NORM_CASES:
        x = torch.randn(shape, generator=gen, device=dev)
        before = core.pixel_norm_launches
        got = core.pixel_norm_leaky(x, 0.2)
        torch.cuda.synchronize()
        launched = core.pixel_norm_launches - before
        want = plain(x)
        good, max_err, scale = _compare(got, want, 1e-5, 1e-7)
        good &= launched == 1
        lib_ok, lib_err, _ = _compare(library(x), want, 1e-5, 1e-7)
        del got, want
        nbytes = 2 * x.numel() * 4
        reps = 10 if nbytes < 1e10 else 3
        ms = queued_ms(lambda: core.pixel_norm_leaky(x, 0.2), reps)
        row = dict(stage=name, dtype="float32", shape=list(shape), ok=good,
                   launches=launched, max_abs_err=max_err, max_ref=scale,
                   rtol=1e-5, ms=ms,
                   call_ms=cuda_ms(lambda: core.pixel_norm_leaky(x, 0.2),
                                   reps, warmup=1),
                   plain_ms=queued_ms(lambda: plain(x), reps),
                   library_ms=queued_ms(lambda: library(x), reps),
                   library_ok=lib_ok, library_max_abs_err=lib_err,
                   **_bound(0, nbytes, "float32"))
        row["bound_share"] = row["bound_ms"] / ms
        row["gb_per_s"] = nbytes / ms / 1e6
        rows.append(row)
        ok &= good
        print("[kernel] " + json.dumps(row))
        del x
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("pixel_norm_leaky kernel disagrees with the "
                             "plain chain (see [kernel] lines)")
    return {"rows": rows}


def _plain_backward(x, k, g, need_dx=True, need_dk=True, kp=None,
                    need_db=False):
    """upsample2_conv3_backward_cuda's counterpart by the plain version, as
    a CPU tensor's backward takes it: the phase convolutions' gradients
    (upsample2_conv3_backward) and the bias gradient as g's float32 sum."""
    from prdisagg_torch.ops.upsample_conv import upsample2_conv3_backward

    dx, dk = upsample2_conv3_backward(x, k, g, need_dx, need_dk)
    return dx, dk, g.float().sum(dim=(0, 1, 2, 3)) if need_db else None


@contextlib.contextmanager
def _k1_plain_route():
    """K1 by its plain versions on the card, forward and backward, as a CPU
    tensor takes them: the forward packs no weights and runs
    upsample2_conv3_reference, the backward upsample2_conv3_backward."""
    from prdisagg_torch.ops import upsample_conv as uc

    saved = (uc.pack_phase_kernels, uc.upsample2_conv3_cuda,
             uc.upsample2_conv3_backward_cuda)
    uc.pack_phase_kernels = lambda kernel, dtype: kernel
    uc.upsample2_conv3_cuda = uc.upsample2_conv3_reference
    uc.upsample2_conv3_backward_cuda = _plain_backward
    try:
        yield
    finally:
        (uc.pack_phase_kernels, uc.upsample2_conv3_cuda,
         uc.upsample2_conv3_backward_cuda) = saved


def _f32_step_check(state, ds, seed: int, n_disc: int, b: int,
                    rtol: float, against: str = "cpu") -> dict:
    """One float32 step (dropout 0, pre-drawn inputs) from the trained
    parameters, with mid-training Adam moments, on the card against the
    same step on the CPU path (`against` "cpu") or on the card with K1's
    plain route ("plain"); losses within `rtol` of the losses' scale and
    every parameter within rtol * max|p| over its net.  Also reports
    whether the critic's pad-only taps kept their weights bit for bit on
    both sides."""
    import torch

    from prdisagg_torch.core.config import TrainConfig
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.models.critic import pad_only_taps
    from prdisagg_torch.train.state import clone_train_state
    from prdisagg_torch.train.wgan_gp import (
        StepDraws,
        train_step_on,
        unpack_metrics,
    )

    cfg = dataclasses.replace(state.gen.cfg, compute_dtype="float32",
                              dropout_rate=0.0)
    tcfg = TrainConfig(n_disc=n_disc)
    ds_cpu = (DeviceDataset.from_tensor(ds.data.cpu(), ds.indices.cpu(),
                                        ds.cfg) if against == "cpu" else None)
    g = torch.Generator().manual_seed(seed + 4)
    rows = ds.indices.cpu()
    draws = dict(real_rows=rows[torch.randint(0, len(rows), (n_disc * b,),
                                              generator=g)],
                 latent=torch.randn((n_disc * b, cfg.latent_dim), generator=g),
                 eps=torch.rand((n_disc, b), generator=g),
                 gen_latent=torch.randn((b, cfg.latent_dim), generator=g),
                 gen_rows=rows[torch.randint(0, len(rows), (b,),
                                             generator=g)])
    # the trained parameters with mid-training Adam moments (_warm_adam):
    # from a trained state's own moments Adam moves a weight whose second
    # moment is exactly 0 by about lr * sign(g), so that rounding decides
    # a 2 lr difference between the two sides
    base = clone_train_state(state, cfg, tcfg, CARD)
    _warm_adam(base, seed)
    pads = pad_only_taps(cfg)
    sides = ((CARD, CARD, ds, contextlib.nullcontext),
             (against, "cpu" if against == "cpu" else CARD,
              ds_cpu if against == "cpu" else ds, _k1_plain_route))
    out = {}
    for side, dev, data, route in sides:
        st = clone_train_state(base, cfg, tcfg, dev)
        dr = StepDraws(masks=[None] * n_disc, gp_masks=[None] * n_disc,
                       gen_masks=None,
                       **{k: v.to(dev) for k, v in draws.items()})
        with route():
            m = unpack_metrics(train_step_on(st, data, dr, tcfg)["packed"])
        kept = all(torch.equal(
            getattr(st.critic, f"conv{i}").weight.detach().cpu()[mask],
            getattr(base.critic, f"conv{i}").weight.detach().cpu()[mask])
            for i, mask in pads.items())
        out[side] = (m, st, kept)
    (mc, sc, kc), (mp, sp, kp) = out[CARD], out[against]
    losses = ("d_loss", "gp", "w_distance", "g_loss")
    scale = max(abs(mp[k]) for k in losses)
    loss_err = max(abs(mc[k] - mp[k]) for k in losses) / scale
    param_err = 0.0
    for net in ("gen", "critic"):
        a, c = getattr(sc, net).state_dict(), getattr(sp, net).state_dict()
        pmax = max(v.abs().max().item() for v in c.values())
        param_err = max(param_err, max(
            (a[k].cpu() - c[k].cpu()).abs().max().item() for k in c) / pmax)
    row = {"card": {k: mc[k] for k in losses},
           against: {k: mp[k] for k in losses},
           "loss_err_over_scale": loss_err, "param_err_over_max": param_err,
           "pad_only_taps_kept": {CARD: kc, against: kp} if pads else None,
           "ndomain": cfg.ndomain, "n_disc": n_disc, "batch": b,
           "tolerance": rtol}
    print(f"[train] f32 step, card vs {against}: " + json.dumps(row))
    check(not mc["nonfinite"] and not mp["nonfinite"], "non-finite f32 step")
    check(loss_err <= rtol and param_err <= rtol,
          f"card and {against} f32 steps differ: {row}")
    check(not pads or (kc and kp), f"pad-only taps moved: {row}")
    return row


def _train_exp(epochs: int, seed: int, **train_kw):
    """The flagship training configuration (bf16, B 32, n_disc 5) for
    `epochs` epochs."""
    from prdisagg_torch.core.config import ExperimentConfig, TrainConfig

    return ExperimentConfig(train=TrainConfig(
        n_disc=N_DISC, schedule=((epochs, TRAIN_BATCH),), seed=seed,
        **train_kw))


def _k1_backward_ms(prof) -> float:
    """Device milliseconds of the kernels launched inside K1's backward
    (the autograd node of ops/upsample_conv.py's Function), from a
    profile's operator tree.  Two operators carry the node's name, the
    engine's ``evaluate_function`` and the node nested in it, each with the
    kernels below it: the outer one's time is the node's."""
    return max((getattr(a, "device_time_total",
                        getattr(a, "cuda_time_total", 0.0))
                for a in prof.key_averages()
                if "_UpsampleConv3Backward" in a.key), default=0.0) / 1e3


# the hand-written kernels, by a part of their names in a profile
BY_NAME = ("k1_bf16_wgmma", "k1_general", "k2_gather",
           "k1_f32_halo", "k1_pack_fwd_tf32", "k1_dx_bf16_halo",
           "k1_dk_bf16_halo", "k1_dx_f32_halo", "k1_dk_f32_halo",
           "k1_pack_tf32", "k1_dx_fma", "k1_dk_fma", "k1_dx_reduce",
           "k1_dk_fold", "pixel_norm_leaky")
# K1's backward kernels' counter names (BACKWARD_KERNELS) by profile name;
# the FMA kernels also ran f32 as "dx_fast" and "dk_fast" before the f32
# halo kernels, named here so that --f32-step can measure such a tree
BACKWARD_BY_NAME = {"k1_dx_bf16_halo": ("dx_halo",),
                    "k1_dk_bf16_halo": ("dk_halo",),
                    "k1_dx_f32_halo": ("dx_halo_f32",),
                    "k1_dk_f32_halo": ("dk_halo_f32",),
                    "k1_pack_tf32": ("pack_tf32",),
                    "k1_dx_fma": ("dx_general", "dx_fast"),
                    "k1_dk_fma": ("dk_general", "dk_fast"),
                    "k1_dx_reduce": ("dx_reduce",), "k1_dk_fold": ("dk_fold",)}


def _eager_backward(prof: dict) -> dict:
    """What one eager step's profile says of K1's backward: the device ms
    of its autograd node and of its kernels by name, the step's busy ms
    and its elementwise and NCHW-to-NHWC kernel counts, and whether a cuDNN
    convolution gradient ran inside the node."""
    def below(ev):
        for c in ev.cpu_children:
            yield c
            yield from below(c)

    cudnn = any("convolution_backward" in c.name
                for e in prof["prof"].events()
                if "_UpsampleConv3Backward" in e.name for c in below(e))
    names = prof["count_by_name"]
    return {"node_ms": _k1_backward_ms(prof["prof"]),
            "kernels_ms": sum(ms for n, ms in prof["ms_by_name"].items()
                              if "k1_dx_" in n or "k1_dk_" in n),
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "elementwise_kernel<128, 4>": sum(
                c for n, c in names.items() if "elementwise_kernel<128, 4" in n),
            "elementwise_all": sum(c for n, c in names.items()
                                   if "elementwise_kernel" in n),
            "nchwToNhwc": sum(c for n, c in names.items()
                              if "nchwToNhwc" in n),
            "cudnn_in_node": cudnn}


def _backward_kernels(counts: dict) -> dict:
    """K1's backward kernels' counts out of the wrappers' counter names."""
    pre = "upsample2_conv3_backward_"
    return {k[len(pre):]: n for k, n in counts.items() if k.startswith(pre)}


def _executed_counts(wrappers: dict, captured: dict, replayed: dict) -> dict:
    """Kernel runs on a path: what passed through the wrappers (eager
    calls, and captures, which record a launch without running it), less
    the captured launches, plus what graph replays launched."""
    return {k: wrappers[k] - captured.get(k, 0) + replayed.get(k, 0)
            for k in wrappers}


def _fit_counted(trainer, steps: int, per_step: dict, tag: str) -> tuple:
    """trainer.fit() with every kernel count set to 0 just before: the
    step's capture must record `per_step`, the replays launch it every
    step, and the wrappers count the warm-up steps and the capture.
    Returns (hist, counts of the kernels run)."""
    import torch

    from prdisagg_torch.ops import gather, upsample_conv
    from prdisagg_torch.train import wgan_gp

    torch.cuda.synchronize()
    reset_k1_counts()
    gather.launches = 0
    wgan_gp.graph_captured.clear()
    wgan_gp.graph_launches.clear()
    hist = trainer.fit(progress=False)
    torch.cuda.synchronize()
    wrappers = wgan_gp.kernel_counts()
    captured = dict(wgan_gp.graph_captured)
    replayed = dict(wgan_gp.graph_launches)
    executed = _executed_counts(wrappers, captured, replayed)
    print(f"[{tag}] main path: Trainer.fit, {steps} steps as CUDA graph "
          f"replays: wrappers {wrappers} (the {wgan_gp.WARMUP_STEPS} warm-up "
          f"steps and one capture), captured per replay {captured}, replays "
          f"launched {replayed}, kernels run {executed}")
    check(trainer.state.step == steps, trainer.state.step)
    check(captured == per_step, f"one capture of one step: {captured}")
    check(replayed == {k: n * steps for k, n in per_step.items()}, replayed)
    check(wrappers == {k: n * (wgan_gp.WARMUP_STEPS + 1)
                       for k, n in per_step.items()}, wrappers)
    counts = {"upsample2_conv3": executed["upsample2_conv3"],
              "upsample2_conv3_by_variant": {
                  v: executed[f"upsample2_conv3_{v}"]
                  for v in upsample_conv.VARIANTS},
              "upsample2_conv3_backward": executed["upsample2_conv3_backward"],
              "upsample2_conv3_backward_kernels": _backward_kernels(executed),
              "gather_patches": executed["gather_patches"],
              "pixel_norm_leaky": executed["pixel_norm_leaky"]}
    import numpy as np

    vals = np.array([hist[k] for k in hist if k != "epoch"])
    check(np.isfinite(vals).all(), f"non-finite metrics {hist}")
    return hist, counts


def _add_counts(total: dict, more: dict) -> dict:
    """Two paths' kernel counts, summed key by key (nested dicts too)."""
    return {k: _add_counts(v, more[k]) if isinstance(v, dict)
            else v + more[k] for k, v in total.items()}


def _step_peaks(step_fn, state, ds) -> list:
    """Peak device bytes above the resident ones of a new graphed step's
    first call (warm-up on a clone, capture, replays) and of a call of
    replays alone."""
    import torch

    peaks = []
    for _ in range(2):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_fn(state, ds)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - resident)
    return peaks


def _graph_kernels(step_fn, state, ds, per_step: dict, what: str,
                   tag: str, replays: int = PROFILE_REPLAYS) -> dict:
    """A profile of one call of `replays` graphed steps (step_fn's
    steps_per_call): device busy and idle share, and the hand-written
    kernels counted by name inside the replays (K1's forward and backward
    kernels as `per_step` says: 6 forwards a step, on wgmma in bf16 and on
    the halo forward and its weight split in f32; K2 2 a step; the
    pixel-norm pass one a K1 forward) with their device ms a step.  CUPTI now and then
    drops events of a long trace, so a trace whose counts differ is taken
    again, up to DEVICE_TRACE_TRIES traces, before the check fails."""
    import torch

    halo = per_step.get("upsample2_conv3_halo_f32", 0)
    want = {"k1_bf16_wgmma": per_step.get("upsample2_conv3_fast", 0),
            "k1_general": per_step.get("upsample2_conv3_general", 0),
            "k1_f32_halo": halo, "k1_pack_fwd_tf32": halo, "k2_gather": 2,
            "pixel_norm_leaky": per_step.get("pixel_norm_leaky", 0)}
    want.update({n: sum(per_step.get(f"upsample2_conv3_backward_{k}", 0)
                        for k in ks)
                 for n, ks in BACKWARD_BY_NAME.items()})
    want = {n: want.get(n, 0) * replays for n in BY_NAME}
    for _ in range(DEVICE_TRACE_TRIES):
        prof = profile_breakdown(
            lambda: (step_fn(state, ds), torch.cuda.synchronize()), what,
            top=12)
        check(prof is not None, "no device events in the graphed window")
        names = prof["count_by_name"]
        in_graph = {name: sum(n for k, n in names.items() if name in k)
                    for name in BY_NAME}
        print(f"[{tag}] kernels in the profiled replays by name: {in_graph} "
              f"({replays} steps)")
        if in_graph == want:
            break
    check(in_graph == want,
          f"the graph's kernels are not the hand-written ones: {in_graph}")
    kernel_ms = {n: sum(ms for k, ms in prof["ms_by_name"].items()
                        if n in k) / replays
                 for n in BY_NAME if in_graph[n]}
    print(f"[{tag}] hand-written kernels' device ms a step in the replays: "
          + json.dumps(kernel_ms))
    return {"window_ms": prof["window_ms"], "busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"],
            "busy_ms_per_step": prof["busy_ms"] / replays,
            "kernels_by_name": in_graph, "kernel_ms_per_step": kernel_ms}


def _conserves(gen, ds, seed: int, n: int = 256) -> float:
    """max |sum_h frac - 1| of a generator on n of the dataset's
    conditions; fails above CONSERVATION_RTOL."""
    import torch

    g = torch.Generator(device=ds.device).manual_seed(seed + 5)
    latent, cond = ds.sample_latent(n, gen.cfg.latent_dim, g)
    with torch.no_grad():
        frac = gen(latent, cond)
    cons = (frac.sum(dim=1) - 1.0).abs().max().item()
    nd = ds.cfg.ndomain
    check(frac.shape == (n, 24, nd, nd, 1) and cons <= CONSERVATION_RTOL,
          f"conservation {cons}")
    return cons


def _pad_only_grads(state, ds, seed: int) -> dict:
    """The critic's pad-only taps on the card, from the trained state: the
    gradient of one critic loss (its gradient penalty included) at every
    such tap, in float32 and bfloat16, must be exactly 0, as JAX's is; and
    the kernels that compute conv3's weight gradient alone, by their
    profiler names."""
    import torch
    import torch.nn.functional as F

    from prdisagg_torch.models.critic import Critic, pad_only_taps
    from prdisagg_torch.ops.core import full_f32
    from prdisagg_torch.train.wgan_gp import critic_loss

    out = {}
    b = TRAIN_BATCH
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(state.critic.cfg, compute_dtype=dname)
        critic = Critic(cfg).to(CARD)
        critic.load_state_dict(state.critic.state_dict())
        g = torch.Generator(device=ds.device).manual_seed(seed + 7)
        frac, cond = ds.sample_real(b, g)
        latent = torch.randn((b, cfg.latent_dim), generator=g,
                             device=ds.device)
        with torch.no_grad():
            fake = state.gen(latent, cond)
        eps = torch.rand((b,), generator=g, device=ds.device)
        loss = critic_loss(critic, frac, cond, fake, eps, None, None, 10.0)[0]
        pads = pad_only_taps(cfg)
        grads = torch.autograd.grad(
            loss, [getattr(critic, f"conv{i}").weight for i in pads])
        row = {}
        for (i, mask), gr in zip(pads.items(), grads):
            row[f"conv{i}"] = {
                "pad_only_taps": int(mask.sum()),
                "max_abs_grad_at_pad_only_taps": gr[mask].abs().max().item(),
                "max_abs_grad_elsewhere": gr[~mask].abs().max().item()}
        # conv3's weight gradient alone, as the critic calls the conv:
        # an NDHWC activation viewed as NCDHW, padded, the weight permuted
        # and cast
        i, mask = next(iter(pads.items()))
        conv = getattr(critic, f"conv{i}")
        cin = conv.weight.shape[3]
        cd = getattr(torch, dname)
        x = torch.randn((b, *critic.stage_dims[i - 1], cin), generator=g,
                        device=ds.device).to(cd).permute(0, 4, 1, 2, 3)
        x = F.pad(x, critic._pads[i])
        w = conv.weight.detach().clone().requires_grad_(True)
        strict = full_f32() if dname == "float32" else contextlib.nullcontext()
        with strict:
            y = F.conv3d(x, w.permute(4, 3, 0, 1, 2).to(cd), stride=2)
            gy = torch.randn(y.shape, generator=g, device=ds.device).to(cd)
            # CUPTI now and then drops the kernels of a short trace: 10
            # calls a trace, up to DEVICE_TRACE_TRIES traces
            kernels = None
            for _ in range(DEVICE_TRACE_TRIES):
                prof = profile_breakdown(
                    lambda: [torch.autograd.grad(y, w, gy, retain_graph=True)
                             for _ in range(10)],
                    f"conv{i}'s weight gradient alone, {dname}, B {b}, 10 "
                    f"calls", top=4)
                names = [] if prof is None else sorted(prof["ms_by_name"])
                if any("copy" not in n for n in names):
                    kernels = names
                    break
            (gw,) = torch.autograd.grad(y, w, gy)
        row[f"conv{i}_alone"] = {
            "max_abs_grad_at_pad_only_taps": gw[mask].abs().max().item(),
            "kernels": kernels}
        print(f"[train] pad-only taps' gradient on the card, {dname}: "
              + json.dumps(row))
        out[dname] = row
    check(all(r["max_abs_grad_at_pad_only_taps"] == 0.0
              for row in out.values() for r in row.values()),
          f"a pad-only tap's gradient is not exactly 0: {out}")
    check(all(row[f"conv{i}_alone"]["kernels"] for row in out.values()),
          f"no trace of {DEVICE_TRACE_TRIES} named conv{i}'s weight-gradient "
          f"kernel (only copies, or no device event): {out}")
    return out


def phase_train(ds, seed: int, workdir: str) -> dict:
    """Trainer.fit at the flagship defaults on the card-resident dataset,
    the step running as a CUDA graph, then EAGER_STEPS eager steps
    in this process, the graphed step's memory and profile, an eager
    step's profile, the critic's pad-only taps and the f32 step against
    the CPU."""
    import torch

    from prdisagg_torch.models.critic import pad_only_taps
    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.train.loop import Trainer
    from prdisagg_torch.train.wgan_gp import (
        draw_step_inputs,
        make_train_step,
        train_step_on,
    )

    kernel_backward = upsample_conv.upsample2_conv3_backward_cuda
    epochs = WARM_EPOCHS + TIMED_EPOCHS
    exp = _train_exp(epochs, seed, log_every_steps=STEPS_PER_EPOCH,
                     checkpoint_every_epochs=epochs)
    trainer = Trainer(exp, ds, workdir, steps_per_epoch=STEPS_PER_EPOCH,
                      plot_every_epochs=0, export_weights_every_epochs=epochs,
                      export_format="npz")
    state = trainer.state
    check(trainer.model_cfg.compute_dtype == "bfloat16"
          and trainer.model_cfg.gen_channels == (256, 128, 64), exp)
    before = {net: {k: v.clone() for k, v in
                    getattr(state, net).state_dict().items()}
              for net in ("gen", "critic")}

    steps = epochs * STEPS_PER_EPOCH
    per_step = train_per_step()
    hist, counts = _fit_counted(trainer, steps, per_step, "train")
    for net in ("gen", "critic"):
        now = getattr(state, net).state_dict()
        check(any(not torch.equal(before[net][k], v) for k, v in now.items()),
              f"{net} parameters did not change")
    # JAX's gradient at the critic's pad-only taps is exactly 0, so Adam
    # leaves their weights where they started; the port's must stay too
    now = state.critic.state_dict()
    pads_kept = {f"conv{i}": bool(torch.equal(
        now[f"conv{i}.weight"][mask], before["critic"][f"conv{i}.weight"][mask]))
        for i, mask in pad_only_taps(state.critic.cfg).items()}
    print(f"[train] pad-only taps' weights bit-identical to their initial "
          f"values after Trainer.fit: {pads_kept}")
    check(pads_kept and all(pads_kept.values()),
          f"pad-only taps moved in training: {pads_kept}")
    last = {k: hist[k][-1] for k in hist}
    print(f"[train] last metrics {json.dumps(last)}")
    n_timed = TIMED_EPOCHS * STEPS_PER_EPOCH
    timed = sum(trainer.epoch_seconds[WARM_EPOCHS:])
    graphed = n_timed / timed
    exports = sorted(os.listdir(trainer.outdir))
    check(exports == sorted(["ckpt"] + [
        f"{p}_{trainer.params_str}_{epochs:04d}.npz" for p in ("gen", "disc")]),
        exports)
    check(trainer.ckpt.epochs() == [epochs], trainer.ckpt.epochs())

    # EAGER_STEPS eager steps, after two to warm up
    for _ in range(2):
        train_step_on(state, ds, draw_step_inputs(state, ds, TRAIN_BATCH,
                                                  N_DISC), exp.train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EAGER_STEPS):
        train_step_on(state, ds, draw_step_inputs(state, ds, TRAIN_BATCH,
                                                  N_DISC), exp.train)
    torch.cuda.synchronize()
    eager = EAGER_STEPS / (time.perf_counter() - t0)
    print(f"[train] graphed {graphed:.2f} fused steps/s "
          f"({graphed * TRAIN_BATCH * (N_DISC + 1):.1f} sample-updates/s; "
          f"Trainer.fit, {TIMED_EPOCHS} calls of {STEPS_PER_EPOCH} replays "
          f"in {timed:.3f} s, warm epoch {trainer.epoch_seconds[0]:.3f} s "
          f"with the warm-up and capture), eager {eager:.2f} fused steps/s "
          f"({EAGER_STEPS} steps of draw_step_inputs + train_step_on), "
          f"graphed/eager {graphed / eager:.2f}")

    # a new graphed step: its first call's peak memory (warm-up on a clone,
    # capture, replays), then a call of replays alone
    step_fn = make_train_step(trainer.model_cfg, exp.train, TRAIN_BATCH,
                              steps_per_call=PROFILE_REPLAYS)
    peaks = _step_peaks(step_fn, state, ds)
    data_bytes = ds.data.numel() * ds.data.element_size()
    check(max(peaks) < data_bytes / 2, "a train step copies the dataset")
    print(f"[train] peak memory above the resident bytes: first call "
          f"(warm-up, capture, {PROFILE_REPLAYS} replays) {peaks[0]} bytes "
          f"({peaks[0] / data_bytes:.3f} of the dataset's {data_bytes}); a "
          f"call of {PROFILE_REPLAYS} replays {peaks[1]} bytes; resident "
          f"{torch.cuda.memory_allocated()}")

    cons = _conserves(state.gen, ds, seed)
    print(f"[train] trained generator: max |sum_h frac - 1| = {cons:.3e} "
          f"over 256 samples (bound {CONSERVATION_RTOL})")

    graph_prof = _graph_kernels(
        step_fn, state, ds, per_step, f"one call of {PROFILE_REPLAYS} graphed "
        f"steps, bf16 batch {TRAIN_BATCH}", "train")

    def eager_step():
        train_step_on(state, ds, draw_step_inputs(state, ds, TRAIN_BATCH,
                                                  N_DISC), exp.train)
        torch.cuda.synchronize()

    # one eager step with K1's backward kernels, then with the plain
    # backward (the phase convolutions' cuDNN gradients) in their place
    eager = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            upsample_conv.upsample2_conv3_backward_cuda = _plain_backward
        try:
            prof = profile_breakdown(
                eager_step, f"one eager step, bf16 batch {TRAIN_BATCH}, K1 "
                f"backward by its {route}", top=6, host_top=6)
        finally:
            upsample_conv.upsample2_conv3_backward_cuda = kernel_backward
        eager[route] = None if prof is None else _eager_backward(prof)
        print(f"[train] K1 backward by its {route}, one eager step: "
              f"{json.dumps(eager[route])}")
    check(eager["kernels"] is None or not eager["kernels"]["cudnn_in_node"],
          f"cuDNN gradients inside K1's backward: {eager['kernels']}")
    k1_bwd = None if eager["kernels"] is None \
        else eager["kernels"]["node_ms"]
    print(f"[train] K1 backward device time per step (3 passes, eager "
          f"profile): {k1_bwd} ms")
    pad_grads = _pad_only_grads(state, ds, seed)
    f32 = _f32_step_check(state, ds, seed, F32_CHECK["n_disc"],
                          F32_CHECK["batch"], F32_CHECK["rtol"])
    return {"counts": counts, "graphed_steps_per_s": graphed,
            "eager_steps_per_s": eager, "step_peaks": peaks,
            "conservation": cons, "f32": f32, "pad_only_grads": pad_grads,
            "pad_only_kept": pads_kept,
            "graph_profile": {k: graph_prof[k] for k in (
                "window_ms", "busy_ms", "idle_share")},
            "k1_backward_ms": k1_bwd, "eager_profiles": eager}


def phase_f32_train(ds, seed: int, workdir: str) -> dict:
    """Trainer.fit of the flagship 16x16 in float32, as `cli train
    --f32-parity` builds it (ExperimentConfig.compute_dtype "float32", B
    32, n_disc 5), graphed, on the card-resident dataset: the kernels
    counted through the wrappers and by name in a profiled call of
    PROFILE_REPLAYS replays; steps/s over TIMED_EPOCHS calls of
    STEPS_PER_EPOCH replays; busy ms a step, K1's backward kernels' device
    ms a step and their share of busy, the idle share; the trained
    generator's conservation."""
    from prdisagg_torch.train.loop import Trainer
    from prdisagg_torch.train.wgan_gp import make_train_step

    epochs = WARM_EPOCHS + TIMED_EPOCHS
    exp = dataclasses.replace(
        _train_exp(epochs, seed, log_every_steps=STEPS_PER_EPOCH,
                   checkpoint_every_epochs=0), compute_dtype="float32")
    trainer = Trainer(exp, ds, workdir, steps_per_epoch=STEPS_PER_EPOCH,
                      plot_every_epochs=0, export_weights_every_epochs=0,
                      export_format="npz")
    check(trainer.model_cfg.compute_dtype == "float32"
          and trainer.model_cfg.gen_channels == (256, 128, 64), exp)
    per_step = train_per_step("float32")
    _, counts = _fit_counted(trainer, epochs * STEPS_PER_EPOCH, per_step,
                             "f32_train")
    timed = sum(trainer.epoch_seconds[WARM_EPOCHS:])
    graphed = TIMED_EPOCHS * STEPS_PER_EPOCH / timed
    step_fn = make_train_step(trainer.model_cfg, exp.train, TRAIN_BATCH,
                              steps_per_call=PROFILE_REPLAYS)
    prof = _graph_kernels(
        step_fn, trainer.state, ds, per_step, f"one call of "
        f"{PROFILE_REPLAYS} graphed f32 steps, batch {TRAIN_BATCH}",
        "f32_train", PROFILE_REPLAYS)
    bwd_ms = sum(ms for n, ms in prof["kernel_ms_per_step"].items()
                 if n in BACKWARD_BY_NAME)
    row = {"graphed_steps_per_s": graphed, "timed_steps":
           TIMED_EPOCHS * STEPS_PER_EPOCH, "timed_s": timed,
           "warm_epoch_s": trainer.epoch_seconds[0],
           "busy_ms_per_step": prof["busy_ms_per_step"],
           "idle_share": prof["idle_share"],
           "k1_backward_ms_per_step": bwd_ms,
           "k1_backward_share_of_busy": bwd_ms / prof["busy_ms_per_step"],
           "k1_ms_per_step": sum(
               ms for n, ms in prof["kernel_ms_per_step"].items()
               if n.startswith("k1_")),
           "conservation": _conserves(trainer.state.gen, ds, seed)}
    print("[f32_train] graphed f32 train: " + json.dumps(row))
    return {"counts": counts, **row}


def _warm_adam(state, seed: int) -> None:
    """Mid-training Adam moments in place, as the full-step parity test
    sets them (tests/test_torch_train.py): step 1, first moments 0, second
    moments 1e-2 * (1 + U[0, 1)).  From step 0 Adam's first update is about
    lr * sign(gradient), so a gradient near 0 whose sign differs between
    two runs by rounding moves a parameter by 2 lr; with these moments the
    update is linear in the gradient."""
    import torch

    g = torch.Generator(device=state.device).manual_seed(seed + 6)
    with torch.no_grad():
        for opt in (state.gen_opt, state.critic_opt):
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state[p]
                    st["step"].fill_(1.0)
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].copy_(1e-2 * (1.0 + torch.rand(
                        p.shape, generator=g, device=p.device)))


def phase_graph_check(ds, seed: int) -> dict:
    """The graphed step against eager steps from the same state (Adam's
    moments mid-training) and generator state, float32 with TF32 off,
    smoke width, dropout on: the
    draws of every replay bit for bit, the losses of every step and the
    parameters after GRAPH_CHECK_STEPS steps within 1e-4 of their scale;
    successive replays draw different rows and latents."""
    import torch

    from prdisagg_torch.core.config import TrainConfig, smoke_model_config
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import (
        clone_train_state,
        create_train_state,
    )

    mc = smoke_model_config(compute_dtype="float32")
    cfg = TrainConfig(n_disc=2, seed=seed)
    b, rtol = 8, 1e-4
    state = create_train_state(mc, cfg, device=CARD)
    _warm_adam(state, seed)
    eager = clone_train_state(state, mc, cfg, CARD)
    eager.rng.set_state(state.rng.get_state())
    made, real = [], wgan_gp.draw_step_inputs
    fields = ("real_rows", "latent", "eps", "gen_latent", "gen_rows")

    def recording(*args):
        made.append(real(*args))
        return made[-1]

    def masks(d):
        return [m for ms in (*d.masks, *d.gp_masks, d.gen_masks) for m in ms]

    step = wgan_gp.make_train_step(mc, cfg, b)
    identical, differ, loss_err = [], [], 0.0
    wgan_gp.draw_step_inputs = recording
    try:
        prev = None
        for _ in range(GRAPH_CHECK_STEPS):
            _, got = step(state, ds)
            static = made[wgan_gp.WARMUP_STEPS]
            want_draws = real(eager, ds, b, cfg.n_disc)
            identical.append(
                all(torch.equal(getattr(static, f), getattr(want_draws, f))
                    for f in fields)
                and all(torch.equal(x, y) for x, y in
                        zip(masks(static), masks(want_draws))))
            now = {f: getattr(static, f).clone() for f in fields}
            if prev is not None:
                differ.append(all(not torch.equal(prev[f], now[f])
                                  for f in ("real_rows", "latent")))
            prev = now
            want = wgan_gp.train_step_on(eager, ds, want_draws, cfg)
            g, w = got["packed"][:-1], want["packed"][:-1]
            loss_err = max(loss_err, ((g - w).abs().max()
                                      / w.abs().max()).item())
    finally:
        wgan_gp.draw_step_inputs = real
    param_err, worst = 0.0, None
    for net in ("gen", "critic"):
        a, c = getattr(state, net).state_dict(), getattr(eager, net).state_dict()
        pmax = max(v.abs().max().item() for v in c.values())
        for k in c:
            err = (a[k] - c[k]).abs().max().item() / pmax
            if worst is None or err > param_err:
                param_err, worst = err, f"{net}.{k}"
    row = {"steps": GRAPH_CHECK_STEPS, "batch": b, "n_disc": cfg.n_disc,
           "dropout": mc.dropout_rate, "adam": "mid-training moments",
           "draws_bit_identical": identical,
           "successive_replays_differ": differ,
           "rng_state_equal": bool(torch.equal(state.rng.get_state(),
                                               eager.rng.get_state())),
           "metric_err_over_scale": loss_err,
           "param_err_over_max": param_err, "worst_param": worst,
           "tolerance": rtol}
    print("[graph] graphed vs eager steps: " + json.dumps(row))
    check(all(identical) and all(differ) and row["rng_state_equal"]
          and loss_err <= rtol and param_err <= rtol,
          f"graphed and eager steps differ: {row}")
    return row


def phase_resume_check(ds, seed: int, workdir: str) -> dict:
    """Exact resume on the card at the flagship width: 2 epochs with a
    checkpoint each, a new Trainer in the same workdir resumed to epoch 3,
    against an uninterrupted 3-epoch run from the same seed.  cuDNN runs
    deterministically here, so that only the resume is under test."""
    import torch

    from prdisagg_torch.train.loop import Trainer

    kw = dict(steps_per_epoch=RESUME_STEPS, plot_every_epochs=0,
              export_weights_every_epochs=0, export_format="npz")

    def run(epochs, sub, resume=False):
        exp = _train_exp(epochs, seed, log_every_steps=RESUME_STEPS // 2,
                         checkpoint_every_epochs=1)
        tr = Trainer(exp, ds, os.path.join(workdir, sub), **kw)
        if resume:
            check(tr.maybe_resume() and tr.epoch == 2,
                  f"resume did not find epoch 2 ({tr.epoch})")
        tr.fit(progress=False)
        return tr

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full = run(3, "full")
        part = run(2, "part")
        check(part.ckpt.epochs() == [1, 2], part.ckpt.epochs())
        resumed = run(3, "part", resume=True)
    finally:
        torch.backends.cudnn.deterministic = det
    param_err = 0.0
    for net in ("gen", "critic"):
        a = getattr(resumed.state, net).state_dict()
        c = getattr(full.state, net).state_dict()
        pmax = max(v.abs().max().item() for v in c.values())
        param_err = max(param_err, max(
            (a[k] - c[k]).abs().max().item() for k in c) / pmax)
    with open(os.path.join(workdir, "full", "hist.csv")) as fa, \
            open(os.path.join(workdir, "part", "hist.csv")) as fb:
        ha, hb = fa.read(), fb.read()
    row = {"steps": resumed.state.step, "param_err_over_max": param_err,
           "hist_epochs": resumed.hist["epoch"],
           "hist_epochs_equal": resumed.hist["epoch"] == full.hist["epoch"],
           "hist_csv_identical": ha == hb, "tolerance": 1e-4}
    print("[resume] resumed vs uninterrupted: " + json.dumps(row))
    check(resumed.state.step == 3 * RESUME_STEPS and param_err <= 1e-4
          and row["hist_epochs_equal"], f"resume is not exact: {row}")
    return row


def phase_cli(seed: int, workdir: str) -> dict:
    """``python -m prdisagg_torch.cli train --synthetic`` at the flagship
    width for two short epochs, then ``--resume`` to a third: both exit 0,
    the second starts at the saved epoch, and the checkpoints, the .npz
    exports, hist.csv and run_config.json are there."""
    args = [sys.executable, "-m", "prdisagg_torch.cli", "train",
            "--synthetic", "--steps-per-epoch", str(CLI_STEPS),
            "--export-format", "npz", "--plot-every-epochs", "0",
            "--workdir", workdir, "--seed", str(seed)]
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, extra in (("train", ["--epochs", "2"]),
                        ("resume", ["--epochs", "3", "--resume"])):
        t0 = time.perf_counter()
        r = subprocess.run(args + extra, cwd=root, capture_output=True,
                           text=True, timeout=600)
        out[name] = {"rc": r.returncode,
                     "seconds": time.perf_counter() - t0,
                     "last_line": r.stdout.strip().splitlines()[-1:]}
        print(f"[cli] {name}: " + json.dumps(out[name]))
        check(r.returncode == 0, f"cli {name} failed:\n{r.stdout[-2000:]}"
              f"\n{r.stderr[-4000:]}")
        out[name]["stdout"] = r.stdout
    check("resumed at epoch 2" in out["resume"]["stdout"]
          and "finished at epoch 3" in out["resume"]["stdout"],
          out["resume"]["stdout"][-2000:])
    from prdisagg_torch.core.config import DataConfig

    outdir = os.path.join(workdir, "trained_models", "wgancp_pixelnorm")
    params = DataConfig().params_string()
    want = sorted(["ckpt"] + [f"{p}_{params}_{e:04d}.npz"
                              for p in ("gen", "disc") for e in (1, 2, 3)])
    got = sorted(os.listdir(outdir))
    ckpts = sorted(os.listdir(os.path.join(outdir, "ckpt")))
    with open(os.path.join(workdir, "hist.csv")) as fh:
        epochs = [line.rsplit(",", 1)[-1].strip()
                  for line in fh.read().splitlines()[1:]]
    print(f"[cli] exports {len(got) - 1} files, checkpoints {ckpts}, "
          f"hist.csv epochs {epochs}, run_config.json "
          f"{os.path.exists(os.path.join(workdir, 'run_config.json'))}")
    check(got == want, got)
    check(ckpts == ["epoch_00000002.pt", "epoch_00000003.pt"], ckpts)
    check(epochs == ["1", "2", "3"], epochs)
    check(os.path.exists(os.path.join(workdir, "run_config.json")),
          "no run_config.json")
    return {k: {kk: vv for kk, vv in v.items() if kk != "stdout"}
            for k, v in out.items()}


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _launches(fn, reps: int = 3):
    """Device events (kernels, copies, memsets) one call of fn launches,
    from a torch.profiler trace of `reps` calls, each synchronised and
    followed by a pause of LAUNCH_GAP_S, so that a call's events form one
    group in time.  CUPTI now and then drops events from a trace (whole
    calls' worth late in a long run), and never adds one, so the count is
    the largest group.  A trace with no device event is taken again, up to
    DEVICE_TRACE_TRIES traces; then the count is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
                time.sleep(LAUNCH_GAP_S)
        starts = sorted((e.time_range.start, e.time_range.end)
                        for e in _device_events(prof))
        if not starts:
            continue
        sizes, end = [0], starts[0][1]
        for start, stop in starts:
            if start - end > LAUNCH_GAP_S * 1e6 / 2:  # us
                sizes.append(0)
            sizes[-1] += 1
            end = max(end, stop)
        return max(sizes)
    print(f"[variants] the profiler saw no device activity in "
          f"{DEVICE_TRACE_TRIES} traces: launches not measured")
    return None


def _f32_layers(gen, seed: int) -> dict:
    """The float32 latent projection (in float64 above PROJ_F32_MAX_K
    inputs) and head (a C -> 27 product and a tree of shifted sums) of the
    64x64 generator module `gen` on the card: device ms (`queued_ms`) and
    device events a call at PROJ_BATCHES and HEAD_SHAPES, beside one float32 F.linear and
    one cuDNN F.conv3d with TF32 off (what the layers ran before) and the
    float32 projection in chunks of 1,024 along K, and each one's
    distance from a float64 product of the same operands on the card as a
    share of its largest output, held to the CPU tests' bounds.  The
    inputs are those of the CPU tests: latents N(0, 1) and conditions
    U(0, 1); leaky-ReLU'd N(0, 1) activations and a N(0, 0.3) head."""
    import torch
    import torch.nn.functional as F

    from prdisagg_torch.models.generator import (
        head_conv_f32,
        latent_projection,
    )
    from prdisagg_torch.ops.core import full_f32

    def share(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    def chunked(x, w, b, n=1024):
        """f32 partial products over chunks of n along K, added in order
        (the design the float64 projection replaced)."""
        acc = x[:, :n] @ w[:, :n].T
        for lo in range(n, x.shape[1], n):
            acc.addmm_(x[:, lo:lo + n], w[:, lo:lo + n].T)
        return acc.add_(b)

    dev, out = gen.latent_proj.weight.device, {}
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    w, b = gen.latent_proj.weight, gen.latent_proj.bias
    k = w.shape[1]
    with torch.no_grad(), full_f32():
        for name, n in PROJ_BATCHES:
            x = torch.cat([torch.randn(n, gen.cfg.latent_dim, generator=g,
                                       device=dev),
                           torch.rand(n, k - gen.cfg.latent_dim, generator=g,
                                      device=dev)], 1)
            ms = queued_ms(lambda: latent_projection(x, w, b), 5)
            plain_ms = queued_ms(lambda: F.linear(x, w, b), 5)
            chunk_ms = queued_ms(lambda: chunked(x, w, b), 5)
            want = x.double() @ w.double().T + b.double()
            got = latent_projection(x, w, b)
            row = {"batch": n, "k": k, "n": w.shape[0], "ms": ms,
                   "launches": _launches(lambda: latent_projection(x, w, b)),
                   "f_linear_ms": plain_ms, "f_linear_launches": _launches(
                       lambda: F.linear(x, w, b)), "chunk_1024_ms": chunk_ms,
                   "f64_share": share(got, want),
                   "f_linear_f64_share": share(F.linear(x, w, b), want),
                   "chunk_1024_f64_share": share(chunked(x, w, b), want),
                   "repeat_bit_equal": torch.equal(
                       got, latent_projection(x, w, b))}
            del x, want, got
            print(f"[variants] f32 latent projection, 64x64 {name}: "
                  + json.dumps(row))
            check(row["f64_share"] <= PROJ_F64_BOUND
                  and row["repeat_bit_equal"], f"f32 projection: {row}")
            out[f"proj_{name}"] = row
        gh = torch.Generator(device=dev).manual_seed(seed + 12)
        for name, n, nd in HEAD_SHAPES:
            c = gen.cfg.gen_channels[-1]
            x = F.leaky_relu(torch.randn(n, gen.cfg.nhours, nd, nd, c,
                                         generator=gh, device=dev), 0.2)
            hw = 0.3 * torch.randn(1, c, 3, 3, 3, generator=gh, device=dev)
            hb = torch.randn(1, generator=gh, device=dev)
            head = lambda: head_conv_f32(x, hw, hb)  # noqa: E731
            conv = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), hw,  # noqa: E731
                                    hb, padding=1)
            xs = x[:HEAD_F64_BATCH]
            want = F.conv3d(xs.double().permute(0, 4, 1, 2, 3), hw.double(),
                            hb.double(), padding=1)
            got = head_conv_f32(x, hw, hb)
            row = {"batch": n, "ndomain": nd, "c": c,
                   "ms": queued_ms(head, 3), "launches": _launches(head),
                   "conv3d_ms": queued_ms(conv, 2),
                   "conv3d_launches": _launches(conv, 2),
                   "f64_share": share(got[:HEAD_F64_BATCH], want),
                   "conv3d_f64_share": share(F.conv3d(
                       xs.permute(0, 4, 1, 2, 3), hw, hb, padding=1), want),
                   "repeat_bit_equal": torch.equal(
                       got, head_conv_f32(x, hw, hb))}
            del x, xs, want, got
            torch.cuda.empty_cache()
            print(f"[variants] f32 head conv, {name}: " + json.dumps(row))
            check(row["f64_share"] <= HEAD_F64_BOUND
                  and row["repeat_bit_equal"], f"f32 head: {row}")
            out[f"head_{name}"] = row
    return out


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn, the sum of the durations of
    the kernels and copies it launched, from a torch.profiler trace of
    `reps` calls: unlike CUDA events around one call, it does not count the
    time the device waits for the host to launch a microsecond kernel.
    A trace that comes back with no device event at all (CUPTI now and then
    delivers none for a trace of a few microsecond kernels) is taken again,
    up to DEVICE_TRACE_TRIES traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = _device_events(prof)
        if dev:
            return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    raise AssertionError(f"the profiler saw no device activity in "
                         f"{DEVICE_TRACE_TRIES} traces")


def profile_breakdown(fn, what: str, top: int = 8, host_top: int = 0):
    """Device time by kernel and the device's idle share over one call of
    fn, from a torch.profiler trace; prints "not measured" and returns None
    when the trace holds no device activity.  With `host_top`, also the
    host operators with the most self time on the CPU.  Returns the window
    and busy milliseconds, the idle share, the kernels' event counts and
    milliseconds by name, and the profile itself."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = list(prof.events())
    dev = _device_events(prof)
    if not dev:
        print(f"[profile] {what}: no device activity in the trace; "
              "breakdown not measured")
        return None
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    by_name: dict = {}
    counts: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        counts[e.name] = counts.get(e.name, 0) + 1
    print(f"[profile] {what}: window {window / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / window:.3f}, "
          f"{len(dev)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile]   {us / 1e3:9.3f} ms  {us / busy:6.1%}  "
              f"{counts[name]:6d}x  {name[:90]}")
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        for a in ops[:host_top]:
            print(f"[profile]   host {a.self_cpu_time_total / 1e3:9.3f} ms "
                  f"self, {a.count:5d} calls  {a.key[:80]}")
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window,
            "ms_by_name": {k: v / 1e3 for k, v in by_name.items()},
            "count_by_name": counts, "prof": prof}


def _random_generator_tree(cfg, seed: int) -> dict:
    """Flagship generator weights in the JAX/Keras layout, N(0, 0.02)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    gd, gh, gw = cfg.latent_grid
    in_dim = cfg.latent_dim + cfg.ndomain ** 2 * cfg.n_cond_channels
    shapes = {"latent_proj": (in_dim, cfg.base_channels * gd * gh * gw)}
    cin = cfg.base_channels
    for i, ch in enumerate(cfg.gen_channels):
        shapes[f"conv{i}"] = (3, 3, 3, cin, ch)
        cin = ch
    shapes["head"] = (3, 3, 3, cin, 1)
    return {name: {"kernel": (cfg.init_stddev * rng.randn(*s)).astype("f4"),
                   "bias": (cfg.init_stddev * rng.randn(s[-1])).astype("f4")}
            for name, s in shapes.items()}


def _conservation_err(scen, cond) -> float:
    import numpy as np

    return float(np.abs(scen.sum(axis=-3) - cond).max() / cond.max())


def phase_slice(seed: int, workdir: str) -> dict:
    import numpy as np
    import torch

    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import ModelConfig
    from prdisagg_torch.ops import core, upsample_conv

    cfg = ModelConfig(compute_dtype="float32")
    tree = _random_generator_tree(cfg, seed)
    npz = os.path.join(workdir, "gen_flagship.npz")
    np.savez(npz, **{f"params/{layer}/{kind}": arr
                     for layer, d in tree.items() for kind, arr in d.items()})
    gen = PretrainedGenerator.from_npz(npz, seed=seed)
    check(gen.cfg == cfg, gen.cfg)
    rng = np.random.RandomState(seed + 1)
    cond = rng.gamma(0.6, 12.0, (16, 16)).astype("f4")  # daily sums, mm

    torch.cuda.synchronize()
    reset_k1_counts()
    pn_before = core.pixel_norm_launches
    scen = gen.generate_scenarios(cond, SCENARIOS)
    launches, by_variant = (upsample_conv.launches,
                            dict(upsample_conv.launches_by_variant))
    pn_launches = core.pixel_norm_launches - pn_before
    print(f"[slice] main path: pixel_norm_leaky launched {pn_launches} "
          f"times")
    check(pn_launches == 3, f"expected 3 pixel-norm kernel launches, got "
          f"{pn_launches}")
    print(f"[slice] main path: generate_scenarios(cond, {SCENARIOS}) "
          f"launched the kernel {launches} times {by_variant} (max_batch "
          f"{gen.max_batch})")
    check(launches == 3
          and by_variant == k1_forward_expected("float32", [SCENARIOS]),
          f"expected 3 halo_f32 kernel launches, got {by_variant}")
    check(scen.shape == (SCENARIOS, 24, 16, 16), scen.shape)
    check(np.isfinite(scen).all(), "non-finite scenarios")
    cons = _conservation_err(scen, cond)
    print(f"[slice] shape {scen.shape} finite; max |sum_h - cond| / max(cond)"
          f" = {cons:.3e} (bound {CONSERVATION_RTOL})")
    check(cons <= CONSERVATION_RTOL, f"conservation error {cons}")

    # the same weights and latents through the CPU path (plain PyTorch)
    lat = rng.randn(8, cfg.latent_dim).astype("f4")
    cpu = PretrainedGenerator.from_npz(npz, device="cpu")
    want = cpu.generate_scenarios(cond, 8, latent=lat)
    got = gen.generate_scenarios(cond, 8, latent=lat)
    cpu_err = float(np.abs(got - want).max())
    print(f"[slice] card vs CPU on 8 scenarios: max |diff| = {cpu_err:.3e} mm"
          f" (bound 1e-5 * max(cond) = {1e-5 * cond.max():.3e})")
    check(cpu_err <= 1e-5 * cond.max(), f"card vs CPU differ by {cpu_err}")

    result = {"launches": launches, "by_variant": by_variant,
              "pixel_norm_launches": pn_launches,
              "conservation": cons, "cpu_err": cpu_err,
              "npz": npz, "gen": gen, "cond": cond}
    for n in (SCENARIOS, gen.max_batch):
        t0 = time.perf_counter()
        gen.generate_scenarios(cond, n)  # returns host numpy: synchronous
        first = time.perf_counter() - t0
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            gen.generate_scenarios(cond, n)
            walls.append(time.perf_counter() - t0)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen.generate_scenarios(cond, n)
        peak = torch.cuda.max_memory_allocated() - base
        wall = statistics.median(walls)
        row = {"n": n, "scenarios_per_s": n / wall, "median_s": wall,
               "first_s": first, "peak_bytes": peak,
               "peak_bytes_per_scenario": peak / n}
        print("[slice] f32 " + json.dumps(row))
        result[f"f32_{n}"] = row
    profile_breakdown(lambda: gen.generate_scenarios(cond, SCENARIOS),
                      f"f32 generate_scenarios(cond, {SCENARIOS})")
    gen16 = PretrainedGenerator.from_npz(
        npz, cfg=ModelConfig(compute_dtype="bfloat16"), seed=seed)
    reset_k1_counts()
    scen16 = gen16.generate_scenarios(cond, SCENARIOS)
    check(upsample_conv.launches_by_variant == fast_only(3),
          f"bf16 forward: {upsample_conv.launches_by_variant}")
    cons16 = _conservation_err(scen16, cond)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        gen16.generate_scenarios(cond, SCENARIOS)
        walls.append(time.perf_counter() - t0)
    print(f"[slice] bf16 generate_scenarios(cond, {SCENARIOS}): "
          f"{SCENARIOS / statistics.median(walls):.1f} scenarios/s, "
          f"conservation {cons16:.3e}")
    check(np.isfinite(scen16).all() and cons16 <= CONSERVATION_RTOL,
          f"bf16 scenarios: conservation error {cons16}")
    return result


def phase_serve(sl: dict) -> None:
    import numpy as np

    from prdisagg_torch.api.server import ScenarioServer, request, scenarios_array
    from prdisagg_torch.ops import upsample_conv

    gen, cond, npz = sl["gen"], sl["cond"], sl["npz"]
    os.makedirs("build", exist_ok=True)  # short relative path: AF_UNIX limit
    sock = os.path.join("build", f"chip_smoke-{os.getpid()}.sock")
    server = ScenarioServer(gen, sock)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    stack = np.stack([cond * (1 + 0.1 * i) for i in range(8)])
    reset_k1_counts()
    try:
        answers = {
            "ping": request(sock, {"cmd": "ping"}),
            "info": request(sock, {"cmd": "info"}),
            "map_b64": request(sock, {"cond": cond.tolist(), "n_scenarios": 16,
                                      "encoding": "b64"}),
            "stack": request(sock, {"cond": stack.tolist(), "n_scenarios": 4}),
            "reload": request(sock, {"cmd": "reload", "weights": npz}),
            "stats": request(sock, {"cmd": "stats"}),
            "shutdown": request(sock, {"cmd": "shutdown"}),
        }
    finally:
        server.shutdown()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    for name, resp in answers.items():
        short = {k: v for k, v in resp.items() if k not in (
            "scenarios", "scenarios_b64")}
        print(f"[serve] {name}: {json.dumps(short)}")
        check(resp.get("ok") is True, (name, resp))
    one = scenarios_array(answers["map_b64"])
    many = scenarios_array(answers["stack"])
    check(one.shape == (16, 24, 16, 16) and many.shape == (8, 4, 24, 16, 16),
          (one.shape, many.shape))
    cons = max(_conservation_err(one, cond),
               max(_conservation_err(many[i], stack[i]) for i in range(8)))
    print(f"[serve] 7/7 responses ok; conservation {cons:.3e}; kernel "
          f"launches {upsample_conv.launches} for 2 scenario requests")
    check(cons <= CONSERVATION_RTOL, f"conservation error {cons}")
    check(upsample_conv.launches == 6
          and upsample_conv.launches_by_variant == k1_forward_expected(
              "float32", [16, 8 * 4]),
          f"expected 6 main-path kernel launches, got "
          f"{upsample_conv.launches_by_variant}")


def _eval_item(name: str, row: dict, phase: str = "eval") -> dict:
    print(f"[{phase}] {name}: " + json.dumps(row))
    return row


@contextlib.contextmanager
def _tf32_on():
    """TF32 allowed for every cuBLAS and cuDNN float32 call, as code run
    before may leave it; the port's contractions must turn it off
    themselves."""
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def _crps_f64_check(pg, reals, seed: int) -> dict:
    """CRPS of CRPS_F64["samples"] GAN ensembles of EVAL_MEMBERS members on
    the card with TF32 allowed globally, against the same ensembles in
    float64 on the CPU: the area-mean rows within the relative bound.  Also
    the spread taken as a GEMM with TF32 on, the gap the port's guard
    closes."""
    import torch

    from prdisagg_torch.ops.stats import crps_ensemble

    n, rtol = CRPS_F64["samples"], CRPS_F64["rtol"]
    g = torch.Generator(device=reals.device).manual_seed(seed + 8)
    rows = {"card": [], "f64": [], "tf32": []}
    with _tf32_on(), torch.inference_mode():
        for real in reals[:n]:
            dsum = real.sum(dim=0)
            cond = (dsum / pg.norm_scale)[None, ..., None]
            lat = torch.randn((EVAL_MEMBERS, pg.cfg.latent_dim), generator=g,
                              device=reals.device)
            ens = pg.predict_fractions(
                lat, cond.expand(EVAL_MEMBERS, *cond.shape[1:]))[..., 0] * dsum
            rows["card"].append(crps_ensemble(real, ens).mean(dim=(1, 2)))
            rows["f64"].append(crps_ensemble(real.double().cpu(),
                                             ens.double().cpu()).mean(
                dim=(1, 2)))
            # the spread contraction as a GEMM with TF32 allowed
            m = ens.shape[0]
            xs = torch.sort(ens.reshape(m, -1).T, dim=-1).values
            w = 2.0 * torch.arange(m, device=xs.device) - m + 1.0
            spread = (xs @ w[:, None].expand(m, 8))[:, 0] / (m * m)
            term1 = (ens - real[None]).abs().mean(dim=0).reshape(-1)
            rows["tf32"].append((term1 - spread).reshape(real.shape)
                                .mean(dim=(1, 2)))
    card, f64, tf32 = (torch.stack(rows[k]).double().cpu()
                       for k in ("card", "f64", "tf32"))
    err = ((card - f64).abs() / f64.abs()).max().item()
    err_tf32 = ((tf32 - f64).abs() / f64.abs()).max().item()
    row = {"samples": n, "members": EVAL_MEMBERS,
           "max_rel_err_tf32_off": err, "max_rel_err_tf32_gemm": err_tf32,
           "mean_crps_f64": f64.mean().item(), "rtol": rtol}
    check(err <= rtol, f"card CRPS differs from float64: {row}")
    return _eval_item("crps card vs float64", row)


def _lsd_f64_check(sp_a, sp_b) -> dict:
    """pairwise_lsd of a LSD_F64["spectra"] block on the card with TF32
    allowed globally, against the direct per-pair float64 form on the CPU,
    within the bound of the block's largest distance; also the same GEMM
    expansion with TF32 on."""
    import torch

    from prdisagg_torch.ops.stats import pairwise_lsd

    n, rtol = LSD_F64["spectra"], LSD_F64["rtol"]
    a, b = sp_a[:n], sp_b[:n]
    nbins = a.shape[-1]
    with _tf32_on():
        card = pairwise_lsd(a, b).double().cpu()
        la, lb = 10.0 * torch.log10(a), 10.0 * torch.log10(b)
        center = la.mean(dim=0)
        la, lb = la - center, lb - center
        d2 = ((la * la).sum(-1)[:, None] + (lb * lb).sum(-1)[None]
              - 2.0 * la @ lb.T)
        tf32 = (torch.sqrt(torch.clamp(d2, min=0.0)) / nbins).double().cpu()
    la64 = 10.0 * torch.log10(a.double().cpu())
    lb64 = 10.0 * torch.log10(b.double().cpu())
    f64 = torch.sqrt(((la64[:, None] - lb64[None]) ** 2).sum(-1)) / nbins
    scale = f64.abs().max().item()
    err = (card - f64).abs().max().item() / scale
    row = {"block": [n, n], "bins": nbins,
           "max_err_over_max_tf32_off": err,
           "max_rel_err_tf32_off": ((card - f64).abs() / f64).max().item(),
           "max_err_over_max_tf32_gemm":
               (tf32 - f64).abs().max().item() / scale,
           "max_distance": scale, "rtol": rtol}
    check(err <= rtol, f"card LSD differs from float64: {row}")
    return _eval_item("lsd card vs float64", row)


def _median_check(sp_gen, sp_real) -> dict:
    """The device reduction's median against np.median of the full
    reduction's population at n = MEDIAN_CHECK["n"] (24 spectra a
    sample)."""
    import numpy as np

    from prdisagg_torch.ops.stats import (
        pairwise_lsd_offdiag,
        pairwise_lsd_summary,
    )

    m, rtol = 24 * MEDIAN_CHECK["n"], MEDIAN_CHECK["rtol"]
    row = {"n": MEDIAN_CHECK["n"], "rtol": rtol}
    for name, a, b in (("gen", sp_gen[:m], sp_gen[:m]),
                       ("between_gen_real", sp_gen[:m], sp_real[:m])):
        s = pairwise_lsd_summary(a, b)
        full = pairwise_lsd_offdiag(a, b)
        finite = full[np.isfinite(full)]
        want = float(np.median(finite))
        row[name] = {"device_median": s["median"], "full_median": want,
                     "rel_err": abs(s["median"] - want) / want,
                     "n_valid": s["n_valid"], "full_finite": len(finite)}
        check(s["n_valid"] == len(finite)
              and row[name]["rel_err"] <= rtol, f"medians differ: {row}")
    return _eval_item("lsd device vs full median", row)


def _eval_cli(npz: str, reals, baseline, workdir: str) -> dict:
    """``cli evaluate --smoke --no-plots`` on the synthetic dataset and
    ``cli crps`` on the eval phase's real samples and baseline patches, as
    two subprocesses run side by side: both exit 0 and write their
    artifacts."""
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(workdir, exist_ok=True)
    real, base = (os.path.join(workdir, f"{n}.npy") for n in ("real", "base"))
    np.save(real, reals)
    np.save(base, baseline)
    crps_out = os.path.join(workdir, "crps")
    cmds = {
        "evaluate": ["evaluate", "--synthetic", "--weights", npz, "--smoke",
                     "--no-plots", "--workdir", workdir],
        "crps": ["crps", "--weights", npz, "--real", real, "--baseline", base,
                 "--n-members", str(EVAL_MEMBERS),
                 "--n-samples", str(CLI_CRPS["samples"]), "--out", crps_out],
    }
    t0 = time.perf_counter()
    procs, ends = {}, {}
    try:
        for name, args in cmds.items():
            with open(os.path.join(workdir, f"{name}.out"), "w") as fo, \
                    open(os.path.join(workdir, f"{name}.err"), "w") as fe:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "prdisagg_torch.cli", *args],
                    cwd=root, stdout=fo, stderr=fe, text=True)
        while len(ends) < len(procs):
            check(time.perf_counter() - t0 < 600, "cli runs timed out")
            for name, proc in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name, proc in procs.items():
        with open(os.path.join(workdir, f"{name}.out")) as fo, \
                open(os.path.join(workdir, f"{name}.err")) as fe:
            stdout, stderr = fo.read(), fe.read()
        out[name] = _eval_item(f"cli {name}", {
            "rc": proc.returncode, "seconds": ends[name],
            "last_line": stdout.strip().splitlines()[-1:]})
        check(proc.returncode == 0, f"cli {name} failed:\n{stdout[-2000:]}"
              f"\n{stderr[-4000:]}")
    written = os.path.join(workdir, "data", "real_samples.npy")
    plotdir = os.path.join(workdir, "plots_generated_wgancp_pixelnorm")
    pvals = [n for n in os.listdir(plotdir) if n.endswith(".txt")]
    check(np.load(written).shape == (50, 24, 16, 16) and len(pvals) == 2,
          (np.load(written).shape, pvals))
    with open(os.path.join(crps_out, "crps_results.json")) as fh:
        out["crps"]["analysis"] = json.load(fh)
    check(os.path.exists(os.path.join(
        crps_out, f"crps_results_n_sample{CLI_CRPS['samples']}.pkl")),
        "no crps pickle")
    return out


def phase_eval(ds, sl: dict, seed: int, workdir: str) -> dict:
    """Evaluation of the flagship float32 generator of the slice phase on
    the card-resident dataset, through the eval entry points at the
    reference protocol's sizes, plots off: crps_gan, crps_random_baseline,
    Evaluator phases 2 and 5 and the n = 1000 LSD summary (the counted
    run), then the float64 and median checks and the two CLI
    subprocesses."""
    import importlib.util

    import numpy as np
    import torch

    from prdisagg_torch.core.config import ExperimentConfig
    from prdisagg_torch.eval import Evaluator, daily_cycle_correlation
    from prdisagg_torch.eval.crps import crps_gan, crps_random_baseline
    from prdisagg_torch.eval.lsd import run_lsd_evaluation, spectra_of_fields
    from prdisagg_torch.ops import core, gather, upsample_conv
    from prdisagg_torch.ops.stats import pairwise_lsd_summary

    check(importlib.util.find_spec("scipy") is not None,
          "phase 5's KS test and the CRPS analysis need scipy, which is not "
          "installed")
    import scipy.stats  # noqa: F401 - imported here, not in phase 5's time
    pg = sl["gen"]
    check(pg.cfg.compute_dtype == "float32", pg.cfg)
    g = torch.Generator(device=ds.device).manual_seed(seed + 7)
    # cuDNN's plans for the head conv at batch 500, outside the counted run
    crps_gan(pg, ds.sample_patches_raw(1, g), n_members=EVAL_MEMBERS,
             member_batch=EVAL_MEMBER_BATCH)
    ev = Evaluator(ExperimentConfig(data=ds.cfg), ds, pg,
                   workdir=os.path.join(workdir, "evaluator"))
    items: dict = {}

    def timed(name, fn):
        k1, k2 = upsample_conv.launches, gather.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        items[name] = {"seconds": time.perf_counter() - t0,
                       "k1_launches": upsample_conv.launches - k1,
                       "k2_launches": gather.launches - k2}
        return r

    # conservation of every field the Evaluator generates
    frac_err = []
    predict = pg.predict_fractions

    def recording(latent, cond):
        out = predict(latent, cond)
        frac_err.append((out.sum(dim=1) - 1.0).abs().max().item())
        return out

    torch.cuda.synchronize()
    reset_k1_counts()
    gather.launches = 0
    pg.predict_fractions = recording
    try:
        reals = timed("draw_reals", lambda: ds.sample_patches_raw(
            EVAL_SAMPLES, g))
        gan = timed("crps_gan", lambda: crps_gan(
            pg, reals, n_members=EVAL_MEMBERS, seed=seed,
            member_batch=EVAL_MEMBER_BATCH))
        ens = timed("draw_baseline", lambda: ds.sample_patches_raw(
            EVAL_BASELINE, g))
        rnd = timed("crps_random_baseline", lambda: crps_random_baseline(
            reals, ens, device=ds.device))
        res = timed("sample_statistics", lambda: ev.sample_statistics(
            n_samples=EVAL_N, make_plots=False))
        pvals = timed("conditional_distribution_check",
                      lambda: ev.conditional_distribution_check(
                          n_pairs=EVAL_KS_PAIRS, n_members=EVAL_KS_MEMBERS,
                          make_plots=False))
        sp_gen, sp_real = timed("spectra", lambda: (
            spectra_of_fields(res["generated_samples"], device=ds.device),
            spectra_of_fields(res["real_samples"], device=ds.device)))
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        summary = timed("pairwise_lsd_summary", lambda: pairwise_lsd_summary(
            sp_gen, sp_real))
        lsd_peak = torch.cuda.max_memory_allocated() - resident
        lsd = timed("run_lsd_evaluation", lambda: run_lsd_evaluation(
            res["real_samples"], res["generated_samples"], n_samples=EVAL_N,
            outdir=os.path.join(workdir, "lsd"), make_plot=False,
            reduction="device", device=ds.device))
    finally:
        del pg.predict_fractions
    counts = {"upsample2_conv3": upsample_conv.launches,
              "upsample2_conv3_by_variant": dict(
                  upsample_conv.launches_by_variant),
              "gather_patches": gather.launches,
              "pixel_norm_leaky": core.pixel_norm_launches}

    want = {"draw_reals": (0, 1),
            "crps_gan": (3 * EVAL_MEMBERS // EVAL_MEMBER_BATCH
                         * EVAL_SAMPLES, 0),
            "draw_baseline": (0, 1), "crps_random_baseline": (0, 0),
            "sample_statistics": (3 * -(-EVAL_N // 500), -(-EVAL_N // 500)),
            "conditional_distribution_check": (3 * 2 * EVAL_KS_PAIRS,
                                               2 * EVAL_KS_PAIRS),
            "spectra": (0, 0), "pairwise_lsd_summary": (0, 0),
            "run_lsd_evaluation": (0, 0)}
    got = {k: (v["k1_launches"], v["k2_launches"]) for k, v in items.items()}
    print(f"[eval] main path: launches by item (K1, K2) {got}, in all "
          f"{counts}")
    check(got == want, f"eval launches {got}, expected {want}")
    check(main_only(counts["upsample2_conv3_by_variant"],
                    counts["upsample2_conv3"]), counts)

    t = items["crps_gan"]["seconds"]
    _eval_item("crps_gan", {
        "samples": EVAL_SAMPLES, "members": EVAL_MEMBERS,
        "member_batch": EVAL_MEMBER_BATCH, "seconds": t,
        "samples_per_s": EVAL_SAMPLES / t,
        "k1_launches": items["crps_gan"]["k1_launches"],
        "mean_crps": float(gan.mean())})
    check(gan.shape == (EVAL_SAMPLES, 24) and np.isfinite(gan).all(),
          "crps_gan: bad rows")
    _eval_item("crps_random_baseline", {
        "samples": EVAL_SAMPLES, "ensemble": EVAL_BASELINE,
        "seconds": items["crps_random_baseline"]["seconds"],
        "k2_launches_for_the_ensemble": items["draw_baseline"]["k2_launches"],
        "mean_crps": float(rnd.mean())})
    check(rnd.shape == (EVAL_SAMPLES, 24) and np.isfinite(rnd).all()
          and (rnd >= -1e-6).all(), "crps_random_baseline: bad rows")
    t = items["sample_statistics"]["seconds"]
    corr = daily_cycle_correlation(res)
    _eval_item("sample_statistics", {
        "samples": EVAL_N, "seconds": t, "samples_per_s": EVAL_N / t,
        "k1_launches": items["sample_statistics"]["k1_launches"],
        "k2_launches": items["sample_statistics"]["k2_launches"],
        "daily_cycle_correlation": corr})
    check(res["generated_samples"].shape == (EVAL_N, 24, 16, 16)
          and np.isfinite(res["generated_samples"]).all()
          and np.isfinite(corr), "sample_statistics: bad output")
    _eval_item("conditional_distribution_check", {
        "pairs": EVAL_KS_PAIRS, "members": EVAL_KS_MEMBERS,
        "seconds": items["conditional_distribution_check"]["seconds"],
        "k2_launches": items["conditional_distribution_check"]["k2_launches"],
        "min_p": [float(p.min()) for p in pvals]})
    check(len(pvals) == EVAL_KS_PAIRS
          and all(p.shape == (24,) and ((p >= 0) & (p <= 1)).all()
                  for p in pvals), "bad KS p-values")
    cons = max(frac_err)
    _eval_item("conservation", {
        "fields_checked": EVAL_N + 2 * EVAL_KS_PAIRS * EVAL_KS_MEMBERS,
        "max_abs_sum_frac_minus_1": cons, "bound": CONSERVATION_RTOL})
    check(cons <= CONSERVATION_RTOL, f"conservation {cons}")
    _eval_item("pairwise_lsd_summary", {
        "n": EVAL_N, "spectra": [len(sp_gen), len(sp_real)],
        "seconds": items["pairwise_lsd_summary"]["seconds"],
        "peak_bytes": lsd_peak, "median": summary["median"],
        "n_valid": summary["n_valid"],
        "run_lsd_evaluation_seconds": items["run_lsd_evaluation"]["seconds"],
        "medians": lsd.medians,
        "spectra_seconds": items["spectra"]["seconds"]})
    check(summary["n_valid"] > 0 and np.isfinite(summary["median"])
          and all(np.isfinite(v) for v in lsd.medians.values()),
          "LSD summary: no finite median")
    profile_breakdown(
        lambda: crps_gan(pg, reals[:2], n_members=EVAL_MEMBERS,
                         member_batch=EVAL_MEMBER_BATCH),
        f"crps_gan, 2 samples x {EVAL_MEMBERS} members")
    profile_breakdown(lambda: pairwise_lsd_summary(sp_gen, sp_real),
                      f"pairwise_lsd_summary at n = {EVAL_N}", host_top=4)

    checks = {"crps_f64": _crps_f64_check(pg, reals, seed),
              "lsd_f64": _lsd_f64_check(sp_gen, sp_real),
              "median": _median_check(sp_gen, sp_real)}
    # the CLI's subprocesses run later, beside the other subprocess
    # phases (main)
    cli_args = (sl["npz"], reals.cpu().numpy(),
                ens[:CLI_CRPS["baseline"]].cpu().numpy(),
                os.path.join(workdir, "cli"))
    return {"counts": counts, "items": items, "conservation": cons,
            "daily_cycle_correlation": corr, "lsd_peak_bytes": lsd_peak,
            "cli_args": cli_args, **checks}


def _rainfarm_checks(batch0: str, slopes0, daily, seed: int) -> dict:
    """Outside the counted run: the estimators on the CPU against the card
    on the same calibration batch (both float64), and downscale_from_phase
    and downscale_spatial_from_phase on the card against the CPU on
    identical phases."""
    import numpy as np
    import torch

    from prdisagg_torch.baselines.rainfarm import core

    batch = torch.from_numpy(np.load(batch0))
    cpu = (core.estimate_alpha(batch), core.estimate_beta(batch))
    slope_err = max(abs(c - g) / abs(c) for c, g in zip(cpu, slopes0))
    out = {"estimators": _eval_item("estimators card vs cpu", {
        "card": list(slopes0), "cpu": list(cpu), "max_rel_err": slope_err,
        "bound": RAINFARM_CHECK["slope_rtol"]}, "rainfarm")}
    check(slope_err <= RAINFARM_CHECK["slope_rtol"],
          f"estimators: card and CPU differ by {slope_err}")
    g = torch.Generator(device=daily.device).manual_seed(seed + 12)
    alpha, beta = slopes0
    m, ds_f = RAINFARM_CHECK["members"], RAINFARM_CHECK["ds_factor"]
    cases = {
        "downscale_from_phase": (
            lambda p, ph: core.downscale_from_phase(p, alpha, beta, ph),
            daily[0], torch.rand((m, 24, *daily.shape[1:]), generator=g,
                                 device=daily.device)),
        f"downscale_spatial ds_factor {ds_f}": (
            lambda p, ph: core.downscale_spatial_from_phase(p, alpha, ds_f,
                                                            ph),
            daily[1], torch.rand((m, *(ds_f * s for s in daily.shape[1:])),
                                 generator=g, device=daily.device))}
    with _tf32_on():
        for name, (fn, p, ph) in cases.items():
            got = fn(p, ph).cpu().numpy()
            want = fn(p.cpu(), ph.cpu()).numpy()
            err = float(np.abs(got - want).max() / np.abs(want).max())
            out[name] = _eval_item(f"{name} card vs cpu", {
                "shape": list(got.shape), "max_abs_err_over_max": err,
                "bound": RAINFARM_CHECK["rtol"]}, "rainfarm")
            check(np.isfinite(got).all() and err <= RAINFARM_CHECK["rtol"],
                  f"{name}: card and CPU differ by {err}")
    return out


def phase_rainfarm(ds, sl: dict, seed: int, workdir: str) -> dict:
    """RainFARM on the card-resident dataset (the counted run): calibrate
    at RainFarmConfig's defaults (K2 draws the 10 x 5000 patches),
    RAINFARM_SAMPLES real test patches drawn by K2, crps_rainfarm on them
    at RAINFARM_MEMBERS members, generate_for_daily_sums of their daily
    sums, and the three-arm CRPS protocol (the slice phase's generator, the
    repeat-0 calibration batch as the random baseline) on EVAL_SAMPLES of
    them; then the card-vs-CPU checks."""
    import numpy as np
    import torch

    from prdisagg_torch.baselines.rainfarm.pipeline import (
        calibrate,
        crps_rainfarm,
        generate_for_daily_sums,
    )
    from prdisagg_torch.core.config import RainFarmConfig
    from prdisagg_torch.eval.crps import run_crps_evaluation
    from prdisagg_torch.ops import core, gather, upsample_conv

    cfg = RainFarmConfig()
    calib_dir = os.path.join(workdir, "calibration")
    g = torch.Generator(device=ds.device).manual_seed(seed + 11)
    items: dict = {}

    def timed(name, fn):
        k1, k2 = upsample_conv.launches, gather.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        items[name] = {"seconds": time.perf_counter() - t0,
                       "k1_launches": upsample_conv.launches - k1,
                       "k2_launches": gather.launches - k2}
        return r

    torch.cuda.synchronize()
    reset_k1_counts()
    gather.launches = 0
    slopes = timed("calibrate", lambda: calibrate(ds, cfg, outdir=calib_dir))
    reals = timed("draw_reals", lambda: ds.sample_patches_raw(
        RAINFARM_SAMPLES, g))
    alpha, beta = slopes[0]
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    crps = timed("crps_rainfarm", lambda: crps_rainfarm(
        reals, alpha, beta, cfg, n_members=RAINFARM_MEMBERS, seed=seed,
        device=ds.device))
    crps_peak = torch.cuda.max_memory_allocated() - resident
    daily = reals.sum(dim=1)
    generated = timed("generate_for_daily_sums", lambda: (
        generate_for_daily_sums(daily, alpha, beta, cfg, seed=seed,
                                device=ds.device)))
    baseline = np.load(os.path.join(calib_dir,
                                    "rainfarm_calibration_data.npy"))
    protocol_dir = os.path.join(workdir, "protocol")
    res = timed("run_crps_evaluation", lambda: run_crps_evaluation(
        sl["gen"], reals[:EVAL_SAMPLES], baseline, n_members=EVAL_MEMBERS,
        outdir=protocol_dir, seed=seed, rainfarm=(alpha, beta, cfg)))
    counts = {"upsample2_conv3": upsample_conv.launches,
              "upsample2_conv3_by_variant": dict(
                  upsample_conv.launches_by_variant),
              "gather_patches": gather.launches,
              "pixel_norm_leaky": core.pixel_norm_launches}

    want = {"calibrate": (0, cfg.n_repeat), "draw_reals": (0, 1),
            "crps_rainfarm": (0, 0), "generate_for_daily_sums": (0, 0),
            "run_crps_evaluation": (
                3 * EVAL_MEMBERS // EVAL_MEMBER_BATCH * EVAL_SAMPLES, 0)}
    got = {k: (v["k1_launches"], v["k2_launches"]) for k, v in items.items()}
    print(f"[rainfarm] main path: launches by item (K1, K2) {got}, in all "
          f"{counts}")
    check(got == want, f"rainfarm launches {got}, expected {want}")
    check(main_only(counts["upsample2_conv3_by_variant"],
                    counts["upsample2_conv3"]), counts)

    for i, (a, b) in enumerate(slopes):
        print(f"[rainfarm] repeat {i}: alpha={a:.6f} beta={b:.6f}")
    check(len(slopes) == cfg.n_repeat and np.isfinite(slopes).all(),
          f"slopes {slopes}")
    check(sorted(os.listdir(calib_dir)) == sorted(
        ["rainfarm_calibration_data.npy"]
        + [f"spectral_slopes_{i}.pkl" for i in range(cfg.n_repeat)]),
        os.listdir(calib_dir))
    _eval_item("calibrate", {
        "n_calib": cfg.n_calib, "n_repeat": cfg.n_repeat, "seed": cfg.seed,
        "seconds": items["calibrate"]["seconds"],
        "k2_launches": items["calibrate"]["k2_launches"],
        "alpha": [a for a, _ in slopes], "beta": [b for _, b in slopes]},
        "rainfarm")
    t = items["crps_rainfarm"]["seconds"]
    _eval_item("crps_rainfarm", {
        "samples": RAINFARM_SAMPLES, "members": RAINFARM_MEMBERS,
        "seconds": t, "samples_per_s": RAINFARM_SAMPLES / t,
        "peak_bytes": crps_peak, "mean_crps": float(crps.mean()),
        "k2_launches_for_the_reals": items["draw_reals"]["k2_launches"]},
        "rainfarm")
    check(crps.shape == (RAINFARM_SAMPLES, 24) and np.isfinite(crps).all()
          and (crps >= 0).all(), "crps_rainfarm: bad rows")
    cons = _conservation_err(generated, daily.cpu().numpy())
    _eval_item("generate_for_daily_sums", {
        "days": RAINFARM_SAMPLES,
        "seconds": items["generate_for_daily_sums"]["seconds"],
        "conservation": cons, "bound": CONSERVATION_RTOL}, "rainfarm")
    check(generated.shape == (RAINFARM_SAMPLES, 24, 16, 16)
          and np.isfinite(generated).all() and cons <= CONSERVATION_RTOL,
          f"generate_for_daily_sums: conservation {cons}")
    with open(os.path.join(protocol_dir, "crps_results_rainfarm.pkl"),
              "rb") as fh:
        pickled = pickle.load(fh)
    _eval_item("run_crps_evaluation", {
        "samples": EVAL_SAMPLES, "members": EVAL_MEMBERS,
        "seconds": items["run_crps_evaluation"]["seconds"],
        "arm_seconds": {k: res[f"{k}_seconds"]
                        for k in ("gan", "random", "rainfarm")},
        "analysis": res["analysis"]}, "rainfarm")
    check(all(res[k].shape == (EVAL_SAMPLES, 24) and np.isfinite(res[k]).all()
              for k in ("gan", "random", "rainfarm"))
          and np.array_equal(pickled, res["rainfarm"])
          and "rainfarm" in res["analysis"], "the three-arm protocol")
    profile_breakdown(
        lambda: crps_rainfarm(reals[:RAINFARM_PROFILED], alpha, beta, cfg,
                              n_members=RAINFARM_MEMBERS, device=ds.device),
        f"crps_rainfarm, {RAINFARM_PROFILED} samples x {RAINFARM_MEMBERS} "
        "members", host_top=4)
    checks = _rainfarm_checks(os.path.join(
        calib_dir, "rainfarm_calibration_data.npy"), slopes[0], daily, seed)
    return {"counts": counts, "items": items, "slopes": slopes,
            "crps_peak_bytes": crps_peak, "conservation": cons, **checks}


def _cli_proc(name: str, args: list, workdir: str):
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(workdir, f"{name}.out"), "w") as fo, \
            open(os.path.join(workdir, f"{name}.err"), "w") as fe:
        return subprocess.Popen(
            [sys.executable, "-m", "prdisagg_torch.cli", *args], cwd=root,
            stdout=fo, stderr=fe, text=True)


def _cli_output(name: str, workdir: str):
    with open(os.path.join(workdir, f"{name}.out")) as fo, \
            open(os.path.join(workdir, f"{name}.err")) as fe:
        return fo.read(), fe.read()


def _wait_for_socket(path: str, proc, deadline: float) -> None:
    while not os.path.exists(path):
        check(proc.poll() is None, f"the server exited before binding {path}")
        check(time.perf_counter() < deadline, f"no socket at {path}")
        time.sleep(0.1)


def phase_serve_cli(sl: dict, workdir: str) -> dict:
    """The serving and RainFARM subcommands as subprocesses from the slice
    phase's .npz, started together: ``inspect``; ``generate`` on one
    condition, on a stack of CLI_STACK and with the float16 wire (their
    scenarios' conservation checked from the saved .npy); ``serve
    --max-requests 3`` answering a ping, a b64 map request and stats;
    a second ``serve`` stopped by SIGTERM; ``rainfarm-calibrate
    --synthetic --n-repeat 2`` and then ``rainfarm-crps`` on its output;
    ``example`` and ``rainfarm-generate``, which need matplotlib: without
    it they must exit non-zero naming it, with it exit 0."""
    import importlib.util

    import numpy as np
    import torch

    from prdisagg_torch.api.server import request, scenarios_array

    torch.cuda.empty_cache()  # room for the subprocesses' forwards
    os.makedirs(workdir, exist_ok=True)
    npz, cond = sl["npz"], sl["cond"]
    stack = np.stack([cond * (1 + 0.1 * i) for i in range(CLI_STACK)])
    paths = {n: os.path.join(workdir, f"{n}.npy")
             for n in ("cond", "stack", "single", "many", "f16")}
    np.save(paths["cond"], cond)
    np.save(paths["stack"], stack)
    os.makedirs("build", exist_ok=True)  # short relative path: AF_UNIX limit
    socks = {n: os.path.join("build", f"serve-cli-{os.getpid()}-{n}.sock")
             for n in ("serve", "serve_sigterm")}
    rf_dir = os.path.join(workdir, "rainfarm")
    gen_args = ["generate", "--weights", npz, "--n-scenarios",
                str(CLI_SCENARIOS)]
    first = {
        "inspect": ["inspect", "--weights", npz],
        "generate_single": gen_args + ["--conds", paths["cond"], "--out",
                                       paths["single"]],
        "generate_stack": gen_args + ["--conds", paths["stack"], "--out",
                                      paths["many"], "--max-batch",
                                      str(CLI_STACK_MAX_BATCH)],
        "generate_f16": gen_args + ["--conds", paths["cond"], "--out",
                                    paths["f16"], "--wire-dtype", "float16"],
        "serve": ["serve", "--weights", npz, "--socket", socks["serve"],
                  "--max-requests", "3", "--max-batch", "1024",
                  "--batch-window-ms", "5"],
        "serve_sigterm": ["serve", "--weights", npz, "--socket",
                          socks["serve_sigterm"], "--warm", "none"],
        "rainfarm_calibrate": ["rainfarm-calibrate", "--synthetic",
                               "--n-repeat", "2", "--out", rf_dir],
        "example": ["example", "--out", os.path.join(workdir, "ex.png")],
    }
    slopes = os.path.join(rf_dir, "spectral_slopes_0.pkl")
    batch = os.path.join(rf_dir, "rainfarm_calibration_data.npy")
    second = {
        "rainfarm_crps": ["rainfarm-crps", "--slopes", slopes, "--real",
                          batch, "--n-samples", str(EVAL_SAMPLES), "--out",
                          rf_dir],
        "rainfarm_generate": ["rainfarm-generate", "--slopes", slopes,
                              "--real", batch, "--n-samples", "4",
                              "--n-map-conditions", "1", "--n-fake-per-real",
                              "2", "--out", rf_dir, "--plotdir",
                              os.path.join(workdir, "rf_plots")],
    }
    t0 = time.perf_counter()
    deadline = t0 + 600
    procs, ends, answers = {}, {}, {}

    def reap():
        for name, proc in procs.items():
            if name not in ends and proc.poll() is not None:
                ends[name] = time.perf_counter() - t0

    try:
        for name, args in first.items():
            procs[name] = _cli_proc(name, args, workdir)
        _wait_for_socket(socks["serve"], procs["serve"], deadline)
        answers = {
            "ping": request(socks["serve"], {"cmd": "ping"}, timeout=120),
            "map_b64": request(socks["serve"], {
                "cond": cond.tolist(), "n_scenarios": 16,
                "encoding": "b64"}, timeout=120),
            "stats": request(socks["serve"], {"cmd": "stats"}, timeout=120)}
        _wait_for_socket(socks["serve_sigterm"], procs["serve_sigterm"],
                         deadline)
        answers["sigterm_ping"] = request(socks["serve_sigterm"],
                                          {"cmd": "ping"}, timeout=120)
        procs["serve_sigterm"].send_signal(signal.SIGTERM)
        while "rainfarm_calibrate" not in ends:
            check(time.perf_counter() < deadline, "cli runs timed out")
            reap()
            time.sleep(0.1)
        check(procs["rainfarm_calibrate"].returncode == 0,
              "rainfarm-calibrate failed:\n"
              + "\n".join(_cli_output("rainfarm_calibrate", workdir)))
        for name, args in second.items():
            procs[name] = _cli_proc(name, args, workdir)
        while len(ends) < len(procs):
            check(time.perf_counter() < deadline, "cli runs timed out")
            reap()
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out = {}
    for name, proc in procs.items():
        stdout, stderr = _cli_output(name, workdir)
        row = {"rc": proc.returncode, "seconds": ends[name],
               "last_line": stdout.strip().splitlines()[-1:]}
        if name in ("example", "rainfarm_generate") and not has_mpl:
            row["stderr"] = stderr.strip().splitlines()[-1:]
            ok = proc.returncode != 0 and "'matplotlib'" in stderr
        else:
            ok = proc.returncode == 0
        print("[serve_cli] " + name + ": " + json.dumps(row))
        check(ok, f"cli {name}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
        out[name] = dict(row, stdout=stdout)

    info = json.loads(out["inspect"]["stdout"])
    check(info["network"] == "generator" and info["n_params"] > 0, info)
    cons = {}
    for name, path, daily, rtol in (
            ("single", paths["single"], cond, CONSERVATION_RTOL),
            ("stack", paths["many"], stack[:, None], CONSERVATION_RTOL),
            ("f16", paths["f16"], cond, WIRE_F16_RTOL)):
        scen = np.load(path)
        cons[name] = _conservation_err(scen, daily)
        check(np.isfinite(scen).all() and cons[name] <= rtol,
              f"cli generate {name}: conservation {cons[name]}")
    check(np.load(paths["many"]).shape == (CLI_STACK, CLI_SCENARIOS, 24, 16,
                                           16), "stack shape")
    print(f"[serve_cli] generate conservation {json.dumps(cons)} (bounds "
          f"{CONSERVATION_RTOL}, f16 {WIRE_F16_RTOL})")
    for name, resp in answers.items():
        check(resp.get("ok") is True, (name, resp))
    one = scenarios_array(answers["map_b64"])
    check(one.shape == (16, 24, 16, 16)
          and _conservation_err(one, cond) <= CONSERVATION_RTOL,
          "serve: bad scenarios")
    print("[serve_cli] serve stats " + json.dumps(
        {k: answers["stats"][k] for k in ("scenario_requests", "scenarios",
                                          "latency_ms")}))
    check("served 3 requests" in out["serve"]["stdout"]
          and "shutting down" in out["serve_sigterm"]["stdout"]
          and "bye" in out["serve_sigterm"]["stdout"]
          and not any(os.path.exists(s) for s in socks.values()),
          "the servers did not stop cleanly")
    check(out["rainfarm_calibrate"]["stdout"].count("alpha=") == 2,
          out["rainfarm_calibrate"]["stdout"])
    with open(os.path.join(rf_dir, "crps_results_rainfarm.pkl"), "rb") as fh:
        rows = pickle.load(fh)
    check(rows.shape == (EVAL_SAMPLES, 24) and np.isfinite(rows).all()
          and (rows >= 0).all(), "cli rainfarm-crps: bad rows")
    return {"conservation": cons, "seconds": time.perf_counter() - t0,
            **{k: {kk: vv for kk, vv in v.items() if kk != "stdout"}
               for k, v in out.items()}}


def _dp_counts() -> dict:
    """The K1 and K2 wrappers' counters (wgan_gp.kernel_counts)."""
    from prdisagg_torch.train import wgan_gp

    return wgan_gp.kernel_counts()


def _reset_counts() -> None:
    from prdisagg_torch.ops import gather

    reset_k1_counts()
    gather.launches = 0


def _is_nccl(kernel: str) -> bool:
    """An NCCL kernel by its name; at world 1 an AVG all-reduce is NCCL's
    oneRankReduce."""
    return "nccl" in kernel.lower() or "onerankreduce" in kernel.lower()


class _GradLog:
    """Hooks on a train state's two optimizers that see the gradients
    reaching each update, in order (n_disc critic updates, then the
    generator's).  Without `want` it keeps a copy of each; with `want`
    (another log's copies, of the same step on the same draws) it compares
    each as it comes and keeps the largest reading of :func:`_grad_err` and
    the parameter that gave it.  close() removes the hooks."""

    def __init__(self, state, want=None):
        self.grads, self.err, self.worst, self.want = [], 0.0, None, want
        self.names = {id(opt): [f"{net}.{n}" for n, _ in getattr(
            state, net).named_parameters()]
            for opt, net in ((state.critic_opt, "critic"),
                             (state.gen_opt, "gen"))}
        self.handles = [opt.register_step_pre_hook(self._hook)
                        for opt in (state.critic_opt, state.gen_opt)]

    def _hook(self, opt, args, kwargs):
        got = [p.grad for g in opt.param_groups for p in g["params"]]
        if self.want is None:
            self.grads.append([x.detach().clone() for x in got])
            return
        err, i = _grad_err(got, self.want[len(self.grads)])
        if err > self.err:
            self.err = err
            self.worst = f"update {len(self.grads)} {self.names[id(opt)][i]}"
        self.grads.append(None)

    def close(self):
        for h in self.handles:
            h.remove()


def _grad_err(got, want) -> tuple:
    """One update's gradients against another run's: the largest over the
    parameters of max |got - want| over the parameter's own largest |want|,
    floored at 1e-2 of the update's largest (some gradients are zero
    analytically, the head's bias, and hold only rounding noise), and the
    index of the parameter that gave it.  A gradient counted twice, or a
    share of one, reads about 1 on its parameter."""
    scale = max(w.abs().max().item() for w in want)
    errs = [(g - w).abs().max().item() / max(w.abs().max().item(),
                                             1e-2 * scale)
            for g, w in zip(got, want)]
    i = max(range(len(errs)), key=errs.__getitem__)
    return errs[i], i


def _param_err(a, b) -> float:
    """max |a - b| over both nets, over max |b|, the larger net's."""
    err = 0.0
    for net in ("gen", "critic"):
        x, y = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        pmax = max(v.abs().max().item() for v in y.values())
        err = max(err, max((x[k] - y[k]).abs().max().item()
                           for k in y) / pmax)
    return err


def dp_worker_nccl(seed: int, workdir: str) -> dict:
    """The NCCL world-1 worker: Trainer.fit at the flagship defaults on a
    mesh, graphed; a profiled call of replays; parameters against a run
    without the mesh."""
    import torch

    from prdisagg_torch.parallel.distributed import initialize_multihost
    from prdisagg_torch.parallel.mesh import make_mesh
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.loop import Trainer

    check(initialize_multihost(), "the launcher's environment started no "
          "process group")
    mesh = make_mesh(1)
    check(mesh.backend == "nccl" and mesh.device.type == "cuda", mesh)
    ds = phase_dataset(seed)
    epochs = WARM_EPOCHS + TIMED_EPOCHS
    exp = _train_exp(epochs, seed, log_every_steps=STEPS_PER_EPOCH,
                     checkpoint_every_epochs=epochs)
    trainer = Trainer(exp, ds, os.path.join(workdir, "nccl_train"),
                      steps_per_epoch=STEPS_PER_EPOCH, plot_every_epochs=0,
                      export_weights_every_epochs=epochs,
                      export_format="npz", mesh=mesh)
    torch.cuda.synchronize()
    _reset_counts()
    wgan_gp.graph_captured.clear()
    wgan_gp.graph_launches.clear()
    trainer.fit(progress=False)
    torch.cuda.synchronize()
    captured = dict(wgan_gp.graph_captured)
    executed = _executed_counts(_dp_counts(), captured,
                                dict(wgan_gp.graph_launches))
    steps = epochs * STEPS_PER_EPOCH
    per_step = train_per_step()
    check(trainer.state.step == steps and captured == per_step,
          (trainer.state.step, captured))
    # the warm-up's eager steps run too
    check(executed == {k: n * (steps + wgan_gp.WARMUP_STEPS)
                       for k, n in per_step.items()}, executed)
    def rate(tr) -> float:
        return (TIMED_EPOCHS * STEPS_PER_EPOCH
                / sum(tr.epoch_seconds[WARM_EPOCHS:]))

    def timed_run(name: str, m):
        tr = Trainer(exp, ds, os.path.join(workdir, f"nccl_{name}"),
                     steps_per_epoch=STEPS_PER_EPOCH, plot_every_epochs=0,
                     export_weights_every_epochs=epochs, export_format="npz",
                     mesh=m)
        check((tr.mesh is None) == (m is None), f"{name}: mesh {tr.mesh}")
        tr.fit(progress=False)
        return tr

    # the same run without the mesh twice, then on the mesh again: the
    # order A B B A takes the position in the process out of the ratio
    alone = timed_run("alone1", None)
    rates = {"dp": [rate(trainer)], "alone": [rate(alone)]}
    rates["alone"].append(rate(timed_run("alone2", None)))
    rates["dp"].append(rate(timed_run("dp2", mesh)))
    graphed = rates["dp"][0]
    # cuDNN's weight gradients need not be deterministic here, so after 250
    # steps this is printed, not held to a bound (the check below is)
    timed_runs_err = _param_err(trainer.state, alone.state)

    step_fn = wgan_gp.make_train_step(trainer.model_cfg, exp.train,
                                      TRAIN_BATCH, PROFILE_REPLAYS, mesh)
    prof = profile_breakdown(
        lambda: (step_fn(trainer.state, ds), torch.cuda.synchronize()),
        f"NCCL world 1: one call of {PROFILE_REPLAYS} graphed steps", top=8)
    check(prof is not None, "no device events in the graphed window")
    names = prof["count_by_name"]
    nccl = sorted(k for k in names if _is_nccl(k))
    in_graph = {
        "k1_bf16_wgmma": sum(n for k, n in names.items()
                             if "k1_bf16_wgmma" in k),
        "k2_gather": sum(n for k, n in names.items() if "k2_gather" in k),
        "nccl": sum(names[k] for k in nccl)}
    nccl_ms = sum(prof["ms_by_name"][k] for k in nccl) / PROFILE_REPLAYS
    check(in_graph == {"k1_bf16_wgmma": 6 * PROFILE_REPLAYS,
                       "k2_gather": 2 * PROFILE_REPLAYS,
                       "nccl": (N_DISC + 1) * PROFILE_REPLAYS},
          f"the replays' kernels: {in_graph}, NCCL kernels {nccl}")

    # the same short run with and without the mesh, cuDNN deterministic
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, m in (("dp", mesh), ("single", None)):
            tr = Trainer(_train_exp(2, seed, log_every_steps=RESUME_STEPS,
                                    checkpoint_every_epochs=0),
                         ds, os.path.join(workdir, f"nccl_{name}"),
                         steps_per_epoch=RESUME_STEPS, plot_every_epochs=0,
                         export_weights_every_epochs=0, export_format="npz",
                         mesh=m)
            check((tr.mesh is None) == (m is None), tr.mesh)
            tr.fit(progress=False)
            runs[name] = tr.state
    finally:
        torch.backends.cudnn.deterministic = det
    param_err = _param_err(runs["dp"], runs["single"])
    check(param_err <= DP_TOL, f"data-parallel and single runs differ by "
          f"{param_err} of max|p|")
    return {"counts": executed, "graphed_steps_per_s": graphed,
            "graphed_steps_per_s_abba": rates,
            "param_err_of_the_timed_runs": timed_runs_err,
            "captured_per_replay": captured, "in_graph": in_graph,
            "nccl_kernels": nccl, "nccl_ms_per_step": nccl_ms,
            "graph_profile": {k: prof[k] for k in (
                "window_ms", "busy_ms", "idle_share")},
            "param_check": {"steps": 2 * RESUME_STEPS,
                            "param_err_over_max": param_err,
                            "tolerance": DP_TOL}}


def dp_worker_gloo(seed: int, workdir: str) -> dict:
    """One rank of the gloo world on the one card: a flagship f32 eager
    step, crps_gan and generate_scenarios over the mesh, each against the
    same work without it."""
    import numpy as np
    import torch

    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import DataConfig, ModelConfig, TrainConfig
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset_torch
    from prdisagg_torch.eval.crps import crps_gan
    from prdisagg_torch.parallel.distributed import initialize_multihost
    from prdisagg_torch.parallel.mesh import (
        all_gather_batch,
        make_mesh,
        replicate,
    )
    from prdisagg_torch.train.state import (
        clone_train_state,
        create_train_state,
    )
    from prdisagg_torch.train.wgan_gp import (
        draw_step_inputs,
        train_step_on,
        unpack_metrics,
    )

    check(initialize_multihost(device=CARD, backend="gloo"),
          "the launcher's environment started no process group")
    mesh = make_mesh(DP_GLOO_WORLD, device=CARD)
    counts = collections.Counter()

    def on_mesh(fn):
        """fn() timed, its K1 and K2 launches added to the path's."""
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts.update(_dp_counts())
        return res, secs

    mc = ModelConfig(compute_dtype="float32")
    tcfg = TrainConfig(n_disc=N_DISC, seed=seed)
    days, ny, nx = DP_GLOO_DATASET
    data, idx, dcfg = make_synthetic_dataset_torch(days, ny, nx, seed, CARD,
                                                   cfg=DataConfig())
    ds = DeviceDataset.from_tensor(data, idx, dcfg)
    state = create_train_state(mc, tcfg, device=CARD, mesh=mesh)
    _warm_adam(state, seed)
    replicate(state, mesh)
    single = clone_train_state(state, mc, tcfg, CARD)
    draws = draw_step_inputs(state, ds, TRAIN_BATCH, N_DISC)
    m_dp, step_s = on_mesh(lambda: unpack_metrics(train_step_on(
        state, ds, draws, tcfg, mesh=mesh)["packed"]))
    m_one = unpack_metrics(train_step_on(single, ds, draws, tcfg)["packed"])
    losses = ("d_loss", "gp", "w_distance", "g_loss")
    scale = max(abs(m_one[k]) for k in losses)
    loss_err = max(abs(m_dp[k] - m_one[k]) for k in losses) / scale
    param_err = _param_err(state, single)
    flat = torch.cat([v.reshape(-1) for net in (state.gen, state.critic)
                      for v in net.state_dict().values()])
    every = all_gather_batch(flat[None], mesh)
    ranks_equal = all(torch.equal(every[0], r) for r in every[1:])

    npz = os.path.join(workdir, "gen.npz")
    reals = np.load(os.path.join(workdir, "reals.npy"))
    cond = np.load(os.path.join(workdir, "cond.npy"))
    gen = PretrainedGenerator.from_npz(npz, seed=seed, device=CARD,
                                       mesh=mesh)
    rows, crps_s = on_mesh(lambda: crps_gan(gen, reals,
                                            n_members=EVAL_MEMBERS,
                                            seed=seed))
    one = PretrainedGenerator.from_npz(npz, seed=seed, device=CARD)
    want = crps_gan(one, reals, n_members=EVAL_MEMBERS, seed=seed)
    scen, gen_s = on_mesh(lambda: gen.generate_scenarios(cond, SCENARIOS))
    want_scen = one.generate_scenarios(cond, SCENARIOS)
    return {
        "rank": mesh.rank, "counts": dict(counts),
        "step": {"loss_err_over_scale": loss_err,
                 "param_err_over_max": param_err, "ranks_equal": ranks_equal,
                 "nonfinite": m_dp["nonfinite"], "seconds": step_s,
                 "losses": {k: m_dp[k] for k in losses}},
        "crps": {"equal": bool(np.array_equal(rows, want)),
                 "max_abs_diff": float(np.abs(rows - want).max()),
                 "shape": list(rows.shape), "mean": float(rows.mean()),
                 "seconds": crps_s,
                 "samples_per_s": len(reals) / crps_s},
        "generate": {"err_over_max_cond": float(
                         np.abs(scen - want_scen).max() / cond.max()),
                     "conservation": _conservation_err(scen, cond),
                     "shape": list(scen.shape), "seconds": gen_s,
                     "scenarios_per_s": SCENARIOS / gen_s}}


def _dp_proc(args: list, rank: int, world: int, local_rank: int, port: int,
             out: str):
    """A worker of a launched world: `args` after the interpreter, the
    launcher's environment set here, output to `out`."""
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(local_rank), MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    root = os.path.dirname(os.path.abspath(__file__))
    with open(out, "w") as fo:
        return subprocess.Popen([sys.executable, *args], cwd=root, env=env,
                                stdout=fo, stderr=subprocess.STDOUT,
                                text=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_all(procs: dict, limit: float, t0: float) -> dict:
    """Wait for every process, killing all of them past `limit` seconds
    from `t0`, when they were started; returns each one's seconds."""
    ends = {}
    try:
        while len(ends) < len(procs):
            check(time.perf_counter() - t0 < limit,
                  f"dp workers timed out: {sorted(set(procs) - set(ends))}")
            for name, proc in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ends


def _worker_result(name: str, workdir: str, proc, secs: float) -> dict:
    """A worker's log lines echoed, its exit code checked, its JSON result
    read."""
    with open(os.path.join(workdir, f"{name}.out")) as fh:
        log = fh.read()
    for line in log.strip().splitlines()[-12:]:
        print(f"[dp:{name}] {line}")
    check(proc.returncode == 0, f"dp worker {name} failed (rc "
          f"{proc.returncode}):\n{log[-4000:]}")
    print(f"[dp] {name}: rc 0 in {secs:.1f} s")
    path = os.path.join(workdir, f"{name}.json")
    if not os.path.exists(path):
        return {"rc": 0, "seconds": secs, "log": log}
    with open(path) as fh:
        return {**json.load(fh), "rc": 0, "seconds": secs}


def phase_dp(sl: dict, train: dict, seed: int, workdir: str,
             card: str) -> dict:
    """Data parallelism through its workers (phase 15 of the docstring)."""
    import numpy as np

    from prdisagg_torch.ops import upsample_conv

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.RandomState(seed + 8)
    reals = rng.gamma(0.5, 0.4, (DP_CRPS_SAMPLES, 24, 16, 16)).astype("f4")
    np.save(os.path.join(workdir, "reals.npy"), reals)
    np.save(os.path.join(workdir, "base.npy"),
            rng.gamma(0.5, 0.4, (100, 24, 16, 16)).astype("f4"))
    np.save(os.path.join(workdir, "cond.npy"), sl["cond"])
    with open(sl["npz"], "rb") as src, \
            open(os.path.join(workdir, "gen.npz"), "wb") as dst:
        dst.write(src.read())
    me = [os.path.abspath(__file__), "--seed", str(seed), "--workdir",
          workdir, "--dp-worker"]
    cli = ["-m", "prdisagg_torch.cli"]

    def out(name):
        return os.path.join(workdir, f"{name}.out")

    t0 = time.perf_counter()
    procs = {"nccl": _dp_proc(me + ["nccl"], 0, 1, 0, _free_port(),
                              out("nccl"))}
    ends = _wait_all(procs, 600, t0)
    nccl = _worker_result("nccl", workdir, procs["nccl"], ends["nccl"])

    gloo_port = _free_port()
    t0 = time.perf_counter()
    procs = {f"gloo{r}": _dp_proc(me + ["gloo"], r, DP_GLOO_WORLD, 0,
                                  gloo_port, out(f"gloo{r}"))
             for r in range(DP_GLOO_WORLD)}
    procs["cli_train"] = _dp_proc(
        cli + ["train", "--synthetic", "--epochs", "2", "--steps-per-epoch",
               str(CLI_STEPS), "--export-format", "npz",
               "--plot-every-epochs", "0", "--seed", str(seed), "--workdir",
               os.path.join(workdir, "cli_train")],
        0, 1, 0, _free_port(), out("cli_train"))
    procs["cli_crps"] = _dp_proc(
        cli + ["crps", "--dp", "1", "--weights",
               os.path.join(workdir, "gen.npz"), "--real",
               os.path.join(workdir, "reals.npy"), "--baseline",
               os.path.join(workdir, "base.npy"), "--n-members",
               str(EVAL_MEMBERS), "--out", os.path.join(workdir, "crps")],
        0, 1, 0, _free_port(), out("cli_crps"))
    os.makedirs("build", exist_ok=True)  # short relative path: AF_UNIX limit
    sock = os.path.join("build", f"chip_smoke-dp-{os.getpid()}.sock")
    procs["cli_serve"] = _dp_proc(
        cli + ["serve", "--dp", "1", "--weights",
               os.path.join(workdir, "gen.npz"), "--socket", sock, "--seed",
               str(seed), "--warm", str(SCENARIOS), "--max-requests", "2"],
        0, 1, 0, _free_port(), out("cli_serve"))
    cond = sl["cond"]
    stack = np.stack([cond * (1 + 0.1 * i) for i in range(4)])
    try:
        from prdisagg_torch.api.server import request, scenarios_array

        _wait_for_socket(sock, procs["cli_serve"], time.perf_counter() + 300)
        served = [scenarios_array(request(sock, {
            "cond": c.tolist(), "n_scenarios": n, "encoding": "b64"},
            timeout=300)) for c, n in ((cond, SCENARIOS), (stack, 250))]
    except BaseException:
        for proc in procs.values():
            proc.kill()
        raise
    ends = _wait_all(procs, 600, t0)
    res = {name: _worker_result(name, workdir, proc, ends[name])
           for name, proc in procs.items()}
    res["nccl"] = nccl

    abba = nccl["graphed_steps_per_s_abba"]
    print(f"[dp] NCCL world 1 ({card}): Trainer.fit graphed, fused steps/s "
          f"in the order mesh, alone, alone, mesh: "
          f"{json.dumps(abba)}, mesh/alone "
          f"{sum(abba['dp']) / sum(abba['alone']):.4f}; the train phase's "
          f"{train['graphed_steps_per_s']:.2f} in this call; per "
          f"replay captured {nccl['captured_per_replay']}; "
          f"in {PROFILE_REPLAYS} profiled replays {nccl['in_graph']} "
          f"({nccl['nccl_kernels']}), NCCL device time "
          f"{nccl['nccl_ms_per_step']:.5f} ms a step, idle share "
          f"{nccl['graph_profile']['idle_share']:.3f}; parameters vs the "
          f"run without a mesh {json.dumps(nccl['param_check'])} (after "
          f"the two timed runs, not deterministic: "
          f"{nccl['param_err_of_the_timed_runs']:.3e} of max|p|)")
    gloo = [res[f"gloo{r}"] for r in range(DP_GLOO_WORLD)]
    for g in gloo:
        print(f"[dp] gloo world {DP_GLOO_WORLD}, rank {g['rank']} ({card}; "
              f"gloo's rates are not performance numbers): step "
              f"{json.dumps(g['step'])}; crps_gan {json.dumps(g['crps'])}; "
              f"generate_scenarios {json.dumps(g['generate'])}; launches "
              f"{g['counts']}")
        st, cr, ge = g["step"], g["crps"], g["generate"]
        check(st["loss_err_over_scale"] <= DP_TOL
              and st["param_err_over_max"] <= DP_TOL and st["ranks_equal"]
              and not st["nonfinite"], f"gloo step: {st}")
        check(cr["equal"] and cr["shape"] == [DP_CRPS_SAMPLES, 24],
              f"crps_gan rows over the mesh differ from one device's: {cr}")
        check(ge["err_over_max_cond"] <= 1e-5
              and ge["conservation"] <= CONSERVATION_RTOL
              and ge["shape"] == [SCENARIOS, 24, 16, 16], ge)
        # a rank's half of the step (K2: 2, K1: 6 forward and 3 backward
        # passes, f32 at B 16), of its 5 scored samples (3 each) and of the
        # forward (3)
        half = DP_CRPS_SAMPLES // DP_GLOO_WORLD
        want = train_per_step("float32", TRAIN_BATCH // DP_GLOO_WORLD)
        scored = [EVAL_MEMBER_BATCH] * (half * EVAL_MEMBERS
                                        // EVAL_MEMBER_BATCH) + [SCENARIOS]
        want["upsample2_conv3"] += 3 * len(scored)
        want["pixel_norm_leaky"] += 3 * len(scored)
        for v, n in k1_forward_expected("float32", scored).items():
            want[f"upsample2_conv3_{v}"] += n
        check(g["counts"] == want, f"gloo rank launches {g['counts']}, "
              f"expected {want}")
    check("data-parallel over 1 rank(s)" in res["cli_train"]["log"],
          res["cli_train"]["log"][-2000:])
    with open(os.path.join(workdir, "crps", "crps_results.json")) as fh:
        analysis = json.load(fh)
    print(f"[dp] cli train under a launched world of 1: "
          f"{res['cli_train']['seconds']:.1f} s; cli crps --dp 1: "
          f"{res['cli_crps']['seconds']:.1f} s, {json.dumps(analysis)} "
          f"({card})")
    # serve --dp 1 against one device's generator from the same seed
    from prdisagg_torch.api.pretrained import PretrainedGenerator

    one = PretrainedGenerator.from_npz(os.path.join(workdir, "gen.npz"),
                                       seed=seed)
    want = [one.generate_scenarios(cond, SCENARIOS),
            one.generate_scenarios_batch(stack, 250)]
    serve_err = max(float(np.abs(g - w).max()) for g, w in zip(served, want))
    serve_cons = max(_conservation_err(served[0], cond),
                     max(_conservation_err(served[1][i], stack[i])
                         for i in range(len(stack))))
    print(f"[dp] cli serve --dp 1 (a leader, no followers): "
          f"{res['cli_serve']['seconds']:.1f} s; a map of {SCENARIOS} and "
          f"a stack of {len(stack)} x 250 against one device's: max |diff| "
          f"{serve_err:.3e} mm, conservation {serve_cons:.3e} ({card})")
    check("served 2 requests" in res["cli_serve"]["log"]
          and serve_err <= 1e-5 * stack.max()
          and serve_cons <= CONSERVATION_RTOL,
          f"serve --dp 1: {serve_err}, {serve_cons}")
    counts = collections.Counter(nccl["counts"])
    for g in gloo:
        counts.update(g["counts"])
    return {"counts": {
        "upsample2_conv3": counts["upsample2_conv3"],
        "upsample2_conv3_by_variant": {
            v: counts[f"upsample2_conv3_{v}"]
            for v in upsample_conv.VARIANTS},
        "upsample2_conv3_backward": counts["upsample2_conv3_backward"],
        "upsample2_conv3_backward_kernels": _backward_kernels(counts),
        "gather_patches": counts["gather_patches"],
        "pixel_norm_leaky": counts["pixel_norm_leaky"]},
        "nccl": {k: v for k, v in nccl.items() if k != "log"},
        "gloo": gloo,
        "cli": {k: res[k]["seconds"] for k in ("cli_train", "cli_crps",
                                                "cli_serve")},
        "serve_err": serve_err}



# ---------------------------------------------------------------------------
# the fused generator forward (phase 20) and spatial sharding (phase 21)
# ---------------------------------------------------------------------------

def _graphed_rate(step_fn, state, ds) -> float:
    """Steps/s of one call of `step_fn` (FUSED_STEPS graphed replays)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(state, ds)
    torch.cuda.synchronize()
    return FUSED_STEPS / (time.perf_counter() - t0)


def phase_fused(ds, seed: int) -> dict:
    """fused_gen_forward beside the default step, in this process, at the
    flagship defaults (bf16, B 32, n_disc 5) on the card-resident dataset,
    each a CUDA graph: their steps/s over calls of FUSED_STEPS replays in
    the order default, fused, fused, default; the fused graph's kernels
    through the wrappers (one K1 forward a stage, at (n_disc + 1) B, and
    K1's backward at that batch); then one f32 step of each from the same
    state (mid-training Adam moments, dropout on) on the same draws."""
    import torch

    from prdisagg_torch.core.config import ModelConfig, TrainConfig
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import clone_train_state, create_train_state

    mc = ModelConfig()
    tcfg = TrainConfig(n_disc=N_DISC, seed=seed)
    steps, rates, counts = {}, {"default": [], "fused": []}, {}
    for name in ("default", "fused", "fused", "default"):
        if name not in steps:
            state = create_train_state(mc, tcfg, device=CARD)
            fn = wgan_gp.make_train_step(mc, tcfg, TRAIN_BATCH, FUSED_STEPS,
                                         fused_gen_forward=name == "fused")
            torch.cuda.synchronize()
            _reset_counts()
            wgan_gp.graph_captured.clear()
            wgan_gp.graph_launches.clear()
            fn(state, ds)  # warm-up, capture and the first call
            torch.cuda.synchronize()
            captured = dict(wgan_gp.graph_captured)
            counts[name] = {
                "per_replay": captured,
                "executed": _executed_counts(_dp_counts(), captured,
                                             dict(wgan_gp.graph_launches))}
            steps[name] = (fn, state)
        rates[name].append(_graphed_rate(*steps[name], ds))
    want = train_per_step("bfloat16", (N_DISC + 1) * TRAIN_BATCH)
    want["upsample2_conv3"] = want["pixel_norm_leaky"] = 3
    want.update({f"upsample2_conv3_{v}": n for v, n in k1_forward_expected(
        "bfloat16", [(N_DISC + 1) * TRAIN_BATCH]).items()})
    check(counts["fused"]["per_replay"] == want,
          f"fused replay's launches {counts['fused']['per_replay']}, "
          f"expected {want}")
    check(counts["default"]["per_replay"] == train_per_step(),
          counts["default"]["per_replay"])
    for _, state in steps.values():
        check(all(torch.isfinite(p).all() for p in state.gen.parameters()),
              "non-finite parameters after the graphed steps")
    del steps
    torch.cuda.empty_cache()

    # one f32 step of each on the same draws
    c = F32_CHECK
    f32 = dataclasses.replace(mc, compute_dtype="float32")
    t32 = TrainConfig(n_disc=c["n_disc"], seed=seed)
    base = create_train_state(f32, t32, device=CARD)
    _warm_adam(base, seed)
    draws = wgan_gp.draw_step_inputs(base, ds, c["batch"], c["n_disc"])
    res = {}
    for name in ("default", "fused"):
        st = clone_train_state(base, f32, t32, CARD)
        _reset_counts()
        m = wgan_gp.unpack_metrics(wgan_gp.train_step_on(
            st, ds, draws, t32, fused_gen_forward=name == "fused")["packed"])
        res[name] = (m, st, _dp_counts())
    (ma, sa, _), (mb, sb, cb) = res["default"], res["fused"]
    losses = ("d_loss", "d_loss_mean", "gp", "w_distance", "g_loss")
    scale = max(abs(ma[k]) for k in losses)
    metric_err = max([abs(mb[k] - ma[k]) / scale for k in losses]
                     + [abs(mb[k] - ma[k]) / ma[k]
                        for k in ("d_grad_norm", "g_grad_norm")])
    param_err = _param_err(sb, sa)
    critic_equal = all(torch.equal(a, b) for a, b in zip(
        sa.critic.parameters(), sb.critic.parameters()))
    cond = ds._real_from_rows(draws.real_rows)[1]
    f32_row = {"metric_rel_err": metric_err,
               "param_err_over_max": param_err,
               "critic_bit_identical": critic_equal,
               "fakes_by_layer": _batch_dependence(
                   base.gen, draws.latent, cond, draws.gen_latent,
                   ds._cond_from_rows(draws.gen_rows)),
               "n_disc": c["n_disc"], "batch": c["batch"],
               "k1_backward_kernels": _backward_kernels(cb)}
    check(not mb["nonfinite"] and metric_err <= FUSED_RTOL
          and param_err <= DP_TOL, f"fused vs default f32 step: {f32_row}")
    for k in counts["fused"]["executed"]:  # the f32 steps are on the path
        counts["fused"]["executed"][k] += res["fused"][2].get(k, 0)
    row = {"graphed_steps_per_s_abba": rates,
           "fused_over_default": sum(rates["fused"]) / sum(rates["default"]),
           "per_replay": {k: v["per_replay"] for k, v in counts.items()},
           "f32_step": f32_row}
    print("[fused] " + json.dumps(row))
    return {**row, "counts": _path_counts(counts["fused"]["executed"])}


def _batch_dependence(gen, lat, cond, lat_more, cond_more) -> dict:
    """Whether the generator's layers give the held-over rows (lat, cond)
    bit for bit alike when the generator update's rows ride in the same
    batch, as under fused_gen_forward: for the latent projection, each
    upsample-conv stage and the fractions (pixel-norm, the head conv and
    the softmax after the last stage), whether the rows' input and output
    are equal.  The first layer whose input is equal and output is not is
    the one whose result depends on the batch it runs in."""
    import torch

    from prdisagg_torch.models.generator import latent_projection
    from prdisagg_torch.ops.core import full_f32

    def run(lt, cd):
        seen = {}
        hooks = [st.register_forward_hook(
            lambda m, a, y, i=i: seen.__setitem__(f"conv{i}", (a[0], y)))
            for i, st in enumerate(gen.stages())]
        try:
            with torch.no_grad():
                y = gen(lt, cd)
                seen["fractions"] = (seen[f"conv{len(hooks) - 1}"][1], y)
                with full_f32():
                    x = torch.cat([lt, cd.reshape(len(lt), -1)], dim=-1)
                    seen["latent_proj"] = (x, latent_projection(
                        x, gen.latent_proj.weight, gen.latent_proj.bias))
        finally:
            for h in hooks:
                h.remove()
        return seen

    a = run(lat, cond)
    b = run(torch.cat([lat, lat_more]), torch.cat([cond, cond_more]))
    n = len(lat)
    return {k: {"input_equal": torch.equal(a[k][0], b[k][0][:n]),
                "output_equal": torch.equal(a[k][1], b[k][1][:n])}
            for k in ["latent_proj"] + [f"conv{i}" for i in range(
                len(gen.stages()))] + ["fractions"]}


def _path_counts(c: dict) -> dict:
    """A path's counters in the shape the kernels line sums."""
    from prdisagg_torch.ops import upsample_conv

    return {"upsample2_conv3": c["upsample2_conv3"],
            "upsample2_conv3_by_variant": {
                v: c[f"upsample2_conv3_{v}"]
                for v in upsample_conv.VARIANTS},
            "upsample2_conv3_backward": c["upsample2_conv3_backward"],
            "upsample2_conv3_backward_kernels": _backward_kernels(c),
            "gather_patches": c["gather_patches"],
            "pixel_norm_leaky": c["pixel_norm_leaky"]}


def _seconds(fn, reps: int) -> float:
    """Median wall seconds of fn() over `reps` calls, each waited for."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _halo_share(fn) -> dict:
    """One more call of fn() with every exchange waited for and timed: its
    seconds, the exchanges' seconds by kind and their share."""
    from prdisagg_torch.parallel import spatial

    spatial.exchange_seconds.clear()
    spatial.timed = True
    try:
        secs = _seconds(fn, 1)
    finally:
        spatial.timed = False
    ex = dict(spatial.exchange_seconds)
    return {"seconds": secs, "exchange_seconds": ex,
            "exchange_share": sum(ex.values()) / secs}


def _timed_peak(fn) -> tuple:
    """Wall seconds of one call of fn(), waited for, and its peak device
    bytes above the resident ones."""
    import torch

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - resident)


def spatial_worker(seed: int, workdir: str) -> dict:
    """One rank of the gloo world on the one card: the 64x64 generator's
    and critic's forward with y split over the world (P 4) and over the
    spatial axis of a (data 2, spatial 2) grid (P 2), in f32 and bf16
    against the same forward in this process without a mesh; then the f32
    step on the grid from mid-training Adam moments against the
    single-process step on the same global draws, its gradients update by
    update too, and the grid step with a planted fault.  Seconds, the halo
    exchanges' share and peak bytes beside one device's."""
    import torch

    from prdisagg_torch.core.config import TrainConfig, large_domain_experiment
    from prdisagg_torch.data.indices import compute_valid_indices
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset_torch
    from prdisagg_torch.models.critic import Critic
    from prdisagg_torch.models.generator import Generator
    from prdisagg_torch.parallel import spatial
    from prdisagg_torch.parallel.distributed import initialize_multihost
    from prdisagg_torch.parallel.mesh import make_mesh, make_mesh_2d
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import clone_train_state, create_train_state

    check(initialize_multihost(device=CARD, backend="gloo"),
          "the launcher's environment started no process group")
    line = make_mesh(SPATIAL_WORLD, device=CARD, axis="spatial")
    grid = make_mesh_2d(2, SPATIAL_WORLD // 2, device=CARD)
    exp = large_domain_experiment()
    counts = collections.Counter()

    def counted(fn):
        """fn() with its K1 and K2 launches added to the path's."""
        _reset_counts()
        res = fn()
        torch.cuda.synchronize()
        counts.update(_dp_counts())
        return res

    out = {"rank": line.rank, "forward": {}}
    dev = torch.device(CARD, torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    lat = torch.randn((SPATIAL_BATCH, 100), generator=g, device=dev)
    cond = 0.1 * torch.rand((SPATIAL_BATCH, ND_LARGE, ND_LARGE, 1),
                            generator=g, device=dev)
    # one set of weights, made on the card from the seed alike on every
    # rank, shared by the nets of both dtypes with and without the mesh
    torch.manual_seed(seed)
    with torch.device(dev):
        weights = [Generator(exp.model()).state_dict(),
                   Critic(exp.model()).state_dict()]

    def nets(cfg):
        with torch.device("meta"):
            pair = Generator(cfg), Critic(cfg)
        for net, sd in zip(pair, weights):
            net.load_state_dict(sd, assign=True)
        return pair

    for dname in ("float32", "bfloat16"):
        base = dataclasses.replace(exp.model(), compute_dtype=dname)
        check(base.latent_dim == lat.shape[1] and base.ndomain == ND_LARGE,
              base)
        gen, critic = nets(base)
        gs, cs = nets(dataclasses.replace(base, spatial_axis="spatial"))
        with torch.no_grad():
            ref = gen(lat, cond)
            ref_scores = critic(ref, cond)
            one = {"seconds": _seconds(lambda: gen(lat, cond), SPATIAL_REPS),
                   "peak_bytes": _timed_peak(lambda: gen(lat, cond))[1]}
            rtol, atol = TOL[dname] if dname == "bfloat16" else (0.0, 1e-5)
            for name, mesh in (("p4", line), ("p2", grid)):
                sp = mesh.axis_mesh("spatial")
                with spatial.use_mesh(mesh):
                    rows = counted(lambda: gs(lat, cond))
                    full = gs.assemble(rows)
                    scores = counted(lambda: cs(
                        spatial.shard_rows(ref, 2, sp), cond))
                    fwd = lambda: gs(lat, cond)  # noqa: E731
                    row = {
                        "rows": list(rows.shape),
                        "seconds": _seconds(fwd, SPATIAL_REPS),
                        "halo": _halo_share(fwd),
                        "peak_bytes": _timed_peak(fwd)[1],
                        "one_device": one}
                ok_g, err_g, max_g = _compare(full, ref, rtol, atol)
                ok_c, err_c, max_c = _compare(scores, ref_scores, rtol, atol)
                lo, hi = spatial.own_rows(ND_LARGE, sp)
                row.update(gen_ok=ok_g and torch.equal(
                    rows, full[:, :, lo:hi]), gen_err_over_max=err_g / max_g,
                    critic_ok=ok_c, critic_err_over_max=err_c / max_c,
                    rtol=rtol, atol_over_max=atol)
                out["forward"][f"{name}_{dname}"] = row
        del gen, critic, gs, cs, ref, full
    del weights
    torch.cuda.empty_cache()

    # the f32 step on the (data, spatial) grid against one process's
    c = LARGE_F32_CHECK
    mc = dataclasses.replace(exp.model(), compute_dtype="float32")
    sp_cfg = dataclasses.replace(mc, spatial_axis="spatial")
    tcfg = TrainConfig(n_disc=c["n_disc"], seed=seed)
    days, ny, nx = SPATIAL_DATASET
    data, _, _ = make_synthetic_dataset_torch(days, ny, nx, seed, dev,
                                              cfg=exp.data)
    ds = DeviceDataset.from_tensor(data, compute_valid_indices(
        data, exp.data), exp.data)
    single = create_train_state(mc, tcfg, device=dev)
    _warm_adam(single, seed)
    state = clone_train_state(single, sp_cfg, tcfg, dev)
    fault = clone_train_state(single, sp_cfg, tcfg, dev)
    draws = wgan_gp.draw_step_inputs(single, ds, c["batch"], c["n_disc"])
    log_one = _GradLog(single)
    m_one = wgan_gp.unpack_metrics(wgan_gp.train_step_on(
        single, ds, draws, tcfg)["packed"])
    log_one.close()
    log_sp = _GradLog(state, log_one.grads)
    spatial.exchanges.clear()
    m_sp = counted(lambda: wgan_gp.unpack_metrics(wgan_gp.train_step_on(
        state, ds, draws, tcfg, mesh=grid)["packed"]))
    log_sp.close()
    losses = ("d_loss", "gp", "w_distance", "g_loss")
    scale = max(abs(m_one[k]) for k in losses)
    step = {"loss_err_over_scale": max(abs(m_sp[k] - m_one[k])
                                       for k in losses) / scale,
            "param_err_over_max": _param_err(state, single),
            "grad_err": log_sp.err, "grad_worst": log_sp.worst,
            "updates": len(log_sp.grads),
            "nonfinite": m_sp["nonfinite"],
            "exchanges": dict(spatial.exchanges)}
    # the same step with a fault planted: the latent projection's
    # gradient, whole on every rank, summed over the spatial axis (counted
    # twice); the gradient check must catch it
    log_fault = _GradLog(fault, log_one.grads)
    partial = fault.gen.spatial_partial_params
    fault.gen.spatial_partial_params = (
        lambda: partial() | {"latent_proj.weight"})
    wgan_gp.train_step_on(fault, ds, draws, tcfg, mesh=grid)
    log_fault.close()
    del fault.gen.spatial_partial_params
    step["planted_fault"] = {"grad_err": log_fault.err,
                             "grad_worst": log_fault.worst,
                             "param_err_over_max": _param_err(fault, single)}
    probe = state
    del single, fault, log_one
    torch.cuda.empty_cache()
    go = lambda: wgan_gp.train_step_on(  # noqa: E731
        probe, ds, draws, tcfg, mesh=grid)
    step["seconds"], step["peak_bytes"] = counted(lambda: _timed_peak(go))
    step["halo"] = counted(lambda: _halo_share(go))
    one = clone_train_state(probe, mc, tcfg, dev)
    secs, peak = _timed_peak(lambda: wgan_gp.train_step_on(
        one, ds, draws, tcfg))
    step["one_device"] = {"seconds": secs, "peak_bytes": peak}
    # gloo's collectives cannot be captured: the graphed step refuses
    try:
        wgan_gp.make_train_step(sp_cfg, tcfg, c["batch"], mesh=grid)(
            probe, ds)
        step["graph_refused"] = False
    except ValueError as e:
        step["graph_refused"] = "cannot be captured" in str(e)
    out["step"] = step
    out["counts"] = dict(counts)
    return out


def phase_spatial(seed: int, workdir: str, card: str) -> dict:
    """Spatial sharding through SPATIAL_WORLD gloo workers on the one card
    (phase 21 of the docstring), alone."""
    os.makedirs(workdir, exist_ok=True)
    me = [os.path.abspath(__file__), "--seed", str(seed), "--workdir",
          workdir, "--spatial-worker"]
    port = _free_port()
    t0 = time.perf_counter()
    procs = {f"spatial{r}": _dp_proc(me, r, SPATIAL_WORLD, 0, port,
                                     os.path.join(workdir, f"spatial{r}.out"))
             for r in range(SPATIAL_WORLD)}
    ends = _wait_all(procs, SPATIAL_LIMIT_S, t0)
    ranks = [_worker_result(name, workdir, proc, ends[name])
             for name, proc in procs.items()]
    counts = collections.Counter()
    for r in ranks:
        counts.update(r["counts"])
        for name, f in r["forward"].items():
            print(f"[spatial] rank {r['rank']} forward {name} ({card}; "
                  f"{SPATIAL_WORLD} gloo ranks share the card, so seconds "
                  f"are not rates of one device): " + json.dumps(f))
            check(f["gen_ok"] and f["critic_ok"],
                  f"spatial forward {name} differs from one device's: {f}")
        st = r["step"]
        print(f"[spatial] rank {r['rank']} data 2 x spatial 2 f32 step "
              f"({card}): " + json.dumps(st))
        check(st["loss_err_over_scale"] <= DP_TOL
              and st["param_err_over_max"] <= DP_TOL
              and st["grad_err"] <= SPATIAL_GRAD_TOL
              and st["updates"] == LARGE_F32_CHECK["n_disc"] + 1
              and st["planted_fault"]["grad_err"] > SPATIAL_GRAD_TOL
              and not st["nonfinite"] and st["graph_refused"]
              and st["exchanges"].get("halo", 0) > 0, f"spatial step: {st}")
    check(counts["upsample2_conv3_general"] == 0
          and counts["upsample2_conv3_backward_dx_general"] == 0
          and counts["upsample2_conv3_backward_dk_general"] == 0
          and counts["upsample2_conv3"] > 0
          and counts["upsample2_conv3_backward"] > 0
          and counts["gather_patches"] > 0,
          f"spatial launches {dict(counts)}")
    return {"ranks": ranks, "counts": _path_counts(counts),
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the data pipeline and the ops surface (phases 16 and 17)
# ---------------------------------------------------------------------------

def _cli_argv(args: list) -> list:
    """The command line of one ``python -m prdisagg_torch.cli`` call."""
    return [sys.executable, "-m", "prdisagg_torch.cli", *args]


def _cli_run(args: list, timeout: float):
    """One CLI subprocess from the repository root, its output captured."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run(_cli_argv(args), cwd=root, capture_output=True,
                          text=True, timeout=timeout)


def _cli_ok(name: str, r) -> None:
    check(r.returncode == 0, f"cli {name} failed (rc {r.returncode}):\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")


def _raw_corpus(seed: int):
    """(DATA_DAYS, 288, ny, nx) uint8 SMHI bytes made on the card from
    `seed`: the encoding dBZ = x * 0.4 - 30 with 255 missing, two drifting
    rain blobs a day with an afternoon peak, noise, and a missing border of
    two rows (what a real composite's out-of-range edge looks like)."""
    import torch

    ny, nx = DATASET_SHAPE[2:]
    g = torch.Generator(device=CARD).manual_seed(seed + 21)
    yy, xx = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=CARD),
        torch.arange(nx, dtype=torch.float32, device=CARD), indexing="ij")
    hours = torch.arange(288, dtype=torch.float32, device=CARD) / 12.0
    envelope = (0.35 + 0.65 * torch.exp(-(hours - 15.0) ** 2 / 18.0))
    raw = torch.empty((DATA_DAYS, 288, ny, nx), dtype=torch.uint8,
                      device=CARD)
    for d in range(DATA_DAYS):
        dbz = torch.randn((288, ny, nx), generator=g, device=CARD) * 1.5
        for _ in range(2):
            start = torch.rand(2, generator=g, device=CARD) * ny
            path = (start + torch.cumsum(
                torch.randn((288, 2), generator=g, device=CARD) * 0.8,
                dim=0)) % ny
            d2 = (((yy - path[:, 0, None, None]) % ny) ** 2
                  + ((xx - path[:, 1, None, None]) % nx) ** 2)
            dbz += 45.0 * envelope[:, None, None] * torch.exp(
                -d2 / (2 * (ny / 6) ** 2))
        day = torch.clamp((dbz + 30.0) / 0.4, 0, 254).to(torch.uint8)
        day[:, :2, :] = 255
        raw[d] = day
    return raw.cpu().numpy()


def phase_data(seed: int, workdir: str) -> dict:
    """The data pipeline at the per-day size of a real day (phase 16 of the
    docstring): raw bytes -> per-day .nc -> training tensor and doy sidecar
    -> valid indices -> the K2 patch store -> ``cli train --conditioning
    doy`` on the files, and the trained generator's conservation."""
    import datetime
    import importlib.util
    import pickle

    import numpy as np
    import torch

    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import DataConfig
    from prdisagg_torch.data.indices import (
        compute_valid_indices,
        compute_valid_indices_streamed,
    )
    from prdisagg_torch.data.ingest import convert_day, day_of_year
    from prdisagg_torch.data.native import extract_patch_store
    from prdisagg_torch.data.netcdf_io import convert_and_write_days
    from prdisagg_torch.ops import core, gather, upsample_conv

    os.makedirs(workdir, exist_ok=True)
    torch.cuda.empty_cache()
    first = datetime.date.fromisoformat(DATA_FIRST_DAY)
    dates = [(first + datetime.timedelta(days=d)).strftime("%Y%m%d")
             for d in range(DATA_DAYS)]
    stages: dict = {}

    def stage(name, mb, fn):
        t0 = time.perf_counter()
        r = fn()
        secs = time.perf_counter() - t0
        stages[name] = {"seconds": secs, "MB": mb, "MB_per_s": mb / secs}
        print(f"[data] {name}: {secs:.2f} s, {mb:.1f} MB, "
              f"{mb / secs:.1f} MB/s", flush=True)
        return r

    ny, nx = DATASET_SHAPE[2:]
    raw_mb = DATA_DAYS * 288 * ny * nx / 1e6
    raw = stage("corpus", raw_mb, lambda: _raw_corpus(seed))
    nc_dir = os.path.join(workdir, "nc")
    tiff_dir = os.path.join(workdir, "tiffs")
    if importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        def write_tiffs():
            for date, day in zip(dates, raw):
                os.makedirs(os.path.join(tiff_dir, date))
                for step, frame in enumerate(day):
                    Image.fromarray(frame, mode="L").save(os.path.join(
                        tiff_dir, date, f"radar_{date}_{step:03d}.tif"))

        stage("write_tiffs", raw_mb, write_tiffs)
        r = stage("convert", raw_mb, lambda: _cli_run(
            ["convert-tiffs", "--tiff-dir", tiff_dir, "--out-dir", nc_dir],
            600))
        _cli_ok("convert-tiffs", r)
        route = "cli convert-tiffs (Pillow installed)"
    else:
        os.makedirs(tiff_dir)
        r = _cli_run(["convert-tiffs", "--tiff-dir", tiff_dir, "--out-dir",
                      nc_dir], 300)
        print(f"[data] cli convert-tiffs without a TIFF reader: rc "
              f"{r.returncode}, {r.stderr.strip().splitlines()[-1:]}")
        check(r.returncode != 0 and "rasterio" in r.stderr
              and "Pillow" in r.stderr and not os.path.exists(nc_dir),
              f"convert-tiffs did not refuse: {r.stdout[-1000:]} "
              f"{r.stderr[-1000:]}")
        failed = stage("convert", raw_mb, lambda: convert_and_write_days(
            zip(dates, raw), nc_dir))
        check(failed == [], f"failed days {failed}")
        route = ("convert_and_write_days in process (no TIFF reader; cli "
                 "convert-tiffs refused, naming rasterio and Pillow)")
    print(f"[data] convert stage: {route}")
    nc_mb = sum(os.path.getsize(os.path.join(nc_dir, f))
                for f in os.listdir(nc_dir)) / 1e6
    prefix = os.path.join(workdir, "tensor")
    r = stage("reformat_nc", nc_mb, lambda: _cli_run(
        ["reformat-nc", "--nc-dir", nc_dir, "--out", prefix], 600))
    _cli_ok("reformat-nc", r)
    tensor = np.load(prefix + ".npy", mmap_mode="r")
    want = np.stack([convert_day(day) for day in raw])
    check(tensor.shape == want.shape and tensor.dtype == np.float32
          and np.array_equal(np.asarray(tensor).view(np.uint32),
                             want.view(np.uint32)),
          "reformat-nc's tensor differs from convert_day of the raw days")
    doy = np.load(prefix + "_doy.npy")
    want_doy = np.array([datetime.date(int(d[:4]), int(d[4:6]), int(d[6:]))
                         .timetuple().tm_yday for d in dates], np.float32)
    check(np.array_equal(doy, want_doy)
          and np.array_equal(doy, day_of_year(dates)), f"doy {doy}")
    del want
    tensor_mb = tensor.nbytes / 1e6
    idx_path = os.path.join(workdir, "indices.pkl")
    r = stage("compute_indices", tensor_mb, lambda: _cli_run(
        ["compute-indices", "--data", prefix + ".npy", "--out", idx_path],
        300))
    _cli_ok("compute-indices", r)
    with open(idx_path, "rb") as fh:
        rows = np.asarray(pickle.load(fh), dtype=np.int32)
    cfg = DataConfig()
    want_rows = compute_valid_indices(np.asarray(tensor), cfg)
    check(rows.shape == want_rows.shape and np.array_equal(rows, want_rows),
          f"compute-indices on the card: {rows.shape} rows against "
          f"{want_rows.shape} on the CPU")
    n_days_with_rows = len(np.unique(rows[:, 0]))
    print(f"[data] {len(rows)} valid rows on {n_days_with_rows} of "
          f"{DATA_DAYS} days, equal to compute_valid_indices on the CPU")
    check(len(rows) > 0, "no valid rows")

    reset_k1_counts()
    gather.launches = 0
    scans = {}
    for k in DATA_SCAN_CHUNKS:
        torch.cuda.synchronize()
        scans[k] = stage(f"scan_chunk{k}", tensor_mb,
                         lambda: compute_valid_indices_streamed(
                             tensor, cfg, device=CARD, days_per_chunk=k))
        check(np.array_equal(scans[k], want_rows),
              f"the streamed scan at {k} days a chunk differs")
    for k in DATA_SCAN_CHUNKS:
        stages[f"scan_chunk{k}"]["days_per_s"] = (
            DATA_DAYS / stages[f"scan_chunk{k}"]["seconds"])
    torch.cuda.synchronize()
    store = stage("patch_store", tensor_mb, lambda: extract_patch_store(
        tensor, rows, cfg.ndomain, device=CARD))
    store_launches = gather.launches
    st = stages["patch_store"]
    st["days_per_s"] = DATA_DAYS / st["seconds"]
    st["rows_per_s"] = len(rows) / st["seconds"]
    plain = extract_patch_store(tensor, rows, cfg.ndomain, device="cpu")
    nd = cfg.ndomain
    sliced = np.stack([tensor[t, :, y:y + nd, x:x + nd] for t, y, x in rows])
    check(store.shape == (len(rows), 24, nd, nd)
          and np.array_equal(store, plain),
          "the K2 patch store differs from the plain gather")
    check(np.array_equal(store.view(np.uint32), sliced.view(np.uint32)),
          "the K2 patch store differs from numpy slices of the memmap")
    check(store_launches == n_days_with_rows,
          f"{store_launches} K2 launches for {n_days_with_rows} days")
    print(f"[data] patch store through K2: {len(rows)} rows, "
          f"{store_launches} launches, bit-exact against the plain gather "
          f"and against numpy slices of the memmap; "
          f"{st['days_per_s']:.1f} days/s, {st['rows_per_s']:.0f} rows/s")

    train_dir = os.path.join(workdir, "train")
    r = stage("cli_train", tensor_mb, lambda: _cli_run(
        ["train", "--data", prefix + ".npy", "--indices", idx_path,
         "--conditioning", "doy", "--doy", prefix + "_doy.npy",
         "--epochs", "2", "--steps-per-epoch", str(DATA_TRAIN_STEPS),
         "--export-format", "npz", "--plot-every-epochs", "0",
         "--workdir", train_dir, "--seed", str(seed)], 600))
    _cli_ok("train --conditioning doy", r)
    print(f"[data] cli train --conditioning doy: "
          f"{r.stdout.strip().splitlines()[-1:]}")
    outdir = os.path.join(train_dir, "trained_models", "wgancp_pixelnorm")
    npz = os.path.join(outdir, sorted(
        f for f in os.listdir(outdir) if f.startswith("gen_"))[-1])
    check(npz.endswith("_0002.npz"), npz)
    gen = PretrainedGenerator.from_npz(npz, None, n_cond_channels=3,
                                       device=CARD)
    sel = rows[:: max(1, len(rows) // DATA_CONDS)][:DATA_CONDS]
    daily = np.stack([tensor[t, :, y:y + nd, x:x + nd].sum(axis=0)
                      for t, y, x in sel])
    angle = 2 * np.pi * doy[sel[:, 0]] / 365.0
    conds = np.concatenate(
        [daily[..., None],
         np.broadcast_to(np.sin(angle)[:, None, None, None], daily.shape
                         + (1,)),
         np.broadcast_to(np.cos(angle)[:, None, None, None], daily.shape
                         + (1,))], axis=-1).astype(np.float32)
    check(len(conds) * DATA_SCENARIOS == SCENARIOS == STAGES[0][1]
          and gen.max_batch >= SCENARIOS,
          f"the doy forward's batch {len(conds)} x {DATA_SCENARIOS} is not "
          f"one held in K1_CASES")
    scen = gen.generate_scenarios_batch(conds, DATA_SCENARIOS)
    cons = _conservation_err(scen, daily[:, None])
    print(f"[data] the trained doy generator: {scen.shape} scenarios, "
          f"conservation {cons:.3e} (bound {CONSERVATION_RTOL})")
    check(np.isfinite(scen).all() and cons <= CONSERVATION_RTOL,
          f"conservation {cons}")
    counts = {"upsample2_conv3": upsample_conv.launches,
              "upsample2_conv3_by_variant": dict(
                  upsample_conv.launches_by_variant),
              "gather_patches": gather.launches,
              "pixel_norm_leaky": core.pixel_norm_launches}
    check(counts["upsample2_conv3"] > 0 and counts["gather_patches"] > 0,
          f"the data path launched no kernel: {counts}")
    print("[data] " + json.dumps({"stages": stages, "rows": len(rows),
                                  "counts": counts}))
    return {"counts": counts, "stages": stages, "rows": len(rows),
            "route": route, "conservation": cons}


def _find_pid(marker: str, exclude: str) -> int:
    """The pid whose command line holds `marker` and not `exclude`."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().decode(errors="replace").split("\0")
        except OSError:
            continue
        if marker in cmd and exclude not in cmd:
            return int(pid)
    raise AssertionError(f"no process with {marker} in its command line")


def phase_ops(seed: int, cli_workdir: str, workdir: str) -> dict:
    """The ops surface (phase 17 of the docstring): ``cli doctor`` healthy,
    ``cli doctor --timeout`` shorter than a torch import (the wedge
    signature), and a supervised flagship run whose training child is
    SIGSTOPped after its first heartbeat, then killed, the card probed, and
    the run relaunched, resumed and finished."""
    import shutil

    os.makedirs(workdir, exist_ok=True)
    run_dir = os.path.join(workdir, "run")
    shutil.copytree(cli_workdir, run_dir)  # checkpoints of epochs 2 and 3
    hb = os.path.join(workdir, "heartbeat")
    train = _cli_argv(
        ["train", "--synthetic", "--steps-per-epoch", str(CLI_STEPS),
         "--export-format", "npz", "--plot-every-epochs", "0", "--seed",
         str(seed), "--epochs", str(OPS_EPOCHS), "--resume", "--workdir",
         run_dir])
    root = os.path.dirname(os.path.abspath(__file__))
    out_path = os.path.join(workdir, "supervise.out")
    t0 = time.perf_counter()
    with open(out_path, "w") as fo:
        sup = subprocess.Popen(
            _cli_argv(["supervise", "--heartbeat", hb, "--stall-timeout",
                       str(OPS_STALL_S), "--startup-timeout", "600",
                       "--max-restarts", "1", "--", *train]),
            cwd=root, stdout=fo, stderr=subprocess.STDOUT, text=True)
    # the doctors run beside the supervised run, their probes on the card
    # while the training child holds it
    doctors = {name: subprocess.Popen(
        _cli_argv(["doctor", *extra]), cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, extra in (("healthy", []), ("timeout", [
            "--timeout", str(OPS_SHORT_TIMEOUT)]))}
    deadline = time.perf_counter() + 300
    while not os.path.exists(hb):
        check(sup.poll() is None, "the supervised run ended before a beat")
        check(time.perf_counter() < deadline, "no heartbeat in 300 s")
        time.sleep(0.05)
    t_beat = time.perf_counter() - t0
    child = _find_pid(run_dir, "supervise")
    os.kill(child, signal.SIGSTOP)
    print(f"[ops] first heartbeat after {t_beat:.1f} s; SIGSTOP to the "
          f"training child {child}", flush=True)
    res = {}
    for name, proc in doctors.items():
        stdout, _ = proc.communicate(timeout=300)
        rep = json.loads(stdout[stdout.index("{"):])
        res[f"doctor_{name}"] = {"rc": proc.returncode, **rep}
        print(f"[ops] cli doctor ({name}): rc {proc.returncode} {rep}")
    check(res["doctor_healthy"]["rc"] == 0 and res["doctor_healthy"]["ok"],
          res["doctor_healthy"])
    check(res["doctor_timeout"]["rc"] == 1
          and res["doctor_timeout"]["detail"] == "timeout",
          res["doctor_timeout"])
    try:
        rc = sup.wait(timeout=OPS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        sup.kill()
        sup.wait()
        os.kill(child, signal.SIGKILL)
        raise
    wall = time.perf_counter() - t0
    with open(out_path) as fh:
        text = fh.read()
    print("[ops] supervise: " + " | ".join(
        ln for ln in text.splitlines() if ln.startswith(
            ("[supervise]", "resumed", "finished"))))
    check(rc == 0 and "rc=0 restarts=1 stalls=1" in text,
          f"supervise rc {rc}:\n{text[-3000:]}")
    check("step stall" in text and "device healthy (probe" in text
          and text.count("resumed at epoch 3") == 2
          and f"finished at epoch {OPS_EPOCHS}" in text, text[-3000:])
    with open(os.path.join(run_dir, "hist.csv")) as fh:
        epochs = [line.rsplit(",", 1)[-1].strip()
                  for line in fh.read().splitlines()[1:]]
    check(epochs == [str(e) for e in range(1, OPS_EPOCHS + 1)], epochs)
    print(f"[ops] supervised run: rc 0, restarts=1 stalls=1, hist.csv "
          f"epochs {epochs}, {wall:.1f} s")
    res.update(supervise_seconds=wall, first_beat_seconds=t_beat,
               hist_epochs=epochs)
    return res


def phase_variants(ds, seed: int, workdir: str) -> dict:
    """The 64x64 large domain and the lon variant on the card-resident
    dataset.  64x64: Trainer.fit of large_domain_experiment() at the
    training cell's defaults (bf16, B 32, n_disc 5), graphed, on the same
    tensor's nd-64, n_thresh-40 rows; the kernels counted through the
    wrappers and by name in a profiled call of replays (busy ms a step,
    K1's share, idle share), the first call's and a replay's peak bytes,
    the trained generator's conservation, one f32 step with K1's kernels
    against K1's plain route on the card, and f32 generate_scenarios at the
    default max_batch (scenarios/s; peak bytes within half the card;
    conservation).  lon: Trainer.fit of lon_experiment() at the flagship
    16x16, graphed, its conservation, and its .npz export's f32 forward
    against the live generator's."""
    import numpy as np
    import torch

    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import (
        ModelConfig,
        TrainConfig,
        large_domain_experiment,
        lon_experiment,
    )
    from prdisagg_torch.data.indices import compute_valid_indices
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.ops import core, upsample_conv
    from prdisagg_torch.train.loop import Trainer
    from prdisagg_torch.train.wgan_gp import make_train_step

    def train_cfg(epochs, steps, checkpoint=0):
        return TrainConfig(n_disc=N_DISC, schedule=((epochs, TRAIN_BATCH),),
                           seed=seed, log_every_steps=steps,
                           checkpoint_every_epochs=checkpoint)

    os.makedirs(workdir, exist_ok=True)
    out = {}
    # -- the 64x64 large domain: no exports or checkpoints (the dense layer
    # alone is 206M parameters)
    epochs = LARGE_WARM_EPOCHS + LARGE_TIMED_EPOCHS
    exp = dataclasses.replace(large_domain_experiment(),
                              train=train_cfg(epochs, LARGE_STEPS))
    ds64 = DeviceDataset.from_tensor(
        ds.data, compute_valid_indices(ds.data, exp.data), exp.data)
    check(ds64.data.data_ptr() == ds.data.data_ptr(), "from_tensor copied")
    print(f"[variants] 64x64: {ds64.n_samples} valid rows of nd "
          f"{ds64.cfg.ndomain}, n_thresh {ds64.cfg.n_thresh}, in the "
          f"resident {tuple(ds.data.shape)} tensor")
    trainer = Trainer(exp, ds64, os.path.join(workdir, "large_domain"),
                      steps_per_epoch=LARGE_STEPS, plot_every_epochs=0,
                      export_weights_every_epochs=0, export_format="npz")
    check(trainer.model_cfg.ndomain == 64
          and trainer.model_cfg.compute_dtype == "bfloat16", exp)
    per_step = train_per_step(stages=LARGE_STAGES)
    _, counts = _fit_counted(trainer, epochs * LARGE_STEPS, per_step,
                             "variants")
    timed = sum(trainer.epoch_seconds[LARGE_WARM_EPOCHS:])
    graphed = LARGE_TIMED_EPOCHS * LARGE_STEPS / timed
    step_fn = make_train_step(trainer.model_cfg, exp.train, TRAIN_BATCH,
                              steps_per_call=LARGE_PROFILE_REPLAYS)
    peaks = _step_peaks(step_fn, trainer.state, ds64)
    prof = _graph_kernels(step_fn, trainer.state, ds64, per_step,
                          f"one call of {LARGE_PROFILE_REPLAYS} graphed 64x64"
                          f" steps, bf16 batch {TRAIN_BATCH}", "variants",
                          LARGE_PROFILE_REPLAYS)
    k1_ms = sum(ms for n, ms in prof["kernel_ms_per_step"].items()
                if n.startswith("k1_"))
    cons = _conserves(trainer.state.gen, ds64, seed, N_DISC * TRAIN_BATCH)
    row = {"graphed_steps_per_s": graphed, "timed_steps":
           LARGE_TIMED_EPOCHS * LARGE_STEPS, "timed_s": timed,
           "warm_epoch_s": trainer.epoch_seconds[0],
           "busy_ms_per_step": prof["busy_ms_per_step"],
           "idle_share": prof["idle_share"], "k1_ms_per_step": k1_ms,
           "k1_share_of_busy": k1_ms / prof["busy_ms_per_step"],
           "first_call_peak_bytes": peaks[0], "replay_peak_bytes": peaks[1],
           "conservation": cons}
    print("[variants] 64x64 graphed train: " + json.dumps(row))
    out["large_domain"] = row
    c = LARGE_F32_CHECK
    out["large_domain_f32"] = _f32_step_check(
        trainer.state, ds64, seed, c["n_disc"], c["batch"], c["rtol"],
        against="plain")
    del trainer, step_fn
    torch.cuda.empty_cache()

    # -- 64x64 f32 serving at the default max_batch
    cfg64 = ModelConfig(ndomain=ND_LARGE, compute_dtype="float32")
    npz = os.path.join(workdir, "gen_64x64.npz")
    np.savez(npz, **{f"params/{layer}/{kind}": arr for layer, d in
                     _random_generator_tree(cfg64, seed).items()
                     for kind, arr in d.items()})
    gen = PretrainedGenerator.from_npz(npz, seed=seed)
    check(gen.cfg == cfg64, gen.cfg)
    cond = np.random.RandomState(seed + 2).gamma(
        0.6, 12.0, (ND_LARGE, ND_LARGE)).astype("f4")
    n = gen.max_batch
    reset_k1_counts()
    t0 = time.perf_counter()
    scen = gen.generate_scenarios(cond, n)
    first = time.perf_counter() - t0
    serve_counts = {"upsample2_conv3": upsample_conv.launches,
                    "upsample2_conv3_by_variant":
                        dict(upsample_conv.launches_by_variant),
                    "pixel_norm_leaky": core.pixel_norm_launches}
    check(serve_counts["upsample2_conv3_by_variant"] == k1_forward_expected(
        "float32", [n], [s[:1] + s[1:] for s in LARGE_STAGES])
          and serve_counts["pixel_norm_leaky"] == 3, serve_counts)
    check(scen.shape == (n, 24, ND_LARGE, ND_LARGE)
          and np.isfinite(scen).all(), scen.shape)
    scen_cons = _conservation_err(scen, cond)
    del scen
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        gen.generate_scenarios(cond, n)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen.generate_scenarios(cond, n)
    peak = torch.cuda.max_memory_allocated() - base
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    row = {"n": n, "max_batch": gen.max_batch,
           "scenarios_per_s": n / statistics.median(walls),
           "median_s": statistics.median(walls), "first_s": first,
           "peak_bytes": peak, "peak_bytes_per_scenario": peak / n,
           "card_bytes": card_bytes, "peak_share_of_card": peak / card_bytes,
           "conservation": scen_cons}
    print("[variants] 64x64 f32 generate_scenarios: " + json.dumps(row))
    check(scen_cons <= CONSERVATION_RTOL, f"conservation {scen_cons}")
    check(peak <= card_bytes / 2, f"64x64 serving takes over half the "
          f"card at max_batch {n}: {row}")
    out["large_domain_serving"] = row
    out["f32_layers"] = _f32_layers(gen._gen, seed)
    del gen
    torch.cuda.empty_cache()

    # -- lon at the flagship 16x16, on the dataset's own rows
    exp = dataclasses.replace(lon_experiment(),
                              train=train_cfg(LON_EPOCHS, LON_STEPS))
    ds_lon = DeviceDataset.from_tensor(ds.data, ds.indices, exp.data)
    trainer = Trainer(exp, ds_lon, os.path.join(workdir, "lon"),
                      steps_per_epoch=LON_STEPS, plot_every_epochs=0,
                      export_weights_every_epochs=LON_EPOCHS,
                      export_format="npz")
    check(trainer.model_cfg.n_cond_channels == 2, trainer.model_cfg)
    _, lon_counts = _fit_counted(trainer, LON_EPOCHS * LON_STEPS,
                                 train_per_step(), "variants")
    lon_cons = _conserves(trainer.state.gen, ds_lon, seed,
                          N_DISC * TRAIN_BATCH)
    export = os.path.join(trainer.outdir, f"gen_{trainer.params_str}_"
                          f"{LON_EPOCHS:04d}.npz")
    loaded = PretrainedGenerator.from_npz(export, n_cond_channels=2,
                                          seed=seed)
    live = PretrainedGenerator(
        {k: v.detach().clone() for k, v in trainer.state.gen.state_dict()
         .items()}, dataclasses.replace(trainer.model_cfg,
                                        compute_dtype="float32"), seed=seed)
    g = torch.Generator(device=ds.device).manual_seed(seed + 8)
    lat = torch.randn((SCENARIOS, live.cfg.latent_dim), generator=g,
                      device=ds.device)
    _, cond = ds_lon.sample_real(SCENARIOS, g)
    a, b = live.predict_fractions(lat, cond), loaded.predict_fractions(
        lat, cond)
    err, scale = (a - b).abs().max().item(), a.abs().max().item()
    row = {"steps": LON_EPOCHS * LON_STEPS,
           "steps_per_s": LON_EPOCHS * LON_STEPS / sum(trainer.epoch_seconds),
           "conservation": lon_cons, "export": os.path.basename(export),
           "round_trip_max_abs": err, "round_trip_max": scale,
           "round_trip_samples": SCENARIOS}
    print("[variants] lon: " + json.dumps(row))
    check(loaded.cfg.n_cond_channels == 2 and err <= 1e-5 * scale,
          f"the lon export does not round-trip: {row}")
    out["lon"] = row
    total = _add_counts(_add_counts(counts, lon_counts), {
        **serve_counts, "upsample2_conv3_backward": 0,
        "upsample2_conv3_backward_kernels": dict.fromkeys(
            counts["upsample2_conv3_backward_kernels"], 0),
        "gather_patches": 0})
    out["counts"] = total
    return out


def _protocol_proc(module: str, args: list, workdir: str, name: str):
    """`python -m prdisagg_torch.protocols.<module>` on the card, its
    output in WORKDIR/<name>.log; returns (process, log, start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(workdir, f"{name}.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", f"prdisagg_torch.protocols.{module}",
             *args], cwd=root, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True), log, time.perf_counter()
    except OSError:
        log.close()
        raise


def _kill_protocols(procs: dict) -> None:
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        log.close()


def _protocols_wait(procs: dict, workdir: str, limit: float) -> dict:
    """Waits for each (process, log, start) of `procs`, killing any still
    running after `limit` seconds; returns {name: {rc, seconds since its
    start}} and fails on a non-zero exit, with its log's tail."""
    t0, out, bad = time.perf_counter(), {}, []
    for name, (proc, log, start) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, limit - (time.perf_counter()
                                                     - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
        finally:
            log.close()
        out[name] = {"rc": rc, "seconds": time.perf_counter() - start}
        print(f"[protocols] {name}: " + json.dumps(out[name]))
        if rc != 0:
            with open(os.path.join(workdir, f"{name}.log")) as fh:
                print(fh.read()[-4000:])
            bad.append(name)
    check(not bad, f"protocol drivers failed: {bad}")
    return out


def start_protocols(workdir: str) -> dict:
    """Starts the protocol drivers as subprocesses on the card at flagship
    width, cut in depth: protocols.large_domain and protocols.variants
    (PROTOCOL_DAYS training days and their own held-out days, 2 epochs),
    protocols.paper with --mini's battery
    (PAPER_RUN's days and epochs) and protocols.l1_rehearsal.  The card
    has no h5py and no matplotlib: exports are .npz and figures off.
    Returns what phase_protocols waits for."""
    os.makedirs(workdir, exist_ok=True)
    days = str(PROTOCOL_DAYS)
    npz = ["--export-format", "npz"]
    paper_wd = os.path.join(workdir, "paper")
    paper = ["--mini", "--n-days", str(PAPER_RUN[0]), "--heldout-days",
             str(PAPER_RUN[1]), "--epochs", str(PAPER_RUN[2]), "--no-plots",
             "--workdir", paper_wd, *npz]
    procs = {}
    try:
        for name, module, args in (
                ("paper", "paper", paper),
                ("large_domain", "large_domain",
                 [days, "2", "32", "1", "2", "--no-plots", "--workdir",
                  os.path.join(workdir, "large_domain"), *npz]),
                ("variants", "variants",
                 [days, "2", "--workdir",
                  os.path.join(workdir, "variants"), *npz]),
                ("l1_rehearsal", "l1_rehearsal",
                 [os.path.join(workdir, "l1"), "--no-plots", *npz])):
            procs[name] = _protocol_proc(module, args, workdir, name)
    except BaseException:
        _kill_protocols(procs)
        raise
    return {"workdir": workdir, "paper": paper, "procs": procs,
            "paper_wd": paper_wd,
            "t0": time.perf_counter()}


def phase_protocols(started: dict) -> dict:
    """Waits for start_protocols' drivers, each of which must exit 0;
    once the paper protocol is done, runs it again in its workdir (every
    battery stage from its cache, with the same values) and then
    protocols.paper_finish (the same LSD medians and CRPS)."""
    try:
        return _protocols_results(**started)
    finally:
        _kill_protocols(started["procs"])  # what a failure left running


def _protocols_results(workdir: str, paper: list, procs: dict,
                       paper_wd: str, t0: float) -> dict:
    limit = PROTOCOL_LIMIT_S - (time.perf_counter() - t0)
    out = _protocols_wait({"paper": procs.pop("paper")}, workdir, limit)
    summary_path = os.path.join(paper_wd, "paper_protocol_summary.json")
    with open(summary_path) as fh:
        first = json.load(fh)
    out.update(_protocols_wait({"paper_rerun": _protocol_proc(
        "paper", paper + ["--reuse-train"], workdir, "paper_rerun")},
        workdir, PROTOCOL_LIMIT_S))
    with open(summary_path) as fh:
        second = json.load(fh)
    cached = {k: second["stages"][k].get("cached") is True
              for k in ("datasets", "eval_phases_1to5", "rainfarm", "crps",
                        "lsd")}
    same = ({k: v for k, v in first["verdict"].items()
             if k != "total_wall_clock_minutes"}
            == {k: v for k, v in second["verdict"].items()
                if k != "total_wall_clock_minutes"})
    print(f"[protocols] paper rerun: stages cached {cached}, the same "
          f"verdict {same}; verdict {json.dumps(first['verdict'])}")
    v = first["verdict"]
    out.update(_protocols_wait({"paper_finish": _protocol_proc(
        "paper_finish", [paper_wd, v["peak_epoch"],
                         str(v["heldout_daily_cycle_corr"]),
                         str(v["ks_frac_distinct_p05"]), "200",
                         "--no-plots"], workdir, "paper_finish")},
        workdir, PROTOCOL_LIMIT_S))
    with open(summary_path) as fh:
        finished = json.load(fh)["verdict"]
    out.update(_protocols_wait(procs, workdir, PROTOCOL_LIMIT_S - (
        time.perf_counter() - t0)))
    procs.clear()
    check(all(cached.values()) and same, "the paper protocol's rerun did "
          "not take every stage from its cache with the same values")
    check(finished["lsd_medians"] == v["lsd_medians"]
          and finished["crps"] == v["crps"],
          f"paper_finish's verdict differs: {finished}")
    with open(os.path.join(workdir, "l1", "l1_rehearsal_summary.json")) as fh:
        l1 = json.load(fh)
    check(l1["ok"] and l1["n_valid_samples"] > 0, l1)
    for name in ("large_domain", "variants"):
        with open(os.path.join(workdir, f"{name}.log")) as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith("[") and not ln.startswith("[resume")]
        print(f"[protocols] {name}: " + " | ".join(lines))
    out["paper_verdict"] = v
    return out


def _shape_rows(rows: list, prefix: str = "", stage: str = "ld_") -> list:
    """The [kernel] lines' rows whose stage starts with `stage` (the 64x64
    stages by default), in brief: the forward's, or with `prefix`
    "backward_" the backward's."""
    keys = ("stage", "dtype", "shape", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share",
            "library_ratio")
    out = []
    for r in rows:
        if not r["stage"].startswith(stage):
            continue
        if not prefix:
            out.append({k: r[k] for k in keys})
        elif f"{prefix}ms" in r:
            out.append({"stage": r["stage"], "dtype": r["dtype"],
                        "shape": r["shape"],
                        **{k: r[f"{prefix}{k}"] for k in keys[3:9]},
                        "bound_share": r[f"{prefix}bound_ms"]
                        / r[f"{prefix}ms"],
                        "library_ratio": r[f"{prefix}ms"]
                        / r[f"{prefix}library_ms"]})
    return out


def _kernel_lines(kc: dict, gc: dict, counts: dict, slice_launches: int,
                  slice_by_variant: dict, eval_counts: dict,
                  rf_counts: dict, dp_counts: dict,
                  data_counts: dict, var_counts: dict, fused_counts: dict,
                  spatial_counts: dict, f32_counts: dict, pn: dict,
                  slice_pn_launches: int) -> list:
    paths = {"eval": eval_counts, "rainfarm": rf_counts, "dp": dp_counts,
             "data": data_counts, "variants": var_counts,
             "fused": fused_counts, "spatial": spatial_counts,
             "f32_train": f32_counts}
    main_rows = [r for r in kc["rows"] if r["stage"] in MAIN_PATH_STAGES
                 and r["dtype"] == "float32"]
    bf16_rows = [r for r in kc["rows"] if r["stage"] in MAIN_PATH_STAGES
                 and r["dtype"] == "bfloat16"]
    step_names = {s[0] for s in TRAIN_STAGES}
    step_rows = [r for r in kc["rows"] if r["stage"] in step_names
                 and r["dtype"] == "bfloat16"]
    dp_rows = [r for r in kc["rows"]
               if r["stage"] in {s[0] for s in DP_STAGES + DP_SCORE_STAGES}]
    bwd_rows = [r for r in kc["rows"] if "backward_ms" in r]
    step_bwd = [r for r in step_rows if "backward_ms" in r]
    # the f32 backward at the generator update's B 32 (what `cli train
    # --f32-parity` runs), and every f32 backward checked
    f32_bwd = [r for r in kc["rows"] if r["stage"] in step_names
               and r["dtype"] == "float32" and "backward_ms" in r]
    f32_rows = [r for r in bwd_rows if r["dtype"] == "float32"]
    bwd_train = counts["upsample2_conv3_backward_kernels"]
    bwd = {p: c["upsample2_conv3_backward_kernels"] for p, c in paths.items()
           if "upsample2_conv3_backward_kernels" in c}
    f32_kernels = ("dx_halo_f32", "dk_halo_f32", "pack_tf32")
    k2 = {r["stage"]: r for r in gc["rows"]}
    pn_16 = [r for r in pn["rows"] if r["stage"].startswith("pn_stage")]
    # every stage's forward is followed by one pixel-norm pass, so a path
    # that ran K1's forward n times launched the pass n times
    pn_by_path = {"slice": slice_pn_launches,
                  "train": counts["pixel_norm_leaky"],
                  **{p: c["pixel_norm_leaky"] for p, c in paths.items()}}
    k1_by_path = {"slice": slice_launches, "train": counts["upsample2_conv3"],
                  **{p: c["upsample2_conv3"] for p, c in paths.items()}}
    check(pn_by_path == k1_by_path, f"pixel-norm launches {pn_by_path} "
          f"against K1 forward launches {k1_by_path}")
    real = k2[f"real_b{N_DISC * TRAIN_BATCH}"]
    cond = k2[f"cond_b{TRAIN_BATCH}"]
    return [{
        "name": "upsample2_conv3",
        "route": "cuda",
        "source": "prdisagg_torch/csrc/upsample_conv.cu",
        "replaces": "prdisagg_tpu/ops/pallas_upsample_conv.py:37",
        # the launches of the serving, training, evaluation, RainFARM,
        # data-parallel and data paths (RainFARM's: the GAN arm of the
        # three-arm protocol; dp's: its workers'; data's: the trained doy
        # generator's scenarios)
        "launches": (slice_launches + counts["upsample2_conv3"]
                     + sum(c["upsample2_conv3"] for c in paths.values())),
        "launches_by_path": {"slice": slice_launches,
                             "train": counts["upsample2_conv3"],
                             **{p: c["upsample2_conv3"]
                                for p, c in paths.items()}},
        "launches_by_variant": {
            v: n + slice_by_variant[v]
            + sum(c["upsample2_conv3_by_variant"][v]
                  for c in paths.values())
            for v, n in counts["upsample2_conv3_by_variant"].items()},
        # one flagship float32 forward's three launches at batch 1000 (every
        # stage and dtype checked is in the [kernel] lines)
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in main_rows) else "bytes",
        # f32: the exact-FMA and the 3xTF32 bounds (bound_ms the smaller)
        "bound_fma_ms": sum(r["bound_fma_ms"] for r in main_rows),
        "bound_tf32x3_ms": sum(r["bound_tf32x3_ms"] for r in main_rows),
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "call_ms": sum(r["call_ms"] for r in main_rows),
        # the same forward in bf16
        "bf16_ms": sum(r["ms"] for r in bf16_rows),
        "bf16_call_ms": sum(r["call_ms"] for r in bf16_rows),
        "bf16_plain_ms": sum(r["plain_ms"] for r in bf16_rows),
        "bf16_bound_ms": sum(r["bound_ms"] for r in bf16_rows),
        "bf16_library_ms": sum(r["library_ms"] for r in bf16_rows),
        # one bf16 train step's six launches
        "train_step_ms": sum(r["ms"] for r in step_rows),
        "train_step_bound_ms": sum(r["bound_ms"] for r in step_rows),
        "train_step_library_ms": sum(r["library_ms"] for r in step_rows),
        # the data-parallel shapes: a rank's shards of the step, f32 and
        # bf16, and its member batch, f32 (each checked in a [kernel] line)
        "dp_shapes_max_abs_err": {
            d: max(r["max_abs_err"] for r in dp_rows if r["dtype"] == d)
            for d in ("float32", "bfloat16")},
        # the 64x64 generator's stages (large_k1_cases)
        "large_domain_shapes": _shape_rows(kc["rows"]),
        # a spatial rank's stage inputs with their halo rows, and the
        # fused steps' (n_disc + 1) B (spatial_k1_cases)
        "spatial_shapes": _shape_rows(kc["rows"], "", "sp"),
        "fused_shapes": _shape_rows(kc["rows"], "", "fused_"),
    }, {
        "name": "upsample2_conv3_backward",
        "route": "cuda",
        "source": "prdisagg_torch/csrc/upsample_conv.cu",
        # K1's custom_vjp backward (XLA's autodiff of the phase form)
        "replaces": "prdisagg_tpu/ops/pallas_upsample_conv.py:99",
        # dx, dk and dk's fold (and an FMA dx's reduce where split) on the
        # training and data-parallel paths (the others run no backward)
        "launches": (sum(bwd_train.values())
                     + sum(sum(b.values()) for b in bwd.values())),
        "launches_by_path": {"train": sum(bwd_train.values()),
                             **{p: sum(b.values()) for p, b in bwd.items()}},
        "launches_by_kernel": {k: n + sum(b.get(k, 0) for b in bwd.values())
                               for k, n in bwd_train.items()},
        # the generator update's three backward passes at B 32, bf16 (every
        # backward checked, B 16 in both dtypes too, is in the [kernel]
        # lines)
        "max_abs_err": max(r["backward_max_abs_err"] for r in bwd_rows),
        "ms": sum(r["backward_ms"] for r in step_bwd),
        "call_ms": sum(r["backward_call_ms"] for r in step_bwd),
        "plain_ms": sum(r["backward_plain_ms"] for r in step_bwd),
        "bound_ms": sum(r["backward_bound_ms"] for r in step_bwd),
        "bound_by": "operations" if all(
            r["backward_bound_by"] == "operations" for r in step_bwd)
        else "bytes",
        "library_ms": sum(r["backward_library_ms"] for r in step_bwd),
        "db_ms": sum(r["backward_db_ms"] for r in step_bwd),
        "node_ms": sum(r["backward_node_ms"] for r in step_bwd),
        "nonkernel_ms": sum(r["backward_nonkernel_ms"] for r in step_bwd),
        "per_stage_ms": [r["backward_ms"] for r in step_bwd],
        "large_domain_shapes": _shape_rows(kc["rows"], "backward_"),
        "spatial_shapes": _shape_rows(kc["rows"], "backward_", "sp"),
        "fused_shapes": _shape_rows(kc["rows"], "backward_", "fused_"),
    }, {
        "name": "upsample2_conv3_backward_f32",
        "route": "cuda",
        "source": "prdisagg_torch/csrc/upsample_conv.cu",
        # the same custom_vjp backward in f32: k1_dx_f32_halo,
        # k1_dk_f32_halo and k1_pack_tf32 (3xTF32 on the tensor cores), with
        # the fold that the bf16 kernels share
        "replaces": "prdisagg_tpu/ops/pallas_upsample_conv.py:99",
        # their launches on the paths that train in f32 (the f32 graphed
        # step, dp's gloo ranks, the 64x64 f32 step, the fused and spatial
        # f32 steps)
        "launches": sum(b.get(k, 0) for b in bwd.values()
                        for k in f32_kernels),
        "launches_by_path": {p: sum(b.get(k, 0) for k in f32_kernels)
                             for p, b in bwd.items()},
        "launches_by_kernel": {k: sum(b.get(k, 0) for b in bwd.values())
                               for k in f32_kernels},
        # the generator update's three backward passes at B 32 in f32 (the
        # kernels' call, pack and fold included; every f32 backward
        # checked is in the [kernel] lines)
        "max_abs_err": max(r["backward_max_abs_err"] for r in f32_rows),
        "max_err_over_max": max(r["backward_max_err_over_max"]
                                for r in f32_rows),
        "ms": sum(r["backward_ms"] for r in f32_bwd),
        "call_ms": sum(r["backward_call_ms"] for r in f32_bwd),
        "plain_ms": sum(r["backward_plain_ms"] for r in f32_bwd),
        "bound_ms": sum(r["backward_bound_ms"] for r in f32_bwd),
        "bound_by": "operations" if all(
            r["backward_bound_by"] == "operations" for r in f32_bwd)
        else "bytes",
        "bound_fma_ms": sum(r["backward_bound_fma_ms"] for r in f32_bwd),
        "bound_tf32x3_ms": sum(r["backward_bound_tf32x3_ms"]
                               for r in f32_bwd),
        "library_ms": sum(r["backward_library_ms"] for r in f32_bwd),
        "per_stage_ms": [r["backward_ms"] for r in f32_bwd],
    }, {
        "name": "gather_patches",
        "route": "cuda",
        "source": "prdisagg_torch/csrc/gather.cu",
        "replaces": "prdisagg_tpu/ops/pallas_gather.py:30",
        # the launches of the training, evaluation, RainFARM, data-parallel
        # and data paths (RainFARM's: calibration's draws and the scored
        # real patches; dp's: each rank's shard of a step's rows; data's:
        # the patch store, one a day with rows)
        "launches": (counts["gather_patches"]
                     + sum(c["gather_patches"] for c in paths.values())),
        "launches_by_path": {"train": counts["gather_patches"],
                             **{p: c["gather_patches"]
                                for p, c in paths.items()}},
        # one train step's two launches: the n_disc*B real patches and the
        # generator update's conditions (every gather checked is in the
        # [kernel] lines)
        "max_abs_err": max(r["max_abs_err"] for r in gc["rows"]),
        "ms": real["ms"] + cond["ms"],
        "plain_ms": real["plain_ms"] + cond["plain_ms"],
        "bound_ms": real["bound_ms"] + cond["bound_ms"],
        "bound_by": "bytes",
        "library_ms": real["library_ms"] + cond["library_ms"],
        "call_ms": real["call_ms"] + cond["call_ms"],
        "host_us": real["host_us"] + cond["host_us"],
    }, {
        "name": "pixel_norm_leaky",
        "route": "cuda",
        "source": "prdisagg_torch/csrc/pixel_norm.cu",
        # no TPU kernel: XLA fused the chain in the JAX package
        "replaces": None,
        # one a stage's forward on every path, with or without a gradient
        # recorded (checked against K1's forward launches above)
        "launches": sum(pn_by_path.values()),
        "launches_by_path": pn_by_path,
        # the three stages of one flagship f32 forward at B 1000 (the 64x64
        # stage 2 at B 512 is in its [kernel] line)
        "max_abs_err": max(r["max_abs_err"] for r in pn_16),
        "ms": sum(r["ms"] for r in pn_16),
        "call_ms": sum(r["call_ms"] for r in pn_16),
        "plain_ms": sum(r["plain_ms"] for r in pn_16),
        "bound_ms": sum(r["bound_ms"] for r in pn_16),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in pn_16),
    }]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # the dp phase's workers: this script, started by itself
    ap.add_argument("--dp-worker", choices=["nccl", "gloo"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    # the spatial phase's workers: this script, started by itself
    ap.add_argument("--spatial-worker", action="store_true",
                    help=argparse.SUPPRESS)
    # only the device, build and K1-backward-split phases
    ap.add_argument("--k1-backward-split", action="store_true")
    # only the device, build, dataset and f32 graphed-step phases
    ap.add_argument("--f32-step", action="store_true")
    # only the device, build and K1 f32 forward phases
    ap.add_argument("--k1-forward", action="store_true")
    # only the device, build and pixel-norm kernel check phases
    ap.add_argument("--pixel-norm", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if args.dp_worker or args.spatial_worker:
        worker = {"nccl": dp_worker_nccl, "gloo": dp_worker_gloo,
                  None: spatial_worker}
        name = ("spatial" if args.spatial_worker else args.dp_worker) + (
            "" if args.dp_worker == "nccl" else os.environ["RANK"])
        res = worker[args.dp_worker](args.seed, args.workdir)
        res["counts"] = dict(res["counts"])
        with open(os.path.join(args.workdir, f"{name}.json"), "w") as fh:
            json.dump(res, fh)
        print(f"[dp-worker] {name}: " + json.dumps(res))
        import torch.distributed as dist

        dist.destroy_process_group()
        return 0
    try:
        card = phase_device()
        phase_build()
    except Exception:  # noqa: BLE001 — nothing can run after this
        traceback.print_exc()
        return 1
    if args.k1_backward_split:
        phase_k1_backward_split(args.seed)
        return 0
    if args.k1_forward:
        phase_k1_forward(args.seed)
        return 0
    if args.pixel_norm:
        phase_pixel_norm_check(args.seed)
        return 0
    if args.f32_step:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
            phase_f32_train(phase_dataset(args.seed), args.seed, tmp)
        return 0

    failed = []
    out: dict = {}
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke-")

    def run(name, fn, needs=(), own_s=None):
        """Runs phase `name`; a phase that ran in a thread (`own_s` holds
        its seconds) is waited for, and its own seconds printed."""
        missing = [n for n in needs if n not in out]
        if missing:
            failed.append(f"{name} (skipped: {', '.join(missing)} failed)")
            return
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 — report, run the other phases
            traceback.print_exc()
            failed.append(name)
        if own_s is None:
            print(f"[time] {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        else:
            print(f"[time] {name}: {own_s[name]:.1f} s (in its thread, "
                  f"beside the other subprocess phases)", flush=True)

    run("kernel_check", lambda: phase_kernel_check(args.seed))
    run("pixel_norm_check", lambda: phase_pixel_norm_check(args.seed))
    run("k1_backward_split",
        lambda: phase_k1_backward_split_proc(args.seed))
    run("dataset", lambda: phase_dataset(args.seed))
    run("gather_check", lambda: phase_gather_check(out["dataset"], args.seed),
        needs=("dataset",))
    run("slice", lambda: phase_slice(args.seed, workdir.name))
    run("serve", lambda: phase_serve(out["slice"]), needs=("slice",))
    run("train", lambda: phase_train(out["dataset"], args.seed,
                                     os.path.join(workdir.name, "train")),
        needs=("dataset",))
    run("f32_train", lambda: phase_f32_train(
        out["dataset"], args.seed, os.path.join(workdir.name, "f32_train")),
        needs=("dataset",))
    run("graph_check", lambda: phase_graph_check(out["dataset"], args.seed),
        needs=("dataset",))
    run("fused", lambda: phase_fused(out["dataset"], args.seed),
        needs=("dataset",))
    run("resume_check", lambda: phase_resume_check(
        out["dataset"], args.seed, os.path.join(workdir.name, "resume")),
        needs=("dataset",))
    run("eval", lambda: phase_eval(out["dataset"], out["slice"], args.seed,
                                   os.path.join(workdir.name, "eval")),
        needs=("dataset", "slice"))
    run("rainfarm", lambda: phase_rainfarm(
        out["dataset"], out["slice"], args.seed,
        os.path.join(workdir.name, "rainfarm")), needs=("dataset", "slice"))
    run("dp", lambda: phase_dp(out["slice"], out["train"], args.seed,
                               os.path.join(workdir.name, "dp"), card),
        needs=("slice", "train"))
    run("spatial", lambda: phase_spatial(
        args.seed, os.path.join(workdir.name, "spatial"), card))
    # the phases that check subprocesses' exit codes and files, not a time,
    # run together, and beside no phase that times the card or the host:
    # the protocol drivers, and the cli, eval CLI and serving CLI phases,
    # each a thread waiting on its subprocesses; each prints its own seconds
    run("protocols_start", lambda: start_protocols(
        os.path.join(workdir.name, "protocols")))
    beside = {"cli": (lambda: phase_cli(
                  args.seed, os.path.join(workdir.name, "cli")), ()),
              "eval_cli": (lambda: _eval_cli(*out["eval"]["cli_args"]),
                           ("eval",)),
              "serve_cli": (lambda: phase_serve_cli(
                  out["slice"], os.path.join(workdir.name, "serve_cli")),
                  ("slice",))}
    own_s = {}

    def own(name, fn):
        def timed():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                own_s[name] = time.perf_counter() - t0
        return timed

    pool = concurrent.futures.ThreadPoolExecutor(len(beside))
    jobs = {name: pool.submit(own(name, fn))
            for name, (fn, needs) in beside.items()
            if all(n in out for n in needs)}
    run("protocols", lambda: phase_protocols(out["protocols_start"]),
        needs=("protocols_start",))
    for name, (_, needs) in beside.items():
        run(name, jobs[name].result if name in jobs else None, needs=needs,
            own_s=own_s)
    pool.shutdown()
    run("data", lambda: phase_data(args.seed,
                                   os.path.join(workdir.name, "data")))
    run("ops", lambda: phase_ops(args.seed, os.path.join(workdir.name, "cli"),
                                 os.path.join(workdir.name, "ops")),
        needs=("cli",))
    run("variants", lambda: phase_variants(
        out["dataset"], args.seed, os.path.join(workdir.name, "variants")),
        needs=("dataset",))
    workdir.cleanup()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    kernels = _kernel_lines(out["kernel_check"], out["gather_check"],
                            out["train"]["counts"], out["slice"]["launches"],
                            out["slice"]["by_variant"], out["eval"]["counts"],
                            out["rainfarm"]["counts"], out["dp"]["counts"],
                            out["data"]["counts"], out["variants"]["counts"],
                            out["fused"]["counts"], out["spatial"]["counts"],
                            out["f32_train"]["counts"],
                            out["pixel_norm_check"],
                            out["slice"]["pixel_norm_launches"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
