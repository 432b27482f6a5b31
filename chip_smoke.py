#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero; no phase is skipped):
  1. device  — needs torch.cuda.is_available(); prints the card's name,
               the device count and nvidia-smi's name and power limit.
  2. build   — builds every kernel from the sources under
               pytorch_ddp_mnist_tpu_torch/csrc/, and the variant builds
               (each design's phase-stamps build), one nvcc per library,
               all started together, and prints what
               `nvcc -Xptxas -v` reported.
  3. kernels — holds each kernel against its plain PyTorch version on the
               card, on the same numpy-seeded inputs, with the stated
               tolerances, and checks that repeat launches are bitwise equal:
               K1 (fused_step) at B = 128/1000/3, each case asserting the
               design `fused_design` picks; K1-split (the split design of
               K1's f32 forms, csrc/fused_split.cu) bitwise the rows design
               (csrc/fused_step.cu) at B = 128/96/8/3 with a mask and with
               the in-kernel Philox draw, a repeat bitwise, within the
               tolerances of the plain version, a misaligned view and a
               CUDA-graph replay bitwise the eager call; K1-bf16 on the rows
               design at the same B (and unequal to K1); K1-rng (in-kernel
               Philox per (seed, batch block)) at B = 128/1000/3 in f32 and
               bf16 (the rows design), its mask
               bitwise the plain stream, two seeds apart, and its mean loss
               over 8 seeds at B = 512 within 5% of K1's over 8 threefry
               masks; K1-mma (the mma design of the bf16 forms, csrc/
               fused_mma.cu, the products on the tensor cores) at B =
               128/96/8/3, mask and Philox, within the JAX bf16 pins of its
               plain version and of the rows design, a repeat bitwise, the
               Philox form bitwise the mask form on rng_mask, an odd-offset
               view and a CUDA-graph replay bitwise, 48 distinct inputs;
               the streaming threefry mask (the mask entry) bitwise the
               plain draw; K1-split's and K1-mma's keyed forms (jax's
               threefry mask drawn in the hidden phase from the key's
               words in device memory) at B = 128/96/3 on 48 distinct
               keys, some with the high bit set, each call bitwise its
               design's mask-input form on the mask entry's mask, within
               the tolerances of the plain version, the keyed mask entry
               and the rows design forced bitwise their mask forms, a
               graph replay bitwise, a misaligned and a null key refused;
               K1-rng's device-seed forms (the seed read from word 0 of a
               key-table row: what a captured pallas_rng step launches) on
               K1-split, K1-mma (B = 128/96/3) and the rows design (B =
               256, f32 and bf16), bitwise the scalar-seed forms on 48
               seeds, some with the high bit set, within the tolerances of
               the plain version, and a graph replayed after the seed word
               changes drawing the new seed's mask;
               K2 (epoch_step) in its four forms (K2a f32 rows + masks, K2b
               uint8 rows + masks, K2c uint8 + in-kernel Philox, K3 uint8 +
               in-kernel threefry; the uint8 forms run K2-ws, the
               weight-stationary design, K2a the rows design, each
               asserted) at B = 128 x 24 steps and B = 8 x 5 steps:
               in-kernel masks bitwise against the plain streams, the
               epoch bitwise against K1 + SGD per step, K2-ws bitwise
               against the rows design on the same inputs, and against its
               plain version (losses per step; params in Frobenius norm);
               K2-ws's normalise table bitwise the plain normalise of
               0..255; K2-mma (the tensor-core design of the bf16 uint8
               forms, csrc/epoch_mma.cu) in K2b, K2c and K3 at B = 128 x
               24, 96 x 6 and 8 x 5: bitwise K1-mma + SGD per step and a
               repeat launch, within the JAX bf16 pins of its plain
               version and of the rows design forced, which stays bitwise
               its own K1-bf16 + SGD; the superstep K = 2/4/8 bitwise
               equal to K = 1 on the full 469-step epoch (K = 8 pads 3
               steps) and on an 11-step epoch, K2-ws's also bitwise the
               rows design; K6 (the DP
               epoch kernel's ring) on n replicas of this card, at
               (all-gather, n = 2, 4) and (reduce-scatter, n = 3, 4), B =
               128 x 24 steps, 96 x 6 and 8 x 5 per replica, uint8 rows,
               masks/threefry/core, on K6-ws (csrc/ring_ws.cu: K2-ws's
               column-owner step, one mini-ring per column owner; the
               design ring_design picks, asserted) and on the rows
               design's ring forced: (a) replicas bitwise in lockstep, (b)
               bitwise K1 per replica + the ring's summation tree + SGD,
               (c) its plain version, (e) a repeat launch bitwise, on each;
               K6-ws bitwise the rows design's ring; (d) a 1-replica ring
               launch of each design bitwise K2; each replica's in-kernel
               masks bitwise; K6 in bf16 on K6-mma (csrc/ring_mma.cu:
               K2-mma's tensor-core step on each replica, one mini-ring per
               gradient-tile owner; asserted) in the same three forms at
               both rings x n = 2, 3, 4, B = 128 x 24, 96 x 6 and 8 x 5:
               (a), (e), bitwise K1-mma per replica + the ring tree + SGD,
               within the JAX bf16 pins of its plain version and of the
               rows design's ring in bf16 forced (itself bitwise its own
               K1-bf16 + tree + SGD at n = 2, 4), a 1-replica launch
               bitwise K2-mma; a stalled ring of each design (K6-ws,
               K6-mma, rows) ends in RingTimeoutError naming hop 0 and the
               design.
  4. main    — the port's main paths through the entry points a user calls,
               at full width (784-128-128-10, batch 128, lr 0.01, synthetic
               MNIST 60k/10k), each with every kernel's launch count set to 0
               just before it and read just after:
               a. `train` streaming, 50 steps, --kernel auto (K1-split's
                  keyed form a step, the mask drawn in it: no mask entry),
                  held against the same run with the autograd step (`--kernel
                  xla`: the mask entry a step) and against the same run on
                  the CPU;
               b. `train` streaming --kernel pallas --dtype bfloat16, 50
                  steps (K1-mma's keyed form per step), and `train
                  --cached --kernel pallas_rng --dtype bfloat16`, one epoch
                  (469 K1-rng-bf16 launches on the mma design), each also
                  with the rows design forced, in turns (mma, rows, rows,
                  mma): losses within BF16_TRAIN_RTOL across designs, the
                  wall time of each; the streaming bf16 trainer at
                  --batch_size 256 (past MMA_MAX_BATCH: the rows design);
               c. `train --cached --kernel pallas_epoch --impl threefry2x32`,
                  one full epoch of 469 steps in ONE K2-ws launch, held
                  against the same run on the CPU (plain versions, same
                  masks);
               d. `train --cached --fused --n_epochs 2`, two K2-ws launches;
               e. `train --cached --kernel pallas_rng`, one epoch: 469 K1-rng
                  launches (split design) and no mask drawn outside the
                  kernel; `train --cached` (--kernel auto: K1 keyed per
                  step, the keys from the epoch's table), one epoch on the
                  split design and one with the rows design forced (the
                  keyed mask entry and the rows design a step), in turns
                  (split, rows, rows, split), bitwise equal losses, the wall
                  time of each;
               f. `train --cached --kernel pallas_epoch --dtype bfloat16`,
                  one epoch in ONE K2-mma launch, held against the CPU run;
                  the same at --batch_size 256, past MMA_MAX_BATCH: one
                  K2-bf16 launch on the rows design;
               g. `bench --epochs 5` (K2-ws), whose JSON line is printed;
               h. `bench --kernel pallas_epoch --dtype bfloat16 --superstep
                  8 --epochs 5` (K2-mma with K = 8), and with K = 4 at
                  --batch_size 256 (the rows design's superstep);
               i. `fit_cached(mesh=data_parallel_mesh([cuda:0] * 4))` (what
                  `--parallel --cached` calls), global batch 512: one
                  118-step epoch through K6-ws all-gather (threefry), one
                  through K6-ws reduce-scatter (core), and the same two in
                  bf16 through K6-mma; 20 steps at 256 rows per replica
                  through the rows design's all-gather and reduce-scatter
                  rings, and 20 bf16 steps through its all-gather (the rows
                  ring's bf16 form); 50 steps of `--kernel pallas` (K1 per
                  replica, split design, and mma in bf16), each held
                  against the same run
                  on a 4-replica CPU mesh (keyed: no mask entry); `train
                  --parallel --cached
                  --kernel pallas_epoch` on the 1-card mesh (K2-ws), bitwise
                  the serial run;
               j. the process-level world (phase_main_world), ranks spawned
                  on cuda:0 over gloo, each a process of its own (this
                  script run with `--world-rank`): 2 and 4 ranks, 50 steps
                  of `--kernel pallas` a rank at 128 rows, f32 (K1-split)
                  and bf16 (K1-mma), bitwise in lockstep and bitwise the
                  single-process n-replica mesh of the card on the world's
                  rows, each step split into compute and exchange; `train
                  --parallel --wireup_method env` through torchrun
                  --standalone --nproc_per_node 4 and 2, one epoch each (118
                  and 235 keyed K1-split launches a rank), one epoch line
                  and a rank-0 checkpoint equal to every rank's params;
                  `--cached --kernel pallas_rng` on 2 ranks in lockstep; an
                  NCCL world of 1 rank bitwise the serial `--parallel` run,
                  and NCCL asked for by 2 ranks on the card exiting by name;
                  every rank on the eager loop, no graph captured;
               k. where a per-step epoch's wall time goes
                  (phase_epoch_walls): one 469-step epoch of the cached
                  `--kernel pallas` path in f32 and bf16 and of the
                  streaming path, each on the keyed step and on the step
                  before the fold (the mask entry + the mask-input form), in
                  turns, host stamps between upload, indices, key table,
                  step loop, loss fetch and eval; the two bitwise equal;
               l. the capture phase (phase_capture): every per-step path
                  on a step captured as a CUDA graph (train/graphs.py) —
                  cached xla, pallas, pallas_rng in f32 and bf16, the
                  4-replica mesh (pallas, f32 and bf16), streaming pallas
                  and xla — 3 epochs captured and eager in turns (captured,
                  eager, eager, captured), losses and params bitwise, one
                  capture a captured run, the eager run's launch counts,
                  the same epochs through fit_cached / fit bitwise, each
                  epoch's wall with host stamps; the stale-input check (a
                  step captured on epoch 0's buffers replayed on epoch 1's
                  new indices or batches and keys, bitwise the eager epoch
                  1 from the same state); after the profiler session each
                  path's epoch wall, step-loop share and card-busy share,
                  captured against eager, the busy shares marked checked
                  where the two forms' device times agree within
                  PLACEMENT_RTOL;
               m. the 10-epoch golden (phase_golden): docs/golden_accuracy.
                  json's config through the captured make_run_fn with
                  kernel xla and pallas, f32, each held to the golden's
                  accuracy and val-loss-ratio bounds against its torch
                  runs, each curve beside the JAX framework curve;
               n. the reference's five configurations (phase_main_reference):
                  a synthetic 60k/10k set converted to .nc by `python -m
                  pytorch_ddp_mnist_tpu_torch convert`, then `python -m
                  pytorch_ddp_mnist_tpu_torch train` at full width, one
                  epoch cut to --limit REF_LIMIT rows: serial (IDX, the
                  synthetic stand-in), serial --netcdf, --parallel under
                  torchrun with 2 ranks on cuda:0, --parallel over 2 ranks
                  of the env wireup (the mpiexec world of mnist_cpu_mp.py;
                  the machine has no mpiexec) and --netcdf --parallel over 2
                  ranks of the mpich wireup on the variables mpiexec sets
                  (the 4 mpich ranks of mnist_pnetcdf_cpu_mp.py); each epoch
                  line held against the same command on the CPU (--kernel
                  pallas: the same step's plain version, the same masks),
                  each --netcdf run bitwise its IDX run (the line's numbers
                  and the rank-0 checkpoint), the native reader core named
                  on the [data] line, every rank's K1-split launches; the
                  `--dropout_rng torch` step captured for 3 steps bitwise
                  the same steps eagerly on the same masks, the third a
                  replay after its mask slot changed, and `train
                  --sampler_rng torch --dropout_rng torch --eval_shuffle`
                  against its CPU run (no hand-written kernel launched);
                  whether this machine's torch CPU randperm and bernoulli_
                  draw the port's copy's streams; the `bench --mode stream`
                  and `bench --mode accuracy` lines;
               o. the serving path (phase_serve), from n's first checkpoint:
                  an InferenceEngine of max_batch 64 in f32 and uint8 rows
                  captures its 7 bucket graphs at construction and none
                  after; its logits within rtol 1e-5 / atol 1e-6 of the CPU
                  engine's and its preds equal on every bucket and a
                  chunked batch; each bucket's staged flush, dispatched
                  under set_sync_debug_mode("error"), bitwise the direct
                  forward; the fast batcher (its dispatches under the same
                  mode) and the legacy one bitwise the direct preds; 2000
                  requests at 4000 rps answered with the direct preds; no
                  hand-written kernel launched; one flush's CUDA-event time
                  at every bucket; `serve --selftest 2000`; one TCP request
                  through `serve --port 0`, drained on SIGTERM; `bench
                  --mode eval`, `bench --mode serve` (500 rps, 1000
                  requests) and one offered rate past saturation, each on
                  a [serve] line;
               p. the input pipeline (phase_pipeline, after the golden):
                  one streaming epoch of `train` at full width with 4
                  decode workers and a slot ring of depth 3, f32 (keyed
                  K1-split) and `--kernel pallas --dtype bfloat16` (keyed
                  K1-mma), each bitwise its unpiped run, 469 launches in
                  each; `--netcdf --num_workers 2` bitwise `--num_workers
                  0`; the stale-input replay on the ring at depth 1, 2, 4;
                  `bench --mode input` at the JAX defaults ([pipeline]
                  lines: batches/s, data-wait shares, device syncs);
               q. the comm strategies (phase_comm): 50 steps of fit_cached
                  per strategy on a 4-replica mesh of the card (pmean,
                  sharded, bf16 nearest and stochastic on keyed K1-split;
                  pmean, int8 with and without error feedback, pmean +
                  overlap on xla), sharded within rtol 1e-6 of pmean, bf16
                  and int8 within JAX's drift bounds, each bitwise the same
                  epoch eager and captured again; 2-rank gloo worlds under
                  torchrun with `--ddp_comm sharded` and `int8`, each rank
                  bitwise the 2-replica mesh on the same rows; `bench
                  --mode ddp --ddp_comm all` at mlp@1 and deep_mlp@8
                  ([comm] lines);
               r. the replica fleet and hot reload (phase_fleet, right after
                  o, on the same checkpoint): a 2-replica fleet of max_batch
                  64 captures 14 graphs at construction and 7 a restart; the
                  survivor's preds bitwise the direct engine's while its
                  sibling rebuilds under load, and its p50 / p99 against an
                  undisturbed fleet in turns; serve_chaos.py's three legs
                  (kill-mid-burst, wedge-then-watchdog, torn-checkpoint-swap)
                  on the card with availability 1.0, preds bitwise direct,
                  no replica dead or off the card, 7 captures an engine
                  built and no other, and the record contract over the
                  trace; `serve --replicas 2 --wedge_timeout_ms 250
                  --retry_budget 2 --reload_dir DIR` over TCP reloading a
                  step committed under DIR; `bench --mode serve --replicas
                  2` and `--replicas 1` in turns; no hand-written kernel
                  launched ([fleet] lines);
               s. the trainer's in-run telemetry (phase_telemetry, after
                  the step checkpoints' phase): a full streaming epoch
                  (K1-split keyed, captured) with `--telemetry --health
                  warn --metrics_port 0 --profile_dispatch 16` bitwise the
                  run without, the synchronising CUDA calls of both under
                  set_sync_debug_mode("warn") differing by the profiler's
                  drains alone; the same at bf16 (K1-mma keyed, 50 steps)
                  and `--cached --kernel pallas_epoch --health warn` (one
                  K2-ws launch); each flagged run's [telemetry] line
                  reads its one capture; the nan round trip (a live
                  /metrics scrape, /healthz 503, the fatal event in epoch
                  1, the pinned rescue at epoch 0's end, step 100) and
                  `--health abort`; a 2-rank gloo
                  world with `--journal` bitwise its unjournaled twin, its
                  journals read by cluster_report; check_telemetry.py over
                  each trace ([telemetry] lines);
               t. the telemetry read side (phase_trace, after the benches,
                  on what phase_telemetry wrote): `trace report` on the
                  profiled streaming epoch (step_compute p50, --overhead
                  coverage >= 0.90, --baseline exit 0 on itself and 3 on a
                  copy with step_compute doubled), `--cluster` on the
                  journaled world (and a copy with a rank's last
                  collective left open: the stuck seq named), `trace
                  export` (collective tracks, cross-rank arrows); `trace
                  cost --form both` at 8 replicas x 16 rows (every program
                  captured bitwise its eager step, peak and capture time
                  measured, K1-split keyed and mask-entry launches counted)
                  with the mlp@1 ddp lines as its artifact; the ledger
                  over this run's own bench, ddp and cost lines (report,
                  gate 0, a halved run gate 3, a future schema refused,
                  one export track a series); the bench lines' registry
                  and ledger stamps ([trace] lines).
  5. timing  — CUDA-event times of each kernel and form and its plain
               version at the main path's shapes, torch.profiler's device
               time of K1 (both designs) and the cached epoch (f32 on K2-ws,
               bf16 on K2-mma), and its
               device-busy share of a `train --cached` epoch's per-step loop
               on each K1 design, beside the bound computed from those
               shapes; K1-split and the rows design in turns at B = 128,
               f32 and rng, per wrapper call and in a CUDA graph, and the
               per-phase split of a K1-split call from its stamps build;
               K1-mma and the rows design in turns at B = 128, bf16 mask and
               rng, the same ways, K1-mma's stamps split, and the bf16
               per-step loops' device-busy share on each design; K2-ws and the rows design in turns in
               K2b, K2c, K3 and f32 K = 8, and the per-phase split of a K2c epoch from K2-ws's stamps
               build; K2-mma and the rows design's bf16 form in turns over
               the 469-step epoch at K = 1 and K = 8, and K2-mma's phase
               split from its stamps build; K6 per (ring, n) over a
               118-step epoch: K6-ws and the rows design's ring in turns,
               K2-ws alone at K6-ws's blocks and hidden units a block, the
               rows-design K2 and a 1-replica rows ring at the rows ring's
               blocks per replica, K6-ws's stamps split a step, the
               profiler's device time of both designs at n = 4 in turns;
               in bf16, K6-mma and the rows ring's bf16 form in turns at n
               = 2 and 4, both rings, K6-mma's stamps split a step, and
               the profiler's device time of both at n = 4 in turns;
               the keyed forms (f32 and bf16) in turns with the mask entry
               + the mask-input form, per wrapper call and in a CUDA graph,
               and their stamps splits keyed and on the mask in turns; the
               device-seed K1-rng forms in turns with the scalar-seed
               forms, per wrapper call and in a graph (the rows design's
               too); the
               `ptxas -v` registers and spills of K1-split, K1-mma, K2-mma
               and K6-mma (printed after the build).
The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances of the JAX package's own kernel pins (tests/test_pallas_step.py)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
# K2's params after a multi-step epoch against its plain version, in relative
# Frobenius norm per array. Per element they cannot be held at the grads
# tolerance: a ReLU input within rounding of 0 takes the other branch in one
# of the two summation orders and moves its unit's weight column by about
# lr * x * dz (seen on an H100: 6.3e-5 after 24 steps at B = 128 in one
# form, with bitwise-equal masks; the losses stayed within LOSS_RTOL). K2
# is held BITWISE against K1 + SGD per step instead, K1 against its plain
# version per step at the grads tolerance.
PARAM_FRO_RTOL = 1e-3
# per-step losses of a run, kernel vs plain version, same masks: the two
# differ only in f32 summation order, compounded over the steps (1.05e-5
# relative over a 469-step epoch, H100 against the CPU)
TRAIN_RTOL = 1e-3
# the bf16-operand forms against step_reference_bf16: the JAX package's
# pins for its bf16 kernels (tests/test_pallas_step.py)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 2e-3, 1e-4
# K2-bf16 against its plain version over an epoch: losses at the JAX pin for
# its bf16 epoch kernel (rtol 1e-3 / atol 1e-4); params in relative Frobenius
# norm 2e-3, twice PARAM_FRO_RTOL: besides the ReLU flips, an operand within
# rounding of a bf16 tie rounds to the other bf16 value in the other
# summation order and moves by 2**-8 of itself (seen on an H100: 1.95e-4
# after 24 steps at B = 128)
BF16_LOSS_ATOL = 1e-4
BF16_PARAM_FRO_RTOL = 2e-3
# a bf16 run's per-step losses against the same run on the CPU (plain
# versions, same masks), for the reason above
BF16_TRAIN_RTOL = 1e-2
# K1-mma's loss and each grad, in relative Frobenius norm, against its plain
# version and the rows design, beside the pins: the grads' elements are
# 2e-3 to 5e-2 in rms at the check inputs, so a fault in part of one tile can
# stay under atol 1e-4 element by element. f32 summation order and the bf16
# ties it flips give up to 2.5e-5 (the plain version in f32 against f64 on
# the CPU at the same inputs); one 16 x 8 tile of gw1 wrong gives ~3.6e-2
BF16_GRAD_FRO_RTOL = 2e-4
# K1-rng's keep distribution: mean loss over 8 seeds within 5% of K1's over
# 8 threefry masks (the JAX package's test_pallas_rng_matches_mask_kernel_
# in_distribution)
RNG_MEAN_RTOL = 0.05

# H100 SXM published peaks (NVIDIA data sheet): f32 on the CUDA cores, bf16
# on the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_STEPS = 50
MAIN_BATCH = 128
EPOCH_STEPS = 469          # 60,000 rows / 128, the last batch wrap-padded
BENCH_EPOCHS = 5
LR = 0.01

# K2's forms: (pixel type, dropout source)
K2_FORMS = {"K2a": ("f32", "masks"), "K2b": ("uint8", "masks"),
            "K2c": ("uint8", "core"), "K3": ("uint8", "threefry")}
K2_CHECKS = ((128, 24), (8, 5))   # (batch, steps) of the kernel checks
K2_BF16_FORMS = ("K2b", "K2c", "K3")   # the uint8 forms
# (batch, steps) of K2-mma's checks: the main path's full and ragged
# batches, and a small one
K2_BF16_CHECKS = ((128, 24), (96, 6), (8, 5))
SUPERSTEPS = (2, 4, 8)
ROWS_BATCH = 256   # a batch past MMA_MAX_BATCH: the rows design's bf16 step
ROWS_STEPS = 10
ROWS_SUPERSTEP = 4   # the bench's K at ROWS_BATCH: K * B <= 1024, the JAX
                     # kernel's stream budget
# (batch, steps) of the rows design's bf16 checks at the main paths' B
ROWS_CHECK = (ROWS_BATCH, 8)
TPU_SRC = "pytorch_ddp_mnist_tpu/ops/pallas_step.py"
# launch_count keys of K2's rows design (csrc/epoch_step.cu epoch_kernel),
# every one at B > 128 on the main paths
ROWS_DESIGN_KEYS = ("epoch_step", "epoch_step_superstep", "epoch_step_bf16",
                    "epoch_step_superstep_bf16")


def expect_launches(got: dict, want: dict, what: str) -> None:
    """Fail unless the launch counts `got` are `want` for the kernels it
    names and 0 for every other one."""
    full = {k: want.get(k, 0) for k in got}
    if got != full or set(want) - set(got):
        fail(f"{what}: launches {got}, expected {full}")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"[device] {card}")
    return name, count, card


def phase_build():
    from pytorch_ddp_mnist_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all(list(_build.SOURCES) + list(_build.VARIANTS))
    print(f"[build] {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, (so, log) in built.items():
        print(f"[build] {name}: {os.path.relpath(so, REPO)}")
        for line in log.splitlines():
            if line.strip():
                print(f"[build]   {line.strip()}")
    return built


PTXAS_LIBS = ("fused_split", "fused_mma", "epoch_mma", "ring_mma")


def _demangle(names: list) -> list:
    """`names` demangled by c++filt where the machine has it."""
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        out = res.stdout.splitlines()
        if res.returncode == 0 and len(out) == len(names):
            return out
    except OSError:
        pass
    return names


def ptxas_counts(built: dict) -> dict:
    """{library: [{"kernel", "registers", "spill_stores", "spill_loads"}]}
    of PTXAS_LIBS' kernels, read from what `nvcc -Xptxas -v` reported at
    their build: registers a thread, bytes of spill stores and loads."""
    out = {}
    for lib in PTXAS_LIBS:
        rows, entry, props = {}, None, None
        for line in built[lib][1].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                rows.setdefault(entry, {})
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                props = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and props in rows:
                rows[props].update(spill_stores=int(m.group(1)),
                                   spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                rows[entry]["registers"] = int(m.group(1))
        names = [re.sub(r"^void |\(anonymous namespace\)::|mlp::", "",
                        name).split("(")[0]
                 for name in _demangle(list(rows))]
        out[lib] = [{"kernel": name, **row}
                    for name, row in zip(names, rows.values())]
        for r in out[lib]:
            print(f"[build] ptxas {lib}: {r['kernel']}: {r.get('registers')} "
                  f"registers, spill stores {r.get('spill_stores')} B, spill "
                  f"loads {r.get('spill_loads')} B")
    return out


def _k1_inputs(batch: int, seed: int, device):
    """Numpy-seeded K1 inputs: normalised synthetic MNIST rows, labels, a
    pre-scaled dropout mask, and torch-Linear-initialised weights."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                         synthetic_mnist)
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    split = synthetic_mnist(batch, seed=seed)
    rng = np.random.default_rng(seed)
    mask = (rng.random((batch, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    model = MLP(torch.Generator().manual_seed(seed)).to(device)
    params = {n: {k: v.detach() for k, v in layer.items()}
              for n, layer in model.params().items()}
    x = torch.from_numpy(normalize_images(split.images)).to(device)
    y = torch.from_numpy(split.labels.astype(np.int32)).to(device)
    return params, x, y, torch.from_numpy(mask).to(device)


def _flat(loss, grads):
    return [("loss", loss)] + [(f"{n}.{k}", g) for n, layer in grads.items()
                               for k, g in layer.items()]


def phase_kernels(device) -> float:
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    worst_abs = 0.0
    for batch in (128, 1000, 3):
        params, x, y, mask = _k1_inputs(batch, seed=batch, device=device)
        got = _flat(*fused_step.fused_loss_and_grads(params, x, y, mask))
        design = _k1_design(x, False)
        again = _flat(*fused_step.fused_loss_and_grads(params, x, y, mask))
        ref = _flat(*fused_step.fused_loss_and_grads_reference(params, x, y,
                                                               mask))
        torch.cuda.synchronize()
        for (name, a), (_, b) in zip(got, again):
            if not torch.equal(a, b):
                fail(f"fused_step B={batch}: {name} differs between two "
                     f"launches on the same inputs")
        b_abs = b_rel = 0.0
        for (name, a), (_, r) in zip(got, ref):
            if a.shape != r.shape or not torch.isfinite(a).all():
                fail(f"fused_step B={batch}: {name} shape {tuple(a.shape)} "
                     f"or non-finite values")
            diff = (a - r).abs()
            rtol, atol = ((LOSS_RTOL, 0.0) if name == "loss"
                          else (GRAD_RTOL, GRAD_ATOL))
            if not bool((diff <= atol + rtol * r.abs()).all()):
                fail(f"fused_step B={batch}: {name} off its plain version "
                     f"by {float(diff.max()):.3e} (rtol {rtol}, atol {atol})")
            b_abs = max(b_abs, float(diff.max()))
            nz = r.abs() > 0
            if bool(nz.any()):
                b_rel = max(b_rel, float((diff[nz] / r.abs()[nz]).max()))
        worst_abs = max(worst_abs, b_abs)
        print(f"[kernels] fused_step B={batch} ({design} design): loss "
              f"{float(got[0][1]):.7f} vs plain {float(ref[0][1]):.7f}; worst "
              f"abs err {b_abs:.3e}, worst rel err {b_rel:.3e}; repeat launch "
              f"bitwise equal")
    return worst_abs


def _k1_design(x, rng: bool) -> str:
    """The design the last K1 launch ran, failing unless it is the one
    fused_design picks for x's form and batch."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    got = fused_step.last_launch["design"]
    want = fused_step.fused_design(x.dtype, rng, x.shape[0])
    if got != want:
        fail(f"a K1 launch of {x.dtype} B={x.shape[0]} rng={rng} ran the "
             f"{got!r} design; fused_design picks {want!r}")
    return got


SPLIT_CHECKS = (128, 96, 8, 3)   # the full and the ragged main-path batches


def phase_kernels_split(device) -> dict:
    """K1-split, the split design of K1's f32 forms, at B = 128, 96, 8, 3,
    with a mask and with the in-kernel Philox draw: its design asserted,
    bitwise the rows design on the same inputs (the loss and all five
    gradients), a repeat launch bitwise, within the grads tolerances of the
    plain version; at B = 128 a view of x at an odd offset and a CUDA-graph
    replay bitwise the eager call. Returns the worst absolute error against
    the plain version per form."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox
    worst = {"fused_split": 0.0, "fused_split_rng": 0.0}
    for batch in SPLIT_CHECKS:
        params, x, y, mask = _k1_inputs(batch, seed=batch + 50, device=device)
        seed = 0x80000000 + 2 * batch
        for rng in (False, True):
            key = "fused_split_rng" if rng else "fused_split"
            tag = f"{key} B={batch}"

            def call(design=None, xin=x):
                if rng:
                    return fused_step.fused_loss_and_grads_rng(
                        params, xin, y, seed, _design=design)
                return fused_step.fused_loss_and_grads(params, xin, y, mask,
                                                       _design=design)
            got = call()
            if _k1_design(x, rng) != "split":
                fail(f"{tag}: did not run the split design")
            again = call()
            rows = call("rows")
            ref = fused_step.fused_loss_and_grads_reference(
                params, x, y, philox.rng_mask(seed, batch, device) if rng
                else mask)
            torch.cuda.synchronize()
            _check_repeat(tag, got, again)
            for (name, a), (_, b) in zip(_flat(*got), _flat(*rows)):
                if not torch.equal(a, b):
                    fail(f"{tag}: {name} differs from the rows design by "
                         f"{float((a - b).abs().max()):.3e} in "
                         f"{int((a != b).sum())} elements (bitwise expected)")
            err = _check_close(tag, got, ref, LOSS_RTOL, GRAD_RTOL, GRAD_ATOL)
            worst[key] = max(worst[key], err)
            extra = ""
            if batch == MAIN_BATCH:
                # a view of x at an odd offset (copied to 16-byte alignment
                # by the wrapper) and a CUDA-graph replay
                flat = torch.empty(x.numel() + 1, device=device)
                view = flat[1:].view_as(x)
                view.copy_(x)
                odd = call(xin=view)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    captured = call()
                graph.replay()
                torch.cuda.synchronize()
                for what, other in (("an odd-offset view", odd),
                                    ("a CUDA-graph replay", captured)):
                    for (name, a), (_, b) in zip(_flat(*got), _flat(*other)):
                        if not torch.equal(a, b):
                            fail(f"{tag}: {name} of {what} differs from the "
                                 f"eager call")
                extra = "; an odd-offset view and a CUDA-graph replay bitwise"
            print(f"[kernels] {tag}: bitwise the rows design (loss and 5 "
                  f"grads); repeat bitwise; worst abs err vs plain "
                  f"{err:.3e}{extra}")
    # more distinct x and scratch addresses than the wrapper's cache of
    # tensor maps has slots
    params, x, y, mask = _k1_inputs(96, seed=9, device=device)
    xs = [x + 0.0 for _ in range(48)]
    for i, xi in enumerate(xs):
        got = fused_step.fused_loss_and_grads(params, xi, y, mask)
        want = fused_step.fused_loss_and_grads(params, xi, y, mask,
                                               _design="rows")
        for (name, a), (_, b) in zip(_flat(*got), _flat(*want)):
            if not torch.equal(a, b):
                fail(f"fused_split on the {i}th of 48 distinct inputs: {name} "
                     f"differs from the rows design")
    torch.cuda.synchronize()
    print("[kernels] fused_split on 48 distinct inputs (more than its cache "
          "of tensor maps holds): every call bitwise the rows design")
    return worst


def _k2_inputs(batch: int, nsteps: int, seed: int, device):
    """Numpy-seeded K2 inputs: synthetic MNIST rows as raw uint8 and
    normalised f32, labels, pre-scaled masks, a threefry key table, a core
    seed, and torch-Linear-initialised weights."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                         synthetic_mnist)
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import threefry
    rows = batch * nsteps
    split = synthetic_mnist(rows, seed=seed)
    rng = np.random.default_rng(seed)
    masks = (rng.random((rows, 128)) < 0.8).astype(np.float32) / np.float32(0.8)
    keys = threefry.to_int32_words(threefry.split(
        threefry.key_data(seed), nsteps))
    model = MLP(torch.Generator().manual_seed(seed)).to(device)
    params = {n: {k: v.detach() for k, v in layer.items()}
              for n, layer in model.params().items()}
    return {
        "params": params,
        "uint8": torch.from_numpy(split.images.reshape(rows, -1)).to(device),
        "f32": torch.from_numpy(normalize_images(split.images)).to(device),
        "y": torch.from_numpy(split.labels.astype(np.int32)).to(device),
        "masks": torch.from_numpy(masks).to(device),
        "threefry": keys.to(device),
        "core": int(rng.integers(0, 2**32)),
        "batch": batch,
    }


def _k2_call(fn, form: str, inp: dict):
    """fn (the wrapper or its plain version) on `inp` in K2 form `form`."""
    pixels, rng = K2_FORMS[form]
    masks = inp["masks"] if rng == "masks" else None
    seed = None if rng == "masks" else inp[rng]
    return fn(inp["params"], inp[pixels], inp["y"], seed, LR, inp["batch"],
              masks=masks, rng_impl="threefry" if rng == "threefry" else "core")


def _k2_flat(params, losses):
    return [("losses", losses)] + [(f"{n}.{k}", t) for n, layer in
                                   params.items() for k, t in layer.items()]


def _k1_loop(inp: dict, form: str):
    """The epoch as K1 + SGD per step, on the masks of the plain stream:
    the row and gradient code of K1 is K2's, so K2 must equal it bitwise."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import device_normalize
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step
    from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
    pixels, rng = K2_FORMS[form]
    batch = inp["batch"]
    params = {n: {k: t.clone() for k, t in layer.items()}
              for n, layer in inp["params"].items()}
    losses = []
    for step in range(inp["y"].shape[0] // batch):
        rows = slice(step * batch, (step + 1) * batch)
        x = inp[pixels][rows]
        x = device_normalize(x) if pixels == "uint8" else x
        mask = epoch_step.step_mask(rng, inp.get(rng), inp["masks"], step,
                                    batch, x.device)
        loss, grads = fused_step.fused_loss_and_grads(params, x,
                                                      inp["y"][rows], mask)
        sgd_step(params, grads, LR)
        losses.append(loss)
    return params, torch.stack(losses)


def _design(form: str, batch: int, bf16: bool = False) -> str:
    """The K2 design the wrapper's rule picks for `form` at `batch`."""
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    pixels = K2_FORMS[form][0]
    return epoch_step.epoch_design(
        torch.uint8 if pixels == "uint8" else torch.float32, bf16, batch)


def phase_kernels_k2(device) -> dict:
    """K2 in every form: its in-kernel masks bitwise against the plain
    streams, a repeat launch bitwise, the epoch bitwise against K1 + SGD
    per step, and the epoch against its plain version (losses at LOSS_RTOL
    / 1e-6; params by PARAM_FRO_RTOL, see there). The uint8 forms run
    K2-ws (asserted), held bitwise against the rows design on the same
    inputs too; K2-ws's normalise table bitwise the plain normalise.
    Returns the worst absolute error against the plain version per form."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import device_normalize
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    table = epoch_step.kernel_pixel_table(device)
    want = device_normalize(torch.arange(256, dtype=torch.uint8,
                                         device=device))
    if not torch.equal(table, want[:, None].expand_as(table)):
        fail(f"K2-ws's normalise table differs from the plain normalise in "
             f"{int((table != want[:, None]).sum())} of {table.numel()} "
             f"entries")
    print(f"[kernels] epoch_ws normalise table: each of its "
          f"{table.shape[1]} copies bitwise the plain normalise of 0..255")
    worst = {form: 0.0 for form in K2_FORMS}
    for batch, nsteps in K2_CHECKS:
        inp = _k2_inputs(batch, nsteps, seed=batch + nsteps, device=device)
        before = {f"{n}.{k}": t.clone() for n, layer in inp["params"].items()
                  for k, t in layer.items()}
        for form, (_, rng) in K2_FORMS.items():
            tag = f"epoch_step {form} B={batch} S={nsteps}"
            if rng != "masks":
                impl = "threefry" if rng == "threefry" else "core"
                for step in range(nsteps):
                    km = epoch_step.kernel_mask_block(inp[rng], step, batch,
                                                      rng_impl=impl,
                                                      device=device)
                    pm = epoch_step.step_mask(rng, inp[rng], None, step,
                                              batch, device)
                    if not torch.equal(km, pm):
                        fail(f"{tag}: in-kernel mask of step {step} differs "
                             f"from the plain {impl} stream in "
                             f"{int((km != pm).sum())} elements")
            got = _k2_flat(*_k2_call(epoch_step.epoch_fused_sgd, form, inp))
            if epoch_step.last_launch["form"] != "/".join(K2_FORMS[form]):
                fail(f"{tag}: launched form {epoch_step.last_launch['form']}")
            design = epoch_step.last_launch["design"]
            if design != _design(form, batch):
                fail(f"{tag}: launched the {design!r} design, the rule says "
                     f"{_design(form, batch)!r}")
            grid = epoch_step.last_launch["blocks"]
            again = _k2_flat(*_k2_call(epoch_step.epoch_fused_sgd, form, inp))
            if design == "ws":
                rows = _k2_flat(*_k2_call(epoch_step._epoch_fused_sgd_rows,
                                          form, inp))
                if epoch_step.last_launch["design"] != "rows":
                    fail(f"{tag}: the rows design did not launch")
                for (name, a), (_, b) in zip(got, rows):
                    if not torch.equal(a, b):
                        fail(f"{tag}: K2-ws's {name} differs from the rows "
                             f"design's by {float((a - b).abs().max()):.3e} "
                             f"(bitwise expected: the same chains)")
            k1 = _k2_flat(*_k1_loop(inp, form))
            ref = _k2_flat(*_k2_call(epoch_step.epoch_fused_sgd_reference,
                                     form, inp))
            torch.cuda.synchronize()
            for (name, a), (_, b), (_, c) in zip(got, again, k1):
                if not torch.equal(a, b):
                    fail(f"{tag}: {name} differs between two launches on the "
                         f"same inputs")
                if not torch.equal(a, c):
                    fail(f"{tag}: {name} differs from K1 + SGD per step by "
                         f"{float((a - c).abs().max()):.3e} (bitwise "
                         f"expected: the same row and gradient code)")
            f_abs, f_fro = 0.0, 0.0
            for (name, a), (_, r) in zip(got, ref):
                if a.shape != r.shape or not torch.isfinite(a).all():
                    fail(f"{tag}: {name} shape {tuple(a.shape)} or "
                         f"non-finite values")
                diff = (a - r).abs()
                if name == "losses":
                    if not bool((diff <= 1e-6 + LOSS_RTOL * r.abs()).all()):
                        fail(f"{tag}: losses off their plain version by "
                             f"{float(diff.max()):.3e} (rtol {LOSS_RTOL}, "
                             f"atol 1e-6)")
                else:
                    fro = float(diff.norm() / r.norm())
                    if fro > PARAM_FRO_RTOL:
                        fail(f"{tag}: {name} off its plain version by "
                             f"{fro:.3e} in relative Frobenius norm (limit "
                             f"{PARAM_FRO_RTOL})")
                    f_fro = max(f_fro, fro)
                f_abs = max(f_abs, float(diff.max()))
            for name, t in before.items():
                n, k = name.split(".")
                if not torch.equal(inp["params"][n][k], t):
                    fail(f"{tag}: the kernel wrote its input {name}")
            worst[form] = max(worst[form], f_abs)
            print(f"[kernels] {tag}: {design} design; final loss "
                  f"{float(got[0][1][-1]):.7f} vs plain "
                  f"{float(ref[0][1][-1]):.7f}; worst abs err {f_abs:.3e}"
                  f", params' worst relative Frobenius err {f_fro:.3e}; "
                  f"bitwise equal to K1 + SGD per step and to a repeat launch"
                  f"{' and to the rows design' if design == 'ws' else ''};"
                  f" inputs unchanged"
                  f"{'' if rng == 'masks' else '; in-kernel masks bitwise'}"
                  f" (grid {grid} blocks)")
    return worst


def _check_close(tag, got, ref, loss_rtol, grad_rtol, grad_atol) -> float:
    """Fail unless (loss, grads) `got` is within the tolerances of `ref`;
    returns the worst absolute error."""
    worst = 0.0
    for (name, a), (_, r) in zip(_flat(*got), _flat(*ref)):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"{tag}: {name} shape {tuple(a.shape)} or non-finite values")
        diff = (a - r).abs()
        rtol, atol = ((loss_rtol, 0.0) if name == "loss"
                      else (grad_rtol, grad_atol))
        if not bool((diff <= atol + rtol * r.abs()).all()):
            fail(f"{tag}: {name} off its plain version by "
                 f"{float(diff.max()):.3e} (rtol {rtol}, atol {atol})")
        worst = max(worst, float(diff.max()))
    return worst


def _check_fro(tag, got, ref, limit) -> tuple:
    """Fail unless every leaf of (loss, grads) `got` is within `limit` of
    `ref` in relative Frobenius norm; returns (the worst, {leaf: rms of
    ref})."""
    worst, rms = 0.0, {}
    for (name, a), (_, r) in zip(_flat(*got), _flat(*ref)):
        fro = float((a - r).norm() / r.norm())
        if not fro <= limit:
            fail(f"{tag}: {name} off by {fro:.3e} in relative Frobenius norm "
                 f"(limit {limit})")
        worst, rms[name] = max(worst, fro), float(r.pow(2).mean().sqrt())
    return worst, rms


def _check_repeat(tag, got, again) -> None:
    for (name, a), (_, b) in zip(_flat(*got), _flat(*again)):
        if not torch.equal(a, b):
            fail(f"{tag}: {name} differs between two launches on the same "
                 f"inputs")


def _check_mma(device) -> dict:
    """K1-mma, the mma design of K1's bf16 forms, at B = 128, 96, 8, 3
    with a mask and with the in-kernel Philox draw: its design asserted,
    against its plain version and against the rows design at the JAX bf16
    pins and in relative Frobenius norm per leaf (BF16_GRAD_FRO_RTOL), a
    repeat launch bitwise, the Philox form bitwise the mask form on
    philox.rng_mask; at B = 128 a view of x at an odd offset and a
    CUDA-graph replay bitwise the eager call; 48 distinct inputs (more than
    the wrapper's cache of tensor maps holds) against the rows design.
    Returns the worst absolute error against the plain version per form."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox
    worst = {"fused_mma": 0.0, "fused_mma_rng": 0.0}
    pins = (BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL)
    for batch in SPLIT_CHECKS:
        params, x, y, mask = _k1_inputs(batch, seed=batch + 60, device=device)
        xb = x.to(torch.bfloat16)
        seed = 0x80000000 + 3 * batch
        pm = philox.rng_mask(seed, batch, device)
        for rng in (False, True):
            key = "fused_mma_rng" if rng else "fused_mma"
            tag = f"{key} B={batch}"

            def call(design=None, xin=xb):
                if rng:
                    return fused_step.fused_loss_and_grads_rng(
                        params, xin, y, seed, _design=design)
                return fused_step.fused_loss_and_grads(params, xin, y, mask,
                                                       _design=design)
            got = call()
            if _k1_design(xb, rng) != "mma" or \
                    fused_step.last_launch["form"] != key:
                fail(f"{tag}: ran {fused_step.last_launch}")
            again = call()
            rows = call("rows")
            ref = fused_step.step_reference_bf16(params, xb, y,
                                                 pm if rng else mask)
            torch.cuda.synchronize()
            _check_repeat(tag, got, again)
            err = _check_close(tag, got, ref, *pins)
            err_rows = _check_close(f"{tag} against the rows design", got,
                                    rows, *pins)
            fro, rms = _check_fro(tag, got, ref, BF16_GRAD_FRO_RTOL)
            fro_rows, _ = _check_fro(f"{tag} against the rows design", got,
                                     rows, BF16_GRAD_FRO_RTOL)
            worst[key] = max(worst[key], err)
            extra = ""
            if rng:
                on_mask = fused_step.fused_loss_and_grads(params, xb, y, pm)
                for (name, a), (_, b) in zip(_flat(*got), _flat(*on_mask)):
                    if not torch.equal(a, b):
                        fail(f"{tag}: {name} differs from the mask form on "
                             f"philox.rng_mask (bitwise expected)")
                extra = "; bitwise the mask form on rng_mask"
            if batch == MAIN_BATCH:
                flat = torch.empty(xb.numel() + 1, dtype=xb.dtype,
                                   device=device)
                view = flat[1:].view_as(xb)
                view.copy_(xb)
                odd = call(xin=view)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    captured = call()
                graph.replay()
                torch.cuda.synchronize()
                for what, other in (("an odd-offset view", odd),
                                    ("a CUDA-graph replay", captured)):
                    for (name, a), (_, b) in zip(_flat(*got), _flat(*other)):
                        if not torch.equal(a, b):
                            fail(f"{tag}: {name} of {what} differs from the "
                                 f"eager call")
                extra += "; an odd-offset view and a CUDA-graph replay bitwise"
            sizes = ", ".join(f"{n} {v:.1e}" for n, v in rms.items()
                              if n != "loss")
            print(f"[kernels] {tag}: worst abs err vs plain {err:.3e}, vs the "
                  f"rows design {err_rows:.3e} (rtol {BF16_LOSS_RTOL} loss, "
                  f"{BF16_GRAD_RTOL} / atol {BF16_GRAD_ATOL} grads; grads' "
                  f"rms {sizes}); "
                  f"worst relative Frobenius vs plain {fro:.3e}, vs the rows "
                  f"design {fro_rows:.3e} (limit {BF16_GRAD_FRO_RTOL}); "
                  f"repeat bitwise{extra}")
    params, x, y, mask = _k1_inputs(96, seed=19, device=device)
    for i in range(48):
        xi = (x + 0.0).to(torch.bfloat16)
        got = fused_step.fused_loss_and_grads(params, xi, y, mask)
        want = fused_step.fused_loss_and_grads(params, xi, y, mask,
                                               _design="rows")
        _check_close(f"fused_mma on the {i}th of 48 distinct inputs", got,
                     want, *pins)
    torch.cuda.synchronize()
    print("[kernels] fused_mma on 48 distinct inputs (more than its cache of "
          "tensor maps holds): every call within the pins of the rows design")
    return worst


def phase_kernels_k1_variants(device) -> dict:
    """K1-bf16 and K1-rng (f32 and bf16) against their plain versions, the
    bf16 forms on the rows design forced (the design of B > 128, and the
    step K2-bf16 computes); K1-mma (the mma design of the bf16 forms) at B
    = 128, 96, 8, 3, mask and Philox, against its plain version and the
    rows design (the JAX bf16 pins), a repeat bitwise, the Philox form
    bitwise the mask form on rng_mask, at B = 128 an odd-offset view and a
    CUDA-graph replay bitwise, 48 distinct inputs; the in-kernel keep
    distribution; the streaming threefry mask. Returns the worst absolute
    error per form."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox, threefry
    worst = {"fused_step_bf16": 0.0, "fused_step_rng": 0.0,
             "threefry_mask": 0.0}
    for batch in (128, 1000, 3):
        params, x, y, mask = _k1_inputs(batch, seed=batch, device=device)
        xb = x.to(torch.bfloat16)
        tag = f"fused_step bf16 (rows design) B={batch}"
        got = fused_step.fused_loss_and_grads(params, xb, y, mask,
                                              _design="rows")
        if fused_step.last_launch["design"] != "rows":
            fail(f"{tag}: ran {fused_step.last_launch}")
        again = fused_step.fused_loss_and_grads(params, xb, y, mask,
                                                _design="rows")
        f32 = fused_step.fused_loss_and_grads(params, x, y, mask)
        ref = fused_step.step_reference_bf16(params, xb, y, mask)
        torch.cuda.synchronize()
        _check_repeat(tag, got, again)
        err = _check_close(tag, got, ref, BF16_LOSS_RTOL, BF16_GRAD_RTOL,
                           BF16_GRAD_ATOL)
        if torch.equal(got[0], f32[0]):
            fail(f"{tag}: the bf16 loss equals the f32 kernel's")
        worst["fused_step_bf16"] = max(worst["fused_step_bf16"], err)
        print(f"[kernels] {tag}: loss {float(got[0]):.7f} vs plain "
              f"{float(ref[0]):.7f} (f32 kernel {float(f32[0]):.7f}); worst "
              f"abs err {err:.3e}; repeat launch bitwise equal")

        seed = 0x80000000 + batch
        km = fused_step.kernel_rng_mask(seed, batch, device)
        pm = philox.rng_mask(seed, batch, device)
        if not torch.equal(km, pm):
            fail(f"fused_step rng B={batch}: in-kernel mask differs from the "
                 f"plain Philox blocks in {int((km != pm).sum())} elements")
        for xin, bf16 in ((x, False), (xb, True)):
            tag = (f"fused_step rng{' bf16 (rows design)' if bf16 else ''} "
                   f"B={batch}")
            design = "rows" if bf16 else None
            got = fused_step.fused_loss_and_grads_rng(params, xin, y, seed,
                                                      _design=design)
            if bf16 and fused_step.last_launch["design"] != "rows":
                fail(f"{tag}: ran {fused_step.last_launch}")
            if not bf16:
                _k1_design(xin, True)
            again = fused_step.fused_loss_and_grads_rng(params, xin, y, seed,
                                                        _design=design)
            other = fused_step.fused_loss_and_grads_rng(params, xin, y,
                                                        seed + 1,
                                                        _design=design)
            ref = (fused_step.step_reference_bf16 if bf16 else
                   fused_step.fused_loss_and_grads_reference)(params, xin, y,
                                                              pm)
            torch.cuda.synchronize()
            _check_repeat(tag, got, again)
            if torch.equal(got[0], other[0]):
                fail(f"{tag}: seeds {seed} and {seed + 1} give one loss")
            tol = ((BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL) if bf16
                   else (LOSS_RTOL, GRAD_RTOL, GRAD_ATOL))
            err = _check_close(tag, got, ref, *tol)
            worst["fused_step_rng"] = max(worst["fused_step_rng"], err)
            print(f"[kernels] {tag}: loss {float(got[0]):.7f} vs plain "
                  f"{float(ref[0]):.7f}; worst abs err {err:.3e}; mask "
                  f"bitwise the Philox (seed, block) stream; repeat bitwise; "
                  f"seed + 1 differs")

    worst.update(_check_mma(device))

    # the in-kernel stream has the mask kernel's keep distribution
    params, x, y, _ = _k1_inputs(512, seed=1, device=device)
    key = threefry.key_data(100)
    mask_losses, rng_losses = [], []
    for i in range(8):
        key, sub = threefry.split(key)
        mask = fused_step.dropout_mask(sub, 512, device)
        mask_losses.append(float(fused_step.fused_loss_and_grads(
            params, x, y, mask)[0]))
        rng_losses.append(float(fused_step.fused_loss_and_grads_rng(
            params, x, y, 200 + i)[0]))
    m, r = np.mean(mask_losses), np.mean(rng_losses)
    if not abs(m - r) / m < RNG_MEAN_RTOL:
        fail(f"fused_step rng: mean loss over 8 seeds {r:.6f} vs the mask "
             f"kernel's {m:.6f} over 8 keys: more than {RNG_MEAN_RTOL:.0%} "
             f"apart")
    print(f"[kernels] fused_step rng B=512: mean loss over 8 seeds {r:.6f} "
          f"vs {m:.6f} over 8 threefry masks ({abs(m - r) / m:.3%} apart, "
          f"limit {RNG_MEAN_RTOL:.0%})")

    for seed in (0, 7, (1 << 31) + 3):
        key = threefry.split(threefry.key_data(seed))[1]
        for batch in (128, 3):
            got = fused_step.dropout_mask(key, batch, device)
            ref = threefry.dropout_mask(key, batch, device)
            if not torch.equal(got, ref):
                fail(f"threefry_mask key of seed {seed} B={batch}: differs "
                     f"from the plain draw in {int((got != ref).sum())} "
                     f"elements")
    print("[kernels] threefry_mask: bitwise the plain draw (3 keys x "
          "B = 128, 3)")
    return worst


KEYED_CHECKS = (128, 96, 3)   # the full and ragged main-path batches, a tiny one
KEYED_KEYS = 48


def _keyed_keys() -> list:
    """KEYED_KEYS distinct threefry keys: a split chain's, and four with
    chosen words, the high bit set in each (their int32 words negative)."""
    from pytorch_ddp_mnist_tpu_torch.ops import threefry
    _, keys = threefry.step_keys(threefry.key_data(5), KEYED_KEYS - 4)
    keys += [(0x80000000, 0), (0xFFFFFFFF, 0xFFFFFFFF), (3, 0x80000001),
             (0xDEADBEEF, 0xCAFEF00D)]
    if len(set(keys)) != KEYED_KEYS:
        fail("the keyed checks' keys are not distinct")
    return keys


def phase_kernels_keyed(device) -> dict:
    """K1-split's and K1-mma's keyed forms (jax's threefry mask drawn in the
    hidden phase, the key's words read from a device table) at B = 128, 96,
    3 on KEYED_KEYS distinct keys, some with the high bit set: each call
    bitwise the same design's mask-input form on the mask entry's mask, its
    design and form asserted; per batch a repeat bitwise, the plain version
    within K1's tolerances (f32) or the JAX bf16 pins (bf16), the keyed
    mask entry bitwise the mask entry and the plain draw, the rows design
    forced (the keyed mask entry, then the rows design) bitwise the rows
    design on the mask; at B = 128 a CUDA-graph replay bitwise the eager
    call; a key row off 8 bytes and a null key refused by name. Returns the
    worst absolute error against the plain version per form."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
    keys = _keyed_keys()
    table = threefry.to_int32_words(keys).to(device)
    high = int((table < 0).any(dim=1).sum())
    worst = {"fused_split_keyed": 0.0, "fused_mma_keyed": 0.0}
    for batch in KEYED_CHECKS:
        params, x, y, _ = _k1_inputs(batch, seed=batch + 70, device=device)
        for bf16 in (False, True):
            xin = x.to(torch.bfloat16) if bf16 else x
            design = "mma" if bf16 else "split"
            form = f"fused_{design}_keyed"
            tag = f"{form} B={batch}"
            for i, key in enumerate(keys):
                mask = fused_step.dropout_mask(key, batch, device)
                got = fused_step.fused_loss_and_grads_keyed(params, xin, y,
                                                            table[i])
                if (fused_step.last_launch["design"],
                        fused_step.last_launch["form"]) != (design, form):
                    fail(f"{tag}: ran {fused_step.last_launch}")
                want = fused_step.fused_loss_and_grads(params, xin, y, mask)
                _check_bitwise(f"{tag}, key {i}", _flat(*got), _flat(*want),
                               "the mask-input form on the mask entry's mask")
                if i:
                    continue
                again = fused_step.fused_loss_and_grads_keyed(params, xin, y,
                                                              table[i])
                plain = threefry.dropout_mask(key, batch, device)
                keyed_mask = fused_step.keyed_dropout_mask(table[i], batch,
                                                           device)
                if not (torch.equal(keyed_mask, mask)
                        and torch.equal(mask, plain)):
                    fail(f"{tag}: the keyed mask entry, the mask entry and "
                         f"the plain draw disagree")
                ref = (fused_step.step_reference_bf16 if bf16 else
                       fused_step.fused_loss_and_grads_reference)(
                           params, xin, y, plain)
                rows = fused_step.fused_loss_and_grads_keyed(
                    params, xin, y, table[i], _design="rows")
                if fused_step.last_launch["design"] != "rows":
                    fail(f"{tag}, rows design forced: ran "
                         f"{fused_step.last_launch}")
                rows_want = fused_step.fused_loss_and_grads(
                    params, xin, y, mask, _design="rows")
                torch.cuda.synchronize()
                _check_repeat(tag, got, again)
                _check_bitwise(f"{tag}, rows design forced", _flat(*rows),
                               _flat(*rows_want),
                               "the rows design on the mask entry's mask")
                tol = ((BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL)
                       if bf16 else (LOSS_RTOL, GRAD_RTOL, GRAD_ATOL))
                err = _check_close(tag, got, ref, *tol)
                worst[form] = max(worst[form], err)
                extra = ""
                if batch == MAIN_BATCH:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        captured = fused_step.fused_loss_and_grads_keyed(
                            params, xin, y, table[i])
                    graph.replay()
                    torch.cuda.synchronize()
                    _check_bitwise(f"{tag}, a CUDA-graph replay",
                                   _flat(*captured), _flat(*got),
                                   "the eager call")
                    extra = "; a CUDA-graph replay bitwise"
                print(f"[kernels] {tag}: worst abs err vs plain {err:.3e}; "
                      f"repeat bitwise; the keyed mask entry bitwise the mask "
                      f"entry and the plain draw; the rows design forced "
                      f"bitwise the rows design on the mask{extra}")
            torch.cuda.synchronize()
            print(f"[kernels] {tag}: {KEYED_KEYS} distinct keys ({high} with "
                  f"a high bit set), each call bitwise the {design} design's "
                  f"mask-input form on the mask entry's mask")
    # refusals, by name: a key row off 8 bytes in the wrapper, a null key
    # in the kernel's entry
    params, x, y, _ = _k1_inputs(8, seed=3, device=device)
    odd = torch.zeros(5, dtype=torch.int32, device=device)[1:3]
    try:
        fused_step.fused_loss_and_grads_keyed(params, x, y, odd)
        fail("a key row off 8 bytes was not refused")
    except ValueError as e:
        if "8 bytes" not in str(e):
            fail(f"a key row off 8 bytes: refused as {e}")
    for design, xin in (("split", x), ("mma", x.to(torch.bfloat16))):
        lib = fused_step._staged_lib(design)
        p = xin.data_ptr()
        err = getattr(lib, f"pdmt_{design}_step")(
            p, y.data_ptr(), 2, None, None, 0, 1, *([p] * 12), None, 8,
            1.0 / 8, fused_step._stream(device))
        if err == 0:
            fail(f"pdmt_{design}_step took a null key")
    print("[kernels] keyed forms: a key row off 8 bytes refused by the "
          "wrapper, a null key by both kernels' entries")
    return worst


def _k1_loop_bf16(inp: dict, form: str, design: str):
    """The epoch as K1-bf16 on `design` + SGD per step, on the plain
    stream's masks: 'mma' (K1-mma, the step K2-mma computes) or 'rows'
    (the step csrc/epoch_step.cu computes)."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import device_normalize
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step
    from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
    pixels, rng = K2_FORMS[form]
    batch = inp["batch"]
    params = {n: {k: t.clone() for k, t in layer.items()}
              for n, layer in inp["params"].items()}
    losses = []
    for step in range(inp["y"].shape[0] // batch):
        rows = slice(step * batch, (step + 1) * batch)
        x = inp[pixels][rows]
        x = (device_normalize(x) if pixels == "uint8" else x).to(
            torch.bfloat16)
        mask = epoch_step.step_mask(rng, inp.get(rng), inp["masks"], step,
                                    batch, x.device)
        loss, grads = fused_step.fused_loss_and_grads(
            params, x, inp["y"][rows], mask, _design=design)
        if fused_step.last_launch["design"] != design:
            fail(f"K1-bf16 ran {fused_step.last_launch}, not the {design} "
                 f"design")
        sgd_step(params, grads, LR)
        losses.append(loss)
    return params, torch.stack(losses)


def _check_bf16_epoch(tag, got, ref) -> tuple:
    """Fail unless the epoch `got` is within the JAX bf16 epoch pins of
    `ref` (losses BF16_LOSS_RTOL / BF16_LOSS_ATOL, params
    BF16_PARAM_FRO_RTOL in relative Frobenius norm); returns the worst
    absolute error and the worst relative Frobenius error."""
    f_abs = f_fro = 0.0
    for (name, a), (_, r) in zip(got, ref):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"{tag}: {name} shape or non-finite values")
        diff = (a - r).abs()
        if name == "losses":
            if not bool((diff <= BF16_LOSS_ATOL
                         + BF16_LOSS_RTOL * r.abs()).all()):
                fail(f"{tag}: losses off by {float(diff.max()):.3e} (rtol "
                     f"{BF16_LOSS_RTOL}, atol {BF16_LOSS_ATOL})")
        else:
            fro = float(diff.norm() / r.norm())
            if fro > BF16_PARAM_FRO_RTOL:
                fail(f"{tag}: {name} off by {fro:.3e} in relative Frobenius "
                     f"norm (limit {BF16_PARAM_FRO_RTOL})")
            f_fro = max(f_fro, fro)
        f_abs = max(f_abs, float(diff.max()))
    return f_abs, f_fro


def _check_bitwise(tag, got, want, what) -> None:
    for (name, a), (_, b) in zip(got, want):
        if not torch.equal(a, b):
            fail(f"{tag}: {name} differs from {what} by "
                 f"{float((a - b).abs().max()):.3e} (bitwise expected)")


def phase_kernels_k2_bf16(device) -> dict:
    """K2's bf16 forms (uint8 rows) at K2_BF16_CHECKS: K2-mma (asserted by
    the rule) bitwise K1-mma + SGD per step and a repeat launch, within the
    JAX bf16 epoch pins of its plain version and of the rows design forced;
    the rows design bitwise its own K1-bf16 + SGD per step. Then at
    ROWS_CHECK, where the rule picks the rows design: bitwise its K1-bf16 +
    SGD, its staged superstep bitwise K = 1, both within the pins of the
    plain version. Returns the worst absolute error against the plain
    version of K2-mma ('mma'), the rows design's K = 1 ('rows') and its
    superstep at ROWS_CHECK ('rows_superstep')."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    rows_kernel = partial(epoch_step._epoch_fused_sgd_rows, compute_bf16=True)
    plain = partial(epoch_step.epoch_fused_sgd_reference, compute_bf16=True)
    worst = {"mma": 0.0, "rows": 0.0}
    for batch, nsteps in K2_BF16_CHECKS:
        inp = _k2_inputs(batch, nsteps, seed=batch + nsteps + 1, device=device)
        for form in K2_BF16_FORMS:
            tag = f"epoch_step bf16 {form} B={batch} S={nsteps}"
            got = _k2_flat(*_k2_call(kernel, form, inp))
            ll = dict(epoch_step.last_launch)
            if not (ll["bf16"] and ll["form"] == "/".join(K2_FORMS[form])
                    and ll["design"] == "mma" == _design(form, batch, True)):
                fail(f"{tag}: launched {ll}, not K2-mma")
            again = _k2_flat(*_k2_call(kernel, form, inp))
            k1 = _k2_flat(*_k1_loop_bf16(inp, form, "mma"))
            rows = _k2_flat(*_k2_call(rows_kernel, form, inp))
            if epoch_step.last_launch["design"] != "rows":
                fail(f"{tag}: the rows design did not launch")
            k1_rows = _k2_flat(*_k1_loop_bf16(inp, form, "rows"))
            ref = _k2_flat(*_k2_call(plain, form, inp))
            torch.cuda.synchronize()
            _check_bitwise(tag, got, again, "a repeat launch")
            _check_bitwise(tag, got, k1, "K1-mma + SGD per step")
            _check_bitwise(f"{tag} (rows design)", rows, k1_rows,
                           "the rows design's K1-bf16 + SGD per step")
            err, fro = _check_bf16_epoch(f"{tag} against the plain version",
                                         got, ref)
            err_rows, fro_rows = _check_bf16_epoch(
                f"{tag} against the rows design", got, rows)
            r_err, r_fro = _check_bf16_epoch(
                f"{tag} (rows design) against the plain version", rows, ref)
            worst["mma"] = max(worst["mma"], err)
            worst["rows"] = max(worst["rows"], r_err)
            print(f"[kernels] {tag}: K2-mma ({ll['blocks']} blocks) final "
                  f"loss {float(got[0][1][-1]):.7f} vs plain "
                  f"{float(ref[0][1][-1]):.7f}, rows design "
                  f"{float(rows[0][1][-1]):.7f}; worst abs err vs plain "
                  f"{err:.3e}, vs the rows design {err_rows:.3e}; params' "
                  f"worst relative Frobenius err vs plain {fro:.3e}, vs the "
                  f"rows design {fro_rows:.3e} (limit {BF16_PARAM_FRO_RTOL}); "
                  f"bitwise K1-mma + SGD per step and a repeat launch; the "
                  f"rows design bitwise its K1-bf16 + SGD, vs plain "
                  f"{r_err:.3e} / {r_fro:.3e}")

    # past MMA_MAX_BATCH the rule keeps the rows design: its K2-bf16 and its
    # staged superstep at the main paths' B (the cached trainer's K = 1, the
    # bench's K = ROWS_SUPERSTEP)
    batch, nsteps = ROWS_CHECK
    inp = _k2_inputs(batch, nsteps, seed=batch + nsteps + 1, device=device)
    worst["rows_superstep"] = 0.0
    for form in K2_BF16_FORMS:
        tag = f"epoch_step bf16 {form} B={batch} S={nsteps}"
        got = _k2_flat(*_k2_call(kernel, form, inp))
        ll = dict(epoch_step.last_launch)
        if ll["design"] != "rows" or _design(form, batch, True) != "rows":
            fail(f"{tag}: launched {ll}, not the rows design")
        ss = _k2_flat(*_k2_call(partial(kernel, steps_per_iter=ROWS_SUPERSTEP),
                                form, inp))
        ll = dict(epoch_step.last_launch)
        if not (ll["design"] == "rows" and ll["staged"]
                and ll["steps_per_iter"] == ROWS_SUPERSTEP):
            fail(f"{tag} K = {ROWS_SUPERSTEP}: launched {ll}, not the rows "
                 f"design's staged superstep")
        k1_rows = _k2_flat(*_k1_loop_bf16(inp, form, "rows"))
        ref = _k2_flat(*_k2_call(plain, form, inp))
        torch.cuda.synchronize()
        _check_bitwise(tag, got, k1_rows,
                       "the rows design's K1-bf16 + SGD per step")
        _check_bitwise(f"{tag} K = {ROWS_SUPERSTEP}", ss, got, "its K = 1")
        err, fro = _check_bf16_epoch(f"{tag} against the plain version", got,
                                     ref)
        s_err, _ = _check_bf16_epoch(
            f"{tag} K = {ROWS_SUPERSTEP} against the plain version", ss, ref)
        worst["rows"] = max(worst["rows"], err)
        worst["rows_superstep"] = max(worst["rows_superstep"], s_err)
        print(f"[kernels] {tag}: the rows design ({ll['blocks']} blocks) "
              f"bitwise its K1-bf16 + SGD per step; K = {ROWS_SUPERSTEP} "
              f"(staged uint8 rows) bitwise K = 1; worst abs err vs plain "
              f"{err:.3e} (K = {ROWS_SUPERSTEP}: {s_err:.3e}), params' worst "
              f"relative Frobenius err {fro:.3e} (limit "
              f"{BF16_PARAM_FRO_RTOL})")
    return worst


def phase_superstep(device) -> None:
    """K = 2, 4, 8 bitwise equal to K = 1: the full 469-step epoch of the
    bench's form (uint8 rows, in-kernel Philox; K = 8 pads 3 steps) in f32
    and bf16, and an 11-step epoch in the threefry and f32-rows forms. The
    design of each launch is asserted, and whether it staged its rows;
    K2-ws's K = 1 (the f32 uint8 cases) is also held bitwise against the
    rows design. The uint8 bf16 cases also run the rows design forced, whose
    superstep stages its uint8 rows (the bench's path at B > 128)."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    cases = [(MAIN_BATCH, EPOCH_STEPS, "K2c"), (64, 11, "K3"), (64, 11, "K2a")]
    for batch, nsteps, form in cases:
        inp = _k2_inputs(batch, nsteps, seed=nsteps, device=device)
        runs = [(False, None), (True, None)]
        if _design(form, batch, True) == "mma":
            runs.append((True, "rows"))
        for bf16, forced in runs:
            fn = partial(epoch_step.epoch_fused_sgd, compute_bf16=bf16,
                         _design=forced)
            base = _k2_flat(*_k2_call(fn, form, inp))
            design = forced or _design(form, batch, bf16)
            if forced is None and design != (
                    "rows" if form == "K2a" else "mma" if bf16 else "ws"):
                fail(f"superstep {form} bf16={bf16}: the rule picks the "
                     f"{design!r} design")
            if design == "ws":
                rows = _k2_flat(*_k2_call(partial(
                    epoch_step._epoch_fused_sgd_rows, compute_bf16=bf16),
                    form, inp))
                for (name, a), (_, b) in zip(base, rows):
                    if not torch.equal(a, b):
                        fail(f"epoch_step {form} B={batch} S={nsteps}: "
                             f"K2-ws's {name} differs from the rows "
                             f"design's by {float((a - b).abs().max()):.3e}")
            staged = design == "rows" and form != "K2a"
            for k in SUPERSTEPS:
                got = _k2_flat(*_k2_call(partial(fn, steps_per_iter=k), form,
                                         inp))
                ll = epoch_step.last_launch
                if (ll["steps_per_iter"], ll["bf16"], ll["design"],
                        ll["staged"]) != (k, bf16, design, staged):
                    fail(f"superstep K={k}: launched {ll}, expected the "
                         f"{design!r} design, staged rows {staged}")
                for (name, a), (_, b) in zip(got, base):
                    if not torch.equal(a, b):
                        fail(f"epoch_step {form}{' bf16' if bf16 else ''} "
                             f"B={batch} S={nsteps} K={k} ({design} design): "
                             f"{name} differs from K = 1 by "
                             f"{float((a - b).abs().max()):.3e} (bitwise "
                             f"expected)")
            torch.cuda.synchronize()
            print(f"[kernels] epoch_step superstep {form}"
                  f"{' bf16' if bf16 else ''} B={batch} S={nsteps}: {design} "
                  f"design{' (forced)' if forced else ''}; K = "
                  f"{', '.join(map(str, SUPERSTEPS))} bitwise "
                  f"equal to K = 1 (padded to {-(-nsteps // 8) * 8} steps at "
                  f"K = 8; staged rows: {staged})"
                  f"{'; K = 1 bitwise the rows design' if design == 'ws' else ''}")


def _reset_counts():
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step
    for counts in (fused_step.launch_count, epoch_step.launch_count):
        for k in counts:
            counts[k] = 0


def _counts() -> dict:
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step
    return {**fused_step.launch_count, **epoch_step.launch_count}


def _run_trainer(cli_train, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, history = cli_train.train(argv)
    torch.cuda.synchronize()
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[main]   {line}")
    return state, history, out


def phase_main_streaming(tmp: str) -> dict:
    """Path a: `train` streaming (--kernel auto: the keyed K1-split step),
    and the same run with `--kernel xla` (the mask entry and the autograd
    step) and on the CPU. Returns the launches of the two card paths."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = os.path.join(tmp, "model.pt")
    argv = ["--device", "0", "--n_epochs", "1",
            "--limit", str(MAIN_STEPS * MAIN_BATCH),
            "--batch_size", str(MAIN_BATCH), "--lr", "0.01",
            "--kernel", "auto", "--seed", "0",
            "--path", os.path.join(tmp, "no_mnist_here"), "--checkpoint", ckpt]
    _reset_counts()
    t0 = time.perf_counter()
    state, history, out = _run_trainer(cli_train, argv)
    wall = time.perf_counter() - t0
    launches = _counts()

    if not re.search(r"^Epoch=0, train_loss=[-0-9.e]+, val_loss=[-0-9.e]+  "
                     r"\[mean_train=", out, re.M):
        fail("the trainer printed no reference epoch line")
    losses = history[0]
    if losses.shape != (MAIN_STEPS,) or not np.isfinite(losses).all():
        fail(f"per-step losses: shape {losses.shape}, finite "
             f"{bool(np.isfinite(losses).all())}")
    if not losses[-10:].mean() < losses[:10].mean():
        fail(f"losses are not falling: first 10 mean {losses[:10].mean()}, "
             f"last 10 mean {losses[-10:].mean()}")
    expect_launches(launches, {"fused_split_keyed": MAIN_STEPS},
                    f"{MAIN_STEPS} streaming steps (one keyed K1 launch on the "
                    f"split design per step, the mask drawn in it: no "
                    f"threefry_mask launch)")
    saved = load_checkpoint(ckpt)
    for name, layer in state.model.params().items():
        for k, p in layer.items():
            if not torch.equal(saved[name][k], p.detach().cpu()):
                fail(f"checkpoint {name}.{k} does not load back bitwise")
    print(f"[main] {MAIN_STEPS} steps in {wall:.2f}s (wall, data "
          f"generation and eval included); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; K1 launches by design: split (keyed) "
          f"{launches['fused_split_keyed']}, rows {launches['fused_step']}; "
          f"checkpoint loads back bitwise")

    # the same run with the plain autograd step: same seeds, so same
    # weights, batches and dropout masks
    # (`--kernel xla` draws its masks with the mask entry: autograd needs
    # the tensor)
    plain_argv = list(argv)
    plain_argv[plain_argv.index("auto")] = "xla"
    plain_argv[-1] = ""
    _reset_counts()
    _, plain_history, _ = _run_trainer(cli_train, plain_argv)
    xla = _counts()
    expect_launches(xla, {"threefry_mask": MAIN_STEPS},
                    f"{MAIN_STEPS} streaming steps of --kernel xla (the mask "
                    f"entry a step, no fused kernel)")
    rel = np.abs(losses - plain_history[0]) / np.abs(plain_history[0])
    if not (rel <= TRAIN_RTOL).all():
        fail(f"per-step losses off the autograd run by up to {rel.max():.3e} "
             f"(rtol {TRAIN_RTOL})")
    print(f"[main] per-step losses vs the autograd step: worst rel diff "
          f"{rel.max():.3e} (rtol {TRAIN_RTOL})")

    # the same run on the CPU, where the step and the mask draw are their
    # plain versions: the same threefry masks, so only the f32 summation
    # order differs
    cpu_argv = list(plain_argv)
    cpu_argv[1] = "cpu"
    cpu_argv[cpu_argv.index("xla")] = "pallas"
    _reset_counts()
    _, cpu_history, _ = _run_trainer(cli_train, cpu_argv)
    expect_launches(_counts(), {}, "the streaming run on the CPU")
    rel = np.abs(losses - cpu_history[0]) / np.abs(cpu_history[0])
    if not (rel <= TRAIN_RTOL).all():
        fail(f"streaming per-step losses off the same run on the CPU by up "
             f"to {rel.max():.3e} (rtol {TRAIN_RTOL})")
    print(f"[main] per-step losses vs the same run on the CPU (plain "
          f"versions, the same threefry masks): worst rel diff "
          f"{rel.max():.3e} (rtol {TRAIN_RTOL})")
    return {"train": launches, "train --kernel xla": xla}


def _check_bf16_run(out, history, steps: int, what: str) -> None:
    if "dtype=bfloat16" not in out or not re.search(r"^Epoch=0, ", out, re.M):
        fail(f"{what}: no bf16 banner or epoch line")
    losses = history[0]
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        fail(f"{what}: losses shape {losses.shape}, finite "
             f"{bool(np.isfinite(losses).all())}")
    if not losses[-steps // 5:].mean() < losses[:steps // 5].mean():
        fail(f"{what}: losses are not falling")


def phase_main_bf16_k1(tmp: str) -> tuple:
    """Paths b and e': `train --kernel pallas --dtype bfloat16` (streaming,
    50 steps: K1-bf16 keyed per step, the mask drawn in it; with the rows
    design forced the keyed mask entry and the rows design) and `train --cached
    --kernel pallas_rng --dtype bfloat16` (one 469-step epoch: K1-rng-bf16
    per step, no mask drawn outside the kernel), each on the mma design
    and with the rows design forced, in turns (mma, rows, rows, mma):
    launches by design, the two designs' per-step losses within
    BF16_TRAIN_RTOL of each other (the tensor cores sum in another order),
    repeat runs on one design bitwise equal, each run's wall time; then the
    streaming trainer at --batch_size 256, past MMA_MAX_BATCH, whose K1
    launches the rule sends to the rows design. Returns ({path: launches of
    its first run on the design the rule picks}, {path: {design: [wall s
    of each run]}})."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    streaming = ["--device", "0", "--n_epochs", "1",
                 "--limit", str(MAIN_STEPS * MAIN_BATCH),
                 "--batch_size", str(MAIN_BATCH), "--lr", str(LR),
                 "--kernel", "pallas", "--dtype", "bfloat16", "--seed", "0",
                 "--path", os.path.join(tmp, "no_mnist_here"),
                 "--checkpoint", ""]
    cached = _cached_argv(tmp, "--kernel", "pallas_rng", "--dtype",
                          "bfloat16", "--n_epochs", "1", "--checkpoint", "")
    cases = {"train --kernel pallas --dtype bfloat16":
             (streaming, MAIN_STEPS, "fused_mma_keyed", "fused_step_bf16",
              {"threefry_mask": MAIN_STEPS}),
             "train --cached --kernel pallas_rng --dtype bfloat16":
             (cached, EPOCH_STEPS, "fused_mma_rng_dev",
              "fused_step_rng_dev_bf16", {})}
    launches, walls = {}, {}
    for path, (argv, steps, mma_key, rows_key, rows_other) in cases.items():
        walls[path] = {"mma": [], "rows": []}
        runs = {}
        for design in ("mma", "rows", "rows", "mma"):
            _reset_counts()
            with (_k1_rows_design() if design == "rows"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                _, history, out = _run_trainer(cli_train, argv)
                walls[path][design].append(time.perf_counter() - t0)
            what = f"{path}, {design} design"
            _check_bf16_run(out, history, steps, what)
            expect_launches(_counts(), {mma_key: steps} if design == "mma"
                            else {rows_key: steps, **rows_other}, what)
            if design in runs:
                if not np.array_equal(runs[design], history[0]):
                    fail(f"{what}: two runs give different losses")
            else:
                runs[design] = history[0]
                if design == "mma":
                    launches[path] = _counts()
        rel = np.abs(runs["mma"] - runs["rows"]) / np.abs(runs["rows"])
        if not (rel <= BF16_TRAIN_RTOL).all():
            fail(f"{path}: the mma design's per-step losses off the rows "
                 f"design's by up to {rel.max():.3e} (rtol {BF16_TRAIN_RTOL})")
        w = walls[path]
        print(f"[main] {path}: {steps} steps; loss {runs['mma'][0]:.4f} -> "
              f"{runs['mma'][-1]:.4f}; wall s mma "
              f"{', '.join(f'{v:.3f}' for v in w['mma'])}, rows "
              f"{', '.join(f'{v:.3f}' for v in w['rows'])} (turns mma, rows, "
              f"rows, mma; data and eval included); per-step losses of the "
              f"two designs within {rel.max():.3e} (rtol {BF16_TRAIN_RTOL}); "
              f"launches {launches[path]}")

    path = f"train --kernel pallas --dtype bfloat16 --batch_size {ROWS_BATCH}"
    argv = list(streaming)
    argv[argv.index("--limit") + 1] = str(ROWS_STEPS * ROWS_BATCH)
    argv[argv.index("--batch_size") + 1] = str(ROWS_BATCH)
    _reset_counts()
    _, history, out = _run_trainer(cli_train, argv)
    _check_bf16_run(out, history, ROWS_STEPS, path)
    launches[path] = _counts()
    expect_launches(launches[path], {"fused_step_bf16": ROWS_STEPS,
                                     "threefry_mask": ROWS_STEPS}, path)
    print(f"[main] {path}: {ROWS_STEPS} steps on the rows design; loss "
          f"{history[0][0]:.4f} -> {history[0][-1]:.4f}; launches "
          f"{ {k: v for k, v in launches[path].items() if v} }")
    return launches, walls


def _cached_argv(tmp: str, *extra) -> list:
    return ["--device", "0", "--cached", "--batch_size", str(MAIN_BATCH),
            "--lr", str(LR), "--seed", "0",
            "--path", os.path.join(tmp, "no_mnist_here"), *extra]


def _check_epoch_lines(out: str, history, epochs: int, what: str) -> None:
    for e in range(epochs):
        if not re.search(rf"^Epoch={e}, train_loss=[-0-9.e]+, "
                         rf"val_loss=[-0-9.e]+  \[mean_train=", out, re.M):
            fail(f"{what}: no reference epoch line for epoch {e}")
    if len(history) != epochs:
        fail(f"{what}: {len(history)} epochs of losses, expected {epochs}")
    for losses in history:
        if losses.shape != (EPOCH_STEPS,) or not np.isfinite(losses).all():
            fail(f"{what}: per-step losses shape {losses.shape}, finite "
                 f"{bool(np.isfinite(losses).all())}")
    if not history[-1][-50:].mean() < history[0][:50].mean():
        fail(f"{what}: losses are not falling")


def phase_main_cached(tmp: str) -> dict:
    """Paths b and c: the resident-dataset trainer through K2. Returns the
    launch counts of each path."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = os.path.join(tmp, "cached.pt")
    argv = _cached_argv(tmp, "--kernel", "pallas_epoch", "--impl",
                        "threefry2x32", "--n_epochs", "1", "--checkpoint",
                        ckpt)
    _reset_counts()
    t0 = time.perf_counter()
    state, history, out = _run_trainer(cli_train, argv)
    wall = time.perf_counter() - t0
    cached = _counts()
    _check_epoch_lines(out, history, 1, "train --cached")
    expect_launches(cached, {"epoch_step_ws": 1},
                    "train --cached --kernel pallas_epoch, one epoch")
    if (epoch_step.last_launch["form"], epoch_step.last_launch["design"]) \
            != ("uint8/threefry", "ws"):
        fail(f"the cached epoch ran {epoch_step.last_launch}, not "
             f"uint8/threefry (K3) on K2-ws")
    saved = load_checkpoint(ckpt)
    for name, layer in state.model.params().items():
        for k, t in layer.items():
            if not torch.equal(saved[name][k], t.detach().cpu()):
                fail(f"cached checkpoint {name}.{k} does not load back bitwise")
    losses = history[0]
    print(f"[main] train --cached --kernel pallas_epoch --impl threefry2x32: "
          f"{EPOCH_STEPS} steps in {wall:.2f}s (wall, dataset upload and eval "
          f"included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
          f"{cached}; grid {epoch_step.last_launch['blocks']} blocks; "
          f"checkpoint loads back bitwise")

    # the same path on the CPU, where every kernel is its plain version:
    # same weights, indices and threefry masks, so only the f32 summation
    # order differs. (`--kernel xla` draws other masks: its key chain splits
    # per step, the epoch kernel's per epoch, as in the JAX package.)
    cpu_argv = list(argv)
    cpu_argv[1] = "cpu"
    cpu_argv[-1] = ""
    _reset_counts()
    _, cpu_history, _ = _run_trainer(cli_train, cpu_argv)
    expect_launches(_counts(), {}, "the cached run on the CPU")
    rel = np.abs(losses - cpu_history[0]) / np.abs(cpu_history[0])
    if not (rel <= TRAIN_RTOL).all():
        fail(f"cached per-step losses off the plain path on the CPU by up to "
             f"{rel.max():.3e} (rtol {TRAIN_RTOL})")
    print(f"[main] per-step losses vs the same path on the CPU (plain "
          f"versions, same masks): worst rel diff {rel.max():.3e} "
          f"(rtol {TRAIN_RTOL})")

    fused_argv = _cached_argv(tmp, "--fused", "--kernel", "pallas_epoch",
                              "--n_epochs", "2", "--checkpoint", "")
    _reset_counts()
    t0 = time.perf_counter()
    _, fused_history, fused_out = _run_trainer(cli_train, fused_argv)
    wall = time.perf_counter() - t0
    fused = _counts()
    _check_epoch_lines(fused_out, fused_history, 2, "train --cached --fused")
    expect_launches(fused, {"epoch_step_ws": 2},
                    "train --cached --fused --n_epochs 2")
    if epoch_step.last_launch["design"] != "ws":
        fail(f"the fused run ran {epoch_step.last_launch}")
    if not np.array_equal(fused_history[0], losses):
        fail("the fused run's first epoch differs from the cached run's")
    print(f"[main] train --cached --fused --n_epochs 2: {wall:.2f}s (wall); "
          f"launches {fused}; epoch 0 bitwise equal to the unfused run")
    return {"train --cached": cached, "train --cached --fused --n_epochs 2":
            fused}


def phase_main_cached_variants(tmp: str) -> dict:
    """Paths e and f: the cached trainer through K1-rng, K2-mma and, at
    --batch_size 256, the rows design's K2-bf16. Returns the launch counts
    of each path."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    from pytorch_ddp_mnist_tpu_torch.train import loop
    argv = _cached_argv(tmp, "--kernel", "pallas_rng", "--n_epochs", "1",
                        "--checkpoint", "")
    drawn = []
    # the cached steps draw a mask outside a kernel through loop.keyed_keep
    draw = loop.keyed_dropout_mask

    def watched(*a, **k):      # a mask drawn outside the kernel
        drawn.append(a)
        return draw(*a, **k)

    loop.keyed_dropout_mask = watched
    _reset_counts()
    try:
        t0 = time.perf_counter()
        _, history, out = _run_trainer(cli_train, argv)
        wall = time.perf_counter() - t0
    finally:
        loop.keyed_dropout_mask = draw
    rng = _counts()
    _check_epoch_lines(out, history, 1, "train --cached --kernel pallas_rng")
    expect_launches(rng, {"fused_split_rng_dev": EPOCH_STEPS},
                    "train --cached --kernel pallas_rng, one epoch (the split "
                    "design's device-seed form: the captured step reads its "
                    "seed from the key table)")
    if drawn:
        fail(f"train --cached --kernel pallas_rng drew {len(drawn)} masks "
             f"outside the kernel")
    print(f"[main] train --cached --kernel pallas_rng: {EPOCH_STEPS} steps in "
          f"{wall:.2f}s (wall); loss {history[0][0]:.4f} -> "
          f"{history[0][-1]:.4f}; launches {rng}; no mask tensor drawn")

    argv = _cached_argv(tmp, "--kernel", "pallas_epoch", "--dtype",
                        "bfloat16", "--n_epochs", "1", "--checkpoint", "")
    _reset_counts()
    t0 = time.perf_counter()
    _, history, out = _run_trainer(cli_train, argv)
    wall = time.perf_counter() - t0
    bf16 = _counts()
    _check_epoch_lines(out, history, 1, "train --cached --dtype bfloat16")
    expect_launches(bf16, {"epoch_step_mma": 1},
                    "train --cached --kernel pallas_epoch --dtype bfloat16")
    ll = epoch_step.last_launch
    if not (ll["bf16"] and ll["form"] == "uint8/threefry"
            and ll["design"] == "mma"):
        fail(f"the bf16 cached epoch ran {ll}, not K3 on K2-mma")
    losses = history[0]
    cpu_argv = list(argv)
    cpu_argv[1] = "cpu"
    _reset_counts()
    _, cpu_history, _ = _run_trainer(cli_train, cpu_argv)
    expect_launches(_counts(), {}, "the bf16 cached run on the CPU")
    rel = np.abs(losses - cpu_history[0]) / np.abs(cpu_history[0])
    if not (rel <= BF16_TRAIN_RTOL).all():
        fail(f"bf16 cached per-step losses off the plain path on the CPU by "
             f"up to {rel.max():.3e} (rtol {BF16_TRAIN_RTOL})")
    print(f"[main] train --cached --kernel pallas_epoch --dtype bfloat16: "
          f"{EPOCH_STEPS} steps in {wall:.2f}s (wall); loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}; launches {bf16}; per-step losses vs the same "
          f"path on the CPU: worst rel diff {rel.max():.3e} (rtol "
          f"{BF16_TRAIN_RTOL}); grid {ll['blocks']} blocks")

    # past MMA_MAX_BATCH the rule keeps the rows design's K2-bf16
    path = (f"train --cached --kernel pallas_epoch --dtype bfloat16 "
            f"--batch_size {ROWS_BATCH}")
    steps = 2 * ROWS_STEPS
    argv = _cached_argv(tmp, "--kernel", "pallas_epoch", "--dtype",
                        "bfloat16", "--n_epochs", "1", "--checkpoint", "",
                        "--batch_size", str(ROWS_BATCH), "--limit",
                        str(steps * ROWS_BATCH))
    _reset_counts()
    _, history, out = _run_trainer(cli_train, argv)
    rows = _counts()
    _check_bf16_run(out, history, steps, path)
    expect_launches(rows, {"epoch_step_bf16": 1}, path)
    ll = epoch_step.last_launch
    if not (ll["bf16"] and ll["design"] == "rows"):
        fail(f"{path} ran {ll}, not the rows design")
    cpu_argv = list(argv)
    cpu_argv[1] = "cpu"
    _reset_counts()
    _, cpu_history, _ = _run_trainer(cli_train, cpu_argv)
    expect_launches(_counts(), {}, f"{path} on the CPU")
    rel = np.abs(history[0] - cpu_history[0]) / np.abs(cpu_history[0])
    if not (rel <= BF16_TRAIN_RTOL).all():
        fail(f"{path}: per-step losses off the plain path on the CPU by up "
             f"to {rel.max():.3e} (rtol {BF16_TRAIN_RTOL})")
    print(f"[main] {path}: {steps} steps in one launch of the rows design; "
          f"loss {history[0][0]:.4f} -> {history[0][-1]:.4f}; launches "
          f"{ {k: v for k, v in rows.items() if v} }; per-step losses vs the "
          f"same path on the CPU: worst rel diff {rel.max():.3e} (rtol "
          f"{BF16_TRAIN_RTOL})")
    return {"train --cached --kernel pallas_rng": rng,
            "train --cached --kernel pallas_epoch --dtype bfloat16": bf16,
            path: rows}


@contextlib.contextmanager
def _k1_rows_design():
    """Every K1 launch inside runs the rows design (the card's yardstick
    for the split design), whatever fused_design picks."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    rule = fused_step.fused_design
    fused_step.fused_design = lambda *a: "rows"
    try:
        yield
    finally:
        fused_step.fused_design = rule


def phase_main_cached_k1(tmp: str) -> tuple:
    """`train --cached` with --kernel auto (K1 keyed per step: K1-split
    draws the mask from the epoch's key table; with the rows design forced
    the keyed mask entry and the rows design a step), one 469-step epoch on
    the split design and one with the rows design forced, in turns (split,
    rows, rows, split): launches by design,
    the two designs' per-step losses bitwise equal, and each run's wall
    time (dataset upload and eval included). Returns (the split run's
    launches, {design: [wall s of each run]})."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    argv = _cached_argv(tmp, "--n_epochs", "1", "--checkpoint", "")
    walls = {"split": [], "rows": []}
    runs = {}
    for design in ("split", "rows", "rows", "split"):
        _reset_counts()
        with (_k1_rows_design() if design == "rows"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            _, history, out = _run_trainer(cli_train, argv)
            walls[design].append(time.perf_counter() - t0)
        launches = _counts()
        what = f"train --cached (--kernel auto), {design} design"
        _check_epoch_lines(out, history, 1, what)
        expect_launches(launches, {"fused_split_keyed": EPOCH_STEPS}
                        if design == "split" else
                        {"fused_step": EPOCH_STEPS,
                         "threefry_mask": EPOCH_STEPS}, what)
        if design in runs and not np.array_equal(runs[design][0], history[0]):
            fail(f"{what}: two runs give different losses")
        runs[design] = (history[0], launches)
    if not np.array_equal(runs["split"][0], runs["rows"][0]):
        fail("train --cached: the split design's per-step losses differ from "
             "the rows design's (bitwise expected)")
    print(f"[main] train --cached (--kernel auto: {EPOCH_STEPS} K1 launches): "
          f"wall s split {', '.join(f'{v:.3f}' for v in walls['split'])}, "
          f"rows {', '.join(f'{v:.3f}' for v in walls['rows'])} (turns "
          f"split, rows, rows, split; upload and eval included); per-step "
          f"losses bitwise equal across the designs; launches "
          f"{ {k: v for k, v in runs['split'][1].items() if v} }")
    return runs["split"][1], walls


def phase_bench(extra=(), key="epoch_step_ws", form="uint8/core", bf16=False,
                superstep=1, design="ws") -> tuple:
    """Paths g and h: the bench entry point with `extra` arguments, whose
    launches must all be of form `key` on `design`; returns (its JSON
    line, launches)."""
    from pytorch_ddp_mnist_tpu_torch import bench
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    buf = io.StringIO()
    argv = ["--epochs", str(BENCH_EPOCHS), *extra]
    _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    torch.cuda.synchronize()
    launches = _counts()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if rc != 0 or not lines:
        fail(f"bench exited {rc} with output {buf.getvalue()!r}")
    line = json.loads(lines[-1])
    want = BENCH_EPOCHS * (bench.WINDOWS + 1)
    expect_launches(launches, {key: want}, f"bench {' '.join(argv)}")
    ll = epoch_step.last_launch
    if (ll["form"], ll["bf16"], ll["steps_per_iter"], ll["design"]) != (
            form, bf16, superstep, design):
        fail(f"bench {' '.join(argv)} ran {ll}")
    if (line.get("dtype"), line.get("superstep")) != (
            "bfloat16" if bf16 else "float32", superstep):
        fail(f"the bench line's dtype/superstep: {line}")
    for k in ("metric", "value", "unit", "vs_baseline", "tflops",
              "mfu_pct_vs_bf16_peak", "backend", "device"):
        if k not in line:
            fail(f"the bench line has no {k!r}: {line}")
    if not (line["value"] > 0 and line["backend"] == "cuda"):
        fail(f"bench line {line}")
    print(f"[main] bench {' '.join(argv)}: launches {launches}")
    print(json.dumps(line))
    return line, launches


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 20, replays: int = 50) -> float:
    """Device time per call with the host out of the way: `calls` calls
    captured in one CUDA graph, replayed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay, iters=replays, warmup=3) / calls


def _holder(ranges: dict, at: float):
    """The label of the first range [a, b) of `ranges` that holds `at`."""
    return next((label for label, (a, b) in ranges.items() if a <= at < b),
                None)


def profile_jobs(jobs: dict) -> tuple:
    """torch.profiler's device time per call of each CUDA kernel (and copy),
    for jobs {label: (fn, calls, names)} run in turn inside ONE profiler
    session, each inside a record_function range that ends after a sync:
    a kernel belongs to the job whose range's span on the device (the
    profiler's annotation of the range on the device timeline, on the
    device's clock) holds its start; where no span holds it, the job whose
    host range holds the host event that launched it (the profiler's link
    from a device event to the host op), or else its own start. A device
    start read against the host ranges can land in a neighbouring job: on
    an H100 one session's device clock ran tens of ms behind the host's, a
    K6 ring kernel was counted in a streaming job, and the short captured
    jobs lost kernels to the eager job after them; on the card the
    profiler has linked no kernel to its host op. A capture path's
    captured and eager jobs run the same kernels, so their device times
    check the placement (report_capture). A job with names keeps only the
    kernels whose short names it lists. Returns ({label: {name: us per
    call}}, {label: {"wall_ms", "window_ms", "busy_ms", "busy_share"}}),
    the second the job's host wall time, its profiler range and the union
    of its device intervals; empty where the profiler recorded no device
    time. One session: a second session later in the run recorded no
    device time on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for fn, _, _ in jobs.values():
        fn()
    torch.cuda.synchronize()
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, (fn, calls, _) in jobs.items():
            with record_function(f"job::{label}"):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t0
    t_events = time.perf_counter()
    events = prof.events()
    # the ranges on the host, and their spans on the device (one a stream
    # the range launched on), which are no kernels
    windows = {e.name[len("job::"):]: (e.time_range.start, e.time_range.end)
               for e in events if e.name.startswith("job::")
               and getattr(e, "device_type", None) == DeviceType.CPU}
    on_device = {}
    for e in events:
        if e.name.startswith("job::") and getattr(
                e, "device_type", None) == DeviceType.CUDA:
            label = e.name[len("job::"):]
            a, b = on_device.get(label, (math.inf, -math.inf))
            on_device[label] = (min(a, e.time_range.start),
                                max(b, e.time_range.end))
    # the jobs' device spans do not overlap (each range ends after a sync)
    on_device = sorted((a, b, label) for label, (a, b) in on_device.items())
    on_device_starts = [a for a, _, _ in on_device]
    # the host start of every host op and range a device event can link to
    launched_at = {e.id: e.time_range.start for e in events
                   if getattr(e, "device_type", None) == DeviceType.CPU
                   and not getattr(e, "linked_correlation_id", 0)}
    kernels = [e for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not e.name.startswith("job::")
               and e.time_range.end > e.time_range.start]
    print(f"[timing] profiler: {len(jobs)} jobs ran {sum(walls.values()):.1f}"
          f" s; their {len(kernels)} device events took "
          f"{time.perf_counter() - t_events:.1f} s to read")
    out = {label: {} for label in jobs}
    spans = {label: [] for label in jobs}
    for e in kernels:
        at = bisect.bisect_right(on_device_starts, e.time_range.start) - 1
        label = (on_device[at][2] if at >= 0
                 and e.time_range.start <= on_device[at][1] else None)
        if label is None:
            label = _holder(windows, launched_at.get(
                getattr(e, "linked_correlation_id", 0), e.time_range.start))
        if label is None:
            continue
        name = _short(e.name)
        us = e.time_range.end - e.time_range.start
        out[label][name] = out[label].get(name, 0.0) + us / jobs[label][1]
        spans[label].append((e.time_range.start, e.time_range.end))
    busy = {}
    for label, (_, _, names) in jobs.items():
        if names:
            out[label] = {k: v for k, v in out[label].items() if k in names}
        if label not in windows or not spans[label]:
            continue
        a, b = windows[label]
        total, end = 0.0, float("-inf")
        for lo, hi in sorted(spans[label]):
            if hi > end:
                total += hi - max(lo, end)
                end = hi
        busy[label] = {"wall_ms": walls[label] * 1e3,
                       "window_ms": (b - a) / 1e3, "busy_ms": total / 1e3,
                       "busy_share": total / (b - a)}
    return out, busy


def _short(kernel_name: str) -> str:
    m = re.search(r"[A-Za-z]+(?:_[A-Za-z]+)*_kernel", kernel_name)
    return m.group(0) if m else kernel_name[:60]


def _bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def k1_bound(batch: int, bf16: bool = False, rng: bool = False,
             keyed: bool = False):
    """(bound_ms, bound_by, flop, bytes) of one fused step: each input read
    once (x, the mask or, with `rng`, a 4-byte seed, with `keyed` the key's
    8 bytes, labels, weights), each
    output written once (loss, grads); the six products' multiply-adds
    (elementwise work and the in-kernel Philox left out) at the f32
    CUDA-core peak, or the bf16 tensor-core peak for the bf16 form."""
    i, h1, h2, c = 784, 128, 128, 10
    n_params = i * h1 + h1 + h1 * h2 + h2 + h2 * c
    flops = 2 * batch * (2 * (i * h1 + h1 * h2 + h2 * c) + c * h2 + h2 * h1)
    nbytes = (2 if bf16 else 4) * batch * i \
        + (4 if rng else 8 if keyed else 4 * batch * h1) + 4 * batch \
        + 4 * n_params \
        + 4 * (n_params + 1)
    return _bound(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


# launch_count keys of K1's rows design (csrc/fused_step.cu)
ROWS_K1_KEYS = ("fused_step", "fused_step_rng", "fused_step_bf16",
                "fused_step_rng_bf16", "fused_step_rng_dev",
                "fused_step_rng_dev_bf16")


def _sm_max_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(smi.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no SM clock: {smi.stdout!r} {smi.stderr!r}")


def phase_timing(device, paths: dict, max_abs_err: float, split_worst: dict,
                 card: str, prof: dict, busy: dict, cached_walls: dict) -> list:
    """K1 at B = 128, f32, with a mask and with the in-kernel draw: the split
    design and the rows design in turns (rows, split, split, rows) per
    wrapper call and in a CUDA graph, and the plain version; the split
    design's per-phase split from its stamps build (held bitwise against
    the default build); the longest chain's latency floor. `paths` are
    every main path's launches. Returns the kernels-line entries of the
    split design (mask, rng) and of the rows design (f32 mask)."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    seed = 12345
    rows_launches = sum(v.get(k, 0) for v in paths.values()
                        for k in ROWS_K1_KEYS)
    mhz = _sm_max_mhz()
    floor_us = 784 * 4 / mhz
    lib = fused_step._staged_lib("split")
    blocks = (ctypes.c_int * 3)()
    if lib.pdmt_split_blocks(MAIN_BATCH, blocks) != 0:
        fail("pdmt_split_blocks refused B = 128")
    out = []
    for rng in (False, True):
        key = "fused_split_rng" if rng else "fused_split"

        def call(design=None, rng=rng):
            if rng:
                return fused_step.fused_loss_and_grads_rng(params, x, y, seed,
                                                           _design=design)
            return fused_step.fused_loss_and_grads(params, x, y, mask,
                                                   _design=design)

        def plain(rng=rng):
            return fused_step.fused_loss_and_grads_reference(
                params, x, y, philox.rng_mask(seed, MAIN_BATCH, device)
                if rng else mask)
        split = lambda: call()  # noqa: E731
        rows = lambda: call("rows")  # noqa: E731
        p1 = _time_ms(plain, iters=50, warmup=5)
        r_ms, s_ms, turns = _turns(rows, split, iters=200, warmup=20)
        graphs = [_graph_ms(f) for f in (rows, split, split, rows)]
        p2 = _time_ms(plain, iters=50, warmup=0)
        rg, sg = min(graphs[0], graphs[3]), min(graphs[1], graphs[2])
        bound = k1_bound(MAIN_BATCH, rng=rng)
        path = "train" if not rng else "train --cached --kernel pallas_rng"
        extra = dict(
            graph_ms=sg, rows_design_ms=r_ms, rows_design_graph_ms=rg,
            graph_speedup_over_rows_design=rg / sg,
            turns_rows_split_split_rows={"call_ms": turns, "graph_ms": graphs},
            form=("K1-rng (in_kernel_rng), f32" if rng
                  else "K1 f32, mask input"),
            design="split (csrc/fused_split.cu), by fused_design at f32 "
                   "B <= SPLIT_MAX_BATCH",
            launches_by_path=_design_launches(paths, key),
            blocks_per_launch=list(blocks), chain_floor_us=floor_us,
            sm_max_mhz=mhz, batch=MAIN_BATCH)
        if not rng:
            # the per-phase split from the stamps build, bitwise the default
            # build; the profiler's kernels on each design; the per-step
            # cached epoch on each design
            base = _flat(*split())
            fused_step.split_phase_stamps(params, x, y, mask, calls=5)
            loss, grads, phases, per_call = fused_step.split_phase_stamps(
                params, x, y, mask, calls=50)
            for (leaf, a), (_, b) in zip(_flat(loss, grads), base):
                if not torch.equal(a, b):
                    fail(f"K1-split stamps build: {leaf} differs from the "
                         f"default build")
            print(f"[timing] fused_split B={MAIN_BATCH} phase split (stamps "
                  f"build, mean of 50 calls outside a graph; kernel starts "
                  f"by block 0, ends by the last block): {per_call:.2f} us "
                  f"from the first kernel's start to the last one's end "
                  f"[{card}]")
            for phase, us in phases.items():
                print(f"[timing]   {phase:36s} {us:8.3f} us  "
                      f"{us / per_call:6.1%}")
            extra.update(
                phase_split_us=phases, phase_split_call_us=per_call,
                profiler_us_per_call=prof.get("fused_split", {}),
                rows_design_profiler_us_per_call=prof.get("fused_step", {}),
                cached_k1_epoch={
                    "wall_s": cached_walls,
                    "profiler_split": busy.get("k1_epoch_split"),
                    "profiler_rows": busy.get("k1_epoch_rows")})
        if not rng:
            # since the fold no main path passes a mask: the design's f32
            # launches there are its keyed form's (entry fused_split_keyed)
            extra.update(main_path="launches: the split design's launches "
                         "on `train` (its keyed form, which draws the mask "
                         "in this design's hidden kernel); this entry's times "
                         "are its mask-input form's")
        else:
            extra.update(main_path="launches: the split design's K1-rng "
                         "launches on the path, its device-seed form's (the "
                         "captured step reads its seed from the key table; "
                         "entry fused_split_rng_dev); this entry's times are "
                         "its scalar-seed form's")
        out.append(_entry(
            key, "fused_split.cu", 333 if rng else 191,
            sum(_design_launches({path: paths[path]}, key).values()),
            split_worst[key], s_ms, min(p1, p2), bound, card, **extra))
        print(f"[timing] {key} B={MAIN_BATCH}: {sg * 1e3:.2f} us per call in "
              f"a CUDA graph against the rows design's {rg * 1e3:.2f} "
              f"({rg / sg:.2f}x; turns rows, split, split, rows: "
              f"{', '.join(f'{v * 1e3:.2f}' for v in graphs)}); per wrapper "
              f"call {s_ms * 1e3:.2f} us against {r_ms * 1e3:.2f} "
              f"({', '.join(f'{v * 1e3:.2f}' for v in turns)}); plain "
              f"{min(p1, p2) * 1e3:.2f} us; bound {bound[0] * 1e3:.3f} us by "
              f"{bound[1]}; longest chain's floor {floor_us:.2f} us (784 x 4 "
              f"cycles at {mhz:.0f} MHz) [{card}]")
        if not rng:
            rows_entry = _entry(
                "fused_step", "fused_step.cu", 191, rows_launches,
                max_abs_err, r_ms, min(p1, p2), bound, card,
                graph_ms=rg, cuda_launches_per_call=2, batch=MAIN_BATCH,
                profiler_us_per_call=prof.get("fused_step", {}),
                design="rows (csrc/fused_step.cu)",
                main_path="launches: every launch of this design on the main "
                          "paths (bf16 at B > 128, fused_step_bf16); the f32 "
                          "forms at B <= 128 run the split design and the "
                          "bf16 forms the mma design (fused_design), and this "
                          "entry's times are its f32 mask form with the "
                          "design forced, in turns with the split design")
    print("[timing] fused_split, fused_split_rng, fused_step: no single "
          "PyTorch call computes this fused function, so library_ms is null")
    return out + [rows_entry]


def k2_bound(batch: int, nsteps: int, form: str, bf16: bool = False):
    """(bound_ms, bound_by, flop, bytes) of one K2 epoch in `form`: each
    input read once (rows, labels, masks or key table, weights), each output
    written once (weights, losses); the steps' products at the f32 peak, or
    the bf16 peak for K2-bf16."""
    pixels, rng = K2_FORMS[form]
    n_params = 784 * 128 + 128 + 128 * 128 + 128 + 128 * 10
    flops = nsteps * k1_bound(batch)[2]
    rows = nsteps * batch
    nbytes = rows * 784 * (1 if pixels == "uint8" else 4) + 4 * rows \
        + (4 * 128 * rows if rng == "masks" else 0) \
        + (8 * nsteps if rng == "threefry" else 0) \
        + 2 * 4 * n_params + 4 * nsteps
    return _bound(flops, nbytes, PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)


def phase_profile(device, data: dict) -> tuple:
    """The profiler's device time per call of K1 on each design (B = 128;
    f32 and bf16), of one epoch of the cached path at the main path's
    shapes (B = 128, 469 steps, --impl rbg: the gathers of the epoch's rows
    and K2-ws, K2c; and in bf16, K2-mma), of K1-split's and K1-mma's keyed
    forms, of one epoch of the per-step cached loop (`train --cached`'s
    default --kernel pallas: K1 keyed, SGD; with the rows design forced the
    keyed mask entry, K1, SGD) on each f32 K1 design, and of the bf16
    per-step loops (the cached pallas_rng epoch, 50 streaming steps) on
    each bf16 K1 design, with each job's
    device-busy share; and one epoch of each per-step path of the capture
    phase, captured and eager (capture_profile_jobs). The per-step cached
    epochs replay steps captured before the profiler session. Returns
    profile_jobs' two dicts."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                         synthetic_mnist)
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import scan
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    xb = x.to(torch.bfloat16)
    split = data["train"]
    x_all, y_all = data["x_all"], data["y_all"]
    sampler = ShardedSampler(60000, seed=42)
    idx = scan.epoch_batch_indices(sampler, MAIN_BATCH)
    epoch = scan.make_epoch_fn(LR, kernel="pallas_epoch", impl="rbg")
    epoch_bf16 = scan.make_epoch_fn(LR, kernel="pallas_epoch", impl="rbg",
                                    dtype="bfloat16")

    def captured_epoch(kernel, dtype="float32", rows=False):
        """An epoch of the cached per-step loop on a step captured here,
        before the profiler session (on the rows design if `rows`)."""
        steps = scan.CachedSteps(scan._clone(params), x_all, y_all, idx.shape,
                                 LR, kernel, _torch_dtype(dtype))
        with (_k1_rows_design() if rows else contextlib.nullcontext()):
            steps.epoch((0, 1), idx)
        return lambda: steps.epoch((0, 1), idx)

    # the bf16 per-step loops on each K1 design: the cached pallas_rng
    # epoch, and the streaming trainer's step loop (50 host batches copied
    # to the card one a step, the threefry mask, K1-bf16, SGD; the loader's
    # host work is not in it)
    stream_step = fused_step.make_fused_train_step(LR, dtype="bfloat16")
    rows = MAIN_STEPS * MAIN_BATCH
    host_x = torch.from_numpy(normalize_images(split.images[:rows])) \
        .pin_memory().split(MAIN_BATCH)
    host_y = torch.from_numpy(split.labels[:rows].astype(np.int32)) \
        .pin_memory().split(MAIN_BATCH)
    model = MLP(torch.Generator().manual_seed(0)).to(device)

    def stream_bf16():
        _, table = stream_step.key_table(threefry.key_data(1), len(host_x),
                                         device)
        for s, (hx, hy) in enumerate(zip(host_x, host_y)):
            stream_step.run(model, table[s], hx.to(device, non_blocking=True),
                            hy.to(device, non_blocking=True))

    def rows_design(fn):
        def run():
            with _k1_rows_design():
                fn()
        return run


    words = threefry.to_int32_words([(0, 1)]).to(device)[0]
    jobs = {
        "fused_split": (lambda: fused_step.fused_loss_and_grads(
            params, x, y, mask), 50,
            ("split_hidden_kernel", "split_rows_kernel", "split_grads_kernel")),
        "fused_split_keyed": (lambda: fused_step.fused_loss_and_grads_keyed(
            params, x, y, words), 50,
            ("split_hidden_kernel", "split_rows_kernel", "split_grads_kernel")),
        "fused_mma_keyed": (lambda: fused_step.fused_loss_and_grads_keyed(
            params, xb, y, words), 50,
            ("mma_hidden_kernel", "mma_rows_kernel", "mma_grads_kernel")),
        "fused_step": (lambda: fused_step.fused_loss_and_grads(
            params, x, y, mask, _design="rows"), 50,
            ("rows_kernel", "grads_kernel")),
        "cached_epoch": (lambda: epoch(params, (0, 1), x_all, y_all, idx), 3,
                         None),
        "cached_epoch_bf16": (lambda: epoch_bf16(params, (0, 1), x_all,
                                                 y_all, idx), 3, None),
        "k1_epoch_split": (captured_epoch("pallas"), 1, None),
        "k1_epoch_rows": (captured_epoch("pallas", rows=True), 1, None),
        "fused_mma": (lambda: fused_step.fused_loss_and_grads(
            params, xb, y, mask), 50,
            ("mma_hidden_kernel", "mma_rows_kernel", "mma_grads_kernel")),
        "fused_step_bf16": (lambda: fused_step.fused_loss_and_grads(
            params, xb, y, mask, _design="rows"), 50,
            ("rows_kernel", "grads_kernel")),
        "k1_rng_bf16_epoch_mma": (captured_epoch("pallas_rng", "bfloat16"),
                                  1, None),
        "k1_rng_bf16_epoch_rows": (captured_epoch("pallas_rng", "bfloat16",
                                                  rows=True), 1, None),
        "stream_bf16_mma": (stream_bf16, 1, None),
        "stream_bf16_rows": (rows_design(stream_bf16), 1, None),
        **k6_profile_jobs(device),
        **capture_profile_jobs(device, data),
    }
    out, busy = profile_jobs(jobs)
    for label, kernels in out.items():
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        for key, us in top[:8]:
            print(f"[timing] profiler {label}: {us:12.2f} us/call  {key}")
        if not kernels:
            print(f"[timing] profiler {label}: recorded no device time "
                  f"(not measured)")
        if label in busy:
            b = busy[label]
            print(f"[timing] profiler {label}: device busy {b['busy_ms']:.3f} "
                  f"ms of a {b['window_ms']:.3f} ms range "
                  f"({b['busy_share']:.1%}); host wall {b['wall_ms']:.3f} ms")
    return out, busy


def phase_timing_k2(device, launches: dict, worst: dict, card: str,
                    prof: dict, all_paths: dict) -> list:
    """K2 in each form at the main path's shapes (B = 128, 469 steps): the
    plain version, and the rows design and K2-ws timed in turns (rows,
    ws, ws, rows) in the uint8 forms (K2a, f32 rows, has the rows design
    only); the f32 superstep K = 8 on both designs in turns; and the
    per-phase split of a K2c epoch from K2-ws's stamps build (held bitwise
    against the default build). `launches` are the K2 main paths' counts, `all_paths`
    every main path's. Returns the kernels-line entries of the rows
    design (f32) and of K2-ws."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    inp = _k2_inputs(MAIN_BATCH, EPOCH_STEPS, seed=11, device=device)
    forms = {}
    for form in K2_FORMS:
        ws = lambda: _k2_call(epoch_step.epoch_fused_sgd, form, inp)  # noqa: E731
        rows = lambda: _k2_call(epoch_step._epoch_fused_sgd_rows, form, inp)  # noqa: E731
        plain = lambda: _k2_call(  # noqa: E731
            epoch_step.epoch_fused_sgd_reference, form, inp)
        p1 = _time_ms(plain, iters=1, warmup=1)
        if _design(form, MAIN_BATCH) == "ws":
            r_ms, w_ms, turns = _turns(rows, ws, iters=5, warmup=1)
        else:
            r_ms = min(_time_ms(rows, iters=5, warmup=1) for _ in range(2))
            w_ms, turns = None, None
        p2 = _time_ms(plain, iters=1, warmup=0)
        bound_ms, bound_by, flops, nbytes = k2_bound(MAIN_BATCH, EPOCH_STEPS,
                                                     form)
        forms[form] = {"form": "/".join(K2_FORMS[form]), "rows_ms": r_ms,
                       "ws_ms": w_ms, "plain_ms": min(p1, p2),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": worst[form], "flop": flops,
                       "bytes": nbytes, "timed_in_turns_rows_ws_ws_rows": turns}
        ws_txt = (f"K2-ws {w_ms:.3f} ms ({w_ms * 1e3 / EPOCH_STEPS:.2f} us a "
                  f"step, {bound_ms / w_ms:.2%} of the bound), "
                  if w_ms is not None else "")
        print(f"[timing] epoch_step {form} ({forms[form]['form']}) "
              f"B={MAIN_BATCH} S={EPOCH_STEPS}: {ws_txt}rows design "
              f"{r_ms:.3f} ms ({r_ms * 1e3 / EPOCH_STEPS:.2f} us a step)"
              f"{'' if turns is None else ' (turns ' + ', '.join(f'{v:.3f}' for v in turns) + ')'}"
              f"; plain {min(p1, p2):.1f} ms ({p1:.1f}, {p2:.1f}); bound "
              f"{bound_ms:.4f} ms by {bound_by} [{card}]")

    # the f32 superstep K = 8 (K2c): K2-ws against the rows design
    ws8 = lambda: _k2_call(partial(epoch_step.epoch_fused_sgd,  # noqa: E731
                                   steps_per_iter=8), "K2c", inp)
    rows8 = lambda: _k2_call(partial(epoch_step._epoch_fused_sgd_rows,  # noqa: E731
                                     steps_per_iter=8), "K2c", inp)
    r8, w8, t8 = _turns(rows8, ws8, iters=5, warmup=1)
    print(f"[timing] epoch_step K2c f32 superstep K = 8: K2-ws {w8:.3f} ms, "
          f"rows design (staged rows) {r8:.3f} ms (turns "
          f"{', '.join(f'{v:.3f}' for v in t8)}) [{card}]")

    # the per-phase split of a K2c epoch (stamps build; block 0's clock)
    args = (inp["params"], inp["uint8"], inp["y"], inp["core"], LR,
            MAIN_BATCH)
    base = _k2_flat(*_k2_call(epoch_step.epoch_fused_sgd, "K2c", inp))
    epoch_step.ws_phase_stamps(*args)                    # warm-up
    params, losses, split, per_step, mhz = epoch_step.ws_phase_stamps(*args)
    for (leaf, a), (_, b) in zip(_k2_flat(params, losses), base):
        if not torch.equal(a, b):
            fail(f"K2-ws stamps build: {leaf} differs from the default build")
    print(f"[timing] epoch_ws K2c B={MAIN_BATCH} S={EPOCH_STEPS} phase split "
          f"(stamps build, block 0, mean over the steps): {per_step:.2f} us "
          f"a step, SM clock {mhz:.0f} MHz (clock64 over %globaltimer) "
          f"[{card}]")
    for phase, us in split.items():
        print(f"[timing]   {phase:28s} {us:8.3f} us  {us / per_step:6.1%}")

    prof_ws = {k: v for k, v in prof["cached_epoch"].items()
               if k == "ws_kernel"}
    k2c = forms["K2c"]
    rows_entry = {
        "name": "epoch_step", "route": "cuda",
        "source": "pytorch_ddp_mnist_tpu_torch/csrc/epoch_step.cu",
        "replaces": f"{TPU_SRC}:433",
        "launches": sum(v.get(k, 0) for v in all_paths.values()
                        for k in ROWS_DESIGN_KEYS),
        "max_abs_err": worst["K2a"],
        "ms": k2c["rows_ms"], "plain_ms": k2c["plain_ms"],
        "bound_ms": k2c["bound_ms"], "bound_by": k2c["bound_by"],
        "library_ms": None,
        # extras: which form the top-level numbers are, and which forms
        # the main paths launch this design in
        "timed_form": "K2c", "design": "rows (csrc/epoch_step.cu)",
        "main_path": "launches: every launch of this design on the main "
                     "paths, all in its bf16 forms at B > 128 (timed in the "
                     "epoch_step_bf16 and epoch_step_superstep entries); "
                     "the f32 uint8 forms at B <= 128 run epoch_step_ws "
                     "(epoch_design), and this entry's times are its f32 "
                     "K2c form, in turns with K2-ws",
        "forms": forms, "batch": MAIN_BATCH, "steps": EPOCH_STEPS,
        "card": card,
    }
    ws_forms = [f for f in K2_FORMS if forms[f]["ws_ms"] is not None]
    ws_entry = {
        "name": "epoch_step_ws", "route": "cuda",
        "source": "pytorch_ddp_mnist_tpu_torch/csrc/epoch_ws.cu",
        "replaces": f"{TPU_SRC}:433",
        "launches": launches["train --cached"]["epoch_step_ws"],
        "max_abs_err": max(worst[f] for f in ws_forms),
        "ms": k2c["ws_ms"], "plain_ms": k2c["plain_ms"],
        "bound_ms": k2c["bound_ms"], "bound_by": k2c["bound_by"],
        "library_ms": None,
        # extras: the timed form, every uint8 form on both designs, the
        # superstep, the phase split, launches by path
        "timed_form": "K2c", "us_per_step": k2c["ws_ms"] * 1e3 / EPOCH_STEPS,
        "rows_design_ms": k2c["rows_ms"],
        "forms": {f: forms[f] for f in ws_forms},
        "superstep8": {"ws_ms": w8, "rows_ms": r8, "turns_rows_ws_ws_rows": t8},
        "blocks": epoch_step._ws_lib().pdmt_ws_blocks(),
        "smem_bytes_per_block": epoch_step._ws_lib().pdmt_ws_smem_bytes(),
        "phase_split_us": split, "phase_split_step_us": per_step,
        "phase_split_sm_mhz": mhz,
        "launches_by_path": {k: v["epoch_step_ws"] for k, v in
                             launches.items()},
        "profiler_us_per_call": prof_ws,
        "cached_epoch_profiler_us": prof["cached_epoch"],
        "batch": MAIN_BATCH, "steps": EPOCH_STEPS, "card": card,
    }
    print("[timing] epoch_step, epoch_step_ws: no single PyTorch call "
          "computes an epoch of SGD, so library_ms is null")
    return [rows_entry, ws_entry]


def _turns(first, second, iters: int, warmup: int):
    """(first, second, second, first) timed in turns, so that the two are
    compared within one call: returns (first's best, second's best, the
    four times)."""
    a1 = _time_ms(first, iters=iters, warmup=warmup)
    b1 = _time_ms(second, iters=iters, warmup=warmup)
    b2 = _time_ms(second, iters=iters, warmup=0)
    a2 = _time_ms(first, iters=iters, warmup=0)
    return min(a1, a2), min(b1, b2), (a1, b1, b2, a2)


def _design_launches(paths: dict, key: str) -> dict:
    """{path: launches} of a design's form `key` on each path that ran it,
    with the launches of the same design's keyed form (`key` + "_keyed",
    the mask drawn in the kernel) and device-seed form (`key` + "_dev",
    the seed read from the key table by a captured step) on that path."""
    out = {}
    for path, counts in paths.items():
        n = sum(counts.get(k, 0) for k in (key, key + "_keyed", key + "_dev"))
        if n:
            out[path] = n
    return out


def _entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
           bound, card, **extra):
    bound_ms, bound_by, flops, nbytes = bound
    return {"name": name, "route": "cuda",
            "source": f"pytorch_ddp_mnist_tpu_torch/csrc/{source}",
            "replaces": f"{TPU_SRC}:{replaces}", "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "flop": flops, "bytes": nbytes, "card": card, **extra}


def _mma_turns(params, xb, y, mask, seed, rng: bool) -> dict:
    """K1's bf16 form (the mask `mask`, or the in-kernel draw of `seed`)
    at xb's batch: the rows design and the mma design in turns (rows, mma,
    mma, rows) per wrapper call and per call in a CUDA graph, between two
    timings of the plain version. Returns the best ms of each and the
    turns."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox

    def call(design=None):
        if rng:
            return fused_step.fused_loss_and_grads_rng(params, xb, y, seed,
                                                       _design=design)
        return fused_step.fused_loss_and_grads(params, xb, y, mask,
                                               _design=design)

    def plain():
        return fused_step.step_reference_bf16(
            params, xb, y,
            philox.rng_mask(seed, xb.shape[0], xb.device) if rng else mask)
    mma = lambda: call()  # noqa: E731
    rows = lambda: call("rows")  # noqa: E731
    p1 = _time_ms(plain, iters=50, warmup=5)
    r_ms, m_ms, turns = _turns(rows, mma, iters=200, warmup=20)
    graphs = [_graph_ms(f) for f in (rows, mma, mma, rows)]
    p2 = _time_ms(plain, iters=50, warmup=0)
    return {"mma_ms": m_ms, "rows_ms": r_ms,
            "mma_graph_ms": min(graphs[1], graphs[2]),
            "rows_graph_ms": min(graphs[0], graphs[3]),
            "plain_ms": min(p1, p2), "call_turns": turns,
            "graph_turns": graphs}


def phase_timing_mma(device, launches: dict, worst: dict, card: str,
                     prof: dict, busy: dict, walls: dict) -> list:
    """K1's bf16 forms at B = 128, with a mask and with the in-kernel Philox
    draw: the mma design and the rows design in turns (rows, mma, mma,
    rows) per wrapper call and in a CUDA graph, and the plain version; the
    mma design's per-phase split from its stamps build (held against the
    default build at the pins; at B = 128); the profiler's kernels of each
    design, and the bf16 per-step loops' wall time and device-busy share on
    each. `launches` are every main path's. Returns the kernels-line
    entries of the mma design (mask, rng) and of the rows design's bf16
    forms (mask, with the rng form's times as fields of the rows design's
    rng entry: see phase_timing_variants)."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    xb = x.to(torch.bfloat16)
    seed = 12345
    rows_launches = sum(v.get(k, 0) for v in launches.values()
                        for k in ROWS_K1_KEYS)
    lib = fused_step._staged_lib("mma")
    blocks = (ctypes.c_int * 3)()
    if lib.pdmt_mma_blocks(MAIN_BATCH, blocks) != 0:
        fail("pdmt_mma_blocks refused B = 128")
    out, rows_times = [], {}
    for rng in (False, True):
        key = "fused_mma_rng" if rng else "fused_mma"
        t = _mma_turns(params, xb, y, mask, seed, rng)
        r_ms, m_ms, rg, mg, plain_ms = (t[k] for k in (
            "rows_ms", "mma_ms", "rows_graph_ms", "mma_graph_ms", "plain_ms"))
        turns, graphs = t["call_turns"], t["graph_turns"]
        rows_times[rng] = (r_ms, rg, turns, graphs)
        bound = k1_bound(MAIN_BATCH, bf16=True, rng=rng)
        path = ("train --cached --kernel pallas_rng --dtype bfloat16" if rng
                else "train --kernel pallas --dtype bfloat16")
        extra = dict(
            graph_ms=mg, rows_design_ms=r_ms, rows_design_graph_ms=rg,
            graph_speedup_over_rows_design=rg / mg,
            turns_rows_mma_mma_rows={"call_ms": turns, "graph_ms": graphs},
            form=("K1-rng-bf16 (in_kernel_rng, compute_bf16)" if rng
                  else "K1-bf16 (compute_bf16), mask input"),
            design="mma (csrc/fused_mma.cu), by fused_design at bf16 "
                   "B <= MMA_MAX_BATCH; products on the tensor cores "
                   "(mma.sync m16n8k16, bf16 in, f32 accumulate)",
            tolerance="JAX bf16 pins vs step_reference_bf16: loss rtol "
                      f"{BF16_LOSS_RTOL}, grads rtol {BF16_GRAD_RTOL} / atol "
                      f"{BF16_GRAD_ATOL}",
            launches_by_path=_design_launches(launches, key),
            blocks_per_launch=list(blocks),
            per_step_loop={"wall_s": walls.get(path),
                           "profiler_mma": busy.get(
                               "k1_rng_bf16_epoch_mma" if rng
                               else "stream_bf16_mma"),
                           "profiler_rows": busy.get(
                               "k1_rng_bf16_epoch_rows" if rng
                               else "stream_bf16_rows")},
            batch=MAIN_BATCH)
        if not rng:
            base = _flat(*fused_step.fused_loss_and_grads(params, xb, y,
                                                          mask))
            fused_step.mma_phase_stamps(params, xb, y, mask, calls=5)
            loss, grads, phases, per_call = fused_step.mma_phase_stamps(
                params, xb, y, mask, calls=50)
            for (leaf, a), (_, b) in zip(_flat(loss, grads), base):
                if not torch.equal(a, b):
                    fail(f"K1-mma stamps build: {leaf} differs from the "
                         f"default build")
            print(f"[timing] fused_mma B={MAIN_BATCH} phase split (stamps "
                  f"build, mean of 50 calls outside a graph; kernel starts "
                  f"by block 0, ends by the last block): {per_call:.2f} us "
                  f"from the first kernel's start to the last one's end "
                  f"[{card}]")
            for phase, us in phases.items():
                print(f"[timing]   {phase:36s} {us:8.3f} us  "
                      f"{us / per_call:6.1%}")
            extra.update(phase_split_us=phases, phase_split_call_us=per_call,
                         profiler_us_per_call=prof.get("fused_mma", {}),
                         rows_design_profiler_us_per_call=prof.get(
                             "fused_step_bf16", {}))
        if not rng:
            extra.update(main_path="launches: the mma design's launches on "
                         "`train --kernel pallas --dtype bfloat16` (its keyed "
                         "form, which draws the mask in this design's hidden "
                         "kernel); this entry's times are its mask-input "
                         "form's")
        else:
            extra.update(main_path="launches: the mma design's K1-rng "
                         "launches on the path, its device-seed form's (entry "
                         "fused_mma_rng_dev); this entry's times are its "
                         "scalar-seed form's")
        out.append(_entry(
            key, "fused_mma.cu", 333 if rng else 191,
            sum(_design_launches({path: launches[path]}, key).values()),
            worst[key], m_ms, plain_ms, bound, card, **extra))
        print(f"[timing] {key} B={MAIN_BATCH}: {mg * 1e3:.2f} us per call in "
              f"a CUDA graph against the rows design's {rg * 1e3:.2f} "
              f"({rg / mg:.2f}x; turns rows, mma, mma, rows: "
              f"{', '.join(f'{v * 1e3:.2f}' for v in graphs)}); per wrapper "
              f"call {m_ms * 1e3:.2f} us against {r_ms * 1e3:.2f} "
              f"({', '.join(f'{v * 1e3:.2f}' for v in turns)}); plain "
              f"{plain_ms * 1e3:.2f} us; bound {bound[0] * 1e3:.3f} us by "
              f"{bound[1]} [{card}]")
        if not rng:
            out.append(_entry(
                "fused_step_bf16", "fused_step.cu", 191, rows_launches,
                worst["fused_step_bf16"], r_ms, plain_ms, bound, card,
                graph_ms=rg, form="K1-bf16 (compute_bf16), the rows design",
                design="rows (csrc/fused_step.cu)", batch=MAIN_BATCH,
                profiler_us_per_call=prof.get("fused_step_bf16", {}),
                main_path="launches: every launch of the rows design on the "
                          "main paths (bf16 at B > 128); this entry's times "
                          "are its bf16 mask form at B = 128 with the design "
                          "forced, in turns with the mma design"))
    for label in ("stream_bf16", "k1_rng_bf16_epoch"):
        for design in ("mma", "rows"):
            b = busy.get(f"{label}_{design}")
            if b:
                print(f"[timing] {label} on the {design} design: device busy "
                      f"{b['busy_ms']:.3f} ms of {b['window_ms']:.3f} "
                      f"({b['busy_share']:.1%}) [{card}]")
    print("[timing] fused_mma, fused_mma_rng, fused_step_bf16: no single "
          "PyTorch call computes this fused function, so library_ms is null")
    return out, rows_times[True]


def phase_timing_keyed(device, paths: dict, worst: dict, card: str) -> list:
    """The keyed forms at B = 128, f32 (K1-split) and bf16 (K1-mma): the
    keyed call and the path it replaced (the mask entry, then the
    mask-input form of the same design) in turns (entry, keyed, keyed,
    entry) per wrapper call and per call in a CUDA graph, between two
    timings of the plain version (the plain draw and step); each design's
    per-phase split from its stamps build, keyed and on the mask in turns
    (mask, keyed, keyed, mask), the keyed stamps build held bitwise against
    the default build. `paths` are every main path's launches. Returns the
    kernels-line entries of the two keyed forms."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
    params, x, y, _ = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    key = threefry.split(threefry.key_data(1))[1]
    words = threefry.to_int32_words([key]).to(device)[0]
    out = []
    for bf16 in (False, True):
        xin = x.to(torch.bfloat16) if bf16 else x
        design = "mma" if bf16 else "split"
        name = f"fused_{design}_keyed"
        path = "train --kernel pallas --dtype bfloat16" if bf16 else "train"

        def keyed(xin=xin):
            return fused_step.fused_loss_and_grads_keyed(params, xin, y,
                                                         words)

        def entry(xin=xin):
            return fused_step.fused_loss_and_grads(
                params, xin, y, fused_step.dropout_mask(key, MAIN_BATCH,
                                                        device))

        def plain(xin=xin, bf16=bf16):
            ref = (fused_step.step_reference_bf16 if bf16 else
                   fused_step.fused_loss_and_grads_reference)
            return ref(params, xin, y,
                       threefry.dropout_mask(key, MAIN_BATCH, device))
        p1 = _time_ms(plain, iters=50, warmup=5)
        e_ms, k_ms, turns = _turns(entry, keyed, iters=200, warmup=20)
        graphs = [_graph_ms(f) for f in (entry, keyed, keyed, entry)]
        p2 = _time_ms(plain, iters=50, warmup=0)
        eg, kg = min(graphs[0], graphs[3]), min(graphs[1], graphs[2])

        stamps_of = (fused_step.mma_phase_stamps if bf16
                     else fused_step.split_phase_stamps)
        mask = fused_step.dropout_mask(key, MAIN_BATCH, device)
        base = _flat(*keyed())
        stamps_of(params, xin, y, key_words=words, calls=5)
        split = {}
        for form in ("mask", "keyed", "keyed", "mask"):
            got = (stamps_of(params, xin, y, key_words=words, calls=50)
                   if form == "keyed" else
                   stamps_of(params, xin, y, mask, calls=50))
            if form == "keyed":
                _check_bitwise(f"{name} stamps build", _flat(got[0], got[1]),
                               base, "the default build")
            split.setdefault(form, []).append((got[2], got[3]))
        best = {form: min(runs, key=lambda r: r[1])
                for form, runs in split.items()}
        hidden = next(iter(best["keyed"][0]))
        print(f"[timing] {name} B={MAIN_BATCH} phase split (stamps build, "
              f"mean of 50 calls, turns mask, keyed, keyed, mask; the "
              f"faster of each form's two): keyed {best['keyed'][1]:.2f} us, "
              f"on the mask {best['mask'][1]:.2f} us from the first kernel's "
              f"start to the last one's end [{card}]")
        for phase in best["keyed"][0]:
            print(f"[timing]   {phase:40s} keyed {best['keyed'][0][phase]:8.3f}"
                  f" us, mask {best['mask'][0][phase]:8.3f} us")
        bound = k1_bound(MAIN_BATCH, bf16=bf16, keyed=True)
        out.append(_entry(
            name, f"fused_{design}.cu", 191, paths[path].get(name, 0),
            worst[name], k_ms, min(p1, p2), bound, card, graph_ms=kg,
            mask_entry_path_ms=e_ms, mask_entry_path_graph_ms=eg,
            turns_entry_keyed_keyed_entry={"call_ms": turns,
                                           "graph_ms": graphs},
            phase_split_us=best["keyed"][0],
            phase_split_call_us=best["keyed"][1],
            mask_input_phase_split_us=best["mask"][0],
            mask_input_phase_split_call_us=best["mask"][1],
            hidden_phase_us={"keyed": best["keyed"][0][hidden],
                             "mask": best["mask"][0][hidden]},
            stamp_turns={f: [r[1] for r in runs] for f, runs in split.items()},
            form=f"K1{'-bf16' if bf16 else ''} keyed: jax's threefry mask "
                 f"dropout_mask(key, B) drawn in the hidden phase, the key's "
                 f"words read from a device key table (pallas_step.py "
                 f"dropout_mask :1226, threefry2x32 :92, _threefry_mask_block "
                 f":123)",
            design=f"{design} (csrc/fused_{design}.cu), by fused_design",
            replaced="the mask entry (fused_step.cu threefry_mask_kernel) "
                     "and this design's mask-input form: "
                     "mask_entry_path_ms, mask_entry_path_graph_ms",
            launches_by_path={k: v[name] for k, v in paths.items()
                              if v.get(name)},
            batch=MAIN_BATCH))
        print(f"[timing] {name} B={MAIN_BATCH}: {kg * 1e3:.2f} us per call "
              f"in a CUDA graph against the mask entry + mask-input form's "
              f"{eg * 1e3:.2f} (turns entry, keyed, keyed, entry: "
              f"{', '.join(f'{v * 1e3:.2f}' for v in graphs)}); per wrapper "
              f"call {k_ms * 1e3:.2f} us against {e_ms * 1e3:.2f} "
              f"({', '.join(f'{v * 1e3:.2f}' for v in turns)}); plain "
              f"{min(p1, p2) * 1e3:.2f} us; bound {bound[0] * 1e3:.3f} us by "
              f"{bound[1]} [{card}]")
    print("[timing] fused_split_keyed, fused_mma_keyed: no single PyTorch "
          "call computes this fused function, so library_ms is null")
    return out


# a per-step epoch's parts, in order, each the host time since the last
EPOCH_PARTS = ("upload", "indices", "key table", "step loop", "loss fetch",
               "eval")
WALL_PATHS = (("cached", "float32"), ("cached", "bfloat16"),
              ("streaming", "float32"))


def _stamped_epoch(device, data, path: str, dtype: str, folded: bool):
    """One epoch of a per-step `--kernel pallas` path at B = 128 (`cached`:
    the dataset on the card, scan.py's step loop; `streaming`: loop.py
    `fit`'s, a batch copied from the host a step), from MLP.from_seed(0)
    and key 1, with host stamps between its parts (EPOCH_PARTS; the
    streaming step loop's host-to-card batches also as "io in the step
    loop"). `folded`: the port's step (the epoch's key table, the keyed
    kernel); otherwise the step before the fold, rebuilt from the public
    entries: `key, sub = split(key)` a step, the mask entry, the
    mask-input form. Returns ({part: s}, losses, params on the CPU)."""
    from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
    from pytorch_ddp_mnist_tpu_torch.ops.sgd import sgd_step
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import loop, scan
    images, labels, x_norm, x_test, y_test = data
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model = MLP.from_seed(0).to(device)
    key = threefry.key_data(1)
    sampler = ShardedSampler(len(labels), shuffle=True, seed=42)
    sampler.set_epoch(0)
    parts, io = {}, 0.0
    torch.cuda.synchronize()
    last = time.perf_counter()

    def mark(part):
        nonlocal last
        now = time.perf_counter()
        parts[part], last = now - last, now

    if path == "cached":
        x_all = torch.from_numpy(scan.resident_images(images)).to(device)
        y_all = torch.from_numpy(labels).to(device)
    x_test_dev = torch.as_tensor(x_test, device=device)
    y_test_dev = torch.as_tensor(y_test, device=device)
    torch.cuda.synchronize()
    mark("upload")
    if path == "cached":
        idx = loop._to_device(scan.epoch_batch_indices(sampler, MAIN_BATCH),
                              device)
        nsteps = idx.shape[0]
    else:
        loader = BatchLoader(x_norm, labels, sampler, batch_size=MAIN_BATCH)
        nsteps = len(loader)
    mark("indices")
    if folded:
        key, table = threefry.step_key_table(key, nsteps, device)
    mark("key table")

    def step_on(params, x, y):      # the step before the fold
        nonlocal key
        key, sub = threefry.split(key)
        mask = fused_step.dropout_mask(sub, x.shape[0], device)
        return fused_step.fused_loss_and_grads(params, x, y, mask)

    losses = []
    if path == "cached":
        params = scan._clone(model.params())
        for s, rows in enumerate(idx):
            if folded:
                loss, grads = scan._loss_and_grads(params, x_all, y_all, rows,
                                                   table[s], "pallas", dt)
            else:
                loss, grads = step_on(params,
                                      scan._gathered_x(x_all, rows, dt),
                                      y_all.index_select(0, rows))
            sgd_step(params, grads, LR)
            losses.append(loss)
    else:
        step = fused_step.make_fused_train_step(LR, dtype=dtype)
        batches = iter(loader)
        while True:
            t_io = time.perf_counter()
            batch = next(batches, None)
            if batch is not None:
                x, y = (loop._to_device(a, device) for a in batch)
            io += time.perf_counter() - t_io
            if batch is None:
                break
            if folded:
                loss = step.run(model, table[len(losses)], x, y)
            else:
                params = model.params()
                loss, grads = step_on(params, x.to(dt), y)
                sgd_step(params, grads, LR)
            losses.append(loss)
        params = model.params()
    mark("step loop")
    losses = torch.stack(losses).cpu().numpy()
    mark("loss fetch")
    if path == "cached":
        scan._load_params(model, params)
    loop.evaluate(model, x_test_dev, y_test_dev, MAIN_BATCH)
    mark("eval")
    if path == "streaming":
        parts["io in the step loop"] = io
    return parts, losses, {n: {k: v.detach().cpu() for k, v in layer.items()}
                           for n, layer in params.items()}


def phase_epoch_walls(device, tmp: str, card: str) -> dict:
    """Where a per-step epoch's wall time goes: one epoch (469 steps at B =
    128) of the cached `--kernel pallas` path in f32 and bf16 and of the
    streaming path in f32, each on the port's step and on the step before
    the fold (the mask entry + the mask-input form), in turns (before,
    after, after, before), host stamps between the parts (EPOCH_PARTS).
    The two steps' losses and params bitwise equal. Before them, what a
    `train` run does before its first epoch (the data made and normalised,
    the init), each part timed once. Returns {"setup": {part: s}, path:
    {"before" | "after": [{part: s} of each run]}}."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (get_mnist,
                                                         normalize_images)
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    # what a `train` run does before its first epoch, each part timed once
    root = os.path.join(tmp, "no_mnist_here")
    setup, last = {}, time.perf_counter()

    def mark(part):
        nonlocal last
        now = time.perf_counter()
        setup[part], last = now - last, now
    train = get_mnist(root, train=True)
    mark("train split (synthetic 60k)")
    test = get_mnist(root, train=False)
    mark("test split (synthetic 10k)")
    x_norm = normalize_images(train.images)
    mark("normalize the train split (streaming only)")
    x_test = normalize_images(test.images)
    mark("normalize the test split")
    MLP.from_seed(0).to(device)
    torch.cuda.synchronize()
    mark("MLP.from_seed on the card")
    print(f"[timing] a run's setup before its first epoch: "
          f"{sum(setup.values()):.4f} s = " + ", ".join(
              f"{p} {v:.4f}" for p, v in setup.items()) + f" [{card}]")
    data = (train.images, train.labels.astype(np.int32), x_norm, x_test,
            test.labels.astype(np.int32))
    out = {"setup": setup}
    for path, dtype in WALL_PATHS:
        what = f"{path} --kernel pallas {dtype}"
        runs = {"before": [], "after": []}
        results = {}
        for folded in (False, True, True, False):
            label = "after" if folded else "before"
            parts, losses, params = _stamped_epoch(device, data, path, dtype,
                                                   folded)
            runs[label].append(parts)
            if label in results:
                continue
            results[label] = (losses, params)
        (la, pa), (lb, pb) = results["after"], results["before"]
        if not (np.array_equal(la, lb) and _equal_trees(pa, pb)):
            fail(f"epoch of {what}: the keyed step's losses or params differ "
                 f"from the step before the fold (bitwise expected)")
        if la.shape != (EPOCH_STEPS,) or not np.isfinite(la).all():
            fail(f"epoch of {what}: losses shape {la.shape} or not finite")
        for label in ("before", "after"):
            for parts in runs[label]:
                total = sum(parts[p] for p in EPOCH_PARTS)
                print(f"[timing] epoch {what}, {label} the fold: "
                      f"{total:.4f} s = " + ", ".join(
                          f"{p} {parts[p]:.4f}" for p in parts) + f" [{card}]")
        out[what] = runs
    print("[timing] epochs: the keyed step's losses and params bitwise the "
          "step before the fold on each path")
    return out


def phase_timing_variants(device, launches: dict, worst: dict, card: str,
                          rows_rng_bf16: tuple):
    """The rows design's K1-rng (f32, forced; its bf16 form's times from
    phase_timing_mma's turns, `rows_rng_bf16`) and the threefry mask at
    B = 128. Returns the kernels-line entries."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox, threefry
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    out = []

    seed = 12345
    kernel = lambda: fused_step.fused_loss_and_grads_rng(  # noqa: E731
        params, x, y, seed, _design="rows")
    plain = lambda: fused_step.fused_loss_and_grads_reference(  # noqa: E731
        params, x, y, philox.rng_mask(seed, MAIN_BATCH, device))
    p, k, t = _turns(plain, kernel, iters=50, warmup=5)
    kg = _graph_ms(kernel)
    b_ms, b_graph, b_turns, b_graphs = rows_rng_bf16
    out.append(_entry(
        "fused_step_rng", "fused_step.cu", 333,
        sum(v.get(key, 0) for v in launches.values() for key in ROWS_K1_KEYS),
        worst["fused_step_rng"], k, p, k1_bound(MAIN_BATCH, rng=True), card,
        graph_ms=kg, form="K1-rng (in_kernel_rng), f32, the rows design "
        "forced", batch=MAIN_BATCH, bf16_ms=b_ms, bf16_graph_ms=b_graph,
        bf16_turns_rows_mma_mma_rows={"call_ms": b_turns, "graph_ms": b_graphs},
        main_path="launches: every launch of the rows design on the main "
                  "paths (bf16 at B > 128); the f32 rng form at B <= 128 runs "
                  "the split design (fused_split_rng), the bf16 one the mma "
                  "design (fused_mma_rng); bf16_ms and bf16_graph_ms are its "
                  "bf16 form's times with the design forced"))
    print(f"[timing] fused_step rng (rows design) B={MAIN_BATCH}: "
          f"{k * 1e3:.2f} us per "
          f"wrapper call ({t[1] * 1e3:.2f}, {t[2] * 1e3:.2f}), "
          f"{kg * 1e3:.2f} us in a CUDA graph; plain (Philox in torch + the "
          f"plain step) {p * 1e3:.2f} us; bound "
          f"{out[-1]['bound_ms'] * 1e3:.3f} us by {out[-1]['bound_by']}; its "
          f"bf16 form {b_ms * 1e3:.2f} us per call, {b_graph * 1e3:.2f} us in "
          f"a CUDA graph [{card}]")

    key = threefry.split(threefry.key_data(1))[1]
    kernel = lambda: fused_step.dropout_mask(key, MAIN_BATCH, device)  # noqa: E731
    plain = lambda: threefry.dropout_mask(key, MAIN_BATCH, device)  # noqa: E731
    p, k, t = _turns(plain, kernel, iters=200, warmup=20)
    kg = _graph_ms(kernel)
    nbytes = 4 * MAIN_BATCH * 128 + 8
    out.append(_entry(
        "threefry_mask", "fused_step.cu", 123,
        sum(c.get("threefry_mask", 0) for c in launches.values()),
        worst["threefry_mask"], k, p,
        (nbytes / PEAK_BYTES_PER_S * 1e3, "bytes", 0, nbytes), card,
        graph_ms=kg,
        launches_by_path={path: c["threefry_mask"]
                          for path, c in launches.items()
                          if c.get("threefry_mask")},
        form="the mask entry: the `xla` step's per-step dropout draw, and "
             "the rows design's keyed step at B > 128 (K3's threefry "
             "device function); since the fold K1-split and K1-mma draw "
             "the mask themselves, so no `pallas` or world path at B = 128 "
             "launches it; its int32 cipher operations are not in the "
             "bound, which has f32 and bf16 peaks only",
        batch=MAIN_BATCH))
    print(f"[timing] threefry_mask B={MAIN_BATCH}: {k * 1e3:.2f} us per "
          f"launch, {kg * 1e3:.2f} us in a CUDA graph; plain {p * 1e3:.2f} "
          f"us; bound {out[-1]['bound_ms'] * 1e3:.4f} us by bytes [{card}]")

    return out


def mma_epoch_times(device, card: str) -> dict:
    """K2's bf16 forms over the 469-step epoch at B = 128 (uint8 rows,
    in-kernel Philox, K2c): K2-mma and the rows design forced, in turns
    (rows, mma, mma, rows) at K = 1 and at K = 8, between two timings of
    the plain version; K2-mma's per-phase split from its stamps build (held
    bitwise against the default build). Prints them; returns {K: (mma ms,
    rows ms, turns)}, the plain version's ms, the bound, the phase split,
    the us a step of the stamps build and K2-mma's blocks."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    inp = _k2_inputs(MAIN_BATCH, EPOCH_STEPS, seed=11, device=device)

    def run(fn, k):
        return lambda: _k2_call(partial(fn, compute_bf16=True,
                                        steps_per_iter=k), "K2c", inp)
    plain = run(epoch_step.epoch_fused_sgd_reference, 1)
    p1 = _time_ms(plain, iters=1, warmup=1)
    times = {}
    for k in (1, 8):
        r_ms, m_ms, turns = _turns(run(epoch_step._epoch_fused_sgd_rows, k),
                                   run(epoch_step.epoch_fused_sgd, k),
                                   iters=5, warmup=1)
        times[k] = (m_ms, r_ms, turns)
    p2 = _time_ms(plain, iters=1, warmup=0)
    plain_ms = min(p1, p2)
    bound = k2_bound(MAIN_BATCH, EPOCH_STEPS, "K2c", bf16=True)
    for k, (m_ms, r_ms, turns) in times.items():
        print(f"[timing] epoch_step bf16 K2c B={MAIN_BATCH} S={EPOCH_STEPS} "
              f"K = {k}: K2-mma {m_ms:.3f} ms ({m_ms * 1e3 / EPOCH_STEPS:.2f} "
              f"us a step, {bound[0] / m_ms:.2%} of the bound), rows design "
              f"{r_ms:.3f} ms ({r_ms / m_ms:.2f}x; turns rows, mma, mma, "
              f"rows: {', '.join(f'{v:.3f}' for v in turns)}); plain "
              f"{plain_ms:.1f} ms ({p1:.1f}, {p2:.1f}); bound "
              f"{bound[0]:.4f} ms by {bound[1]} [{card}]")

    args = (inp["params"], inp["uint8"], inp["y"], inp["core"], LR,
            MAIN_BATCH)
    base = _k2_flat(*_k2_call(partial(epoch_step.epoch_fused_sgd,
                                      compute_bf16=True), "K2c", inp))
    blocks = epoch_step.last_launch["blocks"]
    epoch_step.mma_epoch_phase_stamps(*args)                 # warm-up
    params, losses, split, per_step = epoch_step.mma_epoch_phase_stamps(*args)
    _check_bitwise("K2-mma stamps build", _k2_flat(params, losses), base,
                   "the default build")
    print(f"[timing] epoch_mma K2c B={MAIN_BATCH} S={EPOCH_STEPS} phase split "
          f"(stamps build, mean over the steps; a phase ends at its last "
          f"block's end, a barrier at block 0's exit): {per_step:.2f} us a "
          f"step [{card}]")
    for phase, us in split.items():
        print(f"[timing]   {phase:48s} {us:8.3f} us  {us / per_step:6.1%}")
    return {"times": times, "plain_ms": plain_ms, "bound": bound,
            "split": split, "per_step": per_step, "blocks": blocks}


def phase_timing_k2_mma(device, launches: dict, worst: dict, card: str,
                        prof: dict) -> list:
    """K2-mma and the rows design's bf16 form timed in turns, and K2-mma's
    phase split (mma_epoch_times). `launches` are every main path's, `prof`
    the profiler's jobs (phase_profile).
    Returns the kernels-line entries of K2-mma and of the rows design's
    K2-bf16 and bf16 superstep (which the main paths launch at B > 128)."""
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    t = mma_epoch_times(device, card)
    plain_ms, bound, split, per_step, blocks = (
        t[k] for k in ("plain_ms", "bound", "split", "per_step", "blocks"))
    cached = "train --cached --kernel pallas_epoch --dtype bfloat16"
    rows_cached = f"{cached} --batch_size {ROWS_BATCH}"
    rows_bench = (f"bench --kernel pallas_epoch --dtype bfloat16 --superstep "
                  f"{ROWS_SUPERSTEP} --batch_size {ROWS_BATCH}")
    (m1, r1, t1), (m8, r8, t8) = t["times"][1], t["times"][8]
    out = [_entry(
        "epoch_step_mma", "epoch_mma.cu", 433, launches[cached]["epoch_step_mma"],
        worst["mma"], m1, plain_ms, bound, card,
        form="K2-mma uint8/core (Philox), K = 1; bitwise K1-mma + SGD per step",
        design="mma (csrc/epoch_mma.cu), by epoch_design at uint8 bf16 B <= "
               "MMA_MAX_BATCH: K1-mma's three phases a step in one "
               "cooperative launch, SGD folded into the gradient phase",
        tolerance=f"JAX bf16 epoch pins vs the plain version and the rows "
                  f"design: losses rtol {BF16_LOSS_RTOL} / atol "
                  f"{BF16_LOSS_ATOL}, params {BF16_PARAM_FRO_RTOL} in "
                  f"relative Frobenius norm",
        us_per_step=m1 * 1e3 / EPOCH_STEPS, k8_ms=m8, rows_design_ms=r1,
        rows_design_k8_ms=r8,
        turns_rows_mma_mma_rows={"K1": t1, "K8": t8},
        launches_by_path={k: v["epoch_step_mma"] for k, v in launches.items()
                          if v.get("epoch_step_mma")},
        blocks=blocks,
        smem_bytes_per_block=epoch_step._mma_lib().pdmt_emma_smem_bytes(),
        phase_split_us=split, phase_split_step_us=per_step,
        cached_epoch_profiler_us=prof.get("cached_epoch_bf16", {}),
        batch=MAIN_BATCH, steps=EPOCH_STEPS)]
    out.append(_entry(
        "epoch_step_bf16", "epoch_step.cu", 497,
        launches[rows_cached]["epoch_step_bf16"], worst["rows"], r1,
        plain_ms, bound, card,
        form="K2-bf16 uint8/core (Philox), K = 1, the rows design forced at "
             "B = 128, in turns with K2-mma; max_abs_err the worst against "
             "the plain version at B = 128, 96, 8 and the main paths' "
             f"B = {ROWS_BATCH}", batch=MAIN_BATCH,
        steps=EPOCH_STEPS,
        main_path=f"launches: `{rows_cached}` (B > 128); at B <= 128 the "
                  f"uint8 bf16 forms run epoch_step_mma"))
    out.append(_entry(
        "epoch_step_superstep", "epoch_step.cu", 505,
        launches[rows_bench]["epoch_step_superstep_bf16"],
        worst["rows_superstep"], r8, plain_ms, bound, card,
        form="K2-bf16 uint8/core, superstep K = 8 (staged rows), the rows "
             "design forced at B = 128, in turns with K2-mma's K = 8; "
             f"max_abs_err: K = {ROWS_SUPERSTEP} at B = {ROWS_BATCH} (the "
             "bench's shape) against the plain version; bitwise its K = 1 "
             "there and on the 469-step epoch (phase_superstep)",
        batch=MAIN_BATCH, steps=EPOCH_STEPS, k1_ms=r1,
        main_path=f"launches: `{rows_bench}` (B > 128); at B <= 128 the "
                  f"bf16 superstep runs epoch_step_mma"))
    print("[timing] epoch_step_mma, epoch_step_bf16, epoch_step_superstep: no "
          "single PyTorch call computes an epoch of SGD, so library_ms is "
          "null")
    return out


# ---- slice 4: K6, the DP epoch kernel's ring, on a replica mesh of cuda:0 ----

RING_CASES = (("allgather", 2), ("allgather", 4), ("reduce_scatter", 3),
              ("reduce_scatter", 4))
RING_CHECK = (128, 24)       # per-replica batch, steps of the kernel checks
DP_FORMS = ("K2b", "K3", "K2c")   # uint8 rows; masks, threefry, core
DP_REPLICAS = 4
DP_BATCH = DP_REPLICAS * MAIN_BATCH        # the global batch, 512
DP_EPOCH_STEPS = 118         # 60,000 rows / 512, the last batch wrap-padded
DP_PALLAS_STEPS = 50
# K6 against its plain version over a 24-step epoch: losses at TRAIN_RTOL,
# not LOSS_RTOL. On one of these inputs (all-gather, n = 2, threefry) a
# ReLU input within rounding of 0 takes the other branch at step 20 in one
# of the two summation orders and the loss parts by 6.866e-05 (3.4e-05
# relative; seen on an H100). Two plain versions part by the same 6.866e-05
# on the CPU (f32 against f64 products, same inputs), and K6 is held
# BITWISE against K1 + the ring tree + SGD on every case, so this is the
# plain version's summation order, not the kernel. Params by PARAM_FRO_RTOL.
K6_LOSS_TOL = (TRAIN_RTOL, 1e-6)
RING_TPU_LINE = {"allgather": 769, "reduce_scatter": 702}
N_PARAMS = 784 * 128 + 128 + 128 * 128 + 128 + 128 * 10


def _dp_inputs(n: int, batch: int, nsteps: int, seed: int, device) -> dict:
    """n replicas' K2 inputs (rows, labels, masks, threefry key tables)
    from seeds seed..seed+n-1, one core seed, the same weights for all."""
    per = [_k2_inputs(batch, nsteps, seed + r, device) for r in range(n)]
    inp = {k: [p[k] for p in per] for k in ("uint8", "f32", "y", "masks",
                                             "threefry")}
    inp["params"] = [{name: {k: t.clone() for k, t in layer.items()}
                      for name, layer in per[0]["params"].items()}
                     for _ in range(n)]
    inp.update(core=per[0]["core"], batch=batch, n=n)
    return inp


def _dp_call(fn, form: str, inp: dict, ring: str, **kw):
    pixels, rng = K2_FORMS[form]
    return fn(inp["params"], inp[pixels], inp["y"],
              None if rng == "masks" else inp[rng], LR, inp["batch"],
              masks=inp["masks"] if rng == "masks" else None,
              rng_impl="threefry" if rng == "threefry" else "core",
              axis_size=inp["n"], ring=ring, **kw)


def _check_dp_case(tag, got, again, k1, ref, n, loss_tol, fro_tol,
                   rows=None):
    """K6's checks (a), (b), (e) bitwise, bitwise the rows design's ring
    `rows` where given, and (c) against its plain version; returns the
    worst absolute error against the plain version and prints the worst
    relative loss error."""
    worst = loss_rel = 0.0
    for r in range(n):
        mine = _k2_flat(got[0][r], got[1][r])
        yard = (_k2_flat(rows[0][r], rows[1][r]) if rows is not None
                else mine)
        for (name, a), (_, z), (_, b), (_, c), (_, d) in zip(
                mine, _k2_flat(got[0][0], got[1][r]),
                _k2_flat(again[0][r], again[1][r]),
                _k2_flat(k1[0][r], k1[1][r]), yard):
            if not torch.equal(a, z):
                fail(f"{tag}: replica {r}'s {name} differs from replica 0's "
                     f"(the replicas must stay bitwise in lockstep)")
            if not torch.equal(a, b):
                fail(f"{tag}: replica {r}'s {name} differs between two "
                     f"launches on the same inputs")
            if not torch.equal(a, c):
                fail(f"{tag}: replica {r}'s {name} differs from K1 per "
                     f"replica + the ring's summation tree + SGD by "
                     f"{float((a - c).abs().max()):.3e} (bitwise expected)")
            if not torch.equal(a, d):
                fail(f"{tag}: replica {r}'s {name} differs from the rows "
                     f"design's ring by {float((a - d).abs().max()):.3e} "
                     f"(bitwise expected)")
        for (name, a), (_, p) in zip(mine, _k2_flat(ref[0][r], ref[1][r])):
            if a.shape != p.shape or not torch.isfinite(a).all():
                fail(f"{tag}: {name} shape or non-finite values")
            diff = (a - p).abs()
            if name == "losses":
                rtol, atol = loss_tol
                if not bool((diff <= atol + rtol * p.abs()).all()):
                    fail(f"{tag}: replica {r}'s losses off the plain version "
                         f"by {float(diff.max()):.3e} (rtol {rtol}, atol "
                         f"{atol})")
                loss_rel = max(loss_rel, float((diff / p.abs()).max()))
            else:
                fro = float(diff.norm() / p.norm())
                if fro > fro_tol:
                    fail(f"{tag}: {name} off its plain version by {fro:.3e} "
                         f"in relative Frobenius norm (limit {fro_tol})")
            worst = max(worst, float(diff.max()))
    print(f"[kernels] {tag}: losses' worst relative error against the plain "
          f"version {loss_rel:.3e} (rtol {loss_tol[0]})")
    return worst


# (batch, steps) of K6's checks: RING_CHECK, and the main path's ragged
# and a small per-replica batch
K6_CHECKS = (RING_CHECK, (96, 6), (8, 5))


def phase_kernels_k6(device) -> dict:
    """K6 in the masks, threefry and core forms (uint8 rows, f32) at
    (all-gather, n = 2, 4) and (reduce-scatter, n = 3, 4), at B = 128 x 24
    steps, 96 x 6 and 8 x 5 per replica, on K6-ws (the design ring_design
    picks, asserted) and on the rows design's ring forced: (a) every
    replica's weights bitwise equal; (b) bitwise K1 per replica + the
    ring's summation tree as torch adds on the card + SGD, step by step;
    (c) against epoch_dp_sgd_reference (losses K6_LOSS_TOL, params
    PARAM_FRO_RTOL); (e) a repeat launch bitwise, on each design; K6-ws
    bitwise the rows design's ring. Then (d) a 1-replica ring launch of
    each design bitwise K2 (K6-mma's bitwise K2-mma), the in-kernel masks
    of each replica bitwise the plain streams, the bf16 mode
    (`phase_kernels_k6_mma`: K6-mma, and the rows design's ring forced),
    and a stalled ring of each design (K6-ws, K6-mma, rows) ending in
    RingTimeoutError naming hop 0 and the design. Returns the worst
    absolute error against the plain version per ring, K6-mma's per ring
    and the rows design's bf16 ring's."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step
    worst = {"allgather": 0.0, "reduce_scatter": 0.0}
    batch, nsteps = RING_CHECK
    for ring, n in RING_CASES:
        inp = _dp_inputs(n, batch, nsteps, seed=20 + 10 * n, device=device)
        for r in range(n):
            for step in (0, nsteps - 1):
                for impl, src in (("core", inp["core"]),
                                  ("threefry", inp["threefry"][r])):
                    km = epoch_step.kernel_mask_block(
                        src, step, batch, rng_impl=impl, device=device,
                        replica=r)
                    pm = epoch_step.step_mask(impl, src, None, step, batch,
                                              device, replica=r)
                    if not torch.equal(km, pm):
                        fail(f"K6 {ring} n={n}: replica {r}'s in-kernel "
                             f"{impl} mask of step {step} differs from the "
                             f"plain stream")
        for batch_c, nsteps_c in K6_CHECKS:
            inp = _dp_inputs(n, batch_c, nsteps_c, seed=20 + 10 * n + batch_c,
                             device=device)
            for form in DP_FORMS:
                tag = (f"epoch_step_dp_ws_{ring} n={n} {form} B={batch_c} "
                       f"S={nsteps_c}")
                t0 = time.perf_counter()
                got = _dp_call(epoch_step.epoch_fused_sgd, form, inp, ring)
                ll = dict(epoch_step.last_launch)
                cols = epoch_step.ring_ws_cols(n)
                if (ll["design"], ll["replicas"], ll["ring"], ll["form"],
                        ll["cols"], ll["blocks"]) != (
                        "ws", n, ring, "/".join(K2_FORMS[form]), cols,
                        128 // cols):
                    fail(f"{tag}: launched {ll}")
                again = _dp_call(epoch_step.epoch_fused_sgd, form, inp, ring)
                rows = _dp_call(epoch_step.epoch_fused_sgd, form, inp, ring,
                                _design="rows")
                if epoch_step.last_launch["design"] != "rows":
                    fail(f"{tag}: _design='rows' launched "
                         f"{epoch_step.last_launch}")
                rows_again = _dp_call(epoch_step.epoch_fused_sgd, form, inp,
                                      ring, _design="rows")
                k1 = _dp_call(epoch_step.epoch_dp_sgd_reference, form, inp,
                              ring, step_fn=fused_step.fused_loss_and_grads)
                ref = _dp_call(epoch_step.epoch_dp_sgd_reference, form, inp,
                               ring)
                torch.cuda.synchronize()
                err = _check_dp_case(tag, got, again, k1, ref, n, K6_LOSS_TOL,
                                     PARAM_FRO_RTOL, rows=rows)
                _check_dp_case(f"epoch_step_dp_{ring} (rows design) n={n} "
                               f"{form} B={batch_c} S={nsteps_c}", rows,
                               rows_again, k1, ref, n, K6_LOSS_TOL,
                               PARAM_FRO_RTOL)
                worst[ring] = max(worst[ring], err)
                print(f"[kernels] {tag}: final loss of replica 0 "
                      f"{float(got[1][0][-1]):.7f} vs plain "
                      f"{float(ref[1][0][-1]):.7f}; worst abs err {err:.3e}; "
                      f"K6-ws ({ll['blocks']} blocks of {cols} units per "
                      f"replica) and the rows design's ring "
                      f"({epoch_step.last_launch['blocks']} blocks per "
                      f"replica): each in lockstep, bitwise K1 + ring tree "
                      f"+ SGD and a repeat launch, and bitwise each other "
                      f"({time.perf_counter() - t0:.1f}s)")

    # (d) one replica: either design's ring kernel is K2 bit for bit
    inp = _k2_inputs(batch, nsteps, seed=7, device=device)
    for form in DP_FORMS:
        pixels, rng = K2_FORMS[form]
        serial = _k2_flat(*_k2_call(epoch_step.epoch_fused_sgd, form, inp))
        for design in ("ws", "rows"):
            ps, ls = epoch_step._ring_cuda(
                [inp["params"]], [inp[pixels]], [inp["y"]], [inp.get(rng)],
                [inp["masks"] if rng == "masks" else None], LR, batch, rng,
                nsteps, False, "allgather", 0, design=design)
            for (name, a), (_, b) in zip(_k2_flat(ps[0], ls[0]), serial):
                if not torch.equal(a, b):
                    fail(f"K6 n=1 {design} {form}: {name} differs from K2 by "
                         f"{float((a - b).abs().max()):.3e} (bitwise "
                         f"expected)")
        bf16 = _k2_flat(*_k2_call(partial(epoch_step.epoch_fused_sgd,
                                          compute_bf16=True), form, inp))
        if epoch_step.last_launch["design"] != "mma":
            fail(f"K2 bf16 {form}: launched {epoch_step.last_launch}")
        ps, ls = epoch_step._ring_cuda(
            [inp["params"]], [inp[pixels]], [inp["y"]], [inp.get(rng)],
            [inp["masks"] if rng == "masks" else None], LR, batch, rng,
            nsteps, True, "allgather", 0, design="mma")
        for (name, a), (_, b) in zip(_k2_flat(ps[0], ls[0]), bf16):
            if not torch.equal(a, b):
                fail(f"K6 n=1 mma {form}: {name} differs from K2-mma by "
                     f"{float((a - b).abs().max()):.3e} (bitwise expected)")
    print(f"[kernels] epoch_step_dp n=1 (one replica's ring launch, K6-ws "
          f"and the rows design; K6-mma in bf16) bitwise equal to K2 (K2-mma)"
          f" in forms {', '.join(DP_FORMS)} at B={batch} S={nsteps}")

    # bf16: K6-mma, and the rows design's ring in the bf16 mode forced
    worst.update(phase_kernels_k6_mma(device))

    for design in ("ws", "mma", "rows"):
        for ring in ("allgather", "reduce_scatter"):
            t0 = time.perf_counter()
            e = epoch_step.stalled_ring(device, n=2, ring=ring, design=design)
            if "hop 0" not in str(e) or f"({design} design)" not in str(e):
                fail(f"a stalled {ring} ring of the {design} design raised "
                     f"{e!r}")
            print(f"[kernels] stalled {ring} ring, {design} design (replica 0 "
                  f"never signals hop 0): {type(e).__name__} after "
                  f"{time.perf_counter() - t0:.2f}s: {e}")
    return worst


# K6-mma's checks: both rings at n = 2..RING_MMA_MAX_REPLICAS, at K6_CHECKS
MMA_RING_CASES = tuple((ring, n) for ring in ("allgather", "reduce_scatter")
                       for n in (2, 3, 4))


def _check_bf16_pins(tag, got, other, n, what) -> float:
    """`got` against `other` (n replicas' params and losses) at the JAX
    bf16 pins: losses BF16_LOSS_RTOL / BF16_LOSS_ATOL, each param in
    relative Frobenius norm BF16_PARAM_FRO_RTOL; returns the worst absolute
    difference."""
    worst = 0.0
    for r in range(n):
        for (name, a), (_, p) in zip(_k2_flat(got[0][r], got[1][r]),
                                     _k2_flat(other[0][r], other[1][r])):
            diff = (a - p).abs()
            if name == "losses":
                if not bool((diff <= BF16_LOSS_ATOL
                             + BF16_LOSS_RTOL * p.abs()).all()):
                    fail(f"{tag}: replica {r}'s losses off {what} by "
                         f"{float(diff.max()):.3e} (rtol {BF16_LOSS_RTOL}, "
                         f"atol {BF16_LOSS_ATOL})")
            else:
                fro = float(diff.norm() / p.norm())
                if fro > BF16_PARAM_FRO_RTOL:
                    fail(f"{tag}: {name} off {what} by {fro:.3e} in relative "
                         f"Frobenius norm (limit {BF16_PARAM_FRO_RTOL})")
            worst = max(worst, float(diff.max()))
    return worst


def phase_kernels_k6_mma(device) -> dict:
    """K6 in the bf16 mode: K6-mma (the design ring_design picks, asserted)
    in the masks, threefry and core forms at (all-gather, reduce-scatter) x
    n = 2, 3, 4, at B = 128 x 24 steps, 96 x 6 and 8 x 5 per replica: (a)
    every replica's weights bitwise equal; (b) bitwise K1-mma per replica +
    the ring's summation tree as torch adds on the card + SGD, step by step;
    (e) a repeat launch bitwise; within the JAX bf16 pins of the plain
    version (epoch_dp_sgd_reference with compute_bf16) and of the rows
    design's ring in the bf16 mode forced on the same inputs (the tensor
    cores sum in their own order). The rows design's ring stays bitwise its
    own step (the rows design's K1-bf16) + the tree + SGD, at n = 2 and 4.
    Returns the worst absolute error against the plain version per ring
    (`mma_<ring>`) and the rows design's bf16 ring's (`bf16`)."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step, fused_step
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    step_mma = lambda p, x, y, m: fused_step.fused_loss_and_grads(  # noqa: E731
        p, x.to(torch.bfloat16), y, m)
    step_rows = lambda p, x, y, m: fused_step.fused_loss_and_grads(  # noqa: E731
        p, x.to(torch.bfloat16), y, m, _design="rows")
    worst = {"mma_allgather": 0.0, "mma_reduce_scatter": 0.0, "bf16": 0.0}
    for ring, n in MMA_RING_CASES:
        for batch_c, nsteps_c in K6_CHECKS:
            inp = _dp_inputs(n, batch_c, nsteps_c,
                             seed=40 + 10 * n + batch_c, device=device)
            for form in DP_FORMS:
                tag = (f"epoch_step_dp_mma_{ring} n={n} {form} B={batch_c} "
                       f"S={nsteps_c}")
                t0 = time.perf_counter()
                got = _dp_call(kernel, form, inp, ring)
                ll = dict(epoch_step.last_launch)
                if (ll["design"], ll["replicas"], ll["ring"], ll["form"],
                        ll["bf16"], ll["blocks"]) != (
                        "mma", n, ring, "/".join(K2_FORMS[form]), True,
                        epoch_step.RING_MMA_BLOCKS):
                    fail(f"{tag}: launched {ll}")
                again = _dp_call(kernel, form, inp, ring)
                rows = _dp_call(kernel, form, inp, ring, _design="rows")
                if epoch_step.last_launch["design"] != "rows":
                    fail(f"{tag}: _design='rows' launched "
                         f"{epoch_step.last_launch}")
                k1 = _dp_call(epoch_step.epoch_dp_sgd_reference, form, inp,
                              ring, step_fn=step_mma)
                ref = _dp_call(epoch_step.epoch_dp_sgd_reference, form, inp,
                               ring, compute_bf16=True)
                torch.cuda.synchronize()
                err = _check_dp_case(tag, got, again, k1, ref, n,
                                     (BF16_LOSS_RTOL, BF16_LOSS_ATOL),
                                     BF16_PARAM_FRO_RTOL)
                rows_err = _check_bf16_pins(tag, got, rows, n,
                                            "the rows design's bf16 ring")
                worst[f"mma_{ring}"] = max(worst[f"mma_{ring}"], err)
                line = (f"[kernels] {tag}: final loss of replica 0 "
                        f"{float(got[1][0][-1]):.7f} vs plain "
                        f"{float(ref[1][0][-1]):.7f}; worst abs err {err:.3e} "
                        f"(plain), {rows_err:.3e} (the rows ring's bf16 "
                        f"form); {ll['blocks']} blocks per replica, in "
                        f"lockstep, bitwise K1-mma + ring tree + SGD and a "
                        f"repeat launch")
                if form == "K2c" and batch_c == RING_CHECK[0] and n in (2, 4):
                    # the rows design's ring: bitwise its own bf16 step
                    k1_rows = _dp_call(epoch_step.epoch_dp_sgd_reference,
                                       form, inp, ring, step_fn=step_rows)
                    rows_again = _dp_call(kernel, form, inp, ring,
                                          _design="rows")
                    worst["bf16"] = max(worst["bf16"], _check_dp_case(
                        f"epoch_step_dp_{ring}_bf16 (rows design) n={n} "
                        f"{form} B={batch_c} S={nsteps_c}", rows, rows_again,
                        k1_rows, ref, n, (BF16_LOSS_RTOL, BF16_LOSS_ATOL),
                        BF16_PARAM_FRO_RTOL))
                    line += ("; the rows ring's bf16 form bitwise the rows "
                             "design's K1-bf16 + ring tree + SGD")
                print(f"{line} ({time.perf_counter() - t0:.1f}s)")
    return worst


def _dp_fit(device, mesh, tmp: str, *, kernel: str, impl: str, ring: str,
            limit: int = 0, dtype: str = "float32", batch: int = DP_BATCH):
    """fit_cached over `mesh` (the function `--parallel --cached` calls):
    one epoch of synthetic MNIST at the global batch `batch`, full 10k
    eval, weights and keys from seeds. Returns (per-step losses, the
    reference epoch lines, the final params)."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import get_mnist, normalize_images
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import threefry
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import scan
    path = os.path.join(tmp, "no_mnist_here")
    with contextlib.redirect_stdout(io.StringIO()):
        train = get_mnist(path, train=True)
        test = get_mnist(path, train=False)
    images, labels = train.images, train.labels
    if limit:
        images, labels = images[:limit], labels[:limit]
    model = MLP(torch.Generator().manual_seed(0)).to(device)
    lines = []
    _, history = scan.fit_cached(
        model, threefry.key_data(1), images, labels.astype(np.int32),
        ShardedSampler(len(images), seed=42), normalize_images(test.images),
        test.labels.astype(np.int32), epochs=1, batch_size=batch, lr=LR,
        kernel=kernel, impl=impl, dtype=dtype, mesh=mesh, ring=ring,
        log=lines.append)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return history[0], lines, {n: {k: v.detach().cpu() for k, v in l.items()}
                               for n, l in model.params().items()}


# the DP epochs that reach the rows design's rings: a batch of ROWS_BATCH
# per replica (past WS_MAX_BATCH and MMA_MAX_BATCH), in f32 and in bf16;
# each cut to DP_ROWS_STEPS steps
DP_ROWS_STEPS = 20


def phase_main_dp(device, tmp: str) -> dict:
    """The DP paths at full width on a 4-replica mesh of cuda:0, each held
    against the same run on a 4-replica CPU mesh (plain versions, the same
    masks): one 118-step epoch through K6-ws (all-gather, threefry masks)
    and one through its reduce-scatter ring (core masks), and the same two
    in bf16 through K6-mma; 20 steps at 256 rows per replica through the
    rows design's rings (all-gather and reduce-scatter, f32; all-gather in
    bf16); then 50 steps of `--kernel pallas` (K1 keyed per
    replica: K1-split in f32, K1-mma in bf16, the bf16 runs held at the
    bf16 limits); then `train --parallel --cached --kernel pallas_epoch`
    through the CLI on the 1-card mesh, equal to the serial run. Returns
    the launch counts of each path."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import data_parallel_mesh
    mesh = data_parallel_mesh([device] * DP_REPLICAS)
    cpu_mesh = data_parallel_mesh(["cpu"] * DP_REPLICAS)
    cpu = torch.device("cpu")
    out = {}
    per_step = DP_PALLAS_STEPS * DP_REPLICAS
    rows_batch = DP_REPLICAS * ROWS_BATCH
    runs = (("allgather", "threefry2x32", "pallas_epoch", 0, "float32",
             DP_BATCH, "ws", {"epoch_step_dp_ws_allgather": 1}),
            ("reduce_scatter", "rbg", "pallas_epoch", 0, "float32", DP_BATCH,
             "ws", {"epoch_step_dp_ws_reduce_scatter": 1}),
            ("allgather", "threefry2x32", "pallas_epoch",
             DP_ROWS_STEPS * rows_batch, "float32", rows_batch, "rows",
             {"epoch_step_dp_allgather": 1}),
            ("reduce_scatter", "rbg", "pallas_epoch",
             DP_ROWS_STEPS * rows_batch, "float32", rows_batch, "rows",
             {"epoch_step_dp_reduce_scatter": 1}),
            ("allgather", "threefry2x32", "pallas_epoch", 0, "bfloat16",
             DP_BATCH, "mma", {"epoch_step_dp_mma_allgather": 1}),
            ("reduce_scatter", "rbg", "pallas_epoch", 0, "bfloat16",
             DP_BATCH, "mma", {"epoch_step_dp_mma_reduce_scatter": 1}),
            ("allgather", "threefry2x32", "pallas_epoch",
             DP_ROWS_STEPS * rows_batch, "bfloat16", rows_batch, "rows",
             {"epoch_step_dp_allgather_bf16": 1}),
            ("auto", "threefry2x32", "pallas", DP_PALLAS_STEPS * DP_BATCH,
             "float32", DP_BATCH, None,
             {"fused_split_keyed": per_step}),
            ("auto", "threefry2x32", "pallas", DP_PALLAS_STEPS * DP_BATCH,
             "bfloat16", DP_BATCH, None,
             {"fused_mma_keyed": per_step}))
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    for ring, impl, kernel, limit, dtype, batch, design, want in runs:
        what = (f"fit_cached(mesh=[cuda:0] x {DP_REPLICAS}, kernel={kernel}, "
                f"impl={impl}, ring={ring}, dtype={dtype}, batch_size="
                f"{batch})")
        bf16 = dtype == "bfloat16"
        loss_rtol = BF16_TRAIN_RTOL if bf16 else TRAIN_RTOL
        fro_rtol = BF16_PARAM_FRO_RTOL if bf16 else PARAM_FRO_RTOL
        _reset_counts()
        t0 = time.perf_counter()
        losses, lines, params = _dp_fit(device, mesh, tmp, kernel=kernel,
                                        impl=impl, ring=ring, limit=limit,
                                        dtype=dtype, batch=batch)
        wall = time.perf_counter() - t0
        launches = _counts()
        ll = dict(epoch_step.last_launch)
        if design is not None and (ll["design"], ll["replicas"]) != (
                design, DP_REPLICAS):
            fail(f"{what}: its K6 launch ran {ll}, expected the {design} "
                 f"design on {DP_REPLICAS} replicas")
        for line in lines:
            print(f"[main]   {line}")
        steps = limit // batch if limit else DP_EPOCH_STEPS
        if not (lines and re.search(r"^Epoch=0, train_loss=[-0-9.e]+, "
                                    r"val_loss=[-0-9.e]+  \[mean_train=",
                                    lines[0])):
            fail(f"{what}: no reference epoch line")
        if losses.shape != (steps,) or not np.isfinite(losses).all():
            fail(f"{what}: per-step losses shape {losses.shape}, finite "
                 f"{bool(np.isfinite(losses).all())}")
        if not losses[-10:].mean() < losses[:10].mean():
            fail(f"{what}: losses are not falling")
        expect_launches(launches, want, what)
        _reset_counts()
        cpu_losses, _, cpu_params = _dp_fit(cpu, cpu_mesh, tmp, kernel=kernel,
                                            impl=impl, ring=ring, limit=limit,
                                            dtype=dtype, batch=batch)
        expect_launches(_counts(), {}, f"{what} on the CPU mesh")
        rel = np.abs(losses - cpu_losses) / np.abs(cpu_losses)
        if not (rel <= loss_rtol).all():
            fail(f"{what}: per-step losses off the CPU mesh's by up to "
                 f"{rel.max():.3e} (rtol {loss_rtol})")
        fro = max(float((params[n][k] - cpu_params[n][k]).norm()
                        / cpu_params[n][k].norm())
                  for n in params for k in params[n])
        if fro > fro_rtol:
            fail(f"{what}: params off the CPU mesh's by {fro:.3e} in "
                 f"relative Frobenius norm (limit {fro_rtol})")
        print(f"[main] {what}: {steps} steps of {DP_REPLICAS} x "
              f"{batch // DP_REPLICAS} rows in {wall:.2f}s (wall, upload and eval included); loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; vs the CPU "
              f"mesh: losses worst rel diff {rel.max():.3e} (rtol "
              f"{loss_rtol}), params worst relative Frobenius {fro:.3e} "
              f"(limit {fro_rtol})")
        out[f"fit_cached {kernel} {ring} {dtype} {batch}"] = launches

    argv = _cached_argv(tmp, "--kernel", "pallas_epoch", "--n_epochs", "1",
                        "--checkpoint", "")
    _, serial, _ = _run_trainer(cli_train, argv)
    _reset_counts()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _, parallel, pout = _run_trainer(cli_train, argv + ["--parallel"])
    launches = _counts()
    if "parallel=1x128" not in pout or "ring (K6)" not in err.getvalue():
        fail(f"train --parallel: banner or note missing: {err.getvalue()!r}")
    expect_launches(launches, {"epoch_step_ws": 1},
                    "train --parallel --cached --kernel pallas_epoch on the "
                    "1-card mesh (the serial kernel, K2-ws: no ring)")
    if not all(np.array_equal(a, b) for a, b in zip(serial, parallel)):
        fail("train --parallel on the 1-card mesh differs from the serial run")
    print("[main] train --parallel --cached --kernel pallas_epoch on the "
          "1-card mesh: bitwise the serial run's losses; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    out["train --parallel --cached"] = launches
    return out


# ---- the process-level world: ranks spawned on cuda:0 ----

WORLD_SIZES = (2, 4)
WORLD_STEPS = DP_PALLAS_STEPS     # the lockstep runs' steps
WORLD_LIMIT_S = 180               # each spawned world's own time limit
WORLD_EPOCH_STEPS = {2: 235, 4: 118}   # 60,000 rows / (n x 128), padded
# launcher variables a spawned rank must not inherit
_LAUNCHER_VARS = ("SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK",
                  "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE", "RANK",
                  "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_VARS}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn(cmds, cwd: str, *, expect_ok: bool = True) -> list:
    """Run the (argv, env) pairs in `cmds` together, each in a session of
    its own; kill every session on the first failure (with expect_ok) or
    at WORLD_LIMIT_S. Retries on a port race only. Returns [(rc, out,
    err)]."""
    import signal
    for attempt in range(3):
        procs, files = [], []
        for argv, env in cmds(attempt):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                          stdout=out, stderr=err,
                                          start_new_session=True))
        deadline = time.monotonic() + WORLD_LIMIT_S
        try:
            while any(p.poll() is None for p in procs):
                failed = any(p.returncode not in (None, 0) for p in procs)
                if time.monotonic() > deadline or (failed and expect_ok):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        res = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            res.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
        blob = "".join(e for _, _, e in res)
        if not ("Address already in use" in blob or "EADDRINUSE" in blob):
            break
    if expect_ok:
        for r, (rc, out, err) in enumerate(res):
            if rc != 0:
                fail(f"spawned process {r} of {len(res)} exited {rc}:\n"
                     f"{out[-3000:]}\n{err[-3000:]}")
    return res


def _env_world(n: int, argv: list, **extra):
    """The (argv, env) pairs of an n-rank world under the env wireup."""
    def cmds(attempt):
        port = _free_port()
        return [(argv, _rank_env(RANK=r, WORLD_SIZE=n, LOCAL_RANK=r,
                                 LOCAL_WORLD_SIZE=n, MASTER_ADDR="127.0.0.1",
                                 MASTER_PORT=port, **extra))
                for r in range(n)]
    return cmds


def _torchrun(n: int, argv: list):
    """torchrun --standalone --nproc_per_node n (torch.distributed.run, the
    reference's launch line) of `argv`."""
    return lambda attempt: [([sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc_per_node", str(n),
                              *argv], _rank_env())]


def _main_data(n_rows: int = 60000):
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                         synthetic_mnist)
    split = synthetic_mnist(n_rows, seed=0)
    return normalize_images(split.images), split.labels.astype(np.int32)


def _world_rows(n: int) -> list:
    """Each rank's sampler shard of epoch 0 (60,000 rows over n ranks)."""
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    out = []
    for r in range(n):
        s = ShardedSampler(60000, num_replicas=n, rank=r, seed=42)
        s.set_epoch(0)
        out.append(s.indices())
    return out


def _world_train(step, x_all, y_all, rows_of_step, device, barrier=None):
    """WORLD_STEPS steps of the KeyedStep `step` from MLP.from_seed(0) and
    key 1, the batches and the steps' key table uploaded first, as `fit`
    builds an epoch's. Returns (losses, final params on the CPU, ms a step
    after the first 10)."""
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import threefry
    xs = [torch.from_numpy(x_all[rows_of_step(s)]).to(device)
          for s in range(WORLD_STEPS)]
    ys = [torch.from_numpy(y_all[rows_of_step(s)]).to(device)
          for s in range(WORLD_STEPS)]
    model = MLP.from_seed(0).to(device)
    _, table = step.key_table(threefry.key_data(1), WORLD_STEPS, device)
    losses = []
    torch.cuda.synchronize()
    if barrier:
        barrier()
    for s in range(WORLD_STEPS):
        if s == 10:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step.run(model, table[s], xs[s], ys[s]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (WORLD_STEPS - 10) * 1e3
    return (torch.stack(losses).cpu(),
            {n: {k: v.detach().cpu() for k, v in l.items()}
             for n, l in model.params().items()}, ms)


def world_rank_lockstep(out: str) -> None:
    """A rank of phase_main_world (a): WORLD_STEPS steps of `--kernel
    pallas` at MAIN_BATCH rows a rank through make_pallas_dp_train_step on
    a WorldMesh, in f32 (K1-split) and bf16 (K1-mma). Each step's
    `world_mean` call is timed between two device syncs (the exchange:
    staging, the all-gather with its wait for the slowest rank, the
    ordered sum); gloo's staging syncs the step there anyway. Saves each
    dtype's losses, params, launches and times to out/rank<r>_<dtype>.pt."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    from pytorch_ddp_mnist_tpu_torch.parallel import ddp
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import WorldMesh
    from pytorch_ddp_mnist_tpu_torch.parallel.wireup import initialize_runtime
    rt = initialize_runtime("env", device_type="cuda")
    mesh = WorldMesh([rt.device], world_size=rt.size, rank=rt.rank)
    x_all, y_all = _main_data()
    rows = _world_rows(rt.size)[rt.rank]
    world_mean, spent = ddp.world_mean, []

    def timed_mean(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = world_mean(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    ddp.world_mean = timed_mean
    for dtype in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats(rt.device)
        _reset_counts()
        spent.clear()
        step = fused_step.make_pallas_dp_train_step(mesh, LR, dtype=dtype)
        losses, params, step_ms = _world_train(
            step, x_all, y_all,
            lambda s: rows[s * MAIN_BATCH:(s + 1) * MAIN_BATCH], rt.device,
            rt.barrier)
        launches = _counts()
        exchange_ms = sum(spent[10:]) / (WORLD_STEPS - 10) * 1e3
        torch.save({"losses": losses, "params": params, "launches": launches,
                    "step_ms": step_ms, "exchange_ms": exchange_ms,
                    "backend": rt.backend, "device": str(rt.device),
                    "peak_mib": torch.cuda.max_memory_allocated(rt.device)
                    / 2**20},
                   os.path.join(out, f"rank{rt.rank}_{dtype}.pt"))
    rt.finalize()


def world_rank_cli(out: str, argv: list) -> None:
    """A rank of a world driven through the trainer's entry point
    (`cli/train.py train`, what `python -m pytorch_ddp_mnist_tpu_torch
    train` calls): saves its per-step losses, final params, launches, CUDA
    graph captures and wall time to out/rank<RANK>.pt."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.train import graphs
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_counts()
    captures = graphs.counts["captures"]
    t0 = time.perf_counter()
    state, history = cli_train.train(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    torch.save({"losses": torch.from_numpy(history[0]),
                "launches": _counts(), "wall_s": wall, "key": state.key,
                "captures": graphs.counts["captures"] - captures,
                "params": {n: {k: v.detach().cpu() for k, v in l.items()}
                           for n, l in state.model.params().items()}},
               os.path.join(out, f"rank{os.environ['RANK']}.pt"))


def _expect_eager(run: dict, what: str) -> None:
    """A world rank keeps the eager loop: it captured no CUDA graph."""
    if run["captures"] != 0:
        fail(f"{what}: {run['captures']} CUDA graph captures; a world keeps "
             f"the eager loop")


def _equal_trees(a, b) -> bool:
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def _world_cli_argv(tmp: str, out: str, *train) -> list:
    return [os.path.join(REPO, "chip_smoke.py"), "--world-rank", "cli",
            "--out", out, "--", "--parallel", "--batch_size", str(MAIN_BATCH),
            "--lr", str(LR), "--seed", "0", "--n_epochs", "1",
            "--path", os.path.join(tmp, "no_mnist_here"), *train]


def _epoch_seconds(line: str, steps: int, global_batch: int) -> float:
    rate = float(re.search(r" ([0-9.]+) img/s", line).group(1))
    return steps * global_batch / rate


def phase_main_world(device, tmp: str, card: str) -> dict:
    """The process-level world: ranks spawned on cuda:0 over gloo (NCCL
    refuses two ranks on one card), each a process of its own.
      a. 2 and 4 ranks under the env wireup run WORLD_STEPS steps of
         `--kernel pallas` at MAIN_BATCH rows a rank through
         make_pallas_dp_train_step on a WorldMesh, f32 (K1-split) and bf16
         (K1-mma): every rank's losses and params bitwise equal, and
         bitwise the single-process n-replica mesh of this card fed the
         world's rows in rank order; each rank's step split into compute
         and exchange (`world_mean` alone);
      b. `train --parallel --wireup_method env` through torchrun
         --standalone --nproc_per_node 4 (and 2), one epoch of synthetic
         60k at 128 rows a rank, full eval: one Epoch=0 line, a checkpoint
         from rank 0 equal to every rank's final params, each rank's
         keyed K1-split launches one a step (no mask entry); the epoch's
         wall time;
      c. `train --parallel --cached --kernel pallas_rng` on 2 ranks, one
         epoch: K1-split's rng form a step (its device-seed form: a
         world's eager loop reads its keys from the key table too), ranks
         in lockstep;
      d. an NCCL world of 1 rank bitwise the serial `--parallel` run, and
         an NCCL request from 2 ranks on this card exiting by name.
    A world of any size, one rank too, keeps the eager loop: every rank
    of b, c and d captures no CUDA graph.
    Returns the launches of each world path, a rank's."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    from pytorch_ddp_mnist_tpu_torch.parallel.mesh import data_parallel_mesh
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
    paths = {}
    x_all, y_all = _main_data()
    t_phase = time.perf_counter()
    for n in WORLD_SIZES:
        out = tempfile.mkdtemp(dir=tmp)
        t0 = time.perf_counter()
        _spawn(_env_world(n, [sys.executable,
                              os.path.join(REPO, "chip_smoke.py"),
                              "--world-rank", "lockstep", "--out", out]), tmp)
        spawn_s = time.perf_counter() - t0
        shards = _world_rows(n)
        for dtype, key in (("float32", "fused_split_keyed"),
                           ("bfloat16", "fused_mma_keyed")):
            what = f"a world of {n} ranks, --kernel pallas, {dtype}"
            runs = [torch.load(os.path.join(out, f"rank{r}_{dtype}.pt"))
                    for r in range(n)]
            for r, run in enumerate(runs):
                expect_launches(run["launches"], {key: WORLD_STEPS},
                                f"{what}, rank {r}")
                if run["backend"] != "gloo" or run["device"] != "cuda:0":
                    fail(f"{what}, rank {r}: backend {run['backend']} on "
                         f"{run['device']}, expected gloo on cuda:0")
                if not (torch.equal(run["losses"], runs[0]["losses"])
                        and _equal_trees(run["params"], runs[0]["params"])):
                    fail(f"{what}: rank {r} is not in lockstep with rank 0")
            losses = runs[0]["losses"].numpy()
            if not (np.isfinite(losses).all()
                    and losses[-10:].mean() < losses[:10].mean()):
                fail(f"{what}: losses not finite and falling: {losses}")
            _reset_counts()
            mesh_losses, mesh_params, _ = _world_train(
                fused_step.make_pallas_dp_train_step(
                    data_parallel_mesh([device] * n), LR, dtype=dtype),
                x_all, y_all, lambda s: np.concatenate(
                    [sh[s * MAIN_BATCH:(s + 1) * MAIN_BATCH] for sh in shards]),
                device)
            expect_launches(_counts(), {key: n * WORLD_STEPS},
                            f"the {n}-replica mesh of cuda:0, {dtype}")
            if not (torch.equal(runs[0]["losses"], mesh_losses)
                    and _equal_trees(runs[0]["params"], mesh_params)):
                fail(f"{what}: not bitwise the single-process {n}-replica "
                     f"mesh on the world's rows")
            slow = max(runs, key=lambda r: r["step_ms"])
            step_ms, exch_ms = slow["step_ms"], slow["exchange_ms"]
            peak = max(r["peak_mib"] for r in runs)
            print(f"[main] {what}: ranks bitwise in lockstep and bitwise the "
                  f"{n}-replica mesh of cuda:0 on the world's rows; loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches a rank "
                  f"{ {k: v for k, v in runs[0]['launches'].items() if v} }")
            print(f"[timing] world step n={n} {dtype} (gloo, ranks on one "
                  f"card; slowest rank, steps 10-{WORLD_STEPS - 1}): "
                  f"{step_ms:.3f} ms a step = compute {step_ms - exch_ms:.3f} "
                  f"+ exchange {exch_ms:.3f} (world_mean in the step, between "
                  f"two syncs: the flat buffer through the host, gloo's "
                  f"all-gather with its wait for the slowest rank, the "
                  f"ordered sum on the card); peak device memory a rank "
                  f"{peak:.1f} MiB [{card}]")
            paths[f"world n={n} --kernel pallas {dtype}, a rank"] = \
                runs[0]["launches"]
        print(f"[main] the {n}-rank lockstep world took {spawn_s:.1f}s of "
              f"wall (process start, data and both dtypes)")

    walls = {}
    for n in (4, 2):
        out = tempfile.mkdtemp(dir=tmp)
        ckpt = os.path.join(out, "model.pt")
        res = _spawn(_torchrun(n, _world_cli_argv(
            tmp, out, "--wireup_method", "env", "--checkpoint", ckpt)), tmp)
        stdout = res[0][1]
        lines = [ln for ln in stdout.splitlines() if ln.startswith("Epoch=")]
        what = f"torchrun --standalone --nproc_per_node {n} ... train " \
               f"--parallel --wireup_method env"
        if len(lines) != 1 or not lines[0].startswith("Epoch=0, "):
            fail(f"{what}: epoch lines {lines}, expected one Epoch=0 line")
        if f"world={n} rank=0 backend=gloo" not in stdout:
            fail(f"{what}: no banner naming the world: {stdout[-2000:]}")
        steps = WORLD_EPOCH_STEPS[n]
        runs = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(n)]
        saved = load_checkpoint(ckpt)
        for r, run in enumerate(runs):
            expect_launches(run["launches"], {"fused_split_keyed": steps},
                            f"{what}, rank {r}")
            _expect_eager(run, f"{what}, rank {r}")
            if not (_equal_trees(run["params"], saved)
                    and torch.equal(run["losses"], runs[0]["losses"])):
                fail(f"{what}: rank {r}'s params or losses differ from the "
                     f"rank-0 checkpoint's")
        peaks = re.findall(r"peak device memory ([0-9.]+) MiB", res[0][2])
        walls[n] = (_epoch_seconds(lines[0], steps, n * MAIN_BATCH),
                    max(r["wall_s"] for r in runs))
        print(f"[main]   {lines[0]}")
        print(f"[main] {what}: one Epoch=0 line, from rank 0; the rank-0 "
              f"checkpoint equals every rank's final params; {steps} keyed "
              f"K1-split launches a rank, no mask entry; ranks' peak device "
              f"memory "
              f"{', '.join(peaks)} MiB")
        print(f"[timing] world epoch n={n} (torchrun, gloo, ranks on one "
              f"card, 128 rows a rank, {steps} steps, eval included): "
              f"{walls[n][0]:.3f} s (the epoch line's); the rank's whole "
              f"train() {walls[n][1]:.3f} s (data and start-up included) "
              f"[{card}]")
        paths[f"world n={n} train --parallel (torchrun), a rank"] = \
            runs[0]["launches"]

    # c and d together: none of them is timed, and the ranks of each are
    # processes of their own
    rng_out, nccl_out = tempfile.mkdtemp(dir=tmp), tempfile.mkdtemp(dir=tmp)
    limit = ["--limit", str(MAIN_STEPS * MAIN_BATCH), "--kernel", "pallas",
             "--checkpoint", ""]
    rng = _torchrun(2, _world_cli_argv(
        tmp, rng_out, "--wireup_method", "env", "--cached", "--kernel",
        "pallas_rng", "--checkpoint", ""))
    nccl = _env_world(1, [sys.executable, *_world_cli_argv(
        tmp, nccl_out, "--wireup_method", "env", *limit)])
    refused = [([sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
                 "--parallel", "--wireup_method", "nccl-mpich",
                 "--checkpoint", "", "--path",
                 os.path.join(tmp, "no_mnist_here")],
                _rank_env(PMI_RANK=r, PMI_SIZE=2)) for r in range(2)]
    t0 = time.perf_counter()
    res = _spawn(lambda attempt: rng(attempt) + nccl(attempt) + refused, tmp,
                 expect_ok=False)
    for what, (rc, o, e) in zip(("the cached pallas_rng world",
                                 "the 1-rank NCCL world"), res):
        if rc != 0:
            fail(f"{what} exited {rc}:\n{o[-3000:]}\n{e[-3000:]}")
    for r, (rc, o, e) in enumerate(res[2:]):
        if rc in (0, None, -9) or "2 ranks share this node's 1 card" not in e:
            fail(f"NCCL from 2 ranks on one card, rank {r}: rc {rc}, "
                 f"expected an exit by name: {e[-2000:]}")
    print(f"[main] c and d ran together in {time.perf_counter() - t0:.1f}s "
          f"(wall); NCCL asked for by 2 ranks on this card: each exited by "
          f"name")

    runs = [torch.load(os.path.join(rng_out, f"rank{r}.pt"))
            for r in range(2)]
    what = "train --parallel --cached --kernel pallas_rng on 2 ranks"
    for r, run in enumerate(runs):
        expect_launches(run["launches"],
                        {"fused_split_rng_dev": WORLD_EPOCH_STEPS[2]},
                        f"{what}, rank {r}")
        _expect_eager(run, f"{what}, rank {r}")
        if not (_equal_trees(run["params"], runs[0]["params"])
                and torch.equal(run["losses"], runs[0]["losses"])):
            fail(f"{what}: rank {r} is not in lockstep with rank 0")
    losses = runs[0]["losses"]
    if not losses[-20:].mean() < losses[:20].mean():
        fail(f"{what}: losses are not falling")
    print(f"[main] {what}: ranks in lockstep, {WORLD_EPOCH_STEPS[2]} "
          f"K1-split device-seed rng launches a rank, no mask drawn outside "
          f"the kernel, no graph captured")
    paths["world n=2 train --parallel --cached --kernel pallas_rng, a rank"] \
        = runs[0]["launches"]

    # NCCL: the world of one rank against the serial --parallel run
    if "world=1 rank=0 backend=nccl" not in res[1][1]:
        fail(f"the 1-rank env world did not form over NCCL: {res[1][1][-2000:]}")
    nccl = torch.load(os.path.join(nccl_out, "rank0.pt"))
    _, serial, _ = _run_trainer(cli_train, _world_cli_argv(tmp, nccl_out,
                                                           *limit)[6:])
    if not np.array_equal(serial[0], nccl["losses"].numpy()):
        fail("the NCCL world of 1 rank differs from the serial --parallel run")
    expect_launches(nccl["launches"], {"fused_split_keyed": MAIN_STEPS},
                    "the NCCL world of 1 rank")
    _expect_eager(nccl, "the NCCL world of 1 rank")
    paths["world n=1 NCCL train --parallel --kernel pallas"] = nccl["launches"]
    print("[main] an NCCL world of 1 rank: bitwise the serial --parallel "
          "run's losses, on the eager loop (no capture)")
    print(f"[main] the world phase took {time.perf_counter() - t_phase:.1f}s")
    return paths


def k6_bound(n: int, batch: int, nsteps: int, ring: str,
             peak: float = PEAK_F32_FLOPS):
    """(bound_ms, bound_by, flop, bytes) of one K6 epoch on n replicas,
    uint8 rows and threefry key tables: the n replicas' products at `peak`
    (the f32 peak; the bf16 one for the bf16 mode); bytes = each input read
    once (rows, labels, key tables, weights), each output written once (n
    weight sets, losses), plus the ring's hops, each hop's bytes written
    once by the sender and read once by the receiver (all-gather: n (n - 1)
    gradient blocks a step; reduce-scatter: 2 (n - 1) blocks a step, n
    replicas x 2 (n - 1) hops of a 1/n chunk)."""
    flops = n * nsteps * k1_bound(batch)[2]
    rows = n * nsteps * batch
    blocks = n * (n - 1) if ring == "allgather" else 2 * (n - 1)
    nbytes = rows * 784 + 4 * rows + 8 * n * nsteps + 2 * 4 * n * N_PARAMS \
        + 4 * n * nsteps + nsteps * blocks * 2 * 4 * N_PARAMS
    return _bound(flops, nbytes, peak)


# K6's designs in the profiler's jobs: (job design, the `_design` it
# forces, bf16 mode, the ring kernel's short name)
K6_PROFILED = (("rows", "rows", False, "ring_kernel"),
               ("ws", "ws", False, "ring_ws_kernel"),
               ("rowsbf16", "rows", True, "ring_kernel"),
               ("mma", "mma", True, "ring_mma_kernel"))


def k6_profile_jobs(device) -> dict:
    """profile_jobs' jobs for K6 at n = DP_REPLICAS, B = 128, the 118-step
    epoch, K3: each ring on the rows design and on K6-ws, in turns, and in
    the bf16 mode on the rows design and on K6-mma, in turns; three calls
    each, keeping the ring kernel."""
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    inp = _dp_inputs(DP_REPLICAS, MAIN_BATCH, DP_EPOCH_STEPS, seed=11,
                     device=device)
    jobs = {}
    for ring in ("allgather", "reduce_scatter"):
        for first, second in (K6_PROFILED[:2], K6_PROFILED[2:]):
            for label, (design, forced, bf16, kernel) in (
                    (first[0], first), (second[0], second),
                    (second[0] + "2", second), (first[0] + "2", first)):
                jobs[f"k6_{ring}_{label}"] = (
                    lambda ring=ring, forced=forced, bf16=bf16: _dp_call(
                        epoch_step.epoch_fused_sgd, "K3", inp, ring,
                        _design=forced, compute_bf16=bf16), 3, (kernel,))
    return jobs


def k6_device_us(prof: dict) -> dict:
    """{(ring, design): the ring kernel's least device time per call of
    its two turns in k6_profile_jobs, in us} from profile_jobs' first dict
    (missing where the profiler recorded no device time)."""
    out = {}
    for ring in ("allgather", "reduce_scatter"):
        for design, *_ in K6_PROFILED:
            times = [t for label in (f"k6_{ring}_{design}",
                                     f"k6_{ring}_{design}2")
                     for t in prof.get(label, {}).values()]
            if times:
                out[ring, design] = min(times)
    return out


def k6_times(device, card: str, prof=None) -> dict:
    """K6 per (ring, n) at B = 128 per replica over the 4-replica main
    path's 118-step epoch (uint8 rows, threefry): K6-ws and the rows
    design's ring in turns (rows, ws, ws, rows), with K2-ws alone at the
    same blocks and hidden units a block beside them (one replica's
    epoch: the ring's share reads as the difference), the rows-design K2
    and a 1-replica rows ring at the rows ring's blocks per replica, the
    plain version, and K6-ws's stamps split a step; the bf16 mode
    (`k6_mma_times`: K6-mma and the rows ring's bf16 form); the profiler's
    device time of the ring kernels at n = DP_REPLICAS, from `prof`
    (phase_profile's) or a session of its own. Returns {"cases": {"<ring>
    n=<n>": {...}}, "mma": k6_mma_times' cases}."""
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    cases = {}
    for ring, n in RING_CASES:
        inp = _dp_inputs(n, MAIN_BATCH, DP_EPOCH_STEPS, seed=11, device=device)
        ws = lambda: _dp_call(epoch_step.epoch_fused_sgd, "K3", inp, ring)  # noqa: E731
        rows = lambda: _dp_call(epoch_step.epoch_fused_sgd, "K3", inp, ring,  # noqa: E731
                                _design="rows")
        ws()
        G, cols = epoch_step.last_launch["blocks"], epoch_step.last_launch["cols"]
        rows()
        Gr = epoch_step.last_launch["blocks"]
        one = {k: inp[k][0] for k in ("params", "uint8", "y", "threefry")}
        one.update(masks=None, batch=MAIN_BATCH)
        k2ws = lambda: epoch_step._ws_cuda(  # noqa: E731
            one["params"], one["uint8"], one["y"], one["threefry"], LR,
            MAIN_BATCH, None, "threefry", DP_EPOCH_STEPS, 1, DP_EPOCH_STEPS,
            0, cols=cols)
        k2 = lambda: _k2_call(lambda *a, **k: epoch_step._epoch_fused_sgd_rows(  # noqa: E731
            *a, max_blocks=Gr, **k), "K3", one)
        ring1 = lambda: epoch_step._ring_cuda(  # noqa: E731
            [one["params"]], [one["uint8"]], [one["y"]], [one["threefry"]],
            [None], LR, MAIN_BATCH, "threefry", DP_EPOCH_STEPS, False,
            "allgather", Gr)
        plain = lambda: _dp_call(  # noqa: E731
            epoch_step.epoch_dp_sgd_reference, "K3", inp, ring)
        p1 = _time_ms(plain, iters=1, warmup=0)
        rows_ms, ws_ms, turns = _turns(rows, ws, iters=5, warmup=1)
        k2ws_ms = _time_ms(k2ws, iters=5, warmup=1)
        k2_ms = _time_ms(k2, iters=5, warmup=1)
        r1 = _time_ms(ring1, iters=5, warmup=1)
        p2 = _time_ms(plain, iters=1, warmup=0)
        _, _, split, per_step = _dp_call(epoch_step.k6_phase_stamps, "K3",
                                         inp, ring)
        bound = k6_bound(n, MAIN_BATCH, DP_EPOCH_STEPS, ring)
        cases[f"{ring} n={n}"] = {
            "ms": ws_ms, "us_per_step": ws_ms * 1e3 / DP_EPOCH_STEPS,
            "rows_ms": rows_ms,
            "rows_us_per_step": rows_ms * 1e3 / DP_EPOCH_STEPS,
            "plain_ms": min(p1, p2), "bound_ms": bound[0],
            "bound_by": bound[1], "flop": bound[2], "bytes": bound[3],
            "blocks_per_replica": G, "cols": cols,
            "k2_ws_same_blocks_ms": k2ws_ms,
            "ring_share_us_per_step": (ws_ms - k2ws_ms) * 1e3 / DP_EPOCH_STEPS,
            "rows_blocks_per_replica": Gr, "k2_rows_same_blocks_ms": k2_ms,
            "rows_ring_n1_same_blocks_ms": r1,
            "timed_in_turns_rows_ws_ws_rows": turns,
            "stamps_us_per_step": per_step, "stamps_split_us": split}
        print(f"[timing] epoch_step_dp_ws_{ring} n={n} B={MAIN_BATCH} "
              f"S={DP_EPOCH_STEPS} ({G} blocks of {cols} units per replica): "
              f"{ws_ms:.3f} ms per epoch launch, "
              f"{ws_ms * 1e3 / DP_EPOCH_STEPS:.2f} us a step; the rows "
              f"design's ring ({Gr} blocks per replica) {rows_ms:.3f} ms "
              f"({rows_ms / ws_ms:.2f}x); K2-ws alone at {G} blocks of {cols} "
              f"units {k2ws_ms:.3f} ms, so the ring adds "
              f"{(ws_ms - k2ws_ms) * 1e3 / DP_EPOCH_STEPS:.2f} us a step; the "
              f"rows-design K2 at {Gr} blocks {k2_ms:.3f} ms, one replica's "
              f"rows ring {r1:.3f} ms; plain {min(p1, p2):.1f} ms; bound "
              f"{bound[0]:.4f} ms by {bound[1]} (turns rows, ws, ws, rows: "
              f"{', '.join(f'{v:.3f}' for v in turns)}) [{card}]")
        print(f"[timing] epoch_step_dp_ws_{ring} n={n} phase split (stamps "
              f"build, block 0 of replica 0, mean over the steps): "
              f"{per_step:.2f} us a step [{card}]")
        for phase, us in split.items():
            print(f"[timing]   {phase:46s} {us:8.3f} us  {us / per_step:6.1%}")
    # the rows ring's split of the card at n = 4: fewer blocks per replica
    # than the co-resident 66, in turns with 66
    inp = _dp_inputs(DP_REPLICAS, MAIN_BATCH, DP_EPOCH_STEPS, seed=11,
                     device=device)
    for ring in ("allgather", "reduce_scatter"):
        c = cases[f"{ring} n={DP_REPLICAS}"]
        split = {}
        for g in (33, 44):
            fewer = lambda: _dp_call(epoch_step.epoch_fused_sgd, "K3", inp,  # noqa: E731
                                     ring, max_blocks=g, _design="rows")
            full = lambda: _dp_call(epoch_step.epoch_fused_sgd, "K3", inp,  # noqa: E731
                                    ring, _design="rows")
            split[g], split[c["rows_blocks_per_replica"]], _ = _turns(
                fewer, full, iters=5, warmup=1)
        c["rows_ms_by_blocks_per_replica"] = split
        print(f"[timing] epoch_step_dp_{ring} (rows design) n={DP_REPLICAS}: "
              f"ms per epoch launch by blocks per replica "
              f"{ {g: round(v, 3) for g, v in sorted(split.items())} } "
              f"[{card}]")
    mma = k6_mma_times(device, card)
    if prof is None:
        prof, _ = profile_jobs(k6_profile_jobs(device))
    dev_us = k6_device_us(prof)
    for ring in ("allgather", "reduce_scatter"):
        c = cases[f"{ring} n={DP_REPLICAS}"]
        ws_us, rows_us = dev_us.get((ring, "ws")), dev_us.get((ring, "rows"))
        c["device_us"] = ws_us
        c["rows_device_us"] = rows_us
        if ws_us is None or rows_us is None:
            print(f"[timing] epoch_step_dp_ws_{ring} n={DP_REPLICAS}: the "
                  f"profiler recorded no device time (not measured)")
            continue
        print(f"[timing] epoch_step_dp_ws_{ring} n={DP_REPLICAS}: device time "
              f"(profiler, in turns rows, ws, ws, rows) {ws_us:.1f} us a "
              f"launch against the rows design's {rows_us:.1f} "
              f"({rows_us / ws_us:.2f}x) [{card}]")
    for ring in ("allgather", "reduce_scatter"):
        c = mma[f"{ring} n={DP_REPLICAS}"]
        mma_us = dev_us.get((ring, "mma"))
        rows_us = dev_us.get((ring, "rowsbf16"))
        c["device_us"], c["rows_device_us"] = mma_us, rows_us
        if mma_us is None or rows_us is None:
            print(f"[timing] epoch_step_dp_mma_{ring} n={DP_REPLICAS}: the "
                  f"profiler recorded no device time (not measured)")
            continue
        print(f"[timing] epoch_step_dp_mma_{ring} n={DP_REPLICAS}: device "
              f"time (profiler, in turns rows, mma, mma, rows) {mma_us:.1f} "
              f"us a launch against the rows design's bf16 form "
              f"{rows_us:.1f} ({rows_us / mma_us:.2f}x) [{card}]")
    return {"cases": cases, "mma": mma}


def k6_mma_times(device, card: str) -> dict:
    """K6 in the bf16 mode per (ring, n) at n = 2 and DP_REPLICAS, B = 128
    per replica, over the 118-step epoch (uint8 rows, threefry): K6-mma and
    the rows design's ring in the bf16 mode (forced) in turns (rows, mma,
    mma, rows), the plain version, K6-mma's stamps split a step, and the
    bound at the bf16 peak. Returns {"<ring> n=<n>": {...}}."""
    from functools import partial

    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    kernel = partial(epoch_step.epoch_fused_sgd, compute_bf16=True)
    cases = {}
    for ring in ("allgather", "reduce_scatter"):
        for n in (2, DP_REPLICAS):
            inp = _dp_inputs(n, MAIN_BATCH, DP_EPOCH_STEPS, seed=11,
                             device=device)
            mma = lambda: _dp_call(kernel, "K3", inp, ring)  # noqa: E731
            rows = lambda: _dp_call(kernel, "K3", inp, ring,  # noqa: E731
                                    _design="rows")
            rows_ms, mma_ms, turns = _turns(rows, mma, iters=5, warmup=1)
            plain_ms = _time_ms(lambda: _dp_call(
                epoch_step.epoch_dp_sgd_reference, "K3", inp, ring,
                compute_bf16=True), iters=1, warmup=0)
            _, _, split, per_step = _dp_call(epoch_step.k6_mma_phase_stamps,
                                             "K3", inp, ring)
            bound = k6_bound(n, MAIN_BATCH, DP_EPOCH_STEPS, ring,
                             PEAK_BF16_FLOPS)
            cases[f"{ring} n={n}"] = {
                "ms": mma_ms, "us_per_step": mma_ms * 1e3 / DP_EPOCH_STEPS,
                "rows_ms": rows_ms,
                "rows_us_per_step": rows_ms * 1e3 / DP_EPOCH_STEPS,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "flop": bound[2], "bytes": bound[3],
                "blocks_per_replica": epoch_step.RING_MMA_BLOCKS,
                "timed_in_turns_rows_mma_mma_rows": turns,
                "stamps_us_per_step": per_step, "stamps_split_us": split}
            print(f"[timing] epoch_step_dp_mma_{ring} n={n} B={MAIN_BATCH} "
                  f"S={DP_EPOCH_STEPS} ({epoch_step.RING_MMA_BLOCKS} blocks "
                  f"per replica): {mma_ms:.3f} ms per epoch launch, "
                  f"{mma_ms * 1e3 / DP_EPOCH_STEPS:.2f} us a step; the rows "
                  f"design's ring in bf16 {rows_ms:.3f} ms "
                  f"({rows_ms / mma_ms:.2f}x); plain {plain_ms:.1f} ms; bound "
                  f"{bound[0]:.4f} ms by {bound[1]} (bf16 peak) (turns rows, "
                  f"mma, mma, rows: {', '.join(f'{v:.3f}' for v in turns)}) "
                  f"[{card}]")
            print(f"[timing] epoch_step_dp_mma_{ring} n={n} phase split "
                  f"(stamps build, block 0 of replica 0, mean over the "
                  f"steps): {per_step:.2f} us a step [{card}]")
            for phase, us in split.items():
                print(f"[timing]   {phase:52s} {us:8.3f} us  "
                      f"{us / per_step:6.1%}")
    return cases


def phase_timing_k6(device, launches: dict, worst: dict, card: str,
                    prof: dict) -> list:
    """K6's times (`k6_times`) and its entries of the kernels line: K6-ws's
    two rings and the rows design's, K6-mma's two rings and the rows
    design's all-gather in the bf16 mode, at n = 4."""
    times = k6_times(device, card, prof)
    cases, mma = times["cases"], times["mma"]
    rows_batch = DP_REPLICAS * ROWS_BATCH
    out = []
    for ring in ("allgather", "reduce_scatter"):
        c = cases[f"{ring} n={DP_REPLICAS}"]
        bound = (c["bound_ms"], c["bound_by"], c["flop"], c["bytes"])
        key = f"epoch_step_dp_ws_{ring}"
        out.append(_entry(
            key, "ring_ws.cu", RING_TPU_LINE[ring],
            launches[f"fit_cached pallas_epoch {ring} float32 {DP_BATCH}"][key],
            worst[ring], c["ms"], c["plain_ms"], bound, card,
            ring_source="pytorch_ddp_mnist_tpu_torch/csrc/ws_step.cuh, "
                        "pytorch_ddp_mnist_tpu_torch/csrc/dp_ring.cuh",
            form=f"K6-ws {ring}, uint8 rows, threefry masks; n = "
                 f"{DP_REPLICAS} replicas on one card; top-level numbers "
                 f"at n = {DP_REPLICAS}",
            batch_per_replica=MAIN_BATCH, steps=DP_EPOCH_STEPS,
            cases={k: v for k, v in cases.items() if k.startswith(ring)}))
        key = f"epoch_step_dp_{ring}"
        out.append(_entry(
            key, "epoch_step.cu", RING_TPU_LINE[ring],
            launches[f"fit_cached pallas_epoch {ring} float32 "
                     f"{rows_batch}"][key],
            worst[ring], c["rows_ms"], c["plain_ms"], bound, card,
            ring_source="pytorch_ddp_mnist_tpu_torch/csrc/dp_ring.cuh",
            form=f"K6 {ring} on the rows design, forced at B = {MAIN_BATCH} "
                 f"(bitwise K6-ws there) and timed in turns with K6-ws; n = "
                 f"{DP_REPLICAS}",
            main_path=f"launched at {ROWS_BATCH} rows per replica (B > "
                      f"128): fit_cached at batch_size {rows_batch}",
            device_us=c["rows_device_us"],
            batch_per_replica=MAIN_BATCH, steps=DP_EPOCH_STEPS))
    for ring in ("allgather", "reduce_scatter"):
        c = mma[f"{ring} n={DP_REPLICAS}"]
        bound = (c["bound_ms"], c["bound_by"], c["flop"], c["bytes"])
        key = f"epoch_step_dp_mma_{ring}"
        out.append(_entry(
            key, "ring_mma.cu", RING_TPU_LINE[ring],
            launches[f"fit_cached pallas_epoch {ring} bfloat16 {DP_BATCH}"][key],
            worst[key[len("epoch_step_dp_"):]], c["ms"], c["plain_ms"], bound,
            card,
            ring_source="pytorch_ddp_mnist_tpu_torch/csrc/mma_step.cuh, "
                        "pytorch_ddp_mnist_tpu_torch/csrc/dp_ring.cuh",
            form=f"K6-mma {ring}, uint8 rows, bf16 operands, threefry masks; "
                 f"n = {DP_REPLICAS} replicas on one card; top-level numbers "
                 f"at n = {DP_REPLICAS}; bound at the bf16 tensor-core peak",
            device_us=c["device_us"], batch_per_replica=MAIN_BATCH,
            steps=DP_EPOCH_STEPS,
            cases={k: v for k, v in mma.items() if k.startswith(ring)}))
    c = mma[f"allgather n={DP_REPLICAS}"]
    out.append(_entry(
        "epoch_step_dp_allgather_bf16", "epoch_step.cu",
        RING_TPU_LINE["allgather"],
        launches[f"fit_cached pallas_epoch allgather bfloat16 "
                 f"{rows_batch}"]["epoch_step_dp_allgather_bf16"],
        worst["bf16"], c["rows_ms"], c["plain_ms"],
        (c["bound_ms"], c["bound_by"], c["flop"], c["bytes"]), card,
        ring_source="pytorch_ddp_mnist_tpu_torch/csrc/dp_ring.cuh",
        form=f"K6-bf16: the rows design's all-gather ring in the bf16-operand "
             f"mode, forced at B = {MAIN_BATCH} and timed in turns with "
             f"K6-mma; n = {DP_REPLICAS} replicas on one card; bound at the "
             f"bf16 tensor-core peak",
        main_path=f"launched at {ROWS_BATCH} rows per replica (B > 128): "
                  f"fit_cached at batch_size {rows_batch}, dtype bfloat16",
        device_us=c["rows_device_us"], batch_per_replica=MAIN_BATCH,
        steps=DP_EPOCH_STEPS))
    print("[timing] epoch_step_dp: no single PyTorch call computes an epoch "
          "of data-parallel SGD, so library_ms is null")
    return out


# ---- the per-step loops captured as CUDA graphs (train/graphs.py) ----

CAPTURE_EPOCHS = 3
# (label, kind, kernel, dtype, replicas of the card or None)
CAPTURE_PATHS = (
    ("cached xla float32", "cached", "xla", "float32", None),
    ("cached xla bfloat16", "cached", "xla", "bfloat16", None),
    ("cached pallas float32", "cached", "pallas", "float32", None),
    ("cached pallas bfloat16", "cached", "pallas", "bfloat16", None),
    ("cached pallas_rng float32", "cached", "pallas_rng", "float32", None),
    ("cached pallas_rng bfloat16", "cached", "pallas_rng", "bfloat16", None),
    ("mesh4 pallas float32", "cached", "pallas", "float32", DP_REPLICAS),
    ("mesh4 pallas bfloat16", "cached", "pallas", "bfloat16", DP_REPLICAS),
    ("streaming pallas float32", "streaming", "pallas", "float32", None),
    ("streaming xla float32", "streaming", "xla", "float32", None),
)
# K1-rng's device-seed form against its scalar-seed form: (B, x dtype, the
# design fused_design picks)
SEED_ROW_CHECKS = ((128, "float32", "split"), (96, "float32", "split"),
                   (3, "float32", "split"), (128, "bfloat16", "mma"),
                   (96, "bfloat16", "mma"), (3, "bfloat16", "mma"),
                   (ROWS_BATCH, "float32", "rows"),
                   (ROWS_BATCH, "bfloat16", "rows"))
SEED_ROW_SEEDS = 48
GOLDEN_KERNELS = ("xla", "pallas")


def _torch_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def capture_data(device, n_train: int = 60000, n_test: int = 10000) -> dict:
    """The synthetic MNIST 60k/10k that the capture, golden and profile
    phases share, made once (the golden's own data: train seed 0, test
    seed 1): the uint8 train rows and labels resident on the card, the
    normalised train rows for the streaming loop, the normalised test
    split."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                         synthetic_mnist)
    from pytorch_ddp_mnist_tpu_torch.train import scan
    train, test = synthetic_mnist(n_train, seed=0), synthetic_mnist(n_test,
                                                                     seed=1)
    labels = train.labels.astype(np.int32)
    return {"train": train, "labels": labels,
            "x_norm": normalize_images(train.images),
            "x_test": normalize_images(test.images),
            "y_test": test.labels.astype(np.int32),
            "x_all": torch.from_numpy(
                scan.resident_images(train.images)).to(device),
            "y_all": torch.from_numpy(labels).to(device)}


class _PathRun:
    """One per-step path built as its trainer builds it, from
    MLP.from_seed(0) and the train key 1 at B = 128 a replica: the cached
    paths on scan.CachedSteps (fit_cached's loop; a mesh of `n_rep`
    replicas of the card), the streaming paths on loop.fit's captured step
    fed by the pipeline's slot ring at `depth` (depth 1: device_prefetch's
    two slots). `eager` runs the same step without a graph."""

    def __init__(self, device, data, kind, kernel, dtype, n_rep, eager,
                 x_all=None, y_all=None, depth=1):
        from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
        from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
        from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
        from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
        from pytorch_ddp_mnist_tpu_torch.train import loop, scan
        self.kind, self.device = kind, device
        self.model = MLP.from_seed(0).to(device)
        self.key = threefry.key_data(1)
        rows = data["labels"].shape[0]
        self.sampler = ShardedSampler(rows, seed=42)
        self.batch = MAIN_BATCH * (n_rep or 1)
        self.fold = None if n_rep is None else range(n_rep)
        if kind == "cached":
            x_all = data["x_all"] if x_all is None else x_all
            y_all = data["y_all"] if y_all is None else y_all
            self.nsteps = math.ceil(rows / self.batch)
            self.params = scan._clone(self.model.params())
            self.steps = scan.CachedSteps(
                self.params, x_all, y_all, (self.nsteps, self.batch), LR,
                kernel, _torch_dtype(dtype),
                None if n_rep is None else (device,) * n_rep, eager=eager)
            self.loop = self.steps.loop
        else:
            step = (loop.make_train_step(LR) if kernel == "xla" else
                    fused_step.make_fused_train_step(LR, dtype=dtype))
            self.step = step
            self.loader = BatchLoader(data["x_norm"], data["train"].labels,
                                      self.sampler, self.batch)
            self.nsteps = len(self.loader)
            self.loop, self.slots, self.keys = loop._captured_steps(
                step, self.model, self.nsteps, self.batch, device, eager,
                ring=depth + 1)
            self.pinned = tuple(torch.empty(s.shape, dtype=s.dtype,
                                            pin_memory=True)
                                for s in self.slots)
            from pytorch_ddp_mnist_tpu_torch.pipeline import SlotRing
            self.ring = SlotRing(self.slots, self.pinned)
        self.depth = depth
        self.epoch = 0

    def load(self) -> None:
        """The epoch's indices (cached) and key table into the buffers."""
        from pytorch_ddp_mnist_tpu_torch.ops import threefry
        from pytorch_ddp_mnist_tpu_torch.train import scan
        self.sampler.set_epoch(self.epoch)
        self.key, words = threefry.step_key_words(self.key, self.nsteps,
                                                  self.fold)
        if self.kind == "cached":
            self.steps.idx.load(scan.epoch_batch_indices(self.sampler,
                                                         self.batch))
            self.steps.keys.load(words)
        else:
            self.keys.load(words)
        self.epoch += 1

    def run_steps(self, steps: int | None = None) -> None:
        """The epoch's steps (its first `steps` of them, if given)."""
        steps = self.nsteps if steps is None else min(steps, self.nsteps)
        self.loop.start_epoch()
        if self.kind == "cached":
            for _ in range(steps):
                self.loop.step()
            return
        batches = self.ring.feed(iter(self.loader), self.depth)
        for k, _ in enumerate(batches):
            self.loop.step()
            if k + 1 == steps:
                break
        batches.close()

    def fetch(self) -> np.ndarray:
        return self.loop.losses().cpu().numpy()

    def state(self) -> dict:
        params = self.params if self.kind == "cached" else self.model.params()
        return {n: {k: v.detach().cpu().clone() for k, v in layer.items()}
                for n, layer in params.items()}

    def evaluate(self, x_test, y_test) -> None:
        from pytorch_ddp_mnist_tpu_torch.train import loop, scan
        if self.kind == "cached":
            scan._load_params(self.model, self.params)
        loop.evaluate(self.model, x_test, y_test, MAIN_BATCH)

    def one_epoch(self, steps: int | None = None) -> None:
        self.load()
        self.run_steps(steps)
        self.fetch()


CAPTURE_PARTS = ("upload", "buffers", "key table", "step loop", "loss fetch",
                 "eval")


def _graph_run(device, data, kind, kernel, dtype, n_rep, eager) -> tuple:
    """CAPTURE_EPOCHS epochs of a per-step path (_PathRun), host stamps
    between the parts of each epoch (CAPTURE_PARTS; the first epoch's
    upload of its data, the static buffers made before it; "key table" is
    the epoch's indices and keys loaded into the buffers; the first step
    loop of a captured run holds the capture). Returns ([{part: s} an
    epoch], losses (E, S), params on the CPU, launches added, captures
    added)."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    from pytorch_ddp_mnist_tpu_torch.train import graphs, scan
    before, caps = dict(fused_step.launch_count), graphs.counts["captures"]
    torch.cuda.synchronize()
    last = time.perf_counter()
    parts = {}

    def mark(part):
        nonlocal last
        now = time.perf_counter()
        parts[part], last = now - last, now

    x_all = y_all = None
    if kind == "cached":   # the trainer's upload of the dataset
        x_all = torch.from_numpy(scan.resident_images(
            data["train"].images)).to(device)
        y_all = torch.from_numpy(data["labels"]).to(device)
    x_test = torch.as_tensor(data["x_test"], device=device)
    y_test = torch.as_tensor(data["y_test"], device=device)
    torch.cuda.synchronize()
    mark("upload")
    run = _PathRun(device, data, kind, kernel, dtype, n_rep, eager, x_all,
                   y_all)
    mark("buffers")
    epochs, losses = [], []
    for _ in range(CAPTURE_EPOCHS):
        run.load()
        mark("key table")
        run.run_steps()
        mark("step loop")
        losses.append(run.fetch())
        mark("loss fetch")
        run.evaluate(x_test, y_test)
        mark("eval")
        epochs.append(dict(parts))
        parts.clear()
    added = {k: v - before[k] for k, v in fused_step.launch_count.items()
             if v != before[k]}
    return (epochs, np.stack(losses), run.state(), added,
            graphs.counts["captures"] - caps)


def _entry_run(device, data, kind, kernel, dtype, n_rep) -> tuple:
    """The same path's CAPTURE_EPOCHS epochs through the entry point a user
    calls (fit_cached, what `train --cached [--parallel]` runs; fit, what
    streaming `train` runs), captured. Returns (losses (E, S), params on
    the CPU, captures added)."""
    from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import graphs, loop, scan
    caps = graphs.counts["captures"]
    model = MLP.from_seed(0).to(device)
    batch = MAIN_BATCH * (n_rep or 1)
    quiet = lambda line: None  # noqa: E731
    if kind == "cached":
        _, history = scan.fit_cached(
            model, threefry.key_data(1), data["train"].images, data["labels"],
            ShardedSampler(len(data["labels"]), seed=42), data["x_test"],
            data["y_test"],
            epochs=CAPTURE_EPOCHS, batch_size=batch, lr=LR, kernel=kernel,
            dtype=dtype, mesh=None if n_rep is None else (device,) * n_rep,
            log=quiet)
    else:
        step = (loop.make_train_step(LR) if kernel == "xla" else
                fused_step.make_fused_train_step(LR, dtype=dtype))
        _, history = loop.fit(
            loop.TrainState(model, threefry.key_data(1)),
            BatchLoader(data["x_norm"], data["train"].labels,
                        ShardedSampler(len(data["labels"]), seed=42), batch),
            data["x_test"], data["y_test"], epochs=CAPTURE_EPOCHS,
            batch_size=batch, train_step=step, log=quiet)
    params = {n: {k: v.detach().cpu().clone() for k, v in layer.items()}
              for n, layer in model.params().items()}
    return np.stack(history), params, graphs.counts["captures"] - caps


STALE_CASES = (("cached", "xla", 1), ("cached", "pallas", 1),
               ("cached", "pallas_rng", 1), ("streaming", "pallas", 1))


def _stale_input_check(device, data, cases=STALE_CASES) -> list:
    """A step captured on epoch 0's buffers, then replayed on epoch 1's
    new indices (or batches) and keys, against the same step run eagerly
    on epoch 1 from the same state: by default the cached f32 paths of
    each kernel and the streaming pallas path; each case is (kind, kernel,
    the streaming ring's prefetch depth). Returns the paths checked."""
    checked = []
    for kind, kernel, depth in cases:
        what = f"{kind} {kernel} float32" + (f" depth {depth}"
                                             if kind == "streaming" else "")
        run = _PathRun(device, data, kind, kernel, "float32", None, False,
                       depth=depth)
        run.one_epoch()
        if run.loop.graph is None:
            fail(f"stale-input check, {what}: epoch 0 captured no graph")
        eager = _PathRun(device, data, kind, kernel, "float32", None, True,
                         depth=depth)
        with torch.no_grad():    # the eager run from the captured's state
            src = run.params if kind == "cached" else run.model.params()
            dst = eager.params if kind == "cached" else eager.model.params()
            for n, layer in src.items():
                for k, v in layer.items():
                    dst[n][k].copy_(v)
        eager.key, eager.epoch = run.key, run.epoch
        run.load()
        run.run_steps()
        eager.load()
        eager.run_steps()
        got, want = run.fetch(), eager.fetch()
        if not (np.array_equal(got, want) and
                _equal_trees(run.state(), eager.state())):
            fail(f"stale-input check, {what}: the replays of epoch 1 on new "
                 f"inputs differ from the eager epoch 1 from the same state "
                 f"(bitwise expected)")
        if run.key != eager.key or not np.isfinite(got).all():
            fail(f"stale-input check, {what}: keys differ or losses not "
                 f"finite")
        checked.append(what)
    print(f"[capture] stale-input check: a step captured on epoch 0's "
          f"buffers, replayed on epoch 1's new indices (batches) and keys, "
          f"bitwise the eager epoch 1 from the same state: "
          f"{', '.join(checked)}")
    return checked


def phase_capture(device, data: dict, card: str) -> dict:
    """Every per-step path on a captured step (CAPTURE_PATHS): CAPTURE_EPOCHS
    epochs captured and eager in turns (captured, eager, eager, captured),
    per-step losses and final params bitwise equal across all four, one
    capture a captured run and none an eager one, the launch counts of a
    captured run the eager run's; the same epochs through the entry point
    a user calls (fit_cached, fit), captured once and bitwise the turns;
    each run's epoch walls with host stamps (CAPTURE_PARTS); then the
    stale-input check. Returns {label: results}."""
    out = {}
    for label, kind, kernel, dtype, n_rep in CAPTURE_PATHS:
        runs = {"captured": [], "eager": []}
        results = {}
        for eager in (False, True, True, False):
            which = "eager" if eager else "captured"
            epochs, losses, params, added, caps = _graph_run(
                device, data, kind, kernel, dtype, n_rep, eager)
            if caps != (0 if eager else 1):
                fail(f"capture {label}, {which}: {caps} captures in a run "
                     f"(expected {0 if eager else 1})")
            if not np.isfinite(losses).all() or losses.shape[0] != \
                    CAPTURE_EPOCHS:
                fail(f"capture {label}, {which}: losses {losses.shape} or "
                     f"not finite")
            runs[which].append(epochs)
            if "ref" not in results:
                results["ref"] = (losses, params, added)
            ref_l, ref_p, ref_n = results["ref"]
            if not (np.array_equal(losses, ref_l)
                    and _equal_trees(params, ref_p)):
                fail(f"capture {label}: the {which} run's losses or params "
                     f"differ from the first run's (bitwise expected)")
            if added != ref_n or not added:
                fail(f"capture {label}: the {which} run's launches {added} "
                     f"are not the first run's {ref_n}")
        entry_l, entry_p, entry_caps = _entry_run(device, data, kind, kernel,
                                                  dtype, n_rep)
        if entry_caps != 1 or not (np.array_equal(entry_l, results["ref"][0])
                                   and _equal_trees(entry_p,
                                                    results["ref"][1])):
            fail(f"capture {label}: the entry point's run ({entry_caps} "
                 f"captures) differs from the turns (bitwise expected)")
        walls = {w: [[sum(e.values()) for e in r] for r in rs]
                 for w, rs in runs.items()}
        loops = {w: [[e["step loop"] + e["loss fetch"] for e in r]
                     for r in rs] for w, rs in runs.items()}
        out[label] = {"epochs": runs, "walls_s": walls,
                      "steps_s": loops, "launches": results["ref"][2],
                      "nsteps": results["ref"][0].shape[1]}
        for which in ("captured", "eager"):
            for r, (w, lp) in enumerate(zip(walls[which], loops[which])):
                print(f"[capture] {label}, {which} run {r}: epoch walls "
                      f"{', '.join(f'{v:.4f}' for v in w)} s (epoch 0 with "
                      f"the upload{' and the capture' if which == 'captured' else ''}); "
                      f"the step loop with its loss fetch "
                      f"{', '.join(f'{v:.4f}' for v in lp)} s "
                      f"({', '.join(f'{a / b:.1%}' for a, b in zip(lp, w))}) "
                      f"[{card}]")
        parts = runs["captured"][0][0]
        print(f"[capture] {label}: {CAPTURE_EPOCHS} epochs of "
              f"{out[label]['nsteps']} steps bitwise equal captured and "
              f"eager (turns captured, eager, eager, captured) and through "
              f"the entry point; one capture a captured run; launches "
              f"{results['ref'][2]} in each; captured epoch 0 = "
              + ", ".join(f"{p} {parts[p]:.4f}" for p in CAPTURE_PARTS
                          if p in parts) + f" s [{card}]")
    out["stale_input_checked"] = _stale_input_check(device, data)
    return out


PROFILE_STEPS = 100   # a capture path's profiler job's steps (of 469 / 118)
# a path's captured and eager device times an epoch, which run the same
# kernels, agree within this share where the profiler placed every kernel
# in its own job
PLACEMENT_RTOL = 0.10


def capture_profile_jobs(device, data: dict) -> dict:
    """Profiler jobs, the first PROFILE_STEPS steps of each capture path's
    epoch with its loss fetch, on an epoch's buffers loaded here: on the
    step captured here, before the profiler session, and on the same step
    run eagerly (a steady share needs no whole epoch, and every event the
    profiler records costs the session time to read)."""
    def job(run):
        run.load()

        def steps_and_fetch():
            run.run_steps(PROFILE_STEPS)
            run.fetch()
        return (steps_and_fetch, 1, None)
    jobs = {}
    for label, kind, kernel, dtype, n_rep in CAPTURE_PATHS:
        run = _PathRun(device, data, kind, kernel, dtype, n_rep, False)
        run.one_epoch(1)
        jobs[f"capture {label} captured"] = job(run)
        jobs[f"capture {label} eager"] = job(
            _PathRun(device, data, kind, kernel, dtype, n_rep, True))
    return jobs


def report_capture(capture: dict, busy: dict, card: str) -> dict:
    """Each capture path's epoch wall, captured against eager (the best of
    each's runs, epochs 1.. and epoch 0 with the upload and capture), the
    step loop's share, and the card's busy share from the profiler. The
    profiler places each kernel in a job by its device start (profile_jobs),
    which can fall into a neighbouring job; the two forms run the same
    kernels, so a path's busy shares are marked checked only where its
    captured and eager device times agree within PLACEMENT_RTOL, and
    unchecked otherwise. Returns the summary."""
    summary = {}
    for label, *_ in CAPTURE_PATHS:
        c = capture[label]
        row = {}
        for which in ("captured", "eager"):
            walls, loops = c["walls_s"][which], c["steps_s"][which]
            steady = [w for r in walls for w in r[1:]]
            steady_loop = [v for r in loops for v in r[1:]]
            b = busy.get(f"capture {label} {which}")
            row[which] = {
                "epoch0_s": min(r[0] for r in walls),
                "epoch_s": min(steady), "step_loop_s": min(steady_loop),
                "step_loop_share": min(steady_loop) / min(steady),
                "busy_share": b["busy_share"] if b else None,
                "busy_ms": b["busy_ms"] if b else None}
        # the two forms run the same kernels: their device times check the
        # profiler's placement of the kernels in the jobs
        cap, eag = row["captured"], row["eager"]
        row["placement_checked"] = False
        if cap["busy_ms"] is not None and eag["busy_ms"] is not None:
            scale = c["nsteps"] / min(PROFILE_STEPS, c["nsteps"])
            dev = {"captured": cap["busy_ms"] * scale,
                   "eager": eag["busy_ms"] * scale}
            row["device_ms_epoch"] = dev
            row["placement_checked"] = abs(
                dev["captured"] - dev["eager"]) <= PLACEMENT_RTOL * max(
                dev["captured"], dev["eager"])
        summary[label] = row
        busy_txt = ", ".join(
            f"{w} {row[w]['busy_share']:.1%}" if row[w]["busy_share"]
            is not None else f"{w} not measured" for w in ("captured",
                                                          "eager"))
        busy_txt += (f" (the first {PROFILE_STEPS} steps and the fetch; "
                     + ("placement checked" if row["placement_checked"] else
                        "placement UNCHECKED: the forms' device times differ "
                        f"by more than {PLACEMENT_RTOL:.0%}") + ")")
        dev = row.get("device_ms_epoch")
        dev_txt = (f"{dev['captured']:.2f} ms captured, {dev['eager']:.2f} "
                   f"eager (scaled from its steps)" if dev else "not measured")
        print(f"[capture] {label}: epoch {cap['epoch_s']:.4f} s captured "
              f"against {eag['epoch_s']:.4f} eager ({eag['epoch_s'] / cap['epoch_s']:.2f}x; "
              f"epoch 0 {cap['epoch0_s']:.4f} against {eag['epoch0_s']:.4f}); "
              f"step loop + fetch {cap['step_loop_s']:.4f} s "
              f"({cap['step_loop_share']:.1%}) against "
              f"{eag['step_loop_s']:.4f} ({eag['step_loop_share']:.1%}); "
              f"card busy {busy_txt} (profiler); device time an epoch "
              f"{dev_txt} [{card}]")
    return summary


def phase_kernels_seed_row(device) -> dict:
    """K1-rng's device-seed forms (the seed read from word 0 of a key-table
    row: what a captured `pallas_rng` step launches) at SEED_ROW_CHECKS,
    each on the design fused_design picks (asserted by its launch key):
    bitwise the scalar-seed form on SEED_ROW_SEEDS seeds, some with the
    high bit set, within the tolerances of the plain version on the
    seed's philox.rng_mask; a call captured in a CUDA graph, replayed after
    the row's seed word changes, bitwise the scalar-seed form of the new
    seed. Returns {launch key: worst abs err against the plain version}."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox, threefry
    rng = np.random.default_rng(14)
    seeds = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF] + [
        int(v) for v in rng.integers(0, 1 << 32, SEED_ROW_SEEDS - 5,
                                     dtype=np.uint64)]
    high = sum(s >= 1 << 31 for s in seeds)
    worst = {}
    for batch, dtype, design in SEED_ROW_CHECKS:
        params, x, y, _ = _k1_inputs(batch, seed=batch + 1, device=device)
        x = x.to(_torch_dtype(dtype))
        bf16 = dtype == "bfloat16"
        key = (f"fused_{design}_rng_dev" if design != "rows" else
               f"fused_step_rng_dev{'_bf16' if bf16 else ''}")
        table = threefry.to_int32_words([(s, i) for i, s in
                                         enumerate(seeds)]).to(device)
        tag = f"K1-rng device-seed, {design} design, {dtype} B={batch}"
        err = 0.0
        for s, row in zip(seeds, table):
            before = fused_step.launch_count[key]
            got_out = fused_step.fused_loss_and_grads_rng(params, x, y, row)
            got = _flat(*got_out)
            if fused_step.launch_count[key] != before + 1:
                fail(f"{tag}: the call did not launch {key}")
            want = _flat(*fused_step.fused_loss_and_grads_rng(params, x, y,
                                                              s))
            _check_bitwise(f"{tag}, seed {s:#x}", got, want,
                           "the scalar-seed form")
            if s in seeds[:8]:
                ref = fused_step._reference(params, x, y,
                                            philox.rng_mask(s, batch, device))
                pins = ((BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL)
                        if bf16 else (LOSS_RTOL, GRAD_RTOL, GRAD_ATOL))
                err = max(err, _check_close(f"{tag}, seed {s:#x}", got_out,
                                            ref, *pins))
        # a captured call reads the seed word the row holds at replay
        row = table[0].clone()
        fused_step.fused_loss_and_grads_rng(params, x, y, row)
        torch.cuda.synchronize()
        graph, held = torch.cuda.CUDAGraph(), {}
        with torch.cuda.graph(graph):
            held["out"] = fused_step.fused_loss_and_grads_rng(params, x, y,
                                                              row)
        for s, src in zip(seeds[1:4], table[1:4]):
            row.copy_(src)
            graph.replay()
            _check_bitwise(f"{tag}, a replay after the seed word changed to "
                           f"{s:#x}", _flat(*held["out"]),
                           _flat(*fused_step.fused_loss_and_grads_rng(
                               params, x, y, s)), "the new seed's call")
        worst[key] = max(worst.get(key, 0.0), err)
        print(f"[kernels] {tag}: bitwise the scalar-seed form on "
              f"{len(seeds)} seeds ({high} with the high bit set); a graph "
              f"replay after the seed word changed draws the new seed's "
              f"mask; worst abs err against the plain version {err:.3e}")
    return worst


def phase_timing_seed_row(device, paths: dict, worst: dict,
                          card: str) -> list:
    """K1-rng's device-seed form at B = 128, f32 (K1-split) and bf16
    (K1-mma): against the scalar-seed form in turns (scalar, device,
    device, scalar) per wrapper call and per call in a CUDA graph, between
    two timings of the plain version; the rows design's two forms in a
    graph with the design forced, in turns. `paths` are every main path's
    launches. Returns the kernels-line entries of the two device-seed
    forms."""
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step, philox, threefry
    params, x, y, _ = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    seed = 0x9E3779B9
    row = threefry.to_int32_words([(seed, 5)]).to(device)[0]
    out = []
    for bf16 in (False, True):
        xin = x.to(torch.bfloat16) if bf16 else x
        design = "mma" if bf16 else "split"
        name = f"fused_{design}_rng_dev"

        def dev(xin=xin, design=None):
            return fused_step.fused_loss_and_grads_rng(params, xin, y, row,
                                                       _design=design)

        def scalar(xin=xin, design=None):
            return fused_step.fused_loss_and_grads_rng(params, xin, y, seed,
                                                       _design=design)

        def plain(xin=xin):
            return fused_step._reference(params, xin, y, philox.rng_mask(
                seed, MAIN_BATCH, device))
        p1 = _time_ms(plain, iters=50, warmup=5)
        s_ms, d_ms, turns = _turns(scalar, dev, iters=200, warmup=20)
        graphs = [_graph_ms(f) for f in (scalar, dev, dev, scalar)]
        p2 = _time_ms(plain, iters=50, warmup=0)
        sg, dg = min(graphs[0], graphs[3]), min(graphs[1], graphs[2])
        rows = [_graph_ms(lambda f=f: f(design="rows"))
                for f in (scalar, dev, dev, scalar)]
        bound = k1_bound(MAIN_BATCH, bf16=bf16, rng=True)
        out.append(_entry(
            name, f"fused_{design}.cu", 333, sum(
                v.get(name, 0) for v in paths.values()),
            worst[name], d_ms, min(p1, p2), bound, card, graph_ms=dg,
            scalar_seed_ms=s_ms, scalar_seed_graph_ms=sg,
            turns_scalar_dev_dev_scalar={"call_ms": turns, "graph_ms": graphs},
            rows_design_graph_ms={"scalar": min(rows[0], rows[3]),
                                  "device_seed": min(rows[1], rows[2]),
                                  "turns": rows},
            form=f"K1-rng{'-bf16' if bf16 else ''} with its seed read from "
                 f"word 0 of a key-table row (PhiloxKeyMask): the form a "
                 f"captured pallas_rng step launches",
            design=f"{design} (csrc/fused_{design}.cu), by fused_design",
            launches_by_path={k: v[name] for k, v in paths.items()
                              if v.get(name)},
            batch=MAIN_BATCH))
        print(f"[timing] {name} B={MAIN_BATCH}: {dg * 1e3:.2f} us per call "
              f"in a CUDA graph against the scalar-seed form's "
              f"{sg * 1e3:.2f} (turns scalar, device, device, scalar: "
              f"{', '.join(f'{v * 1e3:.2f}' for v in graphs)}); per wrapper "
              f"call {d_ms * 1e3:.2f} us against {s_ms * 1e3:.2f}; the rows "
              f"design forced in a graph: "
              f"{', '.join(f'{v * 1e3:.2f}' for v in rows)}; plain "
              f"{min(p1, p2) * 1e3:.2f} us; bound {bound[0] * 1e3:.3f} us by "
              f"{bound[1]} [{card}]")
    print("[timing] fused_split_rng_dev, fused_mma_rng_dev: no single "
          "PyTorch call computes this fused function, so library_ms is null")
    return out


def phase_golden(device, data: dict, card: str) -> dict:
    """The 10-epoch golden on the card: `docs/golden_accuracy.json`'s
    config (synthetic 60k/10k, batch 128, lr 0.01, init
    build_reference_model(7), the batch order of shared_batch_indices)
    through the captured make_run_fn (utils/golden.py `train_port`) with
    kernel `xla` (the golden's own) and `pallas` (K1-split keyed), f32,
    each held to the golden's accuracy bound and val-loss-ratio bound
    against the file's torch runs; each curve printed beside the JAX
    framework curve the file holds. Returns {kernel: (run, verdict)}."""
    from pytorch_ddp_mnist_tpu_torch.train import graphs
    from pytorch_ddp_mnist_tpu_torch.utils import golden, torch_ref
    with open(os.path.join(REPO, "docs", "golden_accuracy.json")) as f:
        art = json.load(f)
    cfg = art["config"]
    want = {"epochs": 10, "batch": MAIN_BATCH, "lr": LR, "train_n": 60000,
            "test_n": 10000, "data": "synthetic", "sampler_seed": 42,
            "init_seed": 7}
    if {k: cfg[k] for k in want} != want:
        fail(f"the golden's config {cfg} is not {want}")
    if (len(data["labels"]), len(data["y_test"])) != (cfg["train_n"],
                                                      cfg["test_n"]):
        fail("the golden needs the synthetic 60k/10k splits")
    idxs = golden.shared_batch_indices(cfg["train_n"], cfg["epochs"],
                                       cfg["batch"])
    params0 = torch_ref.params_from_torch(
        torch_ref.build_reference_model(cfg["init_seed"]))
    jax_curve = art["framework_run"]["curve"]
    out = {}
    for kernel in GOLDEN_KERNELS:
        caps = graphs.counts["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = golden.train_port(params0, data["train"].images, data["labels"],
                                idxs, data["x_test"], data["y_test"],
                                cfg["lr"], device, kernel=kernel)
        wall = time.perf_counter() - t0
        if graphs.counts["captures"] - caps != 1:
            fail(f"golden {kernel}: {graphs.counts['captures'] - caps} "
                 f"captures (one expected: the captured make_run_fn)")
        v = golden.verdict(run, art["torch_runs"], cfg["test_n"])
        out[kernel] = {"run": run, "verdict": v, "wall_s": wall}
        for e, (c, j) in enumerate(zip(run["curve"], jax_curve)):
            print(f"[golden] {kernel} epoch {e}: acc {c['accuracy']:.4f} "
                  f"mean val loss {c['mean_val_loss']:.8f}; the JAX "
                  f"framework run: acc {j['accuracy']:.4f} mean val loss "
                  f"{j['mean_val_loss']:.8f}")
        print(f"[golden] {kernel} f32, 10 epochs on the captured step "
              f"({wall:.3f} s with the eval): final acc "
              f"{v['final_accuracy']:.4f} against torch's "
              f"{v['torch_final_accuracy']:.4f} (gap {v['accuracy_gap']:.4f}, "
              f"bound {v['accuracy_bound']:.4f}); final mean val loss "
              f"{v['final_mean_val_loss']:.8f} against torch's "
              f"{v['torch_final_mean_val_loss']:.8f} (ratio gap "
              f"{v['val_loss_ratio_gap']:.6f}, bound "
              f"{v['val_loss_ratio_bound']}) -> "
              f"{'PASS' if v['pass'] else 'FAIL'} [{card}]")
        if not v["pass"]:
            fail(f"the 10-epoch golden fails on the card with kernel "
                 f"{kernel}: {v}")
    return out


# the reference configurations' depth: one epoch of REF_LIMIT rows, 128
# steps serially and 64 a rank on REF_RANKS ranks
REF_LIMIT = 16384
REF_RANKS = 2
# an epoch line's accuracy against the CPU run's: the losses are held at
# TRAIN_RTOL; a test sample within rounding of a tie may flip its argmax
REF_ACC_ATOL = 0.002
# (name, reference script, launcher, train arguments)
REF_CONFIGS = (
    ("serial", "ddp_tutorial_cpu.py", "serial", ()),
    ("serial --netcdf", "mnist_pnetcdf_cpu.py", "serial", ("--netcdf",)),
    ("torchrun x2 --parallel", "ddp_tutorial_multi_gpu.py", "torchrun",
     ("--parallel",)),
    ("env x2 --parallel", "mnist_cpu_mp.py", "env",
     ("--parallel", "--wireup_method", "env")),
    ("mpich x2 --netcdf --parallel", "mnist_pnetcdf_cpu_mp.py", "mpich",
     ("--netcdf", "--parallel", "--wireup_method", "mpich")),
)
# each --netcdf run and the IDX run it must equal bitwise
REF_NETCDF_TWINS = {"serial --netcdf": "serial",
                    "mpich x2 --netcdf --parallel": "env x2 --parallel"}
_NUMS = re.compile(r"^Epoch=0, train_loss=([-0-9.e]+), val_loss=([-0-9.e]+)  "
                   r"\[mean_train=([-0-9.e]+) mean_val=([-0-9.e]+) "
                   r"acc=([-0-9.e]+) ", re.M)


def world_rank_front(out: str, argv: list) -> None:
    """A process that runs `python -m pytorch_ddp_mnist_tpu_torch train
    ARGV` (the package's __main__, through runpy) and saves its launches and
    CUDA graph captures to out/front-rank<rank>.json."""
    import runpy
    from pytorch_ddp_mnist_tpu_torch.train import graphs
    _reset_counts()
    captures = graphs.counts["captures"]
    sys.argv = ["pytorch_ddp_mnist_tpu_torch", "train", *argv]
    try:
        runpy.run_module("pytorch_ddp_mnist_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    rank = os.environ.get("RANK", os.environ.get("PMI_RANK", "0"))
    with open(os.path.join(out, f"front-rank{rank}.json"), "w") as f:
        json.dump({"launches": _counts(),
                   "captures": graphs.counts["captures"] - captures}, f)


def _ref_cmds(name: str, launcher: str, train: list, out: str):
    """(argv, env) pairs of one configuration's processes, as a function of
    the attempt (a new port each); rank 0 first."""
    front = [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--world-rank", "front", "--out", out, "--", *train]
    if launcher == "serial":
        return lambda attempt: [(front, _rank_env())]
    if launcher == "torchrun":
        return _torchrun(REF_RANKS, front[1:])
    if launcher == "env":
        return _env_world(REF_RANKS, front)

    def mpich(attempt):   # the variables MPICH's mpiexec (Hydra) sets
        port = _free_port()
        return [(front, _rank_env(PMI_RANK=r, PMI_SIZE=REF_RANKS,
                                  MPI_LOCALRANKID=r,
                                  MPI_LOCALNRANKS=REF_RANKS,
                                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
                for r in range(REF_RANKS)]
    return mpich


def _ref_line(out: str, what: str) -> tuple:
    found = _NUMS.findall(out)
    if len(found) != 1:
        fail(f"{what}: {len(found)} epoch lines in its output:\n{out[-2000:]}")
    return found[0]


def _ref_wave(where: str, tmp: str, nc_dir: str, idx_dir: str) -> dict:
    """The five configurations on the card (`where` = "card") or the CPU,
    all at once: {(where, name): {"out": rank 0's stdout, "line": its
    epoch line's numbers, "ranks": each rank's launches and captures,
    "ckpt": rank 0's checkpoint}}."""
    cmds, tags = [], []
    for name, _, launcher, extra in REF_CONFIGS:
        out = os.path.join(tmp, "ref", where, name.replace(" ", "_"))
        os.makedirs(out, exist_ok=True)
        train = ["--n_epochs", "1", "--limit", str(REF_LIMIT),
                 "--batch_size", str(MAIN_BATCH), "--lr", str(LR),
                 "--seed", "0", "--checkpoint", os.path.join(out, "model.pt"),
                 "--path", nc_dir if "--netcdf" in extra else idx_dir,
                 *extra]
        if where == "cpu":   # the same step's plain version, same masks
            train += ["--device", "cpu", "--kernel", "pallas"]
        tags.append((name, out))
        cmds.append(_ref_cmds(name, launcher, train, out))
    res = _spawn(lambda attempt: [pair for c in cmds for pair in c(attempt)],
                 tmp)
    runs, at = {}, 0
    for (name, out), c in zip(tags, cmds):
        text = res[at][1]           # rank 0's (or torchrun's) stdout
        at += len(c(0))
        ranks = [json.load(open(os.path.join(out, f)))
                 for f in sorted(os.listdir(out)) if f.startswith("front")]
        runs[where, name] = {"out": text, "ranks": ranks,
                             "line": _ref_line(text, f"{name} on the {where}"),
                             "ckpt": os.path.join(out, "model.pt")}
    return runs


def phase_main_reference(device, tmp: str, card: str) -> dict:
    """The reference's five configurations through `python -m
    pytorch_ddp_mnist_tpu_torch train` (see the module docstring, n), the
    card runs all at once, then their CPU runs all at once. Returns each
    card configuration's rank-0 launches."""
    from pytorch_ddp_mnist_tpu_torch.data import native
    t0 = time.perf_counter()
    nc_dir, idx_dir = os.path.join(tmp, "ref_nc"), os.path.join(tmp, "ref_no")
    conv = subprocess.run([sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch",
                           "convert", "--synthetic", "60000:10000",
                           "--out_dir", nc_dir], cwd=REPO, env=_rank_env(),
                          capture_output=True, text=True, timeout=300)
    if conv.returncode != 0:
        fail(f"convert exited {conv.returncode}: {conv.stderr[-2000:]}")
    if not native.native_available():
        fail(f"the native reader core did not build on this machine: "
             f"{native.native_build_error()}")
    runs = {}
    for where in ("card", "cpu"):
        runs.update(_ref_wave(where, tmp, nc_dir, idx_dir))
        print(f"[ref] {where}: the five configurations in "
              f"{time.perf_counter() - t0:.1f}s from the phase's start")
    launches = {}
    for name, script, launcher, extra in REF_CONFIGS:
        card_run, cpu_run = runs["card", name], runs["cpu", name]
        n_rank = 1 if launcher == "serial" else REF_RANKS
        steps = REF_LIMIT // (MAIN_BATCH * n_rank)
        if len(card_run["ranks"]) != n_rank:
            fail(f"{name}: {len(card_run['ranks'])} ranks reported, "
                 f"expected {n_rank}")
        for r, rank in enumerate(card_run["ranks"]):
            expect_launches(rank["launches"], {"fused_split_keyed": steps},
                            f"reference config {name!r}, rank {r}")
            want = 1 if launcher == "serial" else 0
            if rank["captures"] != want:
                fail(f"{name}: rank {r} captured {rank['captures']} CUDA "
                     f"graphs, expected {want}")
        for rank in cpu_run["ranks"]:
            expect_launches(rank["launches"], {}, f"{name} on the CPU")
        if "--netcdf" in extra and "read by the native core" not in \
                card_run["out"]:
            fail(f"{name}: the [data] line does not name the native reader "
                 f"core:\n{card_run['out'][-1500:]}")
        got = [float(v) for v in card_run["line"]]
        ref = [float(v) for v in cpu_run["line"]]
        rel = max(abs(g - c) / abs(c) for g, c in zip(got[:4], ref[:4]))
        if rel > TRAIN_RTOL or abs(got[4] - ref[4]) > REF_ACC_ATOL:
            fail(f"{name}: epoch line {card_run['line']} off the CPU run's "
                 f"{cpu_run['line']} (losses rtol {TRAIN_RTOL}, acc atol "
                 f"{REF_ACC_ATOL})")
        launches[f"reference {name}"] = card_run["ranks"][0]["launches"]
        print(f"[ref] {name} ({script}, {launcher}): {steps} steps a rank, "
              f"line {card_run['line']}; the CPU run's {cpu_run['line']}, "
              f"worst loss rel diff {rel:.3e} (rtol {TRAIN_RTOL})")
    for nc_name, idx_name in REF_NETCDF_TWINS.items():
        for where in ("card", "cpu"):
            a, b = runs[where, nc_name], runs[where, idx_name]
            sa = torch.load(a["ckpt"])
            sb = torch.load(b["ckpt"])
            if a["line"] != b["line"] or not all(
                    torch.equal(sa[k], sb[k]) for k in sb):
                fail(f"{nc_name} on the {where} is not bitwise {idx_name} "
                     f"on the same bytes: {a['line']} vs {b['line']}")
        print(f"[ref] {nc_name} bitwise {idx_name} (epoch line and rank-0 "
              f"checkpoint), on the card and on the CPU")
    print(f"[ref] the five configurations: "
          f"{time.perf_counter() - t0:.1f}s [{card}]")
    return launches


def phase_streams() -> None:
    """Whether this machine's torch CPU randperm and bernoulli_ draw the
    port's copy's streams (parallel/torch_rng.py calls torch's own; the
    copy is their plain version). Fails where they do not."""
    from pytorch_ddp_mnist_tpu_torch.parallel import torch_rng as tr
    perms = [(n, s) for n in (60000, 10000, 1877, 7) for s in (0, 42, 43)]
    for n, seed in perms:
        if not np.array_equal(tr.torch_randperm(n, seed),
                              tr.torch_randperm_plain(n, seed)):
            fail(f"torch.randperm({n}) seeded {seed} is not the copy's "
                 f"stream on this machine ({torch.__version__})")
    draws = 0
    for seed in (0, 1, 12345, 2**31 + 7):
        stream, plain = tr.MaskStream(seed), tr.TorchMT19937(seed)
        for n, p in ((128 * 128, 0.8), (3 * 128, 0.8), (1000, 0.5)):
            draws += n
            if not np.array_equal(stream.draw(n, p),
                                  tr.torch_bernoulli_plain(plain, n, p)):
                fail(f"bernoulli_({p}) seeded {seed} is not the copy's "
                     f"stream on this machine ({torch.__version__})")
    print(f"[streams] torch {torch.__version__}: CPU randperm draws the "
          f"copy's stream ({len(perms)} permutations) and CPU bernoulli_ "
          f"draws it ({draws} values over 4 seeds)")


def phase_torch_dropout(device, tmp: str) -> dict:
    """`--dropout_rng torch` on the card: 3 captured steps bitwise the same
    steps run eagerly on the same masks (step 2 replays slot 0 after its
    mask changed), no hand-written kernel launched; then `train
    --sampler_rng torch --dropout_rng torch --eval_shuffle` against the same
    command on the CPU. Returns the CLI run's launches."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.train import graphs, loop
    x_all, y_all = _main_data(3 * MAIN_BATCH)
    x_all = x_all.reshape(3, MAIN_BATCH, -1)
    y_all = y_all.reshape(3, MAIN_BATCH)
    step = loop.make_torch_dropout_train_step(LR, 0)
    masks = [step.draw(MAIN_BATCH) for _ in range(3)]
    if np.array_equal(masks[0], masks[2]):
        fail("the torch mask stream repeated a mask")
    out = {}
    _reset_counts()
    captures = graphs.counts["captures"]
    for eager in (False, True):
        model = MLP.from_seed(0).to(device)
        steps, slots, _ = loop._captured_steps(step, model, 3, MAIN_BATCH,
                                               device, eager=eager)
        steps.start_epoch()
        for s in range(3):
            for slot, a in zip(slots, (x_all[s], y_all[s], masks[s])):
                slot[s % 2].copy_(torch.from_numpy(a))
            steps.step()
        out[eager] = (steps.losses().cpu(), {n: {k: v.detach().cpu()
                      for k, v in l.items()} for n, l in model.params().items()})
    if graphs.counts["captures"] - captures != 1:
        fail("the captured --dropout_rng torch loop did not capture once")
    expect_launches(_counts(), {}, "the --dropout_rng torch steps")
    if not (torch.equal(out[False][0], out[True][0])
            and _equal_trees(out[False][1], out[True][1])):
        fail(f"--dropout_rng torch: the captured steps' losses "
             f"{out[False][0].tolist()} are not the eager steps' "
             f"{out[True][0].tolist()} bitwise")
    print(f"[dropout] 3 captured --dropout_rng torch steps bitwise the eager "
          f"steps on the same masks, step 2 replayed on slot 0's new mask; "
          f"losses {out[False][0].tolist()}")
    argv = ["--n_epochs", "1", "--limit", str(20 * MAIN_BATCH), "--seed", "0",
            "--sampler_rng", "torch", "--dropout_rng", "torch",
            "--eval_shuffle", "--checkpoint", "",
            "--path", os.path.join(tmp, "no_mnist_here")]
    _reset_counts()
    _, history, text = _run_trainer(cli_train, argv)
    launches = _counts()
    expect_launches(launches, {}, "train --dropout_rng torch")
    _, cpu_history, cpu_text = _run_trainer(cli_train,
                                            ["--device", "cpu", *argv])
    rel = np.abs(history[0] - cpu_history[0]) / np.abs(cpu_history[0])
    got, ref = _ref_line(text, "torch streams"), _ref_line(cpu_text, "cpu")
    line_rel = max(abs(float(g) - float(c)) / abs(float(c))
                   for g, c in zip(got[:4], ref[:4]))
    if not (rel <= TRAIN_RTOL).all() or line_rel > TRAIN_RTOL:
        fail(f"train --dropout_rng torch: per-step losses off the CPU run's "
             f"by {rel.max():.3e}, the line by {line_rel:.3e} (rtol "
             f"{TRAIN_RTOL})")
    print(f"[dropout] train --sampler_rng torch --dropout_rng torch "
          f"--eval_shuffle, 20 steps: per-step losses vs the CPU run worst "
          f"rel diff {rel.max():.3e}, line {line_rel:.3e} (rtol "
          f"{TRAIN_RTOL}); no hand-written kernel launched")
    return launches


def phase_data_benches(card: str) -> None:
    """`bench --mode stream` and `bench --mode accuracy` through the front
    door, each line printed and checked."""
    lines = {}
    for mode in ("stream", "accuracy"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch",
                            "bench", "--mode", mode], cwd=REPO,
                           env=_rank_env(), capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            fail(f"bench --mode {mode} exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        line = r.stdout.strip().splitlines()[-1]
        lines[mode] = json.loads(line)
        print(f"[bench] --mode {mode} ({time.perf_counter() - t0:.1f}s, "
              f"{card}): {line}")
    stream, acc = lines["stream"], lines["accuracy"]
    if stream["core"] != "native" or not stream["value"] > 0 \
            or "mfu_pct_vs_bf16_peak" in stream:
        fail(f"bench --mode stream: {stream}")
    ratio = acc["mean_val_loss"] / acc["ref_mean_val_loss"]
    if not (abs(acc["vs_baseline"] - 1) <= 0.01 and abs(ratio - 1) <= 0.05):
        fail(f"bench --mode accuracy: the resolved configuration's accuracy "
             f"ratio {acc['vs_baseline']} or val-loss ratio {ratio:.4f} is "
             f"off the reference configuration's (bounds 0.01, 0.05)")


# the serve phase (phase_serve): the engine's ladder at max_batch 64 (7
# buckets), the card's logits against the CPU engine's at the port's forward
# tolerance (f32 summation order only), the flush times' buckets, the
# in-process load and the offered rate of the saturation sweep
SERVE_MAX_BATCH = 64
SERVE_BUCKETS = 7
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6
SERVE_LOAD = (2000, 4000.0)           # requests, offered rps
# past what one event loop answers on the card's host (18,940 of 20,000
# offered were answered in the first card run): the saturation sweep
SERVE_SATURATE = (6000, 60000.0)      # requests, offered rps
SERVE_LIMIT_S = 300                   # each serve subprocess's own limit


@contextlib.contextmanager
def _graph_captures():
    """Count every CUDA-graph capture begun in this process while open."""
    n = [0]
    orig = torch.cuda.CUDAGraph.capture_begin

    def counting(self, *a, **kw):
        n[0] += 1
        return orig(self, *a, **kw)

    torch.cuda.CUDAGraph.capture_begin = counting
    try:
        yield n
    finally:
        torch.cuda.CUDAGraph.capture_begin = orig


def _serve_groups(service, groups) -> list:
    """Each group of rows submitted together and flushed as ONE batch;
    returns the served preds per group."""
    import asyncio

    async def scenario():
        out = []
        for rows in groups:
            subs = [asyncio.ensure_future(service.handle(r)) for r in rows]
            await asyncio.sleep(0)
            service.batcher.flush()
            out.append(np.asarray(await asyncio.gather(*subs), np.int32))
        await service.shutdown()
        return out

    return asyncio.run(scenario())


def _flush_ms(engine, bucket: int, replay_only: bool, iters: int = 200,
              warmup: int = 20) -> float:
    """CUDA-event time on the engine's stream of one flush of `bucket` (H2D
    from a pinned slab, replay, D2H into its pinned buffers), or of the
    bucket graph's replay alone."""
    slab = engine._new_slab(bucket)
    stream = engine._stream
    rung = engine._rungs[bucket]

    def once():
        if replay_only:
            with torch.cuda.stream(stream):
                rung.graph.replay()
        else:
            engine._launch(slab, bucket)
    for _ in range(warmup):
        once()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(iters):
        once()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / iters


def _serve_cli(argv: list, what: str) -> tuple:
    """`python -m pytorch_ddp_mnist_tpu_torch <argv>` on the card: (its last
    stdout line as JSON, stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch",
                        *argv], cwd=REPO, env=_rank_env(),
                       capture_output=True, text=True, timeout=SERVE_LIMIT_S)
    if r.returncode != 0:
        fail(f"{what} exited {r.returncode}: {r.stderr[-3000:]}")
    return (json.loads(r.stdout.strip().splitlines()[-1]), r.stderr,
            time.perf_counter() - t0)


def _ask(f, req: dict) -> dict:
    """One JSON-lines request over the server connection `f`."""
    f.write(json.dumps(req) + "\n")
    f.flush()
    return json.loads(f.readline())


def _serve_tcp(argv: list, converse, what: str) -> tuple:
    """`serve --port 0 <argv>` in a session of its own: `converse(f)` talks
    over one connection (`f` a read-write file of JSON lines), then SIGTERM
    and the drain. Returns (what converse returned, the final snapshot)."""
    import signal
    import socket
    proc = subprocess.Popen([sys.executable, "-m",
                             "pytorch_ddp_mnist_tpu_torch", "serve", "--port",
                             "0", *argv], cwd=REPO,
                            env=_rank_env(), text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, start_new_session=True)
    try:
        deadline = time.monotonic() + SERVE_LIMIT_S
        err = []
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                fail(f"{what} exited {proc.wait()} before serving: "
                     f"{''.join(err)[-3000:]}")
            err.append(line)
            if line.startswith("serving on "):
                host, port = line.split()[-1].rsplit(":", 1)
                break
        else:
            fail(f"{what} did not start serving in time")
        # the file object holds the socket open: close both before the
        # drain, which waits for every connection to end
        with socket.create_connection((host, int(port)), timeout=60) as sock, \
                sock.makefile("rw") as f:
            result = converse(f)
        os.killpg(proc.pid, signal.SIGTERM)
        out, rest = proc.communicate(timeout=SERVE_LIMIT_S)
    finally:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        fail(f"{what}: rc {proc.returncode}: {''.join(err)[-2000:]}"
             f"{rest[-2000:]}")
    return result, json.loads(out.strip().splitlines()[-1])


def phase_serve(device, tmp: str, card: str) -> dict:
    """The serving path on the card (serve/, cli/serve.py, bench --mode eval
    and serve), from the checkpoint phase_main_streaming saved: for f32 and
    uint8 rows, an engine of max_batch 64 captures its 7 bucket graphs and
    no more (none during the checks and an in-process load); its logits
    within SERVE_RTOL / SERVE_ATOL of the CPU engine's on every bucket and
    a chunked batch, its preds equal; each bucket's staged flush, launched
    under torch.cuda.set_sync_debug_mode("error"), bitwise the direct
    forward; the fast and the legacy batcher bitwise the direct preds; no
    hand-written kernel launched. Then one captured flush's time at every
    bucket; `serve --selftest 2000`; one TCP request through `serve --port
    0`; `bench --mode eval` and `bench --mode serve` at the JAX defaults and
    one offered rate past saturation, each printed on a [serve] line."""
    from pytorch_ddp_mnist_tpu_torch.serve import InferenceEngine, ServeService
    from pytorch_ddp_mnist_tpu_torch.serve.loadgen import (request_rows,
                                                           run_loadgen)
    from pytorch_ddp_mnist_tpu_torch.train.graphs import _set_sync_debug_mode
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "model.pt")
    if not os.path.exists(ckpt):
        fail(f"phase_serve: no checkpoint at {ckpt}")
    report = {}
    _reset_counts()
    for dtype in ("float32", "uint8"):
        with _graph_captures() as built:
            eng = InferenceEngine.from_checkpoint(
                ckpt, max_batch=SERVE_MAX_BATCH, device=device,
                input_dtype=dtype)
        if not (len(eng.buckets) == SERVE_BUCKETS == eng.capture_count
                == built[0]):
            fail(f"serve engine ({dtype}): buckets {eng.buckets}, "
                 f"capture_count {eng.capture_count}, captures {built[0]}")
        cpu = InferenceEngine.from_checkpoint(
            ckpt, max_batch=SERVE_MAX_BATCH, device="cpu", input_dtype=dtype)
        worst = 0.0
        with _graph_captures() as later:
            for n in eng.buckets + (3, 150):
                rows = request_rows(n, dtype, seed=100 + n)
                got, want = eng.forward(rows), cpu.forward(rows)
                if not (np.allclose(got, want, rtol=SERVE_RTOL,
                                    atol=SERVE_ATOL)
                        and np.array_equal(eng.predict(rows),
                                           cpu.predict(rows))):
                    fail(f"serve engine ({dtype}) at {n} rows: the card's "
                         f"logits are off the CPU engine's by "
                         f"{np.abs(got - want).max():.3e}, or the preds "
                         f"differ")
                worst = max(worst, float(np.abs(got - want).max()))
            for b in eng.buckets:
                n = max(1, b - 1)               # a pad row where b > 1
                rows = request_rows(n, dtype, seed=200 + b)
                eng.staging()[:n] = rows
                mode = torch.cuda.get_sync_debug_mode()
                _set_sync_debug_mode("error")
                try:
                    handle = eng.dispatch_staged(n)
                finally:
                    _set_sync_debug_mode(mode)
                logits, preds = eng.fetch_staged(handle)
                if not (np.array_equal(logits, eng.forward(rows))
                        and np.array_equal(preds, eng.predict(rows))):
                    fail(f"serve engine ({dtype}): the staged flush of {n} "
                         f"rows (bucket {b}) is not the direct forward "
                         f"bitwise")
            groups = [request_rows(n, dtype, seed=300 + n)
                      for n in (1, 2, 3, 5, 8, 13, 32, 64)]
            dispatch = eng.dispatch_staged

            def no_sync_dispatch(n, bctx=None):
                # the loop's dispatch may not wait for the card
                mode = torch.cuda.get_sync_debug_mode()
                _set_sync_debug_mode("error")
                try:
                    return dispatch(n, bctx)
                finally:
                    _set_sync_debug_mode(mode)
            for fast in (True, False):
                svc = ServeService(eng, max_delay_ms=1000.0, max_depth=256,
                                   fast=fast)
                eng.dispatch_staged = no_sync_dispatch
                try:
                    served_groups = _serve_groups(svc, groups)
                finally:
                    del eng.dispatch_staged
                for rows, served in zip(groups, served_groups):
                    if not np.array_equal(served, eng.predict(rows)):
                        fail(f"serve ({dtype}, fast={fast}): {len(rows)} "
                             f"served preds are not the direct preds")
            n_load, rps = SERVE_LOAD
            svc = ServeService(eng, max_delay_ms=2.0, max_depth=256)
            load = run_loadgen(svc, offered_rps=rps, n_requests=n_load,
                               seed=7)
            rows = request_rows(n_load, dtype, seed=8)
            if load["completed"] != n_load or not np.array_equal(
                    np.asarray(load["predictions"], np.int32),
                    eng.predict(rows)):
                fail(f"serve ({dtype}): the load answered "
                     f"{load['completed']} of {n_load}, or not the direct "
                     f"preds")
        if later[0] or eng.capture_count != SERVE_BUCKETS:
            fail(f"serve ({dtype}): {later[0]} captures after warm-up "
                 f"(capture_count {eng.capture_count})")
        print(f"[serve] engine {dtype}, max_batch {SERVE_MAX_BATCH}: "
              f"buckets {list(eng.buckets)}, {eng.capture_count} captures "
              f"at construction and none after ({n_load} requests at "
              f"{rps:.0f} rps, {load['batches']} flushes, p99 "
              f"{load['latency_ms']['p99']} ms); card vs CPU engine worst "
              f"|logit diff| {worst:.3e} (rtol {SERVE_RTOL}, atol "
              f"{SERVE_ATOL}), preds equal; staged flush bitwise direct at "
              f"every bucket with no sync in its dispatch; fast (no sync in "
              f"the loop's dispatches) and legacy batcher bitwise direct "
              f"[{card}]")
        report[f"worst_{dtype}"] = worst
        if dtype == "float32":
            report["flush_ms"] = {
                b: (_flush_ms(eng, b, False), _flush_ms(eng, b, True))
                for b in eng.buckets}
            row = request_rows(1, dtype, seed=9)[0]
            tcp_want = int(eng.predict(row[None])[0])
        eng.close()
    expect_launches(_counts(), {}, "the serve path")
    for b, (flush, replay) in report["flush_ms"].items():
        print(f"[serve] one captured flush at bucket {b}: {flush * 1e3:.2f} "
              f"us on the engine's stream (H2D + replay + D2H), the replay "
              f"alone {replay * 1e3:.2f} us (CUDA events, 200 calls) [{card}]")
    st, err, dt = _serve_cli(["serve", "--selftest", "2000", "--checkpoint",
                              ckpt], "serve --selftest 2000")
    if st["completed"] + st["rejected"] != 2000 or "captures=7" not in err:
        fail(f"serve --selftest 2000: {st}; {err[-1000:]}")
    print(f"[serve] serve --selftest 2000 ({dt:.1f}s): {json.dumps(st)} "
          f"[{card}]")
    (pixels, metrics), final = _serve_tcp(
        ["--checkpoint", ckpt],
        lambda f: (_ask(f, {"pixels": row.tolist()}),
                   _ask(f, {"op": "metrics"})), "serve --port 0")
    pred = pixels.get("pred")
    if pred != tcp_want or metrics.get("completed") != 1 \
            or final.get("completed") != 1:
        fail(f"serve over TCP: pred {pred} (direct {tcp_want}), metrics "
             f"{metrics}, final {final}")
    print(f"[serve] serve --port 0: one TCP pixels request answered pred "
          f"{pred} (the direct engine's), metrics op answered, drained on "
          f"SIGTERM [{card}]")
    for argv in (["--mode", "eval"], ["--mode", "serve"],
                 ["--mode", "serve", "--offered_rps", str(SERVE_SATURATE[1]),
                  "--requests", str(SERVE_SATURATE[0])]):
        line, _, dt = _serve_cli(["bench", *argv], f"bench {' '.join(argv)}")
        if not (line["value"] and line["value"] > 0):
            fail(f"bench {' '.join(argv)}: {line}")
        if argv[1] == "serve" and (line["compile_count"] != SERVE_BUCKETS
                                   or line["availability"] != 1.0):
            fail(f"bench {' '.join(argv)}: {line}")
        report[" ".join(argv)] = line
        print(f"[serve] bench {' '.join(argv)} ({dt:.1f}s): "
              f"{json.dumps(line)} [{card}]")
    print(f"[serve] phase_serve: {time.perf_counter() - t0:.1f}s")
    return report


# ---- slice 20: the replica fleet and hot reload ----

FLEET_REPLICAS = 2
# the survivor's turns: requests a turn and their offered rate (the
# restart turn also keeps sending until the rebuilt replica is back)
FLEET_TURN = (400, 2000.0)
FLEET_CHAOS = (200, 800.0)          # requests, offered rps a load leg
FLEET_SETTLE_S = 60.0


def _fleet_ready(fleet) -> bool:
    return all(r.state == "healthy" for r in fleet.replicas)


async def _survivor_turn(fleet, rows, restart: bool) -> dict:
    """One turn of FLEET_TURN requests at their rate through `fleet`; with
    `restart`, replica 0's engine crashes at its next launch (the first
    request goes to it) and the turn goes on sending until the rebuilt
    replica is back. Returns the preds, the latencies of the requests
    sent while replica 0 was rebuilding (all of them when undisturbed),
    and the rebuild's wall."""
    import asyncio
    from pytorch_ddp_mnist_tpu_torch.utils import faultpoints
    n_min, rps = FLEET_TURN
    if restart:
        faultpoints.install("engine_crash:replica=0")
    preds, lat, tasks = {}, [], []

    async def one(i, during):
        t = time.perf_counter()
        preds[i] = await fleet.handle(rows[i % len(rows)])
        if during or not restart:
            lat.append(time.perf_counter() - t)

    t0, i = time.perf_counter(), 0
    try:
        deadline = t0 + FLEET_SETTLE_S
        while i < n_min or (restart and not _fleet_ready(fleet)):
            if time.perf_counter() > deadline:
                fail(f"fleet: replica 0 not rebuilt within "
                     f"{FLEET_SETTLE_S:.0f}s: "
                     f"{[r.state for r in fleet.replicas]}")
            during = fleet.replicas[0].state != "healthy"
            tasks.append(asyncio.ensure_future(one(i, during)))
            i += 1
            await asyncio.sleep(max(0.0, t0 + i / rps - time.perf_counter()))
        await asyncio.gather(*tasks)
    finally:
        faultpoints.install("")
    return {"n": i, "preds": preds, "lat": sorted(lat)}


def _reload_conversation(row: np.ndarray, commit):
    """The fleet server's conversation: a pixels request and a health
    request, then `commit()` writes step 1 under the reload directory and
    the health op is polled until every replica serves it; a pixels
    request again. Returns (pred before, health before, pred after, health
    after, seconds to the reload)."""
    def converse(f):
        before = _ask(f, {"pixels": row.tolist()})
        health0 = _ask(f, {"op": "health"})
        commit()
        t0 = time.perf_counter()
        while True:
            # serving_step moves when the swap starts; the replicas'
            # generations when each has swapped behind its drain
            health1 = _ask(f, {"op": "health"})
            if all(r["generation"] == 1 for r in
                   health1["health"]["fleet"]["per_replica"]):
                break
            if time.perf_counter() - t0 > 60:
                fail(f"serve --reload_dir: step 1 not served within 60s: "
                     f"{health1}")
            time.sleep(0.05)
        reload_s = time.perf_counter() - t0
        after = _ask(f, {"pixels": row.tolist()})
        return (before.get("pred"), health0, after.get("pred"), health1,
                reload_s)
    return converse


def phase_fleet(device, tmp: str, card: str) -> dict:
    """The replica fleet and hot reload on the card (serve/fleet.py,
    serve/reload.py, serve_chaos.py, `serve --replicas`, `bench --mode
    serve --replicas`), from the checkpoint phase_main_streaming saved: a
    2-replica fleet of max_batch 64 captures 14 graphs at construction and
    7 a restart; the survivor's preds bitwise the direct engine's while
    its sibling rebuilds under load, and its p50 / p99 against an
    undisturbed turn, in turns; serve_chaos.py's three legs on the card
    (availability 1.0, preds bitwise direct, no replica dead or off the
    card, 7 captures an engine built and no other, the record contract);
    `serve --replicas 2 --wedge_timeout_ms 250 --retry_budget 2
    --reload_dir DIR` over TCP, reloading a step committed under DIR;
    `bench --mode serve --replicas 2` and `--replicas 1`, in turns. No
    hand-written kernel launched."""
    import asyncio
    from pytorch_ddp_mnist_tpu_torch import serve_chaos
    from pytorch_ddp_mnist_tpu_torch.models.mlp import init_params
    from pytorch_ddp_mnist_tpu_torch.serve import FleetService, InferenceEngine
    from pytorch_ddp_mnist_tpu_torch.serve.loadgen import request_rows
    from pytorch_ddp_mnist_tpu_torch.serve.metrics import nearest_rank
    from pytorch_ddp_mnist_tpu_torch.telemetry import MetricsRegistry, flight
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
    from pytorch_ddp_mnist_tpu_torch.train.ckpt_manager import \
        CheckpointManager
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "model.pt")
    if not os.path.exists(ckpt):
        fail(f"phase_fleet: no checkpoint at {ckpt}")
    params = load_checkpoint(ckpt, init_params(0))
    report = {}
    _reset_counts()

    def build(p):
        return InferenceEngine(p, max_batch=SERVE_MAX_BATCH, device=device)

    direct = build(params)
    rows = request_rows(FLEET_TURN[0], "float32", seed=21)
    want = direct.predict(rows)
    t1 = time.perf_counter()
    with _graph_captures() as built:
        fleet = FleetService(build, params, n_replicas=FLEET_REPLICAS,
                             max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0,
                             wedge_timeout_s=0.25, retry_budget=2,
                             registry=MetricsRegistry())
    construct_s = time.perf_counter() - t1
    if built[0] != FLEET_REPLICAS * SERVE_BUCKETS:
        fail(f"fleet: {built[0]} captures at construction, not "
             f"{FLEET_REPLICAS} x {SERVE_BUCKETS}")

    async def turns():
        out = []
        try:
            for restart in (False, True, True, False):
                out.append((restart, await _survivor_turn(fleet, rows,
                                                          restart)))
            return out, fleet.fleet_snapshot()
        finally:
            await fleet.shutdown()

    with _graph_captures() as rebuilt:
        results, snap = asyncio.run(turns())
    restarts = [e for e in flight.get_flight_recorder().snapshot()
                if e["kind"] == "fleet_event" and e.get("event") == "restart"]
    if snap["restarts"] != 2 or rebuilt[0] != 2 * SERVE_BUCKETS \
            or snap["healthy"] != FLEET_REPLICAS or len(restarts) < 2:
        fail(f"fleet: 2 restarts should capture {2 * SERVE_BUCKETS} graphs "
             f"and leave every replica healthy: {rebuilt[0]} captures, "
             f"{snap}")
    if any(rep.engine.device != device for rep in fleet.replicas):
        fail(f"fleet: a rebuilt engine is off {device}")
    stats = {True: [], False: []}
    for restart, r in results:
        got = np.asarray([r["preds"][i] for i in range(r["n"])], np.int32)
        if not np.array_equal(got, want[np.arange(r["n"]) % len(want)]):
            fail(f"fleet: the {'restart' if restart else 'undisturbed'} "
                 f"turn's preds are not the direct engine's")
        if r["lat"]:
            stats[restart].append((nearest_rank(r["lat"], 0.5) * 1e3,
                                   nearest_rank(r["lat"], 0.99) * 1e3,
                                   len(r["lat"])))
    if not stats[True]:
        fail("fleet: no request was sent while a replica rebuilt")
    dur = [e["dur_s"] for e in restarts[-2:]]
    report.update(construct_s=construct_s, restart_dur_s=dur,
                  survivor=stats[True], undisturbed=stats[False])
    print(f"[fleet] {FLEET_REPLICAS} replicas of max_batch "
          f"{SERVE_MAX_BATCH}: {built[0]} captures at construction "
          f"({construct_s:.3f} s), {rebuilt[0]} for 2 restarts (restart wall "
          f"dur_s {dur}); the survivor's preds bitwise the direct engine's "
          f"while its sibling rebuilt [{card}]")
    for restart in (False, True):
        what = ("survivor during a restart" if restart
                else "undisturbed fleet")
        for p50, p99, n in stats[restart]:
            print(f"[fleet] {what}: p50 {p50:.3f} ms, p99 {p99:.3f} ms over {n} requests at "
                  f"{FLEET_TURN[1]:.0f} rps offered (turns undisturbed, "
                  f"restart, restart, undisturbed) [{card}]")
    n_req, rps = FLEET_CHAOS
    with _graph_captures() as chaos_caps:
        verdict = serve_chaos.run(device, requests=n_req, offered_rps=rps,
                                  max_batch=SERVE_MAX_BATCH,
                                  workdir=os.path.join(tmp, "serve_chaos"))
    engines = 1 + sum(v["engines_built"] for v in verdict["legs"].values())
    if verdict["serve_chaos"] != "ok" or verdict["availability"] != 1.0:
        fail(f"serve_chaos on the card: {json.dumps(verdict)}")
    if chaos_caps[0] != engines * SERVE_BUCKETS:
        fail(f"serve_chaos: {chaos_caps[0]} captures for {engines} engines "
             f"of {SERVE_BUCKETS} buckets")
    legs = verdict["legs"]
    report["serve_chaos"] = verdict
    print(f"[fleet] serve_chaos.py on the card ({verdict['dur_s']} s): "
          f"availability {verdict['availability']}, kill-mid-burst "
          f"{json.dumps(legs['kill_mid_burst'])}, wedge-then-watchdog "
          f"{json.dumps(legs['wedge_then_watchdog'])}, torn-checkpoint-swap "
          f"{json.dumps(legs['torn_checkpoint_swap'])} (reload wall "
          f"serve.reload.last_reload_s), record contract "
          f"{verdict['record_contract']}; {chaos_caps[0]} captures for "
          f"{engines} engines [{card}]")
    reload_dir = os.path.join(tmp, "fleet_reload")
    params_new = init_params(1)
    row = request_rows(1, "float32", seed=22)[0]
    want_before = int(direct.predict(row[None])[0])
    new = build(params_new)
    want_after = int(new.predict(row[None])[0])
    new.close()
    direct.close()

    def commit():
        CheckpointManager(reload_dir).save(
            params_new, np.zeros(2, np.uint32), "threefry2x32", step=1,
            epoch=0, offset=0)

    (before, h0, after, h1, reload_s), _ = _serve_tcp(
        ["--checkpoint", ckpt, "--replicas", str(FLEET_REPLICAS),
         "--wedge_timeout_ms", "250", "--retry_budget", "2", "--reload_dir",
         reload_dir], _reload_conversation(row, commit),
        "serve --replicas 2 --reload_dir")
    f0, f1 = h0["health"]["fleet"], h1["health"]["fleet"]
    if (before, after) != (want_before, want_after) \
            or (f0["replicas"], f0["healthy"], f0["serving_step"]) \
            != (FLEET_REPLICAS, FLEET_REPLICAS, -1) \
            or (f1["generation"], f1["serving_step"], f1["healthy"]) \
            != (1, 1, FLEET_REPLICAS):
        fail(f"serve --replicas 2 --reload_dir: preds {before}, {after} "
             f"(direct {want_before}, {want_after}), fleet {f0} -> {f1}")
    print(f"[fleet] serve --replicas 2 --wedge_timeout_ms 250 --retry_budget "
          f"2 --reload_dir: a TCP request answered the direct pred, the "
          f"health op's fleet block {json.dumps(f0)}; a step committed under "
          f"the directory served by every replica {reload_s:.3f} s later "
          f"(health polled every 50 ms), the next request answered the new "
          f"weights' direct pred; drained on SIGTERM [{card}]")
    for n in (FLEET_REPLICAS, 1):          # in turns: 2, then 1
        what = f"bench --mode serve --replicas {n}"
        line, _, dt = _serve_cli(what.split(), what)
        if not (line["value"] and line["value"] > 0) or line["availability"] \
                != 1.0 or line["replicas"] != n \
                or line["compile_count"] != SERVE_BUCKETS:
            fail(f"{what}: {line}")
        report[what] = line
        print(f"[fleet] {what} (500 rps poisson, 1000 requests, {dt:.1f}s): "
              f"{line['value']} rps, p50 {line['p50_ms']} ms, p99 "
              f"{line['p99_ms']} ms, availability {line['availability']}, "
              f"retried {line['retried_requests']}, reloads "
              f"{line['reloads']} [{card}]")
    expect_launches(_counts(), {}, "the fleet phase")
    print(f"[fleet] phase_fleet: {time.perf_counter() - t0:.1f}s")
    return report


# ---- slice 18: the input pipeline and the comm strategies ----

PIPE_ARGS = ("--input_workers", "4", "--prefetch_depth", "3")
PIPE_NC_LIMIT = 16384
COMM_REPLICAS = 4
COMM_STEPS = 50
COMM_LIMIT = COMM_STEPS * COMM_REPLICAS * MAIN_BATCH    # 25,600 rows
# (label, kernel, knobs) of phase_comm's 4-replica fit_cached runs
COMM_CASES = (
    ("pmean", "pallas", dict(comm="pmean")),
    ("sharded", "pallas", dict(comm="sharded")),
    ("bf16", "pallas", dict(comm="bf16")),
    ("bf16 stochastic", "pallas", dict(comm="bf16",
                                       bf16_rounding="stochastic")),
    ("pmean xla", "xla", dict(comm="pmean")),
    ("int8", "xla", dict(comm="int8")),
    ("int8 no feedback", "xla", dict(comm="int8", error_feedback=False)),
    ("pmean overlap", "xla", dict(comm="pmean", overlap=True)),
)
# JAX's drift bounds of the compressed strategies against pmean
# (tests/test_collectives.py, after 3 steps at lr 0.05; held here after
# COMM_STEPS steps at lr 0.01)
COMM_DRIFT = {"bf16": 1e-4, "int8": 1e-3}
COMM_WORLD = 2
COMM_WORLD_LIMIT = COMM_WORLD * MAIN_BATCH * COMM_STEPS   # 12,800 rows


def _params_cpu(params) -> dict:
    return {n: {k: v.detach().cpu().clone() for k, v in layer.items()}
            for n, layer in params.items()}


def _worst_diff(a, b) -> float:
    return max(float((a[n][k] - b[n][k]).abs().max()) for n in a for k in a[n])


def _pipe_twins(cli_train, base: list, piped: tuple, key: str, steps: int,
                what: str) -> tuple:
    """`train` with `base` and with `piped` added: per-step losses and
    final params bitwise equal, `key` launched once a step in each.
    Returns (the piped run's launches, both runs' epoch lines)."""
    runs = []
    for extra in ((), piped):
        _reset_counts()
        state, history, out = _run_trainer(cli_train, base + list(extra))
        launches = _counts()
        expect_launches(launches, {key: steps}, f"{what} {' '.join(extra)}")
        lines = [ln for ln in out.splitlines() if ln.startswith("Epoch=")]
        runs.append((np.stack(history), _params_cpu(state.model.params()),
                     launches, lines[0]))
    (h0, p0, _, l0), (h1, p1, launches, l1) = runs
    if not (np.array_equal(h0, h1) and _equal_trees(p0, p1)):
        fail(f"{what}: {' '.join(piped)} is not bitwise the unpiped run "
             f"(losses or params)")
    if h0.shape != (1, steps) or not np.isfinite(h0).all():
        fail(f"{what}: losses {h0.shape}, finite {np.isfinite(h0).all()}")
    return launches, (l0, l1)


def phase_pipeline(device, data: dict, tmp: str, card: str) -> dict:
    """The input pipeline (pipeline/) on the card:
      a. one streaming epoch of `train` at full width (784-128-128-10,
         B = 128, synthetic 60k/10k) with PIPE_ARGS (4 decode workers, a
         slot ring of depth 3), bitwise the unpiped run's per-step losses
         and final params, 469 keyed K1-split launches in each;
      b. the same with `--kernel pallas --dtype bfloat16` (keyed K1-mma);
      c. `--netcdf --num_workers 2` bitwise its `--num_workers 0` twin
         (PIPE_NC_LIMIT rows of a converted synthetic file);
      d. the stale-input replay at depth 1, 2 and 4;
      e. `bench --mode input` at the JAX defaults: both variants'
         batches/s, data-wait shares and device syncs.
    Returns the launches of the piped paths."""
    from pytorch_ddp_mnist_tpu_torch import bench
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.data.convert import main as convert
    paths = {}
    base = ["--device", "0", "--n_epochs", "1", "--batch_size",
            str(MAIN_BATCH), "--lr", str(LR), "--seed", "0", "--path",
            os.path.join(tmp, "no_mnist_here"), "--checkpoint", ""]
    for extra, key, label in (
            (["--kernel", "auto"], "fused_split_keyed", "train"),
            (["--kernel", "pallas", "--dtype", "bfloat16"],
             "fused_mma_keyed", "train --kernel pallas --dtype bfloat16")):
        launches, lines = _pipe_twins(cli_train, base + extra, PIPE_ARGS,
                                      key, EPOCH_STEPS, label)
        paths[f"{label} {' '.join(PIPE_ARGS)}"] = launches
        print(f"[pipeline] {label} {' '.join(PIPE_ARGS)}: {EPOCH_STEPS} "
              f"steps bitwise the unpiped run (losses and params), "
              f"{launches[key]} {key} launches in each [{card}]")
        for tag, line in zip(("unpiped", "piped"), lines):
            print(f"[pipeline]   {tag}: {line}")

    nc_dir = os.path.join(tmp, "pipe_nc")
    with contextlib.redirect_stdout(io.StringIO()):
        convert(["--synthetic", "60000:10000", "--out_dir", nc_dir])
    nc = base[:-4] + ["--path", nc_dir, "--checkpoint", "", "--netcdf",
                      "--limit", str(PIPE_NC_LIMIT), "--kernel", "auto"]
    steps = PIPE_NC_LIMIT // MAIN_BATCH
    launches, lines = _pipe_twins(cli_train, nc + ["--num_workers", "0"],
                                  ("--num_workers", "2"), "fused_split_keyed",
                                  steps, "train --netcdf")
    paths["train --netcdf --num_workers 2"] = launches
    print(f"[pipeline] train --netcdf --num_workers 2: {steps} steps bitwise "
          f"its --num_workers 0 twin [{card}]")

    checked = _stale_input_check(device, data, tuple(
        ("streaming", "pallas", d) for d in (1, 2, 4)))
    print(f"[pipeline] stale-input replay on the slot ring: {checked}")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench.main(["--mode", "input"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    for tag in ("legacy", "pipeline"):
        r = line[tag]
        print(f"[pipeline] bench --mode input, {tag} (workers {r['workers']}, "
              f"depth {r['prefetch_depth']}): {r['batches_per_sec']} "
              f"batches/s, {r['images_per_sec']} images/s, data-wait share "
              f"{r['data_wait_share']} ({r['data_wait_s']} s of waits, p95 "
              f"{r['data_wait_p95_s']} s a batch), {r['syncs']} device "
              f"syncs (budget {r['sync_budget']}) [{card}]")
    print(f"[pipeline] bench --mode input: piped/legacy batches/s "
          f"{line['vs_baseline']} at {line['read_latency_ms_per_batch']} ms "
          f"a batch, {line['batches_per_epoch']} batches x {line['epochs']} "
          f"epochs ({time.perf_counter() - t0:.1f} s of wall) [{card}]")
    print(json.dumps({"bench_input": line}))
    return paths


def _comm_data():
    """The synthetic train rows the CLI's stand-in gives (get_mnist),
    cut to COMM_LIMIT, and its test split."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import (get_mnist,
                                                         normalize_images)
    with contextlib.redirect_stdout(io.StringIO()):
        train = get_mnist("/nonexistent", train=True)
        test = get_mnist("/nonexistent", train=False)
    return (train.images, train.labels.astype(np.int32),
            normalize_images(test.images), test.labels.astype(np.int32))


def _comm_fit(device, n: int, limit: int, kernel: str, kw: dict,
              data) -> tuple:
    """fit_cached on an n-replica mesh of the card, one epoch of `limit`
    rows at MAIN_BATCH a replica: (losses, params on the CPU, launches,
    the epoch's indices)."""
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import threefry
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import scan
    x_train, y_train, x_test, y_test = data
    model = MLP.from_seed(0).to(device)
    _reset_counts()
    _, hist = scan.fit_cached(
        model, threefry.key_data(1), x_train[:limit], y_train[:limit],
        ShardedSampler(limit, seed=42), x_test, y_test, epochs=1,
        batch_size=n * MAIN_BATCH, lr=LR, kernel=kernel,
        mesh=(device,) * n, log=lambda _m: None, **kw)
    torch.cuda.synchronize()
    return hist[0], _params_cpu(model.params()), _counts()


def _comm_turn(device, n, limit, kernel, kw, data, eager: bool) -> tuple:
    """The same epoch on fit_cached's loop (scan.CachedSteps with the
    strategy's DPComm), captured again or, with `eager`, the same step
    without a graph."""
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.ops import threefry
    from pytorch_ddp_mnist_tpu_torch.parallel import collectives
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import scan
    mesh = (device,) * n
    sampler = ShardedSampler(limit, seed=42)
    sampler.set_epoch(0)
    idx = scan.epoch_rows(sampler, n * MAIN_BATCH)
    params = scan._clone(MLP.from_seed(0).to(device).params())
    dp = collectives.DPComm(mesh, LR, **kw)
    dp.place_state(params)
    steps = scan.CachedSteps(
        params, torch.from_numpy(scan.resident_images(data[0][:limit])).to(
            device), torch.from_numpy(data[1][:limit]).to(device), idx.shape,
        LR, kernel, torch.float32, mesh, eager=eager, comm=dp)
    _, losses = steps.epoch(threefry.key_data(1), idx)
    return losses.cpu().numpy(), _params_cpu(params)


def phase_comm(device, tmp: str, card: str) -> dict:
    """The gradient-communication strategies (parallel/collectives.py):
      a. on a COMM_REPLICAS-replica mesh of the card, COMM_STEPS steps of
         fit_cached per COMM_CASES entry (pmean, sharded and bf16 on the
         keyed K1-split step, int8 and overlap on xla): sharded within
         rtol 1e-6 of pmean, bf16 and int8 within COMM_DRIFT of pmean on
         the same kernel, overlap within rtol 1e-6 of pmean; each run
         bitwise the same epoch through make_dp_run_fn eager and captured
         again (a rerun);
      b. 2-rank gloo worlds under torchrun, `--parallel --cached
         --ddp_comm sharded --kernel pallas` and `--ddp_comm int8`, each
         rank bitwise the 2-replica mesh of the card fed the same rows;
      c. `bench --mode ddp --ddp_comm all` at mlp@1 and deep_mlp@8.
    Returns the launches of the mesh and world paths."""
    paths = {}
    data = _comm_data()
    runs = {}
    t0 = time.perf_counter()
    for label, kernel, kw in COMM_CASES:
        losses, params, launches = _comm_fit(device, COMM_REPLICAS,
                                             COMM_LIMIT, kernel, kw, data)
        want = ({"fused_split_keyed": COMM_REPLICAS * COMM_STEPS}
                if kernel == "pallas" else
                {"threefry_mask": COMM_REPLICAS * COMM_STEPS})
        what = f"fit_cached mesh={COMM_REPLICAS} {label} --kernel {kernel}"
        expect_launches(launches, want, what)
        if losses.shape != (COMM_STEPS,) or not np.isfinite(losses).all():
            fail(f"{what}: losses {losses.shape} not finite")
        for eager in (True, False):
            l2, p2 = _comm_turn(device, COMM_REPLICAS, COMM_LIMIT, kernel,
                                kw, data, eager)
            if not (np.array_equal(l2, losses) and _equal_trees(p2, params)):
                fail(f"{what}: the {'eager' if eager else 'captured rerun'} "
                     f"epoch is not bitwise the captured fit_cached run")
        runs[label] = (losses, params)
        paths[what] = launches
    checks = []
    for label, ref, kind in (("sharded", "pmean", "rtol"),
                             ("pmean overlap", "pmean xla", "rtol"),
                             ("bf16", "pmean", "bf16"),
                             ("bf16 stochastic", "pmean", "bf16"),
                             ("int8", "pmean xla", "int8"),
                             ("int8 no feedback", "pmean xla", "int8")):
        got, want = runs[label][1], runs[ref][1]
        drift = _worst_diff(got, want)
        if kind == "rtol":
            ok = all(torch.allclose(got[n][k], want[n][k], rtol=1e-6,
                                    atol=1e-7) for n in got for k in got[n])
            bound = "rtol 1e-6"
        else:
            ok = 0 < drift < COMM_DRIFT[kind]
            bound = f"(0, {COMM_DRIFT[kind]})"
        if not ok:
            fail(f"phase_comm: {label} drifts {drift:.3e} from {ref} "
                 f"(bound {bound})")
        checks.append(f"{label} vs {ref} {drift:.3e} ({bound})")
    print(f"[comm] {COMM_STEPS} steps a strategy on a {COMM_REPLICAS}-replica "
          f"mesh of the card, each captured bitwise eager and a rerun: "
          f"{'; '.join(checks)} ({time.perf_counter() - t0:.1f} s) [{card}]")

    outs = {}
    cmds = []
    for comm, kernel in (("sharded", "pallas"), ("int8", "xla")):
        outs[comm] = tempfile.mkdtemp(dir=tmp)
        cmds.append(_torchrun(COMM_WORLD, _world_cli_argv(
            tmp, outs[comm], "--wireup_method", "env", "--cached",
            "--ddp_comm", comm, "--kernel", kernel, "--limit",
            str(COMM_WORLD_LIMIT), "--checkpoint", "")))
    t0 = time.perf_counter()
    _spawn(lambda attempt: [c for cmd in cmds for c in cmd(attempt)], tmp)
    wall = time.perf_counter() - t0
    steps = COMM_WORLD_LIMIT // (COMM_WORLD * MAIN_BATCH)
    for comm, kernel in (("sharded", "pallas"), ("int8", "xla")):
        what = (f"torchrun x{COMM_WORLD} train --parallel --cached "
                f"--ddp_comm {comm} --kernel {kernel}")
        ranks = [torch.load(os.path.join(outs[comm], f"rank{r}.pt"))
                 for r in range(COMM_WORLD)]
        losses, params, _ = _comm_fit(device, COMM_WORLD, COMM_WORLD_LIMIT,
                                      kernel, {"comm": comm}, data)
        for r, run in enumerate(ranks):
            _expect_eager(run, f"{what}, rank {r}")
            if not (np.array_equal(run["losses"].numpy(), losses)
                    and _equal_trees(run["params"], params)):
                fail(f"{what}: rank {r} is not bitwise the {COMM_WORLD}-"
                     f"replica mesh of the card on the same rows")
        key = "fused_split_keyed" if kernel == "pallas" else "threefry_mask"
        expect_launches(ranks[0]["launches"], {key: steps}, f"{what}, rank 0")
        paths[f"world n={COMM_WORLD} --cached --ddp_comm {comm} (torchrun), "
              f"a rank"] = ranks[0]["launches"]
        print(f"[comm] {what}: {steps} steps, every rank bitwise the "
              f"{COMM_WORLD}-replica mesh of the card on the same rows; "
              f"{ranks[0]['launches'][key]} {key} launches a rank")
    print(f"[comm] the two worlds ran together in {wall:.1f} s of wall")

    for argv in (["--mode", "ddp"],
                 ["--mode", "ddp", "--model", "deep_mlp", "--param_scale",
                  "8"]):
        from pytorch_ddp_mnist_tpu_torch import bench
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            bench.main(argv)
        rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        if [r["strategy"] for r in rows] != ["pmean", "sharded", "bf16",
                                             "int8"]:
            fail(f"bench {' '.join(argv)}: rows {rows}")
        for r in rows:
            print(f"[comm] bench {' '.join(argv)} {r['strategy']}: "
                  f"{r['value']} images/s on {r['replicas']} replicas of the "
                  f"card ({r['vs_one_replica']} x the 1-replica "
                  f"{r['one_replica_images_per_sec']}), bytes on wire "
                  f"{r['bytes_on_wire_per_step_per_replica']} (ring model) / "
                  f"moved {r['bytes_moved_per_step_per_replica']} "
                  f"(all-gathers) a step a replica, probe p50 "
                  f"{r['collective_s_p50']} s, drift vs pmean "
                  f"{r['parity_max_abs_diff_vs_pmean']:.3e} [{card}]")
        print(f"[comm] bench {' '.join(argv)}: {time.perf_counter() - t0:.1f}"
              f" s of wall")
        print(json.dumps({"bench_ddp": " ".join(argv), "rows": rows}))
        if argv == ["--mode", "ddp"]:
            with open(os.path.join(tmp, DDP_LINES), "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in rows))
    return paths


DDP_LINES = "bench_ddp_mlp1.jsonl"   # phase_comm's mlp@1 lines, for phase_trace
CHAOS_ROWS = 12800          # 100 steps an epoch at B = 128 (cut depth)
CHAOS_EPOCHS = 2
CHAOS_EVERY = 10
CHAOS_KILL = 137            # mid-epoch 1: the streaming run's last save is
                            # step 130, the resident run's step 140
CHAOS_WORLD = 2
CHAOS_COST_EPOCHS = 3       # the cost runs: full 60k epochs, 469 steps
CHAOS_COST_EVERY = (0, 50, 10)
CHAOS_TEST_ROWS = 10000


def _write_idx(path: str, arr: np.ndarray) -> None:
    """An IDX file (magic 2051 for (n, 28, 28) uint8 images, 2049 for (n,)
    uint8 labels), as the MNIST files are."""
    import struct
    arr = np.ascontiguousarray(arr, np.uint8)
    head = (struct.pack(">IIII", 2051, *arr.shape) if arr.ndim == 3
            else struct.pack(">II", 2049, arr.shape[0]))
    with open(path, "wb") as f:
        f.write(head + arr.tobytes())


def _chaos_data(tmp: str) -> str:
    """A directory of IDX files: CHAOS_WORLD x CHAOS_ROWS synthetic train
    rows and CHAOS_TEST_ROWS test rows (the trainers read them in a few
    milliseconds instead of synthesising 60,000 rows each)."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
    root = os.path.join(tmp, "chaos_idx")
    os.makedirs(root, exist_ok=True)
    for prefix, n, seed in (("train", CHAOS_WORLD * CHAOS_ROWS, 0),
                            ("t10k", CHAOS_TEST_ROWS, 1)):
        split = synthetic_mnist(n, seed=seed)
        _write_idx(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                   split.images)
        _write_idx(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                   split.labels)
    return root


def _file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _train_cmd(*argv) -> list:
    return [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
            *argv]


def _chaos_cost(cli_train, dev: str, tmp: str, card: str) -> dict:
    """What a step checkpoint costs the captured cached `pallas` epoch: the
    steady epochs' wall (epochs 1.. of CHAOS_COST_EPOCHS, full 60k, 469
    steps) at --ckpt_every_steps 0, 50 and 10, in that order, and
    `checkpoint.save_s` over this process's saves (the cost runs are the
    first saves of the process)."""
    from pytorch_ddp_mnist_tpu_torch.telemetry import get_registry
    out, walls = {}, {}
    for every in CHAOS_COST_EVERY:
        ck = os.path.join(tmp, f"cost{every}.msgpack")
        argv = ["--device", dev, "--cached", "--kernel", "pallas",
                "--n_epochs", str(CHAOS_COST_EPOCHS), "--batch_size",
                str(MAIN_BATCH), "--lr", str(LR), "--seed", "0", "--path",
                os.path.join(tmp, "no_mnist_here"), "--checkpoint", ck,
                "--ckpt_every_steps", str(every)]
        _reset_counts()
        _, history, text = _run_trainer(cli_train, argv)
        expect_launches(_counts(), {"fused_split_keyed":
                                    CHAOS_COST_EPOCHS * EPOCH_STEPS},
                        f"chaos cost run at --ckpt_every_steps {every}")
        lines = [ln for ln in text.splitlines() if ln.startswith("Epoch=")]
        walls[every] = [_epoch_seconds(ln, EPOCH_STEPS, MAIN_BATCH)
                        for ln in lines]
        out[every] = lines
    hist = get_registry().histogram("checkpoint.save_s").snapshot()
    steady = {e: float(np.median(w[1:])) for e, w in walls.items()}
    for every in CHAOS_COST_EVERY:
        print(f"[chaos] cost: train --cached --kernel pallas "
              f"--ckpt_every_steps {every}: steady epoch wall "
              f"{steady[every] * 1e3:.1f} ms (epochs {walls[every]} s; "
              f"{'no saves' if not every else f'{-(-EPOCH_STEPS // every)} saves an epoch'}), "
              f"{steady[every] / steady[0]:.3f} x the run with none [{card}]")
    print(f"[chaos] cost: checkpoint.save_s over the {hist['n']} saves of "
          f"the cost runs: p50 {hist['p50'] * 1e3:.2f} ms, p95 "
          f"{hist['p95'] * 1e3:.2f} ms, max {hist['max'] * 1e3:.2f} ms, "
          f"mean {hist['mean'] * 1e3:.2f} ms [{card}]")
    return {"steady_epoch_s": steady, "save_s": hist}


def phase_chaos(device, tmp: str, card: str) -> dict:
    """Step checkpoints, fault injection, resume and outage retry on the
    card, each resumed run bitwise its unbroken run (every tensor
    torch.equal, the final flax msgpack byte for byte):
      a. the cost of a step checkpoint (`_chaos_cost`), first;
      b. killed by `--fault kill:step=CHAOS_KILL` (subprocesses, at full
         width, CHAOS_ROWS rows: 100 steps an epoch, 2 epochs, a save every
         CHAOS_EVERY steps): streaming `train` (K1-split keyed), `--dtype
         bfloat16` (K1-mma keyed), `--cached` (the captured keyed step
         replayed in chunks), and piped (`--input_workers 2
         --prefetch_depth 2`); each dies by SIGKILL with committed
         checkpoints and `--resume <dir>` finishes it, in this process,
         bitwise the unbroken (unpiped, unchunked) run;
      c. K2-ws and K2-mma epoch-granular: 2 epochs of `--cached --kernel
         pallas_epoch` against 1 epoch, then `--resume file --start_epoch
         1` with the key chain in the `.rng.npz` sidecar;
      d. a 2-rank torchrun world (`--parallel --cached`, gloo on the card):
         rank 1 killed, the world reaped, resumed, bitwise the unbroken
         world; `--outage_retries 1` with an injected `collective_timeout`
         on an env world: every rank persists, re-execs, and finishes
         bitwise the unbroken world;
      e. `--fault ckpt_save_io`: the run finishes bitwise, its directory
         has no torn or temporary file.
    Returns the launches of the resumed runs."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.train import graphs
    from pytorch_ddp_mnist_tpu_torch.train.ckpt_manager import \
        CheckpointManager
    t_start = time.perf_counter()
    paths = {}
    dev = "cpu" if device.type == "cpu" else str(device.index)
    cost = _chaos_cost(cli_train, dev, tmp, card)
    t_cost = time.perf_counter() - t_start
    idx = _chaos_data(tmp)
    work = os.path.join(tmp, "chaos")
    os.makedirs(work, exist_ok=True)
    base = ["--device", dev, "--batch_size", str(MAIN_BATCH), "--lr",
            str(LR), "--seed", "0", "--path", idx, "--n_epochs",
            str(CHAOS_EPOCHS)]
    single = base + ["--limit", str(CHAOS_ROWS)]
    every = ["--ckpt_every_steps", str(CHAOS_EVERY)]
    kill = ["--fault", f"kill:step={CHAOS_KILL}"]
    pipe = ["--input_workers", "2", "--prefetch_depth", "2"]
    legs = {   # name: (extra flags, the resumed run's kernel, its golden)
        "train": ([], "fused_split_keyed", "train"),
        "train --dtype bfloat16": (["--kernel", "pallas", "--dtype",
                                    "bfloat16"], "fused_mma_keyed",
                                   "train --dtype bfloat16"),
        "train --cached": (["--cached", "--kernel", "pallas"],
                           "fused_split_keyed", "train --cached"),
        "train " + " ".join(pipe): (pipe, "fused_split_keyed", "train"),
    }
    world = ["--parallel", "--cached", "--limit",
             str(CHAOS_WORLD * CHAOS_ROWS)] + every

    def ck(name):
        return os.path.join(work, name.replace(" ", "_").replace("-", "")
                            + ".msgpack")

    # the subprocesses that die, and the worlds, started first: they run
    # while this process trains the goldens
    def wave_a(attempt):
        cmds = [(_train_cmd(*single, *extra, *every, *kill, "--checkpoint",
                            ck(name)), _rank_env())
                for name, (extra, _, _) in legs.items()]
        cmds.append(([sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", str(CHAOS_WORLD),
                      "-m", "pytorch_ddp_mnist_tpu_torch", "train", *base,
                      *world, "--checkpoint", ck("world_golden")],
                     _rank_env()))
        cmds.append(([sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", str(CHAOS_WORLD),
                      "-m", "pytorch_ddp_mnist_tpu_torch", "train", *base,
                      *world, "--checkpoint", ck("world_killed"), "--fault",
                      f"kill:rank=1:step={CHAOS_KILL}"], _rank_env()))
        port = _free_port()
        cmds += [(_train_cmd(*base, *world, "--wireup_method", "env",
                             "--checkpoint", ck("world_outage"),
                             "--outage_retries", "1", "--fault",
                             "collective_timeout:epoch=0"),
                  _rank_env(RANK=r, WORLD_SIZE=CHAOS_WORLD, LOCAL_RANK=r,
                            LOCAL_WORLD_SIZE=CHAOS_WORLD,
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
                 for r in range(CHAOS_WORLD)]
        return cmds

    box = {}
    t0 = time.perf_counter()
    runner = threading.Thread(
        target=lambda: box.update(res=_spawn(wave_a, work, expect_ok=False)))
    runner.start()
    goldens = {}
    for name in ("train", "train --dtype bfloat16", "train --cached"):
        extra = legs[name][0]
        state, _, _ = _run_trainer(cli_train, single + extra + [
            "--checkpoint", ck(name + " golden")])
        goldens[name] = (_params_cpu(state.model.params()),
                         _file_bytes(ck(name + " golden")))
    runner.join()
    res = box["res"]
    print(f"[chaos] the kills and the worlds ran in "
          f"{time.perf_counter() - t0:.1f} s of wall")
    names = list(legs)
    # the killed world's resume runs while this process resumes the rest
    k_rc, k_out, k_err = res[len(names) + 1]
    if k_rc == 0 or not re.search(r"exitcode\s*:\s*-9|Signal 9", k_err):
        fail(f"phase_chaos: the torchrun world under kill:rank=1 exited "
             f"{k_rc} without a rank killed by SIGKILL:\n{k_err[-3000:]}")
    world_steps = ck("world_killed") + ".steps"
    world_committed = CheckpointManager(world_steps).steps()
    resumed_world = threading.Thread(target=lambda: box.update(
        world=_spawn(lambda attempt: [(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(CHAOS_WORLD), "-m",
             "pytorch_ddp_mnist_tpu_torch", "train", *base, *world,
             "--checkpoint", ck("world_killed"), "--resume", world_steps],
            _rank_env())], work, expect_ok=False)))
    resumed_world.start()
    for i, name in enumerate(names):
        rc, out, err = res[i]
        if rc != -9:
            fail(f"phase_chaos: {name} {' '.join(kill)} exited {rc}, not by "
                 f"SIGKILL:\n{out[-2000:]}\n{err[-2000:]}")
    for name, (extra, key, gold) in legs.items():
        steps_dir = ck(name) + ".steps"
        committed = CheckpointManager(steps_dir).steps()
        if not committed:
            fail(f"phase_chaos: {name}: no committed checkpoint in "
                 f"{steps_dir}")
        _reset_counts()
        captures = graphs.counts["captures"]
        state, _, text = _run_trainer(cli_train, single + extra + every + [
            "--checkpoint", ck(name), "--resume", steps_dir])
        launches = _counts()
        resumed_steps = CHAOS_EPOCHS * CHAOS_ROWS // MAIN_BATCH - committed[-1]
        expect_launches(launches, {key: resumed_steps},
                        f"phase_chaos: {name} --resume")
        if (device.type == "cuda"
                and graphs.counts["captures"] - captures != 1):
            fail(f"phase_chaos: {name} --resume captured "
                 f"{graphs.counts['captures'] - captures} graphs, not 1")
        params, blob = goldens[gold]
        if not _equal_trees(_params_cpu(state.model.params()), params):
            fail(f"phase_chaos: {name}: the resumed run's params are not "
                 f"bitwise the unbroken run's")
        if _file_bytes(ck(name)) != blob:
            fail(f"phase_chaos: {name}: the resumed final msgpack differs "
                 f"from the unbroken run's")
        paths[f"{name} --resume <step dir> (chaos)"] = launches
        print(f"[chaos] {name} {' '.join(kill)}: SIGKILL with checkpoints "
              f"{committed}; --resume from step {committed[-1]}: "
              f"{launches[key]} {key} launches, bitwise the unbroken "
              f"{gold} run (params and msgpack) [{card}]")

    for dtype, key in (("float32", "epoch_step_ws"),
                       ("bfloat16", "epoch_step_mma")):
        k2 = single + ["--cached", "--kernel", "pallas_epoch", "--dtype",
                       dtype]
        golden, part = ck(f"k2 {dtype} golden"), ck(f"k2 {dtype}")
        two, _, _ = _run_trainer(cli_train, k2 + ["--checkpoint", golden])
        one, _, _ = _run_trainer(cli_train, k2 + ["--n_epochs", "1",
                                                  "--checkpoint", part])
        np.savez(part + ".rng.npz", key=np.asarray(one.key, np.uint32),
                 impl="threefry2x32")
        _reset_counts()
        resumed, _, _ = _run_trainer(cli_train, k2 + [
            "--checkpoint", part, "--resume", part, "--start_epoch", "1"])
        launches = _counts()
        expect_launches(launches, {key: 1}, f"phase_chaos: K2 {dtype} resume")
        if not (_equal_trees(_params_cpu(resumed.model.params()),
                             _params_cpu(two.model.params()))
                and _file_bytes(part) == _file_bytes(golden)
                and resumed.key == two.key):
            fail(f"phase_chaos: --cached --kernel pallas_epoch --dtype "
                 f"{dtype}: 1 epoch + --resume --start_epoch 1 is not "
                 f"bitwise 2 epochs")
        if os.path.exists(part + ".rng.npz"):
            fail("phase_chaos: the sidecar outlived the resume's first save")
        paths[f"train --cached --kernel pallas_epoch --dtype {dtype} "
              f"--resume file --start_epoch 1 (chaos)"] = launches
        print(f"[chaos] --cached --kernel pallas_epoch --dtype {dtype}: 1 "
              f"epoch, then --resume <file> --start_epoch 1 with the "
              f"sidecar's key chain: {launches[key]} {key} launch, bitwise 2 "
              f"unbroken epochs [{card}]")

    io = ck("train save_io")
    state, _, _ = _run_trainer(cli_train, single + every + [
        "--checkpoint", io, "--ckpt_keep", "100", "--fault",
        f"ckpt_save_io:step={3 * CHAOS_EVERY}"])
    files = sorted(os.listdir(io + ".steps"))
    saved = CheckpointManager(io + ".steps").steps()
    if (any(".tmp." in n for n in files) or 3 * CHAOS_EVERY in saved
            or not _equal_trees(_params_cpu(state.model.params()),
                                goldens["train"][0])):
        fail(f"phase_chaos: ckpt_save_io: {files}")
    print(f"[chaos] --fault ckpt_save_io:step={3 * CHAOS_EVERY}: the save "
          f"failed, the run finished bitwise the unbroken one, the directory "
          f"holds {saved} and no temporary file [{card}]")
    world_golden = _file_bytes(ck("world_golden"))
    if res[len(names)][0] != 0:
        fail(f"phase_chaos: the unbroken torchrun world exited "
             f"{res[len(names)][0]}:\n{res[len(names)][2][-3000:]}")
    resumed_world.join()
    (rc, _, err), = box["world"]
    if rc != 0:
        fail(f"phase_chaos: the resumed torchrun world exited {rc}:\n"
             f"{err[-3000:]}")
    if _file_bytes(ck("world_killed")) != world_golden:
        fail("phase_chaos: the resumed torchrun world differs from the "
             "unbroken world")
    print(f"[chaos] torchrun x{CHAOS_WORLD} train --parallel --cached, rank "
          f"1 killed at step {CHAOS_KILL} (checkpoints {world_committed}), the "
          f"world reaped and resumed: bitwise the unbroken world [{card}]")
    outage = res[len(names) + 2:]
    if any(rc != 0 for rc, _, _ in outage) or not all(
            "coordinated parallel resume" in err for _, _, err in outage):
        fail("phase_chaos: the outage world did not re-exec and finish:\n"
             + "\n".join(err[-2000:] for _, _, err in outage))
    if _file_bytes(ck("world_outage")) != world_golden:
        fail("phase_chaos: the outage world's re-exec'd run differs from the "
             "unbroken world")
    print(f"[chaos] env x{CHAOS_WORLD} --outage_retries 1 --fault "
          f"collective_timeout:epoch=0: every rank persisted, re-exec'd with "
          f"--resume --start_epoch 1, finished bitwise the unbroken world "
          f"[{card}]")

    print(f"[chaos] phase_chaos: {time.perf_counter() - t_start:.1f} s "
          f"({t_cost:.1f} s of it the cost runs) [{card}]")
    print(json.dumps({"chaos": {"cost": cost, "card": card}}, default=str))
    return paths


TEL_K = 16                  # --profile_dispatch: a drain every 16 steps
TEL_EVERY = 10              # the nan round trip's step checkpoints
TEL_ROWS = CHAOS_ROWS       # 100 steps an epoch at B = 128
TEL_EPOCH = TEL_ROWS // MAIN_BATCH
TEL_NAN_STEP = 135          # its poisoned loss, in epoch 1 of 3: the rescue
                            # is epoch 0's trained end state, step 100
TEL_STALL_S = 1.0           # the loader stall, at batch 3 of each epoch:
                            # epoch 2's keeps the run alive after the fatal
                            # event
TEL_ABORT_STEP = 35         # --health abort's poisoned loss (epoch 0)
TEL_WORLD_ROWS = CHAOS_WORLD * MAIN_BATCH * 20   # 20 steps an epoch a rank
TEL_FLAGS = ("--health", "warn", "--metrics_port", "0",
             "--profile_dispatch", str(TEL_K))


def _check_trace(directory: str, require: str) -> None:
    """scripts/check_telemetry.py (the JAX package's checker, pure stdlib)
    over a trace directory, with a --require gate."""
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "scripts", "check_telemetry.py"),
                          "--require", require, directory],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"check_telemetry.py --require {require} {directory}: "
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")


def _synced_run(cli_train, argv) -> tuple:
    """The trainer in this process under torch.cuda.set_sync_debug_mode
    ("warn"): (state, history, stdout, the synchronising CUDA calls it
    made, the dispatch profiler's drains among them)."""
    import warnings
    from pytorch_ddp_mnist_tpu_torch.telemetry import dispatch
    from pytorch_ddp_mnist_tpu_torch.train.graphs import _set_sync_debug_mode
    drains = dispatch.counts["drains"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _set_sync_debug_mode("warn")
        try:
            state, history, out = _run_trainer(cli_train, argv)
        finally:
            _set_sync_debug_mode("default")
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return state, history, out, syncs, dispatch.counts["drains"] - drains


def _telemetry_line(out: str, what: str) -> dict:
    m = re.search(r"^\[telemetry\] epochs=(\d+) xla_compiles=(\d+) "
                  r"host_rss_mb=(\S+) device_peak_mb=(\S+) trace=(\S+)$",
                  out, re.M)
    if not m:
        fail(f"{what}: no [telemetry] line in\n{out[-2000:]}")
    return {"epochs": int(m[1]), "xla_compiles": int(m[2]),
            "host_rss_mb": m[3], "device_peak_mb": m[4], "trace": m[5]}


def _one_capture(out: str, what: str) -> None:
    """The run's [telemetry] line counts its one CUDA-graph capture (the
    process's earlier runs' captures not among them)."""
    line = _telemetry_line(out, what)
    if line["xla_compiles"] != 1:
        fail(f"phase_telemetry: {what}: [telemetry] xla_compiles="
             f"{line['xla_compiles']}, want the run's one capture")


def _bitwise_twins(tag, a, b) -> None:
    """a, b: (state, history, checkpoint path) of a run without and with
    the telemetry flags: every per-step loss, every parameter and the
    final checkpoint's bytes equal."""
    if len(a[1]) != len(b[1]) or any(
            not np.array_equal(x.view(np.uint32), y.view(np.uint32))
            for x, y in zip(a[1], b[1])):
        fail(f"phase_telemetry: {tag}: the per-step losses differ with the "
             f"telemetry flags")
    if not _equal_trees(_params_cpu(a[0].model.params()),
                        _params_cpu(b[0].model.params())):
        fail(f"phase_telemetry: {tag}: the params differ with the flags")
    if _file_bytes(a[2]) != _file_bytes(b[2]):
        fail(f"phase_telemetry: {tag}: the final checkpoint differs")


def _nan_round_trip(dev: str, idx: str, work: str) -> dict:
    """The health round trip in a subprocess (scripts/health_smoke.py's
    promises): `/metrics` scraped while it trains, `/healthz` 503 after the
    fatal event (a loader stall in epoch 2 keeps the run alive past it),
    the fatal `nan` event in the trace, intact pre-NaN checkpoints, and
    the pinned rescue at the last epoch boundary before the NaN (the
    streaming watchdog observes once an epoch): a trained state, not the
    run's starting one."""
    import select
    import urllib.error
    import urllib.request
    import zlib
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import params_from_bytes
    tel = os.path.join(work, "tel_nan")
    ck = os.path.join(work, "nan.msgpack")
    argv = _train_cmd(
        "--device", dev, "--batch_size", str(MAIN_BATCH), "--lr", str(LR),
        "--seed", "0", "--path", idx, "--limit", str(TEL_ROWS), "--n_epochs",
        "3", "--checkpoint", ck, "--ckpt_every_steps", str(TEL_EVERY),
        "--health", "checkpoint-and-warn", "--telemetry", tel,
        "--metrics_port", "0", "--fault",
        f"nan:step={TEL_NAN_STEP},loader_stall:batch=3:delay_s="
        f"{TEL_STALL_S}:times=3")
    proc = subprocess.Popen(argv, cwd=work, env=_rank_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    lines, url, scraped, statuses = [], None, None, []
    deadline = time.monotonic() + WORLD_LIMIT_S
    try:
        while url is None and time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stderr], [], [], 1.0)
            if not ready:
                if proc.poll() is not None:
                    break
                continue
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("metrics on "):
                url = line.split("metrics on ", 1)[1].strip()
        if url is None:
            fail("phase_telemetry: the nan run never announced its "
                 "--metrics_port endpoint:\n" + "".join(lines)[-3000:])
        scraped = urllib.request.urlopen(url, timeout=10).read().decode()
        healthz = url.rsplit("/", 1)[0] + "/healthz"
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                statuses.append(urllib.request.urlopen(
                    healthz, timeout=5).status)
            except urllib.error.HTTPError as e:
                statuses.append(e.code)
            except OSError:
                break
            if statuses[-1] == 503:
                break
            time.sleep(0.02)
        out, err = proc.communicate(timeout=max(deadline - time.monotonic(),
                                                1.0))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    err = "".join(lines) + err
    if proc.returncode != 0:
        fail(f"phase_telemetry: the nan run exited {proc.returncode} "
             f"(checkpoint-and-warn keeps it alive):\n{err[-3000:]}")
    for needle in ("# TYPE", "health_worst_severity_level"):
        if needle not in scraped:
            fail(f"phase_telemetry: the live /metrics scrape lacks {needle!r}")
    if 503 not in statuses:
        fail(f"phase_telemetry: /healthz never answered 503 after the fatal "
             f"event (statuses {sorted(set(statuses))})")
    _check_trace(tel, "health.,mem.,checkpoint.")
    events = []
    with open(os.path.join(tel, "events.jsonl")) as f:
        for raw in f:
            rec = json.loads(raw)
            if rec.get("kind") == "point" and rec.get("name") == "health":
                events.append(rec["attrs"])
    nans = [e for e in events if e["detector"] == "nan"]
    if not nans or nans[0]["severity"] != "fatal":
        fail(f"phase_telemetry: no fatal nan health event: {events}")
    steps_dir = ck + ".steps"
    pre = []
    for name in sorted(os.listdir(steps_dir)):
        if name.endswith(".json"):
            with open(os.path.join(steps_dir, name)) as f:
                man = json.load(f)
            if man["step"] < TEL_NAN_STEP:
                pre.append(man)
    rescue = [m["step"] for m in pre if m.get("pinned")]
    want = (TEL_NAN_STEP - 1) // TEL_EPOCH * TEL_EPOCH
    if rescue != [want]:
        fail(f"phase_telemetry: the pinned pre-NaN rescue checkpoints are at "
             f"steps {rescue}, want [{want}] (the last epoch boundary before "
             f"the NaN at step {TEL_NAN_STEP}); have "
             f"{sorted(os.listdir(steps_dir))}")
    for man in pre:
        with open(os.path.join(steps_dir, man["payload"]), "rb") as f:
            blob = f.read()
        params = params_from_bytes(blob)
        if (len(blob) != man["bytes"] or zlib.crc32(blob) != man["crc32"]
                or not all(torch.isfinite(v).all() for layer in
                           params.values() for v in layer.values())):
            fail(f"phase_telemetry: pre-NaN checkpoint at step "
                 f"{man['step']} is not intact")
    return {"scrape_lines": len(scraped.splitlines()),
            "healthz": sorted(set(statuses)), "nan_event_step":
            nans[0].get("step"), "pre_nan_steps": [m["step"] for m in pre],
            "rescue": rescue,
            "metrics_url": url}


def phase_telemetry(device, tmp: str, card: str) -> dict:
    """The trainer's in-run telemetry on the card, each run bitwise its
    twin without the flags (every per-step loss, every parameter, the
    final flax msgpack byte for byte):
      a. streaming `train` (K1-split keyed, captured), one full epoch,
         without and with `--telemetry --health warn --metrics_port 0
         --profile_dispatch 16`, both under set_sync_debug_mode("warn"):
         the synchronising calls of the flagged run are the plain run's
         plus the profiler's drains, one every 16 steps; its trace passes
         check_telemetry.py --require health.,mem.,checkpoint.,dispatch.
         and its [telemetry] line reads one capture and the card's peak;
      b. the same at --dtype bfloat16 (K1-mma keyed), 50 steps, and with
         --kernel xla (the health aux written inside the captured graph),
         50 steps;
      c. `--cached --kernel pallas_epoch --health warn --telemetry` (K2-ws,
         one launch an epoch, the watchdog once an epoch);
      d. the nan round trip (`_nan_round_trip`) at 12,800 rows, 3 epochs,
         the NaN in epoch 1, and
         `--health abort` exiting with `[health] …` and a flight dump;
      e. a 2-rank gloo world on the card (`--parallel --kernel xla
         --journal`) bitwise its unjournaled twin, its journals read by the
         port's cluster_report: no desync, no hang, seq 0 the startup
         barrier on both ranks.
    Returns the launches of the flagged runs."""
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.telemetry import (cluster_report,
                                                       format_cluster_report,
                                                       load_journal)
    t_start = time.perf_counter()
    dev = "cpu" if device.type == "cpu" else str(device.index)
    work = os.path.join(tmp, "telemetry")
    os.makedirs(work, exist_ok=True)
    idx = _chaos_data(tmp)
    paths = {}

    world = ["--parallel", "--wireup_method", "env", "--device", dev,
             "--kernel", "xla", "--batch_size", str(MAIN_BATCH), "--lr",
             str(LR), "--seed", "0", "--path", idx, "--limit",
             str(TEL_WORLD_ROWS), "--n_epochs", "1"]
    tel_world = os.path.join(work, "tel_world")

    def world_cmds(attempt):
        return (_env_world(CHAOS_WORLD, _train_cmd(
                    *world, "--checkpoint", "world_plain.msgpack"))(attempt)
                + _env_world(CHAOS_WORLD, _train_cmd(
                    *world, "--checkpoint", "world_journal.msgpack",
                    "--journal", "--telemetry", tel_world))(attempt))

    box = {}
    runner = threading.Thread(target=lambda: box.update(
        res=_spawn(world_cmds, work, expect_ok=False)))
    runner.start()

    base = ["--device", dev, "--batch_size", str(MAIN_BATCH), "--lr",
            str(LR), "--seed", "0", "--path",
            os.path.join(tmp, "no_mnist_here"), "--n_epochs", "1"]
    stream = base + ["--ckpt_every_steps", str(EPOCH_STEPS)]
    tel_a = os.path.join(work, "tel_stream")
    runs = {}
    for tag, extra in (("plain", []),
                       ("flags", [*TEL_FLAGS, "--telemetry", tel_a])):
        ck = os.path.join(work, f"stream_{tag}.msgpack")
        _reset_counts()
        state, history, out, syncs, drains = _synced_run(
            cli_train, stream + extra + ["--checkpoint", ck])
        runs[tag] = (state, history, ck, out, syncs, drains, _counts())
    _bitwise_twins("streaming", runs["plain"][:3], runs["flags"][:3])
    launches = runs["flags"][6]
    expect_launches(launches, {"fused_split_keyed": EPOCH_STEPS},
                    "phase_telemetry: the flagged streaming epoch")
    syncs_plain, syncs_flags, drains = (runs["plain"][4], runs["flags"][4],
                                        runs["flags"][5])
    want_drains = -(-EPOCH_STEPS // TEL_K)
    if drains != want_drains or syncs_flags - syncs_plain != drains:
        fail(f"phase_telemetry: synchronising calls {syncs_plain} without "
             f"the flags, {syncs_flags} with them, {drains} profiler drains "
             f"(want {want_drains}: one every {TEL_K} steps, and no other "
             f"sync added)")
    line = _telemetry_line(runs["flags"][3], "the flagged streaming run")
    if line["xla_compiles"] != 1 or line["device_peak_mb"] in ("None", "0"):
        fail(f"phase_telemetry: [telemetry] line {line}")
    _check_trace(tel_a, "health.,mem.,checkpoint.,dispatch.")
    paths["train " + " ".join(TEL_FLAGS) + " --telemetry (telemetry)"] = \
        launches
    print(f"[telemetry] streaming train, one epoch ({EPOCH_STEPS} captured "
          f"K1-split keyed steps) with {' '.join(TEL_FLAGS)} --telemetry: "
          f"bitwise the run without (losses, params, msgpack); "
          f"synchronising CUDA calls {syncs_plain} -> {syncs_flags}, the "
          f"difference the profiler's {drains} drains (one every {TEL_K} "
          f"steps); [telemetry] xla_compiles={line['xla_compiles']} "
          f"device_peak_mb={line['device_peak_mb']} "
          f"host_rss_mb={line['host_rss_mb']}; check_telemetry.py --require "
          f"health.,mem.,checkpoint.,dispatch. passes [{card}]")

    bf16 = base + ["--kernel", "pallas", "--dtype", "bfloat16", "--limit",
                   str(MAIN_STEPS * MAIN_BATCH)]
    twins = []
    for tag, extra in (("plain", []), ("flags", [
            *TEL_FLAGS, "--telemetry", os.path.join(work, "tel_bf16")])):
        ck = os.path.join(work, f"bf16_{tag}.msgpack")
        _reset_counts()
        state, history, out = _run_trainer(cli_train, bf16 + extra + [
            "--checkpoint", ck])
        twins.append((state, history, ck, _counts(), out))
    _bitwise_twins("bf16 streaming", *[t[:3] for t in twins])
    _one_capture(twins[1][4], "the flagged bf16 streaming run")
    expect_launches(twins[1][3], {"fused_mma_keyed": MAIN_STEPS},
                    "phase_telemetry: the flagged bf16 streaming run")
    paths["train --dtype bfloat16 " + " ".join(TEL_FLAGS)
          + " --telemetry (telemetry)"] = twins[1][3]
    print(f"[telemetry] train --kernel pallas --dtype bfloat16, "
          f"{MAIN_STEPS} K1-mma keyed steps with the flags: bitwise the run "
          f"without [{card}]")

    from pytorch_ddp_mnist_tpu_torch.telemetry import get_registry
    xla = base + ["--kernel", "xla", "--limit", str(MAIN_STEPS * MAIN_BATCH)]
    twins = []
    for tag, extra in (("plain", []), ("flags", [
            *TEL_FLAGS, "--telemetry", os.path.join(work, "tel_xla")])):
        ck = os.path.join(work, f"xla_{tag}.msgpack")
        _reset_counts()
        state, history, out = _run_trainer(cli_train, xla + extra + [
            "--checkpoint", ck])
        twins.append((state, history, ck, _counts(), out))
    _bitwise_twins("xla streaming with the health aux",
                   *[t[:3] for t in twins])
    _one_capture(twins[1][4], "the flagged xla streaming run")
    expect_launches(twins[1][3], {"threefry_mask": MAIN_STEPS},
                    "phase_telemetry: the flagged xla streaming run")
    gauges = get_registry().snapshot()["gauges"]
    if not (gauges.get("health.grad_norm") or 0) > 0 or not (
            gauges.get("health.update_ratio") or 0) > 0:
        fail(f"phase_telemetry: the captured xla step's health aux did not "
             f"reach the watchdog: {gauges}")
    paths["train --kernel xla " + " ".join(TEL_FLAGS)
          + " --telemetry (telemetry)"] = twins[1][3]
    print(f"[telemetry] train --kernel xla, {MAIN_STEPS} captured steps with "
          f"the flags: bitwise the run without; the health aux written in "
          f"the graph reached the watchdog (grad norm "
          f"{gauges['health.grad_norm']:.4f}, update ratio "
          f"{gauges['health.update_ratio']:.3e}) [{card}]")

    k2 = base + ["--cached", "--kernel", "pallas_epoch"]
    twins = []
    tel_k2 = os.path.join(work, "tel_k2")
    for tag, extra in (("plain", []), ("flags", [
            "--health", "warn", "--telemetry", tel_k2])):
        ck = os.path.join(work, f"k2_{tag}.msgpack")
        _reset_counts()
        state, history, _ = _run_trainer(cli_train, k2 + extra + [
            "--checkpoint", ck])
        twins.append((state, history, ck, _counts()))
    _bitwise_twins("K2-ws", *[t[:3] for t in twins])
    expect_launches(twins[1][3], {"epoch_step_ws": 1},
                    "phase_telemetry: --cached --kernel pallas_epoch "
                    "--health warn")
    _check_trace(tel_k2, "health.,mem.")
    paths["train --cached --kernel pallas_epoch --health warn --telemetry "
          "(telemetry)"] = twins[1][3]
    print(f"[telemetry] train --cached --kernel pallas_epoch --health warn "
          f"--telemetry: one K2-ws launch, bitwise the run without; "
          f"check_telemetry.py --require health.,mem. passes [{card}]")

    t0 = time.perf_counter()
    nan = _nan_round_trip(dev, idx, work)
    print(f"[telemetry] nan round trip ({TEL_ROWS} rows, --fault "
          f"nan:step={TEL_NAN_STEP} --health checkpoint-and-warn "
          f"--ckpt_every_steps {TEL_EVERY} --metrics_port 0): /metrics "
          f"served {nan['scrape_lines']} lines mid-run, /healthz "
          f"{nan['healthz']}, the fatal nan event at step "
          f"{nan['nan_event_step']}, intact pre-NaN checkpoints "
          f"{nan['pre_nan_steps']} (rescue, pinned: {nan['rescue']}) in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    tel_abort = os.path.join(work, "tel_abort")
    try:
        _run_trainer(cli_train, base + [
            "--limit", str(TEL_ROWS), "--checkpoint", "", "--health",
            "abort", "--telemetry", tel_abort, "--fault",
            f"nan:step={TEL_ABORT_STEP}"])
        fail("phase_telemetry: --health abort did not stop the run")
    except SystemExit as e:
        if not str(e.code).startswith("[health] fatal health signal (nan"):
            fail(f"phase_telemetry: --health abort exited {e.code!r}")
    dumps = [n for n in os.listdir(tel_abort) if n.startswith("flight.")]
    if not dumps:
        fail("phase_telemetry: --health abort left no flight dump")
    print(f"[telemetry] --health abort: exits by name ('[health] fatal "
          f"health signal (nan …'), flight dump {dumps[0]} [{card}]")

    runner.join()
    res = box["res"]
    for r, (rc, out, err) in enumerate(res):
        if rc != 0:
            fail(f"phase_telemetry: world process {r} exited {rc}:\n"
                 f"{out[-2000:]}\n{err[-3000:]}")
    if _file_bytes(os.path.join(work, "world_plain.msgpack")) != \
            _file_bytes(os.path.join(work, "world_journal.msgpack")):
        fail("phase_telemetry: the journaled world's checkpoint differs from "
             "the unjournaled world's")
    report = cluster_report(tel_world)
    firsts = [load_journal(p)["records"][0] for p in report["files"]]
    if (report["n_ranks"] != CHAOS_WORLD or not report["desync"]["ok"]
            or report["hang"]["stuck"] is not None
            or any(r["seq"] != 0 or r["k"] != "barrier" for r in firsts)):
        fail(f"phase_telemetry: the world's journals: "
             f"{format_cluster_report(report)}")
    _check_trace(tel_world, "cluster.,mem.")
    print(f"[telemetry] env x{CHAOS_WORLD} train --parallel --kernel xla "
          f"--journal on the card: bitwise the unjournaled world; "
          + format_cluster_report(report).replace("\n", "; ")
          + f" [{card}]")
    print(f"[telemetry] phase_telemetry: "
          f"{time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"telemetry": {
        "syncs": {"plain": syncs_plain, "flags": syncs_flags,
                  "drains": drains}, "line": line, "nan": nan,
        "world": {"collectives": report["totals"]["collectives"],
                  "skew_worst": report["skew"]["worst"]}, "card": card}},
        default=str))
    return paths


# phase_trace: `trace cost` at the JAX defaults, each DP program run
# captured and eagerly (its bitwise check), STEP and RUN forms
TRACE_COST_REPLICAS = 8
TRACE_COST_BATCH = 16
TRACE_COST_STEPS = 1 + 2    # a step-form program's steps + a run-form's
TRACE_KEYED = ("pmean", "sharded", "bf16")      # K1-split keyed at B = 16
TRACE_XLA = 5               # int8, int8+overlap and the three +overlap


def _cli(main, argv) -> tuple:
    """(exit code, stdout, stderr) of a CLI's main(argv) in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _expect_rc(got: tuple, want: int, what: str) -> None:
    if got[0] != want:
        fail(f"phase_trace: {what} exited {got[0]}, want {want}:\n"
             f"{got[1][-2000:]}\n{got[2][-2000:]}")


def _check_stamps(line: dict, what: str) -> None:
    """The bench line's registry and ledger stamps, present and typed."""
    ok = (isinstance(line.get("xla_compiles"), int)
          and isinstance(line.get("peak_hbm_bytes"), int)
          and line["peak_hbm_bytes"] > 0
          and isinstance(line.get("health_summary"), dict)
          and line.get("schema_version") == 2
          and isinstance(line.get("run_ord"), int)
          and "statics" not in line)
    if not ok:
        fail(f"phase_trace: {what}: stamps {line}")


def phase_trace(tmp: str, card: str, bench_line: dict) -> dict:
    """The telemetry read side on the card (cli/trace.py, cli/ledger.py,
    telemetry/costs.py), over what phase_telemetry and phase_comm wrote
    under `tmp` and the bench train line `bench_line`:
      a. `trace report` on the profiled streaming epoch: one epoch,
         step_compute p50 > 0; `--overhead` coverage >= 0.90 and a worst
         phase; `--baseline` itself exits 0, a copy with its step_compute
         spans doubled exits 3 naming the phase;
      b. `trace report --cluster` on the journaled 2-rank world: no
         desync, 2 ranks, no stuck seq; a copy with rank 1's last
         collective left open names that seq;
      c. `trace export` of the world: collective tracks, cross-rank flow
         arrows;
      d. `trace cost --form both --telemetry` at 8 replicas x 16 rows,
         the mlp@1 ddp lines its artifact: every program captured, bitwise
         its eager step, peak and capture time measured, analytic_flops
         the JAX formula, the K1-split keyed and mask-entry launches
         counted; check_telemetry.py over its trace; every strategy's
         attribution shares sum to 1; `--cost` against itself exits 0;
      e. the ledger over this run's own lines (BENCH_r01, MULTICHIP_r01,
         COST_r01): report ingests all, gate 0; a halved MULTICHIP_r02
         gates 3 naming the series; a future schema_version refused by
         name; `trace export --ledger` one counter track a series;
      f. the registry and ledger stamps of the bench lines.
    Returns the launches of `trace cost`."""
    import shutil
    from pytorch_ddp_mnist_tpu_torch.cli import ledger as ledger_cli
    from pytorch_ddp_mnist_tpu_torch.cli import trace as trace_cli
    from pytorch_ddp_mnist_tpu_torch.telemetry import analysis, cluster
    t_start = time.perf_counter()
    work = os.path.join(tmp, "trace")
    os.makedirs(work, exist_ok=True)
    tel = os.path.join(tmp, "telemetry")
    stream, world = (os.path.join(tel, "tel_stream"),
                     os.path.join(tel, "tel_world"))

    # a. the phase report and its gates
    rep = analysis.analyze(analysis.trace_files(stream))
    p50 = rep["phases"].get("step_compute", {}).get("p50_s", 0.0)
    if rep["epochs"]["count"] != 1 or not p50 > 0:
        fail(f"phase_trace: trace report {stream}: epochs "
             f"{rep['epochs']}, step_compute p50 {p50}")
    over = analysis.overhead_report(analysis.trace_files(stream))
    row = over["rows"][0] if over["rows"] else {}
    if not (row.get("coverage", 0) >= analysis.OVERHEAD_COVERAGE_MIN
            and row.get("worst_phase")):
        fail(f"phase_trace: --overhead {stream}: {over}")
    _expect_rc(_cli(trace_cli.main, ["report", "--overhead", stream]), 0,
               "trace report --overhead")
    _expect_rc(_cli(trace_cli.main, ["report", stream, "--baseline",
                                     stream]), 0, "trace report --baseline "
                                                  "itself")
    slow = os.path.join(work, "slow")
    os.makedirs(slow)
    for name in os.listdir(stream):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(stream, name)) as f, \
                open(os.path.join(slow, name), "w") as g:
            for raw in f:
                rec = json.loads(raw)
                if rec.get("kind") == "span" \
                        and rec.get("name") == "step_compute":
                    rec["dur_s"] = 2 * rec["dur_s"]
                g.write(json.dumps(rec) + "\n")
    got = _cli(trace_cli.main, ["report", slow, "--baseline", stream])
    _expect_rc(got, 3, "trace report on the doubled step_compute copy")
    if not any("step_compute" in ln and "REGRESSION" in ln
               for ln in got[1].splitlines()):
        fail(f"phase_trace: the doubled copy's gate names no step_compute "
             f"regression:\n{got[1]}")
    print(f"[trace] a. trace report {os.path.basename(stream)}: 1 epoch, "
          f"step_compute p50 {p50 * 1e3:.3f} ms; --overhead coverage "
          f"{row['coverage']:.4f} (worst {row['worst_phase']}, share "
          f"{row['worst_share']:.4f}); --baseline itself exit 0, step_compute "
          f"doubled exit 3 [{card}]")

    # b. the cluster report, and a rank's last collective left open
    got = _cli(trace_cli.main, ["report", "--cluster", world, "--json"])
    _expect_rc(got, 0, "trace report --cluster")
    crep = json.loads(got[1])
    if not (crep["desync"]["ok"] and crep["n_ranks"] == 2
            and crep["hang"]["stuck"] is None):
        fail(f"phase_trace: --cluster {world}: "
             f"{cluster.format_cluster_report(crep)}")
    cut = os.path.join(work, "cut")
    shutil.copytree(world, cut)
    path = cluster.journal_path(cut, 1)
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    last = max(i for i, r in enumerate(recs) if r.get("kind") == "coll")
    stuck_seq = recs[last]["seq"]
    recs = recs[:last] + [{**{k: v for k, v in recs[last].items()
                              if k not in ("kind", "t_exit")},
                           "kind": "coll_enter"}]
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs))
    got = _cli(trace_cli.main, ["report", "--cluster", cut])
    _expect_rc(got, 0, "trace report --cluster on the cut journal")
    want = f"HANG: rank 1 entered collective seq {stuck_seq}"
    if want not in got[1]:
        fail(f"phase_trace: the cut journal's report does not say "
             f"{want!r}:\n{got[1]}")
    print(f"[trace] b. trace report --cluster: {crep['n_ranks']} ranks, "
          f"{crep['totals']['collectives']} collectives, no desync, no "
          f"hang; rank 1's journal cut inside its last collective: '{want} "
          f"...' [{card}]")

    # c. the Chrome export of the world
    chrome = os.path.join(work, "world.chrome.json")
    _expect_rc(_cli(trace_cli.main, ["export", world, "-o", chrome]), 0,
               "trace export")
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    coll = [e for e in events if e.get("cat") == "collective"]
    flows = [e for e in events if e.get("cat") == "collective_flow"]
    if not coll or {e["pid"] for e in coll} != {0, 1} or not any(
            e["ph"] == "f" for e in flows):
        fail(f"phase_trace: trace export {world}: {len(coll)} collective "
             f"events, {len(flows)} flow events")
    print(f"[trace] c. trace export: {len(events)} events, {len(coll)} on "
          f"the 2 ranks' collective tracks, "
          f"{sum(e['ph'] == 's' for e in flows)} cross-rank arrows [{card}]")

    # d. the program cost harvest on the card
    with open(os.path.join(tmp, DDP_LINES)) as f:
        ddp = [json.loads(ln) for ln in f if ln.strip()]
    for line in [bench_line] + ddp:
        _check_stamps(line, line["metric"] + " " + line.get("strategy", ""))
    ledger_dir = os.path.join(work, "ledger")
    os.makedirs(ledger_dir)
    multichip = {"n_devices": ddp[0]["n_devices"], "backend": "cuda",
                 "device_kind": ddp[0]["device"], "model": "mlp",
                 "param_scale": 1, "strategies": ddp, "schema_version": 2,
                 "run_ord": 1}
    mc_path = os.path.join(ledger_dir, "MULTICHIP_r01.json")
    with open(mc_path, "w") as f:
        json.dump(multichip, f)
    with open(os.path.join(ledger_dir, "BENCH_r01.json"), "w") as f:
        json.dump(bench_line, f)
    cost_path = os.path.join(ledger_dir, "COST_r01.json")
    tel_cost = os.path.join(work, "tel_cost")
    _reset_counts()
    t0 = time.perf_counter()
    got = _cli(trace_cli.main, [
        "cost", "-o", cost_path, "--telemetry", tel_cost, "--form", "both",
        "--artifact", mc_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    _expect_rc(got, 0, "trace cost")
    n = TRACE_COST_REPLICAS * TRACE_COST_STEPS * 2
    expect_launches(launches, {"fused_split_keyed": len(TRACE_KEYED) * n,
                               "threefry_mask": TRACE_XLA * n},
                    "trace cost --form both")
    with open(cost_path) as f:
        cost = json.load(f)
    macs = 784 * 128 + 128 * 128 + 128 * 10
    for r in cost["records"]:
        steps = 2 if r.get("form") == "run" else 1
        flops = (6 * macs * TRACE_COST_BATCH * steps if r["kind"] == "ddp"
                 else 2 * macs * r["batch_per_device"])
        if (r.get("error") or not r["compiled"]
                or not r.get("peak_bytes", 0) > 0
                or not r.get("compile_s", 0) > 0
                or r["analytic_flops"] != flops
                or any(k in r for k in ("flops", "bytes_accessed"))):
            fail(f"phase_trace: trace cost record {r}")
    labels = [r["program"] for r in cost["records"]]
    if len(labels) != 24 or sum(lb.startswith("serve.bucket")
                                for lb in labels) != 8:
        fail(f"phase_trace: trace cost labels {labels}")
    _check_trace(tel_cost, "xla.,mem.")
    att = cost["attribution"]
    if sorted(a["strategy"] for a in att) != sorted(
            r["strategy"] for r in ddp) or any(
            abs(sum(a["shares"].values()) - 1) > 1e-3 for a in att):
        fail(f"phase_trace: trace cost attribution {att}")
    _expect_rc(_cli(trace_cli.main, ["report", "--cost", cost_path,
                                     "--baseline", cost_path]), 0,
               "trace report --cost --baseline itself")
    for r in cost["records"]:
        print(f"[trace] d. {r['program']}: captured in {r.get('compile_s')} "
              f"s, peak {r.get('peak_bytes')} B over its build, capture and "
              f"one replay, graph pool {r.get('temp_bytes')} B, arguments "
              f"{r['argument_bytes']} B, analytic {r['analytic_flops']} "
              f"FLOP, wire {r['wire_bytes']} B [{card}]")
    for a in att:
        sh = a["shares"]
        print(f"[trace] d. attribution {a['program']}: measured step "
              f"{a['measured_step_s'] * 1e3:.3f} ms on {a['n_devices']} "
              f"replicas of the card, compute {sh['compute']:.4f}, exposed "
              f"comm {sh['comm_exposed']:.4f}, overhead {sh['overhead']:.4f} "
              f"[{card}]")
    print(f"[trace] d. trace cost --form both: {len(labels)} programs in "
          f"{wall:.1f} s, launches {launches}, compile_s_total "
          f"{cost['summary']['compile_s_total']} s, peak "
          f"{cost['summary']['peak_hbm_bytes']} B [{card}]")

    # e. the ledger over this run's own card lines
    got = _cli(ledger_cli.main, ["ingest", ledger_dir, "--json"])
    _expect_rc(got, 0, "ledger ingest")
    ing = json.loads(got[1])
    if ing["artifacts"] != 3 or ing["skipped"] or {
            r["source"] for r in ing["rows"]} != {
            "BENCH_r01.json", "MULTICHIP_r01.json", "COST_r01.json"}:
        fail(f"phase_trace: ledger ingest {ing['artifacts']} artifacts, "
             f"skipped {ing['skipped']}")
    got = _cli(ledger_cli.main, ["report", ledger_dir, "--json"])
    _expect_rc(got, 0, "ledger report")
    n_series = json.loads(got[1])["n_series"]
    _expect_rc(_cli(ledger_cli.main, ["gate", ledger_dir]), 0, "ledger gate")
    chrome = os.path.join(work, "ledger.chrome.json")
    _expect_rc(_cli(trace_cli.main, ["export", ledger_dir, "-o", chrome,
                                     "--ledger", ledger_dir]), 0,
               "trace export --ledger")
    with open(chrome) as f:
        tracks = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "C"}
    if len(tracks) != n_series:
        fail(f"phase_trace: trace export --ledger drew {len(tracks)} "
             f"counter tracks for {n_series} series")
    halved = json.loads(json.dumps(multichip))
    halved["run_ord"] = 2
    for r in halved["strategies"]:
        for k in ("value", "images_per_sec"):
            r[k] = r[k] / 2
    r02 = os.path.join(ledger_dir, "MULTICHIP_r02.json")
    with open(r02, "w") as f:
        json.dump(halved, f)
    got = _cli(ledger_cli.main, ["gate", ledger_dir])
    _expect_rc(got, 3, "ledger gate with the halved run")
    series = (f"ddp.images_per_sec/pmean/mlp x1/{ddp[0]['n_devices']}dev/"
              f"b{ddp[0]['per_chip_batch']}/cuda")
    if series not in got[2]:
        fail(f"phase_trace: the halved run's gate does not name {series}:"
             f"\n{got[2]}")
    os.remove(r02)
    future = dict(multichip, schema_version=3, run_ord=3)
    with open(os.path.join(ledger_dir, "MULTICHIP_r03.json"), "w") as f:
        json.dump(future, f)
    got = _cli(ledger_cli.main, ["gate", ledger_dir])
    _expect_rc(got, 1, "ledger gate with a future schema")
    if "schema_version 3 is newer" not in got[2]:
        fail(f"phase_trace: the future schema is not refused by name:\n"
             f"{got[2]}")
    print(f"[trace] e. ledger over this run's card lines: "
          f"{len(ing['rows'])} rows in {n_series} series, gate 0; halved "
          f"MULTICHIP_r02 gate 3 naming {series}; schema_version 3 "
          f"refused by name; trace export --ledger {len(tracks)} counter "
          f"tracks [{card}]")
    print(f"[trace] f. stamps: bench train line xla_compiles "
          f"{bench_line['xla_compiles']}, peak_hbm_bytes "
          f"{bench_line['peak_hbm_bytes']}, compile_s_total "
          f"{bench_line['compile_s_total']}, health_summary "
          f"{bench_line['health_summary']}, run_ord {bench_line['run_ord']}; "
          f"{len(ddp)} ddp lines stamped alike [{card}]")
    print(f"[trace] phase_trace: {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")
    print(json.dumps({"trace": {"cost_summary": cost["summary"],
                                "attribution": att, "card": card}}))
    return {"trace cost --form both (8 replicas x 16 rows)": launches}


def main() -> int:
    t_start = time.perf_counter()

    def elapsed(what):
        print(f"[time] {what}: {time.perf_counter() - t_start:.1f} s from "
              f"the start")
    name, count, card = phase_device()
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    ptxas = ptxas_counts(phase_build())
    elapsed("build")
    max_abs_err = phase_kernels(device)
    split_worst = phase_kernels_split(device)
    worst = phase_kernels_k1_variants(device)
    keyed_worst = phase_kernels_keyed(device)
    seed_worst = phase_kernels_seed_row(device)
    k2_worst = phase_kernels_k2(device)
    k2_bf16_worst = phase_kernels_k2_bf16(device)
    phase_superstep(device)
    k6_worst = phase_kernels_k6(device)
    elapsed("kernel checks")
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_main_streaming(tmp)
        bf16_paths, bf16_walls = phase_main_bf16_k1(tmp)
        paths.update(bf16_paths)
        k2_launches = phase_main_cached(tmp)
        paths.update(phase_main_cached_variants(tmp))
        paths["train --cached --kernel auto"], cached_walls = \
            phase_main_cached_k1(tmp)
        dp_launches = phase_main_dp(device, tmp)
        world_launches = phase_main_world(device, tmp, card)
        epoch_walls = phase_epoch_walls(device, tmp, card)
        elapsed("main paths")
        phase_streams()
        world_launches.update(phase_main_reference(device, tmp, card))
        world_launches["train --dropout_rng torch"] = phase_torch_dropout(
            device, tmp)
        phase_data_benches(card)
        elapsed("the reference configurations")
        phase_serve(device, tmp, card)
        elapsed("serve phase")
        phase_fleet(device, tmp, card)
        elapsed("fleet phase")
    data = capture_data(device)
    capture = phase_capture(device, data, card)
    elapsed("capture phase")
    golden = phase_golden(device, data, card)
    elapsed("golden phase")
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(phase_pipeline(device, data, tmp, card))
        elapsed("pipeline phase")
        paths.update(phase_comm(device, tmp, card))
        elapsed("comm phase")
        chaos = phase_chaos(device, tmp, card)
        paths.update(chaos)
        elapsed("chaos phase")
        tel = phase_telemetry(device, tmp, card)
        paths.update(tel)
        # K2-ws's row reads its paths from k2_launches
        k2_launches.update({k: v for k, v in {**chaos, **tel}.items()
                            if v.get("epoch_step_ws")})
        elapsed("telemetry phase")
        bench_line, k2_launches["bench --epochs 5"] = phase_bench()
        ss = ("--kernel", "pallas_epoch", "--dtype", "bfloat16",
              "--superstep", "8")
        _, paths["bench " + " ".join(ss)] = phase_bench(
            ss, key="epoch_step_mma", bf16=True, superstep=8, design="mma")
        # past MMA_MAX_BATCH the rows design's superstep
        ss = ss[:-1] + (str(ROWS_SUPERSTEP), "--batch_size", str(ROWS_BATCH))
        _, paths["bench " + " ".join(ss)] = phase_bench(
            ss, key="epoch_step_superstep_bf16", bf16=True,
            superstep=ROWS_SUPERSTEP,
            design="rows")
        elapsed("benches")
        paths.update(phase_trace(tmp, card, bench_line))
        elapsed("trace phase")
    prof, busy = phase_profile(device, data)
    elapsed("profiler session")
    capture_summary = report_capture(capture, busy, card)
    all_paths = {**paths, **k2_launches, **dp_launches, **world_launches}
    k1_entries = phase_timing(device, all_paths, max_abs_err, split_worst,
                              card, prof, busy, cached_walls)
    k2_entries = phase_timing_k2(device, k2_launches, k2_worst, card, prof,
                                 all_paths)
    new, rows_rng_bf16 = phase_timing_mma(device, all_paths, worst, card,
                                          prof, busy, bf16_walls)
    new += phase_timing_variants(device, all_paths, worst, card,
                                 rows_rng_bf16)
    keyed = phase_timing_keyed(device, all_paths, keyed_worst, card)
    for e in keyed:
        e.update(ptxas=ptxas, epoch_walls_s=epoch_walls)
    new += keyed
    new += phase_timing_k2_mma(device, all_paths, k2_bf16_worst, card,
                               prof)
    new += phase_timing_k6(device, dp_launches, k6_worst, card, prof)
    seed_rows = phase_timing_seed_row(device, all_paths, seed_worst, card)
    for e in seed_rows:
        e.update(capture=capture_summary,
                 capture_stale_input_checked=capture["stale_input_checked"],
                 golden={k: {"verdict": v["verdict"], "wall_s": v["wall_s"],
                             "curve": v["run"]["curve"]}
                         for k, v in golden.items()})
    new += seed_rows
    times = [e[k] for e in k1_entries for k in ("ms", "plain_ms", "graph_ms")]
    times += [f[k] for f in k2_entries[0]["forms"].values()
              for k in ("rows_ms", "ws_ms", "plain_ms") if f[k] is not None]
    times += [e[k] for e in k2_entries + new for k in ("ms", "plain_ms")]
    for v in times:
        if not (math.isfinite(v) and v > 0):
            fail(f"timing gave {v}")
    kernels = k1_entries + k2_entries + new
    for e in kernels:
        if e["launches"] < 1:
            fail(f"{e['name']} was launched no time on its main path")
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s "
          f"from start to the kernels line, the build included [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


def world_rank(args: list) -> int:
    """`chip_smoke.py --world-rank lockstep|cli|front --out DIR [-- TRAIN
    ARGS]`: one rank of a world that phase_main_world or
    phase_main_reference spawns (front: a serial run too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mode, out = args[0], args[args.index("--out") + 1]
    if mode == "lockstep":
        world_rank_lockstep(out)
    elif mode == "front":
        world_rank_front(out, args[args.index("--") + 1:])
    else:
        world_rank_cli(out, args[args.index("--") + 1:])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world-rank"]:
        sys.exit(world_rank(sys.argv[2:]))
    sys.exit(main())
