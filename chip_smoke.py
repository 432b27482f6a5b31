#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero; no phase is skipped):
  1. device  — needs torch.cuda.is_available(); prints the card's name,
               the device count and nvidia-smi's name and power limit.
  2. build   — builds every kernel from the sources under
               pytorch_ddp_mnist_tpu_torch/csrc/ and prints what
               `nvcc -Xptxas -v` reported.
  3. kernels — holds each kernel against its plain PyTorch version on the
               card, on the same numpy-seeded inputs, with the stated
               tolerances, and checks that repeat launches are bitwise equal:
               K1 (fused_step) at B = 128/1000/3; K2 (epoch_step) in its
               four forms (K2a f32 rows + masks, K2b uint8 rows + masks, K2c
               uint8 + in-kernel Philox, K3 uint8 + in-kernel threefry) at
               B = 128 x 24 steps and B = 8 x 5 steps: in-kernel masks of
               K2c and K3 bitwise against the plain streams, the epoch
               bitwise against K1 + SGD per step, and against its plain
               version (losses per step; params in Frobenius norm).
  4. main    — the port's main paths through the entry points a user calls,
               at full width (batch 128, lr 0.01, synthetic MNIST), each with
               every kernel's launch count set to 0 just before it and read
               just after:
               a. `train` streaming, 50 steps, --kernel auto (K1 per step),
                  held against the same run with the plain autograd step;
               b. `train --cached --kernel pallas_epoch --impl threefry2x32`,
                  one full epoch of 469 steps in ONE K2 launch, held against
                  the same run on the CPU (plain versions, same masks);
               c. `train --cached --fused --n_epochs 2`, two K2 launches;
               d. `bench --epochs 5`, whose JSON line is printed.
  5. timing  — CUDA-event times of each kernel and its plain version at the
               main path's shapes, torch.profiler's device time, beside the
               bound computed from those shapes.
The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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

# H100 SXM published peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
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
    built = _build.build_all()
    print(f"[build] {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, (so, log) in built.items():
        print(f"[build] {name}: {os.path.relpath(so, REPO)}")
        for line in log.splitlines():
            if line.strip():
                print(f"[build]   {line.strip()}")


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
        print(f"[kernels] fused_step B={batch}: loss {float(got[0][1]):.7f} "
              f"vs plain {float(ref[0][1]):.7f}; worst abs err {b_abs:.3e}, "
              f"worst rel err {b_rel:.3e}; repeat launch bitwise equal")
    return worst_abs


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


def phase_kernels_k2(device) -> dict:
    """K2 in every form: its in-kernel masks bitwise against the plain
    streams, a repeat launch bitwise, the epoch bitwise against K1 + SGD
    per step, and the epoch against its plain version (losses at LOSS_RTOL
    / 1e-6; params by PARAM_FRO_RTOL, see there). Returns the worst absolute
    error against the plain version per form."""
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
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
            grid = epoch_step.last_launch["blocks"]
            again = _k2_flat(*_k2_call(epoch_step.epoch_fused_sgd, form, inp))
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
            print(f"[kernels] {tag}: final loss {float(got[0][1][-1]):.7f} vs "
                  f"plain {float(ref[0][1][-1]):.7f}; worst abs err {f_abs:.3e}"
                  f", params' worst relative Frobenius err {f_fro:.3e}; "
                  f"bitwise equal to K1 + SGD per step and to a repeat launch;"
                  f" inputs unchanged"
                  f"{'' if rng == 'masks' else '; in-kernel masks bitwise'}"
                  f" (grid {grid} blocks)")
    return worst


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
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
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
    if launches != {"fused_step": MAIN_STEPS, "epoch_step": 0}:
        fail(f"launches {launches} in {MAIN_STEPS} streaming steps (one "
             f"fused_step wrapper call per step expected, no epoch_step)")
    saved = load_checkpoint(ckpt)
    for name, layer in state.model.params().items():
        for k, p in layer.items():
            if not torch.equal(saved[name][k], p.detach().cpu()):
                fail(f"checkpoint {name}.{k} does not load back bitwise")
    print(f"[main] {MAIN_STEPS} steps in {wall:.2f}s (wall, data "
          f"generation and eval included); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; fused_step launches {launches['fused_step']}; "
          f"checkpoint loads back bitwise")

    # the same run with the plain autograd step: same seeds, so same
    # weights, batches and dropout masks
    plain_argv = list(argv)
    plain_argv[plain_argv.index("auto")] = "xla"
    plain_argv[-1] = ""
    _, plain_history, _ = _run_trainer(cli_train, plain_argv)
    if fused_step.launch_count["fused_step"] != launches["fused_step"]:
        fail("--kernel xla launched the fused kernel")
    rel = np.abs(losses - plain_history[0]) / np.abs(plain_history[0])
    if not (rel <= TRAIN_RTOL).all():
        fail(f"per-step losses off the autograd run by up to {rel.max():.3e} "
             f"(rtol {TRAIN_RTOL})")
    print(f"[main] per-step losses vs the autograd step: worst rel diff "
          f"{rel.max():.3e} (rtol {TRAIN_RTOL})")
    return launches


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
    if cached != {"fused_step": 0, "epoch_step": 1}:
        fail(f"train --cached --kernel pallas_epoch: launches {cached} in one "
             f"epoch (one epoch_step launch expected)")
    if epoch_step.last_launch["form"] != "uint8/threefry":
        fail(f"the cached epoch ran form {epoch_step.last_launch['form']}, "
             f"not uint8/threefry (K3)")
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
    if _counts() != {"fused_step": 0, "epoch_step": 0}:
        fail(f"the CPU run launched a kernel: {_counts()}")
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
    if fused != {"fused_step": 0, "epoch_step": 2}:
        fail(f"train --cached --fused --n_epochs 2: launches {fused} (two "
             f"epoch_step launches expected)")
    if not np.array_equal(fused_history[0], losses):
        fail("the fused run's first epoch differs from the cached run's")
    print(f"[main] train --cached --fused --n_epochs 2: {wall:.2f}s (wall); "
          f"launches {fused}; epoch 0 bitwise equal to the unfused run")
    return {"train --cached": cached, "train --cached --fused --n_epochs 2":
            fused}


def phase_bench() -> tuple:
    """Path d: the bench entry point; returns (its JSON line, launches)."""
    from pytorch_ddp_mnist_tpu_torch import bench
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    buf = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--epochs", str(BENCH_EPOCHS)])
    torch.cuda.synchronize()
    launches = _counts()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if rc != 0 or not lines:
        fail(f"bench exited {rc} with output {buf.getvalue()!r}")
    line = json.loads(lines[-1])
    want = BENCH_EPOCHS * (bench.WINDOWS + 1)
    if launches != {"fused_step": 0, "epoch_step": want}:
        fail(f"bench --epochs {BENCH_EPOCHS}: launches {launches} ({want} "
             f"epoch_step launches expected)")
    if epoch_step.last_launch["form"] != "uint8/core":
        fail(f"bench ran form {epoch_step.last_launch['form']}, not "
             f"uint8/core (K2c)")
    for k in ("metric", "value", "unit", "vs_baseline", "tflops",
              "mfu_pct_vs_bf16_peak", "backend", "device"):
        if k not in line:
            fail(f"the bench line has no {k!r}: {line}")
    if not (line["value"] > 0 and line["backend"] == "cuda"):
        fail(f"bench line {line}")
    print(f"[main] bench --epochs {BENCH_EPOCHS}: launches {launches}")
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


def profile_jobs(jobs: dict) -> dict:
    """torch.profiler's device time per call of each CUDA kernel (and copy),
    for jobs {label: (fn, calls, names)} run in turn inside ONE profiler
    session: a job owns the kernels whose short names it lists, the one job
    with names None every other one. Returns {label: {name: us per call}},
    empty where the profiler recorded no device time. One session, taken
    before any CUDA graph capture: a second session later in the run
    recorded no device time on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn, _, _ in jobs.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, calls, _ in jobs.values():
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    owner = {name: label for label, (_, _, names) in jobs.items()
             for name in names or ()}
    rest = [label for label, (_, _, names) in jobs.items() if names is None]
    out = {label: {} for label in jobs}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA \
                or e.device_time_total <= 0:
            continue
        name = _short(e.key)
        label = owner.get(name, rest[0] if rest else None)
        if label is not None:
            out[label][name] = (out[label].get(name, 0.0)
                                + e.device_time_total / jobs[label][1])
    return out


def _short(kernel_name: str) -> str:
    m = re.search(r"[A-Za-z]+(?:_[A-Za-z]+)*_kernel", kernel_name)
    return m.group(0) if m else kernel_name[:60]


def k1_bound(batch: int):
    """(bound_ms, bound_by) of one fused step: each input read once, each
    output written once; the six products' multiply-adds (elementwise work
    left out) at the f32 CUDA-core peak."""
    i, h1, h2, c = 784, 128, 128, 10
    n_params = i * h1 + h1 + h1 * h2 + h2 + h2 * c
    flops = 2 * batch * (2 * (i * h1 + h1 * h2 + h2 * c) + c * h2 + h2 * h1)
    nbytes = 4 * (batch * i + batch * h1 + batch) + 4 * n_params \
        + 4 * (n_params + 1)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_timing(device, launches: dict, max_abs_err: float, card: str,
                 by_kernel: dict):
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    kernel = lambda: fused_step.fused_loss_and_grads(params, x, y, mask)  # noqa: E731
    plain = lambda: fused_step.fused_loss_and_grads_reference(  # noqa: E731
        params, x, y, mask)
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1, k1, k2, p2 = (_time_ms(f) for f in (plain, kernel, kernel, plain))
    kg = _graph_ms(kernel)
    bound_ms, bound_by, flops, nbytes = k1_bound(MAIN_BATCH)
    entry = {
        "name": "fused_step", "route": "cuda",
        "source": "pytorch_ddp_mnist_tpu_torch/csrc/fused_step.cu",
        "replaces": "pytorch_ddp_mnist_tpu/ops/pallas_step.py:191",
        "launches": launches["fused_step"], "max_abs_err": max_abs_err,
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        # extras: device time per call with no host in the way, the CUDA
        # launches behind one wrapper call, and the bound's inputs
        "graph_ms": kg, "cuda_launches_per_call": 2, "batch": MAIN_BATCH,
        "flop": flops, "bytes": nbytes,
        "profiler_us_per_call": by_kernel, "card": card,
    }
    print(f"[timing] fused_step B={MAIN_BATCH}: {entry['ms'] * 1e3:.2f} us "
          f"per wrapper call ({k1 * 1e3:.2f}, {k2 * 1e3:.2f}), "
          f"{kg * 1e3:.2f} us per call in a CUDA graph; plain "
          f"{entry['plain_ms'] * 1e3:.2f} us ({p1 * 1e3:.2f}, {p2 * 1e3:.2f}); "
          f"bound {bound_ms * 1e3:.3f} us by {bound_by}; no single PyTorch "
          f"call computes this fused function, so library_ms is null "
          f"[{card}]")
    return entry


def k2_bound(batch: int, nsteps: int, form: str):
    """(bound_ms, bound_by, flop, bytes) of one K2 epoch in `form`: each
    input read once (rows, labels, masks or key table, weights), each output
    written once (weights, losses); the steps' products at the f32 peak."""
    pixels, rng = K2_FORMS[form]
    n_params = 784 * 128 + 128 + 128 * 128 + 128 + 128 * 10
    flops = nsteps * k1_bound(batch)[2]
    rows = nsteps * batch
    nbytes = rows * 784 * (1 if pixels == "uint8" else 4) + 4 * rows \
        + (4 * 128 * rows if rng == "masks" else 0) \
        + (8 * nsteps if rng == "threefry" else 0) \
        + 2 * 4 * n_params + 4 * nsteps
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_profile(device) -> dict:
    """The profiler's device time per call of K1 (B = 128) and of one epoch
    of the cached path at the main path's shapes (B = 128, 469 steps,
    --impl rbg): the gathers of the epoch's rows and K2 (K2c)."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.train import scan
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    split = synthetic_mnist(60000, seed=0)
    x_all = torch.from_numpy(scan.resident_images(split.images)).to(device)
    y_all = torch.from_numpy(split.labels.astype(np.int32)).to(device)
    sampler = ShardedSampler(60000, seed=42)
    idx = scan.epoch_batch_indices(sampler, MAIN_BATCH)
    epoch = scan.make_epoch_fn(LR, kernel="pallas_epoch", impl="rbg")
    jobs = {
        "fused_step": (lambda: fused_step.fused_loss_and_grads(
            params, x, y, mask), 50, ("rows_kernel", "grads_kernel")),
        "cached_epoch": (lambda: epoch(params, (0, 1), x_all, y_all, idx), 3,
                         None),
    }
    out = profile_jobs(jobs)
    for label, kernels in out.items():
        for key, us in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print(f"[timing] profiler {label}: {us:12.2f} us/call  {key}")
        if not kernels:
            print(f"[timing] profiler {label}: recorded no device time "
                  f"(not measured)")
    return out


def phase_timing_k2(device, launches: dict, worst: dict, card: str,
                    prof: dict):
    """K2 in each form at the main path's shapes (B = 128, 469 steps)."""
    from pytorch_ddp_mnist_tpu_torch.ops import epoch_step
    inp = _k2_inputs(MAIN_BATCH, EPOCH_STEPS, seed=11, device=device)
    forms = {}
    for form in K2_FORMS:
        kernel = lambda: _k2_call(epoch_step.epoch_fused_sgd, form, inp)  # noqa: E731
        plain = lambda: _k2_call(  # noqa: E731
            epoch_step.epoch_fused_sgd_reference, form, inp)
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = _time_ms(plain, iters=1, warmup=1)
        k1, k2 = (_time_ms(kernel, iters=5, warmup=1) for _ in range(2))
        p2 = _time_ms(plain, iters=1, warmup=0)
        bound_ms, bound_by, flops, nbytes = k2_bound(MAIN_BATCH, EPOCH_STEPS,
                                                     form)
        forms[form] = {"form": "/".join(K2_FORMS[form]), "ms": min(k1, k2),
                       "plain_ms": min(p1, p2), "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": worst[form],
                       "flop": flops, "bytes": nbytes,
                       "grid_blocks": epoch_step.last_launch["blocks"]}
        print(f"[timing] epoch_step {form} ({forms[form]['form']}) "
              f"B={MAIN_BATCH} S={EPOCH_STEPS}: {min(k1, k2):.3f} ms per "
              f"epoch launch ({k1:.3f}, {k2:.3f}); plain {min(p1, p2):.1f} ms "
              f"({p1:.1f}, {p2:.1f}); bound {bound_ms:.4f} ms by {bound_by} "
              f"[{card}]")
    main_form = "K2c"       # uint8 rows, in-kernel Philox: the bench default
    f = forms[main_form]
    entry = {
        "name": "epoch_step", "route": "cuda",
        "source": "pytorch_ddp_mnist_tpu_torch/csrc/epoch_step.cu",
        "replaces": "pytorch_ddp_mnist_tpu/ops/pallas_step.py:433",
        "launches": launches["train --cached"]["epoch_step"],
        "max_abs_err": max(worst.values()),
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": None,
        # extras: which form the top-level numbers are, every form's
        # numbers, the launches of each main path, the profiler's device
        # time per call
        "timed_form": main_form, "forms": forms,
        "launches_by_path": {k: v["epoch_step"] for k, v in launches.items()},
        "batch": MAIN_BATCH, "steps": EPOCH_STEPS,
        "profiler_us_per_call": {
            k: v for k, v in prof["cached_epoch"].items()
            if k == "epoch_kernel"},
        "cached_epoch_profiler_us": prof["cached_epoch"],
        "card": card,
    }
    print(f"[timing] epoch_step: no single PyTorch call computes an epoch of "
          f"SGD, so library_ms is null")
    return entry


def main() -> int:
    name, count, card = phase_device()
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    phase_build()
    max_abs_err = phase_kernels(device)
    k2_worst = phase_kernels_k2(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_streaming(tmp)
        k2_launches = phase_main_cached(tmp)
    _, k2_launches["bench --epochs 5"] = phase_bench()
    prof = phase_profile(device)
    entry = phase_timing(device, launches, max_abs_err, card,
                         prof["fused_step"])
    k2_entry = phase_timing_k2(device, k2_launches, k2_worst, card, prof)
    times = [entry["ms"], entry["plain_ms"], entry["graph_ms"]]
    times += [f[k] for f in k2_entry["forms"].values()
              for k in ("ms", "plain_ms")]
    for v in times:
        if not (math.isfinite(v) and v > 0):
            fail(f"timing gave {v}")
    print(json.dumps({"kernels": [entry, k2_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
