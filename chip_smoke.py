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
               tolerances, and checks that repeat launches are bitwise equal.
  4. main    — trains the reference MLP at full width for 50 steps (batch
               128, lr 0.01, synthetic MNIST, --kernel auto) through the
               port's trainer CLI, with the kernels' launch counts set to 0
               just before and read just after; checks the epoch line, the
               per-step losses, the launch counts and the .pt checkpoint, and
               holds the losses against the same run with the plain autograd
               step.
  5. timing  — CUDA-event times of each kernel and its plain version at the
               main path's shapes, beside the bound computed from those shapes.
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
# per-step losses of 50 steps, fused kernel vs plain autograd, same masks:
# the two differ only in f32 summation order, compounded over the steps
TRAIN_RTOL = 1e-3

# H100 SXM published peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_STEPS = 50
MAIN_BATCH = 128


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


def _run_trainer(cli_train, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, history = cli_train.train(argv)
    torch.cuda.synchronize()
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[main]   {line}")
    return state, history, out


def phase_main(tmp: str) -> dict:
    from pytorch_ddp_mnist_tpu_torch.cli import train as cli_train
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = os.path.join(tmp, "model.pt")
    argv = ["--device", "0", "--n_epochs", "1",
            "--limit", str(MAIN_STEPS * MAIN_BATCH),
            "--batch_size", str(MAIN_BATCH), "--lr", "0.01",
            "--kernel", "auto", "--seed", "0",
            "--path", os.path.join(tmp, "no_mnist_here"), "--checkpoint", ckpt]
    for k in fused_step.launch_count:
        fused_step.launch_count[k] = 0
    t0 = time.perf_counter()
    state, history, out = _run_trainer(cli_train, argv)
    wall = time.perf_counter() - t0
    launches = dict(fused_step.launch_count)

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
    if launches["fused_step"] != MAIN_STEPS:
        fail(f"fused_step launched {launches['fused_step']} times in "
             f"{MAIN_STEPS} steps (one wrapper call per step expected)")
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


def _device_us_by_kernel(fn, calls: int = 50) -> dict:
    """torch.profiler's device time per call of each CUDA kernel `fn`
    launches, in us; empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {_short(e.key): e.device_time_total / calls
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.count >= calls}


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


def phase_timing(device, launches: dict, max_abs_err: float, card: str):
    from pytorch_ddp_mnist_tpu_torch.ops import fused_step
    params, x, y, mask = _k1_inputs(MAIN_BATCH, seed=7, device=device)
    kernel = lambda: fused_step.fused_loss_and_grads(params, x, y, mask)  # noqa: E731
    plain = lambda: fused_step.fused_loss_and_grads_reference(  # noqa: E731
        params, x, y, mask)
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1, k1, k2, p2 = (_time_ms(f) for f in (plain, kernel, kernel, plain))
    kg = _graph_ms(kernel)
    by_kernel = _device_us_by_kernel(kernel)
    for key, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        print(f"[timing] profiler: {us:9.2f} us/call  {key}")
    if not by_kernel:
        print("[timing] profiler: recorded no device time (not measured)")
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


def main() -> int:
    name, count, card = phase_device()
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    phase_build()
    max_abs_err = phase_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main(tmp)
    entry = phase_timing(device, launches, max_abs_err, card)
    for v in (entry["ms"], entry["plain_ms"], entry["graph_ms"]):
        if not (math.isfinite(v) and v > 0):
            fail(f"timing gave {v}")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
