"""Benchmark: MNIST training images/sec on one CUDA card (port of the
single-device train mode of the JAX package's `bench.py`).

    python -m pytorch_ddp_mnist_tpu_torch bench [--epochs 400]
        [--kernel auto|xla|pallas|pallas_rng|pallas_epoch]
        [--dtype auto|float32|bfloat16] [--superstep 0|1|2|4|8]
        [--impl rbg|threefry2x32] [--batch_size 128]

Prints ONE JSON line:
    {"metric": "mnist_train_images_per_sec_per_chip", "value": N,
     "unit": "images/sec/chip", "vs_baseline": N, "tflops": N,
     "mfu_pct_vs_bf16_peak": N, "backend": "cuda", "device": "..."}

Workload: the reference MLP, batch 128, SGD lr 0.01, dropout on, over the
synthetic 60k-row MNIST (uint8 on the card), epoch-reshuffled sampler
indices. Measured path: the resident-dataset trainer (train/scan.py) with
`--epochs` epochs run back to back with no host sync between them
(`make_run_fn`); `--kernel auto` resolves to the whole-epoch kernel
(`pallas_epoch`) on a card with float32 and a batch it takes, and `--impl
rbg` (the default) draws its masks in the kernel from Philox. `--dtype
bfloat16` runs the kernels' bf16-operand modes (with `--kernel auto` it
resolves to `xla`, as in the JAX bench), and `--superstep K` runs K steps
per epoch-kernel iteration (`--kernel pallas_epoch` only). `--dtype auto`
and `--superstep 0` resolve to float32 and 1: the JAX bench resolves them
through a calibration measured on a TPU, which is no evidence for a card,
so the port neither reads nor writes it. Timing: the wall time of a whole
run up to the fetch of its loss curve (a full sync), best of 5 windows
after one warm-up run that builds the kernels.

Only the train mode is ported; every other `--mode` of the JAX bench exits
by name. The JAX bench's registry, statics and ledger stamps are telemetry
(ROADMAP.md queue 1, item 12) and are left out. A run needs a card: no
number is taken on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FUSED_EPOCHS = 400
NOMINAL_BASELINE_IMGS_PER_SEC = 1_000_000.0
# model cost per image: 118,016 forward multiply-adds, backward ~2x forward,
# 2 FLOP per multiply-add -> 6 x 118,016 FLOP (the JAX bench's perf_fields)
MACS_FWD_PER_IMG = 784 * 128 + 128 * 128 + 128 * 10
# dense bf16 tensor-core peak of the card the port targets: NVIDIA H100 SXM,
# 989 TFLOP/s (NVIDIA data sheet; at its 700 W power limit)
PEAK_FLOPS_BF16 = 989e12
PEAK_CARD = "NVIDIA H100 SXM"
WINDOWS = 5

# the JAX bench's other modes -> where ROADMAP.md queues them
NOT_YET_PORTED_MODES = {
    "stream": "queue 1, item 1 (data plane)",
    "eval": "queue 1, item 9 (eval bench + serving)",
    "accuracy": "queue 1, item 7 (training CLI)",
    "serve": "queue 1, item 9 (eval bench + serving)",
    "ddp": "queue 1, item 11 (gradient communication)",
    "input": "queue 1, item 10 (input pipeline)",
}


def perf_fields(per_chip_imgs_per_sec: float) -> dict:
    """{tflops, mfu_pct_vs_bf16_peak} for a measured per-card image rate."""
    tf = per_chip_imgs_per_sec * 6 * MACS_FWD_PER_IMG / 1e12
    return {"tflops": round(tf, 2),
            "mfu_pct_vs_bf16_peak": round(100 * tf * 1e12 / PEAK_FLOPS_BF16, 2)}


def resolve_bench_kernel(kernel: str, dtype: str, device_type: str,
                         batch: int = 128, unroll: int = 1) -> str:
    """bench's `--kernel auto`: the trainer's policy (the fused step on CUDA
    with float32), promoted to the whole-epoch kernel where it takes the
    batch (divisible by 8, at most 1024) and there is no unroll."""
    from .ops.epoch_step import EPOCH_KERNEL_MAX_BATCH
    from .train.config import resolve_kernel
    if kernel != "auto":
        return kernel
    kernel = resolve_kernel(kernel, dtype, device_type)
    if (kernel == "pallas" and unroll == 1 and batch % 8 == 0
            and batch <= EPOCH_KERNEL_MAX_BATCH):
        kernel = "pallas_epoch"
    return kernel


def resolve_bench_config(dtype: str, superstep: int) -> tuple:
    """bench's `--dtype auto` / `--superstep 0` -> (float32, 1); explicit
    values pass through. (The JAX bench resolves them through its TPU
    calibration, scripts/promote_epoch_dtype.py; no card has one yet.)"""
    return (dtype if dtype != "auto" else "float32",
            superstep if superstep != 0 else 1)


def run_train_bench(device: torch.device, *, epochs: int, batch_size: int,
                    kernel: str, impl: str, dtype: str = "float32",
                    superstep: int = 1, n_train: int = 60000,
                    windows: int = WINDOWS, lr: float = 0.01) -> dict:
    """Time `windows` runs of `epochs` epochs on `device` and return the
    JSON fields (without backend/device). The losses of every run must be
    finite."""
    from .data.mnist import synthetic_mnist
    from .models.mlp import MLP
    from .ops.threefry import key_data
    from .parallel.sampler import ShardedSampler
    from .train.scan import epoch_batch_indices, make_run_fn, resident_images

    split = synthetic_mnist(n_train, seed=0)
    x_all = torch.from_numpy(resident_images(split.images)).to(device)
    y_all = torch.from_numpy(split.labels.astype(np.int32)).to(device)
    sampler = ShardedSampler(n_train, num_replicas=1, rank=0, seed=42)
    idxs = []
    for e in range(epochs):
        sampler.set_epoch(e)
        idxs.append(epoch_batch_indices(sampler, batch_size))
    idxs = np.stack(idxs)
    run = make_run_fn(lr, kernel=kernel, impl=impl, dtype=dtype,
                      superstep=superstep)
    params = MLP.from_seed(0).to(device).params()
    key = key_data(1)

    losses = run(params, key, x_all, y_all, idxs)[2].cpu().numpy()  # warm-up
    if not np.isfinite(losses).all():
        raise RuntimeError("bench warm-up run gave non-finite losses")
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        losses = run(params, key, x_all, y_all, idxs)[2].cpu().numpy()
        best = min(best, time.perf_counter() - t0)
        if not np.isfinite(losses).all():
            raise RuntimeError("bench run gave non-finite losses")
    imgs_per_sec = idxs.size / best
    return {
        "metric": "mnist_train_images_per_sec_per_chip",
        "value": round(imgs_per_sec, 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(imgs_per_sec / NOMINAL_BASELINE_IMGS_PER_SEC, 4),
        **perf_fields(imgs_per_sec),
        "dtype": dtype, "superstep": superstep,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch bench",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="train",
                   choices=("train",) + tuple(NOT_YET_PORTED_MODES))
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "xla", "pallas", "pallas_rng",
                            "pallas_epoch"))
    p.add_argument("--dtype", default="auto",
                   choices=("auto", "float32", "bfloat16"))
    p.add_argument("--impl", default="rbg", choices=("threefry2x32", "rbg"))
    p.add_argument("--epochs", type=int, default=FUSED_EPOCHS,
                   help=f"epochs per timing window (default {FUSED_EPOCHS})")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--superstep", type=int, default=0,
                   choices=(0, 1, 2, 4, 8))
    p.add_argument("--ring", default="auto",
                   choices=("auto", "allgather", "reduce_scatter"))
    p.add_argument("--unroll", type=int, default=1)
    a = p.parse_args(argv)
    if a.mode != "train":
        raise SystemExit(f"--mode {a.mode} is not ported to the PyTorch "
                         f"package yet; see ROADMAP.md "
                         f"{NOT_YET_PORTED_MODES[a.mode]}")
    if a.ring != "auto":
        raise SystemExit(f"--ring {a.ring} selects the DP epoch kernel's "
                         f"in-kernel allreduce, which needs a multi-card "
                         f"mesh; see ROADMAP.md queue 2, K6")
    if a.epochs < 1:
        p.error("--epochs must be >= 1")
    # the run's configuration, resolved for the card before any work; dtype
    # 'auto' is float32 for the kernel's resolution, as in the JAX bench
    kernel = resolve_bench_kernel(
        a.kernel, "float32" if a.dtype == "auto" else a.dtype, "cuda",
        batch=a.batch_size, unroll=a.unroll)
    dtype, superstep = resolve_bench_config(a.dtype, a.superstep)
    if superstep != 1 and kernel != "pallas_epoch":
        raise SystemExit(f"--superstep {superstep} is a whole-epoch-kernel "
                         f"knob; the resolved kernel is {kernel!r} (use "
                         f"--kernel pallas_epoch, or drop --superstep)")
    from .train.scan import check_run_args
    try:
        check_run_args(kernel, dtype, a.unroll, superstep, a.impl)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if not torch.cuda.is_available():
        raise SystemExit("bench measures the card: no CUDA card is available "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    out = run_train_bench(device, epochs=a.epochs, batch_size=a.batch_size,
                          kernel=kernel, impl=a.impl, dtype=dtype,
                          superstep=superstep)
    out.update({"backend": "cuda", "device": torch.cuda.get_device_name(device),
                "kernel": kernel, "impl": a.impl, "epochs": a.epochs,
                "peak_bf16_of": PEAK_CARD})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
