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

`--mode stream` times the NetCDF streaming loader (data/loader.py
`NetCDFShardLoader`): gather and normalise of a shuffled 60k-row epoch of
a converted synthetic file, best of 3 epochs after a warm one, with
`--num_workers` read-ahead threads; it names the reader core and has no
tflops or mfu field (it measures the host's disk loader, not the card).
`--mode accuracy` trains the resolved configuration and the reference
configuration (xla, float32, threefry2x32) for `--epochs` epochs (default
10, ACCURACY_EPOCHS) each on the bench workload and reports the first's
final test accuracy with vs_baseline the ratio to the second's
(`measure_train_accuracy`).

`--mode eval` (the JAX bench's `make_eval_program` / `_eval_bench`):
`--epochs` (default 400) reference eval passes of the 10k synthetic test
set (`synthetic_mnist(10000, seed=1)`, uint8 on the card, normalised in
each pass) with `init_params(0)`, each pass's fc1 bias carrying `+ 1e-30 *
mean loss` of the pass before so no pass can be folded away; the window's
passes are ONE captured CUDA graph, best of 5 windows;
`mnist_eval_images_per_sec_per_chip` with forward-only perf fields (2 FLOP
a multiply-add).

`--mode serve` (the JAX bench's `_serve_bench`): the open-loop load
generator (serve/loadgen.py) drives `--requests` single-row requests at
`--offered_rps` (`--shape`) through admission, the micro-batcher and the
engine's captured bucket graphs (`--max_batch`, `--max_delay_ms`,
`--queue_depth`, `--no_fast`); the line reports the achieved rate, p50 /
p95 / p99, batch occupancy, rejects, the front-door overhead, the stage
attribution and `compile_count` (the engine's capture count). With
`--replicas N` > 1 the service is a `FleetService` of N engines sharing
the card (serve/fleet.py), and `retried_requests` and `reloads` are read
from its `serve.fleet.*` / `serve.reload.*` counters.

`--mode input` (the JAX bench's `_input_bench`): the same streaming `fit`
over the same `SyntheticSource` (pipeline/synthetic.py; `--input_batches`
batches of `--batch_size` rows an epoch, `--input_latency_ms` of read
latency a batch, which makes the unpiped loop input-bound), once legacy (0
workers, depth 1) and once piped (`--input_workers`, `--input_depth`),
`--epochs` (default 4) epochs each after a warm run; one line,
`mnist_input_pipeline_batches_per_sec`, with both runs' batches/s, their
data-wait share of the run's wall time and the consumer's per-batch wait
(`data.batch_wait_s` of a registry of their own), and the device syncs
each run made, counted under `torch.cuda.set_sync_debug_mode("warn")` and
held to the JAX mode's budget of 6 an epoch.

`--mode ddp` (the JAX bench's `ddp_strategy_rows` / `_ddp_bench`): one
line a gradient-communication strategy (`--ddp_comm`, default all four;
`--overlap` for the bucketed form), `mnist_ddp_train_images_per_sec_per_chip`,
on a mesh of `--replicas` (default 4) replicas of the card at `--batch_size`
rows a replica, against a 1-replica mesh: the resident-dataset DP step
(train/scan.py `dp_steps`: `CachedSteps`, one captured step a step, the
trainer's `--kernel auto` for the strategy, named in the line's `kernel`)
over `--epochs` (default 10) epochs of 8,192 synthetic rows, best of 3
windows after a warm epoch; `--model` / `--param_scale` the zoo model.
`dp_steps` is also the builder whose programs `trace cost` prices
(telemetry/costs.py). Each line has the ring-model
`bytes_on_wire_per_step_per_replica` and the port's all-gather
`bytes_moved_per_step_per_replica` (parallel/collectives.py), the comm
probe's p50, the schedule's collectives a step, and the drift of 3 steps
at lr 0.05 against pmean. All the replicas share one card, so the rate
per chip is the mesh's rate.

The ddp lines also carry the JAX field names the read side joins on
(telemetry/costs.py `attribution_from_artifact`, analysis.py
`efficiency_report`, the ledger's strategy metrics): `n_devices` (the
replicas), `per_chip_batch` (rows a replica),
`bytes_on_wire_per_step_per_device` and `scaling_efficiency_vs_1dev`. On
one card the last is the mesh's per-chip rate over the 1-replica mesh's
rate, which equals `vs_one_replica` (chips = 1: the per-chip rate is the
mesh's). The attribution's compute C = efficiency x T is then the serial
compute of the n replicas on the one card, which is what the card does.

Every line carries `registry_stamp`: `xla_compiles` (the process's
CUDA-graph captures, the listener armed before any work), `host_rss_mb`,
`device_peak_bytes` / `peak_hbm_bytes` (the allocator's peak on the card),
`compile_s_total` (the captures' seconds), `health_summary`, and the
ledger stamps `schema_version` / `run_ord` (`ledger_stamp_fields`). The
JAX bench's `statics` stamp and the ddp rows' journal and
dispatch-overhead stamps are left out (ROADMAP.md queue 1, item 14). A
run needs a card: no number is taken on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np
import torch

FUSED_EPOCHS = 400
# --mode accuracy trains real epochs; the north-star acceptance names 10
# (BASELINE.json / ddp_tutorial_multi_gpu.py:127)
ACCURACY_EPOCHS = 10
# the JAX bench's defaults of its input and ddp modes
INPUT_EPOCHS = 4
DDP_EPOCHS = 10
DDP_REPLICAS = 4
DDP_ROWS = 8192
# the JAX input mode's host-sync budget (its no_host_sync pin): per epoch
SYNCS_PER_EPOCH = 6
NOMINAL_BASELINE_DDP_IMGS_PER_SEC = 1_000_000.0
NOMINAL_BASELINE_IMGS_PER_SEC = 1_000_000.0
NOMINAL_BASELINE_STREAM_IMGS_PER_SEC = 1_000_000.0
# the JAX bench's nominals of its eval and serve lines (an inference-pass
# rate, an open-loop request rate)
NOMINAL_BASELINE_EVAL_IMGS_PER_SEC = 1_000_000.0
NOMINAL_BASELINE_SERVE_RPS = 1_000.0
# model cost per image: 118,016 forward multiply-adds, backward ~2x forward,
# 2 FLOP per multiply-add -> 6 x 118,016 FLOP (the JAX bench's perf_fields)
MACS_FWD_PER_IMG = 784 * 128 + 128 * 128 + 128 * 10
# dense bf16 tensor-core peak of the card the port targets: NVIDIA H100 SXM,
# 989 TFLOP/s (NVIDIA data sheet; at its 700 W power limit)
PEAK_FLOPS_BF16 = 989e12
PEAK_CARD = "NVIDIA H100 SXM"
WINDOWS = 5


def ledger_stamp_fields() -> dict:
    """The performance-ledger stamp of every line (telemetry/ledger.py
    reads it): the schema generation, and the run ordinal its series sorts
    under, `$PDMT_RUN_ORD` when set, else the wall-clock second."""
    import os

    from .telemetry.ledger import SCHEMA_VERSION
    try:
        run_ord = int(os.environ.get("PDMT_RUN_ORD", ""))
    except ValueError:
        run_ord = int(time.time())
    return {"schema_version": SCHEMA_VERSION, "run_ord": run_ord}


def registry_stamp() -> dict:
    """Capture-count and memory fields of a bench line, read from the
    telemetry registry (main() arms the capture listener before any work,
    so `xla_compiles` covers the process), plus `health_summary` and the
    ledger stamps. `device_peak_bytes` is absent off the card."""
    from . import telemetry
    reg = telemetry.get_registry()
    telemetry.collect_memory(reg)
    snap = reg.snapshot()
    out = {"xla_compiles": snap["counters"].get("xla.compiles")}
    rss = snap["gauges"].get("host.rss_bytes")
    out["host_rss_mb"] = round(rss / 2**20, 1) if rss else None
    dev = snap["gauges"].get("device.peak_bytes_in_use")
    if dev is not None:
        out["device_peak_bytes"] = dev
    out["peak_hbm_bytes"] = snap["gauges"].get("mem.device_peak_bytes")
    ch = snap["histograms"].get("xla.compile_s")
    out["compile_s_total"] = (round(ch["total"], 3)
                              if isinstance(ch, dict)
                              and isinstance(ch.get("total"), (int, float))
                              else None)
    out["health_summary"] = telemetry.health_summary(reg)
    out.update(ledger_stamp_fields())
    return out


def perf_fields(per_chip_imgs_per_sec: float, *,
                fwd_only: bool = False,
                macs_fwd: int = MACS_FWD_PER_IMG) -> dict:
    """{tflops, mfu_pct_vs_bf16_peak} for a measured per-card image rate;
    `fwd_only` for inference rates (eval mode): 2 FLOP a multiply-add, no
    backward; `macs_fwd` the model's forward multiply-adds an image (a zoo
    model's, in ddp mode)."""
    tf = (per_chip_imgs_per_sec * (2 if fwd_only else 6) * macs_fwd
          / 1e12)
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


def run_stream_bench(num_workers: int = 0, trials: int = 4,
                     n_train: int = 60000) -> dict:
    """NetCDF streaming-loader throughput (the JAX bench's `--mode stream`):
    converts a synthetic `n_train`-row train split to a .nc file in a
    temporary directory, then times gather + normalise of whole shuffled
    epochs of batch 128 through `NetCDFShardLoader`; trial 0 warms the page
    cache, the best of the rest counts (the reads are warm). No device
    work, so no tflops or mfu field."""
    import os
    import tempfile

    from .data.convert import main as convert_main
    from .data.loader import NetCDFShardLoader
    from .parallel.sampler import ShardedSampler

    with tempfile.TemporaryDirectory() as td:
        with contextlib.redirect_stdout(io.StringIO()):
            convert_main(["--synthetic", f"{n_train}:16", "--out_dir", td])
        ldr = NetCDFShardLoader(os.path.join(td, "mnist_train_images.nc"),
                                batch_size=128, num_workers=num_workers)
        ldr.sampler = ShardedSampler(n_train, num_replicas=1, rank=0,
                                     shuffle=True, seed=42)
        best, n = float("inf"), 0
        for trial in range(trials):
            ldr.sampler.set_epoch(trial)
            t0 = time.perf_counter()
            n = sum(len(x) for x, _ in ldr)
            if trial:
                best = min(best, time.perf_counter() - t0)
    rate = n / best
    return {"metric": "mnist_netcdf_stream_images_per_sec",
            "value": round(rate, 1), "unit": "images/sec",
            "vs_baseline": round(rate / NOMINAL_BASELINE_STREAM_IMGS_PER_SEC,
                                 4),
            "core": ldr.core, "num_workers": num_workers}


def measure_train_accuracy(device: torch.device, kernel: str, dtype: str,
                           superstep: int, impl: str, epochs: int,
                           n_train: int = 60000, n_test: int = 10000
                           ) -> tuple:
    """(final test accuracy, mean val loss) of an `epochs`-epoch run of the
    given configuration on the bench workload (synthetic MNIST, batch 128,
    SGD 0.01, sampler seed 42, weights MLP.from_seed(0), train key 1): the
    JAX bench's `measure_train_accuracy`, the one helper that `--mode
    accuracy` and the promotion gate's accuracy runs call. The epochs run
    back to back through `make_run_fn`; their losses must be finite."""
    from .data.mnist import normalize_images, synthetic_mnist
    from .models.mlp import MLP
    from .ops.threefry import key_data
    from .parallel.sampler import ShardedSampler
    from .train.loop import evaluate
    from .train.scan import (_load_params, epoch_batch_indices, make_run_fn,
                             resident_images)

    train = synthetic_mnist(n_train, seed=0)
    test = synthetic_mnist(n_test, seed=1)
    x_all = torch.from_numpy(resident_images(train.images)).to(device)
    y_all = torch.from_numpy(train.labels.astype(np.int32)).to(device)
    sampler = ShardedSampler(n_train, num_replicas=1, rank=0, seed=42)
    idxs = []
    for e in range(epochs):
        sampler.set_epoch(e)
        idxs.append(epoch_batch_indices(sampler, 128))
    run = make_run_fn(0.01, kernel=kernel, impl=impl, dtype=dtype,
                      superstep=superstep)
    model = MLP.from_seed(0).to(device)
    params, _, losses = run(model.params(), key_data(1), x_all, y_all,
                            np.stack(idxs))
    if not np.isfinite(losses.cpu().numpy()).all():
        raise RuntimeError(f"accuracy run ({kernel}, {dtype}) gave "
                           f"non-finite losses")
    _load_params(model, params)
    _, mean_loss, acc = evaluate(
        model, torch.from_numpy(normalize_images(test.images)).to(device),
        torch.from_numpy(test.labels.astype(np.int32)).to(device), 128)
    return float(acc), float(mean_loss)


def run_accuracy_bench(device: torch.device, kernel: str, dtype: str,
                       superstep: int, impl: str, epochs: int,
                       **workload) -> dict:
    """`--mode accuracy`: the resolved configuration and the reference
    configuration (xla, float32, threefry2x32, the ddp_tutorial script
    restated) trained `epochs` epochs each; the first's final test
    accuracy with vs_baseline the ratio of the two (1.0 when the kernels
    kept the training outcome) and both mean val losses (the finer
    signal: accuracy saturates on the synthetic stand-in)."""
    acc, loss = measure_train_accuracy(device, kernel, dtype, superstep,
                                       impl, epochs, **workload)
    acc_ref, loss_ref = measure_train_accuracy(device, "xla", "float32", 1,
                                               "threefry2x32", epochs,
                                               **workload)
    return {"metric": f"mnist_{epochs}epoch_test_accuracy",
            "value": round(acc, 4), "unit": "fraction",
            "vs_baseline": round(acc / acc_ref, 4) if acc_ref else None,
            "mean_val_loss": round(loss, 6),
            "ref_mean_val_loss": round(loss_ref, 6),
            "kernel": kernel, "dtype": dtype, "superstep": superstep,
            "impl": impl, "epochs": epochs}


def make_eval_program(reps: int):
    """`reps` reference eval passes of the full test set, dropout off (the
    JAX bench's `make_eval_program`): prog(params, x, y) -> (mean loss,
    accuracy) per pass, each (reps,) float32 on x's device.

    `x` may be raw uint8 pixels: each pass then normalises it on the
    device (data/mnist.py `device_normalize`), as the reference's loader
    does at eval time. Each pass's fc1 bias carries `+ 1e-30 * m`, m the
    previous pass's mean loss: lost in f32 rounding at the bias's scale,
    but every pass depends on the one before, as in the JAX program, where
    it keeps XLA from hoisting the loop-invariant forward out of the
    scan."""
    from .data.mnist import device_normalize
    from .models.mlp import mlp_apply

    @torch.no_grad()
    def prog(params, x, y):
        labels = y.long()[:, None]
        p = dict(params)
        losses, accs = [], []
        for _ in range(reps):
            xf = device_normalize(x) if x.dtype == torch.uint8 else x
            logits = mlp_apply(p, xf, train=False)
            logz = torch.log_softmax(logits.float(), dim=-1)
            m = (-torch.gather(logz, -1, labels)[:, 0]).mean()
            correct = (torch.argmax(logits, dim=-1) == labels[:, 0]).float()
            p["fc1"] = dict(p["fc1"], b=p["fc1"]["b"] + 1e-30 * m)
            losses.append(m)
            accs.append(correct.mean())
        return torch.stack(losses), torch.stack(accs)

    return prog


def run_eval_bench(device: torch.device, *, epochs: int,
                   windows: int = WINDOWS, n_test: int = 10000) -> dict:
    """`--mode eval`: `epochs` eval passes of make_eval_program per window
    over the uint8-resident synthetic test set, weights `init_params(0)`;
    on a card the window is one CUDA graph (captured once, after one eager
    pass warms cuBLAS on a side stream), replayed per window; best of
    `windows`. The passes' losses must be finite."""
    from .data.mnist import synthetic_mnist
    from .models.mlp import init_params
    from .train.scan import resident_images

    split = synthetic_mnist(n_test, seed=1)
    x = torch.from_numpy(resident_images(split.images)).to(device)
    y = torch.from_numpy(split.labels.astype(np.int32)).to(device)
    params = {n: {k: v.to(device) for k, v in layer.items()}
              for n, layer in init_params(0).items()}
    prog = make_eval_program(epochs)
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            make_eval_program(1)(params, x, y)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = prog(params, x, y)

        def window():
            graph.replay()
            torch.cuda.synchronize(device)
            return outs
    else:
        def window():
            return prog(params, x, y)
    losses, accs = window()                    # warm
    if not np.isfinite(losses.cpu().numpy()).all():
        raise RuntimeError("eval bench passes gave non-finite losses")
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        window()
        best = min(best, time.perf_counter() - t0)
    per_chip = n_test * epochs / best
    return {
        "metric": "mnist_eval_images_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(per_chip / NOMINAL_BASELINE_EVAL_IMGS_PER_SEC,
                             4),
        **perf_fields(per_chip, fwd_only=True),
        "epochs": epochs,
        "accuracy": round(float(accs[-1]), 4),
    }


def run_serve_bench(device: torch.device, *, offered_rps: float = 500.0,
                    requests: int = 1000, max_batch: int = 64,
                    max_delay_ms: float = 2.0, queue_depth: int = 256,
                    fast: bool = True, shape: str = "poisson",
                    replicas: int = 1) -> dict:
    """`--mode serve`: `requests` open-loop requests at `offered_rps` through
    ServeService over an engine of `init_params(0)` on `device` (one CUDA
    graph per bucket on a card), or through a FleetService of `replicas`
    such engines, after one direct call per bucket; the JAX bench's
    `_serve_bench` line."""
    from .models.mlp import init_params
    from .serve import FleetService, InferenceEngine, ServeService
    from .serve.loadgen import run_loadgen
    from .telemetry import MetricsRegistry

    # a registry of its own: the line reports THIS run's serve counters
    reg = MetricsRegistry()
    params = init_params(0)
    if replicas > 1:
        service = FleetService(
            lambda p_: InferenceEngine(p_, max_batch=max_batch,
                                       device=device), params,
            n_replicas=replicas, max_batch=max_batch,
            max_delay_ms=max_delay_ms, max_depth=queue_depth, registry=reg,
            fast=fast)
        engine = service.engine
    else:
        engine = InferenceEngine(params, max_batch=max_batch, device=device)
        service = ServeService(engine, max_delay_ms=max_delay_ms,
                               max_depth=queue_depth, registry=reg,
                               fast=fast)
    for b in engine.buckets:
        engine.predict(np.zeros((b, 784), np.float32))
    out = run_loadgen(service, offered_rps=offered_rps, n_requests=requests,
                      seed=0, shape=shape)
    if engine.capture_count != len(engine.buckets):
        raise RuntimeError(f"the engine captured {engine.capture_count} "
                           f"graphs for {len(engine.buckets)} buckets")
    lat, rps = out["latency_ms"], out["achieved_rps"]
    answered = out["completed"] + out["failed"]
    counters = reg.snapshot()["counters"]
    return {
        "metric": "mnist_serve_requests_per_sec",
        "value": rps,
        "unit": "requests/sec",
        "vs_baseline": (round(rps / NOMINAL_BASELINE_SERVE_RPS, 4)
                        if rps else None),
        "offered_rps": out["offered_rps"],
        "shape": out["shape"],
        "p50_ms": lat["p50"], "p95_ms": lat["p95"], "p99_ms": lat["p99"],
        "availability": (round(out["completed"] / answered, 6)
                         if answered else None),
        "replicas": replicas,
        "retried_requests": counters.get("serve.fleet.retried_requests", 0),
        "reloads": counters.get("serve.reload.reloads", 0),
        "front_door_overhead_ms": out["front_door_overhead_ms"],
        "reject_rate": out["reject_rate"],
        "rejected": counters["serve.rejected"],
        "batch_occupancy": out["batch_occupancy"],
        "compile_count": engine.capture_count,
        "fast_path": service.batcher.fast_path,
        "staging_grown": engine.staging_grown,
        "stage_attribution": service.metrics.attribution()["stages"],
    }


def count_syncs(fn, device: torch.device):
    """(fn(), the device syncs it made): on a card `fn` runs under
    `torch.cuda.set_sync_debug_mode("warn")`, whose warnings are counted
    (each blocking copy, `.cpu()` fetch or device synchronize is one); on
    the CPU there is no device to sync with (0)."""
    import warnings
    from .train.graphs import _set_sync_debug_mode
    if device.type != "cuda":
        return fn(), 0
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            _set_sync_debug_mode(mode)
    syncs = sum(1 for w in seen if "synchroniz" in str(w.message))
    return out, syncs


def run_input_bench(device: torch.device, *, epochs: int = INPUT_EPOCHS,
                    batch_size: int = 128, latency_ms: float = 5.0,
                    batches: int = 48, workers: int = 4,
                    depth: int = 2) -> dict:
    """`--mode input`: the streaming `fit` (the captured keyed step of
    `--kernel pallas` on a card, the plain step on the CPU) over
    SyntheticSource, legacy then piped, each after the same warm run; see
    the module docstring. A run over its sync budget raises."""
    from .data.mnist import normalize_images, synthetic_mnist
    from .models.mlp import MLP
    from .ops.fused_step import make_fused_train_step
    from .ops.threefry import key_data
    from .pipeline import SyntheticSource
    from .telemetry import MetricsRegistry
    from .train.loop import TrainState, fit

    test = synthetic_mnist(256, seed=1)
    x_test = normalize_images(test.images)
    y_test = test.labels.astype(np.int32)

    def train(src, w, d, registry, n_epochs):
        step = make_fused_train_step(0.01)
        fit(TrainState(MLP.from_seed(0).to(device), key_data(1)), src,
            x_test, y_test, epochs=n_epochs, batch_size=batch_size,
            train_step=step, input_workers=w, prefetch_depth=d,
            registry=registry, log=lambda _m: None)

    # builds the kernels and warms the libraries outside both runs
    train(SyntheticSource(2, batch_size, seed=0), 0, 1, MetricsRegistry(), 1)

    def run(w, d):
        reg = MetricsRegistry()
        src = SyntheticSource(batches, batch_size,
                              latency_s=latency_ms / 1e3, seed=0)
        t0 = time.perf_counter()
        _, syncs = count_syncs(lambda: train(src, w, d, reg, epochs), device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        budget = epochs * SYNCS_PER_EPOCH
        if syncs > budget:
            raise RuntimeError(f"the input bench's run (workers {w}, depth "
                               f"{d}) made {syncs} device syncs, over the "
                               f"budget of {budget}")
        wait = reg.histogram("data.batch_wait_s")
        return {
            "workers": w, "prefetch_depth": d,
            "batches_per_sec": round(epochs * batches / wall, 1),
            "images_per_sec": round(epochs * batches * batch_size / wall, 1),
            "data_wait_share": round(wait.total / wall, 4),
            "data_wait_s": round(wait.total, 6),
            "data_wait_p95_s": round(wait.percentile(95), 6),
            "batches_seen": reg.counter("data.batches").value,
            "syncs": syncs, "sync_budget": budget,
        }

    legacy = run(0, 1)
    piped = run(workers, depth)
    return {
        "metric": "mnist_input_pipeline_batches_per_sec",
        "value": piped["batches_per_sec"],
        "unit": "batches/sec",
        "vs_baseline": (round(piped["batches_per_sec"]
                              / legacy["batches_per_sec"], 4)
                        if legacy["batches_per_sec"] else None),
        "epochs": epochs, "batch_size": batch_size,
        "batches_per_epoch": batches,
        "read_latency_ms_per_batch": latency_ms,
        "legacy": legacy, "pipeline": piped,
    }


def run_ddp_rows(device: torch.device, *, strategies, replicas: int =
                 DDP_REPLICAS, per_replica_batch: int = 128,
                 epochs: int = DDP_EPOCHS, n_rows: int = DDP_ROWS,
                 model: str = "mlp", param_scale: int = 1,
                 overlap: bool = False, windows: int = 3,
                 parity_steps: int = 3, parity_lr: float = 0.05) -> list:
    """`--mode ddp`'s rows (see the module docstring): one dict a
    strategy, measured on a mesh of `replicas` replicas of `device`
    against a 1-replica mesh of it."""
    from .data.mnist import synthetic_mnist
    from .models.mlp import param_count
    from .models.zoo import resolve_model
    from .ops.threefry import key_data
    from .parallel import collectives
    from .parallel.ddp import make_dp_train_step
    from .parallel.sampler import ShardedSampler
    from .train.scan import (_clone, dp_kernel, dp_steps,
                             epoch_batch_indices, resident_images)

    spec = resolve_model(model, param_scale)
    n_rows = max(n_rows, per_replica_batch * replicas)
    split = synthetic_mnist(n_rows, seed=0)
    x_host = resident_images(split.images)
    y_host = split.labels.astype(np.int32)
    x_all = torch.from_numpy(x_host).to(device)
    y_all = torch.from_numpy(y_host).to(device)
    init = spec.from_seed(0)
    params_host = init.params()
    n_params = param_count(params_host)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def measure(n, comm, ov=False):
        batch = per_replica_batch * n
        sampler = ShardedSampler(n_rows, num_replicas=1, rank=0, seed=42)
        idxs = []
        for e in range(epochs):
            sampler.set_epoch(e)
            idxs.append(epoch_batch_indices(sampler, batch))
        params = _clone({k: {kk: v.to(device) for kk, v in layer.items()}
                         for k, layer in params_host.items()})
        steps = dp_steps(params, x_all, y_all, comm, ov, replicas=n,
                         nsteps=idxs[0].shape[0], batch=per_replica_batch,
                         model=model, param_scale=param_scale)
        key = key_data(1)
        key, ls = steps.epoch(key, idxs[0])        # capture + warm
        if not np.isfinite(ls.cpu().numpy()).all():
            raise RuntimeError(f"ddp bench {comm}: non-finite warm losses")
        best = float("inf")
        for _ in range(windows):
            sync()
            t0 = time.perf_counter()
            for e in range(epochs):
                key, ls = steps.epoch(key, idxs[e])
            ls = ls.cpu().numpy()
            best = min(best, time.perf_counter() - t0)
            if not np.isfinite(ls).all():
                raise RuntimeError(f"ddp bench {comm}: non-finite losses")
        return sum(i.size for i in idxs) / best

    def parity(comm, ov=False):
        mesh = (device,) * replicas
        step = make_dp_train_step(mesh, parity_lr, comm=comm, overlap=ov,
                                  model=model, param_scale=param_scale)
        m = spec.from_seed(0).to(device)
        step.place_comm_state(m.params())
        key, b = key_data(1), per_replica_batch * replicas
        for s in range(parity_steps):
            rows = np.arange(s * b, (s + 1) * b) % n_rows
            x = torch.from_numpy(x_host[rows].astype(np.float32) / 255.0)
            key, _ = step(m, key, x.to(device),
                          torch.from_numpy(y_host[rows]).to(device))
        return [v.detach().cpu().numpy() for v in
                collectives.tree_leaves(m.params())]

    one_rate = measure(1, "pmean")
    ref = parity("pmean")
    dev_params = {k: {kk: v.to(device) for kk, v in layer.items()}
                  for k, layer in params_host.items()}
    rows = []
    for comm in strategies:
        probe = collectives.make_comm_probe((device,) * replicas, comm)
        secs = collectives.measure_collective_seconds(probe, dev_params)
        rate = measure(replicas, comm, overlap)
        got = parity(comm, overlap)
        rel = max(float(np.max(np.abs(a - b) / (np.abs(b) + 1e-12)))
                  for a, b in zip(got, ref))
        absd = max(float(np.max(np.abs(a - b))) for a, b in zip(got, ref))
        wire = collectives.bytes_on_wire(params_host, replicas, comm)
        rows.append({
            "strategy": comm, "overlap": bool(overlap),
            "kernel": dp_kernel(comm, overlap, model, param_scale,
                                device.type),
            "collectives_per_step": len(collectives.collective_schedule(
                params_host, replicas, comm, overlap=overlap)),
            "model": model, "param_scale": param_scale,
            "n_params": n_params, "replicas": replicas, "chips": 1,
            "n_devices": replicas,
            "macs_fwd_per_image": sum(int(layer["w"].numel())
                                      for layer in params_host.values()),
            "per_replica_batch": per_replica_batch,
            "per_chip_batch": per_replica_batch,
            "images_per_sec": round(rate, 1),
            "per_chip_images_per_sec": round(rate, 1),
            "one_replica_images_per_sec": round(one_rate, 1),
            "vs_one_replica": round(rate / one_rate, 4),
            "scaling_efficiency_vs_1dev": round(rate / one_rate, 4),
            "bytes_on_wire_per_step_per_replica": wire,
            "bytes_on_wire_per_step_per_device": wire,
            "bytes_moved_per_step_per_replica":
                collectives.bytes_moved(params_host, replicas, comm,
                                        overlap=overlap),
            "collective_s_p50": round(sorted(secs)[len(secs) // 2], 6),
            "parity_max_rel_diff_vs_pmean": rel,
            "parity_max_abs_diff_vs_pmean": absd,
        })
    return rows


def ddp_lines(rows, stamp: dict) -> list:
    """`--mode ddp`'s output lines: one a `run_ddp_rows` row, the metric
    its per-chip rate, with the perf fields and `stamp` (the backend, the
    device and the registry stamps)."""
    return [{
        "metric": "mnist_ddp_train_images_per_sec_per_chip",
        "value": r["per_chip_images_per_sec"],
        "unit": "images/sec/chip",
        "vs_baseline": round(r["per_chip_images_per_sec"]
                             / NOMINAL_BASELINE_DDP_IMGS_PER_SEC, 4),
        **{k: v for k, v in r.items() if k != "per_chip_images_per_sec"},
        **perf_fields(r["per_chip_images_per_sec"],
                      macs_fwd=r["macs_fwd_per_image"]),
        **stamp} for r in rows]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch bench",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="train",
                   choices=("train", "stream", "accuracy", "eval", "serve",
                            "input", "ddp"))
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "xla", "pallas", "pallas_rng",
                            "pallas_epoch"))
    p.add_argument("--dtype", default="auto",
                   choices=("auto", "float32", "bfloat16"))
    p.add_argument("--impl", default="rbg", choices=("threefry2x32", "rbg"))
    p.add_argument("--epochs", type=int, default=None,
                   help=f"train: epochs per timing window (default "
                        f"{FUSED_EPOCHS}); eval: passes per window (default "
                        f"{FUSED_EPOCHS}); accuracy: epochs trained (default "
                        f"{ACCURACY_EPOCHS}); never read by --mode stream "
                        f"or serve")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--superstep", type=int, default=0,
                   choices=(0, 1, 2, 4, 8))
    p.add_argument("--ring", default="auto",
                   choices=("auto", "allgather", "reduce_scatter"))
    p.add_argument("--unroll", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=0,
                   help="stream mode: read-ahead threads")
    ddp = p.add_argument_group("ddp mode")
    ddp.add_argument("--ddp_comm", default="all",
                     choices=("all", "pmean", "sharded", "bf16", "int8"),
                     help="the strategy(ies) to measure (default all four)")
    ddp.add_argument("--overlap", action="store_true",
                     help="measure the bucketed form of the strategies")
    ddp.add_argument("--model", choices=("mlp", "deep_mlp"), default="mlp")
    ddp.add_argument("--param_scale", type=int, default=1)
    inp = p.add_argument_group("input mode")
    inp.add_argument("--input_latency_ms", type=float, default=5.0,
                     help="synthetic read latency a batch")
    inp.add_argument("--input_batches", type=int, default=48,
                     help="batches an epoch of the synthetic source")
    inp.add_argument("--input_workers", type=int, default=4,
                     help="decode workers of the piped run (legacy: 0)")
    inp.add_argument("--input_depth", type=int, default=2,
                     help="prefetch depth of the piped run (legacy: 1)")
    serve = p.add_argument_group("serve mode")
    serve.add_argument("--offered_rps", type=float, default=500.0)
    serve.add_argument("--requests", type=int, default=1000)
    serve.add_argument("--max_batch", type=int, default=64)
    serve.add_argument("--max_delay_ms", type=float, default=2.0)
    serve.add_argument("--queue_depth", type=int, default=256)
    serve.add_argument("--no_fast", dest="serve_fast", action="store_false",
                       help="the legacy stack-at-flush batcher")
    serve.add_argument("--replicas", type=int, default=None,
                       help="serve: engine replicas on the card behind the "
                            "shared admission layer (> 1: the fleet; default "
                            "1); ddp: replicas of the card's "
                            f"mesh (default {DDP_REPLICAS})")
    serve.add_argument("--shape", choices=("poisson", "ramp", "spike"),
                       default="poisson")
    a = p.parse_args(argv)
    serve_knobs = ("offered_rps", "requests", "max_batch", "max_delay_ms",
                   "queue_depth", "serve_fast", "shape")
    if a.replicas is None:
        a.replicas = DDP_REPLICAS if a.mode == "ddp" else 1
    elif a.mode not in ("serve", "ddp"):
        p.error(f"--replicas is a serve- or ddp-mode knob; --mode {a.mode} "
                f"never reads it")
    if a.mode == "serve":
        if a.epochs is not None:
            p.error("--epochs is never read by --mode serve")
        for dest in ("offered_rps", "requests", "max_batch", "queue_depth",
                     "replicas"):
            if getattr(a, dest) <= 0:
                p.error(f"--{dest} must be > 0")
        if a.max_delay_ms < 0:
            p.error("--max_delay_ms must be >= 0")
    else:
        for dest in serve_knobs:
            if getattr(a, dest) != p.get_default(dest):
                flag = "no_fast" if dest == "serve_fast" else dest
                p.error(f"--{flag} is a serve-mode knob; --mode {a.mode} "
                        f"never reads it")
    if a.mode != "input":
        for dest in ("input_latency_ms", "input_batches", "input_workers",
                     "input_depth"):
            if getattr(a, dest) != p.get_default(dest):
                p.error(f"--{dest} {getattr(a, dest)} is an input-mode "
                        f"knob; --mode {a.mode} never reads it")
    else:
        if a.input_latency_ms < 0:
            p.error("--input_latency_ms must be >= 0")
        if a.input_batches < 1:
            p.error("--input_batches must be >= 1")
        if a.input_workers < 1:
            p.error("--input_workers must be >= 1 (the legacy variant "
                    "already measures 0)")
        if a.input_depth < 1:
            p.error("--input_depth must be >= 1")
    if a.mode != "ddp":
        for dest in ("ddp_comm", "overlap", "model", "param_scale"):
            if getattr(a, dest) != p.get_default(dest):
                p.error(f"--{dest} {getattr(a, dest)} is a ddp-mode knob; "
                        f"--mode {a.mode} never reads it")
    else:
        from .models.zoo import validate_model
        try:
            validate_model(a.model, a.param_scale)
        except ValueError as e:
            p.error(str(e))
        if a.replicas < 2:
            p.error(f"--replicas {a.replicas}: the ddp mode measures a mesh "
                    f"of 2 or more replicas against a 1-replica one")
    if a.epochs is None:
        a.epochs = {"accuracy": ACCURACY_EPOCHS, "input": INPUT_EPOCHS,
                    "ddp": DDP_EPOCHS}.get(a.mode, FUSED_EPOCHS)
    if a.epochs < 1:
        p.error("--epochs must be >= 1")
    # a knob the mode never reads would label a number with a configuration
    # it did not run: refused by name, as in the JAX bench
    blocked = (() if a.mode == "train" else
               ("unroll", "ring", "batch_size") if a.mode == "accuracy" else
               ("kernel", "dtype", "impl", "superstep", "unroll", "ring")
               if a.mode in ("input", "ddp") else
               ("kernel", "dtype", "impl", "superstep", "unroll", "ring",
                "batch_size"))
    for dest in blocked:
        if getattr(a, dest) != p.get_default(dest):
            p.error(f"--{dest} {getattr(a, dest)} is a train-mode variant "
                    f"knob; --mode {a.mode} never reads it")
    if a.mode != "stream" and a.num_workers != 0:
        p.error(f"--num_workers is a stream-mode knob; --mode {a.mode} "
                f"never reads it")
    if a.ring != "auto":
        raise SystemExit(f"--ring {a.ring} selects the DP epoch kernel's "
                         f"in-kernel allreduce, which needs a multi-card "
                         f"mesh; see ROADMAP.md queue 2, K6")
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
    from .telemetry import install_compile_listener
    install_compile_listener()
    device = torch.device("cuda", 0)
    stamp = {"backend": "cuda", "device": torch.cuda.get_device_name(device)}
    if a.mode == "stream":
        out = {**run_stream_bench(a.num_workers), **stamp}
    elif a.mode == "eval":
        out = {**run_eval_bench(device, epochs=a.epochs), **stamp}
    elif a.mode == "serve":
        out = {**run_serve_bench(
            device, offered_rps=a.offered_rps, requests=a.requests,
            max_batch=a.max_batch, max_delay_ms=a.max_delay_ms,
            queue_depth=a.queue_depth, fast=a.serve_fast, shape=a.shape,
            replicas=a.replicas), **stamp}
    elif a.mode == "input":
        out = {**run_input_bench(
            device, epochs=a.epochs, batch_size=a.batch_size,
            latency_ms=a.input_latency_ms, batches=a.input_batches,
            workers=a.input_workers, depth=a.input_depth), **stamp}
    elif a.mode == "ddp":
        strategies = (("pmean", "sharded", "bf16", "int8")
                      if a.ddp_comm == "all" else (a.ddp_comm,))
        rows = run_ddp_rows(device, strategies=strategies,
                            replicas=a.replicas,
                            per_replica_batch=a.batch_size,
                            epochs=a.epochs, model=a.model,
                            param_scale=a.param_scale, overlap=a.overlap)
        for line in ddp_lines(rows, {**stamp, **registry_stamp()}):
            print(json.dumps(line), flush=True)
        return 0
    elif a.mode == "accuracy":
        out = {**run_accuracy_bench(device, kernel, dtype, superstep, a.impl,
                                    a.epochs), **stamp}
    else:
        out = run_train_bench(device, epochs=a.epochs,
                              batch_size=a.batch_size, kernel=kernel,
                              impl=a.impl, dtype=dtype, superstep=superstep)
        out.update({**stamp, "kernel": kernel, "impl": a.impl,
                    "epochs": a.epochs, "peak_bf16_of": PEAK_CARD})
    print(json.dumps({**out, **registry_stamp()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
