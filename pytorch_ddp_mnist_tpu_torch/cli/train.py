"""The serial trainer (port of the serial streaming branch of
`pytorch_ddp_mnist_tpu/cli/train.py`).

    python -m pytorch_ddp_mnist_tpu_torch train [--n_epochs N] [--limit N]
        [--batch_size 128] [--lr 0.01] [--seed 0] [--dtype float32|bfloat16]
        [--kernel auto|xla|pallas|pallas_rng|pallas_epoch] [--cached [--fused]]
        [--impl threefry2x32|rbg] [--device 0|cpu] [--checkpoint model.pt]
        [--path data/]

Trains the reference MLP on MNIST (or the synthetic stand-in), prints the
reference epoch line every epoch and saves the reference `.pt` state_dict at
the end. It runs on CUDA device `--device` (default 0); with no card it
exits and names the missing card unless `--device cpu` asks for the CPU.
Without `--cached` it streams batches from the host (train/loop.py); with
it the dataset stays on the device (train/scan.py), `--kernel pallas_rng`
draws each step's dropout inside the fused kernel, and `--kernel
pallas_epoch` runs each epoch as one kernel.

Seeds: the weights come from a CPU `torch.Generator` seeded `--seed` (so
every device starts from the same weights). Both paths key their dropout
masks by jax's threefry key `--seed + 1`, split as the JAX trainer splits
it, so with `--impl threefry2x32` (the default) the masks are the JAX
package's for the same seed. `--kernel pallas_rng` and `--impl rbg` draw
the port's own Philox stream instead (the TPU core PRNG has no CUDA twin).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..data.loader import BatchLoader
from ..data.mnist import get_mnist, normalize_images
from ..models.mlp import MLP, param_count
from ..ops.fused_step import make_fused_train_step
from ..ops.threefry import key_data
from ..parallel.sampler import ShardedSampler
from ..train.checkpoint import save_checkpoint
from ..train.config import configure, resolve_kernel
from ..train.loop import TrainState, fit
from ..train.scan import check_run_args, fit_cached


def resolve_device(spec: str) -> torch.device:
    """`--device` -> torch.device: 'cpu', or a CUDA ordinal that must name
    a card of this machine."""
    if spec == "cpu":
        return torch.device("cpu")
    try:
        index = int(spec)
    except ValueError:
        raise SystemExit(f"--device {spec!r}: expected a CUDA device ordinal "
                         f"or 'cpu'") from None
    if not torch.cuda.is_available():
        raise SystemExit(
            f"--device {index}: no CUDA card is available "
            f"(torch.cuda.is_available() is False). This trainer runs on "
            f"the card; pass --device cpu to run on the CPU instead")
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise SystemExit(f"--device {index}: no such CUDA card (this machine "
                         f"has {count})")
    return torch.device("cuda", index)


def train(argv=None):
    """Everything `main` does; returns (TrainState, per-epoch arrays of the
    per-step losses) for callers that check the run."""
    cfg = configure(argv)
    tcfg, dcfg = cfg["trainer"], cfg["data"]
    device = resolve_device(tcfg["device"])
    # true f32 products, as the JAX package's kernels accumulate, and bf16
    # products reduced in f32, as XLA's are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernel = resolve_kernel(tcfg["kernel"], tcfg["dtype"], device.type)
    try:   # the scan layer's refusals, by name, before any work
        check_run_args(kernel, tcfg["dtype"], 1, 1, tcfg["impl"])
    except ValueError as e:
        raise SystemExit(str(e)) from None

    train_split = get_mnist(dcfg["path"], train=True)
    test_split = get_mnist(dcfg["path"], train=False)
    if dcfg["limit"] and dcfg["limit"] > 0:
        train_split.images = train_split.images[:dcfg["limit"]]
        train_split.labels = train_split.labels[:dcfg["limit"]]
    x_test = normalize_images(test_split.images)
    y_test = test_split.labels.astype(np.int32)
    sampler = ShardedSampler(len(train_split), num_replicas=1, rank=0,
                             shuffle=True, seed=42)

    model = MLP(torch.Generator().manual_seed(tcfg["seed"])).to(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    mode = (f" cached{' fused' if tcfg['fused'] else ''}"
            if tcfg["cached"] else "")
    print(f"pytorch_ddp_mnist_tpu_torch: device={device} ({name}) "
          f"params={param_count(model.params())} "
          f"batch={tcfg['batch_size']} kernel={kernel}{mode} "
          f"impl={tcfg['impl']} dtype={tcfg['dtype']}")
    key = key_data(tcfg["seed"] + 1)

    if tcfg["cached"]:
        key, history = fit_cached(
            model, key, train_split.images,
            train_split.labels.astype(np.int32), sampler, x_test, y_test,
            epochs=tcfg["n_epochs"], batch_size=tcfg["batch_size"],
            lr=tcfg["lr"], kernel=kernel, impl=tcfg["impl"],
            fused=tcfg["fused"], dtype=tcfg["dtype"])
        state = TrainState(model, key)
    else:
        loader = BatchLoader(normalize_images(train_split.images),
                             train_split.labels, sampler,
                             batch_size=tcfg["batch_size"])
        # the JAX trainer's streaming `xla` step takes no dtype: it trains
        # in f32 under --dtype bfloat16, and so does this one
        step = (make_fused_train_step(tcfg["lr"], dtype=tcfg["dtype"])
                if kernel == "pallas" else None)
        state, history = fit(TrainState(model, key), loader, x_test,
                             y_test, epochs=tcfg["n_epochs"],
                             batch_size=tcfg["batch_size"],
                             lr=None if step else tcfg["lr"], train_step=step)
    if tcfg["checkpoint"]:
        save_checkpoint(tcfg["checkpoint"], state.model.params())
        print(f"saved checkpoint to {tcfg['checkpoint']}")
    return state, history


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
