"""Config / CLI layer of the serial trainer (port of a subset of
`pytorch_ddp_mnist_tpu/train/config.py`, plus the `--kernel auto` policy of
`train/scan.py::resolve_kernel`).

The ported flags keep the JAX trainer's names and defaults, so launch lines
carry over, except `--checkpoint`, which defaults to `model.pt` (the port
writes the reference's torch state_dict; msgpack needs flax). Every other
flag of the JAX trainer is recognised and rejected by name, with the
ROADMAP.md item that will port it.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

# flag of the JAX trainer -> where ROADMAP.md queues its port
NOT_YET_PORTED = {
    "--parallel": "queue 1, item 6 (DDP over torch.distributed)",
    "--wireup_method": "queue 1, item 6 (DDP over torch.distributed)",
    "--cached": "queue 1, item 5 (resident-dataset epochs)",
    "--fused": "queue 1, item 5 (resident-dataset epochs)",
    "--netcdf": "queue 1, item 1 (data plane)",
    "--download": "queue 1, item 1 (data plane)",
    "--hdf5": "queue 1, item 7 (training CLI)",
    "--label_map": "queue 1, item 7 (training CLI)",
    "--sampler_rng": "queue 1, item 3 (sampler)",
    "--dropout_rng": "queue 1, item 4 (train loop)",
    "--eval_shuffle": "queue 1, item 4 (train loop)",
    "--resume": "queue 1, item 8 (step checkpoints)",
    "--start_epoch": "queue 1, item 8 (step checkpoints)",
    "--ckpt_every_steps": "queue 1, item 8 (step checkpoints)",
    "--ckpt_keep": "queue 1, item 8 (step checkpoints)",
    "--fault": "queue 1, item 8 (step checkpoints)",
    "--outage_retries": "queue 1, item 8 (step checkpoints)",
    "--num_workers": "queue 1, item 10 (input pipeline)",
    "--input_workers": "queue 1, item 10 (input pipeline)",
    "--prefetch_depth": "queue 1, item 10 (input pipeline)",
    "--model": "queue 1, item 11 (workload zoo)",
    "--param_scale": "queue 1, item 11 (workload zoo)",
    "--ddp_comm": "queue 1, item 11 (gradient communication)",
    "--ddp-comm": "queue 1, item 11 (gradient communication)",
    "--overlap": "queue 1, item 11 (gradient communication)",
    "--quant_block": "queue 1, item 11 (gradient communication)",
    "--error_feedback": "queue 1, item 11 (gradient communication)",
    "--bf16_rounding": "queue 1, item 11 (gradient communication)",
    "--telemetry": "queue 1, item 12 (telemetry)",
    "--journal": "queue 1, item 12 (telemetry)",
    "--profile": "queue 1, item 12 (telemetry)",
    "--profile_dispatch": "queue 1, item 12 (telemetry)",
    "--health": "queue 1, item 12 (telemetry)",
    "--metrics_port": "queue 1, item 12 (telemetry)",
    "--elastic": "queue 1, item 13 (elastic training)",
    "--reshape": "queue 1, item 13 (elastic training)",
    "--impl": "queue 2, K3 and K5 (in-kernel dropout streams)",
}
NOT_YET_PORTED_VALUES = {
    ("--kernel", "pallas_rng"): "queue 2, K5 (in-kernel dropout draw)",
    ("--kernel", "pallas_epoch"): "queue 2, K2 (whole-epoch kernel)",
    ("--dtype", "bfloat16"): "queue 2, K4 (bf16 operands)",
}


def _not_ported(what: str, where: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to the PyTorch package yet; "
                      f"see ROADMAP.md {where}")


def configure(argv=None) -> Dict[str, Dict[str, Any]]:
    """Parse CLI args into the nested {trainer: {...}, data: {...}} config.
    Exits by name on a flag or value that is not ported yet."""
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch train",
        description="MNIST trainer, PyTorch/CUDA port of pytorch_ddp_mnist_tpu "
                    "(serial streaming path)", allow_abbrev=False)
    t = p.add_argument_group("trainer")
    t.add_argument("--batch_size", type=int, default=128)
    t.add_argument("--n_epochs", "--epochs", type=int, default=1)
    t.add_argument("--lr", type=float, default=0.01)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", type=str, default="0",
                   help="CUDA device ordinal (default 0), or 'cpu' to run "
                        "the plain PyTorch versions of the kernels on the CPU")
    t.add_argument("--checkpoint", type=str, default="model.pt",
                   help="final save as the reference's torch state_dict "
                        "(.pt/.pth); '' skips the save")
    t.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    t.add_argument("--kernel", choices=("auto", "xla", "pallas", "pallas_rng",
                                        "pallas_epoch"), default="auto",
                   help="train step: 'pallas' is the fused step (the CUDA "
                        "kernel on a card, its plain version on the CPU), "
                        "'xla' the plain autograd step, 'auto' (default) the "
                        "fused step on CUDA with float32 and 'xla' otherwise")
    d = p.add_argument_group("data")
    d.add_argument("--path", "--data_path", type=str, default="data/",
                   help="dataset root (IDX files); synthetic data otherwise")
    d.add_argument("--limit", "--data_limit", type=int, default=-1,
                   help="truncate the train set to N samples")
    a, rest = p.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in NOT_YET_PORTED:
            raise _not_ported(flag, NOT_YET_PORTED[flag])
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    for (flag, value), where in NOT_YET_PORTED_VALUES.items():
        if getattr(a, flag[2:]) == value:
            raise _not_ported(f"{flag} {value}", where)
    if a.checkpoint and not a.checkpoint.endswith((".pt", ".pth")):
        raise SystemExit(f"--checkpoint {a.checkpoint!r}: the PyTorch package "
                         f"writes .pt/.pth state_dicts only (msgpack needs "
                         f"flax)")
    return {
        "trainer": {
            "batch_size": a.batch_size, "n_epochs": a.n_epochs, "lr": a.lr,
            "seed": a.seed, "device": a.device, "checkpoint": a.checkpoint,
            "dtype": a.dtype, "kernel": a.kernel,
        },
        "data": {"path": a.path, "limit": a.limit},
    }


def resolve_kernel(kernel: str, dtype: str, device_type: str) -> str:
    """The `--kernel auto` policy: the fused step on CUDA with float32, the
    plain autograd step ('xla') otherwise. Explicit choices pass through."""
    if kernel != "auto":
        return kernel
    return "pallas" if device_type == "cuda" and dtype == "float32" else "xla"
