#!/usr/bin/env python3
"""The trainer's streaming epoch on one card, in turns: a checkout of an
earlier commit (`--parent`) and this tree, both without flags, and this
tree with the in-run telemetry flags (`--telemetry DIR --health warn
--metrics_port 0`). Each run is `python -m pytorch_ddp_mnist_tpu_torch
train` at the reference's shapes (784-128-128-10, B = 128, lr 0.01) on
60,000 synthetic rows: the captured K1-split keyed step, 469 steps an
epoch. An epoch's wall time is read from its line (its images over its
img/s, the epoch's eval included); the first epoch, which captures the
step, is left out.

    python3 scripts/telemetry_overhead_turns.py --parent DIR   # one card

The order in each turn is parent, change, flagged, flagged, change,
parent. Prints the card's name and power limit, each run's epoch times,
and each variant's median epoch; the last line is one JSON object of the
same."""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

BATCH = 128
STEPS = 469                  # 60,000 rows at B = 128
EPOCH_LINE = re.compile(r"^Epoch=(\d+), .* (\d+) img/s", re.M)


def write_data(root: str) -> str:
    from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
    for prefix, n, seed in (("train", 60000, 0), ("t10k", 10000, 1)):
        split = synthetic_mnist(n, seed=seed)
        cs._write_idx(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                      split.images)
        cs._write_idx(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                      split.labels)
    return root


def run(tree: str, idx: str, work: str, epochs: int, flags=(),
        device: str = "0") -> list:
    """One trainer process from `tree`; the epoch times (s) after the
    first."""
    argv = [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
            "--device", device, "--batch_size", str(BATCH), "--lr", "0.01",
            "--seed", "0", "--path", idx, "--n_epochs", str(epochs),
            "--checkpoint", os.path.join(work, "final.msgpack"), *flags]
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: train exited {out.returncode}\n"
                         f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    lines = [(int(e), int(rate)) for e, rate in
             EPOCH_LINE.findall(out.stdout)]
    if [e for e, _ in lines] != list(range(epochs)):
        raise SystemExit(f"{tree}: epoch lines {lines}\n{out.stdout[-2000:]}")
    return [STEPS * BATCH / rate for _, rate in lines[1:]]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the root of a checkout of the earlier commit")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("telemetry_overhead_turns: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    parent = os.path.abspath(a.parent)
    with tempfile.TemporaryDirectory() as work:
        idx = os.path.join(work, "idx")
        os.makedirs(idx)
        write_data(idx)
        tel = os.path.join(work, "tel")
        variants = {"parent": (parent, ()), "change": (HERE, ()),
                    "flagged": (HERE, ("--telemetry", tel, "--health",
                                       "warn", "--metrics_port", "0"))}
        times = {k: [] for k in variants}
        for turn in range(a.turns):
            for name in ("parent", "change", "flagged", "flagged", "change",
                         "parent"):
                tree, flags = variants[name]
                epochs = run(tree, idx, work, a.epochs, flags)
                times[name].extend(epochs)
                print(f"turn {turn} {name}: epoch ms "
                      f"{[round(t * 1e3, 3) for t in epochs]}", flush=True)
    summary = {k: {"median_ms": statistics.median(v) * 1e3,
                   "min_ms": min(v) * 1e3, "max_ms": max(v) * 1e3,
                   "epochs": len(v)} for k, v in times.items()}
    for k, v in summary.items():
        print(f"{k}: median epoch {v['median_ms']:.3f} ms (min "
              f"{v['min_ms']:.3f}, max {v['max_ms']:.3f}, {v['epochs']} "
              f"epochs) [{card}]")
    print(json.dumps({"card": card, "epoch_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
