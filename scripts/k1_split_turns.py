#!/usr/bin/env python3
"""K1's two designs on one card, in turns: the split design
(csrc/fused_split.cu) and the rows design (csrc/fused_step.cu), f32 at B =
128 with a mask and with the in-kernel Philox draw, per wrapper call and
per call in a CUDA graph (rows, split, split, rows); the split design's
per-phase split from its stamps build at B = 128, 96 and 3; the profiler's
device time per kernel of each design.

    python3 scripts/k1_split_turns.py        # from the repo root, one card

chip_smoke.py takes the same measurements on every run; this script is the
short loop for changing the kernel."""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from pytorch_ddp_mnist_tpu_torch.ops import _build, fused_step  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_split_turns: needs a CUDA card", file=sys.stderr)
        return 2
    _build.build_all(["fused_split", "fused_split_stamps", "fused_step"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    params, x, y, mask = cs._k1_inputs(128, seed=7, device=dev)
    seed = 12345
    for rng in (False, True):
        def call(design, rng=rng):
            if rng:
                return fused_step.fused_loss_and_grads_rng(params, x, y, seed,
                                                           _design=design)
            return fused_step.fused_loss_and_grads(params, x, y, mask,
                                                   _design=design)
        rows, split = (lambda: call("rows")), (lambda: call("split"))
        graphs = [cs._graph_ms(f) for f in (rows, split, split, rows)]
        r, s, _ = cs._turns(rows, split, iters=200, warmup=20)
        print(f"rng={rng} us a call in a CUDA graph (rows, split, split, "
              f"rows): {[round(v * 1e3, 2) for v in graphs]}; per wrapper "
              f"call: rows {r * 1e3:.2f}, split {s * 1e3:.2f}")
    for batch in (128, 96, 3):
        p, xb, yb, mb = cs._k1_inputs(batch, seed=7, device=dev)
        fused_step.split_phase_stamps(p, xb, yb, mb, calls=5)
        _, _, phases, total = fused_step.split_phase_stamps(p, xb, yb, mb,
                                                            calls=50)
        print(f"B={batch} stamps total {total:.2f} us",
              {k: round(v, 3) for k, v in phases.items()})
    out, _ = cs.profile_jobs({
        "split": (lambda: fused_step.fused_loss_and_grads(
            params, x, y, mask, _design="split"), 50,
            ("split_hidden_kernel", "split_rows_kernel", "split_grads_kernel")),
        "rows": (lambda: fused_step.fused_loss_and_grads(
            params, x, y, mask, _design="rows"), 50,
            ("rows_kernel", "grads_kernel"))})
    print("profiler us a call:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
