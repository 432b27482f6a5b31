#!/usr/bin/env python3
"""K1's bf16 forms on one card: chip_smoke.py's checks of the mma design
(csrc/fused_mma.cu, the six products on the tensor cores) against the
plain version and the rows design (csrc/fused_step.cu); then, at B = 128,
the two designs in turns (rows, mma, mma, rows) per wrapper call and per
call in a CUDA graph, the mma design's per-phase split from its stamps
build at B = 128, 96 and 3, and the profiler's device time per kernel of
each design.

    python3 scripts/k1_mma_turns.py        # from the repo root, one card

chip_smoke.py takes the same checks and timings on every run; this script
is the short loop for changing the kernel. It exits non-zero on a failed
check."""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from pytorch_ddp_mnist_tpu_torch.ops import _build, fused_step  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_mma_turns: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build_all(["fused_mma", "fused_mma_stamps", "fused_step"])
    for line in built["fused_mma"][1].splitlines():
        print("[build]", line.strip())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    cs._check_mma(dev)

    params, x, y, mask = cs._k1_inputs(cs.MAIN_BATCH, seed=7, device=dev)
    xb = x.to(torch.bfloat16)
    for rng in (False, True):
        t = cs._mma_turns(params, xb, y, mask, 12345, rng)
        print(f"[timing] bf16 rng={rng} us a call in a CUDA graph (rows, mma, "
              f"mma, rows): {[round(v * 1e3, 2) for v in t['graph_turns']]}; "
              f"per wrapper call (rows, mma, mma, rows): "
              f"{[round(v * 1e3, 2) for v in t['call_turns']]}; plain "
              f"{t['plain_ms'] * 1e3:.2f} [{card}]")
    for batch in (128, 96, 3):
        p, xf, yb, mb = cs._k1_inputs(batch, seed=7, device=dev)
        fused_step.mma_phase_stamps(p, xf.to(torch.bfloat16), yb, mb, calls=5)
        _, _, phases, total = fused_step.mma_phase_stamps(
            p, xf.to(torch.bfloat16), yb, mb, calls=50)
        print(f"[timing] mma B={batch} stamps total {total:.2f} us",
              {k: round(v, 3) for k, v in phases.items()})
    out, _ = cs.profile_jobs({
        "mma": (lambda: fused_step.fused_loss_and_grads(
            params, xb, y, mask, _design="mma"), 50,
            ("mma_hidden_kernel", "mma_rows_kernel", "mma_grads_kernel")),
        "rows": (lambda: fused_step.fused_loss_and_grads(
            params, xb, y, mask, _design="rows"), 50,
            ("rows_kernel", "grads_kernel"))})
    print("[timing] profiler us a call:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
