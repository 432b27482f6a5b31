#!/usr/bin/env python3
"""Build scripts/mma_latency.cu and measure the latency of one dependent
`mma.sync` m16n8k16 (bf16 in, f32 accumulate) on this card: the cycles of
a chain of 1,024 and of 64 MMAs on one warp, their difference over 960 (the
fixed cost cancels), and that latency in ns at the card's maximum SM clock
(nvidia-smi). PERF.md takes K1-mma's chain floor from it.

    python3 scripts/mma_latency.py     # from the repo root, one card
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pytorch_ddp_mnist_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_latency: needs a CUDA card", file=sys.stderr)
        return 2
    so = os.path.join(str(_build.BUILD_DIR), "mma_latency.so")
    os.makedirs(str(_build.BUILD_DIR), exist_ok=True)
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(ROOT, "scripts", "mma_latency.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout, r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    P = ctypes.c_void_p
    lib.mma_chain_cycles.argtypes = [ctypes.c_int, P, P, P, P]
    dev = torch.device("cuda", 0)
    words = torch.randint(0, 1 << 14, (192,), dtype=torch.int32, device=dev)
    words = words | (words << 16)   # small bf16 pairs: no overflow
    out = torch.zeros(32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)

    def chain(n):
        best = None
        for _ in range(20):
            err = lib.mma_chain_cycles(n, words.data_ptr(), out.data_ptr(),
                                       cycles.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_chain launch failed: CUDA error {err}")
            torch.cuda.synchronize()
            best = int(cycles) if best is None else min(best, int(cycles))
        return best

    long, short = chain(1024), chain(64)
    per = (long - short) / 960
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip()
    mhz = float(smi.split(",")[-1])
    print(f"mma.sync m16n8k16 bf16->f32 dependent chain: {long} cycles for "
          f"1024, {short} for 64: {per:.2f} cycles an MMA, {per / mhz * 1e3:.2f}"
          f" ns at {mhz:.0f} MHz; 8 of them {8 * per / mhz:.3f} us, 49 of "
          f"them {49 * per / mhz:.3f} us [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
