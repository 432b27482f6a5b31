#!/usr/bin/env python3
"""Build scripts/staging_microbench.cu and time, each per launch in a CUDA
graph of 50: an empty kernel; staging 128 x 512 bytes into each of 1, 32
or 116 blocks by TMA (1 or 4 bulk copies, with and without 8 x 32 tensor
copies) and by cp.async, every block reading the same bytes or its own;
and the same staging right after another kernel wrote the bytes.

    python3 scripts/staging_microbench.py     # from the repo root, one card
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
        print("staging_microbench: needs a CUDA card", file=sys.stderr)
        return 2
    so = os.path.join(str(_build.BUILD_DIR), "staging_microbench.so")
    os.makedirs(str(_build.BUILD_DIR), exist_ok=True)
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(ROOT, "scripts", "staging_microbench.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout, r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mb_setup.argtypes = [P, I]
    lib.mb_run.argtypes = [I, I, P, P, I, I, I, I, I, P, P]
    dev = torch.device("cuda", 0)
    x = torch.randn(128, 784, device=dev)
    rest = torch.randn(116 * 128 * 128, device=dev)
    fresh = torch.zeros(128 * 128, device=dev)
    out = torch.zeros(1024, device=dev)
    if lib.mb_setup(x.data_ptr(), 128) != 0:
        print("staging_microbench: no tensor map", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

    def us(what, write=0, src=rest, spread=0, groups=1, box=0, blocks=116):
        def launch():
            lib.mb_run(what, write, fresh.data_ptr(), src.data_ptr(), spread,
                       128, groups, box, blocks, out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
        for _ in range(5):
            launch()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(50):
                launch()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 50 * 1e3

    print(f"{card}: us a launch in a CUDA graph of 50")
    print(f"empty kernel {us(0):.2f}")
    for blocks in (1, 32, 116):
        for spread in (0, 1):
            print(f"{blocks:3d} blocks x 64 KB, {'own' if spread else 'same'}"
                  f" bytes: TMA 1 copy {us(1, spread=spread, blocks=blocks):.2f}"
                  f", 4 copies {us(1, spread=spread, groups=4, blocks=blocks):.2f}"
                  f", 4 copies + boxes "
                  f"{us(1, spread=spread, groups=4, box=1, blocks=blocks):.2f}"
                  f"; cp.async {us(2, spread=spread, blocks=blocks):.2f}")
    writer = us(0, write=1)
    print(f"writer + empty {writer:.2f}; writer + 116 blocks staging what it "
          f"wrote {us(1, write=1, src=fresh, groups=4, box=1):.2f}, staging "
          f"bytes at rest {us(1, write=1, groups=4, box=1):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
