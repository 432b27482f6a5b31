"""MNIST dataset: IDX loading, normalisation, synthetic fallback.

A copy of `pytorch_ddp_mnist_tpu/data/mnist.py`: the same
bytes from the same IDX files, the reference transform
`ToTensor() -> Normalize((0.1307,), (0.3081,))` reproduced op for op in
float32 (/255, then -mean, then /std) on numpy arrays and, as
`device_normalize` (the JAX package's `train/scan.py` one), on tensors of
any device, and the same deterministic synthetic 60k/10k stand-in for
machines without the dataset. `get_mnist(download=True)` keeps the JAX
package's probe order: files on disk, then a checksum-verified download
(data/download.py), then the synthetic stand-in.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .idx import read_idx

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081


@dataclass
class Split:
    """One dataset split: uint8 images (n, H, W) + uint8 labels (n,)."""
    images: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.images)


def normalize_images(images: np.ndarray) -> np.ndarray:
    """uint8 (n, H, W) -> float32 (n, H*W), the reference transform +
    flatten, computed in place on one float32 buffer in the reference's op
    order (bit-identical to `((x/255) - mean)/std`)."""
    x = np.asarray(images, np.float32)
    if np.shares_memory(x, images):  # never mutate the caller's buffer
        x = x.copy()
    x /= 255.0
    x -= MNIST_MEAN
    x /= MNIST_STD
    return x.reshape(x.shape[0], -1)


def device_normalize(x: torch.Tensor) -> torch.Tensor:
    """normalize_images' op chain on a tensor, on its own device: uint8 (or
    float) (n, 784) -> float32, /255, then -mean, then /std, each rounded to
    f32 with true division (bitwise normalize_images). The constants are
    tensors on x's device because CUDA turns a division by a host scalar
    into a multiply by its reciprocal, which rounds differently."""
    def const(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=x.device)

    x = x.to(torch.float32) / const(255.0)
    return (x - const(MNIST_MEAN)) / const(MNIST_STD)


def _find_idx(root: str, stem: str) -> str | None:
    for d in (root, os.path.join(root, "MNIST", "raw")):
        for name in (stem, stem + ".gz"):
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    return None


def load_mnist(root: str, train: bool = True) -> Split | None:
    """Load one split from IDX files under `root` (torchvision layouts
    included). Returns None when the files are absent."""
    prefix = "train" if train else "t10k"
    ipath = _find_idx(root, f"{prefix}-images-idx3-ubyte")
    lpath = _find_idx(root, f"{prefix}-labels-idx1-ubyte")
    if ipath is None or lpath is None:
        return None
    images = read_idx(ipath)
    labels = read_idx(lpath)
    if len(images) != len(labels):
        raise ValueError(
            f"{root}: {len(images)} images but {len(labels)} labels")
    return Split(images, labels)


def synthetic_mnist(n: int, seed: int = 0) -> Split:
    """Deterministic learnable MNIST stand-in: 10 FIXED 7x7 class templates
    (independent of `seed`, so train and test splits share classes) plus
    per-sample label draws and pixel noise driven by `seed`."""
    tmpl_rng = np.random.default_rng(0xC0FFEE)
    coarse = tmpl_rng.integers(30, 226, (10, 7, 7)).astype(np.float32)
    templates = np.kron(coarse, np.ones((4, 4), np.float32))  # (10, 28, 28)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    noise = rng.normal(0.0, 20.0, (n, 28, 28)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return Split(images, labels)


def get_mnist(root: str, train: bool = True, *, synthetic_n: int | None = None,
              quiet: bool = False, download: bool = False) -> Split:
    """Load a split from disk; with `download`, fetch the IDX files from the
    mirrors first when they are absent (data/download.py); fall back to the
    synthetic stand-in of the canonical split size (60k/10k; `synthetic_n`
    overrides). The probe order of `datasets.MNIST(download=True)`
    (ddp_tutorial_cpu.py:22) and of the JAX package's get_mnist."""
    split = load_mnist(root, train)
    if split is not None:
        return split
    if download:
        from .download import DownloadError, download_mnist
        try:
            download_mnist(root, quiet=quiet)
            split = load_mnist(root, train)
            if split is not None:
                return split
        except DownloadError as e:
            if not quiet:
                print(f"[data] MNIST download failed ({e}); "
                      f"falling back to synthetic data")
    n = synthetic_n if synthetic_n is not None else (60000 if train else 10000)
    if not quiet:
        hint = "" if download else " (pass --download to fetch real MNIST)"
        print(f"[data] no MNIST IDX files under {root!r}; using synthetic "
              f"{'train' if train else 'test'} split of {n} samples{hint}")
    return synthetic_mnist(n, seed=0 if train else 1)
