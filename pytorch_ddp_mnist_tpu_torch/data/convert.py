"""IDX -> NetCDF converter CLI, the mnist_to_netcdf.ipynb replacement (port
of `pytorch_ddp_mnist_tpu/data/convert.py`; the files it writes are the JAX
converter's byte for byte).

The reference converts raw MNIST IDX files to two CDF-5 NetCDF files with a
notebook (SURVEY.md §2.8/§3.4: parse IDX with magic checks, write
mnist_{train,test}_images.nc via PnetCDF `64BIT_DATA`). This is the same
capability as a CLI, with a `--synthetic N:M` mode that writes the
generated stand-in for machines without the dataset.

Usage:
  python -m pytorch_ddp_mnist_tpu_torch convert --idx_dir data/ --out_dir data/
  python -m pytorch_ddp_mnist_tpu_torch convert --out_dir data/ --synthetic 60000:10000
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .mnist import load_mnist, synthetic_mnist
from .netcdf import write_mnist_netcdf

OUT_NAMES = ("mnist_train_images.nc", "mnist_test_images.nc")


def convert(idx_dir: str, out_dir: str,
            synthetic: Optional[str] = None) -> List[str]:
    """Convert both splits; returns [train_path, test_path].

    `synthetic="N:M"` generates N train / M test samples instead of reading
    IDX files. Raises FileNotFoundError when IDX files are absent and no
    synthetic spec is given.
    """
    os.makedirs(out_dir, exist_ok=True)
    if synthetic:
        n_train, n_test = (int(p) for p in synthetic.split(":"))
        splits = [synthetic_mnist(n_train, seed=0),
                  synthetic_mnist(n_test, seed=1)]
    else:
        splits = []
        for train in (True, False):
            split = load_mnist(idx_dir, train=train)
            if split is None:
                prefix = "train" if train else "t10k"
                raise FileNotFoundError(
                    f"no IDX files for the {prefix!r} split under {idx_dir!r}"
                    " (expected <prefix>-images-idx3-ubyte[.gz] + labels)")
            splits.append(split)
    out = []
    for split, name in zip(splits, OUT_NAMES):
        path = os.path.join(out_dir, name)
        write_mnist_netcdf(path, split.images, split.labels)
        out.append(path)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pytorch_ddp_mnist_tpu_torch "
                                     "convert",
                                description=__doc__.splitlines()[0])
    p.add_argument("--idx_dir", default="data/",
                   help="directory holding the raw IDX files")
    p.add_argument("--out_dir", default="data/",
                   help="where to write mnist_{train,test}_images.nc")
    p.add_argument("--synthetic", default=None, metavar="N:M",
                   help="generate N train / M test synthetic samples instead "
                        "of reading IDX files")
    a = p.parse_args(argv)
    try:
        paths = convert(a.idx_dir, a.out_dir, synthetic=a.synthetic)
    except FileNotFoundError as e:
        raise SystemExit(f"convert: {e}") from None
    for path in paths:
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
