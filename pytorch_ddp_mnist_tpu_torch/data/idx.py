"""IDX (MNIST ubyte) format reader (a copy of `read_idx` from
`pytorch_ddp_mnist_tpu/data/idx.py`).

The reference parses raw IDX files in its converter notebook
(mnist_to_netcdf.ipynb cell-2, `MnistDataloader.read_images_labels`):
big-endian headers via struct.unpack('>II'/'>IIII') and explicit magic checks
(2049 for labels, 2051 for images) — the only asserts in the whole reference
(SURVEY.md §4 item 3). This module reads the full IDX grammar, so the
port reads torchvision-style cached MNIST directly.

IDX layout: 2 zero bytes, 1 dtype code byte, 1 ndims byte, then ndims
big-endian uint32 dimension sizes, then the array data big-endian.
"""

from __future__ import annotations

import gzip

import numpy as np

# dtype code byte -> numpy dtype (big-endian on disk)
_DTYPE_OF_CODE = {
    0x08: "u1", 0x09: "i1", 0x0B: ">i2", 0x0C: ">i4",
    0x0D: ">f4", 0x0E: ">f8",
}


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":  # gzip payload without the extension
        f.close()
        return gzip.open(path, "rb")
    return f


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally gzipped) into a native-endian array.

    Raises ValueError on a bad magic, like the notebook's
    `raise ValueError('Magic number mismatch...')`.
    """
    with _open_maybe_gz(path) as f:
        header = f.read(4)
        if len(header) < 4 or header[0] != 0 or header[1] != 0 \
                or header[2] not in _DTYPE_OF_CODE:
            raise ValueError(f"{path}: bad IDX magic {header[:4]!r}")
        dtype = np.dtype(_DTYPE_OF_CODE[header[2]])
        ndims = header[3]
        if ndims == 0:
            raise ValueError(f"{path}: bad IDX magic (zero dimensions)")
        shape = tuple(
            int.from_bytes(f.read(4), "big") for _ in range(ndims))
        count = int(np.prod(shape, dtype=np.int64))
        raw = f.read(count * dtype.itemsize)
        if len(raw) != count * dtype.itemsize:
            raise ValueError(f"{path}: truncated IDX data")
        arr = np.frombuffer(raw, dtype).reshape(shape)
        return arr.astype(dtype.newbyteorder("="), copy=True)
