"""MNIST acquisition: mirrored IDX download with checksum verification (a
copy of `pytorch_ddp_mnist_tpu/data/download.py`).

The reference's first-line data capability is `datasets.MNIST(download=True)`
(ddp_tutorial_cpu.py:20,31): torchvision fetches the four gzipped IDX files
from a mirror list and verifies checksums before use. This module does the
same with stdlib urllib against the same public mirrors: an MD5 allowlist
(the canonical published digests torchvision itself pins), atomic writes,
and an IDX magic check on the downloaded payload so a corrupted or
HTML-error body can never be mistaken for data.

Offline behaviour: every mirror failing raises DownloadError; callers fall
back per policy (cli/train.py probes disk -> optional download ->
synthetic, data/mnist.py get_mnist).

    python -m pytorch_ddp_mnist_tpu_torch download [--root data/]
"""

from __future__ import annotations

import gzip
import hashlib
import os
import tempfile
import urllib.error
import urllib.request

# Same mirror order torchvision uses: the S3 mirror first (yann.lecun.com
# has throttled/403'd anonymous clients for years), then the origin.
MIRRORS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "http://yann.lecun.com/exdb/mnist/",
)

# filename -> canonical MD5 of the .gz payload (the digests torchvision pins
# for these exact artifacts; the files have been byte-stable since 1998).
FILES = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}


class DownloadError(RuntimeError):
    """All mirrors failed (or produced bad payloads) for a file."""


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _looks_like_idx_gz(path: str) -> bool:
    """Cheap structural check: gunzips the first 4 bytes and validates the
    IDX magic (00 00 <dtype> <ndims>) — rejects HTML error pages that a
    misbehaving mirror serves with HTTP 200."""
    try:
        with gzip.open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return False
    return (len(head) == 4 and head[0] == 0 and head[1] == 0
            and head[2] in (0x08, 0x09, 0x0B, 0x0C, 0x0D, 0x0E)
            and head[3] > 0)


def download_file(filename: str, dest_dir: str, *,
                  mirrors=None, md5: str | None = None,
                  timeout: float = 30.0, quiet: bool = False) -> str:
    """Fetch one artifact into `dest_dir`, trying each mirror in order.

    The payload lands in a temp file, is checksum- and structure-verified,
    then atomically renamed into place — a crashed or corrupt download can
    never leave a half-written file where the loader probes. Returns the
    final path. An existing file with a matching checksum short-circuits
    (the reference's `download=True` is likewise a no-op on a warm cache).
    """
    mirrors = MIRRORS if mirrors is None else mirrors  # late-bound: tests
    os.makedirs(dest_dir, exist_ok=True)               # repoint the module's
    dest = os.path.join(dest_dir, filename)            # MIRRORS/FILES
    want = md5 if md5 is not None else FILES.get(filename)
    if os.path.exists(dest) and (want is None or _md5(dest) == want):
        return dest
    errors = []
    for mirror in mirrors:
        url = mirror.rstrip("/") + "/" + filename
        fd, tmp = tempfile.mkstemp(dir=dest_dir, suffix=".part")
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    os.fdopen(fd, "wb") as out:
                fd = None
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
            if want is not None and _md5(tmp) != want:
                raise DownloadError(f"{url}: checksum mismatch "
                                    f"(got {_md5(tmp)}, want {want})")
            if not _looks_like_idx_gz(tmp):
                raise DownloadError(f"{url}: payload is not a gzipped IDX file")
            os.replace(tmp, dest)
            if not quiet:
                print(f"[data] downloaded {filename} from {mirror}")
            return dest
        except (urllib.error.URLError, OSError, DownloadError) as e:
            errors.append(f"  {url}: {e}")
        finally:
            if fd is not None:
                os.close(fd)
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise DownloadError(
        f"could not download {filename} from any mirror:\n" + "\n".join(errors))


def download_mnist(root: str, *, mirrors=None, files=None,
                   quiet: bool = False) -> str:
    """Fetch all four MNIST IDX artifacts into `root` (idempotent; verified).

    The capability analog of `datasets.MNIST(root, download=True)`
    (ddp_tutorial_cpu.py:19-33). Files are stored gzipped at `root`'s top
    level, where data/mnist.py's loader probes (`read_idx` gunzips
    transparently). `files` overrides the {filename: md5} manifest (tests
    point it at fixture artifacts). Returns `root`.
    """
    files = FILES if files is None else files
    for filename, md5 in files.items():
        download_file(filename, root, mirrors=mirrors, md5=md5, quiet=quiet)
    return root


def main(argv=None) -> int:
    """`python -m pytorch_ddp_mnist_tpu_torch download [--root data/]`"""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch download",
        description="Download the MNIST IDX files (checksum-verified), the "
                    "datasets.MNIST(download=True) analog")
    p.add_argument("--root", default="data/", help="destination directory")
    a = p.parse_args(argv)
    try:
        download_mnist(a.root)
    except DownloadError as e:
        raise SystemExit(f"download: {e}") from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
