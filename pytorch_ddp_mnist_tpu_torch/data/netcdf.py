"""Dependency-free NetCDF classic reader/writer (CDF-1 / CDF-2 / CDF-5): a
copy of `pytorch_ddp_mnist_tpu/data/netcdf.py`, so the port writes and reads
the same bytes without importing the JAX package.

The reference's parallel-I/O data path stores MNIST in NetCDF written by
PnetCDF in `64BIT_DATA` (CDF-5) format — mnist_to_netcdf.ipynb cell-2:
dims Y=28/X=28/idx=N, vars `images` NC_UBYTE (idx,Y,X) and `labels`
NC_UBYTE (idx,) — and reads it back over MPI-IO, collectively
(mnist_pnetcdf_cpu.py:33,47) or independently per rank
(mnist_pnetcdf_cpu_mp.py:31-46). This module implements the on-disk grammar
itself (the netcdf-c classic format spec plus the PnetCDF CDF-5 widening:
every NON_NEG size field becomes INT64), so each process opens the shared
file and gathers exactly its own sampler's rows — the independent-I/O
analog, with no MPI and no native library. The C++ core (`csrc/reader.cc`,
data/native.py) parses the same grammar for the hot path; this file is the
format source of truth it is tested against.

Grammar implemented (header, big-endian):
  magic('C''D''F' ver) numrecs dim_list gatt_list var_list
  dim_list  = ABSENT | tag(0x0A) NELEMS [name length]...
  gatt_list = ABSENT | tag(0x0C) NELEMS [name nc_type NELEMS values pad4]...
  var_list  = ABSENT | tag(0x0B) NELEMS
              [name ndims dimid... vatt_list nc_type vsize begin]...
  NON_NEG   = u32 (CDF-1/2) | u64 (CDF-5);  begin = u32 (CDF-1) | u64 (2/5)
Record (unlimited) dimensions are not produced by the converter and are not
supported; attributes are parsed and skipped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_UBYTE, NC_USHORT, NC_UINT, NC_INT64, NC_UINT64 = 7, 8, 9, 10, 11

_TAG_DIM, _TAG_VAR, _TAG_ATT = 0x0A, 0x0B, 0x0C

# nc_type -> big-endian on-disk numpy dtype
_NP_OF_NC = {
    NC_BYTE: "i1", NC_CHAR: "S1", NC_SHORT: ">i2", NC_INT: ">i4",
    NC_FLOAT: ">f4", NC_DOUBLE: ">f8", NC_UBYTE: "u1", NC_USHORT: ">u2",
    NC_UINT: ">u4", NC_INT64: ">i8", NC_UINT64: ">u8",
}
_NC_OF_NP = {
    "int8": NC_BYTE, "uint8": NC_UBYTE, "int16": NC_SHORT,
    "uint16": NC_USHORT, "int32": NC_INT, "uint32": NC_UINT,
    "int64": NC_INT64, "uint64": NC_UINT64, "float32": NC_FLOAT,
    "float64": NC_DOUBLE,
}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class Variable:
    """Header entry for one variable (fixed-size; no record vars)."""

    def __init__(self, name: str, dims: Tuple[str, ...],
                 shape: Tuple[int, ...], nc_type: int, begin: int):
        self.name = name
        self.dims = dims
        self.shape = shape
        self.nc_type = nc_type
        self.begin = begin
        self.disk_dtype = np.dtype(_NP_OF_NC[nc_type])
        self.row_bytes = int(np.prod(shape[1:], dtype=np.int64)) \
            * self.disk_dtype.itemsize if shape else self.disk_dtype.itemsize

    def __repr__(self):
        return (f"Variable({self.name!r}, shape={self.shape}, "
                f"nc_type={self.nc_type}, begin={self.begin})")


# ---------------------------------------------------------------- writer ---

class _HeaderWriter:
    def __init__(self, version: int):
        if version not in (1, 2, 5):
            raise ValueError(f"unsupported NetCDF version {version}")
        self.version = version
        self.W = 8 if version == 5 else 4       # NON_NEG width
        self.OFF = 4 if version == 1 else 8     # begin-offset width

    def nonneg(self, x: int) -> bytes:
        return int(x).to_bytes(self.W, "big")

    def u32(self, x: int) -> bytes:
        return int(x).to_bytes(4, "big")

    def offset(self, x: int) -> bytes:
        return int(x).to_bytes(self.OFF, "big")

    def name(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return self.nonneg(len(b)) + b + b"\x00" * (_pad4(len(b)) - len(b))


def write_netcdf(path: str,
                 dims: Dict[str, int],
                 variables: Dict[str, Tuple[Sequence[str], np.ndarray]],
                 version: int = 5) -> None:
    """Write fixed-size dims + variables as one classic-format file.

    `variables` maps name -> (dim-name tuple, array); array shapes must match
    the named dims. version=5 produces the `64BIT_DATA` files the reference
    converter emits (CDF\\x05 magic).
    """
    w = _HeaderWriter(version)
    dim_names = list(dims)
    dim_ids = {n: i for i, n in enumerate(dim_names)}

    entries = []  # (name, dim_ids, nc_type, disk_array, vsize)
    for name, (vdims, arr) in variables.items():
        arr = np.asarray(arr)
        vdims = tuple(vdims)
        want = tuple(int(dims[d]) for d in vdims)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"variable {name!r}: shape {arr.shape} != dims {vdims}={want}")
        nc_type = _NC_OF_NP.get(arr.dtype.name)
        if nc_type is None:
            raise ValueError(f"variable {name!r}: unsupported dtype {arr.dtype}")
        disk = arr.astype(_NP_OF_NC[nc_type])
        vsize = _pad4(disk.nbytes)
        entries.append((name, [dim_ids[d] for d in vdims], nc_type, disk, vsize))

    absent = w.u32(0) + w.nonneg(0)

    def header_bytes(begins: List[int]) -> bytes:
        out = [b"CDF", bytes([version]), w.nonneg(0)]           # magic, numrecs
        out += [w.u32(_TAG_DIM), w.nonneg(len(dim_names))]
        for n in dim_names:
            out += [w.name(n), w.nonneg(dims[n])]
        out.append(absent)                                      # gatt_list
        if entries:
            out += [w.u32(_TAG_VAR), w.nonneg(len(entries))]
            for (name, ids, nc_type, _disk, vsize), begin in zip(entries, begins):
                out += [w.name(name), w.nonneg(len(ids))]
                out += [w.nonneg(i) for i in ids]
                out.append(absent)                              # vatt_list
                out += [w.u32(nc_type), w.nonneg(vsize), w.offset(begin)]
        else:
            out.append(absent)
        return b"".join(out)

    # Header size is begin-independent (fixed-width offsets): measure with
    # placeholder begins, then lay variables out back to back, 4-aligned.
    hsize = len(header_bytes([0] * len(entries)))
    begins, cur = [], _pad4(hsize)
    for *_rest, vsize in entries:
        begins.append(cur)
        cur += vsize

    with open(path, "wb") as f:
        head = header_bytes(begins)
        f.write(head)
        f.write(b"\x00" * (_pad4(hsize) - hsize))
        for (_n, _ids, _t, disk, vsize) in entries:
            raw = disk.tobytes()
            f.write(raw)
            f.write(b"\x00" * (vsize - len(raw)))


def write_mnist_netcdf(path: str, images: np.ndarray,
                       labels: np.ndarray) -> None:
    """Write the reference converter's exact schema (mnist_to_netcdf.ipynb
    cell-2 / SURVEY.md §3.4): CDF-5, dims Y/X/idx, NC_UBYTE images (idx,Y,X)
    then labels (idx,)."""
    images = np.asarray(images, np.uint8)
    labels = np.asarray(labels, np.uint8)
    n, h, wdt = images.shape
    if labels.shape != (n,):
        raise ValueError(f"labels shape {labels.shape} != ({n},)")
    write_netcdf(path, {"Y": h, "X": wdt, "idx": n},
                 {"images": (("idx", "Y", "X"), images),
                  "labels": (("idx",), labels)},
                 version=5)


# ---------------------------------------------------------------- reader ---

class _HeaderCursor:
    """Big-endian cursor that pulls header bytes from the file on demand."""

    def __init__(self, f):
        self.f = f
        self.buf = b""
        self.pos = 0

    def take(self, n: int) -> bytes:
        while len(self.buf) - self.pos < n:
            chunk = self.f.read(1 << 16)
            if not chunk:
                raise ValueError("truncated NetCDF header")
            self.buf += chunk
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "big")

    def be(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")


class NetCDFReader:
    """Parse a classic-format header; read variables whole or by row gather."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic[:3] != b"CDF" or len(magic) < 4 or magic[3] not in (1, 2, 5):
                raise ValueError(f"{path}: bad NetCDF magic {magic!r}")
            self.version = magic[3]
            W = 8 if self.version == 5 else 4
            OFF = 4 if self.version == 1 else 8
            c = _HeaderCursor(f)
            self.numrecs = c.be(W)
            dim_list: List[Tuple[str, int]] = []
            tag, n = c.u32(), c.be(W)
            if tag == _TAG_DIM:
                for _ in range(n):
                    dim_list.append((self._name(c, W), c.be(W)))
            elif tag or n:
                raise ValueError(f"{path}: bad dim_list tag {tag:#x}")
            self._skip_attrs(c, W, path)                    # global atts
            self.dimensions = dict(dim_list)
            self.variables: Dict[str, Variable] = {}
            tag, n = c.u32(), c.be(W)
            if tag == _TAG_VAR:
                for _ in range(n):
                    name = self._name(c, W)
                    ndims = c.be(W)
                    ids = [c.be(W) for _ in range(ndims)]
                    self._skip_attrs(c, W, path)
                    nc_type = c.u32()
                    c.be(W)                                 # vsize (recomputed)
                    begin = c.be(OFF)
                    vdims = tuple(dim_list[i][0] for i in ids)
                    shape = tuple(dim_list[i][1] for i in ids)
                    if nc_type not in _NP_OF_NC:
                        raise ValueError(
                            f"{path}: variable {name!r} has unsupported "
                            f"nc_type {nc_type}")
                    self.variables[name] = Variable(
                        name, vdims, shape, nc_type, begin)
            elif tag or n:
                raise ValueError(f"{path}: bad var_list tag {tag:#x}")

    @staticmethod
    def _name(c: _HeaderCursor, W: int) -> str:
        n = c.be(W)
        s = c.take(_pad4(n))[:n]
        return s.decode("utf-8")

    @staticmethod
    def _skip_attrs(c: _HeaderCursor, W: int, path: str) -> None:
        tag, n = c.u32(), c.be(W)
        if tag == 0 and n == 0:
            return
        if tag != _TAG_ATT:
            raise ValueError(f"{path}: bad attribute list tag {tag:#x}")
        for _ in range(n):
            NetCDFReader._name(c, W)
            nc_type = c.u32()
            nelems = c.be(W)
            item = np.dtype(_NP_OF_NC.get(nc_type, "u1")).itemsize
            c.take(_pad4(nelems * item))

    def read(self, name: str,
             indices: Optional[Sequence[int]] = None) -> np.ndarray:
        """Read a variable, whole or as a leading-dim row gather (the access
        pattern of mnist_pnetcdf_cpu_mp.py:43-46: each rank fetches only its
        own sampler's indices). Returns a native-endian array."""
        v = self.variables[name]
        disk = v.disk_dtype
        native = disk.newbyteorder("=")
        if indices is None:
            count = int(np.prod(v.shape, dtype=np.int64))
            with open(self.path, "rb") as f:
                f.seek(v.begin)
                raw = f.read(count * disk.itemsize)
            if len(raw) != count * disk.itemsize:
                raise ValueError(f"{self.path}: truncated variable {name!r}")
            return np.frombuffer(raw, disk).reshape(v.shape).astype(
                native, copy=True)
        idx = np.asarray(indices, np.int64)
        if not v.shape:
            raise IndexError(f"variable {name!r} is a scalar")
        if idx.size and (idx.min() < 0 or idx.max() >= v.shape[0]):
            raise IndexError(
                f"indices out of range [0, {v.shape[0]}) for {name!r}")
        out = np.empty((idx.size,) + v.shape[1:], disk)
        flat = out.reshape(idx.size, -1).view(np.uint8) if idx.size else out
        with open(self.path, "rb") as f:
            for k, i in enumerate(idx):
                f.seek(v.begin + int(i) * v.row_bytes)
                raw = f.read(v.row_bytes)
                if len(raw) != v.row_bytes:
                    raise ValueError(
                        f"{self.path}: truncated row {int(i)} of {name!r}")
                flat[k] = np.frombuffer(raw, np.uint8)
        return out.astype(native, copy=True)


def read_mnist_netcdf(path: str,
                      indices: Optional[Sequence[int]] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(images, labels) from one converter-schema file, whole or row-gathered."""
    r = NetCDFReader(path)
    return r.read("images", indices), r.read("labels", indices)
