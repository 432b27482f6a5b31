"""ctypes binding of the native reader core (`csrc/reader.cc`; port of
`pytorch_ddp_mnist_tpu/data/native/__init__.py`).

The core is built at first use by ops/_build.py (`HOST_SOURCES["reader"]`:
g++, or `$CXX`) into `build/native/reader-<hash>.so` at the root of the
checkout, written under a temporary name and renamed into place, so ranks
that build at once each see a whole library. Where no C++ toolchain exists
the core is off: `native_available()` says so and `native_build_error()`
says why, and the loader reads through the pure-Python parser of
data/netcdf.py (the format's source of truth, which the tests hold the core
against byte for byte) and names the core it used.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops import _build

# nc_type -> native numpy dtype (the C core already swapped to host order)
_NP_OF_NC = {1: "i1", 2: "S1", 3: "i2", 4: "i4", 5: "f4", 6: "f8",
             7: "u1", 8: "u2", 9: "u4", 10: "i8", 11: "u8"}


class _Core:
    """The loaded library, or why it could not be loaded; loaded once a
    process, under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self.lib = None
        self.error: Optional[str] = None

    def load(self):
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    self.lib = _declare(ctypes.CDLL(str(_build.build_all(
                        ["reader"])["reader"][0])))
                except (_build.KernelBuildError, OSError) as e:
                    self.error = str(e)
        return self.lib


def _declare(lib):
    lib.nr_open.restype = ctypes.c_void_p
    lib.nr_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.nr_close.restype = None
    lib.nr_close.argtypes = [ctypes.c_void_p]
    lib.nr_nvars.restype = ctypes.c_int
    lib.nr_nvars.argtypes = [ctypes.c_void_p]
    lib.nr_var_info.restype = ctypes.c_int
    lib.nr_var_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.nr_read_rows.restype = ctypes.c_int
    lib.nr_read_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    return lib


_CORE = _Core()


def native_available() -> bool:
    """Whether the native core is built and loaded (building it if not)."""
    return _CORE.load() is not None


def native_build_error() -> Optional[str]:
    """Why the native core is off, or None when it is on."""
    _CORE.load()
    return _CORE.error


class NativeReader:
    """One open file (IDX or NetCDF). Context manager; thread-safe reads
    (the core uses pread on a shared fd).

    `variables` maps name -> (shape tuple, nc_type). `read(name, idx)`
    gathers leading-dim rows host-endian; `read(name)` reads the whole
    variable (a single coalesced pread).
    """

    def __init__(self, path: str):
        self._h = None
        lib = _CORE.load()
        if lib is None:
            raise RuntimeError(f"native reader unavailable: {_CORE.error}")
        self._lib = lib
        err = ctypes.create_string_buffer(1024)
        self._h = lib.nr_open(os.fsencode(path), err, len(err))
        if not self._h:
            raise ValueError(err.value.decode(errors="replace"))
        self.path = path
        self.variables: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        self._index: Dict[str, int] = {}
        shape = (ctypes.c_longlong * 16)()
        ndims = ctypes.c_int()
        nc_type = ctypes.c_int()
        name = ctypes.create_string_buffer(256)
        for i in range(lib.nr_nvars(self._h)):
            if lib.nr_var_info(self._h, i, name, len(name), shape, 16,
                               ctypes.byref(ndims), ctypes.byref(nc_type)):
                self.close()
                raise RuntimeError(f"{path}: nr_var_info({i}) failed")
            nm = name.value.decode()
            self.variables[nm] = (
                tuple(int(shape[d]) for d in range(ndims.value)),
                int(nc_type.value))
            self._index[nm] = i

    def close(self) -> None:
        if self._h:
            self._lib.nr_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()

    def read(self, name: str,
             indices: Optional[Sequence[int]] = None) -> np.ndarray:
        if self._h is None:
            raise ValueError(f"{self.path}: reader is closed")
        shape, nc_type = self.variables[name]  # KeyError on unknown name
        if indices is None:
            idx = np.arange(shape[0] if shape else 1, dtype=np.int64)
            out_shape = shape
        else:
            idx = np.ascontiguousarray(indices, np.int64)
            if not shape:
                raise IndexError(f"variable {name!r} is a scalar")
            if idx.size and (idx.min() < 0 or idx.max() >= shape[0]):
                raise IndexError(
                    f"indices out of range [0, {shape[0]}) for {name!r}")
            out_shape = (idx.size,) + shape[1:]
        out = np.empty(out_shape, dtype=_NP_OF_NC[nc_type])
        if out.size == 0:
            return out
        err = ctypes.create_string_buffer(1024)
        rc = self._lib.nr_read_rows(
            self._h, self._index[name],
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx), out.ctypes.data_as(ctypes.c_void_p), err, len(err))
        if rc != 0:
            raise IOError(
                f"{self.path}: {err.value.decode(errors='replace')}")
        return out
