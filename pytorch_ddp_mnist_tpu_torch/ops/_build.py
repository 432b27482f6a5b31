"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` is compiled on its own, at first use, into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. `VARIANTS` are further builds of a source
with extra `-D` flags (a debug build with phase stamps); they are built
only when named. Libraries go under
`build/kernels/` at the root of the checkout (`.gitignore` lists `build/`),
beside a `.log` holding what `-Xptxas -v` reported.

`HOST_SOURCES` are host libraries, built the same way by the C++ compiler
(`$CXX`, else g++) into `build/native/`: the NetCDF/IDX reader core
(`csrc/reader.cc`, data/native.py). Nothing is built when this module is
imported: machines without nvcc or g++ import it freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NATIVE_DIR = PKG_DIR.parent / "build" / "native"

# kernel library name -> source file under csrc/
SOURCES = {"fused_step": "fused_step.cu", "fused_split": "fused_split.cu",
           "fused_mma": "fused_mma.cu", "epoch_step": "epoch_step.cu",
           "epoch_ws": "epoch_ws.cu", "epoch_mma": "epoch_mma.cu",
           "ring_ws": "ring_ws.cu", "ring_mma": "ring_mma.cu"}
# variant library name -> (library of SOURCES, its extra nvcc flags)
VARIANTS = {"epoch_ws_stamps": ("epoch_ws", ("-DWS_STAMPS",)),
            "fused_split_stamps": ("fused_split", ("-DSPLIT_STAMPS",)),
            "fused_mma_stamps": ("fused_mma", ("-DMMA_STAMPS",)),
            "epoch_mma_stamps": ("epoch_mma", ("-DEMMA_STAMPS",)),
            "ring_ws_stamps": ("ring_ws", ("-DK6_STAMPS",)),
            "ring_mma_stamps": ("ring_mma", ("-DK6M_STAMPS",))}

# host library name -> C++ source file under csrc/
HOST_SOURCES = {"reader": "reader.cc"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; carries the compiler's output."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
            "and $PATH); the port's CUDA kernels are built with it at first use")
    return nvcc


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise KernelBuildError(
            f"C++ compiler {cxx!r} not found ($CXX, else g++); the native "
            f"reader core is built with it at first use")
    return path


def _spec(name: str) -> tuple:
    """(source file under csrc/, compiler flags) of library `name`."""
    if name in SOURCES:
        return SOURCES[name], NVCC_FLAGS
    if name in HOST_SOURCES:
        return HOST_SOURCES[name], CXX_FLAGS
    base, extra = VARIANTS[name]
    return SOURCES[base], NVCC_FLAGS + tuple(extra)


def _target(name: str) -> Path:
    source, flags = _spec(name)
    src = (CSRC / source).read_bytes()
    if name in HOST_SOURCES:   # a host library includes no csrc/ header
        digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
        return NATIVE_DIR / f"{name}-{digest[:16]}.so"
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=None) -> dict:
    """Build every library in `names` (of SOURCES, VARIANTS or
    HOST_SOURCES; default: all of SOURCES) that is not built yet, one
    compiler process per source (nvcc, or the C++ compiler for
    HOST_SOURCES), all started together. Returns {name: (library path,
    compiler report)}; raises KernelBuildError naming each source that
    failed, with the compiler's output."""
    names = list(SOURCES if names is None else names)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        source, flags = _spec(name)
        compiler = find_cxx() if name in HOST_SOURCES else find_nvcc()
        cmd = [compiler, *flags, "-o", str(tmp), str(CSRC / source)]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} ({_spec(name)[0]}, "
                          f"{os.path.basename(proc.args[0])} exit "
                          f"{proc.returncode})"
                          f"\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise KernelBuildError("build failed:\n" + "\n".join(failed))
    out = {}
    for name in names:
        so = _target(name)
        log = so.with_suffix(".log")
        out[name] = (so, log.read_text() if log.exists() else "")
    return out


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed. The caller declares the
    functions' ctypes signatures and keeps the handle."""
    so, _ = build_all([name])[name]
    return ctypes.CDLL(str(so))
