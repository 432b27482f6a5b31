"""The port stands alone: no module of pytorch_ddp_mnist_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package. Only tests import both.

Module names are compared exactly, or by the prefix `pytorch_ddp_mnist_tpu.`
with its dot: `pytorch_ddp_mnist_tpu_torch` itself starts with
`pytorch_ddp_mnist_tpu`."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pytorch_ddp_mnist_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_ddp_mnist_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("pytorch_ddp_mnist_tpu")
    assert _forbidden("pytorch_ddp_mnist_tpu.data.mnist")
    assert not _forbidden("pytorch_ddp_mnist_tpu_torch")
    assert not _forbidden("pytorch_ddp_mnist_tpu_torch.ops.fused_step")
    assert not _forbidden("jaxtyping")


def test_no_port_source_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []


def test_importing_the_port_and_chip_smoke_loads_no_jax(tmp_path):
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import pytorch_ddp_mnist_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r}))
print(len(names), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 18 and bad == "[]", out.stdout


# the data plane and the reference's streams: each module on its own, in a
# fresh interpreter, loads neither jax nor the JAX package, and the native
# core is built from the port's own copy of its source
DATA_PLANE_MODULES = (
    "pytorch_ddp_mnist_tpu_torch.data.netcdf",
    "pytorch_ddp_mnist_tpu_torch.data.native",
    "pytorch_ddp_mnist_tpu_torch.data.loader",
    "pytorch_ddp_mnist_tpu_torch.data.convert",
    "pytorch_ddp_mnist_tpu_torch.data.download",
    "pytorch_ddp_mnist_tpu_torch.parallel.torch_rng",
    "pytorch_ddp_mnist_tpu_torch.parallel.sampler",
    "pytorch_ddp_mnist_tpu_torch.bench",
)


def test_the_data_plane_and_stream_modules_stand_alone(tmp_path):
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
for name in {DATA_PLANE_MODULES!r}:
    importlib.import_module(name)
from pytorch_ddp_mnist_tpu_torch.ops import _build
print(_build.CSRC / _build.HOST_SOURCES["reader"])
print(sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    source, bad = out.stdout.strip().splitlines()
    assert bad == "[]"
    assert Path(source) == PORT / "csrc" / "reader.cc"
    assert (PORT / "csrc" / "reader.cc").exists()
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for name in DATA_PLANE_MODULES:
        assert name.replace(".", "/") + ".py" in names


# the input pipeline, the comm strategies and the zoo: each module on its
# own, in a fresh interpreter, loads neither jax nor the JAX package; the
# decode workers' modules import no torch at all (a worker makes numpy
# arrays only and never touches the card)
PIPELINE_COMM_MODULES = (
    "pytorch_ddp_mnist_tpu_torch.pipeline",
    "pytorch_ddp_mnist_tpu_torch.pipeline.reader",
    "pytorch_ddp_mnist_tpu_torch.pipeline.synthetic",
    "pytorch_ddp_mnist_tpu_torch.pipeline.workers",
    "pytorch_ddp_mnist_tpu_torch.pipeline.prefetch",
    "pytorch_ddp_mnist_tpu_torch.parallel.collectives",
    "pytorch_ddp_mnist_tpu_torch.models.zoo",
)
NUMPY_ONLY = ("reader", "synthetic", "workers")


def test_the_pipeline_comm_and_zoo_modules_stand_alone(tmp_path):
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
for name in {PIPELINE_COMM_MODULES!r}:
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for name in NUMPY_ONLY:
        path = PORT / "pipeline" / f"{name}.py"
        tree = ast.parse(path.read_text(), str(path))
        imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names]
        imported += [n.module or "" for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not any(m == "torch" or m.startswith("torch.")
                       for m in imported), (name, imported)


# the replica fleet and hot reload: each module on its own, in a fresh
# interpreter, loads neither jax nor the JAX package (the record contract
# is the port's own copy, not a file-load of the JAX package's analysis.py)
FLEET_MODULES = (
    "pytorch_ddp_mnist_tpu_torch.serve.fleet",
    "pytorch_ddp_mnist_tpu_torch.serve.reload",
    "pytorch_ddp_mnist_tpu_torch.serve_chaos",
    "pytorch_ddp_mnist_tpu_torch.telemetry.analysis",
)


def test_the_fleet_and_reload_modules_stand_alone(tmp_path):
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
for name in {FLEET_MODULES!r}:
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for name in FLEET_MODULES:
        assert name.replace(".", "/") + ".py" in names
    for name in ("serve_chaos.py", "telemetry/analysis.py"):
        text = (PORT / name).read_text()
        assert "spec_from_file_location" not in text, name


# the trainer's in-run telemetry: each module on its own, in a fresh
# interpreter, loads neither jax nor the JAX package, and the copies of
# the JAX package's stdlib/numpy telemetry modules import torch only
# inside their functions (the JAX modules' import-time contract)
TELEMETRY_MODULES = (
    "pytorch_ddp_mnist_tpu_torch.telemetry.runtime",
    "pytorch_ddp_mnist_tpu_torch.telemetry.health",
    "pytorch_ddp_mnist_tpu_torch.telemetry.prom",
    "pytorch_ddp_mnist_tpu_torch.telemetry.dispatch",
    "pytorch_ddp_mnist_tpu_torch.telemetry.cluster",
    "pytorch_ddp_mnist_tpu_torch.utils.profiling",
)


def test_the_telemetry_modules_stand_alone(tmp_path):
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
for name in {TELEMETRY_MODULES!r}:
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for name in TELEMETRY_MODULES:
        rel = name.replace(".", "/") + ".py"
        assert rel in names
        tree = ast.parse((REPO / rel).read_text(), rel)
        top = [a.name for n in tree.body if isinstance(n, ast.Import)
               for a in n.names]
        top += [n.module or "" for n in tree.body
                if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not any(m == "torch" or m.startswith("torch.")
                       for m in top), (name, top)
        assert "spec_from_file_location" not in (REPO / rel).read_text()


# the telemetry read side: each module on its own, in a fresh interpreter,
# loads neither jax, the JAX package nor torch (the JAX read side's
# stdlib-at-import contract: reports and gates run wherever the files land;
# `trace cost` imports torch inside its harvest)
READ_SIDE_MODULES = (
    "pytorch_ddp_mnist_tpu_torch.telemetry.analysis",
    "pytorch_ddp_mnist_tpu_torch.telemetry.export",
    "pytorch_ddp_mnist_tpu_torch.telemetry.ledger",
    "pytorch_ddp_mnist_tpu_torch.telemetry.costs",
    "pytorch_ddp_mnist_tpu_torch.cli.trace",
    "pytorch_ddp_mnist_tpu_torch.cli.ledger",
)


def test_the_read_side_modules_stand_alone_without_torch(tmp_path):
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
for name in {READ_SIDE_MODULES!r}:
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".")
                    for f in {FORBIDDEN + ("torch",)!r})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for name in READ_SIDE_MODULES:
        rel = name.replace(".", "/") + ".py"
        assert rel in names
        assert "spec_from_file_location" not in (REPO / rel).read_text()
