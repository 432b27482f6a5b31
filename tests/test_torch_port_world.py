"""The port's process-level world (parallel/wireup.py, the WorldMesh of
parallel/mesh.py, `world_mean` and the world steps of parallel/ddp.py, the
CLI's `--parallel` under a launcher) on the CPU, over gloo.

  * The env-derivation chains, method detection and reference spellings
    against the JAX package's `parallel/wireup.py`, on the environments of
    tests/test_wireup.py (the `tpu` method is a refusal here): equal.
  * A 4-rank world on tests/mp_worker.py's HPARAMS (this file run as a
    script is the rank): the ranks bitwise in lockstep; `reduce_max` gives
    3 on every rank and `barrier` returns; for the `xla` and the `pallas`
    step, bitwise the port's single-process 4-replica CPU mesh fed the
    world's rows in rank order; within rtol 1e-5 / atol 1e-6 (checksum
    rtol 1e-5) of the JAX golden, test_multiprocess.py's
    `_golden_worker_run` on a 4-device JAX mesh.
  * The CLI on 4 ranks: one `Epoch=0` line, from rank 0, and a rank-0
    checkpoint; `--cached` over 2 epochs with the loss falling; a 1-rank
    env world bitwise the serial `--parallel` run.
  * A world's `--cached` rows: on 2 ranks (`xla`, `pallas`, `--fused`) the
    epoch lines and the checkpoint bitwise the single-process 2-replica
    mesh fed the global batches; each rank's rows those of the JAX cached
    path's global sampler, sliced as P(None, DATA_AXIS) slices them.
  * The refusals by name.

Every spawning test runs its world under a time limit of its own and kills
the whole world on its first failure. The ranks and the CPU mesh they are
held against run torch single-threaded: a CPU product's bits may depend on
its thread count. No rank imports jax: only the tests here do.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu_torch.data.mnist import normalize_images, synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
from pytorch_ddp_mnist_tpu_torch.ops import fused_step, threefry
from pytorch_ddp_mnist_tpu_torch.parallel import ddp, wireup
from pytorch_ddp_mnist_tpu_torch.parallel.mesh import (WorldMesh, first_replica,
                                                       replicas, world_size)
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WORLD = 4
WORLD_LIMIT_S = 90     # each spawned world's own time limit
LAUNCHER_VARS = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
                 "SLURM_NODELIST", "SLURM_STEP_NODELIST", "SLURM_JOBID",
                 "SLURM_NTASKS_PER_NODE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
                 "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
                 "MPI_LOCALRANKID", "MPI_LOCALNRANKS", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "TPU_WORKER_HOSTNAMES")
KERNELS = {"xla": ddp.make_dp_train_step,
           "pallas": fused_step.make_pallas_dp_train_step}


def _hparams():
    sys.path.insert(0, TESTS)
    from mp_worker import HPARAMS
    return HPARAMS


def _data(hp):
    split = synthetic_mnist(hp["n"], seed=hp["data_seed"])
    return normalize_images(split.images), split.labels.astype(np.int32)


def _shards(hp, world):
    out = []
    for r in range(world):
        s = ShardedSampler(hp["n"], num_replicas=world, rank=r,
                           seed=hp["sampler_seed"])
        s.set_epoch(0)
        out.append(s.indices())
    return out


def _train(step, hp, x_all, y_all, rows_of_step):
    """hp["steps"] steps of `step` from the seeds; rows_of_step(s) gives
    the rows of step s. Returns (losses (steps,), the final params)."""
    model = MLP.from_seed(hp["param_seed"])
    key = threefry.key_data(hp["key_seed"])
    losses = []
    for s in range(hp["steps"]):
        rows = rows_of_step(s)
        key, loss = step(model, key, torch.from_numpy(x_all[rows]),
                         torch.from_numpy(y_all[rows]))
        losses.append(loss)
    return torch.stack(losses), model.params()


# ---- the rank: this file run as a script ----

def _rank_main(out: str) -> int:
    torch.set_num_threads(1)
    hp = _hparams()
    rt = wireup.initialize_runtime("env", device_type="cpu")
    mesh = WorldMesh([rt.device], world_size=rt.size, rank=rt.rank)
    x_all, y_all = _data(hp)
    shard = _shards(hp, rt.size)[rt.rank]
    lb = hp["local_batch"]
    for kernel, make in KERNELS.items():
        losses, params = _train(make(mesh, hp["lr"]), hp, x_all, y_all,
                                lambda s: shard[s * lb:(s + 1) * lb])
        torch.save({"losses": losses, "params": params},
                   os.path.join(out, f"rank{rt.rank}_{kernel}.pt"))
    rmax = rt.reduce_max(float(rt.rank))
    rt.barrier()
    # one rank holding other params is named on every rank
    if rt.rank == rt.size - 1:
        with torch.no_grad():
            params["fc3"]["w"][0, 0] += 1.0
    try:
        ddp.check_replicated(mesh, params)
        refusal = ""
    except RuntimeError as e:
        refusal = str(e)
    print(json.dumps({"rank": rt.rank, "size": rt.size, "reduce_max": rmax,
                      "backend": rt.backend, "refusal": refusal}), flush=True)
    rt.finalize()
    return 0


# ---- spawning a world ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world_once(argv, world, cwd, kill_on_failure):
    port = _free_port()
    procs, files = [], []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
        env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        out = tempfile.TemporaryFile("w+")
        err = tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                      stdout=out, stderr=err))
    deadline = time.monotonic() + WORLD_LIMIT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if time.monotonic() > deadline or (failed and kill_on_failure):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        res.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return res


def _run_world(argv, world=WORLD, cwd=REPO, *, expect_ok=True):
    """Run `world` ranks of `argv` under the env wireup; retry only on a
    port race. With expect_ok every rank must exit 0."""
    for _ in range(3):
        outs = _run_world_once(argv, world, cwd, kill_on_failure=expect_ok)
        blob = "\n".join(e for _, _, e in outs)
        if all(rc == 0 for rc, _, _ in outs) or not (
                "Address already in use" in blob or "EADDRINUSE" in blob
                or "errno: 98" in blob):
            break
    if expect_ok:
        for r, (rc, out, err) in enumerate(outs):
            assert rc == 0, f"rank {r} failed (rc={rc}):\n{out}\n{err}"
    return outs


def _cli_argv(*extra):
    return [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
            "--parallel", "--device", "cpu", "--wireup_method", "env",
            "--limit", "1024", "--batch_size", "64", *extra]


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ---- wireup against the JAX package ----

DERIVE_CASES = [
    ("slurm", {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
               "SLURM_NODELIST": "nid[0040-0043]", "SLURM_JOBID": "12345"}),
    ("slurm", {"SLURM_PROCID": "0", "SLURM_NTASKS": "2",
               "SLURM_STEP_NODELIST": "gpu[3,5-9]", "SLURM_NODELIST": "x1"}),
    ("nccl-slurm", {"SLURM_PROCID": "1", "SLURM_NTASKS": "4",
                    "SLURM_NODELIST": "n[01-04]"}),
    ("openmpi", {"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "4",
                 "OMPI_COMM_WORLD_LOCAL_RANK": "2", "MASTER_ADDR": "10.0.0.1",
                 "MASTER_PORT": "23456"}),
    ("nccl-openmpi", {"OMPI_COMM_WORLD_RANK": "1",
                      "OMPI_COMM_WORLD_SIZE": "2"}),
    ("mpich", {"PMI_RANK": "1", "PMI_SIZE": "4"}),
    ("nccl-mpich", {"PMI_RANK": "3", "PMI_SIZE": "4", "MPI_LOCALRANKID": "3"}),
    ("env", {"RANK": "0", "WORLD_SIZE": "2"}),
    ("gloo", {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
              "MASTER_ADDR": "h0", "MASTER_PORT": "1234"}),
    ("env", {}),
    ("slurm", {}),
    ("openmpi", {}),
    ("mpich", {}),
    ("mpich", {"PMI_RANK": "0"}),
    ("nccl", {}),
    ("single", {}),
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (RuntimeError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("method,env", DERIVE_CASES,
                         ids=[f"{m}-{i}" for i, (m, _) in
                              enumerate(DERIVE_CASES)])
def test_derive_and_detect_method_are_the_jax_packages(no_launcher, method,
                                                       env):
    from pytorch_ddp_mnist_tpu.parallel import wireup as jax_wireup
    for k, v in env.items():
        no_launcher.setenv(k, v)
    assert _outcome(lambda: wireup._derive(method)) == _outcome(
        lambda: jax_wireup._derive(method))
    assert wireup.detect_method() == jax_wireup.detect_method()


@pytest.mark.parametrize("name", ["nccl-slurm", "nccl-openmpi", "nccl-mpich",
                                  "gloo", "slurm", "openmpi", "mpich", "env",
                                  "auto", "single"])
def test_resolve_method_is_the_jax_packages(name):
    from pytorch_ddp_mnist_tpu.parallel import wireup as jax_wireup
    assert wireup.resolve_method(name) == jax_wireup.resolve_method(name)
    assert wireup.METHOD_ALIASES == jax_wireup.METHOD_ALIASES


@pytest.mark.parametrize("nodelist", ["nid[0012-0015,0020]", "node1,node2",
                                      "host07", "gpu[3,5-9]", "a-b[07]"])
def test_first_host_is_the_jax_packages(nodelist):
    from pytorch_ddp_mnist_tpu.parallel import wireup as jax_wireup
    assert wireup._first_host(nodelist) == jax_wireup._first_host(nodelist)


def test_a_tpu_pod_marker_is_no_world_here(no_launcher):
    """The JAX package detects a multi-worker TPU pod; the port has no such
    method, so the marker alone is a single process."""
    no_launcher.setenv("TPU_WORKER_HOSTNAMES", "w0,w1")
    assert wireup.detect_method() == "single"
    rt = wireup.initialize_runtime("auto", device_type="cpu")
    assert (rt.initialized, rt.size, rt.backend) == (False, 1, None)
    assert rt.reduce_max(3.5) == 3.5
    rt.barrier()
    rt.finalize()


@pytest.mark.parametrize("request_,device,local,cards,want", [
    (None, "cpu", 4, 0, "gloo"),
    ("gloo", "cpu", 4, 0, "gloo"),
    (None, "cuda", 4, 1, "gloo"),        # ranks share the card
    ("gloo", "cuda", 1, 1, "gloo"),
    ("nccl", "cpu", 1, 0, "the ranks run on the CPU"),
    ("nccl", "cuda", 2, 1, "2 ranks share this node's 1 card"),
    ("nccl", "cuda", 8, 4, "8 ranks share this node's 4 card"),
])
def test_the_backend_follows_the_devices(request_, device, local, cards, want):
    if want in ("gloo", "nccl"):
        assert wireup.choose_backend(request_, device, local, cards) == want
    else:
        with pytest.raises(RuntimeError, match=want):
            wireup.choose_backend(request_, device, local, cards)


def test_a_card_a_rank_takes_nccl_or_names_its_absence():
    import torch.distributed as dist
    for request in (None, "nccl"):
        if dist.is_nccl_available():
            assert wireup.choose_backend(request, "cuda", 2, 2) == "nccl"
        else:
            with pytest.raises(RuntimeError, match="has no NCCL"):
                wireup.choose_backend(request, "cuda", 2, 2)


def test_world_mesh_numbers_its_replicas_globally():
    cpu = torch.device("cpu")
    mesh = WorldMesh([cpu, cpu], world_size=3, rank=2)
    assert tuple(mesh) == (cpu, cpu) and len(mesh) == 2
    assert (world_size(mesh), first_replica(mesh), replicas(mesh)) == (3, 4, 6)
    plain = (cpu,) * 2
    assert (world_size(plain), first_replica(plain), replicas(plain)) == (1, 0, 2)
    with pytest.raises(ValueError, match="outside the world"):
        WorldMesh([cpu], world_size=2, rank=2)


# ---- a 4-rank world against the single-process mesh and the JAX golden ----

def test_four_rank_world_is_the_mesh_bitwise_and_the_jax_golden(tmp_path):
    outs = _run_world([sys.executable, os.path.abspath(__file__), "--rank",
                       "--out", str(tmp_path)])
    results = sorted((json.loads([ln for ln in o.splitlines()
                                  if ln.startswith("{")][-1])
                      for _, o, _ in outs), key=lambda r: r["rank"])
    assert [r["rank"] for r in results] == list(range(WORLD))
    for r in results:
        assert (r["size"], r["backend"], r["reduce_max"]) == (WORLD, "gloo",
                                                              WORLD - 1)
        assert f"rank(s) [{WORLD - 1}] hold other params" in r["refusal"]

    hp = _hparams()
    x_all, y_all = _data(hp)
    shards = _shards(hp, WORLD)
    lb = hp["local_batch"]
    from test_multiprocess import _golden_worker_run
    g_losses, g_checksum = _golden_worker_run()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kernel, make in KERNELS.items():
            runs = [torch.load(tmp_path / f"rank{r}_{kernel}.pt")
                    for r in range(WORLD)]
            for run in runs[1:]:                  # lockstep, atol 0
                assert torch.equal(run["losses"], runs[0]["losses"])
                for n in run["params"]:
                    for k in run["params"][n]:
                        assert torch.equal(run["params"][n][k],
                                           runs[0]["params"][n][k])
            # the single-process 4-replica mesh on the world's rows
            losses, params = _train(
                make((torch.device("cpu"),) * WORLD, hp["lr"]), hp, x_all,
                y_all, lambda s: np.concatenate(
                    [sh[s * lb:(s + 1) * lb] for sh in shards]))
            assert torch.equal(runs[0]["losses"], losses), kernel
            for n in params:
                for k in params[n]:
                    assert torch.equal(runs[0]["params"][n][k], params[n][k]), \
                        f"{kernel} {n}.{k}"
            np.testing.assert_allclose(runs[0]["losses"].numpy(), g_losses,
                                       rtol=1e-5, atol=1e-6)
            checksum = float(sum(v.detach().abs().sum() for layer in params.values()
                                 for v in layer.values()))
            np.testing.assert_allclose(checksum, g_checksum, rtol=1e-5)
    finally:
        torch.set_num_threads(threads)


# ---- the CLI over ranks ----

def test_four_rank_cli_prints_one_epoch_line_and_saves_on_rank_zero(tmp_path):
    ckpt = tmp_path / "model.pt"
    outs = _run_world(_cli_argv("--checkpoint", str(ckpt), "--path",
                                str(tmp_path / "no_mnist")), cwd=tmp_path)
    rank0 = outs[0][1]
    assert rank0.count("Epoch=0,") == 1, rank0
    assert re.search(r"^Epoch=0, train_loss=[-0-9.e]+, val_loss=[-0-9.e]+  "
                     r"\[mean_train=", rank0, re.M), rank0
    assert ("parallel=4x64 world=4 rank=0 backend=gloo wireup=env" in rank0
            and f"saved checkpoint to {ckpt}" in rank0), rank0
    for _, out, _ in outs[1:]:
        assert "Epoch=" not in out and "saved checkpoint" not in out, out
    assert ckpt.exists()


def test_four_rank_cached_cli_loss_falls_over_two_epochs(tmp_path):
    outs = _run_world(_cli_argv("--cached", "--n_epochs", "2",
                                "--checkpoint", "", "--path",
                                str(tmp_path / "no_mnist")), cwd=tmp_path)
    lines = [ln for ln in outs[0][1].splitlines() if ln.startswith("Epoch=")]
    assert len(lines) == 2, outs[0]
    for _, out, _ in outs[1:]:
        assert "Epoch=" not in out
    means = [float(re.search(r"mean_train=([0-9.]+|nan|inf)", ln).group(1))
             for ln in lines]
    assert np.isfinite(means).all() and means[1] < means[0], lines


# ---- a world's --cached rows: the JAX cached path's global sampler ----

def _strip_rate(line: str) -> str:
    """An epoch line without its img/s (a wall-clock rate)."""
    return re.sub(r" [0-9]+ img/s\]$", "]", line)


@pytest.mark.parametrize("argv", [["--kernel", "xla"], ["--kernel", "pallas"],
                                  ["--kernel", "pallas", "--fused"]],
                         ids=["xla", "pallas", "pallas-fused"])
def test_two_rank_cached_world_is_the_two_replica_mesh_bitwise(tmp_path,
                                                                argv):
    """`train --cached --parallel` over 2 gloo ranks: every rank builds the
    global sampler and takes its half of each global batch, so the run is
    bitwise the single-process 2-replica mesh fed the global batches (no
    earlier test saw the per-rank shards it used to take)."""
    from pytorch_ddp_mnist_tpu_torch.data.mnist import get_mnist
    from pytorch_ddp_mnist_tpu_torch.train import scan
    from pytorch_ddp_mnist_tpu_torch.train.checkpoint import load_checkpoint
    ckpt = tmp_path / "model.pt"
    outs = _run_world(_cli_argv("--cached", "--n_epochs", "2", "--checkpoint",
                                str(ckpt), "--path", str(tmp_path / "no_mnist"),
                                *argv), world=2, cwd=tmp_path)
    lines = [_strip_rate(ln) for ln in outs[0][1].splitlines()
             if ln.startswith("Epoch=")]
    assert len(lines) == 2 and "Epoch=" not in outs[1][1]

    quiet = str(tmp_path / "no_mnist")
    train = get_mnist(quiet, train=True, quiet=True)
    test = get_mnist(quiet, train=False, quiet=True)
    model = MLP.from_seed(0)
    want = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scan.fit_cached(
            model, threefry.key_data(1), train.images[:1024],
            train.labels[:1024].astype(np.int32),
            ShardedSampler(1024, num_replicas=1, rank=0, seed=42),
            normalize_images(test.images), test.labels.astype(np.int32),
            epochs=2, batch_size=128, lr=0.01, kernel=argv[1],
            fused="--fused" in argv, mesh=(torch.device("cpu"),) * 2,
            log=lambda line: want.append(_strip_rate(line)))
    finally:
        torch.set_num_threads(threads)
    assert lines == want
    saved = load_checkpoint(str(ckpt))
    for n, layer in model.params().items():
        for k, v in layer.items():
            assert torch.equal(saved[n][k], v.detach()), f"{n}.{k}"


def test_a_world_ranks_cached_rows_are_the_jax_cached_paths():
    """Rank r's rows at steps 0, 1 and the last are the JAX cached path's:
    its global `ShardedSampler(n, num_replicas=1, rank=0, seed=42)`, each
    global batch sliced over the mesh as P(None, DATA_AXIS) gives process
    r its device's rows."""
    from pytorch_ddp_mnist_tpu.parallel.sampler import ShardedSampler as JaxSampler
    from pytorch_ddp_mnist_tpu.train import scan as jax_scan
    from pytorch_ddp_mnist_tpu_torch.train import scan
    n, batch, world = 1024, 128, 2
    ours = ShardedSampler(n, num_replicas=1, rank=0, seed=42)
    ref = JaxSampler(n, num_replicas=1, rank=0, seed=42)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        glob = jax_scan.epoch_batch_indices(ref, batch)
        for r in range(world):
            mesh = WorldMesh(["cpu"], world_size=world, rank=r)
            rows = scan.epoch_rows(ours, batch, mesh)
            lo = r * batch // world
            for step in (0, 1, len(glob) - 1):
                np.testing.assert_array_equal(
                    rows[step], glob[step, lo:lo + batch // world])
            assert rows.shape == (n // batch, batch // world)
    with pytest.raises(ValueError, match="takes the global sampler"):
        scan.epoch_rows(ShardedSampler(n, num_replicas=2, rank=0), batch,
                        WorldMesh(["cpu"], world_size=2, rank=0))


def test_the_epoch_kernel_across_processes_exits_by_name(tmp_path):
    outs = _run_world(_cli_argv("--cached", "--kernel", "pallas_epoch",
                                "--checkpoint", "", "--path",
                                str(tmp_path / "no_mnist")), world=2,
                      cwd=tmp_path, expect_ok=False)
    for rc, out, err in outs:
        assert rc not in (0, None), (out, err)
        assert "across a world of 2 processes" in err, err
        assert "queue 2, item 6" in err and "Epoch=" not in out, err


def _cli(argv, tmp_path):
    from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
    return port_cli.train(["--device", "cpu", "--limit", "512",
                           "--batch_size", "64", "--checkpoint", "",
                           "--path", str(tmp_path / "no_mnist"), *argv])


@pytest.mark.parametrize("argv", [["--kernel", "xla"], ["--kernel", "pallas"],
                                  ["--cached", "--kernel", "pallas"]],
                         ids=["xla", "pallas", "cached-pallas"])
def test_one_rank_env_world_is_the_serial_parallel_run_bitwise(
        no_launcher, tmp_path, capsys, argv):
    import torch.distributed as dist
    serial_state, serial = _cli(["--parallel", *argv], tmp_path)
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        no_launcher.setenv(k, v)
    state, history = _cli(["--parallel", "--wireup_method", "env", *argv],
                          tmp_path)
    assert not dist.is_initialized()           # finalized
    assert "parallel=1x64 world=1 rank=0 backend=gloo" in capsys.readouterr().out
    for a, b in zip(serial, history):
        np.testing.assert_array_equal(a, b)
    assert state.key == serial_state.key
    for n, layer in serial_state.model.params().items():
        for k, v in layer.items():
            assert torch.equal(state.model.params()[n][k], v)


# ---- the refusals by name ----

def test_wireup_tpu_is_refused_by_name():
    from pytorch_ddp_mnist_tpu_torch.train.config import configure
    with pytest.raises(SystemExit, match="--wireup_method tpu reads a Cloud "
                                         "TPU pod's metadata"):
        configure(["--parallel", "--wireup_method", "tpu"])
    with pytest.raises(RuntimeError, match="wireup method 'tpu'"):
        wireup.initialize_runtime("tpu", device_type="cpu")


def test_nccl_on_the_cpu_is_refused_by_name(no_launcher, tmp_path):
    no_launcher.setenv("PMI_RANK", "0")
    no_launcher.setenv("PMI_SIZE", "2")
    with pytest.raises(SystemExit, match="NCCL was asked for .* run on the "
                                         "CPU"):
        _cli(["--parallel", "--wireup_method", "nccl-mpich"], tmp_path)


@pytest.mark.parametrize("method,var", [("slurm", "SLURM_PROCID"),
                                        ("nccl-openmpi", "OMPI_COMM_WORLD_RANK"),
                                        ("mpich", "PMI_RANK")])
def test_a_missing_launcher_variable_is_named(no_launcher, tmp_path, method,
                                              var):
    with pytest.raises(SystemExit, match=f"{var} is not set"):
        _cli(["--parallel", "--wireup_method", method], tmp_path)


def test_the_epoch_kernel_across_processes_is_refused_by_the_scan():
    from pytorch_ddp_mnist_tpu_torch.train import scan
    mesh = WorldMesh(["cpu"], world_size=2, rank=1)
    with pytest.raises(ValueError, match="across a world of 2 processes"):
        scan.make_dp_run_fn(mesh, 0.01, kernel="pallas_epoch")
    scan.make_dp_run_fn(mesh, 0.01, kernel="pallas")      # the per-step path


def test_a_formed_world_of_another_size_is_refused_by_name(no_launcher):
    import torch.distributed as dist
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        no_launcher.setenv(k, v)
    no_launcher.setattr(dist, "get_world_size", lambda *a, **k: 2)
    with pytest.raises(RuntimeError, match="expected 1 processes, the process "
                                           "group formed 2"):
        wireup.initialize_runtime("env", device_type="cpu")
    assert not dist.is_initialized()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--rank", action="store_true")
    p.add_argument("--out", required=True)
    sys.exit(_rank_main(p.parse_args().out))
