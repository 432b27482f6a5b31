"""The trainer's outage retry (`--outage_retries`, cli/train.py
`_train_with_outage_retry`, modelled on the JAX package's
tests/test_outage_resume.py), on the CPU:

  * an injected `collective_timeout` at an epoch's end barrier is retried
    in the process and the run ends bitwise the unbroken one, cached and
    streaming, also when no epoch has completed since the start;
  * an exhausted budget re-raises; a program error on a healthy backend is
    not retried;
  * a wedged context persists the stash (checkpoint and `.rng.npz`
    sidecar) and re-execs with `--resume`, `--start_epoch` and the retries
    left; running that argv finishes bitwise, and the default stash of a
    run with no --checkpoint is removed after it;
  * a sticky CUDA error on a card run takes the same persist-and-re-exec
    path (its context is poisoned);
  * the sidecar survives a resume that dies before its first save;
  * a 2-rank gloo world retries by the coordinated re-exec of every rank
    (a 90 s limit, killed on the first failure) and ends bitwise.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.data.idx import write_idx
from pytorch_ddp_mnist_tpu_torch import chaos
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.parallel import wireup
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints

LIMIT_S = 90


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for prefix, n, seed in (("train", 192, 4), ("t10k", 64, 5)):
        split = synthetic_mnist(n, seed)
        write_idx(str(root / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(root / f"{prefix}-labels-idx1-ubyte"), split.labels)
    return str(root)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """One thread (as the spawned trainers), no leftover fault specs or
    re-exec marker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("PDMT_NO_REEXEC", raising=False)
    monkeypatch.delenv(faultpoints.FAULT_ENV, raising=False)
    yield
    torch.set_num_threads(before)
    os.environ.pop("PDMT_NO_REEXEC", None)
    faultpoints.install()


def _args(mnist, ckpt, *extra, cached=True):
    return ["--device", "cpu", "--limit", "192", "--batch_size", "32",
            "--lr", "0.1", "--n_epochs", "3", "--path", mnist,
            "--checkpoint", str(ckpt), *(["--cached"] if cached else []),
            *extra]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def golden(mnist, tmp_path_factory):
    out = {}
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    for cached in (True, False):
        path = tmp_path_factory.mktemp("golden") / "g.msgpack"
        port_cli.train(_args(mnist, path, cached=cached))
        out[cached] = _bytes(path)
    torch.set_num_threads(before)
    return out


@pytest.mark.parametrize("cached,epoch", [(True, 1), (False, 1), (True, 0)])
def test_a_collective_timeout_is_retried_in_the_process(tmp_path, mnist,
                                                        golden, capsys,
                                                        cached, epoch):
    ck = tmp_path / "f.msgpack"
    port_cli.train(_args(mnist, ck, "--outage_retries", "1", "--fault",
                         f"collective_timeout:epoch={epoch}", cached=cached))
    out = capsys.readouterr()
    assert "[outage] training interrupted" in out.err
    assert out.out.count("Epoch=2,") == 1
    assert out.out.count(f"Epoch={epoch + 1},") == 1   # not run twice
    assert _bytes(ck) == golden[cached]


def test_an_exhausted_budget_reraises(tmp_path, mnist):
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        port_cli.train(_args(mnist, tmp_path / "x.msgpack",
                             "--outage_retries", "2", "--fault",
                             "collective_timeout:times=5"))


def test_a_program_error_is_not_retried(tmp_path, mnist, monkeypatch):
    calls = {"n": 0}

    def broken(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("mat1 and mat2 shapes cannot be multiplied "
                           "(simulated program bug)")

    monkeypatch.setattr(port_cli, "fit_cached", broken)
    with pytest.raises(RuntimeError, match="mat1 and mat2"):
        port_cli.train(_args(mnist, tmp_path / "x.msgpack",
                             "--outage_retries", "3"))
    assert calls["n"] == 1


def _wedge(monkeypatch, execs):
    def wedged(max_wait_s, **kw):
        raise wireup.BackendWedgedError("context wedged (simulated)")

    monkeypatch.setattr(wireup, "wait_for_backend", wedged)
    monkeypatch.setattr(os, "execv", lambda exe, argv: execs.append(argv)
                        or (_ for _ in ()).throw(SystemExit(99)))


@pytest.mark.parametrize("checkpoint", ["f.msgpack", ""])
def test_a_wedged_context_persists_and_reexecs(tmp_path, mnist, golden,
                                               monkeypatch, checkpoint):
    monkeypatch.chdir(tmp_path)
    execs = []
    _wedge(monkeypatch, execs)
    args = _args(mnist, checkpoint, "--outage_retries", "1", "--fault",
                 "collective_timeout:epoch=1")
    monkeypatch.setattr(sys, "argv", ["__main__.py", "train", *args])
    with pytest.raises(SystemExit) as e:
        port_cli.main(None)
    assert e.value.code == 99 and len(execs) == 1
    argv = execs[0]
    assert argv[:4] == [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch",
                        "train"]
    tail = argv[4:]
    stash = tail[tail.index("--resume") + 1]
    assert stash == (checkpoint or "outage_resume.msgpack")
    assert tail[tail.index("--start_epoch") + 1] == "2"
    assert tail[len(tail) - 1 - tail[::-1].index("--outage_retries") + 1] \
        == "0"
    with np.load(stash + ".rng.npz") as z:
        assert str(z["impl"]) == "threefry2x32"
    assert os.environ["PDMT_NO_REEXEC"] == "1"     # a serial re-exec: once
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    port_cli.train(tail)
    assert not os.path.exists(stash + ".rng.npz")
    if checkpoint:
        assert _bytes(checkpoint) == golden[True]
    else:                               # the default stash is swept
        assert not os.path.exists(stash)


def test_a_sticky_cuda_error_reexecs_a_card_run(tmp_path, monkeypatch):
    """The poisoned context of a card run: the serial path persists and
    re-execs without an in-process wait (the run is faked; no card)."""
    execs = []
    _wedge(monkeypatch, execs)
    monkeypatch.setattr(wireup, "wait_for_backend", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("no in-process wait")))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["__main__.py", "train", "--x"])
    from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP
    from pytorch_ddp_mnist_tpu_torch.train.loop import TrainState

    def run_fit(st, start):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    model = MLP.from_seed(0)
    tcfg = {"outage_retries": 2, "start_epoch": 0, "parallel": False,
            "checkpoint": "s.msgpack", "impl": "threefry2x32"}
    stash = {"epoch": 0, **port_cli._host_state(model, (0, 1))}
    with pytest.raises(SystemExit):
        port_cli._train_with_outage_retry(run_fit, TrainState(model, (0, 1)),
                                          tcfg, stash, True, 0,
                                          torch.device("cuda", 0))
    assert execs[0][4:] == ["--x", "--resume", "s.msgpack", "--start_epoch",
                            "1", "--outage_retries", "1"]
    assert os.path.exists("s.msgpack") and os.path.exists("s.msgpack.rng.npz")


def test_the_sidecar_survives_a_resume_that_dies_before_its_first_save(
        tmp_path, mnist, monkeypatch):
    ck = tmp_path / "c.msgpack"
    base = ["--device", "cpu", "--limit", "192", "--batch_size", "32",
            "--path", mnist, "--checkpoint", str(ck), "--cached"]
    port_cli.train(base + ["--n_epochs", "1"])
    sidecar = str(ck) + ".rng.npz"
    np.savez(sidecar, key=np.asarray([0, 123], np.uint32),
             impl="threefry2x32")

    def dies(*a, **kw):
        raise RuntimeError("UNAVAILABLE: socket closed (simulated outage "
                           "before any epoch completes)")

    monkeypatch.setattr(port_cli, "fit_cached", dies)
    resume = ["--n_epochs", "2", "--resume", str(ck), "--start_epoch", "1"]
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        port_cli.train(base + resume)
    assert os.path.exists(sidecar)       # the pair is left for the next try
    monkeypatch.undo()
    port_cli.train(base + resume)
    assert not os.path.exists(sidecar)   # consumed at the first overwrite


def test_a_world_retries_by_the_coordinated_reexec(tmp_path, mnist):
    base = ["--parallel", "--cached", "--wireup_method", "env", "--device",
            "cpu", "--n_epochs", "2", "--limit", "128", "--batch_size", "32",
            "--lr", "0.1", "--path", mnist]
    res = chaos.run_world(base + ["--checkpoint", "g.msgpack"], 2,
                          str(tmp_path), LIMIT_S)
    assert [r[0] for r in res] == [0, 0], res[0][2][-3000:]
    res = chaos.run_world(base + ["--checkpoint", "f.msgpack",
                                  "--outage_retries", "1", "--fault",
                                  "collective_timeout:epoch=0"], 2,
                          str(tmp_path), LIMIT_S)
    assert [r[0] for r in res] == [0, 0], res[1][2][-3000:]
    assert all("coordinated parallel resume" in err for _, _, err in res)
    assert _bytes(tmp_path / "f.msgpack") == _bytes(tmp_path / "g.msgpack")
    assert not (tmp_path / "f.msgpack.rank1").exists()   # swept
