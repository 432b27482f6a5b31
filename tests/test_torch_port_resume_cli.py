"""The trainer CLI's step checkpoints, resume and fault flags
(pytorch_ddp_mnist_tpu_torch/cli/train.py, train/config.py), on the CPU:

  * `train --ckpt_every_steps N --checkpoint X --fault kill:step=K` dies by
    SIGKILL with committed checkpoints, and `--resume X.steps` finishes it
    byte for byte the unbroken run's final checkpoint (streaming and
    `--cached`);
  * the same for a 2-rank gloo world killed at a seeded rank and step
    (the port's chaos script, pytorch_ddp_mnist_tpu_torch/chaos.py), each
    world with its own 90 s limit, killed on its first failure;
  * an epoch-granular `--resume file --start_epoch 1` with the key chain in
    the `.rng.npz` sidecar, bitwise the unbroken run, the sidecar consumed
    at the first save;
  * the directory resume's refusals (a conflicting --start_epoch, another
    run geometry, a mid-epoch checkpoint under pallas_epoch);
  * every JAX CLI refusal of these flags, by name, in the JAX package's
    words.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.cli.train import main as jax_main
from pytorch_ddp_mnist_tpu.data.idx import write_idx
from pytorch_ddp_mnist_tpu_torch import chaos
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 90


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """256 train and 64 test rows as IDX files: both packages read them."""
    root = tmp_path_factory.mktemp("idx")
    for prefix, n, seed in (("train", 256, 4), ("t10k", 64, 5)):
        split = synthetic_mnist(n, seed)
        write_idx(str(root / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(root / f"{prefix}-labels-idx1-ubyte"), split.labels)
    return str(root)


@pytest.fixture(autouse=True)
def one_thread():
    """The in-process runs on one thread, as the spawned trainers run
    (OMP_NUM_THREADS=1): a CPU product's bits depend on its threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _base(mnist, *extra):
    return ["--device", "cpu", "--batch_size", "32", "--lr", "0.05",
            "--path", mnist, *extra]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", [[], ["--cached"]])
def test_killed_run_resumes_from_its_step_directory_bitwise(tmp_path, mnist,
                                                            mode):
    base = _base(mnist, "--n_epochs", "2", "--ckpt_every_steps", "5", *mode)
    golden, flaky = str(tmp_path / "g.msgpack"), str(tmp_path / "f.msgpack")
    port_cli.train(base + ["--checkpoint", golden])
    rc, out, err = chaos.run_serial(
        base + ["--checkpoint", flaky, "--fault", "kill:step=12"],
        str(tmp_path), LIMIT_S)
    assert rc == -9, err[-3000:]
    steps = flaky + ".steps"
    # the streaming loop dies at step 12, before its save at 13; the
    # resident-dataset loop at its first chunk boundary past 12, after it
    committed = ["step_00000005.json", "step_00000008.json"] + (
        ["step_00000013.json"] if mode else [])
    assert sorted(n for n in os.listdir(steps)
                  if n.endswith(".json")) == committed
    port_cli.train(base + ["--checkpoint", flaky, "--resume", steps])
    assert _bytes(flaky) == _bytes(golden)


def test_a_two_rank_world_killed_at_a_seeded_step_resumes_bitwise(tmp_path,
                                                                   mnist):
    leg = chaos.world_leg(str(tmp_path), device="cpu", world=2, seed=0,
                          epochs=3, limit=256, batch=32, every=2,
                          timeout=LIMIT_S, extra=("--path", mnist))
    assert leg["kill"] == "kill:rank=1:step=5"      # the seed's draw
    assert leg["parity"] == "bitwise" and leg["committed_at_kill"]
    # the resume ran with --telemetry and its trace passed the JAX checker
    assert leg["telemetry_gate"] == \
        "check_telemetry.py --require checkpoint.: ok"


@pytest.mark.parametrize("mode", [[], ["--cached", "--kernel",
                                       "pallas_epoch"]])
def test_epoch_resume_from_a_file_and_its_sidecar_is_bitwise(tmp_path,
                                                             mnist, mode):
    golden, part = str(tmp_path / "g.msgpack"), str(tmp_path / "p.msgpack")
    port_cli.train(_base(mnist, "--n_epochs", "2", "--checkpoint", golden,
                         *mode))
    state, _ = port_cli.train(_base(mnist, "--n_epochs", "1",
                                    "--checkpoint", part, *mode))
    sidecar = part + ".rng.npz"
    np.savez(sidecar, key=np.asarray(state.key, np.uint32),
             impl="threefry2x32")
    port_cli.train(_base(mnist, "--n_epochs", "2", "--checkpoint", part,
                         "--resume", part, "--start_epoch", "1", *mode))
    assert _bytes(part) == _bytes(golden)
    assert not os.path.exists(sidecar)      # consumed at the first save


def test_directory_resume_refusals(tmp_path, mnist):
    ck = str(tmp_path / "c.msgpack")
    port_cli.train(_base(mnist, "--n_epochs", "1", "--cached",
                         "--ckpt_every_steps", "3", "--checkpoint", ck))
    steps = ck + ".steps"
    with pytest.raises(SystemExit, match="--start_epoch conflicts"):
        port_cli.train(_base(mnist, "--n_epochs", "2", "--resume", steps,
                             "--start_epoch", "1", "--checkpoint", ""))
    with pytest.raises(SystemExit, match="different run geometry.*\n.*"
                                         "global_batch=32"):
        port_cli.train(_base(mnist, "--n_epochs", "2", "--resume", steps,
                             "--checkpoint", "", "--batch_size", "64"))
    with pytest.raises(SystemExit, match="past --n_epochs 0"):
        port_cli.train(_base(mnist, "--n_epochs", "0", "--resume", steps,
                             "--checkpoint", ""))
    os.remove(os.path.join(steps, "step_00000008.json"))    # mid-epoch left
    with pytest.raises(SystemExit, match="MID-epoch .* pallas_epoch"):
        port_cli.train(_base(mnist, "--n_epochs", "2", "--resume", steps,
                             "--checkpoint", "", "--cached", "--kernel",
                             "pallas_epoch"))


REFUSED = [
    ["--start_epoch", "5", "--n_epochs", "3"],
    ["--outage_retries", "-1"],
    ["--ckpt_every_steps", "-1"],
    ["--ckpt_keep", "0"],
    ["--ckpt_every_steps", "5", "--cached", "--fused"],
    ["--ckpt_every_steps", "5", "--cached", "--kernel", "pallas_epoch"],
    ["--ckpt_every_steps", "5", "--checkpoint", ""],
    ["--outage_retries", "1", "--parallel"],
    ["--outage_retries", "1", "--cached", "--fused"],
    ["--dropout_rng", "torch", "--outage_retries", "1"],
    ["--dropout_rng", "torch", "--resume", "x.msgpack"],
    ["--fault", "explode:step=1"],
    ["--fault", "kill:when=3"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: " ".join(a))
def test_every_jax_refusal_of_the_flags_is_the_port_s(tmp_path, argv):
    with pytest.raises(SystemExit) as want:
        jax_main(["--path", str(tmp_path), *argv])
    with pytest.raises(SystemExit) as got:
        port_cli.train(["--device", "cpu", "--path", str(tmp_path), *argv])
    assert str(got.value.code) == str(want.value.code)


def test_an_unparsable_fault_env_refuses_to_start(tmp_path, monkeypatch,
                                                  mnist):
    monkeypatch.setenv("PDMT_FAULT", "kill:step")
    with pytest.raises(SystemExit, match="--fault: .* is not key=value"):
        port_cli.train(_base(mnist, "--checkpoint", ""))


def test_the_front_door_hands_the_command_line_to_the_trainer(tmp_path,
                                                              mnist):
    """`python -m pytorch_ddp_mnist_tpu_torch train` is the CLI context: an
    outage retry of a world may re-exec it (a list argv may not)."""
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
         *_base(mnist, "--n_epochs", "1", "--checkpoint", "",
                "--outage_retries", "1", "--parallel")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=LIMIT_S,
        env=chaos.rank_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Epoch=0" in r.stdout
