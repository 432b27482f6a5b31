"""Kill a training run at a seeded step, resume it, and hold the result
bitwise against the unbroken run (the port's counterpart of the JAX
package's `scripts/chaos_smoke.py`).

    python -m pytorch_ddp_mnist_tpu_torch.chaos [--device 0|cpu]
        [--world 2] [--chaos_seed 0] [--epochs 3] [--limit 1024]
        [--batch_size 32] [--ckpt_every_steps 2] [--timeout 240]
        [--workdir DIR]

The legs, each a set of trainer processes (`python -m
pytorch_ddp_mnist_tpu_torch train`) with a time limit, killed on their
first failure:

  1. world: an unbroken `--parallel --cached` world of `--world` ranks
     (the env wireup; gloo, on the CPU or sharing the card) with
     `--ckpt_every_steps`, the golden final checkpoint;
  2. chaos: the same world under `PDMT_FAULT=kill:rank=R:step=K`, R and K
     drawn from `--chaos_seed`: rank R SIGKILLs itself at the first step
     boundary >= K, the survivors, blocked in a collective, are reaped (a
     gang scheduler's view: one task dead, the job dead), and the step
     directory stays as the crash left it;
  3. resume: a new world with `--resume <the step directory>` and
     `--telemetry <workdir>/telemetry` restores the newest intact
     checkpoint on every rank and finishes;
  4. verdict: the resumed final checkpoint is byte for byte the golden
     one's (flax msgpack), and the resume's trace passes
     `scripts/check_telemetry.py --require checkpoint.` (the JAX script's
     telemetry gate, pure stdlib);
  5. piped leg (serial, streaming): an unpiped golden run; a run with
     `--input_workers 2 --prefetch_depth 2` killed mid-epoch with its
     decode workers live; the dead writer's `.tmp.<pid>` strays swept; the
     resume, piped, byte for byte the unpiped golden, with no stray left.

The JAX script's elastic leg needs `--elastic` (ROADMAP.md queue 1, item
13) and does not run here. Exit code 0 when every leg holds, 1 otherwise
(the failing processes' output on stderr); the last line of stdout is a
JSON summary.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# launcher variables a spawned rank must not inherit from its parent
_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT", "PDMT_FAULT",
                  "PDMT_NO_REEXEC", "SLURM_PROCID", "SLURM_NTASKS",
                  "OMPI_COMM_WORLD_RANK", "PMI_RANK")
TRAIN = [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_VARS}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def world_env(world: int, port: int, rank: int, **extra) -> dict:
    return rank_env(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                    LOCAL_WORLD_SIZE=world, MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=port, **extra)


def run_procs(cmds, cwd: str, timeout: float, *, victim: int | None = None):
    """Run the (argv, env) pairs together, each in a session of its own,
    and return [(rc, out, err)]. All of them are killed at `timeout`, on
    the first failure, or, with `victim`, once that one has exited (the
    others are the survivors of its death)."""
    procs, files = [], []
    for argv, env in cmds:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                      stdout=out, stderr=err,
                                      start_new_session=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if victim is not None:
                if procs[victim].poll() is not None:
                    break
            elif any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    res = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        res.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return res


def run_world(argv: list, world: int, cwd: str, timeout: float, *,
              victim: int | None = None, **env) -> list:
    """A world of `world` trainer ranks under the env wireup; retried on a
    port race only."""
    for _ in range(3):
        port = free_port()
        res = run_procs([(TRAIN + argv, world_env(world, port, r, **env))
                         for r in range(world)], cwd, timeout, victim=victim)
        if not any("Address already in use" in e or "EADDRINUSE" in e
                   for _, _, e in res):
            return res
    return res


def run_serial(argv: list, cwd: str, timeout: float, **env) -> tuple:
    return run_procs([(TRAIN + argv, rank_env(**env))], cwd, timeout)[0]


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def sweep_strays(steps_dir: str) -> list:
    """Remove the `.tmp.<pid>` files a killed writer left in the step
    directory (a kill between a payload's temp write and its rename) and
    return their names; the manager's next save would sweep them too."""
    swept = []
    for name in sorted(os.listdir(steps_dir)):
        if ".tmp." in name:
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(steps_dir, name))
                swept.append(name)
    return swept


class ChaosFailure(RuntimeError):
    """A leg that did not hold; the message carries the evidence."""


def _check_ok(res: list, what: str) -> None:
    if any(rc != 0 for rc, _, _ in res):
        raise ChaosFailure(f"{what}:\n" + "\n".join(
            f"--- process {r} rc={rc}\n{out[-3000:]}\n{err[-3000:]}"
            for r, (rc, out, err) in enumerate(res)))


def draw_kill(seed: int, world: int, steps_per_epoch: int, epochs: int,
              every: int) -> tuple:
    """(rank, step) of the kill, from `seed`: a rank of the world, and a
    step past the first checkpoint and before the last epoch."""
    total = steps_per_epoch * epochs
    lo = max(1, every)
    if lo >= total:
        raise ChaosFailure(
            f"ckpt_every_steps={every} >= the run's {total} steps "
            f"({steps_per_epoch} an epoch x {epochs}): no checkpoint would "
            f"commit before the kill")
    rng = random.Random(seed)
    rank = rng.randrange(world)
    return rank, rng.randrange(lo, max(lo + 1, total - steps_per_epoch))


def world_leg(work: str, *, device: str, world: int, seed: int, epochs: int,
              limit: int, batch: int, every: int, timeout: float,
              extra=()) -> dict:
    """Legs 1-4 of the module docstring; returns the leg's numbers."""
    spe = -(-limit // (batch * world))
    kill_rank, kill_step = draw_kill(seed, world, spe, epochs, every)
    golden = os.path.join(work, "world_golden.msgpack")
    flaky = os.path.join(work, "world_flaky.msgpack")
    steps_dir = flaky + ".steps"
    base = ["--parallel", "--cached", "--wireup_method", "env", "--device",
            device, "--n_epochs", str(epochs), "--limit", str(limit),
            "--batch_size", str(batch), "--lr", "0.1",
            "--path", os.path.join(work, "data"),
            "--ckpt_every_steps", str(every), *extra]
    t0 = time.perf_counter()
    _check_ok(run_world(base + ["--checkpoint", golden], world, work,
                        timeout), "world baseline")
    fault = f"kill:rank={kill_rank}:step={kill_step}"
    res = run_world(base + ["--checkpoint", flaky], world, work, timeout,
                    victim=kill_rank, PDMT_FAULT=fault)
    if res[kill_rank][0] != -signal.SIGKILL:
        raise ChaosFailure(f"world chaos: rank {kill_rank} exited "
                           f"{res[kill_rank][0]}, not by SIGKILL\n"
                           f"{res[kill_rank][2][-3000:]}")
    if not os.path.isdir(steps_dir) or not os.listdir(steps_dir):
        raise ChaosFailure(f"world chaos: no step checkpoints in {steps_dir}")
    committed = sorted(n for n in os.listdir(steps_dir) if n.endswith(".json"))
    tel = os.path.join(work, "telemetry")
    res = run_world(base + ["--checkpoint", flaky, "--resume", steps_dir,
                            "--telemetry", tel], world, work, timeout)
    _check_ok(res, "world resume")
    if "[ckpt] resuming from" not in res[0][2]:
        raise ChaosFailure(f"world resume printed no restore line\n"
                           f"{res[0][2][-3000:]}")
    if read_bytes(golden) != read_bytes(flaky):
        raise ChaosFailure("world: the resumed final checkpoint differs from "
                           "the unbroken run's")
    return {"world": world, "kill": fault, "steps_per_epoch": spe,
            "committed_at_kill": committed, "parity": "bitwise",
            "telemetry_gate": telemetry_gate(tel, "checkpoint."),
            "wall_s": round(time.perf_counter() - t0, 1)}


def telemetry_gate(directory: str, require: str) -> str:
    """`scripts/check_telemetry.py --require <require> <directory>`; raises
    ChaosFailure on a violation and returns what held."""
    checker = os.path.join(REPO, "scripts", "check_telemetry.py")
    out = subprocess.run([sys.executable, checker, "--require", require,
                          directory], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        raise ChaosFailure(f"telemetry gate: check_telemetry.py --require "
                           f"{require} failed:\n{out.stdout}\n{out.stderr}")
    return f"check_telemetry.py --require {require}: ok"


def piped_leg(work: str, *, device: str, seed: int, timeout: float,
              limit: int = 256, batch: int = 32, epochs: int = 2,
              every: int = 2, extra=()) -> dict:
    """Leg 5 of the module docstring; returns the leg's numbers."""
    spe = -(-limit // batch)
    _, kill_step = draw_kill(seed + 1, 1, spe, epochs, every)
    golden = os.path.join(work, "pipe_golden.msgpack")
    flaky = os.path.join(work, "pipe_flaky.msgpack")
    steps_dir = flaky + ".steps"
    base = ["--device", device, "--n_epochs", str(epochs), "--limit",
            str(limit), "--batch_size", str(batch), "--lr", "0.1",
            "--path", os.path.join(work, "data"),
            "--ckpt_every_steps", str(every), *extra]
    pipe = ["--input_workers", "2", "--prefetch_depth", "2"]
    t0 = time.perf_counter()
    _check_ok([run_serial(base + ["--checkpoint", golden], work, timeout)],
              "piped leg golden")
    rc, _, err = run_serial(base + pipe + ["--checkpoint", flaky], work,
                            timeout, PDMT_FAULT=f"kill:step={kill_step}")
    if rc != -signal.SIGKILL:
        raise ChaosFailure(f"piped chaos exited {rc}, not by SIGKILL\n"
                           f"{err[-3000:]}")
    if not os.path.isdir(steps_dir) or not os.listdir(steps_dir):
        raise ChaosFailure(f"piped chaos: no step checkpoints in {steps_dir}")
    swept = sweep_strays(steps_dir)
    res = run_serial(base + pipe + ["--checkpoint", flaky, "--resume",
                                    steps_dir], work, timeout)
    _check_ok([res], "piped resume")
    if read_bytes(golden) != read_bytes(flaky):
        raise ChaosFailure("piped: the resumed final checkpoint differs from "
                           "the UNPIPED golden run's")
    stray = [n for n in os.listdir(steps_dir) if ".tmp." in n]
    if stray:
        raise ChaosFailure(f"piped: temp strays survived the leg: {stray}")
    return {"kill_step": kill_step, "steps_per_epoch": spe,
            "swept_strays": swept, "parity": "bitwise",
            "wall_s": round(time.perf_counter() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch.chaos",
        description="kill/resume chaos parity of the PyTorch trainer")
    ap.add_argument("--device", default="0",
                    help="the trainers' --device (a CUDA ordinal, or cpu)")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--chaos_seed", type=int, default=0,
                    help="seeds the (kill rank, kill step) draws")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--limit", type=int, default=1024)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--ckpt_every_steps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="each set of processes' time limit (seconds)")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: a fresh temp dir, "
                         "removed after a run that holds)")
    a = ap.parse_args(argv)
    work = a.workdir or tempfile.mkdtemp(prefix="pdmt_chaos_")
    os.makedirs(work, exist_ok=True)
    try:
        world = world_leg(work, device=a.device, world=a.world,
                          seed=a.chaos_seed, epochs=a.epochs, limit=a.limit,
                          batch=a.batch_size, every=a.ckpt_every_steps,
                          timeout=a.timeout)
        print(f"chaos: world leg {json.dumps(world)}", flush=True)
        piped = piped_leg(work, device=a.device, seed=a.chaos_seed,
                          timeout=a.timeout)
        print(f"chaos: piped leg {json.dumps(piped)}", flush=True)
    except ChaosFailure as e:
        print(f"chaos: FAIL — {e}", file=sys.stderr)
        return 1
    print(json.dumps({"chaos": "ok", "chaos_seed": a.chaos_seed,
                      "world_leg": world, "piped_leg": piped,
                      "telemetry_gate": world["telemetry_gate"],
                      "elastic_leg": "not run: ROADMAP.md queue 1, item 13"}))
    if a.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
