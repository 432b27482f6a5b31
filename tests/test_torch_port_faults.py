"""The port's fault switchboard (pytorch_ddp_mnist_tpu_torch/utils/
faultpoints.py) and the outage helpers of its wireup, held against the JAX
package's on the same inputs:

  * `parse_faults` on the JAX tests' spec strings gives the JAX package's
    fields, and the same refusals by name;
  * first crossing, `times` and rank gating fire the same specs on the
    same sequence of fault-point crossings;
  * `poison_array` is bitwise the JAX package's on the same arrays;
  * `kill` in a subprocess dumps the flight recorder and exits by SIGKILL;
  * the loaders' `loader_next` and the barrier's `barrier` points fire;
  * `backoff_schedule`, `env_seconds` and `looks_like_backend_loss` agree
    with the JAX package's, and the port's signatures cover gloo, NCCL and
    sticky CUDA errors; `wait_for_backend` on the CPU, through a flaky
    probe and into a wedged context.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pytorch_ddp_mnist_tpu.parallel import wireup as jax_wireup
from pytorch_ddp_mnist_tpu.utils import faultpoints as jax_fp
from pytorch_ddp_mnist_tpu_torch.parallel import wireup
from pytorch_ddp_mnist_tpu_torch.telemetry.flight import get_flight_recorder
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [
    "kill:rank=2:step=5,loader_stall:batch=3:delay_s=0.25:times=2",
    "ckpt_save_io:step=5", "ckpt_save_io:times=2", "collective_timeout:rank=2",
    "loader_stall:batch=1:delay_s=0.2", "kill:step=3", "nan:step=5",
    "nan:step=2.5:epoch=1", "engine_crash:after=40:replica=0",
    "engine_wedge:delay_s=2:replica=1", "reload_torn", " , ", "",
]
BAD = ["explode:step=1", "kill:when=5", "kill:step", "kill:step=soon"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(fp.FAULT_ENV, raising=False)
    fp.install()
    yield
    os.environ.pop(fp.FAULT_ENV, None)
    fp.install()


def _fields(specs):
    return [(s.kind, s.point, dict(s.where), s.delay_s, s.times)
            for s in specs]


@pytest.mark.parametrize("text", SPECS)
def test_parse_gives_the_jax_fields(text):
    assert _fields(fp.parse_faults(text)) == _fields(jax_fp.parse_faults(text))
    assert [s.describe() for s in fp.parse_faults(text)] == [
        s.describe() for s in jax_fp.parse_faults(text)]


@pytest.mark.parametrize("bad", BAD)
def test_parse_refuses_what_jax_refuses_by_name(bad):
    with pytest.raises(jax_fp.FaultSpecError) as want:
        jax_fp.parse_faults(bad)
    with pytest.raises(fp.FaultSpecError) as got:
        fp.parse_faults(bad)
    assert str(got.value) == str(want.value)
    assert fp.POINTS == jax_fp.POINTS


@pytest.mark.parametrize("text,rank", [
    ("ckpt_save_io:step=5", 0), ("ckpt_save_io:times=2", 0),
    ("ckpt_save_io:step=3:times=3", 0), ("ckpt_save_io:rank=1:step=2", 1),
    ("ckpt_save_io:rank=1:step=2", 0), ("ckpt_save_io:epoch=1", 0),
])
def test_first_crossing_times_and_rank_gating_match_jax(text, rank):
    """The same crossings (steps 1, 2, 4, 7, 8, 9 of epochs 0 and 1) fire
    the same specs the same number of times in both injectors."""
    fired = []
    for mod in (fp, jax_fp):
        inj = mod.FaultInjector(mod.parse_faults(text), rank=rank)
        hits = []
        for epoch, step in ((0, 1), (0, 2), (0, 4), (1, 7), (1, 8), (1, 9)):
            try:
                inj.fire("ckpt_save", step=step, epoch=epoch)
            except OSError:
                hits.append(step)
            inj.fire("loader_next", batch=step)      # another point: no-op
        fired.append((hits, [s.fired for s in inj.specs]))
    assert fired[0] == fired[1]


@pytest.mark.parametrize("text,first_step,n", [
    ("nan:step=6", 3, 5), ("nan:step=3", 10, 4), ("nan", 1, 3),
    ("nan:step=20", 1, 5), ("nan:step=2,nan:step=4", 1, 6),
    ("nan:step=4:times=2", 1, 8),
])
def test_poison_array_is_bitwise_jax(text, first_step, n):
    rng = np.random.default_rng(n)
    values = rng.standard_normal(n).astype(np.float32)
    got = fp.FaultInjector(fp.parse_faults(text)).poison_array(
        "loss", values, first_step=first_step, epoch=0)
    want = jax_fp.FaultInjector(jax_fp.parse_faults(text)).poison_array(
        "loss", values, first_step=first_step, epoch=0)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(values).all()          # the caller's array untouched


def test_poison_scalar_first_crossing_and_fire_ignores_nan():
    inj = fp.FaultInjector(fp.parse_faults("nan:step=5"))
    assert inj.poison("loss", 1.0, step=4) == 1.0
    assert np.isnan(inj.poison("loss", 1.0, step=6))
    assert inj.poison("loss", 1.0, step=7) == 1.0       # fired once
    inj = fp.FaultInjector(fp.parse_faults("nan:step=1"))
    inj.fire("loss", step=3)                            # fire never acts
    assert inj.specs[0].fired == 0


def test_env_and_flag_merge_and_the_fast_path(monkeypatch):
    assert not fp.active()
    fp.fire("step", step=1)
    assert fp.poison("loss", 2.0, step=1) == 2.0
    monkeypatch.setenv(fp.FAULT_ENV, "loader_stall:delay_s=0")
    inj = fp.install("ckpt_save_io:step=2", rank=3)
    assert [s.kind for s in inj.specs] == ["loader_stall", "ckpt_save_io"]
    assert inj.rank == 3 and fp.active()
    fp.set_rank(5)
    assert fp.get_injector().rank == 5


def test_every_fired_fault_is_in_the_flight_recorder():
    inj = fp.FaultInjector(fp.parse_faults("loader_stall:delay_s=0"), rank=3)
    inj.fire("loader_next", batch=7)
    entry = get_flight_recorder().snapshot()[-1]
    assert entry["kind"] == "fault_injected"
    assert (entry["fault"], entry["point"], entry["rank"], entry["batch"]) == (
        "loader_stall", "loader_next", 3, 7)


def test_kill_dumps_the_flight_recorder_then_sigkills(tmp_path):
    code = ("from pytorch_ddp_mnist_tpu_torch.utils import faultpoints as f\n"
            "for s in range(1, 6):\n"
            "    f.fire('step', step=s, epoch=0)\n"
            "    print('after', s, flush=True)\n")
    env = {**os.environ, "PDMT_FAULT": "kill:step=3",
           "PDMT_FLIGHT_DIR": str(tmp_path),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == -9
    assert r.stdout.split() == ["after", "1", "after", "2"]
    (dump,) = [p for p in tmp_path.iterdir() if p.name.startswith("flight.")]
    blob = json.loads(dump.read_text())
    assert blob["reason"] == "injected fault: kill:step=3"
    assert blob["entries"][-1]["kind"] == "fault_injected"
    assert blob["entries"][-1]["step"] == 3


def test_the_loaders_fire_loader_next():
    from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
    from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
    from pytorch_ddp_mnist_tpu_torch.pipeline import SyntheticSource, host_iter
    fp.install("loader_stall:batch=1:delay_s=0.2:times=3")
    loader = BatchLoader(np.zeros((64, 784), np.float32),
                         np.zeros(64, np.int64), ShardedSampler(64),
                         batch_size=16)
    for source, workers in ((loader, 0), (SyntheticSource(4, 16), 2),
                            (SyntheticSource(4, 16), 0)):
        t0 = time.perf_counter()
        n = sum(1 for _ in host_iter(source, workers=workers))
        assert n == 4 and time.perf_counter() - t0 >= 0.2
    assert fp.get_injector().specs[0].fired == 3


def test_barrier_fires_collective_timeout_that_triage_takes_for_a_loss():
    fp.install("collective_timeout:epoch=1")
    rt = wireup.Runtime(method="single")
    rt.barrier()                       # no epoch in the context: no match
    rt.barrier(epoch=0)
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED") as e:
        rt.barrier(epoch=1)
    assert wireup.looks_like_backend_loss(e.value)
    assert jax_wireup.looks_like_backend_loss(e.value)
    rt.barrier(epoch=1)                # fired once


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_backoff_schedule_is_the_jax_one(seed):
    got, want = (m.backoff_schedule(0.5, 8.0, seed=seed)
                 for m in (wireup, jax_wireup))
    assert [next(got) for _ in range(8)] == [next(want) for _ in range(8)]
    with pytest.raises(ValueError):
        next(wireup.backoff_schedule(2.0, 1.0))


@pytest.mark.parametrize("raw", [None, "", "12", "1.5", "abc", "-3", "inf"])
def test_env_seconds_parses_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("PDMT_BACKEND_WAIT", raising=False)
    else:
        monkeypatch.setenv("PDMT_BACKEND_WAIT", raw)
    assert wireup.backend_wait_env(7.0) == jax_wireup.backend_wait_env(7.0)


@pytest.mark.parametrize("msg,loss,sticky", [
    ("UNAVAILABLE: socket closed", True, False),
    ("DEADLINE_EXCEEDED: injected fault", True, False),
    ("Mismatched shapes (simulated program bug)", False, False),
    ("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed "
     "by peer [127.0.0.1]:1234", True, False),
    ("read: Connection reset by peer", True, False),
    ("NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled system error, "
     "NCCL version 2.21.5", True, False),
    ("[Rank 1] Watchdog caught collective operation timeout: "
     "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 600000 ms", True, False),
    ("CUDA error: an illegal memory access was encountered", True, True),
    ("CUDA error: unspecified launch failure", True, True),
    ("mat1 and mat2 shapes cannot be multiplied (8x28 and 784x128)", False,
     False),
])
def test_backend_loss_triage(msg, loss, sticky):
    e = RuntimeError(msg)
    assert wireup.looks_like_backend_loss(e) is loss
    assert wireup.is_sticky_cuda_error(e) is sticky
    if not loss:   # what JAX calls a program error, the port does too
        assert not jax_wireup.looks_like_backend_loss(e)


def test_wait_for_backend_on_the_cpu_through_a_flaky_probe(monkeypatch):
    assert wireup.wait_for_backend(5.0, device_type="cpu") == 1
    calls = {"n": 0}

    def flaky(timeout_s, device_type="cuda"):
        calls["n"] += 1
        if calls["n"] < 3:
            return "error", RuntimeError("UNAVAILABLE: card lost")
        return "ok", 1

    monkeypatch.setattr(wireup, "_probe_devices_bounded", flaky)
    monkeypatch.setattr(wireup.time, "sleep", lambda s: None)
    assert wireup.wait_for_backend(60.0, poll_s=0.01) == 1
    assert calls["n"] == 3
    with pytest.raises(wireup.BackendUnavailableError):
        calls["n"] = -10**6
        wireup.wait_for_backend(0.0, poll_s=0.01)


def test_a_poisoned_context_is_wedged_when_a_fresh_process_answers(
        monkeypatch):
    monkeypatch.setattr(
        wireup, "_probe_devices_bounded", lambda t, d="cuda": (
            "error", RuntimeError("CUDA error: an illegal memory access was "
                                  "encountered")))
    monkeypatch.setattr(wireup, "_subprocess_backend_healthy",
                        lambda t, d="cuda": True)
    with pytest.raises(wireup.BackendWedgedError, match="poisoned"):
        wireup.wait_for_backend(60.0)
    assert wireup._subprocess_backend_healthy(60.0, "cpu")
