"""The port's hot reload (pytorch_ddp_mnist_tpu_torch/serve/reload.py) and
the serve CLI's fleet front door against the JAX package's, on the CPU.

  * A reload under traffic swaps every replica behind a drain: every
    in-flight request answered, `outstanding_at_swap == 0` on every
    `swapped` point of the trace, every replica on generation 1, and the
    preds after it the new params' direct engine's (and the JAX engine's).
  * Torn and NaN steps, and the `reload_torn` fault point, refused by name
    with the incumbent serving; a refused step never re-polled.
  * The JAX and the port `ReloadWatcher` give the same verdict sequence
    and serving steps over the same directory sequence (written by the
    JAX `CheckpointManager`: a JAX-written step directory promotes into
    the port's fleet), and a directory the port wrote promotes into the
    JAX fleet.
  * `run()` picks a commit up on its own timer.
  * The CLI: `serve --replicas 2 --reload_dir DIR` over TCP reloads a
    committed step; the validation messages are the JAX CLI's word for
    word.
"""

import asyncio
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu.cli import serve as jax_serve_cli
from pytorch_ddp_mnist_tpu.models.mlp import init_mlp
from pytorch_ddp_mnist_tpu.serve import FleetService as JaxFleet
from pytorch_ddp_mnist_tpu.serve import InferenceEngine as JaxEngine
from pytorch_ddp_mnist_tpu.serve import ReloadWatcher as JaxWatcher
from pytorch_ddp_mnist_tpu.telemetry.registry import \
    MetricsRegistry as JaxRegistry
from pytorch_ddp_mnist_tpu.train.ckpt_manager import \
    CheckpointManager as JaxManager
from pytorch_ddp_mnist_tpu.utils import faultpoints as jax_faultpoints
from pytorch_ddp_mnist_tpu_torch import telemetry
from pytorch_ddp_mnist_tpu_torch.cli import serve as serve_cli
from pytorch_ddp_mnist_tpu_torch.models.mlp import from_jax_params
from pytorch_ddp_mnist_tpu_torch.serve import (FleetService, InferenceEngine,
                                               ReloadWatcher)
from pytorch_ddp_mnist_tpu_torch.serve.loadgen import request_rows
from pytorch_ddp_mnist_tpu_torch.telemetry import MetricsRegistry
from pytorch_ddp_mnist_tpu_torch.train.ckpt_manager import CheckpointManager
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MAX_BATCH = 8
KEY = np.zeros(2, np.uint32)


@pytest.fixture(scope="module")
def jax_params():
    return init_mlp(jax.random.key(0))


@pytest.fixture(scope="module")
def jax_params_b():
    return init_mlp(jax.random.key(1))


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree)).params()


@pytest.fixture(scope="module")
def params(jax_params):
    return _port(jax_params)


@pytest.fixture(scope="module")
def params_b(jax_params_b):
    return _port(jax_params_b)


@pytest.fixture(scope="module")
def rows():
    return request_rows(32, "float32", seed=1)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faultpoints.install("")
    jax_faultpoints.install("")


def _fleet(params, **kw):
    return FleetService(
        lambda p: InferenceEngine(p, max_batch=MAX_BATCH, device=CPU),
        params, n_replicas=2, max_batch=MAX_BATCH, max_delay_ms=1.0,
        registry=MetricsRegistry(), **kw)


def _direct(params, rows):
    eng = InferenceEngine(params, max_batch=MAX_BATCH, device=CPU)
    out = [int(eng.predict(np.stack([r]))[0]) for r in rows]
    eng.close()
    return out


def _nan_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.full_like(a, jnp.nan), tree)


def _truncate(directory, step, n=8):
    payload = glob.glob(os.path.join(directory, f"*{step}.msgpack"))[0]
    with open(payload, "r+b") as f:
        f.truncate(n)


# ---- the swap ----

def test_a_reload_swaps_every_replica_with_nothing_outstanding(
        params, params_b, jax_params_b, rows, tmp_path):
    want = _direct(params_b, rows)
    jeng = JaxEngine(jax_params_b, max_batch=MAX_BATCH)
    assert want == [int(jeng.predict(np.stack([r]))[0]) for r in rows]
    jeng.close()
    ckpts, tel = tmp_path / "ckpts", tmp_path / "tel"
    CheckpointManager(str(ckpts)).save(params_b, KEY, "threefry2x32",
                                       step=7, epoch=0, offset=0)
    fleet = _fleet(params, serving_step=0)
    watcher = ReloadWatcher(fleet, str(ckpts))

    async def scenario():
        burst = [asyncio.ensure_future(fleet.handle(r)) for r in rows]
        verdict = await watcher.poll_once()
        first = await asyncio.gather(*burst)
        after = await asyncio.gather(*[fleet.handle(r) for r in rows])
        snap = fleet.fleet_snapshot()
        await watcher.stop()
        await fleet.shutdown()
        return verdict, first, after, snap

    telemetry.enable(str(tel))
    try:
        verdict, first, after, snap = asyncio.run(scenario())
    finally:
        telemetry.disable()
    assert verdict == "reloaded" and watcher.reloads == 1
    assert fleet.serving_step == 7 and snap["generation"] == 1
    assert list(after) == want
    assert all(isinstance(g, int) for g in first)
    assert all(rep.generation == 1 for rep in fleet.replicas)
    points = [json.loads(line) for line in open(tel / "events.jsonl")]
    swaps = [p["attrs"] for p in points if p.get("name") == "reload_event"
             and p["attrs"].get("event") == "swapped"]
    assert sorted(s["replica"] for s in swaps) == [0, 1]
    assert all(s["outstanding_at_swap"] == 0 for s in swaps)


def test_torn_and_nan_steps_are_refused_by_name(params, params_b, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    fleet = _fleet(params, serving_step=0)
    watcher = ReloadWatcher(fleet, str(tmp_path))
    mgr.save(params_b, KEY, "threefry2x32", step=3, epoch=0, offset=0)
    _truncate(str(tmp_path), 3)

    async def scenario():
        torn = await watcher.poll_once()
        idle = await watcher.poll_once()     # a refused step never re-polls
        p_nan = {n: {k: torch.full_like(v, float("nan"))
                     for k, v in layer.items()}
                 for n, layer in params_b.items()}
        mgr.save(p_nan, KEY, "threefry2x32", step=4, epoch=0, offset=0)
        nan = await watcher.poll_once()
        still = await fleet.handle(request_rows(1, "float32", seed=5)[0])
        await watcher.stop()
        await fleet.shutdown()
        return torn, idle, nan, still

    torn, idle, nan, still = asyncio.run(scenario())
    assert (torn, idle, nan) == ("refused", "idle", "refused")
    assert watcher.refused == 2 and watcher.reloads == 0
    assert fleet.serving_step == 0 and isinstance(still, int)


def test_the_reload_torn_fault_point_refuses_by_name(params, params_b,
                                                     tmp_path):
    CheckpointManager(str(tmp_path)).save(params_b, KEY, "threefry2x32",
                                          step=2, epoch=0, offset=0)
    fleet = _fleet(params, serving_step=0)
    watcher = ReloadWatcher(fleet, str(tmp_path))
    faultpoints.install("reload_torn:times=1")

    async def scenario():
        refused = await watcher.poll_once()
        again = await watcher.poll_once()
        await watcher.stop()
        await fleet.shutdown()
        return refused, again

    assert asyncio.run(scenario()) == ("refused", "idle")
    assert fleet.serving_step == 0 and watcher.refused == 1


# ---- the JAX watcher and the port's over one directory ----

def test_the_jax_and_port_watchers_agree_on_a_directory_sequence(
        jax_params, jax_params_b, params, tmp_path):
    d = str(tmp_path)
    mgr = JaxManager(d)
    ours = _fleet(params, serving_step=0)
    theirs = JaxFleet(lambda p: JaxEngine(p, max_batch=MAX_BATCH),
                      jax_params, n_replicas=2, max_batch=MAX_BATCH,
                      registry=JaxRegistry(), serving_step=0)
    watchers = (ReloadWatcher(ours, d), JaxWatcher(theirs, d))

    def save(p, step):
        mgr.save(p, KEY, "threefry2x32", step=step, epoch=0, offset=0)

    def arm(spec):
        faultpoints.install(spec)
        jax_faultpoints.install(spec)

    steps = [
        (lambda: save(jax_params_b, 1), ""),        # good: reloaded
        (lambda: save(jax_params_b, 2), "reload_torn"),   # refused
        (lambda: None, ""),                         # idle: never re-polled
        (lambda: (save(jax_params_b, 3), _truncate(d, 3, 16)), ""),
        (lambda: save(_nan_tree(jax_params_b), 4), ""),    # refused
        (lambda: save(jax_params_b, 5), ""),        # reloaded
    ]

    async def scenario():
        got = []
        for mutate, fault in steps:
            mutate()
            row = []
            for w in watchers:
                arm(fault)
                row.append((await w.poll_once(), w.fleet.serving_step))
            arm("")
            got.append(row)
        for w in watchers:
            await w.stop()
            await w.fleet.shutdown()
        return got

    got = asyncio.run(scenario())
    assert [a for a, _ in got] == [b for _, b in got]
    assert [v for (v, _), _ in got] == ["reloaded", "refused", "idle",
                                        "reloaded", "refused", "reloaded"]
    assert [s for (_, s), _ in got] == [1, 1, 1, 2, 2, 5]
    assert [w.reloads for w in watchers] == [3, 3]
    assert [w.refused for w in watchers] == [2, 2]
    # the JAX-written step 5 is what every port replica serves, exactly
    want = _port(jax_params_b)
    for rep in ours.replicas:
        assert rep.generation == 3
        for n, layer in want.items():
            for k, v in layer.items():
                assert torch.equal(rep.engine._params[n][k], v)


def test_a_port_written_directory_promotes_into_the_jax_fleet(
        jax_params, jax_params_b, params_b, tmp_path):
    CheckpointManager(str(tmp_path)).save(params_b, KEY, "threefry2x32",
                                          step=4, epoch=0, offset=0)
    fleet = JaxFleet(lambda p: JaxEngine(p, max_batch=MAX_BATCH), jax_params,
                     n_replicas=2, max_batch=MAX_BATCH,
                     registry=JaxRegistry(), serving_step=0)
    watcher = JaxWatcher(fleet, str(tmp_path))
    rows = request_rows(8, "float32", seed=10)

    async def scenario():
        verdict = await watcher.poll_once()
        got = await asyncio.gather(*[fleet.handle(r) for r in rows])
        await fleet.shutdown()
        return verdict, got

    verdict, got = asyncio.run(scenario())
    assert verdict == "reloaded" and fleet.serving_step == 4
    assert list(got) == _direct(params_b, rows)


def test_the_watcher_loop_picks_a_commit_up_on_its_timer(params, params_b,
                                                         tmp_path):
    fleet = _fleet(params, serving_step=0)
    watcher = ReloadWatcher(fleet, str(tmp_path), poll_interval_s=0.01)
    with pytest.raises(ValueError, match="poll_interval_s"):
        ReloadWatcher(fleet, str(tmp_path), poll_interval_s=0)

    async def scenario():
        watcher.start()
        await asyncio.sleep(0.03)
        CheckpointManager(str(tmp_path)).save(
            params_b, KEY, "threefry2x32", step=3, epoch=0, offset=0)
        deadline = time.monotonic() + 5
        # serving_step moves when the swap starts; the counter when every
        # replica has swapped
        while watcher.reloads != 1 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        await watcher.stop()
        await fleet.shutdown()

    asyncio.run(scenario())
    assert fleet.serving_step == 3 and watcher.reloads == 1


# ---- the CLI ----

def _ask(f, req):
    f.write(json.dumps(req) + "\n")
    f.flush()
    return json.loads(f.readline())


def test_serve_with_a_reload_dir_swaps_a_committed_step_over_tcp(
        params, params_b, tmp_path):
    row = request_rows(1, "float32", seed=12)[0]
    want0, want1 = _direct(params, [row])[0], _direct(params_b, [row])[0]
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("PDMT_FAULT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "serve",
         "--device", "cpu", "--port", "0", "--replicas", "2",
         "--max_batch", "8", "--wedge_timeout_ms", "250", "--retry_budget",
         "2", "--reload_dir", str(tmp_path)], cwd=str(tmp_path), env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        err = []
        for line in proc.stderr:
            err.append(line)
            if line.startswith("serving on "):
                host, port = line.split()[-1].rsplit(":", 1)
                break
        with socket.create_connection((host, int(port)), timeout=30) as s, \
                s.makefile("rw") as f:
            before = _ask(f, {"pixels": row.tolist()})
            h0 = _ask(f, {"op": "health"})["health"]["fleet"]
            CheckpointManager(str(tmp_path)).save(
                params_b, KEY, "threefry2x32", step=1, epoch=0, offset=0)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                h1 = _ask(f, {"op": "health"})["health"]["fleet"]
                if all(r["generation"] == 1 for r in h1["per_replica"]):
                    break
                time.sleep(0.02)
            after = _ask(f, {"pixels": row.tolist()})
        os.killpg(proc.pid, signal.SIGTERM)
        out, rest = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert (before["pred"], after["pred"]) == (want0, want1)
    assert (h0["replicas"], h0["serving_step"]) == (2, -1)
    assert (h1["serving_step"], h1["generation"], h1["healthy"]) == (1, 1, 2)
    assert proc.returncode == 0
    assert "reload watcher: polling" in "".join(err)


@pytest.mark.parametrize("argv", [
    ["--replicas", "0"],
    ["--wedge_timeout_ms", "0"],
    ["--retry_budget", "-1"],
    ["--reload_dir", "ckpts", "--selftest", "1"],
])
def test_the_cli_validation_messages_are_the_jax_clis(argv, capsys):
    msgs = []
    for main in (serve_cli.main, jax_serve_cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    assert msgs[0] == msgs[1]
