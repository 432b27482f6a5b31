"""The training-health watchdog and the live metrics endpoint in the port
(`--health`, `--metrics_port`; telemetry/health.py, telemetry/prom.py),
held against the JAX package on the CPU:

  * the watchdog's detectors: the port's and the JAX `Watchdog`, fed the
    same seeded observations, fire the same events (detector, severity,
    value, threshold, message, epoch, step), leave the same `health.*`
    metrics and the same `health_summary`; the policies: `abort` raises
    the same TrainingHealthError, which is not a RuntimeError, and
    `checkpoint-and-warn` hands the last good state (params, key,
    positions) to its hook, never the poisoned one;
  * `device_health_aux` against JAX's within f32 rounding (rtol 1e-6),
    and the plain step built with `health=True` against JAX's health step
    (aux within rtol 1e-5), its loss and update bitwise the port's plain
    step;
  * the Prometheus text of the same registry content, byte for byte the
    JAX module's; `/metrics`, `/healthz` (200, then 503 after a fatal
    event) and a 404;
  * the trainers: a `nan:step=K` fault emits the fatal `nan` event into
    the trace; the cached trainer's chunk-granular rescue keeps the
    pre-NaN chunk boundary (the JAX test's positions); the CLI's round
    trip (a live `/metrics` scrape, `/healthz` 503 after the event, the
    fatal event in a trace `scripts/check_telemetry.py --require
    health.,mem.,checkpoint.` accepts, an intact pinned pre-NaN
    checkpoint), `--health abort` exiting with `[health] …`, and the JAX
    CLI's refusals of `--health`, word for word.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import select
import subprocess
import sys
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu import telemetry as jtel
from pytorch_ddp_mnist_tpu.cli import train as jax_cli
from pytorch_ddp_mnist_tpu.data.idx import write_idx
from pytorch_ddp_mnist_tpu.models import init_mlp
from pytorch_ddp_mnist_tpu.telemetry import health as jax_health
from pytorch_ddp_mnist_tpu.telemetry import prom as jax_prom
from pytorch_ddp_mnist_tpu.train import loop as jax_loop
from pytorch_ddp_mnist_tpu.train.loop import TrainState as JaxState
from pytorch_ddp_mnist_tpu_torch import telemetry
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import (normalize_images,
                                                    synthetic_mnist)
from pytorch_ddp_mnist_tpu_torch.models.mlp import MLP, from_jax_params
from pytorch_ddp_mnist_tpu_torch.ops.threefry import key_data
from pytorch_ddp_mnist_tpu_torch.parallel.sampler import ShardedSampler
from pytorch_ddp_mnist_tpu_torch.telemetry import health, prom
from pytorch_ddp_mnist_tpu_torch.train import loop, scan
from pytorch_ddp_mnist_tpu_torch.train.checkpoint import params_from_bytes
from pytorch_ddp_mnist_tpu_torch.train.config import configure
from pytorch_ddp_mnist_tpu_torch.train.loop import TrainState
from pytorch_ddp_mnist_tpu_torch.utils import faultpoints

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "check_telemetry", REPO / "scripts" / "check_telemetry.py")
_checker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_checker)
check_main = _checker.main
NAN = float("nan")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv(faultpoints.FAULT_ENV, raising=False)
    faultpoints.install()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    faultpoints.install()
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for prefix, n, seed in (("train", 256, 4), ("t10k", 64, 5)):
        split = synthetic_mnist(n, seed)
        write_idx(str(root / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(root / f"{prefix}-labels-idx1-ubyte"), split.labels)
    return str(root)


# -- the detectors against the JAX watchdog -----------------------------------

def _scenario(name, rng):
    """(config kwargs, [(losses, aux, dt_s, imgs)]) of one seeded run."""
    def healthy(n=4, gn=2.0, pn=100.0, dt=1.0):
        out = []
        for _ in range(n):
            losses = 1.0 + 0.05 * rng.standard_normal(8)
            aux = np.stack([gn * (1 + 0.1 * rng.random(8)), np.ones(8),
                            np.full(8, pn)], 1)
            out.append((losses, aux, dt * (1 + 0.01 * rng.random()), 512))
        return out

    obs = healthy()
    cfg = {}
    if name == "nan":
        losses = 1.0 + rng.random(8)
        losses[3] = NAN
        obs.append((losses, None, 1.0, 512))
    elif name == "inf":
        obs.append((np.array([1.0, np.inf]), None, 1.0, 128))
    elif name == "aux_finite":
        aux = np.tile([2.0, 0.0, 100.0], (8, 1))
        obs.append((np.full(8, 1.0), aux, 1.0, 512))
    elif name == "loss_spike":
        obs.append((np.full(8, 10.0), None, 1.0, 512))
    elif name == "grad_norm":
        obs.append((np.full(8, 1.0), np.tile([50.0, 1.0, 100.0], (8, 1)),
                    1.0, 512))
    elif name == "update_ratio":
        obs = [(np.full(4, 1.0), np.tile([60.0, 1.0, 10.0], (4, 1)), 1.0,
                256)]
    elif name == "throughput":
        obs.append((np.full(8, 1.0), None, 20.0, 512))
    elif name == "straggler":
        cfg = {"straggler_skew_pct": 50.0}
        obs += healthy(3) + [(np.full(8, 1.0), None, 3.0, 512)]
    elif name == "mixed":
        obs += healthy(6)
        for _ in range(6):
            losses = np.abs(rng.standard_normal(8)) * rng.choice([1, 8])
            obs.append((losses, None, rng.choice([1.0, 9.0]), 512))
    return cfg, obs


def _feed(wd, obs):
    fired = []
    for i, (losses, aux, dt, imgs) in enumerate(obs):
        fired += [vars(e) for e in wd.observe(
            losses, aux=aux, epoch=i, step=(i + 1) * len(losses), dt_s=dt,
            imgs=imgs)]
    return fired


@pytest.mark.parametrize("name", ["healthy", "nan", "inf", "aux_finite",
                                  "loss_spike", "grad_norm", "update_ratio",
                                  "throughput", "straggler", "mixed"])
def test_the_detectors_fire_as_the_jax_watchdogs(name):
    cfg, obs = _scenario(name, np.random.default_rng(7))
    jreg, preg = jtel.MetricsRegistry(), telemetry.MetricsRegistry()
    jwd = jax_health.Watchdog(jax_health.HealthConfig(**cfg), registry=jreg,
                              lr=0.1, log=lambda m: None)
    pwd = health.Watchdog(health.HealthConfig(**cfg), registry=preg, lr=0.1,
                          log=lambda m: None)
    want, got = _feed(jwd, obs), _feed(pwd, obs)
    assert got == want
    if name != "healthy":
        assert got, name
    js, ps = jreg.snapshot(), preg.snapshot()
    for table in ("counters", "gauges"):
        assert ps[table] == js[table]
    assert health.health_summary(preg) == jax_health.health_summary(jreg)


def test_abort_raises_the_jax_error_which_is_no_runtime_error():
    jwd = jax_health.Watchdog(jax_health.HealthConfig(policy="abort"),
                              registry=jtel.MetricsRegistry(),
                              log=lambda m: None)
    pwd = health.Watchdog(health.HealthConfig(policy="abort"),
                          registry=telemetry.MetricsRegistry(),
                          log=lambda m: None)
    errors = []
    for wd, err in ((jwd, jax_health.TrainingHealthError),
                    (pwd, health.TrainingHealthError)):
        with pytest.raises(err) as e:
            wd.observe(np.array([NAN]), epoch=2, step=17)
        errors.append(str(e.value))
        assert [ev.detector for ev in wd.events] == ["nan"]
    assert errors[0] == errors[1]
    assert not issubclass(health.TrainingHealthError, RuntimeError)
    with pytest.raises(ValueError, match="policy"):
        health.HealthConfig(policy="panic")


def _state(seed):
    return TrainState(MLP.from_seed(seed), key_data(seed + 1))


def test_checkpoint_and_warn_rescues_the_last_good_state():
    saved = []
    wd = health.Watchdog(health.HealthConfig(policy="checkpoint-and-warn"),
                         registry=telemetry.MetricsRegistry(),
                         on_fatal=saved.append, log=lambda m: None)
    wd.seed_good(_state(0), epoch=0, offset=0, step=0)
    good = _state(1)
    wd.observe(np.full(4, 1.0), state=good, epoch=0, step=4, ckpt_epoch=0,
               ckpt_offset=4)
    want = {n: {k: v.clone() for k, v in layer.items()}
            for n, layer in good.model.params().items()}
    with torch.no_grad():       # the live model moves on after the stash
        good.model.params()["fc1"]["w"].fill_(NAN)
    wd.observe(np.array([NAN]), state=good, epoch=0, step=8)
    (stash,) = saved
    assert (stash["step"], stash["epoch"], stash["offset"]) == (4, 0, 4)
    assert list(stash["key"]) == list(good.key) and stash["resid"] is None
    for n, layer in want.items():
        for k, v in layer.items():
            assert torch.equal(stash["params"][n][k], v)


def test_the_rescue_positions_are_the_jax_watchdogs():
    saved = {"jax": [], "port": []}
    jwd = jax_health.Watchdog(
        jax_health.HealthConfig(policy="checkpoint-and-warn"),
        registry=jtel.MetricsRegistry(), on_fatal=saved["jax"].append,
        log=lambda m: None)
    pwd = health.Watchdog(health.HealthConfig(policy="checkpoint-and-warn"),
                          registry=telemetry.MetricsRegistry(),
                          on_fatal=saved["port"].append, log=lambda m: None)
    jstate = JaxState({"w": np.ones(2, np.float32)}, jax.random.key(1))
    for wd, st in ((jwd, jstate), (pwd, _state(0))):
        wd.seed_good(st, epoch=1, offset=3, step=11)
        wd.observe(np.array([NAN]), epoch=1, step=16)       # the seed
        wd.observe(np.full(4, 1.0), state=st, epoch=1, step=20)
        wd.observe(np.array([NAN]), epoch=1, step=24)       # epoch + 1
    assert [(s["step"], s["epoch"], s["offset"]) for s in saved["port"]] \
        == [(s["step"], s["epoch"], s["offset"]) for s in saved["jax"]] \
        == [(11, 1, 3), (20, 2, 0)]


def test_a_failed_rescue_never_raises_and_no_hook_no_stash():
    def explode(_stash):
        raise OSError("disk died")
    wd = health.Watchdog(health.HealthConfig(policy="checkpoint-and-warn"),
                         registry=telemetry.MetricsRegistry(),
                         on_fatal=explode, log=lambda m: None)
    wd.seed_good(_state(0), epoch=0, offset=0, step=0)
    wd.observe(np.array([NAN]), epoch=0, step=1)
    bare = health.Watchdog(health.HealthConfig(policy="checkpoint-and-warn"),
                           registry=telemetry.MetricsRegistry(),
                           log=lambda m: None)
    bare.observe(np.full(4, 1.0), state=_state(0), epoch=0, step=4)
    assert bare._last_good is None


# -- the device-side aux ------------------------------------------------------

def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"fc1": {"w": (784, 128), "b": (128,)},
              "fc2": {"w": (128, 128), "b": (128,)}, "fc3": {"w": (128, 10)}}
    return [{n: {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in layer.items()} for n, layer in shapes.items()}
            for _ in range(2)]


@pytest.mark.parametrize("poison", [None, "loss", "grad"])
def test_device_health_aux_is_the_jax_fragments(poison):
    grads, params = _trees(3)
    loss = np.float32(NAN if poison == "loss" else 2.5)
    if poison == "grad":
        grads["fc2"]["b"][5] = np.inf
    want = np.asarray(jax_health.device_health_aux(
        jnp.float32(loss), jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, params)))
    got = health.device_health_aux(
        torch.tensor(loss), {n: {k: torch.from_numpy(v) for k, v in
                                 layer.items()} for n, layer in grads.items()},
        {n: {k: torch.from_numpy(v) for k, v in layer.items()}
         for n, layer in params.items()}).numpy()
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == (0.0 if poison else 1.0)


def test_the_health_step_is_the_plain_step_plus_jax_aux():
    rng = np.random.default_rng(0)
    x = rng.random((16, 784)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    jparams = init_mlp(jax.random.key(0))
    _, _, jloss, jaux = jax_loop.make_train_step(0.1, health=True)(
        jparams, jax.random.key(1), x, y)
    plain_m = from_jax_params(init_mlp(jax.random.key(0)))
    health_m = from_jax_params(init_mlp(jax.random.key(0)))
    plain, hstep = loop.make_train_step(0.1), loop.make_train_step(
        0.1, health=True)
    assert not getattr(plain, "health_aux") and hstep.health_aux
    key_p = key_h = key_data(1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(3):
        key_p, lp = plain(plain_m, key_p, xt, yt)
        key_h, (lh, aux) = hstep(health_m, key_h, xt, yt)
        assert key_p == key_h and torch.equal(lp, lh)
        if i == 0:
            np.testing.assert_allclose(float(lh), float(jloss), rtol=1e-5)
            np.testing.assert_allclose(aux.numpy(), np.asarray(jaux),
                                       rtol=1e-5)
    for a, b in zip(plain_m.parameters(), health_m.parameters()):
        assert torch.equal(a, b)


# -- Prometheus ---------------------------------------------------------------

def test_metric_names_and_the_text_are_the_jax_modules():
    for name in ("serve.latency_s", "health.worst_severity_level", "a-b c",
                 "9lives", "mem.device_peak_bytes"):
        assert prom.metric_name(name) == jax_prom.metric_name(name)
    regs = (jtel.MetricsRegistry(), telemetry.MetricsRegistry())
    rng = np.random.default_rng(11)
    values = rng.random(50) * 0.01
    for reg in regs:
        reg.counter("train.steps").inc(42)
        reg.gauge("queue.depth").set(3)
        reg.gauge("dead.provider").set_fn(lambda: None)
        reg.gauge("ratio").set(0.125)
        for v in values:
            reg.histogram("lat_s").record(float(v))
    want = jax_prom.render_prometheus(regs[0])
    assert prom.render_prometheus(regs[1]) == want
    assert "dead_provider" not in want and want.endswith("\n")


def test_the_endpoint_serves_metrics_and_flips_healthz():
    reg = telemetry.MetricsRegistry()
    wd = health.Watchdog(health.HealthConfig(), registry=reg,
                         log=lambda m: None)
    reg.counter("train.steps").inc(7)
    srv = prom.start_metrics_server(0, registry=reg)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        resp = urllib.request.urlopen(base + "/metrics", timeout=10)
        assert resp.headers["Content-Type"].startswith("text/plain")
        body = resp.read().decode()
        assert "train_steps 7" in body
        assert "health_worst_severity_level 0" in body
        hz = urllib.request.urlopen(base + "/healthz", timeout=10)
        assert json.loads(hz.read()) == {"fired": {}, "worst_severity": "ok"}
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert e404.value.code == 404
        wd.observe(np.array([NAN]), epoch=0, step=1)
        with pytest.raises(urllib.error.HTTPError) as e503:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert e503.value.code == 503
    finally:
        srv.shutdown()
        srv.server_close()


# -- the trainers -------------------------------------------------------------

def _wd(policy="warn", **kw):
    return health.Watchdog(health.HealthConfig(policy=policy),
                           registry=telemetry.MetricsRegistry(),
                           log=lambda m: None, **kw)


def test_fit_emits_the_fatal_nan_event(tmp_path):
    train, test = synthetic_mnist(128, seed=0), synthetic_mnist(32, seed=1)
    from pytorch_ddp_mnist_tpu_torch.data.loader import BatchLoader
    ld = BatchLoader(normalize_images(train.images), train.labels,
                     ShardedSampler(128, num_replicas=1, rank=0, seed=42),
                     batch_size=32)
    faultpoints.install("nan:step=2")
    wd = _wd()
    telemetry.enable(str(tmp_path))
    try:
        loop.fit(_state(0), ld, normalize_images(test.images),
                 test.labels.astype(np.int32), epochs=2, batch_size=32,
                 lr=0.1, watchdog=wd, log=lambda m: None)
    finally:
        telemetry.disable()
    nans = [e for e in wd.events if e.detector == "nan"]
    assert nans and (nans[0].severity, nans[0].epoch, nans[0].step) == (
        "fatal", 0, 4)
    points = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    points = [p for p in points if p["kind"] == "point"
              and p["name"] == "health"]
    assert [p["attrs"]["detector"] for p in points] == ["nan"]


def test_fit_cached_rescues_the_pre_nan_chunk_boundary():
    """As the JAX test: a NaN in chunk 2 (steps 5..8) rescues the state at
    the chunk-1 boundary, step 4, position (0, 4), finite."""
    faultpoints.install("nan:step=6")
    saved = []
    wd = _wd("checkpoint-and-warn", on_fatal=saved.append)
    train, test = synthetic_mnist(512, seed=0), synthetic_mnist(64, seed=1)
    state = _state(0)
    wd.seed_good(state, epoch=0, offset=0, step=0)
    scan.fit_cached(state.model, state.key, train.images, train.labels,
                    ShardedSampler(512, num_replicas=1, rank=0, seed=42),
                    normalize_images(test.images),
                    test.labels.astype(np.int32), epochs=1, batch_size=64,
                    lr=0.1, ckpt_every_steps=4, watchdog=wd,
                    log=lambda m: None)
    (stash,) = saved
    assert (stash["step"], stash["epoch"], stash["offset"]) == (4, 0, 4)
    assert all(torch.isfinite(v).all() for layer in stash["params"].values()
               for v in layer.values())
    assert [e.step for e in wd.events if e.detector == "nan"][0] == 8


def _cli_base(mnist, *extra):
    return ["--device", "cpu", "--limit", "256", "--batch_size", "32",
            "--lr", "0.1", "--path", mnist, *extra]


def test_the_cli_rescue_keeps_an_intact_pinned_pre_nan_checkpoint(
        tmp_path, mnist):
    ck, tel = tmp_path / "m.msgpack", tmp_path / "tel"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_cli.train(_cli_base(
            mnist, "--cached", "--n_epochs", "2", "--checkpoint", str(ck),
            "--ckpt_every_steps", "3", "--health", "checkpoint-and-warn",
            "--fault", "nan:step=5", "--telemetry", str(tel)))
    assert check_main(["--require", "health.,mem.,checkpoint.",
                       str(tel)]) == 0
    steps = tmp_path / "m.msgpack.steps"
    mans = [json.loads(p.read_text()) for p in sorted(steps.glob("*.json"))]
    rescue = [m for m in mans if m.get("pinned")]
    assert [m["step"] for m in rescue] == [3]          # before step 5
    blob = (steps / rescue[0]["payload"]).read_bytes()
    assert zlib.crc32(blob) == rescue[0]["crc32"]
    params = params_from_bytes(blob)
    assert all(torch.isfinite(v).all() for layer in params.values()
               for v in layer.values())


def test_health_abort_exits_by_name(tmp_path, mnist):
    with pytest.raises(SystemExit) as e:
        port_cli.train(_cli_base(mnist, "--checkpoint", "", "--health",
                                 "abort", "--fault", "nan:step=3",
                                 "--telemetry", str(tmp_path / "t")))
    assert str(e.value.code).startswith(
        "[health] fatal health signal (nan at epoch 0 step 8: non-finite "
        "training signal: 1/8 non-finite per-step losses) under --health "
        "abort")
    assert any(n.startswith("flight.") for n in os.listdir(tmp_path / "t"))


def test_the_live_endpoint_answers_while_training(tmp_path, mnist):
    """The round trip of scripts/health_smoke.py in a subprocess: /metrics
    scraped while it trains, /healthz 503 after the fatal event (a loader
    stall in epoch 1 keeps the process alive past it)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", faultpoints.FAULT_ENV)}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_ddp_mnist_tpu_torch", "train",
         *_cli_base(mnist, "--n_epochs", "2", "--checkpoint", "",
                    "--health", "warn", "--metrics_port", "0", "--fault",
                    "nan:step=3,loader_stall:batch=2:delay_s=1.5:times=2")],
        cwd=tmp_path, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    url, statuses, body = None, [], ""
    deadline = time.monotonic() + 90
    try:
        while url is None and time.monotonic() < deadline:
            if select.select([proc.stderr], [], [], 1.0)[0]:
                line = proc.stderr.readline()
                if not line:
                    break
                if line.startswith("metrics on "):
                    url = line.split("metrics on ", 1)[1].strip()
        assert url, "no metrics endpoint announced"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                statuses.append(urllib.request.urlopen(
                    url.replace("/metrics", "/healthz"), timeout=5).status)
            except urllib.error.HTTPError as e:
                statuses.append(e.code)
            except OSError:
                break
            if statuses[-1] == 503:
                break
            time.sleep(0.02)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert "# TYPE" in body and "health_worst_severity_level" in body
    assert 503 in statuses


@pytest.mark.parametrize("argv", [
    ["--health", "warn", "--cached", "--fused"],
    ["--health", "checkpoint-and-warn", "--checkpoint", ""],
])
def test_the_health_refusals_are_the_jax_clis_word_for_word(argv, tmp_path,
                                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as port_exit:
        configure(argv)
    assert str(port_exit.value.code) == str(jax_exit.value.code)
