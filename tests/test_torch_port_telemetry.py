"""The trainer's in-run telemetry in the port (`--telemetry DIR`,
`--profile_dispatch`, `--profile`; telemetry/runtime.py, dispatch.py,
utils/profiling.py), held against the JAX package on the CPU:

  * the runtime collectors keep the JAX names: the `mem.*` watermark
    gauges, the `mem_watermark` point, `collect_memory`'s gauges, and the
    capture counter under `xla.compiles` / `xla.compile_s`, one target a
    process;
  * the trainer's trace has the JAX trainer's record kinds, span names,
    span attributes and snapshot metric names for the same run, passes
    `scripts/check_telemetry.py` unchanged, and ends in the registry
    snapshot; the `[telemetry]` line has the JAX line's fields, and its
    `xla_compiles` counts the run's captures, not the process's;
  * the dispatch profiler's records pass the JAX read side's contract,
    and its phases, the window and the drains (one every K steps, never
    another fetch) follow the JAX profiler's; the chaos world leg's
    telemetry gate (chaos.py `telemetry_gate`) refuses a trace the JAX
    checker refuses;
  * `--telemetry --health warn --metrics_port 0 --profile_dispatch K`
    leaves every per-step loss, the parameters and the checkpoint bytes
    of the streaming and the cached run bitwise as they are without;
  * the refusals of `--profile_dispatch` and `--metrics_port` are the JAX
    CLI's, word for word;
  * `$PDMT_BACKEND_WAIT` at a serial run's start: a backend stubbed down,
    then up, is waited for from fresh processes and the run trains; one
    that stays down exits with the JAX CLI's message.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from pytorch_ddp_mnist_tpu import telemetry as jtel
from pytorch_ddp_mnist_tpu.data.idx import write_idx
from pytorch_ddp_mnist_tpu.cli import train as jax_cli
from pytorch_ddp_mnist_tpu.telemetry import analysis as jax_analysis
from pytorch_ddp_mnist_tpu.telemetry import runtime as jax_runtime
from pytorch_ddp_mnist_tpu_torch import chaos, telemetry
from pytorch_ddp_mnist_tpu_torch.cli import train as port_cli
from pytorch_ddp_mnist_tpu_torch.data.mnist import synthetic_mnist
from pytorch_ddp_mnist_tpu_torch.parallel import wireup
from pytorch_ddp_mnist_tpu_torch.telemetry import dispatch, runtime
from pytorch_ddp_mnist_tpu_torch.train import loop as port_loop
from pytorch_ddp_mnist_tpu_torch.train.config import configure
from pytorch_ddp_mnist_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "check_telemetry", REPO / "scripts" / "check_telemetry.py")
_checker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_checker)
check_main = _checker.main

FLAGS = ["--health", "warn", "--metrics_port", "0", "--profile_dispatch",
         "2"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """IDX files of 256 train and 64 test rows (synthetic), which both
    trainers read."""
    root = tmp_path_factory.mktemp("idx")
    for prefix, n, seed in (("train", 256, 4), ("t10k", 64, 5)):
        split = synthetic_mnist(n, seed)
        write_idx(str(root / f"{prefix}-images-idx3-ubyte"), split.images)
        write_idx(str(root / f"{prefix}-labels-idx1-ubyte"), split.labels)
    return str(root)


@pytest.fixture
def base(mnist):
    def make(*extra):
        return ["--epochs", "2", "--limit", "256", "--batch_size", "64",
                "--path", mnist, *extra]
    return make


def _port_run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, history = port_cli.train(["--device", "cpu", *argv])
    return state, history, out.getvalue()


def _records(directory):
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- runtime collectors -------------------------------------------------------

def test_the_watermark_names_are_the_jax_packages():
    assert [n for n, _ in runtime.MEM_GAUGES] == \
        [n for n, _ in jax_runtime.MEM_GAUGES]


def test_memory_collectors_read_none_from_the_card_on_the_cpu():
    assert runtime.device_memory_stats() is None
    reg = telemetry.MetricsRegistry()
    out = runtime.collect_memory(reg)
    assert set(out) == {"host.rss_bytes"} and out["host.rss_bytes"] > 0
    snap = reg.snapshot()["gauges"]
    assert snap["mem.device_peak_bytes"] is None
    assert snap["mem.host_rss_bytes"] > 0


def test_the_memory_point_carries_the_host_watermark(tmp_path):
    tracer = telemetry.EventTrace(str(tmp_path / "events.jsonl"),
                                  process_index=0)
    runtime.record_memory_point(tracer)
    runtime.record_memory_point(telemetry.NullTracer())
    tracer.close()
    recs = _records(tmp_path)
    points = [r for r in recs if r["kind"] == "point"]
    assert [p["name"] for p in points] == ["mem_watermark"]
    assert set(points[0]["attrs"]) == {"mem.host_rss_bytes"}


def test_the_capture_counter_feeds_one_target_a_process(monkeypatch):
    monkeypatch.setattr(runtime, "_compile_counter", None)
    monkeypatch.setattr(runtime, "_compile_hist", None)
    reg = telemetry.MetricsRegistry()
    runtime.note_capture(1.0)          # not installed: nothing
    assert runtime.install_compile_listener(reg) is True
    assert runtime.install_compile_listener(reg) is True
    other = telemetry.MetricsRegistry()
    assert runtime.install_compile_listener(other) is False
    assert "xla.compiles" not in other.snapshot()["counters"]
    for seconds in (0.25, 0.5, 0.125):
        runtime.note_capture(seconds)
    snap = reg.snapshot()
    assert snap["counters"]["xla.compiles"] == 3
    assert snap["histograms"]["xla.compile_s"]["n"] == 3
    assert snap["histograms"]["xla.compile_s"]["total"] == 0.875


def test_timers_and_the_profiler_session(tmp_path):
    reg = telemetry.MetricsRegistry()
    c = profiling.CumulativeTimer("io", registry=reg)
    for _ in range(3):
        with c:
            pass
    assert c.count == 3 and reg.snapshot()["histograms"]["timer.io_s"]["n"] \
        == 3
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(4).add_(1)
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == f"trace.{os.getpid()}.json"
    assert "traceEvents" in json.loads((tmp_path / "prof" / trace)
                                       .read_text())


# -- the trainer's trace against the JAX trainer's ----------------------------

def _shape(directory):
    recs = _records(directory)
    kinds = sorted({(r["kind"], r["name"]) for r in recs})
    attrs = {r["name"]: sorted(r.get("attrs", {})) for r in recs
             if r["kind"] in ("span", "point")}
    snap = recs[-1]
    return kinds, attrs, snap


# metrics the same run writes into both registries
RUN_METRICS = {"counters": {"xla.compiles", "health.events_total",
                            "data.batches"},
               "gauges": {"mem.host_rss_bytes", "host.rss_bytes",
                          "health.worst_severity_level", "health.last_loss"},
               "histograms": {"xla.compile_s", "dispatch.dispatch",
                              "dispatch.sync_wait"}}


def test_the_trace_is_the_jax_trainers(tmp_path, capsys, base):
    """The final snapshot holds the process's registry, which earlier
    tests in the same process may have filled: the names compared are
    the ones neither registry held before the two runs."""
    argv = base("--checkpoint", "", "--health", "warn",
                "--profile_dispatch", "2")
    before = (jtel.get_registry().snapshot(),
              telemetry.get_registry().snapshot())
    assert jax_cli.main(argv + ["--telemetry", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    _, _, out = _port_run(argv + ["--telemetry", str(tmp_path / "port")])
    jk, ja, jsnap = _shape(tmp_path / "jax")
    pk, pa, psnap = _shape(tmp_path / "port")
    assert pk == jk and pa == ja
    assert psnap["kind"] == jsnap["kind"] == "snapshot"
    for table in ("counters", "gauges", "histograms"):
        seen = set(before[0][table]) | set(before[1][table])
        assert set(psnap["attrs"][table]) - seen == \
            set(jsnap["attrs"][table]) - seen
        assert RUN_METRICS[table] <= set(psnap["attrs"][table])
        assert RUN_METRICS[table] <= set(jsnap["attrs"][table])
    line = r"^\[telemetry\] epochs=2 xla_compiles=\d+ host_rss_mb=\d+ " \
        r"device_peak_mb=None trace=\S+$"
    assert re.search(line, jax_out, re.M) and re.search(line, out, re.M)
    assert check_main(["--require", "health.,mem.,dispatch.,xla.",
                       str(tmp_path / "port")]) == 0
    epochs = [r for r in _records(tmp_path / "port") if r["name"] == "epoch"]
    recs = _records(tmp_path / "port")
    for ep in epochs:
        kids = {r["name"]: r for r in recs if r.get("parent") == ep["span"]}
        assert {"data_wait", "step_compute", "eval"} <= set(kids)
        assert kids["step_compute"]["attrs"]["steps"] == 4
        assert (kids["data_wait"]["dur_s"] + kids["step_compute"]["dur_s"]
                <= ep["dur_s"] + 1e-6)


def test_the_telemetry_line_counts_the_runs_captures_only(tmp_path, base,
                                                         monkeypatch):
    """The capture counter is the process's, as JAX's compile counter is;
    the line counts the run's: three captures before the run are not in
    it, the one a stand-in makes at each epoch's end are."""
    port_cli.train(["--device", "cpu", *base("--checkpoint", "",
                                             "--telemetry",
                                             str(tmp_path / "warm"))])
    for _ in range(3):
        runtime.note_capture(0.0)
    real = port_loop.record_memory_point
    monkeypatch.setattr(port_loop, "record_memory_point",
                        lambda tracer: runtime.note_capture(0.0)
                        or real(tracer))
    _, _, out = _port_run(base("--checkpoint", "", "--telemetry",
                               str(tmp_path / "t")))
    assert re.search(r"^\[telemetry\] epochs=2 xla_compiles=2 ", out, re.M)
    assert _records(tmp_path / "t")[-1]["attrs"]["counters"][
        "xla.compiles"] >= 5


def test_the_cached_trace_has_the_jax_cached_spans(tmp_path, base):
    _port_run(base("--cached", "--checkpoint", "",
                    "--telemetry", str(tmp_path / "c")))
    _port_run(base("--cached", "--fused", "--checkpoint", "",
                    "--telemetry", str(tmp_path / "f")))
    names = {r["name"] for r in _records(tmp_path / "c")}
    assert {"epoch", "step_compute", "eval"} <= names
    assert "data_wait" not in names
    assert "fused_run" in {r["name"] for r in _records(tmp_path / "f")}
    assert check_main([str(tmp_path / "c")]) == 0
    assert check_main([str(tmp_path / "f")]) == 0


@pytest.mark.parametrize("mode", [[], ["--cached"],
                                  ["--cached", "--kernel", "pallas",
                                   "--ckpt_every_steps", "3"],
                                  ["--kernel", "pallas"]])
def test_the_in_run_flags_change_nothing_the_run_computes(tmp_path, mode,
                                                          base):
    """Bitwise: every per-step loss, the parameters and the final
    checkpoint's bytes, with and without the in-run flags."""
    plain = _port_run(base(*mode, "--checkpoint",
                            str(tmp_path / "a.msgpack")))
    flags = _port_run(base(*mode, *FLAGS, "--checkpoint",
                            str(tmp_path / "b.msgpack"), "--telemetry",
                            str(tmp_path / "t")))
    assert all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
               for a, b in zip(plain[1], flags[1]))
    assert (tmp_path / "a.msgpack").read_bytes() == \
        (tmp_path / "b.msgpack").read_bytes()
    lines = [[ln.split("  [")[0] for ln in out.splitlines()
              if ln.startswith("Epoch=")] for out in (plain[2], flags[2])]
    assert lines[0] == lines[1] and len(lines[0]) == 2


def _count_fetches(monkeypatch):
    calls = []
    real_cpu, real_item = torch.Tensor.cpu, torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: calls.append("cpu")
                        or real_cpu(t, *a, **k))
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: calls.append("item") or real_item(t))
    return calls


@pytest.mark.parametrize("mode", [[], ["--cached"]])
def test_telemetry_and_a_healthy_watchdog_add_no_fetch(tmp_path, monkeypatch,
                                                       mode, base):
    """The loop's fetches (`.cpu()`, `.item()`) are the same with
    `--telemetry --health warn --metrics_port 0` as without; an armed
    profiler adds its drains only, one every K steps."""
    calls = _count_fetches(monkeypatch)
    _port_run(base(*mode, "--checkpoint", ""))
    plain = list(calls)
    calls.clear()
    drains = dispatch.counts["drains"]
    _port_run(base(*mode, "--checkpoint", "", *FLAGS,
                    "--telemetry", str(tmp_path / "t")))
    assert calls == plain
    steps = 2 * 4 if not mode else 2     # the cached epoch is one chunk
    assert dispatch.counts["drains"] - drains == math.ceil(steps / 2)


# -- the dispatch profiler ----------------------------------------------------

def test_the_null_profiler_is_the_free_default():
    prof = telemetry.NullProfiler()
    assert prof.armed is False
    prof.mark_prestep()
    prof.begin_dispatch({"p": torch.ones(1)})
    prof.end_dispatch(0)
    prof.note_sync_wait(0.5)
    prof.flush_epoch(0, steps=4)


def test_the_dispatch_records_pass_the_jax_contract(tmp_path):
    telemetry.enable(str(tmp_path))
    try:
        prof = telemetry.DispatchProfiler(sample_every=3)
        for epoch in range(2):
            for step in range(5):
                prof.mark_prestep()
                prof.begin_dispatch({"p": torch.ones(1)})
                prof.end_dispatch(epoch * 5 + step)
            prof.note_sync_wait(0.001)
            prof.flush_epoch(epoch, steps=5, step_total_s=0.01)
        telemetry.get_tracer().snapshot(telemetry.get_registry())
    finally:
        telemetry.disable()
    assert check_main(["--require", "dispatch.", str(tmp_path)]) == 0
    recs = _records(tmp_path)
    for r in recs:
        r["_line"] = 0
    assert jax_analysis.dispatch_record_errors(recs) == []
    phases = [r for r in recs if r["name"] == "dispatch_phase"]
    windows = [r for r in recs if r["name"] == "dispatch_window"]
    assert [w["attrs"]["epoch"] for w in windows] == [0, 1]
    idle = [p["attrs"]["n"] for p in phases
            if p["attrs"]["phase"] == "device_idle"]
    assert idle == [2, 2]      # steps 0, 3 | 6, 9 of a 1-in-3 sampling


@pytest.mark.parametrize("bad", [
    None,
    {"name": "dispatch_phase", "attrs": {"phase": "warp", "total_s": 1.0,
                                         "step": 0}},
    {"name": "dispatch_phase", "attrs": {"phase": "dispatch",
                                         "total_s": -1.0, "step": 0}},
    {"name": "dispatch_phase", "attrs": {"phase": "dispatch",
                                         "total_s": 1.0, "step": 1.5}},
    {"name": "dispatch_window", "attrs": {"window_s": -1,
                                          "attributed_s": 0}},
    {"name": "health", "attrs": {"detector": "", "severity": "warn"}},
    {"name": "health", "attrs": {"detector": "nan", "severity": "dire"}},
])
def test_the_chaos_gate_refuses_what_the_jax_checker_refuses(tmp_path, bad):
    """chaos.py's world leg gates its resumed trace on
    `scripts/check_telemetry.py`: a trace that carries the checkpoint
    metrics but one malformed record fails the gate by name."""
    telemetry.enable(str(tmp_path))
    try:
        telemetry.get_registry().counter("checkpoint.saves").inc()
        tracer = telemetry.get_tracer()
        if bad is not None:
            tracer.point(bad["name"], **bad["attrs"])
        tracer.snapshot(telemetry.get_registry())
    finally:
        telemetry.disable()
    if bad is None:
        assert chaos.telemetry_gate(str(tmp_path), "checkpoint.") == \
            "check_telemetry.py --require checkpoint.: ok"
        return
    with pytest.raises(chaos.ChaosFailure,
                       match=r"check_telemetry.py --require checkpoint\. "
                             r"failed"):
        chaos.telemetry_gate(str(tmp_path), "checkpoint.")


def test_the_drain_refuses_inside_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA-graph capture"):
        dispatch.drain({"p": torch.ones(1)})


# -- the CLI ------------------------------------------------------------------

def _messages(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(argv)
    jtel.disable()
    with pytest.raises(SystemExit) as port_exit:
        configure(argv)
    return str(jax_exit.value.code), str(port_exit.value.code)


@pytest.mark.parametrize("argv", [
    ["--profile_dispatch", "4"],
    ["--profile_dispatch", "--telemetry", "tdir", "--cached", "--fused"],
    ["--metrics_port", "-1"],
])
def test_the_refusals_are_the_jax_clis_word_for_word(argv, tmp_path,
                                                     monkeypatch):
    jax_msg, port_msg = _messages(argv, tmp_path, monkeypatch)
    assert port_msg == jax_msg


def test_the_flags_parse_as_the_jax_clis():
    cfg = configure(["--telemetry", "d", "--profile_dispatch", "--health",
                     "abort", "--metrics_port", "0", "--profile", "p"])
    t = cfg["trainer"]
    assert (t["telemetry"], t["profile_dispatch"], t["health"],
            t["metrics_port"], t["profile"]) == ("d", 16, "abort", 0, "p")
    with pytest.raises(SystemExit) as e:
        configure(["--elastic"])
    assert "not ported" in str(e.value.code)


def test_profile_writes_a_chrome_trace(tmp_path, base):
    _port_run(base("--epochs", "1", "--checkpoint", "",
                    "--profile", str(tmp_path / "prof")))
    (name,) = os.listdir(tmp_path / "prof")
    assert name.startswith("trace.") and name.endswith(".json")


# -- $PDMT_BACKEND_WAIT at a serial run's start -------------------------------

def _stub_backend(monkeypatch, answers):
    seen = []

    def healthy(timeout_s, device_type="cuda"):
        seen.append(device_type)
        return answers[min(len(seen), len(answers)) - 1]

    monkeypatch.setattr(wireup, "_subprocess_backend_healthy", healthy)
    monkeypatch.setattr(wireup.time, "sleep", lambda s: None)
    return seen


def test_a_backend_down_then_up_is_waited_for(tmp_path, monkeypatch, base):
    monkeypatch.setenv("PDMT_BACKEND_WAIT", "30")
    seen = _stub_backend(monkeypatch, [False, False, True])
    _, history, out = _port_run(base("--epochs", "1",
                                      "--checkpoint", ""))
    assert seen == ["cpu"] * 3 and len(history) == 1
    assert "Epoch=0," in out


def test_a_backend_that_stays_down_exits_with_the_jax_message(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PDMT_BACKEND_WAIT", "1")
    monkeypatch.setattr(wireup, "_subprocess_backend_healthy",
                        lambda *a, **k: False)
    with pytest.raises(SystemExit) as port_exit:
        port_cli.train(["--device", "cpu", "--limit", "64", "--checkpoint",
                        ""])
    from pytorch_ddp_mnist_tpu.parallel import wireup as jax_wireup

    def down(max_wait_s, **kw):
        raise jax_wireup.BackendUnavailableError(
            f"backend unavailable after 3 attempts over {max_wait_s:.0f}s: "
            f"down")

    monkeypatch.setattr(jax_wireup, "wait_for_backend", down)
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(["--limit", "64", "--checkpoint", ""])
    head = "accelerator backend unavailable after PDMT_BACKEND_WAIT=1s: " \
           "backend unavailable after "
    assert str(jax_exit.value.code).startswith(head)
    assert str(port_exit.value.code).startswith(head)
    assert "attempts over 1s: " in str(port_exit.value.code)


def test_no_wait_without_the_variable(tmp_path, monkeypatch, base):
    monkeypatch.delenv("PDMT_BACKEND_WAIT", raising=False)
    seen = _stub_backend(monkeypatch, [False])
    _port_run(base("--epochs", "1", "--checkpoint", ""))
    assert seen == []
