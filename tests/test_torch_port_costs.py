"""The port's program forensics (telemetry/costs.py, `trace cost`, `trace
report --cost`) held against the JAX package's, on the CPU:

  * the `CostRecord` field set and the label catalog are the JAX package's;
    `analytic_step_flops` / `analytic_forward_flops` and `bytes_on_wire`
    equal the JAX values at several (model, param_scale, batch, n, comm),
    and the committed COST_r01.json's analytic and wire figures;
  * `trace cost --device cpu` at n = 2, 4 rows a replica, both forms,
    gives the JAX harvest's labels; every record passes the JAX
    `cost_record_errors`, leaves the counts it cannot take absent, and its
    trace passes scripts/check_telemetry.py --require xla.,mem.;
  * `attribution_from_artifact`, `build_cost_report`, `compare_cost`, the
    texts and `load_cost_report` equal the JAX package's on the committed
    MULTICHIP_r0*.json / COST_r01.json; the JAX `attribution_from_artifact`
    reads a port `--mode ddp` line;
  * captures made under `label_compiles` are attributed to their label;
  * `trace cost` without a card and without `--device cpu` exits by name.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib

import jax
import pytest
import torch

from pytorch_ddp_mnist_tpu.models.zoo import resolve_model as jax_resolve
from pytorch_ddp_mnist_tpu.parallel import collectives as jax_collectives
from pytorch_ddp_mnist_tpu.serve.engine import bucket_ladder as jax_ladder
from pytorch_ddp_mnist_tpu.telemetry import analysis as jax_analysis
from pytorch_ddp_mnist_tpu.telemetry import costs as jax_costs
from pytorch_ddp_mnist_tpu_torch import bench, telemetry
from pytorch_ddp_mnist_tpu_torch.cli import trace as port_trace_cli
from pytorch_ddp_mnist_tpu_torch.models.zoo import resolve_model
from pytorch_ddp_mnist_tpu_torch.parallel import collectives
from pytorch_ddp_mnist_tpu_torch.telemetry import costs, runtime

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
_spec = importlib.util.spec_from_file_location(
    "check_telemetry", REPO / "scripts" / "check_telemetry.py")
_checker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_checker)
ABSENT = ("flops", "transcendentals", "bytes_accessed",
          "generated_code_bytes")


def _doc(name):
    return json.loads((REPO / name).read_text())


def test_the_record_fields_and_catalog_are_the_jax_packages():
    assert [(f.name, f.default) for f in dataclasses.fields(
        costs.CostRecord)] == [(f.name, f.default) for f in
                               dataclasses.fields(jax_costs.CostRecord)]
    for name in ("COST_POINT", "COST_REPORT_TAG", "N_DEVICES",
                 "BATCH_PER_DEVICE", "RUN_EPOCHS", "RUN_STEPS",
                 "DEFAULT_PER_CHIP_BATCH", "COMMS", "OOM_SIGNATURES"):
        assert getattr(costs, name) == getattr(jax_costs, name), name
    assert costs.looks_like_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    for comm in costs.COMMS:
        for overlap in (False, True):
            for form in ("step", "run"):
                assert costs._label(comm, overlap, form) == \
                    collectives.step_cost_label(comm, overlap, form) == \
                    jax_costs._label(comm, overlap, form)


@pytest.mark.parametrize("model,scale,batch,n", [
    ("mlp", 1, 16, 8), ("mlp", 4, 4, 2), ("deep_mlp", 2, 8, 4)])
def test_the_analytic_and_wire_figures_are_the_jax_packages(model, scale,
                                                            batch, n):
    spec, jspec = resolve_model(model, scale), jax_resolve(model, scale)
    assert tuple(spec.dims) == tuple(jspec.dims)
    assert costs.model_macs(spec.dims) == jax_costs.model_macs(jspec.dims)
    assert costs.analytic_step_flops(spec.dims, batch) == \
        jax_costs.analytic_step_flops(jspec.dims, batch)
    assert costs.analytic_forward_flops(spec.dims, batch) == \
        jax_costs.analytic_forward_flops(jspec.dims, batch)
    params = spec.from_seed(0).params()
    jparams = jax.eval_shape(jspec.init, jax.random.PRNGKey(0))
    for comm in costs.COMMS:
        assert collectives.bytes_on_wire(params, n, comm) == \
            jax_collectives.bytes_on_wire(jparams, n, comm)


def test_the_committed_cost_reports_figures_price_as_the_port():
    doc = _doc("COST_r01.json")
    for rec in doc["records"]:
        if rec["kind"] == "serve":
            dims, b = resolve_model().dims, rec["batch_per_device"]
            assert costs.analytic_forward_flops(dims, b) == \
                rec["analytic_flops"]
            continue
        dims = resolve_model(rec["model"], rec["param_scale"]).dims
        count = sum(a * b + b * (i < len(dims) - 2)
                    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
        assert count == rec["n_params"]
        assert costs.analytic_step_flops(dims, rec["batch_per_device"]) == \
            rec["analytic_flops"]
        assert collectives.bytes_on_wire(count, rec["n_devices"],
                                         rec["comm"]) == rec["wire_bytes"]


@pytest.fixture
def fresh_listener(monkeypatch):
    monkeypatch.setattr(runtime, "_compile_counter", None)
    monkeypatch.setattr(runtime, "_compile_hist", None)
    monkeypatch.setattr(runtime, "_compile_attr", {})
    monkeypatch.setattr(telemetry.registry, "_GLOBAL",
                        telemetry.MetricsRegistry())


def test_trace_cost_on_the_cpu_gives_the_jax_labels(tmp_path, capsys,
                                                    fresh_listener):
    out, tel = tmp_path / "COST.json", tmp_path / "tel"
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert port_trace_cli.main([
            "cost", "--device", "cpu", "--n_devices", "2", "--batch", "4",
            "--form", "both", "-o", str(out), "--telemetry", str(tel)]) == 0
    finally:
        torch.set_num_threads(before)
    report = json.loads(out.read_text())
    labels = [r["program"] for r in report["records"]]
    want = [jax_costs._label(c, o, f) for c in jax_costs.COMMS
            for o in (False, True) for f in ("step", "run")]
    want += [f"serve.bucket{b}" for b in jax_ladder(128)]
    assert labels == want
    step_labels = [lb for lb in labels if ".run." not in lb]
    assert step_labels == [r["program"] for r in _doc("COST_r01.json")[
        "records"]]
    seg = [{"kind": "point", "name": costs.COST_POINT, "attrs": r,
            "_line": i} for i, r in enumerate(report["records"])]
    assert jax_analysis.cost_record_errors(seg) == []
    dims = resolve_model().dims
    params = resolve_model().from_seed(0).params()
    for r in report["records"]:
        assert not r.get("error") and r["compiled"] is False
        assert not any(k in r for k in ABSENT + ("peak_bytes",
                                                 "temp_bytes", "compile_s"))
        assert r["argument_bytes"] > 0 and r["output_bytes"] > 0
        if r["kind"] == "ddp":
            steps = 1 if r["form"] == "step" else 2
            assert r["analytic_flops"] == steps * \
                jax_costs.analytic_step_flops(dims, 4)
            assert r["wire_bytes"] == steps * collectives.bytes_on_wire(
                params, 2, r["comm"])
            assert r["alias_bytes"] >= 4 * r["n_params"]
    assert report["backend"] == "cpu" and report["summary"]["programs"] == 24
    assert _checker.main(["--require", "xla.,mem.", str(tel)]) == 0
    assert "24 record(s)" in capsys.readouterr().out


@pytest.mark.parametrize("artifact,batch", [
    ("MULTICHIP_r06.json", None), ("MULTICHIP_r07.json", 4),
    ("MULTICHIP_r08.json", None)])
def test_the_attribution_and_gate_are_the_jax_packages(artifact, batch):
    art, cost = _doc(artifact), _doc("COST_r01.json")
    rows = costs.attribution_from_artifact(art, batch)
    assert rows == jax_costs.attribution_from_artifact(art, batch)
    ours = costs.build_cost_report(cost["records"], artifact=art,
                                   per_chip_batch=batch)
    theirs = jax_costs.build_cost_report(cost["records"], artifact=art,
                                         per_chip_batch=batch)
    for rep in (ours, theirs):
        rep.pop("generated_unix")
        rep.pop("compile_attribution")
    assert ours == theirs
    assert costs.format_cost_report(ours) == \
        jax_costs.format_cost_report(theirs)
    for threshold in (1.5, 1.01):
        diff = costs.compare_cost(ours, cost, threshold=threshold)
        assert diff == jax_costs.compare_cost(theirs, cost,
                                              threshold=threshold)
        assert costs.format_compare_cost(diff) == \
            jax_costs.format_compare_cost(diff)
    for target in (str(REPO / artifact), str(REPO / "COST_r01.json"),
                   str(REPO / "BASELINE.json")):
        a, b = costs.load_cost_report(target, batch), \
            jax_costs.load_cost_report(target, batch)
        for rep in (a[0], b[0]):
            if rep:
                rep.pop("generated_unix", None)
                rep.pop("compile_attribution", None)
        assert a == b


def test_the_jax_attribution_reads_a_port_ddp_line():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = bench.run_ddp_rows(CPU, strategies=("pmean", "bf16"),
                                  replicas=2, per_replica_batch=16, epochs=1,
                                  n_rows=64, windows=1)
    finally:
        torch.set_num_threads(before)
    art = {"strategies": bench.ddp_lines(rows, {"backend": "cpu"})}
    ours = costs.attribution_from_artifact(art)
    assert ours == jax_costs.attribution_from_artifact(art)
    assert [r["program"] for r in ours] == ["ddp.step.pmean",
                                            "ddp.step.bf16"]
    for r in ours:
        assert r["n_devices"] == 2 and r["per_chip_batch"] == 16
        assert abs(sum(r["shares"].values()) - 1) < 1e-3


def test_captures_are_attributed_to_their_label(fresh_listener):
    reg = telemetry.MetricsRegistry()
    assert runtime.install_compile_listener(reg)
    runtime.note_capture(0.5)
    with runtime.label_compiles("ddp.step.pmean"):
        assert runtime.current_compile_label() == "ddp.step.pmean"
        runtime.note_capture(0.25)
        with runtime.label_compiles("serve.bucket8"):
            runtime.note_capture(0.125)
        runtime.note_capture(0.25)
    assert runtime.current_compile_label() is None
    assert runtime.compile_attribution() == {
        "ddp.step.pmean": {"count": 2, "total_s": 0.5},
        "serve.bucket8": {"count": 1, "total_s": 0.125}}
    assert reg.snapshot()["counters"]["xla.compiles"] == 4
    assert runtime.process_index_cached() == 0


def test_trace_cost_without_a_card_exits_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card is available.*trace "
                                         "cost runs on the card; pass "
                                         "--device cpu"):
        port_trace_cli.main(["cost", "--no-serve-ladder"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert port_trace_cli.main(["cost", "--device", "cpu", "--artifact",
                                    str(REPO / "BASELINE.json")]) == 1
    assert "not a DDP bench artifact" in err.getvalue()
