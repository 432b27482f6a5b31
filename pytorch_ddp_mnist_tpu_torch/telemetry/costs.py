"""Program forensics: per-program cost and memory records of the port's
captured programs, the measured-vs-analytic attribution, and the
compile/memory regression gate (port of
`pytorch_ddp_mnist_tpu/telemetry/costs.py`).

`trace cost` builds the JAX package's program matrix from the port's own
step builders and prices each program in one `CostRecord`:

  * `ddp.<form>.<comm>[+overlap]`: the four comms x overlap off/on, in
    the forms `step` (one step) and `run` (RUN_EPOCHS x RUN_STEPS steps),
    on N_DEVICES replicas of the card at BATCH_PER_DEVICE rows a replica.
    Each program is train/scan.py `dp_steps`: the captured DP step of
    `CachedSteps` over a parallel/collectives.py `DPComm`, the one builder
    `bench.py --mode ddp` times too, so the records price the programs the
    bench measures (and the contract audits will walk the same builder).
    Its kernel is the trainer's `--kernel auto` (`dp_kernel`).
  * `serve.bucket<N>`: the serve engine's bucket ladder up to
    `--serve_max_batch`, one rung an engine, each captured as its graph.

What a record holds, and where it comes from:

  * `compiled`: the program was captured as a CUDA graph (the port's
    counterpart of a compiled XLA executable); `compile_s` is that
    capture's wall time, its warm-up included, taken under
    `runtime.label_compiles(label)`. The first program of a process to
    launch a kernel library or cuBLAS also pays for loading it there.
    Before it is priced, each DP program is run once captured and once
    eagerly on equal inputs, and a capture that is not bitwise its eager
    step is an error record.
  * `analytic_flops` and `wire_bytes`: the JAX formulas unchanged
    (`model_macs`, `analytic_step_flops`, `analytic_forward_flops`,
    collectives.bytes_on_wire), times the steps the program runs.
  * `argument_bytes`: the bytes of the program's static inputs (params,
    the comm state, the resident rows and labels, the index and key
    tables, the step cursor; for a rung, params and its input);
    `output_bytes`: what a replay writes (params, the comm state, the
    loss buffer and the cursor; a rung's logits and preds);
    `alias_bytes`: the outputs written in place over inputs (params, comm
    state, cursor; none in a rung). Counted from the tensors themselves.
  * `peak_bytes`: `torch.cuda.max_memory_allocated` over the program's
    build, capture and one replay, less the bytes allocated before the
    build (the peak statistics reset first): a delta, not the process's
    watermark. cuBLAS takes a workspace (32 MiB on an H100) for each
    stream it first runs on; the captures share one warm-up stream
    (train/graphs.py `side_stream`) and torch's capture stream, so only
    the first program of a process to call cuBLAS there (an `xla` step, a
    serve rung) pays for it.
    `temp_bytes`: the growth of the allocator's reserved bytes during the
    capture, the graph's private pool.
  * `flops`, `transcendentals`, `bytes_accessed` and
    `generated_code_bytes` stay absent: XLA reads them off its compiled
    module (`cost_analysis()`, `memory_analysis()`), and a CUDA graph
    offers no counterpart. The port does not count them for a program,
    and it neither zero-fills them nor copies XLA's numbers.

On the CPU (`--device cpu`, the tests) nothing is captured: the records
carry `compiled=False` and their static byte counts and analytic fields,
and no memory measurement. `trace cost` runs on the card unless the
caller passes `--device cpu`; with no card it exits by name. On a card a
program that fails to build, capture or match its eager step is an error
record (`error`), counted and printed, and the harvest exits 1; nothing
falls back to the CPU.

The read side (`trace report --cost`, cli/trace.py) is the JAX package's:
`attribution_from_artifact` splits a DDP bench artifact's measured step
time T into compute C = scaling_efficiency_vs_1dev x T, wire M =
collective_s_p50 and overhead O = T - bound (bound = C + M serial, max(C,
M) overlapped); `compare_cost` gates compile-count growth, peak-memory
growth and analytic-efficiency drops; `looks_like_oom` /
`record_oom_forensics` dump the loaded program table on an allocation
failure (torch's "CUDA out of memory" matches OOM_SIGNATURES).
`analytic_flops` and `wire_bytes` are per replica, as in the JAX records;
the memory fields are the whole program's on the one card its replicas
share.

Module import is pure stdlib (torch only inside the harvest), so the
report and the gate run wherever the JSON lands.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence

# Trace point-event name for one emitted cost record; the checker
# (scripts/check_telemetry.py via analysis.cost_record_errors) validates
# these: non-empty string `program`, non-negative numeric cost fields.
COST_POINT = "program_cost"
COST_REPORT_TAG = "program_cost_report"

# Default geometry: the JAX package's audit matrix (replicas of one card
# here, rows a replica).
N_DEVICES = 8
BATCH_PER_DEVICE = 16
# Run-form harvest geometry (RUN_EPOCHS epochs of RUN_STEPS steps through
# the captured step), so the analytic totals below price the step count
# the program executes.
RUN_EPOCHS = 1
RUN_STEPS = 2
# The bench default per-chip batch: the fallback for a strategies row that
# predates the `per_chip_batch` stamp.
DEFAULT_PER_CHIP_BATCH = 128

COMMS = ("pmean", "sharded", "bf16", "int8")

# Substrings (lowercased match) of allocation-failure errors. Narrow by
# the looks_like_backend_loss design rule: a retryable backend outage
# ("unavailable", "deadline exceeded") must NOT read as an OOM, and a
# shape/compile error must match neither.
OOM_SIGNATURES = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "out-of-memory", "failed to allocate", "allocation failure",
    "cannot allocate", "exceeds available memory", "hbm limit",
)


def _label(comm: str, overlap: bool = False, form: str = "step") -> str:
    """`ddp.<form>.<comm>[+overlap]` — kept as a LITERAL twin of
    `parallel.collectives.step_cost_label` so this module imports no
    framework at load time (tests pin the two against each other)."""
    return f"ddp.{form}.{comm}" + ("+overlap" if overlap else "")


def looks_like_oom(e: BaseException) -> bool:
    """Does this error look like a device allocation failure (vs a backend
    loss or a deterministic program error)? The forensics trigger: only a
    True here dumps the program memory table."""
    msg = str(e).lower()
    return any(sig in msg for sig in OOM_SIGNATURES)


@dataclass
class CostRecord:
    """One program's cost/memory story (see the module docstring), with
    the JAX package's fields. `compiled=False`
    on the CPU, where nothing is captured: the memory measurements are
    absent there. A field the port does not count stays None."""
    program: str
    kind: str                    # "ddp" | "serve"
    n_devices: int
    compiled: bool
    flops: Optional[float] = None
    transcendentals: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    analytic_flops: Optional[int] = None
    wire_bytes: Optional[int] = None
    compile_s: Optional[float] = None
    comm: Optional[str] = None
    overlap: Optional[bool] = None
    form: Optional[str] = None
    model: Optional[str] = None
    param_scale: Optional[int] = None
    n_params: Optional[int] = None
    batch_per_device: Optional[int] = None
    error: Optional[str] = None

    def to_json(self) -> dict:
        return {k: v for k, v in asdict(self).items()
                if v is not None or k in ("program", "kind", "compiled")}


# -- the loaded-program table (what an OOM dump names) -----------------------

_TABLE_LOCK = threading.Lock()
_PROGRAM_TABLE: Dict[str, dict] = {}


def register_program(record: "CostRecord | dict") -> None:
    """Remember a program's memory story in the process-wide table the OOM
    forensics dump names. The harvest registers every record."""
    rec = record.to_json() if isinstance(record, CostRecord) else dict(record)
    label = rec.get("program")
    if not label:
        return
    with _TABLE_LOCK:
        _PROGRAM_TABLE[str(label)] = rec


def loaded_program_table() -> Dict[str, dict]:
    with _TABLE_LOCK:
        return {k: dict(v) for k, v in _PROGRAM_TABLE.items()}


def record_oom_forensics(e: BaseException, program: Optional[str] = None,
                         dump: bool = True) -> Optional[str]:
    """If `e` classifies as an OOM, record an `oom_forensics` entry (the
    failing program's name, the loaded program memory table, and the live
    watermarks) in the flight recorder, dump the ring, and return the dump
    path. Non-OOM errors return None untouched — callers re-raise either
    way, this only annotates the post-mortem."""
    if not looks_like_oom(e):
        return None
    from . import flight
    from .runtime import MEM_GAUGES, current_compile_label
    label = program or current_compile_label() or "<unlabeled>"
    watermarks = {}
    for name, fn in MEM_GAUGES:
        try:
            v = fn()
        except (OSError, ValueError, RuntimeError):
            v = None  # a dying backend's probe must not mask the OOM
        if v is not None:
            watermarks[name] = v
    table = loaded_program_table()
    programs = {
        lbl: {k: rec.get(k) for k in ("peak_bytes", "temp_bytes",
                                      "argument_bytes", "output_bytes")
              if rec.get(k) is not None}
        for lbl, rec in table.items()}
    flight.record("oom_forensics", program=label, error=str(e)[:500],
                  watermarks=watermarks, programs=programs)
    if not dump:
        return None
    return flight.dump(reason=f"oom: {label}")


# -- the analytic roofline model ---------------------------------------------

def model_macs(dims: Sequence[int]) -> int:
    """Forward MACs per image of an MLP with the given layer dims —
    784*128 + 128*128 + 128*10 = 118,016 for the reference model (the
    bench.py MACS_FWD_PER_IMG constant, generalized to the zoo)."""
    return sum(int(a) * int(b) for a, b in zip(dims[:-1], dims[1:]))


def analytic_step_flops(dims: Sequence[int], batch_per_device: int) -> int:
    """Exact matmul-FLOPs lower bound of one per-device TRAIN step:
    2 FLOPs/MAC forward, backward ~2x forward (the standard 6x rule the
    bench roofline uses). Element-wise ops (relu, dropout, softmax) are
    excluded — this is the roofline floor, not the XLA bill."""
    return 6 * model_macs(dims) * int(batch_per_device)


def analytic_forward_flops(dims: Sequence[int], batch_per_device: int) -> int:
    """Exact matmul-FLOPs lower bound of one per-device INFERENCE pass
    (2 FLOPs/MAC, no backward) — the serve bucket ladder's model."""
    return 2 * model_macs(dims) * int(batch_per_device)


# -- harvest (torch imported lazily from here on) ----------------------------

# A program that fails to build, capture or replay raises one of these (a
# CUDA or allocator error is a RuntimeError): its record carries the error
_HARVEST_ERRORS = (RuntimeError, ValueError, TypeError)


def _nbytes(tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def _leaves(params) -> list:
    return [v for layer in params.values() for v in layer.values()]


def _memory_base(device) -> Optional[int]:
    """On a card: drain it, reset the peak statistics and return the bytes
    allocated now (the base a program's peak is measured from); None on
    the CPU."""
    import torch
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak_since(device, base: int) -> int:
    import torch
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device) - base)


def _dp_run(params_host, comm: str, overlap: bool, *, n_dev: int, batch: int,
            epochs: int, steps: int, model: str, param_scale: int, device,
            eager: bool):
    """One DP program (train/scan.py `dp_steps`) built on `device` and run
    `epochs` epochs of `steps` steps over synthetic rows: (the program,
    its resident rows and labels, the last epoch's losses)."""
    import numpy as np
    import torch

    from ..data.mnist import synthetic_mnist
    from ..ops.threefry import key_data
    from ..train.scan import dp_steps, resident_images
    rows = n_dev * batch * steps
    split = synthetic_mnist(rows, seed=0)
    x_all = torch.from_numpy(resident_images(split.images)).to(device)
    y_all = torch.from_numpy(split.labels.astype(np.int32)).to(device)
    idx = np.arange(rows, dtype=np.int32).reshape(steps, n_dev * batch)
    params = {n: {k: v.detach().to(device, torch.float32).clone()
                  for k, v in layer.items()}
              for n, layer in params_host.items()}
    prog = dp_steps(params, x_all, y_all, comm, overlap, replicas=n_dev,
                    nsteps=steps, batch=batch, model=model,
                    param_scale=param_scale, eager=eager)
    key = key_data(1)
    for _ in range(epochs):
        key, losses = prog.epoch(key, idx)
    return prog, x_all, y_all, losses


def harvest_dp_program(comm: str, overlap: bool, form: str, *, n_dev: int,
                       batch: int, model: str, param_scale: int, device,
                       params_host=None) -> CostRecord:
    """The record of `ddp.<form>.<comm>[+overlap]` (see the module
    docstring): built, captured and replayed under
    `label_compiles(label)`; on a card, measured and held bitwise against
    the same program run eagerly."""
    import torch

    from ..models.mlp import param_count
    from ..models.zoo import resolve_model
    from ..parallel import collectives
    from .runtime import label_compiles

    spec = resolve_model(model, param_scale)
    if params_host is None:
        params_host = spec.from_seed(0).params()
    epochs, steps = (1, 1) if form == "step" else (RUN_EPOCHS, RUN_STEPS)
    n_steps = epochs * steps
    label = _label(comm, overlap, form)
    rec = CostRecord(
        program=label, kind="ddp", n_devices=int(n_dev), compiled=False,
        comm=comm, overlap=overlap, form=form, model=model,
        param_scale=param_scale, n_params=param_count(params_host),
        batch_per_device=batch,
        wire_bytes=collectives.bytes_on_wire(params_host, n_dev, comm)
        * n_steps,
        analytic_flops=analytic_step_flops(spec.dims, batch) * n_steps)
    kw = dict(n_dev=n_dev, batch=batch, epochs=epochs, steps=steps,
              model=model, param_scale=param_scale, device=device)
    try:
        base = _memory_base(device)
        with label_compiles(label):
            prog, x_all, y_all, losses = _dp_run(params_host, comm, overlap,
                                                 eager=False, **kw)
        loop = prog.loop
        if base is not None:
            rec.peak_bytes = _peak_since(device, base)
            rec.compiled = loop.graph is not None
            rec.compile_s = round(loop.capture_s, 6)
            rec.temp_bytes = int(loop.pool_bytes)
        state = _leaves(prog.params) + list(prog.comm.state_tensors())
        rec.argument_bytes = _nbytes(state + [x_all, y_all, prog.idx.buf,
                                              prog.keys.buf, loop.cursor])
        rec.output_bytes = _nbytes(state + [loop._losses, loop.cursor])
        rec.alias_bytes = _nbytes(state + [loop.cursor])
        if rec.compiled:
            twin, _, _, twin_losses = _dp_run(params_host, comm, overlap,
                                              eager=True, **kw)
            bitwise = torch.equal(losses, twin_losses) and all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(prog.params) + list(prog.comm.state_tensors()),
                    _leaves(twin.params) + list(twin.comm.state_tensors())))
            if not bitwise:
                rec.error = ("capture: the captured program is not bitwise "
                             "its eager step on the same inputs")
    except _HARVEST_ERRORS as e:
        record_oom_forensics(e, program=label)
        rec.error = f"{type(e).__name__}: {e}"[:300]
    register_program(rec)
    return rec


def harvest_step_matrix(*, comms: Sequence[str] = COMMS,
                        overlaps: Sequence[bool] = (False, True),
                        forms: Sequence[str] = ("step",),
                        n_dev: int = N_DEVICES,
                        batch: int = BATCH_PER_DEVICE,
                        model: str = "mlp", param_scale: int = 1,
                        device) -> List[CostRecord]:
    """Cost records for the comm x overlap DDP program matrix on `n_dev`
    replicas of `device`. `batch` is rows a replica."""
    from ..models.zoo import resolve_model
    params_host = resolve_model(model, param_scale).from_seed(0).params()
    return [harvest_dp_program(comm, overlap, form, n_dev=n_dev, batch=batch,
                               model=model, param_scale=param_scale,
                               device=device, params_host=params_host)
            for comm in comms for overlap in overlaps for form in forms]


def harvest_serve_ladder(max_batch: int, device) -> List[CostRecord]:
    """Cost records for the serve engine's bucket ladder up to
    `max_batch`, `serve.bucket<N>` labels, the forward-pass analytic
    floor: one engine a rung (serve/engine.py `InferenceEngine` with
    `buckets=(N,)`), so each rung's memory is measured alone. Its
    arguments are params and the rung's input, its outputs the logits and
    preds."""
    import numpy as np

    from ..models.mlp import MLP_DIMS, init_params
    from ..serve.engine import InferenceEngine, bucket_ladder
    params = init_params(0)
    param_bytes = 4 * sum(int(np.asarray(v).size) for layer in params.values()
                          for v in layer.values())
    out = []
    for bucket in bucket_ladder(max_batch):
        label = f"serve.bucket{bucket}"
        rec = CostRecord(
            program=label, kind="serve", n_devices=1, compiled=False,
            batch_per_device=bucket, wire_bytes=0,
            argument_bytes=param_bytes + 4 * bucket * MLP_DIMS[0],
            output_bytes=4 * bucket * (MLP_DIMS[-1] + 1), alias_bytes=0,
            analytic_flops=analytic_forward_flops(MLP_DIMS, bucket))
        try:
            base = _memory_base(device)
            engine = InferenceEngine(params, max_batch=max_batch,
                                     device=device, buckets=(bucket,))
            try:
                engine.forward(np.zeros((bucket, MLP_DIMS[0]), np.float32))
                stats = engine.capture_stats().get(bucket)
                if base is not None:
                    rec.peak_bytes = _peak_since(device, base)
                if stats is not None:
                    rec.compiled = True
                    rec.compile_s = round(stats["capture_s"], 6)
                    rec.temp_bytes = int(stats["pool_bytes"])
            finally:
                engine.close()
        except _HARVEST_ERRORS as e:
            record_oom_forensics(e, program=label)
            rec.error = f"{type(e).__name__}: {e}"[:300]
        register_program(rec)
        out.append(rec)
    return out


def emit_records(tracer, records: Sequence[CostRecord]) -> None:
    """One `program_cost` point event per record into the JSONL trace —
    the shape `analysis.cost_record_errors` / check_telemetry validate."""
    for rec in records:
        tracer.point(COST_POINT, **rec.to_json())


# -- the attribution / roofline decomposition (pure stdlib) ------------------

def attribution_from_artifact(artifact: dict,
                              per_chip_batch: Optional[int] = None) -> List[dict]:
    """The measured-vs-analytic decomposition, one row per strategies
    entry of a DDP bench artifact (MULTICHIP_r0X.json / `bench.py --mode
    ddp` lines): measured per-device step time T splits into

      compute_s  C = scaling_efficiency_vs_1dev * T  (the 1-device step
                 time of the same per-chip batch, by the efficiency
                 definition — no extra measurement needed),
      comm_s     M = collective_s_p50 (the isolated wire probe), and
      overhead_s O = T - bound,  bound = C + M serial, max(C, M)
                 overlapped (comm analytically hidden behind compute).

    Shares divide by T and sum to 1. `analytic_efficiency` = C / bound:
    what efficiency WOULD be if the step were only compute + wire;
    measured efficiency under it is dispatch/launch overhead, the
    arXiv:1810.11112 residual. `per_chip_batch` overrides rows that
    predate the stamp (legacy artifacts default to 128, the bench
    default; MULTICHIP_r07 was measured at 4 — pass it)."""
    rows = []
    for r in artifact.get("strategies") or []:
        if not isinstance(r, dict):
            continue
        n = r.get("n_devices", artifact.get("n_devices"))
        rate = r.get("images_per_sec")
        eff = r.get("scaling_efficiency_vs_1dev")
        m = r.get("collective_s_p50")
        b = per_chip_batch or r.get("per_chip_batch") \
            or DEFAULT_PER_CHIP_BATCH
        if not all(isinstance(v, (int, float)) and v > 0
                   for v in (n, rate, eff, b)) or n <= 1 \
                or not isinstance(m, (int, float)) or m < 0:
            continue
        t = float(b) * float(n) / float(rate)      # measured step seconds
        c = float(eff) * t                          # analytic compute
        overlap = bool(r.get("overlap"))
        bound = max(c, float(m)) if overlap else c + float(m)
        o = t - bound
        rows.append({
            "program": _label(str(r.get("strategy", "?")), overlap),
            "strategy": r.get("strategy"),
            "overlap": overlap,
            "n_devices": int(n),
            "per_chip_batch": int(b),
            "measured_step_s": round(t, 6),
            "compute_s": round(c, 6),
            "comm_s": round(float(m), 6),
            "bound_s": round(bound, 6),
            "overhead_s": round(o, 6),
            "shares": {
                "compute": round(c / t, 4),
                # the wire time the step actually EXPOSES: all of M when
                # serial, only the part compute can't hide when overlapped
                "comm_exposed": round(max(0.0, bound - c) / t, 4),
                "overhead": round(o / t, 4),
            },
            "measured_efficiency": round(float(eff), 4),
            "analytic_efficiency": round(c / bound, 4),
        })
    return rows


def build_cost_report(records: Sequence[CostRecord], *,
                      artifact: Optional[dict] = None,
                      per_chip_batch: Optional[int] = None,
                      meta: Optional[dict] = None) -> dict:
    """The COST_r0X.json shape: per-program records, compile attribution,
    the roofline attribution rows (when a bench artifact is supplied),
    and the summary the gate and the bench stamp read:
    {peak_hbm_bytes, analytic_efficiency, compile_s_total,
    compile_count}."""
    recs = [r.to_json() if isinstance(r, CostRecord) else dict(r)
            for r in records]
    peaks = [r["peak_bytes"] for r in recs
             if isinstance(r.get("peak_bytes"), (int, float))]
    compile_times = [r["compile_s"] for r in recs
                     if isinstance(r.get("compile_s"), (int, float))]
    attribution = (attribution_from_artifact(artifact, per_chip_batch)
                   if artifact else [])
    try:
        from .runtime import compile_attribution
        compile_attr = compile_attribution()
    except ImportError:
        compile_attr = {}
    report = {
        "report": COST_REPORT_TAG,
        "v": 1,
        "generated_unix": round(time.time(), 3),
        "records": recs,
        "attribution": attribution,
        "compile_attribution": compile_attr,
        "summary": {
            "programs": len(recs),
            "compile_count": sum(1 for r in recs if r.get("compiled")),
            "compile_s_total": round(sum(compile_times), 6),
            "peak_hbm_bytes": max(peaks) if peaks else None,
            "analytic_efficiency": {
                row["program"]: row["analytic_efficiency"]
                for row in attribution},
        },
    }
    if meta:
        report.update(meta)
    return report


# -- the gate ----------------------------------------------------------------

def compare_cost(new: dict, baseline: dict, threshold: float = 1.5) -> dict:
    """Diff two cost reports -> {"rows": [...], "regressions": [...]},
    the `compare`/`compare_data` shape. Three gated axes:

      * compile_count — ANY growth regresses (program counts are
        structural, not noisy: more compiles means a recompile storm or a
        silently widened ladder; a deliberate growth is acknowledged by
        refreshing the baseline);
      * peak HBM — summary peak and per-program peak_bytes for labels in
        both reports, new/old ratio past `threshold`;
      * analytic_efficiency — per program label in both, old/new ratio
        past `threshold` (better-is-bigger, the efficiency-gate
        convention).
    """
    rows, regressions = [], []

    def add(metric, program, old_v, new_v, ratio, regressed):
        row = {"metric": metric, "program": program, "baseline": old_v,
               "new": new_v, "ratio": ratio, "regressed": bool(regressed)}
        rows.append(row)
        if row["regressed"]:
            regressions.append(row)

    ns, bs = new.get("summary") or {}, baseline.get("summary") or {}
    oc, nc = bs.get("compile_count"), ns.get("compile_count")
    if isinstance(oc, int) and isinstance(nc, int):
        add("compile_count", "<total>", oc, nc,
            (nc / oc) if oc else float("inf") if nc else 1.0, nc > oc)
    op, np_ = bs.get("peak_hbm_bytes"), ns.get("peak_hbm_bytes")
    if isinstance(op, (int, float)) and isinstance(np_, (int, float)) \
            and op > 0:
        add("peak_hbm_bytes", "<max>", op, np_, np_ / op,
            np_ / op > threshold)
    old_recs = {r.get("program"): r for r in baseline.get("records") or []
                if isinstance(r, dict)}
    for r in new.get("records") or []:
        if not isinstance(r, dict):
            continue
        o = old_recs.get(r.get("program"))
        if not o:
            continue
        ob, nb = o.get("peak_bytes"), r.get("peak_bytes")
        if isinstance(ob, (int, float)) and isinstance(nb, (int, float)) \
                and ob > 0:
            add("peak_bytes", r["program"], ob, nb, nb / ob,
                nb / ob > threshold)
    oe = (bs.get("analytic_efficiency") or {})
    ne = (ns.get("analytic_efficiency") or {})
    for label in sorted(set(oe) & set(ne)):
        ov, nv = oe[label], ne[label]
        if not (isinstance(ov, (int, float)) and isinstance(nv, (int, float))
                and ov > 0):
            continue
        ratio = (ov / nv) if nv > 0 else float("inf")
        add("analytic_efficiency", label, ov, nv, ratio, ratio > threshold)
    return {"threshold": threshold, "rows": rows,
            "regressions": regressions}


# -- rendering ---------------------------------------------------------------

def format_cost_report(report: dict) -> str:
    lines = []
    s = report.get("summary") or {}
    lines.append(f"program cost report: {s.get('programs', 0)} program(s), "
                 f"{s.get('compile_count', 0)} compiled, "
                 f"compile_s_total {s.get('compile_s_total', 0.0):.3f}s, "
                 f"peak HBM "
                 f"{s.get('peak_hbm_bytes') if s.get('peak_hbm_bytes') is not None else 'n/a'}")
    recs = report.get("records") or []
    if recs:
        lines.append(f"{'program':<24} {'flops':>14} {'bytes_acc':>12} "
                     f"{'peak_bytes':>12} {'wire_bytes':>12} {'compile_s':>10}")
        for r in recs:
            def fmt(v, nd=0):
                return (f"{v:,.{nd}f}" if isinstance(v, (int, float))
                        else "-")
            lines.append(f"{str(r.get('program', '?')):<24} "
                         f"{fmt(r.get('flops')):>14} "
                         f"{fmt(r.get('bytes_accessed')):>12} "
                         f"{fmt(r.get('peak_bytes')):>12} "
                         f"{fmt(r.get('wire_bytes')):>12} "
                         f"{r.get('compile_s') if r.get('compile_s') is not None else '-':>10}")
    att = report.get("attribution") or []
    if att:
        lines.append("")
        lines.append(f"measured-step attribution "
                     f"(T = compute + exposed comm + overhead):")
        lines.append(f"{'program':<24} {'step_s':>9} {'compute':>8} "
                     f"{'comm_exp':>9} {'overhead':>9} {'eff meas':>9} "
                     f"{'eff bound':>9}")
        for row in att:
            sh = row["shares"]
            lines.append(f"{row['program']:<24} "
                         f"{row['measured_step_s']:>9.4f} "
                         f"{100 * sh['compute']:>7.1f}% "
                         f"{100 * sh['comm_exposed']:>8.1f}% "
                         f"{100 * sh['overhead']:>8.1f}% "
                         f"{row['measured_efficiency']:>9.4f} "
                         f"{row['analytic_efficiency']:>9.4f}")
    elif not recs:
        lines.append("no cost records and no attribution rows (harvest "
                     "with `trace cost`, or pass a DDP bench artifact)")
    return "\n".join(lines)


def format_compare_cost(diff: dict) -> str:
    lines = [f"cost gate (compile-count growth; peak-HBM / "
             f"analytic-efficiency ratio > {diff['threshold']:g}x):"]
    for row in diff["rows"]:
        verdict = "REGRESSION" if row["regressed"] else "ok"
        lines.append(f"  {row['metric']:<20} {row['program']:<24} "
                     f"{row['baseline']} -> {row['new']}  "
                     f"({row['ratio']:.2f}x)  {verdict}")
    if not diff["rows"]:
        lines.append("  (no cost metric overlaps baseline — nothing gated)")
    n = len(diff["regressions"])
    lines.append(f"regression gate: "
                 f"{f'FAIL — {n} metric(s) regressed' if n else 'PASS'}")
    return "\n".join(lines)


# -- report loading (shared with cli/trace.py) -------------------------------

def load_cost_report(target: str, per_chip_batch: Optional[int] = None):
    """(report, error) from `target`: a saved cost report (its
    COST_REPORT_TAG, plain or under the combined --baseline shape
    {"report": {...}}), or a DDP bench artifact with strategies rows
    (attribution-only report, framework-free). Anything else errors."""
    try:
        with open(target) as f:
            head = json.load(f)
    except OSError as e:
        return None, f"{target}: {e}"
    except ValueError as e:
        return None, f"{target}: not a JSON document ({e})"
    if not isinstance(head, dict):
        return None, f"{target}: not a JSON object"
    if head.get("report") == COST_REPORT_TAG:
        return head, None
    nested = head.get("report")
    if isinstance(nested, dict) and nested.get("report") == COST_REPORT_TAG:
        return nested, None
    if isinstance(head.get("strategies"), list):
        att = attribution_from_artifact(head, per_chip_batch)
        if not att:
            return None, (f"{target}: artifact carries no strategy rows "
                          f"the attribution can decompose (needs "
                          f"images_per_sec, scaling_efficiency_vs_1dev, "
                          f"collective_s_p50, n_devices > 1)")
        return build_cost_report(
            [], artifact=head, per_chip_batch=per_chip_batch,
            meta={"source": target}), None
    return None, (f"{target}: neither a {COST_REPORT_TAG} document nor a "
                  f"DDP bench artifact with strategies rows")


# -- the harvest front door (`trace cost`, cli/trace.py) ---------------------

def harvest_cli(a) -> int:
    """The `trace cost` subcommand body (argparse namespace from
    cli/trace.py): harvest the DDP matrix (+ the serve ladder) on
    `--device`, emit the records (JSONL trace when --telemetry, JSON
    artifact via -o), print the human report. Exit 1 when the artifact is
    unreadable or a program failed (its record names why)."""
    import os
    import sys

    import torch

    from . import disable, enable, flight, get_registry, get_tracer
    from .runtime import (collect_memory, install_compile_listener,
                          install_memory_watermarks, record_memory_point)

    # the measured artifact is read FIRST: a mistyped --artifact path must
    # fail in milliseconds, not after the harvest
    artifact = None
    if a.artifact:
        try:
            with open(a.artifact) as f:
                artifact = json.load(f)
        except OSError as e:
            print(f"trace cost: --artifact {e}", file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"trace cost: --artifact {a.artifact}: not a JSON "
                  f"document ({e})", file=sys.stderr)
            return 1
        if not isinstance(artifact, dict) \
                or not isinstance(artifact.get("strategies"), list):
            print(f"trace cost: --artifact {a.artifact}: not a DDP bench "
                  f"artifact (no strategies rows)", file=sys.stderr)
            return 1
    from ..cli.train import resolve_device
    device = resolve_device(a.device, "trace cost")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    reg = get_registry()
    install_compile_listener()
    install_memory_watermarks(reg)
    if a.telemetry:
        os.makedirs(a.telemetry, exist_ok=True)
        flight.set_dump_dir(a.telemetry)
        enable(a.telemetry, process_index=0)
    tracer = get_tracer()
    try:
        with tracer.span("cost_harvest", model=a.model,
                         param_scale=a.param_scale):
            forms = (("step", "run") if a.form == "both" else (a.form,))
            records = harvest_step_matrix(
                forms=forms, n_dev=a.n_devices, batch=a.batch,
                model=a.model, param_scale=a.param_scale, device=device)
            if a.serve_ladder:
                records.extend(harvest_serve_ladder(a.serve_max_batch,
                                                    device))
            emit_records(tracer, records)
            record_memory_point(tracer)
        meta = {
            "backend": device.type,
            "device_kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "torch_version": torch.__version__,
            "n_devices": a.n_devices,
            "model": a.model,
            "param_scale": a.param_scale,
            "batch_per_device": a.batch,
        }
        if a.artifact:
            meta["measured_artifact"] = a.artifact
        report = build_cost_report(records, artifact=artifact,
                                   per_chip_batch=a.per_chip_batch,
                                   meta=meta)
        collect_memory(reg)
        tracer.snapshot(reg)
    finally:
        if a.telemetry:
            disable()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"trace cost: wrote {len(report['records'])} record(s) to "
              f"{a.out}")
    print(format_cost_report(report))
    failed = [r for r in report["records"] if r.get("error")]
    if failed:
        for r in failed:
            print(f"trace cost: {r['program']}: {r['error']}",
                  file=sys.stderr)
        print(f"trace cost: {len(failed)} of {len(report['records'])} "
              f"program(s) failed on {device}", file=sys.stderr)
        return 1
    return 0
