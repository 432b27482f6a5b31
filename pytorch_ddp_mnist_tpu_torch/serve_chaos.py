"""Crash, wedge and torn-checkpoint-swap a replica fleet under open-loop
load, and hold that nothing admitted was lost (the port's counterpart of
the JAX package's `scripts/serve_chaos_smoke.py`).

    python -m pytorch_ddp_mnist_tpu_torch.serve_chaos [--device 0|cpu]
        [--requests 200] [--offered_rps 800] [--max_batch 16]
        [--workdir DIR]

The fleet's engines run on the card (`--device`, default 0) or, with
`--device cpu`, on the CPU. Three legs, all under one telemetry trace:

  1. kill-mid-burst: a 2-replica fleet serves a spike-shaped open-loop
     burst while `engine_crash:after=2:replica=0` kills replica 0's engine
     mid-burst. Verdict: availability 1.0 (every admitted request
     answered), >= 1 crash, > 0 retried requests, every served pred
     bitwise a direct engine's on the same params, and every replica back
     healthy on its device after its restart;
  2. wedge-then-watchdog: `engine_wedge:delay_s=1.0:replica=1` hangs one
     dispatched batch; the watchdog must quarantine the replica, fail its
     requests over and restart it. The same verdict, with >= 1 wedge;
  3. torn-checkpoint-swap: a `ReloadWatcher` polls a checkpoint directory
     under background traffic: a good commit swaps every replica behind a
     drain; an injected `reload_torn` and an intact-but-NaN checkpoint are
     refused by name; a truncated newest payload makes the walk fall back
     to the newest intact step; a last good commit promotes. Verdict: 3
     reloads (one the torn fallback), 2 refusals, `serving_step` at the
     last good commit, no failed request.

Then the record contract (telemetry/analysis.py `trace_contract_errors`,
the port's copy of the JAX checker's fleet/reload contract) over the
trace, with the `serve.fleet.*` and `serve.reload.*` metrics required in
its final snapshot. Each leg reports the engines its fleet built
(construction, restarts and staged reloads), so a caller counting
captures can hold them to `len(buckets)` an engine. Exit code 0 when
every leg holds, 1 otherwise; the last line of stdout is the JSON verdict.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

N_REPLICAS = 2
MAX_BATCH = 16
WEDGE_TIMEOUT_S = 0.15
# how long a leg waits, after its load, for a quarantined replica's
# restart to finish before it reads the verdict
SETTLE_S = 30.0

# the per-leg counters: the legs share ONE registry (so the final
# snapshot carries serve.fleet.* for the contract), so each leg reads its
# own contribution as an after-minus-before delta
_LEG_COUNTERS = ("serve.completed", "serve.failed", "serve.rejected",
                 "serve.fleet.crashes", "serve.fleet.wedges",
                 "serve.fleet.retried_requests", "serve.fleet.restarts")


def _counter_values(reg) -> dict:
    snap = reg.snapshot()["counters"]
    return {k: snap.get(k, 0) for k in _LEG_COUNTERS}


def direct_predictions(params, rows, device, max_batch: int) -> list:
    """The parity target: every row alone through one untouched engine."""
    from .serve import InferenceEngine
    eng = InferenceEngine(params, max_batch=max_batch, device=device)
    preds = [int(eng.predict(np.stack([r]))[0]) for r in rows]
    eng.close()
    return preds


def make_fleet(params, registry, device, max_batch: int, built: list,
               **kw):
    """A 2-replica fleet whose builder appends each engine it makes to
    `built`."""
    from .serve import FleetService, InferenceEngine

    def build(p):
        eng = InferenceEngine(p, max_batch=max_batch, device=device)
        built.append(eng)
        return eng
    return FleetService(build, params, n_replicas=N_REPLICAS,
                        max_batch=max_batch, max_delay_ms=1.0,
                        registry=registry, wedge_timeout_s=WEDGE_TIMEOUT_S,
                        retry_budget=3, **kw)


async def settle(fleet, timeout_s: float = SETTLE_S) -> None:
    """Wait (bounded) until no replica is mid-restart."""
    from .serve.fleet import RESTARTING
    deadline = time.monotonic() + timeout_s
    while any(r.state == RESTARTING for r in fleet.replicas) \
            and time.monotonic() < deadline:
        await asyncio.sleep(0.01)


def _replica_problems(snap: dict, fleet, device) -> list:
    """A replica not healthy at the end of a leg, or whose engine is not on
    the leg's device (a restart that fell back to anything else)."""
    out = [f"replica {r['idx']} ended the leg {r['state']}"
           for r in snap["per_replica"] if r["state"] != "healthy"]
    out += [f"replica {rep.idx}'s engine is on {rep.engine.device}, not "
            f"{device}" for rep in fleet.replicas
            if rep.engine.device != device]
    return out


def load_leg(params, registry, expect: dict, *, fault: str, shape: str,
             requests: int, offered_rps: float, expect_direct: list,
             device, max_batch: int) -> dict:
    """Legs 1 and 2: inject `fault`, drive the open-loop generator through
    a fresh fleet, hold the served preds bitwise against the direct pass,
    and require no broken promise plus the leg's failure counters."""
    from .serve.loadgen import request_rows, run_open_loop
    from .utils import faultpoints

    before = _counter_values(registry)
    built: list = []
    rows = request_rows(requests, "float32", seed=1)
    faultpoints.install(fault)
    try:
        fleet = make_fleet(params, registry, device, max_batch, built)

        async def leg():
            try:
                out = await run_open_loop(fleet, offered_rps=offered_rps,
                                          n_requests=requests, seed=0,
                                          rows=rows, shape=shape)
                await settle(fleet)
                return out, fleet.fleet_snapshot()
            finally:
                await fleet.shutdown()

        out, snap = asyncio.run(leg())
    finally:
        faultpoints.install("")          # disarm before the next leg
    d = {k: v - before[k] for k, v in _counter_values(registry).items()}
    completed, failed = d["serve.completed"], d["serve.failed"]
    avail = completed / (completed + failed) if completed + failed else 0.0
    served = [p for p in out["predictions"] if p is not None]
    # rejects leave None and are honest backpressure; every SERVED pred
    # must be the direct engine's, bitwise
    mismatches = sum(1 for p, e in zip(out["predictions"], expect_direct)
                     if p is not None and p != e)
    verdict = {
        "fault": fault, "shape": shape, "requests": requests,
        "served": len(served), "rejected": d["serve.rejected"],
        "failed": failed, "availability": round(avail, 6),
        "crashes": d["serve.fleet.crashes"],
        "wedges": d["serve.fleet.wedges"],
        "retried_requests": d["serve.fleet.retried_requests"],
        "restarts": d["serve.fleet.restarts"],
        "bitwise_mismatches": mismatches,
        "engines_built": len(built),
        "p50_ms": out["latency_ms"]["p50"], "p99_ms": out["latency_ms"]["p99"],
    }
    problems = _replica_problems(snap, fleet, device)
    if failed:
        problems.append(f"{failed} admitted requests failed")
    if avail < 1.0:
        problems.append(f"availability {avail:.6f} < 1.0")
    if mismatches:
        problems.append(f"{mismatches} served predictions diverged from "
                        f"the direct engine")
    for counter, floor in expect.items():
        if d[f"serve.fleet.{counter}"] < floor:
            problems.append(f"{counter}={d[f'serve.fleet.{counter}']} < "
                            f"expected >= {floor}")
    if d["serve.fleet.retried_requests"] < 1:
        problems.append("no request was ever failed over (the fault never "
                        "bit, or the failover path is dead)")
    if len(built) != N_REPLICAS + d["serve.fleet.restarts"]:
        problems.append(f"{len(built)} engines built for {N_REPLICAS} "
                        f"replicas and {d['serve.fleet.restarts']} restarts")
    verdict["problems"] = problems
    return verdict


def _truncate(path: str, n: int) -> None:
    with open(path, "r+b") as f:
        f.truncate(n)


async def reload_leg(params, params_new, registry, ckpt_dir: str, device,
                     max_batch: int) -> dict:
    """Leg 3: hot reload under traffic: a good swap, the injected-torn,
    truly-torn and NaN candidates refused or passed over by name, then a
    last good swap."""
    from .serve.loadgen import request_rows
    from .serve.reload import ReloadWatcher
    from .train.ckpt_manager import CheckpointManager
    from .utils import faultpoints

    mgr = CheckpointManager(ckpt_dir)
    key = np.zeros(2, np.uint32)
    built: list = []
    fleet = make_fleet(params, registry, device, max_batch, built,
                       serving_step=0)
    watcher = ReloadWatcher(fleet, ckpt_dir)
    rows = request_rows(64, "float32", seed=2)
    served = {"n": 0, "errors": 0}
    stop = asyncio.Event()

    def save(p, step):
        mgr.save(p, key, "threefry2x32", step=step, epoch=0, offset=0)

    async def traffic():
        i = 0
        while not stop.is_set():
            try:
                await fleet.handle(rows[i % len(rows)])
                served["n"] += 1
            except Exception:   # noqa: BLE001 — the verdict counts these
                served["errors"] += 1
            i += 1
            await asyncio.sleep(0.002)

    async def poll():
        """One watcher cycle, then a few more requests answered: the
        verdicts interleave with traffic wherever a cycle is quick."""
        verdict = await watcher.poll_once()
        want = served["n"] + served["errors"] + 4
        deadline = time.monotonic() + SETTLE_S
        while served["n"] + served["errors"] < want \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.002)
        return verdict

    loop = asyncio.get_running_loop()
    problems = []
    t = loop.create_task(traffic())
    try:
        # 1. good commit -> hot swap behind per-replica drains
        await loop.run_in_executor(None, save, params_new, 1)
        if await poll() != "reloaded":
            problems.append("good step 1 did not reload")
        # 2. injected validation fault: refused by name, incumbent kept
        await loop.run_in_executor(None, save, params_new, 2)
        faultpoints.install("reload_torn:times=1")
        try:
            if await poll() != "refused":
                problems.append("injected reload_torn was not refused")
        finally:
            faultpoints.install("")
        # ...and step 2 stays refused BY STEP, never re-validated
        if await poll() != "idle":
            problems.append("refused step 2 was reconsidered")
        # 3. a truly torn payload: the newer commit reopens the question
        # and the walk falls back past the torn step 3 to step 2, whose
        # refusal was the transient injected fault
        await loop.run_in_executor(None, save, params_new, 3)
        payload = glob.glob(os.path.join(ckpt_dir, "*3*.msgpack"))[0]
        await loop.run_in_executor(None, _truncate, payload, 16)
        if await poll() != "reloaded":
            problems.append("torn step 3 did not fall back to the intact "
                            "step 2")
        if fleet.serving_step != 2:
            problems.append(f"torn-fallback serving_step "
                            f"{fleet.serving_step} != 2")
        # 4. intact but non-finite: with only the torn 3 and the NaN 4
        # beyond serving, nothing is promotable
        p_nan = {n: {k: torch.full_like(torch.as_tensor(v), float("nan"))
                     for k, v in layer.items()}
                 for n, layer in params_new.items()}
        await loop.run_in_executor(None, save, p_nan, 4)
        if await poll() != "refused":
            problems.append("NaN step 4 was not refused")
        if fleet.serving_step != 2:
            problems.append(f"refusals moved serving_step to "
                            f"{fleet.serving_step} (expected 2)")
        # 5. a last good commit promotes past the wreckage
        await loop.run_in_executor(None, save, params_new, 5)
        if await poll() != "reloaded":
            problems.append("good step 5 did not reload")
        if fleet.serving_step != 5:
            problems.append(f"serving_step {fleet.serving_step} != 5")
    finally:
        stop.set()
        await t
        await watcher.stop()
        snap = fleet.fleet_snapshot()
        last_reload_s = registry.gauge("serve.reload.last_reload_s").value
        await fleet.shutdown()
    problems += _replica_problems(snap, fleet, device)
    if served["errors"]:
        problems.append(f"{served['errors']} requests failed during the "
                        f"reload cycle")
    if served["n"] < 10:
        problems.append(f"only {served['n']} requests flowed: the leg never "
                        f"ran under traffic")
    if watcher.reloads != 3:
        problems.append(f"reloads={watcher.reloads} != 3")
    if watcher.refused != 2:
        problems.append(f"refused={watcher.refused} != 2")
    if len(built) != N_REPLICAS * (1 + watcher.reloads):
        problems.append(f"{len(built)} engines built for {N_REPLICAS} "
                        f"replicas and {watcher.reloads} reloads")
    n = served["n"] + served["errors"]
    return {
        "served_during_reloads": served["n"], "failed": served["errors"],
        "availability": round(served["n"] / n, 6) if n else 0.0,
        "reloads": watcher.reloads, "refused": watcher.refused,
        "serving_step": fleet.serving_step,
        "generation": snap["generation"], "engines_built": len(built),
        "last_reload_s": last_reload_s, "problems": problems,
    }


def run(device, *, requests: int = 200, offered_rps: float = 800.0,
        max_batch: int = MAX_BATCH, workdir: str) -> dict:
    """The three legs and the record contract on `device`, with the trace
    and the checkpoints under `workdir`; returns the verdict (its
    "serve_chaos" key is "ok" or "fail", its "problems" what failed)."""
    from . import telemetry
    from .models.mlp import init_params
    from .serve.loadgen import request_rows
    from .telemetry import flight
    from .telemetry.analysis import trace_contract_errors

    device = torch.device(device)
    tel_dir = os.path.join(workdir, "telemetry")
    ckpt_dir = os.path.join(workdir, "ckpts")
    os.makedirs(ckpt_dir, exist_ok=True)
    reg = telemetry.MetricsRegistry()
    telemetry.enable(tel_dir)
    flight.set_dump_dir(tel_dir)
    params, params_new = init_params(0), init_params(1)
    t0 = time.monotonic()
    try:
        direct = direct_predictions(
            params, request_rows(requests, "float32", seed=1), device,
            max_batch)
        common = dict(requests=requests, offered_rps=offered_rps,
                      expect_direct=direct, device=device,
                      max_batch=max_batch)
        legs = {
            # replica 0's engine crashes at its 2nd launch, mid-burst
            "kill_mid_burst": load_leg(
                params, reg, {"crashes": 1},
                fault="engine_crash:after=2:replica=0", shape="spike",
                **common),
            # replica 1 wedges a dispatched batch for 1 s; the watchdog
            # must fail it over within WEDGE_TIMEOUT_S
            "wedge_then_watchdog": load_leg(
                params, reg, {"wedges": 1},
                fault="engine_wedge:delay_s=1.0:replica=1", shape="poisson",
                **common),
            "torn_checkpoint_swap": asyncio.run(reload_leg(
                params, params_new, reg, ckpt_dir, device, max_batch)),
        }
        telemetry.get_tracer().snapshot(reg)
        flight.dump(reason="serve chaos")
    finally:
        telemetry.disable()
        flight.set_dump_dir(None)
    contract = trace_contract_errors(
        tel_dir, require=("serve.fleet.", "serve.reload."))
    problems = [f"{leg}: {p}" for leg, v in legs.items()
                for p in v.pop("problems")]
    problems += [f"record contract: {e}" for e in contract]
    verdict = {
        "serve_chaos": "fail" if problems else "ok",
        "device": str(device),
        "replicas": N_REPLICAS, "max_batch": max_batch,
        "wedge_timeout_s": WEDGE_TIMEOUT_S,
        # the worst availability across legs: what the fleet holds at 1.0
        "availability": min(v["availability"] for v in legs.values()),
        "legs": legs,
        "record_contract": "validated" if not contract else "FAILED",
        "dur_s": round(time.monotonic() - t0, 2),
    }
    if problems:
        verdict["problems"] = problems
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch.serve_chaos",
        description="replica-fleet crash/wedge/hot-reload chaos")
    ap.add_argument("--device", default="0",
                    help="the engines' CUDA ordinal, or cpu")
    ap.add_argument("--requests", type=int, default=200,
                    help="open-loop requests per load leg")
    ap.add_argument("--offered_rps", type=float, default=800.0)
    ap.add_argument("--max_batch", type=int, default=MAX_BATCH,
                    help="each engine's largest bucket")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: a fresh temp dir, "
                         "removed after a run that holds)")
    a = ap.parse_args(argv)
    from .cli.train import resolve_device
    device = resolve_device(a.device, "serve_chaos")
    work = a.workdir or tempfile.mkdtemp(prefix="pdmt_serve_chaos_")
    os.makedirs(work, exist_ok=True)
    verdict = run(device, requests=a.requests, offered_rps=a.offered_rps,
                  max_batch=a.max_batch, workdir=work)
    for p in verdict.get("problems", ()):
        print(f"serve_chaos: FAIL — {p}", file=sys.stderr)
    print(json.dumps(verdict))
    ok = verdict["serve_chaos"] == "ok"
    if ok and a.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
