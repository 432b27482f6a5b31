"""Serving CLI: turn a training checkpoint into a running inference service
on the card (port of `pytorch_ddp_mnist_tpu/cli/serve.py`).

    python -m pytorch_ddp_mnist_tpu_torch serve [--checkpoint model.pt]
        [--device 0|cpu] [--max_batch 64] [--max_delay_ms 2]
        [--queue_depth 256] [--admit depth|predicted_p99] [--slo_p99_ms 50]
        [--input_dtype float32|uint8] [--telemetry DIR] [--no_fast]
        [--mesh] [--replicas 1] [--wedge_timeout_ms 250]
        [--retry_budget 2] [--reload_dir DIR] [--host 127.0.0.1] [--port 0]
        [--selftest N [--offered_rps 500] [--shape poisson|ramp|spike]]

Two front doors over the same request path (`serve.ServeService`, or
`serve.FleetService` when `--replicas` > 1 or `--reload_dir` is set):

* default: a newline-delimited-JSON TCP server. One request per line,
  `{"pixels": [784 numbers]}` -> `{"ok": true, "pred": k}`;
  `{"op": "metrics"}` -> the serving dashboard snapshot; `{"op": "stats"}`
  -> the telemetry registry snapshot (serve counters, latency and stage
  histograms, the engine's capture count) alongside the dashboard;
  `{"op": "health"}` -> the live SLO view (rolling-window p99, observed
  service rate, predicted p99, queue depth; a fleet adds its `fleet`
  block: replica states, degradation, the failover, restart and reload
  counters). Backpressure rejections
  answer `{"ok": false, "error": ..., "retry_after_ms": ...}` without
  closing the connection. `--port 0` binds an ephemeral port and prints
  `serving on HOST:PORT` (stderr). SIGINT/SIGTERM triggers the graceful
  drain, then the final metrics snapshot prints.
* `--selftest N`: no socket — drive N open-loop requests through the full
  admission/batcher/engine path in-process and print the metrics snapshot
  as one JSON line.

The engine runs on CUDA device `--device` (default 0), one CUDA graph per
bucket captured at start; with no card it exits and names the missing card
unless `--device cpu` asks for the CPU, where the same path runs the
forward eagerly. Without `--checkpoint` it serves `--seed`'s weights (the
JAX package's `init_mlp(jax.random.key(seed))`, bit for bit);
`--checkpoint` reads a reference-layout `.pt` / `.pth` (the port's, the
JAX package's or the reference's own). `--telemetry DIR` writes schema-v1
request/batch spans under DIR and a flight-recorder dump at the drain.
`--mesh` with one visible card is the single-card engine, as a one-device
JAX mesh is.

`--replicas N` serves N engines on the card, each with its own stream
and captured bucket graphs, behind the one admission layer (serve/
fleet.py): least-inflight routing, a watchdog that quarantines a replica
whose oldest in-flight batch ages past `--wedge_timeout_ms`, failover of
its requests under `--retry_budget` extra attempts, and an off-loop
restart. `--reload_dir DIR` (TCP mode only) runs the hot-reload watcher
(serve/reload.py) beside the server: a step checkpoint newly committed
under DIR (train/ckpt_manager.py's layout, either package's) is swapped
in behind per-replica drains, and a torn or non-finite one is refused by
name while the incumbent serves. `$PDMT_FAULT` arms the serve fault
points (utils/faultpoints.py: `engine_crash`, `engine_wedge`,
`reload_torn`); a spec that does not parse exits naming it.

Refused by name: `--mesh` over more than one card (ROADMAP.md queue 1,
item 7, blocked on hardware). `--checkpoint` takes the reference's
`.pt`/`.pth`, a `.npz` params tree or a flax `.msgpack` (the JAX
package's or the trainer's).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np
import torch

def initial_params(a):
    """The weights generation 0 serves: the --checkpoint file or a fresh
    --seed init (the JAX package's `init_mlp(jax.random.key(seed))`)."""
    from ..models.mlp import init_params
    from ..train.checkpoint import load_checkpoint
    if a.checkpoint:
        return load_checkpoint(a.checkpoint, init_params(0))
    return init_params(a.seed)


def engine_builder(a, device: torch.device):
    """`build(params) -> InferenceEngine` with the CLI's geometry on
    `device`: called once for a single-engine service, N times (and per
    restart and reload generation) by `FleetService`."""
    from ..serve import InferenceEngine

    def build(params):
        return InferenceEngine(params, max_batch=a.max_batch, device=device,
                               input_dtype=a.input_dtype)
    return build


async def handle_request(service, req: dict) -> dict:
    """One JSON request -> one JSON response dict (the protocol core,
    transport-free so tests drive it without a socket):

      {"pixels": [...784...]}  -> {"ok": true, "pred": k}
      {"op": "metrics"}        -> the serving dashboard snapshot
      {"op": "stats"}          -> {"registry": <registry snapshot>,
                                   "serve": <dashboard snapshot>}
      {"op": "health"}         -> the live SLO view (and the `fleet`
                                  block of a fleet)
    """
    op = req.get("op")
    if op == "metrics":
        return {"ok": True, **service.metrics.snapshot()}
    if op == "stats":
        return {"ok": True, "registry": service.metrics.registry.snapshot(),
                "serve": service.metrics.snapshot()}
    if op == "health":
        pred = service.metrics.predicted_p99()
        health = {**service.metrics.slo.snapshot(),
                  "predicted_p99_ms": (round(pred * 1e3, 3)
                                       if pred is not None else None),
                  "queue_depth": service.admission.depth,
                  "draining": service.admission.draining}
        # a fleet front door also answers replica states, degradation and
        # the failover/restart/reload counters
        fleet_snap = getattr(service, "fleet_snapshot", None)
        if fleet_snap is not None:
            health["fleet"] = fleet_snap()
        return {"ok": True, "health": health}
    pixels = np.asarray(req["pixels"])
    return {"ok": True, "pred": await service.handle(pixels)}


async def _handle_conn(service, reader, writer):
    from ..serve import Rejected
    while True:
        line = await reader.readline()
        if not line:
            break
        try:
            resp = await handle_request(service, json.loads(line))
        except Rejected as e:
            resp = {"ok": False, "error": e.reason,
                    "retry_after_ms": round(e.retry_after_s * 1e3, 1)}
        except Exception as e:  # malformed request: answer, don't die
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        writer.write((json.dumps(resp) + "\n").encode())
        await writer.drain()
    writer.close()


async def _serve_tcp(service, host: str, port: int,
                     reload_dir: str | None = None) -> None:
    import signal

    watcher = None
    if reload_dir:
        from ..serve import ReloadWatcher
        watcher = ReloadWatcher(service, reload_dir)
        watcher.start()
        print(f"reload watcher: polling {reload_dir} every "
              f"{watcher.poll_interval_s}s (serving step "
              f"{service.serving_step})", file=sys.stderr, flush=True)
    server = await asyncio.start_server(
        lambda r, w: _handle_conn(service, r, w), host, port)
    bound = server.sockets[0].getsockname()
    print(f"serving on {bound[0]}:{bound[1]}", file=sys.stderr, flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix event loop
            pass
    await stop.wait()
    print("drain: refusing new requests, finishing in-flight ones",
          file=sys.stderr, flush=True)
    if watcher is not None:   # no swap may start once the drain begins
        await watcher.stop()
    await service.shutdown()
    server.close()
    await server.wait_closed()
    # Post-mortem: the admission reject ring is only non-empty when this
    # server refused requests — flush it so an overloaded-then-killed server
    # leaves WHO it turned away, not just the aggregate counter.
    from ..telemetry import flight
    dump = flight.dump(reason="serve drain")
    if dump:
        print(f"flight recorder: {dump}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="params checkpoint to serve (the reference's "
                        ".pt/.pth, a .npz params tree, or a flax .msgpack); "
                        "default: fresh --seed init")
    p.add_argument("--seed", type=int, default=0,
                   help="init seed when no --checkpoint is given")
    p.add_argument("--device", default="0",
                   help="CUDA device ordinal, or 'cpu'")
    p.add_argument("--max_batch", type=int, default=64,
                   help="largest coalesced batch = top bucket (powers of "
                        "two up to it are captured)")
    p.add_argument("--max_delay_ms", type=float, default=2.0,
                   help="longest a request waits for coalescing partners "
                        "before its batch flushes anyway")
    p.add_argument("--queue_depth", type=int, default=256,
                   help="admission budget: in-flight requests beyond this "
                        "are rejected with a retry-after hint")
    p.add_argument("--admit", choices=("depth", "predicted_p99"),
                   default="depth",
                   help="admission mode: raw queue-depth budget, or reject "
                        "when the PREDICTED p99 would bust --slo_p99_ms")
    p.add_argument("--slo_p99_ms", type=float, default=50.0,
                   help="the p99 SLO (ms) the predicted_p99 admission mode "
                        "protects; ignored under --admit depth")
    p.add_argument("--telemetry", default=None, metavar="DIR",
                   help="emit request/batch spans (schema-v1 JSONL) and "
                        "drain-time flight dumps under DIR")
    p.add_argument("--input_dtype", choices=("float32", "uint8"),
                   default="float32",
                   help="request payload dtype: pre-normalized float32 "
                        "rows, or raw uint8 pixels normalized on the card")
    p.add_argument("--mesh", action="store_true",
                   help="replicate over every visible card; one card is the "
                        "single-card engine")
    p.add_argument("--no_fast", dest="fast", action="store_false",
                   help="force the legacy stack-at-flush batcher instead "
                        "of the staged fast path")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas on the card behind the shared "
                        "admission layer; >1 enables SLO-aware routing, the "
                        "wedge watchdog and bounded request failover")
    p.add_argument("--reload_dir", default=None, metavar="DIR",
                   help="watch this checkpoint directory (train/"
                        "ckpt_manager layout) and hot-swap replicas to "
                        "newly committed steps behind per-replica drains; "
                        "torn/non-finite candidates are refused by name "
                        "while the incumbent keeps serving (TCP mode only)")
    p.add_argument("--wedge_timeout_ms", type=float, default=250.0,
                   help="fleet watchdog: a replica whose oldest in-flight "
                        "batch ages past this is quarantined, its requests "
                        "failed over to a survivor, and it is restarted")
    p.add_argument("--retry_budget", type=int, default=2,
                   help="failover attempts per admitted request before it "
                        "errors out")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = ephemeral; the bound port prints "
                        "to stderr)")
    p.add_argument("--selftest", type=int, default=None, metavar="N",
                   help="serve N open-loop requests in-process and print "
                        "the metrics snapshot (no socket)")
    p.add_argument("--offered_rps", type=float, default=500.0,
                   help="--selftest arrival rate")
    p.add_argument("--shape", choices=("poisson", "ramp", "spike"),
                   default="poisson",
                   help="--selftest arrival shape: homogeneous poisson, a "
                        "0.2x->1.8x linear ramp, or a 3x mid-run burst")
    a = p.parse_args(argv)
    for name in ("max_batch", "queue_depth", "replicas"):
        if getattr(a, name) < 1:
            p.error(f"--{name} must be >= 1")
    if a.max_delay_ms < 0:
        p.error("--max_delay_ms must be >= 0")
    if a.admit == "predicted_p99" and a.slo_p99_ms <= 0:
        p.error("--slo_p99_ms must be > 0 under --admit predicted_p99")
    if a.selftest is not None and a.selftest < 1:
        p.error("--selftest must be >= 1")
    if a.offered_rps <= 0:
        p.error("--offered_rps must be > 0")
    if a.wedge_timeout_ms <= 0:
        p.error("--wedge_timeout_ms must be > 0")
    if a.retry_budget < 0:
        p.error("--retry_budget must be >= 0")
    if a.reload_dir and a.selftest is not None:
        p.error("--reload_dir needs the TCP server (the watcher lives on "
                "its event loop); drop --selftest")
    from ..utils import faultpoints
    try:
        faultpoints.install()          # $PDMT_FAULT, parsed before any work
    except faultpoints.FaultSpecError as e:
        raise SystemExit(f"{faultpoints.FAULT_ENV}: {e}") from None
    from .train import resolve_device
    device = resolve_device(a.device, "serve")
    if a.mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise SystemExit(
            f"--mesh: {torch.cuda.device_count()} cards are visible; an "
            f"engine replicated across cards is not ported yet (ROADMAP.md "
            f"queue 1, item 7: blocked on hardware). One visible card is "
            f"the single-card engine")

    from .. import telemetry
    from ..serve import FleetService, ServeService
    from ..telemetry import flight
    reg = telemetry.get_registry()
    if a.telemetry:
        # request/batch spans into DIR before the first request, and the
        # flight recorder's drain dump beside them
        telemetry.enable(a.telemetry)
        flight.set_dump_dir(a.telemetry)
    common = dict(max_delay_ms=a.max_delay_ms, max_depth=a.queue_depth,
                  registry=reg, admit_mode=a.admit,
                  slo_p99_s=(a.slo_p99_ms / 1e3
                             if a.admit == "predicted_p99" else None),
                  fast=a.fast)
    try:
        params = initial_params(a)
        if a.replicas > 1 or a.reload_dir:
            # N replicas (or 1 + hot reload, which still needs the fleet's
            # drain-and-swap) behind the same admission layer
            service = FleetService(
                engine_builder(a, device), params, n_replicas=a.replicas,
                max_batch=a.max_batch,
                wedge_timeout_s=a.wedge_timeout_ms / 1e3,
                retry_budget=a.retry_budget, **common)
            engine = service.engine
        else:
            engine = engine_builder(a, device)(params)
            service = ServeService(engine, **common)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    reg.counter("serve.engine_captures").set_total(engine.capture_count)
    print(f"engine warm: device={device} buckets={list(engine.buckets)} "
          f"captures={engine.capture_count} "
          f"input_dtype={engine.input_dtype} admit={a.admit} "
          f"replicas={a.replicas} "
          f"fast={'on' if service.batcher.fast_path else 'off'}",
          file=sys.stderr, flush=True)

    def _close_telemetry(reason: str, dump: bool = True) -> None:
        """Stamp the final registry snapshot (check_telemetry --require
        serve. gates on it), flush the flight ring (skipped when the TCP
        drain already dumped it), close the JSONL file."""
        if not a.telemetry:
            return
        telemetry.get_tracer().snapshot(reg)
        if dump:
            path = flight.dump(reason=reason)
            if path:
                print(f"flight recorder: {path}", file=sys.stderr,
                      flush=True)
        telemetry.disable()

    if a.selftest is not None:
        from ..serve.loadgen import run_loadgen
        out = run_loadgen(service, offered_rps=a.offered_rps,
                          n_requests=a.selftest, seed=a.seed, shape=a.shape)
        out.pop("predictions")          # counters, not payloads
        _close_telemetry("serve selftest")
        print(json.dumps(out))
        return 0

    asyncio.run(_serve_tcp(service, a.host, a.port,
                           reload_dir=a.reload_dir))
    _close_telemetry("serve drain", dump=False)  # _serve_tcp just dumped
    print(json.dumps(service.metrics.snapshot()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
