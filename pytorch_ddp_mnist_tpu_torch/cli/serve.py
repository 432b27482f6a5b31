"""Serving CLI: turn a training checkpoint into a running inference service
on the card (port of `pytorch_ddp_mnist_tpu/cli/serve.py`).

    python -m pytorch_ddp_mnist_tpu_torch serve [--checkpoint model.pt]
        [--device 0|cpu] [--max_batch 64] [--max_delay_ms 2]
        [--queue_depth 256] [--admit depth|predicted_p99] [--slo_p99_ms 50]
        [--input_dtype float32|uint8] [--telemetry DIR] [--no_fast]
        [--mesh] [--host 127.0.0.1] [--port 0]
        [--selftest N [--offered_rps 500] [--shape poisson|ramp|spike]]

Two front doors over the same `serve.ServeService` request path:

* default: a newline-delimited-JSON TCP server. One request per line,
  `{"pixels": [784 numbers]}` -> `{"ok": true, "pred": k}`;
  `{"op": "metrics"}` -> the serving dashboard snapshot; `{"op": "stats"}`
  -> the telemetry registry snapshot (serve counters, latency and stage
  histograms, the engine's capture count) alongside the dashboard;
  `{"op": "health"}` -> the live SLO view (rolling-window p99, observed
  service rate, predicted p99, queue depth). Backpressure rejections
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

Refused by name, each with the ROADMAP.md item that owns it: `--replicas`
> 1, `--wedge_timeout_ms` and `--retry_budget` (the replica fleet, queue 1
item 9b), `--reload_dir` (hot reload, item 9b), a `$PDMT_FAULT` (the serve
fault points `engine_crash`, `engine_wedge` and `reload_torn` fire in the
fleet and hot reload: item 9b), `--mesh` over more than one card (item 7,
blocked on hardware). `--checkpoint` takes the reference's `.pt`/`.pth`,
a `.npz` params tree or a flax `.msgpack` (the JAX package's or the
trainer's).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

import numpy as np
import torch

def build_engine(a, device: torch.device):
    """The InferenceEngine of the CLI's geometry on `device`: the
    --checkpoint's weights or --seed's."""
    from ..serve import InferenceEngine
    kw = dict(max_batch=a.max_batch, device=device,
              input_dtype=a.input_dtype)
    if a.checkpoint:
        return InferenceEngine.from_checkpoint(a.checkpoint, **kw)
    return InferenceEngine.from_seed(a.seed, **kw)


async def handle_request(service, req: dict) -> dict:
    """One JSON request -> one JSON response dict (the protocol core,
    transport-free so tests drive it without a socket):

      {"pixels": [...784...]}  -> {"ok": true, "pred": k}
      {"op": "metrics"}        -> the serving dashboard snapshot
      {"op": "stats"}          -> {"registry": <registry snapshot>,
                                   "serve": <dashboard snapshot>}
      {"op": "health"}         -> the live SLO view
    """
    op = req.get("op")
    if op == "metrics":
        return {"ok": True, **service.metrics.snapshot()}
    if op == "stats":
        return {"ok": True, "registry": service.metrics.registry.snapshot(),
                "serve": service.metrics.snapshot()}
    if op == "health":
        pred = service.metrics.predicted_p99()
        return {"ok": True, "health": {
            **service.metrics.slo.snapshot(),
            "predicted_p99_ms": (round(pred * 1e3, 3) if pred is not None
                                 else None),
            "queue_depth": service.admission.depth,
            "draining": service.admission.draining}}
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


async def _serve_tcp(service, host: str, port: int) -> None:
    import signal

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


def refusals(a) -> None:
    """The JAX serve path's features that wait for unported modules, each
    refused by name with its ROADMAP.md item."""
    where = "not ported to the PyTorch package yet; see ROADMAP.md queue 1"
    if a.replicas > 1:
        raise SystemExit(f"--replicas {a.replicas}: the replica fleet "
                         f"(serve/fleet.py) is {where}, item 9b")
    for flag in ("wedge_timeout_ms", "retry_budget"):
        if getattr(a, flag) is not None:
            raise SystemExit(f"--{flag} is a knob of the replica fleet "
                             f"(serve/fleet.py), which is {where}, item 9b")
    if a.reload_dir:
        raise SystemExit(f"--reload_dir: hot reload (serve/reload.py) is "
                         f"{where}, item 9b")
    fault = os.environ.get("PDMT_FAULT", "")
    if fault:
        raise SystemExit(f"PDMT_FAULT={fault!r}: the serve fault points "
                         f"(utils/faultpoints.py: engine_crash, engine_wedge, "
                         f"reload_torn) fire in the replica fleet and hot "
                         f"reload, which are {where}, item 9b")


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
                   help="engine replicas (the fleet; refused by name)")
    p.add_argument("--reload_dir", default=None, metavar="DIR",
                   help="hot reload (refused by name)")
    p.add_argument("--wedge_timeout_ms", type=float, default=None,
                   help="fleet watchdog (refused by name)")
    p.add_argument("--retry_budget", type=int, default=None,
                   help="fleet failover budget (refused by name)")
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
    refusals(a)
    from .train import resolve_device
    device = resolve_device(a.device, "serve")
    if a.mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise SystemExit(
            f"--mesh: {torch.cuda.device_count()} cards are visible; an "
            f"engine replicated across cards is not ported yet (ROADMAP.md "
            f"queue 1, item 7: blocked on hardware). One visible card is "
            f"the single-card engine")

    from .. import telemetry
    from ..serve import ServeService
    from ..telemetry import flight
    reg = telemetry.get_registry()
    if a.telemetry:
        # request/batch spans into DIR before the first request, and the
        # flight recorder's drain dump beside them
        telemetry.enable(a.telemetry)
        flight.set_dump_dir(a.telemetry)
    try:
        engine = build_engine(a, device)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    service = ServeService(
        engine, max_delay_ms=a.max_delay_ms, max_depth=a.queue_depth,
        registry=reg, admit_mode=a.admit,
        slo_p99_s=(a.slo_p99_ms / 1e3 if a.admit == "predicted_p99"
                   else None),
        fast=a.fast)
    reg.counter("serve.engine_captures").set_total(engine.capture_count)
    print(f"engine warm: device={device} buckets={list(engine.buckets)} "
          f"captures={engine.capture_count} "
          f"input_dtype={engine.input_dtype} admit={a.admit} "
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

    asyncio.run(_serve_tcp(service, a.host, a.port))
    _close_telemetry("serve drain", dump=False)  # _serve_tcp just dumped
    print(json.dumps(service.metrics.snapshot()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
