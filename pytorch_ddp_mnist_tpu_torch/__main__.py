"""`python -m pytorch_ddp_mnist_tpu_torch <command>`: the port's front door.

    train      the serial and data-parallel trainer (cli/train.py;
               --parallel for the latter: over the local cards, or as one
               rank of a launcher's world of processes, e.g. `torchrun
               --nproc_per_node 4 -m pytorch_ddp_mnist_tpu_torch train
               --parallel`)
    bench      the single-card benchmark: train, stream, accuracy, eval,
               serve (bench.py)
    convert    IDX (or --synthetic N:M) -> mnist_{train,test}_images.nc
               (data/convert.py)
    download   the MNIST IDX files from the mirrors, checksum-verified
               (data/download.py)
    serve      the micro-batching inference server on the card: TCP
               JSON lines or --selftest N (cli/serve.py)
    trace      report / gate / Perfetto-export the JSONL traces a
               --telemetry run writes, and harvest the program cost
               records on the card (cli/trace.py)
    ledger     the performance ledger: every artifact as one
               direction-aware history, the trajectory report, the trend
               gate (cli/ledger.py; exit 3 names the regressed series)

The JAX package's other commands (lint, audit-program) are not ported yet;
naming one exits with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": ("pytorch_ddp_mnist_tpu_torch.cli.train",
              "the serial and data-parallel trainer"),
    "bench": ("pytorch_ddp_mnist_tpu_torch.bench",
              "the single-card benchmark: train, stream, accuracy, eval, "
              "serve"),
    "convert": ("pytorch_ddp_mnist_tpu_torch.data.convert",
                "IDX or synthetic MNIST -> CDF-5 NetCDF files"),
    "download": ("pytorch_ddp_mnist_tpu_torch.data.download",
                 "fetch the MNIST IDX files, checksum-verified"),
    "serve": ("pytorch_ddp_mnist_tpu_torch.cli.serve",
              "the micro-batching inference server"),
    "trace": ("pytorch_ddp_mnist_tpu_torch.cli.trace",
              "telemetry trace report / regression gate / Perfetto export "
              "/ program cost harvest"),
    "ledger": ("pytorch_ddp_mnist_tpu_torch.cli.ledger",
               "performance ledger: artifact history, trajectory report, "
               "trend gate"),
}
# the JAX package's commands still to port -> ROADMAP.md queue 1 item
_NOT_YET_PORTED = {"lint": 14, "audit-program": 14}


# commands whose main() reads the process's command line itself when given
# None: the trainer, whose outage retry may re-exec the process
_READS_COMMAND_LINE = ("train",)


def main(argv=None) -> int:
    command_line = argv is None
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        lines = [f"  {name:<10} {desc}  (python -m {mod})"
                 for name, (mod, desc) in _COMMANDS.items()]
        usage = ("usage: python -m pytorch_ddp_mnist_tpu_torch <command> "
                 "[args]\n\ncommands:\n" + "\n".join(lines))
        print(usage, file=sys.stdout if argv else sys.stderr)
        return 0 if argv else 2
    if argv[0] in _NOT_YET_PORTED:
        print(f"command {argv[0]!r} is not ported to the PyTorch package yet "
              f"(ROADMAP.md queue 1, item {_NOT_YET_PORTED[argv[0]]})",
              file=sys.stderr)
        return 2
    if argv[0] not in _COMMANDS:
        print(f"unknown command {argv[0]!r}; expected one of "
              f"{', '.join(_COMMANDS)}", file=sys.stderr)
        return 2
    import importlib
    mod = importlib.import_module(_COMMANDS[argv[0]][0])
    if command_line and argv[0] in _READS_COMMAND_LINE:
        return mod.main(None) or 0
    return mod.main(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
