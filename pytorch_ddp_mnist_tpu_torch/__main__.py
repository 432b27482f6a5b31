"""`python -m pytorch_ddp_mnist_tpu_torch <command>`: the port's front door.

    train      the serial and data-parallel trainer (cli/train.py;
               --parallel for the latter: over the local cards, or as one
               rank of a launcher's world of processes, e.g. `torchrun
               --nproc_per_node 4 -m pytorch_ddp_mnist_tpu_torch train
               --parallel`)
    bench      the single-card train benchmark (bench.py)

The JAX package's other commands (serve, trace, ledger, convert, download,
lint, audit-program) are not ported yet; naming one exits with a pointer
to ROADMAP.md.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": ("pytorch_ddp_mnist_tpu_torch.cli.train",
              "the serial and data-parallel trainer"),
    "bench": ("pytorch_ddp_mnist_tpu_torch.bench",
              "the single-card train benchmark"),
}
# the JAX package's commands still to port -> ROADMAP.md queue 1 item
_NOT_YET_PORTED = {
    "serve": 9, "trace": 12, "ledger": 12, "convert": 1, "download": 1,
    "lint": 14, "audit-program": 14,
}


def main(argv=None) -> int:
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
    return mod.main(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
