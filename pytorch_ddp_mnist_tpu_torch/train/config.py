"""Config / CLI layer of the serial trainer (port of a subset of
`pytorch_ddp_mnist_tpu/train/config.py`, plus the `--kernel auto` policy of
`train/scan.py::resolve_kernel` and the JAX CLI's refusals of unsound
combinations of `--cached`, `--fused` and `--kernel pallas_epoch`), with
`--parallel` over the mesh of the local cards or over a world of processes
(`--wireup_method`, parallel/wireup.py), the data plane's `--netcdf` and
`--download`, the reference's own random streams (`--sampler_rng
torch`, `--dropout_rng torch`, `--eval_shuffle`), the input pipeline
(`--input_workers`, `--prefetch_depth`, `--num_workers`), the workload zoo
(`--model`, `--param_scale`) and the gradient-communication strategies
(`--ddp_comm`, `--overlap`, `--quant_block`, `--error_feedback`,
`--bf16_rounding`), with the JAX CLI's refusals of their combinations,
word for word, and its rule that resolves `--kernel auto` to `xla` for the
`xla`-only options; and the step checkpoints and their resume, fault
injection and outage retry (`--resume`, `--start_epoch`,
`--ckpt_every_steps`, `--ckpt_keep`, `--fault`, `--outage_retries`), with
the JAX CLI's refusals of those (`check_resume_knobs`); and the in-run
telemetry (`--telemetry`, `--health`, `--metrics_port`,
`--profile_dispatch`, `--journal`, `--profile`), with the JAX CLI's
refusals of those (`check_telemetry_knobs`, `check_resume_knobs`).

The ported flags keep the JAX trainer's names and defaults, so launch lines
carry over, except `--checkpoint`, which defaults to `model.pt` (the
reference's torch state_dict; `.npz` writes the params tree, and any other
path the JAX package's flax msgpack). `--hdf5` and `--label_map` are the
dead keys of the reference's config that the JAX trainer keeps for
launch-line parity, and so does this one. Every other flag of the JAX
trainer is recognised and rejected by name, with the ROADMAP.md item that
will port it: elastic training (item 13).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

from ..ops.epoch_step import EPOCH_KERNEL_MAX_BATCH
from ..parallel.wireup import METHOD_ALIASES, METHODS

# the JAX trainer's --wireup_method choices and the reference's spellings,
# which also name a backend (parallel/wireup.py); 'tpu' is refused by name
WIREUP_CHOICES = METHODS + tuple(METHOD_ALIASES) + ("tpu",)

# flag of the JAX trainer -> where ROADMAP.md queues its port
NOT_YET_PORTED = {
    "--elastic": "queue 1, item 13 (elastic training)",
    "--reshape": "queue 1, item 13 (elastic training)",
}


def configure(argv=None, *, cli=None) -> Dict[str, Dict[str, Any]]:
    """Parse CLI args into the nested {trainer: {...}, data: {...}} config.
    Exits by name on a flag or value that is not ported yet. `cli` is
    whether the trainer runs from the command line (default: `argv` is
    None), where an outage retry may re-exec the process."""
    p = argparse.ArgumentParser(
        prog="python -m pytorch_ddp_mnist_tpu_torch train",
        description="MNIST trainer, PyTorch/CUDA port of pytorch_ddp_mnist_tpu "
                    "(serial streaming path)", allow_abbrev=False)
    t = p.add_argument_group("trainer")
    t.add_argument("--batch_size", type=int, default=128)
    t.add_argument("--n_epochs", "--epochs", type=int, default=1)
    t.add_argument("--lr", type=float, default=0.01)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--parallel", action="store_true",
                   help="data-parallel: over a launcher's world of processes "
                        "(one replica a rank, on the card of its local rank "
                        "or on the CPU with --device cpu), else over the "
                        "mesh of every local CUDA card (one card is a "
                        "1-replica mesh) or one CPU replica with --device "
                        "cpu: the per-rank batch is --batch_size, the "
                        "per-step gradient mean is in fixed replica order")
    t.add_argument("--ddp-comm", "--ddp_comm", dest="ddp_comm",
                   choices=("pmean", "sharded", "bf16", "int8"),
                   default="pmean",
                   help="gradient-communication strategy for --parallel "
                        "(parallel/collectives.py): pmean (default, the "
                        "reference DDP step: the f32 mean, SGD on every "
                        "replica), sharded (bucketed reduce-scatter, SGD on "
                        "each replica's 1/N shard, params all-gather; "
                        "within rtol 1e-6 of pmean), bf16 (bf16 wire and "
                        "sum, f32 mean and update) or int8 (block-scaled "
                        "int8 on both phases with error-feedback residuals; "
                        "--quant_block / --error_feedback tune it). Every "
                        "mean is taken in fixed replica order")
    t.add_argument("--overlap", action="store_true",
                   help="bucket-pipeline the gradient collectives "
                        "(--parallel): one collective a gradient bucket "
                        "(arXiv:1711.00705). Composes with every --ddp_comm "
                        "strategy (sharded/int8 are bucketed already); plain "
                        "pmean without it stays the reference step. Needs "
                        "the plain autograd step (--kernel xla)")
    t.add_argument("--quant_block", type=int, default=None,
                   help="--ddp_comm int8 only: elements per int8 scaling "
                        "block (one f32 scale each; default 256). Refused "
                        "by name on other strategies")
    t.add_argument("--error_feedback", choices=("on", "off"), default="on",
                   help="--ddp_comm int8 only: carry each replica's "
                        "quantization error into the next step's gradients "
                        "(on, default) or drop it (off). Refused by name on "
                        "other strategies")
    t.add_argument("--model", choices=("mlp", "deep_mlp"), default="mlp",
                   help="model family (models/zoo.py): mlp (default, the "
                        "reference 784-128-128-10 MLP at --param_scale 1) "
                        "or deep_mlp (4 hidden layers). Other models than "
                        "the reference run the plain autograd step (--kernel "
                        "xla)")
    t.add_argument("--param_scale", type=int, default=1,
                   help="hidden-width multiplier for --model (128*N units)")
    t.add_argument("--bf16_rounding", choices=("nearest", "stochastic"),
                   default="nearest",
                   help="--ddp_comm bf16 only: round the gradients into the "
                        "bf16 cast to nearest even (default) or "
                        "stochastically (jax's threefry bits of each "
                        "replica's key). Refused by name on other "
                        "strategies")
    t.add_argument("--num_workers", type=int, default=0,
                   help="read-ahead threads of the --netcdf streaming "
                        "loader (the reference's DataLoader workers, "
                        "mnist_pnetcdf_cpu.py:58-60). Superseded by "
                        "--input_workers: passing both is refused by name")
    t.add_argument("--input_workers", type=int, default=0,
                   help="the staged input pipeline (pipeline/): N decode "
                        "threads feed the streaming loop through a reorder "
                        "buffer; batch order and the trained params stay "
                        "bitwise those of the synchronous default (0). "
                        "Refused by name with --cached")
    t.add_argument("--prefetch_depth", type=int, default=1,
                   help="the pipeline's copy lookahead: K batches' host-to-"
                        "device copies in flight while the current step "
                        "runs (1: the two-slot double buffer; the captured "
                        "step's slots are a ring of K + 1). With --cached "
                        "it makes the epochs' index arrays ahead instead; "
                        "--fused refuses a depth other than 1 by name")
    t.add_argument("--wireup_method", choices=WIREUP_CHOICES, default="auto",
                   help="how --parallel finds its world: auto (SLURM, Open "
                        "MPI, MPICH, then RANK/WORLD_SIZE, else one "
                        "process), single, slurm, openmpi, mpich, env; the "
                        "reference's nccl-slurm, nccl-openmpi, nccl-mpich "
                        "ask for NCCL and gloo for gloo")
    t.add_argument("--device", type=str, default="0",
                   help="CUDA device ordinal (default 0), or 'cpu' to run "
                        "the plain PyTorch versions of the kernels on the CPU")
    t.add_argument("--checkpoint", type=str, default="model.pt",
                   help="the run's params, saved after every epoch (rank 0): "
                        "the reference's torch state_dict (.pt/.pth), the "
                        "params tree (.npz), or the JAX package's flax "
                        "msgpack (any other path, e.g. model.msgpack); '' "
                        "skips the save")
    t.add_argument("--resume", type=str, default=None,
                   help="a checkpoint to start from: a file (any --checkpoint "
                        "format; pair with --start_epoch, and its .rng.npz "
                        "sidecar, written by the outage re-exec, restores "
                        "the key chain), or a step-checkpoint directory "
                        "(<--checkpoint>.steps/), whose newest intact "
                        "checkpoint gives params, key and position")
    t.add_argument("--start_epoch", type=int, default=0,
                   help="resume at this GLOBAL epoch: epochs [start_epoch, "
                        "n_epochs) run with their own shuffles and numbers; "
                        "pair with --resume of epoch start_epoch-1's "
                        "checkpoint")
    t.add_argument("--ckpt_every_steps", type=int, default=0,
                   help="crash-consistent step checkpoints "
                        "(train/ckpt_manager.py): every N steps of an epoch "
                        "and at its end, rank 0 commits params, key and "
                        "sampler position under <--checkpoint>.steps/ "
                        "(atomic, CRC-stamped, the JAX package's files); "
                        "--resume <that directory> continues bitwise. 0 "
                        "(default): none. Needs --checkpoint; refused with "
                        "--fused and --kernel pallas_epoch")
    t.add_argument("--ckpt_keep", type=int, default=3,
                   help="step checkpoints kept (the newest N; default 3)")
    t.add_argument("--fault", type=str, default=None, metavar="SPEC",
                   help="fault injection (utils/faultpoints.py), merged with "
                        "$PDMT_FAULT: comma-separated specs such as "
                        "'kill:rank=1:step=12', 'ckpt_save_io:step=3', "
                        "'loader_stall:batch=3:delay_s=0.5', "
                        "'collective_timeout', 'nan:step=5'")
    t.add_argument("--outage_retries", type=int, default=0,
                   help="retry a run that a lost card or peer interrupts, up "
                        "to N times: wait for the card "
                        "($PDMT_BACKEND_WAIT, default 1 h) and resume from "
                        "the last completed epoch, in the process or, where "
                        "its CUDA context is poisoned (and always with "
                        "--parallel), by persisting that state and "
                        "re-exec'ing with --resume/--start_epoch. 0 "
                        "(default): fail fast")
    t.add_argument("--telemetry", type=str, default=None, metavar="DIR",
                   help="write the JSONL event trace into DIR (per-epoch "
                        "spans with data_wait/step_compute/eval children, "
                        "the capture counter, memory watermarks, the "
                        "end-of-run registry snapshot), dump the flight "
                        "recorder there, and print a rank-0 [telemetry] "
                        "line; validate with scripts/check_telemetry.py "
                        "DIR. Adds no per-step host sync")
    t.add_argument("--journal", action="store_true",
                   help="write the per-rank collective journal beside the "
                        "trace (telemetry/cluster.py: one record a payload "
                        "collective of the DDP step, from its collective "
                        "schedule, with host stamps; the barriers and the "
                        "epoch's loss fetch bracketed) and run its hang "
                        "watchdog. Needs --telemetry and --parallel on the "
                        "streaming --kernel xla path; no device sync, "
                        "bitwise the unjournaled run")
    t.add_argument("--profile_dispatch", type=int, nargs="?", const=16,
                   default=0, metavar="K",
                   help="split the per-step host boundary into "
                        "python_prestep / dispatch / device_idle / "
                        "sync_wait (telemetry/dispatch.py) as dispatch.* "
                        "histograms, flight samples and per-epoch trace "
                        "points. K is the device-idle sampling period: "
                        "the probe drains the card on 1-in-K steps "
                        "(default 16). Needs --telemetry; refused with "
                        "--fused")
    t.add_argument("--health", choices=("off", "warn", "checkpoint-and-warn",
                                        "abort"), default="off",
                   help="live training-health watchdog "
                        "(telemetry/health.py) over the values the loop "
                        "already fetches (no extra per-step host sync): "
                        "loss spikes, NaN/Inf, grad-norm explosion, "
                        "update-ratio drift, throughput collapse, "
                        "straggler drift. The choice is the fatal-signal "
                        "policy: warn, checkpoint-and-warn (also save the "
                        "last good state under <--checkpoint>.steps/) or "
                        "abort (dump the flight ring and stop). Off by "
                        "default")
    t.add_argument("--metrics_port", type=int, default=None, metavar="PORT",
                   help="serve GET /metrics (the registry in Prometheus "
                        "text format) and GET /healthz (the health verdict, "
                        "503 after a fatal event) from a stdlib HTTP thread "
                        "on 127.0.0.1:PORT (rank 0; 0 = ephemeral, the "
                        "bound address prints to stderr)")
    t.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                   help="record the training run with torch.profiler into "
                        "LOGDIR as a Chrome trace (trace.<pid>.json)")
    t.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="bfloat16: bf16 operands of the products with f32 "
                        "master weights in the kernels (and the whole "
                        "forward/backward of --cached --kernel xla); the "
                        "streaming --kernel xla step trains in float32, as "
                        "the JAX trainer's does")
    t.add_argument("--kernel", choices=("auto", "xla", "pallas", "pallas_rng",
                                        "pallas_epoch"), default="auto",
                   help="train step: 'pallas' is the fused step (the CUDA "
                        "kernel on a card, its plain version on the CPU), "
                        "'pallas_rng' the fused step with its dropout drawn "
                        "in the kernel (--cached only), 'xla' the plain "
                        "autograd step, 'pallas_epoch' the whole-epoch kernel "
                        "(--cached only), 'auto' (default) the fused step on "
                        "CUDA with float32 and 'xla' otherwise")
    t.add_argument("--cached", action="store_true",
                   help="keep the dataset on the device as uint8 and run "
                        "each epoch with no per-step host sync")
    t.add_argument("--fused", action="store_true",
                   help="with --cached: run all epochs with one fetch at the "
                        "end (per-epoch lines printed after)")
    t.add_argument("--impl", choices=("threefry2x32", "rbg"), default=None,
                   help="PRNG engine of the train key. threefry2x32 "
                        "(default) is jax's reference stream: the masks are "
                        "the JAX trainer's for the same seed; rbg (--cached "
                        "--kernel pallas_epoch only) selects the epoch "
                        "kernel's own Philox stream (same keep distribution, "
                        "other masks)")
    t.add_argument("--sampler_rng", choices=("pcg64", "torch"),
                   default="pcg64",
                   help="train-shard permutation source: pcg64 (default) or "
                        "torch, the MT19937 randperm of torch's "
                        "DistributedSampler (ddp_tutorial_multi_gpu.py:26-30), "
                        "making every epoch's shards a reference run's at "
                        "the same seed, index for index")
    t.add_argument("--dropout_rng", choices=("jax", "torch"), default="jax",
                   help="dropout mask source: jax (default; the --impl key "
                        "chain) or torch, torch's CPU bernoulli stream "
                        "seeded --seed (the nn.Dropout draw of "
                        "ddp_tutorial_cpu.py:47), drawn on the host a step "
                        "at a time for the plain autograd step (--kernel "
                        "auto resolves to xla). Serial streaming only: no "
                        "--parallel, no --cached")
    t.add_argument("--eval_shuffle", action="store_true",
                   help="segment each epoch's val_loss in a shuffled batch "
                        "order like the reference's test DataLoader("
                        "shuffle=True) (ddp_tutorial_multi_gpu.py:43-47), "
                        "from torch's MT19937 randperm seeded --seed + "
                        "epoch. Only the ref-unit val_loss changes; mean "
                        "loss and accuracy do not, and no device work is "
                        "added")
    d = p.add_argument_group("data")
    d.add_argument("--path", "--data_path", type=str, default="data/",
                   help="dataset root (IDX files, or the .nc files of "
                        "--netcdf); synthetic data otherwise")
    d.add_argument("--netcdf", action="store_true",
                   help="read mnist_{train,test}_images.nc under --path (the "
                        "PnetCDF configurations; write them with `python -m "
                        "pytorch_ddp_mnist_tpu_torch convert`): each rank "
                        "gathers its own shard's rows from the train file")
    d.add_argument("--download", action="store_true",
                   help="fetch the MNIST IDX files (checksum-verified "
                        "mirrors) when they are absent from --path, the "
                        "datasets.MNIST(download=True) analog "
                        "(ddp_tutorial_cpu.py:22); in a world rank 0 "
                        "fetches and the others wait at a barrier")
    d.add_argument("--limit", "--data_limit", type=int, default=-1,
                   help="truncate the train set to N samples")
    d.add_argument("--hdf5", action="store_true",
                   help="dead flag kept for reference-CLI parity")
    d.add_argument("--label_map", type=int, nargs="*", default=None,
                   help="dead key kept for reference-CLI parity")
    a, rest = p.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in NOT_YET_PORTED:
            raise SystemExit(f"{flag} is not ported to the PyTorch package "
                             f"yet; see ROADMAP.md {NOT_YET_PORTED[flag]}")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if a.kernel in ("pallas_rng", "pallas_epoch") and not a.cached:
        raise SystemExit(f"--kernel {a.kernel} runs inside the epoch scan; "
                         f"add --cached")
    if a.kernel == "pallas_epoch" and (
            a.batch_size % 8 != 0 or a.batch_size > EPOCH_KERNEL_MAX_BATCH):
        raise SystemExit(
            f"--kernel pallas_epoch needs a batch divisible by 8 and <= "
            f"{EPOCH_KERNEL_MAX_BATCH} (one block per step); got "
            f"{a.batch_size} — use --kernel pallas instead")
    if a.fused and not a.cached:
        raise SystemExit("--fused fuses the epoch scan; add --cached")
    check_telemetry_knobs(a)
    if a.impl == "rbg" and not a.cached:
        raise SystemExit(
            "--impl rbg selects the epoch kernel's Philox stream (--cached "
            "--kernel pallas_epoch); the streaming path draws the TPU rbg "
            "stream per step in the JAX trainer, which the port does not "
            "have. Use --impl threefry2x32 here")
    if a.wireup_method == "tpu":
        raise SystemExit(
            "--wireup_method tpu reads a Cloud TPU pod's metadata; it has no "
            "counterpart on CUDA machines. Launch under torchrun, SLURM or "
            "MPI (--wireup_method auto), or use --wireup_method env")
    if a.wireup_method != "auto" and not a.parallel:
        raise SystemExit(f"--wireup_method {a.wireup_method} forms the world "
                         f"of --parallel; add --parallel")
    if a.dropout_rng == "torch":
        # the torch mask stream is drawn on the host a step at a time, as
        # torch draws it: that fits the serial streaming loop only
        if a.parallel:
            raise SystemExit(
                "--dropout_rng torch is serial-only: DDP replicas draw "
                "per-rank dropout streams, and the reference's single "
                "global torch generator has no per-rank split to mirror")
        if a.cached:
            raise SystemExit(
                "--dropout_rng torch streams host-drawn masks per step; "
                "the --cached/--fused epoch programs draw masks on the "
                "device — drop --cached (the streaming loop) to use it")
        if a.kernel not in ("auto", "xla"):
            raise SystemExit(
                f"--dropout_rng torch uses the plain autograd step with "
                f"streamed masks; --kernel {a.kernel} draws its own masks "
                f"in the kernel")
        if a.outage_retries:
            raise SystemExit(
                "--dropout_rng torch does not compose with "
                "--outage_retries: the in-process retry would continue "
                "the torch mask stream mid-epoch instead of at the resume "
                "boundary; use --resume/--start_epoch (which re-seat the "
                "stream exactly) or the default jax dropout stream")
        if (a.resume and not a.start_epoch
                and not os.path.isdir(a.resume)):
            raise SystemExit(
                "--dropout_rng torch with --resume needs --start_epoch "
                "(it positions the mask stream at the resume boundary; "
                "without it the stream would restart at epoch 0)")
        a.kernel = "xla"
    check_comm_and_input_knobs(a)
    check_resume_knobs(a, cli=argv is None if cli is None else cli)
    return {
        "trainer": {
            "batch_size": a.batch_size, "n_epochs": a.n_epochs, "lr": a.lr,
            "seed": a.seed, "device": a.device, "checkpoint": a.checkpoint,
            "dtype": a.dtype, "kernel": a.kernel, "cached": a.cached,
            "fused": a.fused, "impl": a.impl or "threefry2x32",
            "parallel": a.parallel, "wireup_method": a.wireup_method,
            "sampler_rng": a.sampler_rng, "dropout_rng": a.dropout_rng,
            "eval_shuffle": a.eval_shuffle, "ddp_comm": a.ddp_comm,
            "bf16_rounding": a.bf16_rounding, "overlap": a.overlap,
            "quant_block": a.quant_block,
            "error_feedback": a.error_feedback == "on",
            "model": a.model, "param_scale": a.param_scale,
            "num_workers": a.num_workers, "input_workers": a.input_workers,
            "prefetch_depth": a.prefetch_depth, "resume": a.resume,
            "start_epoch": a.start_epoch,
            "ckpt_every_steps": a.ckpt_every_steps,
            "ckpt_keep": a.ckpt_keep, "fault": a.fault,
            "outage_retries": a.outage_retries, "telemetry": a.telemetry,
            "journal": a.journal, "profile_dispatch": a.profile_dispatch,
            "health": a.health, "metrics_port": a.metrics_port,
            "profile": a.profile,
        },
        "data": {"path": a.path, "limit": a.limit, "netcdf": a.netcdf,
                 "download": a.download, "hdf5": a.hdf5,
                 "label_map": a.label_map},
    }


def check_telemetry_knobs(a) -> None:
    """The JAX CLI's refusals of `--journal` and `--profile_dispatch`
    (`pytorch_ddp_mnist_tpu/cli/train.py:321-352`), word for word: a
    configuration that would record nothing exits by name. `--journal`
    under `--kernel auto` that resolves to the fused step is refused after
    the kernel is resolved (cli/train.py)."""
    if a.journal:
        if not a.telemetry:
            raise SystemExit("--journal writes journal*.jsonl beside the "
                             "JSONL trace; add --telemetry DIR")
        if not a.parallel:
            raise SystemExit("--journal records the DDP step's collectives "
                             "over the 'dp' mesh; a serial run issues none "
                             "— add --parallel")
        if a.cached:
            raise SystemExit("--journal needs the streaming path: --cached "
                             "runs steps inside a jitted scan, so the host "
                             "observes only chunk boundaries and the "
                             "per-collective journal cannot stamp them — "
                             "drop --cached (and --fused)")
        if a.kernel in ("pallas", "pallas_rng", "pallas_epoch"):
            raise SystemExit(f"--journal needs the XLA step program (it "
                             f"declares its collective schedule); --kernel "
                             f"{a.kernel} owns its own comms")
    if a.profile_dispatch:
        if not a.telemetry:
            raise SystemExit("--profile_dispatch flushes dispatch_phase/"
                             "dispatch_window points into the JSONL trace; "
                             "add --telemetry DIR")
        if a.fused:
            raise SystemExit("--profile_dispatch decomposes the per-step/"
                             "per-chunk host boundary; --fused runs all "
                             "epochs as ONE device program with no such "
                             "boundary — drop --fused")


def check_comm_and_input_knobs(a) -> None:
    """The JAX CLI's rules for the comm strategies, the zoo and the input
    pipeline (`pytorch_ddp_mnist_tpu/cli/train.py:354-435`), word for word:
    every knob some configuration would quietly ignore exits by name, and
    `--kernel auto` resolves to xla where an option needs it."""
    from ..models.zoo import is_default_model, validate_model
    from ..parallel.collectives import validate_int8_options
    if a.ddp_comm != "pmean":
        if not a.parallel:
            raise SystemExit(
                f"--ddp_comm {a.ddp_comm} selects the DDP gradient "
                f"collective; it needs --parallel")
        if a.kernel == "pallas_epoch":
            raise SystemExit(
                f"--ddp_comm {a.ddp_comm} selects the per-step XLA "
                f"gradient collective; --kernel pallas_epoch performs its "
                f"allreduce IN-kernel (the ICI ring) and never reads it")
    if a.bf16_rounding != "nearest" and a.ddp_comm != "bf16":
        raise SystemExit(
            f"--bf16_rounding {a.bf16_rounding} rounds the bf16 "
            f"strategy's wire cast; --ddp_comm {a.ddp_comm} never "
            f"casts — use --ddp_comm bf16")
    try:
        validate_model(a.model, a.param_scale)
        validate_int8_options(a.quant_block, a.error_feedback == "on",
                              a.ddp_comm)
    except ValueError as e:
        raise SystemExit(str(e))
    nondefault_model = not is_default_model(a.model, a.param_scale)
    if a.overlap and not a.parallel:
        raise SystemExit(
            "--overlap bucket-pipelines the DDP gradient collectives; it "
            "needs --parallel")
    xla_only = []
    if a.overlap:
        xla_only.append("--overlap (bucket-pipelined XLA collectives)")
    if a.ddp_comm == "int8":
        xla_only.append("--ddp_comm int8 (error-feedback state threading)")
    if nondefault_model:
        xla_only.append(f"--model {a.model} --param_scale "
                        f"{a.param_scale} (non-reference shapes)")
    if xla_only:
        if a.kernel in ("pallas", "pallas_rng", "pallas_epoch"):
            raise SystemExit(
                f"--kernel {a.kernel} hard-codes the reference MLP / "
                f"owns its own comms; {'; '.join(xla_only)} need(s) "
                f"--kernel xla")
        if a.kernel == "auto":
            a.kernel = "xla"
    if nondefault_model and a.dropout_rng == "torch":
        raise SystemExit(
            "--dropout_rng torch streams masks sized for the reference "
            "MLP's hidden layer; --model/--param_scale change that "
            "geometry — use the default jax dropout stream")
    if a.input_workers < 0:
        raise SystemExit("--input_workers must be >= 0")
    if a.prefetch_depth < 1:
        raise SystemExit("--prefetch_depth must be >= 1")
    if a.input_workers and a.cached:
        raise SystemExit(
            "--input_workers feeds the streaming loader through the input "
            "pipeline; --cached holds the dataset in HBM with no loader to "
            "feed — drop --cached (the streaming loop) to use it")
    if a.input_workers and a.num_workers:
        raise SystemExit(
            "--input_workers (the staged pipeline) supersedes the NetCDF "
            "loader's --num_workers readahead; pass one of the two")
    if a.prefetch_depth != 1 and a.fused:
        raise SystemExit(
            "--prefetch_depth pipelines per-chunk/per-batch device "
            "transfers; --fused places ONE index array for the whole run — "
            "there is nothing to prefetch")


def check_resume_knobs(a, cli: bool) -> None:
    """The JAX CLI's refusals of the checkpoint, resume, outage, health
    and metrics flags (`pytorch_ddp_mnist_tpu/cli/train.py:436-489`), by
    name: a range or a
    combination some path would ignore exits at parse time. `cli` is
    whether the trainer runs from the command line (a re-exec replaces
    the process, which only the command line may do)."""
    if not 0 <= a.start_epoch <= a.n_epochs:
        raise SystemExit(f"--start_epoch {a.start_epoch} outside "
                         f"[0, {a.n_epochs}] (n_epochs is the TOTAL run "
                         f"length; start_epoch resumes inside it)")
    if a.outage_retries < 0:
        raise SystemExit("--outage_retries must be >= 0")
    if a.ckpt_every_steps < 0:
        raise SystemExit("--ckpt_every_steps must be >= 0")
    if a.ckpt_keep < 1:
        raise SystemExit("--ckpt_keep must be >= 1")
    if a.metrics_port is not None and a.metrics_port < 0:
        raise SystemExit("--metrics_port must be >= 0 (0 = ephemeral)")
    if a.health != "off":
        if a.fused:
            raise SystemExit(
                "--health observes at the chunk/epoch boundaries the host "
                "controls; --fused runs all epochs as ONE device program "
                "with no live host — use plain --cached")
        if a.health == "checkpoint-and-warn" and not a.checkpoint:
            raise SystemExit(
                "--health checkpoint-and-warn saves the last known-good "
                "state under <--checkpoint>.steps/; pass a non-empty "
                "--checkpoint to derive the directory from")
    if a.ckpt_every_steps:
        if a.fused:
            raise SystemExit(
                "--ckpt_every_steps saves at chunk boundaries the host "
                "controls; --fused runs all epochs as ONE device program "
                "with no mid-run host control — use plain --cached")
        if a.kernel == "pallas_epoch":
            raise SystemExit(
                "--ckpt_every_steps chunks the epoch scan; --kernel "
                "pallas_epoch splits its dropout key once per EPOCH and "
                "chunking would fork the RNG chain — use --kernel "
                "xla/pallas")
        if not a.checkpoint:
            raise SystemExit(
                "--ckpt_every_steps writes step checkpoints under "
                "<--checkpoint>.steps/; pass a non-empty --checkpoint to "
                "derive the directory from")
    if a.outage_retries and a.parallel and not cli:
        raise SystemExit(
            "--outage_retries with --parallel resumes by re-exec'ing the "
            "process and is only available from the CLI (argv=None); "
            "programmatic callers should relaunch with --resume instead")
    if a.outage_retries and a.fused:
        raise SystemExit(
            "--outage_retries needs per-epoch state to resume from; "
            "--fused runs all epochs as one device program with no "
            "mid-run state (use plain --cached)")
    if a.fault:
        from ..utils.faultpoints import FaultSpecError, parse_faults
        try:
            parse_faults(a.fault)
        except FaultSpecError as e:
            raise SystemExit(f"--fault: {e}") from None


def resolve_kernel(kernel: str, dtype: str, device_type: str) -> str:
    """The `--kernel auto` policy: the fused step on CUDA with float32, the
    plain autograd step ('xla') otherwise. Explicit choices pass through."""
    if kernel != "auto":
        return kernel
    return "pallas" if device_type == "cuda" and dtype == "float32" else "xla"
