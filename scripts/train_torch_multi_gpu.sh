#!/bin/bash
# The PyTorch/CUDA port's multi-card trainer: the reference's
# train_multi_gpu.sh (ddp_tutorial_multi_gpu.py under
# `torch.distributed.launch --nproc_per_node=8`, 10 epochs), one rank a
# card under torchrun. NPROC ranks (default: every card nvidia-smi lists);
# ranks with a card of their own talk NCCL, ranks that share one gloo
# (parallel/wireup.py). Usage:
#   NPROC=4 scripts/train_torch_multi_gpu.sh [--netcdf] [trainer flags]
set -e
cd "$(dirname "$0")/.."
NPROC=${NPROC:-$(nvidia-smi -L 2>/dev/null | wc -l)}
[ "$NPROC" -ge 1 ] || { echo "no CUDA card found; set NPROC" >&2; exit 2; }
exec torchrun --standalone --nproc_per_node "$NPROC" \
    -m pytorch_ddp_mnist_tpu_torch train --parallel --n_epochs 10 "$@"
