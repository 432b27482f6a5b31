#!/bin/bash
# The PyTorch/CUDA port's world of processes on one host: the reference's
# train_cpu_mp.csh (`mpiexec -n 4 ... --parallel --wireup_method mpich`,
# mnist_cpu_mp.py; with --netcdf, mnist_pnetcdf_cpu_mp.py). Under MPICH's
# mpiexec where the machine has one; otherwise WORLD_SIZE processes on the
# env wireup (RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT), the reference's own
# fallback branch (mnist_cpu_mp.py:147-185). The ranks share the host's
# cards (rank r on card r % count, gloo); --device cpu puts them on the CPU.
# Usage:
#   WORLD_SIZE=4 scripts/train_torch_mp.sh [--netcdf] [trainer flags]
set -e
cd "$(dirname "$0")/.."
WORLD_SIZE=${WORLD_SIZE:-4}
if command -v mpiexec >/dev/null 2>&1 && [ -z "$NO_MPIEXEC" ]; then
    exec mpiexec -n "$WORLD_SIZE" python -m pytorch_ddp_mnist_tpu_torch \
        train --parallel --wireup_method mpich --n_epochs 1 "$@"
fi
export WORLD_SIZE LOCAL_WORLD_SIZE=$WORLD_SIZE MASTER_ADDR=127.0.0.1
export MASTER_PORT=${MASTER_PORT:-29541}
pids=()
for r in $(seq 0 $((WORLD_SIZE - 1))); do
    RANK=$r LOCAL_RANK=$r python -m pytorch_ddp_mnist_tpu_torch train \
        --parallel --wireup_method env --n_epochs 1 "$@" &
    pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=$?; done
exit $rc
