#!/bin/bash
# The PyTorch/CUDA port's serial trainer: the reference's train_cpu.sh
# (ddp_tutorial_cpu.py, 1 epoch) on CUDA card 0. With --netcdf it is the
# serial PnetCDF configuration (mnist_pnetcdf_cpu.py), reading
# mnist_{train,test}_images.nc under --path (write them with
# `python -m pytorch_ddp_mnist_tpu_torch convert`). --device cpu runs on
# the CPU. Usage, from anywhere:
#   scripts/train_torch_serial.sh [--netcdf] [--download] [trainer flags]
set -e
cd "$(dirname "$0")/.."
exec python -m pytorch_ddp_mnist_tpu_torch train --n_epochs 1 "$@"
