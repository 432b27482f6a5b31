"""PyTorch/CUDA port of `pytorch_ddp_mnist_tpu`.

The JAX package beside this one is the reference and stays unchanged; this
package imports torch and never jax, and nothing of the JAX package (whose
own `__init__` imports jax). It keeps that package's module paths so each
ported function is easy to find next to its counterpart:

    data/        IDX reader, MNIST splits + normalisation, batch loader
    parallel/    the epoch-seeded sharded sampler, the replica mesh of one
                 process or of a world, the DDP steps and their fixed-order
                 gradient mean, the multi-process wireup (torchrun, SLURM,
                 Open MPI, MPICH, env; gloo or NCCL)
    models/      the reference 784-128-128-10 MLP as an nn.Module
    ops/         loss, SGD, the fused train step (K1) and the whole-epoch
                 kernel (K2) with their CUDA kernels, the threefry and
                 Philox dropout streams
    train/       config, train/eval loop, resident-dataset epochs (scan),
                 .pt checkpoints
    cli/         the serial and data-parallel trainer (`python -m
                 pytorch_ddp_mnist_tpu_torch train [--parallel]`)
    bench.py     the single-card train benchmark (`... bench`)

Kernels are built from `csrc/` at first use (ops/_build.py). ROADMAP.md
lists what is ported and what is still to come.
"""
