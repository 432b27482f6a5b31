"""PyTorch/CUDA port of `pytorch_ddp_mnist_tpu`.

The JAX package beside this one is the reference and stays unchanged; this
package imports torch and never jax, and nothing of the JAX package (whose
own `__init__` imports jax). It keeps that package's module paths so each
ported function is easy to find next to its counterpart:

    data/        IDX reader, MNIST splits + normalisation, batch loader
    parallel/    the epoch-seeded sharded sampler
    models/      the reference 784-128-128-10 MLP as an nn.Module
    ops/         loss, SGD, and the fused train step with its CUDA kernel
    train/       config, train/eval loop, .pt checkpoints
    cli/         the serial trainer (`python -m pytorch_ddp_mnist_tpu_torch
                 train`)

Kernels are built from `csrc/` at first use (ops/_build.py). ROADMAP.md
lists what is ported and what is still to come.
"""
