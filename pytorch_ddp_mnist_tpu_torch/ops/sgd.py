"""Plain SGD, the reference optimizer: torch.optim.SGD(lr=0.01) with no
momentum, weight decay or schedule (port of `pytorch_ddp_mnist_tpu/ops/sgd.py`).
"""

from __future__ import annotations

import torch


@torch.no_grad()
def sgd_step(params, grads, lr: float):
    """params <- params - lr * grads over the params tree, IN PLACE (the
    JAX version returns new arrays; here the update reuses the parameter
    storage). `lr * g` is rounded to float32 first and then subtracted,
    which is JAX's `p - lr * g` bit for bit; `p.add_(g, alpha=-lr)` would
    round differently. Returns `params`."""
    for name, layer in params.items():
        for k, p in layer.items():
            p.sub_(grads[name][k].to(p.dtype) * lr)
    return params


def sgd_step_flat(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """The update on one flat vector (a shard or a bucket of the sharded
    and bucketed strategies, parallel/collectives.py), as a new tensor:
    `p - (g * lr)`, JAX's `p - lr * g` bit for bit, as `sgd_step`."""
    return p - g.to(p.dtype) * lr
