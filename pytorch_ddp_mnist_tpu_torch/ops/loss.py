"""Loss and metric ops (port of `pytorch_ddp_mnist_tpu/ops/loss.py`).

`cross_entropy` is torch.nn.CrossEntropyLoss's default mean reduction, as
the reference uses; `accuracy` is the added metric.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy. logits (B, C) float, labels (B,) int."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logz, -1, labels.long()[:, None])
    return -picked.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax predictions matching labels."""
    pred = torch.argmax(logits, dim=-1)
    return (pred == labels.to(pred.dtype)).float().mean()
