"""Ops: loss, SGD, and the fused train step with its CUDA kernel."""
