"""Ops with a hand-written CUDA kernel beside their plain PyTorch version."""
