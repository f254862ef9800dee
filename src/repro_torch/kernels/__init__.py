"""The fused GCN layer: hand-written CUDA kernels (csrc/), their plain
PyTorch versions, and the public wrapper (ops.py)."""
