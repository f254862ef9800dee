"""The graph kernels — the fused GCN layer (K2) and the ragged block-sparse
product (K1): hand-written CUDA kernels (csrc/), their plain PyTorch
versions, and the differentiable public wrappers (ops.py)."""
