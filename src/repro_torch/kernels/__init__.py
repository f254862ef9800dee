"""The kernels — the fused GCN layer (K2), the ragged block-sparse product
(K1) and DeepFM's FM interaction (K3): hand-written CUDA kernels (csrc/),
their plain PyTorch versions, and the differentiable public wrappers
(ops.py)."""
