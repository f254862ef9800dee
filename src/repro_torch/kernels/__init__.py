"""The kernels — the fused GCN layer (K2), the ragged block-sparse product
(K1), DeepFM's FM interaction (K3) and the LM's flash attention (K4):
hand-written CUDA kernels (csrc/), their plain PyTorch versions, and the
public wrappers (ops.py; differentiable, except the forward-only K4)."""
