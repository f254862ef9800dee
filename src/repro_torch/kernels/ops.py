"""Public wrappers around the port's kernels — twin of `repro.kernels.ops`.

`fused_gcn_layer` pads the feature rows to the block grid and dispatches on
the tensors' device: CPU tensors run the plain PyTorch version, CUDA tensors
run the hand-written kernels of `repro_torch.kernels.fused_gcn` or raise.
There is no lane padding and no feature tile to pick (both were TPU
constraints); the kernels take any width and set their own limits.

Forward only: the custom-VJP backward of the reference arrives with the
training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gcn import fused_gcn_layer_cuda, fused_gcn_layer_plain

__all__ = ["fused_gcn_layer"]

_ORDERS = ("feature_first", "aggregation_first")


def _pad_rows(z: torch.Tensor, block: int) -> torch.Tensor:
    """Row-pad a dense operand to the block grid (zero rows)."""
    pad = (-z.shape[0]) % block
    return torch.cat([z, z.new_zeros((pad,) + tuple(z.shape[1:]))]) if pad else z


def fused_gcn_layer(vals, cols, lens, x, w, b, order: str = "feature_first",
                    relu: bool = True) -> torch.Tensor:
    """One fused GCN layer act(Ã·(X·W) + b) / act((Ã·X)·W + b).

    ``lens=None`` treats every tile as valid. Returns (R·B, F_out) — callers
    slice to their real node count. fp32 only.
    """
    R, T, B, _ = vals.shape
    if order not in _ORDERS:
        raise ValueError(f"unknown dataflow order: {order!r}")
    if lens is None:
        lens = torch.full((R,), T, dtype=torch.int32, device=vals.device)
    b = b.reshape(-1)
    operands = {"vals": vals, "x": x, "w": w, "b": b}
    for name, t in operands.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_gcn_layer takes float32 operands; {name} is {t.dtype}")
    device = x.device
    for t in (vals, cols, lens, w, b):
        if t.device != device:
            raise ValueError(f"fused_gcn_layer: operands on {device} and {t.device}")
    x = _pad_rows(x, B)
    if device.type == "cpu":
        return fused_gcn_layer_plain(vals, cols, lens, x, w, b, order=order, relu=relu)
    if device.type != "cuda":
        raise ValueError(f"fused_gcn_layer has no kernel for device {device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands.values()):
        raise NotImplementedError(
            "fused_gcn_layer on CUDA is forward-only: its backward (the custom VJP "
            "of repro.kernels.ops) arrives with the training slice of the port"
        )
    return fused_gcn_layer_cuda(vals, cols, lens, x, w, b, order=order, relu=relu)
