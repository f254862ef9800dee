"""Gradient compression with error feedback — twin of
`repro.train.compression` (the single-process part).

Two lossy channels, both meant for error feedback (the residual of lossy
compression is carried to the next step so the compressed-SGD iterates
track the exact ones):

  * int8 per-tensor quantization — 4× fewer wire bytes,
  * top-k sparsification — k/N of the wire.

The data-parallel mean over an int8 wire (`compressed_psum_mean`) comes
with the port's distributed slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.train.tree import tree_map

__all__ = ["int8_compress", "int8_decompress", "topk_compress", "error_feedback_update"]

Tree = Any


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale


def topk_compress(x: torch.Tensor, k_fraction: float = 0.01) -> torch.Tensor:
    """Keep the top-|k| entries (by magnitude), zero the rest (same shape —
    a real system would ship (values, indices); the zeroed tensor is the
    mathematically identical lossy channel for error-feedback analysis)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * k_fraction))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return kept.reshape(x.shape)


def error_feedback_update(grads: Tree, residual: Tree, compress_fn) -> tuple[Tree, Tree]:
    """g̃ = C(g + e);  e' = (g + e) − g̃   (Seide et al. 1-bit SGD schema)."""
    target = tree_map(lambda g, e: g + e, grads, residual)
    sent = tree_map(compress_fn, target)
    return sent, tree_map(lambda t, s: t - s, target, sent)
