"""Gradient compression with error feedback — twin of
`repro.train.compression`.

Two lossy channels, both meant for error feedback (the residual of lossy
compression is carried to the next step so the compressed-SGD iterates
track the exact ones):

  * int8 per-tensor quantization — 4× fewer wire bytes,
  * top-k sparsification — k/N of the wire.

`compressed_psum_mean` is the data-parallel mean over an int8 wire across
the ranks of a `torch.distributed` group (the reference's, inside
``shard_map``), with the reference's codes and scales.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.train.tree import tree_map

__all__ = ["int8_compress", "int8_decompress", "topk_compress", "error_feedback_update",
           "compressed_psum_mean"]

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


def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` with int8 wire traffic,
    called by every rank of it.

    Reduce-scatter phase: each rank quantizes its n chunks of ``x`` to int8
    (one scale) and sends chunk j to rank j (``all_to_all_single``), with
    the scales all-gathered; each rank dequantizes and sums its chunk over
    the senders and divides by n. All-gather phase: the mean chunk is
    quantized to int8 again and all-gathered with its scale. The first
    quantization runs in ``x``'s own dtype (for bf16: bf16 ``amax``, scale
    and ``x / scale``, as the reference); the sum and the second phase run
    in fp32, and the result is fp32. Wire bytes:
    2 × n_elements × 1 B against 2 × n_elements × 4 B for an fp32 mean. A
    group whose backend carries host tensors only (gloo) gets the wire
    through the host.
    """
    from repro_torch.dist.halo import _wire_on_host

    n = dist.get_world_size(group)
    on_host = _wire_on_host(x, group)
    flat = (x.detach().cpu() if on_host else x.detach()).reshape(-1)
    pad = (-flat.shape[0]) % n
    chunks = torch.cat([flat, flat.new_zeros(pad)]).reshape(n, -1)
    q, scale = int8_compress(chunks)                       # in x's dtype, as the reference
    q_t = torch.empty_like(q)
    dist.all_to_all_single(q_t, q, group=group)            # q_t[j]: rank j's chunk of this rank
    # Widening a bf16 scale to fp32 is exact, so it may happen before the
    # gather (gloo need not carry bf16); the reference widens after it.
    scales = _all_gather(scale.float().reshape(1), n, group).reshape(n)
    local_sum = (q_t.float() * scales[:, None]).sum(dim=0) / n
    q2, scale2 = int8_compress(local_sum[None, :])
    gathered = _all_gather(q2[0], n, group)                # (n, chunk)
    scales2 = _all_gather(scale2.reshape(1), n, group).reshape(n)
    full = (gathered.float() * scales2[:, None]).reshape(-1)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape).to(x.device)


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t``, stacked in rank order."""
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)
