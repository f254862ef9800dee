"""Serving substrate: continuous-batching LM scheduler over the KV cache —
twin of `repro.serve` for the LM (GCN query serving comes with a later
slice)."""

from repro_torch.serve.scheduler import ContinuousBatcher, Request, decode_multi_pos

__all__ = ["ContinuousBatcher", "Request", "decode_multi_pos"]
