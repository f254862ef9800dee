"""Serving substrate — twin of `repro.serve`: the continuous-batching LM
scheduler over the KV cache (`scheduler`) and online GCN node-query serving
with the hot-neighbor cache (`graph`)."""

from repro_torch.serve.graph import GraphBatcher, GraphQuery, HotNeighborCache, ServeSampler, hot_query_stream
from repro_torch.serve.scheduler import ContinuousBatcher, Request, decode_multi_pos

__all__ = ["ContinuousBatcher", "Request", "decode_multi_pos", "GraphBatcher", "GraphQuery",
           "HotNeighborCache", "ServeSampler", "hot_query_stream"]
