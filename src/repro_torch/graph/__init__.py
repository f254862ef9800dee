"""Graph substrate: host-side containers and blocking, synthetic Table I
datasets and GNN shapes, segment ops, the fanout sampler."""

from repro_torch.graph.generators import (
    GNN_SHAPES,
    TABLE_I,
    citation_like,
    make_dataset,
    molecule_batch,
    random_graph,
)
from repro_torch.graph.ops import (
    aggregate,
    aggregate_padded,
    degrees,
    multi_aggregate,
    multi_aggregate_edges,
    segment_max,
    segment_min,
    segment_sum,
    sym_norm_edge_weights,
)
from repro_torch.graph.sampler import NeighborSampler, SampledBlock
from repro_torch.graph.structure import (
    BlockedAdjacency,
    GraphData,
    PaddedGraph,
    blocked_adjacency,
    locality_block_order,
    permute_edge_index,
    relocate_rows,
    restore_rows,
    to_padded,
)

__all__ = [
    "GraphData",
    "PaddedGraph",
    "to_padded",
    "blocked_adjacency",
    "BlockedAdjacency",
    "locality_block_order",
    "permute_edge_index",
    "relocate_rows",
    "restore_rows",
    "aggregate",
    "aggregate_padded",
    "segment_sum",
    "segment_max",
    "segment_min",
    "multi_aggregate",
    "multi_aggregate_edges",
    "sym_norm_edge_weights",
    "degrees",
    "TABLE_I",
    "GNN_SHAPES",
    "citation_like",
    "random_graph",
    "molecule_batch",
    "make_dataset",
    "NeighborSampler",
    "SampledBlock",
]
