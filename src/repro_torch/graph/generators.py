"""Deterministic synthetic graphs with the paper's Table I shapes — twin of
`repro.graph.generators` (numpy, array-equal to the reference).

Structure is homophilous planted-partition with power-law-ish degrees
(citation-network-like), fully seeded.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import GraphData

__all__ = [
    "DatasetSpec",
    "TABLE_I",
    "GNN_SHAPES",
    "citation_like",
    "random_graph",
    "molecule_batch",
    "make_dataset",
]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_nodes: int
    n_edges: int
    n_features: int
    n_labels: int
    n_layers: int = 2
    hidden: int = 16  # Kipf–Welling default, used in the paper's Nell example


# Paper Table I, verbatim.
TABLE_I: dict[str, DatasetSpec] = {
    "cora": DatasetSpec("cora", 2708, 10556, 1433, 7),
    "citeseer": DatasetSpec("citeseer", 3327, 9228, 3703, 6),
    "pubmed": DatasetSpec("pubmed", 19717, 88651, 500, 3),
    "extcora": DatasetSpec("extcora", 19793, 130622, 8710, 70),
    "nell": DatasetSpec("nell", 65755, 266144, 5414, 210),
}


# The GNN input-shape cells every GNN architecture runs (the reference's).
GNN_SHAPES: dict[str, dict] = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, kind="full-batch"),
    "minibatch_lg": dict(
        n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024, fanout=(15, 10), kind="sampled-training"
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, kind="full-batch-large"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, kind="batched-small-graphs"),
}


def _powerlaw_degrees(n: int, total_edges: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    w /= w.sum()
    deg = rng.multinomial(total_edges, w)
    return rng.permutation(deg)


def citation_like(
    n_nodes: int,
    n_edges: int,
    n_features: int | None = None,
    n_labels: int = 7,
    homophily: float = 0.8,
    alpha: float = 1.6,
    feature_nnz: int = 32,
    seed: int = 0,
    feature_dtype=np.float32,
    with_positions: bool = False,
) -> GraphData:
    """Homophilous power-law graph with bag-of-words-ish features.

    Labels are contiguous blocks; the directed edge count equals ``n_edges``
    exactly, with no self loops (model layers add their own).
    """
    rng = np.random.default_rng(seed)
    labels = (np.arange(n_nodes, dtype=np.int64) * n_labels // n_nodes).astype(np.int32)
    # Label block boundaries for homophilous destination sampling.
    block_lo = np.searchsorted(labels, np.arange(n_labels))
    block_hi = np.searchsorted(labels, np.arange(n_labels), side="right")
    src_deg = _powerlaw_degrees(n_nodes, n_edges, alpha, rng)
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), src_deg)
    same = rng.random(n_edges) < homophily
    lbl = labels[src]
    lo, hi = block_lo[lbl], block_hi[lbl]
    dst_same = lo + (rng.random(n_edges) * (hi - lo)).astype(np.int64)
    dst_rand = rng.integers(0, n_nodes, size=n_edges)
    dst = np.where(same, dst_same, dst_rand)
    self_loop = dst == src
    dst[self_loop] = (dst[self_loop] + 1) % n_nodes
    edge_index = np.stack([src, dst]).astype(np.int32)
    features = None
    if n_features is not None:
        features = _bow_features(n_nodes, n_features, feature_nnz, labels, rng, feature_dtype)
    positions = rng.standard_normal((n_nodes, 3)).astype(np.float32) if with_positions else None
    return GraphData(
        n_nodes=n_nodes,
        edge_index=edge_index,
        features=features,
        labels=labels,
        positions=positions,
    )


def _bow_features(
    n_nodes: int, n_features: int, nnz: int, labels: np.ndarray, rng: np.random.Generator, dtype
) -> np.ndarray:
    """Sparse binary features with a label-correlated slice."""
    x = np.zeros((n_nodes, n_features), dtype=dtype)
    cols = rng.integers(0, n_features, size=(n_nodes, nnz))
    np.put_along_axis(x, cols, 1.0, axis=1)
    n_labels = int(labels.max()) + 1
    sig = min(8, max(1, n_features // max(n_labels, 1) // 4))
    for c in range(n_labels):
        idx = np.flatnonzero(labels == c)
        lo = (c * sig) % max(n_features - sig, 1)
        mask = rng.random((idx.shape[0], sig)) < 0.75
        x[idx[:, None], np.arange(lo, lo + sig)[None, :]] += mask.astype(dtype)
    return x


def random_graph(n_nodes: int, n_edges: int, seed: int = 0) -> GraphData:
    """Uniform random directed graph (self loops and repeats allowed)."""
    rng = np.random.default_rng(seed)
    edge_index = rng.integers(0, n_nodes, size=(2, n_edges)).astype(np.int32)
    return GraphData(n_nodes=n_nodes, edge_index=edge_index)


def molecule_batch(
    n_graphs: int = 128,
    nodes_per_graph: int = 30,
    edges_per_graph: int = 64,
    d_feat: int = 16,
    seed: int = 0,
) -> GraphData:
    """Batched small graphs (the ``molecule`` cell) packed into one big
    disconnected graph with 3-D positions — the standard batching for
    EGNN/Equiformer-style models. No self loops."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per_graph
    offs = np.repeat(np.arange(n_graphs) * nodes_per_graph, edges_per_graph)
    src = rng.integers(0, nodes_per_graph, size=n_graphs * edges_per_graph) + offs
    dst = rng.integers(0, nodes_per_graph, size=n_graphs * edges_per_graph) + offs
    loops = src == dst
    dst[loops] = offs[loops] + (dst[loops] - offs[loops] + 1) % nodes_per_graph
    return GraphData(
        n_nodes=n,
        edge_index=np.stack([src, dst]).astype(np.int32),
        features=rng.standard_normal((n, d_feat)).astype(np.float32),
        positions=rng.standard_normal((n, 3)).astype(np.float32),
        labels=np.zeros(n, np.int32),
    )


def make_dataset(name: str, seed: int = 0, reduced: bool = False) -> tuple[DatasetSpec, GraphData]:
    """Materialize a Table-I dataset (or a `reduced` 1/8-scale version for
    smoke tests). Feature matrices above ~200 MB are emitted as float16;
    cast them to float32 before a forward."""
    spec = TABLE_I[name]
    if reduced:
        spec = DatasetSpec(
            spec.name + "-reduced",
            max(spec.n_nodes // 8, 64),
            max(spec.n_edges // 8, 256),
            min(spec.n_features, 64),
            min(spec.n_labels, 7),
            hidden=spec.hidden,
        )
    fbytes = spec.n_nodes * spec.n_features * 4
    dtype = np.float16 if fbytes > 200e6 else np.float32
    g = citation_like(
        spec.n_nodes,
        spec.n_edges,
        spec.n_features,
        spec.n_labels,
        seed=seed,
        feature_dtype=dtype,
    )
    return spec, g
