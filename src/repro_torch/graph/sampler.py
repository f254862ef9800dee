"""CSR fanout neighbor sampler — twin of `repro.graph.sampler` (host-side
numpy; the same draws from the same seed).

GraphSAGE-style layered uniform sampling: given seed nodes, sample up to
``fanout[0]`` in-neighbors per seed, then ``fanout[1]`` per frontier node,
etc. Output is a :class:`SampledBlock` with *static* shapes (padded with a
ghost node), so every batch of one seed count has one shape.

Implementation notes:
  * host-side numpy against an int64 CSR; vectorized over the frontier,
  * sampling WITH replacement (standard for uniform fanout samplers; avoids
    per-node rejection loops and keeps shapes static),
  * node relabeling via np.unique over the union of layers; seeds first.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import GraphData

__all__ = ["NeighborSampler", "SampledBlock", "stable_order"]


def stable_order(ids: np.ndarray) -> np.ndarray:
    """``np.argsort(ids, kind="stable")`` for non-negative ids below 2³²,
    as two stable 16-bit passes (least significant first). NumPy sorts
    16-bit keys stably by radix, in O(E), where the stable sort of an int64
    array is a merge sort: 3× faster at 11 M edges, the CSR build of a
    sampler over a Reddit-sized graph."""
    ids = np.asarray(ids)
    if ids.size == 0 or ids.min() < 0 or ids.max() >= 1 << 32:
        return np.argsort(ids, kind="stable")
    order = np.argsort((ids & 0xFFFF).astype(np.uint16), kind="stable")
    if ids.max() < 1 << 16:
        return order
    return order[np.argsort((ids[order] >> 16).astype(np.uint16), kind="stable")]


@dataclasses.dataclass
class SampledBlock:
    """One sampled computation block (all layers merged into one subgraph)."""

    node_ids: np.ndarray       # (max_nodes,) original ids, ghost-padded
    senders: np.ndarray        # (max_edges,) local ids into node_ids
    receivers: np.ndarray      # (max_edges,) local ids
    n_seeds: int
    n_nodes: int               # valid prefix of node_ids
    n_edges: int               # valid prefix of senders/receivers
    max_nodes: int
    max_edges: int

    @property
    def edge_mask(self) -> np.ndarray:
        m = np.zeros(self.max_edges, bool)
        m[: self.n_edges] = True
        return m


class NeighborSampler:
    def __init__(self, graph: GraphData, fanout: tuple[int, ...] = (15, 10), seed: int = 0):
        self.fanout = tuple(fanout)
        self.n_nodes = graph.n_nodes
        s, r = graph.edge_index[0].astype(np.int64), graph.edge_index[1].astype(np.int64)
        # In-neighbor CSR: for each receiver, the list of senders.
        order = stable_order(r)
        self._nbr = s[order]
        self._indptr = np.zeros(graph.n_nodes + 1, np.int64)
        self._indptr[1:] = np.bincount(r, minlength=graph.n_nodes)
        np.cumsum(self._indptr, out=self._indptr)
        self._rng = np.random.default_rng(seed)

    def max_shapes(self, batch_nodes: int) -> tuple[int, int]:
        """Static (max_nodes, max_edges) for a given seed-batch size."""
        nodes, edges = batch_nodes, 0
        frontier = batch_nodes
        for f in self.fanout:
            edges += frontier * f
            frontier *= f
            nodes += frontier
        return nodes, edges

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        seeds = np.asarray(seeds, dtype=np.int64)
        if np.unique(seeds).shape[0] != seeds.shape[0]:
            # The relabeling contract puts each seed in its own leading row;
            # duplicate seeds would leave all but one of their rows with no
            # in-edges (silent zero aggregation), so reject them outright.
            raise ValueError("NeighborSampler.sample: duplicate seed nodes")
        max_nodes, max_edges = self.max_shapes(len(seeds))
        all_src: list[np.ndarray] = []
        all_dst: list[np.ndarray] = []
        frontier = seeds
        for f in self.fanout:
            deg = self._indptr[frontier + 1] - self._indptr[frontier]
            has = deg > 0
            # Uniform with replacement among each node's in-neighbors — this
            # also covers fanout > degree (repeats instead of rejection
            # loops, keeping shapes static).
            pick = (self._rng.random((frontier.shape[0], f)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
            if self._nbr.size:
                idx = self._indptr[frontier][:, None] + pick
                src = self._nbr[np.minimum(idx, self._nbr.size - 1)]
            else:
                # Edgeless graph: every node is isolated; all self-messages.
                src = np.broadcast_to(frontier[:, None], (frontier.shape[0], f)).copy()
            src = np.where(has[:, None], src, frontier[:, None])  # isolated: self-message
            dst = np.repeat(frontier, f)
            all_src.append(src.reshape(-1))
            all_dst.append(dst)
            frontier = src.reshape(-1)
        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)
        # Relabel: seeds occupy [0, n_seeds), then other touched nodes.
        uniq = np.unique(np.concatenate([seeds, src, dst]))
        rest = uniq[~np.isin(uniq, seeds, assume_unique=False)]
        node_ids_valid = np.concatenate([seeds, rest])
        lut = np.empty(self.n_nodes, np.int64)
        lut[node_ids_valid] = np.arange(node_ids_valid.shape[0])
        src_l, dst_l = lut[src], lut[dst]
        n_nodes, n_edges = node_ids_valid.shape[0], src_l.shape[0]
        node_ids = np.full(max_nodes, self.n_nodes, np.int64)  # ghost id pad
        node_ids[:n_nodes] = node_ids_valid
        senders = np.full(max_edges, max_nodes, np.int32)
        receivers = np.full(max_edges, max_nodes, np.int32)
        senders[:n_edges] = src_l
        receivers[:n_edges] = dst_l
        return SampledBlock(
            node_ids=node_ids,
            senders=senders,
            receivers=receivers,
            n_seeds=len(seeds),
            n_nodes=n_nodes,
            n_edges=n_edges,
            max_nodes=max_nodes,
            max_edges=max_edges,
        )

    def epoch(self, batch_nodes: int, n_batches: int):
        """Deterministic seed-node stream of sampled blocks."""
        for _ in range(n_batches):
            seeds = self._rng.choice(self.n_nodes, size=batch_nodes, replace=False)
            yield self.sample(seeds)
