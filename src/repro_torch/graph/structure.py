"""Graph containers: host-side data, padded device form, and the 128×128
blocked (BSR) adjacency — twin of `repro.graph.structure`.

The host-side functions are numpy and array-equal to the reference's,
including the padding columns of the tile table that repeat the last valid
id. Only `PaddedGraph` and `BlockedAdjacency.arrays` hold tensors; they are
created on ``device`` (``None`` = the CUDA card, see `repro_torch.device`).

The layout is **ragged**: the rectangular ``(R, T)`` tile tables are padded
to the largest block-row degree T, and ``row_nnzb`` records each block-row's
true tile count so the kernels skip the padding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import bfs_traversal_order, partition_graph
from repro_torch.device import resolve_device

__all__ = [
    "GraphData",
    "PaddedGraph",
    "to_padded",
    "BlockedAdjacency",
    "blocked_adjacency",
    "blocked_stats",
    "locality_block_order",
    "permute_edge_index",
    "relocate_rows",
    "restore_rows",
]


@dataclasses.dataclass
class GraphData:
    """Host-side (numpy) graph with optional features/labels/positions."""

    n_nodes: int
    edge_index: np.ndarray                  # (2, E) int32, [senders; receivers]
    edge_weight: np.ndarray | None = None   # (E,) float32
    features: np.ndarray | None = None      # (N, F) float32 (float16 when large)
    labels: np.ndarray | None = None        # (N,) int32
    positions: np.ndarray | None = None     # (N, 3) float32 (geometric models)

    @property
    def n_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def with_self_loops(self) -> "GraphData":
        loops = np.arange(self.n_nodes, dtype=self.edge_index.dtype)
        ei = np.concatenate([self.edge_index, np.stack([loops, loops])], axis=1)
        ew = None
        if self.edge_weight is not None:
            ew = np.concatenate([self.edge_weight, np.ones(self.n_nodes, np.float32)])
        return dataclasses.replace(self, edge_index=ei, edge_weight=ew)

    def symmetrized(self) -> "GraphData":
        rev = self.edge_index[::-1]
        ei = np.concatenate([self.edge_index, rev], axis=1)
        ei = np.unique(ei, axis=1)
        return dataclasses.replace(self, edge_index=ei.astype(np.int32), edge_weight=None)

    def sym_normalized_weights(self) -> np.ndarray:
        """D^-1/2 Ã D^-1/2 weights (Kipf–Welling; the paper's GCN [11])."""
        s, r = self.edge_index
        deg = np.bincount(r, minlength=self.n_nodes).astype(np.float64)
        deg_s = np.bincount(s, minlength=self.n_nodes).astype(np.float64)
        inv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
        inv_s = 1.0 / np.sqrt(np.maximum(deg_s, 1.0))
        return (inv_s[s] * inv[r]).astype(np.float32)


@dataclasses.dataclass
class PaddedGraph:
    """Device form of an edge list, padded with a ghost node (id = n_nodes).

    Ghost-targeted messages land in segment ``n_nodes`` and are sliced off.
    """

    senders: torch.Tensor        # (E_pad,) int32
    receivers: torch.Tensor      # (E_pad,) int32
    edge_weight: torch.Tensor    # (E_pad,) float32; 0 at padding
    n_nodes: int
    n_real_edges: int

    @property
    def n_edges_padded(self) -> int:
        return int(self.senders.shape[0])


def to_padded(
    g: GraphData, pad_to: int | None = None, weights: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> PaddedGraph:
    device = resolve_device(device)
    e = g.n_edges
    pad_to = pad_to or e
    if pad_to < e:
        raise ValueError(f"pad_to={pad_to} is smaller than the edge count {e}")
    if weights is None:
        weights = g.edge_weight if g.edge_weight is not None else np.ones(e, np.float32)
    s = np.full(pad_to, g.n_nodes, np.int32)
    r = np.full(pad_to, g.n_nodes, np.int32)
    w = np.zeros(pad_to, np.float32)
    s[:e], r[:e], w[:e] = g.edge_index[0], g.edge_index[1], weights
    return PaddedGraph(
        senders=torch.from_numpy(s).to(device),
        receivers=torch.from_numpy(r).to(device),
        edge_weight=torch.from_numpy(w).to(device),
        n_nodes=g.n_nodes,
        n_real_edges=e,
    )


@dataclasses.dataclass
class BlockedAdjacency:
    """Ragged BSR-like 128×128 blocking of A (COIN crossbar map → dense tiles).

      block_vals : (n_block_rows, max_nnzb, B, B) float32 — dense tiles
      block_cols : (n_block_rows, max_nnzb) int32 — column-block ids,
                   padding repeats the last valid id with a zero tile
      row_nnzb   : (n_block_rows,) int32 — valid tiles per block-row (≤ max_nnzb)

    Rows span ``n_nodes`` receivers and columns ``n_col_nodes`` senders
    (== n_nodes for the square global adjacency).
    """

    block_vals: np.ndarray
    block_cols: np.ndarray
    row_nnzb: np.ndarray
    n_nodes: int
    block: int
    n_col_nodes: int = 0              # 0 ⇒ square: == n_nodes

    def __post_init__(self):
        if not self.n_col_nodes:
            self.n_col_nodes = self.n_nodes

    @property
    def n_block_rows(self) -> int:
        return int(self.block_vals.shape[0])

    @property
    def n_block_cols(self) -> int:
        return -(-self.n_col_nodes // self.block)

    @property
    def max_nnzb(self) -> int:
        """The rectangular tile-table width T (global max block-row degree)."""
        return int(self.block_vals.shape[1])

    @property
    def n_padded(self) -> int:
        """Row count of the kernel output (block-row grid × B)."""
        return self.n_block_rows * self.block

    @property
    def n_col_padded(self) -> int:
        """Row count the dense feature operand must be padded to."""
        return self.n_block_cols * self.block

    @property
    def nnz_blocks(self) -> int:
        """Total nonzero (materialized, non-padding) tiles."""
        return int(self.row_nnzb.sum())

    @property
    def padded_tile_fraction(self) -> float:
        """Fraction of the rectangular (R, T) tile table that is padding."""
        grid = self.n_block_rows * self.max_nnzb
        return 1.0 - self.nnz_blocks / max(grid, 1)

    @property
    def density(self) -> float:
        """Fraction of the full R×C block grid that is materialized."""
        grid = self.n_block_rows * self.n_block_cols
        return float(self.nnz_blocks) / max(grid, 1)

    def arrays(
        self, device: str | torch.device | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(vals, cols, lens) on ``device`` — the kernel operand triple.

        The kernels trust the column ids, so they are checked here, on the
        host, against the column block count.
        """
        device = resolve_device(device)
        if self.block_cols.size and not (
            0 <= int(self.block_cols.min()) and int(self.block_cols.max()) < self.n_block_cols
        ):
            raise ValueError("block_cols holds ids outside [0, n_block_cols)")
        return (
            torch.from_numpy(self.block_vals).to(device),
            torch.from_numpy(self.block_cols).to(device),
            torch.from_numpy(self.row_nnzb).to(device),
        )


def blocked_adjacency(
    n_nodes: int,
    edge_index: np.ndarray,
    edge_weight: np.ndarray | None = None,
    block: int = 128,
    n_col_nodes: int | None = None,
) -> BlockedAdjacency:
    """Build the ragged 128×128 blocked adjacency (numpy, one-time host cost).

    A[r, c] = w for each edge (sender=c, receiver=r): aggregation computes
    O = A·Z, rows = receivers. ``n_col_nodes`` widens the column space past
    ``n_nodes`` for rectangular matrices.
    """
    s = np.asarray(edge_index[0], dtype=np.int64)
    r = np.asarray(edge_index[1], dtype=np.int64)
    w = (
        np.ones(s.shape[0], np.float32)
        if edge_weight is None
        else np.asarray(edge_weight, np.float32)
    )
    n_cols = n_nodes if n_col_nodes is None else int(n_col_nodes)
    nbr = -(-n_nodes // block)   # ceil: receiver block-rows
    nbc = -(-n_cols // block)    # ceil: sender block-cols
    br, bc = r // block, s // block
    # Unique nonzero blocks, then scatter edges into dense tiles.
    key = br * nbc + bc
    uniq, inv = np.unique(key, return_inverse=True)
    n_blocks = uniq.shape[0]
    vals = np.zeros((n_blocks, block, block), np.float32)
    np.add.at(vals, (inv, r % block, s % block), w)
    ubr, ubc = uniq // nbc, uniq % nbc
    # Group blocks by block-row, pad to max row nnzb (the ragged lengths).
    row_nnzb = np.bincount(ubr, minlength=nbr).astype(np.int32)
    max_nnzb = max(int(row_nnzb.max(initial=1)), 1)
    block_vals = np.zeros((nbr, max_nnzb, block, block), np.float32)
    block_cols = np.zeros((nbr, max_nnzb), np.int32)
    order = np.argsort(ubr, kind="stable")
    pos = np.zeros(nbr, np.int64)
    for idx in order:
        rr = ubr[idx]
        block_vals[rr, pos[rr]] = vals[idx]
        block_cols[rr, pos[rr]] = ubc[idx]
        pos[rr] += 1
    # Pad columns repeat the last valid id (zero tiles the kernels never read).
    for rr in range(nbr):
        if 0 < pos[rr] < max_nnzb:
            block_cols[rr, pos[rr]:] = block_cols[rr, pos[rr] - 1]
    return BlockedAdjacency(
        block_vals=block_vals,
        block_cols=block_cols,
        row_nnzb=row_nnzb,
        n_nodes=n_nodes,
        block=block,
        n_col_nodes=n_cols,
    )


def blocked_stats(
    n_nodes: int,
    edge_index: np.ndarray,
    block: int = 128,
    n_col_nodes: int | None = None,
) -> dict:
    """Blocked-layout statistics without materializing any (B, B) tile:
    ``n_block_rows`` (R), ``max_nnzb`` (T), ``nnz_blocks`` (tiles the ragged
    kernels execute), ``dense_tiles`` (R·T) and ``padded_tile_fraction``."""
    s = np.asarray(edge_index[0], dtype=np.int64)
    r = np.asarray(edge_index[1], dtype=np.int64)
    n_cols = n_nodes if n_col_nodes is None else int(n_col_nodes)
    nbr = -(-n_nodes // block)
    nbc = -(-n_cols // block)
    uniq = np.unique((r // block) * nbc + (s // block))
    row_nnzb = np.bincount(uniq // nbc, minlength=nbr)
    T = max(int(row_nnzb.max(initial=1)), 1)
    nnz = int(row_nnzb.sum())
    return {
        "block": block,
        "n_block_rows": nbr,
        "n_block_cols": nbc,
        "max_nnzb": T,
        "nnz_blocks": nnz,
        "dense_tiles": nbr * T,
        "padded_tile_fraction": 1.0 - nnz / max(nbr * T, 1),
    }


def locality_block_order(
    n_nodes: int,
    edge_index: np.ndarray,
    block: int = 128,
    method: str = "bfs",
    seed: int = 0,
    refine: bool = True,
) -> np.ndarray:
    """COIN CE-mapping / I-GCN islandization permutation for dense blocking.

    Returns ``perm`` (new position → original node id). method="bfs" is the
    parent-ordered BFS traversal; method="partition" lays out a balanced
    ``ceil(n_nodes / block)``-way BFS partition contiguously.
    """
    if n_nodes <= block:
        return np.arange(n_nodes, dtype=np.int64)
    if method == "bfs":
        return bfs_traversal_order(n_nodes, edge_index[0], edge_index[1])
    if method != "partition":
        raise ValueError(f"unknown locality method: {method!r} (bfs | partition)")
    k = -(-n_nodes // block)
    part = partition_graph(n_nodes, edge_index, k, method="bfs", seed=seed, refine=refine)
    return np.argsort(part.assignment, kind="stable").astype(np.int64)


def permute_edge_index(perm: np.ndarray, edge_index: np.ndarray) -> np.ndarray:
    """Rewrite edge endpoints into the permuted node order (perm: new → old)."""
    inv = np.empty(perm.shape[0], np.int64)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return inv[np.asarray(edge_index, dtype=np.int64)].astype(np.int32)


def relocate_rows(perm: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Gather per-node rows into the permuted order (row i ← old row perm[i])."""
    return np.asarray(x)[perm]


def restore_rows(perm: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`relocate_rows` (accepts trailing feature axes)."""
    x = np.asarray(x)
    out = np.empty_like(x)
    out[perm] = x
    return out
