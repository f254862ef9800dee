"""Graph → CE partitioning, host-side numpy (twin of `repro.core.partition`).

The port keeps its own copy of the functions that the blocked-adjacency
path and the quickstart need: `bfs_traversal_order` (the default locality
permutation), `partition_graph` with its BFS region growing and boundary
refinement (the ``method="partition"`` permutation), the `Partition`
statistics, `partition_from_assignment` (the online re-localization's
wrapper), `measured_probabilities` and `quotient_graph` (the autotuner's
contraction of a partitioned graph to its parts). Outputs are array-equal
to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Partition",
    "partition_graph",
    "partition_from_assignment",
    "measured_probabilities",
    "refine_partition",
    "bfs_traversal_order",
    "quotient_graph",
]


@dataclasses.dataclass
class Partition:
    """A node→CE assignment plus the edge statistics COIN's model needs."""

    assignment: np.ndarray          # (N,) int32 CE id per node
    k: int
    part_sizes: np.ndarray          # (k,) nodes per CE
    edge_counts: np.ndarray         # (k, k) directed edge counts between CEs
    n_nodes: int
    n_edges: int

    @property
    def intra_edges(self) -> int:
        return int(np.trace(self.edge_counts))

    @property
    def cut_edges(self) -> int:
        return int(self.edge_counts.sum() - np.trace(self.edge_counts))

    @property
    def cut_fraction(self) -> float:
        tot = int(self.edge_counts.sum())
        return self.cut_edges / max(tot, 1)

    def inter_ce_traffic_bits(self, act_bits_per_node: float, broadcast: bool = True) -> np.ndarray:
        """(k,k) inter-CE traffic in bits for ONE layer's output exchange.

        broadcast=True  — paper-faithful dataflow (Fig. 5c): each CE sends its
          full layer output (n_m · a bits) to every other CE.
        broadcast=False — beyond-paper halo exchange: CE i sends to CE j only
          the activations of nodes that j's aggregation actually reads, i.e.
          the distinct source nodes of cut edges i→j (upper-bounded here by
          the edge count, exact when sources are distinct).
        """
        k = self.k
        if broadcast:
            out = np.repeat(self.part_sizes[:, None] * float(act_bits_per_node), k, axis=1)
            np.fill_diagonal(out, 0.0)
            return out
        out = self.edge_counts.astype(np.float64) * float(act_bits_per_node)
        np.fill_diagonal(out, 0.0)
        return out

    def intra_ce_traffic_bits(self, act_bits_per_node: float) -> np.ndarray:
        """(k,) intra-CE traffic in bits per layer (local edge messages)."""
        return np.diag(self.edge_counts).astype(np.float64) * float(act_bits_per_node)


def _edge_count_matrix(assignment: np.ndarray, k: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    pair = assignment[src].astype(np.int64) * k + assignment[dst].astype(np.int64)
    counts = np.bincount(pair, minlength=k * k)
    return counts.reshape(k, k).astype(np.int64)


def _csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, s + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, d


def _gather_ranges(indices: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Vectorized np.concatenate([indices[s:e] ...]) for large frontiers."""
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    out_off = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    idx = np.arange(total, dtype=np.int64)
    seg = np.searchsorted(out_off[1:], idx, side="right")
    return indices[starts[seg] + (idx - out_off[seg])]


def _bfs_assignment(n: int, src: np.ndarray, dst: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Multi-source BFS region growing with balance caps."""
    rng = np.random.default_rng(seed)
    indptr, indices = _csr_from_edges(n, src, dst)
    cap = int(np.ceil(n / k) * 1.03) + 1
    assignment = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    seeds = rng.choice(n, size=k, replace=False)
    assignment[seeds] = np.arange(k, dtype=np.int32)
    sizes += 1
    frontier = seeds
    while frontier.size:
        # Expand all frontier nodes one level, vectorized over their edges.
        starts, ends = indptr[frontier], indptr[frontier + 1]
        counts = (ends - starts).astype(np.int64)
        if counts.sum() == 0:
            break
        owner = np.repeat(assignment[frontier], counts)
        if frontier.size < 4096:
            flat = np.concatenate([indices[s:e] for s, e in zip(starts, ends)])
        else:
            flat = _gather_ranges(indices, starts, ends)
        unas = assignment[flat] == -1
        flat, owner = flat[unas], owner[unas]
        if flat.size == 0:
            break
        # First-come wins among duplicates; respect capacity.
        uniq, first = np.unique(flat, return_index=True)
        owner = owner[first]
        room = sizes[owner] < cap
        uniq, owner = uniq[room], owner[room]
        still = assignment[uniq] == -1
        uniq, owner = uniq[still], owner[still]
        assignment[uniq] = owner
        np.add.at(sizes, owner, 1)
        frontier = uniq
    # Orphans (disconnected or capacity-blocked) → fill underfull parts.
    orphans = np.flatnonzero(assignment == -1)
    if orphans.size:
        deficit = np.maximum(cap - sizes, 0)
        fill = np.repeat(np.arange(k), deficit)[: orphans.size]
        if fill.size < orphans.size:  # pathological: round-robin the rest
            extra = np.arange(orphans.size - fill.size) % k
            fill = np.concatenate([fill, extra])
        assignment[orphans] = fill.astype(np.int32)
    return assignment


def bfs_traversal_order(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Parent-ordered BFS traversal order — I-GCN-style islandization.

    Returns ``order`` (position → node id): nodes in BFS discovery order over
    the symmetrized graph, each frontier sorted by its PARENT's position
    (first discoverer wins), so a community's members pack contiguously.
    Disconnected components are traversed in node-id order.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    both_s = np.concatenate([src, dst])
    both_d = np.concatenate([dst, src])
    indptr, indices = _csr_from_edges(n_nodes, both_s, both_d)
    order = np.empty(n_nodes, np.int64)
    seen = np.zeros(n_nodes, bool)
    pos, next_root = 0, 0
    while pos < n_nodes:
        while next_root < n_nodes and seen[next_root]:
            next_root += 1
        frontier = np.array([next_root], np.int64)
        seen[next_root] = True
        while frontier.size:
            order[pos:pos + frontier.size] = frontier
            pos += frontier.size
            starts, ends = indptr[frontier], indptr[frontier + 1]
            counts = (ends - starts).astype(np.int64)
            if counts.sum() == 0:
                break
            flat = _gather_ranges(indices, starts, ends)
            flat = flat[~seen[flat]]
            if flat.size == 0:
                break
            # Dedupe keeping FIRST discovery, then sort by that discovery
            # position — children group under their (community-mate) parent.
            uniq, first = np.unique(flat, return_index=True)
            frontier = uniq[np.argsort(first, kind="stable")]
            seen[frontier] = True
    return order


def refine_partition(
    assignment: np.ndarray,
    k: int,
    src: np.ndarray,
    dst: np.ndarray,
    passes: int = 3,
    balance_slack: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """Greedy single-move boundary refinement with balance caps.

    Each pass moves every node whose strongest-pulling CE beats its own (and
    has room) there, in gain order; a pass that worsens the cut is reverted
    and refinement stops, so the cut never grows across passes.
    """
    rng = np.random.default_rng(seed)
    n = assignment.shape[0]
    assignment = assignment.astype(np.int32).copy()
    cap = int(np.ceil(n / k) * (1.0 + balance_slack)) + 1
    cut_before = int((assignment[src] != assignment[dst]).sum())
    for _ in range(passes):
        prev = assignment.copy()
        # pull[v, c] = #edges from v into CE c (treat graph as undirected).
        pull = np.zeros((n, k), dtype=np.int32)
        np.add.at(pull, (src, assignment[dst]), 1)
        np.add.at(pull, (dst, assignment[src]), 1)
        cur = pull[np.arange(n), assignment]
        best_part = np.argmax(pull, axis=1).astype(np.int32)
        best = pull[np.arange(n), best_part]
        gain = best - cur
        movers = np.flatnonzero((gain > 0) & (best_part != assignment))
        if movers.size == 0:
            break
        movers = movers[np.argsort(-gain[movers], kind="stable")]
        sizes = np.bincount(assignment, minlength=k).astype(np.int64)
        rng.shuffle(movers[: movers.size // 2])  # break pathological orderings
        tgt = best_part[movers]
        moved = 0
        for v, t in zip(movers, tgt):
            if sizes[t] < cap:
                sizes[assignment[v]] -= 1
                sizes[t] += 1
                assignment[v] = t
                moved += 1
        if moved == 0:
            break
        cut_after = int((assignment[src] != assignment[dst]).sum())
        if cut_after > cut_before:
            assignment = prev
            break
        cut_before = cut_after
    return assignment


def quotient_graph(part: Partition, edge_index: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Contract a partitioned graph to its k-super-node quotient.

    Super-node i is CE/part i. The weight of quotient edge (i, j), i ≠ j, is
    the number of DEDUPLICATED boundary rows part i exports to part j: the
    count of distinct source nodes in i that appear on at least one cut edge
    into j. That is exactly the per-pair quantity the halo plan's export
    tiers pad and ship (each distinct (source device, source row) pair
    occupies one slot), so partitioning this quotient minimizes shipped rows
    rather than raw cut edges.

    Returns ``(q_edge_index, q_weights)``: a (2, Eq) int64 directed edge list
    over ``part.k`` super-nodes and the matching (Eq,) int64 weights.
    Self-loops (intra-part edges) are dropped.
    """
    k = int(part.k)
    a = part.assignment.astype(np.int64)
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    a_s, a_d = a[src], a[dst]
    cut = a_s != a_d
    s, dpart = src[cut], a_d[cut]
    # One boundary row per distinct (source node, destination part) pair.
    uniq = np.unique(s * k + dpart)
    q_src = a[uniq // k]
    q_dst = uniq % k
    counts = np.bincount(q_src * k + q_dst, minlength=k * k).reshape(k, k)
    i, j = np.nonzero(counts)
    q_edge_index = np.stack([i, j]).astype(np.int64)
    return q_edge_index, counts[i, j].astype(np.int64)


def partition_graph(
    n_nodes: int,
    edge_index: np.ndarray,
    k: int,
    method: str = "block",
    seed: int = 0,
    refine: bool = False,
) -> Partition:
    """Produce a node→CE :class:`Partition` of the given graph.

    edge_index: (2, E) int array of directed edges (src, dst).
    """
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    if method == "block":
        # Paper-faithful: adjacency sliced "as is" into N×(N/k) column bands.
        bounds = np.linspace(0, n_nodes, k + 1).astype(np.int64)
        assignment = (np.searchsorted(bounds, np.arange(n_nodes), side="right") - 1).astype(np.int32)
        assignment = np.clip(assignment, 0, k - 1)
    elif method == "random":
        rng = np.random.default_rng(seed)
        assignment = (rng.permutation(n_nodes) % k).astype(np.int32)
    elif method == "bfs":
        assignment = _bfs_assignment(n_nodes, src, dst, k, seed)
    else:
        raise ValueError(f"unknown partition method: {method!r}")
    if refine:
        assignment = refine_partition(assignment, k, src, dst, seed=seed)
    counts = _edge_count_matrix(assignment, k, src, dst)
    return Partition(
        assignment=assignment,
        k=k,
        part_sizes=np.bincount(assignment, minlength=k).astype(np.int64),
        edge_counts=counts,
        n_nodes=int(n_nodes),
        n_edges=int(src.shape[0]),
    )


def partition_from_assignment(
    assignment: np.ndarray,
    k: int,
    edge_index: np.ndarray,
) -> Partition:
    """Wrap an externally-computed node→CE assignment as a :class:`Partition`.

    Online re-localization (`repro_torch.dist.delta.DeltaPlanner.relocalize`)
    derives its assignment from a BFS locality order of the MUTATED edge
    list rather than from any `partition_graph` method; this constructor
    attaches the edge statistics every Partition consumer expects (the same
    tail `partition_graph` runs on its own assignments).
    """
    assignment = np.asarray(assignment, dtype=np.int32)
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    counts = _edge_count_matrix(assignment, int(k), src, dst)
    return Partition(
        assignment=assignment,
        k=int(k),
        part_sizes=np.bincount(assignment, minlength=k).astype(np.int64),
        edge_counts=counts,
        n_nodes=int(assignment.shape[0]),
        n_edges=int(src.shape[0]),
    )


def measured_probabilities(p: Partition) -> tuple[np.ndarray, np.ndarray]:
    """Measured p⁽¹⁾_m (k,) and p⁽²⁾_ij (k,k) from a partition (paper §IV-B2).

    p⁽¹⁾_m  = intra-CE edges / ordered node pairs n_m(n_m−1)
    p⁽²⁾_ij = edges between i and j / (n_i · n_j), i ≠ j
    (directed-edge convention, matching the (N/k)(N/k−1) and (N/k)² pair
    counts used in Eqs. 1–2).
    """
    sizes = p.part_sizes.astype(np.float64)
    pairs_in = np.maximum(sizes * (sizes - 1.0), 1.0)
    p1 = np.diag(p.edge_counts) / pairs_in
    pairs_between = np.maximum(np.outer(sizes, sizes), 1.0)
    p2 = p.edge_counts / pairs_between
    np.fill_diagonal(p2, 0.0)
    return p1, p2
