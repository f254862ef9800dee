"""Incremental halo replan for mutating graphs — twin of `repro.dist.delta`
(docs/communication.md §7–§8).

Host side, numpy, and array-equal to the reference: every plan array,
every report field but the timings, and every patched tile table.

`GraphDelta` names a batch of mutations against a FIXED node set and FIXED
partition (node insertion is a re-partition event and stays a full rebuild).
`DeltaPlanner` owns the mutable edge store for one partitioned graph and
repairs every plan it has materialized, in place, per delta:

* **Export tiers** (flat ``send_idx``, hierarchical ``send_loc``/``send_rem``)
  are maintained as per-device refcounted boundary sets with STABLE slots:
  a new export takes the lowest freed slot (or appends at the high-water
  mark), and a surviving export never moves. A non-structural repair
  therefore remaps only newly-cut edges and refreshes only the *dirty*
  devices' send-table rows — O(delta), not O(boundary).
* **Pads never shrink.** If a dirty device's new boundary still fits the
  tier's pad, every other device's slots are untouched; if not, the pad
  grows geometrically (``max(needed, 2·pad)``) and that tier's sender
  encoding is rebuilt (a *structural* repair — still no re-partition).
* **Blocked adjacencies** (`plan_blocked_adjacency` and the
  interior/boundary split pair) are patched tile-wise: touched 128×128
  tiles are recomputed from the live edges and appended / tombstone-swapped
  in their ragged block row (``row_nnzb`` bump), instead of re-blocking the
  graph. Structural repairs drop the blocked cache (column space changed).
* **Rank tables** (`DeltaPlanner.rank_table`, this port's addition) are the
  same patch for ONE rank of a process group: the rank holds its own tiles
  and every rank's tile index (column ids and ragged lengths, no tiles),
  so the width T that all ranks share is agreed — and grown
  geometrically — exactly as the all-rank table's, while no process holds
  the other ranks' tiles. Rank b's patched table equals slice b of the
  patched all-rank table. Structural repairs, re-localizations and
  compactions rebuild it.
* Repaired plans move to a **versioned cache key** (``{base}@d{version}``)
  via `repro_torch.dist.halo.register_halo_plan`, so stale keys miss and
  current keys hit without ever re-running a builder.

`apply_delta_to_graph` is the order-preserving `GraphData` counterpart
(deletes compact, inserts append) used by the serving layer: untouched CSR
rows keep their exact neighbor order, which is what makes
`repro_torch.serve.graph.GraphBatcher.apply_graph_delta`'s scoped cache
invalidation sound. `delta_update_blocked_adjacency` applies the same
tile-patching to a standalone global `BlockedAdjacency`.

Incremental repair keeps plans CORRECT under churn, but not GOOD: the
blocked node order degrades (executed tiles creep back toward the shuffled
baseline) and pads only ever grow. Online maintenance closes that loop:
`RelocalizePolicy` watches the ``locality_drift`` ratio with hysteresis and
triggers :meth:`DeltaPlanner.relocalize` — an in-place re-localization that
installs a fresh BFS-derived balanced partition, rebuilds every
materialized plan, and re-keys the cache — while
:meth:`DeltaPlanner.compact` shrinks pads and tile capacities from their
high-water marks back to current occupancy.

Replicas stay identical: every planner built from the same ``(part,
edge_index, w)`` and fed the same deltas reaches the same plans, slots and
tables (no iteration over hash-ordered sets; the free-slot heaps hold
ints), which is what lets each rank of a group keep its own replica.
"""
from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np

from repro_torch.core.partition import partition_from_assignment
from repro_torch.dist.halo import (
    HaloPlan,
    _blocked_layout,
    _part_columns,
    _rank_edges,
    graph_fingerprint,
    invalidate_halo_plans,
    plan_layout,
    register_halo_plan,
)
from repro_torch.graph.structure import BlockedAdjacency, GraphData
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "GraphDelta",
    "DeltaPlanner",
    "RelocalizePolicy",
    "RankTable",
    "apply_delta_to_graph",
    "delta_update_blocked_adjacency",
]


# ================================================================ GraphDelta
def _as_edge_array(a) -> np.ndarray:
    a = np.asarray(a, np.int64)
    if a.size == 0:
        return np.zeros((2, 0), np.int64)
    if a.ndim != 2 or a.shape[0] != 2:
        raise ValueError(f"edge array must be (2, E), got shape {a.shape}")
    return a


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A batch of mutations against a fixed node set / fixed partition.

    edge_inserts    (2, Ei) int64 — directed (src, dst) edges to add.
    edge_deletes    (2, Ed) int64 — directed edges to remove; each delete
                    consumes the OLDEST matching edge instance (parallel
                    edges are multiset-counted, insertion order decides which
                    instance goes — `apply_delta_to_graph` and `DeltaPlanner`
                    agree on it); deleting an absent edge is an error.
    insert_w        (Ei,) float32 — weights of the inserts (default 1.0;
                    must be > 0, weight 0 is the padding sentinel).
    feature_touches (Tn,) int64   — node rows whose features changed.
    feature_values  (Tn, F) f32   — replacement rows (optional: a touch
                    without values still scopes cache invalidation).
    """

    edge_inserts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((2, 0), np.int64))
    edge_deletes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((2, 0), np.int64))
    insert_w: np.ndarray | None = None
    feature_touches: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    feature_values: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "edge_inserts", _as_edge_array(self.edge_inserts))
        object.__setattr__(self, "edge_deletes", _as_edge_array(self.edge_deletes))
        object.__setattr__(
            self, "feature_touches",
            np.asarray(self.feature_touches, np.int64).ravel())
        if self.insert_w is not None:
            object.__setattr__(
                self, "insert_w", np.asarray(self.insert_w, np.float32).ravel())

    @classmethod
    def empty(cls) -> "GraphDelta":
        return cls()

    @property
    def is_empty(self) -> bool:
        return (self.edge_inserts.shape[1] == 0
                and self.edge_deletes.shape[1] == 0
                and self.feature_touches.size == 0)

    @property
    def n_ops(self) -> int:
        return (int(self.edge_inserts.shape[1])
                + int(self.edge_deletes.shape[1])
                + int(self.feature_touches.size))

    def edge_nodes(self) -> np.ndarray:
        """Distinct endpoints of every inserted/deleted edge."""
        return np.unique(np.concatenate(
            [self.edge_inserts.ravel(), self.edge_deletes.ravel()]))

    def touched_nodes(self) -> np.ndarray:
        """Edge endpoints ∪ feature-touched rows — the invalidation frontier
        seed for scoped serve-side cache drops."""
        return np.unique(np.concatenate(
            [self.edge_nodes(), self.feature_touches]))

    def validate(self, n_nodes: int, feat_dim: int | None = None) -> None:
        for name, arr in (("edge_inserts", self.edge_inserts),
                          ("edge_deletes", self.edge_deletes),
                          ("feature_touches", self.feature_touches)):
            if arr.size and (arr.min() < 0 or arr.max() >= n_nodes):
                raise ValueError(
                    f"{name} references nodes outside [0, {n_nodes}) — node "
                    "insertion/removal is a re-partition, not a GraphDelta")
        if self.insert_w is not None:
            if self.insert_w.shape[0] != self.edge_inserts.shape[1]:
                raise ValueError("insert_w length must match edge_inserts")
            if self.insert_w.size and self.insert_w.min() <= 0:
                raise ValueError(
                    "insert weights must be > 0 (weight 0 is the padding "
                    "sentinel of the relocated edge tables)")
        if self.feature_values is not None:
            fv = np.asarray(self.feature_values)
            if fv.shape[0] != self.feature_touches.size:
                raise ValueError("feature_values rows must match feature_touches")
            if feat_dim is not None and fv.shape[1] != feat_dim:
                raise ValueError(
                    f"feature_values dim {fv.shape[1]} != graph feature dim {feat_dim}")


def apply_delta_to_graph(graph: GraphData, delta: GraphDelta) -> GraphData:
    """The order-preserving `GraphData` application of a delta.

    Deletes are removed by boolean-mask COMPACTION (first matching instance
    per requested multiplicity) and inserts APPEND — so every edge not named
    by the delta keeps its relative position. The serving layer depends on
    this: `repro_torch.serve.graph.ServeSampler`'s CSR rows of untouched receivers
    come out identical, which is what makes the scoped (frontier-walk) cache
    invalidation exact rather than heuristic.
    """
    feat_dim = None if graph.features is None else int(graph.features.shape[1])
    delta.validate(graph.n_nodes, feat_dim)
    n = graph.n_nodes
    s = graph.edge_index[0].astype(np.int64)
    r = graph.edge_index[1].astype(np.int64)
    keep = np.ones(s.shape[0], bool)
    if delta.edge_deletes.shape[1]:
        want: dict[int, int] = {}
        for kk in (delta.edge_deletes[0] * n + delta.edge_deletes[1]).tolist():
            want[kk] = want.get(kk, 0) + 1
        ekey = s * n + r
        for i in np.nonzero(np.isin(ekey, np.fromiter(want, np.int64, len(want))))[0]:
            kk = int(ekey[i])
            if want.get(kk, 0) > 0:
                keep[i] = False
                want[kk] -= 1
        missing = {kk: c for kk, c in want.items() if c}
        if missing:
            bad = [(kk // n, kk % n) for kk in list(missing)[:4]]
            raise ValueError(f"delta deletes absent edges, e.g. {bad}")
    ei = np.concatenate(
        [graph.edge_index[:, keep],
         delta.edge_inserts.astype(graph.edge_index.dtype)], axis=1)
    ew = graph.edge_weight
    ni = delta.edge_inserts.shape[1]
    if ew is not None or delta.insert_w is not None:
        base = (np.ones(s.shape[0], np.float32) if ew is None
                else np.asarray(ew, np.float32))
        iw = (np.ones(ni, np.float32) if delta.insert_w is None
              else delta.insert_w)
        ew = np.concatenate([base[keep], iw])
    feats = graph.features
    if delta.feature_touches.size and delta.feature_values is not None:
        feats = np.array(graph.features)
        feats[delta.feature_touches] = np.asarray(
            delta.feature_values, feats.dtype)
    return dataclasses.replace(
        graph, edge_index=ei, edge_weight=ew, features=feats)


# ========================================================== tile-level patch
# Shared by the standalone BlockedAdjacency path and the per-plan tables:
# recompute every TOUCHED 128×128 tile from the live edges (no incremental
# float adds — 200-step mutation runs must not accumulate drift), then
# append / overwrite / tombstone it in its ragged block row.
def _tile_updates(s, r, w, pairs, nbc: int, block: int, dense: bool = True):
    """Recompute the tiles containing any (row, col) in ``pairs``.

    ``(s, r, w)`` are the CURRENT (post-delta) edges in this table's column
    space; ``pairs`` is an (m, 2) [row, col] int array. Returns
    ``(rbs, cbs, live, tiles)`` — per touched tile its block row, block
    col, whether it still holds any edge (live=False marks a tombstone;
    its ``tiles`` row is zeros), and the recomputed dense tile. All touched
    tiles are rebuilt by ONE scatter-add: a whole-boundary sender remap
    touches thousands of tiles, and a per-tile loop here would dominate the
    repair. ``dense=False`` skips the tiles (``tiles`` is None): a rank
    table patches the other ranks' tile index only. Returns None when
    nothing is touched.
    """
    if pairs.shape[0] == 0:
        return None
    tkeys = np.unique((pairs[:, 0] // block) * nbc + pairs[:, 1] // block)
    key = (r // block) * nbc + (s // block)
    sel = np.isin(key, tkeys)
    ks, ss, rs, ws = key[sel], s[sel], r[sel], w[sel]
    pos = np.searchsorted(tkeys, ks)
    tiles = None
    if dense:
        tiles = np.zeros((tkeys.size, block, block), np.float32)
        np.add.at(tiles, (pos, rs % block, ss % block), ws)
    live = np.zeros(tkeys.size, bool)
    live[pos] = True
    return tkeys // nbc, tkeys % nbc, live, tiles


def _find_tile(cols_row: np.ndarray, valid: int, cb: int) -> int:
    pos = np.nonzero(cols_row[:valid] == cb)[0]
    return int(pos[0]) if pos.size else -1


def _apply_tile_update(vals, cols, lens, rb: int, cb: int, tile) -> None:
    """Overwrite / append / tombstone ONE tile in block row ``rb`` of a
    per-device ragged table ((R, T, B, B) vals, (R, T) cols, (R,) lens).
    The caller has already grown T if an append could overflow. Maintains
    the repeat-last cols padding contract and zeroes freed tiles (so a
    poisoned-padding check can prove the kernel never reads them).
    ``vals=None`` updates the tile index only (``tile`` is then any
    non-None value for an append).
    """
    valid = int(lens[rb])
    p = _find_tile(cols[rb], valid, cb)
    if tile is None:                      # tombstone: swap-remove, zero slot
        if p < 0:
            return
        last = valid - 1
        if vals is not None:
            vals[rb, p] = vals[rb, last]
            vals[rb, last] = 0.0
        cols[rb, p] = cols[rb, last]
        lens[rb] = last
        cols[rb, last:] = cols[rb, last - 1] if last > 0 else 0
        return
    if vals is None and p >= 0:
        return
    if p >= 0:                            # recomputed in place
        vals[rb, p] = tile
        return
    if vals is not None:
        vals[rb, valid] = tile            # append in the ragged row
    cols[rb, valid] = cb
    lens[rb] = valid + 1
    cols[rb, valid + 1:] = cb


def _grow_tiles(vals, cols, new_t: int):
    """Geometrically grown (… , T, B, B)/(… , T) tables; padding tiles are
    zero and padding cols repeat the previous last entry (contract-safe)."""
    pad = new_t - vals.shape[-3]
    vals = np.concatenate(
        [vals, np.zeros(vals.shape[:-3] + (pad,) + vals.shape[-2:], vals.dtype)],
        axis=-3)
    cols = np.concatenate([cols, np.repeat(cols[..., -1:], pad, axis=-1)], axis=-1)
    return vals, cols


def _sim_extra_tiles(vals, cols, lens, ups) -> int:
    """Max valid-tile count any block row reaches DURING ``ups`` — presence
    is read from the pre-patch table (tile updates are per-tile unique, so
    membership is stable under the other updates in the batch). Tracks the
    running count in apply order, not just the net: an append that precedes
    a tombstone in the same row transiently exceeds the final count, and
    `_apply_tile_update` replays ``ups`` in exactly this order."""
    need = int(lens.max(initial=0))
    per_row: dict[int, int] = {}
    for rb, cb, tile in ups:
        present = _find_tile(cols[rb], int(lens[rb]), cb) >= 0
        d = per_row.get(rb, 0)
        if tile is None and present:
            d -= 1
        elif tile is not None and not present:
            d += 1
        per_row[rb] = d
        need = max(need, int(lens[rb]) + d)
    return need


def delta_update_blocked_adjacency(
    ba: BlockedAdjacency,
    edge_index: np.ndarray,
    edge_weight: np.ndarray | None,
    delta: GraphDelta,
) -> BlockedAdjacency:
    """Patch a global `BlockedAdjacency` in place for one delta.

    ``edge_index``/``edge_weight`` are the POST-delta edges (what
    `apply_delta_to_graph` returned). Only the tiles containing a touched
    (receiver, sender) coordinate are recomputed; tombstoned tiles are
    swap-removed from their ragged row and zeroed. Equivalent — up to T
    padding, which never shrinks and grows geometrically — to re-running
    `repro_torch.graph.structure.blocked_adjacency` on the new edges.
    """
    s = np.asarray(edge_index[0], np.int64)
    r = np.asarray(edge_index[1], np.int64)
    w = (np.ones(s.shape[0], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    pairs = set()
    for arr in (delta.edge_inserts, delta.edge_deletes):
        for u, v in arr.T.tolist():
            if v >= ba.n_nodes or u >= ba.n_col_nodes:
                raise ValueError(
                    f"delta edge ({u}, {v}) outside the blocked "
                    f"{ba.n_nodes}×{ba.n_col_nodes} space")
            pairs.add((v, u))             # A[receiver, sender]
    parr = np.array(sorted(pairs), np.int64).reshape(-1, 2)
    res = _tile_updates(s, r, w, parr, ba.n_block_cols, ba.block)
    if res is None:
        return ba
    rbs, cbs, live, tiles = res
    # tombstones first: replaying must never transiently exceed a row's
    # final tile count (an append before a tombstone in the same row would
    # need a capacity slot the net count does not)
    ups = [(rb, cb, None)
           for rb, cb in zip(rbs[~live].tolist(), cbs[~live].tolist())]
    ups += [(rb, cb, tiles[i])
            for i, rb, cb in zip(np.nonzero(live)[0].tolist(),
                                 rbs[live].tolist(), cbs[live].tolist())]
    need = _sim_extra_tiles(ba.block_vals, ba.block_cols, ba.row_nnzb, ups)
    if need > ba.max_nnzb:
        ba.block_vals, ba.block_cols = _grow_tiles(
            ba.block_vals, ba.block_cols, max(need, 2 * ba.max_nnzb))
    for rb, cb, tile in ups:
        _apply_tile_update(ba.block_vals, ba.block_cols, ba.row_nnzb, rb, cb, tile)
    return ba


# ========================================================== re-localization
def _relocalized_assignment(
    n: int, edge_index: np.ndarray, k: int, *,
    block: int = 128, method: str = "bfs",
) -> np.ndarray:
    """The node→device assignment an online re-localization installs.

    Edges are first CANONICALIZED (lexsorted by (src, dst)) so the result is
    a pure function of the edge MULTISET — the planner's store groups edges
    by receiver device, a fresh builder sees them in input order, and
    `locality_block_order`'s BFS tie-breaks on edge order. Canonicalization
    is what makes ``drift_ratio == 1.0`` hold EXACTLY right after
    :meth:`DeltaPlanner.relocalize`: the drift denominator and the installed
    order are the same deterministic construction, however the edges happen
    to be stored. The locality order is then cut into k balanced contiguous
    chunks (devices keep equal loads; BFS neighbors stay co-resident).
    """
    from repro_torch.graph.structure import locality_block_order

    ei = np.asarray(edge_index, np.int64)
    canon = ei[:, np.lexsort((ei[1], ei[0]))]
    order = np.asarray(
        locality_block_order(n, canon, block, method=method), np.int64)
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    assignment = np.empty(n, np.int32)
    for i in range(k):
        assignment[order[bounds[i]:bounds[i + 1]]] = i
    return assignment


@dataclasses.dataclass
class RelocalizePolicy:
    """Hysteresis trigger for online re-localization.

    Attached to a :class:`DeltaPlanner`, the policy observes the
    ``drift_ratio`` after every edge-mutating apply and fires — i.e. the
    planner runs :meth:`DeltaPlanner.relocalize` — only when the ratio has
    exceeded ``threshold`` for ``patience`` CONSECUTIVE structural applies
    (one sub-threshold reading resets the streak). After firing, the next
    ``cooldown`` observations are ignored entirely, so a burst of churn
    cannot re-trigger while the fresh order is still settling.

    ``block``/``method`` parameterize both the drift measurement and the
    re-localization itself — they MUST agree, or post-fire drift is not
    exactly 1.0.
    """

    threshold: float = 1.25
    patience: int = 3
    cooldown: int = 10
    block: int = 128
    method: str = "bfs"
    streak: int = 0
    cooldown_left: int = 0

    def observe(self, drift_ratio: float) -> bool:
        """Feed one drift reading; True ⇒ the caller should relocalize."""
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            return False
        if drift_ratio > self.threshold:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.patience:
            self.streak = 0
            self.cooldown_left = self.cooldown
            return True
        return False


# =============================================================== DeltaPlanner
def _tile_index(s, r, n_rows: int, n_cols: int, block: int, width: int | None = None):
    """The tile index `repro_torch.graph.structure.blocked_adjacency` would
    give these edges — ``(cols (R, T), lens (R,))`` with the same in-row
    order (ascending column block) and repeat-last padding — without a
    tile. ``width`` pads T wider than this table's own."""
    nbr, nbc = -(-n_rows // block), -(-n_cols // block)
    uniq = np.unique((r // block) * nbc + s // block)
    ubr, ubc = uniq // nbc, uniq % nbc
    lens = np.bincount(ubr, minlength=nbr).astype(np.int32)
    t = max(int(lens.max(initial=1)), 1) if width is None else int(width)
    start = np.zeros(nbr + 1, np.int64)
    np.cumsum(lens, out=start[1:])
    cols = np.zeros((nbr, t), np.int32)
    cols[ubr, np.arange(uniq.size) - start[ubr]] = ubc
    last = cols[np.arange(nbr), np.maximum(lens - 1, 0)]
    pad = (np.arange(t)[None, :] >= lens[:, None]) & (lens[:, None] > 0)
    return np.where(pad, last[:, None], cols).astype(np.int32), lens


@dataclasses.dataclass
class RankTable:
    """One rank's blocked table of a planner's plan, kept current by every
    :meth:`DeltaPlanner.apply` (see :meth:`DeltaPlanner.rank_table`).

      vals : (R, T, B, B) float32 — THIS rank's tiles only
      cols : (k, R, T) int32      — every rank's column-block ids
      lens : (k, R) int32         — every rank's ragged tile counts

    T is the width all ranks share, agreed from the index: rank b's table
    equals slice b of the plan's all-rank table of the same form.
    ``last`` says what the last maintenance did to it: ``"built"``,
    ``"patched"`` (tiles recomputed in place), ``"unchanged"`` (the delta
    touched none of the table's tiles) or ``"rebuilt"`` (structural
    apply, re-localization, compaction); ``grown`` counts the patches that
    widened T, ``maintain_ms`` times the last patch or rebuild.
    """

    rank: int
    part: str
    block: int
    vals: np.ndarray
    cols: np.ndarray
    lens: np.ndarray
    n_rows: int
    n_cols: int
    last: str = "built"
    grown: int = 0
    maintain_ms: float = 0.0

    @property
    def max_nnzb(self) -> int:
        return int(self.cols.shape[-1])

    def blocked(self) -> BlockedAdjacency:
        """This rank's table as a `BlockedAdjacency` (views, no copy) — the
        form `plan_blocked_rank` returns, whose ``arrays()`` feed K1/K2."""
        return BlockedAdjacency(
            block_vals=self.vals, block_cols=self.cols[self.rank],
            row_nnzb=self.lens[self.rank], n_nodes=max(self.n_rows, 1),
            block=self.block, n_col_nodes=self.n_cols)

    @property
    def nbytes(self) -> int:
        return self.vals.nbytes + self.cols.nbytes + self.lens.nbytes


def _build_rank_table(plan: HaloPlan, rank: int, block: int, part: str) -> RankTable:
    """A fresh `RankTable`: every rank's index from its edges, this rank's
    tiles from `plan_blocked_rank` at the shared width (the all-rank
    table's T, the widest rank's)."""
    from repro_torch.dist.halo import plan_blocked_rank

    n_rows, n_cols = max(plan.n_local, 1), _part_columns(plan, part)
    edges = [_rank_edges(plan, b, part)[:2] for b in range(plan.k)]
    width = max(_tile_index(s, r, n_rows, n_cols, block)[0].shape[1] for s, r in edges)
    index = [_tile_index(s, r, n_rows, n_cols, block, width) for s, r in edges]
    cols = np.stack([c for c, _ in index])
    lens = np.stack([ln for _, ln in index])
    vals = plan_blocked_rank(plan, rank, block, part, max_nnzb=width).block_vals
    return RankTable(rank=rank, part=part, block=block, vals=vals, cols=cols, lens=lens,
                     n_rows=plan.n_local, n_cols=n_cols)


@dataclasses.dataclass
class _TierState:
    """One export tier's refcounted boundary bookkeeping.

    ref[d]     — {local row: #cut edges of this tier sourced at it}.
    exports[d] — slot → exported local row (python list; -1 marks a freed
                 hole). Slots are STABLE: v0 is the builder's sorted-unique
                 order, a new export takes the lowest freed slot (or
                 appends), and a surviving export NEVER moves — the property
                 that lets a non-structural repair remap only newly-cut
                 edges and tile-patch only delta-sized table regions.
    slot_arr   — (k, n_local) local row → slot (-1 = not exported); the
                 vectorized inverse of ``exports``.
    free[d]    — freed-slot min-heap (deterministic reuse order).
    pad        — the tier's padded segment width (s_max / s_loc / s_rem);
                 never shrinks, grows geometrically when the slot
                 high-water mark (len(exports[d]), holes included)
                 outgrows it.
    dirty      — devices whose export table row changed since last repair.
    """

    ref: list[dict[int, int]]
    exports: list[list[int]]
    slot_arr: np.ndarray
    free: list[list[int]]
    pad: int
    dirty: set[int] = dataclasses.field(default_factory=set)


class DeltaPlanner:
    """Mutable edge store + incremental plan repair for ONE partitioned graph.

    Materialize plans through :meth:`plan` (flat and hierarchical variants
    share the planner's slot layout, so one repair pass fixes all of them),
    then feed `GraphDelta` batches to :meth:`apply`. Each apply:

      1. updates the per-device edge store (delete = swap-fill, insert =
         append; per-device capacity ``e_local`` grows geometrically),
      2. refreshes only the DIRTY devices' export segments per tier, keeping
         pads when the new boundary fits and growing them geometrically
         otherwise (a *structural* repair),
      3. remaps `senders_l` only for edges whose encoding could have moved
         (sourced at a dirty device, or newly cut) — or for the whole cut
         class on a structural repair,
      4. patches the plans' memoized blocked adjacencies tile-wise
         (structural repairs drop them — the halo column space changed),
      5. re-registers every plan under the new versioned ``graph_key``
         (``{base}@d{version}``) and evicts the stale key, so plan-cache
         users migrate keys without ever re-running a builder.

    The node set and the partition are FIXED for the planner's lifetime —
    re-partitioning is `invalidate_halo_plans` + a fresh planner.
    """

    def __init__(self, part, edge_index: np.ndarray,
                 w: np.ndarray | None = None, *, graph_key: str | None = None,
                 relocalize_policy: "RelocalizePolicy | None" = None):
        self.part = part
        self.assignment = np.asarray(part.assignment, np.int64)
        self.k = int(part.k)
        self.n = int(part.n_nodes)
        src = np.asarray(edge_index[0], np.int64)
        dst = np.asarray(edge_index[1], np.int64)
        e = int(src.shape[0])
        w = np.ones(e, np.float32) if w is None else np.asarray(w, np.float32)
        self.base_key = (graph_fingerprint(self.n, edge_index, w, self.assignment)
                         if graph_key is None else graph_key)
        self.version = 0
        self.relocalize_policy = relocalize_policy
        # (block, method) → (era, executed_tiles_reordered): the memoized
        # fresh-reorder denominator of `locality_drift`. The era advances on
        # structural applies and rebuilds, so non-structural applies reuse
        # the BFS result instead of re-running it per apply.
        self._drift_era = 0
        self._drift_memo: dict[tuple[int, str], tuple[int, int]] = {}
        self._init_layout()
        self._init_store(src, dst, w)
        self._tiers: dict[tuple[str, int], _TierState] = {}
        self._plans: dict[object, HaloPlan] = {}

    def _init_layout(self) -> None:
        """(Re)derive the blocked layout from ``self.assignment``."""
        perm, sizes, n_local, local = _blocked_layout(self.assignment, self.k, self.n)
        self.perm, self.part_sizes, self.n_local, self.local = perm, sizes, n_local, local
        # node_of[b, local_row] — inverse of `local` per device block.
        self.node_of = np.zeros((self.k, max(n_local, 1)), np.int64)
        off = 0
        for b in range(self.k):
            sz = int(sizes[b])
            self.node_of[b, :sz] = perm[off:off + sz]
            off += sz

    def _init_store(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> None:
        """(Re)build the per-receiver-device edge store — same stable
        grouping as `_group_edges_by_receiver`, so the first materialized
        plan is bit-identical to `build_halo_plan`."""
        e = int(src.shape[0])
        local = self.local
        a_d = self.assignment[dst]
        counts = np.bincount(a_d, minlength=self.k).astype(np.int64)
        self.e_local = max(int(counts.max()) if e else 0, 1)
        self._cnt = counts
        self._src = np.zeros((self.k, self.e_local), np.int64)
        self._dst = np.zeros((self.k, self.e_local), np.int32)
        self._w = np.zeros((self.k, self.e_local), np.float32)
        start = np.zeros(self.k + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        self._pos: list[dict[tuple[int, int], list[int]]] = [
            {} for _ in range(self.k)]
        if e:
            order = np.argsort(a_d, kind="stable")
            own = a_d[order]
            slot = np.arange(e, dtype=np.int64) - start[own]
            self._src[own, slot] = src[order]
            self._dst[own, slot] = local[dst[order]].astype(np.int32)
            self._w[own, slot] = w[order]
            for b, sl, u, v in zip(own.tolist(), slot.tolist(),
                                   src[order].tolist(), dst[order].tolist()):
                self._pos[b].setdefault((u, v), []).append(sl)
        self._new_cut: np.ndarray | None = None

    # ------------------------------------------------------------- identity
    @property
    def graph_key(self) -> str:
        """The current plan-cache key: base for v0, ``{base}@d{v}`` after."""
        return self.base_key if self.version == 0 else f"{self.base_key}@d{self.version}"

    @property
    def n_edges(self) -> int:
        return int(self._cnt.sum())

    def edge_index(self) -> np.ndarray:
        """Current (2, E) global edges, grouped by receiver device."""
        cols = [np.stack([self._src[b, :self._cnt[b]],
                          self.node_of[b, self._dst[b, :self._cnt[b]]]])
                for b in range(self.k)]
        return (np.concatenate(cols, axis=1) if cols
                else np.zeros((2, 0), np.int64))

    def edge_weights(self) -> np.ndarray:
        """Current (E,) weights, aligned with :meth:`edge_index`'s order."""
        return np.concatenate(
            [self._w[b, :self._cnt[b]] for b in range(self.k)])

    # ----------------------------------------------------------------- tiers
    def _tier_member(self, kind: str, pods: int, a_s, a_d):
        if kind == "flat":
            return a_s != a_d
        km = self.k // pods
        if kind == "loc":
            return (a_s != a_d) & (a_s // km == a_d // km)
        return a_s // km != a_d // km

    def _ensure_tier(self, kind: str, pods: int) -> _TierState:
        key = (kind, int(pods))
        ts = self._tiers.get(key)
        if ts is not None:
            return ts
        grid = np.arange(self.e_local)[None, :] < self._cnt[:, None]
        a_s = self.assignment[self._src]
        owner = np.broadcast_to(
            np.arange(self.k, dtype=np.int64)[:, None], a_s.shape)
        m = grid & self._tier_member(kind, pods, a_s, owner)
        ref: list[dict[int, int]] = [{} for _ in range(self.k)]
        if m.any():
            pair = a_s[m] * self.n + self._src[m]
            uniq, cnts = np.unique(pair, return_counts=True)
            dev, node = uniq // self.n, uniq % self.n
            lrows = self.local[node]
            for d, lr, c in zip(dev.tolist(), lrows.tolist(), cnts.tolist()):
                ref[d][lr] = c
        exports = [sorted(ref[d]) for d in range(self.k)]
        slot_arr = np.full((self.k, max(self.n_local, 1)), -1, np.int64)
        for d in range(self.k):
            if exports[d]:
                slot_arr[d, np.asarray(exports[d], np.int64)] = np.arange(
                    len(exports[d]))
        ts = _TierState(ref=ref, exports=exports, slot_arr=slot_arr,
                        free=[[] for _ in range(self.k)],
                        pad=max((len(ex) for ex in exports), default=0))
        self._tiers[key] = ts
        return ts

    def _bump_tiers(self, a_s: int, a_d: int, lrow: int, dlt: int) -> None:
        # per-edge hot path (apply's delete/insert loops): membership is
        # inlined rather than routed through `_tier_member`
        k = self.k
        for (kind, pods), ts in self._tiers.items():
            if kind == "flat":
                member = a_s != a_d
            else:
                km = k // pods
                if kind == "loc":
                    member = a_s != a_d and a_s // km == a_d // km
                else:
                    member = a_s // km != a_d // km
            if not member:
                continue
            ref = ts.ref[a_s]
            c = ref.get(lrow, 0) + dlt
            if c <= 0:
                if lrow in ref:
                    del ref[lrow]
                    ts.dirty.add(a_s)
                    slot = int(ts.slot_arr[a_s, lrow])
                    ts.slot_arr[a_s, lrow] = -1
                    ts.exports[a_s][slot] = -1
                    heapq.heappush(ts.free[a_s], slot)
            else:
                if c == 1 and dlt > 0:
                    ts.dirty.add(a_s)
                    exp = ts.exports[a_s]
                    fr = ts.free[a_s]
                    slot = heapq.heappop(fr) if fr else len(exp)
                    if slot == len(exp):
                        exp.append(lrow)
                    else:
                        exp[slot] = lrow
                    ts.slot_arr[a_s, lrow] = slot
                ref[lrow] = c

    def _tier_lookup(self, ts: _TierState):
        """Vectorized (devs, global nodes) → STABLE slot resolver — one
        fancy read off the tier's dense row→slot inverse."""
        slot_arr, local = ts.slot_arr, self.local

        def slots(devs, nodes):
            return slot_arr[devs, local[nodes]]

        return slots

    def _send_table(self, ts: _TierState) -> np.ndarray:
        tbl = np.zeros((self.k, ts.pad), np.int32)
        for d in range(self.k):
            ex = np.asarray(ts.exports[d], np.int64)
            if ex.size:
                row = tbl[d, :ex.size]
                valid = ex >= 0
                row[valid] = ex[valid]    # freed holes stay 0: no receiver
        return tbl                        # ever references them

    # ----------------------------------------------------------------- plans
    def plan(self, axes: tuple[str, ...] = ("model",), pods: int = 1) -> HaloPlan:
        """The (memoized) plan for one schedule; repaired in place by every
        subsequent :meth:`apply` and registered in the global plan cache
        under the planner's current ``graph_key``."""
        axes = tuple(axes)
        pods = int(pods)
        if len(axes) not in (1, 2) or (len(axes) == 1 and pods != 1):
            raise ValueError(f"bad schedule: axes={axes!r} pods={pods}")
        if pods < 1 or self.k % pods:
            raise ValueError(f"pods={pods} must divide k={self.k}")
        key_axes = axes[0] if len(axes) == 1 else (axes, pods)
        p = self._plans.get(key_axes)
        if p is None:
            p = self._materialize_plan(axes, pods)
            self._plans[key_axes] = p
            register_halo_plan(
                self.graph_key, self.k,
                axes[0] if len(axes) == 1 else axes, pods=pods, plan=p)
        return p

    def _materialize_plan(self, axes: tuple[str, ...], pods: int) -> HaloPlan:
        flat = self._ensure_tier("flat", 1)
        k, n_local, cap = self.k, self.n_local, self.e_local
        grid = np.arange(cap)[None, :] < self._cnt[:, None]
        a_s = self.assignment[self._src]
        owner = np.broadcast_to(np.arange(k, dtype=np.int64)[:, None], a_s.shape)
        senders = np.zeros((k, cap), np.int32)
        interior = grid & (a_s == owner)
        senders[interior] = self.local[self._src[interior]].astype(np.int32)
        cut = grid & (a_s != owner)
        if len(axes) == 2:
            loc = self._ensure_tier("loc", pods)
            rem = self._ensure_tier("rem", pods)
            km = k // pods
            b_width = loc.pad + pods * rem.pad
            icut = cut & (a_s // km == owner // km)
            xcut = grid & (a_s // km != owner // km)
            if icut.any():
                d_, nd_ = a_s[icut], self._src[icut]
                senders[icut] = (n_local + (d_ % km) * b_width
                                 + self._tier_lookup(loc)(d_, nd_))
            if xcut.any():
                d_, nd_ = a_s[xcut], self._src[xcut]
                senders[xcut] = (n_local + (d_ % km) * b_width + loc.pad
                                 + (d_ // km) * rem.pad
                                 + self._tier_lookup(rem)(d_, nd_))
            s_loc, s_rem = loc.pad, rem.pad
            send_loc, send_rem = self._send_table(loc), self._send_table(rem)
        else:
            s_loc = s_rem = 0
            send_loc = send_rem = None
            if cut.any():
                d_, nd_ = a_s[cut], self._src[cut]
                senders[cut] = (n_local + d_ * flat.pad
                                + self._tier_lookup(flat)(d_, nd_))
        # receivers_l / edge_w are the store arrays THEMSELVES — all plans
        # of this planner share them, so the store update in `apply` is the
        # plan update.
        return HaloPlan(
            k=k, n_local=n_local, s_max=flat.pad, e_local=cap, n_nodes=self.n,
            perm=self.perm, send_idx=self._send_table(flat), senders_l=senders,
            receivers_l=self._dst, edge_w=self._w, part_sizes=self.part_sizes,
            axes=axes, n_pods=pods, s_loc=s_loc, s_rem=s_rem,
            send_loc=send_loc, send_rem=send_rem,
        )

    # ----------------------------------------------------------------- store
    def _grow_capacity(self, new_cap: int) -> None:
        add = new_cap - self.e_local

        def wide(a):
            return np.concatenate(
                [a, np.zeros((self.k, add), a.dtype)], axis=1)

        self._src, self._dst, self._w = wide(self._src), wide(self._dst), wide(self._w)
        if self._new_cut is not None:
            self._new_cut = wide(self._new_cut)
        for p in self._plans.values():
            p.senders_l = wide(p.senders_l)
            p.receivers_l, p.edge_w = self._dst, self._w
            p.e_local = new_cap
        self.e_local = new_cap

    # ----------------------------------------------------------------- apply
    def apply(self, delta: GraphDelta, *, measure_drift: bool = False,
              drift_block: int = 128) -> dict:
        """Apply one delta; repair every materialized plan in place; migrate
        the plan-cache entries to the new versioned key. Returns a repair
        report (counts of dirty devices, remapped senders, patched/dropped
        blocked tables, grown pads, repair latency ``apply_ms``, and the
        ``structural`` flag — True when some tier's pads grew, i.e. the
        halo column space changed and memoized blocked tables were dropped
        rather than patched). ``measure_drift=True`` additionally runs
        :meth:`locality_drift` on the post-apply graph and attaches the
        executed-tile drift record under ``"drift"`` (None otherwise).
        When `repro_torch.obs.metrics` is enabled the report is mirrored into the
        ``delta.*`` series."""
        t_apply = time.perf_counter()
        delta.validate(self.n)
        old_key = self.graph_key
        plans = list(self._plans.values())
        track = {id(p): bool(p.__dict__.get("_blocked_cache") or p.__dict__.get("_rank_tables"))
                 for p in plans}
        pairs = {id(p): [set() for _ in range(self.k)] for p in plans}
        self._new_cut = np.zeros((self.k, self.e_local), bool)

        # -- 1. deletes (batched hole-fill; tiles captured pre-remap) -------
        # The replan latency budget (the 1%-delta bench gate) lives here, so
        # deletes run in two phases: a dict-only python pass resolving each
        # delete to a slot, then one vectorized compaction per device —
        # survivors from the tail drop into the holes in a single fancy
        # write instead of an edge-at-a-time swap-fill.
        src, dst, w_arr = self._src, self._dst, self._w
        new_cut, node_of = self._new_cut, self.node_of
        pos, cnt = self._pos, self._cnt
        plan_sl = [(p.senders_l, pairs[id(p)] if track[id(p)] else None)
                   for p in plans]
        dels = delta.edge_deletes
        del_slots: list[list[int]] = [[] for _ in range(self.k)]
        for u, v, b, a_u, lrow_u in zip(
                dels[0].tolist(), dels[1].tolist(),
                self.assignment[dels[1]].tolist(),
                self.assignment[dels[0]].tolist(),
                self.local[dels[0]].tolist()):
            slots = pos[b].get((u, v))
            if not slots:
                raise ValueError(f"delta deletes absent edge ({u}, {v})")
            # oldest instance first — same parallel-edge tie-break as
            # `apply_delta_to_graph`'s in-order scan, so weighted duplicate
            # edges stay in lockstep between the two representations
            del_slots[b].append(slots.pop(0))
            if not slots:
                del pos[b][(u, v)]
            self._bump_tiers(a_u, b, lrow_u, -1)
        for b, dead in enumerate(del_slots):
            if not dead:
                continue
            s_arr = np.asarray(dead, np.int64)
            for sl, ppairs in plan_sl:
                if ppairs is not None:
                    ppairs[b].update(zip(dst[b, s_arr].tolist(),
                                         sl[b, s_arr].tolist()))
            cnt_b = int(cnt[b])
            keep_n = cnt_b - len(dead)
            dead_set = set(dead)
            movers = [t for t in range(keep_n, cnt_b) if t not in dead_set]
            if movers:
                holes = sorted(s for s in dead_set if s < keep_n)
                mv = np.asarray(movers, np.int64)
                hl = np.asarray(holes, np.int64)
                mus = src[b, mv].tolist()
                mvs = node_of[b, dst[b, mv]].tolist()
                src[b, hl] = src[b, mv]
                dst[b, hl] = dst[b, mv]
                w_arr[b, hl] = w_arr[b, mv]
                new_cut[b, hl] = new_cut[b, mv]
                for sl, _ in plan_sl:
                    sl[b, hl] = sl[b, mv]
                for mu, mvv, old_t, new_t in zip(mus, mvs, movers, holes):
                    moved = pos[b][(mu, mvv)]
                    moved[moved.index(old_t)] = new_t
            tail = slice(keep_n, cnt_b)
            src[b, tail] = 0
            dst[b, tail] = 0
            w_arr[b, tail] = 0.0
            new_cut[b, tail] = False
            for sl, _ in plan_sl:
                sl[b, tail] = 0
            cnt[b] = keep_n

        # -- 2. inserts (append; cut senders resolved in the remap pass) ----
        # Also batched per device: one bulk tail write per device, python
        # only for the _pos bookkeeping and the tier bumps of cut edges.
        n_ins = delta.edge_inserts.shape[1]
        ins_w = (np.ones(n_ins, np.float32) if delta.insert_w is None
                 else delta.insert_w)
        inss = delta.edge_inserts
        if n_ins:
            ins_b = self.assignment[inss[1]]
            need = int((cnt + np.bincount(ins_b, minlength=self.k)).max())
            if need > self.e_local:
                cap = self.e_local
                while cap < need:
                    cap *= 2
                self._grow_capacity(cap)
                plans = list(self._plans.values())
                src, dst, w_arr = self._src, self._dst, self._w
                new_cut = self._new_cut
                plan_sl = [(p.senders_l,
                            pairs[id(p)] if track[id(p)] else None)
                           for p in plans]
            ins_as = self.assignment[inss[0]]
            ins_lu = self.local[inss[0]]
            ins_lv = self.local[inss[1]]
            # stable grouping keeps each device's append order = the delta's
            # edge order (the oldest-first _pos contract)
            order = np.argsort(ins_b, kind="stable")
            bounds = np.searchsorted(ins_b[order], np.arange(self.k + 1))
            for b in range(self.k):
                idx = order[bounds[b]:bounds[b + 1]]
                if not idx.size:
                    continue
                slots = int(cnt[b]) + np.arange(idx.size, dtype=np.int64)
                cnt[b] += idx.size
                src[b, slots] = inss[0, idx]
                dst[b, slots] = ins_lv[idx]
                w_arr[b, slots] = ins_w[idx]
                for u, v, s in zip(inss[0, idx].tolist(),
                                   inss[1, idx].tolist(), slots.tolist()):
                    pos[b].setdefault((u, v), []).append(s)
                interior = ins_as[idx] == b
                lus = ins_lu[idx]
                for sl, ppairs in plan_sl:
                    sl[b, slots[interior]] = lus[interior]
                    if ppairs is not None:
                        ppairs[b].update(zip(ins_lv[idx][interior].tolist(),
                                             lus[interior].tolist()))
                new_cut[b, slots[~interior]] = True
                for a_u, lu in zip(ins_as[idx][~interior].tolist(),
                                   lus[~interior].tolist()):
                    self._bump_tiers(a_u, b, lu, +1)

        # -- 3. tier refresh: pads keep-or-grow on the slot high-water mark
        # (exports/slots were maintained in place by `_bump_tiers`) ---------
        pads_grown: list[tuple[str, int]] = []
        tier_info: dict[tuple[str, int], tuple[set[int], bool]] = {}
        for key, ts in self._tiers.items():
            needed = max((len(ex) for ex in ts.exports), default=0)
            grew = needed > ts.pad
            if grew:
                ts.pad = needed if ts.pad == 0 else max(needed, 2 * ts.pad)
                pads_grown.append(key)
            tier_info[key] = (set(ts.dirty), grew)
            ts.dirty.clear()

        # -- 4. per-plan sender remap + blocked patch ----------------------
        # ONE nonzero over the cut mask extracts every cut edge; all class
        # selection (intra/inter pod, dirty-sourced, newly-cut) then runs on
        # the extracted ~|cut| vectors instead of repeated (k, e_local) mask
        # algebra — the other half of the 1%-delta bench gate.
        grid = np.arange(self.e_local)[None, :] < self._cnt[:, None]
        a_s = self.assignment[self._src]
        owner = np.broadcast_to(
            np.arange(self.k, dtype=np.int64)[:, None], a_s.shape)
        cut = grid & (a_s != owner)
        bm, sm = np.nonzero(cut)
        d_cut = a_s[bm, sm]
        n_cut = self._src[bm, sm]
        nc_cut = self._new_cut[bm, sm]
        pod_sel: dict[int, np.ndarray] = {}
        remapped = 0
        patched = dropped = 0
        self._tables_grown = 0
        flat_info = tier_info.get(("flat", 1), (set(), False))
        all_cut = np.ones(d_cut.size, bool)
        for p in plans:
            ppairs = pairs[id(p)]
            if p.is_hierarchical:
                pods = p.n_pods
                km = p.k_model
                loc = self._tiers[("loc", pods)]
                rem = self._tiers[("rem", pods)]
                loc_info = tier_info[("loc", pods)]
                rem_info = tier_info[("rem", pods)]
                structural = loc_info[1] or rem_info[1]
                p.s_loc, p.s_rem = loc.pad, rem.pad
                b_width = p.block_rows
                same_pod = pod_sel.get(pods)
                if same_pod is None:
                    same_pod = pod_sel[pods] = d_cut // km == bm // km
                lslots, rslots = self._tier_lookup(loc), self._tier_lookup(rem)
                remapped += self._remap_class(
                    p, bm, sm, d_cut, n_cut, nc_cut,
                    same_pod, structural,
                    lambda d_, nd_: (self.n_local + (d_ % km) * b_width
                                     + lslots(d_, nd_)),
                    ppairs if track[id(p)] else None)
                remapped += self._remap_class(
                    p, bm, sm, d_cut, n_cut, nc_cut,
                    ~same_pod, structural,
                    lambda d_, nd_: (self.n_local + (d_ % km) * b_width
                                     + loc.pad + (d_ // km) * rem.pad
                                     + rslots(d_, nd_)),
                    ppairs if track[id(p)] else None)
                if loc_info[0] or loc_info[1] or structural:
                    p.send_loc = self._send_table(loc)
                if rem_info[0] or rem_info[1] or structural:
                    p.send_rem = self._send_table(rem)
            else:
                flat = self._tiers[("flat", 1)]
                structural = flat_info[1]
                p.s_max = flat.pad
                fslots = self._tier_lookup(flat)
                remapped += self._remap_class(
                    p, bm, sm, d_cut, n_cut, nc_cut,
                    all_cut, structural,
                    lambda d_, nd_: self.n_local + d_ * flat.pad + fslots(d_, nd_),
                    ppairs if track[id(p)] else None)
            # every plan carries the flat table as the accounting baseline
            flat = self._tiers[("flat", 1)]
            p.s_max = flat.pad
            if flat_info[0] or flat_info[1]:
                p.send_idx = self._send_table(flat)
            cache = p.__dict__.get("_blocked_cache")
            ranks = p.__dict__.get("_rank_tables") or {}
            if structural:
                if cache:
                    dropped += len(cache)
                p.__dict__.pop("_blocked_cache", None)
                dropped += self._rebuild_rank_tables(p)
            elif cache or ranks:
                patched += self._patch_blocked(p, cache or {}, ranks, ppairs)
            p.__dict__.pop("_edge_locality_cache", None)
        self._new_cut = None

        # -- 5. versioned re-key: stale key evicted, plans re-registered ----
        self.version += 1
        evicted = invalidate_halo_plans(old_key)
        for key_axes, p in self._plans.items():
            if isinstance(key_axes, str):
                register_halo_plan(self.graph_key, self.k, key_axes, plan=p)
            else:
                axes, pods = key_axes
                register_halo_plan(self.graph_key, self.k, axes,
                                   pods=pods, plan=p)
        if pads_grown:
            # structural apply: the halo column space changed, so the
            # memoized fresh-reorder drift denominator is refreshed too
            self._drift_era += 1
        pol = self.relocalize_policy
        edge_ops = bool(n_ins or delta.edge_deletes.shape[1])
        # the policy watches drift at ITS OWN granularity (pol.block, the
        # tile size it would re-localize at) — not the report's drift_block
        pol_drift = (self.locality_drift(pol.block, method=pol.method)
                     if pol is not None and edge_ops else None)
        drift = self.locality_drift(drift_block) if measure_drift else pol_drift
        report = {
            "graph_key": self.graph_key,
            "version": self.version,
            "inserts": n_ins,
            "deletes": int(delta.edge_deletes.shape[1]),
            "dirty_devices": {f"{kind}/{pods}": len(info[0])
                              for (kind, pods), info in tier_info.items()},
            "pads_grown": [f"{kind}/{pods}" for kind, pods in pads_grown],
            "senders_remapped": remapped,
            "blocked_patched": patched,
            "blocked_dropped": dropped,
            "blocked_grown": self._tables_grown,
            "stale_keys_evicted": evicted,
            "structural": bool(pads_grown),
            "apply_ms": (time.perf_counter() - t_apply) * 1e3,
            "drift": drift,
            "relocalized": None,
        }
        if (pol is not None and edge_ops
                and pol.observe(pol_drift["drift_ratio"])):
            report["relocalized"] = self.relocalize(
                block=pol.block, method=pol.method)
            report["graph_key"] = self.graph_key
            report["version"] = self.version
        if _obs_metrics.enabled():
            from repro_torch.obs.instrument import record_delta_report

            record_delta_report(report)
        _obs_trace.instant("delta.apply", {
            "inserts": report["inserts"], "deletes": report["deletes"],
            "apply_ms": report["apply_ms"],
        })
        return report

    def locality_drift(self, block: int = 128, method: str = "bfs") -> dict:
        """Executed-tile locality drift of the mutated graph (the ROADMAP
        drift-metrics item): how much blocked-layout quality the CURRENT
        node order has lost to mutations, measured in the executed-tile
        currency the ragged bsr kernel actually pays.

        Both sides are O(E) `repro_torch.graph.structure.blocked_stats` counts
        over the SAME current edge list, differing only in node order:

          * ``executed_tiles_current``   — edges relabeled by the planner's
            live blocked layout (``perm``, the order every patched blocked
            table tiles over),
          * ``executed_tiles_reordered`` — edges relabeled by the order an
            online re-localization WOULD install: the canonicalized
            `repro_torch.graph.structure.locality_block_order` of the mutated
            graph, cut into k balanced device chunks
            (`_relocalized_assignment` — the exact construction
            :meth:`relocalize` runs, so right after a re-localization the
            two sides coincide and ``drift_ratio == 1.0`` exactly).

        ``drift_ratio = current / reordered`` — 1.0 means the standing
        order is still as tile-dense as a re-localization would be; growth
        beyond a caller-chosen threshold (see :class:`RelocalizePolicy`) is
        the re-localize trigger. The ``reordered`` term is memoized per
        drift era — non-structural applies reuse it instead of re-running
        BFS; structural applies, :meth:`relocalize`, and :meth:`compact`
        rebuilds advance the era and refresh it. Mirrored into the
        ``delta.drift_ratio`` gauge when metrics are enabled."""
        from repro_torch.graph.structure import blocked_stats, permute_edge_index

        ei = self.edge_index()
        cur_edges = permute_edge_index(self.perm, ei)
        current = blocked_stats(self.n, cur_edges, block)["nnz_blocks"]
        memo = self._drift_memo.get((block, method))
        if memo is not None and memo[0] == self._drift_era:
            reordered = memo[1]
        else:
            fresh_a = _relocalized_assignment(
                self.n, ei, self.k, block=block, method=method)
            fresh_perm = np.argsort(fresh_a, kind="stable").astype(np.int64)
            reordered = int(blocked_stats(
                self.n, permute_edge_index(fresh_perm, ei), block)["nnz_blocks"])
            self._drift_memo[(block, method)] = (self._drift_era, reordered)
        drift = {
            "block": block,
            "executed_tiles_current": int(current),
            "executed_tiles_reordered": int(reordered),
            "drift_ratio": current / max(reordered, 1),
        }
        if _obs_metrics.enabled():
            _obs_metrics.set_gauge("delta.drift_ratio", drift["drift_ratio"])
            _obs_metrics.set_gauge("delta.executed_tiles_current", current)
            _obs_metrics.set_gauge("delta.executed_tiles_reordered", reordered)
        return drift

    # -------------------------------------------------- online maintenance
    def _host_bytes(self) -> int:
        """Host bytes held by the store, the plan tables, and the memoized
        blocked tiles — the pad-compaction accounting currency."""
        total = self._src.nbytes + self._dst.nbytes + self._w.nbytes
        for p in self._plans.values():
            total += p.senders_l.nbytes + p.send_idx.nbytes
            if p.send_loc is not None:
                total += p.send_loc.nbytes
            if p.send_rem is not None:
                total += p.send_rem.nbytes
            for key, entry in (p.__dict__.get("_blocked_cache") or {}).items():
                tabs = (entry if isinstance(key, tuple) and key[0] == "split"
                        else (entry,))
                for t in tabs:
                    total += t.vals.nbytes + t.cols.nbytes + t.lens.nbytes
            total += sum(rt.nbytes for rt in (p.__dict__.get("_rank_tables") or {}).values())
        return total

    def _rebuild_in_place(self, assignment: np.ndarray, part,
                          edge_index: np.ndarray, w: np.ndarray) -> None:
        """Swap in a (possibly new) assignment and rebuild everything tight:
        layout, edge store, tiers (fresh pads = exact occupancy), and every
        materialized plan — IN PLACE, preserving plan object identity so
        callers holding a plan reference keep working. Bumps the version and
        migrates the plan-cache entries to the new key."""
        old_key = self.graph_key
        self.part = part
        self.assignment = np.asarray(assignment, np.int64)
        self._init_layout()
        self._init_store(np.asarray(edge_index[0], np.int64),
                         np.asarray(edge_index[1], np.int64),
                         np.asarray(w, np.float32))
        tier_keys = list(self._tiers)
        self._tiers = {}
        for kind, pods in tier_keys:
            self._ensure_tier(kind, pods)
        for p in self._plans.values():
            q = self._materialize_plan(p.axes, p.n_pods)
            p.__dict__.pop("_blocked_cache", None)
            p.__dict__.pop("_edge_locality_cache", None)
            for f in dataclasses.fields(HaloPlan):
                setattr(p, f.name, getattr(q, f.name))
            self._rebuild_rank_tables(p)
        self.version += 1
        self._drift_era += 1
        self._drift_memo.clear()
        invalidate_halo_plans(old_key)
        for key_axes, p in self._plans.items():
            if isinstance(key_axes, str):
                register_halo_plan(self.graph_key, self.k, key_axes, plan=p)
            else:
                axes, pods = key_axes
                register_halo_plan(self.graph_key, self.k, axes,
                                   pods=pods, plan=p)

    def relocalize(self, *, block: int = 128, method: str = "bfs") -> dict:
        """Online re-localization: install a fresh locality order on the
        MUTATED graph, in place (docs/communication.md §8).

        Recomputes `locality_block_order` on the current edges (canonical
        form, `_relocalized_assignment`), cuts it into k balanced device
        chunks, and rebuilds layout, store, tiers, and every materialized
        plan under the new order — pads drop to exact occupancy, blocked
        caches rebuild lazily and tight, and the plan cache re-keys to the
        next version. Returns a report carrying ``old_layout`` — a frozen
        :class:`repro_torch.dist.halo.PlanLayout` of the PRE-relocalize blocked
        layout, which is exactly what `repro_torch.train.elastic.relocate_state_tree`
        needs to move live per-node training state (params, optimizer
        moments) into the new row order. Forward results are bit-equivalent
        before vs. after modulo row order (the subprocess equivalence test).

        Immediately afterwards ``locality_drift(block, method) == 1.0``
        exactly: the installed order IS the drift denominator's
        construction, and the memo is seeded with the just-measured tiles.
        """
        t0 = time.perf_counter()
        with _obs_trace.span("delta.relocalize", args={"block": block}):
            from repro_torch.graph.structure import blocked_stats, permute_edge_index

            ei = self.edge_index()
            w = self.edge_weights()
            old_layout = plan_layout(self)
            tiles_before = int(blocked_stats(
                self.n, permute_edge_index(self.perm, ei), block)["nnz_blocks"])
            pads_before = {f"{kind}/{pods}": ts.pad
                           for (kind, pods), ts in self._tiers.items()}
            assignment = _relocalized_assignment(
                self.n, ei, self.k, block=block, method=method)
            part = partition_from_assignment(assignment, self.k, ei)
            self._rebuild_in_place(assignment, part, ei, w)
            tiles_after = int(blocked_stats(
                self.n, permute_edge_index(self.perm, ei), block)["nnz_blocks"])
            # the installed order is the drift denominator's construction —
            # seed the memo so the next drift read costs no BFS
            self._drift_memo[(block, method)] = (self._drift_era, tiles_after)
            report = {
                "graph_key": self.graph_key,
                "version": self.version,
                "block": block,
                "method": method,
                "executed_tiles_before": tiles_before,
                "executed_tiles_after": tiles_after,
                "pads_before": pads_before,
                "pads_after": {f"{kind}/{pods}": ts.pad
                               for (kind, pods), ts in self._tiers.items()},
                "old_layout": old_layout,
                "relocalize_ms": (time.perf_counter() - t0) * 1e3,
            }
        if _obs_metrics.enabled():
            from repro_torch.obs.instrument import record_relocalize_report

            record_relocalize_report(report)
        return report

    def _tight(self) -> tuple[bool, list]:
        """(planner tight?, loose blocked-cache entries).

        Tight = no reclaimable slack anywhere: every tier is hole-free with
        pad == occupancy and builder-canonical (sorted) slot order, and the
        store capacity equals the live max. Loose blocked entries are cache
        keys whose tile capacity exceeds the live ragged maximum."""
        store_tight = self.e_local == max(int(self._cnt.max(initial=0)), 1)
        tiers_tight = all(
            not any(ts.free)
            and all(x >= 0 for ex in ts.exports for x in ex)
            and all(ex == sorted(ex) for ex in ts.exports)
            and ts.pad == max((len(ex) for ex in ts.exports), default=0)
            for ts in self._tiers.values())
        loose = []
        for p in self._plans.values():
            cache = p.__dict__.get("_blocked_cache")
            if not cache:
                continue
            for key, entry in cache.items():
                tabs = (entry if isinstance(key, tuple) and key[0] == "split"
                        else (entry,))
                if any(t.max_nnzb > max(int(t.lens.max(initial=0)), 1)
                       for t in tabs):
                    loose.append((p, key))
        for p in self._plans.values():
            for key, rt in (p.__dict__.get("_rank_tables") or {}).items():
                if rt.max_nnzb > max(int(rt.lens.max(initial=0)), 1):
                    loose.append((p, ("rank",) + key))
        return store_tight and tiers_tight, loose

    def compact(self) -> dict:
        """Shrink pads and tile capacities from their high-water marks back
        to current occupancy (docs/communication.md §8).

        Three outcomes, cheapest wins:

          * everything already tight → full no-op (``changed=False``; no
            version bump, plans untouched — a v0 planner stays bit-identical
            to `build_halo_plan`),
          * planner tight but some memoized blocked tables over-provisioned
            → drop just those cache entries (they rebuild lazily and tight;
            no version bump — the plan TABLES are unchanged),
          * otherwise → full in-place rebuild under the CURRENT assignment:
            slot heaps re-pack, survivors remap, pads drop to exact
            occupancy, and the plan cache re-keys to the next version
            (receivers still hold the old key's plans — same contract as a
            structural apply).

        Returns a report with per-tier ``pad_rows_reclaimed`` and
        ``bytes_reclaimed`` (host bytes across store, plan tables, and
        blocked tiles). Mirrored to ``delta.compact*`` metrics.
        """
        t0 = time.perf_counter()
        bytes_before = self._host_bytes()
        pads_before = {f"{kind}/{pods}": ts.pad
                       for (kind, pods), ts in self._tiers.items()}
        e_local_before = self.e_local
        tight, loose = self._tight()
        dropped = 0
        if tight and not loose:
            changed = rebuilt = False
        elif tight:
            for p, key in loose:
                if isinstance(key, tuple) and key[0] == "rank":
                    self._rebuild_rank_table(p, p.__dict__["_rank_tables"][key[1:]])
                else:
                    del p.__dict__["_blocked_cache"][key]
                dropped += 1
            changed, rebuilt = True, False
        else:
            for p in self._plans.values():
                dropped += len(p.__dict__.get("_blocked_cache") or {})
                dropped += len(p.__dict__.get("_rank_tables") or {})
            self._rebuild_in_place(
                self.assignment, self.part, self.edge_index(),
                self.edge_weights())
            changed = rebuilt = True
        report = {
            "graph_key": self.graph_key,
            "version": self.version,
            "changed": changed,
            "rebuilt": rebuilt,
            "pad_rows_reclaimed": {
                key: pads_before[key] - ts.pad
                for (kind, pods), ts in self._tiers.items()
                for key in [f"{kind}/{pods}"]},
            "e_local_before": e_local_before,
            "e_local_after": self.e_local,
            "blocked_entries_dropped": dropped,
            "bytes_reclaimed": bytes_before - self._host_bytes(),
            "pad_occupancy": self.pad_occupancy(),
            "compact_ms": (time.perf_counter() - t0) * 1e3,
        }
        if _obs_metrics.enabled():
            from repro_torch.obs.instrument import record_compact_report

            record_compact_report(report)
        return report

    def pad_occupancy(self) -> dict:
        """Live occupancy vs padded capacity, per tier and for the edge
        store — the ``delta.pad_occupancy`` gauge's source. ``frac`` is the
        overall live/padded slot ratio (1.0 = nothing reclaimable)."""
        tiers = {}
        used = cap = 0
        for (kind, pods), ts in self._tiers.items():
            occ = max((len(r) for r in ts.ref), default=0)
            high = max((len(ex) for ex in ts.exports), default=0)
            tiers[f"{kind}/{pods}"] = {
                "pad": ts.pad, "occupancy": occ, "high_water": high}
            used += sum(len(r) for r in ts.ref)
            cap += self.k * ts.pad
        cnt_max = int(self._cnt.max(initial=0))
        used += int(self._cnt.sum())
        cap += self.k * self.e_local
        return {
            "tiers": tiers,
            "e_local": self.e_local,
            "e_local_occupancy": cnt_max,
            "frac": used / cap if cap else 1.0,
        }

    def _remap_class(self, plan: HaloPlan, bm, sm, d_cut, n_cut, nc_cut,
                     class_sel, structural: bool, formula, ppairs) -> int:
        """Re-encode `senders_l` for one tier class. Slots are STABLE —
        a surviving export never moves — so a surviving cut edge's encoding
        only changes when a tier pad grew (structural). Non-structural
        repairs therefore touch ONLY the class's newly-cut edges; structural
        repairs re-encode the whole class (and drop blocked caches, so no
        tile bookkeeping). All inputs are the per-cut-edge vectors extracted
        once in `apply` (`bm`/`sm` the store coordinates, `class_sel` this
        class's membership). ``ppairs`` (when the plan has live blocked
        tables) collects the (row, new sender) tile coordinates the patcher
        must recompute — newly-cut edges held fresh placeholder senders, so
        there is no old coordinate to erase."""
        pick = class_sel if structural else class_sel & nc_cut
        idx = np.nonzero(pick)[0]
        if not idx.size:
            return 0
        bi, si = bm[idx], sm[idx]
        new = formula(d_cut[idx], n_cut[idx]).astype(np.int64)
        if ppairs is not None and not structural:
            rr = self._dst[bi, si]
            for b, r_, n_ in zip(bi.tolist(), rr.tolist(), new.tolist()):
                ppairs[b].add((r_, n_))
        plan.senders_l[bi, si] = new
        return int(idx.size)

    # --------------------------------------------------------- blocked patch
    def _class_edges(self, plan: HaloPlan, b: int, which: str):
        cnt = int(self._cnt[b])
        s = plan.senders_l[b, :cnt].astype(np.int64)
        r = self._dst[b, :cnt].astype(np.int64)
        w = self._w[b, :cnt]
        real = w > 0
        s, r, w = s[real], r[real], w[real]
        if which == "interior":
            m = s < plan.n_local
            return s[m], r[m], w[m]
        if which == "boundary":
            m = s >= plan.n_local
            return s[m] - plan.n_local, r[m], w[m]
        return s, r, w

    def _patch_blocked(self, plan: HaloPlan, cache: dict, ranks: dict, ppairs) -> int:
        """Tile-patch every memoized blocked table of one plan: the combined
        `plan_blocked_adjacency` per block size, the interior/boundary
        `plan_split_blocked_adjacency` pairs (each class sees only its own
        re-based coordinates), and the plan's rank tables. Returns #tables
        patched."""
        n_local = plan.n_local
        parr = [
            np.array(sorted(ppairs[b]), np.int64).reshape(-1, 2)
            if ppairs[b] else np.empty((0, 2), np.int64)
            for b in range(self.k)
        ]
        coords = {"combined": lambda p: p,
                  "interior": lambda p: p[p[:, 1] < n_local],
                  "boundary": lambda p: p[p[:, 1] >= n_local] - [0, n_local]}
        done = 0
        for key, entry in cache.items():
            if isinstance(key, tuple) and key[0] == "split":
                interior, boundary = entry
                done += self._patch_one(plan, interior, parr, "interior", coords["interior"])
                done += self._patch_one(plan, boundary, parr, "boundary", coords["boundary"])
            else:
                done += self._patch_one(plan, entry, parr, "combined", coords["combined"])
        for rt in ranks.values():
            t0 = time.perf_counter()
            hit = self._patch_one(plan, rt, parr, rt.part, coords[rt.part])
            rt.last = "patched" if hit else "unchanged"
            rt.maintain_ms = (time.perf_counter() - t0) * 1e3
            done += hit
        return done

    def _patch_one(self, plan, pba, parr, which: str, coord) -> int:
        """Patch one table: a `PlanBlockedAdjacency` (every rank's tiles)
        or a `RankTable` (one rank's tiles, every rank's index)."""
        own = getattr(pba, "rank", None)
        nbc = -(-pba.n_cols // pba.block)
        updates = []
        need = int(pba.lens.max(initial=0))
        for b in range(self.k):
            mapped = coord(parr[b])
            if mapped.shape[0] == 0:
                continue
            s, r, w = self._class_edges(plan, b, which)
            res = _tile_updates(s, r, w, mapped, nbc, pba.block, dense=own is None or b == own)
            if res is None:
                continue
            rbs, cbs, live, tiles = res
            # current ragged slot of every touched tile (-1 = absent), via
            # a dense (R, nbc) column->slot map — no per-tile scans
            lens_b, cols_b = pba.lens[b], pba.cols[b]
            n_rows, t_cap = cols_b.shape
            slot_map = np.full((n_rows, nbc), -1, np.int64)
            rr, tt = np.nonzero(np.arange(t_cap)[None, :] < lens_b[:, None])
            slot_map[rr, cols_b[rr, tt]] = tt
            slots = slot_map[rbs, cbs]
            dn = (np.bincount(rbs[live & (slots < 0)], minlength=n_rows)
                  - np.bincount(rbs[~live & (slots >= 0)], minlength=n_rows))
            need = max(need, int((lens_b + dn).max(initial=0)))
            updates.append((b, rbs, cbs, live, tiles, slots))
        if not updates:
            return 0
        width = pba.cols.shape[-1]
        if need > width:
            pba.vals, pba.cols = _grow_tiles(pba.vals, pba.cols, max(need, 2 * width))
            self._tables_grown += 1
            if own is not None:
                pba.grown += 1
        for b, rbs, cbs, live, tiles, slots in updates:
            cols_b, lens_b = pba.cols[b], pba.lens[b]
            vals_b = pba.vals[b] if own is None else (pba.vals if b == own else None)
            # the common case — a tile that exists both before and after —
            # is ONE batched fancy write; only the rare membership changes
            # (tombstones, then appends, so the row never transiently
            # overflows its net count) replay through the scalar path
            ov = live & (slots >= 0)
            if vals_b is not None:
                vals_b[rbs[ov], slots[ov]] = tiles[ov]
            for i in np.nonzero(~live & (slots >= 0))[0].tolist():
                _apply_tile_update(vals_b, cols_b, lens_b,
                                   int(rbs[i]), int(cbs[i]), None)
            for i in np.nonzero(live & (slots < 0))[0].tolist():
                _apply_tile_update(vals_b, cols_b, lens_b, int(rbs[i]), int(cbs[i]),
                                   True if vals_b is None else tiles[i])
        return 1

    # ------------------------------------------------------------ rank tables
    def rank_table(self, plan: HaloPlan, rank: int, block: int = 128,
                   part: str = "combined") -> RankTable:
        """Rank ``rank``'s blocked table of ``plan`` (one of this planner's
        plans), in form ``part`` (``"combined"``, ``"interior"`` or
        ``"boundary"``, as `plan_blocked_rank` takes it), built on first use
        and kept current by every later :meth:`apply` — tile-patched in
        place, or rebuilt where the reference drops its blocked cache
        (structural applies, :meth:`relocalize`, :meth:`compact`). A rank
        of a group calls this on its own planner replica: it never holds
        another rank's tiles, and the shared width T grows exactly as the
        all-rank table's would."""
        if not any(q is plan for q in self._plans.values()):
            raise ValueError("rank_table: the plan is not one of this planner's")
        tables = plan.__dict__.setdefault("_rank_tables", {})
        key = (int(rank), int(block), part)
        rt = tables.get(key)
        if rt is None:
            t0 = time.perf_counter()
            rt = tables[key] = _build_rank_table(plan, *key)
            rt.maintain_ms = (time.perf_counter() - t0) * 1e3
        return rt

    def _rebuild_rank_table(self, plan: HaloPlan, rt: RankTable) -> None:
        """Rebuild ``rt`` in place (callers keep their handle)."""
        t0 = time.perf_counter()
        fresh = _build_rank_table(plan, rt.rank, rt.block, rt.part)
        rt.vals, rt.cols, rt.lens = fresh.vals, fresh.cols, fresh.lens
        rt.n_rows, rt.n_cols, rt.last = fresh.n_rows, fresh.n_cols, "rebuilt"
        rt.maintain_ms = (time.perf_counter() - t0) * 1e3

    def _rebuild_rank_tables(self, plan: HaloPlan) -> int:
        """Rebuild the plan's rank tables (the halo column space changed);
        returns how many."""
        tables = plan.__dict__.get("_rank_tables") or {}
        for rt in tables.values():
            self._rebuild_rank_table(plan, rt)
        return len(tables)
