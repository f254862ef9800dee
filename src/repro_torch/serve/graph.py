"""Online GCN query serving with a communication-aware hot-neighbor cache —
twin of `repro.serve.graph`.

Node classification queries arrive asynchronously, a :class:`GraphBatcher`
packs them into fixed-shape micro-batches, and ONE fixed-shape forward
serves every micro-batch — the slot discipline of `ContinuousBatcher`
applied to sampled subgraphs instead of KV-cache slots.

The COIN claim (PAPER.md §IV) is that GCN cost is communication: the same hub
rows are gathered over and over. Serving makes that literal — every query on
a node adjacent to a hub re-fetches and re-computes the hub's L-hop
neighborhood. The **hot-neighbor cache** (:class:`HotNeighborCache`) is a
degree-ranked, capacity-bounded store of layer-ℓ activations for hub nodes;
sampled subgraphs *truncate* at cached frontier nodes and the forward
injects the stored row, so the hub's neighborhood is never re-gathered.

Exactness contract (what makes cached rows reusable at all):

* :class:`ServeSampler` draws each node's fanout in-neighborhood with a
  counter-based hash of ``(node, slot, seed)`` — N̂(v) is a pure function of
  v, not of the query or micro-batch. Every block that expands v sees the
  same subtree, so the layer-ℓ activation of v computed in any block is a
  pure function of (v, params, features).
* Edge weights are full-graph symmetric normalization (1/√d̂(u)·1/√d̂(v)) —
  per-node-pair, block-independent.
* Serving runs fp32: per-tensor fake-quant calibration ranges depend on the
  whole block's activations, which would break per-node purity, so the
  engine force-disables quantization.

Under that contract cache-on and cache-off produce the same logits (fp32
tolerance: on the card `index_add_` sums in no fixed order) while cache-on
samples strictly fewer nodes and edges per query.

The host side — stream, sampler, cache, packing, scoped invalidation — is
numpy and count-for-count the reference's. The forward is plain torch on
the engine's device (`torch.matmul` and `repro_torch.graph.ops.aggregate_padded`,
the injection a `torch.where`): the reference's serve forward reaches no
Pallas kernel, so none runs here. ``traces`` keeps the reference's meaning
— the number of distinct fixed-shape programs built (its jit traces), one
for every live size — and counts input signatures, not calls.

Batch packing is partition-aligned (`repro_torch.core.partition`): pending
queries are grouped by the part owning their seed so a multi-device
deployment sees micro-batches whose subgraphs stay inside one part; the
batcher records the foreign-row count per micro-batch.

PNA and EGNN serve through the same batcher, cache-off (only the GCN
forward has the injection hooks): their forwards run on the packed block
with ``edge_mask = edge_weight > 0``, EGNN on ``[pos ‖ feats]`` rows. The
block's padding edges point at the ghost row ``max_nodes``, which JAX
reads clamped to the last row and drops from every segment sum; here they
are pointed at the last row outright, where their masked messages add
exactly nothing, so the served rows are the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.dataflow import choose_order
from repro_torch.core.partition import Partition
from repro_torch.device import resolve_device
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.ops import aggregate_padded
from repro_torch.graph.sampler import stable_order
from repro_torch.graph.structure import GraphData
from repro_torch.models.gcn import GCNConfig
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.train.tree import tree_map

__all__ = [
    "GraphQuery",
    "GraphBatcher",
    "HotNeighborCache",
    "ServeSampler",
    "ServeBlock",
    "hot_query_stream",
]

# The slice of the port (ROADMAP.md) that brings the other serve forwards.


def hot_query_stream(graph: GraphData, n: int, seed: int = 1) -> np.ndarray:
    """``n`` degree-weighted query nodes — the hub-heavy access pattern GCN
    serving sees in the wild (hubs are queried, and neighbored, most). The
    serve CLI, the example and the tests all draw from this one stream."""
    rng = np.random.default_rng(seed)
    deg = np.bincount(graph.edge_index[1], minlength=graph.n_nodes).astype(np.float64) + 1.0
    return rng.choice(graph.n_nodes, size=n, p=deg / deg.sum())


# --------------------------------------------------------------------- hashing
_U64 = np.uint64
_MIX1 = _U64(0xBF58476D1CE4E5B9)
_MIX2 = _U64(0x94D049BB133111EB)
_GOLDEN = _U64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — a vectorized counter-based hash (no RNG state,
    so a node's draws are reproducible from its id alone)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + _GOLDEN
        z = (z ^ (z >> _U64(30))) * _MIX1
        z = (z ^ (z >> _U64(27))) * _MIX2
        return z ^ (z >> _U64(31))


# --------------------------------------------------------------------- sampler
@dataclasses.dataclass
class ServeBlock:
    """One packed serving micro-batch (static shapes, ghost-padded)."""

    node_ids: np.ndarray        # (max_nodes,) original ids; -1 at padding
    senders: np.ndarray         # (max_edges,) local ids; max_nodes at padding
    receivers: np.ndarray       # (max_edges,) local ids; max_nodes at padding
    edge_weight: np.ndarray     # (max_edges,) float32; 0 at padding
    n_seeds: int
    n_nodes: int
    n_edges: int
    max_nodes: int
    max_edges: int
    # layer → rows to overwrite after that layer: (mask (max_nodes,), pairs)
    inject: dict[int, list[tuple[int, int]]]   # layer -> [(local, node), ...]
    harvest: list[tuple[int, int, int]]        # (layer, local, node)
    cache_hits: int
    cache_misses: int


class ServeSampler:
    """Deterministic fanout sampler: N̂(v) is a pure function of (v, seed).

    Unlike the training `NeighborSampler` (fresh RNG draws per batch), every
    expansion of node v — any query, any micro-batch — yields the same
    in-neighborhood, which is exactly what makes v's layer-ℓ activation
    cacheable. A single scalar fanout applies at every depth so the
    neighborhood does not depend on the depth v was reached at.
    """

    def __init__(self, graph: GraphData, fanout: int, n_layers: int, seed: int = 0):
        self.fanout = int(fanout)
        self.n_layers = int(n_layers)
        self.n_nodes = graph.n_nodes
        self.seed = _U64(seed)
        s = graph.edge_index[0].astype(np.int64)
        r = graph.edge_index[1].astype(np.int64)
        order = stable_order(r)
        self._nbr = s[order]
        self._indptr = np.zeros(graph.n_nodes + 1, np.int64)
        self._indptr[1:] = np.bincount(r, minlength=graph.n_nodes)
        np.cumsum(self._indptr, out=self._indptr)
        self.in_deg = (self._indptr[1:] - self._indptr[:-1]).astype(np.int64)
        out_deg = np.bincount(s, minlength=graph.n_nodes).astype(np.float64)
        # Full-graph sym normalization — per-node scalars, block-independent.
        self._inv_r = (1.0 / np.sqrt(np.maximum(self.in_deg, 1.0))).astype(np.float32)
        self._inv_s = (1.0 / np.sqrt(np.maximum(out_deg, 1.0))).astype(np.float32)

    def max_shapes(self, batch_seeds: int) -> tuple[int, int]:
        """Static (max_nodes, max_edges) for a micro-batch of seed queries."""
        nodes, edges, width = 1, 0, 1
        for _ in range(self.n_layers):
            width *= self.fanout
            nodes += width
            edges += width
        return batch_seeds * nodes, batch_seeds * edges

    def subtree_counts(self, layer: int) -> tuple[int, int]:
        """Worst-case (nodes, edges) a truncation at ``layer`` avoids — the
        bytes-saved formula of DESIGN.md §9.3."""
        nodes = sum(self.fanout ** i for i in range(1, layer + 1))
        return nodes, nodes

    def neighbors(self, nodes: np.ndarray) -> np.ndarray:
        """(len(nodes), fanout) deterministic in-neighbor draws (with
        replacement); zero-in-degree nodes emit self-messages."""
        nodes = np.asarray(nodes, dtype=np.int64)
        deg = self.in_deg[nodes]
        slots = np.arange(self.fanout, dtype=np.uint64)
        with np.errstate(over="ignore"):
            key = nodes.astype(np.uint64)[:, None] * _MIX1 + slots[None, :] + self.seed * _MIX2
        pick = (_mix64(key) % np.maximum(deg, 1).astype(np.uint64)[:, None]).astype(np.int64)
        if self._nbr.size:
            src = self._nbr[np.minimum(self._indptr[nodes][:, None] + pick, self._nbr.size - 1)]
        else:
            src = np.broadcast_to(nodes[:, None], (nodes.shape[0], self.fanout)).copy()
        return np.where((deg > 0)[:, None], src, nodes[:, None])

    def edge_w(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        return self._inv_s[src] * self._inv_r[dst]

    def sample_block(
        self,
        seeds: np.ndarray,
        batch_seeds: int,
        cache: "HotNeighborCache | None" = None,
    ) -> ServeBlock:
        """Expand the seeds' L-hop trees, truncating at cached frontiers.

        Correctness hinges on tracking *(node, layer)* requirements, not just
        nodes: the merged-block forward runs every edge at every layer, so an
        edge c→v makes layer-j of v read layer-(j−1) of c for EVERY j at
        which v itself must be valid (self-loops alone force a seed to be
        valid at every layer). Each requirement is satisfied either by the
        cache (record an injection, stop) or by expanding the node once and
        propagating the (child, layer−1) requirements. Layer-0 requirements
        are raw features — always valid. Without a cache this reduces to the
        plain BFS tree; with one, blocks only shrink.
        """
        max_nodes, max_edges = self.max_shapes(batch_seeds)
        seeds = np.asarray(seeds, dtype=np.int64)
        local: dict[int, int] = {}
        node_list: list[int] = []

        def loc(v: int) -> int:
            i = local.get(v)
            if i is None:
                i = local[v] = len(node_list)
                node_list.append(v)
            return i

        for v in seeds:
            loc(int(v))
        edge_src: list[np.ndarray] = []
        edge_dst: list[np.ndarray] = []
        expanded: dict[int, np.ndarray] = {}        # node -> its N̂ row
        inject: dict[int, list[tuple[int, int]]] = {}
        harvest: list[tuple[int, int, int]] = []
        hits = misses = 0
        L = self.n_layers
        # need[layer] is insertion-ordered (dict keys) for deterministic
        # expansion order; a (node, layer) pair is processed at most once.
        need: dict[int, dict[int, None]] = {L: dict.fromkeys(int(v) for v in seeds)}
        for layer in range(L, 0, -1):
            todo = list(need.get(layer, ()))
            if not todo:
                continue
            expand_list: list[int] = []
            for v in todo:
                if cache is not None and layer < L:
                    val = cache.lookup(v, layer)
                    if val is not None:
                        hits += 1
                        inject.setdefault(layer, []).append((loc(v), v))
                        continue
                    misses += 1
                expand_list.append(v)
            fresh = [v for v in expand_list if v not in expanded]
            if fresh:
                rows = self.neighbors(np.asarray(fresh, dtype=np.int64))
                for v, row in zip(fresh, rows):
                    expanded[v] = row
                    for c in row:
                        loc(int(c))
                    edge_src.append(row)
                    edge_dst.append(np.full(self.fanout, v, np.int64))
            for v in expand_list:
                if cache is not None and layer <= L - 1:
                    harvest.append((layer, local[v], v))
                if layer - 1 >= 1:
                    nxt = need.setdefault(layer - 1, {})
                    for c in expanded[v]:
                        nxt.setdefault(int(c), None)
        src = np.concatenate(edge_src) if edge_src else np.zeros(0, np.int64)
        dst = np.concatenate(edge_dst) if edge_dst else np.zeros(0, np.int64)
        n_nodes, n_edges = len(node_list), src.shape[0]
        assert n_nodes <= max_nodes and n_edges <= max_edges
        lut = {v: i for i, v in enumerate(node_list)}
        node_ids = np.full(max_nodes, -1, np.int64)
        node_ids[:n_nodes] = node_list
        senders = np.full(max_edges, max_nodes, np.int32)
        receivers = np.full(max_edges, max_nodes, np.int32)
        edge_weight = np.zeros(max_edges, np.float32)
        if n_edges:
            senders[:n_edges] = [lut[int(v)] for v in src]
            receivers[:n_edges] = [lut[int(v)] for v in dst]
            edge_weight[:n_edges] = self.edge_w(src, dst)
        return ServeBlock(
            node_ids=node_ids,
            senders=senders,
            receivers=receivers,
            edge_weight=edge_weight,
            n_seeds=len(seeds),
            n_nodes=n_nodes,
            n_edges=n_edges,
            max_nodes=max_nodes,
            max_edges=max_edges,
            inject=inject,
            harvest=harvest,
            cache_hits=hits,
            cache_misses=misses,
        )


# ----------------------------------------------------------------------- cache
class HotNeighborCache:
    """Degree-ranked, capacity-bounded store of layer-ℓ hub activations.

    Admission is by in-degree (COIN's hubs — I-GCN's "islands" — are exactly
    the rows every query re-fetches): when full, a newcomer evicts the
    lowest-degree resident only if it out-ranks it. ``invalidate`` drops
    every entry — the engine calls it on any weight update, since stored
    activations are pure functions of (params, features). Graph/feature
    deltas use :meth:`invalidate_nodes` instead: the engine computes which
    residents' sampled dependency cones intersect the delta
    (``GraphBatcher._scoped_invalidate``) and drops only those.
    """

    def __init__(self, capacity: int, degree: np.ndarray):
        self.capacity = int(capacity)
        self.degree = np.asarray(degree)
        self._entries: dict[int, dict[int, np.ndarray]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.scoped_invalidations = 0
        self.nodes_dropped = 0
        self.rows_saved = 0
        self.edges_saved = 0
        self.bytes_saved = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def peek(self, node: int, layer: int) -> np.ndarray | None:
        """Non-counting read. Engine-internal re-reads of an entry the
        sampler already counted — the injection copy in
        ``GraphBatcher.step`` — go through here so ``stats()["hits"]``
        counts each serving hit exactly once."""
        e = self._entries.get(node)
        if e is None:
            return None
        return e.get(layer)

    def lookup(self, node: int, layer: int) -> np.ndarray | None:
        """Counting read: exactly one hit or miss per call, tallied HERE and
        nowhere else (the batcher must not re-add per-block counts on top —
        that double-counting inflated ``hit_rate``)."""
        val = self.peek(node, layer)
        if val is None:
            self.misses += 1
        else:
            self.hits += 1
        return val

    def admit(self, node: int, layer: int, value: np.ndarray) -> bool:
        e = self._entries.get(node)
        if e is not None:
            e[layer] = value
            return True
        if len(self._entries) < self.capacity:
            self._entries[node] = {layer: value}
            return True
        victim = min(self._entries, key=lambda v: self.degree[v])
        if self.degree[node] <= self.degree[victim]:
            return False
        del self._entries[victim]
        self.evictions += 1
        self._entries[node] = {layer: value}
        return True

    def invalidate(self, reason: str = "") -> None:
        self._entries.clear()
        self.invalidations += 1

    def invalidate_nodes(self, nodes) -> int:
        """Scoped drop: remove only the named residents (all their layers).
        Returns how many residents were actually dropped."""
        dropped = 0
        for v in nodes:
            if self._entries.pop(int(v), None) is not None:
                dropped += 1
        self.scoped_invalidations += 1
        self.nodes_dropped += dropped
        return dropped

    def resident_depths(self) -> dict[int, int]:
        """{node: deepest cached layer} — what a scoped invalidation must
        walk (an entry cached at layer ℓ depends on the ℓ-hop sampled cone)."""
        return {v: max(layers) for v, layers in self._entries.items() if layers}

    def record_saving(self, rows: int, edges: int, bytes_: float) -> None:
        self.rows_saved += rows
        self.edges_saved += edges
        self.bytes_saved += bytes_

    def stats(self) -> dict[str, Any]:
        return {
            "resident": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "scoped_invalidations": self.scoped_invalidations,
            "nodes_dropped": self.nodes_dropped,
            "rows_saved": self.rows_saved,
            "edges_saved": self.edges_saved,
            "bytes_saved": self.bytes_saved,
        }


# --------------------------------------------------------------------- queries
@dataclasses.dataclass
class GraphQuery:
    """One node-classification query plus its serving outcome."""

    qid: int
    node: int
    t_submit: float = 0.0
    logits: np.ndarray | None = None
    latency_s: float | None = None
    micro_batch: int | None = None


# --------------------------------------------------------------------- batcher
class GraphBatcher:
    """Admit node queries, pack fixed-shape micro-batches, serve them through
    one fixed-shape forward (GCN with activation injection; PNA/EGNN plain).

    ``model``: "gcn" (hot-neighbor cache supported), "pna", or "egnn"
    (``graph.positions`` needed). ``cache_capacity`` > 0 enables the cache
    (GCN only). ``partition`` turns on partition-aligned packing. Static
    shapes come from ``(batch_seeds, fanout, n_layers)`` so every
    micro-batch — whatever its live query count — has one shape. ``params``
    (tensors or numpy arrays) go to ``device``: the CUDA card unless
    ``"cpu"`` is asked for.
    """

    def __init__(
        self,
        params: dict,
        graph: GraphData,
        cfg: Any,
        *,
        model: str = "gcn",
        batch_seeds: int = 8,
        fanout: int = 5,
        cache_capacity: int = 0,
        partition: Partition | None = None,
        policy: ShardingPolicy = NO_POLICY,
        seed: int = 0,
        add_self_loops: bool = True,
        device: str | torch.device | None = None,
    ):
        if model not in ("gcn", "pna", "egnn"):
            raise ValueError(f"unknown serve model {model!r}")
        if model != "gcn" and cache_capacity:
            raise ValueError("the hot-neighbor cache needs per-layer injection "
                             "hooks; only the GCN serve forward has them")
        self.device = resolve_device(device)
        self.model = model
        self.params = self._to_device(params)
        self.policy = policy
        self.partition = partition
        self.batch_seeds = int(batch_seeds)
        if model == "gcn":
            assert isinstance(cfg, GCNConfig)
            if cfg.quant.enabled:
                # Per-tensor calibration ranges are batch-dependent; serving
                # must keep per-node purity (module docstring), so fp32 only.
                cfg = dataclasses.replace(cfg, quant=cfg.quant.replace(enabled=False))
        self.cfg = cfg
        assert graph.features is not None, "serving needs node features"
        self.features = np.asarray(graph.features, np.float32)
        self.positions = (
            np.asarray(graph.positions, np.float32) if graph.positions is not None else None
        )
        if model == "egnn" and self.positions is None:
            raise ValueError("egnn serving needs graph.positions")
        self.graph = graph
        self._add_self_loops = bool(add_self_loops)
        self._seed = int(seed)
        g = graph.with_self_loops() if add_self_loops else graph
        self.sampler = ServeSampler(g, fanout, cfg.n_layers, seed=seed)
        self.max_nodes, self.max_edges = self.sampler.max_shapes(self.batch_seeds)
        self.cache = (
            HotNeighborCache(cache_capacity, self.sampler.in_deg) if cache_capacity else None
        )
        # Injectable layers 1..L−1 with their widths (GCN only; empty else).
        self._inject_dims = (
            {i + 1: cfg.layer_dims[i + 1] for i in range(cfg.n_layers - 1)} if model == "gcn" else {})
        self.pending: list[GraphQuery] = []
        self.finished: list[GraphQuery] = []
        self._next_qid = 0
        self.micro_batches = 0
        self.traces = 0
        self._signatures: set = set()
        self.nodes_sampled = 0
        self.edges_sampled = 0
        self.queries_served = 0
        self.foreign_rows = 0

    def _to_device(self, params: dict) -> dict:
        """``params`` (a tree: flat for the GCN, nested for PNA and EGNN) as
        fp32 tensors on the engine's device."""
        return tree_map(lambda v: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32)))
                        .to(self.device, torch.float32), params)

    # ------------------------------------------------------------ forward pass
    def _forward(self, x, senders, receivers, edge_weight, masks, vals):
        """The serve forward of the reference (its ``_build_forward``),
        eager. GCN: every layer ``act(Â·h·W + b)`` in the dataflow order
        COIN's rule picks, then the cached rows injected after each
        injectable layer. PNA / EGNN (``x`` = ``[pos ‖ feats]``): the
        model's forward with ``edge_mask = edge_weight > 0``, the padding
        edges pointed at the last row (module docstring). Returns the
        logits and the injectable layers' outputs."""
        sig = tuple(tuple(t.shape) for t in (x, senders, receivers, edge_weight, *masks, *vals))
        if sig not in self._signatures:       # one fixed-shape program per signature
            self._signatures.add(sig)
            self.traces += 1
        cfg, policy, params = self.cfg, self.policy, self.params
        if self.model != "gcn":
            edge_mask = (edge_weight > 0).to(x.dtype)
            last = self.max_nodes - 1
            senders, receivers = senders.clamp_max(last), receivers.clamp_max(last)
            if self.model == "pna":
                from repro_torch.models.pna import pna_forward

                return pna_forward(params, x, senders, receivers, cfg, policy, edge_mask=edge_mask), ()
            from repro_torch.models.egnn import egnn_forward

            out, _ = egnn_forward(params, x[:, 3:], x[:, :3], senders, receivers, cfg, policy, edge_mask=edge_mask)
            return out, ()
        n, n_edges = self.max_nodes, self.max_edges
        layers = sorted(self._inject_dims)
        h = x
        inter = []
        for i in range(cfg.n_layers):
            w = params[f"w{i}"]
            d_in, d_out = w.shape
            order = cfg.dataflow
            if order == "auto":
                order = choose_order(n, d_in, d_out, n_edges=n_edges)
            if order == "feature_first":
                z = policy.constrain(h @ w, "node_hidden")
                h = aggregate_padded(z, senders, receivers, n, edge_weight)
            else:
                z = policy.constrain(aggregate_padded(h, senders, receivers, n, edge_weight),
                                     "node_hidden")
                h = z @ w
            h = h + params[f"b{i}"]
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
            layer = i + 1
            if layer in self._inject_dims:
                j = layers.index(layer)
                h = torch.where(masks[j][:, None] > 0, vals[j], h)
                inter.append(h)
            h = policy.constrain(h, "node_hidden")
        return h, tuple(inter)

    # --------------------------------------------------------------- admission
    def submit(self, node: int, qid: int | None = None) -> GraphQuery:
        q = GraphQuery(
            qid=self._next_qid if qid is None else qid,
            node=int(node),
            t_submit=time.perf_counter(),
        )
        self._next_qid += 1
        self.pending.append(q)
        return q

    def _pick_batch(self) -> list[GraphQuery]:
        """Partition-aligned packing: drain the part with the most pending
        queries first (FIFO within a part; FIFO overall without a partition),
        topping up from the next-largest parts when it underfills."""
        if not self.pending:
            return []
        if self.partition is None:
            take = self.pending[: self.batch_seeds]
            self.pending = self.pending[self.batch_seeds:]
            return take
        by_part: dict[int, list[GraphQuery]] = {}
        for q in self.pending:
            by_part.setdefault(int(self.partition.assignment[q.node]), []).append(q)
        order = sorted(by_part, key=lambda p: (-len(by_part[p]), p))
        take: list[GraphQuery] = []
        for p in order:
            room = self.batch_seeds - len(take)
            if room <= 0:
                break
            take.extend(by_part[p][:room])
        chosen = set(id(q) for q in take)
        self.pending = [q for q in self.pending if id(q) not in chosen]
        return take

    # ------------------------------------------------------------------- serve
    def step(self) -> list[GraphQuery]:
        """One engine iteration: pick → sample/truncate → forward → harvest."""
        queries = self._pick_batch()
        if not queries:
            return []
        if _obs_metrics.enabled():
            t_pick = time.perf_counter()
            for q in queries:
                _obs_metrics.observe("serve.queue_wait_ms",
                                     (t_pick - q.t_submit) * 1e3)
            _obs_metrics.observe("serve.batch_occupancy",
                                 len(queries) / max(self.batch_seeds, 1))
        seeds: list[int] = []
        row_of: dict[int, int] = {}
        for q in queries:
            if q.node not in row_of:
                row_of[q.node] = len(seeds)
                seeds.append(q.node)
        with _obs_trace.span("serve.sample", args={"seeds": len(seeds)}):
            blk = self.sampler.sample_block(
                np.asarray(seeds), self.batch_seeds, self.cache)
        x = np.zeros((self.max_nodes, self.features.shape[1]), np.float32)
        valid = blk.node_ids[: blk.n_nodes]
        x[: blk.n_nodes] = self.features[valid]
        if self.model == "egnn":
            pos = np.zeros((self.max_nodes, 3), np.float32)
            pos[: blk.n_nodes] = self.positions[valid]
            x = np.concatenate([pos, x], axis=1)
        layers = sorted(self._inject_dims)
        masks, vals = [], []
        for layer in layers:
            m = np.zeros(self.max_nodes, np.float32)
            v = np.zeros((self.max_nodes, self._inject_dims[layer]), np.float32)
            for lc, node in blk.inject.get(layer, []):
                m[lc] = 1.0
                # peek, not lookup: the sampler already counted this hit.
                v[lc] = self.cache.peek(node, layer)
            masks.append(torch.from_numpy(m).to(self.device))
            vals.append(torch.from_numpy(v).to(self.device))
        dev = self.device
        with torch.inference_mode(), _obs_trace.span(
                "serve.forward", args={"nodes": int(blk.n_nodes)}) as _sp:
            out, inter = self._forward(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(blk.senders).to(dev),
                torch.from_numpy(blk.receivers).to(dev),
                torch.from_numpy(blk.edge_weight).to(dev),
                tuple(masks),
                tuple(vals),
            )
            _sp.sync = out
            out = out.cpu().numpy()
            inter = [a.cpu().numpy() for a in inter] if self.cache is not None else []
        now = time.perf_counter()
        for q in queries:
            q.logits = out[row_of[q.node]]
            q.latency_s = now - q.t_submit
            q.micro_batch = self.micro_batches
            if _obs_metrics.enabled():
                _obs_metrics.observe("serve.latency_ms", q.latency_s * 1e3)
        self.finished.extend(queries)
        # Harvest hub activations (degree-ranked admission) for future hits.
        if self.cache is not None:
            for layer, lc, node in blk.harvest:
                self.cache.admit(node, layer, inter[layers.index(layer)][lc].copy())
            # Hits/misses were tallied by cache.lookup during sampling —
            # re-adding blk.cache_hits here would count every hit twice.
            feat_bytes = self.features.dtype.itemsize * self.features.shape[1]
            for layer, pairs in blk.inject.items():
                rows, edges = self.sampler.subtree_counts(layer)
                for _lc, node in pairs:
                    row = self.cache.peek(node, layer)
                    inj_bytes = (
                        row.nbytes if row is not None
                        else self.features.dtype.itemsize * self._inject_dims[layer]
                    )
                    self.cache.record_saving(rows, edges, rows * feat_bytes - inj_bytes)
        if self.partition is not None:
            parts = self.partition.assignment[valid]
            major = int(self.partition.assignment[seeds[0]])
            self.foreign_rows += int((parts != major).sum())
        self.micro_batches += 1
        self.queries_served += len(queries)
        self.nodes_sampled += blk.n_nodes
        self.edges_sampled += blk.n_edges
        if _obs_metrics.enabled():
            _obs_metrics.inc("serve.queries", float(len(queries)))
            _obs_metrics.inc("serve.micro_batches")
            if self.cache is not None:
                _obs_metrics.set_gauge("serve.cache_hit_rate",
                                       self.cache.hit_rate)
        return queries

    def run_until_drained(self, max_batches: int = 10_000) -> list[GraphQuery]:
        for _ in range(max_batches):
            if not self.pending:
                break
            self.step()
        return self.finished

    # ----------------------------------------------------------------- updates
    def update_params(self, params: dict) -> None:
        """Swap model weights; cached activations are stale → invalidate."""
        self.params = self._to_device(params)
        if self.cache is not None:
            self.cache.invalidate("weights")

    def update_features(self, features: np.ndarray, touched=None) -> None:
        """Swap node features. Without ``touched`` every cached activation
        is presumed stale (full invalidation, the pre-delta behavior). With
        ``touched`` — the rows that actually changed — only residents whose
        sampled dependency cone reaches a touched row are dropped."""
        assert features.shape == self.features.shape
        self.features = np.asarray(features, np.float32)
        self.graph = dataclasses.replace(self.graph, features=self.features)
        if self.cache is None:
            return
        if touched is None:
            self.cache.invalidate("features")
        else:
            self._scoped_invalidate(
                set(np.asarray(touched, np.int64).ravel().tolist()))

    def apply_graph_delta(self, delta) -> dict[str, Any]:
        """Mutate the served graph in place: apply the
        `repro_torch.dist.delta.GraphDelta` (order-preserving — deletes compact,
        inserts append), rebuild the sampler over the new edges, and drop
        ONLY the cache residents whose sampled dependency cone intersects
        the delta.

        Why the scoped drop is exact and not heuristic: the new sampler's
        frontier walk from a resident v covers, by induction over layers,
        every node v's cached activation could read under the NEW graph. If
        that cone avoids every delta endpoint and feature touch, the old and
        new sampled subtrees are identical node-for-node (order-preserving
        application keeps untouched CSR rows — and so the counter-hashed
        draws — bit-identical, and the sym-norm scalars of unchanged-degree
        nodes are unchanged), so the cached value is still the exact
        activation. Degree-changed nodes are delta endpoints themselves and
        thus inside every dependent cone. The forward's fixed shape is
        untouched — ``max_shapes`` depends only on (fanout, n_layers)."""
        from repro_torch.dist.delta import apply_delta_to_graph

        self.graph = apply_delta_to_graph(self.graph, delta)
        if self.graph.features is not None:
            self.features = np.asarray(self.graph.features, np.float32)
        g = (self.graph.with_self_loops() if self._add_self_loops
             else self.graph)
        self.sampler = ServeSampler(
            g, self.sampler.fanout, self.sampler.n_layers, seed=self._seed)
        dropped = resident = 0
        if self.cache is not None:
            resident = len(self.cache)
            self.cache.degree = self.sampler.in_deg
            dropped = self._scoped_invalidate(
                set(delta.touched_nodes().tolist()))
        return {"affected_seeds": int(delta.touched_nodes().size),
                "residents_before": resident, "residents_dropped": dropped}

    def adopt_partition(self, partition: Partition | None) -> None:
        """Swap the partition that drives batch packing — the serve side of
        an online re-localization (`repro_torch.dist.delta.DeltaPlanner.relocalize`).

        NO cache or sampler invalidation is needed, by construction: the
        `HotNeighborCache` is keyed by ORIGINAL node ids and the
        `ServeSampler`'s counter-hashed draws are a pure function of
        ``(node, seed)`` — neither ever sees the planner's row order, so a
        new node→CE map changes only which pending queries pack together
        (``_pick_batch``) and the ``foreign_rows`` accounting. Graph
        MUTATIONS are the separate path (:meth:`apply_graph_delta`, which
        does run the scoped invalidation); a re-localization mutates no
        edge."""
        if partition is not None and int(partition.n_nodes) != self.graph.n_nodes:
            raise ValueError(
                f"partition covers {partition.n_nodes} nodes, graph has "
                f"{self.graph.n_nodes}")
        self.partition = partition

    def _scoped_invalidate(self, affected: set[int]) -> int:
        """Drop cache residents whose L-hop sampled cone (under the CURRENT
        sampler, L = the entry's deepest cached layer) intersects
        ``affected``. Exact frontier walk, not a radius heuristic."""
        if self.cache is None or not affected:
            return 0
        hot = np.zeros(self.sampler.n_nodes, bool)
        hot[np.fromiter(affected, np.int64, len(affected))] = True
        stale: list[int] = []
        for v, depth in self.cache.resident_depths().items():
            if hot[v]:
                stale.append(v)
                continue
            frontier = np.asarray([v], np.int64)
            for _ in range(depth):
                frontier = np.unique(self.sampler.neighbors(frontier))
                if hot[frontier].any():
                    stale.append(v)
                    break
        return self.cache.invalidate_nodes(stale)

    # ------------------------------------------------------------- accounting
    def stats(self) -> dict[str, Any]:
        lat = sorted(q.latency_s for q in self.finished if q.latency_s is not None)

        def pct(p: float) -> float:
            return lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0

        out: dict[str, Any] = {
            "queries": self.queries_served,
            "micro_batches": self.micro_batches,
            "traces": self.traces,
            "nodes_per_query": self.nodes_sampled / max(self.queries_served, 1),
            "edges_per_query": self.edges_sampled / max(self.queries_served, 1),
            "p50_ms": pct(0.50) * 1e3,
            "p99_ms": pct(0.99) * 1e3,
            "foreign_rows": self.foreign_rows,
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def export_metrics(self) -> dict[str, Any]:
        """Mirror :meth:`stats` into the obs registry and return it.

        The gauges carry the ENGINE's exact accounting (the sorted-latency
        p50/p99, the cache's own hit counters) — not re-derivations — so an
        exported snapshot equals ``stats()`` value for value; the obs-side
        ``serve.latency_ms`` histogram percentiles are the bucketed
        approximation of the same samples. No-op (still returns the stats)
        when metrics are disabled."""
        out = self.stats()
        if _obs_metrics.enabled():
            _obs_metrics.set_gauge("serve.p50_ms", out["p50_ms"])
            _obs_metrics.set_gauge("serve.p99_ms", out["p99_ms"])
            _obs_metrics.set_gauge("serve.nodes_per_query", out["nodes_per_query"])
            _obs_metrics.set_gauge("serve.edges_per_query", out["edges_per_query"])
            _obs_metrics.set_gauge("serve.foreign_rows", out["foreign_rows"])
            cache = out.get("cache")
            if cache is not None:
                _obs_metrics.set_gauge("serve.cache_hit_rate", cache["hit_rate"])
                _obs_metrics.set_gauge("serve.cache_resident", cache["resident"])
        return out
