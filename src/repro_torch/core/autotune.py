"""Communication-aware placement + configuration autotuner (COIN's loop,
closed) — twin of `repro.core.autotune`.

COIN's thesis is that the node→CE *mapping* determines the communication that
dominates GCN energy and latency — so mapping and the execution config must
be optimized together, not defaulted independently. This module closes that
loop over the knobs the rest of the port already exposes:

  pod_map   — which parts share a pod (the expensive ``send_rem`` tier only
              carries rows that cross pods)
  pods      — hierarchy degree of the (pod, model) group layout
  block     — bsr tile edge (``plan_blocked_shape``)
  backend   — "segment" vs "bsr" aggregation engine
  order     — "feature_first" vs "aggregation_first" dataflow
  payload   — wire format (fp32/bf16/int8, `repro_torch.core.quant`)
  overlap   — interior/boundary split overlapped schedule

The three pieces:

  * :class:`BoundaryIndex` — the deduplicated boundary-pair index of a
    partitioned graph. Evaluates the exact per-tier pads (s_loc, s_rem) of
    ANY candidate part→pod map in O(boundary pairs) — no plan build — by
    reproducing `repro_torch.dist.halo._export_sets` uniqueness analytically.
  * :func:`predict_config_cost` — one scalar objective per candidate,
    composing the per-tier ``exchange_cost`` wire/exposed bytes, the
    ``blocked_multiply_count`` executed-tile compute, and the
    ``CoinEnergyModel``/``MeshNoC`` energy+latency models. Its comm fields
    use the *same formulas* as `repro_torch.launch.dryrun.exchange_accounting`,
    so prediction-vs-measurement is an exact-field comparison.
  * :func:`autotune_config` — coordinate descent: the pod_map knob moves by
    FM-style swap passes on the quotient graph (:func:`refine_pod_map`),
    discrete knobs are enumerated in place, and the block-size knob is
    searched with ``core.solver``'s golden-section over log2(block) before
    snapping to the tile grid. Seeded from today's defaults; every candidate
    evaluation emits a `repro_torch.obs` span (``autotune.candidate``) and
    metrics (``autotune.candidates``, ``autotune.objective_s``,
    ``autotune.objective_best_s``).

Objective units:

  compute_s   = executed multiplies / (``PEAK_FLOPS`` · ``BACKEND_EFFICIENCY``)  [s]
  wire_s      = exposed halo bytes × layers / ``ICI_BYTES_PER_S``   [s]
  noc_latency_s = MeshNoC serialization bound of the dedup-row
                  traffic matrix under the candidate placement       [s]
  noc_energy_j  = MeshNoC energy of the same trace                  [J]
  coin_energy_j = CoinEnergyModel Eq. 3 at k, scaled to joules by
                  the NoC link energy (placement-independent anchor) [J]
  objective_s = compute_s + wire_s + noc_latency_s
                + ENERGY_WEIGHT_S_PER_J · (noc_energy_j + coin_energy_j)

Everything is host numpy and deterministic: the same tie-breaks and loop
orders as the reference, so under the reference's constants every map,
config, history and predicted field equals the reference's. The constants
here are the H100's (see their comments); the NoC and energy terms model
COIN's chip, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dataflow import blocked_multiply_count, exchange_cost, sparse_multiply_count
from repro_torch.core.energy import CoinEnergyModel
from repro_torch.core.noc import MeshNoC
from repro_torch.core.partition import Partition, partition_graph, quotient_graph
from repro_torch.core.quant import payload_bits
from repro_torch.core.solver import _golden_section
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "CandidateConfig",
    "CommStats",
    "BoundaryIndex",
    "comm_stats_from_plan",
    "map_parts_to_pods",
    "refine_pod_map",
    "predict_config_cost",
    "autotune_config",
    "AutotuneResult",
    "PEAK_FLOPS",
    "ICI_BYTES_PER_S",
    "ENERGY_WEIGHT_S_PER_J",
]

# Roofline anchors for the scalar objective: one NVIDIA H100 SXM (80GB
# HBM3, 700 W). Absolute values only set the exchange rate between terms;
# every comparison the autotuner makes is between candidates under the SAME
# constants. The parity tests set them to the reference's values.
PEAK_FLOPS = 33.5e12          # multiplies/s: 67 TFLOP/s fp32 (data sheet, not measured) / 2 per FMA;
                              # the port's aggregation kernels run IEEE fp32
ICI_BYTES_PER_S = 450e9       # NVLink 4 per direction (data sheet; one card's machine cannot measure it)
ENERGY_WEIGHT_S_PER_J = 10.0  # how many seconds one joule is worth
# Fraction of PEAK_FLOPS each aggregation engine sustains: the multiplies the
# cost model counts for one fp32 aggregation at unsharded Nell (bsr: valid
# tiles · 128² · F; segment: E · F) over PEAK_FLOPS × its measured time,
# through K1 (`ragged_layer_kernel<2>`) and through the segment path (gather
# + `index_add_`). Measured by `chip_smoke.py`'s `autotune` line (d) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, at F = 16, the width
# both of Nell's aggregations take (K1 0.418 ms, segment 0.237 ms); at
# F = 210 they read 0.204 and 0.00159. The bsr engine executes every
# multiply of its padded tiles; the segment engine moves one operand per
# multiply, so it counts far fewer multiplies at a far lower rate.
BACKEND_EFFICIENCY = {"bsr": 0.218, "segment": 0.000432}
BLOCK_GRID = (32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    """One point of the joint search space (defaults == today's defaults)."""

    pods: int = 1
    pod_map: tuple[int, ...] | None = None   # None → contiguous pod-major
    block: int = 128
    backend: str = "bsr"                     # "segment" | "bsr"
    order: str = "feature_first"             # | "aggregation_first"
    payload: str | None = None               # None/"fp32" | "bf16" | "int8"
    overlap: bool = True

    def pod_map_array(self) -> np.ndarray | None:
        return None if self.pod_map is None else np.asarray(self.pod_map, np.int64)


@dataclasses.dataclass(frozen=True)
class CommStats:
    """The deterministic comm geometry :func:`predict_config_cost` reads.

    Derivable two ways — analytically from a :class:`BoundaryIndex`
    (``index.comm_stats``) or from a built plan
    (:func:`comm_stats_from_plan`); the two agree exactly, which is the
    calibration contract the dry-run ``predicted`` block pins.
    """

    k: int
    pods: int
    n_local: int
    s_max: int
    s_loc: int
    s_rem: int
    overlap_fraction: float


def comm_stats_from_plan(plan) -> CommStats:
    """Read a built ``HaloPlan``'s geometry back as :class:`CommStats`."""
    return CommStats(
        k=int(plan.k),
        pods=int(plan.n_pods),
        n_local=int(plan.n_local),
        s_max=int(plan.s_max),
        s_loc=int(plan.s_loc),
        s_rem=int(plan.s_rem),
        overlap_fraction=float(plan.overlap_fraction()),
    )


class BoundaryIndex:
    """Deduplicated boundary-pair index of one (graph, partition).

    Stores every distinct (source node, destination part) pair of the cut —
    the unit that occupies one export slot in a halo plan — so the exact
    per-tier pads of any candidate pod_map come from an O(pairs) numpy
    reduction instead of a full plan build.
    """

    def __init__(self, part: Partition, edge_index: np.ndarray):
        self.k = int(part.k)
        self.n_nodes = int(part.n_nodes)
        a = np.asarray(part.assignment, np.int64)
        src = np.asarray(edge_index[0], np.int64)
        dst = np.asarray(edge_index[1], np.int64)
        self.n_edges = int(src.shape[0])
        cut = a[src] != a[dst]
        self.cut_edges = int(cut.sum())
        self.interior_edges = self.n_edges - self.cut_edges
        uniq = np.unique(src[cut] * self.k + a[dst[cut]])
        self.pair_node = uniq // self.k          # (P,) distinct source nodes
        self.pair_dst = (uniq % self.k).astype(np.int64)
        self.pair_src = a[self.pair_node]        # source part of each pair
        self.part_sizes = np.bincount(a, minlength=self.k).astype(np.int64)
        self.n_local = int(self.part_sizes.max()) if self.n_nodes else 0
        # Flat pad: distinct exported nodes per part over ALL cut pairs.
        flat_nodes = np.unique(self.pair_node)
        flat_counts = np.bincount(a[flat_nodes], minlength=self.k)
        self.s_max = int(flat_counts.max()) if flat_nodes.size else 0
        # Quotient weight matrix: W[i, j] = dedup rows i exports to j.
        self.row_traffic = np.bincount(
            self.pair_src * self.k + self.pair_dst, minlength=self.k * self.k
        ).reshape(self.k, self.k).astype(np.int64)

    @property
    def overlap_fraction(self) -> float:
        return self.interior_edges / self.n_edges if self.n_edges else 0.0

    def tier_sizes(self, pods: int, pod_map: np.ndarray | None) -> tuple[int, int]:
        """Exact (s_loc, s_rem) pads of the hierarchical plan under pod_map.

        Mirrors ``_export_sets``: within each tier a source node counts once
        per source device no matter how many destinations read it; a node
        exported on both tiers counts once in each.
        """
        if pods <= 1:
            return 0, 0
        if pod_map is None:
            k_model = self.k // pods
            pod_of = np.arange(self.k) // k_model
        else:
            pod_of = np.asarray(pod_map, np.int64)
        cross = pod_of[self.pair_src] != pod_of[self.pair_dst]
        s_loc = self._max_distinct(~cross)
        s_rem = self._max_distinct(cross)
        return s_loc, s_rem

    def _max_distinct(self, mask: np.ndarray) -> int:
        nodes = np.unique(self.pair_node[mask])
        if not nodes.size:
            return 0
        counts = np.bincount(self.pair_src[np.searchsorted(self.pair_node, nodes)], minlength=self.k)
        return int(counts.max())

    def comm_stats(self, pods: int = 1, pod_map: np.ndarray | None = None) -> CommStats:
        s_loc, s_rem = self.tier_sizes(pods, pod_map)
        return CommStats(
            k=self.k, pods=int(pods), n_local=self.n_local, s_max=self.s_max,
            s_loc=s_loc, s_rem=s_rem, overlap_fraction=self.overlap_fraction,
        )


def map_parts_to_pods(
    part: Partition,
    edge_index: np.ndarray,
    pods: int,
    *,
    seed: int = 0,
    passes: int = 8,
    restarts: int = 4,
    index: BoundaryIndex | None = None,
) -> np.ndarray:
    """Quotient-graph pod mapper: balanced (k,) part→pod assignment.

    Contracts the partitioned graph with :func:`quotient_graph`, seeds a pod
    assignment by partitioning the quotient (``partition_graph`` BFS +
    ``refine_partition`` over the weight-expanded edge list), rebalances to
    exactly ``k // pods`` parts per pod, then runs FM-style swap passes
    (:func:`refine_pod_map`) minimizing the deduplicated crossing rows.
    ``restarts`` BFS seeds (``seed .. seed+restarts−1``) are tried and the
    best final objective kept — deterministic (ties favor the lowest seed).
    """
    k = int(part.k)
    if pods < 1 or k % pods:
        raise ValueError(f"pods={pods} must divide k={k}")
    index = index or BoundaryIndex(part, edge_index)
    if pods == 1:
        return np.zeros(k, np.int64)
    q_ei, q_w = quotient_graph(part, edge_index)
    # Weight-aware seeding: repeat each quotient edge by its row weight so
    # the unweighted BFS/refine machinery sees the boundary-row mass.
    rep = np.repeat(np.arange(q_ei.shape[1]), q_w)
    expanded = q_ei[:, rep]
    best_map, best_obj = None, None
    for s in range(seed, seed + max(restarts, 1)):
        seeded = partition_graph(k, expanded, pods, method="bfs", seed=s, refine=True)
        pod_map = _balance_pod_map(seeded.assignment.astype(np.int64), k, pods, index)
        pod_map = refine_pod_map(pod_map, pods, index, passes=passes)
        obj = _crossing_objective(pod_map, pods, index)
        if best_obj is None or obj < best_obj:
            best_map, best_obj = pod_map, obj
    return best_map


def _balance_pod_map(pod_map: np.ndarray, k: int, pods: int, index: BoundaryIndex) -> np.ndarray:
    """Force exactly ``k // pods`` parts per pod, greedily moving the part
    whose move costs the fewest crossing rows (deterministic tie-break on
    part id)."""
    target = k // pods
    pod_map = pod_map.copy()
    sizes = np.bincount(pod_map, minlength=pods)
    while np.any(sizes != target):
        over = int(np.argmax(sizes))
        under = int(np.argmin(sizes))
        members = np.flatnonzero(pod_map == over)
        best_part, best_cost = -1, None
        for p in members:
            pod_map[p] = under
            cost = _crossing_objective(pod_map, pods, index)
            pod_map[p] = over
            if best_cost is None or cost < best_cost:
                best_part, best_cost = int(p), cost
        pod_map[best_part] = under
        sizes[over] -= 1
        sizes[under] += 1
    return pod_map


def _crossing_objective(pod_map: np.ndarray, pods: int, index: BoundaryIndex) -> tuple[int, int]:
    """(crossing rows under the pad, total crossing pair count) — lexicographic.

    The pad term ``(pods−1)·s_rem`` is what the plan actually ships (the
    acceptance metric); the raw pair count breaks ties smoothly so passes
    keep making progress while the max-device pad is flat.
    """
    pod_s = pod_map[index.pair_src]
    pod_d = pod_map[index.pair_dst]
    cross = pod_s != pod_d
    s_rem = index._max_distinct(cross)
    return ((pods - 1) * s_rem, int(cross.sum()))


def refine_pod_map(
    pod_map: np.ndarray,
    pods: int,
    index: BoundaryIndex,
    *,
    passes: int = 8,
) -> np.ndarray:
    """FM-style quotient boundary refinement under an EXACT balance cap.

    Balance must stay exact (every pod hosts ``k // pods`` parts — the plan
    relabeling has no raveling otherwise), so the move unit is a SWAP of two
    parts across pods. Each pass evaluates every cross-pod pair and commits
    the best strictly-improving swap until none improves; the objective is
    :func:`_crossing_objective`, so crossing rows never increase and the
    result is deterministic (first-best on ties, part-id order).
    """
    pod_map = np.asarray(pod_map, np.int64).copy()
    k = pod_map.shape[0]
    cur = _crossing_objective(pod_map, pods, index)
    for _ in range(passes):
        best_swap, best_obj = None, cur
        for i in range(k):
            for j in range(i + 1, k):
                if pod_map[i] == pod_map[j]:
                    continue
                pod_map[i], pod_map[j] = pod_map[j], pod_map[i]
                obj = _crossing_objective(pod_map, pods, index)
                pod_map[i], pod_map[j] = pod_map[j], pod_map[i]
                if obj < best_obj:
                    best_swap, best_obj = (i, j), obj
        if best_swap is None:
            break
        i, j = best_swap
        pod_map[i], pod_map[j] = pod_map[j], pod_map[i]
        cur = best_obj
    return pod_map


def predict_config_cost(
    cfg: CandidateConfig,
    stats: CommStats,
    *,
    d_feat: int,
    n_nodes: int | None = None,
    layer_dims: tuple[int, ...] | None = None,
    nnz_blocks: int | None = None,
    n_edges: int | None = None,
    row_traffic: np.ndarray | None = None,
    noc: MeshNoC | None = None,
    energy_model: CoinEnergyModel | None = None,
) -> dict:
    """Analytic cost of one candidate config — the search's objective.

    The comm fields reproduce the dry-run ``exchange_accounting`` formulas
    verbatim (same names, same units), so a plan built from ``cfg`` measures
    exactly what this predicts for every deterministic field — the pinned
    calibration contract. The scalar lives under ``"objective_s"``; the
    breakdown terms and their units are in the module docstring.
    """
    k, pods = stats.k, cfg.pods
    if pods != stats.pods:
        raise ValueError(f"cfg.pods={pods} disagrees with stats.pods={stats.pods}")
    hierarchical = pods > 1
    if hierarchical:
        k_model = k // pods
        block_rows = stats.s_loc + pods * stats.s_rem
        halo_rows = pods * stats.s_rem + k_model * block_rows
    else:
        halo_rows = k * stats.s_max
    broadcast_rows = (k - 1) * stats.n_local
    bits = payload_bits(cfg.payload)
    ov = stats.overlap_fraction if cfg.overlap else 0.0
    d = int(d_feat)
    ec = exchange_cost(halo_rows, d, bits, ov)
    out = {
        "halo_rows_per_device": halo_rows,
        "broadcast_rows_per_device": broadcast_rows,
        "wire_fraction": halo_rows / max(broadcast_rows, 1),
        "halo_bytes_per_exchange": halo_rows * d * 4,
        "payload": cfg.payload or "fp32",
        "payload_bits": bits,
        "payload_compression": ec.compression,
        "overlap": bool(cfg.overlap),
        "overlap_fraction": ov,
        "halo_wire_bytes_per_exchange": ec.wire_bytes,
        "halo_exposed_bytes_per_exchange": ec.exposed_bytes,
    }
    if hierarchical:
        out.update(
            pods=pods,
            intra_pod_rows_per_device=k_model * block_rows,
            inter_pod_rows_per_device=pods * stats.s_rem,
            inter_pod_rows_crossing=(pods - 1) * stats.s_rem,
            flat_inter_pod_rows_crossing=(pods - 1) * k_model * stats.s_max,
            inter_pod_bytes_crossing=(pods - 1) * stats.s_rem * d * 4,
            flat_inter_pod_bytes_crossing=(pods - 1) * k_model * stats.s_max * d * 4,
        )

    # ---------------------------------------------------- objective terms
    dims = tuple(layer_dims) if layer_dims else (d, d)
    n = int(n_nodes if n_nodes is not None else stats.k * stats.n_local)
    flops = 0.0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        if cfg.backend == "bsr" and nnz_blocks is not None:
            cost = blocked_multiply_count(n, nnz_blocks, d_in, d_out, block=cfg.block)
        else:
            cost = sparse_multiply_count(n, int(n_edges or 0), d_in, d_out)
        flops += getattr(cost, cfg.order)
    n_exchanges = max(len(dims) - 1, 1)
    compute_s = flops / (PEAK_FLOPS * BACKEND_EFFICIENCY.get(cfg.backend, 1.0))
    wire_s = ec.exposed_bytes * n_exchanges / ICI_BYTES_PER_S
    out.update(compute_flops=flops, compute_s=compute_s, wire_s=wire_s)

    noc_energy_j = noc_latency_s = 0.0
    if noc is not None and row_traffic is not None:
        ts = noc.summarize(row_traffic.astype(np.float64) * d * bits)
        noc_energy_j, noc_latency_s = ts.energy_j * n_exchanges, ts.latency_s * n_exchanges
    coin_energy_j = 0.0
    if energy_model is not None:
        scale = (noc or MeshNoC.square(k)).e_link_j_per_bit
        coin_energy_j = energy_model.total(k) * scale
    out.update(
        noc_energy_j=noc_energy_j,
        noc_latency_s=noc_latency_s,
        coin_energy_j=coin_energy_j,
        objective_s=compute_s + wire_s + noc_latency_s
        + ENERGY_WEIGHT_S_PER_J * (noc_energy_j + coin_energy_j),
    )
    return out


@dataclasses.dataclass
class AutotuneResult:
    """Chosen config + the predicted breakdowns the report prints."""

    config: CandidateConfig
    predicted: dict
    baseline_config: CandidateConfig
    baseline: dict
    history: list[tuple[str, float]]    # (knob description, objective_s)

    @property
    def predicted_improvement(self) -> float:
        return self.baseline["objective_s"] / max(self.predicted["objective_s"], 1e-30)


def _device_order(pod_map: np.ndarray | None, k: int, pods: int) -> np.ndarray:
    if pod_map is None:
        return np.arange(k)
    return np.lexsort((np.arange(k), np.asarray(pod_map, np.int64)))


def autotune_config(
    part: Partition,
    edge_index: np.ndarray,
    *,
    pods: int,
    d_feat: int,
    layer_dims: tuple[int, ...] | None = None,
    nnz_blocks_for: "dict[int, int] | None" = None,
    energy_model: CoinEnergyModel | None = None,
    seed: int = 0,
    rounds: int = 3,
    seed_config: CandidateConfig | None = None,
) -> AutotuneResult:
    """Coordinate descent over the joint (pod_map, exec config) space.

    Each round moves one knob at a time against :func:`predict_config_cost`
    with every other knob fixed: the pod_map by quotient FM swap passes, the
    discrete knobs (backend, order, payload, overlap) by enumeration, and
    the block size by ``core.solver`` golden-section over log2(block)
    snapped to the tile grid. Converges when a round changes nothing.

    ``nnz_blocks_for`` maps block size → nonzero tile count (from
    ``plan_blocked_shape``); omit it to cost the compute term with the
    edge-exact ``sparse_multiply_count`` instead.
    """
    k = int(part.k)
    index = BoundaryIndex(part, edge_index)
    noc = MeshNoC.square(k)
    baseline_cfg = seed_config or CandidateConfig(pods=pods)
    cfg = baseline_cfg

    def evaluate(c: CandidateConfig) -> dict:
        pm = c.pod_map_array()
        stats = index.comm_stats(c.pods, pm)
        order = _device_order(pm, k, c.pods)
        traffic = index.row_traffic[np.ix_(order, order)]
        nnz = (nnz_blocks_for or {}).get(c.block)
        with _obs_trace.span("autotune.candidate", args={"block": c.block, "payload": c.payload or "fp32"}):
            pred = predict_config_cost(
                c, stats, d_feat=d_feat, n_nodes=index.n_nodes,
                layer_dims=layer_dims, nnz_blocks=nnz, n_edges=index.n_edges,
                row_traffic=traffic, noc=noc, energy_model=energy_model,
            )
        if _obs_metrics.enabled():
            _obs_metrics.inc("autotune.candidates")
            _obs_metrics.observe("autotune.objective_s", pred["objective_s"])
        return pred

    baseline = evaluate(baseline_cfg)
    best = evaluate(cfg)
    history: list[tuple[str, float]] = [("seed defaults", best["objective_s"])]

    for _ in range(rounds):
        changed = False
        # --- pod_map: quotient mapper + FM swap passes -------------------
        if pods > 1:
            pm = map_parts_to_pods(part, edge_index, pods, seed=seed, index=index)
            cand = dataclasses.replace(cfg, pod_map=tuple(int(x) for x in pm))
            pred = evaluate(cand)
            if pred["objective_s"] < best["objective_s"]:
                cfg, best, changed = cand, pred, True
                history.append(("pod_map (quotient FM)", best["objective_s"]))
        # --- discrete knobs ----------------------------------------------
        for knob, values in (
            ("backend", ("segment", "bsr")),
            ("order", ("feature_first", "aggregation_first")),
            ("payload", (None, "bf16", "int8")),
            ("overlap", (False, True)),
        ):
            for v in values:
                if getattr(cfg, knob) == v:
                    continue
                cand = dataclasses.replace(cfg, **{knob: v})
                pred = evaluate(cand)
                if pred["objective_s"] < best["objective_s"]:
                    cfg, best, changed = cand, pred, True
                    history.append((f"{knob}={v}", best["objective_s"]))
        # --- block size: golden-section over log2(block), snapped --------
        # Searched jointly with backend="bsr" (block is meaningless for the
        # segment engine), so a descent step into "segment" can still be
        # overturned by bsr at a better tile size next round.
        if nnz_blocks_for:
            def snap(x: float) -> int:
                return min(BLOCK_GRID, key=lambda b: abs(np.log2(b) - x))

            def f(x: float) -> float:
                cand = dataclasses.replace(cfg, backend="bsr", block=snap(x))
                return evaluate(cand)["objective_s"]

            x_star = _golden_section(f, np.log2(min(BLOCK_GRID)), np.log2(max(BLOCK_GRID)), iters=12)
            cand = dataclasses.replace(cfg, backend="bsr", block=snap(x_star))
            pred = evaluate(cand)
            if pred["objective_s"] < best["objective_s"]:
                cfg, best, changed = cand, pred, True
                history.append((f"backend=bsr block={cand.block}", best["objective_s"]))
        if not changed:
            break

    if _obs_metrics.enabled():
        _obs_metrics.set_gauge("autotune.objective_best_s", best["objective_s"])
    return AutotuneResult(
        config=cfg, predicted=best, baseline_config=baseline_cfg,
        baseline=baseline, history=history,
    )
