"""Trace-driven 2D-mesh NoC model (the BookSim analogue of paper §V-A).

Twin of `repro.core.noc` (numpy only; the port keeps its own copy).

The paper feeds per-layer packet traces (src router, dst router, timestamp)
into a customized cycle-accurate BookSim. On this substrate we implement a
vectorized trace-driven model with the same architectural parameters
(Table II: 32-bit bus, X-Y routing, 5-port routers, mesh topology):

  * energy  — exact per-pair accounting: bits × (hops·E_link + (hops+1)·E_router),
  * latency — congestion bound: max per-link serialization under X-Y routing
              (computed exactly from the traffic matrix) + pipeline latency,
  * c-mesh  — concentrated-mesh variant (Fig. 12/14 comparison): express
              links halve hop count, 8-port routers raise per-hop energy.

For the *baseline* architecture (one router per GCN node, k up to 65 755) the
k×k traffic matrix is too large to materialize, so uniform-broadcast closed
forms (exact mean Manhattan distance on an r×c grid) are used instead.

Absolute joules require an energy-per-bit calibration; `MeshNoC.calibrated()`
scales the 32 nm defaults so the COIN reference point (Cora, 4×4 mesh →
2.7 µJ communication energy, §V-D) is matched, after which all other numbers
are predictions of the model.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.partition import Partition

__all__ = ["MeshNoC", "CMeshNoC", "TrafficSummary", "gcn_layer_traffic", "baseline_broadcast_summary"]

PJ = 1e-12


@dataclasses.dataclass(frozen=True)
class TrafficSummary:
    """Result of pushing one trace (traffic matrix) through the NoC model."""

    total_bits: float
    hop_bits: float            # Σ bits × hops (the "data communicated" metric of Fig. 1)
    energy_j: float
    latency_cycles: float
    latency_s: float

    @property
    def edp(self) -> float:
        return self.energy_j * self.latency_s

    def __add__(self, other: "TrafficSummary") -> "TrafficSummary":
        # Layers execute serially (paper §IV-C2) → bits/energy/latency add.
        return TrafficSummary(
            self.total_bits + other.total_bits,
            self.hop_bits + other.hop_bits,
            self.energy_j + other.energy_j,
            self.latency_cycles + other.latency_cycles,
            self.latency_s + other.latency_s,
        )


def _mean_manhattan(rows: int, cols: int) -> float:
    """Exact E|Δr|+E|Δc| for two independent uniform points on a rows×cols grid."""
    er = (rows * rows - 1.0) / (3.0 * rows)
    ec = (cols * cols - 1.0) / (3.0 * cols)
    return er + ec


@dataclasses.dataclass(frozen=True)
class MeshNoC:
    """2D-mesh NoC with X-Y routing (paper Table II parameters)."""

    rows: int
    cols: int
    bus_width_bits: int = 32
    freq_hz: float = 1.0e9
    # 32 nm per-bit energies (defaults in literature range; see calibrated()).
    e_router_j_per_bit: float = 0.060 * PJ
    e_link_j_per_bit: float = 0.025 * PJ
    router_delay_cycles: int = 2
    link_delay_cycles: int = 1
    energy_scale: float = 1.0

    # ------------------------------------------------------------------ setup
    @property
    def k(self) -> int:
        return self.rows * self.cols

    @classmethod
    def square(cls, k: int, **kw) -> "MeshNoC":
        side = int(round(math.sqrt(k)))
        if side * side == k:
            return cls(rows=side, cols=side, **kw)
        rows = int(math.floor(math.sqrt(k)))
        while k % rows:
            rows -= 1
        return cls(rows=rows, cols=k // rows, **kw)

    def _coords(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return ids // self.cols, ids % self.cols

    # ----------------------------------------------------------------- energy
    def _hops_matrix(self) -> np.ndarray:
        ids = np.arange(self.k)
        r, c = self._coords(ids)
        return (np.abs(r[:, None] - r[None, :]) + np.abs(c[:, None] - c[None, :])).astype(np.float64)

    def energy_for_traffic(self, traffic_bits: np.ndarray) -> tuple[float, float]:
        """(energy_joules, hop_bits) for a (k,k) traffic matrix in bits."""
        t = np.asarray(traffic_bits, dtype=np.float64)
        hops = self._hops_matrix()
        hop_bits = float((t * hops).sum())
        link_j = hop_bits * self.e_link_j_per_bit
        router_j = float((t * (hops + 1.0)).sum()) * self.e_router_j_per_bit
        return (link_j + router_j) * self.energy_scale, hop_bits

    # ---------------------------------------------------------------- latency
    def link_loads(self, traffic_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-link bit loads under X-first-then-Y dimension-order routing.

        Returns (h_load, v_load): h_load[r, c] is the load on the horizontal
        link between (r,c)↔(r,c+1) (both directions summed); v_load[r, c]
        likewise for (r,c)↔(r+1,c).
        """
        t = np.asarray(traffic_bits, dtype=np.float64)
        R, C = self.rows, self.cols
        h_load = np.zeros((R, max(C - 1, 1)))
        v_load = np.zeros((max(R - 1, 1), C))
        ids = np.arange(self.k)
        rr, cc = self._coords(ids)
        src, dst = np.nonzero(t)
        bits = t[src, dst]
        rs, cs, rd, cd = rr[src], cc[src], rr[dst], cc[dst]
        # Horizontal segment: row rs, columns [min(cs,cd), max(cs,cd)).
        lo, hi = np.minimum(cs, cd), np.maximum(cs, cd)
        for i in range(bits.shape[0]):
            if hi[i] > lo[i]:
                h_load[rs[i], lo[i]:hi[i]] += bits[i]
            rlo, rhi = (rs[i], rd[i]) if rs[i] <= rd[i] else (rd[i], rs[i])
            if rhi > rlo:
                v_load[rlo:rhi, cd[i]] += bits[i]
        return h_load, v_load

    def latency_for_traffic(self, traffic_bits: np.ndarray) -> float:
        """Congestion-bound latency (cycles): bottleneck-link serialization
        plus mean path pipeline depth. Approximates the BookSim trace replay
        in the bandwidth-limited regime the GCN broadcasts operate in."""
        t = np.asarray(traffic_bits, dtype=np.float64)
        if t.sum() == 0.0:
            return 0.0
        h_load, v_load = self.link_loads(t)
        max_link_bits = max(float(h_load.max(initial=0.0)), float(v_load.max(initial=0.0)))
        serialization = max_link_bits / self.bus_width_bits
        hops = self._hops_matrix()
        w = t / t.sum()
        mean_hops = float((w * hops).sum())
        pipeline = mean_hops * (self.router_delay_cycles + self.link_delay_cycles) + self.router_delay_cycles
        return serialization + pipeline

    # ------------------------------------------------------------- summaries
    def summarize(self, traffic_bits: np.ndarray) -> TrafficSummary:
        energy, hop_bits = self.energy_for_traffic(traffic_bits)
        cycles = self.latency_for_traffic(traffic_bits)
        return TrafficSummary(
            total_bits=float(np.asarray(traffic_bits, dtype=np.float64).sum()),
            hop_bits=hop_bits,
            energy_j=energy,
            latency_cycles=cycles,
            latency_s=cycles / self.freq_hz,
        )

    def intra_ce_energy(self, intra_bits: np.ndarray, nodes_per_ce: float) -> float:
        """Paper Eq. 1 scaling: intra-CE energy/bit ∝ (N/k)^½.

        The local (within-CE) NoC grows with the number of nodes mapped to the
        CE, so its mean path — hence energy/bit — scales as sqrt(N/k). We use
        the same per-hop constants with hop count sqrt(nodes_per_ce)."""
        hops = math.sqrt(max(nodes_per_ce, 1.0))
        e_bit = hops * self.e_link_j_per_bit + (hops + 1.0) * self.e_router_j_per_bit
        return float(np.asarray(intra_bits, dtype=np.float64).sum()) * e_bit * self.energy_scale

    # ------------------------------------------------------------ calibration
    def calibrated(self, scale: float) -> "MeshNoC":
        return dataclasses.replace(self, energy_scale=self.energy_scale * scale)


@dataclasses.dataclass(frozen=True)
class CMeshNoC(MeshNoC):
    """Concentrated mesh (Fig. 12/14 comparison): express links roughly halve
    hop counts; wider (8-port) routers cost more energy per traversal."""

    express_hop_factor: float = 0.5
    router_energy_factor: float = 1.6  # 8-port vs 5-port crossbar energy

    def _hops_matrix(self) -> np.ndarray:
        base = super()._hops_matrix()
        return np.ceil(base * self.express_hop_factor)

    def energy_for_traffic(self, traffic_bits: np.ndarray) -> tuple[float, float]:
        t = np.asarray(traffic_bits, dtype=np.float64)
        hops = self._hops_matrix()
        hop_bits = float((t * hops).sum())
        link_j = hop_bits * self.e_link_j_per_bit * 1.3  # longer express wires
        router_j = float((t * (hops + 1.0)).sum()) * self.e_router_j_per_bit * self.router_energy_factor
        return (link_j + router_j) * self.energy_scale, hop_bits


# --------------------------------------------------------------------- traces
def gcn_layer_traffic(
    part: Partition,
    act_bits_per_node_per_layer: list[float],
    broadcast: bool = True,
) -> list[np.ndarray]:
    """One inter-CE traffic matrix per GCN layer boundary (Fig. 5c exchange).

    ``act_bits_per_node_per_layer`` holds a(l+1) for l = 1..L−1 — the hidden
    activation bits per node communicated after each layer (paper §IV-B2).
    """
    return [part.inter_ce_traffic_bits(a, broadcast=broadcast) for a in act_bits_per_node_per_layer]


def baseline_broadcast_summary(
    noc: MeshNoC, n_nodes: int, bits_per_node: float
) -> TrafficSummary:
    """Closed-form summary for the BASELINE architecture (one CE per node).

    Every node broadcasts ``bits_per_node`` to all N−1 others on an
    r×c ≈ √N×√N mesh. Exact mean Manhattan distance gives energy and
    hop-bits; the bottleneck-bisection bound gives latency.
    """
    r, c = noc.rows, noc.cols
    assert r * c >= n_nodes, "baseline mesh must host one router per node"
    total_bits = float(n_nodes) * float(n_nodes - 1) * bits_per_node
    # Mean over DISTINCT ordered pairs: the all-pairs mean (which includes
    # the zero-distance self pairs) rescaled by k/(k−1).
    k = r * c
    mean_hops = _mean_manhattan(r, c) * k / (k - 1)
    hop_bits = total_bits * mean_hops
    energy = (
        hop_bits * noc.e_link_j_per_bit
        + total_bits * (mean_hops + 1.0) * noc.e_router_j_per_bit
    ) * noc.energy_scale
    # Bisection bound: ~half of all pair-bits cross the central vertical cut
    # of r links.
    cross_bits = total_bits * 0.5
    serialization = cross_bits / r / noc.bus_width_bits
    pipeline = mean_hops * (noc.router_delay_cycles + noc.link_delay_cycles)
    cycles = serialization + pipeline
    return TrafficSummary(
        total_bits=total_bits,
        hop_bits=hop_bits,
        energy_j=energy,
        latency_cycles=cycles,
        latency_s=cycles / noc.freq_hz,
    )
