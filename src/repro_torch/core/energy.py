"""COIN communication-energy model (paper §IV-B, Eqs. 1–3, Appendix A Eq. 5).

Twin of `repro.core.energy` (numpy only; the port keeps its own copy).

The paper models the total on-chip communication energy of a GCN mapped onto
``k`` compute elements (CEs) as the sum of an intra-CE and an inter-CE term:

    E_intra(k) = Σ_m (N/k)(N/k − 1) p⁽¹⁾_m · Σ_{l=1..L−1} a(l+1) · (N/k)^(1/2)
    E_inter(k) = Σ_{i≠j} (N/k)² p⁽²⁾_ij · (Σ_{l=1..L−1} a(l+1)) · k^(1/2)

with
    N        — number of GCN (graph) nodes,
    k        — number of CEs (decision variable),
    a(l)     — input activation *bits* of layer l per node,
    p⁽¹⁾_m   — probability of an edge between two nodes mapped to CE m,
    p⁽²⁾_ij  — probability of an edge between a node in CE i and one in CE j,
    (N/k)^½  — energy/bit scaling of the intra-CE (local NoC) fabric,
    k^½      — energy/bit scaling of the inter-CE (global mesh NoC) fabric [37].

Everything here is exact to the paper; the only generality added is that the
connection probabilities may be scalars (the paper's closed form, used for the
convexity proof with p1=0.25, p2=0.22) or measured per-partition values
(computed by :mod:`repro_torch.core.partition` from an actual graph partition).

Units: `a(l)` is in bits, so E(k) is in (bits · unit-energy). Multiply by an
energy-per-bit calibration constant (see :mod:`repro_torch.core.noc`) to obtain
joules. The *optimum* k is invariant to that constant.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "sum_hidden_activation_bits",
    "CoinEnergyModel",
    "PAPER_P_INTRA",
    "PAPER_P_INTER",
]

# Appendix A: "the highest probability of intra-CE connection for the dataset
# we consider is 0.25 and the highest probability of [inter]-CE connection is
# 0.22" — used in the published convexity bound (Eq. 5).
PAPER_P_INTRA = 0.25
PAPER_P_INTER = 0.22


def sum_hidden_activation_bits(layer_dims: Sequence[int], act_bits: int) -> float:
    """Σ_{l=1..L−1} a(l+1): total per-node *hidden* activation bits communicated.

    ``layer_dims`` = [d_in, h_1, ..., h_{L-1}, d_out] for an L-layer network.
    a(l) is the number of input activation bits of layer l, so a(l+1) for
    l = 1..L−1 covers the hidden activations h_1..h_{L-1} (the final output is
    not forwarded to a subsequent layer). For the paper's 2-layer GCN
    [F, 16, C] this is simply 16·act_bits.
    """
    if len(layer_dims) < 3:
        return 0.0
    hidden = layer_dims[1:-1]
    return float(sum(hidden) * act_bits)


@dataclasses.dataclass(frozen=True)
class CoinEnergyModel:
    """Closed-form E(k) (Eqs. 1–3) with scalar or per-partition probabilities.

    Args:
      n_nodes: N, the number of GCN nodes.
      act_bits_sum: Σ_{l=1..L−1} a(l+1) (per-node hidden activation bits).
      p_intra: scalar edge probability inside a CE (paper's p⁽¹⁾). A scalar
        reproduces the paper's closed form `Σ_m → k · p_intra`.
      p_inter: scalar edge probability across CEs (paper's p⁽²⁾). A scalar
        reproduces `Σ_{i≠j} → k(k−1) · p_inter`.
    """

    n_nodes: int
    act_bits_sum: float
    p_intra: float = PAPER_P_INTRA
    p_inter: float = PAPER_P_INTER

    # ---------------------------------------------------------------- E terms
    def e_intra(self, k):
        """Eq. 1 with uniform p: k · (N/k)(N/k−1)·p1 · S_a · (N/k)^½ ."""
        k = np.asarray(k, dtype=np.float64)
        n_per = self.n_nodes / k
        return k * n_per * (n_per - 1.0) * self.p_intra * self.act_bits_sum * np.sqrt(n_per)

    def e_inter(self, k):
        """Eq. 2 with uniform p: k(k−1) · (N/k)² · p2 · S_a · k^½ ."""
        k = np.asarray(k, dtype=np.float64)
        n_per = self.n_nodes / k
        return k * (k - 1.0) * n_per * n_per * self.p_inter * self.act_bits_sum * np.sqrt(k)

    def total(self, k):
        """Eq. 3: E(k) = E_intra(k) + E_inter(k)."""
        return self.e_intra(k) + self.e_inter(k)

    # ------------------------------------------------------------ derivatives
    # Expand E(k)/S_a with uniform p:
    #   E_intra/S = p1 (N^2.5 k^-1.5 − N^1.5 k^-0.5)
    #   E_inter/S = p2 N² (k^0.5 − k^-0.5)
    def d_total(self, k):
        k = np.asarray(k, dtype=np.float64)
        n = float(self.n_nodes)
        d_intra = self.p_intra * (-1.5 * n**2.5 * k**-2.5 + 0.5 * n**1.5 * k**-1.5)
        d_inter = self.p_inter * n * n * (0.5 * k**-0.5 + 0.5 * k**-1.5)
        return (d_intra + d_inter) * self.act_bits_sum

    def d2_total(self, k):
        """Appendix A Eq. 5 (generalized to arbitrary p1/p2).

        With the paper's p1=0.25, p2=0.22 the coefficients evaluate to the
        published 0.94·N^2.5/k^3.5 − 0.06·N²/k^1.5 − (0.17·N²+0.19·N^1.5)/k^2.5.
        """
        k = np.asarray(k, dtype=np.float64)
        n = float(self.n_nodes)
        term = (
            3.75 * self.p_intra * n**2.5 * k**-3.5
            - 0.25 * self.p_inter * n**2 * k**-1.5
            - (0.75 * self.p_inter * n**2 + 0.75 * self.p_intra * n**1.5) * k**-2.5
        )
        return term * self.act_bits_sum

    def is_convex(self, k_min: float = 4.0, k_max: float = 100.0, num: int = 512) -> bool:
        """Appendix A claim: d²E/dk² > 0 over k ∈ [4, 100] for N > 2000.

        NOTE: evaluating the paper's own Eq. 5 shows this strict claim fails
        for k ≳ 3.96·N^¼ (e.g. N=6000, k=100) — see solver.py. Use
        :meth:`convex_k_limit` / :meth:`is_unimodal` for the properties that
        actually hold; this method reports the literal claim."""
        ks = np.linspace(k_min, k_max, num)
        return bool(np.all(self.d2_total(ks) > 0.0))

    def convex_k_limit(self) -> float:
        """Largest k below which d²E/dk² > 0 (bisection on Eq. 5)."""
        lo, hi = 1.0, 1e6
        if self.d2_total(lo) <= 0:
            return lo
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if self.d2_total(mid) > 0:
                lo = mid
            else:
                hi = mid
        return lo

    def is_unimodal(self, k_min: float = 2.0, k_max: float = 400.0, num: int = 4096) -> bool:
        """E(k) strictly decreases then increases (the property the
        interior-point conclusion actually needs)."""
        ks = np.linspace(k_min, k_max, num)
        d = np.diff(self.total(ks))
        sign_changes = np.flatnonzero(np.sign(d[:-1]) != np.sign(d[1:]))
        return sign_changes.size <= 1

    # -------------------------------------------------------------- utilities
    def normalized(self, ks) -> np.ndarray:
        """E(k)/max(E) over the given ks — reproduces Fig. 19."""
        e = self.total(np.asarray(ks, dtype=np.float64))
        return e / np.max(e)

    def continuous_argmin(self) -> float:
        """Stationary point from dE/dk = 0, leading-order closed form.

        Balancing the dominant terms −1.5·p1·N^2.5·k^-2.5 and 0.5·p2·N²·k^-0.5
        gives k* ≈ (3 p1 √N / p2)^(1/2) — a useful analytic sanity check for
        the interior-point solver (k* ≈ 16 at N≈6000 with paper constants).
        """
        return math.sqrt(3.0 * self.p_intra * math.sqrt(self.n_nodes) / self.p_inter)


def model_from_gcn(
    n_nodes: int, layer_dims: Sequence[int], act_bits: int = 4,
    p_intra: float = PAPER_P_INTRA, p_inter: float = PAPER_P_INTER,
) -> CoinEnergyModel:
    """Convenience constructor from a GCN layer-dimension list."""
    return CoinEnergyModel(
        n_nodes=n_nodes,
        act_bits_sum=sum_hidden_activation_bits(layer_dims, act_bits),
        p_intra=p_intra,
        p_inter=p_inter,
    )
