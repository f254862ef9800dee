"""Interior-point minimization of the COIN objective (paper §IV-B3).

Twin of `repro.core.solver` (numpy only; the port keeps its own copy).

The paper minimizes E(k) subject to k > 0 with an interior-point (log-barrier)
method [38], reporting a 10 ms solve and an optimum of k = 16 (4×4 mesh).

A note on Appendix A: the paper claims d²E/dk² > 0 for all k ∈ [4, 100] and
N > 2000. Evaluating the paper's own Eq. 5 shows this is *not* true for the
whole range (e.g. N = 6000, k = 100 gives d²E/dk² < 0; positivity holds only
for k ≲ 3.96·N^¼). E(k) is nonetheless *unimodal* (strictly decreasing, then
increasing) on the range of interest and convex in a neighborhood of the
minimizer, so the interior-point conclusion stands. We therefore run a
golden-section localization over the full feasible range (robust to the
non-convex tail) followed by a log-barrier damped-Newton polish (the paper's
method, valid in the locally convex basin). The discrepancy is recorded in
EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.energy import CoinEnergyModel

__all__ = [
    "interior_point_minimize",
    "SolveResult",
    "optimal_ce_count",
    "mesh_sweep",
    "SQUARE_MESHES",
]

# Fig. 9 sweeps square meshes 3×3 .. 10×10.
SQUARE_MESHES: tuple[int, ...] = tuple(m * m for m in range(3, 11))


@dataclasses.dataclass(frozen=True)
class SolveResult:
    k_star: float              # continuous minimizer
    k_mesh: int                # nearest feasible square-mesh CE count
    mesh_shape: tuple[int, int]
    energy_at_k: float
    solve_ms: float
    iterations: int
    converged: bool


def _golden_section(f: Callable[[float], float], a: float, b: float, iters: int = 96) -> float:
    gr = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = f(d)
        if b - a < 1e-10 * max(1.0, abs(b)):
            break
    return 0.5 * (a + b)


def interior_point_minimize(
    f: Callable[[float], float],
    df: Callable[[float], float] | None = None,
    d2f: Callable[[float], float] | None = None,
    k_lo: float = 1.0,
    k_hi: float = 1e4,
    mu0: float = 1e-3,
    mu_shrink: float = 0.2,
    tol: float = 1e-9,
    max_outer: int = 30,
    max_newton: int = 40,
) -> tuple[float, int, bool]:
    """min f(k) s.t. k_lo < k < k_hi: golden localization + log-barrier Newton.

    φ_μ(k) = f(k) − μ·(log(k − k_lo) + log(k_hi − k)); damped Newton with a
    gradient-descent fallback when the local Hessian is non-PSD; μ shrinks
    geometrically (the standard barrier path). Returns (k*, iters, converged).
    """
    if df is None:
        h = 1e-4
        df = lambda k: (f(k + h) - f(k - h)) / (2 * h)  # noqa: E731
    if d2f is None:
        h = 1e-3
        d2f = lambda k: (f(k + h) - 2.0 * f(k) + f(k - h)) / (h * h)  # noqa: E731

    k = _golden_section(f, k_lo + 1e-9, k_hi - 1e-9)
    fscale = max(abs(f(k)), 1.0)
    mu = mu0 * fscale
    total_iters = 0
    converged = False

    def phi(x: float, mu: float) -> float:
        return f(x) - mu * (math.log(x - k_lo) + math.log(k_hi - x))

    for _ in range(max_outer):
        for _ in range(max_newton):
            total_iters += 1
            g = df(k) - mu / (k - k_lo) + mu / (k_hi - k)
            hss = d2f(k) + mu / (k - k_lo) ** 2 + mu / (k_hi - k) ** 2
            step = g / hss if (np.isfinite(hss) and hss > 0) else math.copysign(0.1 * k, g)
            t, phi_k = 1.0, phi(k, mu)
            while t > 1e-14:
                cand = k - t * step
                if k_lo < cand < k_hi and phi(cand, mu) <= phi_k + 1e-18 * abs(phi_k):
                    break
                t *= 0.5
            k_new = k - t * step
            if abs(k_new - k) < tol * max(1.0, abs(k)):
                k = k_new
                break
            k = k_new
        mu *= mu_shrink
        if mu < 1e-12 * fscale:
            converged = True
            break
    return float(k), total_iters, converged


def _best_square_mesh(candidates: Sequence[int], f: Callable[[float], float]) -> int:
    """Snap to the feasible square mesh minimizing the (unimodal) objective."""
    return int(min(candidates, key=lambda c: f(float(c))))


def optimal_ce_count(
    model: CoinEnergyModel,
    mesh_candidates: Sequence[int] = SQUARE_MESHES,
) -> SolveResult:
    """§IV-B3: minimize E(k), k > 0, then snap to a square mesh (paper → 16)."""
    t0 = time.perf_counter()
    k_star, iters, converged = interior_point_minimize(
        f=lambda k: float(model.total(k)),
        df=lambda k: float(model.d_total(k)),
        d2f=lambda k: float(model.d2_total(k)),
        k_lo=1.0,
        k_hi=float(max(mesh_candidates) * 4),
    )
    k_mesh = _best_square_mesh(mesh_candidates, lambda k: float(model.total(k)))
    ms = (time.perf_counter() - t0) * 1e3
    side = int(round(math.sqrt(k_mesh)))
    return SolveResult(
        k_star=k_star,
        k_mesh=k_mesh,
        mesh_shape=(side, side),
        energy_at_k=float(model.total(k_mesh)),
        solve_ms=ms,
        iterations=iters,
        converged=converged,
    )


def mesh_sweep(model: CoinEnergyModel, mesh_candidates: Sequence[int] = SQUARE_MESHES) -> dict[int, float]:
    """Fig. 9: modeled communication energy for each square-mesh CE count."""
    return {int(k): float(model.total(float(k))) for k in mesh_candidates}
