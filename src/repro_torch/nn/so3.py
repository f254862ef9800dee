"""Real-spherical-harmonic rotation matrices + eSCN frame alignment — twin of
`repro.nn.so3`.

EquiformerV2 [arXiv:2306.12059] relies on the eSCN trick [arXiv:2302.03655]:
rotate each edge's irrep features so the edge direction maps to the z-axis;
in that frame SO(3) tensor-product convolutions reduce to per-m SO(2) linear
maps (block-diagonal in |m|), dropping the cost from O(L⁶) to O(L³).

  * `rotation_align_z`   — batched Rodrigues rotation taking unit vectors to ẑ,
  * `real_sh_rotations`  — Wigner-D matrices in the REAL SH basis, built with
    the Ivanic–Ruedenberg recursion (J. Phys. Chem. 1996, 100, 6342), term
    for term as the reference builds them: static Python loops over (l, m,
    m′), each entry a short chain of elementwise ops over the edges (≈ 455
    entries at l_max = 6).

Conventions: real SH index m ∈ [−l, l]; the l=1 basis ordering is (y, z, x),
so rotations about ẑ act on each (m, −m) pair as a 2-D rotation by m·γ —
the block-diagonal property eSCN needs.
"""
from __future__ import annotations

import torch

__all__ = ["rotation_align_z", "real_sh_rotations", "sh_block_slices", "block_diag_apply", "block_diag_apply_T"]

_EPS = 1e-9


def rotation_align_z(u: torch.Tensor) -> torch.Tensor:
    """(E, 3) unit vectors → (E, 3, 3) rotations R with R @ u = ẑ.

    Rodrigues formula about axis a = u × ẑ; the antipodal case u ≈ −ẑ falls
    back to a π rotation about x̂. A zero vector (a self-loop's) gives R = I.
    """
    c = u[..., 2]                                           # cos θ = u·ẑ
    a = torch.stack([u[..., 1], -u[..., 0], torch.zeros_like(c)], dim=-1)   # u × ẑ
    s2 = (a * a).sum(dim=-1)                                # sin² θ
    K = _skew(a)
    K2 = K @ K
    factor = torch.where(s2 > _EPS, (1.0 - c) / s2.clamp_min(_EPS), torch.zeros_like(s2))
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    R = eye + K + K2 * factor[..., None, None]
    # Antipodal: rotate π about x̂ (diag(1, −1, −1)).
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=u.dtype, device=u.device))
    anti = (c < -1.0 + 1e-6)[..., None, None]
    return torch.where(anti, flip, R)


def _skew(a: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(a[..., 0])
    return torch.stack(
        [
            torch.stack([z, -a[..., 2], a[..., 1]], -1),
            torch.stack([a[..., 2], z, -a[..., 0]], -1),
            torch.stack([-a[..., 1], a[..., 0], z], -1),
        ],
        -2,
    )


_PERM = (1, 2, 0)


def _r1_from_cartesian(R: torch.Tensor) -> torch.Tensor:
    """l=1 real-SH rotation from the Cartesian matrix; basis order (y, z, x)."""
    perm = list(_PERM)
    return R[..., perm, :][..., :, perm]


def real_sh_rotations(R: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    """[D_0, D_1, …, D_{l_max}] with D_l of shape (..., 2l+1, 2l+1).

    Ivanic–Ruedenberg recursion: D_l is assembled from D_{l−1} and D_1 via
    the U/V/W helper functions with closed-form u/v/w coefficients.
    """
    batch = R.shape[:-2]
    D = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return D
    r1 = _r1_from_cartesian(R)
    D.append(r1)

    def P(i: int, l: int, mu: int, mp: int, Rp: torch.Tensor) -> torch.Tensor:
        # r1 indexed by m ∈ {−1,0,1} → +1; Rp (=D_{l−1}) by m ∈ [−l+1, l−1] → +l−1
        if abs(mp) < l:
            return r1[..., i + 1, 1] * Rp[..., mu + l - 1, mp + l - 1]
        if mp == l:
            return (
                r1[..., i + 1, 2] * Rp[..., mu + l - 1, (l - 1) + (l - 1)]
                - r1[..., i + 1, 0] * Rp[..., mu + l - 1, (-l + 1) + (l - 1)]
            )
        # mp == −l
        return (
            r1[..., i + 1, 2] * Rp[..., mu + l - 1, (-l + 1) + (l - 1)]
            + r1[..., i + 1, 0] * Rp[..., mu + l - 1, (l - 1) + (l - 1)]
        )

    for l in range(2, l_max + 1):
        Rp = D[l - 1]
        rows = []
        for m in range(-l, l + 1):
            row = []
            for mp in range(-l, l + 1):
                denom = float((l + mp) * (l - mp)) if abs(mp) < l else float(2 * l * (2 * l - 1))
                # --- u coefficient & U term
                u2 = (l + m) * (l - m) / denom
                val = torch.zeros(batch, dtype=R.dtype, device=R.device)
                if u2 > 0:
                    val = val + (u2 ** 0.5) * P(0, l, m, mp, Rp)
                # --- v coefficient & V term
                d_m0 = 1.0 if m == 0 else 0.0
                v2 = (1.0 + d_m0) * (l + abs(m) - 1) * (l + abs(m)) / denom
                if v2 > 0:
                    v = 0.5 * (v2 ** 0.5) * (1.0 - 2.0 * d_m0)
                    if m == 0:
                        V = P(1, l, 1, mp, Rp) + P(-1, l, -1, mp, Rp)
                    elif m > 0:
                        d_m1 = 1.0 if m == 1 else 0.0
                        V = P(1, l, m - 1, mp, Rp) * ((1.0 + d_m1) ** 0.5)
                        if m != 1:
                            V = V - P(-1, l, -m + 1, mp, Rp)
                    else:
                        d_m1 = 1.0 if m == -1 else 0.0
                        V = P(-1, l, -m - 1, mp, Rp) * ((1.0 + d_m1) ** 0.5)
                        if m != -1:
                            V = V + P(1, l, m + 1, mp, Rp)
                    val = val + v * V
                # --- w coefficient & W term
                w2 = (l - abs(m) - 1) * (l - abs(m)) / denom
                if w2 > 0 and m != 0:
                    w = -0.5 * (w2 ** 0.5)
                    if m > 0:
                        W = P(1, l, m + 1, mp, Rp) + P(-1, l, -m - 1, mp, Rp)
                    else:
                        W = P(1, l, m - 1, mp, Rp) - P(-1, l, -m + 1, mp, Rp)
                    val = val + w * W
                row.append(val)
            rows.append(torch.stack(row, dim=-1))
        D.append(torch.stack(rows, dim=-2))
    return D


def sh_block_slices(l_max: int) -> list[tuple[int, int]]:
    """(start, size) of each l-block in the flattened (l_max+1)² SH axis."""
    return [(l * l, 2 * l + 1) for l in range(l_max + 1)]


def block_diag_apply(D: list[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply per-l rotations to flattened features x: (..., K, C), K=(l_max+1)²."""
    return torch.cat([Dl @ x[..., l * l: l * l + 2 * l + 1, :] for l, Dl in enumerate(D)], dim=-2)


def block_diag_apply_T(D: list[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply the inverse (transpose) rotations."""
    return torch.cat([Dl.transpose(-1, -2) @ x[..., l * l: l * l + 2 * l + 1, :] for l, Dl in enumerate(D)],
                     dim=-2)
