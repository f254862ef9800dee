"""Fake quantization of weights and activations (paper §V-B, Fig. 7).

Twin of `repro.core.quant` for the forward path: symmetric per-tensor fake
quantization with a straight-through estimator. The halo wire payload
encoders arrive with the halo slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["QuantConfig", "fake_quant"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    weight_bits: int = 4
    act_bits: int = 4
    enabled: bool = True
    act_percentile: float | None = 99.9   # clip activation outliers (QAT)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


def fake_quant(x: torch.Tensor, bits: int, percentile: float | None = None) -> torch.Tensor:
    """Symmetric per-tensor fake quantization with a straight-through grad.

    bits ≥ 32 (or ≤ 0) is a no-op. The scale is amax-based by default;
    ``percentile`` takes the nearest-rank percentile of the magnitudes
    instead: the ceil(p·n/100)-th smallest, i.e. the
    (n − ceil(p·n/100) + 1)-th largest, found with `torch.topk`. The
    calibration statistic carries no gradient. Rounding is half-to-even and
    the clip is [-qmax-1, qmax], as in the reference.
    """
    if bits >= 32 or bits <= 0:
        return x
    qmax = float(2 ** (bits - 1) - 1)
    mag = x.detach().abs()
    if percentile is None:
        amax = mag.max()
    else:
        flat = mag.reshape(-1)
        n = int(flat.shape[0])
        k = min(n, max(1, n - math.ceil(percentile / 100.0 * n) + 1))
        amax = torch.topk(flat, k).values[-1]
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    # Straight-through estimator: forward q, backward identity.
    return x + (q - x).detach()
