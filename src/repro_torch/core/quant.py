"""Fake quantization of weights and activations (paper §V-B, Fig. 7).

Twin of `repro.core.quant`: symmetric per-tensor fake quantization with a
straight-through estimator (per tensor, or over every tensor of a
parameter tree), and the wire payload codecs of the halo exchange
(`repro_torch.dist.halo`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import fake_quant as fq_kernel
from repro_torch.obs import trace as _obs_trace
from repro_torch.train.tree import tree_map

__all__ = [
    "QuantConfig",
    "PAYLOAD_BITS",
    "fake_quant",
    "quantize_tree",
    "payload_bits",
    "quantize_payload",
    "dequantize_payload",
]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    weight_bits: int = 4
    act_bits: int = 4
    enabled: bool = True
    act_percentile: float | None = 99.9   # clip activation outliers (QAT)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


class _FakeQuant(torch.autograd.Function):
    """The kernel forward, the straight-through backward (identity)."""

    @staticmethod
    def forward(ctx, x, bits, percentile):
        return fq_kernel.fake_quant(x, bits, percentile)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, bits: int, percentile: float | None = None) -> torch.Tensor:
    """Symmetric per-tensor fake quantization with a straight-through grad.

    bits ≥ 32 (or ≤ 0) is a no-op. The scale is amax-based by default;
    ``percentile`` takes the nearest-rank percentile of the magnitudes
    instead: the ceil(p·n/100)-th smallest, i.e. the
    (n − ceil(p·n/100) + 1)-th largest. The calibration statistic carries
    no gradient. Rounding is half-to-even and the clip is [-qmax-1, qmax],
    as in the reference. CUDA tensors (fp32, bf16) take the hand-written
    kernels (`repro_torch.kernels.fake_quant`: an exact radix select, then
    one quantize pass), which give the same bits as the PyTorch ops there;
    CPU and meta tensors take the ops (`fake_quant_plain`, with `torch.topk`).
    """
    if bits >= 32 or bits <= 0:
        return x
    with _obs_trace.span("quant.fake_quant"):
        if x.device.type == "cuda":
            return _FakeQuant.apply(x, bits, percentile)
        return fq_kernel.fake_quant_plain(x, bits, percentile)


def quantize_tree(params: Any, bits: int, percentile: float | None = None) -> Any:
    """Fake-quantize every floating tensor of a parameter tree (a nested
    dict, list or tuple); every other leaf is returned as it is.
    ``percentile`` reaches every leaf's calibration."""
    def leaf(p):
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            return fake_quant(p, bits, percentile=percentile)
        return p

    return tree_map(leaf, params)


# --------------------------------------------------------- halo wire payloads
# Wire formats for the halo exchange: the export block is encoded before the
# collective and decoded on receive, so only the compressed representation
# crosses the wire. Unlike fake_quant (QAT emulation in fp32), these change
# the transferred dtype.
PAYLOAD_BITS = {None: 32, "fp32": 32, "bf16": 16, "int8": 8}


def payload_bits(payload: str | None) -> int:
    """Wire bits per element for a halo payload format."""
    try:
        return PAYLOAD_BITS[payload]
    except KeyError:
        raise ValueError(
            f"unknown halo payload {payload!r}; expected one of "
            "None/'fp32', 'bf16', 'int8'"
        ) from None


def quantize_payload(
    x: torch.Tensor, payload: str | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Encode an export block for the wire. Returns ``(wire, scale)``.

    * ``None``/``"fp32"`` — identity, scale None.
    * ``"bf16"``          — bfloat16 cast (round to nearest even), scale None.
    * ``"int8"``          — symmetric per-export-block scale (amax/127); the
                            (1, 1) fp32 scale travels alongside the payload so
                            the receiver can decode every sender's block.
    """
    if payload in (None, "fp32") or x.shape[0] == 0:
        return x, None
    if payload == "bf16":
        return x.to(torch.bfloat16), None
    if payload == "int8":
        amax = x.abs().max()
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).float()
        # The division runs in the promoted type (fp32 for bf16 input), as
        # JAX promotes x / scale: torch would keep a dimensioned bf16 x
        # against the 0-dim fp32 scale in bf16.
        q = torch.clamp(torch.round(x.to(torch.promote_types(x.dtype, scale.dtype)) / scale), -127, 127)
        q = q.to(torch.int8)
        return q, scale.reshape(1, 1)
    payload_bits(payload)  # raises the canonical error
    raise AssertionError  # pragma: no cover


def dequantize_payload(
    wire: torch.Tensor, scale: torch.Tensor | None, dtype=torch.float32
) -> torch.Tensor:
    """Decode gathered wire rows back to ``dtype``.

    For int8, ``scale`` holds one row per gathered export block — shape
    (n_blocks, 1) against wire (n_blocks·s, ...) — and each block is
    rescaled by its sender's amax/127. The wire's trailing shape is kept:
    an (n_blocks·s, K, C) table (EquiformerV2's irreps) decodes to that
    shape, where the reference's reshape to (rows, -1) would flatten it.
    """
    if scale is None:
        return wire.to(dtype)
    n_blocks = scale.shape[0]
    rows = wire.shape[0]
    if n_blocks > 1 and rows:
        per = rows // n_blocks
        return (wire.to(dtype).reshape(n_blocks, per, -1) * scale[:, :, None]).reshape(wire.shape)
    return wire.to(dtype) * scale[0]
