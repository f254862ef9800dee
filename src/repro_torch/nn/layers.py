"""Basic layers: linear, norms, MLPs — functional style over dicts of
tensors; twin of `repro.nn.layers`.

Initializers draw from an explicit `torch.Generator`, on the generator's
own device (so a seed gives the same numbers wherever the parameters go),
then move the result to ``device``: ``None`` is the CUDA card, and raises
without one (`repro_torch.device.resolve_device`). The generator's numbers
are not JAX's: to compute what the reference computes, carry its
parameters across as numpy.

A model describes its parameters once, as a plan: a dict tree of `Draw`
leaves (shape, scale, and the blocks a seeded draw takes one at a time).
`init_tree` draws a plan from a generator; `repro_torch.launch.steps.
draw_tree` draws the same plan block by block from seeds, so that a rank
of a sharded cell draws only its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.train.tree import tree_map

__all__ = [
    "Draw",
    "init_tree",
    "dense_init",
    "dense_plan",
    "params_from_numpy",
    "linear",
    "rms_norm",
    "layer_norm",
    "mlp_plan",
    "mlp_apply",
    "gelu",
    "silu",
]


def normal(generator: torch.Generator, shape: tuple[int, ...], dtype=torch.float32,
           device: str | torch.device | None = None) -> torch.Tensor:
    """Standard normal draws on ``generator``'s device, moved to ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device).to(
        resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Draw:
    """One leaf of a parameter plan: ``kind`` ``normal`` (× ``std``),
    ``ones`` or ``zeros``; ``units``, the blocks along each axis that a
    seeded draw (`repro_torch.launch.steps.draw_tree`) takes one at a time,
    each from a seed of its own (one block per axis by default)."""

    shape: tuple[int, ...]
    kind: str = "normal"
    std: float = 1.0
    units: tuple[int, ...] | None = None


def init_tree(generator: torch.Generator, plan: dict, dtype=torch.float32,
              device: str | torch.device | None = None) -> dict:
    """The parameters ``plan`` describes, every normal leaf drawn whole from
    ``generator`` in the plan's order."""
    device = resolve_device(device)

    def walk(p):
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if p.kind == "normal":
            return normal(generator, p.shape, dtype, device).mul_(p.std)
        return (torch.ones if p.kind == "ones" else torch.zeros)(p.shape, dtype=dtype, device=device)

    return walk(plan)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, scale: str | float = "fan_in",
               dtype=torch.float32, device: str | torch.device | None = None) -> dict:
    if scale == "fan_in":
        std = (1.0 / d_in) ** 0.5
    elif scale == "fan_avg":
        std = (2.0 / (d_in + d_out)) ** 0.5
    else:
        std = float(scale)
    w = normal(generator, (d_in, d_out), dtype, device) * std
    return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=w.device)}


def dense_plan(d_in: int, d_out: int) -> dict:
    """One linear layer as a plan: `dense_init`'s fan-in scale, zero bias."""
    return {"w": Draw((d_in, d_out), std=(1.0 / d_in) ** 0.5), "b": Draw((d_out,), "zeros")}


def params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """A tree of the reference's parameters (numpy or JAX arrays) as tensors
    on ``device``, so that both packages compute the same thing."""
    device = resolve_device(device)
    return tree_map(lambda v: torch.from_numpy(np.array(v)).to(device), params)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def mlp_plan(dims: list[int]) -> dict:
    """Linear layers ``l0 … l{n-1}`` (`dense_init`'s fan-in scale, zero
    biases) as a plan."""
    return {f"l{i}": dense_plan(dims[i], dims[i + 1]) for i in range(len(dims) - 1)}


def mlp_apply(p: dict, x: torch.Tensor, act: Callable = silu, final_act: bool = False) -> torch.Tensor:
    """Linear layers ``l0 … l{n-1}`` with ``act`` (SiLU by default) between
    them, and after the last only when ``final_act``."""
    n = len(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x
