"""Optimizers from scratch (no `torch.optim`): SGD(+momentum), Adam, AdamW,
LAMB — twin of `repro.train.optimizer`, with the reference's formulas term
for term so that trajectories compare step by step.

Functional interface over trees of tensors (`repro_torch.train.tree`):
    opt = adamw(lr=3e-4, weight_decay=0.1)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

State mirrors params (+ a scalar int32 step), so it checkpoints like the
params themselves. Updates return new tensors and leave their inputs alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "adam", "adamw", "lamb"]

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]]
    name: str = "opt"


def _zeros_like_tree(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


def _step0(params: Tree) -> torch.Tensor:
    """The scalar step counter, on the device of the first parameter."""
    device = next((p.device for p in tree_leaves(params) if isinstance(p, torch.Tensor)), None)
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float = 1e-2, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_tree(params) if momentum else None, "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            eff = tree_map(lambda m, g: momentum * m + g, mu, grads) if nesterov else mu
            new_params = tree_map(lambda p, m: p - lr * m, params, eff)
            return new_params, {"mu": mu, "step": step}
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, {"mu": None, "step": step}

    return Optimizer(init, update, "sgd")


def _adam_core(grads, state, b1, b2, eps):
    step = state["step"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
    t = step.to(torch.float32)
    c1, c2 = 1 - b1**t, 1 - b2**t
    upd = tree_map(lambda mm, vv: (mm / c1) / (torch.sqrt(vv / c2) + eps), m, v)
    return upd, {"m": m, "v": v, "step": step}


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params), "step": _step0(params)}

    def update(grads, state, params):
        upd, new_state = _adam_core(grads, state, b1, b2, eps)
        new_params = tree_map(lambda p, u: p - lr * u, params, upd)
        return new_params, new_state

    return Optimizer(init, update, "adam")


def adamw(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> Optimizer:
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        upd, new_state = _adam_core(grads, state, b1, b2, eps)
        new_params = tree_map(lambda p, u: p - lr * (u + weight_decay * p), params, upd)
        return new_params, new_state

    return Optimizer(base.init, update, "adamw")


def lamb(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
    weight_decay: float = 0.01,
) -> Optimizer:
    """Layer-wise adaptive moments (large-batch training)."""
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        upd, new_state = _adam_core(grads, state, b1, b2, eps)

        def apply(p, u):
            u = u + weight_decay * p
            pn = torch.linalg.vector_norm(p.reshape(-1))
            un = torch.linalg.vector_norm(u.reshape(-1))
            trust = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
            return p - lr * trust * u

        return tree_map(apply, params, upd), new_state

    return Optimizer(base.init, update, "lamb")
