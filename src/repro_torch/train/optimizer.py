"""Optimizers from scratch (no `torch.optim`): SGD(+momentum), Adam, AdamW,
LAMB — twin of `repro.train.optimizer`, with the reference's formulas term
for term so that trajectories compare step by step.

Functional interface over trees of tensors (`repro_torch.train.tree`):
    opt = adamw(lr=3e-4, weight_decay=0.1)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

State mirrors params (+ a scalar int32 step), so it checkpoints like the
params themselves — and on a rank of the sharded LM or DeepFM it mirrors
the rank's shards (the reference cells' ``_opt_specs``: m and v take the
parameters' specs, the step is replicated). `data_parallel` wraps an
optimizer for such a rank: each gradient leaf is summed over the data
group before the update (the sharded losses already carry 1/n_data:
each rank's gradient is its share of the global batch's mean). LAMB's
trust ratio needs the norm of the whole leaf, so `data_parallel` refuses
it for a tree with leaves split over the model group. Updates return new tensors and leave their inputs alone.
Adam and AdamW make the moments and the new parameter one leaf at a time,
so a step never holds a whole tree of updates: the largest LM trained on
one card (gemma3-12b's widths, 9.3 GB of parameters) needs that headroom.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["Optimizer", "sgd", "adam", "adamw", "lamb", "data_parallel"]

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


def _adam_leafwise(grads, state, params, b1, b2, eps, new_param, donate: bool = False):
    """Adam's moments and ``new_param(p, update)`` leaf by leaf, the
    reference's formulas term for term: each leaf's update lives only while
    its new parameter is made. With ``donate`` the new moments and parameter
    are written into the old tensors (the reference cells'
    ``donate_argnums``): a step then holds one leaf's new values at a
    time, not a second copy of the parameters and moments."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1, c2 = 1 - b1**t, 1 - b2**t
    new_m, new_v, new_p = [], [], []
    for g, m, v, p in zip(*(tree_leaves(x) for x in (grads, state["m"], state["v"], params)), strict=True):
        if p is None:
            new_m.append(None), new_v.append(None), new_p.append(None)
            continue
        m_old, v_old = m, v
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        q = new_param(p, (m / c1) / (torch.sqrt(v / c2) + eps))
        if donate:
            m, v, q = m_old.copy_(m), v_old.copy_(v), p.copy_(q)
        new_m.append(m), new_v.append(v)
        new_p.append(q)
    return tree_unflatten(params, new_p), {"m": tree_unflatten(state["m"], new_m),
                                           "v": tree_unflatten(state["v"], new_v), "step": step}


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         donate: bool = False) -> Optimizer:
    """``donate``: update the parameters and moments in place (see
    `_adam_leafwise`); the inputs are then the outputs."""
    def init(params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params), "step": _step0(params)}

    def update(grads, state, params):
        return _adam_leafwise(grads, state, params, b1, b2, eps, lambda p, u: p - lr * u, donate)

    return Optimizer(init, update, "adam")


def adamw(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 0.01, donate: bool = False,
) -> Optimizer:
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        return _adam_leafwise(grads, state, params, b1, b2, eps, lambda p, u: p - lr * (u + weight_decay * p),
                              donate)

    return Optimizer(base.init, update, "adamw")


def lamb(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
    weight_decay: float = 0.01,
) -> Optimizer:
    """Layer-wise adaptive moments (large-batch training)."""
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        def apply(p, u):
            u = u + weight_decay * p
            pn = torch.linalg.vector_norm(p.reshape(-1))
            un = torch.linalg.vector_norm(u.reshape(-1))
            trust = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
            return p - lr * trust * u

        return _adam_leafwise(grads, state, params, b1, b2, eps, apply)

    return Optimizer(base.init, update, "lamb")


def data_parallel(opt: Optimizer, policy, specs: Tree | None = None) -> Optimizer:
    """``opt`` on one rank of a grid policy (bound): the update first sums
    every gradient leaf over the data group. ``specs`` are the parameters'
    specs (`repro_torch.launch.shardings`); LAMB is refused where a leaf
    splits over the model group."""
    if opt.name == "lamb" and specs is not None and "model" in tree_leaves(specs):   # specs flatten to axis names
        raise NotImplementedError("LAMB's trust ratio needs each leaf's whole norm: it does not run on "
                                  "leaves split over the model group")
    if policy.n_data == 1:
        return opt

    def update(grads, state, params):
        grads = tree_map(lambda g: policy.data_psum(g.detach()), grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, opt.name)
