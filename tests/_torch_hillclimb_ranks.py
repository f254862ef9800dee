"""The small configurations of tests/test_torch_hillclimb.py and the body of
its 4-rank gloo group.

The spawned ranks import this module by name (the test directory is on
their path), so it imports neither JAX nor `repro`: only torch, numpy and
`repro_torch`. The configurations are the reference's REDUCED ones, cut
the way the JAX side of the test cuts its own: granite with 8 query heads
(its 6 do not split over 4 ranks), gemma3 with 12 layers (two groups of 5
local and 1 global), small LM shapes, and a 600-node graph for pna's
``ogb_products``.
"""
import dataclasses

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.configs.registry import get_arch as _get_arch      # bound before a test patches the registry

SEED = 3
ADAM_B1 = 0.9                     # the cells' AdamW b1
POS = (5, 19)                     # two-stack decode positions: before the first window fills; across a slice edge
LM_CUTS = {"granite-34b": dict(n_heads=8), "gemma3-12b": dict(n_layers=12), "moonshot-v1-16b-a3b": {}}
LM_SHAPES = {"train_4k": dict(kind="train", seq_len=32, global_batch=16),
             "long_500k": dict(kind="decode", seq_len=64, global_batch=1)}
PNA_SHAPE = dict(n_nodes=600, n_edges=2400, d_feat=24, n_out=3)
PNA_MODES = {"fp32": dict(), "bf16_compute": dict(compute_dtype="bfloat16"), "bf16_wire": dict(payload="bf16"),
             "float64": dict(compute_dtype="float64"),
             "float64_bf16_wire": dict(compute_dtype="float64", payload="bf16")}


def small_spec(arch: str):
    """The port's spec of ``arch`` at the test's size."""
    spec = _get_arch(arch)
    if arch in LM_CUTS:
        cfg = dataclasses.replace(spec.make_reduced(), **LM_CUTS[arch])
        shapes = {name: ShapeSpec(name, **kw) for name, kw in LM_SHAPES.items()}
        return dataclasses.replace(spec, make_config=lambda shape=None, c=cfg: c, shapes=shapes)
    shapes = dict(spec.shapes, ogb_products=ShapeSpec("ogb_products", "graph", **PNA_SHAPE))
    return dataclasses.replace(spec, shapes=shapes)


def pna_cell(grid, mode: str):
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.steps import _shape_halo_plan

    spec = small_spec("pna")
    shape = spec.shapes["ogb_products"]
    kw = dict(PNA_MODES[mode])
    if "compute_dtype" in kw:
        kw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    plan = _shape_halo_plan(shape.n_nodes, shape.n_edges, grid.shape["model"])
    return hc._pna_halo_cell(grid, plan, spec.make_config(shape), shape, **kw)


def granite_cell(grid):
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.steps import build_cell

    spec = small_spec("granite-34b")
    shape = spec.shapes["train_4k"]
    spec_r = dataclasses.replace(spec, make_config=lambda s=None, c=dataclasses.replace(
        spec.make_config(), remat=True): c)
    return hc._granite_accum_cell(build_cell(spec_r, shape, grid))


def gemma_cell(grid, ring: bool, pos: int):
    from repro_torch.launch import hillclimb as hc

    spec = small_spec("gemma3-12b")
    return hc._gemma_twostack_cell(grid, spec, spec.shapes["long_500k"], ring=ring, pos=pos)


def host(tree):
    """Every leaf as fp32 numpy (bf16 has no numpy dtype)."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host(v) for v in tree]
    return tree.detach().float().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def train_step(cell, device) -> dict:
    """One step of a train cell on its seeded inputs: the loss and the
    gradient (AdamW's first moment after one step is (1 − b1)·g)."""
    bound = cell.bind()
    params, opt_state, loss = bound.fn(*bound.make_inputs(SEED, device))
    grads = host(opt_state["m"])
    return dict(loss=float(loss), grads=_scale(grads, 1 / (1 - ADAM_B1)), coords=bound.coords)


def _scale(tree, c):
    return {k: _scale(v, c) for k, v in tree.items()} if isinstance(tree, dict) else tree * c


def decode_step(cell, device) -> dict:
    bound = cell.bind()
    logits, cache = bound.fn(*bound.make_inputs(SEED, device))
    return dict(logits=host(logits), cache=host(cache), coords=bound.coords)


def hill_rank(rank: int, k: int, device: torch.device, grid) -> dict:
    """Every hand-built cell of the port's hillclimb on one rank of ``grid``:
    the PNA halo cell in each mode, t2-b, and both two-stack decodes at
    each of `POS`."""
    out = {f"pna/{mode}": train_step(pna_cell(grid, mode), device) for mode in PNA_MODES}
    out["granite"] = train_step(granite_cell(grid), device)
    for ring in (False, True):
        for pos in POS:
            out[f"gemma/{ring}/{pos}"] = decode_step(gemma_cell(grid, ring, pos), device)
    return out
