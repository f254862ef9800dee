"""Cell builder: (arch × shape × grid) → one rank's step function and
inputs — twin of `repro.launch.steps` for the LM and recsys families.

The reference's `build_cell` returns a function and the shardings that
``jax.jit`` lowers over a mesh. Here the grid is run by a
`torch.distributed` group (`repro_torch.launch.mesh.run_group`) with one
process per rank, so a `Cell` is what one rank runs:

* ``fn`` — the step on the rank's shards (after `Cell.bind`, which binds
  the policy to the rank's data and model groups); a train step updates
  its parameters and optimizer state in place (the reference's cells
  donate them, ``donate_argnums=(0, 1)``), so a caller rebinds both from
  its output;
* ``make_inputs(seed, device)`` — the rank's arguments of ``fn``:
  parameters drawn block by block (`draw_tree` over the model's plan,
  `lm_param_plan` / `deepfm_param_plan`: every stacked leaf per layer —
  and per expert —, the vocab and table leaves per row block, each block
  from a seed of its own, so that a rank draws only the blocks its shard
  touches and an unsharded cell draws the same numbers), the optimizer
  state, and the batch of its data shard (`token_batch_fn` /
  `click_batch_fn` from the seed, cut by the batch spec);
* the reference's specs (`repro_torch.launch.shardings`) for the
  parameters, the inputs and the outputs, and ``model_flops`` (the
  reference's formulas).

Step kinds per family (the reference's):
  lm/train      — loss + grads + AdamW update        (train_step)
  lm/prefill    — last-position logits               (serve_step)
  lm/decode     — one token against the KV cache     (serve_step)
  recsys/train  — BCE loss + grads + AdamW
  recsys/serve  — batched logits
  recsys/retrieval — 1×N candidate scoring

A caller may pass a `ShapeSpec` cut in ``global_batch``, ``seq_len`` or
``batch`` (and an `ArchSpec` whose config is cut in depth), never in
width. The GNN cells come later (ROADMAP.md queue 1 item 2): `build_cell`
raises for them; their loss, `_gnn_loss_fn`, is here already, and the
training CLI and ``chip_smoke.py`` train through it. The reference's
``Cell.lower``, ``cost_cells`` and the dry run's cost extrapolation are
not here either.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.registry import ArchSpec, ShapeSpec
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Grid, data_axes
from repro_torch.nn.layers import Draw

__all__ = ["Cell", "build_cell", "draw_tree"]

BF16 = torch.bfloat16
F32 = torch.float32


# ------------------------------------------------------------- drawn weights
def _unit_seed(seed: int, path: str, idx: tuple) -> int:
    return (seed * 1_000_003 + zlib.crc32(f"{path}:{idx}".encode())) % (2**63)


def draw_leaf(seed: int, path: str, d: Draw, dtype, device, block: tuple[slice, ...] | None = None) -> torch.Tensor:
    """The ``block`` of the leaf ``path`` (all of it by default): each of the
    leaf's ``units`` the block touches is drawn whole from its own seed on
    ``device`` and the overlap copied."""
    block = block or tuple(slice(0, n) for n in d.shape)
    out_shape = tuple(s.stop - s.start for s in block)
    if d.kind != "normal":
        return (torch.ones if d.kind == "ones" else torch.zeros)(out_shape, dtype=dtype, device=device)
    units = d.units or (1,) * len(d.shape)
    size = tuple(n // u for n, u in zip(d.shape, units, strict=True))
    out = torch.empty(out_shape, dtype=dtype, device=device)
    ranges = [range(s.start // z, (s.stop - 1) // z + 1) for s, z in zip(block, size)]
    for idx in itertools.product(*ranges):
        gen = torch.Generator(device=device).manual_seed(_unit_seed(seed, path, idx))
        unit = torch.randn(size, generator=gen, dtype=dtype, device=device).mul_(d.std)
        src, dst = [], []
        for i, s, z in zip(idx, block, size):
            lo, hi = max(s.start, i * z), min(s.stop, (i + 1) * z)
            src.append(slice(lo - i * z, hi - i * z))
            dst.append(slice(lo - s.start, hi - s.start))
        out[tuple(dst)] = unit[tuple(src)]
        del unit
    return out


def draw_tree(seed: int, plan: Any, dtype, device, specs: Any = None, coords: dict | None = None) -> Any:
    """The parameters ``plan`` describes, drawn block by block; with
    ``specs`` and ``coords`` only the rank's shard of each leaf (equal to
    `shard_tree` of the whole tree)."""
    def walk(p, s, path):
        if isinstance(p, dict):
            return {k: walk(p[k], None if s is None else s[k], f"{path}/{k}") for k in sorted(p)}
        block = None if s is None else sh.shard_slices(p.shape, s, coords or {})
        return draw_leaf(seed, path, p, dtype, device, block)

    return walk(plan, specs, "")


# ---------------------------------------------------------------------- cell
@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                    # "train_step" | "serve_step" (the reference's)
    shape: ShapeSpec
    cfg: Any
    policy: Any                  # the grid policy; bound to a rank by `bind`
    make_fn: Callable            # policy → the step function
    make_rank_inputs: Callable   # (cell, seed, device, params) → the rank's arguments
    model_flops: float           # 6·N·D-style useful-FLOPs estimate (the reference's)
    param_specs: Any
    in_specs: tuple
    out_specs: Any
    note: str = ""

    @property
    def grid(self) -> Grid:
        return self.policy.grid

    def bind(self) -> "Cell":
        """This cell on the calling rank: the policy bound to its groups."""
        return dataclasses.replace(self, policy=self.policy.bind())

    @property
    def fn(self) -> Callable:
        return self.make_fn(self.policy)

    @property
    def rank(self) -> int:
        return self.policy.data_index * self.policy.n_model + self.policy.model_index

    @property
    def coords(self) -> dict:
        return self.grid.coords(self.rank)

    def make_inputs(self, seed: int, device, params: Any = None) -> tuple:
        """The rank's arguments of ``fn``, made from ``seed``; ``params``, when
        given, are used instead of drawing them (another cell of the same
        model on the same grid drew them)."""
        return self.make_rank_inputs(self, seed, torch.device(device), params)

    def cut(self, array, spec_entries: tuple):
        """The rank's block of a whole (numpy or torch) array under a spec."""
        return array[sh.shard_slices(array.shape, spec_entries, self.coords)]


def _n_data(grid: Grid) -> int:
    return math.prod(grid.shape.get(a, 1) for a in data_axes(grid))


def _draw_params(cell: Cell, plan, dtype, seed: int, device, params=None):
    return params if params is not None else draw_tree(seed, plan, dtype, device, cell.param_specs, cell.coords)


# ========================================================================= LM
def _lm_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, dtype) -> Cell:
    from repro_torch.models.transformer_lm import lm_decode_step, lm_loss, lm_param_plan, lm_prefill
    from repro_torch.train.data import token_batch_fn
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw, data_parallel

    cfg = spec.make_config(shape)
    da = data_axes(grid)
    policy = sh.lm_policy(grid, cfg)
    plan = lm_param_plan(cfg)
    p_specs = sh.lm_param_specs(plan, cfg, grid)
    common = dict(arch_id=spec.arch_id, shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs)

    def tokens(cell, seed, device, seq, spec_entries):
        whole = token_batch_fn(cfg.vocab, seq)(np.random.default_rng(seed), shape.global_batch)
        return torch.from_numpy(np.ascontiguousarray(cell.cut(whole, spec_entries))).to(device, torch.int64)

    if shape.kind == "train":
        def make_fn(policy):
            opt = data_parallel(adamw(lr=3e-4, donate=True), policy, p_specs)

            def train_step(params, opt_state, toks):
                loss, grads = value_and_grad(lambda p, b: lm_loss(p, b, cfg, policy), params, toks)
                new_params, new_opt = opt.update(grads, opt_state, params)
                return new_params, new_opt, loss
            return train_step

        def inputs(cell, seed, device, params):
            params = _draw_params(cell, plan, dtype, seed, device, params)
            return params, adamw(lr=3e-4).init(params), tokens(cell, seed + 1, device, shape.seq_len, sh.spec(da, None))

        return Cell(kind="train_step", policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                    model_flops=6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len,
                    in_specs=(p_specs, {"m": p_specs, "v": p_specs, "step": ()}, sh.spec(da, None)),
                    out_specs=(p_specs, {"m": p_specs, "v": p_specs, "step": ()}, ()), **common)

    if shape.kind == "prefill":
        def make_fn(policy):
            return lambda params, toks: lm_prefill(params, toks, cfg, policy)

        def inputs(cell, seed, device, params):
            toks = tokens(cell, seed + 1, device, shape.seq_len, sh.spec(da, None))[:, :shape.seq_len]
            return _draw_params(cell, plan, dtype, seed, device, params), toks

        return Cell(kind="serve_step", policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                    model_flops=2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len,
                    in_specs=(p_specs, sh.spec(da, None)), out_specs=sh.spec(da, "model"), **common)

    # decode: one new token with a KV cache of seq_len.
    cspec = sh.cache_spec(cfg, shape, grid)
    policy = dataclasses.replace(policy, cache=cspec)
    n_data = _n_data(grid)
    tok_spec = sh.spec(da) if shape.global_batch % n_data == 0 and shape.global_batch >= n_data else sh.spec(None)
    hd = cfg.attn.head_dim
    # The cache drawn per (layer, row): (L, B, S, Hk, Dh) with a unit scale, as keys and values of a prefill.
    cache_plan = Draw((cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv_heads, hd),
                      units=(cfg.n_layers, shape.global_batch, 1, 1, 1))

    def make_fn(policy):
        return lambda params, cache, token, pos: lm_decode_step(params, cache, token, pos, cfg, policy)

    def inputs(cell, seed, device, params):
        params = _draw_params(cell, plan, dtype, seed, device, params)
        block = sh.shard_slices(cache_plan.shape, cspec, cell.coords)
        cache = {name: draw_leaf(seed + 2, f"/cache/{name}", cache_plan, dtype, device, block) for name in ("k", "v")}
        whole = np.random.default_rng(seed + 1).integers(0, cfg.vocab, shape.global_batch).astype(np.int64)
        token = torch.from_numpy(np.ascontiguousarray(cell.cut(whole, tok_spec))).to(device)
        return params, cache, token, shape.seq_len // 2 - 4

    return Cell(kind="serve_step", policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                model_flops=2.0 * cfg.active_param_count() * shape.global_batch,
                in_specs=(p_specs, {"k": cspec, "v": cspec}, tok_spec, ()),
                out_specs=(sh.spec(tok_spec[0], "model"), {"k": cspec, "v": cspec}),
                note=f"KV cache {shape.seq_len} tokens, spec {cspec}", **common)


# ===================================================================== recsys
def _recsys_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, dtype) -> Cell:
    from repro_torch.models.deepfm import deepfm_forward, deepfm_loss, deepfm_param_plan, deepfm_retrieval
    from repro_torch.train.data import click_batch_fn
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw, data_parallel

    cfg = spec.make_config(shape)
    da = data_axes(grid)
    policy = sh.recsys_policy(grid)
    plan = deepfm_param_plan(cfg)
    p_specs = sh.recsys_param_specs(plan)
    common = dict(arch_id=spec.arch_id, shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs)
    mlp_flops = 2.0 * sum(a * b for a, b in zip((cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims), (*cfg.mlp_dims, 1)))
    per_ex = mlp_flops + 4.0 * cfg.n_fields * cfg.embed_dim

    def clicks(cell, seed, device, batch_spec):
        whole = click_batch_fn(cfg.n_fields, cfg.rows_per_field)(np.random.default_rng(seed), shape.batch)
        ids = cell.cut(whole["ids"], batch_spec + (None,))
        labels = cell.cut(whole["labels"], batch_spec)
        return (torch.from_numpy(np.ascontiguousarray(ids)).to(device, torch.int64),
                torch.from_numpy(np.ascontiguousarray(labels)).to(device))

    if shape.kind == "train":
        def make_fn(policy):
            opt = data_parallel(adamw(lr=1e-3, donate=True), policy, p_specs)

            def train_step(params, opt_state, ids, labels):
                loss, grads = value_and_grad(lambda p, b: deepfm_loss(p, b[0], b[1], cfg, policy), params,
                                             (ids, labels))
                new_params, new_opt = opt.update(grads, opt_state, params)
                return new_params, new_opt, loss
            return train_step

        def inputs(cell, seed, device, params):
            params = _draw_params(cell, plan, dtype, seed, device, params)
            return (params, adamw(lr=1e-3).init(params), *clicks(cell, seed + 1, device, sh.spec(da)))

        return Cell(kind="train_step", policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                    model_flops=3.0 * per_ex * shape.batch,
                    in_specs=(p_specs, {"m": p_specs, "v": p_specs, "step": ()}, sh.spec(da, None), sh.spec(da)),
                    out_specs=(p_specs, {"m": p_specs, "v": p_specs, "step": ()}, ()), **common)

    if shape.kind == "retrieval":
        def make_fn(policy):
            return lambda params, user, cands: deepfm_retrieval(params, user, cands, cfg, policy)

        def inputs(cell, seed, device, params):
            rng = np.random.default_rng(seed + 1)
            user = click_batch_fn(cfg.n_fields, cfg.rows_per_field)(rng, shape.batch)["ids"]
            cands = rng.integers(0, cfg.rows_per_field, (shape.batch, shape.n_candidates))
            cands = cell.cut(cands, sh.spec(None, "model"))
            return (_draw_params(cell, plan, dtype, seed, device, params), torch.from_numpy(user).to(device, torch.int64),
                    torch.from_numpy(np.ascontiguousarray(cands)).to(device, torch.int64))

        return Cell(kind="serve_step", policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                    model_flops=2.0 * shape.batch * shape.n_candidates * cfg.d_tower,
                    in_specs=(p_specs, sh.spec(None, None), sh.spec(None, "model")),
                    out_specs=sh.spec(None, "model"), **common)

    big = shape.batch >= _n_data(grid)
    bspec = sh.spec(da) if big else sh.spec(None)

    def make_fn(policy):
        return lambda params, ids: deepfm_forward(params, ids, cfg, policy)

    def inputs(cell, seed, device, params):
        return _draw_params(cell, plan, dtype, seed, device, params), clicks(cell, seed + 1, device, bspec)[0]

    return Cell(kind="serve_step", policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                model_flops=per_ex * shape.batch, in_specs=(p_specs, bspec + (None,)), out_specs=bspec, **common)


# ======================================================================== GNN
def _gnn_loss_fn(arch_id: str, cfg, policy=None, n_loss_nodes: int | None = None) -> Callable:
    """The reference's regression loss over a GNN's output (``loss(params,
    batch)``), sliced to the first ``n_loss_nodes`` rows for sampled
    blocks — losses are computed on the seed nodes only; ``coin_gcn`` is
    `gcn_loss`. ``batch`` holds ``feats``, ``senders``, ``receivers``
    and ``target`` (``pos`` for egnn, ``edge_feats`` for graphcast;
    ``edge_weight``, ``labels`` and ``label_mask`` for coin_gcn); an
    ``edge_mask`` entry, when present, goes to the forward (padding edges
    of a block; the reference's batches have none)."""
    from repro_torch.dist.policy import NO_POLICY

    policy = NO_POLICY if policy is None else policy

    def _mse(pred, target):
        if n_loss_nodes is not None:
            pred = pred[:n_loss_nodes]
        return (pred - target).square().mean()

    if arch_id == "egnn":
        from repro_torch.models.egnn import egnn_forward

        def loss(params, batch):
            pred, _ = egnn_forward(params, batch["feats"], batch["pos"], batch["senders"], batch["receivers"],
                                   cfg, policy, edge_mask=batch.get("edge_mask"))
            return _mse(pred, batch["target"])
    elif arch_id == "graphcast":
        from repro_torch.models.graphcast import graphcast_forward

        def loss(params, batch):
            pred = graphcast_forward(params, batch["feats"], batch["edge_feats"], batch["senders"],
                                     batch["receivers"], cfg, policy, edge_mask=batch.get("edge_mask"))
            return _mse(pred, batch["target"])
    elif arch_id == "pna":
        from repro_torch.models.pna import pna_forward

        def loss(params, batch):
            pred = pna_forward(params, batch["feats"], batch["senders"], batch["receivers"], cfg, policy,
                               edge_mask=batch.get("edge_mask"))
            return _mse(pred, batch["target"])
    elif arch_id == "coin_gcn":
        from repro_torch.models.gcn import gcn_loss

        def loss(params, batch):
            return gcn_loss(params, batch["feats"], batch["senders"], batch["receivers"], batch["edge_weight"],
                            batch["labels"], batch["label_mask"], cfg, policy)
    elif arch_id == "equiformer-v2":
        raise NotImplementedError("equiformer-v2's loss comes with the equiformer-v2 slice "
                                  "(models/equiformer_v2.py, nn/so3.py)")
    else:
        raise KeyError(arch_id)
    return loss


# ==================================================================== factory
def build_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, dtype: torch.dtype | None = None) -> Cell:
    """The cell of ``spec`` at ``shape`` on ``grid``; ``dtype`` of the
    parameters (the reference's defaults: bf16 for the LMs, fp32 for
    DeepFM)."""
    if spec.family == "lm":
        return _lm_cell(spec, shape, grid, dtype or BF16)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape, grid, dtype or F32)
    if spec.family == "gnn":
        raise NotImplementedError("the GNN cells come with their own slice of the port (ROADMAP.md queue 1 "
                                  "item 2); their loss is `_gnn_loss_fn`")
    raise KeyError(spec.family)
