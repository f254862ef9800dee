"""Cell builder: (arch × shape × grid) → one rank's step function and
inputs — twin of `repro.launch.steps`.

The reference's `build_cell` returns a function and the shardings that
``jax.jit`` lowers over a mesh. Here the grid is run by a
`torch.distributed` group (`repro_torch.launch.mesh.run_group`) with one
process per rank, so a `Cell` is what one rank runs:

* ``fn`` — the step on the rank's shards (after `Cell.bind`, which binds
  the policy to the rank's groups); a train step updates its parameters
  and optimizer state in place (the reference's cells donate them,
  ``donate_argnums=(0, 1)``), so a caller rebinds both from its output;
* ``make_inputs(seed, device)`` — the rank's arguments of ``fn``:
  parameters drawn block by block (`draw_tree` over the model's plan,
  `lm_param_plan` / `deepfm_param_plan` / the GNNs' `*_param_plan`: every
  stacked leaf per layer — and per expert —, the vocab and table leaves
  per row block, each block from a seed of its own, so that a rank draws
  only the blocks its shard touches and an unsharded cell draws the same
  numbers), the optimizer state, and the batch of its shard (tokens,
  clicks, or a GNN batch in the plan's layout: the graph's global arrays
  drawn from the seed, then cut to the rank's block);
* ``abstract_inputs()`` — the same arguments as meta tensors of the same
  shapes, drawing nothing: what the dry run (`repro_torch.launch.dryrun`)
  traces a step on;
* the reference's specs (`repro_torch.launch.shardings`) for the
  parameters, the inputs and the outputs, and ``model_flops`` (the
  reference's formulas).

Step kinds per family (the reference's):
  lm/train      — loss + grads + AdamW update        (train_step)
  lm/prefill    — last-position logits               (serve_step)
  lm/decode     — one token against the KV cache     (serve_step)
  gnn/graph     — regression loss + grads + AdamW    (train_step; sampled
                  cells run one block per data shard)
  recsys/train  — BCE loss + grads + AdamW
  recsys/serve  — batched logits
  recsys/retrieval — 1×N candidate scoring

Full-graph GNN cells default to the **halo** schedule: each rank holds one
block of a cached `repro_torch.dist.halo.HaloPlan` of the shape's
deterministic graph (``citation_like(n, e, seed=0)``) and exchanges only
boundary rows a layer; on a grid with a pod axis wider than one the graph
shards over (pod, model) jointly and the exchange turns hierarchical.
``comm="broadcast"`` is the paper's Fig. 5c schedule (a layer's node table
all-gathered over the model group). A GNN cell also carries ``comm``,
``halo_plan``, ``bsr_stats``, ``halo_payload`` and ``halo_overlap``, which
the dry run's `exchange_accounting` reads.

A caller may pass a `ShapeSpec` cut in ``global_batch``, ``seq_len`` or
``batch`` (and an `ArchSpec` whose config is cut in depth), never in
width. The reference's ``Cell.lower``, ``cost_cells`` and the dry run's
cost extrapolation have no counterpart: the port traces every layer (and
every edge chunk of equiformer-v2) eagerly, so no rolled loop body needs
its count corrected.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import zlib
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

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
    if torch.device(device).type == "meta":
        return torch.empty(out_shape, dtype=dtype, device="meta")
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
        if isinstance(p, list):
            return [walk(v, None if s is None else s[i], f"{path}/{i}") for i, v in enumerate(p)]
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
    # GNN full-graph cells: the schedule ("halo" | "broadcast"; None for the
    # other families and the sampled cells), the halo plan whose shapes the
    # batch follows, the blocked tables' statistics (coin_gcn bsr), the wire
    # format and the overlapped schedule — the dry run's exchange
    # accounting reads them.
    comm: str | None = None
    halo_plan: Any = None
    bsr_stats: dict | None = None
    halo_payload: str | None = None
    halo_overlap: bool = False

    @property
    def grid(self) -> Grid:
        return self.policy.grid

    @property
    def graph_rank(self) -> int:
        """This rank's block of a full-graph GNN cell: its index over the
        axes the graph is sharded over (halo: (pod, model) raveled
        pod-major; broadcast: model); 0 in a process alone."""
        if not dist.is_initialized():
            return 0
        c = self.grid.coords(dist.get_rank())
        member, k_model = c["model"]
        if self.comm == "halo" and "pod" in c and c["pod"][1] > 1:
            return c["pod"][0] * k_model + member
        return member

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

    def abstract_inputs(self) -> tuple:
        """The rank's arguments of ``fn`` as meta tensors, of the shapes
        `make_inputs` gives; nothing is drawn."""
        return self.make_rank_inputs(self, 0, torch.device("meta"), None)

    def cut(self, array, spec_entries: tuple):
        """The rank's block of a whole (numpy or torch) array under a spec."""
        return array[sh.shard_slices(array.shape, spec_entries, self.coords)]

    def cut_shape(self, shape: tuple, spec_entries: tuple) -> tuple:
        """The shape of the rank's block of an array of ``shape``."""
        return tuple(s.stop - s.start for s in sh.shard_slices(shape, spec_entries, self.coords))


def _n_data(grid: Grid) -> int:
    return math.prod(grid.shape.get(a, 1) for a in data_axes(grid))


def _draw_params(cell: Cell, plan, dtype, seed: int, device, params=None):
    return params if params is not None else draw_tree(seed, plan, dtype, device, cell.param_specs, cell.coords)


# ========================================================================= LM
def _lm_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, dtype, optimized: bool = False) -> Cell:
    from repro_torch.models.transformer_lm import lm_decode_step, lm_loss, lm_param_plan, lm_prefill
    from repro_torch.train.data import token_batch_fn
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw, data_parallel

    cfg = spec.make_config(shape)
    da = data_axes(grid)
    if optimized:
        # The reference's §Perf findings: hierarchical MoE dispatch, remat on train.
        kw = {"moe_groups": _n_data(grid)} if cfg.is_moe else {}
        if shape.kind == "train":
            kw["remat"] = True
        cfg = dataclasses.replace(cfg, **kw) if kw else cfg
    policy = sh.lm_policy(grid, cfg)
    plan = lm_param_plan(cfg)
    p_specs = sh.lm_param_specs(plan, cfg, grid)
    common = dict(arch_id=spec.arch_id, shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs)

    def tokens(cell, seed, device, seq, spec_entries):
        if device.type == "meta":
            return torch.empty(cell.cut_shape((shape.global_batch, seq + 1), spec_entries), dtype=torch.int64,
                               device=device)
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
        if device.type == "meta":
            token = torch.empty(cell.cut_shape((shape.global_batch,), tok_spec), dtype=torch.int64, device=device)
            return params, cache, token, shape.seq_len // 2 - 4
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
        if device.type == "meta":
            rows = cell.cut_shape((shape.batch,), batch_spec)
            return (torch.empty(rows + (cfg.n_fields,), dtype=torch.int64, device=device),
                    torch.empty(rows, dtype=torch.float32, device=device))
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
            if device.type == "meta":
                cands = cell.cut_shape((shape.batch, shape.n_candidates), sh.spec(None, "model"))
                return (_draw_params(cell, plan, dtype, seed, device, params),
                        torch.empty((shape.batch, cfg.n_fields), dtype=torch.int64, device=device),
                        torch.empty(cands, dtype=torch.int64, device=device))
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
    and ``target`` (``pos`` for egnn and equiformer-v2, ``edge_feats`` for graphcast;
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
        from repro_torch.models.equiformer_v2 import equiformer_forward

        def loss(params, batch):
            pred = equiformer_forward(params, batch["feats"], batch["pos"], batch["senders"], batch["receivers"],
                                      cfg, policy, edge_mask=batch.get("edge_mask"))
            return _mse(pred, batch["target"])
    else:
        raise KeyError(arch_id)
    return loss


# ======================================================================== GNN
def _gnn_params(arch_id: str, cfg) -> dict:
    """The model's parameter plan (`repro_torch.nn.layers.Draw` leaves),
    the reference's ``jax.eval_shape`` of its init: nothing drawn."""
    if arch_id == "pna":
        from repro_torch.models.pna import pna_param_plan

        return pna_param_plan(cfg)
    if arch_id == "egnn":
        from repro_torch.models.egnn import egnn_param_plan

        return egnn_param_plan(cfg)
    if arch_id == "graphcast":
        from repro_torch.models.graphcast import graphcast_param_plan

        return graphcast_param_plan(cfg)
    if arch_id == "coin_gcn":
        from repro_torch.models.gcn import gcn_param_plan

        return gcn_param_plan(cfg)
    if arch_id == "equiformer-v2":
        from repro_torch.models.equiformer_v2 import equiformer_param_plan

        return equiformer_param_plan(cfg)
    raise KeyError(arch_id)


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _gnn_sizes(shape: ShapeSpec, pad_mult: int) -> tuple[int, int]:
    """(nodes, edges) of the device graph: packed for molecule batches,
    fanout-expanded for sampled blocks, padded to the shard divisor."""
    if shape.batch_nodes is not None:       # sampled block
        n, e, frontier = shape.batch_nodes, 0, shape.batch_nodes
        for f in shape.fanout:
            e += frontier * f
            frontier *= f
            n += frontier
    elif shape.n_graphs is not None:        # packed small-graph batch
        n, e = shape.n_nodes * shape.n_graphs, shape.n_edges * shape.n_graphs
    else:                                   # one full graph
        n, e = shape.n_nodes, shape.n_edges
    return _pad_to(n, pad_mult), _pad_to(e, pad_mult)


def _gnn_flops(arch_id: str, shape: ShapeSpec, cfg, bsr_stats: dict | None = None) -> float:
    """Useful forward FLOPs (2 × MACs of the defining matmuls per arch), the
    reference's. ``bsr_stats`` switches the coin_gcn aggregation term to the
    blocked cost model (nnz_blocks·B²·F)."""
    n, e = float(shape.n_nodes), float(shape.n_edges)
    L = cfg.n_layers
    if arch_id == "equiformer-v2":
        C, lmax, mmax = cfg.d_hidden, cfg.l_max, cfg.m_max
        so2 = ((lmax + 1) * C) ** 2 + 2 * sum(2 * ((lmax + 1 - m) * C) ** 2 for m in range(1, mmax + 1))
        rot = 2 * sum((2 * l + 1) ** 2 for l in range(lmax + 1)) * C   # D + Dᵀ apply
        attn = (2 * C + cfg.n_rbf) * C + C * cfg.n_heads
        ffn_n = C * 2 * C + 2 * C * C + lmax * C * C                   # scalar MLP + per-l mix
        return 2.0 * L * (e * (so2 + rot + attn) + n * ffn_n)
    if arch_id == "egnn":
        d = cfg.d_hidden
        per_e = (2 * d + 1) * d + d * d + (d * d + d)                  # φ_e (2-layer) + φ_x
        per_n = 2 * d * d + d * d                                      # φ_h
        return 2.0 * L * (e * per_e + n * per_n)
    if arch_id == "graphcast":
        d = cfg.d_hidden
        per_e = 3 * d * d + d * d
        per_n = 2 * d * d + d * d
        return 2.0 * L * (e * per_e + n * per_n)
    if arch_id == "pna":
        d = cfg.d_hidden
        per_e = 2 * d * d                                              # pre-MLP on (h_i‖h_j)
        per_n = (1 + cfg.n_agg_feats) * d * d                          # post-MLP on 13·d concat
        return 2.0 * L * (e * per_e + n * per_n)
    if arch_id == "coin_gcn":
        from repro_torch.core.dataflow import blocked_multiply_count

        total = 0.0
        for d_in, d_out in zip(cfg.layer_dims[:-1], cfg.layer_dims[1:]):
            if bsr_stats is not None:
                total += blocked_multiply_count(n, bsr_stats["nnz_blocks"], d_in, d_out,
                                                bsr_stats["block"]).feature_first
            else:
                total += n * d_in * d_out + e * d_out                  # feature-first
        return 2.0 * total
    d = getattr(cfg, "d_hidden", 512)
    return 2.0 * L * (n * d * d + e * d)


def _shape_graph(n: int, e: int):
    """The deterministic (n, e) shape-statistics graph of a full-graph cell
    (the reference's ``citation_like(n, e, seed=0)``); memoized."""
    key = (n, e)
    if key not in _SHAPE_GRAPHS:
        from repro_torch.graph.generators import citation_like

        _SHAPE_GRAPHS[key] = citation_like(n, e, seed=0)
    return _SHAPE_GRAPHS[key]


_SHAPE_GRAPHS: dict = {}


def _shape_halo_plan(n: int, e: int, k: int, pods: int = 1):
    """The cached HaloPlan of the (n, e) shape graph over k ranks (``pods >
    1``: the hierarchical (pod, model) plan), partitioned with the
    locality-seeking BFS + refine, under the reference's cache key."""
    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.halo import build_halo_plan, cached_halo_plan

    axes = ("pod", "model") if pods > 1 else ("model",)

    def build():
        g = _shape_graph(n, e)
        part = partition_graph(n, g.edge_index, k, method="bfs", seed=0, refine=True)
        return build_halo_plan(part, g.edge_index, axes=axes, pods=pods)

    return cached_halo_plan(f"citation_like:n{n}:e{e}:seed0", k, axes if pods > 1 else "model", pods=pods,
                            builder=build)


def _plan_edge_ids(plan) -> tuple[np.ndarray, np.ndarray]:
    """The global (sender, receiver) node ids of every plan edge, (k,
    e_local) each (padding edges point at whatever their padded rows hold):
    each rank's ``[local ‖ halo]`` table as global ids, read through the
    plan's re-localized senders."""
    from repro_torch.dist.halo import relocate_node_array

    ids = relocate_node_array(plan, np.arange(plan.n_nodes, dtype=np.int64))
    tables = []
    for b in range(plan.k):
        if plan.is_hierarchical:
            km, p = plan.k_model, b // plan.k_model
            halo = []
            for m in range(km):
                halo.append(ids[p * km + m][plan.send_loc[p * km + m]])
                halo += [ids[q * km + m][plan.send_rem[q * km + m]] for q in range(plan.n_pods)]
        else:
            halo = [ids[j][plan.send_idx[j]] for j in range(plan.k)]
        tables.append(np.concatenate([ids[b], *halo]))
    senders = np.stack([tables[b][plan.senders_l[b]] for b in range(plan.k)])
    receivers = np.stack([ids[b][plan.receivers_l[b]] for b in range(plan.k)])
    return senders, receivers


def _gnn_node_data(arch_id: str, shape: ShapeSpec, cfg, n: int, seed: int) -> dict:
    """The global per-node arrays of a cell's batch, drawn from ``seed``:
    features, targets (coin_gcn: labels and a label mask), positions."""
    rng = np.random.default_rng(seed)
    out = {"feats": rng.standard_normal((n, shape.d_feat), dtype=np.float32)}
    if arch_id == "coin_gcn":
        out["labels"] = rng.integers(0, cfg.layer_dims[-1], n).astype(np.int64)
        out["label_mask"] = np.ones(n, np.float32)
    else:
        n_out = cfg.n_vars if arch_id == "graphcast" else cfg.d_out
        out["target"] = rng.standard_normal((n, n_out), dtype=np.float32)
    out["pos"] = rng.standard_normal((n, 3), dtype=np.float32)
    return out


def _edge_feats(pos: np.ndarray, senders: np.ndarray, receivers: np.ndarray) -> np.ndarray:
    """GraphCast's (E, 4) relative-position edge features ``[p_r − p_s,
    ‖p_r − p_s‖]`` of global edges."""
    rel = pos[receivers] - pos[senders]
    return np.concatenate([rel, np.linalg.norm(rel, axis=-1, keepdims=True)], -1).astype(np.float32)


def _gnn_device_loss(arch_id: str, cfg) -> Callable:
    """Per-rank (weighted_sum, weight) of the arch's loss over one block of
    a halo or broadcast layout: padding (``edge_w == 0`` edges, rows past a
    block's part size) is masked out, so the psum-combined loss equals the
    unsharded loss."""

    def device_loss(params, b, pol):
        edge_mask = (b["edge_w"] > 0).to(torch.float32)
        if arch_id == "coin_gcn":
            from repro_torch.models.gcn import gcn_forward

            adjacency = (b["bsr_vals"], b["bsr_cols"], b["bsr_lens"]) if "bsr_vals" in b else None
            # The split pair: interior tiles aggregate the local block, the
            # boundary tables consume the halo exchange.
            boundary = (b["bsr_bvals"], b["bsr_bcols"], b["bsr_blens"]) if "bsr_bvals" in b else None
            logits = gcn_forward(params, b["feats"], b["senders"], b["receivers"], b["edge_w"], cfg, pol,
                                 adjacency=adjacency, adjacency_boundary=boundary).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, 1, b["labels"].long()[:, None])[:, 0]
            return ((lse - gold) * b["label_mask"]).sum(), b["label_mask"].sum()
        if arch_id == "pna":
            from repro_torch.models.pna import pna_forward

            pred = pna_forward(params, b["feats"], b["senders"], b["receivers"], cfg, pol, edge_mask=edge_mask)
        elif arch_id == "egnn":
            from repro_torch.models.egnn import egnn_forward

            pred, _ = egnn_forward(params, b["feats"], b["pos"], b["senders"], b["receivers"], cfg, pol,
                                   edge_mask=edge_mask)
        elif arch_id == "graphcast":
            from repro_torch.models.graphcast import graphcast_forward

            pred = graphcast_forward(params, b["feats"], b["edge_feats"], b["senders"], b["receivers"], cfg, pol,
                                     edge_mask=edge_mask)
        elif arch_id == "equiformer-v2":
            from repro_torch.models.equiformer_v2 import equiformer_forward

            pred = equiformer_forward(params, b["feats"], b["pos"], b["senders"], b["receivers"], cfg, pol,
                                      edge_mask=edge_mask)
        else:
            raise KeyError(arch_id)
        sq = (pred.float() - b["target"]).square().sum(dim=-1)
        return (sq * b["node_mask"]).sum(), b["node_mask"].sum() * pred.shape[-1]

    return device_loss


def _gnn_train_fn(policy, device_loss, opt_factory, bind_batch: Callable) -> Callable:
    """The train step of a full-graph cell: the loss ``psum(wsum) /
    max(psum(wcnt), 1)`` over the graph's group, its gradient (the
    parameters replicated leaf by leaf: their backward sums the ranks'
    gradients), and AdamW in place."""
    from repro_torch.train.loop import value_and_grad

    opt = opt_factory()

    def total_loss(params, batch):
        pol = bind_batch(policy, batch)
        wsum, wcnt = device_loss(pol.replicate(params), batch, pol)
        return pol.psum(wsum) / pol.psum(wcnt).clamp_min(1.0)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(total_loss, params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss

    return train_step


def _float_dtype(dtype) -> torch.dtype:
    """A GNN batch's float dtype: float64 under float64 parameters (a
    float64 hold of the step), else fp32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _to_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def _meta(shapes: dict) -> dict:
    return {k: torch.empty(shape, dtype=dtype, device="meta") for k, (shape, dtype) in shapes.items()}


def _adamw_init(params):
    from repro_torch.train.optimizer import adamw

    return adamw(lr=1e-3).init(params)


def _gnn_halo_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, cfg, dtype, payload: str | None) -> Cell:
    """Full-graph GNN train cell over the halo schedule (the default): each
    rank holds one HaloPlan block, every layer's sender gather reads
    ``[local ‖ halo]``; over ``model`` (flat: ``k·s_max`` received rows a
    layer) or, on a grid with a pod axis wider than one, over (pod, model)
    jointly with the two-phase hierarchical exchange. ``payload`` is the
    wire format; coin_gcn runs the overlapped schedule (the split blocked
    tables under ``backend="bsr"``)."""
    from repro_torch.dist.halo import plan_split_blocked_shape
    from repro_torch.launch.mesh import halo_axes
    from repro_torch.train.optimizer import adamw

    hier = len(halo_axes(grid)) > 1
    pods = grid.shape["pod"] if hier else 1
    k = pods * grid.shape["model"]
    n_raw, e_raw = _gnn_sizes(shape, pad_mult=1)
    plan = _shape_halo_plan(n_raw, e_raw, k, pods)
    policy = sh.gnn_policy(grid, batched=False, comm="halo", halo_payload=payload)
    bsr_stats = None
    if spec.arch_id == "coin_gcn" and cfg.backend == "bsr":
        split = plan_split_blocked_shape(plan)
        st_i, st_b = split["interior"], split["boundary"]
        nnzb = st_i["nnz_blocks"] + st_b["nnz_blocks"]
        tiles = k * (st_i["n_block_rows"] * st_i["max_nnzb"] + st_b["n_block_rows"] * st_b["max_nnzb"])
        bsr_stats = {"block": st_i["block"], "nnz_blocks": nnzb, "padded_tile_fraction": 1.0 - nnzb / max(tiles, 1),
                     "overlap_fraction": split["overlap_fraction"], "interior": st_i, "boundary": st_b}
    plan_tree = _gnn_params(spec.arch_id, cfg)
    p_specs = sh.replicated_specs(plan_tree)
    arch = spec.arch_id
    f32, i32 = _float_dtype(dtype), torch.int32
    n_local, e_local = plan.n_local, plan.e_local
    shapes = ({"send_loc": ((plan.s_loc,), i32), "send_rem": ((plan.s_rem,), i32)} if hier
              else {"send_idx": ((plan.s_max,), i32)})
    shapes.update(feats=((n_local, shape.d_feat), f32), senders=((e_local,), i32), receivers=((e_local,), i32),
                  edge_w=((e_local,), f32))
    if arch in ("egnn", "equiformer-v2"):
        shapes["pos"] = ((n_local, 3), f32)
    if arch == "graphcast":
        shapes["edge_feats"] = ((e_local, cfg.d_edge_in), f32)
    if arch == "coin_gcn":
        if bsr_stats is not None:
            for tag, prefix in (("interior", "bsr_"), ("boundary", "bsr_b")):
                st = bsr_stats[tag]
                R, T, B = st["n_block_rows"], st["max_nnzb"], st["block"]
                shapes.update({prefix + "vals": ((R, T, B, B), f32), prefix + "cols": ((R, T), i32),
                               prefix + "lens": ((R,), i32)})
        shapes.update(labels=((n_local,), torch.int64), label_mask=((n_local,), f32))
    else:
        shapes.update(target=((n_local, cfg.n_vars if arch == "graphcast" else cfg.d_out), f32),
                      node_mask=((n_local,), f32))
    device_loss = _gnn_device_loss(arch, cfg)

    def bind_batch(pol, b):
        if hier:
            return pol.bind_halo(send_loc=b["send_loc"], send_rem=b["send_rem"])
        return pol.bind_halo(b["send_idx"])

    def make_fn(policy):
        return _gnn_train_fn(policy, device_loss, lambda: adamw(lr=1e-3, donate=True), bind_batch)

    def inputs(cell, seed, device, params):
        if device.type == "meta":
            params = params if params is not None else draw_tree(seed, plan_tree, dtype, device)
            return params, _adamw_init(params), _meta(shapes)
        from repro_torch.dist.halo import node_mask, plan_blocked_rank, relocate_node_array

        r = cell.graph_rank
        data = _gnn_node_data(arch, shape, cfg, plan.n_nodes, seed + 1)
        arrays = {name: relocate_node_array(plan, data[name])[r] for name in data if name in shapes}
        tables = plan.rank_arrays(r, "cpu")
        names = ("send_loc", "send_rem") if hier else ("send_idx",)
        arrays.update({name: t.numpy() for name, t in zip(names + ("senders", "receivers", "edge_w"), tables)})
        if arch == "graphcast":
            s_ids, r_ids = _plan_edge_ids(plan)
            arrays["edge_feats"] = _edge_feats(data["pos"], s_ids[r], r_ids[r]) * (arrays["edge_w"] > 0)[:, None]
        if arch != "coin_gcn":
            arrays["node_mask"] = node_mask(plan)[r]
        if bsr_stats is not None:
            for tag, prefix in (("interior", "bsr_"), ("boundary", "bsr_b")):
                ba = plan_blocked_rank(plan, r, bsr_stats["block"], tag, bsr_stats[tag]["max_nnzb"])
                arrays.update({prefix + "vals": ba.block_vals, prefix + "cols": ba.block_cols,
                               prefix + "lens": ba.row_nnzb})
        batch = {name: t.to(shapes[name][1]) for name, t in _to_device(arrays, device).items()}
        params = params if params is not None else draw_tree(seed, plan_tree, dtype, device)
        return params, _adamw_init(params), batch

    note = (f"full graph (hier halo pods={pods} k={k} s_loc={plan.s_loc} s_rem={plan.s_rem} n_local={plan.n_local})"
            if hier else f"full graph (halo k={k} s_max={plan.s_max} n_local={plan.n_local})")
    if bsr_stats is not None:
        note += (f" bsr nnzb={bsr_stats['nnz_blocks']} (int={bsr_stats['interior']['nnz_blocks']}"
                 f" bnd={bsr_stats['boundary']['nnz_blocks']}) padfrac={bsr_stats['padded_tile_fraction']:.2f}")
    if payload:
        note += f" payload={payload}"
    batch_specs = {name: sh.spec(halo_axes(grid) if hier else "model", *([None] * (len(sh_) - 1)))
                   for name, (sh_, _) in shapes.items()}
    opt_specs = {"m": p_specs, "v": p_specs, "step": ()}
    return Cell(arch_id=arch, shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs, kind="train_step",
                policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                model_flops=_gnn_flops(arch, shape, cfg, bsr_stats) * 3.0, in_specs=(p_specs, opt_specs, batch_specs),
                out_specs=(p_specs, opt_specs, ()), note=note, comm="halo", halo_plan=plan, bsr_stats=bsr_stats,
                halo_payload=payload, halo_overlap=policy.halo_overlap)


def _broadcast_layout(shape: ShapeSpec, m: int) -> dict:
    """The Fig. 5c layout of a full-graph cell's shape graph over ``m``
    ranks: nodes padded to a multiple of ``m``, rank r holding rows
    ``[r·n_local, (r+1)·n_local)`` and the edges whose receivers it owns
    (senders global, receivers local), each rank's edges padded to the
    most any rank holds with weight-0 edges (0 → 0)."""
    key = ("broadcast", shape.n_nodes, shape.n_edges, shape.n_graphs, m)
    if key not in _SHAPE_GRAPHS:
        n_raw, e_raw = _gnn_sizes(shape, pad_mult=1)
        n_pad, _ = _gnn_sizes(shape, pad_mult=m)
        src, dst = _shape_graph(n_raw, e_raw).edge_index
        n_local = n_pad // m
        owner = dst // n_local
        e_local = max(int(np.bincount(owner, minlength=m).max(initial=0)), 1)
        senders, receivers = np.zeros((m, e_local), np.int32), np.zeros((m, e_local), np.int32)
        edge_w, edge_ids = np.zeros((m, e_local), np.float32), np.full((m, e_local), -1, np.int64)
        for r in range(m):
            sel = np.flatnonzero(owner == r)
            senders[r, :sel.size], receivers[r, :sel.size] = src[sel], dst[sel] - r * n_local
            edge_w[r, :sel.size], edge_ids[r, :sel.size] = 1.0, sel
        _SHAPE_GRAPHS[key] = dict(n_raw=n_raw, n_pad=n_pad, n_local=n_local, e_local=e_local, senders=senders,
                                  receivers=receivers, edge_w=edge_w, src=src, dst=dst, edge_ids=edge_ids)
    return _SHAPE_GRAPHS[key]


def _gnn_broadcast_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, cfg, dtype) -> Cell:
    """Full-graph GNN train cell over the broadcast schedule (the paper's
    Fig. 5c): each rank holds ``n_pad / model`` nodes and the edges whose
    receivers it owns; every layer all-gathers the node table over the
    model group (backward: a reduce-scatter), so the aggregation stays
    local. The loss is the halo cell's masked ``psum(wsum) / psum(wcnt)``."""
    from repro_torch.train.optimizer import adamw

    m = grid.shape["model"]
    lay = _broadcast_layout(shape, m)
    n_local, e_local = lay["n_local"], lay["e_local"]
    policy = sh.gnn_policy(grid, batched=False, comm="broadcast")
    plan_tree = _gnn_params(spec.arch_id, cfg)
    p_specs = sh.replicated_specs(plan_tree)
    arch = spec.arch_id
    f32, i32 = _float_dtype(dtype), torch.int32
    shapes = dict(feats=((n_local, shape.d_feat), f32), senders=((e_local,), i32), receivers=((e_local,), i32),
                  edge_w=((e_local,), f32))
    if arch in ("egnn", "equiformer-v2"):
        shapes["pos"] = ((n_local, 3), f32)
    if arch == "graphcast":
        shapes["edge_feats"] = ((e_local, cfg.d_edge_in), f32)
    if arch == "coin_gcn":
        shapes.update(labels=((n_local,), torch.int64), label_mask=((n_local,), f32))
    else:
        shapes.update(target=((n_local, cfg.n_vars if arch == "graphcast" else cfg.d_out), f32),
                      node_mask=((n_local,), f32))
    device_loss = _gnn_device_loss(arch, cfg)

    def make_fn(policy):
        return _gnn_train_fn(policy, device_loss, lambda: adamw(lr=1e-3, donate=True), lambda pol, b: pol)

    def inputs(cell, seed, device, params):
        params = params if params is not None else draw_tree(seed, plan_tree, dtype, device)
        if device.type == "meta":
            return params, _adamw_init(params), _meta(shapes)
        r = cell.graph_rank
        data = _gnn_node_data(arch, shape, cfg, lay["n_raw"], seed + 1)
        rows = slice(r * n_local, (r + 1) * n_local)
        pad = lambda a: np.concatenate([a, np.zeros((lay["n_pad"] - a.shape[0],) + a.shape[1:], a.dtype)])
        arrays = {name: pad(data[name])[rows] for name in data if name in shapes}
        arrays.update(senders=lay["senders"][r], receivers=lay["receivers"][r], edge_w=lay["edge_w"][r])
        if arch == "graphcast":
            ids = lay["edge_ids"][r]
            real = ids >= 0
            feats = np.zeros((e_local, 4), np.float32)
            feats[real] = _edge_feats(data["pos"], lay["src"][ids[real]], lay["dst"][ids[real]])
            arrays["edge_feats"] = feats
        if arch != "coin_gcn":
            arrays["node_mask"] = pad(np.ones(lay["n_raw"], np.float32))[rows]
        batch = {name: t.to(shapes[name][1]) for name, t in _to_device(arrays, device).items()}
        return params, _adamw_init(params), batch

    batch_specs = {name: sh.spec("model", *([None] * (len(sh_) - 1))) for name, (sh_, _) in shapes.items()}
    opt_specs = {"m": p_specs, "v": p_specs, "step": ()}
    return Cell(arch_id=arch, shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs, kind="train_step",
                policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                model_flops=_gnn_flops(arch, shape, cfg) * 3.0, in_specs=(p_specs, opt_specs, batch_specs),
                out_specs=(p_specs, opt_specs, ()), note="full graph (broadcast)", comm="broadcast")


def _sampled_block(shape: ShapeSpec) -> tuple[np.ndarray, np.ndarray]:
    """A sampled block's edges in the fanout-tree layout of its shape: the
    seeds first, then each hop's frontier, every node of a hop sending to
    its parent in the hop before ((senders, receivers), block-local ids)."""
    src, dst, lo, frontier = [], [], 0, shape.batch_nodes
    for f in shape.fanout:
        parents = np.repeat(np.arange(lo, lo + frontier), f)
        children = np.arange(lo + frontier, lo + frontier + frontier * f)
        src.append(children)
        dst.append(parents)
        lo, frontier = lo + frontier, frontier * f
    return np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)


def _gnn_sampled_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, cfg, dtype) -> Cell:
    """Sampled-block GNN train cell: one block per data shard (the model
    ranks of a data slice run the same block), the loss on the seed rows,
    its mean over the data group, and the gradient summed over the data
    group by `repro_torch.train.optimizer.data_parallel`."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw, data_parallel

    n_blocks = _n_data(grid)
    n, e = _gnn_sizes(shape, pad_mult=1)
    arch = spec.arch_id
    plan_tree = _gnn_params(arch, cfg)
    p_specs = sh.replicated_specs(plan_tree)
    policy = sh.gnn_policy(grid, batched=True)
    f32, i32 = _float_dtype(dtype), torch.int32
    n_out = cfg.n_vars if arch == "graphcast" else getattr(cfg, "d_out", None)
    shapes = dict(feats=((n, shape.d_feat), f32), senders=((e,), i32), receivers=((e,), i32))
    if arch in ("egnn", "equiformer-v2"):
        shapes["pos"] = ((n, 3), f32)
    if arch == "graphcast":
        shapes["edge_feats"] = ((e, cfg.d_edge_in), f32)
    if arch == "coin_gcn":
        shapes.update(edge_weight=((e,), f32), labels=((n,), torch.int64), label_mask=((n,), f32))
    else:
        shapes["target"] = ((shape.batch_nodes, n_out), f32)
    from repro_torch.dist.policy import NO_POLICY

    loss_fn = _gnn_loss_fn(arch, cfg, NO_POLICY, n_loss_nodes=shape.batch_nodes)

    def make_fn(policy):
        opt = data_parallel(adamw(lr=1e-3, donate=True), policy, p_specs)

        def train_step(params, opt_state, batch):
            def mean_loss(p, b):
                loss = loss_fn(p, b)
                return policy.data_psum(loss) / n_blocks if n_blocks > 1 else loss
            loss, grads = value_and_grad(mean_loss, params, batch)
            new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, loss
        return train_step

    def inputs(cell, seed, device, params):
        params = params if params is not None else draw_tree(seed, plan_tree, dtype, device)
        if device.type == "meta":
            return params, _adamw_init(params), _meta(shapes)
        rng = np.random.default_rng([seed + 1, cell.policy.data_index])
        senders, receivers = _sampled_block(shape)
        arrays = dict(feats=rng.standard_normal((n, shape.d_feat), dtype=np.float32), senders=senders,
                      receivers=receivers)
        if arch in ("egnn", "equiformer-v2", "graphcast"):
            pos = rng.standard_normal((n, 3), dtype=np.float32)
            if arch != "graphcast":
                arrays["pos"] = pos
            else:
                arrays["edge_feats"] = _edge_feats(pos, senders, receivers)
        if arch == "coin_gcn":
            arrays.update(edge_weight=np.ones(e, np.float32),
                          labels=rng.integers(0, cfg.layer_dims[-1], n).astype(np.int64),
                          label_mask=np.ones(n, np.float32))
        else:
            arrays["target"] = rng.standard_normal((shape.batch_nodes, n_out), dtype=np.float32)
        batch = {name: t.to(shapes[name][1]) for name, t in _to_device(arrays, device).items()}
        return params, _adamw_init(params), batch

    da = data_axes(grid)
    blk = dataclasses.replace(shape, n_nodes=n * n_blocks, n_edges=e * n_blocks)
    batch_specs = {name: sh.spec(da, *([None] * len(sh_))) for name, (sh_, _) in shapes.items()}
    opt_specs = {"m": p_specs, "v": p_specs, "step": ()}
    return Cell(arch_id=arch, shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs, kind="train_step",
                policy=policy, make_fn=make_fn, make_rank_inputs=inputs,
                model_flops=_gnn_flops(arch, blk, cfg) * 3.0, in_specs=(p_specs, opt_specs, batch_specs),
                out_specs=(p_specs, opt_specs, ()), note="sampled blocks ×%d" % n_blocks)


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, dtype, comm: str | None = None,
              optimized: bool = False, payload: str | None = None) -> Cell:
    """The reference's `_gnn_cell`: sampled shapes take the sampled-block
    cell, full graphs the halo schedule (``comm`` None or ``"halo"``) or
    the broadcast one; ``optimized`` turns a full-graph coin_gcn halo cell
    to ``backend="bsr"`` (K1 on each rank's split blocked tables); an
    equiformer-v2 cell over more than 2,000,000 edges (the shape's, as the
    reference counts them) runs its messages in 64 chunks of
    ``ceil(n_edges / 64)`` edges."""
    cfg = spec.make_config(shape)
    if spec.arch_id == "equiformer-v2" and (shape.n_edges or 0) > 2_000_000 and cfg.edge_chunk is None:
        # The reference's big-edge rule: 64 chunks bound the (chunk, K, C) irrep tensor.
        cfg = dataclasses.replace(cfg, edge_chunk=-(-shape.n_edges // 64))
    sampled = shape.batch_nodes is not None
    if optimized and spec.arch_id == "coin_gcn" and not sampled and comm != "broadcast":
        cfg = dataclasses.replace(cfg, backend="bsr")
    if comm is None:
        comm = "broadcast" if sampled else "halo"
    if comm not in ("halo", "broadcast"):
        raise ValueError(f"unknown comm mode {comm!r} (expected 'halo' or 'broadcast')")
    if sampled:
        return _gnn_sampled_cell(spec, shape, grid, cfg, dtype)
    if comm == "halo":
        return _gnn_halo_cell(spec, shape, grid, cfg, dtype, payload)
    return _gnn_broadcast_cell(spec, shape, grid, cfg, dtype)


# ==================================================================== factory
def build_cell(spec: ArchSpec, shape: ShapeSpec, grid: Grid, dtype: torch.dtype | None = None,
               optimized: bool = False, comm: str | None = None, payload: str | None = None) -> Cell:
    """The cell of ``spec`` at ``shape`` on ``grid``; ``dtype`` of the
    parameters (the reference's defaults: bf16 for the LMs, fp32 for
    DeepFM and the GNNs).

    ``optimized`` applies the reference's §Perf findings: for an LM
    hierarchical MoE dispatch (``moe_groups`` = the data shards) and remat
    on train; for a full-graph coin_gcn halo cell ``backend="bsr"``.
    ``comm`` selects the full-graph GNN schedule (None: the family default,
    halo; ``"broadcast"``: Fig. 5c); ``payload`` the halo wire format
    (None/``"fp32"`` | ``"bf16"`` | ``"int8"``). Other families ignore both."""
    payload = None if payload == "fp32" else payload
    if spec.family == "lm":
        return _lm_cell(spec, shape, grid, dtype or BF16, optimized=optimized)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape, grid, dtype or F32)
    if spec.family == "gnn":
        return _gnn_cell(spec, shape, grid, dtype or F32, comm=comm, optimized=optimized, payload=payload)
    raise KeyError(spec.family)
