"""§Perf hillclimb driver — twin of `repro.launch.hillclimb`: four cells,
a baseline and variants, each variant with its hypothesis and the roofline
terms before and after.

Targets:
  1. moonshot-v1-16b-a3b × train_4k — the MoE dispatch's collectives
     (``moe_groups`` 1 → 16, then remat, then capacity factor 1.25 → 1.0);
  2. granite-34b × train_4k         — peak memory (remat, eight
     micro-batches accumulated by a hand-built cell, donation);
  3. pna × ogb_products             — the full-graph exchange the COIN
     objective governs: the halo default against the broadcast schedule,
     and a PNA halo cell of its own with bf16 edge math and a bf16 wire;
  4. gemma3-12b × long_500k         — the decode's cache reads: the uniform
     cache against a two-stack decode whose 40 local layers read only
     their 1,024-key window, sliced from the sequence-split cache or kept
     in a replicated ring.

Every record comes from the dry run's pipeline
(`repro_torch.launch.dryrun.step_terms`): one rank of the grid traced
once on meta tensors in a ``fake`` process group, FLOPs from
``FlopCounterMode``, collectives from the port's counting point, the
roofline terms at the H100 data-sheet rates (not measured), and
``peak_bytes`` = the arguments + the step's live peak. Nothing is
compiled (``compile_s`` is null) and nothing is timed. The records go to
``results/hillclimb_torch.json`` (never the reference's
``results/hillclimb.json``), one list per target, merged into the file
after each target. `PERF.md` §6 sets the port's outcomes beside the
reference's hypotheses.

The three hand-built cells are `repro_torch.launch.steps.Cell` s a rank
runs like any other: ``t2-b`` (`_granite_accum_cell`), `_pna_halo_cell`
and `_gemma_twostack_cell`. Where the reference donates (t2-c), the port's
train cells already update in place, so t2-c measures the t2-a cell.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--target 1|2|3|4|all] [--out F]

The CPU suffices: no card is used.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["RESULTS", "PLAN_PATH", "ACC", "main", "target1_moe", "target2_granite", "target3_pna",
           "target4_gemma_cache", "pna_halo_batch", "pna_halo_lockstep_loss"]

RESULTS = "results/hillclimb_torch.json"
PLAN_PATH = "results/halo_plan_ogb_torch.npz"
ACC = 8                 # t2-b's micro-batches
PLAN_FIELDS = ("k", "n_local", "s_max", "e_local", "n_nodes", "perm", "send_idx", "senders_l", "receivers_l",
               "edge_w", "part_sizes")


def _measure(cell, grid, tag: str) -> dict:
    """The reference's record of one cell: rank 0 of ``grid`` traced on meta
    inputs in a fake group (`repro_torch.launch.dryrun.step_terms`)."""
    from repro_torch.launch.dryrun import step_terms
    from repro_torch.launch.mesh import fake_group

    t0 = time.perf_counter()
    with fake_group(grid):
        bound = cell.bind()
        terms = step_terms(bound.fn, bound.abstract_inputs())
    trace_s = time.perf_counter() - t0
    roof, coll = terms["roofline"], terms["collective_bytes"]
    peak = terms["memory"]["peak_bytes"]
    rec = {
        "tag": tag,
        "compute_s": roof["compute_s"],
        "memory_s": roof["memory_s"],
        "collective_s": roof["collective_s"],
        "collective_by_type": {k: v for k, v in coll.items() if v},
        "peak_bytes": peak,
        "compile_s": None,
        "model_flops": cell.model_flops,
    }
    print(f"  [{tag}] compute={rec['compute_s']:.3g}s memory={rec['memory_s']:.3g}s "
          f"collective={rec['collective_s']:.3g}s peak={peak / 1e9:.1f}GB (trace {trace_s:.0f}s, nothing compiled)")
    return rec


def _with_config(spec, cfg):
    return dataclasses.replace(spec, make_config=lambda s=None, c=cfg: c)


def _defaults(arch: str, shape_name: str, grid, shape):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import production_grid

    spec = get_arch(arch)
    return spec, shape or spec.shapes[shape_name], grid or production_grid()


# ================================================== target 1: MoE collectives
def target1_moe(grid=None, shape=None) -> list[dict]:
    from repro_torch.launch.steps import build_cell

    spec, shape, grid = _defaults("moonshot-v1-16b-a3b", "train_4k", grid, shape)
    out = []
    print("[T1] moonshot-v1-16b-a3b × train_4k (collective-bound MoE)")
    print("  hypothesis A: the flat dispatch sorts/scatters a GLOBAL (T·K)"
          " token stream across shards → XLA emits all-gathers of activations"
          " per MoE layer; grouping dispatch per data shard (G=16) keeps the"
          " sort local and only the (G,E,C,D) buffer crosses the EP axis:"
          " predicted wire/layer ≈ 2·buf/256dev ≈ 0.25 GB vs ≳4 GB.")
    out.append(_measure(build_cell(spec, shape, grid), grid, "t1-baseline groups=1"))

    cfg16 = dataclasses.replace(spec.make_config(shape), moe_groups=16)
    out.append(_measure(build_cell(_with_config(spec, cfg16), shape, grid), grid, "t1-a groups=16 (EP all-to-all)"))

    print("  hypothesis B: with dispatch fixed, remat trims the activation"
          " traffic of the backward pass (fewer saved intermediates).")
    cfg_r = dataclasses.replace(cfg16, remat=True)
    out.append(_measure(build_cell(_with_config(spec, cfg_r), shape, grid), grid, "t1-b groups=16 + remat"))

    print("  hypothesis C: with the collective fixed, memory dominates; the"
          " (G,E,C,D) buffer carries 25% capacity padding — cf 1.25 → 1.0"
          " should cut the dispatch-buffer traffic term by ~20% (drops"
          " overflow tokens; the standard Switch trade).")
    cfg_c = dataclasses.replace(cfg16, moe_capacity_factor=1.0)
    out.append(_measure(build_cell(_with_config(spec, cfg_c), shape, grid), grid, "t1-c groups=16 + cf=1.0"))
    return out


# ================================================ target 2: granite peak mem
def _granite_accum_cell(base):
    """t2-b: ``base`` (a train cell of `build_cell`: its parameter plan,
    specs and token inputs) with a step that splits the rank's rows into
    `ACC` equal micro-batches, sums ``value_and_grad(lm_loss)`` over them
    (an eager loop where the reference scans), divides by `ACC` and makes
    one AdamW update. The mean of equal-size micro-batch means is the batch
    mean, so the loss and gradient are the full batch's."""
    from repro_torch.models.transformer_lm import lm_loss
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw, data_parallel
    from repro_torch.train.tree import tree_map

    cfg = base.cfg

    def make_fn(policy):
        opt = data_parallel(adamw(lr=3e-4, donate=True), policy, base.param_specs)

        def train_step_accum(params, opt_state, toks):
            if toks.shape[0] % ACC:
                raise ValueError(f"{toks.shape[0]} rows a rank do not split into {ACC} micro-batches")
            loss, grads = 0.0, None
            for mb in toks.split(toks.shape[0] // ACC):
                l, g = value_and_grad(lambda p, b: lm_loss(p, b, cfg, policy), params, mb)
                loss = loss + l
                grads = g if grads is None else tree_map(torch.add, grads, g)
            grads = tree_map(lambda g: g / ACC, grads)
            new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, loss / ACC
        return train_step_accum

    return dataclasses.replace(base, make_fn=make_fn, note=f"{ACC} micro-batches a rank, accumulated")


def target2_granite(grid=None, shape=None) -> list[dict]:
    from repro_torch.launch.steps import build_cell

    spec, shape, grid = _defaults("granite-34b", "train_4k", grid, shape)
    out = []
    print("[T2] granite-34b × train_4k (memory-bound, 42.9 GB/device peak)")
    out.append(_measure(build_cell(spec, shape, grid), grid, "t2-baseline"))

    print("  hypothesis A: peak is dominated by saved per-layer activations"
          " (88 layers × B·S·D ≈ 88×16×4096×6144×2B/16TP ≈ 33 GB/dev);"
          " remat on the layer scan should cut peak to O(1 layer) + params"
          " at ~+30% recompute FLOPs.")
    spec_r = _with_config(spec, dataclasses.replace(spec.make_config(shape), remat=True))
    base = build_cell(spec_r, shape, grid)
    out.append(_measure(base, grid, "t2-a remat"))

    print("  hypothesis B: microbatching (8×) shrinks live activations"
          " another 8× at constant math; combined with remat the step should"
          " fit 16 GB with headroom.")
    out.append(_measure(_granite_accum_cell(base), grid, "t2-b remat + 8x microbatch"))

    print("  hypothesis C: peak_bytes on this backend = arguments + outputs"
          " (params/opt counted twice without aliasing); donating params &"
          " opt state (the in-place update a real deployment uses) should"
          " remove the output copy: predicted peak 42.9 → ~18 GB.")
    rec = _measure(base, grid, "t2-c remat + donation")
    rec["note"] = ("the port's train cells always update the parameters and AdamW state in place (the "
                   "reference's donate_argnums=(0, 1)); build_cell has no donate knob, so t2-c measures "
                   "the t2-a cell")
    out.append(rec)
    return out


# =========================================== target 3: PNA broadcast → halo
def _pna_layers(params, blocks: list, cfg, cd, exchange) -> list:
    """The reference's device forward (`repro.launch.hillclimb._pna_halo_cell`)
    for each block of ``blocks`` (a rank's batch of the plan layout): the
    parameters cast to ``cd``; every layer's halo is ``exchange(hs)`` (a
    halo block for each block, from every block's rows). Padding edges
    count in the aggregates (their messages are zeroed) and padding rows in
    the loss, as the reference's cell has them. Returns each block's
    mean squared error."""
    from repro_torch.graph.ops import multi_aggregate_edges, segment_sum
    from repro_torch.nn.layers import linear
    from repro_torch.train.tree import tree_map

    def lin(p, x):                                  # jnp's promotion: the wider of input and weight
        dt = torch.promote_types(x.dtype, p["w"].dtype)
        return linear({"w": p["w"].to(dt), "b": p["b"].to(dt)}, x.to(dt))

    params = tree_map(lambda p: p.to(cd), params)
    hs, stats = [], []
    for b in blocks:
        n_local = b["feats"].shape[0]
        r, w = b["receivers"].long(), (b["edge_w"] > 0)
        hs.append(torch.relu(lin(params["enc"], b["feats"].to(cd))))
        logd = torch.log1p(segment_sum(w.to(torch.float32), r, n_local))[:, None]
        stats.append((logd / cfg.mean_log_degree, cfg.mean_log_degree / logd.clamp_min(1e-6)))
    for i in range(cfg.n_layers):
        halos = exchange(hs)
        nxt = []
        for b, h, halo, (amp, att) in zip(blocks, hs, halos, stats):
            r, w = b["receivers"].long(), (b["edge_w"] > 0)
            full = torch.cat([h, halo])
            msg_in = torch.cat([full.index_select(0, b["senders"].long()), h.index_select(0, r)], dim=-1)
            msg = torch.relu(lin(params[f"pre{i}"], msg_in)) * w[:, None]
            aggs = multi_aggregate_edges(msg, r, h.shape[0])
            feats = [h]
            for a in ("mean", "max", "min", "std"):
                v = aggs[a]
                feats += [v, v * amp, v * att]
            nxt.append(h + torch.relu(lin(params[f"post{i}"], torch.cat(feats, dim=-1))))
        hs = nxt
    return [(lin(params["dec"], h).float() - b["target"]).square().mean() for b, h in zip(blocks, hs)]


def _pna_halo_cell(grid, plan, cfg, shape, compute_dtype=None, payload=None):
    """Train cell for PNA over the halo plan, the reference's
    `_pna_halo_cell`: each rank runs the reference's device forward on its
    block, every layer's halo through `repro_torch.dist.halo.halo_exchange`
    (``payload``: the wire format, decoded on receive), the loss the MSE
    averaged over the model group, the parameters replicated (their
    gradient summed over the group) and AdamW in place.
    ``compute_dtype=torch.bfloat16`` (t3-b) casts the parameters and
    features inside the step (the rest follows jnp's promotion, as in the
    reference); the parameters and the optimizer stay fp32."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import Cell, _adamw_init, _gnn_params, _meta, draw_tree
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import adamw

    cd = compute_dtype or torch.float32
    k, n_local, e_local = plan.k, plan.n_local, plan.e_local
    plan_tree = _gnn_params("pna", cfg)
    p_specs = sh.replicated_specs(plan_tree)
    policy = sh.gnn_policy(grid, batched=False, comm="halo", halo_payload=payload, halo_overlap=False)
    f32, i32 = torch.float32, torch.int32
    shapes = {"feats": ((n_local, cfg.d_in), f32), "send_idx": ((plan.s_max,), i32), "senders": ((e_local,), i32),
              "receivers": ((e_local,), i32), "edge_w": ((e_local,), f32), "target": ((n_local, cfg.d_out), f32)}

    def make_fn(policy):
        opt = adamw(lr=1e-3, donate=True)

        def loss_fn(params, batch):
            pol = policy.bind_halo(batch["send_idx"])
            (loss,) = _pna_layers(pol.replicate(params), [batch], cfg, cd, lambda hs: [pol.halo_block(hs[0])])
            return pol.psum(loss) / k

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_fn, params, batch)
            new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, loss
        return train_step

    def inputs(cell, seed, device, params):
        params = params if params is not None else draw_tree(seed, plan_tree, f32, device)
        if device.type == "meta":
            return params, _adamw_init(params), _meta(shapes)
        return params, _adamw_init(params), pna_halo_batch(plan, cfg, shape, seed, cell.graph_rank, device)

    spec_of = lambda sh_: sh.spec("model", *([None] * (len(sh_) - 1)))
    opt_specs = {"m": p_specs, "v": p_specs, "step": ()}
    return Cell(arch_id="pna", shape_name=shape.name, shape=shape, cfg=cfg, param_specs=p_specs, kind="train_step",
                policy=policy, make_fn=make_fn, make_rank_inputs=inputs, model_flops=0.0,
                in_specs=(p_specs, opt_specs, {name: spec_of(s) for name, (s, _) in shapes.items()}),
                out_specs=(p_specs, opt_specs, ()),
                note=f"halo s_max={plan.s_max} n_local={plan.n_local}" + (f" payload={payload}" if payload else ""),
                comm="halo", halo_plan=plan, halo_payload=payload)


def pna_halo_batch(plan, cfg, shape, seed: int, r: int, device) -> dict:
    """Block ``r`` of `_pna_halo_cell`'s batch: the plan's tables and the
    shape graph's node data drawn from ``seed + 1`` (`build_cell`'s
    features and targets), relocated into the plan's layout."""
    from repro_torch.dist.halo import relocate_node_array
    from repro_torch.launch.steps import _gnn_node_data, _to_device

    data = _gnn_node_data("pna", shape, cfg, plan.n_nodes, seed + 1)
    arrays = {name: relocate_node_array(plan, data[name])[r] for name in ("feats", "target")}
    tables = plan.rank_arrays(r, "cpu")
    arrays.update({name: t.numpy() for name, t in zip(("send_idx", "senders", "receivers", "edge_w"), tables)})
    return _to_device(arrays, device)


def pna_halo_lockstep_loss(params, batches: list, cfg, compute_dtype=None) -> torch.Tensor:
    """`_pna_halo_cell`'s loss with its k blocks in one process: every
    layer's halo of block j is slot-for-slot what the exchange gives it
    (every block's ``send_idx`` rows, in block order). The cell is a
    function of the plan's layout (padding rows enter the loss, padding
    edges the aggregates), so this — not the cell on a one-block plan — is
    the unsharded twin of a k-rank step. fp32 wire only."""
    def exchange(hs):
        halo = torch.cat([h.index_select(0, b["send_idx"].long()) for h, b in zip(hs, batches)])
        return [halo] * len(hs)

    losses = _pna_layers(params, batches, cfg, compute_dtype or torch.float32, exchange)
    return torch.stack(losses).sum() / len(batches)


def _load_plan(path: str, n: int, e: int, k: int) -> bool:
    """Pre-seed the plan cache under `_shape_halo_plan`'s key from a saved
    plan of the same graph and k (the reference's ``results/halo_plan_ogb.npz``
    logic, on the port's own file); whether it did."""
    from repro_torch.dist.halo import HaloPlan, cached_halo_plan

    if not os.path.exists(path):
        return False
    z = np.load(path)
    if int(z["n_nodes"]) != n or int(z["k"]) != k:      # a plan of another shape or grid
        return False
    loaded = HaloPlan(k=int(z["k"]), n_local=int(z["n_local"]), s_max=int(z["s_max"]), e_local=int(z["e_local"]),
                      n_nodes=int(z["n_nodes"]), perm=z["perm"], send_idx=z["send_idx"], senders_l=z["senders_l"],
                      receivers_l=z["receivers_l"], edge_w=z["edge_w"], part_sizes=z["part_sizes"])
    cached_halo_plan(f"citation_like:n{n}:e{e}:seed0", k, "model", builder=lambda: loaded)
    return True


def target3_pna(grid=None, shape=None) -> list[dict]:
    from repro_torch.core.dataflow import exchange_cost
    from repro_torch.launch.steps import _gnn_flops, _gnn_sizes, build_cell

    spec, shape, grid = _defaults("pna", "ogb_products", grid, shape)
    out = []
    print("[T3] pna × ogb_products (paper-representative: exchange schedule)")
    print("  NOTE: the halo exchange IS the build_cell default for full-graph GNN"
          " cells, so the baseline below is the halo schedule and the"
          " comparison point is the comm='broadcast' escape hatch (paper Fig. 5c).")
    # The in-memory plan cache dies with the process; for the 61.9M-edge plan
    # (minutes of BFS + refine) persist it and pre-seed the cache, so that
    # repeat runs load in seconds. The key is steps._shape_halo_plan's.
    n, e = _gnn_sizes(shape, pad_mult=1)
    loaded = _load_plan(PLAN_PATH, n, e, grid.shape["model"])
    t0 = time.time()
    cell = build_cell(spec, shape, grid)                 # default = halo
    plan = cell.halo_plan
    plan_s = time.time() - t0
    if not loaded:
        os.makedirs(os.path.dirname(PLAN_PATH), exist_ok=True)
        np.savez_compressed(PLAN_PATH, **{f: getattr(plan, f) for f in PLAN_FIELDS})
    print(f"  plan ready in {plan_s:.0f}s: s_max={plan.s_max} "
          f"n_local={plan.n_local} wire_fraction={plan.wire_fraction():.4f}")
    rec = _measure(cell, grid, "t3-baseline halo (the new default)")
    rec["plan"] = {"s_max": plan.s_max, "n_local": plan.n_local, "wire_fraction": plan.wire_fraction()}
    out.append(rec)

    print("  comparison: the broadcast all-gather ships (k−1)/k·N·d per layer;"
          " the halo default ships only the per-pair boundary sources (the"
          " quantity COIN's Eq. 2 minimizes). Expect the collective term to"
          " blow back up under comm='broadcast'.")
    out.append(_measure(build_cell(spec, shape, grid, comm="broadcast"), grid,
                        "t3-a broadcast escape hatch (pre-PR2 default)"))

    print("  iteration: the halo default killed the collective term but the"
          " memory term now dominates ((E,2d) message tiles fully local)."
          " hypothesis: bf16 edge math halves the dominant intermediate"
          " traffic at harmless precision for message passing.")
    cfg = spec.make_config(shape)
    cell_b = _pna_halo_cell(grid, plan, cfg, shape, compute_dtype=torch.bfloat16)
    cell_b.model_flops = _gnn_flops("pna", shape, cfg) * 3.0
    out.append(_measure(cell_b, grid, "t3-b halo + bf16 edge math"))

    print("  iteration: the residual collective term is the per-layer halo"
          " gather itself. hypothesis: quantizing just the WIRE to bf16"
          " (dequantized on receive) halves the exchange bytes without"
          " touching the fp32 edge math — and the overlapped schedule hides"
          " the rest behind interior aggregation.")
    d = shape.d_feat or cfg.d_in          # the reference prices the wire at d_feat; the cell exchanges d_hidden
    for bits, tag in ((32, "fp32"), (16, "bf16")):
        ec = exchange_cost(plan.halo_rows_per_device, d, bits, plan.overlap_fraction())
        print(f"  exchange model [{tag}]: wire={ec.wire_bytes / 1e6:.1f}MB/layer"
              f" exposed={ec.exposed_bytes / 1e6:.1f}MB/layer"
              f" (overlap_fraction={plan.overlap_fraction():.3f},"
              f" compression={ec.compression:.0f}x)")
    cell_c = _pna_halo_cell(grid, plan, cfg, shape, payload="bf16")
    cell_c.model_flops = _gnn_flops("pna", shape, cfg) * 3.0
    rec_c = _measure(cell_c, grid, "t3-c halo + bf16 wire payload")
    ec = exchange_cost(plan.halo_rows_per_device, d, 16, plan.overlap_fraction())
    rec_c["exchange_model"] = {
        "wire_bytes_per_layer": ec.wire_bytes,
        "exposed_bytes_per_layer": ec.exposed_bytes,
        "overlap_fraction": ec.overlap_fraction,
        "compression": ec.compression,
    }
    rec_c["counted_wire"] = {
        "all_gather_bytes_per_layer": rec_c["collective_by_type"].get("all-gather", 0.0) / cfg.n_layers,
        "d": cfg.d_hidden,
        "note": "the halo all-gathers' result bytes a layer, as counted: the cell exchanges h at d_hidden, "
                "where exchange_model prices d_feat (the reference's formula)",
    }
    out.append(rec_c)
    return out


# ===================================== stretch: gemma3 long-context KV cache
def _ring_decode(p, x, rk, rv, pos: int, cfg, policy) -> torch.Tensor:
    """t4-b's local attention: one decode step against a ring of W slots
    (``rk``, ``rv``: (B, W, Hk, Dh)) that every rank holds whole, with every
    kv head. The step writes slot ``pos mod W``; slot j holds position
    ``pos − ((pos − j) mod W)``, inside the window by construction and
    valid when ≥ 0. Like the sequence-split decode, each rank attends every
    query head and keeps its own for the row-parallel ``wo``."""
    from repro_torch.nn.attention import _partial_softmax, _qkv, local_heads

    B, hd, W = x.shape[0], cfg.head_dim, rk.shape[1]
    rows, positions = torch.arange(B, device=x.device), torch.full((B,), int(pos), device=x.device)
    q, k, v = _qkv(p, x, cfg, positions[:, None], policy, every_kv=True)
    h_loc, kv_sharded = q.shape[2], local_heads(cfg, policy)[3]
    q_all = policy.model_gather(q, dim=2)                          # (B, 1, H, Dh)
    if kv_sharded:
        k, v = policy.model_gather(k, dim=2), policy.model_gather(v, dim=2)
    rk[rows, positions % W] = k[:, 0]
    rv[rows, positions % W] = v[:, 0]
    k_pos = positions[:, None] - (positions[:, None] - torch.arange(W, device=x.device)) % W
    qg = q_all.reshape(B, cfg.n_kv_heads, cfg.q_groups, hd) * (hd ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qg, rk).float()
    _, l, acc = _partial_softmax(s, (k_pos >= 0)[:, None, None, :], rv)
    out = (acc / l[..., None]).to(x.dtype).reshape(B, cfg.n_heads, hd)
    first = policy.model_index * h_loc
    return policy.model_psum(out[:, first:first + h_loc].reshape(B, 1, h_loc * hd) @ p["wo"])


def _gemma_twostack_cell(grid, spec, shape, ring: bool = False, pos: int | None = None):
    """Decode step where the local layers read only their W-key window (the
    global layers still read the whole cache), in the 5 local + 1 global
    order of ``global_every``.

    ring=False (t4-a) — each local layer reads the window
      ``[clip(pos − W + 1, 0, S − W), +W)`` of the full cache, split by
      sequence over every axis of the grid (the reference's batch-1 cache
      spec): a rank scores the part of its slice inside the window, and a
      rank whose slice misses it gives the empty partial
      (`repro_torch.nn.attention.attention_decode`'s ``span``).
    ring=True (t4-b) — the global layers keep the sequence-split cache
      (``k``, ``v``: one per group); each local layer keeps a replicated
      ring of W slots (``rk``, ``rv``: group × local layer): the step
      writes slot ``pos mod W``, slot j holds position
      ``pos − ((pos − j) mod W)``, valid when ≥ 0 (`_ring_decode`).

    The cache is drawn as `build_cell`'s decode cell draws it (the same
    numbers at every position), and the ring is filled from the drawn
    cache's positions by the slot rule. ``pos`` defaults to the decode
    cell's."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import Cell, _draw_params, draw_leaf
    from repro_torch.models.transformer_lm import GLOBAL_WINDOW, _embed, _ffn, _layer, _logits, lm_param_plan
    from repro_torch.nn.attention import attention_decode
    from repro_torch.nn.layers import Draw, rms_norm

    cfg = spec.make_config(shape)
    W, period = cfg.window, cfg.global_every
    n_groups, n_local = cfg.n_layers // period, period - 1
    if n_groups * period != cfg.n_layers:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of {period}")
    hd, Hk = cfg.attn.head_dim, cfg.n_kv_heads
    B, S = shape.global_batch, shape.seq_len
    pos = S // 2 - 4 if pos is None else int(pos)
    seq = sh.spec(None, None, tuple(grid.axis_names), None, None)
    policy = dataclasses.replace(sh.lm_policy(grid, cfg), cache=seq)
    plan = lm_param_plan(cfg)
    p_specs = sh.lm_param_specs(plan, cfg, grid)
    cache_plan = Draw((cfg.n_layers, B, S, Hk, hd), units=(cfg.n_layers, B, 1, 1, 1))   # the decode cell's
    glob = [g * period + n_local for g in range(n_groups)]
    if ring:
        c_specs = {"k": seq, "v": seq, "rk": sh.spec(*[None] * 6), "rv": sh.spec(*[None] * 6)}
    else:
        c_specs = {"k": seq, "v": seq}

    def make_fn(policy):
        def decode_step(params, cache, token, pos):
            x = _embed(params, token, cfg, policy)[:, None, :]
            for i in range(cfg.n_layers):
                lp = _layer(params, i)
                g, j = divmod(i, period)
                h = rms_norm(x, lp["ln1"])
                if j == n_local:                      # global: the whole sequence-split cache
                    c = (cache["k"][g], cache["v"][g]) if ring else (cache["k"][i], cache["v"][i])
                    a, _ = attention_decode(lp["attn"], h, {"k": c[0], "v": c[1]}, pos, cfg.attn,
                                            window=int(GLOBAL_WINDOW), policy=policy)
                elif ring:
                    a = _ring_decode(lp["attn"], h, cache["rk"][g, j], cache["rv"][g, j], pos, cfg.attn, policy)
                else:
                    start = min(max(pos - W + 1, 0), S - W)
                    a, _ = attention_decode(lp["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg.attn,
                                            window=W, policy=policy, span=(start, start + W))
                x = x + a
                f, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg, policy)
                x = x + f
            x = rms_norm(x, params["final_norm"])
            return _logits(params, x[:, 0], cfg, policy).float(), cache
        return decode_step

    def inputs(cell, seed, device, params):
        params = _draw_params(cell, plan, cell_dtype, seed, device, params)
        seq_block = sh.shard_slices(cache_plan.shape, seq, cell.coords)

        def layers(name, which):                      # the sequence-split cache of layers ``which``
            return torch.cat([draw_leaf(seed + 2, f"/cache/{name}", cache_plan, cell_dtype, device,
                                        (slice(l, l + 1),) + seq_block[1:]) for l in which])

        if ring:
            cache = {"k": layers("k", glob), "v": layers("v", glob)}
            slot_pos = pos - (pos - np.arange(W)) % W
            whole = (slice(0, B), slice(0, S), slice(0, Hk), slice(0, hd))
            for name in ("k", "v"):
                rings = torch.zeros((n_groups, n_local, B, W, Hk, hd), dtype=cell_dtype, device=device)
                if device.type != "meta":
                    ok = torch.as_tensor(slot_pos >= 0, device=device)
                    at = torch.as_tensor(np.maximum(slot_pos, 0), device=device)
                    for g in range(n_groups):
                        for j in range(n_local):
                            full = draw_leaf(seed + 2, f"/cache/{name}", cache_plan, cell_dtype, device,
                                             (slice(g * period + j, g * period + j + 1),) + whole)[0]
                            rings[g, j] = torch.where(ok[None, :, None, None], full[:, at], 0)
                            del full
                cache["r" + name] = rings
        else:
            cache = {name: layers(name, range(cfg.n_layers)) for name in ("k", "v")}
        if device.type == "meta":
            return params, cache, torch.empty((B,), dtype=torch.int64, device=device), pos
        token = np.random.default_rng(seed + 1).integers(0, cfg.vocab, B).astype(np.int64)
        return params, cache, torch.from_numpy(token).to(device), pos

    cell_dtype = torch.bfloat16
    return Cell(arch_id=spec.arch_id, shape_name=shape.name, kind="serve_step", shape=shape, cfg=cfg, policy=policy,
                make_fn=make_fn, make_rank_inputs=inputs, model_flops=2.0 * cfg.active_param_count() * B,
                param_specs=p_specs, in_specs=(p_specs, c_specs, sh.spec(None), ()),
                out_specs=(sh.spec(None, "model"), c_specs),
                note="two-stack sliding decode" + (" (ring)" if ring else " (slice)"))


def target4_gemma_cache(grid=None, shape=None) -> list[dict]:
    from repro_torch.launch.steps import build_cell

    spec, shape, grid = _defaults("gemma3-12b", "long_500k", grid, shape)
    out = []
    print("[T4] gemma3-12b × long_500k (sliding-window cache reads)")
    out.append(_measure(build_cell(spec, shape, grid), grid, "t4-baseline uniform reads"))
    print("  hypothesis: the baseline decode reads the full 524k cache in all"
          " 48 layers; only the 8 global layers need it — slicing the 40"
          " local layers to their 1024-token window cuts cache-read bytes to"
          " (8·524288 + 40·1024)/(48·524288) ≈ 17% → predicted ~6× lower"
          " memory term (the dominant term for this cell).")
    out.append(_measure(_gemma_twostack_cell(grid, spec, shape), grid, "t4-a two-stack sliced reads"))
    print("  iteration (the reference, on XLA): t4-a REFUTED the slicing route —"
          " dynamic_slice across the 256-way sequence sharding forces XLA to"
          " replicate the cache, blowing the collective term up. t4-b keeps a"
          " separate REPLICATED 1024-slot ring per local layer (315 MB total,"
          " slot = pos mod W): no cross-shard slicing at all.")
    out.append(_measure(_gemma_twostack_cell(grid, spec, shape, ring=True), grid,
                        "t4-b local ring buffers (replicated)"))
    return out


TARGETS = {"1": [target1_moe], "2": [target2_granite], "3": [target3_pna], "4": [target4_gemma_cache],
           "all": [target1_moe, target2_granite, target3_pna, target4_gemma_cache]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's §Perf hillclimb: four cells, baselines and variants, "
                                             "on the dry run's accounting.")
    ap.add_argument("--target", default="all", choices=list(TARGETS))
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    try:
        with open(args.out) as f:
            records = json.load(f)
    except FileNotFoundError:
        records = {}
    for t in TARGETS[args.target]:
        records[t.__name__] = t()
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
