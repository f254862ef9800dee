"""The paper's GCN (Kipf–Welling [11]) with the COIN dataflow (§IV-C) — twin
of `repro.models.gcn`.

Each layer computes O = Ã · X · W with the multiplication order chosen by
the COIN rule (feature extraction first when d_out < d_in), optional fake
quantization of weights and activations (§V-B), and three aggregation
backends:

  * "segment" — `index_add_` over the edge list (reference; sparse),
  * "bsr"     — the ragged 128×128 blocked path: each layer is one
                `repro_torch.kernels.ops.fused_gcn_layer` call (transform,
                aggregation, bias and ReLU in the CUDA kernels of
                `repro_torch.kernels.fused_gcn` on the card; its backward
                is the reference's custom VJP), and the dataflow chooser
                sees the blocked cost model,
  * "dense"   — dense Ã matmul (small graphs only).

Every backend is differentiable, fake quantization through its
straight-through estimator, so `gcn_loss` trains under autograd
(`repro_torch.train.loop.Trainer`).

Communication: the aggregation gathers sender rows from
``policy.neighbor_table(z)``. Under an armed halo policy
(`repro_torch.dist.policy`, one rank of a `torch.distributed` group over a
`repro_torch.dist.halo.HaloPlan`) that table is ``[local ‖ halo]`` and only
boundary rows cross the wire (a flat plan's ``k·s_max`` rows, or a
hierarchical plan's member blocks after its two phases); otherwise it is
the identity. The halo path
takes ``backend="segment"`` (with the overlapped `split_halo_aggregate`
when ``policy.halo_overlap``) and ``backend="bsr"`` with this rank's
blocked table over the ``[local ‖ halo]`` columns
(`repro_torch.dist.halo.plan_blocked_rank`): aggregation-first layers stay
fused in one `fused_gcn_layer` call, whose table is cast to bf16 under the
bf16 wire, as the reference does (K2's bf16-operand kernel on the card);
feature-first layers exchange Z = X·W between the matmul and `bsr_spmm`
(K1). With ``adjacency_boundary`` (the split pair), each layer's
aggregation is an interior product over the local block plus a boundary
product over the halo block. Every halo branch differentiates: the
exchange's backward is the transposed collective
(`repro_torch.dist.halo`), and under the bf16 wire the fused
aggregation-first layer's backward recomputes Ã·table with K1's bf16
instantiation, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dataflow import choose_order
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.device import resolve_device
from repro_torch.dist.halo import split_halo_aggregate
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.ops import aggregate, aggregate_padded
from repro_torch.graph.structure import BlockedAdjacency
from repro_torch.kernels.ops import bsr_spmm, fused_gcn_layer
from repro_torch.nn.layers import Draw, params_from_numpy
from repro_torch.obs import trace as _obs_trace

__all__ = ["GCNConfig", "gcn_param_plan", "gcn_init", "params_from_numpy", "gcn_forward", "gcn_loss"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    layer_dims: tuple[int, ...]            # (F_in, hidden..., n_labels)
    dataflow: str = "auto"                 # auto | feature_first | aggregation_first
    quant: QuantConfig = QuantConfig(enabled=False)
    backend: str = "segment"               # segment | bsr | dense

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims) - 1


def gcn_param_plan(cfg: GCNConfig) -> dict:
    """`gcn_init`'s leaves as a plan (`repro_torch.nn.layers.Draw`):
    Glorot-normal weights, zero biases."""
    plan = {}
    for i, (d_in, d_out) in enumerate(zip(cfg.layer_dims[:-1], cfg.layer_dims[1:])):
        plan[f"w{i}"] = Draw((d_in, d_out), std=(2.0 / (d_in + d_out)) ** 0.5)
        plan[f"b{i}"] = Draw((d_out,), "zeros")
    return plan


def gcn_init(generator: torch.Generator, cfg: GCNConfig, dtype=torch.float32,
             device: str | torch.device | None = None) -> dict:
    """Glorot-normal weights and zero biases, drawn on the host from
    ``generator`` (so a seed gives the same weights on every device), then
    moved to ``device``."""
    device = resolve_device(device)
    params = {}
    for i, (d_in, d_out) in enumerate(zip(cfg.layer_dims[:-1], cfg.layer_dims[1:])):
        std = (2.0 / (d_in + d_out)) ** 0.5
        w = torch.randn((d_in, d_out), generator=generator, dtype=dtype) * std
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return params


def _order(
    cfg: GCNConfig, n_nodes: int, d_in: int, d_out: int, n_edges: int,
    nnz_blocks: int | None = None, block: int = 128,
) -> str:
    if cfg.dataflow != "auto":
        return cfg.dataflow
    if cfg.backend == "bsr" and nnz_blocks is not None:
        # Density-aware: the bsr backend's aggregation cost is per nonzero
        # 128×128 tile, not per edge.
        return choose_order(
            n_nodes, d_in, d_out, backend="bsr", nnz_blocks=nnz_blocks, block=block
        )
    return choose_order(n_nodes, d_in, d_out, n_edges=n_edges)


def _normalize_adjacency(adjacency, device: torch.device):
    """Validate/unpack the ``adjacency`` argument of :func:`gcn_forward`.

    Accepts a :class:`~repro_torch.graph.structure.BlockedAdjacency` (its
    arrays are moved to ``device``), a ``(vals, cols, lens)`` tensor triple,
    or the ``(vals, cols)`` pair (every tile treated as valid). Returns
    ``(vals, cols, lens_or_None, nnz_blocks_or_None, block)``.
    """
    if isinstance(adjacency, BlockedAdjacency):
        vals, cols, lens = adjacency.arrays(device=device)
        return vals, cols, lens, adjacency.nnz_blocks, adjacency.block
    if isinstance(adjacency, (tuple, list)):
        if len(adjacency) == 3:
            vals, cols, lens = adjacency
        elif len(adjacency) == 2:
            (vals, cols), lens = adjacency, None
        else:
            raise ValueError(
                "backend='bsr' adjacency must be a BlockedAdjacency, "
                "(vals, cols, lens), or (vals, cols) — got a "
                f"{len(adjacency)}-tuple"
            )
        if getattr(vals, "ndim", 0) != 4 or getattr(cols, "ndim", 0) != 2:
            raise ValueError(
                "backend='bsr' adjacency arrays must be vals (R, T, B, B) and "
                f"cols (R, T); got shapes {getattr(vals, 'shape', None)} and "
                f"{getattr(cols, 'shape', None)}"
            )
        # A meta tensor (the dry run) has no count to read: it takes the
        # reference's Tracer branch (nnz None), whose chooser falls back to
        # the edge model.
        nnz = None
        if lens is not None and lens.device.type != "meta":
            with _obs_trace.span("sync.nnz_blocks"):
                nnz = int(lens.sum())
        return vals, cols, lens, nnz, int(vals.shape[-1])
    raise ValueError(
        "backend='bsr' requires adjacency=BlockedAdjacency or its "
        f"(vals, cols, lens) arrays; got {type(adjacency).__name__}"
    )


def _validate_backend_args(
    cfg: GCNConfig, policy: ShardingPolicy, adjacency, dense_adj, adjacency_boundary,
    device: torch.device,
):
    """Up-front argument validation with actionable errors (not asserts)."""
    if cfg.backend not in ("segment", "bsr", "dense"):
        raise ValueError(
            f"unknown GCN backend {cfg.backend!r}; expected 'segment', 'bsr', or 'dense'"
        )
    if adjacency_boundary is not None and not (cfg.backend == "bsr" and policy.is_halo):
        raise ValueError(
            "adjacency_boundary is the overlapped halo-bsr split "
            "(repro_torch.dist.halo.plan_split_blocked_adjacency) and requires "
            "backend='bsr' under an armed halo policy"
        )
    if cfg.backend == "dense":
        if policy.is_halo:
            raise ValueError(
                "halo comm supports the 'segment' and 'bsr' backends; 'dense' "
                "materializes the global adjacency and cannot run per-shard"
            )
        if dense_adj is None:
            raise ValueError("backend='dense' requires the dense_adj=(N, N) matrix")
    if cfg.backend == "bsr":
        if adjacency is None:
            raise ValueError(
                "backend='bsr' requires adjacency= (a BlockedAdjacency from "
                "repro_torch.graph.structure.blocked_adjacency, or — under halo — "
                "this rank's table from repro_torch.dist.halo.plan_blocked_rank)"
            )
        return _normalize_adjacency(adjacency, device)
    return None


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion: a bf16 operand meeting an fp32 one is
    promoted to fp32 (torch.matmul refuses mixed dtypes)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype) @ b.to(dtype)


def gcn_forward(
    params: dict,
    x: torch.Tensor,                       # (N, F)
    senders: torch.Tensor,                 # (E_pad,)
    receivers: torch.Tensor,               # (E_pad,)
    edge_weight: torch.Tensor,             # (E_pad,)
    cfg: GCNConfig,
    policy: ShardingPolicy = NO_POLICY,
    adjacency=None,                        # BlockedAdjacency (or tensors) for "bsr"
    dense_adj: torch.Tensor | None = None,  # (N, N) for "dense"
    adjacency_boundary=None,               # halo-bsr overlap: the boundary table of
                                           # the split pair (adjacency= is then the
                                           # interior one)
) -> torch.Tensor:
    n_nodes = x.shape[0]
    n_edges = int(senders.shape[0])
    q = cfg.quant
    adj = _validate_backend_args(cfg, policy, adjacency, dense_adj, adjacency_boundary, x.device)
    vals, cols, lens, nnz_blocks, block = adj if adj is not None else (None,) * 4 + (128,)
    adj_b = (
        _normalize_adjacency(adjacency_boundary, x.device)
        if adjacency_boundary is not None
        else None
    )
    if policy.is_halo:
        # The reference runs the halo path inside shard_map, where the tile
        # counts are traced values: its chooser falls back to the edge model
        # over this rank's rows and padded edges. So does the port.
        nnz_blocks = None
    # Unsharded bsr runs the whole layer in one fused call; under halo only
    # aggregation-first layers can fuse (the boundary exchange sits between
    # X·W and the aggregation on feature-first layers).
    fused = cfg.backend == "bsr" and not policy.is_halo
    overlap = policy.is_halo and policy.halo_overlap

    def agg(z: torch.Tensor) -> torch.Tensor:
        if policy.is_halo:
            # Senders index [local ‖ halo]; padding edges carry weight 0.
            if cfg.backend == "bsr":
                if adj_b is not None:
                    # Overlapped split: the interior product reads only the
                    # local block; only the boundary product waits on the wire.
                    b_vals, b_cols, b_lens = adj_b[0], adj_b[1], adj_b[2]
                    halo = policy.halo_block(z)
                    interior = bsr_spmm(vals, cols, z, lens=lens)[:n_nodes]
                    boundary = bsr_spmm(b_vals, b_cols, halo, lens=b_lens)[:n_nodes]
                    return interior + boundary
                return bsr_spmm(vals, cols, policy.neighbor_table(z), lens=lens)[:n_nodes]
            if overlap:
                return split_halo_aggregate(
                    z, policy.halo_block(z), senders, receivers, edge_weight
                )
            return aggregate(policy.neighbor_table(z), senders, receivers, n_nodes, edge_weight)
        if policy.is_broadcast:
            # Fig. 5c: senders index the all-gathered node table; padding
            # edges carry weight 0.
            return aggregate(policy.neighbor_table(z), senders, receivers, n_nodes, edge_weight)
        if cfg.backend == "segment":
            return aggregate_padded(z, senders, receivers, n_nodes, edge_weight)
        return dense_adj @ z

    h = x
    for i in range(cfg.n_layers):
        w = params[f"w{i}"]
        if q.enabled:
            # Under halo each rank calibrates on its own block, padding rows
            # included, as the reference does inside shard_map.
            w = fake_quant(w, q.weight_bits)
            h = fake_quant(h, q.act_bits, percentile=q.act_percentile)
        d_in, d_out = w.shape
        order = _order(cfg, n_nodes, d_in, d_out, n_edges, nnz_blocks, block)
        last = i == cfg.n_layers - 1
        if fused:
            h = fused_gcn_layer(
                vals, cols, lens, h, w, params[f"b{i}"], order=order, relu=not last
            )[:n_nodes]
            continue
        if (
            cfg.backend == "bsr" and policy.is_halo
            and order == "aggregation_first" and adj_b is None
        ):
            # Exchange h, then one fused (Ã·table)·W + b + act call. With a
            # bf16 wire the table enters the kernel in bf16 (fp32
            # accumulation) and the layer's output is bf16, as in the
            # reference.
            table = policy.neighbor_table(h)
            if policy.halo_payload == "bf16":
                table = table.to(torch.bfloat16)
            h = fused_gcn_layer(
                vals, cols, lens, table, w, params[f"b{i}"],
                order="aggregation_first", relu=not last,
            )[:n_nodes]
            continue
        if order == "feature_first":
            z = policy.constrain(_matmul(h, w), "node_hidden")   # feature extraction (Fig. 5a)
            h = agg(z)                                           # aggregation (Fig. 5b)
        else:
            z = policy.constrain(agg(h), "node_hidden")
            h = _matmul(z, w)
        h = h + params[f"b{i}"]
        if not last:
            h = torch.relu(h)              # activation unit (Fig. 3b)
        h = policy.constrain(h, "node_hidden")
    return h


def gcn_loss(
    params: dict,
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_weight: torch.Tensor,
    labels: torch.Tensor,                  # (N,) int
    label_mask: torch.Tensor,              # (N,) float32
    cfg: GCNConfig,
    policy: ShardingPolicy = NO_POLICY,
    **fw_kwargs,
) -> torch.Tensor:
    logits = gcn_forward(params, x, senders, receivers, edge_weight, cfg, policy, **fw_kwargs).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    per_node = (lse - gold) * label_mask
    return per_node.sum() / label_mask.sum().clamp_min(1.0)
