"""The paper's GCN (Kipf–Welling [11]) with the COIN dataflow (§IV-C) — twin
of `repro.models.gcn`, unsharded.

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
(`repro_torch.train.loop.Trainer`). The halo (sharded) path arrives in a
later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dataflow import choose_order
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.device import resolve_device
from repro_torch.graph.ops import aggregate_padded
from repro_torch.graph.structure import BlockedAdjacency
from repro_torch.kernels.ops import fused_gcn_layer

__all__ = ["GCNConfig", "gcn_init", "params_from_numpy", "gcn_forward", "gcn_loss"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    layer_dims: tuple[int, ...]            # (F_in, hidden..., n_labels)
    dataflow: str = "auto"                 # auto | feature_first | aggregation_first
    quant: QuantConfig = QuantConfig(enabled=False)
    backend: str = "segment"               # segment | bsr | dense

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims) - 1


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


def params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """The reference package's parameters (as numpy arrays) as the port's, so
    that both compute the same thing."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in params.items()}


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
        nnz = None if lens is None else int(lens.sum())
        return vals, cols, lens, nnz, int(vals.shape[-1])
    raise ValueError(
        "backend='bsr' requires adjacency=BlockedAdjacency or its "
        f"(vals, cols, lens) arrays; got {type(adjacency).__name__}"
    )


def _validate_backend_args(cfg: GCNConfig, adjacency, dense_adj, device: torch.device):
    """Up-front argument validation with actionable errors (not asserts)."""
    if cfg.backend not in ("segment", "bsr", "dense"):
        raise ValueError(
            f"unknown GCN backend {cfg.backend!r}; expected 'segment', 'bsr', or 'dense'"
        )
    if cfg.backend == "dense" and dense_adj is None:
        raise ValueError("backend='dense' requires the dense_adj=(N, N) matrix")
    if cfg.backend == "bsr":
        if adjacency is None:
            raise ValueError(
                "backend='bsr' requires adjacency= (a BlockedAdjacency from "
                "repro_torch.graph.structure.blocked_adjacency, or its arrays)"
            )
        return _normalize_adjacency(adjacency, device)
    return None


def gcn_forward(
    params: dict,
    x: torch.Tensor,                       # (N, F)
    senders: torch.Tensor,                 # (E_pad,)
    receivers: torch.Tensor,               # (E_pad,)
    edge_weight: torch.Tensor,             # (E_pad,)
    cfg: GCNConfig,
    adjacency=None,                        # BlockedAdjacency (or tensors) for "bsr"
    dense_adj: torch.Tensor | None = None,  # (N, N) for "dense"
) -> torch.Tensor:
    n_nodes = x.shape[0]
    n_edges = int(senders.shape[0])
    q = cfg.quant
    adj = _validate_backend_args(cfg, adjacency, dense_adj, x.device)
    vals, cols, lens, nnz_blocks, block = adj if adj is not None else (None,) * 4 + (128,)

    def agg(z: torch.Tensor) -> torch.Tensor:
        if cfg.backend == "segment":
            return aggregate_padded(z, senders, receivers, n_nodes, edge_weight)
        return dense_adj @ z

    h = x
    for i in range(cfg.n_layers):
        w = params[f"w{i}"]
        if q.enabled:
            w = fake_quant(w, q.weight_bits)
            h = fake_quant(h, q.act_bits, percentile=q.act_percentile)
        d_in, d_out = w.shape
        order = _order(cfg, n_nodes, d_in, d_out, n_edges, nnz_blocks, block)
        last = i == cfg.n_layers - 1
        if cfg.backend == "bsr":
            h = fused_gcn_layer(
                vals, cols, lens, h, w, params[f"b{i}"], order=order, relu=not last
            )[:n_nodes]
            continue
        if order == "feature_first":
            h = agg(h @ w)                 # feature extraction (Fig. 5a), then aggregation
        else:
            h = agg(h) @ w
        h = h + params[f"b{i}"]
        if not last:
            h = torch.relu(h)              # activation unit (Fig. 3b)
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
    **fw_kwargs,
) -> torch.Tensor:
    logits = gcn_forward(params, x, senders, receivers, edge_weight, cfg, **fw_kwargs).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    per_node = (lse - gold) * label_mask
    return per_node.sum() / label_mask.sum().clamp_min(1.0)
