"""Registry mapping --arch ids to model configs and their input shapes —
twin of `repro.configs.registry`: every id the reference knows."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "lm_shapes", "gnn_shapes", "recsys_shapes", "ALL_ARCHS"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture × input-shape) cell (the LM, graph and recsys fields)."""

    name: str
    kind: str                      # train | prefill | decode | serve | retrieval | graph
    # LM fields
    seq_len: int | None = None
    global_batch: int | None = None
    # GNN fields
    n_nodes: int | None = None
    n_edges: int | None = None
    d_feat: int | None = None
    n_out: int | None = None
    batch_nodes: int | None = None
    fanout: tuple[int, ...] | None = None
    n_graphs: int | None = None
    # recsys fields
    batch: int | None = None
    n_candidates: int | None = None
    skip_reason: str | None = None  # e.g. full-attention arch on long_500k


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    source: str                    # citation tag
    make_config: Callable[..., Any]          # (shape: ShapeSpec|None) -> model config
    make_reduced: Callable[[], Any]          # smoke-test config
    shapes: dict[str, ShapeSpec]


def lm_shapes(sub_quadratic: bool) -> dict[str, ShapeSpec]:
    """The LM shape set. long_500k runs only for sub-quadratic
    (sliding-window) archs; the others record why it is skipped."""
    skip = None if sub_quadratic else "pure full-attention arch: 524k dense KV on every layer; skipped per assignment (DESIGN.md §4)"
    return {
        "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
        "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
        "long_500k": ShapeSpec(
            "long_500k", "decode", seq_len=524288, global_batch=1, skip_reason=skip
        ),
    }


def gnn_shapes() -> dict[str, ShapeSpec]:
    """The GNN shape set (the reference's): Cora at full batch, Reddit's size
    as sampled blocks, ogbn-products at full batch, and packed molecules."""
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "graph", n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7
        ),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg",
            "graph",
            n_nodes=232_965,
            n_edges=114_615_892,
            d_feat=602,
            n_out=41,
            batch_nodes=1024,
            fanout=(15, 10),
        ),
        "ogb_products": ShapeSpec(
            "ogb_products", "graph", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_out=47
        ),
        "molecule": ShapeSpec(
            "molecule",
            "graph",
            n_nodes=30,
            n_edges=64,
            d_feat=16,
            n_out=1,
            n_graphs=128,
        ),
    }


def recsys_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", batch=65_536),
        "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262_144),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
    }


ALL_ARCHS: tuple[str, ...] = (
    "moonshot-v1-16b-a3b",
    "olmoe-1b-7b",
    "gemma3-12b",
    "granite-34b",
    "stablelm-12b",
    "egnn",
    "graphcast",
    "equiformer-v2",
    "pna",
    "deepfm",
    "coin_gcn",
)

_MODULES = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "egnn": "repro_torch.configs.egnn",
    "graphcast": "repro_torch.configs.graphcast",
    "pna": "repro_torch.configs.pna",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "deepfm": "repro_torch.configs.deepfm",
    "coin_gcn": "repro_torch.configs.coin_gcn",
}


def get_arch(arch_id: str) -> ArchSpec:
    # Accept the hyphenated spelling of underscore ids (coin-gcn == coin_gcn).
    if arch_id not in ALL_ARCHS and arch_id.replace("-", "_") in ALL_ARCHS:
        arch_id = arch_id.replace("-", "_")
    if arch_id not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_ARCHS)}")
    return importlib.import_module(_MODULES[arch_id]).SPEC
