"""Registry mapping --arch ids to model configs — twin of
`repro.configs.registry` for the architectures the port has reached.

Every id the reference knows is known here; an id whose model the port has
not reached yet raises `NotImplementedError` instead of a config.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "ALL_ARCHS"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture × input-shape) cell (the graph fields)."""

    name: str
    kind: str                      # graph
    n_nodes: int | None = None
    n_edges: int | None = None
    d_feat: int | None = None
    n_out: int | None = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    source: str                    # citation tag
    make_config: Callable[..., Any]          # (shape: ShapeSpec|None) -> model config
    make_reduced: Callable[[], Any]          # smoke-test config
    shapes: dict[str, ShapeSpec]


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

_MODULES = {"coin_gcn": "repro_torch.configs.coin_gcn"}


def get_arch(arch_id: str) -> ArchSpec:
    # Accept the hyphenated spelling of underscore ids (coin-gcn == coin_gcn).
    if arch_id not in ALL_ARCHS and arch_id.replace("-", "_") in ALL_ARCHS:
        arch_id = arch_id.replace("-", "_")
    if arch_id not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_ARCHS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to PyTorch yet; ported: {sorted(_MODULES)}"
        )
    return importlib.import_module(_MODULES[arch_id]).SPEC
