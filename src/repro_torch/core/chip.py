"""COIN chip capacity model (paper §IV-A, §V-C) — twin of `repro.core.chip`.

This is the paper's accelerator, not the card the port runs on: 128×128
RRAM crossbar PEs at 2 bits/cell, 16 PEs per tile, 30 tiles per CE (6×5
mesh), 16 CEs per chip, 30 MB of on-chip memory (30 MB / (16 CEs · 30
tiles) = 64 KB per tile = 16 PEs of 128·128·2 bits). Large GCNs use
several chips (§V-C: Cora 1, Citeseer 1, Pubmed 3, Ext. Cora 20, Nell 45).
Each CE stores an N × (N/k_total) adjacency slice mapped "as is" onto
crossbars (⌈N/128⌉ × ⌈cols/128⌉ arrays) plus the layer weights. The
crossbar-granular count reproduces Cora, Citeseer and Nell, the
cell-granular one Pubmed; Ext. Cora's 20 follows from neither. Pure
Python, copied: the counts equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = ["ChipModel", "chips_required"]


@dataclasses.dataclass(frozen=True)
class ChipModel:
    crossbar_rows: int = 128
    crossbar_cols: int = 128
    bits_per_cell: int = 2
    pes_per_tile: int = 16
    tiles_per_ce: int = 30          # 6×5 mesh (§IV-A)
    ces_per_chip: int = 16          # 4×4 mesh (§IV-B3)
    max_adj_tiles_per_ce: int = 23  # paper: adjacency needs 10–23 tiles
    weight_bits: int = 4            # 4-bit quantization (§V-B)
    adj_cells_per_entry: int = 1    # one RRAM cell per adjacency entry

    @property
    def cells_per_pe(self) -> int:
        return self.crossbar_rows * self.crossbar_cols

    @property
    def cells_per_chip(self) -> int:
        return self.cells_per_pe * self.pes_per_tile * self.tiles_per_ce * self.ces_per_chip

    @property
    def bytes_per_chip(self) -> int:
        return self.cells_per_chip * self.bits_per_cell // 8

    def weight_crossbars(self, layer_dims: Sequence[int]) -> int:
        """Crossbars to hold all layer weights (stored column-wise, §IV-C2)."""
        cells_per_weight = max(1, self.weight_bits // self.bits_per_cell)
        total = 0
        for d_in, d_out in zip(layer_dims[:-1], layer_dims[1:]):
            rows = math.ceil(d_in / self.crossbar_rows)
            cols = math.ceil(d_out * cells_per_weight / self.crossbar_cols)
            total += rows * cols
        return total

    def adjacency_crossbars_total(self, n_nodes: int) -> int:
        """Total crossbars tiling the full N×N adjacency at 128×128 blocks."""
        rows = math.ceil(n_nodes / self.crossbar_rows)
        cols = math.ceil(n_nodes * self.adj_cells_per_entry / self.crossbar_cols)
        return rows * cols

    def adjacency_budget_per_ce(self, layer_dims: Sequence[int]) -> int:
        """Crossbars a CE can devote to adjacency: the paper's ≤23-tile cap,
        further reduced if the (replicated) weights overflow their 7 tiles."""
        pe_per_ce = self.pes_per_tile * self.tiles_per_ce
        w = self.weight_crossbars(layer_dims)
        return min(self.max_adj_tiles_per_ce * self.pes_per_tile, pe_per_ce - w)


def chips_required(
    model: ChipModel, n_nodes: int, layer_dims: Sequence[int], mode: str = "crossbar"
) -> int:
    """Chips needed for one GCN (§V-C: Cora 1, Citeseer 1, Pubmed 3,
    Ext. Cora 20, Nell 45).

    mode="crossbar" — crossbar-granular: the N×N adjacency is tiled into
      128×128 blocks packed across CEs, each CE capped at 23 adjacency tiles
      and holding a replicated weight copy. Reproduces Cora/Citeseer (1) and
      Nell (45) exactly.
    mode="cell" — cell-granular capacity (N²·cells / chip cells). Reproduces
      Pubmed (3). Ext. Cora's published 20 is not derivable from the stated
      parameters under either accounting.
    """
    if mode == "cell":
        cells = n_nodes * n_nodes * model.adj_cells_per_entry
        return max(1, math.ceil(cells / model.cells_per_chip))
    budget = model.adjacency_budget_per_ce(layer_dims)
    if budget <= 0:
        raise ValueError("weights alone overflow a CE")
    total = model.adjacency_crossbars_total(n_nodes)
    ces = math.ceil(total / budget)
    return max(1, math.ceil(ces / model.ces_per_chip))
