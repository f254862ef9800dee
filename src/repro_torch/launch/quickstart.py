"""Quickstart: the COIN methodology end-to-end on a Cora-statistics graph —
twin of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] [--backend bsr]

1. synthesize a graph with Cora's published shape (2708 nodes / 10556 edges),
2. find the optimal CE count with the paper's interior-point solver (→ 4×4),
3. partition the graph onto the CEs and measure connection probabilities,
4. push the layer-exchange traffic through the mesh-NoC model (energy/latency),
5. train the paper's 2-layer GCN with the COIN feature-first dataflow and
   4-bit quantization, and report accuracy.

Steps 1–4 are host numpy and print the reference's numbers. Step 5 trains
on ``--device`` (the CUDA card by default) with the segment backend, as the
reference does, or with ``--backend bsr``: the ragged blocked tables and
the port's kernels. Parameters come from a seeded `torch.Generator`, so the
loss trajectory differs from the reference's by its initialization.
"""
from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from repro_torch.core.energy import CoinEnergyModel
from repro_torch.core.noc import MeshNoC
from repro_torch.core.partition import measured_probabilities, partition_graph
from repro_torch.core.quant import QuantConfig
from repro_torch.core.solver import optimal_ce_count
from repro_torch.device import resolve_device
from repro_torch.graph.generators import DatasetSpec, make_dataset
from repro_torch.graph.structure import GraphData, blocked_adjacency, to_padded
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init, gcn_loss
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import adam

__all__ = ["analytic_steps", "train_gcn", "main"]


def analytic_steps(spec: DatasetSpec, g: GraphData, log: Callable[[str], None] = print) -> dict:
    """Steps 2–4: the optimal CE count, then the NoC cost of one layer
    exchange on the chosen mesh. Returns the numbers it prints."""
    part16 = partition_graph(g.n_nodes, g.edge_index, 16, method="bfs", seed=0, refine=True)
    p1, p2 = measured_probabilities(part16)
    model = CoinEnergyModel(
        n_nodes=g.n_nodes, act_bits_sum=spec.hidden * 4,
        p_intra=float(p1.mean()), p_inter=float(p2.sum() / (16 * 15)),
    )
    res = optimal_ce_count(model)
    log(f"[2] optimal CEs: k*={res.k_star:.1f} → {res.mesh_shape[0]}×{res.mesh_shape[1]} mesh "
        f"(solve {res.solve_ms:.1f} ms; paper: 4×4, 10 ms)")

    part = partition_graph(g.n_nodes, g.edge_index, res.k_mesh, method="bfs", seed=0, refine=True)
    noc = MeshNoC(*res.mesh_shape)
    s = noc.summarize(part.inter_ce_traffic_bits(spec.hidden * 4, broadcast=True))
    halo = noc.summarize(part.inter_ce_traffic_bits(spec.hidden * 4, broadcast=False))
    log(f"[3] inter-CE exchange: {s.total_bits/8e3:.1f} kB, {s.latency_cycles:.0f} cycles "
        f"(beyond-paper halo: {halo.total_bits/8e3:.1f} kB)")
    return dict(k_star=res.k_star, mesh_shape=tuple(res.mesh_shape), exchange_bits=s.total_bits,
                exchange_cycles=s.latency_cycles, halo_bits=halo.total_bits)


def train_gcn(
    spec: DatasetSpec, g: GraphData, backend: str = "segment", epochs: int = 100,
    device: str | torch.device | None = None, log: Callable[[str], None] = print,
) -> tuple[list[float], float]:
    """Step 5: train the 2-layer 4-bit GCN with Adam on the nodes whose id is
    not a multiple of 4, on the ``backend`` aggregation; returns the loss of
    every epoch and the accuracy on the other nodes."""
    device = resolve_device(device)
    gs = g.symmetrized().with_self_loops()
    weights = gs.sym_normalized_weights()
    pg = to_padded(gs, weights=weights, device=device)
    cfg = GCNConfig(
        layer_dims=(spec.n_features, spec.hidden, spec.n_labels),
        dataflow="auto",
        quant=QuantConfig(4, 4, enabled=True),
        backend=backend,
    )
    kw = {"adjacency": blocked_adjacency(g.n_nodes, gs.edge_index, weights)} if backend == "bsr" else {}
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device=device)
    feats = torch.from_numpy(np.asarray(g.features, np.float32)).to(device)
    labels = torch.from_numpy(g.labels).to(device)
    mask = (torch.arange(spec.n_nodes, device=device) % 4 != 0).float()
    opt = adam(1e-2)
    state = opt.init(params)

    def loss_fn(p, _):
        return gcn_loss(p, feats, pg.senders, pg.receivers, pg.edge_weight, labels, mask, cfg, **kw)

    losses = []
    for epoch in range(epochs):
        loss, grads = value_and_grad(loss_fn, params, None)
        with torch.no_grad():
            params, state = opt.update(grads, state, params)
        losses.append(float(loss))
        if epoch % 25 == 0:
            log(f"    epoch {epoch:3d}: loss={losses[-1]:.4f}")
    with torch.no_grad():
        logits = gcn_forward(params, feats, pg.senders, pg.receivers, pg.edge_weight, cfg, **kw)
    test = 1.0 - mask
    acc = float(((logits.argmax(-1) == labels) * test).sum() / test.sum())
    log(f"[4] 4-bit GCN test accuracy: {acc:.3f} "
        f"(dataflow order: {cfg.dataflow} → feature-first, §IV-C3; backend {backend})")
    return losses, acc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for step 5 (default: the CUDA card; 'cpu' runs on the host)")
    ap.add_argument("--backend", default="segment", choices=("segment", "bsr"))
    args = ap.parse_args(argv)
    spec, g = make_dataset("cora")
    print(f"[1] dataset: {spec.name}: N={spec.n_nodes} E={spec.n_edges} "
          f"F={spec.n_features} C={spec.n_labels}")
    analytic_steps(spec, g)
    train_gcn(spec, g, backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
