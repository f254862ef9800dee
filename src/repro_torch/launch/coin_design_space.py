"""Design-space exploration: the COIN objective at chip scale (the paper's
Fig. 9/19) and on a group of GPUs — twin of
``examples/coin_design_space.py``.

    PYTHONPATH=src python -m repro_torch.launch.coin_design_space

The same communication-balance criterion picks both the 4×4 CE mesh of
COIN's chip and the model-parallel degree of the distributed GCN. The
chip-scale lines are the reference's, character for character (the energy
model and solver are copies). The pod-scale lines use
`repro_torch.core.planner` with the H100's data-sheet rates
(`GPUHardware`), so they differ from the reference's, whose planner holds
a TPU's; ``main(hw=...)`` takes other rates. Host arithmetic only: no card.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.energy import model_from_gcn
from repro_torch.core.planner import GPUHardware, plan_gnn_sharding
from repro_torch.core.solver import SQUARE_MESHES, mesh_sweep, optimal_ce_count
from repro_torch.graph.generators import TABLE_I

__all__ = ["main"]


def main(hw: GPUHardware = GPUHardware()) -> None:
    print("== chip scale: CE-count sweep (paper Fig. 9) ==")
    for name, spec in TABLE_I.items():
        m = model_from_gcn(spec.n_nodes, [spec.n_features, 16, spec.n_labels], 4)
        sweep = mesh_sweep(m)
        best = min(sweep, key=sweep.get)
        side = int(np.sqrt(best))
        res = optimal_ce_count(m)
        norm = {k: v / max(sweep.values()) for k, v in sweep.items()}
        bar = " ".join(f"{k}:{norm[k]:.2f}" for k in SQUARE_MESHES)
        print(f"  {name:9s} best={side}x{side} k*={res.k_star:5.1f}  E/Emax: {bar}")

    print("\n== pod scale: model-parallel degree via the same objective ==")
    for name, spec in TABLE_I.items():
        for schedule in ("broadcast", "halo"):
            plan = plan_gnn_sharding(
                spec.n_nodes, spec.n_edges, [spec.n_features, 16, spec.n_labels],
                n_devices=256, hw=hw, schedule=schedule,
                cut_fraction=0.3 if schedule == "halo" else None,
            )
            print(f"  {name:9s} [{schedule:9s}] model={plan.model_shards:3d} "
                  f"data={plan.data_shards:3d} est_step={plan.est_step_s*1e6:7.1f}µs "
                  f"dominant={plan.dominant}")


if __name__ == "__main__":
    main()
