"""Training driver — twin of `repro.launch.train` for the architectures the
port has reached:

    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 60 --device cpu \
        --relocalize-threshold 1.01

Runs the REDUCED config of ``--arch`` on one device (the CUDA card unless
``--device`` names another): synthetic data → eager train step → AdamW →
checkpointing → straggler monitor, resuming from the latest checkpoint
under ``--ckpt-dir``. For ``coin_gcn`` this is the reference's
``_gnn_setup`` branch: ``citation_like(256, 1024, seed=0)``, the reduced
GCN config (segment backend, 4-bit QAT) and `gcn_loss`. For ``deepfm`` it
is ``_recsys_setup``: the reduced DeepFM config (8 fields, MLP 32-32-32),
batches of 256 from the seeded `click_batch_fn` stream and `deepfm_loss`
(its FM term runs K3 on the card). Parameters come from a seeded
`torch.Generator`, so they differ from the reference's.

``--relocalize-threshold T`` (> 0, ``coin_gcn`` only) churns the training
graph as the reference does: every 10 steps one delta deletes 1 % of the
edges and inserts as many among 16 random nodes (E stays fixed), applied
to a `DeltaPlanner` over a 4-part BFS partition whose `RelocalizePolicy`
(threshold T, patience 2, cooldown 3) re-localizes online; each fire prints
the reference's ``relocalize @ step N: executed tiles A → B`` line, and the
batch takes the planner's current edges and weights.
"""
from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.graph.generators import citation_like
from repro_torch.launch.obsflags import add_obs_args, obs_session
from repro_torch.models.gcn import gcn_init, gcn_loss
from repro_torch.train.data import ShardedStream, click_batch_fn
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import adamw

__all__ = ["main"]

# The slice of the port (ROADMAP.md) that brings each architecture not ported yet.
_WAITING = {
    **dict.fromkeys(("gemma3-12b", "granite-34b", "stablelm-12b"),
                    "the LM slice's training part (lm_loss gradients and an attention backward for K4)"),
    **dict.fromkeys(("moonshot-v1-16b-a3b", "olmoe-1b-7b"),
                    "the LM slice's training part and the MoE slice (nn/moe.py)"),
    **dict.fromkeys(("egnn", "graphcast", "equiformer-v2", "pna"), "the slice of the other GNN families"),
}


def _gcn_setup(spec, device: torch.device, relocalize_threshold: float = 0.0):
    """(params, loss_fn, batches) of the reduced coin_gcn on the reference's
    synthetic citation graph; churned under a relocalize policy when
    ``relocalize_threshold`` > 0 (module docstring)."""
    cfg = spec.make_reduced()
    g = citation_like(256, 1024, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.n_nodes, cfg.layer_dims[0])).astype(np.float32)
    batch = {
        "feats": torch.from_numpy(feats),
        "senders": torch.from_numpy(g.edge_index[0]),
        "receivers": torch.from_numpy(g.edge_index[1]),
        "edge_weight": torch.ones(g.n_edges),
        "labels": torch.from_numpy(g.labels),
        "label_mask": torch.ones(g.n_nodes),
    }
    batch = {k: v.to(device) for k, v in batch.items()}
    params = gcn_init(torch.Generator().manual_seed(0), cfg, device=device)

    def loss(params, b):
        return gcn_loss(params, b["feats"], b["senders"], b["receivers"], b["edge_weight"],
                        b["labels"], b["label_mask"], cfg)

    if relocalize_threshold <= 0:
        def batches():
            while True:
                yield batch

        return params, loss, batches

    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.delta import DeltaPlanner, GraphDelta, RelocalizePolicy

    part = partition_graph(g.n_nodes, g.edge_index, 4, "bfs", seed=0, refine=True)
    planner = DeltaPlanner(
        part, g.edge_index, graph_key=f"launch-train-{spec.arch_id}",
        relocalize_policy=RelocalizePolicy(threshold=relocalize_threshold, patience=2, cooldown=3))
    churn = np.random.default_rng(1)

    def batches():
        step = 0
        while True:
            yield batch
            step += 1
            if step % 10:
                continue
            ei = planner.edge_index()
            m = max(ei.shape[1] // 100, 2)
            drop = churn.choice(ei.shape[1], m, replace=False)
            mem = churn.choice(g.n_nodes, 16, replace=False)
            s = mem[churn.integers(0, mem.size, m)]
            d = mem[churn.integers(0, mem.size, m)]
            bad = s == d
            d[bad] = mem[(np.searchsorted(np.sort(mem), d[bad]) + 1) % mem.size]
            rep = planner.apply(GraphDelta(edge_inserts=np.stack([s, d]), edge_deletes=ei[:, drop]))
            if rep["relocalized"] is not None:
                r = rep["relocalized"]
                print(f"  relocalize @ step {step}: executed tiles "
                      f"{r['executed_tiles_before']} → {r['executed_tiles_after']}")
            new_ei = planner.edge_index()
            batch["senders"] = torch.from_numpy(new_ei[0].astype(np.int32)).to(device)
            batch["receivers"] = torch.from_numpy(new_ei[1].astype(np.int32)).to(device)
            batch["edge_weight"] = torch.from_numpy(planner.edge_weights()).to(device)

    return params, loss, batches


def _recsys_setup(spec, device: torch.device, batch: int = 256):
    """(params, loss_fn, batches) of the reduced DeepFM on the seeded click
    stream; ids go to the device as int64 once per batch."""
    from repro_torch.models.deepfm import deepfm_init, deepfm_loss

    cfg = spec.make_reduced()
    params = deepfm_init(torch.Generator().manual_seed(0), cfg, device=device)
    stream = ShardedStream(click_batch_fn(cfg.n_fields, cfg.rows_per_field), global_batch=batch, seed=0)

    def batches():
        for b in stream:
            yield {"ids": torch.from_numpy(b["ids"]).to(device, torch.int64),
                   "labels": torch.from_numpy(b["labels"]).to(device)}

    return params, (lambda p, b: deepfm_loss(p, b["ids"], b["labels"], cfg)), batches


_SETUPS = {"coin_gcn": _gcn_setup, "deepfm": _recsys_setup}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--relocalize-threshold", type=float, default=0.0,
                    help="drift ratio beyond which the churned training graph "
                         "re-localizes online (0 = static graph; coin_gcn only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    with obs_session(args):
        run(args)


def run(args) -> None:
    if args.arch not in _SETUPS:
        raise NotImplementedError(
            f"--arch {args.arch} is not ported to PyTorch yet; it comes with {_WAITING[args.arch]} "
            "(ROADMAP.md)"
        )
    setup = _SETUPS[args.arch]
    if args.relocalize_threshold > 0:
        if args.arch != "coin_gcn":
            raise SystemExit("--relocalize-threshold churns a graph: coin_gcn only")
        setup = functools.partial(setup, relocalize_threshold=args.relocalize_threshold)
    params, loss_fn, batches = setup(get_arch(args.arch), resolve_device(args.device))
    tr = Trainer(
        loss_fn,
        adamw(args.lr),
        params,
        TrainerConfig(ckpt_dir=args.ckpt_dir, log_every=10, compress_grads=args.compress_grads),
    )
    if args.ckpt_dir:
        tr.resume()
    losses = tr.fit(batches(), max_steps=args.steps)
    print(f"{args.arch}: loss {losses[0]:.4f} → {losses[-1]:.4f} over {len(losses)} steps")


if __name__ == "__main__":
    main()
