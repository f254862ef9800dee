"""Training driver — twin of `repro.launch.train` for the architectures the
port has reached:

    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch pna --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 60 --device cpu \
        --relocalize-threshold 1.01

Runs the REDUCED config of ``--arch`` on one device (the CUDA card unless
``--device`` names another): synthetic data → eager train step → AdamW →
checkpointing → straggler monitor, resuming from the latest checkpoint
under ``--ckpt-dir``. For a GNN (``coin_gcn``, ``pna``, ``egnn``,
``graphcast``) this is the reference's ``_gnn_setup``:
``citation_like(256, 1024, seed=0)``, the reduced config, seeded
``default_rng(0)`` features (then ``pos`` for egnn, random ``edge_feats``
for graphcast, and a 0.1-scaled regression target), and the loss of
`repro_torch.launch.steps._gnn_loss_fn` (for coin_gcn `gcn_loss` with the
segment backend and 4-bit QAT). For ``deepfm`` it
is ``_recsys_setup``: the reduced DeepFM config (8 fields, MLP 32-32-32),
batches of 256 from the seeded `click_batch_fn` stream and `deepfm_loss`
(its FM term runs K3 on the card). For an LM id (gemma3-12b,
stablelm-12b, granite-34b, olmoe-1b-7b, moonshot-v1-16b-a3b) it is
``_lm_setup``: the reduced config, batches of 4 sequences of 64 tokens (+1
for the labels) from the seeded `token_batch_fn` stream and `lm_loss` (its
attention runs K4 on the card, its gradient `flash_attention_vjp`; the MoE
configs add the load-balance loss). Parameters come from a seeded
`torch.Generator`, so they differ from the reference's.

``--relocalize-threshold T`` (> 0, the GNNs only) churns the training
graph as the reference does: every 10 steps one delta deletes 1 % of the
edges and inserts as many among 16 random nodes (E stays fixed), applied
to a `DeltaPlanner` over a 4-part BFS partition whose `RelocalizePolicy`
(threshold T, patience 2, cooldown 3) re-localizes online; each fire prints
the reference's ``relocalize @ step N: executed tiles A → B`` line, and the
batch takes the planner's current edges (and coin_gcn's weights).
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
from repro_torch.launch.steps import _gnn_loss_fn
from repro_torch.models.gcn import gcn_init
from repro_torch.train.data import ShardedStream, click_batch_fn, token_batch_fn
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import adamw

__all__ = ["main"]

# The slice of the port (ROADMAP.md) that brings each architecture not ported yet.
_WAITING = {"equiformer-v2": "the equiformer-v2 slice (models/equiformer_v2.py, nn/so3.py)"}


def _init_gnn(arch_id: str, cfg, device: torch.device) -> dict:
    """The GNN's parameters from ``torch.Generator().manual_seed(0)``."""
    gen = torch.Generator().manual_seed(0)
    if arch_id == "pna":
        from repro_torch.models.pna import pna_init

        return pna_init(gen, cfg, device=device)
    if arch_id == "egnn":
        from repro_torch.models.egnn import egnn_init

        return egnn_init(gen, cfg, device=device)
    if arch_id == "graphcast":
        from repro_torch.models.graphcast import graphcast_init

        return graphcast_init(gen, cfg, device=device)
    return gcn_init(gen, cfg, device=device)


def _gnn_setup(spec, device: torch.device, relocalize_threshold: float = 0.0):
    """(params, loss_fn, batches) of a reduced GNN on the reference's
    synthetic citation graph and seeded inputs; churned under a relocalize
    policy when ``relocalize_threshold`` > 0 (module docstring)."""
    cfg = spec.make_reduced()
    g = citation_like(256, 1024, seed=0)
    rng = np.random.default_rng(0)
    d_in = cfg.layer_dims[0] if spec.arch_id == "coin_gcn" else (getattr(cfg, "d_in", None) or cfg.input_dim)
    batch = {
        "feats": torch.from_numpy(rng.standard_normal((g.n_nodes, d_in)).astype(np.float32)),
        "senders": torch.from_numpy(g.edge_index[0]),
        "receivers": torch.from_numpy(g.edge_index[1]),
    }
    if spec.arch_id == "egnn":
        batch["pos"] = torch.from_numpy(rng.standard_normal((g.n_nodes, 3)).astype(np.float32))
    if spec.arch_id == "graphcast":
        batch["edge_feats"] = torch.from_numpy(rng.standard_normal((g.n_edges, cfg.d_edge_in)).astype(np.float32))
    if spec.arch_id == "coin_gcn":
        batch["edge_weight"] = torch.ones(g.n_edges)
        batch["labels"] = torch.from_numpy(g.labels)
        batch["label_mask"] = torch.ones(g.n_nodes)
    else:
        n_out = cfg.n_vars if spec.arch_id == "graphcast" else cfg.d_out
        batch["target"] = torch.from_numpy((rng.standard_normal((g.n_nodes, n_out)) * 0.1).astype(np.float32))
    batch = {k: v.to(device) for k, v in batch.items()}
    params = _init_gnn(spec.arch_id, cfg, device)
    loss = _gnn_loss_fn(spec.arch_id, cfg)

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
            if "edge_weight" in batch:
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


def _lm_setup(spec, device: torch.device, batch: int = 4, seq: int = 64):
    """(params, loss_fn, batches) of the reduced LM on the seeded token
    stream; tokens go to the device as int64 once per batch."""
    from repro_torch.models.transformer_lm import lm_init, lm_loss

    cfg = spec.make_reduced()
    params = lm_init(torch.Generator().manual_seed(0), cfg, device=device)
    stream = ShardedStream(token_batch_fn(cfg.vocab, seq), global_batch=batch, seed=0)

    def batches():
        for b in stream:
            yield torch.from_numpy(b).to(device, torch.int64)

    return params, (lambda p, b: lm_loss(p, b, cfg)), batches


_GNN = ("coin_gcn", "pna", "egnn", "graphcast")
_SETUPS = {**dict.fromkeys(_GNN, _gnn_setup), "deepfm": _recsys_setup,
           **dict.fromkeys(("gemma3-12b", "granite-34b", "stablelm-12b", "moonshot-v1-16b-a3b", "olmoe-1b-7b"),
                           _lm_setup)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--relocalize-threshold", type=float, default=0.0,
                    help="drift ratio beyond which the churned training graph "
                         "re-localizes online (0 = static graph; gnn only)")
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
        if args.arch not in _GNN:
            raise SystemExit(f"--relocalize-threshold churns a graph: GNN archs only ({', '.join(_GNN)})")
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
