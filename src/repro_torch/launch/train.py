"""Training driver — twin of `repro.launch.train` for the architectures the
port has reached:

    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch coin_gcn --steps 50 --device cpu

Runs the REDUCED config of ``--arch`` on one device (the CUDA card unless
``--device`` names another): synthetic data → eager train step → AdamW →
checkpointing → straggler monitor, resuming from the latest checkpoint
under ``--ckpt-dir``. For ``coin_gcn`` this is the reference's
``_gnn_setup`` branch: ``citation_like(256, 1024, seed=0)``, the reduced
GCN config (segment backend, 4-bit QAT) and `gcn_loss`. Parameters come
from a seeded `torch.Generator`, so they differ from the reference's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.graph.generators import citation_like
from repro_torch.models.gcn import gcn_init, gcn_loss
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import adamw

__all__ = ["main"]

# The slice of the port (ROADMAP.md) that brings each architecture not ported yet.
_WAITING = {
    **dict.fromkeys(("moonshot-v1-16b-a3b", "olmoe-1b-7b", "gemma3-12b", "granite-34b", "stablelm-12b"),
                    "the LM slice (transformer_lm and kernel K4)"),
    **dict.fromkeys(("egnn", "graphcast", "equiformer-v2", "pna"), "the slice of the other GNN families"),
    "deepfm": "the DeepFM slice (kernel K3)",
}


def _gcn_setup(spec, device: torch.device):
    """(params, loss_fn, batches) of the reduced coin_gcn on the reference's
    synthetic citation graph."""
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

    def batches():
        while True:
            yield batch

    return params, loss, batches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    if args.arch != "coin_gcn":
        raise NotImplementedError(
            f"--arch {args.arch} is not ported to PyTorch yet; it comes with {_WAITING[args.arch]} "
            "(ROADMAP.md)"
        )
    params, loss_fn, batches = _gcn_setup(get_arch(args.arch), resolve_device(args.device))
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
