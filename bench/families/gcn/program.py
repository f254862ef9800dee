"""The system under test: the port's GCN (`repro_torch`), driven through its
own entry points.

Set-up hands the port the benchmark's raw inputs and lets it derive what it
serves from: the symmetric graph with self loops and its normalised weights
(`GraphData`), the locality order (`locality_block_order`), the ragged
128×128 tile tables (`blocked_adjacency`), the padded edge list
(`to_padded`) and its own copy of the features in its row order. A request
takes refreshed rows into those features, runs `gcn_forward` (bsr backend,
the configuration's dataflow) and returns every node's class id in the
original order. A training step is one `Trainer.fit` step of `gcn_loss`
under the port's `adamw`.

Layer outputs are read where `gcn_forward` produces them: `observe_layers`
wraps the `fused_gcn_layer` that `repro_torch.models.gcn` calls and keeps a
reference to each layer's output (no copy, no sync); the cell copies the
outputs, moments and parameters it compares at the moment it reads them, so
a program that reuses its buffers or updates its state in place is read
right.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from families.gcn.inputs import Dataset


class GcnProgram:
    def __init__(self, config: dict, data: Dataset, features: torch.Tensor):
        from repro_torch.core.quant import QuantConfig
        from repro_torch.graph.structure import (
            GraphData, blocked_adjacency, locality_block_order, permute_edge_index, to_padded,
        )
        from repro_torch.models.gcn import GCNConfig

        model = config["model"]
        quant = model.get("quant")
        self.cfg = GCNConfig(
            layer_dims=tuple(model["layer_dims"]), dataflow=model["dataflow"], backend=model["backend"],
            quant=QuantConfig(int(quant["weight_bits"]), int(quant["act_bits"]), enabled=True,
                              act_percentile=quant.get("act_percentile"))
            if quant else QuantConfig(enabled=False))
        device = features.device
        n = data.n_nodes
        g = GraphData(n, data.edge_index.astype(np.int32)).symmetrized().with_self_loops()
        weights = g.sym_normalized_weights()
        perm = locality_block_order(n, g.edge_index)
        ei = permute_edge_index(perm, g.edge_index)
        ba = blocked_adjacency(n, ei, weights)
        self.adjacency = ba.arrays(device=device)
        self.graph = to_padded(GraphData(n, ei), weights=weights, device=device)
        self.sizes = dict(edges_with_self_loops=g.n_edges, block_rows=ba.n_block_rows,
                          valid_tiles=ba.nnz_blocks, max_tiles_per_row=ba.max_nnzb, block=ba.block)
        del ba
        self.perm = torch.from_numpy(perm).to(device)              # new position → node id
        self.pos = torch.empty_like(self.perm)
        self.pos[self.perm] = torch.arange(n, device=device)       # node id → new position
        self.x = features[self.perm]
        self.labels = data.labels[self.perm]
        self.mask = data.train_mask[self.perm]
        self.n = n
        self.params = None
        self.trainer = None
        self.layer_outputs: list[torch.Tensor] = []
        self.layer_calls: list[dict] = []

    # ------------------------------------------------------------- serving
    def load(self, params: dict) -> None:
        self.params = params
        cuda = self.x.device.type == "cuda"
        self.classes = torch.empty(self.n, dtype=torch.int64, pin_memory=cuda)

    def request(self, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Take ``rows`` in as the features of nodes ``ids``, run the forward
        and return every node's class id, in node order, in the host buffer
        (pinned on the card's host) that the next request overwrites."""
        from repro_torch.models.gcn import gcn_forward

        self.layer_outputs.clear()
        self.x.index_copy_(0, self.pos[ids], rows)
        g = self.graph
        logits = gcn_forward(self.params, self.x, g.senders, g.receivers, g.edge_weight, self.cfg,
                             adjacency=self.adjacency)
        self.classes.copy_(logits.argmax(dim=1)[self.pos], non_blocking=True)
        if self.x.device.type == "cuda":
            torch.cuda.current_stream(self.x.device).synchronize()
        return self.classes

    @contextlib.contextmanager
    def observe_layers(self):
        """Keep each layer's output of the forwards run inside the block in
        ``layer_outputs`` (cleared by every request), and the first
        forward's order and widths of each layer in ``layer_calls``."""
        import repro_torch.models.gcn as gcn

        inner = gcn.fused_gcn_layer

        def observed(vals, cols, lens, x, w, b, order="feature_first", relu=True):
            out = inner(vals, cols, lens, x, w, b, order=order, relu=relu)
            self.layer_outputs.append(out)
            if len(self.layer_calls) < self.cfg.n_layers:
                self.layer_calls.append(dict(order=order, f_in=int(w.shape[0]), f_out=int(w.shape[1])))
            return out

        gcn.fused_gcn_layer = observed
        try:
            yield
        finally:
            gcn.fused_gcn_layer = inner

    # ------------------------------------------------------------ training
    def make_trainer(self, params: dict, opt: dict) -> None:
        from repro_torch.models.gcn import gcn_loss
        from repro_torch.train.loop import Trainer, TrainerConfig
        from repro_torch.train.optimizer import adamw

        g, cfg, adjacency = self.graph, self.cfg, self.adjacency

        def loss_fn(p, b):
            return gcn_loss(p, b["x"], g.senders, g.receivers, g.edge_weight, b["labels"], b["mask"], cfg,
                            adjacency=adjacency)

        self.batch = dict(x=self.x, labels=self.labels, mask=self.mask)
        self.trainer = Trainer(loss_fn, adamw(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                                              weight_decay=opt["weight_decay"]),
                               params, TrainerConfig(log_every=1 << 62))

    def step(self) -> float:
        """One training step; its loss, read back."""
        tr = self.trainer
        return tr.fit(itertools.repeat(self.batch), max_steps=tr.step + 1, log=lambda _: None)[0]

    def first_moment(self) -> dict:
        return dict(self.trainer.opt_state["m"])

    def parameters(self) -> dict:
        return dict(self.trainer.params)

    def close(self) -> None:
        """Drop everything the program holds on the device."""
        for name in ("adjacency", "graph", "x", "labels", "mask", "perm", "pos", "params", "trainer", "batch",
                     "classes"):
            setattr(self, name, None)
        self.layer_outputs = []
