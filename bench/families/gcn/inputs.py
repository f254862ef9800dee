"""The benchmark's inputs, made from seeds and handed alike to the program and
to the reference.

The graph is a configuration's dataset: its edges come from a frozen copy of
the citation-like generator (a homophilous planted partition with power-law
out-degrees, Table I's sizes), drawn on the host from the configuration's
``graph_seed``, so every run of a configuration serves the same graph, as a
deployment serves one dataset. The bag-of-words features are drawn on the
device from the same graph seed. What a run's ``--seed`` draws: the weights
(on the device, one call per leaf) and each request's refreshed rows.

Nothing here imports the program or the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

U64 = 1 << 64
# Stream tags: one independent draw per purpose and seed.
WEIGHTS, REFRESH, FEATURES = 1, 2, 3


def seed_u64(seed: int) -> int:
    """Any whole number (negative or past 64 bits) as a 64-bit seed."""
    return int(seed) % U64


def stream_seed(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed for draw ``index`` of stream ``tag`` under ``seed``."""
    state = np.random.SeedSequence([seed_u64(seed), tag, int(index)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# ------------------------------------------------------------------ the graph
def citation_edges(n_nodes: int, n_edges: int, n_labels: int, homophily: float, alpha: float,
                   seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(edge_index (2, E) int64 [senders; receivers], labels (N,) int64)``:
    E directed edges exactly, no self loops, repeats possible. Labels are
    contiguous blocks; each edge stays in its source's block with
    probability ``homophily``; out-degrees follow rank^-alpha."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n_nodes, dtype=np.int64) * n_labels // n_nodes
    block_lo = np.searchsorted(labels, np.arange(n_labels))
    block_hi = np.searchsorted(labels, np.arange(n_labels), side="right")
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** (-alpha)
    deg = rng.permutation(rng.multinomial(n_edges, w / w.sum()))
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    same = rng.random(n_edges) < homophily
    lo, hi = block_lo[labels[src]], block_hi[labels[src]]
    dst_same = lo + (rng.random(n_edges) * (hi - lo)).astype(np.int64)
    dst = np.where(same, dst_same, rng.integers(0, n_nodes, size=n_edges))
    loop = dst == src
    dst[loop] = (dst[loop] + 1) % n_nodes
    return np.stack([src, dst]), labels


def label_slice(n_features: int, n_labels: int) -> int:
    """Width of the label-correlated column slice of each row."""
    return min(8, max(1, n_features // max(n_labels, 1) // 4))


def bow_rows(labels: torch.Tensor, n_features: int, n_labels: int, nnz: int,
             gen: torch.Generator) -> torch.Tensor:
    """Bag-of-words rows for nodes of ``labels``: ``nnz`` random columns set
    to 1, then the label's slice of columns each raised by 1 with
    probability 3/4 (values 0, 1 or 2; density about (nnz + 3/4·slice) / F)."""
    n, device = labels.shape[0], labels.device
    x = torch.zeros((n, n_features), dtype=torch.float32, device=device)
    cols = torch.randint(0, n_features, (n, nnz), generator=gen, device=device)
    x.scatter_(1, cols, 1.0)
    sig = label_slice(n_features, n_labels)
    lo = (labels * sig) % max(n_features - sig, 1)
    bits = (torch.rand((n, sig), generator=gen, device=device) < 0.75).float()
    x.scatter_add_(1, lo[:, None] + torch.arange(sig, device=device)[None, :], bits)
    return x


class Dataset:
    """A configuration's graph and features, in the original node order."""

    def __init__(self, graph: dict, device: torch.device):
        self.spec = graph
        self.n_nodes = int(graph["n_nodes"])
        self.n_features = int(graph["n_features"])
        self.n_labels = int(graph["n_labels"])
        self.edge_index, labels = citation_edges(
            self.n_nodes, int(graph["n_edges"]), self.n_labels, float(graph["homophily"]),
            float(graph["alpha"]), int(graph["graph_seed"]))
        self.device = device
        self.labels = torch.from_numpy(labels).to(device)
        # Three quarters of the nodes carry the training loss.
        self.train_mask = (torch.arange(self.n_nodes, device=device) % 4 != 0).float()

    def features(self) -> torch.Tensor:
        """(N, F) fp32 on the device, the same on every call."""
        gen = generator(self.device, stream_seed(int(self.spec["graph_seed"]), FEATURES))
        return bow_rows(self.labels, self.n_features, self.n_labels, int(self.spec["feature_nnz"]), gen)

    def chunk_size(self, fraction: float) -> int:
        """Requests whose refreshes are drawn at once: up to 16, and no more
        than 256 MB of rows."""
        m = max(1, round(fraction * self.n_nodes))
        return max(1, min(16, int(256e6 // (m * self.n_features * 4))))

    def refresh_chunk(self, seed: int, c: int, fraction: float) -> tuple[torch.Tensor, torch.Tensor]:
        """The refreshes of requests ``[c·C, (c+1)·C)`` under ``seed`` (C =
        `chunk_size`): ``(node ids (C, m) int64, rows (C, m, F) fp32)``;
        each request's m = round(fraction · N) nodes are distinct and drawn
        uniformly, their rows drawn as the features were."""
        gen = generator(self.device, stream_seed(seed, REFRESH, c))
        size = self.chunk_size(fraction)
        m = max(1, round(fraction * self.n_nodes))
        keys = torch.rand((size, self.n_nodes), generator=gen, device=self.device)
        ids = keys.argsort(dim=1)[:, :m]
        rows = bow_rows(self.labels[ids.reshape(-1)], self.n_features, self.n_labels,
                        int(self.spec["feature_nnz"]), gen)
        return ids, rows.reshape(size, m, self.n_features)


def weights(layer_dims, seed: int, device: torch.device) -> dict:
    """Glorot-normal weights ``w{i}`` (d_in, d_out) and zero biases ``b{i}``,
    fp32, drawn on the device: the same seed gives the same weights."""
    gen = generator(device, stream_seed(seed, WEIGHTS))
    params = {}
    for i, (d_in, d_out) in enumerate(zip(layer_dims[:-1], layer_dims[1:])):
        std = math.sqrt(2.0 / (d_in + d_out))
        params[f"w{i}"] = torch.randn((d_in, d_out), generator=gen, device=device) * std
        params[f"b{i}"] = torch.zeros((d_out,), device=device)
    return params
