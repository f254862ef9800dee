"""Serving entry point — twin of `repro.launch.serve` for the architectures
the port has reached: batched greedy decode for the LMs, batched
scoring for DeepFM, and online GCN node-query serving with the hot-neighbor
cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch coin-gcn --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pna --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch coin-gcn --device cpu \
        --relocalize-threshold 1.01

Runs the REDUCED config on one device (the CUDA card unless ``--device``
names another), with parameters from a seeded `torch.Generator`. An LM
(gemma3-12b, stablelm-12b, granite-34b, and the MoE LMs olmoe-1b-7b and
moonshot-v1-16b-a3b) decodes ``--tokens`` greedy tokens
for a batch of 4 streams through `lm_decode_step` from seeded first tokens
and prints the tokens per second. DeepFM scores one batch of 512 examples of
seeded ids: one warm-up forward, then ``--requests`` forwards, each ended by
a synchronisation, and prints the median request time and the rate; its FM
term runs K3 on the card. ``coin-gcn``, ``pna`` and ``egnn`` serve ``--queries`` degree-weighted
node queries through `GraphBatcher` on a 2,000-node citation-like graph
(``--batch-seeds``, ``--fanout``, ``--cache-capacity`` or ``--no-cache``,
``--parts`` for partition-aligned packing; pna and egnn serve cache-off,
egnn on a graph with positions) and print the reference's lines:
queries, micro-batches and traces, latency, nodes and edges sampled per
query, foreign rows and the cache's accounting — every count but the
times is the reference's, since none depends on the parameters.
``graphcast`` exits with the reference's message (graph serving supports
coin_gcn/pna/egnn). With
``--relocalize-threshold T`` (> 0) a burst of 8 churn deltas hits the
graph halfway through the stream: each goes to the engine
(`apply_graph_delta`) and to a mirrored `DeltaPlanner` whose
`RelocalizePolicy` (patience 2, cooldown 3) may re-localize it; the engine
then adopts the new partition. ``equiformer-v2`` comes with a later
slice of the port and raises `NotImplementedError` naming it.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.obsflags import add_obs_args, obs_session

__all__ = ["serve_lm", "serve_recsys", "build_graph_engine", "serve_graph", "main"]

# The slice of the port (ROADMAP.md) that brings serving for each architecture.
_WAITING = {"equiformer-v2": "the equiformer-v2 slice (models/equiformer_v2.py, nn/so3.py)"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(spec, gen_tokens: int, device: torch.device, batch: int = 4) -> float:
    """Greedy-decode ``gen_tokens`` tokens for ``batch`` streams with the
    reduced LM through `lm_decode_step`; prints and returns the tokens per
    second (host clock, the last step ended by a synchronisation)."""
    from repro_torch.models.transformer_lm import lm_decode_step, lm_init, lm_init_cache

    cfg = spec.make_reduced()
    params = lm_init(torch.Generator().manual_seed(0), cfg, device=device)
    cache = lm_init_cache(cfg, batch, gen_tokens + 8, device=device)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, batch)).to(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        for t in range(gen_tokens):
            logits, cache = lm_decode_step(params, cache, tok, t, cfg)
            tok = logits.argmax(-1)
        _sync(device)
        dt = time.perf_counter() - t0
    print(f"{spec.arch_id}: {batch}×{gen_tokens} tokens in {dt*1e3:.1f} ms "
          f"({batch*gen_tokens/dt:.0f} tok/s)")
    return batch * gen_tokens / dt


def serve_recsys(spec, requests: int, device: torch.device, batch: int = 512) -> float:
    """Score ``requests`` batches of ``batch`` examples with the reduced
    DeepFM; prints and returns the median request time in ms."""
    from repro_torch.models.deepfm import deepfm_forward, deepfm_init

    cfg = spec.make_reduced()
    params = deepfm_init(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.rows_per_field, (batch, cfg.n_fields))).to(device, torch.int64)
    times = []
    with torch.inference_mode():
        deepfm_forward(params, ids, cfg)
        _sync(device)
        for _ in range(requests):
            t0 = time.perf_counter()
            deepfm_forward(params, ids, cfg)
            _sync(device)
            times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"deepfm: batch={batch} p50≈{dt*1e3:.2f} ms ({batch/dt:.0f} examples/s)")
    return dt * 1e3


def build_graph_engine(
    spec,
    device: torch.device,
    batch_seeds: int = 8,
    fanout: int = 4,
    cache_capacity: int = 256,
    n_parts: int = 0,
    seed: int = 0,
    n_nodes: int = 2000,
    n_edges: int = 12000,
):
    """A small serving engine for a GNN arch on a citation-like graph (the
    reference's ``build_graph_engine``): the reduced config, parameters
    from ``torch.Generator().manual_seed(seed)``, and with ``n_parts`` a
    BFS partition (refined) for partition-aligned packing. ``coin_gcn``
    serves with the hot-neighbor cache; ``pna`` and ``egnn`` (whose graph
    carries positions) serve cache-off. Returns (engine, graph); shared by
    the CLI and the example twin."""
    from repro_torch.core.partition import partition_graph
    from repro_torch.graph.generators import citation_like
    from repro_torch.serve.graph import GraphBatcher

    cfg = spec.make_reduced()
    gen = torch.Generator().manual_seed(seed)
    if spec.arch_id == "coin_gcn":
        from repro_torch.models.gcn import gcn_init

        d_in, n_out = cfg.layer_dims[0], cfg.layer_dims[-1]
        graph = citation_like(n_nodes, n_edges, d_in, n_out, seed=seed)
        params = gcn_init(gen, cfg, device=device)
        model = "gcn"
    elif spec.arch_id == "pna":
        from repro_torch.models.pna import pna_init

        graph = citation_like(n_nodes, n_edges, cfg.d_in, 4, seed=seed)
        params = pna_init(gen, cfg, device=device)
        model = "pna"
    elif spec.arch_id == "egnn":
        from repro_torch.models.egnn import egnn_init

        graph = citation_like(n_nodes, n_edges, cfg.d_in, 4, seed=seed, with_positions=True)
        params = egnn_init(gen, cfg, device=device)
        model = "egnn"
    else:
        raise SystemExit(f"{spec.arch_id}: graph serving supports coin_gcn/pna/egnn")
    part = None
    if n_parts:
        part = partition_graph(graph.n_nodes, graph.edge_index, n_parts, method="bfs",
                               seed=seed, refine=True)
    engine = GraphBatcher(
        params, graph, cfg, model=model, batch_seeds=batch_seeds, fanout=fanout,
        # Activation injection (the cache's truncation hook) exists only in
        # the GCN serve forward; other archs serve cache-off.
        cache_capacity=cache_capacity if model == "gcn" else 0,
        partition=part, seed=seed, device=device)
    return engine, graph


def serve_graph(
    spec,
    n_queries: int,
    device: torch.device,
    batch_seeds: int = 8,
    fanout: int = 4,
    cache_capacity: int = 256,
    n_parts: int = 4,
    seed: int = 0,
    relocalize_threshold: float = 0.0,
) -> dict:
    """Serve ``n_queries`` degree-weighted node queries and print the
    latency and the hot-neighbor cache's accounting; with
    ``relocalize_threshold`` > 0 a churn burst (`churn_burst`) hits the
    graph halfway through. Returns the engine's `stats()`."""
    from repro_torch.serve.graph import hot_query_stream

    engine, graph = build_graph_engine(
        spec, device, batch_seeds=batch_seeds, fanout=fanout,
        cache_capacity=cache_capacity, n_parts=n_parts, seed=seed,
    )
    planner = None
    if relocalize_threshold > 0 and engine.partition is not None:
        from repro_torch.dist.delta import DeltaPlanner, RelocalizePolicy

        planner = DeltaPlanner(
            engine.partition, graph.edge_index, graph_key="launch-serve",
            relocalize_policy=RelocalizePolicy(
                threshold=relocalize_threshold, patience=2, cooldown=3))
    nodes = hot_query_stream(graph, n_queries, seed=seed + 1)
    t0 = time.perf_counter()
    half = len(nodes) // 2 if planner is not None else len(nodes)
    for v in nodes[:half]:
        engine.submit(int(v))
    engine.run_until_drained()
    if planner is not None:
        fired = churn_burst(engine, planner, graph.n_nodes, seed)
        for v in nodes[half:]:
            engine.submit(int(v))
        engine.run_until_drained()
        drift = planner.locality_drift()["drift_ratio"]
        print(f"  maintenance: {fired} relocalization(s) over churn burst, "
              f"residual drift {drift:.3f}")
    _sync(device)
    dt = time.perf_counter() - t0
    s = engine.export_metrics()       # == stats(), mirrored into the registry
    print(
        f"{spec.arch_id}: {s['queries']} queries in {s['micro_batches']} micro-batches "
        f"({s['traces']} trace) in {dt*1e3:.1f} ms ({s['queries']/dt:.0f} q/s)"
    )
    print(
        f"  latency p50={s['p50_ms']:.2f} ms p99={s['p99_ms']:.2f} ms | "
        f"sampled {s['nodes_per_query']:.1f} nodes/q {s['edges_per_query']:.1f} edges/q"
        + (f" | foreign rows {s['foreign_rows']}" if n_parts else "")
    )
    if "cache" in s:
        c = s["cache"]
        print(
            f"  hot-neighbor cache: hit-rate {c['hit_rate']:.1%} "
            f"({c['hits']} hits / {c['misses']} misses), resident {c['resident']}/"
            f"{c['capacity']}, evictions {c['evictions']}, "
            f"rows saved {c['rows_saved']}, bytes saved {c['bytes_saved']/1e3:.1f} kB"
        )
    return s


def churn_delta(planner, rng: np.random.Generator, n_nodes: int, frac: float = 0.02, members: int = 24):
    """One churn delta of the reference serve CLI's burst: delete ``frac`` of
    the planner's current edges (at random) and insert as many among a
    random set of ``members`` nodes (no self-loops) — locality decays while
    E stays fixed."""
    from repro_torch.dist.delta import GraphDelta

    ei = planner.edge_index()
    m = max(int(ei.shape[1] * frac), 2)
    drop = rng.choice(ei.shape[1], m, replace=False)
    mem = rng.choice(n_nodes, members, replace=False)
    s = mem[rng.integers(0, mem.size, m)]
    d = mem[rng.integers(0, mem.size, m)]
    bad = s == d
    d[bad] = mem[(np.searchsorted(np.sort(mem), d[bad]) + 1) % mem.size]
    return GraphDelta(edge_inserts=np.stack([s, d]), edge_deletes=ei[:, drop])


def churn_burst(engine, planner, n_nodes: int, seed: int, rounds: int = 8) -> int:
    """The reference's ``_serve_churn_burst``: ``rounds`` churn deltas
    (`churn_delta`, 2 % of the edges each, from ``default_rng(seed + 2)``)
    to the engine AND the planner; the engine adopts the re-localized
    partition whenever the policy fires. Returns the number of fires."""
    churn = np.random.default_rng(seed + 2)
    fired = 0
    for _ in range(rounds):
        delta = churn_delta(planner, churn, n_nodes)
        engine.apply_graph_delta(delta)
        if planner.apply(delta)["relocalized"] is not None:
            fired += 1
            engine.adopt_partition(planner.part)
    return fired


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ALL_ARCHS)} (hyphen/underscore both fine)")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--queries", type=int, default=64, help="graph node queries to serve")
    ap.add_argument("--batch-seeds", type=int, default=8)
    ap.add_argument("--fanout", type=int, default=4)
    ap.add_argument("--cache-capacity", type=int, default=256)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--parts", type=int, default=4, help="partition-aligned packing parts")
    ap.add_argument("--relocalize-threshold", type=float, default=0.0,
                    help="drift ratio beyond which a mid-stream churn burst "
                         "triggers online re-localization (0 = off; gnn only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    with obs_session(args):
        run(args)


def run(args) -> None:
    arch = args.arch.replace("-", "_") if args.arch.replace("-", "_") in ALL_ARCHS else args.arch
    if arch in _WAITING:
        raise NotImplementedError(
            f"serving --arch {args.arch} is not ported to PyTorch yet; it comes with {_WAITING[arch]} "
            "(ROADMAP.md)")
    spec = get_arch(arch)
    if spec.family == "gnn":
        serve_graph(spec, args.queries, resolve_device(args.device), batch_seeds=args.batch_seeds,
                    fanout=args.fanout, cache_capacity=0 if args.no_cache else args.cache_capacity,
                    n_parts=args.parts, relocalize_threshold=args.relocalize_threshold)
        return
    if spec.family == "lm":
        if args.tokens < 1:
            raise SystemExit("--tokens must be at least 1")
        serve_lm(spec, args.tokens, resolve_device(args.device))
        return
    if args.requests < 1:
        raise SystemExit("--requests must be at least 1")
    serve_recsys(spec, args.requests, resolve_device(args.device))


if __name__ == "__main__":
    main()
