"""Online GCN query serving example — twin of
``examples/serve_graph_queries.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_graph_queries
    PYTHONPATH=src python -m repro_torch.launch.serve_graph_queries --device cpu

Builds the serve CLI's engine (`repro_torch.launch.serve.build_graph_engine`:
a 2,000-node citation-like graph, the reduced coin_gcn, the hot-neighbor
cache of 256 rows and 4-part packing) on one device (the CUDA card unless
``--device`` names another) and serves a hub-heavy query stream in arrival
waves of mixed sizes — one fixed-shape forward throughout. Prints the
example's lines: each wave's hit rate and residents, the latency
percentiles and the cache's accounting, then a weight update (parameters
from ``torch.Generator().manual_seed(42)``) that flushes the cache, and the
wave after it. The counts are the reference example's; the times and the
parameters are this run's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_graph_engine
from repro_torch.models.gcn import gcn_init
from repro_torch.serve.graph import hot_query_stream

__all__ = ["main"]


def main(argv=None) -> dict:
    """Runs the example; returns the engine's final `stats()`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    spec = get_arch("coin_gcn")
    engine, graph = build_graph_engine(spec, device, cache_capacity=256, n_parts=4, seed=0)

    for wave, size in enumerate((16, 7, 16, 3, 16)):     # mixed arrival sizes
        for v in hot_query_stream(graph, size, seed=wave):
            engine.submit(int(v))
        engine.run_until_drained()
        c = engine.cache.stats()
        print(f"wave {wave}: {size:3d} queries  hit-rate {c['hit_rate']:.1%}  "
              f"resident {c['resident']}/{c['capacity']}")

    s = engine.stats()
    print(f"\nserved {s['queries']} queries in {s['micro_batches']} micro-batches, "
          f"{s['traces']} trace (compile-once)")
    print(f"latency p50={s['p50_ms']:.2f} ms p99={s['p99_ms']:.2f} ms | "
          f"{s['nodes_per_query']:.1f} nodes/q {s['edges_per_query']:.1f} edges/q")
    c = s["cache"]
    print(f"hot-neighbor cache: {c['hits']} hits / {c['misses']} misses, "
          f"rows saved {c['rows_saved']}, bytes saved {c['bytes_saved']/1e3:.1f} kB")

    # A weight push invalidates every cached activation (they are pure
    # functions of params+features), then the next wave re-warms.
    engine.update_params(gcn_init(torch.Generator().manual_seed(42), engine.cfg, device=device))
    print(f"\nweight update → cache flushed (resident {len(engine.cache)}), "
          f"invalidations={engine.cache.invalidations}")
    for v in hot_query_stream(graph, 16, seed=99):
        engine.submit(int(v))
    engine.run_until_drained()
    s = engine.stats()
    print(f"post-update wave: resident {len(engine.cache)}, "
          f"traces still {s['traces']} (no retrace)")
    return s


if __name__ == "__main__":
    main()
