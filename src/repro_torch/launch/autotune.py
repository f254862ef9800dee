"""repro_torch.launch.autotune — communication-aware placement + config
search; twin of `repro.launch.autotune`.

    PYTHONPATH=src python -m repro_torch.launch.autotune [--out config.json]
    PYTHONPATH=src python -m repro_torch.launch.autotune --n 2000 --e 12000 --k 8

The CLI face of `repro_torch.core.autotune`: builds the pinned graph and
partition, runs the quotient-graph pod mapper and the coordinate-descent
config search, then re-measures BOTH the default and the chosen config on
really-built halo plans and prints a predicted-vs-measured report. The
chosen config is written as JSON (``--out``) and the report prints the
matching flags for `repro_torch.launch.distributed_gcn` and
`repro_torch.launch.serve`. Exit code 1 when a predicted field disagrees
with its measured twin.

Everything here is host-side numpy: no group and no card, so the search
runs in seconds even for the 16384-node benchmark graph.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.core.autotune import BLOCK_GRID, CandidateConfig, autotune_config
from repro_torch.core.dataflow import exchange_cost
from repro_torch.core.energy import model_from_gcn
from repro_torch.core.partition import partition_graph
from repro_torch.core.quant import payload_bits
from repro_torch.dist.halo import build_halo_plan, plan_blocked_shape
from repro_torch.graph.generators import citation_like
from repro_torch.launch.obsflags import add_obs_args, obs_session

__all__ = ["measured_accounting", "run_autotune", "main"]


def measured_accounting(plan, cfg: CandidateConfig, d_feat: int) -> dict:
    """Measured comm/compute record of one config on a BUILT plan.

    Same field names and formulas as `repro_torch.launch.dryrun.exchange_accounting`
    — this is the "measured" side of the predicted-vs-measured report (rows
    come from the plan's real export tables, not from the analytic index).
    """
    bits = payload_bits(cfg.payload)
    ov = plan.overlap_fraction() if cfg.overlap else 0.0
    ec = exchange_cost(plan.halo_rows_per_device, d_feat, bits, ov)
    out = {
        "halo_rows_per_device": plan.halo_rows_per_device,
        "payload": cfg.payload or "fp32",
        "payload_bits": bits,
        "overlap_fraction": ov,
        "halo_wire_bytes_per_exchange": ec.wire_bytes,
        "halo_exposed_bytes_per_exchange": ec.exposed_bytes,
        "executed_tiles": plan_blocked_shape(plan, block=cfg.block)["nnz_blocks"],
        "block": cfg.block,
    }
    if plan.is_hierarchical:
        out.update(
            pods=plan.n_pods,
            s_loc=plan.s_loc,
            s_rem=plan.s_rem,
            inter_pod_rows_crossing=plan.inter_pod_rows_crossing,
            flat_inter_pod_rows_crossing=plan.flat_inter_pod_rows_crossing,
            inter_pod_bytes_crossing=plan.inter_pod_rows_crossing * d_feat * 4,
        )
    return out


def _build_plan(part, ei, pods: int, pod_map) -> object:
    axes = ("pod", "model") if pods > 1 else ("model",)
    return build_halo_plan(
        part, ei, axes=axes, pods=pods,
        pod_map=None if pod_map is None else np.asarray(pod_map, np.int64),
    )


def run_autotune(
    *,
    n: int,
    e: int,
    k: int,
    pods: int,
    d_feat: int,
    layer_dims: tuple[int, ...],
    n_labels: int = 128,
    homophily: float = 0.9,
    graph_seed: int = 1,
    shuffle_seed: int | None = 7,
    partition_seed: int = 0,
    seed: int = 0,
    rounds: int = 3,
) -> dict:
    """Full search + measured report on a pinned synthetic graph.

    Returns the JSON-ready record: chosen config, predicted breakdown,
    measured default-vs-autotuned accounting, improvement ratios, and a
    calibration block listing any predicted field that disagrees with its
    measured twin (empty == exact, the shipped contract).
    """
    g = citation_like(n, e, n_labels=n_labels, homophily=homophily, seed=graph_seed)
    ei = g.edge_index
    if shuffle_seed is not None:
        shuf = np.random.default_rng(shuffle_seed).permutation(n)
        ei = shuf[ei]
    part = partition_graph(n, ei, k, method="bfs", seed=partition_seed, refine=True)

    default_plan = _build_plan(part, ei, pods, None)
    nnz_blocks_for = {
        b: plan_blocked_shape(default_plan, block=b)["nnz_blocks"] for b in BLOCK_GRID
    }
    result = autotune_config(
        part, ei, pods=pods, d_feat=d_feat, layer_dims=layer_dims,
        nnz_blocks_for=nnz_blocks_for,
        energy_model=model_from_gcn(n, layer_dims),
        seed=seed, rounds=rounds,
    )
    cfg = result.config
    tuned_plan = _build_plan(part, ei, pods, cfg.pod_map_array())
    measured_default = measured_accounting(default_plan, result.baseline_config, d_feat)
    measured_tuned = measured_accounting(tuned_plan, cfg, d_feat)

    improvement = {
        "exposed_improvement": measured_default["halo_exposed_bytes_per_exchange"]
        / max(measured_tuned["halo_exposed_bytes_per_exchange"], 1e-30),
        "tiles_ratio": measured_tuned["executed_tiles"]
        / max(measured_default["executed_tiles"], 1),
        "predicted_objective_improvement": result.predicted_improvement,
    }
    if pods > 1:
        improvement["crossing_improvement"] = (
            measured_default["inter_pod_rows_crossing"]
            / max(measured_tuned["inter_pod_rows_crossing"], 1)
        )

    # Calibration: the search predicted with the same formulas the measured
    # accounting uses, so shared deterministic fields must agree exactly.
    mismatches = {
        f: (result.predicted[f], measured_tuned[f])
        for f in (
            "halo_rows_per_device", "payload_bits", "overlap_fraction",
            "halo_wire_bytes_per_exchange", "halo_exposed_bytes_per_exchange",
        ) + (("inter_pod_rows_crossing", "flat_inter_pod_rows_crossing") if pods > 1 else ())
        if result.predicted[f] != measured_tuned[f]
    }
    return {
        "schema": 1,
        "graph": {
            "n": n, "e": e, "n_labels": n_labels, "homophily": homophily,
            "graph_seed": graph_seed, "shuffle_seed": shuffle_seed,
            "k": k, "pods": pods, "partition_seed": partition_seed,
            "d_feat": d_feat, "layer_dims": list(layer_dims),
        },
        "config": dataclasses.asdict(cfg),
        "history": [list(h) for h in result.history],
        "predicted": result.predicted,
        "predicted_baseline": result.baseline,
        "measured": {"default": measured_default, "autotuned": measured_tuned},
        "improvement": improvement,
        "calibration_mismatches": mismatches,
    }


def _print_report(rec: dict) -> None:
    cfg = rec["config"]
    print("chosen config:")
    for key in ("pods", "block", "backend", "order", "payload", "overlap"):
        print(f"  {key:<8} = {cfg[key]!r}")
    print(f"  pod_map  = {cfg['pod_map']}")
    print("search history (objective_s after each accepted move):")
    for desc, obj in rec["history"]:
        print(f"  {obj:.3e}  {desc}")
    md, mt = rec["measured"]["default"], rec["measured"]["autotuned"]
    print("measured (default → autotuned):")
    rows = [
        ("halo rows/device", "halo_rows_per_device"),
        ("wire bytes/exchange", "halo_wire_bytes_per_exchange"),
        ("exposed bytes/exchange", "halo_exposed_bytes_per_exchange"),
        ("executed tiles", "executed_tiles"),
    ]
    if "inter_pod_rows_crossing" in md:
        rows.insert(1, ("inter-pod crossing rows", "inter_pod_rows_crossing"))
    for label, key in rows:
        print(f"  {label:<24} {md[key]:>12} → {mt[key]:>12}")
    print("improvement:", json.dumps(rec["improvement"], sort_keys=True))
    if rec["calibration_mismatches"]:
        print("PREDICTED≠MEASURED:", rec["calibration_mismatches"])
    else:
        print("calibration: every shared predicted field matches measured exactly")
    pods, payload = cfg["pods"], cfg["payload"] or "fp32"
    print("hand-off:")
    print(f"  train : PYTHONPATH=src python -m repro_torch.launch.distributed_gcn --pods {pods} "
          f"--payload {payload} --backend {cfg['backend']}" + ("" if cfg["overlap"] else " --no-overlap"))
    print(f"  serve : PYTHONPATH=src python -m repro_torch.launch.serve --arch coin-gcn "
          f"--parts {rec['graph']['k']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--e", type=int, default=65536)
    ap.add_argument("--k", type=int, default=32, help="partition parts == devices")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--d-feat", type=int, default=64)
    ap.add_argument("--layer-dims", default="64,32,7",
                    help="comma-separated GCN layer dims (first == --d-feat)")
    ap.add_argument("--n-labels", type=int, default=128)
    ap.add_argument("--homophily", type=float, default=0.9)
    ap.add_argument("--graph-seed", type=int, default=1)
    ap.add_argument("--shuffle-seed", type=int, default=7,
                    help="node-id shuffle applied before partitioning; -1 disables")
    ap.add_argument("--partition-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0, help="search seed")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the chosen config JSON here")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    layer_dims = tuple(int(x) for x in args.layer_dims.split(","))
    with obs_session(args):
        rec = run_autotune(
            n=args.n, e=args.e, k=args.k, pods=args.pods, d_feat=args.d_feat,
            layer_dims=layer_dims, n_labels=args.n_labels,
            homophily=args.homophily, graph_seed=args.graph_seed,
            shuffle_seed=None if args.shuffle_seed < 0 else args.shuffle_seed,
            partition_seed=args.partition_seed, seed=args.seed,
            rounds=args.rounds,
        )
    _print_report(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        print(f"wrote {args.out}")
    return 1 if rec["calibration_mismatches"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
