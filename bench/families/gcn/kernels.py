"""The GCN's operations and bytes, from its shapes: the yardstick of the
per-layer roofline and model-FLOP metrics.

Model FLOPs count what the model needs, whatever the program runs: a layer
is 2·N·F_in·F_out for its transform plus 2·E·min(F_in, F_out) for its
aggregation in the cheaper order; a training step adds, per layer, the
weight gradient (2·N·F_in·F_out), and for every layer but the first the
input's gradient (2·N·F_in·F_out) and the transposed aggregation
(2·E·min); the first layer's transposed aggregation only where its
cheaper order transforms first (X's own gradient is never needed).

A kernel's bound: the larger of its bytes at the HBM rate and its
operations at the fp32 rate, with each input element read once and each
output element written once, valid tiles only. The port's kernels are
known by name: ``xw_kernel<TX, TW, TZ>`` (the dense transform X·W) and
``ragged_layer_kernel<MODE, TV, TS, TW, TO>`` (MODE 0 the feature-first
aggregation, 1 the aggregation-first layer, 2 the bare aggregation Ã·Z).
"""
from __future__ import annotations

import re

from benchlib.peaks import H100_SXM

_NAME = re.compile(r"\b(ragged_layer_kernel|xw_kernel)<([^<>]*)>")
RAGGED_KIND = {"0": "ff_aggregate", "1": "af_layer", "2": "aggregate"}


def model_flops(layer_dims, n_nodes: int, n_edges: int, train: bool) -> float:
    total = 0.0
    for i, (f_in, f_out) in enumerate(zip(layer_dims[:-1], layer_dims[1:])):
        dense, agg = 2.0 * n_nodes * f_in * f_out, 2.0 * n_edges * min(f_in, f_out)
        total += dense + agg
        if train:
            total += dense
            if i > 0:
                total += dense + agg
            elif f_out <= f_in:
                total += agg
    return total


def _size(type_name: str) -> int:
    return 2 if ("bfloat16" in type_name or "half" in type_name) else 4


def classify(name: str):
    """``(kind, element sizes)`` of one of the port's GCN kernels, or None."""
    m = _NAME.search(name)
    if not m:
        return None
    args = [a.strip() for a in m.group(2).split(",")]
    if m.group(1) == "xw_kernel":
        return "transform", [_size(a) for a in args]
    return RAGGED_KIND.get(args[0]), [_size(a) for a in args[1:]]


def expected_shapes(layer_calls: list[dict], train: bool) -> dict:
    """The widths each kind of kernel runs at in one request or step, in
    launch order, from each layer's dataflow and widths."""
    out: dict[str, list] = {}
    for c in layer_calls:
        if c["order"] == "feature_first":
            out.setdefault("transform", []).append((c["f_in"], c["f_out"]))
            out.setdefault("ff_aggregate", []).append((c["f_out"],))
        else:
            out.setdefault("af_layer", []).append((c["f_in"], c["f_out"]))
            if train:
                out.setdefault("aggregate", []).append((c["f_in"],))
    return out


def bound_s(kind: str, sizes: list[int], widths: tuple, tiles: dict, peaks: dict = H100_SXM) -> float:
    """Least seconds of one launch. ``tiles``: block, block_rows, valid_tiles."""
    B, R, nnz = tiles["block"], tiles["block_rows"], tiles["valid_tiles"]
    rows = R * B
    if kind == "transform":
        sx, sw, sz = sizes
        k, n = widths
        nbytes = sx * rows * k + sw * k * n + sz * rows * n
        flops = 2.0 * rows * k * n
    else:
        sv, ss, sw, so = sizes
        table = sv * nnz * B * B + 4 * nnz + 4 * R
        f_in = widths[0]
        f_out = widths[1] if kind == "af_layer" else f_in
        nbytes = table + ss * rows * f_in + so * rows * f_out
        flops = 2.0 * nnz * B * B * f_in
        if kind != "aggregate":
            nbytes += 4 * f_out
        if kind == "af_layer":
            nbytes += sw * f_in * f_out
            flops += 2.0 * rows * f_in * f_out
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["fp32_flop_per_s"])


def roofline_percent(view) -> float | None:
    """Σ bound / Σ device time over every launch of the port's GCN kernels
    in the traced window, in %; None where there is none, or where a
    launch's widths cannot be told from its kind alone."""
    ctx = view.context
    expect = expected_shapes(ctx["layer_calls"], ctx["train"])
    total_bound = total_time = 0.0
    for ops in view.per_span(view.kernels):
        seen: dict[str, list] = {}
        for o in ops:
            c = classify(o.name)
            if c is not None:
                seen.setdefault(c[0], []).append((o, c[1]))
        for kind, launches in seen.items():
            widths = expect.get(kind, [])
            if len(widths) == len(launches):
                pairs = zip(launches, widths)
            elif len(set(widths)) == 1:
                pairs = ((launch, widths[0]) for launch in launches)
            else:
                return None
            for (o, sizes), w in pairs:
                total_bound += bound_s(kind, sizes, w, ctx["sizes"])
                total_time += (o.end - o.start) / 1e6
    return 100.0 * total_bound / total_time if total_time > 0 else None


def is_port_kernel(name: str) -> bool:
    return classify(name) is not None
