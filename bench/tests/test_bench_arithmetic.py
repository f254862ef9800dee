"""The yardstick's arithmetic against hand-worked Nell shapes, and the trace
reader on a hand-made trace."""
from __future__ import annotations

import types

import pytest
import torch

from benchlib import readers
from benchlib.traceread import EmptyTrace, TraceView, union_us
from benchlib.window import Window
from families.gcn import kernels

NELL_DIMS = (5414, 16, 210)
NELL_TILES = dict(block=128, block_rows=514, valid_tiles=11662)


def test_model_flops_at_nell():
    # forward: 2·N·(5414·16 + 16·210) + 2·E·16·2 = 11.85 GFLOP
    fwd = kernels.model_flops(NELL_DIMS, 65755, 214161, train=False)
    assert fwd == 2 * 65755 * (5414 * 16 + 16 * 210) + 2 * 214161 * 16 * 2
    assert round(fwd / 1e9, 2) == 11.85
    # a step adds both weight gradients, the hidden layer's input gradient and
    # two transposed aggregations (no gradient for X): 24.1 GFLOP
    step = kernels.model_flops(NELL_DIMS, 65755, 214161, train=True)
    assert step == fwd + 2 * 65755 * (5414 * 16 + 2 * 16 * 210) + 2 * 214161 * 16 * 2
    assert round(step / 1e9, 1) == 24.1


def test_kernel_bounds_at_nell():
    ms = lambda kind, w: 1e3 * kernels.bound_s(kind, [4, 4, 4, 4][: 3 if kind == "transform" else 4], w, NELL_TILES)
    # the transform reads X (65,792 × 5,414 fp32) once: 0.427 ms at 3.35 TB/s
    assert round(ms("transform", (5414, 16)), 3) == 0.427
    # the aggregations stream the 11,662 valid 64 KB tiles once: 0.23 and 0.25 ms
    assert round(ms("ff_aggregate", (16,)), 2) == 0.23
    assert round(ms("aggregate", (16,)), 2) == 0.23
    assert round(ms("af_layer", (16, 210)), 2) == 0.25


def test_model_flops_and_bounds_at_nell_64_wide():
    # Kipf & Welling's NELL width (fp32 configuration): forward 2·N·(5414·64 + 64·210) + 2·E·64·2
    dims = (5414, 64, 210)
    fwd = kernels.model_flops(dims, 65755, 214161, train=False)
    assert fwd == 2 * 65755 * (5414 * 64 + 64 * 210) + 2 * 214161 * 64 * 2
    assert round(fwd / 1e9, 2) == 47.39
    step = kernels.model_flops(dims, 65755, 214161, train=True)
    assert step == fwd + 2 * 65755 * (5414 * 64 + 2 * 64 * 210) + 2 * 214161 * 64 * 2
    assert round(step / 1e9, 2) == 96.55
    ms = lambda kind, w: 1e3 * kernels.bound_s(kind, [4, 4, 4, 4][: 3 if kind == "transform" else 4], w, NELL_TILES)
    # 64 wide, the transform is bound by its operations: 2 · 65,792 · 5,414 · 64 at 67 TFLOP/s
    assert ms("transform", (5414, 64)) == pytest.approx(1e3 * 2 * 65792 * 5414 * 64 / 67e12)
    assert round(ms("transform", (5414, 64)), 3) == 0.680
    # and so are the aggregations: 2 · 11,662 tiles · 128² · 64 (+ 2 · 65,792 · 64 · 210 for the layer)
    assert round(ms("ff_aggregate", (64,)), 3) == 0.365
    assert round(ms("af_layer", (64, 210)), 3) == 0.391


def test_kernel_names_classify():
    assert kernels.classify("void xw_kernel<float, float, float>(float const*, float const*, float*, int, int, "
                            "int, int, int, int)") == ("transform", [4, 4, 4])
    assert kernels.classify("void ragged_layer_kernel<1, float, __nv_bfloat16, float, __nv_bfloat16>(...)") == (
        "af_layer", [4, 2, 4, 2])
    assert kernels.classify("ragged_layer_kernel<2, float, float, float, float>") == ("aggregate", [4, 4, 4, 4])
    assert kernels.classify("void at::native::vectorized_elementwise_kernel<4, ...>") is None


def _event(name, start, end, cuda):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=dt, time_range=types.SimpleNamespace(start=start, end=end))


def _view(events, layer_calls, train=False):
    facts = dict(layer_calls=layer_calls, train=train, sizes=NELL_TILES, is_port_kernel=kernels.is_port_kernel,
                 model_flops=kernels.model_flops(NELL_DIMS, 65755, 214161, train))
    return TraceView(events, "bench.request", "request", facts)


XW = "void xw_kernel<float, float, float>(...)"
AGG0 = "void ragged_layer_kernel<0, float, float, float, float>(...)"
AF = "void ragged_layer_kernel<1, float, float, float, float>(...)"
LAYERS = [dict(order="feature_first", f_in=5414, f_out=16), dict(order="aggregation_first", f_in=16, f_out=210)]


def test_trace_view_metrics():
    # two requests of 10 ms; each: 1 ms host before the first launch, three
    # port kernels whose times are twice their bounds, one 2 ms torch kernel
    events = []
    bounds = [kernels.bound_s("transform", [4, 4, 4], (5414, 16), NELL_TILES),
              kernels.bound_s("ff_aggregate", [4] * 4, (16,), NELL_TILES),
              kernels.bound_s("af_layer", [4] * 4, (16, 210), NELL_TILES)]
    for r in range(2):
        t = r * 10_000.0
        events.append(_event("bench.request", t, t + 10_000.0, False))
        events.append(_event("cudaLaunchKernel", t + 1000.0, t + 1005.0, False))
        events.append(_event("cudaLaunchKernel", t + 3000.0, t + 3010.0, False))
        start = t + 1010.0
        for name, b in zip((XW, AGG0, AF), bounds):
            events.append(_event(name, start, start + 2e6 * b, True))
            start += 2e6 * b
        events.append(_event("void at::native::reduce_kernel<...>", start, start + 2000.0, True))
        events.append(_event("bench.request", t, t + 10_000.0, True))      # the annotation's device copy
    view = _view(events, LAYERS)
    ctx = types.SimpleNamespace(trace=view)
    assert kernels.roofline_percent(view) == pytest.approx(50.0)
    assert readers.other_kernels_ms(ctx) == pytest.approx(2.0)
    assert readers.host_enqueue_ms(ctx) == pytest.approx(3.01)
    busy_us = 2 * (2e6 * sum(bounds) + 2000.0)
    assert view.busy_s == pytest.approx(busy_us / 1e6)
    assert readers.device_idle_percent(ctx) == pytest.approx(100.0 * (1 - busy_us / 20_000.0))
    flops = kernels.model_flops(NELL_DIMS, 65755, 214161, False)
    assert readers.mfu_percent(ctx) == pytest.approx(100.0 * flops / 0.010 / 67e12)
    assert [n for n, _ in view.top_device_ops()[:2]] == ["void at::native::reduce_kernel<...>", XW]
    assert sum(s for _, s in view.idle_gaps()) == pytest.approx(0.020 - busy_us / 1e6)


def test_roofline_silent_where_widths_are_ambiguous():
    layers = [dict(order="feature_first", f_in=5414, f_out=16), dict(order="feature_first", f_in=16, f_out=210)]
    events = [_event("bench.request", 0.0, 100.0, False), _event(AGG0, 1.0, 2.0, True)]
    assert kernels.roofline_percent(_view(events, layers)) is None


def test_empty_trace_fails():
    with pytest.raises(EmptyTrace):
        _view([_event("bench.request", 0.0, 100.0, False), _event("Memcpy DtoH", 1.0, 2.0, True)], LAYERS)
    with pytest.raises(EmptyTrace):
        _view([_event(XW, 1.0, 2.0, True)], LAYERS)


def test_union_and_window_statistics():
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25
    w = Window(kind="request", seconds=2.0, latencies=[i / 1000 for i in range(1, 101)])
    assert w.percentile(95.0) == pytest.approx(0.095)
    assert w.completed == 100
