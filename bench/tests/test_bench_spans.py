"""The program's spans read from a hand-made trace: each device operation
put down to the enqueue call that launched it, also where the device's
timestamps drift against the host's, the new per-layer metrics' values,
nothing where calls and operations do not pair or the program has no such
span, and a span's containment across threads. On the card: every
host–device sync of a request or step of each cell sits in a ``sync.*``
span."""
from __future__ import annotations

import contextlib
import gc
import threading
import traceback
import types
import warnings

import pytest
import torch

from benchlib import spans, spec
from benchlib.traceread import TraceView
from conftest import WORKLOADS

LAYERS = [dict(order="feature_first", f_in=5414, f_out=16), dict(order="aggregation_first", f_in=16, f_out=210)]


def _event(name, start, end, cuda=False, thread=1):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=dt, thread=thread,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _view(events, span="bench.step", unit="step"):
    facts = dict(layer_calls=LAYERS, train=unit == "step", sizes={}, is_port_kernel=lambda n: False, model_flops=1.0)
    return TraceView(events, span, unit, facts)


def _read(metric, view):
    return spec.reader(metric)(types.SimpleNamespace(trace=view))


def _step(t, drift=0.0):
    """One 10 ms training step at ``t`` µs. Main thread: fake quant (two
    launches: 1 ms and 2 ms on the device), the pad copy (one launch:
    0.5 ms), then the backward, during which the autograd engine's thread
    (2) launches a kernel (3 ms), waits 0.2 ms in a tile-index sync whose
    device-to-host copy takes 0.01 ms, and launches another kernel (1 ms);
    then the optimizer (a memset, 0.002 ms, and a kernel, 0.25 ms); then
    ``float(loss)`` (a copy, 0.01 ms). The device's timestamps read
    ``drift`` µs early."""
    ev = [_event("bench.step", t, t + 10_000.0), _event("bench.step", t, t + 10_000.0, cuda=True)]
    ev += [_event("quant.fake_quant", t + 10, t + 100), _event("cudaLaunchKernel", t + 20, t + 25),
           _event("cudaLaunchKernel", t + 50, t + 55), _event("kernels.pad_rows", t + 110, t + 130),
           _event("cudaLaunchKernel", t + 115, t + 120)]
    ev += [_event("train.backward", t + 200, t + 4_000),
           _event("cudaLaunchKernel", t + 210, t + 215, thread=2),
           _event("sync.tile_index", t + 300, t + 500, thread=2),
           _event("cudaMemcpyAsync", t + 310, t + 315, thread=2),
           _event("cudaStreamSynchronize", t + 316, t + 500, thread=2),
           _event("cudaLaunchKernel", t + 600, t + 605, thread=2)]
    ev += [_event("train.optimizer", t + 4_100, t + 4_300), _event("cudaMemsetAsync", t + 4_110, t + 4_112),
           _event("cudaLaunchKernel", t + 4_120, t + 4_125), _event("cudaMemcpyAsync", t + 4_400, t + 4_405),
           _event("cudaStreamSynchronize", t + 4_405, t + 9_000)]
    dev = [("vectorized_elementwise_kernel", 30, 1_000), ("gatherTopK", 1_030, 2_000),
           ("CatArrayBatchedCopy", 3_030, 500), ("bmm", 3_530, 3_000), ("Memcpy DtoH", 6_530, 10),
           ("index_add", 6_540, 1_000), ("Memset", 7_540, 2), ("adam", 7_542, 250), ("Memcpy DtoH", 7_792, 10)]
    ev += [_event(name, t + a - drift, t + a + d - drift, cuda=True) for name, a, d in dev]
    return ev


def _steps(n, drift_per_step=0.0):
    return [e for k in range(n) for e in _step(10_000.0 * k, drift=drift_per_step * k)]


def test_each_operation_goes_to_its_enqueue_call():
    view = _view(_steps(3))
    per = spans.device_ops_in(view, "quant.fake_quant")
    assert [[o.name for o in ops] for ops in per] == [["vectorized_elementwise_kernel", "gatherTopK"]] * 3
    assert [o.name for o in spans.device_ops_in(view, "sync.tile_index")[1]] == ["Memcpy DtoH"]


def test_span_metrics_of_a_step():
    view = _view(_steps(3))
    assert _read("quant_ms.train", view) == pytest.approx(3.0)
    assert _read("pad_copy_ms.train", view) == pytest.approx(0.5)
    assert _read("backward_ms.train", view) == pytest.approx(4.01)
    assert _read("optimizer_ms.train", view) == pytest.approx(0.252)
    assert _read("host_sync_ms.train", view) == pytest.approx(0.2)


def test_device_timestamps_drifting_early():
    """Each step's device operations read 1.5 ms earlier than the last's,
    so that they start inside the step before: the order still pairs each
    with its call."""
    view = _view(_steps(4, drift_per_step=1_500.0))
    assert [len(o) for o in view.per_span(view.device)] != [9] * 4     # by their own starts, steps mix
    assert _read("quant_ms.train", view) == pytest.approx(3.0)
    assert _read("backward_ms.train", view) == pytest.approx(4.01)
    assert _read("optimizer_ms.train", view) == pytest.approx(0.252)


def test_device_timestamps_drifting_late_past_the_window():
    """Late device timestamps push the last step's final operations past
    the window's end, which drops them: that step is left out."""
    view = _view(_steps(4, drift_per_step=-1_500.0))
    assert sorted(spans.paired_units(view)) == [0, 1, 2]
    assert _read("backward_ms.train", view) == pytest.approx(4.01)
    assert _read("optimizer_ms.train", view) == pytest.approx(0.252)


def test_backward_launches_from_another_thread_are_inside_it():
    """The backward's launches run on the engine's thread, not nested under
    the caller's ``train.backward`` event: containment is by time."""
    view = _view(_steps(2))
    bwd = spans.device_ops_in(view, "train.backward")[0]
    assert [o.name for o in bwd] == ["bmm", "Memcpy DtoH", "index_add"]
    assert sum(o.end - o.start for o in bwd) == pytest.approx(4010.0)


def _request(t):
    return [_event("bench.request", t, t + 5_000.0), _event("sync.nnz_blocks", t + 100, t + 300),
            _event("cudaMemcpyAsync", t + 110, t + 115), _event("cudaStreamSynchronize", t + 115, t + 300),
            _event("kernels.pad_rows", t + 400, t + 420), _event("cudaLaunchKernel", t + 405, t + 410),
            _event("cudaLaunchKernel", t + 500, t + 505), _event("cudaMemcpyAsync", t + 600, t + 605),
            _event("Memcpy DtoH", t + 120, t + 121, cuda=True),
            _event("CatArrayBatchedCopy", t + 420, t + 1420, cuda=True),
            _event("xw_kernel", t + 1420, t + 3420, cuda=True), _event("Memcpy DtoH", t + 3420, t + 3430, cuda=True)]


def test_request_metrics_and_nested_sync():
    view = _view(_request(0.0) + _request(6_000.0), "bench.request", "request")
    assert _read("pad_copy_ms.infer", view) == pytest.approx(1.0)
    assert _read("host_sync_ms.infer", view) == pytest.approx(0.2)
    assert _read("quant_ms.infer", view) is None              # no fake quant in this program


@pytest.mark.parametrize("where", ["first step's first kernel", "second step's gather", "third step's final copy",
                                   "a launch with no operation"])
def test_a_step_with_a_lost_operation_is_left_out(where):
    """The profiler lost one operation (or the window cut the last one off):
    that step is left out, the others still pair."""
    ev = _steps(3)
    lost = {"first step's first kernel": ("vectorized_elementwise_kernel", 0),
            "second step's gather": ("bmm", 10_000), "third step's final copy": ("Memcpy DtoH", 27_000)}
    if where in lost:
        name, after = lost[where]
        first = min(e.time_range.start for e in ev if e.name == name and e.time_range.start >= after)
        ev = [e for e in ev if not (e.name == name and e.time_range.start == first)]
    else:
        ev.append(_event("cudaLaunchKernel", 20_000.0 + 4_130, 20_000.0 + 4_135))
    view = _view(ev)
    assert len(spans.paired_units(view)) == 2
    assert _read("quant_ms.train", view) == pytest.approx(3.0)
    assert _read("backward_ms.train", view) == pytest.approx(4.01)
    assert _read("optimizer_ms.train", view) == pytest.approx(0.252)


def _without(ev, name, step):
    """``ev`` less the first event called ``name`` in the given step."""
    first = min(e.time_range.start for e in ev if e.name == name and e.time_range.start >= 10_000.0 * step)
    return [e for e in ev if not (e.name == name and e.time_range.start == first)]


@pytest.mark.parametrize("where", ["two lost operations in a row", "an operation whose call was lost"])
def test_the_walk_resumes_after_a_step_in_the_middle(where, capsys):
    """A step in the middle of the window that does not pair is left out,
    and the walk resumes at the next: the steps after it still count."""
    ev = _steps(5)
    if where == "two lost operations in a row":
        ev = _without(_without(ev, "bmm", 2), "Memcpy DtoH", 2)
    else:
        ev = _without(ev, "cudaLaunchKernel", 2)
    view = _view(ev)
    assert sorted(spans.paired_units(view)) == [0, 1, 3, 4]
    assert _read("quant_ms.train", view) == pytest.approx(3.0)
    assert _read("backward_ms.train", view) == pytest.approx(4.01)
    assert _read("optimizer_ms.train", view) == pytest.approx(0.252)
    assert capsys.readouterr().err.count("spans: 4 of 5 steps pair") == 1     # once a trace, for every metric


@pytest.mark.parametrize("where", ["two steps in the middle", "every step from the third on"])
def test_too_few_paired_steps_read_nothing(where, capsys):
    """Past one step in a hundred (and one at the least) left out inside
    the window, the reading is None, not what the steps that paired say:
    also where the walk cannot resume at all (the profiler stopped
    recording copies)."""
    ev = _steps(6)
    if where == "two steps in the middle":
        ev = _without(_without(ev, "bmm", 1), "bmm", 3)
    else:
        ev = [e for e in ev if not (e.name.startswith("Memcpy") and e.time_range.start >= 20_000.0)]
    view = _view(ev)
    assert spans.paired_units(view) is None
    for metric in ("quant_ms.train", "pad_copy_ms.train", "backward_ms.train", "optimizer_ms.train"):
        assert _read(metric, view) is None, metric
    paired = {"two steps in the middle": 4, "every step from the third on": 2}[where]
    assert f"spans: {paired} of 6 steps pair" in capsys.readouterr().err


def test_nothing_is_attributed_where_calls_and_operations_never_agree():
    ev = [e for e in _steps(3) if not e.name.startswith("Memcpy")]      # no copy reached the trace
    view = _view(ev)
    for metric in ("quant_ms.train", "pad_copy_ms.train", "backward_ms.train", "optimizer_ms.train"):
        assert _read(metric, view) is None, metric
    assert _read("host_sync_ms.train", view) == pytest.approx(0.2)   # host time needs no pairing


def test_a_program_without_spans_reads_nothing():
    """The parent of the program's spans: every new metric is left out."""
    view = _view([e for e in _steps(2) if e.name.split(".")[0] not in ("quant", "kernels", "train", "sync")])
    for metric in ("quant_ms.train", "pad_copy_ms.train", "backward_ms.train", "optimizer_ms.train",
                   "host_sync_ms.train"):
        assert _read(metric, view) is None, metric


def _open_spans_recorder():
    """A `TraceRecorder` that also knows which of its spans are open on the
    calling thread."""
    from repro_torch.obs.trace import TraceRecorder

    class OpenSpans(TraceRecorder):
        local = threading.local()

        def open(self) -> list[str]:
            return list(getattr(self.local, "stack", []))

        @contextlib.contextmanager
        def span(self, name, sync=None, args=None, track=None):
            stack = self.local.__dict__.setdefault("stack", [])
            stack.append(name)
            try:
                with super().span(name, sync=sync, args=args, track=track) as handle:
                    yield handle
            finally:
                stack.pop()

    return OpenSpans()


def _innermost(stack) -> tuple[str, str] | None:
    """(file, function) of the innermost frame of the port or, where the
    port has none, of the benchmark's program adapter."""
    for part in ("/repro_torch/", "/families/gcn/"):
        for f in reversed(stack):
            if part in f.filename:
                return f.filename.split(part, 1)[1], f.name
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_sync_in_the_middle_of_the_work_is_in_a_sync_span(workload):
    """One request (step) of the cell at its full size, under
    ``torch.cuda.set_sync_debug_mode("warn")``: each synchronizing call the
    card reports sits inside a ``sync.*`` span, but for the request's own
    end (the stream sync in the program adapter's ``request``) and the
    step's loss read (``Trainer.fit``), which end the work by design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from families.gcn.cell import Session
    from repro_torch.obs import trace

    cell = spec.find_cell(workload)
    device = torch.device("cuda", 0)
    session = Session(cell.config, cell.traffic, device, cell.limits)
    run = session.start(1_000_000_007)
    prog = session.program
    if run.unit == "request":
        ids, rows = session.data.refresh_chunk(1_000_000_007, 0, float(cell.traffic["refresh_fraction"]))
        work, end = (lambda: prog.request(ids[0], rows[0])), ("program.py", "request")
    else:
        work, end = prog.step, ("train/loop.py", "fit")
    rec = _open_spans_recorder()
    old = trace.set_default_tracer(rec)
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            found.append((rec.open(), _innermost(traceback.extract_stack()[:-1])))

    try:
        with torch.inference_mode(run.unit == "request"), warnings.catch_warnings():
            work()
            torch.cuda.synchronize(device)
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                work()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        trace.set_default_tracer(old)
        run.finish()
        session.close()
        gc.collect()
        torch.cuda.empty_cache()
    outside = [(open_, where) for open_, where in found if not any(n.startswith("sync.") for n in open_)]
    assert outside == [(["train.step"] if run.unit == "step" else [], end)], found
    assert len(found) > 1, found      # the mode reports the syncs inside the spans too
