"""A GCN cell: set-up, the measured window and the comparison with the plain
reference, for the two loops a traffic file can name.

* ``"loop": "infer"`` — one client in a closed loop. Request k brings new
  rows for ``refresh_fraction`` of the nodes (drawn from the seed and k, made
  on the device before the request's clock starts), the program takes them
  into its features, runs the full-graph forward and returns every node's
  class id on the host. ``warmup`` requests run in set-up; the window's
  requests follow them in the same sequence.
* ``"loop": "train"`` — full-batch training steps of the program's
  `Trainer`, the loss read back after each. Set-up builds the trainer and
  drives its first ``checked_steps`` steps; the window steps the same
  trainer on.

What is compared, once the window has closed and the program's state is
freed (`judge`):

The reference computes every layer from the raw inputs itself. It follows
the program only through ties of a step function (a 4-bit code of an
activation or, after an update, of a weight exactly between two levels, a
ReLU input summing to exactly 0; `reference.GCN.layer`): at an element where
the two sides' values agree within the limit of the gap that holds that
layer (``layer1_gap``, ``hidden_gap``), and the step still differs, it takes
the program's side of the step, and counts it (``followed``). `PERF.md`
says why.

* infer: for a sample of the window's requests drawn from the seed and its
  last request, the features as that request saw them are rebuilt from the
  seed. ``layer1_gap``: the program's first layer against the reference's;
  ``logit_gap``: each later layer against the reference's; ``class_gap``:
  how far below the best of its own last layer's logits the class returned
  for a node lies (0 exactly for the argmax; the logits themselves are held
  by ``logit_gap``). All three relative to the largest reference magnitude
  of the layer.
* train: ``hidden_gap``, the hidden layers' outputs at every checked step
  against the reference's; ``loss_gap``, the checked steps' losses, relative; ``grad_gap``,
  the first gradient's norm per leaf as the optimizer got it (from its first
  moment after one step); ``update_gap``, the norm of each leaf's change
  over the checked steps. Both of the latter by the worst leaf, the gap of
  the norms against the reference's norm of that leaf or the median leaf's,
  whichever is larger; a leaf whose reference gradient is under a thousandth
  of the median leaf's is left out of ``update_gap``.

``control=True`` puts the reference, computed with TF32 products, in the
program's place and reads the same numbers.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from benchlib.window import Window
from families.gcn import kernels, reference as ref
from families.gcn.inputs import Dataset, stream_seed, weights
from families.gcn.program import GcnProgram

CHECK_SAMPLE = 2            # window requests checked besides the last one
CHECK_RANGE = 32            # ... drawn from the first CHECK_RANGE of the window
REQUEST_SPAN, STEP_SPAN, REFRESH_SPAN = "bench.request", "bench.step", "bench.refresh"
SPAN = {"request": REQUEST_SPAN, "step": STEP_SPAN}
# The gap whose limit holds the layers that the reference follows through ties.
FOLLOW_LIMIT = {"infer": "layer1_gap", "train": "hidden_gap"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _annotate(trace: bool, name: str):
    return torch.profiler.record_function(name) if trace else contextlib.nullcontext()


class Session:
    """What a configuration sets up once, whatever the seed: its dataset and
    the program's derivations from it."""

    def __init__(self, config: dict, traffic: dict, device: torch.device, limits: dict):
        self.config, self.traffic, self.device = config, traffic, device
        self.loop = traffic["loop"]
        if self.loop not in ("infer", "train"):
            raise ValueError(f"unknown loop {self.loop!r} in traffic {traffic.get('name')}")
        self.follow_tol = float(limits[FOLLOW_LIMIT[self.loop]])
        t0 = time.perf_counter()
        self.data = Dataset(config["graph"], device)
        features = self.data.features()
        sync(device)
        t1 = time.perf_counter()
        self.program = GcnProgram(config, self.data, features)
        sync(device)
        self.setup_split = dict(inputs_s=t1 - t0, program_setup_s=time.perf_counter() - t1)
        expected = config.get("derived_sizes", {})
        wrong = {k: (self.program.sizes.get(k), v) for k, v in expected.items() if self.program.sizes.get(k) != v}
        if wrong:
            raise RuntimeError(f"the program derived other sizes than the configuration states (got, stated): {wrong}")

    def start(self, seed: int) -> "Run":
        return (InferRun if self.loop == "infer" else TrainRun)(self, seed)

    def reset(self) -> None:
        """Features back to the dataset's (after an infer run mutated them)."""
        self.program.x.copy_(self.data.features()[self.program.perm])

    def close(self) -> None:
        self.program.close()


class Run:
    unit = "request"

    def __init__(self, session: Session, seed: int):
        self.s, self.seed = session, seed
        self.prog = session.program
        self.model = session.config["model"]
        self.params0 = weights(self.model["layer_dims"], seed, session.device)

    def facts(self) -> dict:
        """What the per-layer metrics read beside the trace: each layer's
        dataflow and widths as the first forward ran them, the tile tables'
        sizes, and the model FLOPs of one request or step."""
        dims = self.model["layer_dims"]
        graph = self.s.config["graph"]
        return dict(
            layer_calls=self.prog.layer_calls, train=self.unit == "step",
            sizes=dict(self.prog.sizes), is_port_kernel=kernels.is_port_kernel,
            model_flops=kernels.model_flops(dims, int(graph["n_nodes"]),
                                            int(self.prog.sizes["edges_with_self_loops"]),
                                            train=self.unit == "step"))

    def finish(self) -> None:
        """Keep what the comparison reads and drop every other reference to
        the program's state (`Session.close` then frees it)."""


class InferRun(Run):
    unit = "request"

    def __init__(self, session: Session, seed: int):
        super().__init__(session, seed)
        self.fraction = float(session.traffic["refresh_fraction"])
        self.prog.load({k: v.clone() for k, v in self.params0.items()})
        self.k = 0
        self.chunk, self.chunk_id = session.data.chunk_size(self.fraction), None
        rng = np.random.default_rng(stream_seed(seed, 7))
        warm = int(session.traffic["warmup"])
        self.checked = set(int(i) + warm for i in rng.choice(CHECK_RANGE, CHECK_SAMPLE, replace=False))
        self.kept: dict[int, tuple] = {}
        self._observer = self.prog.observe_layers()
        self._observer.__enter__()
        with torch.inference_mode():
            for _ in range(warm):
                self._one(trace=False)
        sync(session.device)

    def _refresh(self, k: int):
        """Request k's (node ids, rows): its chunk is drawn when k enters it,
        and the device finishes the draw before the request's clock starts."""
        c, i = divmod(k, self.chunk)
        if c != self.chunk_id:
            self.chunk_rows = self.s.data.refresh_chunk(self.seed, c, self.fraction)
            self.chunk_id = c
            sync(self.s.device)
        ids, rows = self.chunk_rows
        return ids[i], rows[i]

    def _one(self, trace: bool) -> float:
        with _annotate(trace, REFRESH_SPAN):
            ids, rows = self._refresh(self.k)
        t0 = time.perf_counter()
        with _annotate(trace, REQUEST_SPAN):
            classes = self.prog.request(ids, rows)
        dt = time.perf_counter() - t0
        layers = list(self.prog.layer_outputs)
        self.last = (self.k, layers, classes)
        if self.k in self.checked:
            self.kept[self.k] = self._copy(layers, classes)
        self.k += 1
        return dt

    def _copy(self, layers: list, classes: torch.Tensor) -> tuple:
        """A request's layers, rows in node order, and its class ids, copied
        out of whatever storage the program may use again."""
        n, pos = self.s.data.n_nodes, self.prog.pos
        return [o[:n][pos] for o in layers], classes.clone()

    def window(self, seconds: float, trace: bool = False) -> Window:
        lat = []
        with torch.inference_mode():
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                lat.append(self._one(trace))
            end = time.perf_counter()
        k, layers, classes = self.last
        self.kept[k] = self._copy(layers, classes)
        return Window(kind=self.unit, seconds=end - start, latencies=lat)

    def finish(self) -> None:
        self._observer.__exit__(None, None, None)
        self.outputs, self.kept, self.last = self.kept, {}, None

    def _replay(self):
        """(k, features as request k saw them) for each checked k, in order."""
        data, x, done = self.s.data, self.s.data.features(), 0
        for k in sorted(self.outputs):
            for j in range(done, k + 1):
                c, i = divmod(j, self.chunk)
                if i == 0 or j == done:
                    ids, rows = data.refresh_chunk(self.seed, c, self.fraction)
                x[ids[i]] = rows[i]
            done = k + 1
            yield k, x

    def readings(self, control: bool = False) -> dict:
        adj = ref.Adjacency(self.s.data.edge_index, self.s.data.n_nodes, self.s.device)
        model = ref.GCN(self.model, adj)
        twin = ref.GCN(self.model, adj, tf32=True)
        out = dict(layer1_gap=0.0, logit_gap=0.0, class_gap=0.0)
        with torch.no_grad():
            for k, x in self._replay():
                if control:
                    layers = twin.forward(self.params0, x)
                    classes = layers[-1].argmax(dim=1).cpu()
                else:
                    layers, classes = self.outputs[k]
                for name, value in infer_gaps(model, self.params0, x, layers, classes, self.s.follow_tol).items():
                    out[name] = max(out.get(name, 0), value)
        out["checked_requests"] = sorted(self.outputs)
        out["followed"] = model.followed
        return out


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b|, NaN counting as infinite."""
    scale = float(b.abs().max())
    diff = float((a.float() - b).abs().nan_to_num(nan=float("inf")).max())
    return diff / scale if scale > 0 else diff


def infer_gaps(model: ref.GCN, params: dict, x: torch.Tensor, layers: list, classes: torch.Tensor,
               tol: float) -> dict:
    if len(layers) != model.n_layers:
        return dict(layer1_gap=float("inf"), logit_gap=float("inf"), class_gap=float("inf"))
    expected = model.forward(params, x, follow=layers[:-1], tol=tol)
    gaps = dict(layer1_gap=_rel_max(layers[0], expected[0]), logit_gap=0.0)
    for got, expect in zip(layers[1:], expected[1:]):
        gaps["logit_gap"] = max(gaps["logit_gap"], _rel_max(got, expect))
    expect = expected[-1]
    served = classes.to(expect.device).long()
    last = layers[-1].float()
    if served.shape != last.shape[:1] or int(served.min()) < 0 or int(served.max()) >= last.shape[1]:
        gaps["class_gap"] = float("inf")
    else:
        below = last.max(dim=1).values - last.gather(1, served[:, None])[:, 0]
        gaps["class_gap"] = float(below.max()) / float(expect.abs().max())
    return gaps


class TrainRun(Run):
    unit = "step"

    def __init__(self, session: Session, seed: int):
        super().__init__(session, seed)
        self.opt = session.config["optimizer"]
        self.steps = int(session.traffic["checked_steps"])
        self.prog.make_trainer({k: v.clone() for k, v in self.params0.items()}, self.opt)
        self.losses, self.hidden, self.step_params = [], [], []
        with self.prog.observe_layers():
            for t in range(self.steps):
                self.step_params.append({k: p.detach().clone() for k, p in self.prog.parameters().items()})
                self.prog.layer_outputs.clear()
                self.losses.append(self.prog.step())
                self.hidden.append([o.detach()[: self.prog.n][self.prog.pos] for o in self.prog.layer_outputs[:-1]])
                if t == 0:
                    self.m1 = {k: m.detach().clone() for k, m in self.prog.first_moment().items()}
        self.p_checked = {k: p.detach().clone() for k, p in self.prog.parameters().items()}
        sync(session.device)

    def window(self, seconds: float, trace: bool = False) -> Window:
        lat = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            with _annotate(trace, STEP_SPAN):
                self.prog.step()
            lat.append(time.perf_counter() - t0)
        end = time.perf_counter()
        return Window(kind=self.unit, seconds=end - start, latencies=lat)

    def finish(self) -> None:
        b1 = float(self.opt["b1"])
        self.result = dict(losses=list(self.losses), hidden=self.hidden, step_params=self.step_params,
                           first_grad={k: m / (1 - b1) for k, m in self.m1.items()}, params=self.p_checked)
        self.m1 = self.p_checked = None

    def reference(self, tf32: bool = False, follow: dict | None = None) -> dict:
        adj = ref.Adjacency(self.s.data.edge_index, self.s.data.n_nodes, self.s.device)
        model = ref.GCN(self.model, adj, tf32=tf32)
        return ref.train(model, dict(self.params0), self.s.data.features(), self.s.data.labels,
                         self.s.data.train_mask, self.opt, self.steps, follow, self.s.follow_tol)

    def readings(self, control: bool = False) -> dict:
        got = self.reference(tf32=True) if control else self.result
        return train_gaps(self.reference(follow=got), got, self.params0)


def _leaf_gaps(expect: dict, got: dict, keys) -> dict:
    """Per leaf in ``keys``: the gap of the norms over the reference's norm
    of the leaf or of the median leaf, whichever is larger."""
    norms = {k: float(torch.linalg.vector_norm(expect[k].float())) for k in expect}
    median = statistics.median(norms.values())
    out = {}
    for k in keys:
        gap = abs(float(torch.linalg.vector_norm(got[k].float())) - norms[k])
        denom = max(norms[k], median)
        out[k] = gap / denom if denom > 0 else gap
    return out


def train_gaps(expect: dict, got: dict, params0: dict) -> dict:
    if len(got["losses"]) != len(expect["losses"]) or not all(np.isfinite(got["losses"])):
        return dict(hidden_gap=float("inf"), loss_gap=float("inf"), grad_gap=float("inf"), update_gap=float("inf"))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], expect["losses"]))
    grad = _leaf_gaps(expect["first_grad"], got["first_grad"], expect["first_grad"])
    gnorm = {k: float(torch.linalg.vector_norm(g)) for k, g in expect["first_grad"].items()}
    moved = [k for k, g in gnorm.items() if g >= 1e-3 * statistics.median(gnorm.values())]
    delta = {k: expect["params"][k] - params0[k] for k in params0}
    delta_got = {k: got["params"][k].to(params0[k].device) - params0[k] for k in params0}
    update = _leaf_gaps(delta, delta_got, moved)
    if any(len(a) != len(b) for a, b in zip(got["hidden"], expect["hidden"])):
        hidden_gap = float("inf")
    else:
        hidden_gap = max((_rel_max(a, b) for got_t, expect_t in zip(got["hidden"], expect["hidden"])
                          for a, b in zip(got_t, expect_t)), default=0.0)
    return dict(hidden_gap=hidden_gap, loss_gap=loss_gap, grad_gap=max(grad.values()), update_gap=max(update.values()),
                grad_by_leaf=grad, update_by_leaf=update, losses=list(got["losses"]),
                reference_losses=list(expect["losses"]), followed=expect["followed"])
