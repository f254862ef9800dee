"""Set up and tear down a k-rank `torch.distributed` group — the port's
counterpart of `repro.launch.mesh`.

The reference runs one program over a device mesh (``shard_map``); the port
runs one process per rank. `run_group` starts ``k`` processes, joins them
into one group, calls ``fn(rank, k, device, arg)`` in each with that rank's
own argument, and returns the k results in rank order. Everything that
shapes the run is an explicit field of :class:`GroupSpec`, and
:meth:`GroupSpec.describe` says it in one line for the callers to print:

* the backend: ``gloo`` (host tensors; any number of ranks per card) or
  ``nccl`` (one rank per card),
* the device of each rank (several ranks may share one card),
* the start method: ``spawn``, the only one safe in a parent that has
  already initialized CUDA,
* the rendezvous: a ``file://`` store in a fresh temporary directory, so
  that groups started side by side (tests run in parallel) never fight
  over a port.

Nothing falls back: a rank that raises, dies or outlasts the timeout ends
the whole group (the other ranks are terminated) and `run_group` raises
with that rank's traceback.

`Grid` is the reference's device mesh as the port needs it: named axes
and their sizes (``("data", "model")`` 2 × 2, or ``("pod", "data",
"model")``), a rank's coordinates (global rank g raveled row-major over
the axes, as ``jax.make_mesh`` ravels its devices), and, inside a rank,
`Grid.groups`: the rank's data group and model group (`grid_groups` with
the data axes' product as the outer size). The sharded LM and DeepFM of
`repro_torch.launch.steps` run on it.

`production_grid` is the reference's ``make_production_mesh`` (16 × 16
``(data, model)``, or 2 × 16 × 16 ``(pod, data, model)``), `halo_axes`
its ``halo_axes``, and `fake_group` starts a `torch.distributed` group of
the ``fake`` backend at a grid's size in this one process (one rank of the
grid: every collective returns at once, on meta tensors too) and
destroys it on exit — the dry run's stand-in for the reference's
compile-only mesh (`repro_torch.launch.dryrun`).

Inside a rank, `halo_groups` gives the subgroups of the hierarchical
(pod, model) halo exchange — the counterpart of the reference's
``make_halo_mesh`` and ``halo_axes``: ranks are raveled pod-major, as the
reference's ``(pod, model)`` mesh ravels its devices and as
`repro_torch.dist.halo.build_halo_plan` assumes (global rank g is member
``g % k_model`` of pod ``g // k_model``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

__all__ = ["GroupSpec", "run_group", "grid_groups", "halo_groups", "Grid", "data_axes", "halo_axes",
           "production_grid", "fake_group"]


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One k-rank group: its backend, each rank's device and how the ranks
    start."""

    k: int
    backend: str = "gloo"
    devices: tuple[str, ...] = ("cpu",)   # one entry per rank, or one for all
    start_method: str = "spawn"
    timeout_s: float = 600.0              # whole run; also the group's collective timeout

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"a group needs at least one rank, got k={self.k}")
        if len(self.devices) not in (1, self.k):
            raise ValueError(f"devices names {len(self.devices)} devices for {self.k} ranks")
        if self.backend == "nccl" and len(set(self.device_of(r) for r in range(self.k))) < self.k:
            raise ValueError("nccl takes one rank per card; ranks that share a card need gloo")

    def device_of(self, rank: int) -> str:
        return self.devices[rank if len(self.devices) > 1 else 0]

    def describe(self) -> str:
        devices = (f"{self.devices[0]}×{self.k}" if len(self.devices) == 1
                   else ",".join(self.devices))
        return (f"k={self.k} backend={self.backend} devices={devices} "
                f"start={self.start_method} rendezvous=file threads/rank=1")


def _rank_main(rank: int, spec: GroupSpec, init_file: str, fn: Callable, arg: Any,
               results, released) -> None:
    """The body of one rank's process: join the group, run ``fn``, report,
    and stay until the parent has taken every result (a host tensor in a
    result crosses through shared memory, whose descriptor this process
    hands over)."""
    try:
        torch.set_num_threads(1)      # k ranks share the host's cores
        device = torch.device(spec.device_of(rank))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            spec.backend, init_method=f"file://{init_file}", world_size=spec.k, rank=rank,
            timeout=datetime.timedelta(seconds=spec.timeout_s),
        )
        try:
            out = fn(rank, spec.k, device, arg)
        finally:
            _GRID_GROUPS.clear()
            _HALO_GROUPS.clear()
            dist.destroy_process_group()
        results.put((rank, True, out))
        released.wait(spec.timeout_s)
    except BaseException:   # reported to the parent, which ends the group and raises
        results.put((rank, False, traceback.format_exc()))


def run_group(spec: GroupSpec, fn: Callable, args: list) -> list:
    """Run ``fn(rank, k, device, args[rank])`` on every rank of a fresh
    group; returns the results in rank order.

    ``fn`` and every argument must pickle (``fn`` by its import path: a
    module-level function). Raises RuntimeError when a rank raises, exits
    without a result, or the group outlasts ``spec.timeout_s``; every
    process started here has ended when this returns or raises.
    """
    if len(args) != spec.k:
        raise ValueError(f"run_group needs one argument per rank: {len(args)} for k={spec.k}")
    ctx = multiprocessing.get_context(spec.start_method)
    workdir = tempfile.mkdtemp(prefix="repro_torch_group_")
    init_file = os.path.join(workdir, "rendezvous")
    results, released = ctx.Queue(), ctx.Event()
    procs = [
        ctx.Process(target=_rank_main, args=(r, spec, init_file, fn, args[r], results, released),
                    name=f"rank{r}", daemon=True)
        for r in range(spec.k)
    ]
    out: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + spec.timeout_s
        while len(out) < spec.k:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    # A rank may have put its report just before exiting.
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                            f"and no result ({spec.describe()})") from None
                elif time.monotonic() > deadline:
                    raise RuntimeError(f"group did not finish in {spec.timeout_s:.0f} s "
                                       f"({spec.describe()}); ranks done: {sorted(out)}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed ({spec.describe()}):\n{value}")
            out[rank] = value
        released.set()
        for p in procs:
            p.join(timeout=60.0)
    finally:
        released.set()
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return [out[r] for r in range(spec.k)]


# (world size, outer) → this rank's (outer group, inner group); built once
# per group, since dist.new_group is itself a collective of every rank.
_GRID_GROUPS: dict[tuple[int, int], tuple] = {}


def grid_groups(outer: int) -> tuple:
    """This rank's two subgroups when the k ranks of the group form an
    ``outer × (k / outer)`` grid raveled outer-major (global rank g at
    ``(g // inner, g % inner)``): the ranks with its inner index in every
    outer slice, and the ranks of its own outer slice.

    Every rank of the group must call this with the same ``outer``, in the
    same order as its other collectives: it builds every slice's and every
    inner index's subgroup, each rank in the same order (`dist.new_group`
    needs all ranks; under gloo a rank that builds them in another order
    hangs the group until `run_group`'s timeout ends it). The groups are
    built once per ``(k, outer)`` and cached for the life of the group."""
    k = dist.get_world_size()
    if outer < 1 or k % outer:
        raise ValueError(f"{outer} slices must divide the group's {k} ranks")
    key = (k, outer)
    if key not in _GRID_GROUPS:
        inner, rank = k // outer, dist.get_rank()
        slices = [dist.new_group(list(range(p * inner, (p + 1) * inner))) for p in range(outer)]
        across = [dist.new_group(list(range(m, k, inner))) for m in range(inner)]
        _GRID_GROUPS[key] = (across[rank % inner], slices[rank // inner])
    return _GRID_GROUPS[key]


def halo_groups(pods: int):
    """The process groups this rank's halo exchange runs over: ``None``
    (the whole group: the flat schedule) when ``pods`` is 1, as the
    reference's ``halo_axes`` gives the flat axis for a pod axis of width 1;
    else the rank's ``(pod group, model group)`` of `grid_groups` (pods ×
    k_model, pod-major): the ranks with its member index across pods (phase
    1 of `repro_torch.dist.halo.hier_halo_exchange`), and the ranks of its
    own pod (phase 2). Called by every rank alike."""
    k = dist.get_world_size()
    if pods < 1 or k % pods:
        raise ValueError(f"pods={pods} must divide the group's {k} ranks")
    return None if pods == 1 else grid_groups(pods)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Named axes and their sizes: the reference's mesh shape. The axis
    ``model`` carries tensor and expert parallelism; every other axis
    carries the batch (`data_axes`). Global rank g sits at the row-major
    coordinates of g over ``axes``."""

    axes: tuple[str, ...] = ("data", "model")
    sizes: tuple[int, ...] = (1, 1)

    def __post_init__(self):
        if len(self.axes) != len(self.sizes) or "model" not in self.axes:
            raise ValueError(f"a grid names each axis once with its size, one of them 'model': {self}")
        if self.axes[-1] != "model":
            raise ValueError("the model axis is the innermost: a rank's model group is a run of consecutive ranks")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.axes

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return int(math.prod(self.sizes))

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def n_data(self) -> int:
        return self.size // self.n_model

    def coords(self, rank: int) -> dict[str, tuple[int, int]]:
        """Axis → (this rank's index on it, the axis size)."""
        out, rest = {}, rank
        for axis, n in zip(reversed(self.axes), reversed(self.sizes)):
            out[axis] = (rest % n, n)
            rest //= n
        return {axis: out[axis] for axis in self.axes}

    def groups(self) -> tuple:
        """This rank's (data group, model group) in a running group of
        ``size`` ranks: the ranks with its model index across the data
        axes, and the ranks of its own data slice. Called by every rank
        alike (`grid_groups`)."""
        if dist.get_world_size() != self.size:
            raise ValueError(f"the group has {dist.get_world_size()} ranks; the grid {self.shape} needs {self.size}")
        return grid_groups(self.n_data)

    def halo_groups(self) -> tuple:
        """This rank's groups of a full-graph GNN cell (the reference's
        ``halo_axes``): ``(whole, pod, model)``. ``whole`` holds the ranks
        that share its index on every axis but the halo axes (the graph is
        sharded over them; the other axes replicate it), ``model`` those of
        its own pod along ``model``, and ``pod`` those with its member index
        across pods — ``None`` unless the pod axis is wider than one, when
        ``whole`` is the flat schedule's group and ``model`` is ``whole``.
        Built once per grid, every rank building every group in the same
        order (`dist.new_group` needs all ranks)."""
        if dist.get_world_size() != self.size:
            raise ValueError(f"the group has {dist.get_world_size()} ranks; the grid {self.shape} needs {self.size}")
        key = (self.axes, self.sizes)
        if key not in _HALO_GROUPS:
            hier = halo_axes(self) == ("pod", "model")
            shard = ("pod", "model") if hier else ("model",)
            rank = dist.get_rank()

            def groups_over(axes):
                """Every group of the ranks that differ only on ``axes``, in
                a fixed order; the caller's own one."""
                rest = [a for a in self.axes if a not in axes]
                mine = None
                for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
                    members = [g for g in range(self.size)
                               if all(self.coords(g)[a][0] == i for a, i in zip(rest, fixed))]
                    group = dist.new_group(members)
                    if rank in members:
                        mine = group
                return mine

            whole = groups_over(shard)
            if hier:
                _HALO_GROUPS[key] = (whole, groups_over(("pod",)), groups_over(("model",)))
            else:
                _HALO_GROUPS[key] = (whole, None, whole)
        return _HALO_GROUPS[key]


# (axes, sizes) → this rank's (whole, pod, model) groups of `Grid.halo_groups`.
_HALO_GROUPS: dict[tuple, tuple] = {}


def halo_axes(grid: Grid) -> tuple[str, ...]:
    """The axes a full-graph halo exchange runs over: ``("pod", "model")``
    when the grid has a pod axis wider than one (the hierarchical
    two-phase schedule), else ``("model",)`` (a pod axis of width 1 is no
    hierarchy)."""
    if "pod" in grid.axis_names and grid.shape["pod"] > 1:
        return ("pod", "model")
    return ("model",)


def production_grid(multi_pod: bool = False) -> Grid:
    """The reference's production mesh as a grid: 16 × 16 ``(data,
    model)``, or 2 × 16 × 16 ``(pod, data, model)``."""
    if multi_pod:
        return Grid(("pod", "data", "model"), (2, 16, 16))
    return Grid(("data", "model"), (16, 16))


@contextlib.contextmanager
def fake_group(grid: Grid, rank: int = 0):
    """A process group of the ``fake`` backend of ``grid.size`` ranks in
    this process, which plays rank ``rank``; destroyed (with every cached
    subgroup) on exit. Refuses to start inside another group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: this process already belongs to a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=grid.size)
    try:
        yield grid
    finally:
        _GRID_GROUPS.clear()
        _HALO_GROUPS.clear()
        dist.destroy_process_group()


def data_axes(grid: Grid) -> tuple[str, ...]:
    """The batch-carrying axes: ``("pod", "data")`` on a multi-pod grid,
    only the axes the grid has (the reference's `data_axes`)."""
    names = grid.axis_names
    return tuple(a for a in ("pod", "data") if a in names) or ("data",)
