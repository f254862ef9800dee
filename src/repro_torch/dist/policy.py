"""The sharding policy the model reads — twin of `repro.dist.policy`.

A :class:`ShardingPolicy` carries the GNN **communication mode**:

* ``comm="broadcast"`` — the paper's Fig. 5c schedule. Unbound, its
  ``neighbor_table`` is the identity (the unsharded forward, every
  existing caller). Bound (`ShardingPolicy.bind` of a full-graph cell on
  a grid), each rank holds its block of the nodes and the edges whose
  receivers it owns, and
  ``neighbor_table(h)`` all-gathers the whole node table over the group
  every layer; the backward of that all-gather is a reduce-scatter.
* ``comm="halo"`` — the sharded full-graph schedule: each rank of a
  `torch.distributed` group runs the model on its block of a
  :class:`~repro_torch.dist.halo.HaloPlan` layout, and
  ``neighbor_table(h)`` returns ``[local ‖ halo]`` — the rank's block plus
  the exchanged boundary rows — which plan-relocalized senders index.

The reference names a mesh axis; the port names a process group (``None``
is the default group). Models call ``policy.neighbor_table(x)`` before
every sender-side gather and work identically under both modes (and under
:data:`NO_POLICY`). The halo mode only activates once the rank binds its
export rows with ``bind_halo``: a flat plan's ``send_idx``, or a
hierarchical plan's ``send_loc``/``send_rem`` pair, whose two-phase
exchange runs over ``halo_groups``, the rank's (pod, model) subgroups
(`repro_torch.launch.mesh.halo_groups`, or `Grid.halo_groups` on a grid;
the reference's ``halo_axes``). ``constrain`` is the identity: there is
no mesh to place activations on, and the call keeps the model code in step
with the reference.

Training under halo (and under a bound broadcast) needs two more pieces of
the reference's ``shard_map`` (`replicate` and `psum`, and the policy's
methods of those names). There the parameters are closed over, so the
transpose of their broadcast sums each device's gradient over the mesh
axis; and the loss is ``psum(wsum) / psum(wcnt)``, whose ``psum`` (under
``check_vma=False``) hands each device's cotangent back to its own term.
`replicate` is the identity with an all-reduce (sum) over the group as its
backward, `psum` an all-reduce (sum) whose backward is the identity:
together every rank gets the unsharded gradient, and no other gradient
all-reduce is needed. Both run over ``group``, the whole group, under the
hierarchical exchange too: the reference's ``psum`` over both the pod and
the model axis. A process that runs alone (no process group: a cell on a
1 × 1 grid) is a group of one, where both are the identity.

The sharded LM and DeepFM (`repro_torch.launch.shardings`, the cells of
`repro_torch.launch.steps`) take a policy of the other kind: ``grid``
names the reference's mesh shape (`repro_torch.launch.mesh.Grid`),
``specs`` the reference's name → PartitionSpec contract (each spec a
tuple of axis names per dimension), and `ShardingPolicy.bind` — called
inside a rank — fills in the rank's data group and model group with its
index on each. The models then run Megatron's tensor parallelism over the
model group with the same pair: `replicate` (Megatron's *f*) where a
tensor every rank holds alike enters a per-rank computation, `psum`
(Megatron's *g*) where per-rank partial sums meet. Two more collectives,
neither with a gradient: `all_reduce_max` (the vocab-parallel
logsumexp's shift) and `all_gather` (the sharded logits gathered whole,
the MoE's expert ids over the data group). ``cache`` is the KV cache's
spec (`repro_torch.launch.shardings.cache_spec`): its kv-head entry or
its sequence entry names the axes the decode path splits it over.

Every collective of this module and of `repro_torch.dist.halo` reports to
one counting point, `note_collective`: `STATS` (count, bytes handed in,
host seconds of the synchronous calls) and `COLLECTIVES` (by the
reference's five kinds — ``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute`` for the ring's
send/recv steps — and ``total``: the count, the bytes the rank hands in,
and the bytes of the result, the reference's ``collective_bytes``). The
dry run (`repro_torch.launch.dryrun`) reads `COLLECTIVES` over one step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["ShardingPolicy", "NO_POLICY", "replicate", "psum", "reduce_scatter", "all_reduce_max", "all_gather",
           "STATS", "COLLECTIVES", "KINDS", "note_collective", "counting_collectives"]

#: When a dict, every collective adds to its ``count``, ``bytes`` (what the
#: rank hands the collective: the whole tensor of an all-reduce, the rank's
#: block of an all-gather, the blocks bound for the other ranks of an
#: all-to-all) and ``seconds`` (host clock around a synchronous call, the
#: staging through the host included; the halo exchange's calls add none).
STATS: dict | None = None

#: The reference's collective kinds (`repro.launch.dryrun`'s HLO names).
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: When a dict, every collective adds to ``COLLECTIVES[kind]`` and
#: ``COLLECTIVES["total"]`` its ``count``, ``bytes_in`` (`STATS`' bytes) and
#: ``bytes_out`` (the bytes of its result on this rank).
COLLECTIVES: dict | None = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def note_collective(kind: str, bytes_in: int, bytes_out: int, t0: float | None = None) -> None:
    """The one counting point of every collective call site."""
    if STATS is not None:
        STATS["count"] = STATS.get("count", 0) + 1
        STATS["bytes"] = STATS.get("bytes", 0) + bytes_in
        STATS["seconds"] = STATS.get("seconds", 0.0) + (0.0 if t0 is None else time.perf_counter() - t0)
    if COLLECTIVES is not None:
        for key in (kind, "total"):
            rec = COLLECTIVES.setdefault(key, {"count": 0, "bytes_in": 0, "bytes_out": 0})
            rec["count"] += 1
            rec["bytes_in"] += int(bytes_in)
            rec["bytes_out"] += int(bytes_out)


@contextlib.contextmanager
def counting_collectives():
    """``COLLECTIVES`` set to a fresh dict (every kind and ``total`` at zero)
    for the block, yielded, and restored after it."""
    global COLLECTIVES
    saved, COLLECTIVES = COLLECTIVES, {k: {"count": 0, "bytes_in": 0, "bytes_out": 0} for k in (*KINDS, "total")}
    try:
        yield COLLECTIVES
    finally:
        COLLECTIVES = saved


def _alone(group) -> bool:
    """A process with no process group: a group of one."""
    return group is None and not (dist.is_available() and dist.is_initialized())


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the ranks of ``group`` of ``x`` (a new tensor), through
    the host where the backend carries host tensors only (gloo)."""
    from repro_torch.dist.halo import _wire_on_host

    t0 = time.perf_counter()
    on_host = _wire_on_host(x, group)
    out = (x.detach().cpu() if on_host else x.detach()).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    out = out.to(x.device) if on_host else out
    note_collective("all-reduce", _nbytes(out), _nbytes(out), t0)
    return out


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``group``, with no
    gradient (the shift of a logsumexp, whose value does not depend on it)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (one shape on every rank) concatenated along ``dim``
    in the group's rank order, with no gradient; through the host under
    gloo."""
    from repro_torch.dist.halo import _wire_on_host

    t0 = time.perf_counter()
    on_host = _wire_on_host(x, group)
    src = (x.detach().cpu() if on_host else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    out = out.to(x.device) if on_host else out
    note_collective("all-gather", _nbytes(src), _nbytes(out), t0)
    return out


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``group``, of which rank r keeps block r
    along ``dim``: an all-to-all of the blocks, then a local sum in rank
    order; through the host under gloo."""
    from repro_torch.dist.halo import _wire_on_host

    t0 = time.perf_counter()
    k = dist.get_world_size(group)
    on_host = _wire_on_host(x, group)
    src = (x.detach().cpu() if on_host else x.detach()).movedim(dim, 0).contiguous()
    if src.shape[0] % k:
        raise ValueError(f"dim {dim} of size {src.shape[0]} does not split evenly over {k} ranks")
    got = torch.empty_like(src)
    dist.all_to_all_single(got, src, group=group)
    out = got.reshape(k, src.shape[0] // k, *src.shape[1:]).sum(0).movedim(0, dim)
    out = out.to(x.device) if on_host else out
    note_collective("reduce-scatter", _nbytes(src) * (k - 1) // k, _nbytes(out), t0)
    return out


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate(x: torch.Tensor, group=None) -> torch.Tensor:
    """A parameter every rank of ``group`` holds alike: the identity, whose
    backward sums the ranks' gradients (the transpose of the reference's
    closed-over, replicated parameters)."""
    return _Replicate.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``group`` (``jax.lax.psum``), whose
    backward hands each rank's cotangent back to its own term, as JAX
    transposes ``psum`` under ``check_vma=False``."""
    return _Psum.apply(x, group)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Block r along ``dim`` of the Σ of ``x`` over the ranks of ``group``,
    on rank r (``jax.lax.psum_scatter(..., tiled=True)``): a rank receives
    its block only, 1/k of a `psum`'s result. Backward: the ranks'
    cotangents gathered along ``dim``."""
    return _ReduceScatter.apply(x, group, dim)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The GNN communication mode (broadcast vs halo) and, for halo, the
    process group, the wire format and the schedule of the exchange; for
    the sharded LM and DeepFM, the grid, the named specs, the KV cache's
    spec and (once bound) the rank's data and model groups."""

    grid: Any = None                   # repro_torch.launch.mesh.Grid (the reference's mesh)
    specs: Any = dataclasses.field(default_factory=dict)   # name → spec tuple
    cache: tuple | None = None         # the KV cache's spec (launch.shardings.cache_spec)
    data_group: Any = None             # bound: this rank's data group (torch.distributed)
    model_group: Any = None            # bound: this rank's model group
    data_index: int = 0                # bound: this rank's index in its data group (over every data axis)
    model_index: int = 0               # bound: this rank's index in its model group
    group: Any = None                  # torch.distributed group; None = the default group
    comm: str = "broadcast"            # "broadcast" | "halo"
    halo_via: str = "all_gather"       # collective lowering (see halo_exchange)
    halo_send_idx: Any = None          # (s_max,) rank export rows; bound via bind_halo
    halo_payload: str | None = None    # wire format: None/"fp32" | "bf16" | "int8"
    halo_overlap: bool = True          # split interior/boundary aggregation
    halo_groups: Any = None            # hierarchical: this rank's (pod group, model group)
    halo_send_loc: Any = None          # hierarchical (s_loc,) intra-pod export rows
    halo_send_rem: Any = None          # hierarchical (s_rem,) inter-pod export rows
    graph: bool = False                # a full-graph GNN cell's policy: `bind` binds the graph groups
    bcast_bound: bool = False          # broadcast, bound: the node table is all-gathered over ``group``

    def constrain(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The identity: each rank already holds its block of every named
        activation. Kept so the model reads like the reference."""
        return x

    # ------------------------------------------------- the sharded LM / DeepFM
    @property
    def n_model(self) -> int:
        return 1 if self.grid is None else self.grid.n_model

    @property
    def n_data(self) -> int:
        return 1 if self.grid is None else self.grid.n_data

    @property
    def is_bound(self) -> bool:
        return self.model_group is not None

    def bind(self) -> "ShardingPolicy":
        """Copy with this rank's data and model groups and its index in each
        (inside a rank of a group of ``grid.size`` ranks; every rank calls
        it alike, since it may build the groups). A full-graph GNN policy
        (``graph``) binds the graph's groups instead (`Grid.halo_groups`):
        ``group``, the ranks that share the graph (the reference's
        ``halo_axes``), and under a pod axis wider than one the (pod,
        model) pair of the hierarchical exchange; a broadcast one takes its
        model group and all-gathers the node table over it. On a 1 × 1
        grid in a process alone nothing is built: every collective is the
        identity there."""
        if self.graph:
            bcast = self.comm == "broadcast"
            if self.grid.size == 1 and not dist.is_initialized():
                return dataclasses.replace(self, bcast_bound=bcast)
            whole, pod, model = self.grid.halo_groups()
            if bcast:                          # the reference shards the node table over `model` only
                return dataclasses.replace(self, group=model, bcast_bound=True)
            return dataclasses.replace(self, group=whole, halo_groups=None if pod is None else (pod, model))
        data_group, model_group = self.grid.groups()
        rank = dist.get_rank()
        return dataclasses.replace(self, data_group=data_group, model_group=model_group,
                                   data_index=rank // self.n_model, model_index=rank % self.n_model)

    def _check_bound(self) -> None:
        if self.n_model * self.n_data > 1 and not self.is_bound:
            raise ValueError("a sharded policy runs inside a rank: bind() it to the rank's groups first")

    def model_replicate(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *f* over the model group: the identity, whose backward
        sums the model ranks' partial cotangents."""
        self._check_bound()
        return replicate(x, self.model_group) if self.n_model > 1 else x

    def model_psum(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *g* over the model group: Σ of the ranks' partial sums."""
        self._check_bound()
        return psum(x, self.model_group) if self.n_model > 1 else x

    def data_psum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the data group (backward: each rank's own share)."""
        self._check_bound()
        return psum(x, self.data_group) if self.n_data > 1 else x

    def model_reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of Σ over the model group."""
        self._check_bound()
        return reduce_scatter(x, self.model_group, dim) if self.n_model > 1 else x

    def model_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the model group, no gradient."""
        self._check_bound()
        return all_reduce_max(x, self.model_group) if self.n_model > 1 else x.detach()

    def model_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model ranks' shards of ``x`` put together along ``dim`` (no
        gradient): the vocab-sharded logits whole, for a sampler or a test."""
        self._check_bound()
        return all_gather(x, self.model_group, dim) if self.n_model > 1 else x

    def data_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data ranks' ``x`` concatenated along ``dim`` (no gradient)."""
        self._check_bound()
        return all_gather(x, self.data_group, dim) if self.n_data > 1 else x

    def cache_split(self) -> tuple[str, Any, int, int]:
        """How ``cache``, the KV cache's (L, B, S, Hk, Dh) spec, splits it:
        (``"heads"`` | ``"seq"`` | ``"none"``, the group the split runs
        over, its size, this rank's index in it). Heads split over the model
        group; the sequence over the model group, or over every axis (the
        whole group, ranks in order: the batch-1 branch)."""
        names = lambda e: () if e is None else (e,) if isinstance(e, str) else tuple(e)
        if self.cache is None or not (names(self.cache[3]) or names(self.cache[2])):
            return "none", None, 1, 0
        kind, axes = ("heads", names(self.cache[3])) if names(self.cache[3]) else ("seq", names(self.cache[2]))
        if axes == ("model",):
            return kind, self.model_group, self.n_model, self.model_index
        if self.grid is not None and set(axes) == set(self.grid.axis_names):
            return kind, None, self.grid.size, self.data_index * self.n_model + self.model_index
        raise NotImplementedError(f"a KV cache split over {axes} is not a layout the port runs")

    # ------------------------------------------------- GNN communication mode
    @property
    def is_halo(self) -> bool:
        """True once halo mode is armed: comm == "halo" AND the rank's export
        rows (flat, or the hierarchical pair) are bound."""
        return self.comm == "halo" and (
            self.halo_send_idx is not None
            or (self.halo_send_loc is not None and self.halo_send_rem is not None)
        )

    def bind_halo(
        self,
        send_idx: torch.Tensor | None = None,
        *,
        send_loc: torch.Tensor | None = None,
        send_rem: torch.Tensor | None = None,
    ) -> "ShardingPolicy":
        """Copy with this rank's export rows bound.

        Flat: pass ``send_idx``, the rank's (s_max,) slice of
        ``HaloPlan.send_idx``. Hierarchical: pass the keyword pair
        ``send_loc``/``send_rem``, the rank's (s_loc,) and (s_rem,) slices
        of ``HaloPlan.send_loc``/``send_rem``; ``neighbor_table`` then runs
        the two-phase exchange over ``halo_groups``. Exactly one of the two
        forms must be given."""
        if send_idx is not None and (send_loc is not None or send_rem is not None):
            raise ValueError("bind_halo takes send_idx OR (send_loc, send_rem), not both")
        if send_idx is None and (send_loc is None) != (send_rem is None):
            raise ValueError("hierarchical bind_halo needs BOTH send_loc and send_rem")
        if send_idx is None and send_loc is None:
            raise ValueError("bind_halo needs send_idx or the (send_loc, send_rem) pair")
        return dataclasses.replace(
            self, halo_send_idx=send_idx, halo_send_loc=send_loc, halo_send_rem=send_rem
        )

    @property
    def is_broadcast(self) -> bool:
        """True for a bound broadcast policy: every rank holds its block of
        ``n_pad / k`` nodes and ``neighbor_table`` all-gathers the whole
        table over ``group``."""
        return self.comm == "broadcast" and self.bcast_bound

    def neighbor_table(self, x: torch.Tensor) -> torch.Tensor:
        """The table sender indices gather from.

        NO_POLICY / unbound broadcast / unbound halo: ``x`` itself (senders
        are global rows). Bound broadcast: the ranks' blocks all-gathered
        in rank order, ``(k·n_local, d)`` (global rows of the padded
        graph; backward a reduce-scatter). Armed flat halo: ``[x ‖ halo_exchange(x)]`` of shape
        ``(n_local + k·s_max, d)``; armed hierarchical halo: ``[x ‖
        hier_halo_exchange(x)]`` of shape ``(n_local + k_model·(s_loc +
        n_pods·s_rem), d)``. Either way the plan's re-localized senders
        index it, and its column space is exactly that of the per-rank
        blocked tables of `repro_torch.dist.halo.plan_blocked_rank`."""
        if self.is_broadcast:
            if _alone(self.group):
                return x
            from repro_torch.dist.halo import _axis_gather

            return _axis_gather(x, self.group)
        if not self.is_halo:
            return x
        return torch.cat([x, self.halo_block(x)])

    def _sharded(self) -> bool:
        return (self.is_halo or self.is_broadcast) and not _alone(self.group)

    def replicate(self, params: Any) -> Any:
        """``params`` (a tree of dicts and lists) as the parameters every rank holds
        alike: under an armed halo or a bound broadcast, :func:`replicate`
        of each leaf over the group, as the reference's closed-over
        parameters are replicated leaf by leaf; otherwise themselves."""
        if not self._sharded():
            return params

        def walk(p):
            if isinstance(p, dict):
                return {name: walk(v) for name, v in p.items()}
            return [walk(v) for v in p] if isinstance(p, list) else replicate(p, self.group)

        return walk(params)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`psum` over the group (armed halo or bound broadcast;
        otherwise ``x``)."""
        return psum(x, self.group) if self._sharded() else x

    def halo_block(self, x: torch.Tensor) -> torch.Tensor:
        """Just the exchanged halo rows of :meth:`neighbor_table` (armed
        halo only) — the overlapped schedule consumes this directly. The
        wire is encoded per :attr:`halo_payload` and decoded here, so
        callers always see ``x.dtype`` rows."""
        from repro_torch.dist.halo import halo_exchange, hier_halo_exchange

        if self.halo_send_loc is not None:
            if self.halo_groups is None:
                raise ValueError("a hierarchical halo binding needs halo_groups, the rank's "
                                 "(pod group, model group) from repro_torch.launch.mesh.halo_groups")
            return hier_halo_exchange(
                x, self.halo_send_loc, self.halo_send_rem, self.halo_groups,
                via=self.halo_via, payload=self.halo_payload,
            )
        return halo_exchange(
            x, self.halo_send_idx, self.group, via=self.halo_via, payload=self.halo_payload,
        )


#: The unsharded singleton: the identity neighbor table.
NO_POLICY = ShardingPolicy()
