"""Halo-exchange plans and the flat halo collectives — twin of
`repro.dist.halo`, over `torch.distributed`.

The broadcast schedule (paper Fig. 5c) ships each CE's FULL layer output to
every other CE: ``(k−1)·n_local`` rows received per device per layer. The
halo schedule ships only boundary vertices — the distinct sources of cut
edges — so each rank receives ``k·s_max`` rows, where ``s_max`` is the
largest per-rank export set:

    k · s_max  <  (k − 1) · n_local        (halo beats broadcast)

The host side is numpy and array-equal to the reference: `build_halo_plan`
(flat and hierarchical plans, ``pod_map``), the plan cache, the node
relayout helpers and the per-rank blocked (BSR) tables over the
``[local ‖ halo]`` neighbor table, combined or split into interior and
boundary halves. `plan_blocked_rank` builds one rank's table from that
rank's edges alone, so no process holds all k tile tables.

The device side runs inside one process per rank: the reference's
``shard_map`` body becomes the body of a rank of a `torch.distributed`
group (`repro_torch.launch.mesh`), and the named mesh axis becomes the
process group. `halo_exchange` lowers the flat plan to one collective:
``all_gather``, or ``ppermute`` — a ring of k−1 send/recv steps. A group
whose backend cannot carry device tensors (``gloo``) gets the wire block
copied to the host and back: the exchange's wire goes through the group,
all compute stays on the rank's device. `hier_halo_exchange` runs a
hierarchical plan's two phases over the rank's (pod, model) subgroups
(`repro_torch.launch.mesh.halo_groups`): the ``send_rem`` rows across pods,
then ``[send_loc rows ‖ phase-1 block]`` across pod-mates.

The exchange is differentiable, with the backward JAX's transposes give:
the collective acts on the wire tensor (`_AxisGather`), and the wire's
encode and decode stay ordinary torch ops, so autograd puts the casts
where JAX does. The backward of ``all_gather`` is one reduce-scatter
(rank j receives the sum over ranks i of slot j of rank i's cotangent),
that of the ``ppermute`` ring the ring run in reverse; an fp32 wire's
cotangent crosses in fp32, a bf16 wire's in bf16, and an int8 wire's not
at all: rounding has no derivative, so only the scales' cotangents cross,
which ``amax`` hands to the largest element of each export block (ties
split evenly, as ``jnp.max`` splits them). The transpose of
``h[send_idx]`` is autograd's scatter-add into the exporting rows.
`halo_block`, `halo_aggregate` and `split_halo_aggregate` then
differentiate with no code of their own, and so does the two-phase
exchange: phase 2's transpose, the split of its cotangent into the
``send_loc`` rows and the relayed block, phase 1's transpose on the
latter, then both scatter-adds into h (a row exported on both tiers gets
both).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.quant import dequantize_payload, payload_bits, quantize_payload
from repro_torch.device import resolve_device
from repro_torch.graph.ops import aggregate
from repro_torch.graph.structure import BlockedAdjacency, blocked_adjacency
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "HaloPlan",
    "build_halo_plan",
    "validate_pod_map",
    "pod_map_order",
    "pod_map_fingerprint",
    "halo_exchange",
    "hier_halo_exchange",
    "halo_aggregate",
    "hier_halo_aggregate",
    "split_halo_aggregate",
    "graph_fingerprint",
    "cached_halo_plan",
    "get_halo_plan",
    "register_halo_plan",
    "invalidate_halo_plans",
    "plan_cache_stats",
    "reset_plan_cache_stats",
    "relocate_node_array",
    "restore_node_array",
    "node_mask",
    "PlanLayout",
    "plan_layout",
    "PlanBlockedAdjacency",
    "plan_blocked_adjacency",
    "plan_blocked_rank",
    "plan_blocked_shape",
    "plan_split_blocked_adjacency",
    "plan_split_blocked_shape",
]


@dataclasses.dataclass
class HaloPlan:
    """Static-shape relocation of a partitioned graph onto k devices.

    One plan describes ONE exchange schedule, selected by ``axes``:

    * ``axes == ("model",)`` (default) — the **flat** single-axis plan of
      DESIGN.md §7.2: one collective over ``k`` devices.
    * ``axes == ("pod", "model")`` — the **hierarchical** plan: ``k ==
      n_pods · k_model`` devices arranged pod-major (device ``g`` sits in
      pod ``g // k_model`` as member ``g % k_model``, pod-major as the
      reference's ``(pod, model)`` mesh ravels them), exchanged in two
      phases by :func:`hier_halo_exchange`.

    Array layout shared by both (leading axis k = one slice per device):

      perm        (n_nodes,) int64   — new position → original node id; the
                                       first ``part_sizes[0]`` entries are
                                       device 0's nodes, and so on.
      senders_l   (k, e_local) int32 — per-edge source index into the
                                       ``[local ‖ halo]`` concatenation
                                       (halo layout depends on ``axes``,
                                       see below).
      receivers_l (k, e_local) int32 — per-edge local destination row
                                       (``< n_local``).
      edge_w      (k, e_local) f32   — edge weight; exactly 0 ⇒ padding edge
                                       (contributes nothing to aggregates).
      part_sizes  (k,) int64         — real (un-padded) rows per device block;
                                       rows ≥ part_sizes[b] of block b are
                                       zero padding.

    **Flat plan** (``axes == ("model",)``): ``send_idx`` is ``(k, s_max)``
    int32 — the local rows each device exports (the distinct sources of its
    outgoing cut edges), padded with row 0. The **s_max contract**: every
    device pads its export to exactly ``s_max`` rows so all k devices run
    the same static-shape program; one exchange delivers exactly ``k·s_max``
    halo rows per device and halo slot ``j·s_max + t`` always holds row
    ``send_idx[j, t]`` of device j. ``senders_l < n_local + k·s_max``.

    **Hierarchical plan** (``axes == ("pod", "model")``): the boundary set of
    each device splits into two padded export tables —

      send_loc  (k, s_loc) int32 — rows read by some POD-MATE (cheap tier),
      send_rem  (k, s_rem) int32 — rows read by some device in ANOTHER pod
                                   (expensive tier; deduplicated — only rows
                                   no pod-mate of the reader holds).

    After the two-phase exchange, device ``(p, m)``'s neighbor table is
    ``[local (n_local) ‖ k_model member blocks of width B]`` with
    ``B = s_loc + n_pods·s_rem``; member block ``m'`` is
    ``[send_loc rows of (p, m') ‖ for q in pods: send_rem rows of (q, m')]``.
    So halo slot ``m'·B + t`` (t < s_loc) holds row ``send_loc[(p,m'), t]``
    and slot ``m'·B + s_loc + q·s_rem + t`` holds row ``send_rem[(q,m'), t]``
    — every boundary row in the system is addressable, and ``senders_l <
    n_local + k_model·B``. For hierarchical plans ``s_max``/``send_idx``
    still describe the flat single-axis exchange of the SAME partition: they
    are retained as the accounting baseline (``flat_*`` properties) and must
    NOT be mixed with the hierarchically remapped ``senders_l``.
    """

    k: int
    n_local: int                      # rows per device block (max part size)
    s_max: int                        # flat export rows per device (padded)
    e_local: int                      # edges per device (padded)
    n_nodes: int
    perm: np.ndarray
    send_idx: np.ndarray
    senders_l: np.ndarray
    receivers_l: np.ndarray
    edge_w: np.ndarray
    part_sizes: np.ndarray | None = None
    # ------------------------------------------------ hierarchy (multi-axis)
    axes: tuple[str, ...] = ("model",)
    n_pods: int = 1
    s_loc: int = 0                    # intra-pod export rows per device
    s_rem: int = 0                    # inter-pod export rows per device
    send_loc: np.ndarray | None = None
    send_rem: np.ndarray | None = None

    # ---------------------------------------------------------------- shape
    @property
    def is_hierarchical(self) -> bool:
        """True for (pod, model) plans; False for single-axis plans."""
        return len(self.axes) > 1

    @property
    def k_model(self) -> int:
        """Devices per pod (== k for flat plans, where n_pods == 1)."""
        return self.k // self.n_pods

    @property
    def block_rows(self) -> int:
        """Hierarchical per-member halo block width B = s_loc + n_pods·s_rem."""
        return self.s_loc + self.n_pods * self.s_rem

    @property
    def neighbor_table_rows(self) -> int:
        """Row count of the ``[local ‖ halo]`` table ``neighbor_table``
        concatenates per device — the column space of the per-shard blocked
        adjacency. Flat: ``n_local + k·s_max``. Hierarchical: ``n_local +
        k_model·B`` (phase-1 inter-pod rows are RELAYED inside the member
        blocks, so they do not widen the table — unlike
        :attr:`halo_rows_per_device`, which counts both phases as wire)."""
        if self.is_hierarchical:
            return self.n_local + self.intra_pod_rows_per_device
        return self.n_local + self.k * self.s_max

    # ---------------------------------------------------------------- wire
    @property
    def halo_rows_per_device(self) -> int:
        """Rows received per device per exchange under THIS plan's schedule
        (flat: ``k·s_max``; hierarchical: both phases summed)."""
        if self.is_hierarchical:
            return self.inter_pod_rows_per_device + self.intra_pod_rows_per_device
        return self.k * self.s_max

    @property
    def broadcast_rows_per_device(self) -> int:
        """Rows received per device per layer under the broadcast schedule."""
        return (self.k - 1) * self.n_local

    @property
    def inter_pod_rows_per_device(self) -> int:
        """Hierarchical phase-1 rows received per device (``n_pods·s_rem``,
        self-pod slot included for uniform static shapes)."""
        return self.n_pods * self.s_rem

    @property
    def intra_pod_rows_per_device(self) -> int:
        """Hierarchical phase-2 rows received per device over the cheap tier
        (``k_model·(s_loc + n_pods·s_rem)`` — pod-mates' intra exports plus
        the relayed inter-pod blocks)."""
        return self.k_model * self.block_rows

    @property
    def inter_pod_rows_crossing(self) -> int:
        """Rows that actually CROSS the expensive inter-pod fabric per device
        per exchange (``(n_pods−1)·s_rem`` — the self-pod slot never leaves)."""
        return (self.n_pods - 1) * self.s_rem

    @property
    def flat_inter_pod_rows_crossing(self) -> int:
        """Inter-pod crossing rows the FLAT single-axis schedule would move on
        the same partition and pod grouping: ``(n_pods−1)·k_model·s_max``
        (every remote device's full padded export reaches every device)."""
        return (self.n_pods - 1) * self.k_model * self.s_max

    def wire_fraction(self) -> float:
        """halo ÷ broadcast received-row ratio (< 1 ⇔ halo wins)."""
        return self.halo_rows_per_device / max(self.broadcast_rows_per_device, 1)

    # ------------------------------------------- interior / boundary split
    # Derived lazily from senders_l/edge_w/n_local and memoized on the
    # instance — deliberately NOT stored fields, so plans reloaded from
    # pre-overlap archives (e.g. results/halo_plan_ogb.npz) grow the split
    # for free and no serialized format changes.
    def _edge_locality(self) -> dict:
        cached = self.__dict__.get("_edge_locality_cache")
        if cached is None:
            real = self.edge_w > 0
            remote = self.senders_l >= self.n_local
            mask = np.zeros((self.k, self.n_local), bool)
            for b in range(self.k):
                mask[b, self.receivers_l[b][real[b] & remote[b]]] = True
            cached = {
                "interior_edges": int((real & ~remote).sum()),
                "boundary_edges": int((real & remote).sum()),
                "boundary_mask": mask,
            }
            self.__dict__["_edge_locality_cache"] = cached
        return cached

    def boundary_row_mask(self) -> np.ndarray:
        """(k, n_local) bool: local rows with ≥1 real halo-sender edge —
        the rows whose aggregate depends on the exchange. The complement
        (interior rows, zero-padding rows included) can be aggregated
        entirely from the local block, concurrently with the collective."""
        return self._edge_locality()["boundary_mask"]

    def interior_row_mask(self) -> np.ndarray:
        """(k, n_local) bool complement of :meth:`boundary_row_mask`."""
        return ~self.boundary_row_mask()

    def boundary_rows_per_device(self) -> np.ndarray:
        """(k,) count of boundary rows per device."""
        return self.boundary_row_mask().sum(axis=1)

    def interior_rows_per_device(self) -> np.ndarray:
        """(k,) count of interior rows per device (padding rows included)."""
        return self.interior_row_mask().sum(axis=1)

    @property
    def interior_edges(self) -> int:
        """Real edges whose sender is a local row (no wire dependence)."""
        return self._edge_locality()["interior_edges"]

    @property
    def boundary_edges(self) -> int:
        """Real edges whose sender is a halo row (wire-dependent)."""
        return self._edge_locality()["boundary_edges"]

    def overlap_fraction(self) -> float:
        """Fraction of real aggregation work with NO halo dependence — the
        interior compute available to hide the exchange behind (the
        ``1 − overlap_fraction`` of the exposed-bytes model in
        docs/communication.md and the dry-run `exchange` accounting)."""
        loc = self._edge_locality()
        total = loc["interior_edges"] + loc["boundary_edges"]
        return loc["interior_edges"] / total if total else 0.0

    # ---------------------------------------------------------------- ranks
    def rank_arrays(
        self, rank: int, device: str | torch.device | None = None
    ) -> tuple[torch.Tensor, ...]:
        """One rank's slice of the plan tables as tensors on ``device`` (the
        card unless ``"cpu"`` is asked for) — what the reference shards with
        ``device_arrays`` inside ``shard_map``, handed to one process.

        Flat plans return ``(send_idx, senders_l, receivers_l, edge_w)``;
        hierarchical plans return ``(send_loc, send_rem, senders_l,
        receivers_l, edge_w)`` (the two export tiers replace ``send_idx``).
        """
        device = resolve_device(device)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a[rank])).to(device=device, dtype=dtype)

        tail = (t(self.senders_l, torch.int32), t(self.receivers_l, torch.int32),
                t(self.edge_w, torch.float32))
        if self.is_hierarchical:
            return (t(self.send_loc, torch.int32), t(self.send_rem, torch.int32)) + tail
        return (t(self.send_idx, torch.int32),) + tail


# ============================================================= host builders
def _blocked_layout(assignment: np.ndarray, k: int, n: int):
    """Contiguous per-device blocks: (perm, sizes, n_local, local-row map)."""
    perm = np.argsort(assignment, kind="stable").astype(np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    sizes = np.bincount(assignment, minlength=k).astype(np.int64)
    offsets = np.zeros(k + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    n_local = int(sizes.max()) if n else 0
    local = inv - offsets[assignment]          # local row of every node
    return perm, sizes, n_local, local


def _export_sets(a_sel: np.ndarray, src_sel: np.ndarray, k: int, n: int, local: np.ndarray):
    """Distinct (source device, source node) export sets of a cut-edge subset.

    Returns ``(s, send, slots_for)``: the pad ``s`` (largest per-device set),
    the padded ``(k, s)`` table of exported local rows, and a vectorized
    ``slots_for(devs, nodes) -> slot`` resolving each pair's position inside
    its device's export set.
    """
    pair = a_sel * n + src_sel                 # unique id per (dev, node)
    uniq = np.unique(pair)
    dev = uniq // max(n, 1)
    node = uniq % max(n, 1)
    counts = np.bincount(dev, minlength=k).astype(np.int64)
    s = int(counts.max()) if uniq.size else 0
    start = np.zeros(k + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    send = np.zeros((k, s), np.int32)
    if uniq.size:
        slot = np.arange(uniq.size, dtype=np.int64) - start[dev]
        send[dev, slot] = local[node].astype(np.int32)

    def slots_for(devs: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        # np.unique output is sorted, so searchsorted recovers each pair's
        # slot in its source device's export set.
        pos = np.searchsorted(uniq, devs * n + nodes)
        return pos - start[devs]

    return s, send, slots_for


def _group_edges_by_receiver(
    owner: np.ndarray, senders_full: np.ndarray, receivers_full: np.ndarray,
    w: np.ndarray, k: int, e: int,
):
    """Pack re-localized edges into padded per-receiver-device tables."""
    e_counts = np.bincount(owner, minlength=k).astype(np.int64)
    e_local = max(int(e_counts.max()) if e else 0, 1)
    e_start = np.zeros(k + 1, np.int64)
    np.cumsum(e_counts, out=e_start[1:])
    senders_l = np.zeros((k, e_local), np.int32)
    receivers_l = np.zeros((k, e_local), np.int32)
    edge_w = np.zeros((k, e_local), np.float32)
    if e:
        order = np.argsort(owner, kind="stable")
        own_o = owner[order]
        e_slot = np.arange(e, dtype=np.int64) - e_start[own_o]
        senders_l[own_o, e_slot] = senders_full[order].astype(np.int32)
        receivers_l[own_o, e_slot] = receivers_full[order].astype(np.int32)
        edge_w[own_o, e_slot] = w[order]
    return senders_l, receivers_l, edge_w, e_local


def validate_pod_map(pod_map: np.ndarray, k: int, pods: int) -> np.ndarray:
    """Check a part→pod map is a balanced assignment of k parts to pods.

    Every pod must host exactly ``k // pods`` parts — the halo plan realizes
    the map by relabeling parts into pod-major device slots, so an
    unbalanced map has no device raveling. Returns the map as int64.
    """
    pm = np.asarray(pod_map, dtype=np.int64)
    if pm.shape != (k,):
        raise ValueError(f"pod_map must have shape ({k},), got {pm.shape}")
    if pm.min() < 0 or pm.max() >= pods:
        raise ValueError(f"pod_map entries must lie in [0, {pods}), got {pm!r}")
    sizes = np.bincount(pm, minlength=pods)
    if np.any(sizes != k // pods):
        raise ValueError(
            f"pod_map must place exactly {k // pods} parts per pod, got sizes {sizes!r}"
        )
    return pm


def pod_map_order(pod_map: np.ndarray, k: int, pods: int) -> np.ndarray:
    """Device-slot → part order realizing ``pod_map`` pod-major.

    Slot g hosts ``order[g]``; parts mapped to pod q occupy the contiguous
    slots ``q*k_model .. (q+1)*k_model - 1`` (ties broken by part id), so
    the mesh's pod-major raveling (device g → pod ``g // k_model``) agrees
    with the map without any change to device order.
    """
    pm = validate_pod_map(pod_map, k, pods)
    return np.lexsort((np.arange(k), pm))


def pod_map_fingerprint(pod_map: np.ndarray | None) -> str:
    """Short stable hash of a part→pod map for the plan-cache key.

    ``None`` (the contiguous pod-major default) maps to ``"contig"`` so
    default-mapped plans keep their pre-autotune cache keys byte-identical.
    """
    if pod_map is None:
        return "contig"
    pm = np.ascontiguousarray(pod_map, dtype=np.int64)
    return hashlib.sha1(pm.tobytes()).hexdigest()[:16]


def build_halo_plan(
    part,
    edge_index: np.ndarray,
    w: np.ndarray | None = None,
    *,
    axes: tuple[str, ...] = ("model",),
    pods: int = 1,
    pod_map: np.ndarray | None = None,
) -> HaloPlan:
    """Relocate a :class:`~repro_torch.core.partition.Partition` into a HaloPlan.

    edge_index — (2, E) directed (src, dst); each edge is placed on its
    destination's device. ``w`` defaults to all-ones; padding edges get
    weight 0, so ``(edge_w > 0).sum() == E`` accounts for every real edge
    exactly once (the seed-suite invariant).

    axes/pods — select the exchange schedule. The default (a single axis,
    ``pods == 1``) builds the flat plan of DESIGN.md §7.2, byte-identical to
    the pre-hierarchy builder. ``axes=("pod", "model"), pods=n`` builds the
    hierarchical plan: ``part.k`` must be divisible by ``pods``, devices are
    grouped pod-major (device g → pod ``g // (k/pods)``), and ``senders_l``
    is remapped against the two-phase halo table documented on
    :class:`HaloPlan`. Hierarchical plans also carry the flat
    ``send_idx``/``s_max`` of the same partition as the accounting baseline.

    pod_map — optional (k,) part→pod assignment from the communication-aware
    autotuner (the reference's ``repro.core.autotune``). Default ``None`` keeps the
    contiguous pod-major grouping (part g → pod ``g // (k/pods)``). A map is
    realized by RELABELING parts into pod-major device slots (pod q's parts
    occupy slots ``q*k_model..``); ``perm`` absorbs the relayout, so
    collectives, meshes, and every consumer see an ordinary hierarchical
    plan — only which rows land in the deduplicated ``send_rem`` tier
    changes. Must place exactly ``k // pods`` parts per pod.
    """
    if len(axes) not in (1, 2):
        raise ValueError(f"axes must name 1 or 2 mesh axes, got {axes!r}")
    if len(axes) == 2 and len(set(axes)) != 2:
        raise ValueError(f"hierarchical axes must be distinct, got {axes!r}")
    if len(axes) == 1 and pods != 1:
        raise ValueError("pods > 1 requires two mesh axes, e.g. ('pod', 'model')")
    assignment = np.asarray(part.assignment, dtype=np.int64)
    k = int(part.k)
    if pods < 1 or k % pods:
        raise ValueError(f"pods={pods} must divide the partition's k={k}")
    if pod_map is not None:
        if len(axes) != 2:
            raise ValueError("pod_map requires hierarchical axes, e.g. ('pod', 'model')")
        order = pod_map_order(pod_map, k, pods)
        rank = np.empty(k, dtype=np.int64)
        rank[order] = np.arange(k)
        assignment = rank[assignment]
    n = int(part.n_nodes)
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    e = int(src.shape[0])
    w = np.ones(e, np.float32) if w is None else np.asarray(w, np.float32)

    # 1. contiguous per-device blocks --------------------------------------
    perm, sizes, n_local, local = _blocked_layout(assignment, k, n)
    a_s, a_d = assignment[src], assignment[dst]
    cut = a_s != a_d

    # 2. export sets: distinct (source device, source node) of cut edges ---
    s_max, send_idx, flat_slots = _export_sets(a_s[cut], src[cut], k, n, local)

    hierarchical = len(axes) == 2
    senders_full = local[src].copy()
    if hierarchical:
        # Tier split: an intra-pod cut edge reads a pod-mate's row (cheap
        # link); an inter-pod cut edge reads a row no pod-mate holds
        # (expensive link). Padding is per tier, so cheap traffic no longer
        # pays the global worst-case s_max.
        k_model = k // pods
        p_s, p_d = a_s // k_model, a_d // k_model
        m_s = a_s % k_model
        icut = cut & (p_s == p_d)
        xcut = p_s != p_d
        s_loc, send_loc, loc_slots = _export_sets(a_s[icut], src[icut], k, n, local)
        s_rem, send_rem, rem_slots = _export_sets(a_s[xcut], src[xcut], k, n, local)
        B = s_loc + pods * s_rem
        if np.any(icut):
            senders_full[icut] = (
                n_local + m_s[icut] * B + loc_slots(a_s[icut], src[icut])
            )
        if np.any(xcut):
            senders_full[xcut] = (
                n_local + m_s[xcut] * B + s_loc
                + p_s[xcut] * s_rem + rem_slots(a_s[xcut], src[xcut])
            )
    else:
        s_loc = s_rem = 0
        send_loc = send_rem = None
        if np.any(cut):
            senders_full[cut] = n_local + a_s[cut] * s_max + flat_slots(a_s[cut], src[cut])

    # 3. re-localized edges, grouped by the receiver's device --------------
    senders_l, receivers_l, edge_w, e_local = _group_edges_by_receiver(
        a_d, senders_full, local[dst], w, k, e
    )

    return HaloPlan(
        k=k, n_local=n_local, s_max=s_max, e_local=e_local, n_nodes=n,
        perm=perm, send_idx=send_idx, senders_l=senders_l,
        receivers_l=receivers_l, edge_w=edge_w, part_sizes=sizes,
        axes=tuple(axes), n_pods=pods, s_loc=s_loc, s_rem=s_rem,
        send_loc=send_loc, send_rem=send_rem,
    )


# ===================================================================== cache
# Plans are pure host data keyed by (graph_hash, k, mesh_axes); one build
# serves every layer of every epoch. The axes component is the single axis
# name (str — unchanged from the single-axis era) or the hierarchical
# (axes tuple, n_pods) pair, so flat and (pod, model) plans for one graph
# coexist side by side and differently-podded meshes never collide.
_PLAN_CACHE: dict[tuple[str, int, object], HaloPlan] = {}
_PLAN_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def _observe_cache_stats() -> None:
    """Mirror the cache counters into ``plan_cache.*`` gauges — kept in
    lockstep with every hit/miss/eviction so an exported snapshot always
    equals :func:`plan_cache_stats` (the pinned obs equality test)."""
    if not _obs_metrics.enabled():
        return
    _obs_metrics.set_gauge("plan_cache.hits", _PLAN_STATS["hits"])
    _obs_metrics.set_gauge("plan_cache.misses", _PLAN_STATS["misses"])
    _obs_metrics.set_gauge("plan_cache.evictions", _PLAN_STATS["evictions"])
    _obs_metrics.set_gauge("plan_cache.size", len(_PLAN_CACHE))


def graph_fingerprint(
    n_nodes: int,
    edge_index: np.ndarray,
    w: np.ndarray | None = None,
    assignment: np.ndarray | None = None,
) -> str:
    """Stable content hash of a (graph, weights, partition) triple.

    Used as the ``graph_hash`` component of the plan-cache key when the
    caller has materialized arrays; callers that synthesize graphs
    deterministically (e.g. the launch layer's shape-statistics graphs) can
    pass their own string key instead and skip the hash entirely.
    """
    h = hashlib.sha1()
    h.update(np.int64(n_nodes).tobytes())
    h.update(np.ascontiguousarray(edge_index, dtype=np.int64).tobytes())
    if w is not None:
        h.update(np.ascontiguousarray(w, dtype=np.float32).tobytes())
    if assignment is not None:
        h.update(np.ascontiguousarray(assignment, dtype=np.int32).tobytes())
    return h.hexdigest()


def _hier_key_axes(
    mesh_axis: "str | tuple[str, ...]", pods: int, pod_map: np.ndarray | None
) -> object:
    """The axes component of a plan-cache key.

    Flat plans keep the bare axis name (pre-hierarchy key, unchanged).
    Hierarchical plans use ``(axes, pods)`` — and, only when a non-default
    ``pod_map`` is present, ``(axes, pods, pod_map_fingerprint)``: autotuned
    and default plans of one graph coexist without cross-invalidation, while
    ``invalidate_halo_plans(graph_key=...)`` still sweeps every flavor (the
    fingerprint lives inside the axes component, never in ``key[0]``).
    """
    if isinstance(mesh_axis, str):
        return mesh_axis
    if pod_map is None:
        return (tuple(mesh_axis), int(pods))
    return (tuple(mesh_axis), int(pods), pod_map_fingerprint(pod_map))


def cached_halo_plan(
    graph_key: str,
    k: int,
    mesh_axis: "str | tuple[str, ...]" = "model",
    *,
    pods: int = 1,
    pod_map: np.ndarray | None = None,
    builder: Callable[[], HaloPlan],
) -> HaloPlan:
    """Memoized plan lookup: ``builder()`` runs only on a cache miss.

    ``graph_key`` identifies the graph (and, when relevant, the partition) —
    either a :func:`graph_fingerprint` or any caller-chosen stable string.
    ``mesh_axis`` completes the key ``(graph_key, k, mesh_axis)``: a single
    axis name for flat plans (the pre-hierarchy key, unchanged — ``pods``
    is ignored) or the axes tuple — e.g. ``("pod", "model")`` — for
    hierarchical plans, where ``pods`` joins the key component (the
    member-block layout depends on the pod count, so a 2×4 and a 4×2 plan
    of the same k=8 partition must never collide). Flat and hierarchical
    plans therefore coexist without cross-invalidation. The lazy builder
    matters at scale: on a hit, neither the graph nor the partition needs
    to exist in memory at all. An autotuned ``pod_map`` joins the key via
    its fingerprint (see :func:`_hier_key_axes`), so autotuned and default
    mappings of the same graph coexist too.
    """
    key_axes = _hier_key_axes(mesh_axis, pods, pod_map)
    key = (graph_key, int(k), key_axes)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_STATS["hits"] += 1
        _observe_cache_stats()
        return plan
    _PLAN_STATS["misses"] += 1
    with _obs_trace.span("halo.plan_build", args={"k": int(k)}):
        t0 = time.perf_counter()
        plan = builder()
        if _obs_metrics.enabled():
            _obs_metrics.observe(
                "halo.plan_build_ms", (time.perf_counter() - t0) * 1e3
            )
    _PLAN_CACHE[key] = plan
    _observe_cache_stats()
    return plan


def get_halo_plan(
    part,
    edge_index: np.ndarray,
    w: np.ndarray | None = None,
    *,
    mesh_axis: "str | tuple[str, ...]" = "model",
    graph_key: str | None = None,
    pods: int | None = None,
    pod_map: np.ndarray | None = None,
) -> HaloPlan:
    """Cached :func:`build_halo_plan`: same graph/partition/k/axes → same
    object.

    When ``graph_key`` is omitted the key is content-hashed from the edge
    list, weights, AND the partition assignment (two partitions of the same
    graph never collide). Mutating the graph or re-partitioning produces a
    different key, i.e. a fresh plan.

    Single-axis (default): ``mesh_axis`` is the axis name, exactly as before
    the hierarchy landed. Hierarchical: pass ``pods=n`` (axes default to
    ``("pod", mesh_axis)``) or ``mesh_axis=("pod", "model")`` explicitly —
    ``pods`` is then required; the cache key's axes component is the
    (axes, pods) pair, so plans for different pod counts never collide.
    An autotuned ``pod_map`` (hierarchical only) adds its fingerprint to
    that component, so tuned and default mappings coexist — and one scoped
    ``invalidate_halo_plans(graph_key=...)`` still sweeps both.
    """
    if isinstance(mesh_axis, tuple):
        axes = mesh_axis
        if len(axes) == 2 and not pods:
            raise ValueError(f"hierarchical axes {axes!r} require pods=<n_pods>")
    elif pods and pods > 1:
        axes = ("pod", mesh_axis)
    else:
        axes = (mesh_axis,)
    n_pods = pods if len(axes) == 2 else 1
    key_axes = axes if len(axes) > 1 else axes[0]
    if graph_key is None:
        graph_key = graph_fingerprint(part.n_nodes, edge_index, w, part.assignment)
    return cached_halo_plan(
        graph_key, part.k, key_axes, pods=n_pods, pod_map=pod_map,
        builder=lambda: build_halo_plan(
            part, edge_index, w, axes=axes, pods=n_pods, pod_map=pod_map
        ),
    )


def register_halo_plan(
    graph_key: str,
    k: int,
    mesh_axis: "str | tuple[str, ...]" = "model",
    *,
    pods: int = 1,
    pod_map: np.ndarray | None = None,
    plan: HaloPlan,
) -> HaloPlan:
    """Install an already-built plan under the cache key the lazy lookups
    use — the write-side counterpart of :func:`cached_halo_plan`.

    `repro_torch.dist.delta.DeltaPlanner` repairs plan objects in place and re-registers them
    here under the mutated graph's new versioned key, so the next
    ``cached_halo_plan``/``get_halo_plan`` with that key is a HIT and never
    re-runs the builder. Overwriting an existing entry is allowed (latest
    registration wins) and is not counted as an eviction.
    """
    key_axes = _hier_key_axes(mesh_axis, pods, pod_map)
    _PLAN_CACHE[(graph_key, int(k), key_axes)] = plan
    return plan


def invalidate_halo_plans(graph_key: str | None = None, *, k: int | None = None) -> int:
    """Drop cached plans (all of them, or one graph's). Returns #evicted.

    Matching is on the ``graph_key`` component (optionally narrowed by
    ``k``), so ONE scoped call evicts a graph's flat plan AND every
    hierarchical variant — all ``(axes, n_pods)`` key flavors sharing that
    hash — together, while plans of other graphs coexist untouched.
    ``train/elastic.py`` calls this on an elastic resize that changes the
    model-parallel degree: the node→CE partition is stale, so every plan
    derived from it is too. The next ``get_halo_plan``/``cached_halo_plan``
    rebuilds from scratch. Graph mutations that keep the partition should
    prefer the incremental path (`repro_torch.dist.delta`), which repairs the
    plan objects and moves them to the new key via :func:`register_halo_plan`
    instead of rebuilding.
    """
    if graph_key is None:
        n = len(_PLAN_CACHE)
        _PLAN_CACHE.clear()
        _PLAN_STATS["evictions"] += n
        _observe_cache_stats()
        return n
    victims = [
        key for key in _PLAN_CACHE
        if key[0] == graph_key and (k is None or key[1] == k)
    ]
    for key in victims:
        del _PLAN_CACHE[key]
    _PLAN_STATS["evictions"] += len(victims)
    _observe_cache_stats()
    return len(victims)


def plan_cache_stats() -> dict[str, int]:
    """{'hits', 'misses', 'evictions', 'size'} counters. hits/misses/
    evictions accumulate since process start or the last
    :func:`reset_plan_cache_stats`; ``size`` is the current entry count."""
    return {**_PLAN_STATS, "size": len(_PLAN_CACHE)}


def reset_plan_cache_stats() -> None:
    """Zero the hit/miss/eviction counters (cached plans stay resident).

    Long-lived serving processes sample :func:`plan_cache_stats` per
    reporting interval; without a reset the counters are process-lifetime
    and interval hit rates are unrecoverable."""
    for key in _PLAN_STATS:
        _PLAN_STATS[key] = 0


# ============================================================= host relayout
def relocate_node_array(plan: HaloPlan, x: np.ndarray) -> np.ndarray:
    """Scatter a global per-node array (n_nodes, …) into the plan's blocked
    layout (k, n_local, …); rows past ``part_sizes[b]`` are zero padding."""
    if plan.part_sizes is None:
        raise ValueError("plan has no part_sizes (built by an older writer)")
    x = np.asarray(x)
    out = np.zeros((plan.k, plan.n_local) + x.shape[1:], x.dtype)
    off = 0
    for b in range(plan.k):
        sz = int(plan.part_sizes[b])
        out[b, :sz] = x[plan.perm[off:off + sz]]
        off += sz
    return out


def restore_node_array(plan: HaloPlan, blocks: np.ndarray) -> np.ndarray:
    """Inverse of :func:`relocate_node_array`: gather (k, n_local, …) device
    blocks back into global node order, dropping the padding rows."""
    if plan.part_sizes is None:
        raise ValueError("plan has no part_sizes (built by an older writer)")
    blocks = np.asarray(blocks)
    out = np.zeros((plan.n_nodes,) + blocks.shape[2:], blocks.dtype)
    off = 0
    for b in range(plan.k):
        sz = int(plan.part_sizes[b])
        out[plan.perm[off:off + sz]] = blocks[b, :sz]
        off += sz
    return out


def node_mask(plan: HaloPlan) -> np.ndarray:
    """(k, n_local) float32 validity mask: 1 on real rows, 0 on padding."""
    if plan.part_sizes is None:
        raise ValueError("plan has no part_sizes (built by an older writer)")
    rows = np.arange(plan.n_local)[None, :]
    return (rows < np.asarray(plan.part_sizes)[:, None]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PlanLayout:
    """Frozen snapshot of JUST a plan's blocked row layout.

    :func:`relocate_node_array` / :func:`restore_node_array` only read
    ``k / n_local / n_nodes / perm / part_sizes``, so this snapshot is a
    drop-in "plan" for them. An in-place re-localization
    (`repro_torch.dist.delta.DeltaPlanner.relocalize`) mutates the live plan
    objects — a PlanLayout captured beforehand is the only remaining handle
    on the OLD row order, which is exactly what
    `repro_torch.train.elastic.relocate_state_tree` needs to carry live per-node
    state across the swap.
    """

    k: int
    n_local: int
    n_nodes: int
    perm: np.ndarray
    part_sizes: np.ndarray


def plan_layout(plan) -> PlanLayout:
    """Snapshot the blocked row layout of a plan — or of anything carrying
    ``k / n_local / perm / part_sizes`` (a `DeltaPlanner` works). Arrays are
    copied: the snapshot stays valid after the source is rebuilt in place."""
    if plan.part_sizes is None:
        raise ValueError("plan has no part_sizes (built by an older writer)")
    perm = np.array(plan.perm, np.int64, copy=True)
    return PlanLayout(
        k=int(plan.k), n_local=int(plan.n_local), n_nodes=int(perm.shape[0]),
        perm=perm, part_sizes=np.array(plan.part_sizes, np.int64, copy=True))


# =============================================== blocked (BSR) halo adjacency
@dataclasses.dataclass
class PlanBlockedAdjacency:
    """Per-device ragged BSR over the ``[local ‖ halo]`` neighbor table.

    The ``backend="bsr"`` counterpart of a plan's edge lists (DESIGN.md §2,
    docs/kernels.md): device b's rows span its ``n_local`` local receivers
    and its columns span the full ``n_local + halo`` table that
    ``policy.neighbor_table`` produces inside shard_map, so the MXU kernel
    aggregates exactly the rows the segment path gathers. Arrays carry the
    leading k axis to be sharded one-slice-per-device (like
    :meth:`HaloPlan.device_arrays`); T is the max nonzero-tile count across
    ALL devices (uniform static shapes), with per-device raggedness kept in
    ``lens`` so the kernel skips the cross-device padding too.

      vals : (k, R, T, B, B) float32 — dense tiles
      cols : (k, R, T) int32         — column-block ids into the padded table
      lens : (k, R) int32            — ragged valid-tile counts
    """

    vals: np.ndarray
    cols: np.ndarray
    lens: np.ndarray
    block: int
    n_rows: int                        # n_local (receiver rows per device)
    n_cols: int                        # n_local + halo rows (table width)

    @property
    def k(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_block_rows(self) -> int:
        return int(self.vals.shape[1])

    @property
    def max_nnzb(self) -> int:
        return int(self.vals.shape[2])

    @property
    def nnz_blocks(self) -> int:
        """Total nonzero tiles across all devices."""
        return int(self.lens.sum())

    @property
    def nnz_blocks_max_device(self) -> int:
        """Critical-path device's nonzero tiles (devices run in lockstep)."""
        return int(self.lens.sum(axis=1).max(initial=0))

    @property
    def padded_tile_fraction(self) -> float:
        """Fraction of the (k, R, T) tile tables that is padding — skipped
        by the ragged kernel, paid in full by a dense-T one."""
        grid = self.k * self.n_block_rows * self.max_nnzb
        return 1.0 - self.nnz_blocks / max(grid, 1)

    def stats(self) -> dict:
        """The dry-run / benchmark accounting record (all static host ints)."""
        return {
            "block": self.block,
            "n_block_rows": self.n_block_rows,
            "max_nnzb": self.max_nnzb,
            "nnz_blocks": self.nnz_blocks,
            "nnz_blocks_max_device": self.nnz_blocks_max_device,
            "padded_tile_fraction": self.padded_tile_fraction,
        }


def _plan_real_edges(plan: HaloPlan, b: int):
    """Device b's real (non-padding) re-localized edges: (senders, receivers, w)."""
    mask = plan.edge_w[b] > 0
    return (
        plan.senders_l[b][mask].astype(np.int64),
        plan.receivers_l[b][mask].astype(np.int64),
        plan.edge_w[b][mask],
    )


def _part_edges(plan: HaloPlan, b: int, boundary: bool):
    """Device b's real edges restricted to one locality class. Boundary
    senders are re-based into the halo-only column space (− n_local)."""
    s, r, w = _plan_real_edges(plan, b)
    m = (s >= plan.n_local) if boundary else (s < plan.n_local)
    return s[m] - (plan.n_local if boundary else 0), r[m], w[m]


_PARTS = ("combined", "interior", "boundary")


def _part_columns(plan: HaloPlan, part: str) -> int:
    """Column space of one table form: the whole ``[local ‖ halo]`` table,
    the local block, or the halo block alone."""
    if part == "combined":
        return plan.neighbor_table_rows
    if part == "interior":
        return max(plan.n_local, 1)
    if part == "boundary":
        return max(plan.neighbor_table_rows - plan.n_local, 1)
    raise ValueError(f"unknown blocked table form {part!r}; expected one of {_PARTS}")


def _rank_edges(plan: HaloPlan, b: int, part: str):
    if part == "combined":
        return _plan_real_edges(plan, b)
    return _part_edges(plan, b, boundary=part == "boundary")


def _shape_stats(plan: HaloPlan, block: int, part: str) -> dict:
    n_cols = _part_columns(plan, part)
    nbr = max(-(-plan.n_local // block), 1)
    nbc = max(-(-n_cols // block), 1)
    lens = np.zeros((plan.k, nbr), np.int64)
    for b in range(plan.k):
        s, r, _ = _rank_edges(plan, b, part)
        uniq = np.unique((r // block) * nbc + (s // block))
        lens[b] = np.bincount(uniq // nbc, minlength=nbr)
    T = max(int(lens.max(initial=1)), 1)
    nnz = int(lens.sum())
    return {
        "block": block,
        "n_rows": plan.n_local,
        "n_cols": n_cols,
        "n_block_rows": nbr,
        "max_nnzb": T,
        "nnz_blocks": nnz,
        "nnz_blocks_max_device": int(lens.sum(axis=1).max(initial=0)),
        "padded_tile_fraction": 1.0 - nnz / max(plan.k * nbr * T, 1),
    }


def plan_blocked_shape(plan: HaloPlan, block: int = 128) -> dict:
    """Blocked-adjacency statistics of a plan WITHOUT materializing tiles.

    Counts each device's distinct (receiver-block, sender-block) pairs over
    the real edges — O(E) ints, no (…, B, B) allocation — so a caller can
    size the tables (and reckon their bytes) before any tile exists.
    Returns the :meth:`PlanBlockedAdjacency.stats` dict plus
    ``n_rows``/``n_cols``.
    """
    return _shape_stats(plan, block, "combined")


def plan_blocked_rank(
    plan: HaloPlan, rank: int, block: int = 128, part: str = "combined",
    max_nnzb: int | None = None,
) -> BlockedAdjacency:
    """One rank's blocked table, built from that rank's edges alone.

    ``part`` picks the table form: ``"combined"`` (rows × the whole
    ``[local ‖ halo]`` table, :func:`plan_blocked_adjacency`), or the
    ``"interior"`` / ``"boundary"`` halves of
    :func:`plan_split_blocked_adjacency`. ``max_nnzb`` pads the tile table
    to the width every rank shares (``plan_blocked_shape(plan)["max_nnzb"]``
    or the split shape's), so the result equals slice ``rank`` of the
    all-rank table without building the other ranks' tiles; ``None`` keeps
    this rank's own width. Padding columns repeat the last valid id.
    """
    n_cols = _part_columns(plan, part)
    s, r, w = _rank_edges(plan, rank, part)
    ba = blocked_adjacency(max(plan.n_local, 1), np.stack([s, r]), w, block, n_col_nodes=n_cols)
    T = ba.max_nnzb if max_nnzb is None else int(max_nnzb)
    if T < ba.max_nnzb:
        raise ValueError(f"max_nnzb={T} is narrower than rank {rank}'s {ba.max_nnzb} tiles per block-row")
    if T > ba.max_nnzb:
        t = ba.max_nnzb
        vals = np.zeros((ba.n_block_rows, T, block, block), np.float32)
        cols = np.zeros((ba.n_block_rows, T), np.int32)
        vals[:, :t] = ba.block_vals
        cols[:, :t] = ba.block_cols
        cols[:, t:] = ba.block_cols[:, -1:]   # repeat-last padding contract
        ba = dataclasses.replace(ba, block_vals=vals, block_cols=cols)
    return ba


def _plan_blocked(plan: HaloPlan, block: int, part: str) -> PlanBlockedAdjacency:
    per_dev = [plan_blocked_rank(plan, b, block, part) for b in range(plan.k)]
    T = max(ba.max_nnzb for ba in per_dev)
    nbr = per_dev[0].n_block_rows
    vals = np.zeros((plan.k, nbr, T, block, block), np.float32)
    cols = np.zeros((plan.k, nbr, T), np.int32)
    lens = np.zeros((plan.k, nbr), np.int32)
    for b, ba in enumerate(per_dev):
        t = ba.max_nnzb
        vals[b, :, :t] = ba.block_vals
        cols[b, :, :t] = ba.block_cols
        cols[b, :, t:] = ba.block_cols[:, -1:]   # repeat-last padding contract
        lens[b] = ba.row_nnzb
    return PlanBlockedAdjacency(
        vals=vals, cols=cols, lens=lens, block=block,
        n_rows=plan.n_local, n_cols=_part_columns(plan, part),
    )


def plan_blocked_adjacency(plan: HaloPlan, block: int = 128) -> PlanBlockedAdjacency:
    """Materialize (and cache next to the plan) the per-rank blocked
    adjacency that lets ``backend="bsr"`` run on the halo path, for every
    rank at once.

    Each device's real edges — padding edges carry ``edge_w == 0`` and are
    dropped, so padded gathers never materialize a tile — are blocked over
    the rectangular (n_local) × (n_local + halo) space by
    `repro_torch.graph.structure.blocked_adjacency`, then padded to the max
    nonzero-tile count T across devices. Memoized on the plan instance per
    block size. At scale build one rank's slice with
    :func:`plan_blocked_rank` instead: this holds all k.
    """
    cache = plan.__dict__.setdefault("_blocked_cache", {})
    hit = cache.get(block)
    if hit is not None:
        return hit
    _obs_trace.instant("halo.blocked_build", {"block": block})
    out = _plan_blocked(plan, block, "combined")
    cache[block] = out
    if _obs_metrics.enabled():
        from repro_torch.obs.instrument import record_blocked

        record_blocked(out, scope="plan")
    return out


def plan_split_blocked_adjacency(
    plan: HaloPlan, block: int = 128
) -> tuple[PlanBlockedAdjacency, PlanBlockedAdjacency]:
    """The overlapped-schedule BSR pair ``(interior, boundary)``.

      * ``interior`` — columns span the (n_local) local block only; its
        ``bsr_spmm`` has no data dependence on the collective.
      * ``boundary`` — columns span the halo-only space (senders − n_local,
        width ``neighbor_table_rows − n_local``); its ``bsr_spmm`` consumes
        the gathered halo block directly.

    ``interior(z) + boundary(halo)`` ≡ ``combined([z ‖ halo])`` row for row
    (every real edge lands in exactly one class). Memoized on the plan like
    the combined table.
    """
    cache = plan.__dict__.setdefault("_blocked_cache", {})
    key = ("split", block)
    hit = cache.get(key)
    if hit is None:
        hit = (_plan_blocked(plan, block, "interior"), _plan_blocked(plan, block, "boundary"))
        cache[key] = hit
    return hit


def plan_split_blocked_shape(plan: HaloPlan, block: int = 128) -> dict:
    """:func:`plan_blocked_shape` for the split pair — O(E) statistics, no
    tiles. Returns ``{"interior": stats, "boundary": stats,
    "overlap_fraction": f}``.
    """
    return {
        "interior": _shape_stats(plan, block, "interior"),
        "boundary": _shape_stats(plan, block, "boundary"),
        "overlap_fraction": plan.overlap_fraction(),
    }


# ======================================================= device collectives
def _wire_on_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must go through the host to cross ``group``: gloo
    carries CPU tensors only."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _ring_peer(group, r: int) -> int:
    """The global rank of ``group``'s rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def _gather_start(wire: torch.Tensor, group, via: str) -> Callable[[], torch.Tensor]:
    """Dispatch :func:`_gather` of ``wire`` without waiting for it: returns
    the call that waits and gives the (k·s, d) result. ``all_gather`` is
    one collective with ``async_op=True``; the ring has its first step in
    flight and runs the rest in the wait."""
    k = dist.get_world_size(group)
    if via == "all_gather":
        blocks = [torch.empty_like(wire) for _ in range(k)]
        work = dist.all_gather(blocks, wire, group=group, async_op=True)

        def finish() -> torch.Tensor:
            work.wait()
            return torch.cat(blocks)

        return finish
    i = dist.get_rank(group)
    ring = [wire]

    def step():
        nxt = torch.empty_like(ring[-1])
        reqs = [dist.isend(ring[-1], _ring_peer(group, (i - 1) % k), group=group),
                dist.irecv(nxt, _ring_peer(group, (i + 1) % k), group=group)]
        return nxt, reqs

    pending = step() if k > 1 else None

    def finish_ring() -> torch.Tensor:
        cur = pending
        while cur is not None:
            nxt, reqs = cur
            for req in reqs:
                req.wait()
            ring.append(nxt)
            cur = step() if len(ring) < k else None
        # ring[t] on rank i is rank (i+t) mod k's export: slot j is ring[(j−i) mod k].
        return torch.cat([ring[(j - i) % k] for j in range(k)])

    return finish_ring


def _gather(wire: torch.Tensor, group, via: str) -> torch.Tensor:
    """Every rank's (s, d) block of ``wire`` → (k·s, d), slots in rank order
    (``wire`` already where the group's backend carries it)."""
    return _gather_start(wire, group, via)()


def _gather_transpose(ct: torch.Tensor, group, via: str) -> torch.Tensor:
    """The transpose of :func:`_gather`: this rank's (s, d) block of the
    sum over ranks i of slot ``rank`` of rank i's (k·s, d) cotangent.

    all_gather transposes to one reduce-scatter; the ppermute ring to the
    ring run in reverse (as JAX transposes ``ppermute``): k−1 steps, each
    passing a partial sum one rank up, which adds its own slot to it."""
    k = dist.get_world_size(group)
    blocks = ct.reshape(k, ct.shape[0] // k, *ct.shape[1:])
    if via == "all_gather":
        out = torch.empty_like(blocks[0])
        # reduce_scatter_single is the newer name of reduce_scatter_tensor.
        reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        reduce_scatter(out, ct, op=dist.ReduceOp.SUM, group=group)
        return out
    i = dist.get_rank(group)
    # g[t] (the cotangent of ring[t] on rank i) = slot (i+t) of ct
    # + g[t+1] of rank i−1, whose ring[t+1] was this rank's ring[t].
    acc = blocks[(i + k - 1) % k].clone()
    for t in range(k - 2, -1, -1):
        prev = torch.empty_like(acc)
        reqs = [dist.isend(acc, _ring_peer(group, (i + 1) % k), group=group),
                dist.irecv(prev, _ring_peer(group, (i - 1) % k), group=group)]
        for req in reqs:
            req.wait()
        acc = blocks[(i + t) % k] + prev
    return acc


class _AxisGather(torch.autograd.Function):
    """:func:`_gather` as a differentiable collective: the forward takes the
    already-dispatched gather's wait (:func:`_axis_gather_start`). The wire
    crosses the group in its own dtype both ways (a bf16 wire's cotangent is
    bf16), and through the host where the backend needs it, as in the
    forward. With ``count_rows`` (the exchanged rows, not the int8 scales)
    and metrics on, the backward's received rows and bytes add to
    ``halo.wire_rows`` and ``halo.wire_bytes``: the cotangent block, k·s
    rows, the same as the forward's."""

    @staticmethod
    def forward(ctx, export, group, via, count_rows, finish):
        ctx.group, ctx.via, ctx.count_rows = group, via, count_rows
        return finish()

    @staticmethod
    def backward(ctx, ct):
        wire = ct.contiguous()
        on_host = _wire_on_host(wire, ctx.group)
        if ctx.count_rows and _obs_metrics.enabled():
            _obs_metrics.inc("halo.wire_rows", int(wire.shape[0]))
            _obs_metrics.inc("halo.wire_bytes", wire.numel() * wire.element_size())
        out = _gather_transpose(wire.cpu() if on_host else wire, ctx.group, ctx.via)
        return (out.to(ct.device) if on_host else out), None, None, None, None


def _axis_gather_start(export: torch.Tensor, group=None, via: str = "all_gather",
                       count_rows: bool = False) -> Callable[[], torch.Tensor]:
    """Dispatch :func:`_axis_gather` without waiting for it: the wire is
    copied to the host first where the backend needs it, then the
    collective starts (:func:`_gather_start`). Returns the call that waits
    and gives the differentiable ``(k·s, d)`` block on ``export``'s
    device."""
    if export.shape[0] == 0:
        # Nothing crosses this tier, and (k·0, d) == (0, d) anyway.
        return lambda: export
    if via not in ("all_gather", "ppermute"):
        raise ValueError(f"unknown exchange lowering: {via!r}")
    wire = export.contiguous()
    on_host = _wire_on_host(wire, group)
    finish = _gather_start(wire.cpu() if on_host else wire, group, via)

    def received() -> torch.Tensor:
        out = finish()
        return out.to(export.device) if on_host else out

    return lambda: _AxisGather.apply(export, group, via, count_rows, received)


def _axis_gather(export: torch.Tensor, group=None, via: str = "all_gather",
                 count_rows: bool = False) -> torch.Tensor:
    """Gather every rank's ``(s, d)`` export block across ``group`` →
    ``(k·s, d)``, slots in rank order; differentiable (:class:`_AxisGather`).

    via="all_gather" lowers to one collective; via="ppermute" runs a k−1
    step ring of send/recv (each step passes the block one rank down, the
    NoC-shaped schedule COIN's mesh model assumes) — identical results,
    different lowering. Their backwards are a reduce-scatter and the ring
    in reverse.
    """
    return _axis_gather_start(export, group, via, count_rows)()


def _quantized_gather_start(
    export: torch.Tensor, group, via: str, payload: str | None
) -> Callable[[], torch.Tensor]:
    """Dispatch :func:`_quantized_gather` without waiting for it: the export
    is encoded and its collectives (the rows, and for int8 the scales) are
    in flight on return. Returns the call that waits and decodes."""
    if payload in (None, "fp32") or export.shape[0] == 0:
        return _axis_gather_start(export, group, via, count_rows=True)
    wire, scale = quantize_payload(export, payload)
    rows = _axis_gather_start(wire, group, via, count_rows=True)
    if scale is None:                                     # bf16: plain upcast
        return lambda: rows().to(export.dtype)
    scales = _axis_gather_start(scale, group, via)        # (k, 1) fp32
    return lambda: dequantize_payload(rows(), scales(), export.dtype)


def _quantized_gather(
    export: torch.Tensor, group, via: str, payload: str | None
) -> torch.Tensor:
    """:func:`_axis_gather` with the export block encoded for the wire.

    Only the quantized representation (plus, for int8, one fp32 scale per
    export block) crosses the wire; the gathered rows are decoded back to
    the compute dtype on receive, so callers see the same shapes and dtypes
    as on the fp32 path — only wire bytes change (× bits/32).
    """
    return _quantized_gather_start(export, group, via, payload)()


def halo_exchange(
    h: torch.Tensor,
    send_idx: torch.Tensor,
    group=None,
    via: str = "all_gather",
    payload: str | None = None,
) -> torch.Tensor:
    """Exchange boundary rows across the ranks of ``group`` (the default
    group when None), called by every rank of it.

    h        — (n_local, d) this rank's block.
    send_idx — (s_max,) local rows this rank exports.
    payload  — wire format (`repro_torch.core.quant.quantize_payload`):
               None/"fp32" ships raw rows; "bf16"/"int8" quantize the export
               before the collective and dequantize on receive (int8 carries
               one fp32 scale per sender block).
    Returns the (k·s_max, d) halo block: slot ``j·s_max + t`` holds row
    ``send_idx[j, t]`` of rank j, for every j including self (the self rows
    are redundant but keep the indexing uniform).

    With metrics on (`repro_torch.obs.metrics`), counts the rows and bytes
    this rank received (``halo.wire_rows``, ``halo.wire_bytes``) and the
    exchanges (``halo.exchanges_run``).
    """
    halo = _quantized_gather(h[send_idx.long()], group, via, payload)
    if _obs_metrics.enabled():
        rows = int(halo.shape[0])
        _obs_metrics.inc("halo.exchanges_run")
        _obs_metrics.inc("halo.wire_rows", rows)
        _obs_metrics.inc("halo.wire_bytes", rows * int(h.shape[1]) * payload_bits(payload) / 8)
    return halo


def hier_halo_exchange(
    h: torch.Tensor,
    send_loc: torch.Tensor,
    send_rem: torch.Tensor,
    groups: tuple,
    via: str = "all_gather",
    payload: str | None = None,
) -> torch.Tensor:
    """Two-phase (pod, model) boundary exchange, called by every rank of
    the group.

    h        — (n_local, d) this rank's block.
    send_loc — (s_loc,) local rows some pod-mate reads.
    send_rem — (s_rem,) local rows some rank of ANOTHER pod reads (the
               deduplicated inter-pod segment: the only rows that cross the
               expensive tier).
    groups   — (pod group, model group) of this rank
               (`repro_torch.launch.mesh.halo_groups`): the ranks of its
               member index across pods, and the ranks of its pod.

    Phase 1 (pod group): gather the ``(s_rem, d)`` remote exports across
    pods → ``(n_pods·s_rem, d)``. Phase 2 (model group): gather
    ``[h[send_loc] ‖ phase-1 block]`` across pod-mates, which both
    distributes the local boundary rows and relays every remote row to the
    pod-mates that need it. Returns the ``(k_model·B, d)`` halo block, ``B
    = s_loc + n_pods·s_rem``, in the member-block layout of
    :class:`HaloPlan`.

    ``payload`` quantizes both phases' wire blocks independently: under
    int8 the relayed rows are dequantized after phase 1 and quantized again
    into phase 2, as the reference does; bf16 is closed under the relay (a
    bf16 value cast to bf16 again is itself), so it adds no second rounding.

    With metrics on, counts the rows and bytes this rank received in both
    phases (``halo.wire_rows``, ``halo.wire_bytes``; per phase under the
    label ``phase`` = ``inter_pod`` / ``intra_pod``) and the exchanges
    (``halo.exchanges_run``).
    """
    pod_group, model_group = groups
    inter = _hier_phase1_start(h, send_rem, pod_group, via, payload)()
    halo = _hier_phase2(h, send_loc, inter, model_group, via, payload)
    if _obs_metrics.enabled():
        bytes_per_row = int(h.shape[1]) * payload_bits(payload) / 8
        _obs_metrics.inc("halo.exchanges_run")
        for phase, rows in (("inter_pod", int(inter.shape[0])), ("intra_pod", int(halo.shape[0]))):
            _obs_metrics.inc("halo.wire_rows", rows)
            _obs_metrics.inc("halo.wire_bytes", rows * bytes_per_row)
            _obs_metrics.inc("halo.wire_rows", rows, (("phase", phase),))
    return halo


def _hier_phase1_start(h: torch.Tensor, send_rem: torch.Tensor, pod_group, via: str,
                       payload: str | None) -> Callable[[], torch.Tensor]:
    """Dispatch phase 1 of :func:`hier_halo_exchange` (``h[send_rem]`` over
    the pod group); returns the wait that gives the ``(n_pods·s_rem, d)``
    block."""
    return _quantized_gather_start(h[send_rem.long()], pod_group, via, payload)


def _hier_phase2(h: torch.Tensor, send_loc: torch.Tensor, inter: torch.Tensor, model_group,
                 via: str, payload: str | None) -> torch.Tensor:
    """Phase 2 of :func:`hier_halo_exchange`: gather ``[h[send_loc] ‖
    inter]`` (phase 1's block, relayed) over the model group."""
    return _quantized_gather(torch.cat([h[send_loc.long()], inter]), model_group, via, payload)


def split_halo_aggregate(
    z: torch.Tensor,
    halo: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_w: torch.Tensor,
) -> torch.Tensor:
    """Interior/boundary-split aggregation over an already-gathered halo.

      interior:  O_int[r] = Σ_{s < n_local}  w · z[s]        (no wire dep)
      boundary:  O_bnd[r] = Σ_{s ≥ n_local}  w · halo[s−n_local]

    The interior term is a function of the local block alone, so it can run
    while the exchange is in flight; only the boundary term waits on the
    wire. Masked weights (not gathered subsets) keep shapes fixed: each edge
    contributes to exactly one term, so interior + boundary ≡ the serialized
    sum (padding edges carry w == 0 and vanish from both).
    """
    n_local = z.shape[0]
    senders = senders.long()
    if halo.shape[0] == 0:
        return aggregate(z, senders.clamp_max(n_local - 1), receivers, n_local, edge_w)
    remote = senders >= n_local
    zero = torch.zeros((), dtype=edge_w.dtype, device=edge_w.device)
    w_int = torch.where(remote, zero, edge_w)
    w_bnd = torch.where(remote, edge_w, zero)
    interior = aggregate(z, senders.clamp_max(n_local - 1), receivers, n_local, w_int)
    boundary = aggregate(
        halo, (senders - n_local).clamp(0, halo.shape[0] - 1), receivers, n_local, w_bnd,
    )
    return interior + boundary


def halo_aggregate(
    z: torch.Tensor,
    send_idx: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_w: torch.Tensor,
    group=None,
    via: str = "all_gather",
    payload: str | None = None,
    overlap: bool = False,
) -> torch.Tensor:
    """One distributed weighted aggregation O[r] = Σ w · Z[s] (per rank).

    z        — (n_local, d) this rank's feature block.
    send_idx — (s_max,) this rank's export rows.
    senders  — (e_local,) per-edge source index into ``[local ‖ halo]``.
    receivers— (e_local,) per-edge local destination row (< n_local).
    edge_w   — (e_local,) weights; exactly 0 marks a padding edge.
    Returns the (n_local, d) aggregate: the global `aggregate` on the
    permuted layout, restricted to this rank's rows. ``payload`` quantizes
    the wire (see :func:`halo_exchange`); ``overlap`` routes through
    :func:`split_halo_aggregate`.
    """
    halo = halo_exchange(z, send_idx, group, via=via, payload=payload)
    if overlap:
        return split_halo_aggregate(z, halo, senders, receivers, edge_w)
    full = torch.cat([z, halo])                           # [local ‖ halo]
    return aggregate(full, senders, receivers, z.shape[0], edge_w)


def hier_halo_aggregate(
    z: torch.Tensor,
    send_loc: torch.Tensor,
    send_rem: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_w: torch.Tensor,
    groups: tuple,
    via: str = "all_gather",
    payload: str | None = None,
    overlap: bool = False,
) -> torch.Tensor:
    """:func:`halo_aggregate` over the two-phase (pod, model) exchange: the
    ``senders`` here come from a hierarchical plan (they index the
    member-block table of :func:`hier_halo_exchange`, < n_local +
    k_model·B). ``payload``/``overlap`` behave as on :func:`halo_aggregate`.
    """
    halo = hier_halo_exchange(z, send_loc, send_rem, groups, via=via, payload=payload)
    if overlap:
        return split_halo_aggregate(z, halo, senders, receivers, edge_w)
    full = torch.cat([z, halo])                           # [local ‖ halo]
    return aggregate(full, senders, receivers, z.shape[0], edge_w)
