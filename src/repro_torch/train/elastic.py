"""Elastic scaling: re-plan and re-place after rank loss — twin of
`repro.train.elastic` (DESIGN.md §3).

The contract at pod scale: a failed host removes a slice of ranks; the
controller (a) picks the largest still-healthy group shape from the
preference ladder, (b) restores the latest checkpoint (checkpoints are
host arrays that do not depend on the group: `repro_torch.train.checkpoint`)
and places it on each rank's device, (c) rescales the data pipeline to the
new data-parallel width. The planning is pure logic over rank counts and
numpy layouts, so it runs on the CPU; `MeshPlan.build` is the only call that
needs a running group.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import tree_map

__all__ = [
    "MeshPlan",
    "elastic_replan",
    "relocate_state_tree",
    "reshard_tree",
    "scale_batch",
]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A group shape: ``shape[i]`` ranks along axis ``axes[i]``, raveled
    outer-major (the reference's mesh shape and axis names)."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    def build(self) -> dict:
        """This rank's process groups of the shape, by axis name, in a
        running group of exactly `n_devices` ranks (`repro_torch.launch.mesh`):
        ``axes[1]`` the ranks of its outer slice, ``axes[0]`` the ranks with
        its index in every slice — for ``("data", "model")``, the model group
        a halo exchange runs over and the data group gradients average over
        (`repro_torch.launch.mesh.grid_groups`). Called by every rank."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import grid_groups

        if len(self.shape) != 2 or len(self.axes) != 2:
            raise ValueError(f"a group shape has two axes (outer, inner), got {self.shape} over {self.axes}")
        k = dist.get_world_size()
        if k != self.n_devices:
            raise ValueError(f"the group has {k} ranks; the shape {self.shape} needs {self.n_devices}")
        return dict(zip(self.axes, grid_groups(self.shape[0])))


def elastic_replan(
    n_healthy: int,
    model_shards: int,
    axes: tuple[str, ...] = ("data", "model"),
    *,
    graph_key: str | None = None,
) -> MeshPlan:
    """Largest group shape ≤ n_healthy that preserves the model-parallel
    degree.

    Model-parallel shards hold partitioned state (the COIN CE partition —
    can't shrink without re-partitioning), so the data axis absorbs the
    loss: data' = floor(n_healthy / model_shards). A **pure resize** (the
    model degree survives, only the data axis narrows) keeps the node→CE
    partition intact, so NO cached halo plan is touched — plan-cache
    ``evictions`` stays 0 and the same plan objects serve across the resize.

    Only when fewer than one data replica remains are the model shards
    halved — a re-partition event: the k of the node→CE partition changed,
    so the boundary relocation is stale and the affected plans are evicted
    (DESIGN.md §8). Pass ``graph_key`` (the training graph's fingerprint) to
    scope that eviction to the one graph being re-partitioned — every
    ``(axes, n_pods)`` flavor of it goes in the one call — instead of
    flushing every graph's plans.
    """
    if n_healthy < 1:
        raise ValueError("no healthy devices")
    m = model_shards
    while m > 1 and n_healthy < m:
        m //= 2
    if m != model_shards:
        from repro_torch.dist.halo import invalidate_halo_plans

        invalidate_halo_plans(graph_key)
    d = max(n_healthy // m, 1)
    return MeshPlan(shape=(d, m), axes=axes)


def reshard_tree(tree: Any, device: str | torch.device) -> Any:
    """Every leaf of ``tree`` (tensors, or numpy arrays of a restored
    checkpoint) as a tensor on this rank's ``device``: the port's
    placement, where the reference ``device_put``s each leaf with
    NamedShardings over the new mesh. A rank holds whole arrays (the
    model's parameters are replicated; per-node state is already this
    rank's block), so placement is a copy to its device. ``None`` passes
    through."""
    return tree_map(lambda leaf: torch.as_tensor(leaf).to(device), tree)


def relocate_state_tree(old_layout: Any, new_plan: Any, tree: Any) -> Any:
    """Carry live per-node state across an in-place re-localization.

    ``old_layout`` is a `repro_torch.dist.halo.PlanLayout` snapshot taken
    BEFORE the re-localization; ``new_plan`` is any plan/layout in the NEW
    row order. Every leaf whose leading dims match the old blocked shape
    ``(k, n_local)`` — relocated features, per-node optimizer moments,
    layer activations — is routed ``restore_node_array(old)`` →
    ``relocate_node_array(new)``: back to global node order, then into the
    fresh blocks. The round trip is EXACT (pure gathers, no arithmetic).
    Leaves are numpy arrays (host state: move tensors to the host first);
    leaves of any other shape (dense weights, scalars, None) pass through
    untouched.
    """
    from repro_torch.dist.halo import relocate_node_array, restore_node_array

    old_shape = (int(old_layout.k), int(old_layout.n_local))

    def move(leaf):
        if not hasattr(leaf, "shape") or tuple(np.shape(leaf)[:2]) != old_shape:
            return leaf
        return relocate_node_array(new_plan, restore_node_array(old_layout, np.asarray(leaf)))

    return tree_map(move, tree)


def scale_batch(global_batch: int, old_data_shards: int, new_data_shards: int) -> int:
    """Keep per-device batch constant across a re-shard (linear-scaling rule:
    the caller rescales LR by new/old)."""
    per_device = max(global_batch // old_data_shards, 1)
    return per_device * new_data_shards
