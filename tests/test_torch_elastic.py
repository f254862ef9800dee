"""The port's elastic re-planning (`repro_torch.train.elastic`) against the
JAX package's `repro.train.elastic`, on the CPU.

* `elastic_replan` over the reference's Hypothesis ranges
  (tests/test_train_substrate.py:156): the same shape, and the model
  degree kept whenever the healthy ranks allow it;
* the plan cache across a resize (tests/test_dist_extra.py:241): a pure
  resize keeps the plan object and evicts nothing; halving the model
  degree evicts, in both packages alike (``evictions`` included);
* `relocate_state_tree` between two row layouts of one graph: the same
  arrays as the reference's on the same `PlanLayout`, and an exact round
  trip;
* `scale_batch` and `reshard_tree` (placement on the rank's device).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist import halo as j_halo
from repro.train import elastic as j_elastic
from repro_torch.core.partition import partition_graph
from repro_torch.dist import halo
from repro_torch.graph.generators import citation_like
from repro_torch.train.elastic import MeshPlan, elastic_replan, relocate_state_tree, reshard_tree, scale_batch


@settings(max_examples=50, deadline=None)
@given(n=st.integers(1, 512), m=st.sampled_from([1, 2, 4, 8, 16]))
def test_elastic_replan_matches_jax(n, m):
    """The reference's property (fits, keeps the model axis when n ≥ m) and
    the reference's shape."""
    plan = elastic_replan(n, m)
    assert plan.n_devices <= n
    if n >= m:
        assert plan.shape[1] == m
    assert plan.shape[0] >= 1
    ref = j_elastic.elastic_replan(n, m)
    assert (plan.shape, plan.axes, plan.n_devices) == (tuple(ref.shape), tuple(ref.axes), ref.n_devices)


def test_elastic_replan_refuses_no_healthy_device():
    with pytest.raises(ValueError, match="no healthy devices"):
        elastic_replan(0, 4)


def _cache_walk(mod, part_mod):
    """tests/test_dist_extra.py:241 in package ``mod``: (shapes, whether the
    plan survived each step, the cache stats after each step)."""
    elastic = j_elastic if mod is j_halo else __import__("repro_torch.train.elastic", fromlist=["x"])
    mod.invalidate_halo_plans()
    mod.reset_plan_cache_stats()
    g = citation_like(100, 500, seed=2)
    part = part_mod.partition_graph(100, g.edge_index, 8, method="bfs", seed=0)
    p1 = mod.get_halo_plan(part, g.edge_index)
    steps = [mod.plan_cache_stats()]
    keep = elastic.elastic_replan(32, 8)
    same = mod.get_halo_plan(part, g.edge_index) is p1
    steps.append(mod.plan_cache_stats())
    shrink = elastic.elastic_replan(4, 8)
    rebuilt = mod.get_halo_plan(part, g.edge_index) is not p1
    steps.append(mod.plan_cache_stats())
    mod.invalidate_halo_plans()
    return (tuple(keep.shape), tuple(shrink.shape)), (same, rebuilt), steps


def test_plan_cache_elastic_resize_matches_jax():
    """A data-axis-only shrink keeps the model degree: the same plan object,
    0 evictions. A model-degree change re-partitions: the plan is evicted
    and rebuilt. Shapes, survival and every cache counter equal the
    reference's."""
    from repro.core import partition as j_partition
    from repro_torch.core import partition

    ours = _cache_walk(halo, partition)
    theirs = _cache_walk(j_halo, j_partition)
    assert ours == theirs
    (keep, shrink), (same, rebuilt), steps = ours
    assert keep == (4, 8) and shrink[1] == 4 and same and rebuilt
    assert steps[1]["evictions"] == 0 and steps[2]["evictions"] >= 1


def test_scoped_eviction_touches_one_graph():
    """``graph_key`` scopes the halving's eviction to the graph being
    re-partitioned; another graph's plan stays cached (the same object)."""
    halo.invalidate_halo_plans()
    ga, gb = citation_like(90, 400, seed=3), citation_like(90, 400, seed=4)
    part_a = partition_graph(90, ga.edge_index, 4, method="bfs", seed=0)
    part_b = partition_graph(90, gb.edge_index, 4, method="bfs", seed=0)
    halo.get_halo_plan(part_a, ga.edge_index, graph_key="elastic:a")
    pb = halo.get_halo_plan(part_b, gb.edge_index, graph_key="elastic:b")
    before = halo.plan_cache_stats()["evictions"]
    assert elastic_replan(1, 4, graph_key="elastic:a").shape == (1, 1)
    assert halo.plan_cache_stats()["evictions"] == before + 1
    assert halo.get_halo_plan(part_b, gb.edge_index, graph_key="elastic:b") is pb
    halo.invalidate_halo_plans()


def test_relocate_state_tree_matches_jax_and_round_trips():
    """Per-node state in one row layout of a graph, carried into another
    (two partitions of the same graph; the old one as a `PlanLayout`
    snapshot): the port's arrays equal the reference's on the same layouts,
    the round trip is exact, and leaves of other shapes pass untouched."""
    g = citation_like(300, 1800, seed=13)
    x = np.random.default_rng(4).standard_normal((300, 8)).astype(np.float32)
    old = halo.build_halo_plan(partition_graph(300, g.edge_index, 4, method="bfs", seed=0), g.edge_index)
    new = halo.build_halo_plan(partition_graph(300, g.edge_index, 4, method="block"), g.edge_index)
    old_layout = halo.plan_layout(old)
    j_old, j_new = j_halo.plan_layout(old), j_halo.plan_layout(new)
    tree = {"m": halo.relocate_node_array(old_layout, x), "v": halo.relocate_node_array(old_layout, 2 * x),
            "dense": np.full((3, 3), 7.0, np.float32), "none": None}
    moved = relocate_state_tree(old_layout, halo.plan_layout(new), tree)
    want = j_elastic.relocate_state_tree(j_old, j_new, tree)
    for key in ("m", "v"):
        np.testing.assert_array_equal(moved[key], np.asarray(want[key]))
    np.testing.assert_array_equal(halo.restore_node_array(new, moved["m"]), x)
    np.testing.assert_array_equal(halo.restore_node_array(new, moved["v"]), 2 * x)
    assert moved["dense"] is tree["dense"] and moved["none"] is None
    back = relocate_state_tree(halo.plan_layout(new), old_layout, moved)
    np.testing.assert_array_equal(back["m"], tree["m"])


def test_scale_batch_matches_jax():
    for args in ((256, 32, 28), (256, 32, 32), (7, 8, 2), (1024, 4, 2)):
        assert scale_batch(*args) == j_elastic.scale_batch(*args)
    assert scale_batch(256, 32, 28) == 224


def test_reshard_tree_places_every_leaf():
    """A restored checkpoint (numpy leaves) and tensors land on the rank's
    device as tensors with their values; None passes."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": torch.ones(3), "none": None}
    placed = reshard_tree(tree, "cpu")
    assert placed["none"] is None
    assert placed["w"].device.type == "cpu" and torch.equal(placed["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(placed["b"], torch.ones(3))


def test_mesh_plan_shape_and_build_checks():
    """`MeshPlan` keeps the reference's shape, axes and size; `build`
    refuses a shape of another rank count than the group's (the groups
    themselves: tests/test_torch_hier_halo.py)."""
    plan = MeshPlan(shape=(2, 4), axes=("data", "model"))
    ref = j_elastic.MeshPlan(shape=(2, 4), axes=("data", "model"))
    assert plan.n_devices == ref.n_devices == 8
    with pytest.raises(ValueError, match="two axes"):
        MeshPlan(shape=(8,), axes=("model",)).build()
