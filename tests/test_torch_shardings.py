"""The port's sharding rules (`repro_torch.launch.shardings`) against the
reference's (`repro.launch.shardings`), leaf by leaf, on the CPU.

The reference's rules run over a `jax.sharding.AbstractMesh` with Auto
axes (under jax 0.9 `jax.make_mesh` builds Explicit axes; ROADMAP.md
queue 3), the port's over a `Grid` of the same axis names and sizes.
Each port spec must equal ``tuple(PartitionSpec)``:

* `lm_param_specs` for the five LMs, FULL and REDUCED, at model sizes 1,
  2, 4 and 16 (data 2), and on a (pod, data, model) grid;
* `cache_spec` for every LM shape of the registry (the kv-head, sequence
  and batch-1 branches), `lm_policy`'s named specs;
* `recsys_param_specs` and `recsys_policy` for DeepFM, FULL and REDUCED;
  `gnn_policy`'s specs and modes; `replicated_specs`.

Then `shard_tree`'s shards put back together equal the whole tree (numpy
and torch), `draw_tree`'s blocks equal the same cut of the whole draw,
and `Grid.coords` ravels ranks as a JAX mesh ravels its devices.
"""
import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec

from repro.configs import registry as j_registry
from repro.launch import shardings as j_sh
from repro.models.deepfm import deepfm_init as j_deepfm_init
from repro.models.transformer_lm import lm_init as j_lm_init
from repro.models.transformer_lm import lm_param_shapes as _lm_param_shapes
from repro_torch.configs import registry as t_registry
from repro_torch.launch import shardings as t_sh
from repro_torch.launch.mesh import Grid
from repro_torch.launch.steps import draw_tree
from repro_torch.models.deepfm import deepfm_param_plan
from repro_torch.models.transformer_lm import lm_param_plan

LMS = ("gemma3-12b", "stablelm-12b", "granite-34b", "olmoe-1b-7b", "moonshot-v1-16b-a3b")
MODEL_SIZES = (1, 2, 4, 16)


lm_param_shapes = functools.cache(_lm_param_shapes)      # tracing lm_init: a second a FULL config


def _mesh(axes, sizes):
    return AbstractMesh(tuple(sizes), tuple(axes), axis_types=(AxisType.Auto,) * len(axes))


def _pairs(model: int):
    axes, sizes = ("data", "model"), (2, model)
    return _mesh(axes, sizes), Grid(axes, sizes)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in tree for n, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _same(port_tree, ref_tree):
    ref = {n: tuple(s) for n, s in _leaves(jax.tree_util.tree_map(
        lambda s: s, ref_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))).items()}
    port = _leaves(port_tree)
    assert set(port) == set(ref)
    for name, spec in ref.items():
        assert port[name] == spec, (name, port[name], spec)


def _cfgs(arch, full):
    j_spec, t_spec = j_registry.get_arch(arch), t_registry.get_arch(arch)
    return (j_spec.make_config(), t_spec.make_config()) if full else (j_spec.make_reduced(), t_spec.make_reduced())


@pytest.mark.parametrize("arch,full,model", list(itertools.product(LMS, (True, False), MODEL_SIZES)))
def test_lm_specs_equal_the_reference(arch, full, model):
    j_cfg, t_cfg = _cfgs(arch, full)
    mesh, grid = _pairs(model)
    _same(t_sh.lm_param_specs(lm_param_plan(t_cfg), t_cfg, grid),
          j_sh.lm_param_specs(lm_param_shapes(j_cfg), j_cfg, mesh))
    # The port's rule also reads the reference's own shape tree.
    _same(t_sh.lm_param_specs(lm_param_shapes(j_cfg), t_cfg, grid),
          j_sh.lm_param_specs(lm_param_shapes(j_cfg), j_cfg, mesh))
    want = {k: tuple(v) for k, v in j_sh.lm_policy(mesh, j_cfg).specs.items()}
    assert t_sh.lm_policy(grid, t_cfg).specs == want
    for name, shape in j_registry.get_arch(arch).shapes.items():
        t_shape = t_registry.get_arch(arch).shapes[name]
        assert t_sh.cache_spec(t_cfg, t_shape, grid) == tuple(j_sh.cache_spec(j_cfg, shape, mesh)), name


@pytest.mark.parametrize("full,model", list(itertools.product((True, False), MODEL_SIZES)))
def test_recsys_specs_equal_the_reference(full, model):
    j_cfg, t_cfg = _cfgs("deepfm", full)
    mesh, grid = _pairs(model)
    shapes = jax.eval_shape(lambda k: j_deepfm_init(k, j_cfg), jax.random.PRNGKey(0))
    _same(t_sh.recsys_param_specs(deepfm_param_plan(t_cfg)), j_sh.recsys_param_specs(shapes))
    _same(t_sh.recsys_param_specs(shapes), j_sh.recsys_param_specs(shapes))
    _same(t_sh.replicated_specs(shapes), j_sh.replicated_specs(shapes))
    assert t_sh.recsys_policy(grid).specs == {k: tuple(v) for k, v in j_sh.recsys_policy(mesh).specs.items()}


def test_pod_grid_and_gnn_policy_equal_the_reference():
    axes, sizes = ("pod", "data", "model"), (2, 2, 4)
    mesh, grid = _mesh(axes, sizes), Grid(axes, sizes)
    j_cfg, t_cfg = _cfgs("moonshot-v1-16b-a3b", False)
    _same(t_sh.lm_param_specs(lm_param_plan(t_cfg), t_cfg, grid), j_sh.lm_param_specs(lm_param_shapes(j_cfg), j_cfg, mesh))
    assert t_sh.lm_policy(grid, t_cfg).specs == {k: tuple(v) for k, v in j_sh.lm_policy(mesh, j_cfg).specs.items()}
    for name, shape in j_registry.get_arch("gemma3-12b").shapes.items():
        assert t_sh.cache_spec(t_cfg, shape, grid) == tuple(j_sh.cache_spec(j_cfg, shape, mesh))
    for batched in (True, False):
        for comm in ("halo", "broadcast"):
            j_pol, t_pol = j_sh.gnn_policy(mesh, batched, comm=comm), t_sh.gnn_policy(grid, batched, comm=comm)
            assert t_pol.specs == {k: tuple(v) for k, v in j_pol.specs.items()}
            assert t_pol.comm == j_pol.comm
    with pytest.raises(ValueError, match="unknown comm"):
        t_sh.gnn_policy(grid, False, comm="ring")


@pytest.mark.parametrize("sizes", [(1, 4), (2, 2), (4, 1)])
def test_shard_tree_pieces_put_back_equal_the_whole(sizes):
    grid = Grid(("data", "model"), sizes)
    _, t_cfg = _cfgs("gemma3-12b", False)
    whole = jax.tree_util.tree_map(np.asarray, j_lm_init(jax.random.PRNGKey(0), _cfgs("gemma3-12b", False)[0]))
    specs = t_sh.lm_param_specs(whole, t_cfg, grid)
    as_torch = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), whole)
    for tree in (whole, as_torch):
        back = {n: np.zeros(np.shape(v), np.float32) for n, v in _leaves(whole).items()}
        for r in range(grid.size):
            shard = _leaves(t_sh.shard_tree(tree, specs, grid.coords(r)))
            for name, block in shard.items():
                block = block.numpy() if isinstance(block, torch.Tensor) else block
                back[name][t_sh.shard_slices(back[name].shape, _leaves(specs)[name], grid.coords(r))] = block
        for name, leaf in _leaves(whole).items():
            np.testing.assert_array_equal(back[name], leaf, err_msg=name)
    with pytest.raises(ValueError, match="evenly"):
        t_sh.shard_slices((6,), ("model",), {"model": (0, 4)})


@pytest.mark.parametrize("which,sizes", [("moonshot", (1, 4)), ("deepfm", (2, 16)), ("gemma", (2, 2))])
def test_draw_tree_blocks_equal_the_whole_draw(which, sizes):
    """A rank draws only the blocks its shard touches (the table split
    inside a field at model 16), the same numbers as the whole draw."""
    grid = Grid(("data", "model"), sizes)
    if which == "deepfm":
        plan = deepfm_param_plan(t_registry.get_arch("deepfm").make_reduced())
        specs = t_sh.recsys_param_specs(plan)
    else:
        cfg = t_registry.get_arch("moonshot-v1-16b-a3b" if which == "moonshot" else "gemma3-12b").make_reduced()
        plan = lm_param_plan(cfg)
        specs = t_sh.lm_param_specs(plan, cfg, grid)
    whole = draw_tree(7, plan, torch.float32, "cpu")
    for r in range(grid.size):
        coords = grid.coords(r)
        got, want = _leaves(draw_tree(7, plan, torch.float32, "cpu", specs, coords)), \
            _leaves(t_sh.shard_tree(whole, specs, coords))
        for name in want:
            assert torch.equal(got[name], want[name]), (r, name)
    std = float(_leaves(whole)["/embed" if which != "deepfm" else "/table"].std())
    assert std == pytest.approx(0.02 if which != "deepfm" else 0.01, rel=0.1)


def test_grid_coords_ravel_as_a_jax_mesh():
    grid = Grid(("pod", "data", "model"), (2, 3, 4))
    for r in range(grid.size):
        idx = np.unravel_index(r, (2, 3, 4))
        assert grid.coords(r) == {a: (int(i), n) for a, i, n in zip(grid.axes, idx, grid.sizes)}
    assert (grid.n_data, grid.n_model, grid.size) == (6, 4, 24)
    with pytest.raises(ValueError, match="innermost"):
        Grid(("model", "data"), (2, 2))
