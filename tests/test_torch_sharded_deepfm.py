"""The port's sharded DeepFM (the table and ``w_linear`` row-sharded over
the model group, the batch over the data group) against the JAX
package's unsharded functions, on the CPU.

Two 4-rank `gloo` groups (`repro_torch.launch.mesh.run_group`, rank body
`_torch_sharded_ranks.deepfm_group`), on 2 × 2 and 1 × 4 grids (data ×
model), started side by side once for the module. The parameters are the
reference's `deepfm_init` on the REDUCED config (8 fields × 1,000 rows),
cut with `shard_tree`; ids, labels and candidates are seeded numpy. Held
against the reference, at tests/test_torch_deepfm.py's tolerances:

* `deepfm_forward` on the batch (the data shards put back together) and
  `deepfm_retrieval` of one user against 100 candidates split over the
  model group (the score shards gathered): 1e-5 of the largest output;
* the gradient of `deepfm_loss` (the mean over the global batch), every
  leaf put back together and summed over the data group: 1e-5 of each
  leaf's largest entry;
* five AdamW steps: the losses within 1e-5 relative, every parameter
  after the last step within 1e-4 of its largest entry;
* `reduce_scatter` over the model group (retrieval's candidate sum): each
  rank's block of the sum, and its backward (the ranks' cotangents
  gathered), within 1e-6.

The specs and `shard_tree` themselves are held in
tests/test_torch_shardings.py.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import deepfm as j_cfg_mod
from repro.models import deepfm as j_fm
from repro.train.optimizer import adamw as j_adamw
from repro_torch.configs import deepfm as t_cfg_mod
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Grid, GroupSpec, run_group

import _torch_sharded_ranks as ranks

B, N_CAND, STEPS = 64, 100, 5
GRIDS = {"2x2": Grid(("data", "model"), (2, 2)), "1x4": Grid(("data", "model"), (1, 4))}
J_CFG, T_CFG = j_cfg_mod.SPEC.make_reduced(), t_cfg_mod.SPEC.make_reduced()


def _inputs():
    params = jax.tree_util.tree_map(np.asarray, j_fm.deepfm_init(jax.random.PRNGKey(0), J_CFG))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, J_CFG.rows_per_field, (B, J_CFG.n_fields)).astype(np.int32)
    labels = (rng.random(B) < 0.3).astype(np.float32)
    user = rng.integers(0, J_CFG.rows_per_field, (1, J_CFG.n_fields)).astype(np.int32)
    cands = rng.integers(0, J_CFG.rows_per_field, (1, N_CAND)).astype(np.int32)
    scatter = rng.standard_normal((4, 2, 8, 3)).astype(np.float32)       # one (2, 8, 3) block a rank
    scatter_w = rng.standard_normal((4, 2, 8, 3)).astype(np.float32)     # each rank's cotangent (cut to its block)
    return dict(cfg=T_CFG, params=params, ids=ids, labels=labels, user=user, cands=cands, steps=STEPS,
                scatter=scatter, scatter_w=scatter_w)


@pytest.fixture(scope="module")
def runs():
    job = _inputs()
    with ThreadPoolExecutor(len(GRIDS)) as pool:
        out = dict(zip(GRIDS, pool.map(
            lambda g: run_group(GroupSpec(k=4, timeout_s=300.0), ranks.deepfm_group, [dict(job, grid=GRIDS[g])] * 4),
            GRIDS)))
    return dict(job=job, out=out, ref=_reference(job))


def _reference(job):
    jp = jax.tree_util.tree_map(jnp.asarray, job["params"])
    ids, labels = jnp.asarray(job["ids"]), jnp.asarray(job["labels"])
    out = {"forward": np.asarray(j_fm.deepfm_forward(jp, ids, J_CFG)),
           "retrieval": np.asarray(j_fm.deepfm_retrieval(jp, jnp.asarray(job["user"]), jnp.asarray(job["cands"]),
                                                         J_CFG))}
    grad_fn = jax.jit(jax.value_and_grad(lambda p: j_fm.deepfm_loss(p, ids, labels, J_CFG)))
    opt = j_adamw(ranks.LR)
    state, losses = opt.init(jp), []
    for step in range(STEPS):
        loss, grads = grad_fn(jp)
        if step == 0:
            out["grads"] = jax.tree_util.tree_map(np.asarray, grads)
        jp, state = opt.update(grads, state, jp)
        losses.append(float(loss))
    out["losses"], out["params"] = losses, jax.tree_util.tree_map(np.asarray, jp)
    return out


def _rel_close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in tree for n, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _unshard(results, key, like, grid):
    specs = _leaves(sh.recsys_param_specs(like))
    got = [_leaves(r[key]) for r in results]
    whole = {}
    for name, leaf in _leaves(like).items():
        full = np.zeros(np.shape(leaf), np.float32)
        for r, tree in enumerate(got):
            full[sh.shard_slices(full.shape, specs[name], grid.coords(r))] = tree[name]
        whole[name] = full
    return whole


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_sharded_deepfm_matches_the_reference(runs, grid_name):
    grid, ref = GRIDS[grid_name], runs["ref"]
    results = runs["out"][grid_name]
    n_model = grid.shape["model"]
    forward = np.concatenate([results[d * n_model]["forward"] for d in range(grid.size // n_model)])
    _rel_close(forward, ref["forward"], 1e-5, "logits")
    for r in results:
        _rel_close(r["retrieval"], ref["retrieval"], 1e-5, "scores")
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
    for key, tol in (("grads", 1e-5), ("params", 1e-4)):
        whole, want = _unshard(results, key, runs["job"]["params"], grid), _leaves(ref[key])
        for name, w in want.items():
            if np.abs(w).max() == 0:
                assert np.abs(whole[name]).max() == 0, (key, name)
            else:
                _rel_close(whole[name], w, tol, (key, name))


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_reduce_scatter_is_the_model_sum_scattered(runs, grid_name):
    grid, job = GRIDS[grid_name], runs["job"]
    n = grid.shape["model"]
    s = job["scatter"].shape[2] // n
    for r, res in enumerate(runs["out"][grid_name]):
        group = range(r - r % n, r - r % n + n)          # the model group: one data index, every model index
        m = r % n
        want = sum(job["scatter"][j][:, m * s:(m + 1) * s] for j in group)
        want_grad = np.concatenate([job["scatter_w"][j][:, :s] for j in group], axis=1)
        got, grad = res["reduce_scatter"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6)


def test_lamb_is_refused_on_a_model_split_tree():
    """LAMB's trust ratio needs each leaf's whole norm: `data_parallel`
    refuses it where a leaf splits over the model group; AdamW passes, and
    at a data size of 1 it is the optimizer itself."""
    from repro_torch.train.optimizer import adamw, data_parallel, lamb

    policy = sh.recsys_policy(GRIDS["1x4"])
    specs = sh.recsys_param_specs(_inputs()["params"])
    with pytest.raises(NotImplementedError, match="LAMB"):
        data_parallel(lamb(), policy, specs)
    opt = adamw()
    assert data_parallel(opt, policy, specs) is opt
    assert data_parallel(lamb(), policy, sh.replicated_specs(_inputs()["params"])).name == "lamb"


def test_donated_adamw_step_equals_the_functional_one():
    """``donate=True`` (the train cells' ``donate``, the reference's
    ``donate_argnums``) writes the same values into the inputs."""
    import torch

    from repro_torch.train.optimizer import adamw
    from repro_torch.train.tree import tree_map

    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
              "b": {"c": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}}
    grads = tree_map(lambda p: torch.randn_like(p), params)
    plain, donated = adamw(1e-2), adamw(1e-2, donate=True)
    want, want_state = plain.update(grads, plain.init(params), params)
    mine = tree_map(torch.clone, params)
    state = donated.init(mine)
    for _ in range(2):
        got, got_state = donated.update(grads, state, mine)
        assert got["a"] is mine["a"] and got_state["m"]["b"]["c"] is state["m"]["b"]["c"]
        state = got_state
        if _ == 0:
            for x, y in ((got, want), (got_state["m"], want_state["m"]), (got_state["v"], want_state["v"])):
                assert torch.equal(x["a"], y["a"]) and torch.equal(x["b"]["c"], y["b"]["c"])
            want, want_state = plain.update(grads, want_state, want)
    assert torch.equal(got["a"], want["a"]) and int(state["step"]) == 2
