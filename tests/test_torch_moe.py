"""The port's MoE FFN (`repro_torch.nn.moe`) and the MoE LM against the JAX
package's, on the CPU.

Same numpy inputs into both packages; the parameters are the reference's
`moe_init` / `lm_init`, carried across as numpy.

* `MoEConfig.capacity` equals the reference's for T in 1–4,096 (three
  expert layouts);
* `moe_apply` at groups 1 and 4: the twin of
  tests/test_halo_dist.py::test_grouped_moe_equals_flat (1e-6), and
  against the reference at T ≤ 512 (drop-free) and at T = 1,024 (groups 1)
  and 4,096 (groups 4) with a router scaled and the inputs shifted so that
  capacity drops tokens: the test asserts drops occur, and that ``keep``
  (array-equal), ``out`` and ``aux`` (1e-5 of their largest value) equal
  the reference's; the top-k order among equal probabilities is
  ``jax.lax.top_k``'s (lower expert first);
* `moe_apply`'s gradients against ``jax.grad`` (2e-4 of each leaf's
  largest |g|, the LM tolerance of tests/test_models.py);
* `lm_init`'s stacked MoE tree; the "moe" case of
  tests/test_models.py::test_lm_decode_matches_forward (2e-4) against the
  port's forward and the reference's decode; the batcher's greedy tokens
  for an MoE config equal to the reference batcher's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer_lm as j_lm
from repro.nn import moe as j_moe
from repro.serve import scheduler as j_sched
from repro_torch.models import transformer_lm as t_lm
from repro_torch.nn import moe as t_moe
from repro_torch.serve.scheduler import ContinuousBatcher, Request
from repro_torch.train.loop import value_and_grad

TOL = 1e-5
LM_TOL = 2e-4
KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    return j_moe.MoEConfig(**kw), t_moe.MoEConfig(**kw)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("E,K,cf", [(8, 2, 1.25), (64, 8, 1.25), (64, 6, 1.0)])
def test_capacity_equals_the_reference(E, K, cf):
    j_cfg, t_cfg = _cfgs(num_experts=E, top_k=K, d_model=8, d_ff=8, capacity_factor=cf)
    for T in range(1, 4097):
        assert t_cfg.capacity(T) == j_cfg.capacity(T), T
    if (E, K, cf) == (64, 8, 1.25):                 # olmoe-1b-7b's layer at a 4,096-token prefill
        assert t_cfg.capacity(4096) == 640


def test_moe_init_has_the_reference_leaves():
    j_cfg, t_cfg = _cfgs(num_experts=8, top_k=2, d_model=32, d_ff=64)
    j_p = j_moe.moe_init(KEY, j_cfg)
    t_p = t_moe.moe_init(torch.Generator().manual_seed(0), t_cfg, device="cpu")
    stacked = t_moe.moe_init(torch.Generator().manual_seed(0), t_cfg, device="cpu", n_layers=3)
    for name, leaf in j_p.items():
        assert tuple(t_p[name].shape) == leaf.shape and t_p[name].dtype == torch.float32
        assert tuple(stacked[name].shape) == (3, *leaf.shape)
        np.testing.assert_allclose(float(t_p[name].std()), float(jnp.std(leaf)), rtol=0.2)


def test_grouped_moe_equals_flat():
    """tests/test_halo_dist.py::test_grouped_moe_equals_flat in the port, on
    the reference's parameters and input, and against the reference."""
    j1, t1 = _cfgs(num_experts=8, top_k=2, d_model=32, d_ff=64, capacity_factor=8.0, groups=1)
    t4 = dataclasses.replace(t1, groups=4)
    p = j_moe.moe_init(KEY, j1)
    x = np.asarray(jax.random.normal(KEY, (128, 32)))
    y1, a1 = t_moe.moe_apply(_torch_tree(p), torch.from_numpy(x), t1)
    y4, a4 = t_moe.moe_apply(_torch_tree(p), torch.from_numpy(x), t4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=1e-6)
    assert abs(float(a1 - a4)) < 1e-6
    j_y, j_a = j_moe.moe_apply(p, jnp.asarray(x), j1)
    np.testing.assert_allclose(y1.numpy(), np.asarray(j_y), rtol=TOL, atol=TOL * float(np.abs(j_y).max()))
    assert float(a1) == pytest.approx(float(j_a), rel=TOL)


def _j_keep(p, x, cfg):
    """The reference's ``keep`` of every group (its moe_apply, step by step)."""
    T, D = x.shape
    E, K, G = cfg.num_experts, cfg.top_k, cfg.groups
    probs = jax.nn.softmax((x @ p["router"]).astype(jnp.float32), axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, K)
    C = cfg.capacity(T // G)
    _, meta = jax.vmap(lambda xi, gi, ei: j_moe._dispatch(xi, gi, ei, E, K, C))(
        x.reshape(G, T // G, D), gate_vals.reshape(G, T // G, K), expert_idx.reshape(G, T // G, K))
    return np.asarray(meta[3])


@pytest.mark.parametrize("T,groups,skew", [(256, 1, False), (512, 4, False), (1024, 1, True), (4096, 4, True)])
def test_moe_apply_matches_the_reference(T, groups, skew):
    """With ``skew`` the router is scaled by 8 and the inputs shifted by 1, so
    routing is unbalanced and capacity drops (token, expert) pairs."""
    j_cfg, t_cfg = _cfgs(num_experts=8, top_k=2, d_model=32, d_ff=64, groups=groups)
    p = {k: np.asarray(v) for k, v in j_moe.moe_init(KEY, j_cfg).items()}
    x = np.random.default_rng(T).standard_normal((T, 32)).astype(np.float32)
    if skew:
        p["router"] = p["router"] * 8
        x = x + 1
    j_y, j_a = j_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), j_cfg)
    t_moe.RECORD = []
    try:
        y, a = t_moe.moe_apply(_torch_tree(p), torch.from_numpy(x), t_cfg)
        dropped = int(t_moe.RECORD[0]["dropped"])
    finally:
        t_moe.RECORD = None
    j_keep = _j_keep({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), j_cfg)
    probs = torch.softmax(torch.from_numpy(x @ p["router"]), -1)
    gates, idx = t_moe._top_k(probs, 2)
    C = t_cfg.capacity(T // groups)
    *_, keep, _ = t_moe._dispatch(torch.from_numpy(x).reshape(groups, T // groups, 32),
                                  gates.reshape(groups, -1, 2), idx.reshape(groups, -1, 2), 8, 2, C)[1]
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    assert dropped == int((~j_keep).sum())
    assert (dropped > 0) == skew
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), rtol=TOL, atol=TOL * float(np.abs(j_y).max()))
    assert float(a) == pytest.approx(float(j_a), rel=TOL)


def test_top_k_puts_the_lower_expert_first_among_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1]])
    vals, idx = t_moe._top_k(probs, 2)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    # a zero token routes uniformly: the reference's experts 0..K-1
    j_cfg, t_cfg = _cfgs(num_experts=8, top_k=2, d_model=32, d_ff=64)
    p = j_moe.moe_init(KEY, j_cfg)
    y, _ = t_moe.moe_apply(_torch_tree(p), torch.zeros(8, 32), t_cfg)
    j_y, _ = j_moe.moe_apply(p, jnp.zeros((8, 32)), j_cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=1e-7)


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_apply_gradients_match_jax(groups):
    j_cfg, t_cfg = _cfgs(num_experts=8, top_k=2, d_model=32, d_ff=64, groups=groups)
    p = {k: np.asarray(v) for k, v in j_moe.moe_init(KEY, j_cfg).items()}
    r = np.random.default_rng(9)
    x = r.standard_normal((64, 32)).astype(np.float32)
    w = r.standard_normal((64, 32)).astype(np.float32)

    def j_loss(p, x):
        y, aux = j_moe.moe_apply(p, x, j_cfg)
        return jnp.sum(y * w) + 0.5 * aux

    j_g = jax.jit(jax.grad(j_loss, argnums=(0, 1)))({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    def t_loss(tree, _):
        y, aux = t_moe.moe_apply(tree["p"], tree["x"], t_cfg)
        return torch.sum(y * torch.from_numpy(w)) + 0.5 * aux

    _, t_g = value_and_grad(t_loss, {"p": _torch_tree(p), "x": torch.from_numpy(x)}, None)
    for name, got, want in [*((k, t_g["p"][k], j_g[0][k]) for k in p), ("x", t_g["x"], j_g[1])]:
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= LM_TOL * float(np.abs(want).max()), name


# ------------------------------------------------------------------ MoE LM
MOE = (j_lm.LMConfig("m", 2, 32, 4, 4, 48, 67, moe_experts=4, moe_top_k=2),
       t_lm.LMConfig("m", 2, 32, 4, 4, 48, 67, moe_experts=4, moe_top_k=2))


def test_lm_init_stacks_the_moe_leaves_as_the_reference():
    j_cfg, t_cfg = MOE
    j_params = j_lm.lm_init(KEY, j_cfg)
    t_params = t_lm.lm_init(torch.Generator().manual_seed(0), t_cfg, device="cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(j_params)[0]
    for path, leaf in j_leaves:
        got = t_params
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == leaf.shape, path
    assert tuple(t_params["layers"]["moe"]["router"].shape) == (2, 32, 4)
    assert tuple(t_params["layers"]["moe"]["w_gate"].shape) == (2, 4, 32, 48)
    assert dataclasses.asdict(t_cfg.moe_cfg()) == dataclasses.asdict(j_cfg.moe_cfg())


def test_lm_decode_matches_forward_moe():
    """The "moe" case of tests/test_models.py::test_lm_decode_matches_forward:
    twelve teacher-forced decode steps against the port's forward and the
    reference's decode, on the reference's weights."""
    j_cfg, cfg = MOE
    j_params = j_lm.lm_init(KEY, j_cfg)
    params = t_lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params), "cpu")
    toks = np.asarray(jax.random.randint(KEY, (2, 12), 0, cfg.vocab))
    cache = t_lm.lm_init_cache(cfg, 2, 16, device="cpu")
    j_cache = j_lm.lm_init_cache(j_cfg, 2, 16)
    j_step = jax.jit(j_lm.lm_decode_step, static_argnums=4)
    outs = []
    for t in range(12):
        lg, cache = t_lm.lm_decode_step(params, cache, torch.from_numpy(toks[:, t]), t, cfg)
        j_lg, j_cache = j_step(j_params, j_cache, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32), j_cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(j_lg), rtol=LM_TOL, atol=LM_TOL)
        outs.append(lg)
    pre, aux = t_lm.lm_forward(params, torch.from_numpy(toks), cfg)
    j_pre, j_aux = j_lm.lm_forward(j_params, jnp.asarray(toks), j_cfg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), pre.numpy(), rtol=LM_TOL, atol=LM_TOL)
    np.testing.assert_allclose(pre.numpy(), np.asarray(j_pre), rtol=LM_TOL, atol=LM_TOL)
    assert float(aux) == pytest.approx(float(j_aux), rel=LM_TOL)


def test_batcher_tokens_equal_the_reference_batcher_moe():
    j_cfg, cfg = MOE
    j_params = j_lm.lm_init(jax.random.PRNGKey(1), j_cfg)
    params = t_lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=p).astype(np.int32) for p in (4, 9, 2, 6, 11)]
    out = {}
    for tag, cb in (("jax", j_sched.ContinuousBatcher(j_params, j_cfg, n_slots=2, max_len=24)),
                    ("torch", ContinuousBatcher(params, cfg, n_slots=2, max_len=24))):
        for i, p in enumerate(prompts):
            cb.submit((j_sched.Request if tag == "jax" else Request)(rid=i, prompt=p, max_new_tokens=6))
        out[tag] = {r.rid: r.generated for r in cb.run_until_drained()}
    assert out["torch"] == out["jax"]
