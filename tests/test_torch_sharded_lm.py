"""The port's sharded LM (tensor-, vocab- and expert-parallel over a 4-rank
`gloo` group) against the JAX package's unsharded functions, on the CPU.

Two groups (`repro_torch.launch.mesh.run_group`, rank body
`_torch_sharded_ranks.lm_group`), one on a 1 × 4 grid (data × model) and
one on 2 × 2, started once for the module. The parameters are the
reference's `lm_init` (REDUCED configs), carried over with
`params_from_numpy`'s conversion and `shard_tree`; the tokens and caches
are seeded numpy. Held against the reference:

* `lm_prefill` (the vocab shards gathered), `jax.grad(lm_loss)` per leaf
  (the shards put back together, summed over the data group), one AdamW
  step's parameters (against the reference's AdamW on the same gathered
  gradient: a first Adam step divides each entry by its own magnitude, so
  entries near ``eps`` would amplify a reassociated sum's last bits), `lm_decode_step` over positions that cross a cache
  shard's boundary and `decode_multi_pos` with per-slot positions;
* gemma3 REDUCED (4 query / 2 kv heads): at model 4 its K/V are replicated
  and its cache sharded by sequence (a local layer's window leaves a shard
  with no valid key); at model 2 both are sharded by kv heads; its bf16
  prefill at model 4; its batch-1 decode (the ``long_500k`` branch: the
  sequence over every axis);
* granite REDUCED (MQA, 6 heads) at model 2, cache sharded by sequence
  (its 6 heads do not split over 4: refused there);
* moonshot REDUCED (8 experts over the model ranks) end to end, and one
  skewed MoE layer (T 2,048; capacity 640 at groups 1, 320 at groups 2) at groups 1 and 2: outputs, aux,
  gradients, and the dropped (token, expert) pairs equal to the
  reference's. Over a data size of 2 the MoE gathers the expert ids over
  the data group, so groups = 1 routes the global batch as the reference.

Tolerances: fp32 `LM_TOL` 2e-4 (tests/test_torch_lm.py), bf16 5e-2 (the
parity contract), each relative to the reference's largest entry; the
sharded port against the unsharded port 1e-5.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_12b as j_gemma
from repro.configs import granite_34b as j_granite
from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.models import transformer_lm as j_lm
from repro.nn import moe as j_moe
from repro.serve import scheduler as j_sched
from repro.train.optimizer import adamw as j_adamw
from repro_torch.configs import gemma3_12b as t_gemma
from repro_torch.configs import granite_34b as t_granite
from repro_torch.configs import moonshot_v1_16b_a3b as t_moonshot
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Grid, GroupSpec, run_group
from repro_torch.models import transformer_lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import moe as t_moe
from repro_torch.serve.scheduler import decode_multi_pos
from repro_torch.train.optimizer import adamw
from repro_torch.train.tree import tree_map

import _torch_sharded_ranks as ranks

LM_TOL, BF16_TOL, SELF_TOL = 2e-4, 5e-2, 1e-5
KEY = jax.random.PRNGKey(0)
B, S = 2, 12
SMAX, POSITIONS, SLOTS = 24, list(range(9, 15)), [3, 13]    # 1 × 4 seq shards of 6, 2 × 2 of 12: 11 → 12 crosses both
GRIDS = {"1x4": Grid(("data", "model"), (1, 4)), "2x2": Grid(("data", "model"), (2, 2))}
CFGS = {"gemma": (j_gemma.REDUCED, t_gemma.REDUCED), "granite": (j_granite.REDUCED, t_granite.REDUCED),
        "moonshot": (j_moonshot.REDUCED, t_moonshot.REDUCED)}
MOE = dict(num_experts=8, top_k=2, d_model=32, d_ff=48)
MOE_T = 2048


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _inputs(name: str, seed: int, batch: int = B):
    j_cfg, _ = CFGS[name]
    params = _np_tree(j_lm.lm_init(jax.random.PRNGKey(seed), j_cfg))
    rng = np.random.default_rng(seed)
    hd = j_cfg.attn.head_dim
    shape = (j_cfg.n_layers, batch, SMAX, j_cfg.n_kv_heads, hd)
    decode = dict(cache_k=rng.standard_normal(shape).astype(np.float32),
                  cache_v=rng.standard_normal(shape).astype(np.float32),
                  tokens=rng.integers(0, j_cfg.vocab, (batch, len(POSITIONS))).astype(np.int32),
                  positions=POSITIONS, slot_positions=np.array(SLOTS[:batch], np.int32))
    tokens = rng.integers(0, j_cfg.vocab, (batch, S + 1)).astype(np.int32)
    return dict(cfg=CFGS[name][1], params=params, tokens=tokens, decode=decode)


def _moe_case(groups: int):
    j_cfg = j_moe.MoEConfig(**MOE, groups=groups)
    p = _np_tree(j_moe.moe_init(KEY, j_cfg))
    p["router"] = p["router"] * 8                 # skewed routing: capacity drops pairs
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((MOE_T, MOE["d_model"])) + 1).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return dict(cfg=t_moe.MoEConfig(**MOE, groups=groups), params=p, x=x, cotangent=cot, j_cfg=j_cfg)


def _jobs():
    gemma, moon = _inputs("gemma", 0), _inputs("moonshot", 1)
    bf16 = dict(_inputs("gemma", 2), dtype=torch.bfloat16, grad=False)
    bf16.pop("decode")
    long = dict(_inputs("gemma", 3, batch=1), prefill=False, grad=False)
    lm = {"1x4": {"gemma": gemma, "gemma_bf16": bf16, "moonshot": moon},
          "2x2": {"gemma": gemma, "granite": _inputs("granite", 4), "gemma_long": long, "moonshot": moon}}
    moe = {"1x4": {"moe_g1": _moe_case(1)}, "2x2": {"moe_g1": _moe_case(1), "moe_g2": _moe_case(2)}}
    return lm, moe


@pytest.fixture(scope="module")
def runs():
    """Both groups, started side by side."""
    lm, moe = _jobs_cached()

    def start(g):
        job = {"grid": GRIDS[g], "lm": lm[g], "moe": {k: {kk: vv for kk, vv in v.items() if kk != "j_cfg"}
                                                      for k, v in moe[g].items()}}
        return run_group(GroupSpec(k=4, timeout_s=300.0), ranks.lm_group, [job] * 4)

    with ThreadPoolExecutor(len(GRIDS)) as pool:
        out = dict(zip(GRIDS, pool.map(start, GRIDS)))
    return dict(lm=lm, moe=moe, out=out)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30))


def _data_rows(results, grid, key):
    """The batch put back together: data rank d's rows from its model rank 0."""
    n_model = grid.shape["model"]
    return np.concatenate([results[d * n_model][key] for d in range(grid.size // n_model)], axis=0)


def _unshard(results, key, like, specs, grid):
    """Each rank's block of every leaf placed back into the whole tree."""
    def place(path_like, path_spec, getter):
        if isinstance(path_like, dict):
            return {k: place(path_like[k], path_spec[k], lambda r, k=k, g=getter: g(r)[k]) for k in path_like}
        whole = np.zeros(path_like.shape, np.float32)
        for r, res in enumerate(results):
            whole[sh.shard_slices(whole.shape, path_spec, grid.coords(r))] = getter(res)
        return whole
    return place(like, specs, lambda r: r[key])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in tree for n, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


_j_prefill = jax.jit(j_lm.lm_prefill, static_argnums=2)
_j_grad = jax.jit(jax.grad(j_lm.lm_loss), static_argnums=2)
_j_decode = jax.jit(j_lm.lm_decode_step, static_argnums=4)
_j_multi = jax.jit(j_sched.decode_multi_pos, static_argnums=4)


@functools.cache
def _reference_of(grid_name: str, case_name: str):
    return _reference(_jobs_cached()[0][grid_name][case_name])


@functools.cache
def _jobs_cached():
    return _jobs()


def _reference(case):
    """The reference's unsharded functions on the same inputs (jitted)."""
    j_cfg = {t: j for j, t in CFGS.values()}[case["cfg"]]
    jp = jax.tree_util.tree_map(jnp.asarray, case["params"])
    out = {}
    if case.get("prefill", True):
        if case.get("dtype") == torch.bfloat16:
            jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
            out["prefill"] = np.asarray(_j_prefill(jp16, jnp.asarray(case["tokens"][:, :-1]), j_cfg), np.float32)
        else:
            out["prefill"] = np.asarray(_j_prefill(jp, jnp.asarray(case["tokens"][:, :-1]), j_cfg))
    if case.get("grad", True):
        out["grads"] = _np_tree(_j_grad(jp, jnp.asarray(case["tokens"]), j_cfg))
    dec = case.get("decode")
    if dec is not None:
        cache = {"k": jnp.asarray(dec["cache_k"]), "v": jnp.asarray(dec["cache_v"])}
        steps = []
        for i, pos in enumerate(dec["positions"]):
            logits, cache = _j_decode(jp, cache, jnp.asarray(dec["tokens"][:, i]), jnp.int32(pos), j_cfg)
            steps.append(np.asarray(logits))
        out["decode"] = np.stack(steps, 1)
        cache = {"k": jnp.asarray(dec["cache_k"]), "v": jnp.asarray(dec["cache_v"])}
        out["multi_pos"] = np.asarray(_j_multi(
            jp, cache, jnp.asarray(dec["tokens"][:, 0]), jnp.asarray(dec["slot_positions"]), j_cfg)[0])
    return out


def _unsharded_port(case):
    """The port's own unsharded functions on the same inputs."""
    cfg = case["cfg"]
    params = tree_map(lambda a: torch.from_numpy(np.array(a)), case["params"])
    out = {}
    tokens = torch.from_numpy(case["tokens"]).long()
    with torch.no_grad():
        if case.get("prefill", True) and case.get("dtype") is None:
            out["prefill"] = t_lm.lm_prefill(params, tokens[:, :-1], cfg).numpy()
        dec = case.get("decode")
        if dec is not None:
            cache = {"k": torch.from_numpy(dec["cache_k"].copy()), "v": torch.from_numpy(dec["cache_v"].copy())}
            out["decode"] = np.stack([t_lm.lm_decode_step(params, cache, torch.from_numpy(dec["tokens"][:, i]), pos,
                                                          cfg)[0].numpy() for i, pos in enumerate(dec["positions"])], 1)
            cache = {"k": torch.from_numpy(dec["cache_k"].copy()), "v": torch.from_numpy(dec["cache_v"].copy())}
            out["multi_pos"] = decode_multi_pos(params, cache, torch.from_numpy(dec["tokens"][:, 0]),
                                                torch.from_numpy(dec["slot_positions"]), cfg)[0].numpy()
    if case.get("grad", True):
        from repro_torch.train.loop import value_and_grad

        _, grads = value_and_grad(lambda p, b: t_lm.lm_loss(p, b, cfg), params, tokens)
        out["grads"] = tree_map(lambda g: g.numpy(), grads)
    return out


CASES = [("1x4", "gemma"), ("1x4", "gemma_bf16"), ("1x4", "moonshot"), ("2x2", "gemma"), ("2x2", "granite"),
         ("2x2", "gemma_long"), ("2x2", "moonshot")]


@pytest.mark.parametrize("grid_name,case_name", CASES)
def test_sharded_lm_matches_the_reference(runs, grid_name, case_name):
    grid, case = GRIDS[grid_name], runs["lm"][grid_name][case_name]
    results = [r[case_name] for r in runs["out"][grid_name]]
    ref, own = _reference_of(grid_name, case_name), _unsharded_port(case)
    tol = BF16_TOL if case.get("dtype") == torch.bfloat16 else LM_TOL
    cfg = case["cfg"]
    cshape = (cfg.n_layers, case["decode"]["tokens"].shape[0], SMAX, cfg.n_kv_heads, cfg.attn.head_dim) \
        if "decode" in case else None
    if cshape:
        batch_cut = results[0]["cache_spec"][1] is not None
        want = sh.cache_spec(cfg, dataclasses.replace(_shape(cshape), global_batch=cshape[1]), grid)
        assert results[0]["cache_spec"] == want
        assert {"1x4/gemma": want[2] == "model", "2x2/gemma": want[3] == "model",
                "2x2/granite": want[2] == "model", "2x2/gemma_long": want[2] == ("data", "model"),
                }.get(f"{grid_name}/{case_name}", True)
        assert batch_cut == (case_name != "gemma_long")
        for r, res in enumerate(results):        # lm_init_cache makes the rank's block
            block = sh.shard_slices(cshape, want, grid.coords(r))
            assert res["init_cache_shape"] == tuple(b.stop - b.start for b in block)
    for key in ("prefill", "decode", "multi_pos"):
        if key not in ref:
            continue
        got = _data_rows(results, grid, key) if key == "prefill" or results[0]["cache_spec"][1] is not None \
            else results[0][key]
        _close(got, ref[key], tol)
        if key in own:
            _close(got, own[key], SELF_TOL)
    if "grads" in ref:
        specs = sh.lm_param_specs(case["params"], cfg, grid)
        grads = _unshard(results, "grads", case["params"], specs, grid)
        # The reference's and the unsharded port's AdamW step on the gathered gradient: Adam's first step
        # divides each entry by its own magnitude, so the step is held on the same gradient, and the
        # gradient itself against jax.grad.
        params = tree_map(lambda a: torch.from_numpy(np.array(a)), case["params"])
        opt = adamw(ranks.LR)
        stepped = opt.update(tree_map(torch.from_numpy, grads), opt.init(params), params)[0]
        own_step = {"grads": _leaves(own["grads"]), "adamw": _leaves(tree_map(lambda t: t.numpy(), stepped))}
        jp, j_opt = jax.tree_util.tree_map(jnp.asarray, case["params"]), j_adamw(ranks.LR)
        ref_step = {"grads": ref["grads"],
                    "adamw": _np_tree(j_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), j_opt.init(jp), jp)[0])}
        for key in ("grads", "adamw"):
            whole = _leaves(_unshard(results, key, case["params"], specs, grid))
            for name, want in _leaves(ref_step[key]).items():
                _close(whole[name], want, LM_TOL)
                _close(whole[name], own_step[key][name], SELF_TOL)


def _shape(cache_shape):
    from repro_torch.configs.registry import ShapeSpec

    return ShapeSpec("decode", "decode", seq_len=cache_shape[2], global_batch=cache_shape[1])


@functools.cache
def _moe_reference(groups: int):
    """The reference layer's output, aux, gradients of Σ y·cotangent + aux,
    and its dropped pairs."""
    case = _moe_case(groups)
    j_cfg, cot = case["j_cfg"], jnp.asarray(case["cotangent"])
    jp, x = jax.tree_util.tree_map(jnp.asarray, case["params"]), jnp.asarray(case["x"])

    def objective(p, x):
        y, aux = j_moe.moe_apply(p, x, j_cfg)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(objective, argnums=(0, 1), has_aux=True))(jp, x)
    probs = jax.nn.softmax((x @ jp["router"]).astype(jnp.float32), -1)
    gates, idx = jax.lax.top_k(probs, 2)
    G, T = groups, MOE_T
    _, meta = jax.vmap(lambda a, b, c: j_moe._dispatch(a, b, c, 8, 2, j_cfg.capacity(T // G)))(
        x.reshape(G, T // G, -1), gates.reshape(G, T // G, 2), idx.reshape(G, T // G, 2))
    return y, aux, gp, gx, int((~np.asarray(meta[3])).sum())


@pytest.mark.parametrize("grid_name,case_name", [("1x4", "moe_g1"), ("2x2", "moe_g1"), ("2x2", "moe_g2")])
def test_expert_parallel_moe_matches_the_reference(runs, grid_name, case_name):
    grid, case = GRIDS[grid_name], runs["moe"][grid_name][case_name]
    results = [r[case_name] for r in runs["out"][grid_name]]
    y, aux, gp, gx, want_dropped = _moe_reference(case["j_cfg"].groups)
    assert want_dropped > 0
    assert all(r["dropped"] == want_dropped for r in results)
    _close(_data_rows(results, grid, "y"), y, LM_TOL)
    _close(_data_rows(results, grid, "dx"), gx, LM_TOL)
    assert all(r["aux"] == pytest.approx(float(aux), rel=LM_TOL) for r in results)
    n_model, n_data = grid.shape["model"], grid.size // grid.shape["model"]
    for name, want in gp.items():
        per_model = [sum(results[d * n_model + m]["grads"][name] for d in range(n_data)) for m in range(n_model)]
        got = per_model[0] if name == "router" else np.concatenate(per_model, axis=0)
        _close(got, want, LM_TOL)


def test_heads_that_do_not_split_are_refused():
    """granite's 6 query heads over a model size of 4, and an expert count
    that does not divide, raise; a halo policy is refused (the GCN's)."""
    from repro_torch.dist.policy import ShardingPolicy

    cfg = t_granite.REDUCED
    with pytest.raises(NotImplementedError, match="query heads"):
        t_attn.local_heads(cfg.attn, sh.lm_policy(GRIDS["1x4"], cfg))
    policy = sh.lm_policy(Grid(("data", "model"), (1, 16)), t_moonshot.REDUCED)
    with pytest.raises(NotImplementedError, match="experts"):
        t_moe.moe_apply({"router": torch.zeros(64, 8)}, torch.zeros(4, 64), t_moonshot.REDUCED.moe_cfg(), policy)
    with pytest.raises(NotImplementedError, match="halo"):
        t_lm.lm_prefill({}, torch.zeros(1, 2, dtype=torch.long), cfg, ShardingPolicy(comm="halo"))
