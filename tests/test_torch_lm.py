"""The port's LM serving slice against the JAX package's, on the CPU.

Same numpy inputs into both packages; the parameters are the reference's
`lm_init`, carried across with `params_from_numpy`. On CPU tensors the
port's attention runs K4's plain version where the reference runs
`_chunked_attention`.

* `rope`, `attention_apply` (GQA, H = 4 over Hk = 2, global and sliding
  window) and `attention_decode` within 3e-5 (the reference suite's
  kernel-vs-model-attention tolerance);
* `lm_forward`, `lm_prefill` and `lm_decode_step` within 2e-4 of the
  reference (tests/test_models.py's decode-vs-forward tolerance) for the
  "dense" and "slide" configs of tests/test_models.py and the REDUCED
  gemma3, stablelm and granite (MQA) configs, and the port's decode
  against its own forward at 2e-4;
* `ContinuousBatcher`: twins of tests/test_data_serve.py's three batcher
  tests and tests/test_planner_scheduler.py's overflow guard, its per-slot
  step against the reference's `decode_multi_pos`, and its greedy tokens
  equal to the reference batcher's on the same weights;
* the configs, `lm_shapes`, `window_sizes`, `param_count` and the
  registry; the launchers `launch.serve --arch gemma3-12b` and
  `launch.serve_lm`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_12b as j_gemma
from repro.configs import granite_34b as j_granite
from repro.configs import registry as j_registry
from repro.configs import stablelm_12b as j_stablelm
from repro.models import transformer_lm as j_lm
from repro.nn import attention as j_attn
from repro.serve import scheduler as j_sched
from repro_torch.configs import gemma3_12b as t_gemma
from repro_torch.configs import granite_34b as t_granite
from repro_torch.configs import registry as t_registry
from repro_torch.configs import stablelm_12b as t_stablelm
from repro_torch.kernels import flash_attention as k4
from repro_torch.models import transformer_lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.serve.scheduler import ContinuousBatcher, Request, decode_multi_pos

ATTN_TOL = 3e-5
LM_TOL = 2e-4
KEY = jax.random.PRNGKey(0)

# name → (reference config, port config); the first two are tests/test_models.py's.
CONFIGS = {
    "dense": (j_lm.LMConfig("d", 3, 32, 4, 2, 64, 101), t_lm.LMConfig("d", 3, 32, 4, 2, 64, 101)),
    "slide": (j_lm.LMConfig("s", 6, 32, 4, 2, 64, 53, window=8, global_every=6),
              t_lm.LMConfig("s", 6, 32, 4, 2, 64, 53, window=8, global_every=6)),
    "gemma3-12b": (j_gemma.REDUCED, t_gemma.REDUCED),
    "stablelm-12b": (j_stablelm.REDUCED, t_stablelm.REDUCED),
    "granite-34b": (j_granite.REDUCED, t_granite.REDUCED),
}


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol, atol=tol)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def lm(request):
    j_cfg, t_cfg = CONFIGS[request.param]
    j_params = j_lm.lm_init(KEY, j_cfg)
    tokens = np.random.default_rng(1).integers(0, j_cfg.vocab, (2, 12)).astype(np.int32)
    return dict(name=request.param, j_cfg=j_cfg, t_cfg=t_cfg, j_params=j_params, tokens=tokens,
                t_params=t_lm.params_from_numpy(_numpy_tree(j_params), "cpu"))


# ------------------------------------------------------------------ attention
def _attn_case(seed=0, B=2, S=24, d_model=32, H=4, Hk=2):
    cfg_j = j_attn.AttentionConfig(d_model, H, Hk)
    cfg_t = t_attn.AttentionConfig(d_model, H, Hk)
    p = _numpy_tree(j_attn.attention_init(jax.random.PRNGKey(seed), cfg_j))
    x = np.random.default_rng(seed).standard_normal((B, S, d_model)).astype(np.float32)
    return cfg_j, cfg_t, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}, x


def test_rope_matches():
    x = np.random.default_rng(0).standard_normal((2, 10, 3, 16)).astype(np.float32)
    pos = np.arange(10)
    _close(t_attn.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           j_attn.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-6)


def test_attention_init_has_the_reference_shapes_and_scale():
    cfg_j, cfg_t, p, _, _ = _attn_case(d_model=256, H=8, Hk=2)
    ours = t_attn.attention_init(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in p.items()}
    for k, v in ours.items():
        assert abs(float(v.std()) - (1.0 / 256) ** 0.5) < 0.1 * (1.0 / 256) ** 0.5, k


@pytest.mark.parametrize("window", [None, 5, 1])
def test_attention_apply_matches_jax(window):
    """GQA (H = 4 over Hk = 2): K4's plain version against the reference's
    `_chunked_attention`-based `attention_apply`."""
    cfg_j, cfg_t, p, p_t, x = _attn_case()
    out = t_attn.attention_apply(p_t, torch.from_numpy(x), cfg_t, window=window)
    _close(out, j_attn.attention_apply(p, jnp.asarray(x), cfg_j, window=window), ATTN_TOL)


def test_attention_apply_takes_index_positions_only():
    _, cfg_t, _, p_t, x = _attn_case()
    t_attn.attention_apply(p_t, torch.from_numpy(x), cfg_t, positions=torch.arange(24))
    with pytest.raises(NotImplementedError, match="arange"):
        t_attn.attention_apply(p_t, torch.from_numpy(x), cfg_t, positions=torch.arange(24) + 3)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_jax(window):
    cfg_j, cfg_t, p, p_t, x = _attn_case(seed=3)
    r = np.random.default_rng(4)
    cache = {n: r.standard_normal((2, 16, 2, 8)).astype(np.float32) for n in ("k", "v")}
    t_cache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    j_out, j_cache = j_attn.attention_decode(p, jnp.asarray(x[:, :1]), {n: jnp.asarray(c) for n, c in cache.items()},
                                             jnp.asarray(7, jnp.int32), cfg_j, window=window)
    out, new_cache = t_attn.attention_decode(p_t, torch.from_numpy(x[:, :1]), t_cache, 7, cfg_t, window=window)
    _close(out, j_out, ATTN_TOL)
    for n in ("k", "v"):
        assert new_cache[n] is t_cache[n]                  # written in place
        _close(new_cache[n], j_cache[n], 1e-6)


# ------------------------------------------------------------------------ LM
def test_lm_init_has_the_reference_tree(lm):
    t_params = t_lm.lm_init(torch.Generator().manual_seed(0), lm["t_cfg"], device="cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(lm["j_params"])[0]
    assert len(j_leaves) == sum(1 for _ in _leaves(t_params))
    for path, leaf in j_leaves:
        got = t_params
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == leaf.shape and got.dtype == torch.float32


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_lm_forward_and_prefill_match_jax(lm):
    tokens = torch.from_numpy(lm["tokens"])
    logits, aux = t_lm.lm_forward(lm["t_params"], tokens, lm["t_cfg"])
    j_logits, _ = j_lm.lm_forward(lm["j_params"], jnp.asarray(lm["tokens"]), lm["j_cfg"])
    assert logits.shape == (2, 12, lm["t_cfg"].vocab) and float(aux) == 0.0
    _close(logits, j_logits, LM_TOL)
    prefill = t_lm.lm_prefill(lm["t_params"], tokens, lm["t_cfg"])
    _close(prefill, j_lm.lm_prefill(lm["j_params"], jnp.asarray(lm["tokens"]), lm["j_cfg"]), LM_TOL)
    _close(prefill, logits[:, -1], 1e-5)


def test_lm_decode_matches_jax_and_forward(lm):
    """Twelve teacher-forced decode steps: each step's logits against the
    reference's `lm_decode_step`, and all of them against the port's own
    forward (tests/test_models.py::test_lm_decode_matches_forward)."""
    cfg_t, cfg_j = lm["t_cfg"], lm["j_cfg"]
    cache = t_lm.lm_init_cache(cfg_t, 2, 16, device="cpu")
    j_cache = j_lm.lm_init_cache(cfg_j, 2, 16)
    outs = []
    for t in range(12):
        lg, cache = t_lm.lm_decode_step(lm["t_params"], cache, torch.from_numpy(lm["tokens"][:, t]), t, cfg_t)
        j_lg, j_cache = j_lm.lm_decode_step(lm["j_params"], j_cache, jnp.asarray(lm["tokens"][:, t]),
                                            jnp.asarray(t, jnp.int32), cfg_j)
        assert lg.dtype == torch.float32
        _close(lg, j_lg, LM_TOL)
        outs.append(lg)
    _close(cache["k"], j_cache["k"], 1e-5)
    pre, _ = t_lm.lm_forward(lm["t_params"], torch.from_numpy(lm["tokens"]), cfg_t)
    _close(torch.stack(outs, 1), pre, LM_TOL)


def test_lm_forward_can_take_the_plain_attention(lm):
    """The `kernel` argument chip_smoke.py uses to hold K4 against its plain
    version: on the CPU both are the plain version."""
    tokens = torch.from_numpy(lm["tokens"])
    a = t_lm.lm_prefill(lm["t_params"], tokens, lm["t_cfg"])
    b = t_lm.lm_prefill(lm["t_params"], tokens, lm["t_cfg"], kernel=k4.flash_attention_plain)
    assert torch.equal(a, b)


def test_moe_and_policies_are_refused():
    """The MoE config runs (init, forward, loss and decode: the MoE slice
    lifted its refusal); a grid policy on one rank (the sharded LM's, 1 × 1:
    no group needed) computes what NO_POLICY does; only a halo policy (the
    GCN's) is still refused, by the LM and by `moe_apply`."""
    from repro_torch.dist.policy import ShardingPolicy
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.shardings import lm_policy
    from repro_torch.nn import moe as t_moe

    moe = t_lm.LMConfig("m", 2, 32, 4, 4, 48, 67, moe_experts=4, moe_top_k=2)
    p = t_lm.lm_init(torch.Generator().manual_seed(0), moe, device="cpu")
    assert tuple(p["layers"]["moe"]["w_down"].shape) == (2, 4, 48, 32) and "mlp" not in p["layers"]
    tokens = torch.zeros(1, 5, dtype=torch.long)
    logits, aux = t_lm.lm_forward(p, tokens[:, :4], moe)
    assert logits.shape == (1, 4, 67) and torch.isfinite(logits).all() and float(aux) > 0
    assert torch.isfinite(t_lm.lm_loss(p, tokens, moe))
    grid_policy = lm_policy(Grid(("data", "model"), (1, 1)), moe)
    assert torch.equal(t_lm.lm_forward(p, tokens[:, :4], moe, policy=grid_policy)[0], logits)
    with pytest.raises(NotImplementedError, match="halo policy"):
        t_lm.lm_forward(p, tokens, moe, policy=ShardingPolicy(comm="halo"))
    with pytest.raises(NotImplementedError, match="halo policy"):
        t_moe.moe_apply({k: v[0] for k, v in p["layers"]["moe"].items()}, torch.zeros(4, 32), moe.moe_cfg(),
                        policy=ShardingPolicy(comm="halo"))
    dense = CONFIGS["dense"][1]
    p = t_lm.lm_init(torch.Generator().manual_seed(0), dense, device="cpu")
    with pytest.raises(NotImplementedError, match="halo policy"):
        t_lm.lm_forward(p, torch.zeros(1, 4, dtype=torch.long), dense, policy=ShardingPolicy(comm="halo"))
    assert torch.equal(t_lm.lm_loss(p, tokens, dense, policy=lm_policy(Grid(("data", "model"), (1, 1)), dense)),
                       t_lm.lm_loss(p, tokens, dense))


# ------------------------------------------------------------------ batcher
def _tiny_lm():
    """tests/test_data_serve.py's tiny LM: the reference's parameters, both
    packages' configs."""
    j_cfg = j_lm.LMConfig("tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=101)
    t_cfg = t_lm.LMConfig("tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=101)
    j_params = j_lm.lm_init(jax.random.PRNGKey(0), j_cfg)
    return j_cfg, t_cfg, j_params, t_lm.params_from_numpy(_numpy_tree(j_params), "cpu")


def test_continuous_batcher_matches_sequential_decode():
    """Continuous batching produces exactly the tokens a one-request-at-a-
    time greedy decode produces (slot interleaving must not change math)."""
    _, cfg, _, params = _tiny_lm()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=p).astype(np.int32) for p in (3, 5, 4, 6, 2)]

    def reference(prompt, n_new):
        cache = t_lm.lm_init_cache(cfg, 1, 32, device="cpu")
        tok, out = None, []
        with torch.inference_mode():
            for t in range(len(prompt) + n_new - 1):
                feed = prompt[t] if t < len(prompt) else tok
                logits, cache = t_lm.lm_decode_step(params, cache, torch.tensor([int(feed)]), t, cfg)
                if t >= len(prompt) - 1:
                    tok = int(np.argmax(logits.numpy()[0]))
                    out.append(tok)
        return out

    n_new = 4
    refs = [reference(p, n_new) for p in prompts]
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=32)
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, prompt=p, max_new_tokens=n_new))
    finished = cb.run_until_drained()
    assert len(finished) == len(prompts)
    by_rid = {r.rid: r.generated for r in finished}
    for i, ref in enumerate(refs):
        assert by_rid[i] == ref, (i, by_rid[i], ref)


def test_batcher_eos_first_decode_step_retires_and_readmits():
    """A request whose very first decode step emits EOS retires in that same
    step(), and the freed slot is refilled from the pending queue within the
    same step()."""
    _, cfg, _, params = _tiny_lm()
    probe = ContinuousBatcher(params, cfg, n_slots=1, max_len=16)
    probe.submit(Request(rid=0, prompt=np.asarray([7], np.int32), max_new_tokens=2))
    probe.run_until_drained()
    eos = probe.finished[0].generated[0]

    cb = ContinuousBatcher(params, cfg, n_slots=1, max_len=16)
    cb.submit(Request(rid=0, prompt=np.asarray([7], np.int32), max_new_tokens=4, eos_id=eos))
    cb.submit(Request(rid=1, prompt=np.asarray([1, 2], np.int32), max_new_tokens=2))
    cb.step()
    assert [r.rid for r in cb.finished] == [0]
    assert cb.finished[0].generated == [eos]
    assert cb.active == 1, "freed slot must be re-admitted in the same step()"
    assert cb.slot_req[0].rid == 1 and not cb.pending
    cb.run_until_drained()
    assert len(cb.finished) == 2 and len(cb.finished[1].generated) == 2

    cb2 = ContinuousBatcher(params, cfg, n_slots=1, max_len=16)
    cb2.submit(Request(rid=0, prompt=np.asarray([3, 7], np.int32), max_new_tokens=4, eos_id=None))
    cb2.step()
    first = None
    while cb2.active and first is None:
        cb2.step()
        if cb2.finished or (cb2.slot_req[0] and cb2.slot_req[0].generated):
            first = (cb2.finished or [cb2.slot_req[0]])[0].generated[0]
    cb3 = ContinuousBatcher(params, cfg, n_slots=1, max_len=16)
    cb3.submit(Request(rid=0, prompt=np.asarray([3, 7], np.int32), max_new_tokens=4, eos_id=first))
    cb3.step()
    assert not cb3.finished
    cb3.step()
    assert [r.rid for r in cb3.finished] == [0]
    assert cb3.finished[0].generated == [first]


def test_batcher_slot_turnover_and_capacity():
    _, cfg, _, params = _tiny_lm()
    cb = ContinuousBatcher(params, cfg, n_slots=3, max_len=16)
    for i in range(7):
        cb.submit(Request(rid=i, prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=3))
    finished = cb.run_until_drained()
    assert len(finished) == 7
    assert all(len(r.generated) == 3 for r in finished)
    assert cb.active == 0 and not cb.pending


def test_scheduler_eos_and_overflow_guard():
    """tests/test_planner_scheduler.py::test_scheduler_eos_and_overflow_guard."""
    j_cfg = j_lm.LMConfig("tiny", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32, vocab=11)
    cfg = t_lm.LMConfig("tiny", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32, vocab=11)
    params = t_lm.params_from_numpy(_numpy_tree(j_lm.lm_init(jax.random.PRNGKey(0), j_cfg)), "cpu")
    cb = ContinuousBatcher(params, cfg, n_slots=2, max_len=12)
    cb.submit(Request(rid=0, prompt=np.asarray([1, 2], np.int32), max_new_tokens=8,
                      eos_id=int(np.argmax(np.zeros(1)))))
    finished = cb.run_until_drained()
    assert len(finished) == 1 and finished[0].done
    with pytest.raises(AssertionError):
        cb.submit(Request(rid=1, prompt=np.zeros(10, np.int32), max_new_tokens=8))


def test_batcher_retires_at_the_cache_bound():
    """`pos + 2 > max_len`: a request may fill the cache to its last row."""
    _, cfg, _, params = _tiny_lm()
    cb = ContinuousBatcher(params, cfg, n_slots=1, max_len=6)
    cb.submit(Request(rid=0, prompt=np.asarray([1, 2], np.int32), max_new_tokens=4))
    (req,) = cb.run_until_drained()
    assert len(req.generated) == 4 and cb.steps_run == 5


def test_decode_multi_pos_matches_jax():
    """One per-slot step at positions 0, 3 and 5 over a cache filled with
    random rows: logits and the updated cache against the reference's."""
    j_cfg, cfg, j_params, params = _tiny_lm()
    r = np.random.default_rng(2)
    cache = {n: r.standard_normal((2, 3, 8, 2, 8)).astype(np.float32) for n in ("k", "v")}
    tokens, positions = np.asarray([5, 17, 99], np.int32), np.asarray([0, 3, 5], np.int32)
    j_logits, j_cache = j_sched.decode_multi_pos(j_params, {n: jnp.asarray(c) for n, c in cache.items()},
                                                 jnp.asarray(tokens), jnp.asarray(positions), j_cfg)
    t_cache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    logits, t_cache = decode_multi_pos(params, t_cache, torch.from_numpy(tokens), torch.from_numpy(positions), cfg)
    _close(logits, j_logits, LM_TOL)
    for n in ("k", "v"):
        _close(t_cache[n], j_cache[n], 1e-6)


@pytest.mark.parametrize("name", ["slide", "granite-34b"])
def test_batcher_tokens_equal_the_reference_batcher(name):
    """The same requests through both packages' batchers on the same
    weights: the same greedy tokens, request by request."""
    j_cfg, t_cfg = CONFIGS[name]
    j_params = j_lm.lm_init(jax.random.PRNGKey(1), j_cfg)
    params = t_lm.params_from_numpy(_numpy_tree(j_params), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, j_cfg.vocab, size=p).astype(np.int32) for p in (4, 9, 2, 6, 11)]
    out = {}
    for tag, cb in (("jax", j_sched.ContinuousBatcher(j_params, j_cfg, n_slots=2, max_len=24)),
                    ("torch", ContinuousBatcher(params, t_cfg, n_slots=2, max_len=24))):
        for i, p in enumerate(prompts):
            cb.submit((j_sched.Request if tag == "jax" else Request)(rid=i, prompt=p, max_new_tokens=6))
        out[tag] = {r.rid: r.generated for r in cb.run_until_drained()}
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("j_mod,t_mod", [(j_gemma, t_gemma), (j_stablelm, t_stablelm), (j_granite, t_granite)],
                         ids=["gemma3-12b", "stablelm-12b", "granite-34b"])
def test_configs_equal_the_reference(j_mod, t_mod):
    for which in ("FULL", "REDUCED"):
        j_cfg, t_cfg = getattr(j_mod, which), getattr(t_mod, which)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        np.testing.assert_array_equal(t_cfg.window_sizes(), j_cfg.window_sizes())
        assert t_cfg.param_count() == j_cfg.param_count()
        assert t_cfg.active_param_count() == j_cfg.active_param_count()
        assert t_cfg.attn.head_dim == j_cfg.attn.head_dim and t_cfg.sub_quadratic == j_cfg.sub_quadratic
    spec_j, spec_t = j_mod.SPEC, t_mod.SPEC
    assert (spec_t.arch_id, spec_t.family, spec_t.source) == (spec_j.arch_id, spec_j.family, spec_j.source)
    assert {k: dataclasses.asdict(v) for k, v in spec_t.shapes.items()} == {
        k: {f: getattr(v, f) for f in dataclasses.asdict(spec_t.shapes[k])} for k, v in spec_j.shapes.items()}
    assert t_registry.get_arch(spec_j.arch_id) is spec_t


def test_gemma3_full_config():
    """48 layers, 5 local (window 1,024) : 1 global, head width 240,
    11,623,837,440 parameters (46.5 GB in fp32)."""
    cfg = t_gemma.FULL
    ws = cfg.window_sizes()
    assert list(np.flatnonzero(ws > 10_000)) == [5, 11, 17, 23, 29, 35, 41, 47]
    assert np.all(ws[ws < 10_000] == 1024)
    assert cfg.attn.head_dim == 240 and cfg.attn.q_groups == 2
    assert cfg.param_count() == 11_623_837_440 and round(4 * cfg.param_count() / 1e9, 1) == 46.5


def test_registry_names_the_moe_slice():
    """The MoE ids resolve to the port's configs, equal to the reference's
    field for field (FULL and REDUCED), with the same source and shapes."""
    from repro.configs import moonshot_v1_16b_a3b as j_moonshot, olmoe_1b_7b as j_olmoe
    from repro_torch.configs import moonshot_v1_16b_a3b as t_moonshot, olmoe_1b_7b as t_olmoe

    for j_mod, t_mod in ((j_moonshot, t_moonshot), (j_olmoe, t_olmoe)):
        for which in ("FULL", "REDUCED"):
            j_cfg, t_cfg = getattr(j_mod, which), getattr(t_mod, which)
            assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
            assert t_cfg.param_count() == j_cfg.param_count()
            assert t_cfg.active_param_count() == j_cfg.active_param_count()
            assert dataclasses.asdict(t_cfg.moe_cfg()) == dataclasses.asdict(j_cfg.moe_cfg())
        spec_j, spec_t = j_mod.SPEC, t_mod.SPEC
        assert (spec_t.arch_id, spec_t.family, spec_t.source) == (spec_j.arch_id, spec_j.family, spec_j.source)
        assert {k: dataclasses.asdict(v) for k, v in spec_t.shapes.items()} == {
            k: {f: getattr(v, f) for f in dataclasses.asdict(spec_t.shapes[k])} for k, v in spec_j.shapes.items()}
        assert t_registry.get_arch(spec_j.arch_id) is spec_t
    assert t_olmoe.FULL.param_count() == 6_816_073_728           # 27.3 GB in fp32: one card serves it
    assert t_registry.lm_shapes(True)["long_500k"].skip_reason is None
    assert t_registry.lm_shapes(False)["long_500k"].skip_reason == j_registry.lm_shapes(False)["long_500k"].skip_reason


# --------------------------------------------------------------- launchers
@pytest.mark.parametrize("arch", ["gemma3-12b", "stablelm-12b", "granite-34b"])
def test_launch_serve_lm_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--tokens", "4"])
    out = capsys.readouterr().out
    assert out.startswith(f"{arch}: 4×4 tokens in ") and "tok/s" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "moonshot-v1-16b-a3b"])
def test_launch_serve_moe_names_its_slice(arch, capsys):
    """The MoE ids serve through `serve_lm` as the dense ones do."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--tokens", "4"])
    out = capsys.readouterr().out
    assert out.startswith(f"{arch}: 4×4 tokens in ") and "tok/s" in out


def test_serve_lm_example_twin(capsys):
    """The twin of examples/serve_lm.py: the teacher-forced decode agrees
    with the forward (K4's plain version here) and greedy decode runs."""
    from repro_torch.launch import serve_lm

    err = serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert err < LM_TOL
    assert "decode-vs-forward max err" in out and "generated 16 tokens × 4 streams" in out
