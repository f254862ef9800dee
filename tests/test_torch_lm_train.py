"""The port's LM training slice against the JAX package's, on the CPU.

Same numpy inputs into both packages; the parameters are the reference's
`lm_init`, carried across with `params_from_numpy`. The reference
differentiates `_chunked_attention`; the port's attention is K4's plain
version on CPU tensors with `flash_attention_vjp` behind it, the backward
the card runs behind K4.

* K4's backward (`ops.flash_attention` under autograd, i.e.
  `flash_attention_vjp`) against `jax.vjp` of `_chunked_attention` with
  ``kv_chunk`` 16, so that the JAX side chunks: 2e-5 of each gradient's
  largest |g| (the reference suite's kernel tolerance), H = 4 over Hk = 2
  and over Hk = 1, the global window and 8, S = 24 and 37; and against
  autograd through `flash_attention_plain` at the same tolerance, also with
  window 0, the bidirectional mask and the score blocks forced small;
* `lm_loss` against the reference's at 2e-4 (tests/test_models.py's LM
  tolerance), and its gradients against ``jax.grad`` of the reference's,
  leaf by leaf, at 2e-4 of the leaf's largest |g|: the "dense", "slide" and
  "moe" configs of tests/test_models.py and the REDUCED gemma3, granite
  (MQA), stablelm, olmoe and moonshot configs;
* the twin of tests/test_models.py::test_lm_loss_decreases, and five Adam
  steps whose losses track the reference's jitted steps within 2e-4;
* ``remat=True`` gives the loss and gradients of ``remat=False``;
* `launch.train --arch {gemma3-12b, olmoe-1b-7b} --device cpu --steps 3`
  prints the reference CLI's line.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_12b as j_gemma
from repro.configs import granite_34b as j_granite
from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.configs import olmoe_1b_7b as j_olmoe
from repro.configs import stablelm_12b as j_stablelm
from repro.models import transformer_lm as j_lm
from repro.nn.attention import _chunked_attention
from repro.train import optimizer as j_opt
from repro_torch.configs import gemma3_12b as t_gemma
from repro_torch.configs import granite_34b as t_granite
from repro_torch.configs import moonshot_v1_16b_a3b as t_moonshot
from repro_torch.configs import olmoe_1b_7b as t_olmoe
from repro_torch.configs import stablelm_12b as t_stablelm
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import ops
from repro_torch.models import transformer_lm as t_lm
from repro_torch.train import optimizer as t_opt
from repro_torch.train.loop import value_and_grad

VJP_TOL = 2e-5
LM_TOL = 2e-4
KEY = jax.random.PRNGKey(0)
GLOBAL = 2 ** 30


def _pair(*args, **kw):
    return j_lm.LMConfig(*args, **kw), t_lm.LMConfig(*args, **kw)


# name → (reference config, port config); the first three are tests/test_models.py's.
CONFIGS = {
    "dense": _pair("d", 3, 32, 4, 2, 64, 101),
    "slide": _pair("s", 6, 32, 4, 2, 64, 53, window=8, global_every=6),
    "moe": _pair("m", 2, 32, 4, 4, 48, 67, moe_experts=4, moe_top_k=2),
    "gemma3-12b": (j_gemma.REDUCED, t_gemma.REDUCED),
    "granite-34b": (j_granite.REDUCED, t_granite.REDUCED),
    "stablelm-12b": (j_stablelm.REDUCED, t_stablelm.REDUCED),
    "olmoe-1b-7b": (j_olmoe.REDUCED, t_olmoe.REDUCED),
    "moonshot-v1-16b-a3b": (j_moonshot.REDUCED, t_moonshot.REDUCED),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_errors(t_tree, j_tree) -> dict:
    """path → (max |port − reference|, max |reference|) over every leaf."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(j_tree)[0]:
        got = t_tree
        for key in path:
            got = got[key.key]
        ref = np.asarray(leaf)
        assert tuple(got.shape) == ref.shape, path
        out[jax.tree_util.keystr(path)] = (float(np.abs(got.detach().numpy() - ref).max()), float(np.abs(ref).max()))
    return out


# ------------------------------------------------------------ K4's backward
def _attn_inputs(H, Hk, S, seed, B=2, d=16):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, S, H, d)).astype(np.float32)
    k, v = (r.standard_normal((B, S, Hk, d)).astype(np.float32) for _ in range(2))
    g = r.standard_normal((B, S, H, d)).astype(np.float32)
    return q, k, v, g


def _heads(a: np.ndarray) -> torch.Tensor:
    """(B, S, h, d) → the kernel's (B·h, S, d), requiring a gradient."""
    B, S, h, d = a.shape
    return torch.from_numpy(a).transpose(1, 2).reshape(B * h, S, d).contiguous().requires_grad_(True)


def _unheads(t: torch.Tensor, B: int, h: int) -> np.ndarray:
    S, d = t.shape[1:]
    return t.reshape(B, h, S, d).transpose(1, 2).numpy()


@pytest.mark.parametrize("S", [24, 37])
@pytest.mark.parametrize("window", [GLOBAL, 8], ids=["global", "window8"])
@pytest.mark.parametrize("Hk", [2, 1])
def test_k4_backward_matches_jax_vjp_of_chunked_attention(Hk, window, S):
    H, B = 4, 2
    q, k, v, g = _attn_inputs(H, Hk, S, seed=S + Hk)
    f = lambda q, k, v: _chunked_attention(q, k, v, jnp.arange(S), window, 16)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (_heads(a) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), _heads(g).detach())
    for name, got, h, want in zip("qkv", grads, (H, Hk, Hk), ref):
        want = np.asarray(want)
        err = float(np.abs(_unheads(got, B, h) - want).max())
        assert err <= VJP_TOL * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("case", ["gqa_window", "mqa_global", "window0", "bidirectional", "small_blocks"])
def test_k4_backward_matches_autograd_through_the_plain_version(case, monkeypatch):
    """`flash_attention_vjp` (through the Function) against autograd of
    `flash_attention_plain`; a row with no valid key (window 0) averages v,
    and its gradient reaches v only; ``small_blocks`` forces score blocks of
    a few rows so that the head and row blocking both run."""
    H, Hk, S, window, causal = {
        "gqa_window": (4, 2, 37, 8, True), "mqa_global": (4, 1, 37, GLOBAL, True),
        "window0": (4, 2, 24, 0, True), "bidirectional": (4, 2, 37, 8, False),
        "small_blocks": (4, 2, 37, 8, True)}[case]
    if case == "small_blocks":
        monkeypatch.setattr(k4, "VJP_SCORE_BYTES", 4 * 2 * 5 * 37)     # one kv head, 5 rows a block
    q, k, v, g = _attn_inputs(H, Hk, S, seed=7)
    tq, tk, tv = (_heads(a) for a in (q, k, v))
    tg = _heads(g).detach()
    got = torch.autograd.grad(ops.flash_attention(tq, tk, tv, window=window, causal=causal), (tq, tk, tv), tg)
    want = torch.autograd.grad(k4.flash_attention_plain(tq, tk, tv, window=window, causal=causal), (tq, tk, tv), tg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a - b).abs().max()) <= VJP_TOL * max(float(b.abs().max()), 1e-30)
    if case == "window0":
        assert float(got[0].abs().max()) == 0.0 and float(got[1].abs().max()) == 0.0
        assert float(got[2].abs().max()) > 0.0


def test_k4_backward_returns_each_gradient_in_its_dtype():
    q, k, v, g = _attn_inputs(4, 2, 24, seed=3)
    tq, tk, tv = (_heads(a).detach().bfloat16().requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=8)
    grads = torch.autograd.grad(out, (tq, tk, tv), _heads(g).detach().bfloat16())
    assert all(t.dtype == torch.bfloat16 and torch.isfinite(t).all() for t in grads)


# ------------------------------------------------------------------ lm_loss
@pytest.fixture(scope="module", params=list(CONFIGS))
def lm(request):
    j_cfg, t_cfg = CONFIGS[request.param]
    j_params = j_lm.lm_init(KEY, j_cfg)
    tokens = np.random.default_rng(1).integers(0, j_cfg.vocab, (2, 13)).astype(np.int32)
    return dict(name=request.param, j_cfg=j_cfg, t_cfg=t_cfg, j_params=j_params, tokens=tokens,
                t_params=t_lm.params_from_numpy(_numpy_tree(j_params), "cpu"))


def test_lm_loss_and_gradients_match_jax(lm):
    j_loss, j_grads = jax.jit(jax.value_and_grad(j_lm.lm_loss), static_argnums=2)(
        lm["j_params"], jnp.asarray(lm["tokens"]), lm["j_cfg"])
    tokens = torch.from_numpy(lm["tokens"])
    loss, grads = value_and_grad(lambda p, b: t_lm.lm_loss(p, b, lm["t_cfg"]), lm["t_params"], tokens)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LM_TOL, atol=LM_TOL)
    errs = _leaf_errors(grads, j_grads)
    assert len(errs) == len(jax.tree_util.tree_leaves(j_grads))
    if lm["t_cfg"].is_moe:
        assert "['layers']['moe']['router']" in errs and errs["['layers']['moe']['router']"][1] > 0
    bad = {path: e for path, e in errs.items() if e[0] > LM_TOL * e[1]}
    assert not bad, bad


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_remat_gives_the_same_loss_and_gradients(name):
    j_cfg, cfg = CONFIGS[name]
    params = t_lm.params_from_numpy(_numpy_tree(j_lm.lm_init(KEY, j_cfg)), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 13)))
    runs = [value_and_grad(lambda p, b, c=c: t_lm.lm_loss(p, b, c), params, tokens)
            for c in (cfg, dataclasses.replace(cfg, remat=True))]
    (l0, g0), (l1, g1) = runs
    assert float(l0) == pytest.approx(float(l1), rel=1e-6, abs=1e-6)
    j_like = jax.tree_util.tree_map(lambda t: t.numpy(), g0)
    for path, (err, scale) in _leaf_errors(g1, j_like).items():
        assert err <= 1e-6 * max(scale, 1e-30), path


def test_lm_loss_decreases():
    """tests/test_models.py::test_lm_loss_decreases in the port: 30 Adam
    steps on one batch cut the loss below 0.8 of its first value."""
    j_cfg, cfg = _pair("t", 2, 32, 4, 2, 64, 64)
    params = t_lm.params_from_numpy(_numpy_tree(j_lm.lm_init(KEY, j_cfg)), "cpu")
    toks = torch.from_numpy(np.asarray(jax.random.randint(KEY, (4, 24), 0, cfg.vocab)))
    opt = t_opt.adam(5e-3)
    state = opt.init(params)
    first = float(t_lm.lm_loss(params, toks, cfg))
    for _ in range(30):
        loss, grads = value_and_grad(lambda p, b: t_lm.lm_loss(p, b, cfg), params, toks)
        with torch.no_grad():
            params, state = opt.update(grads, state, params)
    assert float(loss) < first * 0.8


@pytest.mark.parametrize("name", ["slide", "olmoe-1b-7b"])
def test_adam_steps_track_the_reference(name):
    """Five Adam steps (lr 5e-3) from the same parameters on the same batch:
    every loss within 2e-4 of the reference's jitted step's."""
    j_cfg, cfg = CONFIGS[name]
    j_params = j_lm.lm_init(KEY, j_cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    j_o, t_o = j_opt.adam(5e-3), t_opt.adam(5e-3)
    j_state = j_o.init(j_params)
    j_step = jax.jit(lambda p, s, b: (lambda l, g: j_o.update(g, s, p) + (l,))(
        *jax.value_and_grad(j_lm.lm_loss)(p, b, j_cfg)))
    params = t_lm.params_from_numpy(_numpy_tree(j_params), "cpu")
    state = t_o.init(params)
    j_losses, t_losses = [], []
    for _ in range(5):
        j_params, j_state, j_loss = j_step(j_params, j_state, jnp.asarray(tokens))
        loss, grads = value_and_grad(lambda p, b: t_lm.lm_loss(p, b, cfg), params, torch.from_numpy(tokens))
        with torch.no_grad():
            params, state = t_o.update(grads, state, params)
        j_losses.append(float(j_loss))
        t_losses.append(float(loss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LM_TOL, atol=LM_TOL)
    assert t_losses[-1] < t_losses[0]


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["gemma3-12b", "olmoe-1b-7b"])
def test_launch_train_lm_cpu(arch, capsys):
    from repro_torch.launch import train

    train.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    head, _, tail = out.partition(": loss ")
    first, _, rest = tail.partition(" → ")
    last, _, steps = rest.partition(" over ")
    assert head == arch and steps == "3 steps"
    assert np.isfinite(float(first)) and np.isfinite(float(last))
