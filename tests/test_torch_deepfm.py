"""The port's DeepFM slice against the JAX package's, on the CPU.

Same numpy inputs into both packages, at the reduced DeepFM config (8
fields, embed_dim 10, MLP 32-32-32, 1,000 rows per field); the parameters
are the reference's `deepfm_init`, carried across with `params_from_numpy`.
The full config's 39 M-row table (1.56 GB) is never built here.

* `hash_ids` bit for bit (ids near 2³², negative ids, salts > 1);
  `field_lookup` and `embedding_bag` within 1e-6;
* `fm_interaction` (the plain version of K3 on CPU tensors) against the
  reference's `repro.kernels.ops.fm_interaction` (Pallas in interpret mode)
  at the reference suite's tolerances: 1e-4 against the oracle, 1e-3
  against the pairwise form, 2e-4 in the hypothesis cases; its gradient by
  `gradcheck` and against JAX's autodiff of the formula;
* `deepfm_forward` and `deepfm_retrieval` within 1e-5 of the largest
  output; `deepfm_loss` and every gradient (the zero ones of
  `user_tower` / `item_proj` too) against ``jax.value_and_grad`` within
  1e-5 of each parameter's largest entry; a 5-step AdamW `Trainer` run on
  `click_batch_fn` batches against the reference's `Trainer`, 1e-5
  relative;
* the data pipeline (`ShardedStream`, `click_batch_fn`, `token_batch_fn`,
  `epoch_permutation`) array-equal; the layers of `nn/layers.py`; the
  config and registry; the launchers `launch.train --arch deepfm` and
  `launch.serve`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import deepfm as j_cfg
from repro.configs.registry import recsys_shapes as j_recsys_shapes
from repro.kernels import ops as j_kops
from repro.kernels import ref as j_kref
from repro.models import deepfm as j_fm
from repro.nn import layers as j_layers
from repro.recsys import embedding as j_emb
from repro.train import data as j_data
from repro.train import loop as j_loop
from repro.train import optimizer as j_opt
from repro_torch.configs import deepfm as t_cfg
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.fm_interaction import fm_interaction_plain
from repro_torch.kernels.ops import fm_interaction
from repro_torch.models import deepfm as t_fm
from repro_torch.nn import layers as t_layers
from repro_torch.recsys import embedding as t_emb
from repro_torch.train import data as t_data
from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
from repro_torch.train.optimizer import adamw

RNG = np.random.default_rng(0)
TRAIN_STEPS = 5


def _rel_close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def model():
    """The reduced config, the reference's parameters (numpy) and the port's
    copy of them, and one click batch."""
    cfg_j = j_cfg.SPEC.make_reduced()
    cfg_t = t_cfg.SPEC.make_reduced()
    params_np = jax.tree_util.tree_map(np.asarray, j_fm.deepfm_init(jax.random.PRNGKey(0), cfg_j))
    batch = j_data.ShardedStream(j_data.click_batch_fn(cfg_j.n_fields, cfg_j.rows_per_field),
                                 global_batch=256, seed=0).batch_at(0)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np, batch=batch,
                params_j=jax.tree_util.tree_map(jnp.asarray, params_np),
                params_t=t_fm.params_from_numpy(params_np, device="cpu"))


# ------------------------------------------------------------------ embeddings
@pytest.mark.parametrize("bucket", [1000, 1_000_003, 2**31 - 1])
@pytest.mark.parametrize("salt", [0, 1, 7, 123_456_789, 2**32 - 5])
def test_hash_ids_bit_for_bit(bucket, salt):
    raw = np.concatenate([RNG.integers(0, 2**32, 500, dtype=np.uint64),
                          [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]]).astype(np.uint32)
    want = np.asarray(j_emb.hash_ids(jnp.asarray(raw), bucket, salt))
    got = t_emb.hash_ids(torch.from_numpy(raw.astype(np.int64)), bucket, salt).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_hash_ids_per_field_salts_and_negative_ids():
    """(B, F) int32 ids, some negative (they wrap to uint32), with one salt
    per field broadcast along the batch."""
    raw = RNG.integers(-2**31, 2**31, (64, 6), dtype=np.int64).astype(np.int32)
    salts = np.array([0, 1, 2, 3, 977, 2**31 + 11], np.uint32)
    want = np.asarray(j_emb.hash_ids(jnp.asarray(raw), 1_000_000, jnp.asarray(salts)))
    got = t_emb.hash_ids(torch.from_numpy(raw), 1_000_000, torch.from_numpy(salts.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_field_lookup_matches_jax():
    table = RNG.standard_normal((5 * 40, 10)).astype(np.float32)
    ids = RNG.integers(0, 40, (33, 5)).astype(np.int32)
    offs = (np.arange(5) * 40).astype(np.int32)
    want = np.asarray(j_emb.field_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(offs)))
    got = t_emb.field_lookup(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(offs)).numpy()
    assert got.shape == (33, 5, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    """Ragged bags, one of them empty (zero in both modes)."""
    table = RNG.standard_normal((50, 8)).astype(np.float32)
    ids = RNG.integers(0, 50, 120).astype(np.int32)
    seg = np.sort(RNG.integers(0, 12, 120)).astype(np.int32)
    seg[seg == 5] = 6                                   # bag 5 is empty
    w = RNG.random(120).astype(np.float32) if weighted else None
    want = np.asarray(j_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 12,
                                          None if w is None else jnp.asarray(w), mode))
    got = t_emb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg), 12,
                              None if w is None else torch.from_numpy(w), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[5].any()


def test_embedding_bag_rejects_unknown_mode():
    with pytest.raises(ValueError):
        t_emb.embedding_bag(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32),
                            torch.zeros(3, dtype=torch.int32), 1, mode="max")


# -------------------------------------------------------------- fm_interaction
@pytest.mark.parametrize("b,f,d", [(32, 13, 10), (256, 39, 10), (64, 8, 16)])
def test_fm_matches_jax_kernel_ref_and_pairwise(b, f, d):
    emb = RNG.standard_normal((b, f, d)).astype(np.float32)
    out = fm_interaction(torch.from_numpy(emb)).numpy()
    kernel = np.asarray(j_kops.fm_interaction(jnp.asarray(emb)))        # Pallas, interpret mode
    ref = np.asarray(j_kref.fm_interaction_ref(jnp.asarray(emb)))
    np.testing.assert_allclose(out, kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    e = emb.astype(np.float64)
    pair = 0.5 * (np.einsum("bfd,bgd->b", e, e) - np.einsum("bfd,bfd->b", e, e))
    np.testing.assert_allclose(out, pair, rtol=1e-3, atol=1e-3)


@settings(max_examples=10, deadline=None)
@given(
    b=st.sampled_from([8, 64, 200]),
    f=st.integers(2, 40),
    d=st.sampled_from([4, 10, 32]),
    seed=st.integers(0, 99),
)
def test_fm_hypothesis(b, f, d, seed):
    r = np.random.default_rng(seed)
    emb = r.standard_normal((b, f, d)).astype(np.float32)
    np.testing.assert_allclose(
        fm_interaction(torch.from_numpy(emb)).numpy(), np.asarray(j_kops.fm_interaction(jnp.asarray(emb))),
        rtol=2e-4, atol=2e-4,
    )


def test_fm_bf16_matches_jax_ref():
    """bf16 embeddings: fp32 sums, the output rounded once to bf16."""
    emb = torch.from_numpy(RNG.standard_normal((48, 39, 10)).astype(np.float32)).to(torch.bfloat16)
    out = fm_interaction(emb)
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_kref.fm_interaction_ref(jnp.asarray(emb.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy(), want)


def test_fm_plain_is_the_oracle_and_the_model_term():
    emb = torch.from_numpy(RNG.standard_normal((16, 7, 5)).astype(np.float32))
    torch.testing.assert_close(fm_interaction_plain(emb), fm_interaction(emb), rtol=0, atol=0)
    torch.testing.assert_close(t_fm.fm_interaction(emb), fm_interaction(emb), rtol=0, atol=0)


def test_fm_gradient_gradcheck_and_jax():
    """The analytic backward: `gradcheck` in float64, and against JAX's
    autodiff of the reference's jnp term in fp32."""
    emb64 = torch.from_numpy(RNG.standard_normal((6, 5, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(fm_interaction, (emb64,))
    emb = RNG.standard_normal((40, 39, 10)).astype(np.float32)
    ct = RNG.standard_normal(40).astype(np.float32)
    want = np.asarray(jax.vjp(j_fm.fm_interaction, jnp.asarray(emb))[1](jnp.asarray(ct))[0])
    t = torch.from_numpy(emb).requires_grad_(True)
    (got,) = torch.autograd.grad(fm_interaction(t), t, torch.from_numpy(ct))
    _rel_close(got.numpy(), want, 1e-6, "d emb")


def test_fm_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        fm_interaction(torch.zeros(4, 5))
    with pytest.raises(TypeError):
        fm_interaction(torch.zeros(4, 5, 2, dtype=torch.int32))


# ----------------------------------------------------------------------- model
def test_full_config_and_registry_match_the_reference():
    assert dataclasses.asdict(t_cfg.FULL) == dataclasses.asdict(j_cfg.FULL)
    assert dataclasses.asdict(t_cfg.SPEC.make_reduced()) == dataclasses.asdict(j_cfg.SPEC.make_reduced())
    assert t_cfg.FULL.total_rows == 39_000_000
    np.testing.assert_array_equal(t_cfg.FULL.field_offsets, j_cfg.FULL.field_offsets)
    spec = get_arch("deepfm")
    assert spec is t_cfg.SPEC and spec.family == "recsys" and spec.source == "arXiv:1703.04247"
    want = {k: (v.name, v.kind, v.batch, v.n_candidates) for k, v in j_recsys_shapes().items()}
    assert {k: (v.name, v.kind, v.batch, v.n_candidates) for k, v in spec.shapes.items()} == want


def test_init_shapes_and_seed(model):
    """The port's own init: the reference's keys, shapes and scales, the same
    numbers from the same seed."""
    cfg = model["cfg_t"]
    a = t_fm.deepfm_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = t_fm.deepfm_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), model["params_np"])
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), a) == shapes
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
    assert 0.005 < float(a["table"].std()) < 0.02 and float(a["bias"]) == 0.0


def test_forward_matches_jax(model):
    cfg_j, cfg_t, batch = model["cfg_j"], model["cfg_t"], model["batch"]
    want = np.asarray(j_fm.deepfm_forward(model["params_j"], jnp.asarray(batch["ids"]), cfg_j))
    got = t_fm.deepfm_forward(model["params_t"], torch.from_numpy(batch["ids"]), cfg_t).numpy()
    assert got.shape == (256,)
    _rel_close(got, want, 1e-5, "logits")


def test_retrieval_matches_jax(model):
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    r = np.random.default_rng(11)
    user = r.integers(0, cfg_j.rows_per_field, (2, cfg_j.n_fields)).astype(np.int32)
    cand = r.integers(0, cfg_j.rows_per_field, (2, 700)).astype(np.int32)
    want = np.asarray(j_fm.deepfm_retrieval(model["params_j"], jnp.asarray(user), jnp.asarray(cand), cfg_j))
    got = t_fm.deepfm_retrieval(model["params_t"], torch.from_numpy(user), torch.from_numpy(cand), cfg_t).numpy()
    assert got.shape == (2, 700)
    _rel_close(got, want, 1e-5, "scores")


def test_loss_and_every_gradient_match_jax(model):
    cfg_j, cfg_t, batch = model["cfg_j"], model["cfg_t"], model["batch"]
    loss_j, grads_j = jax.value_and_grad(
        lambda p: j_fm.deepfm_loss(p, jnp.asarray(batch["ids"]), jnp.asarray(batch["labels"]), cfg_j)
    )(model["params_j"])
    ids, labels = torch.from_numpy(batch["ids"]), torch.from_numpy(batch["labels"])
    loss_t, grads_t = value_and_grad(lambda p, b: t_fm.deepfm_loss(p, ids, labels, cfg_t), model["params_t"], None)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(grads_t)) == 14
    for path, g in flat_j:
        keys = [p.key for p in path]
        got = grads_t
        for k in keys:
            got = got[k]
        name = "/".join(keys)
        g = np.asarray(g)
        if keys[0] in ("user_tower", "item_proj"):
            assert not g.any() and not got.any(), name        # the loss does not reach them
        else:
            _rel_close(got.numpy(), g, 1e-5, name)


def test_loss_clips_logits_as_the_reference():
    """Logits past ±30 are clipped before the cross-entropy (their gradient
    is zero), so the loss of a huge logit stays finite."""
    z = torch.tensor([100.0, -100.0, 0.5], requires_grad=True)
    y = torch.tensor([0.0, 1.0, 1.0])
    zc = z.clamp(-30.0, 30.0)
    loss = (torch.maximum(zc, torch.zeros_like(zc)) - zc * y + torch.log1p(torch.exp(-zc.abs()))).mean()
    zj = jnp.clip(jnp.asarray([100.0, -100.0, 0.5]), -30.0, 30.0)
    want = jnp.mean(jnp.maximum(zj, 0) - zj * jnp.asarray([0.0, 1.0, 1.0]) + jnp.log1p(jnp.exp(-jnp.abs(zj))))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    (g,) = torch.autograd.grad(loss, z)
    assert g[0] == 0 and g[1] == 0 and g[2] != 0


def test_trainer_trajectory_matches_jax(model):
    """Five AdamW steps on `click_batch_fn` batches of 256, as the launchers
    set them up, from the reference's parameters: losses within 1e-5
    relative, and every parameter after the last step within 1e-4 of its
    largest entry (Adam's normalized step turns a last-bit difference of a
    near-zero gradient into a visible one on that element)."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    fn = j_data.click_batch_fn(cfg_j.n_fields, cfg_j.rows_per_field)
    tr_j = j_loop.Trainer(lambda p, b: j_fm.deepfm_loss(p, b["ids"], b["labels"], cfg_j), j_opt.adamw(1e-3),
                          model["params_j"], j_loop.TrainerConfig(log_every=100))
    stream_j = j_data.ShardedStream(fn, global_batch=256, seed=0)
    losses_j = tr_j.fit(({k: jnp.asarray(v) for k, v in b.items()} for b in stream_j), max_steps=TRAIN_STEPS)
    tr_t = Trainer(lambda p, b: t_fm.deepfm_loss(p, b["ids"], b["labels"], cfg_t), adamw(1e-3),
                   t_fm.params_from_numpy(model["params_np"], device="cpu"), TrainerConfig(log_every=100))
    stream_t = t_data.ShardedStream(t_data.click_batch_fn(cfg_t.n_fields, cfg_t.rows_per_field),
                                    global_batch=256, seed=0)
    losses_t = tr_t.fit(({"ids": torch.from_numpy(b["ids"]).long(), "labels": torch.from_numpy(b["labels"])}
                         for b in stream_t), max_steps=TRAIN_STEPS, log=lambda s: None)
    assert len(losses_t) == len(losses_j) == TRAIN_STEPS
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for path, p in jax.tree_util.tree_flatten_with_path(tr_j.params)[0]:
        got = tr_t.params
        for k in path:
            got = got[k.key]
        _rel_close(got.numpy(), np.asarray(p), 1e-4, [k.key for k in path])


def test_policy_other_than_no_policy_is_refused(model):
    """Only a halo policy (the GCN's) is refused; a grid policy on one rank
    (the sharded DeepFM's, 1 × 1: no group needed) computes what NO_POLICY
    does."""
    from repro_torch.dist.policy import ShardingPolicy
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.shardings import recsys_policy

    ids = torch.from_numpy(model["batch"]["ids"])
    with pytest.raises(NotImplementedError, match="halo policy"):
        t_fm.deepfm_forward(model["params_t"], ids, model["cfg_t"], policy=ShardingPolicy(comm="halo"))
    grid_policy = recsys_policy(Grid(("data", "model"), (1, 1)))
    assert torch.equal(t_fm.deepfm_forward(model["params_t"], ids, model["cfg_t"], policy=grid_policy),
                       t_fm.deepfm_forward(model["params_t"], ids, model["cfg_t"]))


# ------------------------------------------------------------------------ data
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (4, 0), (4, 3)])
def test_click_stream_array_equal(n_hosts, host_id):
    kw = dict(global_batch=64, n_hosts=n_hosts, host_id=host_id, seed=5, start_step=2)
    s_j = j_data.ShardedStream(j_data.click_batch_fn(8, 1000), **kw)
    s_t = t_data.ShardedStream(t_data.click_batch_fn(8, 1000), **kw)
    for _ in range(3):
        bj, bt = next(s_j), next(s_t)
        assert bt["ids"].dtype == np.int32 and bt["labels"].dtype == np.float32
        np.testing.assert_array_equal(bt["ids"], bj["ids"])
        np.testing.assert_array_equal(bt["labels"], bj["labels"])
    assert s_t.step == s_j.step == 5
    np.testing.assert_array_equal(s_t.batch_at(9)["ids"], s_j.batch_at(9)["ids"])


def test_token_stream_and_epoch_permutation_array_equal():
    s_j = j_data.ShardedStream(j_data.token_batch_fn(500, 16), global_batch=8, n_hosts=2, host_id=1, seed=3)
    s_t = t_data.ShardedStream(t_data.token_batch_fn(500, 16), global_batch=8, n_hosts=2, host_id=1, seed=3)
    for _ in range(2):
        a, b = next(s_t), next(s_j)
        assert a.shape == (4, 17) and a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for epoch in (0, 1, 7):
        np.testing.assert_array_equal(t_data.epoch_permutation(1000, epoch, seed=2),
                                      j_data.epoch_permutation(1000, epoch, seed=2))
    with pytest.raises(AssertionError):
        t_data.ShardedStream(t_data.token_batch_fn(5, 4), global_batch=6, n_hosts=4)


# ---------------------------------------------------------------------- layers
def test_layers_match_jax():
    x = RNG.standard_normal((6, 12)).astype(np.float32)
    gamma = RNG.standard_normal(12).astype(np.float32)
    beta = RNG.standard_normal(12).astype(np.float32)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, gamma, beta))
    jx, jg, jb = (jnp.asarray(a) for a in (x, gamma, beta))
    for got, want in (
        (t_layers.rms_norm(tx, tg), j_layers.rms_norm(jx, jg)),
        (t_layers.layer_norm(tx, tg, tb), j_layers.layer_norm(jx, jg, jb)),
        (t_layers.gelu(tx), j_layers.gelu(jx)),
        (t_layers.silu(tx), j_layers.silu(jx)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    p = jax.tree_util.tree_map(np.asarray, j_layers.mlp_init(jax.random.PRNGKey(1), [12, 9, 5]))
    pt = jax.tree_util.tree_map(torch.from_numpy, p)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    for final_act in (False, True):
        np.testing.assert_allclose(t_layers.mlp_apply(pt, tx, final_act=final_act).numpy(),
                                   np.asarray(j_layers.mlp_apply(pj, jx, final_act=final_act)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale,std", [("fan_in", (1 / 300) ** 0.5), ("fan_avg", (2 / 400) ** 0.5), (0.3, 0.3)])
def test_dense_init_scales(scale, std):
    p = t_layers.dense_init(torch.Generator().manual_seed(0), 300, 100, scale=scale, device="cpu")
    assert p["w"].shape == (300, 100) and not p["b"].any()
    assert abs(float(p["w"].std()) / std - 1) < 0.03


# -------------------------------------------------------------------- launchers
def test_launch_serve_deepfm_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "deepfm", "--device", "cpu", "--requests", "2"])
    out = capsys.readouterr().out
    assert out.startswith("deepfm: batch=512 p50≈") and "examples/s" in out


# The ids are the ones these cases had while the GNN families waited for their slice.
@pytest.mark.parametrize("arch,slice_", [
    pytest.param("egnn", None, id="egnn-other GNN families"),
    pytest.param("graphcast", None, id="graphcast-other GNN families"),
    pytest.param("equiformer-v2", "the equiformer-v2 slice", id="equiformer-v2-other GNN families"),
    pytest.param("pna", None, id="pna-other GNN families"),
])
def test_launch_serve_names_the_slice_that_brings_it(arch, slice_, capsys):
    """pna and egnn serve and print the reference CLI's counts (queries,
    micro-batches, traces, nodes and edges per query, foreign rows);
    graphcast exits with the reference's message; equiformer-v2 names the
    slice that brings it."""
    import re

    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    if slice_ is not None:
        with pytest.raises(NotImplementedError, match=slice_):
            serve.main(["--arch", arch, "--device", "cpu"])
        return
    if arch == "graphcast":
        with pytest.raises(SystemExit) as ours:
            serve.main(["--arch", arch, "--device", "cpu"])
        with pytest.raises(SystemExit) as theirs:
            ref_serve.main(["--arch", arch])
        assert str(ours.value) == str(theirs.value) == "graphcast: graph serving supports coin_gcn/pna/egnn"
        return

    def counts(out):
        nums = re.findall(r"(\d+) queries in (\d+) micro-batches \((\d+) trace\)|sampled ([\d.]+) nodes/q "
                          r"([\d.]+) edges/q \| foreign rows (\d+)", out)
        return [x for m in nums for x in m if x]

    serve.main(["--arch", arch, "--device", "cpu"])
    mine = capsys.readouterr().out
    ref_serve.main(["--arch", arch])
    ref = capsys.readouterr().out
    assert mine.startswith(f"{arch}: 64 queries in ") and len(counts(mine)) == 6
    assert counts(mine) == counts(ref)
