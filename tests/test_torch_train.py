"""The port's training substrate and analytic core against the JAX package.

* Optimizers, gradient compression, checkpoints and the `Trainer`
  (counterparts of `tests/test_train_substrate.py:28-144`), held against the
  reference wherever it computes a number.
* Loss trajectories of the reduced `coin_gcn` under the port's `Trainer`
  and the JAX `Trainer`, from the same parameters and data, on the segment
  and bsr backends.
* The analytic core (energy model, CE-count solver, mesh NoC, measured
  connection probabilities) and the quickstart twin's numbers.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as j_comp
from repro.train import loop as j_loop
from repro.train import optimizer as j_opt
from repro_torch.train import compression, optimizer
from repro_torch.train.checkpoint import available_steps, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad


def _t(tree):
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in tree.items()}


# -------------------------------------------------------------------- optimizers
OPTIMIZERS = {
    "sgd": dict(lr=0.1),
    "sgd_momentum": dict(lr=0.05, momentum=0.9),
    "sgd_nesterov": dict(lr=0.05, momentum=0.9, nesterov=True),
    "adam": dict(lr=0.05),
    "adamw": dict(lr=0.05),
    "lamb": dict(lr=0.05),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_trajectory_matches_jax_and_minimizes(name):
    """200 steps on the reference's quadratic with the same gradients each
    step: the port's iterates equal the reference's within fp32 rounding,
    and the loss falls below 1e-2 as in the reference test."""
    make = name.split("_")[0]
    kw = OPTIMIZERS[name]
    opt_j, opt_t = getattr(j_opt, make)(**kw), getattr(optimizer, make)(**kw)
    p_j = {"w": jnp.asarray([3.0, -2.0]), "b": jnp.asarray(5.0)}
    p_t = _t(p_j)
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for _ in range(200):
        g_j = {"w": 2 * p_j["w"], "b": 2 * p_j["b"]}
        p_j, s_j = opt_j.update(g_j, s_j, p_j)
        p_t, s_t = opt_t.update(_t(g_j), s_t, p_t)
        for k in p_j:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=1e-5, atol=1e-6)
    assert float((p_t["w"] ** 2).sum() + p_t["b"] ** 2) < 1e-2
    assert int(s_t["step"]) == 200


def test_adam_matches_reference_formula():
    opt = optimizer.adam(lr=0.1, b1=0.9, b2=0.999, eps=1e-8)
    p = {"x": torch.tensor([1.0])}
    p1, _ = opt.update({"x": torch.tensor([0.5])}, opt.init(p), p)
    m, v = 0.1 * 0.5, 0.001 * 0.25
    upd = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
    np.testing.assert_allclose(float(p1["x"][0]), 1.0 - 0.1 * upd, rtol=1e-6)


# ------------------------------------------------------------------- compression
@pytest.mark.parametrize("seed,n", [(0, 4), (1, 37), (2, 2000), (3, 513)])
def test_int8_matches_jax_and_error_bound(seed, n):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    q, s = compression.int8_compress(torch.from_numpy(x))
    qj, sj = j_comp.int8_compress(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_allclose(float(s), float(sj), rtol=1e-7)
    err = (compression.int8_decompress(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7
    assert compression.int8_compress(torch.zeros(5))[1] == 1.0


@pytest.mark.parametrize("frac", [0.01, 0.25, 0.9])
def test_topk_matches_jax(frac):
    x = np.random.default_rng(3).standard_normal(301).astype(np.float32)
    np.testing.assert_array_equal(compression.topk_compress(torch.from_numpy(x), frac).numpy(),
                                  np.asarray(j_comp.topk_compress(jnp.asarray(x), frac)))


def test_error_feedback_unbiased_over_time():
    """With error feedback the sum of compressed grads tracks the sum of
    true grads (the residual stays bounded), step for step as the reference."""
    r = np.random.default_rng(0)
    res_t, res_j = {"g": torch.zeros(64)}, {"g": jnp.zeros(64)}
    total_true, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = r.standard_normal(64).astype(np.float32)
        sent, res_t = compression.error_feedback_update({"g": torch.from_numpy(g)}, res_t,
                                                        lambda v: compression.topk_compress(v, 0.25))
        sent_j, res_j = j_comp.error_feedback_update({"g": jnp.asarray(g)}, res_j,
                                                     lambda v: j_comp.topk_compress(v, 0.25))
        np.testing.assert_allclose(sent["g"].numpy(), np.asarray(sent_j["g"]), atol=1e-5)
        total_true += g
        total_sent += sent["g"].numpy()
    assert float(res_t["g"].abs().max()) < 20
    np.testing.assert_allclose(total_sent + res_t["g"].numpy(), total_true, atol=1e-3)


# ------------------------------------------------------------------- checkpoints
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.int32), "none": None}}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    for step in [1, 2, 3, 4, 5]:
        save_checkpoint(d, step, _tree(), metadata={"s": step}, keep=3)
    assert available_steps(d) == [3, 4, 5]
    assert latest_step(d) == 5
    step, restored, meta = restore_checkpoint(d, _tree())
    assert step == 5 and meta["s"] == 5
    torch.testing.assert_close(restored["a"], _tree()["a"])
    assert restored["nested"]["b"].dtype == torch.int32
    assert restored["nested"]["none"] is None
    with open(os.path.join(d, "step_5", "manifest.json")) as f:
        assert json.load(f)["n_leaves"] == 3
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(d, {"a": torch.zeros(3, 4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), _tree())


def test_checkpoint_atomicity_partial_tmp_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.ones(3)})
    # A crash mid-save: an orphan tmp dir and a step dir without manifest.
    os.makedirs(os.path.join(d, ".tmp_step_2"))
    os.makedirs(os.path.join(d, "step_3"))
    assert latest_step(d) == 1
    save_checkpoint(d, 2, {"a": torch.full((3,), 2.0)})       # replaces the orphan tmp dir
    assert latest_step(d) == 2 and not os.path.exists(os.path.join(d, ".tmp_step_2"))
    assert float(restore_checkpoint(d, {"a": torch.ones(3)})[1]["a"][0]) == 2.0


# ----------------------------------------------------------------------- Trainer
def _quadratic(p, b):
    return ((p["w"] - b) ** 2).sum()


def test_trainer_crash_and_resume(tmp_path):
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, log_every=1000)
    batch = torch.tensor([1.0])
    gen = iter(lambda: batch, None)
    tr = Trainer(_quadratic, optimizer.adam(0.1), {"w": torch.tensor([4.0])}, cfg)
    with pytest.raises(RuntimeError, match="injected crash"):
        tr.fit(gen, max_steps=50, crash_at=17)
    tr2 = Trainer(_quadratic, optimizer.adam(0.1), {"w": torch.tensor([4.0])}, cfg)
    assert tr2.resume() and tr2.step == 15
    assert int(tr2.opt_state["step"]) == 15
    losses = tr2.fit(gen, max_steps=150)
    assert losses[-1] < 1e-2


def test_trainer_straggler_monitor():
    import time

    tr = Trainer(lambda p, b: (p["w"] ** 2).sum(), optimizer.sgd(0.01), {"w": torch.tensor([1.0])},
                 TrainerConfig(log_every=1000, straggler_factor=5.0))
    orig, calls = tr._step_fn, {"n": 0}

    def slow_step(*a):
        calls["n"] += 1
        if calls["n"] == 20:
            time.sleep(0.3)
        return orig(*a)

    tr._step_fn = slow_step
    tr.fit(iter(lambda: torch.tensor([0.0]), None), max_steps=25)
    assert any(ev["step"] >= 20 for ev in tr.straggler_events)


@pytest.mark.parametrize("compress,accum", [(True, 1), (False, 3), (True, 2)])
def test_trainer_matches_jax_trainer(compress, accum):
    """Compression with error feedback and gradient accumulation over a
    leading microbatch axis: the port's Trainer follows the JAX Trainer
    step for step, and converges as the reference test asks."""
    w0 = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    batch = np.random.default_rng(1).standard_normal((accum, 16) if accum > 1 else (16,)).astype(np.float32)
    cfg_kw = dict(log_every=1000, compress_grads=compress, grad_accum=accum)
    tr_j = j_loop.Trainer(_quadratic, j_opt.adam(0.05), {"w": jnp.asarray(w0)}, j_loop.TrainerConfig(**cfg_kw),
                          donate=False)
    tr_t = Trainer(_quadratic, optimizer.adam(0.05), {"w": torch.from_numpy(w0)}, TrainerConfig(**cfg_kw))
    l_j = tr_j.fit(iter(lambda: jnp.asarray(batch), None), max_steps=150)
    l_t = tr_t.fit(iter(lambda: torch.from_numpy(batch), None), max_steps=150)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-4, atol=1e-5)
    target = batch.mean(0) if accum > 1 else batch
    assert float(((tr_t.params["w"] - torch.from_numpy(target)) ** 2).sum()) < 1e-2


# ------------------------------------------------------ coin_gcn loss trajectories
def _gcn_setup(quant: bool):
    """The reduced coin_gcn (64 → 16 → 7) on citation_like(256, 1024, seed=0)
    as `repro.launch.train` sets it up, with the reference's initial
    parameters handed to both packages."""
    from repro.configs import get_arch as j_get_arch
    from repro.graph.generators import citation_like
    from repro.graph.structure import blocked_adjacency as j_blocked
    from repro.models.gcn import gcn_init as j_gcn_init
    from repro.models.gcn import gcn_loss as j_gcn_loss
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.structure import blocked_adjacency
    from repro_torch.models.gcn import gcn_loss, params_from_numpy

    cfg_j, cfg_t = j_get_arch("coin_gcn").make_reduced(), get_arch("coin_gcn").make_reduced()
    cfg_j = dataclasses.replace(cfg_j, quant=dataclasses.replace(cfg_j.quant, enabled=quant))
    cfg_t = dataclasses.replace(cfg_t, quant=dataclasses.replace(cfg_t.quant, enabled=quant))
    g = citation_like(256, 1024, seed=0)
    feats = np.random.default_rng(0).standard_normal((g.n_nodes, 64)).astype(np.float32)
    ones = np.ones(g.n_edges, np.float32)
    arrays = dict(feats=feats, senders=g.edge_index[0], receivers=g.edge_index[1], edge_weight=ones,
                  labels=g.labels, label_mask=np.ones(g.n_nodes, np.float32))
    params = {k: np.asarray(v) for k, v in j_gcn_init(jax.random.PRNGKey(0), cfg_j).items()}
    adj_j = j_blocked(g.n_nodes, g.edge_index, ones)
    adj_t = blocked_adjacency(g.n_nodes, g.edge_index, ones)

    def loss_j(backend):
        c = dataclasses.replace(cfg_j, backend=backend)
        kw = {"adjacency": adj_j} if backend == "bsr" else {}
        return lambda p, b: j_gcn_loss(p, b["feats"], b["senders"], b["receivers"], b["edge_weight"],
                                       b["labels"], b["label_mask"], c, **kw)

    def loss_t(backend):
        c = dataclasses.replace(cfg_t, backend=backend)
        kw = {"adjacency": adj_t} if backend == "bsr" else {}
        return lambda p, b: gcn_loss(p, b["feats"], b["senders"], b["receivers"], b["edge_weight"],
                                     b["labels"], b["label_mask"], c, **kw)

    batch_j = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch_t = {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}
    return dict(params=params, to_torch=lambda p: params_from_numpy(p, device="cpu"),
                loss_j=loss_j, loss_t=loss_t, batch_j=batch_j, batch_t=batch_t)


def _trajectories(s, backend, steps):
    cfg = dict(log_every=1000)
    tr_j = j_loop.Trainer(s["loss_j"](backend), j_opt.adamw(1e-2), jax.tree_util.tree_map(jnp.asarray, s["params"]),
                          j_loop.TrainerConfig(**cfg), donate=False)
    tr_t = Trainer(s["loss_t"](backend), optimizer.adamw(1e-2), s["to_torch"](s["params"]), TrainerConfig(**cfg))
    return (np.array(tr_t.fit(iter(lambda: s["batch_t"], None), max_steps=steps)),
            np.array(tr_j.fit(iter(lambda: s["batch_j"], None), max_steps=steps)))


@pytest.fixture(scope="module")
def gcn_quant_off():
    return _gcn_setup(quant=False)


@pytest.fixture(scope="module")
def gcn_quant_on():
    return _gcn_setup(quant=True)


@pytest.mark.parametrize("backend", ["segment", "bsr"])
def test_gcn_loss_trajectory_quant_off_matches_jax(gcn_quant_off, backend):
    """Quant off: each of 10 AdamW steps agrees within 1e-4 relative."""
    ours, ref = _trajectories(gcn_quant_off, backend, 10)
    assert len(ours) == 10 and ours[-1] < ours[0]
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


@pytest.mark.parametrize("backend", ["segment", "bsr"])
def test_gcn_first_step_quant_on_matches_jax(gcn_quant_on, backend):
    """Quant on (4-bit QAT): the first loss and every parameter's gradient
    agree within 1e-4 (of the gradient's largest magnitude).

    The biases are drawn nonzero here. With zero biases, 4-bit codes make
    some ReLU inputs exactly zero in exact arithmetic; each framework's
    summation order then rounds them to ±1e-7, so the ReLU mask, and with
    it the gradient, differs there (8 of 4,096 layer-1 inputs on the segment
    path at the reference's zero-bias init) — a tie, not a port fault."""
    s = gcn_quant_on
    r = np.random.default_rng(1)
    params = {k: v if k.startswith("w") else (0.05 * r.standard_normal(v.shape)).astype(np.float32)
              for k, v in s["params"].items()}
    loss_j, grads_j = jax.value_and_grad(s["loss_j"](backend))(
        jax.tree_util.tree_map(jnp.asarray, params), s["batch_j"])
    loss_t, grads_t = value_and_grad(s["loss_t"](backend), s["to_torch"](params), s["batch_t"])
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for k, g in grads_t.items():
        scale = float(jnp.abs(grads_j[k]).max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(grads_j[k]) / scale, atol=1e-4, err_msg=k)


# Drift of the quant-on trajectory over 10 steps, this file's setup, as
# measured on the CPU: at most 6.1e-7 relative (segment) and 5.3e-7 (bsr) —
# no 4-bit bucket flipped. The bound allows ten times that for summation
# orders that change with the thread count; a flipped bucket would exceed it.
QUANT_ON_DRIFT = 1e-5


@pytest.mark.parametrize("backend", ["segment", "bsr"])
def test_gcn_loss_trajectory_quant_on_within_measured_drift(gcn_quant_on, backend):
    ours, ref = _trajectories(gcn_quant_on, backend, 10)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=QUANT_ON_DRIFT)


# ---------------------------------------------------------------- analytic core
@pytest.fixture(scope="module")
def cora():
    from repro_torch.graph.generators import make_dataset

    return make_dataset("cora")


def test_partition_statistics_and_probabilities_match_jax(cora):
    from repro.core import partition as j_part
    from repro_torch.core import partition

    spec, g = cora
    for k, method in ((16, "bfs"), (9, "block")):
        ours = partition.partition_graph(g.n_nodes, g.edge_index, k, method=method, seed=0, refine=True)
        ref = j_part.partition_graph(g.n_nodes, g.edge_index, k, method=method, seed=0, refine=True)
        assert (ours.intra_edges, ours.cut_edges, ours.cut_fraction) == (ref.intra_edges, ref.cut_edges,
                                                                         ref.cut_fraction)
        for broadcast in (True, False):
            np.testing.assert_array_equal(ours.inter_ce_traffic_bits(64, broadcast),
                                          ref.inter_ce_traffic_bits(64, broadcast))
        np.testing.assert_array_equal(ours.intra_ce_traffic_bits(64), ref.intra_ce_traffic_bits(64))
        for a, b in zip(partition.measured_probabilities(ours), j_part.measured_probabilities(ref)):
            np.testing.assert_array_equal(a, b)


def test_energy_solver_noc_match_jax():
    from repro.core import energy as j_energy, noc as j_noc, solver as j_solver
    from repro_torch.core import energy, noc, solver

    kw = dict(n_nodes=2708, act_bits_sum=64, p_intra=0.25, p_inter=0.22)
    ours, ref = energy.CoinEnergyModel(**kw), j_energy.CoinEnergyModel(**kw)
    for k in (4.0, 16.0, 34.1, 100.0):
        assert ours.total(k) == ref.total(k)
    a, b = solver.optimal_ce_count(ours), j_solver.optimal_ce_count(ref)
    assert (a.k_star, a.k_mesh, tuple(a.mesh_shape)) == (b.k_star, b.k_mesh, tuple(b.mesh_shape))
    traffic = np.random.default_rng(0).integers(0, 1000, (16, 16)).astype(np.float64)
    np.fill_diagonal(traffic, 0)
    s, t = noc.MeshNoC(4, 4).summarize(traffic), j_noc.MeshNoC(4, 4).summarize(traffic)
    assert dataclasses.asdict(s) == dataclasses.asdict(t)


def test_quickstart_analytic_numbers_match_reference(cora):
    """The twin's steps 2–3 print the reference quickstart's numbers."""
    from repro.core.energy import CoinEnergyModel
    from repro.core.noc import MeshNoC
    from repro.core.partition import measured_probabilities, partition_graph
    from repro.core.solver import optimal_ce_count
    from repro_torch.launch.quickstart import analytic_steps

    spec, g = cora
    lines = []
    ours = analytic_steps(spec, g, log=lines.append)
    # examples/quickstart.py, steps 2–3
    p1, p2 = measured_probabilities(partition_graph(g.n_nodes, g.edge_index, 16, method="bfs", seed=0,
                                                    refine=True))
    res = optimal_ce_count(CoinEnergyModel(n_nodes=g.n_nodes, act_bits_sum=spec.hidden * 4,
                                           p_intra=float(p1.mean()), p_inter=float(p2.sum() / (16 * 15))))
    part = partition_graph(g.n_nodes, g.edge_index, res.k_mesh, method="bfs", seed=0, refine=True)
    noc = MeshNoC(*res.mesh_shape)
    s = noc.summarize(part.inter_ce_traffic_bits(spec.hidden * 4, broadcast=True))
    halo = noc.summarize(part.inter_ce_traffic_bits(spec.hidden * 4, broadcast=False))
    assert ours == dict(k_star=res.k_star, mesh_shape=tuple(res.mesh_shape), exchange_bits=s.total_bits,
                        exchange_cycles=s.latency_cycles, halo_bits=halo.total_bits)
    assert lines[1] == (f"[3] inter-CE exchange: {s.total_bits/8e3:.1f} kB, {s.latency_cycles:.0f} cycles "
                        f"(beyond-paper halo: {halo.total_bits/8e3:.1f} kB)")
    assert lines[0].startswith(f"[2] optimal CEs: k*={res.k_star:.1f} → {res.mesh_shape[0]}×{res.mesh_shape[1]} mesh")


def test_quickstart_training_on_both_backends(cora):
    """Step 5 with the backend as an argument: segment and bsr train the
    same 4-bit GCN from the same parameters to the same losses."""
    from repro_torch.launch.quickstart import train_gcn

    spec, g = cora
    runs = {b: train_gcn(spec, g, backend=b, epochs=3, device="cpu", log=lambda s: None)
            for b in ("segment", "bsr")}
    (l_seg, acc_seg), (l_bsr, acc_bsr) = runs["segment"], runs["bsr"]
    assert l_seg[-1] < l_seg[0]
    np.testing.assert_allclose(l_bsr, l_seg, rtol=1e-4)
    assert abs(acc_bsr - acc_seg) < 0.01


def test_launch_train_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    train.main(["--arch", "coin_gcn", "--steps", "12", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "coin_gcn: loss" in out and "over 12 steps" in out
    assert latest_step(str(tmp_path)) is None          # ckpt_every=50: nothing saved at 12 steps
    with pytest.raises(NotImplementedError, match="DeepFM slice"):
        train.main(["--arch", "deepfm", "--steps", "1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="LM slice"):
        train.main(["--arch", "olmoe-1b-7b", "--steps", "1", "--device", "cpu"])
