"""The port's GCN (`repro_torch.models.gcn`) against the JAX package's.

Both packages get the same seeded numpy inputs; the reference's parameters
cross over through `params_from_numpy`. The reference runs its bsr backend
as its own tests do on the CPU (Pallas in interpret mode). Tolerance 3e-4
in fp32, the reference suite's bsr-vs-segment tolerance
(tests/test_gcn_backends.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.coin_gcn import make_config as j_make_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.graph.generators import make_dataset as j_make_dataset
from repro.graph.structure import blocked_adjacency as j_blocked_adjacency
from repro.models.gcn import GCNConfig as JGCNConfig, gcn_forward as j_forward, gcn_init as j_init
from repro.models.gcn import gcn_loss as j_loss
from repro_torch.configs.coin_gcn import make_config
from repro_torch.configs.registry import get_arch
from repro_torch.core.quant import QuantConfig
from repro_torch.graph.generators import make_dataset
from repro_torch.graph.structure import (
    blocked_adjacency,
    locality_block_order,
    permute_edge_index,
    relocate_rows,
    to_padded,
)
from repro_torch.models.gcn import GCNConfig, gcn_forward, gcn_init, gcn_loss, params_from_numpy

TOL = 3e-4


def _graph(n, e, seed):
    r = np.random.default_rng(seed)
    ei = r.integers(0, n, size=(2, e)).astype(np.int32)
    w = (np.abs(r.standard_normal(e)) + 0.1).astype(np.float32)
    return ei, w


def _dense_adj(n, ei, w):
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (ei[1], ei[0]), w)
    return a


def _jax_params(dims, seed):
    return {k: np.asarray(v) for k, v in j_init(jax.random.PRNGKey(seed), JGCNConfig(layer_dims=dims)).items()}


def _both(dims, dataflow, backend, n, ei, w, x, params, quant=None):
    """Logits of the reference and of the port on the same inputs."""
    jq = JQuantConfig(**dataclasses.asdict(quant)) if quant else JQuantConfig(enabled=False)
    tq = quant or QuantConfig(enabled=False)
    jcfg = JGCNConfig(layer_dims=dims, dataflow=dataflow, backend=backend, quant=jq)
    tcfg = GCNConfig(layer_dims=dims, dataflow=dataflow, backend=backend, quant=tq)
    jkw, tkw = {}, {}
    if backend == "bsr":
        jkw["adjacency"] = j_blocked_adjacency(n, ei, w)
        tkw["adjacency"] = blocked_adjacency(n, ei, w)
    elif backend == "dense":
        a = _dense_adj(n, ei, w)
        jkw["dense_adj"], tkw["dense_adj"] = jnp.asarray(a), torch.from_numpy(a)
    ref = j_forward({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                    jnp.asarray(ei[0]), jnp.asarray(ei[1]), jnp.asarray(w), jcfg, **jkw)
    out = gcn_forward(params_from_numpy(params, device="cpu"), torch.from_numpy(x),
                      torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), torch.from_numpy(w), tcfg, **tkw)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("dims", [(24, 16, 8), (12, 32, 4)])
@pytest.mark.parametrize("dataflow", ["feature_first", "aggregation_first"])
@pytest.mark.parametrize("backend", ["segment", "bsr", "dense"])
def test_forward_matches_jax(dims, dataflow, backend):
    """As tests/test_gcn_backends.py:47, each backend against its twin."""
    n, e = 256, 1200
    ei, w = _graph(n, e, seed=0)
    x = np.random.default_rng(7).standard_normal((n, dims[0])).astype(np.float32)
    ref, out = _both(dims, dataflow, backend, n, ei, w, x, _jax_params(dims, 0))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dataflow", ["feature_first", "aggregation_first", "auto"])
def test_bsr_nonmultiple_n_matches_jax(dataflow):
    """As tests/test_gcn_backends.py:89: N=300, a ragged tail block."""
    n, e, dims = 300, 1500, (20, 24, 6)
    ei, w = _graph(n, e, seed=11)
    x = np.random.default_rng(8).standard_normal((n, dims[0])).astype(np.float32)
    ref, out = _both(dims, dataflow, "bsr", n, ei, w, x, _jax_params(dims, 3))
    assert out.shape == (n, dims[-1])
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["segment", "bsr"])
def test_fake_quant_forward_matches_jax(backend):
    """As tests/test_gcn_backends.py:106: 4-bit weights and activations."""
    n, e, dims = 384, 2000, (16, 32, 5)
    ei, w = _graph(n, e, seed=12)
    x = np.random.default_rng(9).standard_normal((n, dims[0])).astype(np.float32)
    ref, out = _both(dims, "auto", backend, n, ei, w, x, _jax_params(dims, 4), quant=QuantConfig(4, 4, enabled=True))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_port_bsr_matches_port_segment_under_fake_quant():
    n, e, dims = 384, 2000, (16, 32, 5)
    ei, w = _graph(n, e, seed=12)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((n, dims[0])).astype(np.float32))
    params = gcn_init(torch.Generator().manual_seed(0), GCNConfig(layer_dims=dims), device="cpu")
    q = QuantConfig(4, 4, enabled=True)
    args = (params, x, torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), torch.from_numpy(w))
    seg = gcn_forward(*args, GCNConfig(layer_dims=dims, quant=q))
    out = gcn_forward(*args, GCNConfig(layer_dims=dims, quant=q, backend="bsr"),
                      adjacency=blocked_adjacency(n, ei, w))
    np.testing.assert_allclose(out.numpy(), seg.numpy(), rtol=TOL, atol=TOL)


def test_loss_matches_jax():
    n, e, dims = 300, 1400, (10, 8, 4)
    ei, w = _graph(n, e, seed=13)
    r = np.random.default_rng(10)
    x = r.standard_normal((n, dims[0])).astype(np.float32)
    labels = r.integers(0, dims[-1], n).astype(np.int32)
    mask = (np.arange(n) % 4 != 0).astype(np.float32)
    params = _jax_params(dims, 5)
    cfg = JGCNConfig(layer_dims=dims)
    ref = j_loss({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.asarray(ei[0]),
                 jnp.asarray(ei[1]), jnp.asarray(w), jnp.asarray(labels), jnp.asarray(mask), cfg)
    out = gcn_loss(params_from_numpy(params, device="cpu"), torch.from_numpy(x), torch.from_numpy(ei[0]),
                   torch.from_numpy(ei[1]), torch.from_numpy(w), torch.from_numpy(labels),
                   torch.from_numpy(mask), GCNConfig(layer_dims=dims))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_coin_gcn_reduced_end_to_end_matches_jax(quant):
    """The registry's reduced coin_gcn on make_dataset("cora", reduced=True):
    symmetrize, self-loops, sym-norm weights, locality order, blocking and
    the bsr forward, in both packages from the same seeds."""
    spec, g = make_dataset("cora", reduced=True)
    _, jg = j_make_dataset("cora", reduced=True)
    np.testing.assert_array_equal(g.edge_index, jg.edge_index)
    cfg = get_arch("coin_gcn").make_reduced()
    assert cfg.layer_dims == (spec.n_features, spec.hidden, spec.n_labels)
    if not quant:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(enabled=False))
    gs = g.symmetrized().with_self_loops()
    wts = gs.sym_normalized_weights()
    perm = locality_block_order(g.n_nodes, gs.edge_index)
    ei = permute_edge_index(perm, gs.edge_index)
    x = relocate_rows(perm, g.features).astype(np.float32)
    ref, out = _both(cfg.layer_dims, cfg.dataflow, "bsr", g.n_nodes, ei, wts, x,
                     _jax_params(cfg.layer_dims, 0), quant=cfg.quant if quant else None)
    assert out.shape == (g.n_nodes, spec.n_labels) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    pg = to_padded(gs, weights=wts, device="cpu")
    assert int(pg.senders.shape[0]) == gs.n_edges


def test_make_config_matches_jax():
    for name in ("cora", "pubmed", "nell"):
        ours, theirs = make_config(dataset=name), j_make_config(dataset=name)
        assert ours.layer_dims == theirs.layer_dims
        assert (ours.dataflow, ours.backend) == (theirs.dataflow, theirs.backend)
        assert dataclasses.asdict(ours.quant) == dataclasses.asdict(theirs.quant)


def test_registry_ported_and_unported_archs():
    from repro.configs.registry import get_arch as ref_get_arch

    assert get_arch("coin-gcn") is get_arch("coin_gcn")
    assert set(get_arch("coin_gcn").shapes) == {"cora", "citeseer", "pubmed", "extcora", "nell"}
    for arch in ("pna", "egnn", "graphcast", "equiformer-v2"):
        ours, theirs = get_arch(arch), ref_get_arch(arch)
        assert (ours.arch_id, ours.family, ours.source) == (theirs.arch_id, theirs.family, theirs.source)
        assert dataclasses.asdict(ours.make_reduced()) == dataclasses.asdict(theirs.make_reduced())
        assert dataclasses.asdict(ours.make_config(None)) == dataclasses.asdict(theirs.make_config(None))
        for name, shape in theirs.shapes.items():
            assert dataclasses.asdict(ours.make_config(ours.shapes[name])) == \
                dataclasses.asdict(theirs.make_config(shape))
    from repro_torch.configs.registry import ALL_ARCHS

    assert all(get_arch(a).arch_id == a for a in ALL_ARCHS)      # every id is ported
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_backend_argument_validation():
    """The errors of tests/test_gcn_backends.py:123-141."""
    n, e, dims = 64, 200, (8, 4)
    ei, w = _graph(n, e, seed=13)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, dims[0])).astype(np.float32))
    params = gcn_init(torch.Generator().manual_seed(5), GCNConfig(layer_dims=dims), device="cpu")
    args = (params, x, torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), torch.from_numpy(w))
    with pytest.raises(ValueError, match="unknown GCN backend"):
        gcn_forward(*args, GCNConfig(layer_dims=dims, backend="sparse"))
    with pytest.raises(ValueError, match="requires adjacency"):
        gcn_forward(*args, GCNConfig(layer_dims=dims, backend="bsr"))
    with pytest.raises(ValueError, match="BlockedAdjacency"):
        gcn_forward(*args, GCNConfig(layer_dims=dims, backend="bsr"), adjacency=np.zeros((4, 4)))
    with pytest.raises(ValueError, match="vals"):
        gcn_forward(*args, GCNConfig(layer_dims=dims, backend="bsr"),
                    adjacency=(np.zeros((4, 4)), np.zeros(3)))
    with pytest.raises(ValueError, match="dense_adj"):
        gcn_forward(*args, GCNConfig(layer_dims=dims, backend="dense"))


def test_init_is_seeded_and_glorot_scaled():
    cfg = GCNConfig(layer_dims=(300, 16, 7))
    a = gcn_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = gcn_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["w0"].std()) - (2.0 / 316) ** 0.5) < 0.01
    assert not a["b0"].any() and a["w1"].shape == (16, 7)
