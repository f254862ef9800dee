"""The port's `fake_quant` equals the JAX package's (to 1e-6), and the
port's segment ops equal the reference's `repro.graph.ops`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import fake_quant as j_fake_quant
from repro.graph import ops as j_ops
from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.graph import ops


def _inputs():
    r = np.random.default_rng(0)
    outliers = r.standard_normal(1000).astype(np.float32)
    outliers[[3, 500]] = [80.0, -120.0]
    return {
        "normal": r.standard_normal((64, 33)).astype(np.float32),
        "ties": np.repeat(np.array([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0], np.float32), 20),
        "half_steps": (np.arange(-16, 17, dtype=np.float32) * 0.5),
        "outliers": outliers,
        "tiny": np.array([0.3, -0.7, 0.1], np.float32),
        "single": np.array([[2.5]], np.float32),
        "zeros": np.zeros((4, 5), np.float32),
        "relu_like": np.maximum(r.standard_normal((100, 16)), 0).astype(np.float32),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("percentile", [None, 99.9])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_fake_quant_matches_jax(bits, percentile, name):
    x = INPUTS[name]
    ref = np.asarray(j_fake_quant(jnp.asarray(x), bits, percentile=percentile))
    out = fake_quant(torch.from_numpy(x), bits, percentile=percentile).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [0, 32, 64])
def test_fake_quant_off_is_identity(bits):
    x = torch.from_numpy(INPUTS["normal"])
    assert fake_quant(x, bits) is x


def test_fake_quant_straight_through_gradient():
    x = torch.from_numpy(INPUTS["normal"]).clone().requires_grad_()
    fake_quant(x, 4, percentile=99.9).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_quant_config_matches_reference_defaults():
    q = QuantConfig()
    assert (q.weight_bits, q.act_bits, q.enabled, q.act_percentile) == (4, 4, True, 99.9)
    assert q.replace(act_bits=8).act_bits == 8


def _edges():
    r = np.random.default_rng(3)
    n, e = 50, 300
    ei = r.integers(0, n - 5, size=(2, e)).astype(np.int32)     # nodes ≥ 45 receive nothing
    return n, ei, r.standard_normal(e).astype(np.float32), r.standard_normal((n, 6)).astype(np.float32)


@pytest.mark.parametrize("weighted", [True, False])
def test_aggregate_matches_jax(weighted):
    n, ei, w, x = _edges()
    ref = j_ops.aggregate(jnp.asarray(x), jnp.asarray(ei[0]), jnp.asarray(ei[1]), n,
                          jnp.asarray(w) if weighted else None)
    out = ops.aggregate(torch.from_numpy(x), torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), n,
                        torch.from_numpy(w) if weighted else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_aggregate_padded_degrees_and_sym_norm_match_jax():
    n, ei, w, x = _edges()
    s = np.concatenate([ei[0], np.full(7, n, np.int32)])          # ghost-padded edges
    r = np.concatenate([ei[1], np.full(7, n, np.int32)])
    wp = np.concatenate([w, np.zeros(7, np.float32)])
    ref = j_ops.aggregate_padded(jnp.asarray(x), jnp.asarray(s), jnp.asarray(r), n, jnp.asarray(wp))
    out = ops.aggregate_padded(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(r), n,
                               torch.from_numpy(wp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ops.degrees(torch.from_numpy(ei[1]), n).numpy(),
                                  np.asarray(j_ops.degrees(jnp.asarray(ei[1]), n)))
    np.testing.assert_allclose(
        ops.sym_norm_edge_weights(torch.from_numpy(ei[0]), torch.from_numpy(ei[1]), n).numpy(),
        np.asarray(j_ops.sym_norm_edge_weights(jnp.asarray(ei[0]), jnp.asarray(ei[1]), n)), rtol=1e-6)
