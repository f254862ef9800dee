"""`repro_torch.nn.so3` against `repro.nn.so3`.

The same rotations, made from a seed with numpy, go through both packages:
`rotation_align_z` (with the u = ±ẑ cases and the zero vector of a
self-loop) and `real_sh_rotations` up to l_max 6 hold within 1e-5, as do
`block_diag_apply` and its transpose. The reference's own properties
(tests/test_models.py::test_so3_wigner_properties: each D_l orthogonal,
and D(R₁R₂) = D(R₁)·D(R₂)) hold for the port under hypothesis, at l_max 6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.nn import so3 as ref_so3
from repro_torch.nn import so3

TOL = 1e-5


def _unit_vectors(seed: int, n: int = 64) -> np.ndarray:
    r = np.random.default_rng(seed)
    u = r.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    u[0], u[1], u[2] = (0, 0, 1), (0, 0, -1), (0, 0, 0)          # +ẑ, −ẑ, a self-loop's zero vector
    u[3] = (1e-7, 0, -1)                                          # inside the antipodal branch
    u[4] = (0.6, 0.0, 0.8)
    return u.astype(np.float32)


def _rotations(seed: int, n: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    a = np.linalg.qr(r.standard_normal((n, 3, 3)))[0]
    a[np.linalg.det(a) < 0, :, 0] *= -1
    return a.astype(np.float32)


def test_rotation_align_z_matches_the_reference():
    u = _unit_vectors(0)
    ours = so3.rotation_align_z(torch.from_numpy(u)).numpy()
    theirs = np.asarray(ref_so3.rotation_align_z(jnp.asarray(u)))
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
    np.testing.assert_array_equal(ours[2], np.eye(3, dtype=np.float32))           # zero vector: R = I
    np.testing.assert_array_equal(ours[1], np.diag([1.0, -1.0, -1.0]).astype(np.float32))
    np.testing.assert_array_equal(ours[3], np.diag([1.0, -1.0, -1.0]).astype(np.float32))
    moved = np.einsum("eij,ej->ei", ours, u)
    real = np.linalg.norm(u, axis=1) > 0
    np.testing.assert_allclose(moved[real], np.tile([0.0, 0.0, 1.0], (int(real.sum()), 1)), atol=1e-5)


@pytest.mark.parametrize("l_max", [0, 1, 2, 6])
def test_real_sh_rotations_match_the_reference(l_max):
    R = so3.rotation_align_z(torch.from_numpy(_unit_vectors(1)))
    R = torch.cat([R, torch.from_numpy(_rotations(2, 16))])
    ours = so3.real_sh_rotations(R, l_max)
    theirs = ref_so3.real_sh_rotations(jnp.asarray(R.numpy()), l_max)
    assert len(ours) == len(theirs) == l_max + 1
    for l, (a, b) in enumerate(zip(ours, theirs)):
        assert tuple(a.shape) == (R.shape[0], 2 * l + 1, 2 * l + 1) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0, err_msg=f"l={l}")


def test_block_diag_apply_and_transpose_match_the_reference():
    l_max, c = 6, 5
    R = torch.from_numpy(_rotations(3, 12))
    x = np.random.default_rng(4).standard_normal((12, (l_max + 1) ** 2, c)).astype(np.float32)
    D, D_ref = so3.real_sh_rotations(R, l_max), ref_so3.real_sh_rotations(jnp.asarray(R.numpy()), l_max)
    for ours_fn, ref_fn in ((so3.block_diag_apply, ref_so3.block_diag_apply),
                            (so3.block_diag_apply_T, ref_so3.block_diag_apply_T)):
        ours, theirs = ours_fn(D, torch.from_numpy(x)).numpy(), np.asarray(ref_fn(D_ref, jnp.asarray(x)))
        np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
    back = so3.block_diag_apply_T(D, so3.block_diag_apply(D, torch.from_numpy(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=2e-5)
    assert so3.sh_block_slices(l_max) == ref_so3.sh_block_slices(l_max)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 1000))
def test_so3_wigner_properties(seed):
    """Orthogonality and the homomorphism D(R₁R₂) = D(R₁)·D(R₂), the
    reference's property test run on the port at l_max 6."""
    R = torch.from_numpy(_rotations(seed, 2))
    D = so3.real_sh_rotations(R, 6)
    for l, Dl in enumerate(D):
        eye = np.tile(np.eye(2 * l + 1), (2, 1, 1))
        np.testing.assert_allclose((Dl @ Dl.transpose(-1, -2)).numpy(), eye, atol=2e-5)
    D1, D2 = so3.real_sh_rotations(R[:1], 6), so3.real_sh_rotations(R[1:], 6)
    D12 = so3.real_sh_rotations(R[:1] @ R[1:], 6)
    for l in range(7):
        np.testing.assert_allclose(D12[l].numpy(), (D1[l] @ D2[l]).numpy(), atol=3e-5)


def test_rotations_about_z_act_per_m_pair():
    """The block-diagonal property eSCN needs: a rotation by γ about ẑ turns
    each (m, −m) pair of D_l by m·γ and leaves m = 0 alone."""
    g = 0.7
    Rz = torch.tensor([[np.cos(g), -np.sin(g), 0.0], [np.sin(g), np.cos(g), 0.0], [0.0, 0.0, 1.0]],
                      dtype=torch.float64)[None]
    for l, Dl in enumerate(so3.real_sh_rotations(Rz, 6)):
        Dl = Dl[0].numpy()
        assert abs(Dl[l, l] - 1.0) < 1e-12
        for m in range(1, l + 1):
            block = Dl[np.ix_([l - m, l + m], [l - m, l + m])]
            np.testing.assert_allclose(np.abs(block), np.abs([[np.cos(m * g), np.sin(m * g)],
                                                               [np.sin(m * g), np.cos(m * g)]]), atol=1e-12)
