"""Native C++ resampling trio vs the JAX implementations."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

if shutil.which("g++") is None:
    pytest.skip("no g++ in environment", allow_module_level=True)

from unires_tpu.geometry import affine_matrix_classic
from unires_tpu.native import pull_np, push_np, pull_grad_np
from unires_tpu.ops.resample import affine_to_M, pull, push, pull_grad

AFFINES = [
    np.eye(4),
    affine_matrix_classic([2.3, -1.7, 0.4]),
    affine_matrix_classic([1.0, 0.0, -2.0, 0.04, -0.08, 0.06]),
]


@pytest.mark.parametrize("mat", AFFINES)
@pytest.mark.parametrize("order", [0, 1])
def test_native_pull_matches_jax(mat, order):
    rng = np.random.default_rng(0)
    vol = rng.random((17, 19, 23), dtype=np.float32)
    out_dim = (15, 18, 21)
    M = np.asarray(mat[:3, :4], np.float32)
    got = pull_np(vol, M, out_dim, order=order)
    want = np.asarray(pull(jnp.asarray(vol), affine_to_M(mat), out_dim, order=order))
    frac_diff = np.mean(~np.isclose(got, want, atol=1e-5))
    assert frac_diff < (5e-3 if order == 0 else 1e-6), frac_diff


@pytest.mark.parametrize("mat", AFFINES)
def test_native_push_matches_jax_and_adjoint(mat):
    rng = np.random.default_rng(1)
    in_dim, out_dim = (17, 19, 23), (15, 18, 21)
    vol = rng.random(in_dim, dtype=np.float32)
    vals = rng.random(out_dim, dtype=np.float32)
    M = np.asarray(mat[:3, :4], np.float32)
    got = push_np(vals, M, in_dim)
    want = np.asarray(push(jnp.asarray(vals), affine_to_M(mat), in_dim))
    assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()
    Ay = pull_np(vol, M, out_dim)
    assert abs(float((Ay * vals).sum()) - float((got * vol).sum())) < 1e-2


def test_native_pull_grad_matches_jax():
    rng = np.random.default_rng(2)
    mat = AFFINES[2]
    vol = rng.random((16, 17, 18), dtype=np.float32)
    out_dim = (14, 15, 16)
    M = np.asarray(mat[:3, :4], np.float32)
    got = pull_grad_np(vol, M, out_dim)
    want = np.asarray(pull_grad(jnp.asarray(vol), affine_to_M(mat), out_dim))
    assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()


# anisotropic grids and the four poses of the retired kernel tests: identity,
# shift, a small rotation and the 0.045 rad "bigrot" pose
IN_ANISO, OUT_ANISO = (40, 44, 140), (38, 42, 138)
AFFINES_ANISO = [
    ("identity", np.eye(4)),
    ("shift", affine_matrix_classic([2.3, -1.7, 0.4])),
    ("smallrot", affine_matrix_classic([1.1, -0.6, 0.3, 0.02, -0.01, 0.015])),
    ("bigrot", affine_matrix_classic([0.5, 0.2, -0.3, 0.045, -0.04, 0.03])),
]


@pytest.mark.parametrize("name,mat", AFFINES_ANISO)
def test_native_pull_matches_jax_aniso(name, mat):
    rng = np.random.default_rng(3)
    vol = rng.random(IN_ANISO, dtype=np.float32)
    M = affine_to_M(mat)
    got = np.asarray(pull(jnp.asarray(vol), M, OUT_ANISO))
    want = pull_np(vol, np.asarray(M), OUT_ANISO)
    frac_diff = np.mean(~np.isclose(got, want, atol=1e-5))
    assert frac_diff < 1e-6, frac_diff


@pytest.mark.parametrize("name,mat", AFFINES_ANISO)
def test_native_push_matches_jax_and_adjoint_aniso(name, mat):
    rng = np.random.default_rng(4)
    vals = rng.random(OUT_ANISO, dtype=np.float32)
    vol = rng.random(IN_ANISO, dtype=np.float32)
    M = affine_to_M(mat)
    got = np.asarray(push(jnp.asarray(vals), M, IN_ANISO))
    want = push_np(vals, np.asarray(M), IN_ANISO)
    assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()
    Ay = pull_np(vol, np.asarray(M), OUT_ANISO).astype(np.float64)
    lhs = float((Ay * vals).sum())
    rhs = float((got.astype(np.float64) * vol).sum())
    assert abs(lhs - rhs) < 2e-5 * abs(lhs)


@pytest.mark.parametrize("name,mat", AFFINES_ANISO)
def test_native_pull_grad_matches_jax_aniso(name, mat):
    from chip_smoke import knife_edge

    rng = np.random.default_rng(5)
    vol = rng.random(IN_ANISO, dtype=np.float32)
    M = affine_to_M(mat)
    got = np.asarray(pull_grad(jnp.asarray(vol), M, OUT_ANISO))
    want = pull_grad_np(vol, np.asarray(M), OUT_ANISO)
    diff = np.abs(got - want).max(axis=-1)
    if np.all(diff < 1e-5):
        return  # exact agreement (e.g. integer affines: no rounding at all)
    # sample points within 1e-5 of a cell or FOV boundary may flip sides
    edge = knife_edge(np.asarray(M), OUT_ANISO, IN_ANISO)
    assert np.all(diff[~edge] < 1e-4), diff[~edge].max()
    assert edge.mean() < 0.01
