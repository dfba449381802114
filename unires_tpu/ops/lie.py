"""Device-side (jit-traceable, f32) Lie-group and small-affine helpers.

The host geometry core (`unires_tpu.geometry`) does all of this in f64 numpy
once per operator build. The device variants here exist so the *fit loop*
can update rigid poses inside a single jitted chunk of outer iterations
without bouncing 4x4 matrices through the host every iteration (the
reference recomputes expm/solve on host each Gauss-Newton step,
unires/_update.py:618,664; at device speeds those round-trips dominate).

f32 is ample here: the affines' entries are O(100) voxel units, so matrix
products carry ~1e-4 voxel absolute error — far below the trilinear
interpolation scale. Every product pins ``precision=HIGHEST``: unpinned f32
matmuls may run in TF32 on GPUs (~1e-3 relative, a tenth of a voxel across
a 181-voxel axis).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array
HI = jax.lax.Precision.HIGHEST


def mm(*mats: Array) -> Array:
    """Left-to-right f32 matrix chain at HIGHEST precision."""
    out = mats[0]
    for m in mats[1:]:
        out = jnp.matmul(out, m, precision=HI)
    return out


def se3_expm(q: Array, basis: Array) -> Array:
    """Closed-form differentiable SE(3)/se(3)-span exponential (4x4, f32).

    Rodrigues for the rotation block + the V matrix for the translation;
    valid for any basis whose rotation generators are antisymmetric (the
    'SE' basis of geometry.affine_basis, reference unires/_core.py:317).
    jax.scipy.linalg.expm would work but compiles a large squaring chain.
    """
    X = jnp.einsum("k,kij->ij", q.astype(jnp.float32), basis, precision=HI)
    O = X[:3, :3]  # antisymmetric (SE basis)
    w = jnp.stack([O[2, 1], O[0, 2], O[1, 0]])
    th2 = jnp.sum(w * w)
    big = th2 > 1e-8
    # the where-gradient trap: the unselected branch must still have finite
    # gradients, so feed it a SAFE theta (1.0) instead of ~0
    th2s = jnp.where(big, th2, 1.0)
    th = jnp.sqrt(th2s)
    a = jnp.where(big, jnp.sin(th) / th, 1.0 - th2 / 6.0)
    b = jnp.where(big, (1.0 - jnp.cos(th)) / th2s, 0.5 - th2 / 24.0)
    c = jnp.where(big, (th - jnp.sin(th)) / (th2s * th),
                  1.0 / 6.0 - th2 / 120.0)
    O2 = mm(O, O)
    R3 = jnp.eye(3) + a * O + b * O2
    V = jnp.eye(3) + b * O + c * O2
    t = mm(V, X[:3, 3])
    top = jnp.concatenate([R3, t[:, None]], axis=1)
    return jnp.concatenate([top, jnp.asarray([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def se3_dexpm(q: Array, basis: Array):
    """(R, dR) with dR[k] = d expm(sum q_i B_i)/d q_k, shape (K, 4, 4).

    Exact forward-mode derivative of the closed form (the reference uses
    nitorch _expm(grad_X=True), unires/_update.py:618).
    """
    R = se3_expm(q, basis)
    dR = jax.jacfwd(lambda qq: se3_expm(qq, basis))(q)  # (4,4,K)
    return R, jnp.moveaxis(dR, -1, 0)


def expm44(X: Array, order: int = 10, squarings: int = 4) -> Array:
    """Taylor + scaling-and-squaring exp of a 4x4 (differentiable, f32).

    For groups whose generators are not pure se(3) (e.g. CSO = SE(3) +
    isotropic scale, geometry.affine_basis('CSO')) the Rodrigues closed form
    does not apply; this small series is accurate to f32 for ||X|| up to ~10
    and compiles to a tiny graph (vs jax.scipy.linalg.expm's squaring chain).
    """
    Xs = X / (2.0 ** squarings)
    term = jnp.eye(4, dtype=jnp.float32)
    out = jnp.eye(4, dtype=jnp.float32)
    for k in range(1, order + 1):
        term = mm(term, Xs) / k
        out = out + term
    for _ in range(squarings):
        out = mm(out, out)
    return out


def group_expm(q: Array, basis: Array) -> Array:
    """exp(sum q_k B_k) for an arbitrary affine basis (4x4, f32)."""
    X = jnp.einsum("k,kij->ij", q.astype(jnp.float32), basis, precision=HI)
    return expm44(X)


def inv44(M4: Array) -> Array:
    """Inverse of a 4x4 affine [L t; 0 1] via the 3x3 adjugate (f32-stable)."""
    L = M4[:3, :3]
    t = M4[:3, 3]
    c00 = L[1, 1] * L[2, 2] - L[1, 2] * L[2, 1]
    c01 = L[0, 2] * L[2, 1] - L[0, 1] * L[2, 2]
    c02 = L[0, 1] * L[1, 2] - L[0, 2] * L[1, 1]
    c10 = L[1, 2] * L[2, 0] - L[1, 0] * L[2, 2]
    c11 = L[0, 0] * L[2, 2] - L[0, 2] * L[2, 0]
    c12 = L[0, 2] * L[1, 0] - L[0, 0] * L[1, 2]
    c20 = L[1, 0] * L[2, 1] - L[1, 1] * L[2, 0]
    c21 = L[0, 1] * L[2, 0] - L[0, 0] * L[2, 1]
    c22 = L[0, 0] * L[1, 1] - L[0, 1] * L[1, 0]
    det = L[0, 0] * c00 + L[0, 1] * c10 + L[0, 2] * c20
    Li = jnp.asarray([[c00, c01, c02], [c10, c11, c12], [c20, c21, c22]])
    Li = Li / det
    ti = -mm(Li, t)
    top = jnp.concatenate([Li, ti[:, None]], axis=1)
    return jnp.concatenate([top, jnp.asarray([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def compose_maps(pre: Array, R: Array, post: Array):
    """(M, Minv) (3,4) device maps for M4 = pre @ R @ post (all 4x4 f32)."""
    M4 = mm(pre, R, post)
    return M4[:3, :4], inv44(M4)[:3, :4]
