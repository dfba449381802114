"""Every float32 matrix product of the main path pins precision=HIGHEST.

Without a pinned precision, XLA on an NVIDIA GPU may run float32 matmuls in
TF32 (~1e-3 relative), a tenth of a voxel across a 181-voxel axis. The CPU
cannot show that error, so the tests read the pins from the traced program.
"""
import jax
import jax.numpy as jnp
import numpy as np

from phantoms import blob_phantom, degrade
from unires_tpu import Settings, init
from unires_tpu.ops.resample import _apply_separable, separable_matrices
from unires_tpu.pipeline.fit import _gather_dyn_taus, _gather_subdats
from unires_tpu.solvers.fitloop import init_state, make_fit_chunk

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """All dot_general equations of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _dots(sub)


def _unpinned(closed):
    dots = list(_dots(closed.jaxpr))
    bad = [e for e in dots
           if any(v.aval.dtype == jnp.float32 for v in e.invars)
           and tuple(e.params["precision"] or ()) != (HIGHEST, HIGHEST)]
    return dots, bad


def test_fit_chunk_products_pin_highest():
    gt = blob_phantom(dim=(16, 16, 17), amplitude=1000.0, seed=0)
    x0, m0, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=5.0, seed=0,
                        rigid_params=[0.3, -0.2, 0.1, 0.01, 0.0, -0.01])
    x1, m1, _ = degrade(gt, thick_axis=1, thick=4.0, noise_sd=5.0, seed=1)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, write_out=False,
                    max_iter=4, cgs_max_iter=3, scaling=True,
                    unified_rigid=True, sched_num=0)
    x, y, sett = init([[x0, m0], [x1, m1]], sett)
    chunk = make_fit_chunk(x, y, sett, K=2)
    args = (init_state(x, y, sett),
            tuple(tuple(o.dat for o in xc) for xc in x),
            _gather_dyn_taus(x), _gather_subdats(x, sett),
            chunk._debug["geom"])
    dots, bad = _unpinned(jax.make_jaxpr(chunk._impl)(*args))
    assert len(dots) > 10  # pose maps, GN moments and the DCT are all in
    assert not bad, [str(e) for e in bad[:3]]


def test_separable_reslice_pins_highest():
    mat = np.diag([1.0, 1.0, 4.0, 1.0])
    mat[:3, 3] = [0.3, -0.2, 1.5]
    Ws, perm = separable_matrices(mat, (12, 13, 5), (12, 13, 20))
    vol = jnp.ones((12, 13, 5), jnp.float32)
    for transpose, v in ((False, vol), (True, jnp.ones((12, 13, 20)))):
        dots, bad = _unpinned(jax.make_jaxpr(
            lambda a: _apply_separable(a, Ws, perm, transpose))(v))
        assert len(dots) == 3 and not bad, [str(e) for e in bad]
