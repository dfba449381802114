"""Device-side chunked fit loop (solvers.fitloop).

Covers: chunk-size invariance of the on-device control flow, the on-device
even/odd scaling GN update (reference unires/_update.py:270-393) and the
on-device unified rigid GN update (reference :198-267,448-710) recovering
known simulated degradations end-to-end.
"""
import numpy as np
import pytest

from phantoms import blob_phantom, degrade

from unires_tpu import Settings, init
from unires_tpu.geometry import affine_basis, affine_matrix_classic, expm
from unires_tpu.pipeline.fit import fit as fit_solver


def _problem(rigid_params=None, scl=0.0, seed=3, **kw):
    gt = blob_phantom(dim=(32, 32, 33), amplitude=1000.0, seed=seed)
    x_obs, mat_x, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=15.0,
                              seed=seed, rigid_params=rigid_params, scl=scl)
    kw.setdefault("sched_num", 0)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0,
                    reg_scl=4.0, write_out=False, tolerance=1e-4, **kw)
    x, y, sett = init([[x_obs, mat_x]], sett)
    return gt, x, y, sett


def test_chunk_size_invariance():
    """K=1 and K=8 chunks must walk the identical iteration sequence."""
    _, x, y, sett = _problem(max_iter=8, chunk_iters=1)
    _, _, _, obj1, n1 = fit_solver(x, y, sett)
    _, x, y, sett = _problem(max_iter=8, chunk_iters=8)
    _, _, _, obj8, n8 = fit_solver(x, y, sett)
    assert n1 == n8 == 8
    assert np.allclose(obj1, obj8, rtol=1e-5), np.abs(obj1 - obj8).max()


def test_scaling_recovery_on_device():
    """Simulated even/odd scaling is recovered by the in-chunk GN update."""
    true_scl = 0.08
    _, x, y, sett = _problem(scl=true_scl, max_iter=20, scaling=True,
                             chunk_iters=8)
    fit_solver(x, y, sett)
    got = x[0][0].po.scl
    assert abs(got - true_scl) < 0.03, got


def test_rigid_recovery_on_device():
    """Simulated rigid misalignment of one repeat (against an aligned repeat
    of the same channel) is recovered by the in-chunk GN update. With a
    single observation the pose is unidentifiable and the pipeline disables
    unified_rigid (reference unires/_core.py:192-195) — two repeats pin it."""
    rp = [1.0, -0.6, 0.5, 0.004, -0.003, 0.002]
    true_R = affine_matrix_classic(rp)
    gt = blob_phantom(dim=(32, 32, 33), amplitude=1000.0, seed=3)
    x0, m0, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=10.0, seed=3)
    x1, m1, _ = degrade(gt, thick_axis=1, thick=4.0, noise_sd=10.0, seed=4,
                        rigid_params=rp)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, sched_num=0,
                    reg_scl=4.0, write_out=False, tolerance=1e-4,
                    max_iter=64, unified_rigid=True, chunk_iters=8)
    x, y, sett = init([[[x0, m0], [x1, m1]]], sett)
    assert sett.unified_rigid  # N=2: must stay enabled
    _, R, _, obj, _ = fit_solver(x, y, sett)
    # only the RELATIVE pose is identifiable: the recon + both poses form a
    # gauge family (the reference relies on coreg to pin the global frame)
    # po.rigid holds the WORLD transform (centre-conjugated q since round
    # 4, geometry.rigid_from_q) — expm(rigid_q) alone is no longer it
    R0 = np.asarray(x[0][0].po.rigid, np.float64)
    R1 = np.asarray(x[0][1].po.rigid, np.float64)
    rel = R1 @ np.linalg.inv(R0)
    # 8e-3 rad: with gauge mean-centring (default since round 4 — the
    # full-scale free gauge drifted 3.4 dB of PSNR, settings.py) both
    # observations absorb half the relative correction per round, and on
    # this tiny noisy fixture the objective converges (gain < tol) with
    # ~0.006 rad of relative rotation left — the fixture's identifiability
    # floor, not a solver defect (full-scale PSNR: 31.1 dB centred vs 28.0
    # free)
    assert np.abs(rel[:3, :3] - true_R[:3, :3]).max() < 8e-3, rel
    assert np.abs(rel[:3, 3] - true_R[:3, 3]).max() < 0.2, rel
    assert obj[-1, 0] < obj[0, 0]
    # fit() must report the recovered poses in R as well
    assert np.allclose(R[1], R1)


def test_rigid_gauge_recentring_keeps_nll_monotone():
    """The pose re-centring of the rigid round adopts only pose sets it has
    evaluated, so the NLL stays monotone (tests/test_parity.py's rule). On
    this two-repeat fixture, re-centring unevaluated poses raised it by 1.1%
    at iteration 15."""
    rp = [1.0, -0.6, 0.5, 0.004, -0.003, 0.002]
    gt = blob_phantom(dim=(32, 32, 33), amplitude=1000.0, seed=5)
    x0, m0, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=10.0, seed=5)
    x1, m1, _ = degrade(gt, thick_axis=1, thick=4.0, noise_sd=10.0, seed=6,
                        rigid_params=rp)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, sched_num=0,
                    reg_scl=4.0, write_out=False, tolerance=1e-4,
                    max_iter=64, unified_rigid=True, chunk_iters=8)
    x, y, sett = init([[[x0, m0], [x1, m1]]], sett)
    _, _, _, obj, n = fit_solver(x, y, sett)
    post = obj[:, 0]
    assert n > 20
    rises = [i for i in range(1, n) if post[i] > post[i - 1] * (1 + 1e-3)]
    assert not rises, (rises, post)


def test_schedule_steps_on_device():
    """The coarse-to-fine lambda schedule advances inside the device loop.

    Needs N>=2 observations: get_sched force-disables the schedule for a
    single observation (reference unires/_core.py:288-307).
    """
    gt = blob_phantom(dim=(32, 32, 33), amplitude=1000.0, seed=3)
    x0, m0, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=15.0, seed=3)
    x1, m1, _ = degrade(gt, thick_axis=1, thick=4.0, noise_sd=15.0, seed=4)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, sched_num=1,
                    reg_scl=4.0, write_out=False, tolerance=1e-4,
                    max_iter=60, chunk_iters=16)
    x, y, sett = init([[[x0, m0], [x1, m1]]], sett)
    _, _, _, obj, n = fit_solver(x, y, sett)
    # a schedule step shows as a jump in the prior term after >16 iterations
    nly = obj[:, 2]
    assert n > 17
    # lambda halves at the step: prior term must drop markedly at some point
    ratios = nly[1:] / np.maximum(nly[:-1], 1e-12)
    assert ratios.min() < 0.75, ratios.min()
