"""Diagnose brain-phantom bench quality (round-5).

Runs the bench workload with switchable degradation/registration options and
reports PSNR / sr-vs-trilinear plus recovered-vs-true poses and a
gauge-compensated PSNR (recon resampled by the residual mean pose), to
separate three candidate causes of the r05 brain-phantom regression
(PSNR 15.25, ratio 1.09):
  (a) rigid misalignment never corrected (coreg/GN failure),
  (b) mean-pose gauge offset (recon displaced by mean of true poses),
  (c) intrinsic SR quality on sharp plateaus (regularization tuning).

Usage: python scripts/diag_brain.py [--no-rigid] [--no-coreg] [--dim 121]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-rigid", action="store_true",
                    help="degrade without rigid misalignment")
    ap.add_argument("--no-coreg", action="store_true")
    ap.add_argument("--dim", type=int, default=0,
                    help="cubic dim override (0 = bench 181x217x181)")
    ap.add_argument("--max-iter", type=int, default=-1)
    ap.add_argument("--print", dest="do_print", type=int, default=1)
    args = ap.parse_args()

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from phantoms import brain_phantom
    from unires_tpu import Settings, init
    from unires_tpu.geometry import affine_diag, affine_matrix_classic
    from unires_tpu.models.forward import proj_apply
    from unires_tpu.models.proj_op import proj_info
    from unires_tpu.pipeline.fit import fit as fit_solver

    dim_y = (args.dim,) * 3 if args.dim else (181, 217, 181)
    rng = np.random.default_rng(0)
    gts = [brain_phantom(dim=dim_y, contrast=c, amplitude=2000.0, seed=0)
           for c in ("t1", "t2", "pd")]
    gt = gts[0]
    gtj = jnp.asarray(gt)
    np.asarray(jnp.ones(8) + 1)

    # zero-Lie-mean rigid draws, exactly like bench.py (the common mode is
    # unobservable gauge; see bench.py for the rationale)
    from unires_tpu.geometry import affine_basis, expm, rigid_log

    basis_se = affine_basis("SE")
    rps = [rng.uniform(-2, 2, 3).tolist()
           + rng.uniform(-0.02, 0.02, 3).tolist() for _ in range(3)]
    if args.no_rigid:
        rps = [[0.0] * 6 for _ in range(3)]
    logs = [rigid_log(affine_matrix_classic(rp), basis_se) for rp in rps]
    qm = np.mean(logs, axis=0)
    rigids = [expm(lg - qm, basis_se) for lg in logs]

    chans = []
    thick_axes = [2, 1, 0]
    for c in range(3):
        ax = thick_axes[c]
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        mat_x = affine_diag(vx)
        dim_x = list(dim_y)
        dim_x[ax] = int(np.ceil(dim_y[ax] / 4.0))
        po = proj_info(dim_y, np.eye(4), tuple(dim_x), mat_x,
                       rigid=rigids[c], prof_ip=2, prof_tp=0, scl=0.1)
        x = np.asarray(proj_apply("A", jnp.asarray(gts[c]), po,
                                  "super-resolution"))
        x = x + 75.0 * rng.standard_normal(x.shape).astype(np.float32)
        chans.append([x.astype(np.float32), mat_x])
    print("true rigid params per channel:")
    for c, rp in enumerate(rps):
        print(f"  ch{c}: " + ",".join(f"{v:+.4f}" for v in rp))

    sett = Settings(vx=1.0, do_print=args.do_print, write_out=False,
                    tolerance=1e-4, sched_num=3, reg_scl=4.0,
                    do_coreg=not args.no_coreg,
                    unified_rigid=True, scaling=True)
    if args.max_iter >= 0:
        sett.max_iter = args.max_iter
    t0 = time.time()
    x, y, sett = init(chans, sett)
    t_init = time.time() - t0
    print(f"init: {t_init:.1f}s")
    # header correction applied by coreg: x[c][0].mat vs original mat_x
    for c in range(3):
        d = np.asarray(x[c][0].mat) @ np.linalg.inv(chans[c][1])
        print(f"  coreg correction ch{c} t=" +
              ",".join(f"{v:+.2f}" for v in d[:3, 3]))

    from unires_tpu.ops.resample import affine_to_M, pull

    M = affine_to_M(y[0].mat)
    gt_on_y = np.asarray(pull(gtj, M, y[0].dim))
    msk = gt_on_y > 0
    tri = np.asarray(y[0].dat)
    mse_tri = float(np.mean((tri[msk] - gt_on_y[msk]) ** 2))

    t0 = time.time()
    y, R, jtv, obj, n_iter = fit_solver(x, y, sett)
    t_fit = time.time() - t0
    print(f"fit: {t_fit:.1f}s / {n_iter} iters")

    print("recovered rigid R (world, per obs):")
    for i in range(R.shape[0]):
        tr = R[i][:3, 3]
        print(f"  obs{i}: t=" + ",".join(f"{v:+.2f}" for v in tr))

    rec = np.asarray(y[0].dat)
    mse = float(np.mean((rec[msk] - gt_on_y[msk]) ** 2))
    peak = float(gt_on_y.max())
    psnr = 10.0 * np.log10(peak ** 2 / max(mse, 1e-12))
    print(f"RAW psnr={psnr:.2f} mse_sr={mse:.1f} mse_tri={mse_tri:.1f} "
          f"ratio={mse / max(mse_tri, 1e-12):.4f}", flush=True)

    # gauge-compensated PSNR: estimate the global translation of the recon
    # (the mean-pose gauge can displace the whole solution) by phase
    # correlation (host FFT), then evaluate MSE at that single shift
    F = np.fft.rfftn(gt_on_y)
    G = np.fft.rfftn(rec)
    cross = F * np.conj(G)
    cross /= np.maximum(np.abs(cross), 1e-20)
    corr = np.fft.irfftn(cross, gt_on_y.shape)
    pk = np.unravel_index(np.argmax(corr), corr.shape)
    shift = [float(p if p <= n // 2 else p - n)
             for p, n in zip(pk, gt_on_y.shape)]
    recj = jnp.asarray(rec)
    Msh = np.eye(4)
    Msh[:3, 3] = shift
    sh = np.asarray(pull(recj, affine_to_M(Msh), y[0].dim))
    mse_g = float(np.mean((sh[msk] - gt_on_y[msk]) ** 2))
    if mse_g > mse:
        mse_g, shift = mse, [0.0, 0.0, 0.0]
    psnr_g = 10.0 * np.log10(peak ** 2 / max(mse_g, 1e-12))

    out = {
        "no_rigid": args.no_rigid, "no_coreg": args.no_coreg,
        "dim": dim_y, "n_iter": int(n_iter),
        "init_s": round(t_init, 1), "fit_s": round(t_fit, 1),
        "mse_trilinear": round(mse_tri, 1), "mse_sr": round(mse, 1),
        "sr_vs_trilinear": round(mse / max(mse_tri, 1e-12), 4),
        "psnr_db": round(psnr, 2),
        "psnr_gauge_comp_db": round(psnr_g, 2),
        "gauge_shift_vox": shift,
        "mse_gauge_comp": round(mse_g, 1),
        "nll_first": float(obj[0, 0]) if len(obj) else None,
        "nll_last": float(obj[-1, 0]) if len(obj) else None,
    }
    print("DIAG " + json.dumps(out))


if __name__ == "__main__":
    main()
