"""Device-side chunked fit loop: K outer iterations per device call.

The reference's host loop (unires/run.py:78-157) syncs with the host several
times per outer iteration. This module folds EVERYTHING the reference does per
outer iteration into one jitted function scanned K times on device:

  * the ADMM y/z/w updates and the objective        (unires/_update.py:105-195)
  * the gain-based convergence countdowns            (unires/run.py:100-110)
  * the even/odd scaling Gauss-Newton update         (unires/_update.py:270-393)
  * the unified rigid Gauss-Newton update            (unires/_update.py:198-267,
                                                      448-710)
  * the coarse-to-fine lambda schedule + rho refresh (unires/run.py:140-155)

The host only sees a (K,3) objective block per chunk, logs it and
checkpoints.

Rigid-pose safety: push is a gather over a static window sized at the
nominal pose (ops.resample.push_window); the line search REJECTS candidates
whose dynamic maps exceed it (models.forward.make_resample_suite
capacity_ok), so push stays the exact adjoint of pull by construction.
"""
from __future__ import annotations

from timeit import default_timer as timer
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import affine_basis
from ..models.forward import make_obs_suite
from ..models.proj_op import proj_info
from ..ops.conv import blur_down_sep, blur_up_sep
from ..ops.lie import HI, inv44, mm, se3_dexpm, se3_expm
from ..ops.reductions import stable_sum
from ..ops.scaling import apply_scaling
from .admm import make_admm_body

Array = jax.Array

# symmetric 3x3 -> 6-vector index map (as solvers.rigid / reference
# unires/_update.py:564)
_LKP = np.array([[0, 3, 4], [3, 1, 5], [4, 5, 2]])


class FitState(NamedTuple):
    """Everything the device loop carries between outer iterations."""

    ys: Array          # (C, *dim_y)
    z: Array           # (C, 3, *dim_y)
    w: Array           # (C, 3, *dim_y)
    q: Array           # (Nobs, 6) rigid params
    scl: Array         # (Nobs,) even/odd scaling
    jtv: Array         # (*dim_y) latest shrinkage field
    cdiags: Array      # (C,) preconditioner data-term diagonals
    cnt_scl: Array     # i32 schedule position
    cnt_scl_iter: Array
    countdown0: Array  # convergence countdown (6 -> 0)
    countdown1: Array  # schedule countdown
    n_iter: Array      # i32 global iteration counter
    done: Array        # bool
    prev_obj: Array    # f32 last posterior value
    obj_max: Array
    obj_min: Array
    has_prev: Array    # bool
    n_vetoed: Array    # i32 capacity-vetoed rigid line-search candidates
    n_sat: Array       # i32 SATURATED line searches: no candidate accepted
                       # AND >=1 veto — the pose is pinned at the window
                       # budget edge (ordinary overshoot vetoes, where a
                       # halved step is then accepted, do NOT count)


def init_state(x, y, sett, z=None, w=None) -> FitState:
    """Fresh (or resumed, via the z/w args) device state from pipeline structs."""
    C = len(x)
    dim_y = tuple(int(d) for d in y[0].dim)
    ys = jnp.stack([jnp.asarray(yc.dat, jnp.float32) for yc in y])
    if z is None:
        z = jnp.zeros((C, 3) + dim_y, jnp.float32)
    if w is None:
        w = jnp.zeros((C, 3) + dim_y, jnp.float32)
    qs, scls = [], []
    for xc in x:
        for o in xc:
            qs.append(np.zeros(6) if o.rigid_q is None else
                      np.asarray(o.rigid_q, np.float64))
            scls.append(float(o.po.scl))
    big = jnp.float32(np.finfo(np.float32).max)
    return FitState(
        ys=ys, z=z, w=w,
        q=jnp.asarray(np.stack(qs), jnp.float32),
        scl=jnp.asarray(scls, jnp.float32),
        jtv=jnp.zeros(dim_y, jnp.float32),
        cdiags=jnp.zeros((C,), jnp.float32),
        cnt_scl=jnp.int32(0), cnt_scl_iter=jnp.int32(0),
        countdown0=jnp.int32(6), countdown1=jnp.int32(6),
        n_iter=jnp.int32(0), done=jnp.bool_(False),
        prev_obj=jnp.float32(0.0), obj_max=-big, obj_min=big,
        has_prev=jnp.bool_(False), n_vetoed=jnp.int32(0),
        n_sat=jnp.int32(0),
    )


def _flat_obs(x):
    return [(c, n) for c in range(len(x)) for n in range(len(x[c]))]


def chunk_geom(x, y, sett):
    """Per-subject geometry operands for the fit chunk.

    Returns ``(geom_args, sub_geoms)``: ``geom_args`` is the tuple of device
    arrays the chunk takes as its ``geom`` operand (pre/post affines with the
    pose conjugated by the recon-FOV world centre — q rotations act about the
    volume centre, see geometry.rigid_from_q; on corner-origin affines the
    unconjugated parameterization has near-flat screw directions that
    destabilized the round-4 full-scale rigid chain — plus their
    rigid-subsample variants, vx_y and per-channel lam0). ``sub_geoms`` is a
    flat per-observation list of rigid-subsample geometry dicts (or None when
    unified_rigid is off) that make_fit_chunk pairs with suites.

    Standalone (not a closure) so parallel.fit_batch can build per-SUBJECT
    geom operands for one shared compiled chunk.
    """
    from ..geometry import affine_translation as _aff_T
    from ..geometry import fov_centre as _fov_centre

    method = sett.method
    obs = _flat_obs(x)
    dim_y = tuple(int(d) for d in y[0].dim)
    c_world = _fov_centre(y[0].mat, dim_y)
    Tc = _aff_T(c_world)
    Tc_inv = _aff_T(-c_world)

    pres_np, posts_np = [], []
    sub_pres_np, sub_posts_np = [], []
    sub_geoms = []
    for (c, n) in obs:
        o = x[c][n]
        po = o.po
        pre = np.linalg.inv(np.asarray(po.mat_y, np.float64)) @ Tc
        post = Tc_inv @ np.asarray(
            po.mat_yx if method == "super-resolution" else po.mat_x,
            np.float64)
        pres_np.append(pre.astype(np.float32))
        posts_np.append(np.asarray(post, np.float64).astype(np.float32))

        if sett.unified_rigid:
            po_sub = proj_info(po.dim_y, po.mat_y, o.dim, o.mat,
                               rigid=po.rigid, prof_ip=sett.profile_ip,
                               prof_tp=sett.profile_tp, gap=sett.gap,
                               scl=po.scl, samp=sett.rigid_samp)
            sub_is_main = (po_sub.dim_x == po.dim_x
                           and po_sub.dim_yx == po.dim_yx)
            po_use = po if sub_is_main else po_sub
            mat_sub = (po_use.mat_yx if method == "super-resolution"
                       else po_use.mat_x)
            dim_m = (po_use.dim_yx if method == "super-resolution"
                     else po_use.dim_x)
            center = tuple((d - 1) / 2.0 for d in dim_m)
            cscale = tuple(max((d - 1) / 2.0, 1.0) for d in dim_m)
            sub_pres_np.append(pres_np[-1])
            sub_posts_np.append((Tc_inv @ np.asarray(mat_sub, np.float64))
                                .astype(np.float32))
            sub_geoms.append(dict(
                po=po_use, dim=dim_m, center=center, cscale=cscale,
                sub_is_main=sub_is_main))
        else:
            sub_pres_np.append(pres_np[-1])
            sub_posts_np.append(posts_np[-1])
            sub_geoms.append(None)

    vx_y_np = np.sqrt((np.asarray(y[0].mat, np.float64)[:3, :3] ** 2)
                      .sum(0)).astype(np.float32)
    geom_args = (jnp.asarray(np.stack(pres_np)),
                 jnp.asarray(np.stack(posts_np)),
                 jnp.asarray(np.stack(sub_pres_np)),
                 jnp.asarray(np.stack(sub_posts_np)),
                 jnp.asarray(vx_y_np),
                 jnp.asarray([float(yc.lam0) for yc in y], jnp.float32))
    return geom_args, sub_geoms


def make_fit_chunk(x, y, sett, K: int, extra_budget: float = 0.0):
    """Build the jitted K-iteration chunk for the current plan-time poses.

    ``extra_budget`` (radians) widens every push window; the fit loop
    escalates it when the on-device capacity veto saturates in consecutive
    chunks (a pose BEYOND the window can only be reached through a wider
    one — re-centring at an unmoved pose rebuilds the same program).

    chunk(state, xdats, taus, subdats) ->
        (state, objs (K,3), gains (K,), valid (K,) bool)

    xdats/taus: nested tuples as in solvers.admm. subdats: flat tuple over
    observations of NN-subsampled volumes for the rigid update (None entries
    where the rigid grids coincide with the main grids, the rigid_samp=1
    default — reference unires/_update.py:576-598).
    """
    C = len(x)
    method = sett.method
    do_proj = sett.do_proj
    obs = _flat_obs(x)
    Nobs = len(obs)
    flat_of = {cn: i for i, cn in enumerate(obs)}
    dim_y = tuple(int(d) for d in y[0].dim)

    basis_np = (sett.rigid_basis if sett.rigid_basis is not None
                else affine_basis("SE"))
    basis = jnp.asarray(np.asarray(basis_np), jnp.float32)

    # ---- static per-observation geometry. The affine constants (pre =
    # mat_y^-1, post = mat_yx / mat_x, their rigid-subsample variants, vx_y,
    # lam0) are NOT baked into the trace: they ride in as the ``geom``
    # operand so the compiled executable depends on the pose/affines ONLY
    # through the integer push windows, and is reusable across the
    # subjects of a geometry-homogeneous batch (parallel.fit_batch feeds
    # per-subject geom/pose operands through ONE compiled program). ----
    geom_args, sub_geoms = chunk_geom(x, y, sett)

    suites = []
    sub_infos = []  # (suite_sub, dims, center, cscale, sub_is_main)
    for idx, (c, n) in enumerate(obs):
        o = x[c][n]
        po = o.po
        suites.append(make_obs_suite(po, method, extra_budget=extra_budget))
        sg = sub_geoms[idx]
        if sg is None:
            sub_infos.append(None)
            continue
        if sg["sub_is_main"]:
            suite_sub = suites[-1]
        else:
            suite_sub = make_obs_suite(sg["po"], method,
                                       extra_budget=extra_budget)
        sub_infos.append(dict(sg, suite=suite_sub))

    admm_body = make_admm_body(x, y, sett)

    # ---- schedule / step-size constants ----
    reg_scl = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
    n_sched = int(reg_scl.size)
    reg_scl_j = jnp.asarray(reg_scl.astype(np.float32))
    has_ct = any(o.ct for xc in x for o in xc)
    rho_fixed = (1.0 if has_ct else
                 (float(sett.rho) if sett.rho is not None else None))
    rho_scl = float(sett.rho_scl)
    tol = float(sett.tolerance)
    max_iter = int(sett.max_iter)
    do_scaling = bool(sett.scaling)
    do_rigid = bool(sett.unified_rigid)
    gauge_anchor = bool(getattr(sett, "rigid_gauge_anchor", True))
    rigid_mod = max(int(sett.rigid_mod), 1)
    num_ls = 6  # reference run.py:119,131 line-search budget
    ct_flags = [x[c][n].ct for (c, n) in obs]
    dim_y_j = dim_y

    def maps_from_q(q, pres, posts):
        Ms, Minvs = [], []
        for c in range(C):
            Mc, Mic = [], []
            for n in range(len(x[c])):
                i = flat_of[(c, n)]
                R = se3_expm(q[i], basis)
                M4 = mm(pres[i], R, posts[i])
                Mc.append(M4[:3, :4])
                Mic.append(inv44(M4)[:3, :4])
            Ms.append(tuple(Mc))
            Minvs.append(tuple(Mic))
        return tuple(Ms), tuple(Minvs)

    def nested_scl(scl_flat):
        return tuple(tuple(scl_flat[flat_of[(c, n)]]
                           for n in range(len(x[c]))) for c in range(C))

    def cand_ok(i, qc, geom):
        """The push windows of observation i accept pose qc (device bool)."""
        pres, posts, sub_pres, sub_posts = geom[:4]
        Rc = se3_expm(qc, basis)
        # the MAIN forward ops must stay inside their push windows
        M4m = mm(pres[i], Rc, posts[i])
        okv = suites[i]["capacity_ok"](M4m[:3, :4], inv44(M4m)[:3, :4])
        info = sub_infos[i]
        if info is not None and not info["sub_is_main"]:
            M4s = mm(sub_pres[i], Rc, sub_posts[i])
            okv &= info["suite"]["capacity_ok"](M4s[:3, :4],
                                                inv44(M4s)[:3, :4])
        return okv

    def match_ll(ys_c, dat_x, qc, s_i, tau, i, geom):
        """Rigid matching term of observation i at pose qc."""
        info = sub_infos[i]
        po_u = info["po"]
        M = mm(geom[2][i], se3_expm(qc, basis), geom[3][i])[:3, :4]
        dat_yx = info["suite"]["pull"](ys_c, M)
        if method == "super-resolution":
            dat_yx = blur_down_sep(dat_yx, po_u.smo_ker_1d, po_u.ratio)
            dat_yx = apply_scaling(dat_yx, s_i, po_u.dim_thick)
        res = jnp.where(dat_x != 0, dat_x - dat_yx, 0.0)
        return 0.5 * tau * stable_sum(res * res)

    def rho_of(taus, lams):
        if rho_fixed is not None:
            return jnp.float32(rho_fixed)
        tau_all = jnp.stack([taus[c][n] for (c, n) in obs])
        return rho_scl * jnp.sqrt(jnp.mean(tau_all)) / jnp.mean(lams)

    def compute_cdiags(q, scl_flat, taus, pres, posts):
        Ms, Minvs = maps_from_q(q, pres, posts)
        out = []
        for c in range(C):
            acc = jnp.float32(0.0)
            for n in range(len(x[c])):
                i = flat_of[(c, n)]
                if do_proj:
                    ata1 = suites[i]["AtA"](jnp.ones(dim_y_j, jnp.float32),
                                            Ms[c][n], Minvs[c][n],
                                            scl_flat[i])
                    acc = acc + taus[c][n] * jnp.mean(ata1)
                else:
                    acc = acc + taus[c][n]
            out.append(acc)
        return jnp.stack(out)

    # ------------------------------------------------------------------
    # Chunk builder (wires xdats/taus/subdats operands through the scan)
    # ------------------------------------------------------------------

    # ---- per-observation scaling GN (reference _update_scaling) ----
    def scaling_obs(ys_c, dat_x, M, s0, tau, i):
            c, n = obs[i]
            o = x[c][n]
            axis = o.po.dim_thick
            y0 = suites[i]["project"](ys_c, M)  # pull+blur, no scaling
            msk = dat_x != 0

            def ll_at(s):
                dat_p = apply_scaling(y0, s, axis)
                res = jnp.where(msk, dat_x - dat_p, 0.0)
                return 0.5 * tau * stable_sum(res * res)

            dat_s = apply_scaling(y0, s0, axis)
            res = jnp.where(msk, dat_x - dat_s, 0.0)
            ll0 = 0.5 * tau * stable_sum(res * res)
            sl_e = [slice(None)] * 3
            sl_e[axis] = slice(0, None, 2)
            sl_o = [slice(None)] * 3
            sl_o[axis] = slice(1, None, 2)
            ye, me = dat_s[tuple(sl_e)], msk[tuple(sl_e)]
            yo, mo = dat_s[tuple(sl_o)], msk[tuple(sl_o)]
            xe, xo = dat_x[tuple(sl_e)], dat_x[tuple(sl_o)]
            sp = jnp.sum(jnp.where(me, ye * (xe - ye), 0.0))
            sm = jnp.sum(jnp.where(mo, yo * (xo - yo), 0.0))
            gr = tau * (sm - sp)
            hes = tau * (jnp.sum(jnp.where(me, ye * ye, 0.0))
                         + jnp.sum(jnp.where(mo, yo * yo, 0.0)))
            delta = gr / jnp.maximum(hes, 1e-30)

            def ls_body(carry):
                step, it, acc, s_best, ll_best = carry
                cand = s0 - step * delta
                llc = ll_at(cand)
                ok = llc < ll_best
                s_best = jnp.where(ok, cand, s_best)
                ll_best = jnp.where(ok, llc, ll_best)
                return step * 0.5, it + 1, acc | ok, s_best, ll_best

            def ls_cond(carry):
                _, it, acc, _, _ = carry
                return (~acc) & (it < num_ls)

            _, _, _, s_new, _ = jax.lax.while_loop(
                ls_cond, ls_body,
                (jnp.float32(1.0), jnp.int32(0), jnp.bool_(False), s0, ll0))
            return s_new

    # ---- per-observation rigid GN (reference _update_rigid_channel),
    # split into a STATS phase (moments -> GN delta) and a LINE-SEARCH
    # phase so the rigid round can project the pose-gauge common mode out
    # of the deltas in between (see do_rig below). Both phases are traced
    # exactly once per observation per chunk. ----
    def rigid_stats(ys_c, dat_x, q_i, s_i, tau, i, geom):
            c, n = obs[i]
            pres, posts, sub_pres, sub_posts = geom[:4]
            info = sub_infos[i]
            suite = info["suite"]
            po_u = info["po"]
            pre, post = sub_pres[i], sub_posts[i]
            dim_m = info["dim"]
            center = info["center"]
            cscale = info["cscale"]
            sr = method == "super-resolution"
            kers, ratio, axis = po_u.smo_ker_1d, po_u.ratio, po_u.dim_thick

            R, dR = se3_dexpm(q_i, basis)
            M4 = mm(pre, R, post)
            M = M4[:3, :4]
            dRq = jnp.einsum("ij,kjl,lm->kim", pre, dR, post,
                             precision=HI)  # (6,4,4)

            # matching stats (reference _rigid_match, :448-538)
            dat_yx_raw = suite["pull"](ys_c, M)
            if sr:
                dat_yx = blur_down_sep(dat_yx_raw, kers, ratio)
                dat_yx = apply_scaling(dat_yx, s_i, axis)
            else:
                dat_yx = dat_yx_raw
            gr_vol = suite["pull_grad"](ys_c, M)  # (dim_m..., 3)
            msk_x = dat_x != 0
            res = jnp.where(msk_x, dat_x - dat_yx, 0.0)
            ll = 0.5 * tau * stable_sum(res * res)
            diff = jnp.where(msk_x & (dat_yx != 0), dat_yx - dat_x, 0.0)
            if sr:
                diff = blur_up_sep(diff, kers, ratio)
                ones = jnp.ones(dim_m, jnp.float32)
                ctc = blur_up_sep(blur_down_sep(ones, kers, ratio),
                                  kers, ratio)
            else:
                ctc = jnp.float32(1.0)

            # normalised centred coordinates (f32-safe moments; the scale is
            # folded back into the assembly below)
            X, Y, Z = dim_m
            ii = (jax.lax.broadcasted_iota(jnp.float32, (X, 1, 1), 0)
                  - center[0]) / cscale[0]
            jj = (jax.lax.broadcasted_iota(jnp.float32, (1, Y, 1), 1)
                  - center[1]) / cscale[1]
            kk = (jax.lax.broadcasted_iota(jnp.float32, (1, 1, Z), 2)
                  - center[2]) / cscale[2]

            def moments(W):
                m0 = jnp.sum(W)
                m1 = jnp.stack([jnp.sum(W * ii), jnp.sum(W * jj),
                                jnp.sum(W * kk)])
                m2 = jnp.stack([
                    jnp.sum(W * ii * ii), jnp.sum(W * jj * jj),
                    jnp.sum(W * kk * kk), jnp.sum(W * ii * jj),
                    jnp.sum(W * ii * kk), jnp.sum(W * jj * kk)])
                return m0, m1, m2

            gm0, gm1 = [], []
            for d in range(3):
                m0, m1, _ = moments(gr_vol[..., d] * diff)
                gm0.append(m0)
                gm1.append(m1)
            gm0 = jnp.stack(gm0)
            gm1 = jnp.stack(gm1)
            wm0, wm1, wm2 = [], [], []
            for (d1, d2) in [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]:
                m0, m1, m2 = moments(gr_vol[..., d1] * gr_vol[..., d2] * ctc)
                wm0.append(m0)
                wm1.append(m1)
                wm2.append(m2)
            wm0 = jnp.stack(wm0)
            wm1 = jnp.stack(wm1)
            wm2 = jnp.stack(wm2)

            # ---- assembly (device mirror of solvers.rigid._assemble) ----
            cs = jnp.asarray(cscale, jnp.float32)
            cc = dRq[:, :3, 3] + jnp.einsum(
                "kde,e->kd", dRq[:, :3, :3], jnp.asarray(center, jnp.float32),
                precision=HI)
            b = dRq[:, :3, :3] * cs[None, None, :]  # normalised-coord coeffs
            g = (jnp.einsum("kd,d->k", cc, gm0, precision=HI)
                 + jnp.einsum("kde,de->k", b, gm1, precision=HI))
            lkp = jnp.asarray(_LKP)
            m0m = wm0[lkp]                       # (3,3)
            m1m = wm1[lkp]                       # (3,3,3)

            def m2mat(m2):
                return jnp.asarray([[m2[0], m2[3], m2[4]],
                                    [m2[3], m2[1], m2[5]],
                                    [m2[4], m2[5], m2[2]]])

            M2m = jax.vmap(jax.vmap(m2mat))(wm2[lkp])  # (3,3,3,3)
            H = (jnp.einsum("kd,je,de->kj", cc, cc, m0m, precision=HI)
                 + jnp.einsum("kd,jef,def->kj", cc, b, m1m, precision=HI)
                 + jnp.einsum("kdf,je,def->kj", b, cc, m1m, precision=HI)
                 + jnp.einsum("kdf,jeg,defg->kj", b, b, M2m, precision=HI))
            # Jacobi-equilibrated 6x6 solve: the raw H spans ~6 orders of
            # magnitude between translation and rotation blocks, too much
            # for a plain f32 solve (the host path solves in f64,
            # solvers.rigid._update_rigid_obs); unit-diagonal scaling keeps
            # the f32 factorization accurate
            dscale = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(H)) + 1e-20)
            Hn = H * dscale[:, None] * dscale[None, :]
            gn = g * dscale
            sol = jnp.linalg.solve(Hn + 1e-5 * jnp.eye(6), gn)
            return sol * dscale, ll

    def rigid_ls(ys_c, dat_x, q_i, s_i, tau, i, geom, delta, ll):
            # ---- capacity trust region: an ill-conditioned GN solve can
            # emit a HUGE delta; 6 Armijo halvings then never re-enter the
            # window budget, every candidate is vetoed, and the saturation
            # heuristic would mis-read "pose pinned at the budget edge" —
            # triggering a needless budget-escalating rebuild. Pre-scale the
            # step OUTSIDE the line search (capacity checks only, no ll
            # evaluations — scalar ops, ~free) so Armijo always starts
            # inside the budget and its 6 evaluations compare real
            # objectives. Saturation below then means the pose ITSELF is
            # pinned (even a 2^-16 step leaves capacity) — the only case
            # budget escalation is for. ----
            def pre_cond(carry):
                _, it, okc, _ = carry
                return (~okc) & (it < 16)

            def pre_body(carry):
                step, it, _, nv = carry
                step = step * 0.5
                return (step, it + 1, cand_ok(i, q_i - step * delta, geom),
                        nv + 1)

            step0, _, ok_pre, n_veto = jax.lax.while_loop(
                pre_cond, pre_body,
                (jnp.float32(1.0), jnp.int32(0), cand_ok(i, q_i - delta, geom),
                 jnp.int32(0)))

            def ls_body(carry):
                step, it, acc, q_best, ll_best, nv = carry
                cand = q_i - step * delta
                # belt-and-braces: halving from an in-capacity step0 stays
                # in capacity for every practical map, but push must NEVER
                # run beyond its window — keep the guard
                cap = cand_ok(i, cand, geom)
                llc = jnp.where(cap, match_ll(ys_c, dat_x, cand, s_i, tau, i,
                                              geom), jnp.inf)
                ok = llc < ll_best
                q_best = jnp.where(ok, cand, q_best)
                ll_best = jnp.where(ok, llc, ll_best)
                nv = nv + (~cap).astype(jnp.int32)
                return step * 0.5, it + 1, acc | ok, q_best, ll_best, nv

            def ls_cond(carry):
                _, it, acc, _, _, _ = carry
                return (~acc) & (it < num_ls)

            _, _, acc_any, q_new, _, n_veto = jax.lax.while_loop(
                ls_cond, ls_body,
                (step0, jnp.int32(0), jnp.bool_(False), q_i, ll, n_veto))
            # saturation = nothing accepted AND the trust-region pre-scale
            # could not re-enter the window budget: the pose is genuinely
            # pinned at the budget edge (the only case the host's
            # budget-escalating re-plan is for)
            return q_new, n_veto, (~acc_any) & (~ok_pre)

    def chunk_impl(state: FitState, xdats, taus, subdats, geom):
        pres, posts, sub_pres, sub_posts, vx, lam0 = geom

        # ---- one outer iteration ----
        def live_iter(st: FitState):
            lams = reg_scl_j[st.cnt_scl] * lam0
            rho = rho_of(taus, lams)
            Ms, Minvs = maps_from_q(st.q, pres, posts)
            scls = nested_scl(st.scl)
            ys, z, w, jtv, obj = admm_body(
                st.ys, st.z, st.w, xdats, Ms, Minvs, scls, taus, lams, rho,
                st.cdiags, vx=vx)

            # gain (nitorch get_gain over the posterior trace)
            o0 = obj[0]
            omax = jnp.maximum(st.obj_max, o0)
            omin = jnp.minimum(st.obj_min, o0)
            denom = omax - omin
            gain = jnp.where(
                st.has_prev,
                jnp.where(denom > 0, (st.prev_obj - o0) / denom, 0.0),
                jnp.float32(np.inf))

            # convergence countdown (reference run.py:103-110)
            conv_ok = ((st.cnt_scl >= n_sched - 1)
                       & (st.cnt_scl_iter > 20)
                       & ((jnp.abs(gain) < tol)
                          | (st.n_iter >= max_iter - 1)))
            cd0 = jnp.where(conv_ok, st.countdown0 - 1, 6)
            done_now = conv_ok & (cd0 == 0)

            def tail(args):
                q, scl, cnt_scl, cnt_scl_iter, cd1, nveto, nsat, _ = args
                if do_scaling:
                    Ms2, _ = maps_from_q(q, pres, posts)
                    new_scl = []
                    for i2 in range(Nobs):
                        c2, n2 = obs[i2]
                        if ct_flags[i2]:
                            new_scl.append(scl[i2])
                        else:
                            new_scl.append(scaling_obs(
                                ys[c2], xdats[c2][n2], Ms2[c2][n2], scl[i2],
                                taus[c2][n2], i2))
                    scl = jnp.stack(new_scl)
                if do_rigid:
                    pred = (st.n_iter > 0) & (st.n_iter % rigid_mod == 0)

                    def do_rig(args):
                        qq, nv, ns = args
                        # Phase 1: GN deltas for every observation.
                        dats, deltas, lls = [], [], []
                        for i2 in range(Nobs):
                            c2, n2 = obs[i2]
                            dat_i = (xdats[c2][n2]
                                     if sub_infos[i2]["sub_is_main"]
                                     else subdats[i2])
                            dats.append(dat_i)
                            d_i, ll_i = rigid_stats(
                                ys[c2], dat_i, qq[i2], scl[i2],
                                taus[c2][n2], i2, geom)
                            deltas.append(d_i)
                            lls.append(ll_i)
                        deltas = jnp.stack(deltas)
                        if gauge_anchor and Nobs > 1:
                            # Project the pose-gauge common mode OUT of the
                            # GN steps before the line searches (the joint
                            # model is gauge-free, so the mean step is the
                            # flat manifold direction: following it just
                            # drags recon+poses together — measured round 4
                            # at bench scale, the free gauge drifted to
                            # ~16 mm / 0.1 rad and cost 3.4 dB of PSNR).
                            # Projecting BEFORE Armijo (rather than only
                            # mean-centring the accepted poses, the
                            # reference's mean_correct semantics,
                            # unires/_update.py:243-265) means every
                            # adopted pose was actually evaluated: post-hoc
                            # centring adopted UNEVALUATED poses each round,
                            # which bumped the objective ~1% and kept
                            # |gain| oscillating above the schedule gate
                            # for ~160 iterations (236 total vs ~100 for
                            # the rigid-free run).
                            deltas = deltas - jnp.mean(deltas, axis=0,
                                                       keepdims=True)
                        # Phase 2: capacity trust region + Armijo along the
                        # projected steps.
                        new_q = []
                        for i2 in range(Nobs):
                            c2, n2 = obs[i2]
                            q_i2, nv_i2, sat_i2 = rigid_ls(
                                ys[c2], dats[i2], qq[i2], scl[i2],
                                taus[c2][n2], i2, geom, deltas[i2],
                                lls[i2])
                            new_q.append(q_i2)
                            nv = nv + nv_i2
                            ns = ns + sat_i2.astype(jnp.int32)
                        qn = jnp.stack(new_q)
                        if gauge_anchor and Nobs > 1:
                            # Per-observation step lengths re-introduce a
                            # small common mode. Re-centre the poses (the
                            # reference's mean_correct) only where the
                            # centred set passes every window-capacity check
                            # AND its summed matching term is still below the
                            # round's start: adopting centred poses
                            # UNEVALUATED raised the objective 0.2-3.4% in
                            # the next iteration.
                            qc = qn - jnp.mean(qn, axis=0, keepdims=True)
                            okc = jnp.bool_(True)
                            llc = jnp.float32(0.0)
                            for i2 in range(Nobs):
                                c2, n2 = obs[i2]
                                okc &= cand_ok(i2, qc[i2], geom)
                                llc = llc + match_ll(
                                    ys[c2], dats[i2], qc[i2], scl[i2],
                                    taus[c2][n2], i2, geom)
                            okc &= llc < sum(lls)
                            qn = jnp.where(okc, qc, qn)
                        return qn, nv, ns

                    q, nveto, nsat = jax.lax.cond(pred, do_rig, lambda a: a,
                                                  (q, nveto, nsat))

                # schedule step (reference run.py:140-155)
                sch_ok = ((cnt_scl + 1 < n_sched)
                          & (cnt_scl_iter > 16) & (jnp.abs(gain) < 1e-3))
                cd1 = jnp.where(sch_ok, cd1 - 1, 6)
                stepped = sch_ok & (cd1 == 0)
                # dual-consistency rescale at the lambda step: the z aux
                # approximates lam*D*y, so when lam -> lam' it must scale by
                # lam'/lam (and w by (lam'/lam)*(rho'/rho) = 1, since rho is
                # ~1/lam). The reference skips this and leans on its fixed
                # 20-iteration CG to absorb the shock; with an early-exit
                # residual-stop CG the unrescaled step produced a ~3x
                # objective EXPLOSION at every schedule step (measured
                # iterations 41/53/71 of the tol-10x bench run) that cost
                # ~10 recovery iterations each.
                fac_z = jnp.where(
                    stepped,
                    reg_scl_j[jnp.minimum(cnt_scl + 1, n_sched - 1)]
                    / reg_scl_j[cnt_scl],
                    jnp.float32(1.0))
                cnt_scl = cnt_scl + stepped.astype(jnp.int32)
                cnt_scl_iter = jnp.where(stepped, 0, cnt_scl_iter)
                cd1 = jnp.where(stepped, 6, cd1)
                return q, scl, cnt_scl, cnt_scl_iter, cd1, nveto, nsat, fac_z

            (q, scl, cnt_scl, cnt_scl_iter, cd1, nveto, nsat,
             fac_z) = jax.lax.cond(
                done_now, lambda a: a, tail,
                (st.q, st.scl, st.cnt_scl, st.cnt_scl_iter, st.countdown1,
                 st.n_vetoed, st.n_sat, jnp.float32(1.0)))
            z = z * fac_z

            new = FitState(
                ys=ys, z=z, w=w, q=q, scl=scl, jtv=jtv, cdiags=st.cdiags,
                cnt_scl=cnt_scl, cnt_scl_iter=cnt_scl_iter + 1,
                countdown0=cd0, countdown1=cd1,
                n_iter=st.n_iter + 1, done=st.done | done_now,
                prev_obj=o0, obj_max=omax, obj_min=omin,
                has_prev=jnp.bool_(True), n_vetoed=nveto, n_sat=nsat)
            return new, (obj, gain, jnp.bool_(True))

        def frozen_iter(st: FitState):
            return st, (jnp.zeros((3,), jnp.float32), jnp.float32(0.0),
                        jnp.bool_(False))

        def body(st, _):
            # hard stop at max_iter (reference: for n_iter in range(max_iter))
            frozen = st.done | (st.n_iter >= max_iter)
            return jax.lax.cond(frozen, frozen_iter, live_iter, st)

        # refresh the CG preconditioner diagonals once per chunk (tracks
        # rigid drift)
        state = state._replace(
            cdiags=compute_cdiags(state.q, state.scl, taus, pres, posts))
        state, (objs, gains, valid) = jax.lax.scan(
            body, state, None, length=K)
        return state, objs, gains, valid

    jitted = jax.jit(chunk_impl, donate_argnums=(0,))
    # the first call compiles explicitly so fit() can report compile time
    # apart from the chunk's execution time
    stats = {"compile_s": 0.0}
    compiled = []

    def chunk(state, xdats, taus, subdats):
        args = (state, xdats, taus, subdats, geom_args)
        if not compiled:
            t0 = timer()
            compiled.append(jitted.lower(*args).compile())
            stats["compile_s"] = timer() - t0
        return compiled[0](*args)

    chunk.stats = stats

    # exposed for tests / debugging of the per-observation device updates
    chunk._debug = dict(scaling_obs=scaling_obs,
                        maps_from_q=maps_from_q, sub_infos=sub_infos,
                        geom=geom_args)
    # the raw (un-jitted) chunk body: a pure function of
    # (state, xdats, taus, subdats, geom) — parallel.fit_batch shard_maps it
    # over a 'batch' device axis for geometry-homogeneous subject batches
    chunk._impl = chunk_impl
    return chunk


def _obs_maps_np(x, sett, state_q):
    """Host (M, Minv) per observation at the given poses (f64 numpy).

    Poses are centre-conjugated (geometry.rigid_from_q) — MUST match the
    pre/post folding in make_fit_chunk or the host windows and the device
    maps disagree.
    """
    from ..geometry import fov_centre, rigid_from_q

    basis = (sett.rigid_basis if sett.rigid_basis is not None
             else affine_basis("SE"))
    method = sett.method
    q = np.asarray(state_q, np.float64)
    po0 = x[0][0].po
    centre = fov_centre(po0.mat_y, po0.dim_y)
    out = []
    i = 0
    for xc in x:
        for o in xc:
            R = rigid_from_q(q[i], basis, centre)
            M = (o.po.M_sr(R) if method == "super-resolution"
                 else o.po.M_den(R))
            M4 = np.eye(4)
            M4[:3, :4] = M
            out.append((np.asarray(M, np.float64),
                        np.linalg.inv(M4)[:3, :4]))
            i += 1
    return out


def plan_signature(x, sett, state_q, extra_budget: float = 0.0) -> tuple:
    """Push windows for all observations at the given poses (host numpy).

    The only pose-dependent statics of the chunk: the fit loop rebuilds
    (re-traces) it ONLY when this signature changes, and a pose beyond the
    built window changes it.
    """
    from ..ops.resample import push_window

    return tuple(push_window(M, extra=2.0 * extra_budget)
                 for M, _ in _obs_maps_np(x, sett, state_q))
