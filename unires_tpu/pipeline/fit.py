"""Fit orchestrator: chunked device-side outer loop.

Mirrors the reference ``fit`` (unires/run.py:24-207) — lambda schedule with
countdowns and minimum-iteration guards, gain-based convergence, optional
even/odd scaling and unified-rigid updates, FOV cleaning and rigid-matrix
collection — but the per-iteration control flow lives ON DEVICE
(solvers.fitloop): each host round-trip executes K outer iterations, so
dispatch and sync overhead is amortised K-fold. The host's remaining jobs per
chunk: logging, checkpointing, dashboards, and widening the push windows
when a rigid pose is pinned at their edge.
"""
from __future__ import annotations

import os
from timeit import default_timer as timer
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import expm, voxel_size
from ..solvers.admm import admm_aux, make_admm_step, obs_dyn_args, step_size
from ..solvers.fitloop import (FitState, init_state, make_fit_chunk,
                               plan_signature)
from ..utils.log import info
from .structs import XData, YData


def get_gain(obj_trace) -> float:
    """Relative gain of the last step (nitorch get_gain, run.py:100)."""
    v = np.asarray(obj_trace, dtype=np.float64)
    if v.size < 2:
        return float("inf")
    denom = v.max() - v.min()
    if denom == 0:
        return 0.0
    return float((v[-2] - v[-1]) / denom)


def get_sched(N: int, sett):
    """Coarse-to-fine lambda schedule (reference _core.py:288-307)."""
    if sett.sched_num < 0 or N == 1:
        sett.sched_num = 0
    if sett.rigid_mod < 1:
        sett.rigid_mod = 1
    scl = np.atleast_1d(np.asarray(sett.reg_scl, dtype=np.float32))
    if scl.size > 1:
        # explicit schedule given by the user
        sett.reg_scl = scl
        return sett
    sched = 2.0 ** np.arange(31, -1, -1, dtype=np.float32)
    ix = int(np.argmin(np.abs(sched - scl[0])))
    sched = sched[max(ix - sett.sched_num, 0):ix]
    sett.reg_scl = np.concatenate([sched, scl.reshape(1)])
    return sett


def _gather_dyn_taus(x):
    return tuple(tuple(jnp.float32(o.tau) for o in xc) for xc in x)


def _gather_subdats(x, sett):
    """Flat per-observation NN-subsampled volumes for the rigid update
    (reference unires/_update.py:589-593); None where the rigid grids
    coincide with the main grids (rigid_samp=1 on >=1mm data)."""
    from ..models.proj_op import proj_info
    from ..ops.resample import pull

    if not sett.unified_rigid:
        return tuple(None for xc in x for _ in xc)
    out = []
    for xc in x:
        for o in xc:
            po = o.po
            po_sub = proj_info(po.dim_y, po.mat_y, o.dim, o.mat,
                               rigid=po.rigid, prof_ip=sett.profile_ip,
                               prof_tp=sett.profile_tp, gap=sett.gap,
                               scl=po.scl, samp=sett.rigid_samp)
            if po_sub.dim_x == po.dim_x and po_sub.dim_yx == po.dim_yx:
                out.append(None)
            else:
                Ms = jnp.asarray(po_sub.D_x[:3, :4].astype(np.float32))
                out.append(pull(o.dat, Ms, po_sub.dim_x, order=0))
    return tuple(out)


def _sync_state(x, y, sett, state: FitState):
    """Write device state back into the pipeline structs."""
    from ..geometry import fov_centre, rigid_from_q

    qs = np.asarray(state.q, np.float64)
    scls = np.asarray(state.scl, np.float64)
    basis = sett.rigid_basis
    centre = fov_centre(y[0].mat, y[0].dim)
    i = 0
    for xc in x:
        for o in xc:
            o.rigid_q = qs[i]
            if basis is not None:
                # centre-conjugated world transform (geometry.rigid_from_q)
                o.po.rigid = rigid_from_q(qs[i], basis, centre)
            o.po.scl = float(scls[i])
            i += 1
    cnt_scl = int(state.cnt_scl)
    reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
    for c in range(len(y)):
        y[c].dat = state.ys[c]
        y[c].lam = float(reg[min(cnt_scl, reg.size - 1)]) * y[c].lam0


def fit(x: XData, y: YData, sett):
    """Run the iterative solver; returns (y, R, jtv, obj_trace, n_iter).

    Output writing is the caller's job (pipeline.run handles I/O), keeping
    this function free of host I/O so it can be benchmarked cleanly.
    """
    N = sum(len(xc) for xc in x)
    C = len(x)
    sett = get_sched(N, sett)

    # schedule position 0 (host bookkeeping; the device derives lam itself)
    for c in range(C):
        y[c].lam = float(np.atleast_1d(sett.reg_scl)[0]) * y[c].lam0

    jtv = None
    obj_trace = []
    R = np.stack([np.eye(4)] * N)
    n_done = 0
    if sett.max_iter > 0:
        rho0 = step_size(x, y, sett)
        info(sett, "step-size", rho0)

        state = init_state(x, y, sett)
        if sett.resume and sett.checkpoint_path and \
                os.path.exists(sett.checkpoint_path):
            from .checkpoint import load_checkpoint, restore_into

            z, w, st = restore_into(load_checkpoint(sett.checkpoint_path), x, y)
            obj_trace = list(st["obj_trace"])
            state = init_state(x, y, sett, z=z, w=w)
            tr = np.asarray(obj_trace, np.float64).reshape(-1, 3)
            big = float(np.finfo(np.float32).max)
            state = state._replace(
                cnt_scl=jnp.int32(st["cnt_scl"]),
                cnt_scl_iter=jnp.int32(st["cnt_scl_iter"]),
                countdown0=jnp.int32(st["countdown0"]),
                countdown1=jnp.int32(st["countdown1"]),
                n_iter=jnp.int32(st["n_iter"] + 1),
                prev_obj=jnp.float32(tr[-1, 0] if tr.size else 0.0),
                obj_max=jnp.float32(tr[:, 0].max() if tr.size else -big),
                obj_min=jnp.float32(tr[:, 0].min() if tr.size else big),
                has_prev=jnp.bool_(tr.size > 0),
            )

        K = max(1, min(int(getattr(sett, "chunk_iters", 16)), sett.max_iter))
        extra_budget = 0.0
        chunk = make_fit_chunk(x, y, sett, K)
        # built chunks keyed by push-window signature: a rebuild that lands
        # on an already-built window set re-uses its compiled program
        chunk_cache = {plan_signature(x, sett, state.q): chunk}
        xdats = tuple(tuple(o.dat for o in xc) for xc in x)
        taus = _gather_dyn_taus(x)
        subdats = _gather_subdats(x, sett)

        t00 = info(sett, "fit-start", C, N)
        last_ckpt = int(state.n_iter)
        n_vetoed_seen = 0
        n_sat_seen = 0
        veto_streak = 0
        debug_timing = bool(os.environ.get("UNIRES_TPU_TIME_CHUNKS"))
        profiler_ctx = None
        if getattr(sett, "profile_dir", None):
            # device-level tracing (SURVEY §5: the reference has wall-clock
            # prints only; this captures per-kernel timelines viewable in
            # TensorBoard / Perfetto)
            import jax.profiler as _prof

            profiler_ctx = _prof.trace(sett.profile_dir)
            profiler_ctx.__enter__()
        chunk_times = []  # (iters, EXEC seconds) per chunk; bench reads this
        fit.chunk_times = chunk_times  # via the function attribute
        fit.compile_times = []  # compile seconds of each built chunk
        counted_stats = set()  # chunk builds whose compile time was split out
        while True:
            t_chunk = timer()
            state, objs, gains, valid = chunk(state, xdats, taus, subdats)
            if debug_timing:
                import jax as _jax

                _jax.block_until_ready(objs)
                print(f"[chunk exec {timer() - t_chunk:.2f}s]", flush=True)
                t_host = timer()
            # ONE batched host pull for every per-chunk scalar/trace the
            # loop below consumes (each np.asarray/int() would be a separate
            # device->host round-trip)
            (objs, gains, valid, n_iter_h, done_h, n_vetoed_h, n_sat_h,
             q_h) = jax.device_get((objs, gains, valid, state.n_iter,
                                    state.done, state.n_vetoed, state.n_sat,
                                    state.q))
            objs = np.asarray(objs, np.float64)
            gains = np.asarray(gains, np.float64)
            k_live = int(valid.sum())
            elapsed = timer() - t_chunk
            # split trace/compile out of the first call of each built chunk
            # so fit-ll prints TRUE per-iteration wall time, not a
            # compile-inflated chunk average
            st = chunk.stats
            if id(st) not in counted_stats:
                counted_stats.add(id(st))
                fit.compile_times.append(st["compile_s"])
                elapsed = max(elapsed - st["compile_s"], 1e-6)
            chunk_times.append((k_live, elapsed))
            per_iter = elapsed / max(k_live, 1)
            base = int(n_iter_h) - k_live
            t_now = timer()
            for k in range(k_live):
                obj_trace.append(objs[k])
                info(sett, "fit-ll", base + k, objs[k], float(gains[k]),
                     t_now - per_iter)
            # reference verbosity levels 2-3 (_util.py:107-129): per-image
            # rigid q + even/odd scale each round, per-phase timing
            if sett.do_print >= 2 and k_live:
                _sync_state(x, y, sett, state)
                info(sett, "reg-param", x)
                info(sett, "scl-param", x)
            if sett.do_print >= 3 and k_live:
                info(sett, "fit-done", t_chunk)
                # mid-update visualization (reference shows the scaled
                # observation / rigid-aligned volumes inside the scaling and
                # rigid updates, _update.py:325,366,510 — here the updates
                # run on-device, so the chunk boundary surfaces the current
                # reconstruction per channel at the same verbosity level)
                from ..utils.plots import show_slices as _show

                for c in range(C):
                    _show(np.asarray(state.ys[c]),
                          title=f"y (channel {c}) @ iter {int(n_iter_h)}",
                          fig_num=60 + c)

            # optional dashboards (reference run.py:90-99), chunk cadence
            if sett.plot_conv and obj_trace:
                from ..utils.plots import plot_convergence

                plot_convergence(np.asarray(obj_trace))
            if sett.show_jtv:
                from ..utils.plots import show_slices

                show_slices(np.asarray(state.jtv), title="JTV", fig_num=98,
                            cmap="coolwarm")

            n_done = int(n_iter_h)
            done = bool(done_h)

            # -- checkpoint (SURVEY §5 rebuild note; not in the reference) --
            if (sett.checkpoint_every > 0 and sett.checkpoint_path
                    and n_done - last_ckpt >= sett.checkpoint_every):
                from .checkpoint import save_checkpoint

                _sync_state(x, y, sett, state)
                rho_now = step_size(x, y, sett)
                save_checkpoint(sett.checkpoint_path, x, y, state.z, state.w,
                                dict(rho=rho_now,
                                     cnt_scl=int(state.cnt_scl),
                                     cnt_scl_iter=int(state.cnt_scl_iter),
                                     n_iter=n_done - 1,
                                     countdown0=int(state.countdown0),
                                     countdown1=int(state.countdown1),
                                     obj_trace=np.asarray(obj_trace)))
                last_ckpt = n_done

            if done or n_done >= sett.max_iter:
                if done:
                    info(sett, "fit-finish", t00, n_done - 1)
                break

            if debug_timing:
                print(f"[host log+ckpt {timer() - t_host:.2f}s]", flush=True)
                t_host = timer()
            # -- push-window observability: the device counts
            # capacity-vetoed rigid candidates AND saturated line searches
            # (nothing accepted, >=1 veto — the pose is pinned at the window
            # edge). Saturation in consecutive chunks triggers a
            # window-widening rebuild, so a post-coreg residual beyond the
            # window is corrected instead of silently never attempted.
            # Ordinary overshoot vetoes (step 1 rejected, half-step
            # accepted) are logged but do not widen the windows. --
            dv = int(n_vetoed_h) - n_vetoed_seen
            n_vetoed_seen = int(n_vetoed_h)
            ds = int(n_sat_h) - n_sat_seen
            n_sat_seen = int(n_sat_h)
            escalate_on = bool(getattr(sett, "budget_escalate", True))
            veto_streak = veto_streak + 1 if ds > 0 else 0
            if dv > 0 and (sett.do_print >= 1 or debug_timing):
                import sys as _sys

                print(f"OBS: {dv} capacity-vetoed rigid candidate(s) "
                      f"({ds} saturated line search(es)) in chunk ending at "
                      f"iteration {n_done}"
                      + (" -> re-planning"
                         if escalate_on and veto_streak >= 2 else ""),
                      file=_sys.stdout if sett.do_print >= 1 else _sys.stderr)
            if os.environ.get("UNIRES_TPU_DEBUG_Q"):
                qs = np.asarray(q_h, np.float64)
                print(f"[q@{n_done}] " + "; ".join(
                    f"{i}:" + ",".join(f"{v:+.4f}" for v in qs[i])
                    for i in range(qs.shape[0]))
                    + " scl=" + ",".join(
                        f"{v:+.4f}" for v in np.asarray(state.scl)))
            need_replan = escalate_on and veto_streak >= 2
            if need_replan:
                # a saturated pose never moved, so re-centring alone would
                # rebuild the same windows — escalate the budget instead.
                # Capped: unbounded escalation widens every window and
                # compiles ever-larger programs mid-run.
                if extra_budget >= 0.15:
                    if sett.do_print >= 1:
                        print("OBS: pose budget escalation capped at "
                              f"+{extra_budget:.2f} rad; a pose is pinned at "
                              "the window edge (alignment this coarse should "
                              "come from coreg, not the fit loop)")
                    need_replan = False
                    veto_streak = 0
                else:
                    extra_budget += 0.05
            if sett.unified_rigid and need_replan:
                _sync_state(x, y, sett, state)
                sig_now = plan_signature(x, sett, q_h, extra_budget)
                if sig_now in chunk_cache:
                    chunk = chunk_cache[sig_now]
                else:
                    if sett.do_print >= 1:
                        print(f"OBS: re-planning resampling windows at "
                              f"iteration {n_done} (pose drift, budget "
                              f"+{extra_budget:.2f} rad)")
                    # bound device executables: at most TWO live chunks
                    # (current + the one being built)
                    while len(chunk_cache) >= 2:
                        chunk_cache.pop(next(iter(chunk_cache)))
                    chunk = make_fit_chunk(x, y, sett, K, extra_budget)
                    chunk_cache[sig_now] = chunk
                veto_streak = 0
            if debug_timing:
                print(f"[replan check {timer() - t_host:.2f}s]", flush=True)

        if profiler_ctx is not None:
            profiler_ctx.__exit__(None, None, None)
        _sync_state(x, y, sett, state)
        jtv = state.jtv

    # -- clean FOV (reference run.py:162-187; coordinate-range convention
    # g in [0, dim) per axis, matching run.py:171-174 — round-1 ADVICE) --
    if sett.clean_fov:
        for c in range(C):
            dim_y = tuple(int(d) for d in y[c].dim)
            ii = jnp.arange(dim_y[0], dtype=jnp.float32)[:, None, None]
            jj = jnp.arange(dim_y[1], dtype=jnp.float32)[None, :, None]
            kk = jnp.arange(dim_y[2], dtype=jnp.float32)[None, None, :]
            msk = jnp.ones(dim_y, bool)
            for o in x[c]:
                Minv = np.linalg.inv(
                    np.linalg.solve(y[c].mat, o.po.rigid @ o.mat))
                Mj = jnp.asarray(Minv[:3, :4].astype(np.float32))
                for d in range(3):
                    g = Mj[d, 0] * ii + Mj[d, 1] * jj + Mj[d, 2] * kk + Mj[d, 3]
                    msk = msk & (g >= 0) & (g < o.dim[d])
            y[c].dat = jnp.where(msk, y[c].dat, 0.0)

    # -- rigid matrices (reference run.py:195-200); centre-conjugated
    # world transforms, identical as transforms to the reference's
    # expm(q) output --
    from ..geometry import fov_centre as _fov_centre
    from ..geometry import rigid_from_q as _rigid_from_q

    _centre = _fov_centre(y[0].mat, y[0].dim)
    cnt = 0
    for c in range(C):
        for o in x[c]:
            if o.rigid_q is not None and sett.rigid_basis is not None:
                R[cnt] = _rigid_from_q(o.rigid_q, sett.rigid_basis, _centre)
            cnt += 1

    n_done = len(obj_trace)
    return y, R, jtv, np.asarray(obj_trace) if obj_trace else np.zeros((0, 3)), n_done
