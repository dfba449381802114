"""GPU smoke test: the reconstruction at full size on an NVIDIA card.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --four-gpus   # four GPUs: the batch-sharded fit only

Phases (one GPU):
  1. device      — JAX must see GPUs; prints the card name and power limit.
  2. resampling  — XLA pull / push / pull_grad at 181x217x181 against the
                   C++ oracle (unires_tpu/native), operator adjointness, and
                   each op's time next to a plain device copy of its bytes.
  3. numerics    — one fit chunk's device-composed (3,4) maps against the
                   float64 host maps (catches f32 products run in TF32).
  4. main path   — 3-channel brain-phantom NIfTIs through ``unires_tpu.cli``:
                   ``--linear`` and the full reconstruction; outputs, NLL
                   trace and SR-vs-trilinear MSE are checked.

``--four-gpus`` runs only the multi-device path (``parallel.fit_batch`` on a
('batch',) mesh, as ``--shard batch`` / ``preproc_batch`` reach it) and the
per-subject single-device fits it must reproduce.

Every failed check raises, so the script exits non-zero; the last line of
standard output is the JSON object ``{"ok": true, "device": {...}}`` and is
printed only when every phase passed. Times printed here are smoke readings
of one run, not benchmark numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DIM_Y = (181, 217, 181)
BIGROT = [0.5, 0.2, -0.3, 0.045, -0.04, 0.03]
CHAIN = 10  # op applications per timed run

# tolerances of the CPU tests (tests/test_native.py, tests/test_forward.py,
# tests/test_parity.py, tests/test_fit_batch.py)
TOL_ATOL = 1e-4          # pull/push/pull_grad vs C++, off the knife edge
TOL_EDGE_FRAC = 0.01     # knife-edge mask must stay measure-zero-ish
TOL_ADJ_REL = 2e-5       # <A y, v> vs <y, A^T v>, host float64 sums
TOL_OP_ADJ_REL = 2e-3    # check_adjoint, super-resolution and denoising
TOL_MAP_VOX = 1e-3       # device vs float64 host maps, voxels at grid corners
TOL_NLL_REL = 1e-3       # NLL rise allowed within one lambda segment

# published HBM bandwidth by device_kind (B/s; NVIDIA H100 SXM data sheet)
HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


class Checks:
    """Prints every check of a phase and raises at :meth:`done` if any
    failed, so that one run reports all of the phase's readings."""

    def __init__(self, phase: str):
        self.phase, self.failed = phase, []

    def __call__(self, ok, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failed.append(what)

    def done(self) -> None:
        if self.failed:
            raise SmokeFailure(f"{self.phase}: {len(self.failed)} check(s) "
                               f"failed: {self.failed}")


def _timed(fn, *args, reps: int = 7):
    """Median seconds of ``fn(*args)`` over ``reps`` runs after a warm-up;
    every run ends in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def busy_ns(pdata) -> float:
    """Device busy time of a profiler trace: per GPU plane, the union of the
    event intervals on its stream lines (all its lines if none is named
    ``Stream...``), summed over the planes."""
    total = 0.0
    for plane in pdata.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = ([ln for ln in plane.lines if ln.name.startswith("Stream")]
                 or list(plane.lines))
        end = float("-inf")
        for s, e in sorted((ev.start_ns, ev.end_ns) for ln in lines
                           for ev in ln.events):
            if e > end:
                total += e - max(s, end)
                end = e
    return total


def _kernel_s(fn, *args, reps: int = 7):
    """Device busy seconds of one ``fn(*args)``, averaged over ``reps``
    calls traced by the JAX profiler after a warm-up: kernel time, free of
    the host's launch and sync overhead."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        path, = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                          recursive=True)
        ns = busy_ns(ProfileData.from_file(path))
    if ns <= 0:
        raise SmokeFailure("no GPU kernel in the profiler trace")
    return ns * 1e-9 / reps


def _chain(step, n: int = CHAIN):
    """One jitted program applying ``step`` n times, each application fed
    by the previous one's output; optimization barriers keep XLA from
    fusing the applications or computing only part of an output, so the
    launch and sync overhead of one call is spread over n applications."""
    import jax

    def run(*args):
        for _ in range(n):
            args = jax.lax.optimization_barrier(step(*args))
        return args

    return jax.jit(run)


def _resample_step(op):
    """Chain step: the next application's maps depend on this output."""
    import jax

    def step(data, M, Minv):
        out = jax.lax.optimization_barrier(op(data, M, Minv))
        dep = 0.0 * out.reshape(-1)[0]
        return data, M + dep, Minv + dep

    return step


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def phase_device(count: int | None = None):
    """The JAX devices, refused unless they are GPUs (``count`` of them)."""
    import jax

    devs = jax.devices()
    if any(d.platform != "gpu" for d in devs):
        raise SmokeFailure(
            f"no GPU: JAX reports {[d.platform for d in devs]}")
    if count is not None and len(devs) < count:
        raise SmokeFailure(f"{count} GPUs needed, JAX reports {len(devs)}")
    print(f"device: {devs[0].device_kind} x {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    return devs


# ---------------------------------------------------------------------------
# Phase 2: resampling at full width
# ---------------------------------------------------------------------------

def bench_poses():
    """{name: rigid} — bench.py's channel-0 draw and the 0.045 rad pose."""
    from unires_tpu.geometry import affine_matrix_classic

    return {"bench": _zero_mean_rigids(np.random.default_rng(0))[0],
            "bigrot": affine_matrix_classic(BIGROT)}


def channel_po(dim_y, rigid, thick_axis=2, scl=0.1):
    """bench.py's observation geometry: 4 mm slices along ``thick_axis``."""
    from unires_tpu.geometry import affine_diag
    from unires_tpu.models.proj_op import proj_info

    vx = [1.0, 1.0, 1.0]
    vx[thick_axis] = 4.0
    dim_x = list(dim_y)
    dim_x[thick_axis] = int(np.ceil(dim_y[thick_axis] / 4.0))
    return proj_info(tuple(dim_y), np.eye(4), tuple(dim_x), affine_diag(vx),
                     rigid=rigid, prof_ip=2, prof_tp=0, scl=scl)


def coord_eps(in_dim) -> float:
    """Width of the knife-edge band: 8 float32 ulps of the largest sample
    coordinate. XLA on the card evaluates the affine with fused
    multiply-adds, so its sample coordinates differ from the C++ oracle's by
    a few ulps (~1.5e-5 at 181-voxel coordinates)."""
    return 8.0 * float(np.spacing(np.float32(max(in_dim))))


def _coords(M, idx):
    Mn = np.asarray(M, np.float64)
    return [Mn[d, 0] * idx[0] + Mn[d, 1] * idx[1] + Mn[d, 2] * idx[2]
            + Mn[d, 3] for d in range(3)]


def knife_edge(M, out_dim, in_dim, cells=True):
    """Voxels whose sample point lies within :func:`coord_eps` of the
    field-of-view bound (or, with ``cells``, of a cell boundary): there the
    FOV mask (or the trilinear gradient) flips, and one rounding
    difference legitimately changes the value."""
    eps = coord_eps(in_dim)
    idx = np.meshgrid(*[np.arange(n) for n in out_dim], indexing="ij",
                      sparse=True)
    edge = np.zeros(out_dim, bool)
    for d, g in enumerate(_coords(M, idx)):
        if cells:
            fr = g - np.floor(g)
            edge |= (fr < eps) | (fr > 1 - eps)
        edge |= (np.abs(g + 0.5) < eps) | (np.abs(g - (in_dim[d] - 0.5)) < eps)
    return edge


def push_knife_edge(M, src_dim, vol_dim):
    """Target voxels of push fed by a source on the FOV knife edge."""
    idx = np.nonzero(knife_edge(M, src_dim, vol_dim, cells=False))
    base = [np.floor(g).astype(np.int64) for g in _coords(M, idx)]
    edge = np.zeros(vol_dim, bool)
    for off in np.ndindex(2, 2, 2):
        edge[tuple(np.clip(base[d] + off[d], 0, vol_dim[d] - 1)
                   for d in range(3))] = True
    return edge


def phase_resampling(dim_y=DIM_Y, reps: int = 7, chain: int = CHAIN,
                     kernels: bool = True) -> dict:
    """XLA resampling vs the C++ oracle at the two poses, plus timings: host
    wall always, and with ``kernels`` the device kernel times from a
    profiler trace, the copy's rate set against the card's published HBM
    bandwidth (:data:`HBM_PEAK`)."""
    import jax
    import jax.numpy as jnp

    from unires_tpu.models.forward import (check_adjoint, make_resample_suite,
                                           obs_dyn_args)
    from unires_tpu.native import pull_grad_np, pull_np, push_np

    print(f"phase 2: resampling at {dim_y} (float32; CPU-test tolerances "
          f"off a knife-edge band {coord_eps(dim_y):.3g} voxel wide)",
          flush=True)
    check = Checks("resampling")
    peak = None
    if kernels:
        kind = jax.devices()[0].device_kind
        if kind not in HBM_PEAK:
            raise SmokeFailure(f"no published HBM bandwidth for {kind!r}")
        peak = HBM_PEAK[kind]
    rng = np.random.default_rng(0)
    vol = rng.random(dim_y, dtype=np.float32)
    volj = jnp.asarray(vol)
    copy_run = _chain(lambda a: (a * -1.0,), chain)
    out = {}
    for name, rigid in bench_poses().items():
        po = channel_po(dim_y, rigid)
        suite = make_resample_suite(po, "super-resolution")
        M, Minv = obs_dyn_args(po, "super-resolution")
        src = po.dim_yx
        Mh = np.asarray(M)
        vals = rng.random(src, dtype=np.float32)
        valsj = jnp.asarray(vals)
        print(f" pose {name}: y {dim_y} <-> yx {src}, push window "
              f"{suite['window']}", flush=True)

        def compare(op, got, want, edge):
            diff = np.abs(got - want)
            diff = diff.max(axis=-1) if diff.ndim == 4 else diff
            off = float(diff[~edge].max()) if (~edge).any() else 0.0
            check(off <= TOL_ATOL and edge.mean() < TOL_EDGE_FRAC,
                  f"{op} vs C++: max |diff| off the knife edge {off:.3g} "
                  f"(tol {TOL_ATOL:g}); knife-edge share {edge.mean():.3g} "
                  f"(tol < {TOL_EDGE_FRAC:g}); share off by >1e-5 "
                  f"{np.mean(diff > 1e-5):.3g}")

        got = np.asarray(suite["pull"](volj, M))
        pull_ref = pull_np(vol, Mh, src)
        compare("pull", got, pull_ref, knife_edge(Mh, src, dim_y, False))
        got = np.asarray(suite["push"](valsj, M, Minv))
        compare("push", got, push_np(vals, Mh, dim_y),
                push_knife_edge(Mh, src, dim_y))
        lhs = float(np.dot(pull_ref.ravel().astype(np.float64),
                           vals.ravel()))
        rhs = float(np.dot(got.ravel().astype(np.float64), vol.ravel()))
        rel = abs(lhs - rhs) / abs(lhs)
        check(rel < TOL_ADJ_REL, f"<pull_C++ y, v> vs <y, push v>: rel gap "
              f"{rel:.3g} (tol {TOL_ADJ_REL:g}, float64 host sums)")
        compare("pull_grad", np.asarray(suite["pull_grad"](volj, M)),
                pull_grad_np(vol, Mh, src), knife_edge(Mh, src, dim_y))

        for method in ("super-resolution", "denoising"):
            d, s = check_adjoint(channel_po(dim_y, rigid), method)
            rel = abs(d) / max(1.0, abs(s))
            check(rel < TOL_OP_ADJ_REL, f"check_adjoint {method}: "
                  f"{rel:.3g} (tol {TOL_OP_ADJ_REL:g})")

        n_y, n_src = int(np.prod(dim_y)), int(np.prod(src))
        for op, fn, data, n_elems in (
                ("pull", lambda d, m, mi: suite["pull"](d, m), volj,
                 n_y + n_src),
                ("push", suite["push"], valsj, n_src + n_y),
                ("pull_grad", lambda d, m, mi: suite["pull_grad"](d, m),
                 volj, n_y + 3 * n_src)):
            nbytes = 4 * n_elems
            op_run = _chain(_resample_step(fn), chain)
            # the copy reads and writes n_copy floats; n_copy is a multiple
            # of 4, without which XLA does not vectorise its loop (an odd
            # length ran at half the rate)
            n_copy = -(-n_elems // 8) * 4
            cbytes = 8 * n_copy
            buf = jnp.zeros((n_copy,), jnp.float32)
            t_op = _timed(op_run, data, M, Minv, reps=reps) / chain
            t_copy = _timed(copy_run, buf, reps=reps) / chain
            rec = out[f"{name}/{op}"] = dict(
                ms=t_op * 1e3, copy_ms=t_copy * 1e3, bytes=nbytes)
            print(f"  {op:9s} host {t_op * 1e3:8.4f} ms {nbytes / t_op:.4g} "
                  f"B/s | copy of the same bytes {t_copy * 1e3:8.4f} ms "
                  f"{cbytes / t_copy:.4g} B/s | share of copy rate "
                  f"{nbytes * t_copy / (cbytes * t_op):.4f} (host wall, "
                  f"median of {reps} runs of {chain})", flush=True)
            if peak is None:
                continue
            k_op = _kernel_s(op_run, data, M, Minv, reps=reps) / chain
            k_copy = _kernel_s(copy_run, buf, reps=reps) / chain
            rec.update(kernel_ms=k_op * 1e3, copy_kernel_ms=k_copy * 1e3)
            print(f"  {'':9s} kernels {k_op * 1e3:8.4f} ms {nbytes / k_op:.4g}"
                  f" B/s, {nbytes / k_op / peak:.4f} of the published "
                  f"{peak:.4g} B/s | copy kernels {k_copy * 1e3:8.4f} ms "
                  f"{cbytes / k_copy:.4g} B/s, {cbytes / k_copy / peak:.4f} | "
                  f"share of copy rate {nbytes * k_copy / (cbytes * k_op):.4f}"
                  f" (profiler trace, mean of {reps} runs of {chain})",
                  flush=True)
    check.done()
    return out


# ---------------------------------------------------------------------------
# Phase 3: numerics of the device-composed maps
# ---------------------------------------------------------------------------

def phase_numerics(dim_y=DIM_Y) -> float:
    """Fit-chunk maps_from_q vs the float64 host maps at the phase-2 poses;
    returns the worst corner displacement in voxels."""
    import jax
    import jax.numpy as jnp

    from unires_tpu import Settings, init
    from unires_tpu.geometry import (affine_basis, affine_translation,
                                     fov_centre, rigid_log)
    from unires_tpu.solvers.fitloop import _obs_maps_np, make_fit_chunk

    print(f"phase 3: fit-chunk maps vs float64 host maps at {dim_y} "
          f"(tol {TOL_MAP_VOX:g} voxel at the grid corners)", flush=True)
    check = Checks("numerics")
    po = channel_po(dim_y, np.eye(4), scl=0.0)
    rng = np.random.default_rng(1)
    x_obs = (1000.0 * rng.random(po.dim_x)).astype(np.float32)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, write_out=False,
                    max_iter=16)
    x, y, sett = init([[x_obs, po.mat_x]], sett)
    chunk = make_fit_chunk(x, y, sett, K=1)
    maps = jax.jit(chunk._debug["maps_from_q"])
    pres, posts = chunk._debug["geom"][:2]
    basis = affine_basis("SE")
    c = fov_centre(y[0].mat, y[0].dim)
    worst = 0.0
    for name, rigid in bench_poses().items():
        q = rigid_log(affine_translation(-c) @ rigid @ affine_translation(c),
                      basis)[None]
        Ms, Minvs = maps(jnp.asarray(q, jnp.float32), pres, posts)
        (Mh, Minvh), = _obs_maps_np(x, sett, q)
        for what, dev, host, grid in (("M", Ms[0][0], Mh, x[0][0].po.dim_yx),
                                      ("Minv", Minvs[0][0], Minvh,
                                       y[0].dim)):
            corners = np.array([[i, j, k, 1.0] for i in (0, grid[0] - 1)
                                for j in (0, grid[1] - 1)
                                for k in (0, grid[2] - 1)])
            dvox = np.abs((np.asarray(dev, np.float64) - host) @ corners.T)
            err = float(dvox.max())
            worst = max(worst, err)
            check(err < TOL_MAP_VOX, f"pose {name} {what}: max corner "
                  f"displacement {err:.3g} voxel (float32 HIGHEST vs "
                  "float64)")
    check.done()
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the main path through the CLI
# ---------------------------------------------------------------------------

FULL_ARGS = ["--vx", "1.0", "--scale", "--unified_rigid", "--tolerance",
             "1e-4", "--sched", "3", "--reg_scl", "4.0"]


def write_workload(dim_y, out_dir):
    """bench.py's 3-channel protocol as NIfTI files; returns (paths, gts)."""
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from phantoms import brain_phantom
    from unires_tpu.models.forward import proj_apply
    from unires_tpu.pipeline.nifti import save

    rng = np.random.default_rng(0)
    gts = [brain_phantom(dim=tuple(dim_y), contrast=c, amplitude=2000.0,
                         seed=0) for c in ("t1", "t2", "pd")]
    rigids = _zero_mean_rigids(rng)
    paths = []
    for c, ax in enumerate((2, 1, 0)):
        po = channel_po(dim_y, rigids[c], thick_axis=ax)
        x = np.asarray(proj_apply("A", jnp.asarray(gts[c]), po,
                                  "super-resolution"))
        x = x + 75.0 * rng.standard_normal(x.shape).astype(np.float32)
        p = os.path.join(out_dir, f"chan{c}.nii.gz")
        save(x.astype(np.float32), p, affine=po.mat_x)
        paths.append(p)
    return paths, gts


def _zero_mean_rigids(rng, n=3):
    """bench.py:70-75: uniform draws projected to zero Lie-mean."""
    from unires_tpu.geometry import (affine_basis, affine_matrix_classic,
                                     expm, rigid_log)

    basis = affine_basis("SE")
    rps = [rng.uniform(-2, 2, 3).tolist() + rng.uniform(-0.02, 0.02, 3)
           .tolist() for _ in range(n)]
    logs = [rigid_log(affine_matrix_classic(rp), basis) for rp in rps]
    qm = np.mean(logs, axis=0)
    return [expm(lg - qm, basis) for lg in logs]


@contextlib.contextmanager
def _recording(rec: dict):
    """Record init/fit wall time and the fit's results of one CLI call."""
    from unires_tpu.pipeline import run as run_mod

    init0, fit0 = run_mod.init, run_mod._fit

    def init(*a, **k):
        t0 = time.perf_counter()
        out = init0(*a, **k)
        rec["init_s"] = time.perf_counter() - t0
        return out

    def fit(*a, **k):
        t0 = time.perf_counter()
        out = fit0(*a, **k)
        rec["fit_s"] = time.perf_counter() - t0
        rec["obj"], rec["n_iter"] = np.asarray(out[3]), int(out[4])
        return out

    run_mod.init, run_mod._fit = init, fit
    try:
        yield rec
    finally:
        run_mod.init, run_mod._fit = init0, fit0


def nll_rises(obj):
    """(iteration, relative rise) wherever the NLL rises by more than
    TOL_NLL_REL within a lambda segment — tests/test_parity.py's rule:
    schedule steps show as >20% drops of the prior term."""
    obj = np.asarray(obj, np.float64).reshape(-1, 3)
    post, prior = obj[:, 0], obj[:, 2]
    steps = set(np.nonzero(prior[1:] < 0.8 * prior[:-1])[0] + 1)
    return [(i, round(float(post[i] / post[i - 1] - 1.0), 5))
            for i in range(1, len(post))
            if i not in steps and post[i] > post[i - 1] * (1 + TOL_NLL_REL)]


def _mse_vs_gt(check, paths_out, gts, vx):
    """Per-channel MSE of the written outputs against ground truth on the
    output grid; checks grid, affine and finiteness on the way."""
    import jax.numpy as jnp

    from unires_tpu.geometry import voxel_size
    from unires_tpu.ops.resample import affine_to_M, pull
    from unires_tpu.pipeline.nifti import load

    mses = []
    for c, p in enumerate(paths_out):
        dat, hdr = load(p)
        mat = np.asarray(hdr.affine, np.float64)
        check(dat.ndim == 3 and np.allclose(voxel_size(mat), vx, atol=1e-4),
              f"{os.path.basename(p)}: grid {dat.shape}, voxel "
              f"{np.round(voxel_size(mat), 4).tolist()} mm")
        check(bool(np.isfinite(dat).all()), f"{os.path.basename(p)}: "
              "all values finite")
        gt_on = np.asarray(pull(jnp.asarray(gts[c]),
                                affine_to_M(np.linalg.solve(np.eye(4), mat)),
                                dat.shape))
        msk = gt_on > 0
        mses.append(float(np.mean((dat[msk] - gt_on[msk]) ** 2)))
    return mses, mat


def phase_main_path(dim_y=DIM_Y, fit_args=FULL_ARGS, device="gpu") -> dict:
    """--linear and the full reconstruction of the 3-channel workload."""
    import jax

    from unires_tpu.cli import run as cli_run
    from unires_tpu.pipeline.fit import fit as fit_solver

    print(f"phase 4: 3-channel brain phantom {dim_y} through unires_tpu.cli "
          "(smoke readings, not benchmark numbers)", flush=True)
    check = Checks("main path")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, gts = write_workload(dim_y, tmp)
        runs = (("linear", ["--linear", "--print_info", "0"]),
                ("sr", fit_args + ["--print_info", "1"]))
        for name, extra in runs:
            rec = {}
            out_dir = os.path.join(tmp, name)
            t0 = time.perf_counter()
            with _recording(rec):
                dat_y, mat_y, pth_y = cli_run(paths + extra + [
                    "--dir_out", out_dir, "--device", device])
            rec["wall_s"] = time.perf_counter() - t0
            check(len(pth_y) == 3 and all(os.path.exists(p) for p in pth_y),
                  f"{name}: 3 outputs written")
            rec["mse"], mat = _mse_vs_gt(check, pth_y, gts, 1.0)
            check(np.allclose(mat, mat_y, atol=1e-4), f"{name}: written "
                  "affine equals the returned output affine")
            res[name] = rec
    sr, lin = res["sr"], res["linear"]
    rises = nll_rises(sr["obj"])
    check(sr["n_iter"] > 0 and not rises, f"NLL monotone within lambda "
          f"segments over {sr['n_iter']} iterations (tol {TOL_NLL_REL:g} "
          f"relative, tests/test_parity.py's rule); rises {rises}")
    ratios = [s / max(l, 1e-12) for s, l in zip(sr["mse"], lin["mse"])]
    for c, (s, l, r) in enumerate(zip(sr["mse"], lin["mse"], ratios)):
        check(s < l, f"channel {c}: SR MSE {s:.6g} < --linear MSE {l:.6g} "
              f"(ratio {r:.4f}; reference anchor 0.8126, BASELINE.md)")
    compile_s = (fit_solver.compile_times[0]
                 if getattr(fit_solver, "compile_times", None) else 0.0)
    peak = jax.devices()[0].memory_stats() or {}
    print(f"  smoke: --linear wall {lin['wall_s']:.3f} s (init "
          f"{lin['init_s']:.3f} s)")
    print(f"  smoke: SR init {sr['init_s']:.3f} s, fit {sr['fit_s']:.3f} s, "
          f"{sr['n_iter']} iterations, "
          f"{(sr['fit_s'] - compile_s) / sr['n_iter']:.4f} s/iteration "
          f"without the first chunk's compile {compile_s:.3f} s, wall "
          f"{sr['wall_s']:.3f} s")
    print(f"  smoke: peak_bytes_in_use {peak.get('peak_bytes_in_use')} "
          "(over the whole process)")
    check.done()
    return dict(init_s=sr["init_s"], fit_s=sr["fit_s"], n_iter=sr["n_iter"],
                compile_s=compile_s, ratios=ratios,
                peak_bytes=peak.get("peak_bytes_in_use"))


# ---------------------------------------------------------------------------
# --four-gpus: the batch-sharded fit against single-device fits
# ---------------------------------------------------------------------------

def batch_subjects(dim_y, n):
    """n single-channel subjects, one geometry, own noise and pose seeds."""
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from phantoms import brain_phantom
    from unires_tpu.geometry import affine_matrix_classic
    from unires_tpu.models.forward import proj_apply

    gt = jnp.asarray(brain_phantom(dim=tuple(dim_y), contrast="t1",
                                   amplitude=2000.0, seed=0))
    subjects = []
    for b in range(n):
        rng = np.random.default_rng(100 + b)
        rigid = affine_matrix_classic(rng.uniform(-2, 2, 3).tolist()
                                      + rng.uniform(-0.02, 0.02, 3).tolist())
        po = channel_po(dim_y, rigid)
        x = np.asarray(proj_apply("A", gt, po, "super-resolution"))
        x = x + 75.0 * rng.standard_normal(x.shape).astype(np.float32)
        subjects.append([[x.astype(np.float32), po.mat_x]])
    return subjects


def phase_four_gpus(dim_y=DIM_Y, n=4, max_iter=32, chunk_iters=16,
                    **sett_kw) -> dict:
    """fit_batch on a ('batch',) mesh of n devices vs each subject's fit on
    device 0, at the tolerances of tests/test_fit_batch.py."""
    import jax

    from unires_tpu import Settings, init
    from unires_tpu.parallel.fit_batch import batch_mesh, fit_batch
    from unires_tpu.pipeline.fit import fit as fit_solver

    print(f"batch: {n} subjects at {dim_y}, max_iter {max_iter} "
          "(tolerances of tests/test_fit_batch.py)", flush=True)
    check = Checks("batch")
    base = dict(vx=1.0, do_print=0, write_out=False, tolerance=0.0,
                max_iter=max_iter, chunk_iters=chunk_iters, sched_num=3,
                reg_scl=4.0, scaling=True, unified_rigid=True)
    base.update(sett_kw)
    inits = []
    for data in batch_subjects(dim_y, n):
        sb = Settings(**base)
        if inits:  # preproc_batch's rule: subject 0's output grid for all
            y0 = inits[0][1]
            sb.force_y_space = (y0[0].mat, y0[0].dim)
        inits.append(init(data, sb))
    mesh = batch_mesh(n)
    check(mesh.devices.size == n, f"('batch',) mesh over {mesh.devices.size}"
          f" devices")

    singles = []
    t0 = time.perf_counter()
    for x, y, sett in copy.deepcopy(inits):
        y2, R, _, obj, n_iter = fit_solver(x, y, sett)
        singles.append(dict(
            y=[np.asarray(c.dat) for c in y2], R=R, n_iter=n_iter,
            obj=np.asarray(obj, np.float64),
            q=[np.asarray(o.rigid_q) for xc in x for o in xc],
            scl=[o.po.scl for xc in x for o in xc]))
    t_single = time.perf_counter() - t0
    xs, ys = [i[0] for i in inits], [i[1] for i in inits]
    t0 = time.perf_counter()
    results = fit_batch(xs, ys, inits[0][2])
    t_batch = time.perf_counter() - t0

    worst = dict(obj=0.0, y=0.0, q=0.0, scl=0.0, R=0.0)
    for b, (ref, (yb, Rb, _, objb, n_iter_b)) in enumerate(
            zip(singles, results)):
        check(n_iter_b == ref["n_iter"], f"subject {b}: iterations "
              f"{n_iter_b} == {ref['n_iter']}")
        objb = np.asarray(objb, np.float64)
        rel = float(np.max(np.abs(objb - ref["obj"])
                           / np.maximum(np.abs(ref["obj"]), 1e-30)))
        worst["obj"] = max(worst["obj"], rel)
        check(objb.shape == ref["obj"].shape and rel <= 1e-4,
              f"subject {b}: objective rel diff {rel:.3g} (tol 1e-4)")
        for got, want in zip((np.asarray(c.dat) for c in yb), ref["y"]):
            err = float(np.abs(got - want).max() / np.abs(want).max())
            worst["y"] = max(worst["y"], err)
            check(err <= 1e-3, f"subject {b}: volume max diff {err:.3g} x "
                  "scale (tol 1e-3)")
        q_got = [np.asarray(o.rigid_q) for xc in xs[b] for o in xc]
        scl_got = [o.po.scl for xc in xs[b] for o in xc]
        for key, got, want in (("q", q_got, ref["q"]),
                               ("scl", scl_got, ref["scl"]),
                               ("R", Rb, ref["R"])):
            err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
            worst[key] = max(worst[key], err)
            check(err <= 1e-4, f"subject {b}: {key} max diff {err:.3g} "
                  "(tol 1e-4)")
    print(f"  smoke: {n} single-device fits {t_single:.3f} s; batch fit on "
          f"{n} devices {t_batch:.3f} s (compile included in both)")
    check.done()
    return dict(worst=worst, t_single=t_single, t_batch=t_batch,
                devices=int(jax.device_count()))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the batch-sharded fit on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    devs = phase_device(4 if args.four_gpus else None)
    import unires_tpu  # noqa: F401  (after the device check: sets the cache)

    if args.four_gpus:
        phase_four_gpus(n=4)
    else:
        phase_resampling()
        phase_numerics()
        phase_main_path()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
