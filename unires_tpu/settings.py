"""Algorithm settings (reference: unires/struct.py:57-111).

Flag names and defaults are kept identical to the reference ``settings``
class so a UniRes user can port call-sites unchanged. Fields documented as
"derived" are populated by the pipeline itself (reference mutates them at
unires/_core.py:192-195, 258-264, 305 and unires/run.py:240-245).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class Settings:
    alpha: float = 1.0  # relaxation parameter (0,2); <1 under-, >1 over-relaxation
    atlas_rigid: bool = False  # rigid, else rigid+isotropic-scale, atlas alignment
    bids: bool = False  # add BIDS '_space-unires_' tag to outputs
    bound: str = "zero"  # boundary condition for resampling/gradients
    cgs_max_iter: int = 20  # max CG iterations in the y-update
    cgs_tol: float = 1e-3  # CG gain tolerance
    cgs_verbose: bool = False  # per-CG-iteration residual prints (jax.debug.print)
    clean_fov: bool = False  # zero recon voxels outside all low-res FOVs
    coreg_params: dict = dataclasses.field(
        default_factory=lambda: dict(cost_fun="nmi", group="SE", samp=1, fwhm=7.0, mean_space=False)
    )
    coreg_gauge: str = "mean"  # common-frame anchor for co-registration:
    # 'mean' places the aligned frame at the Lie-mean of all input frames
    # (each scanner-pose error enters at weight 1/N — consistent with the
    # mean-space output grid and the fit's mean-centred pose gauge);
    # 'fix' reproduces the reference (frame = image sett.fix, which then
    # carries that image's full pose error into the output placement).
    crop: bool = False  # crop recon FOV to atlas box
    common_output: bool = False  # same output grid across subjects
    ct: bool = False  # input may be CT (negative values meaningful)
    device: str = "gpu"  # JAX platform the CLI runs on ('gpu'|'cuda'|'cpu')
    diff: str = "forward"  # finite-difference type (forward|backward|central)
    dir_out: Optional[str] = None  # output directory (None -> alongside input)
    do_coreg: bool = True  # initial NMI co-registration
    do_atlas_align: bool = False  # initial atlas alignment
    do_print: int = 1  # verbosity 0-3
    do_proj: Optional[bool] = None  # derived: use projection operators?
    do_res_origin: bool = False  # reset origin for CT
    fix: int = 0  # fixed image index for registration
    force_inplane_res: bool = False  # downsample in-plane axes finer than vx
    fov: str = "brain"  # crop FOV ('brain'|'head')
    gap: float = 0.0  # slice gap in [0,1)
    interpolation: int = 1  # API-compat field: the reference itself reads it
    # only in commented-out code (unires/run.py:180); both pipelines are
    # trilinear end-to-end (reset_origin/in-plane reslice take it directly)
    label: Optional[tuple] = None  # (path, (channel, repeat)) of manual labels
    mat: Optional[Any] = None  # affine for 4D array input
    max_iter: int = 512  # max outer (ADMM) iterations
    noise_model: str = "gaussian"  # background-noise fit: gaussian|rician
    method: Optional[str] = None  # derived: 'super-resolution'|'denoising'
    plot_conv: bool = False  # matplotlib live convergence plot
    pow: int = 0  # round output dims up to powers of 2/3 capped at pow
    prefix: str = "u_"  # output filename prefix
    profile_ip: int = 2  # in-plane slice profile (0 rect|1 tri|2 gauss)
    profile_tp: int = 0  # through-plane slice profile
    reg_scl: Any = 4.0  # regularisation scaling (list -> explicit schedule)
    rho: Optional[float] = None  # ADMM step size (None -> estimate)
    rho_scl: float = 1.0  # scaling of estimated rho
    rigid_basis: Optional[Any] = None  # derived: se(3) basis
    rigid_mod: int = 1  # update rigid every rigid_mod iterations
    rigid_gauge_anchor: bool = True  # True (default): mean-centre the pose
    # gauge each rigid round (the reference's mean_correct semantics,
    # unires/_update.py:243-265): the common mode is projected out of the GN
    # steps, and the poses are re-centred when the centred set still lowers
    # the matching term (solvers.fitloop). False: free gauge
    # (the reference fit loop's literal mean_correct=False at run.py:131).
    # Measured at FULL scale (round 4, 181x217x181 3-channel bench): the
    # free gauge lets the pose/recon pair ratchet along the gauge manifold
    # over ~150 interleaved rigid rounds — final poses drifted to ~16 mm /
    # 0.1 rad common mode and PSNR vs ground truth fell 31.4 -> 28.0 dB
    # with an IDENTICAL final NLL (the drift is invisible to the
    # objective). Mean-centring restores 31.1 dB. Round 3's contrary
    # small-scale measurement did not transfer.
    precond: str = "dct"  # CG preconditioner: 'dct' (this rebuild's
    # DCT-diagonal membrane inverse), 'jacobi' (the reference's
    # shipped-but-disabled voxel-diagonal _precond, unires/_update.py:80-102,
    # for A/B parity runs), or 'none'. UNIRES_TPU_PRECOND overrides.
    budget_escalate: bool = True  # auto-widen the push windows when a rigid
    # line search saturates them in consecutive chunks (self-healing pose
    # budget; False = log saturation but never rebuild)
    rigid_samp: int = 1  # sub-sampling (mm) for rigid updates
    scaling: bool = False  # optimise even/odd slice scaling
    sched_num: int = 3  # number of coarse-to-fine lambda scalings
    show_hyperpar: bool = False
    show_jtv: bool = False
    tolerance: float = 1e-4  # outer-loop gain tolerance (0 -> run to max_iter)
    unified_rigid: bool = False  # joint rigid registration during fitting
    vx: Optional[float] = 1.0  # recon voxel size (0/None -> denoise)
    write_jtv: bool = False  # write JTV volume
    write_out: bool = True  # write reconstructions to disk

    # device-loop chunking (not in the reference; the fit loop runs
    # chunk_iters outer iterations per device call — solvers.fitloop)
    chunk_iters: int = 16
    shard: str = ""  # multi-chip sharding (not in the reference — it is
    # single-device, SURVEY §2.3). "" = off. "batch": fit a list of
    # geometry-homogeneous subjects data-parallel over a ('batch',) device
    # mesh (parallel.fit_batch; CLI: --shard with comma-grouped inputs,
    # API: preproc_batch / fit_batch). Each device runs the FULL per-subject
    # algorithm; equality with the single-device fit is pinned by
    # tests/test_fit_batch.py.
    profile_dir: Optional[str] = None  # write a jax.profiler trace of fit here

    # checkpoint/resume (not in the reference, SURVEY §5 rebuild note)
    checkpoint_every: int = 0  # save solver state every N iterations (0=off)
    checkpoint_path: Optional[str] = None  # where to save/load the state
    resume: bool = False  # resume from checkpoint_path if it exists

    force_y_space: Optional[Any] = None  # (mat, dim): reconstruct on this
    # exact output grid instead of the data-derived mean space. Batch mode
    # sets it to subject 0's grid so the batch is geometry-homogeneous; the
    # reference's cross-subject analog is common_output (atlas grid).

    # derived at runtime (not in the reference struct, kept explicit here)
    mat_coreg: Optional[Any] = None
    mat_atlas: Optional[Any] = None

    def copy(self) -> "Settings":
        return dataclasses.replace(self)


# Backwards-friendly alias matching the reference class name.
settings = Settings

_PLATFORMS = {"gpu": "gpu", "cuda": "gpu", "cpu": "cpu"}


def use_device(name: str):
    """Make the first device of platform ``name`` JAX's default device.

    ``name`` is 'gpu', the reference's spelling 'cuda', or 'cpu'. Raises
    ValueError for any other name and RuntimeError when the platform has no
    devices: nothing falls back to another platform silently.
    """
    platform = _PLATFORMS.get(str(name).lower())
    if platform is None:
        raise ValueError(f"unknown device {name!r} (use 'gpu', 'cuda' or "
                         "'cpu')")
    import jax

    try:
        dev = jax.devices(platform)[0]
    except RuntimeError as e:
        raise RuntimeError(f"no {platform} device available: {e}") from e
    if dev != jax.devices()[0]:
        jax.config.update("jax_default_device", dev)
    return dev
