"""Full-pipeline + CLI integration tests on synthetic NIfTI files."""
import os
import subprocess
import sys

import numpy as np
import pytest

from phantoms import blob_phantom, degrade

from unires_tpu.geometry import affine_diag
from unires_tpu.pipeline.nifti import load, save


@pytest.fixture(scope="module")
def nifti_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    gt = blob_phantom(dim=(32, 32, 33), amplitude=1000.0, seed=5)
    paths = []
    for c, seed in enumerate((11, 22)):
        x_obs, mat_x, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=30.0,
                                  seed=seed)
        p = str(d / f"chan{c}.nii.gz")
        save(x_obs, p, affine=mat_x)
        paths.append(p)
    return gt, paths, str(d)


def test_preproc_python_api(nifti_inputs, tmp_path):
    gt, paths, _ = nifti_inputs
    from unires_tpu import Settings, preproc

    sett = Settings(vx=1.0, do_coreg=False, do_print=0, max_iter=15,
                    sched_num=0, dir_out=str(tmp_path), write_out=True)
    dat_y, mat_y, pth_y = preproc(paths, sett)
    assert dat_y.shape[-1] == 2
    assert len(pth_y) == 2
    for p in pth_y:
        assert os.path.exists(p)
        assert os.path.basename(p).startswith("u_")
        got, hdr = load(p)
        assert got.shape == dat_y.shape[:3]
        assert np.allclose(hdr.affine, mat_y, atol=1e-4)


def test_cli_end_to_end(nifti_inputs, tmp_path):
    gt, paths, _ = nifti_inputs
    out = str(tmp_path / "out")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import unires_tpu.cli as cli;"
        "cli.run([%r, %r, '--vx','1.0','--dir_out',%r,"
        "'--print_info','0','--tolerance','1e-2','--sched','0',"
        "'--device','cpu'])"
        % (paths[0], paths[1], out)
    )
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=900,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    outs = sorted(os.listdir(out))
    assert any(f.startswith("u_chan0") for f in outs), outs
    assert any(f.startswith("u_chan1") for f in outs), outs


def test_cli_linear_reslice(nifti_inputs, tmp_path):
    gt, paths, _ = nifti_inputs
    out = str(tmp_path / "lin")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import unires_tpu.cli as cli;"
        "cli.run([%r, '--linear', '--dir_out', %r, '--print_info','0',"
        "'--device','cpu'])"
        % (paths[0], out)
    )
    r = subprocess.run([sys.executable, "-c", code], env=dict(os.environ),
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    got, hdr = load(os.path.join(out, "u_chan0.nii.gz"))
    assert got.ndim == 3


def test_write_jtv_and_bids(nifti_inputs, tmp_path):
    gt, paths, _ = nifti_inputs
    from unires_tpu import Settings, init, fit

    sett = Settings(vx=1.0, do_coreg=False, do_print=0, max_iter=4,
                    sched_num=0, dir_out=str(tmp_path), write_out=True,
                    write_jtv=True, bids=True, tolerance=1e-4)
    x, y, sett = init(paths, sett)
    dat_y, mat_y, pth_y, R, label, pth_label = fit(x, y, sett)
    outs = os.listdir(str(tmp_path))
    assert any("space-unires" in f for f in outs), outs
    assert any(f.startswith("jtv_") for f in outs), outs
    assert R.shape == (2, 4, 4)


def test_profiler_trace_written(tmp_path):
    """sett.profile_dir writes a jax.profiler trace during fit (SURVEY §5)."""
    import os

    from phantoms import blob_phantom, degrade
    from unires_tpu import Settings, init
    from unires_tpu.pipeline.fit import fit as fit_solver

    gt = blob_phantom(dim=(16, 16, 17), amplitude=500.0, seed=9)
    x_obs, mat_x, _ = degrade(gt, thick=4.0, noise_sd=20.0, seed=9)
    prof = str(tmp_path / "prof")
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, sched_num=0,
                    reg_scl=4.0, write_out=False, max_iter=2, chunk_iters=2,
                    profile_dir=prof)
    x, y, sett = init([[x_obs, mat_x]], sett)
    fit_solver(x, y, sett)
    found = []
    for root, _, files in os.walk(prof):
        found += [f for f in files if f.endswith((".pb", ".json.gz", ".trace"))
                  or "trace" in f]
    assert found, f"no trace files under {prof}"
