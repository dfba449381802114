"""The windowed-gather push and its capacity veto (models.forward).

push is a gather over a static window of candidate source points sized at
the nominal pose; it is the exact adjoint of pull only while the dynamic map
stays inside that window. The fit loop vetoes rigid candidates outside it and
widens the window (``extra_budget``) when a pose is pinned at its edge.
"""
import shutil
import types

import numpy as np
import pytest

from unires_tpu import Settings
from unires_tpu.geometry import affine_matrix_classic
from unires_tpu.models.forward import make_resample_suite, obs_dyn_args
from unires_tpu.models.proj_op import proj_info
from unires_tpu.solvers.fitloop import plan_signature

if shutil.which("g++") is None:
    pytest.skip("no g++ in environment", allow_module_level=True)

from unires_tpu.native import push_np  # noqa: E402

DIM = (20, 22, 24)
SMALL = affine_matrix_classic([0.4, -0.3, 0.2, 0.1, -0.05, 0.03])
LARGE = affine_matrix_classic([0.0, 0.0, 0.0, 0.6, 0.6, 0.6])


def _po():
    return proj_info(DIM, np.eye(4), DIM, np.eye(4), rigid=np.eye(4))


def _push_vs_oracle(suite, po, rigid):
    M, Minv = obs_dyn_args(po, "denoising", rigid)
    vals = np.random.default_rng(0).random(DIM, dtype=np.float32)
    got = np.asarray(suite["push"](vals, M, Minv))
    want = push_np(vals, np.asarray(M), DIM)
    return bool(suite["capacity_ok"](M, Minv)), float(np.abs(got - want).max())


def test_in_window_pose_is_exact():
    po = _po()
    suite = make_resample_suite(po, "denoising")
    assert suite["window"] == (1, 1, 1)
    ok, err = _push_vs_oracle(suite, po, SMALL)
    assert ok and err < 1e-4, err


def test_out_of_window_pose_is_vetoed():
    po = _po()
    suite = make_resample_suite(po, "denoising")
    ok, err = _push_vs_oracle(suite, po, LARGE)
    assert not ok
    assert err > 1e-4  # the veto guards a real loss of exactness


def test_extra_budget_readmits_pose():
    po = _po()
    suite = make_resample_suite(po, "denoising", extra_budget=0.5)
    assert suite["window"] == (2, 2, 2)
    ok, err = _push_vs_oracle(suite, po, LARGE)
    assert ok and err < 1e-4, err


def test_plan_signature_tracks_extra_budget():
    x = [[types.SimpleNamespace(po=_po())]]
    sett = Settings(method="denoising")
    q = np.zeros((1, 6))
    assert plan_signature(x, sett, q) == ((1, 1, 1),)
    assert plan_signature(x, sett, q, extra_budget=0.5) == ((2, 2, 2),)
    assert plan_signature(x, sett, q, 0.5) != plan_signature(x, sett, q)
