"""chip_smoke.py's phases at small sizes on the CPU.

On the card the script runs them at 181x217x181; here they run at shapes the
CPU handles in seconds, which checks their control flow and their checks.
Only ``main`` insists on a GPU, and it must refuse the CPU.
"""
import numpy as np
import pytest

import chip_smoke


def test_resampling_phase_small():
    out = chip_smoke.phase_resampling((20, 22, 24), reps=1, chain=1,
                                      kernels=False)
    assert sorted(out) == sorted(f"{p}/{op}" for p in ("bench", "bigrot")
                                 for op in ("pull", "push", "pull_grad"))
    assert all(r["ms"] > 0 and r["copy_ms"] > 0 for r in out.values())


def test_numerics_phase_small():
    assert chip_smoke.phase_numerics((20, 22, 24)) < chip_smoke.TOL_MAP_VOX


def test_main_path_phase_small():
    res = chip_smoke.phase_main_path(
        (64, 72, 64), fit_args=["--vx", "1.0", "--tolerance", "1e-2",
                                "--sched", "0"], device="cpu")
    assert res["n_iter"] > 0 and len(res["ratios"]) == 3
    assert max(res["ratios"]) < 1.0


def test_four_device_phase_small():
    res = chip_smoke.phase_four_gpus((48, 52, 48), n=4, max_iter=8,
                                     chunk_iters=4, cgs_max_iter=4)
    assert res["worst"]["obj"] <= 1e-4 and res["worst"]["q"] <= 1e-4


def test_main_refuses_cpu(capsys):
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_nll_rule_is_the_parity_rule():
    post = np.linspace(100.0, 90.0, 30)
    obj = np.stack([post, post / 2, np.full(30, 10.0)], axis=1)
    assert chip_smoke.nll_rises(obj) == []
    bump = obj.copy()
    bump[12, 0] *= 1.02  # a rise within the segment, even if undone at once
    assert [i for i, _ in chip_smoke.nll_rises(bump)] == [12]
    small = obj.copy()
    small[12, 0] = small[11, 0] * (1 + 0.5 * chip_smoke.TOL_NLL_REL)
    assert chip_smoke.nll_rises(small) == []
    step = obj.copy()
    step[20:, 2] = 5.0  # lambda step: the prior term drops by half ...
    step[20, 0] *= 1.5  # ... and a jump at the step itself is no rise
    assert chip_smoke.nll_rises(step) == []


def test_busy_ns_unions_gpu_stream_events():
    from jax.profiler import ProfileData

    def events(*spans):
        return " ".join(f"events {{ metadata_id: 1 offset_ps: {a * 1000} "
                        f"duration_ps: {(b - a) * 1000} }}" for a, b in spans)

    txt = ('planes { name: "/device:GPU:0" '
           f'lines {{ name: "Stream #1" {events((0, 10), (5, 20))} }} '
           f'lines {{ name: "Stream #2" {events((30, 40))} }} '
           f'lines {{ name: "XLA Modules" {events((0, 40))} }} '
           'event_metadata { key: 1 value { id: 1 name: "k" } } } '
           'planes { name: "/host:CPU" '
           f'lines {{ name: "python" {events((0, 100))} }} }}')
    # stream events only, overlaps counted once, host plane ignored
    assert chip_smoke.busy_ns(ProfileData.from_text_proto(txt)) == 30.0
