"""chip_smoke.py's phases at tiny sizes on the CPU: the same functions the
card runs at full width, with the LK kernel interpreted and the
multi-device paths on the virtual CPU mesh."""

import jax
import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture
def keep_cache_config():
    """phase_device points the compile cache at its directory; restore the
    test process's settings afterwards."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


@pytest.fixture
def info(keep_cache_config):
    return cs.phase_device(require_gpu=False)


def test_main_refuses_a_backend_without_gpu(keep_cache_config, capsys):
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.main([])
    out = capsys.readouterr().out
    assert "[device]" in out and '"ok": true' not in out


def test_phase_device_names_the_device(info):
    assert info["platform"] == "cpu" and info["count"] == len(jax.devices())
    assert isinstance(info["card"], str) and info["card"]


def test_compare_tracks_accepts_equal_and_rejects_moved():
    xy = np.arange(20, dtype=np.float32).reshape(10, 2)
    st = np.ones(10, bool)
    got = cs.compare_tracks((xy, st), (xy + 1e-3, st))
    assert got == {"max_dxy": pytest.approx(1e-3, rel=1e-3), "status_agree": 1.0,
                   "both": 10}
    with pytest.raises(cs.SmokeFailure, match="max \\|dxy\\|"):
        cs.compare_tracks((xy, st), (xy + 0.5, st))
    flipped = st.copy()
    flipped[:3] = False
    with pytest.raises(cs.SmokeFailure, match="status agreement"):
        cs.compare_tracks((xy, st), (xy, flipped))


def test_lk_kernel_vs_tap_interpreted():
    inputs = cs.lk_inputs(shape=(128, 192), n_feat=24, levels=3)
    res = cs.lk_kernel_vs_tap(win=15, iters=6, interpret=True, inputs=inputs)
    assert set(res) == {"hop1", "hop2"} and res["hop1"]["both"] > 0


def test_lk_tap_device_vs_cpu_device():
    inputs = cs.lk_inputs(shape=(128, 192), n_feat=24, levels=3)
    res = cs.lk_tap_gpu_vs_cpu(win=15, iters=6, inputs=inputs)
    assert res["max_dxy"] == 0.0 and res["status_agree"] == 1.0


def test_ba_window_shapes_and_solve():
    tr, lm, uv, local, mask, free, K = cs.ba_window(P=3, N=32, L_win=64)
    assert tr.shape == (3, 6) and lm.shape == (64, 3) and uv.shape == (3, 32, 2)
    assert local.shape == (3, 32) and mask.all() and free.tolist() == [False, False, True]
    assert not lm[32:].any()
    res = cs.ba_gpu_vs_cpu(iters=3, window=(tr, lm, uv, local, mask, free, K))
    assert res["cost"] < res["cost0"] and res["cost_rel"] == 0.0


def test_four_sharded_ba_on_cpu_mesh(info):
    res = cs.four_sharded_ba(info, Ls=256, P=4, iters=3)
    assert res["L"] == 1024 and res["float32_cost"] < res["float32_cost0"]
    assert res["float64_dpose"] <= 1e-6


def test_four_multi_seq_on_cpu_mesh(info):
    res = cs.four_multi_seq(info, B=4, C=3, shape=(128, 256))
    assert res["B"] == 4 and res["max_dt_m"] <= 0.25


def test_end_to_end_through_the_cli(info, tmp_path):
    res = cs.phase_end_to_end(
        info, out=tmp_path, frames=12, shape=(128, 256), ate_bound=50.0, lk_impl="tap",
        traj_cap=32, map_capacity=2048, min_tracked_features=150,
        tracked_features_tol=60,
    )
    assert res["frames"] + res["init_offset"] == 12 and res["lk_impl"] == "tap"
    assert (tmp_path / "e2e_tap_errors.txt").is_file()
