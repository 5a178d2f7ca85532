"""Checks that need an NVIDIA GPU: the LK kernel as Triton compiles it,
against the tap tracker. On the CPU test lane they skip; on the card
``python chip_smoke.py`` (phase 5) calls the ``check_*`` functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the card")


def check_auto_resolves_to_kernel():
    from pmv_tpu.pipeline import steps

    assert steps.resolve_lk_impl("auto", jax.default_backend(), 21) == "pallas"


def check_kernel_odd_feature_count():
    pyrs, xy, valid = chip_smoke.lk_inputs(shape=(128, 192), n_feat=33, levels=3)
    chip_smoke.lk_kernel_vs_tap(win=15, inputs=(pyrs, xy, valid))


def check_kernel_win32():
    pyrs, xy, valid = chip_smoke.lk_inputs(shape=(192, 320), n_feat=128, levels=3)
    chip_smoke.lk_kernel_vs_tap(win=32, inputs=(pyrs, xy, valid))


def check_fused_step_kernel_vs_tap():
    from pmv_tpu.core.state import FeatureTable, MapState
    from pmv_tpu.frontend.corners import grid_extract, select_top
    from pmv_tpu.frontend.image import build_pyramid
    from pmv_tpu.io import synthetic
    from pmv_tpu.pipeline import fused

    H, W, N, M, C = 96, 160, 128, 512, 4
    seq = synthetic.make_sequence(n_frames=C + 1, shape=(H, W), density=40, seed=3)
    img0 = jnp.asarray(seq["images"][0])
    txy, tsc, tva = select_top(*grid_extract(img0, 64, tile_h=H, tile_w=W), N)
    table = FeatureTable(xy=txy, valid=tva, score=tsc,
                         landmark=jnp.full((N,), -1, jnp.int32))
    K = jnp.asarray(seq["K"], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    imgs_u8 = jnp.asarray(seq["images"][1:].astype(np.uint8))
    outs = {}
    for impl in ("tap", "pallas"):
        cfg = fused.StepConfig(
            lk_levels=2, lk_window=15, lk_iters=6, tile_h=H, tile_w=W,
            n_per_tile=64, tracked_tol=48, e_hypos=64, pnp_hypos=64,
            bundle_size=3, ba_iters=3, traj_cap=16, lk_impl=impl,
        )
        state = fused.init_state(
            pyr=tuple(build_pyramid(img0, cfg.lk_levels)),
            table=table, map_state=MapState.empty(M), cfg=cfg,
        )
        s, _ = fused.chunk_step(state, imgs_u8, jnp.ones(C, jnp.float32), keys, K, cfg)
        outs[impl] = np.asarray(s.t_hist[: C + 1])
    np.testing.assert_allclose(outs["pallas"], outs["tap"], atol=0.05)


def test_auto_resolves_to_kernel(gpu):
    check_auto_resolves_to_kernel()


def test_kernel_odd_feature_count(gpu):
    check_kernel_odd_feature_count()


def test_kernel_win32(gpu):
    check_kernel_win32()


def test_fused_step_kernel_vs_tap(gpu):
    check_fused_step_kernel_vs_tap()
