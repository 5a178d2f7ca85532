"""Pallas LK kernel (Triton route) vs the XLA tap-matrix tracker.

The kernel runs in the Pallas interpreter here (``interpret=True``); the
compiled kernel is checked on the card by tests/test_gpu.py."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pmv_tpu.frontend import corners, image, lucas_kanade as lk, pallas_lk
from pmv_tpu.io import synthetic


def _setup(n_frames=3, seed=2, n_per_tile=48):
    seq = synthetic.make_sequence(
        n_frames=n_frames, shape=(128, 192), density=30, seed=seed
    )
    imgs = [jnp.asarray(f) for f in seq["images"]]
    xy, score, valid = corners.grid_extract(
        imgs[0], n_per_tile=n_per_tile, tile_h=128, tile_w=192
    )
    pyrs = [image.build_pyramid(im, 3) for im in imgs]
    return imgs, xy, valid, pyrs


def _track(blocks, pyr, xy, valid, win):
    return pallas_lk.track_cached(blocks, pyr, xy, valid, win=win, interpret=True)


class TestPallasLK:
    def test_matches_xla_tracker(self):
        imgs, xy, valid, pyrs = _setup()
        win = 15

        ref_blocks = lk.capture_blocks(tuple(pyrs[0]), xy, win=win)
        pal_blocks = pallas_lk.capture_blocks(tuple(pyrs[0]), xy, win=win)
        ref_xy, ref_st, ref_blocks = lk.track_cached(
            ref_blocks, pyrs[1], xy, valid, win=win
        )
        pal_xy, pal_st, pal_blocks = _track(pal_blocks, pyrs[1], xy, valid, win)
        both = np.asarray(ref_st) & np.asarray(pal_st)
        assert both.sum() >= int(np.asarray(ref_st).sum()) * 0.95
        np.testing.assert_allclose(
            np.asarray(pal_xy)[both], np.asarray(ref_xy)[both], atol=5e-3
        )

        # second hop: templates come from blocks captured DURING tracking
        ref2_xy, ref2_st, _ = lk.track_cached(
            ref_blocks, pyrs[2], ref_xy, ref_st, win=win
        )
        pal2_xy, pal2_st, _ = _track(pal_blocks, pyrs[2], pal_xy, pal_st, win)
        both2 = np.asarray(ref2_st) & np.asarray(pal2_st)
        assert both2.sum() >= int(np.asarray(ref2_st).sum()) * 0.9
        np.testing.assert_allclose(
            np.asarray(pal2_xy)[both2], np.asarray(ref2_xy)[both2], atol=2e-2
        )

    def test_blocks_extend_the_tap_regions(self):
        """Feature-major (N, B, B) blocks: the tap tracker's (N, Rg, Rg)
        regions at the same origins, plus B - Rg rows/cols of image."""
        _, xy, valid, pyrs = _setup(n_frames=2)
        win = 15
        search = lk._resolve_search(win, None)
        Rg, B = lk.region_size(win, search), pallas_lk.block_size(win, search)
        ref = lk.capture_blocks(tuple(pyrs[0]), xy, win=win)
        got = pallas_lk.capture_blocks(tuple(pyrs[0]), xy, win=win)
        for (rb, rr, rc), (kb, kr, kc) in zip(ref, got):
            assert kb.shape == (xy.shape[0], B, B)
            np.testing.assert_array_equal(np.asarray(kr), np.asarray(rr))
            np.testing.assert_array_equal(np.asarray(kc), np.asarray(rc))
            np.testing.assert_array_equal(np.asarray(kb)[:, :Rg, :Rg], np.asarray(rb))

    def test_non_power_of_two_features(self):
        """N = 33: one program per feature, no padding of N."""
        imgs, xy, valid, pyrs = _setup()
        n = 33
        xy33, valid33 = xy[:n], valid[:n]
        blocks = pallas_lk.capture_blocks(tuple(pyrs[0]), xy33, win=15)
        pal_xy, pal_st, _ = _track(blocks, pyrs[1], xy33, valid33, 15)
        ref_blocks = lk.capture_blocks(tuple(pyrs[0]), xy33, win=15)
        ref_xy, ref_st, _ = lk.track_cached(ref_blocks, pyrs[1], xy33, valid33, win=15)
        both = np.asarray(ref_st) & np.asarray(pal_st)
        assert both.sum() >= 1
        np.testing.assert_allclose(
            np.asarray(pal_xy)[both], np.asarray(ref_xy)[both], atol=5e-3
        )

    def test_invalid_slots_stay_invalid(self):
        imgs, xy, valid, pyrs = _setup(n_frames=2)
        valid1 = jnp.zeros_like(valid).at[0].set(valid[0])
        blocks = pallas_lk.capture_blocks(tuple(pyrs[0]), xy, win=15)
        _, st, _ = _track(blocks, pyrs[1], xy, valid1, 15)
        assert not bool(st[1:].any())

    def test_win32_matches_tap(self):
        """The reference-parity window (win 32 = one full 32 x 32 tile)."""
        imgs, xy, valid, pyrs = _setup()
        win = 32
        ref_blocks = lk.capture_blocks(tuple(pyrs[0]), xy, win=win)
        pal_blocks = pallas_lk.capture_blocks(tuple(pyrs[0]), xy, win=win)
        ref_xy, ref_st, _ = lk.track_cached(ref_blocks, pyrs[1], xy, valid, win=win)
        pal_xy, pal_st, _ = _track(pal_blocks, pyrs[1], xy, valid, win)
        both = np.asarray(ref_st) & np.asarray(pal_st)
        assert both.sum() >= int(np.asarray(ref_st).sum()) * 0.95
        np.testing.assert_allclose(
            np.asarray(pal_xy)[both], np.asarray(ref_xy)[both], atol=5e-3
        )

    def test_level_min_eig_matches_template_stats(self):
        """The kernel's template statistics equal lucas_kanade's on the
        same sampled template (iters=0: the guess comes back unchanged)."""
        _, xy, valid, pyrs = _setup(n_frames=2)
        win, search = 15, 7
        img = pyrs[0][0]
        PAD = lk._pad_for(win, search)
        blk, r0, c0 = pallas_lk._capture(img, xy, win, search)
        half = (win - 1) / 2.0
        raw_r = xy[:, 1] + PAD - half - 1.0 - r0
        raw_c = xy[:, 0] + PAD - half - 1.0 - c0
        lim = lk.region_size(win, search) - (win + 2) - 1e-5
        zero = jnp.zeros_like(raw_r)
        scal = jnp.stack([raw_r, raw_c, xy[:, 1], xy[:, 0], zero, zero, zero, zero], -1)
        out = pallas_lk.level_call(blk, blk, scal, win=win, iters=0, interpret=True)
        F = lk._sample_window(
            blk, jnp.clip(raw_r, 0.0, lim), jnp.clip(raw_c, 0.0, lim), win + 2
        )
        want = lk._template_stats(F, win)[-1]
        np.testing.assert_allclose(np.asarray(out[:, 2]), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(np.asarray(out[:, 0]), np.asarray(xy[:, 1]))

    def test_block_geometry_and_window_limit(self):
        assert pallas_lk.tile(21) == 32 and pallas_lk.tile(32) == 32
        assert pallas_lk.block_size(21, 10) == lk.region_size(21, 10) + 11 == 66
        assert pallas_lk.supports(32) and not pallas_lk.supports(33)
        _, xy, valid, pyrs = _setup(n_frames=2)
        with pytest.raises(ValueError, match="win <= 32"):
            pallas_lk.track_cached(
                lk.capture_blocks(tuple(pyrs[0]), xy, win=33), pyrs[1], xy, valid,
                win=33, interpret=True,
            )


def test_fused_pipeline_with_pallas_lk(monkeypatch):
    """chunk_step with lk_impl='pallas' (kernel interpreted) must stay
    close to the tap-matrix path over a short fused run."""
    from pmv_tpu.core.state import FeatureTable, MapState
    from pmv_tpu.frontend.corners import grid_extract, select_top
    from pmv_tpu.frontend.image import build_pyramid
    from pmv_tpu.pipeline import fused

    level_call = pallas_lk.level_call
    monkeypatch.setattr(
        pallas_lk, "level_call",
        lambda *a, **k: level_call(*a, **{**k, "interpret": True}),
    )
    H, W, N, M, C = 96, 160, 128, 512, 4
    seq = synthetic.make_sequence(n_frames=C + 1, shape=(H, W), density=40, seed=3)
    img0 = jnp.asarray(seq["images"][0])
    xy, sc, va = grid_extract(img0, 64, tile_h=H, tile_w=W)
    txy, tsc, tva = select_top(xy, sc, va, N)
    table = FeatureTable(
        xy=txy, valid=tva, landmark=jnp.full((N,), -1, jnp.int32), score=tsc
    )
    K = jnp.asarray(seq["K"], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    gts = jnp.ones(C, jnp.float32)
    imgs_u8 = jnp.asarray(seq["images"][1:].astype(np.uint8))

    outs = {}
    for impl in ("tap", "pallas"):
        # lk_iters=7 keeps this program's jit cache entry apart from other
        # tests' (the interpreted kernel is patched in at trace time).
        cfg = fused.StepConfig(
            lk_levels=2, lk_window=15, lk_iters=7, tile_h=H, tile_w=W,
            n_per_tile=64, tracked_tol=48, e_hypos=64, pnp_hypos=64,
            bundle_size=3, ba_iters=3, traj_cap=16, lk_impl=impl,
        )
        state = fused.init_state(
            pyr=tuple(build_pyramid(img0, cfg.lk_levels)),
            table=table, map_state=MapState.empty(M), cfg=cfg,
        )
        s, _ = fused.chunk_step(state, imgs_u8, gts, keys, K, cfg)
        outs[impl] = np.asarray(s.t_hist[: C + 1])

    # trackers agree to ~1e-2 px -> trajectories agree to small tolerance
    np.testing.assert_allclose(outs["pallas"], outs["tap"], atol=0.05)
