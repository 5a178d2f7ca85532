"""Tests for image ops, corner extraction, and Lucas-Kanade tracking."""

import jax.numpy as jnp
import numpy as np
import pytest

from pmv_tpu.frontend import corners, image, lucas_kanade as lk
from pmv_tpu.io import synthetic


def gaussian_blob_img(shape, centers, amp=100.0, sigma=1.5):
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros(shape, np.float32)
    for cx, cy in centers:
        img += amp * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2)))
    return img


class TestImageOps:
    def test_gradient_matches_reference_stencil(self, rng):
        img = jnp.asarray(rng.normal(size=(12, 17)).astype(np.float32))
        gx, gy = image.spatial_gradient(img)
        i = np.asarray(img)
        np.testing.assert_allclose(gx[3, 4], (i[3, 5] - i[3, 3]) / 2, atol=1e-6)
        np.testing.assert_allclose(gy[3, 4], (i[4, 4] - i[2, 4]) / 2, atol=1e-6)
        assert float(jnp.abs(gx[0]).max()) == 0  # zero border
        assert float(jnp.abs(gy[:, 0]).max()) == 0

    def test_box_blur_constant_preserved(self):
        img = jnp.full((10, 10), 7.0)
        np.testing.assert_allclose(image.box_blur3(img), 7.0, atol=1e-5)

    def test_min_eig_peaks_at_corner(self):
        img = jnp.asarray(gaussian_blob_img((32, 32), [(16, 16)]))
        resp = np.asarray(image.min_eig_response(img))
        r, c = np.unravel_index(resp.argmax(), resp.shape)
        assert abs(r - 16) <= 1 and abs(c - 16) <= 1

    def test_min_eig_zero_on_edge_only(self):
        # A vertical edge has gradient in one direction only -> min eig ~ 0
        img = jnp.asarray(np.tile(np.linspace(0, 100, 32), (32, 1)).astype(np.float32) > 50).astype(jnp.float32) * 100
        resp = np.asarray(image.min_eig_response(img))
        mid = resp[10:22, :]
        assert mid.max() < 15.0  # tiny compared to a real corner (~hundreds)

    def test_pyramid_shapes(self):
        img = jnp.zeros((64, 96))
        pyr = image.build_pyramid(img, 3)
        assert [p.shape for p in pyr] == [(64, 96), (32, 48), (16, 24), (8, 12)]


class TestGridExtract:
    def test_finds_planted_corners(self):
        centers = [(20, 15), (50, 40), (100, 30), (80, 70)]
        img = jnp.asarray(gaussian_blob_img((96, 128), centers))
        xy, score, valid = corners.grid_extract(img, n_per_tile=8, tile_h=96, tile_w=128)
        got = np.asarray(xy[np.asarray(valid)])
        for cx, cy in centers:
            d = np.abs(got - [cx, cy]).max(axis=1).min()
            assert d <= 1.0, f"corner ({cx},{cy}) not found (best {d})"

    def test_min_distance_suppression(self):
        # two blobs 3 px apart -> only one survives with min_distance=5
        img = jnp.asarray(gaussian_blob_img((64, 64), [(30, 30), (33, 30)]))
        xy, score, valid = corners.grid_extract(img, n_per_tile=10, tile_h=64, tile_w=64, min_distance=5)
        got = np.asarray(xy[np.asarray(valid)])
        near = got[(np.abs(got - [31, 30]).max(axis=1) < 6)]
        assert len(near) == 1

    def test_tile_spreading(self):
        # corners in two tiles: per-tile quota applies per tile
        img_np = gaussian_blob_img((64, 128), [(20, 20), (30, 40), (90, 20), (100, 40)])
        xy, score, valid = corners.grid_extract(
            jnp.asarray(img_np), n_per_tile=2, tile_h=64, tile_w=64
        )
        got = np.asarray(xy[np.asarray(valid)])
        left = got[got[:, 0] < 64]
        right = got[got[:, 0] >= 64]
        assert len(left) == 2 and len(right) == 2

    def test_select_top(self):
        xy = jnp.asarray(np.arange(10, dtype=np.float32).reshape(5, 2))
        score = jnp.asarray([5.0, 3.0, 9.0, 1.0, 7.0])
        valid = jnp.asarray([True, True, True, True, False])
        top_xy, top_score, top_valid = corners.select_top(xy, score, valid, 3)
        assert top_score.tolist() == [9.0, 5.0, 3.0]
        assert int(top_valid.sum()) == 3


class TestLucasKanade:
    def _shifted_pair(self, shift, shape=(96, 128), n=12, seed=3):
        rng = np.random.default_rng(seed)
        centers = np.stack(
            [rng.uniform(25, shape[1] - 25, n), rng.uniform(25, shape[0] - 25, n)], -1
        )
        img0 = gaussian_blob_img(shape, centers, sigma=2.0)
        img1 = gaussian_blob_img(shape, centers + shift, sigma=2.0)
        return jnp.asarray(img0), jnp.asarray(img1), centers

    def test_subpixel_small_shift(self):
        img0, img1, centers = self._shifted_pair(np.array([1.3, -0.7]))
        pyr0 = image.build_pyramid(img0, 3)
        pyr1 = image.build_pyramid(img1, 3)
        pts = jnp.asarray(centers.astype(np.float32))
        new_pts, status = lk.track(pyr0, pyr1, pts, jnp.ones(len(centers), bool), win=15)
        assert bool(status.all())
        np.testing.assert_allclose(
            np.asarray(new_pts), centers + [1.3, -0.7], atol=0.2
        )

    def test_large_shift_needs_pyramid(self):
        shift = np.array([11.0, 5.0])
        img0, img1, centers = self._shifted_pair(shift)
        pyr0 = image.build_pyramid(img0, 3)
        pyr1 = image.build_pyramid(img1, 3)
        pts = jnp.asarray(centers.astype(np.float32))
        new_pts, status = lk.track(pyr0, pyr1, pts, jnp.ones(len(centers), bool), win=15)
        ok = np.asarray(status)
        assert ok.sum() >= len(centers) - 2
        err = np.abs(np.asarray(new_pts)[ok] - (centers + shift)[ok]).max()
        assert err < 0.5, f"max LK error {err}"

    def test_untextured_region_rejected(self):
        img = jnp.zeros((64, 64))
        pyr = image.build_pyramid(img, 2)
        pts = jnp.asarray([[32.0, 32.0]])
        _, status = lk.track(pyr, pyr, pts, jnp.ones(1, bool), win=15)
        assert not bool(status[0])

    def test_invalid_slots_stay_invalid(self):
        img0, img1, centers = self._shifted_pair(np.array([1.0, 0.0]))
        pyr0 = image.build_pyramid(img0, 2)
        pyr1 = image.build_pyramid(img1, 2)
        pts = jnp.asarray(centers.astype(np.float32))
        valid = jnp.zeros(len(centers), bool).at[0].set(True)
        _, status = lk.track(pyr0, pyr1, pts, valid, win=15)
        assert status.tolist() == [True] + [False] * (len(centers) - 1)

    def test_synthetic_sequence_tracking(self):
        seq = synthetic.make_sequence(n_frames=2, shape=(128, 192), density=30, seed=1)
        img0, img1 = jnp.asarray(seq["images"][0]), jnp.asarray(seq["images"][1])
        xy, score, valid = corners.grid_extract(img0, n_per_tile=64, tile_h=128, tile_w=192)
        pyr0 = image.build_pyramid(img0, 3)
        pyr1 = image.build_pyramid(img1, 3)
        new_xy, status = lk.track(pyr0, pyr1, xy, valid, win=21)
        # most corners should track between consecutive synthetic frames
        assert int(status.sum()) > int(valid.sum()) * 0.5


class TestTrackCached:
    """track_cached (template from cached region blocks) must agree with the
    fresh-template track() and stay accurate over a multi-frame chain."""

    def test_matches_fresh_track(self):
        seq = synthetic.make_sequence(n_frames=3, shape=(128, 192), density=30, seed=2)
        imgs = [jnp.asarray(f) for f in seq["images"]]
        xy, score, valid = corners.grid_extract(imgs[0], n_per_tile=48, tile_h=128, tile_w=192)
        pyrs = [image.build_pyramid(im, 3) for im in imgs]

        blocks = lk.capture_blocks(tuple(pyrs[0]), xy, win=15)
        fresh_xy, fresh_st = lk.track(pyrs[0], pyrs[1], xy, valid, win=15)
        cach_xy, cach_st, blocks = lk.track_cached(blocks, pyrs[1], xy, valid, win=15)
        both = np.asarray(fresh_st) & np.asarray(cach_st)
        assert both.sum() >= int(np.asarray(fresh_st).sum()) * 0.9
        np.testing.assert_allclose(
            np.asarray(cach_xy)[both], np.asarray(fresh_xy)[both], atol=0.05
        )

        # second hop: templates now come from blocks captured DURING tracking
        fresh2_xy, fresh2_st = lk.track(pyrs[1], pyrs[2], cach_xy, cach_st, win=15)
        cach2_xy, cach2_st, _ = lk.track_cached(blocks, pyrs[2], cach_xy, cach_st, win=15)
        both2 = np.asarray(fresh2_st) & np.asarray(cach2_st)
        assert both2.sum() >= int(np.asarray(fresh2_st).sum()) * 0.85
        np.testing.assert_allclose(
            np.asarray(cach2_xy)[both2], np.asarray(fresh2_xy)[both2], atol=0.25
        )


class TestTapSampling:
    def test_tap_window_matches_pointwise_bilinear(self, rng):
        """The tracker's separable tap-matrix sampling at win 21 / search 10
        (Rg 55) equals pointwise bilinear_sample on every window pixel."""
        win, search = 21, 10
        Rg = lk.region_size(win, search)
        assert Rg == 55
        region = jnp.asarray(rng.uniform(0, 255, (6, Rg, Rg)).astype(np.float32))
        lim = Rg - win - 1.000001
        lr = jnp.asarray(rng.uniform(0, lim, 6).astype(np.float32))
        lc = jnp.asarray(rng.uniform(0, lim, 6).astype(np.float32))
        got = np.asarray(lk._sample_window(region, lr, lc, win))
        k = np.arange(win, dtype=np.float32)
        for n in range(6):
            yy, xx = np.meshgrid(float(lr[n]) + k, float(lc[n]) + k, indexing="ij")
            want = lk.bilinear_sample(region[n], jnp.asarray(yy), jnp.asarray(xx))
            np.testing.assert_allclose(got[n], np.asarray(want), rtol=1e-5, atol=1e-3)


class TestLKSelection:
    """steps.resolve_lk_impl: a pure function of (impl, backend, win)."""

    @pytest.mark.parametrize(
        "impl, backend, win, want",
        [
            ("auto", "gpu", 21, "pallas"),
            ("auto", "gpu", 32, "pallas"),
            ("auto", "gpu", 33, "tap"),
            ("auto", "cpu", 21, "tap"),
            ("tap", "gpu", 21, "tap"),
            ("tap", "cpu", 21, "tap"),
            ("pallas", "gpu", 21, "pallas"),
        ],
    )
    def test_resolves(self, impl, backend, win, want):
        from pmv_tpu.pipeline import steps

        assert steps.resolve_lk_impl(impl, backend, win) == want

    @pytest.mark.parametrize("impl, backend", [("pallas", "cpu"), ("bogus", "gpu")])
    def test_refuses(self, impl, backend):
        from pmv_tpu.pipeline import steps

        with pytest.raises(ValueError):
            steps.resolve_lk_impl(impl, backend, 21)

    def test_module_of_each_name(self):
        from pmv_tpu.frontend import pallas_lk
        from pmv_tpu.pipeline import steps

        assert steps.lk_module("tap") is lk
        assert steps.lk_module("pallas") is pallas_lk
