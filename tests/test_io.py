"""Tests for config parsing, KITTI parsers, PNG codec, synthetic data."""

import numpy as np
import pytest

from pmv_tpu.config import OdometryPipelineException, VOConfig, parse_ini
from pmv_tpu.io import kitti, png, synthetic


class TestConfig:
    def test_parse_ini_reference_format(self, tmp_path):
        cfg_text = """
[Settings]
fancy_video = 1
verbose     = 1
; a comment
# another comment
video_path  = /tmp/tracker.avi
[Odometry]
min_tracked_features = 400
tracked_features_tol = 150
init_frames          = 5
frames               = 600
bundle_size          = 5
map_scale            = 1.5
[ceres]
max_iterations = 5
"""
        p = tmp_path / "cfg.txt"
        p.write_text(cfg_text)
        cfg = parse_ini(p)
        assert cfg["fancy_video"] == "1"
        assert cfg["video_path"] == "/tmp/tracker.avi"
        assert "frames" in cfg

        vo = VOConfig.from_ini(p)
        assert vo.min_tracked_features == 400
        assert vo.frames == 600
        assert vo.map_scale == 1.5
        assert vo.max_iterations == 5

    def test_missing_file_raises(self):
        with pytest.raises(OdometryPipelineException):
            parse_ini("/nonexistent/cfg.txt")

    def test_missing_map_scale_raises(self, tmp_path):
        p = tmp_path / "cfg.txt"
        p.write_text("frames = 10\n")
        with pytest.raises(OdometryPipelineException):
            VOConfig.from_ini(p)


class TestKittiParsers:
    def test_calibration(self, tmp_path):
        P = "7.188560000000e+02 0 6.071928000000e+02 0 0 7.188560000000e+02 1.852157000000e+02 0 0 0 1.000000000000e+00 0"
        calib = "\n".join(f"P{i}: {P}" for i in range(4)) + "\n"
        f = tmp_path / "calib.txt"
        f.write_text(calib)
        K = kitti.parse_calibration(f, 0)
        np.testing.assert_allclose(
            K, [[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]]
        )

    def test_poses(self, tmp_path):
        R = np.eye(3)
        t = np.array([1.0, 2.0, 3.0])
        row = " ".join(str(v) for v in np.concatenate([R, t[:, None]], axis=1).reshape(-1))
        f = tmp_path / "poses.txt"
        f.write_text("\n".join([row] * 5) + "\n")
        gt_R, gt_t = kitti.parse_poses(f, stop=3)
        assert gt_R.shape == (3, 3, 3)
        np.testing.assert_allclose(gt_t[0], t)
        np.testing.assert_allclose(gt_R[0], R)


class TestPNG:
    def test_roundtrip_gray(self, tmp_path, rng):
        img = rng.integers(0, 256, size=(37, 53), dtype=np.uint8)
        f = tmp_path / "x.png"
        png.write_png(f, img)
        back = png.read_png(f)
        np.testing.assert_array_equal(back, img)

    def test_roundtrip_rgb(self, tmp_path, rng):
        img = rng.integers(0, 256, size=(21, 33, 3), dtype=np.uint8)
        f = tmp_path / "x.png"
        png.write_png(f, img)
        back = png.read_png(f)
        np.testing.assert_array_equal(back, img)

    def test_load_grayscale_weights(self, tmp_path):
        img = np.zeros((4, 4, 3), np.uint8)
        img[..., 1] = 100  # G
        f = tmp_path / "g.png"
        png.write_png(f, img)
        gray = png.load_grayscale(f)
        np.testing.assert_allclose(gray, 58.7, atol=0.01)


class TestSynthetic:
    def test_sequence_shapes(self):
        seq = synthetic.make_sequence(n_frames=4, shape=(96, 128), density=20)
        assert seq["images"].shape == (4, 96, 128)
        assert seq["gt_R"].shape == (4, 3, 3)
        assert seq["gt_t"].shape == (4, 3)
        # camera moves ~1 m/frame
        step = np.linalg.norm(np.diff(seq["gt_t"], axis=0), axis=1)
        np.testing.assert_allclose(step, 1.0, atol=1e-6)

    def test_images_have_texture(self):
        seq = synthetic.make_sequence(n_frames=2, shape=(96, 128), density=40)
        assert seq["images"].std() > 1.0

    def test_stopgo_family_actually_stops(self):
        """Stop-go trajectory family: the speed profile must
        ramp to ~0 during stops and recover to full speed between them."""
        R, t = synthetic.make_trajectory(
            100, speed=1.0, stop_every=30, stop_len=8, seed=0
        )
        steps = np.linalg.norm(np.diff(t, axis=0), axis=1)
        assert steps.min() < 0.05  # creeping stop
        assert steps.max() > 0.95  # full cruise recovered
        assert (steps < 0.05).sum() >= 8  # at least one full stop window

    def test_photometric_stressors(self):
        """Exposure drift brightens late frames; vignetting dims corners
        relative to center; both keep pixel values finite and in range."""
        seq = synthetic.make_sequence(
            n_frames=8, shape=(96, 160), density=40, seed=1,
            exposure_drift=0.4, vignette=0.5, noise_std=2.0,
        )
        imgs = seq["images"]
        assert np.isfinite(imgs).all() and imgs.min() >= 0 and imgs.max() <= 255
        # corner gain ~ (1-vignette) x center gain: compare the static
        # background gradient regions (corners vs center band)
        f = imgs[0]
        assert f[:8, :8].mean() < 0.75 * f[44:52, 76:84].mean()
        # drift: same-scene luminance grows over the run (background ramps
        # by up to 40%)
        assert imgs[7].mean() > imgs[0].mean()

    def test_kitti_layout_roundtrip(self, tmp_path):
        seq = synthetic.make_sequence(n_frames=3, shape=(64, 96), density=10)
        paths = synthetic.write_kitti_layout(seq, tmp_path)
        K = kitti.parse_calibration(paths["camera_calibration"], 0)
        np.testing.assert_allclose(K, seq["K"], rtol=1e-10)
        gt_R, gt_t = kitti.parse_poses(paths["poses"])
        np.testing.assert_allclose(gt_t, seq["gt_t"], atol=1e-9)
        imgs = kitti.list_images(paths["image_dir"])
        assert len(imgs) == 3
        img = png.load_grayscale(imgs[0])
        assert img.shape == (64, 96)
