"""Tests for the alternate frontend components (FAST, kNN matcher), the
viz layer, and the pose-graph stitcher."""

import jax.numpy as jnp
import numpy as np

from pmv_tpu.core import geometry as geo
from pmv_tpu.core.state import FeatureTable
from pmv_tpu.frontend import fast, knn_matcher
from pmv_tpu.parallel import pose_graph
from pmv_tpu.viz import render, video
from tests_helpers_blob import blob_image


class TestFAST:
    def test_detects_bright_corner(self):
        img = np.zeros((48, 48), np.float32)
        img[20:28, 20:28] = 200.0  # bright square -> 4 corners
        xy, score, valid = fast.fast_extract(jnp.asarray(img), max_feats=20)
        got = np.asarray(xy[np.asarray(valid)])
        assert len(got) >= 1
        sq_corners = np.array([[20, 20], [27, 20], [20, 27], [27, 27]])
        d = np.abs(got[:, None] - sq_corners[None]).max(-1).min()
        assert d <= 2

    def test_flat_image_no_corners(self):
        img = jnp.full((32, 32), 80.0)
        _, _, valid = fast.fast_extract(img, max_feats=10)
        assert int(valid.sum()) == 0

    def test_scan_order_and_cap(self):
        img = np.zeros((64, 64), np.float32)
        img[10:14, 10:14] = 200.0
        img[40:44, 40:44] = 200.0
        xy, _, valid = fast.fast_extract(jnp.asarray(img), max_feats=2)
        got = np.asarray(xy[np.asarray(valid)])
        assert len(got) == 2
        # first-in-scan-order semantics: capped selection keeps top rows
        assert got[:, 1].max() < 20

    def test_threshold(self):
        img = np.zeros((48, 48), np.float32)
        img[20:28, 20:28] = 8.0  # below default threshold 10
        _, _, valid = fast.fast_extract(jnp.asarray(img), max_feats=20, threshold=10.0)
        assert int(valid.sum()) == 0


class TestKNNMatcher:
    def test_matches_shifted_blobs(self, rng):
        centers = np.stack(
            [rng.uniform(20, 100, 10), rng.uniform(20, 100, 10)], -1
        )
        shift = np.array([4.0, 2.0])
        img0 = blob_image((128, 128), centers, sigma=2.0)
        img1 = blob_image((128, 128), centers + shift, sigma=2.0)
        table = FeatureTable(
            xy=jnp.asarray(np.round(centers).astype(np.float32)),
            valid=jnp.ones(10, bool),
            landmark=jnp.arange(10, dtype=jnp.int32),
            score=jnp.ones(10, jnp.float32),
        )
        cand = np.round(centers + shift).astype(np.float32)
        out = knn_matcher.knn_match(
            jnp.asarray(img0), jnp.asarray(img1), table,
            jnp.asarray(cand), jnp.ones(10, bool), threshold=5.0,
        )
        assert int(out.valid.sum()) == 10
        np.testing.assert_allclose(np.asarray(out.xy), cand, atol=0.5)
        # landmarks inherited
        assert np.asarray(out.landmark).tolist() == list(range(10))

    def test_rejects_bad_match(self, rng):
        img0 = blob_image((64, 64), [(30, 30)], sigma=2.0)
        img1 = np.zeros((64, 64), np.float32)  # nothing to match
        table = FeatureTable(
            xy=jnp.asarray([[30.0, 30.0]]),
            valid=jnp.ones(1, bool),
            landmark=jnp.zeros(1, jnp.int32),
            score=jnp.ones(1, jnp.float32),
        )
        out = knn_matcher.knn_match(
            jnp.asarray(img0), jnp.asarray(img1), table,
            jnp.asarray([[10.0, 10.0]]), jnp.ones(1, bool), threshold=0.5,
        )
        assert int(out.valid.sum()) == 0


class TestViz:
    def test_map_renders(self):
        t_est = [np.array([0.0, 0, 0]), np.array([1.0, 0, -1.0])]
        gt = np.array([[0.0, 0, 0], [1.0, 0, 1.0]])
        m = render.draw_map(t_est, gt, 0, 5.0, landmarks=np.array([[2.0, 0, -3.0]]))
        assert m.shape == (511, 511, 3)
        assert m.sum() > 0  # something drawn

    def test_pose_rectangles_drawn(self):
        """Estimated (green) + GT (red) rotated pose rectangles
        (OdometryPipeline.cpp:130-148)."""
        t_est = [np.array([0.0, 0, 0]), np.array([5.0, 0, -8.0])]
        R_est = [np.eye(3), np.eye(3)]
        gt = np.array([[0.0, 0, 0], [-12.0, 0, 8.0]])
        gt_R = np.stack([np.eye(3), np.eye(3)])
        base = render.draw_map(t_est, gt, 0, 5.0)
        with_rects = render.draw_map(t_est, gt, 0, 5.0, R_est=R_est, gt_R=gt_R)
        # rectangles add green and red pixels beyond the path circles
        extra = (with_rects != base).any(axis=-1)
        assert extra.sum() > 20
        assert (with_rects[extra] == render.GREEN).all(axis=-1).any()
        assert (with_rects[extra] == render.RED).all(axis=-1).any()

    def test_rotated_rect_matches_opencv_layout(self):
        """Vertices must follow cv::RotatedRect::points for a 90-degree
        rotation: a (10, 15) rect rotated 90 deg covers the transposed
        extents around the center."""
        img = np.zeros((64, 64, 3), np.uint8)
        render.draw_rotated_rect(img, (32, 32), (10, 15), 90.0, render.GREEN)
        on = np.argwhere(img.any(axis=-1))
        rows = on[:, 0]
        cols = on[:, 1]
        # height axis is now horizontal: cols span ~15, rows span ~10
        assert 13 <= cols.max() - cols.min() <= 17
        assert 8 <= rows.max() - rows.min() <= 12

    def test_live_map_grows_over_time(self):
        """The fancy-video map must evolve per frame (the reference blends
        the LIVE map, OdometryPipeline.cpp:413-422)."""

        class FakePipe:
            pass

        pipe = FakePipe()
        n = 6
        pipe.t = [np.array([2.0 * i, 0.0, -3.0 * i]) for i in range(n)]
        pipe.R = [np.eye(3) for _ in range(n)]
        pipe.gt_t = np.stack([[2.0 * i, 0.0, 3.0 * i] for i in range(n)])
        pipe.gt_R = np.stack([np.eye(3)] * n)
        pipe.init_offset = 0

        class Cfg:
            map_scale = 5.0

        pipe.cfg = Cfg()
        live = render.LiveMapRenderer(pipe)
        m0 = live.render(0)
        m_mid = live.render(2)
        m_end = live.render(n - 1)
        # strictly growing path coverage
        assert (m0.any(axis=-1)).sum() < (m_mid.any(axis=-1)).sum() < (m_end.any(axis=-1)).sum()
        # final live frame contains everything draw_map draws for the path
        full = render.draw_map(pipe.t, pipe.gt_t, 0, 5.0, R_est=pipe.R, gt_R=pipe.gt_R)
        assert (m_end == full).all()

    def test_annotate(self):
        img = np.zeros((32, 64), np.float32)
        out = render.annotate_frame(img, np.array([[10.0, 10.0], [50.0, 20.0]]),
                                    np.array([True, True]))
        assert out.shape == (32, 64, 3)
        assert (out[10, 8:13] > 0).any()

    def test_avi_roundtrip_header(self, tmp_path):
        w = video.AVIWriter(tmp_path / "x.avi", fps=10)
        for _ in range(3):
            w.add(np.random.default_rng(0).integers(0, 255, (24, 32), np.uint8))
        w.close()
        data = (tmp_path / "x.avi").read_bytes()
        assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
        assert b"movi" in data and b"00db" in data and b"idx1" in data


class TestPoseGraph:
    def test_chain_recovery(self, rng):
        # ground-truth chain of 8 poses with yaw + forward motion
        N = 8
        Rs, ts = [np.eye(3)], [np.zeros(3)]
        for i in range(1, N):
            aa = np.array([0.0, 0.02 * i, 0.0])
            R_d = np.asarray(geo.rodrigues(jnp.asarray(aa)))
            t_d = np.array([0.05, 0.0, -1.0])
            R_new, t_new = geo.compose_delta(
                jnp.asarray(Rs[-1]), jnp.asarray(ts[-1]), jnp.asarray(R_d), jnp.asarray(t_d)
            )
            Rs.append(np.asarray(R_new))
            ts.append(np.asarray(t_new))
        Rs, ts = np.stack(Rs), np.stack(ts)
        # windows of 4 poses overlapping by 2 -> edges
        windows = [list(range(s, s + 4)) for s in range(0, N - 3, 2)]
        E_idx, E_R, E_t = pose_graph.window_edges(
            windows, [Rs[w] for w in windows], [ts[w] for w in windows]
        )
        # noisy initialization, node 0 anchored
        R0 = Rs + rng.normal(0, 0.01, Rs.shape)
        # re-orthogonalize init
        U, _, Vt = np.linalg.svd(R0)
        R0 = U @ Vt
        t0 = ts + rng.normal(0, 0.2, ts.shape)
        R0[0], t0[0] = Rs[0], ts[0]
        anchored = np.zeros(N, bool)
        anchored[0] = True
        R_out, t_out = pose_graph.optimize(
            jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(E_idx),
            jnp.asarray(E_R), jnp.asarray(E_t),
            jnp.ones(len(E_idx)), jnp.asarray(anchored), iters=10,
        )
        np.testing.assert_allclose(np.asarray(t_out), ts, atol=1e-4)
        np.testing.assert_allclose(np.asarray(R_out), Rs, atol=1e-5)


class TestPointCloud:
    def test_median_skim(self):
        from pmv_tpu.viz import pointcloud

        pts = np.array([[1.0, 1, 1], [2, 2, 2], [100.0, 1, 1], [1, 1, 1]])
        kept = pointcloud.median_skim(pts)
        assert len(kept) == 3
        assert not (np.abs(kept) > 50).any()

    def test_ply_roundtrip(self, tmp_path):
        from pmv_tpu.viz import pointcloud

        pts = np.array([[1.0, 2, 3], [4, 5, 6]])
        f = tmp_path / "x.ply"
        pointcloud.write_ply(f, pts)
        text = f.read_text()
        assert text.startswith("ply")
        assert "element vertex 2" in text
        assert "1.0000 2.0000 3.0000" in text


class TestContinuousTriangulation:
    """steps.continuous_triangulate (cont_tri, default OFF): midpoint
    triangulation of unbound tracked slots from two accepted world poses.

    Kept default-off: an e2e A/B showed it cuts
    five-point re-bootstraps ~4x but DEGRADES ATE — the reference design
    re-injects GT scale at every bootstrap (OpenCVFivePointTri.cpp:28-34),
    so suppressing bootstraps removes the pipeline's periodic scale
    anchoring. The geometry itself is exact (this test)."""

    def _poses(self):
        import jax.numpy as jnp

        def pose(yaw, pos):
            c, s = np.cos(yaw), np.sin(yaw)
            return (
                jnp.asarray(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])),
                jnp.asarray(np.array(pos, np.float64)),
            )

        return pose(0.01, [0.1, 0.0, 0.0]), pose(0.03, [0.15, 0.02, -1.0])

    def test_exact_on_perfect_data(self, rng):
        import jax.numpy as jnp

        from pmv_tpu.core import geometry as geo
        from pmv_tpu.core.state import FeatureTable, MapState
        from pmv_tpu.pipeline import steps

        N = 64
        K = jnp.asarray(np.array([[300.0, 0, 160], [0, 300.0, 96], [0, 0, 1]]))
        (R1, t1), (R2, t2) = self._poses()
        X_gt = jnp.asarray(
            np.stack(
                [rng.uniform(-10, 10, N), rng.uniform(-4, 4, N),
                 rng.uniform(-50, -8, N)], -1,
            )
        )
        mk = lambda uv: FeatureTable(
            xy=uv, valid=jnp.ones(N, bool),
            landmark=jnp.full((N,), -1, jnp.int32), score=jnp.ones(N),
        )
        src = mk(geo.project_points(X_gt, R1, t1, K))
        nxt = mk(geo.project_points(X_gt, R2, t2, K))
        s2, n2, m2 = steps.continuous_triangulate(
            src, nxt, MapState.empty(256), R1, t1, R2, t2, K, jnp.asarray(True)
        )
        bound = np.asarray(n2.landmark) >= 0
        assert bound.sum() >= N // 2  # depth/parallax gates pass for most
        Xr = np.asarray(m2.xyz)[np.asarray(n2.landmark)[bound]]
        np.testing.assert_allclose(Xr, np.asarray(X_gt)[bound], atol=1e-4)
        # src slots bound identically
        np.testing.assert_array_equal(
            np.asarray(s2.landmark)[bound], np.asarray(n2.landmark)[bound]
        )

    def test_disabled_is_noop(self, rng):
        import jax.numpy as jnp

        from pmv_tpu.core import geometry as geo
        from pmv_tpu.core.state import FeatureTable, MapState
        from pmv_tpu.pipeline import steps

        N = 16
        K = jnp.asarray(np.array([[300.0, 0, 160], [0, 300.0, 96], [0, 0, 1]]))
        (R1, t1), (R2, t2) = self._poses()
        X_gt = jnp.asarray(
            np.stack(
                [rng.uniform(-5, 5, N), rng.uniform(-2, 2, N),
                 rng.uniform(-30, -8, N)], -1,
            )
        )
        mk = lambda uv: FeatureTable(
            xy=uv, valid=jnp.ones(N, bool),
            landmark=jnp.full((N,), -1, jnp.int32), score=jnp.ones(N),
        )
        src = mk(geo.project_points(X_gt, R1, t1, K))
        nxt = mk(geo.project_points(X_gt, R2, t2, K))
        m = MapState.empty(64)
        s2, n2, m2 = steps.continuous_triangulate(
            src, nxt, m, R1, t1, R2, t2, K, jnp.asarray(False)
        )
        assert not np.asarray(m2.alive).any()
        np.testing.assert_array_equal(np.asarray(n2.landmark), -1)
