"""The fused production path must COMPOSE with the offline layers.

Earlier, ``chunk_step`` kept only the first/last feature
table, so a production run had to be re-run in modular mode before global
refinement or per-frame video annotation could consume it. The fused state
now persists every frame's table on device (StepState.tbl_*_hist, the
analogue of the reference annotating every frame during the run,
OdometryPipeline.cpp:117-124); these tests pin the contract:

- per-frame tables exist after a chunked run and are identical across chunk
  sizes (scan-boundary correctness);
- a drifted chunked run is strictly improved by global_bundle_adjust;
- the fancy-video path draws the CURRENT frame's landmark-bound crosses and
  a live per-frame landmark map layer (drawMap semantics,
  OdometryPipeline.cpp:110-127).
"""

import numpy as np
import pytest

from pmv_tpu.config import VOConfig
from pmv_tpu.io import synthetic
from pmv_tpu.parallel import global_refine, mesh as mesh_lib
from pmv_tpu.pipeline.odometry import OdometryPipeline

FRAMES = 24
SHAPE = (128, 256)


def _make_cfg(paths, tmp, chunk_frames=8, **kw):
    base = dict(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        frames=FRAMES, init_frames=2, min_tracked_features=200,
        tracked_features_tol=80, bundle_size=5, max_iterations=3,
        feature_capacity=256, map_capacity=2048,
        grid_rows=128, grid_cols=256, lk_window=15,
        chunk_frames=chunk_frames, traj_cap=64,
    )
    base.update(kw)
    return VOConfig(**base)


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused_compose")
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=SHAPE, density=60, seed=5)
    paths = synthetic.write_kitti_layout(seq, tmp)
    pipe = OdometryPipeline(_make_cfg(paths, tmp, chunk_frames=8))
    pipe.run()
    return paths, pipe, tmp


class TestPerFrameTables:
    def test_tables_cover_every_frame(self, fused_run):
        _, pipe, _ = fused_run
        assert len(pipe.tables) == len(pipe.t)
        # Mid-run frames carry live features AND landmark bindings (the
        # inputs drawMap/global refine need).
        for k in range(2, len(pipe.tables) - 1):
            tbl = pipe.tables[k]
            valid = np.asarray(tbl.valid)
            lm = np.asarray(tbl.landmark)
            assert valid.sum() > 0, f"frame {k} has no features"
            assert ((lm >= 0) & valid).sum() > 0, f"frame {k} has no bindings"

    def test_tables_identical_across_chunk_sizes(self, fused_run):
        paths, pipe8, tmp = fused_run
        pipe1 = OdometryPipeline(_make_cfg(paths, tmp, chunk_frames=1))
        pipe1.run()
        assert len(pipe1.tables) == len(pipe8.tables)
        for k, (a, b) in enumerate(zip(pipe1.tables, pipe8.tables)):
            np.testing.assert_array_equal(
                np.asarray(a.valid), np.asarray(b.valid), err_msg=f"frame {k}"
            )
            np.testing.assert_array_equal(
                np.asarray(a.landmark), np.asarray(b.landmark), err_msg=f"frame {k}"
            )
            np.testing.assert_allclose(
                np.asarray(a.xy), np.asarray(b.xy), atol=0, err_msg=f"frame {k}"
            )

    def test_landmark_sets_evolve(self, fused_run):
        """The live map layer must show dots appearing/expiring: different
        frames bind different landmark sets."""
        _, pipe, _ = fused_run

        def bound_set(k):
            tbl = pipe.tables[k]
            lm = np.asarray(tbl.landmark)
            ok = np.asarray(tbl.valid) & (lm >= 0)
            return set(lm[ok].tolist())

        early, late = bound_set(2), bound_set(len(pipe.tables) - 2)
        assert early != late


class TestFusedGlobalRefine:
    def test_refine_improves_drifted_chunked_run(self, fused_run):
        """Fused run
        (chunk_frames=8) -> inject drift -> global_bundle_adjust strictly
        improves."""
        paths, _, tmp = fused_run
        pipe = OdometryPipeline(_make_cfg(paths, tmp, chunk_frames=8))
        pipe.run()
        clean_t = [np.asarray(x).copy() for x in pipe.t]

        rng = np.random.default_rng(7)
        for i in range(2, len(pipe.t)):
            pipe.t[i] = pipe.t[i] + rng.normal(0, 0.3, 3)
            w = rng.normal(0, 0.01, 3)
            th = np.linalg.norm(w)
            k = w / (th + 1e-12)
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
            pipe.R[i] = dR @ pipe.R[i]

        def mean_err(ts):
            return float(
                np.mean([np.linalg.norm(np.asarray(ts[i]) - clean_t[i])
                         for i in range(1, len(ts))])
            )

        before = mean_err(pipe.t)
        m = mesh_lib.make_mesh(dp=2, lm=4)
        global_refine.global_bundle_adjust(pipe, m, window=8, overlap=4, iters=8)
        after = mean_err(pipe.t)
        assert np.isfinite(np.stack(pipe.t)).all()
        assert after < before / 2, f"noise {before} -> {after}"


class TestCompileCacheKey:
    def test_step_config_constant_in_frame_count(self, fused_run):
        """traj_cap (and every other static field) must not depend on
        cfg.frames: the jitted programs are keyed on StepConfig and a fresh
        compile of the chunk program takes a long time."""
        paths, _, tmp = fused_run
        a = OdometryPipeline(_make_cfg(paths, tmp, frames=10))._step_config(SHAPE)
        b = OdometryPipeline(_make_cfg(paths, tmp, frames=FRAMES))._step_config(SHAPE)
        assert a == b

    def test_overflowing_traj_cap_fails_loudly(self, fused_run):
        from pmv_tpu.config import OdometryPipelineException

        paths, _, tmp = fused_run
        pipe = OdometryPipeline(_make_cfg(paths, tmp, frames=4000))
        with pytest.raises(OdometryPipelineException, match="traj_cap"):
            pipe._step_config(SHAPE)


class TestFancyVideo:
    def test_visuals_from_fused_run(self, fused_run, tmp_path):
        """save_run_visuals on a chunked run: AVI exists and every frame had
        landmark-bound features available for crosses + live map dots."""
        paths, pipe, _ = fused_run
        pipe.cfg.video_path = str(tmp_path / "out.avi")
        pipe.cfg.fancy_video = 1
        from pmv_tpu.viz import render

        arts = render.save_run_visuals(pipe, out_dir=tmp_path)
        assert (tmp_path / "out.avi").stat().st_size > 0
        assert "map" in arts
