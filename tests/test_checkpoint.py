"""Checkpoint/resume round-trip tests."""

import numpy as np

from pmv_tpu.config import VOConfig
from pmv_tpu.io import synthetic
from pmv_tpu.pipeline.odometry import OdometryPipeline
from pmv_tpu.utils import checkpoint


def make_pipe(tmp_path, frames=10, n_data_frames=None, **overrides):
    n_data = n_data_frames or frames
    seq = synthetic.make_sequence(n_frames=n_data, shape=(96, 160), density=40, seed=3)
    paths = synthetic.write_kitti_layout(seq, tmp_path / "data")
    cfg = VOConfig(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        frames=frames, init_frames=2, min_tracked_features=150,
        tracked_features_tol=60, bundle_size=4, max_iterations=3,
        feature_capacity=256, map_capacity=1024, grid_rows=96, grid_cols=160,
        lk_window=15, traj_cap=64, **overrides,
    )
    return OdometryPipeline(cfg)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        pipe = make_pipe(tmp_path)
        pipe.run()
        ck = tmp_path / "state.npz"
        checkpoint.save(pipe, ck)

        pipe2 = make_pipe(tmp_path)
        checkpoint.load(pipe2, ck)
        assert pipe2.init_offset == pipe.init_offset
        assert len(pipe2.t) == len(pipe.t)
        np.testing.assert_allclose(np.stack(pipe2.t), np.stack(pipe.t))
        np.testing.assert_allclose(
            np.asarray(pipe2.map.xyz), np.asarray(pipe.map.xyz)
        )
        assert len(pipe2.tables) == len(pipe.tables)
        np.testing.assert_array_equal(
            np.asarray(pipe2.tables[-1].valid), np.asarray(pipe.tables[-1].valid)
        )
        # restored pipeline computes identical error metrics
        pipe2._compute_errors()
        pipe._compute_errors()
        np.testing.assert_allclose(pipe2.errors_t, pipe.errors_t)


class TestFusedCheckpoint:
    def test_step_state_roundtrip_bitwise(self, tmp_path):
        """save_fused_state/load_fused_state preserves EVERY StepState leaf
        bit-for-bit (arrays, dtypes, block tuple structure)."""
        import jax

        pipe = make_pipe(tmp_path, frames=6)
        ck = tmp_path / "fused.npz"
        pipe.cfg.checkpoint_path = str(ck)
        pipe.run()  # final forced snapshot
        state, _ = checkpoint.load_fused_state(ck)
        ck2 = tmp_path / "fused2.npz"
        checkpoint.save_fused_state(state, ck2)
        state2, _ = checkpoint.load_fused_state(ck2)
        for a, b in zip(
            jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(state2)
        ):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_resume_bit_identical_to_uninterrupted(self, tmp_path):
        """A run interrupted mid-sequence and resumed from the snapshot must
        reproduce the uninterrupted trajectory, map, and error metrics
        bit-for-bit (the fused production path)."""
        frames = 14
        # Uninterrupted reference run.
        full = make_pipe(tmp_path, frames=frames, chunk_frames=2)
        res_full = full.run()

        # Interrupted run: stop at frame 8, snapshotting every frame.
        ck = tmp_path / "mid.npz"
        part = make_pipe(
            tmp_path, frames=8, n_data_frames=frames, chunk_frames=2,
            checkpoint_path=str(ck), checkpoint_every=1,
        )
        part.run()
        assert ck.exists()

        # Resume to the full length.
        resumed = make_pipe(
            tmp_path, frames=frames, n_data_frames=frames, chunk_frames=2,
            checkpoint_path=str(ck), resume=1,
        )
        res_resumed = resumed.run()

        assert res_resumed["frames"] == res_full["frames"]
        np.testing.assert_array_equal(np.stack(resumed.t), np.stack(full.t))
        np.testing.assert_array_equal(np.stack(resumed.R), np.stack(full.R))
        np.testing.assert_array_equal(
            np.asarray(resumed.map.xyz), np.asarray(full.map.xyz)
        )
        np.testing.assert_array_equal(
            np.asarray(resumed.tables[-1].xy), np.asarray(full.tables[-1].xy)
        )
        assert res_resumed["t_total"] == res_full["t_total"]
