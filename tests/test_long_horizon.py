"""Long-horizon robustness pin.

The 600-frame heading divergences of round 1 (~25% of seeds, ATE 280-540 m)
were fixed by two mechanisms — decoupled dense reseeding (reseed_tol=300)
and f32 BA gauge Tikhonov. This CI-scale test pins
them: a 200-frame corridor at a reduced frame size, two seeds, fused chunked
loop, asserting rebased ATE under a generous bound (calibrated values are
~3-5 m; a regression of either fix produces tens-to-hundreds of meters).
"""

import numpy as np
import pytest

from pmv_tpu.config import VOConfig
from pmv_tpu.io import synthetic
from pmv_tpu.pipeline.odometry import OdometryPipeline

FRAMES = 200
SHAPE = (192, 512)
ATE_BOUND_M = 20.0


@pytest.mark.parametrize("seed", [0, 1])
def test_200_frame_corridor_stays_on_track(tmp_path, seed):
    seq = synthetic.make_sequence(
        n_frames=FRAMES, shape=SHAPE, density=60.0, speed=1.0,
        yaw_rate=0.004, seed=seed,
    )
    paths = synthetic.write_kitti_layout(seq, tmp_path / f"s{seed}")
    cfg = VOConfig(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        frames=FRAMES, init_frames=3, min_tracked_features=400,
        tracked_features_tol=150, bundle_size=5, max_iterations=5,
        feature_capacity=512, map_capacity=8192,
        grid_rows=192, grid_cols=256, seed=seed, traj_cap=256,
        # Explicit cap keeps this CPU-mesh e2e affordable: the drop-free
        # DEFAULT (P*N = 2560) quadrupled round 4's suite wall time, and a
        # 200-frame window's true unique count sits well under 1024 (the
        # round-3 value this pin was calibrated at). Drop-free default
        # behavior itself is pinned by test_fused_consistency /
        # test_pipeline at small capacities.
        ba_lm_cap=1024,
    )
    pipe = OdometryPipeline(cfg)
    result = pipe.run()
    assert result["frames"] >= FRAMES - cfg.init_frames - 1

    t_est = np.stack(pipe.t)
    assert np.isfinite(t_est).all()
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    ate = float(np.sqrt(np.mean(np.sum(rel**2, axis=1))))
    assert ate < ATE_BOUND_M, f"seed {seed}: ATE {ate:.1f} m (bound {ATE_BOUND_M})"
