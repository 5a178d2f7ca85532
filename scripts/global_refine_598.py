"""North-star demo at production scale: tuned 598-frame
run -> mesh-parallel global refinement -> before/after ATE + wall time.

The test suite pins the composition only at test scale (test_fused_compose:
"strictly improves"); this script records the full-length number. Runs
entirely on the virtual 8-device CPU mesh (the same validation environment
as the multichip dryrun): the pipeline produces the trajectory + per-frame
tables + map, then ``global_bundle_adjust`` (alternate mode, windows over
dp, landmark blocks over lm) refines it and the pose graph stitches.

Usage: python scripts/global_refine_598.py   (idle host! ~10-20 min on 2
cores — the 1226x370 pipeline alone is ~3 fps on CPU)
Env: GR_FRAMES=598 GR_SEED=1 GR_WINDOW=16 GR_OVERLAP=4 GR_ITERS=8
     GR_OUT=artifacts/tuned/global_refine_598.json
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
from pmv_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np

FRAMES = int(os.environ.get("GR_FRAMES", "598"))
SEED = int(os.environ.get("GR_SEED", "1"))
WINDOW = int(os.environ.get("GR_WINDOW", "16"))
OVERLAP = int(os.environ.get("GR_OVERLAP", "4"))
ITERS = int(os.environ.get("GR_ITERS", "8"))
OUT = Path(os.environ.get("GR_OUT", "artifacts/tuned/global_refine_598.json"))
SHAPE = (370, 1226)


def ate_of(pipe) -> float:
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1))))


def main() -> None:
    from pmv_tpu.config import VOConfig
    from pmv_tpu.io import synthetic
    from pmv_tpu.parallel import global_refine, mesh as mesh_lib
    from pmv_tpu.pipeline.odometry import OdometryPipeline

    d = REPO / ".bench_data" / f"seq_{FRAMES}_{SHAPE[0]}x{SHAPE[1]}"
    if not (d / "ok").exists():
        seq = synthetic.make_sequence(
            n_frames=FRAMES, shape=SHAPE, K=synthetic.KITTI_K,
            density=150.0, speed=1.0, yaw_rate=0.004, seed=0,
        )
        synthetic.write_kitti_layout(seq, d)
        (d / "ok").touch()

    cfg = VOConfig(
        image_dir=str(d / "image_0"),
        camera_calibration=str(d / "calib.txt"),
        poses=str(d / "poses.txt"),
        camera=0, frames=FRAMES, init_frames=5,
        min_tracked_features=400, tracked_features_tol=150,
        bundle_size=5, max_iterations=5,
        feature_capacity=512, map_capacity=8192,
        verbose=0, seed=SEED,
    )
    pipe = OdometryPipeline(cfg)
    t0 = time.perf_counter()
    result = pipe.run()
    t_pipe = time.perf_counter() - t0
    ate_before = ate_of(pipe)
    print(
        f"pipeline: {result['frames']} frames in {t_pipe:.1f} s, "
        f"ATE before {ate_before:.2f} m",
        flush=True,
    )

    m = mesh_lib.make_mesh(dp=2, lm=4)
    t0 = time.perf_counter()
    global_refine.global_bundle_adjust(
        pipe, m, window=WINDOW, overlap=OVERLAP, iters=ITERS
    )
    t_refine = time.perf_counter() - t0
    ate_after = ate_of(pipe)

    rec = {
        "frames": result["frames"],
        "seed": SEED,
        "config": "tuned 5/5 (bench.py defaults)",
        "mesh": "dp=2 x lm=4 (8-device CPU mesh)",
        "window": WINDOW, "overlap": OVERLAP, "iters": ITERS,
        "ate_before_m": round(ate_before, 2),
        "ate_after_m": round(ate_after, 2),
        "improvement_pct": round(100 * (1 - ate_after / max(ate_before, 1e-9)), 1),
        "t_total_before": round(result["t_total"], 1),
        "wall_pipeline_s": round(t_pipe, 1),
        "wall_refine_s": round(t_refine, 1),
    }
    print(json.dumps(rec), flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    existing = json.loads(OUT.read_text()) if OUT.exists() else []
    existing.append(rec)
    OUT.write_text(json.dumps(existing, indent=1) + "\n")


if __name__ == "__main__":
    main()
