"""Strict-parity accuracy sweep at the reference's full workload size.

Runs the REFERENCE-parity configuration — lk_window=32 (OpenCVLucasKanadeFM
.h:9), pnp_thresh=8 px (OpenCVEPnPSolver.cpp:36), e_thresh=1 px
(OpenCVFivePointTri.cpp:24), reseed coupled at tracked_features_tol
(reseed_tol=0, OdometryPipeline.cpp:342), bundle 5 / iterations 5 (the
published 5/5 row, BASELINE.md) — for 600 frames on the synthetic corridor,
over multiple seeds, and writes the reference-format error file per seed
(OdometryPipeline.cpp:285-296 fields). This is exactly the configuration
that diverged on ~25% of seeds before the round-2 gauge/reseed fixes; the
sweep is the evidence that the parity config (not just the tuned defaults)
holds at full length.

Usage: python scripts/parity_sweep.py   (on the GPU; idle host!)
Env: PARITY_SEEDS="0,1,2,3" PARITY_FRAMES=600 PARITY_OUT=artifacts/parity
     PARITY_CONFIG=parity|tuned — ``tuned`` sweeps the TUNED defaults
     (the bench.py configuration: lk_window=21, pnp 3 px, reseed_tol=300)
     instead of the strict-parity overrides.
     PARITY_FAMILY=corridor|photo|stopgo — validation scene family
     ``photo`` adds sensor noise + exposure drift +
     vignetting to the corridor; ``stopgo`` is the stop-go trajectory
     family (traffic-light speed profile). Defaults tuned only on the
     clean corridor get caught by the other two.
     PARITY_OVERRIDES='{"k":v}' — extra VOConfig overrides per run.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from pmv_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np

SEEDS = [int(s) for s in os.environ.get("PARITY_SEEDS", "0,1,2,3").split(",")]
FRAMES = int(os.environ.get("PARITY_FRAMES", "600"))
OUT = Path(os.environ.get("PARITY_OUT", "artifacts/parity"))
SHAPE = (370, 1226)
FAMILY = os.environ.get("PARITY_FAMILY", "corridor")
# Scene families: photometric stress on the corridor, and
# the stop-go trajectory family. Magnitudes sized to real sensors: ~4 DN
# read noise, 25% exposure ramp over the run, 30% corner vignetting.
FAMILY_KW = {
    "corridor": {},
    "photo": dict(noise_std=4.0, exposure_drift=0.25, vignette=0.3),
    "stopgo": dict(stop_every=80, stop_len=10),
}[FAMILY]
OVERRIDES = json.loads(os.environ.get("PARITY_OVERRIDES", "{}"))

PARITY = dict(
    lk_window=32,
    ransac_pnp_thresh=8.0,
    ransac_e_thresh=1.0,
    reseed_tol=0,  # couple reseed to tracked_features_tol like the reference
    bundle_size=5,
    max_iterations=5,
    min_tracked_features=400,
    tracked_features_tol=150,
    init_frames=5,
)

# Tuned defaults = the bench.py configuration: VOConfig defaults plus the
# reference workload knobs (5/5 BA, 400/150 thresholds).
TUNED = dict(
    bundle_size=5,
    max_iterations=5,
    min_tracked_features=400,
    tracked_features_tol=150,
    init_frames=5,
)

if os.environ.get("PARITY_CONFIG", "parity") == "tuned":
    PARITY = TUNED
    OUT = Path(os.environ.get("PARITY_OUT", "artifacts/tuned"))


def build_dataset() -> dict:
    from pmv_tpu.io import synthetic

    suffix = "" if FAMILY == "corridor" else f"_{FAMILY}"
    d = Path(__file__).resolve().parent.parent / ".bench_data" / f"seq_{FRAMES}_{SHAPE[0]}x{SHAPE[1]}{suffix}"
    marker = d / "ok"
    paths = {
        "image_dir": str(d / "image_0"),
        "camera_calibration": str(d / "calib.txt"),
        "poses": str(d / "poses.txt"),
    }
    if marker.exists():
        return paths
    seq = synthetic.make_sequence(
        n_frames=FRAMES, shape=SHAPE, K=synthetic.KITTI_K,
        density=150.0, speed=1.0, yaw_rate=0.004, seed=0, **FAMILY_KW,
    )
    synthetic.write_kitti_layout(seq, d)
    marker.touch()
    return paths


def run_seed(paths: dict, seed: int, frames: int) -> dict:
    from pmv_tpu.config import VOConfig
    from pmv_tpu.pipeline.odometry import OdometryPipeline

    OUT.mkdir(parents=True, exist_ok=True)
    err_path = OUT / f"error_seed{seed}.txt"
    cfg = VOConfig(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        camera=0, frames=frames, feature_capacity=512, map_capacity=8192,
        error_path=str(err_path), seed=seed, **{**PARITY, **OVERRIDES},
    )
    pipe = OdometryPipeline(cfg)
    t0 = time.perf_counter()
    result = pipe.run()
    wall = time.perf_counter() - t0

    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    ate = float(np.sqrt(np.mean(np.sum(rel**2, axis=1))))
    fps = result["frames"] / max(result["runtime"], 1e-9)
    return {
        "seed": seed,
        "family": FAMILY,
        "frames": result["frames"],
        "fps": round(fps, 1),
        "ate_rmse_m": round(ate, 2),
        "t_total": round(result["t_total"], 1),
        "R_total": round(result["R_total"], 3),
        "error_file": str(err_path),
        "lk_impl": cfg.lk_impl,
    }


def main() -> None:
    print(f"device: {jax.devices()[0]}; family {FAMILY}; parity config {PARITY}")
    paths = build_dataset()
    # Warmup at a short length: compiles every program of the parity shape
    # (fresh lk_window=32 programs) so the timed seeds are steady-state.
    warm = run_seed(paths, seed=SEEDS[0], frames=5 + 8 + 6)
    print(f"warmup done: {warm}", flush=True)
    rows = [run_seed(paths, s, FRAMES) for s in SEEDS]
    for r in rows:
        print(json.dumps(r), flush=True)
    suffix = "" if FAMILY == "corridor" else f"_{FAMILY}"
    (OUT / f"summary{suffix}.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
