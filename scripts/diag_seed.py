"""Divergence diagnostic for a single (config, seed) run.

Runs the tuned-default configuration at full length with verbose stats,
then dumps per-frame trajectory error vs ground truth and the per-frame
stats stream (tracked / n3d / branch / inliers / gate) so a divergence can
be localized to a frame and a mechanism (lost tracks -> re-triangulation
with wrong heading vs gate failure vs BA drag).

Usage: python scripts/diag_seed.py           (idle host!)
Env: DIAG_SEED=1 DIAG_FRAMES=598 DIAG_OUT=artifacts/diag
"""

from __future__ import annotations

import io
import json
import os
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pmv_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np

SEED = int(os.environ.get("DIAG_SEED", "1"))
FRAMES = int(os.environ.get("DIAG_FRAMES", "598"))
OUT = Path(os.environ.get("DIAG_OUT", "artifacts/diag"))
SHAPE = (370, 1226)
OVERRIDES = json.loads(os.environ.get("DIAG_OVERRIDES", "{}"))


def main() -> None:
    from pmv_tpu.config import VOConfig
    from pmv_tpu.pipeline.odometry import OdometryPipeline

    d = Path(__file__).resolve().parent.parent / ".bench_data" / f"seq_{FRAMES}_{SHAPE[0]}x{SHAPE[1]}"
    assert (d / "ok").exists(), "dataset missing - run bench.py first"
    base = dict(
        image_dir=str(d / "image_0"),
        camera_calibration=str(d / "calib.txt"),
        poses=str(d / "poses.txt"),
        camera=0, frames=FRAMES, init_frames=5,
        min_tracked_features=400, tracked_features_tol=150,
        bundle_size=5, max_iterations=5,
        feature_capacity=512, map_capacity=8192,
        verbose=1, seed=SEED,
    )
    base.update(OVERRIDES)
    cfg = VOConfig(**base)
    pipe = OdometryPipeline(cfg)
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = pipe.run()
    log = buf.getvalue()

    # Per-frame stats stream (fused loop's verbose lines).
    pat = re.compile(
        r"frame: tracked (\d+), n3d (\d+), (pnp|tri), inliers (\d+), "
        r"accepted (True|False)"
    )
    rows = [
        (int(m[1]), int(m[2]), m[3] == "pnp", int(m[4]), m[5] == "True")
        for m in pat.finditer(log)
    ]
    stats = np.asarray(
        [(t, n, p, i, a) for t, n, p, i, a in rows], np.int32
    ) if rows else np.zeros((0, 5), np.int32)

    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    err = np.linalg.norm(
        (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off]), axis=1
    )

    OUT.mkdir(parents=True, exist_ok=True)
    tag = f"seed{SEED}" + ("_" + "_".join(
        f"{k}={v}" for k, v in sorted(OVERRIDES.items())) if OVERRIDES else "")
    np.savez(OUT / f"diag_{tag}.npz", stats=stats, err=err, t_est=t_est,
             gt=gt, off=off)
    (OUT / f"diag_{tag}.log").write_text(log)

    ate = float(np.sqrt(np.mean(err**2))) if len(err) else 0.0
    # First frame where error exceeds thresholds (divergence onset).
    summary = {
        "tag": tag, "frames": int(result["frames"]), "ate_rmse_m": round(ate, 2),
        "t_total": round(result["t_total"], 1),
        "n_tri": int((~stats[:, 2].astype(bool)).sum()) if len(stats) else -1,
        "n_gate_reject": int((~stats[:, 4].astype(bool)).sum()) if len(stats) else -1,
    }
    for thresh in (5.0, 10.0, 20.0, 40.0):
        ix = np.argmax(err > thresh) if np.any(err > thresh) else -1
        summary[f"first_err_gt_{int(thresh)}m"] = int(ix)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
