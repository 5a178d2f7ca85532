"""Drift-mechanism analysis of diag_seed.py dumps.

Question: the tuned 598-frame ATE spreads 2x across seeds (8.45-18.25 m).
Where does the extra drift of a bad seed accumulate — at tri
(re-bootstrap) events, at trajectory turns, at gate rejections, or
uniformly (chaos floor)?

Method: per-frame error-growth attribution. The per-frame trajectory error
err[k] is differenced into growth g[k] = err[k] - err[k-1]; each frame is
labeled (tri event +-W frames, turn = |gt yaw rate| above threshold, gate
reject, plain pnp) and the growth is summed per label. A mechanism that
owns the seed spread shows up as the dominant growth bucket of the bad
seed but not the good one. Also reports heading-error evolution (the
round-4 drift class was a smooth heading bias).

Usage: python scripts/diag_analyze.py artifacts/diag/diag_seed0.npz ...
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def yaw_of(t: np.ndarray) -> np.ndarray:
    """Heading angle (x-z plane) of consecutive trajectory steps."""
    d = np.diff(t, axis=0)
    return np.arctan2(d[:, 0], -d[:, 2])  # forward = -z in pipeline world


def analyze(path: Path, tri_halo: int = 2, turn_thresh: float = 0.008) -> dict:
    d = np.load(path)
    stats, err, t_est, gt, off = (
        d["stats"], d["err"], d["t_est"], d["gt"], int(d["off"])
    )
    n = len(err)
    g = np.diff(err, prepend=0.0)  # per-frame error growth (signed)

    used_pnp = stats[:, 2].astype(bool)
    accepted = stats[:, 4].astype(bool)
    m = min(n, len(used_pnp))
    g, used_pnp, accepted = g[:m], used_pnp[:m], accepted[:m]

    tri = ~used_pnp
    # halo: attribute the frames right after a tri event to it (the fresh
    # map's heading error surfaces over the next few frames)
    tri_z = np.zeros(m, bool)
    for i in np.where(tri)[0]:
        tri_z[i : i + tri_halo + 1] = True

    gt_yaw = yaw_of(gt[off : off + m + 1])
    yr = np.abs(np.diff(gt_yaw, prepend=gt_yaw[0]))
    # Adaptive: "turn" = top-decile yaw rate of THIS trajectory (the smooth
    # corridor never crosses a fixed KITTI-intersection threshold).
    thr = max(turn_thresh, float(np.quantile(yr, 0.9)))
    turn = (yr > thr)[:m]

    reject = ~accepted

    buckets = {
        "tri_event_halo": tri_z,
        "turn": turn & ~tri_z,
        "gate_reject": reject & ~tri_z & ~turn,
        "plain_pnp": ~tri_z & ~turn & ~reject,
    }
    out = {
        "file": path.name,
        "frames": int(m),
        "final_err_m": round(float(err[-1]), 2),
        "ate_rmse_m": round(float(np.sqrt(np.mean(err**2))), 2),
        "n_tri": int(tri.sum()),
        "n_gate_reject": int(reject.sum()),
    }
    for name, mask in buckets.items():
        out[f"growth_{name}_m"] = round(float(g[mask].sum()), 2)
        out[f"frames_{name}"] = int(mask.sum())
        out[f"growth_per_frame_{name}_mm"] = (
            round(float(g[mask].sum() / mask.sum() * 1e3), 1)
            if mask.sum()
            else 0.0
        )

    # Heading-error evolution: estimated heading minus GT heading, smoothed.
    est_yaw = yaw_of(t_est[: m + 1])
    gty = gt_yaw[:m]
    hd = np.unwrap(est_yaw[:m]) - np.unwrap(gty)
    k = min(21, max(3, m // 20) | 1)
    hd_s = np.convolve(hd, np.ones(k) / k, mode="same")
    out["heading_err_final_deg"] = round(float(np.degrees(hd_s[-1])), 2)
    out["heading_err_max_deg"] = round(float(np.degrees(np.abs(hd_s).max())), 2)
    # Top-5 single-frame error-growth events with their labels.
    top = np.argsort(-np.abs(g))[:5]
    out["top_growth_events"] = [
        {
            "frame": int(i),
            "growth_m": round(float(g[i]), 2),
            "label": next(nm for nm, msk in buckets.items() if msk[i]),
        }
        for i in top
    ]
    return out


def main() -> None:
    paths = [Path(p) for p in sys.argv[1:]]
    if not paths:
        paths = sorted(Path("artifacts/diag").glob("diag_seed*.npz"))
    for p in paths:
        print(json.dumps(analyze(p)), flush=True)


if __name__ == "__main__":
    main()
