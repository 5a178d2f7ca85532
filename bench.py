"""Benchmark harness — one JSON line for the driver.

Measures end-to-end VO throughput (frames/s) of the full pipeline on a
KITTI-sized synthetic sequence (1226x370, the KITTI odometry frame size) on
the GPU. Baseline: the reference C++ pipeline's published KITTI-07 run at
the default bundle_size=5 / max_iterations=5 config — 600 frames in
24.15 s = 24.8 frames/s (Presentation.pdf slide 14; see BASELINE.md).

The child emits a JSON record after the first timed run (118 frames) and
re-emits upgraded records as the full-length (598-frame) runs complete,
starting a run only when its projected cost fits the remaining time. The
parent, which never imports JAX, is a plain timeout: it forwards the
child's most recent record. Without a GPU the bench fails, unless
``BENCH_PLATFORM`` explicitly asks for another platform (e.g. ``cpu`` to
smoke-test the harness).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

BASELINE_FPS = 24.8  # reference 5/5 config on KITTI 07 (BASELINE.md)

# Full-length target = the reference's own workload length (KITTI-07,
# 600 frames, Presentation.pdf slide 14) so the headline vs_baseline ratio
# compares equal-length runs. The FIRST timed run is short (118 frames) so a
# record exists early; longer runs then upgrade it.
TARGET_FRAMES = int(os.environ.get("BENCH_FRAMES", "598"))
FIRST_FRAMES = min(int(os.environ.get("BENCH_FIRST_FRAMES", "118")), TARGET_FRAMES)
SHAPE = (370, 1226)  # KITTI odometry grayscale frame size
CACHE = Path(__file__).resolve().parent / ".bench_data"  # git-ignored

# Parent watchdog budget. The child keeps ~8% margin for itself so it can
# finish emitting before the parent's hard kill.
BUDGET_S = int(os.environ.get("BENCH_TIMEOUT_S", "1200"))

_SEGS = int(os.environ.get("BENCH_SEGMENTS", "1"))
_CHUNK = int(
    json.loads(os.environ.get("BENCH_OVERRIDES", "{}")).get("chunk_frames", 8)
)
# Warmup must reach every compiled program of the timed run: init (5 frames)
# + a full chunk + remainder-sized (1) chunks + a BA call. Segmented mode
# needs one full chunk per segment.
WARMUP_FRAMES = 5 + _CHUNK + 6 if _SEGS <= 1 else 5 + _SEGS * _CHUNK + 2


def build_dataset(n_frames: int) -> dict:
    from pmv_tpu.io import synthetic

    # One directory per dataset config — concurrent processes with different
    # N_FRAMES must never write into the same layout.
    d = CACHE / f"seq_{n_frames}_{SHAPE[0]}x{SHAPE[1]}"
    marker = d / "ok"
    paths = {
        "image_dir": str(d / "image_0"),
        "camera_calibration": str(d / "calib.txt"),
        "poses": str(d / "poses.txt"),
    }
    if marker.exists():
        return paths
    seq = synthetic.make_sequence(
        n_frames=n_frames,
        shape=SHAPE,
        K=synthetic.KITTI_K,
        density=150.0,
        speed=1.0,
        yaw_rate=0.004,
        seed=0,
    )
    synthetic.write_kitti_layout(seq, d)
    marker.touch()
    return paths


def make_pipeline(paths: dict, frames: int):
    from pmv_tpu.config import VOConfig
    from pmv_tpu.pipeline.odometry import OdometryPipeline

    overrides = json.loads(os.environ.get("BENCH_OVERRIDES", "{}"))
    base = dict(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        camera=0,
        frames=frames,
        init_frames=5,
        min_tracked_features=400,
        tracked_features_tol=150,
        bundle_size=5,
        max_iterations=5,
        feature_capacity=512,
        map_capacity=8192,
        verbose=0,
        seed=0,
    )
    base.update(overrides)  # overrides win, including base keys like seed
    cfg = VOConfig(**base)
    if _SEGS > 1:
        from pmv_tpu.pipeline.segmented import SegmentedPipeline

        return SegmentedPipeline(cfg, segments=_SEGS)
    return OdometryPipeline(cfg)


def _decoder_name() -> str:
    try:
        from pmv_tpu.io import native

        return "native_cpp" if native.available() else "python"
    except Exception:
        return "python"


def _ate_rmse(pipe) -> float:
    """Rebased ATE RMSE (the reference's error file never re-bases the init
    offset; this is the fair trajectory-quality number)."""
    import numpy as np

    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1)))) if n > 1 else 0.0


def _record(fps, result, pipe, stage) -> dict:
    import jax

    from pmv_tpu.utils import device

    ov = json.loads(os.environ.get("BENCH_OVERRIDES", "{}"))
    ba_iters = int(ov.get("max_iterations", 5))
    ba_iters_per_sec = (
        result["ba_calls"] * ba_iters / max(result["runtime"], 1e-9)
    )
    return {
        "metric": "vo_frames_per_sec",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "detail": {
            "frames": result["frames"],
            "runtime_s": round(result["runtime"], 2),
            "t_total": round(result["t_total"], 1),
            "R_total": round(result["R_total"], 3),
            "ate_rmse_m": round(_ate_rmse(pipe), 3),
            "ba_iters_per_sec": round(ba_iters_per_sec, 1),
            "device": str(jax.devices()[0]),
            # Card name and power limit (nvidia-smi): a card set below its
            # maximum power runs slower under load.
            "card": device.nvidia_smi_card(),
            "frame_shape": list(SHAPE),
            # Incremental-emission stage: "short" = first 118-frame run,
            # "full" = reference-length run, "full+N" = best of N repeats.
            "bench_stage": stage,
            # Which PNG decoder fed the run: the native C++ decoder
            # (pmv_tpu.io.native) or the pure-Python codec.
            "png_decoder": _decoder_name(),
        },
    }


def main() -> None:
    import jax

    from pmv_tpu.utils import compile_cache

    if os.environ.get("BENCH_PLATFORM"):  # e.g. cpu: smoke-test the harness
        jax.config.update("jax_platforms", os.environ["BENCH_PLATFORM"])
    elif jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench: no GPU (backend {jax.default_backend()!r}); set "
            "BENCH_PLATFORM=cpu to run the harness on the CPU"
        )
    compile_cache.enable()

    t0 = time.time()
    deadline = t0 + BUDGET_S * 0.92

    def remaining() -> float:
        return deadline - time.time()

    # Phase 1: short dataset + warmup + first timed run. Emit immediately.
    paths = build_dataset(FIRST_FRAMES)
    warm = make_pipeline(paths, WARMUP_FRAMES)
    warm.run()

    pipe = make_pipeline(paths, FIRST_FRAMES)
    run_t0 = time.time()
    result = pipe.run()
    first_run_s = time.time() - run_t0
    fps = result["frames"] / max(result["runtime"], 1e-9)
    best = (fps, _record(fps, result, pipe, "short"))
    print(json.dumps(best[1]), flush=True)

    if TARGET_FRAMES <= FIRST_FRAMES:
        return

    # Phase 2: full-length runs, each only started if its projected cost
    # (linear in frames vs the measured first run, +20% margin) fits the
    # remaining child budget. Best-of-N against run-to-run noise; every
    # completed run re-emits so the parent always holds the latest.
    proj_full = first_run_s * (TARGET_FRAMES / FIRST_FRAMES) * 1.2 + 30
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    done = 0
    paths_full = None
    for i in range(max(1, repeats)):
        if remaining() < proj_full:
            break
        if paths_full is None:
            paths_full = build_dataset(TARGET_FRAMES)
        pipe = make_pipeline(paths_full, TARGET_FRAMES)
        run_t0 = time.time()
        result = pipe.run()
        proj_full = (time.time() - run_t0) * 1.1 + 15
        done += 1
        fps = result["frames"] / max(result["runtime"], 1e-9)
        stage = "full" if done == 1 else f"full+{done}"
        if fps >= best[0] or best[1]["detail"]["frames"] < result["frames"]:
            best = (fps, _record(fps, result, pipe, stage))
        else:  # keep the better fps but bump the stage marker
            best[1]["detail"]["bench_stage"] = stage
        print(json.dumps(best[1]), flush=True)


def main_with_watchdog() -> None:
    """Run the benchmark in a child process with a hard timeout.

    The parent never imports JAX (one process per card). It streams the
    child's stdout, keeping the most recent JSON record; on timeout or
    crash it kills the child's process group and forwards that record, or
    a zero record if there is none. Only one line is ever printed by the
    parent.
    """
    import signal
    import subprocess
    import threading

    env = dict(os.environ, BENCH_CHILD="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__)],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
        start_new_session=True,
    )
    state = {"last": None, "stderr": ""}

    def _read_out():
        for line in proc.stdout:
            line = line.strip()
            if line.startswith("{"):
                state["last"] = line

    def _read_err():
        state["stderr"] = proc.stderr.read()

    t_out = threading.Thread(target=_read_out, daemon=True)
    t_err = threading.Thread(target=_read_err, daemon=True)
    t_out.start()
    t_err.start()
    try:
        proc.wait(timeout=BUDGET_S)
        t_out.join(timeout=30)
    except subprocess.TimeoutExpired:
        # Kill the exact process group we started (never pattern-kill).
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        t_out.join(timeout=30)

    if state["last"] is not None:
        print(state["last"])
        return
    err = (state["stderr"] or "")[-400:]
    print(
        json.dumps(
            {
                "metric": "vo_frames_per_sec",
                "value": 0.0,
                "unit": "frames/s",
                "vs_baseline": 0.0,
                "detail": {
                    "error": f"no record emitted (rc={proc.returncode}): {err}"
                },
            }
        )
    )


if __name__ == "__main__":
    if os.environ.get("BENCH_CHILD") == "1":
        main()
    else:
        main_with_watchdog()
