"""Command-line entry point — counterpart of the reference binary
``OdometryPipeline <config-file>`` (main.cpp:5-31).

Usage:
    python -m pmv_tpu.cli run <config.ini> [--platform cpu|gpu]
    python -m pmv_tpu.cli synth <out_dir> [--frames N]   # make a synthetic dataset

Config failures raise OdometryPipelineException and exit with a message,
like main.cpp:25-29. After a run, the trajectory map image and (optionally)
the annotated video are written alongside the error file.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="vo")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run the odometry pipeline on a config")
    run_p.add_argument("config")
    run_p.add_argument("--platform", default=None, help="force jax platform (cpu|gpu)")
    run_p.add_argument("--trace", default=None, metavar="DIR",
                       help="write a jax.profiler trace of the run to DIR")
    run_p.add_argument("--live", type=int, default=0, metavar="N",
                       help="write a live trajectory map (map_live.png) every"
                       " N frames during the run — the headless analogue of"
                       " the reference's during-run map window")

    synth_p = sub.add_parser("synth", help="generate a synthetic KITTI-layout dataset")
    synth_p.add_argument("out_dir")
    synth_p.add_argument("--frames", type=int, default=60)
    synth_p.add_argument("--height", type=int, default=192)
    synth_p.add_argument("--width", type=int, default=640)
    synth_p.add_argument("--density", type=float, default=60.0)
    synth_p.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)

    if args.cmd == "synth":
        from pmv_tpu.io import synthetic

        seq = synthetic.make_sequence(
            n_frames=args.frames,
            shape=(args.height, args.width),
            density=args.density,
            seed=args.seed,
        )
        paths = synthetic.write_kitti_layout(seq, args.out_dir)
        print("\n".join(f"{k} = {v}" for k, v in paths.items()))
        return 0

    import jax

    from pmv_tpu.utils import compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    compile_cache.enable()

    from pmv_tpu.config import OdometryPipelineException
    from pmv_tpu.pipeline.odometry import OdometryPipeline

    try:
        pipe = OdometryPipeline(args.config)
    except OdometryPipelineException as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.live:
        pipe.cfg.live_every = args.live
    from pmv_tpu.utils.profiling import trace

    with trace(args.trace):
        result = pipe.run()
    # Rebased ATE (fair trajectory quality; the error file keeps the
    # reference's un-rebased metric for parity).
    import numpy as np

    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    if n > 1:
        rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
        ate = float(np.sqrt(np.mean(np.sum(rel**2, axis=1))))
        print(f"ATE RMSE (rebased): {ate:.3f} m")
    print(
        f"Processed {result['frames']} poses in {result['runtime']:.2f}s "
        f"({result['frames'] / max(result['runtime'], 1e-9):.1f} fps) | "
        f"t total {result['t_total']:.1f} | R total {result['R_total']:.3f}"
    )
    print(
        f"init frame {pipe.init_offset} | BA calls {result['ba_calls']} | "
        f"bootstrap frames {result['bootstraps']}"
    )
    if pipe.cfg.video_path or pipe.cfg.fancy_video:
        try:
            from pmv_tpu.viz.render import save_run_visuals

            save_run_visuals(pipe)
        except Exception as e:  # viz is best-effort
            print(f"viz failed: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
