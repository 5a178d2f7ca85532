"""The VO pipeline orchestrator — counterpart of
``OdometryPipeline`` (OdometryPipeline.cpp).

Flow per frame (mirroring startPipeline/addFrame/estimatePose,
OdometryPipeline.cpp:247-426): async-prefetched image decode (the producer
thread's successor) -> pyramid build -> batched LK track of the previous
feature table (slot-aligned correspondences) -> reseed from grid corners when
tracked features drop below ``tracked_features_tol`` -> pose estimation for
the latest pair (RANSAC PnP against the live 3D map, or essential-matrix
bootstrap triangulation with GT-derived scale when the map is thin) ->
motion gate -> periodic sliding-window bundle adjustment -> ground-truth
error metrics written in the reference's exact error-file format
(:267-296).

Heavy compute runs as a handful of jitted XLA programs per frame
(pmv_tpu.pipeline.steps, pmv_tpu.solvers, pmv_tpu.ba); the host loop is
bookkeeping only.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from pmv_tpu.ba.schur_lm import BAProblem, ba_solve
from pmv_tpu.config import VOConfig
from pmv_tpu.core import geometry as geo
from pmv_tpu.core.state import FeatureTable, MapState
from pmv_tpu.frontend import corners
from pmv_tpu.frontend.image import build_pyramid
from pmv_tpu.io import kitti
from pmv_tpu.io.prefetch import FramePrefetcher
from pmv_tpu.pipeline import steps
from pmv_tpu.pipeline.heuristics import motion_gate
from pmv_tpu.solvers import essential, pnp
from pmv_tpu.utils.profiling import Stopwatch


class OdometryPipeline:
    def __init__(self, cfg: VOConfig | str | Path):
        if not isinstance(cfg, VOConfig):
            cfg = VOConfig.from_ini(cfg)
        self.cfg = cfg
        self.file_names = kitti.list_images(cfg.image_dir)
        self.K = jnp.asarray(
            kitti.parse_calibration(cfg.camera_calibration, cfg.camera),
            jnp.float32,
        )
        gt_R, gt_t = kitti.parse_poses(cfg.poses, stop=cfg.frames)
        self.gt_R = gt_R.astype(np.float64)
        self.gt_t = gt_t.astype(np.float64)

        self.map = MapState.empty(cfg.map_capacity)
        self.tables: list[FeatureTable] = []
        # Trajectory + heuristic-delta history (host-side, tiny).
        self.R: list[np.ndarray] = []
        self.t: list[np.ndarray] = []
        self.R_s: list[np.ndarray] = []
        self.t_s: list[np.ndarray] = []
        self.scale = 1.0
        self.init_offset = 0
        self.runtime = 0.0
        self.errors_t: list[float] = []
        self.errors_R: list[float] = []
        self._key = jax.random.PRNGKey(cfg.seed)
        self._watch = Stopwatch()
        self._ba_cadence = (
            cfg.ba_cadence if cfg.ba_cadence > 0 else max(1, cfg.bundle_size // 3 * 2)
        )
        self._prev_pyr = None
        self._ba_calls = 0  # actual BA invocations this run (bench metric)
        self._bootstraps = 0  # frames posed by the essential-matrix branch
        # Landmark-position snapshot history at BA cadence (filled by run()
        # when cfg.map_hist and a video is requested; viz/render.py replay).
        self.map_hist: np.ndarray | None = None
        self.map_hist_cadence = self._ba_cadence

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _next_key(self) -> jax.Array:
        self._key, k = jax.random.split(self._key)
        return k

    def _log(self, *args):
        if self.cfg.verbose:
            print(*args, flush=True)

    def _n_tiles(self, shape) -> int:
        H, W = shape
        return math.ceil(H / self.cfg.grid_rows) * math.ceil(W / self.cfg.grid_cols)

    # ------------------------------------------------------------------
    # initialisation (OdometryPipeline.cpp:428-482)
    # ------------------------------------------------------------------

    def initialise(self, images: list[np.ndarray]) -> None:
        """Pick the best of the first ``init_frames`` frames by the
        reference's cost: std of per-tile feature counts + std of scores
        (:461-464), then seed frame 0's feature table from it."""
        cfg = self.cfg
        best_cost = np.inf
        best = None
        for i, img in enumerate(images):
            n_tiles = self._n_tiles(img.shape)
            n_per_tile = max(1, cfg.min_tracked_features // n_tiles)
            preset = cfg.extractor_preset()
            xy, score, valid = corners.grid_extract(
                jnp.asarray(img),
                n_per_tile,
                tile_h=cfg.grid_rows,
                tile_w=cfg.grid_cols,
                **preset,
            )
            v = np.asarray(valid)
            s = np.asarray(score)
            counts = v.reshape(n_tiles, n_per_tile).sum(axis=1).astype(np.float64)
            accepted = s[v]
            std_n = counts.std(ddof=1) if len(counts) > 1 else 0.0
            std_s = accepted.std(ddof=1) if len(accepted) > 1 else 0.0
            cost = std_n + std_s
            self._log(f"init frame {i}: {v.sum()} feats, cost {cost:.3f}")
            if cost < best_cost:
                best_cost = cost
                best = (i, xy, score, valid)
        i, xy, score, valid = best
        self.init_offset = i
        top_xy, top_score, top_valid = corners.select_top(
            xy, score, valid, cfg.feature_capacity
        )
        table = FeatureTable(
            xy=top_xy,
            valid=top_valid,
            landmark=jnp.full((cfg.feature_capacity,), -1, jnp.int32),
            score=top_score,
        )
        self.tables = [table]
        self._log(
            f"Initialised using {int(top_valid.sum())} features from frame #{i}"
        )

    # ------------------------------------------------------------------
    # per-frame ingest (addFrame, OdometryPipeline.cpp:329-374)
    # ------------------------------------------------------------------

    def add_frame(self, img: np.ndarray) -> int:
        cfg = self.cfg
        pyr = build_pyramid(jnp.asarray(img), cfg.lk_levels)
        k = len(self.tables)
        if cfg.verbose:
            self._watch.tick()
        if cfg.matcher == "knn":
            # Alternate matcher (kNNFeatureMatcher.cpp semantics): fresh
            # corners in the new frame + patch-SSD association.
            from pmv_tpu.frontend import knn_matcher
            from pmv_tpu.frontend.corners import grid_extract

            cand_xy, _, cand_valid = grid_extract(
                pyr[0], 1000 // max(1, self._n_tiles(img.shape)) + 1,
                tile_h=cfg.grid_rows, tile_w=cfg.grid_cols,
                quality=cfg.quality_level, min_distance=cfg.min_distance,
            )
            table = knn_matcher.knn_match(
                self._prev_pyr[0], pyr[0], self.tables[k - 1], cand_xy, cand_valid
            )
        else:
            table = steps.track_step(
                self._prev_pyr, pyr, self.tables[k - 1],
                win=cfg.lk_window, iters=cfg.lk_iters, search=cfg.lk_search,
            )
        tracked = int(table.num_valid())
        if cfg.verbose:
            # Per-stage timing like the reference's verbose printouts
            # (OdometryPipeline.cpp:334-340).
            jax.block_until_ready(table.xy)
            self._log(
                f"{self._watch.tock():.6g} seconds for feature matching in frame #{k}"
            )
        if tracked < (cfg.reseed_tol if cfg.reseed_tol > 0 else cfg.tracked_features_tol):
            n_tiles = self._n_tiles(img.shape)
            n_per_tile = max(1, math.ceil(cfg.min_tracked_features / n_tiles))
            if cfg.verbose:
                self._watch.tick()
            self._log(
                f"Trying to find {cfg.min_tracked_features} new features in frame #{k}"
            )
            table = steps.reseed_step(
                table,
                pyr[0],
                n_per_tile,
                tile_h=cfg.grid_rows,
                tile_w=cfg.grid_cols,
                **cfg.extractor_preset(),
            )
            if cfg.verbose:
                # OdometryPipeline.cpp:369-370.
                jax.block_until_ready(table.xy)
                self._log(f"Feature extraction took {self._watch.tock():.6g} seconds")
        self.tables.append(table)
        self._prev_pyr = pyr
        return k

    # ------------------------------------------------------------------
    # pose estimation (estimatePose, OdometryPipeline.cpp:376-426)
    # ------------------------------------------------------------------

    def estimate_pose(self, j: int) -> None:
        """Estimate the pose of frame j+1 from the pair (j, j+1)."""
        cfg = self.cfg
        if cfg.verbose:
            self._watch.tick()
        src = self.tables[j]
        nxt = self.tables[j + 1]
        R_j = jnp.asarray(self.R[j], jnp.float32)
        t_j = jnp.asarray(self.t[j], jnp.float32)

        n3d = int(steps.count_3d(src, self.map))
        if n3d >= cfg.tracked_features_tol:
            X_std, uv, mask, lm_slots = steps.pnp_inputs(src, nxt, self.map, R_j, t_j)
            # Guess: last accepted relative delta (better-conditioned than
            # the reference's global-pose guess at OpenCVEPnPSolver.cpp:10).
            R_delta, t_delta, inliers = pnp.solve_pnp_ransac(
                X_std,
                uv,
                mask,
                self.K,
                self._next_key(),
                jnp.asarray(self.R_s[j], jnp.float32),
                jnp.asarray(self.t_s[j], jnp.float32),
                n_hypos=cfg.ransac_pnp_hypos,
                thresh_px=cfg.ransac_pnp_thresh,
            )
            self.map = steps.kill_outlier_landmarks(self.map, lm_slots, mask, inliers)
            self._log(f"frame {j}: PnP with {n3d} 3D points, {int(inliers.sum())} inliers")
        else:
            self._bootstraps += 1
            if cfg.verbose:
                self._watch.tick()
            corr = src.valid & nxt.valid
            if cfg.essential_solver == "five_point":
                from pmv_tpu.solvers.five_point import (
                    find_essential_5pt_ransac,
                    ransac_budget,
                )

                E, inl = find_essential_5pt_ransac(
                    src.xy, nxt.xy, corr, self.K, self._next_key(),
                    n_hypos=ransac_budget(cfg.ransac_e_hypos),
                    thresh_px=cfg.ransac_e_thresh,
                )
            else:
                E, inl = essential.find_essential_ransac(
                    src.xy,
                    nxt.xy,
                    corr,
                    self.K,
                    self._next_key(),
                    n_hypos=cfg.ransac_e_hypos,
                    thresh_px=cfg.ransac_e_thresh,
                )
            R_delta, t_unit, X_tri, front = essential.recover_pose(
                E, src.xy, nxt.xy, inl, self.K
            )
            # Absolute scale from ground truth (OpenCVFivePointTri.cpp:28-34).
            g = j + self.init_offset
            self.scale = float(np.linalg.norm(self.gt_t[g + 1] - self.gt_t[g]))
            t_delta = t_unit * self.scale
            src2, nxt2, self.map = steps.register_triangulated(
                src,
                nxt,
                self.map,
                X_tri,
                inl & front,
                jnp.float32(self.scale),
                R_j,
                t_j,
            )
            self.tables[j] = src2
            self.tables[j + 1] = nxt2
            self._log(
                f"frame {j}: triangulated, {int((inl & front).sum())} new landmarks"
            )
            if cfg.verbose:
                # OdometryPipeline.cpp:394-395.
                jax.block_until_ready(self.map.xyz)
                self._log(
                    f"{self._watch.tock():.6g} seconds for triangulating points."
                )

        R_new, t_new, R_s_new, t_s_new, accepted = motion_gate(
            R_delta,
            t_delta,
            R_j,
            t_j,
            jnp.asarray(self.R_s[j], jnp.float32),
            jnp.asarray(self.t_s[j], jnp.float32),
            jnp.float32(self.scale),
        )
        if not bool(accepted):
            self._log("Using heuristic motion")
        self.R.append(np.asarray(R_new, np.float64))
        self.t.append(np.asarray(t_new, np.float64))
        self.R_s.append(np.asarray(R_s_new, np.float64))
        self.t_s.append(np.asarray(t_s_new, np.float64))
        if cfg.verbose:
            # OdometryPipeline.cpp:404-405.
            self._log(
                f"{self._watch.tock():.6g} seconds for pose estimation in frame #{j}"
            )

        if cfg.bundle_size and j and j % self._ba_cadence == 0:
            self.bundle_adjust(j + 1)
            self._ba_calls += 1

    # ------------------------------------------------------------------
    # bundle adjustment window (CeresBundleAdjustment.cpp:5-89)
    # ------------------------------------------------------------------

    def bundle_adjust(self, fn_frame: int) -> None:
        cfg = self.cfg
        fn = fn_frame + 1
        n = min(cfg.bundle_size, fn)
        P = cfg.bundle_size  # static window size; early frames padded
        N = cfg.feature_capacity
        frame_ids = list(range(fn - n, fn))
        pad = P - n

        xy = jnp.stack(
            [jnp.zeros((N, 2), jnp.float32)] * pad
            + [self.tables[i].xy for i in frame_ids]
        )
        valid = jnp.stack(
            [jnp.zeros((N,), jnp.bool_)] * pad
            + [self.tables[i].valid for i in frame_ids]
        )
        lm = jnp.stack(
            [jnp.full((N,), -1, jnp.int32)] * pad
            + [self.tables[i].landmark for i in frame_ids]
        )
        obs_uv, obs_pose, obs_lm, obs_mask = steps.assemble_ba_window(
            xy, valid, lm, self.map
        )
        tr = jnp.stack(
            [jnp.zeros((6,), jnp.float32)] * pad
            + [
                jnp.asarray(
                    geo.pose_to_ba_params(
                        jnp.asarray(self.R[i], jnp.float32),
                        jnp.asarray(self.t[i], jnp.float32),
                    )
                )
                for i in frame_ids
            ]
        )
        # Global frame 0 is held fixed (reference skips it entirely,
        # CeresBundleAdjustment.cpp:22-23; we keep its observations as a
        # window anchor). Padded slots are fixed too.
        pose_free = jnp.asarray([False] * pad + [i != 0 for i in frame_ids])

        prob = BAProblem(
            tr=tr,
            lm=self.map.xyz,
            obs_uv=obs_uv,
            obs_pose=obs_pose,
            obs_lm=obs_lm,
            obs_mask=obs_mask,
            pose_free=pose_free,
            K=self.K,
        )
        tr_out, lm_out, stats = ba_solve(
            prob, iters=cfg.max_iterations, obs_gate_px=cfg.ba_obs_gate_px
        )
        if cfg.verbose:
            # Ceres-style per-iteration solver progress (the reference streams
            # Summary::FullReport under verbose, CeresBundleAdjustment.cpp:
            # 56-57, :63-64); ba_solve returns the accepted-cost history.
            hist = np.asarray(stats["history"], np.float64)
            c_prev = float(stats["cost0"])
            for it, c in enumerate(hist):
                self._log(
                    f"  BA iter {it}: cost {c:.6e} (change {c_prev - float(c):.3e})"
                )
                c_prev = float(c)
        self._log(
            f"BA window [{frame_ids[0]},{frame_ids[-1]}]: cost "
            f"{float(stats['cost0']):.1f} -> {float(stats['cost']):.1f}"
        )
        self.map = self.map._replace(xyz=lm_out)
        R_new, t_new = geo.ba_params_to_pose(tr_out)
        for idx, i in enumerate(frame_ids):
            if i == 0:
                continue
            self.R[i] = np.asarray(R_new[pad + idx], np.float64)
            self.t[i] = np.asarray(t_new[pad + idx], np.float64)

    # ------------------------------------------------------------------
    # main loop (startPipeline, OdometryPipeline.cpp:247-296)
    # ------------------------------------------------------------------

    def _seed_trajectory(self) -> None:
        eye = np.eye(3)
        zero = np.zeros(3)
        self.R = [eye.copy()]
        self.t = [zero.copy()]
        self.R_s = [eye.copy()]
        self.t_s = [zero.copy()]

    def _finish(self) -> dict:
        self._compute_errors()
        if self.cfg.error_path:
            self.write_error_file(self.cfg.error_path)
        return {
            "runtime": self.runtime,
            "frames": len(self.t),
            "t_total": float(np.sum(self.errors_t)) if self.errors_t else 0.0,
            "R_total": float(np.sum(self.errors_R)) if self.errors_R else 0.0,
            "ba_calls": self._ba_calls,
            "bootstraps": int(self._bootstraps),
        }

    def _step_config(self, img_shape) -> "fused.StepConfig":
        """The fused loop's STATIC (compile-cache-keyed) configuration.

        Every field must be independent of the run's frame count: jitted
        programs are keyed on this config, and a fresh compile of the
        chunk program takes a long time. In particular ``traj_cap`` is a true
        constant (cfg.traj_cap, default 2048 — covers every KITTI sequence):
        a run that would overflow the device trajectory history fails loudly
        here instead of silently forking every compiled program.
        """
        from pmv_tpu.pipeline import fused

        cfg = self.cfg
        if cfg.frames + 2 > cfg.traj_cap:
            from pmv_tpu.config import OdometryPipelineException

            raise OdometryPipelineException(
                f"frames={cfg.frames} exceeds traj_cap={cfg.traj_cap} - 2; "
                "raise traj_cap explicitly (costs a fresh compile)"
            )
        n_tiles = self._n_tiles(img_shape)
        preset = cfg.extractor_preset()
        return fused.StepConfig(
            lk_levels=cfg.lk_levels,
            lk_window=cfg.lk_window,
            lk_iters=cfg.lk_iters,
            lk_search=cfg.lk_search,
            tile_h=cfg.grid_rows,
            tile_w=cfg.grid_cols,
            n_per_tile=max(1, math.ceil(cfg.min_tracked_features / n_tiles)),
            quality=preset["quality"],
            min_distance=preset["min_distance"],
            response=preset["response"],
            essential_solver=cfg.essential_solver,
            tracked_tol=cfg.tracked_features_tol,
            e_hypos=cfg.ransac_e_hypos,
            e_thresh=cfg.ransac_e_thresh,
            pnp_hypos=cfg.ransac_pnp_hypos,
            pnp_thresh=cfg.ransac_pnp_thresh,
            lk_impl=steps.resolve_lk_impl(
                cfg.lk_impl, jax.default_backend(), cfg.lk_window
            ),
            matcher=cfg.matcher,
            knn_cand_per_tile=1000 // n_tiles + 1,
            reseed_tol=cfg.reseed_tol,
            bundle_size=max(cfg.bundle_size, 1),
            ba_iters=cfg.max_iterations,
            ba_cadence=cfg.ba_cadence,
            ba_obs_gate_px=cfg.ba_obs_gate_px,
            ba_lm_cap=cfg.ba_lm_cap,
            cont_tri=bool(cfg.cont_tri),
            cont_tri_reproj_px=cfg.cont_tri_reproj_px,
            cont_tri_min_depth=cfg.cont_tri_min_depth,
            cont_tri_max_depth=cfg.cont_tri_max_depth,
            traj_cap=cfg.traj_cap,
            map_hist_rows=(
                cfg.traj_cap // self._ba_cadence + 2 if cfg.map_hist else 0
            ),
        )

    def run(self) -> dict:
        """Fused-step main loop: one XLA dispatch per frame (plus periodic
        BA), with async host-side frame prefetch — the device-side analogue of
        the reference's two-thread pipeline."""
        from pmv_tpu.pipeline import fused

        cfg = self.cfg
        if cfg.matcher not in ("lk", "knn"):
            # Unknown matchers run through the modular per-stage loop. Say
            # so loudly (not just under verbose): the modular loop
            # dispatches once per stage, far slower than the fused path.
            print(
                f"pmv_tpu: matcher={cfg.matcher!r} is not fused — falling back "
                "to the modular per-stage loop (one dispatch per stage; much "
                "lower fps than the fused matchers)",
                flush=True,
            )
            return self.run_modular()
        init_paths = self.file_names[: cfg.init_frames]
        init_imgs = [img for _, img in FramePrefetcher(init_paths)]
        self.initialise(init_imgs)
        self._seed_trajectory()

        img0 = init_imgs[self.init_offset]
        step_cfg = self._step_config(img0.shape)
        start = self.init_offset + 1
        stop = min(cfg.frames, len(self.file_names))
        resume = bool(cfg.resume) and cfg.checkpoint_path and Path(cfg.checkpoint_path).exists()
        if resume:
            from pmv_tpu.utils import checkpoint as ckpt_lib

            state, _ = ckpt_lib.load_fused_state(cfg.checkpoint_path)
            k_last = int(np.asarray(state.k))
            self._log(f"Resumed fused state at frame {k_last} from {cfg.checkpoint_path}")
        else:
            state = fused.init_state(
                pyr=tuple(build_pyramid(jnp.asarray(img0), cfg.lk_levels)),
                table=self.tables[0],
                map_state=self.map,
                cfg=step_cfg,
            )
            k_last = 0

        self._watch.tick()
        paths = self.file_names[start + k_last : stop]
        # Pre-split all RANSAC keys once and keep them host-side: per-frame
        # jax.random calls would each cost a device dispatch. The split count
        # covers the WHOLE dataset (not this run's frame range) so a resumed
        # run draws the exact keys the uninterrupted run would have drawn.
        keys = np.asarray(
            jax.random.split(self._key, max(len(self.file_names) - start, 1))
        )
        C = max(1, cfg.chunk_frames)
        buf_img: list[np.ndarray] = []
        buf_gt: list[np.float32] = []
        buf_key: list[np.ndarray] = []
        # Double buffering: start the device upload of chunk i+1 before
        # dispatching compute for chunk i, overlapping the slow host->device
        # transfer with the previous chunk's execution.
        pending = None  # (dev_imgs, gts, keys, n)
        # Bootstrap-branch frames, summed on device (read back once).
        n_boot = jnp.zeros((), jnp.int32)

        def log_stats(stats, take):
            if self.cfg.verbose:
                s = jax.device_get(stats)
                for i in range(take):
                    self._log(
                        f"frame: tracked {int(s['tracked'][i])}, "
                        f"n3d {int(s['n3d'][i])}, "
                        f"{'pnp' if bool(s['used_pnp'][i]) else 'tri'}, "
                        f"inliers {int(s['inliers'][i])}, "
                        f"accepted {bool(s['accepted'][i])}"
                    )

        def dispatch(state, pend):
            nonlocal n_boot
            dev_imgs, gts, kys, n = pend
            state, stats = fused.chunk_step(state, dev_imgs, gts, kys, self.K, step_cfg)
            n_boot = n_boot + jnp.sum(~stats["used_pnp"])
            log_stats(stats, n)
            return state

        def enqueue(state):
            """Upload the buffered frames, then run the previously pending
            chunk. Partial buffers go as size-1 chunks (only chunk sizes C
            and 1 are ever compiled)."""
            nonlocal pending, buf_img, buf_gt, buf_key
            while buf_img:
                take = C if len(buf_img) >= C else 1
                dev_imgs = jax.device_put(np.stack(buf_img[:take]).astype(np.uint8))
                pend_new = (
                    dev_imgs,
                    np.asarray(buf_gt[:take], np.float32),
                    np.stack(buf_key[:take]),
                    take,
                )
                if pending is not None:
                    state = dispatch(state, pending)
                pending = pend_new
                buf_img = buf_img[take:]
                buf_gt = buf_gt[take:]
                buf_key = buf_key[take:]
            return state

        def maybe_checkpoint(state, force=False):
            """Periodic mid-run snapshot of the device-resident StepState
            (double-buffering means it may lag k_last by up to 2 chunks; the
            snapshot reads its own state.k on resume)."""
            nonlocal last_saved
            if not cfg.checkpoint_path:
                return
            due = cfg.checkpoint_every > 0 and (
                k_last - last_saved >= cfg.checkpoint_every
            )
            if not (due or force):
                return
            from pmv_tpu.utils import checkpoint as ckpt_lib

            tmp = Path(str(cfg.checkpoint_path) + ".tmp.npz")
            ckpt_lib.save_fused_state(state, tmp)
            tmp.replace(cfg.checkpoint_path)
            last_saved = k_last

        last_live = k_last

        def maybe_live(state):
            """During-run observability: write the trajectory map every
            ``live_every`` frames — the headless counterpart of the
            reference's per-frame cv::imshow map (OdometryPipeline.cpp:
            423-425). Reads back only the small state (~250 KB)."""
            nonlocal last_live
            if cfg.live_every <= 0 or k_last - last_live < cfg.live_every:
                return
            last_live = k_last
            from pmv_tpu.io.png import write_png
            from pmv_tpu.viz import render as render_mod

            sk = int(state.k)
            t_h, R_h, xyz, alive = jax.device_get(
                (state.t_hist, state.R_hist, state.map.xyz, state.map.alive)
            )
            m = render_mod.draw_map(
                [t_h[i] for i in range(sk + 1)],
                self.gt_t,
                self.init_offset,
                cfg.map_scale,
                landmarks=xyz[alive],
                R_est=[R_h[i] for i in range(sk + 1)],
                gt_R=self.gt_R,
            )
            out = Path(cfg.error_path or "map_live.png")
            write_png(out.parent / "map_live.png", m)

        last_saved = k_last
        for _, img in FramePrefetcher(paths):
            k = k_last + 1
            g = k - 1 + self.init_offset
            if g + 1 >= len(self.gt_t):
                break
            buf_img.append(img)
            buf_gt.append(np.float32(np.linalg.norm(self.gt_t[g + 1] - self.gt_t[g])))
            buf_key.append(keys[min(k - 1, len(keys) - 1)])
            k_last = k
            if len(buf_img) == C:
                state = enqueue(state)
                maybe_checkpoint(state)
                maybe_live(state)
        state = enqueue(state)
        if pending is not None:
            state = dispatch(state, pending)
        maybe_checkpoint(state, force=bool(cfg.checkpoint_path))
        # Exact BA-call count of the fused loop: chunk_step fires BA after
        # frame k at j = k_new - 1, i.e. j ranges over [1, k_last).
        cadence = (
            step_cfg.ba_cadence
            if step_cfg.ba_cadence > 0
            else max(1, step_cfg.bundle_size // 3 * 2)
        )
        self._ba_calls = sum(1 for j in range(1, k_last) if j % cadence == 0)
        self._bootstraps = n_boot
        # One readback for the whole run.
        self.map = state.map
        R_hist, t_hist, Rs_f, ts_f, scale_f = jax.device_get(
            (state.R_hist, state.t_hist, state.R_s, state.t_s, state.scale)
        )
        self.runtime = self._watch.tock()
        self.R = [np.asarray(R_hist[i], np.float64) for i in range(k_last + 1)]
        self.t = [np.asarray(t_hist[i], np.float64) for i in range(k_last + 1)]
        self.R_s = [np.asarray(Rs_f, np.float64)]
        self.t_s = [np.asarray(ts_f, np.float64)]
        self.scale = float(scale_f)
        # Materialize the per-frame feature tables from the device history
        # (post-run, outside the timed window — the analogue of the reference
        # writing its video after the threads join, main.cpp:14-23). These
        # feed the video annotator's per-frame crosses/landmark layers
        # (viz/render.py) and global refinement (parallel/global_refine.py).
        txy, tvalid, tlm = jax.device_get(
            (state.tbl_xy_hist, state.tbl_valid_hist, state.tbl_lm_hist)
        )
        n_overflow = int(np.asarray(state.ba_overflow))
        if n_overflow:
            # Saturated windows silently drop observations — a biased BA
            # that measurably drifts the heading.
            print(
                f"pmv_tpu: {n_overflow} BA windows saturated ba_lm_cap — "
                "raise ba_lm_cap (observations were dropped; heading drift "
                "risk)",
                flush=True,
            )
        # The landmark-position snapshot history is large (~64 MB) and only
        # the video replay needs it — read it back only when one will be
        # rendered.
        if step_cfg.map_hist_rows > 0 and (cfg.video_path or cfg.fancy_video):
            self.map_hist = np.asarray(jax.device_get(state.map_hist))
            self.map_hist_cadence = cadence
        self.tables = [
            FeatureTable(
                xy=jnp.asarray(txy[i]),
                valid=jnp.asarray(tvalid[i]),
                landmark=jnp.asarray(tlm[i]),
                score=jnp.zeros((txy.shape[1],), jnp.float32),
            )
            for i in range(k_last + 1)
        ]
        return self._finish()

    def run_modular(self) -> dict:
        """Reference-shaped loop using the unfused per-stage steps — one
        dispatch per stage. Slower (more round trips) but easier to
        instrument; behaviorally equivalent to run()."""
        cfg = self.cfg
        self._ba_calls = 0
        self._bootstraps = 0
        init_paths = self.file_names[: cfg.init_frames]
        init_imgs = [img for _, img in FramePrefetcher(init_paths)]
        self.initialise(init_imgs)
        self._prev_pyr = build_pyramid(
            jnp.asarray(init_imgs[self.init_offset]), cfg.lk_levels
        )
        self._seed_trajectory()

        self._watch.tick()
        start = self.init_offset + 1
        stop = min(cfg.frames, len(self.file_names))
        paths = self.file_names[start:stop]
        for _, img in FramePrefetcher(paths):
            k = self.add_frame(img)
            self.estimate_pose(k - 1)
        jax.block_until_ready(self.map.xyz)
        self.runtime = self._watch.tock()
        return self._finish()

    # ------------------------------------------------------------------
    # metrics + error file (OdometryPipeline.cpp:267-296)
    # ------------------------------------------------------------------

    def _compute_errors(self) -> None:
        """Reference-faithful error computation, including its in-place
        mutation of the stored GT arrays (cv::Mat shallow copies at
        OdometryPipeline.cpp:273-277 flip signs *in the stored poses*, and
        the R norm then compares against gt_R[i] — not gt_R[i+init_offset] —
        at :279, possibly already mutated). Bug-compatible on purpose: the
        published baseline numbers were produced by this exact computation."""
        gt_t = self.gt_t.copy()
        gt_R = self.gt_R.copy()
        self.errors_t = []
        self.errors_R = []
        for i in range(1, len(self.t)):
            g = i + self.init_offset
            if g >= len(gt_t):
                break
            gt_t[g][2] *= -1
            gt_R[g][2][0] *= -1
            gt_R[g][0][2] *= -1
            t_norm = float(np.linalg.norm(self.t[i] - gt_t[g]))
            R_norm = float(np.linalg.norm(self.R[i] - gt_R[i]))
            self.errors_t.append(t_norm)
            self.errors_R.append(R_norm)

    @staticmethod
    def _std(vals: list[float]) -> float:
        """n-1 standard deviation (OdometryPipeline.cpp:660-672)."""
        if len(vals) < 2:
            return 0.0
        return float(np.std(np.asarray(vals), ddof=1))

    def write_error_file(self, path: str | Path) -> None:
        """Reference error-file format (OdometryPipeline.cpp:285-296),
        with C++ ostream default 6-significant-digit formatting."""

        def fmt(x: float) -> str:
            return f"{x:.6g}"

        lines = [
            f"Runtime: {fmt(self.runtime)}",
            f"R total: {fmt(sum(self.errors_R))}",
            f"R min: {fmt(min(self.errors_R))}",
            f"R max: {fmt(max(self.errors_R))}",
            f"R std: {fmt(self._std(self.errors_R))}",
            f"t total: {fmt(sum(self.errors_t))}",
            f"t min: {fmt(min(self.errors_t))}",
            f"t max: {fmt(max(self.errors_t))}",
            f"t std: {fmt(self._std(self.errors_t))}",
        ]
        Path(path).write_text("\n".join(lines) + "\n")
