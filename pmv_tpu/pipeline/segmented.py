"""Segmented (sequence-parallel) visual odometry on a single chip or mesh.

VO is frame-sequential, which caps per-chip throughput at the latency of one
fused step. The way around it (SURVEY.md section 5: "sequence
scaling by windowing, never by parallel decomposition" is the reference's
limitation, not ours): split the video into B contiguous segments with a
one-frame overlap, run all segments simultaneously as a vmapped batch of
independent VO states (each bootstrapping its own map), then stitch the
segment trajectories by replaying their per-frame deltas onto the previous
segment's final pose. One chip processes B frames of video per step-latency;
on a mesh the batch also shards over the dp axis.

Trade-off: each segment re-bootstraps (a few triangulation frames) and
boundary deltas come from independent maps, so drift is slightly higher than
the strictly sequential run — the pose-graph layer (parallel.pose_graph) can
reconcile overlaps further.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from pmv_tpu.core.state import FeatureTable, MapState
from pmv_tpu.frontend.corners import grid_extract, select_top
from pmv_tpu.frontend.image import build_pyramid
from pmv_tpu.io.prefetch import FramePrefetcher
from pmv_tpu.pipeline import fused
from pmv_tpu.pipeline.odometry import OdometryPipeline


class SegmentedPipeline(OdometryPipeline):
    """Drop-in variant of OdometryPipeline processing B segments in parallel.

    ``segments`` controls B; B=1 degenerates to (a batched copy of) the
    sequential pipeline. Total processed transitions are trimmed to a
    multiple of B.
    """

    def __init__(self, cfg, segments: int = 8):
        super().__init__(cfg)
        self.segments = segments

    def run(self) -> dict:
        cfg = self.cfg
        B = self.segments
        stop = min(cfg.frames, len(self.file_names), len(self.gt_t))
        # Use standard init-frame selection for segment 0's start.
        init_paths = self.file_names[: cfg.init_frames]
        init_imgs = [img for _, img in FramePrefetcher(init_paths)]
        self.initialise(init_imgs)
        self._seed_trajectory()

        first = self.init_offset
        n_trans = stop - first - 1  # transitions to estimate
        C0 = max(1, cfg.chunk_frames)
        # Keep every device chunk exactly chunk_frames long so warmup and
        # timed runs compile the same programs; trailing transitions beyond
        # the largest multiple are dropped (bench-mode trade-off).
        L = (n_trans // B // C0) * C0
        if L < C0:
            L = max(1, n_trans // B)
        if L < 1:
            raise ValueError(f"too few frames ({n_trans}) for {B} segments")
        if L + 2 > cfg.traj_cap:
            raise ValueError(
                f"segment length {L} exceeds traj_cap={cfg.traj_cap} - 2; "
                "raise traj_cap explicitly (costs a fresh compile)"
            )
        seg_starts = [first + b * L for b in range(B)]

        img0 = init_imgs[self.init_offset]
        n_tiles = self._n_tiles(img0.shape)
        preset = cfg.extractor_preset()
        step_cfg = fused.StepConfig(
            lk_levels=cfg.lk_levels,
            lk_window=cfg.lk_window,
            lk_iters=cfg.lk_iters,
            tile_h=cfg.grid_rows,
            tile_w=cfg.grid_cols,
            n_per_tile=max(1, math.ceil(cfg.min_tracked_features / n_tiles)),
            quality=preset["quality"],
            min_distance=preset["min_distance"],
            response=preset["response"],
            tracked_tol=cfg.tracked_features_tol,
            e_hypos=cfg.ransac_e_hypos,
            e_thresh=cfg.ransac_e_thresh,
            pnp_hypos=cfg.ransac_pnp_hypos,
            pnp_thresh=cfg.ransac_pnp_thresh,
            essential_solver=cfg.essential_solver,
            bundle_size=max(cfg.bundle_size, 1),
            ba_iters=cfg.max_iterations,
            ba_obs_gate_px=cfg.ba_obs_gate_px,
            traj_cap=cfg.traj_cap,
        )

        # Segment seed frames + feature tables (batched).
        seed_imgs = []
        for s in seg_starts:
            img = None
            for _, im in FramePrefetcher([self.file_names[s]]):
                img = im
            seed_imgs.append(img)
        states = []
        for b, img in enumerate(seed_imgs):
            jimg = jnp.asarray(img, jnp.float32)
            xy, sc, va = grid_extract(
                jimg,
                step_cfg.n_per_tile,
                tile_h=cfg.grid_rows,
                tile_w=cfg.grid_cols,
                quality=step_cfg.quality,
                min_distance=step_cfg.min_distance,
                response=step_cfg.response,
            )
            txy, tsc, tva = select_top(xy, sc, va, cfg.feature_capacity)
            table = FeatureTable(
                xy=txy,
                valid=tva,
                landmark=jnp.full((cfg.feature_capacity,), -1, jnp.int32),
                score=tsc,
            )
            states.append(
                fused.init_state(
                    pyr=tuple(build_pyramid(jimg, cfg.lk_levels)),
                    table=table,
                    map_state=MapState.empty(cfg.map_capacity),
                    cfg=step_cfg,
                )
            )
        state = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

        batched_chunk = jax.jit(
            jax.vmap(
                lambda s, i, g, k, K: fused.chunk_step(s, i, g, k, K, step_cfg),
                in_axes=(0, 0, 0, 0, None),
            )
        )

        # Per-segment frame paths + gt steps; stream chunks of C frames.
        C = max(1, cfg.chunk_frames)
        keys = np.asarray(jax.random.split(self._key, B * L).reshape(B, L, 2))
        gt_steps = np.zeros((B, L), np.float32)
        for b, s in enumerate(seg_starts):
            for i in range(L):
                g = s + i
                gt_steps[b, i] = np.linalg.norm(self.gt_t[g + 1] - self.gt_t[g])
        prefetchers = [
            FramePrefetcher(self.file_names[s + 1 : s + 1 + L]) for s in seg_starts
        ]
        iters = [iter(p) for p in prefetchers]

        self._watch.tick()
        done = 0
        while done < L:
            take = min(C, L - done)
            imgs = np.zeros((B, take) + img0.shape, np.uint8)
            for b in range(B):
                for i in range(take):
                    _, im = next(iters[b])
                    imgs[b, i] = im.astype(np.uint8)
            state, _ = batched_chunk(
                state,
                jnp.asarray(imgs),
                jnp.asarray(gt_steps[:, done : done + take]),
                jnp.asarray(keys[:, done : done + take]),
                self.K,
            )
            done += take

        # Readback + stitch: replay each segment's deltas onto the previous
        # segment's final pose (delta_j = R_l[j]^T -> reference composition).
        R_hist = np.asarray(jax.device_get(state.R_hist), np.float64)
        t_hist = np.asarray(jax.device_get(state.t_hist), np.float64)
        self.runtime = self._watch.tock()

        R_anchor = np.eye(3)
        t_anchor = np.zeros(3)
        self.R = [R_anchor.copy()]
        self.t = [t_anchor.copy()]
        for b in range(B):
            Rl = R_hist[b]
            tl = t_hist[b]
            for j in range(L):
                # recover the raw delta from the local trajectory
                R_d = Rl[j + 1] @ Rl[j].T
                t_d = Rl[j].T @ (tl[j + 1] - tl[j])
                # re-compose globally (reference rule)
                t_anchor = R_anchor @ t_d + t_anchor
                R_anchor = R_d @ R_anchor
                self.R.append(R_anchor.copy())
                self.t.append(t_anchor.copy())
        self.R_s = [np.eye(3)]
        self.t_s = [np.zeros(3)]
        # Each segment runs the fused BA cadence independently over its L
        # local frames (chunk_step fires at local j in [1, L)).
        cadence = (
            step_cfg.ba_cadence
            if step_cfg.ba_cadence > 0
            else max(1, step_cfg.bundle_size // 3 * 2)
        )
        self._ba_calls = B * sum(1 for j in range(1, L) if j % cadence == 0)
        self.tables.append(jax.tree_util.tree_map(lambda x: x[0], state.table))
        self.map = jax.tree_util.tree_map(lambda x: x[0], state.map)
        return self._finish()
