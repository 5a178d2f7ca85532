"""The fused per-frame step: one XLA program per frame.

The reference hides latency with a two-thread pipeline
(OdometryPipeline.cpp:210-245). On an accelerator the equivalent concern is dispatch
latency: each jitted call costs a host->device round trip, so the whole
per-frame flow — pyramid build, batched LK tracking, conditional reseed,
conditional PnP-vs-triangulation, landmark bookkeeping, motion gate — is
fused into a single jit with ``lax.cond`` branches. The host loop feeds
images and reads back one pose per frame; everything else stays on device.

Branch semantics mirror estimatePose (OdometryPipeline.cpp:376-426):
``count3DPoints >= tracked_features_tol`` selects RANSAC PnP, otherwise the
essential-matrix bootstrap (with GT-derived scale ``gt_step``) triangulates
a fresh map.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pmv_tpu.ba import schur_lm
from pmv_tpu.core import geometry as geo
from pmv_tpu.core.state import FeatureTable, MapState
from pmv_tpu.frontend import corners
from pmv_tpu.frontend.image import build_pyramid
from pmv_tpu.pipeline import steps
from pmv_tpu.pipeline.heuristics import motion_gate
from pmv_tpu.solvers import essential, pnp


class StepConfig(NamedTuple):
    """Static (hashable) configuration of the fused step."""

    lk_levels: int = 4
    lk_window: int = 32
    lk_iters: int = 10
    lk_search: int = 0  # search radius around the guess; 0 = max(4, win//2)
    tile_h: int = 255
    tile_w: int = 255
    n_per_tile: int = 40
    quality: float = 0.01
    min_distance: int = 5
    tracked_tol: int = 150
    reseed_tol: int = 0  # reseed when tracked < this; 0 = tracked_tol
    # (the reference couples reseed and the PnP/tri branch at
    # tracked_features_tol, OdometryPipeline.cpp:342/:383; decoupling lets
    # production keep the feature pool dense without changing the branch)
    e_hypos: int = 256
    e_thresh: float = 1.0
    pnp_hypos: int = 128
    pnp_thresh: float = 8.0
    response: str = "min_eig"  # corner response (extractor preset)
    essential_solver: str = "five_point"  # five_point | eight_point
    matcher: str = "lk"  # lk | knn. knn = the reference's alternate
    # patch-SSD matcher (kNNFeatureMatcher.cpp): fresh corners every frame
    # + k-nearest SSD association — the high-density fallback path
    # (BASELINE.json config #3). In knn mode StepState.blocks carries the
    # previous level-0 image instead of LK region blocks.
    knn_k: int = 7  # spatial nearest neighbors (kNNFeatureMatcher.h:28)
    knn_window: int = 15  # SSD patch side (kNNFeatureMatcher.h:10)
    knn_threshold: float = 2.0  # SSD accept threshold (kNNFeatureMatcher.h:11)
    knn_cand_per_tile: int = 101  # fresh corners per tile (~1000/frame,
    # kNNFeatureMatcher.cpp:3-10)
    bundle_size: int = 5
    ba_iters: int = 5
    ba_obs_gate_px: float = 0.0  # initial-residual observation gate (px)
    ba_cadence: int = 0  # frames between BA calls; 0 = reference cadence
    # (bundle_size//3*2, OdometryPipeline.cpp:407)
    cont_tri: bool = False  # continuous triangulation on PnP frames:
    # midpoint-triangulate unbound tracked slots from the accepted relative
    # pose and insert them (steps.continuous_triangulate). Keeps the map
    # dense so the five-point bootstrap becomes cold-start-only instead of
    # re-firing every 6-18 frames. The reference has no counterpart — its
    # map decays between bootstraps by construction (landmarks only born at
    # OpenCVFivePointTri.cpp:36-53) — so this is OFF in parity configs.
    cont_tri_reproj_px: float = 2.0
    cont_tri_min_depth: float = 1.0
    cont_tri_max_depth: float = 120.0
    ba_lm_cap: int = 0  # max unique landmarks per BA window; 0 = P*N
    # (bundle_size x feature capacity) — the true maximum, so NO
    # observation can ever be dropped. The unique-landmark compaction still
    # shrinks the dense Schur tensors from map_capacity (8192) to ~P*N
    # (2560 at defaults); a smaller explicit cap trades BA cost for drop
    # risk: a saturated cap silently masks a biased observation subset,
    # measured to drive steady heading drift (tuned seed-1 598-frame ATE
    # 90 m at cap 2N vs 6.9 m uncapped-equivalent; parity seed-2 168 m at
    # 4N — artifacts/diag). StepState.ba_overflow counts saturated calls.
    traj_cap: int = 1024  # device trajectory capacity (frames)
    lk_impl: str = "tap"  # LK tracker: tap | pallas (steps.resolve_lk_impl)
    map_hist_rows: int = 0  # landmark-position snapshot rows (0 = off).
    # The reference's drawMap reads each landmark's CURRENT position at draw
    # time (OdometryPipeline.cpp:110-127); positions only change at BA, so a
    # per-BA-cadence snapshot of map.xyz ((rows, M, 3) in HBM, ~96 KB/row at
    # M=8192) lets the post-run replay draw frame k's dots where they were
    # THEN, not at their final optimized coordinates. Row k//cadence is
    # (re)written every frame, so insertions between BA calls are captured.


class StepState(NamedTuple):
    """Device-resident state threaded through frames.

    Nothing here is fetched to the host in the steady-state loop — the
    trajectory and per-frame table histories live on device so the whole
    run is a chain of dispatches with one final readback.
    """

    blocks: tuple  # per-level (region (N,Rg,Rg), r0 (N,), c0 (N,)) LK blocks
    # of the current frame — the next track's template source (template reuse
    # halves the per-frame block gathers)
    table: FeatureTable
    map: MapState
    R: jax.Array  # (3, 3) current world pose
    t: jax.Array  # (3,)
    R_s: jax.Array  # (3, 3) last accepted delta
    t_s: jax.Array  # (3,)
    scale: jax.Array  # () GT-derived step scale
    k: jax.Array  # () i32 — current frame index
    R_hist: jax.Array  # (T, 3, 3) trajectory history
    t_hist: jax.Array  # (T, 3)
    # Full per-frame observation history (feature tables for every processed
    # frame, ~7 KB/frame in HBM). The reference annotates every frame during
    # the run and draws the CURRENT frame's landmark associations in drawMap
    # (OdometryPipeline.cpp:110-127); persisting the tables lets the fused
    # production path feed the video annotator and the global-refinement
    # layer (parallel/global_refine.py) without re-running in modular mode.
    # Slot j holds frame j's FINAL table: the triangulation branch back-writes
    # the source frame (OpenCVFivePointTri.cpp:51), so step j+1 re-writes
    # slot j with the updated source table. The sliding BA window (ba_step)
    # reads its last-bundle_size frames directly from these rows, so the
    # history doubles as the BA feature ring.
    tbl_xy_hist: jax.Array  # (T, N, 2)
    tbl_valid_hist: jax.Array  # (T, N)
    tbl_lm_hist: jax.Array  # (T, N)
    # Landmark-position snapshots at BA cadence (StepConfig.map_hist_rows;
    # (rows, M, 3), rows may be 0 = disabled). Read back only when the run
    # renders video (viz/render.py replay).
    map_hist: jax.Array = None
    # Number of BA calls whose unique-landmark table saturated ba_lm_cap
    # (observations were dropped — the run should warn; see ba_step).
    ba_overflow: jax.Array = None


def init_state(
    pyr: tuple,
    table: FeatureTable,
    map_state: MapState,
    cfg: StepConfig,
) -> StepState:
    """Fresh state at frame 0."""
    N = table.capacity
    eye = jnp.eye(3, dtype=jnp.float32)
    T = cfg.traj_cap
    if cfg.matcher == "knn":
        # kNN matching needs only the previous level-0 image.
        blocks = ((pyr[0],),)
    else:
        lk = steps.lk_module(cfg.lk_impl)

        blocks = lk.capture_blocks(
            tuple(pyr), table.xy, win=cfg.lk_window,
            search=cfg.lk_search if cfg.lk_search > 0 else None,
        )
    return StepState(
        blocks=blocks,
        table=table,
        map=map_state,
        R=eye,
        t=jnp.zeros(3, jnp.float32),
        R_s=eye,
        t_s=jnp.zeros(3, jnp.float32),
        scale=jnp.float32(1.0),
        k=jnp.int32(0),
        R_hist=jnp.broadcast_to(eye, (T, 3, 3)).copy(),
        t_hist=jnp.zeros((T, 3), jnp.float32),
        tbl_xy_hist=jnp.zeros((T, N, 2), jnp.float32).at[0].set(table.xy),
        tbl_valid_hist=jnp.zeros((T, N), jnp.bool_).at[0].set(table.valid),
        tbl_lm_hist=jnp.full((T, N), -1, jnp.int32).at[0].set(table.landmark),
        map_hist=jnp.zeros(
            (cfg.map_hist_rows, map_state.capacity, 3), jnp.float32
        ),
        ba_overflow=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "steady"))
def frame_step(
    state: StepState,
    next_img: jax.Array,
    gt_step: jax.Array,
    key: jax.Array,
    K: jax.Array,
    cfg: StepConfig,
    steady: bool = False,
):
    """Process one frame. Returns (new_state, src_table', stats).

    ``src_table'`` is the previous frame's table with any landmark bindings
    added by the triangulation branch (the reference also back-writes the
    source frame, OpenCVFivePointTri.cpp:51) — the host keeps it for BA
    windows.

    ``steady=True`` compiles the steady-state program: the PnP/tri pose
    cond, the (no-op-under-PnP) triangulation registration, and the
    source-table hist back-writes are all removed — PnP runs
    unconditionally. Valid ONLY while the map stays dense (``n3d >=
    tracked_tol`` every frame); stats still report ``used_pnp`` = the
    condition the full program would have branched on, so a steady chunk
    with ``any(~used_pnp)`` is a detected violation the host must replay
    with the full program (pipeline/odometry.py run()).
    """
    next_pyr = tuple(build_pyramid(next_img, cfg.lk_levels))

    if cfg.matcher == "knn":
        # Alternate matcher (kNNFeatureMatcher.cpp): fresh corners every
        # frame + k-nearest patch-SSD association; the previous level-0
        # image rides in blocks[0][0].
        from pmv_tpu.frontend import knn_matcher

        prev_img = state.blocks[0][0]
        kc_xy, _, kc_valid = corners.grid_extract(
            next_pyr[0], cfg.knn_cand_per_tile,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            quality=cfg.quality, min_distance=cfg.min_distance,
            response=cfg.response,
        )
        tracked_table = knn_matcher.knn_match(
            prev_img, next_pyr[0], state.table, kc_xy, kc_valid,
            k=cfg.knn_k, window=cfg.knn_window, threshold=cfg.knn_threshold,
        )
        new_blocks = ((next_pyr[0],),)
    else:
        tracked_table, new_blocks = steps.track_step_cached(
            state.blocks, list(next_pyr), state.table,
            win=cfg.lk_window, iters=cfg.lk_iters, search=cfg.lk_search,
            impl=cfg.lk_impl,
        )
    tracked = tracked_table.num_valid()

    # --- reseed: one cond with the extraction, merge AND block recapture
    # inside, (table, blocks) as its carried operands. The alternatives
    # pay on every non-reseed frame: a branchless merge runs its top_k +
    # argsort, and a dense where-select of the blocks moves the whole
    # ~25 MB block pytree. ---
    reseed_tol = cfg.reseed_tol if cfg.reseed_tol > 0 else cfg.tracked_tol
    fire = tracked < reseed_tol

    def do_reseed(op):
        tbl, _ = op
        cand_xy, cand_score, cand_valid = corners.grid_extract(
            next_pyr[0], cfg.n_per_tile,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            quality=cfg.quality, min_distance=cfg.min_distance,
            response=cfg.response,
        )
        tbl2 = steps.reseed_merge(
            tbl, cand_xy, cand_score, cand_valid,
            min_distance=cfg.min_distance,
        )
        if cfg.matcher == "knn":
            return tbl2, new_blocks  # knn carries the raw image; no capture
        # Reseeded slots moved: the cached blocks no longer cover them.
        lk = steps.lk_module(cfg.lk_impl)
        blocks2 = lk.capture_blocks(
            next_pyr, tbl2.xy, win=cfg.lk_window,
            search=cfg.lk_search if cfg.lk_search > 0 else None,
        )
        return tbl2, blocks2

    next_table, new_blocks = lax.cond(
        fire, do_reseed, lambda op: op, (tracked_table, new_blocks)
    )

    # --- pose: PnP vs essential-matrix bootstrap. Only per-slot deltas
    # cross the cond; the map/table updates are applied branchlessly
    # outside (kill/insert are exact no-ops under a false mask). ---
    n3d = state.table.count_3d(state.map.alive)
    is_pnp = n3d >= cfg.tracked_tol
    key_pose, _ = jax.random.split(key)
    N = state.table.capacity

    def pnp_branch(op):
        src, nxt = op
        X_std, uv, mask, _ = steps.pnp_inputs(src, nxt, state.map, state.R, state.t)
        R_d, t_d, inliers = pnp.solve_pnp_ransac(
            X_std, uv, mask, K, key_pose, state.R_s, state.t_s,
            n_hypos=cfg.pnp_hypos, thresh_px=cfg.pnp_thresh,
        )
        return (
            R_d, t_d, mask, inliers,
            jnp.zeros((N, 3), jnp.float32), jnp.zeros((N,), jnp.bool_),
            state.scale, jnp.sum(inliers),
        )

    def tri_branch(op):
        src, nxt = op
        corr = src.valid & nxt.valid
        if cfg.essential_solver == "five_point":
            from pmv_tpu.solvers.five_point import (
                find_essential_5pt_ransac,
                ransac_budget,
            )

            E, inl = find_essential_5pt_ransac(
                src.xy, nxt.xy, corr, K, key_pose,
                n_hypos=ransac_budget(cfg.e_hypos), thresh_px=cfg.e_thresh,
            )
        else:
            E, inl = essential.find_essential_ransac(
                src.xy, nxt.xy, corr, K, key_pose,
                n_hypos=cfg.e_hypos, thresh_px=cfg.e_thresh,
            )
        R_d, t_unit, X_tri, front = essential.recover_pose(E, src.xy, nxt.xy, inl, K)
        zN = jnp.zeros((N,), jnp.bool_)
        return (
            R_d, t_unit * gt_step, zN, zN,
            X_tri, inl & front, gt_step, jnp.sum(inl & front),
        )

    if steady:
        # Steady state: PnP always taken. tri_good is all-false there, so
        # register_triangulated is an exact no-op — skip it and the source
        # back-write entirely (src_table == state.table bit-for-bit).
        R_d, t_d, pnp_used, pnp_inl, X_tri, tri_good, scale, n_inl = (
            pnp_branch((state.table, next_table))
        )
        new_map = steps.kill_outlier_landmarks(
            state.map, state.table.landmark, pnp_used, pnp_inl
        )
        src_table = state.table
    else:
        R_d, t_d, pnp_used, pnp_inl, X_tri, tri_good, scale, n_inl = lax.cond(
            is_pnp, pnp_branch, tri_branch, (state.table, next_table)
        )
        # Branchless updates: exactly one of the two masks is non-empty.
        new_map = steps.kill_outlier_landmarks(
            state.map, state.table.landmark, pnp_used, pnp_inl
        )
        src_table, next_table, new_map = steps.register_triangulated(
            state.table, next_table, new_map, X_tri, tri_good, scale,
            state.R, state.t,
        )

    R_new, t_new, R_s_new, t_s_new, accepted = motion_gate(
        R_d, t_d, state.R, state.t, state.R_s, state.t_s, scale
    )

    if cfg.cont_tri:
        # Map maintenance AFTER the pose is known: triangulate unbound
        # tracked slots against the accepted pose (no-op when the gate
        # rejected or the tri branch just rebuilt the map).
        src_table, next_table, new_map = steps.continuous_triangulate(
            src_table, next_table, new_map,
            state.R, state.t, R_new, t_new, K,
            enable=accepted & is_pnp,
            reproj_px=cfg.cont_tri_reproj_px,
            min_depth=cfg.cont_tri_min_depth,
            max_depth=cfg.cont_tri_max_depth,
        )

    k_new = state.k + 1

    new_state = StepState(
        blocks=new_blocks,
        table=next_table,
        map=new_map,
        R=R_new,
        t=t_new,
        R_s=R_s_new,
        t_s=t_s_new,
        scale=scale,
        k=k_new,
        R_hist=state.R_hist.at[k_new].set(R_new),
        t_hist=state.t_hist.at[k_new].set(t_new),
        # Steady mode without cont_tri: src_table == state.table, whose
        # values already sit in row state.k from the previous step — only
        # the new row is written. (cont_tri back-binds landmarks into the
        # source row, so it needs the double write in both modes.)
        tbl_xy_hist=(
            state.tbl_xy_hist.at[k_new].set(next_table.xy)
            if steady and not cfg.cont_tri
            else state.tbl_xy_hist.at[state.k].set(src_table.xy).at[k_new].set(next_table.xy)
        ),
        tbl_valid_hist=(
            state.tbl_valid_hist.at[k_new].set(next_table.valid)
            if steady and not cfg.cont_tri
            else state.tbl_valid_hist.at[state.k].set(src_table.valid).at[k_new].set(next_table.valid)
        ),
        tbl_lm_hist=(
            state.tbl_lm_hist.at[k_new].set(next_table.landmark)
            if steady and not cfg.cont_tri
            else state.tbl_lm_hist.at[state.k].set(src_table.landmark).at[k_new].set(next_table.landmark)
        ),
        map_hist=state.map_hist,
        ba_overflow=state.ba_overflow,
    )
    stats = {
        "tracked": tracked,
        "n3d": n3d,
        "inliers": n_inl,
        "accepted": accepted,
        "used_pnp": n3d >= cfg.tracked_tol,
    }
    return new_state, src_table, stats


@functools.partial(jax.jit, static_argnames=("cfg", "steady"))
def chunk_step(
    state: StepState,
    imgs_u8: jax.Array,  # (C, H, W) uint8
    gt_steps: jax.Array,  # (C,)
    keys: jax.Array,  # (C, 2) uint32
    K: jax.Array,
    cfg: StepConfig,
    steady: bool = False,
):
    """Process C frames in ONE dispatch (lax.scan over frame_step +
    cadenced ba_step).

    Each dispatch and upload has a fixed host-side cost; scanning C frames
    per call amortizes it to ~overhead/C. Frames are shipped uint8 (4x less transfer than f32) and
    converted on device. Returns (state, per-frame stats pytree (C, ...)).

    ``steady=True`` scans the cond-free steady-state frame_step (see its
    docstring); the host validates ``stats['used_pnp'].all()`` at the end
    of the run and replays with the full program on violation.
    """
    cadence = cfg.ba_cadence if cfg.ba_cadence > 0 else max(1, cfg.bundle_size // 3 * 2)

    def body(s, xs):
        img_u8, gt, key = xs
        s, _, stats = frame_step(
            s, img_u8.astype(jnp.float32), gt, key, K, cfg, steady=steady
        )
        j = s.k - 1
        do_ba = (cfg.bundle_size > 0) & (j > 0) & (j % cadence == 0)
        s = lax.cond(do_ba, lambda ss: ba_step(ss, K, cfg), lambda ss: ss, s)
        if cfg.map_hist_rows > 0:
            # Snapshot the landmark positions for the replay (row k//cadence,
            # re-written each frame of the cadence group so insertions land).
            row = jnp.minimum(s.k // cadence, cfg.map_hist_rows - 1)
            s = s._replace(map_hist=s.map_hist.at[row].set(s.map.xyz))
        return s, stats

    return lax.scan(body, state, (imgs_u8, gt_steps, keys))


@functools.partial(jax.jit, static_argnames=("cfg",))
def ba_step(state: StepState, K: jax.Array, cfg: StepConfig) -> StepState:
    """Device-resident sliding-window BA: state -> state, zero host traffic.

    Window semantics match CeresBundleAdjustment.cpp:5-8: after processing
    frame k, the window is the last ``bundle_size`` frames [k-P+1, k]
    (global frame 0 held fixed). Feature tables come straight from the
    device-resident per-frame history rows; poses come from the trajectory
    history and are written back in place.
    """
    P = cfg.bundle_size
    T = cfg.traj_cap
    fn = state.k + 1
    f_ids = fn - P + jnp.arange(P)  # window frame indices (may be < 0 early)
    present = f_ids >= 0
    f_safe = jnp.clip(f_ids, 0)

    xy = state.tbl_xy_hist[f_safe]
    valid = state.tbl_valid_hist[f_safe] & present[:, None]
    lm = state.tbl_lm_hist[f_safe]
    obs_uv, obs_pose, obs_lm, obs_mask = steps.assemble_ba_window(
        xy, valid, lm, state.map
    )
    tr = geo.pose_to_ba_params(state.R_hist[f_safe], state.t_hist[f_safe])
    pose_free = f_ids >= 1

    # Compact the window to its unique landmarks: the solver's block tensors
    # are dense over the landmark axis, so shrinking it from map_capacity to
    # the window's live landmarks cuts BA cost ~an order of magnitude. The
    # unique table is capped (slot-aligned tracking keeps a window's unique
    # count well under P*N — one slot binds one landmark between reseeds);
    # observations of landmarks beyond the cap are masked out instead of
    # mis-indexed.
    N_cap = xy.shape[1]
    # Drop-free default: a window can't contain more distinct LIVE ids than
    # the map has slots, so min(P*N, capacity) is still structurally
    # drop-free. (The clamp also matters operationally: at the high-density
    # shape P*N = 10240 > capacity = 8192 the clamp keeps the unique
    # table at 8192 rows.)
    L_win = (
        cfg.ba_lm_cap
        if cfg.ba_lm_cap > 0
        else min(P * N_cap, state.map.capacity)
    )
    big = jnp.int32(state.map.capacity)
    ids = jnp.where(obs_mask, obs_lm, big)
    uniq = jnp.unique(ids, size=L_win, fill_value=big)
    local = jnp.searchsorted(uniq, ids).astype(jnp.int32)
    local = jnp.minimum(local, L_win - 1)
    kept = uniq[local] == ids
    # Saturation observability: count calls that actually DROPPED an
    # observation (a live id absent from the saturated unique table) — a
    # merely-full table with zero drops is fine (with the default drop-free
    # cap L_win = P*N a window can hold exactly L_win distinct landmarks).
    saturated = jnp.any(obs_mask & ~kept).astype(jnp.int32)
    obs_mask = obs_mask & kept
    uniq_safe = jnp.minimum(uniq, state.map.capacity - 1)
    lm_local = state.map.xyz[uniq_safe]

    # Grid solver: the window is pose-major slot-aligned, so observations
    # reshape to a dense (P, N) grid and assembly becomes one-hot matmuls
    # instead of scatter-adds (schur_lm.assemble_blocks_grid; at
    # high-density sizes the one-hot is built per landmark chunk inside the
    # solver — same matmul assembly, bounded working set).
    tr_out, lm_local_out, _ = schur_lm.ba_solve_grid(
        tr,
        lm_local,
        obs_uv.reshape(P, N_cap, 2),
        local.reshape(P, N_cap),
        obs_mask.reshape(P, N_cap),
        pose_free,
        K,
        iters=cfg.ba_iters,
        obs_gate_px=cfg.ba_obs_gate_px,
    )
    R_new, t_new = geo.ba_params_to_pose(tr_out)
    # Scatter optimized landmarks back to the global map (pad-row trick for
    # the fill slots).
    lm_valid = uniq < big
    scatter_idx = jnp.where(lm_valid, uniq_safe, state.map.capacity).astype(jnp.int32)
    map_xyz = jnp.concatenate([state.map.xyz, jnp.zeros((1, 3), jnp.float32)])
    lm_out = map_xyz.at[scatter_idx].set(lm_local_out)[: state.map.capacity]

    # Scatter back only the free poses (pad-row trick avoids duplicate-index
    # clobbering from the clipped early-window ids).
    idx = jnp.where(pose_free, f_ids, T).astype(jnp.int32)
    R_hist = jnp.concatenate([state.R_hist, jnp.zeros((1, 3, 3), jnp.float32)])
    R_hist = R_hist.at[idx].set(R_new)[:T]
    t_hist = jnp.concatenate([state.t_hist, jnp.zeros((1, 3), jnp.float32)])
    t_hist = t_hist.at[idx].set(t_new)[:T]

    return state._replace(
        map=state.map._replace(xyz=lm_out),
        R_hist=R_hist,
        t_hist=t_hist,
        R=R_hist[state.k],
        t=t_hist[state.k],
        ba_overflow=state.ba_overflow + saturated,
    )
