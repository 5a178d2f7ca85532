"""Jitted per-frame device steps: track, reseed, landmark bookkeeping, BA
window assembly.

These are the fused XLA programs the host-side orchestrator
(pmv_tpu.pipeline.odometry) dispatches once per frame — the device-side
equivalent of the reference's addFrame/estimatePose inner machinery
(OdometryPipeline.cpp:329-374, :376-426) over static-shape feature tables.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pmv_tpu.core import geometry as geo
from pmv_tpu.core.state import FeatureTable, MapState, has_neighbor
from pmv_tpu.frontend import corners
from pmv_tpu.frontend import lucas_kanade as lk

# numpy, NOT jnp: a module-level device array would initialize the XLA
# backend at import time, which must not happen before a possible
# jax.distributed.initialize (multi-host bootstrap ordering).
import numpy as _np

# Full f32 for the geometry products (no TF32 on the GPU's tensor cores).
_PREC = jax.lax.Precision.HIGHEST

FLIP = _np.diag(_np.array([1.0, 1.0, -1.0], _np.float32))


def resolve_lk_impl(impl: str, backend: str, win: int) -> str:
    """The LK tracker a configured ``lk_impl`` runs on ``backend``.

    ``tap``: the plain-XLA tracker (lucas_kanade). ``pallas``: the per-level
    Pallas kernel (pallas_lk), compiled by Triton, so GPU only — asking for
    it elsewhere raises instead of falling back to the interpreter.
    ``auto``: ``pallas`` on the GPU for windows the kernel takes, ``tap``
    otherwise."""
    from pmv_tpu.frontend import pallas_lk

    if impl == "auto":
        return "pallas" if backend == "gpu" and pallas_lk.supports(win) else "tap"
    if impl == "pallas" and backend != "gpu":
        raise ValueError(
            f"lk_impl=pallas needs the GPU backend (got {backend!r}); "
            "use lk_impl=tap or auto"
        )
    if impl not in ("tap", "pallas"):
        raise ValueError(f"unknown lk_impl {impl!r} (tap | pallas | auto)")
    return impl


def lk_module(impl: str):
    """Module of a resolved tracker name (:func:`resolve_lk_impl`)."""
    if impl == "pallas":
        from pmv_tpu.frontend import pallas_lk

        return pallas_lk
    return lk


@functools.partial(jax.jit, static_argnames=("win", "iters", "search"))
def track_step(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    prev_table: FeatureTable,
    win: int = 32,
    iters: int = 10,
    search: int = 0,
) -> FeatureTable:
    """LK-track the previous frame's features into the next frame.

    Slot-aligned correspondence (the static-shape equivalent of the reference's
    ``feat_corr`` weak-ptr map, OpenCVLucasKanadeFM.cpp:19-30): slot i of the
    returned table corresponds to slot i of ``prev_table``; ``valid`` is the
    track status; the landmark association is inherited.
    """
    new_xy, status = lk.track(
        prev_pyr, next_pyr, prev_table.xy, prev_table.valid, win=win, iters=iters,
        search=search if search > 0 else None,
    )
    return FeatureTable(
        xy=new_xy,
        valid=status,
        landmark=jnp.where(status, prev_table.landmark, -1),
        score=jnp.where(status, prev_table.score, 0.0),
    )


@functools.partial(jax.jit, static_argnames=("win", "iters", "search", "impl"))
def track_step_cached(
    blocks: tuple,
    next_pyr: list[jax.Array],
    prev_table: FeatureTable,
    win: int = 32,
    iters: int = 10,
    search: int = 0,
    impl: str = "tap",
) -> tuple[FeatureTable, tuple]:
    """:func:`track_step` with the per-level templates sampled from the
    previous frame's cached region blocks (half the block gathers). Returns
    (table, new_blocks) — thread ``new_blocks`` into the next call.

    ``impl`` selects the tracker: ``tap`` (XLA tap-matrix matmuls) or
    ``pallas`` (one kernel per level, pmv_tpu.frontend.pallas_lk) — their
    blocks differ in size, so ``blocks`` must come from the matching
    module's capture_blocks."""
    mod = lk_module(impl)
    new_xy, status, new_blocks = mod.track_cached(
        blocks, next_pyr, prev_table.xy, prev_table.valid, win=win, iters=iters,
        search=search if search > 0 else None,
    )
    table = FeatureTable(
        xy=new_xy,
        valid=status,
        landmark=jnp.where(status, prev_table.landmark, -1),
        score=jnp.where(status, prev_table.score, 0.0),
    )
    return table, new_blocks


def grid_cand_count(shape, n_per_tile: int, tile_h: int, tile_w: int) -> int:
    """Static candidate capacity of corners.grid_extract for ``shape`` —
    lets a cond's false branch build matching zero arrays."""
    H, W = shape
    return (-(-H // tile_h)) * (-(-W // tile_w)) * n_per_tile


def reseed_merge(
    table: FeatureTable,
    cand_xy: jax.Array,
    cand_score: jax.Array,
    cand_valid: jax.Array,
    min_distance: int = 5,
) -> FeatureTable:
    """Merge candidate corners into the table's free slots (the cheap half
    of :func:`reseed_step`; branchless — with ``cand_valid`` all-false the
    returned table is bit-identical to the input, so the fused step can run
    the merge unconditionally and keep the expensive extraction inside a
    small-output ``lax.cond``)."""
    neigh = has_neighbor(cand_xy, table.xy, table.valid, dist=min_distance)
    ok = cand_valid & ~neigh
    # Order candidates by score (strongest first).
    order_score = jnp.where(ok, cand_score, corners.NEG)
    top_score, order = jax.lax.top_k(order_score, cand_xy.shape[0])
    cand_xy = cand_xy[order]
    ok = top_score > corners.NEG / 2

    # i-th accepted candidate -> i-th free slot (slot order).
    N = table.capacity
    free_slots = jnp.argsort(table.valid, stable=True)  # invalid slots first
    num_free = N - jnp.sum(table.valid)
    rank = jnp.cumsum(ok.astype(jnp.int32)) - 1
    ok = ok & (rank < num_free)
    target = jnp.where(ok, free_slots[jnp.clip(rank, 0, N - 1)], N)  # N = pad row

    xy = jnp.concatenate([table.xy, jnp.zeros((1, 2), table.xy.dtype)])
    xy = xy.at[target].set(cand_xy)[:N]
    score = jnp.concatenate([table.score, jnp.zeros((1,), table.score.dtype)])
    score = score.at[target].set(top_score)[:N]
    valid = jnp.concatenate([table.valid, jnp.zeros((1,), jnp.bool_)])
    valid = valid.at[target].set(True)[:N]
    landmark = jnp.concatenate([table.landmark, jnp.zeros((1,), jnp.int32)])
    landmark = landmark.at[target].set(-1)[:N]
    return FeatureTable(xy=xy, valid=valid, landmark=landmark, score=score)


@functools.partial(
    jax.jit,
    static_argnames=("n_per_tile", "tile_h", "tile_w", "quality", "min_distance", "response"),
)
def reseed_step(
    table: FeatureTable,
    img: jax.Array,
    n_per_tile: int,
    tile_h: int = 255,
    tile_w: int = 255,
    quality: float = 0.01,
    min_distance: int = 5,
    response: str = "min_eig",
) -> FeatureTable:
    """Top up the feature table from fresh grid-tiled corners.

    Mirrors the reseed path at OdometryPipeline.cpp:342-371: extract
    ``n_per_tile`` corners per tile, drop candidates with an existing
    neighbor closer than Chebyshev ``min_distance`` (Frame::hasNeighbor),
    and append the rest — here: fill empty slots in slot order, best score
    first. (Deviation: corners are extracted from the *new* frame's image;
    the reference samples the previous frame's image and pastes the
    coordinates into the new frame, OdometryPipeline.cpp:351-365.)

    Composition of the expensive extraction (corners.grid_extract) and the
    cheap :func:`reseed_merge`.
    """
    cand_xy, cand_score, cand_valid = corners.grid_extract(
        img,
        n_per_tile,
        tile_h=tile_h,
        tile_w=tile_w,
        quality=quality,
        min_distance=min_distance,
        response=response,
    )
    return reseed_merge(table, cand_xy, cand_score, cand_valid, min_distance)


@jax.jit
def pnp_inputs(
    src_table: FeatureTable,
    next_table: FeatureTable,
    map_state: MapState,
    R_prev: jax.Array,
    t_prev: jax.Array,
):
    """Gather the 2D-3D correspondences for the PnP stage.

    The reference walks ``src.map`` + ``feat_corr`` (OpenCVEPnPSolver.cpp:
    13-33): features of the source frame bound to a live landmark and
    tracked into the next frame. Landmarks are moved from the pipeline's
    z-flipped world into the previous camera's *standard* frame:
    ``X_std = flip(R_prev^T (X - t_prev))`` — exactly transformInv + the
    explicit z flip at :23-26.

    Returns (X_std (N, 3), uv (N, 2) next-frame pixels, mask (N,),
    lm_slots (N,)).
    """
    lm = src_table.landmark
    bound = lm >= 0
    lm_safe = jnp.clip(lm, 0)
    alive = map_state.alive[lm_safe] & bound
    mask = src_table.valid & next_table.valid & alive
    X_world = map_state.xyz[lm_safe]
    X_cam = geo.transform_inv(X_world, R_prev, t_prev)
    X_std = X_cam * jnp.array([1.0, 1.0, -1.0], X_cam.dtype)
    return X_std, next_table.xy, mask, lm


@jax.jit
def register_triangulated(
    src_table: FeatureTable,
    next_table: FeatureTable,
    map_state: MapState,
    X_cam_std: jax.Array,
    good: jax.Array,
    scale: jax.Array,
    R_prev: jax.Array,
    t_prev: jax.Array,
) -> tuple[FeatureTable, FeatureTable, MapState]:
    """Insert freshly triangulated landmarks into the map and bind them to
    the corresponding feature slots of both frames.

    Mirrors OpenCVFivePointTri.cpp:36-53: scale the camera-frame point by the
    GT-derived scale, flip z (pipeline convention), keep points in front
    (z < 0 after the flip), transform into the world with the current pose,
    and register in both frames' maps.
    """
    X_scaled = X_cam_std * scale
    X_flip = X_scaled * jnp.array([1.0, 1.0, -1.0], X_scaled.dtype)
    in_front = X_flip[:, 2] < 0
    insert_mask = good & in_front & src_table.valid & next_table.valid
    X_world = geo.transform(X_flip, R_prev, t_prev)
    new_map, slots = map_state.insert(X_world, insert_mask)
    lm_src = jnp.where(insert_mask, slots, src_table.landmark)
    lm_next = jnp.where(insert_mask, slots, next_table.landmark)
    return (
        src_table._replace(landmark=lm_src),
        next_table._replace(landmark=lm_next),
        new_map,
    )


@functools.partial(
    jax.jit,
    static_argnames=("reproj_px", "min_depth", "max_depth", "min_sin2"),
)
def continuous_triangulate(
    src_table: FeatureTable,
    next_table: FeatureTable,
    map_state: MapState,
    R1: jax.Array,
    t1: jax.Array,
    R2: jax.Array,
    t2: jax.Array,
    K: jax.Array,
    enable: jax.Array,
    reproj_px: float = 2.0,
    min_depth: float = 1.0,
    max_depth: float = 120.0,
    min_sin2: float = 1e-5,
) -> tuple[FeatureTable, FeatureTable, MapState]:
    """Map maintenance on PnP frames: midpoint-triangulate slots tracked in
    both frames that have no live landmark, and insert the survivors.

    The reference only creates landmarks in the bootstrap branch
    (OpenCVFivePointTri.cpp:36-53), so its map decays between bootstraps
    and the expensive five-point path re-fires every ~6-18 frames (diag
    traces). Continuously triangulating fresh (reseeded) features from the
    ALREADY-ESTIMATED relative pose keeps ``count3DPoints`` dense so the
    bootstrap becomes a true cold-start path — fewer five-point solves AND
    denser PnP/BA correspondence. One closed-form midpoint
    solve batched over all N slots (geometry.triangulate_midpoint), no
    RANSAC — gating (cheirality both views, depth band, reprojection error
    both views, parallax) replaces consensus, and PnP's outlier erase
    (kill_outlier_landmarks) reaps any survivor that still mis-tracks.

    ``enable`` is a traced scalar bool (typically ``accepted & is_pnp``);
    everything is an exact no-op when it is False.
    """
    from pmv_tpu.solvers.essential import normalize_points

    F = jnp.asarray(FLIP, R1.dtype)
    # Relative pose in STANDARD camera coords (see register_triangulated's
    # flip convention): x_std = F R^T (p_w - t).
    def mm(a, b):
        return jnp.matmul(a, b, precision=_PREC)

    R_rel = mm(mm(mm(F, R2.T), R1), F)
    t_rel = mm(F, mm(R2.T, (t1 - t2)[..., None]))[..., 0]
    x1 = normalize_points(src_table.xy, K)
    x2 = normalize_points(next_table.xy, K)
    X1_std, sin2 = geo.triangulate_midpoint(R_rel, t_rel, x1, x2)
    z1 = X1_std[..., 2]
    z2 = (mm(X1_std, R_rel.T) + t_rel)[..., 2]
    X_world = geo.transform(mm(X1_std, F), R1, t1)
    e1 = jnp.linalg.norm(
        geo.project_points(X_world, R1, t1, K) - src_table.xy, axis=-1
    )
    e2 = jnp.linalg.norm(
        geo.project_points(X_world, R2, t2, K) - next_table.xy, axis=-1
    )
    ok = (
        (z1 > min_depth) & (z1 < max_depth) & (z2 > min_depth)
        & (sin2 > min_sin2) & (e1 < reproj_px) & (e2 < reproj_px)
    )
    bound = next_table.landmark >= 0
    alive = map_state.alive[jnp.clip(next_table.landmark, 0)] & bound
    cand = src_table.valid & next_table.valid & ~alive & ok & enable
    new_map, slots = map_state.insert(X_world, cand)
    return (
        src_table._replace(
            landmark=jnp.where(cand, slots, src_table.landmark)
        ),
        next_table._replace(
            landmark=jnp.where(cand, slots, next_table.landmark)
        ),
        new_map,
    )


@jax.jit
def kill_outlier_landmarks(
    map_state: MapState, lm_slots: jax.Array, used: jax.Array, inliers: jax.Array
) -> MapState:
    """Erase landmarks whose PnP correspondence was a RANSAC outlier —
    the global erase at OpenCVEPnPSolver.cpp:40-49."""
    return map_state.kill(lm_slots, used & ~inliers)


@jax.jit
def assemble_ba_window(
    window_xy: jax.Array,       # (P, N, 2)
    window_valid: jax.Array,    # (P, N)
    window_lm: jax.Array,       # (P, N)
    map_state: MapState,
):
    """Flatten a window of feature tables into BA observation arrays.

    The reference adds one residual block per (window frame, live-landmark
    feature) (CeresBundleAdjustment.cpp:36-52). Returns (obs_uv (P*N, 2),
    obs_pose (P*N,), obs_lm (P*N,), obs_mask (P*N,)).
    """
    P, N = window_valid.shape
    bound = window_lm >= 0
    lm_safe = jnp.clip(window_lm, 0)
    alive = map_state.alive[lm_safe] & bound
    mask = window_valid & alive
    obs_pose = jnp.repeat(jnp.arange(P, dtype=jnp.int32), N)
    return (
        window_xy.reshape(P * N, 2),
        obs_pose,
        lm_safe.reshape(P * N).astype(jnp.int32),
        mask.reshape(P * N),
    )


@jax.jit
def count_3d(table: FeatureTable, map_state: MapState) -> jax.Array:
    return table.count_3d(map_state.alive)
