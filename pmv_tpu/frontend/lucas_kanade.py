"""Batched pyramidal Lucas-Kanade sparse optical flow in plain XLA.

Rewrite of the reference's tracker call
``cv::calcOpticalFlowPyrLK(prev, next, pts, ..., Size(32, 32), 4)``
(OpenCVLucasKanadeFM.cpp:15). The tracker never gathers individual pixels:

- every feature's *search region* is loaded once per pyramid level as a
  contiguous block (one vmapped ``lax.dynamic_slice`` -> block gather);
- all pixels of an LK window share ONE fractional offset, so a subpixel
  window is separable: ``T_row @ region @ T_col^T`` with two-tap bilinear
  "tap" matrices (batched matmuls, no gathers);
- the iteration loop only re-samples windows of the per-feature search
  regions.

``pmv_tpu.frontend.pallas_lk`` runs the same per-level algorithm as one
Pallas kernel per level.

Convention: feature positions are (u=column, v=row) float32 pixels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# Precision of the subpixel sampling matmuls. A reduced-precision pass
# (TF32 on the GPU's tensor cores keeps ~10 mantissa bits) quantizes the
# fractional tap weights, which is fatal for subpixel tracking: pin full f32.
SAMPLE_PRECISION = jax.lax.Precision.HIGHEST


def bilinear_sample(img: jax.Array, y: jax.Array, x: jax.Array) -> jax.Array:
    """Pointwise bilinear sampling (kept for small-N utility uses — the
    tracker itself uses the block formulation below)."""
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.000001)
    y = jnp.clip(y, 0.0, H - 1.000001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    dx = x - x0
    dy = y - y0
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - dy) * (1 - dx)
        + v01 * (1 - dy) * dx
        + v10 * dy * (1 - dx)
        + v11 * dy * dx
    )


def _slice_blocks(img: jax.Array, r0: jax.Array, c0: jax.Array, size: int) -> jax.Array:
    """(N,) integer top-left corners -> (N, size, size) blocks.
    lax.dynamic_slice clamps starts so the slice stays in bounds."""
    return jax.vmap(
        lambda r, c: lax.dynamic_slice(img, (r, c), (size, size))
    )(r0, c0)


def _frac_shift(base: jax.Array, dr: jax.Array, dc: jax.Array) -> jax.Array:
    """Subpixel window from an integer base block: (N, S, S) + per-feature
    fractional offsets (dr, dc) in [0, 1) -> (N, S-1, S-1) bilinear windows,
    as a weighted sum of the 4 integer-shifted dense sub-blocks."""
    w00 = (1 - dr) * (1 - dc)
    w01 = (1 - dr) * dc
    w10 = dr * (1 - dc)
    w11 = dr * dc
    return (
        w00[:, None, None] * base[:, :-1, :-1]
        + w01[:, None, None] * base[:, :-1, 1:]
        + w10[:, None, None] * base[:, 1:, :-1]
        + w11[:, None, None] * base[:, 1:, 1:]
    )


def _tap_matrix(start: jax.Array, out_size: int, in_size: int) -> jax.Array:
    """Per-feature separable bilinear sampling matrix.

    ``start`` (N,) float local coordinates; returns (N, out_size, in_size)
    with row i carrying the two-tap bilinear weights for position
    ``start + i``. Bilinear interpolation is separable, so a subpixel
    (out, out) window of a region is ``T_row @ region @ T_col^T`` — two
    batched matmuls, no gathers.
    """
    i0 = jnp.floor(start)
    fr = (start - i0)[:, None, None]
    pos = i0[:, None, None] + jax.lax.broadcasted_iota(
        start.dtype, (1, out_size, 1), 1
    )
    r_idx = jax.lax.broadcasted_iota(start.dtype, (1, 1, in_size), 2)
    return (r_idx == pos) * (1 - fr) + (r_idx == pos + 1) * fr


def _sample_window(region: jax.Array, lr: jax.Array, lc: jax.Array, win: int) -> jax.Array:
    """Bilinear (N, win, win) windows from (N, Rg, Rg) regions at per-feature
    float top-left (lr, lc) — two batched matmuls, no gathers."""
    Rg = region.shape[-1]
    Tr = _tap_matrix(lr, win, Rg)  # (N, win, Rg)
    Tc = _tap_matrix(lc, win, Rg)  # (N, win, Rg)
    tmp = jnp.einsum(
        "nwr,nrc->nwc", Tr, region,
        preferred_element_type=jnp.float32, precision=SAMPLE_PRECISION,
    )
    return jnp.einsum(
        "nwc,nvc->nwv", tmp, Tc,
        preferred_element_type=jnp.float32, precision=SAMPLE_PRECISION,
    )


def _pad_for(win: int, search: int) -> int:
    """Image padding so every block slice fits (edge replication)."""
    return win + 2 * search + 4


def region_size(win: int, search: int) -> int:
    """Side length of the per-feature search-region block.

    ``win + 3*search + 4``: the (win, win) sample window, +-search of
    iteration freedom, plus an extra 1.5*search margin + bilinear/gradient
    taps — sized so the block doubles as the NEXT frame's template source:
    the feature's final position after the remaining (lower) pyramid levels
    refine it stays inside the block for any refinement up to ~1.5*search at
    this level's scale (larger drifts invalidate the track, see
    :func:`track_cached`).
    """
    return win + 3 * search + 4


def _resolve_search(win: int, search: int | None) -> int:
    return max(4, win // 2) if search is None else search


def _template_stats(F: jax.Array, win: int):
    """Template T, gradients and normal-matrix terms from a sampled
    (N, win+2, win+2) window F."""
    T = F[:, 1:-1, 1:-1]
    Ix = (F[:, 1:-1, 2:] - F[:, 1:-1, :-2]) * 0.5
    Iy = (F[:, 2:, 1:-1] - F[:, :-2, 1:-1]) * 0.5
    Gxx = jnp.sum(Ix * Ix, axis=(1, 2))
    Gxy = jnp.sum(Ix * Iy, axis=(1, 2))
    Gyy = jnp.sum(Iy * Iy, axis=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    mean = (Gxx + Gyy) * 0.5
    rad = jnp.sqrt(jnp.maximum(((Gxx - Gyy) * 0.5) ** 2 + Gxy * Gxy, 0.0))
    min_eig = (mean - rad) / (win * win)
    inv_det = jnp.where(det > 1e-6, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    return T, Ix, Iy, Gxx, Gxy, Gyy, inv_det, min_eig


def region_origin(center: jax.Array, win: int, search: int, H: int, W: int):
    """(N,) integer top-left corners of the (Rg, Rg) search regions around
    ``center`` (float positions in padded-image coords) in an (H, W) padded
    image, clipped so the block stays inside it."""
    Rg = region_size(win, search)
    half = (win - 1) / 2.0
    m = (Rg - win) // 2  # center the block on the capture position
    r0 = jnp.clip(
        jnp.floor(center[:, 1] - half).astype(jnp.int32) - m,
        0, max(H - Rg, 0),
    )
    c0 = jnp.clip(
        jnp.floor(center[:, 0] - half).astype(jnp.int32) - m,
        0, max(W - Rg, 0),
    )
    return r0, c0


def _capture_region(img_padded: jax.Array, center: jax.Array, win: int, search: int):
    """Slice the per-feature (Rg, Rg) search-region block around ``center``
    (float positions in padded-image coords). Returns (region, r0, c0)."""
    r0, c0 = region_origin(center, win, search, *img_padded.shape)
    return _slice_blocks(img_padded, r0, c0, region_size(win, search)), r0, c0


def _iterate(region, reg_r0, reg_c0, T, Ix, Iy, Gxx, Gxy, Gyy, inv_det,
             guess_padded, win: int, iters: int):
    """The LK iteration loop on a preloaded region block; positions in
    padded-image coords."""
    Rg = region.shape[-1]

    def body(_, g):
        half = (win - 1) / 2.0
        lr = jnp.clip(g[:, 1] - half - reg_r0, 0.0, Rg - win - 1.000001)
        lc = jnp.clip(g[:, 0] - half - reg_c0, 0.0, Rg - win - 1.000001)
        I = _sample_window(region, lr, lc, win)
        r = T - I
        bx = jnp.sum(r * Ix, axis=(1, 2))
        by = jnp.sum(r * Iy, axis=(1, 2))
        du = (Gyy * bx - Gxy * by) * inv_det
        dv = (Gxx * by - Gxy * bx) * inv_det
        return g + jnp.stack([du, dv], axis=-1)

    return lax.fori_loop(0, iters, body, guess_padded)


@functools.partial(jax.jit, static_argnames=("win", "iters", "search"))
def _track_level(
    prev_img: jax.Array,
    next_img: jax.Array,
    pts_level: jax.Array,
    guess: jax.Array,
    win: int,
    iters: int,
    search: int,
) -> tuple[jax.Array, jax.Array]:
    """One pyramid level of LK (fresh template). Returns
    (new guess (N, 2), min_eig (N,))."""
    # Pad all sides so every slice window fits regardless of feature position
    # (border behavior = edge replication, like the old clip-based sampler);
    # pixel coordinates shift by PAD.
    PAD = _pad_for(win, search)
    prev_img = jnp.pad(prev_img, PAD, mode="edge")
    next_img = jnp.pad(next_img, PAD, mode="edge")
    H, W = prev_img.shape
    half = (win - 1) / 2.0

    # --- template: fractional (win+2, win+2) window around pts, then T and
    # central-difference gradients (all dense) ---
    TS = win + 4  # template block: win+2 sampled window + 2-tap margin
    tl_r = pts_level[:, 1] + PAD - half - 1.0
    tl_c = pts_level[:, 0] + PAD - half - 1.0
    tr0 = jnp.clip(jnp.floor(tl_r), 0, H - TS)
    tc0 = jnp.clip(jnp.floor(tl_c), 0, W - TS)
    base = _slice_blocks(prev_img, tr0.astype(jnp.int32), tc0.astype(jnp.int32), TS)
    F = _sample_window(
        base,
        jnp.clip(tl_r - tr0, 0.0, 1.0),
        jnp.clip(tl_c - tc0, 0.0, 1.0),
        win + 2,
    )  # (N, win+2, win+2)
    T, Ix, Iy, Gxx, Gxy, Gyy, inv_det, min_eig = _template_stats(F, win)

    # --- search region in next image, loaded ONCE per level ---
    region, reg_r0, reg_c0 = _capture_region(next_img, guess + PAD, win, search)
    g = _iterate(
        region, reg_r0, reg_c0, T, Ix, Iy, Gxx, Gxy, Gyy, inv_det,
        guess + PAD, win, iters,
    )
    return g - PAD, min_eig


def _track_level_cached(
    blk: jax.Array,       # (N, Rg, Rg) block of the PREV frame's level image
    blk_r0: jax.Array,    # (N,) block origins in padded coords
    blk_c0: jax.Array,
    next_img: jax.Array,  # this frame's level image (unpadded)
    pts_level: jax.Array,
    guess: jax.Array,
    win: int,
    iters: int,
    search: int,
):
    """One LK level sampling the template from a cached region block instead
    of re-gathering the previous image (halves the per-frame block loads).
    Returns (new guess, min_eig, (region, r0, c0)) — the region block doubles
    as the next frame's template source."""
    PAD = _pad_for(win, search)
    Rg = region_size(win, search)
    next_img = jnp.pad(next_img, PAD, mode="edge")
    half = (win - 1) / 2.0

    lim = Rg - (win + 2) - 1e-5
    raw_r = pts_level[:, 1] + PAD - half - 1.0 - blk_r0
    raw_c = pts_level[:, 0] + PAD - half - 1.0 - blk_c0
    # A feature that drifted outside its cached block would silently sample a
    # shifted (wrong) template — flag it instead; the caller drops the track
    # (it gets re-seeded like any other loss).
    ok = (raw_r > -0.75) & (raw_r < lim + 0.75) & (raw_c > -0.75) & (raw_c < lim + 0.75)
    F = _sample_window(
        blk, jnp.clip(raw_r, 0.0, lim), jnp.clip(raw_c, 0.0, lim), win + 2
    )
    T, Ix, Iy, Gxx, Gxy, Gyy, inv_det, min_eig = _template_stats(F, win)

    region, reg_r0, reg_c0 = _capture_region(next_img, guess + PAD, win, search)
    g = _iterate(
        region, reg_r0, reg_c0, T, Ix, Iy, Gxx, Gxy, Gyy, inv_det,
        guess + PAD, win, iters,
    )
    return g - PAD, min_eig, ok, (region, reg_r0, reg_c0)


@functools.partial(jax.jit, static_argnames=("win", "search"))
def capture_blocks(
    pyr: tuple,
    pts: jax.Array,
    win: int = 32,
    search: int | None = None,
) -> tuple:
    """Per-level search-region blocks around ``pts`` — the template source
    for the NEXT ``track_cached`` call (used at init and after reseeding,
    when cached blocks don't cover the new feature positions)."""
    search = _resolve_search(win, search)
    PAD = _pad_for(win, search)
    out = []
    for lvl, img in enumerate(pyr):
        s = 2.0 ** lvl
        img_p = jnp.pad(img, PAD, mode="edge")
        out.append(_capture_region(img_p, pts / s + PAD, win, search))
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("win", "iters", "search"))
def track_cached(
    blocks: tuple,
    next_pyr: list[jax.Array],
    pts: jax.Array,
    valid: jax.Array,
    win: int = 32,
    iters: int = 10,
    min_eig_threshold: float = 1e-4,
    search: int | None = None,
) -> tuple[jax.Array, jax.Array, tuple]:
    """Like :func:`track`, but the per-level templates come from ``blocks``
    (the region blocks returned by the previous call / capture_blocks), so
    only ONE block gather per level is issued per frame.

    Returns (new_pts, status, new_blocks).
    """
    levels = len(next_pyr)
    H, W = next_pyr[0].shape
    search = _resolve_search(win, search)
    scale_top = 2.0 ** (levels - 1)
    guess = pts / scale_top
    min_eig0 = jnp.zeros(pts.shape[0], pts.dtype)
    ok_all = jnp.ones(pts.shape[0], bool)
    new_blocks = []
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        blk, br0, bc0 = blocks[lvl]
        guess, min_eig0, ok, captured = _track_level_cached(
            blk, br0, bc0, next_pyr[lvl], pts / s, guess, win, iters, search
        )
        ok_all = ok_all & ok
        new_blocks.append(captured)
        if lvl > 0:
            guess = guess * 2.0
    new_pts = guess
    inside = (
        (new_pts[:, 0] >= 0)
        & (new_pts[:, 0] <= W - 1)
        & (new_pts[:, 1] >= 0)
        & (new_pts[:, 1] <= H - 1)
    )
    status = valid & inside & ok_all & (min_eig0 > min_eig_threshold)
    return new_pts, status, tuple(reversed(new_blocks))


def track(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    pts: jax.Array,
    valid: jax.Array,
    win: int = 32,
    iters: int = 10,
    min_eig_threshold: float = 1e-4,
    search: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Track (N, 2) points from prev to next through the pyramids.

    Returns (new_pts (N, 2), status (N,) bool). Status clears when the point
    leaves the image, drifts outside its per-level search region, or the
    normal matrix is degenerate (untextured window) — the mask-based
    equivalent of OpenCV's status output consumed at
    OpenCVLucasKanadeFM.cpp:21-30.
    """
    levels = len(prev_pyr)
    H, W = prev_pyr[0].shape
    if search is None:
        search = max(4, win // 2)
    scale_top = 2.0 ** (levels - 1)
    guess = pts / scale_top
    min_eig0 = jnp.zeros(pts.shape[0], pts.dtype)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0**lvl
        pts_l = pts / s
        guess, min_eig0 = _track_level(
            prev_pyr[lvl], next_pyr[lvl], pts_l, guess, win, iters, search
        )
        if lvl > 0:
            guess = guess * 2.0
    new_pts = guess
    inside = (
        (new_pts[:, 0] >= 0)
        & (new_pts[:, 0] <= W - 1)
        & (new_pts[:, 1] >= 0)
        & (new_pts[:, 1] <= H - 1)
    )
    status = valid & inside & (min_eig0 > min_eig_threshold)
    return new_pts, status
