"""Pyramidal Lucas-Kanade as one Pallas kernel per pyramid level (Triton).

Same per-level algorithm and contract as the plain-XLA tracker
``lucas_kanade.track_cached``. XLA runs that tracker's iteration loop as a
while loop of several small kernels per iteration, each re-reading the
(N, Rg, Rg) region block from device memory; here one launch per level runs
the template statistics and all ``iters`` iterations, with each feature's
region read from the L1/L2 caches.

- One program per feature (grid ``(N,)``). A program loads W x W tiles,
  W = the next power of two >= ``win`` (Triton's block shapes are powers of
  two), and masks everything outside the ``win x win`` window.
- Bilinear samples are the 4-shifted-window blend of
  ``lucas_kanade._frac_shift``: the four integer-offset tiles are dynamic
  ``pl.ds`` loads of the region ref, blended with the feature's shared
  fractional weights. fp32 throughout, no matmuls.
- Blocks keep the tap tracker's feature-major layout and origins, extended
  by ``W - win`` rows and columns of image so that every tile load stays
  inside the block (:func:`block_size`).

``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests);
it is never switched on implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pmv_tpu.frontend import lucas_kanade as lk

NUM_WARPS = 4
MAX_WIN = 32  # largest window the kernel takes (one 32 x 32 tile)


def tile(win: int) -> int:
    """Side of the power-of-two tile holding a ``win x win`` window."""
    return pl.next_power_of_2(win)


def block_size(win: int, search: int) -> int:
    """Side of the kernel's per-feature blocks: the tap tracker's region
    plus ``tile(win) - win`` so an unmasked tile load never leaves it."""
    return lk.region_size(win, search) + tile(win) - win


def supports(win: int) -> bool:
    return win <= MAX_WIN


def _bilinear(ref, r, c, fr, fc, W: int):
    """W x W bilinear window of a (B, B) ref at integer origin (r, c) and
    fraction (fr, fc): rows blended first, then columns — the association
    of the tap tracker's ``T_row @ region @ T_col^T``."""
    a = ref[pl.ds(r, W), pl.ds(c, W)]
    b = ref[pl.ds(r, W), pl.ds(c + 1, W)]
    d = ref[pl.ds(r + 1, W), pl.ds(c, W)]
    e = ref[pl.ds(r + 1, W), pl.ds(c + 1, W)]
    left = (1.0 - fr) * a + fr * d
    right = (1.0 - fr) * b + fr * e
    return (1.0 - fc) * left + fc * right


def _split(x):
    """float offset -> (int32 floor, fraction)."""
    x0 = jnp.floor(x)
    return x0.astype(jnp.int32), x - x0


def _make_kernel(Rg: int, win: int, iters: int):
    """Kernel for one feature at one level.

    Refs: blk / region (B, B) — the cached template block and this frame's
    search region; scal (8,) = [template r, template c (offsets inside
    blk), guess r, guess c (padded coords), region r0, region c0, 0, 0];
    out (8,) = [guess r', guess c', min_eig, 0 ...]."""
    W = tile(win)
    half = (win - 1) / 2.0
    t_lim = Rg - (win + 2) - 1e-5
    i_lim = Rg - win - 1.000001

    def kernel(blk_ref, reg_ref, scal_ref, out_ref):
        rows = lax.broadcasted_iota(jnp.int32, (W, W), 0)
        cols = lax.broadcasted_iota(jnp.int32, (W, W), 1)
        inside = (rows < win) & (cols < win)

        # Template statistics (lucas_kanade._template_stats): the sampled
        # (win+2)^2 window F is never formed; T, Ix and Iy are sampled
        # directly at F's interior offsets.
        ri, fr = _split(jnp.clip(scal_ref[0], 0.0, t_lim))
        ci, fc = _split(jnp.clip(scal_ref[1], 0.0, t_lim))

        def F(dr, dc):
            return _bilinear(blk_ref, ri + dr, ci + dc, fr, fc, W)

        T = jnp.where(inside, F(1, 1), 0.0)
        Ix = jnp.where(inside, (F(1, 2) - F(1, 0)) * 0.5, 0.0)
        Iy = jnp.where(inside, (F(2, 1) - F(0, 1)) * 0.5, 0.0)
        Gxx = jnp.sum(Ix * Ix)
        Gxy = jnp.sum(Ix * Iy)
        Gyy = jnp.sum(Iy * Iy)
        det = Gxx * Gyy - Gxy * Gxy
        mean = (Gxx + Gyy) * 0.5
        rad = jnp.sqrt(jnp.maximum(((Gxx - Gyy) * 0.5) ** 2 + Gxy * Gxy, 0.0))
        min_eig = (mean - rad) / (win * win)
        inv_det = jnp.where(det > 1e-6, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)

        reg_r0 = scal_ref[4]
        reg_c0 = scal_ref[5]

        def body(_, g):  # lucas_kanade._iterate
            g_r, g_c = g
            r, sr = _split(jnp.clip(g_r - half - reg_r0, 0.0, i_lim))
            c, sc = _split(jnp.clip(g_c - half - reg_c0, 0.0, i_lim))
            res = T - _bilinear(reg_ref, r, c, sr, sc, W)
            # Outside the window Ix = Iy = 0, so res needs no mask.
            bx = jnp.sum(res * Ix)
            by = jnp.sum(res * Iy)
            du = (Gyy * bx - Gxy * by) * inv_det
            dv = (Gxx * by - Gxy * bx) * inv_det
            return g_r + dv, g_c + du

        g_r, g_c = lax.fori_loop(0, iters, body, (scal_ref[2], scal_ref[3]))
        idx = lax.broadcasted_iota(jnp.int32, (8,), 0)
        out_ref[...] = jnp.where(
            idx == 0, g_r, jnp.where(idx == 1, g_c, jnp.where(idx == 2, min_eig, 0.0))
        )

    return kernel


@functools.partial(
    jax.jit, static_argnames=("win", "iters", "interpret", "num_warps")
)
def level_call(blk, region, scal, win: int, iters: int,
               interpret: bool = False, num_warps: int = NUM_WARPS):
    """One level for all N features: blk / region (N, B, B), scal (N, 8)
    -> (N, 8) rows [guess r', guess c', min_eig, ...]."""
    N, B, _ = region.shape
    Rg = B - (tile(win) - win)
    blk_spec = pl.BlockSpec((None, B, B), lambda i: (i, 0, 0))
    row_spec = pl.BlockSpec((None, 8), lambda i: (i, 0))
    return pl.pallas_call(
        _make_kernel(Rg, win, iters),
        grid=(N,),
        in_specs=[blk_spec, blk_spec, row_spec],
        out_specs=row_spec,
        out_shape=jax.ShapeDtypeStruct((N, 8), jnp.float32),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="lk_level",
    )(blk, region, scal)


def _capture(img: jax.Array, pts_level: jax.Array, win: int, search: int):
    """(N, B, B) blocks of the (unpadded) level image at the tap tracker's
    region origins. The image gets the tap tracker's edge padding plus
    ``B - Rg`` more rows and columns at the bottom and right, so the
    larger slice never shifts an origin."""
    PAD = lk._pad_for(win, search)
    H, W = img.shape
    extra = block_size(win, search) - lk.region_size(win, search)
    img_p = jnp.pad(img, ((PAD, PAD + extra), (PAD, PAD + extra)), mode="edge")
    r0, c0 = lk.region_origin(pts_level + PAD, win, search, H + 2 * PAD, W + 2 * PAD)
    return lk._slice_blocks(img_p, r0, c0, block_size(win, search)), r0, c0


def _track_level_cached(blk, blk_r0, blk_c0, next_img, pts_level, guess,
                        win, iters, search, interpret):
    """Kernel counterpart of lucas_kanade._track_level_cached (same
    contract, (N, B, B) blocks)."""
    PAD = lk._pad_for(win, search)
    Rg = lk.region_size(win, search)
    half = (win - 1) / 2.0
    lim = Rg - (win + 2) - 1e-5
    raw_r = pts_level[:, 1] + PAD - half - 1.0 - blk_r0
    raw_c = pts_level[:, 0] + PAD - half - 1.0 - blk_c0
    ok = (raw_r > -0.75) & (raw_r < lim + 0.75) & (raw_c > -0.75) & (raw_c < lim + 0.75)

    region, reg_r0, reg_c0 = _capture(next_img, guess, win, search)
    gp = guess + PAD
    zero = jnp.zeros_like(raw_r)
    scal = jnp.stack(
        [raw_r, raw_c, gp[:, 1], gp[:, 0],
         reg_r0.astype(jnp.float32), reg_c0.astype(jnp.float32), zero, zero],
        axis=-1,
    )
    out = level_call(blk, region, scal, win, iters, interpret=interpret)
    g = jnp.stack([out[:, 1], out[:, 0]], axis=-1) - PAD
    return g, out[:, 2], ok, (region, reg_r0, reg_c0)


@functools.partial(jax.jit, static_argnames=("win", "search"))
def capture_blocks(pyr: tuple, pts, win: int = 32, search: int | None = None):
    """Like lucas_kanade.capture_blocks, with (N, B, B) blocks."""
    search = lk._resolve_search(win, search)
    return tuple(
        _capture(img, pts / 2.0 ** lvl, win, search) for lvl, img in enumerate(pyr)
    )


@functools.partial(jax.jit, static_argnames=("win", "iters", "search", "interpret"))
def track_cached(
    blocks: tuple,
    next_pyr,
    pts,
    valid,
    win: int = 32,
    iters: int = 10,
    min_eig_threshold: float = 1e-4,
    search: int | None = None,
    interpret: bool = False,
):
    """Drop-in for lucas_kanade.track_cached with (N, B, B) blocks.

    Returns (new_pts, status, new_blocks) with identical semantics."""
    if not supports(win):
        raise ValueError(f"pallas LK takes win <= {MAX_WIN}, got {win}")
    levels = len(next_pyr)
    H, W = next_pyr[0].shape
    search = lk._resolve_search(win, search)
    guess = pts / 2.0 ** (levels - 1)
    min_eig0 = jnp.zeros(pts.shape[0], pts.dtype)
    ok_all = jnp.ones(pts.shape[0], bool)
    new_blocks = []
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        blk, br0, bc0 = blocks[lvl]
        guess, min_eig0, ok, captured = _track_level_cached(
            blk, br0, bc0, next_pyr[lvl], pts / s, guess, win, iters, search,
            interpret,
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
    return new_pts, status, tuple(new_blocks[::-1])
