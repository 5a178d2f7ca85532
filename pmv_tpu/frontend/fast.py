"""FAST-9/16 corner detector, fully vectorized (no per-pixel loops).

Replacement for the ``cv::FAST`` wrapper
(OpenCVFASTFeatureExtractor.cpp:4-22: threshold 10, non-max suppression on,
keeps the first ``max`` keypoints in scan order — unsorted, reproduced
here). A pixel is a corner when >= 9 contiguous pixels on the 16-pixel
Bresenham circle are all brighter than center + t or all darker than
center - t. The score is the FAST "V" measure: the largest threshold for
which the pixel remains a corner (arc-min of absolute differences),
followed by 3x3 non-max suppression.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# Bresenham circle of radius 3, OpenCV pixel order, (row, col) offsets.
_CIRCLE = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]


def fast_response(img: jax.Array, threshold: float = 10.0) -> jax.Array:
    """FAST-9 corner score map (0 where not a corner)."""
    shifted = jnp.stack(
        [jnp.roll(img, (-dr, -dc), axis=(0, 1)) for dr, dc in _CIRCLE]
    )  # (16, H, W): shifted[i] at center == img at circle pixel i
    d = shifted - img[None]
    # arc-min over 9 consecutive circle pixels, for every start position
    bright = d  # want min over arc > t
    dark = -d  # want min over arc > t

    def arc_min(x):
        m = x
        for k in range(1, 9):
            m = jnp.minimum(m, jnp.roll(x, -k, axis=0))
        return jnp.max(m, axis=0)  # best start position

    vb = arc_min(bright)
    vd = arc_min(dark)
    score = jnp.maximum(vb, vd)
    score = jnp.where(score > threshold, score, 0.0)
    # kill the border (circle wraps around via roll)
    H, W = img.shape
    rows = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (rows >= 3) & (rows < H - 3) & (cols >= 3) & (cols < W - 3)
    return jnp.where(inside, score, 0.0)


@functools.partial(jax.jit, static_argnames=("max_feats", "threshold", "nonmax"))
def fast_extract(
    img: jax.Array,
    max_feats: int,
    threshold: float = 10.0,
    nonmax: bool = True,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Extract up to ``max_feats`` FAST corners in scan (row-major) order —
    the reference keeps the *first* max keypoints, not the strongest
    (OpenCVFASTFeatureExtractor.cpp:11-15). Returns (xy (C,2), score (C,),
    valid (C,))."""
    score = fast_response(img, threshold)
    if nonmax:
        wmax = lax.reduce_window(score, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME")
        score = jnp.where(score >= wmax, score, 0.0)
    H, W = img.shape
    flat = score.reshape(-1)
    is_corner = flat > 0
    # first-k in scan order: order by (not corner, index)
    idx_rank = jnp.where(is_corner, jnp.arange(H * W), H * W)
    order = jnp.argsort(idx_rank)[:max_feats]
    sel_score = flat[order]
    valid = sel_score > 0
    xy = jnp.stack([(order % W).astype(jnp.float32), (order // W).astype(jnp.float32)], -1)
    return xy, sel_score, valid
