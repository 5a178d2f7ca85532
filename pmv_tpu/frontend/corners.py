"""Grid-tiled corner extraction with static output shapes.

Replacement for the reference's per-tile extractor calls:
``getGridROI`` splits the frame into 255x255 tiles (OdometryPipeline.cpp:
674-693) and runs ``cv::goodFeaturesToTrack`` per tile
(OpenCVGoodFeatureExtractor.cpp:4-21: quality 0.01, min-distance 5) or the
from-scratch Shi-Tomasi extractor (ShiTomasiFeatureExtractor.cpp:5-47:
threshold at quality*r_max, sort by score, top-max).

Here the whole frame's response is computed once, non-max/min-distance
suppression is a windowed max (the data-parallel equivalent of OpenCV's
greedy min-distance scan), and per-tile top-k gives the same spatial spreading with
a fixed (n_tiles * k) candidate capacity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from pmv_tpu.frontend.image import harris_response, min_eig_response

NEG = -1e30


def _window_max(resp: jax.Array, radius: int) -> jax.Array:
    """Max over a (2r+1)^2 neighborhood at every pixel — separable
    (two 1-D passes instead of one O(k^2) window)."""
    w = 2 * radius + 1
    h = lax.reduce_window(resp, -jnp.inf, lax.max, (1, w), (1, 1), padding="SAME")
    return lax.reduce_window(h, -jnp.inf, lax.max, (w, 1), (1, 1), padding="SAME")


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_per_tile",
        "tile_h",
        "tile_w",
        "quality",
        "min_distance",
        "response",
    ),
)
def grid_extract(
    img: jax.Array,
    n_per_tile: int,
    tile_h: int = 255,
    tile_w: int = 255,
    quality: float = 0.01,
    min_distance: int = 5,
    response: str = "min_eig",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Extract up to ``n_per_tile`` corners per ``tile_h x tile_w`` tile.

    Returns (xy (C, 2) float32 as (u=col, v=row), score (C,), valid (C,))
    with static candidate capacity C = n_tiles * n_per_tile, ordered
    tile-major then score-descending within each tile.
    """
    H, W = img.shape
    if response == "min_eig":
        resp = min_eig_response(img)
    elif response == "harris":
        resp = harris_response(img)
    elif response == "fast":
        from pmv_tpu.frontend.fast import fast_response

        resp = fast_response(img, threshold=10.0)
    else:
        raise ValueError(f"unknown response {response!r}")

    # Non-max + min-distance suppression: a corner survives iff it is the
    # strict windowed max of its (2*min_distance+1)^2 neighborhood.
    wmax = _window_max(resp, min_distance)
    # break ties deterministically toward the first (row-major) pixel
    rows = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    is_peak = (resp >= wmax) & (resp > 0)

    # Tile the (padded) response; padded area gets NEG so it never wins.
    th, tw = tile_h, tile_w
    n_th = -(-H // th)
    n_tw = -(-W // tw)
    pH, pW = n_th * th, n_tw * tw
    padded = jnp.full((pH, pW), NEG, resp.dtype)
    padded = padded.at[:H, :W].set(jnp.where(is_peak, resp, NEG))
    tiles = padded.reshape(n_th, th, n_tw, tw).transpose(0, 2, 1, 3)
    flat = tiles.reshape(n_th * n_tw, th * tw)

    # Reference per-tile quality gate: score >= quality * tile_max response
    # (tile max over the raw response, not just peaks).
    raw_padded = jnp.full((pH, pW), NEG, resp.dtype).at[:H, :W].set(resp)
    raw_tiles = raw_padded.reshape(n_th, th, n_tw, tw).transpose(0, 2, 1, 3)
    tile_max = raw_tiles.reshape(n_th * n_tw, th * tw).max(axis=1)

    score, idx = lax.top_k(flat, n_per_tile)  # (T, k)
    in_r = idx // tw
    in_c = idx % tw
    t_ids = lax.broadcasted_iota(jnp.int32, score.shape, 0)
    r = (t_ids // n_tw) * th + in_r
    c = (t_ids % n_tw) * tw + in_c
    valid = (score > NEG / 2) & (score >= quality * tile_max[:, None]) & (score > 0)
    xy = jnp.stack([c, r], axis=-1).astype(jnp.float32)
    return (
        xy.reshape(-1, 2),
        score.reshape(-1).astype(jnp.float32),
        valid.reshape(-1),
    )


def select_top(
    xy: jax.Array, score: jax.Array, valid: jax.Array, capacity: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Keep the ``capacity`` best valid candidates (score-descending),
    returning fixed-shape (capacity, 2), (capacity,), (capacity,)."""
    masked = jnp.where(valid, score, NEG)
    top_score, idx = lax.top_k(masked, min(capacity, score.shape[0]))
    top_xy = xy[idx]
    top_valid = top_score > NEG / 2
    if capacity > score.shape[0]:
        pad = capacity - score.shape[0]
        top_xy = jnp.concatenate([top_xy, jnp.zeros((pad, 2), xy.dtype)])
        top_score = jnp.concatenate([top_score, jnp.full((pad,), NEG, score.dtype)])
        top_valid = jnp.concatenate([top_valid, jnp.zeros((pad,), jnp.bool_)])
    return top_xy, top_score, top_valid
