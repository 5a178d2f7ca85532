"""Patch-SSD k-nearest-neighbor feature matcher (the LK alternative).

Rewrite of kNNFeatureMatcher.cpp:3-122: extract ~1000 fresh
corners in the next frame; for each previous feature take its k=7 spatial
nearest neighbors (Chebyshev distance, matching ``Feature::distance``),
pick the best by 15x15 SSD patch error, accept if the error is below the
threshold (2.0), and reject matches whose displacement exceeds 3x the mean
displacement. The reference's O(n^2) neighbor scans become one batched
distance matrix + top-k; the SSD comparisons one gather + reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from pmv_tpu.core.state import FeatureTable
from pmv_tpu.frontend.lucas_kanade import _frac_shift, _slice_blocks


def _patches(img: jax.Array, xy: jax.Array, window: int) -> jax.Array:
    """(N, 2) centers -> (N, window, window) patches (border-replicated;
    the reference instead skips out-of-bounds pixels in the SSD sum).

    Block dynamic-slices + the four-tap fractional blend — no pointwise
    gathers (the original bilinear_sample formulation issued one gather per
    pixel; at the high-density config that is ~4M scattered reads/frame).
    Values match the pointwise sampler exactly: both
    compute the same four-tap blend of the same edge-clamped pixels.
    """
    half = window // 2
    PAD = half + 2
    img_p = jnp.pad(img, PAD, mode="edge")
    H, W = img_p.shape
    x = xy[:, 0] + PAD
    y = xy[:, 1] + PAD
    # Clamp like bilinear_sample: sample coords clip to the unpadded frame.
    x = jnp.clip(x, PAD, W - PAD - 1.000001)
    y = jnp.clip(y, PAD, H - PAD - 1.000001)
    r0 = jnp.floor(y).astype(jnp.int32) - half
    c0 = jnp.floor(x).astype(jnp.int32) - half
    base = _slice_blocks(img_p, r0, c0, window + 1)  # (N, w+1, w+1)
    return _frac_shift(base, y - jnp.floor(y), x - jnp.floor(x))


@functools.partial(jax.jit, static_argnames=("k", "window", "threshold"))
def knn_match(
    prev_img: jax.Array,
    next_img: jax.Array,
    prev_table: FeatureTable,
    cand_xy: jax.Array,
    cand_valid: jax.Array,
    k: int = 7,
    window: int = 15,
    threshold: float = 2.0,
) -> FeatureTable:
    """Match ``prev_table`` features into candidate corners of the next
    frame. Returns the next frame's slot-aligned FeatureTable (valid =
    matched, landmark inherited)."""
    N = prev_table.capacity
    # Chebyshev spatial distance matrix (N, C) — Feature.cpp:9-15 max-norm.
    d = jnp.max(
        jnp.abs(prev_table.xy[:, None, :] - cand_xy[None, :, :]), axis=-1
    )
    d = jnp.where(cand_valid[None, :], d, jnp.inf)
    k = min(k, cand_xy.shape[0])
    _, nn = lax.top_k(-d, k)  # (N, k) nearest candidate indices

    # compareFeatures loops x,y in [-ceil(w/2), +ceil(w/2)] — a
    # (2*ceil(w/2)+1)-sided patch (17x17 for window=15) — while normalizing
    # by window^2 (kNNFeatureMatcher.cpp:103-121). Keep both quirks.
    psize = 2 * -(-window // 2) + 1
    P_prev = _patches(prev_img, prev_table.xy, psize)  # (N, p, p)
    nn_xy = cand_xy[nn.reshape(-1)]  # (N*k, 2)
    P_next = _patches(next_img, nn_xy, psize).reshape(N, k, psize, psize)
    # Reference error: sqrt(SSD) / window^2 (kNNFeatureMatcher.cpp:120).
    ssd = jnp.sum((P_next - P_prev[:, None]) ** 2, axis=(2, 3))
    err = jnp.sqrt(ssd) / (window * window)
    best = jnp.argmin(err, axis=1)  # (N,)
    best_err = jnp.take_along_axis(err, best[:, None], axis=1)[:, 0]
    best_idx = jnp.take_along_axis(nn, best[:, None], axis=1)[:, 0]
    best_xy = cand_xy[best_idx]

    # An under-populated candidate set lets top_k admit invalid slots (inf
    # spatial distance but real garbage xy); never accept those.
    matched = prev_table.valid & cand_valid[best_idx] & (best_err < threshold)
    disp = jnp.max(jnp.abs(best_xy - prev_table.xy), axis=-1)  # Chebyshev
    # The reference averages matched displacements over ALL previous
    # features, not just matched ones (kNNFeatureMatcher.cpp:42).
    mean_disp = jnp.sum(jnp.where(matched, disp, 0.0)) / jnp.maximum(
        jnp.sum(prev_table.valid), 1
    )
    matched = matched & (disp <= 3.0 * mean_disp)

    return FeatureTable(
        xy=best_xy,
        valid=matched,
        landmark=jnp.where(matched, prev_table.landmark, -1),
        score=jnp.where(matched, prev_table.score, 0.0),
    )
