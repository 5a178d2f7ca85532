"""Image-domain primitives: gradients, structure tensor, pyramids.

Rewrite of the reference's lazy per-frame image cache
(Frame.cpp:58-86 central-difference gradients, Frame.cpp:119-138 gradient
products + 3x3 box blur "Harris matrix"). Everything is expressed as
XLA-fusable elementwise ops and tiny separable convolutions over (H, W)
float32 images; batch dims broadcast on the left.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def spatial_gradient(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Central-difference gradients with zero borders.

    Matches Frame::computeSpatialGradient (Frame.cpp:58-86):
    ``Ix = (I[r, c+1] - I[r, c-1]) / 2``, ``Iy = (I[r+1, c] - I[r-1, c]) / 2``,
    zero on the one-pixel border.
    """
    gx = jnp.zeros_like(img)
    gy = jnp.zeros_like(img)
    gx = gx.at[..., 1:-1, 1:-1].set((img[..., 1:-1, 2:] - img[..., 1:-1, :-2]) * 0.5)
    gy = gy.at[..., 1:-1, 1:-1].set((img[..., 2:, 1:-1] - img[..., :-2, 1:-1]) * 0.5)
    return gx, gy


def box_blur3(x: jax.Array) -> jax.Array:
    """3x3 box blur with replicated borders (cv::blur default
    BORDER_REFLECT_101 differs only on the 1-px border; the reference uses it
    purely to smooth the structure tensor)."""
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
    # separable 3-tap average, fused by XLA
    h = (p[..., :, :-2] + p[..., :, 1:-1] + p[..., :, 2:]) / 3.0
    v = (h[..., :-2, :] + h[..., 1:-1, :] + h[..., 2:, :]) / 3.0
    return v


def structure_tensor(img: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Blurred second-moment matrix entries (Ixx, Iyy, Ixy), each (H, W).

    The reference's "Harris matrix" (Frame.cpp:119-138): gradient products
    box-blurred 3x3.
    """
    gx, gy = spatial_gradient(img)
    return box_blur3(gx * gx), box_blur3(gy * gy), box_blur3(gx * gy)


def min_eig_response(img: jax.Array) -> jax.Array:
    """Shi-Tomasi response: min eigenvalue of the 2x2 structure tensor,
    closed form (ShiTomasiFeatureExtractor.cpp:49-75)."""
    Ixx, Iyy, Ixy = structure_tensor(img)
    # eigenvalues of [[Ixx, Ixy], [Ixy, Iyy]]: mean +- sqrt(((Ixx-Iyy)/2)^2 + Ixy^2)
    mean = (Ixx + Iyy) * 0.5
    d = (Ixx - Iyy) * 0.5
    rad = jnp.sqrt(d * d + Ixy * Ixy)
    return mean - rad


def harris_response(img: jax.Array, k: float = 0.04) -> jax.Array:
    """Classic Harris corner response det - k*trace^2 (the commented-out
    alternative at ShiTomasiFeatureExtractor.cpp:70)."""
    Ixx, Iyy, Ixy = structure_tensor(img)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


def downsample2(img: jax.Array) -> jax.Array:
    """2x downsample with a 2x2 average (pyramid level step). Odd trailing
    row/col are dropped (matching OpenCV's floor((d+1)/2) closely enough for
    tracking)."""
    H, W = img.shape[-2], img.shape[-1]
    h2, w2 = H // 2, W // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*x.shape[:-2], h2, 2, w2, 2)
    return x.mean(axis=(-3, -1))


def gaussian_blur5(img: jax.Array) -> jax.Array:
    """Separable 5-tap binomial blur (1,4,6,4,1)/16 — the anti-alias filter
    applied before each pyramid downsample, like OpenCV's pyrDown."""
    k = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], img.dtype) / 16.0
    p = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(2, 2), (2, 2)], mode="edge")
    h = sum(k[i] * p[..., :, i : i + img.shape[-1]] for i in range(5))
    v = sum(k[i] * h[..., i : i + img.shape[-2], :] for i in range(5))
    return v


def build_pyramid(img: jax.Array, levels: int) -> list[jax.Array]:
    """Gaussian image pyramid: ``levels + 1`` images, level 0 = input.

    Mirrors the pyramid cv::calcOpticalFlowPyrLK builds for maxLevel =
    ``levels`` (OpenCVLucasKanadeFM.cpp:15 uses maxLevel 4).
    """
    pyr = [img]
    for _ in range(levels):
        pyr.append(downsample2(gaussian_blur5(pyr[-1])))
    return pyr
