"""Fixed-budget batched RANSAC utilities.

The reference relies on OpenCV's sequential RANSAC loops
(``cv::findEssentialMat`` with prob .99 / 1 px, OpenCVFivePointTri.cpp:24;
``cv::solvePnPRansac`` with 100 iterations / 8 px, OpenCVEPnPSolver.cpp:35-36).
Data-dependent iteration counts are replaced by a fixed batch of
hypotheses solved simultaneously: sample H minimal sets, solve all H models
with one vmapped linear solve, score all H x N residuals as one tensor op,
and argmax the masked inlier count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_minimal_sets(
    key: jax.Array, valid: jax.Array, n_hypos: int, set_size: int
) -> jax.Array:
    """Draw ``n_hypos`` random subsets of ``set_size`` indices from the valid
    slots, with static shapes.

    Uses the Gumbel-top-k trick: per hypothesis, add Gumbel noise to
    ``log(valid)`` and take the top ``set_size`` — a uniform random
    ``set_size``-subset of valid indices. If fewer than ``set_size`` valid
    slots exist, invalid slots leak in; callers guard via the model's own
    scoring (an invalid row produces a degenerate model that scores poorly).
    Returns (n_hypos, set_size) int32.
    """
    n = valid.shape[0]
    g = jax.random.gumbel(key, (n_hypos, n))
    logits = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(logits, set_size)
    return idx


def best_hypothesis(inlier_masks: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Pick the hypothesis with the most inliers.

    inlier_masks: (H, N) bool. Returns (best_index, best_mask (N,)).
    """
    counts = jnp.sum(inlier_masks, axis=1)
    best = jnp.argmax(counts)
    return best, inlier_masks[best]
