"""Tiny-matrix linear algebra without pivoting.

XLA lowers ``jnp.linalg.solve`` to a row-pivoted LU, whose per-column
max-search and row swaps of a single small matrix form a long scalar
dependency chain. Every small system in this
framework is damped/ridge-regularized SPD (LM normal equations, ridged
Gram matrices, Tikhonov-damped Schur complements), so pivoting is
unnecessary: pivot-free Gauss-Jordan elimination runs as n rank-1 updates
of the augmented matrix — batched elementwise work with no
data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# The one-hot selections below must copy values exactly: no TF32 rounding
# of an unpinned f32 contraction on the GPU.
_PREC = lax.Precision.HIGHEST


def gj_solve(A: jax.Array, B: jax.Array) -> jax.Array:
    """Solve ``A X = B`` by pivot-free Gauss-Jordan elimination.

    A: (..., n, n), B: (..., n, k) -> (..., n, k). Batch dims broadcast
    like ``jnp.linalg.solve``. NO row pivoting: callers must guarantee a
    safely nonzero diagonal throughout elimination — true for the damped
    SPD systems this framework solves (diagonal Tikhonov/LM damping keeps
    every pivot positive). For general matrices use ``jnp.linalg.solve``.
    """
    n = A.shape[-1]
    batch = jnp.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = jnp.broadcast_to(A, batch + A.shape[-2:])
    B = jnp.broadcast_to(B, batch + B.shape[-2:])
    M = jnp.concatenate([A, B.astype(A.dtype)], axis=-1)  # (..., n, n+k)

    def step(i, M):
        e = (jnp.arange(n) == i).astype(M.dtype)  # one-hot pivot selector
        row = jnp.einsum("i,...ij->...j", e, M, precision=_PREC)  # pivot row (..., n+k)
        piv = jnp.einsum("j,...j->...", e, row[..., :n], precision=_PREC)  # A[i, i]
        row = row / piv[..., None]
        col = jnp.einsum("j,...ij->...i", e, M[..., :, :n], precision=_PREC)  # column i
        # Eliminate column i from every row (the pivot row zeroes itself),
        # then write back the normalized pivot row — no scatter needed.
        M = M - col[..., None] * row[..., None, :]
        return M + e[..., None] * row[..., None, :]

    M = lax.fori_loop(0, n, step, M)
    return M[..., :, n:]


def gj_inverse(A: jax.Array) -> jax.Array:
    """Pivot-free Gauss-Jordan inverse of (..., n, n) damped-SPD matrices."""
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    return gj_solve(A, eye)


def det3(M: jax.Array) -> jax.Array:
    """Closed-form determinant of (..., 3, 3) — ``jnp.linalg.det`` lowers
    tiny matrices through LU; the cofactor expansion is three FMAs."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
