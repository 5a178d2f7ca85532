"""Perspective-n-Point pose estimation — batched DLT hypotheses + IRLS
Gauss-Newton refinement.

Replacement for the reference's PnP stage
(OpenCVEPnPSolver.cpp:4-50): ``cv::solvePnPRansac(..., useExtrinsicGuess=true,
100 iters, 8 px, .99)`` — which, despite the class name, runs
SOLVEPNP_ITERATIVE. Here: a fixed batch of 6-point DLT hypotheses (vmapped
12x12 eigendecomposition), plus the extrinsic guess as one extra hypothesis,
scored by reprojection error; the winner is polished by a fixed-iteration
Gauss-Newton on all inliers. The returned inlier mask drives landmark
erasure exactly like the reference's outlier removal (:40-49).

Convention (standard, like OpenCV): object points X are in a reference frame
(here: the previous camera's standard frame), and the solved pose maps them
into the current camera: ``x_cam = R X + t``, z > 0 in front,
``uv = f * xy / z + c``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pmv_tpu.core import geometry as geo
from pmv_tpu.core.linalg import det3, gj_inverse, gj_solve
from pmv_tpu.solvers.ransac import best_hypothesis, sample_minimal_sets

_PREC = jax.lax.Precision.HIGHEST


def _project_std(aa: jax.Array, t: jax.Array, X: jax.Array, K: jax.Array) -> jax.Array:
    """Standard-convention projection of (N, 3) points by pose (aa, t)."""
    xc = geo.angle_axis_rotate(aa[None, :], X) + t
    z = jnp.maximum(xc[..., 2], 1e-9)
    u = xc[..., 0] / z * K[0, 0] + K[0, 2]
    v = xc[..., 1] / z * K[1, 1] + K[1, 2]
    return jnp.stack([u, v], axis=-1)


def _smallest_eigvec12(M: jax.Array) -> jax.Array:
    """Smallest eigenvector of a PSD (12, 12) matrix by ridged inverse
    iteration (one pivot-free Gauss-Jordan inverse + 3 matvecs). Under the
    caller's vmap this is pure batched elementwise work, where ``eigh``
    runs iterative sweeps and pivoted LU a per-column max search and
    row swaps on each tiny matrix. The ridge
    keeps every GJ pivot positive. Hypothesis-grade accuracy only: the
    DLT null direction is amplified ~1/mu per solve (>= 1e4 vs the next
    eigendirection), and RANSAC scoring + the GN polish do the precision
    work downstream."""
    mu = 1e-7 * jnp.trace(M) / 12.0 + 1e-12
    Minv = gj_inverse(M + mu * jnp.eye(12, dtype=M.dtype))
    v = jnp.full((12,), 1.0 / jnp.sqrt(12.0), M.dtype)
    for _ in range(3):
        v = jnp.matmul(Minv, v, precision=_PREC)
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-30)
    return v


def _polar_so3(M: jax.Array) -> jax.Array:
    """Nearest rotation to a (3, 3) matrix with det > 0: Newton polar
    iteration ``X <- (X + X^-T) / 2`` with the closed-form adjugate inverse —
    pure batched elementwise math, replacing the tiny-matrix SVD. Singular
    values converge as s <- (s + 1/s)/2, so 6 iterations cover anisotropy up
    to ~10x; degenerate samples produce garbage hypotheses that RANSAC
    scoring discards like any other bad draw."""

    def inv_T(X):
        a, b, c = X[0, 0], X[0, 1], X[0, 2]
        d, e, f = X[1, 0], X[1, 1], X[1, 2]
        g, h, i = X[2, 0], X[2, 1], X[2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        det = a * A + b * B + c * C
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        adj_T = jnp.array(
            [
                [A, B, C],
                [-(b * i - c * h), a * i - c * g, -(a * h - b * g)],
                [b * f - c * e, -(a * f - c * d), a * e - b * d],
            ]
        )
        return adj_T / det

    X = M
    for _ in range(6):
        X = 0.5 * (X + inv_T(X))
    return X


def _dlt_pose(X: jax.Array, x: jax.Array, w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Weighted DLT for [R|t] from >= 6 3D-2D pairs on unit-plane coords.

    X: (N, 3) object points, x: (N, 2) normalized image coords, w: (N,)
    weights. Returns (R (3,3), t (3,)) with R orthogonalized (Newton polar)
    and the scale/sign fixed by the determinant.
    """
    N = X.shape[0]
    zeros = jnp.zeros((N, 4), X.dtype)
    Xh = jnp.concatenate([X, jnp.ones((N, 1), X.dtype)], axis=1)  # (N, 4)
    r1 = jnp.concatenate([Xh, zeros, -x[:, 0:1] * Xh], axis=1)  # (N, 12)
    r2 = jnp.concatenate([zeros, Xh, -x[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)  # (2N, 12)
    AtA = jnp.matmul(A.T, A, precision=_PREC)
    P = _smallest_eigvec12(AtA).reshape(3, 4)
    M = P[:, :3]
    # M ~ c * R with c = signed cbrt(det M); dividing by c resolves the +-P
    # sign ambiguity of the eigenvector (det((-M)/cbrt(det -M)) is the same).
    detM = det3(M)
    c = jnp.sign(detM) * jnp.abs(detM) ** (1.0 / 3.0)
    c = jnp.where(jnp.abs(c) < 1e-12, 1e-12, c)
    R = _polar_so3(M / c)
    t = P[:, 3] / c
    return R, t


def gauss_newton_refine(
    aa0: jax.Array,
    t0: jax.Array,
    X: jax.Array,
    uv: jax.Array,
    weights: jax.Array,
    K: jax.Array,
    iters: int = 10,
) -> tuple[jax.Array, jax.Array]:
    """Fixed-iteration damped Gauss-Newton on the reprojection residual
    (the SOLVEPNP_ITERATIVE-equivalent polish)."""

    def residual(params):
        pred = _project_std(params[:3], params[3:], X, K)
        return ((uv - pred) * weights[:, None]).reshape(-1)

    def body(_, params):
        J = jax.jacfwd(residual)(params)  # (2N, 6)
        r = residual(params)
        H = jnp.matmul(J.T, J, precision=_PREC) + 1e-6 * jnp.eye(6, dtype=J.dtype)
        g = jnp.matmul(J.T, r, precision=_PREC)
        step = gj_solve(H, g[:, None])[:, 0]  # damped SPD: no pivoting
        return params - step

    params = jnp.concatenate([aa0, t0])
    params = jax.lax.fori_loop(0, iters, body, params)
    return params[:3], params[3:]


@functools.partial(jax.jit, static_argnames=("n_hypos", "refine_iters"))
def solve_pnp_ransac(
    X: jax.Array,
    uv: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    key: jax.Array,
    R_guess: jax.Array,
    t_guess: jax.Array,
    n_hypos: int = 128,
    thresh_px: float = 8.0,
    refine_iters: int = 10,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """RANSAC PnP: returns (R (3,3), t (3,), inliers (N,)).

    X (N, 3): object points (standard camera-frame convention of the caller),
    uv (N, 2): observed pixels, valid (N,): mask. ``R_guess/t_guess`` join the
    hypothesis pool (the reference passes the previous pose with
    useExtrinsicGuess=true, OpenCVEPnPSolver.cpp:35-36).
    """
    xn = jnp.stack(
        [(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], axis=-1
    )
    idx = sample_minimal_sets(key, valid, n_hypos, 6)

    def hypo(i):
        return _dlt_pose(X[i], xn[i], jnp.ones(6, X.dtype))

    Rs, ts = jax.vmap(hypo)(idx)  # (H, 3, 3), (H, 3)
    # Extrinsic guess as an extra hypothesis.
    Rs = jnp.concatenate([Rs, R_guess[None]], axis=0)
    ts = jnp.concatenate([ts, t_guess[None]], axis=0)

    def reproj_err(R, t):
        pred = _project_std(geo.rodrigues_inv(R), t, X, K)
        behind = (jnp.matmul(X, R.T, precision=_PREC) + t)[:, 2] <= 0
        err = jnp.linalg.norm(uv - pred, axis=-1)
        return jnp.where(behind, jnp.inf, err)

    errs = jax.vmap(reproj_err)(Rs, ts)  # (H+1, N)
    inl = (errs < thresh_px) & valid[None, :]
    best, best_mask = best_hypothesis(inl)
    R_best, t_best = Rs[best], ts[best]

    w = best_mask.astype(X.dtype)
    aa, t = gauss_newton_refine(
        geo.rodrigues_inv(R_best), t_best, X, uv, w, K, iters=refine_iters
    )
    R = geo.rodrigues(aa)
    err = reproj_err(R, t)
    inliers = (err < thresh_px) & valid
    # Keep the refinement only if it did not lose inliers.
    better = jnp.sum(inliers) >= jnp.sum(best_mask)
    R = jnp.where(better, R, R_best)
    t = jnp.where(better, t, t_best)
    inliers = jnp.where(better, inliers, best_mask)
    return R, t, inliers
