"""Essential-matrix estimation, pose recovery and triangulation — batched JAX.

Replacement for the reference's bootstrap triangulator
(OpenCVFivePointTri.cpp:5-54): ``cv::findEssentialMat`` (RANSAC, prob .99,
1 px threshold) + ``cv::recoverPose`` (cheirality + triangulation). The
minimal solver here is the normalized 8-point algorithm over batched
hypotheses (one vmapped 9x9 eigendecomposition instead of Nister's degree-10
polynomial — the polynomial root-finder needs a nonsymmetric
eigensolver that XLA does not batch on the device; 8-point over 150+ LK tracks matches its accuracy in
practice), scored by Sampson distance, refit on the best inlier set.

Conventions (identical to OpenCV, which the pipeline layer adapts to the
reference's z-flipped world): points x1 in camera-1 frame map to camera 2 as
``x2 = R x1 + t``; E satisfies ``x2_hat^T E x1_hat = 0`` with
``E = [t]_x R``; triangulated points are in the camera-1 frame with z > 0 in
front.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pmv_tpu.core.geometry import hat as geo_hat
from pmv_tpu.core.geometry import rodrigues as geo_rodrigues
from pmv_tpu.solvers.ransac import sample_minimal_sets

_PREC = jax.lax.Precision.HIGHEST


def normalize_points(p: jax.Array, K: jax.Array) -> jax.Array:
    """Pixels (N, 2) -> unit-plane coordinates via K^-1."""
    x = (p[..., 0] - K[0, 2]) / K[0, 0]
    y = (p[..., 1] - K[1, 2]) / K[1, 1]
    return jnp.stack([x, y], axis=-1)


def _eight_point(x1: jax.Array, x2: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted 8-point solve on unit-plane coords.

    x1, x2: (N, 2); w: (N,) nonnegative weights (0 excludes a row).
    Returns E (3, 3) with the (1, 1, 0) singular-value constraint enforced.
    """
    ones = jnp.ones_like(x1[..., 0])
    A = jnp.stack(
        [
            x2[..., 0] * x1[..., 0],
            x2[..., 0] * x1[..., 1],
            x2[..., 0],
            x2[..., 1] * x1[..., 0],
            x2[..., 1] * x1[..., 1],
            x2[..., 1],
            x1[..., 0],
            x1[..., 1],
            ones,
        ],
        axis=-1,
    )  # (N, 9)
    A = A * w[..., None]
    AtA = jnp.matmul(A.T, A, precision=_PREC)
    _, vecs = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    e = vecs[:, 0]
    E = e.reshape(3, 3)
    # Enforce rank-2 essential structure with equal singular values.
    U, s, Vt = jnp.linalg.svd(E)
    s_mean = (s[0] + s[1]) * 0.5
    E = jnp.matmul(U * jnp.array([s_mean, s_mean, 0.0], E.dtype), Vt, precision=_PREC)
    return E


def sampson_error(E: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """First-order (Sampson) epipolar distance squared, unit-plane units.

    x1, x2: (N, 2). Returns (N,) squared distances.
    """
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    Ex1 = jnp.matmul(x1h, E.T, precision=_PREC)  # (N, 3)
    Etx2 = jnp.matmul(x2h, E, precision=_PREC)  # (N, 3)
    num = jnp.sum(x2h * Ex1, axis=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-18)


@functools.partial(jax.jit, static_argnames=("n_hypos",))
def find_essential_ransac(
    p1: jax.Array,
    p2: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    key: jax.Array,
    n_hypos: int = 256,
    thresh_px: float = 1.0,
) -> tuple[jax.Array, jax.Array]:
    """RANSAC essential matrix from pixel correspondences.

    p1, p2: (N, 2) pixels; valid: (N,) mask. Returns (E (3,3), inliers (N,)).
    Replaces cv::findEssentialMat(RANSAC, 0.99, 1px) at
    OpenCVFivePointTri.cpp:24 with a fixed batch of ``n_hypos`` hypotheses.
    """
    x1 = normalize_points(p1, K)
    x2 = normalize_points(p2, K)
    f_avg = (K[0, 0] + K[1, 1]) * 0.5
    thresh2 = (thresh_px / f_avg) ** 2

    idx = sample_minimal_sets(key, valid, n_hypos, 8)  # (H, 8)
    Es = jax.vmap(
        lambda i: _eight_point(x1[i], x2[i], jnp.ones(8, x1.dtype))
    )(idx)  # (H, 3, 3)
    errs = jax.vmap(lambda E: sampson_error(E, x1, x2))(Es)  # (H, N)
    # MSAC model selection: minimize the truncated error sum.
    msac = jnp.sum(jnp.where(valid[None, :], jnp.minimum(errs, thresh2), 0.0), axis=1)
    best = jnp.argmin(msac)
    best_mask = (errs[best] < thresh2) & valid
    best_E = Es[best]

    # Iterated refit: weighted LS on current inliers -> new inlier set.
    def refit(carry, _):
        E, mask = carry
        E_new = _eight_point(x1, x2, mask.astype(x1.dtype))
        err = sampson_error(E_new, x1, x2)
        mask_new = (err < thresh2) & valid
        better = jnp.sum(mask_new) >= jnp.sum(mask)
        E = jnp.where(better, E_new, E)
        mask = jnp.where(better, mask_new, mask)
        return (E, mask), None

    (E, inliers), _ = jax.lax.scan(refit, (best_E, best_mask), None, length=3)
    return E, inliers


def triangulate_points(
    R: jax.Array, t: jax.Array, x1: jax.Array, x2: jax.Array
) -> jax.Array:
    """Linear (DLT) triangulation on unit-plane coords, batched over N.

    Camera 1 is [I|0], camera 2 is [R|t] (x2 = R x1 + t). Returns (N, 3)
    points in the camera-1 frame (may have z <= 0 for outliers; callers
    apply cheirality masks).
    """
    P1 = jnp.concatenate([jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], axis=1)
    P2 = jnp.concatenate([R, t[:, None]], axis=1)

    def rows(P, x):
        # x (N,2): rows x*P3 - P1 ; y*P3 - P2
        r1 = x[..., 0:1] * P[2][None, :] - P[0][None, :]
        r2 = x[..., 1:2] * P[2][None, :] - P[1][None, :]
        return r1, r2

    a1, a2 = rows(P1, x1)
    a3, a4 = rows(P2, x2)
    A = jnp.stack([a1, a2, a3, a4], axis=-2)  # (N, 4, 4)
    AtA = jnp.matmul(jnp.swapaxes(A, -1, -2), A, precision=_PREC)
    _, vecs = jnp.linalg.eigh(AtA)
    Xh = vecs[..., :, 0]  # (N, 4)
    w = Xh[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w_safe[..., None]


def refine_relative_pose(
    R: jax.Array,
    t: jax.Array,
    x1: jax.Array,
    x2: jax.Array,
    weights: jax.Array,
    iters: int = 10,
) -> tuple[jax.Array, jax.Array]:
    """Polish (R, t) by damped Gauss-Newton on the Sampson error (unit-plane
    coords). t is renormalized to unit length each step (5-DOF problem with a
    6-param chart + damping). This recovers the accuracy the linear 8-point
    estimate leaves on the table under pixel noise."""

    def residual(params):
        Rp = jnp.matmul(geo_rodrigues(params[:3]), R, precision=_PREC)
        tp = params[3:]
        tn = tp / jnp.maximum(jnp.linalg.norm(tp), 1e-12)
        E = jnp.matmul(geo_hat(tn), Rp, precision=_PREC)
        return jnp.sqrt(sampson_error(E, x1, x2) + 1e-18) * weights

    def body(_, params):
        J = jax.jacfwd(residual)(params)
        r = residual(params)
        H = jnp.matmul(J.T, J, precision=_PREC) + 1e-8 * jnp.eye(6, dtype=J.dtype)
        g = jnp.matmul(J.T, r, precision=_PREC)
        return params - jnp.linalg.solve(H, g)

    params0 = jnp.concatenate([jnp.zeros(3, R.dtype), t])
    params = jax.lax.fori_loop(0, iters, body, params0)
    R_out = jnp.matmul(geo_rodrigues(params[:3]), R, precision=_PREC)
    t_out = params[3:] / jnp.maximum(jnp.linalg.norm(params[3:]), 1e-12)
    # Reject a diverged polish.
    cost0 = jnp.sum(residual(params0) ** 2)
    cost1 = jnp.sum(residual(params) ** 2)
    ok = cost1 < cost0
    return jnp.where(ok, R_out, R), jnp.where(ok, t_out, t)


def triangulate_points_fast(
    R: jax.Array, t: jax.Array, x1: jax.Array, x2: jax.Array
) -> jax.Array:
    """Inhomogeneous DLT triangulation: same 4 DLT rows as
    :func:`triangulate_points` but with w fixed to 1, so the solve is a 3x3
    normal-equation closed form (adjugate) instead of a batched 4x4
    eigendecomposition.

    recover_pose triangulates 5x per bootstrap event, so a batched eigh
    here would run five times per event. Agreement with the eigh path is ~1e-3 on inlier-parallax
    points; both degrade together near w -> 0 (points at infinity), which
    cheirality masks and the BA gate handle downstream.
    """
    P1 = jnp.concatenate([jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], axis=1)
    P2 = jnp.concatenate([R, t[:, None]], axis=1)

    def rows(P, x):
        r1 = x[..., 0:1] * P[2][None, :] - P[0][None, :]
        r2 = x[..., 1:2] * P[2][None, :] - P[1][None, :]
        return r1, r2

    a1, a2 = rows(P1, x1)
    a3, a4 = rows(P2, x2)
    A = jnp.stack([a1, a2, a3, a4], axis=-2)  # (N, 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = jnp.einsum("nij,nik->njk", M, M, precision=_PREC)
    Atb = jnp.einsum("nij,ni->nj", M, b, precision=_PREC)
    r0, r1_, r2_ = AtA[..., 0, :], AtA[..., 1, :], AtA[..., 2, :]
    cof0 = jnp.stack(
        [
            r1_[..., 1] * r2_[..., 2] - r1_[..., 2] * r2_[..., 1],
            r0[..., 2] * r2_[..., 1] - r0[..., 1] * r2_[..., 2],
            r0[..., 1] * r1_[..., 2] - r0[..., 2] * r1_[..., 1],
        ],
        axis=-1,
    )
    cof1 = jnp.stack(
        [
            r1_[..., 2] * r2_[..., 0] - r1_[..., 0] * r2_[..., 2],
            r0[..., 0] * r2_[..., 2] - r0[..., 2] * r2_[..., 0],
            r0[..., 2] * r1_[..., 0] - r0[..., 0] * r1_[..., 2],
        ],
        axis=-1,
    )
    cof2 = jnp.stack(
        [
            r1_[..., 0] * r2_[..., 1] - r1_[..., 1] * r2_[..., 0],
            r0[..., 1] * r2_[..., 0] - r0[..., 0] * r2_[..., 1],
            r0[..., 0] * r1_[..., 1] - r0[..., 1] * r1_[..., 0],
        ],
        axis=-1,
    )
    det = jnp.sum(r0 * cof0, axis=-1)
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    inv = jnp.stack([cof0, cof1, cof2], axis=-1)  # adjugate^T rows
    return jnp.einsum("njk,nk->nj", inv, Atb, precision=_PREC) / det[..., None]


@jax.jit
def recover_pose(
    E: jax.Array,
    p1: jax.Array,
    p2: jax.Array,
    valid: jax.Array,
    K: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Cheirality-disambiguated pose from E + triangulation.

    Mirrors cv::recoverPose (OpenCVFivePointTri.cpp:26): decompose E into the
    4 (R, t) candidates, pick the one with most triangulated points in front
    of both cameras, and return (R, t_unit, points3d (N, 3) in cam-1 frame,
    in_front (N,) mask). |t| = 1.
    """
    U, _, Vt = jnp.linalg.svd(E)
    # Ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = jnp.matmul(jnp.matmul(U, W, precision=_PREC), Vt, precision=_PREC)
    Rb = jnp.matmul(jnp.matmul(U, W.T, precision=_PREC), Vt, precision=_PREC)
    tu = U[:, 2]
    x1 = normalize_points(p1, K)
    x2 = normalize_points(p2, K)

    def score(R, t):
        # Closed-form 3x3 DLT instead of a batched 4x4 eigh, which would
        # run 5x per bootstrap event.
        X = triangulate_points_fast(R, t, x1, x2)
        z1 = X[:, 2]
        z2 = (jnp.matmul(X, R.T, precision=_PREC) + t)[:, 2]
        front = (z1 > 0) & (z2 > 0) & valid
        return jnp.sum(front), X, front

    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    scores = []
    for R, t in cands:
        s, _, _ = score(R, t)
        scores.append(s)
    scores = jnp.stack(scores)
    k = jnp.argmax(scores)
    R = jnp.stack([c[0] for c in cands])[k]
    t = jnp.stack([c[1] for c in cands])[k]
    # Gauss-Newton Sampson polish on the inlier set, then re-triangulate.
    R, t = refine_relative_pose(R, t, x1, x2, valid.astype(x1.dtype))
    _, X, front = score(R, t)
    return R, t, X, front
