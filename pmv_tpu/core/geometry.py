"""Camera / SO(3) / SE(3) geometry with the reference implementation's conventions.

This module is the single source of truth for every numeric convention of the
reference C++ pipeline (JeanElsner/practical-multi-view), re-expressed as pure,
vectorizable jax.numpy functions:

- World -> camera projection (reference ``Feature3D::projectPoint``,
  Feature3D.cpp:18-33): ``p' = R^T (p - t); p'.z *= -1;
  uv = f * p'.xy / p'.z + c`` with the "magic_z" guard (1/z replaced by 1 when
  z == 0).
- The bundle-adjustment pose parameterization (CeresBundleAdjustment.cpp:26-34):
  a pose block is ``[angle_axis(R^T), -t]`` and the residual rotates
  ``p + tr[3:6]`` by the angle-axis (include/ProjectionResidual.h:38-58).
- The y-rotation (yaw) extraction used by the motion gate
  (include/OdometryPipeline.h:89-108).

Everything is shape-polymorphic over leading batch dimensions and preserves the
input dtype (float32 on the device; float64 available on CPU for parity tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# An unpinned f32 matmul may run at reduced precision (TF32 on the GPU's
# tensor cores, ~3 decimal digits); geometry is tiny 3x3 algebra where
# that costs sub-pixel reprojection error, so pin full precision.
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)

# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rodrigues(aa: jax.Array) -> jax.Array:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3).

    Rodrigues' formula with a Taylor-series guard at theta ~ 0 so the function
    is smooth and autodiff-safe everywhere.
    """
    theta2 = jnp.sum(aa * aa, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, jnp.finfo(aa.dtype).tiny))
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    cosc = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = hat(aa)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * _mm(K, K)


def rodrigues_inv(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3).

    Stable for theta in [0, pi); at exactly pi it falls back to the
    largest-diagonal branch.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # Antisymmetric part: (R - R^T)^vee / 2 = sin(theta) * axis
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    small = theta < 1e-6
    near_pi = theta > jnp.pi - 1e-4
    # Generic branch: axis * theta = w * theta / sin(theta)
    scale = jnp.where(small, 1.0 + theta * theta / 6.0, theta / jnp.where(sin_t == 0, 1.0, sin_t))
    aa_generic = w * scale[..., None]
    # Near-pi branch: axis from the symmetric part, sign from w
    B = (R + jnp.swapaxes(R, -1, -2)) / 2.0  # = I*cos + (1-cos) aa^T aa-ish
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    one_minus_cos = jnp.maximum(1.0 - cos_t, 1e-12)
    axis2 = jnp.maximum((diag - cos_t[..., None]) / one_minus_cos[..., None], 0.0)
    axis = jnp.sqrt(axis2)
    sign = jnp.where(w >= 0, 1.0, -1.0)
    aa_pi = sign * axis * theta[..., None]
    return jnp.where(near_pi[..., None], aa_pi, aa_generic)


def angle_axis_rotate(aa: jax.Array, p: jax.Array) -> jax.Array:
    """Rotate points p (..., 3) by angle-axis aa (..., 3).

    Matches ``ceres::AngleAxisRotatePoint`` semantics (ProjectionResidual.h:48):
    R(aa) @ p, computed without forming R, smooth at theta ~ 0.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, jnp.finfo(aa.dtype).tiny))
    small = theta2 < 1e-12
    axis = aa / jnp.where(small, 1.0, theta)
    cos_t = jnp.where(small[..., 0], 1.0 - theta2[..., 0] / 2.0, jnp.cos(theta[..., 0]))[..., None]
    sin_t = jnp.where(small[..., 0], theta[..., 0], jnp.sin(theta[..., 0]))[..., None]
    cross = jnp.cross(axis, p)
    dot = jnp.sum(axis * p, axis=-1, keepdims=True)
    rotated = cos_t * p + sin_t * cross + (1.0 - cos_t) * dot * axis
    # For tiny angles use first-order p + aa x p to avoid axis noise
    first_order = p + jnp.cross(aa, p)
    return jnp.where(small, first_order, rotated)


def calc_y_rotation(R: jax.Array, flip: bool = False) -> jax.Array:
    """Yaw extraction used by the motion gate and map drawing.

    Reference: include/OdometryPipeline.h:89-108 — ``cos = R[0,0]``,
    ``sin = R[0,2]``; the sign convention flips with ``flip``.
    """
    cos = jnp.clip(R[..., 0, 0], -1.0, 1.0)
    sin = R[..., 0, 2]
    ac = jnp.arccos(cos)
    if flip:
        return jnp.where(sin <= 0, -ac, ac)
    return jnp.where(sin <= 0, ac, -ac)


# ---------------------------------------------------------------------------
# SE(3) in the reference's (R, t) world-pose convention
# ---------------------------------------------------------------------------


def transform(points: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """Camera -> world: ``p' = R p + t`` (reference ``Feature3D::transform``,
    Feature3D.cpp:85-89: rotate then translate)."""
    return _mm(points, jnp.swapaxes(R, -1, -2)) + t[..., None, :]


def transform_inv(points: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """World -> camera: ``p' = R^T (p - t)`` (reference
    ``Feature3D::transformInv``, Feature3D.cpp:91-97: translate by -t then
    rotate by R^T)."""
    return _mm(points - t[..., None, :], R)


def project_points(
    points: jax.Array, R: jax.Array, t: jax.Array, K: jax.Array
) -> jax.Array:
    """Project world points (..., N, 3) through camera pose (R, t) and
    intrinsics K (3, 3) to pixels (..., N, 2), (u=column, v=row).

    Bit-for-bit the reference model (Feature3D.cpp:18-33):
    ``p' = R^T (p - t); p'.z *= -1; uv = f * p'.xy * magic_z + c`` where
    ``magic_z = 1/z if z != 0 else 1``.
    """
    pc = transform_inv(points, R, t)
    z = -pc[..., 2]
    magic_z = jnp.where(z != 0, 1.0 / jnp.where(z == 0, 1.0, z), 1.0)
    u = pc[..., 0] * magic_z * K[..., 0, 0] + K[..., 0, 2]
    v = pc[..., 1] * magic_z * K[..., 1, 1] + K[..., 1, 2]
    return jnp.stack([u, v], axis=-1)


def camera_depth(points: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    """The (z-flipped) camera-frame depth used for cheirality tests:
    positive when the point is in front of the camera."""
    pc = transform_inv(points, R, t)
    return -pc[..., 2]


# ---------------------------------------------------------------------------
# Bundle-adjustment parameterization (CeresBundleAdjustment.cpp:26-34, :67-88)
# ---------------------------------------------------------------------------


def pose_to_ba_params(R: jax.Array, t: jax.Array) -> jax.Array:
    """World pose (R, t) -> 6-vector BA block ``[angle_axis(R^T), -t]``."""
    aa = rodrigues_inv(jnp.swapaxes(R, -1, -2))
    return jnp.concatenate([aa, -t], axis=-1)


def ba_params_to_pose(params: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Inverse of :func:`pose_to_ba_params`: ``R = rodrigues(aa)^T, t = -t_hat``
    (CeresBundleAdjustment.cpp:72-82)."""
    R = jnp.swapaxes(rodrigues(params[..., :3]), -1, -2)
    return R, -params[..., 3:6]


def ba_project(tr: jax.Array, p3d: jax.Array, K: jax.Array) -> jax.Array:
    """The BA residual's predicted pixel (ProjectionResidual.h:38-58).

    ``p = AngleAxisRotate(tr[:3], p3d + tr[3:6]); p.z *= -1;
    uv = f * p.xy / p.z + c``. Note: no magic_z guard here — the reference
    residual divides directly.
    """
    p = angle_axis_rotate(tr[..., :3], p3d + tr[..., 3:6])
    z = -p[..., 2]
    u = p[..., 0] / z * K[..., 0, 0] + K[..., 0, 2]
    v = p[..., 1] / z * K[..., 1, 1] + K[..., 1, 2]
    return jnp.stack([u, v], axis=-1)


def compose_delta(
    R_prev: jax.Array, t_prev: jax.Array, R_delta: jax.Array, t_delta: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Compose an accepted relative motion onto the trajectory, exactly as the
    reference motion gate does (OdometryPipeline.cpp:180-181):
    ``t_new = R_prev @ t_delta + t_prev; R_new = R_delta @ R_prev``."""
    t_new = _mm(R_prev, t_delta[..., None])[..., 0] + t_prev
    R_new = _mm(R_delta, R_prev)
    return R_new, t_new


def huber_weight(r2: jax.Array, delta: float = 1.0) -> jax.Array:
    """IRLS weight of the Huber loss on squared residual norm r2.

    Ceres' HuberLoss(delta) has rho'(s) = 1 for s <= delta^2 and
    delta/sqrt(s) beyond; this returns rho'(s) used as the IRLS weight.
    """
    d2 = delta * delta
    safe = jnp.maximum(r2, jnp.finfo(r2.dtype).tiny)
    return jnp.where(r2 <= d2, 1.0, delta / jnp.sqrt(safe))


def triangulate_midpoint(
    R_rel: jax.Array, t_rel: jax.Array, x1: jax.Array, x2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Closed-form midpoint triangulation, batched over N rays.

    Camera 1 is [I|0], camera 2 is [R_rel|t_rel] (x2_cam = R_rel X + t_rel),
    both in STANDARD camera coordinates (z > 0 in front); ``x1``/``x2`` are
    unit-plane coords (N, 2). Returns (X (N, 3) in the camera-1 frame,
    sin2 (N,) = squared sine of the ray parallax angle — the caller's
    low-parallax gate; at sin2 -> 0 the midpoint is meaningless).

    Unlike the DLT eigensolve used by the essential-matrix bootstrap
    (solvers/essential.triangulate_points), this is a 2x2 closed form —
    cheap enough to run EVERY frame for the continuous-triangulation path
    (pipeline/steps.continuous_triangulate).
    """
    d1 = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    d1 = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True)
    d2c = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    d2 = _mm(d2c, R_rel)  # R_rel^T rows -> direction in cam-1 frame
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    o2 = -_mm(t_rel[None, :], R_rel)[0]  # camera-2 center in cam-1 frame
    B = jnp.sum(d1 * d2, axis=-1)
    sin2 = jnp.maximum(1.0 - B * B, 0.0)
    r1 = jnp.sum(d1 * o2, axis=-1)  # d1 . (o2 - o1), o1 = 0
    r2 = jnp.sum(d2 * o2, axis=-1)
    denom = jnp.where(sin2 > 1e-12, -sin2, -1e-12)
    a = (B * r2 - r1) / denom
    b = (r2 - B * r1) / denom
    X = (a[..., None] * d1 + o2 + b[..., None] * d2) * 0.5
    return X, sin2
